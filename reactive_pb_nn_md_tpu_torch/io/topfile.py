"""GROMACS-style .top parser, including the MS-EVB sections.

Parses the reference's topology format (intra_bonded_interactions.f90:696-1464
for the bonded sections, ms_evb.f90:3170-3623 for the EVB sections):

  [ bondtypes ] / [ angletypes ] / [ dihedraltypes ]   parameter tables
  [ moleculetype ] -> [ atoms ] [ bonds ] [ angles ] [ dihedrals ]
                      ([ exclusions ] optional)
  [ evb_parameters ] -> [ reference_energy ], [ adiabat_non_bond ] ->
      [ donor_acceptor ], [ proton_acceptor ], [ diabat_coupling ] ->
      [ geometry_factor ], [ exchange_charge_atomic ], [ exchange_charge_proton ]
  [ evb_topology ] -> repeated [ evb_pairs ] blocks with
      [ acid_reactive_protons ] [ base_reactive_protons ]
      [ acid_acceptor_atoms ] [ base_acceptor_atoms ] [ conjugate_atoms ]

Angles/dihedral reference angles are converted from degrees to radians on
read (intra_bonded_interactions.f90:928,1033).  ';' starts a comment.
"""

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


def _strip(line):
    idx = line.find(";")
    if idx >= 0:
        line = line[:idx]
    return line.strip()


def _tokenize(path):
    """Yield (kind, payload) with kind in {'heading', 'line'}."""
    with open(path) as f:
        for raw in f:
            s = _strip(raw)
            if not s:
                continue
            if s.startswith("["):
                yield ("heading", s)
            else:
                yield ("line", s.split())


@dataclass
class MoleculeTypeRaw:
    name: str
    atom_names: List[str] = field(default_factory=list)
    masses: List[float] = field(default_factory=list)
    bonds: List[Tuple[int, int]] = field(default_factory=list)        # 0-based
    angles: List[Tuple[int, int, int]] = field(default_factory=list)
    dihedrals: List[Tuple[int, int, int, int]] = field(default_factory=list)
    explicit_exclusions: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def n_atom(self):
        return len(self.atom_names)


@dataclass
class EvbPairRaw:
    acid_name: str
    base_name: str
    proton_type: str              # acidic proton atom type
    heavy_type: str               # acidic heavy-atom type bonded to proton
    acid_reactive_protons: Dict[int, int] = field(default_factory=dict)
    base_reactive_protons: Dict[int, int] = field(default_factory=dict)
    acid_acceptor_atoms: Dict[int, int] = field(default_factory=dict)
    base_acceptor_atoms: Dict[int, int] = field(default_factory=dict)
    conjugate_atoms: List[Tuple[str, str]] = field(default_factory=list)


@dataclass
class TopologyFileRaw:
    # bonded parameter tables keyed by atom-type-name tuples
    bond_types: Dict[Tuple[str, str], Tuple[int, List[float]]] = field(default_factory=dict)
    angle_types: Dict[Tuple[str, str, str], Tuple[int, List[float]]] = field(default_factory=dict)
    dihedral_types: Dict[Tuple[str, str, str, str], Tuple[int, List[float]]] = field(default_factory=dict)
    molecule_types: List[MoleculeTypeRaw] = field(default_factory=list)
    # EVB parameters
    reference_energy: Dict[str, float] = field(default_factory=dict)   # by molecule name
    donor_acceptor: List[Tuple[Tuple[str, str, str], List[float]]] = field(default_factory=list)
    proton_acceptor: List[Tuple[Tuple[str, str], List[float]]] = field(default_factory=list)
    diabat_coupling: List[Tuple[Tuple[str, str, str], int, List[float]]] = field(default_factory=list)
    exchange_charge_atomic: Dict[str, float] = field(default_factory=dict)
    exchange_charge_proton: Dict[Tuple[str, str], float] = field(default_factory=dict)
    evb_pairs: List[EvbPairRaw] = field(default_factory=list)
    has_evb: bool = False


_DEG = math.pi / 180.0


def read_top(path) -> TopologyFileRaw:
    top = TopologyFileRaw()
    tokens = list(_tokenize(path))
    i = 0
    n = len(tokens)

    def heading_at(k):
        return tokens[k][0] == "heading"

    current = None
    mole = None        # active MoleculeTypeRaw
    pair = None        # active EvbPairRaw
    expect_mole_name = False
    pending_coupling = None

    while i < n:
        kind, payload = tokens[i]
        i += 1
        if kind == "heading":
            current = payload.strip("[] ").strip()
            if current == "moleculetype":
                expect_mole_name = True
                mole = None
            elif current == "evb_pairs":
                pair = None
            elif current == "evb_topology":
                top.has_evb = True
            elif current == "evb_parameters":
                top.has_evb = True
            continue

        args = payload

        if expect_mole_name:
            mole = MoleculeTypeRaw(name=args[0][:5])
            top.molecule_types.append(mole)
            expect_mole_name = False
            continue

        if current == "bondtypes":
            a, b = args[0][:5], args[1][:5]
            func = int(args[2])
            if func in (1, 2):
                params = [float(args[3]), float(args[4]), 0.0]      # b0, kb
            elif func == 3:
                params = [float(args[3]), float(args[4]), float(args[5])]  # D, beta, b0
            else:
                raise ValueError(f"bond function type {func} not implemented")
            top.bond_types[(a, b)] = (func, params)
            top.bond_types[(b, a)] = (func, params)
        elif current == "angletypes":
            a, b, c = args[0][:5], args[1][:5], args[2][:5]
            func = int(args[3])
            params = [float(args[4]) * _DEG, float(args[5])]         # th0(rad), cth
            top.angle_types[(a, b, c)] = (func, params)
            top.angle_types[(c, b, a)] = (func, params)
        elif current == "dihedraltypes":
            a, b, c, d = (args[k][:5] for k in range(4))
            func = int(args[4])
            if func == 3:
                params = [float(v) for v in args[5:11]]              # RB C0..C5
            elif func == 1:
                params = [float(args[5]) * _DEG, float(args[6]), float(args[7]),
                          0.0, 0.0, 0.0]                             # xi0, kxi, mult
            elif func == 2:
                params = [float(args[5]) * _DEG, float(args[6]), 0.0, 0.0, 0.0, 0.0]
            else:
                raise ValueError(f"dihedral function type {func} not implemented")
            top.dihedral_types[(a, b, c, d)] = (func, params)
            top.dihedral_types[(d, c, b, a)] = (func, params)
        elif current == "atoms":
            mole.atom_names.append(args[1][:5])
            mole.masses.append(float(args[2]))
        elif current == "bonds":
            mole.bonds.append((int(args[0]) - 1, int(args[1]) - 1))
        elif current == "angles":
            mole.angles.append((int(args[0]) - 1, int(args[1]) - 1, int(args[2]) - 1))
        elif current == "dihedrals":
            mole.dihedrals.append(tuple(int(a) - 1 for a in args[:4]))
        elif current == "exclusions":
            mole.explicit_exclusions.append((int(args[0]) - 1, int(args[1]) - 1))
        elif current == "reference_energy":
            top.reference_energy[args[0][:5]] = float(args[1])
        elif current == "donor_acceptor":
            key = (args[0][:5], args[1][:5], args[2][:5])
            top.donor_acceptor.append((key, [float(v) for v in args[3:9]]))
        elif current == "proton_acceptor":
            key = (args[0][:5], args[1][:5])
            top.proton_acceptor.append((key, [float(v) for v in args[2:7]]))
        elif current == "geometry_factor":
            # Two layouts exist in the wild:
            #  (a) reference reader (ms_evb.f90:3492-3549): one line with
            #      3 atom types + integer function type, then a second line
            #      with the parameters (10 for type 1, 4 for type 2);
            #  (b) the shipped example file: 3 atom types + all 10 MS-EVB3
            #      parameters on a single line.  Accept both.
            if pending_coupling is not None:
                key, func = pending_coupling
                params = [float(v) for v in args]
                if func == 1 and len(params) != 10:
                    raise ValueError("MS-EVB3 coupling needs 10 parameters")
                if func == 2 and len(params) != 4:
                    raise ValueError("Gaussian-product coupling needs 4 parameters")
                params += [0.0] * (10 - len(params))
                top.diabat_coupling.append((key, func, params))
                pending_coupling = None
            elif len(args) == 4:
                pending_coupling = ((args[0][:5], args[1][:5], args[2][:5]),
                                    int(args[3]))
            elif len(args) in (13, 7):
                key = (args[0][:5], args[1][:5], args[2][:5])
                params = [float(v) for v in args[3:]]
                func = 1 if len(params) == 10 else 2
                params += [0.0] * (10 - len(params))
                top.diabat_coupling.append((key, func, params))
            else:
                raise ValueError(f"cannot parse geometry_factor line: {args}")
        elif current == "exchange_charge_atomic":
            top.exchange_charge_atomic[args[0][:5]] = float(args[1])
        elif current == "exchange_charge_proton":
            top.exchange_charge_proton[(args[0][:5], args[1][:5])] = float(args[2])
        elif current == "evb_pairs":
            pair = EvbPairRaw(acid_name=args[0][:5], base_name=args[1][:5],
                              proton_type=args[2][:5], heavy_type=args[3][:5])
            top.evb_pairs.append(pair)
        elif current == "acid_reactive_protons":
            pair.acid_reactive_protons[int(args[0]) - 1] = int(args[1])
        elif current == "base_reactive_protons":
            pair.base_reactive_protons[int(args[0]) - 1] = int(args[1])
        elif current == "acid_acceptor_atoms":
            pair.acid_acceptor_atoms[int(args[0]) - 1] = int(args[1])
        elif current == "base_acceptor_atoms":
            pair.base_acceptor_atoms[int(args[0]) - 1] = int(args[1])
        elif current == "conjugate_atoms":
            pair.conjugate_atoms.append((args[0][:5], args[1][:5]))

    return top
