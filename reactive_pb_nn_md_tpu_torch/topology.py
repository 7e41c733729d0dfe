"""System compilation: parsed inputs -> dataclasses of tensors.

Counterpart of reactive_pb_nn_md_tpu/topology.py without jax or flax: the
builder below computes the same tables in numpy (the logic is the
reference's, line for line) and ``convert.from_numpy_tree`` places them on
a device.  Index tensors are int64, padded with -1; float tensors take the
deck's precision.

  ForceField     dense per-type parameter tables        [T,...]
  MolTypeTable   padded per-molecule-type templates     [MT, A, ...]
  EvbParams      dense EVB interaction tables           [T,T,T,...]
                 (+ the PB-NN coupling MLP of function type 3)
  Topology       the dynamic molecular assignment       [M, A] / [N]
                 (a proton hop rewrites only these)
"""

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .io.gro import GroFrame
from .io.ffpmt import RawForceField, compile_vdw_tables
from .io.topfile import TopologyFileRaw
from .io.simpmt import SimConfig
from .ops.kernels.pme_slab import suggest_pme_scap


@dataclass
class ForceField:
    charge_by_type: torch.Tensor         # (T,)
    mass_by_type: torch.Tensor           # (T,)
    freeze_by_type: torch.Tensor         # (T,) int
    vdw_type: torch.Tensor               # (T,T) int: 0 LJ, 1 SAPT, -1 none
    vdw_params: torch.Tensor             # (T,T,6)
    vdw_params_14: torch.Tensor          # (T,T,6)
    bond_func: torch.Tensor              # (T,T) int
    bond_params: torch.Tensor            # (T,T,3)
    angle_func: torch.Tensor             # (T,T,T) int
    angle_params: torch.Tensor           # (T,T,T,2)
    dihedral_func: torch.Tensor          # (T,T,T,T) int
    dihedral_params: torch.Tensor        # (T,T,T,T,6)
    atype_names: Tuple[str, ...] = ()


@dataclass
class MolTypeTable:
    natom: torch.Tensor                  # (MT,)
    atype: torch.Tensor                  # (MT,A), -1 pad
    mass: torch.Tensor                   # (MT,A)
    bonds: torch.Tensor                  # (MT,B,2), -1 pad
    angles: torch.Tensor                 # (MT,G,3)
    dihedrals: torch.Tensor              # (MT,D,4)
    excl_code: torch.Tensor              # (MT,A,A) {0,1,2}
    reactive_protons: torch.Tensor       # (MT,A)
    reactive_bases: torch.Tensor         # (MT,A)
    is_acid: torch.Tensor                # (MT,)
    is_base: torch.Tensor                # (MT,)
    conjugate_mtype: torch.Tensor        # (MT,)
    proton_atype: torch.Tensor           # (MT,), -1 if not acid
    heavy_atype: torch.Tensor            # (MT,), -1 if not acid
    reference_energy: torch.Tensor       # (MT,)
    bonded_heavy_slot: torch.Tensor      # (MT,A) template-bonded partner
    heavy_slot: torch.Tensor             # (MT,)
    proton_slots: torch.Tensor           # (MT,P) reactive-proton slots
    base_atype: Optional[torch.Tensor]   # (T,) base flag by atom type
    bond_tab: torch.Tensor               # (MT,B,4) func + 3 params
    angle_tab: torch.Tensor              # (MT,G,3) func + 2 params
    dihedral_tab: torch.Tensor           # (MT,D,7) func + 6 params
    intra_tab: torch.Tensor              # (MT,P2,13) vtype + 6 + 6 params
    mtype_names: Tuple[str, ...] = ()


@dataclass
class EvbParams:
    conjugate_atype: torch.Tensor        # (T,)
    exchange_q_atype: torch.Tensor       # (T,)
    exchange_q_proton: torch.Tensor      # (MT,MT)
    da_mask: torch.Tensor                # (T,T,T) bool
    da_params: torch.Tensor              # (T,T,T,6)  B b d0 b' rs rc
    pa_mask: torch.Tensor                # (T,T) bool
    pa_params: torch.Tensor              # (T,T,5)  C c d0 rs rc
    cpl_func: torch.Tensor               # (T,T,T), 0 = none
    cpl_params: torch.Tensor             # (T,T,T,10)
    type_options: torch.Tensor           # (T,O) every type an atom can take
    # the PB-NN coupling MLP (nn/coupling_mlp.py) that every triple of
    # cpl_func 3 uses; switch a triple to 3 and attach it in one
    # construction (dataclasses.replace)
    nn_params: Optional[dict] = None

    def __post_init__(self):
        check_nn_coupling(self)


def check_nn_coupling(evb):
    """Raise unless every coupling of function type 3 has an MLP, and the
    MLP is well formed.  Once, on the host, where the tables are built or
    attached (one read of cpl_func), never inside a step.  The JAX
    package evaluates such a triple to A = 0 without a word
    (models/coupling.py there, nn_apply None): another surface."""
    if evb is None:
        return
    nn = evb.nn_params
    if nn is None:
        if bool((evb.cpl_func == 3).any()):
            raise ValueError(
                "coupling function type 3 (PB-NN) needs its MLP: attach "
                "nn_params together with the cpl_func switch "
                "(nn.coupling_mlp.attach, through "
                "Simulation.mutate_system)")
        return
    w, b = nn.get("w"), nn.get("b")
    if "vconst" not in nn or not w or b is None or len(w) != len(b):
        raise ValueError("nn_params must be {'vconst', 'w': [...], 'b': "
                         "[...]} with one bias a weight")
    shapes = [tuple(wi.shape) for wi in w]
    if not (all(len(sh) == 2 for sh in shapes) and shapes[0][0] >= 3
            and shapes[-1][1] == 1
            and all(u[1] == v[0] for u, v in zip(shapes, shapes[1:]))
            and all(tuple(bi.shape) == (sh[1],)
                    for bi, sh in zip(b, shapes))):
        raise ValueError(f"nn_params layer shapes {shapes} do not chain "
                         f"from >= 3 inputs to 1 output")


@dataclass
class Topology:
    """Dynamic molecular assignment; with a leading state axis it is the
    batch of diabat topologies."""
    mol_mtype: torch.Tensor              # (M,)
    mol_natom: torch.Tensor              # (M,)
    mol_atoms: torch.Tensor              # (M,A), -1 pad
    atom_mol: torch.Tensor               # (N,)
    atom_slot: torch.Tensor              # (N,)
    atom_type: torch.Tensor              # (N,)
    charge: torch.Tensor                 # (N,)
    hydronium_mol: torch.Tensor          # () -1 if non-reactive


@dataclass
class System:
    """Per-run tables plus static configuration."""
    ff: ForceField
    mt: MolTypeTable
    evb: Optional[EvbParams]
    mass: torch.Tensor                   # (N,)
    device: torch.device
    n_atoms: int = 0
    n_mole: int = 0
    max_atoms_per_mol: int = 0
    real_space_cutoff: float = 0.0
    verlet_cutoff: float = 0.0
    alpha_sqrt: float = 0.3
    pme_grid: int = 60
    spline_order: int = 6
    n_exclusions: int = 2
    evb_max_states: int = 80
    evb_max_chain: int = 3
    evb_max_neighbors: int = 10
    evb_first_solvation_cutoff: float = 5.0
    evb_reactive_pair_distance: float = 2.5
    evb_small_states: int = -1           # -1 auto, 0 off, > 0 explicit
    ms_evb: bool = False
    has_sapt: bool = False
    rs_cells: tuple = ()                 # kernel A cell grid, () = half list
    pme_scap: int = 0                    # PME slab capacity (kernels D), 0 = B
    evb_rep_rc_max: float = 0.0
    compensated_sum: bool = False        # Kahan x / v sums in md_step

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class State:
    x: torch.Tensor                      # (N,3) Angstrom
    v: torch.Tensor                      # (N,3) A/ps
    box: torch.Tensor                    # (3,3)
    step: int = 0


# --------------------------------------------------------------------------
# exclusions (intra_bonded_interactions.f90:574-660)
# --------------------------------------------------------------------------

def generate_exclusions(n_atom, bonds, n_exclusions, explicit=()):
    """Exclusion codes per atom pair: 1 excluded, 2 special 1-4, 0 normal."""
    code = np.zeros((n_atom, n_atom), dtype=np.int64)
    for (i, j) in explicit:
        code[i, j] = code[j, i] = 1
    np.fill_diagonal(code, 1)
    adj = np.zeros((n_atom, n_atom), dtype=bool)
    for (i, j) in bonds:
        adj[i, j] = adj[j, i] = True
    dist = np.full((n_atom, n_atom), 10 ** 6, dtype=np.int64)
    np.fill_diagonal(dist, 0)
    for start in range(n_atom):
        frontier, d, seen = [start], 0, {start}
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in np.nonzero(adj[u])[0]:
                    if v not in seen:
                        seen.add(v)
                        dist[start, v] = d
                        nxt.append(v)
            frontier = nxt
    max_search = max(n_exclusions, 3)
    for i in range(n_atom):
        for j in range(n_atom):
            if i == j:
                continue
            d = dist[i, j]
            if d <= max_search:
                if d == 3 and n_exclusions < 3 and code[i, j] != 1:
                    code[i, j] = 2
                elif d <= n_exclusions:
                    code[i, j] = 1
    return code


def suggest_rs_cells(n_atoms, box, cutoff, safety=1.5, min_atoms=192):
    """Static cell grid (nc1, nc2, nc3, ccap) for kernel A, or () when the
    grid degenerates (tiny or non-orthorhombic boxes, < 3 cells an axis).
    Sized by the real-space cutoff; ccap is a multiple of 8.  The JAX
    package also returns () past n_cells * ccap = 80,000, its kernel's
    scoped-VMEM ceiling on the TPU; the port's kernels take their shared
    memory by ccap alone (ops/kernels/realspace_pair.check_half_smem), so
    a larger box (the 100,000-atom box's 22^3 cells) keeps kernel A''."""
    if n_atoms < min_atoms:
        return ()
    b = np.asarray(box, dtype=np.float64)
    if np.abs(b - np.diag(np.diag(b))).max() > 1e-9:
        return ()
    nc = [int(w // cutoff) for w in np.diag(b)]
    if min(nc) < 3:
        return ()
    per_cell = n_atoms / (nc[0] * nc[1] * nc[2])
    cap = max(per_cell * safety, per_cell + 4.0 * np.sqrt(per_cell))
    ccap = max(int(-(-int(np.ceil(cap)) // 8) * 8), 8)
    return (nc[0], nc[1], nc[2], ccap)


# --------------------------------------------------------------------------
# system building
# --------------------------------------------------------------------------

def build_numpy_tree(gro: GroFrame, ff_raw: RawForceField,
                     top_raw: TopologyFileRaw, cfg: SimConfig) -> dict:
    """The system as nested dicts of numpy arrays, keyed like the
    containers above (the format ``convert.from_numpy_tree`` reads)."""
    T = ff_raw.n_types
    names = ff_raw.names

    def atype_id(name):
        try:
            return names.index(name)
        except ValueError:
            raise ValueError(f"atom type {name!r} not in force-field file")

    vdw_type, vdw_params, vdw_params_14 = compile_vdw_tables(
        ff_raw, cfg.lj_comb_rule)

    bond_func = np.zeros((T, T), dtype=np.int64)
    bond_params = np.zeros((T, T, 3))
    for (a, b), (func, params) in top_raw.bond_types.items():
        ia, ib = atype_id(a), atype_id(b)
        bond_func[ia, ib] = func
        bond_params[ia, ib] = params
    angle_func = np.zeros((T, T, T), dtype=np.int64)
    angle_params = np.zeros((T, T, T, 2))
    for (a, b, c), (func, params) in top_raw.angle_types.items():
        idx = (atype_id(a), atype_id(b), atype_id(c))
        angle_func[idx] = func
        angle_params[idx] = params
    dihedral_func = np.zeros((T, T, T, T), dtype=np.int64)
    dihedral_params = np.zeros((T, T, T, T, 6))
    for (a, b, c, d), (func, params) in top_raw.dihedral_types.items():
        idx = (atype_id(a), atype_id(b), atype_id(c), atype_id(d))
        dihedral_func[idx] = func
        dihedral_params[idx] = params

    mass_by_type = np.full((T,), -1.0)
    for mt_ in top_raw.molecule_types:
        for aname, m in zip(mt_.atom_names, mt_.masses):
            ti = atype_id(aname)
            if mass_by_type[ti] < 0:
                mass_by_type[ti] = m
            elif abs(mass_by_type[ti] - m) > 1e-6:
                raise ValueError(f"inconsistent mass for atom type {aname}")

    ff = dict(charge_by_type=np.asarray(ff_raw.charge, np.float64),
              mass_by_type=np.maximum(mass_by_type, 0.0),
              freeze_by_type=np.asarray(ff_raw.freeze, np.int64),
              vdw_type=vdw_type, vdw_params=vdw_params,
              vdw_params_14=vdw_params_14,
              bond_func=bond_func, bond_params=bond_params,
              angle_func=angle_func, angle_params=angle_params,
              dihedral_func=dihedral_func, dihedral_params=dihedral_params,
              atype_names=tuple(names))

    # ---------------- molecule type templates
    mtypes = top_raw.molecule_types
    mtype_names = [m.name for m in mtypes]
    MT = len(mtypes)
    A = max(m.n_atom for m in mtypes)
    B = max(max(len(m.bonds) for m in mtypes), 1)
    G = max(max(len(m.angles) for m in mtypes), 1)
    D = max(max(len(m.dihedrals) for m in mtypes), 1)

    natom = np.array([m.n_atom for m in mtypes], dtype=np.int64)
    atype = np.full((MT, A), -1, dtype=np.int64)
    mmass = np.zeros((MT, A))
    bonds = np.full((MT, B, 2), -1, dtype=np.int64)
    angles = np.full((MT, G, 3), -1, dtype=np.int64)
    dihedrals = np.full((MT, D, 4), -1, dtype=np.int64)
    excl = np.ones((MT, A, A), dtype=np.int64)
    for k, m in enumerate(mtypes):
        na = m.n_atom
        atype[k, :na] = [atype_id(an) for an in m.atom_names]
        mmass[k, :na] = m.masses
        for ib, bnd in enumerate(m.bonds):
            bonds[k, ib] = bnd
        for ia, ang in enumerate(m.angles):
            angles[k, ia] = ang
        for idd, dih in enumerate(m.dihedrals):
            dihedrals[k, idd] = dih
        excl[k, :na, :na] = generate_exclusions(
            na, m.bonds, cfg.n_exclusions, m.explicit_exclusions)

    def mtype_id(name):
        try:
            return mtype_names.index(name)
        except ValueError:
            raise ValueError(f"molecule type {name!r} not in topology file")

    # ---------------- EVB topology/parameters
    is_acid = np.zeros((MT,), dtype=np.int64)
    is_base = np.zeros((MT,), dtype=np.int64)
    conjugate_mtype = np.arange(MT, dtype=np.int64)
    proton_atype = np.full((MT,), -1, dtype=np.int64)
    heavy_atype = np.full((MT,), -1, dtype=np.int64)
    reference_energy = np.zeros((MT,))
    reactive_protons = np.zeros((MT, A), dtype=np.int64)
    reactive_bases = np.zeros((MT, A), dtype=np.int64)
    conjugate_atype = np.arange(T, dtype=np.int64)

    evb = None
    rep_rc_max = 0.0
    if top_raw.has_evb and cfg.ms_evb_simulation:
        exchange_q_atype = np.zeros((T,))
        exchange_q_proton = np.zeros((MT, MT))
        da_mask = np.zeros((T, T, T), dtype=bool)
        da_params = np.zeros((T, T, T, 6))
        pa_mask = np.zeros((T, T), dtype=bool)
        pa_params = np.zeros((T, T, 5))
        cpl_func = np.zeros((T, T, T), dtype=np.int64)
        cpl_params = np.zeros((T, T, T, 10))
        for name, e in top_raw.reference_energy.items():
            reference_energy[mtype_id(name)] = e
        for (key, params) in top_raw.donor_acceptor:
            i, j, k = (atype_id(x) for x in key)
            da_mask[i, j, k] = True
            da_params[i, j, k] = params
        for (key, params) in top_raw.proton_acceptor:
            i, j = (atype_id(x) for x in key)
            pa_mask[i, j] = True
            pa_params[i, j] = params
        for (key, func, params) in top_raw.diabat_coupling:
            i, j, k = (atype_id(x) for x in key)
            if func == 3:
                # a deck carries no MLP: the JAX package would evaluate
                # this triple to A = 0 (check_nn_coupling)
                raise ValueError(
                    "PB-NN coupling (function type 3) cannot come from a "
                    "deck: build the system with the triple's analytic "
                    "form, then switch the triple to 3 and attach the MLP "
                    "together (nn.coupling_mlp.attach, through "
                    "Simulation.mutate_system; nn/train.py "
                    "pretrain_geometric makes one, convert.mlp_from_numpy "
                    "carries trained weights across)")
            cpl_func[i, j, k] = func
            cpl_params[i, j, k] = params
        for name, q in top_raw.exchange_charge_atomic.items():
            exchange_q_atype[atype_id(name)] = q
        for (n1, n2), q in top_raw.exchange_charge_proton.items():
            exchange_q_proton[mtype_id(n1), mtype_id(n2)] = q
            exchange_q_proton[mtype_id(n2), mtype_id(n1)] = q
        for pair in top_raw.evb_pairs:
            ia, ib = mtype_id(pair.acid_name), mtype_id(pair.base_name)
            is_acid[ia] = 1
            is_base[ib] = 1
            conjugate_mtype[ia] = ib
            conjugate_mtype[ib] = ia
            proton_atype[ia] = atype_id(pair.proton_type)
            heavy_atype[ia] = atype_id(pair.heavy_type)
            for idx, v in pair.acid_reactive_protons.items():
                reactive_protons[ia, idx] = v
            for idx, v in pair.base_reactive_protons.items():
                reactive_protons[ib, idx] = v
            for idx, v in pair.acid_acceptor_atoms.items():
                reactive_bases[ia, idx] = v
            for idx, v in pair.base_acceptor_atoms.items():
                reactive_bases[ib, idx] = v
            # order matters: later lines overwrite
            for (a1, a2) in pair.conjugate_atoms:
                t1, t2 = atype_id(a1), atype_id(a2)
                conjugate_atype[t1] = t2
                conjugate_atype[t2] = t1
        for k in range(MT):
            if is_acid[k] and not any(
                    reactive_protons[k, i] == 1 for i in range(natom[k])):
                raise ValueError(f"acid molecule {mtype_names[k]} has no "
                                 f"reactive proton")

        # every type an atom can take in a diabat (closure of the
        # conjugation / override algebra)
        opt_sets = [[t] for t in range(T)]
        proton_types = sorted({int(proton_atype[a]) for a in range(MT)
                               if is_acid[a] and proton_atype[a] >= 0})
        for t in range(T):
            def _add(v):
                if v >= 0 and v not in opt_sets[t]:
                    opt_sets[t].append(int(v))
            _add(conjugate_atype[t])
            _add(conjugate_atype[conjugate_atype[t]])
            is_rp = any(reactive_protons[m, i] == 1 and atype[m, i] == t
                        for m in range(MT) for i in range(natom[m]))
            if is_rp:
                for p in proton_types:
                    _add(p)
                    _add(conjugate_atype[p])
            for m in range(MT):
                for i in range(natom[m]):
                    if reactive_bases[m, i] == 1 and atype[m, i] == t:
                        acid = conjugate_mtype[m] if not is_acid[m] else m
                        _add(heavy_atype[acid])
                        _add(conjugate_atype[heavy_atype[acid]])
        O = max(len(s) for s in opt_sets)
        type_options = np.full((T, O), -1, dtype=np.int64)
        for t, s in enumerate(opt_sets):
            type_options[t, :len(s)] = s

        rep_rcs = ([float(da_params[da_mask][:, 5].max())]
                   if da_mask.any() else []) \
            + ([float(pa_params[pa_mask][:, 4].max())]
               if pa_mask.any() else [])
        rep_rc_max = max(rep_rcs) if rep_rcs else 0.0
        evb = dict(conjugate_atype=conjugate_atype,
                   exchange_q_atype=exchange_q_atype,
                   exchange_q_proton=exchange_q_proton,
                   da_mask=da_mask, da_params=da_params,
                   pa_mask=pa_mask, pa_params=pa_params,
                   cpl_func=cpl_func, cpl_params=cpl_params,
                   type_options=type_options)

    bonded_heavy_slot = np.full((MT, A), -1, dtype=np.int64)
    heavy_slot = np.full((MT,), -1, dtype=np.int64)
    for k, m in enumerate(mtypes):
        for (i, j) in m.bonds:
            if bonded_heavy_slot[k, i] < 0:
                bonded_heavy_slot[k, i] = j
            if bonded_heavy_slot[k, j] < 0:
                bonded_heavy_slot[k, j] = i
        acid_k = k if is_acid[k] else conjugate_mtype[k]
        if proton_atype[acid_k] >= 0:
            t_heavy = heavy_atype[acid_k]
            if not is_acid[k]:
                t_heavy = conjugate_atype[t_heavy]
            for i in range(natom[k]):
                if atype[k, i] == t_heavy:
                    heavy_slot[k] = i
                    break

    # per-template compiled parameter tables (the type tuple of every
    # bonded term / intra slot pair is static per template)
    B_n, G_n, D_n = bonds.shape[1], angles.shape[1], dihedrals.shape[1]
    bond_tab = np.zeros((MT, B_n, 4))
    angle_tab = np.zeros((MT, G_n, 3))
    dihedral_tab = np.zeros((MT, D_n, 7))
    iu_np, ju_np = np.triu_indices(A, 1)
    P2 = iu_np.shape[0]
    intra_tab = np.zeros((MT, P2, 13))
    intra_tab[:, :, 0] = -1.0
    for k in range(MT):
        for s in range(B_n):
            i0, j0 = bonds[k, s]
            if i0 < 0:
                continue
            ti, tj = atype[k, i0], atype[k, j0]
            bond_tab[k, s, 0] = bond_func[ti, tj]
            bond_tab[k, s, 1:] = bond_params[ti, tj]
        for s in range(G_n):
            i0, j0, k0 = angles[k, s]
            if i0 < 0:
                continue
            tt = (atype[k, i0], atype[k, j0], atype[k, k0])
            angle_tab[k, s, 0] = angle_func[tt]
            angle_tab[k, s, 1:] = angle_params[tt]
        for s in range(D_n):
            i0, j0, k0, l0 = dihedrals[k, s]
            if i0 < 0:
                continue
            tt = (atype[k, i0], atype[k, j0], atype[k, k0], atype[k, l0])
            dihedral_tab[k, s, 0] = dihedral_func[tt]
            dihedral_tab[k, s, 1:] = dihedral_params[tt]
        for s in range(P2):
            i0, j0 = iu_np[s], ju_np[s]
            if j0 >= natom[k]:
                continue
            ti, tj = atype[k, i0], atype[k, j0]
            intra_tab[k, s, 0] = vdw_type[ti, tj]
            intra_tab[k, s, 1:7] = vdw_params[ti, tj]
            intra_tab[k, s, 7:13] = vdw_params_14[ti, tj]

    P = max(1, int((reactive_protons > 0).sum(axis=1).max()))
    proton_slots = np.full((MT, P), -1, dtype=np.int64)
    for k in range(MT):
        sl = np.nonzero(reactive_protons[k] > 0)[0]
        proton_slots[k, :len(sl)] = sl

    base_by_atype = np.zeros((T,), dtype=np.int64)
    base_ok = True
    seen_base = {}
    for k in range(MT):
        for i in range(int(natom[k])):
            t, v = int(atype[k, i]), int(reactive_bases[k, i] > 0)
            if seen_base.setdefault(t, v) != v:
                base_ok = False
            if v:
                base_by_atype[t] = 1

    mt = dict(natom=natom, atype=atype, mass=mmass, bonds=bonds,
              angles=angles, dihedrals=dihedrals, excl_code=excl,
              reactive_protons=reactive_protons,
              reactive_bases=reactive_bases, is_acid=is_acid,
              is_base=is_base, conjugate_mtype=conjugate_mtype,
              proton_atype=proton_atype, heavy_atype=heavy_atype,
              reference_energy=reference_energy,
              bonded_heavy_slot=bonded_heavy_slot, heavy_slot=heavy_slot,
              proton_slots=proton_slots,
              base_atype=base_by_atype if base_ok else None,
              bond_tab=bond_tab, angle_tab=angle_tab,
              dihedral_tab=dihedral_tab, intra_tab=intra_tab,
              mtype_names=tuple(mtype_names))

    # ---------------- per-configuration topology from the .gro frame
    M, N = gro.n_mole, gro.n_atoms
    mol_mtype = np.zeros((M,), dtype=np.int64)
    mol_natom = np.zeros((M,), dtype=np.int64)
    mol_atoms = np.full((M, A), -1, dtype=np.int64)
    atom_mol = np.zeros((N,), dtype=np.int64)
    atom_slot = np.zeros((N,), dtype=np.int64)
    atom_type = np.zeros((N,), dtype=np.int64)
    for m in range(M):
        k = mtype_id(gro.mol_names[m])
        first = int(gro.mol_first_atom[m])
        na = int(gro.mol_natom[m])
        if na != int(natom[k]):
            raise ValueError(
                f"molecule {m} ({gro.mol_names[m]}) has {na} atoms in .gro "
                f"but {int(natom[k])} in topology")
        mol_mtype[m] = k
        mol_natom[m] = na
        mol_atoms[m, :na] = np.arange(first, first + na)
        atom_mol[first:first + na] = m
        atom_slot[first:first + na] = np.arange(na)
        atom_type[first:first + na] = atype[k, :na]
        for i in range(na):
            if gro.atom_names[first + i] != names[atype[k, i]]:
                raise ValueError(
                    f".gro atom name {gro.atom_names[first + i]!r} does not "
                    f"match topology template {names[atype[k, i]]!r} "
                    f"(molecule {m}, slot {i})")

    hydronium = -1
    if cfg.ms_evb_simulation:
        acid_mols = [m for m in range(M) if is_acid[mol_mtype[m]]
                     and proton_atype[mol_mtype[m]] >= 0]
        if len(acid_mols) != 1:
            raise ValueError(f"MS-EVB needs exactly one acidic molecule, "
                             f"found {len(acid_mols)}")
        hydronium = acid_mols[0]

    topo = dict(mol_mtype=mol_mtype, mol_natom=mol_natom,
                mol_atoms=mol_atoms, atom_mol=atom_mol, atom_slot=atom_slot,
                atom_type=atom_type,
                charge=np.asarray(ff_raw.charge, np.float64)[atom_type],
                hydronium_mol=np.asarray(hydronium, np.int64))
    system = dict(
        mass=np.maximum(mass_by_type, 0.0)[atom_type],
        n_atoms=N, n_mole=M, max_atoms_per_mol=A,
        real_space_cutoff=float(cfg.real_space_cutoff),
        verlet_cutoff=float(cfg.verlet_cutoff),
        alpha_sqrt=float(cfg.alpha_sqrt),
        pme_grid=int(cfg.pme_grid), spline_order=int(cfg.spline_order),
        n_exclusions=int(cfg.n_exclusions),
        evb_max_states=int(cfg.evb_max_states),
        evb_max_chain=int(cfg.evb_max_chain),
        evb_max_neighbors=int(cfg.evb_max_neighbors),
        evb_first_solvation_cutoff=float(cfg.evb_first_solvation_cutoff),
        evb_reactive_pair_distance=float(cfg.evb_reactive_pair_distance),
        evb_small_states=int(cfg.evb_small_states),
        ms_evb=bool(cfg.ms_evb_simulation),
        has_sapt=bool((vdw_type == 1).any()),
        rs_cells=suggest_rs_cells(N, gro.box, cfg.real_space_cutoff),
        pme_scap=suggest_pme_scap(N, int(cfg.pme_grid), gro.box),
        evb_rep_rc_max=rep_rc_max,
        compensated_sum=bool(cfg.compensated_sum))
    return dict(ff=ff, mt=mt, evb=evb, system=system, topo=topo)


def build_system(gro: GroFrame, ff_raw: RawForceField,
                 top_raw: TopologyFileRaw, cfg: SimConfig, device="cuda"):
    """Compile parsed inputs into (System, Topology) on `device` (the card
    unless asked otherwise), in the deck's precision."""
    from .convert import from_numpy_tree
    from .utils.dtypes import float_dtype
    return from_numpy_tree(build_numpy_tree(gro, ff_raw, top_raw, cfg),
                           device=device, dtype=float_dtype(cfg.precision))
