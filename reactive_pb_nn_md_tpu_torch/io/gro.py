"""GROMACS .gro reader/writer.

Format contract matches the reference (general_routines.f90:184-315):
fixed-width records ``I5,2A5,I5,3F8.3`` (optionally velocities), coordinates
in nm converted to Angstrom on read (x10) and back to nm on write.
Molecules are delimited by changes in the residue-number column.
Box line has 3 (orthorhombic) or 9 numbers, also nm.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class GroFrame:
    title: str
    mol_names: List[str]          # per molecule
    mol_first_atom: np.ndarray    # (M,) index of first atom of each molecule
    mol_natom: np.ndarray         # (M,)
    atom_names: List[str]         # per atom
    xyz: np.ndarray               # (N, 3) Angstrom
    box: np.ndarray               # (3, 3) Angstrom, rows are lattice vectors
    velocities: np.ndarray = None  # (N, 3) A/ps if present

    @property
    def n_mole(self):
        return len(self.mol_names)

    @property
    def n_atoms(self):
        return self.xyz.shape[0]


def read_gro(path_or_lines) -> GroFrame:
    if isinstance(path_or_lines, (list, tuple)):
        lines = list(path_or_lines)
    else:
        with open(path_or_lines) as f:
            lines = f.read().splitlines()

    title = lines[0]
    n_atoms = int(lines[1].split()[0])

    mol_names, mol_first, mol_natom, atom_names = [], [], [], []
    xyz = np.zeros((n_atoms, 3), dtype=np.float64)
    vel = np.zeros((n_atoms, 3), dtype=np.float64)
    has_vel = False

    prev_mol = None
    for i in range(n_atoms):
        line = lines[2 + i]
        # fixed-width fields per the gro format
        resnum = int(line[0:5])
        resname = line[5:10].strip()
        aname = line[10:15].strip()
        rest = line[20:]
        vals = [rest[k * 8:(k + 1) * 8] for k in range(len(rest) // 8)]
        vals = [float(v) for v in vals if v.strip()]
        xyz[i] = vals[0:3]
        if len(vals) >= 6:
            vel[i] = vals[3:6]
            has_vel = True
        atom_names.append(aname)
        if resnum != prev_mol:
            mol_names.append(resname)
            mol_first.append(i)
            prev_mol = resnum

    mol_first = np.asarray(mol_first, dtype=np.int32)
    mol_natom = np.diff(np.append(mol_first, n_atoms)).astype(np.int32)

    box_vals = [float(v) for v in lines[2 + n_atoms].split()]
    box = np.zeros((3, 3), dtype=np.float64)
    if len(box_vals) >= 9:
        (box[0, 0], box[1, 1], box[2, 2],
         box[0, 1], box[0, 2], box[1, 0],
         box[1, 2], box[2, 0], box[2, 1]) = box_vals[:9]
    else:
        box[0, 0], box[1, 1], box[2, 2] = box_vals[:3]

    # nm -> Angstrom (general_routines.f90:264,306)
    return GroFrame(title=title, mol_names=mol_names, mol_first_atom=mol_first,
                    mol_natom=mol_natom, atom_names=atom_names,
                    xyz=xyz * 10.0, box=box * 10.0,
                    velocities=vel * 10.0 if has_vel else None)


def format_gro_frame(title, mol_names, mol_natom, atom_names, xyz, box,
                     velocities=None) -> str:
    """Render one .gro frame (Angstrom in, nm out), matching the reference
    trajectory writer (general_routines.f90:906-945)."""
    out = [title, f"{len(atom_names):5d}"]
    i = 0
    for m, (mname, na) in enumerate(zip(mol_names, mol_natom)):
        resnum = (m + 1) % 100000
        for _ in range(int(na)):
            x, y, z = xyz[i] / 10.0
            line = f"{resnum:5d}{mname:<5.5s}{atom_names[i]:>5.5s}{(i + 1) % 100000:5d}{x:8.3f}{y:8.3f}{z:8.3f}"
            if velocities is not None:
                vx, vy, vz = velocities[i] / 10.0
                line += f"{vx:8.4f}{vy:8.4f}{vz:8.4f}"
            out.append(line)
            i += 1
    b = box / 10.0
    if abs(b[0, 1]) + abs(b[0, 2]) + abs(b[1, 0]) + abs(b[1, 2]) + abs(b[2, 0]) + abs(b[2, 1]) > 0:
        out.append("  " + "  ".join(f"{v:10.5f}" for v in
                                    [b[0, 0], b[1, 1], b[2, 2], b[0, 1], b[0, 2],
                                     b[1, 0], b[1, 2], b[2, 0], b[2, 1]]))
    else:
        out.append(f"  {b[0, 0]:10.5f}  {b[1, 1]:10.5f}  {b[2, 2]:10.5f}")
    return "\n".join(out) + "\n"


def read_last_gro_frame(path) -> GroFrame:
    """Last frame of a multi-frame .gro trajectory (the reference restarts
    from the trajectory tail, scan_grofile_restart
    general_routines.f90:120-142).  The frame title carries the step number
    ('step N')."""
    with open(path) as f:
        lines = f.read().splitlines()
    i, last = 0, None
    while i + 1 < len(lines):
        try:
            n = int(lines[i + 1].split()[0])
        except (ValueError, IndexError):
            break
        end = i + 3 + n
        if end > len(lines):
            break
        last = lines[i:end]
        i = end
    if last is None:
        raise ValueError(f"no complete frame found in trajectory {path}")
    return read_gro(last)


def frame_step(frame: GroFrame) -> int:
    """Step number from a trajectory frame title ('step N')."""
    parts = frame.title.split()
    if len(parts) >= 2 and parts[0] == "step":
        return int(parts[1])
    return 0


def format_velocity_checkpoint(step, mol_names, mol_natom, atom_names,
                               velocities) -> str:
    """One appended block of the reference's TEXT velocity checkpoint
    (print_velocities_checkpoint, general_routines.f90:997-1026): a
    'step  N' line followed by per-atom records in molecule order,
    format (I5,2A5,I5,3F14.6), velocities in internal units (A/ps)."""
    out = [f"step  {step}"]
    i = 0
    for m, (mname, na) in enumerate(zip(mol_names, mol_natom)):
        for a in range(int(na)):
            vx, vy, vz = velocities[i]
            out.append(f"{(m + 1) % 100000:5d}{mname:<5.5s}"
                       f"{atom_names[i]:<5.5s}{a + 1:5d}"
                       f"{vx:14.6f}{vy:14.6f}{vz:14.6f}")
            i += 1
    return "\n".join(out) + "\n"


def read_velocity_checkpoint(path):
    """Last block of a reference-format text velocity checkpoint.

    Returns (step, velocities (N, 3) in A/ps) -- the semantics of
    read_velocity_restart_checkpoint (general_routines.f90:147-178)."""
    with open(path) as f:
        lines = f.read().splitlines()
    starts = [k for k, ln in enumerate(lines) if ln.split()[:1] == ["step"]]
    if not starts:
        raise ValueError(f"no 'step' block in velocity checkpoint {path}")
    k0 = starts[-1]
    step = int(lines[k0].split()[1])
    vel = []
    for ln in lines[k0 + 1:]:
        if ln.split()[:1] == ["step"] or not ln.strip():
            break
        # fixed-width (I5,2A5,I5,3F14.6)
        rest = ln[20:]
        vel.append([float(rest[c * 14:(c + 1) * 14]) for c in range(3)])
    return step, np.asarray(vel, dtype=np.float64)
