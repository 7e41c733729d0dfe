"""Per-diabat topologies: proton hops applied as index rewrites
(counterpart of reactive_pb_nn_md_tpu/evb/topology_ops.py; replaces the
reference's array shifting, ms_evb.f90:2677-2840, conjugate retyping
:883-932 and template reordering :941-1006).

Positions and global atom indices never change, so forces from autograd
are already in global atom order.  Everything is batched over the padded
state axis: a state's chain touches at most C+1 molecules, so the hops run
on (S, C+1, A) chain blocks and the full-size arrays are written once.
"""

from dataclasses import dataclass

import torch

from ..topology import Topology
from .enumerate import DiabatSet


@dataclass
class DiabatBatch:
    dset: DiabatSet
    topo: Topology                # batched over the leading state axis
    changed_atoms: torch.Tensor   # (S, 2*C*A), -1 padded
    changed_mask: torch.Tensor    # (S, 2*C*A) bool


def state_topology(topo_b: Topology, s) -> Topology:
    """State s's topology out of a batch of diabat topologies; s an int
    or a () tensor, read on the device (no host synchronization)."""
    if isinstance(s, int):
        return Topology(**{k: getattr(topo_b, k)[s]
                           for k in Topology.__dataclass_fields__})
    s = s.reshape(1)
    return Topology(**{k: getattr(topo_b, k).index_select(0, s)[0]
                       for k in Topology.__dataclass_fields__})


def _scatter_update(arr, idx, new_vals, mask):
    """(S, n) copies of arr (n,) with arr[idx] set to new_vals where mask,
    written as masked deltas (duplicate masked indices add zero)."""
    S = idx.shape[0]
    out = arr.expand(S, *arr.shape).clone()
    delta = torch.where(mask, new_vals - torch.gather(out, 1, idx),
                        torch.zeros_like(new_vals))
    return out.scatter_add(1, idx, delta)


def _reorder_to_template(atoms, types, template):
    """Greedy stable match of slot lists (S, A) to type templates (S, A):
    for each slot i whose type mismatches, rotate in the first later slot
    with the right type (reorder_molecule_data_structures)."""
    A = atoms.shape[1]
    slots = torch.arange(A, device=atoms.device)
    for i in range(A):
        need = (template[:, i] >= 0) & (types[:, i] != template[:, i])
        cand = (slots > i)[None] & (types == template[:, i:i + 1])
        j = torch.argmax(cand.to(torch.int64), dim=1)
        do = (need & cand.any(1))[:, None]
        src = torch.where(slots == i, j[:, None],
                          torch.where((slots > i) & (slots <= j[:, None]),
                                      slots - 1, slots))
        atoms = torch.where(do, torch.gather(atoms, 1, src), atoms)
        types = torch.where(do, torch.gather(types, 1, src), types)
    return atoms, types


def _rows(t, r):
    """t[s, r[s]] for a (S, R, ...) tensor and (S,) row index."""
    return t[torch.arange(t.shape[0], device=t.device), r]


def _set_rows(t, r, v):
    return t.index_put((torch.arange(t.shape[0], device=t.device), r), v)


def changed_atoms(topo, hop_log):
    """Atoms of every molecule a state's chain touches (membership in the
    principle topology), deduplicated: ((S, 2CA), mask)."""
    S = hop_log.shape[0]
    mols = torch.cat([hop_log[:, :, 0], hop_log[:, :, 3]], dim=1)
    atoms = topo.mol_atoms[mols.clamp(min=0)]                   # (S, 2C, A)
    cmask = ((mols >= 0)[:, :, None] & (atoms >= 0)).reshape(S, -1)
    flat = atoms.reshape(S, -1)
    n = flat.shape[1]
    lower = torch.ones((n, n), dtype=torch.bool,
                       device=flat.device).tril(-1)
    seen = ((flat[:, :, None] == flat[:, None, :]) & lower
            & cmask[:, None, :]).any(2)
    cmask = cmask & ~seen
    return torch.where(cmask, flat, torch.full_like(flat, -1)), cmask


def build_diabat_topologies(topo, dset: DiabatSet, system) -> DiabatBatch:
    """Apply every state's hop chain to the principle topology."""
    ff, mt, evb = system.ff, system.mt, system.evb
    A = system.max_atoms_per_mol
    hop = dset.hop_log
    S, C = hop.shape[0], hop.shape[1]
    R = C + 1
    dev = hop.device
    slots = torch.arange(A, device=dev)
    rows = torch.arange(R, device=dev)

    # chain molecules: donor of hop 0, then each hop's acceptor; a chain
    # that revisits a molecule uses its first row
    cm = torch.cat([hop[:, :1, 0], hop[:, :, 3]], dim=1)        # (S, R)
    canon = torch.argmax((cm[:, :, None] == cm[:, None, :]).to(torch.int64),
                         dim=2)
    canon = torch.where(cm >= 0, canon, rows)
    is_canon = canon == rows
    cms = cm.clamp(min=0)
    catoms = topo.mol_atoms[cms]                                # (S, R, A)
    ctype = torch.where(catoms >= 0, topo.atom_type[catoms.clamp(min=0)],
                        torch.full_like(catoms, -1))
    cmt = topo.mol_mtype[cms]
    cnat = topo.mol_natom[cms]

    for i in range(C):
        proton, heavy_a = hop[:, i, 1], hop[:, i, 4]
        d_row, a_row = canon[:, i], canon[:, i + 1]
        # ---- the donor loses the proton: compact its slots, conjugate
        datoms, dtypes = _rows(catoms, d_row), _rows(ctype, d_row)
        s_p = torch.argmax((datoms == proton[:, None]).to(torch.int64), 1)
        pad = torch.full_like(datoms[:, :1], -1)
        sh_a = torch.cat([datoms[:, 1:], pad], 1)
        sh_t = torch.cat([dtypes[:, 1:], pad], 1)
        keep_slot = slots[None] < s_p[:, None]
        datoms_n = torch.where(keep_slot, datoms, sh_a)
        dtypes_n = torch.where(keep_slot, dtypes, sh_t)
        dtypes_n = torch.where(datoms_n >= 0,
                               evb.conjugate_atype[dtypes_n.clamp(min=0)],
                               torch.full_like(dtypes_n, -1))
        d_base = mt.conjugate_mtype[_rows(cmt, d_row)]
        datoms_n, dtypes_n = _reorder_to_template(datoms_n, dtypes_n,
                                                  mt.atype[d_base])
        n_catoms = _set_rows(catoms, d_row, datoms_n)
        n_ctype = _set_rows(ctype, d_row, dtypes_n)
        n_cmt = _set_rows(cmt, d_row, d_base)
        n_cnat = _set_rows(cnat, d_row, _rows(cnat, d_row) - 1)

        # ---- the acceptor gains the proton at its last slot, conjugates
        n_a = _rows(n_cnat, a_row)
        aatoms = torch.where(slots[None] == n_a[:, None], proton[:, None],
                             _rows(n_catoms, a_row))
        acid_t = mt.conjugate_mtype[_rows(n_cmt, a_row)]
        atypes = torch.where(
            aatoms >= 0,
            evb.conjugate_atype[_rows(n_ctype, a_row).clamp(min=0)],
            torch.full_like(aatoms, -1))
        atypes = torch.where(aatoms == proton[:, None],
                             mt.proton_atype[acid_t][:, None], atypes)
        atypes = torch.where(aatoms == heavy_a[:, None],
                             mt.heavy_atype[acid_t][:, None], atypes)
        aatoms, atypes = _reorder_to_template(aatoms, atypes,
                                              mt.atype[acid_t])
        n_catoms = _set_rows(n_catoms, a_row, aatoms)
        n_ctype = _set_rows(n_ctype, a_row, atypes)
        n_cmt = _set_rows(n_cmt, a_row, acid_t)
        n_cnat = _set_rows(n_cnat, a_row, n_a + 1)

        keep = i < dset.n_hops                                  # (S,)
        catoms = torch.where(keep[:, None, None], n_catoms, catoms)
        ctype = torch.where(keep[:, None, None], n_ctype, ctype)
        cmt = torch.where(keep[:, None], n_cmt, cmt)
        cnat = torch.where(keep[:, None], n_cnat, cnat)

    # ---- write the chain blocks into full-size per-state arrays
    row_ok = (cm >= 0) & is_canon                               # (S, R)
    amask = (row_ok[:, :, None] & (catoms >= 0)).reshape(S, -1)
    aidx = catoms.clamp(min=0).reshape(S, -1)
    tvals = ctype.clamp(min=0).reshape(S, -1)
    mol_atoms = topo.mol_atoms.expand(S, *topo.mol_atoms.shape).clone()
    delta = torch.where(row_ok[:, :, None],
                        catoms - topo.mol_atoms[cms],
                        torch.zeros_like(catoms))
    mol_atoms = mol_atoms.scatter_add(1, cms[:, :, None].expand(S, R, A),
                                      delta)
    batch_topo = Topology(
        mol_mtype=_scatter_update(topo.mol_mtype, cms, cmt, row_ok),
        mol_natom=_scatter_update(topo.mol_natom, cms, cnat, row_ok),
        mol_atoms=mol_atoms,
        atom_mol=_scatter_update(
            topo.atom_mol, aidx,
            cms[:, :, None].expand(S, R, A).reshape(S, -1), amask),
        atom_slot=_scatter_update(
            topo.atom_slot, aidx,
            slots.expand(S, R, A).reshape(S, -1), amask),
        atom_type=_scatter_update(topo.atom_type, aidx, tvals, amask),
        charge=_scatter_update(topo.charge, aidx, ff.charge_by_type[tvals],
                               amask),
        hydronium_mol=torch.where(dset.n_hops > 0, dset.hydronium_of,
                                  topo.hydronium_mol))
    changed, cmask = changed_atoms(topo, hop)
    return DiabatBatch(dset=dset, topo=batch_topo, changed_atoms=changed,
                       changed_mask=cmask)
