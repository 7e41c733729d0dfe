"""Diabat-state enumeration (counterpart of reactive_pb_nn_md_tpu/evb/enumerate.py;
evb_conduct_proton_transfer_recursive / find_evb_reactive_neighbors,
ms_evb.f90:498-764).

A breadth-first expansion with fixed shapes, on the device: evb_max_chain
levels, each expanding every state of the previous level at once.  The
search runs in the principle topology; a (donor molecule, reactive
proton) pair accepts up to evb_max_neighbors acceptor atoms (molecules
within evb_first_solvation_cutoff COM-COM whose reactive base atom is
within evb_reactive_pair_distance of the proton); chains stop at the
principle hydronium.  State 0 is the principle diabat; every other state
records its parent.

Hop-log fields: [donor_mol, proton_atom, donor_heavy_atom, acceptor_mol,
acceptor_heavy_atom], atoms as global indices.
"""

from dataclasses import dataclass

import torch

from ..utils import pbc
from ..ops.neighbors import CellTable, first_true_columns, rows_on_demand


@dataclass
class DiabatSet:
    n_states: torch.Tensor       # ()
    hop_log: torch.Tensor        # (S, C, 5), -1 padded
    n_hops: torch.Tensor         # (S,)
    parent: torch.Tensor         # (S,), -1 for state 0
    hydronium_of: torch.Tensor   # (S,) acid molecule of each diabat
    overflow: torch.Tensor       # () bool: more states than the cap
    # () bool: an on-demand adjacency row exceeded its capacity (cell
    # path); the simulation loop regrows the neighbor capacities, not the
    # state cap
    row_overflow: torch.Tensor = None


def molecule_com(x, mol_atoms, mass, box=None):
    """Centre of mass of every molecule of mol_atoms (*B, A), -1 padded.
    With `box`, atoms are minimum-imaged against the molecule's first atom
    first, so molecules split across the boundary are whole."""
    mask = mol_atoms >= 0
    idx = mol_atoms.clamp(min=0)
    w = torch.where(mask, mass[idx], torch.zeros_like(mass[idx]))
    xs = x[idx]
    if box is not None:
        anchor = xs[..., :1, :]
        xs = anchor + pbc.min_image(xs - anchor, box)
    return (w[..., None] * xs).sum(-2) / w.sum(-1)[..., None]


def enumerate_diabats(x, box, topo, system, full_idx=None, com=None):
    """Level-synchronous BFS over proton-hop chains at cap
    system.evb_max_states.  `full_idx` (N, K) restricts each proton's
    candidate search to its adjacency row (ascending j, so the discovered
    state order is that of the dense search); a CellTable gives the same
    rows on demand for just the expanded protons."""
    x = x.detach()
    dev = x.device
    S = system.evb_max_states
    C = system.evb_max_chain
    N = x.shape[0]
    Anb = min(system.evb_max_neighbors, system.n_atoms)
    on_demand = isinstance(full_idx, CellTable)
    if on_demand:
        Anb = min(Anb, full_idx.row_cap)
    elif full_idx is not None:
        Anb = min(Anb, full_idx.shape[1])
    mt = system.mt
    if com is None:
        com = molecule_com(x, topo.mol_atoms, system.mass, box)
    com = com.detach()
    principle_h = topo.hydronium_mol
    if mt.base_atype is not None:
        base_atom = mt.base_atype[topo.atom_type] > 0
    else:
        base_atom = mt.reactive_bases[topo.mol_mtype[topo.atom_mol],
                                      topo.atom_slot] > 0
    fsc2 = system.evb_first_solvation_cutoff ** 2
    rpd2 = system.evb_reactive_pair_distance ** 2

    hop_log = torch.full((S, C, 5), -1, dtype=torch.int64, device=dev)
    # meta columns: [n_hops, parent, donor_of, stop]
    # (built out of place: a replica batch vmaps this function)
    sidx = torch.arange(S, device=dev)
    zero_s = torch.zeros(S, dtype=torch.int64, device=dev)
    meta = torch.stack([zero_s, zero_s - 1,
                        torch.where(sidx == 0, principle_h, zero_s - 1),
                        zero_s], dim=-1)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    row_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    lvl_begin = torch.zeros((), dtype=torch.int64, device=dev)
    lvl_end = torch.ones((), dtype=torch.int64, device=dev)
    P = mt.proton_slots.shape[1]

    for level in range(C):
        # level 0 expands the principle diabat only; level 1 only the
        # <= P*Anb one-hop states; deeper levels the whole batch
        SL = 1 if level == 0 else (min(S, 1 + P * Anb) if level == 1
                                   else S)
        sidx_l = torch.arange(SL, device=dev)
        at_level = ((sidx_l >= lvl_begin) & (sidx_l < lvl_end)
                    & (meta[:SL, 3] == 0))
        d_all = meta[:SL, 2].clamp(min=0)

        # ---- candidates (SL, P, Anb) of every expanded donor molecule
        dcom = pbc.min_image(com[d_all][:, None, :] - com[None], box)
        com_ok = (dcom * dcom).sum(-1) < fsc2                    # (SL, M)
        d_mtype = topo.mol_mtype[d_all]
        pslots = mt.proton_slots[d_mtype]                        # (SL, P)
        psafe = pslots.clamp(min=0)
        d_mol_atoms = topo.mol_atoms[d_all]                      # (SL, A)
        d_atoms = torch.gather(d_mol_atoms, 1, psafe)
        proton_ok = (pslots >= 0) & (d_atoms >= 0)
        g_p = d_atoms.clamp(min=0)
        if full_idx is None:
            jg = torch.arange(N, device=dev).expand(SL, P, N)
            row_ok = torch.ones_like(jg, dtype=torch.bool)
        else:
            if on_demand:
                rows, over_r = rows_on_demand(full_idx, x, box,
                                              g_p.reshape(-1))
                rows = rows.reshape(SL, P, -1)                   # (SL, P, Kr)
                row_overflow = row_overflow | (
                    over_r.reshape(SL, P) & proton_ok
                    & at_level[:, None]).any()
            else:
                rows = full_idx[g_p]                             # (SL, P, K)
            row_ok = rows >= 0
            jg = rows.clamp(min=0)
        jmol = topo.atom_mol[jg]
        dr = pbc.min_image(x[g_p][:, :, None, :] - x[jg], box)
        dist2 = (dr * dr).sum(-1)
        cand = (proton_ok[:, :, None] & row_ok & base_atom[jg]
                & (jmol != d_all[:, None, None])
                & torch.gather(com_ok, 1, jmol.reshape(SL, -1)).reshape(
                    jmol.shape)
                & (dist2 < rpd2) & at_level[:, None, None])
        j_atom = first_true_columns(cand, Anb, jg)               # (SL, P, Anb)
        heavy_slot = torch.gather(mt.bonded_heavy_slot[d_mtype], 1, psafe)
        heavy_g = torch.where(
            heavy_slot >= 0,
            torch.gather(d_mol_atoms, 1, heavy_slot.clamp(min=0)),
            torch.full_like(heavy_slot, -1))

        # ---- append the new states in (state, proton, candidate) order
        j_flat = j_atom.reshape(-1)
        valid = j_flat >= 0
        src_state = sidx_l.repeat_interleave(P * Anb)
        p_rep = torch.arange(P, device=dev)[None, :, None].expand(
            SL, P, Anb).reshape(-1)
        slot = lvl_end + torch.cumsum(valid.to(torch.int64), 0) - 1
        tgt = torch.where(valid & (slot < S), slot, torch.full_like(slot, S))
        j_safe = j_flat.clamp(min=0)
        a_mol = topo.atom_mol[j_safe]
        new_hop = torch.stack([d_all[src_state], g_p[src_state, p_rep],
                               heavy_g[src_state, p_rep], a_mol, j_safe],
                              dim=-1)
        chain = torch.where(
            (torch.arange(C, device=dev) == level)[None, :, None],
            new_hop[:, None, :], hop_log[src_state])
        new_meta = torch.stack(
            [torch.full_like(a_mol, level + 1), src_state, a_mol,
             (a_mol == principle_h).to(torch.int64)], dim=-1)
        hop_log = torch.cat([hop_log, hop_log[:1]]).index_put(
            (tgt,), chain)[:S]
        meta = torch.cat([meta, meta[:1]]).index_put((tgt,), new_meta)[:S]

        n_new = valid.sum()
        overflow = overflow | (lvl_end + n_new > S)
        lvl_begin = lvl_end
        lvl_end = torch.clamp(lvl_end + n_new, max=S)

    return DiabatSet(n_states=lvl_end, hop_log=hop_log, n_hops=meta[:, 0],
                     parent=meta[:, 1], hydronium_of=meta[:, 2],
                     overflow=overflow, row_overflow=row_overflow)
