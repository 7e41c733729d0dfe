"""MS-EVB special repulsive interactions, diagonal terms (counterpart of
reactive_pb_nn_md_tpu/models/repulsion.py; eqs. 7-9 of JPC B 2008, 112,
467, as in ms_evb.f90:2259-2504).

  three-atom term : sum over solvent heavy atoms J with a (J, heavy, H)
                    entry: S(r_OO) B e^{-b(r_OO-d0)} sum_H e^{-b' q^2},
                    q = (r_J + r_O)/2 - r_H
  Born-Mayer      : sum over (J, hydronium atom) pairs with a (J, type_i)
                    entry: S(r) C e^{-c(r-d0)}
  switch S        : cubic switch between rs and rc

Dense masked sums over all atoms, batched over the states' topologies
(leading axis S of every Topology field); forces from autograd.  On the
on-demand cell path the same terms are summed over the changed-molecule
superset's neighbor rows instead (ms_evb_repulsion_batched_domain).
"""

import torch

from ..ops.kernels.segment_sum import take_rows
from ..utils import pbc


def _switch(r, rs, rc):
    """Cubic switching function, 1 below rs, 0 above rc."""
    denom3 = torch.clamp((rc - rs) ** 3, min=1e-12)
    mid = 1.0 - (r - rs) ** 2 / denom3 * (3.0 * rc - rs - 2.0 * r)
    return torch.where(r >= rc, torch.zeros_like(r),
                       torch.where(r < rs, torch.ones_like(r), mid))


def ms_evb_repulsion(x, box, topo, system):
    """(S,) special repulsion energy of each state topology's hydronium."""
    evb, mt = system.evb, system.mt
    S = topo.atom_type.shape[0]
    s_idx = torch.arange(S, device=x.device)
    h = topo.hydronium_mol                                      # (S,)
    mtype = topo.mol_mtype[s_idx, h]
    atoms = topo.mol_atoms[s_idx, h]                            # (S, A)
    amask = atoms >= 0
    atoms_s = atoms.clamp(min=0)
    types = torch.where(amask, torch.gather(topo.atom_type, 1, atoms_s),
                        torch.full_like(atoms, -1))
    heavy_t = mt.heavy_atype[mtype]
    proton_t = mt.proton_atype[mtype]
    heavy_atom = torch.gather(
        atoms_s, 1, torch.argmax((types == heavy_t[:, None]).to(torch.int64),
                                 1, keepdim=True))[:, 0]
    solvent = topo.atom_mol != h[:, None]                       # (S, N)
    t_j = topo.atom_type                                        # (S, N)

    # ----- three-atom O-O repulsion
    t_heavy = topo.atom_type[s_idx, heavy_atom]
    hp0 = t_heavy.clamp(min=0)[:, None]
    hp1 = proton_t.clamp(min=0)[:, None]
    da_p = evb.da_params[t_j, hp0, hp1].to(x.dtype)             # (S, N, 6)
    da_m = evb.da_mask[t_j, hp0, hp1] & solvent
    r_heavy = take_rows(x, heavy_atom)                          # (S, 3)
    d_jO = pbc.min_image(r_heavy[:, None, :] - x[None], box)    # (S, N, 3)
    one = torch.ones_like(d_jO[..., 0])
    r_OO = torch.sqrt(torch.where(da_m, (d_jO * d_jO).sum(-1), one))
    B, bl, d0, blp, rs, rc = (da_p[..., k] for k in range(6))
    s_OO = _switch(r_OO, rs, rc)
    fac_OO = B * torch.exp(-bl * (r_OO - d0))
    shift_jO = ((r_heavy[:, None, :] - x[None]) - d_jO).detach()
    is_proton = (types == proton_t[:, None]) & amask            # (S, A)
    xa = take_rows(x, atoms_s)                                  # (S, A, 3)
    r_H = r_heavy[:, None, :] + pbc.min_image(xa - r_heavy[:, None, :], box)
    xj = x[None, :, None, :]
    d_jH = (r_H[:, None, :, :] - shift_jO[:, :, None, :]) - xj  # (S, N, A, 3)
    q = (xj + (xj + d_jO[:, :, None, :])) / 2.0 - (xj + d_jH)
    q2 = (q * q).sum(-1)
    exp_q = torch.where(is_proton[:, None, :], torch.exp(-blp[..., None] * q2),
                        torch.zeros_like(q2))
    e_three = torch.where(da_m, s_OO * fac_OO * exp_q.sum(-1),
                          torch.zeros_like(r_OO)).sum(1)

    # ----- Born-Mayer proton-acceptor terms
    t_i = torch.where(amask, types, torch.zeros_like(types))
    pa_p = evb.pa_params[t_j[:, :, None], t_i[:, None, :]].to(x.dtype)
    pa_m = (evb.pa_mask[t_j[:, :, None], t_i[:, None, :]]
            & solvent[:, :, None] & amask[:, None, :])           # (S, N, A)
    d_ji = pbc.min_image(xa[:, None, :, :] - x[None, :, None, :], box)
    r_ji = torch.sqrt(torch.where(pa_m, (d_ji * d_ji).sum(-1),
                                  torch.ones_like(d_ji[..., 0])))
    C, cl, d0h, rsh, rch = (pa_p[..., k] for k in range(5))
    e_bm = _switch(r_ji, rsh, rch) * C * torch.exp(-cl * (r_ji - d0h))
    e_born_mayer = torch.where(pa_m, e_bm, torch.zeros_like(e_bm)).sum((1, 2))
    return e_three + e_born_mayer


_DOMAIN_IMPL = "auto"       # "auto" (on-demand cell path only) | "on" | "off"


def set_domain_impl(impl):
    """Select the repulsion sweep: the candidate rows ("on"), the dense
    O(N) scan ("off") or by the neighbor path ("auto") -- a test
    override, as in the JAX package."""
    global _DOMAIN_IMPL
    if impl not in ("auto", "on", "off"):
        raise ValueError(f"unknown repulsion impl {impl!r}")
    _DOMAIN_IMPL = impl


def domain_repulsion_active(system, on_demand):
    """The candidate-row sweep is exact iff every repulsion switch outer
    radius fits inside the rows' coverage (the real-space cutoff)."""
    if not (0.0 < system.evb_rep_rc_max <= system.real_space_cutoff):
        return False
    if _DOMAIN_IMPL != "auto":
        return _DOMAIN_IMPL == "on"
    return on_demand


def ms_evb_repulsion_batched_domain(x, box, topo, system, xu, pos_in_U, j,
                                    rmask, atom_type0):
    """(S,) special repulsion of each state from the field-decomposition
    rows, instead of the dense O(N)-per-state sweep of ms_evb_repulsion
    (counterpart of the JAX package's ms_evb_repulsion_batched_domain).

    Exact when every switch radius fits the row coverage
    (domain_repulsion_active): the three-atom term only reaches rc from
    the hydronium heavy atom, each Born-Mayer term only from its own acid
    atom, and every acid atom of every state lies in the changed-molecule
    superset U, whose rows j (U, Kf) (mask rmask) are given.  Candidates
    in U take each state's types and acid membership; the others keep
    the principle topology's (atom_type0).  xu = x[U atoms]; pos_in_U
    (N,) is each atom's row in U or -1.  The JAX package's one-hot
    contractions are plain indexing here (exact)."""
    evb, mt = system.evb, system.mt
    S, U = topo.atom_type.shape[0], xu.shape[0]
    f = xu.dtype
    s_idx = torch.arange(S, device=x.device)
    h = topo.hydronium_mol
    mtype = topo.mol_mtype[s_idx, h]
    atoms = topo.mol_atoms[s_idx, h]                            # (S, A)
    amask = atoms >= 0
    a_safe = atoms.clamp(min=0)
    types = torch.where(amask, torch.gather(topo.atom_type, 1, a_safe),
                        torch.full_like(atoms, -1))
    heavy_tr, proton_tr = mt.heavy_atype[mtype], mt.proton_atype[mtype]
    heavy_t, proton_t = heavy_tr.clamp(min=0), proton_tr.clamp(min=0)

    slotU = torch.where(amask, pos_in_U[a_safe], torch.full_like(atoms, -1))
    row_ok = amask & (slotU >= 0)
    su = slotU.clamp(min=0)
    xa_s = take_rows(xu, su)
    xa = torch.where(row_ok[..., None], xa_s, torch.zeros_like(xa_s))
    jA = j[su]                                                  # (S, A, Kf)
    maskA = rmask[su] & row_ok[..., None]
    jU = pos_in_U[jA]
    inU_j = jU >= 0
    jU_s = jU.clamp(min=0).reshape(S, -1)
    # a device value: a Python scalar in an indexed assignment is copied
    # from the host (a synchronization); out of place: a replica batch
    # vmaps this function
    acidU = torch.zeros((S, U + 1), dtype=torch.bool,
                        device=x.device).index_put(
        (s_idx[:, None], torch.where(row_ok, slotU,
                                     torch.full_like(slotU, U))),
        torch.ones((), dtype=torch.bool, device=x.device))
    in_acid = torch.gather(acidU[:, :U], 1, jU_s).reshape(jU.shape) & inU_j
    # a candidate in U has row pos_in_U[j] of U, so its state type is the
    # state topology's type of j itself
    t_in = torch.gather(topo.atom_type, 1,
                        jA.reshape(S, -1)).reshape(jA.shape)
    t_j = torch.where(inU_j, t_in, atom_type0[jA])
    solvent = maskA & ~in_acid
    # the candidates maskA leaves out are padding to take_rows
    xj = take_rows(x, torch.where(maskA, jA, -1))               # (S, A, Kf, 3)

    # ----- three-atom O-O repulsion on the heavy atom's row
    hslot = torch.argmax((types == heavy_tr[:, None]).to(torch.int64), 1)
    xH = xa[s_idx, hslot]                                       # (S, 3)
    xjH = xj[s_idx, hslot]                                      # (S, Kf, 3)
    tjH = t_j[s_idx, hslot]
    d_jO = pbc.min_image(xH[:, None, :] - xjH, box)
    da_p = evb.da_params[tjH, heavy_t[:, None], proton_t[:, None]].to(f)
    da_m = (evb.da_mask[tjH, heavy_t[:, None], proton_t[:, None]]
            & solvent[s_idx, hslot])
    one = torch.ones_like(d_jO[..., 0])
    r_OO = torch.sqrt(torch.where(da_m, (d_jO * d_jO).sum(-1), one))
    B, bl, d0, blp, rs, rc = (da_p[..., k] for k in range(6))
    s_OO = _switch(r_OO, rs, rc)
    fac_OO = B * torch.exp(-bl * (r_OO - d0))
    shift_jO = ((xH[:, None, :] - xjH) - d_jO).detach()
    is_proton = (types == proton_tr[:, None]) & amask            # (S, A)
    r_H = xH[:, None, :] + pbc.min_image(xa - xH[:, None, :], box)
    d_jH = ((r_H[:, None, :, :] - shift_jO[:, :, None, :])
            - xjH[:, :, None, :])                               # (S, Kf, A, 3)
    q = d_jO[:, :, None, :] / 2.0 - d_jH
    q2 = (q * q).sum(-1)
    exp_q = torch.where(is_proton[:, None, :],
                        torch.exp(-blp[..., None] * q2), torch.zeros_like(q2))
    e_three = torch.where(da_m, s_OO * fac_OO * exp_q.sum(-1),
                          torch.zeros_like(r_OO)).sum(1)

    # ----- Born-Mayer terms, each on its own acid atom's row
    t_i = torch.where(amask, types, torch.zeros_like(types))[..., None]
    pa_p = evb.pa_params[t_j, t_i].to(f)                        # (S, A, Kf, 5)
    pa_m = evb.pa_mask[t_j, t_i] & solvent & amask[..., None]
    d_ji = pbc.min_image(xa[:, :, None, :] - xj, box)
    r_ji = torch.sqrt(torch.where(pa_m, (d_ji * d_ji).sum(-1),
                                  torch.ones_like(d_ji[..., 0])))
    C, cl, d0h, rsh, rch = (pa_p[..., k] for k in range(5))
    e_bm = _switch(r_ji, rsh, rch) * C * torch.exp(-cl * (r_ji - d0h))
    return e_three + torch.where(pa_m, e_bm, torch.zeros_like(e_bm)).sum(
        (1, 2))


def reference_energy(topo, system):
    """(S,) chemical reference energy of each state's acid
    (get_adiabatic_reference_energy)."""
    S = topo.mol_mtype.shape[0]
    mtype = topo.mol_mtype[torch.arange(S, device=topo.mol_mtype.device),
                           topo.hydronium_mol]
    return system.mt.reference_energy[mtype]
