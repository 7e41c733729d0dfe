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
(leading axis S of every Topology field); forces from autograd.
"""

import torch

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
    r_heavy = x[heavy_atom]                                     # (S, 3)
    d_jO = pbc.min_image(r_heavy[:, None, :] - x[None], box)    # (S, N, 3)
    one = torch.ones_like(d_jO[..., 0])
    r_OO = torch.sqrt(torch.where(da_m, (d_jO * d_jO).sum(-1), one))
    B, bl, d0, blp, rs, rc = (da_p[..., k] for k in range(6))
    s_OO = _switch(r_OO, rs, rc)
    fac_OO = B * torch.exp(-bl * (r_OO - d0))
    shift_jO = ((r_heavy[:, None, :] - x[None]) - d_jO).detach()
    is_proton = (types == proton_t[:, None]) & amask            # (S, A)
    xa = x[atoms_s]                                             # (S, A, 3)
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


def reference_energy(topo, system):
    """(S,) chemical reference energy of each state's acid
    (get_adiabatic_reference_energy)."""
    S = topo.mol_mtype.shape[0]
    mtype = topo.mol_mtype[torch.arange(S, device=topo.mol_mtype.device),
                           topo.hydronium_mol]
    return system.mt.reference_energy[mtype]
