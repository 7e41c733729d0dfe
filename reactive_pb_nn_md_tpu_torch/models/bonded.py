"""Intra-molecular bonded terms (counterpart of
reactive_pb_nn_md_tpu/models/bonded.py; formulas of
intra_bonded_interactions.f90).

Every function works on molecule-site positions ``xa`` (*B, A, 3) with the
molecule types ``mtype`` (*B,) of any leading batch shape (molecules, or
states x chain molecules) and returns per-molecule sums (*B,).  All bonded
displacements are minimum-imaged: in a diabat topology the transferred
proton can sit across the boundary from its new molecule.
"""

import math

import torch

from ..ops.kernels.segment_sum import take_rows
from ..utils import pbc


def _safe_acos(c):
    eps = 1e-6 if c.dtype == torch.float32 else 1e-9
    return torch.acos(torch.clamp(c, -1.0 + eps, 1.0 - eps))


def _gather_terms(xa, mtype, mmask, idx_table, par_table):
    """Site positions (*B, S, ar, 3), func (*B, S), params (*B, S, C-1) and
    mask (*B, S) of every term of the molecules' templates."""
    table = idx_table[mtype]                                # (*B, S, ar)
    par = par_table[mtype]                                  # (*B, S, C)
    mask = table[..., 0] >= 0
    if mmask is not None:
        mask = mask & mmask[..., None]
    A = xa.shape[-2]
    lead = table.shape[:-2]
    S, ar = table.shape[-2:]
    # molecule b's slot k is row b A + k of the flattened sites; a padded
    # term (-1) is padding to take_rows
    mol = torch.arange(mtype.numel(), device=xa.device)
    idx = table.reshape(-1, S * ar)
    rows = torch.where(idx >= 0, mol[:, None] * A + idx, -1)
    pos = take_rows(xa.reshape(-1, 3), rows).reshape(*lead, S, ar, 3)
    func = torch.round(par[..., 0]).to(torch.int64)
    return pos, func, par[..., 1:], mask


def bond_energy(xa, mtype, box, system, mmask=None):
    pos, func, p, mask = _gather_terms(xa, mtype, mmask, system.mt.bonds,
                                       system.mt.bond_tab)
    dr = pbc.min_image(pos[..., 0, :] - pos[..., 1, :], box)
    r2 = torch.where(mask, torch.sum(dr * dr, -1), torch.ones_like(dr[..., 0]))
    r = torch.sqrt(r2)
    e_harm = 0.5 * p[..., 1] * (r - p[..., 0]) ** 2
    e_g96 = 0.25 * p[..., 1] * (r2 - p[..., 0] ** 2) ** 2
    e_morse = p[..., 0] * (1.0 - torch.exp(-p[..., 1] * (r - p[..., 2]))) ** 2
    zero = torch.zeros_like(r)
    e = torch.where(func == 1, e_harm,
                    torch.where(func == 2, e_g96,
                                torch.where(func == 3, e_morse, zero)))
    return torch.where(mask, e, zero).sum(-1)


def angle_energy(xa, mtype, box, system, mmask=None):
    pos, func, p, mask = _gather_terms(xa, mtype, mmask, system.mt.angles,
                                       system.mt.angle_tab)
    r_ij = pbc.min_image(pos[..., 0, :] - pos[..., 1, :], box)
    r_kj = pbc.min_image(pos[..., 2, :] - pos[..., 1, :], box)
    one = torch.ones_like(r_ij[..., 0])
    zero = torch.zeros_like(one)
    nij2 = torch.where(mask, torch.sum(r_ij * r_ij, -1), one)
    nkj2 = torch.where(mask, torch.sum(r_kj * r_kj, -1), one)
    cos_t = torch.where(mask, torch.sum(r_ij * r_kj, -1), zero) \
        / torch.sqrt(nij2 * nkj2)
    theta = _safe_acos(cos_t)
    e_harm = 0.5 * p[..., 1] * (theta - p[..., 0]) ** 2
    e_cos = 0.5 * p[..., 1] * (cos_t - torch.cos(p[..., 0])) ** 2
    e = torch.where(func == 1, e_harm, torch.where(func == 2, e_cos, zero))
    return torch.where(mask, e, zero).sum(-1)


def dihedral_energy(xa, mtype, box, system, mmask=None):
    pos, func, p, mask = _gather_terms(xa, mtype, mmask,
                                       system.mt.dihedrals,
                                       system.mt.dihedral_tab)
    r_ji = pbc.min_image(pos[..., 1, :] - pos[..., 0, :], box)
    r_kj = pbc.min_image(pos[..., 2, :] - pos[..., 1, :], box)
    r_lk = pbc.min_image(pos[..., 3, :] - pos[..., 2, :], box)
    d_kj_ji = torch.sum(r_kj * r_ji, -1)
    d_lk_kj = torch.sum(r_lk * r_kj, -1)
    d_lk_ji = torch.sum(r_lk * r_ji, -1)
    nji2 = torch.sum(r_ji * r_ji, -1)
    nkj2 = torch.sum(r_kj * r_kj, -1)
    nlk2 = torch.sum(r_lk * r_lk, -1)
    one = torch.ones_like(nji2)
    zero = torch.zeros_like(nji2)
    a_dot_b = torch.where(mask, d_kj_ji * d_lk_kj - d_lk_ji * nkj2, zero)
    a_dot_a = torch.where(mask, nji2 * nkj2 - d_kj_ji ** 2, one)
    b_dot_b = torch.where(mask, nlk2 * nkj2 - d_lk_kj ** 2, one)
    a_dot_a = torch.clamp(a_dot_a, min=1e-12)
    b_dot_b = torch.clamp(b_dot_b, min=1e-12)
    cos_xi = a_dot_b / torch.sqrt(a_dot_a * b_dot_b)
    xi = _safe_acos(cos_xi)
    e_proper = p[..., 1] * (1.0 + torch.cos(p[..., 2] * xi - p[..., 0]))
    xi_fold = torch.where(xi > math.pi / 2.0, torch.abs(xi - math.pi), xi)
    e_improper = 0.5 * p[..., 1] * (xi_fold - p[..., 0]) ** 2
    c = cos_xi
    e_rb = (p[..., 0] - p[..., 1] * c + p[..., 2] * c ** 2
            - p[..., 3] * c ** 3 + p[..., 4] * c ** 4 - p[..., 5] * c ** 5)
    e = torch.where(func == 1, e_proper,
                    torch.where(func == 2, e_improper,
                                torch.where(func == 3, e_rb, zero)))
    return torch.where(mask, e, zero).sum(-1)


def bonded_energies(xa, mtype, box, system, mmask=None):
    """Per-molecule (bond, angle, dihedral) sums."""
    return (bond_energy(xa, mtype, box, system, mmask),
            angle_energy(xa, mtype, box, system, mmask),
            dihedral_energy(xa, mtype, box, system, mmask))
