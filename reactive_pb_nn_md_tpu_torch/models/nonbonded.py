"""Real-space nonbonded pair energies (counterpart of
reactive_pb_nn_md_tpu/models/nonbonded.py; physics of
pair_int_real_space.f90).  Forces come from autograd."""

import torch

from ..utils.constants import CONV_E2A_KJMOL, SQRT_PI


def tang_toennies(x, n):
    """f_n(x) = 1 - e^{-x} sum_{k=0}^{n} x^k / k!, clamped to 1 past x = 40."""
    xc = torch.clamp(x, max=40.0)
    term = torch.ones_like(xc)
    s = torch.ones_like(xc)
    for k in range(1, n + 1):
        term = term * xc / k
        s = s + term
    return torch.where(x < 40.0, 1.0 - s * torch.exp(-xc),
                       torch.ones_like(xc))


def ewald_real(qq, r, alpha):
    return qq * torch.erfc(alpha * r) / r * CONV_E2A_KJMOL


def ewald_exclusion_correction(qq, r, alpha):
    """-qq erf(a r)/r for excluded intra pairs, r -> 0 limit -2a/sqrt(pi) qq."""
    small = 1e-8
    safe_r = torch.where(r < small, torch.ones_like(r), r)
    e = qq * (torch.erfc(alpha * safe_r) - 1.0) / safe_r
    e0 = -2.0 * alpha / SQRT_PI * qq
    return torch.where(r < small, e0, e) * CONV_E2A_KJMOL


def lj(c12, c6, r2):
    inv_r6 = 1.0 / (r2 * r2 * r2)
    return c12 * inv_r6 * inv_r6 - c6 * inv_r6


def sapt(params, r, r2):
    """SAPT-FF Buckingham; params[..., 0:6] = A, B, C6, C8, C10, C12."""
    A, B = params[..., 0], params[..., 1]
    x = B * r
    inv_r2 = 1.0 / r2
    inv_r6 = inv_r2 * inv_r2 * inv_r2
    inv_r8 = inv_r6 * inv_r2
    inv_r10 = inv_r8 * inv_r2
    inv_r12 = inv_r10 * inv_r2
    e = A * torch.exp(-x)
    e = e - tang_toennies(x, 6) * params[..., 2] * inv_r6
    e = e - tang_toennies(x, 8) * params[..., 3] * inv_r8
    e = e - tang_toennies(x, 10) * params[..., 4] * inv_r10
    e = e - tang_toennies(x, 12) * params[..., 5] * inv_r12
    return e


def vdw_pair_energy(vtype, params, params_14, is_14, r, r2, has_sapt=True):
    """Dispatch over vdw type codes (0 LJ / 1 SAPT / -1 none); 1-4 pairs
    take the special C12/C6 table."""
    p_lj = torch.where(is_14[..., None], params_14, params)
    e_lj = lj(p_lj[..., 0], p_lj[..., 1], r2)
    e = torch.where(vtype == 0, e_lj, torch.zeros_like(e_lj))
    if has_sapt:
        e = torch.where(vtype == 1, sapt(params, r, r2), e)
    return e
