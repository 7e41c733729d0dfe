"""Smooth Particle-Mesh Ewald, reciprocal space (counterpart of
reactive_pb_nn_md_tpu/models/pme.py; Essmann 1995, pme.f90).

  grid_Q                  -> charge_grid: kernel B (ops/kernels/pme_spread),
                             or D (ops/kernels/pme_slab) with a slab cap
  FFT + CB                -> torch.fft.rfftn, E = conv/2 sum w CB |F(Q)|^2
  CB_array / bm_sq        -> cb_half
  update_Ewald_self       -> ewald_self
  per-diabat modify_Q_grid + FFT -> recip_delta_perstate: kernel C
                             (ops/kernels/recip_perstate), no per-diabat FFT
"""

import math

import numpy as np
import torch

from ..utils.constants import CONV_E2A_KJMOL, SQRT_PI
from ..utils import pbc
from ..ops.bspline import bspline_weights, bm_sq_factors
from ..ops.kernels import pme_slab, pme_spread, recip_perstate


def charge_grid(x, q, box, K, order, scap=0, shard=None):
    """((K, K, K) charge grid of all atoms, slab overflow ()).

    With a static slab capacity (scap > 0, System.pme_scap) the slab path
    (kernels D1/D2 on CUDA tensors), whose overflow flag says an x-slab
    held more than scap atoms: the grid then lacks atoms and the
    simulation loop regrows scap.  Otherwise the per-atom spread (kernels
    B1/B2), which cannot overflow.  The dispatch is the JAX package's
    (models/pme.py:93-114), so both packages take one path per deck.

    With `shard` (parallel/shard.py) each rank spreads its own atoms and
    the grids are summed over the ranks before the grid is returned (its
    gradient passed through: each rank's backward gathers its own atoms);
    the overflow is this rank's."""
    if shard is not None:
        a = shard.atoms(x.shape[0])
        Q, over = charge_grid(x[a], q[a], box, K, order, scap)
        return shard.sum(Q, "grid"), over
    if scap:
        return pme_slab.charge_grid_slab(x, q, box, K, order, scap)
    return (pme_spread.charge_grid(x, q, box, K, order),
            torch.zeros((), dtype=torch.bool, device=x.device))


def delta_charge_grid(x, dq, atom_idx, mask, box, K, order):
    """Grid of the charge deltas dq of the atoms atom_idx (-1 padded,
    mask False there): the incremental modify_Q_grid update."""
    xi = x[atom_idx.clamp(min=0)]
    u = pbc.scaled_grid_coords(xi, box, K)
    w, nearpt = bspline_weights(u.reshape(-1), order)
    n = xi.shape[0]
    dqm = torch.where(mask, dq, torch.zeros_like(dq))
    return pme_spread.spread(w.reshape(n, 3, order).contiguous(),
                             nearpt.reshape(n, 3).contiguous(),
                             dqm.contiguous(), K).reshape(K, K, K)


def cb_half(box, K, order, alpha, dtype=torch.float64):
    """CB(m) exp(-pi^2 |m|^2/alpha^2) / (pi V |m|^2) |b1 b2 b3|^2 on the
    rfft half spectrum (K, K, K//2+1), times the rfft plane weights."""
    box = box.to(dtype)
    dev = box.device
    vol = pbc.box_volume(box)
    kk = pbc.recip_vectors(box)
    ar = torch.arange(K, device=dev)
    m1 = torch.where(ar > K // 2, ar - K, ar).to(dtype)
    Kh = K // 2 + 1
    m3 = torch.arange(Kh, device=dev).to(dtype)
    bm = torch.as_tensor(bm_sq_factors(K, order), dtype=dtype, device=dev)
    mm = (m1[:, None, None, None] * kk[0] + m1[None, :, None, None] * kk[1]
          + m3[None, None, :, None] * kk[2])
    mag = torch.sum(mm * mm, dim=-1)
    mag_safe = torch.where(mag > 0, mag, torch.ones_like(mag))
    cb = (torch.exp(-math.pi ** 2 * mag / alpha ** 2)
          / (vol * math.pi * mag_safe)
          * bm[:, None, None] * bm[None, :, None] * bm[None, None, :Kh])
    cb = torch.where(mag > 0, cb, torch.zeros_like(cb))
    w = torch.full((Kh,), 2.0, dtype=dtype, device=dev)
    w[0] = 1.0
    if K % 2 == 0:
        w[Kh - 1] = 1.0
    return cb * w[None, None, :]


def recip_energy(Q, cbw):
    F = torch.fft.rfftn(Q)
    return 0.5 * CONV_E2A_KJMOL * torch.sum(cbw * (F.real ** 2
                                                   + F.imag ** 2))


def ewald_self(q, alpha):
    """-(alpha/sqrt(pi)) sum q_i^2 (update_Ewald_self)."""
    return -alpha / SQRT_PI * torch.sum(q * q) * CONV_E2A_KJMOL


def structure_axis_factors(x_u, box, K, order):
    """Real and imaginary parts of the per-axis structure factors
    A_u(m) = sum_j w_uj exp(-2 pi i m g_uj / K) (and B, C; C only on the
    half spectrum).  The phase m g is reduced mod K in integers, so the
    fp32 sin/cos stay accurate.  Returns ((Ar, Ai), (Br, Bi), (Cr, Ci)),
    each (U, n_m)."""
    f = x_u.dtype
    u = pbc.scaled_grid_coords(x_u, box, K)
    w, nearpt = bspline_weights(u.reshape(-1), order)
    U = x_u.shape[0]
    w = w.reshape(U, 3, order)
    k = torch.arange(order, device=x_u.device)
    g = torch.remainder(nearpt.reshape(U, 3)[..., None] - k, K)  # (U, 3, o)

    def axis_factor(axis, n_m):
        m = torch.arange(n_m, device=x_u.device)
        ph = torch.remainder(m[None, None, :] * g[:, axis, :, None], K)
        ang = (-2.0 * np.pi / K) * ph.to(f)
        wa = w[:, axis, :, None]
        return ((wa * torch.cos(ang)).sum(1), (wa * torch.sin(ang)).sum(1))

    return axis_factor(0, K), axis_factor(1, K), axis_factor(2, K // 2 + 1)


def recip_delta_perstate(x_u, u_mask, dq, box, K, order, cbw, F0):
    """(S,) per-diabat reciprocal energies minus the base one, without
    per-diabat FFTs: for charge deltas dq (S, U) on the atoms x_u,

        E_s - E_0 = conv sum_m cbw Re(F0* G_s) + conv/2 sum_m cbw |G_s|^2,
        G_s = sum_u dq_su A_u B_u C_u

    (exact by linearity of the spreading).  F0 = rfftn of the base grid.
    Kernel C does the contraction on CUDA tensors."""
    (Ar, Ai), (Br, Bi), (Cr, Ci) = structure_axis_factors(x_u, box, K,
                                                           order)
    U = x_u.shape[0]
    Mh = K * (K // 2 + 1)
    dqm = (dq * u_mask.to(dq.dtype)[None, :]).to(Ar.dtype)
    BCr = (Br[:, :, None] * Cr[:, None, :]
           - Bi[:, :, None] * Ci[:, None, :]).reshape(U, Mh)
    BCi = (Br[:, :, None] * Ci[:, None, :]
           + Bi[:, :, None] * Cr[:, None, :]).reshape(U, Mh)
    e = recip_perstate.perstate_recip_energy(
        dqm, Ar.T, Ai.T, BCr, BCi, F0.real.reshape(K, Mh),
        F0.imag.reshape(K, Mh), cbw.to(dqm.dtype).reshape(K, Mh))
    return CONV_E2A_KJMOL * e
