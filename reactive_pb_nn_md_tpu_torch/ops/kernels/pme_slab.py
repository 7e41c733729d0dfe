"""Kernel D: the slab-binned PME charge spread (D1) and its interpolation
(D2).

Replaces reactive_pb_nn_md_tpu/ops/pallas/pme_slab.py:_fwd ->
_spread_slab_kernel and _bwd -> _interp_slab_kernel, source
``csrc/pme_slab.cu``.  The JAX package takes this path instead of the
per-atom spread when the system has a slab capacity (System.pme_scap,
10,000 atoms at K = 64); so does the port.

Atoms are binned in torch by their x-corner c1 = (floor(u_x) - (order-1))
mod K into K slabs of static capacity scap (one stable sort, the same
binning as kernel A's cells).  The overflow flag comes from that binning:
an atom past its slab's capacity is in no slab row, so the grid lacks it
and the flag makes the simulation loop regrow scap and redo the step --
an energy from such a grid is never reported.  D1 builds the K^3 grid
from the slab rows; D2 gives every slab row [dE/dq, dE/du1..3] from the
grid cotangent, and the backward gathers those back to atoms and applies
the charge and box factors.  ``spread_slab`` / ``interp_slab`` run the kernels
for CUDA tensors and the plain versions below (kernel B's index_add
spread and contraction over the slab rows) for CPU tensors.
"""

import math

import numpy as np
import torch

from ...utils import pbc
from ..binning import bin_slots, slot_atoms
from . import _build
from .pme_spread import contract_plain, spline_setup, spread_plain


def suggest_slab_cap(n_atoms, K, safety=1.25):
    """Static per-slab atom capacity, a multiple of 8: the mean N/K times
    a safety factor plus a 6-sigma Poisson tail (the JAX package's rule)."""
    mean = n_atoms / K
    cap = mean * safety + 6.0 * math.sqrt(max(mean, 1.0)) + 8.0
    cap = int(-(-int(math.ceil(cap)) // 8) * 8)
    return max(8, min(cap, n_atoms))


def suggest_pme_scap(n_atoms, K, box=None, order=6):
    """System.pme_scap: the slab capacity, or 0 for the per-atom spread.
    The JAX package's selection rule (topology.py:672-690): orthorhombic
    boxes, K + order - 1 <= 128, and at least 48 atoms per slab."""
    if box is not None:
        b = np.asarray(box, dtype=np.float64)
        if np.abs(b - np.diag(np.diag(b))).max() > 1e-9:
            return 0
    if K + order - 1 > 128 or n_atoms < 48 * K:
        return 0
    return suggest_slab_cap(n_atoms, K)


def slab_bins(nearpt, K, order, scap):
    """(slot (N,), rows (K*scap,), overflow ()): each atom's slab row, the
    atom of every slab row (-1 empty), and whether a slab overflowed."""
    c1 = torch.remainder(nearpt[:, 0] - (order - 1), K)
    slot, over = bin_slots(c1, K, scap)
    return slot, slot_atoms(slot, K * scap), over


def spread_slab_plain(w, nearpt, q, rows, K):
    """(K^3,) grid of the atoms in the slab rows: kernel B's plain
    spread over the rows."""
    a = rows.clamp(min=0)
    qa = torch.where(rows >= 0, q[a], torch.zeros_like(q[a]))
    return spread_plain(w[a], nearpt[a], qa, K)


def interp_slab_plain(gQ, w, dw, nearpt, rows, K):
    """(K*scap, 4) [dE/dq, dE/du1..3] of every slab row (zero if empty)."""
    a = rows.clamp(min=0)
    gq, s = contract_plain(gQ, w[a], dw[a], nearpt[a], K)
    out = torch.cat([gq[:, None], s], dim=1)
    return torch.where((rows >= 0)[:, None], out, torch.zeros_like(out))


def _check(w, nearpt, rows, K, scap):
    n, _, order = w.shape
    f = w.dtype
    _build.require(w, f, (n, 3, order), "w")
    _build.require(nearpt, torch.int64, (n, 3), "nearpt")
    _build.require(rows, torch.int64, (K * scap,), "rows")
    if order > K:
        raise ValueError("spline order exceeds the PME grid")
    # D1 holds a K x K plane and the slab's staged atoms
    smem = K * K * w.element_size() + scap * (2 * order * w.element_size()
                                              + 8)
    if smem > 227 * 1024:
        raise ValueError(f"kernel D needs {smem} B of shared memory at "
                         f"K = {K}, scap = {scap}: over the 227 KB of an SM")
    return order


def spread_slab_cuda(w, nearpt, q, rows, K, scap):
    """Kernel D1: (K^3,) grid; one plane-spread and one fold launch."""
    order = _check(w, nearpt, rows, K, scap)
    f = w.dtype
    _build.require(q, f, (w.shape[0],), "q")
    planes = torch.empty((K, order, K, K), dtype=f, device=w.device)
    grid = torch.empty(K ** 3, dtype=f, device=w.device)
    fn = _build.function("pme_slab_spread_" + _build.suffix(f), 7, 3)
    _build.check(fn(w.data_ptr(), nearpt.data_ptr(), q.data_ptr(),
                    rows.data_ptr(), planes.data_ptr(), grid.data_ptr(),
                    _build.stream_ptr(w), K, order, scap), "D1")
    _build.launches["D1"] += 1
    return grid


def interp_slab_cuda(gQ, w, dw, nearpt, rows, K, scap):
    """Kernel D2: (K*scap, 4) per slab row [dE/dq, dE/du1..3]; one
    per-offset contraction and one fold launch."""
    order = _check(w, nearpt, rows, K, scap)
    f = w.dtype
    _build.require(dw, f, w.shape, "dw")
    _build.require(gQ, f, (K ** 3,), "gQ")
    part = torch.empty((K * scap, order, 4), dtype=f, device=w.device)
    out = torch.empty((K * scap, 4), dtype=f, device=w.device)
    fn = _build.function("pme_slab_interp_" + _build.suffix(f), 8, 3)
    _build.check(fn(gQ.data_ptr(), w.data_ptr(), dw.data_ptr(),
                    nearpt.data_ptr(), rows.data_ptr(), part.data_ptr(),
                    out.data_ptr(), _build.stream_ptr(w), K, order, scap),
                 "D2")
    _build.launches["D2"] += 1
    return out


def spread_slab(w, nearpt, q, rows, K, scap):
    return spread_slab_cuda(w, nearpt, q, rows, K, scap) if w.is_cuda \
        else spread_slab_plain(w, nearpt, q, rows, K)


def interp_slab(gQ, w, dw, nearpt, rows, K, scap):
    return interp_slab_cuda(gQ, w, dw, nearpt, rows, K, scap) if w.is_cuda \
        else interp_slab_plain(gQ, w, dw, nearpt, rows, K)


class ChargeGridSlab(torch.autograd.Function):
    """(Q (K, K, K), overflow ()) from the slab-binned atoms;
    differentiable in x and q (the box gets no cotangent, as in the
    reference kernel)."""

    @staticmethod
    def forward(ctx, x, q, box, K, order, scap):
        w, dw, nearpt = spline_setup(x, box, K, order)
        slot, rows, over = slab_bins(nearpt, K, order, scap)
        q = q.contiguous()
        ctx.save_for_backward(w, dw, nearpt, q, pbc.recip_vectors(box),
                              slot, rows)
        ctx.K, ctx.scap = K, scap
        ctx.mark_non_differentiable(over)
        return spread_slab(w, nearpt, q, rows, K, scap).reshape(K, K, K), over

    @staticmethod
    def backward(ctx, gQ, _):
        w, dw, nearpt, q, recip, slot, rows = ctx.saved_tensors
        K = ctx.K
        out = interp_slab(gQ.reshape(-1).contiguous(), w, dw, nearpt, rows,
                          K, ctx.scap)
        g = torch.cat([out, torch.zeros_like(out[:1])])[slot]   # row gather
        gx = K * ((q[:, None] * g[:, 1:4]) @ recip)
        return gx, g[:, 0], None, None, None, None


def charge_grid_slab(x, q, box, K, order, scap):
    return ChargeGridSlab.apply(x, q, box, K, order, int(scap))
