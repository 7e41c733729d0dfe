"""Kernel B: PME charge spreading (B1) and its backward gather (B2).

Replaces reactive_pb_nn_md_tpu/ops/pallas/pme_spread.py:_spread ->
_spread_kernel and _gather -> _gather_kernel (with the contraction of
_charge_grid_bwd fused in), source ``csrc/pme_spread.cu``.

The B-spline weights and derivatives come from ops/bspline.py in torch;
the kernels scatter and gather.  B1 writes each element of the K^3 grid
once, from one lane that sums the atoms whose spline windows hold it in
ascending atom order (modular wrap, no halo; the order compiled in for
4 and 6 and a generic path, ``spread_smem``, for any other); B2 gives
dE/dq (N,) and dE/dx (N, 3) from the grid cotangent in one pass, one
warp an atom, with the order compiled in for 4 and 6 and a generic path
(per-atom tables in shared memory, ``gather_smem``) for any other.  What
bounds each on the H100 is in the source.  ``spread`` / ``gather`` run the
kernels for CUDA tensors and the plain versions below for CPU tensors.
"""

import torch

from ...utils import pbc
from ..bspline import bspline_weights_and_derivs
from . import _build

SMEM_LIMIT = 227 * 1024                 # shared memory a block can use
_GATHER_WARPS = 4                       # atoms a block of B2
_SPREAD_COUNTS = 64                     # B1's scan counts


def spread_plain(w, nearpt, q, K):
    """(K^3,) grid: sum_a q_a w_a0[i] w_a1[j] w_a2[k] at (nearpt - (i,j,k)) mod K."""
    order = w.shape[-1]
    k = torch.arange(order, device=w.device)
    idx = torch.remainder(nearpt[:, :, None] - k, K)            # (n, 3, o)
    flat = ((idx[:, 0, :, None, None] * K + idx[:, 1, None, :, None]) * K
            + idx[:, 2, None, None, :]).reshape(-1)
    vals = (q[:, None, None, None] * w[:, 0, :, None, None]
            * w[:, 1, None, :, None] * w[:, 2, None, None, :]).reshape(-1)
    return torch.zeros(K ** 3, dtype=w.dtype, device=w.device).index_add_(
        0, flat, vals)


def contract_plain(gQ, w, dw, nearpt, K):
    """(dE/dq (n,), dE/du (n, 3)) from the grid cotangent gQ (K^3,): the
    brick of every atom against its spline values and derivatives, before
    the charge and box factors of dE/dx."""
    order = w.shape[-1]
    k = torch.arange(order, device=w.device)
    idx = torch.remainder(nearpt[:, :, None] - k, K)
    flat = ((idx[:, 0, :, None, None] * K + idx[:, 1, None, :, None]) * K
            + idx[:, 2, None, None, :])
    c = gQ[flat]                                                 # (n, o, o, o)
    w0, w1, w2 = w[:, 0], w[:, 1], w[:, 2]
    d0, d1, d2 = dw[:, 0], dw[:, 1], dw[:, 2]
    gq = torch.einsum("aijl,ai,aj,al->a", c, w0, w1, w2)
    s = torch.stack([torch.einsum("aijl,ai,aj,al->a", c, d0, w1, w2),
                     torch.einsum("aijl,ai,aj,al->a", c, w0, d1, w2),
                     torch.einsum("aijl,ai,aj,al->a", c, w0, w1, d2)], -1)
    return gq, s


def gather_plain(gQ, w, dw, nearpt, q, recip, K):
    """(dE/dq (n,), dE/dx (n, 3)) from the grid cotangent gQ (K^3,)."""
    gq, s = contract_plain(gQ, w, dw, nearpt, K)
    return gq, K * ((q[:, None] * s) @ recip)


def spread_smem(order, K, itemsize):
    """Bytes of dynamic shared memory kernel B1 takes: none where the
    order is compiled in (4 and 6, at most K), else csrc/pme_spread.cu's
    spread_smem_t for the tile K picks: 256 staged rows of 2 order + 1
    values for K <= 32 (one plane), 128 rows of 3 order + 1 above (four
    planes), each row with three base points; the scan counts; 32 hits a
    warp for 16 warps.  It does not depend on n.  ValueError with the
    numbers when it does not fit one block."""
    if order in (4, 6) and order <= K:
        return 0
    planes, stage, width = ((1, 256, 2 * order + 1) if K <= 32
                            else (4, 128, 3 * order + 1))
    hit = -(-(planes * itemsize + 8) // itemsize) * itemsize
    smem = (stage * (width * itemsize + 3 * 4) + _SPREAD_COUNTS * 4
            + 16 * 32 * hit)
    if smem > SMEM_LIMIT:
        raise ValueError(f"kernel B1 needs {smem} B of shared memory at "
                         f"spline order {order} ({itemsize}-byte values), "
                         f"over the {SMEM_LIMIT} B a block can use")
    return smem


def spread_cuda(w, nearpt, q, K):
    n, _, order = w.shape
    f = w.dtype
    _build.require(w, f, (n, 3, order), "w")
    _build.require(nearpt, torch.int64, (n, 3), "nearpt")
    _build.require(q, f, (n,), "q")
    if order > K:
        raise ValueError("spline order exceeds the PME grid")
    spread_smem(order, K, w.element_size())
    # the kernel writes every element (zeros for n = 0): no fill
    grid = torch.empty(K ** 3, dtype=f, device=w.device)
    fn = _build.function("pme_spread_" + _build.suffix(f), 5, 3)
    _build.check(fn(w.data_ptr(), nearpt.data_ptr(), q.data_ptr(),
                    grid.data_ptr(), _build.stream_ptr(w), n, K, order),
                 "B1")
    _build.launches["B1"] += 1
    return grid


def gather_smem(order, K, itemsize):
    """Bytes of shared memory kernel B2 takes: none where the order is
    compiled in (4 and 6, at most K), else csrc/pme_spread.cu's
    gather_smem_t (per warp the atom's weights, derivatives and wrapped
    indices, 3 order each).  ValueError with the numbers when it does not
    fit one block."""
    if order in (4, 6) and order <= K:
        return 0
    smem = _GATHER_WARPS * 3 * order * (2 * itemsize + 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"kernel B2 needs {smem} B of shared memory at "
                         f"spline order {order} ({itemsize}-byte values), "
                         f"over the {SMEM_LIMIT} B a block can use")
    return smem


def gather_cuda(gQ, w, dw, nearpt, q, recip, K):
    n, _, order = w.shape
    f = w.dtype
    _build.require(gQ, f, (K ** 3,), "gQ")
    _build.require(w, f, (n, 3, order), "w")
    _build.require(dw, f, (n, 3, order), "dw")
    _build.require(nearpt, torch.int64, (n, 3), "nearpt")
    _build.require(q, f, (n,), "q")
    _build.require(recip, f, (3, 3), "recip")
    gather_smem(order, K, w.element_size())
    gq = torch.empty(n, dtype=f, device=w.device)
    gx = torch.empty((n, 3), dtype=f, device=w.device)
    fn = _build.function("pme_gather_" + _build.suffix(f), 9, 3)
    _build.check(fn(gQ.data_ptr(), w.data_ptr(), dw.data_ptr(),
                    nearpt.data_ptr(), q.data_ptr(), recip.data_ptr(),
                    gq.data_ptr(), gx.data_ptr(), _build.stream_ptr(w), n,
                    K, order), "B2")
    _build.launches["B2"] += 1
    return gq, gx


def spread(w, nearpt, q, K):
    return spread_cuda(w, nearpt, q, K) if w.is_cuda \
        else spread_plain(w, nearpt, q, K)


def gather(gQ, w, dw, nearpt, q, recip, K):
    return gather_cuda(gQ, w, dw, nearpt, q, recip, K) if w.is_cuda \
        else gather_plain(gQ, w, dw, nearpt, q, recip, K)


def spline_setup(x, box, K, order):
    """(w, dw, nearpt) of every atom, (n, 3, order) / (n, 3)."""
    u = pbc.scaled_grid_coords(x, box, K)
    w, dw, nearpt = bspline_weights_and_derivs(u.reshape(-1), order)
    n = x.shape[0]
    return (w.reshape(n, 3, order).contiguous(),
            dw.reshape(n, 3, order).contiguous(),
            nearpt.reshape(n, 3).contiguous())


class ChargeGrid(torch.autograd.Function):
    """Q grid (K, K, K) from all atoms (grid_Q); differentiable in x and q
    (the box gets no cotangent, as in the reference kernel)."""

    @staticmethod
    def forward(ctx, x, q, box, K, order):
        w, dw, nearpt = spline_setup(x, box, K, order)
        q = q.contiguous()
        recip = pbc.recip_vectors(box).contiguous()
        ctx.save_for_backward(w, dw, nearpt, q, recip)
        ctx.K = K
        return spread(w, nearpt, q, K).reshape(K, K, K)

    @staticmethod
    def backward(ctx, gQ):
        w, dw, nearpt, q, recip = ctx.saved_tensors
        gq, gx = gather(gQ.reshape(-1).contiguous(), w, dw, nearpt, q,
                        recip, ctx.K)
        return gx, gq, None, None, None


def charge_grid(x, q, box, K, order):
    return ChargeGrid.apply(x, q, box, K, order)
