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
kernels for CUDA tensors and the plain versions below for CPU tensors;
they are torch.library ops whose batching rules launch B1 / B2 once for
a whole replica batch (torch.func.vmap over the MD step), a replica
grid axis in the kernels.
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
    return torch.zeros(K ** 3, dtype=w.dtype, device=w.device).index_add(
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


def spread_vjp_plain(gQ, w, nearpt, q, K):
    """(cotangent of w (n, 3, order), of q (n,)) of spread_plain's grid for
    the grid cotangent gQ (K^3,): its gradient in the spline weights and
    the charges (the plain path's delta grids, pme.delta_charge_grid,
    differentiate through it)."""
    order = w.shape[-1]
    k = torch.arange(order, device=w.device)
    idx = torch.remainder(nearpt[:, :, None] - k, K)
    c = gQ[((idx[:, 0, :, None, None] * K + idx[:, 1, None, :, None]) * K
            + idx[:, 2, None, None, :])]                         # (n, o, o, o)
    w0, w1, w2 = w[:, 0], w[:, 1], w[:, 2]
    qc = q[:, None]
    gw = torch.stack([qc * torch.einsum("aijl,aj,al->ai", c, w1, w2),
                      qc * torch.einsum("aijl,ai,al->aj", c, w0, w2),
                      qc * torch.einsum("aijl,ai,aj->al", c, w0, w1)], 1)
    return gw, torch.einsum("aijl,ai,aj,al->a", c, w0, w1, w2)


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


def spread_cuda(w, nearpt, q, K, nb=None):
    """Launch kernel B1: the (K^3,) grid; with nb, a batched launch of nb
    replicas, each argument stacked on a leading axis of nb or shared by
    the batch, giving (nb, K^3) grids."""
    n, _, order = _build.unbatched(w, 3)
    f = w.dtype
    strides = _build.batch_strides((w, nearpt, q), (
        ((n, 3, order), f, "w"), ((n, 3), torch.int64, "nearpt"),
        ((n,), f, "q")), nb)
    if order > K:
        raise ValueError("spline order exceeds the PME grid")
    spread_smem(order, K, w.element_size())
    # the kernel writes every element (zeros for n = 0): no fill
    grid = torch.empty((nb or 1, K ** 3), dtype=f, device=w.device)
    fn = _build.function("pme_spread_" + _build.suffix(f), 5, 7)
    _build.check(fn(w.data_ptr(), nearpt.data_ptr(), q.data_ptr(),
                    grid.data_ptr(), _build.stream_ptr(w), n, K, order,
                    nb or 1, *strides), "B1")
    _build.launches["B1"] += 1
    return grid if nb else grid[0]


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


def gather_cuda(gQ, w, dw, nearpt, q, recip, K, nb=None):
    """Launch kernel B2: (dE/dq (n,), dE/dx (n, 3)); with nb, a batched
    launch of nb replicas (see spread_cuda), giving (nb, n) and (nb, n,
    3)."""
    n, _, order = _build.unbatched(w, 3)
    f = w.dtype
    strides = _build.batch_strides((gQ, w, dw, nearpt, q, recip), (
        ((K ** 3,), f, "gQ"), ((n, 3, order), f, "w"),
        ((n, 3, order), f, "dw"), ((n, 3), torch.int64, "nearpt"),
        ((n,), f, "q"), ((3, 3), f, "recip")), nb)
    if strides[1] != strides[2]:
        raise ValueError("w and dw must be batched alike")
    gather_smem(order, K, w.element_size())
    gq = torch.empty((nb or 1, n), dtype=f, device=w.device)
    gx = torch.empty((nb or 1, n, 3), dtype=f, device=w.device)
    fn = _build.function("pme_gather_" + _build.suffix(f), 9, 9)
    _build.check(fn(gQ.data_ptr(), w.data_ptr(), dw.data_ptr(),
                    nearpt.data_ptr(), q.data_ptr(), recip.data_ptr(),
                    gq.data_ptr(), gx.data_ptr(), _build.stream_ptr(w), n,
                    K, order, nb or 1, strides[0], strides[1], strides[3],
                    strides[4], strides[5]), "B2")
    _build.launches["B2"] += 1
    return (gq, gx) if nb else (gq[0], gx[0])


@torch.library.custom_op(_build.OPS + "::pme_spread", mutates_args=())
def spread(w: torch.Tensor, nearpt: torch.Tensor, q: torch.Tensor,
           K: int) -> torch.Tensor:
    """(K^3,) grid: kernel B1 for CUDA tensors, spread_plain for CPU ones;
    a replica batch (vmap) launches B1 once for all replicas."""
    return spread_cuda(w, nearpt, q, K) if w.is_cuda \
        else spread_plain(w, nearpt, q, K)


@spread.register_fake
def _(w, nearpt, q, K):
    return w.new_empty(K ** 3)


def _spread_setup(ctx, inputs, output):
    w, nearpt, q, K = inputs
    ctx.save_for_backward(w, nearpt, q)
    ctx.K = K


def _spread_backward(ctx, gQ):
    """The plain spread's gradient in w and q, for CPU tensors; kernel B1
    gives none (ChargeGrid differentiates the spread in x through B2)."""
    w, nearpt, q = ctx.saved_tensors
    if gQ.is_cuda:
        raise NotImplementedError(
            "kernel B1 gives no gradient in the spline weights: "
            "differentiate the spread in x through pme_spread.charge_grid")
    gw, gq = spread_vjp_plain(gQ, w, nearpt, q, ctx.K)
    return gw, None, gq, None


spread.register_autograd(_spread_backward, setup_context=_spread_setup)


@spread.register_vmap
def _(info, in_dims, w, nearpt, q, K):
    args = _build.front((w, nearpt, q), in_dims[:3])
    if w.is_cuda:
        return spread_cuda(*args, K, nb=info.batch_size), 0
    return torch.stack([spread(*_build.replica(args, in_dims, i), K)
                        for i in range(info.batch_size)]), 0


@torch.library.custom_op(_build.OPS + "::pme_gather", mutates_args=())
def gather(gQ: torch.Tensor, w: torch.Tensor, dw: torch.Tensor,
           nearpt: torch.Tensor, q: torch.Tensor, recip: torch.Tensor,
           K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dE/dq (n,), dE/dx (n, 3)) from the grid cotangent: kernel B2 for
    CUDA tensors, gather_plain for CPU ones; a replica batch (vmap)
    launches B2 once for all replicas."""
    return gather_cuda(gQ, w, dw, nearpt, q, recip, K) if w.is_cuda \
        else gather_plain(gQ, w, dw, nearpt, q, recip, K)


@gather.register_fake
def _(gQ, w, dw, nearpt, q, recip, K):
    n = w.shape[0]
    return w.new_empty(n), w.new_empty((n, 3))


@gather.register_vmap
def _(info, in_dims, gQ, w, dw, nearpt, q, recip, K):
    args = _build.front((gQ, w, dw, nearpt, q, recip), in_dims[:6])
    if w.is_cuda:
        nb = info.batch_size
        return gather_cuda(*_build.alike(args, in_dims, ((1, 2),), nb), K,
                           nb=nb), (0, 0)
    out = [gather(*_build.replica(args, in_dims, i), K)
           for i in range(info.batch_size)]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out])), (0, 0)


def spline_setup(x, box, K, order):
    """(w, dw, nearpt) of every atom, (n, 3, order) / (n, 3)."""
    u = pbc.scaled_grid_coords(x, box, K)
    w, dw, nearpt = bspline_weights_and_derivs(u.reshape(-1), order)
    n = x.shape[0]
    return (w.reshape(n, 3, order).contiguous(),
            dw.reshape(n, 3, order).contiguous(),
            nearpt.reshape(n, 3).contiguous())


class ChargeGrid(torch.autograd.Function):
    """(Q grid (K, K, K) from all atoms (grid_Q), the spline tables);
    differentiable in x and q (the box gets no cotangent, as in the
    reference kernel).  Its forward and backward are the ops B1 and B2, so
    under a replica batch (vmap) each launches once for all replicas.
    B2's cotangent is detached: under create_graph its result is a
    constant, the kernel's gradient."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, q, box, K, order):
        w, dw, nearpt = spline_setup(x, box, K, order)
        grid = spread(w, nearpt, q.contiguous(), K).reshape(K, K, K)
        return grid, w, dw, nearpt, pbc.recip_vectors(box).contiguous()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1], *output[1:])
        ctx.mark_non_differentiable(*output[1:])
        ctx.K = inputs[3]

    @staticmethod
    def backward(ctx, gQ, *_):
        q, w, dw, nearpt, recip = ctx.saved_tensors
        gq, gx = gather(gQ.detach().reshape(-1).contiguous(), w, dw, nearpt,
                        q.detach().contiguous(), recip, ctx.K)
        return gx, gq, None, None, None


def charge_grid(x, q, box, K, order):
    return ChargeGrid.apply(x, q, box, K, order)[0]
