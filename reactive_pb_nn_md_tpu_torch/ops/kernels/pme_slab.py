"""Kernel D: the slab-binned PME charge spread (D1) and its interpolation
(D2).

Replaces reactive_pb_nn_md_tpu/ops/pallas/pme_slab.py:_fwd ->
_spread_slab_kernel and _bwd -> _interp_slab_kernel, source
``csrc/pme_slab.cu``.  The JAX package takes this path instead of the
per-atom spread when the system has a slab capacity (System.pme_scap,
10,000 atoms at K = 64); so does the port.

Atoms are binned in torch by their x corner c1 = (floor(u_x) - (order-1))
mod K into K slabs of static capacity scap, and within a slab in ascending
y corner c2 (``slab_bins``: one sort by c2, then kernel A's stable
binning by c1).  The overflow flag comes from that binning: an atom past
its slab's capacity is in no slab row, so the grid lacks it and the flag
makes the simulation loop regrow scap and redo the step -- an energy from
such a grid is never reported.  D1 builds the K^3 grid from the slab rows
in one launch, each block owning a band of grid rows and finding the atoms
that reach it by their y corner; D2 gives every slab row [dE/dq,
dE/du1..3] from the grid cotangent in one launch, each block taking the
rows of one slab whose y corner lies in a band.  Both need the rows in
slab_bins' order; neither has a scratch array or atomics, and their shared
memory depends on K, the order and the dtype, not on scap.  Their bound
is bytes, but they run bounded by latency (the source has the design).
The backward gathers D2's rows back to atoms and applies the charge and
box factors.
``spread_slab`` / ``interp_slab`` run the kernels for CUDA tensors and the
plain versions below (kernel B's index_add spread and contraction over the
slab rows, in any row order) for CPU tensors; they are torch.library ops
whose batching rules launch D1 / D2 once for a whole replica batch
(torch.func.vmap over the MD step), a replica grid axis in the kernels.
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
    atom of every slab row (-1 empty), and whether a slab overflowed.  The
    rows of a slab hold its atoms in ascending y corner (ties in atom
    order), then -1: kernel D finds a band's atoms by that order."""
    c = torch.remainder(nearpt[:, :2] - (order - 1), K)
    by_y = torch.argsort(c[:, 1], stable=True)
    slot_y, over = bin_slots(c[by_y, 0], K, scap)
    # out of place: a replica batch vmaps this function
    slot = torch.empty_like(slot_y).index_put((by_y,), slot_y)
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


# csrc/pme_slab.cu: y rows of a D1 tile, warps of a D1 block, atoms a D1
# block stages at a time, a D1 tile row's padding; y corners of a D2
# block, slab rows a D2 block stages at a time
SLAB_BAND, SLAB_WARPS, SLAB_STAGE, TILE_PAD = 8, 8, 128, 6
INTERP_BAND, INTERP_STAGE = 8, 32
SMEM_LIMIT = 227 * 1024


def spread_smem(K, order, itemsize):
    """D1's shared memory: each warp's own tile of SLAB_BAND rows of K +
    TILE_PAD, and the staged atoms (the band-row weights, the z spline row
    and the z point of each)."""
    return (SLAB_WARPS * SLAB_BAND * (K + TILE_PAD) * itemsize
            + SLAB_STAGE * ((SLAB_BAND + order) * itemsize + 4))


def interp_smem(K, order, itemsize):
    """D2's shared memory: the cotangent window of a block (order x-planes
    by INTERP_BAND + order - 1 y rows by K + 1 padded z values) and the
    staged rows (spline and derivative rows, atom, z point, y corner)."""
    return (order * (INTERP_BAND + order - 1) * (K + 1) * itemsize
            + INTERP_STAGE * (6 * order * itemsize + 16))


def _check(order, K, itemsize):
    if order not in (4, 6):
        raise ValueError(f"kernel D takes spline order 4 or 6, not {order}")
    if order > K or K + order - 1 > 128:
        raise ValueError(f"kernel D takes order <= K and K + order - 1 <= "
                         f"128, not K = {K}, order = {order}")
    for name, smem in (("D1", spread_smem(K, order, itemsize)),
                       ("D2", interp_smem(K, order, itemsize))):
        if smem > SMEM_LIMIT:
            raise ValueError(f"kernel {name} needs {smem} B of shared memory "
                             f"at K = {K}: over the 227 KB of an SM")


def spread_slab_cuda(w, nearpt, q, rows, K, scap, nb=None):
    """Kernel D1: (K^3,) grid of the atoms in the slab rows (slab_bins'
    order); one launch.  With nb, a batched launch of nb replicas, each
    argument stacked on a leading axis of nb or shared by the batch,
    giving (nb, K^3) grids."""
    n, _, order = _build.unbatched(w, 3)
    f = w.dtype
    strides = _build.batch_strides((w, nearpt, q, rows), (
        ((n, 3, order), f, "w"), ((n, 3), torch.int64, "nearpt"),
        ((n,), f, "q"), ((K * scap,), torch.int64, "rows")), nb)
    _check(order, K, w.element_size())
    grid = torch.empty((nb, K ** 3) if nb else (K ** 3,), dtype=f,
                       device=w.device)
    fn = _build.function("pme_slab_spread_" + _build.suffix(f), 6, 8)
    _build.check(fn(w.data_ptr(), nearpt.data_ptr(), q.data_ptr(),
                    rows.data_ptr(), grid.data_ptr(), _build.stream_ptr(w),
                    K, order, scap, nb or 1, *strides), "D1")
    _build.launches["D1"] += 1
    return grid


def interp_slab_cuda(gQ, w, dw, nearpt, rows, K, scap, nb=None):
    """Kernel D2: (K*scap, 4) per slab row [dE/dq, dE/du1..3] (slab_bins'
    order), zero on empty rows; one launch.  With nb, a batched launch of
    nb replicas (see spread_slab_cuda; w and dw batched alike), giving
    (nb, K*scap, 4)."""
    n, _, order = _build.unbatched(w, 3)
    f = w.dtype
    strides = _build.batch_strides((gQ, w, dw, nearpt, rows), (
        ((K ** 3,), f, "gQ"), ((n, 3, order), f, "w"),
        ((n, 3, order), f, "dw"), ((n, 3), torch.int64, "nearpt"),
        ((K * scap,), torch.int64, "rows")), nb)
    if strides[1] != strides[2]:
        raise ValueError("w and dw must be batched alike")
    _check(order, K, w.element_size())
    out = torch.empty(((nb,) if nb else ()) + (K * scap, 4), dtype=f,
                      device=w.device)
    fn = _build.function("pme_slab_interp_" + _build.suffix(f), 7, 8)
    _build.check(fn(gQ.data_ptr(), w.data_ptr(), dw.data_ptr(),
                    nearpt.data_ptr(), rows.data_ptr(), out.data_ptr(),
                    _build.stream_ptr(w), K, order, scap, nb or 1,
                    strides[0], strides[1], strides[3], strides[4]), "D2")
    _build.launches["D2"] += 1
    return out


@torch.library.custom_op(_build.OPS + "::pme_slab_spread", mutates_args=())
def spread_slab(w: torch.Tensor, nearpt: torch.Tensor, q: torch.Tensor,
                rows: torch.Tensor, K: int, scap: int) -> torch.Tensor:
    """(K^3,) grid of the atoms in the slab rows: kernel D1 for CUDA
    tensors, spread_slab_plain for CPU ones; a replica batch (vmap)
    launches D1 once for all replicas."""
    return spread_slab_cuda(w, nearpt, q, rows, K, scap) if w.is_cuda \
        else spread_slab_plain(w, nearpt, q, rows, K)


@spread_slab.register_fake
def _(w, nearpt, q, rows, K, scap):
    return w.new_empty(K ** 3)


@spread_slab.register_vmap
def _(info, in_dims, w, nearpt, q, rows, K, scap):
    args = _build.front((w, nearpt, q, rows), in_dims[:4])
    if w.is_cuda:
        return spread_slab_cuda(*args, K, scap, nb=info.batch_size), 0
    return torch.stack([spread_slab(*_build.replica(args, in_dims, i), K,
                                    scap)
                        for i in range(info.batch_size)]), 0


@torch.library.custom_op(_build.OPS + "::pme_slab_interp", mutates_args=())
def interp_slab(gQ: torch.Tensor, w: torch.Tensor, dw: torch.Tensor,
                nearpt: torch.Tensor, rows: torch.Tensor, K: int,
                scap: int) -> torch.Tensor:
    """(K*scap, 4) [dE/dq, dE/du1..3] of every slab row: kernel D2 for
    CUDA tensors, interp_slab_plain for CPU ones; a replica batch (vmap)
    launches D2 once for all replicas."""
    return interp_slab_cuda(gQ, w, dw, nearpt, rows, K, scap) if w.is_cuda \
        else interp_slab_plain(gQ, w, dw, nearpt, rows, K)


@interp_slab.register_fake
def _(gQ, w, dw, nearpt, rows, K, scap):
    return w.new_empty((K * scap, 4))


@interp_slab.register_vmap
def _(info, in_dims, gQ, w, dw, nearpt, rows, K, scap):
    args = _build.front((gQ, w, dw, nearpt, rows), in_dims[:5])
    nb = info.batch_size
    if w.is_cuda:
        return interp_slab_cuda(*_build.alike(args, in_dims, ((1, 2),), nb),
                                K, scap, nb=nb), 0
    return torch.stack([interp_slab(*_build.replica(args, in_dims, i), K,
                                    scap) for i in range(nb)]), 0


class ChargeGridSlab(torch.autograd.Function):
    """(Q (K, K, K), overflow (), the spline tables and the slab binning)
    from the slab-binned atoms; differentiable in x and q (the box gets no
    cotangent, as in the reference kernel).  Its forward and backward are
    the ops D1 and D2, so under a replica batch (vmap) each launches once
    for all replicas.  D2's cotangent is detached: under create_graph its
    result is a constant, the kernel's gradient."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, q, box, K, order, scap):
        w, dw, nearpt = spline_setup(x, box, K, order)
        slot, rows, over = slab_bins(nearpt, K, order, scap)
        grid = spread_slab(w, nearpt, q.contiguous(), rows, K, scap)
        return (grid.reshape(K, K, K), over, w, dw, nearpt,
                pbc.recip_vectors(box).contiguous(), slot, rows)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1], *output[2:])
        ctx.mark_non_differentiable(*output[1:])
        ctx.K, ctx.scap = inputs[3], inputs[5]

    @staticmethod
    def backward(ctx, gQ, *_):
        q, w, dw, nearpt, recip, slot, rows = ctx.saved_tensors
        K = ctx.K
        out = interp_slab(gQ.detach().reshape(-1).contiguous(), w, dw,
                          nearpt, rows, K, ctx.scap)
        g = torch.cat([out, torch.zeros_like(out[:1])])[slot]   # row gather
        gx = K * ((q.detach()[:, None] * g[:, 1:4]) @ recip)
        return gx, g[:, 0], None, None, None, None


def charge_grid_slab(x, q, box, K, order, scap):
    return ChargeGridSlab.apply(x, q, box, K, order, int(scap))[:2]
