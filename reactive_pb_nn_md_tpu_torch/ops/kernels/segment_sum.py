"""Kernel F: the fixed-order segment sum, and the gather whose backward it
is.

Replaces no TPU kernel: on the TPU the JAX step's gradients of its
gathers are XLA scatter-adds that run in their compiled order, so one
input gives one result.  torch's counterparts on the card (the indexing
backward, scatter_add, index_add) add with atomics, and two runs of one
step from one state part after a few dozen steps.  Source
``csrc/segment_sum.cu``.

``segment_sum(src, idx, n)`` is ``out[t] = sum of src[m] over idx[m] = t``
taken in ascending m: on a CUDA tensor kernel F, on a CPU tensor the
plain version, ``index_add``, which adds in that order there.  The order
is found on the card from integers alone (``segment_order``: a sort of
the keys idx * M + m, unique, so any sort gives the one order, and a
search for each row's first entry); every index of the step is
recomputed each step (the pair rows, the states' atoms, the changed
molecules), so the order is made where the sum is, in the backward, and
needs no host read and no allocation that depends on the data: a CUDA
graph captures it.

``take_rows(x, idx)`` is ``x[idx]`` whose backward is segment_sum, and
``add_rows(out, idx, src)`` is ``out.index_add(0, idx, src)`` through
segment_sum.  An index entry < 0 is padding: take_rows reads row 0 for
it and the sums leave it out.  The launch is the torch.library op
``segment_sum_op``, whose batching rule launches F once for a replica
batch (torch.func.vmap over the MD step), the replica on a grid axis of
the kernel; ``segment_sum`` (differentiable: a force-matching loss
differentiates the forces) and ``take_rows`` are autograd Functions in
setup_context form with generated vmap rules, so autograd inside vmap
(the batched step's torch.func.grad) goes through them too.
"""

import torch

from . import _build


def segment_order(idx, n):
    """(perm (M,), offsets (n + 1,)) of the flat int64 index idx (M,) of
    values in [0, n), or < 0 for padding: perm lists the entries m row by
    row, each row's in ascending m, and row t's are perm[offsets[t]:
    offsets[t + 1]] (the padding sorts before row 0 and belongs to no
    row).  The keys idx M + m are unique, so any sort gives this one
    order; integer ops only (exact), no host read; the keys are int32
    where (n + 1) M fits (half the sort's passes)."""
    m = max(idx.numel(), 1)
    dt = torch.int32 if (n + 1) * m < 2 ** 31 else torch.int64
    pos = torch.arange(idx.numel(), device=idx.device, dtype=dt)
    key, perm = torch.sort(pos.add(idx.to(dt), alpha=m))
    offsets = torch.searchsorted(key, torch.arange(
        0, (n + 1) * m, m, device=idx.device, dtype=dt))
    return perm, offsets


def segment_sum_plain(src, idx, n):
    """(n, *rest) sums of src (M, *rest) by idx (M,), ascending m; an
    entry with idx < 0 is padding and adds to no row."""
    pad = torch.where(idx < 0, n, idx)
    return src.new_zeros((n + 1,) + tuple(src.shape[1:])).index_add(
        0, pad, src)[:n]


def segment_sum_cuda(src, idx, n, nb=None):
    """Launch kernel F: (n, *rest); with nb, a batched launch of nb
    replicas, src (nb, M, *rest) and idx (M,) shared or (nb, M), giving
    (nb, n, *rest)."""
    f = src.dtype
    fn = _build.function("segment_sum_" + _build.suffix(f), 5, 6)
    _build.require(src, f, None, "src")
    _build.require(idx, torch.int64, None, "idx")
    lead = 1 if nb else 0
    m = src.shape[lead] if src.ndim > lead else 0
    rest = tuple(src.shape[lead + 1:])
    d = 1
    for s in rest:
        d *= s
    R = nb or 1
    if idx.shape[-1] != m or (idx.ndim == 2 and (not nb or
                                                 idx.shape[0] != nb)):
        raise ValueError(f"idx of shape {tuple(idx.shape)} does not index "
                         f"src of shape {tuple(src.shape)}")
    out = torch.empty((R, n) + rest, dtype=f, device=src.device)
    if idx.ndim == 2:
        # each replica's rows offset by r n (padding kept below 0): one
        # order for the whole batch
        glob = torch.where(idx < 0, -1, idx + n * torch.arange(
            R, device=idx.device)[:, None])
        perm, off = segment_order(glob.reshape(-1), R * n)
        strides = (0, n, n * d)
    else:
        perm, off = segment_order(idx, n)
        strides = (m * d, 0, n * d)
    _build.check(fn(src.data_ptr(), perm.data_ptr(), off.data_ptr(),
                    out.data_ptr(), _build.stream_ptr(src), n, d, R,
                    *strides), "F")
    _build.launches["F"] += 1
    return out if nb else out[0]


@torch.library.custom_op(_build.OPS + "::segment_sum", mutates_args=())
def segment_sum_op(src: torch.Tensor, idx: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(n, *rest) sums of src (M, *rest) by idx (M,), each row's terms in
    ascending m: kernel F for CUDA tensors, segment_sum_plain for CPU
    ones; a replica batch (vmap) launches F once for all replicas."""
    if src.is_cuda:
        return segment_sum_cuda(src.contiguous(), idx.contiguous(), n)
    return segment_sum_plain(src, idx, n)


@segment_sum_op.register_fake
def _(src, idx, n):
    return src.new_empty((n,) + tuple(src.shape[1:]))


@segment_sum_op.register_vmap
def _(info, in_dims, src, idx, n):
    nb = info.batch_size
    src, idx = _build.front((src, idx), in_dims[:2])
    if in_dims[0] is None:
        src = src.expand(nb, *src.shape).contiguous()
    if src.is_cuda:
        return segment_sum_cuda(src, idx, n, nb=nb), 0
    return torch.stack([segment_sum_op(*_build.replica(
        (src, idx), (0, in_dims[1]), i), n) for i in range(nb)]), 0


class _SegmentSum(torch.autograd.Function):
    """segment_sum_op, differentiable in src: its backward is take_rows,
    zero on the padding entries (a force-matching loss differentiates
    the forces, which are segment sums)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(src, idx, n):
        return segment_sum_op(src, idx, n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        grad = take_rows(g, idx)
        pad = (idx < 0).reshape((-1,) + (1,) * (g.ndim - 1))
        return torch.where(pad, torch.zeros_like(grad), grad), None, None


def segment_sum(src, idx, n):
    """(n, *rest) sums of src (M, *rest) by the int64 idx (M,) of values
    in [0, n), each row's terms added in ascending m (segment_sum_op); an
    entry with idx < 0 adds to no row."""
    return _SegmentSum.apply(src, idx, n)


class _TakeRows(torch.autograd.Function):
    """x[idx] with segment_sum as its backward (padding, idx < 0, reads
    row 0 and takes no gradient)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, idx):
        return x[idx.clamp(min=0)]

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, idx = inputs
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        rest = tuple(g.shape[idx.ndim:])
        flat = g.reshape((idx.numel(),) + rest)
        return segment_sum(flat, idx.reshape(-1), ctx.n), None


def take_rows(x, idx):
    """x[idx] for an int64 idx of any shape (rows of x's first axis), its
    gradient summed in a fixed order (segment_sum) on the card too.  An
    entry idx < 0 is padding: it reads row 0, and its gradient, which
    the caller masks to zero, is left out of the sums (a zero added
    changes no sum; left out, the entries of a padded row do not all
    fall on row 0, one thread's loop)."""
    return _TakeRows.apply(x, idx)


def add_rows(out, idx, src):
    """out.index_add(0, idx, src) with src's rows summed by segment_sum
    first, in ascending order, then added once to out."""
    return out + segment_sum(src, idx, out.shape[0])
