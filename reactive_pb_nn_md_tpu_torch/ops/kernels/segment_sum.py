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
plain version, ``index_add``, which adds in that order there.  Kernel F
is at most three launches and nothing else: every index of the step is
recomputed each step (the pair rows, the states' atoms, the changed
molecules), so the order is made where the sum is, in the backward, by
F's own kernels, from the int64 index as it comes:

  1. a block sorts a tile of TILE entries by bucket (a run of
     2 ** bucket_shift(n, M) rows; padding first, rows past n last),
     stably, in shared memory, and counts each bucket's entries in it;
  2. a block a bucket gathers its entries from the tiles in tile order
     (ascending m), sorts them by row CHUNK at a time, and writes the
     rows' offsets and their entries: (perm, offsets), equal to
     ``segment_order``'s on every row;
  3. a thread an element of out adds its row's entries in ascending m.

An index of one tile (M <= TILE) into at most DIRECT_ROWS rows skips the
second launch: the first sorts it by row, which is the order itself.

No host read, no allocation whose size depends on the data (the scratch
is sized by M, n and the batch), no atomic operation: a CUDA graph
captures the call.  ``segment_order`` (a torch sort of the unique keys
idx M + m and a search of the row starts) is the plain version of the
order, and ``segment_sum_plain`` of the sum; on the card nothing on the
main path calls them.

``take_rows(x, idx)`` is ``x[idx]`` whose backward is segment_sum, and
``add_rows(out, idx, src)`` is ``out.index_add(0, idx, src)`` through
segment_sum.  An index entry < 0 is padding: take_rows reads row 0 for
it and the sums leave it out.  The launch is the torch.library op
``segment_sum_op``, whose batching rule launches F once for a replica
batch (torch.func.vmap over the MD step), the replica on a grid axis of
the kernels (an index shared by the batch is ordered once);
``segment_sum`` (differentiable: a force-matching loss differentiates
the forces) and ``take_rows`` are autograd Functions in setup_context
form with generated vmap rules, so autograd inside vmap (the batched
step's torch.func.grad) goes through them too.
"""

import torch

from . import _build

# entries a tile of the first kernel, and a bucket's entries the second
# sorts at once (csrc/segment_sum.cu kTile, kChunk)
TILE = 2048
CHUNK = 4096
# the most rows an index of one tile is ordered for by the first kernel
# alone (kDirectRows)
DIRECT_ROWS = 16384
# the most shared memory a block takes (H100): the second kernel's holds
# two CHUNK arrays, four a bucket's rows and two a tile
_SMEM = 227 * 1024


def bucket_shift(n, m):
    """log2 of the rows a bucket of kernel F's order takes for an index
    of m entries into n rows: the most (at most 256) with about 512
    entries a bucket on average, at least 1."""
    s = 0
    while s < 8 and m * (2 << s) <= 512 * n:
        s += 1
    return s


def segment_order(idx, n):
    """(perm (M,), offsets (n + 1,)) of the flat int64 index idx (M,) of
    values in [0, n), or < 0 for padding: perm lists the entries m row by
    row, each row's in ascending m, and row t's are perm[offsets[t]:
    offsets[t + 1]] (the padding sorts before row 0 and belongs to no
    row).  The keys idx M + m are unique, so any sort gives this one
    order; integer ops only (exact), no host read; the keys are int32
    where (n + 1) M fits (half the sort's passes).  The plain version of
    kernel F's order (segment_order_kernels)."""
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


def _order_buffers(idx, n):
    """(scratch, perm, off, sizes) of kernel F's order for idx (M,) or
    (nbi, M): int32 perm (nbi, M) and off (nbi, n + 1), the tiles'
    entries (int64) and their bucket counts (int32) as scratch, all
    sized by M, n and nbi; sizes (m, nbi, shift) are the launch's."""
    m = idx.shape[-1]
    nbi = idx.shape[0] if idx.ndim == 2 else 1
    shift = bucket_shift(n, m)
    nt = -(-m // TILE)
    nbk = -(-n // (1 << shift))
    tiles = ((_SMEM - 1024) // 4 - 2 * CHUNK - 4 * (1 << shift)) // 2
    if n >= 2 ** 31 or (nbk + 2) * TILE >= 2 ** 32 or nt > tiles:
        raise ValueError(f"kernel F's order takes at most {tiles * TILE} "
                         f"entries and 2**31 rows a replica: M = {m}, n = "
                         f"{n}")
    dev = idx.device
    ent = torch.empty(nbi * nt * TILE, dtype=torch.int64, device=dev)
    ints = torch.empty(nbi * ((nbk + 1) * nt + m + n + 1),
                       dtype=torch.int32, device=dev)
    start = ints[:nbi * (nbk + 1) * nt]
    perm = ints[start.numel():start.numel() + nbi * m].view(nbi, m)
    off = ints[start.numel() + perm.numel():].view(nbi, n + 1)
    return (ent, start), perm, off, (m, nbi, shift)


def segment_order_kernels(idx, n):
    """Kernel F's order of idx (M,) or (nbi, M) (each replica's rows its
    own) on the card: int32 (perm, off) of shapes (M,), (n + 1,) (or
    (nbi, M), (nbi, n + 1)), equal to segment_order's on every row,
    perm[off[0]:off[n]], and in off; the padding's places perm[:off[0]]
    are not written.  On a CPU tensor, segment_order."""
    if not idx.is_cuda:
        if idx.ndim == 2:
            pairs = [segment_order(i, n) for i in idx]
            return (torch.stack([p for p, _ in pairs]),
                    torch.stack([o for _, o in pairs]))
        return segment_order(idx, n)
    _build.require(idx, torch.int64, None, "idx")
    if n < 1:
        raise ValueError("kernel F's order takes n >= 1 rows")
    fn = _build.function("segment_order", 6, 4)
    (ent, start), perm, off, (m, nbi, shift) = _order_buffers(idx, n)
    _build.check(fn(idx.data_ptr(), ent.data_ptr(), start.data_ptr(),
                    perm.data_ptr(), off.data_ptr(), _build.stream_ptr(idx),
                    m, n, nbi, shift), "F order")
    _build.launches["F order"] += 1
    return (perm, off) if idx.ndim == 2 else (perm[0], off[0])


def segment_sum_cuda(src, idx, n, nb=None):
    """Launch kernel F (its order, then its sum): (n, *rest); with nb, a
    batched launch of nb replicas, src (nb, M, *rest) and idx (M,)
    shared (ordered once) or (nb, M), giving (nb, n, *rest)."""
    f = src.dtype
    fn = _build.function("segment_sum_" + _build.suffix(f), 8, 6)
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
    (ent, start), perm, off, (_, nbi, shift) = _order_buffers(idx, n)
    _build.check(fn(src.data_ptr(), idx.data_ptr(), ent.data_ptr(),
                    start.data_ptr(), perm.data_ptr(), off.data_ptr(),
                    out.data_ptr(), _build.stream_ptr(src), m, n, d, R, nbi,
                    shift), "F")
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
