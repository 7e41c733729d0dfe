"""Kernel F's order and sum (ops/kernels/segment_sum.py,
csrc/segment_sum.cu) on the cases its kernels must meet: an empty index,
all padding, rows with no entry, one row taking every entry (more than
CHUNK entries, so the second kernel takes the bucket twice), a batched
(nb, M) index with padding, and M at the first kernel's tile size TILE
and TILE +- 1 (an index of one tile is ordered by the first kernel
alone, one of two tiles by both).

On the CPU: segment_order (the torch-sort order, the kernels' plain
version) lists each row's entries in ascending m after the padding, and
segment_sum_plain equals index_add over the non-padding entries bit for
bit, fp64 and fp32, each replica of a batched index too.

On the card (`cuda`, skipped here): the kernels' (perm, off) equal
segment_order's in off and on every row (perm[off[0]:off[n]]), and F's
sums equal segment_sum_plain bit for bit, fp64 and fp32, single and
batched (an index shared by the batch and a batched one); one call
profiles as F's own kernels and nothing else, at most 3 launches.  The
file imports no jax; on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_segment_order.py -q
"""

import numpy as np
import pytest
import torch

from reactive_pb_nn_md_tpu_torch.ops.kernels import segment_sum as ss

T, C = ss.TILE, ss.CHUNK
# name -> (seed, M, n, nb (None: a flat index), padding share, hot row
# share (entries on row 1)); the index is drawn in [0, n), then padded
CASES = {
    "empty": (0, 0, 5, None, 0.0, 0.0),
    "all padding": (1, 37, 4, None, 1.0, 0.0),
    "rows with no entry": (2, 300, 12, None, 0.2, 0.0),
    "one row takes every entry": (3, 2 * C + 7, 8, None, 0.0, 1.0),
    "batched with padding": (4, 500, 40, 3, 0.3, 0.1),
    "M = TILE - 1": (5, T - 1, 97, None, 0.25, 0.05),
    "M = TILE": (6, T, 97, None, 0.25, 0.05),
    "M = TILE + 1": (7, T + 1, 97, None, 0.25, 0.05),
}
# on the card only: one tile into the most rows its first kernel orders
# alone and one row more (both launches); the main path's sizes: the
# flagship's largest call, the 10k box's, a batch of 10k replicas, the
# 100k box's
CARD_CASES = {
    "one tile, DIRECT_ROWS rows": (12, 2000, ss.DIRECT_ROWS, None, 0.2,
                                   0.01),
    "one tile, DIRECT_ROWS + 1 rows": (13, 2000, ss.DIRECT_ROWS + 1, None,
                                       0.2, 0.01),
    "flagship": (8, 19_392, 649, None, 0.5, 0.02),
    "10k": (9, 29_997, 13_332, None, 0.0, 0.0),
    "10k batch": (10, 29_997, 13_332, 4, 0.1, 0.0),
    "100k": (11, 300_000, 133_332, None, 0.1, 0.001),
}


def _case(spec):
    """(idx int64 (M,) or (nb, M), n) of a case: rows with no entry are
    every row the draw misses (n of 12 from {0, 2, 5, 9} in that case),
    padding entries are -1 or -7."""
    seed, m, n, nb, pad, hot = spec
    rng = np.random.default_rng(seed)
    shape = (m,) if nb is None else (nb, m)
    rows = (rng.choice([0, 2, 5, 9], shape) if n == 12
            else rng.integers(0, n, shape))
    rows = np.where(rng.random(shape) < hot, 1, rows)
    rows = np.where(rng.random(shape) < pad, rng.choice([-1, -7], shape),
                    rows)
    return torch.as_tensor(rows, dtype=torch.int64), n


def _expected_order(i, n):
    """(perm of the rows' entries, off) as numpy: after the padding, the
    entries of row 0, 1, ... each in ascending m."""
    i = i.numpy()
    valid = np.nonzero(i >= 0)[0]
    perm = valid[np.argsort(i[valid], kind="stable")]
    n_pad = int((i < 0).sum())
    off = n_pad + np.searchsorted(np.sort(i[valid]), np.arange(n + 1))
    return perm, off


def _replicas(idx):
    return list(idx) if idx.ndim == 2 else [idx]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_order_and_sum_equal_index_add(name):
    idx, n = _case(CASES[name])
    g = np.random.default_rng(100 + CASES[name][0])
    for i in _replicas(idx):
        perm, off = ss.segment_order(i, n)
        want_perm, want_off = _expected_order(i, n)
        assert np.array_equal(off.numpy(), want_off)
        assert np.array_equal(perm[int(off[0]):int(off[n])].numpy(),
                              want_perm)
        keep = i >= 0
        for dtype in (torch.float64, torch.float32):
            src = torch.as_tensor(g.standard_normal((i.numel(), 3)),
                                  dtype=dtype)
            ref = torch.zeros(n, 3, dtype=dtype).index_add(0, i[keep],
                                                           src[keep])
            assert torch.equal(ss.segment_sum_plain(src, i, n), ref)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel F has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES) + list(CARD_CASES))
def test_kernel_order_equals_segment_order(name):
    dev = _card()
    idx, n = _case({**CASES, **CARD_CASES}[name])
    perm, off = ss.segment_order_kernels(idx.to(dev), n)
    perm, off = perm.cpu(), off.cpu()
    if idx.ndim == 1:
        perm, off = perm[None], off[None]
    for i, p, o in zip(_replicas(idx), perm, off):
        ref_perm, ref_off = ss.segment_order(i, n)
        assert torch.equal(o.long(), ref_off)
        a, b = int(ref_off[0]), int(ref_off[n])
        assert torch.equal(p[a:b].long(), ref_perm[a:b])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", list(CASES) + list(CARD_CASES))
def test_kernel_sum_equals_plain_bit_for_bit(name, dtype):
    dev = _card()
    spec = {**CASES, **CARD_CASES}[name]
    idx, n = _case(spec)
    g = np.random.default_rng(200 + spec[0])
    W = idx.shape[0] if idx.ndim == 2 else 3
    src = torch.as_tensor(g.standard_normal((W, idx.shape[-1], 3)),
                          dtype=dtype)
    reps = _replicas(idx) if idx.ndim == 2 else [idx] * W
    ref = torch.stack([ss.segment_sum_plain(s, i, n)
                       for s, i in zip(src, reps)])
    singles = torch.stack([ss.segment_sum_cuda(s.to(dev), i.to(dev), n)
                           for s, i in zip(src, reps)]).cpu()
    assert torch.equal(singles, ref)
    batched = ss.segment_sum_cuda(src.to(dev), idx.to(dev), n, nb=W)
    assert torch.equal(batched.cpu(), ref)
    if idx.ndim == 1:
        # the same index stacked: ordered for each replica on its own
        batched = ss.segment_sum_cuda(src.to(dev), idx.to(dev).expand(
            W, -1).contiguous(), n, nb=W)
        assert torch.equal(batched.cpu(), ref)


@pytest.mark.cuda
def test_one_call_runs_only_f_kernels():
    dev = _card()
    from torch.profiler import ProfilerActivity, profile
    idx, n = _case(CARD_CASES["flagship"])
    idx = idx.to(dev)
    src = torch.randn(idx.numel(), 3, dtype=torch.float64, device=dev)
    ss.segment_sum_cuda(src, idx, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ss.segment_sum_cuda(src, idx, n)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 1 <= len(names) <= 3, names
    assert all("segment_" in k for k in names), names
