"""Kernel C: per-diabat reciprocal-space delta energies (C1) and their
backward (C2).

Replaces reactive_pb_nn_md_tpu/ops/pallas/recip_perstate.py:_fwd ->
_fwd_kernel and _bwd -> _bwd_kernel, source ``csrc/recip_perstate.cu``.

    E_s = sum_m cbw [F0r Gr + F0i Gi + (Gr^2 + Gi^2)/2],
    G_s(m1, m23) = sum_u dq_su A_u(m1) BC_u(m23)

The boundary is real-valued, as in the JAX package: the caller splits A,
BC and F0 into real and imaginary parts, so torch's complex-autograd
convention never crosses the Function.  The last axis is the unpadded
half spectrum Mh = K (K/2 + 1).  What bounds the kernels on the H100 is in
the source.  ``perstate_recip_energy`` runs the kernels for CUDA tensors
and the plain ``W @ BC`` formulation (models/pme.py:294-305 of the JAX
package) for CPU tensors, whose gradient autograd takes.  On the card
the Function's forward and backward are torch.library ops whose
batching rules launch C1 / C2 once for a whole replica batch
(torch.func.vmap over the MD step).
"""

import functools

import torch

from . import _build


def perstate_plain(dq, ar, ai, bcr, bci, f0r, f0i, cbw):
    """(S,) energies by the W @ BC matmul formulation (autograd backward)."""
    S, U = dq.shape
    K = ar.shape[0]
    Wr = (dq[:, None, :] * ar[None]).reshape(S * K, U)
    Wi = (dq[:, None, :] * ai[None]).reshape(S * K, U)
    Gr = (Wr @ bcr - Wi @ bci).reshape(S, K, -1)
    Gi = (Wr @ bci + Wi @ bcr).reshape(S, K, -1)
    return torch.sum(cbw * (f0r * Gr + f0i * Gi + 0.5 * (Gr * Gr + Gi * Gi)),
                     dim=(1, 2))


def perstate_bwd_plain(gbar, dq, ar, ai, bcr, bci, f0r, f0i, cbw):
    """The cotangents (ddq, dar, dai, dbcr, dbci, df0r, df0i) of
    perstate_plain's energies for the cotangent gbar (S,), written out:
    the plain version of C2 (autograd of perstate_plain gives the same to
    rounding)."""
    S, U = dq.shape
    K = ar.shape[0]
    Wr = (dq[:, None, :] * ar[None]).reshape(S * K, U)
    Wi = (dq[:, None, :] * ai[None]).reshape(S * K, U)
    Gr = (Wr @ bcr - Wi @ bci).reshape(S, K, -1)
    Gi = (Wr @ bci + Wi @ bcr).reshape(S, K, -1)
    g = gbar[:, None, None] * cbw
    dGr, dGi = (g * (f0r + Gr)).reshape(S * K, -1), \
        (g * (f0i + Gi)).reshape(S * K, -1)
    dWr = (dGr @ bcr.T + dGi @ bci.T).reshape(S, K, U)
    dWi = (dGi @ bcr.T - dGr @ bci.T).reshape(S, K, U)
    return ((dWr * ar + dWi * ai).sum(1),
            (dWr * dq[:, None, :]).sum(0), (dWi * dq[:, None, :]).sum(0),
            Wr.T @ dGr + Wi.T @ dGi, Wr.T @ dGi - Wi.T @ dGr,
            (g * Gr).sum(0), (g * Gi).sum(0))


_SHAPES = ("dq", "ar", "ai", "bcr", "bci", "f0r", "f0i", "cbw")
# the argument pairs a batched launch takes one stride for
_PAIRS = ((1, 2), (3, 4), (5, 6))


def _check(dq, ar, ai, bcr, bci, f0r, f0i, cbw, nb=None):
    """(S, U, K, Mh, the batch strides (dq, A, BC, F0, cbw)) of kernel C's
    arguments; with nb, each stacked on a leading axis of nb or shared."""
    S, U = _build.unbatched(dq, 2)
    K, Mh = _build.unbatched(f0r, 2)
    f = dq.dtype
    shapes = ((S, U), (K, U), (K, U), (U, Mh), (U, Mh), (K, Mh), (K, Mh),
              (K, Mh))
    strides = []
    for name, t, shape in zip(_SHAPES, (dq, ar, ai, bcr, bci, f0r, f0i, cbw),
                              shapes):
        _build.require(t, f, None, name)
        if _build.unbatched(t, 2) != shape or (not nb and t.ndim != 2):
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        strides.append(_build.stride(t, 2, nb) if nb else 0)
    for a, b in _PAIRS:
        if strides[a] != strides[b]:
            raise ValueError(f"{_SHAPES[a]} and {_SHAPES[b]} must be "
                             f"batched alike")
    return S, U, K, Mh, (strides[0], strides[1], strides[3], strides[5],
                         strides[7])


@functools.lru_cache(maxsize=None)
def _layout(f64, S, U, K, Mh):
    """(C1 scratch elements, C2 scratch elements, C1 column blocks), of
    one replica."""
    scratch = _build.function("perstate_scratch", 0, 6)
    cols = _build.function("perstate_tile_cols", 0, 1)
    return (scratch(f64, 0, S, U, K, Mh), scratch(f64, 1, S, U, K, Mh),
            -(-Mh // cols(f64)))


def perstate_fwd_cuda(dq, ar, ai, bcr, bci, f0r, f0i, cbw, nb=None):
    """Kernel C1: (S,) energies; with nb, a batched launch of nb replicas
    (each argument stacked on a leading axis of nb or shared), (nb, S)."""
    S, U, K, Mh, strides = _check(dq, ar, ai, bcr, bci, f0r, f0i, cbw, nb)
    f = dq.dtype
    n_scratch, _, ncb = _layout(int(f == torch.float64), S, U, K, Mh)
    partial = torch.empty((nb or 1, S, K * ncb), dtype=f, device=dq.device)
    scratch = torch.empty((nb or 1) * n_scratch, dtype=f, device=dq.device)
    fn = _build.function("perstate_fwd_" + _build.suffix(f), 11, 10)
    _build.check(fn(*[t.data_ptr() for t in (
        dq, ar, ai, bcr, bci, f0r, f0i, cbw, partial, scratch)],
        _build.stream_ptr(dq), S, U, K, Mh, nb or 1, *strides), "C1")
    _build.launches["C1"] += 1
    # per-row partials, in a fixed order
    return partial.sum(dim=2) if nb else partial[0].sum(dim=1)


def perstate_bwd_cuda(gbar, dq, ar, ai, bcr, bci, f0r, f0i, cbw, nb=None):
    """Kernel C2: cotangents (ddq, dar, dai, dbcr, dbci, df0r, df0i); with
    nb, a batched launch of nb replicas, each cotangent (nb, ...)."""
    S, U, K, Mh, strides = _check(dq, ar, ai, bcr, bci, f0r, f0i, cbw, nb)
    f = dq.dtype
    _build.require(gbar, f, None, "gbar")
    if _build.unbatched(gbar, 1) != (S,) or (not nb and gbar.ndim != 1):
        raise ValueError(f"gbar must have shape {(S,)}, got "
                         f"{tuple(gbar.shape)}")
    g_bs = _build.stride(gbar, 1, nb) if nb else 0
    lead = (nb,) if nb else ()

    def new(*shape):
        return torch.empty(lead + shape, dtype=f, device=dq.device)

    scratch = new(_layout(int(f == torch.float64), S, U, K, Mh)[1])
    ddq, dar, dai = new(S, U), new(K, U), new(K, U)
    dbcr, dbci = new(U, Mh), new(U, Mh)
    df0r, df0i = new(K, Mh), new(K, Mh)
    fn = _build.function("perstate_bwd_" + _build.suffix(f), 18, 11)
    _build.check(fn(*[t.data_ptr() for t in (
        gbar, dq, ar, ai, bcr, bci, f0r, f0i, cbw, scratch, ddq, dar, dai,
        dbcr, dbci, df0r, df0i)], _build.stream_ptr(dq), S, U, K, Mh,
        nb or 1, g_bs, *strides), "C2")
    _build.launches["C2"] += 1
    return ddq, dar, dai, dbcr, dbci, df0r, df0i


_T = torch.Tensor


@torch.library.custom_op(_build.OPS + "::perstate_fwd", mutates_args=())
def perstate_fwd(dq: _T, ar: _T, ai: _T, bcr: _T, bci: _T, f0r: _T, f0i: _T,
                 cbw: _T) -> _T:
    """(S,) energies: kernel C1 for CUDA tensors, perstate_plain for CPU
    ones; a replica batch (vmap) launches C1 once for all replicas."""
    if dq.is_cuda:
        return perstate_fwd_cuda(dq, ar, ai, bcr, bci, f0r, f0i, cbw)
    return perstate_plain(dq, ar, ai, bcr, bci, f0r, f0i, cbw)


@perstate_fwd.register_fake
def _(dq, ar, ai, bcr, bci, f0r, f0i, cbw):
    return dq.new_empty(dq.shape[0])


@perstate_fwd.register_vmap
def _(info, in_dims, *args):
    args = _build.front(args, in_dims)
    if args[0].is_cuda:
        nb = info.batch_size
        return perstate_fwd_cuda(*_build.alike(args, in_dims, _PAIRS, nb),
                                 nb=nb), 0
    return torch.stack([perstate_fwd(*_build.replica(args, in_dims, i))
                        for i in range(info.batch_size)]), 0


@torch.library.custom_op(_build.OPS + "::perstate_bwd", mutates_args=())
def perstate_bwd(gbar: _T, dq: _T, ar: _T, ai: _T, bcr: _T, bci: _T,
                 f0r: _T, f0i: _T, cbw: _T) -> tuple[_T, _T, _T, _T, _T, _T,
                                                     _T]:
    """C1's cotangents (ddq, dar, dai, dbcr, dbci, df0r, df0i): kernel C2
    for CUDA tensors, perstate_bwd_plain for CPU ones; a replica batch
    (vmap) launches C2 once for all replicas."""
    if dq.is_cuda:
        return perstate_bwd_cuda(gbar, dq, ar, ai, bcr, bci, f0r, f0i, cbw)
    return perstate_bwd_plain(gbar, dq, ar, ai, bcr, bci, f0r, f0i, cbw)


@perstate_bwd.register_fake
def _(gbar, dq, ar, ai, bcr, bci, f0r, f0i, cbw):
    return tuple(t.new_empty(t.shape) for t in (dq, ar, ai, bcr, bci, f0r,
                                               f0i))


@perstate_bwd.register_vmap
def _(info, in_dims, *args):
    nb = info.batch_size
    args = _build.front(args, in_dims)
    if args[0].is_cuda:
        pairs = tuple((a + 1, b + 1) for a, b in _PAIRS)
        return perstate_bwd_cuda(*_build.alike(args, in_dims, pairs, nb),
                                 nb=nb), (0,) * 7
    outs = [perstate_bwd(*_build.replica(args, in_dims, i))
            for i in range(nb)]
    return tuple(torch.stack(o) for o in zip(*outs)), (0,) * 7


class PerstateRecip(torch.autograd.Function):
    """C1 forward, C2 backward, both ops: under a replica batch (vmap)
    each launches once for all replicas.  C2's inputs are detached: under
    create_graph its result is a constant, the kernel's gradient."""
    generate_vmap_rule = True

    @staticmethod
    def forward(dq, ar, ai, bcr, bci, f0r, f0i, cbw):
        return perstate_fwd(*(t.contiguous() for t in (dq, ar, ai, bcr, bci,
                                                       f0r, f0i, cbw)))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, gbar):
        args = [t.detach().contiguous() for t in ctx.saved_tensors]
        grads = perstate_bwd(gbar.detach().contiguous(), *args)
        return grads + (None,)          # cbw: no cotangent (box fixed)


def perstate_recip_energy(dq, ar, ai, bcr, bci, f0r, f0i, cbw):
    """(S,) per-state reciprocal delta energies (unscaled by CONV): the
    kernels for CUDA tensors, the plain formulation (autograd's backward)
    for CPU ones."""
    if dq.is_cuda:
        return PerstateRecip.apply(dq, ar, ai, bcr, bci, f0r, f0i, cbw)
    return perstate_plain(dq, ar, ai, bcr, bci, f0r, f0i, cbw)
