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
package) for CPU tensors, whose gradient autograd takes.
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


def _check(dq, ar, ai, bcr, bci, f0r, f0i, cbw):
    S, U = dq.shape
    K, Mh = f0r.shape
    f = dq.dtype
    for name, t, shape in (("dq", dq, (S, U)), ("ar", ar, (K, U)),
                           ("ai", ai, (K, U)), ("bcr", bcr, (U, Mh)),
                           ("bci", bci, (U, Mh)), ("f0r", f0r, (K, Mh)),
                           ("f0i", f0i, (K, Mh)), ("cbw", cbw, (K, Mh))):
        _build.require(t, f, shape, name)
    return S, U, K, Mh


@functools.lru_cache(maxsize=None)
def _layout(f64, S, U, K, Mh):
    """(C1 scratch elements, C2 scratch elements, C1 column blocks)."""
    scratch = _build.function("perstate_scratch", 0, 6)
    cols = _build.function("perstate_tile_cols", 0, 1)
    return (scratch(f64, 0, S, U, K, Mh), scratch(f64, 1, S, U, K, Mh),
            -(-Mh // cols(f64)))


def perstate_fwd_cuda(dq, ar, ai, bcr, bci, f0r, f0i, cbw):
    """Kernel C1: (S,) energies."""
    S, U, K, Mh = _check(dq, ar, ai, bcr, bci, f0r, f0i, cbw)
    f = dq.dtype
    n_scratch, _, ncb = _layout(int(f == torch.float64), S, U, K, Mh)
    partial = torch.empty((S, K * ncb), dtype=f, device=dq.device)
    scratch = torch.empty(n_scratch, dtype=f, device=dq.device)
    fn = _build.function("perstate_fwd_" + _build.suffix(f), 11, 4)
    _build.check(fn(*[t.data_ptr() for t in (
        dq, ar, ai, bcr, bci, f0r, f0i, cbw, partial, scratch)],
        _build.stream_ptr(dq), S, U, K, Mh), "C1")
    _build.launches["C1"] += 1
    return partial.sum(dim=1)        # per-row partials, in a fixed order


def perstate_bwd_cuda(gbar, dq, ar, ai, bcr, bci, f0r, f0i, cbw):
    """Kernel C2: cotangents (ddq, dar, dai, dbcr, dbci, df0r, df0i)."""
    S, U, K, Mh = _check(dq, ar, ai, bcr, bci, f0r, f0i, cbw)
    f = dq.dtype
    _build.require(gbar, f, (S,), "gbar")

    def new(*shape):
        return torch.empty(shape, dtype=f, device=dq.device)

    scratch = new(_layout(int(f == torch.float64), S, U, K, Mh)[1])
    ddq, dar, dai = new(S, U), new(K, U), new(K, U)
    dbcr, dbci = new(U, Mh), new(U, Mh)
    df0r, df0i = new(K, Mh), new(K, Mh)
    fn = _build.function("perstate_bwd_" + _build.suffix(f), 18, 4)
    _build.check(fn(*[t.data_ptr() for t in (
        gbar, dq, ar, ai, bcr, bci, f0r, f0i, cbw, scratch, ddq, dar, dai,
        dbcr, dbci, df0r, df0i)], _build.stream_ptr(dq), S, U, K, Mh), "C2")
    _build.launches["C2"] += 1
    return ddq, dar, dai, dbcr, dbci, df0r, df0i


class PerstateRecip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dq, ar, ai, bcr, bci, f0r, f0i, cbw):
        args = tuple(t.contiguous() for t in (dq, ar, ai, bcr, bci, f0r,
                                              f0i, cbw))
        ctx.save_for_backward(*args)
        return perstate_fwd_cuda(*args)

    @staticmethod
    def backward(ctx, gbar):
        grads = perstate_bwd_cuda(gbar.contiguous(), *ctx.saved_tensors)
        return grads + (None,)          # cbw: no cotangent (box fixed)


def perstate_recip_energy(dq, ar, ai, bcr, bci, f0r, f0i, cbw):
    """(S,) per-state reciprocal delta energies (unscaled by CONV)."""
    if dq.is_cuda:
        return PerstateRecip.apply(dq, ar, ai, bcr, bci, f0r, f0i, cbw)
    return perstate_plain(dq, ar, ai, bcr, bci, f0r, f0i, cbw)
