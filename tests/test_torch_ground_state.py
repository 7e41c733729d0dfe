"""Kernel E's method (reactive_pb_nn_md_tpu_torch/csrc/ground_state.cu), on
the CPU: a plain fp64 transcription of its steps -- Householder
tridiagonalization, Sturm-count multisection for lambda_0, inverse
iteration for c_0, the back-transform -- held against the port's plain
ground_state_eigh and the JAX package's ground_state_eigh on padded
EVB-shaped Hamiltonians, the near-degenerate one included.  It checks the
numerics of the method where it can run; the kernel itself is held
against ground_state_eigh on the card (tests/test_torch_cuda.py)."""

import math

import numpy as np
import pytest
import torch

from test_ground_state import _evb_like
from reactive_pb_nn_md_tpu.ops.ground_state import (
    ground_state_eigh as jax_eigh)
from reactive_pb_nn_md_tpu_torch.ops import ground_state as gs

EPS = 2.0 ** -52
SHIFTS = 128                  # the kernel's shifts a round
SOLVES = 3                    # GS_SOLVES
GOLDEN = 0.6180339887498949   # the start vector's Weyl sequence
# the rounds that close any Gershgorin interval (csrc/ground_state.cu:
# 129x narrower a round, from at most 2 max|bound| to 4 eps max|bound|)
ROUNDS = 8


def _tridiagonalize(A):
    """(d, e, taus, V, nact) of the active block A[:nact, :nact] (the rows
    past the last one with an off-diagonal element are parked):
    T = Q^T A Q, Q = H_0 ... H_{nact-3}, H_k = I - tau_k v_k v_k^T with
    v_k = (0..0, 1, V[k, k+2:]) (the kernel keeps V[k] in A's row k)."""
    off = torch.nonzero(A - torch.diag(A.diagonal()))
    nact = int(off.max()) + 1 if off.numel() else 0
    A = A[:nact, :nact].clone()
    d = A.diagonal().clone()
    e = torch.zeros(max(nact - 1, 0), dtype=torch.float64)
    taus = torch.zeros(nact, dtype=torch.float64)
    V = torch.zeros(nact, nact, dtype=torch.float64)
    for k in range(nact - 2):
        x0 = float(A[k + 1, k])
        sig = float((A[k + 2:, k] ** 2).sum())
        d[k] = A[k, k]
        if sig == 0.0:
            e[k] = x0
            continue
        mu = math.sqrt(x0 * x0 + sig)
        beta = -mu if x0 >= 0.0 else mu
        tau = (beta - x0) / beta
        v = torch.cat([torch.ones(1, dtype=torch.float64),
                       A[k + 2:, k] * (1.0 / (x0 - beta))])
        e[k], taus[k], V[k, k + 2:] = beta, tau, v[1:]
        B = A[k + 1:, k + 1:]
        p = tau * (B @ v)
        w = p - 0.5 * tau * float(v @ p) * v
        B -= torch.outer(v, w) + torch.outer(w, v)
    if nact >= 2:
        d[nact - 2], e[nact - 2] = A[nact - 2, nact - 2], A[nact - 1, nact - 2]
        d[nact - 1] = A[nact - 1, nact - 1]
    return d, e, taus, V, nact


def _bounds(d, e):
    """(lo, hi, tol, tnorm): lambda_0's Gershgorin interval, the width at
    which multisection stops, ||T||_inf."""
    S = d.shape[0]
    ae = e.abs()
    off = torch.zeros(S, dtype=torch.float64)
    off[:-1] += ae
    off[1:] += ae
    tnorm = float((d.abs() + off).max())
    fudge = 2.1 * S * EPS * tnorm
    lo = float((d - off).min()) - fudge
    hi = float(d.min()) + fudge
    tol = 4.0 * EPS * max(abs(lo), abs(hi))
    return lo, hi, tol, tnorm


def _sturm_negative(d, e2, x):
    """Whether T - x I has a non-positive LDL^T pivot (x >= lambda_0), at
    each shift x, by the leading minors p_i = (d_i - x) p_{i-1} - e2_{i-1}
    p_{i-2} (the pivots are their ratios), rescaled every fourth step by
    2^-600 (2^600) when they have left [2^-600, 2^600]."""
    p0 = torch.ones_like(x)
    p1 = d[0] - x
    neg = p1 <= 0
    for i in range(1, d.shape[0]):
        p2 = (d[i] - x) * p1 - e2[i - 1] * p0
        neg |= p2 <= 0
        p0, p1 = p1, p2
        if i % 4 == 0:
            m = torch.maximum(p0.abs(), p1.abs())
            f = torch.ones_like(m)
            f[m > 2.0 ** 600] = 2.0 ** -600
            f[m < 2.0 ** -600] = 2.0 ** 600
            p0, p1 = p0 * f, p1 * f
    return neg


def _multisection(d, e, lo, hi, tol):
    """(lambda_0, rounds, closed): each round tests SHIFTS shifts and
    keeps the interval between the last shift below lambda_0 and the
    first above it (at most 64 rounds: a guard, not the kernel's limit)."""
    e2 = e * e
    t = torch.arange(1, SHIFTS + 1, dtype=torch.float64)
    rounds = 0
    while hi - lo > tol and rounds < 64:
        h = (hi - lo) / (SHIFTS + 1)
        hit = torch.nonzero(_sturm_negative(d, e2, lo + h * t))
        if hit.numel():
            ts = int(hit[0, 0])
            lo, hi = (lo + h * ts if ts > 0 else lo), lo + h * (ts + 1)
        else:
            lo = lo + h * SHIFTS
        rounds += 1
    lam = lo + 0.5 * (hi - lo)
    return lam, rounds, hi - lo <= tol


def _inverse_iteration(d, e, lam, ptol):
    """y with (T - lam I) y ~ 0: LU with partial pivoting of the
    tridiagonal T - lam I (LAPACK dgttrf; a pivot below ptol raised to
    ptol), SOLVES solves from a fixed start, each but the first from the
    last one's result over its largest element."""
    S = len(d)
    e = list(e) + [0.0]
    dd, dl, du, du2 = [0.0] * S, [0.0] * S, [0.0] * S, [0.0] * S
    piv = [False] * S
    di, ui = d[0] - lam, e[0]
    for i in range(S - 1):
        li, dn, un = e[i], d[i + 1] - lam, e[i + 1]
        if abs(di) >= abs(li):
            f = li / di if di != 0.0 else 0.0
            dd[i], dl[i], du[i] = di, f, ui
            di, ui = dn - f * ui, un
        else:
            f = di / li
            dd[i], dl[i], du[i], du2[i], piv[i] = li, f, dn, un, True
            di, ui = ui - f * dn, -f * un
    dd[S - 1] = di
    rdd = [1.0 / (x if abs(x) >= ptol else math.copysign(ptol, x))
           for x in dd]
    y = [2.0 * math.fmod((i + 1) * GOLDEN, 1.0) - 1.0 for i in range(S)]
    inv = 1.0
    for _ in range(SOLVES):
        b = [v * inv for v in y]
        for i in range(S - 1):
            if piv[i]:
                b[i], b[i + 1] = b[i + 1], b[i] - dl[i] * b[i + 1]
            else:
                b[i + 1] -= dl[i] * b[i]
        y1 = y2 = 0.0
        for i in range(S - 1, -1, -1):
            y[i] = (b[i] - du[i] * y1 - du2[i] * y2) * rdd[i]
            y1, y2 = y[i], y1
        inv = 1.0 / max(abs(v) for v in y)
    return [v * inv for v in y]


def kernel_e_method(H):
    """(lambda_0, c_0, info) of H as kernel E computes them, in fp64: on
    the active block, unless a parked diagonal lies below its lowest
    eigenvalue (then that state); info = the multisection rounds, -1 when
    the interval did not close or the residual ||(T - lambda_0 I) y||_inf
    exceeded 16 nact eps ||T||_inf ||y||_inf."""
    H = H.to(torch.float64)
    S = H.shape[0]
    h00 = float(H[0, 0])
    A = H - h00 * torch.eye(S, dtype=torch.float64)
    d, e, taus, V, nact = _tridiagonalize(A)
    parked = A.diagonal()[nact:]
    if nact == 0:
        lam_a, rounds, closed = math.inf, 0, True
    else:
        lo, hi, tol, tnorm = _bounds(d, e)
        lam_a, rounds, closed = _multisection(d, e, lo, hi, tol)
    if parked.numel() and float(parked.min()) < lam_a:
        # a parked state below the active block is the ground state
        c = torch.zeros(S, dtype=torch.float64)
        c[nact + int(torch.argmin(parked))] = 1.0
        return float(parked.min()) + h00, c, rounds if closed else -1
    scale = max(abs(lo), abs(hi))
    ptol = EPS * scale if scale > 0.0 else 1.0
    y = _inverse_iteration(d.tolist(), e.tolist(), lam_a, ptol)
    yt = torch.tensor(y, dtype=torch.float64)
    r = (d - lam_a) * yt
    r[:-1] += e * yt[1:]
    r[1:] += e * yt[:-1]
    # (y's largest element is 1)
    ok = closed and float(r.abs().max()) <= 16.0 * nact * EPS * tnorm
    for k in range(nact - 3, -1, -1):
        v = V[k, k + 1:].clone()
        v[0] = 1.0
        yt[k + 1:] -= taus[k] * float(v @ yt[k + 1:]) * v
    c = torch.zeros(S, dtype=torch.float64)
    c[:nact] = gs.fix_sign(yt / yt.norm())
    return lam_a + h00, c, rounds if ok else -1


def _diagonal(S, rng):
    return np.diag(-24000.0 + 50.0 * rng.standard_normal(S))


def _degenerate(S, rng):
    """Two equal lowest diagonals and no coupling: a ground gap of 0."""
    H = _diagonal(S, rng)
    H[3, 3] = H[5, 5] = H.diagonal().min() - 10.0
    return H


def _parked_lowest(S, rng):
    """A parked (decoupled) state below every active one."""
    H = np.array(_evb_like(S, S // 2, rng), np.float64)
    H[S - 3, S - 3] = H.diagonal()[:S // 2].min() - 200.0
    return H


CASES = {
    "S80": lambda rng: _evb_like(80, 60, rng),
    "S48": lambda rng: _evb_like(48, 40, rng),
    "S32": lambda rng: _evb_like(32, 20, rng),
    "S80_near_degenerate": lambda rng: _evb_like(80, 40, rng, gap=1e-7),
    "S81": lambda rng: _evb_like(81, 70, rng),
    "S120": lambda rng: _evb_like(120, 100, rng),
    "S2": lambda rng: _evb_like(2, 2, rng),
    "S33": lambda rng: _evb_like(33, 30, rng),
    "S64": lambda rng: _evb_like(64, 50, rng),
    "diagonal": lambda rng: _diagonal(24, rng),
    "degenerate": lambda rng: _degenerate(24, rng),
    "parked_lowest": lambda rng: _parked_lowest(24, rng),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_e_method_matches_eigh(case):
    """fp64: |dlambda| <= 1e-10 |lambda|, |dc| <= 1e-9 unless the ground
    gap is <= 1e-6 (then the residual of c instead); the same bars as
    the kernel's against eigh on the card."""
    H = np.asarray(CASES[case](np.random.default_rng(11)), np.float64)
    Ht = torch.tensor(H)
    lam, c, info = kernel_e_method(Ht)
    assert 0 <= info <= ROUNDS
    lp, cp = gs.ground_state_eigh(Ht)
    refs = [(float(lp), cp)]
    if len(H) == 80:
        # the JAX package's too, at the full cap alone: a compilation a
        # shape (the two packages' plain versions agree in
        # tests/test_torch_scan.py)
        lj, cj = jax_eigh(H)
        refs.append((float(lj), torch.tensor(np.asarray(cj))))
    w = np.linalg.eigvalsh(H - H[0, 0] * np.eye(len(H)))
    gap = w[1] - w[0] if len(w) > 1 else np.inf
    for lref, cref in refs:
        assert abs(lam - lref) <= 1e-10 * abs(lref)
        if gap > 1e-6:
            dc = min(float((c - cref).abs().max()),
                     float((c + cref).abs().max()))
            assert dc <= 1e-9
    assert abs(float(c.norm()) - 1.0) <= 1e-14
    res = Ht @ c - lam * c
    assert float(res.abs().max()) <= 1e-9
    i = int(torch.argmax(c.abs()))
    assert float(c[i]) > 0
