"""WHAM: the weighted-histogram analysis method for umbrella sampling
(a copy of reactive_pb_nn_md_tpu/analysis/wham.py, host numpy in fp64).

Reconstructs the unbiased potential of mean force F(xi) from a ladder of
harmonically restrained windows (md/bias.HarmonicBias ladders driven by
parallel/umbrella.py).  It runs once a ladder on O(windows x bins) data
on the host, so it has no kernel.

Standard self-consistent equations (Kumar et al. 1992):

    P(b)  =  sum_i n_i(b)  /  sum_i N_i exp[(f_i - U_i(xi_b)) / kT]
    exp(-f_i / kT)  =  sum_b P(b) exp(-U_i(xi_b) / kT)

iterated to |delta f| convergence; F(xi_b) = -kT ln P(b), min-shifted to 0.
Uncertainty by block bootstrap over each window's time series (blocks ~
the CV autocorrelation time, so resampling respects serial correlation).
"""

import numpy as np

from ..utils.constants import KB


def harmonic_bias_energy(xi, centers, k_spring):
    """(W, B) bias energies U_i(xi_b) = 0.5 k_i (xi_b - c_i)^2."""
    xi = np.asarray(xi, np.float64)[None, :]
    c = np.asarray(centers, np.float64)[:, None]
    k = np.broadcast_to(np.asarray(k_spring, np.float64).reshape(-1, 1),
                        c.shape)
    return 0.5 * k * (xi - c) ** 2


def wham(cv_series, centers, k_spring, temperature, n_bins=61,
         bin_range=None, tol=1e-10, max_iter=100000):
    """Solve WHAM for a window ladder.

    cv_series : (W, T) CV samples per window (or a list of 1-D arrays)
    centers   : (W,) bias centers, k_spring: scalar or (W,) kJ/mol/A^2
    returns dict with bin_centers, pmf (kJ/mol, min=0), f_i (window free
    energies), prob (unbiased density), counts, converged, n_iter.
    """
    series = [np.asarray(s, np.float64).ravel() for s in cv_series]
    W = len(series)
    kT = KB * float(temperature)
    if bin_range is None:
        lo = min(s.min() for s in series)
        hi = max(s.max() for s in series)
        pad = 1e-9 * max(1.0, abs(hi - lo))
        bin_range = (lo - pad, hi + pad)
    edges = np.linspace(bin_range[0], bin_range[1], n_bins + 1)
    mids = 0.5 * (edges[:-1] + edges[1:])

    counts = np.stack([np.histogram(s, bins=edges)[0] for s in series])
    N_i = counts.sum(axis=1).astype(np.float64)          # in-range samples
    n_b = counts.sum(axis=0).astype(np.float64)          # (B,)
    u_ib = harmonic_bias_energy(mids, centers, k_spring)  # (W, B)
    c_ib = np.exp(-u_ib / kT)

    f = np.zeros(W)
    converged = False
    it = 0
    for it in range(1, max_iter + 1):
        denom = (N_i * np.exp(f / kT)) @ c_ib             # (B,)
        with np.errstate(divide="ignore", invalid="ignore"):
            p = np.where(denom > 0.0, n_b / denom, 0.0)
        z = c_ib @ p                                       # (W,)
        f_new = -kT * np.log(np.where(z > 0.0, z, 1.0))
        f_new -= f_new[0]
        delta = np.max(np.abs(f_new - f))
        f = f_new
        if delta < tol:
            converged = True
            break

    with np.errstate(divide="ignore"):
        pmf = -kT * np.log(np.where(p > 0.0, p, np.nan))
    pmf -= np.nanmin(pmf)
    return {"bin_centers": mids, "pmf": pmf, "f_i": f, "prob": p,
            "counts": counts, "converged": converged, "n_iter": it,
            "kT": kT}


def wham_bootstrap(cv_series, centers, k_spring, temperature, n_boot=20,
                   block=None, seed=0, **kwargs):
    """Block-bootstrap PMF uncertainty: resample each window's series in
    contiguous blocks (default T/20, >= 10 samples), re-solve WHAM, and
    return (result, pmf_std) where result is the full-data solution."""
    rng = np.random.default_rng(seed)
    series = [np.asarray(s, np.float64).ravel() for s in cv_series]
    res = wham(series, centers, k_spring, temperature, **kwargs)
    # pin the bootstrap to the full-data support so bins line up
    kwargs = dict(kwargs)
    kwargs.setdefault("bin_range", (res["bin_centers"][0]
                                    - 0.5 * np.diff(res["bin_centers"])[0],
                                    res["bin_centers"][-1]
                                    + 0.5 * np.diff(res["bin_centers"])[0]))
    boots = []
    for _ in range(n_boot):
        resampled = []
        for s in series:
            T = s.size
            b = block or max(10, T // 20)
            n_blocks = max(1, int(np.ceil(T / b)))
            starts = rng.integers(0, max(1, T - b + 1), size=n_blocks)
            idx = (starts[:, None] + np.arange(b)[None, :]).ravel()[:T]
            resampled.append(s[np.minimum(idx, T - 1)])
        boots.append(wham(resampled, centers, k_spring, temperature,
                          **kwargs)["pmf"])
    pmf_std = np.nanstd(np.stack(boots), axis=0)
    return res, pmf_std


def barrier_height(bin_centers, pmf, split=0.0):
    """Transfer barrier from a double-well PMF: max between the two well
    minima (wells searched on each side of `split`).  Returns (barrier,
    xi_barrier, left_min, right_min); NaN barrier when a side is empty."""
    b = np.asarray(bin_centers)
    v = np.asarray(pmf, np.float64)
    left = (b < split) & np.isfinite(v)
    right = (b >= split) & np.isfinite(v)
    if not left.any() or not right.any():
        return float("nan"), float("nan"), float("nan"), float("nan")
    li = np.flatnonzero(left)[np.nanargmin(v[left])]
    ri = np.flatnonzero(right)[np.nanargmin(v[right])]
    mid = v[li:ri + 1]
    if mid.size == 0 or not np.isfinite(mid).any():
        return float("nan"), float("nan"), float(v[li]), float(v[ri])
    mi = li + int(np.nanargmax(mid))
    barrier = float(v[mi] - min(v[li], v[ri]))
    return barrier, float(b[mi]), float(v[li]), float(v[ri])
