"""Cardinal B-splines for PME (counterpart of reactive_pb_nn_md_tpu/ops/bspline.py).

Cox-de Boor recursion evaluated analytically, differentiable by autograd.
"""

import numpy as np
import torch


def mn_all(frac, order):
    """M_order(frac + k) for k = 0..order-1: (...,) -> (..., order)."""
    k = torch.arange(order, dtype=frac.dtype, device=frac.device)
    x = frac[..., None] + k
    m = torch.clamp(1.0 - torch.abs(x - 1.0), min=0.0)      # M_2
    for j in range(3, order + 1):
        m_shift = torch.cat([torch.zeros_like(m[..., :1]), m[..., :-1]],
                            dim=-1)
        m = (x * m + (j - x) * m_shift) / (j - 1)
    return m


def bspline_weights(u, order):
    """(weights M_order(frac + k), floor(u) as int64) for u in [0, K);
    the grid point of slot k is (floor(u) - k) mod K."""
    nearpt = torch.floor(u)
    return mn_all(u - nearpt, order), nearpt.to(torch.int64)


def bspline_weights_and_derivs(u, order):
    """(w, dw/du, nearpt): dM_n(x)/dx = M_{n-1}(x) - M_{n-1}(x - 1)."""
    nearpt = torch.floor(u)
    frac = u - nearpt
    w = mn_all(frac, order)
    m1 = mn_all(frac, order - 1)
    z = torch.zeros_like(m1[..., :1])
    dw = torch.cat([m1, z], dim=-1) - torch.cat([z, m1], dim=-1)
    return w, dw, nearpt.to(torch.int64)


def bm_sq_factors(K, order):
    """|b(m)|^2 Essmann factors (pme.f90:578-595), numpy."""
    def mn(x, n):
        if n == 2:
            return max(0.0, 1.0 - abs(x - 1.0))
        return (x * mn(x, n - 1) + (n - x) * mn(x - 1, n - 1)) / (n - 1)

    mvals = np.array([mn(i + 1.0, order) for i in range(order - 1)])
    m = np.arange(K)
    phase = 2.0 * np.pi * np.outer(m, np.arange(order - 1)) / K
    b = (mvals[None, :] * np.exp(1j * phase)).sum(axis=1)
    bm = 1.0 / b
    return bm.real ** 2 + bm.imag ** 2
