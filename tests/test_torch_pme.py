"""Kernels B and C's plain versions against the JAX package.

B: the port's charge grid (spread) and its backward (gather) against JAX
   charge_grid_xla and charge_grid_pallas in interpret mode, at the
   tolerances of tests/test_pallas_pme.py.
C: the per-state reciprocal delta energies against JAX
   recip_delta_perstate (XLA formulation) in fp64, and the Pallas kernel
   in interpret mode in fp32 at the tolerances of
   tests/test_recip_perstate.py; values and position gradients; and the
   seven cotangents of the plain backward (kernel C2's contract) against
   the Pallas kernel's VJP in interpret mode."""

import functools
import inspect
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reactive_pb_nn_md_tpu.models import pme as jax_pme
from reactive_pb_nn_md_tpu.ops.pallas.pme_spread import charge_grid_pallas
from reactive_pb_nn_md_tpu.ops.pallas.recip_perstate import (
    perstate_recip_energy)
from reactive_pb_nn_md_tpu_torch.models import pme
from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_spread, recip_perstate


def _random_system(n=40, L=12.0, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, L, (n, 3)), rng.uniform(-1, 1, (n,)),
            np.eye(3) * L)


def _port_recip(x, q, box, K, order, alpha):
    xt = torch.tensor(x, requires_grad=True)
    qt = torch.tensor(q, requires_grad=True)
    bt = torch.tensor(box)
    cbw = pme.cb_half(bt, K, order, alpha)
    Q, over = pme.charge_grid(xt, qt, bt, K, order)
    assert not bool(over)
    e = pme.recip_energy(Q, cbw)
    gx, gq = torch.autograd.grad(e, (xt, qt))
    return Q.detach().numpy(), float(e.detach()), gx.numpy(), gq.numpy()


@pytest.mark.parametrize("impl,order", [("xla", 4), ("xla", 6),
                                        ("pallas", 4), ("pallas", 6)])
def test_charge_grid_matches_jax(impl, order):
    x, q, box = _random_system(n=30, seed=3)
    K, alpha = 16, 0.6
    spread = (jax_pme.charge_grid_xla if impl == "xla"
              else charge_grid_pallas)
    jbox = jnp.asarray(box)
    cbw = jax_pme.cb_half(jbox, K, order, alpha, dtype=jnp.float64)

    def e_ref(xx, qq):
        return jax_pme.recip_energy(spread(xx, qq, jbox, K, order), cbw)

    Q_ref = jax.jit(spread, static_argnums=(3, 4))(
        jnp.asarray(x), jnp.asarray(q), jbox, K, order)
    e_r, (gx_r, gq_r) = jax.jit(jax.value_and_grad(e_ref, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(q))
    Q, e, gx, gq = _port_recip(x, q, box, K, order, alpha)
    np.testing.assert_allclose(Q, np.asarray(Q_ref), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(e, float(e_r), rtol=1e-12)
    np.testing.assert_allclose(gx, np.asarray(gx_r), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(gq, np.asarray(gq_r), rtol=1e-8, atol=1e-10)


def test_gather_plain_matches_autograd():
    """The plain backward gather equals autograd through the plain spread
    (the contraction the B2 kernel fuses)."""
    x, q, box = _random_system(n=25, seed=5)
    K, order = 12, 6
    xt = torch.tensor(x, requires_grad=True)
    qt = torch.tensor(q, requires_grad=True)
    bt = torch.tensor(box)
    gQ = torch.tensor(np.random.default_rng(2).standard_normal(K ** 3))
    from reactive_pb_nn_md_tpu_torch.ops.bspline import bspline_weights
    from reactive_pb_nn_md_tpu_torch.utils import pbc
    u = pbc.scaled_grid_coords(xt, bt, K)
    w, nearpt = bspline_weights(u.reshape(-1), order)
    grid = pme_spread.spread_plain(w.reshape(-1, 3, order),
                                   nearpt.reshape(-1, 3), qt, K)
    gx_a, gq_a = torch.autograd.grad((grid * gQ).sum(), (xt, qt))
    Q = pme_spread.charge_grid(xt, qt, bt, K, order)
    gx_k, gq_k = torch.autograd.grad((Q.reshape(-1) * gQ).sum(), (xt, qt))
    np.testing.assert_allclose(gx_k.numpy(), gx_a.numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(gq_k.numpy(), gq_a.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_gather_shared_memory_and_index_wrap():
    """Kernel B2's host-side rules: no shared memory where the order is
    compiled in (4, 6, at most K), the generic path's per-warp tables
    otherwise, a ValueError with the numbers past a block's limit; and
    base points off [0, K) wrap as the kernel's wrap_index does (the plain
    gather, which the kernel is held to, is periodic in them)."""
    assert pme_spread.gather_smem(6, 32, 8) == 0
    assert pme_spread.gather_smem(4, 16, 4) == 0
    assert pme_spread.gather_smem(5, 32, 8) == 4 * 3 * 5 * (2 * 8 + 4)
    assert pme_spread.gather_smem(6, 4, 8) == 4 * 3 * 6 * (2 * 8 + 4)
    with pytest.raises(ValueError, match=r"kernel B2 needs \d+ B of shared "
                                         r"memory at spline order 2000"):
        pme_spread.gather_smem(2000, 32, 8)
    x, q, box = _random_system(n=20, seed=7)
    K, order = 8, 5
    w, dw, nearpt = pme_spread.spline_setup(torch.tensor(x),
                                            torch.tensor(box), K, order)
    rng = np.random.default_rng(8)
    gQ = torch.tensor(rng.standard_normal(K ** 3))
    recip = torch.linalg.inv(torch.tensor(box)).T.contiguous()
    shift = torch.tensor(rng.choice([-2 * K, -K, 0, K, 3 * K], (20, 3)))
    for a, b in zip(pme_spread.gather_plain(gQ, w, dw, nearpt + shift,
                                            torch.tensor(q), recip, K),
                    pme_spread.gather_plain(gQ, w, dw, nearpt,
                                            torch.tensor(q), recip, K)):
        assert torch.equal(a, b)


def test_spread_shared_memory_and_index_wrap():
    """Kernel B1's host-side rules: no dynamic shared memory where the
    order is compiled in (4, 6, at most K), the generic path's staged
    rows, scan counts and hit lists otherwise (by the tile K picks,
    whatever n), a ValueError with the numbers past a block's limit; and
    the plain spread, which the kernel is held to, gives the same bits
    for base points moved by multiples of K (the kernel wraps them
    once).  The kernel source has no atomic operation and the wrapper no
    zero fill."""
    assert pme_spread.spread_smem(6, 32, 8) == 0
    assert pme_spread.spread_smem(4, 13, 4) == 0
    def tile(stage, width, itemsize, hit):          # spread_smem_t
        return stage * (width * itemsize + 12) + 64 * 4 + 16 * 32 * hit
    assert pme_spread.spread_smem(5, 32, 8) == tile(256, 11, 8, 16)
    assert pme_spread.spread_smem(5, 64, 8) == tile(128, 16, 8, 40)
    assert pme_spread.spread_smem(5, 200, 8) == tile(128, 16, 8, 40)
    assert pme_spread.spread_smem(6, 4, 8) == tile(256, 13, 8, 16)
    assert pme_spread.spread_smem(5, 13, 4) == tile(256, 11, 4, 12)
    assert pme_spread.spread_smem(7, 40, 4) == tile(128, 22, 4, 24)
    with pytest.raises(ValueError, match=r"kernel B1 needs \d+ B of shared "
                                         r"memory at spline order 2000"):
        pme_spread.spread_smem(2000, 4096, 8)
    # one writer per grid element: no atomic operation in the kernels'
    # code (comments stripped), and the wrapper allocates the grid without
    # a fill
    src = pathlib.Path(pme_spread.__file__).parents[2] / "csrc" / "pme_spread.cu"
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src.read_text(), flags=re.S)
    assert not re.search(r"atomic|\bred\.|\batom\.", code)
    wrapper = inspect.getsource(pme_spread.spread_cuda)
    assert "torch.empty" in wrapper and "torch.zeros" not in wrapper
    x, q, box = _random_system(n=20, seed=9)
    K, order = 8, 5
    w, _, nearpt = pme_spread.spline_setup(torch.tensor(x),
                                           torch.tensor(box), K, order)
    rng = np.random.default_rng(10)
    shift = torch.tensor(rng.choice([-2 * K, -K, 0, K, 3 * K], (20, 3)))
    assert torch.equal(
        pme_spread.spread_plain(w, nearpt + shift, torch.tensor(q), K),
        pme_spread.spread_plain(w, nearpt, torch.tensor(q), K))


def test_delta_charge_grid_matches_jax():
    x, _, box = _random_system(n=30, seed=4)
    K, order = 16, 6
    rng = np.random.default_rng(6)
    idx = np.array([3, 7, -1, 12, 20, -1, 29])
    mask = idx >= 0
    dq = rng.standard_normal(idx.shape)
    ref = jax_pme.delta_charge_grid(jnp.asarray(x), jnp.asarray(dq),
                                    jnp.asarray(idx), jnp.asarray(mask),
                                    jnp.asarray(box), K, order)
    got = pme.delta_charge_grid(torch.tensor(x), torch.tensor(dq),
                                torch.tensor(idx), torch.tensor(mask),
                                torch.tensor(box), K, order)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


def _perstate_inputs(dtype, S=5, U=12, K=16, order=6, seed=1):
    rng = np.random.default_rng(seed)
    L = 9.0
    return dict(box=np.eye(3) * L, x_u=rng.uniform(0, L, (U, 3)),
                u_mask=rng.uniform(size=U) > 0.2,
                dq=rng.standard_normal((S, U)) * 0.2,
                Q0=rng.standard_normal((K, K, K)), K=K, order=order,
                alpha=0.5, dtype=dtype)


def _perstate_jax(a, impl):
    f = a["dtype"]
    box = jnp.asarray(a["box"], f)
    K, order = a["K"], a["order"]
    cbw = jax_pme.cb_half(box, K, order, a["alpha"], dtype=f)
    F0 = jnp.fft.rfftn(jnp.asarray(a["Q0"], f))
    u_mask = jnp.asarray(a["u_mask"])
    dq = jnp.asarray(a["dq"], f)

    def run(xu):
        return jax_pme.recip_delta_perstate(xu, u_mask, dq, box, K, order,
                                            cbw, F0)

    xu = jnp.asarray(a["x_u"], f)
    try:
        jax_pme.set_perstate_impl(impl)
        e = jax.jit(run)(xu)
        g = jax.jit(jax.grad(lambda xx: jnp.sum(run(xx))))(xu)
    finally:
        jax_pme.set_perstate_impl("auto")
    return np.asarray(e), np.asarray(g)


def _perstate_port(a):
    f = torch.float64 if a["dtype"] == jnp.float64 else torch.float32
    box = torch.tensor(a["box"], dtype=f)
    K, order = a["K"], a["order"]
    cbw = pme.cb_half(box, K, order, a["alpha"], dtype=f)
    F0 = torch.fft.rfftn(torch.tensor(a["Q0"], dtype=f))
    xu = torch.tensor(a["x_u"], dtype=f, requires_grad=True)
    e = pme.recip_delta_perstate(xu, torch.tensor(a["u_mask"]),
                                 torch.tensor(a["dq"], dtype=f), box, K,
                                 order, cbw, F0)
    g, = torch.autograd.grad(e.sum(), xu)
    return e.detach().numpy(), g.numpy()


def test_perstate_matches_jax_xla_fp64():
    a = _perstate_inputs(jnp.float64)
    e_r, g_r = _perstate_jax(a, "xla")
    e, g = _perstate_port(a)
    np.testing.assert_allclose(e, e_r, rtol=1e-10,
                               atol=1e-10 * np.abs(e_r).max())
    np.testing.assert_allclose(g, g_r, rtol=1e-10,
                               atol=1e-10 * np.abs(g_r).max())


def test_perstate_matches_jax_pallas_interpret_fp32():
    a = _perstate_inputs(jnp.float32)
    e_r, g_r = _perstate_jax(a, "pallas")
    e, g = _perstate_port(a)
    # tests/test_recip_perstate.py's dispatch tolerances (the Pallas kernel
    # contracts in bf16x3 passes, the port in full fp32)
    np.testing.assert_allclose(e, e_r, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g, g_r, rtol=2e-4, atol=2e-4)



_COTANGENTS = ("ddq", "dar", "dai", "dbcr", "dbci", "df0r", "df0i")


@functools.lru_cache(maxsize=None)
def _perstate_cotangents(S=8, U=13, K=12, seed=3):
    """The seven cotangents of E . gbar from jax.vjp of the Pallas kernel
    (interpret mode, fp32) and from autograd through the port's
    perstate_plain, on the same numpy inputs (made as
    tests/test_recip_perstate.py's _inputs makes them)."""
    rng = np.random.default_rng(seed)
    Mh = K * (K // 2 + 1)
    Mp = -(-Mh // 128) * 128              # the Pallas kernel's lane padding
    f = np.float32
    dq = (rng.standard_normal((S, U)) * 0.3).astype(f)
    ar, ai = (rng.standard_normal((K, U)).astype(f) for _ in range(2))
    bcr, bci = (rng.standard_normal((U, Mh)).astype(f) for _ in range(2))
    f0r, f0i = (rng.standard_normal((K, Mh)).astype(f) for _ in range(2))
    cbw = rng.uniform(0, 1, (K, Mh)).astype(f)
    gbar = rng.standard_normal(S).astype(f)
    vals = (dq, ar, ai, bcr, bci, f0r, f0i, cbw)

    def padl(a):
        return np.pad(a, [(0, 0), (0, Mp - a.shape[1])])

    jins = [jnp.asarray(padl(v) if i >= 3 else v) for i, v in enumerate(vals)]
    _, vjp = jax.vjp(perstate_recip_energy, *jins)
    ref = [np.asarray(c)[:, :Mh] if i >= 3 else np.asarray(c)
           for i, c in enumerate(vjp(jnp.asarray(gbar))[:7])]
    leaves = [torch.tensor(v, requires_grad=i < 7) for i, v in enumerate(vals)]
    got = torch.autograd.grad(
        (recip_perstate.perstate_plain(*leaves) * torch.tensor(gbar)).sum(),
        leaves[:7])
    return ref, [g.numpy() for g in got]


@pytest.mark.parametrize("name", _COTANGENTS)
def test_perstate_cotangents_match_jax_pallas_vjp(name):
    """Each cotangent of kernel C2's contract (ddq, dA, dBC, dF0) from the
    port's plain backward against the JAX Pallas kernel's custom VJP, S = 8,
    U = 13, K = 12 (Mh = 84 of a 128-lane Mp).  Tolerance of
    tests/test_recip_perstate.py::test_gradients_match_dense: the Pallas
    kernel contracts in bf16x3 passes, the port in full fp32."""
    ref, got = _perstate_cotangents()
    i = _COTANGENTS.index(name)
    assert got[i].shape == ref[i].shape
    np.testing.assert_allclose(got[i], ref[i], rtol=2e-3,
                               atol=2e-5 * np.abs(ref[i]).max(), err_msg=name)
