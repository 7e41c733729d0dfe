"""Kernel D's plain version (the slab-binned spread and interpolation)
against the JAX package's charge_grid_slab in interpret mode, at the
sizes and tolerances of tests/test_pallas_pme.py:60-123, and the slab
path inside the port's MS-EVB base grid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import fixture_deck
from reactive_pb_nn_md_tpu.models import pme as jax_pme
from reactive_pb_nn_md_tpu.ops.pallas.pme_slab import (
    charge_grid_slab as jax_slab, pme_slab_overflow, suggest_slab_cap)
from reactive_pb_nn_md_tpu_torch.topology import build_system
from reactive_pb_nn_md_tpu_torch.models import pme
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_slab, pme_spread
from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham


def _random_system(n=40, L=12.0, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, L, (n, 3)), rng.uniform(-1, 1, (n,)),
            np.eye(3) * L)


@pytest.mark.parametrize("order", [4, 6])
def test_slab_grid_matches_jax(order):
    x, q, box = _random_system(n=60, seed=1)
    K = 16
    scap = pme_slab.suggest_slab_cap(60, K)
    assert scap == suggest_slab_cap(60, K)
    ref = jax.jit(jax_slab, static_argnums=(3, 4, 5))(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(box), K, order, scap)
    Q, over = pme_slab.charge_grid_slab(torch.tensor(x), torch.tensor(q),
                                        torch.tensor(box), K, order, scap)
    assert not bool(over)
    np.testing.assert_allclose(Q.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


def test_slab_energy_and_gradients_match_jax():
    x, q, box = _random_system(n=30, seed=3)
    K, order, alpha = 16, 6, 0.6
    scap = suggest_slab_cap(30, K)
    jbox = jnp.asarray(box)
    cbw = jax_pme.cb_half(jbox, K, order, alpha, dtype=jnp.float64)
    e_r, (gx_r, gq_r) = jax.jit(jax.value_and_grad(
        lambda xx, qq: jax_pme.recip_energy(
            jax_slab(xx, qq, jbox, K, order, scap), cbw),
        argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(q))
    xt = torch.tensor(x, requires_grad=True)
    qt = torch.tensor(q, requires_grad=True)
    bt = torch.tensor(box)
    Q, _ = pme.charge_grid(xt, qt, bt, K, order, scap=scap)
    e = pme.recip_energy(Q, pme.cb_half(bt, K, order, alpha))
    gx, gq = torch.autograd.grad(e, (xt, qt))
    np.testing.assert_allclose(float(e.detach()), float(e_r), rtol=1e-12)
    # test_pallas_pme.py's load-bearing tolerances: the spline-derivative
    # rows cancel, so a reduced-precision contraction would fail here
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_r), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(gq.numpy(), np.asarray(gq_r), rtol=1e-8,
                               atol=1e-10)


def test_slab_plain_versions_match_kernel_b_plain():
    """D1/D2's plain versions over the slab rows equal B's over the atoms
    (the function the kernels compute), including the dump row."""
    x, q, box = _random_system(n=48, L=10.0, seed=5)
    K, order = 8, 6
    xt, qt, bt = torch.tensor(x), torch.tensor(q), torch.tensor(box)
    w, dw, nearpt = pme_spread.spline_setup(xt, bt, K, order)
    c1 = np.mod(nearpt[:, 0].numpy() - (order - 1), K)
    tight = int(np.bincount(c1, minlength=K).max())
    slot, rows, over = pme_slab.slab_bins(nearpt, K, order, tight)
    assert not bool(over)
    assert sorted(rows[rows >= 0].tolist()) == list(range(48))
    np.testing.assert_allclose(
        pme_slab.spread_slab_plain(w, nearpt, qt, rows, K).numpy(),
        pme_spread.spread_plain(w, nearpt, qt, K).numpy(), rtol=1e-12,
        atol=1e-14)
    gQ = torch.tensor(np.random.default_rng(2).standard_normal(K ** 3))
    out = pme_slab.interp_slab_plain(gQ, w, dw, nearpt, rows, K)
    gq, s = pme_spread.contract_plain(gQ, w, dw, nearpt, K)
    np.testing.assert_allclose(out[slot].numpy(),
                               torch.cat([gq[:, None], s], 1).numpy(),
                               rtol=1e-12, atol=1e-14)
    assert bool(out[rows < 0].eq(0).all())
    # one row short of the fullest slab: flagged, and an atom is in no row
    slot, rows, over = pme_slab.slab_bins(nearpt, K, order, tight - 1)
    assert bool(over) and int((rows >= 0).sum()) < 48


def test_slab_overflow_flagged_as_jax():
    """All atoms piled into one slab overflow a mean-sized capacity
    (tests/test_pallas_pme.py:113-123); a uniform box does not."""
    rng = np.random.default_rng(7)
    n, K, L = 64, 16, 12.0
    x = np.concatenate([rng.uniform(0, 0.3, (n, 1)),
                        rng.uniform(0, L, (n, 2))], axis=1)
    x_u = rng.uniform(0, L, (n, 3))
    box = np.eye(3) * L
    q = torch.tensor(rng.uniform(-1, 1, n))
    for xx, scap, want in ((x, 8, True),
                           (x_u, suggest_slab_cap(n, K), False)):
        assert bool(pme_slab_overflow(jnp.asarray(xx), jnp.asarray(box), K,
                                      6, scap)) == want
        _, over = pme.charge_grid(torch.tensor(xx), q, torch.tensor(box), K,
                                  6, scap=scap)
        assert bool(over) == want


def test_evb_base_grid_takes_the_slab_path(tmp_path):
    """The MS-EVB evaluation with a slab cap gives the per-atom spread's
    energies and forces, and reports the slab flag in its breakdown."""
    frame, ffr, topr, cfg = fixture_deck(tmp_path, 8, seed=1, pme_grid=12,
                                         extra="evb_max_states 16\n")
    tsys, topo = build_system(frame, ffr, topr, cfg, device="cpu")
    assert tsys.pme_scap == 0
    x, box = torch.tensor(frame.xyz), torch.tensor(frame.box)
    nl = neighbors.build_neighbor_list(x, box, tsys.verlet_cutoff,
                                       tsys.n_atoms - 1)
    cbw = pme.cb_half(box, tsys.pme_grid, tsys.spline_order, tsys.alpha_sqrt)
    out = {}
    for scap in (0, 8, 32):
        res, _ = ham.adiabatic_energy_force(
            x, box, topo, tsys.replace(pme_scap=scap),
            neighbors.neighbor_pairs(nl), cbw, nl.full_idx)
        out[scap] = res
    for scap, want in ((0, False), (8, True), (32, False)):
        assert bool(out[scap].breakdown.slab_overflow) == want
    ref, got = out[0], out[32]
    np.testing.assert_allclose(float(got.energy), float(ref.energy),
                               rtol=1e-12)
    np.testing.assert_allclose(got.force.numpy(), ref.force.numpy(),
                               rtol=1e-10,
                               atol=1e-10 * float(ref.force.abs().max()))


@pytest.mark.parametrize("clumped", [False, True])
def test_slab_rows_ascend_in_y_corner(clumped):
    """slab_bins keeps each slab's atoms in ascending y corner (kernel D
    finds a band's atoms by that order), then -1 rows; an atom past its
    slab's capacity goes to the dump row, and the overflow flag is the JAX
    package's pme_slab_overflow."""
    rng = np.random.default_rng(9)
    n, K, L, order = 300, 16, 12.0, 6
    x = rng.uniform(0, L, (n, 3))
    if clumped:
        x[:60, 0] = rng.uniform(0, 0.3, 60)
    box = np.eye(3) * L
    w, dw, nearpt = pme_spread.spline_setup(torch.tensor(x),
                                            torch.tensor(box), K, order)
    c1 = np.mod(nearpt[:, 0].numpy() - (order - 1), K)
    c2 = np.mod(nearpt[:, 1].numpy() - (order - 1), K)
    counts = np.bincount(c1, minlength=K)
    scap = suggest_slab_cap(n, K)
    slot, rows, over = pme_slab.slab_bins(nearpt, K, order, scap)
    assert bool(over) == clumped == bool(pme_slab_overflow(
        jnp.asarray(x), jnp.asarray(box), K, order, scap))
    slot, rows = slot.numpy(), rows.numpy().reshape(K, scap)
    for b in range(K):
        held = min(counts[b], scap)
        atoms = rows[b, :held]
        assert (atoms >= 0).all() and (rows[b, held:] == -1).all()
        assert (c1[atoms] == b).all()
        assert (np.diff(c2[atoms]) >= 0).all()
        assert (slot[atoms] == b * scap + np.arange(held)).all()
    dumped = slot == K * scap
    assert dumped.sum() == np.maximum(counts - scap, 0).sum()
    assert sorted(rows[rows >= 0].tolist() + np.flatnonzero(dumped)
                  .tolist()) == list(range(n))


def test_kernel_d_shared_memory_does_not_grow_with_scap():
    """D1's and D2's shared memory is a function of K, the order and the
    dtype (no scap argument): at the 10k deck's K = 64 in fp64 four blocks
    of each fit an SM, and every K the slab path takes (K + order - 1 <=
    128) fits one."""
    for order in (4, 6):
        for itemsize in (4, 8):
            for K in range(order, 129 - order + 1):
                assert pme_slab.spread_smem(K, order, itemsize) \
                    <= pme_slab.SMEM_LIMIT
                assert pme_slab.interp_smem(K, order, itemsize) \
                    <= pme_slab.SMEM_LIMIT
    per_block = pme_slab.SMEM_LIMIT // 4 - 1024     # 1 KB reserved a block
    assert pme_slab.spread_smem(64, 6, 8) <= per_block
    assert pme_slab.interp_smem(64, 6, 8) <= per_block
