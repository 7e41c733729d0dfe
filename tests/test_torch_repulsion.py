"""The candidate-row EVB repulsion (ms_evb_repulsion_batched_domain)
against the JAX package's on tests/test_delta_diag.py:74's setup (63
waters + H3O+, the fixture deck), fp64 on the CPU: the diabat diagonals
with the domain sweep forced on in both packages to 1e-10, and the
port's domain sweep against its dense sweep (values and gradients)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import fixture_deck
from reactive_pb_nn_md_tpu.topology import build_system as jax_build
from reactive_pb_nn_md_tpu.models import pme as jax_pme
from reactive_pb_nn_md_tpu.models import repulsion as jax_rep
from reactive_pb_nn_md_tpu.ops import neighbors as jax_nb
from reactive_pb_nn_md_tpu.evb import hamiltonian as jax_ham
from reactive_pb_nn_md_tpu.evb.enumerate import (
    enumerate_diabats as jax_enum)
from reactive_pb_nn_md_tpu.evb.topology_ops import (
    build_diabat_topologies as jax_topos)
from reactive_pb_nn_md_tpu_torch.topology import build_system
from reactive_pb_nn_md_tpu_torch.models import pme, repulsion
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
from reactive_pb_nn_md_tpu_torch.evb.enumerate import enumerate_diabats
from reactive_pb_nn_md_tpu_torch.evb.topology_ops import (
    build_diabat_topologies)


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    frame, ffr, topr, cfg = fixture_deck(tmp_path_factory.mktemp("rep"), 63,
                                         seed=11, pme_grid=12,
                                         extra="evb_max_states 32\n")
    tsys, topo = build_system(frame, ffr, topr, cfg, device="cpu")
    assert 0.0 < tsys.evb_rep_rc_max <= tsys.real_space_cutoff
    x, box = torch.tensor(frame.xyz), torch.tensor(frame.box)
    cap = neighbors.suggest_capacity(tsys.n_atoms,
                                     float(np.prod(np.diag(frame.box))),
                                     tsys.verlet_cutoff)
    nl = neighbors.build_neighbor_list(x, box, tsys.verlet_cutoff, cap)
    assert not bool(nl.overflow)
    dset = enumerate_diabats(x, box, topo, tsys)
    batch = build_diabat_topologies(topo, dset, tsys)
    n = int(dset.n_states)
    assert n > 3
    return dict(frame=frame, ffr=ffr, topr=topr, cfg=cfg, tsys=tsys,
                topo=topo, x=x, box=box, nl=nl, batch=batch, n=n, cap=cap)


def _port_diag(d, impl, x=None):
    tsys = d["tsys"]
    x = d["x"] if x is None else x
    cbw = pme.cb_half(d["box"], tsys.pme_grid, tsys.spline_order,
                      tsys.alpha_sqrt)
    try:
        repulsion.set_domain_impl(impl)
        diag, *_ = ham.diabat_diagonal_energies(
            x, d["box"], d["batch"], tsys, neighbors.neighbor_pairs(d["nl"]),
            cbw, d["topo"].charge, d["topo"], d["nl"].full_idx)
    finally:
        repulsion.set_domain_impl("auto")
    return diag


def test_domain_repulsion_matches_jax(deck):
    d = deck
    jsys, jtopo = jax_build(d["frame"], d["ffr"], d["topr"], d["cfg"])
    jx, jbox = jnp.asarray(d["frame"].xyz), jnp.asarray(d["frame"].box)
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jax_rep.set_domain_impl("on")
        nl = jax_nb.build_neighbor_list(jx, jbox, jsys.verlet_cutoff,
                                        d["cap"])
        cbw = jax_pme.cb_half(jbox, jsys.pme_grid, jsys.spline_order,
                              jsys.alpha_sqrt, dtype=jnp.float64)

        def diag(xx):
            batch = jax_topos(jtopo, jax_enum(xx, jbox, jtopo, jsys), jsys)
            return jax_ham.diabat_diagonal_energies(
                xx, jbox, batch, jsys, jax_nb.neighbor_pairs(nl), cbw,
                jtopo.charge, jtopo, nl.full_idx)[0]

        ref = jax.jit(diag)(jx)
    finally:
        jax_rep.set_domain_impl("auto")
        jax.config.update("jax_disable_most_optimizations", prev)
    n = d["n"]
    got = _port_diag(d, "on")
    np.testing.assert_allclose(got[:n].numpy(), np.asarray(ref)[:n],
                               rtol=1e-10)


def test_domain_repulsion_equals_dense_sweep(deck):
    d, n = deck, deck["n"]
    out = {}
    for impl in ("off", "on"):
        x = d["x"].clone().requires_grad_(True)
        diag = _port_diag(d, impl, x)
        g, = torch.autograd.grad(diag[:n].sum(), x)
        out[impl] = (diag.detach()[:n].numpy(), g.numpy())
    np.testing.assert_allclose(out["on"][0], out["off"][0], rtol=1e-10)
    np.testing.assert_allclose(out["on"][1], out["off"][1], rtol=1e-7,
                               atol=1e-8)
