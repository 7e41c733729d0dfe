"""The port's replica batch on the cell path (md/integrators.py
batched_md_scan, parallel/ensemble.py BatchedReplicaScan), as the
10,000-atom box runs it: cell-list neighbors with on-demand rows and each
replica's own rebuild decision, the candidate-row domain repulsion,
kernels A' / A'' and the slab spread D1 / D2 (their ops' batching rules
looping the plain versions on the CPU).  fp64 on the CPU, W = 2, on the
124-water + H3O+ fixture of tests/test_torch_slice_cells.py (cutoff 4.0 /
Verlet 5.0 A, PME 16^3, state cap 32: neighbor cells (3, 3, 3, 33), react
cells (4, 4, 4, 20), kernel A's cells (3, 3, 3, 32)):

  * evaluate_forces vmapped over the replicas on the cell path against
    each replica's own evaluation, to 1e-12;
  * a batched step where one replica rebuilds its neighbor list and the
    other does not, against each replica's own step;
  * the batched NVT scan (3 steps) against the in-turn ReplicaScan, to
    1e-12 A with equal generator states: the cell list alone, A' and A''
    forced (set_stencil_impl), the slab spread forced (a pme_scap);
  * a 2-window NVE cell-path ladder through make_ladder_scan against the
    JAX package's vmapped make_ladder_scan, to 1e-9 A (one XLA
    compilation, under torch_bridge.jax_compiled; the windows' initial
    forces are the port's, put into the JAX ForceEval, as
    tests/test_torch_umbrella.py does);
  * a batch started under too small a cell capacity, kernel A cell cap
    and slab cap: regrown for all and replayed, equal to a batch started
    at the grown capacities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import fixture_deck, jax_compiled, jax_tree
from test_torch_umbrella import _port_forces_as_jax
from reactive_pb_nn_md_tpu.topology import build_system as jax_build
from reactive_pb_nn_md_tpu.topology import State as JState
from reactive_pb_nn_md_tpu.md import bias as jax_bias
from reactive_pb_nn_md_tpu.md import integrators as jax_int
from reactive_pb_nn_md_tpu.parallel import umbrella as jax_umb
from reactive_pb_nn_md_tpu_torch.convert import (bias_from_numpy,
                                                 from_numpy_tree)
from reactive_pb_nn_md_tpu_torch.md import graphs, integrators, velocities
from reactive_pb_nn_md_tpu_torch.models import pme, repulsion
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_slab
from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp
from reactive_pb_nn_md_tpu_torch.parallel import ensemble, umbrella
from reactive_pb_nn_md_tpu_torch.topology import State

W, DT, N_STEPS, SEED = 2, 0.0005, 3, 5
CENTERS = np.array([-0.3, 0.3])
K_WIN, K_ROO, R_OO = 400.0, 100.0, 2.5


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    """Both packages' systems of the fixture (the port's carried across
    from the JAX one, no small tier), its cell grid and capacity, cbw and
    W velocity sets (seeds 0 .. W - 1)."""
    tmp = tmp_path_factory.mktemp("batched_cells")
    frame, ffr, topr, cfg = fixture_deck(
        tmp, 124, seed=3, cutoff=4.0, verlet_cutoff=5.0, pme_grid=16,
        extra="evb_max_states 32\n")
    jsys, jtopo = jax_build(frame, ffr, topr, cfg)
    tsys, ttopo = from_numpy_tree(jax_tree(jsys, jtopo), device="cpu")
    tsys = ensemble._no_tier(tsys)
    box = torch.tensor(frame.box)
    cells = neighbors.suggest_cells(tsys.n_atoms, frame.box,
                                    tsys.verlet_cutoff, min_atoms=1)
    assert cells[:3] == (3, 3, 3) and tsys.rs_cells[:3] == (3, 3, 3)
    assert repulsion.domain_repulsion_active(tsys, True)
    cap = neighbors.suggest_capacity(tsys.n_atoms,
                                     float(np.prod(np.diag(frame.box))),
                                     tsys.verlet_cutoff)
    cbw = pme.cb_half(box, tsys.pme_grid, tsys.spline_order,
                      tsys.alpha_sqrt)
    mobile = velocities.freeze_mask(tsys, ttopo)
    vs = [velocities.sample_velocities(torch.Generator().manual_seed(w),
                                       tsys.mass, 300.0, mobile)
          for w in range(W)]
    d = dict(frame=frame, jsys=jsys, jtopo=jtopo, tsys=tsys, ttopo=ttopo,
             box=box, x0=torch.tensor(frame.xyz), cells=cells, cap=cap,
             cbw=cbw, vs=vs)
    d["states"] = _states(d, tsys)
    return d


def _states(d, system, cap=None, cells=None):
    """The W replicas set up on the cell path under `system`."""
    return [integrators.initial_md_state(
        State(x=d["x0"], v=v, box=d["box"]), d["ttopo"], system, d["cbw"],
        cap or d["cap"], cells=cells or d["cells"]) for v in d["vs"]]


def _batch(states):
    return ensemble.ReplicaBatch(
        list(states), [ensemble.generator_state(
            "cpu", ensemble.replica_seed(SEED, w)) for w in range(W)])


def _assert_batches_equal(b, t, atol=1e-12):
    for w in range(W):
        np.testing.assert_allclose(b.states[w].state.x.numpy(),
                                   t.states[w].state.x.numpy(), rtol=0,
                                   atol=atol)
        assert torch.equal(b.generators[w], t.generators[w])


def test_vmapped_cell_path_forces_equal_each_replica(deck):
    d, system = deck, deck["tsys"]
    rng = np.random.default_rng(0)
    xs = torch.stack([d["x0"] + torch.tensor(
        rng.normal(scale=0.03, size=d["x0"].shape)) for _ in range(W)])
    ms = d["states"][0]
    box, topo, nl = d["box"], ms.topo, ms.nlist
    assert nl.celltab is not None and nl.react_tab is not None
    nls = [neighbors.rebuild_like(nl, x, box, system.verlet_cutoff)
           for x in xs]

    def one(x, nl_leaves):
        fe = integrators.evaluate_forces(
            x, box, topo, system, graphs.with_leaves(nl, iter(nl_leaves)),
            d["cbw"])
        return fe.potential, fe.force, fe.eigenvector, fe.n_states

    got = torch.func.vmap(one)(xs, [torch.stack(t) for t in zip(
        *(graphs.leaves(n) for n in nls))])
    for w in range(W):
        fe = integrators.evaluate_forces(xs[w], box, topo, system, nls[w],
                                         d["cbw"])
        assert int(got[3][w]) == int(fe.n_states) >= 2
        assert abs(float(got[0][w] - fe.potential)) <= 1e-12 * abs(
            float(fe.potential))
        np.testing.assert_allclose(got[1][w].numpy(), fe.force.numpy(),
                                   rtol=0, atol=1e-12 * float(
                                       fe.force.abs().max()))
        np.testing.assert_allclose(got[2][w].numpy(),
                                   fe.eigenvector.numpy(), rtol=0,
                                   atol=1e-12)


def test_each_replica_keeps_its_own_rebuild(deck):
    """Replica 1's list is built at positions two atoms have left by 0.6 A
    each (past the 1 A skin together): the batched step rebuilds its list
    and keeps replica 0's, as each replica's own step does."""
    d, system = deck, deck["tsys"]
    states = list(d["states"])
    nl = states[1].nlist
    ref_x = nl.ref_x.clone()
    ref_x[:2, 0] += 0.6
    states[1] = integrators.MDState(**{
        **states[1].__dict__, "nlist": neighbors.NeighborList(**{
            **nl.__dict__, "ref_x": ref_x})})
    skin = system.verlet_cutoff - system.real_space_cutoff
    assert [bool(neighbors.needs_rebuild(m.nlist, m.state.x, d["box"],
                                         skin)) for m in states] \
        == [False, True]
    out, _ = integrators.batched_scan_step(
        integrators.stack_states(states), system, d["cbw"], DT, "NVE", 0.1,
        300.0, ())
    for w, got in enumerate(integrators.unstack_states(out)):
        ref, _ = integrators.scan_step_with(states[w], system, d["cbw"], DT,
                                            "NVE", 0.1, 300.0, None)
        for a, b in zip(graphs.leaves(got), graphs.leaves(ref)):
            assert torch.equal(a, b)
    assert not torch.equal(out.nlist.ref_x[1], ref_x)
    assert torch.equal(out.nlist.ref_x[0], states[0].nlist.ref_x)


@pytest.mark.parametrize("path", ["cells", "half", "column", "slab"])
def test_batched_cell_scan_equals_in_turn(deck, path):
    d = deck
    system = d["tsys"]
    if path == "slab":
        system = system.replace(pme_scap=pme_slab.suggest_slab_cap(
            system.n_atoms, system.pme_grid))
    rsp.set_stencil_impl(path if path in ("half", "column") else "auto")
    try:
        impl = rsp._impl_for(system.rs_cells)
        assert impl == (path if path in ("half", "column") else "full")
        states = (d["states"] if path in ("half", "column", "cells")
                  else _states(d, system))
        assert not integrators.overflowed(states[0])
        runs = []
        for cls in (ensemble.ReplicaScan, ensemble.BatchedReplicaScan):
            scan = cls(system, d["cbw"], DT, "NVT", N_STEPS, friction=5.0)
            runs.append(scan(_batch(states)))
    finally:
        rsp.set_stencil_impl("auto")
    (t, td), (b, bd) = runs
    assert bd.potential.shape == (W, N_STEPS) and not bd.capacities()
    _assert_batches_equal(b, t)
    np.testing.assert_allclose(bd.potential.numpy(), td.potential.numpy(),
                               rtol=1e-12)
    assert torch.equal(bd.n_states, td.n_states)
    assert b.states[0].nlist.celltab is not None
    # distinct streams: the replicas part
    assert float((b.states[0].state.x - b.states[1].state.x).abs()
                 .max()) > 1e-6


def test_cell_ladder_matches_jax(deck, monkeypatch):
    """2 windows (window restraint + R_OO keeper) x 3 NVE steps on the
    cell path: the port's make_ladder_scan (both windows through one
    vmapped step) against the JAX package's vmapped make_ladder_scan, from
    the same positions and the JAX velocities: x to 1e-9 A, the (W, n) cv
    to 1e-9, the potential to 1e-10."""
    d = deck
    tsys, cbw, cells = d["tsys"], d["cbw"], d["cells"]
    frame = d["frame"]
    tms = d["states"][0]
    atoms = umbrella.transfer_triple(tms, tsys)
    jcbw = jnp.asarray(cbw.numpy())
    jlad = (jax_umb.make_ladder(atoms, CENTERS, K_WIN, 0, jnp.float64),
            jax_umb.make_ladder(atoms, np.full(W, R_OO), K_ROO, 1,
                                jnp.float64))
    jstate = JState(x=jnp.asarray(frame.xyz),
                    v=jnp.asarray(d["vs"][0].numpy()),
                    box=jnp.asarray(frame.box), key=jax.random.PRNGKey(0),
                    step=jnp.asarray(0, jnp.int32))
    with monkeypatch.context() as mp:
        mp.setattr(jax_int, "evaluate_forces",
                   _port_forces_as_jax(tsys, cbw, d["cap"], cells))
        mp.setattr(jax_bias, "bias_energy_force",
                   jax.jit(jax_bias.bias_energy_force))
        jms = jax_int.initial_md_state(jstate, d["jtopo"], d["jsys"], jcbw,
                                       d["cap"], cells=cells)
        jbatch = jax_umb.seeded_window_states(jms, d["jsys"], jcbw, atoms,
                                              CENTERS, r_oo=R_OO,
                                              ladder=jlad)
    assert tuple(jbatch.nlist.cells) == tuple(cells)
    tlad = bias_from_numpy(jlad, device="cpu")
    tscan = umbrella.make_ladder_scan(tsys, cbw, DT, "NVE", N_STEPS)
    tbatch = umbrella.seeded_window_states(
        tms, tscan.system, cbw, atoms, CENTERS, r_oo=R_OO, ladder=tlad,
        velocities_w=np.asarray(jbatch.state.v))
    assert tbatch.states[0].nlist.cells == cells
    tout, td = tscan(tbatch, tlad)
    with jax_compiled():
        jscan = jax_umb.make_ladder_scan(d["jsys"], jcbw, DT, "NVE",
                                         N_STEPS)
        jout, jd = jscan(jbatch, jlad)
    assert isinstance(tscan, ensemble.BatchedReplicaScan)
    assert td.cv.shape == (W, N_STEPS) and not td.capacities()
    assert not tscan.regrows and not np.asarray(jd.nbr_overflow).any()
    for w in range(W):
        np.testing.assert_allclose(tout.states[w].state.x.numpy(),
                                   np.asarray(jout.state.x[w]), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(td.cv.numpy(), np.asarray(jd.cv), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(td.potential.numpy(),
                               np.asarray(jd.potential), rtol=1e-10)
    np.testing.assert_array_equal(td.n_states.numpy(),
                                  np.asarray(jd.n_states))


def test_cell_batch_regrows_for_all_and_replays(deck):
    """A cell-path batch (the slab spread forced) set up under a neighbor
    cell capacity, a kernel A cell cap and a slab cap that do not hold
    is regrown for every replica, set up again and run: it equals the
    batch set up at the grown capacities."""
    d = deck
    nc1, nc2, nc3, ccap = d["cells"]
    system = d["tsys"].replace(rs_cells=d["tsys"].rs_cells[:3] + (16,),
                               pme_scap=16)
    small = (nc1, nc2, nc3, 16)
    states = _states(d, system, cells=small)
    assert set(integrators.overflowed(states[0])) == {
        integrators.NEIGHBOR_CAP, integrators.RS_CELL_CAP,
        integrators.SLAB_CAP}
    scan = ensemble.BatchedReplicaScan(system, d["cbw"], DT, "NVT", N_STEPS,
                                       friction=5.0)
    out, diag = scan(_batch(states))
    assert scan.n_regrows >= 1 and not diag.capacities()
    assert any("neighbor-list capacity" in ln and "kernel A cell capacity"
               in ln and "PME slab capacity" in ln for ln in scan.regrows)
    cap, cells = scan.caps[0], scan.caps[1]
    assert cells[3] > 16 and scan.system.rs_cells[3] > 16
    assert scan.system.pme_scap > 16
    ref_scan = ensemble.BatchedReplicaScan(scan.system, d["cbw"], DT, "NVT",
                                           N_STEPS, friction=5.0)
    ref, ref_diag = ref_scan(_batch(_states(d, scan.system, cap, cells)))
    assert not ref_scan.regrows
    np.testing.assert_allclose(diag.potential.numpy(),
                               ref_diag.potential.numpy(), rtol=1e-12)
    for w in range(W):
        assert out.states[w].nlist.cells == cells
    _assert_batches_equal(out, ref)
