"""The umbrella-sampling path of the port (md/bias.py, the bias in md_step
and md_scan, parallel/ensemble.py, parallel/umbrella.py, analysis/wham.py,
run/umbrella_pmf.py) against the JAX package, fp64 on the CPU, on the
28-atom reactive fixture of tests/test_umbrella.py (8 waters + H3O+, PME
12^3, state cap 12):

  * collective_variable, bias_energy and bias_energy_force, both CV types
    and a tuple, against the JAX functions to 1e-12; finite differences,
    the hand-built geometry and its minimum image;
  * transfer_triple (equal indices) and seeded_window_states (positions to
    1e-12), the JAX ladder carried across by convert.bias_from_numpy;
  * a 2-window NVE ladder (window restraint + R_OO keeper), the port's
    make_ladder_scan (the windows batched through one vmapped step)
    against the JAX package's vmapped one, from the same positions and
    the JAX velocities: x to 1e-9 A, the (W, n) cv to 1e-9, the potential
    (bias included) to 1e-10, and against the windows in turn
    (ReplicaScan) to 1e-12 A; window 0 through the port's md_scan
    against it too, and against a loop of md_step;
  * wham, wham_bootstrap and barrier_height against the JAX functions to
    1e-10, and a smaller copy of the double-well recovery test;
  * on the port alone: NVT replicas (diverge with distinct generator
    states, equal bit for bit with one), a ladder started under a
    too-small capacity (regrown: its CV series equals a ladder started
    at the grown capacity), the two guards the JAX package lacks
    (off-diagonal box, non-uniform keeper), no host sync in a biased
    scan step, and run_pmf / the CLI end to end on a 22-atom deck.

The JAX side makes one XLA compilation, the vmapped ladder scan (under
torch_bridge.jax_compiled).  The windows' initial forces on the JAX side
are the port's evaluation at the same positions, put into the JAX
package's ForceEval (the JAX initial_md_state adds the restraint itself):
compiling the JAX force evaluation a second time would double the
file's time, and that evaluation is held against the port elsewhere
(tests/test_torch_slice.py).  Every step after it is the JAX package's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_water_box, write_fixture_files
from torch_bridge import jax_compiled, jax_tree
from test_torch_scan import _HostSyncs, _HostTensors
from reactive_pb_nn_md_tpu.io.ffpmt import read_ffpmt
from reactive_pb_nn_md_tpu.io.simpmt import read_sim_params
from reactive_pb_nn_md_tpu.io.topfile import read_top
from reactive_pb_nn_md_tpu.topology import (build_system as jax_build,
                                            State as JState)
from reactive_pb_nn_md_tpu.models import total as jax_total
from reactive_pb_nn_md_tpu.md import integrators as jax_int
from reactive_pb_nn_md_tpu.md import velocities as jax_vel
from reactive_pb_nn_md_tpu.md import bias as jax_bias
from reactive_pb_nn_md_tpu.parallel import umbrella as jax_umb
from reactive_pb_nn_md_tpu.analysis import wham as jax_wham
from reactive_pb_nn_md_tpu_torch.analysis import wham
from reactive_pb_nn_md_tpu_torch.convert import (bias_from_numpy,
                                                 from_numpy_tree)
from reactive_pb_nn_md_tpu_torch.io.simpmt import (
    read_sim_params as port_sim_params)
from reactive_pb_nn_md_tpu_torch.md import bias, graphs, integrators
from reactive_pb_nn_md_tpu_torch.models import pme
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.parallel import ensemble, umbrella
from reactive_pb_nn_md_tpu_torch.run import umbrella_pmf
from reactive_pb_nn_md_tpu_torch.topology import State, Topology
from reactive_pb_nn_md_tpu_torch.utils.constants import KB

DT = 0.0005
CENTERS = np.array([-0.3, 0.3])
K_WIN, K_ROO, R_OO = 400.0, 100.0, 2.5
N_STEPS = 3
BD_FIELDS = ("total", "elec", "vdw", "bond", "angle", "dihedral")


def _to_port_topo(topo):
    return Topology(**{f.name: torch.tensor(np.asarray(
        getattr(topo, f.name)).astype(
            np.float64 if f.name == "charge" else np.int64))
        for f in dataclasses.fields(Topology)})


def _port_forces_as_jax(tsys, tcbw, cap, cells=None):
    """A stand-in for the JAX package's evaluate_forces: the port's
    evaluation at the same positions and topology (its neighbor lists on
    the cell grid `cells` when given), in the JAX ForceEval layout (see
    the module docstring)."""
    def evaluate(x, box, topo, system, nlist, cbw, com=None):
        tx, tb = torch.tensor(np.asarray(x)), torch.tensor(np.asarray(box))
        ttopo = _to_port_topo(topo)
        tnl = neighbors.build_neighbors(
            tx, tb, **integrators.neighbor_plan(tsys, tb, cap, cells))
        fe = integrators.evaluate_forces(tx, tb, ttopo, tsys, tnl, tcbw)

        def j(t, dtype=None):
            return jnp.asarray(t.numpy(), dtype)

        return jax_int.ForceEval(
            potential=j(fe.potential),
            breakdown=jax_total.EnergyBreakdown(**{
                k: j(getattr(fe.breakdown, k)) for k in BD_FIELDS}),
            force=j(fe.force),
            topo=topo.replace(**{
                f.name: j(getattr(fe.topo, f.name),
                          getattr(topo, f.name).dtype)
                for f in dataclasses.fields(Topology)}),
            n_states=j(fe.n_states, jnp.int32),
            eigenvector=j(fe.eigenvector),
            hopped=j(fe.topo.hydronium_mol != ttopo.hydronium_mol),
            evb_overflow=j(fe.evb_overflow),
            hydronium_of=j(fe.hydronium_of, jnp.int32),
            n_hops_of=j(fe.n_hops_of, jnp.int32),
            row_overflow=j(fe.row_overflow))
    return evaluate


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    """Both packages' systems of the fixture, the JAX and port start
    states (the JAX velocities of tests/test_umbrella.py), the seeded
    2-window batches of both and their first ladder chunk."""
    tmp = tmp_path_factory.mktemp("umbrella")
    ff_p, top_p, sim_p = write_fixture_files(
        tmp, msevb="yes", pme_grid=12, extra="evb_max_states 12\n")
    frame = make_water_box(8, include_h3o=True, seed=1)
    jsys, jtopo = jax_build(frame, read_ffpmt(ff_p), read_top(top_p),
                            read_sim_params(sim_p))
    tsys, ttopo = from_numpy_tree(jax_tree(jsys, jtopo), device="cpu")
    tbox = torch.tensor(frame.box)
    tcbw = pme.cb_half(tbox, tsys.pme_grid, tsys.spline_order,
                       tsys.alpha_sqrt)
    cbw = jnp.asarray(tcbw.numpy())
    cap = neighbors.suggest_capacity(tsys.n_atoms,
                                     float(np.prod(np.diag(frame.box))),
                                     tsys.verlet_cutoff)
    key, vkey = jax.random.split(jax.random.PRNGKey(0))
    v = jax_vel.sample_velocities(vkey, jsys.mass, 300.0,
                                  jax_vel.freeze_mask(jsys, jtopo))
    jstate = JState(x=jnp.asarray(frame.xyz), v=v,
                    box=jnp.asarray(frame.box), key=key,
                    step=jnp.asarray(0, jnp.int32))
    tms = integrators.initial_md_state(
        State(x=torch.tensor(frame.xyz), v=torch.tensor(np.asarray(v)),
              box=tbox), ttopo, tsys, tcbw, cap)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_int, "evaluate_forces",
                   _port_forces_as_jax(tsys, tcbw, cap))
        # the restraint compiled once for both windows (eager, each of
        # its ops would compile on its own)
        mp.setattr(jax_bias, "bias_energy_force",
                   jax.jit(jax_bias.bias_energy_force))
        jms = jax_int.initial_md_state(jstate, jtopo, jsys, cbw, cap)
        atoms = jax_umb.transfer_triple(jms, jsys)
        jlad = (jax_umb.make_ladder(atoms, CENTERS, K_WIN, 0, jnp.float64),
                jax_umb.make_ladder(atoms, np.full(2, R_OO), K_ROO, 1,
                                    jnp.float64))
        jbatch = jax_umb.seeded_window_states(jms, jsys, cbw, atoms,
                                              CENTERS, r_oo=R_OO,
                                              ladder=jlad)
    tatoms = umbrella.transfer_triple(tms, tsys)
    tlad = bias_from_numpy(jlad, device="cpu")
    tscan = umbrella.make_ladder_scan(tsys, tcbw, DT, "NVE", N_STEPS)
    tbatch = umbrella.seeded_window_states(
        tms, tscan.system, tcbw, tatoms, CENTERS, r_oo=R_OO, ladder=tlad,
        velocities_w=np.asarray(jbatch.state.v))
    tout, tdiag = tscan(tbatch, tlad)
    # the reference the batched ladder is held against: windows in turn
    turn_out, turn_diag = ensemble.ReplicaScan(tsys, tcbw, DT, "NVE",
                                               N_STEPS)(tbatch, tlad)
    with jax_compiled():
        jscan = jax_umb.make_ladder_scan(jsys, cbw, DT, "NVE", N_STEPS)
        jout, jdiag = jscan(jbatch, jlad)
    return dict(tsys=tsys, tcfg=port_sim_params(sim_p), tcbw=tcbw,
                tms=tms, atoms=atoms, tatoms=tatoms, tlad=tlad,
                jbatch=jbatch, tbatch=tbatch, tscan=tscan, tout=tout,
                tdiag=tdiag, jout=jout, jdiag=jdiag, turn_out=turn_out,
                turn_diag=turn_diag)


# ---- the restraint

def _jax_and_port(atoms, k, center, cv_type):
    jb = jax_bias.HarmonicBias(atoms=jnp.asarray(atoms, jnp.int32),
                               k=jnp.asarray(k), center=jnp.asarray(center),
                               cv_type=cv_type)
    return jb, bias_from_numpy(jb, device="cpu")


@pytest.mark.parametrize("cv_type", [0, 1])
def test_bias_matches_jax(cv_type):
    rng = np.random.default_rng(7)
    x = rng.uniform(0.0, 6.0, (12, 3))
    box = np.eye(3) * 6.2
    jb, tb = _jax_and_port([3, 9, 4], 120.0, 0.3, cv_type)
    assert tb.atoms.dtype == torch.int64 and tb.cv_type == cv_type
    jx, tx = jnp.asarray(x), torch.tensor(x)
    jbox, tbox = jnp.asarray(box), torch.tensor(box)
    np.testing.assert_allclose(
        float(bias.collective_variable(tx, tbox, tb)),
        float(jax.jit(jax_bias.collective_variable)(jx, jbox, jb)), rtol=0,
        atol=1e-12)
    e, f = bias.bias_energy_force(tx, tbox, tb)
    je, jf = jax.jit(jax_bias.bias_energy_force)(jx, jbox, jb)
    np.testing.assert_allclose(float(e), float(je), rtol=0, atol=1e-12)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-12)
    assert float(bias.bias_energy(tx, tbox, tb)) == float(e)
    # finite differences (tests/test_umbrella.py's check)
    h = 1e-6
    for i, d in [(3, 0), (9, 2), (4, 1), (0, 0)]:
        xp, xm = tx.clone(), tx.clone()
        xp[i, d] += h
        xm[i, d] -= h
        fd = -(float(bias.bias_energy(xp, tbox, tb))
               - float(bias.bias_energy(xm, tbox, tb))) / (2 * h)
        np.testing.assert_allclose(float(f[i, d]), fd, rtol=2e-5, atol=1e-7)
    mask = np.ones(12, bool)
    mask[[3, 9, 4]] = False
    assert np.abs(f.numpy()[mask]).max() == 0.0


def test_bias_tuple_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.uniform(0.0, 6.0, (10, 3))
    box = np.eye(3) * 6.5
    jb0, tb0 = _jax_and_port([1, 5, 8], 200.0, -0.2, 0)
    jb1, tb1 = _jax_and_port([1, 5, 8], 80.0, 2.5, 1)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    jbox, tbox = jnp.asarray(box), torch.tensor(box)
    e, f = bias.bias_energy_force(tx, tbox, (tb0, tb1))
    je, jf = jax.jit(jax_bias.bias_energy_force)(jx, jbox, (jb0, jb1))
    np.testing.assert_allclose(float(e), float(je), rtol=0, atol=1e-12)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-12)
    e0, f0 = bias.bias_energy_force(tx, tbox, tb0)
    e1, f1 = bias.bias_energy_force(tx, tbox, tb1)
    np.testing.assert_allclose(float(e), float(e0) + float(e1), rtol=1e-12)
    np.testing.assert_allclose(f.numpy(), (f0 + f1).numpy(), atol=1e-12)
    assert float(bias.primary_cv(tx, tbox, (tb0, tb1))) == float(
        bias.collective_variable(tx, tbox, tb0))
    # the graph key takes a restraint's structure, never its values
    k2 = dataclasses.replace(tb0, k=tb0.k * 2.0)
    assert graphs.signature((tb0, tb1)) == graphs.signature((k2, tb1)) != \
        graphs.signature((tb1, tb0))


def test_cv_values_match_geometry():
    """The CVs of a hand-built configuration, and the minimum image."""
    x = np.zeros((5, 3))
    x[0] = [1.0, 1.0, 1.0]          # donor O
    x[1] = [3.4, 1.0, 1.0]          # acceptor O -> R_OO = 2.4
    x[2] = [2.0, 1.0, 1.0]          # H: 1.0 from donor, 1.4 from acceptor
    box = torch.eye(3, dtype=torch.float64) * 12.0
    _, b0 = _jax_and_port([0, 1, 2], 1.0, 0.0, 0)
    b1 = dataclasses.replace(b0, cv_type=1)
    tx = torch.tensor(x)
    np.testing.assert_allclose(float(bias.collective_variable(tx, box, b0)),
                               -0.4, atol=1e-12)
    np.testing.assert_allclose(float(bias.collective_variable(tx, box, b1)),
                               2.4, atol=1e-12)
    x2 = x.copy()
    x2[1, 0] += 12.0
    np.testing.assert_allclose(
        float(bias.collective_variable(torch.tensor(x2), box, b1)), 2.4,
        atol=1e-9)
    with pytest.raises(ValueError, match="cv_type"):
        bias.collective_variable(tx, box, dataclasses.replace(b0, cv_type=2))


# ---- the ladder against the JAX package

def test_transfer_triple_and_seeded_states_match_jax(deck):
    np.testing.assert_array_equal(deck["tatoms"], np.asarray(deck["atoms"]))
    jb, tb = deck["jbatch"], deck["tbatch"]
    assert len(tb) == 2
    for w in range(2):
        ms = tb.states[w]
        np.testing.assert_allclose(ms.state.x.numpy(),
                                   np.asarray(jb.state.x[w]), rtol=0,
                                   atol=1e-12)
        # the initial force includes the restraint (JAX: its own add)
        np.testing.assert_allclose(ms.force.numpy(), np.asarray(jb.force[w]),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(float(ms.potential),
                                   float(jb.potential[w]), rtol=1e-12)
        cv = float(bias.primary_cv(ms.state.x, ms.state.box,
                                   ensemble.window_bias(deck["tlad"], w)))
        np.testing.assert_allclose(cv, CENTERS[w], atol=1e-12)
    # distinct noise streams, from the seed
    assert not torch.equal(tb.generators[0], tb.generators[1])


def test_ladder_scan_matches_jax(deck):
    tout, td, jout, jd = (deck["tout"], deck["tdiag"], deck["jout"],
                          deck["jdiag"])
    assert td.cv.shape == (2, N_STEPS)
    assert not td.capacities() and not deck["tscan"].regrows
    assert not np.asarray(jd.evb_overflow).any()
    assert not np.asarray(jd.nbr_overflow).any()
    for w in range(2):
        np.testing.assert_allclose(tout.states[w].state.x.numpy(),
                                   np.asarray(jout.state.x[w]), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(td.cv.numpy(), np.asarray(jd.cv), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(td.potential.numpy(),
                               np.asarray(jd.potential), rtol=1e-10)
    np.testing.assert_array_equal(td.n_states.numpy(),
                                  np.asarray(jd.n_states))
    assert float(td.cv[0].mean()) < 0.0 < float(td.cv[1].mean())


def test_batched_ladder_matches_jax_and_in_turn(deck):
    """The batched ladder (make_ladder_scan: both windows through one
    vmapped step) against the JAX package's vmapped make_ladder_scan (x to
    1e-9 A, the (W, n) cv to 1e-9, the potential to 1e-10) and against
    the same windows in turn (ReplicaScan) to 1e-12 A."""
    tscan, tout, td = deck["tscan"], deck["tout"], deck["tdiag"]
    jout, jd = deck["jout"], deck["jdiag"]
    assert isinstance(tscan, ensemble.BatchedReplicaScan)
    assert td.cv.shape == (2, N_STEPS) and not td.capacities()
    for w in range(2):
        np.testing.assert_allclose(tout.states[w].state.x.numpy(),
                                   np.asarray(jout.state.x[w]), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(
            tout.states[w].state.x.numpy(),
            deck["turn_out"].states[w].state.x.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(td.cv.numpy(), np.asarray(jd.cv), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(td.potential.numpy(),
                               np.asarray(jd.potential), rtol=1e-10)
    np.testing.assert_allclose(td.cv.numpy(), deck["turn_diag"].cv.numpy(),
                               rtol=0, atol=1e-12)


def test_biased_md_scan_matches_jax_and_md_step(deck):
    """Window 0 through md_scan: the JAX ladder's window 0 (its vmapped
    md_scan), and a loop of md_step under the same restraint."""
    tsys, tcbw = deck["tscan"].system, deck["tcbw"]
    b0 = ensemble.window_bias(deck["tlad"], 0)
    ms0 = deck["tbatch"].states[0]
    ms, diag = integrators.md_scan(ms0, tsys, tcbw, DT, "NVE", N_STEPS,
                                   bias=b0)
    jout, jd = deck["jout"], deck["jdiag"]
    np.testing.assert_allclose(ms.state.x.numpy(), np.asarray(jout.state.x[0]),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(diag.potential.numpy(),
                               np.asarray(jd.potential[0]), rtol=1e-10)
    np.testing.assert_allclose(diag.cv.numpy(), np.asarray(jd.cv[0]),
                               rtol=0, atol=1e-9)
    ref = ms0
    for _ in range(N_STEPS):
        ref = integrators.md_step(ref, tsys, tcbw, DT, "NVE", bias=b0)
    for a, b in zip(graphs.leaves(ms), graphs.leaves(ref)):
        assert torch.equal(a, b)
    # the potential holds the restraint energy, the breakdown does not
    be = float(bias.bias_energy(ref.state.x, ref.state.box, b0))
    fe = integrators.evaluate_forces(ref.state.x, ref.state.box, ref.topo,
                                     tsys, ref.nlist, tcbw)
    assert be > 0.0
    np.testing.assert_allclose(float(ref.potential), float(fe.potential) + be,
                               rtol=1e-12)
    np.testing.assert_allclose(float(ref.breakdown.total),
                               float(fe.breakdown.total), rtol=1e-12)
    # unbiased, the cv column is 0
    _, d = integrators.md_scan(ms0, tsys, tcbw, DT, "NVE", 1)
    assert float(d.cv[0]) == 0.0


# ---- WHAM

def _synthetic_ladder(n_samples, n_windows, seed):
    """Exact samples of each window's biased density on a double well of
    a 5.8 kT barrier (tests/test_umbrella.py's construction)."""
    rng = np.random.default_rng(seed)
    kT = KB * 300.0
    b = 0.6
    a = 5.8 * kT / b ** 4
    k_spring = 100.0 * kT
    centers = np.linspace(-0.9, 0.9, n_windows)
    grid = np.linspace(-1.4, 1.4, 4001)
    series = []
    for c in centers:
        w = np.exp(-(a * (grid ** 2 - b ** 2) ** 2
                     + 0.5 * k_spring * (grid - c) ** 2) / kT)
        cdf = np.cumsum(w)
        cdf /= cdf[-1]
        series.append(np.interp(rng.random(n_samples), cdf, grid))
    return series, centers, k_spring, (lambda xi: a * (xi ** 2 - b ** 2) ** 2)


def test_wham_matches_jax():
    series, centers, k, _ = _synthetic_ladder(2000, 11, 5)
    kw = dict(n_bins=41, bin_range=(-1.0, 1.0))
    got = wham.wham(series, centers, k, 300.0, **kw)
    want = jax_wham.wham(series, centers, k, 300.0, **kw)
    assert got["converged"] and want["converged"]
    assert got["n_iter"] == want["n_iter"]
    np.testing.assert_allclose(got["f_i"], want["f_i"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["pmf"], want["pmf"], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got["counts"], want["counts"])
    res, std = wham.wham_bootstrap(series, centers, k, 300.0, n_boot=3,
                                   seed=4, n_bins=41)
    jres, jstd = jax_wham.wham_bootstrap(series, centers, k, 300.0,
                                         n_boot=3, seed=4, n_bins=41)
    np.testing.assert_allclose(res["pmf"], jres["pmf"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(std, jstd, rtol=0, atol=1e-10)
    assert wham.barrier_height(got["bin_centers"], got["pmf"]) == \
        jax_wham.barrier_height(want["bin_centers"], want["pmf"])
    assert all(np.isnan(v) for v in wham.barrier_height(
        got["bin_centers"], got["pmf"], split=5.0))


def test_wham_recovers_double_well():
    """tests/test_umbrella.py's recovery test at a quarter of its samples:
    the PMF within 0.25 kT where sampled, the barrier within 0.35 kT."""
    series, centers, k, u0 = _synthetic_ladder(10000, 19, 3)
    kT = KB * 300.0
    res = wham.wham(series, centers, k, 300.0, n_bins=81,
                    bin_range=(-1.0, 1.0))
    assert res["converged"]
    mids, pmf = res["bin_centers"], res["pmf"]
    ok = np.isfinite(pmf) & (res["counts"].sum(axis=0) >= 100)
    assert ok.sum() > 60
    ref = u0(mids)
    err = np.abs((pmf[ok] - pmf[ok].min()) - (ref[ok] - ref[ok].min()))
    assert err.max() < 0.25 * kT, err.max() / kT
    barrier, xi_b, _, _ = wham.barrier_height(mids, pmf)
    assert abs(barrier - 5.8 * kT) < 0.35 * kT and abs(xi_b) < 0.1


# ---- the port alone

def test_replicas_diverge_and_repeat(deck):
    """Three NVT replicas of one state: replicas 0 and 1 from distinct
    generator states part; replica 2, given replica 0's generator state,
    is equal to it bit for bit, and its generator ends in the same state."""
    tms, tsys, tcbw = deck["tms"], deck["tsys"], deck["tcbw"]
    batch = ensemble.stack_replicas(tms, 3, seed=5)
    batch.generators[2] = batch.generators[0].clone()
    scan = ensemble.make_replica_scan(tsys, tcbw, DT, "NVT", 2,
                                      friction=5.0)
    assert scan.system.evb_small_states == 0
    out, diag = scan(batch)
    assert diag.potential.shape == (3, 2) and not diag.capacities()
    x = [m.state.x for m in out.states]
    assert float((x[0] - x[1]).abs().max()) > 1e-6
    for a, b in zip(graphs.leaves(out.states[0]),
                    graphs.leaves(out.states[2])):
        assert torch.equal(a, b)
    assert torch.equal(out.generators[0], out.generators[2])
    assert not torch.equal(out.generators[0], batch.generators[0])


def test_ladder_regrows_a_small_capacity(deck):
    """A ladder whose windows start under too small a neighbor capacity is
    regrown (a regrow line, overflow in sample_ladder's info) and equals,
    to 1e-9, a ladder started at the grown capacity."""
    tms, tsys, tcbw = deck["tms"], deck["tsys"], deck["tcbw"]
    tatoms, tlad = deck["tatoms"], deck["tlad"]
    v = np.asarray(deck["jbatch"].state.v)

    def ladder(cap):
        ms = dataclasses.replace(tms, nlist=dataclasses.replace(
            tms.nlist, capacity=cap))
        scan = umbrella.make_ladder_scan(tsys, tcbw, DT, "NVT", 2,
                                         friction=5.0)
        batch = umbrella.seeded_window_states(
            ms, scan.system, tcbw, tatoms, CENTERS, r_oo=R_OO, seed=3,
            ladder=tlad, velocities_w=v)
        batch, cv, info = umbrella.sample_ladder(scan, batch, tlad, 0, 2, 2)
        return scan, batch, cv, info

    small, _, cv_small, info = ladder(6)
    assert small.regrows and info["overflow"]
    assert "neighbor-list capacity" in small.regrows[0]
    grown = small.caps[0]
    assert grown > 6
    big, _, cv_big, info_big = ladder(grown)
    assert not big.regrows and not info_big["overflow"]
    assert cv_small.shape == (2, 2)
    np.testing.assert_allclose(cv_small, cv_big, rtol=0, atol=1e-9)


def test_ladder_replays_a_chunk_that_overflowed(deck, monkeypatch):
    """A capacity flag raised in window 1's row of the batch's chunk (set
    by hand in its diagnostics: the fixture's rows cannot outgrow their
    cap) regrows every window, sets each up again from its chunk-start
    state, restores its generator state and replays the chunk, the
    windows together (one md_scan of the stacked batch each time): the
    NVT result equals a run that never overflowed."""
    tsys, tcbw, tlad = deck["tsys"], deck["tcbw"], deck["tlad"]
    batch = ensemble.ReplicaBatch(list(deck["tbatch"].states),
                                  [ensemble.generator_state(
                                      "cpu", ensemble.replica_seed(9, w))
                                   for w in range(2)])
    ref_scan = umbrella.make_ladder_scan(tsys, tcbw, DT, "NVT", 2,
                                         friction=5.0)
    ref, ref_diag = ref_scan(batch, tlad)
    md_scan, calls = integrators.md_scan, []

    def flagged(*args, **kw):
        ms, diag = md_scan(*args, **kw)
        calls.append(len(calls))
        if len(calls) == 1:
            diag.neighbor_overflow[1] = True
        return ms, diag

    monkeypatch.setattr(integrators, "md_scan", flagged)
    scan = umbrella.make_ladder_scan(tsys, tcbw, DT, "NVT", 2, friction=5.0)
    out, diag = scan(batch, tlad)
    assert len(calls) == 2 and len(scan.regrows) == 1
    assert "regrow (neighbor-list capacity exceeded)" in scan.regrows[0]
    assert scan.regrows[0].endswith("chunk replayed\n")
    assert not diag.capacities()
    np.testing.assert_allclose(diag.cv.numpy(), ref_diag.cv.numpy(), rtol=0,
                               atol=1e-9)
    for w in range(2):
        np.testing.assert_allclose(out.states[w].state.x.numpy(),
                                   ref.states[w].state.x.numpy(), rtol=0,
                                   atol=1e-9)
        assert torch.equal(out.generators[w], ref.generators[w])


def test_chunk_longer_than_max_chunk_runs_in_pieces(deck, monkeypatch):
    """A replica chunk longer than MAX_CHUNK (run_pmf's 250 steps on the
    card) runs as md_scan pieces of at most MAX_CHUNK, each of the whole
    batch: with MAX_CHUNK 2, 5 NVT steps are pieces 2 + 2 + 1 and equal
    one piece of 5."""
    tsys, tcbw, tlad = deck["tsys"], deck["tcbw"], deck["tlad"]
    batch = deck["tbatch"]
    runs, pieces = [], []
    md_scan = integrators.md_scan

    def counted(*args, **kw):
        pieces.append(args[5])
        return md_scan(*args, **kw)

    monkeypatch.setattr(integrators, "md_scan", counted)
    for max_chunk in (integrators.MAX_CHUNK, 2):
        monkeypatch.setattr(integrators, "MAX_CHUNK", max_chunk)
        scan = umbrella.make_ladder_scan(tsys, tcbw, DT, "NVT", 5,
                                         friction=5.0)
        runs.append(scan(batch, tlad))
    assert pieces == [5, 2, 2, 1]
    (a, da), (b, db) = runs
    assert db.cv.shape == (2, 5)
    for f in dataclasses.fields(integrators.ChunkDiagnostics):
        assert torch.equal(getattr(da, f.name), getattr(db, f.name)), f.name
    for w in range(2):
        assert torch.equal(a.states[w].state.x, b.states[w].state.x)
        assert torch.equal(a.generators[w], b.generators[w])


def test_guards_the_jax_package_lacks(deck):
    """An off-diagonal box is refused by transfer_triple and
    seeded_window_states; a keeper that differs between windows by
    run_pmf, before any step."""
    tms, tsys, tcbw = deck["tms"], deck["tsys"], deck["tcbw"]
    box = tms.state.box.clone()
    box[1, 0] = 0.5
    tilted = dataclasses.replace(tms, state=dataclasses.replace(
        tms.state, box=box))
    with pytest.raises(ValueError, match="orthorhombic"):
        umbrella.transfer_triple(tilted, tsys)
    with pytest.raises(ValueError, match="orthorhombic"):
        umbrella.seeded_window_states(tilted, tsys, tcbw, deck["tatoms"],
                                      CENTERS)
    with pytest.raises(ValueError, match="keeper"):
        umbrella_pmf.run_pmf((tsys, tcbw, deck["tcfg"], tms), n_windows=2,
                             k_roo=[100.0, 120.0], verbose=False)


def test_biased_scan_step_makes_no_host_sync(deck):
    tsys, tcbw = deck["tscan"].system, deck["tcbw"]
    b = ensemble.window_bias(deck["tlad"], 1)
    gen = torch.Generator().manual_seed(1)
    args = (tsys, tcbw, DT, "NVT", 5.0, 300.0, gen, "full", b)
    ms, _ = integrators.scan_step(deck["tbatch"].states[1], *args)
    syncs = _HostSyncs()
    with _HostTensors(syncs.hits), syncs:
        integrators.scan_step(ms, *args)
    bad = [(n, "".join(st[-6:])) for n, st in syncs.hits
           if not any("ground_state_eigh" in f for f in st)]
    assert not bad, bad[0]


# the JSON keys of the JAX package's scripts/umbrella_pmf.py artifact
PMF_KEYS = {"config", "centers", "cv_mean", "cv_std", "bin_centers",
            "pmf_kjmol", "pmf_std_kjmol", "window_f_kjmol", "wham_converged",
            "barrier_kjmol", "barrier_kT", "barrier_xi", "hops_in_ladder",
            "overflow", "aggregate_steps_per_s", "compile_s", "total_s"}


def test_umbrella_pmf_cli_on_the_cpu(tmp_path):
    """The entry point on a 22-atom deck written here (the JAX script's
    --small / --dimer boxes come from tests/fixtures.py): 2 windows, 2 +
    2 steps; the artifact has the JAX artifact's keys; without
    --device cpu it asks for the card."""
    from reactive_pb_nn_md_tpu_torch.io import gro
    ff, top, sim = write_fixture_files(tmp_path, ensemble="NVT",
                                       msevb="yes", pme_grid=12,
                                       extra="evb_max_states 12\n")
    frame = make_water_box(6, include_h3o=True, seed=1)
    p = tmp_path / "in.gro"
    p.write_text(gro.format_gro_frame(frame.title, frame.mol_names,
                                      frame.mol_natom, frame.atom_names,
                                      frame.xyz, frame.box))
    argv = [str(p), ff, top, sim, "--windows", "2", "--equil", "2",
            "--sample", "2", "--chunk", "2", "--out",
            str(tmp_path / "pmf.json")]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            umbrella_pmf.main(argv)
    out = umbrella_pmf.main(argv + ["--device", "cpu"])
    assert set(out) == PMF_KEYS
    assert (tmp_path / "pmf.json").read_text() == json.dumps(out, indent=1)
    assert out["config"]["n_atoms"] == 22 and len(out["cv_mean"]) == 2
    assert out["config"]["evb_max_states"] == 12
