"""The multi-device half of the port's parallel/ (mesh.py, shard.py, the
mesh replica scan of ensemble.py, dryrun.py) on gloo ranks on the CPU,
fp64, on the dryrun's fixture (12 H2O + H3O+, 40 atoms, PME 12^3):

  * one NVE step shared over 2 and over 3 ranks (40 atoms do not divide
    by 3) equals the port's unsharded md_step and the JAX package's step
    from the same positions and velocities: potential rtol 1e-10, forces
    rtol / atol 1e-8, positions 1e-12 (tests/test_parallel.py's
    tolerances); every rank holds the same state; its collectives are
    the four of the design (grid, energy, force sums and the flags' max);
  * a 4-replica batch over 2 ranks gives the bits of the same batch on
    one rank, NVE and NVT, generator states included, the diagnostics
    gathered in replica order; its NVE replicas equal the JAX package's
    vmapped make_replica_step;
  * a capacity flag that one rank alone raises makes both ranks regrow to
    the same caps and replay, and the chunk equals an unflagged one; a
    batch whose steps are shared over 2 ranks (one vmapped step for the
    batch) sets its replicas up again after a regrow shared as well;
  * the launcher: a failing rank raises with its traceback and a hung
    rank raises at the time limit, the others killed;
  * the kernel A cell ranges and the split charge spreads (per atom and
    by slabs) sum to the whole; the dryrun's box and deck are the tests' fixture; the dryrun
    itself on 4 gloo ranks, whose part 1 runs each rank's block of 2
    replicas batched under its atoms pair's shard: one batched step
    issues each of the four collectives once, the block equals the same
    block run in turn under the shard (NVE and NVT, 1e-12 A) and its NVE
    replicas the JAX package's vmapped make_replica_step.

The ranks (tests/torch_dist_ranks.py) run in spawned processes, each
launch with its own store in a temporary file and its own time limit;
they start in threads before the JAX side compiles, which it does once
(the vmapped replica step; its initial forces are the port's, as in
tests/test_torch_umbrella.py).
"""

import json
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from fixtures import make_water_box, write_fixture_files
from torch_bridge import jax_compiled
from test_torch_umbrella import _port_forces_as_jax
from reactive_pb_nn_md_tpu.io.ffpmt import read_ffpmt
from reactive_pb_nn_md_tpu.io.simpmt import read_sim_params
from reactive_pb_nn_md_tpu.io.topfile import read_top
from reactive_pb_nn_md_tpu.topology import (build_system as jax_build,
                                            State as JState)
from reactive_pb_nn_md_tpu.md import integrators as jax_int
from reactive_pb_nn_md_tpu.parallel import ensemble as jax_ens
from reactive_pb_nn_md_tpu_torch.md import integrators
from reactive_pb_nn_md_tpu_torch.models import pme
from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_slab
from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp
from reactive_pb_nn_md_tpu_torch.parallel import dryrun, mesh
from reactive_pb_nn_md_tpu_torch.parallel import shard
from reactive_pb_nn_md_tpu_torch.parallel.shard import AtomShard, split

# seconds a launch may take (rendezvous, collectives, join) before its
# ranks are killed: far above the few seconds they need
LIMIT = 120
# the limit of the launch whose rank 1 hangs
HUNG_LIMIT = 10


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed")
    with ThreadPoolExecutor(5) as pool:
        worlds = {n: pool.submit(mesh.launch, R.world, n, n, device="cpu",
                                 timeout=LIMIT)
                  for n in (2, 3)}
        dry = pool.submit(mesh.launch, dryrun.dryrun_rank, 4, 4, "cpu",
                          device="cpu", timeout=LIMIT)
        failing = pool.submit(_raised, R.fail_on_rank_one, LIMIT)
        hung = pool.submit(_raised, R.hang_on_rank_one, HUNG_LIMIT)
        tsys, tcbw, cfg, tms = dryrun.fixture("cpu")
        ref_step = integrators.md_step(tms, tsys, tcbw, R.DT, "NVE")
        one = {ens: R.replica_run(None, tsys, tcbw, tms, ens)
               for ens in ("NVE", "NVT")}
        ff_p, top_p, sim_p = write_fixture_files(tmp, msevb="yes",
                                                 pme_grid=dryrun.PME_GRID)
        frame = make_water_box(dryrun.N_WATER, include_h3o=True, seed=0)
        jsys, jtopo = jax_build(frame, read_ffpmt(ff_p), read_top(top_p),
                                read_sim_params(sim_p))
        cbw = jnp.asarray(tcbw.numpy())
        cap = tms.nlist.capacity
        jstate = JState(x=jnp.asarray(frame.xyz),
                        v=jnp.asarray(tms.state.v.numpy()),
                        box=jnp.asarray(frame.box),
                        key=jax.random.PRNGKey(0),
                        step=jnp.asarray(0, jnp.int32))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_int, "evaluate_forces",
                       _port_forces_as_jax(tsys, tcbw, cap))
            jms = jax_int.initial_md_state(jstate, jtopo, jsys, cbw, cap)
        jbatch = jax_ens.stack_replicas(jms, R.N_REPLICAS,
                                        jax.random.PRNGKey(42))
        with jax_compiled():
            jout = jax_ens.make_replica_step(jsys, cbw, R.DT, "NVE")(jbatch)
        jout = jax.tree_util.tree_map(np.asarray, jout)
        return dict(worlds={n: f.result() for n, f in worlds.items()},
                    dry=dry.result(), ref_step=ref_step, one=one, jout=jout,
                    frame=frame, ff=ff_p, top=top_p, sim=sim_p,
                    failing=failing.result(), hung=hung.result())


def _raised(fn, limit):
    """(the exception launch(fn, 2) raised or None, its seconds)."""
    t0 = time.monotonic()
    try:
        mesh.launch(fn, 2, device="cpu", timeout=limit)
    except Exception as e:  # noqa: BLE001 -- the tests read it
        return e, time.monotonic() - t0
    return None, time.monotonic() - t0


def _close_step(got, ref_pot, ref_force, ref_x):
    np.testing.assert_allclose(float(got["potential"]), ref_pot, rtol=1e-10)
    np.testing.assert_allclose(got["force"].numpy(), ref_force, rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(got["x"].numpy(), ref_x, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_step_equals_unsharded(runs, n):
    ref = runs["ref_step"]
    for got in (r["step"] for r in runs["worlds"][n]):
        _close_step(got, float(ref.potential), ref.force.numpy(),
                    ref.state.x.numpy())
        for k, v in got["breakdown"].items():
            np.testing.assert_allclose(float(v),
                                       float(getattr(ref.breakdown, k)),
                                       rtol=1e-10, atol=1e-10)
        assert not got["overflow"].any()


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_step_equals_jax(runs, n):
    j = runs["jout"]
    for got in (r["step"] for r in runs["worlds"][n]):
        _close_step(got, float(j.potential[0]), j.force[0], j.state.x[0])


@pytest.mark.parametrize("n", [2, 3])
def test_ranks_hold_one_state(runs, n):
    steps = [r["step"] for r in runs["worlds"][n]]
    for s in steps[1:]:
        for k in ("x", "v", "force", "potential"):
            assert torch.equal(s[k], steps[0][k]), k


@pytest.mark.parametrize("n", [2, 3])
def test_step_collectives(runs, n):
    for r in runs["worlds"][n]:
        assert r["collectives"] == {
            "by_name": {"grid": 1, "energy": 1, "force": 1, "flags": 1},
            "by_kind": {"all_reduce(sum)": 3, "all_reduce(max)": 1}}


@pytest.mark.parametrize("n", [2, 3])
def test_mesh_layout_and_shares(runs, n):
    atoms, mols = [], []
    for rank, r in enumerate(runs["worlds"][n]):
        m = r["mesh_sp"]
        assert m["shape"] == {"replica": 1, "atoms": n}
        assert (m["rank"], m["atoms_index"], m["replica_index"]) == \
            (rank, rank, 0)
        atoms += range(40)[m["atoms"]]
        mols += range(13)[m["mols"]]
    assert atoms == list(range(40)) and mols == list(range(13))
    if n == 2:
        for rank, r in enumerate(runs["worlds"][2]):
            assert r["mesh_dp"]["shape"] == {"replica": 2, "atoms": 1}
            assert r["mesh_dp"]["block"] == [2 * rank, 2 * rank + 1]


@pytest.mark.parametrize("ens", ["NVE", "NVT"])
def test_replicas_same_bits_on_one_and_two_ranks(runs, ens):
    one = runs["one"][ens]
    ranks = [r[ens] for r in runs["worlds"][2]]
    for k in ("x", "v", "potential"):
        got = [t for r in ranks for t in r[k]]
        assert all(torch.equal(a, b) for a, b in zip(got, one[k], strict=True))
    got = [g for r in ranks for g in r["generators"]]
    assert all(torch.equal(a, b) for a, b in zip(got, one["generators"],
                                                  strict=True))
    for r in ranks:
        for k, v in r["diag"].items():
            assert v.shape[0] == R.N_REPLICAS
            assert torch.equal(v, one["diag"][k]), k
    if ens == "NVT":
        xs = one["x"]
        assert min(float((xs[i] - xs[j]).abs().max())
                   for i in range(len(xs)) for j in range(i)) > 1e-6


def test_nve_replicas_equal_jax(runs):
    j = runs["jout"]
    got = [r["NVE"] for r in runs["worlds"][2]]
    x = [t for r in got for t in r["x"]]
    pot = [t for r in got for t in r["potential"]]
    for w in range(R.N_REPLICAS):
        np.testing.assert_allclose(x[w].numpy(), j.state.x[w], rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(float(pot[w]), float(j.potential[w]),
                                   rtol=1e-10)


def test_one_rank_flag_regrows_every_rank(runs):
    ranks = [r["flagged"] for r in runs["worlds"][2]]
    one = runs["one"]["NVT"]
    for r in ranks:
        assert r["n_regrows"] == 1
        assert r["caps"] == ranks[0]["caps"]
        # the neighbor capacity is at its ceiling N - 1 already; the
        # reactive rows' grow
        assert r["caps"][2] > runs["ref_step"].nlist.react_cap
        assert r["evb_max_states"] == ranks[0]["evb_max_states"]
        assert any("neighbor-list capacity" in ln and "chunk replayed" in ln
                   for ln in r["regrows"])
        assert r["s"] < LIMIT
    x = [t for r in ranks for t in r["x"]]
    for a, b in zip(x, one["x"], strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


def test_sharded_replicas_regrow_shared(runs):
    """A regrow of a batch whose steps are shared over 2 ranks (a 1 x 2
    mesh): the set-up after it is shared too (each replica's evaluation
    issues the step's four collectives), and the chunk equals the
    unflagged one-rank chunk."""
    ranks = [r["flagged_sp"] for r in runs["worlds"][2]]
    one = runs["one"]["NVT"]
    # the batch's flagged first chunk (one collective of each kind a
    # batched step), the 4 replicas set up again one by one, the batch's
    # replayed chunk
    each = R.NVT_STEPS + R.N_REPLICAS + R.NVT_STEPS
    for r in ranks:
        assert r["n_regrows"] == 1 and r["caps"] == ranks[0]["caps"]
        assert r["collectives"] == {k: each for k in
                                    ("grid", "energy", "force", "flags")}
        assert all(torch.equal(a, b) for a, b in zip(r["x"], ranks[0]["x"],
                                                      strict=True))
        for a, b in zip(r["x"], one["x"], strict=True):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-12)


def test_dryrun_four_ranks(runs):
    p1, p2, bad = runs["dry"][0]
    assert bad == []
    assert p1["mesh"] == {"replica": 2, "atoms": 2} and p1["replicas"] == 4
    assert p1["finite"] and p1["nve_same"] == 0.0
    assert p1["nve_x_err"] <= dryrun.REPLICA_X_ATOL
    assert p1["nvt_x_err"] <= dryrun.REPLICA_X_ATOL
    assert p2["mesh"] == {"replica": 1, "atoms": 4}
    assert p2["match"] <= dryrun.POT_ATOL and p2["x_err"] <= dryrun.X_ATOL
    assert p2["ranks_x_spread"] == 0.0
    assert p2["collectives"]["by_kind"] == {"all_reduce(sum)": 3,
                                            "all_reduce(max)": 1}
    json.dumps(runs["dry"][0])
    # every rank reached the same verdict
    assert all(r[2] == [] for r in runs["dry"])


def test_dryrun_batched_step_collectives(runs):
    """One batched step of a rank's block (2 replicas shared over its
    atoms pair) issues each of the four collectives once, on every
    rank."""
    for p1, _, _ in runs["dry"]:
        assert p1["collectives"] == {
            "by_name": shard.STEP_COLLECTIVES,
            "by_kind": {"all_reduce(sum)": 3, "all_reduce(max)": 1}}


@pytest.mark.parametrize("ens", ["nve", "nvt"])
def test_dryrun_batch_under_shard_equals_in_turn(runs, ens):
    """Each block batched under the shard against the same block in turn
    under the same shard (ReplicaScan), the largest |dx| over every rank;
    the ranks of an atoms pair hold the same bits."""
    p1 = runs["dry"][0][0]
    assert p1[f"inturn_{ens}_x_err"] <= 1e-12
    assert p1["ranks_x_spread"] == 0.0


def test_dryrun_nve_replicas_equal_jax(runs):
    """The (2 x 2) mesh's NVE replicas, batched under the shard, against
    the JAX package's vmapped make_replica_step (the step
    test_nve_replicas_equal_jax compiles) at tests/test_parallel.py's
    tolerances."""
    j = runs["jout"]
    p1 = runs["dry"][0][0]
    assert p1["replicas"] == R.N_REPLICAS
    for w in range(R.N_REPLICAS):
        np.testing.assert_allclose(np.asarray(p1["nve_x"][w]), j.state.x[w],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(p1["potential"][w],
                                   float(j.potential[w]), rtol=1e-10)


def test_launch_failing_rank_raises(runs):
    err, s = runs["failing"]
    assert isinstance(err, RuntimeError)
    assert "of 2 failed" in str(err)
    assert "rank one fails on purpose" in str(err)
    # rank 0, waiting in its collective, was killed, not waited for
    assert s < LIMIT


def test_launch_hung_rank_times_out(runs):
    err, s = runs["hung"]
    assert isinstance(err, TimeoutError)
    assert "did not finish within" in str(err) and "1]" in str(err)
    assert HUNG_LIMIT <= s < HUNG_LIMIT + 10


def test_make_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="initialised"):
        mesh.make_mesh(2, device="cpu")
    # the launcher's default is the card, and without one it raises
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="2 ranks need 2 cards"):
            mesh.launch(R.hang_on_rank_one, 2)
    assert mesh.backend_for("cpu") == "gloo"
    assert mesh.backend_for("cuda:1") == "nccl"
    with pytest.raises(ValueError):
        mesh.backend_for("meta")


def test_dryrun_fixture_is_the_tests_fixture(runs):
    got, ref = dryrun.water_box(dryrun.N_WATER, seed=0), runs["frame"]
    assert got.mol_names == ref.mol_names
    assert got.atom_names == ref.atom_names
    for f in ("xyz", "box", "mol_first_atom", "mol_natom"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    for name, p in (("ff.pmt", runs["ff"]), ("top.top", runs["top"])):
        assert (dryrun.DECK / name).read_text().strip() == \
            open(p).read().strip()
    cfg = read_sim_params(runs["sim"])
    assert cfg.pme_grid == dryrun.PME_GRID and cfg.precision == "fp64"


@pytest.mark.parametrize("n,size", [(40, 3), (13, 2), (7, 4), (64, 4)])
def test_split_covers_once(n, size):
    got = [i for r in range(size) for i in range(*split(n, size, r))]
    assert got == list(range(n))


def test_cell_ranges_sum_to_the_sweep():
    rng = np.random.default_rng(3)
    cells = (3, 3, 4, 16)
    L = np.array([9.3, 9.6, 12.4])
    n = 180
    x = torch.tensor(rng.uniform(0, 1, (n, 3)) * L)
    box = torch.diag(torch.tensor(L))
    charge = torch.tensor(rng.choice([-0.8, 0.4], n))
    atype = torch.tensor(rng.integers(0, 2, n), dtype=torch.float64)
    mol = torch.arange(n, dtype=torch.float64) // 3
    tabs = torch.stack([torch.zeros(2, 2), torch.full((2, 2), 2.0e5),
                        torch.full((2, 2), 600.0)]).double()
    slot, over = rsp.bin_atoms(x, box, cells, 3.0)
    assert not over
    cm = rsp.pack_cells(x, charge, atype, mol, slot, cells)
    full = rsp.pair_rows(cm, tabs, cells, box, 3.0, 0.7, False)
    parts = [rsp.pair_rows(cm, tabs, cells, box, 3.0, 0.7, False,
                           cell_range=AtomShard(None, r, 4).cells(cells))
             for r in range(4)]
    ccap, n_cells = cells[3], 36
    for r, p in enumerate(parts):
        lo, hi = split(n_cells, 4, r)
        outside = torch.ones(p.shape[0], dtype=torch.bool)
        outside[lo * ccap:hi * ccap] = False
        assert not p[outside].any()
        assert torch.equal(p[~outside], full[~outside])
    np.testing.assert_allclose(sum(parts).numpy(), full.numpy(), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="cell range"):
        rsp.pair_rows(cm, tabs, cells, box, 3.0, 0.7, False,
                      cell_range=(30, 37))


@pytest.mark.parametrize("path", ["atoms", "slab"])
def test_charge_spread_shares_sum_to_the_grid(path):
    """The base charge spread over 3 (per atom: 40 atoms, K = 12) or 4
    (slab path, D1's plain version: 640 atoms, K = 16, the suggested slab
    cap) atom ranges, summed, against the whole spread."""
    rng = np.random.default_rng(4 if path == "atoms" else 5)
    n, K, L, size = (40, 12, 9.0, 3) if path == "atoms" else \
        (640, 16, 16.0, 4)
    x = torch.tensor(rng.uniform(0, L, (n, 3)))
    q = torch.tensor(rng.normal(size=n))
    box = torch.eye(3, dtype=torch.float64) * L
    scap = 0 if path == "atoms" else pme_slab.suggest_slab_cap(n, K)
    full, over = pme.charge_grid(x, q, box, K, 6, scap)
    assert not bool(over)
    shares = []
    for a in (AtomShard(None, r, size).atoms(n) for r in range(size)):
        g, over = pme.charge_grid(x[a], q[a], box, K, 6, scap)
        assert not bool(over)
        shares.append(g)
    np.testing.assert_allclose(sum(shares).numpy(), full.numpy(), rtol=0,
                               atol=1e-12 * float(full.abs().max()))
