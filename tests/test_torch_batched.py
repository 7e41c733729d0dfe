"""The port's replica batch (md/integrators.py batched_md_scan,
parallel/ensemble.py BatchedReplicaScan, the kernels' ops and their
batching rules), on the CPU, fp64, on the 28-atom reactive fixture (8
waters + H3O+ of parallel/dryrun.py's water_box, the flagship deck at
PME 12^3 and state cap 12):

  * evaluate_forces vmapped over W = 3 replicas against each replica's
    own evaluation, to 1e-12;
  * the batched NVE and NVT replica scans (one generator a replica)
    against the in-turn ReplicaScan, 3 steps, positions to 1e-12 A and
    the generators' states equal;
  * each kernel op's batching rule on CPU tensors (the pair sweep at
    impl full, half and column (A, A', A''), B1, B2, C1, C2, D1, D2, E)
    against a loop of its plain version, and C2's plain version against
    autograd of C1's;
  * a batch started under too small a capacity: regrown for all and
    replayed, equal to a batch started at the grown capacity;
  * a batched step makes no host synchronization (the dispatch audit of
    tests/test_torch_scan.py);
  * a batch under an AtomShard of size 1 (a one-rank gloo group made in
    this process) equals the same batch in turn under the shard bit for
    bit and the unsharded batch within 1e-12 A, NVE and NVT, one batched
    step issuing each of the shard's four collectives once; a batch on
    the cell path runs (and its graph key names the cell grids, the slab
    cap and the shard).

The JAX package is held against the batched ladder in
tests/test_torch_umbrella.py (its vmapped make_ladder_scan), and the
cell path under the batch in tests/test_torch_batched_cells.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_scan import _HostSyncs, _HostTensors
from reactive_pb_nn_md_tpu_torch.io.ffpmt import read_ffpmt
from reactive_pb_nn_md_tpu_torch.io.simpmt import read_sim_params
from reactive_pb_nn_md_tpu_torch.io.topfile import read_top
from reactive_pb_nn_md_tpu_torch.md import graphs, integrators, velocities
from reactive_pb_nn_md_tpu_torch.models import pme
from reactive_pb_nn_md_tpu_torch.ops import ground_state as gs
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_slab as sl
from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_spread as sp
from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp
from reactive_pb_nn_md_tpu_torch.ops.kernels import recip_perstate as rp
from reactive_pb_nn_md_tpu_torch.parallel import dryrun, ensemble
from reactive_pb_nn_md_tpu_torch.parallel import shard as shard_mod
from reactive_pb_nn_md_tpu_torch.topology import State, build_system
from reactive_pb_nn_md_tpu_torch.utils import pbc

W, DT, N_STEPS, SEED = 3, 0.0005, 3, 5


@pytest.fixture(scope="module")
def deck():
    """(system without the small tier, cbw, W replicas' MDStates: one
    box, velocities from seeds 0 .. W - 1)."""
    cfg = read_sim_params(dryrun.DECK / "sim.pmt")
    cfg.pme_grid, cfg.precision, cfg.evb_max_states = 12, "fp64", 12
    frame = dryrun.water_box(8, seed=1)
    system, topo = build_system(frame, read_ffpmt(dryrun.DECK / "ff.pmt"),
                                read_top(dryrun.DECK / "top.top"), cfg,
                                device="cpu")
    system = ensemble._no_tier(system)
    f = torch.float64
    box = torch.as_tensor(frame.box, dtype=f)
    x = torch.as_tensor(frame.xyz, dtype=f)
    cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt, dtype=f)
    cap = neighbors.suggest_capacity(system.n_atoms,
                                     float(np.prod(np.diag(frame.box))),
                                     system.verlet_cutoff)
    mobile = velocities.freeze_mask(system, topo)
    states = [integrators.initial_md_state(
        State(x=x, v=velocities.sample_velocities(
            torch.Generator().manual_seed(w), system.mass, 300.0, mobile),
              box=box), topo, system, cbw, cap) for w in range(W)]
    return system, cbw, states


def _batch(states):
    return ensemble.ReplicaBatch(
        list(states), [ensemble.generator_state(
            "cpu", ensemble.replica_seed(SEED, w)) for w in range(W)])


def test_vmapped_evaluate_forces_equal_each_replica(deck):
    system, cbw, states = deck
    rng = np.random.default_rng(0)
    xs = torch.stack([m.state.x + torch.as_tensor(
        rng.normal(scale=0.03, size=m.state.x.shape)) for m in states])
    box, topo, nl = states[0].state.box, states[0].topo, states[0].nlist
    nls = [neighbors.rebuild_like(nl, x, box, system.verlet_cutoff)
           for x in xs]

    def one(x, nl_leaves):
        fe = integrators.evaluate_forces(
            x, box, topo, system, graphs.with_leaves(nl, iter(nl_leaves)),
            cbw)
        return fe.potential, fe.force, fe.eigenvector

    got = torch.func.vmap(one)(xs, [torch.stack(t) for t in zip(
        *(graphs.leaves(n) for n in nls))])
    for w in range(W):
        fe = integrators.evaluate_forces(xs[w], box, topo, system, nls[w],
                                         cbw)
        assert abs(float(got[0][w] - fe.potential)) <= 1e-12 * abs(
            float(fe.potential))
        np.testing.assert_allclose(got[1][w].numpy(), fe.force.numpy(),
                                   rtol=0, atol=1e-12 * float(
                                       fe.force.abs().max()))
        np.testing.assert_allclose(got[2][w].numpy(),
                                   fe.eigenvector.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("ens", ["NVE", "NVT"])
def test_batched_scan_equals_in_turn(deck, ens):
    system, cbw, states = deck
    runs = []
    for cls in (ensemble.ReplicaScan, ensemble.BatchedReplicaScan):
        scan = cls(system, cbw, DT, ens, N_STEPS, friction=5.0)
        runs.append(scan(_batch(states)))
    (t, td), (b, bd) = runs
    assert bd.potential.shape == (W, N_STEPS) and not bd.capacities()
    for w in range(W):
        np.testing.assert_allclose(b.states[w].state.x.numpy(),
                                   t.states[w].state.x.numpy(), rtol=0,
                                   atol=1e-12)
        assert torch.equal(b.generators[w], t.generators[w])
        assert b.states[w].state.step == t.states[w].state.step == N_STEPS
    np.testing.assert_allclose(bd.potential.numpy(), td.potential.numpy(),
                               rtol=1e-12)
    assert torch.equal(bd.n_states, td.n_states)
    if ens == "NVT":
        # distinct streams: the replicas part
        assert float((b.states[0].state.x - b.states[1].state.x).abs()
                     .max()) > 1e-6


def _vmapped_vs_loop(op, args, in_dims, n):
    """op vmapped over the batched args (in_dims) against a loop of op on
    each replica's args."""
    got = torch.func.vmap(op, in_dims=in_dims)(*args)
    got = got if isinstance(got, tuple) else (got,)
    for i in range(n):
        one = op(*(a[i] if d is not None else a
                   for a, d in zip(args, in_dims)))
        one = one if isinstance(one, tuple) else (one,)
        for g, r in zip(got, one, strict=True):
            assert torch.equal(g[i], r)


def test_ops_batching_rules_equal_a_loop_of_the_plain_versions():
    rng = np.random.default_rng(3)
    f = torch.float64
    # kernel A's sweep: 3 replicas of 40 atoms on a (3, 3, 4, 12) grid
    cells, rc = (3, 3, 4, 12), 3.0
    box = torch.diag(torch.tensor([9.5, 9.6, 12.4], dtype=f))
    tabs = torch.stack([torch.zeros(2, 2), torch.full((2, 2), 2.0e5),
                        torch.full((2, 2), 600.0)]).double()
    n = 40
    charge = torch.tensor(rng.normal(size=n))
    atype = torch.tensor(rng.integers(0, 2, n), dtype=f)
    mol = torch.arange(n, dtype=f) // 3
    cms = []
    for _ in range(3):
        x = torch.tensor(rng.uniform(0.0, 1.0, (n, 3))) * torch.diagonal(box)
        slot, over = rsp.bin_atoms(x, box, cells, rc)
        assert not over
        cms.append(rsp.pack_cells(x, charge, atype, mol, slot, cells))
    for impl in ("full", "half", "column"):
        _vmapped_vs_loop(lambda c, b: rsp.pair_rows(c, tabs, list(cells), b,
                                                    rc, 0.7, False, impl),
                         (torch.stack(cms), box), (0, None), 3)
    # B1 / B2: 3 replicas of 30 atoms, K = 10, order 6, shared charges
    K, order = 10, 6
    xs = torch.tensor(rng.uniform(0.0, 8.0, (3, 30, 3)))
    box2 = torch.eye(3, dtype=f) * 8.0
    spl = [sp.spline_setup(x, box2, K, order) for x in xs]
    w, dw, nearpt = (torch.stack([s[i] for s in spl]) for i in range(3))
    q = torch.tensor(rng.normal(size=30))
    _vmapped_vs_loop(lambda a, b: sp.spread(a, b, q, K), (w, nearpt),
                     (0, 0), 3)
    gQ = torch.tensor(rng.normal(size=(3, K ** 3)))
    recip = pbc.recip_vectors(box2)
    _vmapped_vs_loop(lambda g, a, b, c: sp.gather(g, a, b, c, q, recip, K),
                     (gQ, w, dw, nearpt), (0, 0, 0, 0), 3)
    # D1 / D2 on the same atoms, slab-binned at a cap of 8 (shared charges)
    scap = 8
    rows = torch.stack([sl.slab_bins(nearpt[i], K, order, scap)[1]
                        for i in range(3)])
    _vmapped_vs_loop(lambda a, b, r: sl.spread_slab(a, b, q, r, K, scap),
                     (w, nearpt, rows), (0, 0, 0), 3)
    _vmapped_vs_loop(lambda g, a, b, c, r: sl.interp_slab(g, a, b, c, r, K,
                                                          scap),
                     (gQ, w, dw, nearpt, rows), (0, 0, 0, 0, 0), 3)
    # C1 / C2: 3 replicas at S = 5, U = 7, K = 6 (Mh = 24), cbw shared
    S, U, Kc = 5, 7, 6
    Mh = Kc * (Kc // 2 + 1)
    shapes = [(S, U), (Kc, U), (Kc, U), (U, Mh), (U, Mh), (Kc, Mh), (Kc, Mh)]
    ins = [torch.tensor(rng.normal(size=(3,) + s)) for s in shapes]
    cbw = torch.tensor(rng.uniform(0.0, 1.0, (Kc, Mh)))
    _vmapped_vs_loop(rp.perstate_fwd, (*ins, cbw), (0,) * 7 + (None,), 3)
    gbar = torch.tensor(rng.normal(size=(3, S)))
    _vmapped_vs_loop(rp.perstate_bwd, (gbar, *ins, cbw), (0,) * 8 + (None,),
                     3)
    # C2's plain version against autograd of C1's
    leaves = [t[0].clone().requires_grad_() for t in ins]
    ref = torch.autograd.grad((rp.perstate_plain(*leaves, cbw)
                               * gbar[0]).sum(), leaves)
    for a, b in zip(rp.perstate_bwd_plain(gbar[0], *(t[0] for t in ins),
                                          cbw), ref, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(b.abs().max()))
    # E: 3 EVB-shaped Hamiltonians (eigh on the CPU)
    Hs = []
    for _ in range(3):
        H = np.diag(-24000.0 + 50.0 * rng.standard_normal(12))
        for s in range(1, 8):
            p = rng.integers(0, s)
            H[p, s] = H[s, p] = 30.0 * rng.standard_normal()
        Hs.append(H)
    _vmapped_vs_loop(gs.ground_state_op, (torch.tensor(np.stack(Hs)),), (0,),
                     3)


def test_batch_regrows_for_all_and_replays(deck):
    """A batch set up under a neighbor capacity that does not hold is
    regrown for every replica (one log line), set up again and run: it
    equals the batch set up at the grown capacity."""
    system, cbw, states = deck
    small = integrators.initial_md_state(
        states[0].state, states[0].topo, system, cbw, 4)
    assert integrators.NEIGHBOR_CAP in integrators.overflowed(small)
    batch = _batch([integrators.initial_md_state(
        m.state, m.topo, system, cbw, 4) for m in states])
    scan = ensemble.BatchedReplicaScan(system, cbw, DT, "NVT", N_STEPS,
                                       friction=5.0)
    out, diag = scan(batch)
    assert scan.n_regrows >= 1 and not diag.capacities()
    assert all("neighbor-list capacity" in ln for ln in scan.regrows)
    cap = scan.caps[0]
    ref_scan = ensemble.BatchedReplicaScan(system, cbw, DT, "NVT", N_STEPS,
                                           friction=5.0)
    ref, ref_diag = ref_scan(_batch([integrators.initial_md_state(
        m.state, m.topo, system, cbw, cap) for m in states]))
    assert not ref_scan.regrows
    np.testing.assert_allclose(diag.potential.numpy(),
                               ref_diag.potential.numpy(), rtol=1e-12)
    for w in range(W):
        assert out.states[w].nlist.capacity == cap
        np.testing.assert_allclose(out.states[w].state.x.numpy(),
                                   ref.states[w].state.x.numpy(), rtol=0,
                                   atol=1e-12)
        assert torch.equal(out.generators[w], ref.generators[w])


def test_batched_step_makes_no_host_sync(deck):
    system, cbw, states = deck
    bms = integrators.stack_states(states)
    gens = [torch.Generator().manual_seed(w) for w in range(W)]
    args = (system, cbw, DT, "NVT", 5.0, 300.0, gens)
    bms, _ = integrators.batched_scan_step(bms, *args)
    syncs = _HostSyncs()
    with _HostTensors(syncs.hits), syncs:
        integrators.batched_scan_step(bms, *args)
    bad = [(n, "".join(st[-6:])) for n, st in syncs.hits
           if not any("ground_state_eigh" in f for f in st)]
    assert not bad, bad[0]


@pytest.fixture
def one_rank_shard(tmp_path):
    """An AtomShard of size 1 on a one-rank gloo group made in this
    process (a store in a temporary file), torn down after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield shard_mod.AtomShard()
    finally:
        dist.destroy_process_group()


def test_cell_path_and_shard_refuse_a_batch(deck, one_rank_shard):
    """(Named when the cell path and a shard refused a batch.)  A batch
    under a shard of size 1 runs: it equals the same batch in turn under
    the shard bit for bit and the unsharded batch within 1e-12 A (the
    shard sums a step's gradient contributions in another order, in turn
    as batched), NVE and NVT, and one batched step issues each of the
    four collectives once.  The cell path runs a batch (here the slab
    spread), and the batch's graph key names the cell grids, kernel A's
    cells, the slab cap and the shard, so a regrown grid or cap, or a
    shard, is a new capture."""
    system, cbw, states = deck
    sh = one_rank_shard
    bms = integrators.stack_states(states)
    for ens in ("NVE", "NVT"):
        runs = {}
        for cls, shard in ((ensemble.BatchedReplicaScan, sh),
                           (ensemble.ReplicaScan, sh),
                           (ensemble.BatchedReplicaScan, None)):
            scan = cls(system, cbw, DT, ens, N_STEPS, friction=5.0,
                       shard=shard)
            runs[cls, shard] = scan(_batch(states))[0]
        got = runs[ensemble.BatchedReplicaScan, sh]
        for w in range(W):
            x = got.states[w].state.x
            assert torch.equal(x, runs[ensemble.ReplicaScan, sh]
                               .states[w].state.x)
            np.testing.assert_allclose(
                x.numpy(), runs[ensemble.BatchedReplicaScan, None]
                .states[w].state.x.numpy(), rtol=0, atol=1e-12)
    colls = shard_mod.collective_summary(lambda: integrators.
                                         batched_scan_step(
        bms, system, cbw, DT, "NVE", 0.1, 300.0, (), shard=sh))
    assert colls["by_name"] == shard_mod.STEP_COLLECTIVES
    with pytest.raises(ValueError, match="one signature"):
        integrators.stack_states([states[0], dataclasses.replace(
            states[1], nlist=dataclasses.replace(states[1].nlist,
                                                 capacity=7))])
    # the cell path runs: here the slab spread (the cell-list neighbors
    # and kernels A' / A'': tests/test_torch_batched_cells.py)
    box = states[0].state.box
    cells = neighbors.suggest_cells(system.n_atoms, box.numpy(), 2.0,
                                    min_atoms=1)
    assert cells
    slab = system.replace(pme_scap=16)
    _, diag = integrators.md_scan(bms, slab, cbw, DT, "NVE")
    assert diag.potential.shape == (W, 1) and not diag.capacities()
    key = integrators.batch_key(bms, system, cbw, DT, "NVE", 0.1, 300.0, ())
    assert key == integrators.batch_key(bms, system, cbw, DT, "NVE", 0.1,
                                        300.0, ())
    assert integrators.batch_key(bms, system, cbw, DT, "NVE", 0.1, 300.0,
                                 (), shard=sh) != key
    for other, ms in ((slab, bms),
                      (system.replace(rs_cells=(3, 3, 3, 8)), bms),
                      (system, dataclasses.replace(bms, nlist=dataclasses
                                                   .replace(bms.nlist,
                                                            cells=cells)))):
        assert integrators.batch_key(ms, other, cbw, DT, "NVE", 0.1, 300.0,
                                     ()) != key
