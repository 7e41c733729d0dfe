"""The port's md_scan and chunked simulation loop, fp64 on the CPU.

  * md_scan against the JAX package's md_scan: 8 NVE steps on the
    26-water + H3O+ fixture of tests/test_torch_driver.py (13 diabats, at
    that file's regrown state cap of 24, so that neither run regrows);
  * md_scan equals a loop of md_step bit for bit, under NVE and NVT, over
    steps that rebuild the neighbor list;
  * a small-tier overflow replays the chunk at the full cap, which equals
    per-step full-cap steps;
  * the chunked Simulation against the JAX Simulation on that deck: the
    log's step blocks and the hop lines, positions to 1e-9 A; and on that
    deck with a proton put midway between two oxygens, so that it hops
    inside a chunk;
  * the plain ground state (kernel E's CPU version) against the JAX
    package's ground_state_eigh and jacobi_eigh;
  * one scan step makes no host synchronization (the CPU stand-in for a
    CUDA graph capture), on the dense reactive path and on the scale path
    (cell lists with on-demand rows, kernel A's cells, the PME slab);
  * the graph plumbing that runs without a card: MDState flattening, the
    chunk boundaries, the diagnostics.
"""

import dataclasses
import pathlib
import traceback
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from fixtures import make_water_box, write_fixture_files
from torch_bridge import driver_deck, jax_compiled
from test_ground_state import _evb_like
from reactive_pb_nn_md_tpu.md import integrators as jax_int
from reactive_pb_nn_md_tpu.md.simulation import Simulation as JaxSimulation
from reactive_pb_nn_md_tpu.ops.ground_state import (
    ground_state_eigh as jax_eigh, jacobi_eigh)
from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
from reactive_pb_nn_md_tpu_torch.io import gro
from reactive_pb_nn_md_tpu_torch.md import graphs, integrators
from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
from reactive_pb_nn_md_tpu_torch.ops import ground_state as gs

DT = 0.0005
N_WATER, CAP, N_STEPS = 26, 24, 8


def _deck(tmp, **kw):
    return driver_deck(tmp, n_water=N_WATER, msevb="yes",
                       extra=f"evb_max_states {CAP}\n", n_step=N_STEPS,
                       n_output=2, **kw)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """(JAX Simulation's first MDState, the JAX run, its log and hop
    text, the port's Simulation before its run); the JAX run's chunks are
    2 steps, so md_scan of 2 steps reuses their compilation."""
    tmp = tmp_path_factory.mktemp("scan")
    files = _deck(tmp / "jax")
    with jax_compiled():
        jsim = JaxSimulation(*files, checkpoint_file=str(tmp / "chk.npz"))
        jms0 = jsim.ms
        jsim.run(N_STEPS)
    port = Simulation(*_deck(tmp / "port"), device="cpu")
    return dict(jms0=jms0, jsim=jsim,
                log=pathlib.Path(files[5]).read_text(),
                hops=pathlib.Path(files[6]).read_text(), port=port)


def test_md_scan_matches_jax_md_scan(jax_runs):
    sim, jsim, jms = jax_runs["port"], jax_runs["jsim"], jax_runs["jms0"]
    assert sim.system.evb_max_states == jsim.system.evb_max_states == CAP
    jd = []
    with jax_compiled():
        for _ in range(N_STEPS // 2):
            jms, d = jax_int.md_scan(jms, jsim.system, jsim.cbw, DT, "NVE",
                                     2, sim.cfg.friction_coeff,
                                     sim.cfg.temperature)
            jd.append(d)
    ms, diag = integrators.md_scan(sim.ms, sim.system, sim.cbw, DT, "NVE",
                                   N_STEPS)
    assert ms.state.step == N_STEPS
    np.testing.assert_allclose(ms.state.x.numpy(), np.asarray(jms.state.x),
                               rtol=0, atol=1e-9)

    def jcat(name):
        return np.concatenate([np.asarray(getattr(d, name)) for d in jd])

    for name in ("potential", "kinetic"):
        np.testing.assert_allclose(getattr(diag, name).numpy(), jcat(name),
                                   rtol=1e-10)
    np.testing.assert_allclose(diag.max_ci2.numpy(), jcat("max_ci2"),
                               rtol=0, atol=1e-9)
    for name in ("n_states", "hopped", "hydronium", "force_overflow",
                 "evb_overflow"):
        np.testing.assert_array_equal(getattr(diag, name).numpy(),
                                      jcat(name), err_msg=name)
    # the JAX package's one neighbor flag is the port's other capacities
    nbr = (diag.neighbor_overflow | diag.row_overflow
           | diag.rs_cell_overflow | diag.slab_overflow)
    np.testing.assert_array_equal(nbr.numpy(), jcat("nbr_overflow"))
    assert int(diag.n_states.max()) > 1
    assert not diag.small_overflow.any() and not diag.gs_failed.any()


def _step_blocks(text):
    """The log's lines from the first step block on, the run's timing
    line left out."""
    lines = text.splitlines()
    first = next(i for i, ln in enumerate(lines) if ln.startswith("step "))
    return [ln for ln in lines[first:] if not ln.startswith("completed")]


def _assert_same_log(log, jax_log):
    got, want = _step_blocks(log), _step_blocks(jax_log)
    assert len(got) == len(want) > 5 * (N_STEPS // 2 + 1)
    for a, b in zip(got, want):
        ta, tb = a.split(), b.split()
        assert len(ta) == len(tb), (a, b)
        for u, w in zip(ta, tb):
            try:
                assert abs(float(u) - float(w)) <= 1e-6, (a, b)
            except ValueError:
                assert u == w, (a, b)


def test_chunked_simulation_matches_jax_simulation(jax_runs, tmp_path):
    jsim = jax_runs["jsim"]
    files = _deck(tmp_path)
    sim = Simulation(*files, device="cpu")
    sim.run(N_STEPS)
    log = pathlib.Path(files[5]).read_text()
    _assert_same_log(log, jax_runs["log"])
    assert pathlib.Path(files[6]).read_text() == jax_runs["hops"]
    assert f"completed {N_STEPS} steps" in log
    np.testing.assert_allclose(sim.ms.state.x.numpy(),
                               np.asarray(jsim.ms.state.x), rtol=0, atol=1e-9)


def _zundel_deck(tmp):
    """_deck with the water nearest a hydronium proton moved in to 2.45 A,
    oxygen to oxygen, and that proton put midway: it hops inside a 2-step
    chunk, at its second step."""
    files = _deck(tmp)
    f = gro.read_gro(files[0])
    x, L = f.xyz.copy(), np.diag(f.box)

    def wrap(d):
        return d - L * np.round(d / L)

    hyd = f.mol_names.index("h3o")
    o3 = f.mol_first_atom[hyd]
    hs = o3 + np.arange(1, 4)
    ows = np.delete(f.mol_first_atom, hyd)
    d = wrap(x[ows][None] - x[hs][:, None])
    h, w = np.unravel_index(np.argmin((d * d).sum(-1)), d.shape[:2])
    ow = ows[w]
    d = wrap(x[ow] - x[o3])
    x[ow:ow + 3] += d * (2.45 / np.linalg.norm(d) - 1.0)
    x[hs[h]] = x[o3] + 0.5 * wrap(x[ow] - x[o3])
    pathlib.Path(files[0]).write_text(gro.format_gro_frame(
        f.title, f.mol_names, f.mol_natom, f.atom_names, x, f.box,
        velocities=f.velocities))
    return files


def test_chunked_hop_lines_match_jax_simulation(tmp_path):
    """A hop at the second step of a 2-step chunk: the hop line names the
    hydronium of the chunk's first step as the donor, as the JAX driver's
    line does."""
    jfiles = _zundel_deck(tmp_path / "jax")
    with jax_compiled():
        jsim = JaxSimulation(*jfiles,
                             checkpoint_file=str(tmp_path / "chk.npz"))
        jsim.run(N_STEPS)
    files = _zundel_deck(tmp_path / "port")
    sim = Simulation(*files, device="cpu")
    sim.run(N_STEPS)
    hops = pathlib.Path(files[6]).read_text()
    steps = [int(ln.split()[1]) for ln in hops.splitlines()
             if ln.startswith("step")]
    assert "proton hop" in hops and any(s % 2 == 0 for s in steps), hops
    assert hops == pathlib.Path(jfiles[6]).read_text()
    _assert_same_log(pathlib.Path(files[5]).read_text(),
                     pathlib.Path(jfiles[5]).read_text())
    np.testing.assert_allclose(sim.ms.state.x.numpy(),
                               np.asarray(jsim.ms.state.x), rtol=0, atol=1e-9)


def _rebuild_deck(tmp, ensemble):
    """The 16-water reactive fixture with a skin of 0.02 A: the list is
    rebuilt within the first steps."""
    ff, top, sim = write_fixture_files(tmp, ensemble=ensemble, msevb="yes",
                                       verlet_cutoff=4.52, n_step=8,
                                       n_output=8)
    frame = make_water_box(16, include_h3o=True, seed=5, jitter=0.05)
    p = tmp / "in.gro"
    p.write_text(gro.format_gro_frame(frame.title, frame.mol_names,
                                      frame.mol_natom, frame.atom_names,
                                      frame.xyz, frame.box))
    return [str(p), ff, top, sim] + [str(tmp / n) for n in (
        "traj.gro", "log.out", "hop.out", "a.out")]


@pytest.mark.parametrize("ensemble", ["NVE", "NVT"])
def test_md_scan_equals_md_step_loop(tmp_path, ensemble):
    sim = Simulation(*_rebuild_deck(tmp_path, ensemble), device="cpu")
    cfg = sim.cfg
    state0 = sim.gen.get_state()
    ms, diag = integrators.md_scan(sim.ms, sim.system, sim.cbw, DT, ensemble,
                                   6, cfg.friction_coeff, cfg.temperature,
                                   generator=sim.gen)
    sim.gen.set_state(state0)
    ref = sim.ms
    pot, rebuilt = [], 0
    for _ in range(6):
        noise = (integrators.draw_noise(ref.state.x, sim.gen)
                 if ensemble == "NVT" else None)
        nxt = integrators.md_step(ref, sim.system, sim.cbw, DT, ensemble,
                                  cfg.friction_coeff, cfg.temperature,
                                  noise=noise, tier="full")
        rebuilt += not torch.equal(nxt.nlist.ref_x, ref.nlist.ref_x)
        ref = nxt
        pot.append(ref.potential)
    assert rebuilt >= 1
    for a, b in zip(graphs.leaves(ms), graphs.leaves(ref)):
        assert torch.equal(a, b)
    assert torch.equal(diag.potential, torch.stack(pot))
    assert ms.state.step == ref.state.step == 6


def test_small_tier_overflow_replays_at_full_cap(tmp_path):
    """evb_small_states 4 on the 13-diabat fixture: every step overflows
    the small tier, the chunk is replayed at the full cap, and the result
    is that of per-step full-cap steps."""
    files = driver_deck(tmp_path, n_water=N_WATER, msevb="yes",
                        extra=f"evb_max_states {CAP}\nevb_small_states 4\n")
    sim = Simulation(*files, device="cpu")
    assert ham.small_state_tier(sim.system) == 4
    ms, diag = integrators.md_scan(sim.ms, sim.system, sim.cbw, DT, "NVE", 4)
    assert diag.small_overflow.all() and (diag.n_states > 4).all()
    ref = sim.ms
    for _ in range(4):
        ref = integrators.md_step(ref, sim.system, sim.cbw, DT, tier="full")
    np.testing.assert_allclose(ms.state.x.numpy(), ref.state.x.numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(ms.potential), float(ref.potential),
                               rtol=1e-12)
    # the small tier alone: flagged, and its result is not taken
    small = integrators.md_step(sim.ms, sim.system, sim.cbw, DT,
                                tier="small")
    assert bool(small.small_overflow)


@pytest.mark.parametrize("seed", range(3))
def test_plain_ground_state_matches_jax(seed):
    rng = np.random.default_rng(seed)
    S = (80, 48, 33)[seed]
    gap = 1e-7 if seed == 1 else None
    H = np.asarray(_evb_like(S, int(rng.integers(2, S)), rng, gap=gap))
    lam, c = gs.ground_state_eigh(torch.tensor(H))
    lam_j, c_j = jax_eigh(jnp.asarray(H))
    np.testing.assert_allclose(float(lam), float(lam_j), rtol=1e-12)
    c, c_j = c.numpy(), np.asarray(c_j)
    assert min(np.abs(c - c_j).max(), np.abs(c + c_j).max()) < 1e-9
    i = np.argmax(np.abs(c))
    assert c[i] > 0
    # the TPU analog: fixed-sweep Jacobi of H - H00 I
    w, v = jacobi_eigh(jnp.asarray(H - H[0, 0] * np.eye(S)), sweeps=12)
    g = int(jnp.argmin(w))
    np.testing.assert_allclose(float(lam), float(w[g]) + H[0, 0],
                               rtol=1e-10)
    vj = np.asarray(v[:, g])
    assert min(np.abs(c - vj).max(), np.abs(c + vj).max()) < 1e-7
    # the wrapper's CPU path is the plain version, never converged-flagged
    lam2, c2, failed = gs.ground_state(torch.tensor(H))
    assert torch.equal(lam2, lam) and not bool(failed)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gs.ground_state_cuda(torch.tensor(H))


class _HostSyncs(TorchDispatchMode):
    """Records the operations that synchronize with the host on the card:
    scalar reads, data-dependent shapes, eigh's info check, an indexed
    assignment of a host scalar."""
    SYNC = {"_local_scalar_dense", "nonzero", "masked_select", "_unique2",
            "unique_dim", "unique_consecutive", "repeat_interleave",
            "equal", "is_nonzero", "bincount", "_linalg_eigh"}

    def __init__(self):
        super().__init__()
        self.hits, self.fresh = [], {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[-1]
        bad = name in self.SYNC
        if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            bad = any(i is not None and i.dtype == torch.bool
                      for i in args[1])
            r = self.fresh.get(id(args[2])) if name != "index" else None
            bad = bad or (r is not None and r() is args[2])
        if bad:
            self.hits.append((name, traceback.format_stack()))
        out = func(*args, **(kwargs or {}))
        if name == "lift_fresh":
            self.fresh[id(out)] = weakref.ref(out)
        return out


class _HostTensors(TorchFunctionMode):
    """Records tensors made from host data (a host-to-device copy)."""

    def __init__(self, hits):
        super().__init__()
        self.hits = hits

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("tensor", "as_tensor", "from_numpy", "tolist", "item",
                    "__bool__", "__int__", "__float__", "numpy", "cpu"):
            self.hits.append((name, traceback.format_stack()))
        return func(*args, **(kwargs or {}))


def _scale_deck(tmp, ensemble):
    """400 waters + H3O+ at K = 16: cell lists with on-demand rows, the
    domain repulsion, kernel A's cells and the PME slab, with a small
    tier of 48."""
    ff, top, sim = write_fixture_files(tmp, ensemble=ensemble, msevb="yes",
                                       pme_grid=16, n_output=1,
                                       extra="evb_small_states 48\n")
    frame = make_water_box(400, include_h3o=True, seed=2)
    p = tmp / "in.gro"
    p.write_text(gro.format_gro_frame(frame.title, frame.mol_names,
                                      frame.mol_natom, frame.atom_names,
                                      frame.xyz, frame.box))
    return [str(p), ff, top, sim] + [str(tmp / n) for n in (
        "traj.gro", "log.out", "hop.out", "a.out")]


@pytest.mark.parametrize("deck", ["dense NVT", "scale NVE"])
def test_scan_step_makes_no_host_sync(tmp_path, deck):
    kind, ensemble = deck.split()
    files = (_scale_deck(tmp_path, ensemble) if kind == "scale"
             else _rebuild_deck(tmp_path, ensemble))
    sim = Simulation(*files, device="cpu")
    s = sim.system
    if kind == "scale":
        assert (sim.cells and s.rs_cells and s.pme_scap
                and sim.ms.nlist.celltab is not None)
    tier = "small" if ham.small_state_tier(s) else "full"
    args = (s, sim.cbw, DT, ensemble, 1.0, 300.0, sim.gen, tier)
    ms, _ = integrators.scan_step(sim.ms, *args)
    syncs = _HostSyncs()
    with _HostTensors(syncs.hits), syncs:
        integrators.scan_step(ms, *args)
    # the CPU's ground state is eigh, kernel E's plain version
    bad = [(n, "".join(st[-6:])) for n, st in syncs.hits
           if not any("ground_state_eigh" in f for f in st)]
    assert not bad, bad[0]


def test_graph_plumbing_without_a_card(tmp_path):
    sim = Simulation(*_deck(tmp_path), device="cpu")
    ms = sim.ms
    flat = graphs.leaves(ms)
    assert all(isinstance(t, torch.Tensor) for t in flat)
    assert any(t is ms.state.x for t in flat)
    copy = graphs.with_leaves(ms, (t.clone() for t in flat))
    assert copy.nlist.capacity == ms.nlist.capacity
    assert all(torch.equal(a, b) and a is not b
               for a, b in zip(graphs.leaves(copy), flat))
    assert graphs.signature(copy) == graphs.signature(
        dataclasses.replace(ms, state=dataclasses.replace(ms.state, step=7)))
    assert graphs.signature(dataclasses.replace(
        ms, nlist=dataclasses.replace(ms.nlist, capacity=3))) \
        != graphs.signature(ms)
    # chunk boundaries: n_output 2 here; add checkpoints every 3 steps
    sim.cfg.checkpoint_velocity = 3
    assert [sim._next_chunk(k, 8) for k in range(8)] == [2, 1, 1, 1, 2, 1,
                                                         2, 1]
    sim.cfg.checkpoint_velocity, sim.cfg.n_output = 0, 1000
    assert sim._next_chunk(0, 1000) == integrators.MAX_CHUNK
    # the diagnostics name the capacities and the first bad step
    _, diag = integrators.md_scan(ms, sim.system, sim.cbw, DT, "NVE", 2)
    assert diag.capacities() == ()
    diag.slab_overflow[1] = True
    assert diag.capacities() == (integrators.SLAB_CAP,)
    assert diag.first((integrators.SLAB_CAP,)) == 1
