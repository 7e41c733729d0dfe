"""The port's run scripts (reactive_pb_nn_md_tpu_torch/run/) against the
JAX package's scripts and files, on the CPU in fp64 at small size:

  * run/presets.build_water(26, 16, "fp64") equals the JAX package's
    __graft_entry__._build(26, 16, precision="fp64") leaf by leaf through
    convert (velocities aside: the generators differ);
  * run/parity_reference.py's dump of the 8-water PME 12^3 fixture deck
    against the JAX scripts/parity_reference.py engine_dump: the JAX
    diff_dumps accepts the pair both ways, energies and H within 1e-10
    relative, forces 1e-10; the port's diff gives the same verdicts and
    rejects a perturbed dump;
  * the npz layout: the file run/equilibrate.py writes reads into equal
    leaves by the JAX bench.load_equilibrated and by
    convert.load_equilibrated_npz, and the drift study's save= file loads
    in the JAX scripts/drift_study.py _load_state;
  * run/equilibrate.py at tiny counts on 26 waters (2 quench stages of 1
    chunk of 4 steps, 16 ramp steps, 2 validation chunks): it ends clean,
    each rescale hits its ramp's kinetic energy to 1e-12 relative, and
    the saved state is the window's start (its 2 chunks replayed from the
    file give the window's end);
  * run/spontaneous_hops.hop_events and nonfinite_steps on synthetic
    rows;
  * every new entry point defaults to the card, and the acid
    configurations are refused with the blocked message.

The JAX side's force evaluations run compiled with optimizations off
(torch_bridge.jax_compiled), or are left out where only the arrays they
would start from are compared.
"""

import importlib.util
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from fixtures import make_water_box, write_fixture_files
from torch_bridge import jax_compiled, jax_tree
from reactive_pb_nn_md_tpu.io.gro import format_gro_frame
from reactive_pb_nn_md_tpu_torch.convert import (from_numpy_tree,
                                                 load_equilibrated_npz,
                                                 save_state_npz)
from reactive_pb_nn_md_tpu_torch.md import integrators, velocities
from reactive_pb_nn_md_tpu_torch.run import (cell_occupancy, drift_study,
                                             equilibrate, parity_reference,
                                             presets, scale_run,
                                             spontaneous_hops)
from reactive_pb_nn_md_tpu_torch.utils.constants import KB

ROOT = pathlib.Path(__file__).resolve().parents[1]
# tiny equilibration: (quench stages, chunks a stage, chunk, ramp steps,
# validation chunks)
TINY = dict(quench_divs=(40, 20), quench_chunks=1, chunk=4,
            validate_chunks=2)
TINY_STEPS = 16
DUMP_TOL = 1e-10


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same(a, b, path="system"):
    if hasattr(a, "__dataclass_fields__") and not isinstance(a, type):
        assert type(a) is type(b), path
        for f in a.__dataclass_fields__:
            _assert_same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, (path, a, b)


class _Recorded(types.SimpleNamespace):
    """The arguments the JAX initial_md_state was called with, standing in
    for its MDState (state, topo, nlist capacities; replace() as a
    pytree dataclass has it)."""

    def replace(self, **kw):
        return _Recorded(**{**vars(self), **kw})


@pytest.fixture(scope="module")
def jax_build26():
    """The JAX _build(26, 16, fp64) with its initial_md_state replaced by
    a record of its arguments (its force evaluation is not compared
    here): (system, cbw, cfg, ms-like with state, topo, nlist)."""
    from reactive_pb_nn_md_tpu.md import integrators as ji
    graft = _load("graft_entry", "__graft_entry__.py")

    def record(state, topo, system, cbw, capacity, **kw):
        return _Recorded(
            state=state, topo=topo, nlist=types.SimpleNamespace(
                capacity=capacity, cells=kw.get("cells") or (),
                react_cap=kw.get("react_cap") or 0),
            kw=kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ji, "initial_md_state", record)
        return graft._build(26, 16, precision="fp64")


@pytest.fixture(scope="module")
def build26():
    return presets.build_water(26, 16, "fp64", device="cpu")


def test_build_water_equals_jax_build(jax_build26, build26):
    jsys, jcbw, jcfg, jms = jax_build26
    system, cbw, cfg, ms = build26
    ref_sys, ref_topo = from_numpy_tree(jax_tree(jsys, jms.topo), "cpu")
    _assert_same(system, ref_sys)
    # the port's initial state has the topology after its set-up (the
    # principle diabat's, unchanged at the lattice)
    _assert_same(ms.topo, ref_topo, "topo")
    assert torch.equal(ms.state.x, torch.tensor(np.asarray(jms.state.x)))
    assert torch.equal(ms.state.box,
                       torch.tensor(np.asarray(jms.state.box)))
    assert ms.state.step == int(jms.state.step) == 0
    np.testing.assert_allclose(cbw.numpy(), np.asarray(jcbw), rtol=1e-14,
                               atol=0)
    assert ms.nlist.capacity == jms.nlist.capacity and not jms.kw
    assert (cfg.pme_grid, cfg.precision, cfg.delta_t) == \
        (jcfg.pme_grid, jcfg.precision, jcfg.delta_t)
    # the velocities: another generator, the same rule (300 K exactly, no
    # net momentum)
    v, m = ms.state.v, system.mass
    ndof = 3 * system.n_atoms
    assert abs(float(velocities.kinetic_energy(v, m)) / (0.5 * ndof * KB)
               - 300.0) < 1e-9
    assert float((m[:, None] * v).sum(0).abs().max()) < 1e-10


def test_water_deck_files(tmp_path):
    gro, ff, top, sim = presets.water_deck(tmp_path, 26, 16, "fp32",
                                           evb_max_states=32,
                                           compensated=True)
    (tmp_path / "ref").mkdir()
    ref = write_fixture_files(tmp_path / "ref", msevb="yes", cutoff=4.5,
                              verlet_cutoff=5.5, alpha=0.7, pme_grid=16)
    assert pathlib.Path(ff).read_text() == pathlib.Path(ref[0]).read_text()
    assert pathlib.Path(top).read_text() == pathlib.Path(ref[1]).read_text()
    want = pathlib.Path(ref[2]).read_text().replace("fp64", "fp32") + \
        "evb_max_states   32\ncompensated_sum   yes\n"
    assert pathlib.Path(sim).read_text() == want
    frame = make_water_box(26, include_h3o=True, seed=0)
    assert pathlib.Path(gro).read_text() == format_gro_frame(
        frame.title, frame.mol_names, frame.mol_natom, frame.atom_names,
        frame.xyz, frame.box)


# ---- the parity dump


def _deck(tmp_path, seed=1, n_water=8):
    """tests/test_parity_dump.py's deck: 8 waters + H3O+, PME 12^3."""
    ff_p, top_p, sim_p = write_fixture_files(tmp_path, msevb="yes",
                                             pme_grid=12, n_step=0)
    frame = make_water_box(n_water, include_h3o=True, seed=seed)
    gro_p = tmp_path / "box.gro"
    gro_p.write_text(format_gro_frame(
        "parity deck", frame.mol_names, frame.mol_natom, frame.atom_names,
        frame.xyz, frame.box))
    return str(gro_p), ff_p, top_p, sim_p


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """(port dump, JAX dump, the JAX parity module) of the 8-water deck;
    the JAX evaluation compiled whole (optimizations off)."""
    import jax
    from reactive_pb_nn_md_tpu.evb import hamiltonian as jham
    jpar = _load("parity_reference", "scripts/parity_reference.py")
    deck = _deck(tmp_path_factory.mktemp("parity"))
    with jax_compiled(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jham, "adiabatic_energy_force",
                   jax.jit(jham.adiabatic_energy_force))
        ref = jpar.engine_dump(*deck)
    got = json.loads(json.dumps(parity_reference.engine_dump(
        *deck, device="cpu")))
    return got, ref, jpar


def test_parity_dump_equals_jax_dump(dumps):
    got, ref, jpar = dumps
    assert got.keys() == ref.keys()
    assert got["schema"] == ref["schema"]
    assert got["deck"] == ref["deck"]
    for k in ("n_atoms", "n_states", "hydronium_mol"):
        assert got[k] == ref[k], k
    assert got["n_states"] >= 2
    perm = parity_reference._match_states(got["diabat_signature"],
                                          ref["diabat_signature"])
    assert None not in perm
    p = np.asarray(perm)
    assert [ref["diabat_hydronium"][j] for j in perm] == \
        got["diabat_hydronium"]
    Hg, Hr = np.asarray(got["H_kjmol"]), np.asarray(ref["H_kjmol"])[
        np.ix_(p, p)]
    scale = np.maximum(1.0, np.abs(Hr))
    assert (np.abs(Hg - Hr) / scale).max() <= DUMP_TOL
    e, er = got["ground_energy_kjmol"], ref["ground_energy_kjmol"]
    assert abs(e - er) <= DUMP_TOL * abs(er)
    for k, v in ref["breakdown"].items():
        assert abs(got["breakdown"][k] - v) <= DUMP_TOL * max(1.0, abs(v)), k
    F, Fr = np.asarray(got["force_kjmol_per_A"]), np.asarray(
        ref["force_kjmol_per_A"])
    assert np.abs(F - Fr).max() <= DUMP_TOL
    c, cr = np.asarray(got["eigenvector"]), np.asarray(ref["eigenvector"])[p]
    assert min(np.abs(c - cr).max(), np.abs(c + cr).max()) <= 1e-9


def test_parity_diff_both_ways_and_on_a_perturbed_dump(dumps):
    got, ref, jpar = dumps
    for a, b in ((got, ref), (ref, got)):
        ok_jax, rep = jpar.diff_dumps(a, b, verbose=False)
        ok_port, rep_port = parity_reference.diff_dumps(a, b, verbose=False)
        assert ok_jax and ok_port, rep + rep_port
    bad_f = json.loads(json.dumps(got))
    bad_f["force_kjmol_per_A"][3][1] += 1e-3
    bad_h = json.loads(json.dumps(got))
    bad_h["H_kjmol"][1][1] *= 1.01
    bad_s = json.loads(json.dumps(got))
    bad_s["diabat_signature"][1] = [[99, 98]]
    for bad in (bad_f, bad_h, bad_s):
        ok_jax, _ = jpar.diff_dumps(bad, ref, verbose=False)
        ok_port, rep = parity_reference.diff_dumps(bad, ref, verbose=False)
        assert not ok_jax and not ok_port
        assert any(r.startswith("FAIL") for r in rep)


def test_parity_cli_round_trip(dumps, tmp_path, capsys):
    got, ref, _ = dumps
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(got))
    b.write_text(json.dumps(ref))
    assert parity_reference.main(["diff", str(a), str(b)]) == 0
    bad = json.loads(json.dumps(ref))
    bad["ground_energy_kjmol"] += 1.0
    b.write_text(json.dumps(bad))
    assert parity_reference.main(["diff", str(a), str(b)]) == 1
    assert parity_reference.main(["check-toolchain"]) == 0
    assert "FAIL ground energy" in capsys.readouterr().out


# ---- equilibrate and the npz layout


@pytest.fixture(scope="module")
def tiny_eq(build26):
    return equilibrate.equilibrate(build26, TINY_STEPS, seed=0,
                                   log=lambda m: None, **TINY)


def test_equilibrate_tiny_ends_clean(tiny_eq, build26):
    res = tiny_eq
    system = build26[0]
    chunk = TINY["chunk"]
    n_quench = len(TINY["quench_divs"]) * TINY["quench_chunks"] * chunk
    assert res["steps"] == {"quench": n_quench, "rescaled": TINY_STEPS,
                            "window": TINY["validate_chunks"] * chunk}
    assert res["start"].state.step == n_quench + TINY_STEPS
    assert res["ms"].state.step == res["start"].state.step + \
        TINY["validate_chunks"] * chunk
    assert res["regrows"] == [] and res["max_states"] >= 2
    assert not integrators.overflowed(res["ms"])
    assert torch.isfinite(res["ms"].potential)
    # each rescale hits its ramp: 50 K -> 300 K over the first half
    ndof = 3 * system.n_atoms - 3
    ke300 = 0.5 * ndof * KB * 300.0
    steps = [r[0] for r in res["rescales"]]
    assert steps == list(range(chunk, TINY_STEPS + 1, chunk))
    for done, kt, ke in res["rescales"]:
        frac = min(1.0, done / (TINY_STEPS // 2))
        want = ke300 * (50.0 + 250.0 * frac) / 300.0
        assert abs(kt - want) <= 1e-12 * want
        assert abs(ke - want) <= 1e-12 * want
    assert abs(equilibrate.temperature(res["start"], system) - 300.0) \
        < 1e-9


def test_equilibrate_saves_the_window_start(tiny_eq, build26, tmp_path):
    res = tiny_eq
    path = tmp_path / "eq.npz"
    save_state_npz(path, res["start"], res["system"], seed=0)
    state, topo, meta = load_equilibrated_npz(path, "cpu")
    assert torch.equal(state.x, res["start"].state.x)
    assert torch.equal(state.v, res["start"].state.v)
    assert not torch.equal(state.x, res["ms"].state.x)
    assert state.step == res["start"].state.step
    # the window replayed from the file ends where the window ended
    system, cbw, cfg, _ = build26
    system, cbw, cfg, ms = presets.equilibrated(
        (res["system"], cbw, cfg, build26[3]), path)
    caps = integrators.capacities_of(ms)
    for _ in range(TINY["validate_chunks"]):
        r = integrators.regrown_chunk(
            ms, system, cbw, caps, cfg.evb_hard_max_states, cfg.delta_t,
            "NVE", TINY["chunk"], tolerate=(integrators.EVB_STATE_CAP,))
        ms, system, caps = r.ms, r.system, r.caps
        assert r.regrows == 0
    assert float((ms.state.x - res["ms"].state.x).abs().max()) <= 1e-12
    assert meta["capacity"] == res["start"].nlist.capacity
    assert meta["rs_cells"] == res["system"].rs_cells


def test_npz_read_both_ways(tiny_eq, jax_build26, tmp_path):
    """The equilibrate writer's file into the JAX bench.load_equilibrated
    (its set-up replaced by a record of its arguments) and into
    convert.load_equilibrated_npz: equal leaves and capacities."""
    from reactive_pb_nn_md_tpu.md import integrators as ji
    bench = _load("bench", "bench.py")
    res = tiny_eq
    path = tmp_path / "eq.npz"
    save_state_npz(path, res["start"], res["system"], seed=0)
    data = np.load(path)
    assert sorted(data.files) == sorted(
        [f"l{i}" for i in range(13)] + [
            "meta_capacity", "meta_cells", "meta_react_cap",
            "meta_react_cells", "meta_rs_cells", "meta_pme_scap"])
    assert data["l3"].dtype == np.uint32 and data["l3"].shape == (2,)
    assert data["l4"].dtype == np.int32 and data["l4"].shape == ()
    jsys, jcbw, _, jms = jax_build26
    captured = {}

    def record(state, topo, system, cbw, capacity, **kw):
        captured.update(state=state, topo=topo, system=system,
                        capacity=capacity, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ji, "initial_md_state", record)
        _, jsys2 = bench.load_equilibrated(jms, jsys, jcbw, path)
    state, topo, meta = load_equilibrated_npz(path, "cpu")
    js, jt = captured["state"], captured["topo"]
    for name in ("x", "v", "box"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(state, name).numpy())
    assert int(js.step) == state.step
    assert np.asarray(js.key).shape == (2,)
    for name in ("mol_mtype", "mol_natom", "mol_atoms", "atom_mol",
                 "atom_slot", "atom_type", "charge", "hydronium_mol"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)),
                                      getattr(topo, name).numpy(), name)
    assert captured["capacity"] == meta["capacity"]
    assert tuple(captured["cells"] or ()) == meta["cells"]
    assert (captured["react_cap"] or 0) == meta["react_cap"]
    assert tuple(jsys2.rs_cells) == meta["rs_cells"]
    assert jsys2.pme_scap == meta["pme_scap"]


def test_drift_save_loads_in_jax(build26, jax_build26, tmp_path,
                                 monkeypatch):
    """drift_study's save= on the 26-water box (its build swapped in): 13
    leaves, which the JAX drift study's _load_state takes."""
    jdrift = _load("drift_study", "scripts/drift_study.py")
    monkeypatch.setattr(drift_study, "build", lambda *a, **k: build26)
    path = tmp_path / "drift_eq.npz"
    assert drift_study.run("cpu-fp64", 0, "reactive", 8, save=str(path),
                           chunk=4, log=lambda m: None) is None
    assert sorted(np.load(path).files) == sorted(f"l{i}" for i in range(13))
    jms = jax_build26[3]
    out = jdrift._load_state(str(path), jms)
    state, topo, _ = load_equilibrated_npz(path, "cpu")
    np.testing.assert_array_equal(np.asarray(out.state.x), state.x.numpy())
    np.testing.assert_array_equal(np.asarray(out.state.v), state.v.numpy())
    np.testing.assert_array_equal(np.asarray(out.topo.atom_mol),
                                  topo.atom_mol.numpy())
    assert int(out.state.step) == state.step == 8
    # loaded back into the port's study, set up at the build's capacities
    b = drift_study.load(build26, path)
    assert torch.equal(b[3].state.x, state.x)
    assert b[3].nlist.capacity == build26[3].nlist.capacity


# ---- hop events, entry points


def test_hop_events_from_rows():
    hopped = [False, True, False, False, True, True]
    hyd = [4, 9, 9, 9, 2, 4]
    ns = [10, 12, 11, 13, 14, 15]
    ev = spontaneous_hops.hop_events(hopped, hyd, ns, first_step=129,
                                     dt=0.0005, prev=4)
    assert [(e["step"], e["from_mol"], e["to_mol"], e["n_states"])
            for e in ev] == [(130, 4, 9, 12), (133, 9, 2, 14),
                             (134, 2, 4, 15)]
    assert [e["time_ps"] for e in ev] == [0.065, 0.0665, 0.067]
    # a hop at the chunk's first step reads from the state before it
    ev = spontaneous_hops.hop_events([True], [3], [8], 1, 0.0005, prev=7)
    assert (ev[0]["from_mol"], ev[0]["to_mol"]) == (7, 3)
    assert spontaneous_hops.hop_events([False] * 3, [1] * 3, [2] * 3, 1,
                                       0.0005, 1) == []


def test_regrow_leaves_tolerated_and_ceiling_flags():
    """integrators.to_grow: the run scripts tolerate the state cap, and a
    state cap at its ceiling cannot grow; every other flag is grown."""
    caps = integrators.CAPACITIES
    below = types.SimpleNamespace(evb_max_states=32)
    at = types.SimpleNamespace(evb_max_states=80)
    assert integrators.to_grow(caps, below, 80) == caps
    assert integrators.to_grow(caps, at, 80) == caps[:-1]
    assert integrators.to_grow(caps, below, 80,
                               (integrators.EVB_STATE_CAP,)) == caps[:-1]
    assert integrators.to_grow((integrators.SLAB_CAP,), below, 80,
                               (integrators.SLAB_CAP,)) == ()


def test_nonfinite_steps_are_counted():
    """A window whose surface blew up stops and is not clean: its
    non-finite steps are counted (NaN forces pass the 1e4 test), and a
    chunk where kernel E did not converge stops it too."""
    nan, inf = float("nan"), float("inf")
    diag = types.SimpleNamespace(
        potential=torch.tensor([1.0, nan, nan, 2.0]),
        kinetic=torch.tensor([1.0, 1.0, nan, inf]))
    assert spontaneous_hops.nonfinite_steps(diag) == 3
    assert spontaneous_hops.window_chunk(lambda: diag) == (
        diag, "3 non-finite steps")

    def fails():
        raise integrators.GroundStateError("step 9: no convergence")

    assert spontaneous_hops.window_chunk(fails) == (
        None, "step 9: no convergence")
    diag.potential[:] = 1.0
    diag.kinetic[:] = 1.0
    assert spontaneous_hops.nonfinite_steps(diag) == 0
    assert spontaneous_hops.window_chunk(lambda: diag) == (diag, None)


@pytest.mark.parametrize("entry", [
    (equilibrate, ["flagship", "10", "eq.npz"]),
    (scale_run, []),
    (cell_occupancy, []),
    (spontaneous_hops, ["--scan"]),
    (parity_reference, ["dump", "a", "b", "c", "d"]),
    (drift_study, ["cuda-fp64", "40", "reactive", "0"]),
], ids=lambda e: e[0].__name__.rsplit(".", 1)[-1])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults succeed")
    mod, argv = entry
    with pytest.raises(SystemExit, match="CUDA is not available"):
        mod.main(argv)


@pytest.mark.parametrize("config", ["acid", "acid5k"])
def test_acid_configs_are_blocked(config):
    with pytest.raises(SystemExit, match="blocked: CH3SO3H files not in"):
        equilibrate.main([config, "10", "out.npz", "--device", "cpu"])
