"""The port's run contract against the JAX driver, fp64 on the CPU:
checkpoints and the exact, JAX-written and text restarts, the debug >= 2
hop-file and A-file streams with the EVB diagnostics behind them, and
--dump-forces."""

import pathlib

import jax
import numpy as np
import pytest

from torch_bridge import driver_deck, jax_compiled
from reactive_pb_nn_md_tpu.evb import analysis as jax_analysis
from reactive_pb_nn_md_tpu.evb import enumerate as jax_enumerate
from reactive_pb_nn_md_tpu.evb import topology_ops as jax_topology_ops
from reactive_pb_nn_md_tpu.md.simulation import Simulation as JaxSimulation
from reactive_pb_nn_md_tpu_torch.evb import analysis
from reactive_pb_nn_md_tpu_torch.evb.enumerate import enumerate_diabats
from reactive_pb_nn_md_tpu_torch.evb.topology_ops import (
    build_diabat_topologies, state_topology)
from reactive_pb_nn_md_tpu_torch.io.gro import read_velocity_checkpoint
from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
from reactive_pb_nn_md_tpu_torch.run import cli

CHK = "checkpoint_velocity 3\n"


def _cli_run(files, steps, *extra):
    return cli.main(files + ["--device", "cpu", "--steps", str(steps),
                             *extra])


def _fresh(files):
    for f in files[4:] + ["velocity_checkpoint.npz", "velocity_checkpoint"]:
        pathlib.Path(f).unlink(missing_ok=True)


def _numbers(text):
    """Every whitespace-separated token of `text`: floats where they
    parse, else the token."""
    out = []
    for tok in text.split():
        try:
            out.append(float(tok))
        except ValueError:
            out.append(tok)
    return out


def _same_numbers(a, b, atol):
    ta, tb = _numbers(a), _numbers(b)
    assert len(ta) == len(tb)
    assert [t for t in ta if isinstance(t, str)] == \
        [t for t in tb if isinstance(t, str)]
    np.testing.assert_allclose([t for t in ta if not isinstance(t, str)],
                               [t for t in tb if not isinstance(t, str)],
                               rtol=0, atol=atol)


@pytest.mark.parametrize("ensemble,extra", [
    ("NVE", ""), ("NVT", ""), ("NVE", "compensated_sum yes\n")],
    ids=["NVE", "NVT", "compensated"])
def test_exact_restart(tmp_path, monkeypatch, ensemble, extra):
    """9 steps against 6 + an auto-detected restart of 3: the .npz holds
    the topology, the Kahan carries and the noise generator."""
    monkeypatch.chdir(tmp_path)
    files = driver_deck(tmp_path, ensemble=ensemble, extra=CHK + extra)
    _cli_run(files, 9)
    ref = dict(np.load("velocity_checkpoint.npz"))
    _fresh(files)
    _cli_run(files, 6)
    sim = _cli_run(files, 3)
    assert sim.restart and sim.start_step == 6
    got = dict(np.load("velocity_checkpoint.npz"))
    assert int(got["step"]) == 9
    keys = ["x", "v"] + (["comp_x", "comp_v"] if extra else [])
    for k in keys:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-12)
    assert ("comp_x" in got) == bool(extra)
    np.testing.assert_array_equal(got["torch_generator_state"],
                                  ref["torch_generator_state"])
    log = pathlib.Path(files[5]).read_text()
    assert log.count("reactive_pb_nn_md_tpu_torch simulation") == 1
    assert log.count(f"step {0:10d}") == 1 and f"step {8:10d}" in log
    assert pathlib.Path(files[4]).read_text().count("step ") == 5


def test_jax_npz_continued_by_port(tmp_path):
    """A checkpoint the JAX driver wrote (PRNG key, no generator state)
    continues in the port, against the JAX driver's unbroken run."""
    deck = dict(extra=CHK, n_step=9)
    with jax_compiled():
        jfiles = driver_deck(tmp_path / "jax", **deck)
        JaxSimulation(*jfiles, checkpoint_file=str(tmp_path / "j.npz")).run(6)
        ref = JaxSimulation(*driver_deck(tmp_path / "ref", **deck),
                            checkpoint_file=str(tmp_path / "r.npz"))
        ref.run(9)
    sim = Simulation(*jfiles, device="cpu",
                     checkpoint_file=str(tmp_path / "j.npz"))
    assert sim.restart and sim.start_step == 6
    sim.run(3)
    np.testing.assert_allclose(sim.ms.state.x.numpy(),
                               np.asarray(ref.ms.state.x), rtol=0, atol=1e-9)
    log = pathlib.Path(jfiles[5]).read_text()
    assert "no noise generator state" in log and "reseeded from seed 0" in log
    assert "torch_generator_state" in np.load(tmp_path / "j.npz").files


def test_text_restart(tmp_path):
    """Trajectory tail + text checkpoint alone: the velocities are the
    text block's, and the run continues the same physical trajectory
    (within the .gro rounding, tests/test_driver_features.py's bound)."""
    files = driver_deck(tmp_path / "broken", extra=CHK, n_output=3)
    chk = str(tmp_path / "broken" / "chk.npz")
    sim = Simulation(*files, device="cpu", checkpoint_file=chk)
    sim.run(6)
    step, vel = read_velocity_checkpoint(str(tmp_path / "broken" / "chk"))
    assert step == 6 and vel.shape == (sim.system.n_atoms, 3)
    order = sim._blocks()[3]
    np.testing.assert_allclose(vel, np.load(chk)["v"][order], atol=5e-7)
    pathlib.Path(chk).unlink()
    sim2 = Simulation(*files, device="cpu", checkpoint_file=chk)
    assert sim2.text_restart and not sim2.restart and sim2.start_step == 6
    np.testing.assert_allclose(sim2.ms.state.v.numpy(), vel, atol=5e-7)
    sim2.run(3)
    unbroken = driver_deck(tmp_path / "unbroken", extra=CHK, n_output=3)
    Simulation(*unbroken, device="cpu",
               checkpoint_file=str(tmp_path / "u.npz")).run(9)

    def pe_at(path, step):
        lines = pathlib.Path(path).read_text().splitlines()
        k = lines.index(next(ln for ln in lines
                             if ln.startswith(f"step {step:10d}")))
        return float(lines[k + 1].split()[3])

    assert abs(pe_at(files[5], 9) - pe_at(unbroken[5], 9)) <= 15.0


def test_text_restart_step_mismatch_stops(tmp_path):
    files = driver_deck(tmp_path, extra=CHK, n_output=3)
    chk = str(tmp_path / "chk.npz")
    Simulation(*files, device="cpu", checkpoint_file=chk).run(6)
    pathlib.Path(chk).unlink()
    text = tmp_path / "chk"
    lines = text.read_text().splitlines()
    starts = [k for k, ln in enumerate(lines) if ln.startswith("step")]
    text.write_text("\n".join(lines[:starts[1]]) + "\n")
    with pytest.raises(ValueError, match="last step differs"):
        Simulation(*files, device="cpu", checkpoint_file=chk)


def test_fresh_run_empties_a_stale_text_checkpoint(tmp_path):
    files = driver_deck(tmp_path, extra=CHK)
    stale = tmp_path / "chk"
    stale.write_text("step  300\n")
    Simulation(*files, device="cpu",
               checkpoint_file=str(tmp_path / "chk.npz")).run(3)
    assert stale.read_text().startswith("step  3\n")


def test_unknown_ensemble_is_refused(tmp_path):
    with pytest.raises(ValueError, match="ensemble 'NVX'"):
        Simulation(*driver_deck(tmp_path, ensemble="NVX"), device="cpu")


@pytest.fixture(scope="module")
def debug_runs(tmp_path_factory):
    """The JAX driver and the port on the reactive 26-water deck at
    debug 2, both run for 0 steps (the step-0 output: log block, hop-file
    H-bond line, A-file), and step 0's forces dumped by each."""
    tmp = tmp_path_factory.mktemp("debug")
    deck = dict(msevb="yes", n_water=26, extra="debug 2\n")
    out = {}
    with jax_compiled():
        files = driver_deck(tmp / "jax", **deck)
        jsim = JaxSimulation(*files, checkpoint_file=str(tmp / "j.npz"))
        jsim.run(0)
        jsim.dump_forces(str(tmp / "jax" / "forces.out"), 0)
    out["jax"] = (jsim, files)
    files = driver_deck(tmp / "port", **deck)
    sim = Simulation(*files, device="cpu", checkpoint_file=str(tmp / "p.npz"))
    sim.run(0)
    sim.dump_forces(str(tmp / "port" / "forces.out"), 0)
    out["port"] = (sim, files)
    return out


def test_debug2_streams_match_jax(debug_runs):
    (jsim, jfiles), (sim, files) = debug_runs["jax"], debug_runs["port"]
    a_port = pathlib.Path(files[7]).read_text()
    a_jax = pathlib.Path(jfiles[7]).read_text()
    assert a_port.count("Donor Coordinates") == int(sim.ms.n_states) - 1 > 3
    _same_numbers(a_port, a_jax, 1e-8)
    assert pathlib.Path(files[6]).read_text() == \
        pathlib.Path(jfiles[6]).read_text()
    # the step-0 block of the log, line for line (blank lines included)
    blocks = []
    for f in (files[5], jfiles[5]):
        text = pathlib.Path(f).read_text()
        blocks.append(text[text.index(f"step {0:10d}"):
                           text.index("completed")].splitlines())
    assert [ln.split()[:1] for ln in blocks[0]] == \
        [ln.split()[:1] for ln in blocks[1]]
    _same_numbers("\n".join(blocks[0]), "\n".join(blocks[1]), 2e-6)
    assert sum("diabat" in ln for ln in blocks[0]) == \
        int(sim.ms.n_states) + 2


def test_hbond_network_and_diabat_report_match_jax(debug_runs):
    (jsim, _), (sim, _) = debug_runs["jax"], debug_runs["port"]
    jms, ms = jsim.ms, sim.ms
    assert analysis.hbond_network(ms.state.x, ms.state.box, ms.topo,
                                  sim.system) == \
        jax_analysis.hbond_network(jms.state.x, jms.state.box, jms.topo,
                                   jsim.system)
    rows = analysis.diabat_report(ms.hydronium_of, ms.n_hops_of,
                                  ms.eigenvector, ms.n_states)
    jrows = jax_analysis.diabat_report(jms.hydronium_of, jms.n_hops_of,
                                       jms.eigenvector, jms.n_states)
    assert [r[:2] + r[3:] for r in rows] == [r[:2] + r[3:] for r in jrows]
    np.testing.assert_allclose([r[2] for r in rows], [r[2] for r in jrows],
                               rtol=0, atol=1e-10)
    assert analysis.format_diabat_report(7, rows).splitlines()[0] == \
        f" i_step 7 number of diabats {len(rows)}"


def test_zundel_diagnostics_match_jax(debug_runs):
    """Every non-principle diabat's A factor (to 1e-12) and Zundel
    coordinates (to 1e-9 A) from the port's enumeration and the JAX
    package's, on the same state."""
    (jsim, _), (sim, _) = debug_runs["jax"], debug_runs["port"]
    jms, ms = jsim.ms, sim.ms
    with jax_compiled():     # the react rows, as the A-file's enumeration
        jd = jax_enumerate.enumerate_diabats(
            jms.state.x, jms.state.box, jms.topo, jsim.system,
            full_idx=jms.nlist.react_idx)
        jb = jax_topology_ops.build_diabat_topologies(jms.topo, jd,
                                                      jsim.system)
    d = enumerate_diabats(ms.state.x, ms.state.box, ms.topo, sim.system,
                          ms.nlist.react_idx)
    b = build_diabat_topologies(ms.topo, d, sim.system)
    n = int(d.n_states)
    assert n == int(jd.n_states) > 3
    hop_log = d.hop_log.numpy()
    np.testing.assert_array_equal(hop_log[:n], np.asarray(jd.hop_log)[:n])
    for s in range(1, n):
        hop = hop_log[s, int(d.n_hops[s]) - 1]
        args = (hop[0], hop[3], hop[1])
        kw = dict(d_heavy=hop[2], a_heavy=hop[4])
        got = analysis.zundel_diagnostics(
            ms.state.x, ms.state.box, state_topology(b.topo, s), sim.system,
            *args, **kw)
        want = jax_analysis.zundel_diagnostics(
            jms.state.x, jms.state.box,
            jax.tree_util.tree_map(lambda t: t[s], jb.topo),
            jsim.system, *(int(a) for a in args),
            **{k: int(v) for k, v in kw.items()})
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
        assert got[1] == want[1] and got[3] == want[3]
        for i in (2, 4):
            np.testing.assert_allclose(got[i], np.asarray(want[i]), rtol=0,
                                       atol=1e-9)


def test_force_dump_matches_jax(debug_runs):
    (_, jfiles), (sim, files) = debug_runs["jax"], debug_runs["port"]
    got = (pathlib.Path(files[0]).parent / "forces.out").read_text()
    want = (pathlib.Path(jfiles[0]).parent / "forces.out").read_text()
    _same_numbers(got, want, 2e-6)
    assert len(got.splitlines()) == sim.system.n_atoms + 1


def test_cli_debug2_and_dump_forces(tmp_path, monkeypatch):
    """4 reactive steps through the CLI, output every 2: a Donor block per
    non-principle diabat and a hop-file H-bond line at each output step,
    and a fresh force dump whose last rows are the final forces."""
    monkeypatch.chdir(tmp_path)
    files = driver_deck(tmp_path, msevb="yes", n_water=26,
                        extra="debug 2\n")
    dump = tmp_path / "forces.out"
    dump.write_text("stale\n")
    sim = _cli_run(files, 4, "--dump-forces", str(dump))
    a_text = pathlib.Path(files[7]).read_text()
    blocks = a_text.split("step ")[1:]
    assert [b.split()[0] for b in blocks] == ["0", "2", "4"]
    assert blocks[-1].count("Donor Coordinates") == \
        blocks[-1].count("Acceptor Coordinates") == int(sim.ms.n_states) - 1
    hops = [ln for ln in pathlib.Path(files[6]).read_text().splitlines()
            if "number of acceptors" in ln]
    assert [ln.split()[1] for ln in hops] == ["0", "2", "4"]
    text = dump.read_text()
    assert "stale" not in text and text.count("step ") == 2
    rows = np.array([ln.split()[2:5] for ln in text.splitlines()
                     [-sim.system.n_atoms:]], dtype=float)
    np.testing.assert_allclose(rows, sim.ms.force.numpy(), rtol=0,
                               atol=1e-6)
