"""The port's simulation loop against the JAX driver, fp64 on the CPU: the
EVB state-cap regrow with the step redone, the abort at the cap's ceiling,
and the deck keys the port refuses rather than ignores.

The deck is the 26-water + H3O+ fixture of tests/test_driver_features.py
(13 diabats), with velocities in the .gro so that both packages start from
the same ones, and a state cap of 12: one regrow, to min(80, max(24, 20))
= 24, holds every step."""

import pathlib

import jax
import numpy as np
import pytest

from fixtures import make_water_box, write_fixture_files
from reactive_pb_nn_md_tpu.io.gro import format_gro_frame
from reactive_pb_nn_md_tpu.md.simulation import Simulation as JaxSimulation
from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation

N_WATER, CAP0, CAP1, N_STEPS = 26, 12, 24, 4


def _deck(tmp, extra, n_step=N_STEPS, n_output=2):
    """The fixture deck under `tmp`: the 8 file names of the CLI."""
    tmp.mkdir(parents=True, exist_ok=True)
    ff, top, sim = write_fixture_files(tmp, msevb="yes", n_step=n_step,
                                       n_output=n_output, extra=extra)
    frame = make_water_box(N_WATER, include_h3o=True, seed=5, jitter=0.05)
    v = np.random.default_rng(7).standard_normal(frame.xyz.shape) * 5.0
    gro = tmp / "box.gro"
    gro.write_text(format_gro_frame(frame.title, frame.mol_names,
                                    frame.mol_natom, frame.atom_names,
                                    frame.xyz, frame.box, velocities=v))
    return [str(gro), ff, top, sim] + [str(tmp / n) for n in (
        "traj.gro", "log.out", "hop.out", "a.out")]


def _etot(log):
    return [float(ln.split()[5]) for ln in log.splitlines()
            if ln.startswith(" KE")]


@pytest.fixture(scope="module")
def regrow_runs(tmp_path_factory):
    """(JAX driver, port, port started at the regrown cap) after N_STEPS
    steps from a cap of CAP0, each with its log text."""
    tmp = tmp_path_factory.mktemp("regrow")
    files = _deck(tmp / "jax", f"evb_max_states {CAP0}\n")
    # optimizations off: the CPU compile of the reactive chunk is minutes
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jsim = JaxSimulation(*files, checkpoint_file=str(tmp / "chk.npz"))
        jsim.run(N_STEPS)
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)
    out = [(jsim, pathlib.Path(files[5]).read_text())]
    for name, cap in (("port", CAP0), ("port_at_cap1", CAP1)):
        files = _deck(tmp / name, f"evb_max_states {cap}\n")
        sim = Simulation(*files, device="cpu")
        sim.run(N_STEPS)
        out.append((sim, pathlib.Path(files[5]).read_text()))
    return out


def test_state_cap_regrow_matches_jax(regrow_runs):
    (jsim, jlog), (sim, log), (ref, ref_log) = regrow_runs
    want = ("step 0: diabat enumeration exceeded the state cap; "
            f"evb_max_states regrown to {CAP1}")
    assert want in log and want in jlog
    assert sim.system.evb_max_states == jsim.system.evb_max_states == CAP1
    assert CAP1 == min(sim.cfg.evb_hard_max_states, max(2 * CAP0, CAP0 + 8))
    assert "regrown" not in ref_log
    assert f"completed {N_STEPS} steps" in log
    x = sim.ms.state.x.numpy()
    np.testing.assert_allclose(x, np.asarray(jsim.ms.state.x), rtol=0,
                               atol=1e-9)
    e, je = _etot(log), _etot(jlog)
    assert len(e) == len(je) == N_STEPS // 2 + 1
    np.testing.assert_allclose(e, je, rtol=1e-10)
    # the replayed step leaves no trace: the run equals one started at the
    # regrown cap
    np.testing.assert_allclose(x, ref.ms.state.x.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(e, _etot(ref_log), rtol=1e-12)


def test_state_cap_ceiling_aborts_without_raising(tmp_path):
    """At evb_hard_max_states the run ends with the JAX driver's abort line
    (tests/test_driver_features.py: test_evb_state_hard_ceiling_aborts)."""
    files = _deck(tmp_path, "evb_max_states 3\nevb_hard_max_states 3\n",
                  n_step=6)
    sim = Simulation(*files, device="cpu")
    sim.run(6)
    log = pathlib.Path(files[5]).read_text()
    assert ("step 1: diabat enumeration exceeded evb_hard_max_states=3 -- "
            "aborting") in log
    assert "completed 1 steps" in log
    assert sim.system.evb_max_states == 3


@pytest.mark.parametrize("case", ["checkpoint_velocity", "debug",
                                  "velocity_checkpoint.npz",
                                  "velocity_checkpoint"])
def test_unported_deck_keys_are_refused(tmp_path, case):
    """Deck keys and files the JAX driver acts on raise a ValueError that
    names them, before anything is written."""
    extra = {"checkpoint_velocity": "checkpoint_velocity 2\n",
             "debug": "debug 2\n"}.get(case, "")
    files = _deck(tmp_path, extra)
    if case.startswith("velocity_checkpoint"):
        # the JAX driver's restart conditions: the trajectory beside its
        # .npz, or beside the log and a non-empty text checkpoint
        for f in (files[4], files[5]):
            pathlib.Path(f).write_text("step 2\n")
        (tmp_path / case).write_text("step 2\n")
    with pytest.raises(ValueError, match=case):
        Simulation(*files, device="cpu")
    if not case.startswith("velocity_checkpoint"):
        assert not pathlib.Path(files[4]).exists()
