"""The port's simulation loop against the JAX driver, fp64 on the CPU: the
EVB state-cap regrow with the step redone, and the abort at the cap's
ceiling.

The deck is the 26-water + H3O+ fixture of tests/test_driver_features.py
(13 diabats), with velocities in the .gro so that both packages start from
the same ones, and a state cap of 12: one regrow, to min(80, max(24, 20))
= 24, holds every step."""

import pathlib

import numpy as np
import pytest

from torch_bridge import driver_deck, jax_compiled
from reactive_pb_nn_md_tpu.md.simulation import Simulation as JaxSimulation
from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation

N_WATER, CAP0, CAP1, N_STEPS = 26, 12, 24, 4


def _deck(tmp, extra, n_step=N_STEPS, n_output=2):
    """The fixture deck under `tmp`: the 8 file names of the CLI."""
    return driver_deck(tmp, n_water=N_WATER, msevb="yes", extra=extra,
                       n_step=n_step, n_output=n_output)


def _etot(log):
    return [float(ln.split()[5]) for ln in log.splitlines()
            if ln.startswith(" KE")]


@pytest.fixture(scope="module")
def regrow_runs(tmp_path_factory):
    """(JAX driver, port, port started at the regrown cap) after N_STEPS
    steps from a cap of CAP0, each with its log text."""
    tmp = tmp_path_factory.mktemp("regrow")
    files = _deck(tmp / "jax", f"evb_max_states {CAP0}\n")
    # optimizations off, eager paths compiled: the CPU compile of the
    # reactive chunk is minutes otherwise
    with jax_compiled():
        jsim = JaxSimulation(*files, checkpoint_file=str(tmp / "chk.npz"))
        jsim.run(N_STEPS)
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
