"""The port's NVT, compensated and NPT integration against the JAX package,
fp64 on the CPU: the Langevin half kick with the JAX package's own draws,
three NVT steps (non-reactive and on the reactive 26-water fixture), the
Kahan-compensated step, and an NPT run whose barostat makes the JAX
package's decisions; then the barostat's forced acceptance, adaptation
and cell-grid refit on the port alone."""

import dataclasses
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import driver_deck, jax_compiled
from reactive_pb_nn_md_tpu.md import integrators as jax_int
from reactive_pb_nn_md_tpu.md.simulation import Simulation as JaxSimulation
from reactive_pb_nn_md_tpu_torch.md import integrators
from reactive_pb_nn_md_tpu_torch.md.barostat import MCBarostat
from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
from reactive_pb_nn_md_tpu_torch.utils.constants import (
    CONV_KJMOL_A2PS2GMOL, KB)

DT, FRICTION, TEMP = 0.0005, 1.0, 300.0


def _pair(tmp, name, **deck):
    """(JAX Simulation, port Simulation) on one deck."""
    with jax_compiled():
        jsim = JaxSimulation(*driver_deck(tmp / "jax" / name, **deck),
                             checkpoint_file=str(tmp / f"{name}.npz"))
    sim = Simulation(*driver_deck(tmp / "port" / name, **deck),
                     device="cpu", checkpoint_file=str(tmp / f"{name}_p.npz"))
    return jsim, sim


def _etot(ms):
    return float(ms.kinetic) + float(ms.potential)


@pytest.mark.parametrize("friction,temperature", [(1.0, 300.0),
                                                  (8.0, 450.0)])
def test_langevin_half_kick_matches_jax(friction, temperature):
    rng = np.random.default_rng(3)
    n = 64
    v = rng.standard_normal((n, 3)) * 5.0
    f = rng.standard_normal((n, 3)) * 300.0
    mass = rng.uniform(1.0, 16.0, (n, 1))
    key = jax.random.PRNGKey(11)
    want = jax_int.langevin_half_kick(jnp.asarray(v), jnp.asarray(f),
                                      jnp.asarray(mass), key, DT, friction,
                                      temperature)
    g = torch.tensor(np.asarray(jax.random.normal(key, v.shape,
                                                  jnp.float64)))
    got = integrators.langevin_half_kick(
        torch.from_numpy(v), torch.from_numpy(f), torch.from_numpy(mass), g,
        DT, friction, temperature)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=1e-14)


def test_langevin_stationary_variance():
    """Force-free Langevin dynamics samples the Maxwell-Boltzmann
    distribution: per-component variance kT conv / m (tests/test_md.py's
    check, with a torch generator)."""
    n = 512
    mass = torch.full((n, 1), 12.5, dtype=torch.float64)
    v = torch.zeros((n, 3), dtype=torch.float64)
    f = torch.zeros_like(v)
    gen = torch.Generator().manual_seed(0)
    gamma = 8.0
    trace = []
    for _ in range(4000):
        for _ in range(2):
            g = torch.randn((n, 3), generator=gen, dtype=torch.float64)
            v = integrators.langevin_half_kick(v, f, mass, g, 0.002, gamma,
                                               TEMP)
        trace.append(float((v * v).mean()))
    want = KB * TEMP * CONV_KJMOL_A2PS2GMOL / 12.5
    np.testing.assert_allclose(np.mean(trace[1000:]), want, rtol=0.05)


def test_nvt_step_needs_its_draws(tmp_path):
    sim = Simulation(*driver_deck(tmp_path, ensemble="NVT"), device="cpu")
    with pytest.raises(ValueError, match="Gaussian draws"):
        integrators.md_step(sim.ms, sim.system, sim.cbw, DT, "NVT")
    with pytest.raises(ValueError, match="ensemble 'NTP'"):
        integrators.md_step(sim.ms, sim.system, sim.cbw, DT, "NTP")


@pytest.mark.parametrize("msevb,n_water", [("no", 16), ("yes", 26)])
def test_nvt_steps_match_jax(tmp_path, msevb, n_water):
    """Three NVT steps from one state: the port is given the draws the
    JAX md_step makes from its key (split in 3, one normal a half kick)."""
    jsim, sim = _pair(tmp_path, "nvt", ensemble="NVT", msevb=msevb,
                      n_water=n_water)
    jms, ms = jsim.ms, sim.ms
    np.testing.assert_allclose(ms.state.x.numpy(), np.asarray(jms.state.x),
                               rtol=0, atol=1e-12)
    with jax_compiled():
        for _ in range(3):
            _, k1, k2 = jax.random.split(jms.state.key, 3)
            noise = tuple(torch.tensor(np.asarray(jax.random.normal(
                k, jms.state.v.shape, jms.state.v.dtype))) for k in (k1, k2))
            jms = jax_int.md_step(jms, jsim.system, jsim.cbw, DT, "NVT",
                                  FRICTION, TEMP)
            ms = integrators.md_step(ms, sim.system, sim.cbw, DT, "NVT",
                                     FRICTION, TEMP, noise=noise)
            assert not integrators.overflowed(ms)
    if msevb == "yes":
        assert int(ms.n_states) == int(jms.n_states) > 1
    np.testing.assert_allclose(ms.state.x.numpy(), np.asarray(jms.state.x),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(_etot(ms), _etot(jms), rtol=1e-10)


def test_two_sum_add_fp32():
    """A delta below half an ulp of the fp32 accumulator: the plain sum
    loses every add, the compensated one keeps them (tests/test_md.py)."""
    base = torch.tensor(4096.0, dtype=torch.float32)
    delta = torch.tensor(1.0e-4, dtype=torch.float32)
    n = 8192
    acc, c, plain = base, torch.zeros_like(base), base
    for _ in range(n):
        acc, c = integrators.two_sum_add(acc, delta, c)
        plain = plain + delta
    exact = 4096.0 + n * 1.0e-4
    assert abs(float(acc + c) - exact) < 1e-2
    assert abs(float(plain) - exact) > 0.05


def test_compensated_step_from_zero_carry_equals_plain(tmp_path):
    """From zero carries the compensated update does the plain update's
    arithmetic: positions equal bit for bit, velocities to the second
    kick's one rounding."""
    plain = Simulation(*driver_deck(tmp_path / "a"), device="cpu")
    comp = Simulation(*driver_deck(tmp_path / "b",
                                   extra="compensated_sum yes\n"),
                      device="cpu")
    assert comp.system.compensated_sum and not plain.system.compensated_sum
    assert comp.ms.comp is not None and plain.ms.comp is None
    a = integrators.md_step(plain.ms, plain.system, plain.cbw, DT)
    b = integrators.md_step(comp.ms, comp.system, comp.cbw, DT)
    assert torch.equal(a.state.x, b.state.x)
    np.testing.assert_allclose(a.state.v.numpy(), b.state.v.numpy(),
                               rtol=1e-6, atol=1e-9)
    assert float(b.comp.v.abs().max()) > 0.0


def test_compensated_steps_match_jax(tmp_path):
    jsim, sim = _pair(tmp_path, "comp", extra="compensated_sum yes\n")
    jms, ms = jsim.ms, sim.ms
    with jax_compiled():
        for _ in range(3):
            jms = jax_int.md_step(jms, jsim.system, jsim.cbw, DT, "NVE")
            ms = integrators.md_step(ms, sim.system, sim.cbw, DT, "NVE")
    for got, want in ((ms.state.x, jms.state.x), (ms.state.v, jms.state.v),
                      (ms.comp.x, jms.comp.x), (ms.comp.v, jms.comp.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-12)


def test_npt_matches_jax(tmp_path):
    """8 steps at barofreq 2 (trials after steps 2, 4, 6): the port's
    barostat accepts and rejects as the JAX package's, on its draws."""
    jsim, sim = _pair(tmp_path, "npt", ensemble="NPT", n_step=8,
                      extra="barofreq 2\n")
    jaccept = []
    attempt = jsim.barostat.attempt

    def recorded(ms, system, cbw):
        out = attempt(ms, system, cbw)
        jaccept.append(bool(np.any(np.asarray(out[0].state.box)
                                   != np.asarray(ms.state.box))))
        return out

    jsim.barostat.attempt = recorded
    with jax_compiled():
        jsim.run(8)
    sim.run(8)
    accept = [a for _, a in sim.barostat.history]
    assert accept == jaccept and len(accept) == 3
    assert any(accept)
    np.testing.assert_allclose(sim.ms.state.box.numpy(),
                               np.asarray(jsim.ms.state.box), rtol=1e-12)
    np.testing.assert_allclose(sim.ms.state.x.numpy(),
                               np.asarray(jsim.ms.state.x), rtol=0,
                               atol=1e-9)
    log = pathlib.Path(sim.files["log"]).read_text()
    assert log.count("volume(A^3)") == 5


def test_barostat_forced_accept_on_hop(tmp_path):
    """A hop during the trial forces acceptance whatever the weight
    (md_integration.f90:320-323): the proton put 1.0 A from a water
    oxygen, the pressure huge (tests/test_npt.py)."""
    sim = Simulation(*driver_deck(tmp_path, msevb="yes", n_water=26),
                     device="cpu")
    topo = sim.ms.topo
    x = sim.ms.state.x.clone()
    L = torch.diagonal(sim.ms.state.box)
    hyd = int(topo.hydronium_mol)
    o_h3o, h = (int(a) for a in topo.mol_atoms[hyd, :2])
    ow = topo.mol_atoms[:, 0][torch.arange(sim.system.n_mole) != hyd]
    d = x[ow] - x[h]
    d = d - torch.round(d / L) * L
    best = int(ow[torch.argmin((d * d).sum(1))])
    dr = x[best] - x[o_h3o]
    dr = dr - torch.round(dr / L) * L
    x[h] = x[best] - dr / dr.norm()
    # the state moved, its topology not yet switched: the trial hops
    ms = dataclasses.replace(sim.ms, state=dataclasses.replace(sim.ms.state,
                                                               x=x))
    baro = MCBarostat(pressure=1e8, temperature=TEMP, baroscale=1e-6,
                      seed=0)
    ms2, _ = baro.attempt(ms, sim.system, sim.cbw)
    assert baro.n_accept == 1 and baro.history[0][1]
    assert int(ms2.topo.hydronium_mol) != int(ms.topo.hydronium_mol)
    assert np.isfinite(float(ms2.potential))


def test_rejected_barostat_move_keeps_the_system(tmp_path):
    """A rejected trial leaves the System object as it was: another
    object is another graph key (md_scan), and so a capture on the card.
    The trial expands the box by the most its scale allows against a
    huge pressure."""
    sim = Simulation(*driver_deck(tmp_path, ensemble="NPT",
                                  extra="barofreq 2\n"), device="cpu")
    sim.barostat = MCBarostat(pressure=1e8, temperature=TEMP,
                              baroscale=1e-3, seed=0)
    sim.barostat.rng = types.SimpleNamespace(uniform=lambda: 1.0)
    system, box = sim.system, sim.ms.state.box.clone()
    sim._barostat_move(2)
    (_, accepted), = sim.barostat.history
    assert not accepted
    assert sim.system is system
    assert torch.equal(sim.ms.state.box, box)


def test_barostat_trial_is_regrown_before_its_energy(tmp_path):
    """A trial whose neighbor rows overflow is regrown and evaluated again
    by the simulation loop before its dE is used (the plain settle
    raises instead): the same dE as a trial that never overflowed."""
    deck = dict(ensemble="NPT", extra="barofreq 2\n")
    ref = Simulation(*driver_deck(tmp_path / "ref", **deck), device="cpu")
    ref.barostat.attempt(ref.ms, ref.system, ref.cbw)
    sim = Simulation(*driver_deck(tmp_path / "small", **deck), device="cpu")
    small = dataclasses.replace(sim.ms.nlist, capacity=4)
    with pytest.raises(integrators.CapacityOverflow, match="barostat trial"):
        MCBarostat(1.0, TEMP, sim.cfg.baroscale, sim.cfg.seed).attempt(
            dataclasses.replace(sim.ms, nlist=small), sim.system, sim.cbw)
    sim.capacity = 4
    sim._barostat_move(2)
    assert any("regrow (neighbor-list capacity exceeded)" in ln
               for ln in sim._log_lines)
    (de, accepted), = sim.barostat.history
    (want, want_accepted), = ref.barostat.history
    assert accepted == want_accepted and abs(de - want) <= 1e-10


@pytest.mark.parametrize("history,grows", [((11, 11), True),
                                           ((11, 0), False)])
def test_baroscale_adapts(tmp_path, history, grows):
    """Past 10 trials a history outside 25-75% acceptance scales
    baroscale by 1.1 and resets the counters (md_integration.f90:374-384)."""
    sim = Simulation(*driver_deck(tmp_path), device="cpu")
    baro = MCBarostat(pressure=1.0, temperature=TEMP, baroscale=1e-6,
                      seed=2)
    baro.n_trials, baro.n_accept = history
    baro.attempt(sim.ms, sim.system, sim.cbw)
    assert (baro.baroscale > 1e-6) == grows
    assert baro.n_trials == baro.n_accept == 0


def test_cell_grids_refit_to_a_shrunk_box(tmp_path):
    """A grid whose cells a smaller box makes narrower than the cutoff is
    re-derived by its suggest_* rule, with a log line; a grid that still
    fits is kept."""
    sim = Simulation(*driver_deck(tmp_path), device="cpu")
    L = float(sim.ms.state.box[0, 0])
    rc = sim.system.real_space_cutoff
    sim.system = sim.system.replace(rs_cells=(3, 3, 3, 16))
    sim.cells = (2, 2, 2, 40)
    assert sim._fit_grids(sim.ms.state.box * (3.0 * rc + 0.1) / L, 4) == []
    lines = sim._fit_grids(sim.ms.state.box * (3.0 * rc - 0.1) / L, 4)
    assert len(lines) == 1 and lines[0].startswith(
        "step 4: kernel A cell grid (3, 3, 3, 16) has cells narrower")
    assert sim.system.rs_cells == ()        # 48 atoms: below the grid's
    assert sim.cells == (2, 2, 2, 40)
    sim.cells = (3, 3, 3, 40)
    lines = sim._fit_grids(sim.ms.state.box * 0.9, 5)
    assert len(lines) == 1 and "neighbor cell grid" in lines[0]
    assert sim.cells == ()
