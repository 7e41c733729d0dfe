"""The port's reactive NVE slice against the JAX package, fp64 on the CPU:
an 8-water + H3O+ fixture with PME 12 (as tests/test_tier_production.py)
through adiabatic_energy_force and 5 md_steps from identical numpy
velocities, and the CLI in a subprocess that must not import jax; the
same runs held tighter through the fixed-order sums (energy 1e-12,
forces 1e-13, 3 steps 1e-9 A), and the CLI's --profile trace."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_water_box, write_fixture_files
from torch_bridge import fixture_deck
from reactive_pb_nn_md_tpu.io.gro import format_gro_frame
from reactive_pb_nn_md_tpu.topology import build_system as jax_build
from reactive_pb_nn_md_tpu.topology import State as JState
from reactive_pb_nn_md_tpu.models import pme as jax_pme
from reactive_pb_nn_md_tpu.ops import neighbors as jax_nb
from reactive_pb_nn_md_tpu.md import integrators as jax_int
from reactive_pb_nn_md_tpu.md import velocities as jax_vel
from reactive_pb_nn_md_tpu.evb import hamiltonian as jax_ham
from reactive_pb_nn_md_tpu.utils.constants import KB
from reactive_pb_nn_md_tpu_torch.topology import build_system, State
from reactive_pb_nn_md_tpu_torch.models import pme
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.md import integrators
from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_STEPS = 5
CAPACITY = 27            # N - 1: no row can overflow


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """The JAX package's and the port's adiabatic evaluation and 5-step
    trajectory on the same deck, positions and velocities."""
    tmp = tmp_path_factory.mktemp("slice")
    frame, ffr, topr, cfg = fixture_deck(tmp, 8, seed=1, pme_grid=12,
                                         extra="evb_max_states 16\n")
    jsys, jtopo = jax_build(frame, ffr, topr, cfg)
    tsys, ttopo = build_system(frame, ffr, topr, cfg, device="cpu")
    mass = np.asarray(jsys.mass)
    rng = np.random.default_rng(7)
    v0 = rng.standard_normal((jsys.n_atoms, 3)) \
        * np.sqrt(KB * 300.0 * 100.0 / mass)[:, None]
    x0, box = frame.xyz, frame.box
    K, order = jsys.pme_grid, jsys.spline_order

    # ---- JAX: one compiled program each (optimizations off: the CPU
    # compile of the reactive step is otherwise minutes)
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jbox = jnp.asarray(box)
        jcbw = jax_pme.cb_half(jbox, K, order, jsys.alpha_sqrt,
                               dtype=jnp.float64)
        skin = jsys.verlet_cutoff - jsys.real_space_cutoff
        rcut = jsys.evb_reactive_pair_distance + skin
        rcap = jax_nb.suggest_capacity(jsys.n_atoms,
                                       float(np.prod(np.diag(box))), rcut,
                                       safety=1.4)
        nl = jax_nb.build_neighbors(jnp.asarray(x0), jbox,
                                    jsys.verlet_cutoff, CAPACITY,
                                    react_cutoff=rcut, react_cap=rcap)
        assert not bool(nl.overflow)
        pairs = jax_nb.neighbor_pairs(nl)
        res, _ = jax.jit(lambda xx: jax_ham.adiabatic_energy_force(
            xx, jbox, jtopo, jsys, pairs, jcbw, full_idx=nl.full_idx,
            react_idx=nl.react_idx))(jnp.asarray(x0))
        jv = jnp.asarray(v0)
        ms = jax_int.MDState(
            state=JState(x=jnp.asarray(x0), v=jv, box=jbox,
                         key=jax.random.PRNGKey(0),
                         step=jnp.asarray(0, jnp.int32)),
            topo=res.principle_topo, nlist=nl, force=res.force,
            potential=res.energy, breakdown=res.breakdown,
            kinetic=jax_vel.kinetic_energy(jv, jsys.mass),
            n_states=res.n_states, eigenvector=res.eigenvector,
            hopped=jnp.asarray(False), force_overflow=jnp.asarray(False),
            nbr_overflow=nl.overflow, evb_overflow=res.overflow,
            hydronium_of=res.hydronium_of, n_hops_of=res.n_hops_of)
        step = jax.jit(lambda m: jax_int.md_step.__wrapped__(
            m, jsys, jcbw, cfg.delta_t, "NVE"))
        jax_traj = []
        for _ in range(N_STEPS):
            ms = step(ms)
            jax_traj.append((np.asarray(ms.state.x), float(ms.potential)))
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)

    # ---- the port
    tbox = torch.tensor(box)
    tcbw = pme.cb_half(tbox, K, order, tsys.alpha_sqrt)
    tms = integrators.initial_md_state(
        State(x=torch.tensor(x0), v=torch.tensor(v0), box=tbox), ttopo,
        tsys, tcbw, CAPACITY)
    tres, _ = ham.adiabatic_energy_force(
        torch.tensor(x0), tbox, ttopo, tsys,
        neighbors.neighbor_pairs(tms.nlist), tcbw, tms.nlist.full_idx,
        react_idx=tms.nlist.react_idx)
    port_traj = []
    for _ in range(N_STEPS):
        tms = integrators.md_step(tms, tsys, tcbw, cfg.delta_t)
        port_traj.append((tms.state.x.numpy(), float(tms.potential)))
    return dict(jax_res=res, port_res=tres, jax_traj=jax_traj,
                port_traj=port_traj, jax_topo=ms.topo, port_topo=tms.topo)


def test_adiabatic_energy_force_matches_jax(slice_runs):
    j, p = slice_runs["jax_res"], slice_runs["port_res"]
    n = int(j.n_states)
    assert n >= 2 and int(p.n_states) == n
    np.testing.assert_allclose(float(p.energy), float(j.energy), rtol=1e-9)
    H_j = np.asarray(j.hamiltonian)
    np.testing.assert_allclose(p.hamiltonian.numpy(), H_j, rtol=1e-9,
                               atol=1e-9 * np.abs(H_j[:n, :n]).max())
    c_j, c_p = np.asarray(j.eigenvector), p.eigenvector.numpy()
    assert min(np.abs(c_p - c_j).max(), np.abs(c_p + c_j).max()) < 1e-9
    F_j = np.asarray(j.force)
    assert np.abs(p.force.numpy() - F_j).max() <= 1e-9 * np.abs(F_j).max()
    assert int(p.principle) == int(j.principle)


def test_md_steps_match_jax(slice_runs):
    for (xj, ej), (xp, ep) in zip(slice_runs["jax_traj"],
                                  slice_runs["port_traj"]):
        assert np.abs(xp - xj).max() <= 1e-9
        np.testing.assert_allclose(ep, ej, rtol=1e-9)
    jt, pt = slice_runs["jax_topo"], slice_runs["port_topo"]
    for name in ("mol_atoms", "atom_type", "atom_mol", "hydronium_mol"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)))


def _write_deck(tmp_path):
    ff, top, sim = write_fixture_files(tmp_path, msevb="yes", pme_grid=12,
                                       n_output=1,
                                       extra="evb_max_states 16\n")
    frame = make_water_box(8, include_h3o=True, seed=1)
    gro = tmp_path / "in.gro"
    gro.write_text(format_gro_frame(frame.title, frame.mol_names,
                                    frame.mol_natom, frame.atom_names,
                                    frame.xyz, frame.box))
    out = [str(tmp_path / n) for n in ("traj.gro", "run.log", "hops.log",
                                       "A.log")]
    return [str(gro), ff, top, sim] + out


def test_cli_cpu_runs_without_jax(tmp_path):
    files = _write_deck(tmp_path)
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['cli'] + {files!r} + ['--device', 'cpu', "
        "'--steps', '2']\n"
        "runpy.run_module('reactive_pb_nn_md_tpu_torch.run.cli', "
        "run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "completed 2 steps" in r.stdout
    log = pathlib.Path(files[5]).read_text()
    etot = [float(line.split()[5]) for line in log.splitlines()
            if line.startswith(" KE")]
    assert len(etot) == 3 and np.all(np.isfinite(etot))
    assert pathlib.Path(files[4]).read_text().count("step ") == 3


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from reactive_pb_nn_md_tpu_torch.run import cli
    with pytest.raises(SystemExit, match="CUDA is not available"):
        cli.main(_write_deck(tmp_path) + ["--steps", "1"])


def test_sample_velocities_exact_temperature(tmp_path):
    from reactive_pb_nn_md_tpu_torch.md import velocities
    frame, ffr, topr, cfg = fixture_deck(tmp_path, 8, seed=1)
    tsys, ttopo = build_system(frame, ffr, topr, cfg, device="cpu")
    mobile = velocities.freeze_mask(tsys, ttopo)
    gen = torch.Generator().manual_seed(3)
    v = velocities.sample_velocities(gen, tsys.mass, 300.0, mobile)
    ke = float(velocities.kinetic_energy(v, tsys.mass))
    np.testing.assert_allclose(ke, 1.5 * KB * 300.0 * int(mobile.sum()),
                               rtol=1e-12)
    p = (tsys.mass[:, None] * v).sum(0)
    assert float(p.abs().max()) < 1e-10
    v2 = velocities.sample_velocities(torch.Generator().manual_seed(3),
                                      tsys.mass, 300.0, mobile)
    assert torch.equal(v, v2)


def test_fixed_order_sums_hold_jax_parity(slice_runs):
    """The step's gathers on positions go through take_rows, whose
    backward is the fixed-order segment sum (ops/kernels/segment_sum.py):
    the adiabatic energy within 1e-12 relative of the JAX package's, the
    forces within 1e-13 of their largest, the first 3 steps' positions
    within 1e-9 A."""
    j, p = slice_runs["jax_res"], slice_runs["port_res"]
    assert abs(float(p.energy) - float(j.energy)) \
        <= 1e-12 * abs(float(j.energy))
    F_j = np.asarray(j.force)
    assert np.abs(p.force.numpy() - F_j).max() <= 1e-13 * np.abs(F_j).max()
    for (xj, _), (xp, _) in zip(slice_runs["jax_traj"][:3],
                                slice_runs["port_traj"][:3]):
        assert np.abs(xp - xj).max() <= 1e-9


def test_cli_profile_writes_a_trace(tmp_path):
    """--profile DIR (the JAX CLI's jax.profiler.trace) writes a
    torch.profiler Chrome trace of the run into DIR."""
    from reactive_pb_nn_md_tpu_torch.run import cli
    prof = tmp_path / "prof"
    cli.main(_write_deck(tmp_path) + ["--device", "cpu", "--steps", "2",
                                      "--profile", str(prof)])
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
