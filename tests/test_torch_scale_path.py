"""The port stands alone and picks the JAX package's paths.

  * no module of the port and no line of chip_smoke.py imports jax or the
    JAX package (checked with ast); the entry points default to the card;
  * the port's copies of the parsers read both example decks exactly as
    the JAX package's parsers do;
  * examples/water_10k/in.gro is the frame bench.py's run_bench_10k builds;
  * on the flagship and the 10,000-atom box the static-size rules agree
    with the JAX package's, and the 10k deck selects the scale path:
    column pair walk, slab spread, cell list with on-demand rows, domain
    repulsion;
  * a slab capacity that does not hold is regrown and the run goes on.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from fixtures import make_water_box, write_fixture_files
from reactive_pb_nn_md_tpu.io import ffpmt as jax_ffpmt
from reactive_pb_nn_md_tpu.io import gro as jax_gro
from reactive_pb_nn_md_tpu.io import simpmt as jax_simpmt
from reactive_pb_nn_md_tpu.io import topfile as jax_topfile
from reactive_pb_nn_md_tpu.ops import neighbors as jax_nb
from reactive_pb_nn_md_tpu.ops.pallas import realspace_pair as jax_rsp
from reactive_pb_nn_md_tpu.ops.pallas import pme_slab as jax_slab
from reactive_pb_nn_md_tpu.topology import (_suggest_slab_cap_safe,
                                            _suggest_rs_cells_safe)
from reactive_pb_nn_md_tpu_torch.io import ffpmt, gro, simpmt, topfile
from reactive_pb_nn_md_tpu_torch.convert import (from_numpy_tree,
                                                 load_equilibrated_npz)
from reactive_pb_nn_md_tpu_torch.topology import (build_numpy_tree,
                                                  build_system)
from reactive_pb_nn_md_tpu_torch.md import integrators
from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation, load_deck
from reactive_pb_nn_md_tpu_torch.models import repulsion
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_slab
from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp

ROOT = pathlib.Path(__file__).resolve().parents[1]
DECKS = {"water_msevb": ROOT / "examples" / "water_msevb",
         "water_10k": ROOT / "examples" / "water_10k"}


def _port_sources():
    files = sorted((ROOT / "reactive_pb_nn_md_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "reactive_pb_nn_md_tpu",
                                           # the JAX package's tests and
                                           # run scripts' helpers
                                           "tests", "fixtures",
                                           "torch_bridge", "conftest",
                                           "bench", "__graft_entry__")]
    assert len(_port_sources()) > 30
    assert {"nn", "md", "ops", "run", "parallel", "analysis"} <= {
        p.parent.name for p in _port_sources()}
    # the run scripts' counterparts are walked
    assert {f"run/{m}.py" for m in (
        "presets", "equilibrate", "scale_run", "drift_study",
        "spontaneous_hops", "parity_reference", "cell_occupancy",
        "pbnn_transfer", "pbnn_production", "pbnn_training",
        "make_acid_box")} <= {
        p.relative_to(ROOT / "reactive_pb_nn_md_tpu_torch").as_posix()
        for p in _port_sources()[:-1]}
    assert not bad, bad


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults succeed")
    d = DECKS["water_msevb"]
    frame, ffr = gro.read_gro(d / "in.gro"), ffpmt.read_ffpmt(d / "ff.pmt")
    topr, cfg = topfile.read_top(d / "top.top"), simpmt.read_sim_params(
        d / "sim.pmt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_system(frame, ffr, topr, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_numpy_tree(build_numpy_tree(frame, ffr, topr, cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_equilibrated_npz(ROOT / "benchdata" / "eq_flagship_s80.npz")


def _assert_same(a, b, path):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for k, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{path}[{k}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_parser_copies_match_jax_parsers(deck):
    d = DECKS[deck]
    for name, port, ref in (
            ("in.gro", gro.read_gro, jax_gro.read_gro),
            ("ff.pmt", ffpmt.read_ffpmt, jax_ffpmt.read_ffpmt),
            ("top.top", topfile.read_top, jax_topfile.read_top),
            ("sim.pmt", simpmt.read_sim_params, jax_simpmt.read_sim_params)):
        _assert_same(port(d / name), ref(d / name), f"{deck}/{name}")
    f = gro.read_gro(d / "in.gro")
    assert gro.format_gro_frame(f.title, f.mol_names, f.mol_natom,
                                f.atom_names, f.xyz, f.box) \
        == jax_gro.format_gro_frame(f.title, f.mol_names, f.mol_natom,
                                    f.atom_names, f.xyz, f.box)


def test_water_10k_frame_is_the_bench_frame():
    """run_bench_10k's frame (bench.py:415-442: _build(n_water=3332)),
    to the .gro's 0.001 nm precision."""
    ref = make_water_box(3332, include_h3o=True, seed=0)
    got = gro.read_gro(DECKS["water_10k"] / "in.gro")
    assert got.n_atoms == ref.n_atoms == 10_000
    assert list(got.mol_names) == list(ref.mol_names)
    assert list(got.atom_names) == list(ref.atom_names)
    np.testing.assert_array_equal(got.mol_natom, ref.mol_natom)
    np.testing.assert_allclose(got.box, ref.box, atol=1e-9)
    assert np.abs(got.xyz - ref.xyz).max() <= 0.005 + 1e-9   # 0.0005 nm


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_static_size_rules_match_jax(deck):
    d = DECKS[deck]
    cfg = simpmt.read_sim_params(d / "sim.pmt")
    frame = gro.read_gro(d / "in.gro")
    n, box, K = frame.n_atoms, frame.box, cfg.pme_grid
    assert neighbors.suggest_cells(n, box, cfg.verlet_cutoff) \
        == jax_nb.suggest_cells(n, box, cfg.verlet_cutoff)
    rcut = 2.5 + cfg.verlet_cutoff - cfg.real_space_cutoff
    assert neighbors.suggest_cells(n, box, rcut, min_atoms=0) \
        == jax_nb.suggest_cells(n, box, rcut, min_atoms=0)
    assert pme_slab.suggest_slab_cap(n, K) == jax_slab.suggest_slab_cap(n, K)
    assert pme_slab.suggest_pme_scap(n, K, box) \
        == _suggest_slab_cap_safe(n, K, box)
    cells = _suggest_rs_cells_safe(n, box, cfg.real_space_cutoff)
    assert cells
    assert rsp._impl_for(cells) == jax_rsp._impl_for(cells)
    _, frame_, system, _ = load_deck(d / "in.gro", d / "ff.pmt",
                                     d / "top.top", d / "sim.pmt", "cpu")
    assert system.rs_cells == tuple(cells)
    assert system.pme_scap == _suggest_slab_cap_safe(n, K, box)


def test_10k_deck_selects_the_scale_path():
    d = DECKS["water_10k"]
    cfg, frame, system, _ = load_deck(d / "in.gro", d / "ff.pmt",
                                      d / "top.top", d / "sim.pmt", "cpu")
    assert (system.n_atoms, cfg.pme_grid, system.evb_max_states,
            cfg.precision) == (10_000, 64, 32, "fp32")
    assert system.rs_cells == (10, 10, 10, 24)
    assert rsp._impl_for(system.rs_cells) == "column"            # A''
    assert rsp.KERNEL_OF[rsp._impl_for(system.rs_cells)] == "A''"
    assert system.pme_scap == 280                                # D1 / D2
    plan = integrators.neighbor_plan(
        system, torch.tensor(frame.box), neighbors.suggest_capacity(
            system.n_atoms, 46.5 ** 3, system.verlet_cutoff))
    assert plan["cells"] == (8, 8, 8, 42) and plan["on_demand"]
    assert plan["react_cells"] == (13, 13, 13, 18)
    assert not plan["build_half"]
    assert repulsion.domain_repulsion_active(system, plan["on_demand"])
    # the flagship keeps kernel A, the per-atom spread and the dense list
    d = DECKS["water_msevb"]
    _, frame, flag, _ = load_deck(d / "in.gro", d / "ff.pmt",
                                  d / "top.top", d / "sim.pmt", "cpu")
    assert rsp._impl_for(flag.rs_cells) == "full" and flag.pme_scap == 0
    plan = integrators.neighbor_plan(flag, torch.tensor(frame.box), 64)
    assert plan["cells"] == () and not plan["on_demand"]
    assert not repulsion.domain_repulsion_active(flag, False)


def _regrow_deck(tmp_path):
    """128 waters + H3O+ at K = 8: 388 atoms >= 48 K, so the slab path
    (non-reactive: the regrow is the simulation loop's, whatever the
    surface)."""
    ff, top, sim = write_fixture_files(tmp_path, msevb="no", pme_grid=8,
                                       n_output=1)
    frame = make_water_box(128, include_h3o=True, seed=2)
    path = tmp_path / "in.gro"
    path.write_text(gro.format_gro_frame(frame.title, frame.mol_names,
                                         frame.mol_natom, frame.atom_names,
                                         frame.xyz, frame.box))
    out = [str(tmp_path / n) for n in ("traj.gro", "run.log", "hops.log",
                                       "A.log")]
    return [str(path), ff, top, sim] + out


def test_slab_overflow_is_regrown_not_raised(tmp_path):
    files = _regrow_deck(tmp_path)
    sim = Simulation(*files, device="cpu")
    scap0 = sim.system.pme_scap
    assert scap0 > 0 and not integrators.overflowed(sim.ms)
    # at set-up: a deliberately small cap is regrown before the first step
    sim.system = sim.system.replace(pme_scap=8)
    sim._init_state(sim.ms.state, sim.ms.topo)
    assert sim.system.pme_scap > 8 and not integrators.overflowed(sim.ms)
    e_init = float(sim.ms.potential)
    # mid-run: the first step overflows, is regrown and redone
    sim.system = sim.system.replace(pme_scap=8)
    sim.run(2)
    log = pathlib.Path(files[5]).read_text()
    regrows = [ln for ln in log.splitlines()
               if "regrow (PME slab capacity exceeded)" in ln]
    assert regrows[0].startswith("step 0: regrow"), log
    assert regrows[-1].startswith("step 1: regrow"), log
    assert sim.system.pme_scap > 8
    assert "completed 2 steps" in log
    etot = [float(ln.split()[5]) for ln in log.splitlines()
            if ln.startswith(" KE")]
    assert len(etot) == 3 and np.all(np.isfinite(etot))
    pe0 = [float(ln.split()[3]) for ln in log.splitlines()
           if ln.startswith(" KE")][0]
    np.testing.assert_allclose(pe0, e_init, atol=1e-6)    # log: 6 decimals
