"""The port's PB-NN run scripts (reactive_pb_nn_md_tpu_torch/run/
pbnn_transfer.py, pbnn_production.py, pbnn_training.py, make_acid_box.py)
against the JAX package's scripts/pbnn_transfer.py, scripts/
pbnn_production.py and examples/ch3so3h_h2o/make_box.py, fp64 on the
CPU:

  (a) transfer frames: make_frames on the 26-water box (2 frames, numpy
      seed 3) gives the JAX make_frames' positions bit for bit, the same
      neighbor pairs, and the reciprocal weights within 1e-12;
  (b) the 63-water K = 24 box: the port's build equals the JAX
      build_water's leaf by leaf, and its frames (seed 5) the JAX ones;
      with the JAX-pretrained MLP carried across (convert.mlp_from_numpy),
      the 26-water box's frame energies (labels and MLP) within 1e-10
      relative of the JAX ones, eval_system's RMSE within 1e-8.  The
      63-water box's energies are not compared here (one more JAX
      compilation than the file's time allows): chip_smoke.py 15b holds
      them card against CPU;
  (c) one finetune_heldout Adam step (split 0.75: frame 1 trains, frame
      2 is held out) from that MLP: the four rmses before and after, and
      the MLP after, within 1e-8 of the JAX step;
  (d) pbnn_production's mutate (softening (2.0, 0.5, 0.5, 1.0), the MLP
      carried across) on the 26-water Zundel deck of
      tests/test_torch_scan.py equals the JAX script's mutate (its
      cpl_func table, the softened tables, the MLP's leaves), and the
      Simulation's Etot after each of the first 4 steps agrees with the
      JAX package's within 1e-10 relative;
  (e) the hop rows: the same deck under the softening alone (analytic
      couplings), 4 NVE steps from its start in both packages: the
      hopped and hydronium rows equal step by step, positions within
      1e-9 A; the deck's water, moved to 2.45 A of a hydronium proton
      that sits midway, takes the proton at step 3 (the JAX side must
      hop in the window);
  (f) pbnn_production's hop counter on a synthetic hop file of two hops:
      2 events, 2 molecules, 4 lines the JAX way;
  (g) the new entry points default to the card and refuse to run
      without one; make_acid_box writes the JAX make_box.py's bytes for
      --n-water 8 --seed 0; pbnn_transfer's acid rows print the blocked
      message.

What the JAX side compiles, with its optimizations off (as
torch_bridge.jax_compiled does): (a) to (c) in a process of its own
(tests/torch_pbnn_jax.py: one frame's adiabatic energy and its gradient
with respect to the MLP, the system an argument, which nn/train.py's
make_frame_energy_fn vmaps over frames; optax.adam's first update
written out in numpy), and md_scan of the Zundel deck on a second thread
while the fixture's rest runs.  (d) and (e) run through that one
md_scan, their systems both carrying the MLP ((e)'s unused: its
couplings stay analytic).  The JAX runs start from the port's initial
forces (the JAX initial_md_state with its force evaluation replaced by
the port's, which tests/test_torch_slice.py, test_torch_scan.py and
test_torch_pbnn.py hold to the JAX package's), so that md_scan is its
only compilation of the step.  The file takes ~31 s alone on an
8-core CPU.
"""

import concurrent.futures
import importlib.util
import json
import multiprocessing
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pbnn_jax
from torch_bridge import jax_compiled, jax_tree
from test_torch_scan import _zundel_deck
from test_torch_scripts import _assert_same
from reactive_pb_nn_md_tpu.io.ffpmt import read_ffpmt as jax_read_ffpmt
from reactive_pb_nn_md_tpu.io.gro import read_gro as jax_read_gro
from reactive_pb_nn_md_tpu.io.simpmt import read_sim_params as jax_read_sim
from reactive_pb_nn_md_tpu.io.topfile import read_top as jax_read_top
from reactive_pb_nn_md_tpu.md import integrators as ji
from reactive_pb_nn_md_tpu.models.total import EnergyBreakdown as JaxBreakdown
from reactive_pb_nn_md_tpu.nn import train as jnt
from reactive_pb_nn_md_tpu.run import presets as jax_presets
from reactive_pb_nn_md_tpu.topology import State as JaxState
from reactive_pb_nn_md_tpu.topology import build_system as jax_build
from reactive_pb_nn_md_tpu_torch.convert import from_numpy_tree, mlp_from_numpy
from reactive_pb_nn_md_tpu_torch.md import integrators
from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp
from reactive_pb_nn_md_tpu_torch.nn import train as nt
from reactive_pb_nn_md_tpu_torch.run import (make_acid_box, pbnn_production,
                                             pbnn_training, pbnn_transfer)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DT, N_STEPS = 0.0005, 4
HOP_SCALES = (2.0, 0.5, 0.5, 1.0)
PRETRAIN = 20            # the carried MLP's pretraining steps (JAX)
N_FRAMES = 2


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _numpy_mlp(nn):
    return {"vconst": np.asarray(nn["vconst"]),
            "w": [np.asarray(w) for w in nn["w"]],
            "b": [np.asarray(b) for b in nn["b"]]}


def _with_mlp(jsys, nn, triple=None):
    """The JAX system with the MLP attached and, given `triple`, that
    coupling switched to type 3 (the JAX scripts' replace)."""
    evb = jsys.evb.replace(nn_params=nn)
    if triple is not None:
        evb = evb.replace(cpl_func=jsys.evb.cpl_func.at[triple].set(3))
    return jsys.replace(evb=evb)


def _jax_deck(files):
    frame = jax_read_gro(files[0])
    jsys, jtopo = jax_build(frame, jax_read_ffpmt(files[1]),
                            jax_read_top(files[2]), jax_read_sim(files[3]))
    return frame, jsys, jtopo


def _force_of(ms, jtopo):
    """A stand-in for the JAX evaluate_forces of the state's set-up: the
    port's initial evaluation `ms` as a JAX ForceEval."""
    S = ms.eigenvector.shape[0]
    topo = jtopo.replace(**{k: jnp.asarray(getattr(ms.topo, k).numpy(),
                                           dtype=getattr(jtopo, k).dtype)
                            for k in ("mol_mtype", "mol_natom", "mol_atoms",
                                      "atom_mol", "atom_slot", "atom_type",
                                      "charge", "hydronium_mol")})
    bd = JaxBreakdown(**{k: jnp.asarray(float(getattr(ms.breakdown, k)))
                         for k in ("total", "elec", "vdw", "bond", "angle",
                                   "dihedral")})
    fe = ji.ForceEval(
        potential=jnp.asarray(float(ms.potential)), breakdown=bd,
        force=jnp.asarray(ms.force.numpy()), topo=topo,
        n_states=jnp.int32(int(ms.n_states)),
        eigenvector=jnp.asarray(ms.eigenvector.numpy()),
        hopped=jnp.bool_(False), evb_overflow=jnp.bool_(False),
        hydronium_of=jnp.zeros(S, jnp.int32),
        n_hops_of=jnp.zeros(S, jnp.int32))
    return lambda *args, **kw: fe


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every number the tests compare, the port's and the JAX package's
    (see the module docstring for what the JAX side compiles and where)."""
    tmp = tmp_path_factory.mktemp("pbnn_scripts")
    jpt = _load("jax_pbnn_transfer", "scripts/pbnn_transfer.py")
    r = {}
    with jax_compiled(), concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as procs, \
            concurrent.futures.ThreadPoolExecutor(1) as threads:
        files = _zundel_deck(tmp / "zundel")
        frame, jsys0, jtopo = _jax_deck(files)
        tri = jpt.water_triple(jsys0)
        # the carried MLP, pretrained on the triple's analytic row (the
        # force field of every deck here); (a)-(c)'s JAX side from it in
        # the other process
        nn, _ = jnt.pretrain_geometric(jnp.asarray(jsys0.evb.cpl_params[tri]),
                                       jax.random.PRNGKey(1), steps=PRETRAIN)
        transfer = procs.submit(torch_pbnn_jax.transfer_reference,
                                _numpy_mlp(nn))
        r["nn"] = mlp_from_numpy(_numpy_mlp(nn), "cpu")

        # (d), (e): the port's Simulations after mutate, the JAX states
        # from their set-ups, md_scan compiled on the thread
        sims = {k: Simulation(*files, device="cpu") for k in ("d", "e")}
        r["h0"] = int(sims["e"].ms.topo.hydronium_mol)
        sims["d"].mutate_system(pbnn_production.make_mutate(
            HOP_SCALES, True, nn=r["nn"]))
        sims["e"].mutate_system(pbnn_production.make_mutate(HOP_SCALES,
                                                            False))
        soft = jax_presets.soften_for_hops(jsys0, *HOP_SCALES)
        jsys = {"d": _with_mlp(soft, nn, tri), "e": _with_mlp(soft, nn)}
        state = JaxState(x=jnp.asarray(frame.xyz),
                         v=jnp.asarray(frame.velocities),
                         box=jnp.asarray(frame.box),
                         key=jax.random.PRNGKey(0), step=0)
        jcbw = jnp.asarray(sims["e"].cbw.numpy())
        jms = {}
        for k in ("d", "e"):
            with pytest.MonkeyPatch.context() as mk:
                mk.setattr(ji, "evaluate_forces",
                           _force_of(sims[k].ms, jtopo))
                jms[k] = ji.initial_md_state(state, jtopo, jsys[k], jcbw,
                                             sims[k].capacity)
        scan = threads.submit(ji.md_scan.lower(jms["e"], jsys["e"], jcbw,
                                               DT, "NVE", N_STEPS).compile)

        # the rest meanwhile: the port's boxes, frames, energies and
        # steps, the JAX 63-water box
        jB = jpt.build_water(63, 24, seed=4)
        r["jfrB"] = jpt.make_frames(*jB, N_FRAMES, 0.05, 5)
        r["jB"] = jB
        r["wA"] = pbnn_transfer.build_water(26, 16, 9, "cpu")
        r["wB"] = pbnn_transfer.build_water(63, 24, 4, "cpu")
        r["frA"] = pbnn_transfer.make_frames(*r["wA"], N_FRAMES, 0.05, 3)
        r["frB"] = pbnn_transfer.make_frames(*r["wB"], N_FRAMES, 0.05, 5)
        system, topo, _, box = r["wA"]
        r["e"] = pbnn_transfer.frame_energies(system, topo, box,
                                              r["frA"][4], r["frA"][:4],
                                              r["nn"])
        r["scan"] = {k: integrators.md_scan(sims[k].ms, sims[k].system,
                                            sims[k].cbw, DT, "NVE", N_STEPS)
                     for k in ("d", "e")}
        r["sims"], r["jsys"] = sims, jsys
        exe = scan.result()
        r["jscan"] = {k: exe(jms[k], jsys[k], jcbw, DT) for k in ("d", "e")}
        r["jax_transfer"] = transfer.result()
    return r


# ---- (a), (b): frames and builds


@pytest.mark.parametrize("box", ["A", "B"])
def test_transfer_frames_equal_jax(runs, box):
    xs, fi, pj, pm, cbw = runs["fr" + box]
    jxs, jfi, jpj, jpm, jcbw = (runs["jax_transfer"]["frames"]
                                if box == "A" else runs["jfrB"])
    assert torch.equal(xs, torch.from_numpy(np.array(jxs)))
    np.testing.assert_array_equal(fi.numpy(), np.asarray(jfi))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jpm))
    np.testing.assert_array_equal(np.where(pm, pj, -1),
                                  np.where(jpm, jpj, -1))
    assert int(pm.sum()) > 0
    np.testing.assert_allclose(cbw.numpy(), np.asarray(jcbw), rtol=1e-12,
                               atol=0)


def test_transfer_k24_build_equals_jax(runs):
    system, topo, x0, box = runs["wB"]
    jsys, jtopo, jx0, jbox = runs["jB"]
    ref_sys, ref_topo = from_numpy_tree(jax_tree(jsys, jtopo), "cpu")
    _assert_same(system, ref_sys)
    _assert_same(topo, ref_topo, "topo")
    assert (system.n_atoms, system.pme_grid) == (193, 24)
    assert torch.equal(x0, torch.from_numpy(np.array(jx0)))
    assert torch.equal(box, torch.from_numpy(np.array(jbox)))


def test_transfer_energies_match_jax(runs):
    system, topo, _, box = runs["wA"]
    frames, cbw = runs["frA"][:4], runs["frA"][4]
    e_ref, e_nn = runs["e"]
    jt = runs["jax_transfer"]
    assert _rel(e_ref, jt["e_ref"]) <= 1e-10
    assert _rel(e_nn, jt["e_nn"]) <= 1e-10
    jrmse = float(np.sqrt(np.mean((jt["e_nn"] - jt["e_ref"]) ** 2)))
    rmse = float(torch.sqrt(torch.mean((e_nn - e_ref) ** 2)))
    assert abs(rmse - jrmse) <= 1e-8 * jrmse and jrmse > 0.1
    row = pbnn_transfer.eval_system("water26", system, topo, box, cbw,
                                    frames, runs["nn"])
    assert abs(row["rmse_kjmol"] - round(jrmse, 4)) <= 1e-4
    assert row["n_frames"] == N_FRAMES


def test_finetune_step_matches_jax(runs):
    system, topo, _, box = runs["wA"]
    frames, cbw = runs["frA"][:4], runs["frA"][4]
    e_ref = runs["e"][0]
    nn1, rep = nt.finetune_heldout(
        runs["nn"], coupling_mlp.attach(system, runs["nn"]), topo, box, cbw,
        *frames, e_ref, split=0.75, steps=1)
    jt = runs["jax_transfer"]
    d0, d1 = (np.abs(jt[k] - jt["e_ref"]) for k in ("e_nn", "e_nn1"))
    want = {"train_rmse_before": d0[0], "test_rmse_before": d0[1],
            "train_rmse_after": d1[0], "test_rmse_after": d1[1]}
    assert (rep["n_train"], rep["n_test"]) == (1, 1)
    for k, v in want.items():
        assert abs(rep[k] - v) <= 1e-8 * v, k
    assert rep["train_rmse_after"] < rep["train_rmse_before"]
    got = coupling_mlp.mlp_tensors(nn1)
    ref = coupling_mlp.mlp_tensors(mlp_from_numpy(jt["nn1"], "cpu"))
    for a, b in zip(got, ref):
        assert _rel(a, b) <= 1e-8


# ---- (d), (e): the production mutation and the hop rows


def test_production_mutate_matches_jax(runs):
    system, jsys = runs["sims"]["d"].system, runs["jsys"]["d"]
    np.testing.assert_array_equal(system.evb.cpl_func.numpy(),
                                  np.asarray(jsys.evb.cpl_func))
    assert int((system.evb.cpl_func == 3).sum()) == 1
    for name in ("cpl_params", "da_params", "pa_params"):
        np.testing.assert_array_equal(getattr(system.evb, name).numpy(),
                                      np.asarray(getattr(jsys.evb, name)))
    np.testing.assert_array_equal(system.ff.vdw_params.numpy(),
                                  np.asarray(jsys.ff.vdw_params))
    tree = _numpy_mlp(jsys.evb.nn_params)
    for a, b in zip(coupling_mlp.mlp_tensors(system.evb.nn_params),
                    [tree["vconst"], *tree["w"], *tree["b"]]):
        np.testing.assert_array_equal(a.numpy(), b)


def test_production_steps_etot_match_jax(runs):
    _, diag = runs["scan"]["d"]
    jms, jd = runs["jscan"]["d"]
    etot = (diag.kinetic + diag.potential).numpy()
    jetot = np.asarray(jd.kinetic) + np.asarray(jd.potential)
    assert np.abs(etot - jetot).max() <= 1e-10 * np.abs(jetot).max()
    ms = runs["scan"]["d"][0]
    np.testing.assert_allclose(ms.state.x.numpy(), np.asarray(jms.state.x),
                               rtol=0, atol=1e-9)


def test_hop_rows_match_jax(runs):
    ms, diag = runs["scan"]["e"]
    jms, jd = runs["jscan"]["e"]
    np.testing.assert_array_equal(diag.hopped.numpy(), np.asarray(jd.hopped))
    np.testing.assert_array_equal(diag.hydronium.numpy(),
                                  np.asarray(jd.hydronium))
    np.testing.assert_allclose(ms.state.x.numpy(), np.asarray(jms.state.x),
                               rtol=0, atol=1e-9)
    # the window holds a hop on the JAX side: the proton leaves the
    # deck's hydronium at step 3
    assert np.asarray(jd.hopped).tolist() == [False, False, True, False]
    assert int(np.asarray(jd.hydronium)[-1]) != runs["h0"]


# ---- (f), (g): hop counting, entry points, the acid rows


def test_hop_counts_of_a_hop_file():
    text = ("step  3\n proton hop from 23 to 14\n"
            "step  9\n proton hop from 14 to 23\n")
    assert pbnn_production.hop_counts(text) == (2, 2, 4)
    assert pbnn_production.hop_counts("") == (0, 0, 0)


def test_production_deck_keys_are_set_or_refused():
    text = (ROOT / "examples" / "water_msevb" / "sim.pmt").read_text()
    out = pbnn_production.set_keys(text, precision="fp32", n_output=128)
    assert "precision          fp32\n" in out
    assert "n_output           128\n" in out and "fp64" not in out
    with pytest.raises(KeyError, match="n_outputs"):
        pbnn_production.set_keys(text, n_outputs=128)


@pytest.mark.parametrize("module", [pbnn_transfer, pbnn_production,
                                    pbnn_training])
def test_entry_points_default_to_the_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default succeeds")
    with pytest.raises(SystemExit, match="--device cpu"):
        module.main([])


def test_make_acid_box_equals_jax_make_box(tmp_path, monkeypatch):
    jax_mod = _load("jax_make_box", "examples/ch3so3h_h2o/make_box.py")
    args = ["--n-water", "8", "--seed", "0", "--out"]
    monkeypatch.setattr(sys, "argv", ["make_box.py"] + args
                        + [str(tmp_path / "jax.gro")])
    jax_mod.main()
    make_acid_box.main(args + [str(tmp_path / "port.gro")])
    assert (tmp_path / "port.gro").read_bytes() == \
        (tmp_path / "jax.gro").read_bytes()


def test_transfer_acid_rows_blocked(tmp_path, monkeypatch, capsys):
    """main's rows and artifact, the builds, training and evaluations
    replaced by stand-ins: the acid rows are printed and written blocked,
    the water rows as eval_system gives them."""
    monkeypatch.setattr(pbnn_transfer, "build_water",
                        lambda n, *a: (n, None, None, None))
    monkeypatch.setattr(pbnn_transfer, "make_frames",
                        lambda system, *a: (system,) * 5)
    monkeypatch.setattr(pbnn_transfer, "train_on",
                        lambda *a: ("mlp", {"n_train": 6, "n_test": 2}))
    monkeypatch.setattr(pbnn_transfer, "eval_system",
                        lambda tag, *a: {"system": tag, "rmse_kjmol": 1.0})
    out = pbnn_transfer.main(["--device", "cpu", "--out",
                              str(tmp_path / "t.json")])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    blocked = [ln for ln in lines if "blocked" in ln]
    assert [ln["system"] for ln in blocked] == [
        "acid CH3SO3H/H2O (upstream FF)", "acid (train box, all frames)",
        "water26"]
    assert all(ln["blocked"] == "CH3SO3H files not in the repo"
               for ln in blocked)
    assert [ln["system"] for ln in lines if "rmse_kjmol" in ln] == [
        "water26 (train box, all frames)", "water63 (2.4x box, K=24)"]
    saved = json.loads((tmp_path / "t.json").read_text())
    assert saved["transfer"] == out["transfer"] == lines
    assert saved["train_acid_heldout"]["blocked"] == pbnn_transfer.BLOCKED
    assert set(saved) >= {"train_water_heldout", "train_acid_heldout",
                          "transfer", "config", "total_s"}
