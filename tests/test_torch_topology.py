"""The port's jax-free build_system against the JAX package's, leaf by leaf
and exactly, and the equilibrated-state loader against the file."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from torch_bridge import jax_tree, fixture_deck, example_deck
from reactive_pb_nn_md_tpu.topology import build_system as jax_build
from reactive_pb_nn_md_tpu_torch.topology import build_system
from reactive_pb_nn_md_tpu_torch.convert import (from_numpy_tree,
                                                 load_equilibrated_npz)
from reactive_pb_nn_md_tpu_torch.md.simulation import load_deck

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _assert_same(a, b, path="system"):
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("deck", ["fixture26", "fixture26_reordered",
                                  "example"])
def test_build_system_matches_jax(tmp_path, deck):
    if deck == "example":
        frame, ffr, topr, cfg = example_deck(ROOT)
    else:
        frame, ffr, topr, cfg = fixture_deck(
            tmp_path, 26, seed=0, h3o_reordered=deck.endswith("reordered"))
    jsys, jtopo = jax_build(frame, ffr, topr, cfg)
    ref_sys, ref_topo = from_numpy_tree(jax_tree(jsys, jtopo), "cpu")
    sys_, topo = build_system(frame, ffr, topr, cfg, device="cpu")
    _assert_same(sys_, ref_sys)
    _assert_same(topo, ref_topo, "topo")
    assert sys_.rs_cells == tuple(jsys.rs_cells)
    assert sys_.mass.dtype == torch.float64       # the decks say fp64


def test_precision_key_picks_dtype(tmp_path):
    frame, ffr, topr, cfg = fixture_deck(tmp_path, 8)
    cfg.precision = "fp32"
    sys_, topo = build_system(frame, ffr, topr, cfg, device="cpu")
    assert sys_.mass.dtype == torch.float32
    assert topo.charge.dtype == torch.float32
    assert topo.atom_type.dtype == torch.int64


def test_load_deck_matches_build_system():
    d = ROOT / "examples" / "water_msevb"
    cfg, frame, sys_, topo = load_deck(d / "in.gro", d / "ff.pmt",
                                       d / "top.top", d / "sim.pmt", "cpu",
                                       precision="fp32")
    assert cfg.precision == "fp32"
    frame_r, ffr, topr, cfg_r = example_deck(ROOT)
    np.testing.assert_array_equal(frame.xyz, frame_r.xyz)
    cfg_r.precision = "fp32"
    ref_sys, ref_topo = build_system(frame_r, ffr, topr, cfg_r, device="cpu")
    _assert_same(sys_, ref_sys)
    _assert_same(topo, ref_topo, "topo")
    assert sys_.mass.dtype == torch.float32


def test_load_equilibrated_npz():
    path = ROOT / "benchdata" / "eq_flagship_s80.npz"
    state, topo, meta = load_equilibrated_npz(path, "cpu")
    data = np.load(path)
    np.testing.assert_array_equal(state.x.numpy(),
                                  data["l0"].astype(np.float64))
    np.testing.assert_array_equal(state.v.numpy(),
                                  data["l1"].astype(np.float64))
    assert state.step == int(data["l4"])
    np.testing.assert_array_equal(topo.mol_atoms.numpy(), data["l7"])
    np.testing.assert_array_equal(topo.charge.numpy(),
                                  data["l11"].astype(np.float64))
    assert int(topo.hydronium_mol) == int(data["l12"])
    assert meta["rs_cells"] == (4, 4, 4, 24)
    assert meta["capacity"] == int(data["meta_capacity"])
