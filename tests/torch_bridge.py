"""Helpers shared by the tests/test_torch_*.py parity tests: the same deck
built by the JAX package and by the PyTorch port, with the JAX side's
containers flattened to numpy so the port never imports jax."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from fixtures import make_water_box, write_fixture_files
from reactive_pb_nn_md_tpu.io.ffpmt import read_ffpmt
from reactive_pb_nn_md_tpu.io.gro import read_gro, format_gro_frame
from reactive_pb_nn_md_tpu.io.simpmt import read_sim_params
from reactive_pb_nn_md_tpu.io.topfile import read_top

# The suite runs under pytest-xdist, several workers on shared cores: one
# intra-op thread per worker process keeps torch's small CPU ops from
# oversubscribing the cores (tens of times slower when they do).
torch.set_num_threads(1)


# synthetic SAPT water force field (the one tests/test_pallas_realspace.py
# uses; the shipped decks are all-LJ)
SAPT_FF_PMT = """
solute_species
atom_type_parameters
4
OW    -0.82    0.0   0.0   0.0  0.0
HW     0.41    0.0   0.0   0.0  0.0
O_h3o -0.5     0.0   0.0   0.0  0.0
H_h3o  0.5     0.0   0.0   0.0  0.0

custom_sapt_parameters
name  A_ex A_el A_ind A_dhf  B  C6 C8 C10 C12
OW    2.2e5  8.0e4  1.0e4  5.0e3   3.2   1900.0  20000.0  150000.0  800000.0
HW    1.0e4  4.0e3  8.0e2  4.0e2   3.8   40.0   300.0   1500.0   6000.0
O_h3o 0 0 0 0 0 0 0 0 0
H_h3o 0 0 0 0 0 0 0 0 0
"""


def _leaves(obj):
    if obj is None:
        return None
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in ("ff", "mt", "evb"):
            continue
        if isinstance(v, (tuple, str, bool, int, float)) or v is None \
                or isinstance(v, dict):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def jax_tree(system, topo):
    """The JAX package's (System, Topology) as the nested numpy layout of
    reactive_pb_nn_md_tpu_torch.convert.from_numpy_tree."""
    return dict(ff=_leaves(system.ff), mt=_leaves(system.mt),
                evb=_leaves(system.evb), system=_leaves(system),
                topo=_leaves(topo))


def fixture_deck(tmp_path, n_water, seed=1, h3o_reordered=False,
                 sapt=False, **kw):
    """(frame, ff_raw, top_raw, cfg) of the water + hydronium fixture
    (sapt: with the SAPT force field above)."""
    ff_p, top_p, sim_p = write_fixture_files(
        tmp_path, msevb="yes", h3o_reordered=h3o_reordered, **kw)
    if sapt:
        (tmp_path / "ff.pmt").write_text(SAPT_FF_PMT)
    frame = make_water_box(n_water, include_h3o=True, seed=seed,
                           h3o_reordered=h3o_reordered)
    return frame, read_ffpmt(ff_p), read_top(top_p), read_sim_params(sim_p)


def example_deck(root):
    d = root / "examples" / "water_msevb"
    return (read_gro(d / "in.gro"), read_ffpmt(d / "ff.pmt"),
            read_top(d / "top.top"), read_sim_params(d / "sim.pmt"))


def driver_deck(tmp, n_water=16, msevb="no", ensemble="NVE", extra="",
                n_step=6, n_output=2):
    """The 8 CLI file names of the fixture deck under `tmp`, with
    velocities in the .gro so that both packages start from the same
    ones (tests/test_torch_driver.py's deck, any size and ensemble)."""
    tmp.mkdir(parents=True, exist_ok=True)
    ff, top, sim = write_fixture_files(tmp, ensemble=ensemble, msevb=msevb,
                                       n_step=n_step, n_output=n_output,
                                       extra=extra)
    frame = make_water_box(n_water, include_h3o=msevb == "yes", seed=5,
                           jitter=0.05)
    v = np.random.default_rng(7).standard_normal(frame.xyz.shape) * 5.0
    gro = tmp / "box.gro"
    gro.write_text(format_gro_frame(frame.title, frame.mol_names,
                                    frame.mol_natom, frame.atom_names,
                                    frame.xyz, frame.box, velocities=v))
    return [str(gro), ff, top, sim] + [str(tmp / n) for n in (
        "traj.gro", "log.out", "hop.out", "a.out")]


_unoptimized = []     # the jit-cache key of jax_compiled's compilations


@contextlib.contextmanager
def jax_compiled():
    """The JAX driver on the CPU with its eager paths compiled whole and
    optimizations off: the force evaluation of initial_md_state and the
    barostat, and the debug >= 2 enumeration.  Eager, each of their
    thousands of ops compiles on its own (minutes a deck); compiled, the
    arithmetic is the same to rounding.  Everything is restored on
    exit.  The optimization flag is not part of jax.jit's cache key, so
    a user context that is is set too: what compiles inside stays apart
    from what compiles outside, and a later test in the same process
    that compares two compilations bit for bit gets optimized ones
    only."""
    import jax
    from reactive_pb_nn_md_tpu.md import integrators as ji
    from reactive_pb_nn_md_tpu.evb import enumerate as je
    from reactive_pb_nn_md_tpu.evb import topology_ops as jt
    if not _unoptimized:
        _unoptimized.append(jax.make_user_context(default_value=False))
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        with _unoptimized[0](True), pytest.MonkeyPatch.context() as mp:
            mp.setattr(ji, "evaluate_forces", ji._evaluate_forces_jit)
            mp.setattr(je, "enumerate_diabats",
                       jax.jit(je.enumerate_diabats))
            mp.setattr(jt, "build_diabat_topologies",
                       jax.jit(jt.build_diabat_topologies))
            yield
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)
