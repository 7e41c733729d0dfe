"""The port's fixed-order accumulation (ops/kernels/segment_sum.py, kernel
F), on the CPU unless marked `cuda`:

  * the plain segment sum is index_add bit for bit (duplicate and empty
    targets, padding entries (< 0) left out, widths 1 and 3), its order
    lists each row's entries in ascending position, and its batching
    rule (shared and batched indices) equals a loop of single calls bit
    for bit;
  * take_rows passes gradcheck and gradgradcheck in fp64, and its
    gradient under torch.func.vmap equals a loop; add_rows sums first,
    then adds once;
  * csrc/segment_sum.cu has no atomic operation;
  * one step of each path (NVE, NVT and the replica batch on the 28-atom
    fixture: 8 waters + H3O+ of run/presets.py's water_box, the flagship
    deck at PME 12^3 and state cap 12; NVE on the cell path of the
    124-water fixture) makes no
    floating-point accumulation in which some target takes two or more
    nonzero terms (ops/accumulation_audit.py), that is none whose bits
    can depend on the order of its terms;
  * on the card (`cuda`): kernel F against the plain version, two calls
    bit-identical, a batched launch equal to its single launches.

The JAX package's energy, forces and first 3 steps through these ops
are held in tests/test_torch_slice.py (test_fixed_order_sums_hold_jax_
parity: energy 1e-12 relative, forces 1e-13 of their largest, positions
1e-9 A), on the trajectory that file's fixture already runs: a JAX
md_scan of its own would take this file ~20 s (its trace and compile
alone, optimizations off).  The file imports no jax, so its `cuda` test
runs on the card's machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_determinism.py -q -m cuda
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from reactive_pb_nn_md_tpu_torch.io.ffpmt import read_ffpmt
from reactive_pb_nn_md_tpu_torch.io.simpmt import read_sim_params
from reactive_pb_nn_md_tpu_torch.io.topfile import read_top
from reactive_pb_nn_md_tpu_torch.md import integrators, velocities
from reactive_pb_nn_md_tpu_torch.models import pme
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.ops.accumulation_audit import \
    FloatAccumulations
from reactive_pb_nn_md_tpu_torch.ops.kernels import segment_sum as ss
from reactive_pb_nn_md_tpu_torch.parallel import ensemble
from reactive_pb_nn_md_tpu_torch.run.presets import water_box
from reactive_pb_nn_md_tpu_torch.topology import State, build_system

ROOT = pathlib.Path(__file__).resolve().parents[1]
DECK = ROOT / "examples" / "water_msevb"
DT = 0.0005


def _cases(width, seed=0):
    """(src (M, width), idx (M,), n): duplicates, targets no entry
    reaches (the last three and every odd one below 6) and four padding
    entries (-1)."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, 6, (40,), generator=g) * 2
    idx = torch.cat([idx, torch.tensor([7, -1, 7, 9, -1, -1, -1])])
    src = torch.randn(idx.shape[0], width, dtype=torch.float64, generator=g)
    return src, idx, 13


@pytest.mark.parametrize("width", [1, 3])
def test_segment_sum_plain_equals_index_add(width):
    src, idx, n = _cases(width)
    keep = idx >= 0
    ref = torch.zeros(n, width, dtype=src.dtype).index_add(0, idx[keep],
                                                           src[keep])
    got = ss.segment_sum(src, idx, n)
    assert torch.equal(got, ref)
    assert torch.equal(got[[1, 3, 5, 11, 12]], torch.zeros(5, width,
                                                           dtype=src.dtype))
    assert torch.equal(ss.segment_sum(src.float(), idx, n),
                       torch.zeros(n, width).index_add(0, idx[keep],
                                                       src[keep].float()))
    perm, off = ss.segment_order(idx, n)
    assert off[0] == 4 and off[-1] == idx.numel()
    for t in range(n):
        rows = perm[off[t]:off[t + 1]]
        assert torch.equal(rows, torch.nonzero(idx == t)[:, 0])


def test_segment_sum_batching_rule_equals_a_loop():
    src, idx, n = _cases(3, seed=1)
    W = 4
    srcs = torch.stack([src * (w + 1) for w in range(W)])
    idxs = torch.stack([torch.roll(idx, w) for w in range(W)])
    got = torch.func.vmap(ss.segment_sum, (0, None, None))(srcs, idx, n)
    assert torch.equal(got, torch.stack([ss.segment_sum(s, idx, n)
                                         for s in srcs]))
    got = torch.func.vmap(ss.segment_sum, (0, 0, None))(srcs, idxs, n)
    assert torch.equal(got, torch.stack([ss.segment_sum(s, i, n)
                                         for s, i in zip(srcs, idxs)]))
    got = torch.func.vmap(ss.segment_sum, (None, 0, None))(src, idxs, n)
    assert torch.equal(got, torch.stack([ss.segment_sum(src, i, n)
                                         for i in idxs]))


def test_take_rows_gradients():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(7, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    idx = torch.randint(0, 7, (5, 4), generator=g)
    assert torch.equal(ss.take_rows(x, idx), x[idx])
    # padding reads row 0 and takes no gradient
    pad = torch.where(idx == 3, -1, idx)
    assert torch.equal(ss.take_rows(x, pad), x[pad.clamp(min=0)])
    w = torch.randn(5, 4, 3, dtype=torch.float64, generator=g)
    grad, = torch.autograd.grad((ss.take_rows(x, pad) * w).sum(), x)
    keep = pad >= 0
    assert torch.equal(grad, torch.zeros_like(x).index_add(
        0, pad[keep], w[keep]))
    assert torch.autograd.gradcheck(lambda t: ss.take_rows(t, idx), (x,))
    assert torch.autograd.gradgradcheck(lambda t: ss.take_rows(t, idx),
                                        (x,))
    xs = torch.randn(3, 7, 3, dtype=torch.float64, generator=g)
    idxs = torch.randint(0, 7, (3, 5, 4), generator=g)

    def grad(t, i):
        return torch.func.grad(lambda u: (ss.take_rows(u, i) ** 3).sum())(t)

    for dims, ii in (((0, 0), idxs), ((0, None), idx)):
        got = torch.func.vmap(grad, dims)(xs, ii)
        ref = torch.stack([grad(xs[w], ii[w] if dims[1] == 0 else ii)
                           for w in range(3)])
        assert torch.equal(got, ref)


def test_add_rows_sums_then_adds():
    src, idx, n = _cases(3, seed=3)
    keep = idx >= 0
    src, idx = src[keep], idx[keep]
    out = torch.randn(n, 3, dtype=torch.float64)
    got = ss.add_rows(out, idx, src)
    assert torch.equal(got, out + torch.zeros_like(out).index_add(0, idx,
                                                                  src))
    torch.testing.assert_close(got, out.index_add(0, idx, src), rtol=0,
                               atol=1e-14)


def test_kernel_source_has_no_atomics():
    src = ROOT / "reactive_pb_nn_md_tpu_torch" / "csrc" / "segment_sum.cu"
    code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src.read_text(), flags=re.S)
    assert "segment_sum_kernel" in code
    assert not re.search(r"atomic|\bred\.|\batom\.", code)


@pytest.fixture(scope="module")
def fixture28():
    """(system, cbw, MDState) of the 28-atom fixture, velocities from
    numpy seed 7 at 300 K."""
    cfg = read_sim_params(DECK / "sim.pmt")
    cfg.pme_grid, cfg.precision, cfg.evb_max_states = 12, "fp64", 12
    frame = water_box(8, seed=1)
    system, topo = build_system(frame, read_ffpmt(DECK / "ff.pmt"),
                                read_top(DECK / "top.top"), cfg,
                                device="cpu")
    box = torch.as_tensor(frame.box)
    cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt)
    mass = system.mass.numpy()
    v = np.random.default_rng(7).standard_normal((system.n_atoms, 3)) \
        * np.sqrt(0.0083144626 * 300.0 / mass)[:, None] * 10.0
    ms = integrators.initial_md_state(
        State(x=torch.as_tensor(frame.xyz), v=torch.as_tensor(v), box=box),
        topo, system, cbw, system.n_atoms - 1)
    assert not integrators.overflowed(ms)
    return system, cbw, ms


def _audited(fn):
    audit = FloatAccumulations()
    with torch.autograd.detect_anomaly(check_nan=False), audit:
        fn()
    return audit


@pytest.mark.parametrize("ensemble_name", ["NVE", "NVT"])
def test_step_sums_in_a_fixed_order(fixture28, ensemble_name):
    system, cbw, ms = fixture28
    noise = integrators.draw_noise(ms.state.x,
                                   torch.Generator().manual_seed(0))
    audit = _audited(lambda: integrators.md_step(
        ms, system, cbw, DT, ensemble_name,
        noise=noise if ensemble_name == "NVT" else None))
    assert not audit.order_dependent, audit.summary()
    # the sites left as they are: one nonzero term a target
    assert sum(audit.exact.values()) > 0


def test_batched_step_sums_in_a_fixed_order(fixture28):
    system, cbw, ms = fixture28
    system = ensemble._no_tier(system)
    moved = integrators.initial_md_state(
        State(x=ms.state.x + 0.01, v=ms.state.v, box=ms.state.box),
        ms.topo, system, cbw, system.n_atoms - 1)
    bms = integrators.stack_states([ms, moved])
    audit = _audited(lambda: integrators.batched_md_scan(
        bms, system, cbw, DT, "NVE", n_steps=1))
    assert not audit.order_dependent, audit.summary()


def test_cell_path_step_sums_in_a_fixed_order(tmp_path):
    from torch_bridge import fixture_deck
    frame, ffr, topr, cfg = fixture_deck(
        tmp_path, 124, seed=3, cutoff=4.0, verlet_cutoff=5.0, pme_grid=16,
        extra="evb_max_states 32\n")
    system, topo = build_system(frame, ffr, topr, cfg, device="cpu")
    box = torch.as_tensor(frame.box)
    cells = neighbors.suggest_cells(system.n_atoms, frame.box,
                                    system.verlet_cutoff, min_atoms=1)
    vol = float(np.prod(np.diag(frame.box)))
    cap = neighbors.suggest_capacity(system.n_atoms, vol,
                                     system.verlet_cutoff)
    cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt)
    v = velocities.sample_velocities(torch.Generator().manual_seed(1),
                                     system.mass, 300.0,
                                     velocities.freeze_mask(system, topo))
    ms = integrators.initial_md_state(
        State(x=torch.as_tensor(frame.xyz), v=v, box=box), topo, system,
        cbw, cap, cells=cells)
    assert ms.nlist.celltab is not None and system.rs_cells
    audit = _audited(lambda: integrators.md_step(ms, system, cbw, DT))
    assert not audit.order_dependent, audit.summary()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_is_fixed_order_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel F has no CPU mode")
    g = torch.Generator().manual_seed(4)
    n, m, W = 649, 44_000, 4
    idx = torch.randint(-1, n, (m,), generator=g)
    src = torch.randn(W, m, 3, dtype=dtype, generator=g)
    idxs = torch.stack([idx.roll(w) for w in range(W)])
    ref = torch.stack([ss.segment_sum_plain(s.double(), idx, n)
                       for s in src])
    got = ss.segment_sum_cuda(src[0].cuda(), idx.cuda(), n)
    tol = 1e-13 if dtype == torch.float64 else 1e-6
    assert (got.double().cpu() - ref[0]).abs().max() \
        <= tol * ref[0].abs().max()
    assert torch.equal(got, ss.segment_sum_cuda(src[0].cuda(), idx.cuda(),
                                                n))
    # the CPU's index_add adds in the same order: the same bits
    assert torch.equal(got.cpu(), ss.segment_sum_plain(src[0], idx, n))
    for ii in (idx, idxs):
        batched = ss.segment_sum_cuda(src.cuda(), ii.cuda(), n, nb=W)
        singles = torch.stack([ss.segment_sum_cuda(
            src[w].cuda(), (ii if ii.ndim == 1 else ii[w]).cuda(), n)
            for w in range(W)])
        assert torch.equal(batched, singles)
