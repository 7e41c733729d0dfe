"""The port's CUDA kernels against their plain PyTorch versions, and the
CUDA force evaluation against the CPU one.  Needs an NVIDIA card: every
test is marked `cuda` and skips without one.  This file imports no jax, so
it runs on the card's machine (which has none) with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: fp64 1e-10 relative to the largest reference value; fp32 as
chip_smoke.py states them (the Pallas tests' own, or a loosening for the
other summation order of atomics and tiles)."""

import dataclasses
import functools
import pathlib

import numpy as np
import pytest
import torch

from torch_bridge import driver_deck, fixture_deck
from reactive_pb_nn_md_tpu_torch.topology import build_system, State
from reactive_pb_nn_md_tpu_torch.convert import load_equilibrated_npz
from reactive_pb_nn_md_tpu_torch.models import pme
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.ops.kernels import (
    pme_slab, pme_spread, realspace_pair as rsp, recip_perstate)
from reactive_pb_nn_md_tpu_torch.md import integrators
from reactive_pb_nn_md_tpu_torch.md.simulation import load_deck
from reactive_pb_nn_md_tpu_torch.utils import pbc

pytestmark = pytest.mark.cuda
DTYPES = [(torch.float64, 1e-10, 1e-10), (torch.float32, 1e-5, 2e-3)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _close(got, ref, rtol):
    ref = ref.detach().double().cpu().numpy()
    np.testing.assert_allclose(got.detach().double().cpu().numpy(), ref,
                               rtol=rtol, atol=rtol * np.abs(ref).max())


ROOT = pathlib.Path(__file__).resolve().parents[1]
EQ_STATE = ROOT / "benchdata" / "eq_flagship_s80.npz"


def _deck(name, f):
    d = ROOT / "examples" / name
    return load_deck(d / "in.gro", d / "ff.pmt", d / "top.top",
                     d / "sim.pmt", torch.device("cuda"),
                     precision="fp64" if f == torch.float64 else "fp32")


def _flagship_x(f, fill_cell=False):
    """(system, x, box, topo) of the equilibrated flagship at its cells
    (4, 4, 4, 24); fill_cell: 24 atoms moved onto 24 of the 27 sites of a
    3 x 3 x 3 lattice in cell 0 (1.55 A apart), which fills it to ccap."""
    _, _, system, _ = _deck("water_msevb", f)
    state, topo, meta = load_equilibrated_npz(EQ_STATE, "cuda", f)
    system = system.replace(rs_cells=meta["rs_cells"])
    x, box = state.x.clone(), state.box
    if fill_cell:
        cells = system.rs_cells
        h = torch.diagonal(box) / torch.tensor(cells[:3], dtype=f,
                                               device="cuda")
        slot, _ = rsp.bin_atoms(x, box, cells, system.real_space_cutoff)
        own = torch.nonzero(slot < cells[3]).flatten()
        rest = torch.nonzero(slot >= cells[3]).flatten()
        pick = torch.cat([own, rest[:cells[3] - own.numel()]])
        g = torch.tensor([(i, j, k) for i in range(3) for j in range(3)
                          for k in range(3)][:cells[3]], dtype=f,
                         device="cuda")
        x[pick] = (g + 0.5) / 3.0 * h
    return system, x, box, topo


# kernel A: the 63-water fixture at cutoff 3.0 (LJ and SAPT), the
# flagship at its cells, the flagship with one cell filled to ccap, the
# 10k lattice at (10, 10, 10, 24) under the full stencil
PAIR_CASES = ["lj", "sapt", "flagship", "full_cell", "10k"]


@pytest.mark.parametrize("case", PAIR_CASES)
def test_pair_kernel_matches_plain(tmp_path, case):
    """A against the plain sweep (per-slot rows at DTYPES' tolerances),
    and two calls give the same bits."""
    _need_card()
    if case in ("lj", "sapt"):
        frame, ffr, topr, cfg = fixture_deck(tmp_path, 63, seed=4,
                                             cutoff=3.0, verlet_cutoff=4.0,
                                             sapt=case == "sapt")
        tsys, topo = build_system(frame, ffr, topr, cfg, device="cuda")
    for f, rtol, _ in DTYPES:
        if case in ("lj", "sapt"):
            system = tsys
            x = torch.tensor(frame.xyz, dtype=f, device="cuda")
            box = torch.tensor(frame.box, dtype=f, device="cuda")
            charge = topo.charge.to(f)
        else:
            if case == "10k":
                _, frame, system, topo = _deck("water_10k", f)
                x = torch.as_tensor(frame.xyz, dtype=f, device="cuda")
                box = torch.as_tensor(frame.box, dtype=f, device="cuda")
            else:
                system, x, box, topo = _flagship_x(f, case == "full_cell")
            charge = topo.charge
        cells, rcut = system.rs_cells, system.real_space_cutoff
        slot, over = rsp.bin_atoms(x, box, cells, rcut)
        assert not bool(over)
        if case == "full_cell":
            assert int((slot < cells[3]).sum()) == cells[3]
        cm = rsp.pack_cells(x, charge, topo.atom_type, topo.atom_mol, slot,
                            cells)
        tabs = rsp.build_tabs(system, f)
        kw = dict(rcut=rcut, alpha=system.alpha_sqrt,
                  has_sapt=system.has_sapt)
        got = rsp.pair_rows_cuda(cm, tabs, cells, box, **kw)
        ref = rsp.pair_rows_plain(cm, tabs, cells, torch.diagonal(box), **kw)
        torch.cuda.synchronize()
        _close(got, ref, rtol)
        assert torch.equal(got, rsp.pair_rows_cuda(cm, tabs, cells, box,
                                                   **kw))


@pytest.mark.parametrize("ff", ["lj", "sapt"])
def test_half_and_column_kernels_match_plain(tmp_path, ff):
    """A' and A'' against the plain sweep (their plain version) at the
    function level: per-slot gradients and the energy sums (the half
    kernels put a whole pair energy on one row)."""
    _need_card()
    frame, ffr, topr, cfg = fixture_deck(tmp_path, 63, seed=4, cutoff=3.0,
                                         verlet_cutoff=4.0,
                                         sapt=ff == "sapt")
    tsys, topo = build_system(frame, ffr, topr, cfg, device="cuda")
    for f, rtol, _ in DTYPES:
        x = torch.tensor(frame.xyz, dtype=f, device="cuda")
        box = torch.tensor(frame.box, dtype=f, device="cuda")
        slot, over = rsp.bin_atoms(x, box, tsys.rs_cells, 3.0)
        assert not bool(over)
        cm = rsp.pack_cells(x, topo.charge.to(f), topo.atom_type,
                            topo.atom_mol, slot, tsys.rs_cells)
        tabs = rsp.build_tabs(tsys, f)
        kw = dict(rcut=3.0, alpha=tsys.alpha_sqrt, has_sapt=tsys.has_sapt)
        ref = rsp.pair_rows_plain(cm, tabs, tsys.rs_cells,
                                  torch.diagonal(box), **kw)
        for column in (False, True):
            got = rsp.pair_rows_half_cuda(cm, tabs, tsys.rs_cells, box,
                                          column=column, **kw)
            torch.cuda.synchronize()
            _close(got[:, :6], ref[:, :6], rtol)
            _close(got[:, 6:].sum(0), ref[:, 6:].sum(0), rtol)


def _packed(frame, topo, tsys, f, cells, rcut):
    x = torch.tensor(frame.xyz, dtype=f, device="cuda")
    box = torch.tensor(frame.box, dtype=f, device="cuda")
    slot, over = rsp.bin_atoms(x, box, cells, rcut)
    assert not bool(over)
    cm = rsp.pack_cells(x, topo.charge.to(f), topo.atom_type, topo.atom_mol,
                        slot, cells)
    return cm, rsp.build_tabs(tsys, f), box


@pytest.mark.parametrize("ff", ["lj", "sapt"])
def test_half_and_column_kernels_are_deterministic(tmp_path, ff):
    """A' and A'' fold every sum in an order fixed by the input: two calls
    give the same bits."""
    _need_card()
    frame, ffr, topr, cfg = fixture_deck(tmp_path, 63, seed=4, cutoff=3.0,
                                         verlet_cutoff=4.0,
                                         sapt=ff == "sapt")
    tsys, topo = build_system(frame, ffr, topr, cfg, device="cuda")
    for f, _, _ in DTYPES:
        cm, tabs, box = _packed(frame, topo, tsys, f, tsys.rs_cells, 3.0)
        kw = dict(rcut=3.0, alpha=tsys.alpha_sqrt, has_sapt=tsys.has_sapt)
        for column in (False, True):
            a, b = (rsp.pair_rows_half_cuda(cm, tabs, tsys.rs_cells, box,
                                            column=column, **kw)
                    for _ in range(2))
            assert torch.equal(a, b)


# the 10k lattice's grid at the capacities a cell regrow reaches (24 ->
# 40 -> 64 -> 96 by Simulation._grow; 100 as well), and finer grids with
# nc3 >= 16 at a shorter cutoff (2.3 A: L / nc >= 2.3), one not cubic
# (the layout before the per-cell design refused both in fp64)
GRIDS = [((10, 10, 10, 40), 4.5), ((10, 10, 10, 64), 4.5),
         ((10, 10, 10, 96), 4.5), ((10, 10, 10, 100), 4.5),
         ((10, 10, 20, 40), 2.3), ((16, 16, 16, 48), 2.3)]


@pytest.mark.parametrize("cells,rcut", GRIDS)
def test_column_kernel_on_the_10k_lattice(cells, rcut):
    """A'' against the plain sweep on the 10,000-atom lattice of
    examples/water_10k/ binned into `cells`: per-slot gradients and the
    energy sums, fp64 and fp32."""
    _need_card()
    deck = pathlib.Path(__file__).resolve().parents[1] / "examples" \
        / "water_10k"
    for f, rtol, _ in DTYPES:
        _, frame, tsys, topo = load_deck(
            deck / "in.gro", deck / "ff.pmt", deck / "top.top",
            deck / "sim.pmt", torch.device("cuda"),
            precision="fp64" if f == torch.float64 else "fp32")
        cm, tabs, box = _packed(frame, topo, tsys, f, cells, rcut)
        kw = dict(rcut=rcut, alpha=tsys.alpha_sqrt, has_sapt=tsys.has_sapt)
        ref = rsp.pair_rows_plain(cm, tabs, cells, torch.diagonal(box), **kw)
        got = rsp.pair_rows_half_cuda(cm, tabs, cells, box, column=True,
                                      **kw)
        torch.cuda.synchronize()
        _close(got[:, :6], ref[:, :6], rtol)
        _close(got[:, 6:].double().sum(0), ref[:, 6:].double().sum(0), rtol)


def _slab_check(x0, q0, L, K, order, scap, seed=0):
    """D1 and D2 against their plain versions on the slab rows of x0, in
    both dtypes, each giving the same bits on two calls."""
    gQ0 = np.random.default_rng(seed).standard_normal(K ** 3)
    for f, rtol, grtol in DTYPES:
        x = torch.tensor(x0, dtype=f, device="cuda")
        q = torch.tensor(q0, dtype=f, device="cuda")
        box = torch.eye(3, dtype=f, device="cuda") * L
        w, dw, nearpt = pme_spread.spline_setup(x, box, K, order)
        slot, rows, over = pme_slab.slab_bins(nearpt, K, order, scap)
        assert not bool(over)
        grid = pme_slab.spread_slab_cuda(w, nearpt, q, rows, K, scap)
        _close(grid, pme_slab.spread_slab_plain(w, nearpt, q, rows, K), rtol)
        gQ = torch.tensor(gQ0, dtype=f, device="cuda")
        out = pme_slab.interp_slab_cuda(gQ, w, dw, nearpt, rows, K, scap)
        _close(out, pme_slab.interp_slab_plain(gQ, w, dw, nearpt, rows, K),
               grtol)
        # no atomics: two launches agree bit for bit
        assert torch.equal(grid, pme_slab.spread_slab_cuda(w, nearpt, q, rows,
                                                           K, scap))
        assert torch.equal(out, pme_slab.interp_slab_cuda(gQ, w, dw, nearpt,
                                                          rows, K, scap))


def test_slab_kernels_match_plain():
    _need_card()
    rng = np.random.default_rng(3)
    n, K, order, L = 3000, 32, 6, 31.0
    x0, q0 = rng.uniform(0, L, (n, 3)), rng.uniform(-1, 1, n)
    _slab_check(x0, q0, L, K, order, pme_slab.suggest_slab_cap(n, K))


@functools.lru_cache(maxsize=None)
def _water_10k():
    d = pathlib.Path(__file__).resolve().parents[1] / "examples" / "water_10k"
    _, frame, _, topo = load_deck(d / "in.gro", d / "ff.pmt", d / "top.top",
                                  d / "sim.pmt", "cpu", precision="fp64")
    return frame.xyz, topo.charge.numpy(), float(frame.box[0, 0])


# the 10k lattice at its slab cap and at the cap a melting run regrows to;
# a clumped 10k box whose fullest slab holds ~2.7x the mean; order 4; K
# that are not a multiple of the band of 8 y rows (20, and 12, whose band
# window covers every y)
SLAB_CASES = ["10k_280", "10k_520", "10k_clumped", "order4", "K20", "K12"]


@pytest.mark.parametrize("case", SLAB_CASES)
def test_slab_kernels_on_the_10k_box_and_edge_shapes(case):
    _need_card()
    rng = np.random.default_rng(11)
    if case.startswith("10k"):
        x0, q0, L = _water_10k()
        K, order = 64, 6
        if case == "10k_clumped":
            x0 = rng.uniform(0, L, x0.shape)
            # 270 more atoms in the slab of x corner 0: ~426 against 156
            x0[:270, 0] = rng.uniform(5.1, 5.9, 270) * L / K
        scap = 280 if case == "10k_280" else 520
        _slab_check(x0, q0, L, K, order, scap)
        return
    K, order = {"order4": (32, 4), "K20": (20, 6), "K12": (12, 6)}[case]
    n, L = 40 * K, 2.0 * K
    x0, q0 = rng.uniform(0, L, (n, 3)), rng.uniform(-1, 1, n)
    _slab_check(x0, q0, L, K, order, pme_slab.suggest_slab_cap(n, K))


def test_scale_path_forces_cuda_match_cpu(tmp_path):
    """The scale path (cell list with on-demand rows, domain repulsion,
    A'' and the slab spread) forced on a 63-water deck: CUDA kernels
    against the CPU plain versions."""
    _need_card()
    frame, ffr, topr, cfg = fixture_deck(
        tmp_path, 63, seed=3, cutoff=3.1, verlet_cutoff=4.1, pme_grid=12,
        extra="evb_max_states 32\n")
    out = {}
    try:
        rsp.set_stencil_impl("column")
        for dev in ("cuda", "cpu"):
            tsys, topo = build_system(frame, ffr, topr, cfg, device=dev)
            tsys = tsys.replace(pme_scap=pme_slab.suggest_slab_cap(
                tsys.n_atoms, tsys.pme_grid))
            box = torch.tensor(frame.box, device=dev)
            cells = neighbors.suggest_cells(tsys.n_atoms, frame.box,
                                            tsys.verlet_cutoff, min_atoms=1)
            ms = integrators.initial_md_state(
                State(x=torch.tensor(frame.xyz, device=dev),
                      v=torch.zeros((tsys.n_atoms, 3), dtype=torch.float64,
                                    device=dev), box=box),
                topo, tsys, pme.cb_half(box, tsys.pme_grid,
                                        tsys.spline_order, tsys.alpha_sqrt),
                tsys.n_atoms - 1, cells=cells)
            assert not integrators.overflowed(ms) and ms.nlist.celltab is not None
            out[dev] = ms
    finally:
        rsp.set_stencil_impl("auto")
    g, c = out["cuda"], out["cpu"]
    assert int(g.n_states) == int(c.n_states)
    np.testing.assert_allclose(float(g.potential), float(c.potential),
                               rtol=1e-10)
    _close(g.force, c.force, 1e-9)


def test_spread_and_gather_kernels_match_plain():
    _need_card()
    rng = np.random.default_rng(1)
    x0, q0 = rng.uniform(0, 18.0, (200, 3)), rng.uniform(-1, 1, 200)
    K, order = 16, 6
    gQ0 = rng.standard_normal(K ** 3)
    for f, rtol, grtol in DTYPES:
        x = torch.tensor(x0, dtype=f, device="cuda")
        q = torch.tensor(q0, dtype=f, device="cuda")
        box = torch.eye(3, dtype=f, device="cuda") * 18.0
        w, dw, nearpt = pme_spread.spline_setup(x, box, K, order)
        _close(pme_spread.spread_cuda(w, nearpt, q, K),
               pme_spread.spread_plain(w, nearpt, q, K), rtol)
        args = (torch.tensor(gQ0, dtype=f, device="cuda"), w, dw, nearpt, q,
                pbc.recip_vectors(box).contiguous(), K)
        for a, b in zip(pme_spread.gather_cuda(*args),
                        pme_spread.gather_plain(*args)):
            _close(a, b, grtol)


@pytest.mark.parametrize("order", [4, 5, 6])
@pytest.mark.parametrize("K", [16, 32])
@pytest.mark.parametrize("n", [1, 31, 649])
def test_gather_kernel_orders_sizes_and_wrap(order, K, n):
    """B2 against its plain version at the orders compiled in (4, 6) and
    one the generic path takes (5): atoms spread over the box, a third of
    them within a grid spacing of a face (their bricks straddle the
    periodic wrap), and base points moved by -K, +K and +2K (the
    wrapping of an index off [0, K)); two calls give the same bits."""
    _need_card()
    rng = np.random.default_rng(order * 1000 + K * 10 + n)
    L = 18.6
    x0 = rng.uniform(0, L, (n, 3))
    edge = rng.random((n, 3)) < 0.3
    x0 = np.where(edge, rng.uniform(-0.5, 0.5, (n, 3)) * L / K % L, x0)
    q0 = rng.uniform(-1, 1, n)
    gQ0 = rng.standard_normal(K ** 3)
    shift = torch.tensor(rng.choice([0, 0, -K, K, 2 * K], (n, 3)),
                         device="cuda")
    for f, _, grtol in DTYPES:
        box = torch.eye(3, dtype=f, device="cuda") * L
        w, dw, nearpt = pme_spread.spline_setup(
            torch.tensor(x0, dtype=f, device="cuda"), box, K, order)
        args = (torch.tensor(gQ0, dtype=f, device="cuda"), w, dw,
                (nearpt + shift).contiguous(),
                torch.tensor(q0, dtype=f, device="cuda"),
                pbc.recip_vectors(box).contiguous(), K)
        got = pme_spread.gather_cuda(*args)
        for a, b in zip(got, pme_spread.gather_plain(*args)):
            _close(a, b, grtol)
        for a, b in zip(got, pme_spread.gather_cuda(*args)):
            assert torch.equal(a, b)


def _poisoned(fn, numel, dtype):
    """fn() just after a tensor of `numel` elements was filled with NaN and
    freed: the caching allocator hands that block to the next allocation
    of its size (the grid), so an element the kernel never writes shows
    as NaN.  Returns (fn's output, whether it took the poisoned block)."""
    t = torch.full((numel,), float("nan"), dtype=dtype, device="cuda")
    ptr = t.data_ptr()
    del t
    out = fn()
    return out, out.data_ptr() == ptr


@pytest.mark.parametrize("order", [4, 5, 6])
@pytest.mark.parametrize("K", ["order", 13, 32, 40, 70])
@pytest.mark.parametrize("n", [0, 1, 31, 649])
def test_spread_kernel_orders_sizes_and_wrap(order, K, n):
    """B1 against its plain version at the orders compiled in (4, 6) and
    one the generic path takes (5), at K = order (every window covers the
    whole axis), 13 (no multiple of a tile), 32 (the one-plane tile), 40
    and 70 (the four-plane tile; 70 in two z tiles), for no atom, one, and
    many: atoms spread over the box, a third of them within a grid
    spacing of a face (their bricks straddle the periodic wrap), base
    points moved by -K, +K and +2K, a fifth of the charges 0 (the masked
    atoms of delta_charge_grid).  The grid is allocated where a NaN-filled
    block was just freed, so an element the kernel misses fails; two
    calls give the same bits."""
    _need_card()
    K = order if K == "order" else K
    rng = np.random.default_rng(order * 1000 + K * 10 + n)
    L = 18.6
    x0 = rng.uniform(0, L, (n, 3))
    edge = rng.random((n, 3)) < 0.3
    x0 = np.where(edge, rng.uniform(-0.5, 0.5, (n, 3)) * L / K % L, x0)
    q0 = np.where(rng.random(n) < 0.2, 0.0, rng.uniform(-1, 1, n))
    shift = torch.tensor(rng.choice([0, 0, -K, K, 2 * K], (n, 3)),
                         device="cuda").reshape(n, 3)
    for f, rtol, _ in DTYPES:
        box = torch.eye(3, dtype=f, device="cuda") * L
        w, _, nearpt = pme_spread.spline_setup(
            torch.tensor(x0, dtype=f, device="cuda").reshape(n, 3), box, K,
            order)
        args = (w, (nearpt + shift).contiguous(),
                torch.tensor(q0, dtype=f, device="cuda"), K)
        ref = pme_spread.spread_plain(*args)
        for _ in range(2):
            got, poisoned = _poisoned(lambda: pme_spread.spread_cuda(*args),
                                      K ** 3, f)
            torch.cuda.synchronize()
            assert poisoned
            assert not got.isnan().any()
            _close(got, ref, rtol)
        assert torch.equal(got, pme_spread.spread_cuda(*args))


def _perstate_inputs(S, U, K, f, seed=0):
    rng = np.random.default_rng(seed)
    Mh = K * (K // 2 + 1)
    vals = [rng.standard_normal(s) for s in ((S, U), (K, U), (K, U), (U, Mh),
                                             (U, Mh), (K, Mh), (K, Mh))]
    vals.append(rng.uniform(0, 1, (K, Mh)))
    ins = [torch.tensor(v, dtype=f, device="cuda") for v in vals]
    return ins, torch.tensor(rng.standard_normal(S), dtype=f, device="cuda")


# (S, U, K): ragged row, column and depth edges of the output tiles (U 13
# and 321, Mh 84 = K 12), split depths that are not a multiple of their
# chunk (dW: Mh 84 in 16- or 32-deep chunks at S = 1; dBC: 48 states in
# chunks of 7 in fp64), the flagship's S = 48 / 80, the 10k shapes, and
# rows that 16-byte copies cannot take (Mh 45 = K 9 in both types, Mh 66
# = K 11 in fp32): element loads; the 10k deck's shapes after its state
# cap regrows 32 -> 64, and that cap's small tier of 48
PERSTATE_SHAPES = [(1, 13, 12), (7, 28, 12), (7, 321, 32), (8, 32, 16),
                   (48, 192, 32), (80, 320, 32), (80, 13, 64), (32, 128, 64),
                   (5, 20, 9), (3, 12, 11), (64, 256, 64), (48, 192, 64)]


@pytest.mark.parametrize("S,U,K", PERSTATE_SHAPES)
def test_perstate_kernels_match_plain(S, U, K):
    _need_card()
    for f, rtol, grtol in DTYPES:
        ins, gbar = _perstate_inputs(S, U, K, f, seed=S + U + K)
        _close(recip_perstate.perstate_fwd_cuda(*ins),
               recip_perstate.perstate_plain(*ins), rtol * 5)
        leaves = [t.clone().requires_grad_(i < 7) for i, t in enumerate(ins)]
        ref = torch.autograd.grad(
            (recip_perstate.perstate_plain(*leaves) * gbar).sum(),
            leaves[:7])
        for a, b in zip(recip_perstate.perstate_bwd_cuda(gbar, *ins), ref):
            _close(a, b, grtol)


@pytest.mark.parametrize("S,U,K", [(48, 192, 32), (32, 128, 64)])
def test_perstate_kernels_are_deterministic(S, U, K):
    """C1 and C2 (with both depth splits folding partials) give
    bit-identical outputs on two calls: no atomics, fixed-order sums."""
    _need_card()
    for f, _, _ in DTYPES:
        ins, gbar = _perstate_inputs(S, U, K, f)
        assert torch.equal(recip_perstate.perstate_fwd_cuda(*ins),
                           recip_perstate.perstate_fwd_cuda(*ins))
        for a, b in zip(recip_perstate.perstate_bwd_cuda(gbar, *ins),
                        recip_perstate.perstate_bwd_cuda(gbar, *ins)):
            assert torch.equal(a, b)


def test_force_evaluation_cuda_matches_cpu(tmp_path):
    _need_card()
    frame, ffr, topr, cfg = fixture_deck(tmp_path, 26, seed=0)
    out = {}
    for dev in ("cuda", "cpu"):
        tsys, topo = build_system(frame, ffr, topr, cfg, device=dev)
        box = torch.tensor(frame.box, device=dev)
        ms = integrators.initial_md_state(
            State(x=torch.tensor(frame.xyz, device=dev),
                  v=torch.zeros((tsys.n_atoms, 3), dtype=torch.float64,
                                device=dev), box=box),
            topo, tsys, pme.cb_half(box, tsys.pme_grid, tsys.spline_order,
                                    tsys.alpha_sqrt), tsys.n_atoms - 1)
        out[dev] = ms
    g, c = out["cuda"], out["cpu"]
    assert int(g.n_states) == int(c.n_states)
    np.testing.assert_allclose(float(g.potential), float(c.potential),
                               rtol=1e-10)
    _close(g.force, c.force, 1e-9)


def test_nvt_restart_on_the_card(tmp_path, monkeypatch):
    """chip_smoke.py phase 7b at the 26-water reactive fixture: fp64 NVT
    through the CLI, 20 steps against 10 and an auto-detected restart of
    10; the generator on the card is restored from the checkpoint."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.run import cli
    monkeypatch.chdir(tmp_path)
    runs = {}
    for name, legs in (("whole", (20,)), ("broken", (10, 10))):
        files = driver_deck(tmp_path / name, msevb="yes", n_water=26,
                            ensemble="NVT", n_output=10,
                            extra="checkpoint_velocity 10\n")
        for n in legs:
            sim = cli.main(files + ["--device", "cuda", "--steps", str(n)])
        runs[name] = (sim, dict(np.load("velocity_checkpoint.npz")))
        pathlib.Path("velocity_checkpoint.npz").unlink()
    (whole, w), (broken, b) = runs["whole"], runs["broken"]
    assert broken.restart and broken.start_step == 10 and int(b["step"]) == 20
    assert broken.gen.device.type == "cuda"
    np.testing.assert_array_equal(b["torch_generator_state"],
                                  w["torch_generator_state"])
    np.testing.assert_allclose(b["x"], w["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(broken.ms.kinetic + broken.ms.potential),
                               float(whole.ms.kinetic + whole.ms.potential),
                               rtol=0, atol=1e-8)



def _evb_like(S, n_active, rng, gap=None):
    """tests/test_ground_state.py's padded EVB-shaped Hamiltonian (that
    file imports jax)."""
    diag = -24000.0 + 50.0 * rng.standard_normal(S)
    if gap is not None:
        diag[1] = diag[0] + gap
    H = np.diag(diag)
    for s in range(1, n_active):
        p = rng.integers(0, s)
        H[p, s] = H[s, p] = 30.0 * rng.standard_normal()
    for s in range(n_active, S):
        H[s, s] = diag[0] + 1.0e5 * (1.0 + s / S)
        H[s, :s] = H[:s, s] = 0.0
    return H


def _ground_state_case(S, n, gap, kind):
    """An EVB-shaped H, or one whose parked (decoupled) state lies below
    every active one, or a diagonal one (no reflection does anything), or
    a diagonal one whose two lowest entries are equal (a ground gap of
    0)."""
    rng = np.random.default_rng(S + n)
    if kind == "evb":
        return _evb_like(S, n, rng, gap)
    if kind == "parked_lowest":
        H = _evb_like(S, n, rng)
        H[S - 3, S - 3] = H.diagonal()[:n].min() - 200.0
        return H
    H = np.diag(-24000.0 + 50.0 * rng.standard_normal(S))
    if kind == "degenerate":
        H[3, 3] = H[5, 5] = H.diagonal().min() - 10.0
    return H


@pytest.mark.parametrize("S,n,gap,kind", [
    (80, 60, None, "evb"), (48, 40, None, "evb"), (32, 20, None, "evb"),
    (80, 40, 1e-7, "evb"), (81, 70, None, "evb"), (120, 100, None, "evb"),
    (160, 140, None, "evb"),
    (2, 2, None, "evb"), (33, 30, None, "evb"), (64, 50, None, "evb"),
    (24, 0, None, "diagonal"), (24, 0, None, "degenerate"),
    (24, 12, None, "parked_lowest")])
def test_ground_state_kernel_matches_plain(S, n, gap, kind):
    """Kernel E against eigh: the shared-memory path up to 80 states and
    the device-memory one above, the paths through memory past 96 active
    states (120, 160), odd S, S = 2 (no reflection), a diagonal
    H, a near-degenerate diagonal, a parked ground state, and an exactly
    degenerate ground state (c is then any unit vector of the pair's
    span: its residual is held instead)."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.ops import ground_state as gs
    H = torch.tensor(_ground_state_case(S, n, gap, kind), device="cuda")
    for f in (torch.float64, torch.float32):
        Hf = H.to(f)
        lam, c, info = gs.ground_state_cuda(Hf)
        lam2, c2, _ = gs.ground_state_cuda(Hf)
        assert torch.equal(lam, lam2) and torch.equal(c, c2)
        assert 0 <= int(info) <= gs.max_rounds()
        lp, cp = gs.ground_state_eigh(Hf)
        tol = 1e-10 if f == torch.float64 else 1e-6
        assert abs(float(lam) - float(lp)) <= tol * abs(float(lp))
        if kind == "degenerate":
            Hd, cd = Hf.double(), c.double()
            assert abs(float(cd.norm()) - 1.0) <= tol
            assert float((Hd @ cd - float(lam) * cd).abs().max()) <= (
                1e-9 if f == torch.float64 else 1e-2)
        else:
            assert float((c - cp).abs().max()) <= (
                1e-9 if f == torch.float64 else 1e-5)
        i = int(torch.argmax(c.abs()))
        assert float(c[i]) > 0


def _reactive_sim(tmp_path, ensemble):
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    return Simulation(*driver_deck(tmp_path, n_water=26, msevb="yes",
                                   ensemble=ensemble), device="cuda")


@pytest.mark.parametrize("ensemble", ["NVE", "NVT"])
def test_md_scan_graphed_matches_eager(tmp_path, ensemble):
    """16 replays of the captured step against 16 eager md_steps, one
    generator state; a replay counts the launches of its capture."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.md import graphs
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    sim = _reactive_sim(tmp_path, ensemble)
    cfg = sim.cfg
    args = (sim.system, sim.cbw, cfg.delta_t, ensemble)
    kw = dict(friction=cfg.friction_coeff, temperature=cfg.temperature)
    start = sim.gen.get_state()
    sg = graphs.StepGraphs()
    integrators.md_scan(sim.ms, *args, 1, generator=sim.gen, step_graphs=sg,
                        **kw)
    sim.gen.set_state(start)
    _build.launches.clear()
    ms, diag = integrators.md_scan(sim.ms, *args, 16, generator=sim.gen,
                                   step_graphs=sg, **kw)
    assert len(sg.captures) == 1 and _build.launches["E"] == 16
    sim.gen.set_state(start)
    ref = sim.ms
    for _ in range(16):
        noise = (integrators.draw_noise(ref.state.x, sim.gen)
                 if ensemble == "NVT" else None)
        ref = integrators.md_step(ref, *args, noise=noise, **kw)
    assert not diag.capacities() and not integrators.overflowed(ref)
    np.testing.assert_allclose(ms.state.x.cpu().numpy(),
                               ref.state.x.cpu().numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(ms.kinetic + ms.potential),
                               float(ref.kinetic + ref.potential), rtol=0,
                               atol=1e-8)


def test_kernel_a_cap_regrows_capture_anew(tmp_path):
    """Three kernel A cell-cap regrows in a row on the flagship deck
    through Simulation (its _grow, then a chunk each): every regrown
    System is captured anew, none is handed a kept graph of a freed
    System whose id it took (the cap lives only in the System), and no
    chunk overflows."""
    _need_card()
    import shutil
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    deck = tmp_path / "deck"
    shutil.copytree(ROOT / "examples" / "water_msevb", deck)
    sim = Simulation(*[str(deck / n) for n in (
        "in.gro", "ff.pmt", "top.top", "sim.pmt", "traj.gro", "run.log",
        "hops.log", "A.log")], device="cuda")
    step = 0
    caps = []
    for regrow in range(4):
        if regrow:
            ms = sim.ms
            sim._grow((integrators.RS_CELL_CAP,), step, "regrown")
            sim._init_state(ms.state, ms.topo, step, comp=ms.comp)
        caps.append(sim.system.rs_cells[3])
        diag, done, end = sim._chunk(step, 4)
        assert done == 4 and not end and not diag.capacities()
        assert len(sim.step_graphs.captures) == regrow + 1
        step += done
    assert caps == sorted(set(caps))


def test_step_makes_no_host_sync_on_the_card(tmp_path):
    _need_card()
    sim = _reactive_sim(tmp_path, "NVT")
    cfg = sim.cfg
    step = (sim.ms, sim.system, sim.cbw, cfg.delta_t, "NVT",
            cfg.friction_coeff, cfg.temperature, sim.gen, "full")
    integrators.scan_step(*step)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        integrators.scan_step(*step)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---- PB-NN: coupling function type 3 (nn/coupling_mlp.py, nn/train.py)

def _mlp(device, n_env, dtype=torch.float64, seed=0):
    from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp
    return coupling_mlp.init_mlp(torch.Generator().manual_seed(seed),
                                 hidden=(8, 8), vconst=-97.0, dtype=dtype,
                                 device=device, n_env=n_env)


@pytest.mark.parametrize("n_env", [0, 2])
def test_type3_forces_cuda_match_cpu(n_env):
    """The equilibrated flagship with the water triple switched to an MLP:
    evaluate_forces on the card (kernels) against the CPU (plain)."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp
    out = {}
    for dev in ("cuda", "cpu"):
        _, _, system, _ = load_deck(*(ROOT / "examples" / "water_msevb" / n
                                      for n in ("in.gro", "ff.pmt",
                                                "top.top", "sim.pmt")),
                                    torch.device(dev))
        state, topo, meta = load_equilibrated_npz(EQ_STATE, dev)
        system = coupling_mlp.attach(
            system.replace(rs_cells=meta["rs_cells"]), _mlp(dev, n_env))
        cbw = pme.cb_half(state.box, system.pme_grid, system.spline_order,
                          system.alpha_sqrt)
        nl = neighbors.build_neighbors(state.x, state.box,
                                       **integrators.neighbor_plan(
                                           system, state.box,
                                           meta["capacity"],
                                           react_cap=meta["react_cap"]))
        out[dev] = integrators.evaluate_forces(state.x, state.box, topo,
                                               system, nl, cbw)
    g, c = out["cuda"], out["cpu"]
    assert int(g.n_states) == int(c.n_states)
    np.testing.assert_allclose(float(g.potential), float(c.potential),
                               rtol=1e-10)
    _close(g.force, c.force, 1e-9)


def test_force_matching_gradient_cuda_matches_cpu(tmp_path):
    """d(force-matching loss)/d(MLP) on 2 rattled frames of the 26-water
    fixture: the card's kernels (whose backward terms are constants under
    create_graph) against the CPU."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp, train
    frame, ffr, topr, cfg = fixture_deck(tmp_path, 26, seed=9)
    rng = np.random.default_rng(3)
    xs = [frame.xyz + rng.normal(0.0, 0.05, frame.xyz.shape)
          for _ in range(2)]
    f_ref = rng.normal(0.0, 50.0, (2,) + frame.xyz.shape)
    out = {}
    for dev in ("cuda", "cpu"):
        tsys, topo = build_system(frame, ffr, topr, cfg, device=dev)
        nn = coupling_mlp.copy_mlp(_mlp(dev, 2), True)
        tsys = coupling_mlp.attach(tsys, nn)
        box = torch.tensor(frame.box, device=dev)
        cap = neighbors.suggest_capacity(tsys.n_atoms,
                                         float(np.prod(np.diag(frame.box))),
                                         tsys.verlet_cutoff)
        fr = ([], [], [], [])
        for xf in xs:
            x = torch.tensor(xf, device=dev)
            nl = neighbors.build_neighbor_list(x, box, tsys.verlet_cutoff,
                                               cap)
            _, j, m = neighbors.neighbor_pairs(nl)
            for lst, v in zip(fr, (x, nl.full_idx, j, m)):
                lst.append(v)
        cbw = pme.cb_half(box, tsys.pme_grid, tsys.spline_order,
                          tsys.alpha_sqrt)
        e, f = train.make_frame_energy_force_fn(tsys, topo, box, cbw)(
            nn, *fr)
        loss = (torch.mean((e - 600.0) ** 2) + 0.3 * 3 * tsys.n_atoms
                * torch.mean(torch.sum((f - torch.tensor(
                    f_ref, device=dev)) ** 2, -1)))
        out[dev] = (loss, torch.autograd.grad(
            loss, coupling_mlp.mlp_tensors(nn)))
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(float(lg.detach()), float(lc.detach()),
                               rtol=1e-10)
    for a, b in zip(gg, gc):
        _close(a, b, 1e-9)


def test_mutate_system_captures_a_fresh_graph(tmp_path):
    """Attaching an MLP through Simulation.mutate_system drops the graphs
    of the analytic surface and captures the type-3 step anew; an
    in-place change of the attached tensors is seen by the next replay
    (graphed against eager after it)."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
    from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp
    sim = _reactive_sim(tmp_path, "NVE")
    sim._chunk(0, 2)
    old, graphs_before = sim.system, sim.step_graphs
    assert len(graphs_before.captures) == 1
    nn = _mlp("cuda", 2)
    sim.mutate_system(lambda s: coupling_mlp.attach(s, nn))
    assert sim.system is not old and sim.step_graphs is not graphs_before
    sim._chunk(2, 2)
    assert len(sim.step_graphs.captures) == 1
    key = sim.step_graphs.captures[0][0]
    assert any(getattr(k, "obj", None) is sim.system for k in key)
    with torch.no_grad():
        nn["w"][0].mul_(1.1)
    start = sim.ms
    ms, _ = sim._scan(4)
    assert len(sim.step_graphs.captures) == 1
    tier = "small" if ham.small_state_tier(sim.system) else "full"
    ref = start
    for _ in range(4):
        ref = integrators.md_step(ref, sim.system, sim.cbw, sim.cfg.delta_t,
                                  "NVE", tier=tier)
    np.testing.assert_allclose(ms.state.x.cpu().numpy(),
                               ref.state.x.cpu().numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(ms.potential), float(ref.potential),
                               rtol=0, atol=1e-8)


# ---- umbrella sampling (md/bias.py, parallel/ensemble.py, umbrella.py)

def _flagship_ladder(f, centers):
    """(system, cbw, ms, atoms, ladder) at the equilibrated flagship: the
    window restraint at `centers` (k 400) and the R_OO keeper (k 100 at
    2.5 A)."""
    from reactive_pb_nn_md_tpu_torch.parallel import umbrella
    system, x, box, topo = _flagship_x(f)
    cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt, dtype=f)
    _, _, meta = load_equilibrated_npz(EQ_STATE, "cuda", f)
    ms = integrators.initial_md_state(
        State(x=x, v=torch.zeros_like(x), box=box), topo, system, cbw,
        meta["capacity"], react_cap=meta["react_cap"])
    atoms = umbrella.transfer_triple(ms, system)
    W = len(centers)
    ladder = (umbrella.make_ladder(atoms, centers, 400.0, 0, f),
              umbrella.make_ladder(atoms, [2.5] * W, 100.0, 1, f))
    return system, cbw, ms, atoms, ladder


def test_bias_force_cuda_matches_cpu():
    _need_card()
    from reactive_pb_nn_md_tpu_torch.md import bias
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    _, _, ms, _, ladder = _flagship_ladder(torch.float64, [-0.4, 0.4])
    for w in range(2):
        b = ensemble.window_bias(ladder, w)
        e, f = bias.bias_energy_force(ms.state.x, ms.state.box, b)
        cpu = tuple(dataclasses.replace(
            r, atoms=r.atoms.cpu(), k=r.k.cpu(), center=r.center.cpu())
            for r in b)
        ec, fc = bias.bias_energy_force(ms.state.x.cpu(),
                                        ms.state.box.cpu(), cpu)
        assert abs(float(e) - float(ec)) <= 1e-12
        assert float((f.cpu() - fc).abs().max()) <= 1e-12


def test_graphed_ladder_matches_eager_under_one_capture():
    """2 windows, 8 NVT steps each: the replays of one captured step (the
    restraint copied in a window at a time) against eager steps, one
    generator state a window."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.parallel import umbrella
    centers = [-0.4, 0.4]
    system, cbw, ms, atoms, ladder = _flagship_ladder(torch.float64,
                                                      centers)
    runs = []
    for eager in (False, True):
        scan = umbrella.make_ladder_scan(system, cbw, 0.0005, "NVT", 8,
                                         friction=5.0)
        scan.eager = eager
        batch = umbrella.seeded_window_states(ms, scan.system, cbw, atoms,
                                              centers, ladder=ladder)
        runs.append(scan(batch, ladder) + (scan,))
    (g, gd, gscan), (e, ed, _) = runs
    assert len(gscan.step_graphs.captures) == 1 and not gscan.regrows
    assert not gd.capacities()
    for w in range(2):
        dx = (g.states[w].state.x - e.states[w].state.x).abs().max()
        assert float(dx) <= 1e-9
    np.testing.assert_allclose(gd.cv.numpy(), ed.cv.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(gd.potential.numpy(), ed.potential.numpy(),
                               rtol=0, atol=1e-8)
    assert float(gd.cv[0].mean()) < 0.0 < float(gd.cv[1].mean())


def test_replica_generator_swap_on_the_card():
    """3 NVT replicas through one captured step on the card: distinct
    generator states part, replica 2 given replica 0's state follows it
    (to the card's accumulating-op rounding), and each replica's
    generator comes back advanced."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    system, cbw, ms, _, _ = _flagship_ladder(torch.float64, [0.0])
    batch = ensemble.stack_replicas(ms, 3, seed=5)
    batch.generators[2] = batch.generators[0].clone()
    scan = ensemble.make_replica_scan(system, cbw, 0.0005, "NVT", 8,
                                      friction=1.0)
    out, diag = scan(batch)
    assert len(scan.step_graphs.captures) == 1 and not diag.capacities()
    x = [m.state.x for m in out.states]
    assert float((x[0] - x[1]).abs().max()) > 1e-6
    assert float((x[0] - x[2]).abs().max()) <= 1e-9
    assert torch.equal(out.generators[0], out.generators[2])
    assert not torch.equal(out.generators[0], batch.generators[0])


# ---- one replica's step shared over ranks (parallel/shard.py)

@pytest.mark.parametrize("impl", ["full", "half", "column"])
def test_pair_kernel_cell_ranges_sum_to_the_full_launch(impl):
    """A's range launch (and A' / A'' with their rows outside the range
    zeroed), the flagship's cells in 4 ranges: each range's rows equal the
    full launch's there and are zero elsewhere; the ranges sum to it."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.parallel.shard import AtomShard, split
    for f, rtol, _ in DTYPES:
        system, x, box, topo = _flagship_x(f)
        cells = system.rs_cells
        slot, _ = rsp.bin_atoms(x, box, cells, system.real_space_cutoff)
        cm = rsp.pack_cells(x, topo.charge.to(f), topo.atom_type.to(f),
                            topo.atom_mol.to(f), slot, cells)
        args = (rsp.build_tabs(system, f), cells, box,
                system.real_space_cutoff, system.alpha_sqrt,
                system.has_sapt, impl)
        full = rsp.pair_rows(cm, *args)
        n_cells, ccap = cells[0] * cells[1] * cells[2], cells[3]
        parts = []
        for r in range(4):
            p = rsp.pair_rows(cm, *args,
                              cell_range=AtomShard(None, r, 4).cells(cells))
            lo, hi = split(n_cells, 4, r)
            assert not p[:lo * ccap].any() and not p[hi * ccap:].any()
            _close(p[lo * ccap:hi * ccap], full[lo * ccap:hi * ccap], rtol)
            parts.append(p)
        _close(sum(parts), full, rtol)


def test_charge_spread_shares_sum_on_the_card():
    """B1 over 4 atom ranges, summed, against the whole spread (fp64)."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.parallel.shard import AtomShard
    system, x, box, topo = _flagship_x(torch.float64)
    q = topo.charge.to(torch.float64)
    K, order = system.pme_grid, system.spline_order
    full = pme_spread.charge_grid(x, q, box, K, order)
    shares = [pme_spread.charge_grid(x[a], q[a], box, K, order)
              for a in (AtomShard(None, r, 4).atoms(system.n_atoms)
                        for r in range(4))]
    _close(sum(shares), full, 1e-12)


@pytest.mark.parametrize("scap", [280, 520])
def test_slab_spread_shares_sum_on_the_card(scap):
    """D1 over the 4 atom ranges of a step sharded over 4 ranks, summed,
    against the whole slab spread at the 10k lattice's shapes (K = 64,
    order 6; the deck's slab cap 280 and the 520 a melting run regrows
    to), fp64, no slab overflowing."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.parallel.shard import AtomShard
    x0, q0, L = _water_10k()
    x = torch.tensor(x0, device="cuda")
    q = torch.tensor(q0, device="cuda")
    box = torch.eye(3, dtype=torch.float64, device="cuda") * L
    full, over = pme_slab.charge_grid_slab(x, q, box, 64, 6, scap)
    assert not bool(over)
    shares = []
    for a in (AtomShard(None, r, 4).atoms(x.shape[0]) for r in range(4)):
        g, over = pme_slab.charge_grid_slab(x[a], q[a], box, 64, 6, scap)
        assert not bool(over)
        shares.append(g)
    _close(sum(shares), full, 1e-12)


def test_sharded_scan_world_size_one_matches_unsharded(tmp_path):
    """16 graphed NVE steps through make_atom_sharded_scan at world size 1
    (nccl; the collectives in the captured step) against 16 graphed
    unsharded steps: max |dx| <= 1e-12 A, potentials 1e-10; the graph
    counts four collectives a replay."""
    _need_card()
    import torch.distributed as dist
    from reactive_pb_nn_md_tpu_torch.md import graphs
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble, shard
    sim = _reactive_sim(tmp_path, "NVE")
    args = (sim.system, sim.cbw, sim.cfg.delta_t, "NVE")
    dist.init_process_group("nccl", init_method="file://" + str(
        tmp_path / "store"), rank=0, world_size=1)
    try:
        mesh = ensemble.make_mesh(1, sp=1, device="cuda")
        sscan = ensemble.make_atom_sharded_scan(*args, mesh, 16)
        sscan(sim.ms)
        shard.collectives.clear()
        s, sd = sscan(sim.ms)
        assert dict(shard.collectives) == {"grid": 16, "energy": 16,
                                           "force": 16, "flags": 16}
        assert len(sscan.step_graphs.captures) == 1
    finally:
        dist.destroy_process_group()
    g, gd = integrators.md_scan(sim.ms, *args, 16,
                                step_graphs=graphs.StepGraphs())
    assert not sd.capacities() and not gd.capacities()
    np.testing.assert_allclose(s.state.x.cpu().numpy(),
                               g.state.x.cpu().numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sd.potential.numpy(), gd.potential.numpy(),
                               rtol=1e-10)


def test_dryrun_on_the_cards():
    """The port's dryrun_multichip on up to 2 cards (nccl ranks)."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.parallel import dryrun, mesh
    n = min(2, torch.cuda.device_count())
    p1, p2, bad = mesh.launch(dryrun.dryrun_rank, n, n, "cuda",
                              device="cuda", timeout=600, threads=0)[0]
    assert bad == []
    assert p2["match"] <= dryrun.POT_ATOL and p2["x_err"] <= dryrun.X_ATOL


@functools.lru_cache(maxsize=None)
def _batch_cases(f, W):
    import chip_smoke
    return chip_smoke.batch_cases(f, W)


@pytest.mark.parametrize("name", ["A", "B1", "B2", "C1", "C2", "E"])
@pytest.mark.parametrize("f", [torch.float64, torch.float32])
def test_batched_launch_equals_single_launches(name, f):
    """Kernel `name`'s batched launch (its op's batching rule under
    torch.func.vmap; 3 replicas at the flagship's shapes, chip_smoke.py's
    batch_cases) is one launch and equals 3 single launches (fp64 within
    chip_smoke's BATCH_TOL of max |ref|; the same arithmetic in the same
    order gave equal bits on the H100)."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    bat, _, one, *_ = _batch_cases(f, 3)[name]
    _build.launches.clear()
    got = bat()
    assert dict(_build.launches) == {name: 1}
    ref = torch.stack([one(w) for w in range(3)])
    _close(got, ref, 1e-13 if f == torch.float64 else 1e-5)


@pytest.mark.parametrize("ens", ["NVE", "NVT"])
def test_batched_graphed_scan_matches_in_turn(ens):
    """3 windows x 8 graphed fp64 flagship steps through one captured
    batched step against the windows in turn (ReplicaScan): positions
    within 1e-9 A, one capture, each kernel 8 + 1 launches (the replays
    and the capture's warm-up) against 3 x 8 + 1."""
    _need_card()
    import chip_smoke
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    system, cbw, ladder, batch = chip_smoke.batch_windows(torch.float64, 3,
                                                          ens)
    runs = []
    for cls in (ensemble.ReplicaScan, ensemble.BatchedReplicaScan):
        scan = cls(system, cbw, 0.0005, ens, 8, friction=5.0)
        _build.launches.clear()
        runs.append(scan(batch, ladder) + (scan, dict(_build.launches)))
    (t, td, _, tl), (b, bd, bscan, bl) = runs
    assert not td.capacities() and not bd.capacities()
    assert len(bscan.step_graphs.captures) == 1
    for k in ("A", "B1", "B2", "C1", "C2", "E"):
        assert bl[k] == 9 and tl[k] == 25
    for w in range(3):
        _close(b.states[w].state.x, t.states[w].state.x, 1e-12)
        assert torch.equal(b.generators[w], t.generators[w])


@functools.lru_cache(maxsize=None)
def _batch_cases_10k(f, W):
    import chip_smoke
    return chip_smoke.batch_cases_10k(f, W)


@pytest.mark.parametrize("name", ["A'", "A''", "D1", "D2"])
@pytest.mark.parametrize("f", [torch.float64, torch.float32])
def test_batched_cell_launch_equals_single_launches(name, f):
    """Kernel `name` of the 10k path (A', A'', D1, D2), its op's batching
    rule under torch.func.vmap at 3 replicas of the 10k lattice's shapes
    (chip_smoke.py's batch_cases_10k): one launch, equal to 3 single
    launches (fp64 within chip_smoke's BATCH_TOL of max |ref|)."""
    _need_card()
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    bat, _, one, *_ = _batch_cases_10k(f, 3)[name]
    _build.launches.clear()
    got = bat()
    assert dict(_build.launches) == {name: 1}
    ref = torch.stack([one(w) for w in range(3)])
    _close(got, ref, 1e-13 if f == torch.float64 else 1e-5)


def test_batched_10k_scan_matches_in_turn(tmp_path):
    """2 replicas x 4 graphed fp64 NVT steps of the 10k lattice through
    one captured batched step against the replicas in turn: positions
    within 1e-9 A, each kernel of the 10k path 4 + 1 launches against
    2 x 4 + 1."""
    _need_card()
    import chip_smoke
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    system, cbw, cfg, ms = chip_smoke.batch_lattice(tmp_path, torch.float64)
    batch = ensemble.stack_replicas(ms, 2, seed=3)
    runs = []
    for cls in (ensemble.ReplicaScan, ensemble.BatchedReplicaScan):
        scan = cls(system, cbw, cfg.delta_t, "NVT", 4, friction=1.0)
        _build.launches.clear()
        runs.append(scan(batch) + (scan, dict(_build.launches)))
    (t, td, _, tl), (b, bd, bscan, bl) = runs
    assert not td.capacities() and not bd.capacities()
    assert len(bscan.step_graphs.captures) == 1
    for k in chip_smoke.TENK_KERNELS:
        assert bl[k] == 5 and tl[k] == 9
    for w in range(2):
        _close(b.states[w].state.x, t.states[w].state.x, 1e-12)
        assert torch.equal(b.generators[w], t.generators[w])
