"""Kernel A's plain version (the cell-binned torch sweep) against the JAX
package on the 63-water, cutoff-3.0 setup of tests/test_pallas_realspace.py:
the XLA half-list path at 1e-10 relative, and the Pallas kernel in
interpret mode at that file's tolerances (its erfc is A&S 7.1.26)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import fixture_deck
from reactive_pb_nn_md_tpu.topology import build_system as jax_build
from reactive_pb_nn_md_tpu.models import total as jax_total
from reactive_pb_nn_md_tpu.ops import neighbors as jax_nb
from reactive_pb_nn_md_tpu.ops.pallas import realspace_pair as jax_rsp
from reactive_pb_nn_md_tpu_torch.topology import build_system
from reactive_pb_nn_md_tpu_torch.models import total
from reactive_pb_nn_md_tpu_torch.md import integrators
from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp


def _setup(tmp_path, ff):
    frame, ffr, topr, cfg = fixture_deck(tmp_path, 63, seed=4, cutoff=3.0,
                                         verlet_cutoff=4.0,
                                         sapt=ff == "sapt")
    jsys, jtopo = jax_build(frame, ffr, topr, cfg)
    tsys, ttopo = build_system(frame, ffr, topr, cfg, device="cpu")
    assert tsys.rs_cells and tsys.has_sapt == (ff == "sapt")
    return frame, jsys, jtopo, tsys, ttopo


def _port(tsys, ttopo, x, box):
    """(e_el, e_vdw, dE_el/dx + 0.37 dE_vdw/dx) of the plain cell sweep."""
    xt = torch.tensor(x, requires_grad=True)
    e_el, e_vdw, over = total.realspace_inter(xt, torch.tensor(box), ttopo,
                                              tsys, None)
    assert not bool(over)
    g, = torch.autograd.grad(e_el + 0.37 * e_vdw, xt)
    return float(e_el.detach()), float(e_vdw.detach()), g.numpy()


def _jax(fn, x):
    def e(xx):
        a, b = fn(xx)
        return a + 0.37 * b, (a, b)
    (_, (a, b)), g = jax.jit(jax.value_and_grad(e, has_aux=True))(
        jnp.asarray(x))
    return float(a), float(b), np.asarray(g)


@pytest.mark.parametrize("ff", ["lj", "sapt"])
def test_cell_sweep_matches_half_list(tmp_path, ff):
    frame, jsys, jtopo, tsys, ttopo = _setup(tmp_path, ff)
    x, box = frame.xyz, frame.box
    jbox = jnp.asarray(box)
    cap = jax_nb.suggest_capacity(jsys.n_atoms, float(np.prod(np.diag(box))),
                                  jsys.verlet_cutoff, safety=2.0)
    nl = jax_nb.build_neighbor_list(jnp.asarray(x), jbox,
                                    jsys.verlet_cutoff, cap)
    pairs = jax_nb.neighbor_pairs(nl)
    ref = _jax(lambda xx: jax_total._realspace_inter_xla(
        xx, jbox, jtopo, jsys, pairs), x)
    got = _port(tsys, ttopo, x, box)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-10)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-10)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-10,
                               atol=1e-10 * np.abs(ref[2]).max())


@pytest.mark.parametrize("ff", ["lj", "sapt"])
def test_cell_sweep_matches_pallas_interpret(tmp_path, ff):
    frame, jsys, jtopo, tsys, ttopo = _setup(tmp_path, ff)
    x, box = frame.xyz, frame.box
    jbox = jnp.asarray(box)
    f = jnp.float64
    tabs = jax_rsp._build_tabs(jsys, f)
    consts = (float(jsys.real_space_cutoff), float(jsys.alpha_sqrt),
              bool(jsys.has_sapt), int(jsys.ff.vdw_type.shape[0]))
    ref = _jax(lambda xx: jax_rsp.realspace_inter_cells(
        xx, jtopo.charge.astype(f), jtopo.atom_type.astype(f),
        jtopo.atom_mol.astype(f), jbox, tabs, jsys.rs_cells, consts), x)
    got = _port(tsys, ttopo, x, box)
    # tolerances of tests/test_pallas_realspace.py: e_el carries the A&S
    # erfc (1.5e-7 absolute per pair); vdW shares no approximation
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=5e-3)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-9)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("impl", ["half", "column"])
def test_cell_sweep_matches_pallas_half_and_column(tmp_path, impl):
    """Kernels A' and A'' compute kernel A's function, so the plain cell
    sweep is their plain version: it is held against the JAX package's
    half-stencil and column-walk kernels in interpret mode, at the
    function level (e_el, e_vdw, per-atom gradient) -- the half paths put
    a whole pair's energy on one row.  Tolerances as
    test_cell_sweep_matches_pallas_interpret (the TPU erfc)."""
    frame, jsys, jtopo, tsys, ttopo = _setup(tmp_path, "lj")
    x, box = frame.xyz, frame.box
    jbox = jnp.asarray(box)
    f = jnp.float64
    tabs = jax_rsp._build_tabs(jsys, f)
    consts = (float(jsys.real_space_cutoff), float(jsys.alpha_sqrt),
              bool(jsys.has_sapt), int(jsys.ff.vdw_type.shape[0]))
    try:
        jax_rsp.set_stencil_impl(impl)
        rsp.set_stencil_impl(impl)
        assert rsp._impl_for(tsys.rs_cells) == impl
        ref = _jax(lambda xx: jax_rsp.realspace_inter_cells(
            xx, jtopo.charge.astype(f), jtopo.atom_type.astype(f),
            jtopo.atom_mol.astype(f), jbox, tabs, jsys.rs_cells, consts), x)
        got = _port(tsys, ttopo, x, box)
    finally:
        jax_rsp.set_stencil_impl("auto")
        rsp.set_stencil_impl("auto")
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=5e-3)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-9)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-4)


def test_stencil_selection_follows_jax():
    for cells in ((4, 4, 4, 24), (5, 5, 8, 16), (10, 10, 10, 24)):
        assert rsp._impl_for(cells) == jax_rsp._impl_for(cells)
    assert rsp._impl_for((10, 10, 10, 24)) == "column"
    assert rsp.KERNEL_OF == {"full": "A", "half": "A'", "column": "A''"}
    with pytest.raises(ValueError):
        rsp.set_stencil_impl("quarter")


def test_bin_atoms_overflow(tmp_path):
    frame, _, _, tsys, _ = _setup(tmp_path, "lj")
    x = torch.tensor(frame.xyz)
    box = torch.tensor(frame.box)
    cells, rc = tsys.rs_cells, tsys.real_space_cutoff
    slot, over = rsp.bin_atoms(x, box, cells, rc)
    assert not bool(over)
    assert len(set(slot.tolist())) == x.shape[0]
    assert bool(rsp.bin_atoms(torch.zeros_like(x) + 0.1, box, cells, rc)[1])
    assert bool(rsp.bin_atoms(x * 0.5, box * 0.5, cells, rc)[1])
    # the JAX package's probe agrees on all three
    for xx, bb in ((x, box), (torch.zeros_like(x) + 0.1, box),
                   (x * 0.5, box * 0.5)):
        assert bool(jax_rsp.rs_cell_overflow(
            jnp.asarray(xx.numpy()), jnp.asarray(bb.numpy()), cells, rc)) \
            == bool(rsp.bin_atoms(xx, bb, cells, rc)[1])


def test_cell_overflow_reaches_the_step_flags(tmp_path):
    """The forward's own binning reports the overflow, and the step's flag
    sync names it (the simulation loop then regrows), beside an EVB
    state-cap overflow."""
    frame, _, _, tsys, ttopo = _setup(tmp_path, "lj")
    box = torch.tensor(frame.box)
    flags = []
    no = torch.zeros((), dtype=torch.bool)
    for x in (torch.tensor(frame.xyz),
              torch.zeros((tsys.n_atoms, 3), dtype=torch.float64) + 0.1):
        *_, over = total.realspace_inter(x, box, ttopo, tsys, None)
        flags.append(bool(over))
        fe = SimpleNamespace(breakdown=SimpleNamespace(rs_overflow=over,
                                                       slab_overflow=no),
                             evb_overflow=no, row_overflow=no,
                             force=torch.zeros_like(x))
        got = integrators.overflow_names(integrators.capacity_flags(
            SimpleNamespace(overflow=no), fe))
        assert got == (("kernel A cell capacity",) if bool(over) else ())
    assert flags == [False, True]
    fe.evb_overflow = torch.ones((), dtype=torch.bool)
    assert integrators.overflow_names(integrators.capacity_flags(
        SimpleNamespace(overflow=no), fe)) == ("kernel A cell capacity",
                                               "EVB state cap")


def test_half_kernel_shared_memory_fits_and_raises():
    """Kernels A' / A'' take shared memory by ccap alone: it fits one
    block at every capacity a cell regrow reaches from the 10k deck, on
    grids of any length, and the check raises with the numbers where a
    capacity does not fit."""
    n_tabv = 8 * 4 * 4                     # SAPT tables of 4 types
    for itemsize in (8, 4):
        for ccap in (24, 40, 64, 96, 100):
            sizes = {rsp.check_half_smem(n_tabv, (10, 10, nc3, ccap),
                                         itemsize, "A''")
                     for nc3 in (10, 16, 20, 64)}
            assert len(sizes) == 1 and sizes.pop() <= rsp.SMEM_LIMIT
    # at the 10k deck's cells, at least two blocks fit an SM in fp64
    assert 2 * rsp.check_half_smem(n_tabv, (10, 10, 10, 24), 8,
                                   "A''") <= rsp.SMEM_LIMIT
    assert rsp.check_half_smem(n_tabv, (10, 10, 10, 100), 8, "A''") == (
        (n_tabv + 10 * 1400 + 8 * 256 + 800) * 8
        + (3 * 1400 + 256 + 101 + 48 + 8) * 4)
    with pytest.raises(ValueError, match=r"needs \d+ B of shared memory at "
                                         r"cells \(10, 10, 10, 200\)"):
        rsp.check_half_smem(n_tabv, (10, 10, 10, 200), 8, "A''")


def test_full_kernel_shared_memory_fits_and_raises():
    """Kernel A takes shared memory by ccap alone: it fits one block at the
    flagship's and the 10k lattice's cells in both dtypes, and at every
    capacity a cell regrow reaches from them (24 -> 40 -> 64 -> 96), on
    grids of any length; the check raises with the numbers where a
    capacity does not fit."""
    n_tabv = 8 * 4 * 4                     # SAPT tables of 4 types
    for itemsize in (8, 4):
        for ccap in (24, 40, 64, 96):
            sizes = {rsp.check_full_smem(n_tabv, (n, n, n, ccap), itemsize)
                     for n in (3, 4, 10, 16)}
            assert len(sizes) == 1 and sizes.pop() <= rsp.SMEM_LIMIT
    # at the flagship's cells, several blocks fit an SM in fp64
    assert 5 * rsp.check_full_smem(n_tabv, (4, 4, 4, 24), 8) <= \
        rsp.SMEM_LIMIT
    assert rsp.check_full_smem(n_tabv, (4, 4, 4, 24), 8) == (
        (n_tabv + 4 * 648 + 8 * 24) * 8 + (3 * 648 + 21 + 8 * 256) * 4)
    with pytest.raises(ValueError, match=r"kernel A needs \d+ B of shared "
                                         r"memory at cells \(4, 4, 4, 200\)"):
        rsp.check_full_smem(n_tabv, (4, 4, 4, 200), 8)


def test_full_kernel_launch_shape():
    """Kernel A's blocks per cell: 128 blocks (about one an SM of the
    H100, measured faster than two) on the flagship's 64 cells, one a cell
    on grids of 128 cells or more, never more parts than slots; and every
    occupied slot of a cell goes to exactly one (part, item) of the
    launch."""
    assert rsp.full_parts((4, 4, 4, 24)) == 2
    assert rsp.full_parts((10, 10, 10, 24)) == 1
    assert rsp.full_parts((3, 3, 3, 2)) == 2
    assert rsp.full_parts((3, 3, 3, 8)) == 5
    for cells in ((4, 4, 4, 24), (3, 3, 3, 8), (5, 5, 8, 16)):
        parts = rsp.full_parts(cells)
        for n0 in range(cells[3] + 1):
            seen = []
            for p in range(parts):           # the kernel's item arithmetic
                m = -(-(n0 - p) // parts) if p < n0 else 0
                seen += [p + parts * a for a in range(m)]
            assert sorted(seen) == list(range(n0))


def test_kernel_stencil_orders_follow_jax():
    """The stencil offsets the CUDA kernels walk are the JAX kernel's
    (_offsets): the full stencil as a permutation with the cell itself
    first (the arithmetic of csrc's full_off, mirrored here), and the half
    stencil in its order (csrc's HALF_OFF table)."""
    import pathlib
    import re
    full = []
    for k in range(27):
        m = 13 if k == 0 else k - 1 + (k >= 14)     # lexicographic index
        full.append((m // 9 - 1, (m // 3) % 3 - 1, m % 3 - 1))
    ref = [tuple(o) for o in jax_rsp._offsets(False)]
    assert full == [(0, 0, 0)] + [o for o in ref if o != (0, 0, 0)]
    src = (pathlib.Path(rsp.__file__).resolve().parents[2] / "csrc"
           / "realspace_pair.cu").read_text()
    body = re.search(r"HALF_OFF\[14\]\[3\] = \{(.*?)\};", src,
                     re.S).group(1)
    assert [tuple(int(v) for v in t.split(","))
            for t in re.findall(r"\{([-\d, ]+)\}", body)] == [
        tuple(o) for o in jax_rsp._offsets(True)]
