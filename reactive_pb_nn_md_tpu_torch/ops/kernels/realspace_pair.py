"""Kernels A, A', A'': the fused inter-molecular real-space pair sweep.

Replace reactive_pb_nn_md_tpu/ops/pallas/realspace_pair.py:_forward ->
_kernel / _pair_math (A: full 27-stencil; A': the same with half=True,
each unordered pair once) and _forward_column -> _kernel_column (A'': the
half stencil walked one xy column of cells at a time), source
``csrc/realspace_pair.cu``.  Which of them runs is the JAX package's
choice (``_impl_for``): the column walk for grids of at least
_HALF_MIN_CELLS cells (the 10,000-atom box), else the full stencil;
``set_stencil_impl`` overrides it, as in the JAX package.  On the card
A' and A'' are one routine (one block per cell of the half stencil).

Atoms are binned into a static (nc1, nc2, nc3) grid sized by the
real-space cutoff (``System.rs_cells``), in torch: cell id, stable sort,
rank in cell -> slot, and an overflow flag.  The cell-packed array
(n_cells*ccap, 8) [x y z q type mol 0 0] goes to ``pair_rows``, which
returns per-slot [dE_el/dx, dE_vdw/dx, e_el, e_vdw] (A splits each pair
energy over both rows, A' and A'' put it on one) -- the gradients come
out of the forward sweep, so the autograd backward only scales the stored
gradients (as the TPU kernel's custom VJP does).

What bounds them on the H100 and what the designs do about it: see the
source.  ``pair_rows`` runs a CUDA kernel for a CUDA tensor and the plain
torch sweep below, the plain version of all three, for a CPU tensor;
nothing else selects between them.  It is a torch.library op whose
batching rule launches the kernel once for a whole replica batch
(torch.func.vmap over the MD step), a replica grid axis in each.

A cell range (c0, c1) takes the rows of the home cells c0 .. c1 - 1 only,
the others zero: kernel A and the plain sweep compute those cells alone
(A's range launch), A' and A'' sweep every cell and their rows outside
the range are zeroed (their fold assembles each slot's j side from other
cells' blocks).  A row holds its atom's whole gradient and its share of
the pair energies, so the ranges of a partition of the cells sum to the
full sweep (parallel/shard.py splits one step's sweep so over ranks).
The kernel assumes an orthorhombic box (L = diag(box)), as the reference
kernel does; ``suggest_rs_cells`` returns () for any other box.
"""

from typing import Optional

import torch

from ...utils.constants import CONV_E2A_KJMOL, SQRT_PI
from ..binning import bin_slots, cell_counts, stencil_offsets
from . import _build

SENTINEL = 1.0e6            # empty-slot position: far outside any cutoff
# cells per pass of the plain sweep: bounds its (chunk, ccap, 27 ccap)
# pair temporaries to a few MB at the flagship's ccap of 24
_CELL_CHUNK = 16
# the JAX package's crossover: grids of this many cells take the column
# walk (realspace_pair.py:77)
_HALF_MIN_CELLS = 200
# A' / A'': pairs one flush of the pair list evaluates, and threads a
# block (csrc/realspace_pair.cu's PAIR_LIST, HALF_THREADS)
_PAIR_LIST = 256
_HALF_THREADS = 128
# A: warps a block and each warp's survivor ring (FULL_WARPS, FULL_RING),
# and the blocks a launch should at least have: a grid of fewer cells
# cuts each cell's atoms into parts.  128 (2 parts a cell at the
# flagship's 64) ran faster than 192 or 256 on the H100, whose 132 SMs
# then take one block each (tools/time_pair.py --min-blocks; PERF.md)
_FULL_WARPS = 8
_FULL_RING = 256
_FULL_MIN_BLOCKS = 128
SMEM_LIMIT = 227 * 1024                 # shared memory a block can use
_STENCIL_IMPL = "auto"                  # "auto" | "full" | "half" | "column"
# kernel launched by each stencil implementation
KERNEL_OF = {"full": "A", "half": "A'", "column": "A''"}


def set_stencil_impl(impl):
    """Select the stencil enumeration: "auto" (the column walk for grids
    of >= _HALF_MIN_CELLS cells, else the full stencil), "full", "half"
    or "column"."""
    global _STENCIL_IMPL
    if impl not in ("auto", "full", "half", "column"):
        raise ValueError(f"unknown stencil impl {impl!r}")
    _STENCIL_IMPL = impl


def _impl_for(cells):
    if _STENCIL_IMPL == "auto":
        big = cells[0] * cells[1] * cells[2] >= _HALF_MIN_CELLS
        return "column" if big else "full"
    return _STENCIL_IMPL


def build_tabs(system, dtype):
    """(n_tab, T, T) tables: vdw_type, C12, C6 [, A, B, C8, C10, C12]."""
    ff = system.ff
    p = ff.vdw_params.to(dtype)
    is_lj = ff.vdw_type == 0
    zero = torch.zeros_like(p[..., 0])
    tabs = [ff.vdw_type.to(dtype), torch.where(is_lj, p[..., 0], zero),
            torch.where(is_lj, p[..., 1], p[..., 2])]
    if system.has_sapt:
        tabs += [p[..., 0], p[..., 1], p[..., 3], p[..., 4], p[..., 5]]
    return torch.stack(tabs).contiguous()


def bin_atoms(x, box, cells, cutoff):
    """(slot (N,), overflow ()): the packed row of every atom; overflow
    when a cell holds more than ccap atoms or a cell is narrower than the
    cutoff."""
    nc1, nc2, nc3, ccap = cells
    ncv = cell_counts(nc1, nc2, nc3, x.device)
    L = torch.diagonal(box)
    frac = x / L
    frac = frac - torch.floor(frac)
    ci = torch.minimum((frac * ncv).to(torch.int64), ncv - 1).clamp(min=0)
    cell_id = (ci[:, 0] * nc2 + ci[:, 1]) * nc3 + ci[:, 2]
    slot, over = bin_slots(cell_id, nc1 * nc2 * nc3, ccap)
    return slot, over | (L / ncv < cutoff).any()


def pack_cells(x, charge, atype, mol, slot, cells):
    """(n_cells*ccap, 8) [x y z q type mol 0 0]; empty slots get the
    sentinel position and mol = -1."""
    nc1, nc2, nc3, ccap = cells
    C8 = nc1 * nc2 * nc3 * ccap
    f = x.dtype
    base = torch.zeros((C8 + 1, 8), dtype=f, device=x.device)
    base[:, 0:3] = SENTINEL
    base[:, 5] = -1.0
    vals = torch.cat([x, charge[:, None].to(f), atype[:, None].to(f),
                      mol[:, None].to(f),
                      torch.zeros((x.shape[0], 2), dtype=f, device=x.device)],
                     dim=1)
    # out of place: a replica batch vmaps this function
    return base.index_put((slot,), vals)[:C8].contiguous()


def _stencil(cells, device):
    """(n_cells, 27) neighbor cell ids, offsets in lexicographic order."""
    nc1, nc2, nc3, _ = cells
    c = torch.arange(nc1 * nc2 * nc3, device=device)
    c1, c2, c3 = c // (nc2 * nc3), (c // nc3) % nc2, c % nc3
    o = stencil_offsets(device)
    return ((((c1[:, None] + o[:, 0]) % nc1) * nc2
             + (c2[:, None] + o[:, 1]) % nc2) * nc3
            + (c3[:, None] + o[:, 2]) % nc3)


def pair_rows_plain(cm, tabs, cells, L, rcut, alpha, has_sapt,
                    cell_range=None):
    """Plain torch version of the kernel: same inputs, same output."""
    nc1, nc2, nc3, ccap = cells
    n_cells = nc1 * nc2 * nc3
    lo, hi = (0, n_cells) if cell_range is None else cell_range
    T = tabs.shape[-1]
    cmr = cm.view(n_cells, ccap, 8)
    nb = _stencil(cells, cm.device)
    conv = CONV_E2A_KJMOL
    out = []
    for c0 in range(lo, hi, _CELL_CHUNK):
        cs = torch.arange(c0, min(c0 + _CELL_CHUNK, hi), device=cm.device)
        own = cmr[cs][:, :, None, :]                           # (n, ccap, 1, 8)
        cand = cmr[nb[cs]].reshape(len(cs), 1, 27 * ccap, 8)   # (n, 1, J, 8)
        gid_i = (cs[:, None] * ccap
                 + torch.arange(ccap, device=cm.device))[:, :, None]
        gid_j = (nb[cs][:, :, None] * ccap
                 + torch.arange(ccap, device=cm.device)).reshape(len(cs),
                                                                1, -1)
        d = own[..., 0:3] - cand[..., 0:3]
        d = d - L * torch.round(d * (1.0 / L))
        r2 = (d * d).sum(-1)
        moli, molj = own[..., 5], cand[..., 5]
        within = ((r2 < rcut * rcut) & (moli != molj) & (moli >= 0)
                  & (molj >= 0) & (gid_i != gid_j))
        one = torch.ones_like(r2)
        r2s = torch.where(within, r2, one)
        inv_r2 = 1.0 / r2s
        r = torch.sqrt(r2s)
        inv_r = 1.0 / r
        qq = own[..., 3] * cand[..., 3] * conv
        ar_ = alpha * r
        erfc_ar = torch.erfc(ar_)
        e_el = qq * erfc_ar * inv_r
        s_el = qq * (erfc_ar * inv_r + 2.0 * alpha / SQRT_PI
                     * torch.exp(-ar_ * ar_)) * inv_r2
        p = (torch.round(own[..., 4]).long() * T
             + torch.round(cand[..., 4]).long())
        tab = tabs.reshape(tabs.shape[0], T * T)[:, p]        # (n_tab, ...)
        vt, c12, c6 = tab[0], tab[1], tab[2]
        inv_r6 = inv_r2 * inv_r2 * inv_r2
        inv_r12 = inv_r6 * inv_r6
        zero = torch.zeros_like(r2)
        is_lj = vt == 0
        e_v = torch.where(is_lj, c12 * inv_r12 - c6 * inv_r6, zero)
        s_v = torch.where(is_lj, (12.0 * c12 * inv_r12 - 6.0 * c6 * inv_r6)
                          * inv_r2, zero)
        if has_sapt:
            A, B = tab[3], tab[4]
            Cs = [c6, tab[5], tab[6], tab[7]]
            x_tt = torch.clamp(B * r, max=40.0)
            ex = torch.exp(-x_tt)
            e_s = A * ex
            s_s = A * B * ex * inv_r
            term = torch.ones_like(x_tt)
            ssum = torch.ones_like(x_tt)
            inv_rn = inv_r6
            fact = 1.0
            for n in range(1, 13):
                fact = fact * n
                term = term * x_tt
                ssum = ssum + term / fact
                if n in (6, 8, 10, 12):
                    fn = 1.0 - ssum * ex
                    dfn = ex * term / fact
                    Cn = Cs[(n - 6) // 2]
                    e_s = e_s - fn * Cn * inv_rn
                    s_s = s_s + (B * dfn * Cn * inv_rn
                                 - n * fn * Cn * inv_rn * inv_r) * inv_r
                    inv_rn = inv_rn * inv_r2
            e_v = torch.where(vt == 1, e_s, e_v)
            s_v = torch.where(vt == 1, s_s, s_v)
        e_el = torch.where(within, e_el, zero)
        e_v = torch.where(within, e_v, zero)
        d = torch.where(within[..., None], d, torch.zeros_like(d))
        s_el = torch.where(within, s_el, zero)[..., None]
        s_v = torch.where(within, s_v, zero)[..., None]
        out.append(torch.cat([-(s_el * d).sum(2), -(s_v * d).sum(2),
                              0.5 * e_el.sum(2, keepdim=True),
                              0.5 * e_v.sum(2, keepdim=True)], dim=-1))
    if cell_range is None:
        return torch.cat(out).reshape(n_cells * ccap, 8)
    rows = torch.zeros((n_cells * ccap, 8), dtype=cm.dtype, device=cm.device)
    if out:
        rows[lo * ccap:hi * ccap] = torch.cat(out).reshape(-1, 8)
    return rows


def _check(cm, tabs, cells, box, name):
    nc1, nc2, nc3, ccap = cells
    f = cm.dtype
    _build.require(cm, f, (nc1 * nc2 * nc3 * ccap, 8), "cm")
    _build.require(tabs, f, None, "tabs")
    _build.require(box, f, (3, 3), "box")
    n_tab, T = tabs.shape[0], tabs.shape[-1]
    if n_tab * T * T * cm.element_size() > 48 * 1024:
        raise ValueError("parameter tables exceed 48 KB of shared memory")
    if min(nc1, nc2, nc3) < 3:
        raise ValueError(f"kernel {name} needs >= 3 cells along every axis")
    return n_tab, T


def _check_batch(cm, tabs, cells, box, name, nb):
    """_check of a launch, with nb of a batched launch of nb replicas (cm
    (nb, n_cells ccap, 8), tabs and box each stacked on a leading axis of
    nb or shared by the batch): (n_tab, T, the strides of cm, tabs and box
    between replicas)."""
    if not nb:
        return _check(cm, tabs, cells, box, name) + ((0, 0, 0),)
    nc1, nc2, nc3, ccap = cells
    C8 = nc1 * nc2 * nc3 * ccap
    _build.require(cm, cm.dtype, (nb, C8, 8), "cm")
    strides = (C8 * 8, _build.stride(tabs, 3, nb), _build.stride(box, 2, nb))
    n_tab, T = _check(cm[0], tabs if tabs.ndim == 3 else tabs[0], cells,
                      box if box.ndim == 2 else box[0], name)
    _build.require(tabs, cm.dtype, None, "tabs")
    _build.require(box, cm.dtype, None, "box")
    return n_tab, T, strides


def full_parts(cells):
    """Blocks per cell of kernel A (the launch is (n_cells, parts)): enough
    for _FULL_MIN_BLOCKS blocks, at most ccap.  Block (c, p) takes cell
    c's occupied slots p, p + parts, ...; 2 at the flagship's (4, 4, 4,
    24), 1 at the 10k lattice's (10, 10, 10, 24)."""
    nc1, nc2, nc3, ccap = cells
    return max(1, min(ccap, -(-_FULL_MIN_BLOCKS // (nc1 * nc2 * nc3))))


def check_full_smem(n_tabv, cells, itemsize, name="A"):
    """Bytes of shared memory kernel A takes at `cells`, the layout of
    csrc/realspace_pair.cu's full_smem_t: per block the 27 stencil cells'
    staged slots (x, y, z, q: 4 values; type, mol, the occupied list: 3
    ints), the partial rows (8 values for each of max(ccap, warps)), the
    occupancy words (one a 32 slots) and the warps' survivor rings.  It
    grows with ccap, not with the grid.  ValueError with the numbers when
    it does not fit one block."""
    ccap = cells[3]
    n = 27 * ccap
    smem = ((n_tabv + 4 * n + 8 * max(ccap, _FULL_WARPS)) * itemsize
            + (3 * n + -(-n // 32) + _FULL_WARPS * _FULL_RING) * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"kernel {name} needs {smem} B of shared memory at "
                         f"cells {tuple(cells)} ({itemsize}-byte values), "
                         f"over the {SMEM_LIMIT} B a block can use")
    return smem


def _cell_range(cells, cell_range):
    """(c0, c1) of `cell_range` (None: every cell), checked."""
    n_cells = cells[0] * cells[1] * cells[2]
    if cell_range is None:
        return 0, n_cells
    c0, c1 = (int(c) for c in cell_range)
    if not 0 <= c0 <= c1 <= n_cells:
        raise ValueError(f"cell range {cell_range} outside the "
                         f"{n_cells} cells")
    return c0, c1


def pair_rows_cuda(cm, tabs, cells, box, rcut, alpha, has_sapt,
                   cell_range=None, nb=None):
    """Launch kernel A (box: (3, 3), orthorhombic), over the home cells
    of `cell_range` only when given (the other rows zero).  With nb, a
    batched launch of nb replicas: cm (nb, n_cells ccap, 8), tabs and box
    each stacked on a leading axis of nb or shared by the batch; the rows
    come back (nb, n_cells ccap, 8)."""
    nc1, nc2, nc3, ccap = cells
    n_tab, T, strides = _check_batch(cm, tabs, cells, box, "A", nb)
    c0, c1 = _cell_range(cells, cell_range)
    check_full_smem(n_tab * T * T, cells, cm.element_size())
    if cm.data_ptr() % 16:
        raise ValueError("kernel A reads cm rows in 16-byte loads: cm must "
                         "be 16-byte aligned")
    f = cm.dtype
    full = c1 - c0 == nc1 * nc2 * nc3
    out = torch.empty_like(cm) if full else torch.zeros_like(cm)
    if c1 == c0:
        return out
    fn = _build.function("rs_pair_" + _build.suffix(f), 5, 14, 3)
    _build.check(fn(cm.data_ptr(), tabs.data_ptr(), box.data_ptr(),
                    out.data_ptr(), _build.stream_ptr(cm), nc1, nc2, nc3,
                    ccap, full_parts(cells), c0, c1 - c0, T, n_tab,
                    int(bool(has_sapt)), nb or 1, *strides,
                    float(rcut) ** 2, float(alpha), CONV_E2A_KJMOL), "A")
    _build.launches["A"] += 1
    return out


def check_half_smem(n_tabv, cells, itemsize, name):
    """Bytes of shared memory kernels A' / A'' take at `cells`, the layout
    of csrc/realspace_pair.cu's half_smem_t: per block the 14 stencil
    cells' staged slots (x, y, z, q and the j-side sums: 10 values; mol,
    type, slot map: 3 ints), the pair list's terms and keys, the i-side
    rows, the run starts, counts and cell ids.  It grows with ccap, not
    with the grid.  ValueError with the numbers when it does not fit one
    block."""
    ccap = cells[3]
    n = 14 * ccap
    warps = _HALF_THREADS // 32
    smem = ((n_tabv + 10 * n + 8 * _PAIR_LIST + 8 * ccap) * itemsize
            + (3 * n + _PAIR_LIST + ccap + 1 + 48 + 2 * warps) * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(f"kernel {name} needs {smem} B of shared memory at "
                         f"cells {tuple(cells)} ({itemsize}-byte values), "
                         f"over the {SMEM_LIMIT} B a block can use")
    return smem


def pair_rows_half_cuda(cm, tabs, cells, box, rcut, alpha, has_sapt,
                        column, nb=None):
    """Launch kernel A'' (column) or A' (half stencil) and their fold:
    per-slot rows with each pair's energy on one row.  On the card both
    are one routine (one block per cell); `column` names the launch.
    With nb, a batched launch of nb replicas, as pair_rows_cuda's."""
    name = KERNEL_OF["column" if column else "half"]
    n_tab, T, strides = _check_batch(cm, tabs, cells, box, name, nb)
    nc1, nc2, nc3, ccap = cells
    check_half_smem(n_tab * T * T, cells, cm.element_size(), name)
    C8 = nc1 * nc2 * nc3 * ccap
    R = nb or 1
    # one scratch: each replica's cells' own rows (C8, 8), then each
    # replica's 13 per-offset j-side arrays (13, C8, 6), every slot of
    # which has one writer
    scratch = torch.empty(R * (C8 * 8 + 13 * C8 * 6), dtype=cm.dtype,
                          device=cm.device)
    out = torch.empty_like(cm)
    fn = _build.function("rs_half_" + _build.suffix(cm.dtype), 7, 11, 3)
    _build.check(fn(cm.data_ptr(), tabs.data_ptr(), box.data_ptr(),
                    scratch.data_ptr(),
                    scratch.data_ptr() + R * C8 * 8 * cm.element_size(),
                    out.data_ptr(),
                    _build.stream_ptr(cm), nc1, nc2, nc3, ccap, T, n_tab,
                    int(bool(has_sapt)), R, *strides, float(rcut) ** 2,
                    float(alpha), CONV_E2A_KJMOL), name)
    _build.launches[name] += 1
    return out


@torch.library.custom_op(_build.OPS + "::pair_rows", mutates_args=())
def pair_rows(cm: torch.Tensor, tabs: torch.Tensor, cells: list[int],
              box: torch.Tensor, rcut: float, alpha: float, has_sapt: bool,
              impl: str = "full",
              cell_range: Optional[list[int]] = None) -> torch.Tensor:
    """Per-slot [dE_el/dx (3), dE_vdw/dx (3), e_el, e_vdw]: for a CUDA
    tensor the kernel of `impl` (A "full", A' "half", A'' "column"), for
    a CPU tensor the plain sweep (whose rows split each pair energy in
    two, as A's do; the sums agree).  cell_range: the home cells (c0,
    c1) whose rows to give, the others zero (see the module docstring).
    Under a replica batch (vmap) the kernel launches once for all
    replicas."""
    cells = tuple(cells)
    if not cm.is_cuda:
        if cell_range is not None:
            cell_range = _cell_range(cells, cell_range)
        return pair_rows_plain(cm, tabs, cells, torch.diagonal(box), rcut,
                               alpha, has_sapt, cell_range)
    box = box.contiguous()
    if impl == "full":
        return pair_rows_cuda(cm, tabs, cells, box, rcut, alpha, has_sapt,
                              cell_range)
    return _in_range(pair_rows_half_cuda(cm, tabs, cells, box, rcut, alpha,
                                         has_sapt, column=impl == "column"),
                     cells, cell_range)


def _in_range(rows, cells, cell_range):
    """A' / A'' `rows` ((..., n_cells ccap, 8)) with those outside the
    home cells of `cell_range` zeroed (None: all kept)."""
    if cell_range is None:
        return rows
    c0, c1 = _cell_range(cells, cell_range)
    ccap = cells[3]
    slot = torch.arange(rows.shape[-2], device=rows.device)[:, None]
    keep = (slot >= c0 * ccap) & (slot < c1 * ccap)
    return torch.where(keep, rows, torch.zeros_like(rows))


@pair_rows.register_fake
def _(cm, tabs, cells, box, rcut, alpha, has_sapt, impl="full",
      cell_range=None):
    return torch.empty_like(cm)


@pair_rows.register_vmap
def _(info, in_dims, cm, tabs, cells, box, rcut, alpha, has_sapt,
      impl="full", cell_range=None):
    nb = info.batch_size
    cm, tabs, box = _build.front((cm, tabs, box), (in_dims[0], in_dims[1],
                                                   in_dims[3]))
    if in_dims[0] is None:
        cm = cm.expand(nb, *cm.shape).contiguous()
    if cm.is_cuda:
        cells = tuple(cells)
        if impl == "full":
            return pair_rows_cuda(cm, tabs, cells, box, rcut, alpha,
                                  has_sapt, cell_range, nb=nb), 0
        return _in_range(pair_rows_half_cuda(
            cm, tabs, cells, box, rcut, alpha, has_sapt,
            column=impl == "column", nb=nb), cells, cell_range), 0
    dims = (0, in_dims[1], in_dims[3])
    return torch.stack([
        pair_rows(c, t, cells, b, rcut, alpha, has_sapt, impl, cell_range)
        for c, t, b in (_build.replica((cm, tabs, box), dims, i)
                        for i in range(nb))]), 0


class RealspaceInterCells(torch.autograd.Function):
    """(e_elec, e_vdw, overflow, the rows' gradients) over all
    inter-molecular pairs within the cutoff; differentiable in x only
    (the stored analytic gradients).  With a cell range, the home cells'
    share: their atoms' gradients and their rows' energies (pair_rows).
    The sweep is the op pair_rows, so under a replica batch (vmap)
    kernel A, A' or A'' launches once for all replicas."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x, charge, atype, mol, box, tabs, cells, rcut, alpha,
                has_sapt, cell_range=None):
        slot, overflow = bin_atoms(x, box, cells, rcut)
        cm = pack_cells(x, charge, atype, mol, slot, cells)
        f = pair_rows(cm, tabs, cells, box, rcut, alpha, has_sapt,
                      _impl_for(cells), cell_range)
        g = torch.cat([f, torch.zeros_like(f[:1])])[slot]
        return f[:, 6].sum(), f[:, 7].sum(), overflow, g[:, 0:6]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output[3])
        ctx.mark_non_differentiable(output[2], output[3])

    @staticmethod
    def backward(ctx, ge, gv, *_):
        g, = ctx.saved_tensors
        return (ge * g[:, 0:3] + gv * g[:, 3:6],) + (None,) * 10


def realspace_inter_cells(x, charge, atype, mol, box, tabs, cells, rcut,
                          alpha, has_sapt, cell_range=None):
    return RealspaceInterCells.apply(x, charge, atype, mol, box, tabs,
                                     cells, float(rcut), float(alpha),
                                     bool(has_sapt), cell_range)[:3]
