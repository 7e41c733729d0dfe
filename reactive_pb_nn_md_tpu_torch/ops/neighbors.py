"""Fixed-capacity Verlet neighbor lists (counterpart of
reactive_pb_nn_md_tpu/ops/neighbors.py).

Two builds, picked by a static cell grid as in the JAX package:

  * dense (``cells == ()``): a chunked O(N^2) distance sweep, used below
    1024 atoms;
  * cell list (``suggest_cells``): atoms are binned into a fixed
    (nc1, nc2, nc3) fractional grid of per-cell capacity ccap by one
    sort, and each atom's candidates are its 27 stencil cells.  With
    ``on_demand`` (the MS-EVB path) nothing (N, K)-shaped is
    materialized: the cell table itself is kept (``CellTable``) and the
    EVB layer extracts the few dozen rows it reads with
    ``rows_on_demand``.

The half list is a padded (N, K) tensor of neighbors j > i; the full and
short-cutoff ("react") adjacencies hold every neighbor, ascending j.
Intra-molecular pairs are kept and masked at use time with each diabat's
molecule assignment, so one list serves every diabat.  Every capacity
(row, cell, box width per cell) sets the overflow flag; the simulation
loop regrows the capacities and rebuilds.
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils import pbc
from .binning import bin_slots, cell_counts, stencil_offsets

# candidate atoms per pass of the materialized cell sweep (bounds its
# (chunk, 27 ccap) temporaries)
_CELL_CHUNK = 2048


@dataclass
class CellTable:
    """Persisted cell table for on-demand adjacency rows.

    pos holds each slot's fractional coordinates at build time and ids
    its atom (n_atoms in empty slots).  A pair within the use-time cutoff
    was within `cutoff` (use cutoff + skin) at build time as long as the
    displacement trigger fires before the drift exceeds the skin, so
    filtering the stale table positions at `cutoff` keeps every true pair
    (the same coverage the materialized Verlet rows give)."""
    pos: torch.Tensor                    # (n_cells, ccap, 3) fractional
    ids: torch.Tensor                    # (n_cells, ccap) atom, N if empty
    cutoff: float
    cells: tuple
    row_cap: int
    n_atoms: int

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class NeighborList:
    idx: torch.Tensor                 # (N, K) half list, -1 pad; (N, 0) if skipped
    full_idx: torch.Tensor            # (N, Kf) all neighbors, ascending j; (N, 0) on demand
    ref_x: torch.Tensor               # (N, 3) positions at build time
    overflow: torch.Tensor            # () bool
    capacity: int
    react_idx: Optional[torch.Tensor] = None   # (N, Kr) short-cutoff rows
    react_cutoff: float = 0.0
    react_cap: int = 0
    cells: tuple = ()                 # () dense build, else (nc1, nc2, nc3, ccap)
    celltab: Optional[CellTable] = None       # on-demand full rows
    react_tab: Optional[CellTable] = None     # on-demand react rows
    react_cells: tuple = ()


def suggest_capacity(n_atoms, volume, cutoff, safety=1.2):
    """Density-based row capacity (cf. general_routines.f90:1231-1239)."""
    per_atom = 4.0 / 3.0 * math.pi * cutoff ** 3 * n_atoms / volume
    cap = int(math.ceil(per_atom * safety)) + 8
    return max(16, min(cap, n_atoms - 1))


def suggest_cells(n_atoms, box, cutoff, safety=1.45, min_atoms=1024):
    """Cell grid (nc1, nc2, nc3, ccap) of the O(N) build, or () when the
    dense sweep is used: fewer than `min_atoms` atoms, or fewer than 3
    cells an axis (a 27-stencil would then visit a cell twice).  The
    JAX package's rule (construct_verlet_list_grid's fixed grid,
    general_routines.f90:1408-1595), so both packages pick one path."""
    if n_atoms < min_atoms:
        return ()
    b = np.asarray(box, dtype=np.float64)
    recip = np.linalg.inv(b).T
    widths = 1.0 / np.linalg.norm(recip, axis=1)
    nc = [int(w // cutoff) for w in widths]
    if min(nc) < 3:
        return ()
    per_cell = n_atoms / (nc[0] * nc[1] * nc[2])
    cap = max(4, int(math.ceil(per_cell * safety)),
              int(math.ceil(per_cell + 4.0 * math.sqrt(per_cell))) + 4)
    return (nc[0], nc[1], nc[2], cap)


def first_true_columns(mask, cap, idx_val=None):
    """Compact each row's masked values into (..., cap), ascending, -1
    padded; idx_val defaults to the column index."""
    n = mask.shape[-1]
    k = min(cap, n)
    if idx_val is None:
        v = torch.arange(n, device=mask.device).expand(mask.shape)
        bound = n
    else:
        v = idx_val.to(torch.int64)
        bound = 2 ** 30
    key = torch.where(mask, bound - v, torch.zeros_like(v))
    kvals = torch.topk(key, k, dim=-1).values
    out = torch.where(kvals > 0, bound - kvals, torch.full_like(kvals, -1))
    if k < cap:
        out = torch.nn.functional.pad(out, (0, cap - k), value=-1)
    return out


def build_neighbor_list(x, box, cutoff, capacity, react_cutoff=0.0,
                        react_cap=0, build_half=True, chunk=1024):
    """Dense build: half list, full adjacency and (react_cap > 0) the
    short-cutoff adjacency for the proton-hop search, in one sweep."""
    x = x.detach()
    N = x.shape[0]
    capacity = min(capacity, N - 1)
    full_cap = min(capacity + 8, N - 1)
    react_cap = min(react_cap, N - 1)
    cutoff2 = cutoff * cutoff
    j_idx = torch.arange(N, device=x.device)[None, :]
    halves, fulls, reacts = [], [], []
    over = torch.zeros((), dtype=torch.bool, device=x.device)
    for i0 in range(0, N, chunk):
        xi = x[i0:i0 + chunk]
        dr = pbc.min_image(xi[:, None, :] - x[None, :, :], box)
        d2 = torch.sum(dr * dr, dim=-1)
        i_idx = i0 + torch.arange(xi.shape[0], device=x.device)[:, None]
        fmask = (d2 < cutoff2) & (j_idx != i_idx)
        fulls.append(first_true_columns(fmask, full_cap))
        over = over | (fmask.sum(1) > full_cap).any()
        if build_half:
            hmask = fmask & (j_idx > i_idx)
            halves.append(first_true_columns(hmask, capacity))
            over = over | (hmask.sum(1) > capacity).any()
        if react_cap > 0:
            rmask = fmask & (d2 < react_cutoff * react_cutoff)
            reacts.append(first_true_columns(rmask, react_cap))
            over = over | (rmask.sum(1) > react_cap).any()
    idx = (torch.cat(halves) if build_half
           else torch.zeros((N, 0), dtype=torch.int64, device=x.device))
    return NeighborList(idx=idx, full_idx=torch.cat(fulls), ref_x=x,
                        overflow=over, capacity=capacity,
                        react_idx=torch.cat(reacts) if react_cap else None,
                        react_cutoff=react_cutoff, react_cap=react_cap)


def _frac_cells(x, box, cells, cutoff):
    """Fractional coordinates in [0, 1), cell index per atom (N, 3), and
    the box flag: a cell's plane spacing is below the cutoff."""
    ncv = cell_counts(*cells[:3], x.device)
    recip = pbc.recip_vectors(box)
    widths = 1.0 / torch.sqrt(torch.sum(recip * recip, dim=1))
    box_bad = (widths / ncv.to(x.dtype) < cutoff).any()
    frac = pbc.xyz_to_frac(x, box)
    frac = frac - torch.floor(frac)
    ci = torch.minimum((frac * ncv).to(torch.int64), ncv - 1).clamp(min=0)
    return frac, ci, box_bad


def _cell_id(ci, cells):
    _, nc2, nc3, _ = cells
    return (ci[..., 0] * nc2 + ci[..., 1]) * nc3 + ci[..., 2]


def _pack_cell_table(frac, ci, cells):
    """(pos (n_cells, ccap, 3), ids (n_cells, ccap), cell overflow)."""
    nc1, nc2, nc3, ccap = cells
    n_cells = nc1 * nc2 * nc3
    N = frac.shape[0]
    slot, cell_over = bin_slots(_cell_id(ci, cells), n_cells, ccap)
    # out of place: a replica batch vmaps this function
    pos = torch.zeros((n_cells * ccap + 1, 3), dtype=frac.dtype,
                      device=frac.device).index_put((slot,), frac)
    ids = torch.full((n_cells * ccap + 1,), N, dtype=torch.int64,
                     device=frac.device).index_put(
        (slot,), torch.arange(N, device=frac.device))
    return (pos[:-1].reshape(n_cells, ccap, 3),
            ids[:-1].reshape(n_cells, ccap), cell_over)


def build_cell_table(x, box, cells, row_cap, cutoff):
    """(CellTable, overflow): atoms binned into `cells` for on-demand rows
    of coverage `cutoff`."""
    frac, ci, box_bad = _frac_cells(x.detach(), box, cells, cutoff)
    pos, ids, cell_over = _pack_cell_table(frac, ci, cells)
    ct = CellTable(pos=pos, ids=ids, cutoff=float(cutoff), cells=cells,
                   row_cap=row_cap, n_atoms=x.shape[0])
    return ct, cell_over | box_bad


def _candidates(ct: CellTable, frac, ci, box):
    """Stencil candidates of query atoms (fractional coords frac, cells
    ci): (atom ids (n, 27 ccap), squared distance at the table's
    positions (n, 27 ccap)).  The minimum image is taken per fractional
    component, so any box shape works."""
    ccap = ct.cells[3]
    ncv = cell_counts(*ct.cells[:3], frac.device)
    nb_id = _cell_id(torch.remainder(ci[:, None, :]
                                     + stencil_offsets(frac.device)[None],
                                     ncv), ct.cells)              # (n, 27)
    n = frac.shape[0]
    cand = ct.ids[nb_id].reshape(n, 27 * ccap)
    df = frac[:, None, :] - ct.pos[nb_id].reshape(n, 27 * ccap, 3)
    df = df - torch.floor(df + 0.5)
    d = (df[..., 0:1] * box[0] + df[..., 1:2] * box[1]
         + df[..., 2:3] * box[2])
    return cand, (d * d).sum(-1)


def rows_on_demand(ct: CellTable, x, box, atoms):
    """Compacted adjacency rows of `atoms` from a persisted cell table:
    ((n, row_cap) ascending global j, -1 padded; (n,) per-row overflow,
    which callers mask on padded query rows).  Every pair within the
    use-time cutoff of a query atom is present; the consumer's own
    distance mask makes energies exact."""
    x = x.detach()
    ncv = cell_counts(*ct.cells[:3], x.device)
    frac = pbc.xyz_to_frac(x[atoms], box)
    frac = frac - torch.floor(frac)
    ci = torch.minimum((frac * ncv).to(torch.int64), ncv - 1).clamp(min=0)
    cand, d2 = _candidates(ct, frac, ci, box)
    mask = ((cand < ct.n_atoms) & (cand != atoms[:, None])
            & (d2 < ct.cutoff * ct.cutoff))
    rows = first_true_columns(mask, ct.row_cap, cand)
    return rows, mask.sum(-1) > ct.row_cap


def build_neighbor_list_cell(x, box, cutoff, capacity, cells,
                             react_cutoff=0.0, react_cap=0,
                             build_half=True, on_demand=False,
                             react_cells=()):
    """O(N) cell-list build (static grid, fixed cell capacity).

    With on_demand the full / react adjacencies are not materialized:
    the cell table is kept as ``celltab`` (and a finer react-cutoff table
    as ``react_tab`` when `react_cells` is a grid, else the coarse table
    at react coverage).  Overflow: a cell over capacity, a row over
    capacity, or a box shrunk below one cutoff per cell."""
    x = x.detach()
    N = x.shape[0]
    capacity = min(capacity, N - 1)
    full_cap = min(capacity + 8, N - 1)
    react_cap = min(react_cap, N - 1)
    frac, ci, box_bad = _frac_cells(x, box, cells, cutoff)
    pos, ids, cell_over = _pack_cell_table(frac, ci, cells)
    over = cell_over | box_bad
    table = CellTable(pos=pos, ids=ids, cutoff=float(cutoff), cells=cells,
                      row_cap=full_cap, n_atoms=N)
    celltab = react_tab = None
    if on_demand:
        celltab = table
        if react_cap > 0:
            if react_cells:
                react_tab, r_over = build_cell_table(x, box, react_cells,
                                                     react_cap, react_cutoff)
                over = over | r_over
            else:
                react_tab = table.replace(row_cap=react_cap,
                                          cutoff=float(react_cutoff))
        if not build_half:
            empty = torch.zeros((N, 0), dtype=torch.int64, device=x.device)
            return NeighborList(idx=empty, full_idx=empty, ref_x=x,
                                overflow=over, capacity=capacity,
                                react_cutoff=react_cutoff,
                                react_cap=react_cap, cells=cells,
                                celltab=celltab, react_tab=react_tab,
                                react_cells=react_cells)
    halves, fulls, reacts = [], [], []
    for i0 in range(0, N, _CELL_CHUNK):
        ar = torch.arange(i0, min(i0 + _CELL_CHUNK, N), device=x.device)
        cand, d2 = _candidates(table, frac[ar], ci[ar], box)
        fmask = (cand < N) & (cand != ar[:, None]) & (d2 < cutoff * cutoff)
        if build_half:
            hmask = fmask & (cand > ar[:, None])
            halves.append(first_true_columns(hmask, capacity, cand))
            over = over | (hmask.sum(1) > capacity).any()
        if not on_demand:
            fulls.append(first_true_columns(fmask, full_cap, cand))
            over = over | (fmask.sum(1) > full_cap).any()
            if react_cap > 0:
                rmask = fmask & (d2 < react_cutoff * react_cutoff)
                reacts.append(first_true_columns(rmask, react_cap, cand))
                over = over | (rmask.sum(1) > react_cap).any()
    empty = torch.zeros((N, 0), dtype=torch.int64, device=x.device)
    return NeighborList(
        idx=torch.cat(halves) if build_half else empty,
        full_idx=empty if on_demand else torch.cat(fulls), ref_x=x,
        overflow=over, capacity=capacity,
        react_idx=torch.cat(reacts) if reacts else None,
        react_cutoff=react_cutoff, react_cap=react_cap, cells=cells,
        celltab=celltab, react_tab=react_tab, react_cells=react_cells)


def build_neighbors(x, box, cutoff, capacity, cells=(), react_cutoff=0.0,
                    react_cap=0, build_half=True, on_demand=False,
                    react_cells=()):
    """The dense or the cell-list build, by the static config."""
    if cells:
        return build_neighbor_list_cell(x, box, cutoff, capacity, cells,
                                        react_cutoff=react_cutoff,
                                        react_cap=react_cap,
                                        build_half=build_half,
                                        on_demand=on_demand,
                                        react_cells=react_cells)
    return build_neighbor_list(x, box, cutoff, capacity,
                               react_cutoff=react_cutoff,
                               react_cap=react_cap, build_half=build_half)


def rebuild_like(nlist: NeighborList, x, box, cutoff):
    """Rebuild with the same static configuration."""
    return build_neighbors(x, box, cutoff, nlist.capacity, nlist.cells,
                           react_cutoff=nlist.react_cutoff,
                           react_cap=nlist.react_cap,
                           build_half=nlist.idx.shape[1] > 0,
                           on_demand=nlist.celltab is not None,
                           react_cells=nlist.react_cells)


def where_nlist(cond, a: NeighborList, b: NeighborList) -> NeighborList:
    """Field by field torch.where(cond, a, b) of two lists of one static
    configuration, cond a () bool tensor: the device-side counterpart of
    the JAX package's lax.cond between a rebuilt list and the old one."""
    def pick(u, w):
        if isinstance(u, torch.Tensor):
            return torch.where(cond, u, w)
        if isinstance(u, CellTable):
            return u.replace(pos=pick(u.pos, w.pos), ids=pick(u.ids, w.ids))
        return u
    return dataclasses.replace(a, **{f.name: pick(getattr(a, f.name),
                                                  getattr(b, f.name))
                                     for f in dataclasses.fields(a)})


def needs_rebuild(nlist: NeighborList, x, box, skin):
    """() bool tensor: the two largest displacements since the build sum
    past the skin (general_routines.f90:1320-1326)."""
    dr = pbc.min_image(x.detach() - nlist.ref_x, box)
    d2 = torch.sum(dr * dr, dim=-1)
    top = torch.topk(d2, min(2, d2.shape[0])).values
    return torch.sqrt(top).sum() > skin


def neighbor_pairs(nlist: NeighborList):
    """(i (N, 1), j (N, K), mask (N, K)) broadcastable pair indices."""
    N = nlist.idx.shape[0]
    i = torch.arange(N, device=nlist.idx.device)[:, None]
    mask = nlist.idx >= 0
    return i, nlist.idx.clamp(min=0), mask
