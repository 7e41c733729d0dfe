"""Fixed-capacity Verlet neighbor list, dense build (counterpart of the
dense path of reactive_pb_nn_md_tpu/ops/neighbors.py).

The list is a padded (N, K) tensor of half neighbors (j > i) plus the full
adjacency rows the MS-EVB layer reads.  Intra-molecular pairs are kept and
masked at use time with each diabat's molecule assignment, so one list
serves every diabat.  Capacity overflow is a flag; the integrator raises on
it (no regrow yet).  The cell-list build is not ported: below 1024 atoms
the reference uses this dense sweep too.
"""

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..utils import pbc


@dataclass
class NeighborList:
    idx: torch.Tensor                 # (N, K) half list, -1 pad; (N, 0) if skipped
    full_idx: torch.Tensor            # (N, Kf) all neighbors, ascending j
    ref_x: torch.Tensor               # (N, 3) positions at build time
    overflow: torch.Tensor            # () bool
    capacity: int
    react_idx: Optional[torch.Tensor] = None   # (N, Kr) short-cutoff rows
    react_cutoff: float = 0.0
    react_cap: int = 0


def suggest_capacity(n_atoms, volume, cutoff, safety=1.2):
    """Density-based row capacity (cf. general_routines.f90:1231-1239)."""
    per_atom = 4.0 / 3.0 * math.pi * cutoff ** 3 * n_atoms / volume
    cap = int(math.ceil(per_atom * safety)) + 8
    return max(16, min(cap, n_atoms - 1))


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
    """Half list, full adjacency and (react_cap > 0) the short-cutoff
    adjacency for the proton-hop search, from one dense sweep."""
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


def rebuild_like(nlist: NeighborList, x, box, cutoff):
    """Rebuild with the same static configuration."""
    return build_neighbor_list(x, box, cutoff, nlist.capacity,
                               react_cutoff=nlist.react_cutoff,
                               react_cap=nlist.react_cap,
                               build_half=nlist.idx.shape[1] > 0)


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
