"""Stable binning of atoms into fixed-capacity bins (one sort).

Shared by kernel A's cell packing, the cell-list neighbor build and the
PME slab spread: the same sort / rank-in-run trick as the JAX package's
``_bin_atoms``, ``_pack_cell_table`` and ``_bin_by_slab``.
"""

import functools

import torch


def bin_slots(key, n_bins, cap):
    """(slot (N,), overflow ()): each atom's row in a bin-major layout of
    n_bins bins of `cap` rows, in atom order within a bin.  Atoms past
    their bin's capacity go to the dump row n_bins * cap, and overflow is
    set; nothing else is dropped."""
    N = key.shape[0]
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    ar = torch.arange(N, device=key.device)
    # (out of place: a replica batch vmaps this function)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=key.device),
                       sorted_key[1:] != sorted_key[:-1]])
    run_start = torch.cummax(torch.where(first, ar, torch.zeros_like(ar)),
                             0).values
    rank = ar - run_start
    slot_sorted = torch.where(rank < cap, sorted_key * cap + rank,
                              torch.full_like(rank, n_bins * cap))
    slot = torch.empty_like(slot_sorted).index_put((order,), slot_sorted)
    return slot, (rank >= cap).any()


def slot_atoms(slot, n_rows):
    """(n_rows,) atom of every bin row, -1 where the row is empty (the
    inverse of bin_slots' slot, dump row dropped)."""
    rows = torch.full((n_rows + 1,), -1, dtype=torch.int64,
                      device=slot.device)
    return rows.index_put((slot,), torch.arange(slot.shape[0],
                                                device=slot.device))[:n_rows]


@functools.lru_cache(maxsize=None)
def cell_counts(n1, n2, n3, device):
    """(3,) int64 tensor (n1, n2, n3) on `device`, made once per grid: a
    host-to-device copy inside the MD step would be a synchronization,
    which a CUDA graph capture refuses.  Callers must not modify it."""
    return torch.tensor([n1, n2, n3], device=device)


def stencil_offsets(device):
    """(27, 3) cell offsets in {-1, 0, 1}^3, lexicographic."""
    o = torch.arange(-1, 2, device=device)
    return torch.stack(torch.meshgrid(o, o, o, indexing="ij"),
                       dim=-1).reshape(27, 3)
