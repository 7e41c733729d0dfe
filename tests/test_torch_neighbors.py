"""The port's cell-list neighbor build and on-demand rows against the JAX
package, on tests/test_neighbors.py's cases (:26-43, :210-279): the same
rows, in the same ascending order, and the same overflow flags."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reactive_pb_nn_md_tpu.ops import neighbors as jax_nb
from reactive_pb_nn_md_tpu_torch.ops import neighbors


def _random_box(n, L, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, L, size=(n, 3)), np.diag([L, L, L])


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,L,cutoff", [(200, 20.0, 4.5), (400, 24.0, 6.0)])
def test_cell_build_matches_jax(n, L, cutoff):
    x, box = _random_box(n, L, seed=3)
    cap = neighbors.suggest_capacity(n, L ** 3, cutoff, safety=2.0)
    cells = neighbors.suggest_cells(n, box, cutoff, min_atoms=1)
    assert cells == jax_nb.suggest_cells(n, box, cutoff, min_atoms=1)
    kw = dict(react_cutoff=3.5, react_cap=24)
    ref = jax_nb.build_neighbor_list_cell(jnp.asarray(x), jnp.asarray(box),
                                          cutoff, cap, cells, **kw)
    got = neighbors.build_neighbor_list_cell(torch.tensor(x),
                                             torch.tensor(box), cutoff, cap,
                                             cells, **kw)
    assert not bool(got.overflow) and not bool(ref.overflow)
    _eq(got.idx, ref.idx)
    _eq(got.full_idx, ref.full_idx)
    _eq(got.react_idx, ref.react_idx)
    # and the dense build holds the same rows
    dense = neighbors.build_neighbor_list(torch.tensor(x), torch.tensor(box),
                                          cutoff, cap, **kw)
    assert torch.equal(dense.full_idx, got.full_idx)
    assert torch.equal(dense.react_idx, got.react_idx)


def test_rows_on_demand_match_jax():
    x, box = _random_box(400, 18.0, seed=11)
    cutoff, rcut = 6.0, 3.0
    cap = neighbors.suggest_capacity(400, 18.0 ** 3, cutoff)
    cells = neighbors.suggest_cells(400, box, cutoff, min_atoms=1)
    rcells = neighbors.suggest_cells(400, box, rcut, min_atoms=0)
    kw = dict(react_cutoff=rcut, react_cap=24, build_half=False,
              on_demand=True, react_cells=rcells)
    jx, jb = jnp.asarray(x), jnp.asarray(box)
    tx, tb = torch.tensor(x), torch.tensor(box)
    ref = jax_nb.build_neighbor_list_cell(jx, jb, cutoff, cap, cells, **kw)
    got = neighbors.build_neighbor_list_cell(tx, tb, cutoff, cap, cells,
                                             **kw)
    assert not bool(got.overflow) and not bool(ref.overflow)
    assert got.full_idx.shape == (400, 0) and got.react_idx is None
    assert got.celltab.row_cap == ref.celltab.row_cap
    assert got.react_tab.row_cap == ref.react_tab.row_cap == 24
    atoms = np.random.default_rng(2).choice(400, 53, replace=False)
    for ct, jct in ((got.celltab, ref.celltab),
                    (got.react_tab, ref.react_tab)):
        rows, over = neighbors.rows_on_demand(ct, tx, tb,
                                              torch.tensor(atoms))
        r_rows, r_over = jax_nb.rows_on_demand(
            jct, jx, jb, jnp.asarray(atoms.astype(np.int32)))
        _eq(rows, r_rows)
        _eq(over, r_over)
        assert not bool(over.any())
    # a too-small row capacity flags the same rows
    rows, over = neighbors.rows_on_demand(got.celltab.replace(row_cap=2),
                                          tx, tb, torch.tensor(atoms))
    _, r_over = jax_nb.rows_on_demand(ref.celltab.replace(row_cap=2), jx, jb,
                                      jnp.asarray(atoms.astype(np.int32)))
    assert bool(over.any())
    _eq(over, r_over)
    # on-demand rows at the build instant are the materialized rows
    mat = neighbors.build_neighbor_list_cell(tx, tb, cutoff, cap, cells,
                                             react_cutoff=rcut, react_cap=24)
    rows, _ = neighbors.rows_on_demand(got.celltab, tx, tb,
                                       torch.tensor(atoms))
    assert torch.equal(rows, mat.full_idx[atoms])


def test_cell_overflow_flags_and_rebuild():
    x, box = _random_box(300, 18.0, seed=1)
    tx, tb = torch.tensor(x), torch.tensor(box)
    cells = neighbors.suggest_cells(300, box, 4.0, min_atoms=1)
    tiny = cells[:3] + (2,)                 # 2 atoms a cell: must overflow
    assert bool(neighbors.build_neighbor_list_cell(tx, tb, 4.0, 64,
                                                   tiny).overflow)
    assert bool(jax_nb.build_neighbor_list_cell(
        jnp.asarray(x), jnp.asarray(box), 4.0, 64, tiny).overflow)
    # a box shrunk below one cutoff per cell
    assert bool(neighbors.build_neighbor_list_cell(tx * 0.6, tb * 0.6, 4.0,
                                                   64, cells).overflow)
    nl = neighbors.build_neighbors(tx, tb, 4.0, 64, cells, react_cutoff=3.0,
                                   react_cap=24, build_half=False,
                                   on_demand=True)
    nl2 = neighbors.rebuild_like(nl, tx + 0.01, tb, 4.0)
    assert nl2.cells == cells and nl2.celltab is not None
    assert nl2.idx.shape == (300, 0)
    assert not bool(neighbors.needs_rebuild(nl, tx + 0.01, tb, 1.0))
