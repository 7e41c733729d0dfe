"""The port's forces and diabat diagonals held to their own ground truths,
fp64 on the CPU: autograd forces against central finite differences of
the energy (tests/test_forces.py), and the field-decomposed diagonals
against every diabat recomputed in full (tests/test_delta_diag.py)."""

import numpy as np
import pytest
import torch

from torch_bridge import fixture_deck
from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
from reactive_pb_nn_md_tpu_torch.evb.enumerate import enumerate_diabats
from reactive_pb_nn_md_tpu_torch.evb.topology_ops import (
    build_diabat_topologies)
from reactive_pb_nn_md_tpu_torch.models import pme, total
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.topology import build_system
from reactive_pb_nn_md_tpu_torch.utils import pbc


@pytest.fixture(scope="module")
def water(tmp_path_factory):
    """63 H2O + H3O+ (tests/test_forces.py's box) with its half list,
    full adjacency and reciprocal weights."""
    frame, ffr, topr, cfg = fixture_deck(tmp_path_factory.mktemp("w"), 63,
                                         seed=7,
                                         extra="evb_max_states 24\n")
    system, topo = build_system(frame, ffr, topr, cfg, device="cpu")
    x = torch.as_tensor(frame.xyz)
    box = torch.as_tensor(frame.box)
    cap = neighbors.suggest_capacity(system.n_atoms,
                                     float(pbc.box_volume(box)),
                                     system.verlet_cutoff)
    nlist = neighbors.build_neighbor_list(x, box, system.verlet_cutoff, cap)
    assert not bool(nlist.overflow)
    cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt)
    return system, topo, x, box, nlist, cbw


def test_finite_difference_forces(water):
    system, topo, x, box, nlist, cbw = water
    pairs = neighbors.neighbor_pairs(nlist)

    def energy(xx):
        return total.total_energy(xx, box, topo, system, pairs, cbw).total

    xg = x.clone().requires_grad_(True)
    force = -torch.autograd.grad(energy(xg), xg)[0]
    assert torch.isfinite(force).all()
    rng = np.random.default_rng(0)
    h = 1e-5
    for _ in range(6):
        a, d = int(rng.integers(0, system.n_atoms)), int(rng.integers(0, 3))
        dx = torch.zeros_like(x)
        dx[a, d] = h
        fd = -(float(energy(x + dx)) - float(energy(x - dx))) / (2 * h)
        np.testing.assert_allclose(float(force[a, d]), fd, rtol=2e-5,
                                   atol=1e-6)


def test_delta_diagonals_equal_full(water):
    """The field-decomposed diagonals (the MD path) against the full
    per-diabat recompute, energies to 1e-10 and their gradients."""
    system, topo, x, box, nlist, cbw = water
    pairs = neighbors.neighbor_pairs(nlist)
    dset = enumerate_diabats(x, box, topo, system)
    batch = build_diabat_topologies(topo, dset, system)
    n = int(dset.n_states)
    assert n > 3 and not bool(dset.overflow)
    live = torch.arange(system.evb_max_states) < n

    def both(xx):
        delta, _, recip_delta, _ = ham.diabat_diagonal_energies(
            xx, box, batch, system, pairs, cbw, topo.charge, topo,
            nlist.full_idx)
        full, _, recip_full = ham.diabat_diagonal_energies_full(
            xx, box, batch, system, pairs, cbw, topo.charge)
        return delta, recip_delta, full, recip_full

    xg = x.clone().requires_grad_(True)
    delta, recip_delta, full, recip_full = both(xg)
    np.testing.assert_allclose(recip_delta.detach().numpy(),
                               recip_full.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(delta.detach().numpy()[:n],
                               full.detach().numpy()[:n], rtol=1e-10)
    g_delta, = torch.autograd.grad(torch.where(live, delta, 0.0).sum(), xg,
                                   retain_graph=True)
    g_full, = torch.autograd.grad(torch.where(live, full, 0.0).sum(), xg)
    np.testing.assert_allclose(g_delta.numpy(), g_full.numpy(), rtol=1e-7,
                               atol=1e-8)
