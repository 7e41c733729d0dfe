"""A deck with `eigensolver iterative` on the port, against the JAX
package's iterative path (ops/ground_state.py's shift-and-invert Krylov
ground state), fp64 on the CPU: the 8-water + H3O+ fixture of
tests/test_torch_slice.py (PME 12, state cap 16).

The port has one ground state whatever the deck asks (kernel E on the
card, eigh on the CPU: ops/ground_state.py), so it runs such a deck as it
runs an eigh one.  The JAX package's Krylov solve stops at a residual,
not at the exact eigenpair: its energy, stationary in the eigenvector,
is held within 1e-8 relative (tests/test_ground_state.py:41's bound of
Krylov against eigh).  The Hellmann-Feynman forces are linear in the
eigenvector's error, which the Krylov solve leaves at its residual: they
are held within 1e-9 of their largest value, the port's force bound
against the JAX eigh path on this deck (tests/test_torch_slice.py).  On
this H the solve converges to round-off: the eigenvectors differ by
4.2e-17, the energies by 9.2e-15 relative and the forces by 2.3e-13
kJ/mol/A of 603.6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import fixture_deck, jax_tree
from reactive_pb_nn_md_tpu.topology import build_system as jax_build
from reactive_pb_nn_md_tpu.models import pme as jax_pme
from reactive_pb_nn_md_tpu.ops import neighbors as jax_nb
from reactive_pb_nn_md_tpu.evb import hamiltonian as jax_ham
from reactive_pb_nn_md_tpu_torch.convert import from_numpy_tree
from reactive_pb_nn_md_tpu_torch.topology import build_system, State
from reactive_pb_nn_md_tpu_torch.models import pme
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.md import integrators
from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham

CAPACITY = 27            # N - 1: no row can overflow


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("iterative")
    frame, ffr, topr, cfg = fixture_deck(
        tmp, 8, seed=1, pme_grid=12,
        extra="evb_max_states 16\neigensolver iterative\n")
    assert cfg.eigensolver == "iterative"
    jsys, jtopo = jax_build(frame, ffr, topr, cfg)
    assert jsys.eigensolver == "iterative"
    tsys, ttopo = build_system(frame, ffr, topr, cfg, device="cpu")
    x0, box = frame.xyz, frame.box
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jbox = jnp.asarray(box)
        jcbw = jax_pme.cb_half(jbox, jsys.pme_grid, jsys.spline_order,
                               jsys.alpha_sqrt, dtype=jnp.float64)
        skin = jsys.verlet_cutoff - jsys.real_space_cutoff
        rcut = jsys.evb_reactive_pair_distance + skin
        nl = jax_nb.build_neighbors(jnp.asarray(x0), jbox,
                                    jsys.verlet_cutoff, CAPACITY,
                                    react_cutoff=rcut, react_cap=CAPACITY)
        jres, _ = jax.jit(lambda xx: jax_ham.adiabatic_energy_force(
            xx, jbox, jtopo, jsys, jax_nb.neighbor_pairs(nl), jcbw,
            full_idx=nl.full_idx, react_idx=nl.react_idx))(jnp.asarray(x0))
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)
    tbox = torch.tensor(box)
    tcbw = pme.cb_half(tbox, tsys.pme_grid, tsys.spline_order,
                       tsys.alpha_sqrt)
    tms = integrators.initial_md_state(
        State(x=torch.tensor(x0), v=torch.zeros(tsys.n_atoms, 3), box=tbox),
        ttopo, tsys, tcbw, CAPACITY)
    tres, _ = ham.adiabatic_energy_force(
        torch.tensor(x0), tbox, ttopo, tsys,
        neighbors.neighbor_pairs(tms.nlist), tcbw, tms.nlist.full_idx,
        react_idx=tms.nlist.react_idx)
    return dict(jres=jres, tres=tres, tsys=tsys, ttopo=ttopo, jsys=jsys,
                jtopo=jtopo)


def test_iterative_deck_builds_as_the_jax_one(runs):
    ref_sys, ref_topo = from_numpy_tree(jax_tree(runs["jsys"],
                                                 runs["jtopo"]), "cpu")
    for name in ("n_atoms", "evb_max_states", "pme_grid", "ms_evb"):
        assert getattr(runs["tsys"], name) == getattr(ref_sys, name)
    for name in ("mol_atoms", "atom_type", "charge"):
        assert torch.equal(getattr(runs["ttopo"], name),
                           getattr(ref_topo, name))


def test_iterative_deck_matches_the_jax_krylov_path(runs):
    j, p = runs["jres"], runs["tres"]
    n = int(j.n_states)
    assert n >= 2 and int(p.n_states) == n
    e_j = float(j.energy)
    assert abs(float(p.energy) - e_j) <= 1e-8 * abs(e_j)
    F_j = np.asarray(j.force)
    err = np.abs(p.force.numpy() - F_j).max()
    assert err <= 1e-9 * np.abs(F_j).max(), err
    assert int(p.principle) == int(j.principle)
