"""The port's EVB layer against the JAX package on the equilibrated
flagship state (649 atoms, benchdata/eq_flagship_s80.npz: 32 diabats,
chains of up to 3 hops), fp64 on the CPU: the enumeration and the diabat
topologies exactly, the Hamiltonian and the adiabatic forces to 1e-9."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import example_deck
from reactive_pb_nn_md_tpu.topology import build_system as jax_build
from reactive_pb_nn_md_tpu.topology import Topology as JTopology
from reactive_pb_nn_md_tpu.models import pme as jax_pme
from reactive_pb_nn_md_tpu.ops import neighbors as jax_nb
from reactive_pb_nn_md_tpu.evb import hamiltonian as jax_ham
from reactive_pb_nn_md_tpu_torch.topology import build_system
from reactive_pb_nn_md_tpu_torch.convert import load_equilibrated_npz
from reactive_pb_nn_md_tpu_torch.models import pme
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham

ROOT = pathlib.Path(__file__).resolve().parents[1]
EQ = ROOT / "benchdata" / "eq_flagship_s80.npz"


@pytest.fixture(scope="module")
def flagship_evb():
    frame, ffr, topr, cfg = example_deck(ROOT)
    jsys, _ = jax_build(frame, ffr, topr, cfg)
    tsys, _ = build_system(frame, ffr, topr, cfg, device="cpu")
    state, ttopo, meta = load_equilibrated_npz(EQ, "cpu")
    data = np.load(EQ)
    jtopo = JTopology(*[jnp.asarray(data[f"l{i}"]).astype(
        jnp.float64 if i == 11 else jnp.int32) for i in range(5, 13)])
    x, box = state.x.numpy(), state.box.numpy()
    rcut = (tsys.evb_reactive_pair_distance + tsys.verlet_cutoff
            - tsys.real_space_cutoff)
    K, order = tsys.pme_grid, tsys.spline_order

    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jbox = jnp.asarray(box)
        nl = jax_nb.build_neighbors(jnp.asarray(x), jbox, jsys.verlet_cutoff,
                                    meta["capacity"], react_cutoff=rcut,
                                    react_cap=meta["react_cap"])
        assert not bool(nl.overflow)
        cbw = jax_pme.cb_half(jbox, K, order, jsys.alpha_sqrt,
                              dtype=jnp.float64)
        jres, jbatch = jax.jit(lambda xx: jax_ham.adiabatic_energy_force(
            xx, jbox, jtopo, jsys, jax_nb.neighbor_pairs(nl), cbw,
            full_idx=nl.full_idx, react_idx=nl.react_idx))(jnp.asarray(x))
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)

    # the JAX package runs the half-list pair path on the CPU; the port's
    # cell path is held to it by tests/test_torch_realspace_pair.py
    tsys = tsys.replace(rs_cells=())
    tnl = neighbors.build_neighbor_list(
        state.x, state.box, tsys.verlet_cutoff, meta["capacity"],
        react_cutoff=rcut, react_cap=meta["react_cap"])
    tres, tbatch = ham.adiabatic_energy_force(
        state.x, state.box, ttopo, tsys, neighbors.neighbor_pairs(tnl),
        pme.cb_half(state.box, K, order, tsys.alpha_sqrt), tnl.full_idx,
        react_idx=tnl.react_idx)
    return jres, jbatch, tres, tbatch


def test_enumeration_and_topologies_match_jax(flagship_evb):
    jres, jbatch, tres, tbatch = flagship_evb
    n = int(jres.n_states)
    assert n == int(tres.n_states) and n > 20
    assert int(np.asarray(jbatch.dset.n_hops).max()) == 3
    for name in ("hop_log", "n_hops", "parent", "hydronium_of"):
        np.testing.assert_array_equal(getattr(tbatch.dset, name).numpy(),
                                      np.asarray(getattr(jbatch.dset, name)))
    for name in ("mol_mtype", "mol_natom", "mol_atoms", "atom_mol",
                 "atom_slot", "atom_type", "charge", "hydronium_mol"):
        np.testing.assert_array_equal(getattr(tbatch.topo, name).numpy(),
                                      np.asarray(getattr(jbatch.topo, name)))
    np.testing.assert_array_equal(tbatch.changed_atoms.numpy(),
                                  np.asarray(jbatch.changed_atoms))


def test_hamiltonian_and_forces_match_jax(flagship_evb):
    jres, _, tres, _ = flagship_evb
    n = int(jres.n_states)
    H_j = np.asarray(jres.hamiltonian)
    np.testing.assert_allclose(tres.hamiltonian.numpy(), H_j, rtol=1e-9,
                               atol=1e-9 * np.abs(H_j[:n, :n]).max())
    np.testing.assert_allclose(float(tres.energy), float(jres.energy),
                               rtol=1e-12)
    F_j = np.asarray(jres.force)
    assert np.abs(tres.force.numpy() - F_j).max() <= 1e-9 * np.abs(F_j).max()
    c_j, c_p = np.asarray(jres.eigenvector), tres.eigenvector.numpy()
    assert min(np.abs(c_p - c_j).max(), np.abs(c_p + c_j).max()) < 1e-9


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vex_sum_masks_a_coincident_pair_off_by_rounding(dtype):
    """A Zundel atom meets its own molecule-pack entry through two routes
    that agree only to a few fp32 ulps (~1e-6 A at 20 A): the pair is one
    atom and stays masked, value and gradient, as an exact coincidence is.
    (Kept with the JAX package's 1e-12 A^2, such a pair put thousands of
    kJ/mol/A on one atom in fp32 on the card, and NVE runs jumped.)"""
    from reactive_pb_nn_md_tpu_torch.models import coupling
    zx = torch.tensor([[[20.0, 10.0, 5.0]]], dtype=dtype,
                      requires_grad=True)                      # (S, Z, 3)
    zq = torch.tensor([[0.5]], dtype=dtype)
    far = torch.tensor([21.0, 11.5, 5.5], dtype=dtype)
    for off in (0.0, 2e-6, 4e-6):
        near = zx.detach()[0, 0] + torch.tensor([0.0, off, 0.0], dtype=dtype)
        xg = torch.stack([near, far])[None, None]              # (S, 1, 2, 3)
        qg = torch.tensor([[[-0.8, 0.4]]], dtype=dtype)
        mask = torch.ones((1, 1, 2), dtype=torch.bool)
        v = coupling._vex_sum(zx, zq, xg, qg, mask)
        g, = torch.autograd.grad(v.sum(), zx)
        r = torch.linalg.norm(zx.detach()[0, 0] - far)
        np.testing.assert_allclose(float(v.detach()), 0.5 * 0.4 / float(r),
                                   rtol=1e-6)
        ref = -0.5 * 0.4 * (zx.detach()[0, 0] - far) / r ** 3
        np.testing.assert_allclose(g[0, 0].numpy(), ref.numpy(), rtol=1e-5)
