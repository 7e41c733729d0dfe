"""The port's scale path against the JAX package, fp64 on the CPU: the
cell-list neighbor build with on-demand adjacency rows and the
candidate-row EVB repulsion, as the 10,000-atom box runs them, forced on
the 124-water + H3O+ fixture of tests/test_neighbors.py:280-333 (cutoff
4.0 / Verlet 5.0 A: a 3x3x3 neighbor grid, and the repulsion's 3.05 A
switch radius inside the cutoff).  The adiabatic energy and forces, and
5 NVE steps from identical numpy velocities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_bridge import fixture_deck
from reactive_pb_nn_md_tpu.topology import build_system as jax_build
from reactive_pb_nn_md_tpu.topology import State as JState
from reactive_pb_nn_md_tpu.models import pme as jax_pme
from reactive_pb_nn_md_tpu.ops import neighbors as jax_nb
from reactive_pb_nn_md_tpu.md import integrators as jax_int
from reactive_pb_nn_md_tpu.md import velocities as jax_vel
from reactive_pb_nn_md_tpu.evb import hamiltonian as jax_ham
from reactive_pb_nn_md_tpu.utils.constants import KB
from reactive_pb_nn_md_tpu_torch.topology import build_system, State
from reactive_pb_nn_md_tpu_torch.models import pme, repulsion
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.md import integrators

N_STEPS = 5


@pytest.fixture(scope="module")
def cell_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice_cells")
    frame, ffr, topr, cfg = fixture_deck(
        tmp, 124, seed=3, cutoff=4.0, verlet_cutoff=5.0, pme_grid=16,
        extra="evb_max_states 32\n")
    jsys, jtopo = jax_build(frame, ffr, topr, cfg)
    tsys, ttopo = build_system(frame, ffr, topr, cfg, device="cpu")
    x0, box = frame.xyz, frame.box
    cells = neighbors.suggest_cells(tsys.n_atoms, box, tsys.verlet_cutoff,
                                    min_atoms=1)
    assert cells[:3] == (3, 3, 3)
    assert repulsion.domain_repulsion_active(tsys, True)
    mass = np.asarray(jsys.mass)
    v0 = np.random.default_rng(7).standard_normal((jsys.n_atoms, 3)) \
        * np.sqrt(KB * 300.0 * 100.0 / mass)[:, None]
    skin = jsys.verlet_cutoff - jsys.real_space_cutoff
    rcut = jsys.evb_reactive_pair_distance + skin
    rcells = neighbors.suggest_cells(tsys.n_atoms, box, rcut, min_atoms=0)
    vol = float(np.prod(np.diag(box)))
    cap = neighbors.suggest_capacity(tsys.n_atoms, vol, tsys.verlet_cutoff)
    rcap = neighbors.suggest_capacity(tsys.n_atoms, vol, rcut, safety=1.4)

    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        jbox = jnp.asarray(box)
        jcbw = jax_pme.cb_half(jbox, jsys.pme_grid, jsys.spline_order,
                               jsys.alpha_sqrt, dtype=jnp.float64)
        nl = jax_nb.build_neighbors(jnp.asarray(x0), jbox,
                                    jsys.verlet_cutoff, cap, cells,
                                    react_cutoff=rcut, react_cap=rcap,
                                    on_demand=True, react_cells=rcells)
        assert not bool(nl.overflow) and nl.celltab is not None
        res, _ = jax.jit(lambda xx: jax_ham.adiabatic_energy_force(
            xx, jbox, jtopo, jsys, jax_nb.neighbor_pairs(nl), jcbw,
            full_idx=nl.celltab, react_idx=nl.react_tab))(jnp.asarray(x0))
        jv = jnp.asarray(v0)
        ms = jax_int.MDState(
            state=JState(x=jnp.asarray(x0), v=jv, box=jbox,
                         key=jax.random.PRNGKey(0),
                         step=jnp.asarray(0, jnp.int32)),
            topo=res.principle_topo, nlist=nl, force=res.force,
            potential=res.energy, breakdown=res.breakdown,
            kinetic=jax_vel.kinetic_energy(jv, jsys.mass),
            n_states=res.n_states, eigenvector=res.eigenvector,
            hopped=jnp.asarray(False), force_overflow=jnp.asarray(False),
            nbr_overflow=nl.overflow, evb_overflow=res.overflow,
            hydronium_of=res.hydronium_of, n_hops_of=res.n_hops_of)
        step = jax.jit(lambda m: jax_int.md_step.__wrapped__(
            m, jsys, jcbw, cfg.delta_t, "NVE"))
        jax_traj = []
        for _ in range(N_STEPS):
            ms = step(ms)
            assert not bool(ms.nbr_overflow)
            jax_traj.append((np.asarray(ms.state.x), float(ms.potential)))
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)

    tbox = torch.tensor(box)
    tcbw = pme.cb_half(tbox, tsys.pme_grid, tsys.spline_order,
                       tsys.alpha_sqrt)
    tms = integrators.initial_md_state(
        State(x=torch.tensor(x0), v=torch.tensor(v0), box=tbox), ttopo,
        tsys, tcbw, cap, cells=cells, react_cap=rcap)
    assert not integrators.overflowed(tms)
    port_init = (float(tms.potential), tms.force.numpy(), int(tms.n_states))
    port_traj = []
    for _ in range(N_STEPS):
        tms = integrators.md_step(tms, tsys, tcbw, cfg.delta_t)
        assert not integrators.overflowed(tms)
        port_traj.append((tms.state.x.numpy(), float(tms.potential)))
    return dict(jax_res=res, port_init=port_init, port_ms=tms,
                jax_traj=jax_traj,
                port_traj=port_traj, jax_topo=ms.topo, rcells=rcells,
                cells=cells)


def test_cell_path_is_taken(cell_runs):
    nl = cell_runs["port_ms"].nlist
    assert nl.cells == cell_runs["cells"]
    assert nl.celltab is not None and nl.react_tab is not None
    assert nl.full_idx.shape[1] == 0 and nl.react_idx is None
    assert nl.react_cells == cell_runs["rcells"]


def test_cell_path_energy_and_forces_match_jax(cell_runs):
    j = cell_runs["jax_res"]
    e, force, n = cell_runs["port_init"]
    assert n == int(j.n_states) and n >= 2
    np.testing.assert_allclose(e, float(j.energy), rtol=1e-12)
    F_j = np.asarray(j.force)
    assert np.abs(force - F_j).max() <= 1e-9 * np.abs(F_j).max()


def test_cell_path_md_steps_match_jax(cell_runs):
    for (xj, ej), (xp, ep) in zip(cell_runs["jax_traj"],
                                  cell_runs["port_traj"]):
        assert np.abs(xp - xj).max() <= 1e-9
        np.testing.assert_allclose(ep, ej, rtol=1e-9)
    jt, pt = cell_runs["jax_topo"], cell_runs["port_ms"].topo
    for name in ("mol_atoms", "atom_type", "atom_mol", "hydronium_mol"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
