"""Velocity-Verlet NVE step (counterpart of the NVE path of
reactive_pb_nn_md_tpu/md/integrators.py; md_integrate_atomic,
md_integration.f90:438-541).

One step = kick, drift, wrap whole molecules, neighbor rebuild when the
displacements exceed the skin, force evaluation (the MS-EVB adiabatic
surface in reactive mode, which also switches the principle topology on
a hop), kick, COM-momentum removal.  The rebuild and the overflow checks
are Python branches, one host sync each; overflow raises (no regrow yet).
"""

from dataclasses import dataclass

import torch

from reactive_pb_nn_md_tpu.utils.constants import CONV_KJMOL_A2PS2GMOL
from ..models import total as total_mod
from ..ops import neighbors
from ..evb import hamiltonian as ham
from ..evb.enumerate import molecule_com
from ..topology import State, Topology
from ..utils import pbc
from . import velocities


class CapacityOverflow(RuntimeError):
    """A fixed capacity (neighbor rows, kernel A cells, EVB state cap) was
    exceeded; regrowing is not ported yet."""


@dataclass
class ForceEval:
    potential: torch.Tensor
    breakdown: total_mod.EnergyBreakdown
    force: torch.Tensor
    topo: Topology                 # post-hop principle topology
    n_states: torch.Tensor
    eigenvector: torch.Tensor
    evb_overflow: torch.Tensor
    hydronium_of: torch.Tensor
    n_hops_of: torch.Tensor


@dataclass
class MDState:
    state: State
    topo: Topology
    nlist: neighbors.NeighborList
    force: torch.Tensor
    potential: torch.Tensor
    breakdown: total_mod.EnergyBreakdown
    kinetic: torch.Tensor
    n_states: torch.Tensor
    eigenvector: torch.Tensor
    hydronium_of: torch.Tensor
    n_hops_of: torch.Tensor
    hopped: bool = False           # hydronium changed this step
    force_overflow: bool = False   # |F| > 1e4: the reference aborts


def wrap_molecules(x, box, topo, mass):
    """Translate whole molecules into the box by their COM; returns
    (wrapped x, wrapped COM), the COM is reused by the EVB layer."""
    com = molecule_com(x, topo.mol_atoms, mass, box)
    shift = torch.floor(pbc.xyz_to_frac(com, box)).detach() @ box
    return x - shift[topo.atom_mol], com - shift


def evaluate_forces(x, box, topo, system, nlist, cbw, com=None):
    """Reactive (MS-EVB) or plain force evaluation."""
    pairs = neighbors.neighbor_pairs(nlist)
    S = system.evb_max_states
    if system.ms_evb:
        res, _ = ham.adiabatic_energy_force(
            x, box, topo, system, pairs, cbw, nlist.full_idx,
            react_idx=nlist.react_idx, com=com)
        return ForceEval(potential=res.energy, breakdown=res.breakdown,
                         force=res.force, topo=res.principle_topo,
                         n_states=res.n_states, eigenvector=res.eigenvector,
                         evb_overflow=res.overflow,
                         hydronium_of=res.hydronium_of,
                         n_hops_of=res.n_hops_of)
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        bd = total_mod.total_energy(xg, box, topo, system, pairs, cbw)
        grad, = torch.autograd.grad(bd.total, xg)
    dev = x.device
    return ForceEval(potential=bd.total.detach(), breakdown=bd, force=-grad,
                     topo=topo, n_states=torch.ones((), dtype=torch.int64,
                                                    device=dev),
                     eigenvector=torch.zeros(S, dtype=x.dtype, device=dev),
                     evb_overflow=torch.zeros((), dtype=torch.bool,
                                              device=dev),
                     hydronium_of=torch.full((S,), -1, device=dev),
                     n_hops_of=torch.zeros(S, dtype=torch.int64, device=dev))


def _sync_flags(nlist, fe, hopped):
    """One host sync for the step's flags: raise on any overflow, return
    (hopped, |F| > 1e4) as Python bools."""
    flags = torch.stack([nlist.overflow, fe.breakdown.rs_overflow,
                         fe.evb_overflow, hopped,
                         (fe.force.abs() > 1.0e4).any()]).tolist()
    for name, bad in zip(("neighbor-list capacity", "kernel A cell capacity",
                          "EVB state cap (evb_max_states)"), flags[:3]):
        if bad:
            raise CapacityOverflow(f"{name} exceeded; regrowing is not "
                                   f"ported yet")
    return flags[3], flags[4]


def initial_md_state(state: State, topo, system, cbw, capacity,
                     react_cap=None) -> MDState:
    react_cutoff = 0.0
    if system.ms_evb:
        skin = system.verlet_cutoff - system.real_space_cutoff
        react_cutoff = float(system.evb_reactive_pair_distance + skin)
        if react_cap is None:
            vol = float(pbc.box_volume(state.box))
            react_cap = neighbors.suggest_capacity(
                system.n_atoms, vol, react_cutoff, safety=1.4)
    else:
        react_cap = 0
    # kernel A bins atoms itself: the half list is built only without it
    nlist = neighbors.build_neighbor_list(
        state.x, state.box, system.verlet_cutoff, capacity,
        react_cutoff=react_cutoff, react_cap=react_cap,
        build_half=not system.rs_cells)
    fe = evaluate_forces(state.x, state.box, topo, system, nlist, cbw)
    _sync_flags(nlist, fe, torch.zeros((), dtype=torch.bool,
                                       device=state.x.device))
    return MDState(state=state, topo=fe.topo, nlist=nlist, force=fe.force,
                   potential=fe.potential, breakdown=fe.breakdown,
                   kinetic=velocities.kinetic_energy(state.v, system.mass),
                   n_states=fe.n_states, eigenvector=fe.eigenvector,
                   hydronium_of=fe.hydronium_of, n_hops_of=fe.n_hops_of)


def md_step(ms: MDState, system, cbw, dt: float) -> MDState:
    """One velocity-Verlet NVE step."""
    state, topo = ms.state, ms.topo
    box = state.box
    mass = system.mass[:, None]
    mobile = velocities.freeze_mask(system, topo)[:, None]
    conv = CONV_KJMOL_A2PS2GMOL
    v = torch.where(mobile, state.v + dt / 2.0 * ms.force / mass * conv,
                    state.v)
    x = torch.where(mobile, state.x + v * dt, state.x)
    x, com = wrap_molecules(x, box, topo, system.mass)

    nlist = ms.nlist
    skin = system.verlet_cutoff - system.real_space_cutoff
    if bool(neighbors.needs_rebuild(nlist, x, box, skin)):
        nlist = neighbors.rebuild_like(nlist, x, box, system.verlet_cutoff)

    fe = evaluate_forces(x, box, topo, system, nlist, cbw, com=com)
    v = torch.where(mobile, v + dt / 2.0 * fe.force / mass * conv, v)
    v = velocities.remove_com_momentum(v, system.mass, mobile[:, 0])
    hopped, force_overflow = _sync_flags(
        nlist, fe, fe.topo.hydronium_mol != topo.hydronium_mol)
    return MDState(state=State(x=x, v=v, box=box, step=state.step + 1),
                   topo=fe.topo, nlist=nlist, force=fe.force,
                   potential=fe.potential, breakdown=fe.breakdown,
                   kinetic=velocities.kinetic_energy(v, system.mass),
                   n_states=fe.n_states, eigenvector=fe.eigenvector,
                   hydronium_of=fe.hydronium_of, n_hops_of=fe.n_hops_of,
                   hopped=hopped, force_overflow=force_overflow)
