"""MD step: velocity Verlet (NVE, and NPT between barostat moves) and
Langevin leapfrog (NVT) (counterpart of
reactive_pb_nn_md_tpu/md/integrators.py; md_integrate_atomic,
md_integration.f90:438-541, langevin_integrator :186-228).

One step = kick, drift, wrap whole molecules, neighbor rebuild when the
displacements exceed the skin, force evaluation (the MS-EVB adiabatic
surface in reactive mode, which also switches the principle topology on
a hop), kick, COM-momentum removal.  With System.compensated_sum the
NVE/NPT kicks and the drift accumulate with Kahan carries (MDState.comp).
The NVT step takes its two Gaussian draws as an argument, so a step
redone after a capacity regrow reuses them.  The rebuild check and the
step's flags are Python branches, one host sync each.  A capacity that
did not hold (neighbor rows, cells, on-demand rows, kernel A's cells, the
PME slab cap, the EVB state cap) is reported in MDState.overflow: the
step's result is then not valid, and the simulation loop
(md/simulation.py) regrows the capacities and redoes the step.
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..utils.constants import CONV_KJMOL_A2PS2GMOL, KB
from ..models import total as total_mod
from ..ops import neighbors
from ..evb import hamiltonian as ham
from ..evb.enumerate import molecule_com
from ..topology import State, Topology
from ..utils import pbc
from . import velocities


class CapacityOverflow(RuntimeError):
    """A capacity still overflowing after the regrow rounds of
    md/simulation.py."""


# the capacity flags of a step, in the order _sync_flags reads them
CAPACITIES = ("neighbor-list capacity", "on-demand row capacity",
              "kernel A cell capacity", "PME slab capacity",
              "EVB state cap")
NEIGHBOR_CAP, ROW_CAP, RS_CELL_CAP, SLAB_CAP, EVB_STATE_CAP = CAPACITIES
ENSEMBLES = ("NVE", "NVT", "NPT")


@dataclass
class CompCarry:
    """Kahan residuals of the integrator's x / v sums
    (System.compensated_sum)."""
    x: torch.Tensor                # (N, 3) position-sum residual
    v: torch.Tensor                # (N, 3) velocity-sum residual


def two_sum_add(acc, delta, carry):
    """acc += delta with the running residual `carry` (Kahan form);
    returns (sum, new carry).  Eager torch evaluates each op as written,
    with no algebraic simplifier to fold (t - acc) back to d, so the JAX
    package's optimization barrier has no counterpart here."""
    d = delta + carry
    t = acc + d
    return t, d - (t - acc)


def langevin_half_kick(v, f, mass_col, noise, dt, friction, temperature):
    """Langevin leapfrog half-update (langevin_integrator,
    md_integration.f90:186-228, OpenMM convention) with the standard
    normal draw `noise` (v's shape).  Two half-updates a step together
    have the stationary variance kT conv / m per component."""
    conv = CONV_KJMOL_A2PS2GMOL
    decay = math.exp(-friction * dt / 2.0)
    return (decay * v + (1.0 - decay) / friction * f / mass_col * conv
            + torch.sqrt(2.0 * KB * temperature * friction * conv / mass_col)
            * math.sqrt((1.0 - math.exp(-friction * dt)) / (2.0 * friction))
            * noise)


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
    row_overflow: torch.Tensor     # () bool: an on-demand row overflowed


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
    overflow: tuple = ()           # CAPACITIES that did not hold: not valid
    comp: Optional[CompCarry] = None   # Kahan carries (compensated_sum)


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
    dev = x.device
    if system.ms_evb:
        # on-demand cell path: the EVB layer reads rows from the cell
        # tables instead of materialized (N, K) adjacencies
        full_src = (nlist.celltab if nlist.celltab is not None
                    else nlist.full_idx)
        react_src = (nlist.react_tab if nlist.react_tab is not None
                     else nlist.react_idx)
        res, _ = ham.adiabatic_energy_force(
            x, box, topo, system, pairs, cbw, full_src, react_idx=react_src,
            com=com)
        return ForceEval(potential=res.energy, breakdown=res.breakdown,
                         force=res.force, topo=res.principle_topo,
                         n_states=res.n_states, eigenvector=res.eigenvector,
                         evb_overflow=res.overflow,
                         hydronium_of=res.hydronium_of,
                         n_hops_of=res.n_hops_of,
                         row_overflow=res.row_overflow)
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        bd = total_mod.total_energy(xg, box, topo, system, pairs, cbw)
        grad, = torch.autograd.grad(bd.total, xg)
    bd = dataclasses.replace(bd, **{k: getattr(bd, k).detach() for k in (
        "total", "elec", "vdw", "bond", "angle", "dihedral")})
    return ForceEval(potential=bd.total, breakdown=bd, force=-grad,
                     topo=topo, n_states=torch.ones((), dtype=torch.int64,
                                                    device=dev),
                     eigenvector=torch.zeros(S, dtype=x.dtype, device=dev),
                     evb_overflow=torch.zeros((), dtype=torch.bool,
                                              device=dev),
                     hydronium_of=torch.full((S,), -1, device=dev),
                     n_hops_of=torch.zeros(S, dtype=torch.int64, device=dev),
                     row_overflow=torch.zeros((), dtype=torch.bool,
                                              device=dev))


def _sync_flags(nlist, fe, hopped):
    """One host sync for the step's flags: (the CAPACITIES that did not
    hold, hopped, |F| > 1e4).  The slab flag comes from the forward's own
    slab binning, kernel A's from its own cell binning: no second
    binning."""
    bd = fe.breakdown
    flags = torch.stack([nlist.overflow, fe.row_overflow, bd.rs_overflow,
                         bd.slab_overflow, fe.evb_overflow, hopped,
                         (fe.force.abs() > 1.0e4).any()]).tolist()
    over = tuple(n for n, bad in zip(CAPACITIES, flags[:5]) if bad)
    return over, flags[5], flags[6]


def neighbor_plan(system, box, capacity, cells=None, react_cap=None,
                  react_cells=None):
    """The neighbor-list configuration initial_md_state builds, as the
    keyword arguments of neighbors.build_neighbors.

    cells: the cell-list grid (None: suggest_cells' choice, () forces the
    dense build); with cells on an MS-EVB system the adjacency rows come
    on demand from the cell tables, with a finer react-cutoff grid
    (react_cells, None: suggested).  Kernel A bins atoms itself, so the
    half list is built only without it.  The JAX package's choices
    (md/integrators.py:314-355)."""
    box_np = box.detach().cpu().numpy()
    if cells is None:
        cells = neighbors.suggest_cells(system.n_atoms, box_np,
                                        system.verlet_cutoff)
    react_cutoff = 0.0
    if system.ms_evb:
        skin = system.verlet_cutoff - system.real_space_cutoff
        react_cutoff = float(system.evb_reactive_pair_distance + skin)
        if react_cap is None:
            vol = float(pbc.box_volume(box))
            react_cap = neighbors.suggest_capacity(
                system.n_atoms, vol, react_cutoff, safety=1.4)
    else:
        react_cap = 0
    on_demand = bool(cells) and system.ms_evb
    if on_demand and react_cap and react_cells is None:
        react_cells = neighbors.suggest_cells(system.n_atoms, box_np,
                                              react_cutoff, min_atoms=0)
    return dict(cutoff=system.verlet_cutoff, capacity=capacity, cells=cells,
                react_cutoff=react_cutoff, react_cap=react_cap,
                build_half=not system.rs_cells, on_demand=on_demand,
                react_cells=react_cells or ())


def initial_md_state(state: State, topo, system, cbw, capacity, cells=None,
                     react_cap=None, react_cells=None, comp=None) -> MDState:
    """The state before the first step: neighbor lists (neighbor_plan's
    configuration) and forces.  MDState.overflow lists the capacities
    that did not hold.  comp: the Kahan carries to keep (zeros when None
    and the system is compensated)."""
    nlist = neighbors.build_neighbors(
        state.x, state.box, **neighbor_plan(system, state.box, capacity,
                                            cells, react_cap, react_cells))
    fe = evaluate_forces(state.x, state.box, topo, system, nlist, cbw)
    over, _, _ = _sync_flags(nlist, fe, torch.zeros(
        (), dtype=torch.bool, device=state.x.device))
    if comp is None and system.compensated_sum:
        comp = CompCarry(x=torch.zeros_like(state.x),
                         v=torch.zeros_like(state.v))
    return MDState(state=state, topo=fe.topo, nlist=nlist, force=fe.force,
                   potential=fe.potential, breakdown=fe.breakdown,
                   kinetic=velocities.kinetic_energy(state.v, system.mass),
                   n_states=fe.n_states, eigenvector=fe.eigenvector,
                   hydronium_of=fe.hydronium_of, n_hops_of=fe.n_hops_of,
                   overflow=over, comp=comp)


def md_step(ms: MDState, system, cbw, dt: float, ensemble="NVE",
            friction=0.1, temperature=300.0, noise=None) -> MDState:
    """One step of `ensemble`: velocity Verlet for NVE and NPT (the
    barostat moves between steps), Langevin for both half kicks under
    NVT with the step's standard normal draws noise = (g1, g2), each
    (N, 3) in the state's dtype.  Under NVE and NPT with
    System.compensated_sum the kicks and the drift are Kahan sums
    (ms.comp).  The result is valid only if its `overflow` is empty;
    else regrow and redo it from `ms` with the same noise."""
    if ensemble not in ENSEMBLES:
        raise ValueError(f"ensemble {ensemble!r}: expected one of "
                         f"{', '.join(ENSEMBLES)}")
    if ensemble == "NVT" and noise is None:
        raise ValueError("an NVT step needs its two Gaussian draws "
                         "(noise=(g1, g2))")
    state, topo = ms.state, ms.topo
    box = state.box
    mass = system.mass[:, None]
    mobile = velocities.freeze_mask(system, topo)[:, None]
    conv = CONV_KJMOL_A2PS2GMOL
    g1, g2 = noise if ensemble == "NVT" else (None, None)
    # the Langevin update is not a pure add, and its noise dwarfs fp32
    # rounding: the compensated sum serves the Verlet kicks only
    compensated = system.compensated_sum and ensemble != "NVT"

    def kick(v, f, g):
        if ensemble == "NVT":
            return langevin_half_kick(v, f, mass, g, dt, friction,
                                      temperature)
        return v + dt / 2.0 * f / mass * conv

    def masked_two_sum(acc, delta, carry):
        t, c = two_sum_add(acc, delta, carry)
        return torch.where(mobile, t, acc), torch.where(mobile, c, carry)

    if compensated:
        v, vc = masked_two_sum(state.v, dt / 2.0 * ms.force / mass * conv,
                               ms.comp.v)
        x, xc = masked_two_sum(state.x, v * dt, ms.comp.x)
    else:
        v = torch.where(mobile, kick(state.v, ms.force, g1), state.v)
        x = torch.where(mobile, state.x + v * dt, state.x)
    x, com = wrap_molecules(x, box, topo, system.mass)

    nlist = ms.nlist
    skin = system.verlet_cutoff - system.real_space_cutoff
    if bool(neighbors.needs_rebuild(nlist, x, box, skin)):
        nlist = neighbors.rebuild_like(nlist, x, box, system.verlet_cutoff)

    fe = evaluate_forces(x, box, topo, system, nlist, cbw, com=com)
    if compensated:
        v, vc = masked_two_sum(v, dt / 2.0 * fe.force / mass * conv, vc)
        comp = CompCarry(x=xc, v=vc)
    else:
        v = torch.where(mobile, kick(v, fe.force, g2), v)
        comp = ms.comp
    v = velocities.remove_com_momentum(v, system.mass, mobile[:, 0])
    over, hopped, force_overflow = _sync_flags(
        nlist, fe, fe.topo.hydronium_mol != topo.hydronium_mol)
    return MDState(state=State(x=x, v=v, box=box, step=state.step + 1),
                   topo=fe.topo, nlist=nlist, force=fe.force,
                   potential=fe.potential, breakdown=fe.breakdown,
                   kinetic=velocities.kinetic_energy(v, system.mass),
                   n_states=fe.n_states, eigenvector=fe.eigenvector,
                   hydronium_of=fe.hydronium_of, n_hops_of=fe.n_hops_of,
                   hopped=hopped, force_overflow=force_overflow,
                   overflow=over, comp=comp)
