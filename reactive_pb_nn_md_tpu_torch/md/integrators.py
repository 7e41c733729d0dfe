"""MD step: velocity Verlet (NVE, and NPT between barostat moves) and
Langevin leapfrog (NVT) (counterpart of
reactive_pb_nn_md_tpu/md/integrators.py; md_integrate_atomic,
md_integration.f90:438-541, langevin_integrator :186-228), and md_scan,
a chunk of steps with per-step diagnostics.

One step = kick, drift, wrap whole molecules, neighbor rebuild when the
displacements exceed the skin, force evaluation (the MS-EVB adiabatic
surface in reactive mode, which also switches the principle topology on
a hop), kick, COM-momentum removal.  With System.compensated_sum the
NVE/NPT kicks and the drift accumulate with Kahan carries (MDState.comp).
The NVT step takes its two Gaussian draws as an argument, so a step
redone after a capacity regrow reuses them.

The step makes no host synchronization: the rebuild is computed every
step and selected on the device (the JAX package's lax.cond), and the
step's flags stay device tensors (MDState.overflow, hopped,
force_overflow, small_overflow, gs_failed), which md_scan stacks into its
per-step rows and the host reads once a chunk.  On the card md_scan
replays the step captured as a CUDA graph (md/graphs.py); on the CPU it
runs the same step eagerly.  A capacity that did not hold (neighbor rows,
cells, on-demand rows, kernel A's cells, the PME slab cap, the EVB state
cap) makes the step's result not valid: regrown_chunk grows the
capacities by the JAX package's factors (grow_capacities) and replays
the chunk, for the simulation loop (md/simulation.py) and the run
scripts.

An umbrella restraint (md/bias.py), when given as `bias`, adds its force
to the physical force before the second half kick; MDState.force,
force_overflow and potential then include it (the breakdown does not),
and md_scan's cv column holds its primary CV after every step.

With `shard` (parallel/shard.py) one replica's step is shared over the
ranks of a process group: the state stays replicated, each rank
computes its share of the force evaluation, the forces are summed over
the ranks and the step's flags are OR-ed over them, so every rank takes
the same step and the same host decisions.  Without it nothing changes.
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
from . import bias as bias_mod
from . import graphs, velocities


class CapacityOverflow(RuntimeError):
    """A capacity still overflowing after MAX_REGROWS regrow rounds
    (settle, regrown_chunk)."""


class GroundStateError(RuntimeError):
    """Kernel E failed: its multisection did not close, or its
    eigenvector's residual exceeded the bound (ops/ground_state.py)."""


# the capacity flags of a step, in the order of MDState.overflow, and the
# ChunkDiagnostics field of each
CAPACITIES = ("neighbor-list capacity", "on-demand row capacity",
              "kernel A cell capacity", "PME slab capacity",
              "EVB state cap")
NEIGHBOR_CAP, ROW_CAP, RS_CELL_CAP, SLAB_CAP, EVB_STATE_CAP = CAPACITIES
CAPACITY_FIELDS = ("neighbor_overflow", "row_overflow", "rs_cell_overflow",
                   "slab_overflow", "evb_overflow")
ENSEMBLES = ("NVE", "NVT", "NPT")
# steps a chunk of md_scan holds (one host read each)
MAX_CHUNK = graphs.MAX_CHUNK


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
    small_overflow: torch.Tensor   # () bool: the small tier overflowed
    gs_failed: torch.Tensor        # () bool: kernel E did not converge


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
    # device flags of the step: (len(CAPACITIES),) bool, a capacity that
    # did not hold (the result is not valid: regrow and redo); () bool
    # each: the hydronium changed, |F| > 1e4 (the reference aborts), the
    # small tier's enumeration overflowed (not valid: redo at the full
    # cap), kernel E did not converge
    overflow: torch.Tensor
    hopped: torch.Tensor
    force_overflow: torch.Tensor
    small_overflow: torch.Tensor
    gs_failed: torch.Tensor
    comp: Optional[CompCarry] = None   # Kahan carries (compensated_sum)


def overflow_names(flags):
    """The CAPACITIES whose flag in `flags` (len(CAPACITIES),) is set: one
    host read."""
    return tuple(n for n, bad in zip(CAPACITIES, flags.tolist()) if bad)


def overflowed(ms):
    """The CAPACITIES that did not hold in `ms` (one host read)."""
    return overflow_names(ms.overflow)


def wrap_molecules(x, box, topo, mass):
    """Translate whole molecules into the box by their COM; returns
    (wrapped x, wrapped COM), the COM is reused by the EVB layer."""
    com = molecule_com(x, topo.mol_atoms, mass, box)
    shift = torch.floor(pbc.xyz_to_frac(com, box)).detach() @ box
    return x - shift[topo.atom_mol], com - shift


def evaluate_forces(x, box, topo, system, nlist, cbw, com=None,
                    tier="full", shard=None):
    """Reactive (MS-EVB) or plain force evaluation; `tier` the EVB
    two-tier mode of hamiltonian.adiabatic_energy_force; `shard` the
    evaluation shared over ranks (parallel/shard.py)."""
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
            com=com, tier=tier, shard=shard)
        return ForceEval(potential=res.energy, breakdown=res.breakdown,
                         force=res.force, topo=res.principle_topo,
                         n_states=res.n_states, eigenvector=res.eigenvector,
                         evb_overflow=res.overflow,
                         hydronium_of=res.hydronium_of,
                         n_hops_of=res.n_hops_of,
                         row_overflow=res.row_overflow,
                         small_overflow=res.small_overflow,
                         gs_failed=res.gs_failed)
    def energy(xg):
        bd = total_mod.total_energy(xg, box, topo, system, pairs, cbw,
                                    shard=shard)
        return bd.total, bd

    _, bd, grad = ham.energy_and_grad(energy, x)
    if shard is not None:
        grad = shard.sum_force(grad)
    bd = dataclasses.replace(bd, **{k: getattr(bd, k).detach() for k in (
        "total", "elec", "vdw", "bond", "angle", "dihedral")})
    no = torch.zeros((), dtype=torch.bool, device=dev)
    return ForceEval(potential=bd.total, breakdown=bd, force=-grad,
                     topo=topo, n_states=torch.ones((), dtype=torch.int64,
                                                    device=dev),
                     eigenvector=torch.zeros(S, dtype=x.dtype, device=dev),
                     evb_overflow=no,
                     hydronium_of=torch.full((S,), -1, device=dev),
                     n_hops_of=torch.zeros(S, dtype=torch.int64, device=dev),
                     row_overflow=no, small_overflow=no, gs_failed=no)


def capacity_flags(nlist, fe):
    """(len(CAPACITIES),) bool device tensor: the capacities that did not
    hold.  The slab flag comes from the forward's own slab binning,
    kernel A's from its own cell binning: no second binning."""
    bd = fe.breakdown
    return torch.stack([nlist.overflow, fe.row_overflow, bd.rs_overflow,
                        bd.slab_overflow, fe.evb_overflow])


def step_flags(nlist, fe, shard=None):
    """(capacity_flags, small_overflow, gs_failed) of a step, OR-ed over
    the ranks of `shard` in one collective when given."""
    flags = capacity_flags(nlist, fe)
    if shard is None:
        return flags, fe.small_overflow, fe.gs_failed
    n = flags.shape[0]
    v = shard.any(torch.cat([flags, fe.small_overflow[None],
                             fe.gs_failed[None]]))
    return v[:n], v[n], v[n + 1]


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


def grow_capacities(names, system, capacity, cells, react_cap, react_cells,
                    hard_max_states, step, redo):
    """The capacities of `names` (CAPACITIES) grown by the JAX package's
    factors (md/simulation.py:189-238 there): (System, (capacity, cells,
    react_cap, react_cells), log lines, one for the state cap and one
    for the others, each naming `step` and ending with `redo`).  The
    state cap grows to min(hard_max_states, max(2S, S + 8)).  The JAX
    package grows all of the others, its flag being shared; the port's
    flags are separate, so the others keep their size (a kernel A or
    slab cap grown for nothing costs shared memory and time).  The
    System returned is always a new object."""
    n1 = system.n_atoms - 1
    kw = {}
    lines = []
    if EVB_STATE_CAP in names:
        S = system.evb_max_states
        kw["evb_max_states"] = min(hard_max_states, max(2 * S, S + 8))
        lines.append(f"step {step}: diabat enumeration exceeded the "
                     f"state cap; evb_max_states regrown to "
                     f"{kw['evb_max_states']}, {redo}\n")
    if {NEIGHBOR_CAP, ROW_CAP} & set(names):
        capacity = min(int(capacity * 1.5) + 8, n1)
        if cells:
            nc1, nc2, nc3, ccap = cells
            cells = (nc1, nc2, nc3, int(ccap * 1.5) + 4)
        if react_cap:
            react_cap = min(int(react_cap * 1.5) + 8, n1)
        if react_cells:
            rn1, rn2, rn3, rcc = react_cells
            react_cells = (rn1, rn2, rn3, int(rcc * 1.5) + 4)
    if RS_CELL_CAP in names:
        n1_, n2_, n3_, rcap = system.rs_cells
        kw["rs_cells"] = (n1_, n2_, n3_, -(-int(rcap * 1.3 + 8) // 8) * 8)
    if SLAB_CAP in names:
        # multiplicative: a melting lattice concentrates whole planes
        # into single slabs (~2.7x the mean on the 10k box)
        kw["pme_scap"] = -(-int(system.pme_scap * 1.3 + 16) // 8) * 8
    system = system.replace(**kw)
    others = [n for n in names if n != EVB_STATE_CAP]
    if others:
        lines.append(
            f"step {step}: regrow ({', '.join(others)} exceeded): "
            f"capacity {capacity} cells {cells} react_cap "
            f"{react_cap} react_cells {react_cells} rs_cells "
            f"{system.rs_cells} pme_scap {system.pme_scap}, "
            f"{redo}\n")
    return system, (capacity, cells, react_cap, react_cells), lines


def initial_md_state(state: State, topo, system, cbw, capacity, cells=None,
                     react_cap=None, react_cells=None, comp=None,
                     bias=None, shard=None) -> MDState:
    """The state before the first step: neighbor lists (neighbor_plan's
    configuration) and forces, the restraint `bias` (md/bias.py) included
    when given.  MDState.overflow flags the capacities that did not hold
    (overflowed() names them).  comp: the Kahan carries to keep (zeros
    when None and the system is compensated).  shard: the evaluation
    shared over ranks (parallel/shard.py)."""
    nlist = neighbors.build_neighbors(
        state.x, state.box, **neighbor_plan(system, state.box, capacity,
                                            cells, react_cap, react_cells))
    fe = evaluate_forces(state.x, state.box, topo, system, nlist, cbw,
                         shard=shard)
    overflow, small_overflow, gs_failed = step_flags(nlist, fe, shard)
    force, potential = _with_bias(fe, state.x, state.box, bias)
    if comp is None and system.compensated_sum:
        comp = CompCarry(x=torch.zeros_like(state.x),
                         v=torch.zeros_like(state.v))
    return MDState(state=state, topo=fe.topo, nlist=nlist, force=force,
                   potential=potential, breakdown=fe.breakdown,
                   kinetic=velocities.kinetic_energy(state.v, system.mass),
                   n_states=fe.n_states, eigenvector=fe.eigenvector,
                   hydronium_of=fe.hydronium_of, n_hops_of=fe.n_hops_of,
                   overflow=overflow,
                   hopped=torch.zeros_like(fe.small_overflow),
                   force_overflow=(force.abs() > 1.0e4).any(),
                   small_overflow=small_overflow, gs_failed=gs_failed,
                   comp=comp)


def _with_bias(fe, x, box, bias):
    """(force, potential) of `fe` with the restraint `bias` added."""
    if bias is None:
        return fe.force, fe.potential
    be, bf = bias_mod.bias_energy_force(x, box, bias)
    return fe.force + bf, fe.potential + be


def md_step(ms: MDState, system, cbw, dt: float, ensemble="NVE",
            friction=0.1, temperature=300.0, noise=None,
            tier="full", bias=None, shard=None) -> MDState:
    """One step of `ensemble`: velocity Verlet for NVE and NPT (the
    barostat moves between steps), Langevin for both half kicks under
    NVT with the step's standard normal draws noise = (g1, g2), each
    (N, 3) in the state's dtype.  Under NVE and NPT with
    System.compensated_sum the kicks and the drift are Kahan sums
    (ms.comp).  `tier`: the EVB two-tier mode ("small" or "full").
    `bias`: an umbrella restraint (md/bias.py), its force added before
    the second half kick and its energy to the potential.  `shard`: the
    step shared over ranks (parallel/shard.py; under NVT every rank draws
    the same noise).  The result is valid only if no flag of its
    `overflow` and not its `small_overflow` is set; else regrow (or take
    the full tier) and redo it from `ms` with the same noise."""
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

    # the rebuild is computed every step and taken where the displacements
    # exceed the skin, on the device (the JAX package's lax.cond)
    skin = system.verlet_cutoff - system.real_space_cutoff
    nlist = neighbors.where_nlist(
        neighbors.needs_rebuild(ms.nlist, x, box, skin),
        neighbors.rebuild_like(ms.nlist, x, box, system.verlet_cutoff),
        ms.nlist)

    fe = evaluate_forces(x, box, topo, system, nlist, cbw, com=com,
                         tier=tier, shard=shard)
    overflow, small_overflow, gs_failed = step_flags(nlist, fe, shard)
    force, potential = _with_bias(fe, x, box, bias)
    if compensated:
        v, vc = masked_two_sum(v, dt / 2.0 * force / mass * conv, vc)
        comp = CompCarry(x=xc, v=vc)
    else:
        v = torch.where(mobile, kick(v, force, g2), v)
        comp = ms.comp
    v = velocities.remove_com_momentum(v, system.mass, mobile[:, 0])
    return MDState(state=State(x=x, v=v, box=box, step=state.step + 1),
                   topo=fe.topo, nlist=nlist, force=force,
                   potential=potential, breakdown=fe.breakdown,
                   kinetic=velocities.kinetic_energy(v, system.mass),
                   n_states=fe.n_states, eigenvector=fe.eigenvector,
                   hydronium_of=fe.hydronium_of, n_hops_of=fe.n_hops_of,
                   overflow=overflow,
                   hopped=fe.topo.hydronium_mol != topo.hydronium_mol,
                   force_overflow=(force.abs() > 1.0e4).any(),
                   small_overflow=small_overflow, gs_failed=gs_failed,
                   comp=comp)


def draw_noise(x, generator):
    """An NVT step's two standard normal draws, each x's shape and dtype,
    from `generator` on x's device."""
    return tuple(torch.randn(x.shape, generator=generator, device=x.device,
                             dtype=x.dtype) for _ in range(2))


@dataclass
class ChunkDiagnostics:
    """Per-step values of a chunk, (n_steps,) CPU tensors from one host
    read (the JAX package's ChunkDiagnostics; parallel/ensemble.py stacks
    them to (W, n_steps)).  cv is the restraint's primary CV (md/bias.py)
    after the step, 0 when the chunk runs unbiased.  The capacity flags
    are kept apart, one field each (CAPACITY_FIELDS, in CAPACITIES
    order); small_overflow flags the steps
    whose small-tier enumeration overflowed in the chunk's first run (the
    chunk was then replayed at the full cap); gs_failed the steps where
    kernel E did not converge."""
    potential: torch.Tensor
    kinetic: torch.Tensor
    n_states: torch.Tensor
    hopped: torch.Tensor
    hydronium: torch.Tensor
    max_ci2: torch.Tensor
    cv: torch.Tensor
    force_overflow: torch.Tensor
    small_overflow: torch.Tensor
    gs_failed: torch.Tensor
    neighbor_overflow: torch.Tensor
    row_overflow: torch.Tensor
    rs_cell_overflow: torch.Tensor
    slab_overflow: torch.Tensor
    evb_overflow: torch.Tensor

    def capacities(self):
        """The CAPACITIES that did not hold at some step."""
        return tuple(n for n, f in zip(CAPACITIES, CAPACITY_FIELDS)
                     if bool(getattr(self, f).any()))

    def first(self, names):
        """Index of the first step where any capacity of `names` did not
        hold."""
        bad = torch.zeros_like(self.potential, dtype=torch.bool)
        for n in names:
            bad |= getattr(self, CAPACITY_FIELDS[CAPACITIES.index(n)])
        return int(torch.nonzero(bad)[0, 0])


# the row a step writes, in ChunkDiagnostics' field order
_ROW = tuple(f.name for f in dataclasses.fields(ChunkDiagnostics))


def _diag_row(ms, cv):
    """The step's (len(_ROW),) float64 row (every value exact in fp64),
    `cv` its 0-d CV."""
    f = torch.float64
    vals = [ms.potential, ms.kinetic, ms.n_states, ms.hopped,
            ms.topo.hydronium_mol, (ms.eigenvector ** 2).max(), cv,
            ms.force_overflow, ms.small_overflow, ms.gs_failed]
    return torch.cat([torch.stack([v.to(f) for v in vals]),
                      ms.overflow.to(f)])


def _diagnostics(rows, dtype):
    """ChunkDiagnostics of the (n, len(_ROW)) rows (one host read); of a
    replica batch's (n, W, len(_ROW)) rows, (W, n) fields."""
    rows = rows.cpu().movedim(0, -2)
    kinds = {"potential": dtype, "kinetic": dtype, "max_ci2": dtype,
             "cv": dtype, "n_states": torch.int64, "hydronium": torch.int64}
    return ChunkDiagnostics(**{
        name: rows[..., i].to(kinds.get(name, torch.bool))
        for i, name in enumerate(_ROW)})


def scan_step(ms, system, cbw, dt, ensemble, friction, temperature,
              generator, tier, bias=None, shard=None):
    """One step of md_scan: the NVT draws from `generator`, md_step under
    the restraint `bias`, the diagnostics row.  The body the CUDA graph
    captures and the CPU runs."""
    noise = (draw_noise(ms.state.x, generator) if ensemble == "NVT"
             else None)
    return scan_step_with(ms, system, cbw, dt, ensemble, friction,
                          temperature, noise, tier, bias, shard)


def scan_step_with(ms, system, cbw, dt, ensemble, friction, temperature,
                   noise, tier="full", bias=None, shard=None):
    """scan_step with the NVT draws `noise` given: md_step and the
    diagnostics row."""
    ms = md_step(ms, system, cbw, dt, ensemble, friction, temperature,
                 noise=noise, tier=tier, bias=bias, shard=shard)
    x = ms.state.x
    cv = (torch.zeros((), dtype=x.dtype, device=x.device) if bias is None
          else bias_mod.primary_cv(x, ms.state.box, bias))
    return ms, _diag_row(ms, cv)


def graph_key(ms, system, cbw, dt, ensemble, friction, temperature,
              generator, tier, bias=None, shard=None):
    """The StepGraphs key of a captured step.  The System (whose kernel A
    cell cap, slab cap and state cap live nowhere else) and the generator
    enter held (graphs.Held), not by id(): a kept key keeps them alive,
    so no later System can match a graph captured for another.  A
    restraint (a tuple, md_scan's) enters by its signature (cv_type,
    shapes, dtypes), never its values: they are static inputs of the
    graph, copied in at each chunk's start, so one capture serves every
    window of a ladder.  A shard (parallel/shard.py) enters held: its
    collectives are captured on its group."""
    return (ensemble, ms.state.x.dtype, tier, dt, friction, temperature,
            graphs.Held(system), graphs.Held(generator),
            graphs.signature(ms), tuple(cbw.shape), graphs.signature(bias),
            graphs.Held(shard))


def _scan(ms, system, cbw, dt, ensemble, n_steps, friction, temperature,
          generator, tier, step_graphs, eager, bias, shard):
    """n_steps steps at one tier: (MDState, ChunkDiagnostics)."""
    def body(m, w, b):
        return scan_step(m, system, w, dt, ensemble, friction, temperature,
                         generator, tier, b, shard)

    if ms.state.x.is_cuda and not eager:
        key = graph_key(ms, system, cbw, dt, ensemble, friction,
                        temperature, generator, tier, bias, shard)
        g = step_graphs.get(key, lambda: graphs.StepGraph(
            body, ms, cbw, generator if ensemble == "NVT" else None, bias))
        out, rows = g.run(ms, cbw, n_steps, bias)
    else:
        out, rows = ms, []
        for _ in range(n_steps):
            out, row = body(out, cbw, bias)
            rows.append(row)
        rows = torch.stack(rows)
    out = dataclasses.replace(out, state=dataclasses.replace(
        out.state, step=ms.state.step + n_steps))
    return out, _diagnostics(rows, ms.state.x.dtype)


def md_scan(ms: MDState, system, cbw, dt: float, ensemble="NVE",
            n_steps=1, friction=0.1, temperature=300.0, generator=None,
            step_graphs=None, eager=False, bias=None, shard=None):
    """n_steps (<= MAX_CHUNK on the card) MD steps from `ms`: (MDState
    after them, ChunkDiagnostics).

    On the card each step is a replay of the step captured as a CUDA graph
    (md/graphs.py; `step_graphs`, a graphs.StepGraphs, keeps the captures
    of a run, else they are made for this call), with no host
    synchronization until the diagnostics are read at the end; on the CPU
    the same step runs eagerly.  NVT draws from `generator` inside the
    step.  With an EVB small tier the chunk runs at the small cap, and
    when any step's small enumeration overflowed it is replayed from its
    start at the full cap, the generator restored first: the small set
    equals the full enumeration whenever it fits, so the trajectory is
    that of per-step selection up to rounding.  The result is valid only
    if diag.capacities() is empty (else regrow and replay the chunk).
    eager: no graph on the card either (the reference that chip_smoke.py
    holds the graphs against).  bias: an umbrella restraint (md/bias.py;
    one HarmonicBias or a tuple), whose primary CV is diag.cv.  shard:
    every step shared over the ranks of a process group (parallel/
    shard.py), its collectives inside the captured step; every rank of
    the group calls md_scan with the same arguments, and the replay of
    the small tier's chunk is decided from flags OR-ed over the ranks.

    A stacked replica batch `ms` (stack_states: every tensor (W, ...))
    runs batched_md_scan, `generator` then one generator a replica and
    `bias` the stacked restraint of a ladder; with `shard` the batch's
    step is shared over the group as one replica's is."""
    if ms.state.x.ndim == 3:
        return batched_md_scan(ms, system, cbw, dt, ensemble, n_steps,
                               friction, temperature, generator,
                               step_graphs, eager, bias, shard)
    if ensemble not in ENSEMBLES:
        raise ValueError(f"ensemble {ensemble!r}: expected one of "
                         f"{', '.join(ENSEMBLES)}")
    if ensemble == "NVT" and generator is None:
        raise ValueError("an NVT chunk needs the generator of its draws")
    if ms.state.x.is_cuda and step_graphs is None and not eager:
        step_graphs = graphs.StepGraphs()
    small = system.ms_evb and ham.small_state_tier(system) > 0
    start = generator.get_state() if ensemble == "NVT" else None
    bias = bias_mod.as_tuple(bias)
    args = (system, cbw, dt, ensemble, n_steps, friction, temperature,
            generator)
    out, diag = _scan(ms, *args, "small" if small else "full", step_graphs,
                      eager, bias, shard)
    if small and bool(diag.small_overflow.any()):
        if start is not None:
            generator.set_state(start)
        first = diag.small_overflow
        out, diag = _scan(ms, *args, "full", step_graphs, eager, bias, shard)
        diag = dataclasses.replace(diag, small_overflow=first)
    return out, diag


# ---- the regrow rule of a run (md/simulation.py, the run scripts): a
# capacity that did not hold is grown (grow_capacities) and the state set
# up again at the new size, or the chunk replayed from its start

# regrow rounds before a capacity that still overflows is an error
MAX_REGROWS = 16


def capacities_of(ms):
    """The sizes grow_capacities takes besides the System's, as `ms`'s
    neighbor lists hold them: (capacity, cells, react_cap, react_cells)."""
    nl = ms.nlist
    return (nl.capacity, nl.cells, nl.react_cap or None,
            nl.react_cells or None)


def to_grow(names, system, hard_max_states, tolerate=()):
    """The CAPACITIES of `names` to regrow: those not in `tolerate`, and
    the EVB state cap only below its ceiling hard_max_states (it cannot
    grow there).  A flag not grown is the caller's to judge."""
    return tuple(n for n in names if n not in tolerate
                 and (n != EVB_STATE_CAP
                      or system.evb_max_states < hard_max_states))


def settle(state, topo, system, cbw, caps, hard_max_states, step,
           comp=None, tolerate=(), log=None):
    """initial_md_state at `state` under `caps` (capacities_of's tuple),
    the capacities to grow (to_grow) grown until they hold, each regrow's
    lines, naming `step`, passed to `log`: (MDState, System, caps).  A
    flag not grown stays in MDState.overflow.  Raises GroundStateError
    where kernel E did not converge."""
    for _ in range(MAX_REGROWS + 1):
        capacity, cells, react_cap, react_cells = caps
        ms = initial_md_state(state, topo, system, cbw, capacity, cells,
                              react_cap=react_cap, react_cells=react_cells,
                              comp=comp)
        caps = (capacity, cells, ms.nlist.react_cap or None,
                ms.nlist.react_cells or None)
        if bool(ms.gs_failed):
            raise GroundStateError(
                f"step {step}: the EVB ground state did not converge")
        over = to_grow(overflowed(ms), system, hard_max_states, tolerate)
        if not over:
            return ms, system, caps
        system, caps, lines = grow_capacities(
            over, system, *caps, hard_max_states, step, "step redone")
        if log is not None:
            log(lines)
    raise CapacityOverflow(f"step {step}: {', '.join(over)} still "
                           f"exceeded after {MAX_REGROWS} regrows")


@dataclass
class Regrown:
    """A chunk of regrown_chunk: the MDState after it and its
    ChunkDiagnostics, the MDState it started from (after the last regrow,
    the state set up again at the new sizes), the System and caps it ran
    under and its regrow rounds."""
    ms: MDState
    diag: ChunkDiagnostics
    start: MDState
    system: object
    caps: tuple
    regrows: int


def regrown_chunk(ms, system, cbw, caps, hard_max_states, dt, ensemble,
                  n_steps, friction=0.1, temperature=300.0, generator=None,
                  step_graphs=None, eager=False, tolerate=(), log=None,
                  step=None):
    """n_steps of md_scan from `ms` (the step number `step`, by default
    ms.state.step) under `caps`; each capacity to grow (to_grow) that did
    not hold is grown (its lines passed to `log`), the chunk's start set
    up again by settle, `generator` restored and the chunk replayed, the
    Kahan carries kept: a Regrown.  Its diagnostics may hold the flags
    not grown.  A chunk whose kinetic energy went non-finite is returned
    as it is (past a blow-up the flags mean nothing).  Raises
    GroundStateError where kernel E did not converge."""
    step = ms.state.step if step is None else step
    gen0 = generator.get_state() if generator is not None else None
    for k in range(MAX_REGROWS + 1):
        out, diag = md_scan(ms, system, cbw, dt, ensemble, n_steps,
                            friction, temperature, generator=generator,
                            step_graphs=step_graphs, eager=eager)
        if bool(diag.gs_failed.any()):
            bad = step + int(torch.nonzero(diag.gs_failed)[0, 0]) + 1
            raise GroundStateError(
                f"step {bad}: the EVB ground state (kernel E) did not "
                f"converge")
        over = to_grow(diag.capacities(), system, hard_max_states, tolerate)
        if not over or not bool(torch.isfinite(diag.kinetic).all()):
            return Regrown(out, diag, ms, system, caps, k)
        bad = step + diag.first(over) + 1
        system, caps, lines = grow_capacities(
            over, system, *caps, hard_max_states, bad, "chunk replayed")
        if log is not None:
            log(lines)
        if gen0 is not None:
            generator.set_state(gen0)
        ms, system, caps = settle(ms.state, ms.topo, system, cbw, caps,
                                  hard_max_states, bad, comp=ms.comp,
                                  tolerate=tolerate, log=log)
    raise CapacityOverflow(f"step {step}: {', '.join(over)} still "
                           f"exceeded after {MAX_REGROWS} regrows")


# ---- a replica batch: the counterpart of the JAX package's
# jax.vmap(md_step / md_scan) (parallel/ensemble.py make_replica_scan,
# parallel/umbrella.py make_ladder_scan).  W MDStates of one signature are
# stacked on a leading axis, and ONE step, md_step under torch.func.vmap,
# advances all of them: every torch op runs once for the batch and each
# kernel (A, A', A'', B1, B2, C1, C2, D1, D2, E) launches once for all W
# (their ops' batching rules).  Any path of one replica's step runs so:
# the dense or cell-list neighbors (each replica's own rebuild decision
# selected on the device, its own cell tables and on-demand rows), the
# domain repulsion, kernel A's full stencil or A' / A'', the per-atom or
# the slab PME spread.  With a shard the batch's step is shared over the
# ranks of its group: each kernel runs on this rank's share for all W
# (A's cell range, the atom slices of B1 / D1), and each of the step's
# four collectives is issued once for the stacked (W, ...) tensor
# (parallel/shard.py), the counterpart of the JAX replica_sharding's
# batch sharded over both mesh axes.

def stack_states(states):
    """One MDState whose tensors are those of `states` (one signature)
    stacked on a leading axis; the static fields (capacities, cell grids,
    the step count) are states[0]'s."""
    sig = graphs.signature(states[0])
    if any(graphs.signature(s) != sig for s in states[1:]):
        raise ValueError("a replica batch needs MDStates of one signature "
                         "(shapes, capacities, cell grids)")
    cols = zip(*(graphs.leaves(s) for s in states))
    return graphs.with_leaves(states[0], (torch.stack(c) for c in cols))


def unstack_states(bms):
    """The W MDStates of a stacked batch (views of its tensors)."""
    W = bms.state.x.shape[0]
    ts = graphs.leaves(bms)
    return [graphs.with_leaves(bms, (t[w] for t in ts)) for w in range(W)]


def batched_scan_step(bms, system, cbw, dt, ensemble, friction, temperature,
                      generators, bias=None, shard=None):
    """One step of every replica of the stacked batch `bms`: the NVT draws
    of replica w from generators[w] (drawn before the vmapped step, in
    replica order, so each stream equals the one replica's own; under a
    shard every rank of the group holds the same generator states, so
    its ranks draw the same noise), md_step vmapped over the replicas
    under the stacked restraint `bias` (a tuple of HarmonicBias of
    (W, ...) leaves, or None) at the full cap, shared over the ranks of
    `shard` when given, and the (W, D) diagnostics rows."""
    noise = None
    if ensemble == "NVT":
        draws = [draw_noise(x, g) for x, g in zip(bms.state.x, generators)]
        noise = tuple(torch.stack([d[k] for d in draws]) for k in range(2))

    def one(tensors, noise_w, bias_leaves):
        ms = graphs.with_leaves(bms, iter(tensors))
        b = graphs.with_leaves(bias, iter(bias_leaves))
        ms, row = scan_step_with(ms, system, cbw, dt, ensemble, friction,
                                 temperature, noise_w, bias=b, shard=shard)
        return graphs.leaves(ms), row

    out, rows = torch.func.vmap(one, in_dims=(0, None if noise is None
                                              else 0, 0))(
        graphs.leaves(bms), noise, graphs.leaves(bias))
    return graphs.with_leaves(bms, iter(out)), rows


def batch_key(bms, system, cbw, dt, ensemble, friction, temperature,
              generators, bias=None, shard=None):
    """The StepGraphs key of a captured batched step (graph_key's, with
    the batch size and every replica's generator held).  The neighbor
    cell grids enter through the batch's signature, kernel A's cells, the
    slab cap and the state cap through the System held (a regrow makes a
    new one): a regrown grid or cap is a new capture.  The shard enters
    held, so a batch under a shard never replays a capture made without
    one, nor one on another group."""
    return ("batch", bms.state.x.shape[0], ensemble, bms.state.x.dtype, dt,
            friction, temperature, graphs.Held(system),
            tuple(graphs.Held(g) for g in generators),
            graphs.signature(bms), tuple(cbw.shape), graphs.signature(bias),
            graphs.Held(shard))


def batched_md_scan(bms, system, cbw, dt, ensemble="NVE", n_steps=1,
                    friction=0.1, temperature=300.0, generators=None,
                    step_graphs=None, eager=False, bias=None, shard=None):
    """n_steps (<= MAX_CHUNK on the card) steps of every replica of the
    stacked batch `bms` (stack_states): (the batch after them,
    ChunkDiagnostics of (W, n_steps) fields).  On the card each step is a
    replay of the batched step captured once as a CUDA graph (md/
    graphs.py), every generator of `generators` (one a replica, NVT)
    registered with it; on the CPU, or eager, the same step runs without
    a graph.  No small tier (the replicas run one static cap, as the JAX
    package's vmapped ones do).  bias: the (W, ...)-stacked restraint of
    a ladder (parallel/umbrella.make_ladder), or None.  The result is
    valid only if diag.capacities() is empty (else regrow every replica
    and replay the chunk).  shard: every replica's step shared over the
    ranks of a process group (parallel/shard.py), each of its four
    collectives issued once a step for the whole batch; every rank of
    the group calls it with the same arguments and generator states.
    On the card a batch under a shard is the captured step or an error:
    it has no eager or in-turn fallback."""
    if ensemble not in ENSEMBLES:
        raise ValueError(f"ensemble {ensemble!r}: expected one of "
                         f"{', '.join(ENSEMBLES)}")
    W = bms.state.x.shape[0]
    if ensemble == "NVT" and (generators is None or len(generators) != W):
        raise ValueError(f"an NVT batch needs a generator for each of its "
                         f"{W} replicas")
    gens = tuple(generators) if ensemble == "NVT" else ()
    bias = bias_mod.as_tuple(bias)

    def body(m, w, b):
        return batched_scan_step(m, system, w, dt, ensemble, friction,
                                 temperature, gens, b, shard)

    if bms.state.x.is_cuda and not eager:
        if step_graphs is None:
            step_graphs = graphs.StepGraphs()
        key = batch_key(bms, system, cbw, dt, ensemble, friction,
                        temperature, gens, bias, shard)
        g = step_graphs.get(key, lambda: graphs.StepGraph(
            body, bms, cbw, gens, bias))
        out, rows = g.run(bms, cbw, n_steps, bias)
    else:
        out, rows = bms, []
        for _ in range(n_steps):
            out, row = body(out, cbw, bias)
            rows.append(row)
        rows = torch.stack(rows)
    out = dataclasses.replace(out, state=dataclasses.replace(
        out.state, step=bms.state.step + n_steps))
    return out, _diagnostics(rows, bms.state.x.dtype)
