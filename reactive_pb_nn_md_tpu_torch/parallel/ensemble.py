"""Replica ensembles and their meshes (counterpart of
reactive_pb_nn_md_tpu/parallel/ensemble.py: make_mesh, stack_replicas,
replica_sharding, _no_tier, make_replica_step, make_replica_scan,
atom_sharding, make_atom_sharded_step, make_atom_sharded_scan,
collective_summary).

The JAX package vmaps the step over a leading replica axis, and so does
the port: a batch of W replicas is a list of W MDStates of one signature
(the same shapes, capacities and cell grids; the windows share their
start state's tensors, which no step writes into) and W noise-generator
states, and a chunk (BatchedReplicaScan, what make_replica_scan and
parallel/umbrella.make_ladder_scan return) stacks the MDStates on a
leading axis and runs md_scan on the stack: ONE step, md_step under
torch.func.vmap, advances all W (md/integrators.py batched_md_scan), on
the card the replays of that step captured once as a CUDA graph with
the W generators registered to it, each kernel launched once a step for
all W (their ops' batching rules).  Replica w's generator is seeded from
SeedSequence([seed, 2, w]) (Simulation's own stream is [seed, 1]), so
the streams are distinct, and its draws are those of its own generator
alone.  Diagnostics come back as (W, n) fields, as the JAX vmap returns
them.  ReplicaScan runs the same chunk with the replicas in turn (each
replica's md_scan, one capture for all, its generator state swapped in
and out): the reference the batch is held against, and nothing else.

Replicas run one static cap with no small tier (_no_tier), as the JAX
package's do, so the trajectories are those of the JAX package at that
cap.  A capacity that does not hold in any replica is regrown for all of
them by Simulation's factors (integrators.grow_capacities); each replica
is then set up again from its chunk-start state (forces evaluated again
under its restraint), its generator state restored, and the chunk is
replayed, so no sample comes from truncated data (the JAX ladder only
reports the overflow).  A regrow is a new System and so one capture more;
otherwise a W-replica batch needs one capture.  A batch runs any path
of one replica's step: the flagship's (dense neighbors, kernel A, the
per-atom PME spread) and the cell path of the 10,000-atom box (cell-list
neighbors with each replica's own rebuild and on-demand rows, the domain
repulsion, kernels A' / A'', the slab spread D1 / D2); a regrow of the
cell capacities, kernel A's cells or the slab cap is made for all and
the chunk replayed, as any other.  A batch under a shard (shard=, an
AtomShard of parallel/shard.py) runs the same vmapped step shared over
the ranks of the shard's group, each of the step's four collectives
issued once for the whole batch.

Over several ranks (parallel/mesh.py, a dp x sp mesh):

  * replicas over the "replica" axis (MeshReplicaScan): rank block d of
    dp holds the contiguous replicas d W/dp .. (d+1) W/dp - 1 (W must
    divide by dp) and runs them through its own captured step on its own
    device.  Replica w's generator is seeded from replica_seed(seed, w)
    whatever rank holds it, so a W-replica run gives the same
    trajectories on any number of ranks.  The capacity flags of a chunk
    (and kernel E's failure) are OR-ed over the replica group before any
    rank decides, so every rank regrows to the same caps and replays
    together (a decision from one rank's own flags could leave one rank
    capturing while another replays, a hang under NCCL); the
    diagnostics come back as (W, n) fields in replica order, gathered
    from every rank.  States stay with their ranks;
  * one replica's step over the "atoms" axis (atom_sharding, make_atom_
    sharded_step / _scan): parallel/shard.py.  On a dp x sp mesh with
    sp > 1 each block runs batched under its atoms group's shard: one
    vmapped step advances the block's replicas, each rank computing its
    share for all of them (the JAX replica_sharding, a batch sharded
    over both axes).  The ranks of an atoms group hold the same
    replicas and generator states (stack_replicas with the mesh), so
    they draw the same noise and take the same step.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..md import bias as bias_mod
from ..md import graphs, integrators
# the JAX module's names
from .mesh import make_mesh  # noqa: F401
from .shard import collective_summary  # noqa: F401


@dataclass
class ReplicaBatch:
    """W replicas: their MDStates (one signature) and the states of their
    noise generators (torch.Generator.get_state() of a generator on the
    replicas' device)."""
    states: list
    generators: list

    def __len__(self):
        return len(self.states)


def replica_seed(seed, w):
    """The noise generator seed of replica w."""
    return int(np.random.SeedSequence([seed, 2, w]).generate_state(1)[0])


def generator_state(device, seed):
    """The state of a generator on `device` seeded with `seed`."""
    return torch.Generator(device=device).manual_seed(seed).get_state()


def replica_sharding(mesh, n_replicas):
    """The range of the replicas this rank's block of `mesh` holds (W must
    divide by the "replica" axis)."""
    if n_replicas % mesh.dp:
        raise ValueError(f"{n_replicas} replicas do not divide over the "
                         f"{mesh.dp} ranks of the replica axis")
    per = n_replicas // mesh.dp
    return range(mesh.replica_index * per, (mesh.replica_index + 1) * per)


def stack_replicas(ms, n_replicas, seed, mesh=None):
    """n_replicas copies of `ms` with distinct generator states; with a
    mesh, this rank's block of them (replica_sharding), replica w's
    generator seeded as on one rank."""
    dev = ms.state.x.device
    block = (range(n_replicas) if mesh is None
             else replica_sharding(mesh, n_replicas))
    return ReplicaBatch(
        states=[ms] * len(block),
        generators=[generator_state(dev, replica_seed(seed, w))
                    for w in block])


def _no_tier(system):
    """Replicas run one static cap: the JAX package disables the two-tier
    state evaluation under vmap, where its lax.cond would run both
    branches for every replica; with it off here too, the replicas'
    trajectories are the JAX package's at the same cap."""
    return system.replace(evb_small_states=0)


def window_bias(ladder, w):
    """Window w's restraint(s) of a ladder (parallel/umbrella.make_ladder:
    a HarmonicBias of (W, 3) atoms and (W,) k / center, or a tuple of
    them); None for None."""
    if ladder is None:
        return None
    if isinstance(ladder, tuple):
        return tuple(window_bias(b, w) for b in ladder)
    return bias_mod.HarmonicBias(atoms=ladder.atoms[w], k=ladder.k[w],
                                 center=ladder.center[w],
                                 cv_type=ladder.cv_type)


def _cat(diags, op):
    """ChunkDiagnostics whose fields are op(list of the fields of
    `diags`)."""
    return integrators.ChunkDiagnostics(**{
        f.name: op([getattr(d, f.name) for d in diags])
        for f in dataclasses.fields(integrators.ChunkDiagnostics)})


class ReplicaScan:
    """n_steps steps of every replica of a batch: scan(batch[, ladder]) ->
    (batch after them, ChunkDiagnostics of (W, n_steps) fields), the
    replicas in turn (the reference BatchedReplicaScan is held against,
    with a shard too).

    system: its two-tier evaluation is turned off (_no_tier); `system`
    holds the current caps, and `caps` the neighbor capacities
    (capacity, cells, react_cap, react_cells), taken from the first
    batch, both regrown when a replica overflows (up to
    hard_max_states for the state cap, default the System's own cap).
    `regrows` keeps the regrow log lines (one or two a regrow),
    `n_regrows` counts the regrows, `step_graphs` keeps the captures (on
    the card).  eager: no graph on the card either (for
    comparisons).  shard: every replica's step shared over ranks
    (parallel/shard.py)."""

    def __init__(self, system, cbw, dt, ensemble, n_steps, friction=0.1,
                 temperature=300.0, hard_max_states=None, eager=False,
                 shard=None):
        if ensemble not in integrators.ENSEMBLES:
            raise ValueError(f"ensemble {ensemble!r}: expected one of "
                             f"{', '.join(integrators.ENSEMBLES)}")
        self.system = _no_tier(system)
        self.cbw, self.dt, self.ensemble = cbw, dt, ensemble
        self.n_steps, self.friction = n_steps, friction
        self.temperature = temperature
        self.hard_max_states = (system.evb_max_states
                                if hard_max_states is None
                                else hard_max_states)
        self.eager = eager
        self.shard = shard
        self.caps = None
        self.regrows = []
        self.n_regrows = 0
        dev = cbw.device
        self.generator = torch.Generator(device=dev)
        self.step_graphs = (graphs.StepGraphs() if dev.type == "cuda"
                            else None)
        self.steps_done = 0

    def _replica(self, ms, gen_state, bias):
        """n_steps steps of one replica from (ms, gen_state), in chunks of
        at most MAX_CHUNK: (MDState, generator state, diagnostics); the
        run stops after the first chunk with a capacity that did not
        hold or a failed kernel E."""
        g = self.generator
        g.set_state(gen_state)
        diags, done = [], 0
        while done < self.n_steps:
            n = min(integrators.MAX_CHUNK, self.n_steps - done)
            ms, d = integrators.md_scan(
                ms, self.system, self.cbw, self.dt, self.ensemble, n,
                self.friction, self.temperature, generator=g,
                step_graphs=self.step_graphs, eager=self.eager, bias=bias,
                shard=self.shard)
            diags.append(d)
            done += n
            if bool(d.gs_failed.any()) or d.capacities():
                break
        return ms, g.get_state(), _cat(diags, torch.cat)

    def _reduce(self, flags):
        """The (len(CAPACITIES) + 1,) bool flags of this rank's replicas
        (the capacities, then kernel E's failure) as every rank that takes
        the decision with it sees them: here they are."""
        return flags

    def _gather(self, diag):
        """The (W, n) diagnostics of all replicas from this rank's."""
        return diag

    def _decide(self, flags):
        """The capacities to regrow by the reduced `flags`; raises when
        kernel E failed in a replica."""
        flags = self._reduce(flags)
        if bool(flags[-1]):
            raise integrators.GroundStateError(
                "a replica's EVB ground state (kernel E) did not converge")
        return integrators.overflow_names(flags[:-1])

    def _grow(self, names, states, biases):
        """Grow the capacities of `names` for every replica and set each of
        `states` up again under them: the new states."""
        if integrators.EVB_STATE_CAP in names \
                and self.system.evb_max_states >= self.hard_max_states:
            raise integrators.CapacityOverflow(
                f"a replica's diabat enumeration exceeded the state cap at "
                f"its ceiling {self.hard_max_states}")
        if self.n_regrows >= integrators.MAX_REGROWS:
            raise integrators.CapacityOverflow(
                f"{', '.join(names)} still exceeded after "
                f"{integrators.MAX_REGROWS} regrows")
        self.n_regrows += 1
        self.system, self.caps, lines = integrators.grow_capacities(
            names, self.system, *self.caps, self.hard_max_states,
            self.steps_done, "chunk replayed")
        self.regrows.extend(lines)
        return [self._settle(ms, b) for ms, b in zip(states, biases)]

    def _settle(self, ms, bias):
        """`ms` set up again (initial_md_state) under the current caps and
        the restraint `bias`, the Kahan carries kept."""
        capacity, cells, react_cap, react_cells = self.caps
        return integrators.initial_md_state(
            ms.state, ms.topo, self.system, self.cbw, capacity, cells,
            react_cap=react_cap, react_cells=react_cells, comp=ms.comp,
            bias=bias, shard=self.shard)

    def _chunk(self, states, gens, biases, ladder, first):
        """The chunk of every replica, in turn: (MDStates, generator
        states, (W, n) diagnostics, the (len(CAPACITIES) + 1,) flags of
        the first replica whose capacities did not hold or whose kernel E
        failed, the rest not run then)."""
        out, out_gens, diags = [], [], []
        flags = torch.zeros(len(integrators.CAPACITIES) + 1,
                            dtype=torch.bool)
        for w in range(len(states)):
            ms, gen, d = self._replica(states[w], gens[w], biases[w])
            flags = _flags(d)
            if flags.any():
                break
            out.append(ms)
            out_gens.append(gen)
            diags.append(d)
        return out, out_gens, diags and _cat(diags, torch.stack), flags

    def __call__(self, batch, ladder=None, first=0):
        """The chunk of every replica of `batch`; `first` the index in the
        whole ensemble of its replica 0 (its window of `ladder`)."""
        W = len(batch)
        biases = [window_bias(ladder, first + w) for w in range(W)]
        states, gens = list(batch.states), list(batch.generators)
        if self.caps is None:
            self.caps = integrators.capacities_of(states[0])

        def start_flags():
            # a replica set up under a capacity that did not hold has
            # forces from truncated data
            f = torch.stack([m.overflow for m in states]).any(0).cpu()
            return torch.cat([f, torch.zeros(1, dtype=torch.bool)])

        names = self._decide(start_flags())
        while names:
            states = self._grow(names, states, biases)
            names = self._decide(start_flags())
        while True:
            out, out_gens, diag, flags = self._chunk(states, gens, biases,
                                                     ladder, first)
            names = self._decide(flags)
            if not names:
                break
            states = self._grow(names, states, biases)
        self.steps_done += self.n_steps
        return ReplicaBatch(out, out_gens), self._gather(diag)


def _flags(d):
    """The (len(CAPACITIES) + 1,) bool flags of diagnostics `d` (any step,
    any replica): the capacities that did not hold, then kernel E's
    failure."""
    return torch.tensor([bool(getattr(d, f).any())
                         for f in integrators.CAPACITY_FIELDS]
                        + [bool(d.gs_failed.any())])


def window_slice(ladder, first, n):
    """Windows first .. first + n - 1 of a ladder (None for None)."""
    if ladder is None:
        return None
    if isinstance(ladder, tuple):
        return tuple(window_slice(b, first, n) for b in ladder)
    return bias_mod.HarmonicBias(atoms=ladder.atoms[first:first + n],
                                 k=ladder.k[first:first + n],
                                 center=ladder.center[first:first + n],
                                 cv_type=ladder.cv_type)


class BatchedReplicaScan(ReplicaScan):
    """A ReplicaScan whose chunk advances all W replicas together: the
    replicas stacked on a leading axis (integrators.stack_states) through
    ONE step vmapped over them (integrators.batched_md_scan; on the card
    one capture for the batch, each kernel one launch a step for all W,
    W generators registered with the graph).  The counterpart of the JAX
    package's jax.vmap(md_scan).  Same results as the in-turn ReplicaScan
    (the reference it is held against), same capacity handling: flags
    OR-ed over the replicas, a regrow for all, the chunk replayed.  With
    a shard the batch's step is shared over the shard's group (each
    collective once a step for the whole batch), and so is the set-up
    after a regrow."""

    def __init__(self, system, cbw, dt, ensemble, n_steps, friction=0.1,
                 temperature=300.0, hard_max_states=None, eager=False,
                 shard=None):
        super().__init__(system, cbw, dt, ensemble, n_steps, friction,
                         temperature, hard_max_states, eager, shard)
        # one noise generator a replica, kept so that the captured step
        # (whose key holds them) is replayed, not captured again
        self.generators = []

    def _chunk(self, states, gens, biases, ladder, first):
        W = len(states)
        dev = self.cbw.device
        if len(self.generators) != W:
            self.generators = [torch.Generator(device=dev) for _ in range(W)]
        for g, st in zip(self.generators, gens):
            g.set_state(st)
        bias = window_slice(ladder, first, W)
        bms = integrators.stack_states(states)
        diags, done = [], 0
        flags = torch.zeros(len(integrators.CAPACITIES) + 1,
                            dtype=torch.bool)
        while done < self.n_steps and not flags.any():
            n = min(integrators.MAX_CHUNK, self.n_steps - done)
            bms, d = integrators.md_scan(
                bms, self.system, self.cbw, self.dt, self.ensemble, n,
                self.friction, self.temperature, generator=self.generators,
                step_graphs=self.step_graphs, eager=self.eager, bias=bias,
                shard=self.shard)
            diags.append(d)
            done += n
            flags = _flags(d)
        return (integrators.unstack_states(bms),
                [g.get_state() for g in self.generators],
                _cat(diags, lambda fs: torch.cat(fs, dim=1)), flags)


class MeshReplicaScan(BatchedReplicaScan):
    """A replica scan over the "replica" axis of a mesh (parallel/mesh.py):
    scan(block[, ladder]) -> (this rank's block after the chunk,
    ChunkDiagnostics of (W, n_steps) fields of all replicas in replica
    order).  `block` is this rank's replicas (stack_replicas(..., mesh));
    every rank of the world calls it together.  The regrow decision is
    taken from flags OR-ed over the replica group (and, inside the step,
    over the atoms group), so every rank grows to the same caps and
    replays.  A rank's block runs batched (BatchedReplicaScan) on every
    mesh: with sp > 1 its step is shared over the rank's atoms group."""

    def __init__(self, mesh, system, cbw, dt, ensemble, n_steps,
                 friction=0.1, temperature=300.0, hard_max_states=None,
                 eager=False):
        super().__init__(system, cbw, dt, ensemble, n_steps, friction,
                         temperature, hard_max_states, eager,
                         shard=atom_sharding(mesh) if mesh.sp > 1 else None)
        self.mesh = mesh

    def _reduce(self, flags):
        v = flags.to(torch.int32).to(self.mesh.device)
        dist.all_reduce(v, op=dist.ReduceOp.MAX,
                        group=self.mesh.replica_group)
        return (v != 0).cpu()

    def _gather(self, diag):
        fields = [f.name for f in dataclasses.fields(diag)]
        local = torch.stack([getattr(diag, f).to(torch.float64)
                             for f in fields], -1)      # (W_b, n, F)
        parts = [torch.empty_like(local, device=self.mesh.device)
                 for _ in range(self.mesh.dp)]
        dist.all_gather(parts, local.to(self.mesh.device),
                        group=self.mesh.replica_group)
        full = torch.cat(parts).cpu()
        return integrators.ChunkDiagnostics(**{
            f: full[..., i].to(getattr(diag, f).dtype)
            for i, f in enumerate(fields)})

    def __call__(self, block, ladder=None):
        per = len(block)
        return super().__call__(block, ladder,
                                first=self.mesh.replica_index * per)


def make_replica_step(system, cbw, dt, ensemble, friction=0.1,
                      temperature=300.0, hard_max_states=None, mesh=None):
    """One step of every replica: scan(batch) -> (batch, diagnostics of
    (W, 1) fields), batched; with a mesh, over its ranks
    (MeshReplicaScan)."""
    return make_replica_scan(system, cbw, dt, ensemble, 1, friction,
                             temperature, hard_max_states, mesh)


def make_replica_scan(system, cbw, dt, ensemble, n_steps, friction=0.1,
                      temperature=300.0, hard_max_states=None, mesh=None):
    """n_steps steps of every replica: scan(batch) -> (batch, diagnostics
    of (W, n_steps) fields), batched (BatchedReplicaScan); with a mesh,
    over its ranks (MeshReplicaScan)."""
    if mesh is not None:
        return MeshReplicaScan(mesh, system, cbw, dt, ensemble, n_steps,
                               friction, temperature, hard_max_states)
    return BatchedReplicaScan(system, cbw, dt, ensemble, n_steps, friction,
                              temperature, hard_max_states)


def atom_sharding(mesh):
    """This rank's AtomShard on the mesh's "atoms" axis (parallel/
    shard.py): what the JAX package's shardings of one MDState are to its
    step."""
    return mesh.atom_shard()


def make_atom_sharded_step(system, cbw, dt, ensemble, mesh, friction=0.1,
                           temperature=300.0):
    """One step of one replica shared over the mesh's "atoms" axis:
    step(ms, noise=None) -> MDState, the same on every rank of the
    group (md_step with the shard; under NVT every rank passes the same
    draws)."""
    shard = atom_sharding(mesh)

    def step(ms, noise=None):
        return integrators.md_step(ms, system, cbw, dt, ensemble, friction,
                                   temperature, noise=noise, shard=shard)

    return step


def make_atom_sharded_scan(system, cbw, dt, ensemble, mesh, n_steps,
                           friction=0.1, temperature=300.0):
    """The chunked production loop of one replica shared over the mesh's
    "atoms" axis: scan(ms, generator=None) -> (MDState, ChunkDiagnostics),
    md_scan with the shard; on the card the replays of one captured step
    that holds its collectives (its captures kept in scan.step_graphs).
    The state stays replicated between chunks (parallel/shard.py)."""
    shard = atom_sharding(mesh)
    step_graphs = graphs.StepGraphs() if mesh.device.type == "cuda" \
        else None

    def scan(ms, generator=None):
        return integrators.md_scan(ms, system, cbw, dt, ensemble, n_steps,
                                   friction, temperature, generator,
                                   step_graphs=step_graphs, shard=shard)

    scan.step_graphs = step_graphs
    return scan

