"""Replica ensembles on one card (counterpart of the one-card half of
reactive_pb_nn_md_tpu/parallel/ensemble.py: stack_replicas, _no_tier,
make_replica_step, make_replica_scan).

The JAX package vmaps the step over a leading replica axis.  Here a batch
of W replicas is a list of W MDStates of one signature (the same shapes,
capacities and cell grids; the windows share their start state's
tensors, which no step writes into) and W noise-generator states, and a
chunk runs the replicas in turn: each replica's chunk is md_scan, on the
card the replays of the ONE step captured for the whole batch (md/
graphs.py), with ONE generator registered to that graph.  A replica's
generator state goes into it with set_state before its chunk and comes
back out with get_state after it, as Simulation._chunk restores the
generator before a replayed chunk.  Replica w's generator is seeded from
SeedSequence([seed, 2, w]) (Simulation's own stream is [seed, 1]), so
the streams are distinct.  Diagnostics come back as (W, n) fields, as the
JAX vmap returns them.

Replicas run one static cap with no small tier (_no_tier), as the JAX
package's do, so the trajectories are those of the JAX package at that
cap.  A capacity that does not hold in any replica is regrown for all of
them by Simulation's factors (integrators.grow_capacities); each replica
is then set up again from its chunk-start state (forces evaluated again
under its restraint), its generator state restored, and the chunk is
replayed, so no sample comes from truncated data (the JAX ladder only
reports the overflow).  A regrow is a new System and so one capture more;
otherwise a W-replica batch needs one capture.

The multi-device half (meshes, sharded replicas and atoms) is not here.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..md import bias as bias_mod
from ..md import graphs, integrators

# regrow rounds before a capacity that still overflows is an error
MAX_REGROWS = 16


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


def stack_replicas(ms, n_replicas, seed):
    """n_replicas copies of `ms` with distinct generator states."""
    dev = ms.state.x.device
    return ReplicaBatch(
        states=[ms] * n_replicas,
        generators=[generator_state(dev, replica_seed(seed, w))
                    for w in range(n_replicas)])


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
    (batch after them, ChunkDiagnostics of (W, n_steps) fields).

    system: its two-tier evaluation is turned off (_no_tier); `system`
    holds the current caps, and `caps` the neighbor capacities
    (capacity, cells, react_cap, react_cells), taken from the first
    batch, both regrown when a replica overflows (up to
    hard_max_states for the state cap, default the System's own cap).
    `regrows` keeps the regrow log lines (one or two a regrow),
    `n_regrows` counts the regrows, `step_graphs` keeps the captures (on
    the card).  eager: no graph on the card either (for
    comparisons)."""

    def __init__(self, system, cbw, dt, ensemble, n_steps, friction=0.1,
                 temperature=300.0, hard_max_states=None, eager=False):
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
        hold."""
        g = self.generator
        g.set_state(gen_state)
        diags, done = [], 0
        while done < self.n_steps:
            n = min(integrators.MAX_CHUNK, self.n_steps - done)
            ms, d = integrators.md_scan(
                ms, self.system, self.cbw, self.dt, self.ensemble, n,
                self.friction, self.temperature, generator=g,
                step_graphs=self.step_graphs, eager=self.eager, bias=bias)
            diags.append(d)
            done += n
            if bool(d.gs_failed.any()):
                raise integrators.GroundStateError(
                    "a replica's EVB ground state (kernel E) did not "
                    "converge")
            if d.capacities():
                break
        return ms, g.get_state(), _cat(diags, torch.cat)

    def _grow(self, names, states, biases):
        """Grow the capacities of `names` for every replica and set each of
        `states` up again under them: the new states."""
        if integrators.EVB_STATE_CAP in names \
                and self.system.evb_max_states >= self.hard_max_states:
            raise integrators.CapacityOverflow(
                f"a replica's diabat enumeration exceeded the state cap at "
                f"its ceiling {self.hard_max_states}")
        if self.n_regrows >= MAX_REGROWS:
            raise integrators.CapacityOverflow(
                f"{', '.join(names)} still exceeded after {MAX_REGROWS} "
                f"regrows")
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
            bias=bias)

    def __call__(self, batch, ladder=None):
        W = len(batch)
        biases = [window_bias(ladder, w) for w in range(W)]
        states, gens = list(batch.states), list(batch.generators)
        if self.caps is None:
            nl = states[0].nlist
            self.caps = (nl.capacity, nl.cells, nl.react_cap or None,
                         nl.react_cells or None)
        # the start states' own flags: a replica set up under a capacity
        # that did not hold has forces from truncated data
        names = integrators.overflow_names(
            torch.stack([m.overflow for m in states]).any(0))
        while names:
            states = self._grow(names, states, biases)
            names = integrators.overflow_names(
                torch.stack([m.overflow for m in states]).any(0))
        w = 0
        out, out_gens, diags = [], [], []
        while w < W:
            ms, gen, d = self._replica(states[w], gens[w], biases[w])
            names = d.capacities()
            if names:
                states = self._grow(names, states, biases)
                out, out_gens, diags, w = [], [], [], 0
                continue
            out.append(ms)
            out_gens.append(gen)
            diags.append(d)
            w += 1
        self.steps_done += self.n_steps
        return ReplicaBatch(out, out_gens), _cat(diags, torch.stack)


def make_replica_step(system, cbw, dt, ensemble, friction=0.1,
                      temperature=300.0, hard_max_states=None):
    """One step of every replica: scan(batch) -> (batch, diagnostics of
    (W, 1) fields)."""
    return ReplicaScan(system, cbw, dt, ensemble, 1, friction, temperature,
                       hard_max_states)


def make_replica_scan(system, cbw, dt, ensemble, n_steps, friction=0.1,
                      temperature=300.0, hard_max_states=None):
    """n_steps steps of every replica: scan(batch) -> (batch, diagnostics
    of (W, n_steps) fields)."""
    return ReplicaScan(system, cbw, dt, ensemble, n_steps, friction,
                       temperature, hard_max_states)
