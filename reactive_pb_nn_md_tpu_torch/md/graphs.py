"""The MD step as one CUDA graph (the counterpart, on the card, of the JAX
package's jitted lax.scan body in md/integrators.py md_scan).

A StepGraph captures one step on static buffers: `body(ms, cbw, bias)`
reads the MDState `ms`, the PME weights `cbw` and the umbrella restraint
`bias` (md/bias.py, a tuple of HarmonicBias, or None), returns the next
MDState and the step's diagnostics row, and the captured program copies
the next state back into the buffers it read, in place, and the row into
slot k of the chunk's row buffer, k a device counter.  A chunk is then:
the start state copied into the buffers, k set to 0, n replays, one host
read of the n rows.  Nothing inside a chunk synchronizes with the host.

Hazards of static buffers: a graph reads fixed addresses, so everything
the step reads is updated in place, never rebound: positions, velocities,
box, cbw (copied in at every chunk start, so a barostat move or a
restart reaches the next chunk), the restraint's atoms, k and center
(copied in at every chunk start, so one capture serves every window of a
ladder: parallel/ensemble.py), the principle Topology (a hop changes
it), the NeighborList, forces and the Kahan carries (copied back after
every step).  What the step reads outside the MDState and cbw (the
System's tables) is read at the addresses it had at the capture: a
StepGraphs key holds the System and the generator themselves (`Held`,
equal only to the same object), so while a graph is kept its System
stays alive, no other object can take its id, and another System is
captured anew.

Launch counts: a replay runs the kernels without calling their wrappers,
so the counts that the capture added to ops.kernels._build.launches are
taken back off and added again at every replay; so are the collectives
of a step shared over ranks (_build.collectives, counted by parallel/
shard.py), which the graph holds as it holds the kernels.
"""

import dataclasses
import time
from collections import Counter, OrderedDict

import torch

from ..ops.kernels import _build

# steps a chunk holds (rows of a StepGraph; one host read a chunk)
MAX_CHUNK = 128
# captured steps a StepGraphs keeps
KEEP = 4


def leaves(obj):
    """The tensors of a (nested) dataclass or tuple, in field order; None
    and non-tensor fields are skipped."""
    out = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif dataclasses.is_dataclass(o):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
        elif type(o) is tuple:
            for v in o:
                walk(v)

    walk(obj)
    return out


def with_leaves(obj, tensors):
    """A copy of `obj` whose tensors are taken, in leaves() order, from
    the iterator `tensors`."""
    if isinstance(obj, torch.Tensor):
        return next(tensors)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: with_leaves(getattr(obj, f.name), tensors)
            for f in dataclasses.fields(obj) if f.init})
    if type(obj) is tuple:
        return tuple(with_leaves(v, tensors) for v in obj)
    return obj


class Held:
    """An object in a graph key: equal only to that same object, and kept
    alive for as long as the key is (a key of bare id()s could match an
    object made later at a freed one's address)."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __eq__(self, other):
        return isinstance(other, Held) and other.obj is self.obj

    def __hash__(self):
        return id(self.obj)


def signature(obj):
    """Every non-tensor field and every tensor's shape and dtype, in
    leaves() order, for the graph key: equal signatures fit one set of
    static buffers."""
    if isinstance(obj, torch.Tensor):
        return (tuple(obj.shape), obj.dtype, obj.device)
    if dataclasses.is_dataclass(obj):
        return tuple((f.name, signature(getattr(obj, f.name)))
                     for f in dataclasses.fields(obj) if f.name != "step")
    if type(obj) is tuple:
        return tuple(signature(v) for v in obj)
    return obj


class StepGraph:
    """One captured step (see the module docstring).  `generator`, when
    the step draws from one (or a sequence of them, one a replica of a
    batched step), is registered with the graph, so replays advance it
    as eager draws would.  `bias`, the restraint of the
    capture (None: unbiased), gives the structure of the restraint
    buffers; run() copies each chunk's values in.  A chunk is at most
    MAX_CHUNK steps."""

    def __init__(self, body, ms, cbw, generator=None, bias=None):
        dev = cbw.device
        self.ms = with_leaves(ms, (t.clone() for t in leaves(ms)))
        self.cbw = cbw.clone()
        self.bias = with_leaves(bias, (t.clone() for t in leaves(bias)))
        self.k = torch.zeros(1, dtype=torch.int64, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        gens = (() if generator is None else tuple(generator)
                if isinstance(generator, (tuple, list)) else (generator,))
        for g in gens:
            self.graph.register_generator_state(g)
        start = [g.get_state() for g in gens]
        # warm-up on a side stream: the kernels are built, the cuFFT plans
        # made and autograd has run once before the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _, row = body(self.ms, self.cbw, self.bias)
        torch.cuda.current_stream(dev).wait_stream(side)
        for g, st in zip(gens, start):
            g.set_state(st)
        self.rows = torch.zeros((MAX_CHUNK,) + tuple(row.shape),
                                dtype=row.dtype, device=dev)
        before = Counter(_build.launches)
        before_coll = Counter(_build.collectives)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            out, row = body(self.ms, self.cbw, self.bias)
            dst, src = leaves(self.ms), leaves(out)
            if [(t.shape, t.dtype) for t in dst] != \
                    [(t.shape, t.dtype) for t in src]:
                raise ValueError("the step's result does not have its "
                                 "input's structure")
            # a result that shares memory with an input it is not would be
            # overwritten by an earlier copy: take it apart first
            held = {t.untyped_storage().data_ptr() for t in dst}
            src = [s if s is d or s.untyped_storage().data_ptr() not in held
                   else s.clone() for d, s in zip(dst, src)]
            for d, s in zip(dst, src):
                if s is not d:
                    d.copy_(s)
            self.rows.index_copy_(0, self.k, row[None])
            self.k.add_(1)
        torch.cuda.synchronize(dev)
        # host seconds of the capture; the card's memory in the graph's
        # private pool
        self.capture_s = time.perf_counter() - t0
        pool = self.graph.pool()
        self.pool_bytes = sum(seg["total_size"]
                              for seg in torch.cuda.memory_snapshot()
                              if seg["segment_pool_id"] == pool)
        self.launches = Counter(_build.launches) - before
        _build.launches -= self.launches
        self.collectives = Counter(_build.collectives) - before_coll
        _build.collectives -= self.collectives

    def run(self, ms, cbw, n, bias=None):
        """n steps from `ms` under the restraint `bias` (the capture's
        structure): (the MDState after them, its tensors fresh copies;
        the (n, D) rows on the card, (n, W, D) for a batched step)."""
        if n > self.rows.shape[0]:
            raise ValueError(f"{n} steps: a chunk holds at most "
                             f"{self.rows.shape[0]}")
        for d, s in zip(leaves(self.ms), leaves(ms)):
            d.copy_(s)
        self.cbw.copy_(cbw)
        for d, s in zip(leaves(self.bias), leaves(bias), strict=True):
            d.copy_(s)
        self.k.zero_()
        for _ in range(n):
            self.graph.replay()
        for name, c in self.launches.items():
            _build.launches[name] += c * n
        for name, c in self.collectives.items():
            _build.collectives[name] += c * n
        out = with_leaves(self.ms, (t.clone() for t in leaves(self.ms)))
        return out, self.rows[:n]


class StepGraphs:
    """The captured steps of a run, by key (integrators.graph_key: the
    ensemble, dtype, tier and step parameters, the System and the
    generator held, the MDState's signature with every capacity and cell
    grid that lives there): a key changes after a regrow, a grid refit
    or a tier switch, and its step is captured then.  At most KEEP
    graphs are kept, the least recently used dropped first; a dropped
    key releases its System."""

    def __init__(self):
        self.graphs = OrderedDict()
        self.captures = []       # (key, capture s, pool bytes) of each

    def get(self, key, make):
        g = self.graphs.pop(key, None)
        if g is None:
            g = make()
            self.captures.append((key, g.capture_s, g.pool_bytes))
        self.graphs[key] = g
        while len(self.graphs) > KEEP:
            self.graphs.popitem(last=False)
        return g
