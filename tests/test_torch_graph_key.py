"""The key under which md_scan keeps a captured step (md/graphs.py
StepGraphs, md/integrators.py graph_key), on the CPU: a chain of kernel A
cap regrows, each dropping the System before it, must never be handed a
graph captured for another System.  Kernel A's cell cap lives only in the
System, so the MDState's signature in the key cannot tell two caps apart;
a key of id(system) could, once the old System was freed and a new one
took its address."""

import dataclasses
import gc
import weakref

import torch

from reactive_pb_nn_md_tpu_torch.md import graphs, integrators
from reactive_pb_nn_md_tpu_torch.topology import System


@dataclasses.dataclass
class _State:
    x: torch.Tensor


@dataclasses.dataclass
class _MDState:
    state: _State


class _Captured:
    """A stand-in for graphs.StepGraph: the kernel A cells it was captured
    at."""

    capture_s = 0.0
    pool_bytes = 0

    def __init__(self, rs_cells):
        self.rs_cells = rs_cells


def _key(ms, system, cbw, gen):
    return integrators.graph_key(ms, system, cbw, 0.0005, "NVT", 1.0, 300.0,
                                 gen, "full")


def test_regrown_system_never_gets_another_systems_graph():
    ms = _MDState(_State(torch.zeros(6, 3, dtype=torch.float64)))
    cbw = torch.zeros(4, 4, 3, dtype=torch.float64)
    gen = torch.Generator()
    sg = graphs.StepGraphs()
    system = System(ff=None, mt=None, evb=None, mass=torch.ones(6),
                    device=torch.device("cpu"), rs_cells=(4, 4, 4, 8))
    first = weakref.ref(system)
    n_systems = 12
    for _ in range(n_systems):
        # md/simulation.py _grow's kernel A cap regrow
        n1, n2, n3, cap = system.rs_cells
        new = system.replace(
            rs_cells=(n1, n2, n3, -(-int(cap * 1.3 + 8) // 8) * 8))
        g = sg.get(_key(ms, new, cbw, gen), lambda: _Captured(new.rs_cells))
        assert g.rs_cells == new.rs_cells
        # the old System dropped, as Simulation drops it
        system = new
    # every System was captured anew, and the same System finds its own
    assert len(sg.captures) == n_systems
    assert sg.get(_key(ms, system, cbw, gen), lambda: None) is not None
    assert len(sg.captures) == n_systems
    # at most KEEP Systems are held: a dropped key releases its System
    gc.collect()
    assert first() is None
    held = [k for key in sg.graphs for k in key
            if isinstance(k, graphs.Held) and isinstance(k.obj, System)]
    assert len(held) == graphs.KEEP


def test_held_compares_by_identity():
    a = torch.Generator()
    assert graphs.Held(a) == graphs.Held(a)
    assert graphs.Held(a) != graphs.Held(torch.Generator())
    assert graphs.Held(None) == graphs.Held(None)
    assert len({graphs.Held(a), graphs.Held(a)}) == 1
