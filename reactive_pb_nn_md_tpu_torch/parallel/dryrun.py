"""The multi-device check of the port (counterpart of dryrun_multichip in
the JAX package's __graft_entry__.py):

    python -m reactive_pb_nn_md_tpu_torch.parallel.dryrun --devices N \\
        [--device cpu] [--timeout S]

starts N ranks (parallel/mesh.launch: nccl on cuda:0 .. N-1, or gloo on
the CPU when asked), or, under torchrun --nproc-per-node N, runs as the
rank torchrun made.  On one fixture (12 H2O + 1 H3O+, 40 atoms, the
MS-EVB3 water deck of examples/water_msevb with a 12^3 PME grid, fp64):

  1. a (N/2 x 2) mesh ((1 x N) for odd N): one full reactive NVE step of
     2 dp replicas, each rank's block of 2 batched (one vmapped step)
     and shared over its atoms group, every potential finite; then 3 NVT
     steps of the same batch, whose replicas (one generator seed each)
     must differ pairwise; the positions of both runs held within
     1e-12 A against the one-rank batch on the same seeds and against
     the same block run in turn under the same shard (ReplicaScan), and
     the ranks of an atoms group against each other (bit for bit); the
     collectives of one batched step by name (each of the four once,
     whatever the block's size);
  2. an atoms-only (1 x N) mesh: two chained md_scan(2) chunks of the one
     replica shared over every rank, held against the unsharded loop
     with the JAX check's bounds (potential 1e-6 absolute; elec, vdw,
     bond, angle, dihedral 1e-8 relative; positions 1e-9 A), and the
     ranks' positions against each other; the collectives of one step
     by name and kind (parallel/shard.py).

Rank 0 prints one line a part and, last, one JSON object with the
numbers; the exit code is 0 when every check held.
"""

import argparse
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..io.ffpmt import read_ffpmt
from ..io.simpmt import read_sim_params
from ..io.topfile import read_top
from ..md import integrators, velocities
from ..models import pme
from ..ops import neighbors
from ..run.presets import water_box
from ..topology import State, build_system
from . import ensemble, mesh as mesh_mod
from .shard import STEP_COLLECTIVES

DECK = pathlib.Path(__file__).resolve().parents[2] / "examples" / \
    "water_msevb"
N_WATER, PME_GRID, N_SCAN = 12, 12, 2
# the JAX check's bounds (__graft_entry__.dryrun_multichip part 2)
POT_ATOL, TERM_RTOL, X_ATOL = 1e-6, 1e-8, 1e-9
# part 1: the mesh's replicas against the one-rank batch's and the
# in-turn block's
REPLICA_X_ATOL = 1e-12
# NVT steps of part 1
N_NVT = 3
TERMS = ("elec", "vdw", "bond", "angle", "dihedral")


def fixture(device, seed=0):
    """(system, cbw, cfg, ms) of the fixture on `device`, fp64: 300 K
    velocities from a CPU generator seeded with `seed`, the state set up
    unsharded."""
    cfg = read_sim_params(DECK / "sim.pmt")
    cfg.pme_grid, cfg.precision = PME_GRID, "fp64"
    frame = water_box(N_WATER, seed)
    system, topo = build_system(frame, read_ffpmt(DECK / "ff.pmt"),
                                read_top(DECK / "top.top"), cfg,
                                device=device)
    f = torch.float64
    gen = torch.Generator().manual_seed(seed)
    v = velocities.sample_velocities(gen, system.mass, 300.0,
                                     velocities.freeze_mask(system, topo))
    box = torch.as_tensor(frame.box, dtype=f, device=device)
    state = State(x=torch.as_tensor(frame.xyz, dtype=f, device=device), v=v,
                  box=box)
    cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt, dtype=f)
    cap = neighbors.suggest_capacity(
        system.n_atoms, float(np.prod(np.diag(frame.box))),
        system.verlet_cutoff)
    ms = integrators.initial_md_state(state, topo, system, cbw, cap)
    return system, cbw, cfg, ms


def _gather(t, group, n):
    """t from each of the n ranks of `group`, stacked in rank order."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def _block_dx(block, ref, first=0):
    """max |dx| of this rank's `block` against replicas first.. of the
    batch `ref`, the largest over every rank of the world."""
    dx = max(float((m.state.x - r.state.x).abs().max())
             for m, r in zip(block.states, ref.states[first:]))
    t = torch.tensor([dx], dtype=torch.float64, device=block.states[0].
                     state.x.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def part_replicas(mesh, system, cbw, cfg, ms):
    """Part 1 (the module docstring): its numbers, every replica's
    positions after the NVE step among them (nve_x, (W, N, 3) nested
    lists)."""
    W = 2 * mesh.dp
    first = mesh.replica_index * (W // mesh.dp)
    block = ensemble.stack_replicas(ms, W, seed=42, mesh=mesh)
    batch = ensemble.stack_replicas(ms, W, seed=42)
    shard = ensemble.atom_sharding(mesh) if mesh.sp > 1 else None
    runs = {}
    for ens, n, fr in (("NVE", 1, 0.1), ("NVT", N_NVT, 5.0)):
        args = (system, cbw, cfg.delta_t, ens, n)
        scan = ensemble.make_replica_scan(*args, friction=fr, mesh=mesh)
        out, diag = scan(block)
        # the one-rank batch on the same seeds, on every rank
        ref, _ = ensemble.make_replica_scan(*args, friction=fr)(batch)
        # this rank's block in turn under the same shard
        turn, _ = ensemble.ReplicaScan(*args, friction=fr, shard=shard)(
            block)
        runs[ens] = (out, diag, _block_dx(out, ref, first),
                     _block_dx(out, turn))
    # one batched step of the block, eager: its collectives
    bms = integrators.stack_states(block.states)
    colls = ensemble.collective_summary(lambda: integrators.batched_scan_step(
        bms, scan.system, cbw, cfg.delta_t, "NVE", 0.1, 300.0, (),
        shard=shard))
    pot = runs["NVE"][1].potential[:, 0]
    x = torch.stack([m.state.x for m in runs["NVT"][0].states])
    xs = _gather(x, mesh.replica_group, mesh.dp).reshape(W, -1)
    apart = min(float((xs[i] - xs[j]).abs().max())
                for i in range(W) for j in range(i))
    # the ranks of an atoms group hold one block: their copies, NVE and NVT
    copies = [_gather(torch.stack([m.state.x for m in runs[e][0].states]),
                      mesh.atoms_group, mesh.sp) for e in ("NVE", "NVT")]
    x = torch.stack([m.state.x for m in runs["NVE"][0].states])
    nve_x = _gather(x, mesh.replica_group, mesh.dp)
    return dict(mesh=mesh.shape, replicas=W, n_atoms=system.n_atoms,
                potential=pot.tolist(),
                finite=bool(torch.isfinite(pot).all()),
                nve_same=float((pot - pot[0]).abs().max()),
                nve_x_err=runs["NVE"][2], nvt_x_err=runs["NVT"][2],
                inturn_nve_x_err=runs["NVE"][3],
                inturn_nvt_x_err=runs["NVT"][3],
                ranks_x_spread=max(float((c - c[0]).abs().max())
                                   for c in copies),
                collectives=colls,
                nvt_min_pairwise_dx=apart,
                nve_x=nve_x.reshape(W, -1, 3).cpu().tolist())


def part_atoms(mesh, system, cbw, cfg, ms):
    """Part 2 (the module docstring): its numbers."""
    sscan = ensemble.make_atom_sharded_scan(system, cbw, cfg.delta_t, "NVE",
                                            mesh, N_SCAN)
    t0 = time.perf_counter()
    out, d1 = sscan(ms)
    out, d2 = sscan(out)
    sharded_s = time.perf_counter() - t0
    ref, r1 = integrators.md_scan(ms, system, cbw, cfg.delta_t, "NVE",
                                  N_SCAN)
    ref, r2 = integrators.md_scan(ref, system, cbw, cfg.delta_t, "NVE",
                                  N_SCAN)
    pots = torch.cat([d1.potential, d2.potential])
    rpots = torch.cat([r1.potential, r2.potential])
    terms = {k: (float(getattr(out.breakdown, k)),
                 float(getattr(ref.breakdown, k))) for k in TERMS}
    step = ensemble.make_atom_sharded_step(system, cbw, cfg.delta_t, "NVE",
                                           mesh)
    colls = ensemble.collective_summary(lambda: step(ms))
    x = out.state.x
    xr = _gather(x, mesh.atoms_group, mesh.sp)
    flags = sorted(set(d1.capacities()) | set(d2.capacities()))
    return dict(
        mesh=mesh.shape, n_atoms=system.n_atoms, n_scan=N_SCAN, chunks=2,
        potential=float(pots[-1]),
        match=float((pots - rpots).abs().max()),
        term_rel={k: abs(a - b) / max(1.0, abs(b))
                  for k, (a, b) in terms.items()},
        x_err=float((x - ref.state.x).abs().max()),
        x_same_bits=bool(torch.equal(x, ref.state.x)),
        ranks_x_spread=float((xr - xr[0]).abs().max()),
        finite=bool(torch.isfinite(pots).all()),
        collectives=colls, flags=flags,
        captures=(0 if sscan.step_graphs is None
                  else len(sscan.step_graphs.captures)),
        sharded_s=sharded_s)


def checks(p1, p2):
    """The failed checks of the two parts' numbers (empty: all held)."""
    bad = []
    if not p1["finite"]:
        bad.append("part 1: a non-finite potential")
    if p1["nvt_min_pairwise_dx"] <= 0.0:
        bad.append("part 1: two NVT replicas did not differ")
    for ens in ("nve", "nvt"):
        e = p1[f"{ens}_x_err"]
        if not e <= REPLICA_X_ATOL:
            bad.append(f"part 1: {ens.upper()} replicas on the mesh and "
                       f"on one rank differ by {e} A")
        e = p1[f"inturn_{ens}_x_err"]
        if not e <= REPLICA_X_ATOL:
            bad.append(f"part 1: the {ens.upper()} block batched and in "
                       f"turn differ by {e} A")
    if p1["ranks_x_spread"] != 0.0:
        bad.append(f"part 1: the ranks' copies of a block differ by "
                   f"{p1['ranks_x_spread']} A")
    # a block with no atoms group (sp = 1, an odd world) issues none
    want = STEP_COLLECTIVES if p1["mesh"]["atoms"] > 1 else {}
    if p1["collectives"]["by_name"] != want:
        bad.append(f"part 1: the collectives of one batched step are "
                   f"{p1['collectives']['by_name']}, not {want}")
    if not p2["finite"]:
        bad.append("part 2: a non-finite sharded potential")
    if p2["match"] > POT_ATOL:
        bad.append(f"part 2: sharded/unsharded potential {p2['match']}")
    for k, e in p2["term_rel"].items():
        if e > TERM_RTOL:
            bad.append(f"part 2: sharded/unsharded {k} {e}")
    if p2["x_err"] > X_ATOL:
        bad.append(f"part 2: sharded/unsharded positions {p2['x_err']}")
    if p2["collectives"]["by_name"] != STEP_COLLECTIVES:
        bad.append(f"part 2: the collectives of one step are "
                   f"{p2['collectives']['by_name']}")
    if p2["ranks_x_spread"] != 0.0:
        bad.append(f"part 2: the ranks' positions differ by "
                   f"{p2['ranks_x_spread']}")
    if p2["flags"]:
        bad.append(f"part 2: flags {p2['flags']}")
    return bad


def dryrun_rank(n_devices, device):
    """One rank of the check (every rank runs it): rank 0's
    (part 1, part 2, failed checks)."""
    t0 = time.perf_counter()
    mesh = ensemble.make_mesh(n_devices, sp=2 if n_devices % 2 == 0 else 1,
                              device=device)
    mesh_sp = ensemble.make_mesh(n_devices, sp=n_devices, device=device)
    system, cbw, cfg, ms = fixture(mesh.device)
    p1 = part_replicas(mesh, system, cbw, cfg, ms)
    p1["s"] = time.perf_counter() - t0
    rank0 = dist.get_rank() == 0
    if rank0:
        print(f"dryrun part 1 OK: mesh {p1['mesh']}, {p1['replicas']} "
              f"replicas x {p1['n_atoms']} atoms, potential[0]="
              f"{p1['potential'][0]:.6f}, NVT min pairwise max|dx| "
              f"{p1['nvt_min_pairwise_dx']:.3e} A, against one rank NVE "
              f"{p1['nve_x_err']:.2e} A, NVT {p1['nvt_x_err']:.2e} A, "
              f"batched against in turn NVE {p1['inturn_nve_x_err']:.2e} "
              f"A, NVT {p1['inturn_nvt_x_err']:.2e} A, ranks' copies "
              f"{p1['ranks_x_spread']:.2e} A, collectives of a batched "
              f"step {p1['collectives']['by_name']} [{p1['s']:.1f} s]",
              flush=True)
    p2 = part_atoms(mesh_sp, system, cbw, cfg, ms)
    p2["s"] = time.perf_counter() - t0
    if rank0:
        print(f"dryrun part 2 OK: mesh {p2['mesh']}, 1 replica x "
              f"{p2['n_atoms']} atoms sharded md_scan({N_SCAN}) x2 chunks, "
              f"potential={p2['potential']:.6f} (match {p2['match']:.2e}, "
              f"x {p2['x_err']:.2e} A), collectives={p2['collectives']} "
              f"[{p2['s']:.1f} s]", flush=True)
    return p1, p2, checks(p1, p2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="ranks (default: torchrun's world, else the "
                         "visible cards)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: no CUDA device (pass --device cpu for gloo ranks on "
              "the CPU)", file=sys.stderr)
        return 1
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        mesh_mod.init_from_env(a.device, timeout=a.timeout)
        n = dist.get_world_size()
        p1, p2, bad = dryrun_rank(n, a.device)
        dist.destroy_process_group()
        if int(os.environ["RANK"]):
            return 1 if bad else 0
    else:
        n = a.devices or torch.cuda.device_count()
        if a.device == "cuda":
            from ..ops.kernels import _build
            _build.library()      # built once here, not by every rank
        res = mesh_mod.launch(dryrun_rank, n, n, a.device, device=a.device,
                              timeout=a.timeout,
                              threads=1 if a.device == "cpu" else 0)
        p1, p2, bad = res[0]
    p1.pop("nve_x")       # the tests' reference positions, not a result
    print(json.dumps({"devices": n, "device": a.device, "part1": p1,
                      "part2": p2, "failed": bad}))
    for b in bad:
        print("dryrun FAILED: " + b, file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
