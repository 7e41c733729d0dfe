#!/usr/bin/env python3
"""Time the port's two multi-card shapes against one card, in one call:

    python3 tools/time_multichip.py [--cards 4] [--out DIR]

  1. replicas over cards: bench.py run_bench_replicas' ensemble (chip_smoke
     phase 10d's cell: 16 NVT replicas of examples/water_msevb/in.gro,
     fp32, state cap 48 with no small tier, friction 0.1 / ps, 300 K),
     40 steps a chunk, first on one card (one batch of 16), then over
     --cards ranks as a (cards x 1) mesh (MeshReplicaScan, a batch of
     16 / cards replicas a rank), then, for an even number of cards, as a
     (cards / 2 x 2) mesh (a batch of 32 / cards replicas a rank pair,
     its step shared over the pair: a batch under a shard).  Each prints
     the first chunk's rate (its captures included) and a second chunk's
     (steady), replica-steps/s: 16 x 40 / the slowest rank's wall
     seconds; the (x 2) mesh also the largest |dx| between the two
     ranks' copies of their block (0: the ranks stay together);
  2. one box over cards: the 10,000-atom lattice of examples/water_10k/
     (fp32, the CLI's seeded velocities, the PME slab cap set to
     SCAP_10K: the melting lattice outgrows the deck's 280 at step 31,
     and a chunk from truncated data would time nothing real), 2 x
     STEPS_10K graphed NVE steps
     shared over --cards ranks (make_atom_sharded_scan), then the same
     steps unsharded on rank 0's card while the others wait: the ms a
     step of each (the second of two chunks, so captures are not
     counted), max |dx| between the two, and the collectives of a step.

Exits 1, naming the failure, when a capacity flag stands after a chunk
of either shape (the chunk then ran on truncated data), when the two
ranks of a (x 2) mesh's pair part (ranks_dx not 0), or when the 10k
positions differ by more than DX_10K_FP32.

The ranks are nccl on cuda:0 .. cards - 1 (parallel/mesh.launch).  Prints
one JSON line per shape, nvidia-smi's name and power limit, and writes
multichip.json to --out (default chiprun_out/).
"""

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import NVT_DECK, SCAP_10K, deck_copy  # noqa: E402

REPLICAS, REPLICA_STEPS, REPLICA_CAP = 16, 40, 48
STEPS_10K = 20
# the bound on max |dx| between the 10k lattice's sharded and one-card
# positions after 2 x STEPS_10K fp32 steps.  fp32 rounding alone left
# 2.67e-05 A (four H100 80GB HBM3 at 700 W); a share of a term lost or
# counted twice is a force error of 1 kJ/mol/A or more, which moves a
# hydrogen (1 kJ/mol/A/amu = 100 A/ps^2) ~0.08 A in those 40 fs
DX_10K_FP32 = 1e-3


def replica_sim(tmp):
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    return Simulation(*deck_copy(
        pathlib.Path(tmp), ROOT / "examples" / "water_msevb", "fp32",
        f"evb_max_states     {REPLICA_CAP}\n" + NVT_DECK), device="cuda")


def _chunks(scan, block, sync):
    """Two chunks of `scan` from `block`: (wall s of each, the block and
    diagnostics after the second)."""
    import torch
    walls = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        block, diag = scan(block)
        torch.cuda.synchronize()
        sync()
        walls.append(time.perf_counter() - t0)
    return walls, block, diag


def replicas_one_card():
    import torch
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    with tempfile.TemporaryDirectory() as tmp:
        sim = replica_sim(tmp)
        batch = ensemble.stack_replicas(sim.ms, REPLICAS, seed=7)
        scan = ensemble.make_replica_scan(
            sim.system, sim.cbw, sim.cfg.delta_t, "NVT", REPLICA_STEPS,
            friction=0.1, temperature=300.0,
            hard_max_states=sim.cfg.evb_hard_max_states)
        walls, out, diag = _chunks(scan, batch, torch.cuda.synchronize)
    return dict(cards=1, walls=walls, regrows=scan.regrows,
                captures=len(scan.step_graphs.captures),
                flags=list(diag.capacities()), x0=out.states[0].state.x.cpu())


def replicas_rank(n, sp=1):
    """One rank of the replica shape over n cards, a (n / sp x sp) mesh."""
    import torch
    import torch.distributed as dist
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    mesh = ensemble.make_mesh(n, sp=sp)
    with tempfile.TemporaryDirectory() as tmp:
        sim = replica_sim(tmp)
        block = ensemble.stack_replicas(sim.ms, REPLICAS, seed=7, mesh=mesh)
        scan = ensemble.make_replica_scan(
            sim.system, sim.cbw, sim.cfg.delta_t, "NVT", REPLICA_STEPS,
            friction=0.1, temperature=300.0,
            hard_max_states=sim.cfg.evb_hard_max_states, mesh=mesh)
        walls, out, diag = _chunks(scan, block, dist.barrier)
    x = torch.stack([m.state.x for m in out.states])
    copies = [torch.empty_like(x) for _ in range(sp)]
    dist.all_gather(copies, x, group=mesh.atoms_group)
    return dict(cards=n, walls=walls, regrows=scan.regrows,
                captures=len(scan.step_graphs.captures),
                flags=list(diag.capacities()),
                x0=out.states[0].state.x.cpu(),
                ranks_dx=max(float((c - x).abs().max()) for c in copies),
                potential=diag.potential[:, -1])


def lattice_rank(n):
    """One rank of the 10k shape over n cards."""
    import torch
    import torch.distributed as dist
    from reactive_pb_nn_md_tpu_torch.md import graphs, integrators
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    mesh = ensemble.make_mesh(n, sp=n)
    with tempfile.TemporaryDirectory() as tmp:
        sim = Simulation(*deck_copy(pathlib.Path(tmp),
                                    ROOT / "examples" / "water_10k", "fp32"),
                         device="cuda")
    args = (sim.system.replace(pme_scap=SCAP_10K), sim.cbw, sim.cfg.delta_t,
            "NVE")
    sscan = ensemble.make_atom_sharded_scan(*args, mesh, STEPS_10K)
    step = ensemble.make_atom_sharded_step(*args, mesh)
    colls = ensemble.collective_summary(lambda: step(sim.ms))
    walls, out, diag = _chunks(sscan, sim.ms, dist.barrier)
    res = dict(cards=n, sharded_ms=[w / STEPS_10K * 1e3 for w in walls],
               flags=list(diag.capacities()), collectives=colls,
               captures=len(sscan.step_graphs.captures))
    if mesh.rank == 0:
        sg = graphs.StepGraphs()
        ms, walls1 = sim.ms, []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ms, d1 = integrators.md_scan(ms, *args, STEPS_10K,
                                         step_graphs=sg)
            torch.cuda.synchronize()
            walls1.append(time.perf_counter() - t0)
        res.update(one_card_ms=[w / STEPS_10K * 1e3 for w in walls1],
                   one_card_flags=list(d1.capacities()),
                   max_dx=float((ms.state.x - out.state.x).abs().max()))
    dist.barrier()
    return res


def main():
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    from reactive_pb_nn_md_tpu_torch.parallel import mesh as mesh_mod
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _build.library()
    res = {"nvidia_smi": smi}
    one = replicas_one_card()
    rate = [REPLICAS * REPLICA_STEPS / w for w in one["walls"]]
    res["replicas"] = dict(replicas=REPLICAS, steps=REPLICA_STEPS,
                           one_card_rate=rate, cards=a.cards,
                           one_card_regrows=one["regrows"],
                           captures=[one["captures"]], flags=[one["flags"]])
    for sp in (1, 2) if a.cards % 2 == 0 else (1,):
        multi = mesh_mod.launch(replicas_rank, a.cards, a.cards, sp,
                                device="cuda", timeout=900, threads=0)
        mrate = [REPLICAS * REPLICA_STEPS / max(r["walls"][i] for r in multi)
                 for i in range(2)]
        res["replicas"][f"mesh_{a.cards // sp}x{sp}"] = dict(
            rate=mrate, speedup=[m / o for m, o in zip(mrate, rate)],
            regrows=[r["regrows"] for r in multi],
            ranks_dx=max(r["ranks_dx"] for r in multi),
            replica0_dx=float((one["x0"] - multi[0]["x0"]).abs().max()))
        res["replicas"]["captures"] += [r["captures"] for r in multi]
        res["replicas"]["flags"] += [r["flags"] for r in multi]
    print(json.dumps({"replicas": res["replicas"]}), flush=True)
    lat = mesh_mod.launch(lattice_rank, a.cards, a.cards, device="cuda",
                          timeout=900, threads=0)
    res["lattice_10k"] = dict(
        cards=a.cards, steps=STEPS_10K,
        sharded_ms=[max(r["sharded_ms"][i] for r in lat) for i in range(2)],
        one_card_ms=lat[0]["one_card_ms"], max_dx=lat[0]["max_dx"],
        collectives=lat[0]["collectives"],
        flags=[r["flags"] for r in lat] + [lat[0]["one_card_flags"]],
        captures=[r["captures"] for r in lat])
    print(json.dumps({"lattice_10k": res["lattice_10k"]}), flush=True)
    print(smi)
    out = pathlib.Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "multichip.json").write_text(json.dumps(res, indent=1))
    bad = failures(res)
    for b in bad:
        print("time_multichip FAILED: " + b, file=sys.stderr)
    return 1 if bad else 0


def failures(res):
    """The failed checks of the two shapes' results (empty: all held)."""
    bad = []
    for shape in ("replicas", "lattice_10k"):
        flags = [f for fl in res[shape]["flags"] for f in fl]
        if flags:
            bad.append(f"{shape}: capacity flags stand {sorted(set(flags))}")
    for mesh, r in res["replicas"].items():
        if mesh.startswith("mesh_") and r["ranks_dx"] != 0.0:
            bad.append(f"replicas {mesh}: the ranks' copies of a block "
                       f"differ by {r['ranks_dx']} A")
    dx = res["lattice_10k"]["max_dx"]
    if not dx <= DX_10K_FP32:
        bad.append(f"lattice_10k: sharded and one-card positions differ by "
                   f"{dx} A (bound {DX_10K_FP32})")
    return bad


if __name__ == "__main__":
    sys.exit(main())
