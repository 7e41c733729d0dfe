#!/usr/bin/env python3
"""Profile the port's MD step on one card, eager against graphed:

    python3 tools/profile_step.py [--deck flagship|10k] [--ensemble NVE|NVT]
        [--dtype fp64|fp32|both] [--steps N] [--graphed-only] [--out DIR]

--deck flagship (default): the equilibrated flagship box
(benchdata/eq_flagship_s80.npz with examples/water_msevb/); --deck 10k:
the 10,000-atom lattice of examples/water_10k/ with the CLI's seeded
velocities.  Both run through the simulation loop (md/simulation.py: a
capacity that does not hold is regrown and the chunk replayed).

For each precision, from the same start, eager (md_step on the card, no
graph: Simulation.eager; left out with --graphed-only) and graphed (the
chunked loop's replays of the captured step):
  1. steps/s from the log's "completed" line of a run of --steps steps
     (the graphed run includes its warm-up step and capture; eager runs
     a sixth as many steps, at most 20);
  2. graphed: the steady wall ms per step of a further --steps steps
     (perf_counter around a chunk of replays ended by a synchronization;
     eager: the run's own);
  3. torch.profiler (CUDA activity) over PROFILED further steps: device
     ms per step (every device op's self time), device ops per step
     (kernels, copies and sets: per replay when graphed), kernel E's
     and kernel F's device ms (its order kernels and its sum; the order
     alone too), the device ms and count of torch's
     accumulating kernels (ACCUMULATE), the wall ms per step of those
     same steps (perf_counter
     between two synchronizations) and the device busy share, device ms
     over that wall ms: one window for both, so the share is at most 1
     (the profiler's own cost is the profiled wall ms against the
     steady one);
     the SM clock (nvidia-smi) before and after each timed window;
  4. eager: the device ms of the neighbor rebuild, computed every step
     and selected on the device (record_function ranges around
     needs_rebuild, rebuild_like and where_nlist);
  5. graphed: the capture's host seconds and the graph pool's MiB.

Prints one line per precision and mode and nvidia-smi's name and power
limit; writes profile_<deck>_<ensemble>.json and the profiler tables to
--out.  chip_smoke.py's phase 8f calls measure() on its four cells, and
its phase 12c profiled_chunk() on a batched replica scan.
"""

import argparse
import json
import pathlib
import re
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROFILED = 8                   # steps under the profiler
# device kernels of torch's accumulating ops (the indexing backward, which
# index_put with accumulate also runs; index_add; the scatter-add of
# gather's backward) and of the port's fixed-order segment sum (kernel F)
ACCUMULATE = re.compile(r"indexing_backward|indexFunc|ReduceAdd|"
                        r"embedding_backward")
SEGMENT = re.compile(r"segment_(sum|tile_sort|bucket_order)_kernel")
SEGMENT_ORDER = re.compile(r"segment_(tile_sort|bucket_order)_kernel")
NVT_LINES = "ensemble           NVT\nfriction_coeff     1.0\n"
# record_function ranges of the eager step: (module, function) -> label
RANGES = (("ops.neighbors", "needs_rebuild", "rebuild"),
          ("ops.neighbors", "rebuild_like", "rebuild"),
          ("ops.neighbors", "where_nlist", "rebuild"))


def _instrument():
    """Wrap RANGES in record_function ranges "P:<label>" (the step calls
    each through its module's global name)."""
    import importlib
    from torch.profiler import record_function

    def ranged(fn, label):
        def inner(*a, **k):
            with record_function("P:" + label):
                return fn(*a, **k)
        inner.ranged = True
        return inner

    for mod, name, label in RANGES:
        m = importlib.import_module("reactive_pb_nn_md_tpu_torch." + mod)
        if not getattr(getattr(m, name), "ranged", False):
            setattr(m, name, ranged(getattr(m, name), label))


def deck_files(out_dir, deck, ensemble, tag, steps):
    """A copy of the deck in precision `tag` under `ensemble`, output at
    the run's end: the 8 CLI file names."""
    src = ROOT / "examples" / ("water_msevb" if deck == "flagship"
                               else "water_10k")
    d = out_dir / f"deck_{deck}_{ensemble}_{tag}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src, d)
    sim = d / "sim.pmt"
    text = re.sub(r"precision\s+fp\d\d", f"precision          {tag}",
                  sim.read_text())
    text = re.sub(r"n_output\s+\d+", f"n_output           {steps}", text)
    sim.write_text(text.rstrip("\n") + "\n"
                   + (NVT_LINES if ensemble == "NVT" else ""))
    return [str(d / n) for n in ("in.gro", "ff.pmt", "top.top", "sim.pmt",
                                 "traj.gro", "run.log", "hops.log",
                                 "A.log")]


def simulation(files, deck, dtype):
    """The Simulation of `files`; the flagship starts from the
    equilibrated state with its capacities (chip_smoke.flagship)."""
    import torch
    from chip_smoke import flagship
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    sim = Simulation(*files, device="cuda")
    if deck == "flagship":
        system, state, topo, meta, cbw, _ = flagship(torch.device("cuda"),
                                                     dtype)
        sim.system, sim.cbw = system, cbw
        sim.capacity, sim.react_cap = meta["capacity"], meta["react_cap"]
        sim._init_state(state, topo)
    return sim


def sm_clock():
    """The card's SM clock now and its maximum, MHz (nvidia-smi)."""
    import subprocess
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    return [int(v) for v in r.stdout.splitlines()[0].split(",")]


def measure(deck, ensemble, tag, out_dir, steps, eager, mutate=None,
            profiled=PROFILED):
    """One mode's numbers (see the module docstring) over `profiled`
    profiled steps; mutate: a function of the System for
    Simulation.mutate_system before the run (chip_smoke phase 9f attaches
    a PB-NN MLP)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dtype = torch.float64 if tag == "fp64" else torch.float32
    n = min(20, max(steps // 6, 1)) if eager else steps
    files = deck_files(out_dir, deck, ensemble, tag, n)
    sim = simulation(files, deck, dtype)
    if mutate is not None:
        sim.mutate_system(mutate)
    sim.eager = eager
    sim.run(n)
    text = pathlib.Path(files[5]).read_text()
    done = re.findall(r"completed (\d+) steps in ([\d.]+) s \(([\d.]+) "
                      r"steps/s\)", text)[-1]
    rate = float(done[2])
    step = sim.ms.state.step
    steady_ms = 1e3 / rate
    clocks = [sm_clock()]
    if not eager:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, k, _ = sim._chunk(step, steps)
        torch.cuda.synchronize()
        steady_ms = (time.perf_counter() - t0) * 1e3 / k
        step += k
        clocks.append(sm_clock())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim._chunk(step, profiled)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / profiled
    clocks.append(sm_clock())
    step += profiled
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type.name == "CUDA"
           and not e.key.startswith("P:")]
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3 / profiled
    res = dict(deck=deck, ensemble=ensemble, dtype=tag,
               mode="eager" if eager else "graphed", steps=int(done[0]),
               steps_per_s=rate, steady_ms_per_step=steady_ms,
               profiled_ms_per_step=profiled_ms,
               device_ms_per_step=device_ms,
               device_busy_share=device_ms / profiled_ms,
               sm_clock_mhz=[c for c, _ in clocks],
               sm_clock_max_mhz=clocks[0][1],
               device_ops_per_step=sum(e.count for e in dev) / profiled,
               E_device_ms=sum(e.self_device_time_total for e in dev
                               if "ground_state_kernel" in e.key)
               / 1e3 / profiled,
               F_device_ms=sum(e.self_device_time_total for e in dev
                               if SEGMENT.search(e.key)) / 1e3 / profiled,
               F_order_device_ms=sum(
                   e.self_device_time_total for e in dev
                   if SEGMENT_ORDER.search(e.key)) / 1e3 / profiled,
               F_per_step=sum(e.count for e in dev
                              if SEGMENT.search(e.key)) / profiled,
               accumulate={e.key[:90]: dict(
                   ms=e.self_device_time_total / 1e3 / profiled,
                   per_step=e.count / profiled)
                   for e in dev if ACCUMULATE.search(e.key)},
               regrows=[ln for ln in text.splitlines() if "regrow" in ln],
               top=[dict(op=e.key[:70], ms=e.self_device_time_total / 1e3
                         / profiled, per_step=e.count / profiled)
                    for e in sorted(dev, key=lambda e:
                                    -e.self_device_time_total)[:12]])
    name = f"profile_{deck}_{ensemble}_{tag}_{res['mode']}.txt"
    (out_dir / name).write_text(ka.table(sort_by="self_device_time_total",
                                         row_limit=50))
    if eager:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim._chunk(step, profiled)
            torch.cuda.synchronize()
        res["ranges_device_ms"] = {
            e.key[2:]: e.device_time_total / 1e3 / profiled
            for e in prof.key_averages()
            if e.key.startswith("P:") and e.device_type.name == "CPU"}
    else:
        res["captures"] = [dict(key_tier=k[2], seconds=s, pool_mib=b / 2**20)
                           for k, s, b in sim.step_graphs.captures]
    return res


def profiled_chunk(run, steps):
    """(device ms, device ops) per step of run(), a callable that runs
    `steps` steps (a chunk of a graphed replica batch: chip_smoke.py's
    phase 12c), under torch.profiler with measure()'s reading: every
    device op's self time and count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
           and not e.key.startswith("P:")]
    return (sum(e.self_device_time_total for e in dev) / 1e3 / steps,
            sum(e.count for e in dev) / steps)


def line(r):
    extra = (f"rebuild {r['ranges_device_ms'].get('rebuild', 0):.3f} ms "
             f"device" if r["mode"] == "eager" else
             "captures " + ", ".join(f"{c['key_tier']} {c['seconds']:.2f} s "
                                     f"{c['pool_mib']:.0f} MiB"
                                     for c in r["captures"]))
    return (f"{r['deck']} {r['ensemble']} {r['dtype']} {r['mode']:7s}: "
            f"{r['steps_per_s']:.2f} steps/s ({r['steps']} steps, the "
            f"log's line), steady {r['steady_ms_per_step']:.2f} ms/step, "
            f"profiled {r['profiled_ms_per_step']:.2f} ms/step, "
            f"device {r['device_ms_per_step']:.2f} ms/step (E "
            f"{r['E_device_ms']:.3f}, F {r['F_device_ms']:.3f} in "
            f"{r['F_per_step']:.0f} (its order "
            f"{r['F_order_device_ms']:.3f}), torch accumulate "
            f"kernels "
            f"{sum(a['ms'] for a in r['accumulate'].values()):.3f} in "
            f"{sum(a['per_step'] for a in r['accumulate'].values()):.0f}), "
            f"busy {r['device_busy_share']:.3f}, "
            f"{r['device_ops_per_step']:.0f} device ops/step, SM clock "
            f"{r['sm_clock_mhz']} of {r['sm_clock_max_mhz']} MHz; {extra}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="chiprun_out",
                   help="directory for the json and the tables")
    p.add_argument("--deck", default="flagship", choices=("flagship", "10k"))
    p.add_argument("--ensemble", default="NVE", choices=("NVE", "NVT"))
    p.add_argument("--dtype", default="both", choices=("fp64", "fp32",
                                                       "both"))
    p.add_argument("--steps", type=int, default=128,
                   help="steps of the graphed run (a chunk at most 128)")
    p.add_argument("--graphed-only", action="store_true",
                   help="measure the graphed step only")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import nvidia_smi
    _instrument()
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    res = dict(card=nvidia_smi(), runs=[])
    tags = ("fp64", "fp32") if args.dtype == "both" else (args.dtype,)
    for tag in tags:
        for eager in (False,) if args.graphed_only else (True, False):
            r = measure(args.deck, args.ensemble, tag, out_dir, args.steps,
                        eager)
            res["runs"].append(r)
            print(line(r), flush=True)
            for t in r["top"][:8]:
                print(f"    {t['op']:70s} {t['ms']:.4f} ms x"
                      f"{t['per_step']:.1f}")
    (out_dir / f"profile_{args.deck}_{args.ensemble}.json").write_text(
        json.dumps(res, indent=1))
    print(res["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
