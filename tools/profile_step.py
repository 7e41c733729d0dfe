#!/usr/bin/env python3
"""Profile the port's eager NVE step on one card:

    python3 tools/profile_step.py [--deck flagship|10k] [--out DIR]

--deck flagship (default): the equilibrated flagship box
(benchdata/eq_flagship_s80.npz with examples/water_msevb/); --deck 10k:
the 10,000-atom lattice of examples/water_10k/ with the CLI's seeded
velocities, stepped through the simulation loop (a capacity that does
not hold is regrown and the step redone, as in a run).

For fp64 and fp32, from the same starting state:
  1. wall ms per step over TIMED unprofiled steps after WARM ones
     (perf_counter between CUDA synchronisations);
  2. torch.profiler (CPU and CUDA activities) over PROFILED further steps:
     device time per step (the sum of the device ops' self time), device
     ops per step (kernels, copies and sets), the device busy share
     (device time over step 1's wall time), per-phase host and device ms
     from record_function ranges around the EVB phases, and the largest
     device ops;
  3. reproducibility: two runs of REPEAT steps from one state; the
     largest |Etot| and |x| difference between them, and the first step
     whose diabat counts differ.  The hand-written kernels sum in fixed
     orders; torch's accumulating ops on the card (index_put with
     accumulate=True in evb/hamiltonian.py, scatter_add_ in
     evb/topology_ops.py, the backward of indexing) add in the order
     their threads arrive, so two runs can differ by rounding.

Prints one summary line per precision and nvidia-smi's name and power
limit; writes profile.json and the profiler tables to --out.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
WARM, TIMED, PROFILED, REPEAT = 5, 50, 5, 100    # steps of each part

# (module, function) pairs that get a record_function range "P:<name>";
# each is called through its module's global name by the step
PHASES = (("evb.hamiltonian", "enumerate_diabats"),
          ("evb.hamiltonian", "build_diabat_topologies"),
          ("evb.hamiltonian", "diabat_diagonal_energies"),
          ("evb.hamiltonian", "_chain_mol_deltas"),
          ("evb.hamiltonian", "coupling_elements"),
          ("evb.hamiltonian", "ground_state_eigh"),
          ("md.integrators", "evaluate_forces"),
          ("md.integrators", "_sync_flags"),
          ("ops.neighbors", "needs_rebuild"))


def _instrument():
    """Wrap PHASES and torch.autograd.grad in record_function ranges."""
    import importlib
    import torch
    from torch.profiler import record_function

    def ranged(fn, label):
        def inner(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return inner

    for mod, name in PHASES:
        m = importlib.import_module("reactive_pb_nn_md_tpu_torch." + mod)
        setattr(m, name, ranged(getattr(m, name), "P:" + name))
    torch.autograd.grad = ranged(torch.autograd.grad, "P:backward")


def _run(step, ms, n, trace=None):
    """n steps of step(ms); appends (Etot, n_states) of each to `trace`."""
    for _ in range(n):
        ms = step(ms)
        if trace is not None:
            trace.append((float(ms.kinetic + ms.potential),
                          int(ms.n_states)))
    return ms


def _first(flags):
    """Index of the first true flag, -1 when there is none."""
    return next((i for i, f in enumerate(flags) if f), -1)


def _flagship_stepper(dtype):
    """(step, first MDState, regrow lines) on the equilibrated flagship
    state."""
    import torch
    from chip_smoke import flagship
    from reactive_pb_nn_md_tpu_torch.md import integrators
    system, state, topo, meta, cbw, cfg = flagship(torch.device("cuda"),
                                                   dtype)
    ms0 = integrators.initial_md_state(state, topo, system, cbw,
                                       meta["capacity"],
                                       react_cap=meta["react_cap"])

    def step(ms):
        ms = integrators.md_step(ms, system, cbw, cfg.delta_t)
        if ms.overflow:
            raise integrators.CapacityOverflow(", ".join(ms.overflow))
        return ms
    return step, ms0, []


def _lattice_stepper(dtype, out_dir):
    """(step, first MDState, regrow lines) of the simulation loop on
    water_10k."""
    import shutil
    import torch
    from chip_smoke import DECK_10K
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    tag = "fp64" if dtype == torch.float64 else "fp32"
    d = out_dir / f"deck_10k_{tag}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(DECK_10K, d)
    sim = d / "sim.pmt"
    sim.write_text(sim.read_text().replace("precision          fp32",
                                           f"precision          {tag}"))
    files = [str(d / n) for n in ("in.gro", "ff.pmt", "top.top", "sim.pmt",
                                  "traj.gro", "run.log", "hops.log",
                                  "A.log")]
    sim = Simulation(*files, device="cuda")

    def step(ms):
        sim.ms = ms
        sim._step(int(ms.state.step) + 1)
        return sim.ms
    return step, sim.ms, sim._log_lines


def profile_one(dtype, out_dir, deck):
    import torch
    from torch.profiler import ProfilerActivity, profile
    step, ms0, regrows = (_flagship_stepper(dtype) if deck == "flagship"
                          else _lattice_stepper(dtype, out_dir))
    ms = _run(step, ms0, WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = _run(step, ms, TIMED)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / TIMED

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = _run(step, ms, PROFILED)
        torch.cuda.synchronize()
    n = PROFILED
    ka = prof.key_averages()
    # device-side copies of the "P:" ranges are spans, not device ops
    dev = [e for e in ka if e.device_type.name == "CUDA"
           and not e.key.startswith("P:")]
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3 / n
    phases = {e.key: dict(host_ms=e.cpu_time_total / 1e3 / n,
                          device_ms=e.device_time_total / 1e3 / n)
              for e in ka if e.key.startswith("P:")
              and e.device_type.name == "CPU"}
    top = [dict(op=e.key[:80], device_ms=e.self_device_time_total / 1e3 / n,
                per_step=e.count / n)
           for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:15]]
    tag = "fp64" if dtype == torch.float64 else "fp32"
    (out_dir / f"profile_{deck}_{tag}.txt").write_text(
        ka.table(sort_by="self_device_time_total", row_limit=60))

    runs = []
    for _ in range(2):
        trace = []
        end = _run(step, ms0, REPEAT, trace)
        runs.append((trace, end.state.x))
    (ta, xa), (tb, xb) = runs
    e0 = float(ms0.kinetic + ms0.potential)
    de = [abs(a[0] - b[0]) for a, b in zip(ta, tb)]
    return dict(
        wall_ms_per_step=wall_ms, steps_per_s=1e3 / wall_ms,
        device_ms_per_step=device_ms, device_busy_share=device_ms / wall_ms,
        device_ops_per_step=sum(e.count for e in dev) / n, phases=phases,
        top_device_ops=top,
        repeat_max_abs_dEtot=max(de),
        repeat_max_abs_dx=float((xa - xb).abs().max()),
        repeat_dEtot_end=[ta[-1][0] - e0, tb[-1][0] - e0],
        repeat_max_abs_dEtot_within={
            k: max(de[:k]) for k in (1, 10, 30) if k < len(de)},
        repeat_abs_dEtot=de,
        repeat_first_step_n_states_differ=_first(
            a[1] != b[1] for a, b in zip(ta, tb)) + 1,
        n_states_max=max(t[1] for t in ta),
        regrows=[ln.strip() for ln in regrows])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="chiprun_out",
                   help="directory for profile_<deck>.json and the tables")
    p.add_argument("--deck", default="flagship", choices=("flagship", "10k"))
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
    res = dict(card=nvidia_smi(), deck=args.deck,
               steps=dict(warm=WARM, timed=TIMED,
                                             profiled=PROFILED,
                                             repeat=REPEAT))
    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        r = res[tag] = profile_one(dtype, out_dir, args.deck)
        print(f"{tag}: wall {r['wall_ms_per_step']:.2f} ms/step "
              f"({r['steps_per_s']:.2f} steps/s), device "
              f"{r['device_ms_per_step']:.2f} ms/step, busy "
              f"{r['device_busy_share']:.3f}, "
              f"{r['device_ops_per_step']:.0f} device ops/step; repeat "
              f"max|dEtot| {r['repeat_max_abs_dEtot']:.3e} kJ/mol, "
              f"max|dx| {r['repeat_max_abs_dx']:.3e} A; max|dEtot| within "
              f"k steps {r['repeat_max_abs_dEtot_within']}; n_states first "
              f"differ at step {r['repeat_first_step_n_states_differ']} "
              f"(0: never); max n_states {r['n_states_max']}", flush=True)
        for ln in r["regrows"]:
            print("  " + ln)
        for name, ph in sorted(r["phases"].items()):
            print(f"  {name:32s} host {ph['host_ms']:8.2f} ms  device "
                  f"{ph['device_ms']:7.3f} ms")
        for t in r["top_device_ops"][:10]:
            print(f"  {t['op']:60s} {t['device_ms']:.4f} ms x"
                  f"{t['per_step']:.1f}")
    (out_dir / f"profile_{args.deck}.json").write_text(
        json.dumps(res, indent=1))
    print(res["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
