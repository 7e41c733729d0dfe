"""Spontaneous (unseeded) proton transport on a softened surface
(counterpart of the JAX package's scripts/spontaneous_hops.py):

    python -m reactive_pb_nn_md_tpu_torch.run.spontaneous_hops --scan
        [--steps 2048] [--temp 300] [--scales C DA PA C12] [--pmf]
    python -m reactive_pb_nn_md_tpu_torch.run.spontaneous_hops --final
        [--steps 20480] [--scales C DA PA C12] [--out FILE]
    (both: [--device cuda] [--seed 23])

The published MS-EVB3 constants put the flagship liquid's transfer
barrier far above kT, so hops seldom happen on their own.  On the
equilibrated flagship (run/presets.build_water(215, 32, "fp32", 80) at
benchdata/eq_flagship_s80.npz) softened by presets.soften_for_hops
(coupling, donor-acceptor, proton-acceptor and O_h3o-OW C12 scales),
with fresh velocities at --temp:

  --scan   an NVT window (Langevin, friction 1 / ps) for each softening
           candidate of CANDIDATES (or --scales), one line each: hops,
           the diabat maximum, steps/s, clean; --pmf adds a short
           umbrella PMF barrier (run/umbrella_pmf.run_pmf, 12 windows);
  --final  one long window at --scales (default SPONT_SCALES, the JAX
           bench's: all 1.0) and the hop-event artifact: every hop's
           step, time, donor -> acceptor molecule and diabat count
           (the reference's hop log), written as JSON to --out (under
           the git-ignored build/ by default).

The window's first chunk (thermalization) is discarded.  The Langevin
draws and the velocities come from generators seeded from --seed.  A
capacity that does not hold is regrown and the chunk replayed
(integrators.regrown_chunk); steps with a state-cap overflow or
|F| > 1e4 kJ/mol/A are counted and make the window not clean, and so do
non-finite steps or a ground state that kernel E cannot converge, after
which the window stops ("stopped" says why: the stronger softenings blow
up in tens of steps, in fp64 as in fp32; the JAX script counts such a
window as clean, its NaN forces passing the 1e4 test).
"""

import argparse
import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from ..convert import cli_device, resolve_device
from ..md import graphs, integrators, velocities
from . import presets, umbrella_pmf

ROOT = pathlib.Path(__file__).resolve().parents[2]
EQ_FLAGSHIP = ROOT / "benchdata" / "eq_flagship_s80.npz"
CANDIDATES = [
    # (coupling_scale, da_scale, pa_scale, c12_scale)
    (1.0, 1.0, 1.0, 1.0),      # unsoftened control
    (2.0, 0.5, 0.5, 1.0),
    (3.0, 0.4, 0.4, 0.6),
    (4.0, 0.3, 0.3, 0.5),
    (5.0, 0.25, 0.25, 0.4),
]
# the JAX bench's pinned scales (bench.py SPONT_SCALES)
SPONT_SCALES = (1.0, 1.0, 1.0, 1.0)
OUT = ROOT / "build" / "spontaneous_hops.json"


def build_softened(scales, temperature, seed=23, device="cuda"):
    """(system, cbw, cfg, ms): the equilibrated flagship, fp32, cap 80,
    its surface softened by `scales` = (coupling, da, pa, c12), with
    velocities at `temperature` from a generator seeded with `seed`."""
    system, cbw, cfg, ms = presets.equilibrated(
        presets.build_water(215, 32, "fp32", 80, device=device),
        EQ_FLAGSHIP)
    cs, das, pas, c12s = scales
    system = presets.soften_for_hops(system, coupling_scale=cs,
                                     da_scale=das, pa_scale=pas,
                                     c12_scale=c12s)
    v = velocities.sample_velocities(
        torch.Generator().manual_seed(seed), system.mass, temperature,
        velocities.freeze_mask(system, ms.topo))
    nl = ms.nlist
    ms = integrators.initial_md_state(
        dataclasses.replace(ms.state, v=v), ms.topo, system, cbw,
        nl.capacity, cells=nl.cells, react_cap=nl.react_cap or None)
    return system, cbw, cfg, ms


def hop_events(hopped, hydronium, n_states, first_step, dt, prev):
    """The hop events of a chunk's rows: hopped (n,) bool, hydronium (n,)
    and n_states (n,) after each step, `first_step` the step number of
    row 0, `prev` the hydronium before it.  One dict a hop: step,
    time_ps, from_mol, to_mol, n_states.  (The JAX script takes, when no
    event precedes the chunk, its first row's own hydronium as `prev`: a
    hop at a chunk's first step then reads from == to.)"""
    hyd = [int(h) for h in hydronium]
    events = []
    for i in np.flatnonzero(np.asarray(hopped)):
        step = int(first_step + i)
        events.append({"step": step,
                       "time_ps": round(float(step * dt), 4),
                       "from_mol": prev if i == 0 else hyd[i - 1],
                       "to_mol": hyd[i], "n_states": int(n_states[i])})
    return events


def nonfinite_steps(diag):
    """Steps of a chunk whose energy is not finite (a surface that blew
    up: past it the statistics mean nothing)."""
    return int((~(torch.isfinite(diag.potential)
                  & torch.isfinite(diag.kinetic))).sum())


def window_chunk(advance):
    """(ChunkDiagnostics, why the window stops or None) of the chunk that
    advance() runs: it stops at non-finite steps, and where kernel E did
    not converge (no diagnostics then), which a blown-up surface's
    Hamiltonian also causes."""
    try:
        diag = advance()
    except integrators.GroundStateError as e:
        return None, str(e)
    bad = nonfinite_steps(diag)
    return diag, (f"{bad} non-finite steps" if bad else None)


def run_window(scales, n_steps, temperature, collect_events=False,
               chunk=128, friction=1.0, seed=23, device="cuda"):
    """One NVT window on the softened flagship: its statistics (and hop
    events when asked), the JAX script's keys."""
    device = resolve_device(device)
    system, cbw, cfg, ms = build_softened(scales, temperature, seed, device)
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, 1]).generate_state(1)[0]))
    sg = graphs.StepGraphs() if device.type == "cuda" else None
    caps = integrators.capacities_of(ms)
    regrows = 0

    def advance():
        # state-cap overflows are counted, the cap never grown
        nonlocal ms, system, caps, regrows
        r = integrators.regrown_chunk(
            ms, system, cbw, caps, cfg.evb_hard_max_states, cfg.delta_t,
            "NVT", chunk, friction, temperature, generator=gen,
            step_graphs=sg, tolerate=(integrators.EVB_STATE_CAP,),
            log=lambda lines: print("".join("# " + ln for ln in lines),
                                    end=""))
        ms, system, caps = r.ms, r.system, r.caps
        regrows += r.regrows
        return r.diag

    _, stopped = window_chunk(advance)   # capture and thermalization
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    done = hops = n_max = n_evb_over = n_force_over = 0
    events = []
    while done < n_steps and stopped is None:
        prev = int(ms.topo.hydronium_mol)
        diag, stopped = window_chunk(advance)
        if diag is None:
            break
        if collect_events:
            events += hop_events(diag.hopped, diag.hydronium, diag.n_states,
                                 done + 1, cfg.delta_t, prev)
        hops += int(diag.hopped.sum())
        n_max = max(n_max, int(diag.n_states.max()))
        n_evb_over += int(diag.evb_overflow.sum())
        n_force_over += int(diag.force_overflow.sum())
        done += chunk
    wall = time.perf_counter() - t0
    out = {"scales": list(scales), "temperature": temperature,
           "steps": done, "window_ps": round(done * cfg.delta_t, 2),
           "hops": hops, "max_states": n_max,
           "steps_per_s": round(done / max(wall, 1e-9), 1),
           "clean": not (n_evb_over or n_force_over or stopped),
           # steps with a truncated state set, steps with a transient
           # |F| > 1e4 kJ/mol/A (the reference's abort threshold,
           # md_integration.f90:523-526), and why the window stopped
           # early (window_chunk)
           "steps_evb_overflow": n_evb_over,
           "steps_force_over_1e4": n_force_over,
           "stopped": stopped,
           "regrows": regrows}
    if collect_events:
        out["events"] = events
    return out


def run_barrier(scales, temperature=300.0, seed=23, device="cuda"):
    """A short umbrella PMF barrier of one candidate: (kJ/mol, kT, hops
    in the ladder)."""
    build = build_softened(scales, temperature, seed, device)
    out, _, _ = umbrella_pmf.run_pmf(build, n_windows=12, span=0.6,
                                     k_spring=400.0, n_equil=300,
                                     n_sample=1000, chunk=100,
                                     verbose=False)
    return out["barrier_kjmol"], out["barrier_kT"], out["hops_in_ladder"]


def final_artifact(r):
    """The --final result with the JAX artifact's summary keys."""
    ev = r["events"]
    if ev:
        mols = {e["to_mol"] for e in ev} | {e["from_mol"] for e in ev}
        gaps = np.diff([e["time_ps"] for e in ev])
        r["distinct_molecules_visited"] = len(mols)
        r["mean_identity_survival_ps"] = (round(float(gaps.mean()), 5)
                                          if gaps.size else None)
        r["hops_per_ps"] = round(len(ev) / r["window_ps"], 2)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="reactive_pb_nn_md_tpu_torch.run.spontaneous_hops",
        description="Spontaneous proton hops on a softened surface")
    ap.add_argument("--scan", action="store_true")
    ap.add_argument("--pmf", action="store_true")
    ap.add_argument("--final", action="store_true")
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--temp", type=float, default=300.0)
    ap.add_argument("--scales", type=float, nargs=4, default=None,
                    help="coupling da pa c12 (overrides the grid)")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs only when "
                         "asked for)")
    ap.add_argument("--seed", type=int, default=23)
    args = ap.parse_args(argv)
    device = cli_device(args.device)

    if args.scan:
        grid = [tuple(args.scales)] if args.scales else CANDIDATES
        rows = []
        for sc in grid:
            r = run_window(sc, args.steps, args.temp, seed=args.seed,
                           device=device)
            line = (f"scales={sc} T={args.temp:.0f} hops={r['hops']} / "
                    f"{r['window_ps']} ps max_states={r['max_states']} "
                    f"steps/s={r['steps_per_s']} clean={r['clean']}"
                    + (f" stopped: {r['stopped']}" if r["stopped"] else ""))
            if args.pmf:
                b_kj, b_kt, _ = run_barrier(sc, args.temp, args.seed, device)
                r.update(barrier_kjmol=b_kj, barrier_kT=b_kt)
                line += f"  barrier={b_kj} kJ/mol ({b_kt} kT)"
            print(line, flush=True)
            rows.append(r)
        return rows

    if args.final:
        sc = tuple(args.scales) if args.scales else SPONT_SCALES
        r = final_artifact(run_window(sc, args.steps, args.temp,
                                      collect_events=True, seed=args.seed,
                                      device=device))
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(r, indent=1))
        print(json.dumps({k: v for k, v in r.items() if k != "events"}))
        print(f"# hop-event artifact -> {path} ({len(r['events'])} events)")
        return r

    ap.print_help()
    return None


if __name__ == "__main__":
    main()
