"""Equilibrate a water box and save its state for the benchmarks and the
scale runs (counterpart of the JAX package's scripts/equilibrate.py):

    python -m reactive_pb_nn_md_tpu_torch.run.equilibrate \\
        {flagship,10k} STEPS OUT [--device cuda] [--seed 0]

flagship is the 649-atom box (215 H2O + 1 H3O+, PME 32^3, state cap 80,
fp32), 10k the 10,000-atom box of examples/water_10k/ (3,332 H2O + 1
H3O+, PME 64^3, cap 32, fp32), both built by run/presets.build_water
with 300 K velocities drawn from --seed.  The JAX script's acid and
acid5k configurations need the CH3SO3H force-field and topology files,
which the repository does not hold: they exit with that message.

The protocol is the JAX script's, step for step:
  1. a staged-dt quench from the lattice: NVE chunks of 40 steps at dt/40,
     /20, /10, /5, eight clean chunks each, the velocities redrawn at 50 K
     after every clean chunk;
  2. STEPS steps of rescaled NVE in chunks of 40, the kinetic energy set
     after each chunk to the ramp's, 50 K -> 300 K over the first half and
     300 K after; force spikes (|F| > 1e4 kJ/mol/A) and state-cap
     overflows are logged, not fatal; a non-finite kinetic energy is;
  3. the capacities re-tightened: those of the build before any regrow
     (a fresh build of the configuration gives the same ones: NVE keeps
     the box), regrown at once if they do not hold;
  4. a validation window of 10 clean NVE chunks; a force spike, a
     state-cap overflow or a non-finite potential there is fatal.
A capacity that does not hold (neighbor rows, cells, kernel A's cells,
the slab cap) is regrown by the port's integrators.grow_capacities and
the chunk replayed from the state before it (integrators.regrown_chunk,
as md/simulation.py does); in the window a regrow restarts the window.  On
the card a chunk is replays of a captured step: one capture for each dt
and one for each regrow.

OUT gets the state the 10 clean chunks started from, the state the
window validated forward (the JAX script saves the one after it), in the
JAX package's layout (convert.save_state_npz: leaves l0..l12 and the
capacities as meta_*), which convert.load_equilibrated_npz and the JAX
bench.load_equilibrated both read.  The velocity redraws of the quench
come from a generator seeded from --seed.  Prints one JSON line last.
"""

import argparse
import dataclasses
import json
import math
import pathlib
import time

import numpy as np
import torch

from ..convert import cli_device, save_state_npz
from ..md import graphs, integrators, velocities
from ..utils.constants import KB
from . import presets

# name -> build_water's (n_water, pme_grid, precision, evb_max_states)
CONFIGS = {"flagship": (215, 32, "fp32", 80),
           "10k": (3332, 64, "fp32", 32)}
BLOCKED = ("acid", "acid5k")
CHUNK = 40
QUENCH_DIVS = (40, 20, 10, 5)       # dt / div at each quench stage
QUENCH_CHUNKS = 8                   # clean chunks a stage
VALIDATE_CHUNKS = 10
QUENCH_T, START_T, TARGET_T = 50.0, 50.0, 300.0


def build(config, device="cuda", seed=0):
    """(system, cbw, cfg, ms) of a configuration of CONFIGS."""
    if config in BLOCKED:
        raise SystemExit(f"{config}: blocked: CH3SO3H files not in the repo "
                         f"(CH3SO3H.pmt and CH3SO3H_H2O.top)")
    if config not in CONFIGS:
        raise SystemExit(f"unknown config {config!r}: expected one of "
                         f"{', '.join(CONFIGS)}")
    return presets.build_water(*CONFIGS[config], seed=seed, device=device)


def degrees_of_freedom(system, topo):
    """3 x mobile atoms - 3 (the COM momentum is removed)."""
    return 3 * int(velocities.freeze_mask(system, topo).sum()) - 3


def equilibrate(build, equil_steps, seed=0, chunk=CHUNK,
                quench_divs=QUENCH_DIVS, quench_chunks=QUENCH_CHUNKS,
                validate_chunks=VALIDATE_CHUNKS, log=print):
    """The protocol of the module docstring on `build` = (system, cbw, cfg,
    ms); the step counts are arguments so that a test can run it small.
    Returns a dict: "start" the MDState the validation window started from
    (the one to save), "ms" the state after the window, "system" the
    System they ran with, "rescales" (step, target KE, KE after) of every
    rescale, "max_states", "regrows" (log lines), "captures", "steps" by
    phase and "wall_s"."""
    t0 = time.perf_counter()
    system, cbw, cfg, ms = build
    caps = integrators.capacities_of(ms)
    tight_system, tight_caps = system, caps
    sg = graphs.StepGraphs() if ms.state.x.is_cuda else None
    mass = system.mass
    mobile = velocities.freeze_mask(system, ms.topo)
    ke_target = 0.5 * degrees_of_freedom(system, ms.topo) * KB * TARGET_T
    gen = torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, 100]).generate_state(1)[0]))
    dt = cfg.delta_t
    max_states, rescales, regrows = 0, [], []

    def grew(lines):
        for ln in lines:
            log("# " + ln.rstrip())
        regrows.extend(lines)

    def advance(step_dt):
        # the JAX script logs state-cap overflows and never grows the cap
        nonlocal ms, system, caps
        r = integrators.regrown_chunk(
            ms, system, cbw, caps, cfg.evb_hard_max_states, step_dt, "NVE",
            chunk, step_graphs=sg, tolerate=(integrators.EVB_STATE_CAP,),
            log=grew)
        ms, system, caps = r.ms, r.system, r.caps
        return r

    def set_v(v):
        nonlocal ms
        ms = dataclasses.replace(
            ms, state=dataclasses.replace(ms.state, v=v),
            kinetic=velocities.kinetic_energy(v, mass))

    # 1. staged-dt quench, velocities redrawn at QUENCH_T after each chunk
    for div in quench_divs:
        for _ in range(quench_chunks):
            diag = advance(dt / div).diag
            max_states = max(max_states, int(diag.n_states.max()))
            set_v(velocities.sample_velocities(gen, mass, QUENCH_T, mobile))
    n_quench = len(quench_divs) * quench_chunks * chunk
    log(f"# quenched {n_quench} staged-dt steps, "
        f"{time.perf_counter() - t0:.0f} s")

    # 2. rescaled NVE, the target ramped START_T -> TARGET_T over the
    # first half
    done, half = 0, max(1, equil_steps // 2)
    while done < equil_steps:
        diag = advance(dt).diag
        done += chunk
        heating = done < equil_steps // 2
        max_states = max(max_states, int(diag.n_states.max()))
        if bool(diag.force_overflow.any()):
            fmag = torch.linalg.norm(ms.force.detach(), dim=1)
            a = int(torch.argmax(fmag))
            t = int(ms.topo.atom_type[a])
            names = system.ff.atype_names
            log(f"# transient force spike at {done}"
                f"{' (heating)' if heating else ''}: atom {a} type "
                f"{names[t] if t < len(names) else '?'} |F|="
                f"{float(fmag[a]):.0f} mol {int(ms.topo.atom_mol[a])}")
        if bool(diag.evb_overflow.any()):
            log(f"# transient EVB-cap overflow at {done} (warm-up only)")
        ke = float(diag.kinetic[-1])
        if not math.isfinite(ke):
            raise SystemExit(f"non-finite KE at {done}")
        kt = ke_target * (START_T + (TARGET_T - START_T)
                          * min(1.0, done / half)) / TARGET_T
        set_v(ms.state.v * math.sqrt(kt / ke))
        rescales.append((done, kt, float(ms.kinetic)))
        if done % 1000 == 0:
            log(f"# {done}/{equil_steps}, {time.perf_counter() - t0:.0f} "
                f"s, KE {ke:.0f} -> {kt:.0f}, n_states max "
                f"{int(diag.n_states.max())}")

    # 3. the capacities of the fresh build, regrown only if they do not
    # hold here
    ms, system, caps = integrators.settle(
        ms.state, ms.topo, tight_system, cbw, tight_caps,
        cfg.evb_hard_max_states, ms.state.step, comp=ms.comp,
        tolerate=(integrators.EVB_STATE_CAP,), log=grew)

    # 4. the validation window; a regrow restarts it
    start, clean = ms, 0
    while clean < validate_chunks:
        r = advance(dt)
        diag = r.diag
        if r.regrows:
            start, clean = r.start, 0
        max_states = max(max_states, int(diag.n_states.max()))
        bad = [n for n in ("force_overflow", "evb_overflow")
               if bool(getattr(diag, n).any())]
        if bad or not math.isfinite(float(diag.potential[-1])):
            raise SystemExit(f"validation window failed: {bad}, potential "
                             f"{float(diag.potential[-1])}")
        clean += 1
    log(f"# validation window clean ({validate_chunks * chunk} steps, no "
        f"flags)")
    return dict(start=start, ms=ms, system=system,
                rescales=rescales, max_states=max_states,
                regrows=regrows,
                captures=0 if sg is None else len(sg.captures),
                steps={"quench": n_quench, "rescaled": done,
                       "window": validate_chunks * chunk},
                wall_s=time.perf_counter() - t0)


def temperature(ms, system):
    """The kinetic temperature of `ms` (K)."""
    return 2.0 * float(ms.kinetic) / (degrees_of_freedom(system, ms.topo)
                                      * KB)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="reactive_pb_nn_md_tpu_torch.run.equilibrate",
        description="Equilibrate a water box and save its state")
    ap.add_argument("config", help=f"one of {', '.join(CONFIGS)}")
    ap.add_argument("steps", type=int, help="rescaled NVE steps")
    ap.add_argument("out", help="the .npz to write")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs only when "
                         "asked for)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.config not in CONFIGS:
        build(args.config)              # the blocked or unknown config
    device = cli_device(args.device)
    t0 = time.perf_counter()
    b = build(args.config, device, args.seed)
    t_build = time.perf_counter() - t0
    res = equilibrate(b, args.steps, seed=args.seed)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    start, system = res["start"], res["system"]
    save_state_npz(path, start, system, seed=args.seed)
    summary = dict(
        config=args.config, steps=args.steps, seed=args.seed,
        device=str(device), n_atoms=system.n_atoms,
        build_s=round(t_build, 2), wall_s=round(res["wall_s"], 2),
        ke_kjmol=float(start.kinetic),
        temperature_k=temperature(start, system),
        potential_kjmol=float(start.potential),
        max_states=res["max_states"], regrows=len(res["regrows"]),
        captures=res["captures"], steps_by_phase=res["steps"],
        capacity=start.nlist.capacity, cells=list(start.nlist.cells),
        rs_cells=list(system.rs_cells), pme_scap=system.pme_scap,
        out=str(path))
    if device.type == "cuda":
        summary["card"] = torch.cuda.get_device_name(device)
    print(f"# saved {args.config} (the validation window's start) -> "
          f"{path}")
    print(json.dumps(summary))
    return res


if __name__ == "__main__":
    main()
