"""Large-system scale probe: reactive MS-EVB steps/s at any N
(counterpart of the JAX package's scripts/scale_run.py):

    python -m reactive_pb_nn_md_tpu_torch.run.scale_run [n_water]
        [pme_grid] [chunk] [steps] [--device cuda] [--seed 0]

builds the water + hydronium box of run/presets.build_water at the
requested size (defaults: the 100,000-atom box, 33,332 H2O + 1 H3O+, PME
128^3, fp32, state cap 32) and times NVE chunks of graphed steps on the
card: a first chunk (its capture and one chunk of steps), then `steps`
steps in chunks of `chunk`.  It prints the JAX script's lines (the
build, the first chunk with its seconds and potential, the flags after
warm-up, steps/s and ms/step with the diabat count, the final flags),
then the peak device memory, the kernel launches of the timed steps
(ops/kernels/_build.launches) and the card's name and power limit.  A
capacity that does not hold is reported, not regrown (the production
loop, md/simulation.py, regrows): the flags are those of every chunk,
and a rate whose steps had one timed a truncated computation.

The launches name the paths the box took: at 10^5 atoms kernel A'' on
22^3 cells, the per-atom spread B1 / B2 (the slab spread needs
K + order - 1 <= 128, 133 here; the build line's pme_scap 0), C1 / C2
at S = 32 and K = 128, E.  The JAX script's --no-rs-kernel has no
counterpart: it works around the TPU kernel's scoped-VMEM limit at 22^3
cells, and A'' takes its shared memory by ccap alone
(ops/kernels/realspace_pair.check_half_smem).
"""

import argparse
import json
import subprocess
import time
from collections import Counter

import torch

from ..convert import cli_device
from ..md import graphs, integrators
from ..ops.kernels import _build
from . import presets

N_WATER, PME_GRID, CHUNK, STEPS = 33332, 128, 16, 64
PRECISION, STATES = "fp32", 32


def build(n_water=N_WATER, pme_grid=PME_GRID, device="cuda", seed=0,
          times=None):
    """(system, cbw, cfg, ms) of the box, fp32, state cap 32 (`times`:
    presets.build_water's)."""
    return presets.build_water(n_water, pme_grid, PRECISION, STATES,
                               seed=seed, device=device, times=times)


def flag_names(diags):
    """The JAX script's three flags, from the port's, over the chunks'
    ChunkDiagnostics `diags`."""
    def any_of(*fields):
        return any(bool(getattr(d, f).any()) for d in diags
                   for f in fields)
    return dict(nbr=any_of("neighbor_overflow", "row_overflow",
                           "rs_cell_overflow", "slab_overflow"),
                evb=any_of("evb_overflow"), force=any_of("force_overflow"))


def nvidia_smi():
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def run(build, chunk=CHUNK, steps=STEPS, log=print):
    """The probe on `build`: first chunk, then `steps` timed steps.
    Returns a dict of the numbers printed."""
    system, cbw, cfg, ms = build
    dev = ms.state.x.device
    sg = graphs.StepGraphs() if dev.type == "cuda" else None

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def scan(ms):
        return integrators.md_scan(ms, system, cbw, cfg.delta_t, "NVE",
                                   chunk, step_graphs=sg)

    sync()
    t0 = time.perf_counter()
    ms, diag = scan(ms)
    pot0 = float(diag.potential[-1])
    first_s = time.perf_counter() - t0
    log(f"first chunk (capture): {first_s:.1f} s, potential {pot0:.1f}")
    warm = flag_names([diag])
    log(f"overflow flags after warmup: {warm}")
    diags = [diag]
    before = Counter(_build.launches)
    sync()
    t0 = time.perf_counter()
    done = 0
    while done < steps:
        ms, diag = scan(ms)
        diags.append(diag)
        done += chunk
    pot = float(diag.potential[-1])
    dt = time.perf_counter() - t0
    launches = dict(Counter(_build.launches) - before)
    log(f"{done} steps in {dt:.2f} s = {done / dt:.2f} steps/s "
        f"({1000.0 * dt / done:.1f} ms/step), potential {pot:.1f}, "
        f"diabats {int(diag.n_states[-1])}")
    final = flag_names(diags)
    capacities = sorted({c for d in diags for c in d.capacities()})
    log(f"overflow flags: {final}, capacities that did not hold: "
        f"{capacities or 'none'}")
    out = dict(first_chunk_s=first_s, first_potential=pot0,
               warmup_flags=warm, steps=done, seconds=dt,
               steps_per_s=done / dt, ms_per_step=1000.0 * dt / done,
               potential=pot, diabats=int(diag.n_states[-1]),
               flags=final, capacities=capacities,
               launches=launches,
               captures=0 if sg is None else len(sg.captures))
    if dev.type == "cuda":
        out["max_memory_allocated_mib"] = \
            torch.cuda.max_memory_allocated(dev) / 2 ** 20
        log(f"max_memory_allocated {out['max_memory_allocated_mib']:.1f} "
            f"MiB")
    log(f"kernel launches in the timed steps: {launches}")
    return out, ms


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="reactive_pb_nn_md_tpu_torch.run.scale_run",
        description="Reactive steps/s of a large water box")
    ap.add_argument("n_water", nargs="?", type=int, default=N_WATER)
    ap.add_argument("pme_grid", nargs="?", type=int, default=PME_GRID)
    ap.add_argument("chunk", nargs="?", type=int, default=CHUNK)
    ap.add_argument("steps", nargs="?", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs only when "
                         "asked for)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    times = {}
    t0 = time.perf_counter()
    b = build(args.n_water, args.pme_grid, device, args.seed, times)
    system = b[0]
    build_s = time.perf_counter() - t0
    print(f"build: {system.n_atoms} atoms, {system.n_mole} molecules, "
          f"PME {system.pme_grid}^3, rs_cells {system.rs_cells}, "
          f"pme_scap {system.pme_scap}, state cap "
          f"{system.evb_max_states}, {build_s:.1f} s (system "
          f"{times['system_s']:.1f} s, set-up {times['setup_s']:.1f} s)",
          flush=True)
    out, _ = run(b, args.chunk, args.steps,
                 log=lambda m: print(m, flush=True))
    out.update(build_s=build_s, n_atoms=system.n_atoms, **times)
    if device.type == "cuda":
        out["card"] = nvidia_smi()
        print(out["card"], flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
