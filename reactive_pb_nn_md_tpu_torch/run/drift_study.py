"""NVE drift decomposition (counterpart of the JAX package's
scripts/drift_study.py): the same flagship trajectory in several
arithmetics, reactive and non-reactive, to separate rounding drift from
the sharp-cutoff truncation drift (the physics is the same in all; only
the arithmetic differs):

    python -m reactive_pb_nn_md_tpu_torch.run.drift_study CONFIG [steps]
        [reactive|nonreactive] [equil_steps] [save=FILE] [load=FILE]
        [smax=S] [seed=N]

CONFIG is cuda-fp32, cuda-fp64, cuda-fp32-comp (fp32 state and forces,
the integrator's sums Kahan-compensated: System.compensated_sum),
cpu-fp32 or cpu-fp64; defaults 20000 steps, nonreactive, 4000
equilibration steps, smax 32, seed 0.  reactive is the flagship box (215
H2O + 1 H3O+, PME 32^3, state cap smax); nonreactive the 216-water box
with ms_evb off (run/presets.build_water).

The measurement window is preceded by equil_steps of NVE with the
velocities rescaled to 300 K after every chunk of 40; a state-cap
overflow there is tolerated (a truncated state set for a few steps of
thermalization), any other flag aborts.  save=FILE writes the state
after the equilibration, the JAX package's 13 leaves (the layout the
JAX script's _load_state asserts), and exits; load=FILE starts the
window from such a file (cast to the config's dtype, set up again at the
build's capacities), so every arithmetic runs the same initial
condition.  Flags (every capacity, the state cap, |F| > 1e4 kJ/mol/A,
kernel E's) are checked at every chunk: a drift from a truncated
trajectory means nothing, so the window stops at the first.

Prints one line:  CONFIG MODE steps=N dt_ps=... E0=... E1=... KE=...
max_states=... drift_per_ps=... drift_pct_of_KE_per_ps=...
"""

import dataclasses
import math
import sys
import time

import numpy as np
import torch

from ..convert import cli_device, load_equilibrated_npz, save_state_npz
from ..md import graphs, integrators, velocities
from ..utils.constants import KB
from . import presets

CONFIGS = ("cuda-fp32", "cuda-fp64", "cuda-fp32-comp", "cpu-fp32",
           "cpu-fp64")
MODES = ("reactive", "nonreactive")
CHUNK = 40


def parse_config(config):
    """(device, precision, compensated) of a CONFIGS name."""
    if config not in CONFIGS:
        raise SystemExit(f"unknown config {config!r}: expected one of "
                         f"{', '.join(CONFIGS)}")
    compensated = config.endswith("-comp")
    base = config[:-5] if compensated else config
    device, precision = base.split("-")
    return device, precision, compensated


def build(mode, precision, compensated=False, smax=32, seed=0,
          device="cuda"):
    """(system, cbw, cfg, ms): the flagship box (reactive, state cap
    smax) or the 216-water box with ms_evb off (nonreactive)."""
    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode!r}: expected one of "
                         f"{', '.join(MODES)}")
    if mode == "reactive":
        return presets.build_water(215, 32, precision, evb_max_states=smax,
                                   compensated=compensated, seed=seed,
                                   device=device)
    return presets.build_water(216, 32, precision, compensated=compensated,
                               msevb=False, seed=seed, device=device)


def load(build, path):
    """`build` at the (State, Topology) of `path`, cast to its dtype and set
    up again at the build's capacities (the fresh build's neighbor list
    refers to its lattice, not to the loaded configuration)."""
    system, cbw, cfg, ms = build
    state, topo, _ = load_equilibrated_npz(path, ms.state.x.device,
                                           ms.state.x.dtype)
    nl = ms.nlist
    ms = integrators.initial_md_state(state, topo, system, cbw, nl.capacity,
                                      cells=nl.cells,
                                      react_cap=nl.react_cap or None)
    return system, cbw, cfg, ms


def flags(diag, done, chunk):
    """The flags a chunk raised, each `name@step` at its first step."""
    bad = []
    for name in integrators.CAPACITY_FIELDS + ("force_overflow",
                                               "gs_failed"):
        a = getattr(diag, name)
        if bool(a.any()):
            first = int(torch.nonzero(a)[0, 0])
            bad.append(f"{name}@{done - chunk + first + 1}")
    return bad


def drift(etot, dt):
    """(steps, drift in kJ/mol/ps): a linear fit over the whole run."""
    t_ps = np.arange(1, len(etot) + 1) * dt
    return len(etot), float(np.polyfit(t_ps, etot, 1)[0])


def run(config="cuda-fp32", n_steps=20000, mode="nonreactive",
        equil_steps=4000, save=None, load_path=None, smax=32, seed=0,
        chunk=CHUNK, log=print):
    """The study of the module docstring: returns the result line's
    values as a dict (None after save=); a flag in the equilibration
    other than the state cap's exits."""
    device, precision, compensated = parse_config(config)
    device = cli_device(device)
    b = build(mode, precision, compensated, smax, seed, device)
    if load_path:
        b = load(b, load_path)
        log(f"# loaded equilibrated state from {load_path}")
    system, cbw, cfg, ms = b
    sg = graphs.StepGraphs() if device.type == "cuda" else None
    ke_target = 0.5 * (3 * int(velocities.freeze_mask(system, ms.topo)
                               .sum()) - 3) * KB * 300.0

    def scan(ms):
        return integrators.md_scan(ms, system, cbw, cfg.delta_t, "NVE",
                                   chunk, step_graphs=sg)

    t0 = time.perf_counter()
    done, ke = 0, None
    while done < equil_steps:
        ms, diag = scan(ms)
        done += chunk
        bad = flags(diag, done, chunk)
        if any(b.startswith("evb_overflow") for b in bad):
            log(f"# equil: transient {bad} (tolerated in warm-up)")
            bad = [b for b in bad if not b.startswith("evb_overflow")]
        if bad:
            raise SystemExit(f"# EQUIL OVERFLOW {bad} -- aborting")
        ke = float(diag.kinetic[-1])
        v = ms.state.v * math.sqrt(ke_target / ke)
        ms = dataclasses.replace(
            ms, state=dataclasses.replace(ms.state, v=v),
            kinetic=velocities.kinetic_energy(v, system.mass))
    if equil_steps:
        log(f"# equilibrated {done} rescaled-NVE steps, "
            f"{time.perf_counter() - t0:.0f} s, KE={ke:.1f} -> "
            f"{ke_target:.1f}")
    if save:
        save_state_npz(save, ms)
        log(f"# saved equilibrated state to {save}")
        return None

    etots, max_states = [], 0
    t0 = time.perf_counter()
    done = 0
    while done < n_steps:
        ms, diag = scan(ms)
        e = (diag.potential + diag.kinetic).double().numpy()
        etots.append(e)
        max_states = max(max_states, int(diag.n_states.max()))
        done += chunk
        bad = flags(diag, done, chunk)
        if bad or not np.isfinite(e[-1]):
            log(f"# ABORT at step {done}: flags={bad} Etot={e[-1]}")
            break
        if done % 4000 == 0:
            log(f"# {done}/{n_steps} steps, {time.perf_counter() - t0:.0f} "
                f"s, Etot={e[-1]:.3f}")
    wall = time.perf_counter() - t0
    e = np.concatenate(etots)
    steps, slope = drift(e, cfg.delta_t)
    ke = float(diag.kinetic[-1])
    return dict(config=config, mode=mode, steps=steps, dt_ps=cfg.delta_t,
                E0=float(e[0]), E1=float(e[-1]), KE=ke,
                max_states=max_states, drift_per_ps=slope,
                drift_pct_of_KE_per_ps=100.0 * slope / ke,
                steps_per_s=done / wall)


def line(r):
    """The JAX script's result line."""
    return (f"{r['config']} {r['mode']} steps={r['steps']} "
            f"dt_ps={r['dt_ps']} E0={r['E0']:.4f} E1={r['E1']:.4f} "
            f"KE={r['KE']:.1f} max_states={r['max_states']} "
            f"drift_per_ps={r['drift_per_ps']:.4f} "
            f"drift_pct_of_KE_per_ps={r['drift_pct_of_KE_per_ps']:.4f}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    pos = [a for a in argv if "=" not in a]
    opts = dict(a.split("=", 1) for a in argv if "=" in a)
    unknown = set(opts) - {"save", "load", "smax", "seed"}
    if unknown:
        raise SystemExit(f"unknown options {sorted(unknown)}")
    r = run(config=pos[0] if pos else "cuda-fp32",
            n_steps=int(pos[1]) if len(pos) > 1 else 20000,
            mode=pos[2] if len(pos) > 2 else "nonreactive",
            equil_steps=int(pos[3]) if len(pos) > 3 else 4000,
            save=opts.get("save"), load_path=opts.get("load"),
            smax=int(opts.get("smax", 32)), seed=int(opts.get("seed", 0)))
    if r is not None:
        print(line(r), flush=True)
    return r


if __name__ == "__main__":
    main()
