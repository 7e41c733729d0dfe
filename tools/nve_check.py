#!/usr/bin/env python3
"""Repeated NVE runs from the equilibrated flagship on one card, to find
where and why the total energy jumps:

    python3 tools/nve_check.py [--root DIR] [--runs N] [--steps N]
                               [--dtype fp32|fp64] [--jump KJ] [--save DIR]

Each run goes through the simulation loop from benchdata/
eq_flagship_s80.npz as chip_smoke's phase 6 does, in chunks of one step
(chip_smoke.eq_sim's set-up), recording every step's Etot, diabat count, hydronium molecule
and max |F|.  The step is reproducible bit for bit (every sum in a
fixed order: the kernels' and kernel F's for the gradients of the
gathers on positions), so runs from one state agree; --root runs an
older checkout, whose runs differ.  For every
step whose |Etot change| exceeds --jump kJ/mol (default 5), the
positions before and after it are evaluated again in fp64
(evaluate_forces on the positions in fp64, with the fp64 system and the
run's capacities): a gap between a run's potential and the fp64 one at
the same positions is a fault of the evaluation in that precision; equal
potentials mean that the dynamics itself jumped.

--root: the checkout whose reactive_pb_nn_md_tpu_torch runs (default:
this repo).  --save: write the state after each jump (positions,
velocities, box and topology, the run's capacities) to
DIR/jump_<run>_<step>.npz.  Prints one line per run (Etot(200) - Etot(0), Etot(last) -
Etot(0), hops, jumps) and one per jump; then nvidia-smi's name and power
limit.
"""

import argparse
import dataclasses
import importlib.util
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--dtype", choices=("fp32", "fp64"), default="fp32")
    ap.add_argument("--jump", type=float, default=5.0)
    ap.add_argument("--save", default=None)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    cs = _chip_smoke()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(root))
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    from reactive_pb_nn_md_tpu_torch.ops import neighbors
    if not pathlib.Path(integrators.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {integrators.__file__}, not the package under "
                 f"{root}")
    dev = torch.device("cuda")
    dtype = torch.float32 if args.dtype == "fp32" else torch.float64
    sys64, _, _, _, cbw64, _ = cs.flagship(dev, torch.float64)

    def fp64_eval(sim, ms):
        """(potential, n_states, max|F|) of ms's positions in fp64."""
        x, box = ms.state.x.double(), ms.state.box.double()
        topo = dataclasses.replace(ms.topo, charge=ms.topo.charge.double())
        system = sys64.replace(evb_max_states=sim.system.evb_max_states)
        nl = neighbors.build_neighbors(x, box, **integrators.neighbor_plan(
            system, box, sim.capacity, react_cap=sim.react_cap))
        fe = integrators.evaluate_forces(x, box, topo, system, nl, cbw64)
        return (float(fe.potential), int(fe.n_states),
                float(fe.force.abs().max()))

    def save(sim, ms, path):
        import numpy as np
        path.parent.mkdir(parents=True, exist_ok=True)
        arrays = {f"topo_{f.name}": getattr(ms.topo, f.name).cpu().numpy()
                  for f in dataclasses.fields(ms.topo)}
        np.savez(path, x=ms.state.x.cpu().numpy(),
                 v=ms.state.v.cpu().numpy(), box=ms.state.box.cpu().numpy(),
                 force=ms.force.cpu().numpy(), capacity=sim.capacity,
                 react_cap=sim.react_cap or 0,
                 evb_max_states=sim.system.evb_max_states, **arrays)

    with tempfile.TemporaryDirectory() as tmp:
        for run in range(args.runs):
            system, state, topo, meta, cbw, _ = cs.flagship(dev, dtype)
            sim = Simulation(*cs.deck_copy(pathlib.Path(tmp) / str(run),
                                           cs.DECK, args.dtype),
                             device="cuda")
            sim.system, sim.cbw = system, cbw
            sim.capacity, sim.react_cap = meta["capacity"], meta["react_cap"]
            sim._init_state(state, topo)
            etot = [float(sim.ms.kinetic + sim.ms.potential)]
            hops, jumps = 0, []
            for k in range(args.steps):
                prev = sim.ms
                diag, _, last = sim._chunk(k, 1)
                cs.check(not last, f"the run ended at step {k + 1}: "
                                   f"{sim._log_lines[-1:]}")
                ms = sim.ms
                hops += int(diag.hopped[0])
                etot.append(float(ms.kinetic + ms.potential))
                if abs(etot[-1] - etot[-2]) > args.jump:
                    if args.save:
                        save(sim, ms, pathlib.Path(args.save)
                             / f"jump_{run}_{k + 1}.npz")
                    p0, n0, f0 = fp64_eval(sim, prev)
                    p1, n1, f1 = fp64_eval(sim, ms)
                    jumps.append(
                        f"    step {k + 1}: dEtot {etot[-1] - etot[-2]:+.3f}"
                        f" (dPE {float(ms.potential - prev.potential):+.3f},"
                        f" dKE {float(ms.kinetic - prev.kinetic):+.3f}); "
                        f"hopped {bool(diag.hopped[0])}; diabats "
                        f"{int(prev.n_states)}"
                        f" -> {int(ms.n_states)}; hydronium "
                        f"{int(prev.topo.hydronium_mol)} -> "
                        f"{int(ms.topo.hydronium_mol)}; max|F| "
                        f"{float(prev.force.abs().max()):.1f} -> "
                        f"{float(ms.force.abs().max()):.1f}; PE run "
                        f"{float(prev.potential):.3f} -> "
                        f"{float(ms.potential):.3f}, fp64 at the same "
                        f"positions {p0:.3f} -> {p1:.3f} (diabats {n0} -> "
                        f"{n1}, max|F| {f0:.1f} -> {f1:.1f})")
            d = [e - etot[0] for e in etot]
            i200 = min(200, args.steps)
            print(f"run {run} {args.dtype}: Etot({i200}) - Etot(0) "
                  f"{d[i200]:+.3f}, Etot({args.steps}) - Etot(0) "
                  f"{d[-1]:+.3f}, max|Etot - Etot0| "
                  f"{max(map(abs, d)):.3f}, {hops} hops, {len(jumps)} "
                  f"jumps > {args.jump} kJ/mol", flush=True)
            for j in jumps:
                print(j, flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
