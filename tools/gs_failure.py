#!/usr/bin/env python3
"""Where kernel E gives up on a softened surface: the Hamiltonian it did
not solve, and eigh on the same matrix.

    python3 tools/gs_failure.py [--scales 3.0 0.4 0.4 0.6] [--steps 512]
        [--seed 23] [--temp 300] [--out build/gs_failure]

Runs run/spontaneous_hops.py's NVT window (the equilibrated flagship,
fp32, state cap 80, its surface softened by --scales = (coupling, da, pa,
c12), fresh velocities from --seed, Langevin 1 / ps at --temp) in chunks
of 128 graphed steps.  At the first chunk where kernel E did not converge
(integrators.GroundStateError) the chunk is run again from its start and
generator state, eagerly and one step at a time, every call of the
ground state watched: the first Hamiltonian on which E reports failure
is written to OUT/gs_fail.npz with the positions and velocities before
that step.  Printed: each replayed step's potential, kinetic energy,
diabat count, largest c_i^2 and largest |F| up to the failure; then, on
the saved H, whether it is finite, its largest |entry|, E's info on it
(in its own dtype and in fp64), and eigh's (fp64, of H - H00 I) lowest
eigenvalues and ground gap.  One JSON line at the end holds the same
numbers; then nvidia-smi's name and power limit.
"""

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", type=float, nargs=4,
                    default=(3.0, 0.4, 0.4, 0.6))
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--temp", type=float, default=300.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "gs_failure"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
    from reactive_pb_nn_md_tpu_torch.md import graphs, integrators
    from reactive_pb_nn_md_tpu_torch.ops import ground_state as gs
    from reactive_pb_nn_md_tpu_torch.run import spontaneous_hops as sh

    dev = torch.device("cuda")
    chunk, friction = 128, 1.0
    system, cbw, cfg, ms = sh.build_softened(tuple(args.scales), args.temp,
                                             args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(
        int(np.random.SeedSequence([args.seed, 1]).generate_state(1)[0]))
    sg = graphs.StepGraphs()
    caps = integrators.capacities_of(ms)
    done, failure = 0, None
    while done < args.steps:
        start = (ms, gen.get_state(), system)
        try:
            r = integrators.regrown_chunk(
                ms, system, cbw, caps, cfg.evb_hard_max_states, cfg.delta_t,
                "NVT", chunk, friction, args.temp, generator=gen,
                step_graphs=sg, tolerate=(integrators.EVB_STATE_CAP,))
        except integrators.GroundStateError as e:
            failure = str(e)
            break
        ms, system, caps = r.ms, r.system, r.caps
        done += chunk
    print(f"scales {list(args.scales)} seed {args.seed}: "
          f"{failure or f'no failure in {done} steps'}", flush=True)
    out = {"scales": list(args.scales), "seed": args.seed,
           "graphed_failure": failure, "steps_before_chunk": done}
    if failure is not None:
        out.update(replay(start, cbw, cfg, gen, chunk, friction, args,
                          ham, integrators, gs, torch))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    print(out["card"])


def replay(start, cbw, cfg, gen, chunk, friction, args, ham, integrators,
           gs, torch):
    """The failed chunk again from `start`, eager, a step at a time, the
    ground state watched; the saved H and what eigh makes of it."""
    ms, gen_state, system = start
    gen.set_state(gen_state)
    real = ham.ground_state
    seen = []

    def watch(H):
        lam, c, failed = real(H)
        if not seen and bool(failed):
            seen.append(H.detach().clone())
        return lam, c, failed

    ham.ground_state = watch
    rows, before = [], None
    try:
        for k in range(chunk):
            before = ms
            ms, d = integrators.md_scan(ms, system, cbw, cfg.delta_t, "NVT",
                                        1, friction, args.temp,
                                        generator=gen, eager=True)
            row = dict(step=int(ms.state.step),
                       potential=float(d.potential[0]),
                       kinetic=float(d.kinetic[0]),
                       n_states=int(d.n_states[0]),
                       max_ci2=float(d.max_ci2[0]),
                       max_force=float(ms.force.abs().max()),
                       gs_failed=bool(d.gs_failed[0]))
            rows.append(row)
            print("  " + json.dumps(row), flush=True)
            if seen:
                break
    finally:
        ham.ground_state = real
    res = {"eager_rows": rows, "eager_failed": bool(seen)}
    if not seen:
        return res
    H = seen[0]
    pathlib.Path(args.out).mkdir(parents=True, exist_ok=True)
    path = pathlib.Path(args.out) / "gs_fail.npz"
    np.savez(path, H=H.cpu().numpy(), x=before.state.x.cpu().numpy(),
             v=before.state.v.cpu().numpy(),
             box=before.state.box.cpu().numpy(), step=rows[-1]["step"])
    Hd = H.double().cpu()
    finite = bool(torch.isfinite(Hd).all())
    res.update(saved=str(path), S=H.shape[0], dtype=str(H.dtype),
               finite=finite,
               max_abs_entry=float(Hd.abs().max()) if finite else None)
    _, _, info = gs.ground_state_cuda(H.contiguous())
    _, _, info64 = gs.ground_state_cuda(H.double().contiguous())
    res.update(e_info=int(info), e_info_fp64=int(info64))
    if finite:
        A = Hd - Hd[0, 0] * torch.eye(Hd.shape[0], dtype=torch.float64)
        w = torch.linalg.eigvalsh(A)
        res.update(eigh_lowest=[float(v) for v in w[:4]],
                   lambda0=float(w[0] + Hd[0, 0]),
                   ground_gap=float(w[1] - w[0]),
                   h00=float(Hd[0, 0]))
    print(f"  saved H ({H.shape[0]}x{H.shape[0]}, {H.dtype}) at step "
          f"{rows[-1]['step']}: finite {finite}, E info {int(info)} "
          f"(fp64 {int(info64)}); eigh: {res.get('eigh_lowest')}, gap "
          f"{res.get('ground_gap')}", flush=True)
    return res


if __name__ == "__main__":
    main()
