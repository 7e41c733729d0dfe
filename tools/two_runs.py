#!/usr/bin/env python3
"""Two runs of one deck from one state on one card, every step's x, v and
Etot compared bit for bit:

    python3 tools/two_runs.py [--root DIR] [--against DIR]

Configurations (chip_smoke.py phase 16 runs the same ones and fails
where two runs part): the equilibrated flagship (benchdata/
eq_flagship_s80.npz), 100 graphed steps NVE fp64 and fp32 and NVT fp32
(one generator seed for both runs); the committed equilibrated 10k state
(reactive_pb_nn_md_tpu_torch/data/eq_10k_s32.npz), 64 fp32 NVE steps;
4 flagship umbrella windows batched (chip_smoke's 12b ladder), 32 fp64
NVT steps; the flagship with the (OW, O_h3o, H_h3o) triple switched to
a type-3 MLP, 64 fp32 NVE steps.  Each run captures its own graph and
steps one md_scan chunk a step.

--root: the checkout whose package and chip_smoke.py run (default: this
repo; an older one, unpacked with `git archive`, shows where its runs
parted).  Prints one line a configuration: the first step where the two
runs differ (None: equal at every step) and the largest differences;
then nvidia-smi's name and power limit.

--against DIR: instead, one run of each configuration in the checkout
--root and one in the checkout at DIR (an older one, unpacked with `git
archive`), each checkout in its own process (`--dump FILE` saves a
process's runs), every step's x, v and Etot compared bit for bit across
the two: a change that keeps the step's bits shows None everywhere.
"""

import argparse
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
DET_STEPS, DET_10K_STEPS, DET_BATCH_STEPS, DET_NN_STEPS = 100, 64, 32, 64


def stepwise(ms, n, scan):
    """n steps from ms, one chunk a step (scan(ms) -> (ms, diag)): every
    step's x, v and Etot, copied (a chunk's outputs are the captured
    graph's buffers); raises on a capacity flag."""
    rows = []
    for i in range(n):
        ms, diag = scan(ms)
        if diag.capacities():
            raise RuntimeError(f"{diag.capacities()} at step {i}")
        rows.append((ms.state.x.clone(), ms.state.v.clone(),
                     (diag.kinetic + diag.potential).clone()))
    return rows


def compare(a, b):
    """(first step where the runs a and b differ or None, max |dx|,
    max |dv|, max |dEtot|) of two stepwise() results."""
    import torch
    first = next((i for i, (p, q) in enumerate(zip(a, b))
                  if not all(torch.equal(u, w) for u, w in zip(p, q))),
                 None if len(a) == len(b) else min(len(a), len(b)))
    return (first,) + tuple(max(float((p[k] - q[k]).abs().max())
                                for p, q in zip(a, b)) for k in range(3))


def configurations(cs, tmp, nn):
    """[(name, run)]: run() gives one run's stepwise() rows; cs is the
    chip_smoke module of the checkout, tmp a directory for the deck
    copies, nn the type-3 MLP (an MLP dict on the CPU)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md import graphs, integrators
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    from reactive_pb_nn_md_tpu_torch.run import presets

    def flagship(tag, ens, n, mutate=None):
        dtype = torch.float64 if tag == "fp64" else torch.float32
        sim = cs.eq_sim(tmp / f"{tag}_{ens}_{mutate is not None}", dtype,
                        cs.NVT_DECK if ens == "NVT" else "")
        if mutate is not None:
            sim.mutate_system(mutate)
        system, cbw, dt, _, fr, temp = cs.scan_args(sim, ens)

        def run():
            gen = torch.Generator(device="cuda")
            gen.manual_seed(16)
            sg = graphs.StepGraphs()
            return stepwise(sim.ms, n, lambda m: integrators.md_scan(
                m, system, cbw, dt, ens, 1, fr, temp, generator=gen,
                step_graphs=sg))
        return run

    def tenk():
        system, cbw, cfg, ms = presets.equilibrated(
            presets.build_water(3332, 64, "fp32", 32, device="cuda"),
            cs.ROOT / "reactive_pb_nn_md_tpu_torch" / "data"
            / "eq_10k_s32.npz")

        def run():
            sg = graphs.StepGraphs()
            return stepwise(ms, DET_10K_STEPS, lambda m: integrators.md_scan(
                m, system, cbw, cfg.delta_t, "NVE", 1, step_graphs=sg))
        return run

    def batch():
        W = cs.BATCH_W
        system, cbw, ladder, bt = cs.batch_windows(torch.float64, W, "NVT")
        bias = ensemble.window_slice(ladder, 0, W)
        bms = integrators.stack_states(bt.states)

        def run():
            gens = [torch.Generator(device="cuda") for _ in range(W)]
            for g, st in zip(gens, bt.generators):
                g.set_state(st)
            sg = graphs.StepGraphs()
            return stepwise(bms, DET_BATCH_STEPS,
                            lambda m: integrators.md_scan(
                                m, system, cbw, 0.0005, "NVT", 1,
                                cs.LADDER["friction"],
                                cs.LADDER["temperature"], generator=gens,
                                step_graphs=sg, bias=bias))
        return run

    return [("flagship NVE fp64", flagship("fp64", "NVE", DET_STEPS)),
            ("flagship NVE fp32", flagship("fp32", "NVE", DET_STEPS)),
            ("flagship NVT fp32", flagship("fp32", "NVT", DET_STEPS)),
            ("10k state NVE fp32", tenk()),
            (f"{cs.BATCH_W} flagship windows batched NVT fp64", batch()),
            ("flagship type 3 NVE fp32", flagship(
                "fp32", "NVE", DET_NN_STEPS,
                mutate=cs.attach_mlp(nn, torch.float32)))]


def seeded_mlp(cs):
    """A type-3 MLP for the flagship triple from torch seed 1 (random
    weights; the analytic row's Vconst)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp
    system = cs.flagship(torch.device("cuda"), torch.float32)[0]
    names = system.ff.atype_names
    row = system.evb.cpl_params[tuple(names.index(n) for n in cs.NN_TRIPLE)]
    return coupling_mlp.init_mlp(torch.Generator().manual_seed(1),
                                 vconst=float(row[0]), dtype=torch.float32,
                                 device="cpu", n_env=cs.NN_ENV)


def run_once(root, path):
    """Each configuration of the checkout at `root` run once, its
    stepwise() rows saved to `path` (torch.save: {name: rows on the
    CPU})."""
    import torch
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    _build.library()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in configurations(cs, pathlib.Path(tmp),
                                        seeded_mlp(cs)):
            runs[name] = [tuple(t.cpu() for t in row) for row in run()]
    torch.save(runs, path)


def against(root, other):
    """--against: one process a checkout (this script's --dump), their
    runs compared configuration by configuration."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for tree in (root, other):
            path = pathlib.Path(tmp) / f"{len(files)}.pt"
            subprocess.run([sys.executable, __file__, "--root", str(tree),
                            "--dump", str(path)], check=True)
            files.append(torch.load(path, weights_only=True))
        mine, theirs = files
        for name, rows in mine.items():
            first, dx, dv, de = compare(rows, theirs[name])
            print(f"{root.name} against {other.name}, {name}: first step "
                  f"apart {first}, max|dx| {dx:.3e} A, max|dv| {dv:.3e}, "
                  f"max|dEtot| {de:.3e} kJ/mol", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=str(ROOT),
                   help="the checkout to run (default: this repo)")
    p.add_argument("--against", default=None,
                   help="a checkout to compare --root's runs with")
    p.add_argument("--dump", default=None,
                   help="run each configuration once and save the runs")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("two_runs: no CUDA device", file=sys.stderr)
        return 1
    root = pathlib.Path(args.root).resolve()
    if args.dump:
        run_once(root, args.dump)
        return 0
    if args.against:
        against(root, pathlib.Path(args.against).resolve())
        sys.path.insert(0, str(root))
        import chip_smoke as cs
        print(cs.nvidia_smi())
        return 0
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    _build.library()
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in configurations(cs, pathlib.Path(tmp),
                                        seeded_mlp(cs)):
            first, dx, dv, de = compare(run(), run())
            print(f"{root.name} {name}: first step apart {first}, max|dx| "
                  f"{dx:.3e} A, max|dv| {dv:.3e}, max|dEtot| {de:.3e} "
                  f"kJ/mol", flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
