#!/usr/bin/env python3
"""Time kernels C1 and C2 (the per-state reciprocal energies and their
backward) of one checkout of the port on one card:

    python3 tools/time_perstate.py [--root DIR] [--parts]

--root: the checkout whose reactive_pb_nn_md_tpu_torch is timed (default:
this repo).  Whatever the checkout, the times are this repo's
chip_smoke.cuda_ms (the median of 25 runs of back-to-back launches over
their count), so that two versions of the kernels are timed by one
method: unpack the other version's package into a git-ignored directory
(git archive <commit> reactive_pb_nn_md_tpu_torch | tar -x -C DIR) and
run the two alternately, each in its own process (other, this, this,
other), in one call on one card.

Shapes: the flagship's S = 48 and 80 (K = 32, U = 4 S) and the 10k box's
(S = 32, K = 64, U = 128), fp64 and fp32, inputs made with numpy from a
seed.  Before it is timed, each kernel is held against perstate_plain:
max |got - ref| over max |ref| at most 1e-10 in fp64, 5e-5 (C1) and 2e-3
(C2) in fp32, or the script fails.

--parts: C2's device microseconds per call by part, by torch.profiler,
labelled by the names of the kernels in this repo's
csrc/recip_perstate.cu (PARTS); a kernel with none of these names is
counted under its own name, so none is lost.

Prints one JSON object per (dtype, shape): {"root", "dtype", "shape",
"c1_ms", "c2_ms", "c1_err", "c2_err"} and, with --parts,
"c2_parts_us"; then nvidia-smi's name and power limit.
"""

import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {"S48": (48, 192, 32), "S80": (80, 320, 32), "10k": (32, 128, 64)}
TOL = {"fp64": (1e-10, 1e-10), "fp32": (5e-5, 2e-3)}     # C1, C2
# C2's kernels by a name each owns (first match): its products and sums
PARTS = (("w_kernel", "W"), ("DGEpi", "G->dG"), ("DWEpi", "dW"),
         ("DBCEpi", "dBC"), ("fold_kernel", "folds"), ("DdqTerm", "ddq"),
         ("DaTerm", "dA"), ("Df0Term", "dF0"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(S, U, K, dtype, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    Mh = K * (K // 2 + 1)
    vals = [rng.standard_normal(s) for s in ((S, U), (K, U), (K, U), (U, Mh),
                                             (U, Mh), (K, Mh), (K, Mh))]
    vals.append(rng.uniform(0, 1, (K, Mh)))
    ins = [torch.tensor(v, dtype=dtype, device="cuda") for v in vals]
    return ins, torch.tensor(rng.standard_normal(S), dtype=dtype,
                             device="cuda")


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def c2_parts(fn, calls=10):
    """Device microseconds of each part of one fn() call, over `calls`
    calls the profile holds (each launches W once), or None if the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts, seen = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us <= 0:
            continue
        label = next((lab for key, lab in PARTS if key in e.key), e.key)
        parts[label] = parts.get(label, 0.0) + us
        seen += e.count if label == "W" else 0
    return {k: v / seen for k, v in parts.items()} if seen else None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--parts", action="store_true")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    cs = _chip_smoke()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(root))
    from reactive_pb_nn_md_tpu_torch.ops.kernels import recip_perstate as rp
    if not pathlib.Path(rp.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {rp.__file__}, not the package under {root}")
    for tag, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        for shape, (S, U, K) in SHAPES.items():
            ins, gbar = _inputs(S, U, K, dtype, seed=S + U + K)
            e1 = _rel(rp.perstate_fwd_cuda(*ins), rp.perstate_plain(*ins))
            leaves = [t.clone().requires_grad_(i < 7)
                      for i, t in enumerate(ins)]
            ref = torch.autograd.grad(
                (rp.perstate_plain(*leaves) * gbar).sum(), leaves[:7])
            e2 = max(_rel(a, b) for a, b in zip(
                rp.perstate_bwd_cuda(gbar, *ins), ref))
            cs.check(e1 <= TOL[tag][0] and e2 <= TOL[tag][1],
                     f"{tag} {shape}: C1 err {e1:.3e}, C2 err {e2:.3e}")
            row = dict(root=str(root), dtype=tag, shape=shape,
                       c1_ms=cs.cuda_ms(lambda: rp.perstate_fwd_cuda(*ins)),
                       c2_ms=cs.cuda_ms(
                           lambda: rp.perstate_bwd_cuda(gbar, *ins)),
                       c1_err=e1, c2_err=e2)
            if args.parts:
                row["c2_parts_us"] = c2_parts(
                    lambda: rp.perstate_bwd_cuda(gbar, *ins))
            print(json.dumps(row), flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
