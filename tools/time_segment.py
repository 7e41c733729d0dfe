#!/usr/bin/env python3
"""Time kernel F (the fixed-order segment sum: its order and its sum) of
one checkout of the port on one card, at the calls of one force
evaluation of each deck:

    python3 tools/time_segment.py [--root DIR] [--decks flagship 10k 100k]

--root: the checkout whose reactive_pb_nn_md_tpu_torch is timed (default:
this repo).  Whatever the checkout, the calls are recorded by this
repo's chip_smoke.segment_calls (every F launch of one eager evaluation,
in launch order) and timed by its cuda_ms, device_ms_by_name and
graphed_device_ms, so that two versions are timed by one method: unpack
the other version's package into a git-ignored directory (git archive
<commit> reactive_pb_nn_md_tpu_torch | tar -x -C DIR) and run the two
alternately, each in its own process (other, this, this, other), in one
call on one card.

Decks (default: flagship and 10k): the equilibrated flagship
(benchdata/eq_flagship_s80.npz, small tier) and the 10k lattice at step
0 (examples/water_10k/), as chip_smoke phase 3 takes them; 100k: the
run/scale_run.py box at its set-up, as phase 14a takes it.  fp64 and
fp32 each.  Before it is timed, every call's sum is held against the
plain version on the CPU (index_add, which adds in the same order): the
bits must be equal, or the script fails.

Prints one JSON object per (deck, dtype): {"root", "deck", "dtype",
"calls", "entries", "largest": [M, n, d], "largest_ms" (cuda_ms of the
largest call), "eval_ms" (cuda_ms of all calls one after another),
"eval_graphed_ms" (their device ms from a CUDA graph of 8 evaluations
less empty kernels), "eval_device_ms", "order_device_ms", "sum_device_ms"
(torch.profiler: the sum kernel, and all else of the calls, which is the
order), "foreign_device_ms" (neither F's sum nor its order kernels: the
torch sort and search in a checkout before them), "longest_rows"}; then
nvidia-smi's name and power limit.
"""

import argparse
import importlib.util
import json
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
DECKS = ("flagship", "10k", "100k")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def deck_calls(cs, deck, dtype, scale=None):
    """chip_smoke.segment_calls of one evaluation of `deck` in `dtype`;
    scale: run/scale_run.build's result for the 100k deck."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.models import pme
    from reactive_pb_nn_md_tpu_torch.ops import neighbors
    from reactive_pb_nn_md_tpu_torch.topology import State
    dev = torch.device("cuda")
    if deck == "flagship":
        system, state, topo, meta, cbw, _ = cs.flagship(dev, dtype)
        return cs.segment_calls(system, state, topo, cbw,
                                integrators.neighbor_plan(
                                    system, state.box, meta["capacity"],
                                    react_cap=meta["react_cap"]))
    if deck == "10k":
        system, x, box, topo, _ = cs.lattice_10k(dev, dtype)
        cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                          system.alpha_sqrt, dtype=dtype)
        cap = neighbors.suggest_capacity(system.n_atoms,
                                         float(torch.det(box)),
                                         system.verlet_cutoff)
        return cs.segment_calls(
            system, State(x=x, v=torch.zeros_like(x), box=box), topo, cbw,
            integrators.neighbor_plan(system, box, cap))
    import dataclasses
    system, _, _, ms = scale
    x, box = ms.state.x.to(dtype), ms.state.box.to(dtype)
    topo = dataclasses.replace(ms.topo, charge=ms.topo.charge.to(dtype))
    cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt, dtype=dtype)
    nl = ms.nlist
    return cs.segment_calls(system, types.SimpleNamespace(x=x, box=box),
                            topo, cbw, integrators.neighbor_plan(
                                system, box, nl.capacity, nl.cells,
                                nl.react_cap, nl.react_cells))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--decks", nargs="+", choices=DECKS,
                    default=["flagship", "10k"])
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    cs = _chip_smoke()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(root))
    from reactive_pb_nn_md_tpu_torch.ops.kernels import segment_sum as ss
    if not pathlib.Path(ss.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {ss.__file__}, not the package under {root}")
    scale = None
    if "100k" in args.decks:
        from reactive_pb_nn_md_tpu_torch.run import scale_run
        scale = scale_run.build(device="cuda")
    for deck in args.decks:
        for tag, dtype in (("fp64", torch.float64),
                           ("fp32", torch.float32)):
            calls = deck_calls(cs, deck, dtype, scale)
            for src, idx, n in calls:
                cs.check(torch.equal(
                    ss.segment_sum_cuda(src, idx, n).cpu(),
                    ss.segment_sum_plain(src.cpu(), idx.cpu(), n)),
                    f"{deck} {tag}: kernel F differs from index_add on the "
                    f"CPU at M = {idx.numel()}, n = {n}")
            src, idx, n = max(calls, key=lambda c: c[1].numel())

            def every():
                return [ss.segment_sum_cuda(*c) for c in calls]

            step = cs.segment_step(calls, tag)
            row = dict(root=str(root), deck=deck, dtype=tag,
                       calls=step["calls"], entries=step["entries"],
                       largest=[int(idx.numel()), n, int(src[0].numel())],
                       largest_ms=cs.cuda_ms(
                           lambda: ss.segment_sum_cuda(src, idx, n)),
                       eval_ms=cs.cuda_ms(every),
                       eval_graphed_ms=cs.graphed_device_ms(every, n=8),
                       eval_device_ms=step["device_ms"],
                       order_device_ms=step["order_device_ms"],
                       sum_device_ms=step["kernel_device_ms"],
                       foreign_device_ms=step["foreign_device_ms"],
                       longest_rows=step["longest_rows"])
            print(json.dumps(row), flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
