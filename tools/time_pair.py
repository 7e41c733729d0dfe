#!/usr/bin/env python3
"""Time the pair kernels A, A' and A'' of one checkout of the port on one
card: A at the flagship's cells (benchdata/eq_flagship_s80.npz, cells (4,
4, 4, 24), its main path), and A, A' and A'' on the 10,000-atom lattice
(examples/water_10k/, cells (10, 10, 10, 24)):

    python3 tools/time_pair.py [--root DIR] [--min-blocks N [N ...]]

--root: the checkout whose reactive_pb_nn_md_tpu_torch is timed (default:
this repo).  Whatever the checkout, the times are this repo's
chip_smoke.cuda_ms (the median of 25 runs of back-to-back launches over
their count) and chip_smoke.device_ms (the profiler's device time of a
call, every kernel summed), so that two versions are timed by one method:
unpack the other version's package into a git-ignored directory (git
archive <commit> reactive_pb_nn_md_tpu_torch | tar -x -C DIR) and run the
two alternately, each in its own process (other, this, this, other), in
one call on one card.

--min-blocks: also time A at the flagship with the checkout's
realspace_pair._FULL_MIN_BLOCKS set to each N (the blocks a launch should
at least have; parts per cell = ceil(N / 64) there), as "A@mb<N>".

Before it is timed, each kernel is held against pair_rows_plain at
chip_smoke's tolerances (fp64 1e-10 relative; fp32 TOL32's pair_g on the
per-slot gradients, pair_e on the energy sums), and two calls must give
the same bits, or the script fails.

Prints one JSON object per dtype: {"root", "dtype", "floor_device_ms",
"<kernel>": {"ms", "device_ms", "max_rel_err", "cells"}} for A (the
flagship), A@10k, A' and A'', where floor_device_ms is an empty kernel's
device_ms (chip_smoke.launch_floor_ms); then nvidia-smi's name and power
limit.
"""

import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMPLS_10K = {"full": "A@10k", "half": "A'", "column": "A''"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--min-blocks", type=int, nargs="*", default=[])
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    cs = _chip_smoke()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(root))
    from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp
    if not pathlib.Path(rsp.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {rsp.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    for tag, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        row = dict(root=str(root), dtype=tag,
                   floor_device_ms=cs.launch_floor_ms())

        def entry(name, impl, system, x, box, topo):
            cells = system.rs_cells
            slot, over = rsp.bin_atoms(x, box, cells,
                                       system.real_space_cutoff)
            cs.check(not bool(over), f"{name}: the cells overflow")
            cm = rsp.pack_cells(x, topo.charge, topo.atom_type,
                                topo.atom_mol, slot, cells)
            tabs = rsp.build_tabs(system, dtype)
            kw = dict(rcut=system.real_space_cutoff, alpha=system.alpha_sqrt,
                      has_sapt=system.has_sapt)
            ref = rsp.pair_rows_plain(cm, tabs, cells, torch.diagonal(box),
                                      **kw)

            def fn():
                return rsp.pair_rows(cm, tabs, cells, box, impl=impl, **kw)
            got = fn()
            if tag == "fp64":
                g = cs.close(got[:, :6], ref[:, :6], **cs.TOL64)
                e = cs.close(got[:, 6:].sum(0), ref[:, 6:].sum(0),
                             **cs.TOL64)
            else:
                g = cs.close(got[:, :6], ref[:, :6], **cs.TOL32["pair_g"])
                e = cs.close(got[:, 6:].double().sum(0),
                             ref[:, 6:].double().sum(0), **cs.TOL32["pair_e"])
            cs.check(g[2] and e[2], f"{name} ({tag}) disagrees with the "
                                    f"plain sweep: {g[:2]}, {e[:2]}")
            cs.check(torch.equal(got, fn()),
                     f"{name} ({tag}) differs between two calls")
            row[name] = dict(ms=cs.cuda_ms(fn), device_ms=cs.device_ms(fn),
                             max_rel_err=max(g[1], e[1]), cells=list(cells))

        system, state, topo, _, _, _ = cs.flagship(dev, dtype)
        entry("A", "full", system, state.x, state.box, topo)
        if args.min_blocks:
            keep = rsp._FULL_MIN_BLOCKS
            try:
                for mb in args.min_blocks:
                    rsp._FULL_MIN_BLOCKS = mb
                    entry(f"A@mb{mb}", "full", system, state.x, state.box,
                          topo)
            finally:
                rsp._FULL_MIN_BLOCKS = keep
        system, x, box, topo, _ = cs.lattice_10k(dev, dtype)
        for impl, name in IMPLS_10K.items():
            entry(name, impl, system, x, box, topo)
        print(json.dumps(row), flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
