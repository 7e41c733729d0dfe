#!/usr/bin/env python3
"""Time the pair kernels A, A' and A'' of one checkout of the port on one
card, on the 10,000-atom lattice (examples/water_10k/, cells (10, 10, 10,
24)):

    python3 tools/time_pair.py [--root DIR]

--root: the checkout whose reactive_pb_nn_md_tpu_torch is timed (default:
this repo).  Whatever the checkout, the times are this repo's
chip_smoke.cuda_ms (the median of 25 runs of back-to-back launches over
their count) and chip_smoke.device_ms (the profiler's device time of a
call, every kernel summed), so that two versions are timed by one method:
unpack the other version's package into a git-ignored directory (git
archive <commit> reactive_pb_nn_md_tpu_torch | tar -x -C DIR) and run the
two alternately, each in its own process (other, this, this, other), in
one call on one card.

Before it is timed, each kernel is held against pair_rows_plain at
chip_smoke's tolerances (fp64 1e-10 relative; fp32 TOL32's pair_g on the
per-slot gradients, pair_e on the energy sums), or the script fails.

Prints one JSON object per dtype: {"root", "dtype", "cells", "<kernel>":
{"ms", "device_ms", "max_rel_err"}} for A, A' and A''; then nvidia-smi's
name and power limit.
"""

import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMPLS = {"full": "A", "half": "A'", "column": "A''"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
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
        system, x, box, topo, _ = cs.lattice_10k(dev, dtype)
        cells = system.rs_cells
        slot, over = rsp.bin_atoms(x, box, cells, system.real_space_cutoff)
        cs.check(not bool(over), "the 10k lattice overflows its cells")
        cm = rsp.pack_cells(x, topo.charge, topo.atom_type, topo.atom_mol,
                            slot, cells)
        tabs = rsp.build_tabs(system, dtype)
        kw = dict(rcut=system.real_space_cutoff, alpha=system.alpha_sqrt,
                  has_sapt=system.has_sapt)
        ref = rsp.pair_rows_plain(cm, tabs, cells, torch.diagonal(box), **kw)
        row = dict(root=str(root), dtype=tag, cells=list(cells))
        for impl, name in IMPLS.items():
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
            row[name] = dict(ms=cs.cuda_ms(fn), device_ms=cs.device_ms(fn),
                             max_rel_err=max(g[1], e[1]))
        print(json.dumps(row), flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
