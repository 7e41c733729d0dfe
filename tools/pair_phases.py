#!/usr/bin/env python3
"""Where kernel A'' spends its time, by phase, on one card:

    python3 tools/pair_phases.py [--out DIR]

Copies this repo's reactive_pb_nn_md_tpu_torch to DIR (default: the
git-ignored build/pair_phases), adds clock reads to the copy's
rs_half_cell_kernel (csrc/realspace_pair.cu) at the ends of its phases,
builds that copy and runs A'' on the 10,000-atom lattice (examples/
water_10k/, cells (10, 10, 10, 24)), fp64 and fp32.  The package itself
is not changed.  The patch finds its places by the source's own lines
and fails if they moved.

Prints, per dtype, the mean and max SM cycles a block spends in each
phase (stage: the 14 cells into shared memory; filter: the candidate
tests and list appends; flush: half_flush, the pair math and the sums;
out: the own and part writes), the launch's wall span and the blocks
resident on average (the blocks' summed wall time over the span, from
%globaltimer), the filter passes, atoms per cell and stencil, and the
blocks each SM ran; then nvidia-smi's name and power limit.
"""

import argparse
import ctypes
import importlib.util
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX_BLOCKS = 16384

# (anchor in the kernel source, text put after it)
PATCH = [
    ("#define PAIR_LIST 256               // pairs one flush evaluates\n",
     f"__device__ long long g_phase[{MAX_BLOCKS}][10];\n"
     "__device__ __forceinline__ long long wall_ns() {\n"
     "    long long t;\n"
     '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "    return t;\n}\n"),
    ("    const size_t C8 = (size_t)nc1 * nc2 * nc3 * ccap;\n",
     "    const long long T0 = clock64(), W0 = wall_ns();\n"
     "    long long TF = 0;\n"),
    ("    const PairConst<T> P = pair_const(stab, box, T_, has_sapt, rcut2, "
     "alpha,\n                                      conv);\n\n"
     "    // filter in key order",
     None),
    ("        if (L + tot > PAIR_LIST) {                      "
     "// block-uniform\n",
     "            const long long a = clock64();\n"),
    ("            half_flush(S, L, Nj, P);\n            L = 0;\n",
     "            TF += clock64() - a;\n"),
]


def patch(src):
    s = src.read_text()
    for anchor, add in PATCH:
        if s.count(anchor) != 1:
            sys.exit(f"{src}: the line {anchor.splitlines()[0]!r} moved")
        if add is None:           # the clock after staging, before filter
            s = s.replace(anchor, anchor.replace(
                "\n\n    // filter in key order",
                "\n    const long long T1 = clock64();\n"
                "\n    // filter in key order"))
        else:
            s = s.replace(anchor, anchor + add)
    tail = ("    __syncthreads();\n    if (L > 0) half_flush(S, L, Nj, P);\n")
    out_end = ("            dst[q] = n < 0 ? (T)0 : S.jacc[n * 6 + q % 6];\n"
               "        }\n    }\n}\n")
    for anchor in (tail, out_end):
        if s.count(anchor) != 1:
            sys.exit(f"{src}: the line {anchor.splitlines()[1]!r} moved")
    s = s.replace(tail, "    __syncthreads();\n"
                        "    const long long T2 = clock64();\n"
                        "    if (L > 0) half_flush(S, L, Nj, P);\n"
                        "    const long long T3 = clock64();\n")
    s = s.replace(out_end, out_end[:-2] + (
        f"    if (tid == 0 && c < {MAX_BLOCKS}) {{\n"
        "        unsigned sm;\n"
        '        asm("mov.u32 %0, %%smid;" : "=r"(sm));\n'
        "        long long* g = g_phase[c];\n"
        "        g[0] = T1 - T0; g[1] = T2 - T1 - TF; g[2] = TF + T3 - T2;\n"
        "        g[3] = clock64() - T3; g[4] = n0; g[5] = Nj; g[6] = sm;\n"
        "        g[7] = W0; g[8] = wall_ns(); g[9] = pass;\n    }\n}\n"))
    s += ("\nKERNELS_API int rs_phases(void* dst, int n) {\n"
          "    return (int)cudaMemcpyFromSymbol(dst, g_phase,\n"
          "                                     (size_t)n * 10 * "
          "sizeof(long long));\n}\n")
    src.write_text(s)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "pair_phases"))
    args = ap.parse_args()
    out = pathlib.Path(args.out).resolve()
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "reactive_pb_nn_md_tpu_torch",
                    out / "reactive_pb_nn_md_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    patch(out / "reactive_pb_nn_md_tpu_torch" / "csrc" / "realspace_pair.cu")
    cs = _chip_smoke()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(out))
    from reactive_pb_nn_md_tpu_torch.ops.kernels import (
        _build, realspace_pair as rsp)
    fn = _build.library().rs_phases
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for tag, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        system, x, box, topo, _ = cs.lattice_10k(torch.device("cuda"), dtype)
        cells = system.rs_cells
        slot, over = rsp.bin_atoms(x, box, cells, system.real_space_cutoff)
        cs.check(not bool(over), "the 10k lattice overflows its cells")
        cm = rsp.pack_cells(x, topo.charge, topo.atom_type, topo.atom_mol,
                            slot, cells)
        tabs = rsp.build_tabs(system, dtype)
        for _ in range(3):
            rsp.pair_rows(cm, tabs, cells, box, system.real_space_cutoff,
                          system.alpha_sqrt, system.has_sapt, impl="column")
        torch.cuda.synchronize()
        n = min(cells[0] * cells[1] * cells[2], MAX_BLOCKS)
        a = np.zeros((n, 10), dtype=np.int64)
        _build.check(fn(a.ctypes.data, n), "rs_phases")
        ph = a[:, :4].astype(float)
        span = (a[:, 8].max() - a[:, 7].min()) / 1e3
        per_sm = np.bincount(a[:, 6])
        print(f"{tag}: cycles a block, stage / filter / flush / out: mean "
              f"{ph.mean(0).round(0).tolist()}, max "
              f"{ph.max(0).round(0).tolist()}; launch wall {span:.3f} us, "
              f"blocks resident {(a[:, 8] - a[:, 7]).sum() / 1e3 / span:.1f}"
              f"; filter passes {a[:, 9].mean():.2f}; atoms a cell "
              f"{a[:, 4].mean():.2f}, a stencil {a[:, 5].mean():.2f}; blocks "
              f"an SM {per_sm[per_sm > 0].min()}-{per_sm.max()}", flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
