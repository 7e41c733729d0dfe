#!/usr/bin/env python3
"""Where kernel A spends its time, by phase, on one card:

    python3 tools/full_phases.py [--root DIR] [--out DIR] [--min-blocks N]

Copies the reactive_pb_nn_md_tpu_torch of --root (default: this repo) to
--out (default: the git-ignored build/full_phases), adds clock reads to
the copy's rs_full_kernel (csrc/realspace_pair.cu) at the ends of its
phases, builds that copy and runs A at the flagship's cells (benchdata/
eq_flagship_s80.npz, cells (4, 4, 4, 24)), fp64 and fp32.  The package
itself is not changed.  The patch finds its places by the source's own
lines and fails if they moved.  --min-blocks sets the copy's
realspace_pair._FULL_MIN_BLOCKS (its parts a cell) before the run.

Prints, per dtype, the mean and max SM cycles a block spends in each
phase (stage: the 27 cells' slots into shared memory; list: the counts,
scan and occupied list; items: the filter and pair math of its atoms;
out: the rows), the launch's wall span and the blocks resident on
average (the blocks' summed wall time over the span, from
%globaltimer), the atoms a block and a cell's stencil, the blocks each
SM ran, and warp 0's item cycles split into the filter loop (with its
full flushes), the last flush and the sums; then the phases' mean
cycles of the blocks on SMs that ran 1, 2, ... blocks; then
nvidia-smi's name and power limit.
"""

import argparse
import ctypes
import importlib.util
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX_BLOCKS = 16384

NF = 13                         # values recorded a block

# (anchor in the kernel source, text put after it)
PATCH = [
    ("#define FULL_RING 256               // a warp's survivor ring "
     "(> 31 + 32 ILP)\n",
     f"__device__ long long g_fphase[{MAX_BLOCKS}][{NF}];\n"
     "__device__ __forceinline__ long long fwall_ns() {\n"
     "    long long t;\n"
     '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "    return t;\n}\n"),
    ("    const int n_tabv = n_tab * T_ * T_, N = 27 * ccap, NW = (N + 31) "
     ">> 5;\n",
     "    const long long T0 = clock64(), W0 = fwall_ns();\n"),
    ("            if (lane == 0 && w < NW) occw[w] = bal;\n        }\n    }\n"
     "    __syncthreads();\n",
     "    const long long T1 = clock64();\n"),
    ("        Nj += __shfl_sync(0xffffffffu, incl, 31);\n    }\n"
     "    __syncthreads();\n",
     "    const long long T2 = clock64();\n"),
    ("        if (lane < 8) prow[item * 8 + lane] = v;\n    }\n"
     "    __syncthreads();\n",
     "    const long long T3 = clock64();\n"),
    ("    int* rg = ring + warp * FULL_RING;\n",
     "    long long TI[3] = {0, 0, 0};\n"),
    ("        int head = 0, nq = 0;\n",
     "        const long long I0 = clock64();\n"),
    ("        if (lane < nq) add(rg[(head + lane) & (FULL_RING - 1)]);\n",
     "        const long long I2 = clock64();\n"),
    ("        if (lane < 8) prow[item * 8 + lane] = v;\n",
     "        if (warp == 0) {\n"
     "            TI[0] += I1 - I0;\n"
     "            TI[1] += I2 - I1;\n"
     "            TI[2] += clock64() - I2;\n"
     "        }\n"),
]
# the clock before the last flush goes in front of its line
BEFORE = ("        if (lane < nq) add(rg[(head + lane) & (FULL_RING - 1)]);\n",
          "        const long long I1 = clock64();\n")
END = "            if (smol[e >> 3] < 0) orow[e] = (T)0;\n}\n"


def patch(src):
    s = src.read_text()
    for anchor, _ in PATCH + [(END, "")]:
        if s.count(anchor) != 1:
            sys.exit(f"{src}: the line {anchor.splitlines()[0]!r} moved")
    for anchor, add in PATCH:
        s = s.replace(anchor, anchor + add)
    s = s.replace(BEFORE[0], BEFORE[1] + BEFORE[0])
    s = s.replace(END, END[:-2] + (
        "    const int b = c * parts + part;\n"
        f"    if (tid == 0 && b < {MAX_BLOCKS}) {{\n"
        "        unsigned sm;\n"
        '        asm("mov.u32 %0, %%smid;" : "=r"(sm));\n'
        "        long long* g = g_fphase[b];\n"
        "        g[0] = T1 - T0; g[1] = T2 - T1; g[2] = T3 - T2;\n"
        "        g[3] = clock64() - T3; g[4] = m; g[5] = Nj; g[6] = sm;\n"
        "        g[7] = W0; g[8] = fwall_ns(); g[9] = np;\n"
        "        g[10] = TI[0]; g[11] = TI[1]; g[12] = TI[2];\n    }\n}\n"))
    s += ("\nKERNELS_API int rs_full_phases(void* dst, int n) {\n"
          "    return (int)cudaMemcpyFromSymbol(dst, g_fphase,\n"
          f"                                     (size_t)n * {NF} * "
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
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out", default=str(ROOT / "build" / "full_phases"))
    ap.add_argument("--min-blocks", type=int, default=None)
    args = ap.parse_args()
    out = pathlib.Path(args.out).resolve()
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(pathlib.Path(args.root) / "reactive_pb_nn_md_tpu_torch",
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
    if args.min_blocks is not None:
        rsp._FULL_MIN_BLOCKS = args.min_blocks
    fn = _build.library().rs_full_phases
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for tag, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        system, state, topo, _, _, _ = cs.flagship(torch.device("cuda"),
                                                   dtype)
        x, box, cells = state.x, state.box, system.rs_cells
        slot, over = rsp.bin_atoms(x, box, cells, system.real_space_cutoff)
        cs.check(not bool(over), "the flagship overflows its cells")
        cm = rsp.pack_cells(x, topo.charge, topo.atom_type, topo.atom_mol,
                            slot, cells)
        tabs = rsp.build_tabs(system, dtype)
        for _ in range(3):
            rsp.pair_rows(cm, tabs, cells, box, system.real_space_cutoff,
                          system.alpha_sqrt, system.has_sapt, impl="full")
        torch.cuda.synchronize()
        n = min(cells[0] * cells[1] * cells[2] * rsp.full_parts(cells),
                MAX_BLOCKS)
        a = np.zeros((n, NF), dtype=np.int64)
        _build.check(fn(a.ctypes.data, n), "rs_full_phases")
        ph = a[:, :4].astype(float)
        span = (a[:, 8].max() - a[:, 7].min()) / 1e3
        per_sm = np.bincount(a[:, 6])
        print(f"{tag}: {n} blocks ({rsp.full_parts(cells)} parts a cell); "
              f"cycles a block, stage / list / items / out: mean "
              f"{ph.mean(0).round(0).tolist()}, max "
              f"{ph.max(0).round(0).tolist()}; launch wall {span:.3f} us, "
              f"blocks resident {(a[:, 8] - a[:, 7]).sum() / 1e3 / span:.1f}"
              f"; atoms a block {a[:, 4].mean():.2f} (max {a[:, 4].max()}),"
              f" list parts {a[:, 9].mean():.2f}, a stencil "
              f"{a[:, 5].mean():.2f}; blocks an SM "
              f"{per_sm[per_sm > 0].min()}-{per_sm.max()} on "
              f"{(per_sm > 0).sum()} SMs; warp 0's items, filter / last "
              f"flush / sums: mean {a[:, 10:13].mean(0).round(0).tolist()}",
              flush=True)
        shared = per_sm[a[:, 6]]
        for k in sorted(set(shared.tolist())):
            sel = shared == k
            print(f"  blocks on SMs running {k}: {int(sel.sum())}, cycles "
                  f"stage / list / items / out "
                  f"{ph[sel].mean(0).round(0).tolist()}", flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
