#!/usr/bin/env python3
"""Where kernel B1 (the per-atom PME spread) spends its time, by phase,
on one card:

    python3 tools/spread_phases.py [--out DIR]

Copies this repo's reactive_pb_nn_md_tpu_torch to DIR (default: the
git-ignored build/spread_phases), adds clock reads to the copy's
spread_kernel (csrc/pme_spread.cu) at the ends of its phases, builds that
copy and runs B1 at the flagship (benchdata/eq_flagship_s80.npz, 649
atoms, K = 32, order 6) and on the 10,000-atom lattice
(examples/water_10k/, K = 64), fp64 and fp32.  The package itself is not
changed.  The patch finds its places by the source's own lines and fails
if they moved.

Prints, per dtype and box, the mean and max SM cycles a block spends in
each phase -- scan (testing the atoms, loading the rows of those that
reach the tile, ranking them), stage (their rows into shared memory),
add (the warps' column tests and the sums), out (writing the tile) --
and in all, the atoms a block stages, the launch's wall span
(%globaltimer), the blocks resident on average, the spread of the
blocks' start times and the most blocks an SM ran; then nvidia-smi's
name and power limit.
"""

import argparse
import ctypes
import importlib.util
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX_BLOCKS = 8192

PROBE = f"""__device__ long long g_phase[{MAX_BLOCKS}][10];
__device__ __forceinline__ long long wall_ns() {{
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}}
__device__ __forceinline__ void phase_out(long long all, long long scan,
                                          long long stage, long long add,
                                          long long out, long long n,
                                          long long w0) {{
    const int c = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
                  + blockIdx.x;
    if (threadIdx.x != 0 || c >= {MAX_BLOCKS}) return;
    unsigned sm;
    asm("mov.u32 %0, %%smid;" : "=r"(sm));
    long long* g = g_phase[c];
    g[0] = scan; g[1] = stage; g[2] = add; g[3] = out; g[4] = all;
    g[5] = n; g[6] = sm; g[7] = w0; g[8] = wall_ns();
}}
"""

# (text in the kernel source, text that replaces it)
PATCH = [
    ("#define SPREAD_COUNTS ", PROBE + "#define SPREAD_COUNTS "),
    ("    const bool ztest = zw < K;\n",
     "    const bool ztest = zw < K;\n"
     "    const long long T0 = clock64(), W0 = wall_ns();\n"
     "    long long TSC = 0, TST = 0, TAD = 0, NST = 0;\n"),
    ("    for (int base = 0; base < n; base += CH) {\n",
     "    for (int base = 0; base < n; base += CH) {\n"
     "        const long long ta = clock64();\n"),
    ("        const bool last = base + CH >= n;\n",
     "        const bool last = base + CH >= n;\n"
     "        long long tb = clock64();\n        TSC += tb - ta;\n"),
    ("            __syncthreads();\n            add_staged(count);\n"
     "            __syncthreads();\n",
     "            __syncthreads();\n            const long long tc = clock64();"
     "\n            TST += tc - tb;\n            NST += count;\n"
     "            add_staged(count);\n            __syncthreads();\n"
     "            tb = clock64();\n            TAD += tb - tc;\n"),
    ("    // 3. every element of the tile, written once\n",
     "    // 3. every element of the tile, written once\n"
     "    const long long T2 = clock64();\n"),
    (" = acc[p];\n    }\n}",
     " = acc[p];\n    }\n    __syncthreads();\n"
     "    const long long T3 = clock64();\n"
     "    phase_out(T3 - T0, TSC, TST, TAD, T3 - T2, NST, W0);\n}"),
]
LABELS = "scan / stage / add / out / all"


def patch(src):
    s = src.read_text()
    for old, new in PATCH:
        if s.count(old) != 1:
            sys.exit(f"{src}: the line {old.splitlines()[0]!r} moved")
        s = s.replace(old, new)
    s += ("\nKERNELS_API int spread_phases(void* dst) {\n"
          "    return (int)cudaMemcpyFromSymbol(dst, g_phase, "
          "sizeof(g_phase));\n}\n")
    src.write_text(s)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "spread_phases"))
    args = ap.parse_args()
    out = pathlib.Path(args.out).resolve()
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "reactive_pb_nn_md_tpu_torch",
                    out / "reactive_pb_nn_md_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    patch(out / "reactive_pb_nn_md_tpu_torch" / "csrc" / "pme_spread.cu")
    cs = _chip_smoke()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(out))
    from reactive_pb_nn_md_tpu_torch.ops.kernels import (
        _build, pme_spread as sp)
    fn = _build.library().spread_phases
    fn.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    for tag, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        system, state, topo, _, _, _ = cs.flagship(dev, dtype)
        boxes = [("flagship", system, state.x, state.box, topo)]
        system, x, box, topo, _ = cs.lattice_10k(dev, dtype)
        boxes.append(("10k", system, x, box, topo))
        for name, system, x, box, topo in boxes:
            K, order = system.pme_grid, system.spline_order
            w, _, nearpt = sp.spline_setup(x, box, K, order)
            q = topo.charge.contiguous()
            for _ in range(20):
                grid = sp.spread_cuda(w, nearpt, q, K)
            torch.cuda.synchronize()
            err = cs.close(grid, sp.spread_plain(w, nearpt, q, K),
                           **(cs.TOL64 if tag == "fp64"
                              else cs.TOL32["spread"]))
            cs.check(err[2], f"the patched B1 disagrees: {err[:2]}")
            a = np.zeros((MAX_BLOCKS, 10), dtype=np.int64)
            _build.check(fn(a.ctypes.data), "spread_phases")
            p = a[:int((a[:, 8] > 0).sum())]
            span = (p[:, 8].max() - p[:, 7].min()) / 1e3
            print(f"{tag} {name}: {len(p)} blocks; cycles a block, "
                  f"{LABELS}: mean {p[:, :5].mean(0).round(0).tolist()}, "
                  f"max {p[:, :5].max(0).tolist()}; atoms staged a block "
                  f"{p[:, 5].mean():.1f} (max {p[:, 5].max()}); launch wall "
                  f"{span:.2f} us, blocks resident "
                  f"{(p[:, 8] - p[:, 7]).sum() / 1e3 / span:.1f}, start "
                  f"spread {(p[:, 7].max() - p[:, 7].min()) / 1e3:.2f} us, "
                  f"blocks an SM <= {np.bincount(p[:, 6]).max()}",
                  flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
