#!/usr/bin/env python3
"""Where kernels D1 and D2 spend their time, by phase, on one card:

    python3 tools/slab_phases.py [--out DIR]

Copies this repo's reactive_pb_nn_md_tpu_torch to DIR (default: the
git-ignored build/slab_phases), adds clock reads to the copy's
slab_spread_kernel and slab_interp_kernel (csrc/pme_slab.cu) at the ends
of their phases, builds that copy and runs D1 and D2 on the 10,000-atom
lattice (examples/water_10k/, K = 64, order 6) at slab caps 280 and 520,
fp64 and fp32.  The package itself is not changed.  The patch finds its
places by the source's own lines and fails if they moved.

Prints, per dtype, cap and kernel, the mean and max SM cycles a block
spends in each phase -- D1: search (the row ranges of the six slabs),
stage (the atoms into shared memory), add (the products into the warps'
tiles), fold (the tiles summed and written); D2: search and window (the
row range and the cotangent window), rows (staging and contracting the
rows) -- the atoms a block takes, the launch's wall span, the blocks
resident on average (the blocks' summed wall time over the span, from
%globaltimer), the spread of the blocks' start times and the most blocks
an SM ran; then nvidia-smi's name and power limit.
"""

import argparse
import ctypes
import importlib.util
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX_BLOCKS = 8192

PROBE = f"""__device__ long long g_phase[2][{MAX_BLOCKS}][8];
__device__ __forceinline__ long long wall_ns() {{
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}}
__device__ __forceinline__ void phase_out(int k, long long p0, long long p1,
                                          long long p2, long long p3,
                                          long long n, long long w0) {{
    const int c = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x != 0 || c >= {MAX_BLOCKS}) return;
    unsigned sm;
    asm("mov.u32 %0, %%smid;" : "=r"(sm));
    long long* g = g_phase[k][c];
    g[0] = p0; g[1] = p1; g[2] = p2; g[3] = p3; g[4] = n; g[5] = sm;
    g[6] = w0; g[7] = wall_ns();
}}
"""

# (text in the kernel source, text that replaces it)
PATCH = [
    ("__device__ __forceinline__ int mod_k(",
     PROBE + "__device__ __forceinline__ int mod_k("),
    # D1
    ("    for (int e = threadIdx.x; e < SLAB_WARPS * SLAB_BAND * RS;",
     "    const long long T0 = clock64(), W0 = wall_ns();\n"
     "    long long TS = 0, TA = 0;\n"
     "    for (int e = threadIdx.x; e < SLAB_WARPS * SLAB_BAND * RS;"),
    ("    __syncthreads();\n    int total = 0;",
     "    __syncthreads();\n    const long long T1 = clock64();\n"
     "    int total = 0;"),
    ("        const int n = min(SLAB_STAGE, total - base);\n",
     "        const int n = min(SLAB_STAGE, total - base);\n"
     "        const long long ta = clock64();\n"),
    ("        __syncthreads();\n        // each warp adds every",
     "        __syncthreads();\n        const long long tb = clock64();\n"
     "        TS += tb - ta;\n        // each warp adds every"),
    ("        __syncthreads();\n    }\n    // fold the warps",
     "        __syncthreads();\n        TA += clock64() - tb;\n    }\n"
     "    const long long T2 = clock64();\n    // fold the warps"),
    ("        grid[((size_t)X * K + y0 + r) * K + z] = sum;\n    }\n}",
     "        grid[((size_t)X * K + y0 + r) * K + z] = sum;\n    }\n"
     "    __syncthreads();\n"
     "    phase_out(0, T1 - T0, TS, TA, clock64() - T2, total, W0);\n}"),
    # D2
    ("    const long long* rows_b = rows + (size_t)b * scap;\n\n"
     "    if (warp == 0) {",
     "    const long long* rows_b = rows + (size_t)b * scap;\n"
     "    const long long T0 = clock64(), W0 = wall_ns();\n\n"
     "    if (warp == 0) {"),
    ("    const int lo = range[0], hi = range[1];",
     "    const int lo = range[0], hi = range[1];\n"
     "    const long long T1 = clock64();"),
    ("            out[(size_t)b * scap * 4 + e] = (T)0;\n}",
     "            out[(size_t)b * scap * 4 + e] = (T)0;\n"
     "    __syncthreads();\n"
     "    phase_out(1, T1 - T0, clock64() - T1, 0, 0, hi - lo, W0);\n}"),
]
PHASES = (("D1", "search / stage / add / fold"), ("D2", "search+window / rows"))


def patch(src):
    s = src.read_text()
    for old, new in PATCH:
        if s.count(old) != 1:
            sys.exit(f"{src}: the line {old.splitlines()[0]!r} moved")
        s = s.replace(old, new)
    s += ("\nKERNELS_API int slab_phases(void* dst) {\n"
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
    ap.add_argument("--out", default=str(ROOT / "build" / "slab_phases"))
    args = ap.parse_args()
    out = pathlib.Path(args.out).resolve()
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "reactive_pb_nn_md_tpu_torch",
                    out / "reactive_pb_nn_md_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    patch(out / "reactive_pb_nn_md_tpu_torch" / "csrc" / "pme_slab.cu")
    cs = _chip_smoke()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(out))
    from reactive_pb_nn_md_tpu_torch.ops.kernels import (
        _build, pme_slab as sl, pme_spread as sp)
    fn = _build.library().slab_phases
    fn.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    for tag, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        system, x, box, topo, _ = cs.lattice_10k(dev, dtype)
        K, order = system.pme_grid, system.spline_order
        w, dw, nearpt = sp.spline_setup(x, box, K, order)
        q = topo.charge.contiguous()
        gQ = torch.tensor(rng.standard_normal(K ** 3), dtype=dtype,
                          device=dev)
        n_blocks = K * -(-K // sl.SLAB_BAND)
        for scap in (280, 520):
            slot, rows, over = sl.slab_bins(nearpt, K, order, scap)
            cs.check(not bool(over), f"the lattice overflows scap {scap}")
            for _ in range(20):
                sl.spread_slab_cuda(w, nearpt, q, rows, K, scap)
                sl.interp_slab_cuda(gQ, w, dw, nearpt, rows, K, scap)
            torch.cuda.synchronize()
            a = np.zeros((2, MAX_BLOCKS, 8), dtype=np.int64)
            _build.check(fn(a.ctypes.data), "slab_phases")
            for k, (name, labels) in enumerate(PHASES):
                p = a[k, :n_blocks]
                m = len(labels.split("/"))
                span = (p[:, 7].max() - p[:, 6].min()) / 1e3
                print(f"{tag} scap {scap} {name}: cycles a block, {labels}: "
                      f"mean {p[:, :m].mean(0).round(0).tolist()}, max "
                      f"{p[:, :m].max(0).tolist()}; atoms a block "
                      f"{p[:, 4].mean():.1f} (max {p[:, 4].max()}); launch "
                      f"wall {span:.2f} us, blocks resident "
                      f"{(p[:, 7] - p[:, 6]).sum() / 1e3 / span:.1f}, start "
                      f"spread {(p[:, 6].max() - p[:, 6].min()) / 1e3:.2f} "
                      f"us, blocks an SM <= {np.bincount(p[:, 5]).max()}",
                      flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
