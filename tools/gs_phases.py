#!/usr/bin/env python3
"""Where kernel E (the EVB ground state, csrc/ground_state.cu) spends its
time, by phase, on one card:

    python3 tools/gs_phases.py [--out DIR]

Copies this repo's reactive_pb_nn_md_tpu_torch to DIR (default: the
git-ignored build/gs_phases), adds clock reads of thread 0 to the copy's
ground_state_kernel at the ends of its phases, builds that copy and runs
E on padded EVB-shaped Hamiltonians (chip_smoke.evb_like) at S = 32, 48
and 80 and a near-degenerate one at S = 80, fp64.  The package itself is
not changed.  The patch finds its places by the source's own lines and
fails if they moved.

Prints, per S, the SM cycles of each phase -- load (H into A, the active
block), house (the reflections), bounds (T's last entries, the Gershgorin
interval), bisect (the multisection rounds), inverse (the LU and
solves), resid (the residual check), back (the back-transform), out
(normalization, sign, output) -- and in all, the median of 20 calls, and
house by part, summed over the reflections that are not skipped: p (the
warps' parts of A v and a barrier), w (p and the warps' parts of v^T p,
a barrier), update (the rank-2 update, warp 0's next reflector, a
barrier); then nvidia-smi's name and power limit.
"""

import argparse
import ctypes
import importlib.util
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_MARKS = 9
LABELS = ("load", "house", "bounds", "bisect", "inverse", "resid", "back",
          "out")

PROBE = f"""__device__ long long g_gs_phase[{N_MARKS + 3}];
#define GS_MARK(i) do {{ if (threadIdx.x == 0) g_gs_phase[i] = clock64(); \\
}} while (0)
"""

# (text in the kernel source, text that replaces it); GS_MARK(i) after
# the phase before it
PATCH = [
    ("template <typename T, int JR>\n__global__", PROBE
     + "template <typename T, int JR>\n__global__"),
    ("    const double h00 = (double)H[0];\n",
     "    GS_MARK(0);\n    const double h00 = (double)H[0];\n"),
    ("    // 1. Householder: reflection k",
     "    GS_MARK(1);\n    long long gs_acc[3] = {0, 0, 0}, gs_t;\n"
     "    // 1. Householder: reflection k"),
    ("        const int k1 = k + 1, n = nact - k1;\n",
     "        const int k1 = k + 1, n = nact - k1;\n"
     "        gs_t = clock64();\n"),
    ("            __syncthreads();\n"
     "            // p = tau A v, warp w its rows",
     "            __syncthreads();\n"
     "            gs_acc[0] += clock64() - gs_t;\n"
     "            gs_t = clock64();\n"
     "            // p = tau A v, warp w its rows"),
    ("            __syncthreads();\n            // K = (tau / 2) v^T p",
     "            __syncthreads();\n"
     "            gs_acc[1] += clock64() - gs_t;\n"
     "            gs_t = clock64();\n            // K = (tau / 2) v^T p"),
    ("        __syncthreads();\n    }\n\n    // T of the active block",
     "        __syncthreads();\n        gs_acc[2] += clock64() - gs_t;\n"
     "    }\n    if (threadIdx.x == 0) {\n"
     "        g_gs_phase[9] = gs_acc[0];\n"
     "        g_gs_phase[10] = gs_acc[1];\n"
     "        g_gs_phase[11] = gs_acc[2];\n"
     "    }\n    GS_MARK(2);\n\n    // T of the active block"),
    ("    // 2. multisection on the active",
     "    GS_MARK(3);\n    // 2. multisection on the active"),
    ("    const bool closed = nact == 0 || hi - lo <= tol;\n",
     "    GS_MARK(4);\n"
     "    const bool closed = nact == 0 || hi - lo <= tol;\n"),
    ("    // 4. residual on T", "    GS_MARK(5);\n    // 4. residual on T"),
    ("    // y -= tau_k (v_k^T y) v_k from k = N - 3 down;",
     "    GS_MARK(6);\n"
     "    // y -= tau_k (v_k^T y) v_k from k = N - 3 down;"),
    ("    double nrm = 0.0, amax = -1.0;\n",
     "    GS_MARK(7);\n    double nrm = 0.0, amax = -1.0;\n"),
    ("        info_out[0] = ok ? rounds : -1;\n    }\n",
     "        info_out[0] = ok ? rounds : -1;\n    }\n    GS_MARK(8);\n"),
]


def patch(src):
    s = src.read_text()
    for old, new in PATCH:
        if s.count(old) != 1:
            sys.exit(f"{src}: the line {old.splitlines()[0]!r} moved")
        s = s.replace(old, new)
    s += ("\nKERNELS_API int gs_phases(void* dst) {\n"
          "    return (int)cudaMemcpyFromSymbol(dst, g_gs_phase, "
          "sizeof(g_gs_phase));\n}\n")
    src.write_text(s)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "gs_phases"))
    args = ap.parse_args()
    out = pathlib.Path(args.out).resolve()
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "reactive_pb_nn_md_tpu_torch",
                    out / "reactive_pb_nn_md_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    patch(out / "reactive_pb_nn_md_tpu_torch" / "csrc" / "ground_state.cu")
    cs = _chip_smoke()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(out))
    from reactive_pb_nn_md_tpu_torch.ops import ground_state as gs
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    fn = _build.library().gs_phases
    fn.argtypes = [ctypes.c_void_p]
    for name, S, n, gap in (("S32", 32, 20, None), ("S48", 48, 40, None),
                            ("S80", 80, 60, None),
                            ("S80_near_degenerate", 80, 60, 1e-7)):
        H = torch.tensor(cs.evb_like(S, n, np.random.default_rng(S), gap),
                         device="cuda")
        rows = []
        for _ in range(21):
            lam, c, info = gs.ground_state_cuda(H)
            torch.cuda.synchronize()
            a = np.zeros(N_MARKS + 3, dtype=np.int64)
            _build.check(fn(a.ctypes.data), "gs_phases")
            rows.append(np.concatenate([np.diff(a[:N_MARKS]),
                                        a[N_MARKS:]]))
        lp, _ = gs.ground_state_eigh(H)
        cs.check(int(info) >= 0 and abs(float(lam) - float(lp))
                 <= 1e-10 * abs(float(lp)), f"{name}: the patched E failed")
        med = np.median(np.array(rows[1:]), axis=0).astype(int)
        print(f"{name}: cycles, " + ", ".join(
            f"{k} {v}" for k, v in zip(LABELS, med[:-3].tolist()))
            + f"; all {int(med[:-3].sum())}; house by part: p {med[-3]}, w "
            f"{med[-2]}, update {med[-1]}; rounds {int(info)}",
            flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
