#!/usr/bin/env python3
"""Time the PME spread kernels of one checkout of the port on one card, on
the 10,000-atom lattice (examples/water_10k/, K = 64, order 6): the slab
spread and interpolation D1 and D2 at slab caps 280 and 520, and the
per-atom spread and gather B1 and B2 on the same atoms:

    python3 tools/time_slab.py [--root DIR]

--root: the checkout whose reactive_pb_nn_md_tpu_torch is timed (default:
this repo).  Whatever the checkout, the times are this repo's
chip_smoke.cuda_ms (the median of 25 runs of back-to-back launches over
their count) and chip_smoke.device_ms (the profiler's device time of a
call, every kernel summed), so that two versions are timed by one method:
unpack the other version's package into a git-ignored directory (git
archive <commit> reactive_pb_nn_md_tpu_torch | tar -x -C DIR) and run the
two alternately, each in its own process (other, this, this, other), in
one call on one card.  The slab rows come from the checkout's own
slab_bins.

Before it is timed, each kernel is held against its plain version at
chip_smoke's tolerances (fp64 1e-10 relative; fp32 TOL32's spread for D1
and B1, gather for D2 and B2), and D1 and D2 must give the same bits on
two calls, or the script fails.

Prints one JSON object per dtype: {"root", "dtype", "<kernel>": {"ms",
"device_ms", "max_rel_err", "bound_ms", "kernels_us"}} for D1@280,
D2@280, D1@520, D2@520, B1 and B2, where kernels_us is the device
microseconds per call of each device kernel by name (the plane and fold
launches of a two-kernel design show apart); then nvidia-smi's name and
power limit.
"""

import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCAPS = (280, 520)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernels_us(fn, calls=5):
    """Device microseconds per fn() call of each device kernel, by name
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / calls
            for e in prof.key_averages() if e.self_device_time_total > 0}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    cs = _chip_smoke()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(root))
    from reactive_pb_nn_md_tpu_torch.ops.kernels import (
        pme_slab as sl, pme_spread as sp)
    from reactive_pb_nn_md_tpu_torch.utils import pbc
    if not pathlib.Path(sl.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {sl.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    for tag, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        tol = dict(spread=cs.TOL64, gather=cs.TOL64) if tag == "fp64" else \
            dict(spread=cs.TOL32["spread"], gather=cs.TOL32["gather"])
        system, x, box, topo, _ = cs.lattice_10k(dev, dtype)
        K, order = system.pme_grid, system.spline_order
        w, dw, nearpt = sp.spline_setup(x, box, K, order)
        q = topo.charge.contiguous()
        n = x.shape[0]
        gQ = torch.tensor(rng.standard_normal(K ** 3), dtype=dtype,
                          device=dev)
        row = dict(root=str(root), dtype=tag)

        def entry(name, fn, ref, kind, n_bytes, flops, same=False,
                  view=lambda out: out):
            got = view(fn())
            err = cs.close(got, ref, **tol[kind])
            cs.check(err[2], f"{name} ({tag}) disagrees with its plain "
                             f"version: {err[:2]}")
            if same:
                cs.check(torch.equal(got, fn()),
                         f"{name} ({tag}) differs between two calls")
            row[name] = dict(ms=cs.cuda_ms(fn), device_ms=cs.device_ms(fn),
                             max_rel_err=err[1],
                             bound_ms=cs.bound(n_bytes, flops, tag)[0],
                             kernels_us=kernels_us(fn))

        for scap in SCAPS:
            slot, rows, over = sl.slab_bins(nearpt, K, order, scap)
            cs.check(not bool(over), f"the lattice overflows scap {scap}")
            entry(f"D1@{scap}", lambda: sl.spread_slab_cuda(
                      w, nearpt, q, rows, K, scap),
                  sl.spread_slab_plain(w, nearpt, q, rows, K), "spread",
                  cs.nbytes(w, nearpt, q, rows) + K ** 3 * w.element_size(),
                  4 * n * order ** 3, same=True)
            entry(f"D2@{scap}", lambda: sl.interp_slab_cuda(
                      gQ, w, dw, nearpt, rows, K, scap),
                  sl.interp_slab_plain(gQ, w, dw, nearpt, rows, K), "gather",
                  cs.nbytes(gQ, w, dw, nearpt, rows)
                  + K * scap * 4 * w.element_size(), 16 * n * order ** 3,
                  same=True)
        entry("B1", lambda: sp.spread_cuda(w, nearpt, q, K),
              sp.spread_plain(w, nearpt, q, K), "spread",
              cs.nbytes(w, nearpt, q) + K ** 3 * w.element_size(),
              4 * n * order ** 3)
        gargs = (gQ, w, dw, nearpt, q, pbc.recip_vectors(box).contiguous(), K)

        def flat(out):
            return torch.cat([t.reshape(-1) for t in out])
        entry("B2", lambda: sp.gather_cuda(*gargs),
              flat(sp.gather_plain(*gargs)), "gather",
              cs.nbytes(*gargs[:-1]) + 4 * n * w.element_size(),
              16 * n * order ** 3, view=flat)
        print(json.dumps(row), flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
