#!/usr/bin/env python3
"""Time the per-atom PME spread and gather, kernels B1 and B2, of one
checkout of the port on one card: at the flagship's 649 atoms
(benchdata/eq_flagship_s80.npz, K = 32, order 6, their main path) and on
the 10,000-atom lattice (examples/water_10k/, K = 64, order 6):

    python3 tools/time_spread.py [--root DIR]

--root: the checkout whose reactive_pb_nn_md_tpu_torch is timed (default:
this repo).  Whatever the checkout, the times are this repo's
chip_smoke.cuda_ms (the median of 25 runs of back-to-back launches over
their count) and chip_smoke.device_ms (the profiler's device time of a
call, every kernel summed: a zero fill of the grid counts), so that two
versions are timed by one method: unpack the other version's package
into a git-ignored directory (git archive <commit>
reactive_pb_nn_md_tpu_torch | tar -x -C DIR) and run the two
alternately, each in its own process (other, this, this, other), in one
call on one card.  B1 is the subject; B2 (the gather) is the control:
its code is the same in both.

Before it is timed, each kernel is held against its plain version at
chip_smoke's tolerances (fp64 1e-10 relative; fp32 TOL32's spread for B1,
gather for B2), and two B2 calls must give the same bits, or the script
fails.  For B1 it reports whether two calls give the same bits
(same_bits) and whether the grid equals the plain version run on the
CPU bit for bit (cpu_plain_bits: that version sums each element's atoms
in ascending order).

Prints one JSON object per dtype: {"root", "dtype", "floor_device_ms",
"<kernel>": {"ms", "device_ms", "max_rel_err", "bound_ms"}} for B1, B2,
B1@10k and B2@10k (B1's with same_bits and cpu_plain_bits), where
floor_device_ms is an empty kernel's device_ms
(chip_smoke.launch_floor_ms); then nvidia-smi's name and power limit.
"""

import argparse
import importlib.util
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


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
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(root))
    from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_spread as sp
    from reactive_pb_nn_md_tpu_torch.utils import pbc
    if not pathlib.Path(sp.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {sp.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    for tag, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        tol = dict(spread=cs.TOL64, gather=cs.TOL64) if tag == "fp64" else \
            dict(spread=cs.TOL32["spread"], gather=cs.TOL32["gather"])
        row = dict(root=str(root), dtype=tag,
                   floor_device_ms=cs.launch_floor_ms())

        def flat(out):
            return torch.cat([t.reshape(-1) for t in out])

        def entries(key, system, x, box, topo):
            K, order = system.pme_grid, system.spline_order
            w, dw, nearpt = sp.spline_setup(x, box, K, order)
            q = topo.charge.contiguous()
            n = x.shape[0]
            grid = sp.spread_cuda(w, nearpt, q, K)
            err = cs.close(grid, sp.spread_plain(w, nearpt, q, K),
                           **tol["spread"])
            cs.check(err[2], f"B1{key} ({tag}) disagrees: {err[:2]}")
            cpu = sp.spread_plain(w.cpu(), nearpt.cpu(), q.cpu(), K)
            row["B1" + key] = dict(
                same_bits=torch.equal(grid, sp.spread_cuda(w, nearpt, q, K)),
                cpu_plain_bits=torch.equal(grid.cpu(), cpu),
                ms=cs.cuda_ms(lambda: sp.spread_cuda(w, nearpt, q, K)),
                device_ms=cs.device_ms(lambda: sp.spread_cuda(w, nearpt, q,
                                                              K)),
                max_rel_err=err[1],
                bound_ms=cs.bound(cs.nbytes(w, nearpt, q)
                                  + K ** 3 * w.element_size(),
                                  4 * n * order ** 3, tag)[0])
            gQ = torch.tensor(rng.standard_normal(K ** 3), dtype=dtype,
                              device=dev)
            gargs = (gQ, w, dw, nearpt, q,
                     pbc.recip_vectors(box).contiguous(), K)

            def fn():
                return sp.gather_cuda(*gargs)
            got = flat(fn())
            err = cs.close(got, flat(sp.gather_plain(*gargs)),
                           **tol["gather"])
            cs.check(err[2], f"B2{key} ({tag}) disagrees: {err[:2]}")
            cs.check(torch.equal(got, flat(fn())),
                     f"B2{key} ({tag}) differs between two calls")
            row["B2" + key] = dict(
                ms=cs.cuda_ms(fn), device_ms=cs.device_ms(fn),
                max_rel_err=err[1],
                bound_ms=cs.bound(cs.nbytes(*gargs[:-1])
                                  + 4 * n * w.element_size(),
                                  16 * n * order ** 3, tag)[0])

        system, state, topo, _, _, _ = cs.flagship(dev, dtype)
        entries("", system, state.x, state.box, topo)
        system, x, box, topo, _ = cs.lattice_10k(dev, dtype)
        entries("@10k", system, x, box, topo)
        print(json.dumps(row), flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
