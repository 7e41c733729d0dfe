#!/usr/bin/env python3
"""Time kernel E, the EVB ground state (csrc/ground_state.cu), of one
checkout of the port on one card, on the Hamiltonians of chip_smoke.py's
phase 8b: the equilibrated flagship's at S = 80 and at its small tier S =
48, the 10,000-atom lattice's at S = 32, and an engineered near-degenerate
one at S = 80 (chip_smoke.evb_like, diagonal gap 1e-7), each in fp64 and
fp32:

    python3 tools/time_ground_state.py [--root DIR] [--hamiltonians FILE]

--root: the checkout whose reactive_pb_nn_md_tpu_torch is timed (default:
this repo).  Whatever the checkout, the times are this repo's
chip_smoke.cuda_ms (the median of 25 runs of back-to-back launches over
their count) and chip_smoke.graphed_device_ms (n launches captured in one
CUDA graph, the replay timed by CUDA events, less an empty kernel's
graph, over n), so that two versions are timed by one method: unpack the
other version's package into a git-ignored directory (git archive
<commit> reactive_pb_nn_md_tpu_torch | tar -x -C DIR) and run the two
alternately, each in its own process (other, this, this, other), in one
call on one card.

--hamiltonians: an .npz of the four Hamiltonians (fp64); built from the
decks by the checkout's own package and written there when it is missing
(default build/time_ground_state_h.npz), so that every run of a call
times the same bits.

Before it is timed, each call is held against the plain version (eigh) at
chip_smoke's bars: fp64 |dlambda_0| <= 1e-10 |lambda_0| and |dc| <= 1e-9
up to sign where the ground gap is > 1e-6, fp32 1e-6 and 1e-5; two calls
must give the same bits and info must be >= 0, or the script fails.

Prints one JSON object per dtype: {"root", "dtype", "<case>": {"ms",
"device_ms", "eigh_ms" (torch.linalg.eigh's cuda_ms), "info", "dlam",
"dc", "bound_ms"}} for the cases S80, S48, S32 and S80_near_degenerate;
then nvidia-smi's name and power limit.
"""

import argparse
import importlib.util
import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = ("S80", "S48", "S32", "S80_near_degenerate")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hamiltonians(cs, path):
    """The four fp64 Hamiltonians (numpy), from `path` or built and saved
    there."""
    import numpy as np
    import torch
    if path.exists():
        with np.load(path) as z:
            return {k: z[k] for k in CASES}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        flag = cs.eq_sim(tmp / "flag", torch.float64)
        hs = dict(
            S80=cs.evb_hamiltonian(flag, "full"),
            S48=cs.evb_hamiltonian(flag, "small")[:48, :48],
            S32=cs.evb_hamiltonian(cs.lattice_sim(tmp / "10k",
                                                  torch.float32), "full"))
        hs = {k: v.double().cpu().numpy() for k, v in hs.items()}
    hs["S80_near_degenerate"] = cs.evb_like(80, 60, np.random.default_rng(7),
                                            1e-7)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **hs)
    return hs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--hamiltonians",
                    default=str(ROOT / "build" / "time_ground_state_h.npz"))
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    cs = _chip_smoke()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(root))
    from reactive_pb_nn_md_tpu_torch.ops import ground_state as gs
    if not pathlib.Path(gs.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {gs.__file__}, not the package under {root}")
    hs = _hamiltonians(cs, pathlib.Path(args.hamiltonians))
    for tag, dtype in (("fp64", torch.float64), ("fp32", torch.float32)):
        row = dict(root=str(root), dtype=tag)
        tol_l, tol_c = (1e-10, 1e-9) if tag == "fp64" else (1e-6, 1e-5)
        for case in CASES:
            H = torch.tensor(hs[case], device="cuda").to(dtype)
            S = H.shape[0]
            lam, c, info = gs.ground_state_cuda(H)
            lam2, c2, _ = gs.ground_state_cuda(H)
            cs.check(torch.equal(lam, lam2) and torch.equal(c, c2),
                     f"{case} {tag}: two calls of E differ")
            cs.check(int(info) >= 0, f"{case} {tag}: E failed ({int(info)})")
            lp, cp = gs.ground_state_eigh(H)
            w = torch.linalg.eigvalsh(torch.tensor(hs[case], device="cuda"))
            gap = float(w[1] - w[0])
            dlam = abs(float(lam) - float(lp))
            dc = min(float((c - cp).abs().max()), float((c + cp).abs().max()))
            cs.check(dlam <= tol_l * abs(float(lp))
                     and (gap <= 1e-6 or dc <= tol_c),
                     f"{case} {tag}: E disagrees with eigh: |dlambda| "
                     f"{dlam:.3e}, |dc| {dc:.3e}, gap {gap:.3e}")

            def fn():
                return gs.ground_state_cuda(H)
            isz = H.element_size()
            row[case] = dict(
                ms=cs.cuda_ms(fn), device_ms=cs.graphed_device_ms(fn),
                eigh_ms=cs.cuda_ms(
                    lambda: torch.linalg.eigh(H)),
                info=int(info), dlam=dlam, dc=dc,
                bound_ms=cs.bound(S * S * isz + (S + 1) * isz,
                                  4.0 / 3.0 * S ** 3, "fp64")[0])
        print(json.dumps(row), flush=True)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
