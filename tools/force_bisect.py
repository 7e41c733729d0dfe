#!/usr/bin/env python3
"""Hold the card's forces at one saved state against fp64, with each
kernel in turn replaced by its plain version:

    python3 tools/force_bisect.py STATE.npz [STATE.npz ...] [--root DIR]
                                  [--dtype fp32|fp64]

STATE: a state tools/nve_check.py --save wrote (the flagship deck's
system at the state's capacities).  evaluate_forces runs at it on the
card in --dtype (default fp32) with every kernel, then with one kernel
at a time replaced by its plain PyTorch version (inputs copied to the
CPU, the result back, autograd through the copies): A (pair_rows), B1
(spread), B2 (gather), C1 and C2 (perstate_recip_energy, forward and
backward together); and in fp64 with every kernel, the reference.
Prints, for each, the potential, max |F| and max |F - F(fp64)| with the
atom where it is largest; then, with every kernel, the Hellmann-Feynman
force cut into its parts (the c-weighted diagonal, of which the
per-state reciprocal deltas, and the couplings) at that atom, in --dtype
and in fp64; then nvidia-smi's name and power limit.

--root: the checkout whose reactive_pb_nn_md_tpu_torch runs (default:
this repo).
"""

import argparse
import dataclasses
import importlib.util
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
    ap.add_argument("states", nargs="+")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--dtype", choices=("fp32", "fp64"), default="fp32")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    cs = _chip_smoke()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(root))
    from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.ops import neighbors
    from reactive_pb_nn_md_tpu_torch.ops.kernels import (
        pme_spread as sp, realspace_pair as rsp, recip_perstate as rp)
    from reactive_pb_nn_md_tpu_torch.topology import Topology
    dev = torch.device("cuda")

    def cpu(t):
        return t.cpu() if torch.is_tensor(t) else t

    # the plain version of each kernel on the CUDA tensors it is given
    plain = {
        "A": (rsp, "pair_rows", lambda cm, tabs, cells, box, rcut, alpha,
              has_sapt, impl="full": rsp.pair_rows_plain(
                  cm.cpu(), tabs.cpu(), cells, torch.diagonal(box).cpu(),
                  rcut, alpha, has_sapt).to(cm.device)),
        "B1": (sp, "spread", lambda w, nearpt, q, K: sp.spread_plain(
            w.cpu(), nearpt.cpu(), q.cpu(), K).to(w.device)),
        "B2": (sp, "gather", lambda *a: tuple(
            t.to(a[1].device) for t in sp.gather_plain(*map(cpu, a)))),
        "C1+C2": (rp, "perstate_recip_energy", lambda *a: rp.perstate_plain(
            *map(cpu, a)).to(a[0].device)),
    }

    def evaluate(path, dtype):
        d = np.load(path)
        system, _, _, meta, cbw, _ = cs.flagship(dev, dtype)
        system = system.replace(evb_max_states=int(d["evb_max_states"]))
        x = torch.tensor(d["x"], dtype=dtype, device=dev)
        box = torch.tensor(d["box"], dtype=dtype, device=dev)
        topo = Topology(**{f.name: torch.tensor(d["topo_" + f.name],
                                                device=dev)
                           for f in dataclasses.fields(Topology)})
        topo = dataclasses.replace(topo, charge=topo.charge.to(dtype))
        nl = neighbors.build_neighbors(x, box, **integrators.neighbor_plan(
            system, box, int(d["capacity"]),
            react_cap=int(d["react_cap"]) or None))
        return integrators.evaluate_forces(x, box, topo, system, nl, cbw)

    def parts(path, dtype, atom):
        """-d/dx at `atom` of c^T diag(H) c, of its reciprocal deltas and
        of the couplings, captured inside the evaluation (the eigenvector
        c held fixed, as the force takes it)."""
        rec, out = {}, {}
        diag_fn, eigh_fn = ham.diabat_diagonal_energies, ham.ground_state

        def diag_wrap(x, *a, **k):
            res = diag_fn(x, *a, **k)
            rec.update(x=x, recip=res[2])
            return res

        def eigh_wrap(H):
            w, c, failed = eigh_fn(H)
            cc = c.detach().to(H.dtype)
            e_diag = (cc ** 2 * torch.diagonal(H)).sum()
            e_recip = (cc[:rec["recip"].shape[0]] ** 2 * rec["recip"]).sum()
            for name, e in (("diagonal", e_diag), ("of it recip", e_recip),
                            ("couplings", cc @ H @ cc - e_diag)):
                g, = torch.autograd.grad(e, rec["x"], retain_graph=True,
                                         allow_unused=True)
                out[name] = (torch.zeros(3) if g is None
                             else -g[atom].double().cpu())
            return w, c, failed

        ham.diabat_diagonal_energies, ham.ground_state = (diag_wrap,
                                                          eigh_wrap)
        try:
            evaluate(path, dtype)
        finally:
            ham.diabat_diagonal_energies, ham.ground_state = (diag_fn,
                                                              eigh_fn)
        return out

    dtype = torch.float32 if args.dtype == "fp32" else torch.float64
    for path in args.states:
        ref = evaluate(path, torch.float64)
        f64 = ref.force

        def report(name, fe):
            dF = (fe.force.double() - f64).abs().max(1).values
            i = int(dF.argmax())
            print(f"  {name:14s} PE {float(fe.potential):.4f}  max|F| "
                  f"{float(fe.force.abs().max()):9.2f}  max|F - F64| "
                  f"{float(dF[i]):.3e} (atom {i})", flush=True)

        print(f"{path}: fp64 PE {float(ref.potential):.4f}, max|F| "
              f"{float(f64.abs().max()):.2f}, {int(ref.n_states)} diabats",
              flush=True)
        fe = evaluate(path, dtype)
        report(f"{args.dtype} kernels", fe)
        atom = int((fe.force.double() - f64).abs().max(1).values.argmax())
        p32, p64 = parts(path, dtype, atom), parts(path, torch.float64, atom)
        for name in p32:
            print(f"  atom {atom} force, {name:12s} {args.dtype} "
                  f"{[round(v, 3) for v in p32[name].tolist()]}  fp64 "
                  f"{[round(v, 3) for v in p64[name].tolist()]}", flush=True)
        for name, (mod, attr, fn) in plain.items():
            keep = getattr(mod, attr)
            setattr(mod, attr, fn)
            try:
                report(f"{name} plain", evaluate(path, dtype))
            finally:
                setattr(mod, attr, keep)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
