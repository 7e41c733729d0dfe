"""Parity harness (counterpart of the JAX package's
scripts/parity_reference.py):

    python -m reactive_pb_nn_md_tpu_torch.run.parity_reference dump \\
        in.gro ff.pmt top.top sim.pmt [--out FILE] [--device cuda]
        [--precision fp64]
    python -m reactive_pb_nn_md_tpu_torch.run.parity_reference diff A B \\
        [--tol-e-rel 1e-3] [--tol-h-abs 1e-3] [--tol-f-abs 1e-4]
    python -m reactive_pb_nn_md_tpu_torch.run.parity_reference \\
        check-toolchain

dump: one MS-EVB evaluation of a deck (the reference's file formats)
written to JSON in the JAX dump's schema ("reactive_pb_nn_md parity dump
v1"): the per-diabat Hamiltonian, each diabat's hop signature (the
donor -> acceptor molecule chain of its hops), the hydronium of each,
the ground-state energy and eigenvector, the adiabatic forces and the
non-reactive energy decomposition.  The neighbors are the JAX dump's (a
dense list at the Verlet cutoff, the suggested capacity); the
evaluation runs on --device (the card by default, its kernels) in fp64
unless --precision says otherwise.  A dump whose neighbor list or state
set overflowed is refused.  The JAX package's diff_dumps reads a port
dump, and this diff reads a JAX one.

diff: two dumps compared with the diabats matched by hop signature, not
by enumeration order (the reference enumerates depth-first, both
engines breadth-first): H diagonal and energies to tol-e-rel relative
(of max(1, |value|)), |H off-diagonal| to tol-h-abs, forces to tol-f-abs
per component; exit 0 when all hold.  The JAX script's tolerances.

check-toolchain: whether a Fortran compiler exists for the reference
side (docs/PARITY.md); exits 0 with SKIP when none does.
"""

import argparse
import json
import pathlib
import shutil
import sys

import numpy as np
import torch

from ..convert import cli_device, resolve_device
from ..evb import hamiltonian as ham
from ..md.simulation import load_deck
from ..models import pme
from ..ops import neighbors
from ..utils import pbc

SCHEMA = "reactive_pb_nn_md parity dump v1"
TERMS = ("elec", "vdw", "bond", "angle", "dihedral")
# the JAX script's tolerances
TOL_E_REL, TOL_H_ABS, TOL_F_ABS = 1e-3, 1e-3, 1e-4


def engine_dump(gro, ff, top, sim, out_path=None, device="cuda",
                precision="fp64"):
    """One MS-EVB evaluation of the deck -> the schema's dict (written to
    out_path as JSON when given)."""
    device = resolve_device(device)
    cfg, frame, system, topo = load_deck(gro, ff, top, sim, device,
                                         precision)
    if not system.ms_evb:
        raise SystemExit("deck is not an MS-EVB simulation "
                         "(ms_evb_simulation no)")
    f = system.mass.dtype
    x = torch.as_tensor(frame.xyz, dtype=f, device=device)
    box = torch.as_tensor(frame.box, dtype=f, device=device)
    cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt, dtype=f)
    cap = neighbors.suggest_capacity(system.n_atoms,
                                     abs(float(pbc.box_volume(box))),
                                     system.verlet_cutoff)
    nlist = neighbors.build_neighbors(x, box, system.verlet_cutoff, cap)
    res, batch = ham.adiabatic_energy_force(
        x, box, topo, system, neighbors.neighbor_pairs(nlist), cbw,
        nlist.full_idx, react_idx=nlist.react_idx)
    if bool(nlist.overflow) or bool(res.overflow):
        raise SystemExit("the neighbor list or the state set overflowed: "
                         "no dump from truncated data")
    S = int(res.n_states)
    hop_log = batch.dset.hop_log[:S].cpu().numpy()
    n_hops = batch.dset.n_hops[:S].cpu().numpy()
    # hop_log columns: [donor_mol, proton_atom, donor_heavy, acceptor_mol,
    # acceptor_heavy]; a diabat's signature is its molecule chain
    sigs = [[[int(hop_log[s, h, 0]), int(hop_log[s, h, 3])]
             for h in range(int(n_hops[s]))] for s in range(S)]
    bd = res.breakdown

    def host(t):
        return t.detach().double().cpu().numpy()

    dump = {
        "schema": SCHEMA,
        "deck": {"gro": str(gro), "ff": str(ff), "top": str(top),
                 "sim": str(sim)},
        "n_atoms": system.n_atoms,
        "n_states": S,
        "hydronium_mol": int(topo.hydronium_mol),
        "diabat_signature": sigs,
        "diabat_hydronium": res.hydronium_of[:S].cpu().tolist(),
        "H_kjmol": host(res.hamiltonian)[:S, :S].tolist(),
        "ground_energy_kjmol": float(res.energy),
        "eigenvector": host(res.eigenvector)[:S].tolist(),
        "force_kjmol_per_A": host(res.force).tolist(),
        "breakdown": {k: float(getattr(bd, k)) for k in TERMS},
    }
    if out_path:
        pathlib.Path(out_path).write_text(json.dumps(dump))
    return dump


def _match_states(sig_a, sig_b):
    """perm[i] = the row of B whose hop signature is A's row i (or None)."""
    keyed = {json.dumps(s): i for i, s in enumerate(sig_b)}
    return [keyed.get(json.dumps(s)) for s in sig_a]


def diff_dumps(a, b, tol_e_rel=TOL_E_REL, tol_h_abs=TOL_H_ABS,
               tol_f_abs=TOL_F_ABS, verbose=True):
    """Compare two dumps: (ok, report lines), the JAX diff_dumps' checks."""
    rep = []
    ok = True

    def chk(cond, msg):
        nonlocal ok
        rep.append(("OK  " if cond else "FAIL") + " " + msg)
        ok = ok and bool(cond)

    chk(a["n_atoms"] == b["n_atoms"],
        f"n_atoms {a['n_atoms']} vs {b['n_atoms']}")
    chk(a["n_states"] == b["n_states"],
        f"n_states {a['n_states']} vs {b['n_states']}")
    perm = _match_states(a["diabat_signature"], b["diabat_signature"])
    matched = all(p is not None for p in perm)
    chk(matched, f"diabat signatures match "
                 f"({sum(p is not None for p in perm)}/{len(perm)})")
    Ha, Hb = np.asarray(a["H_kjmol"]), np.asarray(b["H_kjmol"])
    if matched and Ha.shape == Hb.shape:
        p = np.asarray(perm)
        Hb2 = Hb[np.ix_(p, p)]
        rel = (np.abs(np.diag(Ha) - np.diag(Hb2))
               / np.maximum(1.0, np.abs(np.diag(Hb2))))
        chk(rel.max() < tol_e_rel,
            f"H diagonal rel err {rel.max():.2e} < {tol_e_rel}")
        off = ~np.eye(Ha.shape[0], dtype=bool)
        doff = np.abs(np.abs(Ha[off]) - np.abs(Hb2[off]))
        chk(doff.max(initial=0.0) < tol_h_abs,
            f"|H offdiag| abs err {doff.max(initial=0.0):.2e} < "
            f"{tol_h_abs}")
    de = abs(a["ground_energy_kjmol"] - b["ground_energy_kjmol"])
    rel = de / max(1.0, abs(b["ground_energy_kjmol"]))
    chk(rel < tol_e_rel, f"ground energy rel err {rel:.2e} < {tol_e_rel}")
    Fa = np.asarray(a["force_kjmol_per_A"])
    Fb = np.asarray(b["force_kjmol_per_A"])
    if Fa.shape == Fb.shape:
        df = np.abs(Fa - Fb).max()
        chk(df < tol_f_abs, f"force abs err {df:.2e} < {tol_f_abs}")
    else:
        chk(False, f"force shape {Fa.shape} vs {Fb.shape}")
    for k, va in a["breakdown"].items():
        vb = b["breakdown"].get(k)
        if vb is not None:
            rel = abs(va - vb) / max(1.0, abs(vb))
            chk(rel < tol_e_rel, f"breakdown.{k} rel err {rel:.2e}")
    if verbose:
        print("\n".join(rep))
    return ok, rep


def check_toolchain():
    for c in ("ifort", "ifx", "gfortran"):
        if shutil.which(c):
            print(f"toolchain: {c} available -- see docs/PARITY.md for the "
                  f"reference build recipe")
            return
    print("SKIP: no Fortran compiler in this environment -- the reference "
          "side of the parity diff cannot run here (docs/PARITY.md has the "
          "recipe for a compiler-equipped host; the engine-side dump still "
          "works: `dump ...`)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="reactive_pb_nn_md_tpu_torch.run.parity_reference",
        description="MS-EVB parity dump and diff")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    for name in ("gro", "ff", "top", "sim"):
        d.add_argument(name)
    d.add_argument("--out", default="parity_engine.json")
    d.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs only when "
                        "asked for)")
    d.add_argument("--precision", choices=("fp64", "fp32"), default="fp64")
    f = sub.add_parser("diff")
    f.add_argument("a")
    f.add_argument("b")
    f.add_argument("--tol-e-rel", type=float, default=TOL_E_REL)
    f.add_argument("--tol-h-abs", type=float, default=TOL_H_ABS)
    f.add_argument("--tol-f-abs", type=float, default=TOL_F_ABS)
    sub.add_parser("check-toolchain")
    args = ap.parse_args(argv)

    if args.cmd == "check-toolchain":
        check_toolchain()
        return 0
    if args.cmd == "dump":
        engine_dump(args.gro, args.ff, args.top, args.sim, args.out,
                    cli_device(args.device), args.precision)
        print(f"engine dump -> {args.out}")
        return 0
    a = json.loads(pathlib.Path(args.a).read_text())
    b = json.loads(pathlib.Path(args.b).read_text())
    ok, _ = diff_dumps(a, b, args.tol_e_rel, args.tol_h_abs, args.tol_f_abs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
