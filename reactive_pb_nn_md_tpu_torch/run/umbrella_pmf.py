"""Proton-transfer PMF by umbrella sampling (counterpart of the JAX
package's scripts/umbrella_pmf.py):

    python -m reactive_pb_nn_md_tpu_torch.run.umbrella_pmf \\
        in.gro ff.pmt top.top sim.pmt [--state NPZ] [--windows 16]
        [--span 0.65] [--k 400] [--k-roo 100] [--r-oo 2.5] [--equil 1500]
        [--sample 6000] [--chunk 250] [--temperature 300] [--friction 5.0]
        [--seed 17] [--precision fp32|fp64] [--device cuda] --out FILE

A W-window harmonic ladder on delta r_OH (md/bias.py cv_type 0) between
the hydronium oxygen and its nearest water oxygen, with a soft R_OO
keeper (cv_type 1) holding the pair at bridging distance, run as a
replica batch on one card (parallel/umbrella.py; NVT, no small tier) and
estimated with WHAM and a block bootstrap (analysis/wham.py).  The deck
gives the system (its evb_max_states the cap); --state an equilibrated
(State, Topology) file (benchdata/eq_flagship_s80.npz) with its
capacities.  ``--device`` defaults to ``cuda``; the CPU runs only when
asked for.  Writes the JAX artifact's JSON keys to --out.

The JAX script's TPU workarounds (vmap groups of max_vmap windows, and
the XLA per-state reciprocal above cap 80) have no counterpart: all
windows run batched through one captured step (parallel/ensemble.py).
"""

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from ..analysis import wham
from ..convert import load_equilibrated_npz, resolve_device
from ..md import integrators
from ..md.simulation import load_deck
from ..models import pme
from ..ops import neighbors
from ..parallel import umbrella
from ..topology import State
from ..utils import pbc
from ..utils.dtypes import float_dtype


def load_build(gro, ff, top, sim, state=None, device="cuda",
               precision=None):
    """(system, cbw, cfg, ms) of a deck: its frame, or the equilibrated
    (State, Topology) file `state` with the capacities and kernel A grid
    saved beside it; `precision` replaces the deck's."""
    device = resolve_device(device)
    cfg, frame, system, topo = load_deck(gro, ff, top, sim, device,
                                         precision)
    f = float_dtype(cfg.precision)
    meta = {}
    if state is not None:
        st, topo, meta = load_equilibrated_npz(state, device, f)
        if "rs_cells" in meta:
            system = system.replace(rs_cells=meta["rs_cells"])
    else:
        x = torch.as_tensor(frame.xyz, dtype=f, device=device)
        st = State(x=x, v=torch.zeros_like(x),
                   box=torch.as_tensor(frame.box, dtype=f, device=device))
    cbw = pme.cb_half(st.box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt, dtype=f)
    capacity = meta.get("capacity") or neighbors.suggest_capacity(
        system.n_atoms, float(pbc.box_volume(st.box)), system.verlet_cutoff)
    ms = integrators.initial_md_state(
        st, topo, system, cbw, capacity,
        cells=() if cfg.verlet_allpairs else None,
        react_cap=meta.get("react_cap"))
    return system, cbw, cfg, ms


def check_keepers(ladder):
    """Raise unless every restraint after the window's (the keepers) is the
    same in every window: WHAM is given the window restraint only, which
    is right only then.  (The JAX script relies on this silently.)"""
    for b in ladder[1:]:
        for name in ("atoms", "k", "center"):
            t = getattr(b, name)
            if not bool((t == t[:1]).all()):
                raise ValueError(
                    f"the keeper restraint (cv_type {b.cv_type}) has a "
                    f"{name} that differs between windows: WHAM, given the "
                    f"window restraint only, would be wrong")


def run_pmf(build, n_windows=16, span=0.65, k_spring=400.0, k_roo=100.0,
            r_oo=2.5, n_equil=1500, n_sample=6000, chunk=250,
            temperature=300.0, friction=5.0, seed=17, verbose=True,
            on_chunk=None):
    """The ladder on `build` = (system, cbw, cfg, ms) (load_build's):
    returns (the JAX artifact's dict, the final ReplicaBatch, a dict of
    cv (W, T), the scan, the ladder and the atoms).  k_roo: a scalar, or
    (W,) (then it must be uniform: check_keepers raises before any step);
    on_chunk(batch, diag) after each sampled chunk (sample_ladder's)."""
    t0 = time.time()
    system, cbw, cfg, ms = build
    atoms = umbrella.transfer_triple(ms, system)
    centers = np.linspace(-span, span, n_windows)
    fdt, dev = ms.state.x.dtype, ms.state.x.device
    ladder = (
        umbrella.make_ladder(atoms, centers, k_spring, cv_type=0,
                             dtype=fdt, device=dev),
        umbrella.make_ladder(atoms, np.full(n_windows, r_oo), k_roo,
                             cv_type=1, dtype=fdt, device=dev),
    )
    check_keepers(ladder)
    if verbose:
        print(f"# atoms (O_d, O_a, H) = {atoms.tolist()}, {n_windows} "
              f"windows in [{-span}, {span}], k = {k_spring}, keeper k_roo "
              f"= {k_roo} @ {r_oo} A", flush=True)
    scan = umbrella.make_ladder_scan(
        system, cbw, cfg.delta_t, "NVT", chunk, friction=friction,
        temperature=temperature, hard_max_states=cfg.evb_hard_max_states)
    batch = umbrella.seeded_window_states(
        ms, scan.system, cbw, atoms, centers, r_oo=r_oo,
        temperature=temperature, seed=seed, ladder=ladder)
    t_first = time.time()
    batch, diag = scan(batch, ladder)      # the capture and chunk 1
    float(diag.potential[-1, -1])
    t_run0 = time.time()
    batch, cv, info = umbrella.sample_ladder(
        scan, batch, ladder, n_equil=max(0, n_equil - chunk),
        n_sample=n_sample, chunk=chunk, on_chunk=on_chunk)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t_run0
    agg = n_windows * (info["steps_equil"] + info["steps_sampled"]) / wall

    res, pmf_std = wham.wham_bootstrap(
        cv, centers, k_spring, temperature, n_boot=20,
        n_bins=max(31, 4 * n_windows + 1))
    barrier, xi_b, _, _ = wham.barrier_height(res["bin_centers"],
                                              res["pmf"])
    out = {
        "config": {"n_windows": n_windows, "span": span, "k": k_spring,
                   "k_roo": np.asarray(k_roo).tolist(), "r_oo": r_oo,
                   "n_equil": n_equil,
                   "n_sample": n_sample, "temperature": temperature,
                   "dt_ps": float(cfg.delta_t),
                   "evb_max_states": scan.system.evb_max_states,
                   "n_atoms": system.n_atoms,
                   "atoms": [int(a) for a in atoms]},
        "centers": centers.tolist(),
        "cv_mean": np.round(cv.mean(axis=1), 4).tolist(),
        "cv_std": np.round(cv.std(axis=1), 4).tolist(),
        "bin_centers": np.round(res["bin_centers"], 4).tolist(),
        "pmf_kjmol": np.round(res["pmf"], 3).tolist(),
        "pmf_std_kjmol": np.round(pmf_std, 3).tolist(),
        "window_f_kjmol": np.round(res["f_i"], 3).tolist(),
        "wham_converged": bool(res["converged"]),
        "barrier_kjmol": None if np.isnan(barrier) else round(barrier, 2),
        "barrier_kT": None if np.isnan(barrier)
        else round(barrier / res["kT"], 2),
        "barrier_xi": None if np.isnan(xi_b) else round(xi_b, 3),
        "hops_in_ladder": info["hops"],
        "overflow": scan.n_regrows > 0,
        "aggregate_steps_per_s": round(agg, 1),
        "compile_s": round(t_run0 - t_first, 1),
        "total_s": round(time.time() - t0, 1),
    }
    return out, batch, {"cv": cv, "scan": scan, "ladder": ladder,
                        "atoms": atoms, "wham": res}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="reactive_pb_nn_md_tpu_torch.run.umbrella_pmf",
        description="Proton-transfer PMF by umbrella sampling on one card")
    for name, doc in (("gro", "input coordinates (.gro, nm)"),
                      ("ffpmt", "force-field parameter file (.pmt)"),
                      ("top", "topology file (.top)"),
                      ("simpmt", "simulation parameter file (.pmt)")):
        ap.add_argument(name, help=doc)
    ap.add_argument("--state", default=None,
                    help="equilibrated (State, Topology) .npz")
    ap.add_argument("--windows", type=int, default=16)
    ap.add_argument("--span", type=float, default=0.65)
    ap.add_argument("--k", type=float, default=400.0)
    ap.add_argument("--k-roo", type=float, default=100.0)
    ap.add_argument("--r-oo", type=float, default=2.5)
    ap.add_argument("--equil", type=int, default=1500)
    ap.add_argument("--sample", type=int, default=6000)
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--temperature", type=float, default=300.0)
    ap.add_argument("--friction", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--precision", choices=("fp32", "fp64"), default=None,
                    help="replace the deck's precision")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs only when "
                         "asked for)")
    ap.add_argument("--out", required=True, help="the JSON artifact")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run "
                         "on the CPU")
    build = load_build(args.gro, args.ffpmt, args.top, args.simpmt,
                       args.state, device, args.precision)
    out, _, _ = run_pmf(build, n_windows=args.windows, span=args.span,
                        k_spring=args.k, k_roo=args.k_roo, r_oo=args.r_oo,
                        n_equil=args.equil, n_sample=args.sample,
                        chunk=args.chunk, temperature=args.temperature,
                        friction=args.friction, seed=args.seed)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in
                      ("barrier_kjmol", "barrier_kT", "barrier_xi",
                       "hops_in_ladder", "overflow",
                       "aggregate_steps_per_s", "wham_converged",
                       "total_s")}))
    print(f"# PMF artifact -> {path}")
    return out


if __name__ == "__main__":
    main()
