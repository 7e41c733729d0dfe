"""PB-NN coupling transfer: train on one water box, evaluate the frozen
MLP on boxes it never saw (counterpart of the JAX package's
scripts/pbnn_transfer.py, parts A and B):

    python -m reactive_pb_nn_md_tpu_torch.run.pbnn_transfer [--frames 8]
        [--rattle 0.05] [--pretrain-steps 1500] [--finetune-steps 20]
        [--device cuda] [--dtype fp64] [--out build/pbnn_transfer.json]

The neural coupling (function type 3) of the water <-> hydronium triple
(OW, O_h3o, H_h3o) is pretrained on the analytic MS-EVB3 geometric
surface of the 26-water box and finetuned on its rattled frames, the
first 3/4 training and the rest held out (nn/train.py
finetune_heldout).  The same parameters, frozen, are then evaluated

  A  on all frames of the training box (26 H2O + H3O+, 82 atoms, PME
     16^3): no shift;
  B  on a 2.4x larger water box (63 H2O + H3O+, 193 atoms, PME 24^3):
     a size and electrostatics shift, the same chemistry.

Only the triple switches to the MLP; every other coupling stays
analytic.  Labels are each box's analytic adiabatic energies; a row's
RMSE is over its rattled frames.  Part C (the CH3SO3H acid box) and the
reverse direction (train on acid frames, test on water) need the
upstream acid force field and topology (CH3SO3H.pmt, CH3SO3H_H2O.top),
which the repository does not hold: their rows are printed and written
as {"system": ..., "blocked": "CH3SO3H files not in the repo"}.

The boxes are run/presets.water_system's (the JAX script's fixture
boxes, seeds 9 and 4).  The frames draw from numpy default_rng (seeds 3
and 5), so they equal the JAX script's bit for bit; the pretraining's
samples and initial MLP draw from a torch.Generator seeded 1 (the JAX
script's jax.random.PRNGKey(1) stream has no torch counterpart, so the
trained MLP differs from the JAX script's by its draws).  Each frame has
its own diabat set and is evaluated eagerly (nn/train.py), on the card
unless --device cpu is given; both boxes are too small for a cell grid,
so kernel A does not run and the real-space term is plain torch, as in
the JAX package.  The artifact (the JAX layout: train_water_heldout,
train_acid_heldout, transfer, config, total_s; plus each stage's
seconds and the card) goes to --out, under the git-ignored build/ by
default.
"""

import argparse
import json
import math
import pathlib
import time

import numpy as np
import torch

from ..convert import cli_device, resolve_device
from ..models import pme
from ..nn import coupling_mlp
from ..nn import train as nt
from ..ops import neighbors
from ..utils.dtypes import float_dtype
from . import presets
from .scale_run import nvidia_smi

ROOT = pathlib.Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "pbnn_transfer.json"
TRIPLE = ("OW", "O_h3o", "H_h3o")
BLOCKED = "CH3SO3H files not in the repo"
ACID = "acid CH3SO3H/H2O (upstream FF)"


def build_water(n_water, pme_grid, seed, device="cuda", precision="fp64"):
    """(system, topo, x0, box) of the water box of n_water H2O and one
    H3O+ (run/presets.water_system, MS-EVB on) on `device`."""
    system, topo, frame, cfg = presets.water_system(
        n_water, pme_grid, precision, seed=seed, device=device)
    f = float_dtype(cfg.precision)
    dev = resolve_device(device)
    return (system, topo, torch.as_tensor(frame.xyz, dtype=f, device=dev),
            torch.as_tensor(frame.box, dtype=f, device=dev))


def make_frames(system, topo, x0, box, n_frames, rattle, seed):
    """(xs, full_idxs, pair_j, pair_mask, cbw): n_frames copies of x0
    rattled by numpy normal(0, rattle) draws from default_rng(seed) (added
    in fp64, then cast to x0's dtype), each with its dense neighbor views
    at one capacity (neighbors.suggest_capacity for the box's volume),
    stacked, and the box's reciprocal weights.  A frame that overflows
    the capacity raises."""
    cap = neighbors.suggest_capacity(
        system.n_atoms, abs(float(np.linalg.det(box.detach().cpu()
                                                .double().numpy()))),
        system.verlet_cutoff)
    rng = np.random.default_rng(seed)
    xs, fidx, pj, pm = [], [], [], []
    for _ in range(n_frames):
        noise = torch.from_numpy(rng.normal(0.0, rattle, tuple(x0.shape)))
        xf = (x0.double() + noise.to(x0.device)).to(x0.dtype)
        nl = neighbors.build_neighbor_list(xf, box, system.verlet_cutoff,
                                           cap)
        if bool(nl.overflow):
            raise RuntimeError(f"a rattled frame overflows the neighbor "
                               f"capacity {cap}")
        _, j, m = neighbors.neighbor_pairs(nl)
        xs.append(xf)
        fidx.append(nl.full_idx)
        pj.append(j)
        pm.append(m)
    cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt, dtype=x0.dtype)
    return (torch.stack(xs), torch.stack(fidx), torch.stack(pj),
            torch.stack(pm), cbw)


def water_triple(system):
    """The (OW, O_h3o, H_h3o) type indices."""
    names = system.ff.atype_names
    return tuple(names.index(n) for n in TRIPLE)


def labels(system, topo, box, cbw, frames):
    """The analytic adiabatic energies (F,) of the frames (xs, full_idxs,
    pair_j, pair_mask)."""
    with torch.no_grad():
        return nt.make_frame_energy_fn(system, topo, box, cbw)(None,
                                                               *frames)


def mlp_energies(system, topo, box, cbw, frames, nn):
    """The frames' adiabatic energies (F,) with the triple switched to the
    MLP nn."""
    sys_nn = coupling_mlp.attach(system, nn, TRIPLE)
    with torch.no_grad():
        return nt.make_frame_energy_fn(sys_nn, topo, box, cbw)(nn, *frames)


def frame_energies(system, topo, box, cbw, frames, nn):
    """(labels, MLP energies) of the frames."""
    return (labels(system, topo, box, cbw, frames),
            mlp_energies(system, topo, box, cbw, frames, nn))


def eval_system(tag, system, topo, box, cbw, frames, nn):
    """The JAX script's row of one system: the frames' energy RMSE with
    the triple switched to the trained MLP against the analytic labels,
    and the labels' spread."""
    e_ref, e_nn = frame_energies(system, topo, box, cbw, frames, nn)
    rmse = math.sqrt(float(torch.mean((e_nn - e_ref) ** 2)))
    spread = float(e_ref.max() - e_ref.min())
    return {"system": tag, "rmse_kjmol": round(rmse, 4),
            "frame_energy_spread_kjmol": round(spread, 2),
            "n_frames": int(frames[0].shape[0])}


def train_on(system, topo, box, cbw, frames, pretrain_steps, finetune_steps,
             split=0.75, seed=1):
    """Pretrain the MLP on the system's analytic geometric surface (a
    torch.Generator seeded `seed`, the frames' dtype) and finetune it on
    the frames' first `split` (nt.finetune_heldout): (MLP, held-out
    report)."""
    xs = frames[0]
    row = system.evb.cpl_params[water_triple(system)]
    nn, _ = nt.pretrain_geometric(row, torch.Generator().manual_seed(seed),
                                  steps=pretrain_steps, dtype=xs.dtype,
                                  device=xs.device)
    return nt.finetune_heldout(
        nn, coupling_mlp.attach(system, nn, TRIPLE), topo, box, cbw,
        *frames, labels(system, topo, box, cbw, frames), split=split,
        steps=finetune_steps)


def blocked(system, direction):
    """A row the acid box would give: blocked."""
    return {"system": system, "blocked": BLOCKED, "direction": direction}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="reactive_pb_nn_md_tpu_torch.run.pbnn_transfer",
        description="PB-NN coupling transfer across water boxes")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--rattle", type=float, default=0.05, help="Angstrom")
    ap.add_argument("--pretrain-steps", type=int, default=1500)
    ap.add_argument("--finetune-steps", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs only when "
                         "asked for)")
    ap.add_argument("--dtype", choices=("fp64", "fp32"), default="fp64")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    device = cli_device(args.device)

    def stamp():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = stamp()
    wA = build_water(26, 16, 9, device, args.dtype)     # train box, 82 atoms
    wB = build_water(63, 24, 4, device, args.dtype)     # 193 atoms, K = 24
    frA = make_frames(*wA, args.frames, args.rattle, 3)
    frB = make_frames(*wB, args.frames, args.rattle, 5)
    seconds = {"build": stamp() - t0}
    print(f"# systems built [{seconds['build']:.1f}s]; the acid box: "
          f"{BLOCKED}", flush=True)

    t1 = stamp()
    nn, repA = train_on(wA[0], wA[1], wA[3], frA[4], frA[:4],
                        args.pretrain_steps, args.finetune_steps)
    seconds["train"] = stamp() - t1
    print(f"# trained on water ({repA}) [{stamp() - t0:.0f}s]", flush=True)
    t2 = stamp()
    rows = [
        dict(eval_system("water26 (train box, all frames)", wA[0], wA[1],
                         wA[3], frA[4], frA[:4], nn), direction="water->"),
        dict(eval_system("water63 (2.4x box, K=24)", wB[0], wB[1], wB[3],
                         frB[4], frB[:4], nn), direction="water->"),
        blocked(ACID, "water->"),
        blocked("acid (train box, all frames)", "acid->"),
        blocked("water26", "acid->"),
    ]
    seconds["evaluate"] = stamp() - t2
    for r in rows:
        print(json.dumps(r), flush=True)
    out = {"train_water_heldout": repA,
           "train_acid_heldout": blocked("acid (train box)", "acid->"),
           "transfer": rows, "config": vars(args),
           "total_s": round(stamp() - t0, 1), "seconds": seconds,
           "device": str(device)}
    if device.type == "cuda":
        out["card"] = nvidia_smi()
        print(out["card"], flush=True)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"# transfer artifact -> {path}", flush=True)
    return out


if __name__ == "__main__":
    main()
