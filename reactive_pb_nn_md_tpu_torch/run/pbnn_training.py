"""Train the PB-NN diabatic coupling (function type 3), the two-stage
recipe of nn/train.py (counterpart of the JAX package's
examples/pbnn_training.py):

    python -m reactive_pb_nn_md_tpu_torch.run.pbnn_training [--n-water 26]
        [--frames 6] [--rattle 0.05] [--pretrain-steps 2000]
        [--finetune-steps 25] [--device cuda]

  1. pretrain_geometric: a supervised fit of the MLP geometric factor
     A_nn(q^2, R_OO) to the analytic MS-EVB3 surface of the
     (OW, O_h3o, H_h3o) triple (standing in for ab initio data);
  2. finetune_adiabatic: Adam through the adiabatic ground-state
     energies of rattled water + hydronium frames, the whole EVB surface
     (enumeration, diabat energies, couplings, ground state) between the
     loss and the MLP.

The box is the JAX example's (run/pbnn_transfer.build_water: n_water H2O
and one H3O+, seed 9, PME 32^3, fp64), its frames rattled by numpy draws
from default_rng(3) (pbnn_transfer.make_frames: equal to the JAX
example's frames bit for bit).  The untrained MLP draws from a
torch.Generator seeded 5 and the pretraining from one seeded 1 (the JAX
example's PRNGKey(5) and PRNGKey(1) streams have no torch counterpart).
Printed: the labels' spread, the energy RMSE against the analytic
engine untrained, pretrained and finetuned (before and after), the
improvement over the untrained MLP, each stage's seconds, and a JSON
line of the same numbers.  On the card unless --device cpu is given.
"""

import argparse
import json
import math
import time

import torch

from ..convert import cli_device
from ..nn import coupling_mlp
from ..nn import train as nt
from .pbnn_transfer import (TRIPLE, build_water, labels, make_frames,
                            mlp_energies, water_triple)
from .scale_run import nvidia_smi

PME_GRID, BOX_SEED, FRAME_SEED = 32, 9, 3
INIT_SEED, PRETRAIN_SEED = 5, 1


def rmse(e, e_ref):
    return math.sqrt(float(torch.mean((e - e_ref) ** 2)))


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="reactive_pb_nn_md_tpu_torch.run.pbnn_training",
        description="Train the PB-NN coupling in two stages")
    ap.add_argument("--n-water", type=int, default=26)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--rattle", type=float, default=0.05, help="Angstrom")
    ap.add_argument("--pretrain-steps", type=int, default=2000)
    ap.add_argument("--finetune-steps", type=int, default=25)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs only when "
                         "asked for)")
    args = ap.parse_args(argv)
    device = cli_device(args.device)

    def stamp():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    system, topo, x0, box = build_water(args.n_water, PME_GRID, BOX_SEED,
                                        device)
    *frames, cbw = make_frames(system, topo, x0, box, args.frames,
                               args.rattle, FRAME_SEED)
    row = system.evb.cpl_params[water_triple(system)]
    out = {}

    t0 = stamp()
    e_ref = labels(system, topo, box, cbw, frames)
    out["ref_s"] = stamp() - t0
    out["spread_kjmol"] = float(e_ref.max() - e_ref.min())
    print(f"[ref] {args.frames} adiabatic energies in {out['ref_s']:.1f}s; "
          f"spread {out['spread_kjmol']:.1f} kJ/mol", flush=True)

    def energies(nn):
        return mlp_energies(system, topo, box, cbw, frames, nn)

    nn_raw = coupling_mlp.init_mlp(torch.Generator().manual_seed(INIT_SEED),
                                   vconst=float(row[0]),
                                   dtype=torch.float64, device=device)
    out["rmse_untrained"] = rmse(energies(nn_raw), e_ref)
    print(f"[0] untrained MLP        energy rmse "
          f"{out['rmse_untrained']:10.4f} kJ/mol", flush=True)

    t0 = stamp()
    nn, rmse_a = nt.pretrain_geometric(
        row, torch.Generator().manual_seed(PRETRAIN_SEED),
        steps=args.pretrain_steps, dtype=torch.float64, device=device)
    out["rmse_pretrained"] = rmse(energies(nn), e_ref)
    out.update(surface_rmse=rmse_a, pretrain_s=stamp() - t0)
    print(f"[1] pretrained on A      energy rmse "
          f"{out['rmse_pretrained']:10.4f} kJ/mol (A-surface rmse "
          f"{rmse_a:.4f}; {out['pretrain_s']:.1f}s)", flush=True)

    t0 = stamp()
    nn, r0, r1 = nt.finetune_adiabatic(
        nn, coupling_mlp.attach(system, nn, TRIPLE), topo, box, cbw,
        *frames, e_ref, steps=args.finetune_steps)
    out.update(rmse_finetune_before=r0, rmse_finetuned=r1,
               finetune_s=stamp() - t0)
    print(f"[2] finetuned end-to-end energy rmse {r1:10.4f} kJ/mol "
          f"(from {r0:.4f}; {out['finetune_s']:.1f}s)", flush=True)
    out["improvement"] = out["rmse_untrained"] / max(r1, 1e-12)
    print(f"improvement vs untrained: {out['improvement']:.0f}x",
          flush=True)
    print("attach with coupling_mlp.attach(system, nn) (the triple's "
          "coupling function set to 3) or Simulation.mutate_system",
          flush=True)
    out.update(config=vars(args), device=str(device))
    if device.type == "cuda":
        out["card"] = nvidia_smi()
        print(out["card"], flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
