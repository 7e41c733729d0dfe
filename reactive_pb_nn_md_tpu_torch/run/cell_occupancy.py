"""Max real-space cell occupancy over an MD window (counterpart of the JAX
package's scripts/cell_occupancy.py):

    python -m reactive_pb_nn_md_tpu_torch.run.cell_occupancy [n_water]
        [pme_grid] [steps] [--device cuda] [--seed 0]

How tight can the pair kernels' static cell capacity (ccap of
topology.suggest_rs_cells: the larger of 1.5 times the mean and the mean
plus 4 Poisson sigmas, a multiple of 8) be?  The padding multiplies
the kernels' candidate work (A'' stages 14 x ccap slots a cell), and the
liquid's density fluctuations are well below Poisson's.  On the water
box of run/presets.build_water (default the 10k box: 3,332 H2O + 1
H3O+, PME 64^3, fp32, state cap 32) it runs `steps` NVE steps (default
512) in chunks of 64 and, after each, counts the atoms of the fullest
kernel cell and of the fullest PME slab (atoms binned by the x corner
floor(u1) of their scaled grid coordinates, the slab spread's binning).
A capacity that does not hold is regrown and the chunk replayed
(integrators.regrown_chunk); the caps printed are those at the end.
"""

import argparse
import json

import numpy as np
import torch

from ..convert import cli_device
from ..md import graphs, integrators
from ..utils import pbc
from . import presets

N_WATER, PME_GRID, STEPS, CHUNK = 3332, 64, 512, 64


def max_occupancy(x, box, cells, K):
    """(atoms in the fullest cell of the (nc1, nc2, nc3) grid, atoms in
    the fullest of the K slabs)."""
    nc1, nc2, nc3 = cells[:3]
    ncv = torch.tensor([nc1, nc2, nc3], device=x.device)
    frac = x / torch.diagonal(box)[None, :]
    frac = frac - torch.floor(frac)
    ci = torch.minimum((frac * ncv).long(), ncv - 1)
    cell = (ci[:, 0] * nc2 + ci[:, 1]) * nc3 + ci[:, 2]
    u1 = torch.floor(pbc.scaled_grid_coords(x, box, K)[:, 0]).long()
    slab = torch.clamp(u1, 0, K - 1)
    return (int(torch.bincount(cell, minlength=nc1 * nc2 * nc3).max()),
            int(torch.bincount(slab, minlength=K).max()))


def occupancy(build, steps=STEPS, chunk=CHUNK, log=print):
    """The window on `build`: a dict with the per-chunk maxima, their
    means and the caps."""
    system, cbw, cfg, ms = build
    cells, K = system.rs_cells, system.pme_grid
    if not cells:
        raise SystemExit("the box has no kernel cell grid (rs_cells ())")
    sg = graphs.StepGraphs() if ms.state.x.is_cuda else None
    now, caps, regrows = system, integrators.capacities_of(ms), 0
    occs, slabs = [], []
    chunk = min(chunk, steps)
    for i in range(steps // chunk):
        r = integrators.regrown_chunk(
            ms, now, cbw, caps, cfg.evb_hard_max_states, cfg.delta_t, "NVE",
            chunk, step_graphs=sg, tolerate=(integrators.EVB_STATE_CAP,),
            log=lambda lines: log("\n".join("# " + ln.rstrip()
                                             for ln in lines)))
        ms, now, caps, regrows = r.ms, r.system, r.caps, regrows + r.regrows
        mo, so = max_occupancy(ms.state.x, ms.state.box, cells, K)
        occs.append(mo)
        slabs.append(so)
        if i % 2 == 1:
            log(f"step {(i + 1) * chunk}: cell max = {max(occs)} slab max = "
                f"{max(slabs)}")
    n = system.n_atoms
    out = dict(steps=len(occs) * chunk, rs_cells=list(cells),
               cell_mean=n / (cells[0] * cells[1] * cells[2]),
               cell_max=max(occs), cell_median=float(np.median(occs)),
               ccap=cells[3], ccap_now=now.rs_cells[3],
               slab_mean=n / K, slab_max=max(slabs),
               slab_median=float(np.median(slabs)),
               scap=system.pme_scap, scap_now=now.pme_scap,
               regrows=regrows)
    log(f"cell mean {out['cell_mean']:.2f} max {out['cell_max']} (median "
        f"{out['cell_median']:.0f}) ccap {out['ccap']}; slab mean "
        f"{out['slab_mean']:.1f} max {out['slab_max']} (median "
        f"{out['slab_median']:.0f}) scap {out['scap']} over "
        f"{out['steps']} steps")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="reactive_pb_nn_md_tpu_torch.run.cell_occupancy",
        description="Max real-space cell and PME slab occupancy")
    ap.add_argument("n_water", nargs="?", type=int, default=N_WATER)
    ap.add_argument("pme_grid", nargs="?", type=int, default=PME_GRID)
    ap.add_argument("steps", nargs="?", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs only when "
                         "asked for)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    b = presets.build_water(args.n_water, args.pme_grid, "fp32", 32,
                            seed=args.seed, device=device)
    print(f"rs_cells = {b[0].rs_cells}  pme_scap = {b[0].pme_scap}",
          flush=True)
    out = occupancy(b, args.steps, log=lambda m: print(m, flush=True))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
