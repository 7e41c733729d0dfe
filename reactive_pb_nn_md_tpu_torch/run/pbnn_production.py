"""A PB-NN coupling driving the production Simulation, against its
analytic twin (counterpart of the JAX package's
scripts/pbnn_production.py):

    python -m reactive_pb_nn_md_tpu_torch.run.pbnn_production
        [--steps 1536] [--out build/pbnn_production.json]
        [--device cuda] [--seed 0]

runs the flagship deck (examples/water_msevb/: 215 H2O + 1 H3O+, PME
32^3, its lattice start) twice through md/simulation.Simulation, the
8-file contract with its trajectory, log and hop file, fp32, output
every 128 steps:

  analytic  the MS-EVB3 couplings, softened by presets.soften_for_hops
            at SPONT_SCALES (the JAX bench's, all 1.0: the published
            surface);
  pbnn      the same softening, then the (OW, O_h3o, H_h3o) triple
            switched to coupling function type 3: an MLP pretrained on
            that triple's softened analytic geometric surface
            (nn/train.py pretrain_geometric, fp32, 1,500 steps, samples
            and initial weights from a torch.Generator seeded 3),
            attached with Simulation.mutate_system.

and compares what the two runs' users look at: hop events, the distinct
molecules they visit, steps/s.  The two surfaces differ by the fit's
residual and the dynamics is chaotic, so the trajectories part; the hop
statistics should not, if the fit is good.

Hops are counted from the hop file's " proton hop from A to B" lines
(one event each; a hop writes two lines, "step  N" and that one) and
from Simulation.hopped_rows (the hopped rows of every chunk), which must
agree; the JAX script's count of non-empty lines is printed beside them
as jax_style_line_count (twice the events), so that the JAX package's
committed artifact (benchdata/pbnn_production.json) can be compared.  A
run fails (the artifact says why and the exit code is 1) when an output
step's Etot is not finite, when it ends early (the reference's aborting
lines: a state cap at its ceiling, a force above 1e4 kJ/mol/A), when
kernel E does not converge, or when the event counts disagree; a
capacity that does not hold is regrown and its chunk replayed by the
Simulation, so no reported number comes from truncated data.  steps/s is
the wall of Simulation.run (the chunks' captures included), in chunks of
128 steps.  The artifact goes to --out (under the git-ignored build/ by
default), never to benchdata/.  --seed is the deck's seed (the initial
velocities' draws).
"""

import argparse
import json
import math
import pathlib
import re
import shutil
import tempfile

import torch

from ..convert import cli_device
from ..md import integrators
from ..md.simulation import Simulation
from ..nn import coupling_mlp
from ..nn import train as nt
from . import presets
from .scale_run import nvidia_smi
from .spontaneous_hops import SPONT_SCALES

ROOT = pathlib.Path(__file__).resolve().parents[2]
DECK = ROOT / "examples" / "water_msevb"
OUT = ROOT / "build" / "pbnn_production.json"
TRIPLE = ("OW", "O_h3o", "H_h3o")
N_OUTPUT = 128                  # the output cadence, and the chunk
PRETRAIN_STEPS, PRETRAIN_SEED = 1500, 3
SCALE_NAMES = ("coupling_scale", "da_scale", "pa_scale", "c12_scale")
_HOP = re.compile(r"^\s*proton hop from (\d+) to (\d+)\s*$")


def set_keys(text, **keys):
    """The sim.pmt `text` with each key's line set to its value; a key the
    deck does not have raises (a silent no-op would run another deck)."""
    for key, value in keys.items():
        pat = re.compile(rf"^{key}\s+\S+.*$", re.MULTILINE)
        if not pat.search(text):
            raise KeyError(f"sim.pmt has no {key!r} line")
        text = pat.sub(f"{key:<18} {value}", text, count=1)
    return text


def make_mutate(scales, nn_attach, nn=None, log=print, info=None):
    """Simulation.mutate_system's function: soften_for_hops(*scales), then
    with nn_attach the triple switched to an MLP (`nn`, or one pretrained
    on the softened triple's analytic row; its rmse into info["rmse"])."""
    def mutate(system):
        system = presets.soften_for_hops(system, *scales)
        if not nn_attach:
            return system
        mlp = nn
        if mlp is None:
            names = system.ff.atype_names
            row = system.evb.cpl_params[tuple(names.index(n)
                                              for n in TRIPLE)]
            mlp, rmse = nt.pretrain_geometric(
                row, torch.Generator().manual_seed(PRETRAIN_SEED),
                steps=PRETRAIN_STEPS, dtype=torch.float32,
                device=row.device)
            log(f"# pretrained the MLP on the softened analytic surface, "
                f"rmse {rmse:.4f}")
            if info is not None:
                info["rmse"] = rmse
        return coupling_mlp.attach(system, mlp, TRIPLE)

    return mutate


def hop_counts(text):
    """(events, distinct molecules, the JAX script's line count) of a hop
    file's text."""
    events = [m.groups() for m in map(_HOP.match, text.splitlines()) if m]
    mols = {int(v) for e in events for v in e}
    return len(events), len(mols), sum(1 for ln in text.splitlines()
                                       if ln.strip())


def output_etot(log_text):
    """The Etot of every output step in a Simulation log."""
    return [float(ln.split()[5]) for ln in log_text.splitlines()
            if ln.startswith(" KE")]


def run_one(tag, steps, nn_attach, workdir, scales=SPONT_SCALES,
            device="cuda", seed=0, nn=None, log=print):
    """One run of the flagship deck through Simulation (see the module
    docstring) in workdir/tag: its numbers and the reasons it failed
    ("failed", empty when it did not)."""
    wd = pathlib.Path(workdir) / tag
    wd.mkdir(parents=True)
    for f in ("in.gro", "ff.pmt", "top.top"):
        shutil.copy(DECK / f, wd / f)
    text = set_keys((DECK / "sim.pmt").read_text(), precision="fp32",
                    n_output=N_OUTPUT)
    (wd / "sim.pmt").write_text(text.rstrip("\n") + f"\nseed  {seed}\n")
    files = [wd / n for n in ("in.gro", "ff.pmt", "top.top", "sim.pmt",
                              "traj.out", "log.out", "hop.out", "a.out")]
    sim = Simulation(*map(str, files), device=device,
                     checkpoint_file=str(wd / "chk.npz"))
    info = {}
    sim.mutate_system(make_mutate(scales, nn_attach, nn, log, info))
    failed = []
    wall = math.nan
    try:
        wall = sim.run(steps)
    except integrators.GroundStateError as e:
        failed.append(str(e))
    log_text = files[5].read_text()
    done = re.findall(r"^completed (\d+) steps", log_text, re.MULTILINE)
    done = int(done[-1]) if done else 0
    events, mols, lines = hop_counts(files[6].read_text())
    etot = output_etot(log_text)
    if done != steps:
        failed.append(f"{done} of {steps} steps done")
    if not all(math.isfinite(e) for e in etot):
        failed.append("a non-finite Etot at an output step")
    if events != sim.hopped_rows:
        failed.append(f"{events} hop lines against {sim.hopped_rows} "
                      f"hopped rows")
    aborted = [ln for ln in log_text.splitlines() if "aborting" in ln]
    failed += aborted
    return {"tag": tag, "steps": steps, "steps_done": done,
            "chunk": min(N_OUTPUT, integrators.MAX_CHUNK),
            "wall_s": wall, "steps_per_s": done / wall if done else 0.0,
            "hop_events": events, "hopped_rows": sim.hopped_rows,
            "distinct_mols": mols, "jax_style_line_count": lines,
            "pretrain_rmse": info.get("rmse"),
            "etot_first": etot[0] if etot else None,
            "etot_last": etot[-1] if etot else None,
            "regrows": [ln for ln in log_text.splitlines()
                        if "regrow" in ln],
            "captures": (0 if sim.step_graphs is None
                         else len(sim.step_graphs.captures)),
            "log_tail": log_text.splitlines()[-2:], "failed": failed}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="reactive_pb_nn_md_tpu_torch.run.pbnn_production",
        description="A PB-NN coupling through Simulation against its "
                    "analytic twin")
    ap.add_argument("--steps", type=int, default=1536)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs only when "
                         "asked for)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    out = {"scales": dict(zip(SCALE_NAMES, SPONT_SCALES))}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, nn_attach in (("analytic", False), ("pbnn", True)):
            r = run_one(tag, args.steps, nn_attach, tmp, device=device,
                        seed=args.seed,
                        log=lambda m: print(m, flush=True))
            print(json.dumps(r), flush=True)
            out[tag] = r
    if device.type == "cuda":
        out["card"] = nvidia_smi()
        print(out["card"], flush=True)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"# production NN-vs-analytic artifact -> {path}", flush=True)
    failed = {t: out[t]["failed"] for t in ("analytic", "pbnn")
              if out[t]["failed"]}
    if failed:
        raise SystemExit(f"failed runs: {failed}")
    return out


if __name__ == "__main__":
    main()
