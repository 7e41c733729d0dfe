"""Command-line entry point, the reference's 8-positional-file contract:

    python -m reactive_pb_nn_md_tpu_torch.run.cli \\
        in.gro ff.pmt topology.top sim.pmt traj.out log.out hop.out A.out \\
        [--device cuda|cpu] [--steps N] [--dump-forces PATH] [--profile DIR]

``--device`` defaults to ``cuda`` and fails when CUDA is absent; the CPU
runs only when asked for.  The deck's ``precision fp64|fp32`` key picks
the tensor dtype, its ``ensemble`` key NVE, NVT or NPT.  A run restarts
by itself when ``velocity_checkpoint.npz`` (in the working directory)
lies beside an existing trajectory; ``checkpoint_velocity N`` writes it
every N steps.  ``--profile DIR`` writes a torch.profiler trace of the
run (host and, on the card, device activity) into DIR, a Chrome trace
``*.pt.trace.json`` that TensorBoard's profiler plugin or
chrome://tracing opens.
"""

import argparse

import torch


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="reactive_pb_nn_md_tpu_torch",
        description="Reactive MS-EVB molecular dynamics on PyTorch + CUDA")
    for name, doc in (("gro", "input coordinates (.gro, nm)"),
                      ("ffpmt", "force-field parameter file (.pmt)"),
                      ("top", "topology file (.top)"),
                      ("simpmt", "simulation parameter file (.pmt)"),
                      ("traj", "output trajectory (.gro frames)"),
                      ("log", "output log file"),
                      ("hop", "output proton-hop event file"),
                      ("afile", "output A-factor file")):
        p.add_argument(name, help=doc)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs only when "
                        "asked for)")
    p.add_argument("--steps", type=int, default=None,
                   help="override n_step from the parameter file")
    p.add_argument("--dump-forces", default=None, metavar="PATH",
                   help="write the per-atom forces to PATH (a fresh file "
                        "each run) at every output step (print_forces, "
                        "general_routines.f90:950-991)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run into DIR "
                        "(per-op and, on the card, per-kernel times: the "
                        "JAX CLI's --profile with jax.profiler.trace)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run "
                         "on the CPU")

    from ..md.simulation import Simulation
    sim = Simulation(args.gro, args.ffpmt, args.top, args.simpmt, args.traj,
                     args.log, args.hop, args.afile, device)
    if args.dump_forces:
        sim.dump_forces_path = args.dump_forces
        open(args.dump_forces, "w").close()
    n = args.steps if args.steps is not None else sim.cfg.n_step
    if args.profile:
        with profiled(args.profile, device):
            elapsed = sim.run(n)
    else:
        elapsed = sim.run(n)
    print(f"completed {n} steps in {elapsed:.2f} s "
          f"({n / max(elapsed, 1e-9):.2f} steps/s)")
    return sim


def profiled(out_dir, device):
    """A torch.profiler context writing its trace into out_dir when it
    ends (CPU activity, and CUDA activity on a CUDA device)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(str(out_dir)))


if __name__ == "__main__":
    main()
