"""Write a solvated CH3SO3H box for the upstream example force field
(counterpart of the JAX package's examples/ch3so3h_h2o/make_box.py):

    python -m reactive_pb_nn_md_tpu_torch.run.make_acid_box
        [--n-water 215] [--n-so3 0] [--spacing 3.1] [--seed 0]
        [--out in.gro]

The upstream project ships CH3SO3H.pmt and CH3SO3H_H2O.top but no
coordinates; this writes one .gro frame of 1 CH3SO3H, --n-so3 CH3SO3-
and --n-water H2O on a jittered lattice (run/presets.make_acid_frame,
numpy-seeded: the same bytes as the JAX script's for the same
arguments), ready for equilibration.  It only writes a file: it needs no
card and no force field, so it runs the same with or without a GPU.
Running a simulation on that frame needs the two upstream files, which
this repository does not hold.
"""

import argparse

from ..io.gro import format_gro_frame
from .presets import make_acid_frame


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="reactive_pb_nn_md_tpu_torch.run.make_acid_box",
        description="Write a solvated CH3SO3H .gro frame")
    ap.add_argument("--n-water", type=int, default=215)
    ap.add_argument("--n-so3", type=int, default=0,
                    help="deprotonated CH3SO3- anions (concentrated acid)")
    ap.add_argument("--spacing", type=float, default=3.1,
                    help="lattice spacing, Angstrom")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="in.gro")
    args = ap.parse_args(argv)

    frame = make_acid_frame(n_water=args.n_water, n_so3=args.n_so3,
                            spacing=args.spacing, seed=args.seed)
    with open(args.out, "w") as f:
        f.write(format_gro_frame(frame.title, frame.mol_names,
                                 frame.mol_natom, frame.atom_names,
                                 frame.xyz, frame.box))
    print(f"wrote {args.out}: {frame.n_mole} molecules, "
          f"{len(frame.atom_names)} atoms")


if __name__ == "__main__":
    main()
