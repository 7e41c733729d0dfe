"""Umbrella-sampling restraints on the proton-transfer coordinate
(counterpart of reactive_pb_nn_md_tpu/md/bias.py).

A harmonic restraint U = 0.5 k (cv - center)^2 on a scalar collective
variable (CV) of three atoms, atoms = [donor heavy, acceptor heavy,
proton] (global atom indices, stable across proton hops):

  cv_type 0  delta r_OH = |r_H - r_Od| - |r_H - r_Oa|   (A)
             < 0 proton on the donor, 0 shared, > 0 transferred;
  cv_type 1  R_OO = |r_Od - r_Oa|                        (A)

Distances are minimum-imaged, each with the JAX package's floor
sqrt(max(dr.dr, 1e-12)).  md_step adds the restraint force to the
physical force before the second half kick and its energy to the
reported potential (md/integrators.py); a tuple of restraints sums (the
window restraint first, keepers after).

The atoms are read with one (3,) index tensor and the force is analytic
(dU/dcv dcv/dx, scattered back with index_add), so the restraint makes no
host synchronization and reads k, center and the atoms from tensors: a
captured step (md/graphs.py) serves every window of a ladder, its
restraint copied in at each chunk's start.
"""

from dataclasses import dataclass

import torch

from ..utils import pbc


@dataclass
class HarmonicBias:
    """U = 0.5 k (cv - center)^2.  A window ladder (parallel/umbrella.py
    make_ladder) holds (W, 3) atoms and (W,) k / center; window_bias takes
    one window's."""
    atoms: torch.Tensor     # (3,) int64: [donor heavy, acceptor heavy, H]
    k: torch.Tensor         # () kJ/mol/A^2, the state's dtype
    center: torch.Tensor    # () A, the state's dtype
    cv_type: int = 0


def as_tuple(bias):
    """None, or the restraints of `bias` (one HarmonicBias or a tuple) as
    a tuple."""
    if bias is None or isinstance(bias, tuple):
        return bias
    return (bias,)


def _dist_unit(a, b, box):
    """(|min_image(a - b)| floored at 1e-6, its gradient w.r.t. a)."""
    dr = pbc.min_image(a - b, box)
    s = (dr * dr).sum()
    d = torch.sqrt(torch.clamp(s, min=1e-12))
    return d, torch.where(s > 1e-12, dr / d, torch.zeros_like(dr))


def _cv_grad(x, box, bias):
    """(cv, (3, 3) dcv/d[r_donor, r_acceptor, r_H])."""
    r = x[bias.atoms]
    r_d, r_a, r_h = r[0], r[1], r[2]
    if bias.cv_type == 0:
        d1, u1 = _dist_unit(r_h, r_d, box)
        d2, u2 = _dist_unit(r_h, r_a, box)
        return d1 - d2, torch.stack([-u1, u2, u1 - u2])
    if bias.cv_type == 1:
        d, u = _dist_unit(r_d, r_a, box)
        return d, torch.stack([u, -u, torch.zeros_like(u)])
    raise ValueError(f"unknown cv_type {bias.cv_type}")


def collective_variable(x, box, bias: HarmonicBias):
    """The CV of one restraint's atom triple, a 0-d tensor."""
    return _cv_grad(x, box, bias)[0]


def bias_energy(x, box, bias):
    """Total restraint energy of one HarmonicBias or a tuple of them."""
    return bias_energy_force(x, box, bias)[0]


def bias_energy_force(x, box, bias):
    """(energy, (N, 3) force) of the restraint(s), force = -dU/dx."""
    e = torch.zeros((), dtype=x.dtype, device=x.device)
    f = torch.zeros_like(x)
    for b in as_tuple(bias):
        cv, g = _cv_grad(x, box, b)
        dev = cv - b.center
        e = e + 0.5 * b.k * dev ** 2
        f = f.index_add(0, b.atoms, -(b.k * dev) * g)
    return e, f


def primary_cv(x, box, bias):
    """The sampled CV: the first restraint's when a tuple is given (the
    window coordinate; keepers come after)."""
    return collective_variable(x, box, as_tuple(bias)[0])

