"""Velocity initialization and kinetic energy (counterpart of
reactive_pb_nn_md_tpu/md/velocities.py; md_integration.f90:48-177)."""

import torch

from ..utils.constants import CONV_KJMOL_A2PS2GMOL, KB


def freeze_mask(system, topo):
    """(N,) bool: True for mobile atoms."""
    return system.ff.freeze_by_type[topo.atom_type] != 1


def kinetic_energy(v, mass):
    return 0.5 * torch.sum(mass[:, None] * v * v) / CONV_KJMOL_A2PS2GMOL


def remove_com_momentum(v, mass, mobile):
    """Subtract the net per-atom momentum so total momentum is zero."""
    n = mobile.sum()
    p = torch.where(mobile[:, None], mass[:, None] * v,
                    torch.zeros_like(v)).sum(0)
    dv = p / n / mass[:, None]
    return torch.where(mobile[:, None], v - dv, v)


def sample_velocities(generator, mass, temperature, mobile):
    """Maxwell-Boltzmann velocities from `generator` (a CPU
    torch.Generator), COM momentum removed, rescaled to exactly T."""
    sigma = torch.sqrt(KB * temperature * CONV_KJMOL_A2PS2GMOL / mass)
    g = torch.randn((mass.shape[0], 3), generator=generator,
                    dtype=torch.float64).to(mass.device, mass.dtype)
    v = torch.where(mobile[:, None], sigma[:, None] * g, torch.zeros_like(g))
    v = remove_com_momentum(v, mass, mobile)
    ke = 0.5 * torch.where(mobile[:, None], mass[:, None] * v * v,
                           torch.zeros_like(v)).sum() / CONV_KJMOL_A2PS2GMOL
    target = 1.5 * KB * temperature * mobile.sum().to(mass.dtype)
    return v * torch.sqrt(target / ke)
