"""Monte-Carlo barostat for NPT (counterpart of
reactive_pb_nn_md_tpu/md/barostat.py; monte_carlo_barostat,
md_integration.f90:231-386).

A host-side move every `barofreq` steps; the trial's energy is one more
force evaluation on the device.  As the reference:

  * a random isotropic box-length change within +/- baroscale * L;
  * molecules moved with their centres of mass, kept whole;
  * Metropolis weight w = dE + p dV - 3 M kT ln(L'/L);
  * a proton hop during the trial forces acceptance (:320-323);
  * baroscale adapts toward 25-75% acceptance past 10 trials (:374-384).

The draws come from numpy's default_rng(seed + 777), as in the JAX
package, so both packages make the same decisions on the same energies.
No trial energy comes from truncated data: the trial state is settled
(its capacities regrown) before its energy is used.
"""

import dataclasses

import numpy as np
import torch

from ..utils.constants import KB, CONV_BAR_KJMOLA3
from ..evb.enumerate import molecule_com
from ..models import pme
from ..topology import State
from . import integrators


def settle_plain(state, ms, system, cbw):
    """The trial's MDState with ms's neighbor configuration and no
    regrow (md/simulation.py regrows instead)."""
    nl = ms.nlist
    return integrators.initial_md_state(
        state, ms.topo, system, cbw, nl.capacity, nl.cells,
        react_cap=nl.react_cap or None, react_cells=nl.react_cells)


class MCBarostat:
    def __init__(self, pressure, temperature, baroscale=0.01, seed=0):
        self.pressure = pressure
        self.temperature = temperature
        self.baroscale = baroscale
        self.n_trials = 0
        self.n_accept = 0
        self.rng = np.random.default_rng(seed + 777)
        self.history = []              # (dE, accepted) of every trial

    def attempt(self, ms, system, cbw, settle=settle_plain):
        """One MC volume move; returns (MDState, cbw), the trial's when
        accepted.  settle(state, ms, system, cbw) evaluates the trial
        state; a capacity it did not hold raises."""
        box = ms.state.box.detach().cpu().numpy()
        if not np.allclose(np.diag(np.diag(box)), box):
            raise ValueError("MC barostat requires a cubic box")
        L = float(box[0, 0])
        self.n_trials += 1

        dL = L * self.baroscale * (self.rng.uniform() * 2.0 - 1.0)
        newL = L + dL
        scale = newL / L

        x = ms.state.x
        com = molecule_com(x, ms.topo.mol_atoms, system.mass, ms.state.box)
        x_new = x + (com * scale - com)[ms.topo.atom_mol]
        new_box = ms.state.box * scale
        new_cbw = pme.cb_half(new_box, system.pme_grid, system.spline_order,
                              system.alpha_sqrt, dtype=x.dtype)
        trial = settle(State(x=x_new, v=ms.state.v, box=new_box,
                             step=ms.state.step), ms, system, new_cbw)
        over = integrators.overflowed(trial)
        if over:
            raise integrators.CapacityOverflow(
                f"barostat trial: {', '.join(over)} exceeded")

        kT = KB * self.temperature
        dE = float(trial.potential) - float(ms.potential)
        pV = CONV_BAR_KJMOLA3 * self.pressure * (newL ** 3 - L ** 3)
        S = system.n_mole * kT * 3.0 * np.log(scale)
        w = dE + pV - S
        hopped = bool(trial.topo.hydronium_mol != ms.topo.hydronium_mol)
        if hopped:
            w = -1.0     # force acceptance across a proton hop

        accept = w < 0 or self.rng.uniform() <= np.exp(-w / kT)
        self.history.append((dE, bool(accept)))
        if accept:
            self.n_accept += 1
            # the position residuals refer to the unscaled coordinates:
            # restart them
            comp = ms.comp
            if comp is not None:
                comp = integrators.CompCarry(x=torch.zeros_like(comp.x),
                                             v=comp.v)
            ms = dataclasses.replace(trial, comp=comp)
            cbw = new_cbw

        if self.n_trials > 10:
            if self.n_accept < 0.25 * self.n_trials:
                self.baroscale /= 1.1
                self.n_trials = self.n_accept = 0
            elif self.n_accept > 0.75 * self.n_trials:
                self.baroscale *= 1.1
                self.n_trials = self.n_accept = 0

        return ms, cbw
