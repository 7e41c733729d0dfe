"""Simulation loop, NVE (counterpart of reactive_pb_nn_md_tpu/md/simulation.py;
main_ms_evb.f90:15-122, print_step general_routines.f90:870-945).

File contract of the reference CLI: in.gro ff.pmt top sim.pmt -> trajectory
(.gro frames), log, hop file, A file.  A fixed capacity that does not hold
(neighbor rows and cells, on-demand rows, kernel A's cells, the PME slab
cap, the EVB state cap) is regrown by the JAX package's factors and the
step is redone from the state before it, so no reported energy comes from
truncated data; each regrow is one line of the log.  The EVB state cap
grows to min(evb_hard_max_states, max(2S, S + 8)); an overflow at that
ceiling ends the run with the JAX package's "aborting" line.

Not ported yet, and refused with a ValueError naming the key or the file
rather than ignored: NVT/NPT, the velocity checkpoints (checkpoint_velocity
> 0), the debug >= 2 A-file stream, and restarts.  The JAX driver restarts
when the trajectory exists beside its checkpoint; the port takes that
checkpoint's default name, velocity_checkpoint.npz, and its text sibling
velocity_checkpoint, in the trajectory's directory, and refuses to start
(and overwrite the trajectory and log) when either is there.  The A file
is created and left empty.
"""

import os
import time

import numpy as np
import torch

from ..io.gro import read_gro, format_gro_frame
from ..io.ffpmt import read_ffpmt
from ..io.topfile import read_top
from ..io.simpmt import read_sim_params
from ..topology import build_system, State
from ..models import pme
from ..ops import neighbors
from ..ops.kernels.realspace_pair import _impl_for
from ..utils import pbc
from ..utils.dtypes import float_dtype
from . import integrators, velocities


def load_deck(gro_file, ff_file, top_file, sim_file, device,
              precision=None):
    """(cfg, frame, system, topo) of a deck's four input files on `device`;
    `precision` ("fp64" | "fp32"), when given, replaces the deck's key."""
    cfg = read_sim_params(sim_file)
    if precision is not None:
        cfg.precision = precision
    frame = read_gro(gro_file)
    system, topo = build_system(frame, read_ffpmt(ff_file),
                                read_top(top_file), cfg,
                                device=torch.device(device))
    return cfg, frame, system, topo


# regrow rounds before a capacity that still overflows is an error
_MAX_REGROWS = 16
# the JAX driver's default checkpoint and its text sibling
CHECKPOINT_FILE = "velocity_checkpoint.npz"
TEXT_CHECKPOINT_FILE = "velocity_checkpoint"


def _refuse_unported(cfg, traj_file, log_file):
    """Raise ValueError on a deck key or file the JAX driver would act on
    and the port cannot honour yet."""
    if cfg.ensemble != "NVE":
        raise ValueError(f"ensemble {cfg.ensemble} is not ported yet "
                         f"(NVE only)")
    if cfg.checkpoint_velocity > 0:
        raise ValueError(f"checkpoint_velocity {cfg.checkpoint_velocity}: "
                         f"velocity checkpoints are not ported yet (set it "
                         f"to 0)")
    if cfg.debug >= 2:
        raise ValueError(f"debug {cfg.debug}: the debug >= 2 A-file stream "
                         f"is not ported yet (use debug <= 1)")
    # the JAX driver's restart conditions (md/simulation.py:64-70 there)
    d = os.path.dirname(os.path.abspath(traj_file))
    npz = os.path.join(d, CHECKPOINT_FILE)
    text = os.path.join(d, TEXT_CHECKPOINT_FILE)
    if os.path.exists(traj_file) and (
            os.path.exists(npz)
            or (os.path.exists(log_file) and os.path.exists(text)
                and os.path.getsize(text) > 0)):
        found = npz if os.path.exists(npz) else text
        raise ValueError(f"checkpoint {found} beside the trajectory "
                         f"{traj_file}: restarts are not ported yet (move "
                         f"the checkpoint or the trajectory away)")


class Simulation:
    """Owns the host loop around md_step."""

    def __init__(self, gro_file, ff_file, top_file, sim_file, traj_file,
                 log_file, hop_file, a_file, device):
        self.device = torch.device(device)
        _refuse_unported(read_sim_params(sim_file), traj_file, log_file)
        self.cfg, frame, self.system, topo = load_deck(
            gro_file, ff_file, top_file, sim_file, self.device)
        cfg = self.cfg
        self.files = dict(traj=traj_file, log=log_file, hop=hop_file,
                          a=a_file)
        f = float_dtype(cfg.precision)
        box = torch.as_tensor(frame.box, dtype=f, device=self.device)
        if frame.velocities is not None:
            v = torch.as_tensor(frame.velocities, dtype=f, device=self.device)
        else:
            gen = torch.Generator().manual_seed(cfg.seed)
            v = velocities.sample_velocities(
                gen, self.system.mass, cfg.initial_temp,
                velocities.freeze_mask(self.system, topo))
        state = State(x=torch.as_tensor(frame.xyz, dtype=f,
                                        device=self.device), v=v, box=box)
        self.cbw = pme.cb_half(box, self.system.pme_grid,
                               self.system.spline_order,
                               self.system.alpha_sqrt, dtype=f)
        self.capacity = neighbors.suggest_capacity(
            self.system.n_atoms, float(pbc.box_volume(box)),
            self.system.verlet_cutoff)
        # verlet_allpairs forces the dense O(N^2) build (the reference's
        # all-pairs fallback, general_routines.f90:1356)
        self.cells = () if cfg.verlet_allpairs else neighbors.suggest_cells(
            self.system.n_atoms, frame.box, self.system.verlet_cutoff)
        self.react_cap = self.react_cells = None
        self._log_lines = []            # written to the log when it opens
        self.log_f = None
        self._init_state(state, topo)

    def _init_state(self, state, topo, step=0):
        """MDState at `state` with the current capacities, regrown until
        they hold (regrow lines name `step`).  An EVB state-cap overflow
        at the ceiling is left in the state: the next step reports it
        and ends the run, as the JAX driver's first chunk does."""
        for _ in range(_MAX_REGROWS + 1):
            self.ms = integrators.initial_md_state(
                state, topo, self.system, self.cbw, self.capacity,
                self.cells, react_cap=self.react_cap,
                react_cells=self.react_cells)
            self.react_cap = self.ms.nlist.react_cap or None
            self.react_cells = self.ms.nlist.react_cells or None
            over = tuple(n for n in self.ms.overflow
                         if n != integrators.EVB_STATE_CAP
                         or not self._states_at_ceiling())
            if not over:
                return
            self._grow(over, step)
        raise integrators.CapacityOverflow(
            f"{', '.join(self.ms.overflow)} still exceeded after "
            f"{_MAX_REGROWS} regrows")

    def _states_at_ceiling(self):
        return self.system.evb_max_states >= self.cfg.evb_hard_max_states

    def _grow(self, names, step):
        """Grow the capacities that did not hold by the JAX package's
        factors (md/simulation.py:189-238 there) and log one line each
        for the state cap and the others.  The JAX package grows all of
        the others, its flag being shared; the port's flags are separate,
        so the others keep their size (a kernel A or slab cap grown for
        nothing costs shared memory and time)."""
        n1 = self.system.n_atoms - 1
        kw = {}
        lines = []
        if integrators.EVB_STATE_CAP in names:
            S = self.system.evb_max_states
            kw["evb_max_states"] = min(self.cfg.evb_hard_max_states,
                                       max(2 * S, S + 8))
            lines.append(f"step {step}: diabat enumeration exceeded the "
                         f"state cap; evb_max_states regrown to "
                         f"{kw['evb_max_states']}, step redone\n")
        if {integrators.NEIGHBOR_CAP, integrators.ROW_CAP} & set(names):
            self.capacity = min(int(self.capacity * 1.5) + 8, n1)
            if self.cells:
                nc1, nc2, nc3, ccap = self.cells
                self.cells = (nc1, nc2, nc3, int(ccap * 1.5) + 4)
            if self.react_cap:
                self.react_cap = min(int(self.react_cap * 1.5) + 8, n1)
            if self.react_cells:
                rn1, rn2, rn3, rcc = self.react_cells
                self.react_cells = (rn1, rn2, rn3, int(rcc * 1.5) + 4)
        if integrators.RS_CELL_CAP in names:
            n1_, n2_, n3_, rcap = self.system.rs_cells
            kw["rs_cells"] = (n1_, n2_, n3_, -(-int(rcap * 1.3 + 8) // 8) * 8)
        if integrators.SLAB_CAP in names:
            # multiplicative: a melting lattice concentrates whole planes
            # into single slabs (~2.7x the mean on the 10k box)
            kw["pme_scap"] = -(-int(self.system.pme_scap * 1.3 + 16) // 8) * 8
        self.system = self.system.replace(**kw)
        others = [n for n in names if n != integrators.EVB_STATE_CAP]
        if others:
            lines.append(
                f"step {step}: regrow ({', '.join(others)} exceeded): "
                f"capacity {self.capacity} cells {self.cells} react_cap "
                f"{self.react_cap} react_cells {self.react_cells} rs_cells "
                f"{self.system.rs_cells} pme_scap {self.system.pme_scap}\n")
        self._log(lines)

    def _log(self, lines):
        """Write `lines` to the log, or keep them until it opens."""
        if self.log_f is None:
            self._log_lines.extend(lines)
        else:
            self.log_f.writelines(lines)
            self.log_f.flush()

    def _step(self, step):
        """One md_step; a capacity that did not hold is regrown and the
        step redone from the state before it.  Returns False when the
        EVB state cap overflowed at evb_hard_max_states: the step is kept,
        as the JAX driver keeps its chunk, and the run ends."""
        for _ in range(_MAX_REGROWS):
            ms = integrators.md_step(self.ms, self.system, self.cbw,
                                     self.cfg.delta_t)
            if not ms.overflow:
                self.ms = ms
                return True
            if integrators.EVB_STATE_CAP in ms.overflow \
                    and self._states_at_ceiling():
                self._log([f"step {step}: diabat enumeration exceeded "
                           f"evb_hard_max_states="
                           f"{self.cfg.evb_hard_max_states} -- aborting "
                           f"(reference behavior, ms_evb.f90:3107-3123)\n"])
                self.ms = ms
                return False
            self._grow(ms.overflow, step)
            self._init_state(self.ms.state, self.ms.topo, step)
        raise integrators.CapacityOverflow(
            f"step {step}: {', '.join(ms.overflow)} still exceeded after "
            f"{_MAX_REGROWS} regrows")

    def _write_frame(self, step):
        topo = self.ms.topo
        names = [self.system.mt.mtype_names[t]
                 for t in topo.mol_mtype.tolist()]
        ma = topo.mol_atoms.cpu().numpy().ravel()
        order = ma[ma >= 0]
        anames = np.asarray(self.system.ff.atype_names)[
            topo.atom_type.cpu().numpy()[order]].tolist()
        self.traj_f.write(format_gro_frame(
            f"step {step}", names, topo.mol_natom.cpu().numpy(), anames,
            self.ms.state.x.cpu().numpy()[order],
            self.ms.state.box.cpu().numpy()))
        self.traj_f.flush()

    def _log_header(self):
        cfg, s = self.cfg, self.system
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        self.log_f.write("\n".join([
            "reactive_pb_nn_md_tpu_torch simulation",
            f" ensemble {cfg.ensemble}  steps {cfg.n_step}  "
            f"dt(ps) {cfg.delta_t}  T(K) {cfg.temperature}",
            f" atoms {s.n_atoms}  molecules {s.n_mole}  "
            f"molecule types {len(s.mt.mtype_names)}",
            f" real_space_cutoff {s.real_space_cutoff}  "
            f"verlet_cutoff {s.verlet_cutoff}  alpha_sqrt {s.alpha_sqrt}",
            f" pme_grid {s.pme_grid}^3  spline_order {s.spline_order}  "
            f"n_exclusions {s.n_exclusions}",
            f" ms_evb {s.ms_evb}  evb_max_states {s.evb_max_states}  "
            f"evb_max_chain {s.evb_max_chain}",
            f" neighbor cells {self.cells or 'dense'}  rs_cells "
            f"{s.rs_cells or '()'} "
            f"({_impl_for(s.rs_cells) if s.rs_cells else 'pair list'})  "
            f"pme_scap {s.pme_scap or '0 (per-atom spread)'}",
            f" lj_comb_rule {cfg.lj_comb_rule}  precision {cfg.precision}  "
            f"device {self.device} ({name})", ""]))
        self.log_f.flush()

    def _log_step(self, step):
        ms = self.ms
        bd = ms.breakdown
        ke, pe = float(ms.kinetic), float(ms.potential)
        line = (f"step {step:10d} time(ps) {step * self.cfg.delta_t:12.4f}\n"
                f" KE {ke:14.6f} PE {pe:14.6f} Etot {ke + pe:14.6f}\n"
                f" Eelec {float(bd.elec):14.6f} Evdw {float(bd.vdw):14.6f}"
                f" Ebond {float(bd.bond):12.6f} Eangle {float(bd.angle):12.6f}"
                f" Edihedral {float(bd.dihedral):12.6f}\n")
        if self.system.ms_evb and self.cfg.print_ms_evb_data:
            c = ms.eigenvector.cpu().numpy()
            n = int(ms.n_states)
            hyd = ms.hydronium_of.cpu().numpy()
            shell = ms.n_hops_of.cpu().numpy()
            line += (f" diabats {n} max_ci2 {float(np.max(c ** 2)):8.5f} "
                     f"hydronium_mol {int(ms.topo.hydronium_mol) + 1}\n")
            # per-diabat block (print_evb_trajectory_data)
            line += f" i_step {step} number of diabats {n}\n"
            for s in range(n):
                line += (f"  diabat {s + 1:3d} hydronium_molecule "
                         f"{int(hyd[s]) + 1:6d} ci^2 {float(c[s] ** 2):10.6f}"
                         f" solvation_shell {int(shell[s]):2d}\n")
            line += "\n"
        self.log_f.write(line)
        self.log_f.flush()

    def run(self, n_steps=None):
        """Run n_steps NVE steps; returns the wall seconds of the loop."""
        cfg = self.cfg
        n_steps = cfg.n_step if n_steps is None else n_steps
        with open(self.files["traj"], "w") as self.traj_f, \
                open(self.files["log"], "w") as self.log_f, \
                open(self.files["hop"], "w") as hop_f, \
                open(self.files["a"], "w"):
            self._log_header()
            self.log_f.writelines(self._log_lines)
            self._log_lines = []
            self._log_step(0)
            self._write_frame(0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            step = 0
            while step < n_steps:
                prev_h = int(self.ms.topo.hydronium_mol) \
                    if self.system.ms_evb else -1
                going = self._step(step + 1)
                step += 1
                if self.ms.hopped:
                    hop_f.write(f"step  {step}\n proton hop from "
                                f"{prev_h + 1} to "
                                f"{int(self.ms.topo.hydronium_mol) + 1}\n")
                    hop_f.flush()
                if self.ms.force_overflow:
                    self.log_f.write(f"step {step}: force magnitude exceeded "
                                     f"1e4 kJ/mol/A -- aborting (reference "
                                     f"behavior, md_integration.f90:523-526)\n")
                    break
                if step % cfg.n_output == 0:
                    self._log_step(step)
                    self._write_frame(step)
                if not going:
                    break
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            elapsed = time.perf_counter() - t0
            self.log_f.write(f"completed {step} steps in {elapsed:.2f} s "
                             f"({step / max(elapsed, 1e-9):.2f} steps/s)\n")
        self.log_f = None
        return elapsed
