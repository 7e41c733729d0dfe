"""Simulation loop (counterpart of reactive_pb_nn_md_tpu/md/simulation.py;
main_ms_evb.f90:15-122, print_step general_routines.f90:870-945, the
velocity checkpoint :997-1026 and the restart auto-detect :37-178).

File contract of the reference CLI: in.gro ff.pmt top sim.pmt -> trajectory
(.gro frames), log, hop file, A file.  Ensembles NVE, NVT (Langevin, its
Gaussian draws from a torch.Generator on the run's device, seeded from the
deck's seed) and NPT (the MC barostat before every step k + 1 with
k % barofreq == 0 past the first step of the run).

The run goes in chunks, as the JAX driver's: md_scan steps to the next
host boundary (output, checkpoint, barostat move, the run's end; at most
integrators.MAX_CHUNK steps), on the card as replays of the step captured
as a CUDA graph, and the host reads the chunk's per-step diagnostics once
(hop lines, flags).  A fixed capacity that does not hold at some step of
a chunk (neighbor rows and cells, on-demand rows, kernel A's cells, the
PME slab cap, the EVB state cap) is regrown by the JAX package's factors
and the chunk is replayed from its start state and generator state, so no
reported energy comes from truncated data; each regrow is one line of
the log.  The EVB state cap grows to min(evb_hard_max_states, max(2S,
S + 8)); an overflow at that ceiling, or a force above 1e4 kJ/mol/A, ends
the run at the first step that had it (the chunk is replayed up to it),
with the JAX package's "aborting" line.  A cell grid whose cells a
barostat move (or a restart's box) makes narrower than their cutoff is
re-derived, with one log line.

Checkpoints (every checkpoint_velocity steps): a text block in the
reference's format appended to the text checkpoint, and an .npz with the
JAX package's keys (x, v, box, step, the topology, comp_x / comp_v when
compensated) plus the noise generator's state.  A run restarts when the
trajectory exists beside the .npz (exact: positions, velocities,
topology, carries and generator; a JAX-written .npz has no generator
state, which is then reseeded from the deck's seed) or, failing that,
beside the log and a non-empty text checkpoint (positions from the
trajectory's last frame, velocities from the text block).  A restart
appends to the outputs and writes no header or first frame.
"""

import os
import time

import numpy as np
import torch

from ..io.gro import (read_gro, format_gro_frame, read_last_gro_frame,
                      frame_step, format_velocity_checkpoint,
                      read_velocity_checkpoint)
from ..io.ffpmt import read_ffpmt
from ..io.topfile import read_top
from ..io.simpmt import read_sim_params
from ..topology import (build_system, check_nn_coupling, suggest_rs_cells,
                        State, Topology)
from ..evb import analysis
from ..evb.enumerate import enumerate_diabats
from ..evb.topology_ops import build_diabat_topologies, state_topology
from ..models import pme
from ..ops import neighbors
from ..ops.kernels.realspace_pair import _impl_for
from ..utils import pbc
from ..utils.dtypes import float_dtype
from . import graphs, integrators, velocities
from .barostat import MCBarostat


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


# the JAX driver's default checkpoint; its text sibling drops ".npz"
CHECKPOINT_FILE = "velocity_checkpoint.npz"
# the .npz keys of the topology (the JAX driver's) and of the generator
TOPO_KEYS = ("mol_mtype", "mol_natom", "mol_atoms", "atom_mol", "atom_slot",
             "atom_type", "charge", "hydronium_mol")
GENERATOR_KEY = "torch_generator_state"
GENERATOR_DEVICE_KEY = "torch_generator_device"


def _noise_seed(seed):
    """The NVT noise generator's seed for the deck's `seed`: a stream of
    its own (the initial velocities take `seed` itself)."""
    return int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])


class Simulation:
    """Owns the host loop around md_scan."""

    def __init__(self, gro_file, ff_file, top_file, sim_file, traj_file,
                 log_file, hop_file, a_file, device,
                 checkpoint_file=CHECKPOINT_FILE):
        self.device = torch.device(device)
        self.cfg = cfg = read_sim_params(sim_file)
        if cfg.ensemble not in integrators.ENSEMBLES:
            raise ValueError(f"ensemble {cfg.ensemble!r}: expected one of "
                             f"{', '.join(integrators.ENSEMBLES)}")
        self.files = dict(traj=traj_file, log=log_file, hop=hop_file,
                          a=a_file, chk=checkpoint_file)
        # per-atom force dump at every output step (print_forces,
        # general_routines.f90:950-991; --dump-forces on the CLI)
        self.dump_forces_path = None
        self.text_chk = (checkpoint_file[:-4]
                         if checkpoint_file.endswith(".npz")
                         else checkpoint_file + ".vel")
        self._log_lines = []            # written to the log when it opens
        self.log_f = None
        # hop events of the run: the chunks' hopped rows (one a hop line)
        self.hopped_rows = 0

        # restart auto-detect, the JAX driver's conditions and precedence
        self.restart = (os.path.exists(traj_file)
                        and os.path.exists(checkpoint_file))
        self.text_restart = (not self.restart
                             and os.path.exists(traj_file)
                             and os.path.exists(log_file)
                             and os.path.exists(self.text_chk)
                             and os.path.getsize(self.text_chk) > 0)
        if self.text_restart:
            frame = read_last_gro_frame(traj_file)
            step_traj = frame_step(frame)
            step_vel, v_text = read_velocity_checkpoint(self.text_chk)
            # the reference stops on a step mismatch (:85-93)
            if step_traj != step_vel or step_vel <= 0:
                raise ValueError(
                    f"error restarting trajectory: last step differs "
                    f"between trajectory ({step_traj}) and velocity "
                    f"checkpoint ({step_vel})")
            if v_text.shape[0] != frame.n_atoms:
                raise ValueError("velocity checkpoint atom count does not "
                                 "match the trajectory frame")
        else:
            frame = read_gro(gro_file)
        self.system, topo = build_system(frame, read_ffpmt(ff_file),
                                         read_top(top_file), cfg,
                                         device=self.device)
        f = float_dtype(cfg.precision)

        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=f,
                                   device=self.device)

        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(_noise_seed(cfg.seed))
        # the captured steps of the run (None on the CPU: eager steps);
        # eager: no graphs on the card either, for comparisons only
        self.step_graphs = (graphs.StepGraphs()
                            if self.device.type == "cuda" else None)
        self.eager = False
        comp = None
        if self.restart:
            chk = np.load(checkpoint_file)
            topo = Topology(**{k: torch.as_tensor(
                np.asarray(chk[k]), device=self.device,
                dtype=f if k == "charge" else torch.int64)
                for k in TOPO_KEYS})
            state = State(x=tensor(chk["x"]), v=tensor(chk["v"]),
                          box=tensor(chk["box"]), step=int(chk["step"]))
            if "comp_x" in chk.files and self.system.compensated_sum:
                comp = integrators.CompCarry(x=tensor(chk["comp_x"]),
                                             v=tensor(chk["comp_v"]))
            if GENERATOR_KEY in chk.files and \
                    str(chk[GENERATOR_DEVICE_KEY]) == self.device.type:
                self.gen.set_state(torch.from_numpy(
                    np.asarray(chk[GENERATOR_KEY])))
            else:
                self._log([f"restart from {checkpoint_file}: no noise "
                           f"generator state for a {self.device.type} run "
                           f"(a JAX-written checkpoint, or another device);"
                           f" reseeded from seed {cfg.seed}\n"])
        elif self.text_restart:
            state = State(x=tensor(frame.xyz), v=tensor(v_text),
                          box=tensor(frame.box), step=step_vel)
        else:
            if frame.velocities is not None:
                v = tensor(frame.velocities)
            else:
                gen = torch.Generator().manual_seed(cfg.seed)
                v = velocities.sample_velocities(
                    gen, self.system.mass, cfg.initial_temp,
                    velocities.freeze_mask(self.system, topo))
            state = State(x=tensor(frame.xyz), v=v, box=tensor(frame.box))
        self.start_step = state.step

        self.cbw = pme.cb_half(state.box, self.system.pme_grid,
                               self.system.spline_order,
                               self.system.alpha_sqrt, dtype=f)
        self.capacity = neighbors.suggest_capacity(
            self.system.n_atoms, float(pbc.box_volume(state.box)),
            self.system.verlet_cutoff)
        # verlet_allpairs forces the dense O(N^2) build (the reference's
        # all-pairs fallback, general_routines.f90:1356)
        self.cells = () if cfg.verlet_allpairs else neighbors.suggest_cells(
            self.system.n_atoms, state.box.cpu().numpy(),
            self.system.verlet_cutoff)
        self.react_cap = self.react_cells = None
        # the deck's box sized kernel A's grid; a restart's box may be
        # smaller
        self._log(self._fit_grids(state.box, state.step))
        self._init_state(state, topo, state.step, comp=comp)
        self.barostat = None
        if cfg.ensemble == "NPT":
            self.barostat = MCBarostat(cfg.pressure, cfg.temperature,
                                       cfg.baroscale, cfg.seed)

    def mutate_system(self, fn):
        """Apply fn(system) -> System before run(): the hook for
        parameter surgery the deck cannot express, such as a documented
        softening (run/presets.soften_for_hops) or a PB-NN coupling: the
        triple's cpl_func switched to 3 and its MLP attached in one
        dataclasses.replace of the EvbParams (nn/train.py makes the MLP,
        convert.mlp_from_numpy carries trained weights across).

        The System that results is checked (topology.check_nn_coupling)
        and is always a new object, so md_scan captures its step anew and
        no graph of the old surface is replayed (the old graphs are
        dropped).  The force state is evaluated again under the new
        parameters, capacities that do not hold regrown with a log line
        each, the Kahan carries kept."""
        system = fn(self.system)
        if system is self.system:
            system = system.replace()
        check_nn_coupling(system.evb)
        self.system = system
        if self.step_graphs is not None:
            self.step_graphs = graphs.StepGraphs()
        ms = self.ms
        self._init_state(ms.state, ms.topo, ms.state.step, comp=ms.comp)

    def _settle(self, state, topo, step, cbw=None, comp=None):
        """MDState at `state` (under `cbw`, default self.cbw) with the
        current capacities, regrown until they hold (integrators.settle;
        regrow lines name `step`).  An EVB state-cap overflow at the
        ceiling is left in the state: the next step reports it and ends
        the run, as the JAX driver's first chunk does."""
        ms, self.system, caps = integrators.settle(
            state, topo, self.system, self.cbw if cbw is None else cbw,
            self._caps(), self.cfg.evb_hard_max_states, step, comp=comp,
            log=self._log)
        self._set_caps(caps)
        return ms

    def _caps(self):
        return self.capacity, self.cells, self.react_cap, self.react_cells

    def _set_caps(self, caps):
        self.capacity, self.cells, self.react_cap, self.react_cells = caps

    def _init_state(self, state, topo, step=0, comp=None):
        """self.ms at `state`, every capacity held (_settle)."""
        self.ms = self._settle(state, topo, step, comp=comp)

    def _fit_grids(self, box, step):
        """Re-derive by the suggest_* rules every cell grid (kernel A's
        System.rs_cells, the neighbor cells, the react cells) whose cells
        are narrower than its cutoff at `box`, where pairs would be
        missed; one log line each.  The grids are fixed when the system
        is built, from the deck's box."""
        b = box.detach().cpu().numpy()
        spacing = 1.0 / np.linalg.norm(np.linalg.inv(b).T, axis=1)
        s, n = self.system, self.system.n_atoms
        lines = []

        def narrow(grid, cutoff):
            return bool(grid) and any(w / c < cutoff
                                      for w, c in zip(spacing, grid[:3]))

        def note(name, old, new, cutoff):
            lines.append(f"step {step}: {name} {old} has cells narrower "
                         f"than its cutoff {cutoff} at box "
                         f"{np.round(spacing, 4).tolist()}; re-derived as "
                         f"{tuple(new or ())}\n")

        if narrow(s.rs_cells, s.real_space_cutoff):
            new = suggest_rs_cells(n, b, s.real_space_cutoff)
            note("kernel A cell grid", s.rs_cells, new, s.real_space_cutoff)
            self.system = s.replace(rs_cells=new)
        if narrow(self.cells, s.verlet_cutoff):
            new = neighbors.suggest_cells(n, b, s.verlet_cutoff)
            note("neighbor cell grid", self.cells, new, s.verlet_cutoff)
            self.cells = new
        react_cutoff = (s.evb_reactive_pair_distance + s.verlet_cutoff
                        - s.real_space_cutoff)
        if narrow(self.react_cells, react_cutoff):
            new = neighbors.suggest_cells(n, b, react_cutoff, min_atoms=0)
            note("react cell grid", self.react_cells, new, react_cutoff)
            self.react_cells = new or None
        return lines

    def _grow(self, names, step, redo):
        """Grow the capacities of `names` by the JAX package's factors
        (integrators.grow_capacities) and log one line each for the state
        cap and the others, ending with `redo`."""
        self.system, caps, lines = integrators.grow_capacities(
            names, self.system, *self._caps(),
            self.cfg.evb_hard_max_states, step, redo)
        self._set_caps(caps)
        self._log(lines)

    def _log(self, lines):
        """Write `lines` to the log, or keep them until it opens."""
        if self.log_f is None:
            self._log_lines.extend(lines)
        else:
            self.log_f.writelines(lines)
            self.log_f.flush()

    def _next_chunk(self, step, end):
        """Steps to the next host boundary (output, checkpoint, barostat
        move, the run's end), at most integrators.MAX_CHUNK (the JAX
        driver's _next_chunk; a replayed graph costs no compilation per
        length, so there is no power-of-two quantization)."""
        cfg = self.cfg
        n = min(end - step, cfg.n_output - step % cfg.n_output,
                integrators.MAX_CHUNK)
        if cfg.checkpoint_velocity:
            n = min(n, cfg.checkpoint_velocity
                    - step % cfg.checkpoint_velocity)
        if self.barostat is not None:
            n = min(n, cfg.barofreq - step % cfg.barofreq)
        return max(int(n), 1)

    def _scan(self, n):
        cfg = self.cfg
        return integrators.md_scan(
            self.ms, self.system, self.cbw, cfg.delta_t, cfg.ensemble, n,
            cfg.friction_coeff, cfg.temperature, generator=self.gen,
            step_graphs=self.step_graphs, eager=self.eager)

    def _chunk(self, step, n):
        """n steps from self.ms at `step`: (diag, steps done, end of run).
        A capacity that did not hold is regrown and the chunk replayed
        (integrators.regrown_chunk).  An EVB state-cap overflow at
        evb_hard_max_states or a force above 1e4 kJ/mol/A ends the run at
        the first step that had it: the chunk is replayed up to that step
        and its "aborting" line logged."""
        cfg = self.cfg
        gen0 = self.gen.get_state()
        r = integrators.regrown_chunk(
            self.ms, self.system, self.cbw, self._caps(),
            cfg.evb_hard_max_states, cfg.delta_t, cfg.ensemble, n,
            cfg.friction_coeff, cfg.temperature, generator=self.gen,
            step_graphs=self.step_graphs, eager=self.eager, log=self._log,
            step=step)
        self.system, diag = r.system, r.diag
        self._set_caps(r.caps)
        if integrators.EVB_STATE_CAP in diag.capacities() and \
                self.system.evb_max_states >= cfg.evb_hard_max_states:
            k = diag.first((integrators.EVB_STATE_CAP,))
            line = (f"step {step + k + 1}: diabat enumeration exceeded "
                    f"evb_hard_max_states={cfg.evb_hard_max_states} -- "
                    f"aborting (reference behavior, "
                    f"ms_evb.f90:3107-3123)\n")
            return self._replay_to(r.start, gen0, k, line)
        if bool(diag.force_overflow.any()):
            k = int(torch.nonzero(diag.force_overflow)[0, 0])
            line = (f"step {step + k + 1}: force magnitude exceeded 1e4 "
                    f"kJ/mol/A -- aborting (reference behavior, "
                    f"md_integration.f90:523-526)\n")
            return self._replay_to(r.start, gen0, k, line)
        self.ms = r.ms
        return diag, n, False

    def _replay_to(self, ms0, gen0, k, line):
        """The chunk from (ms0, gen0) replayed through its step k, where
        the run ends with `line`."""
        self.ms = ms0
        self.gen.set_state(gen0)
        self.ms, diag = self._scan(k + 1)
        self._log([line])
        return diag, k + 1, True

    def _barostat_move(self, step):
        """One MC volume move after step `step`.  The trial is settled
        (regrown) with the cell grids fitted to its box; a rejected trial
        leaves the grids as they were, an accepted one logs each grid it
        re-derived.  The System is replaced only when kernel A's grid
        changed: a new System object is a new graph key (md_scan), and
        so a capture."""
        grids = (self.system.rs_cells, self.cells, self.react_cells)
        notes = []

        def settle(state, ms, system, cbw):
            notes.extend(self._fit_grids(state.box, step))
            return self._settle(state, ms.topo, step, cbw=cbw)

        self.ms, self.cbw = self.barostat.attempt(self.ms, self.system,
                                                  self.cbw, settle)
        if self.barostat.history[-1][1]:
            self._log(notes)
        else:
            rs, self.cells, self.react_cells = grids
            if self.system.rs_cells != rs:
                self.system = self.system.replace(rs_cells=rs)

    def _blocks(self):
        """(molecule names, atoms per molecule, atom names, atom order)
        of the current topology in molecule-slot order, the order of the
        trajectory and the text checkpoint."""
        topo = self.ms.topo
        names = [self.system.mt.mtype_names[t]
                 for t in topo.mol_mtype.tolist()]
        ma = topo.mol_atoms.cpu().numpy().ravel()
        order = ma[ma >= 0]
        anames = np.asarray(self.system.ff.atype_names)[
            topo.atom_type.cpu().numpy()[order]].tolist()
        return names, topo.mol_natom.cpu().numpy(), anames, order

    def _write_frame(self, step):
        names, natom, anames, order = self._blocks()
        self.traj_f.write(format_gro_frame(
            f"step {step}", names, natom, anames,
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
        if self.cfg.ensemble == "NPT":
            vol = abs(float(np.linalg.det(ms.state.box.cpu().numpy())))
            dens = float(self.system.mass.sum()) / vol / 6.022e23 * 1e24
            line += f" volume(A^3) {vol:14.4f} density(g/cm3) {dens:10.6f}\n"
        if self.system.ms_evb and self.cfg.print_ms_evb_data:
            c2 = float((ms.eigenvector ** 2).max())
            line += (f" diabats {int(ms.n_states)} max_ci2 {c2:8.5f} "
                     f"hydronium_mol {int(ms.topo.hydronium_mol) + 1}\n")
            line += analysis.format_diabat_report(step, analysis.diabat_report(
                ms.hydronium_of, ms.n_hops_of, ms.eigenvector, ms.n_states))
        if self.system.ms_evb and self.cfg.debug >= 2:
            n_acc, n_don = analysis.hbond_network(
                ms.state.x, ms.state.box, ms.topo, self.system)
            self.hop_f.write(f"step {step} number of acceptors {n_acc} "
                             f"number of donors {n_don}\n")
            self.hop_f.flush()
            self._write_a_file(step)
        self.log_f.write(line)
        self.log_f.flush()

    def _write_a_file(self, step):
        """The debug >= 2 A-file block of every non-principle diabat:
        Zundel geometry and geometric factor A (write_geometry,
        ms_evb.f90:3828-3848, called at :1079-1081).  The diabat set is
        enumerated again at the output step, outside the MD step."""
        ms, nl = self.ms, self.ms.nlist
        ridx = next(t for t in (nl.react_tab, nl.react_idx, nl.full_idx)
                    if t is not None)
        x, box = ms.state.x, ms.state.box
        dset = enumerate_diabats(x, box, ms.topo, self.system, ridx)
        batch = build_diabat_topologies(ms.topo, dset, self.system)
        hop_log = dset.hop_log.cpu().numpy()
        n_hops = dset.n_hops.cpu().numpy()
        self.a_f.write(f"step {step}\n")
        for s in range(1, int(dset.n_states)):
            hop = hop_log[s, max(int(n_hops[s]) - 1, 0)]
            self.a_f.write(analysis.format_zundel_geometry(
                *analysis.zundel_diagnostics(
                    x, box, state_topology(batch.topo, s), self.system,
                    hop[0], hop[3], hop[1], d_heavy=hop[2],
                    a_heavy=hop[4])))
        self.a_f.flush()

    def dump_forces(self, path, step):
        """Append the per-atom forces, global atom order (print_forces,
        general_routines.f90:950-991)."""
        f = self.ms.force.cpu().numpy()
        names = [self.system.ff.atype_names[t]
                 for t in self.ms.topo.atom_type.tolist()]
        with open(path, "a") as fh:
            fh.write(f"step {step}\n")
            fh.writelines(f"{i + 1:6d} {nm:<5s} {f[i, 0]:14.6f} "
                          f"{f[i, 1]:14.6f} {f[i, 2]:14.6f}\n"
                          for i, nm in enumerate(names))

    def _checkpoint(self, step):
        """Append the text block (print_velocities_checkpoint) and
        rewrite the .npz."""
        ms, topo = self.ms, self.ms.topo
        names, natom, anames, order = self._blocks()
        with open(self.text_chk, "a") as fh:
            fh.write(format_velocity_checkpoint(
                step, names, natom, anames, ms.state.v.cpu().numpy()[order]))
        extra = {}
        if ms.comp is not None:
            extra = dict(comp_x=ms.comp.x.cpu().numpy(),
                         comp_v=ms.comp.v.cpu().numpy())
        np.savez(self.files["chk"], x=ms.state.x.cpu().numpy(),
                 v=ms.state.v.cpu().numpy(), box=ms.state.box.cpu().numpy(),
                 step=step, **extra,
                 **{k: getattr(topo, k).cpu().numpy() for k in TOPO_KEYS},
                 **{GENERATOR_KEY: self.gen.get_state().numpy(),
                    GENERATOR_DEVICE_KEY: self.device.type})

    def run(self, n_steps=None):
        """Run n_steps steps from the start step; returns the wall seconds
        of the loop."""
        cfg = self.cfg
        n_steps = cfg.n_step if n_steps is None else n_steps
        restarting = self.restart or self.text_restart
        mode = "a" if restarting else "w"
        if not restarting and cfg.checkpoint_velocity \
                and os.path.exists(self.text_chk):
            open(self.text_chk, "w").close()    # a fresh run: no stale blocks
        start = self.start_step
        with open(self.files["traj"], mode) as self.traj_f, \
                open(self.files["log"], mode) as self.log_f, \
                open(self.files["hop"], mode) as self.hop_f, \
                open(self.files["a"], mode) as self.a_f:
            if not restarting:
                self._log_header()
            self.log_f.writelines(self._log_lines)
            self._log_lines = []
            if not restarting:
                self._log_step(start)
                self._write_frame(start)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            step, end = start, start + n_steps
            while step < end:
                if self.barostat is not None and step % cfg.barofreq == 0 \
                        and step > start:
                    self._barostat_move(step)
                prev_h = int(self.ms.topo.hydronium_mol) \
                    if self.system.ms_evb else -1
                diag, done, last = self._chunk(
                    step, self._next_chunk(step, end))
                # the rows are on the host already: no read of the card
                self.hopped_rows += int(diag.hopped.sum())
                if self.system.ms_evb and bool(diag.hopped.any()):
                    hyds = diag.hydronium.tolist()
                    for k in torch.nonzero(diag.hopped)[:, 0].tolist():
                        old = prev_h if k == 0 else hyds[k - 1]
                        self.hop_f.write(f"step  {step + k + 1}\n proton hop "
                                         f"from {old + 1} to "
                                         f"{hyds[k] + 1}\n")
                    self.hop_f.flush()
                step += done
                if step % cfg.n_output == 0:
                    self._log_step(step)
                    self._write_frame(step)
                    if self.dump_forces_path:
                        self.dump_forces(self.dump_forces_path, step)
                if cfg.checkpoint_velocity and \
                        step % cfg.checkpoint_velocity == 0:
                    self._checkpoint(step)
                if last:
                    break
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            elapsed = time.perf_counter() - t0
            done = step - start
            self.log_f.write(f"completed {done} steps in {elapsed:.2f} s "
                             f"({done / max(elapsed, 1e-9):.2f} steps/s)\n")
        self.log_f = None
        return elapsed
