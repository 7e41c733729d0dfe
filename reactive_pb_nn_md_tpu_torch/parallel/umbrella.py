"""Umbrella-sampling window ladders (counterpart of
reactive_pb_nn_md_tpu/parallel/umbrella.py).

A ladder is W harmonically restrained replicas of one box (md/bias.py),
run as a replica batch on one card (parallel/ensemble.py: the windows
stacked through one step vmapped over them, each chunk the replays of
that step captured once, the stacked restraint copied in at the chunk's
start), and estimated with WHAM
(analysis/wham.py).  The workflow (run/umbrella_pmf.py drives it):

    atoms  = transfer_triple(ms, system)           # donor O, acceptor O, H
    ladder = make_ladder(atoms, centers, k, ...)   # (W,)-batched restraint
    scan   = make_ladder_scan(system, cbw, dt, "NVT", chunk, ...)
    batch  = seeded_window_states(ms, scan.system, cbw, atoms, centers,
                                  ladder=ladder)
    batch, cv, info = sample_ladder(scan, batch, ladder, ...)   # (W, T)
    pmf    = wham.wham(cv, centers, k, T)

Two departures from the JAX package, which is silent in both cases:
transfer_triple and seeded_window_states raise on a box with off-diagonal
terms (the JAX functions take np.diag(box) as the box lengths), and
run/umbrella_pmf.run_pmf raises before WHAM when the keeper restraint is
not the same in every window (WHAM is given the window restraint only).
"""

import numpy as np
import torch

from ..convert import resolve_device
from ..md import bias as bias_mod
from ..md import integrators, velocities
from ..topology import State
from . import ensemble


def _box_lengths(box):
    """The edge lengths of an orthorhombic `box` (a tensor); raises on
    off-diagonal terms."""
    b = box.detach().cpu().numpy().astype(np.float64)
    if np.any(b - np.diag(np.diag(b))):
        raise ValueError("the umbrella ladder needs an orthorhombic box: "
                         "this one has off-diagonal terms")
    return np.diag(b)


def transfer_triple(ms, system, acceptor_rank=0):
    """The proton-transfer triple of the current state, on the host: donor
    heavy = the hydronium's heaviest atom, acceptor heavy = the
    `acceptor_rank`-th nearest heavy atom of another molecule, H = the
    donor proton most aligned with the donor -> acceptor axis.  (3,)
    int64 [O_donor, O_acceptor, H], global atom indices."""
    x = ms.state.x.detach().cpu().numpy().astype(np.float64)
    L = _box_lengths(ms.state.box)
    topo = ms.topo
    mass = system.mass.cpu().numpy().astype(np.float64)
    hyd = int(topo.hydronium_mol)
    mol_of = topo.atom_mol.cpu().numpy()
    atoms_h = topo.mol_atoms[hyd].cpu().numpy()
    atoms_h = atoms_h[atoms_h >= 0]
    O_d = int(atoms_h[np.argmax(mass[atoms_h])])
    cand = np.where((mass > 10.0) & (mol_of != hyd))[0]
    dr = x[cand] - x[O_d]
    dr -= np.round(dr / L) * L
    dist = np.linalg.norm(dr, axis=1)
    k = int(np.argsort(dist)[acceptor_rank])
    u = dr[k] / dist[k]
    O_a = int(cand[k])
    hs = atoms_h[mass[atoms_h] < 2.0]
    dh = x[hs] - x[O_d]
    dh -= np.round(dh / L) * L
    H = int(hs[np.argmax(dh @ u)])
    return np.array([O_d, O_a, H], np.int64)


def velocity_seed(seed, w):
    """The seed of window w's initial velocities (a CPU generator)."""
    return int(np.random.SeedSequence([seed, 3, w]).generate_state(1)[0])


def seeded_window_states(ms, system, cbw, atoms, centers, r_oo=2.5,
                         temperature=300.0, seed=17, ladder=None,
                         velocities_w=None):
    """Window initial states with the transfer geometry built at each
    window's center, as the JAX package builds it: the acceptor molecule
    shifted rigidly to R_OO = r_oo and the proton put on the O-O axis at
    delta r_OH = center (r_dH = (r_oo + center) / 2).  Velocities:
    velocities_w[w] when given, else Maxwell-Boltzmann at `temperature`
    from a CPU generator seeded with velocity_seed(seed, w); the noise
    generator of window w is seeded with ensemble.replica_seed(seed, w).
    Each window is set up with initial_md_state at `ms`'s capacities under
    its restraint of `ladder` (its initial force includes the bias).
    Returns an ensemble.ReplicaBatch."""
    x0 = ms.state.x.detach().cpu().numpy().astype(np.float64)
    L = _box_lengths(ms.state.box)
    mol_of = ms.topo.atom_mol.cpu().numpy()
    O_d, O_a, H = int(atoms[0]), int(atoms[1]), int(atoms[2])
    acc_atoms = np.where(mol_of == mol_of[O_a])[0]
    mobile = velocities.freeze_mask(system, ms.topo)
    fdt, dev = ms.state.x.dtype, ms.state.x.device
    nl = ms.nlist
    states, gens = [], []
    for w, c in enumerate(np.asarray(centers, np.float64)):
        x = x0.copy()
        dr = x[O_a] - x[O_d]
        dr -= np.round(dr / L) * L
        d = np.linalg.norm(dr)
        u = dr / d
        x[acc_atoms] += (r_oo - d) * u
        x[H] = x[O_d] + 0.5 * (r_oo + c) * u
        if velocities_w is None:
            v = velocities.sample_velocities(
                torch.Generator().manual_seed(velocity_seed(seed, w)),
                system.mass, temperature, mobile)
        else:
            v = torch.as_tensor(np.array(velocities_w[w]), dtype=fdt,
                                device=dev)
        st = State(x=torch.as_tensor(x, dtype=fdt, device=dev), v=v,
                   box=ms.state.box, step=ms.state.step)
        states.append(integrators.initial_md_state(
            st, ms.topo, system, cbw, nl.capacity, cells=nl.cells or None,
            react_cap=nl.react_cap or None,
            react_cells=nl.react_cells or None,
            bias=ensemble.window_bias(ladder, w)))
        gens.append(ensemble.generator_state(
            dev, ensemble.replica_seed(seed, w)))
    return ensemble.ReplicaBatch(states, gens)


def make_ladder(atoms, centers, k_spring, cv_type=0, dtype=torch.float32,
                device="cuda"):
    """(W,)-batched HarmonicBias: one atom triple, a center a window,
    k_spring a scalar or (W,); on the card unless `device` says
    otherwise."""
    device = resolve_device(device)
    centers = torch.as_tensor(np.asarray(centers, np.float64), dtype=dtype,
                              device=device)
    W = centers.shape[0]
    k = torch.as_tensor(np.broadcast_to(np.asarray(k_spring, np.float64),
                                        (W,)).copy(), dtype=dtype,
                        device=device)
    at = torch.as_tensor(np.broadcast_to(np.asarray(atoms, np.int64),
                                         (W, 3)).copy(), device=device)
    return bias_mod.HarmonicBias(atoms=at, k=k, center=centers,
                                 cv_type=cv_type)


def make_ladder_scan(system, cbw, dt, ensemble_name, n_steps, friction=1.0,
                     temperature=300.0, hard_max_states=None):
    """The ladder's scan: scan(batch, ladder) advances every window
    n_steps steps under its restraint, all windows through one batched
    step (ensemble.BatchedReplicaScan, no small tier)."""
    return ensemble.BatchedReplicaScan(system, cbw, dt, ensemble_name,
                                       n_steps, friction, temperature,
                                       hard_max_states)


def sample_ladder(scan, batch, ladder, n_equil, n_sample, chunk,
                  on_chunk=None):
    """Drive a ladder scan whose chunk is `chunk` steps: chunks until
    n_equil steps are discarded, then chunks until n_sample steps are
    sampled.  Returns (batch, cv (W, >= n_sample) float64 numpy, info:
    hops, overflow (a chunk of this call was regrown and replayed),
    steps_sampled, steps_equil)."""
    if chunk != scan.n_steps:
        raise ValueError(f"chunk {chunk}: the scan runs {scan.n_steps} "
                         f"steps a call")
    regrows = scan.n_regrows
    cvs = []
    hops = 0
    n_eq_done = 0
    while n_eq_done < n_equil:
        batch, diag = scan(batch, ladder)
        n_eq_done += chunk
        hops += int(diag.hopped.sum())
    done = 0
    while done < n_sample:
        batch, diag = scan(batch, ladder)
        done += chunk
        cvs.append(diag.cv.numpy().astype(np.float64))   # (W, chunk)
        hops += int(diag.hopped.sum())
        if on_chunk is not None:
            on_chunk(batch, diag)
    cv = np.concatenate(cvs, axis=1)
    return batch, cv, {"hops": hops,
                       "overflow": scan.n_regrows > regrows,
                       "steps_sampled": done, "steps_equil": n_eq_done}
