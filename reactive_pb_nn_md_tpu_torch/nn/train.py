"""PB-NN training: fit the neural diabatic coupling (function type 3)
(counterpart of reactive_pb_nn_md_tpu/nn/train.py, optax replaced by
torch.optim).

  stage 1  pretrain_geometric : regress the MLP on labelled geometric
           factors A(q^2, R_OO) of the analytic surface over the
           physical (q^2, R_OO) range (Adam under the JAX package's
           cosine-decayed rate, Vconst frozen);
  stage 2  finetune_adiabatic : descend on whole-frame adiabatic
           ground-state energies (and, with f_ref, forces) through the
           full engine: enumeration -> per-diabat energies -> coupling ->
           ground state.

The frame energy is c^T H c at the full state cap, c from the detached H
and held fixed, so dE/d(params) is the Hellmann-Feynman c^T dH c.  The
force is -dE/dx with the graph kept (create_graph), and force matching
differentiates it once more with respect to the MLP.  The kernels'
autograd Functions (kernel A's pair sweep, the PME spread B1/B2, the
per-state reciprocal C1/C2) return saved analytic gradients, so under
create_graph their force terms are constants.  That is right for this
loss only because those terms are the Hamiltonian's diagonal: it does not
depend on the MLP, and c is fixed, so d(diagonal force)/d(params) is 0.
The coupling elements, the only place the MLP enters, are plain torch
and differentiate twice.  A loss in which the diagonal's parameters
train would need second derivatives the kernels do not give.

Frames are looped (each has its own diabat set); the frame arguments are
stacked tensors or lists, one entry a frame.  Entry points draw and
compute on the card unless the caller asks for the CPU.
"""

import dataclasses
import math

import numpy as np
import torch

from ..evb import hamiltonian as ham
from ..evb.enumerate import enumerate_diabats, molecule_com
from ..evb.topology_ops import build_diabat_topologies
from ..models.coupling import geometric_factor
from ..ops.ground_state import ground_state
from .coupling_mlp import apply_mlp, copy_mlp, init_mlp, mlp_tensors

ADAM = dict(betas=(0.9, 0.999), eps=1e-8)       # optax.adam's defaults


def analytic_geometric_surface(cpl_params_row, q2, roo, cpl_func=1):
    """Labels: the analytic A factor of a coupling row (>= 10 values, the
    triple's evb.cpl_params row) at (q2, roo) (B,); cpl_func: the row's
    own function type (1 MS-EVB3, 2 product of Gaussians)."""
    p = _tensor(cpl_params_row).to(dtype=q2.dtype, device=q2.device)
    z = torch.zeros_like(q2)
    qv = torch.stack([torch.sqrt(torch.clamp(q2, min=0.0)), z, z], dim=-1)
    rv = torch.stack([roo, z, z], dim=-1)
    func = torch.full(q2.shape, int(cpl_func), device=q2.device)
    return geometric_factor(func, p.expand(q2.shape[0], -1), qv, rv)


def _tensor(v):
    """A tensor of v (a tensor as it is; else a copy of np.asarray(v))."""
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v))


def sample_geometries(generator, n, q2_range=(0.0, 0.6), roo_range=(2.2, 3.2),
                      dtype=torch.float64, device="cuda"):
    """Uniform (q2, roo) samples (n,) over the Zundel geometries the
    candidate cutoffs admit (R_OO ~ 2.2-3.2 A, |q| <= ~0.8 A), drawn from
    `generator` on its device."""
    from ..convert import resolve_device
    device = resolve_device(device)

    def uniform(lo, hi):
        u = torch.rand(n, generator=generator, dtype=dtype,
                       device=generator.device)
        return (lo + (hi - lo) * u).to(device)

    return uniform(*q2_range), uniform(*roo_range)


def pretrain_geometric(cpl_params_row, generator=None, hidden=(16, 16),
                       n_samples=2048, steps=2000, lr=1e-2,
                       dtype=torch.float64, cpl_func=1, n_env=0,
                       device="cuda", samples=None, init=None):
    """Stage 1: fit the MLP to the analytic A(q2, roo) of the row.

    Returns (MLP, rmse of the last step's loss).  The samples are drawn
    first, then the initial MLP, from `generator` (a CPU generator seeded
    0 when None); `samples` (q2, roo) and `init` (an MLP) replace them.
    Vconst is the row's (degenerate with the output scale here) and is not
    trained.  Adam under optax.cosine_decay_schedule(lr, steps): update t
    = 0 .. steps - 1 at lr (1 + cos(pi t / steps)) / 2.  Environment
    inputs (n_env) are zero here: the surface fit is unchanged and the
    environment is learned from real frames in stage 2."""
    from ..convert import resolve_device
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if samples is None:
        q2, roo = sample_geometries(generator, n_samples, dtype=dtype,
                                    device=device)
    else:
        q2, roo = (_tensor(s).to(dtype=dtype, device=device)
                   for s in samples)
    labels = analytic_geometric_surface(cpl_params_row, q2, roo,
                                        cpl_func=cpl_func)
    if init is None:
        init = init_mlp(generator, hidden=hidden,
                        vconst=float(cpl_params_row[0]), dtype=dtype,
                        device=device, n_env=n_env)
    nn = copy_mlp(init, True)
    nn["vconst"].requires_grad_(False)
    opt = torch.optim.Adam(nn["w"] + nn["b"], lr=lr, **ADAM)
    for t in range(steps):
        opt.param_groups[0]["lr"] = lr * 0.5 * (1.0 + math.cos(
            math.pi * t / steps))
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((apply_mlp(nn, q2, roo) - labels) ** 2)
        loss.backward()
        opt.step()
    rmse = math.sqrt(float(loss.detach())) if steps else float("nan")
    return copy_mlp(nn), rmse


def with_mlp(system, nn_params):
    """`system` with its EVB tables' MLP replaced by nn_params (checked:
    topology.check_nn_coupling)."""
    return system.replace(evb=dataclasses.replace(system.evb,
                                                  nn_params=nn_params))


def adiabatic_energy(x, box, topo, system, pairs, cbw, full_idx):
    """The adiabatic ground-state energy c^T H c at the full cap (no small
    tier), c from the detached H and held fixed: the training objective,
    without the position forces of hamiltonian.adiabatic_energy_force."""
    xd = x.detach()
    com = molecule_com(xd, topo.mol_atoms, system.mass, box)
    dset = enumerate_diabats(xd, box, topo, system, full_idx, com)
    batch = build_diabat_topologies(topo, dset, system)
    H, _, _, _ = ham.assemble_hamiltonian(x, box, batch, system, pairs, cbw,
                                          topo.charge, topo, full_idx, com)
    _, c, _ = ground_state(H.detach())
    return c @ H @ c


def _frames(xs, full_idxs, pair_j, pair_mask):
    for x, fi, j, m in zip(xs, full_idxs, pair_j, pair_mask):
        i = torch.arange(x.shape[0], device=x.device)[:, None]
        yield x, fi, (i, j, m)


def make_frame_energy_fn(system, topo, box, cbw):
    """energies(nn_params, xs, full_idxs, pair_j, pair_mask) -> (F,): the
    adiabatic energy of each frame (xs (F, N, 3), each frame's full
    adjacency and pair list at one capacity) with the MLP nn_params
    (None: the system's analytic couplings)."""

    def energies(nn_params, xs, full_idxs, pair_j, pair_mask):
        sys_nn = with_mlp(system, nn_params)
        return torch.stack([
            adiabatic_energy(x, box, topo, sys_nn, pairs, cbw, fi)
            for x, fi, pairs in _frames(xs, full_idxs, pair_j, pair_mask)])

    return energies


def make_frame_energy_force_fn(system, topo, box, cbw):
    """energies_forces(nn_params, xs, full_idxs, pair_j, pair_mask) ->
    ((F,), (F, N, 3)): the force is -dE/dx, its graph kept when an MLP
    tensor requires grad, so that a force-matching loss differentiates
    it with respect to the MLP (see the module docstring)."""

    def energies_forces(nn_params, xs, full_idxs, pair_j, pair_mask):
        sys_nn = with_mlp(system, nn_params)
        keep = nn_params is not None and any(
            t.requires_grad for t in mlp_tensors(nn_params))
        es, fs = [], []
        for x, fi, pairs in _frames(xs, full_idxs, pair_j, pair_mask):
            xg = x.detach().requires_grad_(True)
            with torch.enable_grad():
                e = adiabatic_energy(xg, box, topo, sys_nn, pairs, cbw, fi)
                g, = torch.autograd.grad(e, xg, create_graph=keep)
            es.append(e if keep else e.detach())
            fs.append(-g)
        return torch.stack(es), torch.stack(fs)

    return energies_forces


def finetune_adiabatic(nn, system, topo, box, cbw, xs, full_idxs,
                       pair_j, pair_mask, e_ref, steps=60, lr=1e-3,
                       f_ref=None, force_weight=0.1):
    """Stage 2: Adam on the whole-frame objective through the full engine,
    every MLP tensor (Vconst too) trained.  Energy only by default; with
    f_ref (F, N, 3) force matching is added,

        L = mean (E - e_ref)^2 + w * 3N * mean_frames,atoms |F - f_ref|^2

    (w in (kJ/mol)^2 per (kJ/mol/A)^2).  Returns (MLP, energy rmse before,
    after), with f_ref also the force rmse before and after: (MLP, e0,
    e1, f0, f1).  `nn` is not changed."""
    energies = make_frame_energy_fn(system, topo, box, cbw)
    ef = make_frame_energy_force_fn(system, topo, box, cbw)
    dev, dt = xs[0].device, xs[0].dtype
    e_ref = _tensor(e_ref).to(dtype=dt, device=dev)
    if f_ref is not None:
        f_ref = _tensor(f_ref).to(dtype=dt, device=dev)
    frames = (xs, full_idxs, pair_j, pair_mask)
    params = copy_mlp(nn, True)
    opt = torch.optim.Adam(mlp_tensors(params), lr=lr, **ADAM)

    def f_mse(e_f):
        return torch.mean(torch.sum((e_f[1] - f_ref) ** 2, dim=-1))

    def loss_fn(p):
        if f_ref is None:
            return torch.mean((energies(p, *frames) - e_ref) ** 2)
        e_f = ef(p, *frames)
        n3 = 3.0 * xs[0].shape[0]
        return (torch.mean((e_f[0] - e_ref) ** 2)
                + force_weight * n3 * f_mse(e_f))

    def rmses(p):
        p = copy_mlp(p)
        with torch.no_grad():
            e = math.sqrt(float(torch.mean((energies(p, *frames) - e_ref)
                                           ** 2)))
        f = (None if f_ref is None
             else math.sqrt(float(f_mse(ef(p, *frames))) / 3.0))
        return e, f

    e0, f0 = rmses(params)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss_fn(params).backward()
        opt.step()
    e1, f1 = rmses(params)
    out = copy_mlp(params)
    if f_ref is None:
        return out, e0, e1
    return out, e0, e1, f0, f1


def finetune_heldout(nn, system, topo, box, cbw, xs, full_idxs, pair_j,
                     pair_mask, e_ref, split=0.75, steps=60, lr=1e-3):
    """Stage 2 with a held-out set: the first `split` of the frames train
    (finetune_adiabatic), the rest are never seen by the optimizer.
    Returns (MLP, report) with report = {train_rmse_before/after,
    test_rmse_before/after, n_train, n_test} in kJ/mol."""
    F = len(xs)
    n_tr = max(1, min(F - 1, int(round(F * split))))
    tr, te = slice(0, n_tr), slice(n_tr, F)
    energies = make_frame_energy_fn(system, topo, box, cbw)
    e_ref = _tensor(e_ref).to(dtype=xs[0].dtype, device=xs[0].device)

    def rmse(params, sl):
        with torch.no_grad():
            e = energies(copy_mlp(params), xs[sl], full_idxs[sl],
                         pair_j[sl], pair_mask[sl])
            return math.sqrt(float(torch.mean((e - e_ref[sl]) ** 2)))

    test0 = rmse(nn, te)
    nn, tr0, tr1 = finetune_adiabatic(
        nn, system, topo, box, cbw, xs[tr], full_idxs[tr], pair_j[tr],
        pair_mask[tr], e_ref[tr], steps=steps, lr=lr)
    report = {"train_rmse_before": tr0, "train_rmse_after": tr1,
              "test_rmse_before": test0, "test_rmse_after": rmse(nn, te),
              "n_train": n_tr, "n_test": F - n_tr}
    return nn, report
