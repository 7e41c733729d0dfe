"""EVB Hamiltonian assembly, ground state and Hellmann-Feynman forces
(counterpart of reactive_pb_nn_md_tpu/evb/hamiltonian.py;
construct_evb_hamiltonian / diagonalize_evb_hamiltonian, ms_evb.f90:181-490).

  * diagonals by field decomposition: the principle topology's full energy
    plus per-state deltas that involve only the changed-molecule superset
    U; reciprocal space as one base grid (kernel B) + one FFT + the
    per-state spectrum contraction (kernel C), no per-diabat FFT;
  * couplings of every state with its parent;
  * ground state of the padded H (inactive states parked above the
    spectrum): kernel E on the card, eigh on the CPU (ops/ground_state.py);
  * forces F = -d/dx [c^T H(x) c] with c held fixed (Hellmann-Feynman).

With `shard` (parallel/shard.py) one evaluation is shared over ranks: the
bulk energy_no_recip and the base charge spread are split, everything
else (enumeration, U, the deltas, the couplings, the ground state) is
computed alike on every rank from x read through shard.shared, and the
forces are summed over the ranks.

Every per-state quantity carries a leading state axis; the padded state
cap is static.  The two-tier switch is chosen by the caller (`tier`):
the small tier's overflow is a device flag, on which md_scan replays its
chunk at the full cap; no host synchronization.
"""

from dataclasses import dataclass, replace

import torch

from ..utils.constants import CONV_E2A_KJMOL, SQRT_PI
from ..models import total as total_mod
from ..models import bonded, coupling, nonbonded, pme, repulsion
from ..md.graphs import leaves, with_leaves
from ..ops.ground_state import ground_state
from ..ops.kernels.segment_sum import take_rows
from ..ops.neighbors import CellTable, rows_on_demand
from ..topology import Topology
from ..utils import pbc
from .enumerate import DiabatSet, enumerate_diabats, molecule_com
from .topology_ops import (DiabatBatch, build_diabat_topologies,
                           state_topology)

# span of the inactive-state park above the principle diagonal (relative,
# so it does not inflate ||H|| past what fp32 couplings survive)
INACTIVE_DIAG = 1.0e5


def _dedup_mols(hop_log):
    """(mols (S, 2C), mvalid): every chain's donor/acceptor molecules, each
    molecule valid once."""
    mols = torch.cat([hop_log[:, :, 0], hop_log[:, :, 3]], dim=1)
    n = mols.shape[1]
    lower = torch.ones((n, n), dtype=torch.bool,
                       device=mols.device).tril(-1)
    mvalid = mols >= 0
    seen = ((mols[:, :, None] == mols[:, None, :]) & lower
            & mvalid[:, None, :]).any(2)
    return mols, mvalid & ~seen


def _rows_of(t, idx):
    """t[s, idx[s, ...]] for a batched (S, n, ...) tensor."""
    s = torch.arange(t.shape[0], device=t.device).reshape(
        (-1,) + (1,) * (idx.ndim - 1))
    return t[s, idx]


def _chain_mol_deltas(x, box, batch: DiabatBatch, system, base_charge,
                      topo0, order_m, umol_ok, skip_repulsion=False):
    """Per-state deltas of the molecule-local terms (intra nonbonded,
    bonded, Ewald self) over the hop-chain molecules, and each state's
    EVB reference energy plus, unless skip_repulsion (the candidate-row
    sweep takes it), the dense EVB repulsion.  The principle side is
    evaluated once per superset molecule."""
    tb = batch.topo
    xa0 = total_mod.mol_sites_packed(x, base_charge, topo0.mol_atoms[order_m])
    mt0 = topo0.mol_mtype[order_m]
    ie0, iv0 = total_mod.intra_terms(xa0, mt0, box, system, umol_ok)
    b0 = bonded.bonded_energies(xa0[..., 0:3], mt0, box, system, umol_ok)
    e0_mol = ie0 + iv0 + b0[0] + b0[1] + b0[2]                   # (UM,)

    mols, mvalid = _dedup_mols(batch.dset.hop_log)
    msafe = mols.clamp(min=0)
    mol_atoms_d = _rows_of(tb.mol_atoms, msafe)                 # (S, 2C, A)
    mtype_d = _rows_of(tb.mol_mtype, msafe)
    xa_d = total_mod.mol_sites_packed(x, tb.charge, mol_atoms_d)
    ie_d, iv_d = total_mod.intra_terms(xa_d, mtype_d, box, system, mvalid)
    b_d = bonded.bonded_energies(xa_d[..., 0:3], mtype_d, box, system,
                                 mvalid)
    e_d = (ie_d + iv_d + b_d[0] + b_d[1] + b_d[2]).sum(1)
    memb = ((mols[:, :, None] == order_m[None, None, :])
            & mvalid[:, :, None] & umol_ok[None, None, :])
    e_0 = torch.where(memb, e0_mol[None, None, :],
                      torch.zeros_like(e0_mol)[None, None, :]).sum((1, 2))
    csafe = batch.changed_atoms.clamp(min=0)
    q_d = torch.gather(tb.charge, 1, csafe)
    q_0 = base_charge[csafe]
    dself = -system.alpha_sqrt / SQRT_PI * CONV_E2A_KJMOL * torch.where(
        batch.changed_mask, q_d * q_d - q_0 * q_0,
        torch.zeros_like(q_d)).sum(1)
    e_ref = repulsion.reference_energy(tb, system)
    if not skip_repulsion:
        e_ref = e_ref + repulsion.ms_evb_repulsion(x, box, tb, system)
    return e_d - e_0 + dself, e_ref


def _vdw(system, ta, tb, r, r2):
    """vdW pair energy of types (ta, tb) at distance r (no 1-4 pairs)."""
    vt = system.ff.vdw_type[ta, tb]
    vp = system.ff.vdw_params[ta, tb].to(r.dtype)
    no14 = torch.zeros_like(vt, dtype=torch.bool)
    return nonbonded.vdw_pair_energy(vt, vp, vp, no14, r, r2,
                                     has_sapt=system.has_sapt)


def diabat_diagonal_energies(x, box, batch: DiabatBatch, system, pairs, cbw,
                             base_charge, topo0, full_idx, xa_pc0=None,
                             shard=None):
    """Field decomposition of the diagonals.

    A pair (u in U, j outside U) keeps j's charge, type and molecule in
    every state and stays inter-molecular, so the real-space delta of
    state s is sum_u (q_s[u] - q_0[u]) Phi_el[u] (+ the vdW analog over
    each atom's type options) with the potentials computed once; pairs
    inside U x U are summed per state.  full_idx is the (N, Kf) full
    adjacency or, on the on-demand cell path, a CellTable whose rows are
    extracted for U only.  Returns (diag (S,), principle breakdown with
    the base grid's slab overflow, e_recip (S,), row overflow ()).  With
    `shard` the bulk and the base grid are this rank's shares summed over
    the ranks, and the rest reads x through shard.shared (the module
    docstring)."""
    dset = batch.dset
    S = system.evb_max_states
    M, N = system.n_mole, system.n_atoms
    dev = x.device
    bd0 = total_mod.energy_no_recip(x, box, topo0, system, pairs,
                                    xa_pc=xa_pc0, shard=shard)
    x_split = x
    if shard is not None:
        x = shard.shared(x)

    # ---------------- changed-molecule superset U (constant in x)
    mols_all = torch.cat([dset.hop_log[:, :, 0], dset.hop_log[:, :, 3]],
                         dim=1).reshape(-1)
    # (out of place: a replica batch vmaps this function)
    in_U = torch.zeros(M, dtype=torch.int64, device=dev).scatter_reduce(
        0, mols_all.clamp(min=0), (mols_all >= 0).to(torch.int64),
        reduce="amax")
    h0 = topo0.hydronium_mol.reshape(1)
    in_U = in_U.scatter_reduce(0, h0.clamp(min=0),
                               (h0 >= 0).to(torch.int64), reduce="amax")
    UM = min(S, M)
    order_m = torch.argsort(-in_U, stable=True)[:UM]
    umol_ok = in_U[order_m] > 0
    ua_mat = topo0.mol_atoms[order_m]                           # (UM, A)
    ua_mask = (umol_ok[:, None] & (ua_mat >= 0)).reshape(-1)
    ua = ua_mat.clamp(min=0).reshape(-1)                        # (U,)
    U = ua.shape[0]
    pos_in_U = torch.full((N + 1,), -1, dtype=torch.int64,
                          device=dev).index_put(
        (torch.where(ua_mask, ua, torch.full_like(ua, N)),),
        torch.arange(U, device=dev))[:N]

    # ---------------- state-independent pair data over U's neighbor rows
    on_demand = isinstance(full_idx, CellTable)
    if on_demand:
        rows, over_r = rows_on_demand(full_idx, x, box, ua)      # (U, Kf)
        row_over = (over_r & ua_mask).any()
    else:
        rows = full_idx[ua]                                     # (U, Kf)
        row_over = torch.zeros((), dtype=torch.bool, device=dev)
    rmask = ua_mask[:, None] & (rows >= 0)
    j = rows.clamp(min=0)
    xu = x[ua]
    qj0, t0j = base_charge[j], topo0.atom_type[j]
    jU = pos_in_U[j]
    # the entries rmask leaves out (empty slots, the rows of U's padded
    # atoms) are padding to take_rows: no gradient reaches them
    dr = pbc.min_image(xu[:, None, :] - take_rows(x, torch.where(rmask, j,
                                                                -1)), box)
    r2 = (dr * dr).sum(-1)
    within = rmask & (r2 < system.real_space_cutoff ** 2)
    r2s = torch.where(within, r2, torch.ones_like(r2))
    r = torch.sqrt(r2s)
    zero = torch.zeros_like(r)
    out_p = within & (jU < 0)
    uu_p = within & (jU >= 0)
    inter0 = topo0.atom_mol[ua][:, None] != topo0.atom_mol[j]
    ke = nonbonded.ewald_real(torch.ones_like(r), r, system.alpha_sqrt)
    phi_el = torch.where(out_p & inter0, ke * qj0, zero).sum(1)  # (U,)

    opts = system.evb.type_options[topo0.atom_type[ua]]         # (U, O)
    O = opts.shape[1]
    phi_vdw = torch.stack(
        [torch.where(out_p & inter0 & (opts[:, o] >= 0)[:, None],
                     _vdw(system, opts[:, o].clamp(min=0)[:, None], t0j, r,
                          r2s), zero).sum(1)
         for o in range(O)], dim=1)                             # (U, O)

    jU_s = jU.clamp(min=0)
    optsJ = opts[jU_s]                                          # (U, Kf, O)
    e_uu = [[torch.where(uu_p, _vdw(system, opts[:, a].clamp(min=0)[:, None],
                                    optsJ[:, :, b].clamp(min=0), r, r2s),
                         zero)
             for b in range(O)] for a in range(O)]
    ke_uu = torch.where(uu_p, ke, zero)

    # ---------------- per-state values on U
    tb = batch.topo
    qU, tU, mU = tb.charge[:, ua], tb.atom_type[:, ua], tb.atom_mol[:, ua]
    q0U, m0U = base_charge[ua], topo0.atom_mol[ua]
    selU = torch.argmax((tU[..., None] == opts[None]).to(torch.int64), -1)
    # one_hot validates its classes on the host (a synchronization)
    oh_sel = (selU[..., None] == torch.arange(O, device=dev)).to(x.dtype)
    masked_q = torch.where(ua_mask[None], qU - q0U[None],
                           torch.zeros_like(qU))                # (S, U)
    d_el_out = masked_q @ phi_el
    d_vdw_out = torch.einsum("suo,uo->s", oh_sel, phi_vdw) - phi_vdw[:, 0].sum()

    qJ, mJ, sJ = qU[:, jU_s], mU[:, jU_s], selU[:, jU_s]        # (S, U, Kf)
    m0J, q0J = m0U[jU_s], q0U[jU_s]
    inter_d = mU[:, :, None] != mJ
    inter_0uu = m0U[:, None] != m0J
    e_el_uu_d = 0.5 * torch.einsum(
        "uk,suk->s", ke_uu,
        torch.where(inter_d, qU[:, :, None] * qJ, torch.zeros_like(qJ)))
    e_el_uu_0 = 0.5 * (ke_uu * torch.where(inter_0uu, q0U[:, None] * q0J,
                                           zero)).sum()
    e_vdw_uu_d = torch.zeros(S, dtype=x.dtype, device=dev)
    for a in range(O):
        for b in range(O):
            sel_ab = (selU[:, :, None] == a) & (sJ == b) & inter_d
            e_vdw_uu_d = e_vdw_uu_d + 0.5 * torch.einsum(
                "uk,suk->s", e_uu[a][b], sel_ab.to(x.dtype))
    e_vdw_uu_0 = 0.5 * (e_uu[0][0] * inter_0uu.to(x.dtype)).sum()
    deltas_rs = (d_el_out + d_vdw_out + (e_el_uu_d - e_el_uu_0)
                 + (e_vdw_uu_d - e_vdw_uu_0))

    # ---------------- molecule-local deltas + EVB repulsion / reference
    use_domain_rep = repulsion.domain_repulsion_active(system, on_demand)
    deltas_mol, extra = _chain_mol_deltas(x, box, batch, system, base_charge,
                                          topo0, order_m, umol_ok,
                                          skip_repulsion=use_domain_rep)
    if use_domain_rep:
        extra = extra + repulsion.ms_evb_repulsion_batched_domain(
            x, box, tb, system, xu, pos_in_U, j, rmask, topo0.atom_type)

    # ---------------- reciprocal space per state: one base grid + one FFT
    # + the per-state spectrum contraction
    K = system.pme_grid
    Q0, slab_over = pme.charge_grid(x_split, base_charge, box, K,
                                    system.spline_order,
                                    scap=system.pme_scap, shard=shard)
    F0 = torch.fft.rfftn(Q0)
    e0 = 0.5 * CONV_E2A_KJMOL * (cbw * (F0.real ** 2 + F0.imag ** 2)).sum()
    e_recip = e0 + pme.recip_delta_perstate(xu, ua_mask, masked_q, box, K,
                                            system.spline_order, cbw, F0)
    diag = bd0.total + deltas_rs + deltas_mol + extra + e_recip
    return diag, replace(bd0, slab_overflow=slab_over), e_recip, row_over


def _recip_batched(x, box, batch: DiabatBatch, system, cbw, base_charge):
    """(S,) per-diabat reciprocal energies by brute force: the base grid
    plus each state's grid of its changed atoms' charge deltas, one FFT a
    state.  The ground truth of recip_delta_perstate."""
    K, order = system.pme_grid, system.spline_order
    Q0, _ = pme.charge_grid(x, base_charge, box, K, order,
                            scap=system.pme_scap)
    e = []
    for s in range(batch.changed_atoms.shape[0]):
        changed = batch.changed_atoms[s]
        safe = changed.clamp(min=0)
        dq = batch.topo.charge[s, safe] - base_charge[safe]
        e.append(pme.recip_energy(Q0 + pme.delta_charge_grid(
            x, dq, changed, batch.changed_mask[s], box, K, order), cbw))
    return torch.stack(e)


def diabat_diagonal_energies_full(x, box, batch: DiabatBatch, system, pairs,
                                  cbw, base_charge):
    """Every diabat's energy recomputed in full in its own topology, a
    state at a time: (diag (S,), principle breakdown, e_recip (S,)).  The
    ground truth of diabat_diagonal_energies (held equal by the tests);
    not on the MD path."""
    tb = batch.topo
    bds = [total_mod.energy_no_recip(x, box, state_topology(tb, s), system,
                                     pairs)
           for s in range(batch.changed_atoms.shape[0])]
    extra = (repulsion.ms_evb_repulsion(x, box, tb, system)
             + repulsion.reference_energy(tb, system))
    e_recip = _recip_batched(x, box, batch, system, cbw, base_charge)
    diag = torch.stack([bd.total for bd in bds]) + extra + e_recip
    return diag, bds[0], e_recip


def coupling_elements(x, box, batch: DiabatBatch, system, com0, xa_pc0,
                      topo0):
    """H_{parent(s), s} of every non-principle state."""
    dset = batch.dset
    S = system.evb_max_states
    sidx = torch.arange(S, device=x.device)
    active = (sidx < dset.n_states) & (sidx > 0)
    last = (dset.n_hops - 1).clamp(min=0)
    hop_last = dset.hop_log[sidx, last]                         # (S, 5)
    mols, mvalid = _dedup_mols(dset.hop_log)
    com_chain = molecule_com(x, _rows_of(batch.topo.mol_atoms,
                                         mols.clamp(min=0)),
                             system.mass, box)                  # (S, 2C, 3)
    # the charges are topology data: no gradient to carry back
    mol_pack = (xa_pc0[..., 0:3], xa_pc0[..., 3].detach(),
                topo0.mol_atoms >= 0)
    return coupling.coupling_elements(x, box, batch.topo, system, com0,
                                      mol_pack, (mols, mvalid, com_chain,
                                                 last), hop_last, active)


def assemble_hamiltonian(x, box, batch: DiabatBatch, system, pairs, cbw,
                         base_charge, topo0, full_idx, com0, shard=None):
    S = system.evb_max_states
    dset = batch.dset
    sidx = torch.arange(S, device=x.device)
    active = sidx < dset.n_states
    xs = x if shard is None else shard.shared(x)
    xa_pc0 = total_mod.mol_sites_packed(xs, topo0.charge, topo0.mol_atoms)
    diag, bd0, e_recip, row_over = diabat_diagonal_energies(
        x, box, batch, system, pairs, cbw, base_charge, topo0, full_idx,
        xa_pc0=xa_pc0, shard=shard)
    # the principle diabat's reported decomposition includes its recip
    bds = replace(bd0, elec=bd0.elec + e_recip[0],
                  total=bd0.total + e_recip[0])
    offdiag = coupling_elements(xs, box, batch, system, com0, xa_pc0, topo0)
    park = diag[0].detach() + INACTIVE_DIAG * (1.0 + sidx.to(x.dtype) / S)
    diag = torch.where(active, diag, park)
    par = dset.parent.clamp(min=0)
    val = torch.where((dset.parent >= 0) & active, offdiag,
                      torch.zeros_like(offdiag))
    H = torch.diag_embed(diag)
    H = H.index_put((par, sidx), val, accumulate=True)
    H = H.index_put((sidx, par), val, accumulate=True)
    return H, bds, e_recip, row_over


@dataclass
class EvbResult:
    energy: torch.Tensor           # adiabatic ground-state energy
    force: torch.Tensor            # (N, 3)
    eigenvector: torch.Tensor      # (S,)
    n_states: torch.Tensor
    principle: torch.Tensor        # () diabat with max |c_i|
    hamiltonian: torch.Tensor      # (S, S)
    breakdown: total_mod.EnergyBreakdown
    overflow: torch.Tensor         # () bool: the state set was truncated
    hydronium_of: torch.Tensor     # (S,)
    n_hops_of: torch.Tensor        # (S,)
    principle_topo: Topology       # the principle diabat's topology
    # () bool: an on-demand adjacency row exceeded its capacity (cell
    # path), in the Hamiltonian's rows or the enumeration's
    row_overflow: torch.Tensor = None
    # () bool: the small tier's enumeration overflowed (tier "small": the
    # result is not valid, evaluate at the full cap instead)
    small_overflow: torch.Tensor = None
    gs_failed: torch.Tensor = None # () bool: kernel E did not converge


def energy_and_grad(fn, x):
    """(energy, aux, d energy / dx) of `fn(x) -> (energy (), aux)`, aux a
    tuple of tensors and dataclasses of tensors.  An unbatched x takes
    torch.autograd.grad (the step's own path, unchanged); an x inside a
    torch.func transform (a replica batch vmaps the step: md/
    integrators.py) takes the functional torch.func.grad, which vmap can
    batch and which runs the same backward."""
    if not torch._C._functorch.is_functorch_wrapped_tensor(x):
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            energy, aux = fn(xg)
            grad, = torch.autograd.grad(energy, xg)
        return energy.detach(), aux, grad
    structure = []

    def flat(xg):
        # functorch unwraps a pytree of tensors only: the dataclasses go
        # through as their leaves, and come back in their structure
        energy, aux = fn(xg)
        structure.append(aux)
        return energy, (energy, leaves(aux))

    grad, (energy, vals) = torch.func.grad(flat, has_aux=True)(x)
    return energy, with_leaves(structure[0], iter(vals)), grad


def _eval_at_cap(x, box, topo, system, pairs, cbw, full_idx, com,
                 dset: DiabatSet, shard=None):
    """Diabat topologies -> H -> ground state -> Hellmann-Feynman forces,
    at cap system.evb_max_states; with `shard` the forces are the sum of
    the ranks' shares."""
    batch = build_diabat_topologies(topo, dset, system)

    def hf_energy(xg):
        H, bds, _, row_over = assemble_hamiltonian(
            xg, box, batch, system, pairs, cbw, topo.charge, topo, full_idx,
            com, shard=shard)
        _, c, gs_failed = ground_state(H)
        c = c.detach()
        return c @ H @ c, (H.detach(), bds, row_over, c, gs_failed)

    energy, (H, bds, row_over, c, gs_failed), grad = energy_and_grad(
        hf_energy, x)
    if shard is not None:
        grad = shard.sum_force(grad)
    principle = torch.argmax(c.abs())
    ptopo = state_topology(batch.topo, principle)
    bds = replace(bds, **{k: getattr(bds, k).detach()
                          for k in ("total", "elec", "vdw", "bond", "angle",
                                    "dihedral")})
    res = EvbResult(energy=energy, force=-grad, eigenvector=c,
                    n_states=dset.n_states, principle=principle,
                    hamiltonian=H, breakdown=bds,
                    overflow=dset.overflow, hydronium_of=dset.hydronium_of,
                    n_hops_of=dset.n_hops, principle_topo=ptopo,
                    row_overflow=row_over | dset.row_overflow,
                    small_overflow=torch.zeros_like(dset.overflow),
                    gs_failed=gs_failed)
    return res, batch


def small_state_tier(system) -> int:
    """Small-tier cap of the two-tier evaluation, 0 = off.

    evb_small_states -1 (auto) gives 48 when the cap is >= 64 on a CUDA
    device and 0 on the CPU (the reference likewise turns the auto tier
    off on its CPU backend); an explicit value > 0 holds on any device."""
    S = system.evb_max_states
    s1 = system.evb_small_states
    if s1 < 0:
        if system.device.type == "cpu":
            return 0
        s1 = 48 if S >= 64 else 0
    if s1 <= 1 or s1 >= S:
        return 0
    return s1


def _pad_states(res: EvbResult, batch: DiabatBatch, S: int):
    """Pad a small-tier result up to the full cap S.  Padded rows are
    inert: every consumer masks by n_states or reads row `principle`."""
    S1 = res.eigenvector.shape[0]
    pad = S - S1
    sidx = torch.arange(S, device=res.eigenvector.device)

    def pad0(a, fill):
        return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                        dtype=a.dtype, device=a.device)])

    H = torch.zeros((S, S), dtype=res.hamiltonian.dtype,
                    device=res.hamiltonian.device)
    H[:S1, :S1] = res.hamiltonian
    park = res.hamiltonian[0, 0] + INACTIVE_DIAG * (
        1.0 + sidx[S1:].to(H.dtype) / S)
    H[sidx[S1:], sidx[S1:]] = park
    res = replace(res, eigenvector=pad0(res.eigenvector, 0),
                  hamiltonian=H, hydronium_of=pad0(res.hydronium_of, -1),
                  n_hops_of=pad0(res.n_hops_of, 0))
    d = batch.dset
    dset = replace(d, hop_log=pad0(d.hop_log, -1), n_hops=pad0(d.n_hops, 0),
                   parent=pad0(d.parent, -1),
                   hydronium_of=pad0(d.hydronium_of, -1))
    topo_b = Topology(**{
        k: torch.cat([v, v[:1].expand((pad,) + v.shape[1:])])
        for k, v in ((k, getattr(batch.topo, k))
                     for k in Topology.__dataclass_fields__)})
    batch = DiabatBatch(dset=dset, topo=topo_b,
                        changed_atoms=pad0(batch.changed_atoms, -1),
                        changed_mask=pad0(batch.changed_mask, False))
    return res, batch


def adiabatic_energy_force(x, box, topo, system, pairs, cbw, full_idx,
                           react_idx=None, com=None, tier="full",
                           shard=None):
    """Full MS-EVB energy/force evaluation -> (EvbResult, DiabatBatch).

    full_idx: the (N, K) full adjacency; react_idx: the short-cutoff rows
    for the hop search (full_idx if None); on the on-demand cell path both
    are CellTables.  com: per-molecule COM of (x, topo), used only where
    gradients are cut.

    Two-tier (small_state_tier): `tier` "small" evaluates at the small cap
    and sets EvbResult.small_overflow when its enumeration overflowed (the
    result is then not valid: evaluate at the full cap); "full" evaluates
    at the full cap.  The small-tier state set equals the full
    enumeration whenever it fits, so the physics is the same.  `shard`:
    the evaluation shared over ranks (the module docstring)."""
    if com is None:
        com = molecule_com(x, topo.mol_atoms, system.mass, box)
    com = com.detach()
    enum_src = react_idx if react_idx is not None else full_idx
    S1 = small_state_tier(system)
    if tier == "small" and S1:
        sys_small = system.replace(evb_max_states=S1)
        dset = enumerate_diabats(x, box, topo, sys_small, enum_src, com)
        res, batch = _eval_at_cap(x, box, topo, sys_small, pairs, cbw,
                                  full_idx, com, dset, shard)
        # where the small set holds, the full cap's is the same and did
        # not overflow
        res = replace(res, small_overflow=dset.overflow,
                      overflow=torch.zeros_like(dset.overflow))
        return _pad_states(res, batch, system.evb_max_states)
    dset = enumerate_diabats(x, box, topo, system, enum_src, com)
    return _eval_at_cap(x, box, topo, system, pairs, cbw, full_idx, com,
                        dset, shard)
