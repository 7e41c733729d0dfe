"""Total energy aggregation (counterpart of reactive_pb_nn_md_tpu/models/total.py;
calculate_total_force_energy, total_energy_forces.f90).

  inter-molecular real space : erfc-Ewald + LJ/SAPT -- kernel A
                               (ops/kernels/realspace_pair) when the system
                               has a cell grid, else the half pair list
  intra-molecular nonbonded  : exclusion-coded template pairs
  PME reciprocal + Ewald self
  bonds / angles / dihedrals

With `shard` (parallel/shard.py) each rank computes its share of these
terms and the shares are summed over the ranks.
"""

from dataclasses import dataclass

import torch

from ..utils import pbc
from . import nonbonded, bonded, pme
from ..ops.kernels import realspace_pair
from ..ops.kernels.segment_sum import take_rows


@dataclass
class EnergyBreakdown:
    total: torch.Tensor
    elec: torch.Tensor
    vdw: torch.Tensor
    bond: torch.Tensor
    angle: torch.Tensor
    dihedral: torch.Tensor
    rs_overflow: torch.Tensor      # () bool: kernel A's cell grid did not hold
    slab_overflow: torch.Tensor    # () bool: the PME slab cap did not hold


def realspace_inter(x, box, topo, system, pairs, shard=None):
    """(e_elec, e_vdw, overflow) of the inter-molecular pairs within the
    cutoff.

    With a cell grid (system.rs_cells) and an un-batched x this is kernel
    A's path (the plain cell sweep for CPU tensors), and overflow says
    that a cell's capacity or width did not hold; otherwise the half pair
    list on the same device, which cannot overflow here.  Same-molecule
    pairs are masked with this topology's molecule assignment.  With
    `shard`, this rank's share: its home cells, or its atoms' rows of the
    half list."""
    if system.rs_cells and x.ndim == 2:
        f = x.dtype
        return realspace_pair.realspace_inter_cells(
            x, topo.charge.to(f), topo.atom_type.to(f), topo.atom_mol.to(f),
            box, realspace_pair.build_tabs(system, f), system.rs_cells,
            system.real_space_cutoff, system.alpha_sqrt, system.has_sapt,
            None if shard is None else shard.cells(system.rs_cells))
    if shard is not None:
        rows = shard.atoms(system.n_atoms)
        pairs = tuple(p[rows] for p in pairs)
    e_el, e_vdw = _realspace_inter_pairs(x, box, topo, system, pairs)
    return e_el, e_vdw, torch.zeros((), dtype=torch.bool, device=x.device)


def _realspace_inter_pairs(x, box, topo, system, pairs):
    """The half-list pair sweep (counterpart of _realspace_inter_xla)."""
    i, j, mask = pairs
    if j.shape[-1] == 0 and system.n_atoms > 1:
        raise ValueError("the half neighbor list was not built, but the "
                         "pair sweep needs it")
    inter = mask & (topo.atom_mol[i] != topo.atom_mol[j])
    dr = pbc.min_image(x[i] - take_rows(x, torch.where(mask, j, -1)), box)
    r2 = torch.sum(dr * dr, dim=-1)
    within = inter & (r2 < system.real_space_cutoff ** 2)
    r2s = torch.where(within, r2, torch.ones_like(r2))
    r = torch.sqrt(r2s)
    qq = topo.charge[i] * topo.charge[j]
    e_elec = nonbonded.ewald_real(qq, r, system.alpha_sqrt)
    ti = topo.atom_type[i].expand_as(j)
    tj = topo.atom_type[j]
    vtype = system.ff.vdw_type[ti, tj]
    params = system.ff.vdw_params[ti, tj].to(x.dtype)
    e_vdw = nonbonded.vdw_pair_energy(vtype, params, params,
                                      torch.zeros_like(within), r, r2s,
                                      has_sapt=system.has_sapt)
    zero = torch.zeros_like(e_elec)
    return (torch.where(within, e_elec, zero).sum(),
            torch.where(within, e_vdw, zero).sum())


def mol_sites_packed(x, charge, mol_atoms):
    """(*B, A, 4) [position | charge] of the molecules' template slots
    (padded slots read atom 0; callers mask).  charge may carry a leading
    state axis matching mol_atoms' (S, ...).  Without one, mol_atoms are
    distinct molecules' rows, so each atom is read once and x[g]'s
    backward adds one term an atom (exact in any order); the states'
    rows read an atom many times and take take_rows' fixed-order sum,
    their padded slots (-1) its padding."""
    g = mol_atoms.clamp(min=0)
    if charge.ndim == 1:
        return torch.cat([x[g], charge[g][..., None]], dim=-1)
    S = charge.shape[0]
    q = torch.gather(charge, 1, g.reshape(S, -1)).reshape(g.shape)
    return torch.cat([take_rows(x, mol_atoms), q[..., None]], dim=-1)


def intra_terms(xa_pc, mtype, box, system, mmask=None):
    """Per-molecule intra nonbonded (el, vdw), shapes (*B,), of molecules
    with site data xa_pc (*B, A, 4) and types mtype (*B,).

    Exclusion codes: 1 excluded (only the -erf reciprocal correction),
    2 special 1-4, 0 normal; vdW has no cutoff, electrostatics does."""
    A = system.max_atoms_per_mol
    iu, ju = torch.triu_indices(A, A, 1, device=xa_pc.device)
    natom = system.mt.natom[mtype]
    valid = ju < natom[..., None]                               # (*B, P2)
    if mmask is not None:
        valid = valid & mmask[..., None]
    code = system.mt.excl_code[:, iu, ju][mtype]                 # (*B, P2)
    itab = system.mt.intra_tab[mtype].to(xa_pc.dtype)            # (*B, P2, 13)
    # the pairs (i < j) read from the slots' full difference and charge
    # product matrices: each (i, j) is read once, so the pair gather's
    # gradient adds one term a target, and the slots' gradients are the
    # broadcasts' sums (a gather of slots i and j would sum each slot's
    # pairs with an accumulating index op)
    dr = pbc.min_image((xa_pc[..., :, None, 0:3]
                        - xa_pc[..., None, :, 0:3])[..., iu, ju, :], box)
    r2 = torch.where(valid, torch.sum(dr * dr, -1),
                     torch.ones_like(dr[..., 0]))
    r = torch.sqrt(r2)
    q = xa_pc[..., 3].detach()          # charges: no gradient to carry
    qq = (q[..., :, None] * q[..., None, :])[..., iu, ju]
    excluded = valid & (code == 1)
    nonexcl = valid & (code != 1)
    e_corr = nonbonded.ewald_exclusion_correction(qq, r, system.alpha_sqrt)
    within = nonexcl & (r2 < system.real_space_cutoff ** 2)
    e_elec = nonbonded.ewald_real(qq, r, system.alpha_sqrt)
    vtype = torch.round(itab[..., 0]).to(torch.int64)
    e_vdw = nonbonded.vdw_pair_energy(vtype, itab[..., 1:7],
                                      itab[..., 7:13], code == 2, r, r2,
                                      has_sapt=system.has_sapt)
    zero = torch.zeros_like(e_elec)
    el = torch.where(excluded, e_corr, zero) + torch.where(within, e_elec,
                                                           zero)
    return el.sum(-1), torch.where(nonexcl, e_vdw, zero).sum(-1)


def energy_no_recip(x, box, topo, system, pairs, xa_pc=None, shard=None):
    """All terms except reciprocal PME, including the Ewald self term.
    With `shard` (xa_pc not used) every rank computes its share: its
    real-space share, its molecules' intra and bonded terms and its
    atoms' self term; the five scalars are summed over the ranks
    (parallel/shard.py: the gradient passed through, so each rank's
    backward gives its own share's)."""
    e_real_elec, e_real_vdw, rs_overflow = realspace_inter(
        x, box, topo, system, pairs, shard)
    mols, atoms = slice(None), slice(None)
    if shard is not None:
        mols, atoms = shard.mols(system.n_mole), shard.atoms(system.n_atoms)
        xa_pc = None
    if xa_pc is None:
        xa_pc = mol_sites_packed(x, topo.charge, topo.mol_atoms[mols])
    mtype = topo.mol_mtype[mols]
    ie, iv = intra_terms(xa_pc, mtype, box, system)
    e_intra_elec, e_intra_vdw = ie.sum(), iv.sum()
    e_self = pme.ewald_self(topo.charge[atoms], system.alpha_sqrt)
    eb, ea, ed = (t.sum() for t in bonded.bonded_energies(
        xa_pc[..., 0:3], mtype, box, system))
    elec = e_real_elec + e_intra_elec + e_self
    vdw = e_real_vdw + e_intra_vdw
    if shard is not None:
        elec, vdw, eb, ea, ed = shard.sum(
            torch.stack([elec, vdw, eb, ea, ed]), "energy").unbind()
    return EnergyBreakdown(total=elec + vdw + eb + ea + ed, elec=elec,
                           vdw=vdw, bond=eb, angle=ea, dihedral=ed,
                           rs_overflow=rs_overflow,
                           slab_overflow=torch.zeros_like(rs_overflow))


def total_energy(x, box, topo, system, pairs, cbw, shard=None):
    """Full potential energy of one topology (non-reactive path); with
    `shard` every rank's share summed over the ranks (parallel/shard.py)."""
    bd = energy_no_recip(x, box, topo, system, pairs, shard=shard)
    Q, slab_over = pme.charge_grid(x, topo.charge, box, system.pme_grid,
                                   system.spline_order, scap=system.pme_scap,
                                   shard=shard)
    e_recip = pme.recip_energy(Q, cbw)
    return EnergyBreakdown(total=bd.total + e_recip, elec=bd.elec + e_recip,
                           vdw=bd.vdw, bond=bd.bond, angle=bd.angle,
                           dihedral=bd.dihedral, rs_overflow=bd.rs_overflow,
                           slab_overflow=slab_over)
