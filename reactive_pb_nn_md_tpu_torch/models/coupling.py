"""Diabatic coupling matrix elements H_ij = (Vconst + Vex) * A(q, R_OO)
(counterpart of reactive_pb_nn_md_tpu/models/coupling.py; eqs. 10-12 of
JPC B 2008, 112, 467, ms_evb.f90:1021-1403).

  geometric factor A : type 1 = MS-EVB3 form, type 2 = product of
                       Gaussians, type 3 = PB-NN: the MLP of
                       nn/coupling_mlp.py (System.evb.nn_params), its
                       Vconst the MLP's own, with the smooth
                       coordination numbers of donor and acceptor as
                       extra inputs when its first layer has them.
  exchange term Vex  : Coulomb sum of exchange charges on the Zundel
                       complex against all other molecules, no cutoff, no
                       Ewald; PBC shifts against the Zundel centre of mass.

Evaluated for every state at once (leading axis S) in the state's diabat
topology; the transferred proton and the heavy atoms are global atom
indices from the hop log.  Forces from autograd.
"""

import math

import torch

from ..nn.coupling_mlp import apply_mlp
from ..ops.kernels.segment_sum import take_rows
from ..utils.constants import CONV_E2A_KJMOL
from ..utils import pbc

# cutoff (A) of the coordination numbers' cosine switch, and the mass
# (g/mol) above which an atom is heavy (O, S, ...): _env_features
ENV_CUTOFF = 3.5
HEAVY_MASS = 10.0


def geometric_factor(func, p, q_vec, r_OO_vec, nn_apply=None):
    """A(q, R_OO) for every type, (S,): types 1 and 2 from the parameter
    rows p, type 3 from nn_apply(q2, roo) where given (else 0, which a
    System never reaches: topology.check_nn_coupling); the sqrt is
    guarded so inactive rows (donor == acceptor) give no NaN gradient."""
    q2 = (q_vec * q_vec).sum(-1)
    roo2 = (r_OO_vec * r_OO_vec).sum(-1)
    roo = torch.sqrt(torch.where(roo2 > 1e-12, roo2, torch.ones_like(roo2)))
    gamma, P, k, D, beta, R0, Pp, alpha, rl0 = (p[:, i] for i in range(1, 10))
    f1 = torch.exp(-gamma * q2)
    f2 = 1.0 + P * torch.exp(-k * (roo - D) ** 2)
    f3 = (0.5 * (1.0 - torch.tanh(beta * (roo - R0)))
          + Pp * torch.exp(-alpha * (roo - rl0)))
    a1 = f1 * f2 * f3
    a2 = torch.exp(-p[:, 1] * q2) * torch.exp(-p[:, 2] * (roo - p[:, 3]) ** 2)
    a = torch.where(func == 1, a1,
                    torch.where(func == 2, a2, torch.zeros_like(a1)))
    if nn_apply is not None:
        a = torch.where(func == 3, nn_apply(q2, roo), a)
    return a


def _env_features(x, box, atom_mol, mass, d, a, r_O1, r_O2):
    """(S, 2) PB-NN environment features of every state: the smooth
    first-shell coordination numbers of the donor and acceptor heavy
    atoms r_O1, r_O2 (S, 3),

        cn = sum_{heavy k of other molecules} f(|r_k - r_O|),
        f(r) = (1 + cos(pi min(r, rc) / rc)) / 2,   rc = ENV_CUTOFF,

    over the heavy atoms (mass > HEAVY_MASS) of molecules other than the
    state's donor d and acceptor a (S,), by atom_mol (S, N), the states'
    molecule of each atom; each as cn / 4 - 1 (0 = tetrahedral water).
    Differentiable in x; an (S, N) distance block per centre.  The 1e-12
    A^2 floor of r^2 is the JAX package's."""
    other = ((atom_mol != d[:, None]) & (atom_mol != a[:, None])
             & (mass > HEAVY_MASS)[None, :])

    def cn(center):
        dr = pbc.min_image(x[None, :, :] - center[:, None, :], box)
        r = torch.sqrt(torch.clamp((dr * dr).sum(-1), min=1e-12))
        f = 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(r, max=ENV_CUTOFF)
                                   / ENV_CUTOFF))
        return torch.where(other, f, torch.zeros_like(f)).sum(1)

    return torch.stack([cn(r_O1) / 4.0 - 1.0, cn(r_O2) / 4.0 - 1.0], dim=1)


# |r|^2 (A^2) below which a Zundel atom and a pack entry are one atom:
# its two routes (a minimum image against the molecule's first atom, the
# pack minus its lattice shift) agree to a few ulps only, ~1e-6 A at 20 A
# in fp32, where the JAX package's 1e-12 kept such pairs and their 1/r^2
# gradients, which cancel between the sweeps only to fp32 rounding
# (thousands of kJ/mol/A on one atom).  Distinct atoms are never within
# 1e-3 A, so fp64 results are unchanged.
_COINCIDENT_R2 = 1e-6


def _vex_sum(zx, zq, xg, qg, mask):
    """sum_z sum_g zq_z qg / |zx_z - xg| per state: zx (S, Z, 3), zq
    (S, Z), xg (S, G1, G2, 3) shifted positions, qg / mask broadcastable
    to (S, G1, G2).  Coincident pairs are masked (they cancel between the
    full and subtraction sweeps)."""
    dr = zx[:, :, None, None, :] - xg[:, None]
    r2 = (dr * dr).sum(-1)                                      # (S, Z, G1, G2)
    pair = ((zq != 0.0)[:, :, None, None] & mask[:, None]
            & (r2 > _COINCIDENT_R2))
    r2 = torch.where(pair, r2, torch.ones_like(r2))
    t = zq[:, :, None, None] * qg[:, None] / torch.sqrt(r2)
    return torch.where(pair, t, torch.zeros_like(t)).sum((1, 2, 3))


def coupling_elements(x, box, topo_b, system, com0, mol_pack, chain,
                      hop_last, active):
    """(S,) off-diagonal element of every state with its parent.

    topo_b: the states' topologies; com0: principle-topology molecule COMs
    (M, 3); mol_pack: (positions (M, A, 3), charges (M, A), mask (M, A)) of
    the principle topology; chain: (mols (S, 2C), mvalid, com_chain
    (S, 2C, 3), last (S,)); hop_last: (S, 5) each state's last hop.

    Vex is swept molecule-major: the state-independent principle pack, then
    a correction of the <= 2C chain molecules whose charges / membership
    differ in the state (_vex_mol_major of the JAX package):
        vex = sum(all, base) - sum(chain, base) + sum(chain not d/a, state)."""
    evb = system.evb
    S = hop_last.shape[0]
    s_idx = torch.arange(S, device=x.device)
    zero_i = torch.zeros_like(hop_last[:, 0])
    d = torch.where(active, hop_last[:, 0], zero_i)
    a = torch.where(active, hop_last[:, 3], zero_i)
    proton = torch.where(active, hop_last[:, 1], zero_i).clamp(min=0)
    d_heavy = torch.where(active, hop_last[:, 2], zero_i).clamp(min=0)
    a_heavy = torch.where(active, hop_last[:, 4], zero_i).clamp(min=0)
    d_mtype = topo_b.mol_mtype[s_idx, d]
    a_mtype = topo_b.mol_mtype[s_idx, a]

    # ---- geometric factor, positions min-imaged against O_donor
    r_O1 = take_rows(x, d_heavy)
    r_O2 = r_O1 + pbc.min_image(take_rows(x, a_heavy) - r_O1, box)
    r_H = r_O1 + pbc.min_image(take_rows(x, proton) - r_O1, box)
    q_vec = (r_O1 + r_O2) / 2.0 - r_H
    t1 = topo_b.atom_type[s_idx, d_heavy]
    t2 = topo_b.atom_type[s_idx, a_heavy]
    t3 = topo_b.atom_type[s_idx, proton]
    func = evb.cpl_func[t1, t2, t3]
    params = evb.cpl_params[t1, t2, t3].to(x.dtype)             # (S, 10)
    vconst = params[:, 0]
    nn_apply = None
    nn = evb.nn_params
    if nn is not None:
        # the MLP's input count is a static shape: no host read
        env = (_env_features(x, box, topo_b.atom_mol, system.mass, d, a,
                             r_O1, r_O2)
               if nn["w"][0].shape[0] > 3 else None)

        def nn_apply(q2, roo):
            return apply_mlp(nn, q2, roo, env)

        vconst = torch.where(func == 3, nn["vconst"].to(x.dtype), vconst)
    a_fac = geometric_factor(func, params, q_vec, r_O1 - r_O2, nn_apply)

    # ---- exchange electrostatics Vex
    mols, mvalid, com_chain, last = chain
    C = mols.shape[1] // 2
    d_atoms = topo_b.mol_atoms[s_idx, d]                        # (S, A)
    a_atoms = topo_b.mol_atoms[s_idx, a]
    d_am, a_am = d_atoms >= 0, a_atoms >= 0
    d_ai, a_ai = d_atoms.clamp(min=0), a_atoms.clamp(min=0)
    com_d = com_chain[s_idx, last]
    com_a = com_chain[s_idx, C + last]
    shift_a = ((com_a - com_d) - pbc.min_image(com_a - com_d, box)).detach()
    zero = torch.zeros_like(system.mass[d_ai])
    mass_d = torch.where(d_am, system.mass[d_ai], zero).sum(1)
    mass_a = torch.where(a_am, system.mass[a_ai], zero).sum(1)
    zundel = ((mass_d[:, None] * com_d + mass_a[:, None] * (com_a - shift_a))
              / (mass_d + mass_a)[:, None]).detach()
    dz = com0[None] - zundel[:, None]
    shift_mol = (dz - pbc.min_image(dz, box)).detach()          # (S, M, 3)
    dc = com_chain - zundel[:, None]
    shift_chain = (dc - pbc.min_image(dc, box)).detach()        # (S, 2C, 3)

    qx_d = torch.where(d_am, evb.exchange_q_atype[
        torch.gather(topo_b.atom_type, 1, d_ai)], zero)
    qx_a = torch.where(a_am, evb.exchange_q_atype[
        torch.gather(topo_b.atom_type, 1, a_ai)], zero)
    q_transfer = evb.exchange_q_proton[a_mtype, d_mtype]
    qx_a = torch.where(a_atoms == proton[:, None], q_transfer[:, None], qx_a)

    def whole(ai):
        xa = take_rows(x, ai)
        return xa[:, :1] + pbc.min_image(xa - xa[:, :1], box)

    zx = torch.cat([whole(d_ai), whole(a_ai) - shift_a[:, None]], dim=1)
    zq = torch.cat([qx_d, qx_a], dim=1).to(x.dtype)             # (S, 2A)

    xm0, qm0, amask0 = mol_pack
    full = _vex_sum(zx, zq, xm0[None] - shift_mol[:, :, None, :], qm0[None],
                    amask0[None])
    cm = mols.clamp(min=0)                                      # (S, 2C)
    sub = _vex_sum(zx, zq,
                   take_rows(xm0, cm)
                   - shift_mol[s_idx[:, None], cm][:, :, None, :],
                   qm0[cm], amask0[cm] & mvalid[:, :, None])
    atoms_c = topo_b.mol_atoms[s_idx[:, None], cm]              # (S, 2C, A)
    av = ((atoms_c >= 0) & mvalid[:, :, None]
          & ((cm != d[:, None]) & (cm != a[:, None]))[:, :, None])
    ai = atoms_c.clamp(min=0)
    q_c = torch.gather(topo_b.charge, 1, ai.reshape(S, -1)).reshape(ai.shape)
    # the entries av masks out are padding to take_rows (no gradient)
    add = _vex_sum(zx, zq, take_rows(x, torch.where(av, ai, -1))
                   - shift_chain[:, :, None, :], q_c, av)
    vex = (full - sub + add) * CONV_E2A_KJMOL

    return torch.where(active, (vconst + vex) * a_fac,
                       torch.zeros_like(a_fac))
