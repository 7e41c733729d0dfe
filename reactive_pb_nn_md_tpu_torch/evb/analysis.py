"""EVB trajectory diagnostics (counterpart of
reactive_pb_nn_md_tpu/evb/analysis.py; ms_evb.f90:3684-3848).

  hbond_network      : donor / acceptor hydrogen-bond counts around the
                       hydronium (get_hbond_neighbors / get_h3o_network):
                       r_OO < 3.6 A, r_HO < 2.41 A, O-O-H angle < 30 deg
  diabat_report      : per-diabat hydronium molecule, c_i^2 and solvation
                       shell (print_evb_trajectory_data, ms_evb.f90:3128-3162)
  zundel_diagnostics : donor / acceptor coordinates and the geometric
                       factor A of one diabat, the debug >= 2 A-file
                       content (write_geometry)

Host-side diagnostics of the output steps: each reads its device tensors
once.
"""

import math

import numpy as np
import torch

from ..models.coupling import geometric_factor
from ..utils import pbc


def hbond_network(x, box, topo, system, roo_cut=3.6, rho_cut=2.41,
                  angle_cut_deg=30.0):
    """(n_acceptors, n_donors): H-bonds the hydronium donates to water
    oxygens, and those water protons donate to it."""
    h = topo.hydronium_mol
    mt = topo.mol_mtype[h]
    row = topo.mol_atoms[h]
    atoms = row.clamp(min=0)
    heavy = atoms[system.mt.heavy_slot[mt].clamp(min=0)]
    types = torch.where(row >= 0, topo.atom_type[atoms],
                        torch.full_like(atoms, -1))
    is_proton = types == system.mt.proton_atype[mt]

    # candidate oxygens: reactive base atoms of the other molecules
    base = ((system.mt.reactive_bases[topo.mol_mtype[topo.atom_mol],
                                      topo.atom_slot] > 0)
            & (topo.atom_mol != h))
    o1 = x[heavy]
    d_o = pbc.min_image(x - o1[None, :], box)               # O1 -> O0
    roo = torch.sqrt((d_o * d_o).sum(-1))
    near = base & (roo < roo_cut)
    cos_cut = math.cos(math.radians(angle_cut_deg))

    # the hydronium donates: its protons H1 with r(H1, O0) < rho_cut and
    # angle(O1->O0, O1->H1) < the cut
    xh = x[atoms]
    d_h = xh - o1[None, :]
    d_h_norm = torch.sqrt(torch.clamp((d_h * d_h).sum(-1), min=1e-12))
    dho = pbc.min_image(x[None, :, :] - xh[:, None, :], box)
    rho = torch.sqrt((dho * dho).sum(-1))
    cosang = ((d_o[None, :, :] * d_h[:, None, :]).sum(-1)
              / (roo[None, :] * d_h_norm[:, None] + 1e-12))
    donate = (is_proton[:, None] & near[None, :] & (rho < rho_cut)
              & (cosang > cos_cut))

    # the hydronium accepts: protons H0 of near base molecules with
    # r(H0, O1) < rho_cut and angle(O0->O1, O0->H0) < the cut
    mol0 = topo.mol_atoms[topo.atom_mol, 0].clamp(min=0)
    is_water_h = (topo.atom_slot > 0) & near[mol0]
    o0 = x[mol0]
    d_ho1 = pbc.min_image(o1[None, :] - x, box)
    rh_o1 = torch.sqrt((d_ho1 * d_ho1).sum(-1))
    d_oo1 = pbc.min_image(o1[None, :] - o0, box)
    d_oh = x - o0
    cosang2 = (d_oo1 * d_oh).sum(-1) / (
        torch.sqrt(torch.clamp((d_oo1 * d_oo1).sum(-1), min=1e-12))
        * torch.sqrt(torch.clamp((d_oh * d_oh).sum(-1), min=1e-12)))
    accept = is_water_h & (rh_o1 < rho_cut) & (cosang2 > cos_cut)
    n_accept, n_donate = torch.stack([donate.sum(), accept.sum()]).tolist()
    return n_accept, n_donate


def diabat_report(hydronium_of, n_hops, eigenvector, n_states):
    """Rows (state, hydronium molecule, c_i^2, solvation shell), 1-based,
    of the per-state arrays the MD state carries."""
    c = np.asarray(eigenvector.detach().cpu())
    hyd = np.asarray(hydronium_of.cpu())
    nh = np.asarray(n_hops.cpu())
    return [(s + 1, int(hyd[s]) + 1, float(c[s] ** 2), int(nh[s]))
            for s in range(int(n_states))]


def format_diabat_report(step, rows):
    """The reference's per-output-step EVB block (ms_evb.f90:3128-3162):
    the diabat count, then one row per diabat."""
    lines = [f" i_step {step} number of diabats {len(rows)}"]
    for s, hyd_mol, ci2, shell in rows:
        lines.append(f"  diabat {s:3d} hydronium_molecule {hyd_mol:6d} "
                     f"ci^2 {ci2:10.6f} solvation_shell {shell:2d}")
    lines.append("")
    return "\n".join(lines)


def zundel_diagnostics(x, box, topo_d, system, donor_mol, acceptor_mol,
                       proton_atom, d_heavy=None, a_heavy=None):
    """(A, donor atom names, donor xyz, acceptor atom names, acceptor xyz)
    of one diabat: topo_d is its topology (the acceptor protonated),
    proton_atom / d_heavy / a_heavy global indices from its hop log.
    Without d_heavy / a_heavy the template heavy slot is used, right only
    for monoprotic bases such as water."""
    mt = system.mt
    d, a = int(donor_mol), int(acceptor_mol)
    if d_heavy is None:
        d_heavy = topo_d.mol_atoms[d, mt.heavy_slot[topo_d.mol_mtype[d]]
                                   .clamp(min=0)]
    if a_heavy is None:
        a_heavy = topo_d.mol_atoms[a, mt.heavy_slot[topo_d.mol_mtype[a]]
                                   .clamp(min=0)]
    d_heavy, a_heavy, proton = int(d_heavy), int(a_heavy), int(proton_atom)

    r_o1 = x[d_heavy]
    r_o2 = r_o1 + pbc.min_image(x[a_heavy] - r_o1, box)
    r_h = r_o1 + pbc.min_image(x[proton] - r_o1, box)
    q_vec = (r_o1 + r_o2) / 2.0 - r_h
    r_oo = r_o1 - r_o2
    t1, t2, t3 = (topo_d.atom_type[i] for i in (d_heavy, a_heavy, proton))
    func = system.evb.cpl_func[t1, t2, t3].reshape(1)
    params = system.evb.cpl_params[t1, t2, t3].reshape(1, -1).to(x.dtype)
    a_fac = float(geometric_factor(func, params, q_vec[None], r_oo[None])[0])

    names = system.ff.atype_names
    xs = x.detach().cpu().numpy()
    types = topo_d.atom_type.cpu().numpy()
    mol_atoms = topo_d.mol_atoms.cpu().numpy()

    def block(mol):
        atoms = [int(g) for g in mol_atoms[mol] if g >= 0]
        return [names[types[g]] for g in atoms], xs[atoms]

    dn, dx = block(d)
    an, ax = block(a)
    return a_fac, dn, dx, an, ax


def format_zundel_geometry(a_factor, donor_names, donor_xyz,
                           acceptor_names, acceptor_xyz):
    """The debug >= 2 A-file block (write_geometry, ms_evb.f90:3828-3848)."""
    lines = ["Donor Coordinates"]
    for nm, p in zip(donor_names, donor_xyz):
        lines.append(f" {nm} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}")
    lines.append("Acceptor Coordinates")
    for nm, p in zip(acceptor_names, acceptor_xyz):
        lines.append(f" {nm} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}")
    lines.append(f" A {a_factor}")
    lines.append("")
    return "\n".join(lines)
