"""Presets (counterpart of reactive_pb_nn_md_tpu/run/presets.py).

  * the acid box geometry: so3h_geometry, so3_geometry, water_geometry,
    _TEMPLATES and make_acid_frame, a jittered-lattice box of 1 CH3SO3H,
    n_so3 CH3SO3- and n_water H2O as a GroFrame (io/gro.py).  Numpy and
    seeded, so the frames equal the JAX package's bit for bit.  Its
    build_acid_system is not here: it reads the upstream CH3SO3H force
    field and topology files, which the repository does not hold;
  * soften_for_hops, which the PB-NN production path runs through.  A
    parameter preset returns a new System and leaves its argument as it
    was; hand it to Simulation.mutate_system.
"""

import dataclasses
import math

import numpy as np

from ..io.gro import GroFrame


def so3h_geometry():
    """CH3SO3H heavy-atom skeleton (template order C_a, S_a, O_a, O_a,
    O_ah, H_a; bond lengths in Angstrom)."""
    c = np.array([0.0, 0.0, 0.0])
    s = np.array([1.81, 0.0, 0.0])

    def sdir(theta_deg, phi_deg, r):
        t, p = math.radians(theta_deg), math.radians(phi_deg)
        return s + r * np.array([math.cos(t),
                                 math.sin(t) * math.cos(p),
                                 math.sin(t) * math.sin(p)])

    o1 = sdir(110, 90, 1.45)
    o2 = sdir(110, 210, 1.45)
    oh = sdir(110, 330, 1.62)
    # proton along the S->O(H) direction, tilted ~30 deg off-axis: keeps
    # S..H at ~2.4 A (a fixed lab-frame direction previously landed the
    # H 0.87 A from S -- inside the sulfur, a catastrophic start)
    u = (oh - s) / np.linalg.norm(oh - s)
    perp = np.cross(u, np.array([0.0, 0.0, 1.0]))
    perp /= np.linalg.norm(perp)
    h = oh + 0.97 * (0.87 * u + 0.5 * perp)
    return np.stack([c, s, o1, o2, oh, h])


def so3_geometry():
    """CH3SO3- (template order C_b, S_b, O_b, O_b, O_b)."""
    return so3h_geometry()[:5]


def water_geometry():
    r, th = 1.012, math.radians(113.24)
    return np.array([[0.0, 0.0, 0.0],
                     [r * math.sin(th / 2), r * math.cos(th / 2), 0.0],
                     [-r * math.sin(th / 2), r * math.cos(th / 2), 0.0]])


_TEMPLATES = {
    "so3h": (so3h_geometry, ["C_a", "S_a", "O_a", "O_a", "O_ah", "H_a"]),
    "so3": (so3_geometry, ["C_b", "S_b", "O_b", "O_b", "O_b"]),
    "h2o": (water_geometry, ["OW", "HW", "HW"]),
}


def make_acid_frame(n_water=215, n_so3=0, spacing=3.1, seed=0,
                    jitter=0.05) -> GroFrame:
    """Jittered-lattice box: 1 so3h + n_so3 so3- + n_water h2o.

    Acid-family molecules span ~3 A, so each acid is CENTERED on its
    site and its six face-adjacent sites are left empty (un-centered
    acids reached into neighbor sites and the resulting contacts
    exceeded the engine's 1e4 kJ/mol/A force abort even after a
    small-dt quench)."""
    rng = np.random.default_rng(seed)
    n_acid = 1 + n_so3
    n_mol = n_acid + n_water
    # slack sites for the blocked acid neighborhoods; the BOX keeps the
    # target per-molecule volume (spacing^3 per water, ~3x for an acid),
    # so the occupied-site spacing is slightly tighter than `spacing` --
    # the equilibration quench relaxes that
    n_side = math.ceil((n_mol + 7 * n_acid) ** (1 / 3))
    L = max((n_mol + 2 * n_acid) ** (1 / 3) * spacing, 11.5)
    spacing = L / n_side

    all_sites = [(i, j, k) for i in range(n_side) for j in range(n_side)
                 for k in range(n_side)]
    perm = rng.permutation(len(all_sites))
    blocked = set()
    acid_sites = []
    for idx in perm:
        if len(acid_sites) == n_acid:
            break
        s = all_sites[idx]
        if s in blocked:
            continue
        acid_sites.append(s)
        blocked.add(s)
        for d in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                  (0, 0, 1), (0, 0, -1)):
            blocked.add(((s[0] + d[0]) % n_side, (s[1] + d[1]) % n_side,
                         (s[2] + d[2]) % n_side))
    water_sites = [all_sites[i] for i in perm
                   if all_sites[i] not in blocked][:n_water]
    if len(water_sites) < n_water or len(acid_sites) < n_acid:
        raise ValueError("lattice too small for the requested mixture")

    placements = [("so3h", acid_sites[0])] \
        + [("so3", s) for s in acid_sites[1:]] \
        + [("h2o", s) for s in water_sites]

    mol_names, atom_names, mol_first, mol_natom, xyz = [], [], [], [], []
    count = 0
    for name, (i, j, k) in placements:
        origin = (np.array([i, j, k]) + 0.5) * spacing
        origin += rng.uniform(-jitter, jitter, 3)
        geom_fn, anames = _TEMPLATES[name]
        pos = geom_fn()
        pos = pos - pos.mean(axis=0) + origin     # center on the site
        mol_names.append(name)
        atom_names.extend(anames)
        mol_first.append(count)
        mol_natom.append(len(pos))
        count += len(pos)
        xyz.append(pos)
    return GroFrame(title="ch3so3h box", mol_names=mol_names,
                    mol_first_atom=np.array(mol_first, np.int32),
                    mol_natom=np.array(mol_natom, np.int32),
                    atom_names=atom_names, xyz=np.concatenate(xyz),
                    box=np.eye(3) * L)


def soften_for_hops(system, coupling_scale=2.0, da_scale=0.5,
                    pa_scale=0.5, c12_scale=1.0, c12_pair=("O_h3o", "OW")):
    """A documented softening of the EVB surface that brings the
    proton-transfer barrier down to thermally accessible heights, for
    demonstrating spontaneous proton transport (the published MS-EVB3
    constants put the flagship liquid's barrier far above kT).  Knobs:

      coupling_scale : multiplies Vconst (cpl_params[..., 0], the eq. 10
                       prefactor, ms_evb.f90:1196-1231);
      da_scale       : multiplies the donor-acceptor repulsion prefactor
                       B (da_params[..., 0], ms_evb.f90:2295-2399);
      pa_scale       : multiplies the Born-Mayer proton-acceptor
                       prefactor C (pa_params[..., 0], ms_evb.f90:2405-2478);
      c12_scale      : multiplies the C12 core (vdw_params[..., 0]) of the
                       named LJ cross pair in both orders (twice where the
                       two names are one type, as the JAX package does).

    Only these tables change, as in the JAX package: the per-template
    intra-molecular table (MolTypeTable.intra_tab) keeps the deck's C12,
    and a PB-NN MLP's own Vconst is not scaled."""
    evb = system.evb

    def scaled(t, s):
        t = t.clone()
        t[..., 0] *= s
        return t

    evb = dataclasses.replace(
        evb, cpl_params=scaled(evb.cpl_params, coupling_scale),
        da_params=scaled(evb.da_params, da_scale),
        pa_params=scaled(evb.pa_params, pa_scale))
    ff = system.ff
    if c12_scale != 1.0 and c12_pair:
        names = list(ff.atype_names)
        i, j = names.index(c12_pair[0]), names.index(c12_pair[1])
        vp = ff.vdw_params.clone()
        vp[i, j, 0] *= c12_scale
        vp[j, i, 0] *= c12_scale
        ff = dataclasses.replace(ff, vdw_params=vp)
    return system.replace(evb=evb, ff=ff)
