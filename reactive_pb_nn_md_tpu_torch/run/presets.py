"""Presets (counterpart of reactive_pb_nn_md_tpu/run/presets.py, and of
the water box the JAX package's run scripts build).

  * the water box: water_box (waters and one hydronium on a jittered
    cubic lattice, the tests' fixture frame), water_deck (its four input
    files: the MS-EVB3 water force field and topology of
    examples/water_msevb/, a sim.pmt with cutoff 4.5, Verlet 5.5, alpha
    0.7), water_system (its system, topology, frame and parameters) and
    build_water, the (system, cbw, cfg, ms) of such a box with 300 K
    velocities from a seeded generator.  The JAX run scripts' boxes:
    the flagship build_water(215, 32, "fp32", 80), the 10k box
    build_water(3332, 64, "fp32", 32) (the deck of examples/water_10k/),
    the 100k box build_water(33332, 128, "fp32", 32); equilibrated() puts
    a saved state (convert.load_equilibrated_npz) with its capacities on
    such a build;
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
import pathlib
import tempfile
import time

import numpy as np
import torch

from ..convert import load_equilibrated_npz, resolve_device
from ..io.ffpmt import read_ffpmt
from ..io.gro import GroFrame, format_gro_frame
from ..io.simpmt import read_sim_params
from ..io.topfile import read_top
from ..md import integrators, velocities
from ..models import pme
from ..ops import neighbors
from ..topology import State, build_system
from ..utils.dtypes import float_dtype

# the MS-EVB3 water force field and topology (the tests' fixture files)
WATER_DECK = pathlib.Path(__file__).resolve().parents[2] / "examples" / \
    "water_msevb"
SIM_PMT = """Simulation Methodology
ensemble           NVE
lj_comb_rule       opls
ms_evb_simulation  {msevb}
Simulation Parameters
n_step             10
n_output           100
n_exclusions       2
temperature        300.0
pressure           1.0
barofreq           3
delta_t            0.0005
real_space_cutoff  4.5
verlet_cutoff      5.5
alpha_sqrt         0.7
pme_grid           {pme_grid}
spline_order       6
n_threads          1
precision          {precision}
{extra}"""
TEMPERATURE = 300.0         # K, build_water's velocities


def water_box(n_water, seed=0, spacing=3.1, jitter=0.05, include_h3o=True):
    """n_water waters and (include_h3o) one hydronium on a jittered cubic
    lattice of `spacing` A, the hydronium in the middle of the list: the
    tests' fixture frame (tests/fixtures.py make_water_box), numpy-seeded,
    equal to it bit for bit."""
    rng = np.random.default_rng(seed)
    n_mol = n_water + (1 if include_h3o else 0)
    n_side = math.ceil(n_mol ** (1.0 / 3.0))
    r, th = 1.012, math.radians(113.24)
    water = np.array([[0.0, 0.0, 0.0],
                      [r * math.sin(th / 2), r * math.cos(th / 2), 0.0],
                      [-r * math.sin(th / 2), r * math.cos(th / 2), 0.0]])
    h3o = np.array([[0.0, 0.0, 0.0]] + [
        [0.94 * math.cos(2 * math.pi * k / 3),
         0.94 * math.sin(2 * math.pi * k / 3), 0.35] for k in range(3)])
    h3o_index = n_mol // 2 if include_h3o else -1
    sites = [(i, j, k) for i in range(n_side) for j in range(n_side)
             for k in range(n_side)][:n_mol]
    names, atoms, first, natom, xyz = [], [], [], [], []
    for m, site in enumerate(sites):
        origin = (np.array(site) + 0.5) * spacing
        origin += rng.uniform(-jitter, jitter, size=3)
        if m == h3o_index:
            geom, name, an = h3o, "h3o", ["O_h3o", "H_h3o", "H_h3o",
                                          "H_h3o"]
        else:
            geom, name, an = water, "h2o", ["OW", "HW", "HW"]
        if jitter:
            geom = geom + rng.normal(scale=jitter, size=geom.shape)
        names.append(name)
        atoms.extend(an)
        first.append(sum(natom))
        natom.append(len(geom))
        xyz.append(geom + origin)
    return GroFrame(title="fixture water box", mol_names=names,
                    mol_first_atom=np.array(first, dtype=np.int32),
                    mol_natom=np.array(natom, dtype=np.int32),
                    atom_names=atoms, xyz=np.concatenate(xyz),
                    box=np.eye(3) * n_side * spacing)


def _write_params(directory, pme_grid, precision, evb_max_states=None,
                  compensated=False, msevb=True):
    """(ff.pmt, top.top, sim.pmt) of the water deck written to
    `directory`."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    for name in ("ff.pmt", "top.top"):
        (d / name).write_text((WATER_DECK / name).read_text())
    extra = ""
    if evb_max_states:
        extra += f"evb_max_states   {evb_max_states}\n"
    if compensated:
        extra += "compensated_sum   yes\n"
    (d / "sim.pmt").write_text(SIM_PMT.format(
        msevb="yes" if msevb else "no", pme_grid=pme_grid,
        precision=precision, extra=extra))
    return tuple(str(d / n) for n in ("ff.pmt", "top.top", "sim.pmt"))


def water_deck(directory, n_water, pme_grid, precision, evb_max_states=None,
               compensated=False, msevb=True, seed=0, spacing=3.1):
    """Write the four input files of the 8-file contract for a water box
    to `directory`: in.gro (water_box, with one hydronium when `msevb`),
    ff.pmt and top.top (the MS-EVB3 water deck), sim.pmt (NVE, cutoff 4.5,
    Verlet 5.5, alpha 0.7, PME `pme_grid`, order 6, `precision`, the
    state cap and Kahan sums when given).  Returns the (gro, ff, top,
    sim) paths.  The .gro keeps 0.001 nm: build_water builds from the
    frame itself."""
    ff, top, sim = _write_params(directory, pme_grid, precision,
                                 evb_max_states, compensated, msevb)
    f = water_box(n_water, seed=seed, spacing=spacing, include_h3o=msevb)
    gro = pathlib.Path(directory) / "in.gro"
    gro.write_text(format_gro_frame(f.title, f.mol_names, f.mol_natom,
                                    f.atom_names, f.xyz, f.box))
    return str(gro), ff, top, sim


def water_system(n_water=26, pme_grid=16, precision="fp32",
                 evb_max_states=None, compensated=False, msevb=True, seed=0,
                 spacing=3.1, device="cuda"):
    """(system, topo, frame, cfg) of water_deck's box on `device` (the
    card unless asked otherwise), the system built from the frame itself
    (not from the .gro's 0.001 nm): the JAX package's fixture deck
    (tests/fixtures.py write_fixture_files and make_water_box)."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        ff, top, sim = _write_params(tmp, pme_grid, precision,
                                     evb_max_states, compensated, msevb)
        cfg = read_sim_params(sim)
        frame = water_box(n_water, seed=seed, spacing=spacing,
                          include_h3o=msevb)
        system, topo = build_system(frame, read_ffpmt(ff), read_top(top),
                                    cfg, device=device)
    return system, topo, frame, cfg


def build_water(n_water=26, pme_grid=16, precision="fp32",
                evb_max_states=None, compensated=False, msevb=True, seed=0,
                spacing=3.1, device="cuda", times=None):
    """(system, cbw, cfg, ms) of water_system's box on `device` (the card
    unless asked otherwise): 300 K velocities (COM momentum removed,
    rescaled to exactly 300 K) from a CPU generator seeded with `seed`,
    the neighbor capacity suggested for the box and the state set up
    (integrators.initial_md_state).  The JAX package's
    __graft_entry__._build but for the velocities' draws.  `times`, a
    dict when given, gets the host seconds of the system's build
    ("system_s") and of the state's set-up ("setup_s")."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    system, topo, frame, cfg = water_system(
        n_water, pme_grid, precision, evb_max_states, compensated, msevb,
        seed, spacing, device)
    f = float_dtype(cfg.precision)
    gen = torch.Generator().manual_seed(seed)
    v = velocities.sample_velocities(gen, system.mass, TEMPERATURE,
                                     velocities.freeze_mask(system, topo))
    box = torch.as_tensor(frame.box, dtype=f, device=device)
    state = State(x=torch.as_tensor(frame.xyz, dtype=f, device=device), v=v,
                  box=box)
    cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt, dtype=f)
    cap = neighbors.suggest_capacity(
        system.n_atoms, float(np.prod(np.diag(frame.box))),
        system.verlet_cutoff)
    t1 = time.perf_counter()
    ms = integrators.initial_md_state(state, topo, system, cbw, cap)
    if times is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.update(system_s=t1 - t0, setup_s=time.perf_counter() - t1)
    return system, cbw, cfg, ms


def equilibrated(build, path):
    """`build` = (system, cbw, cfg, ms) at the saved state of `path`
    (convert.load_equilibrated_npz's layout, cast to the build's dtype):
    the capacities and grids saved beside it replace the build's, and
    the state is set up again (the JAX package's bench.load_equilibrated).
    Returns the new (system, cbw, cfg, ms)."""
    system, cbw, cfg, ms = build
    state, topo, meta = load_equilibrated_npz(path, ms.state.x.device,
                                              ms.state.x.dtype)
    nl = ms.nlist
    capacity, cells = nl.capacity, nl.cells or None
    react_cap, react_cells = nl.react_cap or None, None
    if "capacity" in meta:
        capacity, cells = meta["capacity"], meta["cells"] or None
        react_cap = meta["react_cap"] or None
        react_cells = meta["react_cells"] or None
        system = system.replace(rs_cells=meta["rs_cells"],
                                pme_scap=meta["pme_scap"])
    ms = integrators.initial_md_state(state, topo, system, cbw, capacity,
                                      cells=cells, react_cap=react_cap,
                                      react_cells=react_cells)
    return system, cbw, cfg, ms


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
