"""Parameter presets (counterpart of reactive_pb_nn_md_tpu/run/presets.py;
so far only soften_for_hops, which the PB-NN production path runs
through).  A preset returns a new System and leaves its argument as it
was; hand it to Simulation.mutate_system."""

import dataclasses


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
