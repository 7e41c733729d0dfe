"""The acid box geometry of the port's run/presets.py against the JAX
package's (numpy on both sides, so equal bit for bit): the three molecule
templates and make_acid_frame, two seeds, with and without CH3SO3-
anions.  No JAX compilation."""

import numpy as np
import pytest

from reactive_pb_nn_md_tpu.run import presets as jax_presets
from reactive_pb_nn_md_tpu_torch.io.gro import GroFrame
from reactive_pb_nn_md_tpu_torch.run import presets


@pytest.mark.parametrize("name", ["so3h_geometry", "so3_geometry",
                                  "water_geometry"])
def test_geometry_equals_jax(name):
    got, ref = getattr(presets, name)(), getattr(jax_presets, name)()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert np.array_equal(got, ref)


def test_templates_equal_jax():
    assert presets._TEMPLATES.keys() == jax_presets._TEMPLATES.keys()
    for k, (fn, names) in presets._TEMPLATES.items():
        jfn, jnames = jax_presets._TEMPLATES[k]
        assert names == jnames
        assert np.array_equal(fn(), jfn())
        assert len(names) == fn().shape[0]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n_water,n_so3", [(40, 0), (60, 3)])
def test_make_acid_frame_equals_jax(seed, n_water, n_so3):
    got = presets.make_acid_frame(n_water=n_water, n_so3=n_so3, seed=seed)
    ref = jax_presets.make_acid_frame(n_water=n_water, n_so3=n_so3,
                                      seed=seed)
    assert isinstance(got, GroFrame)
    assert got.title == ref.title
    assert got.mol_names == ref.mol_names
    assert got.atom_names == ref.atom_names
    for f in ("mol_first_atom", "mol_natom", "xyz", "box"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    assert got.velocities is None and ref.velocities is None
    # 1 so3h first, then the anions, then the waters
    assert got.mol_names == (["so3h"] + ["so3"] * n_so3
                             + ["h2o"] * n_water)
    assert got.n_atoms == 6 + 5 * n_so3 + 3 * n_water


def test_make_acid_frame_seeds_differ():
    a = presets.make_acid_frame(n_water=40, seed=0)
    b = presets.make_acid_frame(n_water=40, seed=1)
    assert not np.array_equal(a.xyz, b.xyz)

