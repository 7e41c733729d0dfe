"""The JAX side of tests/test_torch_pbnn_scripts.py (a) to (c), run in a
process of its own so that its compilation overlaps the rest of that
file's fixture (jax only: no torch, no port module).

transfer_reference(mlp) builds the JAX scripts/pbnn_transfer.py's
26-water box and 2 rattled frames (numpy seed 3), then compiles, with
the JAX package's optimizations off, one frame's adiabatic energy
(nn/train.py adiabatic_energy: what make_frame_energy_fn vmaps over
frames) and its gradient with respect to the MLP, the system an
argument, and returns as numpy: the frames; the labels (the analytic
couplings) and the energies with the (OW, O_h3o, H_h3o) triple switched
to `mlp` (a numpy MLP in the JAX layout); the MLP after optax.adam's
first update (lr 1e-3, its defaults; written out in numpy) of the train
frame's loss (E - label)^2 (finetune_heldout's split 0.75 of 2 frames
trains on the first); and the energies with that MLP.
"""

import importlib.util
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_FRAMES = 2
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-3)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def transfer_reference(mlp):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_disable_most_optimizations", True)
    import jax.numpy as jnp
    from reactive_pb_nn_md_tpu.nn import train as jnt

    jpt = _load("jax_pbnn_transfer", "scripts/pbnn_transfer.py")
    system, topo, x0, box = jpt.build_water(26, 16, seed=9)
    frames = jpt.make_frames(system, topo, x0, box, N_FRAMES, 0.05, 3)
    xs, fi, pj, pm, cbw = frames
    tri = jpt.water_triple(system)
    nn = jax.tree_util.tree_map(jnp.asarray, mlp)

    def with_mlp(p, switched):
        evb = system.evb.replace(nn_params=p)
        if switched:
            evb = evb.replace(cpl_func=system.evb.cpl_func.at[tri].set(3))
        return system.replace(evb=evb)

    def energy(s, p, k):
        i = jnp.arange(xs.shape[1], dtype=jnp.int32)[:, None]
        e = jnt.adiabatic_energy(
            xs[k], box, topo, s.replace(evb=s.evb.replace(nn_params=p)),
            (i, pj[k], pm[k]), cbw, fi[k])
        return e, e

    f = jax.jit(jax.value_and_grad(energy, argnums=1, has_aux=True))

    def energies(p, switched):
        out = [f(with_mlp(p, switched), p, k) for k in range(N_FRAMES)]
        return np.array([float(e) for (e, _), _ in out]), out[0][1]

    e_ref, _ = energies(nn, False)
    e_nn, g = energies(nn, True)
    a = ADAM

    def adam(p, g):
        g = 2.0 * (e_nn[0] - e_ref[0]) * np.asarray(g)
        m, v = (1 - a["b1"]) * g, (1 - a["b2"]) * g * g
        return np.asarray(p) - a["lr"] * (m / (1 - a["b1"])) / (
            np.sqrt(v / (1 - a["b2"])) + a["eps"])

    nn1 = jax.tree_util.tree_map(adam, nn, g)
    e_nn1, _ = energies(jax.tree_util.tree_map(jnp.asarray, nn1), True)
    return dict(frames=tuple(np.asarray(t) for t in frames), e_ref=e_ref,
                e_nn=e_nn, e_nn1=e_nn1, nn1=nn1)
