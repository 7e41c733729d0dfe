"""PB-NN, coupling function type 3, in the port against the JAX package,
fp64 on the CPU, on the 26-water + H3O+ fixture of tests/test_nn_coupling.py
(seed 9; the (OW, O_h3o, H_h3o) triple switched to 3):

  * the JAX type-3 system carried across (torch_bridge.jax_tree ->
    convert.from_numpy_tree) gives the JAX adiabatic energy; without its
    MLP it raises (the converter used to drop the MLP: A = 0);
  * apply_mlp, 3 and 5 inputs: values 1e-13, input gradients 1e-12;
  * the adiabatic energy (1e-12), forces (1e-11 of max|F|), couplings
    and dE/d(MLP) (1e-10), n_env 0 and 2;
  * 20 pretrain_geometric steps from the JAX package's initial MLP and
    samples: the MLP within 1e-9 of optax's;
  * one finetune_adiabatic energy step and the force-matching loss
    gradient on 2 rattled frames: 1e-9;
  * soften_for_hops equal to the JAX package's;
  * a type-3 step attached through Simulation.mutate_system makes no
    host synchronization.

The JAX side runs compiled with its optimizations off (as
torch_bridge.jax_compiled does), each quantity from one trace.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fixtures import make_water_box, write_fixture_files
from torch_bridge import driver_deck, jax_tree
from test_torch_scan import _HostSyncs, _HostTensors
from reactive_pb_nn_md_tpu.io.ffpmt import read_ffpmt
from reactive_pb_nn_md_tpu.io.simpmt import read_sim_params
from reactive_pb_nn_md_tpu.io.topfile import read_top
from reactive_pb_nn_md_tpu.topology import build_system as jax_build
from reactive_pb_nn_md_tpu.ops import neighbors as jax_nb
from reactive_pb_nn_md_tpu.evb import hamiltonian as jax_ham
from reactive_pb_nn_md_tpu.evb.enumerate import molecule_com as jax_com
from reactive_pb_nn_md_tpu.ops import ground_state as jax_gs
from reactive_pb_nn_md_tpu.nn import coupling_mlp as jax_mlp
from reactive_pb_nn_md_tpu.nn import train as jax_train
from reactive_pb_nn_md_tpu.run import presets as jax_presets
from reactive_pb_nn_md_tpu_torch.convert import from_numpy_tree, mlp_from_numpy
from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
from reactive_pb_nn_md_tpu_torch.md import integrators
from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
from reactive_pb_nn_md_tpu_torch.models import pme
from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp, train
from reactive_pb_nn_md_tpu_torch.ops import neighbors
from reactive_pb_nn_md_tpu_torch.run import presets
from reactive_pb_nn_md_tpu_torch.topology import check_nn_coupling

TRIPLE = ("OW", "O_h3o", "H_h3o")
W_F = 0.3                  # the force-matching weight of the tests


@contextlib.contextmanager
def _unoptimized():
    prev = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _mlp_leaves(nn):
    """The MLP's arrays in mlp_tensors' order."""
    return [nn["vconst"], *nn["w"], *nn["b"]]


@pytest.fixture(scope="module")
def deck(tmp_path_factory):
    """The JAX package's analytic system of the fixture, its frame and a
    rattled copy with their JAX inputs, the reciprocal weights, the
    triple's index."""
    tmp = tmp_path_factory.mktemp("pbnn")
    ff_p, top_p, sim_p = write_fixture_files(tmp, msevb="yes")
    frame = make_water_box(26, include_h3o=True, seed=9)
    jsys, jtopo = jax_build(frame, read_ffpmt(ff_p), read_top(top_p),
                            read_sim_params(sim_p))
    names = jsys.ff.atype_names
    box = jnp.asarray(frame.box)
    cap = jax_nb.suggest_capacity(jsys.n_atoms,
                                  float(np.prod(np.diag(frame.box))),
                                  jsys.verlet_cutoff)
    # the reciprocal weights of both sides: the port's (held to the JAX
    # package's by tests/test_torch_pme.py)
    tbox = torch.tensor(frame.box)
    tcbw = pme.cb_half(tbox, jsys.pme_grid, jsys.spline_order,
                       jsys.alpha_sqrt)
    # the frame and a rattled copy (numpy seed 3, 0.05 A), each with its
    # JAX neighbor data and diabat topologies (which the couplings do not
    # change), from one compilation
    rng = np.random.default_rng(3)
    xs = [frame.xyz, frame.xyz + rng.normal(0.0, 0.05, frame.xyz.shape)]
    with _unoptimized():
        diabats = jax.jit(lambda xx, fi: _jax_diabats(xx, box, jtopo, jsys,
                                                      fi))
        frames = []
        for xf in xs:
            xf = jnp.asarray(xf)
            nl = jax_nb.build_neighbor_list(xf, box, jsys.verlet_cutoff, cap)
            _, j, m = jax_nb.neighbor_pairs(nl)
            frames.append((xf, nl.full_idx, j, m) + diabats(xf, nl.full_idx))
    return dict(jsys=jsys, jtopo=jtopo, xs=xs, frames=frames, box=box,
                cap=cap, cbw=jnp.asarray(tcbw.numpy()), tbox=tbox,
                tcbw=tcbw,
                triple=tuple(names.index(n) for n in TRIPLE))


def _jax_type3(deck, nn):
    jsys = deck["jsys"]
    return jsys.replace(evb=jsys.evb.replace(
        cpl_func=jsys.evb.cpl_func.at[deck["triple"]].set(3),
        nn_params=nn))


def _jax_diabats(x, box, topo, system, full_idx):
    """The steps of the JAX package's nn/train.py adiabatic_energy that do
    not depend on x differentiably or on the MLP: the molecule COMs and
    the diabat topologies."""
    com = jax_com(x, topo, system.mass, box)
    dset = jax_ham.enumerate_diabats(x, box, topo, system,
                                     full_idx=full_idx, com=com)
    return com, jax_ham.build_diabat_topologies(topo, dset, system)


def _jax_energy(x, box, topo, system, pairs, cbw, full_idx, com, batch):
    """The rest of that adiabatic_energy, c^T H c with c fixed, with
    (H, n_states) as aux."""
    H, _, _, _ = jax_ham.assemble_hamiltonian(
        x, box, batch, system, pairs, cbw, topo.charge, topo, full_idx,
        com0=com)
    _, c = jax_gs.ground_state_eigh(jax.lax.stop_gradient(H))
    c = jax.lax.stop_gradient(c)
    return c @ H @ c, (H, batch.dset.n_states)


def _type3_ref(deck, n_env):
    """The JAX type-3 system with a (8, 8) MLP of n_env inputs and, on
    the fixture's frame, its energy, force, H, n_states and dE/d(MLP);
    the port's system and topology carried across, the frame's tensors.

    n_env 2 also holds the rattled frame, targets e_ref, f_ref (numpy
    seed 4) and, over both frames, the energy loss and its
    gradient, the force-matching loss (weight W_F) and its gradient, and
    optax's Adam step (1e-3) on the energy loss with the loss after it:
    one trace."""
    nn = jax_mlp.init_mlp(jax.random.PRNGKey(n_env), hidden=(8, 8),
                          vconst=-97.0, dtype=jnp.float64, n_env=n_env)
    jsys3 = _jax_type3(deck, nn)
    box, topo, cbw = deck["box"], deck["jtopo"], deck["cbw"]
    xs = deck["xs"][:1 + bool(n_env)]
    frames = jax.tree_util.tree_map(lambda *a: jnp.stack(a),
                                    *deck["frames"][:len(xs)])
    x0 = xs[0]
    out = dict(n_env=n_env, jsys3=jsys3, xs=xs)

    def energy(x, p, fi, j, m, com, batch):
        s = jsys3.replace(evb=jsys3.evb.replace(nn_params=p))
        i = jnp.arange(x.shape[0])[:, None]
        return _jax_energy(x, box, topo, s, (i, j, m), cbw, fi, com, batch)

    def frame(p, *f):
        (e, aux), gx = jax.value_and_grad(energy, has_aux=True)(f[0], p,
                                                                 *f[1:])
        return (e, -gx), aux

    with _unoptimized():
        if not n_env:
            f0 = jax.tree_util.tree_map(lambda a: a[0], frames)
            (e, (H, n)), (gx, gp) = jax.jit(lambda p: jax.value_and_grad(
                energy, argnums=(0, 1), has_aux=True)(f0[0], p, *f0[1:]))(nn)
            f = -gx
        else:
            rng = np.random.default_rng(4)
            e_ref = rng.normal(600.0, 5.0, 2)
            f_ref = rng.normal(0.0, 50.0, (2,) + x0.shape)
            n3, F, N = 3.0 * x0.shape[0], len(xs), x0.shape[0]

            def both(p):
                (ea, fa), back, aux = jax.vjp(
                    lambda q: jax.vmap(frame, in_axes=(None,) + (0,) * 6)(
                        q, *frames), p, has_aux=True)
                de = 2.0 * (ea - e_ref) / F
                df = W_F * n3 * 2.0 * (fa - f_ref) / (F * N)
                one0 = jnp.zeros_like(ea).at[0].set(1.0)
                zf = jnp.zeros_like(fa)
                # cotangents: E of frame 0; the energy loss; force matching
                g = jax.vmap(back)((jnp.stack([one0, de, de]),
                                    jnp.stack([zf, zf, df])))[0]
                loss_e = jnp.mean((ea - e_ref) ** 2)
                loss_f = loss_e + W_F * n3 * jnp.mean(
                    jnp.sum((fa - f_ref) ** 2, -1))
                return ea[0], fa[0], jax.tree_util.tree_map(
                    lambda a: a[0], aux), g, loss_e, loss_f

            step = jax.jit(both)
            e, f, (H, n), g, loss_e, loss_f = step(nn)
            gp, ge, gf = (jax.tree_util.tree_map(lambda a: a[k], g)
                          for k in range(3))
            opt = optax.adam(1e-3)
            upd, _ = opt.update(ge, opt.init(nn))
            nn1 = optax.apply_updates(nn, upd)
            out.update(e_ref=e_ref, f_ref=f_ref, loss_e=float(loss_e),
                       loss_f=float(loss_f), gf=gf, nn1=nn1,
                       loss_e1=float(step(nn1)[4]))
    tsys, ttopo = from_numpy_tree(jax_tree(jsys3, topo), device="cpu")
    tbox, tcbw = deck["tbox"], deck["tcbw"]
    tx = [torch.tensor(x) for x in xs]
    tnl = [neighbors.build_neighbor_list(x, tbox, tsys.verlet_cutoff,
                                         deck["cap"]) for x in tx]
    out.update(e=float(e), force=np.asarray(f), H=np.asarray(H), n=int(n),
               grad=gp, tsys=tsys, ttopo=ttopo, x=tx[0], xs_t=tx,
               box=tbox, nl=tnl[0], nls=tnl, cbw=tcbw)
    return out


@pytest.fixture(scope="module")
def refs(deck):
    """_type3_ref by n_env, each made once."""
    cache = {}

    def get(n_env):
        if n_env not in cache:
            cache[n_env] = _type3_ref(deck, n_env)
        return cache[n_env]

    return get


@pytest.fixture(params=[0, 2], ids=["n_env0", "n_env2"])
def type3(request, refs):
    return refs(request.param)


def _port_eval(t, system=None):
    return ham.adiabatic_energy_force(
        t["x"], t["box"], t["ttopo"], system or t["tsys"],
        neighbors.neighbor_pairs(t["nl"]), t["cbw"], t["nl"].full_idx)[0]


def test_type3_system_carries_across_with_its_mlp(deck, type3):
    """Fails where the converter drops evb["nn_params"] (A = 0)."""
    assert type3["tsys"].evb.nn_params is not None
    assert int((type3["tsys"].evb.cpl_func == 3).sum()) == 1
    res = _port_eval(type3)
    np.testing.assert_allclose(float(res.energy), type3["e"], rtol=1e-12)
    tree = jax_tree(type3["jsys3"], deck["jtopo"])
    tree["evb"] = dict(tree["evb"], nn_params=None)
    with pytest.raises(ValueError, match="type 3"):
        from_numpy_tree(tree, device="cpu")


@pytest.mark.parametrize("n_env", [0, 2])
def test_apply_mlp_matches_jax(n_env):
    rng = np.random.default_rng(n_env)
    nn = jax_mlp.init_mlp(jax.random.PRNGKey(7), hidden=(16, 16),
                          vconst=-100.0, dtype=jnp.float64, n_env=n_env)
    q2 = rng.uniform(0.0, 0.6, 64)
    roo = rng.uniform(2.2, 3.2, 64)
    env = rng.normal(0.0, 0.3, (64, n_env)) if n_env else None

    def one(a, b, e):
        return jax_mlp.apply_mlp(nn, a, b, e)

    args = (jnp.asarray(q2), jnp.asarray(roo),
            None if env is None else jnp.asarray(env))
    batched = jax.vmap(one, in_axes=(0, 0, None if env is None else 0))
    ref, gref = jax.jit(lambda *a: (batched(*a), jax.grad(
        lambda *b: jnp.sum(batched(*b)),
        argnums=(0, 1) + ((2,) if n_env else ()))(*a)))(*args)
    tnn = mlp_from_numpy(nn, device="cpu")
    ins = [torch.tensor(v, requires_grad=True) for v in (q2, roo, env)
           if v is not None]
    out = coupling_mlp.apply_mlp(tnn, ins[0], ins[1],
                                 ins[2] if n_env else None)
    assert _rel(out.detach().numpy(), ref) <= 1e-13
    grads = torch.autograd.grad(out.sum(), ins)
    for g, gr in zip(grads, gref):
        assert _rel(g.numpy(), gr) <= 1e-12


def test_type3_energy_forces_couplings_match_jax(type3):
    res = _port_eval(type3)
    n = int(res.n_states)
    assert n == type3["n"] and n >= 2
    np.testing.assert_allclose(float(res.energy), type3["e"], rtol=1e-12)
    F = type3["force"]
    assert np.abs(res.force.numpy() - F).max() <= 1e-11 * np.abs(F).max()
    # the couplings (off-diagonal elements), some of them the MLP's
    H_j, H_p = type3["H"][:n, :n], res.hamiltonian.numpy()[:n, :n]
    off = ~np.eye(n, dtype=bool)
    assert _rel(H_p[off], H_j[off]) <= 1e-12
    assert np.abs(H_j[off]).max() > 1.0
    # the analytic surface differs: the MLP's elements are in H
    H_a = _port_eval(type3, type3["tsys"].replace(evb=dataclasses.replace(
        type3["tsys"].evb, cpl_func=torch.where(
            type3["tsys"].evb.cpl_func == 3, 1, type3["tsys"].evb.cpl_func),
        nn_params=None))).hamiltonian.numpy()[:n, :n]
    assert np.abs(H_a[off] - H_p[off]).max() > 1e-3


def test_energy_gradient_wrt_mlp_matches_jax(type3):
    t = type3
    nn = coupling_mlp.copy_mlp(t["tsys"].evb.nn_params, True)
    system = train.with_mlp(t["tsys"], nn)
    e = train.adiabatic_energy(t["x"], t["box"], t["ttopo"], system,
                               neighbors.neighbor_pairs(t["nl"]), t["cbw"],
                               t["nl"].full_idx)
    np.testing.assert_allclose(float(e.detach()), t["e"], rtol=1e-12)
    grads = torch.autograd.grad(e, coupling_mlp.mlp_tensors(nn))
    for g, gr in zip(grads, _mlp_leaves(t["grad"])):
        assert _rel(g.numpy(), gr) <= 1e-10


def test_pretrain_matches_optax(deck):
    row = jnp.asarray(deck["jsys"].evb.cpl_params[deck["triple"]])
    key = jax.random.PRNGKey(1)
    nn_j, rmse_j = jax_train.pretrain_geometric(row, key, steps=20,
                                                n_samples=256, n_env=2)
    # the samples and initial MLP that the JAX function drew inside
    kd, ki = jax.random.split(key)
    q2, roo = jax_train.sample_geometries(kd, 256, dtype=jnp.float64)
    init = jax_mlp.init_mlp(ki, vconst=float(row[0]), dtype=jnp.float64,
                            n_env=2)
    nn_p, rmse_p = train.pretrain_geometric(
        np.asarray(row), steps=20, n_env=2, device="cpu",
        samples=(np.array(q2), np.array(roo)),
        init=mlp_from_numpy(init, device="cpu"))
    for a, b in zip(coupling_mlp.mlp_tensors(nn_p), _mlp_leaves(nn_j)):
        assert _rel(a.numpy(), b) <= 1e-9
    np.testing.assert_allclose(rmse_p, rmse_j, rtol=1e-9)
    assert float(nn_p["vconst"]) == float(row[0])


def test_finetune_step_and_force_matching_gradient_match_jax(refs):
    t = refs(2)
    tsys, fr = t["tsys"], ([], [], [])
    for nl in t["nls"]:
        _, j, m = neighbors.neighbor_pairs(nl)
        for lst, v in zip(fr, (nl.full_idx, j, m)):
            lst.append(v)
    args = (tsys, t["ttopo"], t["box"], t["cbw"], t["xs_t"]) + fr
    e_ref = torch.tensor(t["e_ref"])
    nn1, e0, e1 = train.finetune_adiabatic(tsys.evb.nn_params, *args, e_ref,
                                           steps=1)
    np.testing.assert_allclose([e0, e1],
                               np.sqrt([t["loss_e"], t["loss_e1"]]),
                               rtol=1e-9)
    for a, b in zip(coupling_mlp.mlp_tensors(nn1), _mlp_leaves(t["nn1"])):
        assert _rel(a.numpy(), b) <= 1e-9

    p = coupling_mlp.copy_mlp(tsys.evb.nn_params, True)
    e, f = train.make_frame_energy_force_fn(*args[:4])(p, *args[4:])
    n3 = 3.0 * f.shape[1]
    loss = (torch.mean((e - e_ref) ** 2) + W_F * n3 * torch.mean(
        torch.sum((f - torch.tensor(t["f_ref"])) ** 2, -1)))
    np.testing.assert_allclose(float(loss.detach()), t["loss_f"], rtol=1e-9)
    g = torch.autograd.grad(loss, coupling_mlp.mlp_tensors(p))
    for a, b in zip(g, _mlp_leaves(t["gf"])):
        assert _rel(a.numpy(), b) <= 1e-9


def test_soften_for_hops_matches_jax(deck):
    kw = dict(coupling_scale=1.7, da_scale=0.6, pa_scale=0.4,
              c12_scale=0.8)
    ref = jax_presets.soften_for_hops(deck["jsys"], **kw)
    tsys, _ = from_numpy_tree(jax_tree(deck["jsys"], deck["jtopo"]),
                              device="cpu")
    out = presets.soften_for_hops(tsys, **kw)
    for name in ("cpl_params", "da_params", "pa_params"):
        np.testing.assert_array_equal(getattr(out.evb, name).numpy(),
                                      np.asarray(getattr(ref.evb, name)))
    np.testing.assert_array_equal(out.ff.vdw_params.numpy(),
                                  np.asarray(ref.ff.vdw_params))
    # the argument is left as it was
    np.testing.assert_array_equal(tsys.evb.cpl_params.numpy(),
                                  np.asarray(deck["jsys"].evb.cpl_params))


def test_type3_step_through_mutate_system_makes_no_host_sync(tmp_path):
    sim = Simulation(*driver_deck(tmp_path, n_water=26, msevb="yes"),
                     device="cpu")
    old = sim.system
    names = old.ff.atype_names
    triple = tuple(names.index(n) for n in TRIPLE)
    nn = coupling_mlp.init_mlp(torch.Generator().manual_seed(0),
                               hidden=(8, 8), vconst=-97.0,
                               dtype=torch.float64, device="cpu", n_env=2)

    with pytest.raises(ValueError, match="type 3"):
        sim.mutate_system(lambda s: coupling_mlp.attach(s, None))
    assert sim.system is old
    e_analytic = float(sim.ms.potential)
    sim.mutate_system(lambda s: coupling_mlp.attach(s, nn))
    assert int((sim.system.evb.cpl_func == 3).sum()) == 1
    assert int(sim.system.evb.cpl_func[triple]) == 3
    assert sim.system is not old and sim.system.evb.nn_params is nn
    assert float(sim.ms.potential) != e_analytic
    # the same object back is a new System all the same
    before = sim.system
    sim.mutate_system(lambda s: s)
    assert sim.system is not before
    check_nn_coupling(sim.system.evb)

    s = sim.system
    args = (s, sim.cbw, 0.0005, "NVE", 1.0, 300.0, sim.gen, "full")
    ms, _ = integrators.scan_step(sim.ms, *args)
    syncs = _HostSyncs()
    with _HostTensors(syncs.hits), syncs:
        integrators.scan_step(ms, *args)
    bad = [(n, "".join(st[-6:])) for n, st in syncs.hits
           if not any("ground_state_eigh" in fr for fr in st)]
    assert not bad, bad[0]
