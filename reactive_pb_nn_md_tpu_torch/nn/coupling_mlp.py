"""PB-NN diabatic coupling: the neural geometric factor of coupling
function type 3 (counterpart of reactive_pb_nn_md_tpu/nn/coupling_mlp.py).

A small MLP over symmetry-invariant features of the proton-transfer
geometry is the geometric factor of the element H_ij = (Vconst + Vex) A,

    A_nn = A_MAX * sigmoid(MLP([q^2, R_OO, exp(-R_OO) [, cn_d, cn_a]]))

with tanh hidden layers.  A first layer of 3 rows is geometry-only; more
rows take the environment features of models/coupling._env_features
(the donor's and acceptor's smooth first-shell coordination numbers):
the parameter shape is the configuration.

The parameters are a plain dict of tensors, the JAX package's layout:
``{"vconst": () tensor, "w": [(n_in, n_out) tensors], "b": [(n_out,)
tensors]}``, applied as ``h @ w + b``, so weights trained by either
package carry across by a copy (convert.mlp_from_numpy).  The same
tensors serve torch.optim (as leaves that require grad) and a captured
step, which reads them at their addresses: update them in place, never
rebind them in a System that a graph was captured for
(md/simulation.py Simulation.mutate_system attaches them, with attach).
"""

import dataclasses
import math

import torch

# upper bound of the sigmoid output head: the analytic surfaces peak at
# ~1.25 over the admissible (q2, R_OO) range
A_MAX = 2.5


def init_mlp(generator, hidden=(16, 16), vconst=-100.0, dtype=torch.float32,
             device="cuda", n_env=0):
    """He-normal weights drawn from `generator` (on its own device, then
    moved to `device`), zero biases; n_env > 0 adds that many
    environment-feature inputs (2: the coordination numbers)."""
    from ..convert import resolve_device
    device = resolve_device(device)
    sizes = (3 + n_env,) + tuple(hidden) + (1,)
    params = {"vconst": torch.tensor(vconst, dtype=dtype, device=device),
              "w": [], "b": []}
    for i in range(len(sizes) - 1):
        w = torch.randn((sizes[i], sizes[i + 1]), generator=generator,
                        dtype=dtype, device=generator.device)
        params["w"].append((w * math.sqrt(2.0 / sizes[i])).to(device))
        params["b"].append(torch.zeros(sizes[i + 1], dtype=dtype,
                                       device=device))
    return params


def mlp_tensors(params):
    """The parameter tensors in a fixed order: vconst, the weights, the
    biases."""
    return [params["vconst"], *params["w"], *params["b"]]


def copy_mlp(params, requires_grad=False):
    """A copy of the MLP whose tensors are fresh leaves (that require grad
    when asked: the parameters of an optimizer)."""
    return {"vconst": params["vconst"].detach().clone().requires_grad_(
                requires_grad),
            "w": [w.detach().clone().requires_grad_(requires_grad)
                  for w in params["w"]],
            "b": [b.detach().clone().requires_grad_(requires_grad)
                  for b in params["b"]]}


def apply_mlp(params, q2, roo, env=None):
    """A_nn of a batch: q2, roo (B,), env (B, n_env) or None -> (B,).

    When the MLP takes environment features and none are given (as in
    pretraining on the geometric surface alone) they are zero, the
    'mean-field solvation' point of their centred encoding.  The
    parameters are used in the inputs' dtype."""
    w, b = params["w"], params["b"]
    n_in = w[0].shape[0]
    h = torch.stack([q2, roo, torch.exp(-roo)], dim=-1)
    if n_in > 3:
        if env is None:
            env = torch.zeros(h.shape[:-1] + (n_in - 3,), dtype=h.dtype,
                              device=h.device)
        h = torch.cat([h, env.to(h.dtype)], dim=-1)
    for wi, bi in zip(w[:-1], b[:-1]):
        h = torch.tanh(h @ wi.to(h.dtype) + bi.to(h.dtype))
    out = h @ w[-1].to(h.dtype) + b[-1].to(h.dtype)
    # bounded head: A in (0, A_MAX), positive as an overlap envelope is
    # (the sign lives in Vconst); it also caps |dA/d(raw)| at A_MAX / 4
    return A_MAX * torch.sigmoid(out[..., 0])


def attach(system, nn_params, triple=("OW", "O_h3o", "H_h3o")):
    """A new System whose coupling `triple` (atom-type names: donor heavy
    atom, acceptor heavy atom, proton) is the MLP's: its cpl_func set to
    3 and nn_params attached in one construction of the EvbParams (for
    Simulation.mutate_system; bench.py's run_bench_nn switches the water
    triple)."""
    names = system.ff.atype_names
    cf = system.evb.cpl_func.clone()
    cf[tuple(names.index(n) for n in triple)] = 3
    return system.replace(evb=dataclasses.replace(
        system.evb, cpl_func=cf, nn_params=nn_params))
