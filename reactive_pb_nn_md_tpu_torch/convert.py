"""State and parameters carried across from the JAX package's formats.

``from_numpy_tree`` takes the system as nested dicts of numpy arrays keyed
by container and field name -- the layout ``topology.build_numpy_tree``
produces, and the one a test gets by flattening the JAX package's
``System`` / ``Topology`` -- so this module never imports jax.
``load_equilibrated_npz`` reads the flattened ``(State, Topology)`` pytree
files under ``benchdata/``, and ``save_state_npz`` writes them.

Every entry point places its tensors on the card unless the caller asks
for another device; without a card, ``device="cuda"`` raises.
"""

import dataclasses

import numpy as np
import torch

from .topology import (ForceField, MolTypeTable, EvbParams, Topology,
                       System, State)


def resolve_device(device):
    """torch.device of `device`; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return device


def cli_device(device):
    """resolve_device for a command line's --device: without a card, exit
    with the flag to pass."""
    try:
        return resolve_device(device)
    except RuntimeError:
        raise SystemExit("CUDA is not available; pass --device cpu to run "
                         "on the CPU") from None


def _tensor(v, device, dtype):
    """numpy leaf -> tensor: floats in `dtype`, ints as int64, bools kept."""
    a = np.asarray(v)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int64), device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def mlp_from_numpy(tree, device="cuda", dtype=torch.float64):
    """A PB-NN coupling MLP (nn/coupling_mlp.py) from the JAX package's
    layout ``{"vconst": scalar, "w": [(n_in, n_out) arrays], "b":
    [(n_out,) arrays]}`` (numpy or anything np.asarray reads): the same
    layout, ``h @ w + b``, in `dtype` on `device`."""
    device = resolve_device(device)
    return {"vconst": _tensor(tree["vconst"], device, dtype),
            "w": [_tensor(w, device, dtype) for w in tree["w"]],
            "b": [_tensor(b, device, dtype) for b in tree["b"]]}


def bias_from_numpy(bias, device="cuda", dtype=torch.float64):
    """The port's restraint (md/bias.HarmonicBias, or a tuple of them) from
    the JAX package's HarmonicBias or ladder, or a tuple of them (atoms,
    k and center anything np.asarray reads): atoms as int64, k and center
    in `dtype`, on `device`.  A ladder's (W, 3) atoms and (W,) k / center
    keep their shapes (parallel/ensemble.window_bias takes one window)."""
    from .md.bias import HarmonicBias
    if isinstance(bias, tuple):
        return tuple(bias_from_numpy(b, device, dtype) for b in bias)
    device = resolve_device(device)
    return HarmonicBias(atoms=_tensor(bias.atoms, device, dtype),
                        k=_tensor(bias.k, device, dtype),
                        center=_tensor(bias.center, device, dtype),
                        cv_type=int(bias.cv_type))


def _container(cls, leaves, device, dtype):
    kw = {}
    for f in dataclasses.fields(cls):
        v = leaves.get(f.name)
        if f.name in ("atype_names", "mtype_names"):
            kw[f.name] = tuple(v or ())
        elif f.name == "nn_params":
            kw[f.name] = None if v is None else mlp_from_numpy(v, device,
                                                               dtype)
        else:
            kw[f.name] = None if v is None else _tensor(v, device, dtype)
    return cls(**kw)


def from_numpy_tree(tree, device="cuda", dtype=torch.float64):
    """(System, Topology) on `device` from the nested numpy layout:
    ``{"ff": {...}, "mt": {...}, "evb": {...} or None, "system": {mass,
    static config...}, "topo": {...}}``, the EVB tables with their PB-NN
    MLP (``evb["nn_params"]``, mlp_from_numpy's layout) where they have
    one.  Keys the port has no field for are ignored; an EVB table whose
    cpl_func holds a 3 without an MLP raises (topology.check_nn_coupling)."""
    device = resolve_device(device)
    ff = _container(ForceField, tree["ff"], device, dtype)
    mt = _container(MolTypeTable, tree["mt"], device, dtype)
    evb = (None if tree.get("evb") is None
           else _container(EvbParams, tree["evb"], device, dtype))
    s = tree["system"]
    static = {f.name: s[f.name] for f in dataclasses.fields(System)
              if f.name not in ("ff", "mt", "evb", "mass", "device")
              and f.name in s}
    static["rs_cells"] = tuple(int(c) for c in static.get("rs_cells", ()))
    static["pme_scap"] = int(static.get("pme_scap", 0))
    system = System(ff=ff, mt=mt, evb=evb,
                    mass=_tensor(s["mass"], device, dtype), device=device,
                    **static)
    topo = _container(Topology, tree["topo"], device, dtype)
    return system, topo


# leaf order of the flattened (State, Topology) pytree in benchdata/*.npz
_STATE_LEAVES = ("x", "v", "box", "key", "step")
_TOPO_LEAVES = ("mol_mtype", "mol_natom", "mol_atoms", "atom_mol",
                "atom_slot", "atom_type", "charge", "hydronium_mol")


def load_equilibrated_npz(path, device="cuda", dtype=torch.float64):
    """(State, Topology, meta) from an equilibrated-state file.

    Leaves l0..l4 are the State (x, v, box, PRNG key, step; the key is not
    used: NVE), l5..l12 the Topology; ``meta`` holds the saved capacities
    (``capacity``, ``react_cap``, ``rs_cells``, ...)."""
    data = np.load(path)
    n = len(_STATE_LEAVES) + len(_TOPO_LEAVES)
    if len([k for k in data.files if k.startswith("l")]) != n:
        raise ValueError(f"{path}: expected {n} (State, Topology) leaves")
    leaf = {name: data[f"l{i}"]
            for i, name in enumerate(_STATE_LEAVES + _TOPO_LEAVES)}
    device = resolve_device(device)
    state = State(x=_tensor(leaf["x"], device, dtype),
                  v=_tensor(leaf["v"], device, dtype),
                  box=_tensor(leaf["box"], device, dtype),
                  step=int(leaf["step"]))
    topo = Topology(**{k: _tensor(leaf[k], device, dtype)
                       for k in _TOPO_LEAVES})
    meta = {k[len("meta_"):]: data[k] for k in data.files
            if k.startswith("meta_")}
    for k in ("capacity", "react_cap", "pme_scap"):
        if k in meta:
            meta[k] = int(meta[k])
    for k in ("cells", "react_cells", "rs_cells"):
        if k in meta:
            meta[k] = tuple(int(c) for c in meta[k])
    return state, topo, meta


def save_state_npz(path, ms, system=None, seed=0):
    """Write the MDState `ms`'s (State, Topology) as the JAX package's
    flattened pytree: leaves l0..l12 (x, v, box; the PRNG key as the JAX
    shape, jax.random.PRNGKey(seed)'s (0, seed) uint32 pair, which an NVE
    state never reads; the step as int32; the Topology with ints as
    int32), and with `system` the capacities the state was run at
    (meta_capacity, meta_cells, meta_react_cap, meta_react_cells,
    meta_rs_cells, meta_pme_scap).  Without `system` the file holds the
    13 leaves only, the layout the JAX drift study's loader asserts."""
    st, topo = ms.state, ms.topo

    def host(t):
        a = t.detach().cpu().numpy()
        return a.astype(np.int32) if np.issubdtype(a.dtype, np.integer) \
            else a

    leaves = [host(st.x), host(st.v), host(st.box),
              np.array([0, seed], np.uint32), np.asarray(st.step, np.int32)]
    leaves += [host(getattr(topo, k)) for k in _TOPO_LEAVES]
    payload = {f"l{i}": v for i, v in enumerate(leaves)}
    if system is not None:
        nl = ms.nlist
        payload.update(
            meta_capacity=np.asarray(nl.capacity, np.int64),
            meta_cells=np.asarray(nl.cells or (), np.int64),
            meta_react_cap=np.asarray(nl.react_cap or 0, np.int64),
            meta_react_cells=np.asarray(nl.react_cells or (), np.int64),
            meta_rs_cells=np.asarray(system.rs_cells or (), np.int64),
            meta_pme_scap=np.asarray(system.pme_scap, np.int64))
    np.savez(path, **payload)
