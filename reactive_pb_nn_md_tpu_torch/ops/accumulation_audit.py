"""Find the floating-point accumulations of a computation whose bits can
depend on the order of their terms.

On the card torch adds the terms of these ops with atomics (or in an
order that its launch configuration picks), so two runs of one step
from one state may round differently:

  * ``index_put`` / ``_index_put_impl_`` / ``_unsafe_index_put`` with
    ``accumulate=True`` (the backward of ``x[idx]``),
  * ``index_add`` (the backward of ``index_select``),
  * ``scatter_add`` and ``scatter_reduce`` with ``"sum"`` / ``"mean"``
    (the backward of ``gather``),
  * ``embedding_dense_backward``, ``put_`` with ``accumulate=True`` and
    ``index_reduce``.

A site whose every target receives at most one nonzero term is exact in
any order (a zero added to a value, or to a zero, rounds nothing), so
the audit reads each call's index and values and sorts it into
``exact`` or ``order_dependent``.  ``FloatAccumulations`` is a
TorchDispatchMode: everything dispatched inside it, the backward
included, is seen.  The port's own fixed-order segment sum
(ops/kernels/segment_sum.py) is one custom op and is not looked into.
"""

import math
import traceback
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PKG = "reactive_pb_nn_md_tpu_torch"


@dataclass
class Site:
    op: str
    dtype: str
    shape: tuple
    max_terms: int          # most nonzero terms a target received
    where: str              # the port's frames that made the call


@dataclass
class FloatAccumulations(TorchDispatchMode):
    """Record the floating-point accumulating ops dispatched inside.

    ``order_dependent`` lists the calls where some target received two
    or more nonzero terms; ``exact`` the others, by site."""
    order_dependent: list = field(default_factory=list)
    exact: Counter = field(default_factory=Counter)

    def __post_init__(self):
        super().__init__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        terms = _terms(name, args, kwargs)
        if terms is not None:
            values, dtype, shape = terms[1], terms[2], terms[3]
            if values.is_floating_point():
                n = _max_terms(terms[0], values)
                site = Site(name, str(dtype), shape, n, _where())
                if n > 1:
                    self.order_dependent.append(site)
                else:
                    self.exact[(name, site.where)] += 1
        return out

    def summary(self):
        """{(op, where): calls} of the order-dependent sites."""
        return Counter((s.op, s.where) for s in self.order_dependent)


def _where():
    """The port's innermost frames of the current call; in a backward,
    the forward's (anomaly mode records it on the autograd node)."""
    node = torch._C._current_autograd_node()
    if node is not None:
        tb = node.metadata.get("traceback_")
        if tb:
            frames = [ln.strip() for ln in "".join(tb).splitlines()
                      if _PKG in ln and "File" in ln]
            return "backward of " + " <- ".join(_short(f) for f in
                                                frames[::-1][:3])
        return f"backward {node.name()} (no forward trace)"
    frames = [f for f in traceback.extract_stack()
              if _PKG in f.filename and "accumulation_audit" not in
              f.filename]
    return " <- ".join(f"{_rel(f.filename)}:{f.lineno}"
                       for f in frames[::-1][:3])


def _rel(path):
    return path.split(_PKG + "/")[-1]


def _short(line):
    # 'File ".../pkg/models/total.py", line 68, in f' -> models/total.py:68
    try:
        path = line.split('"')[1]
        lineno = line.split("line ")[1].split(",")[0]
        return f"{_rel(path)}:{lineno}"
    except IndexError:
        return line


def _terms(name, args, kwargs):
    """(linear target of every term, its value, dtype, target shape) of an
    accumulating call, else None."""
    def arg(i, key, default=None):
        return args[i] if len(args) > i else kwargs.get(key, default)

    if name in ("index_put", "index_put_", "_index_put_impl",
                "_index_put_impl_", "_unsafe_index_put"):
        if not arg(3, "accumulate", False):
            return None
        return _put_terms(args[0], list(args[1]), args[2])
    if name in ("index_add", "index_add_", "index_reduce",
                "index_reduce_"):
        if name.startswith("index_reduce") and arg(4, "reduce") not in (
                "sum", "mean"):
            return None
        self, dim, index, src = args[0], args[1], args[2], args[3]
        dim = dim % self.ndim
        pos = torch.arange(src.numel(), device=src.device).reshape(src.shape)
        coords = list(torch.unravel_index(pos.reshape(-1), src.shape))
        coords[dim] = index[coords[dim]]
        tgt = torch.zeros_like(coords[0])
        for c, s in zip(coords, self.shape):
            tgt = tgt * s + c
        return tgt, src.reshape(-1), self.dtype, tuple(self.shape)
    if name in ("scatter_add", "scatter_add_", "scatter_reduce",
                "scatter_reduce_", "scatter", "scatter_"):
        if name.startswith("scatter_reduce") and arg(4, "reduce") not in (
                "sum", "mean"):
            return None
        if name in ("scatter", "scatter_") and kwargs.get("reduce") != "add":
            return None
        self, dim, index, src = args[0], args[1], args[2], args[3]
        if not isinstance(src, torch.Tensor):
            return None
        dim = dim % self.ndim
        pos = torch.arange(index.numel(), device=index.device)
        coords = list(torch.unravel_index(pos, index.shape))
        vals = src[tuple(coords)]
        coords[dim] = index.reshape(-1)
        tgt = torch.zeros_like(pos)
        for c, s in zip(coords, self.shape):
            tgt = tgt * s + c
        return tgt, vals, self.dtype, tuple(self.shape)
    if name == "embedding_dense_backward":
        grad, indices, num = args[0], args[1], args[2]
        d = grad.shape[-1]
        tgt = (indices.reshape(-1, 1) * d
               + torch.arange(d, device=grad.device)).reshape(-1)
        return tgt, grad.reshape(-1), grad.dtype, (num, d)
    if name in ("put", "put_"):
        if not arg(3, "accumulate", False):
            return None
        return args[1].reshape(-1), args[2].reshape(-1), args[0].dtype, \
            tuple(args[0].shape)
    return None


def _put_terms(self, indices, values):
    """_terms of self[indices] += values: the index tensors adjacent
    (None for a whole axis before, after or between none of them)."""
    pos = [k for k, t in enumerate(indices) if t is not None]
    if any(t.dtype == torch.bool for t in indices if t is not None) or \
            pos != list(range(pos[0], pos[-1] + 1)):
        # a form the step does not use: count every value a term of one
        # target, so the call is reported
        return (torch.zeros(values.numel(), dtype=torch.int64,
                            device=values.device), values.reshape(-1),
                self.dtype, tuple(self.shape))
    k, j = pos[0], len(pos)
    lead, mid, trail = (self.shape[:k], self.shape[k:k + j],
                        self.shape[k + j:])
    b = torch.broadcast_shapes(*(indices[i].shape for i in pos))
    lin = torch.zeros(b, dtype=torch.int64, device=self.device)
    for i, s in zip(pos, mid):
        lin = lin * s + indices[i].expand(b)
    A, T = math.prod(lead), math.prod(trail)
    tgt = ((torch.arange(A, device=self.device)[:, None, None]
            * math.prod(mid) + lin.reshape(1, -1, 1)) * T
           + torch.arange(T, device=self.device)[None, None, :])
    vals = values.expand(tuple(lead) + tuple(b) + tuple(trail))
    return tgt.reshape(-1), vals.reshape(-1), self.dtype, tuple(self.shape)


def _max_terms(tgt, vals):
    """The most nonzero values any one target receives."""
    nz = vals != 0
    if not bool(nz.any()):
        return 0
    t = tgt[nz]
    _, counts = torch.unique(t, return_counts=True)
    return int(counts.max())
