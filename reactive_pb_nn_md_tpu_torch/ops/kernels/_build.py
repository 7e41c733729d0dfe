"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into ONE shared library with a plain
C interface (no PyTorch headers, so the build takes seconds) loaded with
``ctypes``.  The build happens on first use, into
``build/kernels/<hash of sources and flags>/`` beside the package, and is
redone when a source changes.  Each C entry point launches on the stream
it is given, allocates nothing, does not synchronize, and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.

``launches`` counts kernel launches by kernel name (A, A', A'', B1, B2,
C1, C2, D1, D2, E, and F: one a call of its three kernels; "F order"
for its order alone); each wrapper adds one where it launches its
kernel, and nowhere else (a CUDA graph's replay adds what its capture counted:
md/graphs.py).  A batched launch (a replica batch of the vmapped step:
the kernels' ops' batching rules, `stride` / `front` below) counts once
for all its replicas.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from collections import Counter
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--expt-relaxed-constexpr"]

# namespace of the kernels' torch.library custom ops (one an entry point:
# each has the plain version for CPU tensors, the launch for CUDA ones and
# a batching rule, so a replica batch vmapped over the MD step launches
# each kernel once for all replicas)
OPS = "rpnm_torch"

launches = Counter()
# collectives a step shared over ranks issued (parallel/shard.py), by
# name; kept here so md/graphs.py moves them across a capture and its
# replays as it moves the launches
collectives = Counter()
build_info = {}            # seconds, path, nvcc output of the last build
_lib = None
_functions = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc) to build the "
                           "kernels in csrc/")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _load():
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libkernels.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp_dir = tempfile.mkdtemp(dir=out_dir)
        try:
            log = _compile(srcs, Path(tmp_dir))
            os.replace(os.path.join(tmp_dir, "libkernels.so"), so)  # atomic
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)
    lib = ctypes.CDLL(str(so))
    lib.kernels_error_string.argtypes = [ctypes.c_int]
    lib.kernels_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, path=str(so),
                      log=log)
    return lib


def _compile(srcs, tmp_dir):
    """One nvcc per source, all at once, then one link; returns the
    compilers' output (register and spill counts)."""
    procs = []
    for src in srcs:
        out = open(tmp_dir / (src.stem + ".log"), "w+")
        cmd = ([_nvcc()] + NVCC_FLAGS
               + ["-c", "-o", str(tmp_dir / (src.stem + ".o")), str(src)])
        procs.append((src, out, subprocess.Popen(cmd, stdout=out,
                                                 stderr=subprocess.STDOUT)))
    log, failed = "", []
    for src, out, proc in procs:
        rc = proc.wait()
        out.seek(0)
        log += f"== {src.name}\n" + out.read()
        out.close()
        if rc != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    cmd = ([_nvcc(), "-shared", "-o", str(tmp_dir / "libkernels.so")]
           + [str(tmp_dir / (s.stem + ".o")) for s in srcs])
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"link failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    return log


def function(name, n_ptr, n_int=0, n_float=0):
    """The C entry point `name`: n_ptr pointers (the stream last among
    them), then n_int ints, then n_float doubles."""
    if name not in _functions:
        f = getattr(library(), name)
        f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                      + [ctypes.c_double] * n_float)
        f.restype = ctypes.c_int
        _functions[name] = f
    return _functions[name]


def check(err, name):
    if err != 0:
        msg = library().kernels_error_string(err).decode()
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error "
                           f"{err} ({msg})")


def stream_ptr(t):
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def suffix(dtype):
    """C entry-point suffix of a float dtype."""
    import torch
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"kernels take float32 or float64, not {dtype}")


def require(t, dtype, shape=None, name="tensor"):
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and shape)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def stride(t, ndim, nb):
    """Elements between two replicas' copies of `t` in a batched launch of
    nb replicas: 0 when t has the ndim of one replica's array (the batch
    shares it), else t[0].numel() (t stacked on a leading axis of nb)."""
    if t.ndim == ndim:
        return 0
    if t.ndim != ndim + 1 or t.shape[0] != nb:
        raise ValueError(f"a batched launch of {nb} replicas takes an array "
                         f"of {ndim} axes or {nb} stacked on a leading "
                         f"axis, not shape {tuple(t.shape)}")
    return t[0].numel()


def batch_strides(args, specs, nb):
    """Checks of a launch's per-replica arguments `args` against `specs`,
    one (shape of one replica's array, dtype, name) each; with nb, a
    batched launch of nb replicas, each argument stacked on a leading
    axis of nb or shared by the batch.  Returns their strides between
    replicas (stride(); 0 without nb)."""
    strides = []
    for t, (shape, dtype, name) in zip(args, specs, strict=True):
        require(t, dtype, None, name)
        if unbatched(t, len(shape)) != tuple(shape) or (
                not nb and t.ndim != len(shape)):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        strides.append(stride(t, len(shape), nb) if nb else 0)
    return strides


def unbatched(t, ndim):
    """The shape of one replica's `t` (t of ndim axes, or ndim + 1 with the
    replicas first)."""
    return tuple(t.shape[t.ndim - ndim:])


def front(args, in_dims):
    """The tensors `args` of a batching rule, each contiguous with its
    batch axis first; those the batch shares (in_dims None) unbatched."""
    return [a.movedim(d, 0).contiguous() if d is not None
            else a.contiguous() for a, d in zip(args, in_dims)]


def alike(args, in_dims, groups, nb):
    """A batching rule's `args` (front() order) with every group of
    indices in `groups` batched alike (a batched launch takes one stride
    a group): a shared member of a group whose others are batched is
    stacked nb times."""
    args = list(args)
    for group in groups:
        if len({in_dims[k] is None for k in group}) > 1:
            for k in group:
                if in_dims[k] is None:
                    args[k] = args[k].expand(nb, *args[k].shape).contiguous()
    return args


def replica(args, in_dims, i):
    """Replica i's arguments of a batching rule (front() order)."""
    return [a[i] if d is not None else a for a, d in zip(args, in_dims)]
