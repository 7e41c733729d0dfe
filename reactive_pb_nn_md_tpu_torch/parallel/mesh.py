"""Ranks and the mesh (counterpart of make_mesh in
reactive_pb_nn_md_tpu/parallel/ensemble.py, a 2-axis ("replica",
"atoms") layout of jax.devices()).

Here the mesh lays out the ranks of an initialised torch.distributed
world: rank = replica index * sp + atoms index.  The ranks of one
replica index share one replica's step (the "atoms" axis, parallel/
shard.py); the ranks of one atoms index hold disjoint blocks of the
replicas (the "replica" axis, parallel/ensemble.py).  Each rank has one
device of its own.

Backends are named, never switched: a card is `nccl` on cuda:<local
rank>, the CPU is `gloo` and is taken only when the caller asks for it
(device="cpu").  A world comes from

  * launch(fn, n, ...): n ranks started here with torch.multiprocessing
    (spawn), their rendezvous through a store in a temporary file (no
    TCP port, so several launches run side by side), a time limit on the
    rendezvous, on every collective (gloo) and on the join; when one
    rank fails or the limit passes, the others are killed and the error
    is raised: a hung rank becomes an error, never a wait;
  * torchrun --nproc-per-node N: init_from_env() reads the environment
    torchrun sets.
"""

import datetime
import os
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .shard import AtomShard

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device):
    """The backend of a device type: nccl for "cuda", gloo for "cpu"."""
    kind = torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"no backend for device {device!r}: "
                         f"{sorted(BACKENDS)}")
    return BACKENDS[kind]


def local_rank():
    """This process's rank on its host (LOCAL_RANK, which torchrun and
    launch() set; else the global rank)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _init(backend, init_method, rank, world_size, timeout):
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout),
                            **kw)


def init_from_env(device="cuda", timeout=300):
    """Join the world torchrun describes (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT, LOCAL_RANK), with device's backend."""
    _init(backend_for(device), "env://", int(os.environ["RANK"]),
          int(os.environ["WORLD_SIZE"]), timeout)


@dataclass
class Mesh:
    """dp x sp ranks: this rank's indices, device and the groups of its
    two axes (None where the axis is the whole world)."""
    dp: int
    sp: int
    rank: int
    device: torch.device
    backend: str
    replica_group: object
    atoms_group: object

    @property
    def shape(self):
        return {"replica": self.dp, "atoms": self.sp}

    @property
    def replica_index(self):
        return self.rank // self.sp

    @property
    def atoms_index(self):
        return self.rank % self.sp

    def atom_shard(self):
        """The AtomShard of this rank on the "atoms" axis."""
        return AtomShard(self.atoms_group, self.atoms_index, self.sp)


def make_mesh(n_devices=None, sp=None, device="cuda"):
    """The (dp, sp) mesh of the initialised world's ranks.  n_devices:
    the world size (None: whatever it is); sp: ranks a replica's step is
    shared over (None: 2 when the world is even and larger than 1, else
    1, as the JAX package).  device "cuda" takes cuda:<local rank> and
    needs an nccl world; "cpu" needs a gloo world.  Every rank calls it,
    in the same order as its other group creations.  Each group's
    communicator is warmed with one collective here, before any step is
    captured."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "world: start the ranks with parallel.mesh.launch "
                           "or torchrun (then init_from_env)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"{n_devices} devices asked for, the world has {n} "
                         f"ranks")
    if sp is None:
        sp = 2 if n % 2 == 0 and n > 1 else 1
    if sp < 1 or n % sp:
        raise ValueError(f"sp = {sp} does not divide the {n} ranks")
    dp = n // sp
    backend = dist.get_backend()
    want = backend_for(device)
    if backend != want:
        raise ValueError(f"device {device!r} takes the {want} backend; the "
                         f"world was initialised with {backend}")
    dev = (torch.device("cuda", local_rank()) if want == "nccl"
           else torch.device("cpu"))
    rank = dist.get_rank()
    atoms_group = replica_group = None
    # every rank creates every group, in one order (an axis of one rank
    # is a group of one)
    if sp < n:
        for d in range(dp):
            g = dist.new_group(list(range(d * sp, (d + 1) * sp)))
            if d == rank // sp:
                atoms_group = g
    if dp < n:
        for s in range(sp):
            g = dist.new_group(list(range(s, n, sp)))
            if s == rank % sp:
                replica_group = g
    for g in (None, atoms_group, replica_group):
        dist.all_reduce(torch.zeros(1, device=dev), group=g)
    return Mesh(dp=dp, sp=sp, rank=rank, device=dev, backend=backend,
                replica_group=replica_group, atoms_group=atoms_group)


def _rank_main(fn, rank, n, backend, store, out_dir, timeout, threads,
               args):
    os.environ["LOCAL_RANK"] = str(rank)
    if threads:
        torch.set_num_threads(threads)
    try:
        _init(backend, "file://" + store, rank, n, timeout)
        res = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pt"), "wb") as f:
            torch.save(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def launch(fn, n, *args, device="cuda", timeout=300, threads=1):
    """fn(*args) on n ranks of a new world (device's backend, one rank a
    device; the CPU's gloo only when asked with device="cpu"): the list
    of the ranks' return values (torch.save-able, read back on the
    CPU).  Each rank runs in a spawned process with
    `threads` intra-op threads (0: torch's default).  fn must be
    importable by name (a module-level function).  `timeout` seconds
    bound the rendezvous, every gloo collective and the whole run: past
    it, or when a rank fails, every rank still running is killed and
    RuntimeError (TimeoutError) names the failure."""
    backend = backend_for(device)
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks need {n} cards; "
                           f"{torch.cuda.device_count()} visible")
    out_dir = tempfile.mkdtemp(prefix="ranks_")
    store = os.path.join(out_dir, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, backend, store, out_dir, timeout,
                               threads, args))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                _kill(procs)
                # a rank whose peer died fails too: every traceback written
                raise RuntimeError(
                    f"ranks {failed} of {n} failed (exit codes "
                    f"{[codes[r] for r in failed]}):\n"
                    + "\n".join(_error(out_dir, r) for r in range(n)
                                if r in failed or os.path.exists(
                                    os.path.join(out_dir, f"rank{r}.err"))))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                _kill(procs)
                raise TimeoutError(
                    f"{n} ranks did not finish within {timeout} s (ranks "
                    f"{[r for r, c in enumerate(codes) if c is None]} "
                    f"still running)")
            time.sleep(0.02)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]
    finally:
        _kill(procs)
        shutil.rmtree(out_dir, ignore_errors=True)


def _kill(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        if p.pid is not None:
            p.join(5)


def _error(out_dir, rank):
    try:
        with open(os.path.join(out_dir, f"rank{rank}.err")) as f:
            return f"rank {rank}:\n" + f.read()
    except OSError:
        return f"rank {rank}: no traceback (it died before writing one)"
