"""Rank functions of tests/test_torch_distributed.py, run by
reactive_pb_nn_md_tpu_torch.parallel.mesh.launch on gloo ranks.  They
live apart from the test module so that a rank imports the port alone
(no jax), and return CPU tensors and plain values."""

import dataclasses
import time

import torch
import torch.distributed as dist

from reactive_pb_nn_md_tpu_torch.md import integrators
from reactive_pb_nn_md_tpu_torch.parallel import dryrun, ensemble, shard

DT = 0.0005
N_REPLICAS, NVT_STEPS, FRICTION, SEED = 4, 3, 5.0, 5


def _step_numbers(ms):
    return dict(potential=ms.potential, force=ms.force, x=ms.state.x,
                v=ms.state.v, breakdown={
                    k: getattr(ms.breakdown, k)
                    for k in ("total", "elec", "vdw", "bond", "angle",
                              "dihedral")},
                overflow=ms.overflow)


def _block_numbers(scan, block, diag):
    return dict(x=[m.state.x for m in block.states],
                v=[m.state.v for m in block.states],
                potential=[m.potential for m in block.states],
                generators=list(block.generators),
                diag=dataclasses.asdict(diag), n_regrows=scan.n_regrows,
                caps=scan.caps, regrows=list(scan.regrows),
                evb_max_states=scan.system.evb_max_states)


def replica_run(mesh, system, cbw, ms, ensemble_name):
    """The 4-replica batch's chunk (1 NVE step, or NVT_STEPS NVT steps) on
    `mesh` (None: one rank, the plain ReplicaScan)."""
    n = 1 if ensemble_name == "NVE" else NVT_STEPS
    block = ensemble.stack_replicas(ms, N_REPLICAS, seed=SEED, mesh=mesh)
    scan = ensemble.make_replica_scan(system, cbw, DT, ensemble_name, n,
                                      friction=FRICTION, mesh=mesh)
    out, diag = scan(block)
    return _block_numbers(scan, out, diag)


def _flag_first_chunk(rank_to_flag):
    """Make md_scan report a neighbor-list overflow in this rank's first
    chunk when it is `rank_to_flag` (None: on every rank): the flag one
    rank alone raises."""
    orig = integrators.md_scan
    calls = [0]

    def md_scan(*a, **k):
        out, d = orig(*a, **k)
        if rank_to_flag in (None, dist.get_rank()) and calls[0] == 0:
            d = dataclasses.replace(
                d, neighbor_overflow=torch.ones_like(d.neighbor_overflow))
        calls[0] += 1
        return out, d

    return md_scan


def world(n):
    """Every check of one world of n gloo ranks (the test module's
    docstring)."""
    system, cbw, cfg, ms = dryrun.fixture("cpu")
    res = {}
    mesh_sp = ensemble.make_mesh(n, sp=n, device="cpu")
    sh = ensemble.atom_sharding(mesh_sp)
    step = ensemble.make_atom_sharded_step(system, cbw, DT, "NVE", mesh_sp)
    out = []
    counts = shard.collective_summary(lambda: out.append(step(ms)))
    res["step"] = _step_numbers(out[0])
    res["collectives"] = counts
    res["mesh_sp"] = dict(shape=mesh_sp.shape, rank=mesh_sp.rank,
                          atoms_index=mesh_sp.atoms_index,
                          replica_index=mesh_sp.replica_index,
                          atoms=sh.atoms(system.n_atoms),
                          mols=sh.mols(system.n_mole))
    if n == 2:
        mesh_dp = ensemble.make_mesh(n, sp=1, device="cpu")
        res["mesh_dp"] = dict(shape=mesh_dp.shape,
                              replica_index=mesh_dp.replica_index,
                              block=list(ensemble.replica_sharding(
                                  mesh_dp, N_REPLICAS)))
        for ens in ("NVE", "NVT"):
            res[ens] = replica_run(mesh_dp, system, cbw, ms, ens)
        orig = integrators.md_scan
        integrators.md_scan = _flag_first_chunk(1)
        try:
            t0 = time.perf_counter()
            res["flagged"] = replica_run(mesh_dp, system, cbw, ms, "NVT")
            res["flagged"]["s"] = time.perf_counter() - t0
            # the batch shared over both ranks (a 1 x 2 mesh): the
            # regrow's set-up is shared as its steps are
            integrators.md_scan = _flag_first_chunk(None)
            got = []
            colls = shard.collective_summary(lambda: got.append(
                replica_run(mesh_sp, system, cbw, ms, "NVT")))
            res["flagged_sp"] = dict(got[0], collectives=colls["by_name"])
        finally:
            integrators.md_scan = orig
    return res


def fail_on_rank_one():
    """Rank 1 raises; rank 0 waits in a collective that never completes
    (the launcher must kill it)."""
    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.all_reduce(torch.zeros(1))
    return 0


def hang_on_rank_one():
    """Rank 1 sleeps past any limit; rank 0 returns."""
    if dist.get_rank() == 1:
        time.sleep(3600)
    return 0
