#!/usr/bin/env python3
"""Chip smoke test: drives the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order, one line each (any failure raises, exit code != 0):
  1. device: the card's name and nvidia-smi's name / power limit; no CUDA
     device -> exit 1 before anything else;
  2. build: every kernel under reactive_pb_nn_md_tpu_torch/csrc/ with nvcc;
  3. kernels A, B1, B2, C1, C2 against their plain PyTorch versions at the
     flagship shapes (the 649-atom equilibrated state, K = 32, order 6,
     S = 48 and 80, U = 4 S), in fp64 and fp32, with CUDA-event times;
  4. one full force evaluation in fp64, CUDA (kernels) against CPU (plain);
  5. the CLI on examples/water_msevb/ for 50 steps in fp64 (the deck as
     shipped) and fp32 -- the main path; every kernel must launch;
  6. NVE from the equilibrated state, 200 steps in fp64 (|Etot(200) -
     Etot(0)| <= 5 kJ/mol) and in fp32 (finite; drift reported, not
     bounded); the largest excursion is reported for both.
The line before the last is nvidia-smi's name and power limit, the one
before it the per-kernel JSON; the last line is the result JSON.
"""

import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
DECK = ROOT / "examples" / "water_msevb"
EQ_STATE = ROOT / "benchdata" / "eq_flagship_s80.npz"

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "A": ("reactive_pb_nn_md_tpu_torch/csrc/realspace_pair.cu",
          "reactive_pb_nn_md_tpu/ops/pallas/realspace_pair.py:601"),
    "B1": ("reactive_pb_nn_md_tpu_torch/csrc/pme_spread.cu",
           "reactive_pb_nn_md_tpu/ops/pallas/pme_spread.py:121"),
    "B2": ("reactive_pb_nn_md_tpu_torch/csrc/pme_spread.cu",
           "reactive_pb_nn_md_tpu/ops/pallas/pme_spread.py:145"),
    "C1": ("reactive_pb_nn_md_tpu_torch/csrc/recip_perstate.cu",
           "reactive_pb_nn_md_tpu/ops/pallas/recip_perstate.py:239"),
    "C2": ("reactive_pb_nn_md_tpu_torch/csrc/recip_perstate.cu",
           "reactive_pb_nn_md_tpu/ops/pallas/recip_perstate.py:272"),
}

# Tolerances (|got - ref| <= atol + rtol |ref|, atol relative to max|ref|):
#  fp64: 1e-10 relative for every kernel.
#  fp32: kernel A as tests/test_pallas_realspace.py (energies rtol 1e-6 /
#  atol 5e-3, gradients rtol 1e-5 / atol 1e-4).  B and C sum 216 (B) or
#  U x Mh (C) terms in another order (atomics, tiles) than the plain
#  version: B1 takes rtol 1e-5, C1 tests/test_recip_perstate.py's forward
#  bound (5e-5), and the gradients, which cancel heavily (spline-derivative
#  rows, dG contractions), rtol 2e-3 with atol 2e-5 of their scale -- that
#  file's gradient bound.
TOL64 = dict(rtol=1e-10, scale_atol=1e-10)


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    """Raise (exit code != 0) unless `ok`."""
    if not ok:
        raise AssertionError(msg)


def close(got, ref, rtol, atol=0.0, scale_atol=0.0):
    """(max |got - ref|, that over max |ref|, ok) under
    |got - ref| <= atol + scale_atol max|ref| + rtol |ref|."""
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    bound = atol + scale_atol * scale + rtol * ref.abs()
    return (float(err.max()), float(err.max()) / max(scale, 1e-300),
            bool((err <= bound).all()))


def cuda_ms(fn, reps=25):
    """Median milliseconds of fn() over `reps` runs, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    times.sort()
    return times[len(times) // 2]


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def flagship(device, dtype):
    """(system, state, topo, meta, cbw, cfg) of the equilibrated flagship
    box: the deck's system with the state and capacities of the npz."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md.simulation import load_deck
    from reactive_pb_nn_md_tpu_torch.convert import load_equilibrated_npz
    from reactive_pb_nn_md_tpu_torch.models import pme
    cfg, _, system, _ = load_deck(
        DECK / "in.gro", DECK / "ff.pmt", DECK / "top.top", DECK / "sim.pmt",
        device, precision="fp64" if dtype == torch.float64 else "fp32")
    state, topo, meta = load_equilibrated_npz(EQ_STATE, device, dtype)
    system = system.replace(rs_cells=meta["rs_cells"])
    cbw = pme.cb_half(state.box, system.pme_grid, system.spline_order,
                      system.alpha_sqrt, dtype=dtype)
    return system, state, topo, meta, cbw, cfg


def phase_kernels(results):
    """Phase 3: every kernel against its plain version at flagship shapes."""
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import (
        realspace_pair as rsp, pme_spread as sp, recip_perstate as rp)
    from reactive_pb_nn_md_tpu_torch.models import pme
    from reactive_pb_nn_md_tpu_torch.utils import pbc
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        fp64 = dtype == torch.float64
        system, state, topo, _, cbw, _ = flagship(dev, dtype)
        x, box = state.x, state.box
        K, order = system.pme_grid, system.spline_order
        out = results.setdefault(tag, {})

        # ---- A: pair rows (energies + analytic gradients)
        cells = system.rs_cells
        slot, over = rsp.bin_atoms(x, box, cells, system.real_space_cutoff)
        check(not bool(over), "kernel A cell capacity overflows")
        cm = rsp.pack_cells(x, topo.charge, topo.atom_type, topo.atom_mol,
                            slot, cells)
        tabs = rsp.build_tabs(system, dtype)
        args = (cm, tabs, cells)
        kw = dict(rcut=system.real_space_cutoff, alpha=system.alpha_sqrt,
                  has_sapt=system.has_sapt)
        got = rsp.pair_rows_cuda(*args, box, **kw)
        ref = rsp.pair_rows_plain(*args, torch.diagonal(box), **kw)
        if fp64:
            err, rel, ok = close(got, ref, **TOL64)
        else:
            e1, r1, ok1 = close(got[:, 6:].sum(0), ref[:, 6:].sum(0), 1e-6,
                                5e-3)
            e2, r2, ok2 = close(got[:, :6], ref[:, :6], 1e-5, 1e-4)
            err, rel, ok = max(e1, e2), max(r1, r2), ok1 and ok2
        out["A"] = dict(max_abs_err=err, max_rel_err=rel, ok=ok,
                        ms=cuda_ms(lambda: rsp.pair_rows_cuda(*args, box,
                                                              **kw)),
                        plain_ms=cuda_ms(lambda: rsp.pair_rows_plain(
                            *args, torch.diagonal(box), **kw)))

        # ---- B1 / B2: spread and gather
        w, dw, nearpt = sp.spline_setup(x, box, K, order)
        q = topo.charge.contiguous()
        got = sp.spread_cuda(w, nearpt, q, K)
        ref = sp.spread_plain(w, nearpt, q, K)
        err, rel, ok = close(got, ref, **(TOL64 if fp64 else
                                          dict(rtol=1e-5, scale_atol=1e-6)))
        out["B1"] = dict(max_abs_err=err, max_rel_err=rel, ok=ok,
                         ms=cuda_ms(lambda: sp.spread_cuda(w, nearpt, q, K)),
                         plain_ms=cuda_ms(lambda: sp.spread_plain(
                             w, nearpt, q, K)))
        gQ = torch.tensor(rng.standard_normal(K ** 3), dtype=dtype,
                          device=dev)
        recip = pbc.recip_vectors(box).contiguous()
        gargs = (gQ, w, dw, nearpt, q, recip, K)
        got = torch.cat([t.reshape(-1) for t in sp.gather_cuda(*gargs)])
        ref = torch.cat([t.reshape(-1) for t in sp.gather_plain(*gargs)])
        err, rel, ok = close(got, ref, **(TOL64 if fp64 else
                                          dict(rtol=2e-3, scale_atol=2e-5)))
        out["B2"] = dict(max_abs_err=err, max_rel_err=rel, ok=ok,
                         ms=cuda_ms(lambda: sp.gather_cuda(*gargs)),
                         plain_ms=cuda_ms(lambda: sp.gather_plain(*gargs)))

        # ---- C1 / C2 at S = 48 and 80, U = 4 S, on the real spectra
        Q0 = pme.charge_grid(x, q, box, K, order)
        F0 = torch.fft.rfftn(Q0)
        Mh = K * (K // 2 + 1)
        for S in (48, 80):
            U = 4 * S
            (Ar, Ai), (Br, Bi), (Cr, Ci) = pme.structure_axis_factors(
                x[:U], box, K, order)
            BCr = (Br[:, :, None] * Cr[:, None, :]
                   - Bi[:, :, None] * Ci[:, None, :]).reshape(U, Mh)
            BCi = (Br[:, :, None] * Ci[:, None, :]
                   + Bi[:, :, None] * Cr[:, None, :]).reshape(U, Mh)
            dq = torch.tensor(rng.standard_normal((S, U)) * 0.3,
                              dtype=dtype, device=dev)
            ins = [t.contiguous() for t in (
                dq, Ar.T, Ai.T, BCr, BCi, F0.real.reshape(K, Mh),
                F0.imag.reshape(K, Mh), cbw.reshape(K, Mh))]
            gbar = torch.tensor(rng.standard_normal(S), dtype=dtype,
                                device=dev)
            e_k = rp.perstate_fwd_cuda(*ins)
            e_p = rp.perstate_plain(*ins)
            err, rel, ok = close(e_k, e_p, **(TOL64 if fp64 else
                                              dict(rtol=5e-5,
                                                   scale_atol=5e-5)))
            g_k = rp.perstate_bwd_cuda(gbar, *ins)
            leaves = [t.clone().requires_grad_(i < 7)
                      for i, t in enumerate(ins)]
            g_p = torch.autograd.grad(
                (rp.perstate_plain(*leaves) * gbar).sum(), leaves[:7])
            errs = [close(a, b, **(TOL64 if fp64 else
                                   dict(rtol=2e-3, scale_atol=2e-5)))
                    for a, b in zip(g_k, g_p)]

            def plain_fb():
                lv = [t.clone().requires_grad_(i < 7)
                      for i, t in enumerate(ins)]
                torch.autograd.grad((rp.perstate_plain(*lv) * gbar).sum(),
                                    lv[:7])

            c1_plain = cuda_ms(lambda: rp.perstate_plain(*ins))
            key = "" if S == 80 else f"_S{S}"
            out["C1" + key] = dict(
                max_abs_err=err, max_rel_err=rel, ok=ok,
                ms=cuda_ms(lambda: rp.perstate_fwd_cuda(*ins)),
                plain_ms=c1_plain)
            out["C2" + key] = dict(
                max_abs_err=max(e for e, _, _ in errs),
                max_rel_err=max(r for _, r, _ in errs),
                ok=all(o for _, _, o in errs),
                ms=cuda_ms(lambda: rp.perstate_bwd_cuda(gbar, *ins)),
                plain_ms=cuda_ms(plain_fb) - c1_plain)
        torch.cuda.synchronize()
        for name, r in out.items():
            log(f"  {tag} {name:7s} max_abs_err {r['max_abs_err']:.3e} "
                f"max_rel_err {r['max_rel_err']:.3e} ok {r['ok']}  kernel "
                f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms")
            check(r["ok"], f"kernel {name} ({tag}) disagrees with its plain "
                           f"version: max abs error {r['max_abs_err']:.3e}")


def phase_forces():
    """Phase 4: evaluate_forces fp64, CUDA (kernels) vs CPU (plain)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.ops import neighbors
    from reactive_pb_nn_md_tpu_torch.md import integrators
    res = {}
    for dev in ("cuda", "cpu"):
        system, state, topo, meta, cbw, _ = flagship(torch.device(dev),
                                                     torch.float64)
        nl = neighbors.build_neighbor_list(
            state.x, state.box, system.verlet_cutoff, meta["capacity"],
            react_cutoff=system.evb_reactive_pair_distance
            + system.verlet_cutoff - system.real_space_cutoff,
            react_cap=meta["react_cap"], build_half=False)
        check(not bool(nl.overflow), "neighbor-list capacity overflows")
        fe = integrators.evaluate_forces(state.x, state.box, topo, system,
                                         nl, cbw)
        res[dev] = fe
    g, c = res["cuda"], res["cpu"]
    check(int(g.n_states) == int(c.n_states), "state counts differ")
    dE = abs(float(g.potential) - float(c.potential))
    ev_g, ev_c = g.eigenvector.cpu(), c.eigenvector
    dc = min(float((ev_g - ev_c).abs().max()),
             float((ev_g + ev_c).abs().max()))
    fmax = float(c.force.abs().max())
    dF = float((g.force.cpu() - c.force).abs().max())
    log(f"  n_states {int(c.n_states)}  |dE| {dE:.3e} kJ/mol  |dc| {dc:.3e}"
        f"  max|dF| {dF:.3e} (max|F| {fmax:.1f})")
    check(dE <= 1e-8 * abs(float(c.potential)) and dc <= 1e-8
          and dF <= 1e-8 * fmax, "CUDA and CPU force evaluations disagree")


def phase_cli(tmp):
    """Phase 5: the CLI on the flagship deck, fp64 then fp32, 50 steps."""
    from reactive_pb_nn_md_tpu_torch.run import cli
    for prec in ("fp64", "fp32"):
        d = tmp / prec
        shutil.copytree(DECK, d)
        sim = d / "sim.pmt"
        sim.write_text(sim.read_text().replace("precision          fp64",
                                               f"precision          {prec}"))
        files = [str(d / n) for n in ("in.gro", "ff.pmt", "top.top",
                                      "sim.pmt", "traj.gro", "run.log",
                                      "hops.log", "A.log")]
        cli.main(files + ["--device", "cuda", "--steps", "50"])
        text = (d / "run.log").read_text()
        check(f"precision {prec}" in text, f"the log does not say {prec}")
        etot = [float(ln.split()[5]) for ln in text.splitlines()
                if ln.startswith(" KE")]
        check(len(etot) == 6 and all(math.isfinite(e) for e in etot),
              f"{prec}: log energies {etot}")
        frames = (d / "traj.gro").read_text().count("step ")
        check(frames == 6, f"{prec}: {frames} trajectory frames, not 6")
        rate = float(text.strip().splitlines()[-1].split("(")[1].split()[0])
        log(f"  {prec}: 50 steps, {rate:.2f} steps/s, Etot {etot[0]:.3f} "
            f"-> {etot[-1]:.3f}, {frames} frames")


def phase_nve():
    """Phase 6: 200 NVE steps from the equilibrated state."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md import integrators
    out = {}
    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        system, state, topo, meta, cbw, cfg = flagship(torch.device("cuda"),
                                                       dtype)
        ms = integrators.initial_md_state(state, topo, system, cbw,
                                          meta["capacity"], meta["react_cap"])
        etot = [float(ms.kinetic + ms.potential)]
        hops = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            ms = integrators.md_step(ms, system, cbw, cfg.delta_t)
            hops += ms.hopped
            etot.append(float(ms.kinetic + ms.potential))
        torch.cuda.synchronize()
        rate = 200 / (time.perf_counter() - t0)
        check(all(math.isfinite(e) for e in etot), f"{tag}: non-finite Etot")
        out[tag] = dict(dEtot=etot[-1] - etot[0],
                        max_abs_dEtot=max(abs(e - etot[0]) for e in etot),
                        steps_per_s=rate, hops=hops)
        log(f"  {tag}: Etot(200) - Etot(0) {etot[-1] - etot[0]:+.3f} "
            f"kJ/mol, max|Etot - Etot0| {out[tag]['max_abs_dEtot']:.3f}, "
            f"{rate:.2f} steps/s, {hops} hops")
    check(abs(out["fp64"]["dEtot"]) <= 5.0, "fp64 NVE drift exceeds 5 kJ/mol")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    if not (ROOT / "reactive_pb_nn_md_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[1 device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    _build.library()
    log(f"[2 build] {len(list(_build.CSRC.glob('*.cu')))} sources built in "
        f"{_build.build_info['seconds']:.1f} s -> {_build.build_info['path']}")
    for ln in _build.build_info["log"].splitlines():
        if "registers" in ln or "spill" in ln:
            log("  " + ln.strip())

    log("[3 kernels] kernel vs plain at flagship shapes")
    measured = {}
    phase_kernels(measured)

    log("[4 forces] evaluate_forces fp64, CUDA vs CPU")
    phase_forces()

    log("[5 cli] examples/water_msevb, --device cuda --steps 50")
    _build.launches.clear()                     # main path starts here
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli(pathlib.Path(tmp))
    launches = dict(_build.launches)
    log(f"  launches {launches}")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    check(not missing, f"kernels not launched on the main path: {missing}")

    log("[6 nve] 200 steps from benchdata/eq_flagship_s80.npz")
    phase_nve()

    k64, k32 = measured["fp64"], measured["fp32"]
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k], max_abs_err=k64[k]["max_abs_err"],
                    ms=k64[k]["ms"], plain_ms=k64[k]["plain_ms"],
                    fp32_max_abs_err=k32[k]["max_abs_err"],
                    fp32_ms=k32[k]["ms"], fp32_plain_ms=k32[k]["plain_ms"])
               for k, (src, rep) in KERNELS.items()]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
