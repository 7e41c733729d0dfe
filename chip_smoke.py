#!/usr/bin/env python3
"""Chip smoke test: drives the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order, one line each (any failure raises, exit code != 0):
  1. device: the card's name and nvidia-smi's name / power limit; no CUDA
     device -> exit 1 before anything else;
  2. build: every kernel under reactive_pb_nn_md_tpu_torch/csrc/ with nvcc
     (one nvcc per source, all at once);
  3. kernels against their plain PyTorch versions, in fp64 and fp32, with
     CUDA-event times (cuda_ms) and device times (device_ms: the
     profiler's device kernels of a call, summed): A, B1, B2, C1, C2 at
     the flagship shapes (the 649-atom equilibrated state, K = 32, order
     6, S = 48 and 80, U = 4 S); A, A', A'', B1, B2, D1, D2, C1, C2 at
     the 10,000-atom shapes (the lattice of examples/water_10k/, cells
     (10, 10, 10, 24), K = 64, scap 280, S = 32), A' under
     set_stencil_impl("half"), B beside D on the same atoms; two calls
     of A, A', A'', B1, B2, C2, D1 and D2 must agree bit for bit; an
     empty kernel's device_ms, the launch floor, is printed beside them;
  4. full force evaluations in fp64, CUDA (kernels) against CPU (plain):
     the flagship and the 10k lattice;
  5. the main paths through the CLI, each with the launch counts set to 0
     just before it and read just after (a run goes in chunks, each chunk
     replays of the step captured as a CUDA graph: a replay adds the
     launches its capture counted):
     a. examples/water_msevb/, 30 steps fp64 and fp32: A, B1, B2, C1, C2,
        E;
     b. examples/water_10k/, 20 steps fp32 (the deck as shipped) and fp64:
        A'', D1, D2, C1, C2, E launch, and A, B1, B2 do not;
     c. examples/water_10k/ under set_stencil_impl("half"), 3 steps fp32:
        A' launches;
     d. examples/water_msevb/ at evb_max_states 8, 5 steps fp64: the state
        cap is regrown at set-up (a log line) and the run completes;
     e. examples/water_10k/ fp32 under NVT and NPT (barofreq 3), 12 steps
        each: A'', D1, D2, C1, C2, E launch;
  6. NVE from the equilibrated flagship state through the chunked loop,
     512 steps in fp64 and fp32: fp64 |Etot(200) - Etot(0)| <= 5 kJ/mol;
     fp32 finite at every step and |dEtot(512)| within 10 kJ/mol of
     fp64's; both drifts, the largest excursions and the rates reported;
  7. ensembles and the run contract, on the flagship:
     a. 256 Langevin NVT steps (friction 1.0 / ps, 300 K) from the
        equilibrated state in fp64 and fp32 through the simulation loop,
        launch counts from 0: Etot finite at every step, the mean kinetic
        temperature of the last 128 steps within 300 +- 30 K; A, B1, B2,
        C1, C2 launch, A', A'', D1, D2 do not;
     b. fp64 NVT through the CLI with checkpoint_velocity 10: 20 steps
        against 10 and an auto-detected restart of 10, positions within
        1e-12 A (the JAX package's restart bound, tests/test_md.py:
        150-151) and Etot within 1e-8 kJ/mol, whether x and v match bit
        for bit, the same generator state at step 10 (so the same
        step-11 draws); the step-10 forces of the restart's set-up
        against the unbroken run's;
     c. the first three barostat trials from the equilibrated state on
        the card and on the CPU (plain path), one numpy seed: the same dE
        and decisions; then 30 NPT steps through the CLI, barofreq 3;
     d. 4 steps through the CLI at debug 2 with --dump-forces: a Donor
        block per non-principle diabat and an H-bond line at each output
        step, the dump's rows equal to the forces;
  8. md_scan graphed (md/graphs.py), against eager md_steps on the card:
     a. one eager warm step under torch.cuda.set_sync_debug_mode("error")
        raises nothing (flagship NVT fp64 and fp32, 10k fp32); the
        capture's seconds and the graph pool's MiB of each;
     b. kernel E against its plain version (eigh): the flagship's H at
        S = 80 and 48 (the small tier), the 10k box's at S = 32, an
        engineered near-degenerate H (diagonal gap 1e-7): |dlambda_0| <=
        1e-10 |lambda_0|, |dc| <= 1e-9 up to sign where the ground gap is
        > 1e-6, two calls bit-identical; E, plain and eigh times, and
        E's device time from a CUDA graph of back-to-back launches
        (graphed_device_ms);
     c. EAGER_STEPS (64) graphed steps against as many eager md_steps
        from the equilibrated flagship, NVE and NVT (one generator state),
        fp64 (max |dx| <= 1e-9 A, |dEtot| <= 1e-8 kJ/mol) and fp32 (1e-3
        A, 0.05 kJ/mol; two eager fp32 runs part by 0.016 kJ/mol over 100
        steps): A, B1, B2, C1, C2 and E launch 64 times each;
     d. the 10k box fp32, 20 steps graphed against eager, the same
        tolerances: A'', D1, D2, C1, C2, E launch 20 times each;
     e. the replays: a small tier that every step overflows
        (evb_small_states 16), replayed at the full cap, against eager
        full-cap steps; a state cap lowered to the current diabat count,
        regrown inside a chunk ("chunk replayed"); the 30-step NPT CLI
        run of 7c against the same run eager (positions within 1e-9 A,
        the same barostat decisions);
     f. rates, eager against graphed (tools/profile_step.py measure,
        RATE_STEPS graphed steps, a sixth of them eager): the flagship NVE
        fp64 and fp32, NVT fp64, the 10k box NVE fp32: steps/s from the
        log's completed line, device ms, busy share and device ops per
        step; no claim rests on them;
  9. PB-NN (coupling function type 3: nn/coupling_mlp.py, nn/train.py) on
     the equilibrated flagship, bench.py run_bench_nn's configuration:
     the (OW, O_h3o, H_h3o) triple switched to a (16, 16) MLP of 5 inputs
     (n_env 2) pretrained in-process, attached with
     Simulation.mutate_system:
     a. pretrain_geometric, fp32, 400 steps on the triple's analytic row,
        on the card and on the CPU from one initial MLP and one sample
        set: the MLPs within 1e-5 relative (each tensor's max |diff| over
        its max |value|); the fit's rmse;
     b. evaluate_forces fp64 with the MLP, card (kernels) against CPU
        (plain): energy within 1e-10 relative, forces phase 4's bound;
     c. 256 graphed NVE steps in fp32 through the Simulation, launch counts
        from 0: Etot finite at every step, no capacity regrown; A, B1, B2,
        C1, C2, E launch, A', A'', D1, D2 do not; then 200 fp64 steps,
        |Etot(200) - Etot(0)| <= 5 kJ/mol (phase 6's bound);
     d. an eager type-3 step under sync-debug "error" (fp64, fp32), then
        EAGER_STEPS graphed against as many eager steps at GRAPH_TOL, A,
        B1, B2, C1, C2 and E launching EAGER_STEPS times each;
     e. finetune_adiabatic with force matching (weight 0.1) on 4 rattled
        copies of the flagship frame (numpy seed 0, 0.05 A), e_ref and
        f_ref from the analytic surface on the card: 3 Adam steps fp64 on
        the card and on the CPU, the energy and force rmses before and
        after, the loss and its gradient with respect to every MLP tensor
        within 1e-8 relative;
     f. printed, not gated: steps/s, steady ms, device ms and device ops
        per step of the graphed step with the MLP beside the analytic one,
        fp32 and fp64, 64 steps each (tools/profile_step.py measure), and
        the device ms of the MLP and environment features' forward and
        backward at the small tier (S = 48) alone.
  10. umbrella sampling (md/bias.py, parallel/ensemble.py,
     parallel/umbrella.py, analysis/wham.py, run/umbrella_pmf.py) on the
     flagship, bench.py run_bench_umbrella's ladder (window restraint on
     delta r_OH, k 400, centers in [-0.65, 0.65]; R_OO keeper k 100 at
     2.5 A; Langevin NVT 300 K, friction 5.0 / ps; cap 80, no small
     tier):
     a. the restraint's energy and force, every window of the 16, at the
        equilibrated state in fp64, card against CPU: within 1e-12;
     b. 2 windows (centers -0.4, 0.4), 32 fp64 NVT steps each, graphed
        (the replays of ONE captured step, the restraint copied in a window
        at a time) against eager: max |dx| <= 1e-9 A and |dEtot| <= 1e-8
        kJ/mol a window (8c's bound), the cv series within 1e-9, the
        windows' CV means apart, one capture;
     c. the full-width ladder through run_pmf (its windows batched: one
        captured step for all 16), fp32, 16 windows, 64
        equilibration + 128 sampled steps a window (a depth cut from
        run_bench_umbrella's 400 + 1200), launch counts from 0: A, B1, B2,
        C1, C2, E launch, A', A'', D1, D2 do not; no capacity flag left
        standing; every CV finite; each window's mean CV within 0.25 A of
        its center; each window's last cv equal to a host recomputation
        from its final positions within 1e-5 A; the mean kinetic
        temperature over every window's sampled steps within 300 +- 30 K
        (7a's bound); WHAM converged with >= 10 finite PMF bins; printed:
        the aggregate windows x steps / wall, the captures, the graph
        pool MiB, the peak memory beside what earlier phases still held,
        and the barrier (NaN allowed at this depth);
     d. bench.py run_bench_replicas' ensemble, batched: 16 NVT replicas
        of the lattice deck (examples/water_msevb/in.gro), fp32, cap 48 with no
        tier, 40 steps: the trajectories pairwise apart (max |dx| > 1e-3
        A), replica 15 given replica 0's generator state within 1e-4 A of
        it (the distance printed), one capture when nothing
        regrew.
  11. one replica's step shared over ranks (parallel/shard.py) at world
     size 1 over nccl (a store in a temporary file): 64 graphed fp64 NVE
     steps of the equilibrated flagship through make_atom_sharded_scan
     (the collectives inside the captured step), launch counts from 0 (A,
     B1, B2, C1, C2, E launch), against 64 graphed unsharded steps from
     the same state: max |dx| <= 1e-12 A, whether the bits are equal, the
     potentials within 1e-10 relative; the collectives of one step by
     name and kind (grid, energy, force sums, the flags' max); kernel A's
     range launch, the flagship's 64 cells in 4 ranges, summed against
     its full launch, B1 spreading 4 atom ranges summed against the
     whole spread, and D1 spreading the 10k lattice's 4 atom ranges
     (K = 64, the deck's slab cap and SCAP_10K, no slab overflowing)
     summed against its whole slab spread, all fp64 within 1e-12 of the
     largest value; the sharded and unsharded ms a step.
  12. the replica batch (md/integrators.py batched_md_scan, parallel/
     ensemble.py BatchedReplicaScan: one step vmapped over the replicas,
     captured once, each kernel one launch a step for all of them):
     a. each kernel of the flagship path (A, B1, B2, C1, C2, E), its op's
        batching rule under torch.func.vmap at W = 4 replicas of the
        flagship's shapes (the equilibrated state moved by 0.02 A, S =
        80), against 4 single launches, fp64 and fp32: one launch, fp64
        within BATCH_TOL of the largest value, whether the bits are
        equal; then at W = 16 the batch's launch against 16 single
        launches by cuda_ms and graphed_device_ms, beside 16 times a
        single launch's bound (the w16_* keys of the kernels line);
     b. 4 windows (phase 10's restraints, centers in [-0.4, 0.4]) x 64
        graphed fp64 flagship steps, NVE and NVT, batched against in turn
        (ReplicaScan): per window max |dx| and |dEtot| within phase 8c's
        fp64 bounds; each kernel launches 64 + 1 times batched (the
        replays and the capture's warm-up) against 4 x 64 + 1; one
        capture;
     c. fp32 flagship NVT window-steps/s, batched and in turn, at W = 1,
        4 and 16 (BATCH_RATE_STEPS timed after a 4-step chunk holding the
        capture), the device ms and device ops of a batched step and of
        a window's step in turn (at W = 1; tools/profile_step.py
        profiled_chunk), graph pool MiB and peak memory: printed, not
        gated;
     d. the kernels of the 10k path's cell sweep and slab spread (A', A'',
        D1, D2), their ops' batching rules at W = 4 replicas of the 10k
        lattice's shapes (moved by 0.02 A; cells (10, 10, 10, 24), K = 64,
        scap 280) against 4 single launches, fp64 and fp32, as 12a; at W
        = 16 the batch's launch against 16 single launches, beside 16
        times a single launch's bound (w16_* keys);
     e. 4 replicas x 32 graphed fp64 NVT steps of the 10k lattice (slab
        cap SCAP_10K), batched against in turn (ReplicaScan): per replica
        max |dx| and |dEtot| within 8c's fp64 bounds; A'', D1, D2, C1, C2
        and E launch 32 + 1 times batched against 4 x 32 + 1 in turn,
        each regrow adding its replays and its set-ups (batch_counts);
        then a 4-window fp32 10k ladder (phase 10's restraints) x 32
        steps through make_ladder_scan: every CV finite, the same counts;
     f. fp32 10k lattice NVT replica-steps/s, batched and in turn, at W =
        1, 4 and 16 (32 steps timed after a 4-step chunk holding the
        capture; a W that does not fit the card's memory says so), the
        device ms and ops of a batched step, graph pool MiB, peak memory
        and the captures inside the timed window (the lattice melts: a
        window holding a capture is labelled not steady): printed, not
        gated.
  13. the replica batch under a shard (parallel/shard.py: one vmapped step
     whose force evaluation is shared over an atoms group, each of its
     four collectives issued once for the whole batch), at world size 1
     over nccl (a store in a temporary file), as phase 11:
     a. 4 flagship windows (12b's restraints) x 32 graphed fp64 NVT steps
        through BatchedReplicaScan with an AtomShard of size 1, launch and
        collective counts from 0, against BatchedReplicaScan unsharded
        from the same states and generators: max |dx| <= 1e-12 A
        (phase 11's bound) and whether the bits are equal; one capture;
        A, B1, B2, C1, C2 and E launch 32 + 1 times, each collective
        32 + 1 times, and the captured step holds the four once each;
     b. the kernels a shard runs on its share, batched (one launch under
        torch.func.vmap for W = 4 replicas moved by 0.02 A), 4 shares
        summed against the batched launch of the whole, fp64, within
        1e-12 of the largest value: A's range launch over the flagship's
        64 cells, A'' over the 10k lattice's cells (each range's rows
        kept), B1 spreading the flagship's atom slices, D1 the 10k
        lattice's (K = 64, SCAP_10K).
  14. the run scripts (reactive_pb_nn_md_tpu_torch/run/):
     a. the 100,000-atom box through run/scale_run.py's build() (33,332
        H2O + 1 H3O+, PME 128^3, fp32, cap 32): its shapes must be 22^3
        kernel cells, pme_scap 0 (the per-atom spread: K + order - 1 =
        133 > 128), S = 32 and K = 128; A'', B1, B2, C1, C2 and E
        against their plain versions at the box's shapes, fp64 and fp32,
        at phase 3's (E: 8b's) tolerances (the at_100k keys of the
        kernels line), and F at the calls of one evaluation of the box,
        each equal to the CPU's index_add bit for bit, their device ms
        (order and sum) printed; then one capture chunk and 64 graphed fp32 NVE
        steps through scale_run.run, launch counts from 0 (the path:
        A'', B1, B2, C1, C2, E launch; A, A', D1, D2 do not): the
        potential finite, no capacity flag in any chunk (the steps/s of
        truncated steps would not be the box's); the flags, steps/s and
        peak memory printed;
     b. the committed equilibrated 10k state
        (reactive_pb_nn_md_tpu_torch/data/eq_10k_s32.npz, made by
        run/equilibrate.py) on its build: 64 graphed fp32 NVE steps
        holding the capture, then 64 steady; no capacity flag, exactly
        one capture; A'', D1, D2, C1, C2, E launch; steps/s printed;
     c. run/equilibrate.py's protocol on the flagship at reduced counts
        (EQ_SMOKE): it ends clean, its window starts within 30 K of 300 K
        (the last rescale's target, unless a regrow restarted the window
        later) and its file reads back;
     d. run/parity_reference.py's dump of the flagship deck in fp64 on
        the card against the CPU's: the port's diff passes; the largest
        force difference printed.
  15. the PB-NN run scripts (run/pbnn_production.py,
     run/pbnn_transfer.py):
     a. pbnn_production.run_one on both surfaces (the analytic MS-EVB3
        couplings, and the (OW, O_h3o, H_h3o) triple switched to an MLP
        pretrained in-process, fp32, 1,500 steps), PBNN_STEPS (256) fp32
        steps each of the flagship deck from its lattice through the
        Simulation, launch counts from 0: A, B1, B2, C1, C2, E launch,
        A', A'', D1, D2 do not; the run fails on a non-finite Etot at an
        output step, a step not done, an aborting line or a kernel E
        failure; hop events (the hop file's lines) equal the hopped rows;
        steps/s, hops, distinct molecules, regrows and captures printed;
     b. the transfer boxes (26 H2O + H3O+ at K = 16, 63 H2O + H3O+ at
        K = 24, fp64 and fp32): B1, B2, C1, C2 at the box's shapes
        (C at S = 80 over the path's U = min(S, molecules) x 4 superset
        atoms) against their plain versions at phase 3's tolerances, E on
        the first Hamiltonian of the box's eval path at 8b's, device ms
        from CUDA graphs as 14a's (the at_k16 and at_k24 keys of the
        kernels line); then the labels and the
        MLP's energies of 2 rattled frames of each box (eval_system's
        numbers), card against CPU, fp64, within 1e-10 relative, launch
        counts from 0 (B1, C1, E launch; A, A', A'', D1, D2 do not);
     c. one finetune_heldout step (split 0.75) on the 26-water box's 2
        frames, card against CPU: the report's rmses and the MLP after
        within 1e-8 relative (9e's bound).
  16. the step is reproducible: two runs of one deck from one state,
     each with a capture of its own, every step's x, v and Etot equal bit
     for bit (tools/two_runs.py's configurations): the equilibrated
     flagship, 100 graphed steps NVE fp64 and fp32 and NVT fp32 (one
     generator seed); the committed 10k state, 64 fp32 NVE; 4 flagship
     windows batched, 32 fp64 NVT; the flagship with phase 9's type-3
     coupling, 64 fp32 NVE; then an eager step of
     the flagship (fp64) and of the 10k lattice (fp32) under the
     accumulation audit (ops/accumulation_audit.py: no floating-point
     accumulation with two nonzero terms on one target; the exact sites
     listed), and the torch accumulate kernels of one profiled replay of
     each captured step, printed.
  Phase 3 also holds kernel F (the fixed-order segment sum,
  csrc/segment_sum.cu: two order kernels and the sum) at the calls of
  one flagship and one 10k force evaluation: its order (perm, off)
  equal to segment_order's, its sum equal to the CPU's index_add bit
  for bit (which adds in the same order; within SEGMENT_TOL of max
  |ref| printed too), two calls bit-identical and a batched launch of 4
  equal to 4 single launches (an index shared and batched); one call
  profiles as F's own kernels and nothing else, at most 3 launches; the
  evaluation's calls' device ms, the order's apart from the sum's, and
  each call's longest row are printed.  F launches on every main path
  with a force.
The line before the last is nvidia-smi's name and power limit, the one
before it the per-kernel JSON (times, errors and bounds in fp64; fp32 in
the fp32_ keys); the last line is the result JSON.

bound_ms is the least time the card could take for a kernel's work: the
larger of the bytes its function must move (inputs read once, outputs
written once) over 3.35 TB/s and its operations over the card's peak
for their type: the pair, spread and interpolation kernels at the fp64
(34 TFLOP/s) or fp32 (67 TFLOP/s) rate without tensor cores; C1 and C2,
whose work is complex GEMMs, at the fp64 tensor-core (DMMA) rate of 67
TFLOP/s in fp64 and at 67 TFLOP/s in fp32 (the tensor cores' fp32-input
mode is TF32, another type).  Operations are counted from these inputs:
for the pair kernels FLOP_PAIR per inter-molecular pair within the cutoff
(each unordered pair once); for the spreads 4 per atom and brick element;
for the interpolations 16; for C1 the complex product W @ BC (8 per
complex multiply-add) and for C2 three of them; for E, whose solve is
fp64 whatever H's type, the (4/3) S^3 flops of a dense symmetric
tridiagonalization.
"""

import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter

ROOT = pathlib.Path(__file__).resolve().parent
DECK = ROOT / "examples" / "water_msevb"
DECK_10K = ROOT / "examples" / "water_10k"
EQ_STATE = ROOT / "benchdata" / "eq_flagship_s80.npz"

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "A": ("reactive_pb_nn_md_tpu_torch/csrc/realspace_pair.cu",
          "reactive_pb_nn_md_tpu/ops/pallas/realspace_pair.py:601"),
    "A'": ("reactive_pb_nn_md_tpu_torch/csrc/realspace_pair.cu",
           "reactive_pb_nn_md_tpu/ops/pallas/realspace_pair.py:601"),
    "A''": ("reactive_pb_nn_md_tpu_torch/csrc/realspace_pair.cu",
            "reactive_pb_nn_md_tpu/ops/pallas/realspace_pair.py:657"),
    "B1": ("reactive_pb_nn_md_tpu_torch/csrc/pme_spread.cu",
           "reactive_pb_nn_md_tpu/ops/pallas/pme_spread.py:121"),
    "B2": ("reactive_pb_nn_md_tpu_torch/csrc/pme_spread.cu",
           "reactive_pb_nn_md_tpu/ops/pallas/pme_spread.py:145"),
    "C1": ("reactive_pb_nn_md_tpu_torch/csrc/recip_perstate.cu",
           "reactive_pb_nn_md_tpu/ops/pallas/recip_perstate.py:239"),
    "C2": ("reactive_pb_nn_md_tpu_torch/csrc/recip_perstate.cu",
           "reactive_pb_nn_md_tpu/ops/pallas/recip_perstate.py:272"),
    "D1": ("reactive_pb_nn_md_tpu_torch/csrc/pme_slab.cu",
           "reactive_pb_nn_md_tpu/ops/pallas/pme_slab.py:268"),
    "D2": ("reactive_pb_nn_md_tpu_torch/csrc/pme_slab.cu",
           "reactive_pb_nn_md_tpu/ops/pallas/pme_slab.py:291"),
    # no TPU kernel: the JAX package's ground state is jnp.linalg.eigh
    "E": ("reactive_pb_nn_md_tpu_torch/csrc/ground_state.cu",
          "reactive_pb_nn_md_tpu/ops/ground_state.py:157"),
    # no TPU kernel: XLA's scatter-add, the transpose of the JAX step's
    # gathers on positions (the pair rows' packed[j] here), which the TPU
    # runs in its compiled order
    "F": ("reactive_pb_nn_md_tpu_torch/csrc/segment_sum.cu",
          "reactive_pb_nn_md_tpu/evb/hamiltonian.py:229"),
}
# the shapes each kernel's JSON numbers are taken at (its main path's)
AT_10K = ("A'", "A''", "D1", "D2")
HBM_BPS = 3.35e12                           # H100 SXM device memory
# H100 SXM peaks: fp64 / fp32 outside the tensor cores, and GEMM-shaped
# work, whose fp64 runs on the tensor cores (DMMA)
PEAK_FLOPS = {"fp64": 34e12, "fp32": 67e12}
PEAK_GEMM_FLOPS = {"fp64": 67e12, "fp32": 67e12}
# operations per inter-molecular pair within the cutoff: erfc (~20), exp
# (~10), sqrt and the divides (~10), LJ (~10), force factors (~10)
FLOP_PAIR = 60
NVE_STEPS = 512                 # phase 6, past the reference's fp32 pump
NVT_STEPS = 256                 # phase 7a
# phases 8c and 9d: graphed against eager steps; phase 8f: graphed steps
# a rate cell (printed only; 128 before phase 14)
EAGER_STEPS, RATE_STEPS = 64, 64
NVT_DECK = "ensemble           NVT\nfriction_coeff     1.0\n"
# phase 7b: the restart against the unbroken run, max |dx| (A): the JAX
# package's own bound (tests/test_md.py:150-151)
RESTART_DX = 1e-12
# kernels of each main path (E: the EVB ground state of every reactive
# one), each launched once a step; F, the fixed-order segment sum, takes
# every gradient of a gather on positions: several launches a step
FLAGSHIP_KERNELS = ("A", "B1", "B2", "C1", "C2", "E")
TENK_KERNELS = ("A''", "D1", "D2", "C1", "C2", "E")
FLAGSHIP_PATH = FLAGSHIP_KERNELS + ("F",)
TENK_PATH = TENK_KERNELS + ("F",)
# phase 8c / 8d: graphed against eager, (max |dx| A, |dEtot| kJ/mol)
GRAPH_TOL = {"fp64": (1e-9, 1e-8), "fp32": (1e-3, 0.05)}
# phase 9: bench.py run_bench_nn's MLP (the triple, 5 inputs, 400 steps)
NN_TRIPLE = ("OW", "O_h3o", "H_h3o")
NN_ENV, NN_PRETRAIN, NN_STEPS, NN_FRAMES = 2, 400, 256, 4
# phase 10: run_bench_umbrella's ladder, its 400 + 1200 steps a window cut
# to 64 + 128; run_bench_replicas' ensemble
LADDER = dict(n_windows=16, span=0.65, k_spring=400.0, k_roo=100.0,
              r_oo=2.5, n_equil=64, n_sample=128, chunk=64,
              temperature=300.0, friction=5.0)
REPLICAS, REPLICA_STEPS, REPLICA_CAP = 16, 40, 48
# phase 11: the sharded scan's steps, its bound against the unsharded
# scan (A), and the ranges' sums against the full launches (of max|ref|)
SHARD_STEPS, SHARD_DX, RANGE_TOL = 64, 1e-12, 1e-12
# the 10k lattice's slab cap once it melts (the deck's 280 overflows at
# step 31 of a fp32 NVE run)
SCAP_10K = 520
# phase 12: the replica batch: 12a's and 12b's replicas, 12b's graphed
# steps, 12a's bound on a batched launch against W single launches (of
# max |singles|, fp64: the same arithmetic in the same order, but for
# torch's sums over C1's partials), 12c's batch sizes and steps a chunk
BATCH_W, BATCH_STEPS, BATCH_TOL = 4, 64, 1e-13
BATCH_RATE_W, BATCH_RATE_STEPS = (1, 4, 16), 32
# 12e / 12f: the 10k box's graphed steps a batch (and timed at 12f's W)
TENK_BATCH_STEPS = 32
# phase 13: the batch under a shard: 13a's graphed steps (its windows are
# BATCH_W), its bound against the unsharded batch (A, phase 11's) and
# 13b's ranges a batched launch (their sums against the batched whole
# launch within RANGE_TOL of its largest value)
SHARD_BATCH_STEPS, SHARD_BATCH_RANGES = 32, 4
# phase 14: the 100k box (run/scale_run.py's defaults: 33,332 H2O + 1
# H3O+, PME 128^3, fp32, cap 32), the kernels of its path, the samples
# its plain versions are timed over, its graphed NVE steps (a capture
# chunk, then timed); the committed 10k state and 14b's steps a chunk;
# 14c's reduced equilibration (run/equilibrate.py's counts: 4 x 8 quench
# chunks, STEPS rescaled, 10 window chunks of 40)
SCALE_ATOMS = 100_000
SCALE_KERNELS = ("A''", "B1", "B2", "C1", "C2", "E")
SCALE_PLAIN_REPS = 3
SCALE_CHUNK, SCALE_STEPS = 64, 64
EQ_10K = ROOT / "reactive_pb_nn_md_tpu_torch" / "data" / "eq_10k_s32.npz"
TENK_STEADY_STEPS = 64
EQ_SMOKE = dict(equil_steps=80, quench_divs=(40, 5), quench_chunks=1,
                validate_chunks=2)
# phase 15: the PB-NN scripts: 15a's fp32 steps a surface (the production
# script's 1,536 cut in depth); run/pbnn_transfer.py's boxes, name ->
# (waters, K, seed, frame seed), their frames (15b, 15c), the kernels the
# eval path launches, the kernels held at the boxes' shapes, the shared
# MLP's pretraining steps and the plain versions' timing samples
PBNN_STEPS, PBNN_FRAMES = 256, 2
TRANSFER_BOXES = {"k16": (26, 16, 9, 3), "k24": (63, 24, 4, 5)}
TRANSFER_KERNELS = ("B1", "C1", "E")
TRANSFER_AT = ("B1", "B2", "C1", "C2", "E")
TRANSFER_PRETRAIN, TRANSFER_PLAIN_REPS = 200, 5
# kernel F against its plain version (of max |ref|; the plain version on
# the CPU adds in the same order, so the bits agree in both types)
SEGMENT_TOL = {"fp64": 1e-13, "fp32": 1e-6}
# kernel F's kernels by name (csrc/segment_sum.cu): its order, its sum
F_ORDER_KERNELS = ("segment_tile_sort_kernel", "segment_bucket_order_kernel")
F_SUM_KERNEL = "segment_sum_kernel"

# Tolerances (|got - ref| <= atol + rtol |ref|, atol relative to max|ref|):
#  fp64: 1e-10 relative for every kernel.
#  fp32: kernel A as tests/test_pallas_realspace.py (energies rtol 1e-6 /
#  atol 5e-3, gradients rtol 1e-5 / atol 1e-4).  B and C sum 216 (B) or
#  U x Mh (C) terms in another order (tiles; the plain spread's atomics on
#  the card) than their plain versions: B1 takes rtol 1e-5, C1
#  tests/test_recip_perstate.py's forward bound (5e-5), and the gradients,
#  which cancel heavily (spline-derivative rows, dG contractions), rtol
#  2e-3 with atol 2e-5 of their scale -- that file's gradient bound.
TOL64 = dict(rtol=1e-10, scale_atol=1e-10)
TOL32 = {"pair_e": dict(rtol=1e-6, atol=5e-3), "pair_g": dict(rtol=1e-5,
                                                              atol=1e-4),
         "spread": dict(rtol=1e-5, scale_atol=1e-6),
         "gather": dict(rtol=2e-3, scale_atol=2e-5),
         "C1": dict(rtol=5e-5, scale_atol=5e-5)}


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


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
    """Milliseconds of one fn() call by CUDA events: the median of `reps`
    samples, each a run of n back-to-back calls over n (n from a first
    timed call: a sample spans about 2 ms, n at most 20), so that the
    wrapper's host work overlaps the card's and is not counted while the
    card idles."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    n = max(1, min(20, int(2.0 / max(t0.elapsed_time(t1), 1e-3))))
    times = []
    for _ in range(reps):
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / n)
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, calls=5):
    """Device milliseconds of one fn() call by torch.profiler: every
    device kernel, copy and fill the profile holds over `calls` calls
    after a warm-up, summed whatever its name, over `calls`; None if the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(max(getattr(e, "self_device_time_total", 0), 0)
             for e in prof.key_averages())
    return us / calls / 1e3 if us > 0 else None


def graphed_device_ms(fn, n=64, reps=15):
    """Device milliseconds of one fn() call without the profiler: n calls
    captured back to back in one CUDA graph, its replay timed by CUDA
    events (the median of `reps`), less the replay of n empty kernels
    (torch.cuda._sleep(0)) captured the same way, over n.  The two
    graphs replay in turns."""
    import torch

    def capture(f):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            f()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                f()
        return g

    graphs = (capture(fn), capture(lambda: torch.cuda._sleep(0)))
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    times = ([], [])
    for _ in range(reps + 1):
        for g, ts in zip(graphs, times):
            t0.record()
            g.replay()
            t1.record()
            torch.cuda.synchronize()
            ts.append(t0.elapsed_time(t1))
    med = [sorted(ts[1:])[reps // 2] for ts in times]
    return (med[0] - med[1]) / n


def tool(name):
    """tools/<name>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def launch_floor_ms():
    """device_ms of an empty kernel (torch.cuda._sleep(0)): the launch
    floor a tiny kernel's device time is read against."""
    import torch
    return device_ms(lambda: torch.cuda._sleep(0))


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes, flops, tag, gemm=False):
    """(bound_ms, bound_by) of a kernel's work on the H100."""
    t_b = n_bytes / HBM_BPS
    t_o = flops / (PEAK_GEMM_FLOPS if gemm else PEAK_FLOPS)[tag]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def pairs_within(x, box, mol, rc):
    """Inter-molecular atom pairs within rc (each unordered pair once)."""
    import torch
    L = torch.diagonal(box)
    n = 0
    for i0 in range(0, x.shape[0], 1024):
        d = x[i0:i0 + 1024, None, :] - x[None, :, :]
        d = d - L * torch.round(d / L)
        m = ((d * d).sum(-1) < rc * rc) & (mol[i0:i0 + 1024, None]
                                           != mol[None, :])
        n += int(m.sum())
    return n // 2


def record(out, name, err, ok, fn, plain, n_bytes, flops, tag, lib=None,
           gemm=False, plain_reps=25, graphed=False):
    """One kernel's entry: error, kernel / plain / library ms, the
    kernel's device ms (the profiler's, or with `graphed` a CUDA graph's
    of back-to-back launches, graphed_device_ms), bound (the plain
    version timed over plain_reps samples)."""
    b_ms, b_by = bound(n_bytes, flops, tag, gemm)
    out[name] = dict(max_abs_err=err[0], max_rel_err=err[1], ok=ok,
                     ms=cuda_ms(fn), device_ms=graphed_device_ms(
                         fn, n=8, reps=5) if graphed else device_ms(fn),
                     plain_ms=plain if isinstance(
                         plain, float) else cuda_ms(plain, plain_reps),
                     bound_ms=b_ms, bound_by=b_by,
                     library_ms=None if lib is None else cuda_ms(lib))


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


def lattice_10k(device, dtype):
    """(system, x, box, topo, cfg) of examples/water_10k/ at step 0."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md.simulation import load_deck
    cfg, frame, system, topo = load_deck(
        DECK_10K / "in.gro", DECK_10K / "ff.pmt", DECK_10K / "top.top",
        DECK_10K / "sim.pmt", device,
        precision="fp64" if dtype == torch.float64 else "fp32")
    x = torch.as_tensor(frame.xyz, dtype=dtype, device=device)
    box = torch.as_tensor(frame.box, dtype=dtype, device=device)
    return system, x, box, topo, cfg


def pair_kernels(out, tag, system, x, box, topo, names, plain_reps=25,
                 graphed=False):
    """Pair kernels of the stencils in `names` ("full" A, "half" A',
    "column" A'' -> the entry's name) against the plain sweep on one
    state, at the function level: per-slot
    gradients and the energy sums (A' and A'' put each pair's energy on
    one row)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp
    fp64 = tag == "fp64"
    cells = system.rs_cells
    slot, over = rsp.bin_atoms(x, box, cells, system.real_space_cutoff)
    check(not bool(over), "kernel A cell capacity overflows")
    cm = rsp.pack_cells(x, topo.charge, topo.atom_type, topo.atom_mol,
                        slot, cells)
    tabs = rsp.build_tabs(system, x.dtype)
    kw = dict(rcut=system.real_space_cutoff, alpha=system.alpha_sqrt,
              has_sapt=system.has_sapt)
    ref = rsp.pair_rows_plain(cm, tabs, cells, torch.diagonal(box), **kw)
    plain = cuda_ms(lambda: rsp.pair_rows_plain(cm, tabs, cells,
                                                torch.diagonal(box), **kw),
                    plain_reps)
    n_pairs = pairs_within(x, box, topo.atom_mol, system.real_space_cutoff)
    for impl, name in names.items():
        rsp.set_stencil_impl(impl)
        try:
            def fn():
                return rsp.pair_rows(cm, tabs, cells, box, impl=impl, **kw)
            got = fn()
            if fp64:
                e1, r1, ok1 = close(got[:, :6], ref[:, :6], **TOL64)
                e2, r2, ok2 = close(got[:, 6:].sum(0), ref[:, 6:].sum(0),
                                    **TOL64)
            else:
                e1, r1, ok1 = close(got[:, :6], ref[:, :6], **TOL32["pair_g"])
                e2, r2, ok2 = close(got[:, 6:].double().sum(0),
                                    ref[:, 6:].double().sum(0),
                                    **TOL32["pair_e"])
            # every row is summed in a fixed order (A' and A'' fold their
            # j sides in one too): a second call must give the same bits
            check(torch.equal(got, fn()),
                  f"kernel {name} ({tag}) differs between two calls")
            record(out, name, (max(e1, e2), max(r1, r2)),
                   ok1 and ok2, fn, plain, nbytes(cm, tabs, box) + nbytes(cm),
                   FLOP_PAIR * n_pairs, tag, graphed=graphed)
        finally:
            rsp.set_stencil_impl("auto")


def perstate_inputs(x, box, topo, system, cbw, S, rng, ua=None):
    """Kernel C's eight arguments at S states, on the real spectra of
    `x` (perstate_kernels' inputs): U = 4 S atoms x[:U], or the atoms
    `ua` (the superset rows the path gives, any U)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.models import pme
    dtype, dev = x.dtype, x.device
    K, order = system.pme_grid, system.spline_order
    Q0, _ = pme.charge_grid(x, topo.charge.contiguous(), box, K, order,
                            scap=system.pme_scap)
    F0 = torch.fft.rfftn(Q0)
    xu = x[:4 * S] if ua is None else x[ua]
    Mh, U = K * (K // 2 + 1), xu.shape[0]
    (Ar, Ai), (Br, Bi), (Cr, Ci) = pme.structure_axis_factors(
        xu, box, K, order)
    BCr = (Br[:, :, None] * Cr[:, None, :]
           - Bi[:, :, None] * Ci[:, None, :]).reshape(U, Mh)
    BCi = (Br[:, :, None] * Ci[:, None, :]
           + Bi[:, :, None] * Cr[:, None, :]).reshape(U, Mh)
    dq = torch.tensor(rng.standard_normal((S, U)) * 0.3, dtype=dtype,
                      device=dev)
    return [t.contiguous() for t in (
        dq, Ar.T, Ai.T, BCr, BCi, F0.real.reshape(K, Mh),
        F0.imag.reshape(K, Mh), cbw.reshape(K, Mh))]


def perstate_kernels(out, tag, x, box, topo, system, cbw, S, rng, key,
                     plain_reps=25, graphed=False, ua=None):
    """C1 / C2 at S states on the real spectra of `x`: U = 4 S, or the
    atoms `ua` (perstate_inputs)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import recip_perstate as rp
    fp64 = tag == "fp64"
    dtype, dev = x.dtype, x.device
    K = system.pme_grid
    ins = perstate_inputs(x, box, topo, system, cbw, S, rng, ua)
    Mh, U = K * (K // 2 + 1), ins[1].shape[1]
    dq, BCr, BCi = ins[0], ins[3], ins[4]
    gbar = torch.tensor(rng.standard_normal(S), dtype=dtype, device=dev)
    e_k = rp.perstate_fwd_cuda(*ins)
    e_p = rp.perstate_plain(*ins)
    err = close(e_k, e_p, **(TOL64 if fp64 else TOL32["C1"]))
    g_k = rp.perstate_bwd_cuda(gbar, *ins)
    leaves = [t.clone().requires_grad_(i < 7) for i, t in enumerate(ins)]
    g_p = torch.autograd.grad((rp.perstate_plain(*leaves) * gbar).sum(),
                              leaves[:7])
    errs = [close(a, b, **(TOL64 if fp64 else TOL32["gather"]))
            for a, b in zip(g_k, g_p)]

    def plain_fb():
        lv = [t.clone().requires_grad_(i < 7) for i, t in enumerate(ins)]
        torch.autograd.grad((rp.perstate_plain(*lv) * gbar).sum(), lv[:7])

    # the library yardsticks, complex torch.matmul of the plain
    # formulation: W @ BC (C1); G = W @ BC, dG @ BC^H and W^H @ dG, C2's
    # three products, in one closure (C2)
    W = (dq[:, None, :] * torch.complex(ins[1], ins[2])[None]).reshape(
        S * K, U)
    BC = torch.complex(BCr, BCi)
    dG = torch.complex(torch.randn(S * K, Mh, dtype=dtype, device=dev),
                       torch.randn(S * K, Mh, dtype=dtype, device=dev))

    def c2_library():
        torch.matmul(W, BC)
        torch.matmul(dG, BC.mH)
        torch.matmul(W.mH, dG)

    gemm = 8.0 * S * K * U * Mh
    c1_plain = cuda_ms(lambda: rp.perstate_plain(*ins), plain_reps)
    record(out, "C1" + key, err[:2], err[2],
           lambda: rp.perstate_fwd_cuda(*ins), c1_plain,
           nbytes(*ins) + S * dq.element_size(), gemm, tag,
           lib=lambda: torch.matmul(W, BC), gemm=True, graphed=graphed)
    # C2 folds every cross-block sum in a fixed order: a second call
    # must give the same bits
    same = all(torch.equal(a, b) for a, b in zip(
        g_k, rp.perstate_bwd_cuda(gbar, *ins)))
    check(same, f"C2{key} ({tag}) differs between two calls")
    record(out, "C2" + key, (max(e for e, _, _ in errs),
                             max(r for _, r, _ in errs)),
           all(o for _, _, o in errs),
           lambda: rp.perstate_bwd_cuda(gbar, *ins),
           cuda_ms(plain_fb, plain_reps) - c1_plain,
           nbytes(gbar, *ins) + nbytes(*ins[:7]), 3 * gemm, tag,
           lib=c2_library, gemm=True, graphed=graphed)


def spread_kernels(out, tag, x, box, topo, K, order, rng, key,
                   plain_reps=25, graphed=False):
    """B1 / B2 (the per-atom spread and gather) on the atoms of `x`."""
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_spread as sp
    from reactive_pb_nn_md_tpu_torch.utils import pbc
    fp64 = tag == "fp64"
    w, dw, nearpt = sp.spline_setup(x, box, K, order)
    q = topo.charge.contiguous()
    n = x.shape[0]
    grid = sp.spread_cuda(w, nearpt, q, K)
    err = close(grid, sp.spread_plain(w, nearpt, q, K),
                **(TOL64 if fp64 else TOL32["spread"]))
    # B1 writes each element once, its atoms summed in ascending order: a
    # second call gives the same bits
    check(torch.equal(grid, sp.spread_cuda(w, nearpt, q, K)),
          f"kernel B1{key} ({tag}) differs between two calls")
    record(out, "B1" + key, err[:2], err[2],
           lambda: sp.spread_cuda(w, nearpt, q, K),
           lambda: sp.spread_plain(w, nearpt, q, K),
           nbytes(w, nearpt, q) + K ** 3 * w.element_size(),
           4 * n * order ** 3, tag, plain_reps=plain_reps, graphed=graphed)
    gQ = torch.tensor(rng.standard_normal(K ** 3), dtype=x.dtype,
                      device=x.device)
    recip = pbc.recip_vectors(box).contiguous()
    gargs = (gQ, w, dw, nearpt, q, recip, K)
    got = torch.cat([t.reshape(-1) for t in sp.gather_cuda(*gargs)])
    ref = torch.cat([t.reshape(-1) for t in sp.gather_plain(*gargs)])
    err = close(got, ref, **(TOL64 if fp64 else TOL32["gather"]))
    # B2 sums each atom in a fixed order: a second call gives the same bits
    check(torch.equal(got, torch.cat([t.reshape(-1) for t in
                                      sp.gather_cuda(*gargs)])),
          f"kernel B2{key} ({tag}) differs between two calls")
    record(out, "B2" + key, err[:2], err[2], lambda: sp.gather_cuda(*gargs),
           lambda: sp.gather_plain(*gargs),
           nbytes(*gargs[:-1]) + 4 * n * w.element_size(),
           16 * n * order ** 3, tag, plain_reps=plain_reps,
           graphed=graphed)


def segment_calls(system, state, topo, cbw, kw):
    """(src, idx, n) of every kernel F launch of one eager force
    evaluation of `state` (the neighbor plan kw) at the tier the main
    path's steps take (the small one where the system has it), in launch
    order."""
    from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.ops import neighbors
    from reactive_pb_nn_md_tpu_torch.ops.kernels import segment_sum as ss
    calls = []
    launch = ss.segment_sum_cuda

    def recorded(src, idx, n, nb=None):
        calls.append((src.clone(), idx.clone(), n))
        return launch(src, idx, n, nb)

    ss.segment_sum_cuda = recorded
    try:
        nl = neighbors.build_neighbors(state.x, state.box, **kw)
        integrators.evaluate_forces(
            state.x, state.box, topo, system, nl, cbw,
            tier="small" if ham.small_state_tier(system) else "full")
    finally:
        ss.segment_sum_cuda = launch
    return calls


def device_ms_by_name(fn, calls=5, counts=False):
    """{kernel name: device ms of one fn() call} (torch.profiler); with
    `counts`, {name: (ms, launches)} of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / calls / 1e3, e.count / calls)
            if counts else e.self_device_time_total / calls / 1e3
            for e in prof.key_averages() if e.self_device_time_total > 0}


def segment_split(by_name):
    """(sum, order, foreign) device ms of a device_ms_by_name profile of
    kernel F calls: the sum kernel's, the rest (F's two order kernels;
    in a checkout before them, torch's sort and search), and what is
    neither F's sum nor its order kernels."""
    total = sum(by_name.values())
    s = sum(v for k, v in by_name.items() if F_SUM_KERNEL in k)
    own = sum(v for k, v in by_name.items() if any(
        n in k for n in F_ORDER_KERNELS + (F_SUM_KERNEL,)))
    return s, total - s, total - own


def longest_row(idx, n):
    """The most entries of idx (any shape) on one row t < n."""
    import torch
    i = idx.reshape(-1)
    i = i[(i >= 0) & (i < n)]
    return int(torch.bincount(i, minlength=n).max()) if i.numel() else 0


def segment_step(calls, tag, library=None):
    """Device ms of the F calls `calls` one after another (one force
    evaluation's), split into the order's and the sum's, with their
    bound, entries and each call's longest row; with `library`, the
    library call's device ms on the same inputs."""
    from reactive_pb_nn_md_tpu_torch.ops.kernels import segment_sum as ss
    by_name = device_ms_by_name(lambda: [ss.segment_sum_cuda(*c)
                                         for c in calls])
    s, o, foreign = segment_split(by_name)
    return dict(calls=len(calls), entries=sum(c[1].numel() for c in calls),
                device_ms=sum(by_name.values()), kernel_device_ms=s,
                order_device_ms=o, foreign_device_ms=foreign,
                library_device_ms=None if library is None else device_ms(
                    lambda: [library(*c) for c in calls]),
                bound_ms=sum(bound(nbytes(src, i) + m * src[0].numel()
                                   * src.element_size(), 0, tag)[0]
                             for src, i, m in calls),
                longest_rows=[longest_row(i, m) for _, i, m in calls],
                shapes=[[int(i.numel()), m, int(src[0].numel())]
                        for src, i, m in calls])


def segment_kernels(out, tag, calls, key, W=BATCH_W):
    """Kernel F at the shapes of `calls` (segment_calls'): each call's
    order (perm, off) equal to segment_order's on the CPU (off, and every
    row's entries), its sum equal to the plain version on the CPU
    (index_add, which adds in the same order) bit for bit, two calls
    bit-identical; a batched launch of W replicas (the call's src scaled
    per replica, the index shared and rolled per replica) equal to W
    single launches bit for bit, and the rolled indices' orders to
    segment_order's.  One call of the largest profiles as F's own
    kernels only, at most 3 launches.  Records the largest call (most
    entries) as F{key}, its library call torch's indexing backward
    (index_put_ with accumulate) on the same inputs, and the whole
    evaluation's calls as F{key}_step (segment_step: device ms of the
    order kernels and of the sum, each call's longest row)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import segment_sum as ss

    def same_order(ii, n):
        perm, off = ss.segment_order_kernels(ii, n)
        perm, off = perm.cpu().reshape(-1, ii.shape[-1]), off.cpu()
        for i, p, o in zip(ii.cpu().reshape(-1, ii.shape[-1]), perm,
                           off.reshape(-1, n + 1)):
            ref_perm, ref_off = ss.segment_order(i, n)
            a, b = int(ref_off[0]), int(ref_off[n])
            check(torch.equal(o.long(), ref_off)
                  and torch.equal(p[a:b].long(), ref_perm[a:b]),
                  f"kernel F ({tag}{key}): the order kernels' (perm, off) "
                  f"differ from segment_order's at M = {i.numel()}, n = "
                  f"{n}")

    worst = 0.0
    for src, idx, n in calls:
        same_order(idx, n)
        got = ss.segment_sum_cuda(src, idx, n)
        ref = ss.segment_sum_plain(src.cpu(), idx.cpu(), n)
        err = close(got, ref, 0.0, scale_atol=SEGMENT_TOL[tag])
        check(err[2], f"kernel F ({tag}{key}) disagrees with its plain "
                      f"version: {err[0]:.3e} at M = {idx.numel()}")
        worst = max(worst, err[1])
        check(torch.equal(got.cpu(), ref),
              f"kernel F ({tag}{key}) differs from index_add on the CPU "
              f"at M = {idx.numel()}, n = {n}: max |d| {err[0]:.3e}")
        check(torch.equal(got, ss.segment_sum_cuda(src, idx, n)),
              f"kernel F ({tag}{key}) differs between two calls")
        srcs = torch.stack([src * (1.0 + 0.25 * w) for w in range(W)])
        idxs = torch.stack([idx.roll(w) for w in range(W)])
        same_order(idxs, n)
        for ii in (idx, idxs):
            singles = torch.stack([ss.segment_sum_cuda(
                srcs[w], ii if ii.ndim == 1 else ii[w], n)
                for w in range(W)])
            check(torch.equal(ss.segment_sum_cuda(srcs, ii, n, nb=W),
                              singles),
                  f"kernel F ({tag}{key}): a batched launch differs from "
                  f"{W} single launches")
    src, idx, n = max(calls, key=lambda c: c[1].numel())
    ref = ss.segment_sum_plain(src.cpu(), idx.cpu(), n)
    err = close(ss.segment_sum_cuda(src, idx, n), ref, 0.0,
                scale_atol=SEGMENT_TOL[tag])
    one = device_ms_by_name(lambda: ss.segment_sum_cuda(src, idx, n),
                            counts=True)
    check(all(any(f in k for f in F_ORDER_KERNELS + (F_SUM_KERNEL,))
              for k in one) and sum(c for _, c in one.values()) <= 3,
          f"one kernel F call ({tag}{key}) runs other device work or more "
          f"than 3 launches: {one}")

    def library(s, i, m):
        # torch's indexing backward as the step gave it its inputs before
        # kernel F: a padding entry on row 0 with a zero cotangent
        pad = (i < 0).reshape((-1,) + (1,) * (s.ndim - 1))
        return torch.zeros((m,) + tuple(s.shape[1:]), dtype=s.dtype,
                           device=s.device).index_put_(
            (i.clamp(min=0),), torch.where(pad, 0.0, s), accumulate=True)

    record(out, "F" + key, err[:2], err[2],
           lambda: ss.segment_sum_cuda(src, idx, n),
           lambda: ss.segment_sum_plain(src, idx, n),
           nbytes(src, idx) + n * src[0].numel() * src.element_size(), 0,
           tag, lib=lambda: library(src, idx, n))
    out["F" + key]["shape"] = [int(idx.numel()), n,
                               int(src[0].numel())]
    out["F" + key]["kernels"] = {k: v for k, v in one.items()}
    step = segment_step(calls, tag, library)
    step.update(worst_rel_err=worst, equal_to_cpu_plain=True)
    out["F" + key + "_step"] = step
    log(f"  {tag} F{key}: {len(calls)} launches an evaluation, "
        f"{step['entries']} entries; every call's order equal to "
        f"segment_order's, its sum to the CPU's index_add bit for bit "
        f"(within {SEGMENT_TOL[tag]:g} of max|ref|: worst {worst:.3e}), "
        f"two calls and batched (W = {W}) launches bit-identical; one "
        f"call: {one}; the evaluation's calls {step['device_ms']:.4f} "
        f"device ms (the order kernels {step['order_device_ms']:.4f}, the "
        f"sum {step['kernel_device_ms']:.4f}, other "
        f"{step['foreign_device_ms']:.4f}) against torch's indexing "
        f"backward {fmt(step['library_device_ms'])} on the same inputs; "
        f"bound {step['bound_ms']:.5f} ms (bytes); longest rows "
        f"{step['longest_rows']}")


def phase_kernels(results):
    """Phase 3: every kernel against its plain version, at the flagship
    shapes (A, B, C, F) and at the 10,000-atom shapes (A, A', A'', B, D,
    C, F)."""
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.ops import neighbors
    from reactive_pb_nn_md_tpu_torch.ops.kernels import (
        pme_spread as sp, pme_slab as sl)
    from reactive_pb_nn_md_tpu_torch.models import pme
    from reactive_pb_nn_md_tpu_torch.topology import State
    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        fp64 = dtype == torch.float64
        system, state, topo, _, cbw, _ = flagship(dev, dtype)
        x, box = state.x, state.box
        K, order = system.pme_grid, system.spline_order
        out = results.setdefault(tag, {})

        # ---- A at the flagship shapes
        pair_kernels(out, tag, system, x, box, topo, {"full": "A"})

        # ---- B1 / B2: spread and gather
        spread_kernels(out, tag, x, box, topo, K, order, rng, "")

        # ---- C1 / C2 at S = 48 and 80
        for S in (48, 80):
            perstate_kernels(out, tag, x, box, topo, system, cbw, S, rng,
                             "" if S == 80 else f"_S{S}")

        # ---- F at the calls of one force evaluation
        meta = flagship(dev, dtype)[3]
        segment_kernels(out, tag, segment_calls(
            system, state, topo, cbw, integrators.neighbor_plan(
                system, box, meta["capacity"], react_cap=meta["react_cap"])),
            "")

        # ---- the 10,000-atom lattice: A, A', A'' on one state; D; C
        system, x, box, topo, _ = lattice_10k(dev, dtype)
        K, order, scap = system.pme_grid, system.spline_order, system.pme_scap
        pair_kernels(out, tag, system, x, box, topo,
                     {"full": "A@10k", "half": "A'", "column": "A''"})
        spread_kernels(out, tag, x, box, topo, K, order, rng, "@10k")
        w, dw, nearpt = sp.spline_setup(x, box, K, order)
        q = topo.charge.contiguous()
        n = x.shape[0]
        slot, rows, over = sl.slab_bins(nearpt, K, order, scap)
        check(not bool(over), "the 10k lattice overflows the slab cap")
        grid = sl.spread_slab_cuda(w, nearpt, q, rows, K, scap)
        err = close(grid, sl.spread_slab_plain(w, nearpt, q, rows, K),
                    **(TOL64 if fp64 else TOL32["spread"]))
        # D1 and D2 sum every element in one fixed order: a second call
        # must give the same bits
        check(torch.equal(grid, sl.spread_slab_cuda(w, nearpt, q, rows, K,
                                                    scap)),
              f"kernel D1 ({tag}) differs between two calls")
        record(out, "D1", err[:2], err[2],
               lambda: sl.spread_slab_cuda(w, nearpt, q, rows, K, scap),
               lambda: sl.spread_slab_plain(w, nearpt, q, rows, K),
               nbytes(w, nearpt, q, rows) + K ** 3 * w.element_size(),
               4 * n * order ** 3, tag)
        gQ = torch.tensor(rng.standard_normal(K ** 3), dtype=dtype,
                          device=dev)
        dargs = (gQ, w, dw, nearpt, rows, K)
        d2 = sl.interp_slab_cuda(*dargs, scap)
        err = close(d2, sl.interp_slab_plain(*dargs),
                    **(TOL64 if fp64 else TOL32["gather"]))
        check(torch.equal(d2, sl.interp_slab_cuda(*dargs, scap)),
              f"kernel D2 ({tag}) differs between two calls")
        record(out, "D2", err[:2], err[2],
               lambda: sl.interp_slab_cuda(*dargs, scap),
               lambda: sl.interp_slab_plain(*dargs),
               nbytes(gQ, w, dw, nearpt, rows)
               + K * scap * 4 * w.element_size(), 16 * n * order ** 3, tag)
        cbw = pme.cb_half(box, K, order, system.alpha_sqrt, dtype=dtype)
        perstate_kernels(out, tag, x, box, topo, system, cbw,
                         system.evb_max_states, rng, "@10k")
        cap = neighbors.suggest_capacity(system.n_atoms,
                                         float(torch.det(box)),
                                         system.verlet_cutoff)
        segment_kernels(out, tag, segment_calls(
            system, State(x=x, v=torch.zeros_like(x), box=box), topo, cbw,
            integrators.neighbor_plan(system, box, cap)), "@10k")
        torch.cuda.synchronize()
        log(f"  {tag}: empty kernel device_ms (launch floor) "
            f"{fmt(launch_floor_ms())}")
        ten = ("A@10k", "A'", "A''", "B1@10k", "D1", "B2@10k", "D2")
        row = ", ".join(f"{k} {out[k]['ms']:.4f} / "
                        f"{fmt(out[k]['device_ms'])}" for k in ten)
        log(f"  {tag}: on the 10k lattice, cuda_ms / device_ms: {row}")
        for name, r in out.items():
            if name.endswith("_step"):
                continue
            lib = ("" if r["library_ms"] is None
                   else f"  library {r['library_ms']:.4f} ms")
            log(f"  {tag} {name:7s} max_abs_err {r['max_abs_err']:.3e} "
                f"max_rel_err {r['max_rel_err']:.3e} ok {r['ok']}  kernel "
                f"{r['ms']:.4f} ms  device {fmt(r['device_ms'])} ms  plain "
                f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}){lib}")
            check(r["ok"], f"kernel {name} ({tag}) disagrees with its plain "
                           f"version: max abs error {r['max_abs_err']:.3e}")


def forces_cuda_vs_cpu(name, build, e_rtol=1e-8):
    """evaluate_forces fp64 on the card (kernels) and on the CPU (plain)
    from `build(device)` -> (system, state, topo, cbw, nlist kwargs):
    energy within e_rtol relative, eigenvector and forces 1e-8."""
    import torch
    from reactive_pb_nn_md_tpu_torch.ops import neighbors
    from reactive_pb_nn_md_tpu_torch.md import integrators
    res = {}
    for dev in ("cuda", "cpu"):
        system, state, topo, cbw, kw = build(torch.device(dev))
        nl = neighbors.build_neighbors(state.x, state.box, **kw)
        check(not bool(nl.overflow), f"{name}: neighbor capacity overflows")
        t0 = time.perf_counter()
        fe = integrators.evaluate_forces(state.x, state.box, topo, system,
                                         nl, cbw)
        over = integrators.overflow_names(integrators.capacity_flags(nl, fe))
        check(not over, f"{name}: {over} overflow")
        res[dev] = (fe, time.perf_counter() - t0)
    (g, tg), (c, tc) = res["cuda"], res["cpu"]
    check(int(g.n_states) == int(c.n_states), f"{name}: state counts differ")
    dE = abs(float(g.potential) - float(c.potential))
    ev_g, ev_c = g.eigenvector.cpu(), c.eigenvector
    dc = min(float((ev_g - ev_c).abs().max()),
             float((ev_g + ev_c).abs().max()))
    fmax = float(c.force.abs().max())
    dF = float((g.force.cpu() - c.force).abs().max())
    log(f"  {name}: n_states {int(c.n_states)}  |dE| {dE:.3e} kJ/mol  "
        f"|dc| {dc:.3e}  max|dF| {dF:.3e} (max|F| {fmax:.1f}); cuda "
        f"{tg:.2f} s, cpu {tc:.2f} s")
    check(dE <= e_rtol * abs(float(c.potential)) and dc <= 1e-8
          and dF <= 1e-8 * fmax, f"{name}: CUDA and CPU forces disagree")


def phase_forces():
    """Phase 4: evaluate_forces fp64, CUDA (kernels) vs CPU (plain), on
    the flagship and the 10k lattice."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.models import pme
    from reactive_pb_nn_md_tpu_torch.ops import neighbors
    from reactive_pb_nn_md_tpu_torch.topology import State

    def flag(dev):
        system, state, topo, meta, cbw, _ = flagship(dev, torch.float64)
        kw = integrators.neighbor_plan(system, state.box, meta["capacity"],
                                       react_cap=meta["react_cap"])
        return system, state, topo, cbw, kw

    def lattice(dev):
        system, x, box, topo, _ = lattice_10k(dev, torch.float64)
        cbw = pme.cb_half(box, system.pme_grid, system.spline_order,
                          system.alpha_sqrt, dtype=torch.float64)
        cap = neighbors.suggest_capacity(system.n_atoms,
                                         float(torch.det(box)),
                                         system.verlet_cutoff)
        return (system, State(x=x, v=torch.zeros_like(x), box=box), topo,
                cbw, integrators.neighbor_plan(system, box, cap))

    forces_cuda_vs_cpu("flagship", flag)
    forces_cuda_vs_cpu("10k lattice", lattice)


def deck_copy(tmp, deck, prec, extra=""):
    """The 8 CLI file names of a copy of `deck` under `tmp` in precision
    `prec`, with the parameter lines `extra` appended."""
    d = tmp / f"{deck.name}_{prec}"
    shutil.copytree(deck, d)
    sim = d / "sim.pmt"
    text = sim.read_text()
    for p in ("fp64", "fp32"):
        text = text.replace(f"precision          {p}",
                            f"precision          {prec}")
    sim.write_text(text.rstrip("\n") + "\n" + extra)
    return [str(d / n) for n in ("in.gro", "ff.pmt", "top.top", "sim.pmt",
                                 "traj.gro", "run.log", "hops.log", "A.log")]


def run_cli(tmp, deck, prec, steps, n_frames, extra=""):
    """The CLI on a copy of `deck` in precision `prec`; returns (steps/s,
    regrow lines)."""
    from reactive_pb_nn_md_tpu_torch.run import cli
    files = deck_copy(tmp, deck, prec, extra)
    cli.main(files + ["--device", "cuda", "--steps", str(steps)])
    text = pathlib.Path(files[5]).read_text()
    check(f"precision {prec}" in text, f"the log does not say {prec}")
    check(f"completed {steps} steps" in text,
          f"{deck.name} {prec}: the run did not complete {steps} steps")
    etot = [float(ln.split()[5]) for ln in text.splitlines()
            if ln.startswith(" KE")]
    check(len(etot) == n_frames and all(math.isfinite(e) for e in etot),
          f"{deck.name} {prec}: log energies {etot}")
    frames = pathlib.Path(files[4]).read_text().count("step ")
    check(frames == n_frames, f"{deck.name} {prec}: {frames} trajectory "
                              f"frames, not {n_frames}")
    regrows = [ln for ln in text.splitlines() if "regrow" in ln]
    rate = float(text.strip().splitlines()[-1].split("(")[1].split()[0])
    log(f"  {deck.name} {prec}: {steps} steps, {rate:.2f} steps/s, Etot "
        f"{etot[0]:.3f} -> {etot[-1]:.3f}, {frames} frames, "
        f"{len(regrows)} regrows")
    for ln in regrows:
        log("    " + ln)
    return rate, regrows


def main_path(name, fn, launched, absent=()):
    """Run one main path with the launch counts set to 0 just before it;
    every kernel of `launched` must launch, none of `absent`."""
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    _build.launches.clear()
    fn()
    counts = dict(_build.launches)
    log(f"  {name} launches {counts}")
    missing = [k for k in launched if counts.get(k, 0) == 0]
    check(not missing, f"{name}: kernels not launched: {missing}")
    stray = [k for k in absent if counts.get(k, 0)]
    check(not stray, f"{name}: kernels of another path launched: {stray}")
    return counts


def eq_sim(tmp, dtype, extra=""):
    """The Simulation of the flagship deck (copied under `tmp`, with the
    parameter lines `extra`) at the equilibrated state and its
    capacities."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    tag = "fp64" if dtype == torch.float64 else "fp32"
    system, state, topo, meta, cbw, _ = flagship(torch.device("cuda"), dtype)
    sim = Simulation(*deck_copy(tmp, DECK, tag, extra), device="cuda")
    sim.system, sim.cbw = system, cbw
    sim.capacity, sim.react_cap = meta["capacity"], meta["react_cap"]
    sim._init_state(state, topo)
    return sim


def flagship_run(tmp, dtype, steps, extra="", mutate=None):
    """`steps` steps from the equilibrated flagship state through the
    chunked loop (capacities regrown, chunk replayed) of the flagship
    deck with the parameter lines `extra`, the System passed through
    Simulation.mutate_system(mutate) first when given; (Etot and KE at
    every step, hops, steps/s, the Simulation)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md import integrators
    tag = "fp64" if dtype == torch.float64 else "fp32"
    sim = eq_sim(tmp, dtype, extra)
    if mutate is not None:
        sim.mutate_system(mutate)
    etot = [float(sim.ms.kinetic + sim.ms.potential)]
    ke = [float(sim.ms.kinetic)]
    hops = step = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while step < steps:
        diag, done, last = sim._chunk(
            step, min(integrators.MAX_CHUNK, steps - step))
        check(not last, f"{tag}: the run ended at step {step + done}: "
                        f"{sim._log_lines[-1:]}")
        hops += int(diag.hopped.sum())
        etot += (diag.kinetic + diag.potential).tolist()
        ke += diag.kinetic.tolist()
        step += done
    torch.cuda.synchronize()
    return etot, ke, hops, steps / (time.perf_counter() - t0), sim


def phase_nve():
    """Phase 6: NVE_STEPS steps from the equilibrated state in fp64 and
    fp32.  fp64 must hold |Etot(200) - Etot(0)| <= 5 kJ/mol; fp32 must stay
    finite at every step and end within 10 kJ/mol of fp64's drift at the
    last step."""
    import torch
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in (torch.float64, torch.float32):
            tag = "fp64" if dtype == torch.float64 else "fp32"
            etot, _, hops, rate, sim = flagship_run(
                pathlib.Path(tmp), dtype, NVE_STEPS)
            regrows = sim._log_lines
            bad = [i for i, e in enumerate(etot) if not math.isfinite(e)]
            check(not bad, f"{tag}: non-finite Etot from step {bad[:1]}")
            out[tag] = etot
            d = [e - etot[0] for e in etot]
            log(f"  {tag}: Etot(200) - Etot(0) {d[200]:+.3f} kJ/mol, "
                f"Etot({NVE_STEPS}) - Etot(0) {d[-1]:+.3f}, max|Etot - Etot0| "
                f"{max(map(abs, d)):.3f}, {rate:.2f} steps/s, {hops} hops, "
                f"{len(regrows)} regrows")
            for ln in regrows:
                log("    " + ln.rstrip())
    d64 = out["fp64"][200] - out["fp64"][0]
    dd = (out["fp32"][-1] - out["fp32"][0]) - (out["fp64"][-1] - out["fp64"][0])
    log(f"  fp32 - fp64 drift at step {NVE_STEPS}: {dd:+.3f} kJ/mol")
    check(abs(d64) <= 5.0, "fp64 NVE drift exceeds 5 kJ/mol at step 200")
    check(abs(dd) <= 10.0, f"fp32 drift differs from fp64's by more than 10 "
                           f"kJ/mol at step {NVE_STEPS}")


def phase_nvt(tmp):
    """Phase 7a: NVT_STEPS Langevin steps (friction 1.0 / ps, 300 K) from
    the equilibrated flagship in fp64 and fp32: Etot finite at every
    step, the mean kinetic temperature 2 KE / (3 N kB) of the last half
    within 300 +- 30 K.  Returns {tag: steps/s}."""
    import torch
    from reactive_pb_nn_md_tpu_torch.utils.constants import KB
    rates = {}
    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        etot, ke, hops, rate, sim = flagship_run(
            tmp / "nvt", dtype, NVT_STEPS, NVT_DECK)
        regrows = sim._log_lines
        bad = [i for i, e in enumerate(etot) if not math.isfinite(e)]
        check(not bad, f"7a {tag}: non-finite Etot from step {bad[:1]}")
        temp = [2.0 * k / (3.0 * sim.system.n_atoms * KB) for k in ke]
        t_mean = sum(temp[-NVT_STEPS // 2:]) / (NVT_STEPS // 2)
        log(f"  7a {tag}: {NVT_STEPS} NVT steps, mean T(last "
            f"{NVT_STEPS // 2}) {t_mean:.2f} K (T0 {temp[0]:.2f}), Etot "
            f"{etot[0]:.3f} -> {etot[-1]:.3f}, {rate:.2f} steps/s, {hops} "
            f"hops, {len(regrows)} regrows")
        check(abs(t_mean - 300.0) <= 30.0,
              f"7a {tag}: mean kinetic temperature {t_mean:.2f} K is not "
              f"within 300 +- 30 K")
        rates[tag] = rate
    return rates


def cli_in(files, steps, opts=()):
    """The CLI on the deck `files` (deck_copy's) with the deck's directory
    as the working directory, where its checkpoint lives; returns the
    Simulation."""
    import os
    from reactive_pb_nn_md_tpu_torch.run import cli
    cwd = os.getcwd()
    os.chdir(pathlib.Path(files[0]).parent)
    try:
        return cli.main(files + ["--device", "cuda", "--steps", str(steps),
                                 *opts])
    finally:
        os.chdir(cwd)


def flagship_copy(tmp, name, extra):
    """deck_copy of the flagship deck in fp64 under tmp / name."""
    (tmp / name).mkdir()
    return deck_copy(tmp / name, DECK, "fp64", extra)


def phase_restart(tmp):
    """Phase 7b: fp64 NVT through the CLI, checkpoint_velocity 10: 20
    steps against 10 and an auto-detected restart of 10.  Positions at
    step 20 within RESTART_DX (the JAX package's restart bound,
    tests/test_md.py:150-151), Etot within 1e-8 kJ/mol; whether they
    match bit for bit is printed; the restored generator's state at step
    10 is the unbroken run's, so step 11 draws what it drew."""
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    extra = NVT_DECK + "checkpoint_velocity 10\n"
    chunk = Simulation._chunk
    from reactive_pb_nn_md_tpu_torch.md import graphs
    # (Simulation, step, generator state, MDState, its forces and its
    # neighbor list) at each chunk's start (copied: a graphed chunk's
    # outputs are the graph's buffers, which the next chunk's replays
    # overwrite)
    starts = []

    def recorded(self, step, n):
        nl = self.ms.nlist
        starts.append((self, step, self.gen.get_state(), self.ms,
                       self.ms.force.clone(), graphs.with_leaves(
                           nl, iter([t.clone() for t in graphs.leaves(nl)]))))
        return chunk(self, step, n)

    Simulation._chunk = recorded
    try:
        whole = cli_in(flagship_copy(tmp, "whole", extra), 20)
        files = flagship_copy(tmp, "broken", extra)
        cli_in(files, 10)
        broken = cli_in(files, 10)
    finally:
        Simulation._chunk = chunk
    check(broken.restart and broken.start_step == 10,
          "7b: the second run did not restart from step 10")
    at10 = [(g, ms, f, nl) for sim, step, g, ms, f, nl in starts
            if step == 10 and sim in (whole, broken)]
    same = len(at10) == 2 and torch.equal(at10[0][0], at10[1][0])
    check(same, "7b: the restored generator's state at step 10 differs")
    dx = float((broken.ms.state.x - whole.ms.state.x).abs().max())
    de = abs(float(broken.ms.kinetic + broken.ms.potential)
             - float(whole.ms.kinetic + whole.ms.potential))
    exact = (torch.equal(broken.ms.state.x, whole.ms.state.x)
             and torch.equal(broken.ms.state.v, whole.ms.state.v))
    chk = np.load(pathlib.Path(files[0]).parent / "velocity_checkpoint.npz")
    log(f"  7b: 20 steps vs 10 + restart 10 (fp64 NVT): max|dx| {dx:.3e} A,"
        f" |dEtot| {de:.3e} kJ/mol, step-10 generator equal {same}, "
        f"checkpoint step {int(chk['step'])}, generator on "
        f"{broken.gen.device}; x and v equal bit for bit {exact}")
    # the step-10 forces: the unbroken run's from its graphed step 10, the
    # restart's from its set-up (an eager evaluation at the full state
    # cap, on a neighbor list built there); beside them eager
    # evaluations of the restart's state at the tier the graphed step
    # took, on the restart's neighbor list and on the unbroken run's
    from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
    from reactive_pb_nn_md_tpu_torch.md import integrators
    (_, _, f_w, nl_w), (_, mb, f_b, _) = at10
    tier = "small" if ham.small_state_tier(broken.system) else "full"

    def force(nl):
        return integrators.evaluate_forces(
            mb.state.x, mb.state.box, mb.topo, broken.system, nl,
            broken.cbw, tier=tier).force

    def vs(f):
        return (f"equal {torch.equal(f, f_w)}, max|dF| "
                f"{float((f - f_w).abs().max()):.3e}")

    log(f"  7b: step-10 forces against the unbroken run's graphed step: "
        f"the restart's set-up (full tier, its own neighbor list) "
        f"{vs(f_b)} kJ/mol/A; eager, {tier} tier, its own neighbor list "
        f"{vs(force(mb.nlist))}; eager, {tier} tier, the unbroken run's "
        f"neighbor list {vs(force(nl_w))}; the two lists' rows equal "
        f"{torch.equal(mb.nlist.full_idx, nl_w.full_idx)}")
    check(dx <= RESTART_DX and de <= 1e-8,
          "7b: the restart does not continue the unbroken run")


def phase_npt(tmp):
    """Phase 7c: the first three barostat trials from the equilibrated
    flagship on the card and with the plain path on the CPU, from one
    numpy seed: each dE within 1e-8 |dE| + 1e-12 |PE| (the CUDA vs CPU
    potentials' own agreement), the same decisions.  Then 30 NPT steps
    through the CLI at barofreq 3, fp64: finite, the box diagonal.
    Returns (the CLI's steps/s, its Simulation)."""
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.md.barostat import MCBarostat
    runs = {}
    for dev in ("cuda", "cpu"):
        system, state, topo, meta, cbw, cfg = flagship(torch.device(dev),
                                                       torch.float64)
        ms = integrators.initial_md_state(
            state, topo, system, cbw, meta["capacity"],
            react_cap=meta["react_cap"])
        over = integrators.overflowed(ms)
        check(not over, f"7c {dev}: {over} overflow")
        baro = MCBarostat(cfg.pressure, cfg.temperature, cfg.baroscale,
                          cfg.seed)
        t0 = time.perf_counter()
        for _ in range(3):
            ms, cbw = baro.attempt(ms, system, cbw)
        runs[dev] = (baro.history, float(ms.potential),
                     time.perf_counter() - t0)
    (h_g, pe_g, t_g), (h_c, pe_c, t_c) = runs["cuda"], runs["cpu"]
    for k, ((dg, ag), (dc, ac)) in enumerate(zip(h_g, h_c)):
        log(f"  7c trial {k + 1}: dE card {dg:.10f} cpu {dc:.10f} kJ/mol "
            f"(|diff| {abs(dg - dc):.3e}), accepted {ag} / {ac}")
        check(abs(dg - dc) <= 1e-8 * abs(dc) + 1e-12 * abs(pe_c) and ag == ac,
              f"7c: barostat trial {k + 1} differs between card and CPU")
    log(f"  7c: three trials {t_g:.2f} s on the card, {t_c:.2f} s on the "
        f"CPU; PE after them {pe_g:.6f} / {pe_c:.6f}")
    files = flagship_copy(tmp, "npt", "ensemble           NPT\n")
    sim = cli_in(files, 30)
    box = sim.ms.state.box.cpu().numpy()
    text = pathlib.Path(files[5]).read_text()
    etot = [float(ln.split()[5]) for ln in text.splitlines()
            if ln.startswith(" KE")]
    vols = [float(ln.split()[1]) for ln in text.splitlines()
            if ln.startswith(" volume(A^3)")]
    rate = float(text.strip().splitlines()[-1].split("(")[1].split()[0])
    acc = [a for _, a in sim.barostat.history]
    # a capture a tier, and one more for each grid refit or regrow: a move,
    # rejected or accepted, keeps the System and so its graph
    caps = sim.step_graphs.captures
    refits = sum("re-derived" in ln or "regrow" in ln
                 for ln in text.splitlines())
    tiers = len({key[2] for key, _, _ in caps})
    log(f"  7c: 30 NPT steps (CLI, fp64, barofreq 3): {len(acc)} trials, "
        f"{sum(acc)} accepted, volume {vols[0]:.4f} -> "
        f"{float(np.linalg.det(box)):.4f} A^3, {rate:.2f} steps/s, "
        f"{len(caps)} captures ({tiers} tiers, {refits} refits/regrows)")
    check(all(math.isfinite(e) for e in etot) and len(acc) == 9,
          f"7c: NPT run: Etot {etot}, {len(acc)} trials")
    check(len(caps) <= tiers + refits,
          f"7c: {len(caps)} captures for {tiers} tiers and {refits} grid "
          f"refits or regrows")
    check(np.allclose(np.diag(np.diag(box)), box), "7c: box not diagonal")
    return rate, sim


def phase_debug(tmp):
    """Phase 7d: 4 reactive steps through the CLI at debug 2, output every
    2 steps, with --dump-forces: a Donor block per non-principle diabat
    at each output step, the hop-file H-bond lines, and the dump's last
    rows equal to the final forces to its printed precision (1e-6)."""
    import numpy as np
    dump = tmp / "forces.out"
    files = flagship_copy(tmp, "debug", "debug              2\n"
                          "n_output           2\n")
    sim = cli_in(files, 4, ("--dump-forces", str(dump)))
    log_text = pathlib.Path(files[5]).read_text()
    n_states = [int(ln.split()[1]) for ln in log_text.splitlines()
                if ln.startswith(" diabats ")]
    blocks = pathlib.Path(files[7]).read_text().split("step ")[1:]
    donors = [b.count("Donor Coordinates") for b in blocks]
    hb = [ln for ln in pathlib.Path(files[6]).read_text().splitlines()
          if "number of acceptors" in ln]
    n = sim.system.n_atoms
    rows = np.array([ln.split()[2:5] for ln in
                     dump.read_text().splitlines()[-n:]], dtype=float)
    df = float(np.abs(rows - sim.ms.force.cpu().numpy()).max())
    log(f"  7d: diabats at steps 0, 2, 4 {n_states}, Donor blocks {donors},"
        f" H-bond lines {len(hb)}, force dump max|row - F| {df:.2e}")
    check(donors == [s - 1 for s in n_states] and len(donors) == 3,
          "7d: one Donor block per non-principle diabat at each output step")
    check(len(hb) == 3, "7d: hop-file H-bond lines")
    check(df <= 1e-6, "7d: the force dump differs from the forces")


def lattice_sim(tmp, dtype):
    """The Simulation of examples/water_10k/ (copied under `tmp`) in
    `dtype`, with the CLI's seeded velocities."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    tag = "fp64" if dtype == torch.float64 else "fp32"
    (tmp / f"10k_{tag}").mkdir(parents=True)
    return Simulation(*deck_copy(tmp / f"10k_{tag}", DECK_10K, tag),
                      device="cuda")


def scan_args(sim, ensemble):
    """md_scan's arguments after (ms, ...) for `sim` under `ensemble`."""
    cfg = sim.cfg
    return (sim.system, sim.cbw, cfg.delta_t, ensemble, cfg.friction_coeff,
            cfg.temperature)


def sync_free_step(sim, ens):
    """One eager step of sim's state (after a warm one: kernels, cuFFT
    plans) under torch.cuda.set_sync_debug_mode("error"), which raises at
    a host synchronization; returns the step's EVB tier."""
    import torch
    from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
    from reactive_pb_nn_md_tpu_torch.md import integrators
    system, cbw, dt, _, fr, temp = scan_args(sim, ens)
    tier = "small" if ham.small_state_tier(system) else "full"
    step = (sim.ms, system, cbw, dt, ens, fr, temp, sim.gen, tier)
    integrators.scan_step(*step)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        integrators.scan_step(*step)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return tier


def phase_sync(tmp):
    """Phase 8a: one eager warm step under sync-debug "error" in each
    cell, then its capture: (name, capture s, pool MiB) of each."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md import graphs, integrators
    out = []
    for name, make, ens in (
            ("flagship NVT fp64", lambda: eq_sim(tmp / "8a64", torch.float64,
                                                 NVT_DECK), "NVT"),
            ("flagship NVT fp32", lambda: eq_sim(tmp / "8a32", torch.float32,
                                                 NVT_DECK), "NVT"),
            ("10k NVE fp32", lambda: lattice_sim(tmp, torch.float32),
             "NVE")):
        sim = make()
        system, cbw, dt, _, fr, temp = scan_args(sim, ens)
        tier = sync_free_step(sim, ens)
        sg = graphs.StepGraphs()
        integrators.md_scan(sim.ms, system, cbw, dt, ens, 1, fr, temp,
                            generator=sim.gen, step_graphs=sg)
        _, sec, pool = sg.captures[0]
        out.append((name, sec, pool / 2 ** 20))
        log(f"  8a {name}: an eager {tier}-tier step under sync-debug "
            f"'error' raised nothing; capture {sec:.3f} s, graph pool "
            f"{pool / 2 ** 20:.1f} MiB")
    return out


def evb_like(S, n_active, rng, gap=None):
    """A padded EVB-shaped Hamiltonian (tests/test_ground_state.py's
    _evb_like): tree couplings, parked inactive diagonal."""
    import numpy as np
    diag = -24000.0 + 50.0 * rng.standard_normal(S)
    if gap is not None:
        diag[1] = diag[0] + gap
    H = np.diag(diag)
    for s in range(1, n_active):
        p = rng.integers(0, s)
        H[p, s] = H[s, p] = 30.0 * rng.standard_normal()
    for s in range(n_active, S):
        H[s, s] = diag[0] + 1.0e5 * (1.0 + s / S)
        H[s, :s] = H[:s, s] = 0.0
    return H


def evb_hamiltonian(sim, tier):
    """The EVB Hamiltonian of sim's current state at `tier`."""
    from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
    from reactive_pb_nn_md_tpu_torch.ops import neighbors
    ms, nl = sim.ms, sim.ms.nlist
    full = nl.celltab if nl.celltab is not None else nl.full_idx
    react = nl.react_tab if nl.react_tab is not None else nl.react_idx
    res, _ = ham.adiabatic_energy_force(
        ms.state.x, ms.state.box, ms.topo, sim.system,
        neighbors.neighbor_pairs(nl), sim.cbw, full, react_idx=react,
        tier=tier)
    return res.hamiltonian


def phase_ground_state(tmp, measured):
    """Phase 8b: kernel E against its plain version; E's entries of
    `measured` (fp64 and fp32 at the flagship's small tier, S = 48; S = 80
    and the 10k box's S = 32 beside them)."""
    import numpy as np
    import torch
    flag = eq_sim(tmp / "8b", torch.float64)
    H80 = evb_hamiltonian(flag, "full")
    H48 = evb_hamiltonian(flag, "small")[:48, :48].contiguous()
    H32 = evb_hamiltonian(lattice_sim(tmp / "8b", torch.float32),
                          "full").double()
    Hdeg = torch.tensor(evb_like(80, 60, np.random.default_rng(7), 1e-7),
                        device="cuda")
    for name, H, key in (("flagship S=80", H80, "E_S80"),
                         ("flagship S=48", H48, "E"),
                         ("10k S=32", H32, "E@10k"),
                         ("near-degenerate S=80", Hdeg, None)):
        for dtype in (torch.float64, torch.float32):
            row = ground_state_row(f"8b {name}", H, dtype)
            if key is not None:
                measured["fp64" if dtype == torch.float64 else "fp32"][
                    key] = row


def ground_state_row(name, H, dtype):
    """Kernel E on H in `dtype` against its plain version (eigh): checked
    (phase 8b's bounds) and timed; its entry of `measured`."""
    import torch
    from reactive_pb_nn_md_tpu_torch.ops import ground_state as gs
    tag = "fp64" if dtype == torch.float64 else "fp32"
    Ht = H.to(dtype)
    lam, c, info = gs.ground_state_cuda(Ht)
    lam2, c2, _ = gs.ground_state_cuda(Ht)
    check(torch.equal(lam, lam2) and torch.equal(c, c2),
          f"{name} {tag}: two calls of E differ")
    rounds = int(info)
    check(rounds >= 0, f"{name} {tag}: E failed (info -1)")
    lp, cp = gs.ground_state_eigh(Ht)
    w = torch.linalg.eigvalsh(Ht.double() - Ht[0, 0].double()
                              * torch.eye(Ht.shape[0], device="cuda",
                                          dtype=torch.float64))
    ground_gap = float(w[1] - w[0])
    dlam = abs(float(lam) - float(lp))
    dc = min(float((c - cp).abs().max()), float((c + cp).abs().max()))
    # fp32: H's own rounding (~1e-3 kJ/mol at |H00| ~ 1e4) is in both; the
    # solve is fp64 in both, the outputs rounded to fp32
    tol_l, tol_c = ((1e-10, 1e-9) if tag == "fp64" else (1e-6, 1e-5))
    ok = dlam <= tol_l * abs(float(lp)) and (
        ground_gap <= 1e-6 or dc <= tol_c)
    S = Ht.shape[0]
    isz = Ht.element_size()
    ms = cuda_ms(lambda: gs.ground_state_cuda(Ht))
    # not the profiler's device_ms: it kept the records of 0 or 1 of 5
    # calls of E here
    dev = graphed_device_ms(lambda: gs.ground_state_cuda(Ht))
    row = dict(max_abs_err=max(dlam, dc), max_rel_err=dlam / abs(
        float(lp)), ok=ok, ms=ms, device_ms=dev,
        plain_ms=cuda_ms(lambda: gs.ground_state_eigh(Ht)),
        library_ms=cuda_ms(lambda: torch.linalg.eigh(Ht)),
        rounds=rounds)
    # the function's work, not the method's: H in, (lambda, c) out, and
    # the flops of a dense symmetric tridiagonalization, (4/3) S^3 in
    # fp64 (the solve is fp64 whatever H's dtype)
    row["bound_ms"], row["bound_by"] = bound(
        S * S * isz + (S + 1) * isz, 4.0 / 3.0 * S ** 3, "fp64")
    log(f"  {name} {tag}: E |dlambda| {dlam:.3e} (|lambda| "
        f"{abs(float(lp)):.1f}), |dc| {dc:.3e} up to sign, ground gap"
        f" {ground_gap:.3e}, {rounds} rounds; E {ms:.4f} ms, device "
        f"{dev:.4f} ms, plain {row['plain_ms']:.4f} ms, eigh "
        f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.2e} ms "
        f"({row['bound_by']})")
    check(ok, f"{name} {tag}: E disagrees with eigh")
    return row


def graphed_vs_eager(name, sim, ensemble, n, kernels, tier=None):
    """n graphed steps (md_scan, captured first) against n eager md_steps
    from sim's state, one generator state; the launches of `kernels` must
    be n each.  tier: the eager steps' (None: md_scan's first, and no
    eager step may overflow it)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
    from reactive_pb_nn_md_tpu_torch.md import graphs, integrators
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    system, cbw, dt, ens, fr, temp = scan_args(sim, ensemble)
    if tier is None:
        tier = "small" if ham.small_state_tier(system) else "full"
    tag = "fp64" if sim.ms.state.x.dtype == torch.float64 else "fp32"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    start = gen.get_state()
    sg = graphs.StepGraphs()
    integrators.md_scan(sim.ms, system, cbw, dt, ens, 1, fr, temp,
                        generator=gen, step_graphs=sg)
    gen.set_state(start)
    _build.launches.clear()
    t0 = time.perf_counter()
    g, diag = integrators.md_scan(sim.ms, system, cbw, dt, ens, n, fr, temp,
                                  generator=gen, step_graphs=sg)
    t_g = time.perf_counter() - t0
    counts = dict(_build.launches)
    gen.set_state(start)
    e = sim.ms
    t0 = time.perf_counter()
    for _ in range(n):
        noise = (integrators.draw_noise(e.state.x, gen) if ens == "NVT"
                 else None)
        e = integrators.md_step(e, system, cbw, dt, ens, fr, temp,
                                noise=noise, tier=tier)
        check(not bool(e.small_overflow),
              f"{name}: an eager step overflowed the small tier")
    torch.cuda.synchronize()
    t_e = time.perf_counter() - t0
    check(not integrators.overflowed(e) and not diag.capacities(),
          f"8 {name}: a capacity overflowed")
    dx = float((g.state.x - e.state.x).abs().max())
    de = abs(float(g.kinetic + g.potential) - float(e.kinetic + e.potential))
    tol_x, tol_e = GRAPH_TOL[tag]
    log(f"  {name} {ensemble} {tag}: {n} graphed vs eager steps, max|dx| "
        f"{dx:.3e} A, |dEtot| {de:.3e} kJ/mol, {int(diag.hopped.sum())} "
        f"hops, small tier replayed {bool(diag.small_overflow.any())}; "
        f"{t_g:.2f} s graphed, {t_e:.2f} s eager; launches {counts}")
    check(dx <= tol_x and de <= tol_e,
          f"{name} {ensemble} {tag}: graphed and eager steps disagree")
    bad = {k: counts.get(k, 0) for k in kernels if counts.get(k, 0) != n}
    check(not bad, f"{name} {ensemble} {tag}: launches {bad}, not {n}")
    return diag


def phase_replays(tmp, npt_graphed):
    """Phase 8e: the small-tier replay, a state-cap regrow inside a chunk,
    and the 7c NPT run against the same run eager."""
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    sim = eq_sim(tmp / "8e_tier", torch.float64)
    sim.system = sim.system.replace(evb_small_states=16)
    sim._init_state(sim.ms.state, sim.ms.topo)
    # every chunk runs twice (small, then the full cap): no launch count
    diag = graphed_vs_eager("8e small tier 16", sim, "NVE", 16, (),
                            tier="full")
    check(bool(diag.small_overflow.all()),
          "8e: the small tier did not overflow at every step")

    sim = eq_sim(tmp / "8e_cap", torch.float64)
    sim._chunk(0, 8)
    cap = int(sim.ms.n_states)
    sim.system = sim.system.replace(evb_max_states=cap)
    sim._init_state(sim.ms.state, sim.ms.topo, 8)
    step = 8
    while step < 40 and sim.system.evb_max_states == cap:
        _, done, _ = sim._chunk(step, 8)
        step += done
    lines = [ln for ln in sim._log_lines if "chunk replayed" in ln]
    log(f"  8e state cap {cap} from step 8: {''.join(lines).strip()}")
    check(lines and sim.system.evb_max_states > cap,
          "8e: no state-cap regrow inside a chunk")

    files = flagship_copy(tmp, "npt_eager", "ensemble           NPT\n")
    eager = Simulation(*files, device="cuda")
    eager.eager = True
    eager.run(30)
    dx = float((eager.ms.state.x - npt_graphed.ms.state.x).abs().max())
    acc_e = [a for _, a in eager.barostat.history]
    acc_g = [a for _, a in npt_graphed.barostat.history]
    log(f"  8e NPT 30 steps eager vs graphed: max|dx| {dx:.3e} A, "
        f"decisions {acc_e} / {acc_g}")
    check(dx <= 1e-9 and acc_e == acc_g and np.isfinite(dx),
          "8e: the NPT run differs eager and graphed")


def phase_rates(tmp):
    """Phase 8f: tools/profile_step.py's measure, eager against graphed,
    in four cells; the eager cells profile 2 steps (the graphed ones
    profile.PROFILED), a quarter of their profiler's cost at 8."""
    prof = tool("profile_step")
    prof._instrument()
    out = []
    for deck, ens, tag in (("flagship", "NVE", "fp64"),
                           ("flagship", "NVE", "fp32"),
                           ("flagship", "NVT", "fp64"),
                           ("10k", "NVE", "fp32")):
        for eager in (True, False):
            t0 = time.perf_counter()
            r = prof.measure(deck, ens, tag, tmp, RATE_STEPS, eager,
                             profiled=2 if eager else prof.PROFILED)
            log(f"  8f {prof.line(r)} [{time.perf_counter() - t0:.1f} s]")
            out.append(r)
    return out


def mlp_as(nn, device, dtype):
    """A copy of the MLP nn on `device` in `dtype`."""
    return {"vconst": nn["vconst"].to(device, dtype),
            "w": [w.to(device, dtype) for w in nn["w"]],
            "b": [b.to(device, dtype) for b in nn["b"]]}


def mlp_rel(a, b):
    """The largest over the MLP's tensors of max |a - b| / max |b|."""
    from reactive_pb_nn_md_tpu_torch.nn.coupling_mlp import mlp_tensors
    return max(float((u.double().cpu() - v.double().cpu()).abs().max())
               / max(float(v.double().abs().max()), 1e-300)
               for u, v in zip(mlp_tensors(a), mlp_tensors(b)))


def attach_mlp(nn, dtype):
    """mutate_system's function: the NN_TRIPLE switched to nn (as dtype,
    on the card)."""
    from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp
    return lambda s: coupling_mlp.attach(s, mlp_as(nn, "cuda", dtype),
                                         NN_TRIPLE)


def phase_pbnn_pretrain():
    """Phase 9a: run_bench_nn's pretraining on the card and on the CPU from
    one initial MLP and one sample set; returns the card's MLP."""
    import torch
    from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp, train
    system = flagship(torch.device("cuda"), torch.float32)[0]
    names = system.ff.atype_names
    row = system.evb.cpl_params[tuple(names.index(n) for n in NN_TRIPLE)]
    gen = torch.Generator().manual_seed(1)
    samples = train.sample_geometries(gen, 2048, dtype=torch.float32,
                                      device="cpu")
    init = coupling_mlp.init_mlp(gen, vconst=float(row[0]),
                                 dtype=torch.float32, device="cpu",
                                 n_env=NN_ENV)
    out = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nn, rmse = train.pretrain_geometric(
            row.to(dev), steps=NN_PRETRAIN, dtype=torch.float32,
            n_env=NN_ENV, device=dev, samples=samples,
            init=mlp_as(init, dev, torch.float32))
        out[dev] = (nn, rmse, time.perf_counter() - t0)
    (g, rg, tg), (c, rc, tc) = out["cuda"], out["cpu"]
    rel = mlp_rel(g, c)
    log(f"  9a pretrain_geometric fp32, {NN_PRETRAIN} steps, 2048 samples,"
        f" n_env {NN_ENV}: rmse card {rg:.6f} cpu {rc:.6f}; MLP card vs cpu"
        f" {rel:.3e} relative; {tg:.2f} s card, {tc:.2f} s cpu")
    check(rel <= 1e-5, f"9a: the card's pretrained MLP differs from the "
                       f"CPU's by {rel:.3e} relative")
    return g


def frames_of(system, state, meta, xs):
    """(xs, full_idxs, pair_j, pair_mask) of the frames xs on the main
    path's neighbor plan."""
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.ops import neighbors
    plan = integrators.neighbor_plan(system, state.box, meta["capacity"],
                                     react_cap=meta["react_cap"])
    fr = ([], [], [], [])
    for x in xs:
        nl = neighbors.build_neighbors(x, state.box, **plan)
        check(not bool(nl.overflow), "9e: a frame overflows its neighbors")
        _, j, m = neighbors.neighbor_pairs(nl)
        for lst, v in zip(fr, (x, nl.full_idx, j, m)):
            lst.append(v)
    return fr


def phase_pbnn_finetune(nn):
    """Phase 9e: finetune_adiabatic with force matching on NN_FRAMES
    rattled copies of the flagship frame, card against CPU."""
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp, train
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    system, state, topo, meta, cbw, _ = flagship(dev, torch.float64)
    x0 = state.x.cpu().numpy()
    xs = [torch.tensor(x0 + rng.normal(0.0, 0.05, x0.shape), device=dev)
          for _ in range(NN_FRAMES)]
    e_ref, f_ref = train.make_frame_energy_force_fn(system, topo,
                                                    state.box, cbw)(
        None, *frames_of(system, state, meta, xs))
    out = {}
    for dev in ("cuda", "cpu"):
        system, state, topo, meta, cbw, _ = flagship(torch.device(dev),
                                                     torch.float64)
        nn0 = mlp_as(nn, dev, torch.float64)
        sys_nn = coupling_mlp.attach(system, nn0, NN_TRIPLE)
        fr = frames_of(sys_nn, state, meta, [x.to(dev) for x in xs])
        args = (sys_nn, topo, state.box, cbw, *fr)
        er, fref = e_ref.to(dev), f_ref.to(dev)
        t0 = time.perf_counter()
        p = coupling_mlp.copy_mlp(nn0, True)
        e, f = train.make_frame_energy_force_fn(*args[:4])(p, *fr)
        loss = (torch.mean((e - er) ** 2) + 0.1 * 3.0 * system.n_atoms
                * torch.mean(torch.sum((f - fref) ** 2, -1)))
        grad = torch.autograd.grad(loss, coupling_mlp.mlp_tensors(p))
        t1 = time.perf_counter()
        res = train.finetune_adiabatic(nn0, *args, er, steps=3, f_ref=fref,
                                       force_weight=0.1)
        out[dev] = (float(loss.detach()), grad, res, t1 - t0,
                    time.perf_counter() - t1)
    (lg, gg, rg, t1g, t2g), (lc, gc, rc, t1c, t2c) = out["cuda"], out["cpu"]
    d_loss = abs(lg - lc) / abs(lc)
    d_grad = max(float((a.cpu() - b).abs().max()) / max(
        float(b.abs().max()), 1e-300) for a, b in zip(gg, gc))
    d_rmse = max(abs(a - b) / abs(b) for a, b in zip(rg[1:], rc[1:]))
    d_mlp = mlp_rel(rg[0], rc[0])
    log(f"  9e finetune_adiabatic, {NN_FRAMES} frames, 3 steps, force "
        f"weight 0.1: e rmse {rc[1]:.6f} -> {rc[2]:.6f} kJ/mol, f rmse "
        f"{rc[3]:.6f} -> {rc[4]:.6f} kJ/mol/A (cpu); card vs cpu: loss "
        f"{d_loss:.3e}, gradient {d_grad:.3e}, rmses {d_rmse:.3e}, MLP "
        f"after {d_mlp:.3e} relative; loss + gradient {t1g:.2f} s card, "
        f"{t1c:.2f} s cpu; 3 steps {t2g:.2f} s card, {t2c:.2f} s cpu")
    check(d_loss <= 1e-8 and d_grad <= 1e-8 and d_rmse <= 1e-8,
          "9e: the force-matching loss, its gradient or the finetuning "
          "rmses differ between card and CPU")


def mlp_device_ms(nn, sim):
    """Device ms of the MLP and the environment features, forward and
    backward, at the small tier's S = 48 on sim's state: the type-3 extra
    of a step, alone (graphed_device_ms)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.models import coupling
    from reactive_pb_nn_md_tpu_torch.nn.coupling_mlp import apply_mlp
    x0, box, topo = sim.ms.state.x, sim.ms.state.box, sim.ms.topo
    S = 48
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = torch.randint(0, sim.system.n_mole, (S,), device="cuda",
                      generator=gen)
    a = (d + 1) % sim.system.n_mole
    heavy = topo.mol_atoms[:, 0]
    atom_mol = topo.atom_mol.expand(S, -1)
    x = x0.detach().clone().requires_grad_(True)

    def fwd_bwd():
        r1, r2 = x[heavy[d]], x[heavy[a]]
        env = coupling._env_features(x, box, atom_mol, sim.system.mass, d,
                                     a, r1, r2)
        dr = r1 - r2
        roo = torch.sqrt((dr * dr).sum(-1))
        q2 = (0.25 * dr * dr).sum(-1)
        out = apply_mlp(nn, q2, roo, env).sum()
        return torch.autograd.grad(out, x)

    return graphed_device_ms(fwd_bwd)


def phase_pbnn(tmp):
    """Phase 9 (see the module docstring)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp
    t9 = time.perf_counter()
    nn = phase_pbnn_pretrain()

    def flag_nn(dev):
        system, state, topo, meta, cbw, _ = flagship(dev, torch.float64)
        system = coupling_mlp.attach(system, mlp_as(nn, dev, torch.float64),
                                     NN_TRIPLE)
        kw = integrators.neighbor_plan(system, state.box, meta["capacity"],
                                       react_cap=meta["react_cap"])
        return system, state, topo, cbw, kw

    forces_cuda_vs_cpu("9b flagship type 3", flag_nn, e_rtol=1e-10)

    def nve(dtype, steps):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        etot, _, hops, rate, sim = flagship_run(
            tmp / f"9c_{tag}", dtype, steps,
            mutate=attach_mlp(nn, dtype))
        bad = [i for i, e in enumerate(etot) if not math.isfinite(e)]
        grown = [ln for ln in sim._log_lines if "chunk replayed" in ln]
        d = [e - etot[0] for e in etot]
        log(f"  9c type 3 NVE {tag}: {steps} graphed steps, Etot({steps}) - "
            f"Etot(0) {d[-1]:+.3f} kJ/mol"
            + (f", Etot(200) - Etot(0) {d[200]:+.3f}" if steps >= 200
               else "")
            + f", max|Etot - Etot0| {max(map(abs, d)):.3f}, {rate:.2f} "
            f"steps/s, {hops} hops, {len(grown)} regrows, "
            f"{len(sim.step_graphs.captures)} captures")
        check(not bad, f"9c {tag}: non-finite Etot from step {bad[:1]}")
        check(not grown, f"9c {tag}: a capacity was regrown: {grown}")
        return d, sim

    main_path("9c flagship type 3 NVE fp32",
              lambda: nve(torch.float32, NN_STEPS), FLAGSHIP_PATH,
              ("A'", "A''", "D1", "D2"))
    d64, _ = nve(torch.float64, 200)
    check(abs(d64[200]) <= 5.0,
          "9c: fp64 NVE drift with the MLP exceeds 5 kJ/mol at step 200")

    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        sim = eq_sim(tmp / f"9d_{tag}", dtype)
        sim.mutate_system(attach_mlp(nn, dtype))
        tier = sync_free_step(sim, "NVE")
        log(f"  9d type 3 {tag}: an eager {tier}-tier step under sync-debug "
            f"'error' raised nothing")
        graphed_vs_eager("9d flagship type 3", sim, "NVE", EAGER_STEPS,
                         FLAGSHIP_KERNELS)

    phase_pbnn_finetune(nn)

    prof = tool("profile_step")
    prof._instrument()
    for dtype in (torch.float32, torch.float64):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        for name, mutate in (("analytic", None),
                             ("type 3", attach_mlp(nn, dtype))):
            r = prof.measure("flagship", "NVE", tag, tmp / "9f", 64, False,
                             mutate=mutate)
            log(f"  9f {name}: " + prof.line(r))
    sim = eq_sim(tmp / "9f_mlp", torch.float32)
    ms = mlp_device_ms(mlp_as(nn, "cuda", torch.float32), sim)
    log(f"  9f the MLP and environment features, forward and backward, S "
        f"= 48, fp32: {ms:.4f} device ms (alone, a CUDA graph of 64)")
    log(f"  phase 9: {time.perf_counter() - t9:.1f} s")
    return nn


def window_cv(x, box, atoms):
    """delta r_OH of the triple at positions x, on the host in fp64."""
    import numpy as np
    x = x.detach().cpu().double().numpy()
    L = np.diag(box.detach().cpu().double().numpy())

    def dist(a, b):
        d = x[a] - x[b]
        d -= np.floor(d / L + 0.5) * L
        return float(np.sqrt(d @ d))

    d, a, h = (int(i) for i in atoms)
    return dist(h, d) - dist(h, a)


def phase_bias_force():
    """Phase 10a: every window's restraint at the equilibrated flagship,
    fp64, card against CPU."""
    import dataclasses
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.md import bias, integrators
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble, umbrella
    system, state, topo, meta, cbw, _ = flagship(torch.device("cuda"),
                                                 torch.float64)
    ms = integrators.initial_md_state(state, topo, system, cbw,
                                      meta["capacity"],
                                      react_cap=meta["react_cap"])
    atoms = umbrella.transfer_triple(ms, system)
    W = LADDER["n_windows"]
    centers = np.linspace(-LADDER["span"], LADDER["span"], W)
    ladder = (umbrella.make_ladder(atoms, centers, LADDER["k_spring"], 0,
                                   torch.float64),
              umbrella.make_ladder(atoms, np.full(W, LADDER["r_oo"]),
                                   LADDER["k_roo"], 1, torch.float64))
    de = df = 0.0
    for w in range(W):
        b = ensemble.window_bias(ladder, w)
        e, f = bias.bias_energy_force(state.x, state.box, b)
        cpu = tuple(dataclasses.replace(r, atoms=r.atoms.cpu(), k=r.k.cpu(),
                                        center=r.center.cpu()) for r in b)
        ec, fc = bias.bias_energy_force(state.x.cpu(), state.box.cpu(), cpu)
        de = max(de, abs(float(e) - float(ec)))
        df = max(df, float((f.cpu() - fc).abs().max()))
    log(f"  10a triple (O_d, O_a, H) {atoms.tolist()}: {W} windows' "
        f"restraint card vs CPU fp64: max|dE| {de:.3e} kJ/mol, max|dF| "
        f"{df:.3e} kJ/mol/A")
    check(de <= 1e-12 and df <= 1e-12,
          "10a: the restraint differs between the card and the CPU")
    return system, cbw, ms, atoms


def phase_ladder_graphed(system, cbw, ms, atoms):
    """Phase 10b: 2 windows, 32 fp64 NVT steps, graphed against eager."""
    import torch
    from reactive_pb_nn_md_tpu_torch.parallel import umbrella
    centers, n = [-0.4, 0.4], 32
    ladder = (umbrella.make_ladder(atoms, centers, LADDER["k_spring"], 0,
                                   torch.float64),
              umbrella.make_ladder(atoms, [LADDER["r_oo"]] * 2,
                                   LADDER["k_roo"], 1, torch.float64))
    runs = {}
    for eager in (False, True):
        scan = umbrella.make_ladder_scan(
            system, cbw, 0.0005, "NVT", n, friction=LADDER["friction"],
            temperature=LADDER["temperature"])
        scan.eager = eager
        batch = umbrella.seeded_window_states(ms, scan.system, cbw, atoms,
                                              centers, ladder=ladder)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, diag = scan(batch, ladder)
        torch.cuda.synchronize()
        runs[eager] = (out, diag, scan, time.perf_counter() - t0)
    (g, gd, gscan, tg), (e, ed, _, te) = runs[False], runs[True]
    caps = len(gscan.step_graphs.captures)
    dx = max(float((g.states[w].state.x - e.states[w].state.x).abs().max())
             for w in range(2))
    de = max(abs(float(g.states[w].kinetic + g.states[w].potential)
                 - float(e.states[w].kinetic + e.states[w].potential))
             for w in range(2))
    dcv = float((gd.cv - ed.cv).abs().max())
    means = gd.cv.mean(dim=1).tolist()
    log(f"  10b 2 windows x {n} NVT fp64 steps, graphed vs eager: max|dx| "
        f"{dx:.3e} A, |dEtot| {de:.3e} kJ/mol, max|dcv| {dcv:.3e}, mean cv "
        f"{means[0]:+.4f} / {means[1]:+.4f} A, {caps} captures, "
        f"{len(gscan.regrows)} regrows; {tg:.2f} s graphed, {te:.2f} s "
        f"eager")
    tol_x, tol_e = GRAPH_TOL["fp64"]
    check(not gd.capacities() and not ed.capacities(),
          "10b: a capacity flag stands")
    check(dx <= tol_x and de <= tol_e and dcv <= 1e-9,
          "10b: the graphed ladder differs from the eager one")
    check(means[1] - means[0] > 0.4, "10b: the windows' CV means do not "
                                     "differ")
    check(caps == 1 and not gscan.regrows,
          f"10b: {caps} captures for 2 windows, not one")


def phase_ladder_pmf():
    """Phase 10c: the full-width ladder through run_pmf (see the module
    docstring); returns the launch counts."""
    import math
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.run import umbrella_pmf
    from reactive_pb_nn_md_tpu_torch.utils.constants import KB
    build = umbrella_pmf.load_build(
        DECK / "in.gro", DECK / "ff.pmt", DECK / "top.top", DECK / "sim.pmt",
        state=EQ_STATE, device="cuda", precision="fp32")
    system = build[0]
    ke = []

    def run():
        torch.cuda.reset_peak_memory_stats()
        mem.append(torch.cuda.memory_allocated())
        res.append(umbrella_pmf.run_pmf(
            build, verbose=False,
            on_chunk=lambda batch, diag: ke.append(diag.kinetic), **LADDER))

    res, mem = [], []
    counts = main_path("10c ladder", run, FLAGSHIP_PATH,
                       ("A'", "A''", "D1", "D2"))
    out, batch, extra = res[0]
    cv, scan, atoms = extra["cv"], extra["scan"], extra["atoms"]
    W = LADDER["n_windows"]
    centers = np.asarray(out["centers"])
    steps = out["config"]["n_equil"], out["config"]["n_sample"]
    standing = [w for w, m in enumerate(batch.states)
                if integrators.overflowed(m)]
    dev_mean = np.abs(cv.mean(axis=1) - centers)
    host = np.array([window_cv(m.state.x, m.state.box, atoms)
                     for m in batch.states])
    dlast = float(np.abs(cv[:, -1] - host).max())
    kin = torch.cat(ke, dim=1).double()
    t_mean = float((2.0 * kin / (3.0 * system.n_atoms * KB)).mean())
    finite = int(np.isfinite(np.asarray(out["pmf_kjmol"], float)).sum())
    pool = sum(b for _, _, b in scan.step_graphs.captures) / 2 ** 20
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    before = mem[0] / 2 ** 20
    log(f"  10c depth cut: {steps[0]} + {steps[1]} steps a window "
        f"(run_bench_umbrella: 400 + 1200), {W} windows, chunk "
        f"{LADDER['chunk']}, fp32, cap {out['config']['evb_max_states']}, "
        f"triple {out['config']['atoms']}")
    log(f"  10c {out['aggregate_steps_per_s']} window-steps/s aggregate "
        f"(windows x steps / wall; the windows batched; the windows in "
        f"turn before the batch: 70.9), first chunk with the capture "
        f"{out['compile_s']} s, total {out['total_s']} s; "
        f"{len(scan.step_graphs.captures)} captures, graph pool "
        f"{pool:.1f} MiB, peak memory {peak:.1f} MiB ({before:.1f} MiB "
        f"held before the ladder); {out['hops_in_ladder']}"
        f" hops, overflow (regrown) {out['overflow']}: {scan.regrows}")
    log(f"  10c mean cv - center max {dev_mean.max():.4f} A (cv_mean "
        f"{out['cv_mean']}), last cv vs host max {dlast:.3e} A, mean T "
        f"{t_mean:.2f} K, WHAM converged {out['wham_converged']} with "
        f"{finite} finite bins of {len(out['pmf_kjmol'])}, barrier "
        f"{out['barrier_kjmol']} kJ/mol at xi {out['barrier_xi']}")
    check(not standing, f"10c: capacity flags stand in windows {standing}")
    check(bool(np.isfinite(cv).all()), "10c: a non-finite CV")
    check(bool((dev_mean <= 0.25).all()),
          f"10c: windows {np.flatnonzero(dev_mean > 0.25).tolist()} sit "
          f"more than 0.25 A from their centers")
    check(dlast <= 1e-5, "10c: the last cv differs from the host's")
    check(abs(t_mean - 300.0) <= 30.0 and math.isfinite(t_mean),
          f"10c: mean kinetic temperature {t_mean:.2f} K is not within "
          f"300 +- 30 K")
    check(out["wham_converged"] and finite >= 10,
          "10c: WHAM did not converge to >= 10 finite bins")
    return counts


def phase_replicas(tmp):
    """Phase 10d: bench.py run_bench_replicas' ensemble (see the module
    docstring)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md.simulation import Simulation
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    (tmp / "10d").mkdir()
    sim = Simulation(*deck_copy(
        tmp / "10d", DECK, "fp32",
        f"evb_max_states     {REPLICA_CAP}\n" + NVT_DECK), device="cuda")
    batch = ensemble.stack_replicas(sim.ms, REPLICAS, seed=7)
    batch.generators[-1] = batch.generators[0].clone()
    scan = ensemble.make_replica_scan(
        sim.system, sim.cbw, sim.cfg.delta_t, "NVT", REPLICA_STEPS,
        friction=0.1, temperature=300.0,
        hard_max_states=sim.cfg.evb_hard_max_states)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, diag = scan(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x = [m.state.x for m in out.states]
    apart = min(float((x[i] - x[j]).abs().max())
                for i in range(REPLICAS - 1) for j in range(i))
    same = float((x[0] - x[-1]).abs().max())
    caps = len(scan.step_graphs.captures)
    rate = REPLICAS * REPLICA_STEPS / wall
    log(f"  10d {REPLICAS} NVT replicas x {REPLICA_STEPS} fp32 steps of the "
        f"lattice deck, cap {REPLICA_CAP} no tier: {rate:.1f} "
        f"replica-steps/s aggregate, batched (in turn before the batch: "
        f"66.1; "
        f"{wall:.2f} s, the capture "
        f"included), min pairwise max|dx| {apart:.3e} A, the same generator "
        f"state {same:.3e} A, {caps} captures, regrows {scan.regrows}")
    check(not diag.capacities(), "10d: a capacity flag stands")
    check(apart > 1e-3, "10d: two replicas did not part")
    check(same <= 1e-4, "10d: replicas of one generator state differ")
    check(caps == 1 or scan.regrows, f"10d: {caps} captures, not one")


def phase_umbrella(tmp):
    """Phase 10 (see the module docstring): returns the ladder's launch
    counts."""
    t10 = time.perf_counter()
    phase_ladder_graphed(*phase_bias_force())
    counts = phase_ladder_pmf()
    phase_replicas(tmp)
    log(f"  phase 10: {time.perf_counter() - t10:.1f} s")
    return counts


def range_launches(n_ranges=4):
    """Phase 11's kernel checks: A over `n_ranges` cell ranges and B1
    over as many atom ranges at the equilibrated flagship, and D1 over as
    many atom ranges at the 10k lattice's shapes (K = 64, the deck's slab
    cap and SCAP_10K), each sum against the full launch (fp64): the max
    errors over max|full|, and whether a slab overflowed."""
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_slab, pme_spread
    from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp
    from reactive_pb_nn_md_tpu_torch.parallel.shard import AtomShard
    f = torch.float64
    system, state, topo, _, _, _ = flagship(torch.device("cuda"), f)
    cells, x, box = system.rs_cells, state.x, state.box
    slot, _ = rsp.bin_atoms(x, box, cells, system.real_space_cutoff)
    cm = rsp.pack_cells(x, topo.charge.to(f), topo.atom_type.to(f),
                        topo.atom_mol.to(f), slot, cells)
    args = (rsp.build_tabs(system, f), cells, box, system.real_space_cutoff,
            system.alpha_sqrt, system.has_sapt)
    full = rsp.pair_rows(cm, *args)
    parts = [rsp.pair_rows(cm, *args, cell_range=AtomShard(
        None, r, n_ranges).cells(cells)) for r in range(n_ranges)]
    a_err = float((sum(parts) - full).abs().max() / full.abs().max())
    a_bits = bool(torch.equal(sum(parts), full))
    K, order, N = system.pme_grid, system.spline_order, system.n_atoms
    q = topo.charge.to(f)
    grid = pme_spread.charge_grid(x, q, box, K, order)
    shares = [pme_spread.charge_grid(x[sh], q[sh], box, K, order)
              for sh in (AtomShard(None, r, n_ranges).atoms(N)
                         for r in range(n_ranges))]
    b_err = float((sum(shares) - grid).abs().max() / grid.abs().max())
    system, x, box, topo, _ = lattice_10k(torch.device("cuda"), f)
    K, order, N = system.pme_grid, system.spline_order, system.n_atoms
    q = topo.charge.to(f)
    d_err, d_over = 0.0, False
    for scap in (system.pme_scap, SCAP_10K):
        grid, over = pme_slab.charge_grid_slab(x, q, box, K, order, scap)
        d_over |= bool(over)
        total = torch.zeros_like(grid)
        for sh in (AtomShard(None, r, n_ranges).atoms(N)
                   for r in range(n_ranges)):
            g, over = pme_slab.charge_grid_slab(x[sh], q[sh], box, K, order,
                                                scap)
            d_over |= bool(over)
            total += g
        d_err = max(d_err, float((total - grid).abs().max()
                                 / grid.abs().max()))
    return a_err, a_bits, b_err, d_err, d_over


def phase_sharded(tmp):
    """Phase 11 (see the module docstring)."""
    import torch
    import torch.distributed as dist
    from reactive_pb_nn_md_tpu_torch.md import graphs, integrators
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    t11 = time.perf_counter()
    (tmp / "11").mkdir()
    dist.init_process_group("nccl", init_method="file://" + str(
        tmp / "11" / "store"), rank=0, world_size=1)
    try:
        mesh = ensemble.make_mesh(1, sp=1, device="cuda")
        sim = eq_sim(tmp / "11", torch.float64)
        system, cbw, dt, _, fr, temp = scan_args(sim, "NVE")
        sscan = ensemble.make_atom_sharded_scan(system, cbw, dt, "NVE",
                                                mesh, SHARD_STEPS)
        ref_graphs = graphs.StepGraphs()
        out = {}

        def sharded():
            out["s"] = sscan(sim.ms)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            return r, (time.perf_counter() - t0) / SHARD_STEPS * 1e3

        counts = main_path("11 sharded flagship scan, world size 1",
                           sharded, FLAGSHIP_PATH,
                           ("A'", "A''", "D1", "D2"))
        (g, gd), ref_ms = timed(lambda: integrators.md_scan(
            sim.ms, system, cbw, dt, "NVE", SHARD_STEPS, fr, temp,
            step_graphs=ref_graphs))
        (g, gd), ref_ms = timed(lambda: integrators.md_scan(
            sim.ms, system, cbw, dt, "NVE", SHARD_STEPS, fr, temp,
            step_graphs=ref_graphs))
        (s, sd), sh_ms = timed(lambda: sscan(sim.ms))
        s0, sd0 = out["s"]
        dx = float((s.state.x - g.state.x).abs().max())
        bits = bool(torch.equal(s.state.x, g.state.x))
        again = bool(torch.equal(s.state.x, s0.state.x))
        de = float(((sd.potential - gd.potential).abs()
                    / gd.potential.abs()).max())
        step = ensemble.make_atom_sharded_step(system, cbw, dt, "NVE", mesh)
        colls = ensemble.collective_summary(lambda: step(sim.ms))
        a_err, a_bits, b_err, d_err, d_over = range_launches()
        log(f"  11 {SHARD_STEPS} graphed fp64 NVE flagship steps sharded "
            f"(world size 1, nccl) vs unsharded: max|dx| {dx:.3e} A, bits "
            f"equal {bits}, two sharded chunks equal {again}, potential "
            f"rel {de:.3e}, {int(sd.hopped.sum())} hops; {sh_ms:.2f} ms a "
            f"step sharded, {ref_ms:.2f} unsharded; captures "
            f"{len(sscan.step_graphs.captures)}; collectives a step "
            f"{colls}; A over 4 cell ranges vs full {a_err:.3e} (bits "
            f"equal {a_bits}), B1 over 4 atom ranges vs full {b_err:.3e}, "
            f"D1 over 4 atom ranges vs full (10k, the deck's slab cap and "
            f"{SCAP_10K}) {d_err:.3e}; launches {counts}")
        check(not sd.capacities() and not gd.capacities()
              and not sd0.capacities(), "11: a capacity flag stands")
        check(dx <= SHARD_DX, f"11: sharded and unsharded scans differ by "
              f"{dx} A")
        check(de <= 1e-10, f"11: potentials differ by {de} (relative)")
        check(colls["by_name"] == {"grid": 1, "energy": 1, "force": 1,
                                   "flags": 1},
              f"11: the collectives of a step are {colls}")
        check(a_err <= RANGE_TOL and b_err <= RANGE_TOL
              and d_err <= RANGE_TOL,
              "11: a range launch does not sum to the full launch")
        check(not d_over, "11: a slab overflowed in D1's range check")
        bad = {k: counts.get(k, 0) for k in FLAGSHIP_KERNELS
               if counts.get(k, 0) < SHARD_STEPS}
        check(not bad, f"11: launches {bad}, fewer than {SHARD_STEPS}")
    finally:
        dist.destroy_process_group()
    log(f"  phase 11: {time.perf_counter() - t11:.1f} s")
    return counts


# ---- phase 12: the replica batch (integrators.batched_md_scan)

def batch_cases(dtype, W, seed=12):
    """Per kernel of the flagship path: (batched fn, the batch's direct
    launch (no vmap), one replica's launch fn(w), per-replica bytes and
    operations, whether its work is GEMMs) for W replicas at the
    flagship's shapes: W copies of the equilibrated state moved by
    0.02 A, S = 80, K = 32; the batched fn is the op under torch.func.vmap
    (its batching rule), with the inputs a batch shares unbatched."""
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.ops import ground_state as gs
    from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_spread as sp
    from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp
    from reactive_pb_nn_md_tpu_torch.ops.kernels import recip_perstate as rp
    from reactive_pb_nn_md_tpu_torch.utils import pbc
    vmap = torch.func.vmap
    dev = torch.device("cuda")
    system, state, topo, _, cbw, _ = flagship(dev, dtype)
    rng = np.random.default_rng(seed)
    xs = [state.x + torch.tensor(rng.normal(scale=0.02, size=state.x.shape),
                                 dtype=dtype, device=dev) for _ in range(W)]
    box, f = state.box, dtype
    cells, K, order = system.rs_cells, system.pme_grid, system.spline_order
    rc, alpha, sapt = (system.real_space_cutoff, system.alpha_sqrt,
                       system.has_sapt)
    tabs = rsp.build_tabs(system, f)
    cms = torch.stack([rsp.pack_cells(
        x, topo.charge.to(f), topo.atom_type.to(f), topo.atom_mol.to(f),
        rsp.bin_atoms(x, box, cells, rc)[0], cells) for x in xs])
    n = state.x.shape[0]
    n_pairs = pairs_within(xs[0], box, topo.atom_mol, rc)
    cases = {"A": (
        lambda: vmap(lambda c: rsp.pair_rows(c, tabs, list(cells), box, rc,
                                             alpha, sapt))(cms),
        lambda: rsp.pair_rows_cuda(cms, tabs, cells, box, rc, alpha, sapt,
                                   nb=W),
        lambda w: rsp.pair_rows(cms[w], tabs, cells, box, rc, alpha, sapt),
        2 * nbytes(cms[0]) + nbytes(tabs, box), FLOP_PAIR * n_pairs, False)}
    spl = [sp.spline_setup(x, box, K, order) for x in xs]
    ws, dws, nps = (torch.stack([s[i] for s in spl]) for i in range(3))
    q = topo.charge.contiguous()
    cases["B1"] = (
        lambda: vmap(lambda a, b: sp.spread(a, b, q, K))(ws, nps),
        lambda: sp.spread_cuda(ws, nps, q, K, nb=W),
        lambda w: sp.spread(ws[w], nps[w], q, K),
        nbytes(ws[0], nps[0], q) + K ** 3 * ws.element_size(),
        4 * n * order ** 3, False)
    gQ = torch.tensor(rng.standard_normal((W, K ** 3)), dtype=f, device=dev)
    recip = pbc.recip_vectors(box).contiguous()
    cases["B2"] = (
        lambda: torch.cat([t.reshape(W, -1) for t in vmap(
            lambda g, a, b, c: sp.gather(g, a, b, c, q, recip, K))(
                gQ, ws, dws, nps)], 1),
        lambda: sp.gather_cuda(gQ, ws, dws, nps, q, recip, K, nb=W),
        lambda w: torch.cat([t.reshape(-1) for t in sp.gather(
            gQ[w], ws[w], dws[w], nps[w], q, recip, K)]),
        nbytes(gQ[0], ws[0], dws[0], nps[0], q, recip) + 4 * n
        * ws.element_size(), 16 * n * order ** 3, False)
    S = 80
    ins = [perstate_inputs(x, box, topo, system, cbw, S, rng) for x in xs]
    bat = [torch.stack([i[k] for i in ins]) for k in range(7)]
    cbw2 = ins[0][7]
    gbar = torch.tensor(rng.standard_normal((W, S)), dtype=f, device=dev)
    U, Mh = 4 * S, K * (K // 2 + 1)
    gemm = 8.0 * S * K * U * Mh
    cases["C1"] = (
        lambda: vmap(rp.perstate_fwd, in_dims=(0,) * 7 + (None,))(*bat,
                                                                  cbw2),
        lambda: rp.perstate_fwd_cuda(*bat, cbw2, nb=W),
        lambda w: rp.perstate_fwd(*ins[w]),
        nbytes(*ins[0]) + S * gbar.element_size(), gemm, True)
    cases["C2"] = (
        lambda: torch.cat([t.reshape(W, -1) for t in vmap(
            rp.perstate_bwd, in_dims=(0,) * 8 + (None,))(gbar, *bat,
                                                          cbw2)], 1),
        lambda: rp.perstate_bwd_cuda(gbar, *bat, cbw2, nb=W),
        lambda w: torch.cat([t.reshape(-1) for t in rp.perstate_bwd(
            gbar[w], *ins[w])]),
        nbytes(gbar[0], *ins[0]) + nbytes(*ins[0][:7]), 3 * gemm, True)
    Hs = torch.stack([torch.tensor(evb_like(S, 60, rng), dtype=f,
                                   device=dev) for _ in range(W)])
    cases["E"] = (
        lambda: torch.cat([t.reshape(W, -1).to(f) for t in vmap(
            gs.ground_state_op)(Hs)], 1),
        lambda: gs.ground_state_cuda(Hs, W),
        lambda w: torch.cat([t.reshape(-1).to(f) for t in
                             gs.ground_state_op(Hs[w])]),
        nbytes(Hs[0]) + (S + 1) * Hs.element_size(),
        4.0 / 3.0 * S ** 3, False)
    return cases


def batch_cases_10k(dtype, W, seed=16):
    """batch_cases for the kernels of the 10k path's cell sweep and slab
    spread (A', A'', D1, D2): W copies of the examples/water_10k/ lattice
    moved by 0.02 A, its cells (10, 10, 10, 24), K = 64, the deck's slab
    cap; the tables, box and charges shared by the batch."""
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_slab as sl
    from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_spread as sp
    from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp
    vmap = torch.func.vmap
    dev = torch.device("cuda")
    system, x, box, topo, _ = lattice_10k(dev, dtype)
    rng = np.random.default_rng(seed)
    xs = [x + torch.tensor(rng.normal(scale=0.02, size=x.shape),
                           dtype=dtype, device=dev) for _ in range(W)]
    f, n = dtype, x.shape[0]
    cells, K, order = system.rs_cells, system.pme_grid, system.spline_order
    scap = system.pme_scap
    rc, alpha, sapt = (system.real_space_cutoff, system.alpha_sqrt,
                       system.has_sapt)
    tabs = rsp.build_tabs(system, f)
    packed = [rsp.bin_atoms(xx, box, cells, rc) for xx in xs]
    check(not any(bool(o) for _, o in packed),
          "12d: a moved lattice overflows kernel A's cells")
    cms = torch.stack([rsp.pack_cells(
        xx, topo.charge.to(f), topo.atom_type.to(f), topo.atom_mol.to(f),
        slot, cells) for xx, (slot, _) in zip(xs, packed)])
    n_pairs = pairs_within(xs[0], box, topo.atom_mol, rc)
    cases = {}
    for impl in ("half", "column"):
        cases[rsp.KERNEL_OF[impl]] = (
            lambda impl=impl: vmap(lambda c: rsp.pair_rows(
                c, tabs, list(cells), box, rc, alpha, sapt, impl))(cms),
            lambda impl=impl: rsp.pair_rows_half_cuda(
                cms, tabs, cells, box, rc, alpha, sapt,
                column=impl == "column", nb=W),
            lambda w, impl=impl: rsp.pair_rows(cms[w], tabs, cells, box, rc,
                                               alpha, sapt, impl),
            2 * nbytes(cms[0]) + nbytes(tabs, box), FLOP_PAIR * n_pairs,
            False)
    spl = [sp.spline_setup(xx, box, K, order) for xx in xs]
    ws, dws, nps = (torch.stack([s[i] for s in spl]) for i in range(3))
    bins = [sl.slab_bins(nps[w], K, order, scap) for w in range(W)]
    check(not any(bool(b[2]) for b in bins),
          "12d: a moved lattice overflows the slab cap")
    rows = torch.stack([b[1] for b in bins])
    q = topo.charge.contiguous()
    cases["D1"] = (
        lambda: vmap(lambda a, b, r: sl.spread_slab(a, b, q, r, K, scap))(
            ws, nps, rows),
        lambda: sl.spread_slab_cuda(ws, nps, q, rows, K, scap, nb=W),
        lambda w: sl.spread_slab(ws[w], nps[w], q, rows[w], K, scap),
        nbytes(ws[0], nps[0], q, rows[0]) + K ** 3 * ws.element_size(),
        4 * n * order ** 3, False)
    gQ = torch.tensor(rng.standard_normal((W, K ** 3)), dtype=f, device=dev)
    cases["D2"] = (
        lambda: vmap(lambda g, a, b, c, r: sl.interp_slab(
            g, a, b, c, r, K, scap))(gQ, ws, dws, nps, rows),
        lambda: sl.interp_slab_cuda(gQ, ws, dws, nps, rows, K, scap, nb=W),
        lambda w: sl.interp_slab(gQ[w], ws[w], dws[w], nps[w], rows[w], K,
                                 scap),
        nbytes(gQ[0], ws[0], dws[0], nps[0], rows[0])
        + K * scap * 4 * ws.element_size(), 16 * n * order ** 3, False)
    return cases


def phase_batch_kernels(W, timed=None, cases=batch_cases, label="12a"):
    """Phase 12a (12d with cases=batch_cases_10k): each kernel's batched
    launch (the op's batching rule under torch.func.vmap) against W
    single launches, fp64 and fp32: one launch a batched call, max
    |batched - singles| over max |singles| (fp64 <= BATCH_TOL), whether
    the bits are equal.  With `timed` (a dict), the W = 16 times go
    there: the batch's direct launch against 16 single launches by
    cuda_ms and graphed_device_ms, and W times a single launch's bound."""
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        for name, (bat, direct, one, n_b, n_op, gemm) in cases(
                dtype, W).items():
            _build.launches.clear()
            got = bat()
            n_launch = _build.launches[name]
            _build.launches.clear()
            ref = torch.stack([one(w) for w in range(W)])
            singles = _build.launches[name]
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max()) / max(scale, 1e-300)
            bits = bool(torch.equal(got, ref))
            line = (f"  {label} {name} {tag} W={W}: {n_launch} launch batched "
                    f"({singles} single), max|batched - singles| / "
                    f"max|singles| {err:.3e}, bits equal {bits}")
            if timed is not None:
                t = dict(ms=cuda_ms(direct),
                         single_ms=cuda_ms(lambda: [one(w)
                                                    for w in range(W)]),
                         device_ms=graphed_device_ms(direct, n=8, reps=7),
                         single_device_ms=graphed_device_ms(
                             lambda: [one(w) for w in range(W)], n=8,
                             reps=7),
                         bound_ms=bound(W * n_b, W * n_op, tag, gemm)[0])
                timed.setdefault(tag, {})[name] = t
                line += (f"; cuda_ms {fmt(t['ms'])} against {W} singles "
                         f"{fmt(t['single_ms'])}, device "
                         f"{fmt(t['device_ms'])} against "
                         f"{fmt(t['single_device_ms'])}, bound "
                         f"{fmt(t['bound_ms'])}")
            log(line)
            check(n_launch == 1 and singles == W,
                  f"{label}: {name} launched {n_launch} times for a batch")
            check(err <= (BATCH_TOL if tag == "fp64" else 1e-5),
                  f"{label}: {name} ({tag}) batched differs from {W} "
                  f"singles")


def batch_windows(dtype, W, ensemble_name):
    """(system, cbw, the W-window ladder, the seeded batch) of a W-window
    ladder on the equilibrated flagship (phase 10's restraint, centers
    in [-0.4, 0.4])."""
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble, umbrella
    system, state, topo, meta, cbw, _ = flagship(torch.device("cuda"),
                                                 dtype)
    system = ensemble._no_tier(system)
    ms = integrators.initial_md_state(state, topo, system, cbw,
                                      meta["capacity"],
                                      react_cap=meta["react_cap"])
    atoms = umbrella.transfer_triple(ms, system)
    centers = np.linspace(-0.4, 0.4, W)
    ladder = (umbrella.make_ladder(atoms, centers, LADDER["k_spring"], 0,
                                   dtype),
              umbrella.make_ladder(atoms, np.full(W, LADDER["r_oo"]),
                                   LADDER["k_roo"], 1, dtype))
    batch = umbrella.seeded_window_states(ms, system, cbw, atoms, centers,
                                          ladder=ladder)
    return system, cbw, ladder, batch


def phase_batch_graphed():
    """Phase 12b: W = BATCH_W windows x BATCH_STEPS graphed fp64 flagship
    steps, batched (one capture for all) against in turn (ReplicaScan,
    the reference), NVE and NVT: per window max |dx| and |dEtot| within
    GRAPH_TOL fp64; each kernel launches once a batched step (BATCH_STEPS
    + the capture's warm-up) against W a step in turn."""
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    W, n = BATCH_W, BATCH_STEPS
    tol_x, tol_e = GRAPH_TOL["fp64"]
    for ens in ("NVE", "NVT"):
        system, cbw, ladder, batch = batch_windows(torch.float64, W, ens)
        runs = {}
        for cls in (ensemble.ReplicaScan, ensemble.BatchedReplicaScan):
            scan = cls(system, cbw, 0.0005, ens, n,
                       friction=LADDER["friction"],
                       temperature=LADDER["temperature"])
            _build.launches.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, diag = scan(batch, ladder)
            torch.cuda.synchronize()
            runs[cls.__name__] = (out, diag, scan, Counter(_build.launches),
                                  time.perf_counter() - t0)
        (t, td, _, tl, tt), (b, bd, bscan, bl, bt) = (
            runs["ReplicaScan"], runs["BatchedReplicaScan"])
        dx = max(float((t.states[w].state.x - b.states[w].state.x).abs()
                       .max()) for w in range(W))
        de = max(abs(float(t.states[w].kinetic + t.states[w].potential)
                     - float(b.states[w].kinetic + b.states[w].potential))
                 for w in range(W))
        caps = len(bscan.step_graphs.captures)
        log(f"  12b {W} windows x {n} {ens} fp64 steps, batched vs in "
            f"turn: max|dx| {dx:.3e} A, max|dEtot| {de:.3e} kJ/mol, "
            f"launches batched {dict(bl)} / in turn {dict(tl)}, "
            f"{caps} captures; {bt:.2f} s batched, {tt:.2f} s in turn "
            f"(the captures included)")
        check(not td.capacities() and not bd.capacities(),
              "12b: a capacity flag stands")
        check(dx <= tol_x and de <= tol_e,
              f"12b: the batched {ens} windows differ from in turn")
        check(all(bl[k] == n + 1 and tl[k] == W * n + 1
                  for k in FLAGSHIP_KERNELS),
              f"12b: not one launch a batched step: {dict(bl)}")
        check(caps == 1, f"12b: {caps} captures for one batch")


def phase_batch_rates():
    """Phase 12c: fp32 flagship NVT window-steps/s, batched against in
    turn, at W = 1, 4 and 16 in one call (a chunk of BATCH_RATE_STEPS,
    timed after a first chunk that holds the capture); the device ms and
    device ops of a batched step and of a window's step in turn (at W =
    1; tools/profile_step.py's profiled_chunk), the graph pool MiB and
    the peak memory.  Printed, not gated."""
    import torch
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    prof = tool("profile_step")
    n = BATCH_RATE_STEPS
    res = {}
    for W in BATCH_RATE_W:
        system, cbw, ladder, batch = batch_windows(torch.float32, W, "NVT")
        for cls in (ensemble.ReplicaScan, ensemble.BatchedReplicaScan):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            # a first short chunk holds the capture
            scan = cls(system, cbw, 0.0005, "NVT", 4,
                       friction=LADDER["friction"],
                       temperature=LADDER["temperature"])
            out, _ = scan(batch, ladder)
            scan.n_steps = n
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, diag = scan(out, ladder)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            r = dict(rate=W * n / wall,
                     pool_mib=sum(b for _, _, b in
                                  scan.step_graphs.captures) / 2 ** 20,
                     peak_mib=(torch.cuda.max_memory_allocated() - held)
                     / 2 ** 20, captures=len(scan.step_graphs.captures))
            # device ms and ops a step of the batch; in turn a window's
            # step, the same at any W: profiled at W = 1 only
            if cls is ensemble.BatchedReplicaScan or W == 1:
                scan.n_steps = 8
                r["device_ms"], r["ops"] = prof.profiled_chunk(
                    lambda: scan(out, ladder), 8)
            res[(W, cls.__name__)] = r
            check(not diag.capacities(), "12c: a capacity flag stands")
        b, t = res[(W, "BatchedReplicaScan")], res[(W, "ReplicaScan")]
        one = res[(BATCH_RATE_W[0], "ReplicaScan")]
        log(f"  12c W={W}: {b['rate']:.2f} window-steps/s batched against "
            f"{t['rate']:.2f} in turn ({b['rate'] / t['rate']:.2f}x); "
            f"batched step: {b['device_ms']:.3f} device ms, "
            f"{b['ops']:.0f} device ops (a window's step in turn: "
            f"{one['device_ms']:.3f} ms, {one['ops']:.0f} ops); graph pool "
            f"{b['pool_mib']:.1f} "
            f"MiB batched / {t['pool_mib']:.1f} in turn, peak memory "
            f"{b['peak_mib']:.1f} / {t['peak_mib']:.1f} MiB over what was "
            f"held, {b['captures']} / {t['captures']} captures")
    return res


def batch_lattice(tmp, dtype):
    """(system, cbw, cfg, ms) of the examples/water_10k/ lattice with the
    CLI's seeded velocities, at the slab cap SCAP_10K and with no small
    tier (a replica batch's system)."""
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    sim = lattice_sim(tmp, dtype)
    system = ensemble._no_tier(sim.system).replace(pme_scap=SCAP_10K)
    nl = sim.ms.nlist
    ms = integrators.initial_md_state(
        sim.ms.state, sim.ms.topo, system, sim.cbw, nl.capacity, nl.cells,
        react_cap=nl.react_cap or None, react_cells=nl.react_cells or None)
    check(not integrators.overflowed(ms), "12e: the 10k lattice's set-up "
                                          "overflows")
    return system, sim.cbw, sim.cfg, ms


def batch_counts(counts, W, n, regrows, batched):
    """Whether each kernel of the 10k path launched as a chunk of n steps
    of W replicas should: batched, n + 1 (the replays and the capture's
    warm-up) a run of the chunk, and each regrow W more (every replica
    set up again) and a run more; in turn W n + 1 with no regrow (a
    regrow stops the run at the first replica flagged: not gated)."""
    want = ((n + 1) * (1 + regrows) + W * regrows if batched
            else W * n + 1 if not regrows else None)
    return all(want is None or counts.get(k, 0) == want
               for k in TENK_KERNELS)


def phase_batch_10k(tmp):
    """Phase 12e: BATCH_W replicas x TENK_BATCH_STEPS graphed fp64 NVT
    steps of the 10k lattice (from SCAP_10K), batched against in turn
    (ReplicaScan): per replica max |dx| and |dEtot| within GRAPH_TOL fp64;
    the launch counts of batch_counts.  Then a BATCH_W-window fp32 10k
    ladder (phase 10's restraints, centers in [-0.4, 0.4]) through
    make_ladder_scan, TENK_BATCH_STEPS steps: every CV finite, the same
    launch counts."""
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble, umbrella
    W, n = BATCH_W, TENK_BATCH_STEPS
    tol_x, tol_e = GRAPH_TOL["fp64"]
    system, cbw, cfg, ms = batch_lattice(tmp / "12e", torch.float64)
    batch = ensemble.stack_replicas(ms, W, seed=16)
    runs = {}
    for cls in (ensemble.ReplicaScan, ensemble.BatchedReplicaScan):
        scan = cls(system, cbw, cfg.delta_t, "NVT", n, friction=1.0,
                   temperature=300.0)
        _build.launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, diag = scan(batch)
        torch.cuda.synchronize()
        runs[cls.__name__] = (out, diag, scan, dict(_build.launches),
                              time.perf_counter() - t0)
    (t, td, tscan, tl, tt), (b, bd, bscan, bl, bt) = (
        runs["ReplicaScan"], runs["BatchedReplicaScan"])
    dx = max(float((t.states[w].state.x - b.states[w].state.x).abs().max())
             for w in range(W))
    de = max(abs(float(t.states[w].kinetic + t.states[w].potential)
                 - float(b.states[w].kinetic + b.states[w].potential))
             for w in range(W))
    caps = len(bscan.step_graphs.captures)
    log(f"  12e {W} replicas x {n} NVT fp64 steps of the 10k lattice, "
        f"batched vs in turn: max|dx| {dx:.3e} A, max|dEtot| {de:.3e} "
        f"kJ/mol; launches batched {bl} / in turn {tl}; {caps} / "
        f"{len(tscan.step_graphs.captures)} captures, regrows batched "
        f"{bscan.regrows} / in turn {tscan.regrows}; {bt:.2f} s batched, "
        f"{tt:.2f} s in turn (the captures included)")
    check(not td.capacities() and not bd.capacities(),
          "12e: a capacity flag stands")
    check(dx <= tol_x and de <= tol_e,
          "12e: the batched 10k replicas differ from in turn")
    check(batch_counts(bl, W, n, bscan.n_regrows, True)
          and batch_counts(tl, W, n, tscan.n_regrows, False),
          f"12e: not one launch a batched step: {bl} / {tl}")
    check(caps == 1 + bscan.n_regrows, f"12e: {caps} captures")

    f = torch.float32
    system, cbw, cfg, ms = batch_lattice(tmp / "12e_ladder", f)
    atoms = umbrella.transfer_triple(ms, system)
    centers = np.linspace(-0.4, 0.4, W)
    ladder = (umbrella.make_ladder(atoms, centers, LADDER["k_spring"], 0, f),
              umbrella.make_ladder(atoms, np.full(W, LADDER["r_oo"]),
                                   LADDER["k_roo"], 1, f))
    scan = umbrella.make_ladder_scan(system, cbw, cfg.delta_t, "NVT", n,
                                     friction=LADDER["friction"],
                                     temperature=LADDER["temperature"])
    windows = umbrella.seeded_window_states(ms, scan.system, cbw, atoms,
                                            centers, r_oo=LADDER["r_oo"],
                                            ladder=ladder)
    _build.launches.clear()
    t0 = time.perf_counter()
    _, diag = scan(windows, ladder)
    wall = time.perf_counter() - t0
    lc = dict(_build.launches)
    cv = diag.cv.double()
    log(f"  12e {W}-window fp32 10k ladder x {n} steps (make_ladder_scan): "
        f"cv means {[round(float(c), 3) for c in cv.mean(1)]}, launches "
        f"{lc}, {len(scan.step_graphs.captures)} captures, regrows "
        f"{scan.regrows}, {wall:.2f} s (the capture included)")
    check(not diag.capacities(), "12e: a ladder capacity flag stands")
    check(bool(torch.isfinite(cv).all()), "12e: a window's CV is not "
                                          "finite")
    check(batch_counts(lc, W, n, scan.n_regrows, True),
          f"12e: the ladder's launches {lc}")


def phase_batch_rates_10k(tmp):
    """Phase 12f: fp32 10k lattice NVT replica-steps/s, batched against in
    turn, at W = 1, 4 and 16 (TENK_BATCH_STEPS steps timed after a first
    4-step chunk that holds the capture); the device ms and device ops of
    a batched step (tools/profile_step.py profiled_chunk), the graph pool
    MiB, the peak memory and the captures inside the timed window (a
    window that holds one is not a steady rate: it says so).  Printed,
    not gated; a W whose batch does not fit the card's memory says so."""
    import torch
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    prof = tool("profile_step")
    n = TENK_BATCH_STEPS
    system, cbw, cfg, ms = batch_lattice(tmp / "12f", torch.float32)
    res = {}
    for W in BATCH_RATE_W:
        batch = ensemble.stack_replicas(ms, W, seed=17)
        for cls in (ensemble.ReplicaScan, ensemble.BatchedReplicaScan):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            scan = cls(system, cbw, cfg.delta_t, "NVT", 4, friction=1.0,
                       temperature=300.0)
            try:
                out, _ = scan(batch)
                scan.n_steps = n
                before = len(scan.step_graphs.captures)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, diag = scan(out)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            except torch.cuda.OutOfMemoryError as e:
                log(f"  12f W={W} {cls.__name__}: does not fit the card's "
                    f"memory ({str(e).splitlines()[0]})")
                res[(W, cls.__name__)] = None
                del scan
                torch.cuda.empty_cache()
                continue
            r = dict(rate=W * n / wall,
                     pool_mib=sum(b for _, _, b in
                                  scan.step_graphs.captures) / 2 ** 20,
                     peak_mib=(torch.cuda.max_memory_allocated() - held)
                     / 2 ** 20,
                     captures=len(scan.step_graphs.captures),
                     in_window=len(scan.step_graphs.captures) - before,
                     flags=diag.capacities(), regrows=scan.n_regrows)
            if cls is ensemble.BatchedReplicaScan or W == 1:
                scan.n_steps = 8
                r["device_ms"], r["ops"] = prof.profiled_chunk(
                    lambda: scan(out), 8)
            res[(W, cls.__name__)] = r
            del scan, out
        b, t = res[(W, "BatchedReplicaScan")], res[(W, "ReplicaScan")]
        if b is None or t is None:
            continue
        steady = ("steady" if not b["in_window"] and not t["in_window"]
                  else f"NOT steady: {b['in_window']} / {t['in_window']} "
                       f"captures inside the timed window")
        log(f"  12f W={W}: {b['rate']:.2f} replica-steps/s batched against "
            f"{t['rate']:.2f} in turn ({b['rate'] / t['rate']:.2f}x, "
            f"{steady}); batched step: {b['device_ms']:.3f} device ms, "
            f"{b['ops']:.0f} device ops; graph pool {b['pool_mib']:.1f} MiB "
            f"batched / {t['pool_mib']:.1f} in turn, peak memory "
            f"{b['peak_mib']:.1f} / {t['peak_mib']:.1f} MiB over what was "
            f"held, {b['captures']} / {t['captures']} captures, regrows "
            f"{b['regrows']} / {t['regrows']}, flags standing "
            f"{b['flags']} / {t['flags']}")
    return res


# ---- phase 13: the replica batch under a shard (one vmapped step shared
# over the ranks of an atoms group)

def phase_batch_shard_graphed(tmp):
    """Phase 13a: BATCH_W flagship windows (phase 12b's restraints) x
    SHARD_BATCH_STEPS graphed fp64 NVT steps through BatchedReplicaScan
    with an AtomShard of size 1 (nccl), launch and collective counts from
    0, against BatchedReplicaScan unsharded from the same states and
    generators: max |dx| <= SHARD_DX, whether the bits are equal, one
    capture, each kernel of the flagship path SHARD_BATCH_STEPS + 1
    launches (the replays and the capture's warm-up), each collective as
    many, the captured step's collectives the four once each.  Returns
    the sharded batch's launch counts."""
    import torch
    import torch.distributed as dist
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    from reactive_pb_nn_md_tpu_torch.parallel import ensemble
    from reactive_pb_nn_md_tpu_torch.parallel.shard import STEP_COLLECTIVES
    W, n = BATCH_W, SHARD_BATCH_STEPS
    dist.init_process_group("nccl", init_method="file://" + str(
        tmp / "store"), rank=0, world_size=1)
    try:
        mesh = ensemble.make_mesh(1, sp=1, device="cuda")
        shard = ensemble.atom_sharding(mesh)
        system, cbw, ladder, batch = batch_windows(torch.float64, W, "NVT")
        runs = {}
        for sh in (shard, None):
            scan = ensemble.BatchedReplicaScan(
                system, cbw, 0.0005, "NVT", n, friction=LADDER["friction"],
                temperature=LADDER["temperature"], shard=sh)

            def run():
                _build.collectives.clear()
                runs[sh is None] = (*scan(batch, ladder), scan,
                                    dict(_build.collectives))

            counts = main_path(f"13a {W} windows x {n} fp64 NVT steps "
                               f"batched, shard {sh}", run, FLAGSHIP_PATH,
                               ("A'", "A''", "D1", "D2"))
            if sh is not None:
                sharded_counts = counts
    finally:
        dist.destroy_process_group()
    (s, sd, sscan, scoll), (u, ud, _, ucoll) = runs[False], runs[True]
    dx = max(float((s.states[w].state.x - u.states[w].state.x).abs().max())
             for w in range(W))
    bits = all(torch.equal(s.states[w].state.x, u.states[w].state.x)
               for w in range(W))
    caps = len(sscan.step_graphs.captures)
    graph_colls = [dict(g.collectives)
                   for g in sscan.step_graphs.graphs.values()]
    log(f"  13a {W} windows x {n} graphed fp64 NVT steps, batched under a "
        f"shard of size 1 (nccl) vs batched unsharded: max|dx| {dx:.3e} A, "
        f"bits equal {bits}; {caps} captures, collectives of the run "
        f"{scoll} (unsharded {ucoll}), of a captured step {graph_colls}; "
        f"launches {sharded_counts}")
    check(not sd.capacities() and not ud.capacities(),
          "13a: a capacity flag stands")
    check(dx <= SHARD_DX, f"13a: the batch under the shard and the "
                          f"unsharded batch differ by {dx} A")
    check(caps == 1, f"13a: {caps} captures for one batch")
    check(graph_colls == [STEP_COLLECTIVES],
          f"13a: the captured batched step issues {graph_colls}")
    check(scoll == {k: n + 1 for k in STEP_COLLECTIVES} and not ucoll,
          f"13a: collectives {scoll} / {ucoll}")
    bad = {k: sharded_counts.get(k, 0) for k in FLAGSHIP_KERNELS
           if sharded_counts.get(k, 0) != n + 1}
    check(not bad, f"13a: launches {bad}, not {n + 1}")
    return sharded_counts


def phase_batch_shard_ranges(W=BATCH_W, n_ranges=SHARD_BATCH_RANGES,
                             seed=13):
    """Phase 13b: the kernels a shard runs on its share, batched: each
    share's launch under torch.func.vmap over W replicas (one launch for
    all W), summed over `n_ranges` shares, against the batched launch of
    the whole, fp64: A over the flagship's 64 cells in ranges (its range
    launch), A'' over the 10k lattice's cells (all cells swept, each
    range's rows kept: _in_range), B1 spreading the flagship's atom
    slices, D1 the 10k lattice's (K = 64, SCAP_10K).  The replicas are
    the state moved by 0.02 A.  Returns {kernel: max error over max
    |whole|}."""
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.ops.kernels import _build
    from reactive_pb_nn_md_tpu_torch.ops.kernels import pme_slab, pme_spread
    from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp
    from reactive_pb_nn_md_tpu_torch.parallel.shard import AtomShard
    vmap = torch.func.vmap
    f, dev = torch.float64, torch.device("cuda")
    rng = np.random.default_rng(seed)
    shards = [AtomShard(None, r, n_ranges) for r in range(n_ranges)]

    def moved(x):
        return torch.stack([x + torch.tensor(
            rng.normal(scale=0.02, size=x.shape), dtype=f, device=dev)
            for _ in range(W)])

    def held(name, kernel, whole, part):
        """Each call one launch of `kernel`; the shares' sum against the
        whole."""
        _build.launches.clear()
        ref = whole()
        got = sum(part(sh) for sh in shards)
        launches = _build.launches[kernel]
        err = float((got - ref).abs().max() / ref.abs().max())
        log(f"  13b {name} W={W}: {n_ranges} shares batched, summed, vs "
            f"the batched whole launch: {err:.3e} of max|whole|, bits "
            f"equal {bool(torch.equal(got, ref))}; {launches} launches "
            f"for {n_ranges + 1} batched calls")
        check(err <= RANGE_TOL, f"13b: {name}'s shares do not sum to the "
                                f"whole ({err})")
        check(launches == n_ranges + 1,
              f"13b: {name} launched {launches} times for "
              f"{n_ranges + 1} batched calls")
        return err

    errs = {}
    for deck in ("flagship", "10k"):
        if deck == "flagship":
            system, state, topo, _, _, _ = flagship(dev, f)
            x, box = state.x, state.box
            pair, spread = "A", "B1"
        else:
            system, x, box, topo, _ = lattice_10k(dev, f)
            pair, spread = "A''", "D1"
        xs = moved(x)
        cells, rc = system.rs_cells, system.real_space_cutoff
        impl = rsp._impl_for(cells)
        check(rsp.KERNEL_OF[impl] == pair, f"13b: {deck} sweeps with "
                                           f"{rsp.KERNEL_OF[impl]}")
        tabs = rsp.build_tabs(system, f)
        packed = [rsp.bin_atoms(xx, box, cells, rc) for xx in xs]
        check(not any(bool(o) for _, o in packed),
              f"13b: a moved {deck} box overflows kernel A's cells")
        cms = torch.stack([rsp.pack_cells(
            xx, topo.charge.to(f), topo.atom_type.to(f), topo.atom_mol.to(f),
            slot, cells) for xx, (slot, _) in zip(xs, packed)])

        def rows(cell_range=None):
            return vmap(lambda c: rsp.pair_rows(
                c, tabs, list(cells), box, rc, system.alpha_sqrt,
                system.has_sapt, impl, cell_range))(cms)

        errs[pair] = held(f"{pair} ({deck}, cells {cells})", pair, rows,
                          lambda sh: rows(list(sh.cells(cells))))
        K, order, N = system.pme_grid, system.spline_order, system.n_atoms
        scap = 0 if deck == "flagship" else SCAP_10K
        q = topo.charge.to(f)

        def grid(a):
            if scap:
                return vmap(lambda xx: pme_slab.charge_grid_slab(
                    xx[a], q[a], box, K, order, scap)[0])(xs)
            return vmap(lambda xx: pme_spread.charge_grid(
                xx[a], q[a], box, K, order))(xs)

        if scap:
            over = [bool(pme_slab.charge_grid_slab(xx[sh.atoms(N)],
                                                   q[sh.atoms(N)], box, K,
                                                   order, scap)[1])
                    for xx in xs for sh in shards]
            check(not any(over), "13b: a slab overflowed")
        errs[spread] = held(f"{spread} ({deck}, K {K}, scap {scap})",
                            spread, lambda: grid(slice(None)),
                            lambda sh: grid(sh.atoms(N)))
    return errs


def phase_batch_shard():
    """Phase 13 (see the module docstring): the sharded batch's launch
    counts."""
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_batch_shard_graphed(pathlib.Path(tmp))
    phase_batch_shard_ranges()
    log(f"  phase 13: {time.perf_counter() - t13:.1f} s")
    return counts


def phase_batch(measured):
    """Phase 12 (see the module docstring); the W = 16 kernel times go to
    measured["batch16"]."""
    t12 = time.perf_counter()
    phase_batch_kernels(BATCH_W)
    timed = {}
    phase_batch_kernels(16, timed)
    phase_batch_graphed()
    rates = phase_batch_rates()
    phase_batch_kernels(BATCH_W, cases=batch_cases_10k, label="12d")
    phase_batch_kernels(16, timed, cases=batch_cases_10k, label="12d")
    measured["batch16"] = timed
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        phase_batch_10k(tmp)
        rates_10k = phase_batch_rates_10k(tmp)
    log(f"  phase 12: {time.perf_counter() - t12:.1f} s")
    return rates, rates_10k


def scale_box():
    """14a's set-up: the 100,000-atom box through run/scale_run.build
    (fp32, state cap 32), whose shapes must be 22^3 kernel cells,
    pme_scap 0 (the per-atom spread: K + order - 1 = 133 > 128), S = 32
    and K = 128; the kernels its path takes are read from the launch
    counts (phase_scripts)."""
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.run import scale_run
    times = {}
    t0 = time.perf_counter()
    build = scale_run.build(device="cuda", times=times)
    system, _, _, ms = build
    log(f"  14a build: {system.n_atoms} atoms, {system.n_mole} molecules, "
        f"{time.perf_counter() - t0:.1f} s (system {times['system_s']:.1f} "
        f"s, set-up {times['setup_s']:.1f} s); rs_cells "
        f"{system.rs_cells}, pme_scap {system.pme_scap}, neighbor cells "
        f"{ms.nlist.cells}")
    check(system.n_atoms == SCALE_ATOMS, f"14a: {system.n_atoms} atoms")
    check(tuple(system.rs_cells[:3]) == (22, 22, 22),
          f"14a: kernel cells {system.rs_cells}")
    check(system.pme_scap == 0 and system.pme_grid == 128
          and system.evb_max_states == 32,
          f"14a: pme_scap {system.pme_scap}, K {system.pme_grid}, S "
          f"{system.evb_max_states}")
    check(not integrators.overflowed(ms), "14a: the box's set-up overflows")
    return build


def scale_kernels(build, measured):
    """14a: every kernel of the 100k path (A'', B1, B2, C1, C2, E) against
    its plain version at the box's shapes, fp64 and fp32 (phase 3's and
    8b's tolerances; the plain versions timed over SCALE_PLAIN_REPS
    samples, the kernels' device time from a CUDA graph of 8 launches,
    as E's): the "@100k" entries of `measured`."""
    import dataclasses
    import types
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.models import pme
    system, cbw32, _, ms = build
    rng = np.random.default_rng(2026)
    H = evb_hamiltonian(types.SimpleNamespace(ms=ms, system=system,
                                              cbw=cbw32), "full").double()
    K, order = system.pme_grid, system.spline_order
    for dtype in (torch.float64, torch.float32):
        tag = "fp64" if dtype == torch.float64 else "fp32"
        out = measured[tag]
        x, box = ms.state.x.to(dtype), ms.state.box.to(dtype)
        topo = dataclasses.replace(ms.topo, charge=ms.topo.charge.to(dtype))
        cbw = pme.cb_half(box, K, order, system.alpha_sqrt, dtype=dtype)
        pair_kernels(out, tag, system, x, box, topo, {"column": "A''@100k"},
                     SCALE_PLAIN_REPS, graphed=True)
        spread_kernels(out, tag, x, box, topo, K, order, rng, "@100k",
                       SCALE_PLAIN_REPS, graphed=True)
        perstate_kernels(out, tag, x, box, topo, system, cbw,
                         system.evb_max_states, rng, "@100k",
                         SCALE_PLAIN_REPS, graphed=True)
        out["E@100k"] = ground_state_row("14a 100k S=32", H, dtype)
        scale_segments(out, tag, build, x, box, topo, cbw)
        for name in SCALE_KERNELS:
            r = out[name + "@100k"]
            lib = ("" if r["library_ms"] is None
                   else f"  library {r['library_ms']:.4f} ms")
            log(f"  14a {tag} {name + '@100k':9s} max_abs_err "
                f"{r['max_abs_err']:.3e} ok {r['ok']}  kernel "
                f"{r['ms']:.4f} ms  device {fmt(r['device_ms'])} ms  plain "
                f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}){lib}")
            check(r["ok"], f"kernel {name} ({tag}) at the 100k shapes "
                           f"disagrees with its plain version: max abs "
                           f"error {r['max_abs_err']:.3e}")


def scale_segments(out, tag, build, x, box, topo, cbw):
    """14a: kernel F at the calls of one force evaluation of the 100k box
    (its state's neighbor plan): each call equal to the CPU's index_add
    bit for bit; the calls' device ms, the order's and the sum's, and
    each call's longest row (segment_step) as F@100k_step."""
    import types
    import torch
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.ops.kernels import segment_sum as ss
    system, _, _, ms = build
    nl = ms.nlist
    calls = segment_calls(system, types.SimpleNamespace(x=x, box=box), topo,
                          cbw, integrators.neighbor_plan(
                              system, box, nl.capacity, nl.cells,
                              nl.react_cap, nl.react_cells))
    for src, idx, n in calls:
        check(torch.equal(ss.segment_sum_cuda(src, idx, n).cpu(),
                          ss.segment_sum_plain(src.cpu(), idx.cpu(), n)),
              f"14a kernel F ({tag}) differs from index_add on the CPU at "
              f"M = {idx.numel()}, n = {n}")
    step = segment_step(calls, tag)
    out["F@100k_step"] = step
    log(f"  14a {tag} F@100k: {step['calls']} calls, {step['entries']} "
        f"entries, each equal to the CPU's index_add bit for bit; "
        f"{step['device_ms']:.4f} device ms (the order kernels "
        f"{step['order_device_ms']:.4f}, the sum "
        f"{step['kernel_device_ms']:.4f}, other "
        f"{step['foreign_device_ms']:.4f}); bound {step['bound_ms']:.5f} "
        f"ms (bytes); longest rows {step['longest_rows']}; shapes "
        f"{step['shapes']}")


def scale_md(build):
    """14a: one capture chunk and SCALE_STEPS graphed fp32 NVE steps of
    the 100k box through run/scale_run.run; the potential finite and no
    capacity flag in any chunk."""
    import torch
    from reactive_pb_nn_md_tpu_torch.run import scale_run
    torch.cuda.reset_peak_memory_stats()
    out, _ = scale_run.run(build, chunk=SCALE_CHUNK, steps=SCALE_STEPS,
                           log=lambda m: log("  14a " + m))
    check(math.isfinite(out["potential"])
          and math.isfinite(out["first_potential"]),
          f"14a: potential {out['potential']}")
    check(not out["capacities"], f"14a: capacities did not hold: "
                                 f"{out['capacities']}")
    log(f"  14a {out['steps']} steps: {out['steps_per_s']:.2f} steps/s "
        f"({out['ms_per_step']:.2f} ms/step), flags {out['flags']}, "
        f"capacities that did not hold: none, "
        f"captures {out['captures']}, peak "
        f"{out['max_memory_allocated_mib']:.1f} MiB")
    return out


def phase_tenk_steady():
    """14b: the committed equilibrated 10k state (run/equilibrate.py's
    file) on its build: a chunk of TENK_STEADY_STEPS graphed fp32 NVE
    steps holding the one capture, then as many timed steady; no
    capacity flag, exactly one capture in the run."""
    import torch
    from reactive_pb_nn_md_tpu_torch.md import graphs, integrators
    from reactive_pb_nn_md_tpu_torch.run import presets
    system, cbw, cfg, ms = presets.equilibrated(
        presets.build_water(3332, 64, "fp32", 32, device="cuda"), EQ_10K)
    check(not integrators.overflowed(ms), "14b: the state's set-up "
                                          "overflows")
    sg = graphs.StepGraphs()
    rates, flags = [], set()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms, diag = integrators.md_scan(ms, system, cbw, cfg.delta_t, "NVE",
                                       TENK_STEADY_STEPS, step_graphs=sg)
        pot = float(diag.potential[-1])
        rates.append(TENK_STEADY_STEPS / (time.perf_counter() - t0))
        flags |= set(diag.capacities())
        check(math.isfinite(pot), f"14b: potential {pot}")
    check(not flags, f"14b: capacities did not hold: {sorted(flags)}")
    check(len(sg.captures) == 1, f"14b: {len(sg.captures)} captures")
    log(f"  14b {EQ_10K.name}: {system.n_atoms} atoms, capacity "
        f"{ms.nlist.capacity}, cells {ms.nlist.cells}, rs_cells "
        f"{system.rs_cells}, pme_scap {system.pme_scap}; first chunk "
        f"(the capture) {rates[0]:.2f} steps/s, steady {rates[1]:.2f} "
        f"steps/s ({1e3 / rates[1]:.2f} ms/step), 1 capture, no capacity "
        f"flag, KE {float(diag.kinetic[-1]):.1f} kJ/mol")
    return rates[1]


def phase_equilibrate(tmp):
    """14c: run/equilibrate.py's protocol on the flagship at reduced
    counts (EQ_SMOKE): it ends clean, and its file reads back."""
    import torch
    from reactive_pb_nn_md_tpu_torch.convert import (load_equilibrated_npz,
                                                     save_state_npz)
    from reactive_pb_nn_md_tpu_torch.run import equilibrate
    res = equilibrate.equilibrate(equilibrate.build("flagship", "cuda"),
                                  log=lambda m: log("  14c " + m),
                                  **EQ_SMOKE)
    start = res["start"]
    path = tmp / "eq_flagship.npz"
    save_state_npz(path, start, res["system"])
    state, _, meta = load_equilibrated_npz(path, "cuda", torch.float32)
    check(torch.equal(state.x, start.state.x)
          and meta["capacity"] == start.nlist.capacity,
          "14c: the saved state does not read back")
    T = equilibrate.temperature(start, res["system"])
    check(abs(T - 300.0) < 30.0, f"14c: the window starts at {T} K")
    log(f"  14c flagship {res['steps']}: clean, {res['wall_s']:.1f} s, "
        f"{res['captures']} captures, {len(res['regrows'])} regrows, max "
        f"n_states {res['max_states']}, window start {T:.3f} K, potential "
        f"{float(start.potential):.1f} kJ/mol")


def phase_parity():
    """14d: run/parity_reference.py's dump of the flagship deck in fp64 on
    the card (A, B1, B2, C1, C2, E) against the CPU's (plain versions);
    the port's diff must pass."""
    import numpy as np
    from reactive_pb_nn_md_tpu_torch.run import parity_reference as par
    files = [DECK / n for n in ("in.gro", "ff.pmt", "top.top", "sim.pmt")]
    got = par.engine_dump(*files, device="cuda")
    ref = par.engine_dump(*files, device="cpu")
    ok, rep = par.diff_dumps(got, ref, verbose=False)
    df = float(np.abs(np.asarray(got["force_kjmol_per_A"])
                      - np.asarray(ref["force_kjmol_per_A"])).max())
    de = abs(got["ground_energy_kjmol"] - ref["ground_energy_kjmol"])
    log(f"  14d flagship dump fp64, card against CPU: {got['n_states']} "
        f"diabats, max |dF| {df:.3e} kJ/mol/A, |dE| {de:.3e} kJ/mol; "
        f"diff {'passes' if ok else 'fails'}")
    check(ok, "14d: " + "; ".join(r for r in rep if r.startswith("FAIL")))


def phase_scripts(tmp, measured):
    """Phase 14: the run scripts (run/scale_run.py, run/equilibrate.py,
    run/parity_reference.py) on the card; returns the 100k path's launch
    counts and its numbers."""
    t14 = time.perf_counter()
    build = scale_box()
    scale_kernels(build, measured)
    res = {}
    res["launches"] = main_path(
        "14a 100k box", lambda: res.update(md=scale_md(build)),
        SCALE_KERNELS + ("F",), ("A", "A'", "D1", "D2"))
    del build
    import torch
    torch.cuda.empty_cache()
    log(f"  14a: {time.perf_counter() - t14:.1f} s")
    main_path("14b equilibrated 10k",
              lambda: res.update(tenk_steady=phase_tenk_steady()),
              TENK_PATH, ("A", "A'", "B1", "B2"))
    phase_equilibrate(tmp)
    phase_parity()
    log(f"  phase 14: {time.perf_counter() - t14:.1f} s")
    return res



def phase_pbnn_production(tmp):
    """15a: run/pbnn_production.run_one on both surfaces, PBNN_STEPS fp32
    steps each through the Simulation: no failure (every output Etot
    finite, every step done, no aborting line, kernel E converged), hop
    events equal to the hopped rows."""
    from reactive_pb_nn_md_tpu_torch.run import pbnn_production as pp
    res = {}
    for tag, nn_attach in (("analytic", False), ("pbnn", True)):
        t0 = time.perf_counter()
        r = pp.run_one(tag, PBNN_STEPS, nn_attach, tmp, device="cuda",
                       log=lambda m: log("  15a " + m))
        log(f"  15a {tag}: {r['steps_done']} fp32 steps, "
            f"{r['steps_per_s']:.2f} steps/s (chunks of {r['chunk']}, "
            f"captures included), hop events {r['hop_events']}, hopped "
            f"rows {r['hopped_rows']}, distinct molecules "
            f"{r['distinct_mols']}, JAX-style line count "
            f"{r['jax_style_line_count']}, Etot {r['etot_first']} -> "
            f"{r['etot_last']}, {len(r['regrows'])} regrows, "
            f"{r['captures']} captures, pretrain rmse "
            f"{r['pretrain_rmse']}; {time.perf_counter() - t0:.1f} s")
        for ln in r["regrows"]:
            log("    " + ln)
        check(not r["failed"], f"15a {tag}: {r['failed']}")
        res[tag] = r
    return res


def transfer_box(name, device):
    """A pbnn_transfer box (TRANSFER_BOXES) on `device`, fp64: (system,
    topo, box, frames, cbw) of its PBNN_FRAMES rattled frames."""
    from reactive_pb_nn_md_tpu_torch.run import pbnn_transfer as pt
    n_water, K, seed, frame_seed = TRANSFER_BOXES[name]
    system, topo, x0, box = pt.build_water(n_water, K, seed, device)
    *frames, cbw = pt.make_frames(system, topo, x0, box, PBNN_FRAMES, 0.05,
                                  frame_seed)
    return system, topo, box, frames, cbw


def path_hamiltonians(fn):
    """fn() run with nn/train.py's ground state watched: the Hamiltonians
    it was given."""
    from reactive_pb_nn_md_tpu_torch.nn import train
    real, seen = train.ground_state, []

    def watch(H):
        seen.append(H.detach().clone())
        return real(H)

    train.ground_state = watch
    try:
        fn()
    finally:
        train.ground_state = real
    return seen


def transfer_kernels(measured, nn):
    """15b: B1, B2, C1, C2 at each transfer box's shapes (its first
    rattled frame; C at the box's state cap and the superset atoms its
    path gives, U = min(S, molecules) x 4) and E on the first
    Hamiltonian of its eval path, fp64 and fp32, against their plain
    versions at phase 3's (E: 8b's) tolerances, device ms from a CUDA
    graph of back-to-back launches as 14a's (the profiler's records of
    such short calls come back incomplete in the full script): the
    "@k16" / "@k24" entries of `measured`."""
    import dataclasses
    import numpy as np
    import torch
    from reactive_pb_nn_md_tpu_torch.models import pme
    from reactive_pb_nn_md_tpu_torch.run import pbnn_transfer as pt
    rng = np.random.default_rng(2027)
    for name in TRANSFER_BOXES:
        key = "@" + name
        system, topo, box, frames, cbw = transfer_box(name, "cuda")
        H = path_hamiltonians(lambda: pt.frame_energies(
            system, topo, box, cbw, frames, mlp_as(nn, "cuda",
                                                   torch.float64)))[0]
        S, K, order = system.evb_max_states, system.pme_grid, \
            system.spline_order
        UM = min(S, system.n_mole)
        ua = topo.mol_atoms[:UM].clamp(min=0).reshape(-1)
        log(f"  15b {name}: {system.n_atoms} atoms, K = {K}, S = {S}, U = "
            f"{ua.numel()}, rs_cells {system.rs_cells or '() (no grid)'}, "
            f"pme_scap {system.pme_scap}")
        for dtype in (torch.float64, torch.float32):
            tag = "fp64" if dtype == torch.float64 else "fp32"
            out = measured[tag]
            x, bx = frames[0][0].to(dtype), box.to(dtype)
            tp = dataclasses.replace(topo, charge=topo.charge.to(dtype))
            cb = pme.cb_half(bx, K, order, system.alpha_sqrt, dtype=dtype)
            spread_kernels(out, tag, x, bx, tp, K, order, rng, key,
                           TRANSFER_PLAIN_REPS, graphed=True)
            perstate_kernels(out, tag, x, bx, tp, system, cb, S, rng, key,
                             TRANSFER_PLAIN_REPS, graphed=True, ua=ua)
            out["E" + key] = ground_state_row(f"15b {name} S={S}", H, dtype)
            for k in ("B1", "B2", "C1", "C2"):
                r = out[k + key]
                lib = ("" if r["library_ms"] is None
                       else f"  library {r['library_ms']:.4f} ms")
                log(f"  15b {tag} {k + key:7s} max_abs_err "
                    f"{r['max_abs_err']:.3e} ok {r['ok']}  kernel "
                    f"{r['ms']:.4f} ms  device {fmt(r['device_ms'])} ms  "
                    f"plain {r['plain_ms']:.4f} ms  bound "
                    f"{r['bound_ms']:.2e} ms ({r['bound_by']}){lib}")
                check(r["ok"], f"kernel {k} ({tag}) at the {name} transfer "
                               f"box disagrees with its plain version: max "
                               f"abs error {r['max_abs_err']:.3e}")


def transfer_eval(nn):
    """15b: pbnn_transfer.frame_energies (the labels and the MLP's
    energies) on PBNN_FRAMES frames of each box, card against CPU, fp64:
    within 1e-10 relative."""
    import torch
    from reactive_pb_nn_md_tpu_torch.run import pbnn_transfer as pt
    for name in TRANSFER_BOXES:
        res = {}
        for dev in ("cuda", "cpu"):
            system, topo, box, frames, cbw = transfer_box(name, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e = pt.frame_energies(system, topo, box, cbw, frames,
                                  mlp_as(nn, dev, torch.float64))
            torch.cuda.synchronize()
            res[dev] = (torch.cat(e).cpu(), time.perf_counter() - t0)
        (g, tg), (c, tc) = res["cuda"], res["cpu"]
        rel = float(((g - c).abs() / c.abs()).max())
        log(f"  15b {name} eval, {PBNN_FRAMES} frames, labels and MLP "
            f"energies: card vs CPU {rel:.3e} relative; {tg:.2f} s card, "
            f"{tc:.2f} s cpu")
        check(rel <= 1e-10, f"15b {name}: card and CPU frame energies "
                            f"differ by {rel:.3e} relative")


def transfer_finetune(nn):
    """15c: one finetune_heldout step (split 0.75) on the 26-water box's
    frames, card against CPU: the report's rmses and the MLP after within
    1e-8 relative (9e's bound)."""
    import torch
    from reactive_pb_nn_md_tpu_torch.nn import coupling_mlp, train
    from reactive_pb_nn_md_tpu_torch.run import pbnn_transfer as pt
    out = {}
    for dev in ("cuda", "cpu"):
        system, topo, box, frames, cbw = transfer_box("k16", dev)
        nn0 = mlp_as(nn, dev, torch.float64)
        e_ref, _ = pt.frame_energies(system, topo, box, cbw, frames, nn0)
        sys_nn = coupling_mlp.attach(system, nn0, pt.TRIPLE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[dev] = train.finetune_heldout(nn0, sys_nn, topo, box, cbw,
                                          *frames, e_ref, split=0.75,
                                          steps=1) + (
            time.perf_counter() - t0,)
    (ng, rg, tg), (nc, rc, tc) = out["cuda"], out["cpu"]
    keys = [k for k in rc if k.endswith(("before", "after"))]
    d_rmse = max(abs(rg[k] - rc[k]) / abs(rc[k]) for k in keys)
    d_mlp = mlp_rel(ng, nc)
    log(f"  15c finetune_heldout, 1 step, {rc['n_train']} train / "
        f"{rc['n_test']} test frames: train rmse "
        f"{rc['train_rmse_before']:.6f} -> {rc['train_rmse_after']:.6f}, "
        f"test {rc['test_rmse_before']:.6f} -> {rc['test_rmse_after']:.6f} "
        f"kJ/mol (cpu); card vs cpu: rmses {d_rmse:.3e}, MLP after "
        f"{d_mlp:.3e} relative; {tg:.2f} s card, {tc:.2f} s cpu")
    check(d_rmse <= 1e-8 and d_mlp <= 1e-8, "15c: the finetuning step "
                                            "differs between card and CPU")


def phase_pbnn_scripts(tmp, measured):
    """Phase 15: the PB-NN run scripts (run/pbnn_production.py,
    run/pbnn_transfer.py); returns the launch counts of each path."""
    import torch
    from reactive_pb_nn_md_tpu_torch.nn import train
    from reactive_pb_nn_md_tpu_torch.run import pbnn_transfer as pt
    t15 = time.perf_counter()
    res = {}
    res["production"] = main_path(
        "15a pbnn_production", lambda: res.update(
            runs=phase_pbnn_production(tmp)),
        FLAGSHIP_PATH, ("A'", "A''", "D1", "D2"))
    log(f"  15a: {time.perf_counter() - t15:.1f} s")
    # one MLP for 15b and 15c, pretrained on the CPU (the transfer boxes
    # are fp64)
    system = pt.build_water(26, 16, 9, "cpu")[0]
    nn, _ = train.pretrain_geometric(
        system.evb.cpl_params[pt.water_triple(system)],
        torch.Generator().manual_seed(1), steps=TRANSFER_PRETRAIN,
        dtype=torch.float64, device="cpu")
    transfer_kernels(measured, nn)
    res["transfer"] = main_path("15b pbnn_transfer eval",
                                lambda: transfer_eval(nn), TRANSFER_KERNELS,
                                ("A", "A'", "A''", "D1", "D2"))
    transfer_finetune(nn)
    log(f"  phase 15: {time.perf_counter() - t15:.1f} s")
    return res


# ---- phase 16: the step is reproducible bit for bit


def audit_step(name, sim, ens):
    """One eager step of sim's state under the accumulation audit
    (ops/accumulation_audit.py): no floating-point accumulation whose
    bits can depend on the order of its terms; the exact sites (one
    nonzero term a target) counted."""
    import warnings
    import torch
    from reactive_pb_nn_md_tpu_torch.evb import hamiltonian as ham
    from reactive_pb_nn_md_tpu_torch.md import integrators
    from reactive_pb_nn_md_tpu_torch.ops.accumulation_audit import \
        FloatAccumulations
    system, cbw, dt, _, fr, temp = scan_args(sim, ens)
    tier = "small" if ham.small_state_tier(system) else "full"
    audit = FloatAccumulations()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with torch.autograd.detect_anomaly(check_nan=False), audit:
            integrators.scan_step(sim.ms, system, cbw, dt, ens, fr, temp,
                                  sim.gen, tier)
    log(f"  16 {name}: an eager {tier}-tier step under the accumulation "
        f"audit: order-dependent sites {dict(audit.summary())}, exact "
        f"sites {len(audit.exact)} ({sum(audit.exact.values())} calls)")
    for (op, where), n in sorted(audit.exact.items()):
        log(f"    exact: {op} x{n} at {where}")
    check(not audit.order_dependent,
          f"16 {name}: order-dependent accumulations {audit.summary()}")


def replay_accumulations(name, sim):
    """The device kernels of one replay of sim's captured step whose
    names are torch's accumulating kernels (profile_step.ACCUMULATE: the
    indexing backward, index_add, scatter-add; over floats or integers),
    by name and count; printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step = sim.ms.state.step
    sim._chunk(step, 2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim._chunk(step + 2, 1)
        torch.cuda.synchronize()
    hits = {e.key[:140]: e.count for e in prof.key_averages()
            if e.device_type.name == "CUDA"
            and tool("profile_step").ACCUMULATE.search(e.key)}
    log(f"  16 {name}: torch accumulate kernels in one replay: "
        f"{hits or 'none'}")
    return hits


def phase_determinism(tmp, nn):
    """Phase 16 (see the module docstring)."""
    import torch
    t16 = time.perf_counter()
    two = tool("two_runs")
    for name, run in two.configurations(sys.modules[__name__], tmp, nn):
        t0 = time.perf_counter()
        a = run()
        first, dx, dv, de = two.compare(a, run())
        log(f"  16 {name}: {len(a)} steps twice, max|dx| {dx:.3e} A, "
            f"max|dv| {dv:.3e}, max|dEtot| {de:.3e} kJ/mol, first step "
            f"apart {first}; {time.perf_counter() - t0:.1f} s")
        check(first is None,
              f"16 {name}: two runs from one state part at step {first}")
    audit_step("flagship fp64", eq_sim(tmp / "16a", torch.float64), "NVE")
    tenk = lattice_sim(tmp / "16b", torch.float32)
    audit_step("10k fp32", tenk, "NVE")
    replay_accumulations("flagship fp64", eq_sim(tmp / "16c",
                                                 torch.float64))
    replay_accumulations("10k fp32", tenk)
    log(f"  phase 16: {time.perf_counter() - t16:.1f} s")


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
    from reactive_pb_nn_md_tpu_torch.ops.kernels import realspace_pair as rsp
    _build.library()
    log(f"[2 build] {len(list(_build.CSRC.glob('*.cu')))} sources built in "
        f"{_build.build_info['seconds']:.1f} s -> {_build.build_info['path']}")
    for ln in _build.build_info["log"].splitlines():
        if "registers" in ln or "spill" in ln or ln.startswith("=="):
            log("  " + ln.strip())

    log("[3 kernels] kernel vs plain at flagship and 10k shapes")
    measured = {}
    phase_kernels(measured)

    log("[4 forces] evaluate_forces fp64, CUDA vs CPU")
    phase_forces()

    log("[5 cli] the main paths, launch counts from 0 each")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        flag = main_path(
            "5a water_msevb",
            lambda: [run_cli(tmp, DECK, p, 30, 4) for p in ("fp64", "fp32")],
            FLAGSHIP_PATH, ("A'", "A''", "D1", "D2"))
        big = main_path(
            "5b water_10k",
            lambda: [run_cli(tmp, DECK_10K, p, 20, 3)
                     for p in ("fp32", "fp64")],
            TENK_PATH, ("A", "A'", "B1", "B2"))

        def half():
            rsp.set_stencil_impl("half")
            try:
                run_cli(tmp / "half", DECK_10K, "fp32", 3, 1)
            finally:
                rsp.set_stencil_impl("auto")

        (tmp / "half").mkdir()
        half_counts = main_path("5c water_10k half stencil", half,
                                ("A'", "E"), ("A", "A''"))

        def regrow():
            (tmp / "cap8").mkdir()
            _, lines = run_cli(tmp / "cap8", DECK, "fp64", 5, 1,
                               extra="evb_max_states     8\n")
            check(any("evb_max_states regrown to" in ln for ln in lines),
                  "the state cap 8 was not regrown")

        main_path("5d water_msevb at evb_max_states 8", regrow,
                  FLAGSHIP_PATH, ("A'", "A''", "D1", "D2"))

        def ensembles_10k():
            for name, extra in (("nvt", NVT_DECK),
                                ("npt", "ensemble           NPT\n")):
                (tmp / f"10k_{name}").mkdir()
                run_cli(tmp / f"10k_{name}", DECK_10K, "fp32", 12, 2,
                        extra=extra)

        main_path("5e water_10k NVT and NPT", ensembles_10k, TENK_PATH,
                  ("A", "A'", "B1", "B2"))
    for k in FLAGSHIP_PATH:
        launches[k] = flag[k]
    for k in ("A''", "D1", "D2"):
        launches[k] = big[k]
    launches["A'"] = half_counts["A'"]

    log(f"[6 nve] {NVE_STEPS} steps from benchdata/eq_flagship_s80.npz")
    phase_nve()

    log("[7 ensembles and run contract] NVT, restart, NPT, debug 2")
    t7 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        nvt = main_path("7a flagship NVT", lambda: phase_nvt(tmp),
                        FLAGSHIP_PATH, ("A'", "A''", "D1", "D2"))
        phase_restart(tmp)
        _, npt = phase_npt(tmp)
        phase_debug(tmp)
        log(f"  phase 7: {time.perf_counter() - t7:.1f} s")

        log("[8 md_scan graphed] sync-free step, kernel E, graphed vs "
            "eager, replays, rates")
        t8 = time.perf_counter()
        phase_sync(tmp)
        phase_ground_state(tmp, measured)
        for dtype in (torch.float64, torch.float32):
            tag = "fp64" if dtype == torch.float64 else "fp32"
            for ens in ("NVE", "NVT"):
                sim = eq_sim(tmp / f"8c_{tag}_{ens}", dtype,
                             NVT_DECK if ens == "NVT" else "")
                graphed_vs_eager("8c flagship", sim, ens, EAGER_STEPS,
                                 FLAGSHIP_KERNELS)
        graphed_vs_eager("8d 10k", lattice_sim(tmp / "8d", torch.float32),
                         "NVE", 20, TENK_KERNELS)
        phase_replays(tmp, npt)
        phase_rates(tmp / "8f")
        log(f"  phase 8: {time.perf_counter() - t8:.1f} s")

        log("[9 pb-nn] coupling type 3: pretraining, forces, graphed NVE, "
            "finetuning, card against CPU")
        nn = phase_pbnn(tmp)

        log("[10 umbrella] the restraint, graphed vs eager windows, the "
            "full-width ladder through run_pmf, replicas")
        ladder = phase_umbrella(tmp)

        log("[11 sharded step] one replica's step shared over ranks at "
            "world size 1: graphed scan vs unsharded, range launches")
        sharded = phase_sharded(tmp)

    log("[12 replica batch] batched launches vs single ones, the batched "
        "graphed step vs in turn, window-steps/s at W = 1, 4, 16; the 10k "
        "cell path: A', A'', D1, D2 batched, 10k replicas and a ladder, "
        "replica-steps/s")
    phase_batch(measured)

    log("[13 batch under a shard] the replica batch's step shared over an "
        "atoms group at world size 1 against the unsharded batch, the "
        "range launches batched")
    shard_batch = phase_batch_shard()

    log("[14 scripts] the run scripts: the 100k box (its kernels against "
        "their plain versions, graphed steps), the committed 10k state, "
        "equilibrate, the parity dump")
    with tempfile.TemporaryDirectory() as tmp:
        scripts = phase_scripts(pathlib.Path(tmp), measured)

    log("[15 pb-nn scripts] pbnn_production's two surfaces through the "
        "Simulation, the kernels at the transfer boxes' shapes, their "
        "eval and a finetuning step, card against CPU")
    with tempfile.TemporaryDirectory() as tmp:
        pbnn = phase_pbnn_scripts(pathlib.Path(tmp), measured)

    log("[16 determinism] two runs of one deck from one state, every "
        "step's x, v and Etot bit for bit; the accumulation audit of an "
        "eager step; torch accumulate kernels in a replay")
    with tempfile.TemporaryDirectory() as tmp:
        phase_determinism(pathlib.Path(tmp), nn)

    k64, k32 = measured["fp64"], measured["fp32"]
    kernels = []
    for k, (src, rep) in KERNELS.items():
        m64, m32 = k64[k], k32[k]
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=rep,
            launches=launches[k], nvt_launches=nvt.get(k, 0),
            ladder_launches=ladder.get(k, 0),
            sharded_launches=sharded.get(k, 0),
            sharded_batch_launches=shard_batch.get(k, 0),
            pbnn_production_launches=pbnn["production"].get(k, 0),
            pbnn_transfer_launches=pbnn["transfer"].get(k, 0),
            max_abs_err=m64["max_abs_err"],
            ms=m64["ms"], device_ms=m64["device_ms"],
            plain_ms=m64["plain_ms"],
            bound_ms=m64["bound_ms"], bound_by=m64["bound_by"],
            library_ms=m64["library_ms"],
            shapes="water_10k" if k in AT_10K else "flagship",
            fp32_max_abs_err=m32["max_abs_err"], fp32_ms=m32["ms"],
            fp32_device_ms=m32["device_ms"],
            fp32_plain_ms=m32["plain_ms"], fp32_bound_ms=m32["bound_ms"],
            fp32_library_ms=m32["library_ms"],
            **{f"w16_{tag}_{f}": v
               for tag, res in measured["batch16"].items() if k in res
               for f, v in res[k].items()},
            **({} if k not in SCALE_KERNELS else {"at_100k": dict(
                launches=scripts["launches"].get(k, 0),
                **{tag: {f: measured[tag][k + "@100k"][f] for f in (
                    "max_abs_err", "ms", "device_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")}
                   for tag in ("fp64", "fp32")})}),
            **{f"at_{box}": {
                tag: {f: measured[tag][f"{k}@{box}"][f] for f in (
                    "max_abs_err", "ms", "device_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")}
                for tag in ("fp64", "fp32")}
               for box in TRANSFER_BOXES if k in TRANSFER_AT},
            **({} if k != "F" else {
                "shape": m64["shape"], "at_10k": {
                    tag: {f: measured[tag]["F@10k"][f] for f in (
                        "max_abs_err", "ms", "device_ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms", "shape")}
                    for tag in ("fp64", "fp32")},
                "per_evaluation": {
                    tag: {box: measured[tag][f"F{key}_step"]
                          for box, key in (("flagship", ""),
                                           ("10k", "@10k"),
                                           ("100k", "@100k"))}
                    for tag in ("fp64", "fp32")}})))
    extra = {f"{tag}_{k}": {f: r[f] for f in ("ms", "device_ms", "plain_ms",
                                               "bound_ms", "library_ms")}
             for tag, res in measured.items() if tag != "batch16"
             for k, r in res.items()
             if k not in KERNELS and not k.endswith(
                 ("@100k", "_step") + tuple("@" + b for b in
                                            TRANSFER_BOXES))}
    log(f"  other shapes: {json.dumps(extra)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
