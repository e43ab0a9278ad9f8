"""Smoke run of the PyTorch + CUDA port (swarm_ode_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero):
  1. the card: CUDA present, name and power limit from nvidia-smi; TF32 off
     for matrix products and cuDNN (the GDE compares the card with the CPU
     in full float32);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel;
     timed); ptxas's registers and spills of each BFS kernel
     instantiation, no spills in the medium forms;
  3. K1 and K2 (one kernel, csrc/bfs_query.cu, building each row from its
     env's occupancy) against their own plain versions (`_passable_rows`
     then `bitpack_query_plain` or `query_plain`) on the card: on real
     medium env rows; random medium rows at 0, 1, 8, 32 and 200 sweeps;
     extralarge (44 words) and 80 x 30; targets and own cells on blocked
     cells; for K2 also walled widths of 41, 64 and 151 (the shared-memory
     form); every walled target in [-3(W+1), L + 3(W+1)) of each kernel's
     padded row L and the int32 extremes: 0 mismatches. K1 against K2 on
     real rows and on margin-row targets with t + W+1 < 32*words.
     replan_query with host synchronisation forbidden. Times at the main
     path's 12,672 rows at 32 and 200 sweeps, the plain versions and the
     mask build the kernel replaces; the fused bound beside the earlier
     (K, n) mask-row bound;
  4. K3 (full-field BFS) against its plain version on all 57,344 rows of
     real medium states and on random grids: at walled widths of 32, 64 and
     101 and a 150 x 150 grid, with 0, 1 and 200 sweeps, on impassable
     targets and on every target of the out-of-range sweep at 9 x 8 and
     medium: 0 mismatches; two launches bit-identical; its field read at
     each own cell equals K1's (distance, next hop); times at 57,344 rows
     (also at 200 sweeps, the early exit, and at 0 sweeps, its input and
     output alone), against the bound and the time
     before the redesign; ptxas's registers for its medium instantiation,
     no spills;
  5. the card against the CPU: 50 steps of dispatcher + step at B = 64 with
     the same injected draws, every state field, reward and info identical;
     from the same reset and draws, the stochastic expert (T = 1.0, its
     dispatcher draws made on the CPU) with the stateless expert's actions
     and the action masks at every state, and collect_batch's captured
     arrays (observations as float16 bits): identical;
  6. the main path: medium, B = 2048, reset + 200 steps, once in each
     setting of bfs_kernel with the launch counts zeroed before and read
     after: the default (bitpack32) launches the bit-packed kernel once per
     step, "int32" the int32 kernel, neither the other's, `_passable_rows`
     builds no (K, n) mask, and nothing overflows the compaction; batched_env_steps_per_sec (default setting,
     best of 3 after a warm-up); both settings give identical states from
     one start state and one set of draws;
  7. the full-field rollout: medium, B = 2048, 200 steps with
     bfs_backend="xla", counts zeroed before and read after: K3 once per
     step, K1 and K2 never; steps/s (best of 3); at B = 64 over 50 steps it
     gives states identical to the compacted path, both at
     replan_row_frac = 1.0;
  8. GDE serving: a medium heuristic rollout of B = 512 envs; every step
     observe (partial, D = 435) -> push_frame -> the server
     (build_temporal_batch, temporal_edges, apply_batched with euler over
     t = 0..4 on seeded flagship-shaped weights, newest frame's positions);
     counts zeroed before the 50 counted steps and read after (K4 three
     times per ODE step, one plan per batch); windows/s and ms per batch.
     K4 at D = 435 and 64 on the served edges, planned (the served form:
     sources read through the plan, mean) and general (segment_sum_call):
     against its plain version on the card within the bucket tolerance and
     on the CPU (max error printed), two launches bit-identical, one plan
     and one planned launch with host synchronisation forbidden; times of
     K4, its plain version, the plan and the library yardsticks
     (torch.sparse.mm of the CSR adjacency, index_add_ over the valid rows),
     the bound and the roofline share. The sparse mean against the dense
     one on the card, and the card against the CPU on 8 windows;
  9. GDE training at the flagship's recipe (windows of 5 x 28 x 435,
     hidden 64, euler, horizon 4 with weights (3, 1, 1, 1), batch 32,
     AdamW, clip 1.0) on 8 medium episodes of 100 steps that the port's
     rollout records: one step (loss, every gradient, the parameters after
     AdamW) card against CPU at horizon 1 and 4; one step with host
     synchronisation forbidden; train_gde for 2 epochs on the card (uint8
     storage, checkpoints), the loss falling and no K4 launch in training;
     a resume restoring parameters and optimizer state bit for bit; the
     best weights served through K4 at B = 512 (counts zeroed before and
     read after: 12 launches) against the structured path on the card
     within 1e-4 of the largest prediction; train ms per step and windows/s
     at B = 32 and 512 (best of 3 after a warm-up), peak memory, device
     events and busy share per step from torch.profiler traces;
 10. 30 medium episodes of 500 steps through the `parity` command line
     (`python -m swarm_ode_tpu_torch.policies.heuristic parity`, in this
     process, one batched rollout): its reference table and JSON line
     printed, mean deliveries within 10% of the JAX package's 85.13,
     overflow 0, counts zeroed before and read after (K1 500 times: one
     compacted launch a step for all 30 envs); its wall seconds;
 11. expert datagen: collect_batch at medium, B = 128 episodes of 500 steps
     in chunks of 100, up to the host arrays the HDF5 writer takes (the
     writer needs h5py, which the card's host need not have), counts
     zeroed before and read after: K1 500 times, overflow 0, mean
     deliveries within 10% of 85.13; env steps/s
     with capture, MB copied a chunk, and the device's busy share (busy time
     a step in a traced chunk of 5 steps over the run's wall time a step);
 12. the env API: a 500-step medium episode through the gym adapter
     (`make`, on the card by default) driven by the dispatcher, terminateds
     at step 500 and not before; heuristic_episode on it; auto_reset_rollout
     at B = 64 over 1,100 steps with host synchronisation forbidden (two
     boundaries per env, cur_steps from the last one); checked_step over 100
     steps at B = 64 beside the plain step: it raises exactly where the
     invariant flags (the same on the card and the CPU) break, and only
     the break JAX's own rollout makes (two agents of one layer on one
     cell, neither fixing a clash) may occur; K1's launches on each path;
 13. off-policy MARL: card against CPU at medium, B = 8 (TF32 off): hetero
     graphs, masks_from_feats, busy flags and selections (epsilon-greedy,
     the claim auction's epsilon-greedy and sampling) identical, Q-values
     of gnn, gnode and gnode_comm within 1e-5 of the largest |Q|, one IQL
     and one QMIX learn step (n_step 3, value_transform, coordinated) with
     the loss and gradient within 1e-5 and Adam from the CPU's gradients
     within 1e-6; run_marl with experiments/medium_qmix_long.py's recipe for one
     stride (qmix, gnode, 8 envs x 500 steps, hidden 64, buffer 100,000,
     batch 64, a learn step every env step), the episode with host
     synchronisation forbidden, counts zeroed before and read after (K1 500
     times, overflow 0), a finite nonzero loss, every parameter a Q head
     reaches moved; marl_env_steps_per_sec, ms per learn step, peak memory,
     busy share of a traced block; the greedy evaluation (8 envs x 500
     steps) resuming from the run's checkpoint, the agent restored bit for
     bit; make_policy_fn(coordinated=True) serving the trained Q-network
     over 200 steps of a medium episode; K1's launches on each path;
 14. learning from the dispatcher and on-policy MARL, at the width of
     experiments/medium_bc.py, medium_dagger.py, medium_mappo.py and
     medium_coma_curve.py (net gnode, hidden 64, 8 medium envs; episodes
     cut to 100 steps, COMA's stride excepted, 500): 8 expert episodes
     recorded in memory by collect_batch (the
     card's host has no h5py); train_bc on them for 2 epochs at batch 64,
     the loss finite and falling, the best epoch's checkpoint read back bit
     for bit; one DAgger round (collect_dagger over 8 episodes at beta 0.25,
     coordinated, then 1 epoch on the aggregate from the clone);
     evaluate_policy over 8 episodes through the claim auction; run_mappo
     for one stride (coordinated, ppo_epochs 2, minibatch 128) warm-started
     from the clone, the actor before its first update equal to the
     checkpoint bit for bit, the collection with host synchronisation
     forbidden, then its greedy probe; run_marl(algo="coma", coordinated)
     for one stride (batch 64, buffer 50,000, 8 updates), the episode with
     host synchronisation forbidden; a QMIX run built with init_q_from the
     clone, its Q-network and targets the checkpoint's bit for bit; card
     against CPU on one batch taken from the card: a COMA update (both
     losses, both gradients), a MAPPO minibatch step (loss, gradients) and a
     BC batch (loss, gradient) within the MARL tolerances, Adam on the card
     from the CPU's gradients within 1e-6; counts zeroed before and read
     after each path: K1 once a step, overflow 0; steps/s, ms per update,
     ms per epoch, peak memory and the MAPPO collection's busy share;
 15. the recurrent models: the four trajectory baselines (GRU and LSTM on
     observations, GRU and LSTM on positions) at the flagship's shape
     (medium, D = 435, N = 28, windows of 5, hidden 128, batch 32) on 8
     recorded medium episodes of 100 steps: one step card against CPU
     (loss, gradients, AdamW from the CPU's gradients, the GDE training
     tolerances), train_baseline for 3 epochs on the card with the loss
     falling, a step with host synchronisation forbidden, ms per train step
     and windows/s (best of 3 x 10 steps), peak memory and busy share;
     graph-GRU IQL (scripts/run_gru.py's recipe: hidden 256, buffer 20,000,
     batch 32) card against CPU over 20 env steps of 8 medium envs from one
     agent state and one set of draws (actions, rewards and features
     identical, hidden states within 1e-5 of the largest) and one learn
     step (the MARL tolerances); run_marl for one stride of 8 envs x 500
     steps with the episode under host synchronisation forbidden, counts
     zeroed before and read after (K1 500 times, overflow 0), the GRU
     cells trained; marl_env_steps_per_sec, ms per learn step, bytes an
     item, peak memory, busy share; the greedy evaluation (8 envs x 500
     steps) resuming from the run's checkpoint, the agent restored bit for
     bit (K1 500); make_policy_fn serving the trained GRU Q-network over 200
     steps of a medium episode (K1 200);
 16. export and the committed artifacts: each of the four committed
     dispatch policies (QMIX gnode, medium and large, greedy; the DAgger
     clones, gnn, medium and large, T = 3.0) built on the card from its
     committed weights (convert.committed_params), exported
     (serving.export_policy) on the card and on the CPU, both artifacts
     loaded on the card (serving.load_policy): on 16 observations of a
     seeded rollout of its env (64 for the QMIX medium policy), their
     actions equal the direct policy's on the card and the port's on the
     CPU, bit for bit (the clones given the same Gumbels), a loaded call
     with host synchronisation forbidden; the loaded QMIX medium artifact
     exported on the card drives 64 medium envs for one episode (replan
     compaction off), counts zeroed before and read after (K1 500 times,
     overflow 0), deliveries per env and ms a step; the flagship
     GDE (gde_medium_h4w's weights) exported on the card for batches of 512
     windows, loaded on the card, serving phase 8's 50 batches of windows
     (the same rollout) with K4's count zeroed before and read after (600:
     the exported program calls K4 as the custom op), its predictions
     within 1e-4 of the largest against the eager predictor on the card and
     the port on the CPU (8 windows), a loaded call with host
     synchronisation forbidden; ms per batch of the predictor, loaded beside
     eager; each export's seconds (trace and save) and the phase's;
 17. profiling and data parallelism: utils/profiling's StageTimer over 20
     steps of the main path (medium, B = 2048, dispatcher and step as two
     stages, block_on the env state); a stage around a device sleep reads
     at least the sleep (timed by CUDA events) with block_on and less
     without it; device_throughput
     of the 20-step loop beside phase 6's reading (no gate). One NCCL rank
     on the card (a process group of world size 1 through a file store):
     make_mesh takes cuda:0, an all_reduce and a broadcast on the card;
     train_gde for one epoch on phase 9's episodes (its recipe, uint8
     storage) and run_mappo with mesh_devices=1 at JAX's mesh parity config
     (tiny, 4 envs, 2 strides of 30 steps) each equal the run without a
     process group bit for bit (parameters and history; a second run
     without a group, the control, equal too), counts zeroed before the
     mesh MAPPO run and read after (K1 once a collected step);
 18. trajectory evaluation (analysis.py): the committed flagship
     gde_medium_h4w (convert.committed_params; 5 x 28 x 435 windows, hidden
     64) scored by evaluate_gde over 1,024 windows of three of the datagen
     phase's episodes at batch 64, K4's count zeroed before and read after
     (batches x its count in one batch, 3: one Euler step, three SAGE
     layers); the card's predictions against the CPU's within 1e-4 of the
     largest and the metrics within what that moves (`assert_eval_agrees`);
     the mean error under 1.0 cell and success@2.0 above 0.9, printed
     beside RESULTS.md's 0.301 / 96.4% / 0.875 (other data: no gate); the
     four baselines (seeded weights, hidden 128) over 256 windows, card
     against CPU; windows/s and the phase's seconds;
 19. the `run` command line (`python -m swarm_ode_tpu_torch.policies.heuristic
     run`, in this process): one medium episode of 500 steps at B = 1 on
     the card, its stat line read back by the shared pattern
     (`heuristic.STAT_LINE`) and equal to the episode's summary, counts
     zeroed before and read after (K1 500 times), overflow 0; its FPS.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. A kernel's `bound_ms` is the least time the
card could take for its work at this run's inputs: the larger of its bytes
(each input read once, each output written once) over 3.35 TB/s and its
operations over 67 T/s (float32 outside the tensor cores; the BFS kernels'
integer operations are counted at that rate too), the H100 SXM data sheet's
rates at 700 W. A kernel's `ms` is the mean of CUDA events around
launches queued behind a device sleep (`cuda_time_ms`, which fails if the
device woke before the last launch was queued); its `trace_ms`, the mean
of its own durations in torch.profiler traces (traced again until as many
launches are held as were made), must lie within 20% of it.
Plain versions, plans, library calls and the mask build are timed as
kernels are (`device_ms`), or, where their calls cannot be queued behind
the sleep (they synchronise or overflow the launch queue), as the device's
busy time per call in a torch.profiler trace, one of two that hold the
same, largest count of device events (after 8 traces, the largest count
two of them hold). No time may fall below its bound.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

MEDIUM = "tarware-medium-19agvs-9pickers-partialobs-v1"
BATCH, STEPS = 2048, 200
# GDE serving: the flagship's shape (results_data/gde_medium_h4w.stablehlo.json).
GDE_BATCH, GDE_STEPS, WINDOW, HORIZON, HIDDEN = 512, 50, 5, 4, 64
# GDE training: the flagship's recipe (horizon 4, weights (3, 1, 1, 1)) on
# episodes the port's rollout records.
TRAIN_ENVS, TRAIN_STEPS, TRAIN_WEIGHTS = 8, 100, (3.0, 1.0, 1.0, 1.0)
# Card against CPU for one training step, TF32 off: the loss within 1e-5 of
# itself and each gradient within 1e-5 of its largest element (float32 sums
# over 32 x 140 nodes in other orders; the port's float criterion against
# JAX); AdamW from the same gradients within 1e-6 (elementwise float32
# arithmetic on parameters of magnitude < 1).
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_OPT_ATOL = 1e-5, 1e-5, 1e-6
# The solver's backward on the card: checkpoint=True recomputes the same
# steps, so its gradients equal the stored ones up to float32 rounding
# (1e-6 of the largest); the adjoint integrates the augmented system back
# with the same rk4, within the JAX adjoint test's 1e-4.
SOLVER_CKPT_RTOL, SOLVER_ADJ_RTOL = 1e-6, 1e-4
# Float32 rounding bound of a sum of up to 32 terms in any order, relative to
# the sum of the terms' magnitudes: 32 * 2**-23. Atomics (K4) and matrix
# products sum in other orders than the plain versions.
SUM_RTOL = 32 * 2.0**-23
# H100 SXM data sheet (700 W): device memory rate, float32 rate outside the
# tensor cores; the SM clock's ceiling (1,980 MHz), which sizes the sleep
# that timed launches queue behind.
HBM_BYTES_PER_S, F32_OPS_PER_S, SM_CYCLES_PER_S = 3.35e12, 67e12, 1.98e9
# A kernel's event-timed mean also holds the device's gap between back-to-
# back launches, which its own duration in a profiler trace does not (under
# a microsecond a launch on an H100): the two may differ by this share of the
# trace mean. Time paced by the host instead (a kernel shorter than its
# wrapper's Python reads as the wrapper's issue time) is far outside it.
TRACE_RTOL = 0.2
# A torch.profiler trace on an H100 may lose the records of some launches,
# at the start or the end of its cycle, now and then all of them (0 of 50
# K4 launches, 10 of 20 K3 launches lost); the same trace of another cycle
# usually holds them all. `trace_ms` traces again, at most this many times.
TRACE_TRIES = 8
# K3 at 57,344 medium rows before its bit-packed redesign (one block per row,
# the int32 field in shared memory), as PERF.md's kernel table records it.
K3_PREVIOUS_MS = 1.2552
# JAX package, 30 medium episodes (results_data/parity_rejoin_r4.json,
# parity_at_chosen): deliveries, clashes, stucks per episode.
JAX_PARITY = {"deliveries": 85.13, "clashes": 189.23, "stucks": 16.63}
# Expert datagen: B episodes of the config's 500 steps, copied to the host in
# chunks of DATAGEN_CHUNK steps; the busy share from a traced chunk of
# DATAGEN_TRACE_STEPS steps. The env API: the auto-reset rollout over 1,100
# steps (two 500-step boundaries, JAX's test) and checked_step, at B = 64.
DATAGEN_BATCH, DATAGEN_CHUNK, DATAGEN_TRACE_STEPS = 128, 100, 5
ENV_API_BATCH, AUTO_RESET_STEPS, CHECKED_STEPS = 64, 1100, 100
# The one invariant JAX's own medium rollout breaks (tests/test_torch_invariants.py).
OVERLAP = "same-layer agents overlap without fixing-clash"
# Off-policy MARL: experiments/medium_qmix_long.py's recipe for one stride
# (medium, qmix, gnode, 8 envs, hidden 64, a 100,000-item buffer, batch 64,
# learn_every 1, n_step 3, value_transform): 8 episodes of 500 steps in
# lockstep. Card against CPU at the same width (TF32 off): Q-values within
# 1e-5 of the largest |Q|, a learn step's loss within 1e-5 of itself, its
# gradient within 1e-5 of its largest element, the parameters after Adam on
# the card from the CPU's gradients within 1e-6 (as the GDE training
# phase holds AdamW); graphs, masks, busy
# flags and selections identical. The busy share from a traced block of
# MARL_TRACE_STEPS steps with learning; ms per learn step over
# MARL_LEARN_REPS steps.
MARL_ENVS, MARL_HIDDEN, MARL_BUFFER, MARL_BATCH = 8, 64, 100_000, 64
MARL_Q_RTOL, MARL_LOSS_RTOL, MARL_GRAD_RTOL, MARL_OPT_ATOL = 1e-5, 1e-5, 1e-5, 1e-6
MARL_TRACE_STEPS, MARL_LEARN_REPS = 5, 20
# Learning from the dispatcher and on-policy MARL (experiments/medium_bc.py,
# medium_dagger.py, medium_mappo.py, medium_coma_curve.py at their width):
# 8 medium envs, net gnode, hidden 64; BC 2 epochs at batch 64; one DAgger
# round at beta 0.25 then 1 epoch; MAPPO ppo_epochs 2, minibatch 128; COMA
# batch 64, buffer 50,000, 8 updates a stride, learn_every 4. The MAPPO
# collection's busy share from a traced collection of LFE_TRACE_STEPS steps.
# Every rollout of the phase but COMA's stride (run_marl's episode is the
# config's 500 steps) runs LFE_STEPS steps, and the served trained policies
# of the marl and recurrent phases SERVED_STEPS: depth cut so that the whole
# script keeps within its time (the medium episode is 500).
LFE_ENVS, LFE_HIDDEN, BC_BATCH, BC_EPOCHS, DAGGER_BETA = 8, 64, 64, 2, 0.25
LFE_STEPS, SERVED_STEPS = 100, 200
MAPPO_EPOCHS, MAPPO_MINIBATCH = 2, 128
COMA_BATCH, COMA_BUFFER, COMA_UPDATES, COMA_LEARN_EVERY = 64, 50_000, 8, 4
LFE_TRACE_STEPS = 5
# The recurrent models. The baselines at the flagship's shape (medium,
# partial observations, D = 435, N = 28, windows of 5, hidden 128, batch 32)
# on BASE_ENVS episodes of BASE_STEPS steps that the port's rollout records,
# train_baseline for BASE_EPOCHS epochs each; ms per step best of 3 x
# BASE_REPS. Graph-GRU IQL at scripts/run_gru.py's recipe (hidden 256, a
# 20,000-item buffer, batch 32, a learn step every env step, n_step 3) for
# one stride of GRU_ENVS envs x 500 steps; card against CPU over the first
# GRU_CHECK_STEPS env steps, with the MARL tolerances.
BASE_ENVS, BASE_STEPS, BASE_EPOCHS, BASE_HIDDEN, BASE_BATCH, BASE_REPS = 8, 100, 3, 128, 32, 10
GRU_ENVS, GRU_HIDDEN, GRU_BATCH, GRU_BUFFER, GRU_CHECK_STEPS = 8, 256, 32, 20_000, 20
# Export and the committed artifacts: the four committed dispatch policies,
# each exported on the card and on the CPU and held on EXPORT_OBS
# observations of a seeded rollout of its env (SERVED_POLICY on SERVE_ENVS);
# SERVED_POLICY's card artifact then drives SERVE_ENVS medium envs for an
# episode (scripts/serve_policy.py's loop, batched).
POLICY_BLOBS = ("policy_qmix_coordtrain20k", "policy_qmix_large_coordtrain",
                "policy_dagger_clone_r4", "policy_dagger_clone_large_r4")
SERVED_POLICY, EXPORT_OBS, SERVE_ENVS = "policy_qmix_coordtrain20k", 16, 64
# Profiling and data parallelism: StageTimer over MESH_STEPS steps of the
# main path; a device sleep of about MESH_SLEEP_S for the block_on gate;
# MAPPO at tests/test_mappo.py's mesh parity config.
MESH_STEPS, MESH_SLEEP_S = 20, 0.05
MESH_MAPPO = dict(env_id="tarware-tiny-3agvs-2pickers-partialobs-v1", net="gnn", hidden_dim=8,
                  num_envs=4, num_strides=2, steps_override=30, minibatch=16, ppo_epochs=1,
                  coordinated=True, seed=3)
# Card against CPU for one MAPPO minibatch: a collection of this many steps
# (8 envs: 160 samples, of which the minibatch takes 128).
MAPPO_CHECK_STEPS = 20
# Trajectory evaluation: the committed flagship (gde_medium_h4w) scored by
# analysis.evaluate_gde over the first EVAL_WINDOWS windows of the first
# EVAL_EPISODES episodes that the datagen phase captured, in batches of
# EVAL_BATCH (the collision metric's (1, windows, windows, 28) distances:
# 117 MB at 1,024); the four baselines (seeded weights, BASE_HIDDEN) over
# BASE_EVAL_WINDOWS. Card against CPU: predictions within 1e-4 of the
# largest; the metrics within what that moves (assert_eval_agrees).
# Gates on the flagship: next-step mean error under EVAL_MAX_ERROR cells,
# success@2.0 above EVAL_MIN_SUCCESS. RESULTS.md's numbers for it (other
# data: printed beside, no gate).
EVAL_EPISODES, EVAL_WINDOWS, EVAL_BATCH, BASE_EVAL_WINDOWS = 3, 1024, 64, 256
EVAL_PRED_RTOL, EVAL_MAX_ERROR, EVAL_MIN_SUCCESS = 1e-4, 1.0, 0.9
RESULTS_FLAGSHIP = {"mean_error": 0.301, "success_rate@1.0": 0.964, "collision_f1": 0.875}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"[{phase}] FAILED: {msg}")


def _paced_ms(fn, reps: int):
    """Mean device time of fn() over reps calls, after one warm-up, or None.
    The calls queue up behind a device-side sleep sized from the host's time
    to issue them, so a function shorter than its Python (K1 and K2 are) is
    timed on the device, not at the host's issue rate. The mean stands only
    if the start event was still pending when the last call was queued (the
    device was still asleep); if not, the sleep is lengthened and the calls
    timed again, and if that never holds (fn synchronises, or its launches
    overflow the launch queue), the answer is None."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for pace in (2, 8, 32):
        torch.cuda._sleep(int(min(pace * reps * issue_s, 1.0) * SM_CYCLES_PER_S))
        start.record()
        for _ in range(reps):
            fn()
        asleep = not start.query()
        end.record()
        torch.cuda.synchronize()
        if asleep:
            return start.elapsed_time(end) / reps
    return None


def cuda_time_ms(fn, reps: int) -> float:
    """`_paced_ms` of a kernel wrapper (one launch a call); fails if the
    device woke before the last launch was queued."""
    ms = _paced_ms(fn, reps)
    if ms is None:
        fail("timing", f"the device woke before the last of {reps} launches was queued, even "
             "behind a sleep of 32x their issue time")
    return ms


def device_ms(fn, reps: int, what: str) -> float:
    """Device ms per call of a function of several launches (a plain
    version, a plan, a library call): `_paced_ms` where it holds, else the
    device's busy time per call in a trace (`trace_ms`)."""
    ms = _paced_ms(fn, reps)
    if ms is None:
        ms = trace_ms(fn, reps)
        say("timing", f"{what}: cannot be queued behind a sleep; device busy time from a "
            f"trace: {ms:.4f} ms")
    return ms


def _traced(fn, reps: int):
    """The device events (kernels, copies) that a torch.profiler trace of
    reps calls of fn() records. A first cycle of reps calls is traced and
    dropped: a trace loses launches at its start more often."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    # The step's annotation on the device's timeline (ProfilerStep#n) spans
    # the whole cycle and is no device work.
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")
            and not getattr(e, "is_user_annotation", False)]


def trace_ms(fn, reps: int, kernel=None) -> float:
    """From torch.profiler traces of reps calls of fn(), after a warm-up.
    With `kernel`: the mean duration of the launches whose name holds it
    (one a call), the kernel's own time; a trace that lost launches adds
    those it holds, and traces are taken until reps launches are held.
    Without: the device's busy time per call (`busy_per_call`). No host
    pacing reaches either. Fails after TRACE_TRIES traces."""
    if kernel is None:
        return busy_per_call(fn, reps)[1]
    import torch

    fn()
    torch.cuda.synchronize()
    us = []
    for attempt in range(1, TRACE_TRIES + 1):
        got = [e.time_range.elapsed_us() for e in _traced(fn, reps) if kernel in e.name]
        us += got
        if len(us) >= reps:
            return sum(us) / 1e3 / len(us)
        if attempt < TRACE_TRIES:
            say("timing", f"a trace of {reps} calls held {len(got)} launches of {kernel}; "
                f"{len(us)} held in all, tracing again")
    fail("timing", f"{TRACE_TRIES} traces of {reps} calls held {len(us)} launches of {kernel}")


def busy_per_call(fn, reps: int):
    """(device events, device busy ms) per call of fn(): every kernel and
    copy of fn() in a torch.profiler trace of reps calls after a warm-up,
    without the gaps between them, from a trace holding the most device
    events seen, once two traces agree on that count (a lossy trace would
    read short). After TRACE_TRIES traces whose largest count only one
    held (one H100 trace held one event more than seven others), the
    largest count two traces agree on, printed as such; fails if no two
    agree."""
    import torch

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(TRACE_TRIES):
        dev = _traced(fn, reps)
        seen.append((len(dev), sum(e.time_range.elapsed_us() for e in dev)))
        most = max(n for n, _ in seen)
        agree = [busy for n, busy in seen if n == most]
        if most and len(agree) >= 2:
            return most / reps, agree[0] / 1e3 / reps
    counts = [n for n, _ in seen]
    agreed = [n for n in counts if n and counts.count(n) >= 2]
    if not agreed:
        fail("timing", f"no two of {TRACE_TRIES} traces held the same count of device events "
             f"(events per trace: {counts})")
    most = max(agreed)
    say("timing", f"the largest count of device events was held by one trace only; the "
        f"largest two agree on: {most} (events per trace: {counts})")
    return most / reps, next(busy for n, busy in seen if n == most) / 1e3 / reps


def at_least_bound(what: str, ms: float, bound_ms: float) -> None:
    """A time below the least time the card could take for the work means
    the timing missed some of it."""
    if ms < bound_ms:
        fail("timing", f"{what}: {ms:.4f} ms is below its bound {bound_ms:.4f} ms")


def kernel_time_ms(fn, reps: int, kernel: str):
    """(event mean, trace mean) in ms of a kernel wrapper fn(); fails if
    they differ by more than TRACE_RTOL of the trace."""
    ms, tr = cuda_time_ms(fn, reps), trace_ms(fn, reps, kernel)
    if abs(ms - tr) > TRACE_RTOL * tr:
        fail("timing", f"{kernel}: event mean {ms:.4f} ms and trace mean {tr:.4f} ms differ "
             f"by more than {TRACE_RTOL:.0%} of the trace")
    return ms, tr


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time for `nbytes` moved and `ops`
    done, at the card's published peaks."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bfs_bound(pas, out_bytes_per_row: int):
    """Bound of a BFS kernel on K rows of masks `pas` (one byte a cell): the
    masks, target and position in, `out_bytes_per_row` out; a BFS visits each
    cell once (four neighbour reads and an add: 5 operations)."""
    K = pas.shape[0]
    return bound(pas.numel() + K * (8 + out_bytes_per_row), 5 * pas.numel())


def phase_card():
    import torch

    if not torch.cuda.is_available():
        fail("card", "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("card", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi name, power.limit:")
    print(smi, flush=True)
    return smi


def ptxas_usage(log: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from nvcc's -Xptxas -v report."""
    usage, name, spills = {}, None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            usage[name] = (int(m.group(1)), *spills)
    return usage


def phase_build():
    """Builds the kernels; returns {instantiation: (registers, spill store,
    spill load bytes)} of K3 (`bfs_dist_kernel<S>`) and of the query kernel
    of K1 and K2 (`bfs_query_kernel<S>`): S = 1 and 2 the register forms
    (S = 1 at medium), S = 0 the shared-memory form."""
    from swarm_ode_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    log = path.with_suffix(".log").read_text()
    report = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    say("build", f"{path.name} in {dt:.1f} s; ptxas: " + " | ".join(report))
    regs = {}
    for mangled, use in ptxas_usage(log).items():
        m = re.search(r"(bfs_dist_kernel|bfs_query_kernel)ILi(\d)E", mangled)
        if m:
            regs[f"{m.group(1)}<{m.group(2)}>"] = use
    say("build", "BFS kernel instantiations (registers, spill stores, spill loads): "
        + ", ".join(f"{k}: {v}" for k, v in sorted(regs.items())))
    for name in ("bfs_dist_kernel<1>", "bfs_query_kernel<1>"):
        if name not in regs or regs[name][1] or regs[name][2]:
            fail("build", f"{name} (the medium form): {regs.get(name)} (expected no spills)")
    return regs


def state_occupancy(pp, state):
    """(B, H, W) bool: the cells agents stand on."""
    import torch

    B = state.agent_dir.shape[0]
    H, W = pp.grid_h, pp.grid_w
    xy = state.agent_xy
    occ = torch.zeros(B, H * W, dtype=torch.bool, device=xy.device)
    occ.scatter_(1, (xy[..., 1] * W + xy[..., 0]).long(), True)
    return occ.view(B, H, W)


def real_rows(pp, state):
    """Every agent's replan query in `state` (all B*A rows, uncompacted), in
    the kernels' occupancy form: (occ, env, cls, base, tgt, pos)."""
    import torch

    from swarm_ode_tpu_torch.env.state import agent_class
    from swarm_ode_tpu_torch.ops import bfs_pallas

    B, A = state.agent_dir.shape
    Ws = pp.grid_w + 1
    xy = state.agent_xy
    tgt = pp.action_cells[(state.agent_target - 1).clamp(min=0).long()]
    _, env, cls, tgtK, posK = bfs_pallas.compact_rows(
        tgt[..., 0] * Ws + tgt[..., 1], xy[..., 1] * Ws + xy[..., 0], agent_class(pp),
        torch.ones(B, A, dtype=torch.bool, device=xy.device), row_frac=1.0, rows_per_block=128,
    )
    return bfs_pallas.walled_rows(state_occupancy(pp, state)), env, cls, pp.replan_base, tgtK, posK


def random_envs(H, W, B, K, seed, device, blocked=False):
    """Occupancy-form query rows over B random envs (10% of cells occupied;
    class 1 on a random highway of 85% of the cells), own cells on every
    edge and corner. With `blocked`, every target and own cell lies on a
    cell its row blocks (occupied, off the highway, or the wall column),
    which the kernel must free."""
    import torch

    from swarm_ode_tpu_torch.ops import bfs_pallas

    g = torch.Generator().manual_seed(seed)
    Ws = W + 1
    grid = torch.rand(B, H, W, generator=g) < 0.1
    base = bfs_pallas.class_base_rows(torch.rand(H, W, generator=g) < 0.85)
    env = torch.randint(0, B, (K,), generator=g)
    cls = torch.randint(0, 2, (K,), generator=g)
    ty, tx = torch.randint(0, H, (K,), generator=g), torch.randint(0, W, (K,), generator=g)
    py, px = torch.randint(0, H, (K,), generator=g), torch.randint(0, W, (K,), generator=g)
    py[0::4], px[1::4], py[2::4], px[3::4] = 0, 0, H - 1, W - 1
    if blocked:
        grid[env, ty, tx] = True
        grid[env, py, px] = True
        tx[0::3] = W  # the wall column
    occ = bfs_pallas.walled_rows(grid)
    rows = (occ, env.int(), cls.int(), base, (ty * Ws + tx).int(), (py * Ws + px).int())
    return _on(rows, device)


def _on(rows, device):
    """Query rows moved to `device`, the occupancy and base rows kept
    16-byte aligned there."""
    import torch

    occ, env, cls, base, tgt, pos = rows
    out = []
    for r in (occ, base):
        buf = torch.zeros(r.shape[0], r.stride(0), dtype=torch.bool, device=device)
        buf[:, :r.shape[1]] = r
        out.append(buf[:, :r.shape[1]])
    return out[0], env.to(device), cls.to(device), out[1], tgt.to(device), pos.to(device)


def with_targets(rows, tgt):
    return (*rows[:4], tgt, rows[5])


def query_plain(kernel, rows, H, W, iters):
    """The plain version of K1 or K2 on occupancy-form rows: `_passable_rows`
    then the kernel's own plain query."""
    from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas

    plain = {"K1": bfs_bitpack.bitpack_query_plain, "K2": bfs_pallas.query_plain}[kernel]
    return plain(bfs_pallas._passable_rows(*rows), rows[4], rows[5], H, W, iters)


def query_call(kernel, rows, H, W, iters):
    from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas

    call = {"K1": bfs_bitpack.bitpack_query_call, "K2": bfs_pallas.query_call}[kernel]
    return call(*rows, H, W, iters)


def row_length(kernel, H, W):
    """L, the padded row the kernel's first frontier wraps in."""
    from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas

    return 32 * bfs_bitpack._plan(H, W)[2] if kernel == "K1" else bfs_pallas.query_length(H, W)


def query_bound(rows, H, W):
    """(bound_ms, bound_by) of the fused query on `rows`: the occupancy rows
    of the envs it reads, once each, the two base rows, 16 bytes a row in
    (env, class, target, own cell) and 8 out; a BFS visits each cell once
    (four neighbour reads and an add: 5 operations a cell)."""
    import torch

    occ, env, *_ = rows
    K, n = env.shape[0], occ.shape[1]
    envs = int(torch.unique(env[(env >= 0) & (env < occ.shape[0])]).numel())
    return bound(envs * n + 2 * n + 24 * K, 5 * K * n)


def phase_kernels(layout_cache, regs):
    """K1 and K2 against their own plain versions on the card; times and
    bounds at the main path's 12,672 rows."""
    import torch

    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env import pathfinding
    from swarm_ode_tpu_torch.env.layout import build_layout
    from swarm_ode_tpu_torch.env.state import agent_class, make_params
    from swarm_ode_tpu_torch.ops import bfs_pallas
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

    cfg = EnvConfig.from_env_id(MEDIUM)
    lay = build_layout(cfg)
    pp = make_params(cfg, lay, "cuda")
    layout_cache["medium"] = (cfg, lay, pp)
    H, W, iters = pp.grid_h, pp.grid_w, pp.dynamic_bfs_iters
    Ws, n = W + 1, pp.grid_h * (pp.grid_w + 1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    state = heuristic_rollout(pp, lay, BATCH, 40, gen).state
    layout_cache["state"] = state
    real = real_rows(pp, state)
    # The main path's compacted rows a step; the real rows must cover them.
    K = bfs_pallas._round_up(int(BATCH * pp.num_agents * pp.replan_row_frac), 128)
    if real[1].shape[0] < K:
        fail("kernels", f"the medium env rows hold {real[1].shape[0]} rows, fewer than the "
             f"main path's K = {K}")
    both = ("K1", "K2")
    cases = [("medium env rows", H, W, iters, real, both)]
    cases += [(f"medium random, {it} sweeps", H, W, it, random_envs(H, W, 256, 4096, 2 + it, "cuda"),
               both) for it in (0, 1, 8, 32, 200)]
    xl = EnvConfig.from_env_id("tarware-extralarge-14agvs-7pickers-partialobs-v1")
    xH, xW = build_layout(xl).grid_size
    cases.append((f"extralarge {xH}x{xW} random", xH, xW, 40,
                  random_envs(xH, xW, 256, 4096, 4, "cuda"), both))
    cases.append(("80x30 random", 80, 30, 64, random_envs(80, 30, 64, 1024, 5, "cuda"), both))
    cases.append(("medium blocked targets and own cells", H, W, iters,
                  random_envs(H, W, 256, 4096, 6, "cuda", blocked=True), both))
    # Walled widths of 32 and more, which K1 refuses: the shared-memory form.
    cases += [(f"{h}x{w} random (Ws = {w + 1})", h, w, 2 * (h + w),
               random_envs(h, w, 16, 512 if h < 100 else 128, 7 + w, "cuda"), ("K2",))
              for h, w in ((20, 40), (16, 63), (150, 150))]
    # Every walled target in [-3Ws, L + 3Ws) of each kernel's padded row L,
    # and the int32 extremes.
    for k in both:
        L = row_length(k, H, W)
        ts = torch.cat([torch.arange(-3 * Ws, L + 3 * Ws),
                        torch.tensor([-1, -2**31, 2**31 - 1])]).int().cuda()
        rows = random_envs(H, W, 64, ts.shape[0], 8, "cuda")
        cases.append((f"medium target sweep [-3Ws, L + 3Ws), L = {L}", H, W, iters,
                      with_targets(rows, ts), (k,)))

    max_err = {"K1": 0, "K2": 0}
    for name, h, w, it, rows, kernels in cases:
        mism = {}
        for k in kernels:
            d0, nd0 = query_plain(k, rows, h, w, it)
            d, nd = query_call(k, rows, h, w, it)
            torch.cuda.synchronize()
            mism[f"{k} vs plain"] = int(((d != d0) | (nd != nd0)).sum())
            max_err[k] = max(max_err[k], int((d - d0).abs().max()), int((nd - nd0).abs().max()))
        reached = float((d0 < bfs_pallas.INF).float().mean())
        say("kernels", f"{name}: {rows[1].shape[0]} rows, n={rows[0].shape[1]}, {it} sweeps, "
            f"reached {reached:.3f}, mismatches {mism}")
        if any(mism.values()):
            fail("kernels", f"{name}: {mism}")

    # K1 against K2 where the two JAX kernels agree: targets in the grid, and
    # in the margin row with t + Ws < 32*words.
    M = row_length("K1", H, W)
    margin = torch.arange(n, n + Ws, dtype=torch.int32, device="cuda")
    margin = margin[margin + Ws < M].repeat(64)
    for name, rows in (("medium env rows", real),
                       ("medium margin-row targets",
                        with_targets(random_envs(H, W, 64, margin.shape[0], 9, "cuda"), margin))):
        d1, nd1 = query_call("K1", rows, H, W, iters)
        d2, nd2 = query_call("K2", rows, H, W, iters)
        mism = int(((d1 != d2) | (nd1 != nd2)).sum())
        say("kernels", f"K1 vs K2, {name}: {rows[1].shape[0]} rows, mismatches {mism}")
        if mism:
            fail("kernels", f"K1 and K2 differ on {mism} rows of {name}")

    # The replan query as the env step calls it: no host sync.
    B, A = state.agent_dir.shape
    tgt_yx = pp.action_cells[(state.agent_target - 1).clamp(min=0).long()]
    need = torch.rand(B, A, device="cuda", generator=gen) < 0.2
    occupied = state_occupancy(pp, state)
    torch.cuda.synchronize()
    for kernel in ("bitpack32", "int32"):
        p = dataclasses.replace(pp, bfs_kernel=kernel)
        torch.cuda.set_sync_debug_mode("error")
        try:
            pathfinding.replan_query(p, occupied, tgt_yx, state.agent_xy.flip(-1),
                                     agent_class(pp), need)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    say("kernels", "replan_query (both kernels) on the card with host synchronisation "
        "forbidden: passed")

    # Times at the main path's shape: 12,672 of the real rows, spread over
    # the envs as the compaction spreads them (about 6 an env).
    pick = torch.randperm(B * A, generator=torch.Generator().manual_seed(3))[:K].sort().values
    pick = pick.cuda()
    rows = (real[0], *(t.index_select(0, pick).contiguous() for t in real[1:3]), real[3],
            *(t.index_select(0, pick).contiguous() for t in real[4:]))
    t = {}
    for k in both:
        ms, tr = kernel_time_ms(lambda: query_call(k, rows, H, W, iters), 200, "bfs_query_kernel")
        t[k] = {
            "ms": ms,
            "trace_ms": tr,
            "ms_200_sweeps": cuda_time_ms(lambda: query_call(k, rows, H, W, 200), 200),
            "plain_ms": device_ms(lambda: query_plain(k, rows, H, W, iters), 10, f"{k} plain"),
        }
    mask_ms = device_ms(lambda: bfs_pallas._passable_rows(*rows), 20, "mask build")
    qb, old_b = query_bound(rows, H, W), bfs_bound(bfs_pallas._passable_rows(*rows), 8)
    for k in both:
        for key in ("ms", "trace_ms", "ms_200_sweeps", "plain_ms"):
            at_least_bound(f"{k} {key}", t[k][key], qb[0])
        t[k].update(bound_ms=qb[0], bound_by=qb[1], mask_build_ms=mask_ms,
                    mask_row_bound_ms=old_b[0], max_abs_err=max_err[k],
                    registers={r: v for r, v in regs.items() if r.startswith("bfs_query")})
        say("kernels", f"{k} at K={K} rows over {int(torch.unique(rows[1]).numel())} envs, n={n}: "
            f"{t[k]['ms']:.4f} ms at {iters} sweeps (trace {t[k]['trace_ms']:.4f}), "
            f"{t[k]['ms_200_sweeps']:.4f} ms at 200; plain "
            f"{t[k]['plain_ms']:.4f} ms; bound {qb[0]:.4f} ms ({qb[1]}), roofline share "
            f"{qb[0] / t[k]['ms']:.3f}; earlier yardstick, the (K, n) mask-row bound: "
            f"{old_b[0]:.4f} ms ({old_b[1]})")
    say("kernels", f"the mask build the kernel replaces (_passable_rows, its gather "
        f"included, on the same rows): {mask_ms:.4f} ms")
    return t


def _states_equal(a, b):
    return all(
        torch_equal(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)
    )


def torch_equal(x, y) -> bool:
    import torch

    return x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


def phase_card_vs_cpu(layout_cache):
    import torch

    from swarm_ode_tpu_torch import convert
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.ops import bfs_bitpack
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

    cfg, lay, pp_gpu = layout_cache["medium"]
    pp_cpu = make_params(cfg, lay, "cpu")
    B, T = 64, 50
    g = torch.Generator().manual_seed(5)
    s_cpu = step_mod.reset(pp_cpu, B, g)
    noise_cpu = [step_mod.draw_noise(pp_cpu, B, g) for _ in range(T)]
    noise_gpu = [
        step_mod.StepNoise(None if n.break_r is None else n.break_r.cuda(), n.delivery_gumbel.cuda())
        for n in noise_cpu
    ]
    s_gpu = convert.env_state_to(s_cpu, "cuda")
    bfs_bitpack.LAUNCHES = 0
    t0 = time.perf_counter()
    gpu = heuristic_rollout(pp_gpu, lay, B, T, state=s_gpu, noise=noise_gpu, record=True)
    torch.cuda.synchronize()
    t_gpu, k1 = time.perf_counter() - t0, bfs_bitpack.LAUNCHES
    if k1 != T:
        fail("card-vs-cpu", f"K1 launched {k1} times in {T} steps")
    t0 = time.perf_counter()
    cpu = heuristic_rollout(pp_cpu, lay, B, T, state=s_cpu, noise=noise_cpu, record=True)
    t_cpu = time.perf_counter() - t0
    for t, (g_step, c_step) in enumerate(zip(gpu.trace, cpu.trace)):
        ga, gr, ginfo, gs = g_step
        ca, cr, cinfo, cs = c_step
        same = (torch_equal(ga, ca) and torch_equal(gr, cr) and _states_equal(gs, cs)
                and all(torch_equal(ginfo[k], cinfo[k]) for k in cinfo))
        if not same:
            fail("card-vs-cpu", f"card and CPU differ at step {t}")
    deliv = int(cpu.deliveries.sum())
    say("card-vs-cpu", f"B={B}, {T} steps: states, actions, rewards and info identical on "
        f"every step ({deliv} deliveries, {int(cpu.clashes.sum())} clashes, overflow "
        f"{int(cpu.replan_overflow.sum())}); card {t_gpu:.2f} s, CPU {t_cpu:.2f} s")
    if deliv == 0:
        fail("card-vs-cpu", "no deliveries: the comparison exercised too little")
    return experts_card_vs_cpu(pp_gpu, pp_cpu, lay, s_cpu, noise_cpu, g)


def expert_steps(pp, lay, state, noise, dispatch_noise):
    """The stochastic expert (T = 1.0) driving B envs from `state` with the
    given draws; at each step also the stateless expert's actions and the
    action masks of the same state. Returns ([(actions, stateless actions,
    masks, HeuristicState)] per step, final state)."""
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.observations import compute_valid_action_masks
    from swarm_ode_tpu_torch.policies import heuristic as heur

    stoch = heur.make_policy(pp, lay, temperature=1.0)
    expert = heur.make_stateless_expert(pp, lay)
    h = heur.init_state(pp, state.batch)
    out = []
    for n, dn in zip(noise, dispatch_noise):
        a, h = stoch(pp, state, h, dn)
        out.append((a, expert(pp, state), compute_valid_action_masks(pp, state), h))
        state, *_ = step_mod.step(pp, state, a, noise=n)
    return out, state


def experts_card_vs_cpu(pp_gpu, pp_cpu, lay, s_cpu, noise_cpu, g):
    """The experts and datagen, card against CPU from one reset with
    the same draws (made on the CPU): every step's stochastic actions and
    HeuristicState, stateless actions and masks, and collect_batch's
    captured arrays (float16 compared as bits) identical. Returns K1's
    launches in the stochastic expert's run on the card."""
    import numpy as np
    import torch

    from swarm_ode_tpu_torch import convert
    from swarm_ode_tpu_torch.data.collect import collect_batch
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.ops import bfs_bitpack
    from swarm_ode_tpu_torch.policies import heuristic as heur

    B, T = s_cpu.batch, len(noise_cpu)
    dnoise_cpu = [heur.draw_dispatch_noise(pp_cpu, B, g) for _ in range(T)]
    noise_gpu = [step_mod.StepNoise(None, n.delivery_gumbel.cuda()) for n in noise_cpu]
    dnoise_gpu = [heur.DispatchNoise(d.assign.cuda(), d.goal.cuda(), d.ret.cuda())
                  for d in dnoise_cpu]
    s_gpu = convert.env_state_to(s_cpu, "cuda")
    bfs_bitpack.LAUNCHES = 0
    t0 = time.perf_counter()
    gpu, gs = expert_steps(pp_gpu, lay, s_gpu, noise_gpu, dnoise_gpu)
    torch.cuda.synchronize()
    t_gpu, k1 = time.perf_counter() - t0, bfs_bitpack.LAUNCHES
    t0 = time.perf_counter()
    cpu, cs = expert_steps(pp_cpu, lay, s_cpu, noise_cpu, dnoise_cpu)
    t_cpu = time.perf_counter() - t0
    for t, (x, y) in enumerate(zip(gpu, cpu)):
        for what, a, b in zip(("stochastic actions", "stateless actions", "masks"), x, y):
            if not torch_equal(a, b):
                fail("card-vs-cpu", f"{what} differ at step {t}")
        if not _states_equal(x[3], y[3]):
            fail("card-vs-cpu", f"the stochastic expert's HeuristicState differs at step {t}")
    if not _states_equal(gs, cs):
        fail("card-vs-cpu", "the stochastic expert's final states differ")
    if k1 != T:
        fail("card-vs-cpu", f"K1 launched {k1} times in the stochastic expert's {T} steps")
    agree = float(np.mean([(a == f).float().mean().item() for a, f, _, _ in cpu]))
    say("card-vs-cpu", f"B={B}, {T} steps of the stochastic expert (T = 1.0) with the "
        f"stateless expert and the action masks at every state: identical on every step "
        f"(stateless vs stochastic actions agree on {agree:.3f}); card {t_gpu:.2f} s, CPU "
        f"{t_cpu:.2f} s")

    chunk = 20
    t0 = time.perf_counter()
    got, gstats = collect_batch(pp_gpu, lay, B, T, chunk, state=s_gpu, noise=noise_gpu)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, _ = collect_batch(pp_cpu, lay, B, T, chunk, state=s_cpu, noise=noise_cpu)
    t_cpu = time.perf_counter() - t0
    for k in want:
        a, b = got[k], want[k]
        if a.dtype == np.float16:
            a, b = a.view(np.uint16), b.view(np.uint16)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            fail("card-vs-cpu", f"collect_batch's {k} differs")
    say("card-vs-cpu", f"collect_batch, B={B}, {T} steps in chunks of {chunk}: all "
        f"{len(want)} captured keys identical (observations as float16 bits; "
        f"{int(gstats['deliveries'].sum())} deliveries); card {t_gpu:.2f} s, CPU "
        f"{t_cpu:.2f} s")
    return k1


def phase_main_path(layout_cache):
    import torch

    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

    cfg, lay, pp = layout_cache["medium"]
    # bench.py's --bfs_kernel option: the same main path through K2.
    pp32 = make_params(dataclasses.replace(cfg, bfs_kernel="int32"), lay, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def timed(params):
        t0 = time.perf_counter()
        out = heuristic_rollout(params, lay, BATCH, STEPS, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        overflow = int(out.replan_overflow.sum())
        if overflow:
            fail("main-path", f"{params.bfs_kernel}: replan_overflow summed to {overflow}")
        return BATCH * STEPS / dt, float(out.deliveries.float().mean())

    heuristic_rollout(pp, lay, BATCH, STEPS, gen)  # warm-up
    torch.cuda.synchronize()

    # The counted run: the main path once in each kernel setting, default
    # first. Each setting launches its own kernel once per step, the other
    # never, and the kernels build their rows: no (K, n) mask is made.
    mask_builds = []
    plain_rows = bfs_pallas._passable_rows

    def counted_rows(*args):
        mask_builds.append(1)
        return plain_rows(*args)

    bfs_pallas._passable_rows = counted_rows
    try:
        bfs_bitpack.LAUNCHES = 0
        bfs_pallas.LAUNCHES = 0
        runs = [timed(pp)]
        by_setting = {"bitpack32": {"K1": bfs_bitpack.LAUNCHES, "K2": bfs_pallas.LAUNCHES}}
        rate32, deliv32 = timed(pp32)
        launches = {"K1": bfs_bitpack.LAUNCHES, "K2": bfs_pallas.LAUNCHES}
    finally:
        bfs_pallas._passable_rows = plain_rows
    by_setting["int32"] = {k: launches[k] - by_setting["bitpack32"][k] for k in launches}
    expect = {"bitpack32": {"K1": STEPS, "K2": 0}, "int32": {"K1": 0, "K2": STEPS}}
    if by_setting != expect:
        fail("main-path", f"launch counts {by_setting}, expected {expect}")
    if mask_builds:
        fail("main-path", f"_passable_rows built (K, n) masks {len(mask_builds)} times")
    say("main-path", f"medium B={BATCH}, {STEPS} steps, launches per kernel setting: "
        f"{by_setting}; overflow 0; (K, n) masks built: 0")

    runs += [timed(pp) for _ in range(2)]
    say("main-path", f"bitpack32 runs (steps/s, deliveries per env): "
        + ", ".join(f"({r:.1f}, {d:.3f})" for r, d in runs)
        + f"; int32, one run after the first: ({rate32:.1f}, {deliv32:.3f})")
    best = max(r for r, _ in runs)
    say("main-path", f"batched_env_steps_per_sec {best:.1f}")

    # From one start state and one set of draws both kernels give identical
    # steps (these launches are a comparison and are not counted above).
    g = torch.Generator(device="cuda").manual_seed(9)
    start = heuristic_rollout(pp, lay, BATCH, 30, g).state
    noise = [step_mod.draw_noise(pp, BATCH, g) for _ in range(5)]
    a = heuristic_rollout(pp32, lay, BATCH, 5, state=start, noise=noise)
    b = heuristic_rollout(pp, lay, BATCH, 5, state=start, noise=noise)
    torch.cuda.synchronize()
    if not _states_equal(a.state, b.state):
        fail("main-path", "int32 and bitpack32 rollouts differ")
    say("main-path", f"bfs_kernel=int32 vs bitpack32, B={BATCH}, 5 steps from one state "
        "with the same draws: states identical")
    return by_setting, best


def random_fields(H, W, K, seed, device, impassable=False):
    """Random (K, H, W) grids with targets on every edge and corner, one
    target on a blocked cell (it still starts at 0), or every target on one
    when `impassable`."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pas = torch.rand(K, H, W, generator=g) < 0.75
    ty, tx = torch.randint(0, H, (K,), generator=g), torch.randint(0, W, (K,), generator=g)
    ty[0::5], tx[1::5], ty[2::5], tx[3::5] = 0, 0, H - 1, W - 1
    pas[torch.arange(K), ty, tx] = not impassable
    pas[4, ty[4], tx[4]] = False
    return pas.to(device), (ty * W + tx).int().to(device)


def target_sweep(H, W, device):
    """One random grid for every flat target in [-3W, 2HW + 5W) and the
    int32 extremes: in the grid, below it, in its wall row, in the padding
    that wraps to row 0, and far outside (ops/bfs_pallas.bfs_dist_plain)."""
    import torch

    ts = torch.cat([torch.arange(-3 * W, 2 * H * W + 5 * W),
                    torch.tensor([-2**31, 2**31 - 1, 2**30, 2**31 - W])]).int()
    pas = torch.rand(ts.shape[0], H, W, generator=torch.Generator().manual_seed(H * W)) < 0.8
    return pas.to(device), ts.to(device)


def phase_fields(layout_cache):
    import torch

    from swarm_ode_tpu_torch.env import pathfinding
    from swarm_ode_tpu_torch.env.state import agent_class
    from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas

    _, _, pp = layout_cache["medium"]
    state = layout_cache["state"]
    H, W, iters = pp.grid_h, pp.grid_w, pp.dynamic_bfs_iters
    B, A = state.agent_dir.shape
    xy = state.agent_xy
    occ = torch.zeros(B, H * W, dtype=torch.bool, device=xy.device)
    occ.scatter_(1, (xy[..., 1] * W + xy[..., 0]).long(), True)
    tgt = pp.action_cells[(state.agent_target - 1).clamp(min=0).long()]
    self_yx = xy.flip(-1)
    pas = pathfinding.passable_grid(pp, occ.view(B, H, W), tgt, self_yx, agent_class(pp))
    pas = pas.reshape(B * A, H, W).contiguous()
    tflat = (tgt[..., 0] * W + tgt[..., 1]).to(torch.int32).reshape(-1).contiguous()
    cases = [("medium env rows", pas, tflat, iters),
             ("medium random", *random_fields(H, W, 8192, 12, "cuda"), iters),
             ("medium random, 8 sweeps", *random_fields(H, W, 4096, 13, "cuda"), 8),
             ("80x30 random", *random_fields(80, 30, 1024, 14, "cuda"), 64),
             # Walled widths of 32 and more: the shared-memory form, +-Ws
             # carries across whole words (Ws % 32 == 0: no shift by 32).
             ("33x31 random (Ws = 32)", *random_fields(33, 31, 1024, 15, "cuda"), 80),
             ("12x63 random (Ws = 64)", *random_fields(12, 63, 1024, 16, "cuda"), 60),
             ("7x100 random (Ws = 101)", *random_fields(7, 100, 1024, 17, "cuda"), 120),
             ("150x150 random (708 words)", *random_fields(150, 150, 128, 18, "cuda"), 600),
             ("medium random, 0 sweeps", *random_fields(H, W, 2048, 19, "cuda"), 0),
             ("medium random, 1 sweep", *random_fields(H, W, 2048, 20, "cuda"), 1),
             # More sweeps than any distance needs: the early exit.
             ("medium random, 200 sweeps", *random_fields(H, W, 4096, 21, "cuda"), 200),
             ("medium random, impassable targets",
              *random_fields(H, W, 4096, 22, "cuda", impassable=True), iters)]
    cases += [(f"{h}x{w} target sweep, iters {it}", *target_sweep(h, w, "cuda"), it)
              for h, w in ((9, 8), (H, W)) for it in (1, iters)]
    max_err = 0
    for name, p, t, it in cases:
        ref = bfs_pallas.bfs_dist_plain(p, t, it)
        got = bfs_pallas.bfs_dist_call(p, t, it)
        torch.cuda.synchronize()
        mism = int((got != ref).sum())
        max_err = max(max_err, int((got.long() - ref.long()).abs().max()))
        reached = ref < bfs_pallas.INF
        say("fields", f"K3 {name}: {p.shape[0]} rows of {p.shape[1]}x{p.shape[2]}, "
            f"reached {float(reached.float().mean()):.3f}, max distance "
            f"{int(ref[reached].max()) if bool(reached.any()) else None}, mismatches {mism}")
        if mism:
            fail("fields", f"K3 {name}: {mism} mismatches")
    again = bfs_pallas.bfs_dist_call(pas, tflat, iters)
    if not torch.equal(again, bfs_pallas.bfs_dist_call(pas, tflat, iters)):
        fail("fields", "K3: two launches on the same inputs differ")
    say("fields", "K3: two launches on the medium env rows bit-identical")

    # The full field read at each own cell equals K1's own-cell query.
    dist = bfs_pallas.bfs_dist_call(pas, tflat, iters).view(B, A, H, W)
    d3, nd3 = pathfinding.dist_nextdir_at(pp, dist, pas.view(B, A, H, W), self_yx)
    d1, nd1 = bfs_bitpack.bitpack_query_call(*real_rows(pp, state), H, W, iters)
    torch.cuda.synchronize()
    mism = int(((d3.reshape(-1) != d1) | (nd3.reshape(-1) != nd1)).sum())
    say("fields", f"K3 field at the own cell vs K1 on the same {B * A} rows: mismatches {mism}")
    if mism:
        fail("fields", f"K3 own-cell read differs from K1 on {mism} rows")

    k3, k3_trace = kernel_time_ms(lambda: bfs_pallas.bfs_dist_call(pas, tflat, iters), 20,
                                  "bfs_dist_kernel")
    times = {
        "K3": k3,
        "K3, trace": k3_trace,
        "K3, 200 sweeps": cuda_time_ms(lambda: bfs_pallas.bfs_dist_call(pas, tflat, 200), 20),
        # No sweep: the mask in, the staging row and the field out alone.
        "K3, 0 sweeps": cuda_time_ms(lambda: bfs_pallas.bfs_dist_call(pas, tflat, 0), 20),
        "plain": device_ms(lambda: bfs_pallas.bfs_dist_plain(pas, tflat, iters), 5, "K3 plain"),
    }
    # In: the masks (one byte a cell) and the target; out: the int32 field.
    times["bound"] = bound(pas.numel() + 4 * B * A + 4 * pas.numel(), 5 * pas.numel())
    for k in ("K3", "K3, trace", "K3, 200 sweeps", "plain"):
        at_least_bound(k, times[k], times["bound"][0])
    say("fields", f"times at {B * A} rows, {H}x{W}, {iters} sweeps: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items() if k != "bound")
        + f"; bound {times['bound'][0]:.4f} ms ({times['bound'][1]}), roofline share "
        f"{times['bound'][0] / times['K3']:.3f}; {K3_PREVIOUS_MS} ms before the redesign (PERF.md, not this run)")
    return times, max_err


def phase_full_field(layout_cache):
    import torch

    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

    cfg, lay, _ = layout_cache["medium"]
    ppx = make_params(dataclasses.replace(cfg, bfs_backend="xla"), lay, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)

    def timed():
        t0 = time.perf_counter()
        out = heuristic_rollout(ppx, lay, BATCH, STEPS, gen)
        torch.cuda.synchronize()
        if int(out.replan_overflow.sum()):
            fail("full-field", "replan_overflow is not 0 on the full-field branch")
        return BATCH * STEPS / (time.perf_counter() - t0), float(out.deliveries.float().mean())

    heuristic_rollout(ppx, lay, BATCH, 20, gen)  # warm-up
    torch.cuda.synchronize()
    bfs_pallas.DIST_LAUNCHES = bfs_pallas.LAUNCHES = bfs_bitpack.LAUNCHES = 0
    runs = [timed()]
    launches = {"K1": bfs_bitpack.LAUNCHES, "K2": bfs_pallas.LAUNCHES,
                "K3": bfs_pallas.DIST_LAUNCHES}
    if launches != {"K1": 0, "K2": 0, "K3": STEPS}:
        fail("full-field", f"launch counts {launches}, expected K3 {STEPS} and no other")
    runs += [timed() for _ in range(2)]
    say("full-field", f"medium B={BATCH}, {STEPS} steps, bfs_backend=xla, launches {launches}; "
        "runs (steps/s, deliveries per env): "
        + ", ".join(f"({r:.1f}, {d:.3f})" for r, d in runs))
    say("full-field", f"full_field_env_steps_per_sec {max(r for r, _ in runs):.1f}")

    # Without compaction both branches run every row: identical rollouts.
    full = make_params(dataclasses.replace(cfg, bfs_backend="xla", replan_row_frac=1.0), lay, "cuda")
    comp = make_params(dataclasses.replace(cfg, replan_row_frac=1.0), lay, "cuda")
    B, T = 64, 50
    g = torch.Generator(device="cuda").manual_seed(6)
    start = step_mod.reset(full, B, g)
    noise = [step_mod.draw_noise(full, B, g) for _ in range(T)]
    a = heuristic_rollout(full, lay, B, T, state=start, noise=noise, record=True)
    b = heuristic_rollout(comp, lay, B, T, state=start, noise=noise, record=True)
    torch.cuda.synchronize()
    for t, (sa, sb) in enumerate(zip(a.trace, b.trace)):
        if not (_states_equal(sa[3], sb[3]) and torch_equal(sa[0], sb[0])):
            fail("full-field", f"full-field and compacted rollouts differ at step {t}")
    say("full-field", f"B={B}, {T} steps at replan_row_frac=1.0: full-field and compacted "
        f"states identical on every step ({int(a.deliveries.sum())} deliveries, "
        f"{int(a.clashes.sum())} clashes)")
    return launches["K3"]


def _bounded_err(got, ref, abs_sum):
    """(max |got - ref|, whether every element is within SUM_RTOL of its
    sum of magnitudes, plus 1e-6)."""
    err = (got - ref).abs()
    return float(err.max()), bool((err <= SUM_RTOL * abs_sum + 1e-6).all())


def check_k4(feats, src, dst, valid, S, smi):
    """K4 on the served edges at one width D, planned (the served form: the
    sources read through the plan, mean) and general (segment_sum_call on
    the gathered messages): against the plain versions, twice for the same
    bits, with host synchronisation forbidden for one plan and one planned
    launch; times and bounds. Returns the record's numbers."""
    import torch

    from swarm_ode_tpu_torch.ops import segment_pallas as sp

    D = feats.shape[1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = sp.segment_plan(dst, valid, S, rows=src, num_rows=S)
        got = sp.segment_sum_planned(feats, *plan, mean=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    again = sp.segment_sum_planned(feats, *plan, mean=True)
    ref = sp.segment_sum_planned_plain(feats, *plan, mean=True)
    abs_ref = sp.segment_sum_planned_plain(feats.abs(), *plan, mean=True)
    err, ok = _bounded_err(got, ref, abs_ref)
    cpu_err = float((got.cpu() - sp.segment_sum_planned_plain(
        feats.cpu(), *(t.cpu() for t in plan), mean=True)).abs().max())

    keep = valid & (dst >= 0) & (dst < S)
    msgs = feats[src.long()]
    gen = sp.segment_sum_call(msgs, dst, S, valid)
    gen_again = sp.segment_sum_call(msgs, dst, S, valid)
    gen_ref = sp.segment_sum_plain(msgs, dst, S, valid)
    gen_err, gen_ok = _bounded_err(gen, gen_ref, sp.segment_sum_plain(msgs.abs(), dst, S, valid))
    same = torch.equal(got, again) and torch.equal(gen, gen_again)
    torch.cuda.synchronize()

    # Library yardsticks, never called by the port: the served mean as a CSR
    # sparse-dense product, the segment sum as index_add_ over valid rows.
    row, offsets = plan
    M = int(offsets[-1])
    counts = offsets.diff()
    vals = (1.0 / counts.clamp(min=1).float()).repeat_interleave(counts.long(), output_size=M)
    adj = torch.sparse_csr_tensor(offsets.long(), row[:M].long(), vals, size=(S, feats.shape[0]),
                                  check_invariants=True)
    lib_err = float((torch.sparse.mm(adj, feats) - ref).abs().max())
    sel = keep.nonzero()[:, 0]
    dv, mv = dst[sel].long(), msgs[sel].contiguous()
    ms, tr = kernel_time_ms(lambda: sp.segment_sum_planned(feats, *plan, mean=True), 50,
                            "segment_sum_kernel")
    t = {
        "ms": ms,
        "trace_ms": tr,
        "plain_ms": device_ms(lambda: sp.segment_sum_planned_plain(feats, *plan, mean=True), 10,
                              f"K4 plain, D={D}"),
        "plan_ms": device_ms(lambda: sp.segment_plan(dst, valid, S, rows=src, num_rows=S), 50,
                             f"K4 plan, D={D}"),
        "library_ms": device_ms(lambda: torch.sparse.mm(adj, feats), 50, f"sparse.mm, D={D}"),
        # The plan and the kernel.
        "general_ms": device_ms(lambda: sp.segment_sum_call(msgs, dst, S, valid), 20,
                                f"K4 general, D={D}"),
        "general_plain_ms": device_ms(lambda: sp.segment_sum_plain(msgs, dst, S, valid), 10,
                                      f"K4 general plain, D={D}"),
        "general_library_ms": device_ms(
            lambda: torch.zeros(S, D, device=feats.device).index_add_(0, dv, mv), 20,
            f"index_add_, D={D}"),
    }
    # Planned: each distinct source row read once, the plan, the output;
    # an add per (edge, feature) and a division per output element.
    distinct = int(torch.unique(row[:M]).numel())
    t["bound_ms"], t["bound_by"] = bound(4 * (distinct * D + M + S + 1 + S * D), M * D + S * D)
    # General: the valid messages, every id and flag, the output; the adds.
    E = dst.shape[0]
    t["general_bound_ms"], _ = bound(4 * M * D + 5 * E + 4 * S * D, M * D)
    # index_add_ over the valid messages moves their rows and the output.
    for k, b in (("ms", t["bound_ms"]), ("trace_ms", t["bound_ms"]), ("plain_ms", t["bound_ms"]),
                 ("library_ms", t["bound_ms"]), ("general_ms", t["general_bound_ms"]),
                 ("general_plain_ms", t["general_bound_ms"]),
                 ("general_library_ms", bound(4 * M * D + 4 * S * D, M * D)[0])):
        at_least_bound(f"K4 {k}, D={D}", t[k], b)
    t.update(max_abs_err=max(err, gen_err), cpu_err=cpu_err, lib_err=lib_err)
    say("gde", f"K4 at D={D}: {E} edge slots ({M} valid, {distinct} distinct sources) into {S} "
        f"nodes. Planned mean vs plain: max abs err {err:.3e}, vs the plain version on the CPU "
        f"{cpu_err:.3e} (the design predicts 0); general sum vs plain {gen_err:.3e} (tolerance "
        f"{SUM_RTOL:.2e} x sum of |terms| + 1e-6); two launches bit-identical: {same}; plan and "
        f"planned launch with host sync forbidden: passed")
    say("gde", f"K4 at D={D} times: planned {t['ms']:.4f} ms (trace {t['trace_ms']:.4f}, plain "
        f"{t['plain_ms']:.4f}, plan "
        f"{t['plan_ms']:.4f}, torch.sparse.mm {t['library_ms']:.4f}, max abs err {lib_err:.3e}); "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), roofline share "
        f"{t['bound_ms'] / t['ms']:.3f}; general {t['general_ms']:.4f} ms (plain "
        f"{t['general_plain_ms']:.4f}, index_add_ {t['general_library_ms']:.4f}, bound "
        f"{t['general_bound_ms']:.4f}); on {smi}")
    if not (ok and gen_ok):
        fail("gde", f"K4 at D={D} is outside the tolerance (planned {ok}, general {gen_ok})")
    if not same:
        fail("gde", f"K4 at D={D}: two launches on the same inputs differ")
    return t


def phase_gde(layout_cache, smi):
    import copy

    import torch

    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.graphs import temporal
    from swarm_ode_tpu_torch.models.gde import GraphODE
    from swarm_ode_tpu_torch.ops import segment, segment_pallas
    from swarm_ode_tpu_torch.ops.sage import masked_mean_aggregate
    from swarm_ode_tpu_torch.policies.heuristic import init_state, make_policy
    from swarm_ode_tpu_torch.serving import make_gde_fn

    _, lay, pp = layout_cache["medium"]
    A = pp.num_agents
    torch.manual_seed(0)
    model_cpu = GraphODE(435, pp.num_agvs, pp.num_pickers, HIDDEN, "euler")
    model = copy.deepcopy(model_cpu).cuda()
    predict = make_gde_fn(model, None, 5.0, HORIZON)
    predict_cpu = make_gde_fn(model_cpu, None, 5.0, HORIZON)
    policy = make_policy(pp, lay)
    gen = torch.Generator(device="cuda").manual_seed(8)
    es = step_mod.reset(pp, GDE_BATCH, gen)
    h = init_state(pp, GDE_BATCH)
    w = temporal.init_window(GDE_BATCH, WINDOW, A, 435, device="cuda")

    def env_step(es, h):
        actions, h = policy(pp, es, h)
        es, _, _, _ = step_mod.step(pp, es, actions, generator=gen)
        return es, h

    def serve(es, w):
        w = temporal.push_frame(w, observe(pp, es))
        return w, predict(w.obs, w.count)

    for _ in range(WINDOW + 2):  # warm-up: fills every window
        es, h = env_step(es, h)
        w, pred = serve(es, w)
    torch.cuda.synchronize()
    segment_pallas.LAUNCHES = 0
    ms = []
    for _ in range(GDE_STEPS):
        es, h = env_step(es, h)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, pred = serve(es, w)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = segment_pallas.LAUNCHES
    # Per batch one plan, then one K4 launch for each of the 3 SAGE layers in
    # each ODE step.
    expect = GDE_STEPS * HORIZON * 3
    if launches != expect:
        fail("gde", f"K4 launched {launches} times, expected {expect}")
    if pred.shape != (GDE_BATCH, HORIZON + 1, A, 2) or not bool(torch.isfinite(pred).all()):
        fail("gde", f"predictions of shape {tuple(pred.shape)}, finite {bool(torch.isfinite(pred).all())}")
    mean_ms = sum(ms) / len(ms)
    say("gde", f"medium B={GDE_BATCH} windows of {WINDOW}x{A}x435, euler t=0..{HORIZON}, "
        f"{GDE_STEPS} served steps, K4 launches {launches}: ms per batch mean {mean_ms:.3f}, "
        f"min {min(ms):.3f}, max {max(ms):.3f}; gde_windows_per_sec {GDE_BATCH / mean_ms * 1e3:.1f}")

    g = temporal.build_temporal_batch(w.obs, w.count, pp.num_agvs, 5.0)
    src, dst, valid = temporal.temporal_edges(g)
    S = GDE_BATCH * WINDOW * A
    x = w.obs.reshape(S, 435)
    with torch.no_grad():
        hid = torch.relu(model.func.conv1.DenseSAGEConv_0.lin_r(x)).contiguous()
    k4 = {D: check_k4(feats, src, dst, valid, S, smi) for D, feats in ((435, x), (HIDDEN, hid))}

    # The sparse mean (K4) against the dense one on the same graphs.
    dense_g = temporal.build_temporal_graph(w, pp.num_agvs, 5.0)
    dense = masked_mean_aggregate(dense_g.x, dense_g.adj, dense_g.node_mask).reshape(S, 435)
    abs_mean = masked_mean_aggregate(dense_g.x.abs(), dense_g.adj, dense_g.node_mask).reshape(S, 435)
    sparse = segment.gather_scatter_mean(x, src, dst, valid, S)
    err, ok = _bounded_err(sparse, dense, abs_mean)
    say("gde", f"gather_scatter_mean (K4) vs dense masked_mean_aggregate on the card: "
        f"max abs err {err:.3e}")
    if not ok:
        fail("gde", "sparse and dense means differ beyond the tolerance")

    # The card against the CPU on 8 windows, TF32 off.
    got = predict(w.obs[:8], w.count[:8]).cpu()
    ref = predict_cpu(w.obs[:8].cpu(), w.count[:8].cpu())
    err = float((got - ref).abs().max())
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    say("gde", f"card vs CPU, 8 windows: max abs err {err:.3e} on predictions up to "
        f"{float(ref.abs().max()):.2f} (tolerance {tol:.2e}: 1e-4 of the largest)")
    if not err <= tol:
        fail("gde", "card and CPU predictions differ beyond the tolerance")
    return launches, k4


def record_episodes(pp, lay, B: int, T: int, seed: int):
    """(B, T, A, D) float32 observations of B medium episodes of T steps:
    the port's heuristic rollout, `observe` before each step."""
    import torch

    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.policies.heuristic import init_state, make_policy

    gen = torch.Generator(device="cuda").manual_seed(seed)
    policy = make_policy(pp, lay)
    es, h = step_mod.reset(pp, B, gen), init_state(pp, B)
    frames = []
    for _ in range(T):
        frames.append(observe(pp, es))
        actions, h = policy(pp, es, h)
        es, _, _, _ = step_mod.step(pp, es, actions, generator=gen)
    return torch.stack(frames, dim=1).cpu().numpy()


def _max_rel(got, ref) -> float:
    """max |got - ref| over the largest |ref| (1 where ref is all zeros)."""
    scale = float(ref.abs().max()) or 1.0
    return float((got.cpu() - ref.cpu()).abs().max()) / scale


def step_card_vs_cpu(ds, model_cpu, pairs, horizon, weights, cfg):
    """One training step on the card and on the CPU from the same
    parameters and the same 32 windows: (loss rel. error, worst gradient
    rel. error, worst parameter error beyond what the gradients' difference
    explains, worst parameter error of the card's optimizer from the CPU's
    gradients)."""
    import copy

    import numpy as np
    import torch

    from swarm_ode_tpu_torch.train import train_gde as tg

    pos = np.stack(ds._positions)
    if horizon > 1:
        pos = np.pad(pos, ((0, 0), (0, horizon), (0, 0), (0, 0)), mode="edge")
    T = ds.episodes[0].shape[0]
    out = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(model_cpu).to(dev)
        data = {"episodes": torch.from_numpy(np.stack(ds.episodes)).to(dev),
                "positions": torch.from_numpy(pos).to(dev)}
        batch = tg.window_batch(data, pairs.to(dev), ds.seq_len, horizon, T)
        params = list(model.parameters())
        loss = tg._batch_loss(model, ds.num_agvs, 5.0, horizon, weights)(batch)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            clipped = tg.clip_by_global_norm(grads, cfg.grad_clip)
            opt = tg.adamw_update(params, clipped, tg.adamw_init(params), cfg.lr,
                                  cfg.weight_decay)
        out[dev] = (loss.detach(), grads, clipped, [p.detach() for p in params], opt)
    (lg, gg, cg, pg, og), (lc, gc, cc, pc, oc) = out["cuda"], out["cpu"]
    loss_err = _max_rel(lg, lc)
    grad_err = max(_max_rel(a, b) for a, b in zip(gg, gc))
    # Adam's first update is lr * g / (|g| + eps) elementwise (decay aside):
    # where the two gradients differ by d, the updates may differ by at most
    # lr * min(2, d / (min |g| + eps)), plus float32 rounding.
    excess = 0.0
    for p_g, p_c, a, b, p0 in zip(pg, pc, cg, cc, model_cpu.parameters()):
        a, b = a.cpu(), b.cpu()
        d = (a - b).abs()
        allow = cfg.lr * torch.clamp(d / (torch.minimum(a.abs(), b.abs()) + 1e-8), max=2.0)
        allow = allow + 1e-6 * (1 + p0.detach().abs())
        excess = max(excess, float(((p_g.cpu() - p_c).abs() - allow).max()))
    # The card's optimizer from the CPU's clipped gradients: the same
    # parameters within float32 rounding.
    model = copy.deepcopy(model_cpu).cuda()
    params = list(model.parameters())
    with torch.no_grad():
        tg.adamw_update(params, [c.cuda() for c in cc], tg.adamw_init(params), cfg.lr,
                        cfg.weight_decay)
    opt_err = max(float((a.detach().cpu() - b).abs().max()) for a, b in zip(params, pc))
    return loss_err, grad_err, excess, opt_err, float(lc)


def solver_backward_on_card(rows: int):
    """The solver's backward on the card at the GDE's hidden width: for a
    tanh(y W + b) field on (rows, HIDDEN) states, the gradients of the last
    state's squared sum with checkpoint=True against checkpoint=False
    (euler, rk4, dopri5), and odeint_adjoint against the direct gradients
    (rk4, 32 substeps on [0, 1], the JAX package's adjoint case) and against
    the adjoint on the CPU. Returns the worst error of each, relative to the
    largest gradient."""
    import numpy as np
    import torch

    from swarm_ode_tpu_torch.ops.odeint import odeint, odeint_adjoint

    rng = np.random.RandomState(5)
    y0_np = rng.normal(size=(rows, HIDDEN)).astype(np.float32)
    w_np = (rng.normal(size=(HIDDEN, HIDDEN)) / np.sqrt(HIDDEN)).astype(np.float32)
    b_np = (0.1 * rng.normal(size=HIDDEN)).astype(np.float32)

    def field(t, y, p):
        return torch.tanh(y @ p[0] + p[1])

    def grads(dev, method, substeps, checkpoint=False, adjoint=False):
        y0, w, b = (torch.from_numpy(a).to(dev).requires_grad_()
                    for a in (y0_np, w_np, b_np))
        t = torch.tensor([0.0, 1.0], device=dev)
        if adjoint:
            ys = odeint_adjoint(field, y0, t, (w, b), method=method, substeps=substeps)
        else:
            ys = odeint(lambda ti, y: field(ti, y, (w, b)), y0, t, method=method,
                        substeps=substeps, checkpoint=checkpoint)
        return torch.autograd.grad((ys[-1] ** 2).sum(), (y0, w, b))

    def worst(got, ref):
        return max(_max_rel(a, b) for a, b in zip(got, ref))

    ckpt = max(worst(grads("cuda", m, 4, checkpoint=True), grads("cuda", m, 4))
               for m in ("euler", "rk4", "dopri5"))
    adj = grads("cuda", "rk4", 32, adjoint=True)
    return ckpt, worst(adj, grads("cuda", "rk4", 32)), worst(adj, grads("cpu", "rk4", 32,
                                                                         adjoint=True))


def phase_train(layout_cache, smi):
    """GDE training at the flagship's width on the card: medium episodes
    from the port's rollout, one step against the CPU, a step with host
    syncs forbidden, train_gde for 2 epochs with checkpoints, a bit-exact
    resume, the trained weights served through K4, and train ms per step at
    B = 32 and 512. Returns the K4 launches in train_gde and in the served
    batch."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset
    from swarm_ode_tpu_torch.graphs.temporal import build_temporal_batch
    from swarm_ode_tpu_torch.models.gde import GraphODE
    from swarm_ode_tpu_torch.ops import segment_pallas
    from swarm_ode_tpu_torch.serving import make_gde_fn
    from swarm_ode_tpu_torch.train import train_gde as tg

    _, lay, pp = layout_cache["medium"]
    t0 = time.perf_counter()
    obs = record_episodes(pp, lay, TRAIN_ENVS, TRAIN_STEPS, seed=11)
    ds = TrajectoryDataset(episodes=list(obs), num_agvs=pp.num_agvs,
                           num_pickers=pp.num_pickers, seq_len=WINDOW)
    D = ds.obs_dim
    say("train", f"data: {TRAIN_ENVS} medium episodes x {TRAIN_STEPS} steps from the port's "
        f"rollout, {ds.num_agents} agents x {D} features, {obs.nbytes / 1e6:.1f} MB float32, "
        f"{len(ds)} windows, observations in [{obs.min():.0f}, {obs.max():.0f}]; "
        f"{time.perf_counter() - t0:.1f} s")

    cfg = tg.GDETrainConfig(horizon=HORIZON, horizon_weights=TRAIN_WEIGHTS)
    model_cpu = GraphODE(D, pp.num_agvs, pp.num_pickers, HIDDEN, "euler")
    model_cpu.init_(torch.Generator().manual_seed(0))
    pairs = torch.from_numpy(np.asarray(ds._index, np.int32)[
        np.random.RandomState(0).choice(len(ds), 32, replace=False)])
    for horizon, weights in ((1, None), (HORIZON, TRAIN_WEIGHTS)):
        loss_err, grad_err, excess, opt_err, loss = step_card_vs_cpu(
            ds, model_cpu, pairs, horizon, weights, cfg)
        say("train", f"one step at B=32, horizon {horizon}, weights {weights}, card vs CPU "
            f"(TF32 off): loss {loss:.4f}, rel. error {loss_err:.2e} (tolerance "
            f"{TRAIN_LOSS_RTOL:.0e}); worst gradient error {grad_err:.2e} of its largest "
            f"(tolerance {TRAIN_GRAD_RTOL:.0e}); parameters after AdamW beyond what the "
            f"gradients explain: {excess:.2e} (tolerance 0); card's AdamW from the CPU's "
            f"gradients: max abs error {opt_err:.2e} (tolerance {TRAIN_OPT_ATOL:.0e})")
        if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL and excess <= 0
                and opt_err <= TRAIN_OPT_ATOL):
            fail("train", f"card and CPU steps differ beyond the tolerances (horizon {horizon})")

    rows = 32 * ds.num_agents
    ckpt_err, adj_err, adj_cpu_err = solver_backward_on_card(rows)
    say("train", f"solver backward on the card, ({rows}, {HIDDEN}) states: checkpoint=True vs "
        f"False (euler, rk4, dopri5) worst gradient error {ckpt_err:.2e} of its largest "
        f"(tolerance {SOLVER_CKPT_RTOL:.0e}); odeint_adjoint vs direct (rk4, 32 substeps) "
        f"{adj_err:.2e} (tolerance {SOLVER_ADJ_RTOL:.0e}); adjoint card vs CPU "
        f"{adj_cpu_err:.2e} (tolerance {TRAIN_GRAD_RTOL:.0e})")
    if not (ckpt_err <= SOLVER_CKPT_RTOL and adj_err <= SOLVER_ADJ_RTOL
            and adj_cpu_err <= TRAIN_GRAD_RTOL):
        fail("train", "the solver's backward on the card is beyond its tolerances")

    # One step (gather, loss, backward, clip, AdamW) with host syncs
    # forbidden; the data and the index pairs are uploaded before.
    u8, _ = tg.stack_episodes_streamed(ds.episodes, "uint8")
    pos = np.pad(np.stack(ds._positions), ((0, 0), (0, HORIZON), (0, 0), (0, 0)), mode="edge")
    data = {"episodes": torch.from_numpy(u8).cuda(), "positions": torch.from_numpy(pos).cuda()}
    model = copy.deepcopy(model_cpu).cuda()
    params = list(model.parameters())
    loss_fn = tg._batch_loss(model, ds.num_agvs, 5.0, HORIZON, TRAIN_WEIGHTS)
    rng = np.random.RandomState(1)
    index = np.asarray(ds._index, np.int32)
    opt = tg.adamw_init(params)

    def steps(pairs_dev):
        nonlocal opt
        for p in pairs_dev:
            opt, loss = tg.train_step(params, opt, loss_fn,
                                      tg.window_batch(data, p, WINDOW, HORIZON, TRAIN_STEPS), cfg)
        return loss

    dev_pairs = torch.from_numpy(index[rng.choice(len(ds), (2, 32))]).cuda()
    steps(dev_pairs[:1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        steps(dev_pairs[1:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    say("train", "one training step (window gather, graphs, loss, backward, clip, AdamW) "
        "on the card with host synchronisation forbidden: passed")

    # train_gde on the card: 2 epochs, uint8 storage, checkpoints; no kernel
    # of K1-K4 in the training step (it aggregates structurally).
    with tempfile.TemporaryDirectory() as ckdir:
        run_cfg = dataclasses.replace(cfg, num_epochs=2, device_dtype="uint8",
                                      checkpoint_dir=ckdir, checkpoint_every=1)
        init = {k: v.cuda() for k, v in model_cpu.state_dict().items()}
        segment_pallas.LAUNCHES = 0
        t0 = time.perf_counter()
        out = tg.train_gde(ds, run_cfg, verbose=False, device="cuda", init_params=init)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k4_in_training = segment_pallas.LAUNCHES
        hist = out["history"]
        say("train", f"train_gde, 2 epochs on the card (uint8 storage, batch 32, horizon "
            f"{HORIZON}, weights {TRAIN_WEIGHTS}): train loss {hist['train_loss']}, val loss "
            f"{hist['val_loss']}; {dt:.1f} s on {smi}; K4 launches in training {k4_in_training}")
        if not hist["train_loss"][1] < hist["train_loss"][0]:
            fail("train", "the training loss did not fall")
        if k4_in_training:
            fail("train", f"the training step launched K4 {k4_in_training} times")
        again = tg.train_gde(ds, run_cfg, verbose=False, device="cuda")
    same_params = all(torch.equal(v, out["final_params"][k]) for k, v in again["final_params"].items())
    a, b = again["opt_state"], out["opt_state"]
    same_opt = (torch.equal(a.count, b.count)
                and all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu)))
    say("train", f"resume from the last checkpoint (nothing left to train): parameters "
        f"bit-identical {same_params}, optimizer state (count {int(a.count)}, mu, nu) "
        f"bit-identical {same_opt}")
    if not (same_params and same_opt and again["history"]["train_loss"] == []):
        fail("train", "the resume did not restore the saved state bit for bit")

    # The trained (best) weights served through K4 at B = 512, against the
    # structured path on the card.
    serve_model = GraphODE(D, pp.num_agvs, pp.num_pickers, HIDDEN, "euler").cuda()
    predict = make_gde_fn(serve_model, out["params"], 5.0, HORIZON)
    sel = torch.from_numpy(index[np.random.RandomState(2).choice(len(ds), GDE_BATCH)]).cuda()
    wobs, wcount, _, _ = tg._extract_windows(data["episodes"], data["positions"], WINDOW,
                                             sel[:, 0], sel[:, 1], horizon=HORIZON,
                                             true_len=TRAIN_STEPS)
    torch.cuda.synchronize()
    segment_pallas.LAUNCHES = 0
    pred = predict(wobs, wcount)
    torch.cuda.synchronize()
    k4 = segment_pallas.LAUNCHES
    with torch.no_grad():
        g = build_temporal_batch(wobs, wcount, pp.num_agvs, 5.0)
        t_span = torch.arange(HORIZON + 1, dtype=torch.float32, device="cuda")
        traj = serve_model.apply_batched(g, t_span)["trajectories"]
        ref = traj[:, torch.arange(GDE_BATCH, device="cuda"),
                   (wcount.long() - 1).clamp(min=0)].transpose(0, 1)
    err = float((pred - ref).abs().max())
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    say("train", f"trained weights served at B={GDE_BATCH} through K4 ({k4} launches) vs the "
        f"structured path on the card: max abs err {err:.3e} (tolerance {tol:.2e}), "
        f"predictions {tuple(pred.shape)}, finite {bool(torch.isfinite(pred).all())}")
    if k4 != HORIZON * 3 or not err <= tol or not bool(torch.isfinite(pred).all()):
        fail("train", f"serving the trained weights: {k4} K4 launches (expected "
             f"{HORIZON * 3}), error {err:.3e}")

    # Train ms per step at the flagship's shape.
    for B in (32, GDE_BATCH):
        reps = 10
        tp = torch.from_numpy(index[rng.choice(len(ds), (reps, B))]).cuda()
        steps(tp)
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            steps(tp)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        steps(tp[:1])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        events, busy = busy_per_call(lambda: steps(tp[:1]), reps)
        by_name = {}
        for e in _traced(lambda: steps(tp[:1]), reps):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        ms = 1e3 * min(runs) / reps
        say("train", f"B={B}, windows of {WINDOW}x{ds.num_agents}x{D}, hidden {HIDDEN}, euler, "
            f"horizon {HORIZON}: train ms per step {ms:.3f} (best of 3 x {reps} steps; runs "
            + ", ".join(f"{1e3 * r / reps:.3f}" for r in runs)
            + f"), windows/s {B / ms * 1e3:.1f}, peak {peak:.2f} GiB, device events per step "
            f"{events:.1f}, device busy {busy:.3f} ms per step (busy share {busy / ms:.3f}); "
            f"on {smi}")
        say("train", f"B={B}, device ms per step of the largest kernels in one trace, on "
            f"{smi}: " + "; ".join(f"{name[:70]} {v:.3f}" for name, v in top))
    return k4_in_training, k4


def run_cli(argv):
    """The dispatcher's command line (`policies/heuristic.main`) in this
    process: (what it returns, the lines it printed)."""
    import contextlib
    import io

    from swarm_ode_tpu_torch.policies import heuristic

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = heuristic.main(argv)
    return result, out.getvalue().splitlines()


def phase_distribution(smi):
    """30 medium episodes of 500 steps through `parity`'s command line on
    the card (one batched rollout), K1's launches counted (zeroed before,
    read after). Returns (K1 launches, wall seconds)."""
    import torch

    from swarm_ode_tpu_torch.ops import bfs_bitpack
    from swarm_ode_tpu_torch.policies import heuristic

    torch.cuda.synchronize()
    bfs_bitpack.LAUNCHES = 0
    t0 = time.perf_counter()
    totals, lines = run_cli(["parity", "--episodes", "30", "--seed", "2024"])
    seconds = time.perf_counter() - t0
    launches = bfs_bitpack.LAUNCHES
    for line in lines:
        say("distribution", line)
    record = json.loads(lines[-1])
    if (record["metric"] != "parity_medium_30ep"
            or list(record["detail"]) != list(heuristic.PARITY_REFERENCE)
            or len(lines) != 2 + len(heuristic.PARITY_REFERENCE)):
        fail("distribution", "parity printed another table or JSON line than the reference's")
    got = {"deliveries": float(totals["total_deliveries"].mean()),
           "clashes": float(totals["total_clashes"].mean()),
           "stucks": float(totals["total_stuck"].mean())}
    overflow = int(totals["replan_overflow"].sum())
    say("distribution", "30 medium episodes x 500 steps, port vs JAX package: "
        + ", ".join(f"{k} {got[k]:.2f} vs {JAX_PARITY[k]}" for k in got)
        + f"; overflow {overflow}; K1 launches {launches}; parity's wall time {seconds:.2f} s "
        f"(synchronised: the sums read back); on {smi}")
    lo, hi = 0.9 * JAX_PARITY["deliveries"], 1.1 * JAX_PARITY["deliveries"]
    if not lo <= got["deliveries"] <= hi:
        fail("distribution", f"mean deliveries {got['deliveries']:.2f} outside [{lo:.1f}, {hi:.1f}]")
    if launches != 500 or overflow:
        fail("distribution", f"K1 launched {launches} times (500 expected), overflow {overflow}")
    return launches, seconds


def phase_datagen(layout_cache, smi):
    """Expert datagen on the card: `collect_batch` at medium, B = 128
    episodes of 500 steps in chunks of 100 (the default K1 path), up to the
    host arrays the HDF5 writer takes (the writer needs h5py, which the
    card's host need not have).
    Counts zeroed before and read after: K1 once a step. Returns
    (K1 launches, the numbers printed, the first EVAL_EPISODES episodes'
    observations (E, T, A, D) float16 for the evaluation phase)."""
    import numpy as np
    import torch

    from swarm_ode_tpu_torch.data.collect import collect_batch
    from swarm_ode_tpu_torch.env.observations import obs_lengths
    from swarm_ode_tpu_torch.ops import bfs_bitpack

    cfg, lay, pp = layout_cache["medium"]
    B, T, chunk = DATAGEN_BATCH, cfg.max_steps, DATAGEN_CHUNK
    gen = torch.Generator(device="cuda").manual_seed(77)
    torch.cuda.synchronize()
    bfs_bitpack.LAUNCHES = 0
    t0 = time.perf_counter()
    traj, stats = collect_batch(pp, lay, B, T, chunk, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = bfs_bitpack.LAUNCHES
    overflow = int(stats["replan_overflow"].sum())
    mb_chunk = sum(v.nbytes for v in traj.values()) / 1e6 / (T // chunk)
    got = {k: float(np.mean(stats[k])) for k in ("deliveries", "clashes", "stucks")}
    shapes = {k: traj[k].shape for k in ("observations", "grid_collision_layers")}
    if k1 != T:
        fail("datagen", f"K1 launched {k1} times in {T} steps")
    if overflow:
        fail("datagen", f"replan_overflow summed to {overflow}")
    width = max(obs_lengths(pp))
    if shapes["observations"] != (B, T, pp.num_agents, width) or traj["observations"].dtype != np.float16:
        fail("datagen", f"observations {shapes['observations']} {traj['observations'].dtype}")
    if not np.isfinite(traj["rewards"]).all():
        fail("datagen", "non-finite rewards")
    # Busy share: the device's busy time a step, from a torch.profiler trace
    # of a chunk of DATAGEN_TRACE_STEPS steps (its copies included), over
    # the counted run's wall time a step.
    events, busy = busy_per_call(
        lambda: collect_batch(pp, lay, B, DATAGEN_TRACE_STEPS, DATAGEN_TRACE_STEPS, gen), 1)
    busy_step, wall_step = busy / DATAGEN_TRACE_STEPS, 1e3 * wall / T
    rate = B * T / wall
    say("datagen", f"medium B={B} x {T} steps in chunks of {chunk}: {rate:.1f} env steps/s "
        f"with capture ({wall:.2f} s, {wall_step:.3f} ms a step), {mb_chunk:.1f} MB copied "
        f"to the host a chunk, K1 launches {k1}, overflow {overflow}; per episode: "
        + ", ".join(f"{k} {v:.2f}" for k, v in got.items())
        + f" (JAX deliveries {JAX_PARITY['deliveries']}); on {smi}")
    say("datagen", f"device busy {busy_step:.3f} ms a step in a traced chunk of "
        f"{DATAGEN_TRACE_STEPS} steps ({events / DATAGEN_TRACE_STEPS:.1f} device events a "
        f"step): busy share {busy_step / wall_step:.3f}")
    lo, hi = 0.9 * JAX_PARITY["deliveries"], 1.1 * JAX_PARITY["deliveries"]
    if not lo <= got["deliveries"] <= hi:
        fail("datagen", f"mean deliveries {got['deliveries']:.2f} outside [{lo:.1f}, {hi:.1f}]")
    episodes = traj["observations"][:EVAL_EPISODES].copy()
    del traj
    return k1, {"env_steps_per_sec": rate, "mb_per_chunk": mb_chunk,
                "busy_share": busy_step / wall_step, **got}, episodes


def phase_env_api(layout_cache):
    """The env API on the card, each path's K1 launches counted (zeroed
    before, read after): a 500-step medium episode through the gym adapter
    driven by the dispatcher (terminateds at step 500 and not before; a
    host sync a step by the gym contract), `heuristic_episode` on the same
    adapter, `auto_reset_rollout` at B = 64 over 1,100 steps with host
    synchronisation forbidden (two boundaries per env, cur_steps as JAX's
    test pins it), `checked_step` over 100 steps at B = 64."""
    import numpy as np
    import torch

    import swarm_ode_tpu_torch
    from swarm_ode_tpu_torch import convert
    from swarm_ode_tpu_torch.env import env as env_mod
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.invariants import InvariantError, checked_step, state_flags
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.ops import bfs_bitpack
    from swarm_ode_tpu_torch.policies import heuristic as heur

    cfg, lay, pp = layout_cache["medium"]
    launches = {}
    env = swarm_ode_tpu_torch.make(MEDIUM)
    if env.params.device != pp.device:
        fail("env-api", f"make() put the env on {env.params.device}, not {pp.device}")
    steps = env.params.max_steps
    policy = heur.make_policy(env.params, env.layout)
    env.reset(seed=0)
    h = heur.init_state(env.params, 1)
    bfs_bitpack.LAUNCHES = 0
    deliveries, t0 = 0, time.perf_counter()
    for t in range(steps):
        a, h = policy(env.params, env.state, h)
        _, _, term, trunc, info = env.step(a[0].tolist())
        deliveries += info["shelf_deliveries"]
        if all(term) != (t == steps - 1) or term != trunc:
            fail("env-api", f"gym step {t + 1}: terminateds {term}")
    gym_s = time.perf_counter() - t0
    launches["gym episode"] = bfs_bitpack.LAUNCHES
    bfs_bitpack.LAUNCHES = 0
    t0 = time.perf_counter()
    infos, ret, ep_returns = heur.heuristic_episode(env, seed=0)
    ep_s = time.perf_counter() - t0
    launches["heuristic_episode"] = bfs_bitpack.LAUNCHES
    ep_deliv = sum(i["shelf_deliveries"] for i in infos)
    if deliveries <= 0 or ep_deliv <= 0 or len(infos) != steps:
        fail("env-api", f"gym episode {deliveries}, heuristic_episode {ep_deliv} deliveries")
    if abs(ret - float(ep_returns.sum())) > 1e-3:
        fail("env-api", f"heuristic_episode's return {ret} != {ep_returns.sum()}")
    say("env-api", f"gym adapter on the card, medium: a {steps}-step episode by env.step "
        f"(terminateds at step {steps} only; {deliveries} deliveries) in {gym_s:.2f} s, "
        f"{1e3 * gym_s / steps:.3f} ms a step with its host sync; heuristic_episode "
        f"{ep_deliv} deliveries, return {ret:.2f}, {ep_s:.2f} s")

    B, T = ENV_API_BATCH, AUTO_RESET_STEPS
    g = torch.Generator(device="cuda").manual_seed(3)
    s, h = step_mod.reset(pp, B, g), heur.init_state(pp, B)
    policy = heur.make_policy(pp, lay)  # copies the picker zones to the card
    torch.cuda.synchronize()
    bfs_bitpack.LAUNCHES = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s, h, (_, done, _) = env_mod.auto_reset_rollout(
            pp, policy, lambda b: heur.init_state(pp, b), s, h, T, generator=g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ar_s = time.perf_counter() - t0
    launches["auto_reset_rollout"] = bfs_bitpack.LAUNCHES
    done = done.cpu().numpy()
    last = T - 1 - np.argmax(done[:, ::-1], axis=1)
    if not (done.sum(1) == 2).all():
        fail("env-api", f"auto_reset_rollout boundaries per env: {sorted(set(done.sum(1)))}")
    if not np.array_equal(s.cur_steps.cpu().numpy(), T - (last + 1)):
        fail("env-api", "auto_reset_rollout's cur_steps do not count from the last boundary")
    say("env-api", f"auto_reset_rollout, medium B={B} x {T} steps with host "
        f"synchronisation forbidden: 2 boundaries per env, cur_steps {int(s.cur_steps[0])} "
        f"at the end; {B * T / ar_s:.1f} env steps/s")

    # checked_step beside the plain step on the same inputs: it raises
    # exactly where check_state's flags (the same on the card and the CPU)
    # say an invariant broke, with the first broken one's message, and
    # returns the plain step's result elsewhere. JAX's own rollout breaks
    # one invariant, two agents of one layer on one cell with neither fixing
    # a clash (tests/test_torch_invariants.py); any other break fails.
    pp_cpu = make_params(cfg, lay, "cpu")
    step = checked_step(pp)
    s = step_mod.reset(pp, B, g)
    h = heur.init_state(pp, B)
    broken = {}
    checked_launches = 0
    t0 = time.perf_counter()
    for t in range(CHECKED_STEPS):
        a, h = policy(pp, s, h)
        n = step_mod.draw_noise(pp, B, g)
        plain = step_mod.step(pp, s, a, noise=n)
        flags = [(msg, ok.cpu()) for msg, ok in state_flags(pp, plain[0])]
        cpu_flags = state_flags(pp_cpu, convert.env_state_to(plain[0], "cpu"))
        if any(not torch.equal(ok, c) for (_, ok), (_, c) in zip(flags, cpu_flags)):
            fail("env-api", f"step {t}: the invariant flags differ on the card and the CPU")
        first = next((msg for msg, ok in flags if not bool(ok.all())), None)
        # Counted around checked_step's call alone, not the plain step's.
        bfs_bitpack.LAUNCHES = 0
        try:
            out = step(s, a, noise=n)
            raised = None
        except InvariantError as e:
            raised = str(e)
        checked_launches += bfs_bitpack.LAUNCHES
        if first is None and (raised or not _states_equal(out[0], plain[0])):
            fail("env-api", f"step {t}: checked_step raised {raised!r} or changed the step")
        if first is not None and not (raised and raised.startswith(first)):
            fail("env-api", f"step {t}: {first!r} broken, checked_step raised {raised!r}")
        for msg, ok in flags:
            if not bool(ok.all()):
                broken[msg] = broken.get(msg, 0) + 1
        s = plain[0]
    launches["checked_step"] = checked_launches
    if set(broken) - {OVERLAP}:
        fail("env-api", f"invariants broken: {broken}")
    say("env-api", f"checked_step, medium B={B} x {CHECKED_STEPS} steps beside the plain step: "
        f"raised exactly where an invariant broke (steps with a break: {broken or 0}; "
        f"the overlap is JAX's own), flags identical on the card and the CPU "
        f"({time.perf_counter() - t0:.2f} s); K1 launches by path {launches}")
    for path, want in (("gym episode", steps), ("heuristic_episode", steps),
                       ("auto_reset_rollout", T), ("checked_step", CHECKED_STEPS)):
        if launches[path] != want:
            fail("env-api", f"{path}: K1 launched {launches[path]} times in {want} steps")
    return launches


def _tree_to(x, device):
    """Nested dicts / lists / tuples / agent states of tensors, on `device`."""
    import dataclasses as dc

    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _tree_to(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_to(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_to(v, device) for v in x)
    if dc.is_dataclass(x):
        return type(x)(**{f.name: _tree_to(getattr(x, f.name), device) for f in dc.fields(x)})
    return x


def _max_err(got, ref) -> float:
    return float((got.detach().cpu() - ref.detach().cpu()).abs().max())


def marl_card_vs_cpu(cfg_env, lay, pp):
    """The MARL path's pieces, card against CPU, on B = 8 medium envs after
    one reset and 40 steps of random valid actions (every draw made on the
    CPU and moved to the card): graphs, masks_from_feats and busy flags
    identical; Q-values of gnn, gnode and gnode_comm (hidden 64) within
    MARL_Q_RTOL of the largest |Q|; epsilon-greedy, the claim auction's
    epsilon-greedy and its sampling identical on the same Q-values and
    draws; one IQL and one QMIX learn step (n_step 3, value_transform,
    coordinated) from one sampled batch: loss and gradient within the
    MARL_* tolerances, Adam from the CPU's gradients within MARL_OPT_ATOL.
    Returns the numbers printed."""
    import dataclasses as dc

    import torch

    from swarm_ode_tpu_torch import convert
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.observations import compute_valid_action_masks, observe
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.graphs import hetero
    from swarm_ode_tpu_torch.rl import coordination, replay
    from swarm_ode_tpu_torch.rl.dqn import ActNoise, epsilon_greedy, module_params, q_values
    from swarm_ode_tpu_torch.train import run_rl
    from swarm_ode_tpu_torch.utils.optim import adamw_update, clip_by_global_norm

    dev = pp.device
    pp_cpu = make_params(cfg_env, lay, "cpu")
    g = torch.Generator().manual_seed(31)
    B = MARL_ENVS
    s = step_mod.reset(pp_cpu, B, g)
    obs = []
    for t in range(40):
        m = compute_valid_action_masks(pp_cpu, s)
        a = (torch.rand(m.shape, generator=g) * m).argmax(-1).to(torch.int32)
        s = step_mod.step(pp_cpu, s, a, generator=g)[0]
        if t % 10 == 9:
            o_cpu = observe(pp_cpu, s)
            o_gpu = observe(pp, convert.env_state_to(s, dev))
            if not torch.equal(o_gpu.cpu(), o_cpu):
                fail("marl", f"step {t}: observations differ on the card and the CPU")
            obs.append(o_cpu)
    obs = torch.cat(obs)  # (32, A, D)
    ref = dict(vars(hetero.hetero_graph_from_obs(pp_cpu, obs)))
    got = dict(vars(hetero.hetero_graph_from_obs(pp, obs.to(dev))))
    f_cpu, f_gpu = hetero.split_observation(pp_cpu, obs), hetero.split_observation(pp, obs.to(dev))
    ref["masks"], got["masks"] = (hetero.masks_from_feats(p, *f) for p, f in
                                  ((pp_cpu, f_cpu), (pp, f_gpu)))
    ref["busy"], got["busy"] = (coordination.busy_from_feats(*f[:2]) for f in (f_cpu, f_gpu))
    for k in ref:
        if not torch.equal(got[k].cpu(), ref[k]):
            fail("marl", f"{k} differs on the card and the CPU")
    edges = int(ref["agv2pick"].sum() + ref["pick2loc"].sum() + ref["agv2agv"].sum())

    q_err = {}
    for net in ("gnn", "gnode", "gnode_comm"):
        cfg = run_rl.RLRunConfig(net=net, hidden_dim=MARL_HIDDEN, device="cpu")
        _, net_cpu = run_rl.make_agent(cfg, pp_cpu)
        net_cpu.init_(torch.Generator().manual_seed(3))
        _, net_gpu = run_rl.make_agent(dc.replace(cfg, device="cuda"), pp)
        net_gpu.load_state_dict(net_cpu.state_dict())
        with torch.no_grad():
            qc = q_values(net_cpu, dict(net_cpu.named_parameters()),
                          hetero.hetero_graph_from_obs(pp_cpu, obs))
            qg = q_values(net_gpu, dict(net_gpu.named_parameters()),
                          hetero.hetero_graph_from_obs(pp, obs.to(dev)))
        q_err[net] = _max_err(qg, qc) / float(qc.abs().max())
        if q_err[net] > MARL_Q_RTOL:
            fail("marl", f"{net}: Q-values differ by {q_err[net]:.2e} of the largest |Q|")

    # Selection on the same Q-values (the last network's) and draws.
    n = pp.num_actions
    noise = [ActNoise(torch.rand(qc.shape[:2], generator=g), torch.rand(qc.shape, generator=g)),
             ActNoise(torch.rand(qc.shape[:2], generator=g),
                      step_mod.draw_gumbel(qc.shape, g, "cpu"))]
    active = ~ref["busy"]
    eps = torch.tensor(0.5)
    picks = {}
    for coordinated, nz in ((True, noise[0]), (False, noise[1])):
        picks[coordinated] = [epsilon_greedy(*(x.to(d) if isinstance(x, torch.Tensor) else x
                                               for x in (qc, ref["masks"], eps)),
                                             ActNoise(nz.explore_u.to(d), nz.row.to(d)),
                                             pcfg, coordinated, active.to(d))
                              for d, pcfg in (("cpu", pp_cpu), (dev, pp))]
    picks["sample"] = [coordination.coordinated_sample(
        qc.to(d), ref["masks"].to(d), pp.num_agvs, 1 + pp.num_goals, noise[1].row.to(d),
        active.to(d)) for d in ("cpu", dev)]
    for k, (c, gg) in picks.items():
        if not torch.equal(gg.cpu(), c):
            fail("marl", f"selection {k}: actions differ on the card and the CPU")

    # One learn step of each algorithm from one sampled batch.
    learn = {}
    base = run_rl.RLRunConfig(num_envs=B, hidden_dim=MARL_HIDDEN, buffer_size=256,
                              batch_size=MARL_BATCH, n_step=3, value_transform=True,
                              coordinated=True, device="cpu", seed=5)
    run = run_rl.MarlRun(base)
    es = run.draws.reset(B)
    o = observe(pp_cpu, es)
    for t in range(12):
        es, o, _ = run.env_step(es, o, t, 0)
    idx = torch.randint(0, run.buf.size, (MARL_BATCH,), generator=g)
    sampled = replay.sample_nstep(run.buf, MARL_BATCH, 3, B, idx=idx)
    for algo in ("iql", "qmix"):
        cfg = dc.replace(base, algo=algo)
        agent_c, _ = run_rl.make_agent(cfg, pp_cpu)
        agent_g, _ = run_rl.make_agent(dc.replace(cfg, device="cuda"), pp)
        st = agent_c.init(torch.Generator().manual_seed(7))
        batch = run_rl.batch_from(sampled, algo, agent_c.cfg.gamma, 3)
        new_c, aux_c, gr_c = agent_c.learn_with_grads(st, batch)
        new_g, aux_g, gr_g = agent_g.learn_with_grads(_tree_to(st, dev), _tree_to(batch, dev))
        loss_err = abs(float(aux_g["loss"]) - float(aux_c["loss"])) / abs(float(aux_c["loss"]))
        scale = max(float(v.abs().max()) for v in gr_c.values())
        grad_err = max(_max_err(gr_g[k], gr_c[k]) for k in gr_c) / scale
        # Adam on the card from the CPU's clipped gradients: its arithmetic
        # alone. From each side's own gradients Adam divides each element by
        # its own magnitude (plus 1e-8), so a parameter whose gradient is
        # near 1e-8 moves by up to lr/2 and a rounding difference in that
        # gradient shows amplified: that difference is printed, not held.
        names = list(st.params)
        clipped = clip_by_global_norm([gr_c[k] for k in names], agent_c.cfg.grad_clip)
        on_card = [st.params[k].to(dev).clone() for k in names]
        adamw_update(on_card, [c.to(dev) for c in clipped],
                     _tree_to(st.opt_state, dev), agent_c.cfg.lr, 0.0)
        opt_err = max(_max_err(p, new_c.params[k]) for p, k in zip(on_card, names))
        own = {k: _max_err(new_g.params[k], new_c.params[k]) for k in names}
        worst = max(own, key=own.get)
        learn[algo] = (float(aux_c["loss"]), loss_err, grad_err, opt_err, own[worst], worst,
                       float(gr_c[worst].abs().min()))
        if not (loss_err <= MARL_LOSS_RTOL and grad_err <= MARL_GRAD_RTOL
                and opt_err <= MARL_OPT_ATOL):
            fail("marl", f"{algo} learn step card vs CPU: loss {loss_err:.2e}, gradient "
                 f"{grad_err:.2e}, parameters after Adam from the CPU's gradients {opt_err:.2e}")
    n_params = sum(v.numel() for v in module_params(agent_c.net).values())
    say("marl", f"card vs CPU (TF32 off), medium B={B} after 40 random-action steps: hetero "
        f"graphs ({edges} agent edges), masks_from_feats and busy flags identical; Q-values "
        f"(hidden {MARL_HIDDEN}; the gnode Q-network has {n_params} parameters) within "
        + ", ".join(f"{k} {v:.2e}" for k, v in q_err.items())
        + " of the largest |Q|; epsilon-greedy, coordinated epsilon-greedy and coordinated "
        "sampling identical; one learn step from one sampled batch of "
        f"{MARL_BATCH} (n_step 3, value_transform, coordinated): "
        + "; ".join(f"{k} loss {v[0]:.5f}, rel. error {v[1]:.2e}, gradient {v[2]:.2e} of its "
                    f"largest, parameters after Adam from the CPU's gradients {v[3]:.2e} (from "
                    f"the card's own: {v[4]:.2e}, at {v[5]}, whose smallest |gradient| is "
                    f"{v[6]:.2e})" for k, v in learn.items()))
    return {"q_rel_err": q_err, "learn": learn}


def phase_marl(layout_cache, smi):
    """Off-policy MARL on the card: the pieces card against CPU
    (marl_card_vs_cpu); run_marl with medium_qmix_long's recipe for one
    stride of 8 envs x 500 steps, the episode under host sync forbidden,
    counts zeroed before and read after (K1 once a step, overflow 0), the
    loss finite and nonzero, the parameters moved; env steps/s with
    learning, ms per learn step, peak memory, busy share; the greedy
    evaluation (8 envs x 500 steps) resuming from the run's checkpoint,
    which must restore the agent bit for bit; make_policy_fn(coordinated)
    serving the trained Q-network over SERVED_STEPS steps. Returns
    (K1 launches by path, the numbers printed)."""
    import dataclasses as dc
    import tempfile

    import numpy as np
    import torch

    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.ops import bfs_bitpack
    from swarm_ode_tpu_torch.rl import replay
    from swarm_ode_tpu_torch.serving import make_policy_fn
    from swarm_ode_tpu_torch.train import run_rl

    cfg_env, lay, pp = layout_cache["medium"]
    t_phase = time.perf_counter()
    checks = marl_card_vs_cpu(cfg_env, lay, pp)
    launches, out = {}, {}
    with tempfile.TemporaryDirectory() as ckdir:
        cfg = run_rl.RLRunConfig(
            env_id=MEDIUM, algo="qmix", net="gnode", num_envs=MARL_ENVS,
            num_episodes=MARL_ENVS, hidden_dim=MARL_HIDDEN, buffer_size=MARL_BUFFER,
            batch_size=MARL_BATCH, seed=0, checkpoint_dir=ckdir, checkpoint_every=MARL_ENVS,
            forbid_host_sync=True)
        agent, _ = run_rl.make_agent(cfg, pp)
        start = agent.init(torch.Generator(device="cuda").manual_seed(0))
        init = {k: v.clone() for k, v in start.params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bfs_bitpack.LAUNCHES = 0
        t0 = time.perf_counter()
        res = run_rl.run_marl(cfg, verbose=False, agent_state=start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["marl train"] = bfs_bitpack.LAUNCHES
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        stats, losses, trained = res["history"][0], res["losses"][0], res["agent_state"]
        steps = len(losses)  # learn_every = 1: one learn step an env step
        buf_gb = res["buffer"].nbytes() / 1e9
        if launches["marl train"] != steps or stats["replan_overflow"]:
            fail("marl", f"training: K1 launched {launches['marl train']} times in {steps} "
                 f"steps, overflow {stats['replan_overflow']}")
        if not (np.isfinite(losses).all() and stats["loss"] != 0.0):
            fail("marl", f"training loss {stats['loss']} (finite: {np.isfinite(losses).all()})")
        # The last conv block's location outputs feed no Q head: those
        # relations' parameters get zero gradients (in JAX too) and stay.
        last = f"q.encoder.conv{agent.net.encoder.num_layers - 1}."
        unreached = {k for k in init if k.startswith(last) and (
            ".agv_targets_loc." in k or ".pick_manages_loc." in k)}
        still = {k for k, v in init.items() if torch.equal(trained.params[k], v)}
        moved = len(init) - len(still)
        if still != unreached:
            fail("marl", f"parameter tensors unchanged by training: {sorted(still)}, expected "
                 f"exactly those no Q head reaches: {sorted(unreached)}")
        rate = MARL_ENVS * steps / stats["seconds"]
        wall_step = 1e3 * stats["seconds"] / steps

        # ms per learn step, alone: sample + batch + learn, synchronised.
        learn_agent, _ = run_rl.make_agent(cfg, pp)
        gcuda = torch.Generator(device="cuda").manual_seed(9)

        def learn_once():
            sampled = replay.sample_nstep(res["buffer"], MARL_BATCH, cfg.n_step, MARL_ENVS,
                                          generator=gcuda)
            learn_agent.learn(trained, run_rl.batch_from(sampled, "qmix",
                                                         learn_agent.cfg.gamma, cfg.n_step))

        learn_once()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(MARL_LEARN_REPS):
            learn_once()
        torch.cuda.synchronize()
        learn_ms = 1e3 * (time.perf_counter() - t1) / MARL_LEARN_REPS

        # Busy share: a traced block of steps with learning (the run's code,
        # on its trained state) over the training run's wall time a step.
        run = run_rl.MarlRun(dc.replace(cfg, buffer_size=4096, checkpoint_dir=None),
                             agent_state=trained)
        es = run.draws.reset(MARL_ENVS)
        o = observe(pp, es)
        carry = {"es": es, "obs": o, "t": 0}
        for _ in range(12):  # fill past the warm start
            carry["es"], carry["obs"], _ = run.env_step(carry["es"], carry["obs"], carry["t"], 0)
            carry["t"] += 1

        def block():
            for _ in range(MARL_TRACE_STEPS):
                carry["es"], carry["obs"], _ = run.env_step(carry["es"], carry["obs"],
                                                            carry["t"], 0)
                carry["t"] += 1
                run.learn_block()

        events, busy = busy_per_call(block, 1)
        busy_step = busy / MARL_TRACE_STEPS
        say("marl", f"run_marl, medium_qmix_long's recipe for one stride (qmix, gnode, "
            f"{MARL_ENVS} envs x {steps} steps, hidden {MARL_HIDDEN}, buffer {MARL_BUFFER} "
            f"({buf_gb:.3f} GB on the card), batch {MARL_BATCH}, learn every step, n_step 3, "
            f"value_transform), the episode with host synchronisation forbidden: "
            f"marl_env_steps_per_sec {rate:.1f} ({wall_step:.3f} ms a step with its learn "
            f"step; {wall:.2f} s with set-up), {learn_ms:.3f} ms per learn step alone "
            f"(synchronised, mean of {MARL_LEARN_REPS}); peak memory {peak_gb:.3f} GiB; K1 "
            f"launches {launches['marl train']}, overflow {stats['replan_overflow']}; loss "
            f"{stats['loss']:.5f} (mean of {int((losses != 0).sum())} learn steps), epsilon "
            f"{float(trained.epsilon):.4f}, {moved} of {len(init)} parameter tensors moved (the "
            f"{len(unreached)} no Q head reaches stayed); "
            f"deliveries {stats['deliveries']} an env, pick rate {stats['pick_rate']:.2f}; "
            f"on {smi}")
        say("marl", f"device busy {busy_step:.3f} ms a step in a traced block of "
            f"{MARL_TRACE_STEPS} steps with learning ({events / MARL_TRACE_STEPS:.1f} device "
            f"events a step): busy share {busy_step / wall_step:.3f}")

        # Greedy evaluation, resuming from the run's checkpoint.
        ecfg = dc.replace(cfg, num_episodes=0, eval_episodes=MARL_ENVS, resume_from=ckdir,
                          checkpoint_dir=None, forbid_host_sync=False)
        torch.cuda.synchronize()
        bfs_bitpack.LAUNCHES = 0
        t0 = time.perf_counter()
        ev = run_rl.run_marl(ecfg, verbose=False)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches["marl eval"] = bfs_bitpack.LAUNCHES
        rs = ev["agent_state"]
        same = all(torch.equal(getattr(rs, k)[n], getattr(trained, k)[n])
                   for k in ("params", "target_params") for n in trained.params)
        same = same and all(torch.equal(a, b) for a, b in zip(
            [rs.opt_state.count, rs.epsilon, rs.step, *rs.opt_state.mu, *rs.opt_state.nu],
            [trained.opt_state.count, trained.epsilon, trained.step, *trained.opt_state.mu,
             *trained.opt_state.nu]))
        if not same:
            fail("marl", "resume_from did not restore the agent state bit for bit")
        if launches["marl eval"] != steps:
            fail("marl", f"eval: K1 launched {launches['marl eval']} times in {steps} steps")
        eh = ev["history"][0]

    # The trained Q-network served through make_policy_fn (claim auction)
    # over SERVED_STEPS steps of a medium episode.
    net = run_rl.make_network(cfg, pp.num_actions,
                              1.0 / max(pp.grid_h, pp.grid_w)).to(pp.device)
    policy = make_policy_fn(pp, net, run_rl.agent_params(trained), coordinated=True)
    g = torch.Generator(device="cuda").manual_seed(2)
    s = step_mod.reset(pp, 1, g)
    torch.cuda.synchronize()
    bfs_bitpack.LAUNCHES = 0
    deliv = torch.zeros((), device=pp.device)
    t0 = time.perf_counter()
    for _ in range(SERVED_STEPS):
        a = policy(observe(pp, s))
        s, _, _, info = step_mod.step(pp, s, a, generator=g)
        deliv += info["shelf_deliveries"].sum()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches["policy served"] = bfs_bitpack.LAUNCHES
    if launches["policy served"] != SERVED_STEPS:
        fail("marl", f"served policy: K1 launched {launches['policy served']} times")
    say("marl", f"greedy evaluation resumed from the checkpoint (agent state restored bit for "
        f"bit): {MARL_ENVS} envs x {steps} steps in {eval_s:.2f} s, deliveries "
        f"{eh['eval_deliveries']:.2f} an env, return {eh['eval_return']:.2f}; "
        f"make_policy_fn(coordinated=True) serving the trained Q-network over "
        f"{SERVED_STEPS} steps of a medium episode: {int(deliv)} deliveries, "
        f"{1e3 * serve_s / SERVED_STEPS:.3f} ms a step; K1 launches by path {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    out.update(checks, env_steps_per_sec=rate, ms_per_step=wall_step, learn_ms=learn_ms,
               peak_gib=peak_gb, busy_share=busy_step / wall_step, buffer_gb=buf_gb)
    return launches, out


def _grad_err(got, ref, terms=None) -> float:
    """The largest difference of two gradient dicts over ref's largest
    element, or over the largest element of `terms` where that is larger:
    the gradient of the terms a loss cancels (a squared residual cancels
    its prediction's square), whose rounding the difference carries."""
    scale = max(float(v.abs().max()) for v in ref.values())
    if terms is not None:
        scale = max(scale, max(float(v.abs().max()) for v in terms.values()))
    return max(_max_err(got[k], ref[k]) for k in ref) / (scale or 1.0)


def _rel(got, ref) -> float:
    return abs(float(got) - float(ref)) / (abs(float(ref)) or 1.0)


def _adam_from_cpu_grads(params, grads_cpu, opt, lr, clip, dev):
    """The parameters after one Adam step on the card from the CPU's
    gradients (clipped to `clip` when given): Adam's arithmetic alone."""
    from swarm_ode_tpu_torch.rl.dqn import adam_step

    new, _ = adam_step(_tree_to(params, dev), _tree_to(grads_cpu, dev), _tree_to(opt, dev), lr,
                       clip)
    return new


def coma_card_vs_cpu(pp, pp_cpu, ccfg, cres):
    """One COMA update of the trained state on a batch of the stride's
    newest transitions, card against CPU (see learn_card_vs_cpu)."""
    import dataclasses as dc

    import torch

    from swarm_ode_tpu_torch.rl import replay
    from swarm_ode_tpu_torch.rl.dqn import value_and_grad
    from swarm_ode_tpu_torch.train import run_rl

    dev = pp.device
    window = pp.max_steps * ccfg.num_envs
    off = torch.arange(1, COMA_BATCH + 1, device=dev) * 37 % window + 1
    sampled = replay.sample_recent(cres["buffer"], COMA_BATCH, window, off=off)
    batch = {"obs_feats": sampled["obs_feats"], "global_state": sampled["global_state"],
             "actions": sampled["actions"], "rewards": sampled["rewards"].mean(-1),
             "next_global_state": sampled["next_global_state"], "dones": sampled["done"]}
    agent_g, _ = run_rl.make_agent(ccfg, pp)
    agent_c, _ = run_rl.make_agent(dc.replace(ccfg, device="cpu"), pp_cpu)
    st, batch_c = cres["agent_state"], _tree_to(batch, "cpu")
    st_c = _tree_to(st, "cpu")
    new_c, _, gr_c = agent_c.update_with_grads(st_c, batch_c)
    closs_c, q_c, _ = agent_c.critic_grads(st_c, batch_c)
    # The TD loss (mean Q - target)^2 cancels mean Q's square.
    _, _, (terms,) = value_and_grad(lambda cp: (agent_c.q(cp, batch_c["global_state"],
                                                          batch_c["actions"]).mean(1) ** 2).mean(),
                                    st_c.critic_params)
    adv_c = agent_c.advantage(st_c, batch_c, q_c)
    aloss_c, _ = agent_c.actor_grads(st_c, batch_c, adv_c)
    closs_g, q_g, cgr_g = agent_g.critic_grads(st, batch)
    adv_g = agent_g.advantage(st, batch, q_g)
    aloss_g, agr_g = agent_g.actor_grads(st, batch, adv_c.to(dev))
    gr_g = {"critic": cgr_g, "actor": agr_g}
    with torch.no_grad():
        td = batch_c["rewards"] + agent_c.cfg.gamma * agent_c.q(
            st_c.critic_params, batch_c["next_global_state"], batch_c["actions"]).mean(1) * (
            1.0 - batch_c["dones"].float())
    closs_terms = float((q_c.mean(1) ** 2 + td ** 2).mean())
    errs = {"critic_loss (of its terms)": abs(float(closs_g) - float(closs_c)) / closs_terms,
            "actor_loss": _rel(aloss_g, aloss_c),
            "advantage (of the largest |Q|)": _max_err(adv_g, adv_c) / float(q_c.abs().max())}
    for part in ("critic", "actor"):
        errs[f"{part} gradient"] = _grad_err(gr_g[part], gr_c[part],
                                             terms if part == "critic" else None)
        lr = agent_c.cfg.lr_critic if part == "critic" else agent_c.cfg.lr_actor
        params, opt = (st.critic_params, st.critic_opt) if part == "critic" else (
            st.actor_params, st.actor_opt)
        on_card = _adam_from_cpu_grads(params, gr_c[part], opt, lr, None, dev)
        want = new_c.critic_params if part == "critic" else new_c.actor_params
        errs[f"{part} Adam"] = max(_max_err(on_card[k], want[k]) for k in want)
    return errs


def mappo_card_vs_cpu(mappo_run):
    """One MAPPO minibatch (the same rows) of a short collection on the card
    under the run's parameters, card against CPU (see learn_card_vs_cpu)."""
    import dataclasses as dc

    import torch

    from swarm_ode_tpu_torch.rl import ppo
    from swarm_ode_tpu_torch.rl.dqn import adam_step, value_and_grad

    dev = mappo_run.device
    short = ppo.MappoRun(dc.replace(mappo_run.cfg, steps_override=MAPPO_CHECK_STEPS,
                                    init_from=None, forbid_host_sync=False))
    short.actor_params, short.critic_params = mappo_run.actor_params, mappo_run.critic_params
    traj = short.collect()
    cpu_run = ppo.MappoRun(dc.replace(short.cfg, device="cpu"))
    cpu_run.actor_params = _tree_to(mappo_run.actor_params, "cpu")
    cpu_run.critic_params = _tree_to(mappo_run.critic_params, "cpu")
    N = traj["reward"].numel()
    idx = torch.randperm(N, generator=torch.Generator().manual_seed(3))[:MAPPO_MINIBATCH]
    mb = {}
    for side, run, d in (("card", short, dev), ("cpu", cpu_run, "cpu")):
        data = {k: v.flatten(0, 1).to(d) for k, v in traj.items()
                if k not in ("deliv", "overflow")}
        adv = (data["adv"] - data["adv"].mean()) / (data["adv"].std(correction=0) + 1e-8)
        mb[side] = value_and_grad(lambda a, c: run.loss(a, c, data, adv, idx.to(d)),
                                  run.actor_params, run.critic_params, has_aux=True)
    (tot_g, aux_g, (ag_g, cg_g)), (tot_c, aux_c, (ag_c, cg_c)) = mb["card"], mb["cpu"]
    cfg = mappo_run.cfg
    # The loss's terms: the policy term averages |advantage| x ratio (~1)
    # terms of either sign, the value term cancels v's square.
    adv_terms = float(adv[idx].abs().mean())
    pg_err = abs(float(aux_g[0]) - float(aux_c[0])) / adv_terms
    loss_err = abs(float(tot_g) - float(tot_c)) / (
        adv_terms + cfg.value_coef * float(aux_c[1]) + cfg.entropy_coef * float(aux_c[2]))
    gs_b = data["gs"][idx]
    _, _, (terms,) = value_and_grad(
        lambda c: cfg.value_coef * (cpu_run.value(c, gs_b) ** 2).mean(), cpu_run.critic_params)
    with torch.no_grad():
        v_terms = float((cpu_run.value(cpu_run.critic_params, gs_b) ** 2
                         + data["ret"][idx] ** 2).mean())
    on_card = _adam_from_cpu_grads(mappo_run.actor_params, ag_c, short.actor_opt, cfg.lr,
                                   cfg.max_grad_norm, dev)
    want, _ = adam_step(cpu_run.actor_params, ag_c, cpu_run.actor_opt, cfg.lr, cfg.max_grad_norm)
    return {"loss (of its terms)": loss_err, "pg_loss (of |advantage|)": pg_err,
            "v_loss (of its terms)": abs(float(aux_g[1]) - float(aux_c[1])) / v_terms,
            "entropy": _rel(aux_g[2], aux_c[2]),
            "actor gradient": _grad_err(ag_g, ag_c),
            "critic gradient": _grad_err(cg_g, cg_c, terms),
            "actor Adam": max(_max_err(on_card[k], want[k]) for k in want)}


def bc_card_vs_cpu(pp, pp_cpu, bc_net, bc_params, arrays):
    """One BC batch (the dataset's first rows), card against CPU: loss and
    gradient (see learn_card_vs_cpu)."""
    import torch

    from swarm_ode_tpu_torch.rl.dqn import value_and_grad
    from swarm_ode_tpu_torch.train.train_bc import batch_loss

    obs = torch.from_numpy(arrays[0][:BC_BATCH]).float()
    act, idle = torch.from_numpy(arrays[1][:BC_BATCH]), torch.from_numpy(~arrays[2][:BC_BATCH])
    out = {}
    for side, p in (("card", pp), ("cpu", pp_cpu)):
        d = p.device
        net = bc_net.to(d)
        out[side] = value_and_grad(
            lambda q: batch_loss(net, q, p, obs.to(d), act.to(d), idle.to(d)),
            _tree_to(bc_params, d), has_aux=True)
    bc_net.to(pp.device)
    return {"loss": _rel(out["card"][0], out["cpu"][0]),
            "gradient": _grad_err(out["card"][2][0], out["cpu"][2][0])}


def learn_card_vs_cpu(pp, lay, cfg_env, coma, mappo_run, bc_net, bc_params, arrays):
    """One COMA update, one MAPPO minibatch step and one BC batch, card
    against CPU on one batch taken from the card and copied to the CPU:
    losses within MARL_LOSS_RTOL, gradients within MARL_GRAD_RTOL of their
    largest element, Adam on the card from the CPU's gradients within
    MARL_OPT_ATOL of the CPU's parameters. Where a quantity cancels larger
    terms, it is held against their size, which sets its rounding: COMA's
    advantages are differences of Q-values (the counterfactual baseline
    nearly cancels Q), held within MARL_Q_RTOL of the largest |Q|, and the
    actors' step is held from the CPU's advantages, as Adam is from the
    CPU's gradients; MAPPO's policy term averages terms of +-|advantage|
    (over the minibatch of a normalised stride it nearly vanishes), held
    against their mean magnitude, and its loss against the sum of its
    terms'; a squared residual (both critics' losses) against the mean of
    its two squares, and its gradient against the gradient of its
    prediction's square where that is larger.
    Every error is printed before any is held. Returns the errors."""
    from swarm_ode_tpu_torch.env.state import make_params

    pp_cpu = make_params(cfg_env, lay, "cpu")
    errs = {"coma": coma_card_vs_cpu(pp, pp_cpu, *coma), "mappo": mappo_card_vs_cpu(mappo_run),
            "bc": bc_card_vs_cpu(pp, pp_cpu, bc_net, bc_params, arrays)}
    say("learn", "card vs CPU (TF32 off) on one batch from the card: " + "; ".join(
        f"{path} " + ", ".join(f"{k} {v:.2e}" for k, v in e.items()) for path, e in errs.items()))
    for path, e in errs.items():
        for k, v in e.items():
            tol = MARL_OPT_ATOL if "Adam" in k else MARL_GRAD_RTOL if "gradient" in k else (
                MARL_Q_RTOL if "advantage" in k else MARL_LOSS_RTOL)
            if not v <= tol:
                fail("learn", f"{path} card vs CPU: {k} differs by {v:.2e} > {tol:.0e}")
    return errs


def phase_learn_from_expert(layout_cache, smi):
    """Learning from the dispatcher and on-policy MARL on the card (see the
    docstring's phase 14). Returns (K1 launches by path, the numbers
    printed)."""
    import dataclasses as dc
    import tempfile

    import numpy as np
    import torch

    from swarm_ode_tpu_torch.data.collect import collect_batch
    from swarm_ode_tpu_torch.ops import bfs_bitpack
    from swarm_ode_tpu_torch.rl import ppo
    from swarm_ode_tpu_torch.train import run_rl
    from swarm_ode_tpu_torch.train import train_bc as bc
    from swarm_ode_tpu_torch.utils.checkpoint import CheckpointManager

    cfg_env, lay, pp = layout_cache["medium"]
    E, T = LFE_ENVS, LFE_STEPS
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(13)
    launches, out = {}, {}

    def counted(what, fn, steps=T):
        """fn() with K1's count zeroed before and read after, synchronised;
        (its result, its seconds)."""
        torch.cuda.synchronize()
        bfs_bitpack.LAUNCHES = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        launches[what] = bfs_bitpack.LAUNCHES
        if launches[what] != steps:
            fail("learn", f"{what}: K1 launched {launches[what]} times in {steps} steps")
        return res, time.perf_counter() - t0

    # 1. The dispatcher's decisions, in memory.
    traj, dstats = collect_batch(pp, lay, E, T, 100, gen)
    flat = lambda k: traj[k].reshape((E * T,) + traj[k].shape[2:])
    arrays = (flat("observations").astype(np.float16), flat("actions").astype(np.int32),
              flat("agent_busy"), np.repeat(np.arange(E, dtype=np.int32), T))
    del traj
    with tempfile.TemporaryDirectory() as tmp:
        bc_dir = f"{tmp}/bc"
        # 2. Behaviour cloning.
        bcfg = bc.BCConfig(env_id=MEDIUM, net="gnode", hidden_dim=LFE_HIDDEN, epochs=BC_EPOCHS,
                           batch_size=BC_BATCH, seed=0, checkpoint_dir=bc_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clone = bc.train_bc(bcfg, verbose=False, arrays=arrays)
        torch.cuda.synchronize()
        bc_s = time.perf_counter() - t0
        hist = clone["history"]
        tr = [h["train_loss"] for h in hist]
        if not (np.isfinite([[h[k] for k in h] for h in hist]).all() and tr[-1] < tr[0]):
            fail("learn", f"behaviour cloning: train losses {tr} (finite and falling?)")
        saved = CheckpointManager(bc_dir).restore({"q_params": clone["params"]})
        if saved is None or not all(torch.equal(saved["q_params"][k], v)
                                    for k, v in clone["params"].items()):
            fail("learn", "the behaviour-cloning checkpoint does not hold the best parameters")
        bc_epoch_ms = 1e3 * float(np.mean([h["seconds"] for h in hist]))
        net = clone["net"]
        # 3. One DAgger round.
        (o, a, b, dst), dag_s = counted("dagger collection", lambda: bc.collect_dagger(
            pp, lay, net, clone["params"], E, gen, beta=DAGGER_BETA, coordinated=True,
            steps=T, with_stats=True))
        if dst["replan_overflow"] or o.shape != (T * E,) + arrays[0].shape[1:] or (
                o.dtype != np.float16) or not np.isfinite(o.astype(np.float32)).all():
            fail("learn", f"DAgger collection: overflow {dst['replan_overflow']}, observations "
                 f"{o.shape} {o.dtype}")
        agg = (np.concatenate([arrays[0], o]), np.concatenate([arrays[1], a]),
               np.concatenate([arrays[2], b]),
               np.concatenate([arrays[3], E + np.tile(np.arange(E, dtype=np.int32), T)]))
        t0 = time.perf_counter()
        dagger = bc.train_bc(dc.replace(bcfg, epochs=1, checkpoint_dir=None), verbose=False,
                             arrays=agg, init_params=clone["params"])
        dagger_train_s = time.perf_counter() - t0
        if not np.isfinite(dagger["history"][0]["train_loss"]):
            fail("learn", f"DAgger retraining loss {dagger['history'][0]['train_loss']}")
        # 4. Evaluation of the DAgger clone through the claim auction.
        ev, eval_s = counted("clone evaluation", lambda: bc.evaluate_policy(
            pp, net, dagger["params"], E, gen, coordinated=True, verbose=False, steps=T))
        if ev["replan_overflow"]:
            fail("learn", f"evaluation: overflow {ev['replan_overflow']}")
        # 5. MAPPO warm-started from the clone.
        mcfg = ppo.MAPPOConfig(env_id=MEDIUM, net="gnode", hidden_dim=LFE_HIDDEN, num_envs=E,
                               num_strides=1, ppo_epochs=MAPPO_EPOCHS, minibatch=MAPPO_MINIBATCH,
                               coordinated=True, init_from=bc_dir, seed=0,
                               forbid_host_sync=True, steps_override=T)
        mrun = ppo.MappoRun(mcfg)
        if not all(torch.equal(mrun.actor_params[k], v) for k, v in saved["q_params"].items()):
            fail("learn", "MAPPO's actor before its first update differs from the checkpoint")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mres, mappo_s = counted("mappo collection", lambda: ppo.run_mappo(
            mcfg, verbose=False, run=mrun))
        mappo_peak = torch.cuda.max_memory_allocated() / 2**30
        mh = mres["history"][0]
        if mh["replan_overflow"] or not np.isfinite(
                [mh[k] for k in ("pg_loss", "v_loss", "entropy", "return")]).all():
            fail("learn", f"MAPPO stride: {mh}")
        probe, probe_s = counted("mappo greedy probe", lambda: mrun.eval_probe(
            mrun.draws.split()))
        mappo_rate = E * T / mh["collect_seconds"]
        n_mb = E * T // MAPPO_MINIBATCH
        update_ms = 1e3 * mh["update_seconds"] / (MAPPO_EPOCHS * n_mb)
        short = ppo.MappoRun(dc.replace(mcfg, steps_override=LFE_TRACE_STEPS, init_from=None,
                                        forbid_host_sync=False))
        short.actor_params, short.critic_params = mrun.actor_params, mrun.critic_params
        events, busy = busy_per_call(short.collect, 1)
        busy_step, wall_step = busy / LFE_TRACE_STEPS, 1e3 * mh["collect_seconds"] / T
        # 6. COMA, coordinated.
        ccfg = run_rl.RLRunConfig(
            env_id=MEDIUM, algo="coma", net="gnode", num_envs=E, num_episodes=E,
            hidden_dim=LFE_HIDDEN, buffer_size=COMA_BUFFER, batch_size=COMA_BATCH,
            learn_every=COMA_LEARN_EVERY, coma_updates=COMA_UPDATES, coordinated=True, seed=0,
            forbid_host_sync=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cres, coma_s = counted("coma stride", lambda: run_rl.run_marl(ccfg, verbose=False),
                               cfg_env.max_steps)
        coma_peak = torch.cuda.max_memory_allocated() / 2**30
        ch = cres["history"][0]
        if ch["replan_overflow"] or not np.isfinite([ch["critic_loss"], ch["actor_loss"]]).all():
            fail("learn", f"COMA stride: overflow {ch['replan_overflow']}, critic loss "
                 f"{ch['critic_loss']}, actor loss {ch['actor_loss']}")
        if int(cres["agent_state"].step) != COMA_UPDATES:
            fail("learn", f"COMA took {int(cres['agent_state'].step)} updates")
        coma_rate = E * cfg_env.max_steps / ch["episode_seconds"]
        coma_update_ms = 1e3 * ch["coma_update_seconds"] / COMA_UPDATES
        # 7. QMIX built with init_q_from the clone.
        qrun = run_rl.MarlRun(run_rl.RLRunConfig(
            env_id=MEDIUM, algo="qmix", net="gnode", num_envs=E, hidden_dim=LFE_HIDDEN,
            buffer_size=1024, init_q_from=bc_dir))
        for k, v in saved["q_params"].items():
            if not (torch.equal(qrun.astate.params[f"q.{k}"], v)
                    and torch.equal(qrun.astate.target_params[f"q.{k}"], v)):
                fail("learn", f"init_q_from: q.{k} (or its target) differs from the checkpoint")
        del qrun
    say("learn", f"medium, {E} envs x {T} steps, net gnode, hidden {LFE_HIDDEN}: behaviour "
        f"cloning on {E} expert episodes ({arrays[0].shape[0]} rows, in memory) for "
        f"{BC_EPOCHS} epochs at batch {BC_BATCH}: {bc_epoch_ms:.1f} ms an epoch "
        f"({bc_s:.2f} s with set-up), train loss {tr[0]:.4f} -> {tr[-1]:.4f}, val loss "
        f"{hist[-1]['val_loss']:.4f}, val accuracy {hist[-1]['val_acc']:.3f}, checkpoint read "
        f"back bit for bit; DAgger collection (beta {DAGGER_BETA}, coordinated) "
        f"{E * T / dag_s:.1f} env steps/s ({dag_s:.2f} s), {dst['deliveries']:.2f} deliveries "
        f"an episode, then 1 epoch on {agg[0].shape[0]} rows in {dagger_train_s:.2f} s; "
        f"evaluate_policy (coordinated) {E * T / eval_s:.1f} env steps/s, deliveries "
        f"{ev['deliveries']:.2f} an episode (the dispatcher's "
        f"{float(np.mean(dstats['deliveries'])):.2f}); on {smi}")
    say("learn", f"MAPPO, one stride warm-started from the clone (actor equal to the "
        f"checkpoint bit for bit), coordinated, collection with host synchronisation "
        f"forbidden: {mappo_rate:.1f} env steps/s collected ({1e3 * mh['collect_seconds']:.1f} "
        f"ms), {update_ms:.3f} ms per minibatch step ({MAPPO_EPOCHS} epochs x {n_mb} of "
        f"{MAPPO_MINIBATCH}; {mh['update_seconds']:.2f} s), stride {mappo_s:.2f} s with "
        f"set-up, peak memory {mappo_peak:.3f} GiB; pg {mh['pg_loss']:.5f}, v {mh['v_loss']:.5f}, "
        f"entropy {mh['entropy']:.4f}, deliveries {mh['deliveries']:.2f} an episode; greedy "
        f"probe {E * T / probe_s:.1f} env steps/s, deliveries {probe[1]:.2f}; device busy "
        f"{busy_step:.3f} ms a step in a traced collection of {LFE_TRACE_STEPS} steps "
        f"({events / LFE_TRACE_STEPS:.1f} device events a step): busy share "
        f"{busy_step / wall_step:.3f}")
    say("learn", f"COMA, one coordinated stride (batch {COMA_BATCH}, buffer {COMA_BUFFER}, "
        f"{COMA_UPDATES} updates), the episode with host synchronisation forbidden: "
        f"{coma_rate:.1f} env steps/s in the episode ({ch['episode_seconds']:.2f} s), "
        f"{coma_update_ms:.1f} ms per update, stride {coma_s:.2f} s with set-up, peak memory "
        f"{coma_peak:.3f} GiB; critic loss {ch['critic_loss']:.5f}, actor loss "
        f"{ch['actor_loss']:.5f}, deliveries {ch['deliveries']} an env; QMIX built with "
        f"init_q_from the clone: Q-network and targets equal to the checkpoint bit for bit")
    # 8. Card against CPU.
    errs = learn_card_vs_cpu(pp, lay, cfg_env, (ccfg, cres), mrun, net, clone["params"], arrays)
    say("learn", f"K1 launches by path {launches}, overflow 0; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    out.update(bc_epoch_ms=bc_epoch_ms, dagger_steps_per_sec=E * T / dag_s,
               eval_deliveries=ev["deliveries"], mappo_steps_per_sec=mappo_rate,
               mappo_update_ms=update_ms, mappo_peak_gib=mappo_peak,
               mappo_busy_share=busy_step / wall_step, coma_steps_per_sec=coma_rate,
               coma_update_ms=coma_update_ms, coma_stride_s=coma_s, coma_peak_gib=coma_peak,
               card_vs_cpu=errs)
    return launches, out


def baseline_card_vs_cpu(ds, model_cpu, name, pairs, cfg):
    """One baseline step on the card and on the CPU from the same
    parameters and windows (TF32 off): (loss rel. error, worst gradient
    error over its largest element, worst parameter error of the card's
    AdamW from the CPU's clipped gradients, the loss)."""
    import copy

    import numpy as np
    import torch

    from swarm_ode_tpu_torch.train import train_baselines as tb
    from swarm_ode_tpu_torch.train import train_gde as tg
    from swarm_ode_tpu_torch.utils.optim import adamw_init, adamw_update, clip_by_global_norm

    out = {}
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(model_cpu).to(dev)
        data = {"episodes": torch.from_numpy(np.stack(ds.episodes)).to(dev),
                "positions": torch.from_numpy(np.stack(ds._positions)).to(dev)}
        params = list(model.parameters())
        loss = tb.baseline_loss(model, name.startswith("pos_"))(
            tg.window_batch(data, pairs.to(dev), ds.seq_len, with_pos=True))
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            clipped = clip_by_global_norm(grads, cfg.grad_clip)
            adamw_update(params, clipped, adamw_init(params), cfg.lr, cfg.weight_decay)
        out[dev] = (loss.detach(), grads, clipped, [p.detach() for p in params])
    (lg, gg, _, _), (lc, gc, cc, pc) = out["cuda"], out["cpu"]
    model = copy.deepcopy(model_cpu).cuda()
    params = list(model.parameters())
    with torch.no_grad():
        adamw_update(params, [c.cuda() for c in cc], adamw_init(params), cfg.lr,
                     cfg.weight_decay)
    opt_err = max(float((a.detach().cpu() - b).abs().max()) for a, b in zip(params, pc))
    return (_max_rel(lg, lc), max(_max_rel(a, b) for a, b in zip(gg, gc)), opt_err,
            float(lc))


def phase_baselines(pp, lay, smi):
    """The four trajectory baselines at the flagship's shape on the card
    (see the docstring's phase 15). Returns the numbers printed."""
    import copy

    import numpy as np
    import torch

    from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset
    from swarm_ode_tpu_torch.train import train_baselines as tb
    from swarm_ode_tpu_torch.train import train_gde as tg
    from swarm_ode_tpu_torch.utils.optim import adamw_init

    t0 = time.perf_counter()
    obs = record_episodes(pp, lay, BASE_ENVS, BASE_STEPS, seed=17)
    ds = TrajectoryDataset(episodes=list(obs), num_agvs=pp.num_agvs,
                           num_pickers=pp.num_pickers, seq_len=WINDOW)
    say("recurrent", f"data: {BASE_ENVS} medium episodes x {BASE_STEPS} steps from the port's "
        f"rollout, {ds.num_agents} agents x {ds.obs_dim} features, {len(ds)} windows of "
        f"{WINDOW}; {time.perf_counter() - t0:.1f} s")
    index = np.asarray(ds._index, np.int32)
    rng = np.random.RandomState(3)
    pairs = torch.from_numpy(index[rng.choice(len(ds), BASE_BATCH, replace=False)])
    data = {"episodes": torch.from_numpy(np.stack(ds.episodes)).cuda(),
            "positions": torch.from_numpy(np.stack(ds._positions)).cuda()}
    out = {}
    for name in tb.MODEL_FACTORIES:
        cfg = tb.BaselineTrainConfig(model=name, num_epochs=BASE_EPOCHS,
                                     batch_size=BASE_BATCH, hidden_dim=BASE_HIDDEN)
        model_cpu = tb.MODEL_FACTORIES[name](ds, BASE_HIDDEN).init_(
            torch.Generator().manual_seed(0))
        loss_err, grad_err, opt_err, loss = baseline_card_vs_cpu(ds, model_cpu, name, pairs, cfg)
        if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL
                and opt_err <= TRAIN_OPT_ATOL):
            fail("recurrent", f"{name}: one step card vs CPU: loss {loss_err:.2e}, gradient "
                 f"{grad_err:.2e}, AdamW from the CPU's gradients {opt_err:.2e}")

        # train_baseline on the card from the same init: resident episodes,
        # windows cut on the device, one loss read back an epoch.
        init = {k: v.cuda() for k, v in model_cpu.state_dict().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tb.train_baseline(ds, cfg, verbose=False, init_params=init)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        hist = res["history"]
        if not (np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
                and hist["train_loss"][-1] < hist["train_loss"][0]):
            fail("recurrent", f"{name}: train_baseline losses {hist} (finite and falling?)")

        # ms per train step: best of 3 x BASE_REPS steps, synchronised; one
        # step with host synchronisation forbidden.
        model = copy.deepcopy(model_cpu).cuda()
        params = list(model.parameters())
        loss_fn = tb.baseline_loss(model, name.startswith("pos_"))
        opt = adamw_init(params)

        def steps(tp):
            nonlocal opt
            for p in tp:
                opt, _ = tg.train_step(params, opt, loss_fn,
                                       tg.window_batch(data, p, WINDOW, with_pos=True), cfg)

        tp = torch.from_numpy(index[rng.choice(len(ds), (BASE_REPS, BASE_BATCH))]).cuda()
        steps(tp)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            steps(tp[:1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(tp)
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0) / BASE_REPS)
        torch.cuda.reset_peak_memory_stats()
        steps(tp[:1])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        events, busy = busy_per_call(lambda: steps(tp[:1]), BASE_REPS)
        ms = min(runs)
        n_params = sum(p.numel() for p in params)
        say("recurrent", f"{name} ({n_params} parameters, hidden {BASE_HIDDEN}, windows of "
            f"{WINDOW}x{ds.num_agents}x{ds.obs_dim}, batch {BASE_BATCH}): one step card vs CPU "
            f"(TF32 off): loss {loss:.4f}, rel. error {loss_err:.2e}, worst gradient error "
            f"{grad_err:.2e} of its largest, AdamW from the CPU's gradients {opt_err:.2e}; "
            f"train_baseline {BASE_EPOCHS} epochs on the card in {train_s:.2f} s, train loss "
            + " -> ".join(f"{v:.4f}" for v in hist["train_loss"])
            + f", val loss {hist['val_loss'][-1]:.4f}; a step with host synchronisation "
            f"forbidden: passed; train ms per step {ms:.3f} (best of 3 x {BASE_REPS}; runs "
            + ", ".join(f"{r:.3f}" for r in runs)
            + f"), windows/s {BASE_BATCH / ms * 1e3:.1f}, peak {peak:.3f} GiB, device events "
            f"per step {events:.1f}, device busy {busy:.3f} ms per step (busy share "
            f"{busy / ms:.3f}); on {smi}")
        out[name] = {"ms_per_step": ms, "windows_per_sec": BASE_BATCH / ms * 1e3,
                     "peak_gib": peak, "busy_share": busy / ms, "events": events,
                     "loss_err": loss_err, "grad_err": grad_err, "opt_err": opt_err}
    return out


class _MirroredDraws:
    """A run's draws made on the CPU and moved to `device`: a run on the
    card and one on the CPU, each with its own copy from the same seed,
    take the same draws."""

    def __init__(self, draws, device):
        self.draws, self.device = draws, device

    def reset(self, B):
        from swarm_ode_tpu_torch import convert

        return convert.env_state_to(self.draws.reset(B), self.device)

    def __getattr__(self, name):
        fn = getattr(self.draws, name)
        return lambda *a: _tree_to(fn(*a), self.device)


def gru_card_vs_cpu(cfg, pp_cpu):
    """run_marl's GRU pieces card against CPU (TF32 off): MarlRun on each
    from the same agent state and draws for GRU_CHECK_STEPS env steps of
    B envs (near-greedy: epsilon 0.05): actions, rewards and features
    identical, the hidden states in replay within MARL_Q_RTOL of the
    largest |h|; one learn step on one sampled batch: the loss within
    MARL_LOSS_RTOL, the gradient within MARL_GRAD_RTOL of its largest
    element, Adam on the card from the CPU's gradients within
    MARL_OPT_ATOL. Returns the numbers."""
    import dataclasses as dc

    import torch

    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.rl import replay
    from swarm_ode_tpu_torch.train import run_rl
    from swarm_ode_tpu_torch.utils.optim import adamw_update, clip_by_global_norm

    ccfg = dc.replace(cfg, device="cpu", buffer_size=GRU_CHECK_STEPS * GRU_ENVS,
                      epsilon_start=0.05, checkpoint_dir=None, forbid_host_sync=False)
    runs = {}
    for dev in ("cpu", "cuda"):
        draws = run_rl.MarlDraws(pp_cpu, torch.Generator().manual_seed(21), False, "iql")
        run = run_rl.MarlRun(dc.replace(ccfg, device=dev),
                             draws=draws if dev == "cpu" else _MirroredDraws(draws, dev),
                             agent_state=None if dev == "cpu" else
                             _tree_to(runs["cpu"].astate, dev))
        es = run.draws.reset(GRU_ENVS)
        o = observe(run.params, es)
        for t in range(GRU_CHECK_STEPS):
            es, o, _ = run.env_step(es, o, t, 0)
        runs[dev] = run
    sc, sg = runs["cpu"].buf.storage, runs["cuda"].buf.storage
    for k in ("actions", "rewards", "obs_feats", "next_feats", "done"):
        if not all(torch.equal(a.cpu(), b) for a, b in zip(_leaves(sg[k]), _leaves(sc[k]))):
            fail("recurrent", f"graph-GRU run: {k} differ on the card and the CPU")
    h_err = max(_max_err(a, b) / float(b.abs().max()) for k in ("extras", "next_extras")
                for a, b in zip(sg[k], sc[k]))
    if h_err > MARL_Q_RTOL:
        fail("recurrent", f"graph-GRU run: hidden states differ by {h_err:.2e} of the largest")
    n_actions = sc["actions"].numel()
    idx = torch.randint(0, runs["cpu"].buf.size, (cfg.batch_size,),
                        generator=torch.Generator().manual_seed(4))
    agent_c, agent_g = runs["cpu"].agent, runs["cuda"].agent
    st = runs["cpu"].astate
    batch = run_rl.batch_from(replay.sample_nstep(runs["cpu"].buf, cfg.batch_size, cfg.n_step,
                                                  GRU_ENVS, idx=idx),
                              "iql", agent_c.cfg.gamma, cfg.n_step)
    new_c, aux_c, gr_c = agent_c.learn_with_grads(st, batch)
    _, aux_g, gr_g = agent_g.learn_with_grads(_tree_to(st, "cuda"), _tree_to(batch, "cuda"))
    loss_err = abs(float(aux_g["loss"]) - float(aux_c["loss"])) / abs(float(aux_c["loss"]))
    scale = max(float(v.abs().max()) for v in gr_c.values())
    grad_err = max(_max_err(gr_g[k], gr_c[k]) for k in gr_c) / scale
    names = list(st.params)
    clipped = clip_by_global_norm([gr_c[k] for k in names], agent_c.cfg.grad_clip)
    on_card = [st.params[k].cuda().clone() for k in names]
    adamw_update(on_card, [c.cuda() for c in clipped], _tree_to(st.opt_state, "cuda"),
                 agent_c.cfg.lr, 0.0)
    opt_err = max(_max_err(p, new_c.params[k]) for p, k in zip(on_card, names))
    if not (loss_err <= MARL_LOSS_RTOL and grad_err <= MARL_GRAD_RTOL
            and opt_err <= MARL_OPT_ATOL):
        fail("recurrent", f"graph-GRU learn step card vs CPU: loss {loss_err:.2e}, gradient "
             f"{grad_err:.2e}, parameters after Adam from the CPU's gradients {opt_err:.2e}")
    return {"steps": GRU_CHECK_STEPS, "actions": n_actions, "hidden_rel_err": h_err,
            "loss": float(aux_c["loss"]), "loss_err": loss_err, "grad_err": grad_err,
            "opt_err": opt_err}


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in x for v in _leaves(x[k])]
    if isinstance(x, tuple):
        return [v for item in x for v in _leaves(item)]
    return [x]


def phase_recurrent(layout_cache, smi):
    """The recurrent models on the card (see the docstring's phase 15): the
    four baselines, then graph-GRU IQL through run_marl, its greedy
    evaluation resumed from the checkpoint and the served policy. Returns
    (K1 launches by path, the numbers printed)."""
    import dataclasses as dc
    import tempfile

    import numpy as np
    import torch

    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.ops import bfs_bitpack
    from swarm_ode_tpu_torch.rl import replay
    from swarm_ode_tpu_torch.serving import make_policy_fn
    from swarm_ode_tpu_torch.train import run_rl

    cfg_env, lay, pp = layout_cache["medium"]
    t_phase = time.perf_counter()
    out = {"baselines": phase_baselines(pp, lay, smi)}
    launches = {}
    with tempfile.TemporaryDirectory() as ckdir:
        # scripts/run_gru.py's recipe (iql, gru, hidden 256, buffer 20,000,
        # batch 32, a learn step every env step, n_step 3) on 8 envs.
        cfg = run_rl.RLRunConfig(
            env_id=MEDIUM, algo="iql", net="gru", num_envs=GRU_ENVS, num_episodes=GRU_ENVS,
            hidden_dim=GRU_HIDDEN, buffer_size=GRU_BUFFER, batch_size=GRU_BATCH, seed=0,
            checkpoint_dir=ckdir, checkpoint_every=GRU_ENVS, forbid_host_sync=True)
        checks = gru_card_vs_cpu(cfg, make_params(cfg_env, lay, "cpu"))
        say("recurrent", f"graph-GRU IQL card vs CPU (TF32 off), medium B={GRU_ENVS}, hidden "
            f"{GRU_HIDDEN}, {checks['steps']} env steps from one agent state and one set of "
            f"draws (epsilon 0.05): {checks['actions']} actions, the rewards and features "
            f"identical, hidden states in "
            f"replay within {checks['hidden_rel_err']:.2e} of the largest; one learn step on "
            f"a sampled batch of {GRU_BATCH}: loss {checks['loss']:.5f}, rel. error "
            f"{checks['loss_err']:.2e}, gradient {checks['grad_err']:.2e} of its largest, "
            f"parameters after Adam from the CPU's gradients {checks['opt_err']:.2e}")
        agent, _ = run_rl.make_agent(cfg, pp)
        start = agent.init(torch.Generator(device="cuda").manual_seed(0))
        init = {k: v.clone() for k, v in start.params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bfs_bitpack.LAUNCHES = 0
        t0 = time.perf_counter()
        res = run_rl.run_marl(cfg, verbose=False, agent_state=start)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["gru train"] = bfs_bitpack.LAUNCHES
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        stats, losses, trained = res["history"][0], res["losses"][0], res["agent_state"]
        steps = len(losses)
        buf = res["buffer"]
        item_bytes = buf.nbytes() / buf.capacity
        extras_bytes = sum(h.numel() * h.element_size() for k in ("extras", "next_extras")
                           for h in buf.storage[k]) / buf.capacity
        if launches["gru train"] != steps or stats["replan_overflow"]:
            fail("recurrent", f"graph-GRU training: K1 launched {launches['gru train']} times "
                 f"in {steps} steps, overflow {stats['replan_overflow']}")
        if not (np.isfinite(losses).all() and stats["loss"] != 0.0):
            fail("recurrent", f"graph-GRU training loss {stats['loss']}")
        moved = sum(not torch.equal(trained.params[k], v) for k, v in init.items())
        if not any(k.startswith(("agv_gru.", "picker_gru.")) and not torch.equal(
                trained.params[k], v) for k, v in init.items()):
            fail("recurrent", "graph-GRU training left the GRU cells' parameters unchanged")
        h_last = max(float(h[: steps * GRU_ENVS].abs().max()) for h in buf.storage["extras"])
        rate = GRU_ENVS * steps / stats["seconds"]
        wall_step = 1e3 * stats["seconds"] / steps

        # ms per learn step, alone: sample + batch + learn, synchronised.
        gcuda = torch.Generator(device="cuda").manual_seed(9)

        def learn_once():
            sampled = replay.sample_nstep(buf, GRU_BATCH, cfg.n_step, GRU_ENVS, generator=gcuda)
            agent.learn(trained, run_rl.batch_from(sampled, "iql", agent.cfg.gamma, cfg.n_step))

        learn_once()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(MARL_LEARN_REPS):
            learn_once()
        torch.cuda.synchronize()
        learn_ms = 1e3 * (time.perf_counter() - t1) / MARL_LEARN_REPS

        # Busy share: a traced block of steps with learning on the trained
        # state, over the training run's wall time a step.
        run = run_rl.MarlRun(dc.replace(cfg, buffer_size=1024, checkpoint_dir=None),
                             agent_state=trained)
        carry = {"es": run.draws.reset(GRU_ENVS), "t": 0}
        carry["obs"] = observe(pp, carry["es"])

        def block():
            for _ in range(MARL_TRACE_STEPS):
                carry["es"], carry["obs"], _ = run.env_step(carry["es"], carry["obs"],
                                                            carry["t"], 0)
                carry["t"] += 1
                run.learn_block()

        for _ in range(3):  # fill past the warm start
            block()
        events, busy = busy_per_call(block, 1)
        busy_step = busy / MARL_TRACE_STEPS
        say("recurrent", f"run_marl, scripts/run_gru.py's recipe for one stride (iql, gru, "
            f"{GRU_ENVS} envs x {steps} steps, hidden {GRU_HIDDEN}, buffer {GRU_BUFFER} "
            f"({buf.nbytes() / 1e9:.3f} GB on the card, {item_bytes:.0f} bytes an item of "
            f"which {extras_bytes:.0f} the hidden states), batch {GRU_BATCH}, learn every "
            f"step, n_step 3), the episode with host synchronisation forbidden: "
            f"marl_env_steps_per_sec {rate:.1f} ({wall_step:.3f} ms a step with its learn "
            f"step; {wall:.2f} s with set-up), {learn_ms:.3f} ms per learn step alone "
            f"(synchronised, mean of {MARL_LEARN_REPS}); peak memory {peak_gb:.3f} GiB; K1 "
            f"launches {launches['gru train']}, overflow {stats['replan_overflow']}; loss "
            f"{stats['loss']:.5f}, epsilon {float(trained.epsilon):.4f}, {moved} of "
            f"{len(init)} parameter tensors moved, largest stored |hidden| {h_last:.3f}; "
            f"deliveries {stats['deliveries']} an env; device busy {busy_step:.3f} ms a step "
            f"in a traced block of {MARL_TRACE_STEPS} steps with learning "
            f"({events / MARL_TRACE_STEPS:.1f} device events a step): busy share "
            f"{busy_step / wall_step:.3f}; on {smi}")

        # Greedy evaluation, resuming from the run's checkpoint.
        ecfg = dc.replace(cfg, num_episodes=0, eval_episodes=GRU_ENVS, resume_from=ckdir,
                          checkpoint_dir=None, forbid_host_sync=False)
        torch.cuda.synchronize()
        bfs_bitpack.LAUNCHES = 0
        t0 = time.perf_counter()
        ev = run_rl.run_marl(ecfg, verbose=False)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches["gru eval"] = bfs_bitpack.LAUNCHES
        rs = ev["agent_state"]
        same = all(torch.equal(getattr(rs, k)[n], getattr(trained, k)[n])
                   for k in ("params", "target_params") for n in trained.params)
        same = same and all(torch.equal(a, b) for a, b in zip(
            [rs.opt_state.count, rs.epsilon, rs.step, *rs.opt_state.mu, *rs.opt_state.nu],
            [trained.opt_state.count, trained.epsilon, trained.step, *trained.opt_state.mu,
             *trained.opt_state.nu]))
        if not same:
            fail("recurrent", "resume_from did not restore the GRU agent state bit for bit")
        if launches["gru eval"] != steps:
            fail("recurrent", f"eval: K1 launched {launches['gru eval']} times in {steps} "
                 f"steps")
        eh = ev["history"][0]

    # The trained GRU Q-network served through make_policy_fn (zero hidden
    # states each call) over SERVED_STEPS steps of a medium episode.
    net = run_rl.make_network(cfg, pp.num_actions,
                              1.0 / max(pp.grid_h, pp.grid_w)).to(pp.device)
    policy = make_policy_fn(pp, net, run_rl.agent_params(trained))
    g = torch.Generator(device="cuda").manual_seed(2)
    s = step_mod.reset(pp, 1, g)
    torch.cuda.synchronize()
    bfs_bitpack.LAUNCHES = 0
    deliv = torch.zeros((), device=pp.device)
    t0 = time.perf_counter()
    for _ in range(SERVED_STEPS):
        a = policy(observe(pp, s))
        s, _, _, info = step_mod.step(pp, s, a, generator=g)
        deliv += info["shelf_deliveries"].sum()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches["gru policy served"] = bfs_bitpack.LAUNCHES
    if launches["gru policy served"] != SERVED_STEPS or not torch.isfinite(deliv):
        fail("recurrent", f"served GRU policy: K1 launched {launches['gru policy served']} times")
    say("recurrent", f"greedy evaluation resumed from the checkpoint (agent state restored bit "
        f"for bit): {GRU_ENVS} envs x {steps} steps in {eval_s:.2f} s, deliveries "
        f"{eh['eval_deliveries']:.2f} an env, return {eh['eval_return']:.2f}; "
        f"make_policy_fn serving the trained GRU Q-network over {SERVED_STEPS} steps of a "
        f"medium episode: {int(deliv)} deliveries, {1e3 * serve_s / SERVED_STEPS:.3f} ms a "
        f"step; K1 launches by path "
        f"{launches}; phase {time.perf_counter() - t_phase:.1f} s")
    out.update(card_vs_cpu=checks, env_steps_per_sec=rate, ms_per_step=wall_step,
               learn_ms=learn_ms, peak_gib=peak_gb, busy_share=busy_step / wall_step,
               buffer_gb=buf.nbytes() / 1e9, item_bytes=item_bytes)
    return launches, out



def phase_export(layout_cache, smi):
    """Export and the committed artifacts on the card (see the docstring's
    phase 16). Returns (K1's launches in the served rollout, K4's in the
    served GDE batches)."""
    import torch

    from swarm_ode_tpu_torch import convert, serving
    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.layout import build_layout
    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.graphs import temporal
    from swarm_ode_tpu_torch.models.gde import GraphODE
    from swarm_ode_tpu_torch.ops import bfs_bitpack, segment_pallas
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout, init_state, make_policy
    from swarm_ode_tpu_torch.train.run_rl import RLRunConfig, make_network

    t_phase = time.perf_counter()
    trace_s = {}

    def exported(what, export):
        """export()'s bytes; its seconds (the trace and the save) in trace_s."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = export()
        trace_s[what] = round(time.perf_counter() - t0, 1)
        return blob

    def no_sync(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def committed_policy(name, pp, device):
        meta, sd = convert.committed_params(name, device=device)
        net = make_network(RLRunConfig(net=meta["net"], hidden_dim=meta["hidden_dim"]),
                           pp.num_actions, 1.0 / max(pp.grid_h, pp.grid_w)).to(device)
        return meta, serving.make_policy_fn(pp, net, sd, meta["coordinated"], meta["temperature"])

    # 1. Each committed policy exported on the card and on the CPU, both
    # artifacts loaded on the card, against the direct policy on the card and
    # the port on the CPU.
    for name in POLICY_BLOBS:
        cfg = EnvConfig.from_env_id(convert.committed_params(name, device="cpu")[0]["env_id"])
        lay = build_layout(cfg)
        pp, pp_cpu = make_params(cfg, lay, "cuda"), make_params(cfg, lay, "cpu")
        meta, policy = committed_policy(name, pp, "cuda")
        _, policy_cpu = committed_policy(name, pp_cpu, "cpu")
        # The served policy's artifacts take the served rollout's batch.
        n_obs = SERVE_ENVS if name == SERVED_POLICY else EXPORT_OBS
        gen = torch.Generator(device="cuda").manual_seed(31)
        obs = observe(pp, heuristic_rollout(pp, lay, n_obs, 40, gen).state)
        stochastic = meta["temperature"] > 0
        draws = ()
        if stochastic:
            draws = (step_mod.draw_gumbel((*obs.shape[:-1], pp.num_actions),
                                          torch.Generator().manual_seed(32), "cpu").cuda(),)
        on_card = serving.load_policy(exported(f"{name}, card", lambda: serving.export_policy(
            policy, obs, stochastic)))
        from_cpu = serving.load_policy(exported(f"{name}, CPU", lambda: serving.export_policy(
            policy_cpu, obs.cpu(), stochastic)))
        direct = policy(obs, *draws)
        port_cpu = policy_cpu(obs.cpu(), *(d.cpu() for d in draws))
        got = [no_sync(lambda: f(obs, *draws)) for f in (on_card, from_cpu)]
        torch.cuda.synchronize()
        same = [torch.equal(g, direct) for g in got] + [torch.equal(direct.cpu(), port_cpu)]
        say("export", f"{name} ({meta['env_id']}, {meta['net']}, T = {meta['temperature']}"
            f"{', the same Gumbels' if stochastic else ''}), {n_obs} observations: loaded "
            f"artifacts exported on the card / on the CPU equal the direct policy on the card "
            f"{same[:2]}, the card equals the port on the CPU {same[2]} ({int((direct > 0).sum())} "
            f"actions not noop); loaded calls with host syncs forbidden; export s on the card "
            f"{trace_s[f'{name}, card']}, on the CPU {trace_s[f'{name}, CPU']}")
        if not all(same):
            fail("export", f"{name}: loaded artifacts or the card differ from the direct policy")
        if name == SERVED_POLICY:
            served = on_card

    # 2. The served policy's loaded card artifact drives SERVE_ENVS medium
    # envs for one episode, with the replan compaction off (replan_row_frac
    # 1.0: every needed row runs, in K1 once a step): the default budget,
    # sized for the dispatcher, overflowed 505 rows in 500 steps under this
    # policy at B = 64 (this phase on an H100 with the default). The
    # artifact holds no replan setting (the env step is outside it).
    _, lay, _ = layout_cache["medium"]
    pp = make_params(EnvConfig.from_env_id(MEDIUM, replan_row_frac=1.0), lay, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(33)
    es = step_mod.reset(pp, SERVE_ENVS, gen)
    T = pp.max_steps
    deliv = torch.zeros(SERVE_ENVS, device="cuda")
    overflow = torch.zeros((), dtype=torch.int64, device="cuda")
    served(observe(pp, es))  # warm-up: the loaded module's first call
    torch.cuda.synchronize()
    bfs_bitpack.LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(T):
        es, _, _, info = step_mod.step(pp, es, served(observe(pp, es)), generator=gen)
        deliv += info["shelf_deliveries"]
        overflow += info["replan_overflow"].sum()
    torch.cuda.synchronize()
    serve_ms = 1e3 * (time.perf_counter() - t0) / T
    k1 = bfs_bitpack.LAUNCHES
    say("export", f"loaded {SERVED_POLICY} artifact serving {SERVE_ENVS} medium envs x {T} "
        f"steps (replan_row_frac 1.0): K1 launches {k1}, overflow {int(overflow)}, deliveries "
        f"per env mean {float(deliv.mean()):.2f} (min {float(deliv.min()):.0f}, max "
        f"{float(deliv.max()):.0f}), {serve_ms:.3f} ms a step")
    if k1 != T or int(overflow) != 0 or not bool(torch.isfinite(deliv).all()):
        fail("export", f"served rollout: K1 launched {k1} times in {T} steps, overflow "
             f"{int(overflow)}")

    # 3. The flagship GDE exported on the card, serving phase 8's windows.
    _, lay, pp = layout_cache["medium"]
    meta, sd = convert.committed_params("gde_medium_h4w")
    _, sd_cpu = convert.committed_params("gde_medium_h4w", device="cpu")
    A, D = pp.num_agents, meta["obs_dim"]
    model_args = (D, pp.num_agvs, pp.num_pickers, meta["hidden_dim"], "euler")
    predict = serving.make_gde_fn(GraphODE(*model_args).cuda(), sd, 5.0, meta["horizon"])
    predict_cpu = serving.make_gde_fn(GraphODE(*model_args), sd_cpu, 5.0, meta["horizon"])
    loaded = serving.load_gde(exported(f"gde_medium_h4w, card, B = {GDE_BATCH}",
                                       lambda: serving.export_gde(predict, WINDOW, A, D,
                                                                  batch=GDE_BATCH)))
    policy = make_policy(pp, lay)
    gen = torch.Generator(device="cuda").manual_seed(8)
    es, h = step_mod.reset(pp, GDE_BATCH, gen), init_state(pp, GDE_BATCH)
    w = temporal.init_window(GDE_BATCH, WINDOW, A, D, device="cuda")
    windows = []
    for t in range(WINDOW + 2 + GDE_STEPS):  # phase 8's warm-up, then its served steps
        actions, h = policy(pp, es, h)
        es, _, _, _ = step_mod.step(pp, es, actions, generator=gen)
        w = temporal.push_frame(w, observe(pp, es))
        if t >= WINDOW + 2:
            windows.append(w)

    def serve_all(fn):
        preds, ms = [], []
        for win in windows:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            preds.append(fn(win.obs, win.count))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return preds, sum(ms) / len(ms)

    for fn in (loaded, predict):  # warm-up
        fn(windows[0].obs, windows[0].count)
    torch.cuda.synchronize()
    segment_pallas.LAUNCHES = 0
    got, loaded_ms = serve_all(loaded)
    k4 = segment_pallas.LAUNCHES
    ref, eager_ms = serve_all(predict)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    scale = max(float(b.abs().max()) for b in ref)
    cpu_ref = predict_cpu(windows[-1].obs[:8].cpu(), windows[-1].count[:8].cpu())
    cpu_err = float((got[-1][:8].cpu() - cpu_ref).abs().max())
    no_sync(lambda: loaded(windows[0].obs, windows[0].count))
    tol = 1e-4 * max(1.0, scale)
    say("export", f"loaded gde_medium_h4w artifact (committed weights) over phase 8's "
        f"{GDE_STEPS} batches of {GDE_BATCH} windows: K4 launches {k4}; predictor ms per batch "
        f"loaded {loaded_ms:.3f} (gde_windows_per_sec {GDE_BATCH / loaded_ms * 1e3:.1f}), eager "
        f"{eager_ms:.3f} ({GDE_BATCH / eager_ms * 1e3:.1f}); loaded vs eager on the card max abs "
        f"err {err:.3e}, vs the port on the CPU (8 windows) {cpu_err:.3e}, on predictions up to "
        f"{scale:.2f} (tolerance {tol:.2e}: 1e-4 of the largest); a loaded call with host syncs "
        f"forbidden; export s (trace and save) {trace_s}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if k4 != GDE_STEPS * meta["horizon"] * 3:
        fail("export", f"K4 launched {k4} times in {GDE_STEPS} served batches")
    if not (err <= tol and cpu_err <= tol) or got[-1].shape != (GDE_BATCH, HORIZON + 1, A, 2):
        fail("export", "loaded GDE predictions differ from the eager predictor or the CPU")
    return k1, k4

def phase_mesh(layout_cache, smi, main_path_rate: float):
    """utils/profiling on the main path and one NCCL rank on the card:
    StageTimer's stages, its block_on gate, device_throughput; train_gde
    and run_mappo inside a one-rank process group against the runs without
    one, bit for bit. Returns {path: K1 launches} of the mesh MAPPO
    collection."""
    import tempfile

    import torch
    import torch.distributed as dist

    from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.ops import bfs_bitpack
    from swarm_ode_tpu_torch.parallel import mesh as meshlib
    from swarm_ode_tpu_torch.policies.heuristic import init_state, make_policy
    from swarm_ode_tpu_torch.rl import ppo
    from swarm_ode_tpu_torch.train import train_gde as tg
    from swarm_ode_tpu_torch.utils.profiling import StageTimer, device_throughput

    t_phase = time.perf_counter()
    _, lay, pp = layout_cache["medium"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    policy = make_policy(pp, lay)

    def loop(es, h):
        for _ in range(MESH_STEPS):
            actions, h = policy(pp, es, h)
            es, _, _, _ = step_mod.step(pp, es, actions, generator=gen)
        return es

    es, h = step_mod.reset(pp, BATCH, gen), init_state(pp, BATCH)
    loop(es, h)
    torch.cuda.synchronize()
    timer = StageTimer()
    for _ in range(MESH_STEPS):
        with timer.stage("dispatcher", block_on=es):
            actions, h = policy(pp, es, h)
        with timer.stage("step", block_on=es):
            es, _, _, _ = step_mod.step(pp, es, actions, generator=gen)
    stages = timer.summary({"dispatcher": BATCH, "step": BATCH})
    say("mesh", f"StageTimer, medium B={BATCH}, {MESH_STEPS} steps, block_on the env state: "
        + "; ".join(f"{k}: mean {1e3 * v['mean_s']:.3f} ms, {v['calls']} calls, "
                    f"throughput {v['throughput']:.1f} env steps/s" for k, v in stages.items())
        + f"; on {smi}")

    # The gate: a stage around a device sleep, its length read by CUDA events
    # (the SM clock may run above SM_CYCLES_PER_S: one H100 slept 99,000,000
    # cycles in 0.0498 s). With block_on the stage spans the whole sleep,
    # without it only the launch.
    cycles = int(MESH_SLEEP_S * SM_CYCLES_PER_S)
    x = torch.zeros(1, device="cuda")
    gate, slept = StageTimer(), {}
    for name, block_on in (("block_on", x), ("no block_on", None)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        with gate.stage(name, block_on=block_on):
            start.record()
            torch.cuda._sleep(cycles)
            end.record()
            x += 1
        torch.cuda.synchronize()
        slept[name] = start.elapsed_time(end) / 1e3
    read = {k: v["total_s"] for k, v in gate.summary().items()}
    say("mesh", f"a stage around a device sleep of {cycles} cycles: "
        f"{read['block_on']:.4f} s with block_on (the sleep {slept['block_on']:.4f} s by "
        f"events), {read['no block_on']:.4f} s without (the sleep "
        f"{slept['no block_on']:.4f} s)")
    if not (read["block_on"] >= slept["block_on"]
            and read["no block_on"] < slept["no block_on"]):
        fail("mesh", "StageTimer's block_on did not wait for the card")

    rate = device_throughput(loop, (step_mod.reset(pp, BATCH, gen), init_state(pp, BATCH)),
                             units=BATCH * MESH_STEPS, repeats=3)
    say("mesh", f"device_throughput of {MESH_STEPS} steps of dispatcher + step at B={BATCH}: "
        f"{rate:.1f} env steps/s (best of 3); phase 6's batched_env_steps_per_sec "
        f"{main_path_rate:.1f} over {STEPS} steps; on {smi}")

    obs = record_episodes(pp, lay, TRAIN_ENVS, TRAIN_STEPS, seed=11)
    ds = TrajectoryDataset(episodes=list(obs), num_agvs=pp.num_agvs,
                           num_pickers=pp.num_pickers, seq_len=WINDOW)
    gcfg = tg.GDETrainConfig(num_epochs=1, horizon=HORIZON, horizon_weights=TRAIN_WEIGHTS,
                             device_dtype="uint8")
    mcfg = ppo.MAPPOConfig(**MESH_MAPPO)

    def runs(mesh_devices):
        g = tg.train_gde(ds, gcfg, verbose=False)
        m = ppo.run_mappo(dataclasses.replace(mcfg, mesh_devices=mesh_devices), verbose=False)
        torch.cuda.synchronize()
        return g, m

    def same(a, b):
        """(train_gde equal, run_mappo equal), bit for bit, the timings
        of the MAPPO history left out."""
        drop = ("seconds", "collect_seconds", "update_seconds")
        gde = (a[0]["history"] == b[0]["history"]
               and all(torch.equal(v, b[0][part][k]) for part in ("params", "final_params")
                       for k, v in a[0][part].items()))
        mappo = ([{k: v for k, v in h.items() if k not in drop} for h in a[1]["history"]]
                 == [{k: v for k, v in h.items() if k not in drop} for h in b[1]["history"]]
                 and all(torch.equal(v, b[1][part][k]) for part in ("actor_params", "critic_params")
                         for k, v in a[1][part].items()))
        return gde, mappo

    alone, control = runs(0), runs(0)
    with tempfile.TemporaryDirectory() as store:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0,
                                world_size=1)
        try:
            mesh = meshlib.make_mesh(("dp",))
            t = torch.arange(4.0, device="cuda")
            dist.all_reduce(t)
            dist.broadcast(t, src=0)
            torch.cuda.synchronize()
            if mesh.device != torch.device("cuda", 0) or mesh.size != 1 or not torch.equal(
                    t.cpu(), torch.arange(4.0)):
                fail("mesh", f"one NCCL rank: mesh on {mesh.device} of {mesh.size} rank(s), "
                     f"all_reduce + broadcast gave {t.tolist()}")
            g = tg.train_gde(ds, gcfg, verbose=False)
            torch.cuda.synchronize()
            bfs_bitpack.LAUNCHES = 0
            m = ppo.run_mappo(dataclasses.replace(mcfg, mesh_devices=1), verbose=False)
            torch.cuda.synchronize()
            k1 = bfs_bitpack.LAUNCHES
        finally:
            dist.destroy_process_group()
        dt = time.perf_counter() - t0
    ranked, repeat = same((g, m), alone), same(control, alone)
    hist = g["history"]
    say("mesh", f"one NCCL rank (file store, world size 1; {dt:.1f} s): mesh on {mesh.device}, "
        f"all_reduce + broadcast on the card; train_gde 1 epoch (train loss "
        f"{hist['train_loss'][0]:.6f}, val loss {hist['val_loss'][0]:.6f}) and run_mappo "
        f"mesh_devices=1 (pick rates {[h['pick_rate'] for h in m['history']]}) equal the runs "
        f"without a group bit for bit: {ranked}; control (a second run without a group): "
        f"{repeat}; K1 launches in the mesh MAPPO collection {k1}")
    want_k1 = mcfg.num_strides * mcfg.steps_override
    if not (all(ranked) and all(repeat)):
        fail("mesh", f"one NCCL rank against no group (train_gde, run_mappo) {ranked}; "
             f"control {repeat}")
    if k1 != want_k1:
        fail("mesh", f"K1 launched {k1} times in the mesh MAPPO collection, expected {want_k1}")
    say("mesh", f"phase {time.perf_counter() - t_phase:.1f} s on {smi}")
    return {"MAPPO collection, one NCCL rank": k1}


def phase_evaluate(layout_cache, smi, episodes):
    """Trajectory evaluation (analysis.py) on the card: the committed
    flagship gde_medium_h4w (convert.committed_params; windows of
    5 x 28 x 435, hidden 64) scored by evaluate_gde over EVAL_WINDOWS
    windows of the datagen phase's episodes at batch EVAL_BATCH, K4's
    count zeroed before and read after; the same predictions on the CPU
    (assert_eval_agrees); the mean error and success@2.0 gates; the four
    baselines at BASE_HIDDEN, card against CPU. Returns K4's launches in
    the counted evaluation."""
    import numpy as np
    import torch

    from swarm_ode_tpu_torch import analysis, convert
    from swarm_ode_tpu_torch.data.dataset import TrajectoryDataset
    from swarm_ode_tpu_torch.models.gde import GraphODE
    from swarm_ode_tpu_torch.ops import segment_pallas
    from swarm_ode_tpu_torch.train.train_baselines import MODEL_FACTORIES

    t_phase = time.perf_counter()
    _, _, pp = layout_cache["medium"]
    ds = TrajectoryDataset(episodes=list(episodes), num_agvs=pp.num_agvs,
                           num_pickers=pp.num_pickers, seq_len=WINDOW)
    meta, sd = convert.committed_params("gde_medium_h4w")
    _, sd_cpu = convert.committed_params("gde_medium_h4w", device="cpu")
    model = GraphODE(meta["obs_dim"], pp.num_agvs, pp.num_pickers, meta["hidden_dim"], "euler")
    windows = range(EVAL_WINDOWS)
    n_batches = -(-EVAL_WINDOWS // EVAL_BATCH)

    # One batch first, counted alone: K4's launches in a batch (one Euler
    # step over t_span = [0, 1]); it also warms the path up.
    segment_pallas.LAUNCHES = 0
    analysis.evaluate_gde(model, sd, ds, range(EVAL_BATCH), EVAL_BATCH)
    per_batch = segment_pallas.LAUNCHES
    torch.cuda.synchronize()
    segment_pallas.LAUNCHES = 0
    t0 = time.perf_counter()
    got = analysis.evaluate_gde(model, sd, ds, windows, EVAL_BATCH)
    eval_s = time.perf_counter() - t0
    k4 = segment_pallas.LAUNCHES
    if per_batch != 3 or k4 != n_batches * per_batch:
        fail("evaluate", f"K4 launched {k4} times in {n_batches} batches ({per_batch} in one "
             f"batch; expected 3: one Euler step, three SAGE layers)")

    predict = analysis.gde_predictor(model, sd, pp.num_agvs)
    t0 = time.perf_counter()
    pred, target = analysis.predict_windows(predict, ds, windows, EVAL_BATCH)
    predict_s = time.perf_counter() - t0
    predict_cpu = analysis.gde_predictor(model, sd_cpu, pp.num_agvs, device="cpu")
    pred_cpu, target_cpu = analysis.predict_windows(predict_cpu, ds, windows, EVAL_BATCH,
                                                    device="cpu")
    if not (np.array_equal(target, target_cpu) and pred.shape == (EVAL_WINDOWS, pp.num_agents, 2)
            and np.isfinite(pred).all()):
        fail("evaluate", f"predictions of shape {pred.shape} or targets differ from the CPU's")
    if analysis.prediction_metrics(pred, target) != got:
        fail("evaluate", "evaluate_gde's metrics are not those of its own predictions")
    cpu = analysis.prediction_metrics(pred_cpu, target_cpu)
    err = assert_eval_agrees("gde_medium_h4w", got, cpu, pred, pred_cpu, target)
    say("evaluate", f"gde_medium_h4w (committed weights) over {EVAL_WINDOWS} medium windows of "
        f"{EVAL_EPISODES} datagen episodes, batch {EVAL_BATCH}: K4 launches {k4} in {n_batches} "
        f"batches ({per_batch} a batch); evaluate_gde {eval_s:.3f} s "
        f"({EVAL_WINDOWS / eval_s:.1f} windows/s with the host metrics), predictions "
        f"{predict_s:.3f} s ({EVAL_WINDOWS / predict_s:.1f} windows/s); card vs CPU "
        f"predictions max abs err {err:.3e}; on {smi}")
    shown = ", ".join(f"{k} {got[k]:.5f} (RESULTS.md {v})" for k, v in RESULTS_FLAGSHIP.items())
    say("evaluate", f"gde_medium_h4w next step: {shown}; success@0.5 "
        f"{got['success_rate@0.5']:.5f}, success@2.0 {got['success_rate@2.0']:.5f}, max error "
        f"{got['max_error']:.5f} (other data than RESULTS.md's: no gate on the comparison)")
    if not (got["mean_error"] < EVAL_MAX_ERROR and got["success_rate@2.0"] > EVAL_MIN_SUCCESS):
        fail("evaluate", f"the committed model scores mean error {got['mean_error']} and "
             f"success@2.0 {got['success_rate@2.0']}: not carried or not loaded")

    base = range(BASE_EVAL_WINDOWS)
    summary = []
    for i, name in enumerate(sorted(MODEL_FACTORIES)):
        net = MODEL_FACTORIES[name](ds, BASE_HIDDEN)
        net.init_(torch.Generator().manual_seed(100 + i))
        pos = name.startswith("pos_")
        t0 = time.perf_counter()
        res = analysis.evaluate_baseline(net, None, ds, pos, base, EVAL_BATCH)
        base_s = time.perf_counter() - t0
        p_card, _ = analysis.predict_windows(analysis.baseline_predictor(net, None, pos), ds,
                                             base, EVAL_BATCH, with_pos=pos)
        p_cpu, t_cpu = analysis.predict_windows(
            analysis.baseline_predictor(net, None, pos, device="cpu"), ds, base, EVAL_BATCH,
            device="cpu", with_pos=pos)
        if analysis.prediction_metrics(p_card, t_cpu) != res:
            fail("evaluate", f"{name}: evaluate_baseline's metrics are not its predictions'")
        e = assert_eval_agrees(name, res, analysis.prediction_metrics(p_cpu, t_cpu), p_card,
                               p_cpu, t_cpu)
        summary.append(f"{name} mean error {res['mean_error']:.3f}, card vs CPU {e:.3e}, "
                       f"{BASE_EVAL_WINDOWS / base_s:.1f} windows/s")
    say("evaluate", f"baselines (seeded weights, hidden {BASE_HIDDEN}) over {BASE_EVAL_WINDOWS} "
        f"windows: " + "; ".join(summary) + f"; phase {time.perf_counter() - t_phase:.1f} s")
    return k4


def assert_eval_agrees(what: str, got, ref, pred, ref_pred, target) -> float:
    """Fails unless the metric dict `got` of predictions `pred` agrees with
    `ref` of `ref_pred`, both against `target` (windows, N, 2): the
    predictions within EVAL_PRED_RTOL of the largest (tol); the continuous
    metrics within 3 tol (a prediction that moves by d moves an error by at
    most d); a success rate only by the predictions whose error lies within
    2 tol of its threshold; the collision flags (analysis.py's 4-D call:
    one agent slot in two windows) only on pairs whose distance lies within
    4 tol of 1.5, and the collision metrics equal where no flag moved.
    Returns the predictions' largest difference."""
    import numpy as np

    def pair_distances(p):
        d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)  # (windows, windows, N)
        iu = np.triu_indices(p.shape[0], k=1)
        return d[iu[0], iu[1]].reshape(-1)

    tol = EVAL_PRED_RTOL * max(1.0, float(np.abs(ref_pred).max()))
    err = float(np.abs(pred - ref_pred).max())
    if not err <= tol or list(got) != list(ref):
        fail("evaluate", f"{what}: predictions differ by {err:.3e} (tolerance {tol:.2e})")
    for k in ("mean_error", "median_error", "max_error", "std_error", "rmse"):
        if not abs(got[k] - ref[k]) <= 3 * tol:
            fail("evaluate", f"{what}: {k} {got[k]!r} against {ref[k]!r}")
    dist = np.linalg.norm(ref_pred - target, axis=-1).reshape(-1)
    for k in (k for k in ref if k.startswith("success_rate@")):
        t = float(k.split("@")[1])
        slack = np.sum(np.abs(dist - t) <= 2 * tol) / dist.size
        if not abs(got[k] - ref[k]) <= slack:
            fail("evaluate", f"{what}: {k} {got[k]!r} against {ref[k]!r} (slack {slack})")
    d_got, d_ref = pair_distances(pred), pair_distances(ref_pred)
    moved = (d_got < 1.5) != (d_ref < 1.5)
    if not np.all(np.abs(d_ref[moved] - 1.5) <= 4 * tol):
        fail("evaluate", f"{what}: a collision flag moved on a pair far from 1.5")
    if not moved.any() and any(got[k] != ref[k] for k in ref if k.startswith("collision_")):
        fail("evaluate", f"{what}: collision metrics differ with no flag moved")
    return err


def phase_cli(smi):
    """`run`'s command line on the card: one medium episode at B = 1, its
    stat line read back with the shared pattern, K1's launches counted
    (zeroed before, read after). Returns (K1 launches, FPS)."""
    import math

    import torch

    from swarm_ode_tpu_torch.ops import bfs_bitpack
    from swarm_ode_tpu_torch.policies import heuristic

    torch.cuda.synchronize()
    bfs_bitpack.LAUNCHES = 0
    episodes, lines = run_cli(["run", "--num_episodes", "1", "--seed", "0"])
    launches = bfs_bitpack.LAUNCHES
    if len(lines) != 1 or len(episodes) != 1:
        fail("cli", f"run printed {len(lines)} lines for {len(episodes)} episodes, not one")
    say("cli", lines[0])
    m = heuristic.STAT_LINE.match(lines[0])
    if m is None:
        fail("cli", "run's stat line does not parse with heuristic.STAT_LINE")
    s = episodes[0]
    printed = dict(zip(heuristic.STAT_FIELDS, map(float, m.groups()[1:])))
    fps = s["episode_length"] / s["seconds"]
    for k, v in printed.items():
        want = fps if k == "fps" else s[k]
        if abs(v - want) > 0.005 + 1e-9 * abs(want):
            fail("cli", f"the stat line's {k} {v} is not the episode's {want}")
    if s["episode_length"] != 500 or not math.isfinite(s["global_episode_return"]) \
            or s["total_deliveries"] <= 0:
        fail("cli", f"episode of {s['episode_length']} steps, return "
             f"{s['global_episode_return']}, {s['total_deliveries']} deliveries")
    if launches != 500 or s["replan_overflow"]:
        fail("cli", f"K1 launched {launches} times (500 expected), overflow {s['replan_overflow']}")
    say("cli", f"run: one medium episode of 500 steps at B = 1 in {s['seconds']:.3f} s "
        f"(synchronised: the trajectory read back), FPS {fps:.2f}; K1 launches {launches}, "
        f"overflow 0; on {smi}")
    return launches, fps


def main() -> None:
    t_start = time.perf_counter()
    import torch

    smi = phase_card()
    # Full float32 in matrix products and cuDNN: the GDE phase holds the
    # card to the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    regs = phase_build()
    layouts = {}
    query_times = phase_kernels(layouts, regs)
    k3_times, k3_err = phase_fields(layouts)
    k1_stochastic = phase_card_vs_cpu(layouts)
    by_setting, main_path_rate = phase_main_path(layouts)
    k3_launches = phase_full_field(layouts)
    k4_launches, k4 = phase_gde(layouts, smi)
    k4_training, k4_trained = phase_train(layouts, smi)
    k1_parity, _ = phase_distribution(smi)
    k1_datagen, _, eval_episodes = phase_datagen(layouts, smi)
    k1_env_api = phase_env_api(layouts)
    k1_marl, _ = phase_marl(layouts, smi)
    k1_learn, _ = phase_learn_from_expert(layouts, smi)
    k1_recurrent, _ = phase_recurrent(layouts, smi)
    k1_export, k4_export = phase_export(layouts, smi)
    k1_mesh = phase_mesh(layouts, smi, main_path_rate)
    k4_eval = phase_evaluate(layouts, smi, eval_episodes)
    k1_run, _ = phase_cli(smi)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s on {smi}")

    def entry(k, name, replaces, setting):
        # `launches`: the counted main-path run (both settings); the other
        # setting launched this kernel 0 times, as launches_by_setting shows.
        # Times at 12,672 medium rows; mask_build_ms is the plain row build
        # the kernel replaces, mask_row_bound_ms the earlier yardstick (the
        # bound of a query over prebuilt (K, n) masks).
        return {"name": name, "route": "cuda", "source": "swarm_ode_tpu_torch/csrc/bfs_query.cu",
                "replaces": replaces, "launches": sum(c[k] for c in by_setting.values()),
                "bfs_kernel_setting": setting,
                "launches_by_setting": {s: c[k] for s, c in by_setting.items()},
                "library_ms": None, **query_times[k]}

    k1 = entry("K1", "bitpack_query (K1)", "swarm_ode_tpu/ops/bfs_bitpack.py:75",
               "bitpack32 (default)")
    # K1's launches on the expert-data paths, each counted alone.
    k1["launches_by_path"] = {
        "main path rollout": by_setting["bitpack32"]["K1"], "datagen": k1_datagen,
        "stochastic expert (card vs CPU)": k1_stochastic, **k1_env_api, **k1_marl,
        **k1_learn, **k1_recurrent, "exported policy served": k1_export, **k1_mesh,
        "parity command line (30 envs)": k1_parity, "run command line (1 env)": k1_run}

    planned, narrow = k4[435], k4[HIDDEN]
    record = {"kernels": [
        k1,
        entry("K2", "bfs_query_int32 (K2)", "swarm_ode_tpu/ops/bfs_pallas.py:79", "int32"),
        # `launches`: the counted full-field rollout (bfs_backend="xla").
        {"name": "bfs_dist (K3)", "route": "cuda", "source": "swarm_ode_tpu_torch/csrc/bfs_dist.cu",
         "replaces": "swarm_ode_tpu/ops/bfs_pallas.py:69", "launches": k3_launches,
         "path": "full-field rollout, bfs_backend=xla", "max_abs_err": k3_err,
         "ms": k3_times["K3"], "trace_ms": k3_times["K3, trace"], "plain_ms": k3_times["plain"],
         "bound_ms": k3_times["bound"][0],
         "bound_by": k3_times["bound"][1], "library_ms": None,
         "ms_200_sweeps": k3_times["K3, 200 sweeps"], "ms_0_sweeps": k3_times["K3, 0 sweeps"],
         "registers": regs["bfs_dist_kernel<1>"][0]},
        # `launches`: the counted GDE serving run. Times of the served form
        # (planned, mean) at D = 435, the observation width; library_ms is
        # torch.sparse.mm of the CSR adjacency. D = 64 and the general form
        # (segment_sum_call, plan included; index_add_ its yardstick) beside.
        {"name": "segment_sum (K4)", "route": "cuda",
         "source": "swarm_ode_tpu_torch/csrc/segment_sum.cu",
         "replaces": "swarm_ode_tpu/ops/segment_pallas.py:25", "launches": k4_launches,
         "path": "GDE serving",
         # The training slice's path, counted in two runs: train_gde (none:
         # it aggregates structurally), then one served batch of its weights.
         "launches_by_path": {"GDE serving": k4_launches, "GDE training": k4_training,
                              "trained weights served": k4_trained,
                              "exported GDE served": k4_export,
                              "trajectory evaluation": k4_eval},
         "max_abs_err": max(planned["max_abs_err"], narrow["max_abs_err"]),
         "ms": planned["ms"], "trace_ms": planned["trace_ms"], "plain_ms": planned["plain_ms"],
         "bound_ms": planned["bound_ms"],
         "bound_by": planned["bound_by"], "library_ms": planned["library_ms"],
         "plan_ms": planned["plan_ms"],
         "d64": {k: narrow[k] for k in ("ms", "trace_ms", "plain_ms", "bound_ms", "library_ms",
                                        "plan_ms")},
         "general": {D: {k[len("general_"):]: k4[D][k] for k in
                         ("general_ms", "general_plain_ms", "general_bound_ms",
                          "general_library_ms")} for D in k4}},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
