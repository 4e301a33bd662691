#!/usr/bin/env python3
"""Smoke test of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, one JSON line each:

  build    nvcc-builds every CUDA source of the port (src/repro_torch/
           kernels/csrc/*.cu, all at once) for sm_90a.
  kernels  holds each kernel to its plain PyTorch version on the card, at
           the main paths' shapes (rbf_matvec also at the grBCM tiles, M =
           1 and Ni = 16,200; nll_grad at gapx's N = 16,200) and at
           ragged/edge shapes (rbf_gram at
           the sparse fit's panel, the 100k fleet's tail panel, a square
           panel with noise and edge shapes), checks that rbf_matvec is
           bitwise repeatable and, traced at the serving tile and at the
           sparse serving tile, one device launch a call (its device
           time, host us per call and 20-call repeatability reported),
           that two nll_grad calls are bitwise equal, that cholupdate equals
           its plain version bit for bit in every case, is bitwise
           repeatable over 20 evictions, makes at most two device launches
           a call (traced), leaves a factor bitwise unchanged under a zero
           x and its inactive agents untouched, raises when a panel's
           rotations are withheld (its watchdog), and that its branch-free
           division and sqrt equal the intrinsics bit for bit (every sqrt
           input in range, 2^32 random divisions), and times each kernel,
           its plain version and a library yardstick with CUDA events
           beside the kernel's lower bound.
  serve    the serving path: a paper-scale DEC-rBCM fleet (32,400 points
           from a GP field, M = 4 agents on a path graph, 200 DAC sweeps,
           chunk 256, float32, streamed mean) fitted at the true
           hyperparameters through GPFleet, serving 8 micro-batches of 256
           queries and one 4,096-query call. It checks rbf_matvec launched
           once per query tile, that the means agree with the same experts
           served without the kernel, and the RMSE against the noise-free
           field.
  fullgp   the FULL-GP yardstick: predict_full (paper eq. 5-6) at the true
           hyperparameters over all 32,400 points for the serve phase's
           6,144 queries, in float32 and, when the float32 Cholesky fails
           (NaN), in float64, with the failure reported; then
           train_full_gp (multi-start Adam on log theta) on the
           GPExperimentConfig.n_train = 8,100 points spread over the
           square, float64, from theta0: FULLGP_STARTS starts of
           FULLGP_STEPS steps, one start when a probe says they would
           take longer than FULLGP_BUDGET_S. It checks the RMSE, that
           the NLL fell and theta is finite, and reports ms, peak memory,
           ms per step and the recovered theta.
  fleets   the paper's other fleets, M = 10, 20, 40 over the same 32,400
           points (stripe_partition, path graph, true hyperparameters,
           float32, streamed means): rbcm, nn_rbcm, npae and npae_star at
           FleetConfig's iteration counts on four 256-query tiles each.
           It reports batch ms, q/s, RMSE over the FULL-GP's, CBNN agents
           per query, the final DAC / JOR residuals, rbcm's DAC
           trajectory from the engine's diagnostics mode and the sweeps
           dac_until needs to reach 1e-9 on a tile's payloads (float64).
           It checks the RMSE of rbcm, nn_rbcm and cen_npae, rbf_matvec
           launched once per tile and held to its plain version on the
           fleet's own inputs, each DAC method against its centralized
           form within the rounding bound (DAC_ROUND at M), every agent's
           own DAC estimate within M times its query's final spread (the
           reported residual recomputed), npae and npae_star within their
           residual bounds of cen_npae, and that diagnostics change no
           prediction.
  methods  CBNN, grBCM and dense NPAE (the paper's Alg. 9-18): the same
           paper fleet at the true hyperparameters, float32, streamed
           means, with the grBCM communication dataset (8,100 points drawn
           from the agents) and the augmented experts (4 x 16,200 points)
           fitted beside the base experts. It serves grbcm, npae,
           npae_star (from a fleet of its own with NPAE_STAR_JOR_ITERS JOR
           iterations, C8), the six nn_* methods, cen_grbcm and cen_npae
           on four 256-query tiles each through GPFleet.predict and
           reports q/s, batch ms, RMSE, the final DAC / JOR / DALE
           residuals, agents per query under CBNN, rbf_matvec launches per
           batch (checked: one per expert set per tile) and peak memory.
           It checks the RMSE; each DAC-family method against its
           centralized form with the same mask within the DAC rounding
           bound (DAC_ROUND); npae, npae_star and nn_npae against the
           centralized NPAE solve within a bound from their reported
           residuals (NPAE_ROUND; the bound's smallest and median value
           reported); one tile of every method against the same port in
           float64 on the card (F32_MEAN_TOL, F32_VAR_TOL; npae_star
           within both runs' residual bounds where they are larger); that
           cache_cross raises at the default 1,024 MB guard and, with the
           limit raised, serves npae as without the cache. Then gapx and
           dec-gapx train for 3 iterations each on the augmented data
           (nll_grad at N = 16,200, one launch per iteration; finite
           thetas checked), and the sparse m = 512 fleet (float64 data)
           fits its augmented and communication experts through rbf_gram
           and serves grbcm and nn_rbcm.
  train    the training path: the same fleet trained from the paper's
           theta0 with DEC-apx-GP (rho 500, kappa 10,000, 100 iterations,
           float32) by GPFleet.fit(train=True, trace=TraceRecorder()),
           then serving 4,096 queries. It checks nll_grad launched once
           per iteration for the whole fleet, the trace's 100 iterations
           (its summary reported), that GPFleet.metrics() and the
           Prometheus text parse back to the same counters, that the
           summed NLL fell, the RMSE against the field, that 10 iterations
           with the trace's diagnostics give the same theta as without
           (ms per iteration of both reported), that 10 float64
           iterations with the kernel agree
           with 10 iterations with its plain version swapped in through
           the grad_fn hook, and in float32 within float32's own distance
           from float64; it reports the distance from the true theta and
           each float32 trajectory's deviation from float64, and
           the residuals of 20 float64 iterations at the paper's kappa =
           5,000, which does not converge at this size (see TRAIN_KAPPA).
  online   the streaming path: the same fleet as sliding windows
           (FleetConfig(online=True, window=8,100), one full window per
           agent) fitted at the true hyperparameters, then 128 fleet-wide
           GPFleet.observe rounds of points from the same field (each an
           eviction through cholupdate, an append and alpha), one
           256-query rBCM micro-batch served after every 4 rounds, then
           GPFleet.drift(iters=5) (DEC-apx-GP on the live windows through
           nll_grad), a join of one agent with 8,100 points and the leave
           of agent 1 (interior node of the path), and serving again. It
           checks one cholupdate launch per round, the streamed factors,
           alpha and served means against a float32 refit and a float64
           refit of the same windows (see F32_FACTOR), the RMSE against the
           field, nll_grad launched once per drift iteration, that the
           engine object and adjacency survive the stream (factors swapped,
           not rebuilt), and the fleet after join/leave against a fresh
           fleet on the same windows and graph.
  sparse   sparse pseudo-representation experts (FleetConfig(sparse_m=
           512)), in three parts. serve: the paper fleet fitted at the
           true hyperparameters (the Kmn statistics through rbf_gram, one
           launch per 4,096-column panel for the whole fleet), serving 8
           rBCM micro-batches of 256 queries and the 4,096-query call, and
           npae_sparse on 4,096 queries. train: DEC-apx-GP with the
           collapsed-bound gradient (100 iterations, kappa 10,000) and
           fact-sparse (200 Adam steps over theta and Z), each then served.
           scale: the reference's 100k-per-agent fleet (4 x 100,000 points
           of the same field, m = 512), fitted and served by npae_sparse
           and rBCM at 256 queries. The runs carry float64 data, with the
           kernels computing in float32; the 100k fleet is first fitted in
           float32 and reported without a gate (see SPARSE_F32). It checks
           the rbf_gram launches of each fit (ceil(Ni / 4,096)), the
           streamed means of the served queries against the float64 plain
           path, the RMSE against the field, and reports the factors'
           bytes against the dense factors'.
  persist  GPFleet.save then GPFleet.load in the same process, one kind at
           a time into a directory of the checkout deleted before the
           next: the serve phase's dense fleet, the online phase's windows
           (with count and jitter), the 4 x 100,000 sparse fleet and the
           methods phase's grBCM fleet. It checks that the loaded fleet's
           predictions (rbf_matvec launched once per tile) are bitwise the
           saved fleet's, and for the online fleet that one observe round
           (one cholupdate launch) leaves both states bitwise equal; it
           reports save ms, load ms and bytes on disk.
  chaos    degraded-mode consensus: the serve phase's fleet (rbcm's
           M = 4 path, 200 DAC sweeps, float32, streamed means) serves poe,
           gpoe, bcm, rbcm, nn_rbcm, npae, npae_star and nn_npae on four
           256-query tiles per fault plan through GPFleet.predict(
           fault_plan=, allow_degraded=True). It checks that a consensus-
           free plan (straggle_every=2, fail_every=5) gives the exact
           result bit for bit; Dropout(0) (3 alive, 1 excluded),
           Dropout(1) (the path splits: {2, 3} served, 2 components) and
           nan_agents=(2,) (1 scrubbed) each DAC method within the DAC
           rounding bound of its centralized form over the surviving
           agents, and the NPAE family within its residual bound of the
           centralized NPAE solve over the same agents; a mid-run Dropout(3, at=50, until=150) with
           edge_loss=0.2 finite, under degraded_tol and below the RMSE
           gate (its distance from the exact result reported); no method
           refused (ConsensusDiverged) under any of these plans; rbf_matvec
           once per tile and expert set under every plan; every plan
           that drops all agents raising ConsensusDiverged, cen_* a
           ValueError, and FleetDegraded without allow_degraded;
           health()'s census and totals; a degraded float32 tile against
           the port in float64 (F32_MEAN_TOL); and on the M = 10 fleet
           that Dropout(0) either raises ConsensusDiverged or serves
           under degraded_tol (which one is reported). Degraded and exact
           batch ms are reported side by side.
  frontdoor the serving front door (launch.scheduler): tenants rbcm
           (slots 256, 512, 1,024) and npae (256) of the paper fleet on
           one ServingScheduler. It checks 24 ragged requests of 1-700
           rows against GPFleet.predict on each request's rows
           (F32_MEAN_TOL), rbf_matvec once per dispatched rbcm tile, the
           tenant-labelled counters read back from GET /metrics of
           --metrics-port's server, and that no tenant meets a new
           geometry after warm-up in any stage; it runs an open-loop
           Poisson load for 5 s (rbcm 30, npae 5 requests/s) and a
           closed-loop burst of 64 rbcm requests, reporting q/s, p50 /
           p95 / p99 latency, padding and engine seconds; it injects
           fail_every=5 (retried equals injected, answers as without),
           straggle_every=7 of 50 ms under a 25 ms watchdog (the
           straggled requests fail with SchedulerStalled, the tenant
           recovers) and a Dropout(0) tenant (every dispatch counted
           degraded, answers the degraded GPFleet.predict's); and it runs
           serve_gp.main(--scheduler --loadgen 30 --duration 2
           --fault-dropout 0 --fault-fail-every 5) at the paper size.
  scenario the closed-loop mission (repro_torch.scenario): the reference's
           "mission" (6 agents, gpoe, 24 steps, drift every 6; float32)
           and "chaos" (5 agents, dropout of agent 1 over steps 4-10,
           edge_loss 0.05, stragglers, fail_every 7, 5 s deadlines;
           float64) presets at full width (SCENARIO_WIDTH: 8,100-point
           windows full from the first step, 200 DAC sweeps, kappa
           10,000, 4 requests of 256 rows a step, 1,024 eval points),
           each run twice through run_scenario on the card. It checks the
           replay digests equal, no hung or failed request and completed
           + dropped = submitted, the chaos membership timeline [(4,
           leave, 1), (10, rejoin, 1)] with recompiles at those steps
           only and none on the clean mission, finite curves with the
           final RMSE below RMSE_LIMIT and below the first, and the
           launches of each run (counts reset just before it): cholupdate
           once per observe round, nll_grad once per ADMM iteration of the
           fit and the drift epochs, rbf_matvec once per query tile the
           engine served. It reports per-step ms, observations/s, queries/
           s of the dispatches, p50/p99 and each drift epoch's ms. Then
           the smoke preset in float64 on the card against the CPU, one
           host-drawn world (SCENARIO_TWIN_TOL).
  sharded  the agent-sharded fleet (ShardedEngine on launch.mesh's agent
           meshes): the methods phase's paper fleet (M = 4, float32,
           streamed means, with the grBCM experts) on make_agent_mesh(4)
           (one member on one card) and on four members of the card, every
           DAC-family method on four 256-query tiles, DAC and exact
           consensus, against the replicated engine within the two
           engines' rounding bounds, the exact runs also against their
           members' payloads summed in float64 within a few float32 ulps
           (exact_sum_ulps), CBNN masks equal, rbf_matvec once per
           tile per member and expert set, and on four members the routed nn_* methods
           against the full output on the queries whose participants are
           member-local; the M = 40 fleet (Ni = 810) on four members; the
           m = 512 sparse fleet (float64 data) fitted on four members
           (rbf_gram once per panel) and serving npae_sparse against the
           replicated engine (SHARDED_NPAE_TOL); and the dec-apx-sharded
           trainer through GPFleet.fit on four members (kappa 10,000, 20
           iterations, nll_grad once per member per iteration) against the
           simulated trainer on cycle_graph(4) (SHARDED_TRAIN_TOL). It
           reports batch ms and q/s beside the replicated engine's.
  lm       LM serving: internlm2-1.8b at its published widths and depth
           (24 layers, d 2,048, 16 query / 8 KV heads, vocab 92,544,
           1.89 B float32 parameters drawn from the seed) through the
           port's serve launcher: batched prefill of 4 prompts of 2,048
           tokens, then 32 greedy decode steps. It checks flash_attention
           launched once per layer in the prefill and never in decode,
           the prefill logits against the same model with the kernel's
           plain version swapped in (LM_LOGIT_TOL), the greedy tokens
           equal to that run's wherever its top-2 logit gap exceeds the
           tolerance, and prefill + one decode step against the parallel
           forward over 2,049 tokens; it reports prefill ms, decode ms per
           step, tok/s, peak device memory and the first tokens. Then the
           same model placed on make_test_mesh(1, 1) (cuda:0) by its
           parameters' specs (launch/sharding.py) runs one prefill under
           use_mesh with constrain live: its logits bit for bit the
           unplaced prefill's, its kernel launches counted under the path
           lm:mesh.
  lm_train LM training (after the profile phase, whose LM it frees):
           internlm2-1.8b at full width through the port's train launcher
           (launch.train.run) at the reference's train_4k shape, 4,096
           tokens a sequence with remat, the batch of 256 cut to 2: (a) 3
           Adam steps (lr 1e-4), checking finite losses and flash_attention
           launched 2 x 24 times a step (forward and recompute), reporting
           ms per step, tokens/s and peak memory; (b) one gradient with the
           kernel and one with its plain version swapped in, every
           parameter tensor within LM_GRAD_TOL and the loss within
           LM_LOGIT_TOL; the kernel's launch with and without its
           log-sum-exp and the ported backward timed at one layer's
           attention, with their share of a step; (c) the paper's DEC-ADMM
           (--consensus dec_admm) over two agents on the card at full
           depth, 2 steps, reporting losses and disagreement; (d) the
           reduced internlm2 under DEC-ADMM over 4 agents and under
           Adafactor, 3 steps each on the card and on the CPU from one set
           of parameters and one batch stream, held to each other
           (LM_TWIN_LOSS_TOL, LM_TWIN_PARAM_TOL). With --profile it traces
           one training step.
  lm_families the other LM families (each model freed before the
           next) through the serve launcher at their published widths
           (LM_FAMILIES): dbrx-132b (MoE, 16 experts top-4; 4 of 40
           layers), jamba-v0.1-52b (one superblock of 8 layers: attention,
           4 mamba + MoE, 3 mamba) and internvl2-76b (8 of 80 layers, 256
           patch embeddings before the prompt) in bf16 with B 2 x 2,048
           stream tokens and 16 greedy steps, and whisper-small whole in
           float32 (4 x 1,500 frames, a 2,048-token prompt, 32 steps). It
           checks flash_attention launched once per attention product of
           the prefill (whisper: 12 encoder, 12 self and 12 cross) and, for
           whisper only, once per decoder layer a decode step (the
           cross-attention at Sq 1), the prefill logits against the same
           model with the plain attention and prefill + one decode step
           against the parallel forward (LM_FAMILY_TOL, per dtype; the MoE
           layers drop-free for that check), finite logits and the greedy
           tokens as the lm phase does; it reports prefill ms, decode ms
           per step, tok/s and peak memory (with --profile a traced dbrx
           and jamba prefill). xlstm-350m is served whole in float32 (4 x
           2,048 tokens, 32 steps) with its flash_attention launches
           gated at 0 (it runs no attention, and is no path of the
           kernel), prefill + one decode step against the parallel
           forward and the chunked mLSTM against mlstm_sequential on its
           first layer's own inputs (XLSTM_CHUNK_TOL). At whisper's worst
           paired call the kernel and the plain version also run on v
           centered over the keys (C14). Then the reduced families (with
           llama4-maverick; jamba at 4 layers; xlstm) in float32 on the
           card against the CPU, one Adam step of whisper-small at full
           size (train_4k: 2 x 4,096 tokens) whose gradient is held to the
           plain attention's (WHISPER_GRAD_TOL), and one Adam step of
           xlstm-350m at train_4k (2 x 4,096 tokens, remat).
  dryrun   the pod dry run (launch/dryrun.py, last): every arch x
           supported shape on the 16 x 16 and 2 x 16 x 16 production
           meshes under the default and dp policies, 39 meta steps traced
           in DRYRUN_JOBS spawned host processes and 156 records, each
           ok (whisper-small's long_500k skipped); it reports the
           per-device GiB and FLOPs of the train_4k rows. Host only by
           design: a pod that one card cannot be.

The kernels phase also holds flash_attention to its plain version at the
prefill shape (4, 16/8, 2,048, 128, causal; timed, with PyTorch's
scaled_dot_product_attention as the library yardstick, which the port
never calls), a sliding window of 512 whose first key blocks are wholly
masked for the late queries, bf16, ragged S = 1,000, the decode shape
(Sq 1, Sk 2,081), D = 64 and D = 32, the edges of the kernel's 128-row
query blocks and 64-key tiles, and the LM families' modes (whisper's
non-causal encoder and its cross-attention at Sq 2,048 > Sk 1,500 and
at Sq 1, dbrx's GQA 6 in bf16), each bitwise repeatable; at each
case its log-sum-exp output against the plain logsumexp, and the
gradients of FlashAttentionFunction (the kernel forward, the ported
chunked backward) against autograd through the plain version. rbf_gram's
sparse-fit panel is traced for its device time.

With --profile it then traces one 256-query batch of the serving path
and the serving path's dense fit, one ADMM iteration of the training
path, one observe round and one served batch of the streaming fleet, one
sparse fit of the 100k-per-agent fleet, one served rBCM batch of the
sparse paper fleet, one npae, nn_npae and grbcm tile of the methods
phase's fleet, and one LM prefill and one decode step with
torch.profiler, and prints device time by kernel, the GEMMs' share and
the device's busy share; the lm_train phase then traces one full training
step, and the lm_families phase one dbrx and one jamba prefill.

Then it prints the kernel table as one JSON object, the card's name and
power limit as nvidia-smi reports them, and last
{"ok": true, "device": {...}}. It exits non-zero, before printing any
result, without a CUDA device or without the port's sources beside it,
and non-zero after any failed phase.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

DEVICE = "cuda"                 # every phase runs on the card
ROOT = Path(__file__).resolve().parent

# H100 SXM figures for the lower bounds (bound_ms):
HBM_BYTES_PER_S = 3.35e12       # NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12        # NVIDIA data sheet, outside the tensor cores
TF32_TC_FLOPS_PER_S = 495e12    # NVIDIA data sheet, dense TF32 tensor cores
# exp2 on the special-function units: 16 results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) at the 1,980 MHz maximum SM clock
SFU_EXP_PER_CLOCK_PER_SM = 16
SM_CLOCK_HZ = 1.98e9

TRUE_THETA = ([1.2, 0.3], 1.3, 0.1)   # paper §6: (l1, l2, sigma_f, sigma_eps)
N_TRAIN = 32_400                      # paper §6 (configs/paper_gp.py)
BATCH, N_BATCHES, BIG = 256, 8, 4096
REL_TOL = 1e-5                        # relative to the sum of |terms|
RMSE_LIMIT = 0.2                      # twice sigma_eps
# rbf_matvec (Nt, M, Ni, D): the serving tile first, then ragged and edge
# shapes
RBF_MATVEC_SHAPES = [(256, 4, 8100, 2), (200, 4, 8100, 2), (131, 4, 8099, 2),
                     (256, 4, 1013, 1), (97, 3, 777, 3), (256, 2, 555, 8),
                     (256, 40, 810, 2), (256, 1, 8100, 2), (256, 4, 16200, 2),
                     (256, 10, 3240, 2), (256, 20, 1620, 2)]
# the grBCM tiles of the methods phase and the tiles of the fleets phase
# (the paper's M = 10, 20, 40 over the same 32,400 points), timed and
# traced like the serve tile: the communication expert (M = 1), the
# augmented experts, and the three larger fleets
GRBCM_TILES = ((256, 1, 8100, 2), (256, 4, 16200, 2))
FLEET_TILES = ((256, 10, 3240, 2), (256, 20, 1620, 2), (256, 40, 810, 2))
RBF_MATVEC_REPEATS = 20               # calls held bitwise to the first
RBF_MATVEC_TRACED = 50                # back-to-back calls in one trace
# nll_grad (M, N, D) after the training shape: ragged N, other D, and the
# paper's largest fleet (M = 40 agents of 810 points)
NLL_GRAD_EDGE_SHAPES = [(4, 8099, 2), (4, 131, 2), (4, 1, 2), (4, 1013, 1),
                        (3, 777, 3), (2, 555, 8), (40, 810, 2),
                        (4, 16200, 2), (4, 16199, 2)]
# gapx / dec-gapx's shape (the augmented data, 2 x 8,100 points per agent:
# d2u 2.1e9 elements, just under 2^31), timed like the training shape
NLL_GRAD_AUG = (4, 16200, 2)
# cholupdate (M, n) at random factors after the paper-fleet cases
CHOLUPDATE_EDGE_SHAPES = [(3, 777), (4, 131), (4, 1)]
CHOLUPDATE_REPEATS = 20               # evictions held bitwise to the first
CHOLUPDATE_SELFCHECK_DIVS = 1 << 32   # random divisions held to __fdiv_rn
PROFILE_PAD = 8                       # spin kernels that open each trace
# assumed least latency of one column of the rotation chain: a correctly
# rounded sqrt and a division on the dependent path, each at least a MUFU
# approximation and a fused multiply-add refinement (about 20 cycles),
# against 4-cycle FMAs; not a data-sheet figure, so it is only reported
CHAIN_CYCLES_PER_COLUMN = 40
WINDOW = 8_100                        # one window per agent at the paper's Ni
STREAM_ROUNDS = 128                   # fleet-wide observe rounds
SERVE_EVERY = 4                       # rounds between served micro-batches
DRIFT_ITERS = 5
# The streamed factors, alpha and served means are held to a float64 refit
# of the same windows: each may be at most F32_FACTOR times as far from it
# as a float32 refit is. A float32 Cholesky of these windows is itself
# off by about cond(C) * eps (the phase reports both distances), and the
# stream's 128 rank-1 updates and appends are backward stable, so they may
# not add more than float32's own error again.
F32_FACTOR = 2.0
# DEC-apx-GP's proximal weight in the train phase. The paper's kappa =
# 5,000 (FleetConfig's default) does not converge at Ni = 8,100, in float32
# or float64: eq. 34 is a gradient step of 1 / (kappa + 2 rho deg), 1/6,000
# at the path's ends, against an NLL curvature along log sigma_eps of
# about 2 Ni = 16,200, so sigma_eps overshoots and the agents oscillate.
# Theorem 1 asks kappa to grow with the local gradient's Lipschitz
# constant, which grows with Ni. The phase reports the kappa = 5,000 run
# without gating on it and trains with kappa = 10,000.
TRAIN_KAPPA = 10_000.0
PAPER_KAPPA_ITERS = 20                # float64 iterations at kappa = 5,000
CHECK_ITERS = 10                      # ADMM iterations held kernel vs plain
# kernel vs plain thetas after CHECK_ITERS iterations, in log theta, with
# the iterations in float64: there the kernel is the only float32 step (the
# op casts its operands, as the reference's Pallas path does), so the two
# trajectories differ by the kernel's float32 sums alone. Those stay within
# REL_TOL of the summed |terms| (the kernels phase), a few 1e-3 absolute at
# theta0; as sigma_eps falls, inner ~ C^-1 grows like 1 / sigma_eps^2 and
# the rounding with it, and eq. 34 divides the gradient difference by
# kappa + 2 rho deg >= 11,000. So a step moves the trajectories apart by
# 1e-6 to a few 1e-6, and ten steps of a converging iteration stay inside
# 1e-4. In float32 every step of the iteration rounds, and at cond(C) ~ 1e6
# a difference of one rounding anywhere decorrelates the Cholesky's
# rounding errors: two float32 trajectories then drift apart by up to
# float32's own error. So the float32 kernel and plain trajectories are
# held to within the float32 plain trajectory's distance from float64:
# the kernel may move theta no further than float32 arithmetic itself.
THETA_TOL = 1e-4
# rbf_gram (M, m, N, D, col0, width, with_noise): the sparse fit's panel
# (the paper fleet's m = 512 inducing points against a 4,096-column panel),
# the tail panel of the 100k-per-agent fleet (100,000 = 24 x 4,096 + 1,696:
# 1,696 valid columns, the rest exactly 0), a square panel with the noise
# on its diagonal, and edge shapes
KMN_PANEL = 4096                      # columns per kmn_stats panel
RBF_GRAM_CASES = [(4, 512, 8100, 2, 0, KMN_PANEL, False),
                  (4, 512, 100_000, 2, 24 * KMN_PANEL, KMN_PANEL, False),
                  (1, 1013, 1013, 2, 0, 1013, True),
                  (3, 97, 777, 3, 0, 777, False),
                  (2, 64, 555, 8, 0, 555, False),
                  (4, 1, 7, 2, 0, 7, False)]
RBF_GRAM_TOL = 1e-5                   # max |error| relative to sigma_f^2
SPARSE_M = 512                        # inducing points per agent
# the reference's large sparse fleet (benchmarks/bench_prediction.py
# :342-344, big_ni=100_000, big_m=512, big_agents=4)
BIG_NI = 100_000
SCALE_QUERIES = 256
FIELD_CHUNK = 50_000                  # points per RFF field evaluation
# SPARSE_F32: the 100k-per-agent fleet is fitted once in float32 and the
# outcome reported, without a gate. At m = 512 inducing points per stripe
# the Kmm Cholesky fails in float32 at the reference's jitter floor
# (8 eps(float32) sigma_f^2 = 1.6e-6, below the rounding of a 512-point
# Cholesky of near-duplicate points), in the JAX package as in the port
# (on a CPU, both packages give NaN factors for this fleet), and so it
# does for the paper fleet at m = 512. The gated runs carry float64 data:
# the rbf_gram kernel still computes in float32, and the products and the
# m x m algebra run in float64, what the reference does under x64.
# LM serving (lm phase): the smallest LM configuration of the repo that
# runs flash_attention at full width (head_dim 128), served at its
# published widths and depth in float32, as the reference initializes it
LM_ARCH = "internlm2-1.8b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
# kernel vs plain-attention prefill logits, and prefill + decode vs the
# parallel forward, max |error| relative to max |logit|: the kernel's
# float32 attention differs from the plain version's by rounding (about
# 1e-6 of its output, FLASH_TOL below), which 24 layers of float32 GEMMs
# carry to the logits; decode runs other GEMM shapes and the plain
# decode attention
LM_LOGIT_TOL = 1e-4
BF16_TC_FLOPS_PER_S = 989e12          # NVIDIA data sheet, dense tensor cores
# flash_attention (B, H, KH, Sq, Sk, D, causal, window, dtype): the
# prefill shape first (timed), a sliding window whose first key blocks
# are wholly masked for the late queries, bf16 at the prefill shape
# (timed), ragged S, the decode shape, D = 64 and D = 32; then the edges
# of the 128-row query block and 64-key tile: S of 127, 128, 129 and 191,
# Sk - Sq not a multiple of the key tile, a window that masks whole
# leading key tiles of a block, bf16 at D = 128 (its dropped passes); then
# the LM families' modes: whisper's cross-attention (Sq 2,048 > Sk 1,500,
# no mask) and encoder (MHA, D 64, non-causal), dbrx's GQA 6 in bf16, and
# a whisper decode step's cross-attention (Sq 1 against 1,500 frames)
FLASH_CASES = [(4, 16, 8, 2048, 2048, 128, True, None, "float32"),
               (1, 16, 8, 2048, 2048, 128, True, 512, "float32"),
               (4, 16, 8, 2048, 2048, 128, True, None, "bfloat16"),
               (1, 16, 8, 1000, 1000, 128, True, None, "float32"),
               (4, 16, 8, 1, 2081, 128, True, None, "float32"),
               (2, 16, 8, 1024, 1024, 64, True, None, "float32"),
               (2, 16, 8, 777, 777, 32, True, 100, "float32"),
               (1, 4, 2, 127, 127, 128, True, None, "float32"),
               (1, 4, 2, 128, 128, 128, True, None, "float32"),
               (1, 4, 2, 129, 129, 128, True, None, "float32"),
               (1, 4, 2, 191, 191, 64, False, None, "float32"),
               (1, 4, 2, 129, 300, 64, True, None, "float32"),
               (1, 4, 2, 640, 640, 128, True, 100, "float32"),
               (1, 8, 2, 300, 300, 128, True, None, "bfloat16"),
               (2, 12, 12, 2048, 1500, 64, False, None, "float32"),
               (2, 12, 12, 1500, 1500, 64, False, None, "float32"),
               (2, 48, 8, 2048, 2048, 128, True, None, "bfloat16"),
               (2, 12, 12, 1, 1500, 64, False, None, "float32")]
# max |kernel - plain| relative to max |plain output|: float32 sums in
# another order (the tolerance the reference's tests hold its Pallas
# kernel to), bf16 outputs rounded to 8 bits
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the kernel's log-sum-exp against the plain logsumexp, max |error| / (1 +
# |lse|): float32 sums of the same scores in another order
FLASH_LSE_TOL = 1e-5
# dq, dk, dv of FlashAttentionFunction (the kernel forward, the ported
# backward) against autograd through the plain version, max |error|
# relative to max |plain gradient|: one backward's float32 rounding fed
# the kernel's out and lse, or bf16 gradients rounded to 8 bits
FLASH_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# LM training (lm_train phase): internlm2-1.8b at its published widths and
# depth through the port's train launcher at the reference's train_4k
# shape (4,096 tokens a sequence, remat), its batch of 256 cut to 2 so that
# one card holds the step, Adam at pick_optimizer's default lr
LM_TRAIN_BATCH, LM_TRAIN_STEPS, LM_TRAIN_LR = 2, 3, 1e-4
LM_TRAIN_ARGS = ["--arch", LM_ARCH, "--shape", "train_4k", "--batch",
                 str(LM_TRAIN_BATCH), "--lr", str(LM_TRAIN_LR),
                 "--log-every", "1"]
# the paper's DEC-ADMM over two agents on the card (rho and kappa the
# launcher's defaults: 0.1 and 1 / lr)
LM_FED_AGENTS, LM_FED_STEPS = 2, 2
# the full-width gradient with the kernel against the same step with the
# plain version swapped in, per parameter tensor max |error| / max |plain
# gradient|: the kernel's float32 attention (split TF32, ex2.approx: about
# 1e-6 of its output) carried through 24 layers and their recompute. A CPU
# rehearsal with the kernel's arithmetic emulated
# (flash_attention_split_tf32) at 24 layers, d 256, 4,096 tokens gave
# 3.5e-6 at worst (wk); the card at full width gives 7.3e-5 (wq), and
# tools/lm_grad_witness.py puts the kernel path 8.8e-5 and the plain path
# 3.1e-5 from float64 (PERF.md §6). The gate is four times the
# card's reading, below the 5.2e-4 that the reference's delta = dout . out
# gives with this kernel forward
LM_GRAD_TOL = 3e-4
# the reduced internlm2 (2 layers, d 256) card against CPU, from one set
# of initial parameters and one numpy batch stream: DEC-ADMM over 4
# agents and Adafactor, 3 steps each
LM_TWIN_AGENTS, LM_TWIN_STEPS, LM_TWIN_BATCH, LM_TWIN_SEQ = 4, 3, 2, 128
LM_TWIN_LR = 3e-3                     # the reference launcher's default
LM_TWIN_LOSS_TOL = 1e-5               # relative, every step
LM_TWIN_PARAM_TOL = 1e-5              # DEC-ADMM, relative to max |theta|
# one attention layer of the training step (B, H, KH, S, S, D), timed
LM_TRAIN_ATTENTION = (2, 16, 8, 4096, 4096, 128)

# LM families (lm_families phase): (arch, layers run or None for all,
# dtype, batch, prompt tokens, generated tokens), each at its published
# widths through the serve launcher, the depth cut only where one 80 GB
# card forces it (parameters from the reference's param_defs: dbrx 4 of 40
# layers 14.27 B, 28.5 GB bf16; jamba one superblock, 8 of 32 layers
# (attention, 4 mamba + MoE, 3 mamba) 12.77 B, 25.5 GB; internvl2 8 of 80
# 8.95 B, 17.9 GB, its 256 patch embeddings before 1,792 prompt tokens;
# whisper-small whole, 0.311 B float32, 1,500 frames and a 2,048-token
# prompt, so its cross-attention runs Sq > Sk)
LM_FAMILIES = [("dbrx-132b", 4, "bfloat16", 2, 2048, 16),
               ("jamba-v0.1-52b", 8, "bfloat16", 2, 2048, 16),
               ("internvl2-76b", 8, "bfloat16", 2, 1792, 16),
               ("whisper-small", None, "float32", 4, 2048, 32),
               ("xlstm-350m", None, "float32", 4, 2048, 32)]
# families that run no attention: served and gated like the others, their
# flash_attention launches gated at 0 and kept out of the kernel's paths
NO_ATTENTION = ("xlstm-350m",)
# the chunked mLSTM (8 chunks of 256) against mlstm_sequential (2,048
# steps) on the first mLSTM layer's own q, k, v and gates of the xlstm
# prompt, h and the final (C, n, m) each relative to its max |value|:
# float32 sums in two orders over 2,048 tokens; on the CPU at these widths
# (tools/xlstm_witness.py --parts layer) 7.7e-6 for h and 1.3e-5 for m,
# on the card 1.8e-5 for h, and the gate is about five times that
XLSTM_CHUNK_TOL = 1e-4
# xlstm-350m's prefill + decode against the parallel forward, max |error|
# relative to max |logit|. At its initial weights the model amplifies
# float32 rounding about 1e4-fold over its 24 blocks (the residual stream
# grows from 48 to 217 in max |x|, and the mLSTM's h divides by its
# normalizer): on the CPU (tools/xlstm_witness.py --parts model,reference)
# prefill + decode reads 4.5e-3, the parallel forward with its embedding
# scaled by one float32 ulp 4.0e-3, and the JAX package's forward on the
# same weights 4.4e-3 from the port's. LM_LOGIT_TOL (1e-4) sits below
# that floor; the card read 6.4e-3, and the gate is about five times it
# (ROADMAP C16). The ulp probe runs on the card too and is reported
XLSTM_LOGIT_TOL = 3e-2
# prefill logits through the kernel against the plain attention, and
# prefill + decode against the parallel forward, max |error| relative to
# max |logit|. float32: LM_LOGIT_TOL's reasoning. bf16: both attentions
# compute in float32 and round to bf16, so their outputs differ by one bf16
# ulp (2^-8 relative) wherever the two float32 results straddle a rounding
# boundary, and every bf16 GEMM after them rounds again (decode also runs
# other GEMM shapes than the parallel forward); 4-8 layers carry that to
# the bf16 logits, whose own ulp is 3.9e-3 of max |logit|. The gate is
# about 8 of those ulps
LM_FAMILY_TOL = {"float32": LM_LOGIT_TOL, "bfloat16": 3e-2}
# the kernel against its plain version on each attention call of a served
# run, max |error| relative to max |v| (_PairedAttention). bf16: outputs
# rounded to 8 bits (FLASH_TOL). float32: the tensor cores' float32
# accumulation of p v over up to 2,048 keys rounds in units of the running
# sums, which a common component of v's rows (the model's, not FLASH_CASES'
# zero-mean random v) makes far larger than the output's spread. Measured
# apart at whisper-small's worst call, its decoder's causal self-attention
# (ROADMAP C14; centered_attention_check): 2.42e-5 on v, and with v
# centered over the keys the kernel's out(v - c) + c is 2.2e-6 from the
# plain out(v) (4.4e-7 from the plain out(v - c)), so the error follows
# v's common component. That centered check is gated at FLASH_TOL; the
# gate here is about four times the uncentered reading
PAIRED_TOL = {"float32": 1e-4, "bfloat16": FLASH_TOL["bfloat16"]}
# the reduced twins (float32, jamba at 4 layers so that both mamba kinds
# run), card against CPU from one set of weights and inputs: prefill and
# every decode step's logits, relative to max |logit| (LM_LOGIT_TOL)
LM_FAMILY_TWINS = ("dbrx-132b", "llama4-maverick-400b-a17b",
                   "jamba-v0.1-52b", "internvl2-76b", "whisper-small",
                   "xlstm-350m")
LM_FAMILY_TWIN_GEN = 8
# one Adam step of whisper-small at full size: train_4k's 4,096 decoder
# tokens, its batch of 256 cut to 2 (the reference's encoder-decoder reads
# no remat)
WHISPER_TRAIN_ARGS = ["--arch", "whisper-small", "--shape", "train_4k",
                      "--batch", "2", "--lr", "1e-4", "--steps", "1"]
# one Adam step of xlstm-350m at full width: train_4k's 4,096 tokens with
# remat, its batch of 256 cut to 2 (the sLSTM a Python loop over the 4,096
# steps, forward, recompute and backward)
XLSTM_TRAIN_ARGS = ["--arch", "xlstm-350m", "--shape", "train_4k",
                    "--batch", "2", "--lr", "1e-4", "--steps", "1"]
# the dry run (dryrun phase): every arch x supported shape on both
# production meshes under both policies, the 39 meta steps traced in
# DRYRUN_JOBS spawned host processes
DRYRUN_JOBS = 7
# its gradient with the kernel against the plain attention's, per
# parameter tensor max |error| / max |plain gradient|. The cross-attention's
# wq and wk (and ln_x before it) get sums over 1,500 near-uniform weights
# (scaled scores below 2) of frames with a common component: the
# cancellation LM_GRAD_TOL's comment describes, deeper here. The card read
# 2.7e-3 (cross_attn.wk) with the row-normalized backward (PR 25's first
# runs; tools/lm_grad_witness.py --arch whisper-small sets each path
# against float64); the gate is about four times that
WHISPER_GRAD_TOL = 1e-2


# methods phase: CBNN, grBCM and dense NPAE on the paper fleet (float32,
# streamed means), each method on METHOD_TILES query tiles of BATCH
NEW_METHODS = ("grbcm", "npae", "npae_star", "nn_poe", "nn_gpoe", "nn_bcm",
               "nn_rbcm", "nn_grbcm", "nn_npae", "cen_grbcm", "cen_npae")
METHOD_TILES = 4
# rbf_matvec launches per query tile with stream_mean: one per expert set
# whose moments a method takes (the grbcm methods: the augmented experts
# and the communication expert); the NPAE terms take k^T alpha densely, as
# the reference's npae_terms_cached does
MATVEC_PER_TILE = {"grbcm": 2, "nn_grbcm": 2, "cen_grbcm": 2, "rbcm": 1,
                   "poe": 1, "gpoe": 1, "bcm": 1, "nn_poe": 1,
                   "nn_gpoe": 1, "nn_bcm": 1, "nn_rbcm": 1, "npae": 0,
                   "npae_star": 0, "nn_npae": 0, "cen_npae": 0}
UNIT = 2.0 ** -24                     # float32 unit roundoff
# A DAC-family method against its centralized form with the same mask. Both
# assemble the posterior from the same per-agent payloads w_i; DAC's sums
# are M x the network mean after `dac_iters` sweeps of w <- P w with a
# doubly stochastic P, which keeps the mean exactly in exact arithmetic.
# In float32 each sweep rounds every entry by at most 2 u |w|max, so the
# sums drift by at most DAC_ROUND = 2 dac_iters u M (sum_i |w_i|): the gate
# compares the posterior's precision 1/var and precision-weighted mean
# mean/var, query by query, against that bound over their payloads.
DAC_ROUND = 2 * 200 * 4 * UNIT
# The NPAE family against cen_npae (and nn_npae against
# aggregation.npae(mask=)): JOR / DALE stop after jor_iters / dale_iters
# with a final residual r_t = max |q^(s+1) - q^s| per query (the tile's
# largest is the one the engine reports; the gate recomputes them with the
# port's jor / dale on the tile's own systems and checks that the largest
# is the reported one). For an affine iteration q' = c + G q with I - G
# invertible, the error of the last iterate is (I - G)^-1 (q^(s+1) - q^s),
# so |q - q*| <= kappa_t r_t with kappa_t = ||(I - G)^-1||_inf of the
# query's own system (JOR: I - G = omega D^-1 H; DALE: its M^2 x M^2
# operator). Float32 rounding of every step, the Cholesky of the
# centralized solve and the two jitters' difference (4.6e-8 of the
# diagonal) add at most NPAE_ROUND u |q|max to r_t. The gate:
# |mean - mean_cen| and |var - var_cen| <= sum_i |k_A,i| kappa_t (r_t +
# NPAE_ROUND u |q|max) + the DAC rounding of sum_i k_A,i q_i.
NPAE_ROUND = 16
# Each method's first tile against the same port in float64 on the card:
# within a tenth of the measurement noise's standard deviation (sigma_eps
# = 0.1) in the mean and a tenth of its variance in the variance, far
# inside what the GP resolves (RMSE 0.007 against the field). npae and
# nn_npae run the same unconverged iteration count in both dtypes and are
# held to that alone. npae_star is held to the larger of that and the sum
# of the float32 and float64 runs' residual bounds (NPAE_ROUND, each run's
# own residuals and unit roundoff), since both sit within their bound of
# the exact solve: its JOR runs at the edge of stability (C8), where
# float32 and float64 part by up to 0.05 (an H100, 100,000 iterations).
F32_MEAN_TOL = 0.1 * TRUE_THETA[2]
F32_VAR_TOL = 0.1 * TRUE_THETA[2] ** 2
CROSS_CACHE_LIMIT_MB = 8192           # the paper fleet's cross-Gram: 4,199 MB
# DEC-NPAE* (Alg. 12) takes omega* = 2 / (lmax + lmin) of R = D^-1 C_A from
# the power method. At the paper fleet C_A is ill-conditioned (cond 1e3-1e4
# on a CPU run at 1,000 points per agent), so omega* lmax is within 1e-3 of
# 2: the largest mode of JOR's error, the one k_A weighs most, decays at
# |1 - omega* lmax| ~ 0.999 per iteration, and FleetConfig's 500 JOR
# iterations leave it where it started (the reference does the same on the
# same data; ROADMAP C8). On an H100 50,000 iterations took the first
# tile's RMSE to 0.013 (20,000: 0.072; 100,000 did not improve on the four
# tiles' 0.025; tools/npae_iterations.py). The phase serves and gates
# npae_star through a fleet of its own, FleetConfig(jor_iters=
# NPAE_STAR_JOR_ITERS).
NPAE_STAR_JOR_ITERS = 50_000
GAPX_ITERS = 3                        # gapx / dec-gapx iterations at 16,200
# their proximal weights (kappa of eq. 34, L of eq. 26): TRAIN_KAPPA scaled
# with the points per agent, 16,200 against the train phase's 8,100, since
# the NLL's curvature grows like 2 N_i (see TRAIN_KAPPA; not a worked-out
# rule, C4). gapx's agents diverge at this kappa; the reference does the
# same at a reduced Ni with the same kappa / Ni (tools/gapx_kappa.py).
GAPX_KAPPA = 2 * TRAIN_KAPPA
# fullgp phase: the FULL-GP yardstick (paper eq. 5-6) over all 32,400
# points, then exact training (P1, multi-start Adam on log theta) on
# GPExperimentConfig.n_train points in float64: FULLGP_STARTS starts of
# FULLGP_STEPS steps, cut to one start when a probe of FULLGP_PROBE_STEPS
# steps says the three would take longer than FULLGP_BUDGET_S
FULLGP_STARTS, FULLGP_STEPS, FULLGP_PROBE_STEPS = 3, 200, 5
FULLGP_BUDGET_S = 60.0
# fleets phase: the paper's other fleets (GPExperimentConfig.fleets) over
# the same 32,400 points, stripe-partitioned on a path graph, each method
# at FleetConfig's iteration counts on METHOD_TILES tiles of BATCH queries.
# DAC on an M-agent path keeps 1 - eps 2 (1 - cos(pi / M)) of its slowest
# mode a sweep (eps = 1/3): 0.9674, 0.9918, 0.9979 at M = 10, 20, 40, so
# 200 sweeps leave 1.3e-3, 0.19 and 0.66 of it. The engine reads the sums
# as M times the agents' mean, which the doubly stochastic sweeps keep
# whatever the residual, so the served posterior is held to its
# centralized form within the rounding bound at every M (DAC_ROUND with
# M); what the residual bounds is any one agent's own estimate, which is
# held per query within M times that query's own final spread.
FLEET_SIZES = (10, 20, 40)
FLEET_METHODS = ("rbcm", "nn_rbcm", "npae", "npae_star")
DAC_UNTIL_TOL = 1e-9                  # dac_until's default tolerance
DIAG_SWEEPS = (1, 10, 50, 100, 200)   # trajectory points reported
# chaos phase: the serve fleet under fault plans (repro_torch.chaos), each
# method on CHAOS_TILES tiles of BATCH queries through GPFleet.predict(
# fault_plan=, allow_degraded=True). A consensus-free plan must give the
# exact result bit for bit; a round-0 dropout, a partition and a NaN agent
# are exact masked aggregation over the agents CHAOS_KEEP lists (the DAC
# family gated by DAC_ROUND, the NPAE family by NPAE_ROUND); the mid-run
# dropout with edge loss is an estimate, gated by the engine's residual
# guard (degraded_tol) and the RMSE. A method the guard refuses under any
# of these plans fails the phase.
CHAOS_METHODS = ("poe", "gpoe", "bcm", "rbcm", "nn_rbcm", "npae",
                 "npae_star", "nn_npae")
DAC_CHAOS = CHAOS_METHODS[:5]
CHAOS_TIMED = ("rbcm", "npae", "nn_npae")
CHAOS_TILES = METHOD_TILES
CHAOS_PLANS = {"free": dict(straggle_every=2, fail_every=5),
               "drop0": dict(dropouts=((0, 0),)),
               "drop1": dict(dropouts=((1, 0),)),
               "nan2": dict(nan_agents=(2,)),
               "midrun": dict(seed=7, dropouts=((3, 50, 150),),
                              edge_loss=0.2)}
CHAOS_CONSENSUS_PLANS = ("drop0", "drop1", "nan2", "midrun")
CHAOS_CENSUS = {
    "drop0": dict(alive_agents=3, excluded_agents=1, n_components=1,
                  scrubbed_agents=0),
    "drop1": dict(alive_agents=3, excluded_agents=2, n_components=2,
                  scrubbed_agents=0),      # {0} cut off, {2, 3} served
    "nan2": dict(alive_agents=4, excluded_agents=0, n_components=1,
                 scrubbed_agents=1),
    "midrun": dict(alive_agents=4, excluded_agents=0, n_components=1,
                   scrubbed_agents=0)}
CHAOS_KEEP = {"drop0": [1, 2, 3], "drop1": [2, 3], "nan2": [0, 1, 3]}
# The engine's residual guard. Its default (the reference's), 1e-2, is an
# absolute spread, below the float32 rounding floor of DAC at this fleet's
# payloads: a converged float32 DAC keeps a spread of a few ulps of the
# summed |beta_i / var_i|, which grows with the points an agent holds (the
# exact path's own rbcm residual is 0.039 on the serve phase's 4,096
# queries, an H100 80GB HBM3 at 700 W). The reference in float32 reports
# 0.0156 under Dropout(0) at 4,000 points an agent already
# (tools/reference_witness.py --parts c11), so at 1e-2 the guard refuses
# the degraded rbcm tiles the masked sweeps serve correctly. The phase
# reports that outcome, then serves at 1.0: a decade and more above the
# float32 residuals of every plan here, and a decade and more below the
# M = 10 fleet's unconverged 31-138, which the guard must still refuse.
# Set only within _degraded_tol, so no other phase serves at it.
CHAOS_DEGRADED_TOL = 1.0
# frontdoor phase: two tenants of one ServingScheduler on the paper fleet,
# rbcm (slots 256, 512, 1,024) and npae (the registry's cap, 256)
FRONTDOOR_MAX_ROWS = 700              # rows of a ragged request, at most
FRONTDOOR_RAGGED = 12                 # ragged requests a tenant, checked
FRONTDOOR_RATES = {"rbcm": 30.0, "npae": 5.0}   # open-loop requests/s
FRONTDOOR_SECONDS = 5.0
FRONTDOOR_QUEUE_ROWS = 8192           # open-loop admission: reject above
FRONTDOOR_BURST = 64                  # closed-loop burst, rbcm requests
FRONTDOOR_FAULT_REQUESTS = 21         # requests a serving-fault tenant
FRONTDOOR_STRAGGLE_MS, FRONTDOOR_STALL_MS = 50.0, 25.0
# the launcher keeps the reference's guard (1e-2), so it serves the
# degraded fleet in float64, whose DAC floor lies far below it (the
# rbf_matvec kernel computes in float32 either way)
FRONTDOOR_LAUNCHER_ARGS = ["--agents", "4", "--per-agent", "8100",
                           "--chunk", "256", "--batch", "1024",
                           "--dac-iters", "200", "--dtype", "float64",
                           "--scheduler", "--loadgen", "30", "--duration",
                           "2", "--fault-dropout", "0",
                           "--fault-fail-every", "5"]

# scenario phase: the reference's mission and chaos presets at the repo's
# full width (four 8,100-point windows' worth per agent: every agent's
# window holds WINDOW points from the first step), kappa as the train
# phase's (TRAIN_KAPPA, C4); everything else from the preset. The mission
# runs in float32; the chaos mission in float64, because in float32 the
# reference's absolute degraded_tol refuses every degraded DAC tile at
# this payload scale (C11).
SCENARIO_WIDTH = dict(window=WINDOW, warmup_obs=WINDOW, chunk=BATCH,
                      dac_iters=200, kappa=TRAIN_KAPPA, queries_per_step=4,
                      query_rows=BATCH, max_slot=4 * BATCH,
                      eval_points=4 * BATCH)
SCENARIO_MISSIONS = (("mission", "float32"), ("chaos", "float64"))
SCENARIO_RMSE_LIMIT = RMSE_LIMIT
# The smoke preset on the card in float64 against the same preset on the
# CPU in float64, world drawn on the host for both. The card's kernels
# compute in float32 (kernels/ops.py): the observe factor, the streamed
# means and the NLL gradient are rounded through float32 there and not on
# the CPU, so the curves cannot agree to float64 roundoff. A CPU run of
# the preset with those three results rounded through float32 moved the
# RMSE curve by 1.2e-7 and the NLL curve by 8.6e-7 (drift NLLs 4.9e-7);
# the gate allows ten times that.
SCENARIO_TWIN_TOL = 1e-5
# sharded phase: the paper fleet on make_agent_mesh(4) (one member on one
# card) and on four members of cuda:0, and the M = 40 fleet on four; every
# DAC-family method at the methods phase's tiles. Both engines read the
# network sums out as a mean over agents (replicated) or members
# (sharded), which DAC preserves exactly, so each is within its float32
# rounding bound of the exact sums (DAC_ROUND's form: 2 dac_iters M u of
# the summed |payloads|, the ring's ndev <= M) whether or not the
# consensus converged: the gate is the sum of the two bounds. The
# replicated engine runs DAC, so that gate cannot tell the sharded
# engine's exact consensus from its DAC; an exact run is also held to
# its members' own payloads summed and read out in float64, within
# exact_sum_ulps(M, members) units of the summed |payloads|: a member's
# sum of its M / members agents (M / members - 1), the ring's members - 1
# folds, member 0's mean of the members' sums (members), and the
# read-out's four roundings (the correction term, its sum, 1/prec and
# mean = num / prec). A ring fault above a few float32 ulps of the
# payloads fails it; the DAC bound (2 dac_iters M units) is 200 to 400
# times wider.
SHARDED_MESHES = (1, 4)


def exact_sum_ulps(M, members):
    return M // members - 1 + 2 * members + 4

# Routing is exact on the queries whose CBNN-selected agents all live in
# the member they were routed to. At the paper's lengthscales (1.2 across
# the 0.5-wide stripes) every agent scores high everywhere and no query
# is member-local, so the routed methods are reported there and held to
# the full output on the reference test's localized setting
# (tests/test_sharded_serving.py): lengthscales 0.08, eta_nn 0.8, queries
# within 0.01 of the agents' centroids, here on the paper fleet's 4 x
# 8,100 inputs in float64 (at lengthscale 0.08 their float32 Cholesky
# fails; the rbf_matvec kernel computes in float32 either way).
SHARDED_ROUTED_LS = (0.08, 0.08)
SHARDED_ROUTED_ETA = 0.8
SHARDED_ROUTED_PER_AGENT = 64
SHARDED_M40 = 40
SHARDED_M40_METHODS = ("poe", "gpoe", "bcm", "rbcm", "nn_poe", "nn_gpoe",
                       "nn_bcm", "nn_rbcm")
# npae_sparse: the sharded and the replicated engine run the same float64
# solve on the same gathered factors; they part by float64 reduction order
SHARDED_NPAE_TOL = 1e-6
# dec-apx-sharded: 20 iterations at TRAIN_KAPPA on four members against
# the simulated trainer on cycle_graph(4), both float32 with the kernel.
# The two differ in the order of float32 operations only (the ring's
# neighbour sum against the adjacency product, one nll_grad launch per
# member against one for the fleet). At kappa = 10,000 the ADMM steps
# amplify those roundings: the simulated float32 run ends 0.0226 in log
# theta from the same iterations in float64 with the plain gradient, and
# the sharded run 0.0012249 from the simulated one, the same reading in
# three runs on the card (the kernels are deterministic; PERF.md §6). The
# gate, SHARDED_TRAIN_TOL in log theta, is twice that reading; the
# float64 distance is reported beside it.
SHARDED_TRAIN_ITERS = 20
SHARDED_TRAIN_TOL = 2.5e-3

def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` over `reps` back-to-back calls,
    by CUDA events, after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rbf_matvec_bound_ms(Nt: int, M: int, Ni: int, D: int,
                        sm_count: int) -> tuple[float, str]:
    """Least time for out (M, Nt) = sf2 * exp(-d2) @ v on the card: each
    input (a, b, v, the D lengthscales and sf2) read once and the output
    written once over the memory rate, or the operations over their peak
    rates — per (query, point) pair one exp2 on the SFUs and 3D + 3 FP32
    flops (D subtracts, D fused multiply-adds, the log2(e) scale, the
    accumulating fused multiply-add), whichever is larger."""
    pairs = Nt * M * Ni
    bytes_ = 4 * (Nt * D + M * Ni * D + M * Ni + D + 1 + M * Nt)
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_flops = pairs * (3 * D + 3) / FP32_FLOPS_PER_S
    t_exp = pairs / (SFU_EXP_PER_CLOCK_PER_SM * sm_count * SM_CLOCK_HZ)
    t_ops = max(t_flops, t_exp)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def nll_grad_bound_ms(M: int, N: int, D: int,
                      sm_count: int) -> tuple[float, str]:
    """Least time for the (M, D+2) sums of W = inner * sf2 exp(-d2s) on the
    card: d2u (M, D, N, N) and inner (M, N, N) read once, params in and
    sums out, over the memory rate; or per element one exp on the SFUs
    and 4D + 3 FP32 flops (D fused multiply-adds for d2s, the sf2 and
    inner products, D accumulating fused multiply-adds, the sum of W) over
    their peak rates, whichever is larger."""
    elems = M * N * N
    bytes_ = 4 * (M * (D + 1) * N * N + M * (D + 1) + M * (D + 2))
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_flops = elems * (4 * D + 3) / FP32_FLOPS_PER_S
    t_exp = elems / (SFU_EXP_PER_CLOCK_PER_SM * sm_count * SM_CLOCK_HZ)
    t_ops = max(t_flops, t_exp)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def paper_data(ctx):
    """The paper's §6 fleet on the card, made once per run: training
    inputs and held-out queries from ONE field draw (random Fourier
    features, as gp_sample_field draws above 4,096 points, with the same
    numbers), so the queries' noise-free values are known; the field is
    kept in ctx for more points. Returns (Xp (4, 8100, 2), yp (4, 8100),
    Xq (6144, 2), fq (6144,))."""
    if "data" not in ctx:
        import torch
        from repro_torch.core.gp import pack, stripe_partition
        from repro_torch.data import random_inputs, rff_field
        dev = torch.device(DEVICE)
        gen = torch.Generator(dev).manual_seed(ctx["seed"])
        lt = pack(*TRUE_THETA, dtype=torch.float32, device=dev)
        X = random_inputs(gen, N_TRAIN + N_BATCHES * BATCH + BIG,
                          dtype=torch.float32)
        field = rff_field(gen, lt, 2, dtype=torch.float32)
        f = field(X)
        y = f + torch.exp(lt[-1]) * torch.randn(
            X.shape[0], generator=gen, dtype=torch.float32, device=dev)
        Xp, yp = stripe_partition(X[:N_TRAIN], y[:N_TRAIN], 4)
        ctx["data"] = (Xp, yp, X[N_TRAIN:], f[N_TRAIN:])
        ctx["field"] = field
    return ctx["data"]


def online_data(ctx):
    """More points of the paper field for the online phase: per round one
    observation per agent, uniform in that agent's stripe of the first
    coordinate, and WINDOW points over the whole square for the joining
    agent. Returns (xs (R, 4, 2), ys (R, 4), Xj (W, 2), yj (W,))."""
    import torch
    from repro_torch.data import random_inputs
    Xp, _, _, _ = paper_data(ctx)
    field, dev = ctx["field"], Xp.device
    sigma_eps = torch.tensor(TRUE_THETA[2], device=dev).log().exp()
    gen = torch.Generator(dev).manual_seed(ctx["seed"] + 3)
    lo, hi = Xp[..., 0].amin(1), Xp[..., 0].amax(1)
    u = torch.rand(STREAM_ROUNDS, Xp.shape[0], 2, generator=gen, device=dev)
    xs = torch.stack([lo + (hi - lo) * u[..., 0], 2 * u[..., 1]], -1)
    Xj = random_inputs(gen, WINDOW, dtype=torch.float32)

    def noisy(X):
        return field(X) + sigma_eps * torch.randn(
            X.shape[0], generator=gen, dtype=torch.float32, device=dev)
    ys = noisy(xs.reshape(-1, 2)).reshape(xs.shape[:2])
    return xs, ys, Xj, noisy(Xj)


def cholupdate_bound_ms(M: int, n: int, shift: int,
                        sm_count: int) -> tuple[float, str, float]:
    """Least time for the rank-1 update of M factors on the card, out of
    place: the lower triangle of the updated (n - shift) block and of the
    `shift` stale rows read once, the whole (n, n) output (its zeros above
    the diagonal and the stale rows included) written once, and x read,
    over the memory rate; or 5 FP32 operations per updated element (a
    fused multiply-add for u, the division, a multiply and a fused
    multiply-add for x) over their peak rate, whichever is larger. Also
    returns the column chain's latency floor (CHAIN_CYCLES_PER_COLUMN per
    column at the maximum SM clock), reported beside it."""
    m = n - shift
    elems = M * m * (m + 1) // 2
    read = M * n * (n + 1) // 2       # the updated block's and stale rows'
    t_bytes = 4 * (read + M * n * n + M * m) / HBM_BYTES_PER_S
    t_ops = 5 * elems / FP32_FLOPS_PER_S
    chain = m * CHAIN_CYCLES_PER_COLUMN / SM_CLOCK_HZ
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations", 1e3 * chain)


def rbf_gram_bound_ms(M: int, m: int, valid: int, width: int, D: int,
                      sm_count: int) -> tuple[float, str]:
    """Least time for one (M, m, width) Gram panel on the card: z and the
    panel's valid x columns read once, params in, the float32 panel
    written once, over the memory rate; or per valid element one exp2 on
    the SFUs and 2D + 2 FP32 flops (D subtracts, D fused multiply-adds,
    the log2(e) scale, the sigma_f^2 product) over their peak rates,
    whichever is larger."""
    elems = M * m * valid
    bytes_ = 4 * (M * m * D + M * valid * D + 2 + M * m * width)
    t_bytes = bytes_ / HBM_BYTES_PER_S
    t_flops = elems * (2 * D + 2) / FP32_FLOPS_PER_S
    t_exp = elems / (SFU_EXP_PER_CLOCK_PER_SM * sm_count * SM_CLOCK_HZ)
    t_ops = max(t_flops, t_exp)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                        else "operations")


def flash_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask admits, queries right-aligned."""
    import torch
    q_pos = torch.arange(Sq, dtype=torch.int64) + (Sk - Sq)
    hi = q_pos.clamp(max=Sk - 1) if causal else torch.full_like(q_pos,
                                                                  Sk - 1)
    lo = (q_pos - window + 1).clamp(min=0) if window else \
        torch.zeros_like(q_pos)
    return int((hi - lo + 1).clamp(min=0).sum())


def flash_bound_ms(B: int, H: int, KH: int, Sq: int, Sk: int, D: int,
                   causal: bool, window, dtype: str,
                   sm_count: int) -> tuple[float, str, float, float]:
    """Least time for the attention on the card: q, k, v read once and o
    written once over the memory rate; or the two products, 4 D flops per
    admitted (query, key) pair and head, with one SFU exp2 per admitted
    pair, whichever is larger. float32 products at float32 accuracy run
    as three split-TF32 passes on the tensor cores (3 x 4 D flops a pair
    at the TF32 rate); bf16 products run once at the bf16 tensor-core
    rate. Also returns the float32 bound of the same products as CUDA-core
    FMAs, and the bound of the same work in bf16 on the tensor cores."""
    pairs = B * H * flash_pairs(Sq, Sk, causal, window)
    elems = 2 * B * H * Sq * D + 2 * B * KH * Sk * D
    size = 4 if dtype == "float32" else 2
    t_bytes = size * elems / HBM_BYTES_PER_S
    t_exp = pairs / (SFU_EXP_PER_CLOCK_PER_SM * sm_count * SM_CLOCK_HZ)
    flops = 4 * D * pairs
    t_mma = 3 * flops / TF32_TC_FLOPS_PER_S if dtype == "float32" \
        else flops / BF16_TC_FLOPS_PER_S
    t_ops = max(t_mma, t_exp)
    t_fma = max(flops / FP32_FLOPS_PER_S, t_exp, t_bytes)
    t_tc = max(flops / BF16_TC_FLOPS_PER_S, t_exp,
               2 * elems / HBM_BYTES_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations", 1e3 * t_fma,
            1e3 * t_tc)


def flash_attention_cases(ctx, sms):
    """flash_attention against its plain version on the card at
    FLASH_CASES (random normal q, k, v), max |error| within FLASH_TOL of
    max |plain output|, bitwise repeatable and finite; its log-sum-exp
    output against the plain logsumexp (FLASH_LSE_TOL) with the output
    bitwise unchanged; FlashAttentionFunction's dq, dk, dv against
    autograd through the plain version (FLASH_GRAD_TOL); the prefill
    shape, float32 and bf16, timed against the plain version, PyTorch's
    scaled_dot_product_attention (causal, GQA) and the bound, and the
    launch with the log-sum-exp on."""
    import torch
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import ops
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(ctx["seed"] + 7)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = []
    for B, H, KH, Sq, Sk, D, causal, window, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn(B, H, Sq, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, KH, Sk, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, KH, Sk, D, generator=gen, device=dev).to(dtype)
        got = F.flash_attention(q, k, v, causal, window)
        again = F.flash_attention(q, k, v, causal, window)
        want = F.flash_attention_plain(q, k, v, causal, window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        case = {"B": B, "H": H, "KH": KH, "Sq": Sq, "Sk": Sk, "D": D,
                "causal": causal, "window": window, "dtype": dt,
                "max_abs_err": err, "max_rel_err": err / scale,
                "bitwise_repeatable": bool(torch.equal(got, again)),
                "finite": bool(torch.isfinite(got).all())}
        if not (err <= FLASH_TOL[dt] * scale and case["finite"]
                and case["bitwise_repeatable"]):
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version, is not finite or not "
                                 f"repeatable at {case}")
        del want
        # the training forward: its log-sum-exp, and the output with the
        # lse on bitwise the output without
        out_lse, lse = F.flash_attention_lse(q, k, v, causal, window)
        _, want_lse = F.flash_attention_plain_lse(q, k, v, causal, window)
        case["max_rel_err_lse"] = float(((lse - want_lse).abs()
                                         / (1 + want_lse.abs())).max())
        case["lse_out_bitwise_equal"] = bool(torch.equal(out_lse, got))
        del out_lse, lse, want_lse
        # FlashAttentionFunction's gradients against autograd through the
        # plain version
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        grads = torch.autograd.grad(
            ops.flash_attention(*qkv, causal=causal, window=window), qkv,
            dout)
        want_grads = torch.autograd.grad(
            F.flash_attention_plain(*qkv, causal, window), qkv, dout)
        case["max_rel_err_grads"] = max(
            float((g.float() - w.float()).abs().max())
            / float(w.float().abs().max())
            for g, w in zip(grads, want_grads))
        case["grads_finite"] = all(bool(torch.isfinite(g).all())
                                   for g in grads)
        del qkv, dout, grads, want_grads
        if not (case["max_rel_err_lse"] <= FLASH_LSE_TOL
                and case["lse_out_bitwise_equal"]
                and case["max_rel_err_grads"] <= FLASH_GRAD_TOL[dt]
                and case["grads_finite"]):
            raise AssertionError(f"flash_attention's log-sum-exp or its "
                                 f"Function's gradients disagree with the "
                                 f"plain version at {case}")
        if (B, H, KH, Sq, Sk, D, causal, window) == FLASH_CASES[0][:8]:
            # the library yardstick: one PyTorch call, never made by the
            # port
            case["ms"] = cuda_ms(
                lambda: F.flash_attention(q, k, v, causal, window), 20)
            case["plain_ms"] = cuda_ms(
                lambda: F.flash_attention_plain(q, k, v, causal, window), 5)
            case["library_ms"] = cuda_ms(
                lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 20)
            case["library_call"] = ("scaled_dot_product_attention("
                                    "is_causal=True, enable_gqa=True)")
            # the training forward's launch, log-sum-exp written
            case["lse_ms"] = cuda_ms(
                lambda: F.flash_attention_lse(q, k, v, causal, window), 20)
            (case["bound_ms"], case["bound_by"], case["fp32_fma_bound_ms"],
             case["bf16_tensor_core_bound_ms"]) = flash_bound_ms(
                 B, H, KH, Sq, Sk, D, causal, window, dt, sms)
            case["admitted_pairs_per_head"] = flash_pairs(Sq, Sk, causal,
                                                          window)
            if dt == "float32":
                ctx["flash_attention"] = case
        cases.append(case)
        del q, k, v, got, again
    torch.cuda.empty_cache()
    return cases


def plain_local_grad(lt, Xi, yi):
    """One agent's cached-geometry NLL gradient with the nll_grad kernel's
    plain version in its place, on whatever device the inputs lie: the
    grad_fn hook that the train phase holds the kernel path against."""
    import torch
    from repro_torch.core.gp import diff2_stack, inner_from_cov
    from repro_torch.core.training import cov_from_cache
    from repro_torch.kernels import nll_grad as G
    D = Xi.shape[-1]
    d2u = diff2_stack(Xi)
    C, _ = cov_from_cache(lt, d2u)
    theta = torch.exp(lt)
    params = torch.cat([1 / theta[:D] ** 2, theta[D:D + 1] ** 2])
    sums = G.nll_grad_plain(d2u, inner_from_cov(C, yi), params)
    return torch.cat([sums[:D] * params[:D], sums[D:D + 1],
                      theta[D + 1:] ** 2 * sums[D + 1:]])


def phase_build(ctx):
    from repro_torch.kernels import _build
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    fresh = [n for n in names if not _build.library_path(n).exists()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        libs = list(ex.map(_build.build, names))
    # ptxas's report of a fresh build (-Xptxas -v): registers per thread
    # and spilled bytes over every kernel of each library
    ptxas = {}
    for n in fresh:
        log = (_build.BUILD_DIR / f"{n}.log").read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill", log)]
        ptxas[n] = {"registers": [min(regs), max(regs)] if regs else None,
                    "spill_bytes": sum(spills)}
    return {"seconds": time.perf_counter() - t0, "built": fresh,
            "libraries": [str(p) for p in libs], "ptxas": ptxas}


def _rel_err(torch, got, want, scale):
    return float(((got.double() - want.double()).abs()
                  / scale.double().clamp_min(1e-30)).max())


def rbf_matvec_timing(case, a, b, v, ls, sf2, sms):
    """One shape of rbf_matvec timed on the card, into `case`: its device
    time and device launches per call from a trace of RBF_MATVEC_TRACED
    back-to-back calls (the phase raises unless every call is one device
    launch), the mean ms per call by CUDA events over 200 back-to-back
    calls, the host's us per call (the enqueue of 200 calls on the
    host's clock, which the events time includes whenever the card is
    faster than the host), RBF_MATVEC_REPEATS calls held bitwise to the
    first, and the bound."""
    import torch
    from repro_torch.kernels import rbf_matvec as K
    first = K.rbf_matvec(a, b, v, ls, sf2)
    case["bitwise_repeatable"] = all(
        torch.equal(K.rbf_matvec(a, b, v, ls, sf2), first)
        for _ in range(RBF_MATVEC_REPEATS))
    trace = _profiled(lambda: [K.rbf_matvec(a, b, v, ls, sf2)
                               for _ in range(RBF_MATVEC_TRACED)],
                      "rbf_matvec")
    case["device_ms"] = trace["rbf_matvec_device_ms"] / RBF_MATVEC_TRACED
    case["device_launches_per_call"] = (trace["kernels_launched"]
                                        / RBF_MATVEC_TRACED)
    if not (case["bitwise_repeatable"]
            and trace["rbf_matvec_device_launches"] == RBF_MATVEC_TRACED
            and case["device_launches_per_call"] == 1):
        raise AssertionError(f"rbf_matvec is not one repeatable device "
                             f"launch a call: {case}, {trace['top_kernels']}")
    case["ms"] = cuda_ms(lambda: K.rbf_matvec(a, b, v, ls, sf2), 200)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        K.rbf_matvec(a, b, v, ls, sf2)
    case["host_us_per_call"] = 1e6 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    case["bound_ms"], case["bound_by"] = rbf_matvec_bound_ms(
        *a.shape[:1], *b.shape, sms)
    case["geometry"] = K.geometry(*a.shape[:1], *b.shape, sms)._asdict()
    return case


def phase_kernels(ctx):
    import torch
    from repro_torch.kernels import rbf_matvec as K
    dev = torch.device(DEVICE)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(dev).manual_seed(ctx["seed"] + 1)
    shapes = RBF_MATVEC_SHAPES
    cases = []
    for Nt, M, Ni, D in shapes:
        ls = (torch.tensor(TRUE_THETA[0], device=dev) if D == 2
              else torch.full((D,), 0.5, device=dev))
        a = 2 * torch.rand(Nt, D, generator=gen, device=dev)
        b = 2 * torch.rand(M, Ni, D, generator=gen, device=dev)
        v = torch.randn(M, Ni, generator=gen, device=dev)
        sf2 = torch.tensor([TRUE_THETA[1] ** 2], device=dev)
        got = K.rbf_matvec(a, b, v, ls, sf2)
        again = K.rbf_matvec(a, b, v, ls, sf2)
        want = K.rbf_matvec_plain(a, b, v, ls, sf2)
        scale = K.rbf_matvec_plain(a, b, v.abs(), ls, sf2)
        torch.cuda.synchronize()
        case = {"Nt": Nt, "M": M, "Ni": Ni, "D": D,
                "max_rel_err": _rel_err(torch, got, want, scale),
                "max_abs_err": float((got - want).abs().max()),
                "bitwise_repeatable": bool(torch.equal(got, again))}
        if not (case["max_rel_err"] <= REL_TOL
                and case["bitwise_repeatable"]):
            raise AssertionError(f"rbf_matvec disagrees with its plain "
                                 f"version or is not repeatable at {case}")
        if (Nt, M, Ni, D) == shapes[0]:
            # library yardstick: no single PyTorch call computes this
            # function, so the composition cdist -> exp -> bmm is timed
            def composed():
                k = torch.cdist((a / ls)[None].expand(M, Nt, D),
                                b / ls).square_()
                return sf2 * torch.bmm(k.neg_().exp_(), v[..., None])
            rbf_matvec_timing(case, a, b, v, ls, sf2, sms)
            case["plain_ms"] = cuda_ms(
                lambda: K.rbf_matvec_plain(a, b, v, ls, sf2), 20)
            case["composed_library_ms"] = cuda_ms(composed, 20)
            ctx["rbf_matvec"] = case
        elif (Nt, M, Ni, D) in GRBCM_TILES + FLEET_TILES:
            rbf_matvec_timing(case, a, b, v, ls, sf2, sms)
            case["plain_ms"] = cuda_ms(
                lambda: K.rbf_matvec_plain(a, b, v, ls, sf2), 5)
        cases.append(case)
    cases.append(sparse_matvec_case(ctx, sms))
    return {"rel_tol": REL_TOL, "rbf_matvec": cases,
            "nll_grad": nll_grad_cases(ctx, sms),
            "cholupdate": cholupdate_cases(ctx, sms),
            "rbf_gram_tol": RBF_GRAM_TOL,
            "rbf_gram": rbf_gram_cases(ctx, sms),
            "flash_tol": FLASH_TOL,
            "flash_attention": flash_attention_cases(ctx, sms)}


def sparse_matvec_case(ctx, sms):
    """rbf_matvec against its plain version at the shape the sparse
    serving path gives it (Nt 256, M 4, Ni = SPARSE_M inducing points, D
    2), on that path's own inputs: the sparse phase's first query batch,
    the paper fleet's stride inducing points and the weights c of its
    float64 sparse fit, cast to float32 as the op casts them; timed and
    traced as the serving tile is."""
    import torch
    from repro_torch.core.gp import pack
    from repro_torch.core.sparse import fit_sparse_experts, select_inducing
    from repro_torch.kernels import rbf_matvec as K
    Xp, yp, Xq, _ = paper_data(ctx)
    lt = pack(*TRUE_THETA, dtype=torch.float64, device=Xp.device)
    Z = select_inducing(Xp.double(), SPARSE_M)
    c = fit_sparse_experts(lt, Xp.double(), yp.double(), Z).c
    a = Xq[:BATCH].double().float().contiguous()
    b = Z.float().contiguous()
    v = c.float().contiguous()
    ls = torch.exp(lt[:2]).float()
    sf2 = torch.exp(2 * lt[2:3]).float()
    got = K.rbf_matvec(a, b, v, ls, sf2)
    want = K.rbf_matvec_plain(a, b, v, ls, sf2)
    scale = K.rbf_matvec_plain(a, b, v.abs(), ls, sf2)
    torch.cuda.synchronize()
    case = {"Nt": BATCH, "M": Xp.shape[0], "Ni": SPARSE_M, "D": 2,
            "inputs": "sparse fleet's queries, Z and c",
            "max_rel_err": _rel_err(torch, got, want, scale),
            "max_abs_err": float((got - want).abs().max())}
    if not case["max_rel_err"] <= REL_TOL:
        raise AssertionError(f"rbf_matvec disagrees with its plain version "
                             f"at the sparse serving shape {case}")
    return rbf_matvec_timing(case, a, b, v, ls, sf2, sms)


def rbf_gram_cases(ctx, sms):
    """rbf_gram against its plain version on the card, max |error| within
    RBF_GRAM_TOL sigma_f^2: first the sparse fit's panel of the paper fleet
    (its 512 stride inducing points against the first 4,096 points of each
    agent, timed, with the composed cdist -> exp as yardstick), then
    random inputs at the tail panel of the 100k fleet (the columns past N
    checked exactly 0), a square panel with noise, and edge shapes."""
    import torch
    from repro_torch.core.sparse import select_inducing
    from repro_torch.kernels import rbf_gram as RG
    dev = torch.device(DEVICE)
    Xp, _, _, _ = paper_data(ctx)
    gen = torch.Generator(dev).manual_seed(ctx["seed"] + 6)
    sf2 = TRUE_THETA[1] ** 2
    params = torch.tensor([sf2, TRUE_THETA[2] ** 2], device=dev)
    cases = []
    for M, m, N, D, col0, width, noise in RBF_GRAM_CASES:
        ls = (torch.tensor(TRUE_THETA[0], device=dev) if D == 2
              else torch.full((D,), 0.5, device=dev))
        if (M, m, N) == (4, SPARSE_M, Xp.shape[1]):
            x = (Xp / ls).contiguous()
            z = (select_inducing(Xp, m) / ls).contiguous()
        else:
            x = 2 * torch.rand(M, N, D, generator=gen, device=dev) / ls
            z = x[:, :m].contiguous() if noise else \
                2 * torch.rand(M, m, D, generator=gen, device=dev) / ls
        got = RG.rbf_gram(z, x, params, noise, col0, width)
        want = RG.rbf_gram_plain(z, x, params, noise, col0, width)
        torch.cuda.synchronize()
        valid = min(width, N - col0)
        case = {"M": M, "m": m, "N": N, "D": D, "col0": col0,
                "width": width, "valid_columns": valid, "with_noise": noise,
                "max_abs_err": float((got - want).abs().max()),
                "tail_exactly_zero": bool((got[..., valid:] == 0).all())}
        if not (case["max_abs_err"] <= RBF_GRAM_TOL * sf2
                and case["tail_exactly_zero"]):
            raise AssertionError(f"rbf_gram disagrees with its plain "
                                 f"version at {case}")
        if not cases:
            # library yardstick: no single PyTorch call computes this
            # function, so the composition cdist -> square -> exp is timed
            xs = x[:, :width]

            def composed():
                return sf2 * torch.exp(-torch.cdist(z, xs).square_())
            case["ms"] = cuda_ms(
                lambda: RG.rbf_gram(z, x, params, False, col0, width), 200)
            case["plain_ms"] = cuda_ms(
                lambda: RG.rbf_gram_plain(z, x, params, False, col0, width),
                20)
            case["composed_library_ms"] = cuda_ms(composed, 20)
            case["bound_ms"], case["bound_by"] = rbf_gram_bound_ms(
                M, m, valid, width, D, sms)
            # device time from a trace of back-to-back calls, beside the
            # events time (which includes the host's launch gaps)
            trace = _profiled(lambda: [RG.rbf_gram(z, x, params, False, col0,
                                                   width)
                                       for _ in range(RBF_MATVEC_TRACED)],
                              "rbf_gram")
            case["device_ms"] = (trace["rbf_gram_device_ms"]
                                 / RBF_MATVEC_TRACED)
            case["device_launches_per_call"] = (
                trace["rbf_gram_device_launches"] / RBF_MATVEC_TRACED)
            ctx["rbf_gram"] = case
        cases.append(case)
    return cases


def nll_grad_cases(ctx, sms):
    """nll_grad against its plain version on the card, per component
    relative to its sum of |terms| (sum |W d2u[d]|, sum |W|, sum |diag
    inner|), and bitwise repeatable: first at the training shape with the
    real `inner` of the paper fleet at theta0, then ragged N, other D and
    the paper's largest fleet (M = 40) with a random symmetric `inner`."""
    import torch
    from repro_torch.core.gp import diff2_stack, inner_from_cov, pack
    from repro_torch.core.training import cov_from_cache
    from repro_torch.fleet import FleetConfig
    from repro_torch.kernels import nll_grad as G
    dev = torch.device(DEVICE)
    Xp, yp, _, _ = paper_data(ctx)
    th0 = FleetConfig().theta0
    lt0 = pack(list(th0[:-2]), th0[-2], th0[-1], dtype=torch.float32,
               device=dev).expand(Xp.shape[0], -1)
    gen = torch.Generator(dev).manual_seed(ctx["seed"] + 2)
    shapes = [tuple(Xp.shape)] + NLL_GRAD_EDGE_SHAPES
    cases = []
    for M, N, D in shapes:
        if (M, N, D) == shapes[0]:
            d2u = diff2_stack(Xp)
            C, Kmat = cov_from_cache(lt0, d2u)
            inner = inner_from_cov(C, yp)
            del C
            theta = torch.exp(lt0)
            params = torch.cat([1 / theta[:, :D] ** 2,
                                theta[:, D:D + 1] ** 2], 1).contiguous()
        else:
            d2u = diff2_stack(2 * torch.rand(M, N, D, generator=gen,
                                             device=dev))
            inner = torch.randn(M, N, N, generator=gen, device=dev)
            inner = (inner + inner.mT) / 2
            ls = 0.3 + torch.rand(M, D, generator=gen, device=dev)
            sf2 = 0.5 + torch.rand(M, 1, generator=gen, device=dev)
            params = torch.cat([1 / ls ** 2, sf2], 1)
        got = G.nll_grad(d2u, inner, params)
        again = G.nll_grad(d2u, inner, params)
        want = G.nll_grad_plain(d2u, inner, params)
        scale = G.nll_grad_plain(d2u, inner.abs(), params)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs()
        case = {"M": M, "N": N, "D": D,
                "max_rel_err": float((err / scale.double()
                                      .clamp_min(1e-30)).max()),
                "max_abs_err": float(err.max()),
                "bitwise_repeatable": bool(torch.equal(got, again))}
        if not (bool((err <= REL_TOL * scale.double()).all())
                and case["bitwise_repeatable"]):
            raise AssertionError(f"nll_grad disagrees with its plain "
                                 f"version or is not repeatable at {case}")
        if (M, N, D) == shapes[0]:
            # library yardstick: no single PyTorch call computes these
            # sums, so the composition that reuses the K the iteration
            # already built (einsum of inner * K against d2u) is timed
            case["ms"] = cuda_ms(lambda: G.nll_grad(d2u, inner, params), 50)
            case["plain_ms"] = cuda_ms(
                lambda: G.nll_grad_plain(d2u, inner, params), 5)
            case["composed_library_ms"] = cuda_ms(
                lambda: G.nll_grad_plain(d2u, inner, params, Kmat), 5)
            case["bound_ms"], case["bound_by"] = nll_grad_bound_ms(
                M, N, D, sms)
            ctx["nll_grad"] = case
            del Kmat
        elif (M, N, D) == NLL_GRAD_AUG:
            case["ms"] = cuda_ms(lambda: G.nll_grad(d2u, inner, params), 10)
            case["plain_ms"] = cuda_ms(
                lambda: G.nll_grad_plain(d2u, inner, params), 2, warmup=1)
            case["bound_ms"], case["bound_by"] = nll_grad_bound_ms(
                M, N, D, sms)
        cases.append(case)
        del d2u, inner
    torch.cuda.empty_cache()
    return cases


def cholupdate_cases(ctx, sms):
    """cholupdate against its plain version on the card, bit for bit (and
    relative to max |L'| per agent, reported): the real shift=1 eviction
    of the paper fleet's four factors (timed by events and traced for its
    device time and device launches, with the refactorization as
    yardstick, and CHOLUPDATE_REPEATS calls bitwise equal), an update and
    a downdate that keeps the factor positive definite at n = 8,099,
    random factors at the edge shapes, a partially filled window whose x
    is zero beyond its count, a zero x (bitwise no-op), a mask with two
    of four agents active (the others bitwise untouched), and a withheld
    panel that must trip the watchdog."""
    import torch
    from repro_torch.core.gp import cov_matrix, pack
    from repro_torch.core.online import from_batch
    from repro_torch.kernels import cholupdate as C
    dev = torch.device(DEVICE)
    Xp, yp, _, _ = paper_data(ctx)
    lt = pack(*TRUE_THETA, dtype=torch.float32, device=dev)
    gen = torch.Generator(dev).manual_seed(ctx["seed"] + 4)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def factor(X):
        return torch.linalg.cholesky(cov_matrix(X, lt, 1e-8)).contiguous()

    def check(name, L, x, shift=0, downdate=False, active=None):
        got = C.cholupdate(L, x, downdate, shift, active)
        start.record()
        want = C.cholupdate_plain(L, x, downdate, shift, active)
        end.record()
        torch.cuda.synchronize()
        err = (got - want).abs().amax((1, 2))
        M, n, _ = L.shape
        case = {"case": name, "M": M, "n": n, "shift": shift,
                "downdate": downdate,
                "bitwise_equal": bool(torch.equal(got, want)),
                "max_rel_err": float((err / want.abs().amax((1, 2))
                                      .clamp_min(1e-30)).max()),
                "max_abs_err": float(err.max()),
                "plain_ms": start.elapsed_time(end)}
        ok = case["bitwise_equal"] and case["max_rel_err"] <= REL_TOL
        if not bool(x.any()):
            case["bitwise_unchanged"] = bool(torch.equal(got, L)
                                             and torch.equal(want, L))
            ok = ok and case["bitwise_unchanged"]
        if active is not None:
            case["inactive_bitwise_unchanged"] = bool(
                torch.equal(got[~active], L[~active]))
            ok = ok and case["inactive_bitwise_unchanged"]
        if not ok:
            raise AssertionError(f"cholupdate disagrees with its plain "
                                 f"version at {case}")
        return case, got

    cases = []
    L = factor(Xp)
    x = L[:, :, 0]
    case, evicted = check("evict", L, x, shift=1)
    case["bitwise_repeatable"] = all(
        torch.equal(C.cholupdate(L, x, shift=1), evicted)
        for _ in range(CHOLUPDATE_REPEATS))
    if not case["bitwise_repeatable"]:
        raise AssertionError(f"cholupdate is not bitwise repeatable over "
                             f"{CHOLUPDATE_REPEATS} calls")
    # one call traced: its device launches (the scratch's fill and the
    # kernel; the fault word's copy is not a launch) and device time
    trace = _profiled(lambda: C.cholupdate(L, x, shift=1), "cholupdate")
    case["device_ms"] = trace["cholupdate_device_ms"]
    case["device_ops"] = {k["name"]: k["count"]
                          for k in trace["top_kernels"]}
    case["device_launches_per_call"] = sum(
        n_ for k, n_ in case["device_ops"].items()
        if not k.startswith("Memcpy"))
    if trace["cholupdate_device_launches"] != 1 or \
            case["device_launches_per_call"] > C.DEVICE_LAUNCHES_PER_CALL:
        raise AssertionError(f"cholupdate device launches per call: "
                             f"{case['device_ops']}")
    case["ms"] = cuda_ms(lambda: C.cholupdate(L, x, shift=1), 20)
    case["refactorization_ms"] = cuda_ms(
        lambda: torch.linalg.cholesky(L @ L.mT + x[..., :, None]
                                      * x[..., None, :]), 3, warmup=1)
    # the kernel line's library yardstick: that composed refactorization
    # (the product, then one torch.linalg.cholesky of the four windows)
    case["library_ms"] = case["refactorization_ms"]
    # where the time goes: the same launches with every column skipped (a
    # zero x: loads and stores, no rotation arithmetic), and with every
    # agent masked out (the fill's copy and the launches alone)
    case["ms_zero_x"] = cuda_ms(
        lambda: C.cholupdate(L, torch.zeros_like(x), shift=1), 10)
    case["ms_all_agents_inactive"] = cuda_ms(
        lambda: C.cholupdate(L, x, shift=1, active=torch.zeros(
            L.shape[0], dtype=torch.bool, device=dev)), 10)
    case["bound_ms"], case["bound_by"], case["chain_floor_ms"] = \
        cholupdate_bound_ms(*L.shape[:2], 1, sms)
    ctx["cholupdate"] = case
    cases.append(case)
    del L, x

    L = evicted[:, :-1, :-1].contiguous()          # the windows less slot 0
    del evicted
    x = 0.5 * torch.randn(L.shape[:2], generator=gen, device=dev)
    case, up = check("update", L, x)
    cases.append(case)
    cases.append(check("downdate", up, x, downdate=True)[0])
    del L, up
    torch.cuda.empty_cache()

    for M, n in CHOLUPDATE_EDGE_SHAPES:
        L = factor(2 * torch.rand(M, n, 2, generator=gen, device=dev))
        x = torch.randn(M, n, generator=gen, device=dev)
        cases.append(check("update", L, x)[0])
    state = from_batch(lt, Xp[:, :500], yp[:, :500], window=777)
    L = state.L.contiguous()
    x = L[:, :, 0]
    case = check("evict_partial_window", L, x, shift=1)[0]
    case["x_zero_beyond_count"] = bool((x[:, 500:] == 0).all())
    if not case["x_zero_beyond_count"]:
        raise AssertionError("a sentinel row of the window factor is not "
                             "zero in column 0")
    cases.append(case)
    L = factor(2 * torch.rand(4, 1013, 2, generator=gen, device=dev))
    cases.append(check("zero_x", L, torch.zeros(4, 1013, device=dev))[0])
    cases.append(check("mask", L, L[:, :, 0], shift=1,
                       active=torch.tensor([True, False, True, False],
                                           device=dev))[0])
    C.check_faults()                  # every case above ran without a fault
    # the branch-free division and sqrt against the intrinsics, bit for bit
    math = C.selfcheck(CHOLUPDATE_SELFCHECK_DIVS, dev)
    if math["sqrt_unequal"] or math["div_unequal"]:
        raise AssertionError(f"cholupdate's fast division or sqrt differs "
                             f"from the intrinsics: {math}")
    cases.append({"case": "fast_math_selfcheck", **math})
    # the watchdog: agent 0's panel 3 withheld, the call ends in time and
    # its fault is raised
    t0 = time.perf_counter()
    C._launch(L, L[:, :, 0], False, 0, None, timeout_s=0.05, never_publish=3)
    try:
        C.check_faults()
        tripped = ""
    except RuntimeError as e:
        tripped = str(e)
    case = {"case": "watchdog", "M": 4, "n": 1013, "timeout_s": 0.05,
            "raised": tripped, "s": time.perf_counter() - t0}
    if "panel 3 of agent 0 never arrived" not in tripped:
        raise AssertionError(f"cholupdate's watchdog did not trip: {case}")
    cases.append(case)
    return cases


def phase_serve(ctx):
    import torch
    from repro_torch.core.gp import pack
    from repro_torch.core.prediction import PredictionEngine
    from repro_torch.core.prediction.local import local_moments_cached
    from repro_torch.fleet import FleetConfig, GPFleet
    from repro_torch.kernels import nll_grad as G
    from repro_torch.kernels import rbf_matvec as K
    dev = torch.device(DEVICE)
    lt = pack(*TRUE_THETA, dtype=torch.float32, device=dev)
    n_query = N_BATCHES * BATCH + BIG
    Xp, yp, Xq, fq = paper_data(ctx)
    cfg = FleetConfig(stream_mean=True)
    assert (cfg.num_agents, cfg.graph, cfg.dac_iters, cfg.chunk,
            cfg.method) == (4, "path", 200, 256, "rbcm"), cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    fleet = GPFleet(cfg, device=DEVICE).fit(Xp, yp, log_theta0=lt,
                                            train=False)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    if not all(bool(torch.isfinite(t).all()) for t in fleet.fitted
               if t is not None):
        raise AssertionError("non-finite Cholesky factors")
    fleet.predict(Xq[:BATCH])                       # warm-up
    torch.cuda.synchronize()

    # the serving path: counts reset just before, read just after
    K.reset_launches()
    G.reset_launches()
    batch_ms, means, variances = [], [], []
    t_all = time.perf_counter()
    for i in range(N_BATCHES):
        t0 = time.perf_counter()
        m, v, _ = fleet.predict(Xq[i * BATCH:(i + 1) * BATCH])
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
        means.append(m)
        variances.append(v)
    t0 = time.perf_counter()
    m, v, info = fleet.predict(Xq[N_BATCHES * BATCH:])
    torch.cuda.synchronize()
    big_ms = 1e3 * (time.perf_counter() - t0)
    total_s = time.perf_counter() - t_all
    launches = K.launches
    if G.launches:
        raise AssertionError(f"serving launched nll_grad {G.launches} "
                             f"times")
    peak = torch.cuda.max_memory_allocated(dev)
    means.append(m)
    variances.append(v)
    mean, var = torch.cat(means), torch.cat(variances)

    tiles = N_BATCHES * -(-BATCH // cfg.chunk) + -(-BIG // cfg.chunk)
    if launches != tiles:
        raise AssertionError(f"rbf_matvec launched {launches} times for "
                             f"{tiles} query tiles")
    if mean.shape != (n_query,) or not bool(torch.isfinite(mean).all()) \
            or not bool(torch.isfinite(var).all()) or \
            not bool((var > 0).all()):
        raise AssertionError("served moments are not finite and positive "
                             "of the expected shape")
    rmse = float(torch.sqrt(((mean - fq) ** 2).mean()))
    if not rmse < RMSE_LIMIT:
        raise AssertionError(f"RMSE {rmse} against the noise-free field "
                             f"is not below {RMSE_LIMIT}")

    # the same experts served without the kernel (dense mean k^T alpha);
    # a per-agent mean error e_i reaches the rBCM mean as sum_i w_i e_i
    # with w_i = (beta_i / var_i) / prec, so the per-query scale is
    # sum_i |w_i| sum_j |k_ij alpha_ij|
    dense = PredictionEngine(fleet.fitted, fleet.A, chunk=cfg.chunk,
                             dac_iters=cfg.dac_iters, stream_mean=False,
                             device=DEVICE)
    ft = fleet.fitted
    ls, sf = torch.exp(ft.log_theta[:-2]), torch.exp(ft.log_theta[-2])
    sf2 = (sf ** 2).reshape(1)
    agent_err = mean_err = 0.0
    for t0_ in range(0, n_query, cfg.chunk):
        Xt = Xq[t0_:t0_ + cfg.chunk]
        mu_d, var_d = local_moments_cached(ft.log_theta, ft.Xp, ft.L,
                                           ft.alpha, Xt)
        mu_s = fleet.engine.posterior_means_streamed(Xt)
        S = K.rbf_matvec_plain(Xt, ft.Xp, ft.alpha.abs(), ls, sf2)
        agent_err = max(agent_err, _rel_err(torch, mu_s, mu_d, S))
        beta = 0.5 * (torch.log(sf2) - torch.log(var_d))
        prec = (beta / var_d).sum(0) + (1 - beta.sum(0)) / sf2
        scale = ((beta / var_d / prec).abs() * S).sum(0)
        m_d = dense.predict("rbcm", Xt)[0]
        mean_err = max(mean_err, _rel_err(
            torch, mean[t0_:t0_ + cfg.chunk], m_d, scale))
    if not (agent_err <= REL_TOL and mean_err <= REL_TOL):
        raise AssertionError(f"streamed vs dense means: per-agent "
                             f"{agent_err}, rBCM {mean_err} > {REL_TOL}")
    ctx["launches"]["rbf_matvec"] = launches
    ctx["fleet"], ctx["queries"] = fleet, Xq
    return {"n_train": N_TRAIN, "agents": cfg.num_agents,
            "per_agent": int(Xp.shape[1]), "dac_iters": cfg.dac_iters,
            "chunk": cfg.chunk, "dtype": "float32", "queries": n_query,
            "fit_ms": fit_ms, "batch_ms": batch_ms,
            "mean_batch_ms": sum(batch_ms) / len(batch_ms),
            "big_call_ms": big_ms, "queries_per_s": n_query / total_s,
            "peak_memory_bytes": peak, "rbf_matvec_launches": launches,
            "query_tiles": tiles, "rmse_vs_field": rmse,
            "max_rel_err_agent_means": agent_err,
            "max_rel_err_rbcm_means": mean_err,
            "dac_residual_4096": float(info["dac_residual"])}


def _serve_method(predict, method, Xq, fq, chunk, failures):
    """One method of the methods phase: a warm-up tile, then METHOD_TILES
    tiles of BATCH queries through `predict(X, method=)` (GPFleet.predict),
    the rbf_matvec count reset just before and read just after; an RMSE
    above RMSE_LIMIT goes to `failures`. Returns the report and the first
    tile's (mean, var, info)."""
    import torch
    from repro_torch.kernels import rbf_matvec as K
    dev = torch.device(DEVICE)
    predict(Xq[:BATCH], method=method)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launches()
    outs, batch_ms = [], []
    t_all = time.perf_counter()
    for i in range(METHOD_TILES):
        t0 = time.perf_counter()
        outs.append(predict(Xq[i * BATCH:(i + 1) * BATCH], method=method))
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    total_s = time.perf_counter() - t_all
    launches = K.launches
    n = METHOD_TILES * BATCH
    mean = torch.cat([o[0] for o in outs])
    var = torch.cat([o[1] for o in outs])
    if mean.shape != (n,) or not bool(torch.isfinite(mean).all()) \
            or not bool(torch.isfinite(var).all()) \
            or not bool((var > 0).all()):
        raise AssertionError(f"{method}: served moments are not finite and "
                             f"positive of the expected shape")
    want = MATVEC_PER_TILE[method] * METHOD_TILES * -(-BATCH // chunk)
    if launches != want:
        raise AssertionError(f"{method}: rbf_matvec launched {launches} "
                             f"times, {want} expected")
    rmse = _rmse(mean, fq)
    if not rmse < RMSE_LIMIT:
        failures.append(f"{method}: RMSE {rmse} against the noise-free "
                        f"field is not below {RMSE_LIMIT}")
    rep = {"batch_ms": batch_ms, "mean_batch_ms": sum(batch_ms) / len(
        batch_ms), "queries_per_s": n / total_s, "rmse_vs_field": rmse,
        "rbf_matvec_launches_per_batch": launches / METHOD_TILES,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)}
    for key in ("dac_residual", "jor_residual", "dale_residual"):
        if key in outs[0][2]:
            rep[key] = max(float(o[2][key]) for o in outs)
    if "mask" in outs[0][2]:
        rep["mean_agents_per_query"] = float(torch.cat(
            [o[2]["mask"] for o in outs], 1).double().sum(0).mean())
    return rep, outs[0]


def _dac_scales(method, mu, var, pv, mask, mu_c=None, var_c=None):
    """Per query, the summed |payloads| that bound the DAC rounding of the
    posterior's precision and precision-weighted mean (see DAC_ROUND):
    returns (prec_scale, num_scale)."""
    import torch
    base = method[3:] if method.startswith("nn_") else method
    m = torch.ones_like(mu) if mask is None else mask.to(mu.dtype)
    if base in ("poe", "bcm"):
        beta = m
    elif base == "gpoe":
        beta = m / m.sum(0)
    elif base == "rbcm":
        beta = 0.5 * (torch.log(pv) - torch.log(var)) * m
    else:                                              # grbcm
        beta = 0.5 * (torch.log(var_c)[None] - torch.log(var))
        beta[0] = 1.0
        beta = beta * m
    prec = (beta / var).abs().sum(0)
    num = (beta * mu / var).abs().sum(0)
    if base in ("bcm", "rbcm"):
        prec = prec + beta.abs().sum(0) / pv
    if base == "grbcm":
        prec = prec + beta.abs().sum(0) / var_c
        num = num + beta.abs().sum(0) * mu_c.abs() / var_c
    return prec, num


def _check_dac_vs_cen(method, got, want, scales, dac_iters, M):
    """|1/var - 1/var_cen| and |mean/var - mean_cen/var_cen| per query
    within DAC_ROUND's bound; returns the largest share of the bound."""
    bound = 2 * dac_iters * M * UNIT
    share = 0.0
    for g, w, sc in ((1 / got[1], 1 / want[1], scales[0]),
                     (got[0] / got[1], want[0] / want[1], scales[1])):
        err = (g.double() - w.double()).abs()
        share = max(share, float((err / (bound * sc.double())).max()))
    if not share <= 1.0:
        raise AssertionError(f"{method} differs from its centralized form "
                             f"by {share} x the DAC rounding bound")
    return share


def _npae_bound(H, kA, b, r, dac_iters, omega=None, A=None, unit=UNIT,
                n_dac=None):
    """The per-query bound of the NPAE gate (see NPAE_ROUND) for the
    systems H (Nt, M, M) of one tile with right-hand sides b (Nt, M, 2),
    final residuals r (Nt,), `dac_iters` DAC sweeps over `n_dac` agents
    (default M) and the unit roundoff of the run's dtype: JOR at
    relaxation `omega`, or DALE on the adjacency `A`. Computed in
    float64."""
    import torch
    H, kA, b = H.double(), kA.double(), b.double()
    r = torch.as_tensor(r, dtype=H.dtype, device=H.device)
    Nt, M, _ = H.shape
    eye = torch.eye(M, dtype=H.dtype, device=H.device)
    if A is None:
        om = torch.as_tensor(omega, dtype=H.dtype, device=H.device)
        om = om.expand(Nt) if om.dim() == 0 else om.double()
        d = torch.diagonal(H, dim1=-2, dim2=-1)
        I_G = om[:, None, None] * H / d[..., :, None]
    else:
        Af = A.to(H.device, H.dtype)
        W = Af / torch.clamp(Af.sum(1), min=1.0)[:, None]
        hn = (H * H).sum(-1)
        P = eye - (H / hn[..., None])[..., :, None] * H[..., None, :]
        T = W[None, :, None, :, None] * P[:, :, :, None, :]  # (Nt,i,e,j,f)
        I_G = torch.eye(M * M, dtype=H.dtype, device=H.device) \
            - T.reshape(Nt, M * M, M * M)
    kappa = torch.linalg.inv(I_G).abs().sum(-1).amax(-1)
    q = torch.linalg.solve(H, b)
    qmax = q.abs().amax((-2, -1))
    dac = 2 * dac_iters * (M if n_dac is None else n_dac) * unit \
        * (kA.T[..., None] * q).abs().sum(1).amax(-1)
    return kA.abs().sum(0) * kappa * (r + NPAE_ROUND * unit * qmax) + dac


def _check_npae(method, got, want, bound):
    """The NPAE gate: per query within `bound`; returns the largest share
    of the bound and the largest difference."""
    err = _max_err(got, want)
    share = float((err / bound).max())
    if not share <= 1.0:
        raise AssertionError(f"{method} differs from its centralized form "
                             f"by {share} x its residual bound")
    return {"share": share, "max_abs_err": float(err.max())}


def _max_err(got, want):
    """Per query, the larger of |mean - mean'| and |var - var'| (float64)."""
    return ((got[0].double() - want[0].double()).abs()).maximum(
        (got[1].double() - want[1].double()).abs())


NPAE_ITER = ("npae", "npae_star", "nn_npae")


def _iterative_npae_bound(method, cfg, A, terms, info, unit):
    """The per-query bound (NPAE_ROUND) of npae, npae_star or nn_npae on
    one tile, at `cfg`'s iteration counts, from the tile's NPAE terms (mu,
    k_A, C_A), its served info (the CBNN mask, the reported residual) and
    the dtype's unit roundoff: the port's jor / dale rerun on the tile's
    own systems give each query's final residual, and the largest must be
    the reported one."""
    import torch
    from repro_torch.core.consensus import dale, jor, optimal_omega
    from repro_torch.core.prediction.decentralized import (_masked_system,
                                                           _rel_jitter)
    mu, kA, CA = terms
    M = kA.shape[0]
    if method == "nn_npae":
        key, mk = "dale_residual", info["mask"].to(kA.dtype)
        H = _rel_jitter(_masked_system(CA, mk.T), cfg.npae_jitter)
        mu, kA = mu * mk, kA * mk
        b = torch.stack([mu.T, kA.T], -1)
        res = dale(H, b, A, cfg.dale_iters)[1]
        kw = {"A": A, "dac_iters": 0}
    else:
        key, H = "jor_residual", _rel_jitter(CA, cfg.npae_jitter)
        b = torch.stack([mu.T, kA.T], -1)
        omega = (2.0 / M) * 0.999 if method == "npae" \
            else optimal_omega(H, cfg.pm_iters)
        res = jor(H, b, omega, cfg.jor_iters)[1]
        kw = {"omega": omega, "dac_iters": cfg.dac_iters}
    r = res[:, -1]
    if float(r.max()) != float(info[key]):
        raise AssertionError(f"{method}: recomputed {key} {float(r.max())} "
                             f"is not the reported {float(info[key])}")
    return _npae_bound(H, kA, b, r, unit=unit, **kw)


def phase_fullgp(ctx):
    """The FULL-GP yardstick and exact training (see the module
    docstring)."""
    import torch
    from repro_torch.configs.paper_gp import CONFIG
    from repro_torch.core.gp import pack, predict_full, train_full_gp
    from repro_torch.core.gp.exact import _fit_one
    dev = torch.device(DEVICE)
    Xp, yp, Xq, fq = paper_data(ctx)
    n_query = N_BATCHES * BATCH + BIG
    X, y, Xq, fq = Xp.reshape(-1, 2), yp.reshape(-1), Xq[:n_query], \
        fq[:n_query]
    out = {"n_train": int(X.shape[0]), "queries": n_query, "predict": {}}
    rmse = None
    # float32 first; float64 only when the float32 Cholesky fails (C6)
    for dtype in (torch.float32, torch.float64):
        lt = pack(*TRUE_THETA, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        mean, var = predict_full(lt, X.to(dtype), y.to(dtype), Xq.to(dtype))
        torch.cuda.synchronize()
        rec = {"ms": 1e3 * (time.perf_counter() - t0),
               "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
               "factor_bytes": X.shape[0] ** 2 * lt.element_size(),
               "finite": bool(torch.isfinite(mean).all()
                              and torch.isfinite(var).all())}
        out["predict"][str(dtype).removeprefix("torch.")] = rec
        if rec["finite"]:
            if mean.shape != (n_query,) or not bool((var > 0).all()):
                raise AssertionError("FULL-GP moments are not positive of "
                                     "the expected shape")
            rmse = rec["rmse_vs_field"] = _rmse(mean, fq)
            break
        del mean, var
        torch.cuda.empty_cache()
    if rmse is None:
        raise AssertionError("predict_full failed in float32 and float64")
    _check_rmse("FULL-GP", rmse)
    ctx["fullgp_rmse"] = rmse
    del mean, var
    torch.cuda.empty_cache()

    # exact training on n_train points spread over the whole square (every
    # fourth point of the stripes), float64, from the paper's theta0
    step = max(1, X.shape[0] // CONFIG.n_train)
    Xt, yt = X[::step][:CONFIG.n_train].double(), \
        y[::step][:CONFIG.n_train].double()
    n = int(Xt.shape[0])
    th0 = CONFIG.theta0
    lt0 = pack(list(th0[:-2]), th0[-2], th0[-1], dtype=torch.float64,
               device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _fit_one(lt0, Xt, yt, steps=FULLGP_PROBE_STEPS)
    torch.cuda.synchronize()
    probe_ms = 1e3 * (time.perf_counter() - t0) / FULLGP_PROBE_STEPS
    starts = FULLGP_STARTS if (FULLGP_STARTS * FULLGP_STEPS * probe_ms
                               <= 1e3 * FULLGP_BUDGET_S) else 1
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lt, info = train_full_gp(Xt, yt,
                             torch.Generator(dev).manual_seed(ctx["seed"]),
                             num_starts=starts, steps=FULLGP_STEPS,
                             log_theta0=lt0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    hist = info["history"]
    if not (bool(torch.isfinite(lt).all()) and float(hist[-1])
            < float(hist[0])):
        raise AssertionError(f"train_full_gp: theta {lt.tolist()}, NLL "
                             f"{float(hist[0])} -> {float(hist[-1])}")
    true_lt = pack(*TRUE_THETA, dtype=torch.float64, device=dev)
    out["train"] = {
        "n_train": n, "dtype": "float64", "starts": starts,
        "starts_asked": FULLGP_STARTS, "steps": FULLGP_STEPS,
        "probe_ms_per_step": probe_ms, "budget_s": FULLGP_BUDGET_S,
        "train_s": train_s,
        "ms_per_step": 1e3 * train_s / (starts * FULLGP_STEPS),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
        "theta0": list(th0), "theta": torch.exp(lt).tolist(),
        "true_theta": list(TRUE_THETA[0]) + list(TRUE_THETA[1:]),
        "max_abs_log_theta_from_true": float((lt - true_lt).abs().max()),
        "nll_first_last": [float(hist[0]), float(info["nll"])]}
    return out


def _dac_payloads(mu, var, pv, mask):
    """rBCM's per-agent DAC payloads [beta mu / var, beta / var, beta]
    (M, Nt, 3), as decentralized._poe_family_from_moments builds them."""
    import torch
    m = torch.ones_like(mu) if mask is None else mask.to(mu.dtype)
    beta = 0.5 * (torch.log(pv) - torch.log(var)) * m
    return torch.stack([beta * mu / var, beta / var, beta], dim=-1)


def _agent_readout_gate(method, w0, A, iters, reported):
    """Rerun the engine's DAC on a tile's payloads w0 (M, Nt, 3): the
    largest final spread must be the reported residual, and every agent's
    own estimate of the network sums, M w_i, must lie within M times its
    query's final spread (plus the rounding bound of DAC_ROUND) of the
    exact sums. Returns the largest share of the bound and the spreads."""
    import torch
    from repro_torch.core.consensus import dac
    M = w0.shape[0]
    w, res = dac(w0.reshape(M, -1), A, iters)
    if float(res[-1]) != float(reported):
        raise AssertionError(f"{method}: recomputed DAC residual "
                             f"{float(res[-1])} is not the reported "
                             f"{float(reported)}")
    w = w.reshape(w0.shape).double()
    spread = w.amax(0) - w.amin(0)                        # (Nt, 3)
    exact = w0.double().sum(0)
    rounding = 2 * iters * M * UNIT * w0.double().abs().sum(0)
    bound = M * spread + rounding
    share = float(((M * w - exact).abs() / bound).max())
    if not share <= 1.0:
        raise AssertionError(f"{method}: an agent's own DAC estimate is "
                             f"{share} x its residual bound from the sums")
    return share, spread.amax(-1)


def phase_fleets(ctx):
    """The paper's M = 10, 20, 40 fleets (see the module docstring)."""
    import torch
    from repro_torch.core.consensus import dac_until
    from repro_torch.core.gp import pack, stripe_partition
    from repro_torch.core.prediction import aggregation as agg
    from repro_torch.fleet import FleetConfig, GPFleet
    from repro_torch.kernels import rbf_matvec as K
    dev = torch.device(DEVICE)
    Xp4, yp4, Xq, fq = paper_data(ctx)
    X, y = Xp4.reshape(-1, 2), yp4.reshape(-1)
    n_q = METHOD_TILES * BATCH
    Xq, fq = Xq[:n_q], fq[:n_q]
    Xt = Xq[:BATCH]
    lt = pack(*TRUE_THETA, dtype=torch.float32, device=dev)
    yard = ctx.get("fullgp_rmse")
    out = {"fullgp_rmse": yard, "dtype": "float32",
           "queries_per_method": n_q, "fleets": {}}
    failures = []
    matvec_total = 0

    def gate(fn, *args):
        try:
            return fn(*args)
        except AssertionError as e:
            failures.append(str(e))

    for M in FLEET_SIZES:
        Xp, yp = stripe_partition(X, y, M)
        cfg = FleetConfig(num_agents=M, stream_mean=True)
        assert (cfg.graph, cfg.dac_iters, cfg.jor_iters, cfg.pm_iters,
                cfg.eta_nn, cfg.chunk) == ("path", 200, 500, 100, 0.1,
                                           BATCH), cfg
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fleet = GPFleet(cfg, device=DEVICE).fit(Xp, yp, log_theta0=lt,
                                                train=False)
        torch.cuda.synchronize()
        rep = {"agents": M, "per_agent": int(Xp.shape[1]),
               "fit_ms": 1e3 * (time.perf_counter() - t0), "methods": {}}
        first = {}
        for method in FLEET_METHODS:
            # the DAC family is exact up to rounding at any M: its RMSE is
            # gated; npae / npae_star stop where JOR does (C8), held by
            # their residual bound below, their RMSE reported
            dac_family = method in ("rbcm", "nn_rbcm")
            r, first[method] = _serve_method(
                fleet.predict, method, Xq, fq, cfg.chunk,
                failures if dac_family else [])
            matvec_total += r["rbf_matvec_launches_per_batch"] \
                * METHOD_TILES
            if yard is not None:
                r["rmse_over_fullgp"] = r["rmse_vs_field"] / yard
            rep["methods"][method] = r
        eng, pv = fleet.engine, fleet.fitted.prior_var
        mu, var = eng._moments(fleet.fitted, Xt)

        # the served posterior against its centralized form (rounding)
        shares = {}
        for method in ("rbcm", "nn_rbcm"):
            mask = first[method][2].get("mask")
            shares[method] = gate(
                _check_dac_vs_cen, method, first[method][:2],
                agg.rbcm(mu, var, pv, mask=mask),
                _dac_scales(method, mu, var, pv, mask), cfg.dac_iters, M)
        # any one agent's own estimate, from each query's own residual
        readout = gate(_agent_readout_gate, "rbcm",
                       _dac_payloads(mu, var, pv, None), fleet.A,
                       cfg.dac_iters, first["rbcm"][2]["dac_residual"])
        if readout is not None:
            sh, spread = readout
            rep["agent_readout_share_of_residual_bound"] = sh
            rep["dac_spread_per_query"] = {
                "min": float(spread.min()), "median": float(spread.median()),
                "max": float(spread.max())}
        # npae / npae_star against the centralized NPAE solve
        terms = eng._terms(fleet.fitted, Xt)
        cen = agg.npae(*terms, pv)
        rep["cen_npae_first_tile_rmse"] = _rmse(cen[0], fq[:BATCH])
        gate(_check_rmse, f"M={M} cen_npae", rep["cen_npae_first_tile_rmse"])
        for method in ("npae", "npae_star"):
            bound = _iterative_npae_bound(method, cfg, fleet.A, terms,
                                          first[method][2], UNIT)
            shares[method] = gate(_check_npae, method, first[method][:2],
                                  cen, bound)
            rep["methods"][method]["bound_min_median"] = [
                float(bound.min()), float(bound.median())]
        rep["dec_vs_cen_share_of_bound"] = shares
        del terms, cen

        # diagnostics mode: rbcm's DAC trajectory, predictions unchanged
        eng.set_diagnostics(True)
        m_d, v_d, info_d = fleet.predict(Xt)
        eng.set_diagnostics(False)
        if not (torch.equal(m_d, first["rbcm"][0])
                and torch.equal(v_d, first["rbcm"][1])):
            failures.append(f"M={M}: diagnostics mode changed rbcm's "
                            f"prediction")
        traj = info_d["dac_residuals"]
        rep["rbcm_dac_residual_at_sweep"] = {
            str(k): float(traj[k - 1]) for k in DIAG_SWEEPS}

        # sweeps DAC needs to reach dac_until's tolerance on this tile's
        # payloads (float64: float32's rounding of payloads in the
        # hundreds stays above 1e-9)
        w0 = _dac_payloads(mu, var, pv, None).double().reshape(M, -1)
        t0 = time.perf_counter()
        _, sweeps = dac_until(w0, fleet.A, tol=DAC_UNTIL_TOL)
        torch.cuda.synchronize()
        rep["dac_until"] = {"tol": DAC_UNTIL_TOL, "sweeps": sweeps,
                            "ms": 1e3 * (time.perf_counter() - t0),
                            "initial_spread": float(
                                (w0.amax(0) - w0.amin(0)).max())}

        # rbf_matvec against its plain version on this path's own inputs
        # (the first tile, the fleet's points and weights): comparison
        # launches, after the path's counts were read
        ft = fleet.fitted
        ls = torch.exp(ft.log_theta[:-2])
        sf2 = torch.exp(2 * ft.log_theta[-2:-1])
        got = K.rbf_matvec(Xt, ft.Xp, ft.alpha, ls, sf2)
        want = K.rbf_matvec_plain(Xt, ft.Xp, ft.alpha, ls, sf2)
        scale = K.rbf_matvec_plain(Xt, ft.Xp, ft.alpha.abs(), ls, sf2)
        rep["rbf_matvec_max_rel_err"] = _rel_err(torch, got, want, scale)
        if not rep["rbf_matvec_max_rel_err"] <= REL_TOL:
            failures.append(f"M={M}: rbf_matvec disagrees with its plain "
                            f"version ({rep['rbf_matvec_max_rel_err']})")
        out["fleets"][str(M)] = rep
        del fleet, eng, mu, var, first
        torch.cuda.empty_cache()
    ctx["launches_by_path"]["rbf_matvec"]["fleets"] = int(matvec_total)
    if failures:
        emit({"phase": "fleets", "report_of_a_failed_phase": True, **out})
        raise AssertionError("; ".join(failures))
    return out


def phase_methods(ctx):
    """CBNN, grBCM and dense NPAE on the paper fleet (see the module
    docstring)."""
    import torch
    from repro_torch.core.gp import pack
    from repro_torch.core.prediction import PredictionEngine, fit_experts
    from repro_torch.core.prediction import aggregation as agg
    from repro_torch.core.prediction.decentralized import _rel_jitter
    from repro_torch.core.sparse import SparseExperts
    from repro_torch.core.training import build_training_cache
    from repro_torch.fleet import FleetConfig, GPFleet, get_trainer
    from repro_torch.kernels import nll_grad as G
    from repro_torch.kernels import rbf_gram as RG
    dev = torch.device(DEVICE)
    Xp, yp, Xq, fq = paper_data(ctx)
    n_q = METHOD_TILES * BATCH
    Xq, fq = Xq[:n_q], fq[:n_q]
    lt = pack(*TRUE_THETA, dtype=torch.float32, device=dev)
    cfg = FleetConfig(method="grbcm", stream_mean=True)
    assert (cfg.num_agents, cfg.graph, cfg.dac_iters, cfg.jor_iters,
            cfg.dale_iters, cfg.pm_iters, cfg.eta_nn, cfg.chunk) == \
        (4, "path", 200, 500, 2000, 100, 0.1, BATCH), cfg
    gen = torch.Generator(dev).manual_seed(ctx["seed"] + 7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fleet = GPFleet(cfg, device=DEVICE).fit(Xp, yp, generator=gen,
                                            log_theta0=lt, train=False)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    fit_peak = torch.cuda.max_memory_allocated(dev)
    fa, fc = fleet.fitted_aug, fleet.fitted_comm
    Ni = Xp.shape[1]
    if fa.L.shape != (4, 2 * Ni, 2 * Ni) or fc.L.shape != (1, Ni, Ni) \
            or not all(bool(torch.isfinite(f.L).all())
                       for f in (fleet.fitted, fa, fc)):
        raise AssertionError("the augmented and communication factors are "
                             "not finite of the expected shapes")
    Xc, yc = fleet._comm_data[:2]
    out = {"agents": 4, "per_agent": Ni, "augmented_per_agent": 2 * Ni,
           "communication_points": int(Xc.shape[0]), "dtype": "float32",
           "queries_per_method": n_q, "fit_ms": fit_ms,
           "fit_peak_memory_bytes": fit_peak, "methods": {}}

    # -- every method, served; the first tile kept for the gates ----------
    failures = []

    def gate(fn, *args):
        try:
            return fn(*args)
        except AssertionError as e:
            failures.append(str(e))

    # npae_star from a fleet of its own with enough JOR iterations to
    # converge (NPAE_STAR_JOR_ITERS, C8): the base experts alone
    star_cfg = FleetConfig(method="npae_star", stream_mean=True,
                           jor_iters=NPAE_STAR_JOR_ITERS)
    star = GPFleet(star_cfg, device=DEVICE).fit(Xp, yp, log_theta0=lt,
                                                train=False)
    first = {}
    matvec_total = 0
    for method in NEW_METHODS:
        predict = star.predict if method == "npae_star" else fleet.predict
        rep, first[method] = _serve_method(predict, method, Xq, fq,
                                           cfg.chunk, failures)
        matvec_total += rep["rbf_matvec_launches_per_batch"] * METHOD_TILES
        out["methods"][method] = rep
    out["methods"]["npae_star"]["jor_iters"] = NPAE_STAR_JOR_ITERS

    # -- DAC family == centralized form, same mask (DAC_ROUND) -----------
    eng, Xt = fleet.engine, Xq[:BATCH]
    pv = fleet.fitted.prior_var
    mu, var = eng._moments(fleet.fitted, Xt)
    mu_a, var_a = eng._moments(fa, Xt)
    mu_c, var_c = (t[0] for t in eng._moments(fc, Xt))
    shares = {}
    for method in ("grbcm", "nn_grbcm", "nn_poe", "nn_gpoe", "nn_bcm",
                   "nn_rbcm"):
        mask = first[method][2].get("mask")
        base = method[3:] if method.startswith("nn_") else method
        if base == "grbcm":
            want = agg.grbcm(mu_a, var_a, mu_c, var_c, mask=mask)
            sc = _dac_scales(method, mu_a, var_a, pv, mask, mu_c, var_c)
        else:
            fn = getattr(agg, base)
            want = fn(mu, var, pv, mask=mask) if base in ("bcm", "rbcm") \
                else fn(mu, var, mask=mask)
            sc = _dac_scales(method, mu, var, pv, mask)
        shares[method] = gate(_check_dac_vs_cen, method, first[method][:2],
                              want, sc, cfg.dac_iters, 4)
    # the centralized forms the gates use are what cen_grbcm serves
    if not all(torch.equal(g, w) for g, w in zip(
            first["cen_grbcm"][:2], agg.grbcm(mu_a, var_a, mu_c, var_c))):
        raise AssertionError("cen_grbcm is not aggregation.grbcm of the "
                             "engine's moments")

    # -- NPAE family == its centralized solve, within the residual bound --
    terms = eng._terms(fleet.fitted, Xt)
    cen_npae = first["cen_npae"][:2]
    if not all(torch.equal(g, w) for g, w in zip(
            cen_npae, agg.npae(*terms, pv))):
        raise AssertionError("cen_npae is not aggregation.npae of the "
                             "engine's NPAE terms")
    star_terms = star.engine._terms(star.fitted, Xt)
    cens = {"npae": cen_npae, "npae_star": agg.npae(*star_terms, pv),
            "nn_npae": agg.npae(*terms, pv,
                                mask=first["nn_npae"][2]["mask"])}
    bounds32, npae_bound = {}, {}
    for method in NPAE_ITER:
        fl, tm = (star, star_terms) if method == "npae_star" \
            else (fleet, terms)
        bounds32[method] = _iterative_npae_bound(
            method, fl.config, fl.A, tm, first[method][2], UNIT)
        shares[method] = gate(_check_npae, method, first[method][:2],
                              cens[method], bounds32[method])
        npae_bound[method] = {"min": float(bounds32[method].min()),
                              "median": float(bounds32[method].median())}
    out["dec_vs_cen_share_of_bound"] = shares
    out["npae_bound"] = npae_bound
    del terms, star_terms, cens, star

    # -- the cross-Gram cache: the default guard raises, a raised limit ---
    # -- serves npae as without the cache ---------------------------------
    try:
        fit_experts(lt, Xp, yp, cache_cross=True)
        raise AssertionError("cache_cross at the paper fleet passed the "
                             "default 1,024 MB guard")
    except ValueError as e:
        if "cache_cross would materialize" not in str(e):
            raise
        guard = str(e).split(";")[0]
    t0 = time.perf_counter()
    fcc = fit_experts(lt, Xp, yp, cache_cross=True,
                      cross_cache_limit_mb=CROSS_CACHE_LIMIT_MB)
    torch.cuda.synchronize()
    cc_fit_ms = 1e3 * (time.perf_counter() - t0)
    ecc = PredictionEngine(fcc, fleet.A, chunk=cfg.chunk,
                           dac_iters=cfg.dac_iters, jor_iters=cfg.jor_iters,
                           npae_jitter=cfg.npae_jitter, device=DEVICE)
    ecc.predict("npae", Xt)                                   # warm-up
    torch.cuda.synchronize()
    cc_ms = []
    for i in range(METHOD_TILES):
        t0 = time.perf_counter()
        got = ecc.predict("npae", Xq[i * BATCH:(i + 1) * BATCH])
        torch.cuda.synchronize()
        cc_ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            muN, kA, CA = eng._terms(fleet.fitted, Xt)
            H = _rel_jitter(CA, cfg.npae_jitter)
            bound = _npae_bound(H, kA, torch.stack([muN.T, kA.T], -1),
                                0.0, cfg.dac_iters,
                                omega=(2.0 / 4) * 0.999)
            shares["npae_cache_cross"] = gate(
                _check_npae, "npae with cache_cross", got[:2],
                first["npae"][:2], bound)
            del muN, kA, CA, H
    out["cache_cross"] = {
        "default_guard": guard, "limit_mb": CROSS_CACHE_LIMIT_MB,
        "kcross_bytes": fcc.Kcross.numel() * fcc.Kcross.element_size(),
        "fit_ms": cc_fit_ms, "npae_batch_ms": cc_ms,
        "npae_mean_batch_ms": sum(cc_ms) / len(cc_ms)}
    del fcc, ecc
    torch.cuda.empty_cache()

    # -- one tile per method against the same port in float64 -------------
    kw = dict(log_theta0=lt.double(), train=False)
    f64 = GPFleet(cfg, device=DEVICE).fit(
        Xp.double(), yp.double(), comm_data=(Xc.double(), yc.double()), **kw)
    star64 = GPFleet(star_cfg, device=DEVICE).fit(Xp.double(), yp.double(),
                                                  **kw)
    tile64 = {method: (star64 if method == "npae_star" else f64).predict(
        Xt.double(), method=method) for method in NEW_METHODS}
    # npae_star: each run within its residual bound of the exact solve, so
    # the two within the sum of their bounds
    star_bound = bounds32["npae_star"] + _iterative_npae_bound(
        "npae_star", star_cfg, star64.A,
        star64.engine._terms(star64.fitted, Xt.double()),
        tile64["npae_star"][2], 2.0 ** -53)
    f32_vs_f64 = {}
    for method in NEW_METHODS:
        m64, v64, _ = tile64[method]
        m32, v32 = first[method][:2]
        em = (m32.double() - m64).abs()
        ev = (v32.double() - v64).abs()
        rep = {"max_abs_mean": float(em.max()), "max_abs_var": float(ev.max()),
               "max_share_of_fixed_tolerance": float(
                   (em / F32_MEAN_TOL).maximum(ev / F32_VAR_TOL).max())}
        tol_m = torch.full_like(em, F32_MEAN_TOL)
        tol_v = torch.full_like(ev, F32_VAR_TOL)
        if method == "npae_star":
            tol_m, tol_v = tol_m.maximum(star_bound), \
                tol_v.maximum(star_bound)
            rep["max_share_of_tolerance"] = float(
                (em / tol_m).maximum(ev / tol_v).max())
            rep["bound_min"] = float(star_bound.min())
            rep["bound_median"] = float(star_bound.median())
        f32_vs_f64[method] = rep
        if not (bool((em <= tol_m).all()) and bool((ev <= tol_v).all())):
            failures.append(f"{method}: float32 tile {rep} from float64 "
                            f"beyond its tolerance")
    out["f32_vs_f64_first_tile"] = f32_vs_f64
    del f64, star64, tile64, bounds32, star_bound
    torch.cuda.empty_cache()

    # -- gapx and dec-gapx at 16,200 points per agent ---------------------
    # the registry's training loops on the fleet's augmented data, as
    # GPFleet.fit(train=True, grad_fn="fused") runs them, without its
    # serving factorization (three iterations from theta0 leave the float32
    # Cholesky of 8,100 points at an unconverged theta to chance). "fused"
    # forces the cached-geometry gradient through nll_grad past the
    # reference's 4,096 MB guard: the diff^2 stacks take 8,009 MB here, and
    # by default both packages would take autodiff gradients instead
    Xa, ya = fleet._comm_data[2:]
    th0 = cfg.theta0
    lt0 = pack(list(th0[:-2]), th0[-2], th0[-1], dtype=torch.float32,
               device=dev)
    train = {}
    for trainer in ("gapx", "dec-gapx"):
        tcfg = FleetConfig(trainer=trainer, admm_iters=GAPX_ITERS,
                           kappa=GAPX_KAPPA, lipschitz=GAPX_KAPPA)
        spec = get_trainer(trainer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        G.reset_launches()
        t0 = time.perf_counter()
        lt_t, thetas, info = spec.run(tcfg, lt0, Xa, ya, fleet.A,
                                      grad_fn="fused")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = G.launches
        peak = torch.cuda.max_memory_allocated(dev)
        if launches != GAPX_ITERS:
            raise AssertionError(f"{trainer}: nll_grad launched {launches} "
                                 f"times in {GAPX_ITERS} iterations")
        t0 = time.perf_counter()
        build_training_cache(Xa, ya)
        torch.cuda.synchronize()
        cache_s = time.perf_counter() - t0
        train[trainer] = {
            "iters": GAPX_ITERS, "kappa": tcfg.kappa,
            "lipschitz": tcfg.lipschitz, "points_per_agent": int(Xa.shape[1]),
            "nll_grad_launches": launches, "run_ms": 1e3 * run_s,
            "ms_per_iteration": 1e3 * (run_s - cache_s) / GAPX_ITERS,
            "training_cache_ms": 1e3 * cache_s, "peak_memory_bytes": peak,
            "theta0": list(th0), "theta": torch.exp(lt_t).tolist(),
            "thetas_per_agent": torch.exp(thetas).tolist(),
            "theta_finite": bool(torch.isfinite(thetas).all()),
            "residuals": info["residuals"].tolist()}
        ctx["launches_by_path"]["nll_grad"][trainer] = launches
        if not train[trainer]["theta_finite"]:
            failures.append(f"{trainer}: non-finite theta after "
                            f"{GAPX_ITERS} iterations")
        del lt_t, thetas, info
        torch.cuda.empty_cache()
    out["train"] = train

    # -- grbcm and nn_rbcm from the sparse m = 512 fleet (float64 data) ----
    scfg = FleetConfig(method="grbcm", sparse_m=SPARSE_M, stream_mean=True)
    kw = dict(comm_data=(Xc.double(), yc.double()), log_theta0=lt.double(),
              train=False)
    GPFleet(scfg, device=DEVICE).fit(Xp.double(), yp.double(), **kw)
    torch.cuda.synchronize()
    RG.reset_launches()
    t0 = time.perf_counter()
    sfl = GPFleet(scfg, device=DEVICE).fit(Xp.double(), yp.double(), **kw)
    torch.cuda.synchronize()
    sfit_ms = 1e3 * (time.perf_counter() - t0)
    panels = 2 * -(-Ni // KMN_PANEL) + -(-2 * Ni // KMN_PANEL)
    if RG.launches != panels or not isinstance(sfl.fitted_aug,
                                               SparseExperts):
        raise AssertionError(f"the sparse grbcm fit launched rbf_gram "
                             f"{RG.launches} times for {panels} panels")
    ctx["launches_by_path"]["rbf_gram"]["methods_sparse_grbcm"] = \
        RG.launches
    sparse = {"fit_ms": sfit_ms, "rbf_gram_launches": RG.launches,
              "panels": panels}
    for method in ("grbcm", "nn_rbcm"):
        rep, _ = _serve_method(sfl.predict, method, Xq.double(), fq,
                               scfg.chunk, failures)
        matvec_total += rep["rbf_matvec_launches_per_batch"] * METHOD_TILES
        sparse[method] = rep
    out["sparse_m512"] = sparse
    del sfl
    ctx["launches_by_path"]["rbf_matvec"]["methods"] = int(matvec_total)
    ctx["methods_fleet"] = fleet
    torch.cuda.empty_cache()
    if failures:
        # the phase fails; its measurements are printed first
        emit({"phase": "methods", "report_of_a_failed_phase": True, **out})
        raise AssertionError("; ".join(failures))
    return out


def phase_train(ctx):
    import torch
    from repro_torch.core.consensus import path_graph
    from repro_torch.core.gp import inner_from_cov, nll, pack
    from repro_torch.core.gp.nll import INVERSE_EDGE, _inner_blocked, cholesky
    from repro_torch.core.training import (build_training_cache,
                                           cov_from_cache, train_dec_apx_gp)
    from repro_torch.fleet import FleetConfig, GPFleet
    from repro_torch.kernels import nll_grad as G
    from repro_torch.kernels import rbf_matvec as K
    from repro_torch.obs import (TraceRecorder, parse_prometheus_text,
                                 prometheus_text)
    dev = torch.device(DEVICE)
    Xp, yp, Xq, fq = paper_data(ctx)
    Xq, fq = Xq[:BIG], fq[:BIG]
    cfg = FleetConfig(stream_mean=True, kappa=TRAIN_KAPPA)
    assert (cfg.trainer, cfg.theta0, cfg.rho, cfg.admm_iters,
            cfg.num_agents, cfg.graph) == ("dec-apx", (2.0, 0.5, 1.0, 1.0),
                                           500.0, 100, 4, "path"), cfg
    th0 = cfg.theta0
    lt0 = pack(list(th0[:-2]), th0[-2], th0[-1], dtype=torch.float32,
               device=dev)
    nll0 = float(nll(lt0, Xp, yp).sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # the training path, traced: counts reset just before, read just after
    rec = TraceRecorder()
    G.reset_launches()
    K.reset_launches()
    t0 = time.perf_counter()
    fleet = GPFleet(cfg, device=DEVICE).fit(Xp, yp, train=True, trace=rec)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    mean, var, _ = fleet.predict(Xq)
    torch.cuda.synchronize()
    predict_ms = 1e3 * (time.perf_counter() - t0)
    launches = {"nll_grad": G.launches, "rbf_matvec": K.launches}
    peak = torch.cuda.max_memory_allocated(dev)

    if launches["nll_grad"] != cfg.admm_iters:
        raise AssertionError(f"nll_grad launched {launches['nll_grad']} "
                             f"times in {cfg.admm_iters} ADMM iterations")
    tiles = -(-BIG // cfg.chunk)
    if launches["rbf_matvec"] != tiles:
        raise AssertionError(f"rbf_matvec launched {launches['rbf_matvec']}"
                             f" times for {tiles} query tiles")
    lt = fleet.log_theta
    if not (bool(torch.isfinite(fleet.thetas).all())
            and bool(torch.isfinite(lt).all())):
        raise AssertionError(f"trained theta is not finite: {fleet.thetas}")
    nll_trained = float(nll(lt, Xp, yp).sum())
    if not nll_trained < nll0:
        raise AssertionError(f"sum of NLL did not fall: {nll0} at theta0, "
                             f"{nll_trained} trained")
    if mean.shape != (BIG,) or not bool(torch.isfinite(mean).all()) \
            or not bool((var > 0).all()):
        raise AssertionError("served moments are not finite and positive "
                             "of the expected shape")
    rmse = float(torch.sqrt(((mean - fq) ** 2).mean()))
    if not rmse < RMSE_LIMIT:
        raise AssertionError(f"RMSE {rmse} against the noise-free field "
                             f"is not below {RMSE_LIMIT}")
    ctx["launches"]["nll_grad"] = launches["nll_grad"]
    ctx["trained_theta"] = lt
    trace = rec.last()
    if not (len(rec) == 1 and trace["nll"].shape == (cfg.admm_iters, 4)
            and trace["primal_residuals"].shape == (cfg.admm_iters,)
            and trace["theta_trajectory"].shape[0] == cfg.admm_iters):
        shapes = {k: getattr(v, "shape", v) for k, v in trace.items()}
        raise AssertionError(f"the fit's trace is not the trainer's "
                             f"{cfg.admm_iters} iterations: {shapes}")
    # the metrics the fleet reports parse back from the Prometheus text
    snap = fleet.metrics()
    fams = parse_prometheus_text(prometheus_text())
    for name, m in snap.items():
        if name == "fleet" or m["kind"] != "counter":
            continue
        got = {tuple(sorted(x["labels"].items())): x["value"]
               for x in m["series"]}
        # a counter with no series yet (the engine's degraded-mode
        # counters before any degraded prediction) has no sample lines
        back = {tuple(sorted(lb.items())): v
                for lb, v in fams.get(name, [])}
        if got != back:
            raise AssertionError(f"{name}: metrics() {got} != Prometheus "
                                 f"text {back}")

    # CHECK_ITERS iterations with the kernel against the same loop with the
    # plain version swapped in through the grad_fn hook: in float64, then in
    # float32 (the kernel path timed, cache build apart); see THETA_TOL
    A = path_graph(cfg.num_agents)
    kw = dict(rho=cfg.rho, kappa=cfg.kappa, iters=CHECK_ITERS)
    X64, y64, lt64 = Xp.double(), yp.double(), lt0.double()
    th_kernel64, _ = train_dec_apx_gp(lt64, X64, y64, A, **kw)
    th_plain64, _ = train_dec_apx_gp(lt64, X64, y64, A,
                                     grad_fn=plain_local_grad, **kw)
    del X64, y64
    kernel_vs_plain = float((th_kernel64 - th_plain64).abs().max())
    if not kernel_vs_plain <= THETA_TOL:
        raise AssertionError(f"after {CHECK_ITERS} float64 iterations the "
                             f"kernel path's log theta is {kernel_vs_plain} "
                             f"from the plain path's (> {THETA_TOL})")
    t0 = time.perf_counter()
    build_training_cache(Xp, yp)
    torch.cuda.synchronize()
    cache_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    th_kernel, _ = train_dec_apx_gp(lt0, Xp, yp, A, **kw)
    torch.cuda.synchronize()
    iter_ms = (1e3 * (time.perf_counter() - t0) - cache_ms) / CHECK_ITERS
    # the same iterations with the trace's diagnostics (diag=True: per-agent
    # NLL at every iterate) and the recorder's host copy
    t0 = time.perf_counter()
    th_diag, info_diag = train_dec_apx_gp(lt0, Xp, yp, A, diag=True, **kw)
    TraceRecorder().record("dec-apx", info_diag)
    torch.cuda.synchronize()
    iter_ms_traced = (1e3 * (time.perf_counter() - t0) - cache_ms) \
        / CHECK_ITERS
    if not torch.equal(th_diag, th_kernel):
        raise AssertionError("the diagnostics changed the trained theta")
    th_plain, _ = train_dec_apx_gp(lt0, Xp, yp, A, grad_fn=plain_local_grad,
                                   **kw)
    kernel_vs_plain32 = float((th_kernel - th_plain).abs().max())
    f32_error = float((th_plain.double() - th_plain64).abs().max())
    if not kernel_vs_plain32 <= f32_error:
        raise AssertionError(f"after {CHECK_ITERS} float32 iterations the "
                             f"kernel path's log theta is {kernel_vs_plain32}"
                             f" from the plain path's, more than float32's "
                             f"own error ({f32_error})")

    # the paper's kappa at this size, in float64 with the plain version:
    # reported, not gated (see TRAIN_KAPPA)
    _, paper = train_dec_apx_gp(lt0.double(), Xp.double(), yp.double(), A,
                                rho=cfg.rho, kappa=FleetConfig().kappa,
                                iters=PAPER_KAPPA_ITERS,
                                grad_fn=plain_local_grad)
    paper_res = paper["residuals"]

    # the three library routes to C^-1 at theta0 and the blocked route to
    # inner (inner_from_cov's above INVERSE_EDGE, alpha included), one call
    # each after a warm-up
    C, _ = cov_from_cache(lt0.expand(cfg.num_agents, -1),
                          build_training_cache(Xp, yp).d2u)
    L = cholesky(C)
    eye = torch.eye(L.shape[-1], device=dev)

    def trsm_matmul():
        Li = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
        return Li.mT @ Li
    inverse_ms = {
        "solve_triangular_matmul": cuda_ms(trsm_matmul, 1, warmup=1),
        "cholesky_solve": cuda_ms(lambda: torch.cholesky_solve(eye, L), 1,
                                  warmup=1),
        "cholesky_inverse": cuda_ms(lambda: torch.cholesky_inverse(L), 1,
                                    warmup=1),
        "blocked": cuda_ms(lambda: _inner_blocked(L, yp, INVERSE_EDGE), 1,
                           warmup=1),
        "cholesky": cuda_ms(lambda: torch.linalg.cholesky_ex(C), 1,
                            warmup=1),
        "inner_from_cov": cuda_ms(lambda: inner_from_cov(C, yp), 1,
                                  warmup=1)}
    del C, L

    true_lt = pack(*TRUE_THETA, dtype=torch.float32, device=dev)
    return {"n_train": N_TRAIN, "agents": cfg.num_agents,
            "per_agent": int(Xp.shape[1]), "trainer": cfg.trainer,
            "admm_iters": cfg.admm_iters, "rho": cfg.rho,
            "kappa": cfg.kappa, "dtype": "float32", "queries": BIG,
            "fit_ms": fit_ms, "ms_per_admm_iteration": iter_ms,
            "ms_per_admm_iteration_traced": iter_ms_traced,
            "trace_summary": rec.summary(),
            "metrics_counters": {k: m["series"] for k, m in snap.items()
                                 if k != "fleet" and m["kind"] == "counter"},
            "metrics_fleet": snap["fleet"],
            "training_cache_ms": cache_ms,
            "nll_grad_ms_share_of_iteration":
                ctx["nll_grad"]["ms"] / iter_ms,
            "predict_4096_ms": predict_ms, "peak_memory_bytes": peak,
            "nll_grad_launches": launches["nll_grad"],
            "rbf_matvec_launches": launches["rbf_matvec"],
            "theta0": list(th0), "trained_theta": torch.exp(lt).tolist(),
            "trained_thetas_per_agent": torch.exp(fleet.thetas).tolist(),
            "true_theta": torch.exp(true_lt).tolist(),
            "max_abs_log_theta_from_true": float((lt - true_lt).abs().max()),
            "sum_nll_theta0": nll0, "sum_nll_trained": nll_trained,
            "final_residual": float(fleet.train_info["residuals"][-1]),
            "rmse_vs_field": rmse,
            "check_iters": CHECK_ITERS, "theta_tol": THETA_TOL,
            "max_abs_log_theta_kernel_vs_plain_f64": kernel_vs_plain,
            "max_abs_log_theta_kernel_vs_plain_f32": kernel_vs_plain32,
            "max_abs_log_theta_f32_kernel_vs_f64_plain":
                float((th_kernel.double() - th_plain64).abs().max()),
            "max_abs_log_theta_f32_plain_vs_f64_plain": f32_error,
            "inverse_route_ms": inverse_ms,
            "paper_kappa": FleetConfig().kappa,
            "paper_kappa_residuals": paper_res.tolist(),
            "trained_kappa_residuals_last": fleet.train_info["residuals"]
            [-PAPER_KAPPA_ITERS:].tolist()}


def _rel_per_agent(a, b) -> float:
    """max over agents of max |a - b| / max |b| (b the reference)."""
    dims = tuple(range(1, b.dim()))
    return float(((a.double() - b.double()).abs().amax(dims)
                  / b.double().abs().amax(dims).clamp_min(1e-30)).max())


def phase_online(ctx):
    import torch
    from repro_torch.core.consensus import is_connected
    from repro_torch.core.gp import pack
    from repro_torch.core.online import OnlineExperts, refit
    from repro_torch.core.gp.nll import cho_solve
    from repro_torch.core.online.experts import _fwd_solve
    from repro_torch.core.prediction import PredictionEngine
    from repro_torch.fleet import FleetConfig, GPFleet
    from repro_torch.kernels import cholupdate as C
    from repro_torch.kernels import nll_grad as G
    from repro_torch.kernels import rbf_matvec as K
    from repro_torch.kernels.ops import cholupdate_fleet
    dev = torch.device(DEVICE)
    Xp, yp, Xq, fq = paper_data(ctx)
    xs, ys, Xj, yj = online_data(ctx)
    Xb, fb = Xq[:BIG], fq[:BIG]
    lt = pack(*TRUE_THETA, dtype=torch.float32, device=dev)
    cfg = FleetConfig(online=True, window=WINDOW, stream_mean=True,
                      kappa=TRAIN_KAPPA)
    assert (cfg.num_agents, cfg.graph, cfg.method, cfg.chunk,
            cfg.trainer) == (4, "path", "rbcm", 256, "dec-apx"), cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fleet = GPFleet(cfg, device=DEVICE).fit(Xp, yp, log_theta0=lt,
                                            train=False)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    fleet.predict(Xq[:BATCH])                       # warm-up
    torch.cuda.synchronize()
    engine = fleet.engine
    kept = (engine.A.data_ptr(), engine.fitted.log_theta.data_ptr())

    # the streaming path: counts reset just before, read just after
    C.reset_launches()
    K.reset_launches()
    G.reset_launches()
    round_ms, round_launches, batch_ms, sq_err = [], [], [], []
    t_all = time.perf_counter()
    for r in range(STREAM_ROUNDS):
        before = C.launches
        t0 = time.perf_counter()
        fleet.observe(xs[r], ys[r])
        torch.cuda.synchronize()
        round_ms.append(1e3 * (time.perf_counter() - t0))
        round_launches.append(C.launches - before)
        if (r + 1) % SERVE_EVERY == 0:
            q0 = (len(batch_ms) * BATCH) % Xq.shape[0]
            t0 = time.perf_counter()
            m, _, _ = fleet.predict(Xq[q0:q0 + BATCH])
            torch.cuda.synchronize()
            batch_ms.append(1e3 * (time.perf_counter() - t0))
            sq_err.append((m - fq[q0:q0 + BATCH]) ** 2)
    stream_s = time.perf_counter() - t_all
    C.check_faults()                  # no eviction's watchdog fired
    launches = {"cholupdate": C.launches, "rbf_matvec": K.launches,
                "nll_grad": G.launches}
    peak = torch.cuda.max_memory_allocated(dev)

    if round_launches != [1] * STREAM_ROUNDS:
        raise AssertionError(f"cholupdate launches per observe round: "
                             f"{round_launches}")
    if launches["rbf_matvec"] != len(batch_ms) * -(-BATCH // cfg.chunk) \
            or launches["nll_grad"]:
        raise AssertionError(f"launches while streaming: {launches}")
    if not bool((fleet.window_counts == WINDOW).all()):
        raise AssertionError(f"window counts {fleet.window_counts}")
    if fleet.engine is not engine or kept != (
            engine.A.data_ptr(), engine.fitted.log_theta.data_ptr()) \
            or engine.fitted.L is not fleet.fitted.L:
        raise AssertionError("the stream rebuilt the engine or its "
                             "adjacency instead of swapping the factors")
    rmse_stream = float(torch.sqrt(torch.cat(sq_err).mean()))
    if not rmse_stream < RMSE_LIMIT:
        raise AssertionError(f"RMSE {rmse_stream} while streaming is not "
                             f"below {RMSE_LIMIT}")

    # one round's parts on the live windows: the rank-1 update, and the
    # append's solve with alpha's two
    st = fleet._online_state
    full = st.count >= WINDOW
    chol_ms = cuda_ms(lambda: cholupdate_fleet(st.L, st.L[:, :, 0],
                                               shift=1, active=full), 5,
                      warmup=1)
    solves_ms = cuda_ms(lambda: (_fwd_solve(st.L, st.yw),
                                 cho_solve(st.L, st.yw)), 5, warmup=1)

    # the streamed windows against a float32 and a float64 refit of them
    ref32 = refit(st)
    ref64 = refit(OnlineExperts(*(t.double() if t.is_floating_point()
                                  else t for t in st)))
    errs = {}
    for name in ("L", "alpha"):
        a, r32, r64 = (getattr(s_, name) for s_ in (st, ref32, ref64))
        errs[name] = {"stream_vs_refit32": _rel_per_agent(a, r32),
                      "stream_vs_refit64": _rel_per_agent(a, r64),
                      "refit32_vs_refit64": _rel_per_agent(r32, r64)}
    del ref32
    engine64 = PredictionEngine(ref64.to_fitted(), fleet.A, chunk=cfg.chunk,
                                dac_iters=cfg.dac_iters, stream_mean=False,
                                device=DEVICE)
    m64 = engine64.predict("rbcm", Xb.double())[0]
    del engine64, ref64
    fresh = GPFleet(FleetConfig(stream_mean=True), A=fleet.A,
                    device=DEVICE).fit(st.Xw, st.yw, log_theta0=lt,
                                       train=False)
    m_fresh = fresh.predict(Xb)[0]
    del fresh
    m_stream = fleet.predict(Xb)[0]
    errs["mean"] = {
        "stream_vs_fresh32": float((m_stream - m_fresh).abs().max()),
        "stream_vs_fresh64": float((m_stream.double() - m64).abs().max()),
        "fresh32_vs_fresh64": float((m_fresh.double() - m64).abs().max())}
    torch.cuda.empty_cache()
    for name, ref in (("L", "refit"), ("alpha", "refit"), ("mean", "fresh")):
        e = errs[name]
        if not e[f"stream_vs_{ref}64"] <= \
                F32_FACTOR * e[f"{ref}32_vs_{ref}64"]:
            raise AssertionError(f"streamed {name} is further from float64 "
                                 f"than {F32_FACTOR} x float32's own error: "
                                 f"{e}")

    # drift: DEC-apx-GP on the live windows, refit, swap
    G.reset_launches()
    C.reset_launches()
    t0 = time.perf_counter()
    info = fleet.drift(iters=DRIFT_ITERS)
    torch.cuda.synchronize()
    drift_ms = 1e3 * (time.perf_counter() - t0)
    drift_launches = {"nll_grad": G.launches, "cholupdate": C.launches}
    if drift_launches != {"nll_grad": DRIFT_ITERS, "cholupdate": 0}:
        raise AssertionError(f"drift launches {drift_launches} for "
                             f"{DRIFT_ITERS} iterations")
    if fleet.engine is not engine or not bool(
            torch.isfinite(fleet.log_theta).all()):
        raise AssertionError("drift rebuilt the engine or left a "
                             "non-finite theta")
    m_drift = fleet.predict(Xb)[0]
    rmse_drift = float(torch.sqrt(((m_drift - fb) ** 2).mean()))

    # membership: one agent joins with WINDOW points, agent 1 leaves
    t0 = time.perf_counter()
    fleet.join(Xj, yj)
    fleet.leave(1)
    torch.cuda.synchronize()
    membership_ms = 1e3 * (time.perf_counter() - t0)
    if fleet.num_agents != 4 or not is_connected(fleet.A) \
            or fleet.engine is not engine:
        raise AssertionError("join/leave left a wrong fleet or graph")
    st = fleet._online_state
    m_mem = fleet.predict(Xb)[0]
    fresh = GPFleet(FleetConfig(stream_mean=True), A=fleet.A,
                    device=DEVICE).fit(st.Xw, st.yw,
                                       log_theta0=fleet.log_theta,
                                       train=False)
    mem_err = float((m_mem - fresh.predict(Xb)[0]).abs().max())
    del fresh
    rmse_mem = float(torch.sqrt(((m_mem - fb) ** 2).mean()))
    if not (rmse_drift < RMSE_LIMIT and rmse_mem < RMSE_LIMIT):
        raise AssertionError(f"RMSE after drift {rmse_drift}, after "
                             f"join/leave {rmse_mem}: not below "
                             f"{RMSE_LIMIT}")
    if not mem_err <= errs["mean"]["fresh32_vs_fresh64"]:
        raise AssertionError(f"after join/leave the means are {mem_err} "
                             f"from a fresh fleet on the same windows")
    torch.cuda.empty_cache()

    ctx["launches"]["cholupdate"] = launches["cholupdate"]
    ctx["online_fleet"], ctx["online_round"] = fleet, (xs[0], ys[0])
    n_obs = STREAM_ROUNDS * cfg.num_agents
    mean_round = sum(round_ms) / len(round_ms)
    return {"agents": cfg.num_agents, "window": WINDOW, "dtype": "float32",
            "rounds": STREAM_ROUNDS, "serve_every": SERVE_EVERY,
            "fit_ms": fit_ms, "stream_s": stream_s,
            "observations_per_s": n_obs / stream_s,
            "queries_per_s_while_streaming": len(batch_ms) * BATCH / stream_s,
            "mean_observe_round_ms": mean_round,
            "max_observe_round_ms": max(round_ms),
            "cholupdate_ms_per_round": chol_ms,
            "solves_ms_per_round": solves_ms,
            "rest_ms_per_round": mean_round - chol_ms - solves_ms,
            "mean_batch_ms_while_streaming": sum(batch_ms) / len(batch_ms),
            "peak_memory_bytes": peak, "stream_launches": launches,
            "rmse_vs_field_while_streaming": rmse_stream,
            "f32_factor": F32_FACTOR, "errors_vs_refit": errs,
            "drift_iters": DRIFT_ITERS, "drift_ms": drift_ms,
            "drift_launches": drift_launches,
            "drift_final_residual": float(info["residuals"][-1]),
            "theta_after_drift": torch.exp(fleet.log_theta).tolist(),
            "rmse_vs_field_after_drift": rmse_drift,
            "join_leave_ms": membership_ms,
            "max_abs_mean_vs_fresh_after_join_leave": mem_err,
            "rmse_vs_field_after_join_leave": rmse_mem}


def big_data(ctx):
    """The reference's 100k-per-agent fleet on the card: 4 x BIG_NI
    points of the paper field (the same field draw as paper_data, noise
    sigma_eps), stripe-partitioned, and SCALE_QUERIES held-out queries with
    their noise-free values. The field is evaluated FIELD_CHUNK points at a
    time: at once, its (N, 4,096) features would take 6.6 GB twice over.
    Returns (Xp (4, BIG_NI, 2), yp (4, BIG_NI), Xq, fq), float32."""
    if "big" not in ctx:
        import torch
        from repro_torch.core.gp import stripe_partition
        from repro_torch.data import random_inputs
        paper_data(ctx)
        field, dev = ctx["field"], torch.device(DEVICE)
        gen = torch.Generator(dev).manual_seed(ctx["seed"] + 5)
        n = 4 * BIG_NI
        X = random_inputs(gen, n + SCALE_QUERIES, dtype=torch.float32)
        f = torch.cat([field(X[i:i + FIELD_CHUNK])
                       for i in range(0, X.shape[0], FIELD_CHUNK)])
        y = f + TRUE_THETA[2] * torch.randn(
            X.shape[0], generator=gen, dtype=torch.float32, device=dev)
        Xp, yp = stripe_partition(X[:n], y[:n], 4)
        ctx["big"] = (Xp, yp, X[n:], f[n:])
    return ctx["big"]


def _f32_record(cfg, Xp, yp, lt, Xq, fq):
    """The float32 run of the 100k fleet, for the record (SPARSE_F32): fit
    at lt, serve Xq by rBCM, report whether the factors are finite and the
    RMSE. Not gated; an error on the way (torch.linalg.eigh may refuse a
    NaN matrix on the card) is reported as it is."""
    from repro_torch.fleet import GPFleet
    try:
        fl = GPFleet(cfg, device=DEVICE).fit(Xp, yp, log_theta0=lt,
                                             train=False)
        return {"factors_finite": _finite(fl.fitted),
                "rmse_vs_field": _rmse(fl.predict(Xq)[0], fq)}
    except RuntimeError as e:
        return {"error": f"{type(e).__name__}: {e}"[:300]}


def _finite(fitted) -> bool:
    import torch
    return all(bool(torch.isfinite(t).all()) for t in fitted)


def _rmse(mean, f) -> float:
    import torch
    return float(torch.sqrt(((mean.double() - f.double()) ** 2).mean()))


def _check_rmse(name, rmse):
    if not rmse < RMSE_LIMIT:
        raise AssertionError(f"{name}: RMSE {rmse} against the noise-free "
                             f"field is not below {RMSE_LIMIT}")


def phase_sparse(ctx):
    import torch
    from repro_torch.core.gp import pack
    from repro_torch.core.sparse import (SparseExperts, fit_sparse_experts,
                                         select_inducing,
                                         sparse_moments_cached)
    from repro_torch.fleet import FleetConfig, GPFleet
    from repro_torch.kernels import rbf_gram as RG
    from repro_torch.kernels import rbf_matvec as K
    dev = torch.device(DEVICE)
    Xp32, yp32, Xq, fq = paper_data(ctx)
    lt32 = pack(*TRUE_THETA, dtype=torch.float32, device=dev)
    Xp, yp, lt, Xq64 = Xp32.double(), yp32.double(), lt32.double(), \
        Xq.double()
    n_query = N_BATCHES * BATCH + BIG
    panels = -(-Xp.shape[1] // KMN_PANEL)
    cfg = FleetConfig(sparse_m=SPARSE_M, stream_mean=True)
    out = {"sparse_m": SPARSE_M, "kmn_panel": KMN_PANEL}

    # -- serve -------------------------------------------------------------
    # warm-up: the first float64 fit sets up cuSOLVER's eigh, which the
    # timed fit should not pay
    GPFleet(cfg, device=DEVICE).fit(Xp, yp, log_theta0=lt, train=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    # the sparse serving path: counts reset just before, read just after
    RG.reset_launches()
    K.reset_launches()
    t0 = time.perf_counter()
    fleet = GPFleet(cfg, device=DEVICE).fit(Xp, yp, log_theta0=lt,
                                            train=False)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    fit_launches = RG.launches
    if not isinstance(fleet.fitted, SparseExperts) or \
            not _finite(fleet.fitted):
        raise AssertionError("the sparse fleet's factors are not finite "
                             "SparseExperts")
    if fit_launches != panels:
        raise AssertionError(f"rbf_gram launched {fit_launches} times for "
                             f"{panels} panels of the fit")
    fleet.predict(Xq64[:BATCH])                       # warm-up
    fleet.predict(Xq64[:BATCH], method="npae_sparse")
    torch.cuda.synchronize()
    K.reset_launches()
    batch_ms, means = [], []
    t_all = time.perf_counter()
    for i in range(N_BATCHES):
        t0 = time.perf_counter()
        means.append(fleet.predict(Xq64[i * BATCH:(i + 1) * BATCH])[0])
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    means.append(fleet.predict(Xq64[N_BATCHES * BATCH:])[0])
    torch.cuda.synchronize()
    big_ms = 1e3 * (time.perf_counter() - t0)
    total_s = time.perf_counter() - t_all
    matvec_launches = K.launches
    t0 = time.perf_counter()
    npae_mean, npae_var, _ = fleet.predict(Xq64[:BIG], method="npae_sparse")
    torch.cuda.synchronize()
    npae_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    mean = torch.cat(means)
    tiles = N_BATCHES * -(-BATCH // cfg.chunk) + -(-BIG // cfg.chunk)
    if matvec_launches != tiles:
        raise AssertionError(f"rbf_matvec launched {matvec_launches} times "
                             f"for {tiles} query tiles of the sparse fleet")
    if RG.launches != fit_launches:
        raise AssertionError("serving launched rbf_gram")
    # the streamed agent means of the served queries against the float64
    # plain path (k(Xs, Z) c by einsum), relative to the summed |terms|
    f = fleet.fitted
    stream_mu = fleet.engine.posterior_means_streamed(Xq64)
    plain_mu, _ = sparse_moments_cached(f.log_theta, f.Z, f.Lmm, f.LS, f.c,
                                        Xq64)
    terms, _ = sparse_moments_cached(f.log_theta, f.Z, f.Lmm, f.LS,
                                     f.c.abs(), Xq64)
    stream_err = _rel_err(torch, stream_mu, plain_mu, terms)
    if not stream_err <= REL_TOL:
        raise AssertionError(f"the sparse fleet's streamed means are "
                             f"{stream_err} from the float64 plain path, "
                             f"relative to the summed |terms|")
    if mean.shape != (n_query,) or not bool(torch.isfinite(mean).all()) \
            or not bool((npae_var > 0).all()):
        raise AssertionError("sparse served moments are not finite of the "
                             "expected shape")
    rmse, rmse_npae = _rmse(mean, fq), _rmse(npae_mean, fq[:BIG])
    _check_rmse("sparse rbcm", rmse)
    _check_rmse("npae_sparse", rmse_npae)
    dense_diff = None
    if "fleet" in ctx:
        dense = ctx["fleet"].predict(Xq)[0]
        dense_diff = float((mean - dense.double()).abs().max())
    ctx["launches"]["rbf_gram"] = fit_launches
    ctx["sparse_fleet"] = fleet
    out["serve"] = {
        "n_train": N_TRAIN, "agents": cfg.num_agents,
        "per_agent": int(Xp.shape[1]), "dtype": "float64 data, float32 "
        "kernel", "fit_ms": fit_ms, "rbf_gram_launches": fit_launches,
        "panels": panels, "batch_ms": batch_ms,
        "mean_batch_ms": sum(batch_ms) / len(batch_ms),
        "big_call_ms": big_ms, "queries_per_s": n_query / total_s,
        "rbf_matvec_launches": matvec_launches, "query_tiles": tiles,
        "npae_sparse_4096_ms": npae_ms, "peak_memory_bytes": peak,
        "rmse_vs_field_rbcm": rmse, "rmse_vs_field_npae_sparse": rmse_npae,
        "max_rel_err_streamed_means_vs_float64_plain": stream_err,
        "max_abs_rbcm_mean_vs_dense_fleet": dense_diff,
        "tr_corr": fleet.fitted.tr_corr.tolist()}

    # -- train: dec-apx-sparse and fact-sparse ----------------------------
    th0 = cfg.theta0
    lt0 = pack(list(th0[:-2]), th0[-2], th0[-1], dtype=torch.float64,
               device=dev)
    for trainer, kw, steps in (
            ("dec-apx-sparse", dict(kappa=TRAIN_KAPPA), cfg.admm_iters),
            ("fact-sparse", {}, cfg.fact_steps)):
        tcfg = cfg.replace(trainer=trainer, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        RG.reset_launches()
        t0 = time.perf_counter()
        tf = GPFleet(tcfg, device=DEVICE).fit(Xp, yp, train=True)
        torch.cuda.synchronize()
        tfit_ms = 1e3 * (time.perf_counter() - t0)
        tlaunches = RG.launches
        t0 = time.perf_counter()
        fit_sparse_experts(tf.log_theta, Xp, yp, tf.fitted.Z,
                           jitter=tcfg.jitter)
        torch.cuda.synchronize()
        factor_ms = 1e3 * (time.perf_counter() - t0)
        tmean = tf.predict(Xq64[:BIG])[0]
        if tlaunches != panels:
            raise AssertionError(f"{trainer}: rbf_gram launched {tlaunches}"
                                 f" times for {panels} panels")
        if not (_finite(tf.fitted) and bool(torch.isfinite(tmean).all())):
            raise AssertionError(f"{trainer}: non-finite factors or means")
        trmse = _rmse(tmean, fq[:BIG])
        _check_rmse(trainer, trmse)
        out[trainer] = {
            "steps": steps, "fit_ms": tfit_ms, "factor_fit_ms": factor_ms,
            "ms_per_step": (tfit_ms - factor_ms) / steps,
            "rbf_gram_launches": tlaunches,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "theta0": list(th0),
            "trained_theta": torch.exp(tf.log_theta).tolist(),
            "rmse_vs_field": trmse}
        if trainer == "dec-apx-sparse":
            out[trainer]["final_residual"] = float(
                tf.train_info["residuals"][-1])
        else:
            out[trainer]["bound_first_last"] = [
                float(tf.train_info["nll"][0]),
                float(tf.train_info["nll"][-1])]
            out[trainer]["max_abs_Z_moved"] = float(
                (tf.fitted.Z - select_inducing(Xp, SPARSE_M)).abs().max())
        del tf

    # -- scale: the 100k-per-agent fleet ----------------------------------
    BX32, By32, BXq, Bfq = big_data(ctx)
    big_panels = -(-BX32.shape[1] // KMN_PANEL)
    out["scale_f32"] = _f32_record(cfg, BX32, By32, lt32, BXq, Bfq)
    BX, By, BXq64 = BX32.double(), By32.double(), BXq.double()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    RG.reset_launches()
    t0 = time.perf_counter()
    big = GPFleet(cfg, device=DEVICE).fit(BX, By, log_theta0=lt,
                                          train=False)
    torch.cuda.synchronize()
    big_fit_ms = 1e3 * (time.perf_counter() - t0)
    big_launches = RG.launches
    if big_launches != big_panels:
        raise AssertionError(f"rbf_gram launched {big_launches} times for "
                             f"{big_panels} panels of the 100k fit")
    if not _finite(big.fitted):
        raise AssertionError("the 100k fleet's factors are not finite")
    served = {}
    for method in ("npae_sparse", "rbcm"):
        big.predict(BXq64, method=method)            # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bm = big.predict(BXq64, method=method)[0]
        torch.cuda.synchronize()
        served[method] = {"ms": 1e3 * (time.perf_counter() - t0),
                          "rmse_vs_field": _rmse(bm, Bfq)}
        _check_rmse(f"100k {method}", served[method]["rmse_vs_field"])
    factor_bytes = sum(t.numel() * t.element_size() for t in big.fitted)
    ctx["big_fit"] = (BX, By, lt, cfg)
    ctx["big_fleet"] = big
    out["scale"] = {
        "agents": 4, "per_agent": BIG_NI, "queries": SCALE_QUERIES,
        "dtype": "float64 data, float32 kernel", "fit_ms": big_fit_ms,
        "rbf_gram_launches": big_launches, "panels": big_panels,
        "served": served, "factor_bytes": factor_bytes,
        "dense_float32_factor_bytes": 4 * 4 * BIG_NI ** 2,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
        "tr_corr": big.fitted.tr_corr.tolist()}
    return out


def _equal_moments(a, b) -> bool:
    import torch
    return all(torch.equal(x, y) for (ma, va), (mb, vb) in zip(a, b)
               for x, y in ((ma, mb), (va, vb)))


def phase_persist(ctx):
    """Save and load the four kinds of fleet (see the module
    docstring)."""
    import torch
    from repro_torch.fleet import GPFleet
    from repro_torch.kernels import cholupdate as C
    from repro_torch.kernels import rbf_matvec as K
    _, _, Xq, _ = paper_data(ctx)
    tiles = [Xq[i * BATCH:(i + 1) * BATCH] for i in range(METHOD_TILES)]
    big_q = big_data(ctx)[2].double()
    kinds = (("dense", ctx["fleet"], "rbcm", tiles),
             ("online", ctx["online_fleet"], "rbcm", tiles),
             ("sparse", ctx["big_fleet"], "rbcm", [big_q]),
             ("grbcm", ctx["methods_fleet"], "grbcm", tiles))
    out, matvec = {}, 0
    for kind, fleet, method, queries in kinds:
        before = [fleet.predict(x, method=method)[:2] for x in queries]
        # one kind at a time, its directory gone before the next
        d = tempfile.mkdtemp(prefix=".chip_smoke_persist_", dir=ROOT)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fleet.save(d)
            save_ms = 1e3 * (time.perf_counter() - t0)
            on_disk = sum(f.stat().st_size for f in Path(d).iterdir())
            t0 = time.perf_counter()
            loaded = GPFleet.load(d, device=DEVICE)
            torch.cuda.synchronize()
            load_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            shutil.rmtree(d)
        # the loaded fleet's serving: counts reset just before, read after
        K.reset_launches()
        after = [loaded.predict(x, method=method)[:2] for x in queries]
        torch.cuda.synchronize()
        launches = K.launches
        matvec += launches
        want = MATVEC_PER_TILE[method] * len(queries)   # one tile a batch
        rec = {"method": method, "queries": sum(len(x) for x in queries),
               "save_ms": save_ms, "load_ms": load_ms,
               "bytes_on_disk": on_disk,
               "factor_bytes": sum(t.numel() * t.element_size()
                                   for f in (fleet.fitted, fleet.fitted_aug,
                                             fleet.fitted_comm)
                                   if f is not None for t in f
                                   if t is not None),
               "rbf_matvec_launches": launches,
               "predictions_bitwise_equal": _equal_moments(before, after)}
        if launches != want or not rec["predictions_bitwise_equal"]:
            raise AssertionError(f"{kind}: after load {rec}, {want} "
                                 f"rbf_matvec launches expected")
        if kind == "online":
            xs, ys = ctx["online_round"]
            C.reset_launches()
            loaded.observe(xs, ys)
            torch.cuda.synchronize()
            rec["cholupdate_launches"] = C.launches
            ctx["launches_by_path"]["cholupdate"]["persist"] = C.launches
            fleet.observe(xs, ys)
            rec["observe_bitwise_equal"] = all(
                torch.equal(a, b) for a, b in zip(loaded._online_state,
                                                  fleet._online_state))
            rec["predictions_after_observe_bitwise_equal"] = \
                _equal_moments([fleet.predict(tiles[0])[:2]],
                               [loaded.predict(tiles[0])[:2]])
            if not (rec["cholupdate_launches"] == 1
                    and rec["observe_bitwise_equal"]
                    and rec["predictions_after_observe_bitwise_equal"]):
                raise AssertionError(f"online: observe after load {rec}")
        out[kind] = rec
        del loaded, before, after
        torch.cuda.empty_cache()
    ctx["launches_by_path"]["rbf_matvec"]["persist"] = matvec
    return out


def _serve_fleet(ctx):
    """The serve phase's paper fleet (rbcm, M = 4 on a path, 200 DAC
    sweeps, chunk 256, float32, streamed means), fitted anew when that
    phase did not leave it."""
    if "fleet" not in ctx:
        import torch
        from repro_torch.core.gp import pack
        from repro_torch.fleet import FleetConfig, GPFleet
        Xp, yp, _, _ = paper_data(ctx)
        lt = pack(*TRUE_THETA, dtype=torch.float32, device=Xp.device)
        ctx["fleet"] = GPFleet(FleetConfig(stream_mean=True),
                               device=DEVICE).fit(Xp, yp, log_theta0=lt,
                                                  train=False)
    return ctx["fleet"]


def _tiles(predict, Xq, method, plan):
    """CHAOS_TILES tiles of BATCH queries through `predict` (GPFleet.
    predict) under `plan` with allow_degraded -> (per-tile outputs, ms a
    tile); the first tile served once more beforehand as a warm-up."""
    import torch
    kw = {} if plan is None else {"fault_plan": plan,
                                  "allow_degraded": True}
    predict(Xq[:BATCH], method=method, **kw)
    torch.cuda.synchronize()
    outs, ms = [], []
    for i in range(CHAOS_TILES):
        t0 = time.perf_counter()
        outs.append(predict(Xq[i * BATCH:(i + 1) * BATCH], method=method,
                            **kw))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return outs, ms


def _degraded_npae_gate(method, cfg, terms, info, keep, chaos, cen):
    """The NPAE gate of a degraded tile, the bound of NPAE_ROUND with the
    reported residual for every query (the tile's largest, so the bound
    only widens), taken on the agents that iterate. JOR (npae, npae_star)
    is a per-query solve in which the decoupled rows of excluded agents
    never couple back: the payload agents `keep` solve their own block.
    DALE (nn_npae) runs over the readout component on the live subgraph
    (chaos["A_live"]), a scrubbed member included: it relays, holding its
    decoupled row. The DAC readout of npae and npae_star sums over the
    readout component. `cen` is the centralized solve over `keep`."""
    import torch
    from repro_torch.core.consensus import optimal_omega
    from repro_torch.core.prediction.decentralized import (_masked_system,
                                                           _rel_jitter)
    mu, kA, CA = terms
    M = kA.shape[0]
    mk = info["mask"].to(kA.dtype)
    H = _rel_jitter(_masked_system(CA, mk.T), cfg.npae_jitter)
    comp = torch.nonzero(chaos["readout"] > 0).flatten().to(H.device)
    k = comp if method == "nn_npae" \
        else torch.as_tensor(keep, device=H.device)
    Hs = H[:, k][:, :, k]
    kAs = (kA * mk)[k]
    b = torch.stack([(mu * mk)[k].T, kAs.T], -1)
    key = "dale_residual" if method == "nn_npae" else "jor_residual"
    r = torch.full((H.shape[0],), float(info[key]), dtype=torch.float64,
                   device=H.device)
    if method == "nn_npae":
        kw = {"A": chaos["A_live"][comp][:, comp], "dac_iters": 0}
    else:
        omega = (2.0 / M) * 0.999 if method == "npae" \
            else optimal_omega(H, cfg.pm_iters)
        kw = {"omega": omega, "dac_iters": cfg.dac_iters,
              "n_dac": int(comp.numel())}
    bound = _npae_bound(Hs, kAs, b, r, unit=UNIT, **kw)
    return _check_npae(method, info["_out"], cen, bound)


@contextlib.contextmanager
def _degraded_tol(engine, tol):
    """The engine's residual guard at `tol` within the block, restored
    after it."""
    default = engine.degraded_tol
    engine.degraded_tol = tol
    try:
        yield
    finally:
        engine.degraded_tol = default


def phase_chaos(ctx):
    """Degraded-mode consensus on the paper fleet (see the module
    docstring)."""
    from repro_torch.chaos import Dropout, FaultPlan
    from repro_torch.core.consensus import ConsensusDiverged
    fleet = _serve_fleet(ctx)
    Xq = paper_data(ctx)[2]
    default_tol = fleet.engine.degraded_tol
    # the guard at the reference's default, on the first tile
    try:
        info = fleet.predict(Xq[:BATCH], fault_plan=FaultPlan(
            dropouts=(Dropout(0),)), allow_degraded=True)[2]
        at_default = {"outcome": "served",
                      "dac_residual": float(info["dac_residual"])}
    except ConsensusDiverged as e:
        at_default = {"outcome": "ConsensusDiverged",
                      "message": str(e)[:160]}
    at_default["exact_dac_residual"] = float(
        fleet.predict(Xq[:BATCH])[2]["dac_residual"])
    with _degraded_tol(fleet.engine, CHAOS_DEGRADED_TOL):
        out, failures = _chaos_under_plans(ctx, fleet)
    out["rbcm_drop0_at_default_tol"] = {"degraded_tol": default_tol,
                                        **at_default}
    if failures:
        emit({"phase": "chaos", "report_of_a_failed_phase": True, **out})
        raise AssertionError("; ".join(failures))
    return out


def _chaos_under_plans(ctx, fleet):
    """The chaos phase's plans, typed failures and float64 and M = 10
    comparisons, at the engine's guard as set -> (report, failures)."""
    import torch
    from repro_torch.chaos import Dropout, FaultPlan
    from repro_torch.core.consensus import ConsensusDiverged
    from repro_torch.core.gp import pack, stripe_partition
    from repro_torch.core.prediction import aggregation as agg
    from repro_torch.fleet import FleetConfig, FleetDegraded, GPFleet
    from repro_torch.kernels import rbf_matvec as K
    cfg, eng = fleet.config, fleet.engine
    Xp, yp, Xq, fq = paper_data(ctx)
    n_q = CHAOS_TILES * BATCH
    Xq, fq = Xq[:n_q], fq[:n_q]
    Xt = Xq[:BATCH]
    pv = fleet.fitted.prior_var
    mu, var = eng._moments(fleet.fitted, Xt)
    terms = eng._terms(fleet.fitted, Xt)
    failures = []

    def gate(fn, *args):
        try:
            return fn(*args)
        except AssertionError as e:
            failures.append(str(e))

    plans = {name: FaultPlan(**kw) for name, kw in CHAOS_PLANS.items()}
    out = {"agents": cfg.num_agents, "per_agent": int(Xp.shape[1]),
           "dac_iters": cfg.dac_iters, "degraded_tol": eng.degraded_tol,
           "dtype": "float32", "queries_per_plan": n_q,
           "plans": {n: repr(p) for n, p in plans.items()}, "methods": {}}
    exact, launches = {}, 0
    for method in CHAOS_METHODS:
        rep = {}
        exact[method], ms = _tiles(fleet.predict, Xq, method, None)
        rep["exact_batch_ms"] = sum(ms) / len(ms)
        rep["exact_residuals"] = {
            k: max(float(o[2][k]) for o in exact[method])
            for k in ("dac_residual", "dale_residual", "jor_residual")
            if k in exact[method][0][2]}
        free, _ = _tiles(fleet.predict, Xq, method, plans["free"])
        rep["free_plan_bitwise"] = all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and "degraded" not in b[2] for a, b in zip(exact[method], free))
        if not rep["free_plan_bitwise"]:
            failures.append(f"{method}: a consensus-free plan changed the "
                            f"result")
        for name in CHAOS_CONSENSUS_PLANS:
            r = rep[name] = {}
            K.reset_launches()
            try:
                outs, ms = _tiles(fleet.predict, Xq, method, plans[name])
            except ConsensusDiverged as e:
                r["diverged"] = str(e)[:300]
                failures.append(f"{method} under {name}: {r['diverged']}")
                continue
            torch.cuda.synchronize()
            # the warm-up tile and CHAOS_TILES tiles, one launch a tile
            got, want = K.launches, MATVEC_PER_TILE[method] * (
                CHAOS_TILES + 1)
            launches += got
            if got != want:
                failures.append(f"{method} under {name}: rbf_matvec "
                                f"launched {got} times, {want} expected")
            info = outs[0][2]
            mean = torch.cat([o[0] for o in outs])
            varo = torch.cat([o[1] for o in outs])
            census = {k: info[k] for k in ("alive_agents",
                                           "excluded_agents",
                                           "n_components",
                                           "scrubbed_agents")}
            r.update(batch_ms=sum(ms) / len(ms), **census,
                     rmse_vs_field=_rmse(mean, fq),
                     max_abs_diff_from_exact=float(
                         (mean - torch.cat([o[0] for o in exact[method]]))
                         .abs().max()))
            for k in ("dac_residual", "dale_residual", "jor_residual"):
                if k in info:
                    r[k] = max(float(o[2][k]) for o in outs)
            if info.get("degraded") is not True or \
                    not bool(torch.isfinite(mean).all()) or \
                    not bool(torch.isfinite(varo).all()) or \
                    not bool((varo > 0).all()):
                failures.append(f"{method} under {name}: not a finite, "
                                f"flagged degraded result")
            want_census = CHAOS_CENSUS.get(name)
            if want_census is not None and census != want_census:
                failures.append(f"{method} under {name}: census {census}, "
                                f"{want_census} expected")
            if name == "midrun" and method != "npae_star":   # C8
                gate(_check_rmse, f"{method} under {name}",
                     r["rmse_vs_field"])
            keep = CHAOS_KEEP.get(name)
            if keep is None:
                continue
            mk = info["mask"]
            others = [i for i in range(cfg.num_agents) if i not in keep]
            if bool(mk[others].any()):
                failures.append(f"{method} under {name}: agents {others} "
                                f"not excluded from the mask")
            base = method[3:] if method.startswith("nn_") else method
            if method in DAC_CHAOS:
                fn = getattr(agg, base)
                cen = fn(mu, var, pv, mask=mk) if base in ("bcm", "rbcm") \
                    else fn(mu, var, mask=mk)
                r["dec_vs_cen_share_of_bound"] = gate(
                    _check_dac_vs_cen, f"{method} under {name}",
                    outs[0][:2], cen, _dac_scales(method, mu, var, pv, mk),
                    cfg.dac_iters, cfg.num_agents)
            else:
                info = dict(info, _out=outs[0][:2])
                r["dec_vs_cen"] = gate(
                    _degraded_npae_gate, method, cfg, terms, info, keep,
                    eng._chaos_cache[plans[name]][0],
                    agg.npae(*terms, pv, mask=mk))
        out["methods"][method] = rep
    ctx["launches_by_path"]["rbf_matvec"]["chaos"] = launches
    out["rbf_matvec_launches"] = launches
    out["batch_ms_exact_vs_drop0"] = {
        m: [out["methods"][m]["exact_batch_ms"],
            out["methods"][m]["drop0"].get("batch_ms")]
        for m in CHAOS_TIMED}

    # -- typed failures ----------------------------------------------------
    typed = {}
    for name, plan in (("all_at_0", FaultPlan(dropouts=tuple(
            Dropout(i) for i in range(cfg.num_agents)))),
                       ("all_mid_run", FaultPlan(dropouts=tuple(
                           Dropout(i, at=20 * (i + 1))
                           for i in range(cfg.num_agents))))):
        for method in ("rbcm", "npae", "nn_npae"):
            try:
                fleet.predict(Xt, method=method, fault_plan=plan,
                              allow_degraded=True)
                failures.append(f"{method}: {name} did not raise "
                                f"ConsensusDiverged")
            except ConsensusDiverged:
                typed[f"{method}_{name}"] = "ConsensusDiverged"
    try:
        fleet.predict(Xt, method="cen_rbcm", fault_plan=plans["drop0"])
        failures.append("cen_rbcm served a consensus fault")
    except ValueError:
        typed["cen_rbcm_drop0"] = "ValueError"
    try:
        fleet.predict(Xt, method="rbcm", fault_plan=plans["drop0"])
        failures.append("a degraded result was returned without "
                        "allow_degraded")
    except FleetDegraded as e:
        typed["rbcm_drop0_not_allowed"] = "FleetDegraded"
        if not torch.equal(e.result[0], fleet.predict(
                Xt, method="rbcm", fault_plan=plans["drop0"],
                allow_degraded=True)[0]):
            failures.append("FleetDegraded does not carry the answer")
    out["typed_failures"] = typed
    health = fleet.health()
    out["health"] = health
    if health["last_degraded"] is None or \
            not health["degraded_predictions"] > 0:
        failures.append(f"health() reports no degraded prediction: "
                        f"{health}")

    # -- one degraded tile against the same port in float64 ---------------
    lt64 = pack(*TRUE_THETA, dtype=torch.float64, device=Xp.device)
    f64 = GPFleet(cfg, device=DEVICE).fit(Xp.double(), yp.double(),
                                          log_theta0=lt64, train=False)
    f32 = fleet.predict(Xt, method="rbcm", fault_plan=plans["drop0"],
                        allow_degraded=True)
    ref = f64.predict(Xt.double(), method="rbcm", fault_plan=plans["drop0"],
                      allow_degraded=True)
    errs = {"mean": float((f32[0].double() - ref[0]).abs().max()),
            "var": float((f32[1].double() - ref[1]).abs().max())}
    out["rbcm_drop0_f32_vs_f64"] = errs
    if not (errs["mean"] <= F32_MEAN_TOL and errs["var"] <= F32_VAR_TOL):
        failures.append(f"degraded float32 tile vs float64: {errs}")
    del f64, ref

    # -- the M = 10 fleet: Dropout(0) diverges or converges, never worse --
    X, y = Xp.reshape(-1, 2), yp.reshape(-1)
    Xp10, yp10 = stripe_partition(X, y, 10)
    lt = pack(*TRUE_THETA, dtype=torch.float32, device=Xp.device)
    f10 = GPFleet(FleetConfig(num_agents=10, stream_mean=True),
                  device=DEVICE).fit(Xp10, yp10, log_theta0=lt, train=False)
    f10.engine.degraded_tol = eng.degraded_tol
    m10 = {"exact_dac_residual": float(f10.predict(Xt)[2]["dac_residual"]),
           "degraded_tol": f10.engine.degraded_tol}
    try:
        _, _, info = f10.predict(Xt, fault_plan=plans["drop0"],
                                 allow_degraded=True)
        m10["outcome"] = "served"
        m10["dac_residual"] = float(info["dac_residual"])
        if not m10["dac_residual"] <= eng.degraded_tol:
            failures.append(f"M=10: a degraded result above degraded_tol "
                            f"was returned ({m10})")
    except ConsensusDiverged as e:
        m10["outcome"] = "ConsensusDiverged"
        m10["message"] = str(e)[:200]
    out["m10_rbcm_drop0"] = m10
    del f10
    torch.cuda.empty_cache()
    return out, failures


def _ragged(rng, X, n_requests, lo=1, hi=FRONTDOOR_MAX_ROWS):
    """n_requests host requests of lo..hi rows cut in turn from X."""
    sizes = rng.integers(lo, hi + 1, size=n_requests)
    out, off = [], 0
    for n in sizes:
        if off + n > X.shape[0]:
            off = 0
        out.append(X[off:off + n])
        off += n
    return out


def launcher_summary(text) -> dict:
    """The counts of `serve_gp --scheduler`'s summary line and each
    tenant's q/s, from its printed output ({} without a summary line)."""
    m = re.search(r"-> (\d+) submitted: (\d+) served / (\d+) "
                  r"past-deadline / (\d+) rejected / (\d+) failed / "
                  r"(\d+) hung", text)
    if m is None:
        return {}
    keys = ("submitted", "served", "past_deadline", "rejected", "failed",
            "hung")
    return {**dict(zip(keys, map(int, m.groups()))),
            "queries_per_s": [int(q) for q in
                              re.findall(r"\((\d+) q/s\)", text)]}


def launcher_served_all(summary) -> bool:
    """Every request the launcher admitted was served (none failed, hung
    or past its deadline), some were, and every tenant's rate is above 0."""
    return bool(summary) and summary["served"] > 0 \
        and summary["served"] == summary["submitted"] - summary["rejected"] \
        and bool(summary["queries_per_s"]) \
        and min(summary["queries_per_s"]) > 0


def _tenant_report(st, seconds):
    p50, p95, p99 = st.latency_ms(50, 95, 99)
    return {"requests": st.requests, "queries": st.queries,
            "queries_per_s": st.queries / seconds, "batches": st.batches,
            "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
            "padding_fraction": st.padding_fraction,
            "engine_seconds": st.engine_seconds, "rejected": st.rejected,
            "retried": st.retried, "stalled": st.stalled}


def phase_frontdoor(ctx):
    """The serving front door on the paper fleet (see the module
    docstring)."""
    import io
    import urllib.request
    import numpy as np
    import torch
    from repro_torch.chaos import Dropout, FaultPlan
    from repro_torch.core.gp import pack
    from repro_torch.fleet import GPFleet
    from repro_torch.kernels import rbf_matvec as K
    from repro_torch.launch import serve_gp
    from repro_torch.launch.scheduler import (SchedulerStalled,
                                              ServingScheduler, slot_ladder)
    from repro_torch.obs import parse_prometheus_text, start_metrics_server
    fleets = {"rbcm": _serve_fleet(ctx)}
    Xp, yp, Xq, _ = paper_data(ctx)
    lt = pack(*TRUE_THETA, dtype=torch.float32, device=Xp.device)
    fleets["npae"] = GPFleet(fleets["rbcm"].config.replace(method="npae"),
                             device=DEVICE).fit(Xp, yp, log_theta0=lt,
                                                train=False)
    X = Xq.cpu().numpy()
    rng = np.random.default_rng(ctx["seed"] + 22)
    out = {}
    failures = []
    slots = {"rbcm": slot_ladder(*fleets["rbcm"].slot_geometry()),
             "npae": slot_ladder(*fleets["npae"].slot_geometry())}
    out["slots"] = slots
    if slots != {"rbcm": (256, 512, 1024), "npae": (256,)}:
        failures.append(f"slot ladders {slots}")
    launches = 0

    def register(sched, suffix="", **kw):
        for name, fl in fleets.items():
            sched.add_fleet(name + suffix, fl, method=name, **kw)
        return {name + suffix: fl.jit_cache_misses
                for name, fl in fleets.items()}

    def flat(misses0, stage):
        for name, fl in fleets.items():
            for t, m in misses0.items():
                if t.startswith(name) and fl.jit_cache_misses != m:
                    failures.append(f"{stage}: tenant {t} met "
                                    f"{fl.jit_cache_misses - m} new "
                                    f"geometries after warm-up")

    # -- 1. ragged requests against GPFleet.predict, metrics port ---------
    server = start_metrics_server(0)
    try:
        K.reset_launches()
        with ServingScheduler(max_wait_ms=2.0) as sched:
            misses0 = register(sched, queue_depth=1 << 16)
            warm_tiles = sum(slots["rbcm"]) // BATCH
            reqs = [(name, r) for name in fleets
                    for r in _ragged(rng, X, FRONTDOOR_RAGGED)]
            t0 = time.perf_counter()
            futs = [sched.add_request(r, tenant=name) for name, r in reqs]
            answers = [f.result(timeout=300) for f in futs]
            seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        got = K.launches
        launches += got
        st = sched.tenant_stats
        want = warm_tiles + (st["rbcm"].queries
                             + st["rbcm"].padded_queries) // BATCH
        if got != want:
            failures.append(f"ragged: rbf_matvec launched {got} times for "
                            f"{want} rbcm tiles")
        flat(misses0, "ragged")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/metrics", timeout=30) as r:
            scraped = parse_prometheus_text(r.read().decode())
        for name in fleets:
            seen = {labels["tenant"]: v for labels, v in
                    scraped.get("gp_requests_total", [])
                    if "tenant" in labels}
            if seen.get(name) != st[name].requests:
                failures.append(f"/metrics gp_requests_total{{tenant="
                                f"{name}}} = {seen.get(name)}, "
                                f"{st[name].requests} served")
        out["metrics_port_series"] = len(scraped)
    finally:
        server.stop()
    err = {"mean": 0.0, "var": 0.0}
    for (name, r), (m, v) in zip(reqs, answers):
        want_m, want_v, _ = fleets[name].predict(r)
        err["mean"] = max(err["mean"], float(np.abs(
            m - want_m.cpu().numpy()).max()))
        err["var"] = max(err["var"], float(np.abs(
            v - want_v.cpu().numpy()).max()))
    out["ragged"] = {"requests": len(reqs),
                     "rows": int(sum(r.shape[0] for _, r in reqs)),
                     "max_abs_err_vs_predict": err,
                     "rbf_matvec_launches": got,
                     "seconds": seconds,
                     "tenants": {n: _tenant_report(st[n], seconds)
                                 for n in fleets}}
    if not (err["mean"] <= F32_MEAN_TOL and err["var"] <= F32_VAR_TOL):
        failures.append(f"ragged answers vs GPFleet.predict: {err}")

    # -- 2. open-loop Poisson load ----------------------------------------
    K.reset_launches()
    events = serve_gp.poisson_arrivals(
        rng, {n + "_open": rate for n, rate in FRONTDOOR_RATES.items()},
        FRONTDOOR_SECONDS)
    with ServingScheduler(max_wait_ms=2.0) as sched:
        misses0 = register(sched, "_open", admission="reject",
                           queue_depth=FRONTDOOR_QUEUE_ROWS)
        t0 = time.perf_counter()
        futs, rejected = serve_gp.open_loop(
            sched, events, lambda name: _ragged(rng, X, 1)[0])
        for f in futs:
            f.result(timeout=300)
        seconds = time.perf_counter() - t0
    launches += K.launches
    flat(misses0, "open loop")
    out["open_loop"] = {
        "seconds": seconds, "rates_per_s": FRONTDOOR_RATES,
        "rejected": rejected,
        "tenants": {n: _tenant_report(sched.tenant_stats[n + "_open"],
                                      seconds) for n in fleets}}

    # -- 3. closed-loop burst: everything submitted at once ---------------
    K.reset_launches()
    burst = _ragged(rng, X, FRONTDOOR_BURST)
    with ServingScheduler(max_wait_ms=2.0) as sched:
        misses0 = register(sched, "_burst", queue_depth=1 << 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = [sched.add_request(r, tenant="rbcm_burst") for r in burst]
        for f in futs:
            f.result(timeout=300)
        seconds = time.perf_counter() - t0
    launches += K.launches
    flat(misses0, "burst")
    rows = sum(r.shape[0] for r in burst)
    out["burst"] = {"requests": len(burst), "rows": rows,
                    "seconds": seconds, "peak_queries_per_s": rows / seconds,
                    "rbcm": _tenant_report(
                        sched.tenant_stats["rbcm_burst"], seconds)}

    # -- 4. serving faults -------------------------------------------------
    K.reset_launches()
    fl = fleets["rbcm"]
    fail_reqs = _ragged(rng, X, FRONTDOOR_FAULT_REQUESTS, hi=BATCH)
    with ServingScheduler(max_wait_ms=2.0) as sched:
        t_fail = sched.add_fleet("fail", fl, method="rbcm",
                                 fault_plan=FaultPlan(fail_every=5),
                                 retry_backoff_ms=0.1)
        misses0 = fl.jit_cache_misses
        # one request a dispatch: call k is request k
        fail_answers = [sched.add_request(r, tenant="fail").result(
            timeout=300) for r in fail_reqs]
    new_geometries = {"fail": fl.jit_cache_misses - misses0}

    stalled, spurious, ok_after_stall, quarantined = [], [], 0, 0
    with ServingScheduler(max_wait_ms=2.0,
                          stall_timeout_ms=FRONTDOOR_STALL_MS) as sched:
        t_slow = sched.add_fleet("slow", fl, method="rbcm", max_slot=BATCH,
                                 fault_plan=FaultPlan(
                                     straggle_every=7,
                                     straggle_ms=FRONTDOOR_STRAGGLE_MS))
        misses0 = fl.jit_cache_misses
        for k, r in enumerate(_ragged(rng, X, FRONTDOOR_FAULT_REQUESTS,
                                      hi=BATCH), 1):
            while True:
                try:
                    fut = sched.add_request(r, tenant="slow")
                    break
                except SchedulerStalled:
                    quarantined += 1    # the straggler has not returned yet
                    time.sleep(0.005)
            try:
                fut.result(timeout=300)
                if stalled and stalled[-1] < k:
                    ok_after_stall += 1
            except SchedulerStalled:
                (stalled if k % 7 == 0 else spurious).append(k)
    new_geometries["slow"] = fl.jit_cache_misses - misses0
    straggled = [k for k in range(1, FRONTDOOR_FAULT_REQUESTS + 1)
                 if k % 7 == 0]
    out["straggle_every_7"] = {
        "requests": FRONTDOOR_FAULT_REQUESTS,
        "straggle_ms": FRONTDOOR_STRAGGLE_MS,
        "stall_timeout_ms": FRONTDOOR_STALL_MS, "straggled": straggled,
        "failed_stalled": stalled, "spurious_stalls": spurious,
        "watchdog_stalls": t_slow.stats.stalled,
        "rejected_while_quarantined": quarantined,
        "served_after_a_stall": ok_after_stall}
    if stalled != straggled or not ok_after_stall:
        failures.append(f"straggle_every=7: {out['straggle_every_7']}")

    plan = FaultPlan(dropouts=(Dropout(0),))
    degraded0 = fl.health()["degraded_predictions"]
    reqs = _ragged(rng, X, FRONTDOOR_FAULT_REQUESTS)
    with _degraded_tol(fl.engine, CHAOS_DEGRADED_TOL), \
            ServingScheduler(max_wait_ms=2.0) as sched:
        t_deg = sched.add_fleet("degraded", fl, method="rbcm",
                                fault_plan=plan)
        misses0 = fl.jit_cache_misses
        futs = [sched.add_request(r, tenant="degraded") for r in reqs]
        answers = [f.result(timeout=300) for f in futs]
    torch.cuda.synchronize()
    new_geometries["degraded"] = fl.jit_cache_misses - misses0
    # the faults' serving counted; what follows are the comparisons
    launches += K.launches
    dispatched = len(slots["rbcm"]) + t_deg.stats.batches
    counted = fl.health()["degraded_predictions"] - degraded0
    injected = t_fail.predict_fn.calls["n"] // 5
    ferr = max(float(np.abs(m - fl.predict(r)[0].cpu().numpy()).max())
               for r, (m, _) in zip(fail_reqs, fail_answers))
    out["fail_every_5"] = {"requests": len(fail_reqs),
                           "dispatch_calls": t_fail.predict_fn.calls["n"],
                           "injected": injected,
                           "retried": t_fail.stats.retried,
                           "max_abs_err_vs_predict": ferr}
    if t_fail.stats.retried != injected or not ferr <= F32_MEAN_TOL:
        failures.append(f"fail_every=5: {out['fail_every_5']}")
    with _degraded_tol(fl.engine, CHAOS_DEGRADED_TOL):
        derr = max(float(np.abs(m - fl.predict(
            r, fault_plan=plan, allow_degraded=True)[0].cpu().numpy()).max())
            for r, (m, _) in zip(reqs, answers))
    out["dropout_0"] = {"requests": len(reqs), "dispatches": dispatched,
                        "degraded_counted": counted,
                        "last_degraded": fl.health()["last_degraded"],
                        "max_abs_err_vs_degraded_predict": derr}
    if counted != dispatched or not derr <= F32_MEAN_TOL:
        failures.append(f"Dropout(0) tenant: {out['dropout_0']}")
    out["fault_tenants_new_geometries"] = new_geometries
    if any(new_geometries.values()):
        failures.append(f"fault tenants met new geometries after warm-up: "
                        f"{new_geometries}")

    # -- 5. the launcher in-process ---------------------------------------
    buf = io.StringIO()
    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve_gp.main(FRONTDOOR_LAUNCHER_ARGS)
    torch.cuda.synchronize()
    launches += K.launches
    text = buf.getvalue()
    summary = launcher_summary(text)
    out["serve_gp"] = {"args": FRONTDOOR_LAUNCHER_ARGS,
                       "seconds": time.perf_counter() - t0, **summary,
                       "output": text.strip().splitlines()[-4:]}
    if not launcher_served_all(summary):
        failures.append(f"serve_gp --scheduler did not serve every "
                        f"admitted request: {text}")
    ctx["launches_by_path"]["rbf_matvec"]["frontdoor"] = launches
    out["rbf_matvec_launches"] = launches
    del fleets["npae"]
    torch.cuda.empty_cache()
    if failures:
        emit({"phase": "frontdoor", "report_of_a_failed_phase": True, **out})
        raise AssertionError("; ".join(failures))
    return out


@contextlib.contextmanager
def _mission_probes():
    """Class-level probes of one mission, restored after it: the query
    tiles the serving engine computes (each launches rbf_matvec once on the
    streamed-mean path), the observe rounds and their seconds, the drift
    epochs' milliseconds and the seconds the scheduler spends dispatching
    (each probe synchronises the card around its call)."""
    import torch
    from repro_torch.core.prediction import PredictionEngine
    from repro_torch.fleet import GPFleet
    from repro_torch.launch.scheduler import ServingScheduler
    rec = {"tiles": 0, "observe_calls": 0, "observations": 0,
           "observe_s": 0.0, "drift_ms": [], "dispatch_s": 0.0}
    orig = (PredictionEngine.predict, GPFleet.observe, GPFleet.drift,
            ServingScheduler.step)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def predict(self, method, Xs, fault_plan=None):
        rec["tiles"] += -(-len(Xs) // self.chunk)
        return orig[0](self, method, Xs, fault_plan=fault_plan)

    def observe(self, xs, ys):
        out, dt = timed(lambda: orig[1](self, xs, ys))
        rec["observe_calls"] += 1
        rec["observations"] += len(xs)
        rec["observe_s"] += dt
        return out

    def drift(self, **kw):
        out, dt = timed(lambda: orig[2](self, **kw))
        rec["drift_ms"].append(1e3 * dt)
        return out

    def step(self, **kw):
        out, dt = timed(lambda: orig[3](self, **kw))
        rec["dispatch_s"] += dt
        return out
    (PredictionEngine.predict, GPFleet.observe, GPFleet.drift,
     ServingScheduler.step) = (predict, observe, drift, step)
    try:
        yield rec
    finally:
        (PredictionEngine.predict, GPFleet.observe, GPFleet.drift,
         ServingScheduler.step) = orig


def _mission_gates(name, cfg, r, launches, probe):
    """The scenario phase's gates on one full-width mission run; returns
    the failures found."""
    import math
    bad = []
    s = r.serving
    if r.hung_futures or s["failed"] or \
            s["completed"] + s["dropped"] != s["submitted"]:
        bad.append(f"{name}: serving {s}, {r.hung_futures} hung")
    if name == "chaos":
        if r.membership != [(4, "leave", 1), (10, "rejoin", 1)] or \
                not set(r.recompile_steps) <= {4, 10}:
            bad.append(f"chaos: membership {r.membership}, recompiles at "
                       f"{r.recompile_steps}")
    elif r.recompile_steps or r.membership:
        bad.append(f"{name}: recompiles at {r.recompile_steps}, "
                   f"membership {r.membership}")
    for k in ("rmse", "nll", "degraded_fraction"):
        if not all(math.isfinite(v) for v in r.curves[k]):
            bad.append(f"{name}: non-finite {k} curve")
    rmse = r.curves["rmse"]
    if not (rmse[-1] < SCENARIO_RMSE_LIMIT and rmse[-1] < rmse[0]):
        bad.append(f"{name}: final RMSE {rmse[-1]} (first {rmse[0]}, limit "
                   f"{SCENARIO_RMSE_LIMIT})")
    want = {"cholupdate": probe["observe_calls"],
            "nll_grad": cfg.admm_iters + len(r.drift_steps) * cfg.drift_iters,
            "rbf_matvec": probe["tiles"]}
    if probe["observe_calls"] != cfg.steps or launches != want:
        bad.append(f"{name}: launches {launches}, expected {want} "
                   f"({probe['observe_calls']} observe calls)")
    return bad


def phase_scenario(ctx):
    """The closed-loop mission at full width, twice each, and the smoke
    preset on the card against the CPU (see the module docstring)."""
    import statistics
    import torch
    from repro_torch.kernels import cholupdate as C
    from repro_torch.kernels import nll_grad as G
    from repro_torch.kernels import rbf_matvec as K
    from repro_torch.scenario import preset, run_scenario, validate_bench
    out = {"width": dict(SCENARIO_WIDTH), "missions": {}}
    failures = []
    totals = {"rbf_matvec": 0, "cholupdate": 0, "nll_grad": 0}
    for name, dt in SCENARIO_MISSIONS:
        cfg = preset(name).replace(**SCENARIO_WIDTH)
        runs = []
        for _ in range(2):
            stamps = []
            with _mission_probes() as probe:
                torch.cuda.synchronize()
                for k in (K, C, G):
                    k.reset_launches()
                t0 = time.perf_counter()
                r = run_scenario(cfg, device=DEVICE,
                                 dtype=getattr(torch, dt),
                                 csv=lambda _: stamps.append(
                                     time.perf_counter()))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {"rbf_matvec": K.launches,
                            "cholupdate": C.launches, "nll_grad": G.launches}
            validate_bench({"scenario": r.to_bench()})
            failures += _mission_gates(name, cfg, r, launches, probe)
            for k in totals:
                totals[k] += launches[k]
            runs.append((r, wall, launches, dict(probe), stamps))
        (r, wall, launches, probe, stamps), (r2, wall2, *_) = runs
        if r.replay_digest() != r2.replay_digest():
            failures.append(f"{name}: the replay digests differ")
        steps_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        served = r.serving["completed"] * cfg.query_rows
        out["missions"][name] = {
            "dtype": dt, "agents": cfg.num_agents, "steps": cfg.steps,
            "window": cfg.window, "method": cfg.method,
            "drift_every": cfg.drift_every, "wall_s": [wall, wall2],
            "step_ms_median": statistics.median(steps_ms),
            "step_ms_max": max(steps_ms),
            "observations_per_s": probe["observations"] / probe["observe_s"],
            "queries_per_s_dispatch": served / probe["dispatch_s"],
            "p50_ms": r.serving["p50_ms"], "p99_ms": r.serving["p99_ms"],
            "drift_epoch_ms": probe["drift_ms"],
            "rmse_first": r.curves["rmse"][0],
            "rmse_last": r.curves["rmse"][-1],
            "nll_first": r.curves["nll"][0], "nll_last": r.curves["nll"][-1],
            "drift_nll": r.drift_nll, "alive": r.curves["alive"],
            "degraded_fraction_max": max(r.curves["degraded_fraction"]),
            "membership": r.membership,
            "recompile_steps": r.recompile_steps,
            "serving": {k: r.serving[k] for k in
                        ("submitted", "completed", "dropped", "failed",
                         "retried")},
            "launches": launches, "tiles": probe["tiles"],
            "digest": r.replay_digest(),
            "digests_equal": r.replay_digest() == r2.replay_digest()}

    # the smoke preset on the card and on the CPU, float64, one world
    smoke = preset("smoke")
    t0 = time.perf_counter()
    card = run_scenario(smoke, device=DEVICE, dtype=torch.float64)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run_scenario(smoke, device="cpu", dtype=torch.float64)
    cpu_s = time.perf_counter() - t0
    diffs = {k: max(abs(a - b) for a, b in zip(card.curves[k],
                                              cpu.curves[k]))
             for k in ("rmse", "nll")}
    diffs["drift_nll"] = max((abs(a - b) for a, b in
                              zip(card.drift_nll, cpu.drift_nll)),
                             default=0.0)
    same = (card.curves["step"] == cpu.curves["step"]
            and card.curves["alive"] == cpu.curves["alive"]
            and card.drift_steps == cpu.drift_steps
            and card.membership == cpu.membership
            and card.recompile_steps == cpu.recompile_steps)
    if not same or not max(diffs.values()) <= SCENARIO_TWIN_TOL:
        failures.append(f"smoke preset, card vs CPU (float64): curve "
                        f"differences {diffs} (tolerance "
                        f"{SCENARIO_TWIN_TOL}), timelines equal: {same}")
    out["smoke_twin"] = {"card_s": card_s, "cpu_s": cpu_s,
                         "max_abs_diff": diffs, "tol": SCENARIO_TWIN_TOL,
                         "timelines_equal": same,
                         "card_rmse": card.curves["rmse"],
                         "cpu_rmse": cpu.curves["rmse"]}
    for k, n in totals.items():
        ctx["launches_by_path"][k]["scenario"] = n
    if failures:
        emit({"phase": "scenario", "report_of_a_failed_phase": True, **out})
        raise AssertionError("; ".join(failures))
    return out


def _sharded_gate(method, got, want, scales, bound):
    """|1/var| and |mean/var| of a sharded result against `want`, per
    query, within `bound` (in units of the summed |payloads|, SHARDED_MESHES
    note); returns the largest share of it."""
    share = 0.0
    for g, w, sc in ((1 / got[1], 1 / want[1], scales[0]),
                     (got[0] / got[1], want[0] / want[1], scales[1])):
        err = (g.double() - w.double()).abs()
        share = max(share, float((err / (bound * sc.double())).max()))
    if not share <= 1.0:
        raise AssertionError(f"sharded {method} differs from the reference "
                             f"result by {share} x its rounding bound")
    return share


def _exact_sum_gate(method, eng, Xq, got):
    """A consensus="exact" sharded result against its members' own
    payloads summed in float64 and read out in float64, query by query,
    within exact_sum_ulps(M, members) units of the summed |payloads|;
    returns the largest share of the bound."""
    import torch
    base = method[3:] if method.startswith("nn_") else method
    d0 = eng.devices[0]
    M = sum(f.num_agents for f in eng.fitted)
    want, scales = [], []
    for xq in Xq.split(eng.chunk):
        Xqs = [xq.to(d) for d in eng.devices]
        masks = eng._masks(Xqs, ring=True) if base != method else None
        w0, comm = eng._payloads(method, Xqs, masks, ring=True)
        w = torch.cat([x.to(d0).double() for x in w0])   # (M, chunk, 3)
        s, a = w.sum(0), w.abs().sum(0)
        if base == "grbcm":
            mu_c, var_c = (c.to(d0).double() for c in comm[0])
            prec = s[:, 1] + (1.0 - s[:, 2]) / var_c
            num = s[:, 0] - (s[:, 2] - 1.0) * mu_c / var_c
            sc = (a[:, 1] + (1.0 + a[:, 2]) / var_c,
                  a[:, 0] + (1.0 + a[:, 2]) * mu_c.abs() / var_c)
        else:
            pv = eng.fitted[0].prior_var.to(d0).double()
            corr = base in ("bcm", "rbcm")
            prec = s[:, 1] + (1.0 - s[:, 2]) / pv if corr else s[:, 1]
            num = s[:, 0]
            sc = (a[:, 1] + (1.0 + a[:, 2]) / pv if corr else a[:, 1],
                  a[:, 0])
        want.append((num / prec, 1.0 / prec))
        scales.append(sc)
    want = tuple(torch.cat(t) for t in zip(*want))
    scales = tuple(torch.cat(t) for t in zip(*scales))
    return _sharded_gate(method, got, want, scales,
                         exact_sum_ulps(M, eng.ndev) * UNIT)


def _payload_scales(method, f, fa, fc, Xq, mask):
    """_dac_scales of the replicated engine's payloads for `method`."""
    from repro_torch.core.prediction.local import local_moments_cached
    base = method[3:] if method.startswith("nn_") else method
    if base == "grbcm":
        mu, var = local_moments_cached(fa.log_theta, fa.Xp, fa.L, fa.alpha,
                                       Xq)
        mu_c, var_c = local_moments_cached(fc.log_theta, fc.Xp, fc.L,
                                           fc.alpha, Xq)
        return _dac_scales(method, mu, var, f.prior_var, mask, mu_c[0],
                           var_c[0])
    mu, var = local_moments_cached(f.log_theta, f.Xp, f.L, f.alpha, Xq)
    return _dac_scales(method, mu, var, f.prior_var, mask)


def _sharded_fleet(failures, rep, f, fa, fc, Xq, methods, meshes, cfg,
                   routed=False):
    """Every method of `methods` from the replicated engine `rep` and from
    ShardedEngines on `meshes` (DAC and exact), gated; returns the report
    and the rbf_matvec launches of the sharded calls."""
    import torch
    from repro_torch.core.prediction import ShardedEngine
    from repro_torch.kernels import rbf_matvec as K
    M = f.num_agents
    tiles = -(-Xq.shape[0] // cfg.chunk)
    report, launches = {}, 0
    for method in methods:
        want = rep.predict(method, Xq)
        rep_ms = cuda_ms(lambda: rep.predict(method, Xq), 1, warmup=0)
        mask = want[2].get("mask")
        scales = _payload_scales(method, f, fa, fc, Xq, mask)
        rec = {"replicated_batch_ms": rep_ms}
        for name, mesh in meshes.items():
            for consensus in ("dac", "exact"):
                eng = ShardedEngine(f, mesh, chunk=cfg.chunk,
                                    dac_iters=cfg.dac_iters,
                                    eta_nn=cfg.eta_nn, consensus=consensus,
                                    fitted_aug=fa, fitted_comm=fc,
                                    stream_mean=True)
                torch.cuda.synchronize()
                K.reset_launches()
                got = eng.predict(method, Xq)
                torch.cuda.synchronize()
                n = K.launches
                launches += n
                key = f"{name}_{consensus}"
                try:
                    want_n = MATVEC_PER_TILE[method] * mesh.size * tiles
                    if n != want_n:
                        raise AssertionError(
                            f"sharded {method} on {name}: rbf_matvec "
                            f"launched {n} times for {tiles} tiles on "
                            f"{mesh.size} members (expected {want_n})")
                    rec[key + "_share_of_bound"] = _sharded_gate(
                        method, got, want, scales,
                        2 * (2 * cfg.dac_iters * M) * UNIT)
                    if consensus == "exact":
                        rec[key + "_share_of_exact_bound"] = \
                            _exact_sum_gate(method, eng, Xq, got)
                    if mask is not None and not torch.equal(
                            got[2]["mask"], mask):
                        raise AssertionError(f"sharded {method} on {name}: "
                                             f"the CBNN mask differs")
                except AssertionError as e:
                    failures.append(str(e))
                if consensus == "dac":
                    ms = cuda_ms(lambda: eng.predict(method, Xq), 1,
                                 warmup=0)
                    rec[key + "_batch_ms"] = ms
                    rec[key + "_queries_per_s"] = 1e3 * Xq.shape[0] / ms
                    rec[key + "_dac_residual"] = float(got[2]["dac_residual"])
            if routed and method.startswith("nn_") and mesh.size > 1:
                launches += _routed_check(failures, rec, f, fa, fc, rep.A,
                                          Xq, method, name, mesh, cfg,
                                          cfg.eta_nn)
        report[method] = rec
    return report, launches


def _routed_check(failures, rec, f, fa, fc, A, Xq, method, name, mesh, cfg,
                  eta, need_local=False):
    """predict_routed of `method` at CBNN threshold `eta` against the
    replicated engine's full output at `eta`, on the queries whose
    selected agents all live in the member they were routed to (with
    `need_local`, there must be such queries); returns the rbf_matvec
    launches."""
    import torch
    from repro_torch.core.prediction import PredictionEngine, ShardedEngine
    from repro_torch.kernels import rbf_matvec as K
    M = f.num_agents
    full = PredictionEngine(f, A, chunk=cfg.chunk, dac_iters=cfg.dac_iters,
                            eta_nn=eta, fitted_aug=fa, fitted_comm=fc,
                            stream_mean=True, device=DEVICE)
    want = full.predict(method, Xq)
    mask = want[2]["mask"]
    eng = ShardedEngine(f, mesh, chunk=cfg.chunk, dac_iters=cfg.dac_iters,
                        eta_nn=eta, fitted_aug=fa, fitted_comm=fc,
                        stream_mean=True)
    torch.cuda.synchronize()
    K.reset_launches()
    mean, var, info = eng.predict_routed(method, Xq)
    torch.cuda.synchronize()
    n = K.launches
    ms = cuda_ms(lambda: eng.predict_routed(method, Xq), 1, warmup=0)
    Mb = M // mesh.size
    members = torch.arange(M, device=mask.device) // Mb
    shard = torch.as_tensor(info["shard"], device=mask.device)
    local = ~(mask & (members[:, None] != shard[None, :])).any(0)
    key = f"{name}_routed_eta{eta:g}"
    rec[key + "_local_queries"] = int(local.sum())
    rec[key + "_batch_per_shard"] = info["batch_per_shard"]
    rec[key + "_batch_ms"] = ms
    try:
        want_n = MATVEC_PER_TILE[method] * mesh.size * \
            info["batch_per_shard"] // cfg.chunk
        if n != want_n:
            raise AssertionError(f"routed {method}: rbf_matvec launched {n} "
                                 f"times, expected {want_n}")
        if need_local and not bool(local.any()):
            raise AssertionError(f"routed {method} at eta {eta}: no query "
                                 f"has member-local participants")
        if not torch.equal(info["n_selected"][local], mask.sum(0)[local]):
            raise AssertionError(f"routed {method}: participant counts "
                                 f"differ")
        sc = _payload_scales(method, f, fa, fc, Xq, mask)
        if bool(local.any()):
            rec[key + "_share_of_bound"] = _sharded_gate(
                method, (mean[local], var[local]),
                (want[0][local], want[1][local]),
                (sc[0][local], sc[1][local]),
                2 * (2 * cfg.dac_iters * M) * UNIT)
    except AssertionError as e:
        failures.append(str(e))
    return n


def phase_sharded(ctx):
    """The agent-sharded fleet on the card (see the module docstring)."""
    import torch
    from repro_torch.core.consensus import cycle_graph, path_graph
    from repro_torch.core.gp import pack, stripe_partition
    from repro_torch.core.prediction import (PredictionEngine, ShardedEngine,
                                             fit_experts)
    from repro_torch.core.training import train_dec_apx_gp
    from repro_torch.fleet import FleetConfig, GPFleet
    from repro_torch.kernels import nll_grad as G
    from repro_torch.kernels import rbf_gram as RG
    from repro_torch.kernels import rbf_matvec as K
    from repro_torch.launch.mesh import make_agent_mesh
    dev = torch.device(DEVICE)
    Xp, yp, Xq, fq = paper_data(ctx)
    n_q = METHOD_TILES * BATCH
    Xq, fq = Xq[:n_q], fq[:n_q]
    lt = pack(*TRUE_THETA, dtype=torch.float32, device=dev)
    fleet = ctx.get("methods_fleet")
    if fleet is None:
        fleet = GPFleet(FleetConfig(method="grbcm", stream_mean=True),
                        device=DEVICE).fit(
            Xp, yp, generator=torch.Generator(dev).manual_seed(
                ctx["seed"] + 7), log_theta0=lt, train=False)
    cfg = fleet.config
    f, fa, fc = fleet.fitted, fleet.fitted_aug, fleet.fitted_comm
    meshes = {"mesh1": make_agent_mesh(cfg.num_agents),
              "mesh4": make_agent_mesh(cfg.num_agents,
                                       devices=(DEVICE,) * 4)}
    if [m.size for m in meshes.values()] != list(SHARDED_MESHES):
        raise AssertionError(f"agent meshes of {[m.size for m in meshes.values()]}"
                             f" members, expected {SHARDED_MESHES}")
    failures = []
    rep = PredictionEngine(f, fleet.A, chunk=cfg.chunk,
                           dac_iters=cfg.dac_iters, eta_nn=cfg.eta_nn,
                           fitted_aug=fa, fitted_comm=fc, stream_mean=True,
                           device=DEVICE)
    methods = tuple(m for m in ShardedEngine.METHODS if m != "npae_sparse")
    out = {"queries": n_q, "chunk": cfg.chunk, "dac_iters": cfg.dac_iters}
    out["paper_fleet"], matvec = _sharded_fleet(
        failures, rep, f, fa, fc, Xq, methods, meshes, cfg, routed=True)

    # routing where it is exact (SHARDED_ROUTED_LS note)
    lt_r = pack(list(SHARDED_ROUTED_LS), TRUE_THETA[1], TRUE_THETA[2],
                dtype=torch.float64, device=dev)
    f_r = fit_experts(lt_r, Xp.double(), yp.double())
    gen = torch.Generator(dev).manual_seed(ctx["seed"] + 11)
    Xr = (Xp.double().mean(1)[:, None, :] + 0.01 * torch.randn(
        Xp.shape[0], SHARDED_ROUTED_PER_AGENT, 2, generator=gen,
        dtype=torch.float64, device=dev)).reshape(-1, 2)
    out["routed_localized"] = {}
    for method in ("nn_poe", "nn_gpoe", "nn_bcm", "nn_rbcm"):
        rec = out["routed_localized"][method] = {}
        matvec += _routed_check(failures, rec, f_r, None, None, fleet.A, Xr,
                                method, "mesh4", meshes["mesh4"], cfg,
                                SHARDED_ROUTED_ETA, need_local=True)
    del f_r

    # the M = 40 fleet over the same points, on four members
    X, y = Xp.reshape(-1, 2), yp.reshape(-1)
    Xp40, yp40 = stripe_partition(X, y, SHARDED_M40)
    cfg40 = FleetConfig(num_agents=SHARDED_M40, stream_mean=True)
    f40 = GPFleet(cfg40, device=DEVICE).fit(Xp40, yp40, log_theta0=lt,
                                            train=False)
    rep40 = PredictionEngine(f40.fitted, f40.A, chunk=cfg40.chunk,
                             dac_iters=cfg40.dac_iters, eta_nn=cfg40.eta_nn,
                             stream_mean=True, device=DEVICE)
    out["m40_fleet"], n40 = _sharded_fleet(
        failures, rep40, f40.fitted, None, None, Xq, SHARDED_M40_METHODS,
        {"mesh4": make_agent_mesh(SHARDED_M40, devices=(DEVICE,) * 4)},
        cfg40)
    matvec += n40
    del f40, rep40

    # npae_sparse: the m = 512 sparse fleet (float64 data, C6) fitted and
    # served sharded on four members, against the replicated engine
    scfg = FleetConfig(sparse_m=SPARSE_M, method="npae_sparse",
                       sharded=True, stream_mean=True)
    torch.cuda.synchronize()
    RG.reset_launches()
    t0 = time.perf_counter()
    sfl = GPFleet(scfg, mesh=meshes["mesh4"], device=DEVICE).fit(
        Xp.double(), yp.double(), log_theta0=lt.double(), train=False)
    torch.cuda.synchronize()
    sfit_ms = 1e3 * (time.perf_counter() - t0)
    gram = RG.launches
    panels = -(-Xp.shape[1] // KMN_PANEL)
    if gram != panels:
        failures.append(f"sparse fit: rbf_gram launched {gram} times for "
                        f"{panels} panels")
    got = sfl.predict(Xq.double())
    sh_ms = cuda_ms(lambda: sfl.predict(Xq.double()), 1, warmup=0)
    srep = PredictionEngine(sfl.fitted, path_graph(cfg.num_agents),
                            chunk=scfg.chunk, device=DEVICE)
    want = srep.predict("npae_sparse", Xq.double())
    rep_ms = cuda_ms(lambda: srep.predict("npae_sparse", Xq.double()), 1,
                     warmup=0)
    npae_err = max(float((a - b).abs().max() / max(float(b.abs().max()), 1.0))
                   for a, b in zip(got[:2], want[:2]))
    if not npae_err <= SHARDED_NPAE_TOL:
        failures.append(f"sharded npae_sparse: {npae_err} from the "
                        f"replicated engine (> {SHARDED_NPAE_TOL})")
    out["npae_sparse"] = {
        "m": SPARSE_M, "members": sfl.engine.ndev, "fit_ms": sfit_ms,
        "rbf_gram_launches": gram, "panels": panels,
        "max_rel_err_vs_replicated": npae_err, "batch_ms": sh_ms,
        "replicated_batch_ms": rep_ms,
        "rmse_vs_field": _rmse(got[0], fq.double())}
    del sfl, srep

    # dec-apx-sharded: GPFleet's trainer on four members against the
    # simulated trainer on cycle_graph(4) (SHARDED_TRAIN_TOL note)
    tcfg = FleetConfig(trainer="dec-apx-sharded", kappa=TRAIN_KAPPA,
                       admm_iters=SHARDED_TRAIN_ITERS, stream_mean=True)
    th0 = tcfg.theta0
    lt0 = pack(list(th0[:-2]), th0[-2], th0[-1], dtype=torch.float32,
               device=dev)
    torch.cuda.synchronize()
    G.reset_launches()
    t0 = time.perf_counter()
    tfl = GPFleet(tcfg, mesh=meshes["mesh4"], device=DEVICE).fit(
        Xp, yp, log_theta0=lt0)
    torch.cuda.synchronize()
    sh_fit_ms = 1e3 * (time.perf_counter() - t0)
    sh_launches = G.launches
    if sh_launches != 4 * SHARDED_TRAIN_ITERS:
        failures.append(f"dec-apx-sharded launched nll_grad {sh_launches} "
                        f"times, expected one per member per iteration")
    kw = dict(rho=tcfg.rho, kappa=tcfg.kappa, iters=SHARDED_TRAIN_ITERS)
    A = cycle_graph(4)
    t0 = time.perf_counter()
    th_sim, info_sim = train_dec_apx_gp(lt0, Xp, yp, A, **kw)
    torch.cuda.synchronize()
    sim_ms = 1e3 * (time.perf_counter() - t0)
    th_64, _ = train_dec_apx_gp(lt0.double(), Xp.double(), yp.double(), A,
                                grad_fn=plain_local_grad, **kw)
    f32_err = float((th_sim.double() - th_64).abs().max())
    diff = float((tfl.thetas - th_sim).abs().max())
    res_diff = float((tfl.train_info["residuals"]
                      - info_sim["residuals"]).abs().max())
    if not diff <= SHARDED_TRAIN_TOL:
        failures.append(f"dec-apx-sharded: log theta {diff} from the "
                        f"simulated trainer (> {SHARDED_TRAIN_TOL}; float32 "
                        f"is {f32_err} from float64)")
    mean = tfl.predict(Xq)[0]
    out["dec_apx_sharded"] = {
        "members": 4, "iters": SHARDED_TRAIN_ITERS, "kappa": tcfg.kappa,
        "fit_ms": sh_fit_ms, "simulated_train_ms": sim_ms,
        "nll_grad_launches": sh_launches,
        "max_abs_log_theta_vs_simulated": diff,
        "max_abs_log_theta_f32_vs_f64_simulated": f32_err,
        "max_abs_residual_diff": res_diff,
        "trained_theta": torch.exp(tfl.log_theta).tolist(),
        "rmse_vs_field": _rmse(mean, fq)}
    ctx["launches_by_path"]["rbf_matvec"]["sharded"] = matvec
    ctx["launches_by_path"]["rbf_gram"]["sharded"] = gram
    ctx["launches_by_path"]["nll_grad"]["dec-apx-sharded"] = sh_launches
    if failures:
        emit({"phase": "sharded", "report_of_a_failed_phase": True, **out})
        raise AssertionError("; ".join(failures))
    return out

def plain_attention(q, k, v, causal=True, window=None, scale=None):
    """ops.flash_attention's signature with the kernel's plain version in
    its place, on whatever device the inputs lie: the attention hook that
    the lm phase holds the kernel path against."""
    from repro_torch.kernels import flash_attention as F
    return F.flash_attention_plain(q, k, v, causal, window, scale)


def phase_lm(ctx):
    import torch
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch import serve, steps
    from repro_torch.models.lm import param_count
    dev = torch.device(DEVICE)
    args = serve.parse_args(
        ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
         str(LM_PROMPT), "--gen", str(LM_GEN), "--seed", str(ctx["seed"]),
         "--device", DEVICE])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)     # earlier phases' fleets

    # the LM serving path, through the launcher: counts reset just
    # before, read just after
    F.reset_launches()
    t0 = time.perf_counter()
    cold = serve.run(args)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = F.launches
    model, prompts = cold["model"], cold["prompts"]
    cfg = model.cfg
    B, P, G = LM_BATCH, LM_PROMPT, LM_GEN
    if (launches, cold["prefill_launches"], cold["decode_launches"]) != \
            (cfg.num_layers, cfg.num_layers, 0):
        raise AssertionError(f"flash_attention launched {launches} times: "
                             f"{cold['prefill_launches']} in the prefill, "
                             f"{cold['decode_launches']} in decode, for "
                             f"{cfg.num_layers} layers")

    # the same requests again, warm: the reported times
    torch.cuda.reset_peak_memory_stats(dev)
    warm = serve.generate(model, prompts, G)
    peak = torch.cuda.max_memory_allocated(dev)
    logits, tokens = warm["prefill_logits"], warm["tokens"]
    if logits.shape != (B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()) or \
            tokens.shape != (B, G) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError("prefill logits or tokens are not finite of "
                             "the expected shape")

    # the same model with the kernel's plain version in the prefill
    plain = serve.generate(model, prompts, G, attention=plain_attention)
    scale = float(plain["prefill_logits"].abs().max())
    logit_err = float((logits - plain["prefill_logits"]).abs().max()) / scale
    # greedy tokens: equal up to the first step where they differ, and
    # there the plain run's top-2 gap must be within the tolerance
    agree = _greedy_agreement(tokens, plain, LM_LOGIT_TOL, scale)
    if not logit_err <= LM_LOGIT_TOL:
        raise AssertionError(f"prefill logits with the kernel vs its plain "
                             f"version: {logit_err} > {LM_LOGIT_TOL}")

    # prefill + one decode step against the parallel forward over P + 1
    _, cache = steps.make_prefill_step(cfg, P + 2)(model, prompts)
    ld, _ = steps.make_decode_step(cfg)(model, cache, prompts[:, :1])
    del cache
    with torch.no_grad():
        lf, _, _ = model(torch.cat([prompts, prompts[:, :1]], 1),
                         logits_slice=1)
    decode_err = float((ld[:, -1] - lf[:, -1]).abs().max()) / \
        float(lf.abs().max())
    if not decode_err <= LM_LOGIT_TOL:
        raise AssertionError(f"prefill + decode vs the parallel forward: "
                             f"{decode_err} > {LM_LOGIT_TOL}")
    ctx["launches"]["flash_attention"] = launches
    ctx["lm"] = (model, prompts)
    placed = lm_placed_prefill(ctx, model, prompts)
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "heads": cfg.num_heads,
            "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
            "vocab": cfg.vocab_size, "parameters": param_count(cfg),
            "dtype": "float32", "batch": B, "prompt_len": P, "gen": G,
            "cold_run_s": cold_s, "cold_prefill_ms": 1e3 * cold["prefill_s"],
            "prefill_ms": 1e3 * warm["prefill_s"],
            "prefill_tokens_per_s": B * P / warm["prefill_s"],
            "decode_ms_per_step": 1e3 * warm["decode_s"] / G,
            "decode_tokens_per_s": B * G / warm["decode_s"],
            "peak_memory_bytes": peak - held,
            "memory_held_by_earlier_phases_bytes": held,
            "flash_attention_launches_prefill": cold["prefill_launches"],
            "flash_attention_launches_decode": cold["decode_launches"],
            "logit_tol": LM_LOGIT_TOL,
            "max_rel_err_logits_vs_plain": logit_err,
            "max_rel_err_decode_vs_parallel": decode_err,
            "greedy_steps_equal_to_plain": agree,
            "warm_tokens_equal_cold": bool(torch.equal(tokens,
                                                       cold["tokens"])),
            "min_top2_gap": float(warm["gaps"].min()),
            "first_tokens": tokens[:, :8].tolist(), "placed": placed}


def lm_placed_prefill(ctx, model, prompts):
    """One prefill of the lm phase's model placed on make_test_mesh(1, 1)
    (cuda:0) by its parameters' specs and run under use_mesh, with
    constrain live (it raises on a tensor off the mesh inside the block):
    the logits bit for bit those of the same prefill without a mesh, the
    kernel's launches counted under the path lm:mesh."""
    import torch
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import sharding, steps
    from repro_torch.models import act_sharding
    cfg = model.cfg
    prefill = steps.make_prefill_step(cfg, prompts.shape[1] + 1)
    want, _ = prefill(model, prompts)
    mesh = lmesh.make_test_mesh(1, 1)
    specs = steps.model_param_specs(model, mesh)
    sharding.place(model, mesh, specs)
    torch.cuda.synchronize()
    n0 = F.launches
    t0 = time.perf_counter()
    with act_sharding.use_mesh(mesh):
        got, _ = prefill(model, prompts)
        torch.cuda.synchronize()
        placed_s = time.perf_counter() - t0
        launches = F.launches - n0
        try:
            act_sharding.constrain(torch.zeros(4, 1), ("batch", None))
            live = False
        except ValueError:
            live = True
    ctx["launches_by_path"]["flash_attention"]["lm:mesh"] = launches
    equal = bool(torch.equal(got, want))
    if not (equal and live and launches == cfg.num_layers):
        raise AssertionError(f"placed prefill: logits bitwise equal {equal}, "
                             f"constrain live {live}, {launches} launches "
                             f"for {cfg.num_layers} layers")
    return {"mesh": dict(mesh.shape), "devices": [str(d) for d in
                                                  mesh.devices],
            "sharded_specs": sum(any(e is not None for e in sp)
                                 for sp in specs.values()),
            "params": len(specs), "logits_bitwise_equal": equal,
            "constrain_live": live, "flash_attention_launches": launches,
            "prefill_ms": 1e3 * placed_s}


def _param_kind(name: str) -> str:
    """A parameter's name without its layer index ("blocks.3.attn.wq" ->
    "attn.wq"), to report the worst error of each kind over the layers."""
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "blocks" else name


def _twin_states(models):
    """Each model's parameters on the CPU, by name."""
    return [{n: p.detach().cpu() for n, p in m.named_parameters()}
            for m in models]


def _twin_gate(name, card, cpu, tol, lr_bound=None):
    """Max |card - CPU| of each parameter relative to its max |CPU value|,
    the worst over the models; with `lr_bound` also the worst absolute
    difference, held to it. Returns (worst relative, worst absolute)."""
    rel, absolute = 0.0, 0.0
    for a, b in zip(card, cpu):
        for n, want in b.items():
            d = float((a[n] - want).abs().max())
            absolute = max(absolute, d)
            rel = max(rel, d / max(float(want.abs().max()), 1e-30))
    if tol is not None and not rel <= tol:
        raise AssertionError(f"{name}: card vs CPU parameters {rel} > {tol}")
    if lr_bound is not None and not absolute <= lr_bound:
        raise AssertionError(f"{name}: card vs CPU parameters differ by "
                             f"{absolute} > {lr_bound}")
    return rel, absolute


def lm_twins(ctx):
    """The reduced internlm2 card against the CPU (part d of lm_train):
    one set of initial parameters (drawn on the CPU) and one numpy batch
    stream per agent, DEC-ADMM over LM_TWIN_AGENTS agents and Adafactor,
    LM_TWIN_STEPS steps each on both devices. DEC-ADMM's update is linear
    in the gradient: losses within LM_TWIN_LOSS_TOL and parameters within
    LM_TWIN_PARAM_TOL. Adafactor's first step is about lr sign(g), so an
    entry whose gradient is below the rounding moves by up to 2 lr: its
    losses are held to LM_TWIN_LOSS_TOL and its parameters to 2 lr a
    step, the relative difference reported."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import federated
    from repro_torch.data import MarkovLMData
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch import steps
    from repro_torch.models import LM
    from repro_torch.optim import adafactor
    dev = torch.device(DEVICE)
    cfg = get_config(LM_ARCH).reduced()
    init = LM(cfg, device="cpu",
              generator=torch.Generator().manual_seed(ctx["seed"]))
    datas = [MarkovLMData(cfg.vocab_size, seed=0, agent=a)
             for a in range(LM_TWIN_AGENTS)]
    draws = [[d.batch(LM_TWIN_BATCH, LM_TWIN_SEQ) for d in datas]
             for _ in range(LM_TWIN_STEPS)]

    def batch(draw, device):
        return {"tokens": torch.from_numpy(draw[0]).to(device, torch.int64),
                "labels": torch.from_numpy(draw[1]).to(device, torch.int64)}

    runs = {}
    for key, device in (("cpu", torch.device("cpu")), ("card", dev)):
        fed = steps.make_federated_train_step(
            cfg, n_agents=LM_TWIN_AGENTS, rho=0.1, kappa=1 / LM_TWIN_LR)
        models = [copy.deepcopy(init).to(device)
                  for _ in range(LM_TWIN_AGENTS)]
        duals = federated.dec_admm_init([dict(m.named_parameters())
                                         for m in models])
        F.reset_launches()
        fed_losses = []
        for draw in draws:
            duals, loss = fed(models, duals, [batch(d, device) for d in draw])
            fed_losses.append(float(loss))
        opt = adafactor(LM_TWIN_LR)
        single = copy.deepcopy(init).to(device)
        state = opt.init(dict(single.named_parameters()))
        train_step = steps.make_train_step(cfg, opt)
        ada_losses = []
        for draw in draws:
            state, loss, _ = train_step(single, state, batch(draw[0], device))
            ada_losses.append(float(loss))
        runs[key] = {"fed_losses": fed_losses,
                             "fed": _twin_states(models),
                             "ada_losses": ada_losses,
                             "ada": _twin_states([single]),
                             "launches": F.launches}
    card, cpu = runs["card"], runs["cpu"]
    want_launches = (LM_TWIN_AGENTS + 1) * LM_TWIN_STEPS * cfg.num_layers
    if card["launches"] != want_launches:
        raise AssertionError(f"twins: {card['launches']} flash_attention "
                             f"launches on the card, not {want_launches}")
    loss_err = max(abs(a - b) / abs(b) for key in ("fed_losses",
                                                  "ada_losses")
                   for a, b in zip(card[key], cpu[key]))
    if not loss_err <= LM_TWIN_LOSS_TOL:
        raise AssertionError(f"twins: card vs CPU losses {loss_err} > "
                             f"{LM_TWIN_LOSS_TOL}")
    fed_rel, fed_abs = _twin_gate("DEC-ADMM", card["fed"], cpu["fed"],
                                  LM_TWIN_PARAM_TOL)
    ada_rel, ada_abs = _twin_gate("Adafactor", card["ada"], cpu["ada"], None,
                                  2 * LM_TWIN_LR * LM_TWIN_STEPS)
    return {"arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "agents": LM_TWIN_AGENTS,
            "steps": LM_TWIN_STEPS, "batch": LM_TWIN_BATCH,
            "seq": LM_TWIN_SEQ, "lr": LM_TWIN_LR,
            "dec_admm_losses_card": card["fed_losses"],
            "dec_admm_losses_cpu": cpu["fed_losses"],
            "adafactor_losses_card": card["ada_losses"],
            "adafactor_losses_cpu": cpu["ada_losses"],
            "max_rel_err_losses": loss_err, "loss_tol": LM_TWIN_LOSS_TOL,
            "dec_admm_max_rel_err_params": fed_rel,
            "dec_admm_max_abs_err_params": fed_abs,
            "param_tol": LM_TWIN_PARAM_TOL,
            "adafactor_max_rel_err_params": ada_rel,
            "adafactor_max_abs_err_params": ada_abs,
            "flash_launches_card": card["launches"]}


def lm_attention_timing(warm_step_ms, layers):
    """One attention layer of the training step (LM_TRAIN_ATTENTION,
    float32, causal) on the card: the kernel's launch without and with
    its log-sum-exp, and the ported backward, by CUDA events; and their
    share of a warm step (forward and recompute launch the kernel,
    `layers` backward passes)."""
    import torch
    from repro_torch.kernels import flash_attention as F
    B, H, KH, Sq, Sk, D = LM_TRAIN_ATTENTION
    dev = torch.device(DEVICE)
    gen = torch.Generator(dev).manual_seed(11)
    q = torch.randn(B, H, Sq, D, generator=gen, device=dev)
    k, v = (torch.randn(B, KH, Sk, D, generator=gen, device=dev)
            for _ in "kv")
    dout = torch.randn(B, H, Sq, D, generator=gen, device=dev)
    _, lse = F.flash_attention_lse(q, k, v)
    fwd = cuda_ms(lambda: F.flash_attention(q, k, v), 10)
    fwd_lse = cuda_ms(lambda: F.flash_attention_lse(q, k, v), 10)
    bwd = cuda_ms(lambda: F.flash_attention_bwd(q, k, v, lse, dout, True,
                                                None, None, F.BWD_CHUNK),
                  3, warmup=1)
    return {"shape": list(LM_TRAIN_ATTENTION), "kernel_ms": fwd,
            "kernel_lse_ms": fwd_lse, "plain_backward_ms": bwd,
            "kernel_share_of_step": 2 * layers * fwd_lse / warm_step_ms,
            "backward_share_of_step": layers * bwd / warm_step_ms}


def phase_lm_train(ctx):
    """LM training at full width: (a) the allreduce trainer through the
    launcher, (b) the gradient with the kernel against the plain version,
    (f) with --profile one traced step, the attention's times and shares,
    (c) DEC-ADMM over two agents, (d) the reduced twins."""
    import torch
    from repro_torch.data import MarkovLMData
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.models.lm import param_count
    from repro_torch.optim import adam
    dev = torch.device(DEVICE)
    ctx.pop("lm", None)                 # the serving model: its phases ran
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)     # earlier phases' fleets
    common = LM_TRAIN_ARGS + ["--seed", str(ctx["seed"]), "--device",
                              DEVICE]

    # (a) the trainer, counts reset just before, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    F.reset_launches()
    res = train.run(train.parse_args(common + ["--steps",
                                               str(LM_TRAIN_STEPS)]))
    launches = F.launches
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, losses, step_s = res["cfg"], res["losses"], res["step_s"]
    L = cfg.num_layers
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses are not finite: {losses}")
    if res["flash_launches"] != [2 * L] * LM_TRAIN_STEPS or \
            launches != 2 * L * LM_TRAIN_STEPS:
        raise AssertionError(f"flash_attention launched {launches} times, "
                             f"{res['flash_launches']} a step, not "
                             f"2 x {L} a step")
    ctx["launches_by_path"]["flash_attention"]["lm_train"] = launches
    warm_s = sum(step_s[1:]) / max(len(step_s) - 1, 1)
    tokens = res["tokens_per_step"]
    seq = tokens // LM_TRAIN_BATCH
    out = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
           "parameters": param_count(cfg), "dtype": "float32",
           "remat": cfg.remat_policy if cfg.remat else None,
           "tokens_per_step": tokens, "seq": seq,
           "memory_held_by_earlier_phases_bytes": held,
           "allreduce": {
               "optimizer": "adam", "losses": losses,
               "step_ms": [1e3 * t for t in step_s],
               "warm_ms_per_step": 1e3 * warm_s,
               "tokens_per_s": tokens / warm_s,
               "peak_memory_bytes": peak - held,
               "flash_launches_per_step": res["flash_launches"]}}

    # (b) one gradient with the kernel, one with the plain version
    model = res["models"][0]
    del res
    batch = train.make_batch(MarkovLMData(cfg.vocab_size, seed=1),
                             LM_TRAIN_BATCH, seq, dev)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    grads, loss_of, activations = {}, {}, {}
    for name, attention in (("kernel", None), ("plain", plain_attention)):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        # the loss alone: the metrics' ce would keep the graph, and with
        # it the checkpointed blocks and their parameters, alive
        loss = lm.loss_fn(cfg, model, batch, attention=attention)[0]
        loss.backward()
        torch.cuda.synchronize()
        activations[name] = (torch.cuda.max_memory_allocated(dev) - base
                             - param_bytes)
        loss_of[name] = float(loss.detach())
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
        del loss
    model.zero_grad(set_to_none=True)
    worst = {}
    for n, want in grads["plain"].items():
        got = grads["kernel"][n]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{n}: the kernel path's gradient is not "
                                 f"finite")
        err = float((got - want).abs().max()) / float(want.abs().max())
        kind = _param_kind(n)
        worst[kind] = max(worst.get(kind, 0.0), err)
    del grads
    loss_err = abs(loss_of["kernel"] - loss_of["plain"]) / \
        abs(loss_of["plain"])
    out["gradient_check"] = {
        "loss_kernel": loss_of["kernel"], "loss_plain": loss_of["plain"],
        "max_rel_err_loss": loss_err, "logit_tol": LM_LOGIT_TOL,
        "grad_tol": LM_GRAD_TOL, "max_rel_err_grad_by_kind": worst,
        "activation_peak_bytes": activations}
    if not (max(worst.values()) <= LM_GRAD_TOL and loss_err <= LM_LOGIT_TOL):
        raise AssertionError(f"the kernel path's gradient or loss disagrees "
                             f"with the plain version's: {worst}, "
                             f"{loss_err}")

    # (f) one traced step, the attention's times and shares
    if ctx.get("profile"):
        opt = adam(LM_TRAIN_LR)
        state = opt.init(dict(model.named_parameters()))
        step = steps.make_train_step(cfg, opt)
        out["lm_train_step"] = _profiled(lambda: step(model, state, batch),
                                         "flash_fwd")
        del state, step
    del model, batch
    torch.cuda.empty_cache()
    out["attention"] = lm_attention_timing(1e3 * warm_s, L)
    torch.cuda.empty_cache()

    # (c) DEC-ADMM over two agents on the card at full depth: two agents'
    # parameters, duals and gradients (45 GB) and one backward's
    # activations fit beside the earlier phases' fleets
    free = torch.cuda.mem_get_info(dev)[0]
    allocated = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    F.reset_launches()
    fed = train.run(train.parse_args(
        common + ["--steps", str(LM_FED_STEPS), "--consensus", "dec_admm",
                  "--agents", str(LM_FED_AGENTS)]))
    fed_launches = F.launches
    fed_peak = torch.cuda.max_memory_allocated(dev)
    ctx["launches_by_path"]["flash_attention"]["lm_train_dec_admm"] = \
        fed_launches
    want = LM_FED_AGENTS * 2 * L * LM_FED_STEPS
    dis = fed["disagreement"]
    if fed_launches != want or not all(math.isfinite(x)
                                       for x in fed["losses"]) \
            or not all(d is not None and math.isfinite(d) and d > 0
                       for d in dis):
        raise AssertionError(f"DEC-ADMM: {fed_launches} launches (want "
                             f"{want}), losses {fed['losses']}, "
                             f"disagreement {dis}")
    fed_warm = fed["step_s"][-1]
    out["dec_admm"] = {
        "agents": LM_FED_AGENTS, "layers": L, "free_bytes_before": free,
        "allocated_bytes_before": allocated, "losses": fed["losses"],
        "disagreement": dis, "step_ms": [1e3 * t for t in fed["step_s"]],
        "tokens_per_s": fed["tokens_per_step"] / fed_warm,
        "peak_memory_bytes": fed_peak - held,
        "flash_launches_per_step": fed["flash_launches"]}
    del fed
    torch.cuda.empty_cache()

    # (d) the reduced twins, card against CPU
    out["twins"] = lm_twins(ctx)
    return out


def _profiled(fn, port_kernel):
    """Device time by kernel over one call of `fn` (after a warm-up), the
    port kernel's device time and launches, the matrix products' device
    time (cuBLAS/CUTLASS GEMM kernels by name, cuBLAS's nvjet kernels
    included), and the device's busy share of the call's wall time (one
    stream: kernels do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # PROFILE_PAD short spin kernels open the trace and are left out of
        # every count: on the card a trace came about six device events
        # short at its start, which must not be the port's kernel
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name:
            us, n = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not by_kernel:
        raise RuntimeError("the profiler recorded no device activity")
    busy_us = sum(us for us, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    port = [(us, n) for k, (us, n) in by_kernel.items() if port_kernel in k]
    gemm = [us for k, (us, _) in by_kernel.items()
            if re.search(r"gemm|xmma|cutlass|nvjet", k, re.IGNORECASE)]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            f"{port_kernel}_device_ms": sum(us for us, _ in port) / 1e3,
            f"{port_kernel}_device_launches": sum(n for _, n in port),
            "gemm_device_ms": sum(gemm) / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "kernels_launched": sum(n for _, n in by_kernel.values()),
            "top_kernels": [{"name": k[:120], "ms": us / 1e3, "count": n}
                            for k, (us, n) in top]}


def phase_profile(ctx):
    """One served 256-query batch and the dense fit of the serving path,
    one DEC-apx-GP iteration of the training path (from the trained
    theta), one observe round and one served batch of the streaming fleet,
    one sparse fit of the 100k fleet, one served rBCM batch of the sparse
    paper fleet, one 256-query tile of npae, nn_npae and grbcm from the
    methods phase's fleet, and one LM prefill and one decode step (over
    the prefill's cache, rewritten in place at the same slot), each traced
    alone."""
    from repro_torch.core.training import train_dec_apx_gp
    from repro_torch.fleet import GPFleet
    from repro_torch.launch import steps
    model, prompts = ctx["lm"]
    prefill = steps.make_prefill_step(model.cfg, LM_PROMPT + 2)
    decode = steps.make_decode_step(model.cfg)
    _, cache = prefill(model, prompts)
    fleet, Xb = ctx["fleet"], ctx["queries"][:BATCH]
    sparse, (BX, By, lt, cfg_big) = ctx["sparse_fleet"], ctx["big_fit"]
    Xp, yp, _, _ = paper_data(ctx)
    cfg = fleet.config
    online, (x1, y1) = ctx["online_fleet"], ctx["online_round"]
    mfleet = ctx["methods_fleet"]
    return {"batch": BATCH,
            "serve_batch": _profiled(lambda: fleet.predict(Xb),
                                     "rbf_matvec"),
            "admm_iteration": _profiled(
                lambda: train_dec_apx_gp(ctx["trained_theta"], Xp, yp,
                                         fleet.A, rho=cfg.rho,
                                         kappa=cfg.kappa, iters=1),
                "nll_grad"),
            "observe_round": _profiled(lambda: online.observe(x1, y1),
                                       "cholupdate"),
            "online_serve_batch": _profiled(lambda: online.predict(Xb),
                                            "rbf_matvec"),
            "sparse_fit_100k": _profiled(
                lambda: GPFleet(cfg_big, device=DEVICE).fit(
                    BX, By, log_theta0=lt, train=False), "rbf_gram"),
            "sparse_serve_batch": _profiled(
                lambda: sparse.predict(Xb.double()), "rbf_matvec"),
            "serve_fit": _profiled(
                lambda: GPFleet(cfg, device=DEVICE).fit(
                    Xp, yp, log_theta0=fleet.fitted.log_theta, train=False),
                "potrf"),
            "npae_tile": _profiled(
                lambda: mfleet.predict(Xb, method="npae"), "trsm"),
            "nn_npae_tile": _profiled(
                lambda: mfleet.predict(Xb, method="nn_npae"), "trsm"),
            "grbcm_tile": _profiled(
                lambda: mfleet.predict(Xb, method="grbcm"), "rbf_matvec"),
            "lm_prefill": _profiled(lambda: prefill(model, prompts),
                                    "flash_fwd"),
            "lm_decode_step": _profiled(
                lambda: decode(model, cache, prompts[:, :1]), "flash_fwd")}


@contextlib.contextmanager
def _drop_free(model):
    """Every MoE layer of `model` at capacity factor E / k for the block:
    each expert's capacity is then its group's size, so no choice drops.
    Decode is drop-free by the reference's rule while a parallel forward
    over the same tokens drops choices at the configured factor; holding
    one to the other needs both drop-free."""
    from repro_torch.models.moe import MoE
    layers = [m for m in model.modules() if isinstance(m, MoE)]
    keep = [m.cfg for m in layers]
    for m in layers:
        m.cfg = m.cfg.with_overrides(
            moe_capacity_factor=m.cfg.num_experts / m.cfg.experts_per_token)
    try:
        yield
    finally:
        for m, cfg in zip(layers, keep):
            m.cfg = cfg


class _PairedAttention:
    """An attention hook (ops.flash_attention's signature) that runs the
    kernel and its plain version on the same inputs, keeps each call's
    max |kernel - plain| over max |v| in `errors`, and returns the
    kernel's output: the kernel held to its plain version at every
    attention product of a model run, on the model's own q, k and v.
    Each output row is a convex combination of v's rows, so its rounding
    is bounded in units of max |v|; against max |output| it would grow
    with the averaging (a non-causal row over 1,500 frames cancels to an
    output far below |v|), which FLASH_CASES' random inputs do not show."""

    def __init__(self, keep_worst: bool = False):
        self.errors = []
        self.worst = None
        self.keep_worst = keep_worst
        self.worst_inputs = None

    def __call__(self, q, k, v, causal=True, window=None, scale=None):
        from repro_torch.kernels import flash_attention as F
        from repro_torch.kernels import ops
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  scale=scale)
        want = F.flash_attention_plain(q, k, v, causal, window, scale)
        err = float((got.float() - want.float()).abs().max()) / \
            max(float(v.float().abs().max()), 1e-30)
        if not self.errors or err > max(self.errors):
            self.worst = {"q": list(q.shape), "k": list(k.shape),
                          "causal": causal, "max_rel_err": err,
                          "max_abs_scaled_score": float(
                              (q[:, :1].float() @ k[:, :1].float()
                               .transpose(-1, -2)).abs().max())
                          * q.shape[-1] ** -0.5}
            if self.keep_worst:
                self.worst_inputs = (q.clone(), k.clone(), v.clone(), causal,
                                     window, scale)
        self.errors.append(err)
        return got


@contextlib.contextmanager
def _routing(model, into: dict):
    """Record every MoE layer's top-k experts (B, S, k), sorted, of each
    call within the block: into[layer] is a list, one entry a call. The
    hook repeats moe.route's router product, softmax and top-k on the
    layer's input, so it picks what the layer picked."""
    import torch
    from repro_torch.models.moe import MoE, capacity
    hooks = []
    for i, m in enumerate(x for x in model.modules() if isinstance(x, MoE)):
        def hook(mod, args, out, calls=into.setdefault(i, [])):
            x = args[0]
            B, S, d = x.shape
            g, _ = capacity(mod.cfg, B, S)
            logits = torch.einsum("Ggd,de->Gge", x.reshape(-1, g, d),
                                  mod.router).to(torch.float32)
            top = torch.topk(torch.softmax(logits, dim=-1),
                             mod.cfg.experts_per_token, dim=-1).indices
            calls.append(top.reshape(B, S, -1).sort(-1).values)
        hooks.append(m.register_forward_hook(hook))
    try:
        yield into
    finally:
        for h in hooks:
            h.remove()


def _route_flips(a: dict, b: dict, join_a=False) -> int:
    """(layer, token) pairs whose top-k experts differ between two
    recordings of the same tokens: a's first call against b's (with
    `join_a`, a's calls joined along the sequence, a prefill and its
    decode step against one parallel forward)."""
    import torch
    flips = 0
    for i in a:
        got = torch.cat(a[i], 1) if join_a else a[i][0]
        flips += int((got != b[i][0]).any(-1).sum())
    return flips


def _greedy_agreement(tokens, plain, tol, scale):
    """Steps each sequence's greedy tokens equal the plain run's; raises
    where they part while the plain run's top-2 gap exceeds tol x scale."""
    same = (tokens == plain["tokens"]).cpu()
    agree = []
    for b in range(tokens.shape[0]):
        n = int(same[b].long().cumprod(0).sum())
        agree.append(n)
        if n < tokens.shape[1] and \
                float(plain["gaps"][b, n]) > tol * scale:
            raise AssertionError(f"sequence {b}: greedy tokens differ at "
                                 f"step {n} where the top-2 gap is "
                                 f"{float(plain['gaps'][b, n])}")
    return agree


def lm_family(ctx, arch, layers, dtype, B, P, G):
    """One LM family at its published widths through the serve launcher
    (counts reset just before the cold run, read just after), then warm,
    paired with the plain attention at every call, with the plain
    attention end to end, and prefill + one decode step against the
    parallel forward. Returns (report, the cold run's launches, (model,
    prompts, embeds))."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch import serve, steps
    from repro_torch.models import encdec, lm
    dev = torch.device(DEVICE)
    argv = ["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
            "--gen", str(G), "--dtype", dtype, "--seed", str(ctx["seed"]),
            "--device", DEVICE]
    if layers:
        argv += ["--layers", str(layers)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    F.reset_launches()
    t0 = time.perf_counter()
    cold = serve.run(serve.parse_args(argv))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = F.launches
    model, prompts = cold["model"], cold["prompts"]
    frames, embeds = cold["frames"], cold["embeds"]
    cfg = model.cfg
    attn = serve.attention_layers(cfg)
    per_step = cfg.num_layers if cfg.encdec else 0
    if (cold["prefill_launches"], cold["decode_launches"], launches) != \
            (attn, per_step * G, attn + per_step * G):
        raise AssertionError(
            f"{arch}: flash_attention launched {cold['prefill_launches']} "
            f"times in the prefill and {cold['decode_launches']} in "
            f"decode, not {attn} and {per_step * G}")
    torch.cuda.reset_peak_memory_stats(dev)
    warm = serve.generate(model, prompts, G, frames=frames, embeds=embeds)
    peak = torch.cuda.max_memory_allocated(dev)
    logits, tokens = warm["prefill_logits"], warm["tokens"]
    if logits.shape != (B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()) or \
            tokens.shape != (B, G) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{arch}: prefill logits or tokens are not "
                             f"finite of the expected shape")
    # the kernel against its plain version at every attention product of
    # a served run, on the model's own inputs
    paired = _PairedAttention(keep_worst=arch == "whisper-small")
    with _routing(model, {}) as kernel_routes:
        serve.generate(model, prompts, G, attention=paired, frames=frames,
                       embeds=embeds)
    paired_err = max(paired.errors) if paired.errors else None
    if len(paired.errors) != attn + per_step * G or \
            (paired.errors and not paired_err <= PAIRED_TOL[dtype]):
        raise AssertionError(f"{arch}: the kernel vs its plain version on "
                             f"the model's attention inputs: {paired_err} "
                             f"> {PAIRED_TOL[dtype]} over "
                             f"{len(paired.errors)} calls, worst "
                             f"{paired.worst}")

    # the same model with the plain attention, end to end. A top-k router
    # is discontinuous: where the two runs' bf16 roundings route a token
    # to other experts the logits part by more than rounding, so the
    # logits and greedy tokens are gated when every MoE layer routed
    # every token alike (the routes that differ are counted)
    tol = LM_FAMILY_TOL[dtype]
    with _routing(model, {}) as plain_routes:
        plain = serve.generate(model, prompts, G, attention=plain_attention,
                               frames=frames, embeds=embeds)
    flips = _route_flips(kernel_routes, plain_routes)
    scale = float(plain["prefill_logits"].float().abs().max())
    logit_err = float((logits.float() - plain["prefill_logits"].float())
                      .abs().max()) / scale
    agree = _greedy_agreement(tokens, plain, tol, scale) if not flips \
        else None
    if not flips and not logit_err <= tol:
        raise AssertionError(f"{arch}: prefill logits with the kernel vs "
                             f"its plain version: {logit_err} > {tol}")
    del plain

    # prefill + one decode step against the parallel forward over P + 1
    # (drop-free MoE on both sides), gated as above (xLSTM at
    # XLSTM_LOGIT_TOL, its float32 floor)
    nxt = prompts[:, :1]
    extra = {}
    dec_tol = XLSTM_LOGIT_TOL if cfg.block_type == "xlstm" else tol
    with _drop_free(model), torch.no_grad():
        prefill = steps.make_prefill_step(cfg, P + 2 + cfg.vis_tokens)
        decode = steps.make_decode_step(cfg)
        with _routing(model, {}) as step_routes:
            if cfg.encdec:
                _, cache, enc = prefill(model, frames, prompts)
                ld, _ = decode(model, cache, enc, nxt)
            else:
                _, cache = prefill(model, prompts, embeds)
                ld, _ = decode(model, cache, nxt)
        del cache
        with _routing(model, {}) as parallel_routes:
            if cfg.encdec:
                lf, _ = model.decode(torch.cat([prompts, nxt], 1), enc,
                                     logits_slice=1)
            else:
                lf, _, _ = model(torch.cat([prompts, nxt], 1),
                                 embeds=embeds, logits_slice=1)
        if cfg.block_type == "xlstm":
            # the same parallel forward with the embedding scaled by one
            # float32 ulp: the model's own float32 floor
            keep = model.embed.detach().clone()
            model.embed.mul_(1 + 2.0 ** -23)
            lp, _, _ = model(torch.cat([prompts, nxt], 1), logits_slice=1)
            model.embed.copy_(keep)
            del keep
            extra["max_rel_err_parallel_embed_ulp_vs_parallel"] = float(
                (lp[:, -1] - lf[:, -1]).abs().max()) / float(lf.abs().max())
            del lp
    decode_flips = _route_flips(step_routes, parallel_routes, join_a=True)
    decode_err = float((ld[:, -1].float() - lf[:, -1].float()).abs().max()) \
        / float(lf.float().abs().max())
    del lf, ld
    if not decode_flips and not decode_err <= dec_tol:
        raise AssertionError(f"{arch}: prefill + decode vs the parallel "
                             f"forward: {decode_err} > {dec_tol}")
    if paired.worst_inputs is not None:
        c14 = centered_attention_check(*paired.worst_inputs)
        extra["c14_centered"] = c14
        paired.worst_inputs = None
        if not c14["centered_kernel_vs_plain"] <= FLASH_TOL["float32"]:
            raise AssertionError(f"{arch}: the kernel on v centered over "
                                 f"the keys vs the plain version: {c14}")
    if cfg.block_type == "xlstm":
        extra["mlstm_chunked_vs_sequential"] = mlstm_chunk_check(model,
                                                                 prompts)
    counted = encdec.param_count(cfg) if cfg.encdec else lm.param_count(cfg)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    report = {
        "arch": arch, "layers": cfg.num_layers,
        "published_layers": get_config(arch).num_layers,
        "d_model": cfg.d_model, "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
        "experts": cfg.num_experts, "experts_per_token":
            cfg.experts_per_token, "vocab": cfg.vocab_size,
        "parameters": counted, "parameter_bytes": param_bytes,
        "dtype": dtype, "batch": B, "prompt_len": P,
        "prefix_tokens": cfg.vis_tokens, "frames": cfg.enc_seq, "gen": G,
        "cold_run_s": cold_s, "cold_prefill_ms": 1e3 * cold["prefill_s"],
        "prefill_ms": 1e3 * warm["prefill_s"],
        "prefill_tokens_per_s": B * (P + cfg.vis_tokens) / warm["prefill_s"],
        "decode_ms_per_step": 1e3 * warm["decode_s"] / G,
        "decode_tokens_per_s": B * G / warm["decode_s"],
        "peak_memory_bytes": peak - held,
        "memory_held_before_bytes": held,
        "flash_attention_launches_prefill": cold["prefill_launches"],
        "flash_attention_launches_decode": cold["decode_launches"],
        "attention_calls_paired": len(paired.errors),
        "max_rel_err_attention_vs_plain": paired_err,
        "paired_tol": PAIRED_TOL[dtype], "worst_paired_call": paired.worst,
        "logit_tol": tol, "max_rel_err_logits_vs_plain": logit_err,
        "moe_routes_differing_vs_plain": flips,
        "max_rel_err_decode_vs_parallel": decode_err,
        "moe_routes_differing_decode_vs_parallel": decode_flips,
        "decode_tol": dec_tol,
        "greedy_steps_equal_to_plain": agree,
        "warm_tokens_equal_cold": bool(torch.equal(tokens, cold["tokens"])),
        "min_top2_gap": float(warm["gaps"].float().min()),
        "first_tokens": tokens[:, :8].tolist(), **extra}
    return report, launches, (model, prompts, embeds)


def centered_attention_check(q, k, v, causal, window, scale):
    """C14 measured apart on one attention call's own inputs: the kernel
    and its plain version on v and on v - c, c = v's mean over the keys
    per (batch, kv head, column). Softmax rows sum to 1, so out(v - c) + c
    = out(v); if the kernel's float32 error scales with v's common
    component, the centered kernel output lands far closer to the plain
    out(v). Errors relative to max |v|."""
    import torch
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import ops
    g = q.shape[1] // k.shape[1]
    c = v.mean(dim=2, keepdim=True)
    cq = c.repeat_interleave(g, dim=1)
    vmax = float(v.abs().max())

    def err(a, b):
        return float((a.float() - b.float()).abs().max()) / vmax
    with torch.no_grad():
        plain = F.flash_attention_plain(q, k, v, causal, window, scale)
        kern = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
        vc = (v - c).contiguous()
        kern_c = ops.flash_attention(q, k, vc, causal=causal, window=window,
                                     scale=scale) + cq
        plain_c = F.flash_attention_plain(q, k, vc, causal, window,
                                          scale) + cq
    return {"q": list(q.shape), "k": list(k.shape), "causal": causal,
            "max_abs_v": vmax, "max_abs_v_centered": float(vc.abs().max()),
            "kernel_vs_plain": err(kern, plain),
            "centered_kernel_vs_plain": err(kern_c, plain),
            "centered_kernel_vs_centered_plain": err(kern_c, plain_c),
            "centered_plain_vs_plain": err(plain_c, plain),
            "flash_tol": FLASH_TOL["float32"]}


def mlstm_chunk_check(model, prompts):
    """The chunked mLSTM (`_mlstm_chunk` over chunks of xlstm_chunk
    tokens) against `mlstm_sequential` (one step a token) on the first
    mLSTM block's own q, k, v and gates of the prompts, float32 on the
    card: h and the final C, n, m, each max |error| / max |sequential|,
    within XLSTM_CHUNK_TOL."""
    import torch
    from torch.nn import functional as Fn
    from repro_torch.models import xlstm
    cfg = model.cfg
    blk = model.blocks[0]
    cell = blk.cell
    B, S = prompts.shape
    L = cfg.xlstm_chunk
    f32 = torch.float32
    with torch.no_grad():
        x = blk.ln(model.embed[prompts])
        q, k, v = (torch.einsum("bsd,dhk->bhsk", x, w).to(f32)
                   for w in (cell.wq, cell.wk, cell.wv))
        lf = Fn.logsigmoid(torch.einsum("bsd,dh->bhs", x, cell.wf).to(f32))
        li = torch.einsum("bsd,dh->bhs", x, cell.wi).to(f32)
        state = xlstm.init_mlstm_state(cfg, B, x.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs, st = [], state
        for c0 in range(0, S, L):
            sl = slice(c0, c0 + L)
            h, st = xlstm._mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                       lf[..., sl], li[..., sl], st)
            hs.append(h)
        h_chunk = torch.cat(hs, dim=2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        h_seq, st_seq = xlstm.mlstm_sequential(q, k, v, lf, li, state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    errs = {"h": float((h_chunk - h_seq).abs().max())
            / float(h_seq.abs().max())}
    for n in ("C", "n", "m"):
        errs[n] = float((st[n] - st_seq[n]).abs().max()) / \
            float(st_seq[n].abs().max())
    if not max(errs.values()) <= XLSTM_CHUNK_TOL:
        raise AssertionError(f"chunked vs sequential mLSTM: {errs} > "
                             f"{XLSTM_CHUNK_TOL}")
    return {"tokens": S, "chunk": L, "chunks": S // L, "max_rel_err": errs,
            "tol": XLSTM_CHUNK_TOL, "chunked_ms": 1e3 * (t1 - t0),
            "sequential_ms": 1e3 * (t2 - t1)}


def lm_family_twins(ctx):
    """The reduced families in float32, card against CPU from one set of
    weights (drawn on the CPU) and one set of prompts, frames and patch
    embeddings: the prefill's and every decode step's logits within
    LM_LOGIT_TOL of max |logit|, the CPU's greedy tokens fed to both, and
    the card's launches one per attention product of the prefill (and
    one per decoder layer a whisper decode step)."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch import serve, steps
    from repro_torch.models import build_model
    dev = torch.device(DEVICE)
    out = {}
    for arch in LM_FAMILY_TWINS:
        cfg = get_config(arch).reduced(
            layers=4 if arch.startswith("jamba") else 2)
        gen = torch.Generator().manual_seed(ctx["seed"])
        cpu = build_model(cfg, device="cpu", generator=gen)
        card = copy.deepcopy(cpu).to(dev)
        P, G = 64, LM_FAMILY_TWIN_GEN
        prompts = torch.randint(0, cfg.vocab_size, (2, P), generator=gen)
        frames, embeds = serve.stub_inputs(cfg, 2, gen, "cpu")
        prefill = steps.make_prefill_step(cfg, P + G + cfg.vis_tokens + 1)
        decode = steps.make_decode_step(cfg)
        runs = {}
        for name, model, device in (("cpu", cpu, torch.device("cpu")),
                                    ("card", card, dev)):
            F.reset_launches()
            if cfg.encdec:
                lg, cache, enc = prefill(model, frames.to(device),
                                         prompts.to(device))
            else:
                lg, cache = prefill(model, prompts.to(device),
                                    None if embeds is None
                                    else embeds.to(device))
            seen = [lg[:, -1].cpu()]
            for step in range(G):
                src = runs["cpu"]["logits"][step] if name == "card" \
                    else seen[-1]
                tok = src.argmax(-1)[:, None].to(device)
                if cfg.encdec:
                    lg, cache = decode(model, cache, enc, tok)
                else:
                    lg, cache = decode(model, cache, tok)
                seen.append(lg[:, -1].cpu())
            runs[name] = {"logits": seen, "launches": F.launches}
        err = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(runs["card"]["logits"],
                                  runs["cpu"]["logits"]))
        want = serve.attention_layers(cfg) + \
            (cfg.num_layers * G if cfg.encdec else 0)
        if runs["card"]["launches"] != want or not err <= LM_LOGIT_TOL:
            raise AssertionError(f"{arch} twins: {runs['card']['launches']} "
                                 f"launches (want {want}), card vs CPU "
                                 f"logits {err} > {LM_LOGIT_TOL}")
        out[arch] = {"layers": cfg.num_layers, "d_model": cfg.d_model,
                     "max_rel_err_logits": err,
                     "flash_launches_card": runs["card"]["launches"]}
        del card, cpu
    return out


def whisper_train_step(ctx):
    """One Adam step of whisper-small at full size through the train
    launcher (train_4k: 4,096 decoder tokens, batch 2), then one gradient
    with the kernel and one with the plain attention, every parameter
    tensor within WHISPER_GRAD_TOL of max |plain gradient|."""
    import torch
    from repro_torch.data import MarkovLMData
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch import train
    from repro_torch.models import encdec
    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    F.reset_launches()
    res = train.run(train.parse_args(
        WHISPER_TRAIN_ARGS + ["--seed", str(ctx["seed"]),
                              "--device", DEVICE]))
    launches = F.launches
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, losses, step_s = res["cfg"], res["losses"], res["step_s"][0]
    want = cfg.enc_layers + 2 * cfg.num_layers
    if launches != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"whisper step: {launches} launches (want "
                             f"{want}), losses {losses}")
    model = res["models"][0]
    del res
    seq = train.SHAPES["train_4k"]["seq"]
    gen = torch.Generator(dev).manual_seed(ctx["seed"] + 1)
    batch = train.make_batch(MarkovLMData(cfg.vocab_size, seed=1), 2, seq,
                             dev, cfg, gen)
    grads, loss_of = {}, {}
    for name, attention in (("kernel", None), ("plain", plain_attention)):
        model.zero_grad(set_to_none=True)
        loss = encdec.loss_fn(cfg, model, batch, attention=attention)[0]
        loss.backward()
        loss_of[name] = float(loss.detach())
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
        del loss
    model.zero_grad(set_to_none=True)
    worst = {}
    for n, w in grads["plain"].items():
        got = grads["kernel"][n]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{n}: the kernel path's gradient is not "
                                 f"finite")
        kind = ".".join(p for p in n.split(".") if not p.isdigit())
        worst[kind] = max(worst.get(kind, 0.0), float(
            (got - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    del grads, model, batch
    torch.cuda.empty_cache()
    loss_err = abs(loss_of["kernel"] - loss_of["plain"]) / \
        abs(loss_of["plain"])
    if not (max(worst.values()) <= WHISPER_GRAD_TOL
            and loss_err <= LM_LOGIT_TOL):
        raise AssertionError(f"whisper step: the kernel path's gradient or "
                             f"loss disagrees with the plain version's: "
                             f"{worst}, {loss_err}")
    return {"arch": cfg.name, "tokens_per_step": 2 * seq,
            "frames": cfg.enc_seq, "loss": losses[0],
            "step_ms": 1e3 * step_s,
            "tokens_per_s": 2 * seq / step_s,
            "flash_launches": launches, "peak_memory_bytes": peak - held,
            "loss_kernel": loss_of["kernel"], "loss_plain": loss_of["plain"],
            "max_rel_err_loss": loss_err, "grad_tol": WHISPER_GRAD_TOL,
            "max_rel_err_grad_by_kind": worst}, launches


def phase_lm_families(ctx):
    """The MoE, jamba, VLM and whisper families (LM_FAMILIES) served at
    their published widths, each freed before the next; with --profile a
    traced dbrx and jamba prefill; the reduced twins card vs CPU; one
    whisper Adam step at full size."""
    import torch
    from repro_torch.launch import steps
    out = {"families": {}}
    by_path = ctx["launches_by_path"]["flash_attention"]
    for arch, layers, dtype, B, P, G in LM_FAMILIES:
        report, launches, (model, prompts, embeds) = lm_family(
            ctx, arch, layers, dtype, B, P, G)
        if arch not in NO_ATTENTION:
            by_path[f"lm_families:{arch}"] = launches
        if ctx.get("profile") and arch in ("dbrx-132b", "jamba-v0.1-52b"):
            prefill = steps.make_prefill_step(model.cfg, P + G + 1)
            report["profile_prefill"] = _profiled(
                lambda: prefill(model, prompts, embeds), "flash_fwd")
        out["families"][arch] = report
        del model, prompts, embeds
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["twins"] = lm_family_twins(ctx)
    out["whisper_train"], n = whisper_train_step(ctx)
    by_path["lm_families:whisper_train"] = n
    out["xlstm_train"] = xlstm_train_step(ctx)
    return out


def xlstm_train_step(ctx):
    """One Adam step of xlstm-350m at full width through the train
    launcher (train_4k: 4,096 tokens with remat, batch 2): a finite loss,
    no flash_attention launch; ms, tokens/s and peak memory."""
    import torch
    from repro_torch.kernels import flash_attention as F
    from repro_torch.launch import train
    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    F.reset_launches()
    res = train.run(train.parse_args(
        XLSTM_TRAIN_ARGS + ["--seed", str(ctx["seed"]), "--device", DEVICE]))
    launches = F.launches
    peak = torch.cuda.max_memory_allocated(dev)
    cfg, losses, step_s = res["cfg"], res["losses"], res["step_s"][0]
    tokens = res["tokens_per_step"]
    del res
    torch.cuda.empty_cache()
    if launches != 0 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"xlstm step: {launches} launches, losses "
                             f"{losses}")
    return {"arch": cfg.name, "layers": cfg.num_layers, "remat": cfg.remat,
            "tokens_per_step": tokens, "loss": losses[0],
            "step_ms": 1e3 * step_s, "tokens_per_s": tokens / step_s,
            "flash_launches": launches, "peak_memory_bytes": peak - held}


def phase_dryrun(ctx):
    """The port's pod dry run (launch/dryrun.py): every arch x supported
    shape x {16 x 16, 2 x 16 x 16} x {default, dp}, 39 meta steps (each
    traced once, in DRYRUN_JOBS spawned processes) and 156 spec records;
    whisper-small's long_500k is skipped by the reference's gate. Host
    only by design: the meshes are a 256- and a 512-chip pod that one
    card cannot be, the steps run on meta tensors, and no process touches
    the card. Every record must read ok or skipped; the records go to a
    temporary directory, not into the repo."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import SHAPES
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        recs = list(dryrun.run_all(ARCH_IDS, list(SHAPES), (False, True),
                                   tuple(dryrun.POLICIES), tmp,
                                   jobs=DRYRUN_JOBS))
        files = len(list(Path(tmp).iterdir()))
    wall = time.perf_counter() - t0
    ok = [r for r in recs if r["status"] == "ok"]
    skipped = sorted({(r["arch"], r["shape"]) for r in recs
                      if r["status"].startswith("skipped")})
    traces = {(r["arch"], r["shape"]): r["trace_s"] for r in ok}
    failed = [f"{r['arch']} {r['shape']} {r['mesh']} {r['policy']}: "
              f"{r.get('error', r['status'])}" for r in recs
              if r not in ok and not r["status"].startswith("skipped")]
    if failed or len(ok) != 156 or len(traces) != 39 or \
            skipped != [("whisper-small", "long_500k")]:
        raise AssertionError(f"dry run: {len(ok)} records ok of "
                             f"{len(recs)}, {len(traces)} meta steps, "
                             f"skipped {skipped}, failed {failed[:4]}")
    train_rows = {f"{r['arch']} {r['mesh']} {r['policy']}": {
        "gib_per_device": r["memory"]["argument_size_in_bytes"] / 2**30,
        "flops": r["cost"]["flops"]} for r in ok if r["shape"] == "train_4k"}
    return {"seconds": wall, "jobs": DRYRUN_JOBS, "meta_steps": len(traces),
            "records": len(recs), "records_ok": len(ok),
            "records_written": files, "skipped": skipped,
            "trace_s_sum": sum(traces.values()),
            "trace_s_max": max(traces.values()),
            "slowest_step": max(traces, key=traces.get),
            "train_4k": train_rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one served batch and the serve "
                         "fit, one ADMM iteration, one observe round, one "
                         "sparse fit, one sparse served batch, one npae, "
                         "nn_npae and grbcm tile, one LM prefill and one "
                         "decode step, one training step and a dbrx and a "
                         "jamba prefill with torch.profiler")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's sources are missing ({e})",
              file=sys.stderr)
        return 1

    card = card_line()
    ctx = {"seed": args.seed, "launches": {}, "profile": args.profile,
           "launches_by_path": {"rbf_matvec": {}, "nll_grad": {},
                                "rbf_gram": {}, "cholupdate": {},
                                "flash_attention": {}}}
    failed = []
    phases = [("build", phase_build), ("kernels", phase_kernels),
              ("serve", phase_serve), ("fullgp", phase_fullgp),
              ("fleets", phase_fleets), ("methods", phase_methods),
              ("train", phase_train), ("online", phase_online),
              ("sparse", phase_sparse), ("persist", phase_persist),
              ("chaos", phase_chaos), ("frontdoor", phase_frontdoor),
              ("scenario", phase_scenario), ("sharded", phase_sharded),
              ("lm", phase_lm)]
    if args.profile:
        phases.append(("profile", phase_profile))
    phases.append(("lm_train", phase_lm_train))
    phases.append(("lm_families", phase_lm_families))
    phases.append(("dryrun", phase_dryrun))
    for name, fn in phases:
        try:
            out = fn(ctx)
            emit({"phase": name, "ok": True, "card": card, **out})
        except Exception as e:  # report every phase, fail at the end
            traceback.print_exc()
            failed.append(name)
            emit({"phase": name, "ok": False, "card": card,
                  "error": f"{type(e).__name__}: {e}"})
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    main_path = {"rbf_matvec": "serve", "nll_grad": "train",
                 "cholupdate": "online", "rbf_gram": "sparse",
                 "flash_attention": "lm"}
    rows = []
    for name, replaces in (("rbf_matvec", "src/repro/kernels/rbf_matvec.py:46"),
                           ("nll_grad", "src/repro/kernels/nll_grad.py:73"),
                           ("cholupdate", "src/repro/kernels/cholupdate.py:69"),
                           ("rbf_gram", "src/repro/kernels/rbf_gram.py:47"),
                           ("flash_attention",
                            "src/repro/kernels/flash_attention.py:72")):
        k = ctx[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces, "launches": ctx["launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
            "launches_by_path": {main_path[name]: ctx["launches"][name],
                                 **ctx["launches_by_path"].get(name, {})},
            **{key: k[key] for key in ("device_ms", "lse_ms")
               if key in k}})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
