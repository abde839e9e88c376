#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (`neural_rx_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  1. card: the `nvidia-smi` name and power limit;
  2. build: the CUDA kernels with plain nvcc (`kernels/_build.py`);
  3. kernel_check: each kernel against its plain PyTorch version at the
     nrx_rt widths (N = b*T = 2, 14x1584), float32 and bfloat16, sc_valid
     None and (5, 1500): the sepconv stack at its three stacks; the CGNN
     iteration in state and readout modes and the whole-CGNN kernel, with
     users active (1, 1) and (1, 0); the iteration in readout mode with
     the 2- and 6-bit LLR readouts of nrx_rt_qpsk and nrx_rt_64qam, every
     output equal to the plain version's;
  4. ldpc_check: the layered min-sum LDPC kernel against its plain version,
     20 iterations, hard bits exactly equal: nrx_rt's eval code (BG1,
     Z = 384, the 5 code blocks of 16 transport blocks) on LLRs from the
     TB chain over a BPSK-equivalent channel at 10 dB (decodable) and at
     1.7 dB (the waterfall), the noiseless codewords, an odd count of 7;
     the 4-PRB code (BG2, Z = 128) at 2 dB; BG1/Z = 352 and BG2/Z = 52
     (Z no multiple of 32) at 0 dB; the 150 codewords of user 0 of one
     Monte-Carlo step (batch 30, DoubleTDLlow, 3 dB, the receiver's LLRs);
     with bit and block errors of each;
  5. main_path: `entry()` at 132 PRB on its routes, each run with the
     launch counts set to 0 just before and read just after: batch 1 (3
     sepconv launches, nothing else), batch 16 (1 sepconv, 2 iteration
     launches) and mega at batch 1 and 16 (1 whole-CGNN launch, nothing
     else); shapes, finite values, and each route against the same route
     through the plain versions on this card (bfloat16 as served, and
     float32);
  6. eval_path: `eval_entry()` at 132 PRB, batch 16, float32, Eb/N0 10 dB
     on the seeded flat channel, with each decoder, counts set to 0 before
     and read after: the layered kernel (1 sepconv, 2 iteration, 2 LDPC
     launches: one per user) and the flooding decoder (no LDPC launch);
     b_hat equals the bits sent in every transport block but the two the
     JAX package's receiver fails on the same slot, the CRC fails exactly
     there, and the kernel route's b_hat and crc equal the same route
     through the plain versions;
  7. mc_path: the Monte-Carlo BLER evaluation (`mc_entry()`, `E2EModel`,
     `sim_ber`) of nrx_rt at 132 PRB, batch 30, float32, DoubleTDLlow:
     launches of one step with each decoder, counts set to 0 before and
     read after (1 sepconv, 2 iteration and 2 LDPC launches of 150
     codewords with the layered kernel; no LDPC launch with flooding); the
     kernel route against the plain route from the same generator seed
     (nrx_rt: 2 steps at 3 dB with each decoder; nrx_rt_qpsk and
     nrx_rt_64qam: 1 step with the layered decoder): counters, b_hat and
     crc equal; a `sim_ber` sweep with the layered kernel at 2, 3 and 4 dB
     and with flooding at 3 dB, each point's BLER with its Wilson interval
     beside the committed JAX curve (`JAX_CURVE`), inside the sanity band
     of that curve 1 dB to either side and decreasing with Eb/N0; device
     ms of a step split into draws + transmitter + channel, receiver and
     decode, the sweep's slots/s by wall clock and by device time, and
     the host-device copies of a step (profiler);
  8. baseline_path: the classical baselines (`BaselineE2EModel`) at 132
     PRB, batch 30, with the layered kernel: the six systems on nrx_rt (2
     users, DoubleTDLlow) and the two K-Best systems on e2e_baseline (1
     user, TDL-B100), their covariances computed on the card into a
     temporary directory (seconds recorded); one step of each, counts set
     to 0 before and read after (2 LDPC launches at 2 users, 1 at 1 user,
     nothing else), against the plain route from the same seed (counters,
     b_hat, crc equal; the CRC passes exactly where b_hat is right); short
     `sim_ber` points (BASE_SWEEP) inside the band of their JAX curve
     (BASE_CURVES, BASE_CURVE_FILES) 1 dB to either side, and the neural receiver's 4 dB
     point of `mc_path` below LS/lin + LMMSE's; per system the device ms
     of a step split into draws + transmitter + channel, estimation,
     detection and decode, and slots/s by wall clock and by device time;
  9. var_mcs_path: several MCS at eval (`mc_entry(config=..., mcs_idx=)`,
     `mixed_mcs_entry`, `sim.mixed_mcs`) on nrx_rt_var_mcs at 132 PRB,
     batch 30, float32, with K5: launches of a step on MCS 0 and 1 and in
     a mixed slot (2 sepconv: one init stack per MCS, 2 iteration, 2 LDPC;
     LS/lin in the mixed slot 1 LDPC), counts set to 0 before and read
     after; kernel route = plain route (counters, b_hat, crc) on MCS 0,
     MCS 1, the mixed slot, one iteration, and nrx_rt with a 0.1 ppm
     frequency offset; `sim_ber` points per MCS inside the band of the
     committed curve the converted weights reproduce (VAR_CURVE_FILE, the
     imported weights' curve beside) and in both mixed slots for the NRX
     and LS/lin inside their JAX curves' bands (MIXED_CURVE), the NRX
     below LS/lin; the masking configuration (3 MCS, 8 iterations,
     seed-made parameters) one step per MCS against its plain route (1
     sepconv, 8 iteration launches); the whole-CGNN kernel at 8 iterations
     against its plain version and route (bf16 and float32); the evaluate
     CLI on MCS 1; a step's device ms by stage and slots/s;
 10. train_path: training (`sim/training.py`, `cli/train.py`): the UMi
     channel on the card (finite, mean power, frequency selectivity and
     user independence at the bars of tests/test_tr38901.py); nrx_rt from a
     seed-made init at its training width (4 PRB, 4 rx antennas, 2 users,
     batch 128, UMi, phase 0), TRAIN_STEPS Adam steps with no kernel
     launched: every loss finite, the data loss's mean over the last
     TRAIN_WINDOW steps below that of the first by more than twice their
     combined standard error; WARM_STEPS steps from the committed weights
     at phase 1's Eb/N0, the data loss below the init's first mean by two
     standard errors and within three of the JAX package's with the same
     weights (JAX_WARM_LOSS);
     e2e_rt phase 0 (TDL-C300, learned constellation, masked pilots, no LS
     input, float32): the points move and stay centred at unit energy; the
     train CLI's smoke into a temporary directory and the evaluate CLI on
     the weights it wrote; the trained parameters through the eval receiver
     at 132 PRB (one Monte-Carlo step, batch 30: 1 sepconv, 2 iteration, 2
     LDPC launches, kernel route = plain route); `compute_cov` on UMi at 132
     PRB (Hermitian, PSD); a step's device ms by stage, steps/s, the
     device's busy share and the peak memory;
 11. deploy_path: the deploy engine (`entry.deploy_entry`, `deploy/`) of
     nrx_rt, bf16, committed EMA weights: every bucket of
     DEFAULT_PRB_BUCKETS (4 to 273 PRB) at batch 1, its CUDA-graph replay
     equal to its eager call and that to the plain route (1 sepconv, 2
     iteration launches an eager call; a replay passes no wrapper), device
     ms by CUDA events and host p50/p99 per call, eager and graph, beside
     the reference's 1.275 ms; 131 and 100 PRB through the 132 bucket
     against engines of those widths with nonzero biases, equal in float32
     and bf16; the mega route (K4) at 132 PRB, batch 1 and 16, captured,
     graph = eager = plain route; the Aerial test vectors
     (`deploy/data_tools.py`, DoubleTDLlow, 10 dB, batch 16) through the
     engine into the evaluator in float32 and bf16 (coded BER, CRC pass
     rate), the float32 served call within 1e-5 of the eval receiver on
     the same slot; slots/s at batch
     16; the export CLI for buckets 4 and 132 into a temporary directory
     and its 132 engine file loaded back, equal to the live engine; K1 and
     K3 at 48 and 3276 subcarriers with their bounds;
 12. site_path: the site-specific Dataset channel: the synthetic datasets
     written into a temporary directory (md5 of data/'s files);
     nrx_site_specific_100k at 132 PRB, batch 30, float32, K5: one step's
     launches (1 sepconv, 2 iteration, 2 LDPC), kernel route = plain route
     over 2 steps, `sim_ber` at 3 and 7 dB inside the committed curve's
     band, the evaluate CLI; the LS/lin and LMMSE baselines of
     nrx_site_specific_baseline (2 LDPC launches, covariances computed on
     the Dataset channel) = plain route; 20 training steps of
     nrx_site_specific at 4 PRB, batch 128 (no kernel, finite losses); a
     step's device ms by stage;
 13. dist_path: several ranks (`dist/`): a one-rank NCCL group (mesh 1 x
     1) whose `sim_ber` (nrx_rt, 132 PRB, 3 dB, global batch 30, K5) and
     training step (the gradient all-reduce) equal the same calls without
     a mesh; gloo groups of 2 and 4 ranks sharing the card, started
     together (spawn; the library built here, loaded there): the stack
     and iteration kernels on 792- and 396-subcarrier shards with halos of
     3 (bf16, float32) against the unsharded launch, the eval receiver's
     CGNN on meshes 1 x 4 and 2 x 2 within 1e-5 of one rank's, `sim_ber`
     on meshes 2 x 1 and 2 x 2 with counters equal to one rank's, a 2-rank
     training step with equal parameters on both ranks, each rank's
     launches asserted; `chained_device_time_ms` of `entry()` at batch 1 beside its
     event time; nrx_rt's weights through the reference format and back
     equal, a served call from them equal;
 14. modes_path: the JAX package's layer modes at 132 PRB, nrx_rt, committed
     EMA weights (`conv_mxu`, the folded-tap form of the stack kernel, and
     `stencil_lp`, the depthwise taps summed in bf16, of the stack,
     iteration and whole-CGNN kernels): each kernel in its mode equal bit
     for bit to its plain version in the mode, and different from the
     kernel in the normal mode on the same inputs (the stack's folded form
     in bf16 and float32 on the init and update stacks at N = 2 with
     sc_valid None and (5, 1500), its bf16 stencil there too; the
     iteration's stencil at batch 16 in state and readout modes; the whole
     CGNN's at batch 1); fused_iteration refusing mxu; the receiver's
     routes, the modes set in its `CGNNConfig`, equal bit for bit to their
     plain routes with the launches counted by mode (batch 1 under
     NRX_CONV_MXU=1: 3 folded stack launches; batch 16 with conv_mxu in
     the configuration and the knob unset: 3 stack launches, 1 folded, no
     iteration launch, a warning; batch 16 with stencil_lp: 1 stack and 2
     iteration launches, all in the mode; mega at batch 1 with stencil_lp:
     1 whole-CGNN launch in the mode); each mode's device time beside the
     normal mode's in turns on one card (the stack over a batch-1 slot and
     at N = 32 in bf16, folded in float32 at N = 60, the iteration at batch
     16, the whole CGNN at batch 1), with its bound (folded: 2 x 9 x c_in x
     c_out FLOP per position and layer); the new instances' registers and
     spills;
 15. completion_path: the last of the JAX package. e2e_rt at 132 PRB
     (seed-made parameters, one user): K1 on its 130-channel update stack
     (bf16 in the normal, stencil_lp and folded modes, sc_valid None and
     (5, 1500) in the normal mode), K3 at batch 16 in state and readout
     modes and K4 at batch 1 (normal and stencil_lp), each equal bit for
     bit to its plain version, and in float32 within TOL_F32; e2e_large's
     K4 at 8 iterations; the receiver's batch-1 (5 stack launches),
     batch-16 (1 stack, 4 iteration launches) and mega routes (1 whole-CGNN
     launch) equal to their plain routes; nrx_rt with full 3x3 conv layers
     (`layer_type_conv = "conv"`, seed-made) on the batch-1, batch-16 and
     mega routes in bf16 and float32, no kernel launched, equal to the
     plain route, with device ms, and one conv-layer training step at
     batch 128, 4 PRB (finite loss and gradients); the fused routes where
     the JAX package's gates fail (an aggregation MLP of two hidden layers:
     2 stack and 1 iteration launches at batch 16, 3 stack launches on the
     mega route; apply_multiloss: 3 stack launches with fused_full, 1 stack
     and 2 iteration launches with the fused readout) equal to their plain
     routes; each e2e kernel's time beside its bound and plain version;
     the wide instances' registers and spills, and no spill in any
     instance;
 16. large_path: nrx_large and e2e_rt with their committed weights (the
     parts of weights/nrx_large_weights.npz, from the pickle the JAX
     evaluate CLI loads, and of weights/e2e_rt_ema_weights.npz with the
     learned constellation): nrx_large's Monte Carlo at 132 PRB, batch 30,
     float32, DoubleTDLlow (a step through `mc_entry`: 1 sepconv, 8
     iteration, 2 LDPC launches; kernel route = plain route on one step;
     `sim_ber` at 1, 2 and 3 dB inside the band of the JAX package's curve
     with the same weights, a CPU sweep,
     `neural_rx_tpu_torch/curves/jax_nrx_large.json` (the committed curve,
     `curves/nrx_large.json`, was made with other weights: ROADMAP.md R10;
     it stands beside each point); a step's device ms by
     stage and, from the profiler, by kernel beside its bound, and its busy
     share); nrx_large's bf16 serving routes, batch 16 (1 sepconv, 8
     iteration launches) and mega at batch 1 (1 whole-CGNN launch of 8
     iterations), each equal bit for bit to its plain route, with device
     ms; WARM_STEPS Adam steps from the committed weights at phase 1 (UMi,
     4 PRB, batch 128, apply_multiloss, double readout, 8 iterations, no
     kernel): finite losses, the data loss within three standard errors of
     the JAX package's with the same weights (JAX_LARGE_WARM_LOSS), a
     step's device ms and the peak memory; e2e_rt's Monte Carlo (EMA
     weights, learned constellation, 1 user, TDL-B100, batch 20: 1
     sepconv, 4 iteration, 1 LDPC launch; the transmitter's points the
     committed constellation's centred and normalised within 1e-6, kernel
     route = plain route, `sim_ber` at 1, 2 and 3 dB inside the band of
     `curves/e2e_rt.json`), with the same stage and kernel records;
 17. times: CUDA-event device time per kernel launch (kernel and plain) at
     the shapes the main path gives it, with its bound, achieved TFLOP/s
     and share of the bound (the sepconv stack at N = 2 and on the batch-16
     route's init stack at N = 32, the whole-CGNN kernel at batch 1 and
     16, the LDPC kernel at the baseline path's 1-user launch and at a
     dist-path rank's 75 codewords), per call
     and slot on each route, and the eval path's call split into receiver
     and decode for each decoder.
Every kernel_check record carries the share of output elements that differ
from the plain version and, in bfloat16, the largest difference in ulps.
Then the `kernels` line, and last `{"ok": true, "device": {...}}`. Any
failure raises and the script exits non-zero. Without a CUDA device it exits
non-zero before printing anything.
"""

import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

# Tolerances: max |kernel - plain| / max |plain|. float32: the sums run in
# another order (sequential FMA vs cuBLAS). bfloat16: those order
# differences flip the last bit of a rounded activation now and then.
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
# kernels whose float32 instances run the CUDA-core tile (mangled names:
# the template's first argument, float, follows the name as "If")
F32_INSTANCES = ("sepconv_stack_kernel", "cgnn_iter_kernel",
                 "cgnn_full_kernel")
SC_VALID_CASES = (None, (5, 1500))
LDPC_ITER = 20  # the layered decoder's default iteration count
LDPC_OPS = 10   # value operations per edge, lane and iteration
EVAL_EBNO_DB = 10.0
# (item, user) of the transport blocks of eval_entry's example slot (batch
# 16, seed 0, 10 dB) that do not decode: the JAX package's receiver fails
# the same two on the same slot (tests/test_torch_eval_path.py); every other
# one decodes to the bits sent
EVAL_FAILS = {(11, 0), (13, 1)}
ACTIVE_CASES = ((1.0, 1.0), (1.0, 0.0))
MC_BATCH = 30  # nrx_rt's batch_size_eval
MC_SEED = 0
MC_EBNO_DB = 3.0
MC_SWEEP_DB = (2.0, 3.0, 4.0)
MC_TARGET_BLOCK_ERRORS = 100
MC_MAX_ITER = 40
# The JAX package's committed BLER curve of nrx_rt on DoubleTDLlow (132 PRB,
# 2 users, flooding decoder): results/nrx_rt_results.pkl, key
# ('Neural Receiver', 2, 0), Eb/N0 -2 ... 7 dB, measured with an earlier
# EMA snapshot of the committed weights (results/README.md), so a sanity
# band only. results/ is not in the card's copy, hence the constant.
JAX_CURVE_DB = tuple(float(e) for e in range(-2, 8))
JAX_CURVE = (1.0, 0.9916666666666667, 0.8916666666666667, 0.6833333333333333,
             0.37962962962962965, 0.14444444444444443, 0.04065040650406504,
             0.007541666666666667, 0.00125, 8.333333333333333e-05)
BASE_BATCH = 30  # batch_size_eval of nrx_rt and e2e_baseline
BASE_SEED = 0
BASE_SYSTEMS = ("baseline_lslin_lmmse", "baseline_lsnn_lmmse",
                "baseline_lmmse_lmmse", "baseline_lmmse_kbest",
                "baseline_perf_csi_lmmse", "baseline_perf_csi_kbest")
# (configuration, users (None: all), Eb/N0 of the kernel-vs-plain step,
# systems): nrx_rt with 2 users on DoubleTDLlow, e2e_baseline with 1 user on
# TDL-B100
BASE_CASES = (("nrx_rt", None, 4.0, BASE_SYSTEMS),
              ("e2e_baseline", 1, 2.0, ("baseline_lmmse_kbest",
                                        "baseline_perf_csi_kbest")))
# The JAX package's baseline BLER curves (132 PRB, flooding decoder, first
# Eb/N0 and one point a dB), up to the last nonzero point. Committed:
# results/nrx_rt_results.pkl keys ('Baseline - LS/lin+LMMSE', 2, 0) and
# ('Baseline - LS/nn+LMMSE', 2, 0), results/e2e_baseline_results.pkl key
# ('Baseline - Perf. CSI & K-Best', 1, 0). results/ is not in the card's
# copy, hence the constants.
BASE_CURVES = {
    ("nrx_rt", "baseline_lslin_lmmse"): (-2.0, (
        1.0, 1.0, 0.9916666666666667, 0.9166666666666666,
        0.7333333333333333, 0.3287878787878788, 0.11333333333333333,
        0.01565891472868217, 0.00038333333333333334)),
    ("nrx_rt", "baseline_lsnn_lmmse"): (-2.0, (
        1.0, 1.0, 0.9875, 0.9125, 0.7233333333333334, 0.33636363636363636,
        0.1388888888888889, 0.022945205479452054)),
    ("e2e_baseline", "baseline_perf_csi_kbest"): (-1.0, (
        0.5234375, 0.13333333333333333, 0.01, 0.0008333333333333334))}
# The committed LMMSE+K-Best curve (results/e2e_baseline_results.pkl, key
# ('Baseline - LMMSE+K-Best', 1, 0); BASE_COMMITTED) lies 1.5-1.8 dB left
# of what the JAX package's BaselineE2EModel computes. That system is held
# to the curve of the JAX code instead, measured on the CPU with the
# committed covariances by scripts/torch_port_jax_baseline_curve.py (its
# docstring has the command) and committed as this file of the port; the
# committed curve is shown beside the points.
BASE_CURVE_FILES = {("e2e_baseline", "baseline_lmmse_kbest"): os.path.join(
    "neural_rx_tpu_torch", "curves",
    "jax_e2e_baseline_baseline_lmmse_kbest.json")}
BASE_COMMITTED = {("e2e_baseline", "baseline_lmmse_kbest"): (-1.0, (
    0.7481481481481481, 0.29777777777777775, 0.05416666666666667, 0.0025))}
# the short sim_ber points of each curve, on its waterfall
BASE_SWEEP = {("nrx_rt", "baseline_lslin_lmmse"): (3.0, 4.0),
              ("nrx_rt", "baseline_lsnn_lmmse"): (3.0, 4.0),
              ("e2e_baseline", "baseline_lmmse_kbest"): (1.0, 2.0, 3.0),
              ("e2e_baseline", "baseline_perf_csi_kbest"): (0.0,)}
# Several MCS at eval (var_mcs_path): nrx_rt_var_mcs (MCS 9 QPSK and 14
# 16-QAM, one init stack and one LLR readout per MCS), batch 30, with the
# committed weights/nrx_rt_var_mcs_weights.npz, which reproduce the
# own-trained curves of results/nrx_rt_var_mcs_results.pkl (ROADMAP.md C4;
# copied into VAR_CURVE_FILE by scripts/torch_port_export_curves.py, beside
# the imported weights' curves, shown, not asserted)
VAR_LABEL = "nrx_rt_var_mcs"
VAR_BATCH = 30
VAR_SEED = 0
VAR_STEP_DB = {0: 1.0, 1: 2.0}  # Eb/N0 of the kernel-vs-plain step per MCS
VAR_SWEEP = {0: (1.0, 2.0), 1: (2.0, 3.0)}
VAR_CURVE_FILE = os.path.join("neural_rx_tpu_torch", "curves",
                              "nrx_rt_var_mcs.json")
# mixed slots: (MCS evaluation order, one-hot MCS rows of users 0 and 1,
# Eb/N0); user 0's blocks are counted. The committed mixed curves
# (results/mixed_mcs_results.pkl) were made with weights that are not in
# the repository, so both systems are held to the JAX code's curves with
# the committed weights, measured on the CPU by
# scripts/torch_port_jax_baseline_curve.py --mixed-order (its docstring)
MIXED_CASES = {"ue0_qpsk": ((0, 1), ((1.0, 0.0), (0.0, 1.0)), 1.0),
               "ue0_16qam": ((1, 0), ((0.0, 1.0), (1.0, 0.0)), 2.0)}
MIXED_CURVE = os.path.join("neural_rx_tpu_torch", "curves",
                           "jax_mixed_mcs_{system}_{mix}.json")
MASKING_LABEL = "nrx_large_var_mcs_64qam_masking"  # 3 MCS, 8 iterations
MASKING_BATCH = 8  # > 4: the iteration kernel's route
MASKING_SEED = 0
CFO_PPM = 0.1  # the frequency offset of the kernel-vs-plain CFO step
TRAIN_LABEL = "nrx_rt"  # trains at 4 PRB, 2 users, batch 128, UMi
TRAIN_SEED = 0
TRAIN_BATCH = 128  # the batch of every phase of nrx_rt and e2e_rt
TRAIN_STEPS = 400  # Adam steps from the seed-made init
TRAIN_WINDOW = 50  # steps in each mean of the loss-fall check
WARM_STEPS = 20  # steps from the committed weights, phase-1 Eb/N0
# the JAX package's data loss with the committed nrx_rt EMA weights at
# phase-1 sampling on UMi, batch 128, 16 batches, no update (mean, standard
# error): scripts/torch_port_jax_train_loss.py on the CPU
JAX_WARM_LOSS = (0.48769028671085835, 0.019965730458610505)
E2E_LABEL = "e2e_rt"  # learned constellation, masked pilots, no LS input
E2E_STEPS = 40
CLI_SMOKE_ITERS = 200
TRAIN_EVAL_EBNO_DB = 4.0
# the deploy engine (phase deploy_path): nrx_rt, bf16, every bucket
DEPLOY_YARDSTICK_MS = 1.275  # the reference's slot, RTX 3090, TRT fp16
DEPLOY_PRB = 132  # the eval width: the padded, mega and test-vector bucket
DEPLOY_PAD_CASES = (131, 100)  # requests served by the 132-PRB bucket
DEPLOY_BATCH = 16  # the generator/evaluator slot and the slots/s batch
DEPLOY_EBNO_DB = 10.0
DEPLOY_ITERS = 50  # calls per latency measurement
DEPLOY_SEED = 0
# the site-specific path (phase site_path): nrx_site_specific_100k at
# 132 PRB on the eval trajectory, batch 30, float32, committed weights
SITE_LABEL = "nrx_site_specific_100k"
SITE_BASELINE = "nrx_site_specific_baseline"
SITE_TRAIN_LABEL = "nrx_site_specific"  # trains at 4 PRB, batch 128
SITE_BATCH = 30
SITE_SEED = 0
SITE_STEP_DB = 5.0
SITE_SWEEP_DB = (3.0, 7.0)
SITE_TRAIN_STEPS = 20
SITE_CURVE = os.path.join("neural_rx_tpu_torch", "curves",
                          "nrx_site_specific_100k.json")
# md5 of the port's synthetic datasets, the repository's data/ files
SITE_MD5 = {"nrx_site_specific_train.cirbin":
            "e544e3a74fdbe8c6b1b8524ae3c34b36",
            "nrx_site_specific_eval.cirbin":
            "74d4594bc73ca5afedea1ecb091a110e"}
# the committed weights of nrx_large and e2e_rt (phase large_path)
LARGE_LABEL = "nrx_large"  # 8 iterations, 2 users, multiloss training
LARGE_BATCH = 30  # nrx_large's batch_size_eval
LARGE_SERVE_BATCH = 16  # > 4: the iteration kernel's serving route
LARGE_SEED = 0
LARGE_STEP_DB = 2.0  # Eb/N0 of the kernel-vs-plain step
LARGE_SWEEP_DB = (1.0, 2.0, 3.0)
LARGE_CURVE = os.path.join("neural_rx_tpu_torch", "curves",
                           "nrx_large.json")
# the JAX package's BLER with the committed weights, on the CPU: the
# committed curve above was made with other weights (ROADMAP.md R10)
LARGE_JAX_CURVE = os.path.join("neural_rx_tpu_torch", "curves",
                               "jax_nrx_large.json")
# the JAX package's phase-1 data loss of nrx_large with the committed
# weights, apply_multiloss (the sum over the 8 iterations' readouts), on
# UMi, batch 128, 16 batches, no update (mean, standard error), on the CPU:
#   JAX_PLATFORMS=cpu python scripts/torch_port_jax_train_loss.py \
#       --config nrx_large --weights weights/nrx_large_weights.pkl
JAX_LARGE_WARM_LOSS = (3.907813847064972, 0.16878222242128169)
E2E_EVAL_BATCH = 20  # e2e_rt's batch_size_eval, 1 user, TDL-B100
E2E_CURVE = os.path.join("neural_rx_tpu_torch", "curves", "e2e_rt.json")
ROOT = os.path.dirname(os.path.abspath(__file__))
N_SYM, N_SC, N_TX = 14, 1584, 2


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_peaks(name: str) -> dict:
    """Published dense peaks of the card (NVIDIA data sheets): bytes/s,
    bf16 tensor FLOP/s and float32 (non-tensor) FLOP/s."""
    if "H100" in name and "PCIe" in name:
        return {"part": "H100 PCIe", "bytes_per_s": 2.0e12,
                "bf16_flops": 756e12, "f32_flops": 51e12}
    if "H100" in name and "NVL" in name:
        return {"part": "H100 NVL", "bytes_per_s": 3.9e12,
                "bf16_flops": 835e12, "f32_flops": 60e12}
    return {"part": "H100 SXM", "bytes_per_s": 3.35e12,
            "bf16_flops": 989e12, "f32_flops": 67e12}


def stack_flops(widths) -> int:
    """FLOPs of the stack per position: 9 depthwise MACs per input channel,
    c_in*c_out pointwise MACs and the bias, per layer."""
    return sum(2 * 9 * ci + 2 * ci * co + co
               for ci, co in zip(widths[:-1], widths[1:]))


def stack_params(widths) -> int:
    return sum(9 * ci + ci * co + co
               for ci, co in zip(widths[:-1], widths[1:]))


def stack_work(widths, n, h, w, itemsize):
    """(bytes, flops) the stack must move and do: input read once, output
    written once, weights read once."""
    nbytes = (n * h * w * (widths[0] + widths[-1]) + stack_params(widths)) \
        * itemsize
    return nbytes, stack_flops(widths) * n * h * w


def mlp_dims(p):
    return (p["hidden"][0]["w"].shape[0], p["hidden"][0]["w"].shape[1],
            p["out"]["w"].shape[1])


def mlp_flops(dims) -> int:
    i, h, o = dims
    return 2 * i * h + h + 2 * h * o + o


def mlp_params(dims) -> int:
    i, h, o = dims
    return i * h + h + h * o + o


def widths_of(p):
    return [p["hidden"][0]["pw"].shape[0]] + [
        lp["pw"].shape[1] for lp in p["hidden"]] + [p["out"]["pw"].shape[1]]


def iteration_work(it_p, b, d_pe, itemsize, readouts=(), w=N_SC, t=N_TX):
    """(bytes, flops) of one CGNN iteration at 14 x w with b*t images:
    state and pe read once, the state (or the readouts) written once,
    weights read once; per position the aggregation MLP, the user sum,
    difference and scale (3 ops a channel), the update stack and the
    residual, plus the readout MLPs."""
    agg = mlp_dims(it_p["agg"])
    widths = widths_of(it_p["update"])
    d_s = agg[0]
    n_pos = b * t * N_SYM * w
    out_ch = sum(mlp_dims(r)[2] for r in readouts) if readouts else d_s
    flops = n_pos * (mlp_flops(agg) + 3 * d_s + stack_flops(widths) + d_s
                     + sum(mlp_flops(mlp_dims(r)) for r in readouts))
    n_w = mlp_params(agg) + stack_params(widths) + sum(
        mlp_params(mlp_dims(r)) for r in readouts)
    nbytes = (n_pos * (d_s + out_ch) + t * N_SYM * w * d_pe + n_w) \
        * itemsize + b * t * 4
    return nbytes, flops


def full_work(cgnn, b, d_pe, itemsize, t=N_TX):
    """(bytes, flops) of the whole CGNN with t users: z0 and pe read once,
    llr and h_hat written once, weights read once; the init stack, every
    iteration and both readouts per position."""
    init_w = widths_of(cgnn["s_init"][0])
    its = cgnn["iterations"]
    readouts = (cgnn["readout_llrs"][0], cgnn["readout_chest"])
    n_pos = b * t * N_SYM * N_SC
    flops = n_pos * stack_flops(init_w)
    n_w = stack_params(init_w)
    for i, it_p in enumerate(its):
        _, f = iteration_work(it_p, b, d_pe, itemsize,
                              readouts if i == len(its) - 1 else (), t=t)
        flops += f
        n_w += mlp_params(mlp_dims(it_p["agg"])) + stack_params(
            widths_of(it_p["update"]))
    n_w += sum(mlp_params(mlp_dims(r)) for r in readouts)
    out_ch = sum(mlp_dims(r)[2] for r in readouts)
    nbytes = (n_pos * (init_w[0] + out_ch) + t * N_SYM * N_SC * d_pe
              + n_w) * itemsize + b * t * 4
    return nbytes, flops


def bound(nbytes, flops, peaks, rate="bf16_flops"):
    t_bytes = nbytes / peaks["bytes_per_s"] * 1e3
    t_ops = flops / peaks[rate] * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ldpc_work(code, n):
    """(bytes, operations) of a layered decode of n codewords: LLRs read
    and hard bits written once (float32); per edge, lane and iteration 10
    value operations (subtract, abs, sign test, min1, first-min test,
    mask, min2, select, multiply, fused multiply-add)."""
    return (2 * n * code.n_full * 4,
            n * code.num_edges * code.z * LDPC_ITER * LDPC_OPS)


def bpsk_llrs(bits, snr_db, gen):
    """Sionna-convention LLRs log(p1/p0) of bits sent as 1 - 2b over a real
    Gaussian channel of noise variance 10^(-snr_db/10)."""
    import torch
    var = 10.0 ** (-snr_db / 10.0)
    y = (1.0 - 2.0 * bits) + var ** 0.5 * torch.randn(
        bits.shape, generator=gen, device=bits.device)
    return -2.0 * y / var


def rel_err(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def cuda_ms(fn, reps, warmup=3):
    """Device time per call from CUDA events over `reps` back-to-back calls
    on the current stream, after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bf16_line(x):
    """bfloat16 values as integers on a monotone line, one step per ulp:
    the bit pattern for x >= 0, minus the magnitude's for x < 0 (so -0 and
    +0 meet at 0)."""
    import torch
    i = x.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -32768 - i, i)


def differences(got, ref):
    """(share of elements that differ, largest difference in bf16 ulps or
    None for another dtype) over the outputs of one call (tuples)."""
    import torch
    n = sum(g.numel() for g in got)
    if got[0].dtype != torch.bfloat16:
        return sum(int((g != r).sum()) for g, r in zip(got, ref)) / n, None
    steps = [(bf16_line(g) - bf16_line(r)).abs() for g, r in zip(got, ref)]
    return (sum(int((d > 0).sum()) for d in steps) / n,
            max(int(d.max()) for d in steps))


def compare(got, ref, dtype, tol):
    """Error record of kernel outputs against plain outputs (tuples)."""
    import torch
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    ok = all(g.shape == r.shape and g.dtype == dtype
             and bool(torch.isfinite(g).all()) for g, r in zip(got, ref))
    share, ulps = differences(got, ref)
    return {"dtype": str(dtype),
            "max_abs_err": max(float((g.float() - r.float()).abs().max())
                               for g, r in zip(got, ref)),
            "rel_err": max(errs), "differing_share": share,
            "max_ulps": ulps, "tol": tol, "ok": ok and max(errs) <= tol}


def curve_of(first_db, blers):
    """(Eb/N0s, BLERs) of a curve that starts at first_db, a point a dB."""
    return (tuple(first_db + i for i in range(len(blers))), blers)


def json_curve(path, key=None):
    """(Eb/N0s, BLERs) of a committed curve file: a curve-script record
    (its points up to the last with an error), or `key`'s curve of a
    {"ebno_db": [...], "bler": [...]} record."""
    with open(os.path.join(ROOT, path)) as f:
        rec = json.load(f)
    if key is None:
        pts = rec["curve"]
        while pts and pts[-1]["block_errors"] == 0:
            pts = pts[:-1]
        return (tuple(float(pt["ebno_db"]) for pt in pts),
                tuple(float(pt["bler"]) for pt in pts))
    for part in key:
        rec = rec[part]
    pts = [(e, b) for e, b in zip(rec["ebno_db"], rec["bler"]) if b > 0]
    return tuple(e for e, _ in pts), tuple(b for _, b in pts)


def base_curve(label: str, system: str):
    """(Eb/N0s, BLERs) of a baseline's JAX curve, up to its last nonzero
    point: the constants of BASE_CURVES or the committed file of
    BASE_CURVE_FILES."""
    path = BASE_CURVE_FILES.get((label, system))
    if path is None:
        return curve_of(*BASE_CURVES[(label, system)])
    return json_curve(path)


def jax_bler(ebno_db: float, curve=(JAX_CURVE_DB, JAX_CURVE)) -> float:
    """A committed JAX curve (default: the neural receiver's) at ebno_db,
    interpolated in log10 BLER."""
    dbs, blers = curve
    return float(10.0 ** np.interp(ebno_db, dbs, np.log10(blers)))


def jax_ebno(bler: float, curve=(JAX_CURVE_DB, JAX_CURVE)) -> float:
    """The Eb/N0 at which a committed JAX curve reaches `bler`."""
    dbs, blers = curve
    return float(np.interp(-np.log10(bler), -np.log10(blers), dbs))


def curve_point(e, ber, bler, errs, blocks, curve):
    """A sim_ber point with its Wilson interval beside a committed JAX
    curve and that curve's band, 1 dB to either side."""
    from neural_rx_tpu_torch.sim.simber import bler_confidence_interval
    return {"ebno_db": e, "ber": float(ber), "bler": float(bler),
            "block_errors": int(errs), "blocks": int(blocks),
            "wilson95": bler_confidence_interval(int(errs), int(blocks)),
            "jax_bler": jax_bler(e, curve),
            # past the curve's last nonzero point the JAX run saw no error
            "band": (jax_bler(e + 1.0, curve) if e + 1.0 <= curve[0][-1]
                     else 0.0, jax_bler(e - 1.0, curve)),
            "db_behind_jax": (e - jax_ebno(float(bler), curve)
                              if bler > 0 else None)}


def block_counts(b, b_hat):
    """(bit errors, block errors) of one Monte-Carlo batch."""
    errs = (b != b_hat).sum(dim=-1)
    return int(errs.sum()), int((errs > 0).sum())


def rates(rec):
    """A timing record with its achieved TFLOP/s and its share of the
    bound (bound_ms / kernel_ms, in %)."""
    return {**rec, "tflops": rec["flops"] / rec["kernel_ms"] / 1e9,
            "pct_of_bound": 100.0 * rec["bound_ms"] / rec["kernel_ms"]}


def baseline_path(dev, card, counts, reset, nrx_points):
    """Phase 8: the classical baselines (`BaselineE2EModel`) with K5 on the
    configurations of BASE_CASES in eval mode (132 PRB), BASE_BATCH slots a
    step. Emits the phase's record, asserts it, and returns the K5
    launches of one step per system.
    nrx_points: the mc path's sweep points with K5 (the neural receiver at
    4 dB is held to beat LS/lin + LMMSE)."""
    import torch
    from neural_rx_tpu_torch.channel.apply import apply_ofdm_channel
    from neural_rx_tpu_torch.sim.baseline_e2e import (
        BaselineE2EModel, load_or_compute_covariances)
    from neural_rx_tpu_torch.sim.config import Parameters
    from neural_rx_tpu_torch.sim.simber import make_eval_step, sim_ber

    t0 = time.perf_counter()
    base_launches, base_plain, base_models, cov_seconds = {}, {}, {}, {}
    expected_base = {}
    with tempfile.TemporaryDirectory() as cov_dir:
        for label, users, ebno, systems in BASE_CASES:
            p_b = Parameters(label, training=False, num_tx_eval=users)
            if any("_lmmse_" in s_ for s_ in systems):
                # the LMMSE estimate's covariances, on the card
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                load_or_compute_covariances(p_b, cov_dir, dev)
                torch.cuda.synchronize()
                cov_seconds[label] = time.perf_counter() - t1
            for system in systems:
                key = f"{label}_{system}"
                models = [BaselineE2EModel(p_b, system, cov_dir=cov_dir,
                                           kernels=k, device=dev)
                          for k in (True, False)]
                base_models[(label, system)] = models[0]
                outs = []
                for m in models:
                    gen_b = torch.Generator(device=dev).manual_seed(BASE_SEED)
                    reset()
                    outs.append(m({}, gen_b, BASE_BATCH, ebno,
                                  fast_ldpc=True))
                    torch.cuda.synchronize()
                    if m.kernels:
                        base_launches[key] = counts()
                reset()
                (b, b_hat, crc), ref = outs
                expected_base[key] = {"sepconv_stack": 0, "cgnn_iter": 0,
                                      "cgnn_full": 0,
                                      "ldpc_decode": p_b.max_num_tx}
                base_plain[key] = {
                    "ebno_db": ebno, "users": p_b.max_num_tx,
                    "counters": block_counts(b, b_hat),
                    "counters_plain": block_counts(ref[0], ref[1]),
                    "b_hat_shape": list(b_hat.shape),
                    "crc_truthful": bool(torch.equal(
                        (b_hat == b).all(dim=-1), crc)),
                    "equals_plain_route": all(
                        torch.equal(x, y) for x, y in zip(outs[0], ref))}
                del models, outs, ref

        base_sweep = {}
        for (label, system), dbs in BASE_SWEEP.items():
            model = base_models[(label, system)]
            curve = base_curve(label, system)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            bers, blers, n_err, n_blk = sim_ber(
                model, {}, dbs, BASE_BATCH, max_mc_iter=MC_MAX_ITER,
                num_target_block_errors=MC_TARGET_BLOCK_ERRORS,
                seed=BASE_SEED, verbose=False, fast_ldpc=True,
                return_counts=True)
            wall = time.perf_counter() - t1
            steps = int(n_blk.sum()) // (BASE_BATCH * model.p.max_num_tx)
            points = [curve_point(*pt, curve) for pt in zip(
                dbs, bers, blers, n_err, n_blk)]
            if (label, system) in BASE_COMMITTED:
                committed = curve_of(*BASE_COMMITTED[(label, system)])
                for pt in points:
                    pt["committed_jax_bler"] = jax_bler(pt["ebno_db"],
                                                        committed)
            base_sweep[f"{label}_{system}"] = {
                "points": points, "steps": steps, "wall_s": wall,
                "slots_per_s_wall": steps * BASE_BATCH / wall}

        # device ms of a step: draws + transmitter + channel, estimation,
        # detection, decode (K5); host ms of whole steps
        base_times = {}
        for (label, system), model in base_models.items():
            ebno = {c[0]: c[2] for c in BASE_CASES}[label]
            no = model.p.noise_variance(ebno)
            gen_t = torch.Generator(device=dev).manual_seed(BASE_SEED + 1)

            def front(model=model, gen_t=gen_t, ebno=ebno):
                (b_,), h_, n_ = model.draw(gen_t, BASE_BATCH, ebno)
                return apply_ofdm_channel(model.transmitter(b_), h_, None,
                                          noise=n_), h_
            y_b, h_b = front()
            h_hat = model.estimate(y_b, h_b, no)
            llr_b = model.detect(y_b, h_hat, no)
            rec = {"batch": BASE_BATCH, "users": model.p.max_num_tx,
                   "ebno_db": ebno,
                   "front_ms": cuda_ms(front, 3, warmup=1),
                   "estimate_ms": cuda_ms(
                       lambda: model.estimate(y_b, h_b, no), 3, warmup=1),
                   "detect_ms": cuda_ms(
                       lambda: model.detect(y_b, h_hat, no), 3, warmup=1),
                   "decode_ms": cuda_ms(
                       lambda: model.decode(llr_b, True), 3, warmup=1)}
            rec["device_step_ms"] = sum(rec[k] for k in (
                "front_ms", "estimate_ms", "detect_ms", "decode_ms"))
            rec["slots_per_s_device"] = BASE_BATCH / rec[
                "device_step_ms"] * 1e3
            step = make_eval_step(model, fast_ldpc=True)
            host_ms = []
            for _ in range(3):
                t1 = time.perf_counter()
                step({}, gen_t, BASE_BATCH, ebno)
                host_ms.append((time.perf_counter() - t1) * 1e3)
            rec["step_host_ms_median"] = float(np.median(host_ms))
            rec["slots_per_s_wall"] = BASE_BATCH / rec[
                "step_host_ms_median"] * 1e3
            sw = base_sweep.get(f"{label}_{system}")
            if sw is not None:
                rec["sweep_slots_per_s_wall"] = sw["slots_per_s_wall"]
            base_times[f"{label}_{system}"] = rec
            del y_b, h_b, h_hat, llr_b
        del base_models
    nrx_4db = next(pt for pt in nrx_points if pt["ebno_db"] == 4.0)
    lslin_4db = next(pt for pt in base_sweep[
        "nrx_rt_baseline_lslin_lmmse"]["points"] if pt["ebno_db"] == 4.0)
    ordering = {"nrx_bler_4db": nrx_4db["bler"],
                "lslin_bler_4db": lslin_4db["bler"],
                "wilson_disjoint": bool(nrx_4db["wilson95"][1]
                                        < lslin_4db["wilson95"][0])}
    emit({"phase": "baseline_path", "batch": BASE_BATCH,
          "covariance_seconds": cov_seconds, "launches": base_launches,
          "expected": expected_base, "kernel_vs_plain": base_plain,
          "sweep": base_sweep, "nrx_vs_lslin": ordering,
          "times": base_times, "card": card,
          "seconds": time.perf_counter() - t0})
    for key, rec in base_plain.items():
        assert base_launches[key] == expected_base[key], (key, base_launches)
        assert rec["equals_plain_route"] and rec["crc_truthful"], (key, rec)
    for key, sw in base_sweep.items():
        for pt in sw["points"]:
            lo, hi = pt["band"]
            assert lo <= pt["bler"] <= hi, (key, pt)
    assert ordering["nrx_bler_4db"] < ordering["lslin_bler_4db"], ordering
    return base_launches


def var_mcs_path(dev, card, peaks, counts, reset):
    """Phase 9: several MCS at eval, 132 PRB, float32, with K5: launches
    of a step on each MCS and in a mixed slot; kernel route = plain route
    on MCS 0, MCS 1, the mixed slot, one iteration, and a frequency offset
    on nrx_rt; BLER points per MCS and in the mixed slots inside their
    curves' bands; the masking configuration (3 MCS, 8 iterations, seed-made
    parameters) and K4 at 8 iterations against their plain routes; the
    evaluate CLI on MCS 1; a step's device ms by stage. Emits the phase's
    record, asserts it, and returns (launches by path, timing records for
    the kernels line)."""
    import torch
    from neural_rx_tpu_torch import weights
    from neural_rx_tpu_torch.channel.apply import apply_ofdm_channel
    from neural_rx_tpu_torch.cli import evaluate as cli_evaluate
    from neural_rx_tpu_torch.entry import (load_params, mc_entry,
                                           mixed_mcs_entry)
    from neural_rx_tpu_torch.kernels import cgnn_iter
    from neural_rx_tpu_torch.kernels import ldpc as k5
    from neural_rx_tpu_torch.phy.nr import tb
    from neural_rx_tpu_torch.rx.neural_rx import mcs_mask, receiver_for
    from neural_rx_tpu_torch.sim.config import Parameters
    from neural_rx_tpu_torch.sim.e2e import E2EModel
    from neural_rx_tpu_torch.sim.mixed_mcs import (MixedMCSBaselineModel,
                                                   MixedMCSE2EModel)
    from neural_rx_tpu_torch.sim.simber import sim_ber

    t0 = time.perf_counter()
    launches = {}
    k_all = {"sepconv_stack": 2, "cgnn_iter": 2, "cgnn_full": 0,
             "ldpc_decode": 2}
    expected = {"var_mcs0_b30": k_all, "var_mcs1_b30": k_all,
                "var_mixed_b30": k_all,
                "var_mixed_lslin_b30": {"sepconv_stack": 0, "cgnn_iter": 0,
                                        "cgnn_full": 0, "ldpc_decode": 1}}

    # (a) launches of one step through the entry points
    runs = {"var_mcs0_b30": lambda: mc_entry(
                device=dev, batch=VAR_BATCH, ebno_db=VAR_STEP_DB[0],
                seed=VAR_SEED, config=VAR_LABEL, mcs_idx=0),
            "var_mcs1_b30": lambda: mc_entry(
                device=dev, batch=VAR_BATCH, ebno_db=VAR_STEP_DB[1],
                seed=VAR_SEED, config=VAR_LABEL, mcs_idx=1),
            "var_mixed_b30": lambda: mixed_mcs_entry(
                VAR_LABEL, *MIXED_CASES["ue0_qpsk"][:2], system="nrx",
                device=dev, batch=VAR_BATCH, seed=VAR_SEED),
            "var_mixed_lslin_b30": lambda: mixed_mcs_entry(
                VAR_LABEL, *MIXED_CASES["ue0_qpsk"][:2], system="lslin",
                device=dev, batch=VAR_BATCH, seed=VAR_SEED)}
    step_counts = {}
    for route, make in runs.items():
        fn, args = make()
        reset()
        step_counts[route] = fn(*args).tolist()
        torch.cuda.synchronize()
        launches[route] = counts()
    reset()

    # (b) kernel route = plain route on the same draws
    p_v = Parameters(VAR_LABEL, training=False)
    params_v = load_params(dtype=p_v.nrx_dtype, device=dev,
                           path=weights.committed_weights(VAR_LABEL))
    models_v = [E2EModel(p_v, kernels=k, device=dev) for k in (True, False)]
    mixed_models = {
        mix: [MixedMCSE2EModel(p_v, order, mcs_ue_mask=torch.tensor([rows]),
                               kernels=k, device=dev) for k in (True, False)]
        for mix, (order, rows, _) in MIXED_CASES.items()}
    p_cfo = Parameters("nrx_rt", training=False,
                       overrides={"cfo_offset_ppm": CFO_PPM})
    params_rt = load_params(dtype=p_cfo.nrx_dtype, device=dev)
    models_cfo = [E2EModel(p_cfo, kernels=k, device=dev)
                  for k in (True, False)]
    cases = {
        "mcs0": (models_v, params_v, VAR_STEP_DB[0], {"mcs_arr_eval_idx": 0}),
        "mcs1": (models_v, params_v, VAR_STEP_DB[1], {"mcs_arr_eval_idx": 1}),
        "mixed_ue0_qpsk": (mixed_models["ue0_qpsk"], params_v,
                           MIXED_CASES["ue0_qpsk"][2], {}),
        "mcs0_num_it_1": (models_v, params_v, VAR_STEP_DB[0],
                          {"mcs_arr_eval_idx": 0, "num_it": 1}),
        "nrx_rt_cfo": (models_cfo, params_rt, 4.0, {})}
    plain = {}
    for case, (models, params, ebno, kw) in cases.items():
        outs = []
        for m in models:
            gen = torch.Generator(device=dev).manual_seed(VAR_SEED)
            outs.append(m(params, gen, VAR_BATCH, ebno, fast_ldpc=True, **kw))
        torch.cuda.synchronize()
        (b, b_hat, crc), ref = outs
        plain[case] = {
            "ebno_db": ebno, "counters": block_counts(b, b_hat),
            "counters_plain": block_counts(ref[0], ref[1]),
            "crc_truthful": bool(torch.equal((b_hat == b).all(dim=-1), crc)),
            "equals_plain_route": all(torch.equal(x, y)
                                      for x, y in zip(outs[0], ref))}
    reset()
    del models_cfo, params_rt

    # (c) BLER per MCS, (d) in the mixed slots, with K5
    with open(os.path.join(ROOT, VAR_CURVE_FILE)) as f:
        assert json.load(f)["config"] == VAR_LABEL
    sweep = {}
    for mcs, dbs in VAR_SWEEP.items():
        curve = json_curve(VAR_CURVE_FILE, ("own", str(mcs)))
        other = json_curve(VAR_CURVE_FILE, ("ref", str(mcs)))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bers, blers, n_err, n_blk = sim_ber(
            models_v[0], params_v, dbs, VAR_BATCH, max_mc_iter=MC_MAX_ITER,
            num_target_block_errors=MC_TARGET_BLOCK_ERRORS, seed=VAR_SEED,
            verbose=False, fast_ldpc=True, return_counts=True,
            mcs_arr_eval_idx=mcs)
        wall = time.perf_counter() - t1
        points = [curve_point(*pt, curve) for pt in zip(
            dbs, bers, blers, n_err, n_blk)]
        for pt in points:
            pt["imported_weights_bler"] = jax_bler(pt["ebno_db"], other)
        steps = int(n_blk.sum()) // (VAR_BATCH * N_TX)
        sweep[f"mcs{mcs}"] = {"points": points, "steps": steps,
                              "wall_s": wall,
                              "slots_per_s_wall": steps * VAR_BATCH / wall}
    mixed = {}
    for mix, (order, rows, ebno) in MIXED_CASES.items():
        mask = torch.tensor([rows])
        committed = json_curve(VAR_CURVE_FILE, (
            "mixed", f"nrx_ue0_mcs{order[0]}"))
        for system, cls in (("nrx", MixedMCSE2EModel),
                            ("lslin", MixedMCSBaselineModel)):
            model = cls(p_v, order, mcs_ue_mask=mask, device=dev)
            curve = json_curve(MIXED_CURVE.format(system=system, mix=mix))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            bers, blers, n_err, n_blk = sim_ber(
                model, params_v if system == "nrx" else {}, [ebno],
                VAR_BATCH, max_mc_iter=MC_MAX_ITER,
                num_target_block_errors=MC_TARGET_BLOCK_ERRORS,
                seed=VAR_SEED, verbose=False, fast_ldpc=True,
                return_counts=True)
            wall = time.perf_counter() - t1
            pt = curve_point(ebno, bers[0], blers[0], n_err[0], n_blk[0],
                             curve)
            if system == "nrx":
                pt["imported_weights_bler"] = jax_bler(ebno, committed)
            mixed[f"{system}_{mix}"] = {
                "point": pt, "steps": int(n_blk[0]) // VAR_BATCH,
                "wall_s": wall,
                "slots_per_s_wall": int(n_blk[0]) / wall}
            del model
    del mixed_models

    # (e) the masking configuration: seed-made parameters, each MCS
    p_m = Parameters(MASKING_LABEL, training=False)
    models_m = [E2EModel(p_m, kernels=k, device=dev) for k in (True, False)]
    params_m = models_m[0].receiver.init_params(
        torch.Generator(device=dev).manual_seed(MASKING_SEED))
    masking = {}
    for mcs in range(len(p_m.mcs_index)):
        outs = []
        for m in models_m:
            gen = torch.Generator(device=dev).manual_seed(MASKING_SEED)
            reset()
            outs.append(m(params_m, gen, MASKING_BATCH, 4.0, fast_ldpc=True,
                          mcs_arr_eval_idx=mcs))
            torch.cuda.synchronize()
            if m.receiver.cgnn_cfg.kernels:
                launches[f"masking_mcs{mcs}_b{MASKING_BATCH}"] = counts()
        (b, b_hat, crc), ref = outs
        masking[f"mcs{mcs}"] = {
            "bits_per_symbol": p_m.transmitters[mcs].num_bits_per_symbol,
            "b_hat_shape": list(b_hat.shape),
            "equals_plain_route": all(torch.equal(x, y)
                                      for x, y in zip(outs[0], ref))}
        expected[f"masking_mcs{mcs}_b{MASKING_BATCH}"] = {
            "sepconv_stack": 1, "cgnn_iter": 8, "cgnn_full": 0,
            "ldpc_decode": 2}
    reset()
    del models_m, params_m

    # K4 at 8 iterations (nrx_large widths, seed-made), the mega route at
    # batch 1 against its plain route, bf16 as served and float32
    p_l = Parameters("nrx_large", training=False)
    k4 = {}
    y1 = torch.as_tensor(np.random.default_rng(2).normal(
        size=(1, 4, N_SYM, N_SC, 2)), dtype=torch.float32, device=dev)
    for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
        rxs = [receiver_for(p_l, nrx_dtype=dtype, fused_full=True, kernels=k,
                            device=dev) for k in (True, False)]
        params_l = rxs[0].init_params(
            torch.Generator(device=dev).manual_seed(MASKING_SEED))
        assert len(params_l["cgnn"]["iterations"]) == 8
        reset()
        got = rxs[0].serve(params_l, y1)
        torch.cuda.synchronize()
        launches[f"mega_8it_b1_{str(dtype)[6:]}"] = counts()
        expected[f"mega_8it_b1_{str(dtype)[6:]}"] = {
            "sepconv_stack": 0, "cgnn_iter": 0, "cgnn_full": 1,
            "ldpc_decode": 0}
        ref = rxs[1].serve(params_l, y1)
        torch.cuda.synchronize()
        k4[str(dtype)] = {"llr": rel_err(got[0], ref[0]),
                          "h_hat": rel_err(got[1], ref[1]), "tol": tol,
                          "finite": bool(torch.isfinite(got[0]).all())}
    reset()
    # K4's time alone at 8 iterations, bf16, batch 1
    cgnn_l = params_l["cgnn"]
    gen = torch.Generator(device=dev).manual_seed(3)
    z1 = torch.randn((1, N_TX, N_SYM, N_SC, 18), generator=gen,
                     device=dev).to(torch.bfloat16)
    pe = rxs[0].pe.to(torch.bfloat16)
    act1 = torch.ones((1, N_TX), device=dev)
    got = cgnn_iter.fused_cgnn_full(cgnn_l, z1, pe, act1)
    ref = cgnn_iter.fused_cgnn_full_reference(cgnn_l, z1, pe, act1)
    torch.cuda.synchronize()
    k4_check = compare(got, ref, torch.bfloat16, TOL_BF16)
    k4_time = rates({
        "iterations": 8, "shape": list(z1.shape),
        "kernel_ms": cuda_ms(
            lambda: cgnn_iter.fused_cgnn_full(cgnn_l, z1, pe, act1), 10),
        "plain_ms": cuda_ms(lambda: cgnn_iter.fused_cgnn_full_reference(
            cgnn_l, z1, pe, act1), 3, warmup=1),
        **bound(*full_work(cgnn_l, 1, pe.shape[-1], 2), peaks)})
    reset()
    del rxs, params_l, cgnn_l

    # (f) the evaluate CLI on MCS 1
    with tempfile.TemporaryDirectory() as results:
        t1 = time.perf_counter()
        cli_evaluate.main(["--config", VAR_LABEL, "--mcs-idx", "1", "--snr",
                           "3", "--max-iter", "2", "--fast-ldpc",
                           "--results-dir", results])
        cli_seconds = time.perf_counter() - t1
        path = os.path.join(results, f"{VAR_LABEL}_results.pkl")
        with open(path, "rb") as f:
            ebno_cli, _, bler_cli = pickle.load(f)
        cli = {"seconds": cli_seconds, "ebno_db": list(map(float, ebno_cli)),
               "keys": [list(k) for k in bler_cli],
               "bler": [float(v[0]) for v in bler_cli.values()]}
    reset()

    # (g) device ms of a step by stage: draws + transmitter + channel,
    # receiver, decode (both users, K5); one MCS and the mixed slot
    model = models_v[0]
    rx = model.receiver
    gen_t = torch.Generator(device=dev).manual_seed(VAR_SEED + 1)
    order, rows, _ = MIXED_CASES["ue0_qpsk"]
    mask_mixed = torch.tensor([rows], device=dev).expand(VAR_BATCH, -1, -1)

    def front(order, mask):
        bits, h_, n_ = model.draw(gen_t, VAR_BATCH, 1.0, order)
        x = model.transmit(bits, order, mask)
        return apply_ofdm_channel(x, h_, None, noise=n_)
    mask0 = mcs_mask((VAR_BATCH, N_TX), 0, model.num_mcs, dev)
    y_t = front([0], mask0)
    y_tp = torch.stack([y_t.real, y_t.imag], dim=-1)
    ones = torch.ones((VAR_BATCH, N_TX), device=dev)
    llrs, _, _ = rx._cgnn(params_v, y_tp, ones, None, None, mask0)
    times = {"batch": VAR_BATCH,
             "front_ms": cuda_ms(lambda: front([0], mask0), 3, warmup=1),
             "front_mixed_ms": cuda_ms(lambda: front(list(order),
                                                     mask_mixed), 3,
                                       warmup=1),
             "receiver_ms": cuda_ms(lambda: rx._cgnn(
                 params_v, y_tp, ones, None, None, mask0), 3, warmup=1)}
    for mcs in (0, 1):
        tbs = rx.tb_configs[mcs]

        def decode_both(mcs=mcs, tbs=tbs):
            flat = rx.rg.demap_data(llrs[mcs]).reshape(VAR_BATCH, N_TX, -1)
            return [k5.tb_decode_fast(cfg, flat[:, ue])
                    for ue, cfg in enumerate(tbs)]
        decode_ms = cuda_ms(decode_both, 3, warmup=1)
        step_ms = times["front_ms"] + times["receiver_ms"] + decode_ms
        sw = sweep[f"mcs{mcs}"]
        times[f"mcs{mcs}"] = {
            "decode_ms": decode_ms, "device_step_ms": step_ms,
            "slots_per_s_device": VAR_BATCH / step_ms * 1e3,
            "sweep_slots_per_s_wall": sw["slots_per_s_wall"],
            "sweep_host_share": 1.0 - sw["steps"] * step_ms / 1e3
            / sw["wall_s"]}
    mixed_ms = times["front_mixed_ms"] + times["receiver_ms"] + times[
        "mcs0"]["decode_ms"]
    times["mixed"] = {"device_step_ms": mixed_ms,
                      "slots_per_s_device": VAR_BATCH / mixed_ms * 1e3,
                      "sweep_slots_per_s_wall": mixed["nrx_ue0_qpsk"][
                          "slots_per_s_wall"]}
    # K5 at the MCS-9 (QPSK) launch: one user's codewords of the step
    cfg_q = rx.tb_configs[0][0]
    llr_q = tb.codeword_llrs(cfg_q, rx.rg.demap_data(llrs[0]).reshape(
        VAR_BATCH, N_TX, -1)[:, 0]).reshape(-1, cfg_q.code.n_full)
    llr_q = llr_q.contiguous()
    k5_qpsk = rates({
        "codewords": int(llr_q.shape[0]), "bg": cfg_q.code.bg,
        "z": cfg_q.code.z,
        "kernel_ms": cuda_ms(
            lambda: k5.layered_decode(cfg_q.code, llr_q, LDPC_ITER), 10),
        "plain_ms": cuda_ms(lambda: k5.layered_decode_reference(
            cfg_q.code, llr_q, LDPC_ITER), 2, warmup=1),
        **bound(*ldpc_work(cfg_q.code, llr_q.shape[0]), peaks,
                rate="f32_flops")})
    reset()
    del models_v, y_t, y_tp, llrs

    emit({"phase": "var_mcs_path", "config": VAR_LABEL, "batch": VAR_BATCH,
          "launches": launches, "expected": expected,
          "step_counts": step_counts, "kernel_vs_plain": plain,
          "sweep": sweep, "mixed": mixed, "masking": masking,
          "mega_8it": k4, "k4_8it_check": k4_check, "k4_8it_time": k4_time,
          "cli": cli, "times": times, "k5_qpsk": k5_qpsk, "card": card,
          "seconds": time.perf_counter() - t0})
    for route, want in expected.items():
        assert launches[route] == want, (route, launches[route])
    for case, rec in {**plain, **masking}.items():
        assert rec["equals_plain_route"], (case, rec)
    for case, rec in plain.items():
        assert rec["crc_truthful"], (case, rec)
    points = [pt for sw in sweep.values() for pt in sw["points"]] + [
        rec["point"] for rec in mixed.values()]
    for pt in points:
        lo, hi = pt["band"]
        assert lo <= pt["bler"] <= hi, pt
    for mix in MIXED_CASES:
        assert mixed[f"nrx_{mix}"]["point"]["bler"] < mixed[
            f"lslin_{mix}"]["point"]["bler"], (mix, mixed)
    for rec in k4.values():
        assert rec["finite"] and max(rec["llr"], rec["h_hat"]) <= rec["tol"]
    assert k4_check["ok"], k4_check
    assert cli["keys"] == [["Neural Receiver", 2, 1]], cli
    return launches, {"k4_8it": k4_time, "k5_qpsk": k5_qpsk}


def train_path(dev, card, counts, reset):
    """Phase 10: training at nrx_rt's training width on the card, the
    e2e_rt phase 0, the train CLI's smoke, the trained parameters through
    the eval receiver with its kernels, covariances on UMi. Emits the
    phase's record, asserts it, and returns the launches by path."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from neural_rx_tpu_torch import weights
    from neural_rx_tpu_torch.channel.apply import apply_ofdm_channel
    from neural_rx_tpu_torch.channel.tr38901 import UMiUMaChannel
    from neural_rx_tpu_torch.cli import compute_cov
    from neural_rx_tpu_torch.cli import evaluate as cli_evaluate
    from neural_rx_tpu_torch.cli import train as cli_train
    from neural_rx_tpu_torch.entry import pack_params, train_entry
    from neural_rx_tpu_torch.phy.constellation import Constellation
    from neural_rx_tpu_torch.sim import training
    from neural_rx_tpu_torch.sim.config import Parameters
    from neural_rx_tpu_torch.sim.e2e import E2EModel

    t0 = time.perf_counter()
    zero = {"sepconv_stack": 0, "cgnn_iter": 0, "cgnn_full": 0,
            "ldpc_decode": 0}
    expected = {"train_step_b128": zero,
                "train_eval_b30": {"sepconv_stack": 1, "cgnn_iter": 2,
                                   "cgnn_full": 0, "ldpc_decode": 2}}
    launches = {}

    # (a) the UMi channel on the card, at the bars of tests/test_tr38901.py
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    umi = UMiUMaChannel("umi", 2.14e9, num_rx_ant=4, num_tx_ant=2,
                        min_speed=0.0, max_speed=56.0)
    h = umi(gen, 128, 2, 14, 48, 30e3)
    h_pow = umi(gen, 64, 1, 1, 16, 30e3)
    h0 = umi(gen, 128, 1, 1, 256, 30e3)[:, 0, 0, 0, 0]
    hu = umi(gen, 512, 2, 1, 1, 30e3)
    p0 = (h0.abs() ** 2).mean()
    u1, u2 = hu[:, 0, 0, 0, 0, 0], hu[:, 0, 1, 0, 0, 0]
    umi_rec = {
        "shape": list(h.shape),
        "finite": bool(torch.isfinite(torch.view_as_real(h)).all()),
        "mean_power": float((h_pow.abs() ** 2).mean()),
        "corr_adjacent_sc": float((h0[:, :-1] * h0[:, 1:].conj()).mean()
                                  .abs() / p0),
        "corr_128_sc": float((h0[:, :-128] * h0[:, 128:].conj()).mean()
                             .abs() / p0),
        "corr_users": float((u1 * u2.conj()).mean().abs() / torch.sqrt(
            (u1.abs() ** 2).mean() * (u2.abs() ** 2).mean())),
        "cfr_ms_b128": cuda_ms(lambda: umi(gen, 128, 2, 14, 48, 30e3), 10)}
    del h, h_pow, h0, hu

    # (b) nrx_rt from a seed-made init, phase 0, TRAIN_STEPS steps
    fn, (params, gen) = train_entry(TRAIN_LABEL, device=dev,
                                    batch=TRAIN_BATCH, seed=TRAIN_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t1 = time.perf_counter()
    hist = training.loss_history([fn(params, gen)
                                  for _ in range(TRAIN_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches["train_step_b128"] = counts()
    reset()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ld = hist[:, 0]
    first, last = ld[:TRAIN_WINDOW], ld[-TRAIN_WINDOW:]
    se = float(np.sqrt(first.var(ddof=1) / len(first)
                       + last.var(ddof=1) / len(last)))
    fall = {"steps": TRAIN_STEPS, "first_losses": hist[:3].tolist(),
            "last_losses": hist[-3:].tolist(),
            "first_mean": float(first.mean()),
            "last_mean": float(last.mean()), "combined_se": se,
            "all_finite": bool(np.isfinite(hist).all()),
            "wall_s": wall, "steps_per_s_wall": TRAIN_STEPS / wall,
            "peak_memory_gb": peak_gb}
    print(f"train nrx_rt: loss_data first {hist[0, 0]:.4f} mean(first "
          f"{TRAIN_WINDOW}) {fall['first_mean']:.4f} -> mean(last "
          f"{TRAIN_WINDOW}) {fall['last_mean']:.4f}, last {hist[-1, 0]:.4f}",
          flush=True)

    # a step's device ms by stage (the step's own pieces, in its order)
    p = Parameters(TRAIN_LABEL, training=True)
    model = E2EModel(p, training=True, device=dev)
    sched = p.training_schedule
    tp = training.trainable(params)
    opt = training.make_adam(tp, float(sched["learning_rate"][0]))
    step = training.make_step(model, p, opt, [0], TRAIN_BATCH, True,
                              float(sched["weighting_double_readout"][0]),
                              False, False)
    step.set_snr_range(sched["min_training_snr_db"][0],
                       sched["max_training_snr_db"][0])
    stages = {k: [] for k in ("draws_tx_ms", "channel_ms", "forward_ms",
                              "backward_ms", "adam_ms")}
    for i in range(8):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        snr, active, mm = step.sample(gen)
        bits = model._bits(gen, TRAIN_BATCH, [0])
        slot = torch.randint(0, model._num_slots, (), generator=gen,
                             device=dev)
        x, coded = model.transmit(bits, [0], mm, active, slot,
                                  return_coded=True)
        ev[1].record()
        h = model._channel(gen, TRAIN_BATCH)
        y = apply_ofdm_channel(x, h, None, noise=model._noise(
            gen, TRAIN_BATCH, snr, 0))
        ev[2].record()
        opt.zero_grad(set_to_none=True)
        l_d, l_c = model.receiver.training_loss(tp, y, active, coded, h, mm,
                                                slot_idx=slot)
        loss = l_d + 0.02 * l_c
        ev[3].record()
        loss.backward()
        ev[4].record()
        opt.step()
        ev[5].record()
        torch.cuda.synchronize()
        if i >= 2:
            for k, (a, b) in zip(stages, zip(ev[:-1], ev[1:])):
                stages[k].append(a.elapsed_time(b))
    stage_ms = {k: float(np.median(v)) for k, v in stages.items()}
    stage_ms["step_ms"] = sum(stage_ms.values())
    del tp, opt, step, x, h, y, loss
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(3):
            fn(params, gen)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t1) * 1e3
    busy_ms = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    n_kernels = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    profile_rec = {"steps": 3, "window_ms_per_step": window_ms / 3,
                   "device_busy_ms_per_step": busy_ms / 3,
                   "device_busy_share": busy_ms / window_ms,
                   "kernels_per_step": n_kernels / 3}

    # (c) warm start from the committed weights, phase-1 Eb/N0
    p_rt = Parameters(TRAIN_LABEL, training=True)
    warm_model = E2EModel(p_rt, training=True, device=dev)
    warm, copied, kept = training.merge_matching_leaves(
        warm_model.init_params(gen),
        training.load_weights(weights.NRX_RT_EMA, dev))
    warm = training.trainable(warm)
    sched = p_rt.training_schedule
    wstep = training.make_step(
        warm_model, p_rt, training.make_adam(
            warm, float(sched["learning_rate"][1])), [0], TRAIN_BATCH, True,
        float(sched["weighting_double_readout"][1]), False, False)
    wstep.set_snr_range(sched["min_training_snr_db"][1],
                        sched["max_training_snr_db"][1])
    whist = training.loss_history([wstep(warm, gen)
                                   for _ in range(WARM_STEPS)])
    w_se = float(whist[:, 0].std(ddof=1) / np.sqrt(WARM_STEPS))
    warm_rec = {"copied": copied, "kept": kept, "steps": WARM_STEPS,
                "loss_data_mean": float(whist[:, 0].mean()),
                "loss_data_se": w_se,
                "init_first_mean": fall["first_mean"],
                "init_first_se": float(first.std(ddof=1)
                                       / np.sqrt(len(first))),
                "jax_mean": JAX_WARM_LOSS[0], "jax_se": JAX_WARM_LOSS[1],
                "all_finite": bool(np.isfinite(whist).all())}
    print("warm start nrx_rt: loss_data mean "
          f"{warm_rec['loss_data_mean']:.4f} vs the init's first "
          f"{TRAIN_WINDOW}-step mean {fall['first_mean']:.4f} (JAX, same "
          f"weights and sampling: {JAX_WARM_LOSS[0]:.4f})", flush=True)
    del warm, wstep, warm_model

    # (d) e2e_rt phase 0: the constellation learns
    efn, (eparams, egen) = train_entry(E2E_LABEL, device=dev,
                                       batch=TRAIN_BATCH, seed=TRAIN_SEED)
    before = Constellation.points(eparams["constellation"][0].detach(),
                                  center=True)
    reset()
    ehist = training.loss_history([efn(eparams, egen)
                                   for _ in range(E2E_STEPS)])
    e2e_launches = counts()
    reset()
    after = Constellation.points(eparams["constellation"][0].detach(),
                                 center=True)
    e2e_rec = {"steps": E2E_STEPS, "first_losses": ehist[:2].tolist(),
               "last_losses": ehist[-2:].tolist(),
               "all_finite": bool(np.isfinite(ehist).all()),
               "points_moved_max": float((after - before).abs().max()),
               "points_mean_abs": float(after.mean().abs()),
               "points_energy": float((after.abs() ** 2).mean()),
               "launches": e2e_launches}
    del efn, eparams

    # (e) the train CLI's smoke, the evaluate CLI on what it wrote
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        cli_train.main(["--config", TRAIN_LABEL, "--smoke", "--iters",
                        str(CLI_SMOKE_ITERS), "--weights-dir", tmp,
                        "--log-dir", tmp, "--seed", str(TRAIN_SEED),
                        "--device", dev.type])
        smoke_s = time.perf_counter() - t1
        wpath = os.path.join(tmp, f"{TRAIN_LABEL}_smoke_weights.npz")
        with open(os.path.join(tmp, f"{TRAIN_LABEL}_smoke.jsonl")) as f:
            smoke_log = [json.loads(line) for line in f]
        cli_evaluate.main(["--config", TRAIN_LABEL, "--weights", wpath,
                           "--snr", str(TRAIN_EVAL_EBNO_DB), "--max-iter",
                           "1", "--fast-ldpc", "--results-dir", tmp,
                           "--batch-size", str(MC_BATCH), "--device",
                           dev.type])
        with open(os.path.join(tmp, f"{TRAIN_LABEL}_results.pkl"),
                  "rb") as f:
            _, _, bler_cli = pickle.load(f)
            keys = sorted(bler_cli)
        cli_rec = {"smoke_seconds": smoke_s, "iters": CLI_SMOKE_ITERS,
                   "loss_mean_first": smoke_log[0]["loss_mean"],
                   "loss_mean_last": smoke_log[-1]["loss_mean"],
                   "weights_bytes": os.path.getsize(wpath),
                   "evaluate_keys": [list(k) for k in keys]}
    reset()

    # (f) the trained parameters through the eval receiver, K1 / K3 / K5
    p_ev = Parameters(TRAIN_LABEL, training=False)
    trained = pack_params(weights.unflatten({
        k: v.detach().clone() for k, v in weights.flatten(params).items()}),
        p_ev.nrx_dtype)
    outs = []
    for kernels in (True, False):
        m = E2EModel(p_ev, kernels=kernels, device=dev)
        g = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        reset()
        outs.append(m(trained, g, MC_BATCH, TRAIN_EVAL_EBNO_DB,
                      fast_ldpc=True))
        torch.cuda.synchronize()
        if kernels:
            launches["train_eval_b30"] = counts()
    reset()
    (b, b_hat, crc), ref = outs
    eval_rec = {"counters": block_counts(b, b_hat),
                "counters_plain": block_counts(ref[0], ref[1]),
                "equals_plain_route": all(torch.equal(x, y)
                                          for x, y in zip(outs[0], ref))}
    del outs, trained, params

    # (g) covariances of UMi at 132 PRB (the LMMSE baseline's input)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, covs = compute_cov.compute(TRAIN_LABEL, dev)
    cov_s = time.perf_counter() - t1
    cov_rec = {"seconds": cov_s, "shapes": [list(c.shape) for c in covs]}
    for name, c in zip(("freq", "time", "space"), covs):
        c = c.astype(np.complex128)
        eig = np.linalg.eigvalsh(c)
        cov_rec[name] = {
            "hermitian_err": float(np.abs(c - c.conj().T).max()
                                   / np.abs(c).max()),
            "min_eig": float(eig.min()), "max_eig": float(eig.max())}

    emit({"phase": "train_path", "config": TRAIN_LABEL, "card": card,
          "umi": umi_rec, "loss_fall": fall, "stage_ms": stage_ms,
          "steps_per_s_device": 1e3 / stage_ms["step_ms"],
          "profile": profile_rec, "warm_start": warm_rec, "e2e_rt": e2e_rec,
          "cli": cli_rec, "eval_check": eval_rec, "covariance": cov_rec,
          "launches": launches, "expected": expected,
          "seconds": time.perf_counter() - t0})
    assert umi_rec["finite"] and umi_rec["shape"] == [128, 4, 2, 2, 14, 48]
    assert 0.03 < umi_rec["mean_power"] < 3.0, umi_rec
    assert umi_rec["corr_adjacent_sc"] > 0.8, umi_rec
    assert umi_rec["corr_128_sc"] < 0.7, umi_rec
    assert umi_rec["corr_users"] < 0.1, umi_rec
    for route, want in expected.items():
        assert launches[route] == want, (route, launches[route])
    assert e2e_launches == zero, e2e_launches
    assert fall["all_finite"] and warm_rec["all_finite"], (fall, warm_rec)
    assert fall["last_mean"] < fall["first_mean"] - 2 * se, fall
    # the warm start beats the seed-made init, and its loss is the JAX
    # package's with the same weights (which is not half of the init's:
    # 0.49 against 0.61-0.66 on the UMi of the training configuration)
    assert warm_rec["loss_data_mean"] < fall["first_mean"] - 2 * np.hypot(
        w_se, warm_rec["init_first_se"]), warm_rec
    assert abs(warm_rec["loss_data_mean"] - JAX_WARM_LOSS[0]) < 3 * np.hypot(
        w_se, JAX_WARM_LOSS[1]), warm_rec
    assert e2e_rec["all_finite"] and e2e_rec["points_moved_max"] > 1e-4, \
        e2e_rec
    assert e2e_rec["points_mean_abs"] < 1e-5, e2e_rec
    assert abs(e2e_rec["points_energy"] - 1.0) < 1e-5, e2e_rec
    assert cli_rec["evaluate_keys"] == [["Neural Receiver", 2, 0]], cli_rec
    assert eval_rec["equals_plain_route"], eval_rec
    assert cov_rec["shapes"] == [[1584, 1584], [14, 14], [4, 4]], cov_rec
    for name in ("freq", "time", "space"):
        c = cov_rec[name]
        assert c["hermitian_err"] < 1e-6, (name, c)
        assert c["min_eig"] > -1e-6 * c["max_eig"], (name, c)
    return launches


def deploy_path(dev, card, peaks, counts, reset):
    """Phase 11: the deploy engine (`entry.deploy_entry`, `deploy/`) of
    nrx_rt with the committed EMA weights in bf16: per bucket at batch 1
    the graph replay against the eager call and both against the plain
    route (launches of an eager call counted), device ms and host p50/p99,
    eager and graph; padded requests against direct engines (f32 and bf16,
    nonzero biases); the mega route (K4) at batch 1 and 16; the Aerial test
    vectors through the engine into the evaluator (f32, bf16), the served
    call against the eval receiver; slots/s at batch 16; the export CLI and an
    engine file loaded back; K1 and K3 at the smallest and largest bucket's
    width. Emits the phase's record, asserts it, and returns (launches by
    path, the kernels' timing records)."""
    import dataclasses
    import torch
    from neural_rx_tpu_torch import weights
    from neural_rx_tpu_torch.cli import export as cli_export
    from neural_rx_tpu_torch.deploy import aot, data_tools
    from neural_rx_tpu_torch.deploy.aerial import AerialNRX
    from neural_rx_tpu_torch.entry import deploy_entry, load_params
    from neural_rx_tpu_torch.kernels import cgnn_iter, sepconv
    from neural_rx_tpu_torch.sim.config import Parameters
    from neural_rx_tpu_torch.sim.e2e import E2EModel

    t0 = time.perf_counter()
    bf, f32 = torch.bfloat16, torch.float32
    launches = {}
    route = {"sepconv_stack": 1, "cgnn_iter": 2, "cgnn_full": 0,
             "ldpc_decode": 0}
    mega_route = {"sepconv_stack": 0, "cgnn_iter": 0, "cgnn_full": 1,
                  "ldpc_decode": 0}
    expected = {}

    def twin(rx, **changes):
        """A receiver of rx's engines (the same tables) on another route."""
        engines = {n: AerialNRX(e.numpy_tables(),
                                dataclasses.replace(e.cfg, **changes),
                                num_it=e.num_it, dtype=e.dtype,
                                mcs_idx=e.mcs_idx, device=dev)
                   for n, e in rx.engines.items()}
        return aot.BucketedReceiver(engines.__getitem__, rx.params,
                                    rx.batch_size, rx.buckets)

    def counted(name, fn, want):
        """fn() with the counts set to 0 just before and read just after,
        its outputs cloned."""
        reset()
        out = [o.clone() for o in fn()]
        torch.cuda.synchronize()
        launches[name], expected[name] = counts(), want
        reset()
        return out

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # (a) every bucket at batch 1: graph = eager = plain route
    t1 = time.perf_counter()
    rx, examples = deploy_entry(device=dev)
    build_s = time.perf_counter() - t1
    plain = twin(rx, kernels=False)
    buckets = {}
    for n in rx.buckets:
        x = examples[n]
        eager = counted(f"deploy_b1_{n}prb", lambda: rx.eager(n, *x), route)
        reset()
        graph = [o.clone() for o in rx.run(n, *x)]
        torch.cuda.synchronize()
        replay_counts = counts()
        ref = plain.eager(n, *x)
        torch.cuda.synchronize()
        reset()
        rec = compare(eager, ref, f32, TOL_BF16)
        buckets[n] = {
            "sc": 12 * n, "llr_shape": list(eager[0].shape),
            "graph_equals_eager": same(graph, eager),
            "eager_equals_plain": same(eager, ref), "vs_plain": rec,
            "replay_counts": replay_counts,
            "capture_s": rx.capture_seconds.get((n, 12 * n)),
            "graph": aot.measure_latency(lambda *a: rx.run(n, *a), x,
                                         DEPLOY_ITERS),
            "eager": aot.measure_latency(lambda *a: rx.eager(n, *a), x,
                                         DEPLOY_ITERS)}
        reset()
    del plain

    # (b) padded requests against direct engines, nonzero biases
    flat = weights.flatten(weights.load_tree(weights.NRX_RT_EMA,
                                             device=dev)["cgnn"])
    gen_b = torch.Generator(device=dev).manual_seed(7)
    params_r = {"cgnn": weights.unflatten({
        k: 0.5 * torch.randn(v.shape, generator=gen_b, device=dev)
        if v.dim() == 1 else v for k, v in flat.items()})}
    padded = {}
    for dtype in (f32, bf):
        direct, _ = deploy_entry(device=dev, buckets=DEPLOY_PAD_CASES,
                                 dtype=dtype, params=params_r)
        pad_rx, _ = deploy_entry(device=dev, buckets=(DEPLOY_PRB,),
                                 dtype=dtype, params=params_r)
        for n in DEPLOY_PAD_CASES:
            x = direct.example_inputs(n, seed=3)
            want = [o.clone() for o in direct.run(n, *x)]
            key = f"{n}_in_{DEPLOY_PRB}_{str(dtype)[6:]}"
            eager = counted(f"deploy_pad_{key}", lambda: pad_rx.eager(n, *x),
                            route)
            graph = [o.clone() for o in pad_rx.run(n, *x)]
            torch.cuda.synchronize()
            padded[key] = {
                "shapes": [list(o.shape) for o in graph],
                "graph_equals_direct": same(graph, want),
                "eager_equals_direct": same(eager, want),
                "rel_err": max(rel_err(g, w) for g, w in zip(graph, want)),
                "mean_err": max(float((g - w).abs().mean() / w.abs().max())
                                for g, w in zip(graph, want))}
        del direct, pad_rx

    # (c) the mega route (K4) at 132 PRB, captured in a graph
    mega = {}
    for b in (1, DEPLOY_BATCH):
        m_rx, m_ex = deploy_entry(device=dev, buckets=(DEPLOY_PRB,),
                                  batch=b, mega=True)
        x = m_ex[DEPLOY_PRB]
        eager = counted(f"deploy_mega_b{b}",
                        lambda: m_rx.eager(DEPLOY_PRB, *x), mega_route)
        m_plain = twin(m_rx, kernels=False)
        ref = m_plain.eager(DEPLOY_PRB, *x)
        graph = [o.clone() for o in m_rx.run(DEPLOY_PRB, *x)]
        torch.cuda.synchronize()
        mega[b] = {"capture_s": m_rx.capture_seconds.get(
                       (DEPLOY_PRB, 12 * DEPLOY_PRB)),
                   "graph_equals_eager": same(graph, eager),
                   "eager_equals_plain": same(eager, ref),
                   "vs_plain": compare(eager, ref, f32, TOL_BF16),
                   "run": aot.measure_latency(
                       lambda *a: m_rx.run(DEPLOY_PRB, *a), x, DEPLOY_ITERS,
                       b),
                   "eager": aot.measure_latency(
                       lambda *a: m_rx.eager(DEPLOY_PRB, *a), x,
                       DEPLOY_ITERS, b)}
        reset()
        del m_rx, m_plain

    # (d) Aerial test vectors -> engine -> evaluator, 132 PRB, batch 16
    p = Parameters("nrx_rt", training=False,
                   overrides={"n_size_bwp": DEPLOY_PRB})
    model = E2EModel(p, device=dev)
    inputs, labels = data_tools.AerialDataGenerator(model)(
        torch.Generator(device=dev).manual_seed(DEPLOY_SEED), DEPLOY_BATCH,
        DEPLOY_EBNO_DB)
    evaluator = data_tools.AerialDataEvaluator(model)
    vectors = {}
    for dtype in (f32, bf):
        rx16, _ = deploy_entry(device=dev, buckets=(DEPLOY_PRB,),
                               batch=DEPLOY_BATCH, dtype=dtype)
        name = str(dtype)[6:]
        llr, h_hat = counted(f"deploy_vectors_{name}",
                             lambda: rx16.eager(DEPLOY_PRB, *inputs), route)
        vectors[name] = {**evaluator(llr, labels),
                         "graph": aot.measure_latency(
                             lambda *a: rx16.run(DEPLOY_PRB, *a), inputs,
                             DEPLOY_ITERS, DEPLOY_BATCH)}
        if dtype == f32:
            # the served call (num_valid_sc = 12 n_prb) against the eval
            # receiver's CGNN on the same slot and route (K1 + K3)
            y = torch.complex(inputs[0], inputs[1]).permute(0, 3, 2, 1)
            llr_r, h_r = model.receiver.serve(
                load_params(dtype=f32, device=dev),
                torch.stack([y.real, y.imag], dim=-1))
            vectors[name]["vs_eval_receiver"] = {
                "llr": rel_err(-llr.transpose(2, 3), llr_r),
                "h_hat": rel_err(h_hat.transpose(2, 3), h_r)}
        del rx16
    reset()

    # (e) the export CLI, an engine file loaded back without Parameters
    with tempfile.TemporaryDirectory() as out:
        t1 = time.perf_counter()
        cli_export.main(["--config", "nrx_rt", "--buckets", "4",
                         str(DEPLOY_PRB), "--out", out])
        cli_s = time.perf_counter() - t1
        with open(os.path.join(out, "nrx_rt_manifest.json")) as f:
            manifest = json.load(f)
        eng, params_l = aot.load_engine(os.path.join(
            out, manifest["buckets"][str(DEPLOY_PRB)]["engine_file"]),
            device=dev)
        x, sc = examples[DEPLOY_PRB], 12 * DEPLOY_PRB
        loaded_equal = same(eng(params_l, *x, num_valid_sc=sc),
                            rx.engines[DEPLOY_PRB](rx.params, *x,
                                                   num_valid_sc=sc))
    reset()

    # (f) K1 and K3 (bf16) at the smallest and largest bucket's width
    cgnn = rx.params["cgnn"]
    init_p, it0 = cgnn["s_init"][0], cgnn["iterations"][0]
    gen_k = torch.Generator(device=dev).manual_seed(1)
    widths_k = {}
    for n in (min(rx.buckets), max(rx.buckets)):
        w = 12 * n
        eng_n = rx.engines[n]
        x = torch.randn((N_TX, N_SYM, w, 18), generator=gen_k,
                        device=dev).to(bf)
        s = (4.0 * torch.randn((1, N_TX, N_SYM, w, 56), generator=gen_k,
                               device=dev)).to(bf)
        pe = eng_n.tables["pe"].to(bf)
        act = torch.ones((1, N_TX), device=dev)
        widths_k[w] = {
            "sepconv_stack": rates({
                "shape": list(x.shape),
                "kernel_ms": cuda_ms(lambda: sepconv.fused_conv_stack(
                    init_p, x), 20),
                "plain_ms": cuda_ms(lambda: sepconv.sepconv_stack_reference(
                    init_p, x), 5),
                **bound(*stack_work(widths_of(init_p), N_TX, N_SYM, w, 2),
                        peaks)}),
            "cgnn_iter": rates({
                "shape": list(s.shape),
                "kernel_ms": cuda_ms(lambda: cgnn_iter.fused_iteration(
                    it0, s, pe, act), 20),
                "plain_ms": cuda_ms(
                    lambda: cgnn_iter.fused_iteration_reference(
                        it0, s, pe, act), 5),
                **bound(*iteration_work(it0, 1, 2, 2, w=w), peaks)})}
    reset()

    emit({"phase": "deploy_path", "card": card, "buckets": buckets,
          "build_s": build_s, "padded": padded, "mega": mega,
          "vectors": vectors, "ebno_db": DEPLOY_EBNO_DB,
          "export": {"seconds": cli_s, "manifest": manifest,
                     "loaded_equals_live": loaded_equal},
          "kernels_at_width": widths_k,
          "yardstick_ms": DEPLOY_YARDSTICK_MS, "launches": launches,
          "expected": expected, "seconds": time.perf_counter() - t0})
    for name, want in expected.items():
        assert launches[name] == want, (name, launches[name])
    for n, rec in buckets.items():
        assert rec["graph_equals_eager"], (n, rec)
        assert rec["eager_equals_plain"], (n, rec)
        assert rec["replay_counts"] == dict.fromkeys(route, 0), (n, rec)
        assert rec["llr_shape"] == [1, N_TX, 12 * n, N_SYM, 4], (n, rec)
    for key, rec in padded.items():
        assert rec["graph_equals_direct"], (key, rec)
        assert rec["eager_equals_direct"], (key, rec)
    for b, rec in mega.items():
        assert rec["capture_s"] is not None, (b, rec)
        assert rec["graph_equals_eager"], (b, rec)
        assert rec["eager_equals_plain"], (b, rec)
    for name, rec in vectors.items():
        # JAX_CURVE: nrx_rt's BLER is below 1e-4 from 7 dB on
        assert 0.0 <= rec["coded_ber"] < 0.2, (name, rec)
        assert rec["crc_pass_rate"] >= 0.9, (name, rec)
    assert max(vectors["float32"]["vs_eval_receiver"].values()) <= 1e-5, \
        vectors["float32"]
    assert loaded_equal and set(manifest["buckets"]) == {"4",
                                                         str(DEPLOY_PRB)}
    return launches, widths_k


def site_path(dev, card, counts, reset):
    """Phase 12: the site-specific Dataset channel on the card: the port's
    synthetic datasets written into a temporary directory (md5 of the
    repository's data/ files); one Monte-Carlo step of SITE_LABEL at 132
    PRB, batch 30, float32 with K5 (launches counted), kernel route = plain
    route from the same seed; `sim_ber` at SITE_SWEEP_DB inside the
    committed curve's band; the evaluate CLI; one step of the LS/lin and
    the LMMSE baselines of SITE_BASELINE with covariances computed on the
    Dataset channel; SITE_TRAIN_STEPS training steps of SITE_TRAIN_LABEL at
    its training width; a step's device ms by stage. Emits the phase's
    record, asserts it, and returns the launches by path."""
    import hashlib
    import torch
    from neural_rx_tpu_torch.channel.apply import apply_ofdm_channel
    from neural_rx_tpu_torch.cli import evaluate as cli_evaluate
    from neural_rx_tpu_torch.entry import (baseline_entry, mc_entry,
                                           train_entry)
    from neural_rx_tpu_torch.kernels import ldpc as k5
    from neural_rx_tpu_torch.sim import trajectory
    from neural_rx_tpu_torch.sim.baseline_e2e import BaselineE2EModel
    from neural_rx_tpu_torch.sim.config import Parameters
    from neural_rx_tpu_torch.sim.e2e import E2EModel
    from neural_rx_tpu_torch.sim.simber import sim_ber

    t0 = time.perf_counter()
    launches = {}
    k_all = {"sepconv_stack": 1, "cgnn_iter": 2, "cgnn_full": 0,
             "ldpc_decode": 2}
    k5_only = {"sepconv_stack": 0, "cgnn_iter": 0, "cgnn_full": 0,
               "ldpc_decode": 2}
    none = dict.fromkeys(k_all, 0)
    expected = {"site_b30": k_all, "site_baseline_lslin_lmmse": k5_only,
                "site_baseline_lmmse_lmmse": k5_only,
                "site_train_steps": none}
    curve = json_curve(SITE_CURVE, key=("curve",))
    with tempfile.TemporaryDirectory() as data_dir:
        t1 = time.perf_counter()
        paths = trajectory.write_committed_site_datasets(data_dir)
        md5 = {}
        for path in paths:
            with open(path, "rb") as f:
                md5[os.path.basename(path)] = hashlib.md5(
                    f.read()).hexdigest()
        datasets_s = time.perf_counter() - t1

        # (a) one step through the entry point, launches counted
        fn, (params, gen) = mc_entry(device=dev, batch=SITE_BATCH,
                                     ebno_db=SITE_STEP_DB, seed=SITE_SEED,
                                     config=SITE_LABEL, data_dir=data_dir)
        reset()
        step_counts = fn(params, gen)
        torch.cuda.synchronize()
        launches["site_b30"] = counts()
        reset()

        # (b) kernel route = plain route from the same seed, 2 steps
        p = Parameters(SITE_LABEL, training=False, data_dir=data_dir)
        models = [E2EModel(p, kernels=k, device=dev) for k in (True, False)]
        outs = []
        for m in models:
            g = torch.Generator(device=dev).manual_seed(SITE_SEED)
            outs.append([m(params, g, SITE_BATCH, SITE_STEP_DB,
                           fast_ldpc=True) for _ in range(2)])
        torch.cuda.synchronize()
        reset()
        plain_rec = {
            "counters": [block_counts(b, bh) for b, bh, _ in outs[0]],
            "counters_plain": [block_counts(b, bh) for b, bh, _ in outs[1]],
            "equals_plain_route": all(
                torch.equal(x, y) for o, r in zip(*outs)
                for x, y in zip(o, r))}
        del outs

        # (c) sim_ber inside the committed curve's band
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bers, blers, n_err, n_blk = sim_ber(
            models[0], params, SITE_SWEEP_DB, SITE_BATCH,
            max_mc_iter=MC_MAX_ITER,
            num_target_block_errors=MC_TARGET_BLOCK_ERRORS, seed=SITE_SEED,
            verbose=False, fast_ldpc=True, return_counts=True)
        sweep_s = time.perf_counter() - t1
        points = [curve_point(*pt, curve) for pt in zip(
            SITE_SWEEP_DB, bers, blers, n_err, n_blk)]
        steps = int(n_blk.sum()) // (SITE_BATCH * N_TX)
        reset()

        # (d) a step's device ms by stage
        model = models[0]
        rx_s = model.receiver
        gen_t = torch.Generator(device=dev).manual_seed(SITE_SEED + 1)

        def front():
            (b_,), h_, n_ = model.draw(gen_t, SITE_BATCH, SITE_STEP_DB)
            return apply_ofdm_channel(model.transmitter(b_), h_, None,
                                      noise=n_)
        y_t = front()
        y_tp = torch.stack([y_t.real, y_t.imag], dim=-1)
        llr_t, _ = rx_s.serve(params, y_tp)

        def decode_both():
            flat = rx_s.rg.demap_data(llr_t).reshape(SITE_BATCH, N_TX, -1)
            return [k5.tb_decode_fast(cfg.tb, flat[:, ue])
                    for ue, cfg in enumerate(rx_s.rg.configs)]
        stage_ms = {"front_ms": cuda_ms(front, 5),
                    "channel_cfr_ms": cuda_ms(lambda: p.channel_model(
                        gen_t, SITE_BATCH, N_TX, N_SYM, N_SC, 30e3), 5),
                    "receiver_ms": cuda_ms(lambda: rx_s.serve(params, y_tp),
                                           5),
                    "decode_ms": cuda_ms(decode_both, 3, warmup=1)}
        stage_ms["step_ms"] = (stage_ms["front_ms"] + stage_ms["receiver_ms"]
                               + stage_ms["decode_ms"])
        del models, y_t, y_tp, llr_t
        reset()

        # (e) the evaluate CLI on the site configuration
        with tempfile.TemporaryDirectory() as res_dir:
            t1 = time.perf_counter()
            cli_evaluate.main(["--config", SITE_LABEL, "--snr", "5",
                               "--max-iter", "2", "--fast-ldpc",
                               "--data-dir", data_dir,
                               "--results-dir", res_dir])
            with open(os.path.join(res_dir, f"{SITE_LABEL}_results.pkl"),
                      "rb") as f:
                cli_keys = sorted(pickle.load(f)[2])
            cli_s = time.perf_counter() - t1
        reset()

        # (f) the baselines, covariances on the Dataset channel
        base = {}
        with tempfile.TemporaryDirectory() as cov_dir:
            for system in ("baseline_lslin_lmmse", "baseline_lmmse_lmmse"):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn_b, (prm_b, gen_b) = baseline_entry(
                    system, config=SITE_BASELINE, device=dev,
                    batch=SITE_BATCH, ebno_db=SITE_STEP_DB, seed=SITE_SEED,
                    cov_dir=cov_dir, data_dir=data_dir)
                setup_s = time.perf_counter() - t1
                reset()
                c = fn_b(prm_b, gen_b)
                torch.cuda.synchronize()
                launches[f"site_{system}"] = counts()
                reset()
                p_b = Parameters(SITE_BASELINE, system=system,
                                 training=False, data_dir=data_dir)
                outs = []
                for k in (True, False):
                    m = BaselineE2EModel(p_b, system, cov_dir=cov_dir,
                                         kernels=k, device=dev)
                    g = torch.Generator(device=dev).manual_seed(SITE_SEED)
                    outs.append(m({}, g, SITE_BATCH, SITE_STEP_DB,
                                  fast_ldpc=True))
                torch.cuda.synchronize()
                reset()
                base[system] = {
                    "setup_s": setup_s, "counters": [int(v) for v in c],
                    "equals_plain_route": all(
                        torch.equal(x, y) for x, y in zip(*outs))}
            cov_files = sorted(f for f in os.listdir(cov_dir)
                               if f.endswith(".npy"))
            covs = [np.load(os.path.join(cov_dir, f)) for f in cov_files]
        cov_rec = {"files": cov_files, "hermitian_err": max(
            float(np.abs(c - c.conj().T).max() / np.abs(c).max())
            for c in covs)}

        # (g) training steps of the site configuration at its width
        step, (tparams, tgen) = train_entry(SITE_TRAIN_LABEL, device=dev,
                                            seed=SITE_SEED,
                                            data_dir=data_dir)
        reset()
        losses = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(SITE_TRAIN_STEPS):
            losses.append([float(v) for v in step(tparams, tgen)])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        launches["site_train_steps"] = counts()
        reset()

    emit({"phase": "site_path", "card": card, "config": SITE_LABEL,
          "datasets": {"md5": md5, "seconds": datasets_s},
          "step_counters": [int(v) for v in step_counts],
          "kernel_vs_plain": plain_rec,
          "sweep": {"points": points, "steps": steps, "wall_s": sweep_s,
                    "slots_per_s_wall": steps * SITE_BATCH / sweep_s},
          "stage_ms": stage_ms,
          "slots_per_s_device": SITE_BATCH / stage_ms["step_ms"] * 1e3,
          "cli": {"seconds": cli_s, "keys": cli_keys},
          "baselines": base, "covariance": cov_rec,
          "train": {"config": SITE_TRAIN_LABEL, "steps": SITE_TRAIN_STEPS,
                    "seconds": train_s, "first": losses[0],
                    "last": losses[-1],
                    "all_finite": bool(np.isfinite(losses).all())},
          "launches": launches, "expected": expected,
          "seconds": time.perf_counter() - t0})
    assert md5 == SITE_MD5, md5
    for name, want in expected.items():
        assert launches[name] == want, (name, launches[name])
    assert step_counts[3] == SITE_BATCH * N_TX, step_counts
    assert plain_rec["equals_plain_route"], plain_rec
    assert all(a > b for a, b in zip(blers, blers[1:])), blers
    for pt in points:
        lo, hi = pt["band"]
        assert lo <= pt["bler"] <= hi, pt
    assert cli_keys == [("Neural Receiver", 2, 0)], cli_keys
    for system, rec in base.items():
        assert rec["equals_plain_route"], (system, rec)
        assert rec["counters"][3] == SITE_BATCH * N_TX, (system, rec)
    assert len(cov_rec["files"]) == 3 and cov_rec["hermitian_err"] < 1e-6, \
        cov_rec
    assert np.isfinite(losses).all(), losses
    return launches


DIST_BATCH = 30  # the global batch of the sharded sim_ber (nrx_rt eval)
DIST_EBNO_DB = 3.0
DIST_STEPS = 2  # sim_ber steps a run
DIST_SEED = 0
DIST_CGNN_BATCH = 2  # the grid-sharded CGNN's batch (1 a data row at 2)
DIST_CGNN_MESHES = ((1, 4), (2, 2))
CHAIN_LENGTH = 20  # calls a chain of chained_device_time_ms


def dist_inputs(config="nrx_rt", config_dir=None, batch=DIST_BATCH,
                train_batch=None):
    """The sharded jobs' inputs at nrx_rt's widths (132 PRB, committed
    weights; CPU tensors from numpy's default_rng(DIST_SEED)):
    "kernel_jobs", the stack kernel (init stack, N = 2) and the iteration
    kernel (b = 1, state and readout mode) in bf16 and float32; "cgnn", the
    eval receiver's CGNN (float32, its iteration-kernel route) with its
    inputs at batch DIST_CGNN_BATCH; "eval_args", `sim_ber` of config at
    DIST_EBNO_DB, global batch `batch`, DIST_STEPS steps with the layered
    decoder; "train_args", one training step of config from a seed-made
    init at global batch train_batch (default: its phase 0's)."""
    import dataclasses
    import torch
    from neural_rx_tpu_torch import weights
    from neural_rx_tpu_torch.dist import checks
    from neural_rx_tpu_torch.entry import load_params, make_receiver
    from neural_rx_tpu_torch.sim.config import Parameters
    from neural_rx_tpu_torch.sim.e2e import E2EModel

    rng = np.random.default_rng(DIST_SEED)

    def normal(*shape, scale=1.0):
        return torch.as_tensor(scale * rng.normal(size=shape),
                               dtype=torch.float32)
    cgnn_p = load_params(dtype=torch.float32, device="cpu")["cgnn"]
    rx32 = make_receiver(nrx_dtype=torch.float32, device="cpu")
    x = normal(2, N_SYM, N_SC, 18)
    s = normal(1, N_TX, N_SYM, N_SC, 56, scale=4.0)
    act = torch.ones((1, N_TX))
    readouts = [cgnn_p["readout_llrs"][0], cgnn_p["readout_chest"]]
    kernel_jobs = []
    for dt in ("bfloat16", "float32"):
        kernel_jobs += [
            ("stack", {"p": cgnn_p["s_init"][0], "x": x, "dtype": dt}),
            ("iteration", {"it_p": cgnn_p["iterations"][0], "s": s,
                           "pe": rx32.pe, "active": act, "dtype": dt}),
            ("iteration", {"it_p": cgnn_p["iterations"][1], "s": s,
                           "pe": rx32.pe, "active": act,
                           "readouts": readouts, "dtype": dt})]
    b = DIST_CGNN_BATCH
    cgnn = {"params": cgnn_p, "pe": rx32.pe, "y": normal(b, N_SYM, N_SC, 8),
            "h": normal(b, N_TX, N_SYM, N_SC, 8),
            "cfg": dataclasses.replace(rx32.cgnn_cfg, fused_iteration=True)}
    p_train = Parameters(config, training=True, config_dir=config_dir)
    train_batch = train_batch or int(
        p_train.training_schedule["batch_size"][0])
    eval_args = {"config": config, "config_dir": config_dir,
                 "weights": weights.NRX_RT_EMA,
                 "kwargs": {"ebno_dbs": [DIST_EBNO_DB], "batch_size": batch,
                            "max_mc_iter": DIST_STEPS,
                            "num_target_block_errors": 10**9,
                            "seed": DIST_SEED, "fast_ldpc": True}}
    train_args = {"config": config, "config_dir": config_dir, "lr": 1e-3,
                  "seed": DIST_SEED, "batch": train_batch,
                  "leaves": checks.flat_leaves(
                      E2EModel(p_train, training=True, device="cpu")
                      .init_params(torch.Generator().manual_seed(
                          DIST_SEED)))}
    return {"kernel_jobs": kernel_jobs, "cgnn": cgnn,
            "eval_args": eval_args, "train_args": train_args}


def cgnn_jobs(inputs, meshes) -> list:
    """A "cgnn" job of `dist_inputs`' CGNN on each (data, grid) mesh."""
    import torch
    c = inputs["cgnn"]
    b = c["y"].shape[0]
    return [("cgnn", {**c, "active": torch.ones((b, N_TX)),
                      "mm": torch.ones((b, N_TX, 1)), "data": d, "grid": g,
                      "dtype": "float32"}) for d, g in meshes]


def check_kernel_jobs(dev, kernel_jobs, groups_w, world) -> list:
    """`compare` records of each kernel job's shards (groups_w: per job the
    ranks' records) joined, against the unsharded launch on dev."""
    import torch
    from neural_rx_tpu_torch.dist import checks
    from neural_rx_tpu_torch.kernels import cgnn_iter, sepconv
    recs = []
    for (kind, args), ranks in zip(kernel_jobs, groups_w):
        dtype = getattr(torch, args["dtype"])
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        if kind == "stack":
            ref = (sepconv.fused_conv_stack(checks.to_device(args["p"], dev),
                                            args["x"].to(dev, dtype)),)
            got = (torch.cat([r["out"] for r in ranks], 2),)
        else:
            ref = cgnn_iter.fused_iteration(
                checks.to_device(args["it_p"], dev),
                args["s"].to(dev, dtype), args["pe"].to(dev, dtype),
                args["active"].to(dev), None,
                *checks.to_device(args.get("readouts") or [], dev))
            ref = ref if isinstance(ref, tuple) else (ref,)
            got = tuple(torch.cat([r["out"][j] for r in ranks], 3)
                        for j in range(len(ref)))
        rec = compare(tuple(g.to(dev) for g in got), ref, dtype, tol)
        recs.append({"ranks": world, "kernel": kind, "shard": N_SC // world,
                     "mode": "readout" if "readouts" in args else "state",
                     **rec})
    return recs


def check_cgnn_jobs(dev, inputs, groups_c, meshes) -> list:
    """Each "cgnn" job's blocks joined (groups_c: per mesh the ranks'
    records) against `cgnn_apply` on dev alone: the largest difference
    relative to max |ref|."""
    import torch
    from neural_rx_tpu_torch.dist import checks
    from neural_rx_tpu_torch.rx.cgnn import cgnn_apply
    c = inputs["cgnn"]
    b = c["y"].shape[0]
    llr, _ = cgnn_apply(checks.to_device(c["params"], dev), c["cfg"],
                        c["y"].to(dev), c["pe"].to(dev), c["h"].to(dev),
                        torch.ones((b, N_TX), device=dev),
                        torch.ones((b, N_TX, 1), device=dev))
    return [{"data": d, "grid": g, "rel_err": rel_err(
        checks.assemble(ranks, "llr").to(dev), llr[-1][0])}
        for (d, g), ranks in zip(meshes, groups_c)]


def dist_path(dev, card, peaks, counts, reset):
    """Phase 13: several ranks (`neural_rx_tpu_torch/dist/`) and the
    tooling on the card. (a) A one-rank NCCL group in this process, mesh
    1 x 1: `sim_ber` of nrx_rt at 132 PRB, DIST_EBNO_DB, global batch
    DIST_BATCH, DIST_STEPS steps with K5, counters equal to the same call
    without a mesh; one training step (nrx_rt at 4 PRB, batch 128, UMi)
    through the gradient all-reduce, parameters equal to the step without
    it bit for bit. (b) Gloo groups of 2 and 4 ranks sharing the card
    (`dist.launch.run_ranks`, `dist.checks.run_jobs`; the kernel library
    built here, the ranks only load it), started together: the stack kernel
    (nrx_rt's init stack) and the iteration kernel (state and readout mode)
    on 792 / 396-subcarrier shards with halos of 3, bf16 and float32,
    against the unsharded launch here (bit for bit expected; held to
    TOL_*); on 4 ranks the eval receiver's CGNN on meshes data 1 x grid 4
    and data 2 x grid 2 (K1, then K3 on every iteration) within 1e-5 of max
    |ref| of one rank's, and `sim_ber` on a data 2 x grid 2 mesh; on 2
    ranks `sim_ber` on a data 2 mesh (mode a); both with counters equal to
    (a)'s; on 2 ranks a training step on a data 2 mesh (batch
    128 in all), parameters equal on both ranks; each rank's K1 / K3 / K5
    launches per job asserted. (c) Tooling: `chained_device_time_ms` of
    `entry()` at batch 1 beside its CUDA-event time; nrx_rt's weights
    exported to the reference format and imported back equal, and a served
    call from the imported tree equal to the original's. (d) K1 and K3 (bf16,
    batch 1) timed at the extended shard widths of 2 and 4 ranks beside
    their bounds. Emits the phase's record, asserts it, and returns (the
    launches by path, the kernels' timing records by shard count)."""
    import concurrent.futures
    import torch
    import torch.distributed as dist
    from neural_rx_tpu_torch import weights
    from neural_rx_tpu_torch.compat import reference_weights as refw
    from neural_rx_tpu_torch.dist import checks
    from neural_rx_tpu_torch.dist.launch import run_ranks
    from neural_rx_tpu_torch.dist.mesh import make_mesh
    from neural_rx_tpu_torch.entry import entry, make_receiver, pack_params
    from neural_rx_tpu_torch.kernels import cgnn_iter, sepconv
    from neural_rx_tpu_torch.sim.simber import sim_ber
    from neural_rx_tpu_torch.utils.profiling import chained_device_time_ms

    t0 = time.perf_counter()
    launches = {}
    none = {"sepconv_stack": 0, "cgnn_iter": 0, "cgnn_full": 0,
            "ldpc_decode": 0}

    def want(k1=0, k3=0, k5=0):
        return dict(none, sepconv_stack=k1, cgnn_iter=k3, ldpc_decode=k5)

    # (b) the gloo groups, started first: they run while (a) does
    d = dist_inputs()
    eval_args, train_args = d["eval_args"], d["train_args"]
    kernel_jobs, cgnn_js = d["kernel_jobs"], cgnn_jobs(d, DIST_CGNN_MESHES)
    jobs = {2: kernel_jobs + [("sim_ber", dict(eval_args, mode="a", data=2,
                                               grid=1)),
                              ("train", train_args)],
            4: kernel_jobs + cgnn_js + [
                ("sim_ber", dict(eval_args, mode="a", data=2, grid=2))]}
    # per rank and job: 1 K1 a stack; 1 K3 an iteration; the CGNN's init
    # stack and its 2 iterations; per sim_ber step K1, 2 K3 (batch 15 > 4:
    # the iteration kernel's route) and 2 K5 (one a user: every rank of a
    # data row decodes the row's blocks)
    kernel_want = [want(k1=1), want(k3=1), want(k3=1)] * 2
    sim_want = want(DIST_STEPS, 2 * DIST_STEPS, 2 * DIST_STEPS)
    job_want = {2: kernel_want + [sim_want, none],
                4: kernel_want + [want(1, 2)] * len(cgnn_js) + [sim_want]}
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futures = {w: pool.submit(
        run_ranks, "neural_rx_tpu_torch.dist.checks:run_jobs", w, "gloo",
        {"device": "cuda", "jobs": jobs[w]}, 600)
        for w in (2, 4)}

    # (a) a one-rank NCCL group, mesh 1 x 1
    with tempfile.TemporaryDirectory() as rdv:
        dist.init_process_group("nccl", init_method=f"file://{rdv}/nccl",
                                world_size=1, rank=0)
        try:
            mesh1 = make_mesh(1, 1, 1, backend="nccl")
            model, params = checks.eval_model(eval_args, dev)
            ref_counts = sim_ber(model, params, verbose=False,
                                 return_counts=True, **eval_args["kwargs"])
            reset()
            mesh_counts = sim_ber(model, params, verbose=False, mesh=mesh1,
                                  return_counts=True, **eval_args["kwargs"])
            torch.cuda.synchronize()
            launches["dist_nccl_sim_ber"] = counts()
            reset()
            step_plain = checks.train_once(train_args, dev)
            step_mesh = checks.train_once(train_args, dev, mesh1)
            launches["dist_nccl_train"] = counts()
            reset()
        finally:
            dist.destroy_process_group()
    nccl = {
        "counters": [int(v[0]) for v in ref_counts[2:]],
        "ber": float(ref_counts[0][0]),
        "counters_equal": all(np.array_equal(a, c) for a, c in
                              zip(ref_counts, mesh_counts)),
        "train_equal": all(torch.equal(v, step_mesh[0][k])
                           for k, v in step_plain[0].items())
        and torch.equal(step_plain[1], step_mesh[1]),
        "train_moved": any(not torch.equal(v, train_args["leaves"][k])
                           for k, v in step_plain[0].items())}

    # the groups are done before anything here is timed
    groups = {w: [list(r) for r in zip(*futures[w].result())]
              for w in (2, 4)}
    pool.shutdown()

    # (c) tooling
    fn, (params_e, y_e) = entry(device="cuda")
    chained = chained_device_time_ms(lambda yy: fn(params_e, yy), y_e,
                                     length=CHAIN_LENGTH, reps=3)
    event_ms = cuda_ms(lambda: fn(params_e, y_e), 20)
    with tempfile.TemporaryDirectory() as wdir:
        path = os.path.join(wdir, "nrx_rt_weights")
        refw.save_reference_weights(path, params_e)
        template = make_receiver(device=dev).init_params(
            torch.Generator(device=dev).manual_seed(1))
        imported = pack_params(weights.load_tree(path, device=dev,
                                                 template=template))
    flat_o = weights.flatten(params_e["cgnn"])
    flat_i = weights.flatten(imported["cgnn"])
    rx = make_receiver(device=dev)
    out_o = rx.serve(params_e, y_e)
    out_i = rx.serve(imported, y_e)
    torch.cuda.synchronize()
    tools = {"chained_ms_b1": chained, "event_ms_b1": event_ms,
             "chain_length": CHAIN_LENGTH,
             "weights_equal": flat_o.keys() == flat_i.keys() and all(
                 torch.equal(flat_o[k], flat_i[k]) for k in flat_o),
             "served_equal": all(torch.equal(a, c)
                                 for a, c in zip(out_o, out_i))}
    reset()

    # (d) K1 and K3 at the extended shard widths, bf16, batch 1
    bf = torch.bfloat16
    init_p = checks.to_device(d["cgnn"]["params"]["s_init"][0], dev)
    it0 = checks.to_device(d["cgnn"]["params"]["iterations"][0], dev)
    gen_k = torch.Generator(device=dev).manual_seed(DIST_SEED)
    shard_k = {}
    for w_ranks in (2, 4):
        w = N_SC // w_ranks + 2 * 3  # the shard and its halos
        x_k = torch.randn((N_TX, N_SYM, w, 18), generator=gen_k,
                          device=dev).to(bf)
        s_k = (4.0 * torch.randn((1, N_TX, N_SYM, w, 56), generator=gen_k,
                                 device=dev)).to(bf)
        pe_k = torch.randn((N_TX, N_SYM, w, 2), generator=gen_k,
                           device=dev).to(bf)
        act_k = torch.ones((1, N_TX), device=dev)
        shard_k[w_ranks] = {
            "sepconv_stack": rates({
                "shape": list(x_k.shape),
                "kernel_ms": cuda_ms(lambda: sepconv.fused_conv_stack(
                    init_p, x_k), 20),
                "plain_ms": cuda_ms(lambda: sepconv.sepconv_stack_reference(
                    init_p, x_k), 5),
                **bound(*stack_work(widths_of(init_p), N_TX, N_SYM, w, 2),
                        peaks)}),
            "cgnn_iter": rates({
                "shape": list(s_k.shape),
                "kernel_ms": cuda_ms(lambda: cgnn_iter.fused_iteration(
                    it0, s_k, pe_k, act_k), 20),
                "plain_ms": cuda_ms(
                    lambda: cgnn_iter.fused_iteration_reference(
                        it0, s_k, pe_k, act_k), 5),
                **bound(*iteration_work(it0, 1, 2, 2, w=w), peaks)})}
    reset()

    # (b) the groups' results against the unsharded launches here
    kernel_recs = []
    for w in (2, 4):
        kernel_recs += check_kernel_jobs(dev, kernel_jobs, groups[w], w)
    cgnn_recs = check_cgnn_jobs(dev, d, groups[4][len(kernel_jobs):],
                                DIST_CGNN_MESHES)
    reset()
    n_k = len(kernel_jobs)
    sim2 = groups[2][n_k]
    train2 = groups[2][n_k + 1]
    sim4 = groups[4][n_k + len(cgnn_js)]

    def same_counters(recs):
        return all(np.array_equal(r["block_errors"], ref_counts[2])
                   and np.array_equal(r["blocks"], ref_counts[3])
                   and np.array_equal(r["ber"], ref_counts[0]) for r in recs)
    gloo = {
        "sim_ber_counters": [[int(r["block_errors"][0]), int(r["blocks"][0]),
                              float(r["ber"][0])] for r in sim2],
        "sim_ber_equal": same_counters(sim2),
        "sim_ber_2x2_counters": [[int(r["block_errors"][0]),
                                  int(r["blocks"][0]), float(r["ber"][0])]
                                 for r in sim4],
        "sim_ber_2x2_equal": same_counters(sim4),
        "train_ranks_equal": all(torch.equal(v, train2[0]["leaves"][k])
                                 for r in train2
                                 for k, v in r["leaves"].items()),
        "train_vs_single_max_abs": max(
            checks.max_abs_diff(v, step_plain[0][k])
            for k, v in train2[0]["leaves"].items()),
        "job_seconds": {w: [max(r["seconds"] for r in recs)
                            for recs in groups[w]] for w in (2, 4)}}
    for w in (2, 4):
        total = dict(none)
        for i, recs in enumerate(groups[w]):
            for r in recs:
                assert r["launches"] == job_want[w][i], (w, i, r["launches"])
                for k in total:
                    total[k] += r["launches"][k]
        launches[f"dist_gloo{w}"] = total
    expected = {"dist_nccl_sim_ber": want(DIST_STEPS, 2 * DIST_STEPS,
                                          2 * DIST_STEPS),
                "dist_nccl_train": none}
    emit({"phase": "dist_path", "card": card, "nccl_1x1": nccl,
          "kernels_sharded": kernel_recs, "cgnn_sharded": cgnn_recs,
          "gloo": gloo, "tools": tools, "kernels_at_shard": shard_k,
          "launches": launches, "seconds": time.perf_counter() - t0})
    for name, w in expected.items():
        assert launches[name] == w, (name, launches[name])
    assert nccl["counters_equal"] and nccl["train_equal"], nccl
    assert nccl["train_moved"], nccl
    for rec in kernel_recs:
        assert rec["ok"], rec
    for rec in cgnn_recs:
        assert rec["rel_err"] <= 1e-5, rec
    assert gloo["sim_ber_equal"] and gloo["sim_ber_2x2_equal"], gloo
    assert gloo["train_ranks_equal"], gloo
    assert tools["weights_equal"] and tools["served_equal"], tools
    assert tools["chained_ms_b1"] > 0, tools
    return launches, shard_k


MODES_SEED = 3
MODE_ENV = ("NRX_CONV_MXU", "NRX_STENCIL_LP")


def fold_flops(widths) -> int:
    """FLOPs of the folded-tap stack per position: the product over the
    nine taps, 2 x 9 x c_in x c_out per layer."""
    return sum(2 * 9 * ci * co for ci, co in zip(widths[:-1], widths[1:]))


def ptxas_entries(lines) -> dict:
    """{mangled kernel name: its register and spill lines} from ptxas' -v
    report."""
    out, name = {}, None
    for ln in lines:
        if "Compiling entry" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            out[name] = []
        elif name is not None and ("registers" in ln or "spill" in ln):
            out[name].append(ln)
    return out


def modes_path(dev, card, peaks, counts, reset, ptxas):
    """The layer modes of the JAX package at 132 PRB, nrx_rt, committed EMA
    weights: the folded-tap form of K1 (conv_mxu) and the bf16 depthwise sum
    of K1, K3 and K4 (stencil_lp). Each kernel against its plain version in
    the mode; the receiver's routes with the modes against their plain
    routes, launches counted by mode; each mode's device time beside the
    normal mode's in turns (normal, mode, mode, normal), with its bound;
    the new instances' registers and spills. Returns (launches by route,
    times, launches by mode)."""
    import dataclasses
    import warnings

    import torch
    from neural_rx_tpu_torch.entry import load_params, make_receiver
    from neural_rx_tpu_torch.kernels import cgnn_iter, sepconv

    t0 = time.perf_counter()
    saved_env = {k: os.environ.pop(k, None) for k in MODE_ENV}
    bf, f32 = torch.bfloat16, torch.float32
    params = load_params(device=dev)
    cgnn = params["cgnn"]
    stacks = {"init": cgnn["s_init"][0],
              "update0": cgnn["iterations"][0]["update"],
              "update1": cgnn["iterations"][1]["update"]}
    gen = torch.Generator(device=dev).manual_seed(MODES_SEED)
    h, w = N_SYM, N_SC
    rx = make_receiver(device=dev)
    pe = rx.pe.to(bf)
    d_s = cgnn["iterations"][0]["agg"]["hidden"][0]["w"].shape[0]
    by_mode = {"sepconv_stack": sepconv.launches_by_mode,
               "cgnn_iter": cgnn_iter.iter_launches_by_mode,
               "cgnn_full": cgnn_iter.full_launches_by_mode}

    def reset_modes():
        reset()
        for d in by_mode.values():
            for k in d:
                d[k] = 0

    def modes_now():
        return {k: dict(v) for k, v in by_mode.items()}

    # 1. each kernel in each mode against its plain version
    checks = []

    def check(kernel, got, ref, normal, dtype, tol, **what):
        """got: the kernel in the mode; ref: its plain version in the mode;
        normal: the kernel in the normal mode on the same inputs. The kernel
        must equal its plain version bit for bit, and differ from the normal
        mode (a dropped mode flag would run the normal instance)."""
        got, ref, normal = (t if isinstance(t, tuple) else (t,)
                            for t in (got, ref, normal))
        torch.cuda.synchronize()
        rec = compare(got, ref, dtype, tol)
        rec["share_vs_normal"] = differences(got, normal)[0]
        rec["ok"] = rec["ok"] and rec["differing_share"] == 0 \
            and rec["share_vs_normal"] > 0
        scv = what.get("sc_valid")
        if scv is not None and kernel == "sepconv_stack":
            lo, hi = scv
            rec["ok"] = rec["ok"] and not got[0][:, :, :lo].any() \
                and not got[0][:, :, hi:].any()
        checks.append({"kernel": kernel, **what, **rec})
        assert rec["ok"], checks[-1]

    for sname in ("init", "update0"):
        p = stacks[sname]
        x32 = torch.randn((2, h, w, widths_of(p)[0]), generator=gen,
                          device=dev)
        for dtype, tol in ((bf, TOL_BF16), (f32, TOL_F32)):
            x = x32.to(dtype)
            for scv in SC_VALID_CASES:
                check("sepconv_stack",
                      sepconv.fused_conv_stack(p, x, scv, mxu=True),
                      sepconv.sepconv_stack_reference(p, x, scv, mxu=True),
                      sepconv.fused_conv_stack(p, x, scv, mxu=False,
                                               lp_stencil=False),
                      dtype, tol, mode="mxu", stack=sname, sc_valid=scv)
        x = x32.to(bf)
        for scv in SC_VALID_CASES:
            check("sepconv_stack",
                  sepconv.fused_conv_stack(p, x, scv, lp_stencil=True),
                  sepconv.sepconv_stack_reference(p, x, scv,
                                                  lp_stencil=True),
                  sepconv.fused_conv_stack(p, x, scv, mxu=False,
                                           lp_stencil=False),
                  bf, TOL_BF16, mode="lp", stack=sname, sc_valid=scv)
    s16 = (4.0 * torch.randn((16, N_TX, h, w, d_s), generator=gen,
                             device=dev)).to(bf)
    act16 = torch.ones((16, N_TX), device=dev)
    readouts = (cgnn["readout_llrs"][0], cgnn["readout_chest"])
    for mode, it_p, ro in (("state", cgnn["iterations"][0], ()),
                           ("readout", cgnn["iterations"][1], readouts)):
        check("cgnn_iter",
              cgnn_iter.fused_iteration(it_p, s16, pe, act16, None, *ro,
                                        lp_stencil=True),
              cgnn_iter.fused_iteration_reference(it_p, s16, pe, act16, None,
                                                  *ro, lp_stencil=True),
              cgnn_iter.fused_iteration(it_p, s16, pe, act16, None, *ro,
                                        lp_stencil=False),
              bf, TOL_BF16, mode="lp", iteration=mode, batch=16)
    z1 = torch.randn((1, N_TX, h, w, 18), generator=gen, device=dev).to(bf)
    act1 = torch.ones((1, N_TX), device=dev)
    check("cgnn_full",
          cgnn_iter.fused_cgnn_full(cgnn, z1, pe, act1, lp_stencil=True),
          cgnn_iter.fused_cgnn_full_reference(cgnn, z1, pe, act1,
                                              lp_stencil=True),
          cgnn_iter.fused_cgnn_full(cgnn, z1, pe, act1, lp_stencil=False),
          bf, TOL_BF16, mode="lp", batch=1)
    refused = False
    try:
        cgnn_iter.fused_iteration(cgnn["iterations"][0], s16, pe, act16,
                                  mxu=True)
    except ValueError:
        refused = True
    assert refused, "fused_iteration took mxu=True"

    # 2. the receiver's routes with the modes against their plain routes
    rng = np.random.default_rng(MODES_SEED)
    y1, y16 = (torch.as_tensor(rng.normal(size=(b, 4, h, w, 2)),
                               dtype=torch.float32, device=dev)
               for b in (1, 16))
    routes = {
        # name: (CGNNConfig fields, env, y, expected launches, by mode)
        "b1_mxu_env": ({}, {"NRX_CONV_MXU": "1"}, y1,
                       {"sepconv_stack": 3, "cgnn_iter": 0, "cgnn_full": 0},
                       {"sepconv_stack": {"normal": 0, "lp": 0, "mxu": 3}}),
        "b16_mxu_cfg": ({"conv_mxu": True}, {}, y16,
                        {"sepconv_stack": 3, "cgnn_iter": 0, "cgnn_full": 0},
                        {"sepconv_stack": {"normal": 2, "lp": 0, "mxu": 1}}),
        "b16_lp": ({"stencil_lp": True}, {}, y16,
                   {"sepconv_stack": 1, "cgnn_iter": 2, "cgnn_full": 0},
                   {"sepconv_stack": {"normal": 0, "lp": 1, "mxu": 0},
                    "cgnn_iter": {"normal": 0, "lp": 2}}),
        "mega_b1_lp": ({"stencil_lp": True, "fused_full": True}, {}, y1,
                       {"sepconv_stack": 0, "cgnn_iter": 0, "cgnn_full": 1},
                       {"cgnn_full": {"normal": 0, "lp": 1}})}
    launches, modes, route_recs = {}, {}, {}
    for name, (kw, env, yy, want, want_modes) in routes.items():
        os.environ.update(env)
        try:
            rx_k = make_receiver(device=dev)
            rx_p = make_receiver(device=dev, kernels=False)
            for r in (rx_k, rx_p):
                r.cgnn_cfg = dataclasses.replace(r.cgnn_cfg, **kw)
            reset_modes()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                llr, h_hat = rx_k.serve(params, yy)
            torch.cuda.synchronize()
            got = {k: v for k, v in counts().items() if k in want}
            launches[name], modes[name] = counts(), modes_now()
            reset_modes()
            llr_p, h_p = rx_p.serve(params, yy)
            torch.cuda.synchronize()
            assert counts() == dict.fromkeys(counts(), 0), counts()
        finally:
            for k in env:
                os.environ.pop(k, None)
        route_recs[name] = {
            "batch": yy.shape[0], "config": kw, "env": env,
            "launches": got, "by_mode": {k: modes[name][k]
                                         for k in want_modes},
            "warned": [str(c.message)[:60] for c in caught],
            "rel_err_vs_plain": {"llr": rel_err(llr, llr_p),
                                 "h_hat": rel_err(h_hat, h_p)},
            "equal_to_plain": bool(torch.equal(llr, llr_p)
                                   and torch.equal(h_hat, h_p)),
            "finite": bool(torch.isfinite(llr).all()
                           and torch.isfinite(h_hat).all())}
        assert got == want, (name, got)
        for k, v in want_modes.items():
            assert modes[name][k] == v, (name, k, modes[name][k])
        assert route_recs[name]["finite"], name
        assert route_recs[name]["equal_to_plain"], (name, route_recs[name])
    assert route_recs["b16_mxu_cfg"]["warned"], "no conv_mxu warning"
    reset_modes()

    # 3. device times, each mode beside the normal mode in turns
    def ab(normal, moded, reps, warmup=3):
        t = [cuda_ms(f, reps, warmup) for f in (normal, moded, moded,
                                                normal)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    def rec(normal_ms, ms, plain_ms, work, rate="bf16_flops"):
        b = bound(*work, peaks, rate)
        return {"normal_ms": normal_ms, "kernel_ms": ms, "plain_ms": plain_ms,
                **b, "pct_of_bound": 100.0 * b["bound_ms"] / ms}

    times = {"card": card}
    for mode, kw in (("mxu", {"mxu": True}), ("lp", {"lp_stencil": True})):
        slot = []
        for sname, p in stacks.items():
            widths = widths_of(p)
            x = torch.randn((2, h, w, widths[0]), generator=gen,
                            device=dev).to(bf)
            normal_ms, ms = ab(lambda: sepconv.fused_conv_stack(
                p, x, mxu=False, lp_stencil=False),
                lambda: sepconv.fused_conv_stack(p, x, **kw), 20)
            nbytes, flops = stack_work(widths, 2, h, w, 2)
            if mode == "mxu":
                flops = fold_flops(widths) * 2 * h * w
            slot.append({"stack": sname, **rec(
                normal_ms, ms, cuda_ms(lambda: sepconv.sepconv_stack_reference(
                    p, x, **kw), 3), (nbytes, flops))})
        p = stacks["init"]
        x = torch.randn((32, h, w, 18), generator=gen, device=dev).to(bf)
        normal_ms, ms = ab(lambda: sepconv.fused_conv_stack(
            p, x, mxu=False, lp_stencil=False),
            lambda: sepconv.fused_conv_stack(p, x, **kw), 5)
        nbytes, flops = stack_work(widths_of(p), 32, h, w, 2)
        if mode == "mxu":
            flops = fold_flops(widths_of(p)) * 32 * h * w
        times[f"k1_{mode}"] = {
            "slot": slot,
            "slot_ms": sum(r["kernel_ms"] for r in slot),
            "slot_normal_ms": sum(r["normal_ms"] for r in slot),
            "slot_plain_ms": sum(r["plain_ms"] for r in slot),
            "slot_bound_ms": sum(r["bound_ms"] for r in slot),
            "n32": rec(normal_ms, ms, cuda_ms(
                lambda: sepconv.sepconv_stack_reference(p, x, **kw), 2,
                warmup=1), (nbytes, flops))}
        del x
    # K1 float32 folded at the Monte-Carlo launch (init stack, N = 60)
    p = stacks["init"]
    x60 = torch.randn((MC_BATCH * N_TX, h, w, 18), generator=gen,
                      device=dev)
    normal_ms, ms = ab(lambda: sepconv.fused_conv_stack(p, x60, mxu=False),
                       lambda: sepconv.fused_conv_stack(p, x60, mxu=True), 3,
                       warmup=1)
    times["k1_mxu_f32_n60"] = rec(
        normal_ms, ms, cuda_ms(lambda: sepconv.sepconv_stack_reference(
            p, x60, mxu=True), 2, warmup=1),
        (stack_work(widths_of(p), 60, h, w, 4)[0],
         fold_flops(widths_of(p)) * 60 * h * w), rate="f32_flops")
    del x60
    it0 = cgnn["iterations"][0]
    normal_ms, ms = ab(
        lambda: cgnn_iter.fused_iteration(it0, s16, pe, act16,
                                          lp_stencil=False),
        lambda: cgnn_iter.fused_iteration(it0, s16, pe, act16,
                                          lp_stencil=True), 5)
    times["k3_lp_b16"] = rec(normal_ms, ms, cuda_ms(
        lambda: cgnn_iter.fused_iteration_reference(
            it0, s16, pe, act16, lp_stencil=True), 2, warmup=1),
        iteration_work(it0, 16, pe.shape[-1], 2))
    normal_ms, ms = ab(
        lambda: cgnn_iter.fused_cgnn_full(cgnn, z1, pe, act1,
                                          lp_stencil=False),
        lambda: cgnn_iter.fused_cgnn_full(cgnn, z1, pe, act1,
                                          lp_stencil=True), 20)
    times["k4_lp_b1"] = rec(normal_ms, ms, cuda_ms(
        lambda: cgnn_iter.fused_cgnn_full_reference(
            cgnn, z1, pe, act1, lp_stencil=True), 3, warmup=1),
        full_work(cgnn, 1, pe.shape[-1], 2))
    del s16
    reset_modes()

    # 4. the mode instances' registers and spills (ptxas -v; mangled
    # template tails: stack mode 1 or 2, CGNN kLp true, then kWide)
    regs = {k: v for k, v in ptxas_entries(ptxas).items()
            if any(t in k for t in ("Li1ELb", "Li2ELb", "Lb1ELb"))}
    for k, v in saved_env.items():
        if v is not None:
            os.environ[k] = v
    emit({"phase": "modes_path", "card": card, "checks": checks,
          "routes": route_recs, "times": times, "ptxas_new": regs,
          "seconds": time.perf_counter() - t0})
    return launches, times, modes


COMPLETION_SEED = 5
WIDE_INSTANCE = "ELb1EE"  # mangled template tail of a kWide instance


def completion_path(dev, card, peaks, counts, reset, ptxas):
    """The last of the JAX package on the card. e2e_rt at 132 PRB with
    seed-made parameters, bf16: K1 on its 130-channel update stack (normal,
    stencil_lp and folded modes), K3 at batch 16 (state and readout modes)
    and K4 at batch 1 (4 iterations), both normal and stencil_lp, and
    e2e_large's K4 at 8 iterations, each equal bit for bit to its plain
    version (K1/K3/K4 also in float32, within TOL_F32); the receiver's
    batch-1, batch-16 and mega routes equal to their plain routes, with
    their launches. nrx_rt with full 3x3 conv layers (seed-made, 132 PRB)
    on those routes in bf16 and float32: no kernel launched, equal to the
    plain route, finite, device ms; one conv-layer training step at batch
    128, 4 PRB. The fused routes where JAX's gates fail (a two-hidden-layer
    aggregation MLP; apply_multiloss): the launches the gates imply, equal
    to the plain route. Each e2e kernel's time beside its bound and plain
    version; the registers and spills of the wide instances, and no spill
    in any instance. Returns (launches by route, times)."""
    import dataclasses

    import torch
    from neural_rx_tpu_torch.entry import train_entry
    from neural_rx_tpu_torch.kernels import cgnn_iter, sepconv
    from neural_rx_tpu_torch.rx.cgnn import cgnn_apply
    from neural_rx_tpu_torch.rx.neural_rx import receiver_for
    from neural_rx_tpu_torch.sim.config import Parameters
    from neural_rx_tpu_torch.weights import flatten

    t0 = time.perf_counter()
    bf, f32 = torch.bfloat16, torch.float32
    h, w = N_SYM, N_SC
    gen = torch.Generator(device=dev).manual_seed(COMPLETION_SEED)
    rng = np.random.default_rng(COMPLETION_SEED)
    y1, y16 = (torch.as_tensor(rng.normal(size=(b, 4, h, w, 2)),
                               dtype=torch.float32, device=dev)
               for b in (1, 16))
    stack_modes = {"normal": {"mxu": False, "lp_stencil": False},
                   "lp": {"mxu": False, "lp_stencil": True},
                   "mxu": {"mxu": True, "lp_stencil": False}}

    # 1. the e2e kernels past 128 input channels against their plain versions
    checks = []

    def check(kernel, got, ref, dtype, **what):
        """bf16: equal bit for bit; float32: within TOL_F32."""
        got, ref = (t if isinstance(t, tuple) else (t,) for t in (got, ref))
        torch.cuda.synchronize()
        rec = compare(got, ref, dtype, TOL_BF16 if dtype == bf else TOL_F32)
        if dtype == bf:
            rec["ok"] = rec["ok"] and rec["differing_share"] == 0
        checks.append({"kernel": kernel, **what, **rec})
        assert rec["ok"], checks[-1]

    p_e2e = Parameters("e2e_rt", training=False)
    rx_e2e = receiver_for(p_e2e, bf, device=dev)
    params = rx_e2e.init_params(gen)
    cgnn = params["cgnn"]
    upd = cgnn["iterations"][0]["update"]
    assert widths_of(upd) == [130, 128, 128, 64], widths_of(upd)
    assert len(cgnn["iterations"]) == 4
    readouts = (cgnn["readout_llrs"][0], cgnn["readout_chest"])
    t_e = rx_e2e.max_num_tx  # e2e_rt evaluates one user
    # K1 as the batch-1 route launches it on an update stack (N = t_e)
    x32 = torch.randn((t_e, h, w, 130), generator=gen, device=dev)
    s32 = 4.0 * torch.randn((16, t_e, h, w, 64), generator=gen, device=dev)
    z32 = torch.randn((1, t_e, h, w, 10), generator=gen, device=dev)
    act16 = torch.ones((16, t_e), device=dev)
    act1 = torch.ones((1, t_e), device=dev)
    for dtype in (bf, f32):
        x, s16, z1, pe = (t.to(dtype) for t in (x32, s32, z32, rx_e2e.pe))
        for mode, kw in stack_modes.items():
            if dtype == f32 and mode != "normal":
                continue
            for scv in SC_VALID_CASES if mode == "normal" else (None,):
                check("sepconv_stack",
                      sepconv.fused_conv_stack(upd, x, scv, **kw),
                      sepconv.sepconv_stack_reference(upd, x, scv, **kw),
                      dtype, config="e2e_rt", stack="update0", mode=mode,
                      sc_valid=scv)
            if mode == "mxu":
                continue
            lp = {"lp_stencil": kw["lp_stencil"]}
            for imode, it_p, ro in (("state", cgnn["iterations"][0], ()),
                                    ("readout", cgnn["iterations"][3],
                                     readouts)):
                check("cgnn_iter",
                      cgnn_iter.fused_iteration(it_p, s16, pe, act16, None,
                                                *ro, **lp),
                      cgnn_iter.fused_iteration_reference(
                          it_p, s16, pe, act16, None, *ro, **lp),
                      dtype, config="e2e_rt", iteration=imode, batch=16,
                      mode=mode)
            check("cgnn_full",
                  cgnn_iter.fused_cgnn_full(cgnn, z1, pe, act1, **lp),
                  cgnn_iter.fused_cgnn_full_reference(cgnn, z1, pe, act1,
                                                      **lp),
                  dtype, config="e2e_rt", batch=1, iterations=4, mode=mode)
    rx_large = receiver_for(Parameters("e2e_large", training=False), bf,
                            device=dev)
    cgnn_l = rx_large.init_params(gen)["cgnn"]
    assert len(cgnn_l["iterations"]) == 8 and rx_large.max_num_tx == t_e
    z1, pe_l = z32.to(bf), rx_large.pe.to(bf)
    for mode in ("normal", "lp"):
        lp = {"lp_stencil": mode == "lp"}
        check("cgnn_full",
              cgnn_iter.fused_cgnn_full(cgnn_l, z1, pe_l, act1, **lp),
              cgnn_iter.fused_cgnn_full_reference(cgnn_l, z1, pe_l, act1,
                                                  **lp),
              bf, config="e2e_large", batch=1, iterations=8, mode=mode)
    reset()

    # 2. routes against their plain routes, launches counted
    launches, route_recs = {}, {}

    def route(name, fn, fn_plain, want):
        reset()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        reset()
        ref = fn_plain()
        torch.cuda.synchronize()
        plain_counts = counts()
        reset()
        launches[name] = got
        route_recs[name] = {
            "launches": {k: v for k, v in got.items() if v},
            "equal_to_plain": all(torch.equal(a, b)
                                  for a, b in zip(out, ref)),
            "finite": all(bool(torch.isfinite(a).all()) for a in out)}
        assert got == {**dict.fromkeys(got, 0), **want}, (name, got)
        assert plain_counts == dict.fromkeys(plain_counts, 0), plain_counts
        assert route_recs[name]["equal_to_plain"], (name, route_recs[name])
        assert route_recs[name]["finite"], name
        return out

    def pair(p, dtype, **kw):
        return (receiver_for(p, dtype, device=dev, **kw),
                receiver_for(p, dtype, device=dev, kernels=False, **kw))

    times = {"card": card}
    (rk, rp), (mk, mp) = pair(p_e2e, bf), pair(p_e2e, bf, fused_full=True)
    n_it = len(cgnn["iterations"])
    for b, y in ((1, y1), (16, y16)):
        route(f"e2e_rt_b{b}", lambda: rk.serve(params, y),
              lambda: rp.serve(params, y),
              {"sepconv_stack": 1 + n_it} if b == 1 else
              {"sepconv_stack": 1, "cgnn_iter": n_it})
        route(f"e2e_rt_mega_b{b}", lambda: mk.serve(params, y),
              lambda: mp.serve(params, y), {"cgnn_full": 1})

    # full 3x3 conv layers: nrx_rt's widths, no kernel on any route
    p_conv = Parameters("nrx_rt", training=False,
                        overrides={"layer_type_conv": "conv"})
    params_c = None
    conv_ms = {}
    for dtype in (bf, f32):
        dt = "bf16" if dtype == bf else "f32"
        (ck, cp), (cmk, cmp) = pair(p_conv, dtype), pair(p_conv, dtype,
                                                          fused_full=True)
        if params_c is None:
            params_c = ck.init_params(gen)
            assert "w" in params_c["cgnn"]["s_init"][0]["out"]
        for b, y in ((1, y1), (16, y16)):
            route(f"conv_{dt}_b{b}", lambda: ck.serve(params_c, y),
                  lambda: cp.serve(params_c, y), {})
            route(f"conv_{dt}_mega_b{b}", lambda: cmk.serve(params_c, y),
                  lambda: cmp.serve(params_c, y), {})
            conv_ms[f"{dt}_b{b}"] = cuda_ms(lambda: ck.serve(params_c, y),
                                            3, warmup=1)
        del ck, cp, cmk, cmp
    fn_t, (params_t, gen_t) = train_entry(
        TRAIN_LABEL, device=dev, batch=TRAIN_BATCH,
        overrides={"layer_type_conv": "conv"})
    reset()
    losses = fn_t(params_t, gen_t)
    torch.cuda.synchronize()
    train_launches = counts()
    grads = [v.grad for v in flatten(params_t["cgnn"]).values()]
    conv_ms["train_step_b128"] = cuda_ms(lambda: fn_t(params_t, gen_t), 3,
                                         warmup=1)
    conv_train = {"losses": [float(x) for x in losses],
                  "launches": {k: v for k, v in train_launches.items() if v},
                  "grads_finite": all(g is not None
                                      and bool(torch.isfinite(g).all())
                                      for g in grads),
                  "step_ms": conv_ms["train_step_b128"]}
    assert train_launches == dict.fromkeys(train_launches, 0), train_launches
    assert all(np.isfinite(conv_train["losses"])), conv_train
    assert conv_train["grads_finite"], conv_train
    times["conv_layers_ms"] = conv_ms
    del params_t, fn_t

    # the fused routes where JAX's gates fail: the fallbacks' launches
    p_deep = Parameters("nrx_rt", training=False,
                        overrides={"num_units_agg": [[64, 64], [64]]})
    (dk, dp), (dmk, dmp) = pair(p_deep, bf), pair(p_deep, bf,
                                                  fused_full=True)
    params_d = dk.init_params(gen)
    # batch 16: iteration 0 (two hidden layers) plain with its update
    # stack in K1, iteration 1 in K3 with both readouts
    route("c1_deep_agg_b16", lambda: dk.serve(params_d, y16),
          lambda: dp.serve(params_d, y16),
          {"sepconv_stack": 2, "cgnn_iter": 1})
    route("c1_deep_agg_mega_b1", lambda: dmk.serve(params_d, y1),
          lambda: dmp.serve(params_d, y1), {"sepconv_stack": 3})
    rx_n = receiver_for(Parameters("nrx_rt", training=False), bf,
                        device=dev)
    params_n = rx_n.init_params(gen)

    def multiloss(kernels, **flags):
        y_in, h_in = rx_n._prepare_inputs(y16)
        cfg = dataclasses.replace(rx_n.cgnn_cfg, kernels=kernels, **flags)
        llrs, h_hats = cgnn_apply(
            params_n["cgnn"], cfg, y_in, rx_n.pe, h_in,
            torch.ones((16, N_TX), device=dev),
            torch.ones((16, N_TX, 1), device=dev), dtype=bf,
            apply_multiloss=True)
        assert len(llrs) == 1
        return llrs[-1][0], h_hats[-1]
    route("c1_multiloss_full",
          lambda: multiloss(True, fused_full=True),
          lambda: multiloss(False, fused_full=True), {"sepconv_stack": 3})
    route("c1_multiloss_readout",
          lambda: multiloss(True, fused_iteration=True, fused_readout=True),
          lambda: multiloss(False, fused_iteration=True,
                            fused_readout=True),
          {"sepconv_stack": 1, "cgnn_iter": 2})
    del dk, dp, dmk, dmp, rx_n

    # 3. the e2e kernels' device times with their bounds
    def timed(name, fn, plain, work, rate="bf16_flops", reps=10):
        times[name] = rates({"kernel_ms": cuda_ms(fn, reps),
                             "plain_ms": cuda_ms(plain, 2, warmup=1),
                             **bound(*work, peaks, rate)})

    for dtype in (bf, f32):
        dt, size = ("bf16", 2) if dtype == bf else ("f32", 4)
        rate = "bf16_flops" if dtype == bf else "f32_flops"
        x, s16, z1, pe = (t.to(dtype) for t in (x32, s32, z32, rx_e2e.pe))
        it0 = cgnn["iterations"][0]
        timed(f"k1_130_n2_{dt}",
              lambda: sepconv.fused_conv_stack(upd, x, mxu=False,
                                               lp_stencil=False),
              lambda: sepconv.sepconv_stack_reference(upd, x),
              stack_work(widths_of(upd), t_e, h, w, size), rate, 20)
        timed(f"k3_e2e_b16_{dt}",
              lambda: cgnn_iter.fused_iteration(it0, s16, pe, act16,
                                                lp_stencil=False),
              lambda: cgnn_iter.fused_iteration_reference(it0, s16, pe,
                                                          act16),
              iteration_work(it0, 16, pe.shape[-1], size, t=t_e), rate, 3)
        timed(f"k4_e2e_b1_{dt}",
              lambda: cgnn_iter.fused_cgnn_full(cgnn, z1, pe, act1,
                                                lp_stencil=False),
              lambda: cgnn_iter.fused_cgnn_full_reference(cgnn, z1, pe,
                                                          act1),
              full_work(cgnn, 1, pe.shape[-1], size, t=t_e), rate, 5)
    z1 = z32.to(bf)
    timed("k4_e2e_large_8it_b1_bf16",
          lambda: cgnn_iter.fused_cgnn_full(cgnn_l, z1, pe_l, act1,
                                            lp_stencil=False),
          lambda: cgnn_iter.fused_cgnn_full_reference(cgnn_l, z1, pe_l,
                                                      act1),
          full_work(cgnn_l, 1, pe_l.shape[-1], 2, t=t_e), reps=5)
    del s32, x32
    reset()

    # 4. registers and spills: the wide instances, and no spill anywhere
    entries = ptxas_entries(ptxas)
    spilled = {k: v for k, v in entries.items()
               if any("spill" in ln and "0 bytes spill stores, 0 bytes "
                      "spill loads" not in ln for ln in v)}
    wide = {k: v for k, v in entries.items() if WIDE_INSTANCE in k}
    emit({"phase": "completion_path", "card": card, "checks": checks,
          "routes": route_recs, "conv_training": conv_train,
          "times": times, "ptxas_wide": wide, "spilled": spilled,
          "seconds": time.perf_counter() - t0})
    assert len(wide) == 7, sorted(wide)  # K1 x 3 modes, K3 x 2, K4 x 2
    assert not spilled, spilled
    return launches, times


def kernel_of(name: str) -> str:
    """The launch counter a device kernel's name belongs to, or "other"."""
    for key, part in (("sepconv_stack", "sepconv_stack_kernel"),
                      ("cgnn_iter", "cgnn_iter_kernel"),
                      ("cgnn_full", "cgnn_full_kernel"),
                      ("ldpc_decode", "ldpc_layered_kernel")):
        if part in name:
            return key
    return "other"


def profile_steps(fn, steps=2):
    """Device time of fn() per call over `steps` calls after one more
    (profiler): the window's host ms, the device's busy ms and share, and
    per launch counter (`kernel_of`) its ms and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t1) * 1e3 / steps
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = by.setdefault(kernel_of(e.name), {"ms": 0.0,
                                                    "launches": 0.0})
            rec["ms"] += e.time_range.elapsed_us() / 1e3 / steps
            rec["launches"] += 1.0 / steps
    busy = sum(rec["ms"] for rec in by.values())
    return {"window_ms": window, "busy_ms": busy,
            "busy_share": busy / window, "by_kernel": by}


def mc_step_bounds(cgnn, b, t, codes, peaks) -> dict:
    """Least device ms of a float32 Monte-Carlo step's kernels, per launch
    counter: the init stack on b*t images, every iteration at batch b with
    t users (the last with both readouts), and a layered decode of each
    (code, codewords) of `codes`."""
    its = cgnn["iterations"]
    ro = (cgnn["readout_llrs"][0], cgnn["readout_chest"])
    f32 = {"peaks": peaks, "rate": "f32_flops"}
    return {
        "sepconv_stack": bound(*stack_work(widths_of(cgnn["s_init"][0]),
                                           b * t, N_SYM, N_SC, 4),
                               **f32)["bound_ms"],
        "cgnn_iter": sum(bound(*iteration_work(
            it, b, 2, 4, ro if i == len(its) - 1 else (), t=t),
            **f32)["bound_ms"] for i, it in enumerate(its)),
        "ldpc_decode": sum(bound(*ldpc_work(code, n), **f32)["bound_ms"]
                           for code, n in codes)}


def large_path(dev, card, peaks, counts, reset):
    """Phase 16: nrx_large and e2e_rt with their committed weights (the
    parts of weights/nrx_large_weights.npz and e2e_rt_ema_weights.npz).
    (a) nrx_large's Monte Carlo at 132 PRB, batch 30, float32, DoubleTDLlow:
    a step's launches through `mc_entry` (1 stack, 8 iteration, 2 LDPC),
    the kernel route equal to the plain route, `sim_ber` at 1, 2, 3 dB in
    the band of the JAX package's curve with the same weights (the CPU
    sweep LARGE_JAX_CURVE; the committed curve beside), a step's device ms
    by stage and by kernel beside its bound, and its busy share; (b)
    nrx_large's bf16
    serving routes: batch 16 (1 stack, 8 iteration launches) and mega at
    batch 1 (one whole-CGNN launch, 8 iterations), each equal bit for bit
    to its plain route, with device ms; (c) WARM_STEPS Adam steps from the
    committed weights at phase 1 (UMi, 4 PRB, batch 128, apply_multiloss,
    double readout, 8 iterations): finite losses, the data loss within
    three standard errors of the JAX package's (JAX_LARGE_WARM_LOSS), a
    step's device ms and the peak memory; (d) e2e_rt's Monte Carlo (EMA
    weights, learned constellation, 1 user, TDL-B100, batch 20): launches
    (1 stack, 4 iteration, 1 LDPC), the transmitter's points the
    committed constellation's centred and normalised, kernel route = plain
    route, `sim_ber` at 1, 2, 3 dB in the band of its curve. Emits the
    phase's record, asserts it, and returns (launches by path, the step
    profiles)."""
    import torch
    from neural_rx_tpu_torch import weights
    from neural_rx_tpu_torch.channel.apply import apply_ofdm_channel
    from neural_rx_tpu_torch.entry import load_params, mc_entry
    from neural_rx_tpu_torch.kernels import ldpc as k5
    from neural_rx_tpu_torch.rx.neural_rx import mcs_mask, receiver_for
    from neural_rx_tpu_torch.sim import training
    from neural_rx_tpu_torch.sim.config import Parameters
    from neural_rx_tpu_torch.sim.e2e import E2EModel
    from neural_rx_tpu_torch.sim.simber import sim_ber

    t0 = time.perf_counter()
    zero = dict.fromkeys(("sepconv_stack", "cgnn_iter", "cgnn_full",
                          "ldpc_decode"), 0)
    launches = {}
    expected = {
        "large_mc_b30": {**zero, "sepconv_stack": 1, "cgnn_iter": 8,
                         "ldpc_decode": 2},
        "large_b16": {**zero, "sepconv_stack": 1, "cgnn_iter": 8},
        "large_mega_b1": {**zero, "cgnn_full": 1},
        "large_warm_b128": zero,
        "e2e_mc_b20": {**zero, "sepconv_stack": 1, "cgnn_iter": 4,
                       "ldpc_decode": 1}}

    def monte_carlo(route, label, batch, curve, committed=None):
        """A step's launches through mc_entry (counted under `route`),
        kernel route = plain route on one step, the sweep (its points beside
        `curve`, and beside the `committed` curve where that is another),
        the stages and the profile of a step."""
        fn, (params, gen) = mc_entry(device=dev, batch=batch,
                                     ebno_db=LARGE_STEP_DB, seed=LARGE_SEED,
                                     config=label)
        reset()
        step_counts = fn(params, gen).tolist()
        torch.cuda.synchronize()
        launches[route] = counts()
        reset()
        p = Parameters(label, training=False)
        models = [E2EModel(p, kernels=k, device=dev) for k in (True, False)]
        outs = []
        for m in models:
            g = torch.Generator(device=dev).manual_seed(LARGE_SEED)
            outs.append(m(params, g, batch, LARGE_STEP_DB, fast_ldpc=True))
        torch.cuda.synchronize()
        reset()
        (b, b_hat, crc), ref = outs
        plain = {"ebno_db": LARGE_STEP_DB, "counters": block_counts(b, b_hat),
                 "counters_plain": block_counts(ref[0], ref[1]),
                 "crc_truthful": bool(torch.equal((b_hat == b).all(dim=-1),
                                                  crc)),
                 "equals_plain_route": all(torch.equal(x, y)
                                           for x, y in zip(outs[0], ref))}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bers, blers, n_err, n_blk = sim_ber(
            models[0], params, LARGE_SWEEP_DB, batch,
            max_mc_iter=MC_MAX_ITER,
            num_target_block_errors=MC_TARGET_BLOCK_ERRORS, seed=LARGE_SEED,
            verbose=False, fast_ldpc=True, return_counts=True)
        wall = time.perf_counter() - t1
        users = p.max_num_tx
        steps = int(n_blk.sum()) // (batch * users)
        sweep = {"points": [curve_point(*pt, curve) for pt in zip(
                     LARGE_SWEEP_DB, bers, blers, n_err, n_blk)],
                 "steps": steps, "wall_s": wall,
                 "slots_per_s_wall": steps * batch / wall}
        if committed is not None:
            for pt in sweep["points"]:
                pt["committed_curve_bler"] = jax_bler(pt["ebno_db"],
                                                      committed)
        # a step's device ms by stage: draws + transmitter + channel,
        # receiver (the CGNN's kernels), decode (K5, every user)
        model, rx = models[0], models[0].receiver
        gen_t = torch.Generator(device=dev).manual_seed(LARGE_SEED + 1)
        mask = mcs_mask((batch, users), 0, model.num_mcs, dev)

        def front():
            bits, h_, n_ = model.draw(gen_t, batch, LARGE_STEP_DB)
            x = model.transmit(bits, [0], mask, points=(
                model.constellation_points(params, [0])))
            return apply_ofdm_channel(x, h_, None, noise=n_)
        y_t = front()
        y_tp = torch.stack([y_t.real, y_t.imag], dim=-1)
        llr_t, _ = rx.serve(params, y_tp)
        tbs = rx.tb_configs[0]

        def decode():
            flat = rx.rg.demap_data(llr_t).reshape(batch, users, -1)
            return [k5.tb_decode_fast(cfg, flat[:, ue])
                    for ue, cfg in enumerate(tbs)]
        stages = {"front_ms": cuda_ms(front, 3, warmup=1),
                  "receiver_ms": cuda_ms(lambda: rx.serve(params, y_tp), 3,
                                         warmup=1),
                  "decode_ms": cuda_ms(decode, 3, warmup=1)}
        stages["device_step_ms"] = sum(stages.values())
        stages["slots_per_s_device"] = batch / stages["device_step_ms"] * 1e3
        prof = profile_steps(lambda: fn(params, gen))
        for k, bms in mc_step_bounds(
                params["cgnn"], batch, users,
                [(cfg.code, batch * cfg.num_cbs) for cfg in tbs],
                peaks).items():
            rec = prof["by_kernel"][k]
            rec["bound_ms"] = bms
            rec["pct_of_bound"] = 100.0 * bms / rec["ms"]
        reset()
        rec = {"config": label, "batch": batch, "users": users,
               "step_counts": step_counts, "kernel_vs_plain": plain,
               "sweep": sweep, "stages": stages, "profile": prof}
        return rec, models[0], params

    # (a) nrx_large's Monte Carlo
    with open(os.path.join(ROOT, LARGE_JAX_CURVE)) as f:
        assert json.load(f)["weights"] == "nrx_large_weights.pkl"
    mc_large, _, _ = monte_carlo(
        "large_mc_b30", LARGE_LABEL, LARGE_BATCH,
        json_curve(LARGE_JAX_CURVE), json_curve(LARGE_CURVE, ("curve",)))

    # (b) nrx_large's bf16 serving routes against their plain routes
    p_l = Parameters(LARGE_LABEL, training=False)
    params_b = load_params(dtype=torch.bfloat16, device=dev,
                           path=weights.committed_weights(LARGE_LABEL))
    rng = np.random.default_rng(LARGE_SEED)
    ys = {b: torch.as_tensor(rng.normal(size=(b, 4, N_SYM, N_SC, 2)),
                             dtype=torch.float32, device=dev)
          for b in (1, LARGE_SERVE_BATCH)}
    serving = {}
    for route, mega, b in (("large_b16", False, LARGE_SERVE_BATCH),
                           ("large_mega_b1", True, 1)):
        rxk, rxp = (receiver_for(p_l, torch.bfloat16, fused_full=mega,
                                 kernels=k, device=dev)
                    for k in (True, False))
        reset()
        out = rxk.serve(params_b, ys[b])
        torch.cuda.synchronize()
        launches[route] = counts()
        reset()
        ref = rxp.serve(params_b, ys[b])
        torch.cuda.synchronize()
        plain_counts = counts()
        serving[route] = {
            "batch": b, "plain_launches": plain_counts,
            "equal_to_plain": all(torch.equal(x, y)
                                  for x, y in zip(out, ref)),
            "finite": all(bool(torch.isfinite(x).all()) for x in out),
            "call_ms": cuda_ms(lambda: rxk.serve(params_b, ys[b]),
                               10 if b == 1 else 3),
            "plain_call_ms": cuda_ms(lambda: rxp.serve(params_b, ys[b]), 2,
                                     warmup=1)}
        serving[route]["slot_ms"] = serving[route]["call_ms"] / b
        reset()
        del rxk, rxp
    del params_b, ys

    # (c) the warm start from the committed weights, phase 1, multiloss
    p_t = Parameters(LARGE_LABEL, training=True)
    sched = p_t.training_schedule
    warm_model = E2EModel(p_t, training=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(LARGE_SEED)
    warm, copied, kept = training.merge_matching_leaves(
        warm_model.init_params(gen), training.load_weights(
            weights.committed_weights(LARGE_LABEL), dev))
    warm = training.trainable(warm)
    phase = 1
    flags = {"double_readout": bool(sched["double_readout"][phase]),
             "apply_multiloss": bool(sched["apply_multiloss"][phase]),
             "weighting": float(sched["weighting_double_readout"][phase])}
    wstep = training.make_step(
        warm_model, p_t, training.make_adam(
            warm, float(sched["learning_rate"][phase])), [0], TRAIN_BATCH,
        flags["double_readout"], flags["weighting"],
        flags["apply_multiloss"], False)
    wstep.set_snr_range(sched["min_training_snr_db"][phase],
                        sched["max_training_snr_db"][phase])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    hist, step_ms = [], []
    t1 = time.perf_counter()
    for _ in range(WARM_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        hist.append(wstep(warm, gen))
        ev[1].record()
        torch.cuda.synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
    wall = time.perf_counter() - t1
    launches["large_warm_b128"] = counts()
    reset()
    whist = training.loss_history(hist)
    w_se = float(whist[:, 0].std(ddof=1) / np.sqrt(WARM_STEPS))
    warm_rec = {"copied": copied, "kept": kept, "steps": WARM_STEPS,
                "phase": phase, **flags, "batch": TRAIN_BATCH,
                "iterations": len(warm["cgnn"]["iterations"]),
                "losses": whist.tolist(),
                "loss_data_mean": float(whist[:, 0].mean()),
                "loss_data_se": w_se,
                "jax_mean": JAX_LARGE_WARM_LOSS[0],
                "jax_se": JAX_LARGE_WARM_LOSS[1],
                "all_finite": bool(np.isfinite(whist).all()),
                "step_event_ms_median": float(np.median(step_ms[2:])),
                "steps_per_s_wall": WARM_STEPS / wall,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("warm start nrx_large (multiloss): loss_data mean "
          f"{warm_rec['loss_data_mean']:.4f} +- {w_se:.4f} (JAX, same "
          f"weights and sampling: {JAX_LARGE_WARM_LOSS[0]:.4f} +- "
          f"{JAX_LARGE_WARM_LOSS[1]:.4f})", flush=True)
    del warm, wstep, warm_model

    # (d) e2e_rt's Monte Carlo with its learned constellation
    mc_e2e, model_e, params_e = monte_carlo(
        "e2e_mc_b20", E2E_LABEL, E2E_EVAL_BATCH,
        json_curve(E2E_CURVE, ("curve",)))
    c = np.asarray(weights.load_tree(weights.committed_weights(E2E_LABEL),
                                     device="cpu")["constellation"][0],
                   np.float64)
    c = c[0] + 1j * c[1]
    c = c - c.mean()
    c = c / np.sqrt((np.abs(c) ** 2).mean())
    (pts,) = model_e.constellation_points(params_e, [0])
    pts = pts.cpu().numpy()
    mc_e2e["constellation"] = {
        "points": len(pts), "max_abs_err": float(np.abs(pts - c).max()),
        "mean_abs": float(abs(pts.mean())),
        "energy": float((np.abs(pts) ** 2).mean())}
    del model_e, params_e

    emit({"phase": "large_path", "card": card, "nrx_large_mc": mc_large,
          "serving": serving, "warm_start": warm_rec, "e2e_rt_mc": mc_e2e,
          "launches": launches, "expected": expected,
          "seconds": time.perf_counter() - t0})
    for route, want in expected.items():
        assert launches[route] == want, (route, launches[route])
    for rec in (mc_large, mc_e2e):
        assert rec["kernel_vs_plain"]["equals_plain_route"], rec
        assert rec["kernel_vs_plain"]["crc_truthful"], rec
        for pt in rec["sweep"]["points"]:
            lo, hi = pt["band"]
            assert lo <= pt["bler"] <= hi, (rec["config"], pt)
    for route, rec in serving.items():
        assert rec["equal_to_plain"] and rec["finite"], (route, rec)
        assert rec["plain_launches"] == zero, (route, rec)
    assert warm_rec["copied"] == 121 and warm_rec["kept"] == 0, warm_rec
    assert warm_rec["all_finite"], warm_rec
    assert abs(warm_rec["loss_data_mean"] - JAX_LARGE_WARM_LOSS[0]) < \
        3 * np.hypot(w_se, JAX_LARGE_WARM_LOSS[1]), warm_rec
    con = mc_e2e["constellation"]
    assert con["points"] == 16 and con["max_abs_err"] < 1e-6, con
    return launches, {"large_mc": mc_large["profile"],
                      "e2e_mc": mc_e2e["profile"]}


def main() -> int:
    t_all = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile
    from neural_rx_tpu_torch import weights
    from neural_rx_tpu_torch.channel.apply import apply_ofdm_channel
    from neural_rx_tpu_torch.entry import (entry, eval_entry, eval_example,
                                           load_params, make_receiver,
                                           mc_entry)
    from neural_rx_tpu_torch.kernels import _build, cgnn_iter, sepconv
    from neural_rx_tpu_torch.kernels import ldpc as k5
    from neural_rx_tpu_torch.phy.nr import ldpc, tb
    from neural_rx_tpu_torch.phy.nr.tb import tb_decode
    from neural_rx_tpu_torch.rx.cgnn import count_params
    from neural_rx_tpu_torch.sim.config import Parameters
    from neural_rx_tpu_torch.sim.e2e import E2EModel
    from neural_rx_tpu_torch.sim.simber import sim_ber

    # the plain version is the oracle: full float32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtypes = ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16))

    def counts():
        return {"sepconv_stack": sepconv.launches,
                "cgnn_iter": cgnn_iter.iter_launches,
                "cgnn_full": cgnn_iter.full_launches,
                "ldpc_decode": k5.launches}

    def reset():
        sepconv.launches = 0
        cgnn_iter.iter_launches = 0
        cgnn_iter.full_launches = 0
        k5.launches = 0

    # 1. card
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks": peaks,
          "seconds": time.perf_counter() - t0})

    # 2. build
    t0 = time.perf_counter()
    info = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    # the float32 instances of K1-K4 (the CUDA-core tile): registers, and
    # no spill
    f32_regs = {k: v for k, v in ptxas_entries(ptxas).items()
                if any(f"{kn}If" in k for kn in F32_INSTANCES)}
    emit({"phase": "build", "nvcc_seconds": info.seconds, "ptxas": ptxas,
          "ptxas_f32": f32_regs, "seconds": time.perf_counter() - t0})
    assert len(f32_regs) == 4, sorted(f32_regs)  # K1 normal, folded; K3; K4
    assert all("0 bytes spill stores, 0 bytes spill loads" in ln
               for v in f32_regs.values() for ln in v if "spill" in ln), \
        f32_regs

    # 3. each kernel against its plain version at the nrx_rt widths
    t0 = time.perf_counter()
    params = load_params(device=dev)
    cgnn = params["cgnn"]
    assert count_params(cgnn) == 142922, count_params(cgnn)
    stacks = {"init": cgnn["s_init"][0],
              "update0": cgnn["iterations"][0]["update"],
              "update1": cgnn["iterations"][1]["update"]}
    n, h, w = 2, N_SYM, N_SC
    gen = torch.Generator(device=dev).manual_seed(0)
    checks = []
    for sname, p in stacks.items():
        c_in = p["hidden"][0]["pw"].shape[0]
        x32 = torch.randn((n, h, w, c_in), generator=gen, device=dev)
        for dtype, tol in dtypes:
            x = x32.to(dtype)
            for scv in SC_VALID_CASES:
                got = sepconv.fused_conv_stack(p, x, sc_valid=scv)
                ref = sepconv.sepconv_stack_reference(p, x, sc_valid=scv)
                torch.cuda.synchronize()
                rec = compare((got,), (ref,), dtype, tol)
                if scv is not None:
                    lo, hi = scv
                    rec["ok"] = rec["ok"] and not got[:, :, :lo].any() \
                        and not got[:, :, hi:].any()
                checks.append({"kernel": "sepconv_stack", "stack": sname,
                               "sc_valid": scv, **rec})
                assert rec["ok"], checks[-1]

    rx = make_receiver(device=dev)
    pe32 = rx.pe
    d_s = cgnn["iterations"][0]["agg"]["hidden"][0]["w"].shape[0]
    s32 = 4.0 * torch.randn((1, N_TX, h, w, d_s), generator=gen, device=dev)
    z32 = torch.randn((1, N_TX, h, w, 18), generator=gen, device=dev)
    readouts = (cgnn["readout_llrs"][0], cgnn["readout_chest"])
    for dtype, tol in dtypes:
        s, z0, pe = s32.to(dtype), z32.to(dtype), pe32.to(dtype)
        for scv in SC_VALID_CASES:
            for active in ACTIVE_CASES:
                act = torch.tensor([active], device=dev)
                for mode, it_p, ro in (("state", cgnn["iterations"][0], ()),
                                       ("readout", cgnn["iterations"][1],
                                        readouts)):
                    got = cgnn_iter.fused_iteration(it_p, s, pe, act, scv,
                                                    *ro)
                    ref = cgnn_iter.fused_iteration_reference(
                        it_p, s, pe, act, scv, *ro)
                    torch.cuda.synchronize()
                    got = got if ro else (got,)
                    ref = ref if ro else (ref,)
                    rec = compare(got, ref, dtype, tol)
                    if scv is not None and not ro:
                        lo, hi = scv  # the stack adds nothing there
                        rec["ok"] = rec["ok"] and bool(
                            torch.equal(got[0][:, :, :, hi:], s[:, :, :, hi:])
                            and torch.equal(got[0][:, :, :, :lo],
                                            s[:, :, :, :lo]))
                    checks.append({"kernel": "cgnn_iter", "mode": mode,
                                   "sc_valid": scv, "active": active, **rec})
                    assert rec["ok"], checks[-1]
                got = cgnn_iter.fused_cgnn_full(cgnn, z0, pe, act, scv)
                ref = cgnn_iter.fused_cgnn_full_reference(cgnn, z0, pe, act,
                                                          scv)
                torch.cuda.synchronize()
                rec = compare(got, ref, dtype, tol)
                checks.append({"kernel": "cgnn_full", "sc_valid": scv,
                               "active": active, **rec})
                assert rec["ok"], checks[-1]
    # the readout mode with the LLR readouts of the other nrx_rt MCS
    act = torch.ones((1, N_TX), device=dev)
    for label, bits in (("nrx_rt_qpsk", 2), ("nrx_rt_64qam", 6)):
        cgnn_l = load_params(device=dev,
                             path=weights.ema_weights(label))["cgnn"]
        ro_l = (cgnn_l["readout_llrs"][0], cgnn_l["readout_chest"])
        assert ro_l[0]["out"]["w"].shape[1] == bits
        for dtype, tol in dtypes:
            s, pe = s32.to(dtype), pe32.to(dtype)
            got = cgnn_iter.fused_iteration(cgnn_l["iterations"][1], s, pe,
                                            act, None, *ro_l)
            ref = cgnn_iter.fused_iteration_reference(
                cgnn_l["iterations"][1], s, pe, act, None, *ro_l)
            torch.cuda.synchronize()
            rec = compare(got, ref, dtype, tol)
            rec["ok"] = rec["ok"] and rec["differing_share"] == 0 \
                and got[0].shape[-1] == bits
            checks.append({"kernel": "cgnn_iter", "mode": f"readout_{bits}",
                           "config": label, "sc_valid": None,
                           "active": (1.0, 1.0), **rec})
            assert rec["ok"], checks[-1]
        del cgnn_l, ro_l
    emit({"phase": "kernel_check", "checks": checks,
          "seconds": time.perf_counter() - t0})

    # 4. the LDPC kernel against its plain version: hard bits exactly equal
    t0 = time.perf_counter()
    cfg132 = Parameters("nrx_rt", training=False).pusch_configs[0][0].tb
    cfg4 = Parameters("nrx_rt", training=True).pusch_configs[0][0].tb
    assert (cfg132.bg, cfg132.z, cfg132.num_cbs) == (1, 384, 5)
    assert (cfg4.bg, cfg4.z, cfg4.num_cbs) == (2, 128, 1)
    gen_l = torch.Generator(device=dev).manual_seed(1)

    def tb_case(cfg, n_tb, snr_db):
        """(codewords, decoder LLRs) [n_tb * C, n_full] of random TBs sent
        through the TB chain over a BPSK-equivalent channel at snr_db."""
        bits = torch.randint(0, 2, (n_tb, cfg.tb_size), generator=gen_l,
                             device=dev).float()
        cw = tb.tb_codewords(cfg, bits).reshape(-1, cfg.code.n_full)
        coded = tb.tb_encode(cfg, bits)
        llr = bpsk_llrs(coded, snr_db, gen_l)
        return cw, tb.codeword_llrs(cfg, llr).reshape(-1, cfg.code.n_full)

    def code_case(bg, z, n, snr_db):
        """(codewords, LLRs) of n random codewords of one code, every
        position sent but the punctured first 2Z."""
        code = ldpc.get_code(bg, z)
        info = torch.randint(0, 2, (n, code.k), generator=gen_l,
                             device=dev).float()
        cw = ldpc.encode(code, info)
        llr = -bpsk_llrs(cw, snr_db, gen_l)  # internal log(p0/p1)
        llr[:, :2 * z] = 0.0
        return cw, llr

    cw80, llr80 = tb_case(cfg132, 16, 10.0)
    noiseless = (1.0 - 2.0 * cw80) * 8.0
    noiseless[:, :2 * cfg132.z] = 0.0
    # the receiver's LLRs of user 0 of one Monte-Carlo step: 150 codewords
    p_mc = Parameters("nrx_rt", training=False)
    params_mc = load_params(dtype=p_mc.nrx_dtype, device=dev)
    mc_model = E2EModel(p_mc, device=dev)
    rx_mc = mc_model.receiver
    (bits_mc,), h_mc, noise_mc = mc_model.draw(
        torch.Generator(device=dev).manual_seed(MC_SEED), MC_BATCH,
        MC_EBNO_DB)
    y_mc = apply_ofdm_channel(mc_model.transmitter(bits_mc), h_mc, None,
                              noise=noise_mc)
    llr_mc, _ = rx_mc.serve(params_mc, torch.stack([y_mc.real, y_mc.imag],
                                                   dim=-1))
    cfg_u0 = rx_mc.rg.configs[0].tb
    llr150 = tb.codeword_llrs(cfg_u0, rx_mc.rg.demap_data(llr_mc).reshape(
        MC_BATCH, N_TX, -1)[:, 0]).reshape(-1, cfg_u0.code.n_full)
    cw150 = tb.tb_codewords(cfg_u0, bits_mc[:, 0]).reshape(
        -1, cfg_u0.code.n_full)
    assert llr150.shape[0] == 150
    del h_mc, noise_mc, y_mc, llr_mc
    ldpc_cases = {
        "bg1_z384_10dB": (cfg132.code, cw80, llr80),
        "bg1_z384_1.7dB": (cfg132.code, *tb_case(cfg132, 16, 1.7)),
        "bg1_z384_noiseless": (cfg132.code, cw80, noiseless),
        "bg1_z384_odd7": (cfg132.code, cw80[:7], llr80[:7].contiguous()),
        "bg2_z128_2dB": (cfg4.code, *tb_case(cfg4, 16, 2.0)),
        "bg1_z352_0dB": (ldpc.get_code(1, 352), *code_case(1, 352, 9, 0.0)),
        "bg2_z52_0dB": (ldpc.get_code(2, 52), *code_case(2, 52, 9, 0.0)),
        "bg1_z384_mc_step_150": (cfg_u0.code, cw150, llr150.contiguous())}
    ldpc_checks = []
    for cname, (code, cw, llr) in ldpc_cases.items():
        got = k5.layered_decode(code, llr, LDPC_ITER)
        ref = k5.layered_decode_reference(code, llr, LDPC_ITER)
        torch.cuda.synchronize()
        err = got != cw
        rec = {"case": cname, "bg": code.bg, "z": code.z,
               "codewords": int(llr.shape[0]),
               "differing_bits": int((got != ref).sum()),
               "bit_errors": int(err.sum()),
               "block_errors": int(err.any(dim=1).sum())}
        rec["ok"] = rec["differing_bits"] == 0 and got.shape == cw.shape
        if cname in ("bg1_z384_10dB", "bg1_z384_noiseless",
                     "bg1_z384_odd7"):
            rec["ok"] = rec["ok"] and rec["bit_errors"] == 0
        ldpc_checks.append(rec)
    emit({"phase": "ldpc_check", "num_iter": LDPC_ITER,
          "checks": ldpc_checks, "seconds": time.perf_counter() - t0})
    for rec in ldpc_checks:
        assert rec["ok"], rec

    # 5. main path: entry() at 132 PRB on each of its routes
    t0 = time.perf_counter()
    expected = {"b1": {"sepconv_stack": 3, "cgnn_iter": 0, "cgnn_full": 0,
                       "ldpc_decode": 0},
                "b16": {"sepconv_stack": 1, "cgnn_iter": 2, "cgnn_full": 0,
                        "ldpc_decode": 0},
                "mega_b1": {"sepconv_stack": 0, "cgnn_iter": 0,
                            "cgnn_full": 1, "ldpc_decode": 0},
                "mega_b16": {"sepconv_stack": 0, "cgnn_iter": 0,
                             "cgnn_full": 1, "ldpc_decode": 0}}
    fn, (params, y) = entry(device="cuda")
    fn_mega, _ = entry(device="cuda", mega=True)
    y16 = torch.as_tensor(np.random.default_rng(1).normal(
        size=(16,) + tuple(y.shape[1:])), dtype=torch.float32, device=dev)
    routes = {"b1": (fn, y, False), "b16": (fn, y16, False),
              "mega_b1": (fn_mega, y, True),
              "mega_b16": (fn_mega, y16, True)}
    launches, outs = {}, {}
    for route, (f, yy, _) in routes.items():
        reset()
        outs[route] = f(params, yy)
        torch.cuda.synchronize()
        launches[route] = counts()
        assert launches[route] == expected[route], (route, launches[route])
    reset()
    e2e = {}
    params32 = load_params(dtype=torch.float32, device=dev)
    for route, (f, yy, mega) in routes.items():
        llr, h_hat = outs[route]
        b = yy.shape[0]
        assert llr.shape == (b, N_TX, N_SYM, N_SC, 4), llr.shape
        assert h_hat.shape == (b, N_TX, N_SYM, N_SC, 8), h_hat.shape
        assert bool(torch.isfinite(llr).all() and torch.isfinite(h_hat).all())
        plain = make_receiver(fused_full=mega, kernels=False, device=dev)
        llr_p, h_p = plain.serve(params, yy)
        rx32 = make_receiver(nrx_dtype=torch.float32, fused_full=mega,
                             device=dev)
        rx32p = make_receiver(nrx_dtype=torch.float32, fused_full=mega,
                              kernels=False, device=dev)
        l32, h32 = rx32.serve(params32, yy)
        l32p, h32p = rx32p.serve(params32, yy)
        torch.cuda.synchronize()
        e2e[route] = {
            "bf16": {"llr": rel_err(llr, llr_p), "h_hat": rel_err(h_hat, h_p)},
            "f32": {"llr": rel_err(l32, l32p), "h_hat": rel_err(h32, h32p)}}
        if route != "b1":
            # this route against the stack-kernel-only route, same input
            l1, h1 = rx.serve(params, yy, fused_iteration=False)
            e2e[route]["bf16_vs_stack_route"] = {
                "llr": rel_err(llr, l1), "h_hat": rel_err(h_hat, h1)}
    reset()
    emit({"phase": "main_path", "launches": launches,
          "expected": expected, "rel_err_vs_plain": e2e,
          "tol": {"bf16": TOL_BF16, "f32": TOL_F32},
          "seconds": time.perf_counter() - t0})
    for route, errs in e2e.items():
        for key, tol in (("bf16", TOL_BF16), ("f32", TOL_F32)):
            assert max(errs[key].values()) <= tol, (route, key, errs[key])
    del outs, params32

    # 6. the eval path at 132 PRB, batch 16, float32, with each decoder
    t0 = time.perf_counter()
    p_eval = Parameters("nrx_rt", training=False)
    bits16, y_eval, act16 = eval_example(p_eval, 16, EVAL_EBNO_DB,
                                         device=dev)
    eval_routes = {"eval_fast_b16": True, "eval_flooding_b16": False}
    expected_eval = {
        "eval_fast_b16": {"sepconv_stack": 1, "cgnn_iter": 2,
                          "cgnn_full": 0, "ldpc_decode": 2},
        "eval_flooding_b16": {"sepconv_stack": 1, "cgnn_iter": 2,
                              "cgnn_full": 0, "ldpc_decode": 0}}
    eval_fns, eval_out = {}, {}
    for route, fast in eval_routes.items():
        fn_e, (params_e, y_e, act_e) = eval_entry(
            device="cuda", batch=16, ebno_db=EVAL_EBNO_DB, fast_ldpc=fast)
        assert torch.equal(y_e, y_eval)
        eval_fns[route] = fn_e
        reset()
        eval_out[route] = fn_e(params_e, y_e, act_e)
        torch.cuda.synchronize()
        launches[route] = counts()
    reset()
    rx_eval_plain = make_receiver(nrx_dtype=p_eval.nrx_dtype, kernels=False,
                                  device=dev)
    b_plain, _, _, crc_plain = rx_eval_plain.apply(params_e, y_eval, act16,
                                                   fast_ldpc=True)
    torch.cuda.synchronize()
    assert k5.launches == 0 and counts() == dict.fromkeys(counts(), 0)
    eval_rec = {}
    for route in eval_routes:
        b_hat, crc = eval_out[route]
        wrong = (b_hat != bits16).any(dim=-1)
        eval_rec[route] = {
            "b_hat_shape": list(b_hat.shape),
            "crc_pass": int(crc.sum()), "crc_total": crc.numel(),
            "crc_failed": sorted(map(tuple, (~crc).nonzero().tolist())),
            "crc_truthful": bool(torch.equal(wrong, ~crc)),
            "bit_errors": int((b_hat != bits16).sum())}
    b_fast, crc_fast = eval_out["eval_fast_b16"]
    eval_rec["eval_fast_b16"]["equals_plain_route"] = bool(
        torch.equal(b_fast, b_plain) and torch.equal(crc_fast, crc_plain))
    emit({"phase": "eval_path", "ebno_db": EVAL_EBNO_DB,
          "launches": {r: launches[r] for r in eval_routes},
          "expected": expected_eval, "results": eval_rec,
          "seconds": time.perf_counter() - t0})
    for route in eval_routes:
        b_hat, crc = eval_out[route]
        rec = eval_rec[route]
        assert launches[route] == expected_eval[route], (route,
                                                         launches[route])
        assert b_hat.shape == bits16.shape, route
        assert set(rec["crc_failed"]) == EVAL_FAILS, (route, rec)
        assert rec["crc_truthful"], (route, rec)
    assert eval_rec["eval_fast_b16"]["equals_plain_route"]
    del b_plain, rx_eval_plain

    # 7. the Monte-Carlo BLER evaluation at 132 PRB, batch 30, float32
    t0 = time.perf_counter()
    mc_routes = {"mc_fast_b30": True, "mc_flooding_b30": False}
    expected_mc = {
        "mc_fast_b30": {"sepconv_stack": 1, "cgnn_iter": 2, "cgnn_full": 0,
                        "ldpc_decode": 2},
        "mc_flooding_b30": {"sepconv_stack": 1, "cgnn_iter": 2,
                            "cgnn_full": 0, "ldpc_decode": 0}}
    mc_fns = {}
    for route, fast in mc_routes.items():
        fn_m, (params_m, gen_m) = mc_entry(device="cuda", batch=MC_BATCH,
                                           ebno_db=MC_EBNO_DB,
                                           fast_ldpc=fast, seed=MC_SEED)
        reset()
        step_counts = fn_m(params_m, gen_m)
        torch.cuda.synchronize()
        launches[route] = counts()
        mc_fns[route] = (fn_m, params_m, gen_m)
        assert step_counts[1] == MC_BATCH * N_TX * p_mc.transmitters[
            0].tb_size and step_counts[3] == MC_BATCH * N_TX, step_counts
    reset()

    def run_steps(model, params, fast, steps):
        gen = torch.Generator(device=dev).manual_seed(MC_SEED)
        return [model(params, gen, MC_BATCH, MC_EBNO_DB, fast_ldpc=fast)
                for _ in range(steps)]

    mc_plain = {}
    for label, cases in (("nrx_rt", ((True, 2), (False, 2))),
                         ("nrx_rt_qpsk", ((True, 1),)),
                         ("nrx_rt_64qam", ((True, 1),))):
        p_l = Parameters(label, training=False)
        params_l = load_params(dtype=p_l.nrx_dtype, device=dev,
                               path=weights.ema_weights(label))
        models = [E2EModel(p_l, kernels=k, device=dev) for k in (True, False)]
        for fast, steps in cases:
            got, ref = (run_steps(m, params_l, fast, steps) for m in models)
            torch.cuda.synchronize()
            mc_plain[f"{label}_{'fast' if fast else 'flooding'}"] = {
                "steps": steps,
                "bits_per_symbol": p_l.transmitters[0].num_bits_per_symbol,
                "counters": [block_counts(b, bh) for b, bh, _ in got],
                "counters_plain": [block_counts(b, bh) for b, bh, _ in ref],
                "equals_plain_route": all(
                    torch.equal(x, y) for g, r in zip(got, ref)
                    for x, y in zip(g, r))}
        del models, params_l
    reset()

    sweep = {}
    for decoder, fast, dbs in (("fast", True, MC_SWEEP_DB),
                            ("flooding", False, (MC_EBNO_DB,))):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bers, blers, n_err, n_blk = sim_ber(
            mc_model, params_mc, dbs, MC_BATCH, max_mc_iter=MC_MAX_ITER,
            num_target_block_errors=MC_TARGET_BLOCK_ERRORS, seed=MC_SEED,
            verbose=False, fast_ldpc=fast, return_counts=True)
        wall = time.perf_counter() - t1
        points = [curve_point(*pt, (JAX_CURVE_DB, JAX_CURVE))
                  for pt in zip(dbs, bers, blers, n_err, n_blk)]
        steps = int(n_blk.sum()) // (MC_BATCH * N_TX)
        sweep[decoder] = {"points": points, "steps": steps, "wall_s": wall,
                       "slots_per_s_wall": steps * MC_BATCH / wall}

    # device time of a step, split: draws + transmitter + channel,
    # receiver, decode (both users); host time of a whole step
    gen_t = torch.Generator(device=dev).manual_seed(MC_SEED + 1)
    rg_mc = rx_mc.rg

    def front():
        (b_,), h_, n_ = mc_model.draw(gen_t, MC_BATCH, MC_EBNO_DB)
        return apply_ofdm_channel(mc_model.transmitter(b_), h_, None,
                                  noise=n_)
    y_t = front()
    y_tp = torch.stack([y_t.real, y_t.imag], dim=-1)
    llr_t, _ = rx_mc.serve(params_mc, y_tp)
    mc_times = {"batch": MC_BATCH, "front_ms": cuda_ms(front, 5),
                "receiver_ms": cuda_ms(lambda: rx_mc.serve(params_mc, y_tp),
                                       5)}
    for decoder, route in (("fast", "mc_fast_b30"),
                        ("flooding", "mc_flooding_b30")):
        dec = k5.tb_decode_fast if mc_routes[route] else tb_decode

        def decode_both():
            flat = rg_mc.demap_data(llr_t).reshape(MC_BATCH, N_TX, -1)
            return [dec(cfg.tb, flat[:, ue])
                    for ue, cfg in enumerate(rg_mc.configs)]
        decode_ms = cuda_ms(decode_both, 3, warmup=1)
        step_ms = mc_times["front_ms"] + mc_times["receiver_ms"] + decode_ms
        fn_m, params_m, gen_m = mc_fns[route]
        host_ms = []
        for _ in range(5):
            t1 = time.perf_counter()
            fn_m(params_m, gen_m)
            host_ms.append((time.perf_counter() - t1) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                fn_m(params_m, gen_m)
            torch.cuda.synchronize()
        copies = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA \
                    and "Memcpy" in ev.name:
                copies[ev.name] = copies.get(ev.name, 0) + 0.5
        sw = sweep[decoder]
        mc_times[decoder] = {
            "decode_ms": decode_ms, "device_step_ms": step_ms,
            "slots_per_s_device": MC_BATCH / step_ms * 1e3,
            "step_host_ms_median": float(np.median(host_ms)),
            "sweep_slots_per_s_wall": sw["slots_per_s_wall"],
            "sweep_slots_per_s_device": MC_BATCH / step_ms * 1e3,
            "sweep_host_share": 1.0 - sw["steps"] * step_ms / 1e3
            / sw["wall_s"],
            "copies_per_step": copies}
    del y_t, y_tp, llr_t
    emit({"phase": "mc_path", "batch": MC_BATCH, "ebno_db": MC_EBNO_DB,
          "launches": {r: launches[r] for r in mc_routes},
          "expected": expected_mc, "kernel_vs_plain": mc_plain,
          "sweep": sweep, "times": mc_times, "card": card,
          "seconds": time.perf_counter() - t0})
    for route in mc_routes:
        assert launches[route] == expected_mc[route], (route,
                                                       launches[route])
    for key, rec in mc_plain.items():
        assert rec["equals_plain_route"], (key, rec)
    fast_blers = [pt["bler"] for pt in sweep["fast"]["points"]]
    assert all(a > b for a, b in zip(fast_blers, fast_blers[1:])), \
        fast_blers
    for decoder in sweep:
        for pt in sweep[decoder]["points"]:
            lo, hi = pt["band"]
            assert lo <= pt["bler"] <= hi, (decoder, pt)

    # 8. the classical baselines at 132 PRB, batch 30, with K5
    launches.update(baseline_path(dev, card, counts, reset,
                                  sweep["fast"]["points"]))

    # 9. several MCS at eval: nrx_rt_var_mcs, the masking configuration,
    # K4 at 8 iterations
    var_launches, var_times = var_mcs_path(dev, card, peaks, counts, reset)
    launches.update(var_launches)

    # 10. training: nrx_rt at its training width, e2e_rt, the CLIs, the
    # trained parameters through the eval receiver, covariances on UMi
    launches.update(train_path(dev, card, counts, reset))

    # 11. the deploy engine: every bucket, padded requests, mega, the
    # Aerial test vectors, the export CLI
    deploy_launches, deploy_widths = deploy_path(dev, card, peaks, counts,
                                                 reset)
    launches.update(deploy_launches)

    # 12. the site-specific Dataset channel: eval, baselines, training
    launches.update(site_path(dev, card, counts, reset))

    # 13. several ranks: a one-rank NCCL group, gloo groups of 2 and 4
    # ranks sharing the card; the tooling
    dist_launches, dist_shards = dist_path(dev, card, peaks, counts, reset)
    launches.update(dist_launches)

    # 14. the layer modes: the folded-tap stack and the bf16 stencil of
    # the stack, iteration and whole-CGNN kernels
    mode_launches, mode_times, by_mode = modes_path(dev, card, peaks, counts,
                                                    reset, ptxas)
    launches.update(mode_launches)

    # 15. the last of the JAX package: e2e widths past 128 channels, full
    # 3x3 conv layers, the fused routes' fallbacks
    done_launches, done_times = completion_path(dev, card, peaks, counts,
                                                reset, ptxas)
    launches.update(done_launches)

    # 16. nrx_large and e2e_rt with their committed weights: Monte Carlo,
    # serving, the multiloss warm start
    large_launches, large_profiles = large_path(dev, card, peaks, counts,
                                                reset)
    launches.update(large_launches)

    # 17. times (bf16, as served), at the shapes the main path gives each
    # kernel: stacks at N = 2 (batch 1), the iteration at batch 16, the
    # whole CGNN at batch 1
    t0 = time.perf_counter()
    bf = torch.bfloat16
    per_stack = []
    for sname, p in stacks.items():
        c_in = p["hidden"][0]["pw"].shape[0]
        x = torch.randn((n, h, w, c_in), generator=gen, device=dev).to(bf)
        widths = widths_of(p)
        per_stack.append({
            "stack": sname, "widths": widths, "shape": [n, h, w],
            "kernel_ms": cuda_ms(lambda: sepconv.fused_conv_stack(p, x), 50),
            "plain_ms": cuda_ms(
                lambda: sepconv.sepconv_stack_reference(p, x), 10),
            **bound(*stack_work(widths, n, h, w, 2), peaks)})
        per_stack[-1] = rates(per_stack[-1])
    # the batch-16 route's launch: the init stack on all 32 images
    p_init = stacks["init"]
    x32 = torch.randn((16 * N_TX, h, w, 18), generator=gen,
                      device=dev).to(bf)
    stack_n32 = rates({
        "stack": "init", "widths": widths_of(p_init), "shape": [32, h, w],
        "kernel_ms": cuda_ms(lambda: sepconv.fused_conv_stack(p_init, x32),
                             20),
        "plain_ms": cuda_ms(
            lambda: sepconv.sepconv_stack_reference(p_init, x32), 3),
        **bound(*stack_work(widths_of(p_init), 32, h, w, 2), peaks)})
    del x32
    s16 = (4.0 * torch.randn((16, N_TX, h, w, d_s), generator=gen,
                             device=dev)).to(bf)
    pe = pe32.to(bf)
    act16 = torch.ones((16, N_TX), device=dev)
    it0 = cgnn["iterations"][0]
    iteration = rates({
        "shape": list(s16.shape),
        "kernel_ms": cuda_ms(
            lambda: cgnn_iter.fused_iteration(it0, s16, pe, act16), 5),
        "plain_ms": cuda_ms(lambda: cgnn_iter.fused_iteration_reference(
            it0, s16, pe, act16), 3),
        **bound(*iteration_work(it0, 16, pe.shape[-1], 2), peaks)})
    del s16
    z1 = z32.to(bf)
    act1 = torch.ones((1, N_TX), device=dev)
    full = rates({
        "shape": list(z1.shape),
        "kernel_ms": cuda_ms(
            lambda: cgnn_iter.fused_cgnn_full(cgnn, z1, pe, act1), 20),
        "plain_ms": cuda_ms(lambda: cgnn_iter.fused_cgnn_full_reference(
            cgnn, z1, pe, act1), 5),
        **bound(*full_work(cgnn, 1, pe.shape[-1], 2), peaks)})
    # the mega route's launch at batch 16
    z16 = torch.randn((16, N_TX, h, w, 18), generator=gen,
                      device=dev).to(bf)
    full16 = rates({
        "shape": list(z16.shape),
        "kernel_ms": cuda_ms(
            lambda: cgnn_iter.fused_cgnn_full(cgnn, z16, pe, act16), 5),
        "plain_ms": cuda_ms(lambda: cgnn_iter.fused_cgnn_full_reference(
            cgnn, z16, pe, act16), 2, warmup=1),
        **bound(*full_work(cgnn, 16, pe.shape[-1], 2), peaks)})
    del z16
    paths = {}
    for route, (f, yy, _) in routes.items():
        b = yy.shape[0]
        call_ms = cuda_ms(lambda: f(params, yy), 5 if b > 1 else 20)
        host_ms = []
        for _ in range(10):
            t1 = time.perf_counter()
            f(params, yy)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t1) * 1e3)
        paths[route] = {"batch": b, "call_ms": call_ms,
                        "slot_ms": call_ms / b,
                        "slots_per_s": b / (call_ms / 1e3),
                        "call_host_ms_median": float(np.median(host_ms))}
    # the same batch 16 on the stack-kernel-only route (batch <= 4's)
    call_ms = cuda_ms(lambda: rx.serve(params, y16, fused_iteration=False), 5)
    paths["b16_stack_route"] = {"batch": 16, "call_ms": call_ms,
                                "slot_ms": call_ms / 16,
                                "slots_per_s": 16 / (call_ms / 1e3)}
    # the LDPC kernel at one user's batch-16 load: 16 TBs x 5 code blocks
    code132 = cfg132.code
    ldpc_time = rates({
        "codewords": int(llr80.shape[0]), "bg": 1, "z": code132.z,
        "num_iter": LDPC_ITER,
        "kernel_ms": cuda_ms(
            lambda: k5.layered_decode(code132, llr80, LDPC_ITER), 20),
        "plain_ms": cuda_ms(lambda: k5.layered_decode_reference(
            code132, llr80, LDPC_ITER), 2, warmup=1),
        **bound(*ldpc_work(code132, llr80.shape[0]), peaks,
                rate="f32_flops")})
    # each kernel at the mc path's launch (float32, batch 30): the init
    # stack on 60 images, one iteration, 150 codewords of one user
    cgnn_mc = params_mc["cgnn"]
    x60 = torch.randn((MC_BATCH * N_TX, h, w, 18), generator=gen,
                      device=dev)
    p_init32 = cgnn_mc["s_init"][0]
    mc_kernels = {"sepconv_stack": rates({
        "shape": list(x60.shape),
        "kernel_ms": cuda_ms(lambda: sepconv.fused_conv_stack(p_init32, x60),
                             5),
        "plain_ms": cuda_ms(lambda: sepconv.sepconv_stack_reference(
            p_init32, x60), 2, warmup=1),
        **bound(*stack_work(widths_of(p_init32), MC_BATCH * N_TX, h, w, 4),
                peaks, rate="f32_flops")})}
    del x60
    s30 = 4.0 * torch.randn((MC_BATCH, N_TX, h, w, d_s), generator=gen,
                            device=dev)
    act30 = torch.ones((MC_BATCH, N_TX), device=dev)
    it0_32 = cgnn_mc["iterations"][0]
    mc_kernels["cgnn_iter"] = rates({
        "shape": list(s30.shape),
        "kernel_ms": cuda_ms(lambda: cgnn_iter.fused_iteration(
            it0_32, s30, pe32, act30), 3),
        "plain_ms": cuda_ms(lambda: cgnn_iter.fused_iteration_reference(
            it0_32, s30, pe32, act30), 2, warmup=1),
        **bound(*iteration_work(it0_32, MC_BATCH, pe32.shape[-1], 4), peaks,
                rate="f32_flops")})
    del s30
    # the other float32 instances of the eval path: K3 at the eval batch
    # (16, state mode) and K4 at batch 1 (the fused-full route in float32)
    s16 = 4.0 * torch.randn((16, N_TX, h, w, d_s), generator=gen,
                            device=dev)
    act16_32 = torch.ones((16, N_TX), device=dev)
    mc_kernels["cgnn_iter_b16"] = rates({
        "shape": list(s16.shape),
        "kernel_ms": cuda_ms(lambda: cgnn_iter.fused_iteration(
            it0_32, s16, pe32, act16_32), 3),
        "plain_ms": cuda_ms(lambda: cgnn_iter.fused_iteration_reference(
            it0_32, s16, pe32, act16_32), 2, warmup=1),
        **bound(*iteration_work(it0_32, 16, pe32.shape[-1], 4), peaks,
                rate="f32_flops")})
    del s16
    z1_32 = torch.randn((1, N_TX, h, w, 18), generator=gen, device=dev)
    act1_32 = torch.ones((1, N_TX), device=dev)
    mc_kernels["cgnn_full_b1"] = rates({
        "shape": list(z1_32.shape),
        "kernel_ms": cuda_ms(lambda: cgnn_iter.fused_cgnn_full(
            cgnn_mc, z1_32, pe32, act1_32), 10),
        "plain_ms": cuda_ms(lambda: cgnn_iter.fused_cgnn_full_reference(
            cgnn_mc, z1_32, pe32, act1_32), 2, warmup=1),
        **bound(*full_work(cgnn_mc, 1, pe32.shape[-1], 4), peaks,
                rate="f32_flops")})
    llr150 = llr150.contiguous()
    mc_kernels["ldpc_decode"] = rates({
        "codewords": int(llr150.shape[0]),
        "kernel_ms": cuda_ms(
            lambda: k5.layered_decode(code132, llr150, LDPC_ITER), 10),
        "plain_ms": cuda_ms(lambda: k5.layered_decode_reference(
            code132, llr150, LDPC_ITER), 2, warmup=1),
        **bound(*ldpc_work(code132, llr150.shape[0]), peaks,
                rate="f32_flops")})
    # K5 at the dist path's launch: one rank's 75 codewords of a data-2
    # mesh (batch 15 a rank, 5 code blocks a transport block)
    llr75 = llr150[:75].contiguous()
    dist_ldpc_75 = rates({
        "codewords": 75,
        "kernel_ms": cuda_ms(
            lambda: k5.layered_decode(code132, llr75, LDPC_ITER), 10),
        "plain_ms": cuda_ms(lambda: k5.layered_decode_reference(
            code132, llr75, LDPC_ITER), 2, warmup=1),
        **bound(*ldpc_work(code132, 75), peaks, rate="f32_flops")})
    # K5 at the 1-user baseline path's launch: e2e_baseline's 30 TBs x 6
    # code blocks of BG1, Z = 352 (20 iterations, no early stop, so random
    # LLRs take the time of real ones)
    code352, (_, llr180) = ldpc.get_code(1, 352), code_case(1, 352, 180, 0.0)
    base_ldpc_1ue = rates({
        "codewords": int(llr180.shape[0]),
        "kernel_ms": cuda_ms(
            lambda: k5.layered_decode(code352, llr180, LDPC_ITER), 10),
        "plain_ms": cuda_ms(lambda: k5.layered_decode_reference(
            code352, llr180, LDPC_ITER), 2, warmup=1),
        **bound(*ldpc_work(code352, llr180.shape[0]), peaks,
                rate="f32_flops")})
    # the eval path per decoder, split into receiver and decode
    rx_e = make_receiver(nrx_dtype=p_eval.nrx_dtype, device=dev)
    y_planar = torch.stack([y_eval.real, y_eval.imag], dim=-1)
    llr_e, _ = rx_e.serve(params_e, y_planar)
    rg = rx_e.rg
    eval_times = {"batch": 16,
                  "receiver_ms": cuda_ms(
                      lambda: rx_e.serve(params_e, y_planar), 5)}
    for route, fast in eval_routes.items():
        dec = (k5.tb_decode_fast if fast else tb_decode)

        def decode_both():
            flat = rg.demap_data(llr_e).reshape(16, N_TX, -1)
            return [dec(cfg.tb, flat[:, ue])
                    for ue, cfg in enumerate(rg.configs)]
        f_e = eval_fns[route]
        call_ms = cuda_ms(lambda: f_e(params_e, y_eval, act16), 3, warmup=1)
        eval_times[route] = {
            "call_ms": call_ms, "slot_ms": call_ms / 16,
            "slots_per_s": 16 / (call_ms / 1e3),
            "decode_ms": cuda_ms(decode_both, 3, warmup=1)}
    emit({"phase": "times", "card": card, "per_stack": per_stack,
          "sepconv_init_n32": stack_n32, "cgnn_iter": iteration,
          "cgnn_full": full,
          "cgnn_full_b16": full16, "paths": paths,
          "ldpc_decode": ldpc_time, "eval_path": eval_times,
          "mc_path_kernels": mc_kernels,
          "baseline_path_ldpc_1ue": base_ldpc_1ue,
          "dist_path_ldpc_75": dist_ldpc_75,
          "seconds": time.perf_counter() - t0})

    def max_abs(kernel):
        return max(c["max_abs_err"] for c in checks
                   if c["kernel"] == kernel and c["dtype"] == str(bf))

    def total(kernel):
        return sum(launches[r][kernel] for r in launches)

    def mc_keys(kernel):
        rec = mc_kernels[kernel]
        return {"ms_mc": rec["kernel_ms"], "plain_ms_mc": rec["plain_ms"],
                "bound_ms_mc": rec["bound_ms"]}

    def width_keys(kernel):
        """The deploy path's launch at the smallest and largest bucket's
        width (bf16, batch 1)."""
        out = {}
        for w, recs in deploy_widths.items():
            rec = recs[kernel]
            out.update({f"ms_w{w}": rec["kernel_ms"],
                        f"plain_ms_w{w}": rec["plain_ms"],
                        f"bound_ms_w{w}": rec["bound_ms"],
                        f"pct_of_bound_w{w}": rec["pct_of_bound"]})
        return out

    def shard_keys(kernel):
        """The dist path's launch on the extended shard of 2 and 4 ranks
        (bf16, batch 1)."""
        out = {}
        for n, recs in dist_shards.items():
            rec = recs[kernel]
            out.update({f"ms_shard{n}": rec["kernel_ms"],
                        f"plain_ms_shard{n}": rec["plain_ms"],
                        f"bound_ms_shard{n}": rec["bound_ms"],
                        f"pct_of_bound_shard{n}": rec["pct_of_bound"]})
        return out

    def mode_keys(kernel):
        """The modes path's launches by mode and each mode's times beside
        the normal mode's from the same turns (bf16; K1: the three stacks
        of a batch-1 slot, N = 2, and the init stack at N = 32, folded also
        in float32 at N = 60; K3 at batch 16; K4 at batch 1)."""
        out = {"launches_by_mode": {
            m: sum(by_mode[r][kernel][m] for r in by_mode)
            for m in by_mode["b16_lp"][kernel]}}
        if kernel == "sepconv_stack":
            for m in ("mxu", "lp"):
                t = mode_times[f"k1_{m}"]
                out.update({f"launches_{m}": out["launches_by_mode"][m],
                            f"ms_{m}": t["slot_ms"],
                            f"ms_normal_vs_{m}": t["slot_normal_ms"],
                            f"plain_ms_{m}": t["slot_plain_ms"],
                            f"bound_ms_{m}": t["slot_bound_ms"],
                            f"ms_{m}_n32": t["n32"]["kernel_ms"],
                            f"ms_normal_vs_{m}_n32": t["n32"]["normal_ms"],
                            f"bound_ms_{m}_n32": t["n32"]["bound_ms"]})
            t = mode_times["k1_mxu_f32_n60"]
            out.update({"ms_mxu_f32_n60": t["kernel_ms"],
                        "ms_normal_vs_mxu_f32_n60": t["normal_ms"],
                        "plain_ms_mxu_f32_n60": t["plain_ms"],
                        "bound_ms_mxu_f32_n60": t["bound_ms"]})
            return out
        t = mode_times["k3_lp_b16" if kernel == "cgnn_iter" else "k4_lp_b1"]
        out.update({"launches_lp": out["launches_by_mode"]["lp"],
                    "ms_lp": t["kernel_ms"], "ms_normal_vs_lp": t["normal_ms"],
                    "plain_ms_lp": t["plain_ms"], "bound_ms_lp": t["bound_ms"]})
        return out

    def e2e_keys(kernel):
        """The completion path's launches past 128 input channels (e2e_rt,
        132 PRB, seed-made parameters; K4 also e2e_large's 8 iterations),
        bf16 and float32."""
        out = {}
        for n in {"sepconv_stack": ("k1_130_n2",),
                  "cgnn_iter": ("k3_e2e_b16",),
                  "cgnn_full": ("k4_e2e_b1", "k4_e2e_large_8it_b1")}[kernel]:
            for dt in ("bf16", "f32"):
                rec = done_times.get(f"{n}_{dt}")
                if rec is not None:
                    out.update({f"ms_{n}_{dt}": rec["kernel_ms"],
                                f"plain_ms_{n}_{dt}": rec["plain_ms"],
                                f"bound_ms_{n}_{dt}": rec["bound_ms"],
                                f"pct_of_bound_{n}_{dt}":
                                    rec["pct_of_bound"]})
        return out

    def large_keys(kernel):
        """The large path's Monte-Carlo steps (float32, committed weights,
        profiler): nrx_large at batch 30, e2e_rt at batch 20; the kernel's
        ms and launches a step, and their bound."""
        out = {}
        for n, prof in large_profiles.items():
            rec = prof["by_kernel"].get(kernel)
            if rec is not None:
                out.update({f"ms_step_{n}": rec["ms"],
                            f"launches_step_{n}": rec["launches"],
                            f"bound_ms_step_{n}": rec.get("bound_ms")})
        return out

    st_bytes = sum(s["bytes_ms"] for s in per_stack)
    st_ops = sum(s["ops_ms"] for s in per_stack)
    by_path = {k: {r: launches[r][k] for r in launches} for k in
               ("sepconv_stack", "cgnn_iter", "cgnn_full", "ldpc_decode")}
    emit({"kernels": [
        {"name": "sepconv_stack", "route": "cuda",
         "source": "neural_rx_tpu_torch/csrc/sepconv_stack.cu",
         "replaces": "neural_rx_tpu/kernels/sepconv_pallas.py:362",
         "replaces_k": "K1/K2 (fused_conv_stack :243, "
                       "fused_conv_stack_blocked :362)",
         "launches": total("sepconv_stack"),
         "launches_by_path": by_path["sepconv_stack"],
         "max_abs_err": max_abs("sepconv_stack"), "tol": TOL_BF16,
         "ms": sum(s["kernel_ms"] for s in per_stack),
         "plain_ms": sum(s["plain_ms"] for s in per_stack),
         "bound_ms": sum(s["bound_ms"] for s in per_stack),
         "bound_by": "bytes" if st_bytes >= st_ops else "operations",
         "library_ms": None, "ms_n32": stack_n32["kernel_ms"],
         "plain_ms_n32": stack_n32["plain_ms"],
         "bound_ms_n32": stack_n32["bound_ms"],
         **mc_keys("sepconv_stack"), **width_keys("sepconv_stack"),
         **shard_keys("sepconv_stack"), **mode_keys("sepconv_stack"),
         **e2e_keys("sepconv_stack"), **large_keys("sepconv_stack"),
         "note": "ms/plain_ms/bound_ms: sum over the 3 launches of one "
                 "batch-1 slot (init, update0, update1), bf16, N=2, "
                 "14x1584; *_n32: the batch-16 route's launch (init stack, "
                 "N=32); *_mc: the mc path's launch (init stack, float32, "
                 "N=60); *_w48, *_w3276: the deploy engine's init stack at "
                 "the 4- and 273-PRB buckets (bf16, N=2); *_shard2, "
                 "*_shard4: the dist path's launch on the extended shard "
                 "of 2 and 4 ranks (798 and 402 columns, bf16, N=2); "
                 "*_mxu, *_lp: the folded-tap and bf16-stencil modes over "
                 "the same slot (and *_n32, f32_n60) beside the normal "
                 "mode's time from the same turns (ms_normal_vs_*), "
                 "launches_by_mode from the modes path's routes; "
                 "*_k1_130_n2_*: e2e_rt's 130-channel update stack (N=2, "
                 "bf16 and float32; the wide instance in bf16); "
                 "*_step_large_mc, *_step_e2e_mc: the kernel's ms and "
                 "launches a Monte-Carlo step (profiler) of nrx_large "
                 "(batch 30) and e2e_rt (batch 20) with their committed "
                 "weights, float32, and their bound; "
                 "library: no PyTorch call computes a separable stack"},
        {"name": "cgnn_iter", "route": "cuda",
         "source": "neural_rx_tpu_torch/csrc/cgnn_iter.cu",
         "replaces": "neural_rx_tpu/kernels/cgnn_iter_pallas.py:532",
         "replaces_k": "K3 (fused_iteration :532, _iter_kernel :46)",
         "launches": total("cgnn_iter"),
         "launches_by_path": by_path["cgnn_iter"],
         "max_abs_err": max_abs("cgnn_iter"), "tol": TOL_BF16,
         "ms": iteration["kernel_ms"], "plain_ms": iteration["plain_ms"],
         "bound_ms": iteration["bound_ms"],
         "bound_by": iteration["bound_by"], "library_ms": None,
         **mc_keys("cgnn_iter"), **width_keys("cgnn_iter"),
         **shard_keys("cgnn_iter"), **mode_keys("cgnn_iter"),
         **e2e_keys("cgnn_iter"), **large_keys("cgnn_iter"),
         "note": "one launch in state mode at batch 16 (b=16, T=2, "
                 "14x1584), bf16; *_mc: the mc path's launch (float32, "
                 "b=30); *_w48, *_w3276: the deploy engine's launch at the "
                 "4- and 273-PRB buckets (bf16, b=1, state mode); "
                 "*_shard2, *_shard4: the dist path's launch on the "
                 "extended shard of 2 and 4 ranks (798 and 402 columns, "
                 "bf16, b=1, state mode); *_lp: the bf16-stencil mode "
                 "at batch 16 beside the normal mode's time from the same "
                 "turns; *_k3_e2e_b16_*: e2e_rt's iteration (130-channel "
                 "update stack) at batch 16, state mode, bf16 and float32; "
                 "*_step_large_mc, *_step_e2e_mc: the 8 (nrx_large, batch "
                 "30) and 4 (e2e_rt, batch 20) launches of a Monte-Carlo "
                 "step with the committed weights, float32, summed "
                 "(profiler), and their bound; "
                 "library: no PyTorch call "
                 "computes the aggregation MLP, user sum and separable "
                 "stack"},
        {"name": "cgnn_full", "route": "cuda",
         "source": "neural_rx_tpu_torch/csrc/cgnn_iter.cu",
         "replaces": "neural_rx_tpu/kernels/cgnn_iter_pallas.py:494",
         "replaces_k": "K4 (fused_cgnn_full :494, _full_kernel :316)",
         "launches": total("cgnn_full"),
         "launches_by_path": by_path["cgnn_full"],
         "max_abs_err": max_abs("cgnn_full"), "tol": TOL_BF16,
         "ms": full["kernel_ms"], "plain_ms": full["plain_ms"],
         "bound_ms": full["bound_ms"], "bound_by": full["bound_by"],
         "library_ms": None, "ms_b16": full16["kernel_ms"],
         "plain_ms_b16": full16["plain_ms"],
         "bound_ms_b16": full16["bound_ms"],
         "ms_8it": var_times["k4_8it"]["kernel_ms"],
         "plain_ms_8it": var_times["k4_8it"]["plain_ms"],
         "bound_ms_8it": var_times["k4_8it"]["bound_ms"],
         **mode_keys("cgnn_full"), **e2e_keys("cgnn_full"),
         "note": "ms/plain_ms/bound_ms: one launch at batch 1 (b=1, T=2, "
                 "14x1584), bf16; *_b16: the mega route's launch at batch "
                 "16; *_8it: batch 1 with 8 seed-made iterations of "
                 "nrx_large's widths; *_lp: the bf16-stencil mode at "
                 "batch 1 beside the normal mode's time from the same "
                 "turns; *_k4_e2e_b1_*: e2e_rt (4 iterations, 130-channel "
                 "update stacks) at batch 1, bf16 and float32; "
                 "*_k4_e2e_large_8it_b1_bf16: e2e_large's 8 iterations; "
                 "library: no PyTorch call computes "
                 "the whole CGNN"},
        {"name": "ldpc_decode", "route": "cuda",
         "source": "neural_rx_tpu_torch/csrc/ldpc_decode.cu",
         "replaces": "neural_rx_tpu/kernels/ldpc_pallas.py:81",
         "replaces_k": "K5 (make_decoder :81, kernel :133, pallas_call "
                       ":189)",
         "launches": total("ldpc_decode"),
         "launches_by_path": by_path["ldpc_decode"],
         "max_abs_err": max(float(c["differing_bits"] > 0)
                            for c in ldpc_checks), "tol": 0.0,
         "ms": ldpc_time["kernel_ms"], "plain_ms": ldpc_time["plain_ms"],
         "bound_ms": ldpc_time["bound_ms"],
         "bound_by": ldpc_time["bound_by"], "library_ms": None,
         **mc_keys("ldpc_decode"), **large_keys("ldpc_decode"),
         "ms_base_1ue": base_ldpc_1ue["kernel_ms"],
         "plain_ms_base_1ue": base_ldpc_1ue["plain_ms"],
         "bound_ms_base_1ue": base_ldpc_1ue["bound_ms"],
         "ms_dist_75": dist_ldpc_75["kernel_ms"],
         "plain_ms_dist_75": dist_ldpc_75["plain_ms"],
         "bound_ms_dist_75": dist_ldpc_75["bound_ms"],
         "ms_var_qpsk": var_times["k5_qpsk"]["kernel_ms"],
         "plain_ms_var_qpsk": var_times["k5_qpsk"]["plain_ms"],
         "bound_ms_var_qpsk": var_times["k5_qpsk"]["bound_ms"],
         "note": "ms/plain_ms/bound_ms: one launch of 80 codewords (one "
                 "user of a batch-16 slot: 16 TBs x 5 code blocks), BG1, "
                 "Z=384; *_mc: 150 codewords (one user of a batch-30 "
                 "Monte-Carlo step, also each user's launch on the 2-user "
                 "baseline path); *_base_1ue: 180 codewords of BG1, Z=352 "
                 "(the 1-user baseline path's launch, e2e_baseline); "
                 "*_dist_75: 75 codewords (a rank's launch on a data-2 "
                 "mesh, batch 15); "
                 "*_var_qpsk: one user's MCS-9 (QPSK) codewords of a "
                 "batch-30 nrx_rt_var_mcs step; *_step_large_mc, "
                 "*_step_e2e_mc: the launches of a Monte-Carlo step of "
                 "nrx_large (2 x 150 codewords) and e2e_rt (1 user, batch "
                 "20), summed (profiler); 20 iterations, float32; "
                 "max_abs_err on hard bits "
                 "(0 or 1); bound: 10 f32 operations per edge, lane and "
                 "iteration at the card's f32 rate, LLRs read and bits "
                 "written once; library: no PyTorch call decodes LDPC"}]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_all})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
