#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure ends the run with a non-zero exit:
  1. device   a CUDA device is required (no CPU path); its name and
              `nvidia-smi` name/power limit and maximum SM clock
  2. build    nvcc builds the four kernels from csrc/ (sm_90a), one nvcc per
              source, all at once; each kernel's registers, shared memory
              and spills as `-Xptxas -v` reports them
  3. kernels  each kernel against its plain PyTorch version on the card, on
              the same inputs, at every shape the paths give it: FAST on
              uint8 and float32 frames and a pyramid level; patches for ORB,
              BRISK, FREAK, AKAZE and a pyramid level; Hamming at 8 and 16 words and at
              8192x8192; the window gather's five cases; then the edge cases
              of torch_edge_cases.py (Hamming ties at tile and block
              boundaries, ragged and tiny train sets; FAST at ragged sizes,
              constant images, plateaus, a checkerboard; patches at odd
              widths, planes at an element offset, K from 1 to 513, ps from
              1 to 33, keypoints at the edges and on .5; windows leaving the
              image, xs at every residue mod 4, ragged K). Exact equality
  4. parity   keyframe_step on CUDA vs on the CPU from the same state: the
              default ORB slice for 4 synthetic keyframes, then BRISK, FREAK,
              AKAZE, the 3-level ORB pyramid and SIFT for 2 each (640x480,
              K=512, W=10): every int and bool field equal
  5. main     each path driven once with the launch counts set to 0 just
              before and read just after (every phase counts kernels run,
              ops/cuda_kernels.runs(): stream launches plus the kernels of
              the Frontend's step-graph replays, so a Frontend keyframe
              counts as many whether eager or replayed): the port's CLI on synthetic:20
              (ORB) and on synthetic:8 with --descriptor_family brisk, freak,
              akaze and sift (SIFT: B1 and B2, no Hamming kernel); the ORB
              pyramid through Frontend on 8 frames; the
              window-gather entry point (ops/kernel_variants) at the TPU
              probe's shapes. Each frontend run is checked against the CPU
              run of the same input; then one steady-state step per
              configuration under sync-debug mode "error"
  6. timing   median keyframe step time (synced, and host enqueue) per
              configuration with one profiled step's launches and device
              time (torch.profiler), and each kernel at each shape: its
              device time per launch (utils/cuda_timing.device_ms: 50
              launches in one CUDA graph, replayed behind a stream spin so
              the host cannot starve the window, median of 5), beside its
              plain version and one PyTorch call that computes the same
              function where there is one (timed the same way), its cost per
              call (CUDA events around one call), and its bound; at each
              kernel's main shape, torch.profiler's kernel durations as a
              cross-check ("not measured" where the profiler recorded no
              device trace: the CUDA-event times are the figures of
              record, and a missing trace fails nothing); the Hamming window shape's +-1 int8 product
              alone through torch._int_mm (product_ms, a yardstick); and the
              launch floor, a 1-element fill timed the same way
  7. ba       the bundle-adjustment backend (plain torch, no kernel of its
              own; TF32 off, printed): (a) synthetic_ba_problem(P=64,
              L=4096) on the CPU and on the card under dense and PCG, final
              cost, poses and landmarks within the stated tolerances and
              equal accepted steps, LM accept/reject flips reported (dense
              must have none); (b) the benchmark shape (P=500, L=100k,
              N=500k, clean) with tests/test_ba_scale_accuracy.py's settings,
              dense then pcg_chunked (the single-program PCG) at 32 CG
              iterations, held to that test's ATE checks, dense also to the
              JAX package's CPU run (all 25 iterations, iterations 4 to 6
              rejected, cost within 1%; backend/dense_plateau's rule), with
              LM it/s, the
              median iteration split into linearize / solve / cost, enqueue
              against synced time, launches per iteration (torch.profiler),
              peak memory, and one linearize + solve per solver under
              sync-debug "error", and the dense assembly's time and its
              stages (terms, placement, gathers, products, scatter; the staged
              S bit-equal to the assembly's) beside the former float32
              coupling's recorded time; (c) the first two dense iterations
              twice, bit-equal; (d) one iteration at L=500k, N=2.5M under
              dense and PCG: time and peak memory, the assembly as in (b); (e) the slam_backend CLI on phase
              5's synthetic:20 npz on the card and on the CPU: the same keys,
              shapes and dtypes, the cost histories entry by entry within
              2e-3 and of equal length, or one longer by one
              where the runs part at the LM stop rule (one run stops on a
              relative decrease below 1e-6, the other's decrease there below
              10 times that and nothing gained after), poses and
              landmarks within (a)'s tolerances;
              (f) the first dense LM step at the benchmark shape (lambda
              1e-3) in float32 and with every tensor in float64, on the card:
              the relative difference of the step and of the cost after it
  8. local_ba windowed local BA (plain torch; its path runs the frontend's
              kernels): (a) the CLI on synthetic:20 with --local_ba 8 on the
              card (launch counts from that run) and on the CPU: the same
              keyframes and int fields, each local solve's accept/reject
              decisions compared (flips counted and bounded), final poses
              within one tolerance with or without flips, the final cost of
              each solve without flips within its own; (b) a soak, the CLI
              on synthetic:30 with --local_ba 8 in a process of its own
              (640x480, K=512, W=10; every keyframe textured): the first
              keyframe's local-BA host time apart from the median, steady
              frames/s and keyframes/s, frame latency percentiles, peak RSS
              (sampled after each frame) and device memory, beside a
              15-frame soak's (their growth), and the RSS of a fresh process
              stage by stage; then the window ending at keyframe 20 solved
              again: synced and enqueue ms (median of 5), launches and
              device ms under torch.profiler;
              (c) one steady pipelined dispatch under sync-debug "error";
              (d) slam_merge of two overlapping sessions made with the CLI,
              on the card and on the CPU: the same keys, shapes and dtypes,
              poses and landmarks within phase 7 (a)'s tolerances
  9. golden   (a) tests/test_golden_loop.py on the card for all five
              families: its 215 frames (512x384, seed 5, odometry drift
              0.02, texture noise 2) rendered once, Frontend (K=256, W=8)
              then build_ba_problem and BA (15 iterations, trim 8), every
              assertion of TestGoldenLoop against a copy of FAMILY_GOLDEN,
              each family's readings beside its pins; (b) the CLI on the
              card: --checkpoint_every then --resume, and --interrupt_after
              (exit 130, partial problem and checkpoint) then --resume, each
              against the uninterrupted run; (c) --validate for ORB and SIFT,
              equal to phase 5's unvalidated runs
 10. inputs   the real inputs: (a) the JPEG decode route taken, which must
              be CARD_DECODE_ROUTE (the card's probe), the native library's
              build (or why it is unavailable) and one 640x480 pair's host
              decode ms; (b) tests/test_golden_bag.py on the card: the port
              writes the degraded bag (100 frames, 512x384, JPEG quality 88,
              seed 9, odometry drift 0.02) and saves its config, the CLI runs
              it with --config for all five families, then tracks and BA
              (15 iterations, trim 8), every assertion against a copy of
              FAMILY_GOLDEN, readings beside pins with the CLI and BA
              seconds; the ORB run's launches, and its int and bool fields
              and track ids equal to a CPU run over the first 20 keyframes;
              (c) the end-to-end bag rate: the CLI on a 150-frame 640x480
              degraded bag (K=512, W=10) in a process of its own, a warm-up
              run, then with and without the decode-ahead thread in turns:
              frames/s, latency percentiles, peak RSS and device memory,
              host decode ms per pair; (d) tests/test_io.py's 5-frame KITTI
              (with --output_bag, read back, --ply and --html) and EuRoC
              inputs, card against CPU, and bag_extract; (e) the 6x5
              survival matrix of tests/test_adversarial_conditions.py on the
              card, against a copy of its CONDITIONS
 11. parallel the parallel/ package (plain torch, no kernel): (a) segment BA
              on tests/test_segment_ba.py's fixture (P=128, L=2048, n_seg 4,
              sweeps 4) on the card and on the CPU: final cost, poses, a
              monotone history, within 2% of the joint optimize; (b) segments
              at the BA benchmark shape (phase 7's P=500, L=100k, clean; n_seg
              8, sweeps 2, polish 3): cost and ATE beside phase 7's, held to
              tests/test_ba_scale_accuracy.py's ATE check, seconds per sweep,
              one level-A iteration's synced and enqueue ms, launches and
              device ms, peak memory, and whether a segment's LM met four
              rejections in a row; (c) past the dense ceiling (P=4096,
              L=100k, drifting): segments against the joint solve under auto
              (PCG), held to tests/test_segment_ba.py's two checks; (d) on the
              one card: two processes over gloo with CUDA tensors on cuda:0
              and a world-size-1 NCCL group, each running observation-sharded
              PCG, landmark-sharded dense and sharded segments on phase 7
              (a)'s problem, held to the single-process runs, each mode's
              collective calls and bytes per LM iteration equal to
              comm_report's analytic count, and `slam_backend --devices 2`
              refused ("needs 2 CUDA devices, found 1"); (e) the slam_backend
              CLI with --schur_solver segments on phase 5's synthetic:20 npz,
              card against CPU
 12. tools    (a) the CLI on synthetic:20 with --visualize --save_debug on
              the card (launch counts from that run) and on the CPU: the
              same PNG names, each image at least 99.9% pixel-equal, the
              live pages' deltas equal (node ids, edges; poses within 2e-4,
              landmarks within 2e-3), the npz equal to phase 5's plain run
              and the kernel launches equal to its, and
              the host draw and PNG ms per keyframe of a Frontend with debug
              images on the card; (b) the CLI on phase 10 (c)'s bag in a
              process of its own, a warm-up, then without and with
              --visualize --save_debug: frames/s, latency, peak RSS (with
              them within 10% of without) and images written; (c) profile_stages on the card
              (640x480, K=512, W=10): all 12 stages positive, the step's
              synced and enqueue ms, its --trace_dir trace holding the three
              frontend kernels ("not measured" where the trace has no device
              kernel), and slam_frontend --profile_dir writing a trace; (d)
              one ORB keyframe_step under utils/checks.checkified: no error
              and the plain step's int and bool fields, a NaN pose naming an
              aten op, an out-of-range gather raising no device assert (a
              plain step after it still matches), checked against plain
              seconds; (e) backend/dense_plateau.coupling_trial (ROADMAP C:
              the coupling's ablations, the compensated products without the
              placement and the former float32 coupling) beside phase 7's
              dense run, then placement_trial (the solver, whose coupling
              places repeated (landmark, pose) slots in bf16 as the reference
              does) and schedule_trial (one dense step of the former float32
              coupling at each lambda from 1e-9 to 1e4 at its stop), each
              beside ROADMAP C's CPU figures (a record: nothing new is held)
 13. api      the reference's two-step API and switches at full width
              (640x480, K=512, ORB, one synthetic frame; 448 FAST or random
              keypoints, every 17th invalid, and 64 keypoints 3-14 px from
              the edges), card against CPU on the same inputs:
              compute_orientations (angles within API_THETA_ATOL, bins
              equal), brief_describe under "gather", "mxu" and "auto" (words
              equal), brief.extract_patches at (H, W) and (H, W, 3) (exact),
              fast_detect(nms=False) and ORB detect_and_describe(nms=False)
              (int and bool fields equal, float differences printed); the
              launch counts of each call on the card, held to API_LAUNCHES
Then a JSON line of every kernel shape's numbers and the BA, local-BA,
golden-loop, input, parallel, tools and api numbers, the kernels JSON line and,
last, the result line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

NUM_PARITY_KEYFRAMES = 4
NUM_FAMILY_PARITY_KEYFRAMES = 2
MAIN_INPUT = "synthetic:20"
FAMILY_INPUT = "synthetic:8"
FAMILY_FRAMES = 8
TIMING_KEYFRAMES = 20

# Phase 7 (BA): the small CPU/CUDA comparison, the benchmark shape with
# tests/test_ba_scale_accuracy.py's settings and checks, and the largest shape.
BA_SMALL = dict(P=64, L=4096)
BA_SMALL_ITERATIONS = 25
BA_SCALE = (500, 100_000, 5)
BA_BIG = (500, 500_000, 5)
BA_ITERATIONS = 25
BA_CG_ITERATIONS = 32
BA_ATE_MAX = {"dense": 0.040, "pcg": 0.045}
BA_ATE_GAP = 0.008
BA_MIN_ACCEPTED = 5
# CPU against CUDA, the same problem and solver settings: final cost
# (relative), poses (m) and landmarks (m). On the CPU a 1-ulp change of the
# small problem's landmarks moves its dense result by 2e-3 m (poses) and
# 0.06 m (landmarks). Its PCG runs (monocular, float32 CG at small damping)
# take other accept/reject decisions after such a change and follow other LM
# paths: after 25 iterations their final costs agree within 3e-4 (poses
# within 0.05 m, landmarks along weak rays within 14 m). Where the card's and
# the CPU's decisions differ, the flips are reported and the final cost is
# held to BA_FLIP_COST_RTOL; dense must have no flips.
BA_COST_RTOL = 1e-3
BA_POSE_ATOL = 1e-2
BA_LM_ATOL = 0.1
BA_FLIP_COST_RTOL = 5e-3
BA_REPS = 5
# A round of ba.optimize stops after an accepted step whose relative decrease
# is below LM_STOP_REL, or at its iteration limit. Phase 7 (e) holds the
# card's and the CPU's cost histories to equal lengths, or to one more entry
# on one side where the two runs part at that rule: one run stops on it, the
# other's decrease there below LM_STOP_FACTOR times it (float32 rounding at
# the convergence tail) and nothing gained after.
LM_STOP_REL = 1e-6
LM_STOP_FACTOR = 10.0
# Over the two histories' common length, the entries' relative difference
# (tests/test_torch_backend_cli.py's HISTORY_RTOL: the port's CPU run against
# the JAX package's parts by up to 5.7e-4 mid-descent and meets it again).
BA_HISTORY_RTOL = 2e-3
# The dense Schur assembly's synced ms with the former float32 coupling (one
# product per pair of observation slots) on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md section 5): (b) and (d) print them beside this run's.
BA_ASSEMBLY_MS_FLOAT32 = {"scale": 9.22, "big": 85.25}
# The JAX package's first dense step at the benchmark shape, on the CPU: the
# cost after it is 3.2% off the float64 step's (ROADMAP C; no jax on the card's
# machine, so a CPU figure).
BA_REFERENCE_STEP_COST_REL = 0.032

# Phase 8 (local BA): the CLI's window, the soak's lengths and the merged
# sessions. Card against CPU on synthetic:20: float32 PCG at small damping
# takes other accept/reject decisions after a 1-ulp change. On an H100, 7 of
# 96 decisions flipped, the final poses were 3.5e-5 m apart and the solves
# without flips ended within 1.4e-5 of each other's cost (the log's 4
# decimals on a cost of 7); with the card's solve disabled, 86 decisions
# flipped and the poses were 1.9e-2 m apart. The final poses are held to
# LBA_POSE_ATOL (m) with or without flips, at most LBA_MAX_FLIPS of the
# decisions may flip, and each solve whose decisions all agree has its final
# cost within LBA_COST_RTOL of the CPU's.
LBA_WINDOW = 8
LBA_POSE_ATOL = 1e-3
LBA_MAX_FLIPS = 0.25
LBA_COST_RTOL = 1e-4
# The soak: every frame a keyframe (synthetic steps of 0.25 m), at two lengths
# inside the textured stretch of the synthetic world, whose ground texture
# thins out: from keyframe 29 on fewer than 100 features survive, and past
# about 70 none. The solve is timed on the window that ends at keyframe
# LBA_TIMING_KEYFRAMES.
LBA_SOAK_FRAMES = (15, 30)
LBA_TEXTURED_FEATURES = 100
LBA_TIMING_KEYFRAMES = 20
MERGE_SESSION_B = "synthetic:12:0.3"

# Phase 11 (parallel). (a) tests/test_segment_ba.py's fixture and checks: the
# card's run against the CPU's (its unsharded-vs-sharded tolerances, cost and
# poses) and the joint optimum (2%). (b) segments at phase 7's benchmark shape
# (monocular): finite, monotone and below the initial cost, its ATE reported
# beside tests/test_ba_scale_accuracy.py's PCG limit and beside the JAX
# package's own segment solver on this problem, which misses that limit too
# (SEG_SCALE_REFERENCE, `python torch_segment_cases.py benchmark 500 100000 jax`
# on the CPU; no jax on the card's machine; ROADMAP C). (c) that test's
# beyond-the-ceiling trajectory at P=4096: finite, monotone and below 0.01 of
# the initial cost (its first check); its second, below twice the ground
# truth's cost, reported (missed at this size: ROADMAP C). (d) the distributed modes on
# phase 7 (a)'s problem over two processes: each mode's final cost within
# DIST_PCG_RTOL (PCG) or DIST_SEG_RTOL (dense, segments) of the same mode run
# in one process on a 2-shard in-process group, whose per-shard partials are
# the ranks'; dense also within phase 7 (a)'s tolerances of the single-device
# dense solve. PCG and segments are not held to the single-device solve here:
# this problem is monocular, and float32 PCG at lambda 1e-3 on it is off the
# float64 step by 100% after 32 CG iterations, so a reduction order moves the
# LM path anywhere (on the CPU a 2-shard PCG run stopped at cost 1,421 after
# four rejections where the single-device run reached 866); their
# single-device costs are printed beside. Segments run without the PCG
# polish there (the PCG mode runs that solve): level A's dense steps and level
# B. The world-size-1 NCCL group: equal to a one-shard in-process group. The
# dense mode is printed beside the JAX package's landmark-sharded dense solve
# of the same problem on a 2-device CPU mesh (DIST_DENSE_REFERENCE,
# `python torch_segment_cases.py sharded 64 4096 jax`; no jax on the card's
# machine).
SEG_WORLD = dict(P=128, L=2048, obs_per_lm=5, seed=3, stereo=True, pose_noise=0.08)
SEG_ITERATIONS = 12
SEG_COST_RTOL = 1e-2
SEG_POSE_ATOL = 2e-3
SEG_JOINT_RATIO = 1.02
SEG_SCALE = dict(n_seg=8, sweeps=2, polish_iterations=3)
SEG_SCALE_REFERENCE = dict(ate=0.7407, cost=2_093_805.4)
LONG_WORLD = dict(P=4096, L=100_000, obs_per_lm=4, seed=7, stereo=True, pose_noise=0.01, pose_walk=0.02)
LONG_SEGMENTS = dict(n_seg=8, sweeps=2, polish_iterations=2)
LONG_ITERATIONS = 8
DIST_RANKS = 2
DIST_GROUPS = (("gloo", DIST_RANKS), ("nccl", 1))
DIST_SEGMENTS = 4
DIST_PCG_RTOL = 3e-4
DIST_SEG_RTOL = 1e-2  # dense too
DIST_DENSE_REFERENCE = dict(cost=866.2767)
DIST_TIMEOUT_S = 600

# The H100's published peaks (NVIDIA data sheet, SXM, dense, 700 W).
# Phase 13: the card's angles against the CPU's, and each call's kernel
# launches on the card (B1 fast_scores_nms, B2 extract_patches; the Hamming
# and window kernels are never launched there).
API_THETA_ATOL = 1e-6
API_KEYPOINTS = 512
API_EDGE_KEYPOINTS = 64
API_LAUNCHES = {
    "compute_orientations": {"extract_patches": 1},
    "brief_describe gather": {},
    "brief_describe mxu": {"extract_patches": 1},
    "brief_describe auto": {},
    "extract_patches (H, W)": {"extract_patches": 1},
    "extract_patches (H, W, 3)": {"extract_patches": 1},
    "fast_detect nms=False": {"fast_scores_nms": 1},
    "detect_and_describe nms=False": {"fast_scores_nms": 1, "extract_patches": 1},
}

HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# Issue rates per SM per clock (Hopper): min/max (FMNMX) at half the FP32
# add/multiply rate. Times the SM count and nvidia-smi's maximum SM clock.
SMS = 132
FMNMX_PER_CLOCK_SM = 64
FADD_PER_CLOCK_SM = 128
# FAST-9 + NMS per pixel: 16 ring - centre subtractions; 128 arc min/max by
# doubling (min and max of 2, 4, 8, 9 neighbours at 16 starts) and 32 for the
# two polarities and the best start, two values per instruction (half2) on a
# uint8 image, whose differences are exact in fp16; 8 NMS maxima and 1 compare.
FAST_SUBS_PER_PIXEL = 16
FAST_ARC_MINMAX_PER_PIXEL = 128 + 32
FAST_NMS_PER_PIXEL = 9

# Kernel name -> (CUDA source, the TPU kernel(s) it replaces, a substring of
# its CUDA kernel's symbol for torch.profiler).
KERNELS = {
    "fast_scores_nms": (
        "vision_slam_frontend_tpu_torch/csrc/fast_nms.cu",
        "vision_slam_frontend_tpu/ops/pallas_kernels.py:331",
        "fast_nms_kernel",
    ),
    "extract_patches": (
        "vision_slam_frontend_tpu_torch/csrc/extract_patches.cu",
        "vision_slam_frontend_tpu/ops/pallas_kernels.py:394",
        "extract_patches_kernel",
    ),
    "hamming_top2": (
        "vision_slam_frontend_tpu_torch/csrc/hamming_top2.cu",
        "vision_slam_frontend_tpu/ops/pallas_kernels.py:193 and vision_slam_frontend_tpu/ops/pallas_kernels.py:89",
        "hamming_top2_kernel",
    ),
    "patch_windows": (
        "vision_slam_frontend_tpu_torch/csrc/patch_windows.cu",
        "probe_kernel_variants.py:22",
        "patch_windows_kernel",
    ),
}
# The shape of each kernel that the kernels line reports (the others are on
# the line before it).
PRIMARY_SHAPE = {
    "fast_scores_nms": "640x480 u8",
    "extract_patches": "ORB K=512 C=1 ps=31 f16",
    "hamming_top2": "window 5120x512 words=8",
    "patch_windows": "E1 dyn-sublane, 32 rows, blk64",
}
# Frontend configurations: name -> FrontendConfig overrides.
CONFIGS = {
    "orb": {},
    "brisk": {"descriptor_family": "brisk"},
    "freak": {"descriptor_family": "freak"},
    "akaze": {"descriptor_family": "akaze"},
    "orb_pyramid": {"num_levels": 3},
    "sift": {"descriptor_family": "sift"},
}

# Phase 9 (a): tests/test_golden_loop.py's fixture and its per-family pins
# (FAMILY_GOLDEN, tests/test_golden_loop.py:42-63; chip_smoke imports no test
# module, so the pins are copied here).
GOLDEN_FRAMES = 215
GOLDEN_RIG = dict(width=512, height=384, cx=256.0, cy=192.0, fx=420.0, fy=420.0)
GOLDEN_SEQUENCE = dict(step=0.25, yaw_rate=2 * np.pi / 210, odom_drift=0.02, seed=5, texture_noise=2.0)
GOLDEN_CONFIG = dict(max_features=256, frame_life=8, fast_threshold=12.0)
FAMILY_GOLDEN = {
    "orb": {"ate_ba_max": 0.26, "min_landmarks": 1830, "min_obs": 5800,
            "min_feats_mean": 98, "min_feats_min": 42, "beats_odom": True},
    "brisk": {"ate_ba_max": 0.23, "min_landmarks": 1800, "min_obs": 5400,
              "min_feats_mean": 95, "min_feats_min": 43, "beats_odom": True},
    "akaze": {"ate_ba_max": 0.53, "min_landmarks": 1650, "min_obs": 5000,
              "min_feats_mean": 93, "min_feats_min": 46, "beats_odom": False},
    "sift": {"ate_ba_max": 0.99, "min_landmarks": 1850, "min_obs": 5900,
             "min_feats_mean": 98, "min_feats_min": 42, "beats_odom": False},
    "freak": {"ate_ba_max": 0.26, "min_landmarks": 2000, "min_obs": 6400,
              "min_feats_mean": 94, "min_feats_min": 38, "beats_odom": True},
}
# Phase 9 (b): the interrupted CLI run (tests/test_checkpoint.py's).
CKPT_INPUT = "synthetic:12"
CKPT_INTERRUPT_AFTER = 6
CKPT_EVERY = 3

# Phase 10 (a): the JPEG decoder the H100 machine has. A probe of that machine
# found cv2 and PIL but no libjpeg headers, so the native decoder cannot be
# built there; the run fails where the route taken differs.
CARD_DECODE_ROUTE = "cv2"
# Phase 10 (b): tests/test_golden_bag.py's fixture and its per-family pins
# (FAMILY_GOLDEN, tests/test_golden_bag.py:35-53), copied: chip_smoke
# imports no test module.
BAG_FRAMES = 100
BAG_ODOM_DRIFT = 0.02
BAG_JPEG_QUALITY = 88
BAG_SEED = 9
BAG_CONFIG = dict(max_features=256, frame_life=8, fast_threshold=12.0)
BAG_CPU_POSES = 20
BAG_GOLDEN = {
    "orb": {"ate_ba_max": 0.12, "min_landmarks": 670, "min_feats_mean": 70, "min_feats_min": 22},
    "brisk": {"ate_ba_max": 0.12, "min_landmarks": 450, "min_feats_mean": 55, "min_feats_min": 15},
    "akaze": {"ate_ba_max": 0.27, "min_landmarks": 660, "min_feats_mean": 60, "min_feats_min": 20},
    "sift": {"ate_ba_max": 0.25, "min_landmarks": 900, "min_feats_mean": 80, "min_feats_min": 30},
    "freak": {"ate_ba_max": 0.13, "min_landmarks": 660, "min_feats_mean": 65, "min_feats_min": 27},
}
# Phase 10 (c): the end-to-end bag rate (bench.py's degraded-bag row:
# SyntheticRig(), K=512, W=10, fast threshold 12).
RATE_FRAMES = 150
RATE_CONFIG = dict(max_features=512, frame_life=10, fast_threshold=12.0)
# Phase 10 (d): the 5-frame KITTI and EuRoC inputs of tests/test_io.py.
DATASET_FRAMES = 5
DATASET_ARGS = ["--max_features", "192", "--frame_life", "4"]
# Phase 10 (e): tests/test_adversarial_conditions.py's 6x5 survival matrix
# (CONDITIONS, FAMILIES, NUM_FRAMES), copied.
CONDITION_FRAMES = 30
CONDITION_FAMILIES = ["orb", "brisk", "akaze", "sift", "freak"]
CONDITIONS = {
    "heavy_blur": dict(
        degrader=dict(seed=3, max_blur_px=6.0, noise_read=4.0),
        seq=dict(step=0.25, yaw_rate=2 * np.pi / 210),
    ),
    "exposure_steps": dict(
        degrader=dict(seed=4, flicker=0.35, offset_drift=24.0, max_blur_px=1.5),
        seq=dict(step=0.25, yaw_rate=2 * np.pi / 210),
    ),
    "rotation_dominant": dict(
        degrader=dict(seed=5, max_blur_px=2.0),
        seq=dict(step=0.08, yaw_rate=2 * np.pi / 30),
    ),
    "low_contrast": dict(
        degrader=dict(seed=6, max_blur_px=2.0, noise_read=1.5),
        contrast=0.35,
        seq=dict(step=0.25, yaw_rate=2 * np.pi / 210),
    ),
    "camera_roll": dict(
        degrader=dict(seed=7, max_blur_px=2.0),
        seq=dict(step=0.1, yaw_rate=0.0,
                 roll_rate=np.deg2rad(12.0), pitch_rate=np.deg2rad(-0.8)),
    ),
    "forward_approach": dict(
        degrader=dict(seed=8, max_blur_px=2.0),
        seq=dict(step=0.7, yaw_rate=0.0),
    ),
}


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    """The first card's `nvidia-smi --query-gpu=<query>` line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def check_equal(what: str, a, b) -> None:
    """Exact equality (equal infinities and NaNs included), or a failure
    that names how many elements differ and the first of them."""
    import torch

    a, b = a.cpu(), b.cpu()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.dtype.is_floating_point else a == b
    if a.shape != b.shape or not bool(same.all()):
        if a.shape != b.shape:
            raise AssertionError(f"{what}: shapes {tuple(a.shape)} vs {tuple(b.shape)}")
        first = tuple((~same).nonzero()[0].tolist())
        raise AssertionError(
            f"{what}: {int((~same).sum())} of {a.numel()} elements differ; first at {first}: "
            f"{a[first].item()} vs {b[first].item()}"
        )


def check_equal_arrays(what: str, a, b) -> None:
    """check_equal on numpy arrays."""
    import torch

    check_equal(what, torch.from_numpy(np.ascontiguousarray(a)), torch.from_numpy(np.ascontiguousarray(b)))


def max_abs_err(a, b) -> float:
    """Largest |a - b|, with equal infinities counting as 0."""
    import torch

    a = a.double()
    b = b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def synthetic_frames(n: int):
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence

    return list(generate_sequence(num_frames=n, step=0.25, rig=SyntheticRig()))


def make_config(name: str):
    from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig

    return FrontendConfig(calib=SyntheticRig().calib(), fast_threshold=12.0, **CONFIGS[name])


def frame_poses(frames):
    """Per-frame odometry world pose relative to frame 0 (the Frontend's rule)."""
    from vision_slam_frontend_tpu_torch.utils import np_geom

    q0 = np_geom.quat_normalize(np.asarray(frames[0].odom_rotation, np.float64))
    t0 = np.asarray(frames[0].odom_translation, np.float64)
    q0_inv = np_geom.quat_inverse(q0)
    out = []
    for f in frames:
        q = np_geom.quat_normalize(np.asarray(f.odom_rotation, np.float64))
        t = np_geom.quat_rotate(q0_inv, np.asarray(f.odom_translation, np.float64) - t0)
        out.append((t.astype(np.float32), np_geom.quat_multiply(q, q0_inv).astype(np.float32)))
    return out


def u8(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0, 255).astype(np.uint8)


def bound(bytes_moved: float, op_seconds: float = 0.0) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations' time at their peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    return max(t_bytes, op_seconds) * 1e3, ("operations" if op_seconds > t_bytes else "bytes")


def fast_op_seconds(pixels: int, sm_hz: float, arc_values_per_op: int) -> float:
    """Least time of FAST-9 + NMS over `pixels` at the issue rates of its
    instructions (min/max at 64, subtraction at 128 per clock per SM), the
    arcs' min/max at `arc_values_per_op` values per instruction."""
    minmax = FAST_ARC_MINMAX_PER_PIXEL / arc_values_per_op + FAST_NMS_PER_PIXEL
    return pixels * (minmax / FMNMX_PER_CLOCK_SM + FAST_SUBS_PER_PIXEL / FADD_PER_CLOCK_SM) / (SMS * sm_hz)


def covered_pixels(ys, xs, rows: int, cols: int, H: int, W: int) -> int:
    """Distinct image pixels inside rows x cols windows at (ys, xs): what a
    gather of those windows must read at least once."""
    import torch

    dev = ys.device
    r = ys.long()[:, None, None] + torch.arange(rows, device=dev)[None, :, None]
    c = xs.long()[:, None, None] + torch.arange(cols, device=dev)[None, None, :]
    inside = (r >= 0) & (r < H) & (c >= 0) & (c < W)
    mask = torch.zeros(H * W, dtype=torch.bool, device=dev)
    mask[(r.clamp(0, H - 1) * W + c.clamp(0, W - 1))[inside]] = True
    return int(mask.sum())


# ---------------------------------------------------------------------------
# Kernel cases: every shape the paths give each kernel
# ---------------------------------------------------------------------------


def kernel_cases(ck, frames, dev, sm_hz):
    """[{kernel, shape, kernel fn, plain fn, library fn or None, bound_ms,
    bound_by}] at the main paths' shapes, on the card; `sm_hz` is the SM
    clock the FAST bound counts."""
    import torch

    from vision_slam_frontend_tpu_torch.ops import akaze, brief, brisk, freak
    from vision_slam_frontend_tpu_torch.ops.fast import fast_detect
    from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur, resize_linear

    cases = []
    img = torch.from_numpy(u8(frames[1].left)).to(dev)
    H, W = img.shape

    # B1: uint8 frame, float32 frame (non-integer values), pyramid level.
    level = resize_linear(img.float(), (343, 457))
    for label, im in (("640x480 u8", img), ("640x480 f32", gaussian_blur(img.float(), sigma=1.0)),
                      ("457x343 f32 level", level)):
        h, w = im.shape
        b_ms, b_by = bound(h * w * (im.element_size() + 8),
                           fast_op_seconds(h * w, sm_hz, 2 if im.dtype == torch.uint8 else 1))
        cases.append(dict(kernel="fast_scores_nms", shape=label, kernel_fn=lambda im=im: ck.fast_scores_nms(im),
                          plain_fn=lambda im=im: ck.fast_scores_nms_plain(im), library_fn=None,
                          bound_ms=b_ms, bound_by=b_by))

    # B2: each family's planes at K=512, keypoints from the detector plus
    # clamped corners and exact .5 coordinates.
    kps, _, _ = fast_detect(img, threshold=12.0, max_keypoints=512, border=19)
    special = torch.tensor(
        [[0.0, 0.0], [639.0, 479.0], [-7.0, 3.0], [700.0, 500.0], [100.5, 200.5],
         [101.5, 33.5], [15.5, 15.5], [624.5, 464.5], [320.49, 240.51], [2.5, 477.5]],
        device=dev,
    )
    kps = torch.cat([kps[: 512 - len(special)], special]).contiguous()
    imf = img.float()
    L = akaze.build_scale_space(imf, 1, 1.4)[0]
    Lx, Ly = akaze.grad_central(L)
    # The pyramid's second level: its share of the budget (brief.level_budgets)
    # at the level's coordinates.
    level_kps = (kps[: brief.level_budgets(512, 3)[1]] / 1.4).contiguous()
    for label, planes, ps, k_in in (
        ("ORB K=512 C=1 ps=31 f16", gaussian_blur(imf).to(torch.float16)[None], 31, kps),
        ("BRISK K=512 C=5 ps=27 f32", torch.stack([gaussian_blur(imf, sigma=s) for s in brisk.SIGMAS]), 27, kps),
        ("FREAK K=512 C=7 ps=27 f32", torch.stack([gaussian_blur(imf, sigma=s) for s in freak.SIGMAS]), 27, kps),
        ("AKAZE K=512 C=3 ps=31 f32", torch.stack([L, Lx, Ly]), 31, kps),
        ("SIFT K=512 C=1 ps=31 f32", gaussian_blur(imf)[None], 31, kps),
        (f"ORB pyramid level 457x343 K={len(level_kps)} C=1 ps=31 f16",
         gaussian_blur(level).to(torch.float16)[None], 31, level_kps),
    ):
        planes = planes.contiguous()
        C, H, W = planes.shape
        r = ps // 2
        xs = (torch.round(k_in[:, 0]).long() - r).clamp(0, W - ps)
        ys = (torch.round(k_in[:, 1]).long() - r).clamp(0, H - ps)
        off = torch.arange(ps, device=dev)
        r_idx = (ys[:, None, None] + off[None, :, None]).expand(-1, ps, ps)
        c_idx = (xs[:, None, None] + off[None, None, :]).expand(-1, ps, ps)
        elem = planes.element_size()
        b_ms, b_by = bound(covered_pixels(ys, xs, ps, ps, H, W) * C * elem + k_in.numel() * 4
                           + k_in.shape[0] * C * ps * ps * elem)
        cases.append(dict(kernel="extract_patches", shape=label,
                          kernel_fn=lambda p=planes, ps=ps, k=k_in: ck.extract_patches(p, k, ps),
                          plain_fn=lambda p=planes, ps=ps, k=k_in: ck.extract_patches_plain(p, k, ps),
                          library_fn=lambda p=planes, ri=r_idx, ci=c_idx: p[:, ri, ci].transpose(0, 1),
                          bound_ms=b_ms, bound_by=b_by))

    # B3/B4: stereo 512x512 and window 5120x512 at 8 and 16 words, and the
    # reference's K=8192 setting.
    rng = np.random.default_rng(0)
    for kq, kt, words in ((5120, 512, 8), (512, 512, 8), (5120, 512, 16), (512, 512, 16), (8192, 8192, 8)):
        q = torch.from_numpy(rng.integers(0, 2**32, (kq, words), dtype=np.uint32).view(np.int32)).to(dev)
        t = torch.from_numpy(rng.integers(0, 2**32, (kt, words), dtype=np.uint32).view(np.int32)).to(dev)
        v = torch.from_numpy(rng.random(kt) >= 0.3).to(dev)
        n_valid = int(v.sum())
        # The b1 products' rate is unpublished: they are counted at the int8
        # tensor rate, and the bytes' time is reported beside it.
        n_bytes = (kq + kt) * words * 4 + kt + kq * 12
        b_ms, b_by = bound(n_bytes, 2.0 * kq * n_valid * words * 32 / INT8_TENSOR_OPS_PER_S)
        kind = "K=8192" if kq == 8192 else ("window" if kq > kt else "stereo")
        cases.append(dict(kernel="hamming_top2", shape=f"{kind} {kq}x{kt} words={words}",
                          kernel_fn=lambda q=q, t=t, v=v: ck.hamming_top2(q, t, v),
                          plain_fn=lambda q=q, t=t, v=v: ck.hamming_top2_plain(q, t, v), library_fn=None,
                          bound_ms=b_ms, bound_by=b_by, bound_bytes_ms=bound(n_bytes)[0]))
    return cases


def window_cases(ck, dev):
    """B5's five cases at the TPU probe's shapes (480x640, K=8192)."""
    import torch

    from vision_slam_frontend_tpu_torch.ops import kernel_variants as kv

    H, W, K = kv.PROBE_SHAPE
    img, ys, xs = kv.probe_inputs(H, W, K, dev)
    cases = []
    for name, rows, shifted, block in kv.CASES:
        cover = covered_pixels(ys, xs if shifted else torch.zeros_like(xs), rows, ck.WINDOW_COLS, H, W)
        b_ms, b_by = bound(cover * 4 + K * 8 + K * rows * ck.WINDOW_COLS * 4)
        cases.append(dict(kernel="patch_windows", shape=name, bound_ms=b_ms, bound_by=b_by,
                          kernel_fn=lambda r=rows, s=shifted, b=block: ck.patch_windows(img, ys, xs, r, s, b),
                          plain_fn=lambda r=rows, s=shifted, b=block: ck.patch_windows_plain(img, ys, xs, r, s, b)))
    return (img, ys, xs), cases


def compare_outputs(what: str, out, ref) -> float:
    """Exact equality of a kernel's output(s) with the plain version's;
    returns the max abs error (0)."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = 0.0
    for i, (a, b) in enumerate(zip(outs, refs)):
        check_equal(f"{what} output {i} vs plain", a, b)
        err = max(err, max_abs_err(a, b))
    return err


def phase_kernels(ck, cases, windows, dev):
    """Each case, plus edge cases, against the plain version; returns (the
    max error per kernel, the number of edge cases)."""
    import torch
    import torch_edge_cases as edge_cases

    errs = {name: 0.0 for name in KERNELS}
    for c in cases + windows:
        out = c["kernel_fn"]()
        torch.cuda.synchronize()
        ref = c["plain_fn"]()
        errs[c["kernel"]] = max(errs[c["kernel"]], compare_outputs(f"{c['kernel']} {c['shape']}", out, ref))
        if c.get("library_fn") is not None:  # the timed library call computes the same function
            check_equal(f"{c['kernel']} {c['shape']} library call vs plain", c["library_fn"](),
                        ref.reshape(c["library_fn"]().shape))
    # Hamming edge cases: all trains invalid (1e9 sentinels), ragged sizes,
    # large 16-word sets.
    rng = np.random.default_rng(1)
    for kq, kt, words, invalid in ((512, 512, 8, 1.0), (77, 300, 8, 0.5), (2048, 2048, 16, 0.2), (64, 1, 16, 0.0)):
        q = torch.from_numpy(rng.integers(0, 2**32, (kq, words), dtype=np.uint32).view(np.int32)).to(dev)
        t = torch.from_numpy(rng.integers(0, 2**32, (kt, words), dtype=np.uint32).view(np.int32)).to(dev)
        v = torch.from_numpy(rng.random(kt) >= invalid).to(dev)
        out = ck.hamming_top2(q, t, v)
        torch.cuda.synchronize()
        what = f"hamming_top2 {kq}x{kt} words={words} invalid={invalid}"
        errs["hamming_top2"] = max(errs["hamming_top2"], compare_outputs(what, out, ck.hamming_top2_plain(q, t, v)))
    n_edge = 0
    for label, (q, t, v) in edge_cases.hamming_cases():
        q, t = (torch.from_numpy(a.view(np.int32)).to(dev) for a in (q, t))
        v = torch.from_numpy(v).to(dev)
        out = ck.hamming_top2(q, t, v)
        torch.cuda.synchronize()
        errs["hamming_top2"] = max(errs["hamming_top2"], compare_outputs(
            f"hamming_top2 edge case {label}", out, ck.hamming_top2_plain(q, t, v)))
        n_edge += 1
    for label, img in edge_cases.fast_cases():
        img = torch.from_numpy(img).to(dev)
        out = ck.fast_scores_nms(img)
        torch.cuda.synchronize()
        errs["fast_scores_nms"] = max(errs["fast_scores_nms"], compare_outputs(
            f"fast_scores_nms edge case {label}", out, ck.fast_scores_nms_plain(img)))
        n_edge += 1
    for label, planes, kps, ps, offset in edge_cases.patch_cases():
        planes = edge_cases.at_offset(planes, offset, dev)
        kps = torch.from_numpy(kps).to(dev)
        out = ck.extract_patches(planes, kps, ps)
        torch.cuda.synchronize()
        errs["extract_patches"] = max(errs["extract_patches"], compare_outputs(
            f"extract_patches edge case {label}", out, ck.extract_patches_plain(planes, kps, ps)))
        n_edge += 1
    for label, img, ys, xs, rows, shifted, block, offset in edge_cases.window_cases():
        img = edge_cases.at_offset(img, offset, dev)
        ys, xs = torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev)
        out = ck.patch_windows(img, ys, xs, rows, shifted, block)
        torch.cuda.synchronize()
        errs["patch_windows"] = max(errs["patch_windows"], compare_outputs(
            f"patch_windows edge case {label}", out, ck.patch_windows_plain(img, ys, xs, rows, shifted, block)))
        n_edge += 1
    return errs, n_edge


# ---------------------------------------------------------------------------
# Steps, parity, main paths
# ---------------------------------------------------------------------------


def step_inputs(frames, dev):
    import torch

    poses = frame_poses(frames)
    return [
        (
            torch.from_numpy(u8(f.left)).to(dev),
            torch.from_numpy(u8(f.right)).to(dev),
            torch.from_numpy(t).to(dev),
            torch.from_numpy(q).to(dev),
        )
        for f, (t, q) in zip(frames, poses)
    ]


def run_step(params, state, inputs, fid, config):
    from vision_slam_frontend_tpu_torch.frontend.keyframe import keyframe_step

    left, right, t, q = inputs
    return keyframe_step(
        params, state, left, right, fid,
        capacity=config.max_features, window=config.frame_life, border=config.detect_border,
        blur_sigma=config.blur_sigma, num_levels=config.num_levels, scale_factor=config.pyramid_scale,
        descriptor_family=config.descriptor_family, mutual_check=config.mutual_check,
        curr_pose_t=t, curr_pose_q=q,
    )


def new_state(config, dev):
    from vision_slam_frontend_tpu_torch.frontend.keyframe import WindowState
    from vision_slam_frontend_tpu_torch.ops.descriptors import descriptor_dtype, get_family

    family = get_family(config.descriptor_family)
    return WindowState.create(config.frame_life, config.max_features, config.stereo_threshold_init, dev,
                              words=family.words, desc_dtype=descriptor_dtype(family))


def state_to(state, dev):
    import dataclasses

    from vision_slam_frontend_tpu_torch.frontend.keyframe import WindowState

    return WindowState(**{f.name: getattr(state, f.name).to(dev) for f in dataclasses.fields(state)})


def phase_parity(config, in_gpu, in_cpu, n_keyframes, dev):
    """keyframe_step on CUDA vs CPU from the same state, n_keyframes times."""
    import dataclasses

    import torch

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams

    cpu = torch.device("cpu")
    p_gpu = StepParams.from_config(config, dev)
    p_cpu = StepParams.from_config(config, cpu)
    s_cpu = new_state(config, cpu)
    n_fields = 0
    float_err = 0.0
    for k in range(1, n_keyframes + 1):
        s_gpu_new, r_gpu = run_step(p_gpu, state_to(s_cpu, dev), in_gpu[k], k - 1, config)
        s_cpu_new, r_cpu = run_step(p_cpu, s_cpu, in_cpu[k], k - 1, config)
        for obj_g, obj_c in ((r_gpu, r_cpu), (s_gpu_new, s_cpu_new)):
            for f in dataclasses.fields(obj_c):
                a, b = getattr(obj_g, f.name).cpu(), getattr(obj_c, f.name)
                if a.dtype.is_floating_point:
                    float_err = max(float_err, max_abs_err(a, b))
                else:
                    check_equal(f"keyframe {k}: {type(obj_c).__name__}.{f.name} CUDA vs CPU", a, b)
                    n_fields += 1
        check(int(r_cpu.num_features) > 50, f"keyframe {k}: only {int(r_cpu.num_features)} features")
        s_cpu = s_cpu_new
    return n_fields, float_err


def compare_problems(gpu_npz: str, cpu_npz: str) -> str:
    a, b = np.load(gpu_npz), np.load(cpu_npz)
    check(sorted(a.files) == sorted(b.files), "npz keys differ between CUDA and CPU runs")
    for k in b.files:
        check(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, f"npz {k}: shape/dtype differ")
        if a[k].dtype.kind == "f":
            check(bool(np.isfinite(a[k]).all()), f"npz {k}: non-finite values")
    check(len(a["nodes_id"]) > 0 and len(a["feat_node"]) > 0, "empty problem")
    track_eq = float(np.mean(a["feat_track"] == b["feat_track"]))
    check(track_eq >= 0.99, f"only {track_eq:.4f} of track ids equal CUDA vs CPU")
    px = float(np.abs(a["feat_pixel"] - b["feat_pixel"]).max())
    check(px <= 1e-3, f"feature pixels differ by {px} px CUDA vs CPU")
    return (f"{len(a['nodes_id'])} nodes, {len(a['feat_node'])} features, "
            f"{len(a['vfm_factor'])} matches; track ids equal {track_eq:.4f}, max pixel diff {px:.2e}")


def check_launches(path: str, launches: dict, runs: tuple[str, ...], absent: tuple[str, ...] = ()) -> None:
    for name in runs:
        check(launches[name] > 0, f"{path}: kernel {name} was not launched")
    for name in absent:
        check(launches[name] == 0, f"{path}: kernel {name} was launched {launches[name]} times")


def run_cli(ck, argv, dev, tmp, tag):
    """The CLI on the card (launch counts from that run), then on the CPU;
    returns (summary line, launches, keyframes, agreement)."""
    import contextlib
    import io

    from vision_slam_frontend_tpu_torch.cli.slam_frontend import main as cli_main

    gpu_out = os.path.join(tmp, f"{tag}_gpu.npz")
    cpu_out = os.path.join(tmp, f"{tag}_cpu.npz")
    buf = io.StringIO()
    ck.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([*argv, "--output", gpu_out, "--device", str(dev)])
    launches = ck.runs()
    check(rc == 0, f"CLI {argv} exit code {rc}")
    summary = [ln for ln in buf.getvalue().splitlines() if ln.startswith("Saved SLAM problem")]
    check(len(summary) == 1, f"no summary line from the CLI {argv}")
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli_main([*argv, "--output", cpu_out, "--device", "cpu"]) == 0, f"CPU run {argv} failed")
    return summary[0], launches, len(np.load(gpu_out)["nodes_id"]), compare_problems(gpu_out, cpu_out)


def run_frontend(ck, config, frames, dev, tmp, tag):
    """Frontend over `frames` on the card (launch counts from that run),
    then on the CPU; returns (summary, launches, keyframes, agreement)."""
    import torch

    from vision_slam_frontend_tpu_torch.frontend import Frontend
    from vision_slam_frontend_tpu_torch.io.serialize import save_problem

    paths, summaries, launches = [], [], None
    for i, device in enumerate((dev, torch.device("cpu"))):
        ck.reset_launch_counts()
        fe = Frontend(config, device=device)
        for f in frames:
            fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
            fe.observe_image(f.left, f.right, f.timestamp)
        problem = fe.get_slam_problem()
        if i == 0:
            launches = ck.runs()
        paths.append(os.path.join(tmp, f"{tag}_{i}.npz"))
        save_problem(paths[-1], problem, config=config, node_track_ids=fe.node_track_ids)
        summaries.append(problem.summary())
    return summaries[0], launches, len(np.load(paths[0])["nodes_id"]), compare_problems(*paths)


def phase_main(ck, frames, window_inputs, dev, tmp):
    """Every path once; returns ({path: launches}, lines, B5 results)."""
    from vision_slam_frontend_tpu_torch.ops import kernel_variants as kv

    frontend_kernels = ("fast_scores_nms", "extract_patches", "hamming_top2")
    per_path = {}
    lines = []
    summary, launches, n_kf, agreement = run_cli(ck, ["--input", MAIN_INPUT], dev, tmp, "orb")
    check_launches("ORB CLI", launches, frontend_kernels, absent=("patch_windows",))
    per_path["orb"] = launches
    lines.append(f"ORB {MAIN_INPUT}: {summary}; launches {launches} over {n_kf} keyframes; vs CPU: {agreement}")
    for fam in ("brisk", "freak", "akaze", "sift"):
        summary, launches, n_kf, agreement = run_cli(
            ck, ["--input", FAMILY_INPUT, "--descriptor_family", fam], dev, tmp, fam)
        if fam == "akaze":  # AKAZE detects on the Hessian response: no FAST kernel
            check_launches("AKAZE CLI", launches, ("extract_patches", "hamming_top2"),
                           absent=("fast_scores_nms", "patch_windows"))
        elif fam == "sift":  # SIFT matches by L2 distance: no Hamming kernel
            check_launches("SIFT CLI", launches, ("fast_scores_nms", "extract_patches"),
                           absent=("hamming_top2", "patch_windows"))
        else:
            check_launches(f"{fam} CLI", launches, frontend_kernels, absent=("patch_windows",))
        per_path[fam] = launches
        lines.append(f"{fam} {FAMILY_INPUT}: {summary}; launches {launches} over {n_kf} keyframes; vs CPU: {agreement}")
    summary, launches, n_kf, agreement = run_frontend(ck, make_config("orb_pyramid"), frames[:FAMILY_FRAMES], dev,
                                                      tmp, "pyramid")
    check_launches("ORB pyramid", launches, frontend_kernels, absent=("patch_windows",))
    per_path["orb_pyramid"] = launches
    lines.append(f"ORB 3-level pyramid, {FAMILY_FRAMES} frames: {summary}; launches {launches} over {n_kf} "
                 f"keyframes; vs CPU: {agreement}")
    # The window-gather entry point (ops/kernel_variants), at the probe's shapes.
    ck.reset_launch_counts()
    b5 = kv.run_cases(*window_inputs)
    launches = ck.runs()
    check_launches("kernel_variants", launches, ("patch_windows",),
                   absent=("fast_scores_nms", "extract_patches", "hamming_top2"))
    per_path["kernel_variants"] = launches
    lines.append(f"kernel_variants at H=480 W=640 K=8192: 5 cases exact; launches {launches}")
    return per_path, lines, b5


def phase_sync_free(frames, dev):
    """One steady-state step per configuration, inputs already on the card,
    under sync-debug "error"."""
    import torch

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams

    inputs = step_inputs(frames[:4], dev)
    out = {}
    for name in CONFIGS:
        config = make_config(name)
        params = StepParams.from_config(config, dev)
        state = new_state(config, dev)
        for k in range(1, 3):
            state, _ = run_step(params, state, inputs[k], k - 1, config)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, result = run_step(params, state, inputs[3], 2, config)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out[name] = int(result.num_features)
    return out


def step_times(config, inputs, dev):
    """Median synced keyframe step time and median host enqueue time (ms,
    host clock) over the steady keyframes, and their count."""
    import torch

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams

    params = StepParams.from_config(config, dev)
    state = new_state(config, dev)
    step_ms, enqueue_ms = [], []
    for k in range(1, len(inputs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = run_step(params, state, inputs[k], k - 1, config)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        enqueue_ms.append((t1 - t0) * 1e3)
    # The first keyframes pay one-time set-up.
    return statistics.median(step_ms[2:]), statistics.median(enqueue_ms[2:]), len(step_ms) - 2


def profile_step(config, inputs, dev):
    """Kernel launches and device time (ms) of one steady step, from
    torch.profiler: (launches, device ms), each None where the profiler
    recorded no such event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams

    params = StepParams.from_config(config, dev)
    state = new_state(config, dev)
    for k in range(1, 4):
        state, _ = run_step(params, state, inputs[k], k - 1, config)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_step(params, state, inputs[4], 3, config)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 if device else None
    return launches or None, device_ms


def product_ms(ck, dev) -> float:
    """Device time of the Hamming window shape's distance product alone: the
    +-1 int8 (5120, 256) @ (256, 512) through torch._int_mm (cuBLAS), checked
    against the plain distances. A yardstick: the port never calls it."""
    import torch

    from vision_slam_frontend_tpu_torch.ops.brief import unpack_bits
    from vision_slam_frontend_tpu_torch.utils.cuda_timing import device_ms

    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.integers(0, 2**32, (5120, 8), dtype=np.uint32).view(np.int32)).to(dev)
    t = torch.from_numpy(rng.integers(0, 2**32, (512, 8), dtype=np.uint32).view(np.int32)).to(dev)
    bq, bt = unpack_bits(q), unpack_bits(t)
    sq = (1 - 2 * bq).to(torch.int8)
    st = (1 - 2 * bt).to(torch.int8).t().contiguous()
    dot = torch._int_mm(sq, st)
    dist = bq.sum(1)[:, None] + bt.sum(1)[None, :] - 2.0 * (bq @ bt.T)
    check(torch.equal((256 - dot).float() / 2, dist), "the +-1 int8 product disagrees with the plain distances")
    return device_ms(lambda: torch._int_mm(sq, st))


def phase_timing(ck, cases, frames, dev):
    """Step medians per configuration; each kernel case's times; the
    profiler's kernel durations at each kernel's main shape; product_ms; and
    the launch floor: the device time of the smallest kernel (a 1-element
    fill) timed the same way."""
    import torch

    from vision_slam_frontend_tpu_torch.utils.cuda_timing import call_ms, device_ms, profiled_kernel_ms

    inputs = step_inputs(frames, dev)
    steps = {name: step_times(make_config(name), inputs, dev) + profile_step(make_config(name), inputs, dev)
             for name in CONFIGS}
    rows = []
    for c in cases:
        # Plain, kernel, kernel, plain: the mean of each pair's device times.
        p1, k1, k2, p2 = (device_ms(c["plain_fn"]), device_ms(c["kernel_fn"]), device_ms(c["kernel_fn"]),
                          device_ms(c["plain_fn"]))
        lib = device_ms(c["library_fn"]) if c["library_fn"] is not None else None
        row = dict(kernel=c["kernel"], shape=c["shape"], ms=(k1 + k2) / 2, call_ms=call_ms(c["kernel_fn"]),
                   plain_ms=(p1 + p2) / 2, library_ms=lib, bound_ms=c["bound_ms"], bound_by=c["bound_by"])
        if "bound_bytes_ms" in c:
            row["bound_bytes_ms"] = c["bound_bytes_ms"]
        if PRIMARY_SHAPE[c["kernel"]] == c["shape"]:
            row["profiled_ms"], row["kernels_per_call"], row["profiled_device_events"] = profiled_kernel_ms(
                c["kernel_fn"], KERNELS[c["kernel"]][2])
        rows.append(row)
    one = torch.empty(1, device=dev)
    return steps, rows, product_ms(ck, dev), device_ms(lambda: one.fill_(0.0))


def profiler_note(row) -> str:
    """The profiler's cross-check of a timing row, for phase 6's line."""
    if "profiled_ms" not in row:
        return ""
    if row["profiled_ms"] is None:
        return f" (profiler not measured: {row['profiled_device_events']} device events recorded, none of this kernel)"
    return f" (profiler {row['profiled_ms']:.5f})"


# ---------------------------------------------------------------------------
# Phase 7: the bundle-adjustment backend
# ---------------------------------------------------------------------------


def accept_pattern(history) -> list[bool]:
    """Per LM iteration, whether its step was accepted (the cost fell)."""
    return [b < a for a, b in zip(history[:-1], history[1:])]


def compare_ba(what: str, gpu, cpu, gt_t) -> str:
    """Hold a CUDA run (problem, info) to the CPU run of the same problem."""
    from vision_slam_frontend_tpu_torch.backend.metrics import ate_rmse

    (pg, ig), (pc, ic) = gpu, cpu
    pg = pg.to("cpu")
    rel = abs(ig["cost"] - ic["cost"]) / max(abs(ic["cost"]), 1e-12)
    pose = max(max_abs_err(pg.poses_t, pc.poses_t), max_abs_err(pg.poses_q, pc.poses_q))
    lm = max_abs_err(pg.landmarks, pc.landmarks)
    flips = [i for i, (a, b) in enumerate(zip(accept_pattern(ig["history"]), accept_pattern(ic["history"]))) if a != b]
    line = (f"{what}: cost {ig['cost']:.6g} vs {ic['cost']:.6g} (rel {rel:.2e}), accepted {ig['accepted']} vs "
            f"{ic['accepted']}, ATE {ate_rmse(pg.poses_t.numpy(), gt_t):.4f} vs {ate_rmse(pc.poses_t.numpy(), gt_t):.4f} "
            f"m, poses max diff {pose:.2e}, landmarks {lm:.2e}")
    if flips:
        check(rel <= BA_FLIP_COST_RTOL, f"{line}; LM decisions flip at iterations {flips}, cost beyond {BA_FLIP_COST_RTOL}")
        return line + f"; LM accept/reject decisions FLIP at iterations {flips} (different LM paths: cost held only)"
    check(rel <= BA_COST_RTOL and pose <= BA_POSE_ATOL and lm <= BA_LM_ATOL and ig["accepted"] == ic["accepted"],
          f"{line}: beyond cost {BA_COST_RTOL}, poses {BA_POSE_ATOL}, landmarks {BA_LM_ATOL}")
    return line + "; no decision flips"


def phase_ba_small(dev) -> list[str]:
    """(a): synthetic_ba_problem on the CPU and on the card, dense and PCG."""
    import torch

    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, optimize
    from vision_slam_frontend_tpu_torch.io.synthetic import synthetic_ba_problem

    lines = []
    runs = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        cam, problem, gt_t, _ = synthetic_ba_problem(**BA_SMALL, device=device)
        for name in ("dense", "pcg"):
            solver = BASolverConfig(max_iterations=BA_SMALL_ITERATIONS, schur_solver=name,
                                    cg_iterations=BA_CG_ITERATIONS)
            runs[where, name] = optimize(problem, cam=cam, solver=solver)
    for name in ("dense", "pcg"):
        line = compare_ba(name, runs["card", name], runs["cpu", name], gt_t)
        check(name != "dense" or "FLIP" not in line, f"dense: {line}")
        lines.append(line)
    return lines


def ba_scalars():
    """The default solver's Huber delta and odometry weights, rounded to
    float32 as optimize rounds them."""
    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, _round_f32

    solver = BASolverConfig()
    return tuple(_round_f32(x) for x in (solver.huber_delta, solver.odom_t_weight, solver.odom_r_weight))


def ba_build(name, problem, pm, plan, lin, lam=1e-3):
    """The solve's one-time products: dense, the assembled S (the Schur
    assembly); PCG, the preconditioner and the CG operator's state."""
    from vision_slam_frontend_tpu_torch.backend import ba

    if name == "dense":
        return ba._dense_assemble(pm, *lin, problem, lam, True, plan)
    return ba._pm_build_from_pm(pm, *lin, problem, lam, True)


def ba_finish(name, problem, lin, built):
    """The rest of the step from ba_build's products: dense, the Cholesky
    solve and the back-substitution; PCG, the CG iterations and the
    back-substitution. Returns (d_pose, d_lm)."""
    from vision_slam_frontend_tpu_torch.backend import ba

    if name == "dense":
        S4, b, free, V_inv, g_lm = built
        d_pose, _ = ba._dense_solve_core(S4, b, free)
        lm_mask = problem.lm_obs_mask.to(g_lm.dtype)[..., None]
        return d_pose, ba._backsub(lin[1], lin[2], problem.lm_obs, lm_mask, V_inv, g_lm, d_pose)
    state, b, g_lm = built
    d_pose, _ = ba._run_pcg(b, lambda x: ba._pm_sapply(state, x), lambda x: ba._pm_mapply(state, x),
                            BA_CG_ITERATIONS)
    return d_pose, ba._pm_backsub(state, g_lm, d_pose)


def ba_solve(name, problem, pm, plan, lin):
    return ba_finish(name, problem, lin, ba_build(name, problem, pm, plan, lin))


def ba_iteration_times(name, cam, problem, reps: int):
    """One LM iteration's phases (linearize; the solve's one-time products:
    the Schur assembly for dense; the Cholesky or CG solve with the
    back-substitution; the candidate cost), each synced, `reps` times: the
    medians (ms), the median host enqueue and synced time of a whole
    iteration (ms), the launches and device ms of one profiled iteration
    (None where the profiler recorded none), and the sync check: one
    linearize + solve under sync-debug "error"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vision_slam_frontend_tpu_torch.backend import ba

    hd, wt, wr = ba_scalars()
    pm = ba._build_pm_inputs(problem)
    plan = ba._dense_coupling_plan(problem) if name == "dense" else None

    def lin():
        return ba._linearize_pm(cam, problem, pm, hd, wt, wr, True)

    def iteration():
        step = ba_solve(name, problem, pm, plan, lin())
        return ba.compute_cost(cam, ba._apply_step(problem, step[0], step[1]), hd, wt, wr, True)

    float(iteration())  # warm-up
    phases, whole, enqueue = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        terms = lin()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        built = ba_build(name, problem, pm, plan, terms)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        step = ba_finish(name, problem, terms, built)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        float(ba.compute_cost(cam, ba._apply_step(problem, step[0], step[1]), hd, wt, wr, True))
        t.append(time.perf_counter())
        phases.append([(b - a) * 1e3 for a, b in zip(t[:-1], t[1:])])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost = iteration()
        t1 = time.perf_counter()
        float(cost)
        whole.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(iteration())
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 if device else None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ba_solve(name, problem, pm, plan, lin())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    med = [statistics.median(p[i] for p in phases) for i in range(4)]
    out = dict(linearize_ms=med[0], build_ms=med[1], solve_ms=med[2], cost_ms=med[3],
               iteration_ms=statistics.median(whole), enqueue_ms=statistics.median(enqueue),
               launches=launches or None, device_ms=device_ms)
    if name == "dense":
        out.update(split=assembly_split(problem, pm, plan, lin(), reps), coupling_blocks=len(plan[0]))
    return out


ASSEMBLY_STAGES = ("terms", "placement", "gathers", "products", "scatter")


def assembly_split(problem, pm, plan, lin, reps: int) -> dict:
    """The dense Schur assembly (ba._dense_assemble at lambda 1e-3) stage by
    stage on the same linearization, each stage synced: `terms`
    (ba._dense_terms: the Schur terms, S's block diagonal and odometry
    blocks, Bt), `placement` (ba.placed_parts and the slabs), `gathers` (each
    group pair's two slabs), `products` (the one batched product), `scatter`
    (into S). Median ms of each over `reps` after a warm-up; the staged S
    must equal _dense_assemble's bit for bit."""
    import torch

    from vision_slam_frontend_tpu_torch.backend import ba

    lm, a, b, target, place = plan
    stages = {
        "terms": lambda _: ba._dense_terms(pm, *lin, problem, 1e-3, True)[1:],
        "placement": lambda s: (s[0], ba._compensated_slabs(ba.placed_parts(s[1], place))),
        "gathers": lambda s: (s[0], s[1][0][lm, a], s[1][1][lm, b]),
        "products": lambda s: (s[0], torch.bmm(s[1], s[2].transpose(1, 2))),
        "scatter": lambda s: ba._scatter_add_(s[0].view(-1, 36), target, -s[1].reshape(-1, 36)),
    }
    times = {k: [] for k in ASSEMBLY_STAGES}
    for rep in range(reps + 1):
        state = None
        for k in ASSEMBLY_STAGES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = stages[k](state)
            torch.cuda.synchronize()
            if rep:
                times[k].append((time.perf_counter() - t0) * 1e3)
    whole = ba_build("dense", problem, pm, plan, lin)[0]
    check_equal("staged dense assembly", state.view_as(whole), whole)
    return {k: statistics.median(v) for k, v in times.items()}


def assembly_text(t, shape: str) -> str:
    """(b) and (d)'s dense assembly line: its time and stages beside the
    former float32 coupling's recorded time."""
    split = ", ".join(f"{k} {t['split'][k]:.2f}" for k in ASSEMBLY_STAGES)
    return (f"dense assembly {t['build_ms']:.2f} ms for {t['coupling_blocks']} (landmark, pose) group pairs "
            f"(stages, each synced: {split} ms); the former float32 coupling's {BA_ASSEMBLY_MS_FLOAT32[shape]:.2f} ms "
            f"recorded")


def ba_timing_text(t) -> str:
    return (f"iteration {t['iteration_ms']:.2f} ms synced, {t['enqueue_ms']:.2f} ms enqueue; linearize "
            f"{t['linearize_ms']:.2f}, build (dense: Schur assembly; PCG: one-time products) {t['build_ms']:.2f}, "
            f"solve (Cholesky or {BA_CG_ITERATIONS} CG iterations, back-substitution) {t['solve_ms']:.2f}, "
            f"cost {t['cost_ms']:.2f} ms; "
            + ("launches not measured" if t["launches"] is None else f"{t['launches']} launches") + ", "
            + ("device time not measured" if t["device_ms"] is None else f"{t['device_ms']:.2f} ms device")
            + " per iteration; no sync inside linearize + solve")


def phase_ba_scale(dev):
    """(b) and (c): the benchmark shape, both solvers, the accuracy checks,
    the timings; then the first two dense iterations twice, bit-equal."""
    import torch

    from vision_slam_frontend_tpu_torch.backend import dense_plateau
    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, optimize
    from vision_slam_frontend_tpu_torch.backend.metrics import ate_rmse
    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
    from vision_slam_frontend_tpu_torch.io.synthetic import make_problem

    P, L, obs = BA_SCALE
    problem, gt_t, _ = make_problem(P, L, obs, return_gt=True, clean=True, device=dev)
    cam = CameraParams(fx=500.0, fy=500.0, cx=320.0, cy=240.0, R_cr=np.eye(3), t_cr=np.zeros(3)).to(dev)
    n_obs = int(problem.obs_mask.sum())
    init_ate = ate_rmse(problem.poses_t.cpu().numpy(), gt_t)
    check(init_ate > 0.05, f"the benchmark problem's initial ATE {init_ate:.4f} is not perturbed")
    out = {"shape": dict(P=P, L=L, N=n_obs, slots=problem.num_observations, Mp=int(problem.pose_obs.shape[1]),
                         Ml=int(problem.lm_obs.shape[1])), "init_ate": init_ate}
    lines = [f"P={P} L={L}, {n_obs} valid observations of {problem.num_observations} (clean), "
             f"initial ATE {init_ate:.4f} m"]
    for name, schur in (("dense", "dense"), ("pcg", "pcg_chunked")):
        solver = BASolverConfig(max_iterations=BA_ITERATIONS, schur_solver=schur, cg_iterations=BA_CG_ITERATIONS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        opt, info = optimize(problem, cam=cam, solver=solver)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        ate = ate_rmse(opt.poses_t.cpu().numpy(), gt_t)
        check(np.isfinite(info["cost"]), f"{name}: non-finite cost")
        check(ate < BA_ATE_MAX[name], f"{name}: ATE {ate:.4f} >= {BA_ATE_MAX[name]}")
        check(ate < init_ate / 2.5, f"{name}: ATE {ate:.4f} not below the initial {init_ate:.4f} / 2.5")
        check(info["accepted"] >= BA_MIN_ACCEPTED, f"{name}: {info['accepted']} accepted steps")
        h = info["history"]
        rejected = [i for i in range(1, len(h)) if h[i] == h[i - 1]]
        follows = ""
        if name == "dense":
            run = dict(cost=info["cost"], iterations=info["iterations"], rejected=rejected)
            ref = dense_plateau.REFERENCE_CPU
            follows = (f"; rejected {rejected}, the JAX package's CPU run: cost {ref['cost']:.1f}, {ref['accepted']} "
                       f"of {ref['iterations']} accepted, rejected {ref['rejected']}, ATE {ref['ate']:.4f}")
            check(dense_plateau._follows_reference(run),
                  f"dense LM does not follow the JAX package's CPU run (all {dense_plateau.ITERATIONS} iterations, "
                  f"4 to 6 rejected, cost within 1% of {ref['cost']:.1f}): cost {info['cost']:.1f} after "
                  f"{info['iterations']} iterations{follows}")
            follows += " (followed: all iterations, 4 to 6 rejected, cost within 1%)"
        times = ba_iteration_times(name, cam, problem, BA_REPS)
        out[name] = dict(ate=ate, cost=info["cost"], iterations=info["iterations"], accepted=info["accepted"],
                         rejected=rejected, seconds=elapsed, lm_it_per_s=info["iterations"] / elapsed, peak_gib=peak,
                         **times)
        lines.append(f"{name} ({schur}, cg {BA_CG_ITERATIONS}): ATE {ate:.4f} m (limit {BA_ATE_MAX[name]}), cost "
                     f"{info['cost']:.1f}, {info['accepted']} of {info['iterations']} steps accepted{follows}, in "
                     f"{elapsed:.2f} s = {info['iterations'] / elapsed:.2f} LM it/s, peak {peak:.2f} GiB; "
                     + ba_timing_text(times) + ("; " + assembly_text(times, "scale") if name == "dense" else ""))
    gap = abs(out["dense"]["ate"] - out["pcg"]["ate"])
    check(gap < BA_ATE_GAP, f"dense and PCG ATEs differ by {gap:.4f}")
    lines.append(f"ATE gap {gap:.4f} m (limit {BA_ATE_GAP})")

    two = BASolverConfig(max_iterations=2, schur_solver="dense", cg_iterations=BA_CG_ITERATIONS)
    (a, _), (b, _) = optimize(problem, cam=cam, solver=two), optimize(problem, cam=cam, solver=two)
    for field in ("poses_t", "poses_q", "landmarks"):
        check_equal(f"dense rerun {field}", getattr(a, field), getattr(b, field))
    lines.append("(c) two dense iterations twice: poses and landmarks bit-equal")
    return out, lines


def phase_ba_big(dev):
    """(d): one iteration at L=500k, N=2.5M, dense and PCG."""
    import torch

    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, optimize
    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
    from vision_slam_frontend_tpu_torch.io.synthetic import make_problem

    P, L, obs = BA_BIG
    problem = make_problem(P, L, obs, device=dev)
    cam = CameraParams(fx=500.0, fy=500.0, cx=320.0, cy=240.0, R_cr=np.eye(3), t_cr=np.zeros(3)).to(dev)
    n_obs = int(problem.obs_mask.sum())
    out = {"shape": dict(P=P, L=L, N=n_obs, slots=problem.num_observations, Mp=int(problem.pose_obs.shape[1]),
                         Ml=int(problem.lm_obs.shape[1]))}
    lines = [f"P={P} L={L}, {n_obs} valid observations of {problem.num_observations}"]
    for name, schur in (("dense", "dense"), ("pcg", "pcg_chunked")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, info = optimize(problem, cam=cam, solver=BASolverConfig(max_iterations=1, schur_solver=schur,
                                                                   cg_iterations=BA_CG_ITERATIONS))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(np.isfinite(info["cost"]), f"L={L} {name}: non-finite cost")
        times = ba_iteration_times(name, cam, problem, 1)
        out[name] = dict(seconds=elapsed, peak_gib=peak, cost=info["cost"], accepted=info["accepted"], **times)
        lines.append(f"{name}: one LM iteration in optimize {elapsed:.2f} s (set-up included), peak {peak:.2f} GiB, "
                     f"accepted {info['accepted']}; " + ba_timing_text(times)
                     + ("; " + assembly_text(times, "big") if name == "dense" else ""))
    return out, lines


def lm_histories_parting(a, b, rtol: float) -> str:
    """Two LM cost histories of one problem (card and CPU): entry by entry
    within `rtol` over their common length, and of equal length, or one
    longer by one only where the two runs part at the stop rule: the shorter
    run's last relative decrease in (0, LM_STOP_REL), so it stopped on the
    rule; the longer run's decrease at that iteration below LM_STOP_FACTOR *
    LM_STOP_REL (zero where its step was refused); and its one more entry,
    its round's last, a decrease below LM_STOP_REL. Returns how they part."""
    n = min(len(a), len(b))
    rel = float((np.abs(a[:n] - b[:n]) / np.abs(b[:n])).max())
    check(rel <= rtol, f"cost histories: entries differ by {rel:.2e} (limit {rtol})")
    if len(a) == len(b):
        return f"{n} entries each, within {rel:.2e}"
    short, longer = (a, b) if len(a) < len(b) else (b, a)

    def dec(h, i):
        return float((h[i - 1] - h[i]) / h[i - 1])

    parts = (dec(short, n - 1), dec(longer, n - 1), dec(longer, n) if len(longer) == n + 1 else float("nan"))
    text = (f"{len(a)} and {len(b)} entries, the first {n} within {rel:.2e}; relative decreases at the parting "
            f"{parts[0]:.2e} (stopped) and {parts[1]:.2e}, then {parts[2]:.2e}")
    check(len(longer) == n + 1 and 0 < parts[0] < LM_STOP_REL and 0 <= parts[1] < LM_STOP_FACTOR * LM_STOP_REL
          and 0 <= parts[2] < LM_STOP_REL, f"cost histories do not part at the LM stop rule: {text}")
    return text + " (the stop rule)"


def phase_ba_cli(npz: str, dev, tmp) -> str:
    """(e): the backend CLI on the frontend's synthetic:20 problem, card and CPU."""
    import contextlib
    import io

    from vision_slam_frontend_tpu_torch.cli.slam_backend import main as backend_main

    outs, summary = {}, []
    for where, device in (("card", str(dev)), ("cpu", "cpu")):
        outs[where] = os.path.join(tmp, f"ba_{where}.npz")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = backend_main(["--input", npz, "--output", outs[where], "--device", device])
        check(rc == 0, f"slam_backend --device {device}: exit code {rc}")
        if where == "card":
            summary = [ln for ln in buf.getvalue().splitlines() if ln.startswith(("BA problem", "BA converged"))]
    a, b = np.load(outs["card"]), np.load(outs["cpu"])
    check(sorted(a.files) == sorted(b.files), "slam_backend npz keys differ between the card and the CPU")
    for k in b.files:
        check(a[k].dtype == b[k].dtype and (a[k].shape == b[k].shape or k == "ba_cost_history"),
              f"slam_backend npz {k}: shape/dtype differ")
    parting = lm_histories_parting(a["ba_cost_history"], b["ba_cost_history"], BA_HISTORY_RTOL)
    pose = float(max(np.abs(a["nodes_loc"] - b["nodes_loc"]).max(), np.abs(a["nodes_quat"] - b["nodes_quat"]).max()))
    lm = float(np.abs(a["ba_landmarks"] - b["ba_landmarks"]).max())
    cost_a, cost_b = float(a["ba_cost_history"][-1]), float(b["ba_cost_history"][-1])
    rel = abs(cost_a - cost_b) / max(abs(cost_b), 1e-12)
    check(bool(np.isfinite(a["ba_landmarks"]).all()), "slam_backend: non-finite landmarks")
    check(pose <= BA_POSE_ATOL and lm <= BA_LM_ATOL and rel <= BA_COST_RTOL,
          f"slam_backend card vs CPU: poses {pose:.2e}, landmarks {lm:.2e}, cost rel {rel:.2e}")
    return (f"slam_backend on {MAIN_INPUT}'s problem: " + "; ".join(summary) + f" | card vs CPU: {len(a.files)} keys "
            f"with equal shapes (the cost history aside) and dtypes; cost histories: {parting}; poses max diff "
            f"{pose:.2e}, landmarks {lm:.2e}, final cost rel {rel:.2e}")


def phase_ba_first_step(dev) -> tuple[str, dict]:
    """(f): the first dense LM step at the benchmark shape, lambda 1e-3, in
    float32 and in float64 on the card (ROADMAP C's plateau)."""
    from vision_slam_frontend_tpu_torch.backend.dense_plateau import SHAPE, benchmark_problem, first_step

    problem, cam, _ = benchmark_problem(dev)
    n = first_step(problem, cam)
    check(bool(np.isfinite(n["cost32"]) and np.isfinite(n["cost64"])), f"first dense step: non-finite cost ({n})")
    P, L, _ = SHAPE
    return (f"(f) first dense LM step, P={P} L={L} clean, lambda 1e-3, float32 against float64 on the card: "
            f"pose step off by {n['step_rel_pose']:.4e} (relative norm), landmark step {n['step_rel_lm']:.4e}; "
            f"cost after the step {n['cost32']:.1f} against {n['cost64']:.1f} (rel {n['cost_rel']:.4e}); the JAX "
            f"package's step on the CPU: {BA_REFERENCE_STEP_COST_REL:.1%} in the cost after it (ROADMAP C)"), n


def phase_ba(ck, dev, npz: str, tmp, card: str):
    """Phase 7, one line per part as it ends; returns (the BA numbers, the
    launch counts of the frontend kernels while it ran: none)."""
    import torch

    ck.reset_launch_counts()
    say("7 ba", f"[{card}] torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    say("7 ba", f"(a) CPU vs CUDA, synthetic_ba_problem(P={BA_SMALL['P']}, L={BA_SMALL['L']}), "
        f"{BA_SMALL_ITERATIONS} LM iterations: " + " | ".join(phase_ba_small(dev)))
    scale, scale_lines = phase_ba_scale(dev)
    say("7 ba", f"(b), (c) [{card}] " + " | ".join(scale_lines))
    torch.cuda.empty_cache()
    big, big_lines = phase_ba_big(dev)
    say("7 ba", f"(d) [{card}] " + " | ".join(big_lines))
    torch.cuda.empty_cache()
    say("7 ba", "(e) " + phase_ba_cli(npz, dev, tmp))
    line, first_step = phase_ba_first_step(dev)
    say("7 ba", f"[{card}] " + line)
    torch.cuda.empty_cache()
    launches = ck.runs()
    check_launches("BA", launches, (), absent=tuple(KERNELS))
    return {"scale": scale, "big": big, "first_step": first_step}, launches


# ---------------------------------------------------------------------------
# Phase 8: windowed local BA and session merging
# ---------------------------------------------------------------------------

LBA_LINE = (r"\[local-ba\] applied the solve dispatched at keyframe (\d+): refined (\d+) poses "
            r"\(cost ([-\d.e+naif]+) -> ([-\d.e+naif]+), steps accepted ([01]+)\)")


def local_ba_solves(printed: str) -> dict:
    """{keyframe: (cost0, cost, accept pattern)} from the CLI's -v 2 lines."""
    import re

    return {int(m[0]): (float(m[2]), float(m[3]), m[4]) for m in re.findall(LBA_LINE, printed)}


def perf_numbers(printed: str) -> dict:
    """The CLI's [perf] lines as numbers (peak device memory: None where the
    run was not on a GPU)."""
    import re

    num = r"([\d.]+)"
    patterns = {
        "frames": rf"\[perf\] {num} stereo frames", "keyframes": rf"stereo frames, {num} keyframes",
        "seconds": rf"keyframes in {num}s", "fps": rf"\({num} frames/s", "kps": rf"frames/s, {num} keyframes/s\)",
        "p50_ms": rf"p50={num}", "p90_ms": rf"p90={num}", "p99_ms": rf"p99={num}", "max_ms": rf"max={num}",
        "peak_rss_mb": rf"peak RSS {num} MB", "peak_device_mb": rf"peak device memory {num} MB",
        "lba_first_ms": rf"first {num} ms", "lba_median_ms": rf"median {num} ms over",
        "lba_keyframes": rf"ms over {num} keyframes", "steady_fps": rf"after the first dispatch {num} frames/s",
        "steady_kps": rf"frames/s, {num} keyframes/s$",
    }
    out = {}
    for key, pat in patterns.items():
        m = re.search(pat, printed, re.M)
        check(m is not None or key == "peak_device_mb", f"CLI output has no {key} ({pat})")
        out[key] = float(m.group(1)) if m else None
    return out


def run_cli_quiet(argv, main=None) -> tuple[int, str]:
    """(exit code, printout) of `main` (default: the frontend CLI) on argv."""
    import contextlib
    import io

    if main is None:
        from vision_slam_frontend_tpu_torch.cli.slam_frontend import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def phase_lba_parity(ck, dev, tmp):
    """(a): the CLI with --local_ba on the card and on the CPU. Returns (the
    card run's launches, the card npz, the line, numbers)."""
    from vision_slam_frontend_tpu_torch.backend.local_ba import SOLVE

    argv = ["--input", MAIN_INPUT, "--local_ba", str(LBA_WINDOW), "-v", "2"]
    outs, solves = {}, {}
    for where, device in (("card", str(dev)), ("cpu", "cpu")):
        outs[where] = os.path.join(tmp, f"lba_{where}.npz")
        ck.reset_launch_counts()
        rc, printed = run_cli_quiet([*argv, "--output", outs[where], "--device", device])
        check(rc == 0, f"CLI --local_ba --device {device}: exit code {rc}")
        if where == "card":
            launches = ck.runs()
        solves[where] = local_ba_solves(printed)
    check_launches("local BA CLI", launches, ("fast_scores_nms", "extract_patches", "hamming_top2"),
                   absent=("patch_windows",))
    a, b = np.load(outs["card"]), np.load(outs["cpu"])
    check(sorted(a.files) == sorted(b.files), "local BA npz keys differ between the card and the CPU")
    n_int = 0
    for k in b.files:
        check(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, f"local BA npz {k}: shape/dtype differ")
        if a[k].dtype.kind in "iub":
            check(bool(np.array_equal(a[k], b[k])), f"local BA npz {k}: integers differ between the card and the CPU")
            n_int += 1
    check(sorted(solves["card"]) == sorted(solves["cpu"]) and len(solves["card"]) == len(a["nodes_id"]) - 3,
          f"local solves at keyframes {sorted(solves['card'])} on the card, {sorted(solves['cpu'])} on the CPU")
    decisions = sum(len(v[2]) for v in solves["cpu"].values())
    flips = sum(x != y for k in solves["cpu"] for x, y in zip(solves["card"][k][2], solves["cpu"][k][2]))
    flipped = sorted(k for k in solves["cpu"] if solves["card"][k][2] != solves["cpu"][k][2])
    pose = float(max(np.abs(a["nodes_loc"] - b["nodes_loc"]).max(), np.abs(a["nodes_quat"] - b["nodes_quat"]).max()))
    check(bool(np.isfinite(a["nodes_loc"]).all()), "local BA: non-finite poses on the card")
    check(pose <= LBA_POSE_ATOL, f"local BA card vs CPU: poses differ by {pose:.3e} m ({flips} flips), beyond "
          f"{LBA_POSE_ATOL}")
    check(flips <= LBA_MAX_FLIPS * decisions, f"local BA card vs CPU: {flips} of {decisions} decisions flip")
    agree = [k for k in solves["cpu"] if k not in flipped]
    cost_rel = max((abs(solves["card"][k][1] - solves["cpu"][k][1]) / max(solves["cpu"][k][1], 1e-12)
                    for k in agree), default=0.0)
    check(cost_rel <= LBA_COST_RTOL, f"local BA card vs CPU: a solve's final cost differs by {cost_rel:.3e} (rel)")
    line = (f"(a) CLI {MAIN_INPUT} --local_ba {LBA_WINDOW}, card against CPU: {len(a['nodes_id'])} keyframes each, "
            f"{n_int} int/bool arrays equal, {len(solves['cpu'])} local solves of {SOLVE.iters} LM iterations, "
            f"{flips} of {decisions} accept/reject decisions flipped (at keyframes {flipped}; limit "
            f"{LBA_MAX_FLIPS:.0%}), final poses max diff {pose:.3e} m (limit {LBA_POSE_ATOL}), the "
            f"{len(agree)} solves without flips: final costs max rel diff {cost_rel:.3e} (limit {LBA_COST_RTOL}); "
            f"launches {launches}")
    return launches, outs["card"], line, dict(keyframes=int(len(a["nodes_id"])), solves=len(solves["cpu"]),
                                              decisions=decisions, flips=flips, pose_diff=pose, cost_rel=cost_rel)


def soak(dev, tmp, frames: int) -> tuple[dict, str]:
    """The CLI with --local_ba in a process of its own (its RSS and device
    memory are the soak's alone): ([perf] numbers with the count of thin
    keyframes, those with fewer than LBA_TEXTURED_FEATURES features; output
    npz)."""
    out = os.path.join(tmp, f"soak{frames}.npz")
    cmd = [sys.executable, "-m", "vision_slam_frontend_tpu_torch.cli.slam_frontend",
           "--input", f"synthetic:{frames}", "--output", out, "--local_ba", str(LBA_WINDOW), "--device", str(dev)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"soak CLI exit code {proc.returncode}: {proc.stderr[-2000:]}")
    n = perf_numbers(proc.stdout)
    check(n["peak_device_mb"] is not None or dev.type != "cuda", "the soak printed no peak device memory")
    z = np.load(out)
    features = np.array([int((z["feat_node"] == i).sum()) for i in z["nodes_id"]])
    n["thin_keyframes"] = int((features < LBA_TEXTURED_FEATURES).sum())
    return n, out


# A fresh process's resident set (MB) after each stage of what the CLI
# loads, then after the CLI itself on a few frames.
BARE_PROCESS = """
import contextlib, io, json, os, tempfile
def mb():
    return int(open("/proc/self/statm").read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20
import torch
out = {"torch imported": mb()}
from vision_slam_frontend_tpu_torch.ops import _build
x = torch.ones(64, 64, device="cuda")
_build.library()
torch.linalg.cholesky_ex(x @ x.T + 64 * torch.eye(64, device="cuda"))
torch.cuda.synchronize()
out["CUDA context, kernel library, cuBLAS and cuSOLVER"] = mb()
from vision_slam_frontend_tpu_torch.cli.slam_frontend import main
with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
    main(["--input", "synthetic:6", "--output", tmp + "/p.npz", "--local_ba", "8"])
out["the CLI on synthetic:6 --local_ba 8"] = mb()
print(json.dumps(out))
"""


def rss_stages() -> dict:
    proc = subprocess.run([sys.executable, "-c", BARE_PROCESS], capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"RSS stages: exit code {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_lba_soak(dev, tmp) -> tuple[dict, str, str]:
    """(b), first half: the soak at both lengths and the RSS stages of a
    fresh process. Returns (numbers, the longer soak's output npz, line)."""
    short, _ = soak(dev, tmp, LBA_SOAK_FRAMES[0])
    n, out = soak(dev, tmp, LBA_SOAK_FRAMES[1])
    n["short"] = short
    n["rss_stages"] = stages = rss_stages()
    line = (f"(b) soak, CLI synthetic:{LBA_SOAK_FRAMES[1]} --local_ba {LBA_WINDOW} (640x480, K=512, W=10) in its own "
            f"process: {n['frames']:.0f} frames, {n['keyframes']:.0f} keyframes in {n['seconds']:.2f} s "
            f"({n['fps']:.2f} frames/s, {n['kps']:.2f} keyframes/s, warm-up included), {n['thin_keyframes']} "
            f"keyframes with fewer than {LBA_TEXTURED_FEATURES} features; warm-up: the first "
            f"keyframe's local BA {n['lba_first_ms']:.1f} ms host time against a median of {n['lba_median_ms']:.1f} ms "
            f"over {n['lba_keyframes']:.0f}; steady after it {n['steady_fps']:.2f} frames/s, {n['steady_kps']:.2f} "
            f"keyframes/s (the synthetic renderer runs on the host inside the loop); frame latency ms p50 "
            f"{n['p50_ms']} p90 {n['p90_ms']} p99 {n['p99_ms']} max {n['max_ms']}; peak RSS {n['peak_rss_mb']:.0f} "
            f"MB, peak device memory {n['peak_device_mb']} MB | at {LBA_SOAK_FRAMES[0]} frames "
            f"({short['thin_keyframes']} thin keyframes): peak RSS {short['peak_rss_mb']:.0f} MB, peak device memory "
            f"{short['peak_device_mb']} MB, p50 {short['p50_ms']} ms; growth over the last "
            f"{LBA_SOAK_FRAMES[1] - LBA_SOAK_FRAMES[0]} frames: RSS {n['peak_rss_mb'] - short['peak_rss_mb']:+.0f} MB, "
            f"device {n['peak_device_mb'] - short['peak_device_mb']:+.1f} MB | RSS of a fresh process after "
            + ", ".join(f"{k} {v:.0f} MB" for k, v in stages.items()))
    return n, out, line


def lba_window(npz: str, dev):
    """The soak's window ending at keyframe LBA_TIMING_KEYFRAMES, as that
    keyframe's dispatch builds it: (config, the SLAMProblem up to that
    keyframe, its window's device problem)."""
    from vision_slam_frontend_tpu_torch.backend.local_ba import slice_problem, window_problem
    from vision_slam_frontend_tpu_torch.io.serialize import load_problem

    from vision_slam_frontend_tpu_torch.types.slam_types import SLAMProblem

    config = make_config("orb")
    full, n = load_problem(npz), LBA_TIMING_KEYFRAMES
    problem = SLAMProblem(  # the problem as it stood when keyframe n arrived
        nodes=full.nodes[:n],
        vision_factors=[f for f in full.vision_factors if max(f.pose_idx_initial, f.pose_idx_current) < n],
        odometry_factors=[f for f in full.odometry_factors if max(f.pose_i, f.pose_j) < n],
    )
    sub = slice_problem(problem, n - LBA_WINDOW)
    return config, problem, window_problem(sub, config, LBA_WINDOW, 2, dev)


def phase_lba_solve(npz: str, dev):
    """(b), second half, and (c): one steady window solved again: synced and
    enqueue ms (median of 5), launches and device ms of one solve under
    torch.profiler; then one pipelined dispatch, replaying its bucket's
    graph, under sync-debug "error"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vision_slam_frontend_tpu_torch.backend.local_ba import SOLVE, LocalBAState, _solve_window, windowed_local_ba

    config, problem, prob = lba_window(npz, dev)
    cam = LocalBAState().camera(config, dev)
    shape = dict(P=prob.num_poses, L=prob.num_landmarks, N=prob.num_observations,
                 valid_obs=int(prob.obs_mask.sum()), valid_landmarks=int(prob.landmark_mask.sum()))
    out = _solve_window(cam, prob).cpu()  # warm-up
    check(bool(torch.isfinite(out).all()), "local solve: non-finite result")
    synced, enqueue = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        packed = _solve_window(cam, prob)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
    check(torch.equal(packed.cpu(), out), "local solve: reruns differ")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _solve_window(cam, prob)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 if device else None

    state = LocalBAState()
    for _ in range(2):  # warm-up: the bucket's first window runs eagerly, its second is captured
        windowed_local_ba(problem, config, window=LBA_WINDOW, pipeline=True, state=state, device=dev)
        state.flush()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        windowed_local_ba(problem, config, window=LBA_WINDOW, pipeline=True, state=state, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(state.in_flight, "the pipelined dispatch left nothing in flight")
    check(sum(g.call.replays for g in state._graphs.values()) == 2, "the steady dispatch was no graph replay")
    updated, info = state.flush()
    check(updated == min(LBA_WINDOW, len(problem.nodes)) - 2 and np.isfinite(info["cost"]),
          f"pipelined solve: {updated} poses, {info}")
    n = dict(window=shape, synced_ms=statistics.median(synced), enqueue_ms=statistics.median(enqueue),
             launches=launches or None, device_ms=device_ms)
    line = (f"the window ending at keyframe {LBA_TIMING_KEYFRAMES} ({shape}) solved again, {SOLVE.iters} LM x {SOLVE.cg_iters} CG iterations: "
            f"{n['synced_ms']:.2f} ms synced, {n['enqueue_ms']:.2f} ms enqueue (medians of 5); "
            + ("launches not measured" if n["launches"] is None else f"{n['launches']} launches") + ", "
            + ("device time not measured" if device_ms is None else f"{device_ms:.2f} ms device")
            + " (one solve under torch.profiler) | (c) a steady pipelined dispatch (a graph replay) under sync-debug 'error': no "
            f"host sync; its flush refined {updated} poses, cost {info['history'][0]:.1f} -> {info['cost']:.1f}")
    return n, line


def phase_merge(dev, session_a: str, tmp) -> str:
    """(d): slam_merge of two overlapping sessions (session A from (a), B a
    CLI run at another pace from the same start), on the card and the CPU."""
    from vision_slam_frontend_tpu_torch.cli.slam_merge import main as merge_main

    session_b = os.path.join(tmp, "session_b.npz")
    rc, _ = run_cli_quiet(["--input", MERGE_SESSION_B, "--output", session_b, "--device", str(dev)])
    check(rc == 0, f"CLI {MERGE_SESSION_B}: exit code {rc}")
    outs, summary = {}, []
    for where, device in (("card", str(dev)), ("cpu", "cpu")):
        import contextlib
        import io

        outs[where] = os.path.join(tmp, f"merged_{where}.npz")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = merge_main(["--inputs", session_a, session_b, "--output", outs[where], "--device", device])
        check(rc == 0, f"slam_merge --device {device}: exit code {rc}")
        if where == "card":
            summary = [ln for ln in buf.getvalue().splitlines() if ln.startswith(("Merged", "Joint BA"))]
    a, b = np.load(outs["card"]), np.load(outs["cpu"])
    check(sorted(a.files) == sorted(b.files), "slam_merge npz keys differ between the card and the CPU")
    for k in b.files:
        check(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, f"slam_merge npz {k}: shape/dtype differ")
        if a[k].dtype.kind in "iub":
            check(bool(np.array_equal(a[k], b[k])), f"slam_merge npz {k}: integers differ")
    check(bool(np.isfinite(a["ba_landmarks"]).all() and np.isfinite(a["nodes_loc"]).all()), "slam_merge: non-finite")
    pose = float(max(np.abs(a["nodes_loc"] - b["nodes_loc"]).max(), np.abs(a["nodes_quat"] - b["nodes_quat"]).max()))
    lm = float(np.abs(a["ba_landmarks"] - b["ba_landmarks"]).max())
    check(pose <= BA_POSE_ATOL and lm <= BA_LM_ATOL, f"slam_merge card vs CPU: poses {pose:.2e}, landmarks {lm:.2e}")
    return (f"(d) slam_merge of {MAIN_INPUT} --local_ba {LBA_WINDOW} and {MERGE_SESSION_B}: " + "; ".join(summary)
            + f" | card against CPU: {len(a.files)} keys with equal shapes and dtypes, integers equal, poses max diff "
            f"{pose:.2e} (limit {BA_POSE_ATOL}), landmarks {lm:.2e} (limit {BA_LM_ATOL})")


def phase_local_ba(ck, dev, tmp, card: str):
    """Phase 8, one line per part as it ends; returns (numbers, the launch
    counts of the path: the CLI's card run in (a))."""
    launches, session_a, line, parity = phase_lba_parity(ck, dev, tmp)
    say("8 local_ba", line)
    soak, soak_npz, line = phase_lba_soak(dev, tmp)
    say("8 local_ba", f"[{card}] " + line)
    solve, line = phase_lba_solve(soak_npz, dev)
    say("8 local_ba", f"[{card}] " + line)
    say("8 local_ba", phase_merge(dev, session_a, tmp))
    return {"parity": parity, "soak": soak, "solve": solve}, launches


# ---------------------------------------------------------------------------
# Phase 9: the golden loop, checkpoints through the CLI, validate
# ---------------------------------------------------------------------------


def golden_frames():
    """tests/test_golden_loop.py's rendered sequence, made once: (frames,
    rig)."""
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence

    rig = SyntheticRig(**GOLDEN_RIG)
    return list(generate_sequence(num_frames=GOLDEN_FRAMES, rig=rig, **GOLDEN_SEQUENCE)), rig


def golden_loop(family: str, frames, rig, dev) -> dict:
    """One family through TestGoldenLoop's run on `dev`: Frontend, tracks,
    BA; returns the readings each of its assertions reads."""
    from vision_slam_frontend_tpu_torch.backend import BASolverConfig, ate_rmse, build_ba_problem, optimize, rpe_rmse
    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
    from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig

    config = FrontendConfig(calib=rig.calib(), descriptor_family=family, **GOLDEN_CONFIG)
    frontend = Frontend(config, device=dev)
    t0 = time.perf_counter()
    gt_pos = []
    for f in frames:
        frontend.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        if frontend.observe_image(f.left, f.right, f.timestamp):
            gt_pos.append(f.cam_pos.copy())
    problem = frontend.get_slam_problem()
    t1 = time.perf_counter()
    gt_pos = np.stack(gt_pos)
    ba = build_ba_problem(problem, left_cam_to_robot=np.asarray(config.left_cam_to_robot), min_track_length=2,
                          device=dev)
    opt, info = optimize(ba, cam=CameraParams.from_config(config, device=dev),
                         solver=BASolverConfig(max_iterations=15, trim_threshold=8.0))
    poses_odom = ba.poses_t.double().cpu().numpy()
    poses_ba = opt.poses_t.double().cpu().numpy()
    s = frontend.stats_summary()
    return dict(
        keyframes=frontend.get_num_poses(), features_mean=s["features_mean"], features_min=s["features_min"],
        landmarks=int(ba.landmark_mask.sum()), observations=int(ba.obs_mask.sum()),
        ate_odom=ate_rmse(poses_odom, gt_pos, align=False), ate_ba=ate_rmse(poses_ba, gt_pos, align=False),
        rpe_odom=rpe_rmse(poses_odom, gt_pos), rpe_ba=rpe_rmse(poses_ba, gt_pos),
        cost0=float(info["history"][0]), cost=float(info["cost"]), iterations=int(info["iterations"]),
        frontend_s=t1 - t0, ba_s=time.perf_counter() - t1,
    )


def golden_failures(family: str, r: dict) -> list[str]:
    """TestGoldenLoop's assertions on one family's readings, as the failed
    ones' descriptions (tests/test_golden_loop.py's four tests)."""
    g = FAMILY_GOLDEN[family]
    checks = [
        (GOLDEN_FRAMES - 5 <= r["keyframes"] <= GOLDEN_FRAMES - 1,
         f"keyframes {r['keyframes']} outside [{GOLDEN_FRAMES - 5}, {GOLDEN_FRAMES - 1}]"),
        (r["features_mean"] > g["min_feats_mean"], f"features_mean {r['features_mean']} <= {g['min_feats_mean']}"),
        (r["features_min"] > g["min_feats_min"], f"features_min {r['features_min']} <= {g['min_feats_min']}"),
        (r["landmarks"] > g["min_landmarks"], f"landmarks {r['landmarks']} <= {g['min_landmarks']}"),
        (r["observations"] > g["min_obs"], f"observations {r['observations']} <= {g['min_obs']}"),
        (r["observations"] / max(r["landmarks"], 1) > 2.5, "observations per landmark <= 2.5"),
        (0.05 < r["ate_odom"] < 0.6, f"odometry ATE {r['ate_odom']} outside (0.05, 0.6)"),
        (bool(np.isfinite(r["cost"])), "non-finite BA cost"),
        (r["cost"] < 0.1 * r["cost0"], f"BA cost {r['cost']} not below a tenth of {r['cost0']}"),
        (r["ate_ba"] < g["ate_ba_max"], f"BA ATE {r['ate_ba']} >= {g['ate_ba_max']}"),
    ]
    if g["beats_odom"]:
        checks += [(r["ate_ba"] < r["ate_odom"], f"BA ATE {r['ate_ba']} not below odometry's {r['ate_odom']}"),
                   (r["rpe_ba"] < r["rpe_odom"], f"BA RPE {r['rpe_ba']} not below odometry's {r['rpe_odom']}")]
    return [msg for ok, msg in checks if not ok]


def golden_line(family: str, r: dict) -> str:
    g = FAMILY_GOLDEN[family]
    return (f"{family}: {r['keyframes']} keyframes, features mean {r['features_mean']:.1f} (pin > "
            f"{g['min_feats_mean']}) min {r['features_min']} (> {g['min_feats_min']}), landmarks {r['landmarks']} "
            f"(> {g['min_landmarks']}), observations {r['observations']} (> {g['min_obs']}), ATE odometry "
            f"{r['ate_odom']:.4f} BA {r['ate_ba']:.4f} (< {g['ate_ba_max']}"
            + (f", and below odometry; RPE {r['rpe_ba']:.4f} < {r['rpe_odom']:.4f}" if g["beats_odom"] else "")
            + f"), cost {r['cost0']:.1f} -> {r['cost']:.1f} in {r['iterations']} iterations; frontend "
            f"{r['frontend_s']:.1f} s, BA {r['ba_s']:.1f} s")


def phase_golden(ck, dev, card: str) -> tuple[dict, dict]:
    """(a): every family through the golden loop on the card. Returns
    (readings per family, launch counts of the path)."""
    t0 = time.perf_counter()
    frames, rig = golden_frames()
    say("9 golden", f"(a) rendered the {GOLDEN_FRAMES} frames of tests/test_golden_loop.py in "
        f"{time.perf_counter() - t0:.1f} s")
    readings, failed = {}, []
    ck.reset_launch_counts()
    for family in FAMILY_GOLDEN:
        r = readings[family] = golden_loop(family, frames, rig, dev)
        failures = golden_failures(family, r)
        failed += [f"{family}: {m}" for m in failures]
        say("9 golden", f"(a) [{card}] " + golden_line(family, r)
            + ("; every pin met" if not failures else "; MISSED: " + "; ".join(failures)))
    launches = ck.runs()
    check(not failed, "golden loop pins missed: " + "; ".join(failed))
    check_launches("golden loop", launches, ("fast_scores_nms", "extract_patches", "hamming_top2"),
                   absent=("patch_windows",))
    return readings, launches


def same_problem(what: str, a_npz: str, b_npz: str) -> str:
    """Two runs on one device: the same keys, dtypes and values."""
    a, b = np.load(a_npz), np.load(b_npz)
    check(sorted(a.files) == sorted(b.files), f"{what}: npz keys differ")
    for k in b.files:
        check(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), f"{what}: npz {k} differs")
    return f"{len(a['nodes_id'])} nodes, {len(a['feat_node'])} features, {len(a['vfm_factor'])} matches equal"


def phase_checkpoint_cli(ck, dev, tmp) -> tuple[str, dict]:
    """(b): the CLI on the card with --checkpoint_every then --resume, and
    with --interrupt_after then --resume, against the uninterrupted run.
    Returns (line, launch counts)."""
    run = lambda *argv: run_cli_quiet(["--input", CKPT_INPUT, "--device", str(dev), *argv])
    out = {k: os.path.join(tmp, f"ckpt_{k}.npz") for k in ("full", "every", "resumed_every", "cut", "resumed_cut")}
    ck.reset_launch_counts()
    rc, _ = run("--output", out["full"])
    check(rc == 0, f"CLI {CKPT_INPUT}: exit code {rc}")
    rc, printed = run("--output", out["every"], "--checkpoint_every", str(CKPT_EVERY), "-v", "1")
    check(rc == 0 and f"[checkpoint] {CKPT_EVERY} poses" in printed, f"--checkpoint_every: exit code {rc}")
    rc, printed = run("--output", out["resumed_every"], "--resume", out["every"] + ".ckpt.npz")
    check(rc == 0 and "Resumed from" in printed, f"--resume after --checkpoint_every: exit code {rc}")
    every = same_problem("--checkpoint_every then --resume", out["resumed_every"], out["full"])
    rc, printed = run("--output", out["cut"], "--interrupt_after", str(CKPT_INTERRUPT_AFTER))
    check(rc == 130 and "SIGINT" in printed, f"--interrupt_after: exit code {rc} (130 expected)")
    check(os.path.exists(out["cut"]) and os.path.exists(out["cut"] + ".ckpt.npz"),
          "--interrupt_after left no partial problem or no checkpoint")
    n_cut = len(np.load(out["cut"])["nodes_id"])
    rc, _ = run("--output", out["resumed_cut"], "--resume", out["cut"] + ".ckpt.npz")
    check(rc == 0, f"--resume after the interrupt: exit code {rc}")
    cut = same_problem("--interrupt_after then --resume", out["resumed_cut"], out["full"])
    launches = ck.runs()
    check_launches("checkpoint CLI", launches, ("fast_scores_nms", "extract_patches", "hamming_top2"),
                   absent=("patch_windows",))
    return (f"(b) CLI {CKPT_INPUT} on the card: --checkpoint_every {CKPT_EVERY} then --resume from its last "
            f"checkpoint: {every} with the uninterrupted run; --interrupt_after {CKPT_INTERRUPT_AFTER}: exit 130 "
            f"with {n_cut} nodes and a checkpoint, then --resume: {cut}; launches {launches}"), launches


def phase_validate(ck, dev, tmp) -> tuple[str, dict]:
    """(c): --validate for ORB and SIFT on phase 5's inputs: no violation,
    and the problem of the unvalidated runs of phase 5."""
    parts = []
    ck.reset_launch_counts()
    for fam, inp in (("orb", MAIN_INPUT), ("sift", FAMILY_INPUT)):
        out = os.path.join(tmp, f"{fam}_validated.npz")
        rc, _ = run_cli_quiet(["--input", inp, "--descriptor_family", fam, "--validate", "--output", out,
                               "--device", str(dev)])
        check(rc == 0, f"CLI --validate {fam}: exit code {rc}")
        parts.append(f"{fam} {inp}: " + same_problem(f"--validate {fam}", out, os.path.join(tmp, f"{fam}_gpu.npz")))
    launches = ck.runs()
    check_launches("validate CLI", launches, ("fast_scores_nms", "extract_patches", "hamming_top2"),
                   absent=("patch_windows",))
    return "(c) --validate on the card, every keyframe checked, none failed: " + "; ".join(parts) + \
        f" with phase 5's unvalidated runs; launches {launches}", launches

# ---------------------------------------------------------------------------
# Phase 10: the real inputs
# ---------------------------------------------------------------------------


def decode_pair_ms(bag: str) -> tuple[float, float, int]:
    """(first pair's ms, median ms, pairs) of host decode of `bag`'s stereo
    pairs through io/image.decode_compressed_image."""
    from vision_slam_frontend_tpu_torch.io import rosbag
    from vision_slam_frontend_tpu_torch.io.image import decode_compressed_image

    images = [m for _, _, m in rosbag.read_messages(bag) if "data" in m]  # left, right, left, ...
    ms = []
    for left, right in zip(images[0::2], images[1::2]):
        t0 = time.perf_counter()
        a, b = decode_compressed_image(left), decode_compressed_image(right)
        ms.append((time.perf_counter() - t0) * 1e3)
        check(a.shape == b.shape == (480, 640), f"decoded pair of shape {a.shape}, {b.shape}")
    return ms[0], statistics.median(ms), len(ms)


def bag_readings(npz: str, gt: dict, config, dev) -> dict:
    """tests/test_golden_bag.py's readings of one CLI run: keyframes,
    features per node, tracks, odometry and BA ATE."""
    import torch

    from vision_slam_frontend_tpu_torch.backend import BASolverConfig, ate_rmse, build_ba_problem, optimize
    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
    from vision_slam_frontend_tpu_torch.io.serialize import load_problem

    problem = load_problem(npz)
    feats = [len(n.features) for n in problem.nodes]
    t0 = time.perf_counter()
    ba = build_ba_problem(problem, left_cam_to_robot=np.asarray(config.left_cam_to_robot), min_track_length=2,
                          device=dev)
    gt_pos = np.stack([gt[round(n.timestamp, 6)] for n in problem.nodes])
    opt, info = optimize(ba, cam=CameraParams.from_config(config, device=dev),
                         solver=BASolverConfig(max_iterations=15, trim_threshold=8.0))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return dict(
        keyframes=len(problem.nodes), features_mean=float(np.mean(feats)), features_min=int(min(feats)),
        landmarks=int(ba.landmark_mask.sum()), observations=int(ba.obs_mask.sum()),
        ate_odom=ate_rmse(ba.poses_t.double().cpu().numpy(), gt_pos, align=False),
        ate_ba=ate_rmse(opt.poses_t.double().cpu().numpy(), gt_pos, align=False),
        cost0=float(info["history"][0]), cost=float(info["cost"]), iterations=int(info["iterations"]),
        ba_s=time.perf_counter() - t0,
    )


def bag_failures(family: str, r: dict) -> list[str]:
    """TestDegradedBagGolden's assertions on one family's readings, as the
    failed ones' descriptions (tests/test_golden_bag.py's three tests)."""
    g = BAG_GOLDEN[family]
    checks = [
        (r["keyframes"] >= BAG_FRAMES - 6, f"keyframes {r['keyframes']} < {BAG_FRAMES - 6}"),
        (r["features_mean"] > g["min_feats_mean"], f"features_mean {r['features_mean']} <= {g['min_feats_mean']}"),
        (r["features_min"] > g["min_feats_min"], f"features_min {r['features_min']} <= {g['min_feats_min']}"),
        (r["landmarks"] > g["min_landmarks"], f"landmarks {r['landmarks']} <= {g['min_landmarks']}"),
        (r["observations"] / max(r["landmarks"], 1) > 2.0, "observations per landmark <= 2"),
        (0.03 < r["ate_odom"] < 0.6, f"odometry ATE {r['ate_odom']} outside (0.03, 0.6)"),
        (bool(np.isfinite(r["cost"])), "non-finite BA cost"),
        (r["ate_ba"] < r["ate_odom"], f"BA ATE {r['ate_ba']} not below odometry's {r['ate_odom']}"),
        (r["ate_ba"] < g["ate_ba_max"], f"BA ATE {r['ate_ba']} >= {g['ate_ba_max']}"),
    ]
    return [msg for ok, msg in checks if not ok]


def prefix_int_fields(npz: str, n: int) -> dict:
    """The int and bool fields of a problem npz for its first `n` nodes (what
    a run stopped at n keyframes writes)."""
    z = np.load(npz)
    ids = z["nodes_id"][:n]
    vf = np.isin(z["vf_pose_current"], ids)
    masks = {"feat_": np.isin(z["feat_node"], ids), "vfm_": np.isin(z["vfm_factor"], np.flatnonzero(vf)),
             "vf_": vf, "of_": np.isin(z["of_pose_j"], ids)}
    out = {"nodes_id": ids, "format_version": z["format_version"]}
    for k in z.files:
        if z[k].dtype.kind in "iub" and k not in out:
            prefix = next((p for p in masks if k.startswith(p)), None)
            check(prefix is not None, f"npz int field {k} has no prefix rule")
            out[k] = z[k][masks[prefix]]
    return out


def phase_bag_golden(ck, dev, tmp, route: str, card: str) -> tuple[dict, dict, str]:
    """(b): tests/test_golden_bag.py on the card. The port writes the
    degraded bag and saves its config; the CLI runs every family with
    --config, then tracks and BA; the ORB run's int fields and track ids
    equal a CPU run's over the first BAG_CPU_POSES keyframes. Returns
    (readings per family, ORB launches, bag path)."""
    from vision_slam_frontend_tpu_torch.frontend import FrontendConfig
    from vision_slam_frontend_tpu_torch.io.degrade import write_degraded_bag
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig

    t0 = time.perf_counter()
    rig = SyntheticRig(**GOLDEN_RIG)
    bag = os.path.join(tmp, "degraded.bag")
    gt = write_degraded_bag(bag, rig=rig, num_frames=BAG_FRAMES, odom_drift=BAG_ODOM_DRIFT,
                            jpeg_quality=BAG_JPEG_QUALITY, seed=BAG_SEED)
    config = FrontendConfig(calib=rig.calib(), **BAG_CONFIG)
    cfg = os.path.join(tmp, "rig.yaml")
    config.save(cfg)
    say("10 inputs", f"(b) wrote tests/test_golden_bag.py's bag ({BAG_FRAMES} frames, 512x384, JPEG quality "
        f"{BAG_JPEG_QUALITY}, seed {BAG_SEED}, odometry drift {BAG_ODOM_DRIFT}; {os.path.getsize(bag) / 2**20:.1f} MB) "
        f"and its config in {time.perf_counter() - t0:.1f} s")
    readings, failed, launches = {}, [], None
    for family in BAG_GOLDEN:
        out = os.path.join(tmp, f"bag_{family}.npz")
        argv = ["--input", bag, "--config", cfg, "--descriptor_family", family, "--output", out, "-v", "1"]
        ck.reset_launch_counts()
        t1 = time.perf_counter()
        rc, printed = run_cli_quiet(argv + ["--device", str(dev)])
        frontend_s = time.perf_counter() - t1
        check(rc == 0, f"CLI on the degraded bag, {family}: exit code {rc}")
        check(f"[decode] {route}" in printed, f"CLI {family} did not decode with {route}: {printed[:300]}")
        if family == "orb":
            launches = ck.runs()
            check_launches("degraded bag, orb", launches, ("fast_scores_nms", "extract_patches", "hamming_top2"),
                           absent=("patch_windows",))
        r = readings[family] = bag_readings(out, gt, config, dev)
        r["frontend_s"] = frontend_s
        failures = bag_failures(family, r)
        failed += [f"{family}: {m}" for m in failures]
        g = BAG_GOLDEN[family]
        say("10 inputs", f"(b) [{card}] {family}: {r['keyframes']} keyframes (pin >= {BAG_FRAMES - 6}), features mean "
            f"{r['features_mean']:.1f} (> {g['min_feats_mean']}) min {r['features_min']} (> {g['min_feats_min']}), "
            f"landmarks {r['landmarks']} (> {g['min_landmarks']}), observations {r['observations']} "
            f"({r['observations'] / max(r['landmarks'], 1):.2f} per landmark, > 2), ATE odometry {r['ate_odom']:.4f} "
            f"(0.03, 0.6) BA {r['ate_ba']:.4f} (< {g['ate_ba_max']} and below odometry), cost {r['cost0']:.1f} -> "
            f"{r['cost']:.1f} in {r['iterations']} iterations; CLI {frontend_s:.1f} s (decode included), BA "
            f"{r['ba_s']:.1f} s" + ("; every pin met" if not failures else "; MISSED: " + "; ".join(failures)))
    check(not failed, "degraded-bag pins missed: " + "; ".join(failed))
    cpu_out = os.path.join(tmp, "bag_orb_cpu.npz")
    t1 = time.perf_counter()
    rc, _ = run_cli_quiet(["--input", bag, "--config", cfg, "--output", cpu_out, "--device", "cpu",
                           "--max_poses", str(BAG_CPU_POSES)])
    check(rc == 0, f"CPU CLI on the degraded bag: exit code {rc}")
    card, host = prefix_int_fields(os.path.join(tmp, "bag_orb.npz"), BAG_CPU_POSES), prefix_int_fields(cpu_out, 10**9)
    check(sorted(card) == sorted(host), "int fields differ between the card's and the CPU's npz")
    for k in host:
        check_equal_arrays(f"degraded bag orb, first {BAG_CPU_POSES} keyframes: {k} card vs CPU", card[k], host[k])
    say("10 inputs", f"(b) orb on the card vs the CPU over the first {BAG_CPU_POSES} keyframes of the same bag: "
        f"{len(host)} int and bool fields equal ({len(host['feat_track'])} track ids, {len(host['vfm_factor'])} "
        f"matches; CPU run {time.perf_counter() - t1:.1f} s); orb launches {launches}")
    return readings, launches, bag


RATE_PROCESS = r"""
import contextlib, io, json, sys
from vision_slam_frontend_tpu_torch.cli.slam_frontend import main
argv = json.loads(sys.argv[1])
runs = []
for mode in ("warm-up", "prefetch", "no_prefetch", "no_prefetch", "prefetch"):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv + (["--no_prefetch"] if mode == "no_prefetch" else []))
    runs.append({"mode": mode, "rc": rc, "printed": buf.getvalue()})
print(json.dumps(runs))
"""


def rate_numbers(printed: str) -> dict:
    import re

    num = r"([\d.]+)"
    out = {}
    for key, pat in {"frames": rf"\[perf\] {num} stereo frames", "keyframes": rf"stereo frames, {num} keyframes",
                     "seconds": rf"keyframes in {num}s", "fps": rf"\({num} frames/s", "p50_ms": rf"p50={num}",
                     "p90_ms": rf"p90={num}", "p99_ms": rf"p99={num}", "max_ms": rf"max={num}",
                     "peak_rss_mb": rf"peak RSS {num} MB", "peak_device_mb": rf"peak device memory {num} MB"}.items():
        m = re.search(pat, printed)
        check(m is not None or key == "peak_device_mb", f"CLI output has no {key}")
        out[key] = float(m.group(1)) if m else None
    return out


def phase_bag_rate(dev, tmp, card: str) -> tuple[dict, str]:
    """(c): bench.py's end-to-end degraded-bag rate: the CLI on a 150-frame
    640x480 bag (K=512, W=10) in a process of its own, a warm-up run, then
    with and without the decode-ahead thread in turns. Returns (numbers,
    bag path)."""
    from vision_slam_frontend_tpu_torch.frontend import FrontendConfig
    from vision_slam_frontend_tpu_torch.io.degrade import write_degraded_bag
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig

    t0 = time.perf_counter()
    bag = os.path.join(tmp, "rate.bag")
    write_degraded_bag(bag, rig=SyntheticRig(), num_frames=RATE_FRAMES)
    cfg = os.path.join(tmp, "rate.yaml")
    FrontendConfig(calib=SyntheticRig().calib(), **RATE_CONFIG).save(cfg)
    written_s = time.perf_counter() - t0
    argv = ["--input", bag, "--config", cfg, "--output", os.path.join(tmp, "rate.npz"), "--device", str(dev)]
    proc = subprocess.run([sys.executable, "-c", RATE_PROCESS, json.dumps(argv)], capture_output=True, text=True,
                          timeout=900, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"bag-rate process exit code {proc.returncode}: {proc.stderr[-2000:]}")
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    numbers = {"bag_written_s": written_s, "runs": []}
    for r in runs:
        check(r["rc"] == 0, f"bag-rate CLI ({r['mode']}) exit code {r['rc']}")
        n = rate_numbers(r["printed"])
        check(n["frames"] == RATE_FRAMES, f"bag-rate CLI ({r['mode']}) saw {n['frames']} frames")
        check(n["peak_device_mb"] is not None or dev.type != "cuda", "the bag-rate CLI printed no device memory")
        numbers["runs"].append(dict(mode=r["mode"], **n))
    measured = numbers["runs"][1:]
    for mode in ("prefetch", "no_prefetch"):
        numbers[mode + "_fps"] = [x["fps"] for x in measured if x["mode"] == mode]
    first_ms, median_ms, pairs = decode_pair_ms(bag)
    numbers.update(decode_first_pair_ms=first_ms, decode_pair_ms=median_ms, decode_pairs=pairs)
    line = (f"(c) [{card}] end-to-end bag rate, CLI on a {RATE_FRAMES}-frame 640x480 degraded bag (K=512, W=10, "
            f"fast 12; written in {written_s:.1f} s) in its own process, runs in turns: " + "; ".join(
                f"{x['mode']} {x['fps']:.2f} frames/s ({x['keyframes']:.0f} keyframes in {x['seconds']:.2f} s), "
                f"latency ms p50 {x['p50_ms']} p90 {x['p90_ms']} p99 {x['p99_ms']} max {x['max_ms']}, peak RSS "
                f"{x['peak_rss_mb']:.0f} MB, peak device {x['peak_device_mb']} MB" for x in numbers["runs"])
            + f" | host decode of one 640x480 JPEG pair: first {first_ms:.2f} ms, median {median_ms:.2f} ms over "
            f"{pairs} pairs")
    return numbers, line


def compare_exports(gpu: dict, cpu: dict) -> str:
    """The card's --output_bag, --ply and --html against the CPU's: the bag
    read back through deserialize_slam_problem equals its own npz and, in
    ids and matches, the CPU's; PLY and HTML counts and node positions
    equal, landmarks within 1e-3 relative."""
    import re

    from vision_slam_frontend_tpu_torch.io import rosbag
    from vision_slam_frontend_tpu_torch.io.ros_msgs import deserialize_slam_problem

    probs = {}
    for name, paths in (("card", gpu), ("cpu", cpu)):
        msgs = list(rosbag.read_messages(paths["bag"], raw=True))
        check([m[0] for m in msgs] == ["extrinsics", "intrinsics", "slam_problem"], f"{name} output bag topics")
        probs[name] = p = deserialize_slam_problem(msgs[2][2]["raw"])
        z = np.load(paths["npz"])
        check_equal_arrays(f"{name} output bag node ids vs npz", np.array([n.node_idx for n in p.nodes], np.int64),
                           z["nodes_id"])
        check_equal_arrays(f"{name} output bag feature ids vs npz",
                           np.array([f.feature_idx for n in p.nodes for f in n.features], np.int64), z["feat_idx"])
        check(np.allclose(np.stack([n.pose.loc for n in p.nodes]), z["nodes_loc"], atol=1e-7),
              f"{name} output bag poses differ from its npz")
        check(np.allclose(np.array([f.pixel for n in p.nodes for f in n.features]), z["feat_pixel"], atol=1e-4),
              f"{name} output bag pixels differ from its npz")
    match = lambda p: [(v.pose_idx_initial, v.pose_idx_current, [(m.feature_idx_initial, m.feature_idx_current)
                                                                  for m in v.feature_matches]) for v in p.vision_factors]
    check(match(probs["card"]) == match(probs["cpu"]), "output bag vision factors differ card vs CPU")
    heads, verts = [], []
    for paths in (gpu, cpu):
        data = open(paths["ply"], "rb").read()
        end = data.index(b"end_header\n") + len(b"end_header\n")
        heads.append(data[:end])
        n = int(re.search(rb"element vertex (\d+)", data).group(1))
        verts.append((np.frombuffer(data[end:end + 15 * n], np.dtype([("xyz", "<f4", 3), ("rgb", "u1", 3)])),
                      data[end + 15 * n:]))
    check(heads[0] == heads[1], "PLY headers differ card vs CPU")
    check(verts[0][1] == verts[1][1] and np.array_equal(verts[0][0]["rgb"], verts[1][0]["rgb"]),
          "PLY edges or colours differ card vs CPU")
    check(np.allclose(verts[0][0]["xyz"], verts[1][0]["xyz"], rtol=1e-3, atol=1e-4), "PLY vertices differ card vs CPU")
    stats = [re.search(r"<div id=\"hud\">[^<]*<br>([^<]*)<br>", open(p["html"]).read()).group(1) for p in (gpu, cpu)]
    check(stats[0] == stats[1], f"HTML viewer counts differ card vs CPU: {stats}")
    n_vert = int(re.search(rb"element vertex (\d+)", heads[0]).group(1))
    return (f"--output_bag read back: {len(probs['card'].nodes)} nodes, ids, matches and poses equal its npz and the "
            f"CPU's; --ply {n_vert} vertices within 1e-3; --html '{stats[0]}' as on the CPU")


def phase_datasets(ck, dev, tmp, golden_bag: str) -> tuple[str, dict]:
    """(d): tests/test_io.py's 5-frame KITTI and EuRoC inputs through the
    CLI on the card and on the CPU (KITTI with --output_bag, --ply and
    --html), and bag_extract. Returns (line, launches of the KITTI run)."""
    from vision_slam_frontend_tpu_torch.cli.bag_extract import main as extract
    from vision_slam_frontend_tpu_torch.io import euroc, kitti, rosbag
    from vision_slam_frontend_tpu_torch.io.image import decode_compressed_image, load_gray
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence

    rig = SyntheticRig()
    frames = list(generate_sequence(num_frames=DATASET_FRAMES, step=0.25, rig=rig))
    kdir, edir = os.path.join(tmp, "kitti", "05"), os.path.join(tmp, "euroc")
    kitti.write_sequence(kdir, frames, rig)
    euroc.write_directory(edir, frames, rig)
    parts, launches = [], {}
    paths = {d: {k: os.path.join(tmp, f"kitti_{d}.{k}") for k in ("npz", "bag", "ply", "html")}
             for d in ("card", "cpu")}
    for d, device in (("card", dev), ("cpu", "cpu")):
        ck.reset_launch_counts()
        rc, _ = run_cli_quiet(["--input", kdir, "--dataset", "kitti", *DATASET_ARGS, "--output", paths[d]["npz"],
                               "--output_bag", paths[d]["bag"], "--ply", paths[d]["ply"], "--html", paths[d]["html"],
                               "--device", str(device)])
        check(rc == 0, f"CLI on KITTI ({d}): exit code {rc}")
        if d == "card":
            launches = ck.runs()
            check_launches("KITTI", launches, ("fast_scores_nms", "extract_patches", "hamming_top2"))
    z = np.load(paths["card"]["npz"])
    check(len(z["nodes_id"]) == DATASET_FRAMES - 1 and np.bincount(z["feat_node"]).min() > 20,
          f"KITTI: {len(z['nodes_id'])} nodes, features per node {np.bincount(z['feat_node'])}")
    parts.append(f"KITTI --dataset kitti: {compare_problems(paths['card']['npz'], paths['cpu']['npz'])}; "
                 + compare_exports(paths["card"], paths["cpu"]))
    summary, e_launches, n, agree = run_cli(ck, ["--input", edir, *DATASET_ARGS], dev, tmp, "euroc")
    check_launches("EuRoC", e_launches, ("fast_scores_nms", "extract_patches", "hamming_top2"))
    z = np.load(os.path.join(tmp, "euroc_gpu.npz"))
    check(n == DATASET_FRAMES - 1 and np.bincount(z["feat_node"]).min() > 20, f"EuRoC: {n} nodes")
    parts.append(f"EuRoC (auto-detected): {agree}")
    out_dir = os.path.join(tmp, "extracted")
    rc, printed = run_cli_quiet(["--input", golden_bag, "--output_dir", out_dir, "--max_images", "3"], extract)
    check(rc == 0 and "Extracted 3 images" in printed, f"bag_extract: exit code {rc}")
    images = [m for _, _, m in rosbag.read_messages(golden_bag, topics=["/stereo/left/image_raw/compressed"])][:3]
    diffs = [float(np.abs(load_gray(os.path.join(out_dir, f"{i:06d}.jpg")) - decode_compressed_image(m)).mean())
             for i, m in enumerate(images)]
    check(sorted(os.listdir(out_dir)) == [f"{i:06d}.jpg" for i in range(3)] and max(diffs) < 2.0,
          f"bag_extract files {sorted(os.listdir(out_dir))}, mean abs differences {diffs}")
    parts.append(f"bag_extract: 3 images, mean abs difference to the bag's decoded frames {max(diffs):.2f} at most")
    return "(d) " + " | ".join(parts) + f"; KITTI card launches {launches}", launches


def condition_frames(name: str):
    """tests/test_adversarial_conditions.py's rendered, degraded frames of
    one condition: (rig, frames)."""
    from vision_slam_frontend_tpu_torch.io.degrade import Degrader
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence

    spec = CONDITIONS[name]
    deg = Degrader(**spec["degrader"])
    contrast = spec.get("contrast", 1.0)
    rig = SyntheticRig(**GOLDEN_RIG)
    frames = []
    for i, f in enumerate(generate_sequence(num_frames=CONDITION_FRAMES, rig=rig, odom_drift=0.015, seed=11,
                                            **spec["seq"])):
        left, right = deg(f.left, i, cam=0), deg(f.right, i, cam=1)
        if contrast != 1.0:
            left = 120.0 + contrast * (left - 120.0)
            right = 120.0 + contrast * (right - 120.0)
        frames.append((left, right, f.odom_translation, f.odom_rotation, f.timestamp, f.cam_pos.copy()))
    return rig, frames


def survival(name: str, family: str, rig, frames, dev) -> tuple[dict, list[str]]:
    """test_condition_survival's run and assertions on the card."""
    from vision_slam_frontend_tpu_torch.backend import BASolverConfig, ate_rmse, build_ba_problem, optimize
    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
    from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig

    config = FrontendConfig(calib=rig.calib(), max_features=256, frame_life=8, fast_threshold=8.0,
                            descriptor_family=family)
    fe = Frontend(config, device=dev)
    gt = []
    for left, right, odom_t, odom_q, t, cam_pos in frames:
        fe.observe_odometry(odom_t, odom_q, t)
        if fe.observe_image(left, right, t):
            gt.append(cam_pos)
    r = dict(poses=fe.get_num_poses(), features_mean=fe.stats_summary()["features_mean"])
    failures = []
    if r["poses"] < CONDITION_FRAMES - 6:
        failures.append(f"{r['poses']} poses")
    if not r["features_mean"] > 25:
        failures.append(f"features_mean {r['features_mean']}")
    ba = build_ba_problem(fe.get_slam_problem(), left_cam_to_robot=np.asarray(config.left_cam_to_robot),
                          min_track_length=2, device=dev)
    r["landmarks"] = int(ba.landmark_mask.sum())
    if r["landmarks"] < 20:
        return r, failures + ["almost no landmarks survived"]
    opt, info = optimize(ba, cam=CameraParams.from_config(config, device=dev),
                         solver=BASolverConfig(max_iterations=10, trim_threshold=8.0))
    gt = np.stack(gt)
    r["ate_odom"] = ate_rmse(ba.poses_t.double().cpu().numpy(), gt, align=False)
    r["ate_ba"] = ate_rmse(opt.poses_t.double().cpu().numpy(), gt, align=False)
    if not np.isfinite(info["cost"]):
        failures.append("non-finite BA cost")
    if not r["ate_ba"] < max(2.0 * r["ate_odom"], 0.25):
        failures.append(f"BA ATE {r['ate_ba']:.4f} >= max(2 x odometry {r['ate_odom']:.4f}, 0.25)")
    return r, failures


def phase_conditions(ck, dev, card: str) -> tuple[dict, dict]:
    """(e): the 6x5 survival matrix of tests/test_adversarial_conditions.py
    on the card. Returns (readings, launches)."""
    readings, failed = {}, []
    ck.reset_launch_counts()
    for name in sorted(CONDITIONS):
        t0 = time.perf_counter()
        rig, frames = condition_frames(name)
        render_s = time.perf_counter() - t0
        cells = []
        for family in CONDITION_FAMILIES:
            t1 = time.perf_counter()
            r, failures = survival(name, family, rig, frames, dev)
            r["seconds"] = time.perf_counter() - t1
            readings[f"{name}/{family}"] = r
            failed += [f"{name}/{family}: {m}" for m in failures]
            cells.append(f"{family} {r['poses']} poses, features {r['features_mean']:.1f}, landmarks {r['landmarks']}"
                         + (f", ATE {r['ate_odom']:.3f} -> {r['ate_ba']:.3f}" if "ate_ba" in r else "")
                         + (" ok" if not failures else " FAILED: " + "; ".join(failures)) + f" ({r['seconds']:.1f} s)")
        say("10 inputs", f"(e) [{card}] {name} (rendered and degraded in {render_s:.1f} s): " + "; ".join(cells))
    launches = ck.runs()
    check(not failed, "survival matrix failed: " + "; ".join(failed))
    check_launches("survival matrix", launches, ("fast_scores_nms", "extract_patches", "hamming_top2"),
                   absent=("patch_windows",))
    say("10 inputs", f"(e) survival matrix: {len(readings)} of {len(CONDITIONS) * len(CONDITION_FAMILIES)} cells "
        f"passed; launches {launches}")
    return readings, launches


def phase_inputs(ck, dev, card: str, keep: str) -> tuple[dict, dict]:
    """Phase 10: the decode route, the degraded-bag golden pins, the bag
    rate (its bag and config written into `keep`, which phase 12 reads),
    KITTI, EuRoC and the exports, the survival matrix. Returns (numbers,
    {path: launches})."""
    from vision_slam_frontend_tpu_torch.io import image, native_loader

    route = CARD_DECODE_ROUTE
    taken = image.decode_route()
    check(taken == route, f"JPEG decode route {taken!r}, but the card's machine was probed to decode with {route!r}")
    why = native_loader.unavailable_reason()
    build = ("native library unavailable: " + why if why else
             f"native library built in {native_loader.build_seconds:.2f} s" if native_loader.build_seconds is not None
             else "native library already built")
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        rate, rate_line = phase_bag_rate(dev, keep, card)
        say("10 inputs", f"(a) JPEG decode route {taken} (as probed); {build}; host decode of one 640x480 "
            f"JPEG pair {rate['decode_first_pair_ms']:.2f} ms (the first), {rate['decode_pair_ms']:.2f} ms (median)")
        golden, launches["bag_golden_orb"], bag = phase_bag_golden(ck, dev, tmp, route, card)
        say("10 inputs", rate_line)
        line, launches["datasets_kitti"] = phase_datasets(ck, dev, tmp, bag)
        say("10 inputs", line)
    conditions, launches["survival_matrix"] = phase_conditions(ck, dev, card)
    return {"decode_route": taken, "native": build, "bag_golden": golden, "bag_rate": rate,
            "survival_matrix": conditions}, launches

# ---------------------------------------------------------------------------
# Phase 11: the parallel/ package
# ---------------------------------------------------------------------------


def monotone(history) -> bool:
    return all(b <= a + 1e-6 for a, b in zip(history[:-1], history[1:]))


def phase_segments_small(dev) -> str:
    """(a): segment BA on the card and on the CPU, and the joint optimum."""
    import torch

    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, optimize
    from vision_slam_frontend_tpu_torch.io.synthetic import synthetic_ba_problem
    from vision_slam_frontend_tpu_torch.parallel.segment_ba import optimize_segments

    solver = BASolverConfig(max_iterations=SEG_ITERATIONS)
    runs = {}
    for where, device in (("card", dev), ("cpu", torch.device("cpu"))):
        cam, problem, _, _ = synthetic_ba_problem(**SEG_WORLD, device=device)
        runs[where] = optimize_segments(problem, cam=cam, solver=solver, n_seg=4, sweeps=4)
        if where == "card":
            _, joint = optimize(problem, cam=cam, solver=solver)
    (pg, ig), (pc, ic) = runs["card"], runs["cpu"]
    rel = abs(ig["cost"] - ic["cost"]) / ic["cost"]
    pose = max_abs_err(pg.poses_t.cpu(), pc.poses_t)
    line = (f"(a) segments P={SEG_WORLD['P']} L={SEG_WORLD['L']} (n_seg 4, sweeps 4): card cost {ig['cost']:.4f} vs "
            f"CPU {ic['cost']:.4f} (rel {rel:.2e}), poses max diff {pose:.2e}, joint optimize {joint['cost']:.4f} "
            f"(ratio {ig['cost'] / joint['cost']:.4f}), histories monotone")
    check(rel <= SEG_COST_RTOL and pose <= SEG_POSE_ATOL, f"{line}: beyond cost {SEG_COST_RTOL}, poses {SEG_POSE_ATOL}")
    check(monotone(ig["history"]) and monotone(ic["history"]), f"{line}: a history rises")
    check(ig["cost"] < SEG_JOINT_RATIO * joint["cost"] + 1e-6, f"{line}: beyond {SEG_JOINT_RATIO} of the joint cost")
    return line


def level_a_times(cam, problem, n_seg: int, reps: int) -> dict:
    """One level-A iteration (every segment's dense step and cost) at lambda
    1e-3: median synced and enqueue ms over `reps`, launches and device ms of
    one profiled iteration (None where the profiler recorded none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vision_slam_frontend_tpu_torch.backend import ba
    from vision_slam_frontend_tpu_torch.parallel.segment_ba import build_segments, fold_segments, level_a_iteration

    stacked, _ = build_segments(problem, n_seg)
    Ps = stacked.poses_t.shape[1]
    folded = fold_segments(stacked, slice(0, n_seg), problem.device)
    pm = ba._build_pm_inputs(folded)
    plan = ba._dense_coupling_plan(folded, Ps)
    lam = torch.full((n_seg,), 1e-3, device=problem.device)

    def iteration():
        return level_a_iteration(cam, folded, pm, plan, lam, n_seg, Ps, *ba_scalars(), True)[1]

    iteration().cpu()  # warm-up
    synced, enqueue = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        costs = iteration()
        t1 = time.perf_counter()
        costs.cpu()
        synced.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        iteration().cpu()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    return dict(iteration_ms=statistics.median(synced), enqueue_ms=statistics.median(enqueue), launches=launches or None,
                device_ms=sum(e.self_device_time_total for e in device) / 1e3 if device else None, Ps=int(Ps),
                Ls=int(stacked.landmarks.shape[1]))


def phase_segments_scale(dev, phase7: dict) -> tuple[dict, str]:
    """(b): segments at the BA benchmark shape, beside phase 7's solves."""
    import torch

    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig
    from vision_slam_frontend_tpu_torch.backend.metrics import ate_rmse
    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
    from vision_slam_frontend_tpu_torch.io.synthetic import make_problem
    from vision_slam_frontend_tpu_torch.parallel.segment_ba import optimize_segments

    P, L, obs = BA_SCALE
    problem, gt_t, _ = make_problem(P, L, obs, return_gt=True, clean=True, device=dev)
    cam = CameraParams(fx=500.0, fy=500.0, cx=320.0, cy=240.0, R_cr=np.eye(3), t_cr=np.zeros(3)).to(dev)
    init_ate = ate_rmse(problem.poses_t.cpu().numpy(), gt_t)
    solver = BASolverConfig(max_iterations=BA_ITERATIONS, cg_iterations=BA_CG_ITERATIONS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt, info = optimize_segments(problem, cam=cam, solver=solver, **SEG_SCALE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    ate = ate_rmse(opt.poses_t.cpu().numpy(), gt_t)
    check(np.isfinite(info["cost"]) and info["cost"] < info["history"][0] and monotone(info["history"]),
          f"segments at the benchmark shape: cost history {info['history']} not finite, falling and monotone")
    pin = ate < BA_ATE_MAX["pcg"] and ate < init_ate / 2.5
    times = level_a_times(cam, problem, SEG_SCALE["n_seg"], BA_REPS)
    plateau = info["max_rejected_in_a_row"] >= 4
    out = dict(cost=info["cost"], ate=ate, init_ate=init_ate, ate_pin_met=pin, seconds=seconds, peak_gib=peak, history=info["history"],
               iterations=info["iterations"], sweep_seconds=info["sweep_seconds"],
               max_rejected_in_a_row=info["max_rejected_in_a_row"], level_a=times)
    d, g = phase7["dense"], phase7["pcg"]
    line = (f"(b) segments P={P} L={L} clean (n_seg {SEG_SCALE['n_seg']}, sweeps {SEG_SCALE['sweeps']}, polish "
            f"{SEG_SCALE['polish_iterations']}, {BA_ITERATIONS} LM iterations a sweep): cost {info['cost']:.1f}, ATE "
            f"{ate:.4f} m (initial {init_ate:.4f}; tests/test_ba_scale_accuracy.py's PCG limit {BA_ATE_MAX['pcg']} and "
            f"initial / 2.5: " + ("met" if pin else "NOT met") + f"; the JAX package's segment solver on this problem "
            f"on the CPU: cost {SEG_SCALE_REFERENCE['cost']:.1f}, ATE {SEG_SCALE_REFERENCE['ate']:.4f} m, ROADMAP C; "
            f"phase 7: dense {d['cost']:.1f} / {d['ate']:.4f} m, PCG {g['cost']:.1f} / {g['ate']:.4f} m), "
            f"{info['iterations']} LM iterations in {seconds:.2f} s, sweeps "
            + ", ".join(f"{x:.2f}" for x in info["sweep_seconds"]) + f" s synced, peak {peak:.2f} GiB; one level-A "
            f"iteration (8 segments of {times['Ps']} poses, {times['Ls']} landmark slots) {times['iteration_ms']:.2f} "
            f"ms synced, {times['enqueue_ms']:.2f} ms enqueue, "
            + ("launches not measured" if times["launches"] is None else f"{times['launches']} launches") + ", "
            + ("device time not measured" if times["device_ms"] is None else f"{times['device_ms']:.2f} ms device")
            + f"; longest run of rejections of one segment's LM: {info['max_rejected_in_a_row']} ("
            + ("meets" if plateau else "does not meet") + " four in a row, ROADMAP C's plateau)")
    return out, line


def phase_segments_long(dev) -> tuple[dict, str]:
    """(c): past the dense ceiling, segments against the joint solve."""
    import torch

    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, _solver_form, compute_cost, optimize
    from vision_slam_frontend_tpu_torch.io.synthetic import synthetic_ba_problem
    from vision_slam_frontend_tpu_torch.parallel.segment_ba import optimize_segments

    cam, problem, gt_t, gt_lm = synthetic_ba_problem(**LONG_WORLD, device=dev)
    solver = BASolverConfig(max_iterations=LONG_ITERATIONS)
    form = _solver_form(problem, solver)
    out = {}
    for name, run in (("segments", lambda: optimize_segments(problem, cam=cam, solver=solver, **LONG_SEGMENTS)),
                      ("joint", lambda: optimize(problem, cam=cam, solver=solver))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, info = run()
        torch.cuda.synchronize()
        out[name] = dict(cost=info["cost"], initial=info["history"][0], seconds=time.perf_counter() - t0,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30, iterations=info["iterations"],
                         history=info["history"])
    P = LONG_WORLD["P"]
    yaw = 0.005 * np.arange(P)
    gt_q = np.stack([np.cos(yaw / 2), np.zeros(P), np.sin(yaw / 2), np.zeros(P)], -1).astype(np.float32)
    gt = problem.replace(poses_t=torch.from_numpy(gt_t).to(dev), poses_q=torch.from_numpy(gt_q).to(dev),
                         landmarks=torch.from_numpy(gt_lm).to(dev))
    out["gt_cost"] = gt_cost = float(compute_cost(cam, gt, *ba_scalars(), True))
    s, j = out["segments"], out["joint"]
    line = (f"(c) P={P} L={LONG_WORLD['L']}, {int(problem.obs_mask.sum())} observations, drifting: segments (n_seg "
            f"{LONG_SEGMENTS['n_seg']}, sweeps {LONG_SEGMENTS['sweeps']}, polish {LONG_SEGMENTS['polish_iterations']}) "
            f"cost {s['initial']:.1f} -> {s['cost']:.1f} in {s['seconds']:.2f} s, peak {s['peak_gib']:.2f} GiB; joint "
            f"optimize under auto ({form}) {j['cost']:.1f} in {j['seconds']:.2f} s, peak {j['peak_gib']:.2f} GiB; "
            f"ground truth's cost {gt_cost:.1f}")
    check(np.isfinite(s["cost"]) and s["cost"] < 0.01 * s["initial"] and monotone(s["history"]),
          f"{line}: segments not finite, monotone and below 0.01 of the initial")
    out["gt_check_met"] = met = s["cost"] < 2.0 * gt_cost
    return out, line + ("; below twice the ground truth's: met" if met else
                        "; below twice the ground truth's (tests/test_segment_ba.py's second check): NOT met, ROADMAP C")


def _dist_modes(mesh, dev) -> dict:
    """The three distributed modes on phase 7 (a)'s problem over `mesh`:
    each one's final cost, iterations, poses and landmarks (numpy)."""
    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig
    from vision_slam_frontend_tpu_torch.io.synthetic import synthetic_ba_problem
    from vision_slam_frontend_tpu_torch.parallel.segment_ba import optimize_segments
    from vision_slam_frontend_tpu_torch.parallel.sharded_ba import (
        optimize_sharded,
        optimize_sharded_dense,
        pad_observations,
    )

    cam, problem, _, _ = synthetic_ba_problem(**BA_SMALL, device=dev)
    it = BA_SMALL_ITERATIONS
    runs = {
        "pcg": lambda: optimize_sharded(pad_observations(problem, mesh.size), mesh, cam=cam, solver=BASolverConfig(
            max_iterations=it, schur_solver="pcg", cg_iterations=BA_CG_ITERATIONS)),
        "dense": lambda: optimize_sharded_dense(problem, mesh, cam=cam, solver=BASolverConfig(
            max_iterations=it, schur_solver="dense")),
        "segments": lambda: optimize_segments(problem, mesh=mesh, cam=cam, solver=BASolverConfig(
            max_iterations=it, cg_iterations=BA_CG_ITERATIONS), n_seg=DIST_SEGMENTS, sweeps=2, polish_iterations=0),
    }
    out = {}
    for name, run in runs.items():
        opt, info = run()
        out[name] = dict(cost=info["cost"], iterations=info["iterations"], poses_t=opt.poses_t.cpu().numpy(),
                         poses_q=opt.poses_q.cpu().numpy(), landmarks=opt.landmarks.cpu().numpy())
    return out


def _dist_worker(rank: int, world: int, backend: str, port: int, device: str, queue) -> None:
    """One rank of phase 11 (d), in a spawned process on `device` (every
    rank on the same one): the three modes and comm_report's counts over the
    process group."""
    import traceback

    try:
        import torch
        import torch.distributed as dist

        from vision_slam_frontend_tpu_torch.parallel.comm_report import report_modes
        from vision_slam_frontend_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        initialize_distributed(f"localhost:{port}", world, rank, backend=backend, device=dev)
        try:
            mesh = make_mesh(world, dev)
            out = _dist_modes(mesh, dev)
            out["counts"] = report_modes(world, P=BA_SMALL["P"], L=BA_SMALL["L"], device=dev,
                                         cg_iters=BA_CG_ITERATIONS, group=mesh)
        finally:
            dist.destroy_process_group()
        queue.put((backend, rank, out))
    except BaseException:
        queue.put((backend, rank, traceback.format_exc()))
        raise


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_distributed(dev, npz: str, tmp: str) -> tuple[dict, list[str]]:
    """(d): the process groups on the one card, against single-process runs."""
    import queue as queue_mod

    import torch
    import torch.multiprocessing as mp

    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, optimize
    from vision_slam_frontend_tpu_torch.io.synthetic import synthetic_ba_problem
    from vision_slam_frontend_tpu_torch.parallel.mesh import LocalShards
    from vision_slam_frontend_tpu_torch.parallel.segment_ba import optimize_segments

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_dist_worker, args=(rank, world, backend, port, str(dev), results))
             for backend, world, port in ((b, w, free_port()) for b, w in DIST_GROUPS) for rank in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    # Meanwhile, the single-process runs in this process: the unsharded
    # solves and the modes on in-process groups.
    cam, problem, _, _ = synthetic_ba_problem(**BA_SMALL, device=dev)
    it = BA_SMALL_ITERATIONS
    single = {
        "pcg": optimize(problem.replace(pose_obs=None, pose_obs_mask=None, lm_obs=None, lm_obs_mask=None), cam=cam,
                        solver=BASolverConfig(max_iterations=it, schur_solver="pcg", cg_iterations=BA_CG_ITERATIONS)),
        "dense": optimize(problem, cam=cam, solver=BASolverConfig(max_iterations=it, schur_solver="dense")),
        "segments": optimize_segments(problem, cam=cam, solver=BASolverConfig(
            max_iterations=it, cg_iterations=BA_CG_ITERATIONS), n_seg=DIST_SEGMENTS, sweeps=2, polish_iterations=0),
    }
    in_process = _dist_modes(LocalShards(DIST_RANKS, dev), dev)
    one_shard = _dist_modes(LocalShards(1, dev), dev)
    got = {}
    deadline = time.perf_counter() + DIST_TIMEOUT_S
    try:
        while len(got) < len(procs):
            try:
                backend, rank, out = results.get(timeout=5)
            except queue_mod.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                check(not failed, f"a rank of phase 11 (d) exited with {failed} before its result")
                check(time.perf_counter() < deadline, f"a rank of phase 11 (d) gave no result in {DIST_TIMEOUT_S} s")
                continue
            check(not isinstance(out, str), f"{backend} rank {rank} failed:\n{out}")
            got[backend, rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs), f"rank exit codes {[p.exitcode for p in procs]}")
    seconds = time.perf_counter() - t0
    lines, numbers = [], {"seconds": seconds}

    gloo = got["gloo", 0]
    for name in ("pcg", "dense", "segments"):
        a, b = gloo[name], got["gloo", 1][name]
        check(np.array_equal(a["poses_t"], b["poses_t"]) and np.array_equal(a["landmarks"], b["landmarks"]),
              f"gloo {name}: the two ranks' results differ")
        c = in_process[name]
        rel = abs(a["cost"] - c["cost"]) / c["cost"]
        pose = float(np.abs(a["poses_t"] - c["poses_t"]).max())
        tol = DIST_PCG_RTOL if name == "pcg" else DIST_SEG_RTOL
        ref, ref_info = single[name]
        text = (f"{name} cost {a['cost']:.6g} vs {c['cost']:.6g} on {DIST_RANKS} in-process shards (rel {rel:.2e}, "
                f"poses max diff {pose:.2e}) and {ref_info['cost']:.6g} unsharded")
        check(rel <= tol, f"gloo {text}: cost beyond {tol}")
        numbers[f"gloo_{name}"] = dict(cost=a["cost"], in_process_cost=c["cost"], single_cost=ref_info["cost"],
                                       rel=rel, pose=pose)
        if name == "dense":
            rel1 = abs(a["cost"] - ref_info["cost"]) / ref_info["cost"]
            pose1 = float(np.abs(a["poses_t"] - ref.poses_t.cpu().numpy()).max())
            lm1 = float(np.abs(a["landmarks"] - ref.landmarks.cpu().numpy()).max())
            text += f" (rel {rel1:.2e}, poses max diff {pose1:.2e}, landmarks {lm1:.2e})"
            check(pose1 <= BA_POSE_ATOL and lm1 <= BA_LM_ATOL and rel1 <= BA_COST_RTOL,
                  f"gloo {text}: beyond poses {BA_POSE_ATOL}, landmarks {BA_LM_ATOL}, cost {BA_COST_RTOL} of the "
                  "unsharded dense solve")
            text += f"; the JAX package's landmark-sharded dense on 2 CPU devices: cost {DIST_DENSE_REFERENCE['cost']:.6g}"
            numbers["gloo_dense"].update(single_rel=rel1, single_pose=pose1, single_lm=lm1)
        lines.append(text)
        for field in ("poses_t", "poses_q", "landmarks"):
            if ("nccl", 0) in got:
                check_equal_arrays(f"nccl world 1 {name} {field} vs one in-process shard", got["nccl", 0][name][field],
                                   one_shard[name][field])
    for backend, rank in got:
        for r in got[backend, rank]["counts"]:
            check((r["calls"], r["bytes"]) == (r["expected_calls"], r["expected_bytes"]),
                  f"{backend}: {r['mode']} counted {r['calls']} calls / {r['bytes']} bytes, expected "
                  f"{r['expected_calls']} / {r['expected_bytes']}")
    numbers["counts"] = got["gloo", 0]["counts"]
    counts = "; ".join(f"{r['mode']} {r['calls']} calls, {r['bytes']} bytes" for r in numbers["counts"])

    proc = subprocess.run([sys.executable, "-m", "vision_slam_frontend_tpu_torch.cli.slam_backend", "--input", npz,
                           "--output", os.path.join(tmp, "devices2.npz"), "--devices", "2"],
                          capture_output=True, text=True, timeout=300)
    refusal = f"needs 2 CUDA devices, found {torch.cuda.device_count()}"
    check(proc.returncode != 0 and refusal in proc.stderr,
          f"slam_backend --devices 2: exit {proc.returncode}, stderr {proc.stderr[-500:]!r}")
    check(not os.path.exists(os.path.join(tmp, "devices2.npz")), "slam_backend --devices 2 wrote an output")
    return numbers, [
        f"(d) {DIST_RANKS} processes over gloo, CUDA tensors on cuda:0, P={BA_SMALL['P']} L={BA_SMALL['L']}, "
        f"{BA_SMALL_ITERATIONS} LM iterations: " + "; ".join(lines) + "; the ranks' results equal",
        "(d) a world-size-1 NCCL group: every mode's poses and landmarks equal a one-shard in-process group's",
        f"(d) collectives per LM iteration (comm_report, {DIST_RANKS} gloo ranks, cg {BA_CG_ITERATIONS}; segments: "
        f"a sweep of one level-A iteration), equal to the analytic count on both groups: {counts}",
        f"(d) slam_backend --devices 2 exits {proc.returncode}: {proc.stderr.strip().splitlines()[-1]}",
        f"(d) {seconds:.1f} s with the processes' start-up",
    ]


def phase_segments_cli(npz: str, dev, tmp) -> str:
    """(e): slam_backend --schur_solver segments on the card and on the CPU."""
    from vision_slam_frontend_tpu_torch.cli.slam_backend import main as backend_main

    outs, summary = {}, []
    for where, device in (("card", str(dev)), ("cpu", "cpu")):
        outs[where] = os.path.join(tmp, f"segments_{where}.npz")
        rc, printed = run_cli_quiet(["--input", npz, "--output", outs[where], "--device", device, "--schur_solver",
                                     "segments"], main=backend_main)
        check(rc == 0, f"slam_backend --schur_solver segments --device {device}: exit code {rc}")
        if where == "card":
            summary = [ln for ln in printed.splitlines() if ln.startswith(("BA problem", "BA (segments"))]
    a, b = np.load(outs["card"]), np.load(outs["cpu"])
    check(sorted(a.files) == sorted(b.files), "slam_backend segments npz keys differ between the card and the CPU")
    for k in b.files:
        check(a[k].dtype == b[k].dtype and (k == "ba_cost_history" or a[k].shape == b[k].shape),
              f"slam_backend segments npz {k}: shape/dtype differ")
    pose = float(max(np.abs(a["nodes_loc"] - b["nodes_loc"]).max(), np.abs(a["nodes_quat"] - b["nodes_quat"]).max()))
    lm = float(np.abs(a["ba_landmarks"] - b["ba_landmarks"]).max())
    check(bool(np.isfinite(a["ba_landmarks"]).all()), "slam_backend segments: non-finite landmarks")
    check(pose <= BA_POSE_ATOL, f"slam_backend segments card vs CPU: poses {pose:.2e} beyond {BA_POSE_ATOL}")
    return (f"(e) slam_backend --schur_solver segments on {MAIN_INPUT}'s problem: " + "; ".join(summary)
            + f" | card vs CPU: {len(a.files)} keys with equal dtypes and shapes, poses max diff {pose:.2e}, "
            f"landmarks {lm:.2e}, final cost {float(a['ba_cost_history'][-1]):.4f} vs "
            f"{float(b['ba_cost_history'][-1]):.4f}")


def phase_parallel(ck, dev, npz: str, tmp, card: str, phase7: dict):
    """Phase 11, one line per part as it ends; returns (the numbers, the
    launch counts of the frontend kernels while it ran: none)."""
    import torch

    t0 = time.perf_counter()
    ck.reset_launch_counts()
    say("11 parallel", f"[{card}] " + phase_segments_small(dev))
    scale, line = phase_segments_scale(dev, phase7)
    say("11 parallel", f"[{card}] " + line)
    torch.cuda.empty_cache()
    long_run, line = phase_segments_long(dev)
    say("11 parallel", f"[{card}] " + line)
    torch.cuda.empty_cache()
    dist_numbers, lines = phase_distributed(dev, npz, tmp)
    for line in lines:
        say("11 parallel", f"[{card}] " + line)
    say("11 parallel", phase_segments_cli(npz, dev, tmp))
    launches = ck.runs()
    check_launches("parallel", launches, (), absent=tuple(KERNELS))
    seconds = time.perf_counter() - t0
    say("11 parallel", f"phase 11 took {seconds:.1f} s")
    return {"segments_scale": scale, "beyond_ceiling": long_run, "distributed": dist_numbers,
            "seconds": seconds}, launches


# ---------------------------------------------------------------------------
# Phase 12: the tools (debug images, the live viewer, stage profiling,
# device-side checks) and the dense-plateau coupling trial
# ---------------------------------------------------------------------------

TOOLS_LIVE_TOL = dict(pose=2e-4, landmark=2e-3)  # the live page rounds to 4 and 3 decimals
TOOLS_MIN_EQUAL_PIXELS = 0.999  # a sub-pixel coordinate at .5 may round apart
TOOLS_RSS_RATIO = 1.10  # --save_debug streams: peak RSS within 10% of the plain run
TOOLS_PROFILE_INPUT = "synthetic:8"
TOOLS_CLI_FLAGS = ["--visualize", "--save_debug"]
LIVE_CHUNK = r"<script>A\((\{.*?\})\)</script>"
STAGES = ("detect_describe_x2", "stereo_ratio_match", "epipolar_filter", "window_match", "undistort_x2",
          "triangulate", "  detect: fast_scores", "  detect: top_k", "  match: unpack_window",
          "  match: best_percent", "  step: stable_partition", "  step: gather_compact")


def live_chunks(npz: str) -> list:
    import re

    with open(os.path.splitext(npz)[0] + "_live.html") as f:
        return [json.loads(c) for c in re.findall(LIVE_CHUNK, f.read())]


def compare_live(a: list, b: list) -> str:
    """Two live pages' delta chunks: equal node ids, edges and debug image
    paths, poses and landmarks within TOOLS_LIVE_TOL."""
    check(len(a) == len(b) >= 2, f"live pages: {len(a)} and {len(b)} delta chunks")
    pose = lm = 0.0
    for x, y in zip(a, b):
        check([n["i"] for n in x["nodes"]] == [n["i"] for n in y["nodes"]], "live pages: node ids differ")
        check(x["oe"] == y["oe"] and x["ve"] == y["ve"], "live pages: edge lists differ")
        check(x.get("dbg") == y.get("dbg"), "live pages: embedded debug images differ")
        for nx, ny in zip(x["nodes"], y["nodes"]):
            pose = max(pose, float(np.abs(np.subtract(nx["p"], ny["p"])).max()))
            check(len(nx["lm"]) == len(ny["lm"]), f"live pages: node {nx['i']}'s landmark counts differ")
            if ny["lm"]:
                lm = max(lm, float(np.abs(np.subtract(nx["lm"], ny["lm"])).max()))
    check(pose <= TOOLS_LIVE_TOL["pose"] and lm <= TOOLS_LIVE_TOL["landmark"],
          f"live pages: poses {pose:.2e} and landmarks {lm:.2e} apart")
    return f"{len(a)} delta chunks, node ids and edges equal, poses within {pose:.1e}, landmarks within {lm:.1e}"


def compare_debug_dirs(a_npz: str, b_npz: str) -> tuple[str, int]:
    """The two runs' debug PNGs: equal names, each image at least
    TOOLS_MIN_EQUAL_PIXELS pixel-equal. Returns (text, images)."""
    from PIL import Image

    da, db = (os.path.splitext(p)[0] + "_debug" for p in (a_npz, b_npz))
    names = sorted(os.listdir(da))
    check(names == sorted(os.listdir(db)), "debug PNG names differ between the card and the CPU")
    worst = 1.0
    for name in names:
        x, y = (np.asarray(Image.open(os.path.join(d, name))) for d in (da, db))
        check(x.shape == y.shape, f"debug PNG {name}: shapes {x.shape} and {y.shape}")
        worst = min(worst, float((x == y).all(-1).mean()))
    check(worst >= TOOLS_MIN_EQUAL_PIXELS, f"debug PNGs: only {worst:.5f} of one image's pixels equal")
    n_match = sum(n.startswith("match_") for n in names)
    return (f"{len(names) - n_match} stereo + {n_match} match PNGs with equal names, the least-equal image "
            f"{worst:.5f} pixel-equal"), len(names)


def debug_host_ms(frames, dev) -> dict:
    """--save_debug's host cost per keyframe, from a Frontend with debug
    images on the card: the stereo lines' colours (np.random.default_rng per
    match), the whole drawing (colours included), and the PNG encoding of
    both images; medians over the keyframes."""
    import dataclasses
    import io

    from PIL import Image

    from vision_slam_frontend_tpu_torch.frontend import Frontend
    from vision_slam_frontend_tpu_torch.viz import debug_images

    fe = Frontend(dataclasses.replace(make_config("orb"), debug_images=True), device=dev)
    for f in frames:
        fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        fe.observe_image(f.left, f.right, f.timestamp)
    nodes = {n.node_idx: n for n in fe.get_slam_problem().nodes}
    colour, draw, png = [], [], []
    for entry in fe.get_debug_data():
        t0 = time.perf_counter()
        for i in range(int(entry["result"].num_features)):
            debug_images._line_color(i)
        t1 = time.perf_counter()
        images = [x for x in debug_images.render_debug_entry(entry, nodes) if x is not None]
        t2 = time.perf_counter()
        for x in images:
            Image.fromarray(x).save(io.BytesIO(), format="PNG")
        t3 = time.perf_counter()
        colour.append((t1 - t0) * 1e3)
        draw.append((t2 - t1) * 1e3)
        png.append((t3 - t2) * 1e3)
    return dict(keyframes=len(draw), colours_ms=statistics.median(colour), draw_ms=statistics.median(draw),
                png_ms=statistics.median(png))


def phase_tools_cli(ck, dev, tmp, frames, orb_npz: str, orb_launches: dict) -> tuple[dict, str, dict]:
    """(a): the CLI on MAIN_INPUT with --visualize --save_debug on the card
    (launch counts from that run) and on the CPU."""
    out = {where: os.path.join(tmp, "tools", where, "run.npz") for where in ("card", "cpu")}
    printed = {}
    for where, device in (("card", str(dev)), ("cpu", "cpu")):
        os.makedirs(os.path.dirname(out[where]))
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        rc, printed[where] = run_cli_quiet(["--input", MAIN_INPUT, "--output", out[where], "--device", device,
                                            *TOOLS_CLI_FLAGS])
        check(rc == 0, f"the CLI with {TOOLS_CLI_FLAGS} on {device}: exit code {rc}")
        if where == "card":
            launches, card_s = ck.runs(), time.perf_counter() - t0
    for name in ("fast_scores_nms", "extract_patches", "hamming_top2", "patch_windows"):
        check(launches[name] == orb_launches[name],
              f"{name}: {launches[name]} launches with {TOOLS_CLI_FLAGS}, {orb_launches[name]} in phase 5's run")
    streamed = [ln for ln in printed["card"].splitlines() if ln.startswith("Streamed ")]
    check(len(streamed) == 1, "the CLI printed no 'Streamed ... debug images' line")
    pngs, n_images = compare_debug_dirs(out["card"], out["cpu"])
    live = compare_live(live_chunks(out["card"]), live_chunks(out["cpu"]))
    same = same_problem("--visualize --save_debug against phase 5's run", out["card"], orb_npz)
    host = debug_host_ms(frames, dev)
    numbers = dict(card_seconds=card_s, images=n_images, launches=launches, **host)
    line = (f"(a) the CLI on {MAIN_INPUT} with {' '.join(TOOLS_CLI_FLAGS)}, card ({card_s:.2f} s) and CPU: "
            f"{streamed[0]} | {pngs} | live page: {live} | npz against phase 5's run: {same} | launches "
            f"{launches}, equal to phase 5's | host per keyframe ({host['keyframes']} keyframes, medians): line "
            f"colours {host['colours_ms']:.3f} ms, drawing {host['draw_ms']:.3f} ms (colours included), PNG "
            f"encoding {host['png_ms']:.3f} ms")
    return numbers, line, launches


TOOLS_BAG_PROCESS = r"""
import contextlib, io, json, sys
from vision_slam_frontend_tpu_torch.cli.slam_frontend import main
argv, extra = json.loads(sys.argv[1]), json.loads(sys.argv[2])
runs = []
for mode in ("warm-up", "plain", "debug"):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv + (extra if mode == "debug" else []))
    runs.append({"mode": mode, "rc": rc, "printed": buf.getvalue()})
print(json.dumps(runs))
"""


def phase_tools_bag(dev, tmp, card: str) -> tuple[dict, str]:
    """(b): the CLI on phase 10 (c)'s bag in a process of its own: a
    warm-up, then without --visualize --save_debug and with them (after the
    plain run, so the peak RSS with them includes their own growth)."""
    import re

    bag, cfg = os.path.join(tmp, "rate.bag"), os.path.join(tmp, "rate.yaml")
    check(os.path.exists(bag) and os.path.exists(cfg), "phase 10 (c)'s bag is gone")
    argv = ["--input", bag, "--config", cfg, "--output", os.path.join(tmp, "tools_bag.npz"), "--device", str(dev)]
    proc = subprocess.run([sys.executable, "-c", TOOLS_BAG_PROCESS, json.dumps(argv), json.dumps(TOOLS_CLI_FLAGS)],
                          capture_output=True, text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"tools bag process exit code {proc.returncode}: {proc.stderr[-2000:]}")
    runs = []
    for r in json.loads(proc.stdout.strip().splitlines()[-1]):
        check(r["rc"] == 0, f"tools bag CLI ({r['mode']}) exit code {r['rc']}")
        n = dict(mode=r["mode"], **rate_numbers(r["printed"]))
        check(n["frames"] == RATE_FRAMES, f"tools bag CLI ({r['mode']}) saw {n['frames']} frames")
        m = re.search(r"Streamed (\d+) match \+ (\d+) stereo debug images", r["printed"])
        check((m is not None) == (r["mode"] == "debug"), f"tools bag CLI ({r['mode']}): Streamed line")
        n["images"] = int(m.group(1)) + int(m.group(2)) if m else 0
        runs.append(n)
    measured = runs[1:]
    rss = {mode: max(x["peak_rss_mb"] for x in measured if x["mode"] == mode) for mode in ("plain", "debug")}
    ratio = rss["debug"] / rss["plain"]
    check(ratio <= TOOLS_RSS_RATIO, f"--save_debug peak RSS {rss['debug']:.0f} MB against {rss['plain']:.0f} MB")
    fps = {mode: next(x["fps"] for x in measured if x["mode"] == mode) for mode in ("plain", "debug")}
    cost_ms = (1.0 / fps["debug"] - 1.0 / fps["plain"]) * 1e3
    numbers = dict(runs=runs, peak_rss_ratio=ratio, debug_cost_ms_per_frame=cost_ms)
    line = (f"(b) [{card}] the CLI on phase 10 (c)'s {RATE_FRAMES}-frame 640x480 bag in its own process, "
            f"without and with {' '.join(TOOLS_CLI_FLAGS)}: " + "; ".join(
                f"{x['mode']} {x['fps']:.2f} frames/s, latency ms p50 {x['p50_ms']} p99 {x['p99_ms']}, peak RSS "
                f"{x['peak_rss_mb']:.0f} MB, {x['images']} images" for x in runs)
            + f" | peak RSS with them {ratio:.3f} of without (limit {TOOLS_RSS_RATIO}); they cost {cost_ms:.2f} ms "
            f"per frame ({fps['debug']:.2f} frames/s against {fps['plain']:.2f})")
    return numbers, line


def trace_kernels(path: str) -> list | None:
    """The names of the CUDA kernels in a Chrome trace; None where it holds
    no device kernel (the CUPTI trace missing)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    names = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    return names or None


def stage_table(printed: str) -> dict:
    """format_stage_table's rows as {name: ms}: the stages, "stage sum",
    "fused keyframe step" and "  of which enqueue"."""
    import re

    rows = {}
    for ln in printed.splitlines():
        if ln.endswith("%") and not ln.startswith("stage "):
            name, ms, _ = ln.rsplit(None, 2)
            rows[name] = float(ms)
        m = re.match(r"^(stage sum|fused keyframe step|  of which enqueue)\s+([\d.]+)", ln)
        if m:
            rows[m.group(1)] = float(m.group(2))
    return rows


def phase_tools_profile(ck, dev, tmp, card: str) -> tuple[dict, str, dict]:
    """(c): profile_stages on the card with --trace_dir, and slam_frontend
    --profile_dir."""
    from vision_slam_frontend_tpu_torch.cli import profile_stages

    trace_dir = os.path.join(tmp, "stage_trace")
    ck.reset_launch_counts()
    rc, printed = run_cli_quiet(["--max_features", "512", "--frame_life", "10", "--trace_dir", trace_dir,
                                 "--device", str(dev)], main=profile_stages.main)
    launches = ck.runs()
    check(rc == 0, f"profile_stages exit code {rc}")
    rows = stage_table(printed)
    for s in STAGES:
        check(rows.get(s, 0.0) > 0.0, f"profile_stages: stage {s!r} missing or not positive")
    fused, enqueue = rows.get("fused keyframe step"), rows.get("  of which enqueue")
    check((fused or 0) > 0 and ((enqueue or 0) > 0 or dev.type != "cuda"),  # enqueue time: CUDA only
          "profile_stages: no synced or enqueue time of the step")
    kernels = trace_kernels(os.path.join(trace_dir, profile_stages.TRACE_FILE))
    found = None
    if kernels is not None:
        found = {name: any(KERNELS[name][2] in k for k in kernels)
                 for name in ("fast_scores_nms", "extract_patches", "hamming_top2")}
        check(all(found.values()), f"profile_stages trace: kernels {found}")
    out = os.path.join(tmp, "profiled.npz")
    prof_dir = os.path.join(tmp, "cli_trace")
    rc, cli_printed = run_cli_quiet(["--input", TOOLS_PROFILE_INPUT, "--output", out, "--device", str(dev),
                                     "--profile_dir", prof_dir])
    check(rc == 0 and f"Wrote profiler trace to {prof_dir}" in cli_printed, f"slam_frontend --profile_dir: rc {rc}")
    files = os.listdir(prof_dir)
    check(len(files) == 1 and os.path.getsize(os.path.join(prof_dir, files[0])) > 0,
          f"slam_frontend --profile_dir wrote {files}")
    cli_kernels = trace_kernels(os.path.join(prof_dir, files[0]))
    numbers = dict(stages=rows, fused_ms=fused, enqueue_ms=enqueue, trace_kernels=found,
                   cli_trace_mb=os.path.getsize(os.path.join(prof_dir, files[0])) / 2**20,
                   cli_trace_kernel_names=None if cli_kernels is None else len(cli_kernels))
    line = (f"(c) [{card}] profile_stages (640x480, K=512, W=10): " + ", ".join(
        f"{s.strip()} {rows[s]:.3f}" for s in STAGES) + f" ms; stage sum {rows.get('stage sum', 0):.3f} ms; step "
        f"{fused:.3f} ms synced, {enqueue} ms enqueue | --trace_dir: " + (
            "device kernels not measured (no CUDA kernel events in the trace)" if found is None else
            "kernels " + ", ".join(KERNELS[k][2] for k in found) + " found") +
        f" | slam_frontend --profile_dir on {TOOLS_PROFILE_INPUT}: {files[0]} ({numbers['cli_trace_mb']:.1f} MB, "
        + ("no device kernels" if cli_kernels is None else f"{len(cli_kernels)} kernel names") + ")")
    return numbers, line, launches


def phase_tools_checks(frames, dev, card: str) -> tuple[dict, str]:
    """(d): one full-width ORB keyframe_step under checkified, against the
    plain step; a NaN pose; an out-of-range gather on the card."""
    import torch

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams
    from vision_slam_frontend_tpu_torch.utils.checks import checkified

    config = make_config("orb")
    params = StepParams.from_config(config, dev)
    inputs = step_inputs(frames[:2], dev)

    def step(inp, checked):
        state = new_state(config, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if checked:
            err, out = checkified(run_step, params, state, inp, 0, config)
        else:
            err, out = None, run_step(params, state, inp, 0, config)
        torch.cuda.synchronize()
        return err, out, time.perf_counter() - t0

    step(inputs[0], False)  # warm
    _, (_, plain), plain_s = step(inputs[0], False)
    err, (_, checked), checked_s = step(inputs[0], True)
    check(err.get() is None, f"checkified clean step: {err.get()}")
    n_fields = 0
    for f in dataclasses.fields(plain):
        a, b = getattr(checked, f.name), getattr(plain, f.name)
        if not a.is_floating_point():
            check_equal(f"checked step {f.name}", a, b)
            n_fields += 1
    left, right, t, q = inputs[0]
    nan_t = t.clone()
    nan_t[1] = float("nan")
    err_nan, _, _ = step((left, right, nan_t, q), True)
    check(err_nan.get() is not None and err_nan.get().startswith("nan generated by aten."),
          f"checkified NaN pose: {err_nan.get()}")
    err_oob, result = checkified(torch.gather, torch.arange(8.0, device=dev), 0, torch.tensor([1, 8], device=dev))
    check(result is None and "out-of-bounds index" in (err_oob.get() or ""), f"out-of-range gather: {err_oob.get()}")
    torch.cuda.synchronize()  # a device-side assert would raise here
    _, (_, again), _ = step(inputs[0], False)
    for f in dataclasses.fields(plain):
        if not getattr(plain, f.name).is_floating_point():
            check_equal(f"step after the gather {f.name}", getattr(again, f.name), getattr(plain, f.name))
    numbers = dict(checked_s=checked_s, plain_s=plain_s, slowdown=checked_s / plain_s, nan_message=err_nan.get(),
                   gather_message=err_oob.get())
    line = (f"(d) [{card}] checkified ORB keyframe_step (640x480, K=512, W=10): no error, {n_fields} int and bool "
            f"fields equal to the plain step; {checked_s:.3f} s checked against {plain_s * 1e3:.3f} ms plain "
            f"({checked_s / plain_s:.0f}x) | NaN in curr_pose_t: '{err_nan.get()}' | out-of-range gather: "
            f"'{err_oob.get()}', no device assert, and a plain step after it runs and matches")
    return numbers, line


def phase_tools_coupling(dev, card: str, phase7: dict) -> tuple[dict, str]:
    """(e): backend/dense_plateau.coupling_trial (the coupling's two
    ablations) on the card, beside phase 7's dense run."""
    import torch

    from vision_slam_frontend_tpu_torch.backend import dense_plateau

    problem, cam, gt_t = dense_plateau.benchmark_problem(dev)
    t0 = time.perf_counter()
    trial = dense_plateau.coupling_trial(problem, cam, gt_t)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for name in ("compensated", "port_float32"):
        check(np.isfinite(trial[name]["cost"]), f"coupling trial {name}: non-finite cost")

    def text(r):
        return (f"cost {r['cost']:.1f}, {r['accepted']} of {r['iterations']} accepted, rejected {r['rejected']}, "
                f"ATE {r['ate']:.4f}, after step 1 {r['cost_after_step1']:.1f}")

    d = phase7["dense"]
    line = (f"(e) [{card}] coupling trial, dense LM at P={dense_plateau.SHAPE[0]} L={dense_plateau.SHAPE[1]} "
            f"({seconds:.1f} s), ablations over slot pairs: the compensated bf16 products without the placement "
            f"rounding {text(trial['compensated'])} (follows the reference: {trial['follows_reference']}) | the "
            f"former float32 coupling {text(trial['port_float32'])} | phase 7's dense run (the solver: placement "
            f"per (landmark, pose) and the compensated products): cost {d['cost']:.1f}, {d['accepted']} of "
            f"{d['iterations']} accepted, rejected {d['rejected']}, ATE {d['ate']:.4f} | the JAX package's CPU run: "
            f"{text(trial['reference_cpu'])}")
    return dict(trial, seconds=seconds), line


def phase_tools_plateau(dev, card: str) -> tuple[dict, str]:
    """(e), continued: backend/dense_plateau.placement_trial (the solver as
    it is) and schedule_trial (the former float32 coupling's stop) on the
    card, beside ROADMAP C's CPU figures."""
    import torch

    from vision_slam_frontend_tpu_torch.backend import dense_plateau

    problem, cam, gt_t = dense_plateau.benchmark_problem(dev)
    t0 = time.perf_counter()
    placement = dense_plateau.placement_trial(problem, cam, gt_t)
    schedule = dense_plateau.schedule_trial(problem, cam, gt_t)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(np.isfinite(placement["placed"]["cost"]) and np.isfinite(schedule["stop"]["cost"]),
          "placement or schedule trial: non-finite cost")
    r, cpu = placement["placed"], dense_plateau.PLACEMENT_CPU
    st, scpu = schedule["stop"], dense_plateau.SCHEDULE_CPU
    sweep = ", ".join(f"{lam:.0e}: {c:.3f}" for lam, c in zip(schedule["lambdas"], schedule["cost_after_step"]))
    line = (f"(e) [{card}] placement trial, the solver ({placement['repeated_slots']} repeated (landmark, pose) "
            f"slots): cost "
            f"{r['cost']:.1f}, {r['accepted']} of {r['iterations']} accepted, rejected {r['rejected']}, ATE "
            f"{r['ate']:.4f}, follows the reference: {placement['follows_reference']} | ROADMAP C's CPU run: cost "
            f"{cpu['cost']:.1f}, {cpu['accepted']} of {cpu['iterations']} accepted, rejected {cpu['rejected']}, ATE "
            f"{cpu['ate']:.4f} | schedule trial: the former float32 run stops at {st['cost']:.1f} after "
            f"{st['iterations']} iterations (rejected {st['rejected']}); one step from there, cost by lambda: "
            f"{sweep}; lowest lambda that lowers the cost: {schedule['accepted_from']} | ROADMAP C's CPU run: stops "
            f"at {scpu['stop_cost']:.1f}, the reference from that state accepted first at lambda "
            f"{scpu['reference_accepted_at']} ({seconds:.1f} s)")
    return dict(placement=placement, schedule=schedule, seconds=seconds), line


def phase_tools(ck, dev, tmp, frames, orb_npz: str, orb_launches: dict, card: str, phase7: dict):
    """Phase 12, one line per part as it ends; returns (numbers, {path: launches})."""
    per_path = {}
    numbers = {}
    numbers["cli"], line, per_path["tools_cli"] = phase_tools_cli(ck, dev, tmp, frames, orb_npz, orb_launches)
    say("12 tools", line)
    numbers["bag"], line = phase_tools_bag(dev, tmp, card)
    say("12 tools", line)
    numbers["profile"], line, per_path["profile_stages"] = phase_tools_profile(ck, dev, tmp, card)
    say("12 tools", line)
    numbers["checks"], line = phase_tools_checks(frames, dev, card)
    say("12 tools", line)
    numbers["coupling"], line = phase_tools_coupling(dev, card, phase7)
    say("12 tools", line)
    numbers["plateau"], line = phase_tools_plateau(dev, card)
    say("12 tools", line)
    return numbers, per_path


def api_inputs(frame):
    """(u8 image, blurred f32 image, keypoints (K, 2), valid (K,)) on the
    CPU: the frame's FAST corners, the empty slots filled with random points
    19 px or more inside, every 17th invalid, then API_EDGE_KEYPOINTS valid
    keypoints 3 to 14 px from the four edges."""
    import torch

    from vision_slam_frontend_tpu_torch.ops.fast import fast_detect
    from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur

    img = torch.from_numpy(u8(frame.left))
    H, W = img.shape
    n = API_KEYPOINTS - API_EDGE_KEYPOINTS
    kps, _, valid = fast_detect(img, threshold=12.0, max_keypoints=n, border=19)
    rng = np.random.default_rng(7)
    fill = torch.from_numpy(rng.uniform([19, 19], [W - 20, H - 20], (n, 2)).astype(np.float32))
    kps = torch.where(valid[:, None], kps, fill)
    m = API_EDGE_KEYPOINTS // 4
    dist = np.tile(np.arange(3, 15), m // 12 + 1)[:m] + rng.uniform(-0.3, 0.3, m)
    along_x, along_y = rng.uniform(20, W - 20, m), rng.uniform(20, H - 20, m)
    edge = np.concatenate([np.stack([dist, along_y], 1), np.stack([W - 1 - dist, along_y], 1),
                           np.stack([along_x, dist], 1), np.stack([along_x, H - 1 - dist], 1)]).astype(np.float32)
    kps = torch.cat([kps, torch.from_numpy(edge)]).contiguous()
    valid = torch.cat([torch.arange(n) % 17 != 5, torch.ones(API_EDGE_KEYPOINTS, dtype=torch.bool)])
    return img, gaussian_blur(img.to(torch.float32), sigma=2.0), kps, valid


def phase_api(ck, dev, frame, card: str) -> tuple[dict, str, dict]:
    """Phase 13: the two-step API and the nms switch, card against CPU, with
    each call's launch counts on the card; returns (numbers, line, launches
    over the phase)."""
    import torch

    from vision_slam_frontend_tpu_torch import ops
    from vision_slam_frontend_tpu_torch.ops import brief

    img, blurred, kps, valid = api_inputs(frame)
    planes3 = torch.stack([img.to(torch.float32), blurred, torch.from_numpy(u8(frame.right)).to(torch.float32)], -1)
    theta = ops.compute_orientations(blurred, kps, valid)  # the CPU's angles feed both describes
    calls = {
        "compute_orientations": lambda d: ops.compute_orientations(blurred.to(d), kps.to(d), valid.to(d)),
        "brief_describe gather": lambda d: ops.brief_describe(blurred.to(d), kps.to(d), theta.to(d), valid.to(d),
                                                              method="gather"),
        "brief_describe mxu": lambda d: ops.brief_describe(blurred.to(d), kps.to(d), theta.to(d), valid.to(d),
                                                           method="mxu"),
        "brief_describe auto": lambda d: ops.brief_describe(blurred.to(d), kps.to(d), theta.to(d), valid.to(d)),
        "extract_patches (H, W)": lambda d: brief.extract_patches(blurred.to(d), kps.to(d)),
        "extract_patches (H, W, 3)": lambda d: brief.extract_patches(planes3.to(d), kps.to(d)),
        "fast_detect nms=False": lambda d: ops.fast_detect(img.to(d), threshold=12.0, max_keypoints=API_KEYPOINTS,
                                                           border=19, nms=False),
        "detect_and_describe nms=False": lambda d: brief.detect_and_describe(img.to(d), threshold=12.0,
                                                                             max_keypoints=API_KEYPOINTS, nms=False),
    }
    t0 = time.perf_counter()
    total = dict.fromkeys(ck.LAUNCHES, 0)
    parts, numbers = [], {}
    for name, call in calls.items():
        ck.reset_launch_counts()
        out = call(dev)
        torch.cuda.synchronize()
        launches = ck.runs()
        for k, v in launches.items():
            total[k] += v
        want = {k: API_LAUNCHES[name].get(k, 0) for k in launches}
        check(launches == want, f"{name}: launches {launches}, expected {want}")
        ref = call(torch.device("cpu"))
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        float_err = 0.0
        for a, b in zip(outs, refs):
            a = a.cpu()
            if name == "compute_orientations":
                float_err = max_abs_err(a, b)
                check(float_err <= API_THETA_ATOL, f"{name}: card against CPU {float_err:.3g} rad")
                check(torch.equal(brief.quantize_angle(a), brief.quantize_angle(b)), f"{name}: rotation bins differ")
            elif a.dtype.is_floating_point and name.startswith(("fast_detect", "detect_and_describe")):
                float_err = max(float_err, max_abs_err(a, b))
            else:
                check_equal(f"{name} card against CPU", a, b)
        numbers[name] = dict(launches=launches, float_max_abs_diff=float_err)
        parts.append(f"{name}: launches " + (", ".join(f"{k} {v}" for k, v in launches.items() if v) or "none")
                     + (f", float max abs diff {float_err:.3g}" if float_err or name == "compute_orientations" else ""))
    seconds = time.perf_counter() - t0
    line = (f"[{card}] 640x480, K={API_KEYPOINTS} ({int(valid.sum())} valid, {API_EDGE_KEYPOINTS} at 3-14 px from "
            f"the edges), card against CPU, every int and bool field and word equal, patches exact: "
            + "; ".join(parts) + f" ({seconds:.1f} s)")
    return dict(numbers, seconds=seconds), line, total


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke test runs only on the GPU", file=sys.stderr)
        return 1
    from vision_slam_frontend_tpu_torch.ops import _build
    from vision_slam_frontend_tpu_torch.ops import cuda_kernels as ck
    from vision_slam_frontend_tpu_torch.utils.cuda_timing import profiled_kernel_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    sm_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    say("1 device", f"{kind}, {count} visible; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"max SM clock {sm_mhz:.0f} MHz")
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.library()
    built = (f"nvcc built {_build.library_path().name} in {_build.build_seconds:.1f} s"
             if _build.build_seconds is not None else f"{_build.library_path().name} already built")
    resources = _build.kernel_resources()
    say("2 build", f"{built}; loaded in {time.perf_counter() - t0:.1f} s; ptxas: " + " | ".join(
        f"{fn}: {info}" for fn, info in resources.items() if any(k[2] in fn for k in KERNELS.values())))

    frames = synthetic_frames(TIMING_KEYFRAMES + 1)

    cases = kernel_cases(ck, frames, dev, sm_mhz * 1e6)
    window_inputs, windows = window_cases(ck, dev)
    errs, n_edge = phase_kernels(ck, cases, windows, dev)
    say("3 kernels", f"kernel == plain version on the card, exact, at {len(cases) + len(windows)} shapes and "
        f"{n_edge} edge cases: " + ", ".join(f"{k} max_abs_err={v}" for k, v in errs.items()))

    cpu = torch.device("cpu")
    in_gpu = step_inputs(frames[: NUM_PARITY_KEYFRAMES + 1], dev)
    in_cpu = step_inputs(frames[: NUM_PARITY_KEYFRAMES + 1], cpu)
    parity = []
    for name in CONFIGS:
        n_kf = NUM_PARITY_KEYFRAMES if name == "orb" else NUM_FAMILY_PARITY_KEYFRAMES
        n_fields, float_err = phase_parity(make_config(name), in_gpu, in_cpu, n_kf, dev)
        parity.append(f"{name} {n_kf} keyframes: {n_fields} int/bool fields equal, float max abs diff {float_err:.3g}")
    say("4 parity", "CUDA vs CPU at 640x480, K=512, W=10: " + "; ".join(parity))

    tmp_dir = tempfile.TemporaryDirectory()  # phase 5's problems feed phase 7
    per_path, lines, b5 = phase_main(ck, frames, window_inputs, dev, tmp_dir.name)
    n_feat = phase_sync_free(frames, dev)
    say("5 main", " | ".join(lines) + f" | steady step under sync-debug 'error' ok, features {n_feat}")

    steps, rows, prod_ms, floor_ms = phase_timing(ck, cases, frames, dev)
    bounds = {w["shape"]: w for w in windows}
    img, ys, xs = window_inputs
    for r in b5:  # timed by the entry point in phase 5
        w = bounds[r["name"]]
        row = dict(kernel="patch_windows", shape=r["name"], ms=r["ms"], call_ms=r["call_ms"], plain_ms=r["plain_ms"],
                   library_ms=r["library_ms"], bound_ms=w["bound_ms"], bound_by=w["bound_by"])
        if r["name"] == PRIMARY_SHAPE["patch_windows"]:
            row["profiled_ms"], row["kernels_per_call"], row["profiled_device_events"] = profiled_kernel_ms(
                lambda: ck.patch_windows(img, ys, xs, 32, False, 64), KERNELS["patch_windows"][2])
        rows.append(row)
    say("6 timing", f"[{smi}] keyframe step (640x480, K=512, W=10), medians over steady keyframes: " + "; ".join(
        f"{name} {ms:.3f} ms synced, {enq:.3f} ms enqueue ({n} keyframes), profiled step "
        + ("launches not measured" if nl is None else f"{nl} launches") + ", "
        + ("device time not measured" if dev_ms is None else f"{dev_ms:.3f} ms device")
        for name, (ms, enq, n, nl, dev_ms) in steps.items()))
    say("6 timing", f"[{smi}] device ms per launch (CUDA graph of 50, median of 5) | " + "; ".join(
        f"{r['kernel']} {r['shape']}: kernel {r['ms']:.5f} ms"
        + profiler_note(r)
        + f", call {r['call_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
        + ("none" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms")
        + f", bound {r['bound_ms']:.5f} ms ({r['bound_by']}"
        + (f" at the int8 tensor rate, the b1 rate being unpublished; bytes alone {r['bound_bytes_ms']:.5f} ms)"
           if "bound_bytes_ms" in r else ")") for r in rows))
    say("6 timing", f"[{smi}] hamming_top2 yardstick: +-1 int8 product of the window shape (5120x256 @ 256x512) "
        f"through torch._int_mm, product_ms {prod_ms:.5f} ms; launch floor (a 1-element fill, same method) "
        f"{floor_ms:.5f} ms")
    say("6 timing", f"whole run so far {time.perf_counter() - t_start:.1f} s")

    ba_numbers, per_path["ba"] = phase_ba(ck, dev, os.path.join(tmp_dir.name, "orb_gpu.npz"), tmp_dir.name, smi)
    say("7 ba", f"whole run so far {time.perf_counter() - t_start:.1f} s")
    lba_numbers, per_path["local_ba"] = phase_local_ba(ck, dev, tmp_dir.name, smi)
    say("8 local_ba", f"whole run so far {time.perf_counter() - t_start:.1f} s")

    golden, per_path["golden_loop"] = phase_golden(ck, dev, smi)
    line, per_path["checkpoint_cli"] = phase_checkpoint_cli(ck, dev, tmp_dir.name)
    say("9 golden", line)
    line, per_path["validate_cli"] = phase_validate(ck, dev, tmp_dir.name)
    say("9 golden", line)
    say("9 golden", f"whole run so far {time.perf_counter() - t_start:.1f} s")

    inputs, input_paths = phase_inputs(ck, dev, smi, tmp_dir.name)
    per_path.update(input_paths)
    say("10 inputs", f"whole run so far {time.perf_counter() - t_start:.1f} s")

    parallel, per_path["parallel"] = phase_parallel(ck, dev, os.path.join(tmp_dir.name, "orb_gpu.npz"), tmp_dir.name,
                                                    smi, ba_numbers["scale"])
    say("11 parallel", f"whole run so far {time.perf_counter() - t_start:.1f} s")

    t12 = time.perf_counter()
    tools, tool_paths = phase_tools(ck, dev, tmp_dir.name, frames, os.path.join(tmp_dir.name, "orb_gpu.npz"),
                                    per_path["orb"], smi, ba_numbers["scale"])
    per_path.update(tool_paths)
    tools["seconds"] = time.perf_counter() - t12
    tmp_dir.cleanup()
    say("12 tools", f"phase 12 {tools['seconds']:.1f} s; whole run so far {time.perf_counter() - t_start:.1f} s")

    api, line, per_path["api"] = phase_api(ck, dev, frames[0], smi)
    say("13 api", line)
    say("13 api", f"phase 13 {api['seconds']:.1f} s; whole run {time.perf_counter() - t_start:.1f} s")

    launches = {name: sum(p[name] for p in per_path.values()) for name in KERNELS}
    print(json.dumps({"card": smi, "max_sm_mhz": sm_mhz, "ptxas": resources,
                      "steps": {k: dict(zip(("ms", "enqueue_ms", "keyframes", "launches", "device_ms"), v))
                                for k, v in steps.items()}, "shapes": rows, "product_ms": prod_ms,
                      "launch_floor_ms": floor_ms,
                      "launches_per_path": per_path, "ba": ba_numbers, "local_ba": lba_numbers,
                      "golden_loop": golden, "inputs": inputs, "parallel": parallel, "tools": tools,
                      "api": api}), flush=True)
    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        r = next(x for x in rows if x["kernel"] == name and x["shape"] == PRIMARY_SHAPE[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
