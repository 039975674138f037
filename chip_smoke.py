#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`lidargs_torch`).

Run from the root of a checkout, on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from `lidargs_torch/csrc/` (nvcc,
sm_90a, one process per source, all at once, into `build/lidargs_torch/`),
then:

  1. renders the full-width benchmark scene (64x2650 range view, 60,000
     anchors on a synthetic street shell, k=6 -> 393,216 gaussians, random
     heads from a seed) from N_FRAMES sensor poses through `measure_fps`,
     with the launch counts set to 0 just before and read just after, and
     requires one K1 launch per frame, finite outputs and occupancy > 0;
  2. re-renders one frame through `run_eval` against a ground truth made
     from its first render (the render is deterministic, so the metrics
     must be exact);
  3. holds the tiled render (K1) against the O(P*HW) golden renderer
     (plain PyTorch) on a small scene;
  4. holds K1 against its plain PyTorch version on the inputs that the main
     path gave it for one frame;
  5. times the render, K1 and the plain version with CUDA events, computes
     K1's bound from this run's inputs and counts the (tile, warp of 32
     pixels, row) visits of K1's walk: of a walk over every row, those with
     a lane inside the row's rect, and those of the kernel's masked walk;
  6. lists the render's costliest device kernels from torch.profiler;
  7. trains: N_STEPS `Trainer.step`s of the same scene against random GT
     images (as the JAX package's train-step benchmark draws them) from
     sensor poses, with the counts set to 0 just before and read just after,
     requiring one K1 and one K2 launch per step, finite losses and
     parameters that changed, and statistics that accumulate; then one
     `Trainer.densify`, whose anchor count must be the count before plus
     grown minus pruned;
  8. holds K2 against its plain PyTorch version on the inputs one step gave
     it, and the parameter gradients of one step through K1/K2 against
     those through the plain versions, and reports the difference between
     two identical steps (PyTorch does not promise that the `[T, K, F]`
     gather's backward, an accumulating index_put, is deterministic on CUDA);
  9. times the train step, K2 and the plain backward with CUDA events,
     computes K2's bound from this run's inputs, counts the (tile, warp of
     32 pixels, row) visits in which some lane applies the row (the row
     reductions K2 runs, `warp_rows`), and profiles a few steps;
 10. renders the same scene from the same poses through the surfel (2DGS)
     variant, `measure_fps(..., variant="surfel")` at the CLI's surfel
     defaults (h1/K384/cap32), with the counts set to 0 just before and read
     just after, requiring one K5 launch per frame, finite outputs on every
     channel and occupancy > 0;
 11. holds the tiled surfel render (K5) against the golden chunk scan
     (plain PyTorch) on a small scene, and K5 against its plain version on
     frame 0's main-path inputs, on every output row;
 12. trains the surfel variant: N_STEPS `Trainer(variant="surfel").step`s
     with both regularizers on from the first step (so every row of K6's
     cotangent is live), one K5 and one K6 launch per step, then one
     densify;
 13. holds K6 against its plain version on one step's inputs, and one step's
     parameter gradients through K5/K6 against those through the plain
     versions;
 14. times the surfel frame and step, K5, K6 and both plain versions with
     CUDA events, computes K5's and K6's bounds (and K6's row reductions,
     K5's warp visits as K1's) from this run's inputs and profiles a frame
     and a step;
 15. renders the same frames through the fused-window gather of the beam
     variant, `measure_fps` with `fused_gather=True` at h4/K768/cap8, with
     the counts set to 0 just before and read just after, requiring one K3
     launch per frame and no K1 launch; holds frame 0's fused render equal
     bit for bit to the materialized one, and K3 equal bit for bit to K1 on
     frame 0's rows (the same packed rows, binned both ways) and to its
     plain version within K1's tolerance;
 16. trains N_STEPS fused `Trainer.step`s (one K3 and one K4 launch each, no
     K1 or K2), densifies once, holds K4 against its plain version and
     against K2 scattered to the windows (bit for bit, every row no tile
     owns zero), and one step's gradients against the plain versions'
     (GRAD_TOL) and the materialized path's (GRAD_TOL, relative norms
     reported); times K3, K4, K1 and K2 on the same rows, the plain
     versions, the fused and the materialized frame and step in turns, the
     `buf` gather against the `[T, K, F]` gather and the zeroing of `dbuf`;
     computes K3's and K4's bounds and profiles a fused frame and step;
 17-18. the same for the surfel variant at h1/K384/cap32: K7 against K5 and
     K8 against K6;
 19. writes the procedural street dataset (`data/synthetic.py`
     `make_street_dataset`, 50 frames of 64x2650: 46 train, 4 test) under
     `build/chip_smoke_cli/` and times it;
 20. trains it through the CLI, `lidargs_torch.train.cli.main`, at its
     defaults (h4/K768/cap8, anchor capacity 2**17, max_visible 2**18,
     k=6) with `--voxel_size 0.2` (~53k anchors from the 500k-point init
     cloud): CLI_ITERS iterations, a checkpoint at half, a densify, the test
     and final evaluations with the chamfer distance and F-score, FPS, the
     dumps and a torch.profiler trace of CLI_PROFILE_STEPS steps; with the
     counts set to 0 just before and read just after, every
     `Trainer.step` call must launch K1 and K2 once each, every frame an
     evaluation scores with the chamfer N1 twice (one a direction; none
     where a cloud is empty), and the init N2 once (the anchors' 3-NN
     scales); `results.json` must hold finite metrics;
 21. holds `mean_sq_dist_3nn` (N2) on the init cloud (KNN_POINTS points)
     and `chamfer_distance`/`fscore` (N1) on test frame 0's dumped render
     against its GT against a float64 k-d tree (scipy.spatial.cKDTree), and
     counts the init cloud's voxels at 0.2 m and at the median 3-NN
     estimate; holds N2 and N1 against their plain versions on the same
     points and clouds (each row within `gram_tol` of the tree's neighbour,
     the chamfer distance and F-score as against the tree), two launches of
     each bit for bit, and times each kernel, its plain version and the
     library calls (addmm and topk / amin) that the plain version makes;
     times `voxelize_points` on the init cloud and `pano_to_lidar` on one
     frame (the torch ops that answer the native `voxel_unique` and
     `pano_to_points`);
 22. resumes from the checkpoint to the end (`--start_checkpoint`: K1 and
     K2 once per step again, a densify) and evaluates the snapshot alone
     (`--load_iteration`: metrics with chamfer, N1 twice a scored frame,
     FPS, 12 PNG renders);
 23. trains the surfel variant through the CLI at its defaults
     (h1/K384/cap32), CLI_SURFEL_ITERS iterations, K5 and K6 once per step;
 24. dumps the beam snapshot's renders (`--load_iteration --dump_renders`),
     with the counts set to 0 just before and read just after: one K1
     launch per evaluated, timed, PNG-rendered and dumped frame, and the 50
     `train_*`/`test_*` frames [6, 64, 2650] plus `dir.npy`;
 25. trains the offline ray-drop refiner on those dumps through `cli
     refine`, `--arch mlp` (128x4 on 169,600 rays a step) and `--arch unet`
     (channels 32 on 64x2656), REFINE_EPOCHS epochs (JAX's default is 100:
     listed as `reduced`): finite losses, the last epoch's below the first
     step's; times one step of each (CUDA events) and profiles 3; holds the
     UNet's output and parameter gradients on one dumped frame on the card
     against the same on the CPU;
 26. evaluates the snapshot with each refiner and a random LPIPS npz in the
     converter's layout (`--raydrop_refiner`, `--lpips_weights`, no
     chamfer): finite `intensity_lpips` and the refined ray-drop metrics in
     `results.json`, the refined `raydrop_acc` beside phase 22's unrefined
     one; times one frame's LPIPS (CUDA events) and holds it against the
     CPU's.
 27. trains data-parallel in one process (`parallel/shard.py` `DPTrainer`,
     DP_BATCH frames a step, replaying its two CUDA graphs around the
     collectives by default): DP_BATCH identical frames give one
     `Trainer.step`'s parameters (DP_TOL) and DP_BATCH times its visits;
     DP_BATCH distinct frames train N_STEPS steps, DP_BATCH K1 and K2
     launches each, and densify once (grown - pruned = the change); the
     witness (`dp_grouped`) trains the N_STEPS steps again in one process
     with the gradients summed in phase 28's order; `DPTrainer(graphed=
     False)` trains them again, and both take two steps without the
     statistics from their densified states: every state leaf bit for bit
     (or within a second eager run's spread), losses and densify equal; a
     graphed step runs under `set_sync_debug_mode` and must not
     synchronize; the graphed and the eager step are timed (CUDA events,
     median, min and max of TRAIN_TIMED after 3 warm-ups) beside DP_BATCH x
     phase 9's and profiled (device ms, launches, busy share); the graph
     pool's bytes at 1, 2 and DP_BATCH frames and at the CLI's capacity;
     SURFEL_DP_STEPS surfel DP steps launch DP_BATCH K5 and K6 each, held to
     eager's bit for bit with and without the statistics, both timed;
 28. starts a fleet of DP_FLEET processes on this card (gloo, through
     `parallel/scaling.py` `launch_fleet`; this script with `--fleet` is
     the rank) that trains the same steps, graphed, each rank its share of
     every batch: DP_BATCH / DP_FLEET K1 and K2 launches a rank and step,
     equal fingerprints, `valid` after the densify bit for bit and the
     state against phase 27's and the witness's (DP_TOL); each rank then
     trains them eagerly and holds its graphed state to that run's (within
     DP_TOL's fleet_param_atol, bit equality reported); it reports the
     graphed and eager step's ms and the all-reduce's calls and bytes, and
     its ms in three parts (`collectives.settle` on: waiting for the card
     and the other rank, the host copies, the transfer). Ranks sharing one
     card: not a scaling figure;
 29. in the same fleet renders phase 1's frame 0 with `render_field_sharded`
     (anchors and tiles over DP_FLEET ranks: one K1 launch a rank on half
     the tiles), against phase 1's image (color 1e-5, depth 1e-4, and
     whether bit-equal), the gradient of JAX's test loss against the
     unsharded render's (DP_TOL), and runs `measure_dp_rate`;
 30. on phase 19's street, runs the CLI with `--data_parallel 1 --dp_batch
     DP_BATCH` (DP_BATCH K1 and K2 launches a step; on the card every step
     returns the same, donated, state buffers: its graphs replay; host ms a
     step, each ending in a synchronize), then a fleet of
     DP_FLEET processes (`--num_processes --process_id --coordinator
     --dp_batch DP_FLEET`, an evaluation at half and a snapshot at the
     end): one coordinator's files, rank 1's log `outputs.p1.log`, one K1
     and one K2 launch a rank and step, a snapshot that loads in one
     process;
 31. writes a DyNFL bundle from phase 19's street (its range images and
     poses, not raycast again) with one vehicle added: a 4.5 x 2 x 1.6 m box
     in the opposite lane driving 1.0 m a frame ahead of the sensor (which
     moves 0.6), raycast alone (`raycast_world`) and taken where it is
     nearer than the street; reads it with `read_dynamic_scene` into a
     background and a vehicle sub-scene; holds `knn3_mean_sq_dist` (N3, one
     launch) of the background's DYN_INIT_SAMPLES init points against the
     k-d tree and against its plain version bit for bit, two launches bit
     for bit, and times N3 and the plain version;
 32. trains each sub-scene DYN_STEPS `Trainer.step`s through the masked
     losses at the CLI's raster defaults (one K1 and one K2 launch a step,
     counted), with one densify; the loss must fall; times a step (CUDA
     events) and profiles 3; holds one masked step's K1 and K2 (and its
     gradients) against the plain versions;
 33. renders each sub-scene's four test frames (one K1 launch each) and
     reports depth L1 and intensity PSNR over each frame's mask, before and
     after training;
 34. runs the step and the render as CUDA graphs against eager
     (`graph_phases`): `Trainer(graphed=True)` and `Trainer(graphed=False)`
     train GRAPH_STEPS steps of the beam and the surfel variant and of a
     masked vehicle-style field from one state, with a densify at half and
     the statistics off for the last quarter; every TrainState leaf and the
     render must agree bit for bit (or within a second eager run's spread
     from the first); one eager and one graphed step and frame run under
     `torch.cuda.set_sync_debug_mode` and must not synchronize with the
     card; graph and eager ms a step and a frame (CUDA events, median of
     GRAPH_TIMED after 3 warm-ups), device ms, launches and runtime calls
     (torch.profiler), and the graph pool's bytes, also of one beam step at
     the CLI's capacity 2**17.

`Trainer`, `DPTrainer`, `measure_fps` and `run_eval` replay CUDA graphs on
the card by default, so phases 1-2, 7-9, 12, 15-24, 27-28, 30-33 and
phase 29's `measure_dp_rate` run graphed steps and renders (a graph replay
adds its captured launches to the counts).

It prints a timing line, a `kernels` line (K1-K8, then the nearest-neighbour
kernels N1-N3 of `csrc/knn.cu`), the card's name and power limit
(`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`) and, as
the last line, `{"ok": true, "device": {...}}`. Any failure exits non-zero
before that line; without a CUDA device it exits non-zero at once.

Tolerances, kernel against plain PyTorch on identical inputs: the kernels
multiply the transmittance in sequence where the plain versions take a
chunked cumprod, so a pixel whose T*(1-alpha) sits at the 1e-4 threshold can
stop one instance earlier or later.
  * K1: features and final T: mean |d| <= 1e-5, max |d| <= 2e-2; depth
    (metres): mean |d| <= 1e-3, max |d| <= 2.0.
  * K2: each dinst column scaled by its largest magnitude: mean |d| <= 1e-5,
    at most 64 elements beyond 2e-5 (the 16 columns of four rows whose
    instance sits at a flipped pixel), max <= 1e-3. On the smoke scene the
    H100 read a mean of 3.9e-9, a max of 9.7e-7 and no element beyond 2e-5
    over 183,125 touched rows: the max allows ~1000 times that, and a flip
    whose pixel carries more than 0.1% of its column's largest gradient
    fails.
  * Gradients of one step, kernels against plain versions, per parameter
    leaf: |g_k - g_p| / |g_p| <= 1e-2 and cosine >= 0.999 (both variants).
  * K5 (and the tiled surfel render against the golden one): features, T,
    normal, M1 and M2 as K1's features; depth (metres) as K1's depth. The
    median depth and the distortion also flip where a pixel's T-before sits
    at 0.5, and then the median moves by metres: at most 1% of the pixels
    beyond 1e-3 m (median) or 1e-5 (distortion), a median within the far
    plane (80 m) and a distortion within 2e-2 everywhere. On the smoke
    scene the H100 read a feature mean of 4.7e-9 and max of 3.0e-7, a depth
    max of 1.5e-5 m, every pixel's median equal bit for bit and a
    distortion max of 1.9e-7.
  * K6: K2's bounds, each column scaled by its largest magnitude. Both take
    K5's output, so the median's cotangent goes to the same rows only where
    the plain version recomputes each pair's depth with K5's bits
    (`csrc/surfel_common.cuh`); the run reports how many pixels' medians
    the plain forward reproduces bit for bit. On the smoke scene the H100
    read a mean of 6.4e-9, a max of 2.8e-5 and 3 elements beyond 2e-5 over
    315,277 touched rows.
  * K3, K7 (window forms): bit for bit equal to K1, K5 on the same rows, and
    against their plain versions K1's and K5's bounds above.
  * The 3-NN and chamfer distances against the k-d tree (float64): each
    point's squared distance within 1e-6 (|x|^2 + |y|^2) + 1e-6 m^2 of the
    tree's (`gram_tol`: the float32 Gram form rounds ~13 terms of that
    size; TF32 would be ~1e3 times off), the chamfer distance within the
    mean of those bounds, the F-score within the share of points whose
    distance lies within its bound of tau = 0.05.
  * The UNet on the card against the CPU (phase 25, UNET_CARD_TOL): its
    output within 1e-4 (float32 gives ~1e-5; TF32's rounding unit, 4.9e-4,
    would show); its parameter gradients within 3e-2 of the whole's norm,
    each leaf within 5e-2 of its own plus 1e-5 of the whole's: BatchNorm's
    backward takes each channel's mean out of the cotangent and the weight
    gradients above it sum that against positive activations, so a rounding
    error in the mean returns multiplied by about sqrt(pixels)
    (`tests/test_torch_raydrop.py` measures the spread on the CPU).
  * LPIPS of one frame on the card against the CPU: 1e-4 relative (float32
    convolutions and means in another order).
  * Data-parallel (DP_TOL): DP_BATCH identical frames against one step,
    JAX's bounds (`tests/test_parallel.py`), params within 1e-5 + 1e-4 |p|
    where the gradient is above 1e-3 of its leaf's largest (Adam's first
    step is a sign step: a noise-level gradient moves by +-lr either way,
    so every entry only within two of its group's learning rates); the fleet
    against one process (only the gradient sum's order differs): the first
    step's reduced gradients within 1e-4 relative norm per leaf, each step's
    loss within 1e-5, `valid` and the visits equal; the first step's Adam
    moments and the final parameters within 1e-5 of the witness, one process
    that sums the frames' gradients in the fleet's order ((f0 + f1) + (f2 +
    f3), `dp_grouped`). Against the plain one-process run, whose order is
    ((f0 + f1) + f2) + f3, the final parameters are only reported, beside
    the witness's distance from it: Adam's sign steps on noise-level
    gradients carry a rounding difference up to about a learning rate. The
    sharded render's gradient against the unsharded one's, JAX's
    bounds for its sharded render (atol 3e-5, rtol 2e-3).
  * knn3_mean_sq_dist (phase 31) against the k-d tree: each point within
    1e-6 of the tree's value relative (direct float32 differences: about
    eight roundings of the result's size), plus 1e-12 m^2.
  * N1 and N2 against their plain versions (phase 21): each row within
    `gram_tol` of the tree's neighbour (the kernels round the dot product
    and the -2 step in another order than cuBLAS's addmm), the chamfer
    distance within the mean of those bounds, the F-score within the share
    of points near tau; N3 against its plain version (phase 31) bit for bit
    (both round every step alone); two launches of each bit for bit.
  * K4, K8: the owned rows bit for bit equal to K2's, K6's rows [0, count)
    on the same inputs and every other row of dbuf exactly zero; the owned
    rows against the plain versions' within K2_TOL. A fused step's
    gradients against the materialized step's within GRAD_TOL (the gather's
    backward sums each gaussian's rows in another order).
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H, W = 64, 2650
N_ANCHORS = 60_000
MODEL = dict(anchor_capacity=65_536)              # feat 32, k=6, hidden 32, C=2
RASTER = dict(tile_h=4, tile_capacity=768, max_tiles_per_gaussian=8,
              max_visible=2 ** 18)                # the CLI's render defaults
N_FRAMES = 8
WARMUP = 3
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_OPS_PER_S = 67e12    # H100 SXM FP32, outside the tensor cores
OPS_IN_RECT = 35               # per pixel-instance pair inside the parity rect
OPS_OUT_RECT = 4               # the rect test alone
OPS_APPLIED_BWD = 80           # K2 per applied pair: the forward recompute and the backward
#                                chain, plus one add per gradient column (14 + C) for the
#                                reduction; K2's other in-rect pairs cost the forward's count
N_STEPS = 8                    # training steps of the main path
TRAIN_TIMED = 20               # steps timed after warm-up
VOXEL = 0.1                    # densify voxel size (m)
# statistics from the first step on, one densify after the last step
OPT = dict(start_stat=0, update_from=0, update_interval=N_STEPS, update_until=10 ** 6)

TOL = {"feat_mean": 1e-5, "feat_max": 2e-2, "depth_mean": 1e-3, "depth_max": 2.0}
K2_TOL = {"mean": 1e-5, "atol": 2e-5, "far_count": 64, "max": 1e-3}
GRAD_TOL = {"rel_norm": 1e-2, "cos": 0.999}
# the surfel variant: the CLI's surfel defaults (tile_h 1, capacity 384,
# max_tiles_per_gaussian left at 32)
SURFEL_RASTER = dict(tile_h=1, tile_capacity=384, max_tiles_per_gaussian=32,
                     max_visible=2 ** 18)
SURFEL_TOL = {"median_atol": 1e-3, "median_far_frac": 0.01, "median_max": 80.0,
              "dist_atol": 1e-5, "dist_far_frac": 0.01, "dist_max": 2e-2}
K6_TOL = K2_TOL
# FP32 operations per pixel-surfel pair, counted from csrc/surfel_common.cuh
# and the kernels' loops (each add, multiply, divide, sqrt, compare or
# select one; expf one):
OPS_S_OUT_RECT = 5             # the valid flag and the four rect compares
OPS_S_IN_RECT = 85             # those, surfel_pair (five 3-dot products, two divides,
#                                the rho2d form, the selects), surfel_alpha, the tests
#                                and the transmittance step
OPS_S_FWD_APPLIED = 28         # + 2 C: K5's accumulators (w, features, depth, normal,
#                                the distortion map and term, M1, M2, the median)
OPS_S_BWD_APPLIED = 288        # + 4 C: K6 per applied pair: the replayed pair (85), the
#                                chain (188 + 3 C) and one add per gradient column
#                                (15 + C) for the reduction
# the training CLI on a dataset (phases 19-23): the procedural street at the
# sensor's width, 46 train and 4 test frames, the CLI's defaults but the
# voxel (0.2 m: ~53k anchors of the 131,072 capacity)
CLI_SCENE = dict(n_frames=50, H=64, W=2650, seed=0)
CLI_NUM_FRAMES = 50           # frames the CLI reads (--num_frames), in the reference's order
CLI_VOXEL = "0.2"
CLI_EXTRA: list = []          # more CLI flags (the CPU rehearsal shrinks the field)
CLI_ITERS = 200               # checkpoint and densify at half and at the end
CLI_SURFEL_ITERS = 20
CLI_LOG_EVERY = 50
CLI_PROFILE_STEPS = 5
KNN_POINTS = 500_000          # init-cloud points held against the k-d tree
# FP32 operations per point pair of the nearest-neighbour kernels N1-N3
# (csrc/knn.cu; each add, multiply, compare or select one): the Gram value
# |p|^2 - 2 q.p is three multiplies and three adds (the -2 scales the staged
# point once, not per pair), the direct one three subtracts, three
# multiplies and two adds; one compare against the minimum or the k-th
# smallest. The sorted insertion after a compare that wins is left out: it
# runs O(k log N) times a row, not once a pair.
OPS_GRAM_PAIR = 7
OPS_DIRECT_PAIR = 9
KNN_TIMED = 5                 # kernel launches timed after a warm-up (N1-N3)
PLAIN_KNN_TIMED = 2           # plain and library calls timed (seconds each at 500k points)
REFINE_EPOCHS = 5             # refiner epochs over the dumps (JAX's default: 100)
REFINE_TIMED = 20             # refine steps timed per arch after warm-up
UNET_CARD_TOL = {"out_max": 1e-4, "rel": 5e-2, "global_rel": 1e-5, "whole": 3e-2}
LPIPS_CARD_RTOL = 1e-4
# data-parallel and multi-process training, the sharded render (phases 27-30)
DP_BATCH = 4                  # frames a data-parallel step
DP_FLEET = 2                  # processes of the fleets, all on this card (gloo)
SURFEL_DP_STEPS = 2           # surfel DP steps of phase 27
DP_RATE_STEPS = 5             # measure_dp_rate's timed steps in the fleet
RENDER_TIMED = 5              # sharded renders timed per rank
CLI_DP_ITERS = 6              # phase 30's CLI iterations (an eval at half, a save at the end)
FLEET_TIMEOUT = 600           # seconds a fleet may take
DP_TOL = {"param_atol": 1e-5, "param_rtol": 1e-4, "fleet_grad_rel": 1e-4,
          "fleet_loss_rel": 1e-5, "fleet_param_atol": 1e-5,
          "grad_atol": 3e-5, "grad_rtol": 2e-3}
# the dynamic decomposition (phases 31-33) on phase 19's street
DYN_VEHICLE = dict(length=4.5, width=2.0, height=1.6, y=-3.3, x0=8.0, speed=1.0, albedo=0.5)
DYN_INIT_SAMPLES = 500_000    # the background's init points (the reader's default)
DYN_STEPS = 100               # masked training steps of each sub-scene, a densify at half
DYN_TIMED = 10                # steps timed after warm-up
# the step and the render as CUDA graphs (phase 34): steps from one state,
# eager and graphed, a densify at half and the statistics off for the last
# quarter; the vehicle-style field (a 1,339-anchor sub-scene in a 4,096
# capacity, as phase 32's vehicle) trains masked
GRAPH_STEPS = {"beam": 20, "surfel": 10, "masked": 10}
GRAPH_TIMED = 20              # graphed and eager steps and frames timed after warm-up
GRAPH_VEHICLE = dict(anchors=1_339, capacity=4_096)
GRAPH_CLI_CAPACITY = 2 ** 17  # the CLI's anchor capacity, for the graph pool's bytes
DYN_VOXEL = {"background": 0.2, "vehicle": 0.1}
DYN_CAPACITY = {"background": 65_536, "vehicle": 4_096}
DYN_MIN_ANCHORS = {"background": 10_000, "vehicle": 200}
DYN_KNN_TOL = {"rel": 1e-6, "abs": 1e-12}
# the sizes a fleet rank takes over from this process (the CPU rehearsal shrinks them)
SIZE_NAMES = ("H", "W", "N_ANCHORS", "MODEL", "RASTER", "OPT", "N_STEPS", "N_FRAMES",
              "DP_BATCH", "DP_RATE_STEPS", "RENDER_TIMED")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def check_against(name: str, got, want, C: int) -> dict:
    """|got - want| over [T, 8, NPIX] (or [C+2]-row image stacks): feature
    and T rows against the feature tolerance, the depth row against the
    depth tolerance. Returns the error summary; fails out of tolerance."""
    import torch

    d = (got - want).abs()
    rows = list(range(C)) + [C + 1]
    feat, dep = d[:, rows], d[:, C]
    err = {
        "feat_mean": float(feat.mean()), "feat_max": float(feat.max()),
        "depth_mean": float(dep.mean()), "depth_max": float(dep.max()),
        "n_pix_feat_gt_1e-4": int((feat.amax(1) > 1e-4).sum()),
    }
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    for k, lim in TOL.items():
        if not err[k] <= lim:
            fail(f"{name}: {k} = {err[k]:.3e} exceeds {lim:.1e} ({err})")
    print(f"# {name}: {err}", file=sys.stderr)
    return err


def time_ms(fn, iters: int, warmup: int) -> list:
    """Per-call device time in ms from CUDA events, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    ev[0].record()
    for i in range(iters):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(iters)]


def time_cold_ms(fn, iters: int = 20) -> float:
    """Median device ms of `fn` from CUDA events around each call alone,
    with the card's 50 MB L2 cache flushed before it (256 MB written
    outside the timed span)."""
    import numpy as np
    import torch

    flush = torch.empty(2 ** 26, dtype=torch.float32, device="cuda")
    fn()
    ms = []
    for _ in range(iters):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return float(np.median(ms))


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take for a function that must move
    `n_bytes` and do `n_ops` FP32 operations: the larger of the two times
    at the card's peak rates."""
    tb, to = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_FP32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "bytes_ms": tb, "ops": n_ops, "ops_ms": to,
            "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations"}


def tile_bytes(counts, rows_walked: int, cols: int, pix, *elements: int) -> int:
    """Bytes a composite function over tiles must move: `cols` columns (the
    ones the function reads) of the `rows_walked` rows of the tiles' lists
    that some pixel's walk reaches, the counts, the five rows of each pixel
    block it reads (direction, column, row), and `elements` more f32
    elements (the rows read of other inputs, the output written)."""
    T, _, npix = pix.shape
    return 4 * (rows_walked * cols + counts.numel() + T * 5 * npix + sum(elements))


def warp_rows(pairs) -> int:
    """(tile, warp of 32 pixels, row) triples in which some lane's pair is
    set, of an [tiles, rows, NPIX] mask of pairs (the kernels' warps are 32
    consecutive pixels of a tile, the last one padded). Of the applied
    pairs: the row reductions a backward kernel runs; of the visited pairs:
    the rows a warp walks; of the visited pairs inside the rect: those in
    which a lane does more than the rect test."""
    import torch

    g, K, npix = pairs.shape
    lanes = torch.nn.functional.pad(pairs.to(torch.uint8), (0, -npix % 32))
    return int(lanes.view(g, K, -1, 32).amax(-1).sum())


def masked_warp_rows(mask, visited) -> int:
    """(tile, warp, row) visits of the forward kernels' masked walk: the
    rows of an [tiles, rows, n_warps] `warp_row_mask` in each chunk of
    FWD_CHUNK rows that the warp walks, which it does unless all its lanes
    are done when the chunk lands, i.e. iff one of its lanes visits the
    chunk's first row ([tiles, rows, NPIX] `visited`)."""
    import torch

    from lidargs_torch.ops.composite_kernel import FWD_CHUNK

    g, K, npix = visited.shape
    lanes = torch.nn.functional.pad(visited.to(torch.uint8), (0, -npix % 32))
    walks = lanes.view(g, K, -1, 32).amax(-1)[:, ::FWD_CHUNK]         # [g, chunks, n_warps]
    walks = walks.repeat_interleave(FWD_CHUNK, dim=1)[:, :K].bool()
    return int((mask & walks).sum())


def walked_pairs(inst, counts, pix, C: int, cfg, group: int = 16):
    """Pixel-instance pairs that K1's sequential walk visits on these inputs
    (each pixel's live rows up to and including its first transmittance
    crossing), as (applied, other in rect, out of rect, rows, reducing warp
    rows, warp rows visited, warp rows visited in rect, warp rows of the
    masked walk): the pairs that pass and are blended (K2 runs its backward
    chain and reduction on these alone), the other pairs inside the
    instance's parity rect (the alpha arithmetic, then a failed test or the
    crossing), the pairs outside it (the rect test alone), the rows of the
    tiles' lists that some pixel visits (the rows the function must read),
    the `warp_rows` of the applied pairs (K2's row reductions), of the
    visited pairs (what a warp walks when it visits every row, as K2 does)
    and of the visited pairs inside the rect, and the visits of K1's masked
    walk (`masked_warp_rows`): at least the last, as it also counts the
    masked rows of a chunk after the warp's last lane has stopped."""
    import torch

    from lidargs_torch.ops.composite_kernel import warp_row_mask
    from lidargs_torch.ops.projection import PackedCols as PC

    T, K, _ = inst.shape
    rc = PC.rect(C).start
    k = torch.arange(K, device=inst.device)[None, :, None]
    n_app = n_in = n_out = n_rows = n_warp = n_wvis = n_wrect = n_wmask = 0
    for t0 in range(0, T, group):
        r = inst[t0:t0 + group]
        col = lambda i: r[:, :, i, None]                            # [g,K,1]
        dirx, diry, dirz, px, py = (pix[t0:t0 + group, i, None, :] for i in range(5))
        live = k < counts[t0:t0 + group, None, None]
        in_rect = (live & (px >= col(rc)) & (px < col(rc + 1))
                   & (py >= col(rc + 2)) & (py < col(rc + 3)))
        dx, dy, dz = col(0) - dirx, col(1) - diry, col(2) - dirz
        ddx = dx * col(3) + dy * col(4) + dz * col(5)
        ddy = dx * col(6) + dy * col(7) + dz * col(8)
        power = -0.5 * (col(9) * ddx * ddx + col(11) * ddy * ddy) - col(10) * ddx * ddy
        alpha = (col(PC.OPACITY) * torch.exp(power)).clamp_max(cfg.alpha_clamp)
        passed = in_rect & (power <= 0.0) & (alpha >= cfg.alpha_min)
        t_incl = torch.cumprod(torch.where(passed, 1.0 - alpha, 1.0), dim=1)
        cross = (passed & (t_incl < cfg.transmittance_min)).to(torch.int32)
        visited = live & ((torch.cumsum(cross, 1) - cross) == 0)
        applied = visited & passed & (cross == 0)
        n_app += int(applied.sum())
        n_in += int((visited & in_rect).sum())
        n_out += int((visited & ~in_rect).sum())
        n_rows += int(visited.any(dim=2).sum())
        n_warp += warp_rows(applied)
        n_wvis += warp_rows(visited)
        n_wrect += warp_rows(visited & in_rect)
        mask = warp_row_mask(r, counts[t0:t0 + group], pix[t0:t0 + group], rc)
        n_wmask += masked_warp_rows(mask, visited)
    return n_app, n_in - n_app, n_out, n_rows, n_warp, n_wvis, n_wrect, n_wmask


def check_dinst(name: str, got, want, nv: int, tol: dict) -> dict:
    """A backward kernel's dinst ([T, K, F], or the owned rows [n, F] of a
    window kernel's dbuf) against the plain version's, each of its first
    `nv` columns scaled by its largest magnitude; the columns after must be
    zero. Fails out of `tol`."""
    import torch

    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite dinst")
    if bool((got[..., nv:] != 0).any()):
        fail(f"{name}: nonzero columns after the first {nv}")
    scale = want[..., :nv].flatten(0, -2).abs().amax(dim=0).clamp_min(1e-30)
    d = (got[..., :nv] - want[..., :nv]).abs() / scale
    err = {"mean": float(d.mean()), "max": float(d.max()),
           "far_count": int((d > K2_TOL["atol"]).sum()),
           "max_abs": float((got - want).abs().max()),
           "mean_abs": float((got - want).abs().mean()),
           "rows_touched": int((want[..., :nv].abs().amax(-1) > 0).sum())}
    for k in ("mean", "far_count", "max"):
        if not err[k] <= tol[k]:
            fail(f"{name} vs plain: {k} = {err[k]:.3e} exceeds {tol[k]:.1e} ({err})")
    print(f"# {name} vs plain (one step's inputs): {err}", file=sys.stderr)
    return err


def check_surfel(name: str, got, want, C: int) -> dict:
    """|got - want| over [n, rows, ...] stacks in K5's row layout (features,
    depth, T, normal, median, distortion, and M1/M2 where present):
    features, T, normal and M1/M2 against TOL's feature bounds, the depth
    against its depth bounds, the median and the distortion against
    SURFEL_TOL's counts of far pixels and max bounds."""
    import torch

    d = (got - want).abs()
    rows = list(range(C)) + [C + 1, C + 2, C + 3, C + 4]
    if got.shape[1] > C + 8:
        rows += [C + 7, C + 8]
    feat, dep, med, dist = d[:, rows], d[:, C], d[:, C + 5], d[:, C + 6]
    err = {
        "feat_mean": float(feat.mean()), "feat_max": float(feat.max()),
        "depth_mean": float(dep.mean()), "depth_max": float(dep.max()),
        "median_far_frac": float((med > SURFEL_TOL["median_atol"]).float().mean()),
        "median_max": float(med.max()),
        "dist_far_frac": float((dist > SURFEL_TOL["dist_atol"]).float().mean()),
        "dist_max": float(dist.max()),
        "median_bit_equal_frac": float((got[:, C + 5] == want[:, C + 5]).float().mean()),
    }
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite output")
    for k, lim in list(TOL.items()) + [(k, v) for k, v in SURFEL_TOL.items()
                                       if not k.endswith("atol")]:
        if not err[k] <= lim:
            fail(f"{name}: {k} = {err[k]:.3e} exceeds {lim:.1e} ({err})")
    print(f"# {name}: {err}", file=sys.stderr)
    return err


def walked_surfel_pairs(inst, counts, pix, C: int, cfg, group: int = 16):
    """Pixel-surfel pairs that K5's sequential walk visits on these inputs
    (each pixel's live rows up to and including its first transmittance
    crossing), as (applied, other past the valid and rect tests, stopped by
    them, rows, reducing warp rows, warp rows visited, warp rows visited
    past the valid and rect tests, warp rows of the masked walk): the pairs
    blended (K5's accumulators and K6's chain run on these alone), the
    other pairs that reach the pair geometry, the pairs that cost the cheap
    tests alone, the rows of the tiles' lists that some pixel visits, the
    `warp_rows` of the applied pairs (K6's row reductions), of the visited
    pairs and of the visited pairs past the cheap tests, and the visits of
    K5's masked walk (`masked_warp_rows`; its mask folds the valid flag in)."""
    import torch

    from lidargs_torch.ops.composite_kernel import warp_row_mask
    from lidargs_torch.ops.surfel import SurfelCols as S
    from lidargs_torch.ops.surfel import pair_geometry

    T, K, _ = inst.shape
    rc, vf = S.rect(C).start, S.validf(C)
    k = torch.arange(K, device=inst.device)[None, :, None]
    n_app = n_in = n_out = n_rows = n_warp = n_wvis = n_wrect = n_wmask = 0
    for t0 in range(0, T, group):
        r = inst[t0:t0 + group]
        col = lambda i: r[:, :, i, None]                            # [g,K,1]
        dirx, diry, dirz, px, py = (pix[t0:t0 + group, i, None, :] for i in range(5))
        live = k < counts[t0:t0 + group, None, None]
        cheap = (live & (col(vf) > 0.0) & (px >= col(rc)) & (px < col(rc + 1))
                 & (py >= col(rc + 2)) & (py < col(rc + 3)))
        g = pair_geometry(r, dirx, diry, dirz, px, py, C, cfg)
        passed = live & g.passed
        t_incl = torch.cumprod(torch.where(passed, 1.0 - g.alpha, 1.0), dim=1)
        cross = (passed & (t_incl < cfg.transmittance_min)).to(torch.int32)
        visited = live & ((torch.cumsum(cross, 1) - cross) == 0)
        applied = visited & passed & (cross == 0)
        n_app += int(applied.sum())
        n_in += int((visited & cheap).sum())
        n_out += int((visited & ~cheap).sum())
        n_rows += int(visited.any(dim=2).sum())
        n_warp += warp_rows(applied)
        n_wvis += warp_rows(visited)
        n_wrect += warp_rows(visited & cheap)
        mask = warp_row_mask(r, counts[t0:t0 + group], pix[t0:t0 + group], rc, vf)
        n_wmask += masked_warp_rows(mask, visited)
    return n_app, n_in - n_app, n_out, n_rows, n_warp, n_wvis, n_wrect, n_wmask


def grad_diff(a: dict, b: dict) -> dict:
    """Per parameter leaf: relative norm of a - b and the cosine of a and b
    (b is the reference)."""
    from lidargs_torch.train.optim import tree_leaves

    out = {}
    for name, x, y in zip(leaf_names(a), tree_leaves(a), tree_leaves(b)):
        x, y = x.double().flatten(), y.double().flatten()
        ny = float(y.norm())
        out[name] = {
            "rel_norm": float((x - y).norm()) / ny if ny > 0 else float((x - y).norm()),
            "cos": float(x @ y) / (float(x.norm()) * ny) if ny > 0 else 1.0,
            "max_abs": float((x - y).abs().max()), "norm": ny,
        }
    return out


@contextlib.contextmanager
def plain_versions(mod, name: str):
    """Route a composite autograd function through the plain PyTorch
    versions of its kernels: `mod.<name>` and `mod.<name>_bwd` (looked up at
    call time) become `<name>_plain` and `<name>_bwd_plain`, for holding the
    kernels' gradients against theirs."""
    fwd, bwd = name, name + "_bwd"
    saved = getattr(mod, fwd), getattr(mod, bwd)
    setattr(mod, fwd, getattr(mod, fwd + "_plain"))
    setattr(mod, bwd, getattr(mod, bwd + "_plain"))
    try:
        yield
    finally:
        setattr(mod, fwd, saved[0])
        setattr(mod, bwd, saved[1])


def owned_rows(starts, counts, n_rows: int):
    """[n_rows] bool: the rows [starts[t], starts[t] + counts[t]) that some
    tile owns in a window kernel's buffer."""
    import torch

    edge = torch.zeros(n_rows + 1, dtype=torch.int64, device=starts.device)
    edge.index_add_(0, starts.long(), torch.ones_like(starts, dtype=torch.int64))
    edge.index_add_(0, (starts + counts).long(), -torch.ones_like(counts, dtype=torch.int64))
    return torch.cumsum(edge, 0)[:n_rows] > 0


def kernel_vs_plain(mod, name: str, grads, nv: int, tol: dict, label: str):
    """One step's gradients through the kernels of a composite autograd
    function against those through its plain versions (GRAD_TOL per leaf),
    and its backward kernel `mod.<name>_bwd` against `<name>_bwd_plain` on
    the arguments that step gave it (`check_dinst`, `tol`). `grads()` runs
    the step and returns (parameter gradients, proxy gradient). For a window
    kernel (a 2-D buffer first) the rows no tile owns must be zero in the
    kernel's dbuf, and the owned rows are compared. Returns the captured
    backward arguments, the kernel's dinst, the dinst error, the per-leaf
    gradient differences and the kernels' gradients."""
    import torch

    from lidargs_torch.train.optim import tree_leaves

    run_bwd = getattr(mod, name + "_bwd")
    captured = []

    def record(*args):
        captured.append(args)
        return run_bwd(*args)

    setattr(mod, name + "_bwd", record)
    try:
        g_k, pg_k = grads()
    finally:
        setattr(mod, name + "_bwd", run_bwd)
    with plain_versions(mod, name):
        g_p, pg_p = grads()
    torch.cuda.synchronize()
    for g in tree_leaves(g_k) + [pg_k]:
        if not bool(torch.isfinite(g).all()):
            fail(f"{label}: non-finite gradients")
    with torch.no_grad():
        d_k = run_bwd(*captured[0])
        d_p = getattr(mod, name + "_bwd_plain")(*captured[0])
    torch.cuda.synchronize()
    if d_k.dim() == 2:
        own = owned_rows(*captured[0][1:3], d_k.shape[0])
        if bool((d_k[~own] != 0).any()):
            fail(f"{label}: a row that no tile owns is not zero")
        err = check_dinst(label, d_k[own], d_p[own], nv, tol)
    else:
        err = check_dinst(label, d_k, d_p, nv, tol)
    vs_plain = grad_diff({**g_k, "proxy": pg_k}, {**g_p, "proxy": pg_p})
    for leaf, e in vs_plain.items():
        if e["norm"] == 0:
            continue
        if not (e["rel_norm"] <= GRAD_TOL["rel_norm"] and e["cos"] >= GRAD_TOL["cos"]):
            fail(f"gradient of {leaf} with {label}, kernels vs plain: {e}")
    print(f"# grads with {label} vs plain: {vs_plain}", file=sys.stderr)
    return captured[0], d_k, err, vs_plain, {**g_k, "proxy": pg_k}


def time_vs_plain(kernel, plain, args) -> tuple:
    """Median device ms of a kernel's wrapper (50 calls) and of its plain
    version (5 calls) on the same arguments, from CUDA events."""
    import numpy as np

    k_ms = time_ms(lambda: kernel(*args), 50, 5)
    p_ms = time_ms(lambda: plain(*args), 5, 1)
    return float(np.median(k_ms)), float(np.median(p_ms))


def kernel_entry(name: str, source: str, replaces: str, launches: int, ms: float,
                 plain_ms: float, b: dict, library_ms: float | None = None,
                 **errors) -> dict:
    """One kernel's entry of the `kernels` line; a forward kernel's carries
    its bound's (tile, warp, row) visits, a nearest-neighbour kernel's its
    pairs."""
    visits = {k: b[k] for k in ("warp_row_visits", "warp_row_visits_in_rect",
                                "warp_row_visits_masked", "pairs") if k in b}
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, **errors, **visits, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "library_ms": library_ms}


def knn_bound(kernel: str, n_q: int, n_p: int, pairs: int, kk: int = 1) -> dict:
    """The bound of a nearest-neighbour kernel on `n_q` query rows and `n_p`
    point rows that compares `pairs` point pairs (the valid ones for N1):
    each input read once, each output written once (N1: both sets [N, 3]
    float32 and their bool masks, [n_q] out; N2: both sets, [n_q, kk] out;
    N3: one set of n_q = n_p points, [n_q] out), against `pairs` times the
    operations a pair."""
    if kernel == "N1":
        n_bytes, ops = 13 * (n_q + n_p) + 4 * n_q, OPS_GRAM_PAIR
    elif kernel == "N2":
        n_bytes, ops = 12 * (n_q + n_p) + 4 * n_q * kk, OPS_GRAM_PAIR
    elif kernel == "N3":
        n_bytes, ops = 16 * n_q, OPS_DIRECT_PAIR
    else:
        raise ValueError(f"unknown kernel {kernel}")
    return {**bound(n_bytes, ops * pairs), "pairs": pairs, "ops_per_pair": ops}


def knn_plan(dev, n_q: int, n_p: int, kk=None) -> dict:
    """The launch plan N1 (`kk` None) or N2 runs on these shapes on this card
    (`ops/knn_kernel.py` `plan_on_card`): rows a thread R, cluster size S,
    row blocks, slice rows, blocks, the blocks an SM holds, and the merge
    (the partners' lists read by cluster rank 0 from their shared memory)."""
    import dataclasses

    from lidargs_torch.ops import knn_kernel as nk

    plan = nk.plan_on_card(n_q, n_p, dev, kk)
    return {**dataclasses.asdict(plan), "blocks": plan.blocks,
            "blocks_per_sm": nk.card_plan_inputs(dev.index or 0, kk)[1], "merge": "cluster"}


# N3 keeps one query row a thread and one block over the whole set
N3_PLAN = {"rows_per_thread": 1, "cluster": 1, "merge": "none"}


def knn_times(kernel, plain, library=None) -> dict:
    """Median device ms of a nearest-neighbour kernel's wrapper (KNN_TIMED
    launches after one warm-up), of its plain version and of the library
    calls that the plain version makes (PLAIN_KNN_TIMED each), from CUDA
    events."""
    import numpy as np

    out = {"ms": float(np.median(time_ms(kernel, KNN_TIMED, 1))),
           "plain_ms": float(np.median(time_ms(plain, PLAIN_KNN_TIMED, 0)))}
    out["library_ms"] = (None if library is None
                         else float(np.median(time_ms(library, PLAIN_KNN_TIMED, 0))))
    return out


def profile_render(render, frames: int = 3) -> dict:
    """torch.profiler over `frames` renders (after one untimed profiled
    render that warms the tracer up): device time and device-side launches
    per frame, in total and for the costliest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        v = getattr(e, "device_time_total", None)
        return v if v is not None else getattr(e, "cuda_time_total", 0.0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        render()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            render()
        torch.cuda.synchronize()
    # the device's own rows (kernels, copies, memsets); the operator rows
    # that launched them would count the same time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    # host-side runtime calls (a host scalar written to the card is a
    # pageable copy and a synchronize, which a CUDA graph could not hold)
    # and the copies by kind
    runtime = {e.key: e.count / frames for e in prof.key_averages()
               if e.key in ("cudaStreamSynchronize", "cudaMemcpyAsync")
               or e.key.startswith("Memcpy")}
    if not kernels:
        return {"frames": frames, "device_ms_per_frame": "not measured",
                "runtime_calls_per_frame": runtime}
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {
        "frames": frames,
        "device_ms_per_frame": sum(dev_us(e) for e in kernels) / 1e3 / frames,
        "device_launches_per_frame": sum(e.count for e in kernels) / frames,
        "runtime_calls_per_frame": runtime,
        "top": [{"name": e.key[:90], "ms_per_frame": dev_us(e) / 1e3 / frames,
                 "calls_per_frame": e.count / frames} for e in top],
    }


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--fleet":
        fleet_worker(json.loads(sys.argv[2]), sys.argv[3:])
        return
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA device")
    run(torch.device("cuda", 0))


def run(dev) -> None:
    import numpy as np
    import torch

    import lidargs_torch
    if Path(lidargs_torch.__file__).resolve().parents[1] != ROOT:
        fail(f"lidargs_torch imported from {lidargs_torch.__file__}, not from {ROOT}")
    from lidargs_torch.config import ModelConfig, RasterConfig
    from lidargs_torch.lidar import LidarFrame, uniform_beam_inclinations
    from lidargs_torch.models.field import field_splats, render_field
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.ops.projection import PackedCols as PC
    from lidargs_torch.ops.projection import preprocess_gaussians
    from lidargs_torch.ops.rasterize import cull_sorted_rows, render_tiled, tile_inputs
    from lidargs_torch.ops.reference import render_reference
    from lidargs_torch.train import measure_fps, run_eval
    from lidargs_torch.utils import cuda_build
    from lidargs_torch.utils.testing import make_scene, sensor_poses, shell_field

    card_csv = card()
    print(f"# card: {card_csv}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)

    # --- build every kernel of the path ---
    t0 = time.perf_counter()
    libs = cuda_build.build(["composite_fwd", "composite_bwd", "surfel_fwd", "surfel_bwd",
                             "knn"])
    build_s = time.perf_counter() - t0
    for name, lib in libs.items():
        log = lib.with_suffix(".log").read_text().strip()
        print(f"# built {name} in {build_s:.1f} s:\n{log}", file=sys.stderr)

    # --- the full-width scene (CLI render defaults h4/K768/cap8) ---
    mcfg = ModelConfig(**MODEL)
    rcfg = RasterConfig(**RASTER)
    C = mcfg.color_channel
    params, valid = shell_field(mcfg, N_ANCHORS, seed=0, device=dev)
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    gt0 = np.zeros((3, H, W), np.float32)
    frames = [LidarFrame.from_lidar2world(p, beams, gt0, uid=i, device=dev)
              for i, p in enumerate(sensor_poses(N_FRAMES, seed=1))]
    bg = torch.zeros(2, device=dev)

    # --- 1. the main path: frames through measure_fps ---
    with torch.no_grad():
        ck.launches = 0
        res = measure_fps(params, valid, frames, mcfg, rcfg, bg, warmup=WARMUP, device=dev)
        k1_launches = ck.launches
    if k1_launches != N_FRAMES:
        fail(f"K1 launched {k1_launches} times for {N_FRAMES} frames")
    for i, out in enumerate(res.outputs):
        if tuple(out.color.shape) != (C, H, W) or tuple(out.depth.shape) != (H, W):
            fail(f"frame {i}: shapes {tuple(out.color.shape)}, {tuple(out.depth.shape)}")
        for name in ("color", "depth", "occ"):
            if not bool(torch.isfinite(getattr(out, name)).all()):
                fail(f"frame {i}: non-finite {name}")
    occ = [float(o.occ.mean()) for o in res.outputs]
    if not min(occ) > 0.0:
        fail(f"empty render: mean occupancy per frame {occ}")
    main_path = {
        "frames": N_FRAMES, "warmup": WARMUP, "fps_host_clock": res.fps,
        "host_ms_per_frame": [t * 1e3 for t in res.seconds],
        "mean_occ": occ,
        "n_overflow": [int(o.n_overflow) for o in res.outputs],
        "n_dropped": [int(o.n_dropped) for o in res.outputs],
        "n_visible": [int(o.visible.sum()) for o in res.outputs],
    }
    print(f"# main path: {json.dumps(main_path)}", file=sys.stderr)

    # --- 2. run_eval against a ground truth made from frame 0's render ---
    o0 = res.outputs[0]
    dmin, dmax = 5.0, 80.0
    gt = torch.stack([(o0.color[1] > 0.5).float(), o0.color[0].clamp(0.0, 1.0),
                      o0.depth.clamp(dmin, dmax)]).cpu().numpy()
    fr_gt = LidarFrame.from_lidar2world(sensor_poses(N_FRAMES, seed=1)[0], beams, gt,
                                        uid=0, device=dev)
    with torch.no_grad():
        ev = run_eval(params, valid, {"test": [fr_gt]}, mcfg, rcfg, bg,
                      str(ROOT / "build" / "chip_smoke"), dmin, dmax, device=dev)
    m = ev["test"]
    if not (m["intensity_l1"] == 0.0 and m["raydrop_acc"] == 1.0 and m["depth_mae"] == 0.0):
        fail(f"run_eval on a deterministic re-render is not exact: {m}")

    # --- 3. K1 render against the golden O(P*HW) renderer, small scene ---
    sc = make_scene(seed=3, n=400, H=32, W=256)
    t = lambda x: torch.from_numpy(x).to(dev)
    small = RasterConfig(tile_h=4, tile_capacity=512, max_tiles_per_gaussian=64,
                         max_visible=512, chunk=8)
    bg_s = torch.tensor([0.3, 0.7], device=dev)
    with torch.no_grad():
        sp = preprocess_gaussians(t(sc.means3d), t(sc.scales), t(sc.quats),
                                  t(sc.opacities), t(sc.feat), t(sc.mask),
                                  t(sc.w2s_rot), t(sc.w2s_trans), t(sc.beams), sc.W, small)
        tiled = render_tiled(sp, t(sc.beams), sc.W, bg_s, small)
        ref_c, ref_d, _ref_occ, ref_T = render_reference(sp, t(sc.beams), sc.W, bg_s, small)
    if int(tiled.n_overflow) != 0 or not float(tiled.occ.max()) > 0.5:
        fail(f"small scene: overflow {int(tiled.n_overflow)}, max occ {float(tiled.occ.max())}")
    stack = lambda c, d, T: torch.cat([c, d[None], T[None]])[None]
    err_ref = check_against("tiled K1 vs golden (small scene)",
                            stack(tiled.color, tiled.depth, tiled.final_T),
                            stack(ref_c, ref_d, ref_T), C)

    # --- 4. K1 against plain PyTorch on the main path's inputs of frame 0 ---
    with torch.no_grad():
        splats = field_splats(params, valid, frames[0], mcfg, rcfg)[0]
        pkv, _ = cull_sorted_rows(splats, rcfg)
        inst, counts, pix, _ = tile_inputs(pkv, frames[0].beams, W, rcfg, C)
        out_k = ck.composite_tiles(inst, counts, pix, C, rcfg)
        out_p = ck.composite_tiles_plain(inst, counts, pix, C, rcfg)
    torch.cuda.synchronize()
    err_k1 = check_against("K1 vs plain (frame 0 inputs)", out_k, out_p, C)
    shapes = {"inst": list(inst.shape), "counts": list(counts.shape),
              "pix": list(pix.shape), "mean_count": float(counts.float().mean()),
              "max_count": int(counts.max())}

    # --- 5. timing (CUDA events) and K1's bound from this run's inputs ---
    with torch.no_grad():
        k1_ms, plain_ms = time_vs_plain(ck.composite_tiles, ck.composite_tiles_plain,
                                        (inst, counts, pix, C, rcfg))
        render = lambda: render_field(params, valid, frames[0], mcfg, rcfg, bg)
        render_ms = time_ms(render, 30, 3)
        n_app, n_other, n_out, n_rows, _, n_wvis, n_wrect, n_wmask = walked_pairs(
            inst, counts, pix, C, rcfg)
        prof = profile_render(render)
    n_in = n_app + n_other
    # K1 reads the columns up to the rect's (PackedCols) of each row
    b1 = bound(tile_bytes(counts, n_rows, PC.rect(C).stop, pix, out_k.numel()),
               OPS_IN_RECT * n_in + OPS_OUT_RECT * n_out)
    b1.update(pairs_in_rect=n_in, pairs_applied=n_app, pairs_out_rect=n_out, rows=n_rows,
              warp_row_visits=n_wvis, warp_row_visits_in_rect=n_wrect,
              warp_row_visits_masked=n_wmask)
    print(f"# K1 bound {b1['bound_ms']:.4f} ms ({b1['bound_by']}); (tile, warp, row) visits of "
          f"a walk over every row: {n_wvis}, with a lane in the rect: {n_wrect}, of the masked "
          f"walk: {n_wmask}", file=sys.stderr)
    med = lambda xs: float(np.median(xs))

    # --- 7-9. training, K2 against plain, timing ---
    train, k2 = train_phases(dev, params, valid, mcfg, rcfg, beams)

    # --- 10-14. the surfel variant: render, K5 against plain, training, K6 ---
    surfel, k5, k6 = surfel_phases(dev, params, valid, mcfg, beams, frames)

    # --- 15-18. the fused-window gather of both variants: K3/K4, K7/K8 ---
    windows, k3, k4 = window_phases(dev, params, valid, mcfg, beams, frames, "beam")
    surfel_windows, k7, k8 = window_phases(dev, params, valid, mcfg, beams, frames, "surfel")

    # --- 34. the step and the render as CUDA graphs against eager ---
    graphs = graph_phases(dev, params, valid, mcfg, beams)

    # --- 27-29. data-parallel steps in one process and in a fleet, the sharded render ---
    dp, dp_launches = dp_phases(dev, params, valid, mcfg, rcfg, beams, res.outputs[0],
                                frames[0], train)
    for entry, key in ((k2, "K2"), (k5, "K5"), (k6, "K6")):
        entry.update(dp_launches[key])

    # --- 19-23. the training CLI on a dataset: train, resume, eval-only ---
    cli = cli_phases(dev)
    for entry, run_, key in ((k2, "beam", "K2"), (k5, "surfel", "K5"), (k6, "surfel", "K6")):
        entry["launches_cli"] = cli[run_]["launches"][key]
    dynamic = cli.pop("dynamic")
    k2["launches_dynamic"] = dynamic["launches"]["K2"]
    n_entries = knn_entries(cli, dynamic)

    timing = {
        "card": card_csv,
        "render_ms_per_frame_median": med(render_ms),
        "render_ms_per_frame_min": min(render_ms), "render_ms_per_frame_max": max(render_ms),
        "render_samples": len(render_ms),
        "fps_from_median": 1e3 / med(render_ms),
        "k1_ms_median": k1_ms, "plain_ms_median": plain_ms,
        "k1_inputs": shapes,
        "k1_bound": b1,
        "build_s": build_s,
        "main_path": main_path,
        "golden_small_err": err_ref,
        "profile": prof,
        "train": train,
        "surfel": surfel,
        "windows": windows,
        "surfel_windows": surfel_windows,
        "graphs": graphs,
        "cli": cli,
        "dp": dp,
        "dynamic": dynamic,
    }
    if isinstance(prof["device_ms_per_frame"], float):
        timing["device_busy_share"] = prof["device_ms_per_frame"] / med(render_ms)
    kernels = {
        "card": card_csv,
        "kernels": [kernel_entry(
            "composite_fwd", "lidargs_torch/csrc/composite_fwd.cu",
            "lidargs_tpu/ops/pallas_composite.py:175", k1_launches, k1_ms, plain_ms, b1,
            launches_train=train["k1_launches"], launches_cli=cli["beam"]["launches"]["K1"],
            launches_dump=cli["refine"]["dump"]["k1_launches"], **dp_launches["K1"],
            launches_dynamic=dynamic["launches"]["K1"],
            max_abs_err=max(err_k1["feat_max"], err_k1["depth_max"]),
            mean_abs_err={"feat": err_k1["feat_mean"], "depth": err_k1["depth_mean"]},
        ), k2, k3, k4, k5, k6, k7, k8, *n_entries],
    }
    print(json.dumps({"timing": timing}))
    print(json.dumps(kernels))
    print(card_csv)
    # the run uses one device
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}}))


def knn_entries(cli: dict, dynamic: dict) -> list:
    """The `kernels` line's entries of N1-N3: launches on their paths
    (phase 20's chamfer evaluations and init, phase 22's eval-only, phase
    21's oracle call, phase 31's), the comparisons, times and bounds of
    phases 21 and 31, each kernel's launch plan and the pairs it compares a
    second."""
    src = "lidargs_torch/csrc/knn.cu"
    ch, nn, n3 = cli["chamfer_oracle"], cli["knn_oracle"], dynamic["knn3_oracle"]

    def entry(name, replaces, launches, o, **extra):
        t = o["kernel"]
        return kernel_entry(name, src, replaces, launches, t["ms"], t["plain_ms"], o["bound"],
                            library_ms=t["library_ms"], **extra,
                            max_abs_err=o["vs_plain"]["max_abs_err"], plan=o["plan"],
                            pairs_per_s=o["bound"]["pairs"] / (t["ms"] / 1e3))

    return [
        entry("knn_chamfer", "lidargs_tpu/ops/knn.py:60", cli["beam"]["launches"]["N1"], ch,
              launches_eval_only=cli["eval_only"]["launches"]["N1"],
              max_err_over_tol=ch["vs_plain"]["max_err_over_tol"]),
        entry("knn_gram_topk", "lidargs_tpu/ops/knn.py:22", cli["beam"]["launches"]["N2"], nn,
              launches_oracle=nn["launches"],
              max_err_over_tol=nn["vs_plain"]["max_err_over_tol"]),
        entry("knn3_direct", "lidargs_tpu/native/lidargs_native.cpp:80", n3["launches"], n3,
              bit_equal=n3["vs_plain"]["bit_equal"]),
    ]


def train_frames(dev, beams, n: int | None = None) -> list:
    """`n` (default N_STEPS) training frames from sensor poses, with GT as
    the JAX package's train-step benchmark draws it."""
    import numpy as np

    from lidargs_torch.lidar import LidarFrame
    from lidargs_torch.utils.testing import sensor_poses

    rng = np.random.default_rng(4)
    frames = []
    for i, pose in enumerate(sensor_poses(N_STEPS if n is None else n, seed=2)):
        gt = np.zeros((3, H, W), np.float32)
        gt[0] = rng.uniform(size=(H, W)) > 0.2
        gt[1] = rng.uniform(size=(H, W)) * gt[0]
        gt[2] = rng.uniform(5.0, 70.0, size=(H, W)) * gt[0]
        frames.append(LidarFrame.from_lidar2world(pose, beams, gt, uid=i, device=dev))
    return frames


def train_phases(dev, params, valid, mcfg, rcfg, beams):
    """Phases 7-9 on the render scene: (summary for the timing line, K2's
    entry of the kernels line)."""
    import numpy as np
    import torch

    from lidargs_torch.config import OptConfig
    from lidargs_torch.models.field import AnchorField
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.ops.projection import PackedCols
    from lidargs_torch.train import Trainer, init_train_state, loss_and_grads
    from lidargs_torch.train.optim import tree_leaves

    C = mcfg.color_channel
    med = lambda xs: float(np.median(xs))
    ocfg = OptConfig(**OPT)
    bg = torch.zeros(2, device=dev)
    trainer = Trainer(mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, bg=bg)
    frames = train_frames(dev, beams)
    state0 = init_train_state(AnchorField(params=params, valid=valid, voxel_size=VOXEL), mcfg)

    # --- 7. the main path: N_STEPS training steps ---
    state, losses = state0, []
    ck.launches = ck.bwd_launches = 0
    for it in range(1, N_STEPS + 1):
        state, m = trainer.step(state, frames[it - 1], it)
        losses.append({f: float(getattr(m.loss, f)) for f in m.loss._fields})
    k1_launches, k2_launches = ck.launches, ck.bwd_launches
    if k1_launches != N_STEPS or k2_launches != N_STEPS:
        fail(f"{N_STEPS} steps launched K1 {k1_launches} and K2 {k2_launches} times")
    if not all(np.isfinite(list(l.values())).all() for l in losses):
        fail(f"non-finite loss terms: {losses}")
    moved = 0
    for a, b in zip(tree_leaves(state.params), tree_leaves(state0.params)):
        if not bool(torch.isfinite(a).all()):
            fail("non-finite parameters after training")
        moved += int((a != b).sum())
    if moved == 0:
        fail("training left every parameter as it was")
    stats = {
        "anchor_demon_max": float(state.anchor_demon.max()),
        "offset_denom_sum": float(state.offset_denom.sum()),
        "offset_grad_accum_sum": float(state.offset_grad_accum.sum()),
        "opacity_accum_sum": float(state.opacity_accum.sum()),
    }
    if not (stats["anchor_demon_max"] == N_STEPS and stats["offset_denom_sum"] > 0
            and stats["offset_grad_accum_sum"] > 0 and stats["opacity_accum_sum"] > 0):
        fail(f"densification statistics did not accumulate: {stats}")
    n_before = int(state.valid.sum())
    if not trainer.should_densify(n_before, N_STEPS):
        fail("the densify cadence does not fire after the last step")
    dense, dstats = trainer.densify(state, torch.Generator(device=dev).manual_seed(0), VOXEL)
    densify = {"n_anchors_before": n_before, "n_grown": int(dstats.n_grown),
               "n_pruned": int(dstats.n_pruned),
               "n_capacity_dropped": int(dstats.n_capacity_dropped),
               "n_anchors_after": int(dense.valid.sum())}
    if densify["n_anchors_after"] != n_before + densify["n_grown"] - densify["n_pruned"]:
        fail(f"densify: anchor count does not add up: {densify}")
    print(f"# train: losses {losses}; stats {stats}; densify {densify}", file=sys.stderr)

    # --- 8. K2 against plain on one step's inputs; gradients against plain ---
    frame = frames[0]
    grads = lambda: loss_and_grads(state, frame, bg, mcfg, rcfg, ocfg)[1:]
    bwd_args, d_k, err_k2, vs_plain, g_k = kernel_vs_plain(
        ck, "composite_tiles", grads, 14 + C, K2_TOL, "K2")
    g_k2, pg_k2 = grads()
    run_to_run = grad_diff({**g_k2, "proxy": pg_k2}, g_k)
    print(f"# grads run to run: {run_to_run}", file=sys.stderr)

    # --- 9. timing: the step, K2, the plain backward; K2's bound; profile ---
    inst, counts, pix = bwd_args[:3]
    held = [state]

    def one_step():
        held[0], _ = trainer.step(held[0], frame, 1)

    step_ms = time_ms(one_step, TRAIN_TIMED, 3)
    k2_ms, plain_bwd_ms = time_vs_plain(ck.composite_tiles_bwd, ck.composite_tiles_bwd_plain,
                                        bwd_args)
    n_app, n_other, n_out, n_rows, n_warp, *_ = walked_pairs(inst, counts, pix, C, rcfg)
    # profile_render reports per call; a call here is one step
    prof = profile_render(one_step, frames=3)
    # K2 reads K1's columns of each row, rows 0..C+1 of res and g
    T, _, npix = pix.shape
    b2 = bound(tile_bytes(counts, n_rows, PackedCols.rect(C).stop, pix,
                          2 * T * (C + 2) * npix, d_k.numel()),
               (OPS_APPLIED_BWD + 14 + C) * n_app + OPS_IN_RECT * n_other
               + OPS_OUT_RECT * n_out)
    b2.update(pairs_applied=n_app, pairs_in_rect_other=n_other, pairs_out_rect=n_out,
              rows=n_rows, warp_rows_reduced=n_warp)
    print(f"# K2 bound {b2['bound_ms']:.4f} ms ({b2['bound_by']}); (tile, warp, row) visits "
          f"that reduce: {n_warp} for {n_app} applied pairs", file=sys.stderr)
    train = {
        "steps": N_STEPS, "k1_launches": k1_launches, "k2_launches": k2_launches,
        "loss_first": losses[0], "loss_last": losses[-1], "stats": stats, "densify": densify,
        "step_ms_median": med(step_ms), "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_samples": len(step_ms),
        "k2_ms_median": k2_ms, "plain_bwd_ms_median": plain_bwd_ms,
        "k2_bound": b2,
        "k2_err": err_k2,
        "grad_vs_plain_worst": max(vs_plain.items(), key=lambda kv: kv[1]["rel_norm"]),
        "grad_run_to_run_max_rel_norm": max(e["rel_norm"] for e in run_to_run.values()),
        "grad_run_to_run_max_abs": max(e["max_abs"] for e in run_to_run.values()),
        "profile": prof,
    }
    if isinstance(prof["device_ms_per_frame"], float):
        train["device_busy_share"] = prof["device_ms_per_frame"] / med(step_ms)
    k2 = kernel_entry(
        "composite_bwd", "lidargs_torch/csrc/composite_bwd.cu",
        "lidargs_tpu/ops/pallas_composite.py:224", k2_launches, k2_ms, plain_bwd_ms, b2,
        warp_rows_reduced=n_warp, **dinst_errors(err_k2))
    return train, k2


def dinst_errors(err: dict) -> dict:
    """The error keys of a backward kernel's entry, from `check_dinst`."""
    return {"max_abs_err": err["max_abs"], "mean_abs_err": err["mean_abs"],
            "column_scaled_err": {k: err[k] for k in ("mean", "max", "far_count")}}


def profile_summary(prof: dict) -> dict:
    """The device totals of a `profile_render` result, without its list."""
    return {k: v for k, v in prof.items() if k != "top"}


def surfel_phases(dev, params, valid, mcfg, beams, frames):
    """Phases 10-14, the surfel (2DGS) variant on the render scene: (summary
    for the timing line, K5's and K6's entries of the kernels line)."""
    import numpy as np
    import torch

    from lidargs_torch.config import OptConfig, RasterConfig
    from lidargs_torch.models.field import AnchorField, field_surfels, render_field_surfel
    from lidargs_torch.ops import surfel_kernel as sk
    from lidargs_torch.ops.surfel import SurfelCols as S
    from lidargs_torch.ops.surfel import (cull_sorted_surfels, preprocess_surfels,
                                          render_surfels, surfel_tile_inputs)
    from lidargs_torch.train import Trainer, init_train_state, loss_and_grads, measure_fps
    from lidargs_torch.train.optim import tree_leaves
    from lidargs_torch.utils.testing import make_scene

    C = mcfg.color_channel
    med = lambda xs: float(np.median(xs))
    rcfg = RasterConfig(**SURFEL_RASTER)
    bg = torch.zeros(2, device=dev)

    # --- 10. the main path: frames through measure_fps(variant="surfel") ---
    with torch.no_grad():
        sk.launches = 0
        res = measure_fps(params, valid, frames, mcfg, rcfg, bg, warmup=WARMUP, device=dev,
                          variant="surfel")
        k5_launches = sk.launches
    if k5_launches != N_FRAMES:
        fail(f"K5 launched {k5_launches} times for {N_FRAMES} surfel frames")
    for i, out in enumerate(res.outputs):
        shapes = {"color": (C, H, W), "depth": (H, W), "occ": (H, W), "final_T": (H, W),
                  "normal": (3, H, W), "median_depth": (H, W), "distortion": (H, W)}
        for name, shape in shapes.items():
            x = getattr(out, name)
            if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
                fail(f"surfel frame {i}: {name} {tuple(x.shape)} not finite of shape {shape}")
    occ = [float(o.occ.mean()) for o in res.outputs]
    if not min(occ) > 0.0:
        fail(f"empty surfel render: mean occupancy per frame {occ}")
    main_path = {
        "frames": N_FRAMES, "warmup": WARMUP, "fps_host_clock": res.fps,
        "host_ms_per_frame": [t * 1e3 for t in res.seconds], "mean_occ": occ,
        "n_overflow": [int(o.n_overflow) for o in res.outputs],
        "n_dropped": [int(o.n_dropped) for o in res.outputs],
        "n_visible": [int(o.visible.sum()) for o in res.outputs],
    }
    print(f"# surfel main path: {json.dumps(main_path)}", file=sys.stderr)

    # --- 11. tiled (K5) against golden (plain) on a small scene; K5 against
    # plain on frame 0's main-path inputs ---
    sc = make_scene(seed=3, n=400, H=32, W=256)
    scales2 = np.random.default_rng(3).uniform(0.3, 1.2, (400, 2)).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(dev)
    small = RasterConfig(tile_h=1, tile_capacity=512, max_tiles_per_gaussian=64,
                         max_visible=512, chunk=8)
    bg_s = torch.tensor([0.3, 0.7], device=dev)
    with torch.no_grad():
        pk = preprocess_surfels(t(sc.means3d), t(scales2), t(sc.quats), t(sc.opacities),
                                t(sc.feat), t(sc.mask), t(sc.w2s_rot), t(sc.w2s_trans),
                                t(sc.beams), sc.W, small)
        tiled = render_surfels(pk, t(sc.beams), sc.W, bg_s, small, C=C)
        gold = render_surfels(pk, t(sc.beams), sc.W, bg_s, small, C=C, golden=True)
    if int(tiled.n_overflow) != 0 or not float(tiled.occ.max()) > 0.5:
        fail(f"small surfel scene: overflow {int(tiled.n_overflow)}, "
             f"max occ {float(tiled.occ.max())}")
    stack = lambda o: torch.cat([o.color, o.depth[None], o.final_T[None], o.normal,
                                 o.median_depth[None], o.distortion[None]])[None]
    err_gold = check_surfel("tiled K5 vs golden (small surfel scene)", stack(tiled),
                            stack(gold), C)
    with torch.no_grad():
        pk0 = field_surfels(params, valid, frames[0], mcfg, rcfg)[0]
        pkv, _ = cull_sorted_surfels(pk0, rcfg, C)
        inst, counts, pix, _ = surfel_tile_inputs(pkv, frames[0].beams, W, rcfg, C)
        out_k = sk.surfel_composite_tiles(inst, counts, pix, C, rcfg)
        out_p = sk.surfel_composite_tiles_plain(inst, counts, pix, C, rcfg)
    torch.cuda.synchronize()
    err_k5 = check_surfel("K5 vs plain (frame 0 inputs)", out_k, out_p, C)
    k5_inputs = {"inst": list(inst.shape), "counts": list(counts.shape),
                 "pix": list(pix.shape), "mean_count": float(counts.float().mean()),
                 "max_count": int(counts.max())}

    # --- 12. training: N_STEPS surfel steps, both regularizers on ---
    ocfg = OptConfig(**OPT, dist_from=0, normal_from=0)
    trainer = Trainer(mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, bg=bg, variant="surfel")
    tframes = train_frames(dev, beams)
    state0 = init_train_state(AnchorField(params=params, valid=valid, voxel_size=VOXEL), mcfg)
    state, losses = state0, []
    sk.launches = sk.bwd_launches = 0
    for it in range(1, N_STEPS + 1):
        state, m = trainer.step(state, tframes[it - 1], it)
        losses.append({f: float(getattr(m.loss, f)) for f in m.loss._fields})
    k5_train, k6_launches = sk.launches, sk.bwd_launches
    if k5_train != N_STEPS or k6_launches != N_STEPS:
        fail(f"{N_STEPS} surfel steps launched K5 {k5_train} and K6 {k6_launches} times")
    if not all(np.isfinite(list(l.values())).all() for l in losses):
        fail(f"non-finite surfel loss terms: {losses}")
    moved = 0
    for a, b in zip(tree_leaves(state.params), tree_leaves(state0.params)):
        if not bool(torch.isfinite(a).all()):
            fail("non-finite parameters after surfel training")
        moved += int((a != b).sum())
    if moved == 0:
        fail("surfel training left every parameter as it was")
    stats = {
        "anchor_demon_max": float(state.anchor_demon.max()),
        "offset_denom_sum": float(state.offset_denom.sum()),
        "offset_grad_accum_sum": float(state.offset_grad_accum.sum()),
        "opacity_accum_sum": float(state.opacity_accum.sum()),
    }
    if not (stats["anchor_demon_max"] == N_STEPS and stats["offset_denom_sum"] > 0
            and stats["offset_grad_accum_sum"] > 0 and stats["opacity_accum_sum"] > 0):
        fail(f"surfel densification statistics did not accumulate: {stats}")
    n_before = int(state.valid.sum())
    dense, dstats = trainer.densify(state, torch.Generator(device=dev).manual_seed(0), VOXEL)
    densify = {"n_anchors_before": n_before, "n_grown": int(dstats.n_grown),
               "n_pruned": int(dstats.n_pruned), "n_anchors_after": int(dense.valid.sum())}
    if densify["n_anchors_after"] != n_before + densify["n_grown"] - densify["n_pruned"]:
        fail(f"surfel densify: anchor count does not add up: {densify}")
    print(f"# surfel train: losses {losses}; stats {stats}; densify {densify}", file=sys.stderr)

    # --- 13. K6 against plain on one step's inputs; gradients against plain ---
    frame = tframes[0]
    grads = lambda: loss_and_grads(state, frame, bg, mcfg, rcfg, ocfg, variant="surfel")[1:]
    bwd_args, d_k, err_k6, vs_plain, _ = kernel_vs_plain(
        sk, "surfel_composite_tiles", grads, 16 + C, K6_TOL, "K6")
    with torch.no_grad():
        # the median routing: where the plain forward's median is K5's bit
        # for bit, the plain backward recomputes the same depth
        med_p = sk.surfel_composite_tiles_plain(*bwd_args[:3], C, rcfg)[:, C + 5]
    err_k6["median_bit_equal_frac"] = float((med_p == bwd_args[3][:, C + 5]).float().mean())
    if bool((d_k[..., S.DEPTH] != 0).any()):
        fail("K6: nonzero DEPTH column")

    # --- 14. timing (CUDA events), bounds from this run's inputs, profiles ---
    with torch.no_grad():
        k5_ms, p5_ms = time_vs_plain(sk.surfel_composite_tiles, sk.surfel_composite_tiles_plain,
                                     (inst, counts, pix, C, rcfg))
        render = lambda: render_field_surfel(params, valid, frames[0], mcfg, rcfg, bg)
        render_ms = time_ms(render, 30, 3)
        prof_r = profile_render(render)
        a5, o5, x5, r5, _, v5, vr5, vm5 = walked_surfel_pairs(inst, counts, pix, C, rcfg)
    held = [state]

    def one_step():
        held[0], _ = trainer.step(held[0], frame, 1)

    step_ms = time_ms(one_step, TRAIN_TIMED, 3)
    prof_s = profile_render(one_step, frames=3)
    k6_ms, p6_ms = time_vs_plain(sk.surfel_composite_tiles_bwd,
                                 sk.surfel_composite_tiles_bwd_plain, bwd_args)
    b_counts, b_pix = bwd_args[1:3]
    a6, o6, x6, r6, w6, *_ = walked_surfel_pairs(*bwd_args[:3], C, rcfg)
    T6, _, npix = b_pix.shape

    # bytes: of each row the kernels read every column up to the valid flag
    # but DEPTH (SurfelCols.validf(C) of them); K6 reads rows 0..C+8 of res
    # and g; each output is written once
    b5 = bound(tile_bytes(counts, r5, S.validf(C), pix, out_k.numel()),
               (OPS_S_IN_RECT + OPS_S_FWD_APPLIED + 2 * C) * a5 + OPS_S_IN_RECT * o5
               + OPS_S_OUT_RECT * x5)
    b5.update(pairs_applied=a5, pairs_in_rect_other=o5, pairs_out_rect=x5, rows=r5,
              warp_row_visits=v5, warp_row_visits_in_rect=vr5, warp_row_visits_masked=vm5)
    print(f"# K5 bound {b5['bound_ms']:.4f} ms ({b5['bound_by']}); (tile, warp, row) visits of "
          f"a walk over every row: {v5}, with a lane past the valid and rect tests: {vr5}, of "
          f"the masked walk: {vm5}", file=sys.stderr)
    b6 = bound(tile_bytes(b_counts, r6, S.validf(C), b_pix, 2 * T6 * (C + 9) * npix,
                          d_k.numel()),
               (OPS_S_BWD_APPLIED + 4 * C) * a6 + OPS_S_IN_RECT * o6 + OPS_S_OUT_RECT * x6)
    b6.update(pairs_applied=a6, pairs_in_rect_other=o6, pairs_out_rect=x6, rows=r6,
              warp_rows_reduced=w6)
    print(f"# K6 bound {b6['bound_ms']:.4f} ms ({b6['bound_by']}); (tile, warp, row) visits "
          f"that reduce: {w6} for {a6} applied pairs", file=sys.stderr)
    summary = {
        "raster": SURFEL_RASTER, "main_path": main_path, "golden_small_err": err_gold,
        "k5_inputs": k5_inputs, "k5_err": err_k5, "k6_err": err_k6,
        "render_ms_per_frame_median": med(render_ms), "render_ms_per_frame_min": min(render_ms),
        "render_ms_per_frame_max": max(render_ms), "render_samples": len(render_ms),
        "render_profile": profile_summary(prof_r), "render_top": prof_r.get("top", [])[:6],
        "steps": N_STEPS, "k5_launches_train": k5_train, "k6_launches": k6_launches,
        "loss_first": losses[0], "loss_last": losses[-1], "stats": stats, "densify": densify,
        "step_ms_median": med(step_ms), "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_samples": len(step_ms),
        "step_profile": profile_summary(prof_s), "step_top": prof_s.get("top", [])[:8],
        "k5_ms_median": k5_ms, "plain_fwd_ms_median": p5_ms,
        "k6_ms_median": k6_ms, "plain_bwd_ms_median": p6_ms,
        "k5_bound": b5, "k6_bound": b6,
        "grad_vs_plain_worst": max(vs_plain.items(), key=lambda kv: kv[1]["rel_norm"]),
    }
    for key, prof, ms in (("render", prof_r, render_ms), ("step", prof_s, step_ms)):
        if isinstance(prof["device_ms_per_frame"], float):
            summary[f"{key}_device_busy_share"] = prof["device_ms_per_frame"] / med(ms)
    k5 = kernel_entry(
        "surfel_fwd", "lidargs_torch/csrc/surfel_fwd.cu", "lidargs_tpu/ops/pallas_surfel.py:186",
        k5_launches, k5_ms, p5_ms, b5, launches_train=k5_train,
        max_abs_err=max(err_k5["feat_max"], err_k5["depth_max"], err_k5["median_max"],
                        err_k5["dist_max"]),
        mean_abs_err={"feat": err_k5["feat_mean"], "depth": err_k5["depth_mean"]})
    k6 = kernel_entry(
        "surfel_bwd", "lidargs_torch/csrc/surfel_bwd.cu", "lidargs_tpu/ops/pallas_surfel.py:405",
        k6_launches, k6_ms, p6_ms, b6, warp_rows_reduced=w6, **dinst_errors(err_k6))
    return summary, k5, k6


def ab_ms(fns: dict, iters: int) -> dict:
    """Per-call device ms of each of `fns` from CUDA events, timed in turns
    (iters // 2 calls each, the order reversed on the second turn)."""
    ms = {k: [] for k in fns}
    for turn in range(2):
        for k in (list(fns) if turn == 0 else list(fns)[::-1]):
            ms[k] += time_ms(fns[k], max(iters // 2, 1), 2)
    return ms


def window_phases(dev, params, valid, mcfg, beams, frames, variant: str):
    """Phases 15-16 (beam) or 17-18 (surfel): the fused-window gather at the
    variant's CLI settings with `fused_gather=True`. Returns (summary for
    the timing line, the entries of the forward and backward window kernels
    for the kernels line)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lidargs_torch.config import OptConfig, RasterConfig, replace
    from lidargs_torch.models.field import AnchorField, field_splats, field_surfels, render_fn
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.ops import rasterize as tr
    from lidargs_torch.ops import surfel as ts
    from lidargs_torch.ops import surfel_kernel as sk
    from lidargs_torch.ops.projection import PackedCols
    from lidargs_torch.train import Trainer, init_train_state, loss_and_grads, measure_fps
    from lidargs_torch.train.optim import tree_leaves

    C = mcfg.color_channel
    surfel = variant == "surfel"
    mod = sk if surfel else ck
    tiles, wins = ("surfel_composite_tiles", "surfel_composite_windows") if surfel else (
        "composite_tiles", "composite_windows")
    cols = ts.SurfelCols if surfel else PackedCols
    mat = RasterConfig(**(SURFEL_RASTER if surfel else RASTER))
    rcfg = replace(mat, fused_gather=True)
    K = rcfg.tile_capacity
    check_out = check_surfel if surfel else check_against
    walked = walked_surfel_pairs if surfel else walked_pairs
    # of each row the kernels read the columns before the valid flag but
    # DEPTH (surfel), or up to the rect's end (beam); the backward reads
    # rows 0..C+8 (surfel) or 0..C+1 (beam) of res and g
    read_cols, res_rows = (cols.validf(C), C + 9) if surfel else (cols.rect(C).stop, C + 2)
    nv = 16 + C if surfel else 14 + C
    bg = torch.zeros(2, device=dev)
    med = lambda xs: float(np.median(xs))
    k_f, k_b = ("K7", "K8") if surfel else ("K3", "K4")
    k_tf, k_tb = ("K5", "K6") if surfel else ("K1", "K2")

    def counts_now():
        return (mod.launches, mod.bwd_launches, mod.windows_launches, mod.windows_bwd_launches)

    def zero_counts():
        mod.launches = mod.bwd_launches = mod.windows_launches = mod.windows_bwd_launches = 0

    # --- 15/17. the main path: frames through measure_fps, fused ---
    with torch.no_grad():
        zero_counts()
        res = measure_fps(params, valid, frames, mcfg, rcfg, bg, warmup=WARMUP, device=dev,
                          variant=variant)
        render_counts = counts_now()
    if render_counts[2] != N_FRAMES or render_counts[0] != 0:
        fail(f"{N_FRAMES} fused {variant} frames launched {k_f} {render_counts[2]} and "
             f"{k_tf} {render_counts[0]} times")
    names = ("color", "depth", "occ") + (("normal", "median_depth", "distortion") if surfel
                                         else ())
    for i, out in enumerate(res.outputs):
        if tuple(out.color.shape) != (C, H, W) or tuple(out.depth.shape) != (H, W):
            fail(f"fused {variant} frame {i}: shapes {tuple(out.color.shape)}, "
                 f"{tuple(out.depth.shape)}")
        for name in names:
            if not bool(torch.isfinite(getattr(out, name)).all()):
                fail(f"fused {variant} frame {i}: non-finite {name}")
    occ = [float(o.occ.mean()) for o in res.outputs]
    if not min(occ) > 0.0:
        fail(f"empty fused {variant} render: mean occupancy per frame {occ}")
    main_path = {"frames": N_FRAMES, "fps_host_clock": res.fps, "mean_occ": occ,
                 "n_overflow": [int(o.n_overflow) for o in res.outputs]}
    print(f"# fused {variant} main path: {json.dumps(main_path)}", file=sys.stderr)

    # frame 0: the fused render against the materialized one, and the window
    # kernel against the tile kernel and its plain version on its inputs
    frame = frames[0]
    render = lambda cfg: render_fn(variant)(params, valid, frame, mcfg, cfg, bg)[0]
    with torch.no_grad():
        fused, plain = render(rcfg), render(mat)
        for name in names:
            if not torch.equal(getattr(fused, name), getattr(plain, name)):
                fail(f"fused {variant} frame 0: {name} differs from the materialized render")
        if int(fused.n_overflow) != int(plain.n_overflow):
            fail(f"fused {variant}: overflow {int(fused.n_overflow)} != {int(plain.n_overflow)}")
        if surfel:
            pkv, _ = ts.cull_sorted_surfels(field_surfels(params, valid, frame, mcfg, rcfg)[0],
                                            rcfg, C)
            inst, counts, pix, _ = ts.surfel_tile_inputs(pkv, frame.beams, W, rcfg, C)
        else:
            pkv, _ = tr.cull_sorted_rows(field_splats(params, valid, frame, mcfg, rcfg)[0], rcfg)
            inst, counts, pix, _ = tr.tile_inputs(pkv, frame.beams, W, rcfg, C)
        buf, starts, wcounts, wpix, _ = tr.window_inputs(pkv, frame.beams, W, rcfg, C, cols)
        if not (torch.equal(counts, wcounts) and torch.equal(pix, wpix)):
            fail(f"fused {variant}: window counts or pixel blocks differ from the tiles'")
        out_w = getattr(mod, wins)(buf, starts, counts, pix, C, rcfg)
        out_t = getattr(mod, tiles)(inst, counts, pix, C, rcfg)
        out_p = getattr(mod, wins + "_plain")(buf, starts, counts, pix, C, rcfg)
    torch.cuda.synchronize()
    if not torch.equal(out_w, out_t):
        fail(f"{k_f} differs from {k_tf} on the same rows "
             f"(max |d| {float((out_w - out_t).abs().max()):.3e})")
    err_f = check_out(f"{k_f} vs plain (fused frame 0 inputs)", out_w, out_p, C)

    # --- 16/18. training: N_STEPS fused steps, one densify ---
    extra = dict(dist_from=0, normal_from=0) if surfel else {}
    ocfg = OptConfig(**OPT, **extra)
    trainer = Trainer(mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, bg=bg, variant=variant)
    tframes = train_frames(dev, beams)
    state0 = init_train_state(AnchorField(params=params, valid=valid, voxel_size=VOXEL), mcfg)
    state, losses = state0, []
    zero_counts()
    for it in range(1, N_STEPS + 1):
        state, m = trainer.step(state, tframes[it - 1], it)
        losses.append({f: float(getattr(m.loss, f)) for f in m.loss._fields})
    train_counts = counts_now()
    if train_counts != (0, 0, N_STEPS, N_STEPS):
        fail(f"{N_STEPS} fused {variant} steps launched {k_tf}, {k_tb}, {k_f}, {k_b} "
             f"{train_counts} times")
    if not all(np.isfinite(list(l.values())).all() for l in losses):
        fail(f"non-finite fused {variant} loss terms: {losses}")
    moved = 0
    for a, b in zip(tree_leaves(state.params), tree_leaves(state0.params)):
        if not bool(torch.isfinite(a).all()):
            fail(f"non-finite parameters after fused {variant} training")
        moved += int((a != b).sum())
    if moved == 0:
        fail(f"fused {variant} training left every parameter as it was")
    n_before = int(state.valid.sum())
    dense, dstats = trainer.densify(state, torch.Generator(device=dev).manual_seed(0), VOXEL)
    densify = {"n_anchors_before": n_before, "n_grown": int(dstats.n_grown),
               "n_pruned": int(dstats.n_pruned), "n_anchors_after": int(dense.valid.sum())}
    if densify["n_anchors_after"] != n_before + densify["n_grown"] - densify["n_pruned"]:
        fail(f"fused {variant} densify: anchor count does not add up: {densify}")
    print(f"# fused {variant} train: losses {losses}; densify {densify}", file=sys.stderr)

    # the backward window kernel against its plain version and against the
    # tile kernel scattered to the windows; one step's gradients against the
    # plain versions' and the materialized path's
    tframe = tframes[0]
    grads = lambda cfg=rcfg: loss_and_grads(state, tframe, bg, mcfg, cfg, ocfg, variant)[1:]
    bwd_args, d_k, err_b, vs_plain, g_f = kernel_vs_plain(mod, wins, grads, nv, K2_TOL, k_b)
    b_buf, b_starts, b_counts, b_pix, b_res, b_g = bwd_args[:6]
    with torch.no_grad():
        b_inst = ck.window_rows(b_buf, b_starts, K).contiguous()
        if not torch.equal(getattr(mod, tiles)(b_inst, b_counts, b_pix, C, rcfg), b_res):
            fail(f"{k_f} differs from {k_tf} on one step's rows")
        d_t = getattr(mod, tiles + "_bwd")(b_inst, b_counts, b_pix, b_res, b_g, C, rcfg)
        if not torch.equal(d_k, ck.scatter_windows(d_t, b_starts, b_counts, b_buf.shape[0])):
            fail(f"{k_b} differs from {k_tb} scattered to the windows")
        if surfel:
            med_p = sk.surfel_composite_windows_plain(*bwd_args[:4], C, rcfg)[:, C + 5]
            err_b["median_bit_equal_frac"] = float((med_p == b_res[:, C + 5]).float().mean())
            if bool((d_k[:, ts.SurfelCols.DEPTH] != 0).any()):
                fail(f"{k_b}: nonzero DEPTH column")
    g_m, pg_m = grads(mat)
    vs_mat = grad_diff(g_f, {**g_m, "proxy": pg_m})
    for leaf, e in vs_mat.items():
        if e["norm"] > 0 and not (e["rel_norm"] <= GRAD_TOL["rel_norm"]
                                  and e["cos"] >= GRAD_TOL["cos"]):
            fail(f"gradient of {leaf}, fused vs materialized {variant}: {e}")
    print(f"# fused {variant} grads vs materialized: {vs_mat}", file=sys.stderr)

    # --- timing: kernels, plain versions, frames and steps beside the
    # materialized ones; the buf gather and the dbuf zeroing; profiles ---
    with torch.no_grad():
        f_ms, pf_ms = time_vs_plain(getattr(mod, wins), getattr(mod, wins + "_plain"),
                                    (buf, starts, counts, pix, C, rcfg))
        t_ms = med(time_ms(lambda: getattr(mod, tiles)(inst, counts, pix, C, rcfg), 50, 5))
        # the same pair with the L2 cache flushed before each call: the tile
        # list may fit the 50 MB L2 where the windows' stretch of buf does not
        cold = {k_f: time_cold_ms(lambda: getattr(mod, wins)(buf, starts, counts, pix, C, rcfg)),
                k_tf: time_cold_ms(lambda: getattr(mod, tiles)(inst, counts, pix, C, rcfg))}
        render_ms = ab_ms({"fused": lambda: render(rcfg), "materialized": lambda: render(mat)},
                          30)
        gy, gx = rcfg.grid_shape(H, W)
        V = pkv.shape[0]
        bin_args = (pkv[:, cols.rect(C)].to(torch.int32), pkv[:, cols.center(C)],
                    pkv[:, cols.validf(C)] > 0.0, rcfg, gx, gy)
        gid = tr.bin_instances_windows(*bin_args)[0]
        ids = tr.bin_instances(*bin_args)[0].reshape(-1)
        gathers = {
            "buf_gather_ms": med(time_ms(lambda: F.pad(pkv[gid.clamp(0, V - 1)], (0, 0, 0, K)),
                                         20, 2)),
            "inst_gather_ms": med(time_ms(lambda: pkv[ids.clamp(0, V - 1)], 20, 2)),
            "dbuf_zero_ms": med(time_ms(lambda: torch.zeros_like(buf), 20, 2)),
            "buf_mb": buf.numel() * 4 / 1e6, "inst_mb": inst.numel() * 4 / 1e6,
        }
        prof_r = profile_render(lambda: render(rcfg))
        a_f, o_f, x_f, r_f, _, v_f, vr_f, vm_f = walked(ck.window_rows(buf, starts, K), counts,
                                                        pix, C, rcfg)
    b_ms, pb_ms = time_vs_plain(getattr(mod, wins + "_bwd"), getattr(mod, wins + "_bwd_plain"),
                                bwd_args)
    tb_ms = med(time_ms(lambda: getattr(mod, tiles + "_bwd")(b_inst, b_counts, b_pix, b_res,
                                                              b_g, C, rcfg), 50, 5))
    cold[k_b] = time_cold_ms(lambda: getattr(mod, wins + "_bwd")(*bwd_args))
    cold[k_tb] = time_cold_ms(lambda: getattr(mod, tiles + "_bwd")(b_inst, b_counts, b_pix,
                                                                   b_res, b_g, C, rcfg))
    trainer_m = Trainer(mcfg=mcfg, ocfg=ocfg, rcfg=mat, bg=bg, variant=variant)
    held = {"fused": [state], "materialized": [state]}

    def step_with(tr_, key):
        def one_step():
            held[key][0], _ = tr_.step(held[key][0], tframe, 1)
        return one_step

    step_ms = ab_ms({"fused": step_with(trainer, "fused"),
                     "materialized": step_with(trainer_m, "materialized")}, TRAIN_TIMED)
    prof_s = profile_render(step_with(trainer, "fused"), frames=3)
    a_b, o_b, x_b, r_b, w_b, *_ = walked(b_inst, b_counts, b_pix, C, rcfg)
    T, _, npix = pix.shape
    if surfel:
        ops_f = ((OPS_S_IN_RECT + OPS_S_FWD_APPLIED + 2 * C) * a_f + OPS_S_IN_RECT * o_f
                 + OPS_S_OUT_RECT * x_f)
        ops_b = (OPS_S_BWD_APPLIED + 4 * C) * a_b + OPS_S_IN_RECT * o_b + OPS_S_OUT_RECT * x_b
    else:
        ops_f = OPS_IN_RECT * (a_f + o_f) + OPS_OUT_RECT * x_f
        ops_b = (OPS_APPLIED_BWD + 14 + C) * a_b + OPS_IN_RECT * o_b + OPS_OUT_RECT * x_b
    # each kernel reads the rows some pixel's walk reaches and writes its
    # output once: K3/K7 the [T, rows, NPIX] image, K4/K8 the owned rows
    b_f = bound(tile_bytes(counts, r_f, read_cols, pix, out_w.numel()), ops_f)
    b_f.update(pairs_applied=a_f, pairs_in_rect_other=o_f, pairs_out_rect=x_f, rows=r_f,
               warp_row_visits=v_f, warp_row_visits_in_rect=vr_f, warp_row_visits_masked=vm_f)
    b_b = bound(tile_bytes(b_counts, r_b, read_cols, b_pix, 2 * T * res_rows * npix,
                           int(b_counts.sum()) * b_buf.shape[1]), ops_b)
    b_b.update(pairs_applied=a_b, pairs_in_rect_other=o_b, pairs_out_rect=x_b, rows=r_b,
               warp_rows_reduced=w_b)
    summary = {
        "raster": {**(SURFEL_RASTER if surfel else RASTER), "fused_gather": True},
        "main_path": main_path, "render_launches": dict(zip((k_tf, k_tb, k_f, k_b),
                                                            render_counts)),
        "train_launches": dict(zip((k_tf, k_tb, k_f, k_b), train_counts)),
        "buf_rows": b_buf.shape[0], **gathers,
        "render_ms_median": {k: med(v) for k, v in render_ms.items()},
        "render_ms_min_max": {k: [min(v), max(v)] for k, v in render_ms.items()},
        "step_ms_median": {k: med(v) for k, v in step_ms.items()},
        "step_ms_min_max": {k: [min(v), max(v)] for k, v in step_ms.items()},
        f"{k_f}_ms_median": f_ms, f"{k_tf}_ms_median_same_rows": t_ms,
        f"{k_b}_ms_median": b_ms, f"{k_tb}_ms_median_same_rows": tb_ms,
        "plain_fwd_ms_median": pf_ms, "plain_bwd_ms_median": pb_ms, "cold_l2_ms_median": cold,
        f"{k_f}_bound": b_f, f"{k_b}_bound": b_b, f"{k_f}_err": err_f, f"{k_b}_err": err_b,
        "loss_first": losses[0], "loss_last": losses[-1], "densify": densify,
        "grad_vs_plain_worst": max(vs_plain.items(), key=lambda kv: kv[1]["rel_norm"]),
        "grad_vs_materialized_worst": max(vs_mat.items(), key=lambda kv: kv[1]["rel_norm"]),
        "render_profile": profile_summary(prof_r), "render_top": prof_r.get("top", [])[:6],
        "step_profile": profile_summary(prof_s), "step_top": prof_s.get("top", [])[:8],
    }
    for key, prof, ms in (("render", prof_r, render_ms["fused"]),
                          ("step", prof_s, step_ms["fused"])):
        if isinstance(prof["device_ms_per_frame"], float):
            summary[f"{key}_device_busy_share"] = prof["device_ms_per_frame"] / med(ms)
            summary[f"{key}_gather_share"] = gathers["buf_gather_ms"] / prof["device_ms_per_frame"]
    summary["step_dbuf_zero_share"] = (gathers["dbuf_zero_ms"] / prof_s["device_ms_per_frame"]
                                       if isinstance(prof_s["device_ms_per_frame"], float)
                                       else "not measured")
    src = "lidargs_torch/csrc/" + ("surfel" if surfel else "composite")
    tpu = "lidargs_tpu/ops/pallas_" + ("surfel.py:" if surfel else "composite.py:")
    e_f = kernel_entry(
        ("surfel" if surfel else "composite") + "_fwd_windows", src + "_fwd.cu",
        tpu + ("192" if surfel else "325"), render_counts[2], f_ms, pf_ms, b_f,
        launches_train=train_counts[2],
        max_abs_err=max(v for k, v in err_f.items() if k.endswith("_max")),
        mean_abs_err={"feat": err_f["feat_mean"], "depth": err_f["depth_mean"]},
        bit_equal_to=k_tf)
    e_b = kernel_entry(
        ("surfel" if surfel else "composite") + "_bwd_windows", src + "_bwd.cu",
        tpu + ("418" if surfel else "385"), train_counts[3], b_ms, pb_ms, b_b,
        warp_rows_reduced=w_b, **dinst_errors(err_b), bit_equal_to=f"{k_tb} on the owned rows")
    return summary, e_f, e_b


@contextlib.contextmanager
def probe(owner, name: str, counters=(), after=None):
    """Wrap `owner.name` while the block runs: each call's host seconds
    (start and duration, `after()` included where it is given, e.g. a device
    synchronize), its result, and how far each of `counters` (zero-argument
    functions reading a launch count) moved during it."""
    orig = getattr(owner, name)
    calls = []

    def wrapped(*a, **k):
        before = [c() for c in counters]
        t0 = time.perf_counter()
        out = orig(*a, **k)
        if after is not None:
            after()
        calls.append({"start": t0, "s": time.perf_counter() - t0, "result": out,
                      "launches": [c() - b for c, b in zip(counters, before)]})
        return out

    setattr(owner, name, wrapped)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)


def trace_device_ms(trace_json: Path, steps: int) -> dict:
    """Device ms and device-side launches per step from the CLI's
    `--profile_steps` Chrome trace (the kernels, copies and memsets), and
    the costliest kernels by name."""
    events = (json.loads(trace_json.read_text()).get("traceEvents", [])
              if trace_json.exists() else [])
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        return {"device_ms_per_step": "not measured", "device_launches_per_step": "not measured"}
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0.0)
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:8]
    return {"device_ms_per_step": sum(e.get("dur", 0.0) for e in dev) / 1e3 / steps,
            "device_launches_per_step": len(dev) / steps,
            "top_ms_per_step": {k[:90]: v / 1e3 / steps for k, v in top}}


def gram_tol(x, y):
    """Per-row bound on the Gram form's float32 error, |x|^2 + |y|^2 - 2 x.y
    with |x| ~ |y| ~ R: about 13 roundings of R^2 (the two norms, the dot
    product, the two sums), so 2**-24 * 13 * R^2 < 1e-6 (|x|^2 + |y|^2); plus
    1e-6 m^2 absolute. TF32 (2**-11) gives errors ~1e3 times this."""
    return 1e-6 * ((x * x).sum(-1) + (y * y).sum(-1)) + 1e-6


def knn_oracle(dev, points, direct: bool = False):
    """`mean_sq_dist_3nn` (N2) on the card against a float64 k-d tree
    (scipy.spatial.cKDTree) on the same float32 points: every row within
    `gram_tol` (the sorted k smallest move by at most the largest error).
    With `direct`, `knn3_mean_sq_dist` (N3, direct differences) within
    DYN_KNN_TOL of the tree's value, timed once without a warm-up run. The
    launches of that one call are counted (the counter set to 0 just before
    and read just after). Then the kernel against its plain version on the
    same points: N2's 3 nearest (`knn_sqdist`) each within `gram_tol` of the
    tree's neighbour of that rank, N3 bit for bit; two launches bit for bit;
    the kernel, plain and library times (`knn_times`) and the bound."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from lidargs_torch.ops import knn
    from lidargs_torch.ops import knn_kernel as nk

    fn = knn.knn3_mean_sq_dist if direct else knn.mean_sq_dist_3nn
    counter = "knn3_launches" if direct else "knn_launches"
    pts = torch.from_numpy(points).to(dev)
    if not direct:
        fn(pts)                                 # warm-up
    torch.cuda.synchronize()
    setattr(nk, counter, 0)
    t0 = time.perf_counter()
    got = fn(pts)
    torch.cuda.synchronize()
    knn_ms = (time.perf_counter() - t0) * 1e3
    launches = getattr(nk, counter)
    if launches != 1:
        fail(f"{fn.__name__}: {launches} launches of its kernel in one call")
    got = got.cpu().numpy().astype(np.float64)
    p64 = points.astype(np.float64)
    t0 = time.perf_counter()
    d, idx = cKDTree(p64).query(p64, k=4, workers=-1)
    tree_s = time.perf_counter() - t0
    want = (d[:, 1:] ** 2).mean(1)
    tol = (DYN_KNN_TOL["rel"] * want + DYN_KNN_TOL["abs"] if direct
           else gram_tol(p64, p64[idx[:, 3]]))
    err = np.abs(got - want)
    out = {"points": len(points), "ms": knn_ms, "ckdtree_s": tree_s, "launches": launches,
           "max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
           "max_err_over_tol": float((err / tol).max()), "max_tol": float(tol.max()),
           "median_port": float(np.median(got)), "median_oracle": float(np.median(want))}
    if not out["max_err_over_tol"] <= 1.0:
        fail(f"{fn.__name__} against cKDTree: {out}")

    # --- the kernel against its plain version on the same points ---
    n = len(points)
    if direct:
        call = lambda: knn.knn3_mean_sq_dist(pts)
        plain = lambda: knn.knn3_mean_sq_dist_plain(pts)
        library = None             # no PyTorch call computes a 3-NN by direct differences
        b = knn_bound("N3", n, n, n * (n - 1))
        plan = N3_PLAN
    else:
        call = lambda: knn.knn_sqdist(pts, pts, 3, exclude_self=True)
        plain = lambda: knn.knn_sqdist_plain(pts, pts, 3, exclude_self=True)
        p2 = (pts * pts).sum(-1)
        pT = pts.T.contiguous()
        rows = knn._rows_per_chunk(pts, n, None)
        # the library calls of the plain version alone (addmm + topk), the
        # norms made outside the timed span
        library = lambda: [torch.topk(torch.addmm(p2[None, :], pts[s:s + rows], pT, alpha=-2.0),
                                      4, dim=1, largest=False, sorted=True)
                           for s in range(0, n, rows)]
        b = knn_bound("N2", n, n, n * n, kk=4)
        plan = knn_plan(dev, n, n, 4)
    k1, k2, want_p = call(), call(), plain()
    torch.cuda.synchronize()
    vs = {"launches_bit_equal": bool(torch.equal(k1, k2)),
          "max_abs_err": float((k1 - want_p).abs().max())}
    if direct:
        vs.update(bit_equal=bool(torch.equal(k1, want_p)), n_differ=int((k1 != want_p).sum()))
        ok = vs["bit_equal"]
    else:
        ptol = np.stack([gram_tol(p64, p64[idx[:, c]]) for c in (1, 2, 3)], 1)
        perr = np.abs(k1.cpu().numpy().astype(np.float64) - want_p.cpu().numpy())
        vs["max_err_over_tol"] = float((perr / ptol).max())
        ok = vs["max_err_over_tol"] <= 1.0
    if not (ok and vs["launches_bit_equal"]):
        fail(f"{'N3' if direct else 'N2'} against its plain version: {vs}")
    out.update(vs_plain=vs, kernel=knn_times(call, plain, library), bound=b, plan=plan)
    return out


def chamfer_oracle(dev, dump: Path, beams, depth_min: float, depth_max: float):
    """`chamfer_distance` and `fscore` on the card, on one dumped frame's
    render against its GT (the clouds `evaluate_frame` builds), against a
    float64 k-d tree: each point's squared distance within `gram_tol`, the
    chamfer distance within the mean of the bounds, the F-score within the
    share of points whose distance lies within its bound of tau. Then N1
    (`_chamfer_dir`, both directions) against its plain version on the same
    clouds with the same bounds, two launches bit for bit, the kernel, plain
    and library times of one direction (`knn_times`) and the bound."""
    import numpy as np
    import torch
    from scipy.spatial import cKDTree

    from lidargs_torch.lidar.pano import pano_to_lidar
    from lidargs_torch.ops import knn
    from lidargs_torch.ops.knn import chamfer_distance, fscore

    tau = 0.05
    r = torch.from_numpy(np.load(dump)).to(dev)            # [6, H, W]
    b = torch.as_tensor(beams, dtype=torch.float32, device=dev)
    pred = pano_to_lidar(r[2].clamp(depth_min, depth_max) * (r[1] > 0.5).float(), b)
    gt = pano_to_lidar(r[5] * r[3], b)
    cd, d1, d2, _, _ = chamfer_distance(pred, gt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cd, d1, d2, v1, v2 = chamfer_distance(pred, gt)
    f = fscore(d1, d2, tau, v1, v2)[0]
    chamfer_ms = (time.perf_counter() - t0) * 1e3
    a32, b32 = (x.float().cpu().numpy().astype(np.float64) for x in (pred, gt))
    e1, i1 = cKDTree(b32).query(a32, workers=-1)
    e2, i2 = cKDTree(a32).query(b32, workers=-1)
    w1, w2 = e1 ** 2, e2 ** 2
    t1, t2 = gram_tol(a32, b32[i1]), gram_tol(b32, a32[i2])
    err1 = np.abs(d1.cpu().numpy() - w1)
    err2 = np.abs(d2.cpu().numpy() - w2)
    cd_want = w1.mean() + w2.mean()
    p1, p2 = (w1 < tau).mean(), (w2 < tau).mean()
    f_want = 2 * p1 * p2 / (p1 + p2) if p1 + p2 > 0 else 0.0
    near = float((np.abs(w1 - tau) <= t1).mean() + (np.abs(w2 - tau) <= t2).mean())
    out = {"pred_points": len(a32), "gt_points": len(b32), "chamfer_ms": chamfer_ms,
           "cd": cd, "cd_oracle": float(cd_want), "cd_tol": float(t1.mean() + t2.mean()),
           "fscore": f, "fscore_oracle": float(f_want), "fscore_tol": near,
           "max_err_over_tol": float(max((err1 / t1).max(), (err2 / t2).max())),
           "max_abs_err": float(max(err1.max(), err2.max()))}
    if not (out["max_err_over_tol"] <= 1.0 and abs(cd - cd_want) <= out["cd_tol"]
            and abs(f - f_want) <= near + 1e-6):
        fail(f"chamfer/F-score against cKDTree: {out}")

    # --- N1 against its plain version on the same clouds ---
    a, bb = (x.to(torch.float32).contiguous() for x in (pred, gt))
    q1, q2 = knn._chamfer_dir_plain(a, v1, bb, v2), knn._chamfer_dir_plain(bb, v2, a, v1)
    again = knn._chamfer_dir(a, v1, bb, v2)
    torch.cuda.synchronize()
    pe1 = np.abs(d1.cpu().numpy().astype(np.float64) - q1.cpu().numpy())
    pe2 = np.abs(d2.cpu().numpy().astype(np.float64) - q2.cpu().numpy())
    cd_plain = float(q1.sum() / v1.sum().clamp_min(1) + q2.sum() / v2.sum().clamp_min(1))
    f_plain = fscore(q1, q2, tau, v1, v2)[0]
    vs = {"max_err_over_tol": float(max((pe1 / t1).max(), (pe2 / t2).max())),
          "max_abs_err": float(max(pe1.max(), pe2.max())), "cd_plain": cd_plain,
          "fscore_plain": f_plain, "launches_bit_equal": bool(torch.equal(d1, again))}
    if not (vs["max_err_over_tol"] <= 1.0 and abs(cd - cd_plain) <= out["cd_tol"]
            and abs(f - f_plain) <= near + 1e-6 and vs["launches_bit_equal"]):
        fail(f"N1 against its plain version: {vs}")
    b2 = torch.where(v2, (bb * bb).sum(-1), torch.inf)
    bT = bb.T.contiguous()
    rows = knn._rows_per_chunk(a, bb.shape[0], None)
    # the library calls of the plain version alone (addmm + amin), the norms
    # made outside the timed span
    library = lambda: [torch.addmm(b2[None, :], a[s:s + rows], bT, alpha=-2.0).amin(1)
                       for s in range(0, a.shape[0], rows)]
    times = knn_times(lambda: knn._chamfer_dir(a, v1, bb, v2),
                      lambda: knn._chamfer_dir_plain(a, v1, bb, v2), library)
    out.update(vs_plain=vs, kernel=times,
               bound=knn_bound("N1", a.shape[0], bb.shape[0], int(v1.sum()) * int(v2.sum())),
               plan=knn_plan(dev, a.shape[0], bb.shape[0]))
    return out


def chamfer_launches(label: str, chamfers: list, sweeps: int, out: Path) -> dict:
    """N1's launches in a CLI run's evaluations (`probe(metrics,
    "_chamfer_metrics", (N1's count,))`): `sweeps` sweeps over the frames
    that `per_view.json` lists, each frame scored once, with two launches
    (one a direction) unless a cloud is empty (an infinite distance and no
    launch). Fails unless that holds and some frame launched."""
    import numpy as np

    n_frames = sum(len(v) for v in json.loads((out / "per_view.json").read_text()).values())
    if len(chamfers) != sweeps * n_frames:
        fail(f"{label}: {len(chamfers)} chamfer frames, not {sweeps} x {n_frames}")
    bad = [(c["result"], c["launches"]) for c in chamfers
           if c["launches"][0] != (2 if np.isfinite(c["result"][0]) else 0)]
    launches = sum(c["launches"][0] for c in chamfers)
    if bad or launches == 0:
        fail(f"{label}: N1 launches per chamfer frame {bad[:4]}, {launches} in all")
    return {"frames": len(chamfers), "N1": launches}


def cli_results(out: Path, split: str = "test") -> dict:
    """`results.json` of a CLI run: its split's metrics, which must be
    finite, with the depth chamfer distance and F-score when asked for."""
    import numpy as np

    m = json.loads((out / "results.json").read_text())[split]
    for k in ("intensity_psnr", "depth_rmse", "depth_cd", "depth_fscore"):
        if k in m and not np.isfinite(m[k]):
            fail(f"{out}: {split} {k} = {m[k]} is not finite")
    return m


def cli_phases(dev):
    """Phases 19-23, the training CLI on a dataset (a summary for the timing
    line, and each kernel's launches in the CLI runs)."""
    import shutil

    import numpy as np
    import torch

    from lidargs_torch.data.ply import read_point_cloud
    from lidargs_torch.data.synthetic import make_street_dataset
    from lidargs_torch.data.waymo import WAYMO_TEST_IDX
    from lidargs_torch.lidar.pano import pano_to_lidar
    from lidargs_torch.models.field import voxelize_points
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.ops import knn_kernel as nk
    from lidargs_torch.ops import surfel_kernel as sk
    from lidargs_torch.train import cli, metrics
    from lidargs_torch.train.trainer import Trainer

    work = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    root, out, out_s = work / "street", work / "beam", work / "surfel"

    # --- 19. the dataset: the procedural street at the sensor's width ---
    t0 = time.perf_counter()
    make_street_dataset(str(root), **CLI_SCENE)
    dataset_s = time.perf_counter() - t0
    print(f"# cli: street dataset {CLI_SCENE} written in {dataset_s:.1f} s", file=sys.stderr)
    half = CLI_ITERS // 2
    n_test = sum(i < CLI_NUM_FRAMES for i in WAYMO_TEST_IDX)
    base = ["-s", str(root), "--num_frames", str(CLI_NUM_FRAMES), "--device", str(dev),
            "--voxel_size", CLI_VOXEL, *CLI_EXTRA]
    argv = base + ["-m", str(out), "--iterations", str(CLI_ITERS),
                   "--start_stat", "1", "--update_from", str(half),
                   "--update_interval", str(half), "--test_iterations", str(CLI_ITERS),
                   "--save_iterations", str(CLI_ITERS), "--checkpoint_iterations", str(half),
                   "--eval_chamfer", "--log_every", str(CLI_LOG_EVERY)]
    beam_counts = (lambda: ck.launches, lambda: ck.bwd_launches)

    # --- 20. the beam variant trains, evaluates, saves and profiles ---
    n1_count = (lambda: nk.chamfer_launches,)
    ck.launches = ck.bwd_launches = nk.chamfer_launches = nk.knn_launches = 0
    with probe(Trainer, "step", beam_counts) as steps, \
            probe(cli, "run_eval") as evals, probe(cli, "measure_fps") as fps, \
            probe(metrics, "_chamfer_metrics", n1_count) as chamfers:
        cli.main(argv + ["--dump_renders", "--profile_steps", str(CLI_PROFILE_STEPS)])
    launches = {"K1": ck.launches, "K2": ck.bwd_launches, "N1": nk.chamfer_launches,
                "N2": nk.knn_launches}
    per_step = {tuple(c["launches"]) for c in steps}
    if len(steps) != CLI_ITERS or per_step != {(1, 1)}:
        fail(f"CLI beam run: {len(steps)} steps launching (K1, K2) {per_step} times each")
    scored = chamfer_launches("CLI beam run", chamfers, len(evals), out)
    # the init's 3-NN: the anchors' scales, and the voxel size's median at 0
    n2_want = 1 if float(CLI_VOXEL) > 0 else 2
    if scored["N1"] != launches["N1"] or launches["N2"] != n2_want:
        fail(f"CLI beam run: N1 {launches['N1']} (chamfer frames: {scored}), N2 "
             f"{launches['N2']} (not {n2_want}) launches")
    log = (out / "outputs.log").read_text()
    if f"iter {CLI_ITERS}: densify" not in log:
        fail("CLI beam run: no densify at the last iteration")
    for f in ("points3d.ply", f"chkpnt{half}.npz", "renders/test_000.npy", "cfg_args.json",
              f"point_cloud/iteration_{CLI_ITERS}/point_cloud.ply", "per_view.json",
              "point_cloud/iteration_best/mlp_checkpoints.npz"):
        if not (out / f).exists():
            fail(f"CLI beam run wrote no {f}")
    test = cli_results(out)
    if not all(k in test for k in ("depth_cd", "depth_fscore")):
        fail(f"CLI beam run: no chamfer metrics in results.json: {test}")
    gaps = np.diff([c["start"] for c in steps]) * 1e3
    beam = {
        "steps": len(steps), "launches": launches,
        "host_ms_per_step_median": float(np.median(gaps)),
        "host_ms_per_step_mean": float(gaps.mean()),
        **trace_device_ms(out / "trace" / "trace.json", CLI_PROFILE_STEPS),
        "profiled_steps": CLI_PROFILE_STEPS,
        "fps": fps[-1]["result"], "eval_s": [c["s"] for c in evals],
        "chamfer_ms_per_frame_median": float(np.median([c["s"] for c in chamfers]) * 1e3),
        "chamfer_frames": scored["frames"],
        "anchors": int(re.search(r"(\d+) anchors, voxel", log).group(1)), "test": test,
    }
    print(f"# cli beam: {json.dumps(beam)}", file=sys.stderr)

    # --- 21. the distance code against a float64 k-d tree ---
    init = read_point_cloud(str(out / "points3d.ply"))
    knn = knn_oracle(dev, np.ascontiguousarray(init[:KNN_POINTS]))
    voxels = {v: int(voxelize_points(torch.from_numpy(init).to(dev), v).shape[0])
              for v in (float(CLI_VOXEL), knn["median_port"])}
    beams = json.loads((root / "transforms_train.json").read_text())["beam_inclinations"]
    chamfer = chamfer_oracle(dev, out / "renders" / "test_000.npy", beams, 5.0, 80.0)
    # the port's torch-op answers to the native library's other two functions
    # (voxel_unique, pano_to_points): device ms by CUDA events
    init_dev = torch.from_numpy(init).to(dev)
    r0 = torch.from_numpy(np.load(out / "renders" / "test_000.npy")).to(dev)
    b0 = torch.as_tensor(beams, dtype=torch.float32, device=dev)
    native_ms = {
        "points": len(init),
        "voxelize_points_ms": float(np.median(time_ms(
            lambda: voxelize_points(init_dev, float(CLI_VOXEL)), KNN_TIMED, 1))),
        "pano_to_lidar_ms": float(np.median(time_ms(
            lambda: pano_to_lidar(r0[5] * r0[3], b0), KNN_TIMED, 1)))}
    print(f"# cli oracle: 3-NN {knn}; voxels {voxels}; chamfer {chamfer}; native "
          f"counterparts {native_ms}", file=sys.stderr)

    # --- 22. resume from the checkpoint, then evaluate the snapshot alone ---
    ck.launches = ck.bwd_launches = 0
    with probe(Trainer, "step", beam_counts) as steps:
        cli.main(argv + ["--start_checkpoint", str(half), "--test_iterations"])
    if len(steps) != CLI_ITERS - half or {tuple(c["launches"]) for c in steps} != {(1, 1)}:
        fail(f"CLI resume: {len(steps)} steps, launches {[c['launches'] for c in steps][:4]}")
    log = (out / "outputs.log").read_text()
    if f"resumed from iteration {half}" not in log or f"iter {CLI_ITERS}: densify" not in log:
        fail("CLI resume: no resume or no densify in its log")
    resumed = cli_results(out)
    nk.chamfer_launches = 0
    with probe(cli, "run_eval") as evals, \
            probe(metrics, "_chamfer_metrics", n1_count) as chamfers:
        cli.main(base + ["-m", str(out), "--load_iteration", str(CLI_ITERS), "--eval_chamfer"])
    eval_n1 = nk.chamfer_launches
    scored_eo = chamfer_launches("CLI eval-only", chamfers, len(evals), out)
    if scored_eo["N1"] != eval_n1:
        fail(f"CLI eval-only: {eval_n1} N1 launches, {scored_eo} in the chamfer frames")
    eval_only = cli_results(out)
    n_png = len(list((out / "test_renders").glob("*.png")))
    if n_png != 3 * n_test:
        fail(f"CLI eval-only: {n_png} test renders, not {3 * n_test}")
    if not all(k in eval_only for k in ("depth_cd", "depth_fscore")):
        fail(f"CLI eval-only: no chamfer metrics: {eval_only}")

    # --- 23. the surfel variant at its defaults ---
    sk.launches = sk.bwd_launches = 0
    with probe(Trainer, "step", (lambda: sk.launches, lambda: sk.bwd_launches)) as s_steps:
        cli.main(base + ["-m", str(out_s), "--surfel", "--iterations", str(CLI_SURFEL_ITERS),
                         "--test_iterations", "--save_iterations", str(CLI_SURFEL_ITERS),
                         "--log_every", str(CLI_SURFEL_ITERS)])
    s_launches = {"K5": sk.launches, "K6": sk.bwd_launches}
    per_step = {tuple(c["launches"]) for c in s_steps}
    if len(s_steps) != CLI_SURFEL_ITERS or per_step != {(1, 1)}:
        fail(f"CLI surfel run: {len(s_steps)} steps launching (K5, K6) {per_step} times each")
    s_test = cli_results(out_s)
    s_gaps = np.diff([c["start"] for c in s_steps]) * 1e3
    # --- 24-26. dump, refine and evaluate with the refiner and LPIPS ---
    refine = refine_phases(dev, base, out, n_test, eval_only)
    # --- 30. data-parallel training through the CLI: a frame batch, a fleet ---
    dp = cli_dp_phase(dev, base, work)
    # --- 31-33. the dynamic decomposition of a bundle made from the street ---
    dynamic = dynamic_phases(dev, root, work / "dynamic")
    summary = {
        "scene": CLI_SCENE, "dataset_s": dataset_s, "beam": beam,
        "knn_oracle": knn, "voxels": voxels, "chamfer_oracle": chamfer,
        "native_counterparts": native_ms,
        "resume": {"steps": len(steps), "test": resumed},
        "eval_only": {"eval_s": evals[-1]["s"], "test": eval_only, "launches": {"N1": eval_n1},
                      "chamfer_ms_per_frame_median": float(
                          np.median([c["s"] for c in chamfers]) * 1e3)},
        "surfel": {"steps": len(s_steps), "launches": s_launches, "test": s_test,
                   "host_ms_per_step_median": float(np.median(s_gaps))},
        "refine": refine,
        "dp": dp,
        "dynamic": dynamic,
    }
    shutil.rmtree(work, ignore_errors=True)
    return summary


def unet_card_vs_cpu(model, x, gt) -> dict:
    """The UNet's output and parameter gradients (the MSE over the real
    pixels of one padded frame `x`) on its device against a copy on the
    CPU, within UNET_CARD_TOL."""
    import copy

    import numpy as np
    import torch

    H, W = gt.shape
    runs = []
    for m in (model, copy.deepcopy(model).cpu()):
        dev = next(m.parameters()).device
        m.zero_grad(set_to_none=True)
        out = m(x.to(dev)[None])
        torch.mean((out[0, 0, :H, :W] - gt.to(dev)) ** 2).backward()
        runs.append((out.detach().cpu().numpy(),
                     {k: p.grad.detach().cpu().numpy() for k, p in m.named_parameters()}))
    (o_k, g_k), (o_c, g_c) = runs
    total = np.sqrt(sum(float((g ** 2).sum()) for g in g_c.values()))
    errs = {k: float(np.linalg.norm(g_k[k] - g)) for k, g in g_c.items()}
    leaf = {k: e / (UNET_CARD_TOL["rel"] * float(np.linalg.norm(g_c[k]))
                    + UNET_CARD_TOL["global_rel"] * total) for k, e in errs.items()}
    worst = max(leaf, key=leaf.get)
    res = {"out_max_abs": float(np.abs(o_k - o_c).max()),
           "grad_whole_rel": float(np.sqrt(sum(e * e for e in errs.values())) / total),
           "grad_worst_leaf": worst,
           "grad_worst_leaf_rel": errs[worst] / max(float(np.linalg.norm(g_c[worst])), 1e-30),
           "grad_worst_leaf_over_tol": leaf[worst], "tol": UNET_CARD_TOL}
    if not (res["out_max_abs"] <= UNET_CARD_TOL["out_max"]
            and res["grad_whole_rel"] <= UNET_CARD_TOL["whole"] and leaf[worst] <= 1.0):
        fail(f"UNet on the card against the CPU: {res}")
    return res


def refine_phases(dev, base: list, out: Path, n_test: int, unrefined: dict) -> dict:
    """Phases 24-26 on the CLI run's beam snapshot: dump its renders, train
    both refiners on them, and evaluate with each refiner and LPIPS."""
    import shutil

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from lidargs_torch.models import raydrop
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.train import cli
    from lidargs_torch.train import lpips as lp

    H, W = CLI_SCENE["H"], CLI_SCENE["W"]
    med = lambda xs: float(np.median(xs))

    # --- 24. dump: the refiner's input, one K1 launch per rendered frame ---
    renders = out / "renders"
    shutil.rmtree(renders, ignore_errors=True)
    ck.launches = 0
    t0 = time.perf_counter()
    cli.main(base + ["-m", str(out), "--load_iteration", str(CLI_ITERS), "--dump_renders"])
    dump_s = time.perf_counter() - t0
    k1 = ck.launches
    names = sorted(p.name for p in renders.iterdir())
    frames = [n for n in names if n != "dir.npy"]
    n_train = sum(n.startswith("train_") for n in frames)
    # run_eval, measure_fps and the dump render every frame, render_sets the test frames
    if len(frames) != CLI_NUM_FRAMES or "dir.npy" not in names or k1 != 3 * len(frames) + n_test:
        fail(f"dump: {len(names)} files, K1 launched {k1} times for {len(frames)} frames")
    shapes = {np.load(renders / n, mmap_mode="r").shape for n in frames}
    if shapes != {(6, H, W)} or np.load(renders / "dir.npy").shape != (H * W, 3):
        fail(f"dump: frame shapes {shapes}")
    dump = {"s": dump_s, "files": len(names), "k1_launches": k1}
    print(f"# dump: {json.dumps(dump)}", file=sys.stderr)

    # --- 25. refine: both archs through `cli refine`, one step timed ---
    d = cli.read_dumps(str(renders))
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    inputs = {
        "mlp": (raydrop.mlp_loss, (on(np.load(renders / "dir.npy")), on(d["intensity"][0].ravel()),
                                   on(d["depth"][0].ravel()), on(d["gt"][0].ravel()))),
        "unet": (raydrop.unet_loss, (raydrop._pad16(torch.stack(
            [on(d["raydrop"][0]), on(d["intensity"][0]), on(d["depth"][0])]))[0],
            on(d["gt"][0]))),
    }
    refine = {"reduced": {"epochs": REFINE_EPOCHS, "of": 100}, "train_frames": n_train}
    for arch, (loss_fn, args) in inputs.items():
        with probe(raydrop, "refine_step") as steps:
            t0 = time.perf_counter()
            model, hist = cli.refine_main([
                "--renders", str(renders), "--arch", arch, "--epochs", str(REFINE_EPOCHS),
                "--device", str(dev), "--out", str(out / f"refiner_{arch}.npz")])
            total_s = time.perf_counter() - t0
        first = float(steps[0]["result"])
        if (len(steps) != REFINE_EPOCHS * n_train or not np.isfinite(hist).all()
                or not hist[-1] < first):
            fail(f"refine {arch}: {len(steps)} steps, first loss {first}, history {hist}")
        opt, sched = raydrop.refiner_optimizer(model)
        step = lambda: raydrop.refine_step(model, opt, sched, loss_fn, *args)
        step_ms = time_ms(step, REFINE_TIMED, 3)
        prof = profile_render(step, frames=3)
        with FlopCounterMode(display=False) as flops:
            step()
        refine[arch] = {
            "steps": len(steps), "s": total_s, "first_step_loss": first, "history": hist,
            "host_ms_per_step_median": med(np.diff([c["start"] for c in steps]) * 1e3),
            "step_ms_median": med(step_ms), "step_ms_min": min(step_ms),
            "step_samples": len(step_ms),
            # the products' operations (torch's flop counter), at FP32's peak
            "gflop_per_step": flops.get_total_flops() / 1e9,
            "flop_bound_ms": flops.get_total_flops() / PEAK_FP32_OPS_PER_S * 1e3,
            "device_ms_per_step": prof.get("device_ms_per_frame"),
            "device_launches_per_step": prof.get("device_launches_per_frame"),
            "runtime_calls_per_step": prof.get("runtime_calls_per_frame"),
        }
        if arch == "unet":
            refine["unet_card_vs_cpu"] = unet_card_vs_cpu(model, *args)
        print(f"# refine {arch}: {json.dumps(refine[arch])}", file=sys.stderr)

    # --- 26. evaluate with each refiner and a random LPIPS npz ---
    lp_path = out / "lpips_random.npz"
    lp.save_lpips_params(str(lp_path), lp.random_lpips_params(0))
    evals = {"raydrop_acc_unrefined": unrefined["raydrop_acc"]}
    for arch in ("mlp", "unet"):
        ck.launches = 0
        with probe(cli, "run_eval") as runs:
            cli.main(base + ["-m", str(out), "--load_iteration", str(CLI_ITERS),
                             "--raydrop_refiner", str(out / f"refiner_{arch}.npz"),
                             "--lpips_weights", str(lp_path)])
        if ck.launches != 2 * len(frames) + n_test:       # eval, FPS, PNGs
            fail(f"eval with the {arch} refiner: K1 launched {ck.launches} times")
        res = json.loads((out / "results.json").read_text())
        for split, m in res.items():
            if not all(np.isfinite(m.get(k, np.nan)) for k in (
                    "intensity_lpips", "raydrop_acc", "intensity_psnr", "depth_rmse")):
                fail(f"eval with the {arch} refiner and LPIPS: {split} {m}")
        evals[arch] = {"eval_s": runs[-1]["s"], "k1_launches": ck.launches, "test": res["test"],
                       "raydrop_acc_train": res["train"]["raydrop_acc"]}
    fr = np.load(renders / "test_000.npy")
    a, b = np.clip(fr[0], 0.0, 1.0), fr[4] * fr[3]
    params = lp.random_lpips_params(0)
    with torch.no_grad():
        net = lp.lpips_net(params, dev)
        ta, tb = on(a), on(b)
        lpips_ms = time_ms(lambda: lp.lpips_single(net, ta, tb), 10, 2)
        card_v = float(lp.lpips_single(net, ta, tb))
        net_cpu = lp.lpips_net(params, "cpu")
        cpu_v = float(lp.lpips_single(net_cpu, torch.from_numpy(a), torch.from_numpy(b)))
        # the five tapped VGG maps of the intensity image, card against CPU
        x3 = lambda img: img[None, None].repeat(1, 3, 1, 1)
        taps = zip(net.features(x3(ta)), net_cpu.features(x3(torch.from_numpy(a))))
        tap_err = [float((f.cpu() - g).abs().max() / g.abs().max()) for f, g in taps]
    evals["lpips_frame"] = {"ms_median": med(lpips_ms), "card": card_v, "cpu": cpu_v,
                            "rel_err": abs(card_v - cpu_v) / abs(cpu_v),
                            "tap_max_rel_err": tap_err}
    if not abs(card_v - cpu_v) <= LPIPS_CARD_RTOL * abs(cpu_v):
        fail(f"LPIPS on the card against the CPU: {evals['lpips_frame']}")
    print(f"# refined eval: {json.dumps(evals)}", file=sys.stderr)
    return {"dump": dump, "refine": refine, "eval": evals}


# --- phase 34: the training step and the render as CUDA graphs ---

def sync_checked(fn, label: str):
    """Run `fn` under `torch.cuda.set_sync_debug_mode("warn")` and fail if
    anything in it synchronized with the card, naming each place; a
    synchronization in a backward pass (reported at the autograd engine) is
    located by running `fn` again in "error" mode under autograd's anomaly
    detection, which names the forward call of the node at fault."""
    import traceback
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{w.filename}:{w.lineno}: {w.message}" for w in caught
             if "called a synchronizing" in str(w.message)]
    if syncs:
        where = ""
        with torch.autograd.set_detect_anomaly(True):
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            except RuntimeError:
                where = traceback.format_exc()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        fail(f"{label} synchronizes with the card {len(syncs)} times: {syncs}\n{where}")
    return out


def pool_bytes(pool):
    """Bytes the caching allocator holds in the graph memory pool `pool`
    (it keeps what a capture took while the graphs live: the pool's peak),
    or "not measured" where the snapshot does not name the pools."""
    import torch

    segs = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in segs):
        return "not measured"
    return sum(seg["total_size"] for seg in segs
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def masked_frames(frames) -> list:
    """The frames with a vehicle-style pixel mask: every row of a band of
    W // 20 columns that moves from frame to frame."""
    import torch

    from lidargs_torch.lidar import LidarFrame

    out = []
    for i, f in enumerate(frames):
        w = max(f.W // 20, 1)
        c0 = (i * 97) % max(f.W - w, 1)
        cols = torch.arange(f.W, device=f.device)
        mask = ((cols >= c0) & (cols < c0 + w))[None, :].expand(f.H, f.W).contiguous()
        out.append(LidarFrame(f.w2s_rot, f.w2s_trans, f.center, f.beams, f.gt_image, f.uid,
                              mask))
    return out


def state_gap(a, b) -> dict:
    """Two TrainStates leaf by leaf: bit-equal or not, the largest |a - b|
    and the leaves that differ."""
    from lidargs_torch.train.trainer import state_leaves

    names = [f"leaf{i}" for i in range(len(state_leaves(a)))]
    diff = {}
    for n, x, y in zip(names, state_leaves(a), state_leaves(b)):
        if not (x.shape == y.shape and bool((x == y).all())):
            d = (x.double() - y.double()).abs()
            diff[n] = float(d.max()) if d.numel() else 0.0
    return {"bit_equal": not diff, "max_abs": max(diff.values(), default=0.0),
            "leaves_differing": diff}


def hold_to_eager(label: str, got, want, rerun) -> dict:
    """A graphed run's state `got` against an eager run's `want`, leaf by
    leaf (`state_gap`): bit for bit, or else within eager's own spread,
    `rerun()`'s state (a second eager run from the same state) against
    `want`; a leaf beyond it fails the phase."""
    gap = state_gap(got, want)
    out = {"graph_vs_eager": gap}
    if not gap["bit_equal"]:
        spread = state_gap(rerun(), want)
        out["eager_vs_eager"] = spread
        over = {k: v for k, v in gap["leaves_differing"].items()
                if v > spread["leaves_differing"].get(k, 0.0)}
        if over:
            fail(f"{label} state differs from eager beyond eager's own spread: {over} "
                 f"(spread {spread['leaves_differing']})")
    return out


def ms_and_profile(ms: dict, prof: dict) -> dict:
    """Each key's CUDA-event ms (median, min, max) and, where `prof` has the
    key, its profile: device ms, device launches and runtime calls a call,
    and the device's busy share (device ms over the median)."""
    import numpy as np

    out = {}
    for k, v in ms.items():
        out[f"{k}_ms_median"] = float(np.median(v))
        out[f"{k}_ms_min"], out[f"{k}_ms_max"] = min(v), max(v)
        p = prof.get(k)
        if p is None:
            continue
        out[f"{k}_device_ms"] = p["device_ms_per_frame"]
        out[f"{k}_launches"] = p.get("device_launches_per_frame", "not measured")
        out[f"{k}_runtime_calls"] = p.get("runtime_calls_per_frame")
        if isinstance(p["device_ms_per_frame"], float):
            out[f"{k}_device_busy_share"] = p["device_ms_per_frame"] / out[f"{k}_ms_median"]
    return out


def graph_steps(trainer, state, frames, n: int, dev):
    """`n` steps of `trainer` from `state`, a densify after step n // 2:
    (a clone of the final state, the losses, the K1/K2/K5/K6 launches)."""
    import torch

    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.ops import surfel_kernel as sk
    from lidargs_torch.train.trainer import clone_state

    gen = torch.Generator(device=dev).manual_seed(0)
    ck.launches = ck.bwd_launches = sk.launches = sk.bwd_launches = 0
    losses = []
    for it in range(1, n + 1):
        state, m = trainer.step(state, frames[(it - 1) % len(frames)], it)
        losses.append(m.loss.total)
        if it == n // 2:
            if not trainer.should_densify(int(state.valid.sum()), it):
                fail(f"phase 34: the densify cadence does not fire at step {it}")
            state, _ = trainer.densify(state, gen, VOXEL)
    launches = {"K1": ck.launches, "K2": ck.bwd_launches, "K5": sk.launches,
                "K6": sk.bwd_launches}
    return clone_state(state), [float(x) for x in losses], launches


def graph_phase(dev, name: str, params, valid, mcfg, rcfg, frames, variant: str) -> dict:
    """Phase 34 for one kind of step: eager and graphed `Trainer`s train
    GRAPH_STEPS[name] steps from one state (a densify at half, the
    statistics off for the last quarter); the graphed state against the
    eager one leaf by leaf (bit for bit, or within a second eager run's
    spread from the first); the graphed render against the eager one; each
    step and frame checked for synchronization with the card; times (CUDA
    events) and profiles of the graphed and eager step and frame; the graph
    pool's bytes."""
    import numpy as np
    import torch

    from lidargs_torch.config import OptConfig
    from lidargs_torch.models.field import AnchorField
    from lidargs_torch.train import Trainer, init_train_state

    n = GRAPH_STEPS[name]
    extra = dict(dist_from=0, normal_from=0) if variant == "surfel" else {}
    ocfg = OptConfig(start_stat=0, update_from=0, update_interval=n // 2,
                     update_until=n - n // 4, **extra)
    bg = torch.zeros(2, device=dev)
    make = lambda graphed: Trainer(mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, bg=bg, variant=variant,
                                   graphed=graphed)
    state0 = init_train_state(AnchorField(params=params, valid=valid, voxel_size=VOXEL), mcfg)
    k_fwd, k_bwd = ("K5", "K6") if variant == "surfel" else ("K1", "K2")

    eager, graphed = make(False), make(True)
    # one eager step and one eager frame with the card's synchronizations
    # reported (after one untimed step: first calls build what they need)
    eager.step(state0, frames[0], 1)
    sync_checked(lambda: eager.step(state0, frames[0], 1), f"an eager {name} step")
    with torch.no_grad():
        sync_checked(lambda: eager.render(state0.params, state0.valid, frames[0]),
                     f"an eager {name} frame")
    e1, loss_e, launch_e = graph_steps(eager, state0, frames, n, dev)
    g, loss_g, launch_g = graph_steps(graphed, state0, frames, n, dev)
    if launch_g[k_fwd] != n or launch_g[k_bwd] != n:
        fail(f"phase 34: {n} graphed {name} steps launched {launch_g}")
    out = {"steps": n, "densify_after": n // 2, "stats_until": ocfg.update_until,
           "launches_graphed": launch_g, "launches_eager": launch_e,
           "loss_first": loss_g[0], "loss_last": loss_g[-1], "losses_equal": loss_g == loss_e,
           **hold_to_eager(f"phase 34: graphed {name}", g, e1,
                           lambda: graph_steps(make(False), state0, frames, n, dev)[0])}

    # the render: graphed against eager, on the trained state
    with torch.no_grad():
        r_g = graphed.render(g.params, g.valid, frames[1])
        r_e = eager.render(g.params, g.valid, frames[1])
    out["render_bit_equal"] = all(torch.equal(a, b) for a, b in zip(r_g, r_e)
                                  if a is not None)
    if not out["render_bit_equal"]:
        fail(f"phase 34: the graphed {name} render differs from the eager one")

    # the graphed step and frame do not synchronize either
    held = {"g": graphed.step(g, frames[0], 1)[0], "e": g}

    def step_of(tr_, key):
        def one_step():
            held[key] = tr_.step(held[key], frames[0], 1)[0]
        return one_step

    sync_checked(step_of(graphed, "g"), f"a graphed {name} step")
    with torch.no_grad():
        sync_checked(lambda: graphed.render(g.params, g.valid, frames[0]),
                     f"a graphed {name} frame")
        frame_of = lambda tr_: (lambda: tr_.render(g.params, g.valid, frames[0]))
        ms = {"graph_step": time_ms(step_of(graphed, "g"), GRAPH_TIMED, 3),
              "eager_step": time_ms(step_of(eager, "e"), GRAPH_TIMED, 3),
              "graph_frame": time_ms(frame_of(graphed), GRAPH_TIMED, 3),
              "eager_frame": time_ms(frame_of(eager), GRAPH_TIMED, 3)}
        prof = {"graph_step": profile_render(step_of(graphed, "g"), frames=3),
                "eager_step": profile_render(step_of(eager, "e"), frames=3),
                "graph_frame": profile_render(frame_of(graphed), frames=3),
                "eager_frame": profile_render(frame_of(eager), frames=3)}
    out.update(ms_and_profile(ms, prof))
    out["pool_bytes"] = pool_bytes(graphed.graph_pool(dev))
    print(f"# phase 34 {name}: {json.dumps(out)}", file=sys.stderr)
    return out


def graph_phases(dev, params, valid, mcfg, beams) -> dict:
    """Phase 34: the beam, surfel and masked vehicle-style steps and their
    renders as CUDA graphs against eager (`graph_phase`), and the graph
    pool's bytes of one beam step at the CLI's anchor capacity."""
    import torch

    from lidargs_torch.config import ModelConfig, OptConfig, RasterConfig
    from lidargs_torch.models.field import AnchorField
    from lidargs_torch.train import Trainer, init_train_state
    from lidargs_torch.utils.testing import shell_field

    frames = train_frames(dev, beams, max(GRAPH_STEPS.values()))
    rcfg, srcfg = RasterConfig(**RASTER), RasterConfig(**SURFEL_RASTER)
    out = {"beam": graph_phase(dev, "beam", params, valid, mcfg, rcfg, frames, "beam"),
           "surfel": graph_phase(dev, "surfel", params, valid, mcfg, srcfg, frames,
                                 "surfel")}
    vcfg = ModelConfig(**{**MODEL, "anchor_capacity": GRAPH_VEHICLE["capacity"]})
    vparams, vvalid = shell_field(vcfg, GRAPH_VEHICLE["anchors"], seed=5, device=dev)
    out["masked"] = graph_phase(dev, "masked", vparams, vvalid, vcfg, rcfg,
                                masked_frames(frames), "beam")
    out["masked"].update(anchors=GRAPH_VEHICLE["anchors"], capacity=GRAPH_VEHICLE["capacity"])

    # the pool of one graphed beam step at the CLI's capacity
    ccfg = ModelConfig(**{**MODEL, "anchor_capacity": GRAPH_CLI_CAPACITY})
    cparams, cvalid = shell_field(ccfg, N_ANCHORS, seed=0, device=dev)
    tr = Trainer(mcfg=ccfg, ocfg=OptConfig(**OPT), rcfg=rcfg,
                 bg=torch.zeros(2, device=dev))
    tr.step(init_train_state(AnchorField(params=cparams, valid=cvalid, voxel_size=VOXEL),
                             ccfg), frames[0], 1)
    out["cli_capacity_pool"] = {"capacity": GRAPH_CLI_CAPACITY, "anchors": N_ANCHORS,
                                "pool_bytes": pool_bytes(tr.graph_pool(dev))}
    return out


# --- phases 27-30: data-parallel and multi-process training, the sharded render ---

def count_plain_launches(setter=setattr) -> None:
    """Route each kernel wrapper to its plain version, counting a launch as
    the wrapper does (`setter(module, name, value)` makes each change): the
    CPU rehearsal of this script (`tests/test_torch_smoke_bounds.py`) and
    its fleets' ranks on the CPU, where no kernel launches."""
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.ops import knn
    from lidargs_torch.ops import knn_kernel as nk
    from lidargs_torch.ops import surfel_kernel as sk

    # (module, function, module of its counter, counter); the distances
    # dispatch in `ops/knn.py`, their counters live in `ops/knn_kernel.py`
    for mod, name, cmod, counter in ((ck, "composite_tiles", ck, "launches"),
                                     (ck, "composite_tiles_bwd", ck, "bwd_launches"),
                                     (ck, "composite_windows", ck, "windows_launches"),
                                     (ck, "composite_windows_bwd", ck, "windows_bwd_launches"),
                                     (sk, "surfel_composite_tiles", sk, "launches"),
                                     (sk, "surfel_composite_tiles_bwd", sk, "bwd_launches"),
                                     (sk, "surfel_composite_windows", sk, "windows_launches"),
                                     (sk, "surfel_composite_windows_bwd", sk,
                                      "windows_bwd_launches"),
                                     (knn, "_chamfer_dir", nk, "chamfer_launches"),
                                     (knn, "knn_sqdist", nk, "knn_launches"),
                                     (knn, "knn3_mean_sq_dist", nk, "knn3_launches")):
        def counted(*a, plain=getattr(mod, name + "_plain"), cmod=cmod, counter=counter, **k):
            setattr(cmod, counter, getattr(cmod, counter) + 1)
            return plain(*a, **k)
        setter(mod, name, counted)
        setter(cmod, counter, 0)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tree_state(state) -> dict:
    """The parts of a TrainState the fleet is held to, on the CPU."""
    from lidargs_torch.train.optim import tree_map

    cpu = lambda x: x.detach().cpu()
    return {"params": tree_map(cpu, state.params), "mu": tree_map(cpu, state.opt.mu),
            "anchor_demon": cpu(state.anchor_demon)}


def render_loss(out):
    """The loss of the JAX package's sharded-render gradient test."""
    return (out.color ** 2).mean() + 0.01 * out.depth.mean()


def render_grads(render, params):
    """(RenderOut, the gradient of `render_loss` per parameter leaf)."""
    import torch

    from lidargs_torch.train.optim import tree_leaves, tree_unflatten

    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
    out = render(tree_unflatten(params, leaves))
    g = torch.autograd.grad(render_loss(out), leaves, allow_unused=True)
    return out, [torch.zeros_like(x) if gx is None else gx for gx, x in zip(g, leaves)]


def dp_graphed(dev):
    """`DPTrainer`'s `graphed` for the main path: its default, which replays
    the step's CUDA graphs on a card; on the CPU rehearsal True, the
    programs' bookkeeping with each function called in place of a replay."""
    return None if dev.type == "cuda" else True


def dp_train(trainer, state, frames, local, steps: int, dev, counters, densify: bool = True):
    """`steps` data-parallel steps, each on the frames `local` of `frames`
    stacked, then one densify (unless not `densify`): (first step's state,
    final state (both cloned: a graphed step donates its state), densified
    state, densify summary, per-step records: host
    ms (ending in a synchronize), kernel launches by `counters`, collective
    calls and bytes, ms in the collectives, in the host copies and waiting
    (`parallel/collectives.py` `stats`), loss)."""
    import torch

    from lidargs_torch.lidar import stack_frames
    from lidargs_torch.parallel import collectives
    from lidargs_torch.train.trainer import clone_state

    batch = stack_frames([frames[i] for i in local])
    first, per_step = None, []
    for it in range(1, steps + 1):
        before = [c() for c in counters]
        collectives.reset_stats()
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch, it)
        sync(dev)
        per_step.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "launches": [c() - b for c, b in zip(counters, before)],
                         "collective_calls": collectives.stats["calls"],
                         "collective_bytes": collectives.stats["bytes"],
                         "collective_ms": collectives.stats["collective_s"] * 1e3,
                         "copy_ms": collectives.stats["copy_s"] * 1e3,
                         "wait_ms": collectives.stats["wait_s"] * 1e3,
                         "loss": float(m.loss.total)})
        # a graphed step donates its state: the next step overwrites it
        first = clone_state(state) if first is None else first
    state = clone_state(state)
    if not densify:
        return first, state, None, None, per_step
    n_before = int(state.valid.sum())
    if not trainer.should_densify(n_before, steps):
        fail("the densify cadence does not fire after the last data-parallel step")
    dense, ds = trainer.densify(state, torch.Generator(device=dev).manual_seed(0), VOXEL)
    summary = {"n_anchors_before": n_before, "n_grown": int(ds.n_grown),
               "n_pruned": int(ds.n_pruned), "n_anchors_after": int(dense.valid.sum())}
    if summary["n_anchors_after"] != n_before + summary["n_grown"] - summary["n_pruned"]:
        fail(f"data-parallel densify: anchor count does not add up: {summary}")
    return first, state, dense, summary, per_step


def dp_nostats(trainer, state, batch, steps: int = 2):
    """`steps` data-parallel steps of `batch` from `state` without the
    statistics (an iteration past OPT's update_until): (a clone of the
    final state, the losses)."""
    from lidargs_torch.train.trainer import clone_state

    losses = []
    for _ in range(steps):
        state, m = trainer.step(state, batch, OPT["update_until"])
        losses.append(float(m.loss.total))
    return clone_state(state), losses


def dp_pool(dev, batch: int, capacity: int, frames, ocfg, rcfg):
    """The graph pool's bytes of one graphed data-parallel beam step of
    `batch` of `frames` on the smoke scene's anchors in `capacity` rows."""
    import torch

    from lidargs_torch.config import ModelConfig
    from lidargs_torch.lidar import stack_frames
    from lidargs_torch.models.field import AnchorField
    from lidargs_torch.parallel import DPTrainer, make_mesh
    from lidargs_torch.train import init_train_state
    from lidargs_torch.utils.testing import shell_field

    mcfg = ModelConfig(**{**MODEL, "anchor_capacity": capacity})
    params, valid = shell_field(mcfg, N_ANCHORS, seed=0, device=dev)
    tr = DPTrainer(mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, bg=torch.zeros(2, device=dev),
                   mesh=make_mesh(), graphed=dp_graphed(dev))
    tr.step(init_train_state(AnchorField(params=params, valid=valid, voxel_size=VOXEL), mcfg),
            stack_frames([frames[i % len(frames)] for i in range(batch)]), 1)
    sync(dev)
    return pool_bytes(tr.graph_pool(dev))


def dp_grouped(trainer, state, frames, groups, steps: int):
    """`steps` data-parallel steps in one process with the gradients summed
    as a fleet with one rank per group sums them: each group's frames in
    turn (`local_sums`), then the groups' sums added in rank order (gloo's
    sum of two ranks is their one addition), then `apply_sums`. (first
    step's state, final state)."""
    import torch

    from lidargs_torch.lidar import stack_frames
    from lidargs_torch.parallel.shard import apply_sums, local_sums

    batches = [stack_frames([frames[i] for i in g]) for g in groups]
    t, first = trainer, None
    for it in range(1, steps + 1):
        collect = t.ocfg.start_stat < it < t.ocfg.update_until
        sums = [local_sums(state, b, t.bg, t.mcfg, t.rcfg, t.ocfg, collect, t.variant)
                for b in batches]
        flat = sums[0][0]
        for f, _ in sums[1:]:
            flat = flat + f
        worst = torch.stack([w for _, w in sums]).amax(0)
        state, _ = apply_sums(state, flat, worst, sum(map(len, groups)), t.ocfg, collect)
        first = state if first is None else first
    return first, state


def param_gap(a: dict, b: dict) -> dict:
    """Two parameter trees entry by entry (on the CPU): entries beyond
    DP_TOL's fleet_param_atol, entries, the largest difference, bit
    equality."""
    from lidargs_torch.train.optim import tree_leaves

    n_far = n_all = 0
    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.cpu() - y.cpu()).abs()
        n_far += int((d > DP_TOL["fleet_param_atol"]).sum())
        n_all += d.numel()
        worst = max(worst, float(d.max()))
    return {"beyond_atol": n_far, "entries": n_all, "max_abs": worst,
            "bit_equal": worst == 0.0}


def fleet_run(cfg: dict, nproc: int, label: str) -> tuple:
    """Start `nproc` ranks of this script's fleet worker (`fleet_worker`)
    through the port's launcher; (coordinator's record, every rank's)."""
    from lidargs_torch.parallel.scaling import launch_fleet

    out = Path(cfg["out"])
    out.mkdir(parents=True, exist_ok=True)
    env = {"OMP_NUM_THREADS": "1"} if cfg["platform"] == "cpu" else None
    t0 = time.perf_counter()
    launch_fleet([sys.executable, str(ROOT / "chip_smoke.py"), "--fleet", json.dumps(cfg)],
                 nproc, out / "logs", timeout=FLEET_TIMEOUT, env=env)
    wall_s = time.perf_counter() - t0
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(nproc)]
    for r in range(nproc):
        tail = (out / "logs" / f"rank{r}.log").read_text(errors="replace")[-1500:].strip()
        if tail:
            print(f"# {label} rank {r} log tail:\n{tail}", file=sys.stderr)
    return ranks[0], ranks, wall_s


def fleet_worker(cfg: dict, argv: list) -> None:
    """One rank of a fleet this script starts (`--fleet <json>`, the rank
    flags appended by the launcher): phases 28-29 ("dp") or phase 30's CLI
    ("cli"). Writes its record to `<out>/rank<r>.json`."""
    import argparse

    import torch

    globals().update(cfg["sizes"])
    p = argparse.ArgumentParser()
    p.add_argument("--num_processes", type=int)
    p.add_argument("--process_id", type=int)
    p.add_argument("--coordinator")
    rank_args = p.parse_args(argv)
    if cfg["platform"] == "cpu":
        torch.set_num_threads(1)
        count_plain_launches()
    out = Path(cfg["out"])
    if cfg["phase"] == "cli":
        rec = cli_rank(cfg, argv)
    else:
        rec = dp_rank(cfg, rank_args)
    (out / f"rank{rank_args.process_id}.json").write_text(json.dumps(rec))


def dp_rank(cfg: dict, rank_args) -> dict:
    """Phases 28-29 on one rank: the data-parallel steps of phase 27 on this
    rank's share of the batch, the sharded render of phase 1's frame 0 with
    its gradient, and `measure_dp_rate`."""
    import numpy as np
    import torch

    from lidargs_torch.config import ModelConfig, OptConfig, RasterConfig
    from lidargs_torch.lidar import LidarFrame, uniform_beam_inclinations
    from lidargs_torch.models.field import AnchorField
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.parallel import DPTrainer, collectives
    from lidargs_torch.parallel.runtime import RuntimeConfig, init_runtime, shutdown_runtime
    from lidargs_torch.parallel.scaling import measure_dp_rate
    from lidargs_torch.parallel.sharded_render import render_field_sharded
    from lidargs_torch.train import init_train_state
    from lidargs_torch.utils.testing import sensor_poses, shell_field

    rt = init_runtime(RuntimeConfig(coordinator_address=rank_args.coordinator,
                                    num_processes=rank_args.num_processes,
                                    process_id=rank_args.process_id, platform=cfg["platform"]))
    dev = rt.device
    mcfg, rcfg = ModelConfig(**MODEL), RasterConfig(**RASTER)
    params, valid = shell_field(mcfg, N_ANCHORS, seed=0, device=dev)
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    bg = torch.zeros(2, device=dev)
    state0 = init_train_state(AnchorField(params=params, valid=valid, voxel_size=VOXEL), mcfg)
    rec = {"process_id": rt.process_id, "backend": rt.backend, "device": str(dev),
           "fingerprints": rt.fingerprint(state0)}

    # --- 28. phase 27's steps, this rank's share of each batch, graphed and
    # then eager ---
    mesh = rt.global_mesh()
    trainer, eager = (DPTrainer(mcfg=mcfg, ocfg=OptConfig(**OPT), rcfg=rcfg, bg=bg, mesh=mesh,
                                graphed=g) for g in (dp_graphed(dev), False))
    frames = train_frames(dev, beams, DP_BATCH)
    local = rt.local_indices(list(range(DP_BATCH)), mesh)
    counters = (lambda: ck.launches, lambda: ck.bwd_launches)
    collectives.settle = True       # wait apart from the transfer (collectives.py)
    first, final, dense, densify, per_step = dp_train(trainer, state0, frames, local, N_STEPS,
                                                      dev, counters)
    _, e_final, e_dense, _, e_steps = dp_train(eager, state0, frames, local, N_STEPS, dev,
                                               counters)
    # every rank holds the same state, so each finds the same gap; a rerun
    # (hold_to_eager) would call the collectives on one rank alone
    rec.update(local=local, per_step=per_step, densify=densify, eager_per_step=e_steps,
               graphed=trainer._steps is not None,
               graphed_vs_eager=state_gap(final, e_final),
               graphed_vs_eager_dense_valid=bool(torch.equal(dense.valid, e_dense.valid)))

    # --- 29. the sharded render of phase 1's frame 0, its gradient, the rate ---
    frame0 = LidarFrame.from_lidar2world(sensor_poses(N_FRAMES, seed=1)[0], beams,
                                         np.zeros((3, H, W), np.float32), uid=0, device=dev)
    tmesh = rt.global_mesh(data=1, tile=rt.num_processes)
    tiles = []
    run_k1 = ck.composite_tiles

    def k1(inst, *a):
        tiles.append(int(inst.shape[0]))
        return run_k1(inst, *a)

    render = lambda p: render_field_sharded(p, valid, frame0, mcfg, rcfg, bg, tmesh)
    ck.composite_tiles = k1
    with torch.no_grad():
        ck.launches = 0
        out = render(params)
        sync(dev)
        k1_fwd = ck.launches
    ck.composite_tiles = run_k1
    ms = []
    with torch.no_grad():
        for _ in range(RENDER_TIMED):
            collectives.reset_stats()
            t0 = time.perf_counter()
            render(params)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
    gather_ms = {k: collectives.stats[k + "_s"] * 1e3 for k in ("collective", "copy", "wait")}
    collectives.settle = False
    ck.launches = ck.bwd_launches = 0
    grads = render_grads(render, params)[1]
    sync(dev)
    rec["sharded"] = {"k1_launches": k1_fwd, "k1_tiles": tiles, "ms": ms,
                      "collective_ms_per_render": gather_ms,
                      "grad_k1_launches": ck.launches, "grad_k2_launches": ck.bwd_launches}
    rate = measure_dp_rate(rt.global_mesh(), mcfg, rcfg, OptConfig(start_stat=10 ** 9), H=H,
                           W=W, n_points=N_ANCHORS, steps=DP_RATE_STEPS, warmup=1,
                           voxel_size=0.5, runtime=rt)
    rec["dp_rate"] = rate
    rt.sync("done")
    if rt.is_coordinator:
        torch.save({"first": tree_state(first), "final": tree_state(final),
                    "dense_valid": dense.valid.cpu(), "color": out.color.cpu(),
                    "depth": out.depth.cpu(), "grads": [g.cpu() for g in grads]},
                   Path(cfg["out"]) / "coordinator.pt")
    rt.sync("saved")
    shutdown_runtime()
    return rec


def cli_rank(cfg: dict, rank_flags: list) -> dict:
    """Phase 30 on one rank: the training CLI with this rank's flags, each
    `DPTrainer.step` probed for its kernel launches."""
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.parallel import DPTrainer
    from lidargs_torch.parallel.runtime import shutdown_runtime
    from lidargs_torch.train import cli

    with probe(DPTrainer, "step", (lambda: ck.launches, lambda: ck.bwd_launches)) as steps:
        cli.main(cfg["argv"] + rank_flags)
    shutdown_runtime()
    gaps = [b["start"] - a["start"] for a, b in zip(steps, steps[1:])]
    return {"steps": len(steps), "launches": [c["launches"] for c in steps],
            "host_ms_per_step": [g * 1e3 for g in gaps]}


def dp_phases(dev, params, valid, mcfg, rcfg, beams, o0, frame0, train: dict):
    """Phases 27-29: (summary for the timing line, launches for the kernels
    line)."""
    import numpy as np
    import torch

    from lidargs_torch.config import OptConfig, RasterConfig
    from lidargs_torch.lidar import stack_frames
    from lidargs_torch.models.field import AnchorField, render_field
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.ops import surfel_kernel as sk
    from lidargs_torch.parallel import DPTrainer, make_mesh
    from lidargs_torch.parallel.runtime import Runtime, RuntimeConfig
    from lidargs_torch.train import Trainer, init_train_state
    from lidargs_torch.train.optim import lr_schedules, tree_leaves

    med = lambda xs: float(np.median(xs))
    ocfg = OptConfig(**OPT)
    bg = torch.zeros(2, device=dev)
    state0 = init_train_state(AnchorField(params=params, valid=valid, voxel_size=VOXEL), mcfg)
    frames = train_frames(dev, beams, DP_BATCH)
    dp, eager = (DPTrainer(mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, bg=bg, mesh=make_mesh(), graphed=g)
                 for g in (dp_graphed(dev), False))
    counters = (lambda: ck.launches, lambda: ck.bwd_launches)

    # --- 27a. DP_BATCH identical frames: one DP step equals one Trainer.step ---
    single, m_s = Trainer(mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, bg=bg).step(state0, frames[0], 1)
    same, m_d = dp.step(state0, stack_frames([frames[0]] * DP_BATCH), 1)
    sync(dev)
    worst, n_far = 0.0, 0
    lrs = lr_schedules(ocfg)
    for key in single.params:
        lr = float(lrs[key](state0.step))
        for a, b, g in zip(tree_leaves(same.params[key]), tree_leaves(single.params[key]),
                           tree_leaves(single.opt.mu[key])):
            d = (a - b).abs()
            above = g.abs() > 1e-3 * g.abs().max()
            over = d > DP_TOL["param_atol"] + DP_TOL["param_rtol"] * b.abs()
            n_far += int((over & above).sum())
            worst = max(worst, float(d.max()))
            if not bool((d <= 2 * lr + 1e-6).all()):
                fail(f"identical frames: a parameter of {key} moved beyond two of its "
                     f"learning rate {lr}")
    demon_ratio = (same.anchor_demon == DP_BATCH * single.anchor_demon).all()
    identical = {"params_beyond_tol_above_noise_floor": n_far, "max_abs": worst,
                 "loss_rel": abs(float(m_d.loss.total) - float(m_s.loss.total))
                 / abs(float(m_s.loss.total)), "anchor_demon_times_batch": bool(demon_ratio)}
    if n_far or not demon_ratio or not identical["loss_rel"] <= 1e-5:
        fail(f"{DP_BATCH} identical frames against one step: {identical}")

    # --- 27b. DP_BATCH distinct frames: N_STEPS steps and one densify ---
    ck.launches = ck.bwd_launches = 0
    first, final, dense, densify, per_step = dp_train(dp, state0, frames, range(DP_BATCH),
                                                      N_STEPS, dev, counters)
    launches = {"K1": ck.launches, "K2": ck.bwd_launches}
    if any(s["launches"] != [DP_BATCH, DP_BATCH] for s in per_step):
        fail(f"one-process DP steps launched (K1, K2) {[s['launches'] for s in per_step]}")
    if not np.isfinite([s["loss"] for s in per_step]).all():
        fail(f"non-finite DP losses: {[s['loss'] for s in per_step]}")
    if dev.type == "cuda" and dp._steps is None:
        fail("the one-process DP step did not replay its CUDA graphs")
    # --- 27c. the witness: one process, the gradients summed in the fleet's order ---
    local_n = DP_BATCH // DP_FLEET
    groups = [list(range(r * local_n, (r + 1) * local_n)) for r in range(DP_FLEET)]
    w_first, w_final = dp_grouped(dp, state0, frames, groups, N_STEPS)
    witness = {"groups": groups, "vs_one_process": param_gap(w_final.params, final.params)}

    # --- 27d. graphed against eager: the same steps and densify, then steps
    # without the statistics from the densified state ---
    e_first, e_final, e_dense, e_densify, e_steps = dp_train(
        eager, state0, frames, range(DP_BATCH), N_STEPS, dev, counters)
    batch = stack_frames(frames)
    g_nostats, g_losses = dp_nostats(dp, dense, batch)
    e_nostats, e_losses = dp_nostats(eager, e_dense, batch)
    vs_eager = {
        "losses_equal": ([s["loss"] for s in per_step] == [s["loss"] for s in e_steps]
                         and g_losses == e_losses),
        "densify_equal": densify == e_densify,
        "final": hold_to_eager("phase 27: the graphed DP step", final, e_final, lambda: dp_train(
            eager, state0, frames, range(DP_BATCH), N_STEPS, dev, counters, densify=False)[1]),
        "nostats_after_densify": hold_to_eager(
            "phase 27: the graphed DP step without statistics", g_nostats, e_nostats,
            lambda: dp_nostats(eager, e_dense, batch)[0]),
    }

    # the graphed step makes no synchronization; graphed and eager timed and
    # profiled in the same call
    held = {"g": final, "e": final}

    def step_of(tr_, key):
        def one_step():
            held[key] = tr_.step(held[key], batch, 1)[0]
        return one_step

    sync_checked(step_of(dp, "g"), "a graphed one-process DP step")
    ms = {"graph_step": time_ms(step_of(dp, "g"), TRAIN_TIMED, 3),
          "eager_step": time_ms(step_of(eager, "e"), TRAIN_TIMED, 3)}
    prof = {k: profile_render(step_of(tr_, k[0]), frames=3)
            for k, tr_ in (("graph_step", dp), ("eager_step", eager))}
    # the pool: this trainer's (both statistics modes), then one mode's at
    # 1, 2 and DP_BATCH frames, and at the CLI's capacity
    cap = MODEL["anchor_capacity"]
    pools = {"both_modes": pool_bytes(dp.graph_pool(dev)),
             **{f"B{b}_capacity_{c}": dp_pool(dev, b, c, frames, ocfg, rcfg)
                for b, c in ((1, cap), (2, cap), (DP_BATCH, cap),
                             (DP_BATCH, GRAPH_CLI_CAPACITY))}}

    # the surfel variant's DP step at a smaller count: K5 and K6 per frame
    srcfg = RasterConfig(**SURFEL_RASTER)
    sdp, sdp_e = (DPTrainer(mcfg=mcfg, ocfg=ocfg, rcfg=srcfg, bg=bg, mesh=make_mesh(),
                            variant="surfel", graphed=g) for g in (dp_graphed(dev), False))
    s_counters = (lambda: sk.launches, lambda: sk.bwd_launches)
    sk.launches = sk.bwd_launches = 0
    _, s_final, _, _, s_steps = dp_train(sdp, state0, frames, range(DP_BATCH), SURFEL_DP_STEPS,
                                         dev, s_counters, densify=False)
    if any(s["launches"] != [DP_BATCH, DP_BATCH] for s in s_steps):
        fail(f"surfel DP steps launched (K5, K6) {[s['launches'] for s in s_steps]}")
    s_launches = {"K5": sk.launches, "K6": sk.bwd_launches}
    _, se_final, _, _, se_steps = dp_train(sdp_e, state0, frames, range(DP_BATCH),
                                           SURFEL_DP_STEPS, dev, s_counters, densify=False)
    sg_nostats, sg_losses = dp_nostats(sdp, s_final, batch)
    se_nostats, se_losses = dp_nostats(sdp_e, se_final, batch)
    s_held = {"g": s_final, "e": s_final}

    def s_step_of(tr_, key):
        def one_step():
            s_held[key] = tr_.step(s_held[key], batch, 1)[0]
        return one_step

    s_ms = {"graph_step": time_ms(s_step_of(sdp, "g"), TRAIN_TIMED, 3),
            "eager_step": time_ms(s_step_of(sdp_e, "e"), TRAIN_TIMED, 3)}
    surfel = {
        "steps": SURFEL_DP_STEPS, "launches": s_launches,
        "losses": [s["loss"] for s in s_steps], "host_ms": [s["ms"] for s in s_steps],
        "losses_equal": ([s["loss"] for s in s_steps] == [s["loss"] for s in se_steps]
                         and sg_losses == se_losses),
        "final": hold_to_eager("phase 27: the graphed surfel DP step", s_final, se_final,
                               lambda: dp_train(sdp_e, state0, frames, range(DP_BATCH),
                                                SURFEL_DP_STEPS, dev, s_counters,
                                                densify=False)[1]),
        "nostats": hold_to_eager("phase 27: the graphed surfel DP step without statistics",
                                 sg_nostats, se_nostats,
                                 lambda: dp_nostats(sdp_e, se_final, batch)[0]),
        "pool_bytes": pool_bytes(sdp.graph_pool(dev)), **ms_and_profile(s_ms, {}),
    }
    one_proc = {
        "batch": DP_BATCH, "steps": N_STEPS, "identical": identical, "launches": launches,
        "graphed": dp._steps is not None, "witness_fleet_order": witness,
        "loss_first": per_step[0]["loss"], "loss_last": per_step[-1]["loss"],
        "densify": densify, "vs_eager": vs_eager, **ms_and_profile(ms, prof),
        "step_samples": len(ms["graph_step"]),
        "single_step_ms_x_batch": DP_BATCH * train["step_ms_median"],
        "profile": profile_summary(prof["graph_step"]),
        "eager_profile": profile_summary(prof["eager_step"]), "pool_bytes": pools,
        "surfel": surfel,
    }
    print(f"# dp one process: {json.dumps(one_proc)}", file=sys.stderr)

    # --- 28-29. the same in a fleet of DP_FLEET ranks on this card ---
    sizes = {k: globals()[k] for k in SIZE_NAMES}
    cfg = {"phase": "dp", "platform": dev.type, "sizes": sizes,
           "out": str(ROOT / "build" / "chip_smoke_fleet")}
    coord, ranks, wall_s = fleet_run(cfg, DP_FLEET, "dp fleet")
    res = torch.load(Path(cfg["out"]) / "coordinator.pt", weights_only=False)
    local = DP_BATCH // DP_FLEET
    for r in ranks:
        if any(s["launches"] != [local, local] for s in r["per_step"]):
            fail(f"fleet rank {r['process_id']}: (K1, K2) per step "
                 f"{[s['launches'] for s in r['per_step']]}, not ({local}, {local})")
    prints = [r["fingerprints"] for r in ranks]
    mine = Runtime(RuntimeConfig(), dev, None).fingerprint(state0)
    if len({p for ps in prints for p in ps} | set(mine)) != 1:
        fail(f"fleet fingerprints differ: {prints}, this process {mine}")
    if not torch.equal(res["dense_valid"], dense.valid.cpu()):
        fail("fleet: valid after the densify differs from the one-process run")
    if coord["densify"] != densify:
        fail(f"fleet densify {coord['densify']} against one process {densify}")
    if [r["local"] for r in ranks] != groups:
        fail(f"fleet ranks' frames {[r['local'] for r in ranks]}, the witness's {groups}")
    grad_err = {}
    for name, a, b in zip(leaf_names(first.params), tree_leaves(res["first"]["mu"]),
                          tree_leaves(first.opt.mu)):
        b = b.cpu()
        grad_err[name] = float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))
    vs_witness = param_gap(res["final"]["params"], w_final.params)
    first_vs_witness = param_gap(res["first"]["mu"], w_first.opt.mu)
    vs_one = param_gap(res["final"]["params"], final.params)
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(coord["per_step"], per_step))
    fleet_ok = (max(grad_err.values()) <= DP_TOL["fleet_grad_rel"]
                and loss_rel <= DP_TOL["fleet_loss_rel"]
                and vs_witness["beyond_atol"] == 0 and first_vs_witness["beyond_atol"] == 0
                and torch.equal(res["final"]["anchor_demon"], final.anchor_demon.cpu()))
    # each rank's graphed steps against its eager ones (the same processes)
    for r in ranks:
        gap = r["graphed_vs_eager"]
        if (dev.type == "cuda" and not r["graphed"]) or not r["graphed_vs_eager_dense_valid"] \
                or gap["max_abs"] > DP_TOL["fleet_param_atol"]:
            fail(f"fleet rank {r['process_id']}: graphed {r['graphed']}, graphed against eager "
                 f"{gap}, valid after the densify equal {r['graphed_vs_eager_dense_valid']}")
    steps_ms = [s["ms"] for r in ranks for s in r["per_step"][1:]]
    coll = coord["per_step"][1:]
    e_coll = coord["eager_per_step"][1:]
    fleet = {
        "label": f"{DP_FLEET} ranks share one card: not a scaling figure",
        "backend": coord["backend"], "devices": [r["device"] for r in ranks],
        "graphed": [r["graphed"] for r in ranks],
        "graphed_vs_eager": [r["graphed_vs_eager"] for r in ranks],
        "eager_losses_equal": all([s["loss"] for s in r["per_step"]]
                                  == [s["loss"] for s in r["eager_per_step"]] for r in ranks),
        "eager_step_ms_median": med([s["ms"] for r in ranks for s in r["eager_per_step"][1:]]),
        "eager_collective_ms_per_step_median": med([s["collective_ms"] for s in e_coll]),
        "eager_copy_ms_per_step_median": med([s["copy_ms"] for s in e_coll]),
        "eager_wait_ms_per_step_median": med([s["wait_ms"] for s in e_coll]),
        "wall_s": wall_s, "fingerprints": prints, "densify": coord["densify"],
        "first_step_grad_rel_err_max": max(grad_err.values()),
        "loss_rel_err_max": loss_rel, "final_params_vs_witness": vs_witness,
        "first_step_mu_vs_witness": first_vs_witness, "final_params_vs_one_process": vs_one,
        "witness_vs_one_process": witness["vs_one_process"],
        "step_ms_median": med(steps_ms),
        "collective_ms_per_step_median": med([s["collective_ms"] for s in coll]),
        "copy_ms_per_step_median": med([s["copy_ms"] for s in coll]),
        "wait_ms_per_step_median": med([s["wait_ms"] for s in coll]),
        "collective_bytes_per_step": coll[0]["collective_bytes"] if coll else None,
        "collective_calls_per_step": coll[0]["collective_calls"] if coll else None,
        "losses": [s["loss"] for s in coord["per_step"]],
    }
    if not fleet_ok:
        fail(f"fleet state against the one-process runs: {fleet}; grads {grad_err}")
    print(f"# dp fleet: {json.dumps(fleet)}", file=sys.stderr)

    # --- 29. the sharded render against phase 1's frame 0, and its gradient ---
    T = -(-H // rcfg.tile_h) * -(-W // rcfg.tile_w)
    Tl = -(-T // DP_FLEET)
    for r in ranks:
        sh = r["sharded"]
        if sh["k1_launches"] != 1 or sh["k1_tiles"] != [Tl]:
            fail(f"sharded render rank {r['process_id']}: {sh['k1_launches']} K1 launches on "
                 f"{sh['k1_tiles']} tiles, not one on {Tl}")
    dc = (res["color"] - o0.color.cpu()).abs().max()
    dd = (res["depth"] - o0.depth.cpu()).abs().max()
    ref_out, ref_g = render_grads(
        lambda p: render_field(p, valid, frame0, mcfg, rcfg, bg)[0], params)
    sync(dev)
    g_err = {}
    for name, a, b in zip(leaf_names(params), res["grads"], ref_g):
        b = b.cpu()
        excess = ((a - b).abs() - (DP_TOL["grad_atol"] + DP_TOL["grad_rtol"] * b.abs())).max()
        g_err[name] = {"max_abs": float((a - b).abs().max()), "excess": float(excess)}
    sharded = {
        "tiles_per_rank": Tl, "color_max_abs": float(dc), "depth_max_abs": float(dd),
        "bit_equal": bool(torch.equal(res["color"], o0.color.cpu())
                          and torch.equal(res["depth"], o0.depth.cpu())),
        "grad_max_abs": max(e["max_abs"] for e in g_err.values()),
        "ms_median": med([m for r in ranks for m in r["sharded"]["ms"][1:]]),
        "collective_ms_per_render": [{k: v / RENDER_TIMED for k, v in
                                      r["sharded"]["collective_ms_per_render"].items()}
                                     for r in ranks],
        "grad_launches": [(r["sharded"]["grad_k1_launches"], r["sharded"]["grad_k2_launches"])
                          for r in ranks],
        "dp_rate": coord["dp_rate"],
        "label": f"{DP_FLEET} ranks share one card: not a scaling figure",
    }
    if not (sharded["color_max_abs"] <= 1e-5 and sharded["depth_max_abs"] <= 1e-4):
        fail(f"sharded render against phase 1's frame 0: {sharded}")
    if max(e["excess"] for e in g_err.values()) > 0:
        fail(f"sharded render's gradient against the unsharded render's: {g_err}")
    print(f"# sharded render: {json.dumps(sharded)}", file=sys.stderr)
    kernels = {"K1": {"launches_dp": launches["K1"],
                      "launches_sharded": ranks[0]["sharded"]["k1_launches"]},
               "K2": {"launches_dp": launches["K2"],
                      "launches_sharded": ranks[0]["sharded"]["grad_k2_launches"]},
               "K5": {"launches_dp": s_launches["K5"]}, "K6": {"launches_dp": s_launches["K6"]}}
    return {"one_process": one_proc, "fleet": fleet, "sharded": sharded}, kernels


def leaf_names(tree, path="") -> list:
    """The leaves' paths of nested dicts, in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [n for k in tree for n in leaf_names(tree[k], f"{path}{k}/")]
    return [path.rstrip("/")]


def cli_dp_phase(dev, base: list, work: Path) -> dict:
    """Phase 30: the CLI with a frame batch in one process, then a fleet of
    DP_FLEET processes with one evaluation and one save."""
    import numpy as np
    import torch

    from lidargs_torch.data.scene import Scene
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.parallel import DPTrainer
    from lidargs_torch.train import cli

    one, fleet_out = work / "dp_one", work / "dp_fleet"
    common = ["--iterations", str(CLI_DP_ITERS), "--log_every", str(CLI_DP_ITERS)]
    ck.launches = ck.bwd_launches = 0
    # each step ends in a synchronize: 6 steps would not fill the launch
    # queue, and the gaps would time the enqueue
    with probe(DPTrainer, "step", (lambda: ck.launches, lambda: ck.bwd_launches),
               after=lambda: sync(dev)) as steps:
        cli.main(base + ["-m", str(one), *common, "--data_parallel", "1", "--dp_batch",
                         str(DP_BATCH), "--test_iterations", "--save_iterations",
                         str(CLI_DP_ITERS)])
    if len(steps) != CLI_DP_ITERS or any(c["launches"] != [DP_BATCH, DP_BATCH] for c in steps):
        fail(f"CLI --dp_batch {DP_BATCH}: {len(steps)} steps launching (K1, K2) "
             f"{[c['launches'] for c in steps]}")
    one_gaps = np.diff([c["start"] for c in steps]) * 1e3
    # a graphed step returns its static state buffers every time (donation)
    donated = all(c["result"][0] is steps[0]["result"][0] for c in steps)
    if dev.type == "cuda" and not donated:
        fail(f"CLI --dp_batch {DP_BATCH}: the steps did not replay CUDA graphs")
    one_test = cli_results(one)

    argv = base + ["-m", str(fleet_out), *common, "--dp_batch", str(DP_FLEET),
                   "--test_iterations", str(CLI_DP_ITERS // 2),
                   "--save_iterations", str(CLI_DP_ITERS)]
    cfg = {"phase": "cli", "platform": dev.type, "argv": argv,
           "sizes": {k: globals()[k] for k in SIZE_NAMES}, "out": str(work / "dp_fleet_ranks")}
    coord, ranks, wall_s = fleet_run(cfg, DP_FLEET, "cli fleet")
    for r in ranks:
        if r["steps"] != CLI_DP_ITERS or any(l != [1, 1] for l in r["launches"]):
            fail(f"CLI fleet rank: {r['steps']} steps launching (K1, K2) {r['launches']}")
    files = sorted(p.name for p in fleet_out.iterdir())
    want = {"cfg_args.json", "outputs.log", "outputs.p1.log", "results.json", "per_view.json",
            "point_cloud", "points3d.ply"}
    if not want <= set(files) or any(f.startswith("outputs.p0") for f in files):
        fail(f"CLI fleet wrote {files}")
    log1 = (fleet_out / "outputs.p1.log").read_text()
    if "[eval" in log1 or "saved snapshot" in log1:
        fail("CLI fleet: rank 1 evaluated or saved")
    fleet_test = cli_results(fleet_out)
    snaps = sorted(p.name for p in (fleet_out / "point_cloud").iterdir())
    mcfg = cli.build_config(base + ["-m", str(fleet_out)])[0].model
    field = Scene._load_field(str(fleet_out), CLI_DP_ITERS, mcfg, dev)
    n_anchors = int(field.valid.sum())
    if not n_anchors > 0 or not bool(torch.isfinite(field.params["anchor"]).all()):
        fail(f"CLI fleet snapshot loads {n_anchors} anchors")
    gaps = [g for r in ranks for g in r["host_ms_per_step"]]
    return {"one_process": {"steps": len(steps), "graphed": donated,
                            "host_ms_per_step_median": float(np.median(one_gaps)),
                            "host_ms_per_step": one_gaps.tolist(), "test": one_test},
            "fleet": {"label": f"{DP_FLEET} ranks share one card: not a scaling figure",
                      "wall_s": wall_s, "steps": [r["steps"] for r in ranks],
                      "launches_per_step": ranks[0]["launches"][0], "files": files,
                      "snapshots": snaps, "snapshot_anchors": n_anchors,
                      "host_ms_per_step_median": float(np.median(gaps)) if gaps else None,
                      "test": fleet_test}}


# --- phases 31-33: the dynamic (background / vehicle) decomposition ---

def box_corners(lo, hi):
    """[8, 3] corners of an axis-aligned box in DyNFL's order: corner 0 at
    the minimum, x along 0->4, y along 0->3, z along 0->1."""
    import numpy as np

    (x0, y0, z0), (x1, y1, z1) = lo, hi
    return np.array([[x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0],
                     [x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]], np.float64)


def write_dynamic_bundle(street: Path, ctx: Path) -> dict:
    """Every file `WaymoDynamicScene` reads, from the street's written range
    images and poses plus one vehicle (DYN_VEHICLE) raycast alone and taken
    where it is nearer than the street. Returns the bundle's sizes and the
    vehicle's pixels a frame."""
    import numpy as np

    from lidargs_torch.data.synthetic import raycast_world
    from lidargs_torch.lidar.pano import ray_dirs_from_beams

    train = json.loads((street / "transforms_train.json").read_text())
    test = json.loads((street / "transforms_test.json").read_text())
    H, W = train["h_lidar"], train["w_lidar"]
    beams = np.asarray(train["beam_inclinations"], np.float64)
    metas = sorted(train["frames"] + test["frames"], key=lambda m: m["lidar_file_path"])
    n = len(metas)
    dirs = ray_dirs_from_beams(H, W, beams).numpy()
    v = DYN_VEHICLE
    ri = np.zeros((n, H, W, 3), np.float32)
    obj = np.full((n, H, W), -1, np.int32)
    corners, poses, vehicle_px = [], [], []
    for i, meta in enumerate(metas):
        l2w = np.asarray(meta["lidar2world"], np.float64)
        rv = np.load(street / meta["lidar_file_path"])           # [H, W, (0, inten, depth)]
        x0 = v["x0"] + v["speed"] * i
        lo = np.array([x0, v["y"] - v["width"] / 2, 0.0])
        hi = np.array([x0 + v["length"], v["y"] + v["width"] / 2, v["height"]])
        # the box alone: no spheres, the ground beyond the far plane
        depth, inten = raycast_world(l2w[:3, 3], dirs @ l2w[:3, :3].T, np.zeros((0, 4)),
                                     np.zeros(1), ground_z=-1e6,
                                     boxes=np.concatenate([lo, hi])[None],
                                     box_albedo=np.array([v["albedo"]]), lambertian=True)
        hit = (depth > 0) & ((rv[..., 2] == 0) | (depth < rv[..., 2]))
        dist = np.where(hit, depth, rv[..., 2])
        # stored so that the reader's tanh gives back the intensity
        ri[i, ..., 0] = dist
        ri[i, ..., 1] = np.arctanh(np.clip(np.where(hit, inten, rv[..., 1]), 0.0, 1.0 - 1e-7))
        obj[i][hit] = 0
        corners.append(box_corners(lo, hi))
        poses.append(l2w)
        vehicle_px.append(int(hit.sum()))
    ctx.mkdir(parents=True, exist_ok=True)
    np.save(ctx / "range_images1.npy", ri)
    np.save(ctx / "ray_object_indices.npy", obj)
    np.save(ctx / "normals.npy", np.zeros((n, H, W, 3), np.float32))
    np.save(ctx / "valid_normal_flags.npy", np.ones((n, H, W), bool))
    np.save(ctx / "beam_inclinations.npy", beams)
    # a background ray (index -1) reads the frame's last listed object (a
    # fault of the JAX package that the port keeps): list a static parked
    # car last, so that the background keeps its rays
    car, parked = "vehicle_0", "parked_0"
    parked_box = box_corners([12.0, 5.0, 0.0], [16.5, 7.0, 1.6])
    ids = np.empty((n, 2), dtype=object)
    ids[:] = [car, parked]
    np.save(ctx / "object_ids_per_frame.npy", ids)
    np.save(ctx / "objects_id_types_per_frame.npy", np.array([[1, 1]] * n, dtype=object))
    dicts = {"tsfm": {car: [np.eye(4)] * n, parked: [np.eye(4)]},
             "corners": {car: corners, parked: [parked_box]},
             "anchors": {car: corners[0], parked: parked_box},
             "frameidx": {car: list(range(n)), parked: [0]},
             "dynamic_flag": {car: True, parked: False}}
    for name, d in dicts.items():
        np.save(ctx / f"objects_id_2_{name}.npy", np.array(d, dtype=object))
    # meta_info.json: the reader takes frames[i + 50]
    frames = [{"lidar2world": p.tolist()} for p in poses + poses]
    (ctx / "meta_info.json").write_text(json.dumps({"frames": frames}))
    mb = sum(f.stat().st_size for f in ctx.iterdir()) / 2 ** 20
    return {"frames": n, "H": H, "W": W, "mb": mb, "vehicle_pixels_per_frame": vehicle_px}


def masked_metrics(out, frame) -> dict:
    """Depth L1 (m) and intensity PSNR (dB) over the frame's pixel mask."""
    import math

    m = frame.pixel_mask.float()
    n = float(m.sum())
    gt = frame.gt_image
    l1 = float(((out.depth - gt[2]).abs() * m).sum()) / n
    mse = float(((out.color[0] - gt[1]) ** 2 * m).sum()) / n
    return {"pixels": int(n), "depth_l1": l1,
            "intensity_psnr": -10.0 * math.log10(mse) if mse > 0 else float("inf")}


def train_subscene(dev, name: str, md) -> dict:
    """Phases 32-33 for one sub-scene: the field from its init points, the
    masked steps with one densify (K1 and K2 counted), timings and a
    profile, one masked step's K1/K2 against the plain versions, the test
    frames before and after training."""
    import numpy as np
    import torch

    from lidargs_torch.config import ModelConfig, OptConfig, RasterConfig
    from lidargs_torch.models.field import field_splats, init_field_from_points
    from lidargs_torch.ops import composite_kernel as ck
    from lidargs_torch.ops.rasterize import cull_sorted_rows, tile_inputs
    from lidargs_torch.train import Trainer, init_train_state, loss_and_grads

    mcfg = ModelConfig(**{**MODEL, "anchor_capacity": DYN_CAPACITY[name]})
    rcfg = RasterConfig(**RASTER)
    ocfg = OptConfig(**{**OPT, "update_interval": DYN_STEPS // 2})
    C = mcfg.color_channel
    bg = torch.zeros(2, device=dev)
    trainer = Trainer(mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, bg=bg)
    field = init_field_from_points(mcfg, md.init_points, voxel_size=DYN_VOXEL[name],
                                   generator=torch.Generator().manual_seed(0), device=dev)
    n_anchors = int(field.valid.sum())
    if n_anchors < DYN_MIN_ANCHORS[name]:
        fail(f"dynamic {name}: {n_anchors} anchors at voxel {DYN_VOXEL[name]}")
    state = init_train_state(field, mcfg)
    with torch.no_grad():
        before = [masked_metrics(trainer.render(state.params, state.valid, f), f)
                  for f in md.test_frames]

    # --- 32. the masked steps, a densify at half ---
    frames = md.train_frames
    losses, densify = [], None
    ck.launches = ck.bwd_launches = 0
    for it in range(1, DYN_STEPS + 1):
        state, m = trainer.step(state, frames[(it - 1) % len(frames)], it)
        losses.append(m.loss.total)
        if it == DYN_STEPS // 2:
            if not trainer.should_densify(int(state.valid.sum()), it):
                fail(f"dynamic {name}: the densify cadence does not fire at step {it}")
            n_before = int(state.valid.sum())
            state, dstats = trainer.densify(state, torch.Generator(device=dev).manual_seed(0),
                                            DYN_VOXEL[name])
            densify = {"n_anchors_before": n_before, "n_grown": int(dstats.n_grown),
                       "n_pruned": int(dstats.n_pruned),
                       "n_anchors_after": int(state.valid.sum())}
    launches = {"K1": ck.launches, "K2": ck.bwd_launches}
    if launches != {"K1": DYN_STEPS, "K2": DYN_STEPS}:
        fail(f"dynamic {name}: {DYN_STEPS} steps launched {launches}")
    losses = torch.stack(losses).cpu().numpy()
    w = max(1, DYN_STEPS // 10)
    if not (np.isfinite(losses).all() and losses[-w:].mean() < losses[:w].mean()):
        fail(f"dynamic {name}: the loss did not fall: {losses.tolist()}")
    frame = frames[0]
    held = [state]

    def one_step():
        held[0], _ = trainer.step(held[0], frame, DYN_STEPS + 1)

    step_ms = time_ms(one_step, DYN_TIMED, 2)
    prof = profile_render(one_step, frames=3)

    # --- one masked step's K1 and K2 against the plain versions ---
    grads = lambda: loss_and_grads(state, frame, bg, mcfg, rcfg, ocfg)[1:]
    _, _, err_k2, vs_plain, _ = kernel_vs_plain(ck, "composite_tiles", grads, 14 + C, K2_TOL,
                                                f"K2 (dynamic {name}, masked)")
    with torch.no_grad():
        splats = field_splats(state.params, state.valid, frame, mcfg, rcfg)[0]
        pkv, _ = cull_sorted_rows(splats, rcfg)
        inst, counts, pix, _ = tile_inputs(pkv, frame.beams, frame.W, rcfg, C)
        err_k1 = check_against(f"K1 vs plain (dynamic {name}, masked frame)",
                               ck.composite_tiles(inst, counts, pix, C, rcfg),
                               ck.composite_tiles_plain(inst, counts, pix, C, rcfg), C)

    # --- 33. the test frames, one K1 launch each ---
    ck.launches = 0
    with torch.no_grad():
        after = [masked_metrics(trainer.render(state.params, state.valid, f), f)
                 for f in md.test_frames]
    launches["K1_test"] = ck.launches
    if ck.launches != len(md.test_frames):
        fail(f"dynamic {name}: {len(md.test_frames)} test renders launched K1 {ck.launches}")
    for a in after:
        if not (np.isfinite(a["depth_l1"]) and a["pixels"] > 0):
            fail(f"dynamic {name}: test frame metrics {after}")
    out = {
        "anchors_init": n_anchors, "voxel": DYN_VOXEL[name], "capacity": DYN_CAPACITY[name],
        "steps": DYN_STEPS, "launches": launches, "densify": densify,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "loss_first_mean": float(losses[:w].mean()), "loss_last_mean": float(losses[-w:].mean()),
        "step_ms_median": float(np.median(step_ms)), "step_ms_min": min(step_ms),
        "step_ms_max": max(step_ms), "step_samples": len(step_ms),
        "profile": prof, "k1_err": err_k1, "k2_err": err_k2,
        "grad_vs_plain_worst": max(vs_plain.items(), key=lambda kv: kv[1]["rel_norm"]),
        "test_before": before, "test_after": after,
    }
    if isinstance(prof["device_ms_per_frame"], float):
        out["device_busy_share"] = prof["device_ms_per_frame"] / out["step_ms_median"]
    return out


def dynamic_phases(dev, street: Path, ctx: Path) -> dict:
    """Phases 31-33: the bundle, its sub-scenes, the exact 3-NN of the
    background's init points, each sub-scene trained and rendered. Returns
    the summary with the K1 and K2 launches of phases 32-33."""
    import numpy as np

    from lidargs_torch.data.waymo_dynamic import STATIC, read_dynamic_scene

    t_all = time.perf_counter()
    # --- 31. the bundle and its sub-scenes ---
    t0 = time.perf_counter()
    bundle = write_dynamic_bundle(street, ctx)
    bundle["write_s"] = time.perf_counter() - t0
    if min(bundle["vehicle_pixels_per_frame"]) == 0:
        fail(f"dynamic bundle: the vehicle leaves the view: {bundle}")
    t0 = time.perf_counter()
    scene, models = read_dynamic_scene(str(ctx), init_samples=DYN_INIT_SAMPLES, device=dev)
    read_s = time.perf_counter() - t0
    ids = [m.model_id for m in models]
    if ids != [STATIC, "vehicle_0"]:
        fail(f"dynamic sub-scenes {ids}")
    subscenes = {}
    for name, md in zip(("background", "vehicle"), models):
        px = [int(f.pixel_mask.sum()) for f in md.train_frames + md.test_frames]
        subscenes[name] = {"train_frames": len(md.train_frames),
                           "test_frames": len(md.test_frames),
                           "init_points": int(md.init_points.shape[0]),
                           "mask_pixels_per_frame": {"min": min(px), "max": max(px),
                                                     "mean": float(np.mean(px))}}
    print(f"# dynamic bundle: {json.dumps(bundle)}; read {read_s:.2f} s; "
          f"{json.dumps(subscenes)}", file=sys.stderr)
    knn = knn_oracle(dev, models[0].init_points.cpu().numpy(), direct=True)
    print(f"# dynamic: knn3_mean_sq_dist {knn}", file=sys.stderr)
    # --- 32-33. each sub-scene's masked steps and test frames ---
    trained = {}
    for name, md in zip(("background", "vehicle"), models):
        trained[name] = train_subscene(dev, name, md)
        print(f"# dynamic {name}: {json.dumps(trained[name])}", file=sys.stderr)
    launches = {"K1": sum(t["launches"]["K1"] + t["launches"]["K1_test"]
                          for t in trained.values()),
                "K2": sum(t["launches"]["K2"] for t in trained.values())}
    wall_s = time.perf_counter() - t_all
    print(f"# dynamic phases 31-33: {wall_s:.1f} s", file=sys.stderr)
    return {"bundle": bundle, "read_s": read_s, "subscenes": subscenes, "knn3_oracle": knn,
            "train": trained, "launches": launches, "wall_s": wall_s}


if __name__ == "__main__":
    main()
