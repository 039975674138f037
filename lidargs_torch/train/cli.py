"""Training CLI: read a LiDAR sequence, build the anchor field from its fused
point cloud, train, evaluate, save snapshots and checkpoints, and resume.

    python -m lidargs_torch.train.cli -s <data> --data_label waymo -m <out> \\
        --iterations 10000

Counterpart of `lidargs_tpu/train/cli.py` on one device (the card unless
`--device cpu`): the same flags and defaults, the same frame schedule
(Python's `random.Random(seed)`), and the same files (`cfg_args.json`,
`outputs.log`, `points3d.ply`, `point_cloud/iteration_<it>/`,
`chkpnt<it>.npz`, `results.json`, `per_view.json`, `test_renders/`,
`renders/`), which either package loads. The step runs eager on the card:
kernels K1 and K2 per beam step, K5 and K6 with `--surfel`, and their
window forms (K3/K4, K7/K8) with `--fused_gather`.

The offline ray-drop refiner trains on the `--dump_renders` output, and an
evaluation then applies it and adds LPIPS:

    python -m lidargs_torch.train.cli refine --renders <out>/renders --arch mlp|unet
    python -m lidargs_torch.train.cli -s <data> -m <out> --load_iteration N \\
        --raydrop_refiner <out>/renders/raydrop_refiner.npz --lpips_weights <lpips.npz>

Data-parallel training: `--data_parallel 1 --dp_batch B` trains B frames
a step in one process (`parallel/shard.py`); a fleet of N processes, one
device each, trains with `--num_processes N --process_id i --coordinator
host:port` (`parallel/runtime.py`), each rank on its slice of every step's
frames, with `--mp_platform cpu` on the CPU:

    python -m lidargs_torch.parallel.scaling ...     # or start each rank:
    python -m lidargs_torch.train.cli -s <data> -m <out> --num_processes 2 \
        --process_id 0 --coordinator 127.0.0.1:29500 --dp_batch 2

Only the coordinator (process 0) writes `cfg_args.json`, evaluations,
snapshots, checkpoints, dumps and traces; the other ranks log to
`outputs.p<i>.log`. `--mp_local_devices` (virtual devices) and
`--pallas_chunk` (a knob of the TPU kernels) raise.
"""
from __future__ import annotations

import argparse
import functools
import json
import logging
import math
import os
import random
import sys
import time

import numpy as np
import torch

from ..lidar.frames import stack_frames
from ..parallel.runtime import frame_schedule


def get_logger(model_path: str, suffix: str = "") -> logging.Logger:
    logger = logging.getLogger("lidargs_torch")
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    os.makedirs(model_path, exist_ok=True)
    fh = logging.FileHandler(os.path.join(model_path, f"outputs{suffix}.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


def _check_flags(args) -> None:
    """Raise for flags the port has no path for, and for a data-parallel
    layout it cannot run: the data axis spans every process, one device
    each."""
    if args.mp_local_devices is not None:
        raise ValueError("--mp_local_devices: PyTorch has no virtual devices; lidargs_torch "
                         "drives one device per process, so launch one process per device "
                         "(--num_processes)")
    n, dp = args.num_processes, args.data_parallel
    if dp > 1 and dp != n:
        raise ValueError(f"--data_parallel {dp}: lidargs_torch drives one device per process; "
                         f"launch {dp} processes (--num_processes {dp} --process_id i "
                         "--coordinator host:port)")
    if n > 1 and dp == 1:
        raise ValueError(f"--data_parallel 1 with --num_processes {n}: the data axis spans "
                         "every process")
    if not 0 <= args.process_id < n:
        raise ValueError(f"--process_id {args.process_id} outside 0..{n - 1}")
    if n > 1 and not args.coordinator:
        raise ValueError(f"--num_processes {n} needs --coordinator host:port")
    if args.dp_batch and n == 1 and dp != 1 and not args.mp_platform:
        raise ValueError(f"--dp_batch {args.dp_batch} trains a frame batch with "
                         "--data_parallel 1 or --num_processes N")
    if args.dp_batch % n:
        raise ValueError(f"--dp_batch {args.dp_batch} must be divisible by the data-axis "
                         f"size {n} and by {n} hosts")
    if args.pallas_chunk is not None:
        raise ValueError("--pallas_chunk is a knob of the TPU kernels; the CUDA kernels "
                         "of lidargs_torch have none")


def build_config(argv=None):
    from ..config import (
        DataConfig, ModelConfig, OptConfig, ParallelConfig, RasterConfig, TrainConfig, replace,
    )

    p = argparse.ArgumentParser("lidargs_torch trainer")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", default="output/run")
    p.add_argument("--data_label", default="waymo")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; raises without a card)")
    p.add_argument("--iterations", type=int, default=10_000)
    p.add_argument("--num_frames", type=int, default=50)
    p.add_argument("--voxel_size", type=float, default=0.0)
    p.add_argument("--anchor_capacity", type=int, default=2**17)
    p.add_argument("--max_visible", type=int, default=2**18)
    p.add_argument("--tile_capacity", type=int, default=None,
                   help="depth-sorted instances composited per tile "
                        "(default: 768 beam / 384 surfel)")
    p.add_argument("--tile_h", type=int, default=None,
                   help="pixel rows per tile (1/2/4/8; default 4 beam / 1 surfel)")
    p.add_argument("--max_tiles_per_gaussian", type=int, default=None,
                   help="per-gaussian touched-tile cap (default 8 beam / the "
                        "RasterConfig default surfel)")
    p.add_argument("--pallas_chunk", type=int, default=None,
                   help="a TPU-kernel knob; refused here")
    p.add_argument("--instance_capacity", type=int, default=None,
                   help="rank-search instance emission budget (0 = exact dense)")
    p.add_argument("--remat_projection", type=int, default=None, choices=(0, 1),
                   help="recompute the projection in the backward instead of the "
                        "hand VJP (default 0)")
    p.add_argument("--fused_gather", action="store_true",
                   help="per-tile windows of one sorted buffer (kernels K3/K4, "
                        "K7/K8) instead of the [T,K,F] gather")
    p.add_argument("--raydrop_lambda", type=float, default=None)
    p.add_argument("--raydrop_refiner", default=None,
                   help="eval-only: refine each render's ray drop with this npz "
                        "(written by `cli refine`, either package)")
    p.add_argument("--lpips_weights", default=None,
                   help="VGG-LPIPS weights npz (tools/convert_lpips_weights.py layout): "
                        "adds intensity_lpips to every evaluation")
    p.add_argument("--surfel", action="store_true",
                   help="train/render through the 2DGS surfel rasterizer with the "
                        "distortion and normal-consistency regularizers")
    p.add_argument("--depth_min", type=float, default=None,
                   help="depth-metric lower clamp (default: 5 for waymo, 1 otherwise)")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="data-axis size: 0 = every process (one device each), 1 with "
                        "--dp_batch = a frame batch in one process")
    p.add_argument("--dp_batch", type=int, default=0,
                   help="global frames per step (default: the data-axis size)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (with --num_processes > 1)")
    p.add_argument("--num_processes", type=int, default=1,
                   help="processes of the fleet, one device each")
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--mp_platform", default=None, choices=("cpu", "gpu", "cuda"),
                   help="the fleet's devices (default: the card, or --device cpu)")
    p.add_argument("--mp_local_devices", type=int, default=None,
                   help="virtual devices per process: refused (PyTorch has none)")
    p.add_argument("--update_from", type=int, default=None,
                   help="densify schedule start (OptConfig default 500)")
    p.add_argument("--update_until", type=int, default=None,
                   help="densify schedule end (OptConfig default 7000)")
    p.add_argument("--update_interval", type=int, default=None,
                   help="densify cadence (OptConfig default 100)")
    p.add_argument("--start_stat", type=int, default=None,
                   help="densification-statistics start iteration")
    p.add_argument("--test_iterations", type=int, nargs="*", default=None)
    p.add_argument("--save_iterations", type=int, nargs="*", default=None)
    p.add_argument("--checkpoint_iterations", type=int, nargs="*", default=[])
    p.add_argument("--start_checkpoint", type=int, default=None)
    p.add_argument("--eval_chamfer", action="store_true")
    p.add_argument("--dump_renders", action="store_true",
                   help="save per-frame renders as npy (raydrop refiner input)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--config", default=None,
                   help="load argument defaults from a saved cfg_args.json")
    p.add_argument("--init_ply", default=None,
                   help="initialize anchors from this PLY instead of the fused frames "
                        "(used by --warmup phase 2)")
    p.add_argument("--warmup", action="store_true",
                   help="two-phase restart: train, then re-train from the saved PLY")
    p.add_argument("--load_iteration", type=int, default=None,
                   help="eval-only: load a saved snapshot, run the metric sweep + FPS, "
                        "save test renders as PNGs")
    p.add_argument("--tensorboard", action="store_true",
                   help="log scalars/images to <model_path>/tb")
    p.add_argument("--wandb", default=None, metavar="PROJECT",
                   help="log train/eval scalars to Weights & Biases; inactive when "
                        "the package is unavailable")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace of N steps into <model_path>/trace")
    args, _ = p.parse_known_args(argv)
    if args.config:
        with open(args.config) as f:
            saved = json.load(f)
        p.set_defaults(**{k: v for k, v in saved.items()
                          if k in {a.dest for a in p._actions}})
    args = p.parse_args(argv)
    _check_flags(args)

    # kitti's ray-drop weight and depth clamp differ from waymo's
    rd_lambda = args.raydrop_lambda
    if rd_lambda is None:
        rd_lambda = 10.0 if args.data_label == "waymo" else 1.0
    depth_min = args.depth_min
    if depth_min is None:
        depth_min = 5.0 if args.data_label == "waymo" else 1.0
    eff_cap = (args.tile_capacity if args.tile_capacity is not None
               else (384 if args.surfel else 768))
    eff_tile_h = args.tile_h if args.tile_h is not None else (1 if args.surfel else 4)
    remat_proj = bool(args.remat_projection) if args.remat_projection is not None else False

    cfg = TrainConfig(
        model=ModelConfig(voxel_size=args.voxel_size, anchor_capacity=args.anchor_capacity),
        opt=replace(OptConfig(), iterations=args.iterations,
                    raydrop_lambda=rd_lambda, depth_min=depth_min,
                    **{k: v for k, v in (
                        ("update_from", args.update_from),
                        ("update_until", args.update_until),
                        ("update_interval", args.update_interval),
                        ("start_stat", args.start_stat),
                    ) if v is not None}),
        raster=replace(
            RasterConfig(), max_visible=args.max_visible,
            **{k: v for k, v in (
                ("tile_h", eff_tile_h),
                ("tile_capacity", eff_cap),
                ("max_tiles_per_gaussian", args.max_tiles_per_gaussian
                 if args.max_tiles_per_gaussian is not None
                 else (None if args.surfel else 8)),
                ("instance_capacity", args.instance_capacity),
                ("remat_projection", remat_proj),
            ) if v is not None},
            **({"fused_gather": True} if args.fused_gather else {}),
        ),
        data=DataConfig(source_path=args.source_path, data_label=args.data_label,
                        num_frames=args.num_frames),
        parallel=ParallelConfig(data_parallel=max(args.data_parallel, args.num_processes)),
        model_path=args.model_path,
        seed=args.seed,
        test_iterations=tuple(args.test_iterations if args.test_iterations is not None
                              else range(2000, args.iterations + 1, 1000)),
        save_iterations=tuple(args.save_iterations if args.save_iterations is not None
                              else (args.iterations,)),
        checkpoint_iterations=tuple(args.checkpoint_iterations),
        log_every=args.log_every,
    )
    return cfg, args


def runtime_config(args):
    """The RuntimeConfig of a data-parallel run (`--num_processes` > 1,
    `--mp_platform`, or `--data_parallel 1 --dp_batch B`), else None. The
    platform is `--mp_platform`, else `--device`'s type."""
    from ..parallel.runtime import RuntimeConfig

    if not (args.num_processes > 1 or args.mp_platform or args.dp_batch):
        return None
    platform = args.mp_platform or ("cpu" if torch.device(args.device).type == "cpu"
                                    else "cuda")
    return RuntimeConfig(coordinator_address=args.coordinator,
                         num_processes=args.num_processes, process_id=args.process_id,
                         platform=platform)


def _frame_rays(fr) -> torch.Tensor:
    """[H*W, 3] unit ray directions of a frame's pixels, row by row."""
    from ..ops.composite import pixel_rays

    rows = torch.arange(fr.H, device=fr.device).repeat_interleave(fr.W)
    cols = torch.arange(fr.W, device=fr.device).repeat(fr.H)
    return pixel_rays(rows, cols, fr.beams, fr.W)


def _refiner(path: str, scene, depth_scale: float, dev):
    """`refine(color, depth)` of the refiner saved at `path`: the UNet, or
    the MLP on train frame 0's ray directions."""
    from ..models.raydrop import UNet, load_refiner, refine_color

    model = load_refiner(path, dev)
    dirs = None
    if not isinstance(model, UNet):
        fr0 = scene.data.train_frames[0]
        dirs = _frame_rays(fr0).reshape(fr0.H, fr0.W, 3)
    return functools.partial(refine_color, model, depth_scale=depth_scale, ray_dirs_hw3=dirs)


def run_eval(scene, state, trainer, cfg, logger, compute_chamfer=False, tb=None, step=0,
             refiner_path=None, lpips_weights=None):
    """The metric sweep over the test and train frames (`train/evaluate.py`
    `run_eval`), writing `results.json` and `per_view.json` under the model
    path; with an active TensorBoard logger, the first four test frames'
    depth, intensity and GT images too. With `refiner_path`, each render's
    ray drop is refined first (depth scaled by the far plane); with
    `lpips_weights`, `intensity_lpips` joins the metrics."""
    from .evaluate import run_eval as eval_splits

    dev = state.valid.device
    refine = (_refiner(refiner_path, scene, trainer.ocfg.depth_max, dev)
              if refiner_path else None)
    lpips_fn = None
    if lpips_weights:
        from .lpips import load_lpips_params, lpips_net, lpips_single

        lpips_fn = functools.partial(lpips_single, lpips_net(load_lpips_params(lpips_weights),
                                                             dev))
    t0 = time.perf_counter()
    results = eval_splits(
        state.params, state.valid,
        {"test": scene.data.test_frames, "train": scene.data.train_frames},
        trainer.mcfg, trainer.rcfg, trainer.bg, cfg.model_path,
        depth_min=trainer.ocfg.depth_min, depth_max=trainer.ocfg.depth_max,
        device=dev, variant=trainer.variant, compute_chamfer=compute_chamfer,
        refine=refine, lpips_fn=lpips_fn)
    n = len(scene.data.test_frames) + len(scene.data.train_frames)
    logger.info(f"[eval] {n} frames in {time.perf_counter() - t0:.2f} s")
    if tb is not None and tb.active:
        gray = lambda x: np.repeat(np.asarray(x)[..., None], 3, -1)
        with torch.no_grad():
            for idx, fr in enumerate(scene.data.test_frames[:4]):
                out = trainer.render(state.params, state.valid, fr)
                tb.depth_image(f"eval/test_{idx}/depth", out.depth.cpu().numpy(), step,
                               vmax=trainer.ocfg.depth_max)
                tb.image(f"eval/test_{idx}/render",
                         gray(out.color[0].clamp(0, 1).cpu().numpy()), step)
                tb.image(f"eval/test_{idx}/gt",
                         gray((fr.gt_image[1] * fr.gt_image[0]).cpu().numpy()), step)
    return results


def measure_fps(scene, state, trainer, warmup: int = 5) -> float:
    """Per-frame wall clock of the render over every train and test frame,
    each ending in a device synchronize; the mean of 1/t after `warmup`
    frames (`train/evaluate.py` `measure_fps`, which logs it)."""
    from .evaluate import measure_fps as fps_of

    with torch.no_grad():
        return fps_of(state.params, state.valid,
                      scene.data.train_frames + scene.data.test_frames,
                      trainer.mcfg, trainer.rcfg, trainer.bg, warmup=warmup,
                      device=state.valid.device, variant=trainer.variant).fps


def main(argv=None):
    cfg, args = build_config(argv)

    # a data-parallel run: join the fleet before any other CUDA use
    rt = None
    rt_cfg = runtime_config(args)
    if rt_cfg is not None:
        from ..parallel.runtime import init_runtime

        rt = init_runtime(rt_cfg)
    is_coord = rt is None or rt.is_coordinator
    logger = get_logger(cfg.model_path, suffix="" if is_coord else f".p{args.process_id}")
    if is_coord:
        with open(os.path.join(cfg.model_path, "cfg_args.json"), "w") as f:
            json.dump(vars(args), f, indent=2, default=str)

    from ..data.scene import Scene
    from ..utils.device import resolve_device
    from .trainer import Trainer, init_train_state

    dev = rt.device if rt is not None else resolve_device(args.device)
    if rt is not None:
        logger.info(f"process {rt.process_id} of {rt.num_processes}: backend "
                    f"{rt.backend or 'none (one process)'}, device {dev}")
    scene = Scene.create(cfg, load_iteration=args.load_iteration, init_ply=args.init_ply,
                         device=dev, write_init=is_coord)
    logger.info(
        f"scene: {len(scene.data.train_frames)} train / "
        f"{len(scene.data.test_frames)} test frames, "
        f"{int(scene.field.valid.sum())} anchors, voxel {scene.field.voxel_size:.4f}"
    )

    bg = torch.zeros((cfg.model.color_channel,), dtype=torch.float32, device=dev)
    variant = "surfel" if args.surfel else "beam"
    mesh = dp_batch = None
    if rt is not None:
        from ..parallel.shard import DPTrainer

        mesh = rt.global_mesh(data=-1)
        dp_batch = args.dp_batch or mesh.data
        trainer = DPTrainer(variant=variant, mcfg=cfg.model, ocfg=cfg.opt, rcfg=cfg.raster,
                            bg=bg, mesh=mesh)
        logger.info(f"data-parallel: {mesh.data}-rank mesh across {rt.num_processes} "
                    f"processes, {dp_batch} frames/step")
    else:
        trainer = Trainer(variant=variant, mcfg=cfg.model, ocfg=cfg.opt, rcfg=cfg.raster,
                          bg=bg)
    state = init_train_state(scene.field, cfg.model)
    if rt is not None:
        state = rt.replicate_tree(state)
        prints = rt.fingerprint(state)
        if len(set(prints)) != 1:
            raise RuntimeError(f"the ranks built different states: fingerprints {prints}")

    if args.load_iteration is not None:
        # eval-only: metric sweep + FPS + saved PNG renders, by the coordinator
        if is_coord:
            run_eval(scene, state, trainer, cfg, logger, compute_chamfer=args.eval_chamfer,
                     refiner_path=args.raydrop_refiner, lpips_weights=args.lpips_weights)
            measure_fps(scene, state, trainer)
            render_sets(scene, state, trainer, cfg, logger)
            if args.dump_renders:
                dump_renders(scene, state, trainer, cfg, logger)
        if rt is not None:
            rt.sync("eval-only")
        return state
    first_iter = 0
    if args.start_checkpoint is not None:
        state = scene.load_train_state(args.start_checkpoint, like=state)
        first_iter = args.start_checkpoint
        logger.info(f"resumed from iteration {first_iter}")

    from ..utils.profiling import StepTimer, TensorBoardLogger, WandbLogger, trace

    tb = TensorBoardLogger(os.path.join(cfg.model_path, "tb")
                           if args.tensorboard and is_coord else None)
    wb = WandbLogger(args.wandb if is_coord else None,
                     run_name=os.path.basename(cfg.model_path), config=vars(args))
    timer = StepTimer().start()
    profile_ctx = None

    rng = random.Random(cfg.seed)
    frame_stack = None
    ema = None
    densify_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    t_start = time.time()
    best_test_psnr, best_test_it = float("-inf"), 0
    for it in range(first_iter + 1, cfg.opt.iterations + 1):
        if args.profile_steps and it == first_iter + 2 and is_coord:   # after the first step
            profile_ctx = trace(os.path.join(cfg.model_path, "trace"))
            profile_ctx.__enter__()
        if mesh is not None:
            # the step's global batch, the same on every rank; each rank
            # stacks only its own slice
            idx = frame_schedule(cfg.seed, it - 1, dp_batch, len(scene.data.train_frames))
            frame = rt.shard_batch(stack_frames([scene.data.train_frames[i]
                                                 for i in rt.local_indices(idx, mesh)]))
        else:
            if not frame_stack:
                frame_stack = list(range(len(scene.data.train_frames)))
            frame = scene.data.train_frames[frame_stack.pop(rng.randint(0, len(frame_stack) - 1))]
        state, metrics = trainer.step(state, frame, it)
        if profile_ctx is not None and it >= first_iter + 1 + args.profile_steps:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            profile_ctx.__exit__(None, None, None)
            profile_ctx = None
            logger.info(f"profiler trace written to {cfg.model_path}/trace")

        if it % cfg.log_every == 0:
            loss = float(metrics.loss.total)                # the host reads the device here
            if not math.isfinite(loss) and is_coord:
                from ..utils.debug import snapshot_if_nonfinite

                snapshot_if_nonfinite(loss, cfg.model_path, it, state.params, state.valid,
                                      frame, logger)
            dt_ms = timer.tick()
            ema = loss if ema is None else 0.4 * loss + 0.6 * ema
            logger.info(
                f"iter {it}: loss={ema:.5f} anchors={int(metrics.n_anchors)} "
                f"visible={int(metrics.n_visible)} "
                f"overflow={int(metrics.n_overflow)} "
                f"({(time.time() - t_start) / (it - first_iter) * 1e3:.0f} ms/it avg)"
            )
            if tb.active:
                lt = metrics.loss
                tb.scalars({
                    "total_loss": lt.total, "depth_l1": lt.depth,
                    "intensity": lt.intensity, "raydrop": lt.raydrop,
                    "l1_loss": lt.l1_intensity, "ssim": lt.ssim_intensity,
                }, it, prefix="train_loss/")
                tb.scalar("iter_time", dt_ms / cfg.log_every, it)
                tb.scalar("anchors", int(metrics.n_anchors), it)
            if wb.active:
                wb.log({"total_loss": loss, "anchors": int(metrics.n_anchors)},
                       step=it, prefix="train/")
        # should_densify needs the cadence first: read the anchor count (a
        # device sync) only on a densify iteration
        if (it % cfg.opt.update_interval == 0
                and trainer.should_densify(int(metrics.n_anchors), it)):
            state, dstats = trainer.densify(state, densify_gen, scene.field.voxel_size)
            logger.info(f"iter {it}: densify +{int(dstats.n_grown)} "
                        f"-{int(dstats.n_pruned)} anchors")
        elif trainer.should_maintain(it):
            state = trainer.maintain(state)

        # evaluations and files: the coordinator's, the others wait for it
        if it in cfg.test_iterations:
            if is_coord:
                res = run_eval(scene, state, trainer, cfg, logger,
                               compute_chamfer=args.eval_chamfer, tb=tb, step=it,
                               lpips_weights=args.lpips_weights)
                if wb.active:
                    wb.log(res["test"], step=it, prefix="test/")
                # keep the best test-PSNR snapshot beside the fixed saves
                p = (res.get("test") or {}).get("intensity_psnr")
                if p is not None and p > best_test_psnr:
                    best_test_psnr, best_test_it = float(p), it
                    path = scene.save(state.params, state.valid, "best")
                    logger.info(f"new best test psnr {p:.3f} at iter {it} -> {path}")
            if rt is not None:
                rt.sync("eval")
        if it in cfg.save_iterations:
            if is_coord:
                path = scene.save(state.params, state.valid, it)
                logger.info(f"saved snapshot to {path}")
            if rt is not None:
                rt.sync("save")
        if it in cfg.checkpoint_iterations:
            if is_coord:
                path = scene.save_train_state(state, it)
                logger.info(f"saved training checkpoint to {path}")
            if rt is not None:
                rt.sync("checkpoint")

    if profile_ctx is not None:
        profile_ctx.__exit__(None, None, None)
    if rt is not None:
        rt.sync("end-of-training")
    if is_coord:
        res = run_eval(scene, state, trainer, cfg, logger, compute_chamfer=args.eval_chamfer,
                       lpips_weights=args.lpips_weights)
        if wb.active:
            wb.log(res["test"], step=cfg.opt.iterations, prefix="test/")
        final_p = (res.get("test") or {}).get("intensity_psnr")
        if best_test_it and final_p is not None:
            logger.info(f"best test psnr {best_test_psnr:.3f} @ iter {best_test_it} "
                        f"(saved at point_cloud/iteration_best) vs final "
                        f"{final_p:.3f} @ {cfg.opt.iterations}")
        measure_fps(scene, state, trainer)
        if args.dump_renders:
            dump_renders(scene, state, trainer, cfg, logger)
    if rt is not None:
        rt.sync("end")
    tb.close()
    wb.finish()
    if args.warmup and args.init_ply is None:
        # two-phase restart: re-train with the saved PLY as the init cloud
        # instead of the raw back-projected frames. The restart's --init_ply
        # marks it as the second phase, also when --warmup comes from a
        # --config file (the JAX package restarts such a run forever).
        logger.info("warmup finished — rebooting from the saved point cloud")
        argv2 = [a for a in (argv if argv is not None else sys.argv[1:]) if a != "--warmup"]
        ply = os.path.join(cfg.model_path, "point_cloud",
                           f"iteration_{cfg.opt.iterations}", "point_cloud.ply")
        return main(argv2 + ["--init_ply", ply])
    return state


def render_sets(scene, state, trainer, cfg, logger):
    """Save the test renders as PNGs: intensity and turbo depth under the
    rendered ray-drop mask, and the GT intensity, per frame."""
    from ..utils.visualize import depth_to_rgb, intensity_to_rgb, save_image

    out_dir = os.path.join(cfg.model_path, "test_renders")
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        for i, fr in enumerate(scene.data.test_frames):
            out = trainer.render(state.params, state.valid, fr)
            inten = out.color[0].cpu().numpy()
            drop = (out.color[1] > 0.5).to(torch.float32).cpu().numpy()
            save_image(os.path.join(out_dir, f"{i:03d}_intensity.png"),
                       intensity_to_rgb(inten * drop))
            save_image(os.path.join(out_dir, f"{i:03d}_depth.png"),
                       depth_to_rgb(out.depth.cpu().numpy() * drop))
            save_image(os.path.join(out_dir, f"{i:03d}_gt_intensity.png"),
                       intensity_to_rgb((fr.gt_image[1] * fr.gt_image[0]).cpu().numpy()))
    logger.info(f"saved test renders to {out_dir}")


def dump_renders(scene, state, trainer, cfg, logger):
    """Per-frame [intensity, raydrop, depth, gt raydrop, gt intensity, gt
    depth] npy dumps and the shared per-pixel ray directions `dir.npy`: the
    training input of the offline ray-drop refiner."""
    out_dir = os.path.join(cfg.model_path, "renders")
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "dir.npy"),
            _frame_rays(scene.data.train_frames[0]).cpu().numpy())
    with torch.no_grad():
        for name, frames in (("train", scene.data.train_frames),
                             ("test", scene.data.test_frames)):
            for i, fr in enumerate(frames):
                out = trainer.render(state.params, state.valid, fr)
                np.save(os.path.join(out_dir, f"{name}_{i:03d}.npy"),
                        torch.stack([out.color[0], out.color[1], out.depth, fr.gt_image[0],
                                     fr.gt_image[1], fr.gt_image[2]]).float().cpu().numpy())
    logger.info(f"dumped renders to {out_dir}")


def read_dumps(renders: str, depth_scale: float = 80.0) -> dict:
    """The `train_*.npy` dumps under `renders` as [N, H, W] float32 stacks:
    `intensity`, `raydrop`, `depth` (divided by `depth_scale`) and `gt` (the
    GT ray-drop mask)."""
    import glob

    files = sorted(glob.glob(os.path.join(renders, "train_*.npy")))
    if not files:
        raise FileNotFoundError(f"no train_*.npy under {renders} (written by --dump_renders)")
    d = np.stack([np.load(f) for f in files])          # [N, 6, H, W]
    return {"intensity": d[:, 0], "raydrop": d[:, 1], "depth": d[:, 2] / depth_scale,
            "gt": d[:, 3]}


def refine_main(argv=None):
    """Train the offline ray-drop refiner on the renders `--dump_renders`
    wrote, and save it in the npz layout of either package:

        python -m lidargs_torch.train.cli refine --renders <model_path>/renders

    `--arch mlp` is the frequency-encoding MLP on each ray, `--arch unet`
    LiDAR4D's attention UNet on the [raydrop, intensity, depth] image. The
    frames go to the device once; the weights start from torch seed 0.
    Returns (model, loss history)."""
    from ..models.raydrop import (
        init_raydrop_mlp, init_unet, save_refiner, train_raydrop_refiner, train_unet_refiner,
    )
    from ..utils.device import resolve_device

    p = argparse.ArgumentParser("lidargs_torch raydrop refiner")
    p.add_argument("--renders", required=True, help="directory written by --dump_renders")
    p.add_argument("--arch", choices=("mlp", "unet"), default="mlp",
                   help="mlp = the reference's frequency-encoding MLP; unet = LiDAR4D's "
                        "attention UNet on the full [raydrop, intensity, depth] image")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--out", default=None)
    p.add_argument("--depth_scale", type=float, default=80.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; raises without a card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    d = read_dumps(args.renders, args.depth_scale)
    gen = torch.Generator().manual_seed(0)
    if args.arch == "unet":
        model, hist = train_unet_refiner(
            init_unet(gen, in_channels=3, device=dev), d["raydrop"], d["intensity"],
            d["depth"], d["gt"], epochs=args.epochs, lr=args.lr, log_every=5)
    else:
        dirs = np.load(os.path.join(args.renders, "dir.npy")).reshape(-1, 3)
        flat = lambda x: x.reshape(x.shape[0], -1)
        model, hist = train_raydrop_refiner(
            init_raydrop_mlp(gen, device=dev), dirs, flat(d["intensity"]), flat(d["depth"]),
            flat(d["gt"]), epochs=args.epochs, lr=args.lr, log_every=5)
    out = args.out or os.path.join(args.renders, "raydrop_refiner.npz")
    save_refiner(out, model)
    print(f"{args.arch} refiner saved to {out}; final loss {hist[-1]:.6f}")
    return model, hist


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "refine":
        refine_main(sys.argv[2:])
    else:
        from ..parallel.runtime import shutdown_runtime

        try:
            main()
        finally:
            shutdown_runtime()
