"""Data-parallel training throughput, and the launcher of process fleets.

Counterpart of `lidargs_tpu/parallel/scaling.py` and of the fleet launcher
of `tools/scaling_fleet.py`. One PyTorch process drives one device, so a
mesh of N ranks is a fleet of N processes: `launch_fleet` starts N ranks of
a command with a free localhost port, and `measure_dp_scaling` runs
`measure_dp_rate` in fleets of 1, 2, ... processes. When processes share a
card (more ranks than cards), the record says so (`ranks_per_card` > 1):
such a rate proves the semantics across processes and is not a scaling
figure.

    python -m lidargs_torch.parallel.scaling --processes 1 2 [--platform cpu]

Every fleet of the port (the tests, `chip_smoke.py`, the CLI's) is started
by `launch_fleet`. The kernels' build is atomic (`utils/cuda_build.py`), so
ranks may share `build/`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..config import ModelConfig, OptConfig, RasterConfig
from ..lidar.beams import uniform_beam_inclinations
from ..lidar.frames import LidarFrame, stack_frames
from ..models.field import init_field_from_points
from ..train.trainer import init_train_state
from .mesh import Mesh
from .shard import make_dp_trainer

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 4000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else "(no log)"


def launch_fleet(cmd: List[str], nproc: int, log_dir, record=None, timeout: float = 600.0,
                 env: Optional[dict] = None):
    """Start `nproc` ranks of `cmd`, each with `--num_processes nproc
    --process_id r --coordinator 127.0.0.1:<free port>` appended and its
    output in `log_dir/rank<r>.log`; wait up to `timeout` seconds. When one
    rank exits non-zero, or the time runs out, kill the rest and raise with
    each rank's log tail. Returns the JSON the coordinator wrote to
    `record` (None without one)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    coord = f"127.0.0.1:{free_port()}"
    full_env = {**os.environ, **(env or {})}
    # every rank is on this host: gloo's sockets on the loopback device (the
    # host's name need not resolve to an address)
    full_env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    full_env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in full_env.get("PYTHONPATH", "").split(os.pathsep) if p])
    logs = [log_dir / f"rank{r}.log" for r in range(nproc)]
    procs = []
    deadline = time.monotonic() + timeout
    try:
        for r in range(nproc):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [*cmd, "--num_processes", str(nproc), "--process_id", str(r),
                     "--coordinator", coord],
                    stdout=f, stderr=subprocess.STDOUT, env=full_env))
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            if all(rc == 0 for rc in rcs) or any(rc not in (None, 0) for rc in rcs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        tails = "\n".join(f"--- rank {r} ({logs[r]}) ---\n{_tail(logs[r])}" for r in range(nproc))
        raise RuntimeError(f"fleet of {nproc} ranks of {cmd}: exit codes {rcs}"
                           + (" (timed out)" if time.monotonic() >= deadline else "")
                           + f"\n{tails}")
    if record is None:
        return None
    with open(record) as f:
        return json.load(f)


def config_from_json(template, d: dict):
    """A configuration dataclass from `dataclasses.asdict` output:
    `template` with `d`'s values, nested dataclasses and tuples rebuilt."""
    kw = {}
    for k, v in d.items():
        t = getattr(template, k)
        kw[k] = (config_from_json(t, v) if dataclasses.is_dataclass(t)
                 else tuple(v) if isinstance(t, tuple) else v)
    return dataclasses.replace(template, **kw)


def synthetic_scene(mcfg: ModelConfig, H: int, W: int, n_points: int, seed: int = 0,
                    voxel_size: float = 0.5, device="cuda"):
    """(AnchorField, LidarFrame): a random point shell around the sensor as
    the field's init cloud, and one frame at the origin with a random GT
    image, all drawn from `seed` as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, n_points)
    el = rng.uniform(np.radians(-18.0), np.radians(6.0), n_points)
    r = rng.uniform(4.0, 70.0, n_points)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], -1)
    beams = uniform_beam_inclinations(2.0, 22.0, H)
    gt = np.zeros((3, H, W), np.float32)
    gt[0] = (rng.uniform(size=(H, W)) > 0.2).astype(np.float32)
    gt[1] = rng.uniform(size=(H, W)).astype(np.float32) * gt[0]
    gt[2] = rng.uniform(5.0, 65.0, size=(H, W)).astype(np.float32) * gt[0]
    field = init_field_from_points(mcfg, pts, voxel_size=voxel_size,
                                   generator=torch.Generator().manual_seed(seed), device=device)
    frame = LidarFrame.from_lidar2world(np.eye(4), beams, gt, uid=0, device=device)
    return field, frame


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_dp_rate(mesh: Mesh, mcfg: ModelConfig, rcfg: RasterConfig, ocfg: OptConfig,
                    H: int = 64, W: int = 2650, n_points: int = 60_000, steps: int = 10,
                    warmup: int = 2, voxel_size: float = 0.5, runtime=None,
                    device="cuda") -> dict:
    """Training-step throughput on one mesh: every rank calls it with the
    same arguments and trains one frame a step, so a step takes mesh.data
    frames; the timed loop ends in a device synchronize and includes the
    gradient all-reduce. Returns {devices, hosts, ranks_per_card,
    ms_per_step, frames_per_s, rays_per_s}."""
    dev = runtime.device if runtime is not None else torch.device(device)
    field, frame = synthetic_scene(mcfg, H, W, n_points, voxel_size=voxel_size, device=dev)
    bg = torch.zeros((mcfg.color_channel,), dtype=torch.float32, device=dev)
    step = make_dp_trainer(mesh, mcfg, rcfg, ocfg, bg=bg)
    state = init_train_state(field, mcfg)
    frames = stack_frames([frame])
    for _ in range(warmup):
        state, _m = step(state, frames)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _m = step(state, frames)
    _sync(dev)
    dt = (time.perf_counter() - t0) / steps
    hosts = runtime.num_processes if runtime is not None else 1
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    fps = mesh.data / dt
    return {"devices": mesh.size, "hosts": hosts, "device": str(dev),
            "ranks_per_card": -(-hosts // cards) if cards else None,
            "ms_per_step": dt * 1e3, "frames_per_s": fps, "rays_per_s": fps * H * W}


def measure_dp_scaling(mcfg: ModelConfig, rcfg: RasterConfig, ocfg: OptConfig,
                       H: int = 64, W: int = 2650, n_points: int = 60_000,
                       process_counts: Optional[List[int]] = None, steps: int = 10,
                       warmup: int = 2, voxel_size: float = 0.5, platform: str = "cuda",
                       log_dir=None, timeout: float = 1200.0) -> List[dict]:
    """`measure_dp_rate` in a fleet of each of `process_counts` processes
    (default: 1, 2, 4, ... up to the cards there are), each record with its
    efficiency against linear scaling of the first."""
    if process_counts is None:
        n = torch.cuda.device_count() if platform != "cpu" else 2
        process_counts = [d for d in (1, 2, 4, 8) if d <= max(n, 1)]
    log_dir = Path(log_dir or REPO / "build" / "scaling")
    out, base = [], None
    for n in process_counts:
        rec_path = log_dir / f"fleet{n}.json"
        cfg = {"mcfg": dataclasses.asdict(mcfg), "rcfg": dataclasses.asdict(rcfg),
               "ocfg": dataclasses.asdict(ocfg), "H": H, "W": W,
               "n_points": n_points, "steps": steps, "warmup": warmup,
               "voxel_size": voxel_size, "platform": platform, "out": str(rec_path)}
        rec = launch_fleet([sys.executable, "-m", "lidargs_torch.parallel.scaling",
                            "--worker", json.dumps(cfg)], n,
                           log_dir / f"fleet{n}", record=rec_path, timeout=timeout)
        base = base if base is not None else rec["rays_per_s"] / process_counts[0]
        rec["efficiency"] = rec["rays_per_s"] / (base * n)
        out.append(rec)
    return out


def _worker(cfg: dict, rank_args) -> None:
    from .runtime import RuntimeConfig, init_runtime, shutdown_runtime

    rt = init_runtime(RuntimeConfig(coordinator_address=rank_args.coordinator,
                                    num_processes=rank_args.num_processes,
                                    process_id=rank_args.process_id,
                                    platform=cfg["platform"]))
    rec = measure_dp_rate(rt.global_mesh(), config_from_json(ModelConfig(), cfg["mcfg"]),
                          config_from_json(RasterConfig(), cfg["rcfg"]),
                          config_from_json(OptConfig(), cfg["ocfg"]),
                          H=cfg["H"], W=cfg["W"], n_points=cfg["n_points"], steps=cfg["steps"],
                          warmup=cfg["warmup"], voxel_size=cfg["voxel_size"], runtime=rt)
    rt.sync("scaling-done")
    if rt.is_coordinator:
        with open(cfg["out"], "w") as f:
            json.dump(rec, f)
    print(f"[p{rt.process_id}] {rec}", flush=True)
    shutdown_runtime()


def main(argv=None) -> None:
    p = argparse.ArgumentParser("lidargs_torch data-parallel scaling")
    p.add_argument("--worker", default=None, help="(a fleet rank) its JSON configuration")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--processes", type=int, nargs="+", default=None)
    p.add_argument("--platform", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--H", type=int, default=64)
    p.add_argument("--W", type=int, default=2650)
    p.add_argument("--n_points", type=int, default=60_000)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--json_out", default=None)
    args = p.parse_args(argv)
    if args.worker is not None:
        _worker(json.loads(args.worker), args)
        return
    recs = measure_dp_scaling(ModelConfig(), RasterConfig(), OptConfig(start_stat=10 ** 9),
                              H=args.H, W=args.W, n_points=args.n_points,
                              process_counts=args.processes, steps=args.steps,
                              platform=args.platform)
    for r in recs:
        shared = r["ranks_per_card"] is not None and r["ranks_per_card"] > 1
        print(json.dumps(r) + ("  [ranks share a card: not a scaling figure]" if shared else ""))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(recs, f, indent=1)


if __name__ == "__main__":
    main()
