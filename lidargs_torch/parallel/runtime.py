"""The multi-process runtime: how a process joins the fleet, which device
and backend it uses, and the per-step frame schedule every rank shares.

Counterpart of `lidargs_tpu/parallel/runtime.py`. The JAX package couples
N processes into one SPMD program with `jax.distributed.initialize`; the
port runs one process per device and couples them with
`torch.distributed.init_process_group` over `tcp://<coordinator>`, with
the rank and world size given (nothing tells a program of its cluster).

The backend follows one rule (`backend_for`): `gloo` on the CPU, `gloo`
when processes share a card (`num_processes > torch.cuda.device_count()`;
NCCL refuses two ranks on one device), and `nccl` when each process has a
card of its own. Rank r drives `cuda:{r % device_count}`. The backend and
device are logged; nothing retries with another backend after a failure.

Parameters are replicated by construction: every rank builds its state
from the same seed, nothing is broadcast, and `fingerprint` checks that the
ranks agree. Each rank loads and stacks only its own slice of a step's
frames (`local_indices`), so `shard_batch` is the identity.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .collectives import all_gather_rows, barrier
from .mesh import Mesh, make_mesh

log = logging.getLogger("lidargs_torch.parallel")

PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda", None: "cuda"}


@dataclass(frozen=True)
class RuntimeConfig:
    """How this process joins the fleet. One process (the default) starts
    no process group. `platform`: "cpu" for the CPU, "gpu" / "cuda" or None
    for the card. `local_device_count` has no counterpart (PyTorch has no
    virtual devices) and must stay None."""

    coordinator_address: Optional[str] = None   # "host:port" of process 0
    num_processes: int = 1
    process_id: int = 0
    platform: Optional[str] = None
    local_device_count: Optional[int] = None


def backend_for(device_type: str, num_processes: int, device_count: int) -> str:
    """The process group's backend: gloo on the CPU or when processes share
    a card, nccl when each process has a card of its own."""
    if device_type == "cpu" or num_processes > device_count:
        return "gloo"
    return "nccl"


class Runtime:
    """Handle on the initialized fleet. Every rank calls each method with
    the same arguments."""

    def __init__(self, cfg: RuntimeConfig, device: torch.device, backend: Optional[str]):
        self.cfg = cfg
        self.num_processes = cfg.num_processes
        self.process_id = cfg.process_id
        self.device = device
        self.backend = backend          # None in one process

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    def global_mesh(self, data: int = -1, tile: int = 1) -> Mesh:
        """The mesh over every rank; data=-1 takes all of them."""
        if data == -1:
            data = self.num_processes // tile
        return make_mesh(data, tile)

    def replicate_tree(self, tree):
        """This rank's copy of a replicated tree (tensors moved to its
        device). Every rank must pass the same values (the same seed);
        nothing is broadcast."""
        if isinstance(tree, torch.Tensor):
            return tree.to(self.device)
        if isinstance(tree, dict):
            return {k: self.replicate_tree(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            vals = [self.replicate_tree(v) for v in tree]
            return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
        return tree

    def shard_batch(self, local_tree):
        """This rank's frames are its share of the global batch as they
        are: the identity (the JAX package assembles a global array here)."""
        return local_tree

    def local_indices(self, indices: Sequence[int], mesh: Optional[Mesh] = None) -> List[int]:
        """This rank's contiguous slice of a step's global index list,
        computed identically on every rank: over the processes, or over
        `mesh`'s data axis (ranks on one data row share a slice)."""
        n, i = ((self.num_processes, self.process_id) if mesh is None
                else (mesh.data, mesh.data_index))
        if len(indices) % n != 0:
            raise ValueError(f"global batch {len(indices)} not divisible by {n} "
                             + ("hosts" if mesh is None else "ranks on the data axis"))
        per = len(indices) // n
        return list(indices[i * per:(i + 1) * per])

    def sync(self, name: str = "barrier") -> None:
        """A barrier over every rank, skipped in one process."""
        barrier()

    def fingerprint(self, tree) -> List[float]:
        """Every rank's sum of |x| over the tree's tensors (float64 on its
        device), in rank order: equal values say the ranks hold the same
        state."""
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for x in _tensors(tree):
            total += x.detach().to(torch.float64).abs().sum()
        return all_gather_rows(total.reshape(1)).tolist()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _tensors(v)


def init_runtime(cfg: RuntimeConfig) -> Runtime:
    """Pick this rank's device and backend, join the process group, and
    return the handle. Call it before any other CUDA use of the process. A
    second call in the same process (the CLI's --warmup restart) finds the
    group initialized and returns a handle on it."""
    if cfg.local_device_count is not None:
        raise ValueError(
            "local_device_count: PyTorch has no virtual devices; lidargs_torch drives one "
            "device per process, so launch one process per device")
    if cfg.platform not in PLATFORMS:
        raise ValueError(f"platform {cfg.platform!r}: expected one of 'cpu', 'gpu', 'cuda'")
    if not 0 <= cfg.process_id < cfg.num_processes:
        raise ValueError(f"process_id {cfg.process_id} outside 0..{cfg.num_processes - 1}")
    dev_type = PLATFORMS[cfg.platform]
    if dev_type == "cuda":
        resolve_device("cuda")                  # raises without a card
        count = torch.cuda.device_count()
        device = torch.device("cuda", cfg.process_id % count)
        torch.cuda.set_device(device)
    else:
        count, device = 0, torch.device("cpu")
    if cfg.num_processes == 1:
        return Runtime(cfg, device, None)
    if not cfg.coordinator_address:
        raise ValueError("multi-process runtime needs coordinator_address")
    backend = backend_for(dev_type, cfg.num_processes, count)
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (cfg.num_processes, cfg.process_id):
            raise RuntimeError(
                f"torch.distributed is initialized as rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, not {cfg.process_id} of {cfg.num_processes}")
        return Runtime(cfg, device, dist.get_backend())
    dist.init_process_group(backend, init_method=f"tcp://{cfg.coordinator_address}",
                            world_size=cfg.num_processes, rank=cfg.process_id,
                            timeout=timedelta(minutes=10))
    log.info("process %d of %d: backend %s, device %s", cfg.process_id, cfg.num_processes,
             backend, device)
    return Runtime(cfg, device, backend)


def shutdown_runtime() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def frame_schedule(seed: int, step: int, global_batch: int, n_frames: int) -> List[int]:
    """Deterministic per-step frame indices, identical on every rank (and
    to the JAX package's): a permutation of the frame list per epoch, seeded
    by (seed, epoch), consumed `global_batch` at a time."""
    start = step * global_batch
    first_epoch = start // n_frames
    last_epoch = (start + global_batch - 1) // n_frames
    perm: List[int] = []
    for epoch in range(first_epoch, last_epoch + 1):
        rng = np.random.default_rng((seed, epoch))
        perm.extend(rng.permutation(n_frames).tolist())
    lo = start - first_epoch * n_frames
    return perm[lo:lo + global_batch]
