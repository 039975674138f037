"""Every collective of the port: sums, maxima and row gathers over a
`torch.distributed` process group.

Each function is the identity when the group has one rank (or when
`torch.distributed` is not initialized), so one-process code runs them
unchanged. On the `gloo` backend a CUDA tensor goes through pinned host
memory, here and nowhere else: one copy to the host, the collective, one
copy back. On `nccl` the tensor stays on its card. A failing collective
raises; nothing retries it or carries on without it.

`stats` counts, since the last `reset_stats()`, the calls, the bytes each
rank contributes and host seconds in three parts: `copy_s`, the copies
through host memory (the copy to the host first waits for the work queued
on the tensor's card); `collective_s`, the collective itself (it waits for
the slowest rank); and `wait_s`, spent only when the module's `settle` is
True: a device synchronize and a barrier before each collective, so that
`copy_s` and `collective_s` hold the transfer alone. `chip_smoke.py`
reads them per training step with `settle` on.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

stats = {"calls": 0, "bytes": 0, "wait_s": 0.0, "copy_s": 0.0, "collective_s": 0.0}
settle = False      # synchronize the device and all ranks before each collective


def reset_stats() -> None:
    stats.update(calls=0, bytes=0, wait_s=0.0, copy_s=0.0, collective_s=0.0)


class _Clock:
    """Adds the host seconds since the last mark to one of `stats`' parts."""

    def __init__(self, x: torch.Tensor, group):
        stats["calls"] += 1
        stats["bytes"] += x.numel() * x.element_size()
        self.t = time.perf_counter()
        if settle:
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            dist.barrier(group=group)
            self.mark("wait_s")

    def mark(self, part: str) -> None:
        now = time.perf_counter()
        stats[part] += now - self.t
        self.t = now


def world(group=None) -> int:
    """The number of ranks in `group` (1 without torch.distributed)."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in `group` (0 without torch.distributed)."""
    return dist.get_rank(group) if world(group) > 1 else 0


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    if world(group) == 1:
        return x
    clock = _Clock(x, group)
    if _staged(x, group):
        h = _host(x)
        clock.mark("copy_s")
        dist.all_reduce(h, op=op, group=group)
        clock.mark("collective_s")
        x.copy_(h)
        clock.mark("copy_s")
    else:
        dist.all_reduce(x, op=op, group=group)
        clock.mark("collective_s")
    return x


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `x` over the ranks of `group`, in place; returns `x`."""
    return _all_reduce(x, dist.ReduceOp.SUM, group)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise maximum of `x` over the ranks of `group`, in place."""
    return _all_reduce(x, dist.ReduceOp.MAX, group)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[n, ...] on each rank -> [world * n, ...]: every rank's rows in rank
    order (every rank gives the same n)."""
    n = world(group)
    if n == 1:
        return x
    clock = _Clock(x, group)
    src = _host(x) if _staged(x, group) else x.contiguous()
    clock.mark("copy_s")
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    clock.mark("collective_s")
    out = torch.cat(parts).to(x.device)
    clock.mark("copy_s")
    return out


def reduce_scatter_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """[world * n, ...] on each rank -> [n, ...]: the sum over ranks of the
    rows this rank owns (rows [rank * n, (rank + 1) * n)), as an all-reduce
    and a slice on every backend."""
    n = world(group)
    if n == 1:
        return x
    rows = x.shape[0] // n
    r = rank(group)
    return all_reduce_sum(x.clone(), group)[r * rows:(r + 1) * rows]


def barrier(group=None) -> None:
    """Wait for every rank of `group` (nothing with one rank)."""
    if world(group) > 1:
        dist.barrier(group=group)
