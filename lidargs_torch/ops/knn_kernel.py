"""Nearest-neighbour kernels N1-N3 (`csrc/knn.cu`) and their launch wrappers.

  N1 `chamfer_dir`        the chamfer's one direction, the counterpart of
                          `_chamfer_dir` in `lidargs_tpu/ops/knn.py` (jitted);
  N2 `knn_sqdist`         the kk smallest Gram-form squared distances, the
                          counterpart of `_chunk_knn_sqdist` there (jitted);
  N3 `knn3_mean_sq_dist`  the exact 3-NN by direct differences, the
                          counterpart of the native `knn3_mean_sq_dist`
                          (`lidargs_tpu/native/lidargs_native.cpp`).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises before the launch, computes the norms the kernel
reads exactly as the plain version in `ops/knn.py` does, allocates the
output with `torch.empty`, launches on PyTorch's current stream (no
synchronization), raises on the launch's `cudaError_t` (a refused cluster
launch too: nothing runs in its place). `ops/knn.py`'s public functions
call them for a CUDA tensor and run the plain versions for a CPU tensor.
The library is built with nvcc at the first launch (`utils/cuda_build.py`).

All three take the point set packed (`pack_points`: (-2 p, |p|^2) rows for
N1 and N2, (p, 0) rows for N3) and a launch plan (`launch_plan`): R query
rows a thread, clusters of S blocks over the same rows, each block
sweeping one of S slices of the packed rows, and the number of row
blocks. Both are plain functions of the shapes, the card's SM count and
the blocks an SM holds (`card_plan_inputs` asks the card once), so the
CPU tests reach them.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..utils import cuda_build

MAX_K = 8                 # the most smallest values N2 keeps a row (registers)
THREADS = 128             # threads a block of N1-N3 (csrc/knn.cu kThreads)
GROUP = 8                 # packed rows a thread takes at once; a slice holds whole groups
STAGE_ROWS = 256          # packed rows a shared-memory stage (csrc/knn.cu kStageRows)
MAX_CLUSTER = 8           # blocks a cluster of N1: the portable cluster size
TOPK_MAX_CLUSTER = 2      # of N2 and N3: each slice warms its k-lists up from +inf


def _on_card(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def check_points(**rows: torch.Tensor) -> None:
    """Raise unless each of `rows` is a contiguous float32 [N, 3] tensor,
    all on one device."""
    devs = {x.device for x in rows.values()}
    if len(devs) > 1:
        raise ValueError(f"inputs on different devices: {sorted(map(str, devs))}")
    for name, x in rows.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} shape {tuple(x.shape)} != (N, 3)")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.shape[0] >= 2 ** 31:
            raise ValueError(f"{name}: {x.shape[0]} rows exceed the kernels' int32 counts")


def check_masks(rows: torch.Tensor, mask: torch.Tensor, name: str) -> None:
    """Raise unless `mask` is a contiguous bool [N] tensor on `rows`'s
    device, N its row count."""
    if mask.device != rows.device:
        raise ValueError(f"{name} on {mask.device}, its rows on {rows.device}")
    if mask.dtype != torch.bool:
        raise TypeError(f"{name} must be bool, got {mask.dtype}")
    if tuple(mask.shape) != (rows.shape[0],):
        raise ValueError(f"{name} shape {tuple(mask.shape)} != ({rows.shape[0]},)")
    if not mask.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_k(kk: int, n_points: int) -> None:
    """Raise unless 1 <= kk <= MAX_K (N2 keeps its values in registers) and
    the set has kk points (as `torch.topk` and JAX's `top_k` require)."""
    if not 1 <= kk <= MAX_K:
        raise ValueError(f"k={kk} outside 1..{MAX_K}: the knn kernel keeps at most "
                         f"{MAX_K} values a row")
    if kk > n_points:
        raise ValueError(f"k={kk} exceeds the {n_points} points of the set")


def rows_per_thread(kk: int | None = None, direct: bool = False) -> int:
    """R, the query rows a thread of N1 (`kk` None), N2 or N3 (`direct`)
    keeps in registers: 8, and 4 for N2 and N3, whose k-lists take the
    registers (the fastest timed on the card, `utils/kernel_ab.py`: N1 of
    4 and 8, N2 of 4 and 8, N3 of 2, 4 and 8). The kernel is built for
    these alone."""
    return 4 if direct or kk is not None else 8


@dataclass(frozen=True)
class LaunchPlan:
    """How N1-N3 cover `n_queries` x `n_points`: `row_blocks` clusters of
    `cluster` blocks, each cluster `THREADS * rows_per_thread` adjacent query
    rows, block rank s of a cluster sweeping packed rows [s * slice_rows,
    (s + 1) * slice_rows)."""
    rows_per_thread: int
    cluster: int
    row_blocks: int
    slice_rows: int

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.cluster

    @property
    def packed_rows(self) -> int:
        return self.cluster * self.slice_rows


def launch_plan(n_queries: int, n_points: int, n_sm: int, blocks_per_sm: int,
                kk: int | None = None, direct: bool = False) -> LaunchPlan:
    """The launch plan of N1 (`kk` None), N2 or N3 (`direct`) on `n_queries`
    > 0 rows against `n_points` points on a card of `n_sm` SMs, each holding
    `blocks_per_sm` of the kernel's blocks at once. R from
    `rows_per_thread`; the cluster size S (1..MAX_CLUSTER, N2 and N3
    ..TOPK_MAX_CLUSTER, at most one slice a group of points) whose blocks
    fill the card's resident blocks in the fullest waves, blocks /
    (resident * ceil(blocks / resident)), the smaller S on a tie; slices of
    whole groups, the last one padded. On the card N1 ran fastest in one
    nearly full wave of resident blocks (PERF.md)."""
    if n_queries <= 0 or n_points < 0 or n_sm <= 0 or blocks_per_sm <= 0:
        raise ValueError(f"no launch plan for {n_queries} queries, {n_points} points, "
                         f"{n_sm} SMs of {blocks_per_sm} blocks")
    r = rows_per_thread(kk, direct)
    row_blocks = -(-n_queries // (THREADS * r))
    groups = -(-n_points // GROUP)
    resident = n_sm * blocks_per_sm

    def fill(s):                          # the share of the waves' resident blocks used
        blocks = row_blocks * s
        return blocks / (resident * -(-blocks // resident))

    top = MAX_CLUSTER if kk is None and not direct else TOPK_MAX_CLUSTER
    cluster = max(range(1, max(1, min(top, groups)) + 1), key=lambda s: (fill(s), -s))
    return LaunchPlan(r, cluster, row_blocks, GROUP * -(-groups // cluster))


def pack_points(p: torch.Tensor, plan: LaunchPlan, valid: torch.Tensor | None = None,
                direct: bool = False) -> torch.Tensor:
    """The point set as N1-N3 stage it: [plan.packed_rows, 4] float32 rows.
    N1 / N2: (-2 p, |p|^2) (the scaling by -2 is exact; the norm computed
    as the plain version computes it, +inf on the rows `valid` rules out),
    the rows past the set (0, 0, 0, +inf). N3 (`direct`): (p, 0), the rows
    past the set +inf."""
    n = p.shape[0]
    packed = torch.empty((plan.packed_rows, 4), dtype=torch.float32, device=p.device)
    if direct:
        packed[:n, :3] = p
        packed[:n, 3] = 0.0
        packed[n:] = torch.inf
        return packed
    p2 = (p * p).sum(-1)
    torch.mul(p, -2.0, out=packed[:n, :3])
    packed[:n, 3] = p2 if valid is None else torch.where(valid, p2, torch.inf)
    packed[n:, :3] = 0.0
    packed[n:, 3] = torch.inf
    return packed


@functools.lru_cache(maxsize=None)
def card_plan_inputs(index: int, kk: int | None, direct: bool = False) -> tuple[int, int]:
    """(SMs of card `index`, blocks of N1 / N2's instance, or N3's
    (`direct`), an SM holds)."""
    blocks = ctypes.c_int(0)
    out = ctypes.POINTER(ctypes.c_int)
    if direct:
        symbol = "lidargs_knn3_blocks_per_sm"
        fn, err_str = cuda_build.entry("knn", symbol, [ctypes.c_int, out])
        args = (rows_per_thread(direct=True), ctypes.byref(blocks))
    else:
        symbol = "lidargs_knn_blocks_per_sm"
        fn, err_str = cuda_build.entry("knn", symbol, [ctypes.c_int, ctypes.c_int, out])
        args = (0 if kk is None else kk, rows_per_thread(kk), ctypes.byref(blocks))
    with torch.cuda.device(index):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: {err_str(err).decode()}")
    return torch.cuda.get_device_properties(index).multi_processor_count, blocks.value


def plan_on_card(n_queries: int, n_points: int, device: torch.device, kk=None,
                 direct: bool = False) -> LaunchPlan:
    """`launch_plan` for N1 (`kk` None), N2 or N3 (`direct`) on the card
    `device`."""
    return launch_plan(n_queries, n_points, *card_plan_inputs(device.index or 0, kk, direct),
                       kk, direct)


def _launch_gram(symbol: str, rows: tuple, p: torch.Tensor, out: torch.Tensor, kk=None,
                 valid=None) -> None:
    """Pack the point set `p` and launch N1 (`kk` None) / N2 with the plan
    of this card: the query tensors `rows`, `packed`, `out`, then the
    counts and the plan."""
    plan = plan_on_card(rows[0].shape[0], p.shape[0], p.device, kk)
    packed = pack_points(p, plan, valid)
    scalars = (rows[0].shape[0], plan.slice_rows, *(() if kk is None else (kk,)),
               plan.rows_per_thread, plan.row_blocks, plan.cluster)
    cuda_build.launch("knn", symbol, [ctypes.c_int] * len(scalars), (*rows, packed, out),
                      scalars)


def chamfer_dir(a: torch.Tensor, a_valid: torch.Tensor, b: torch.Tensor,
                b_valid: torch.Tensor) -> torch.Tensor:
    """N1: [Na] squared distance from each valid row of `a` to its nearest
    valid row of `b` (0 where a_i is invalid, +inf where no b_j is)."""
    _on_card("chamfer_dir", a)
    check_points(a=a, b=b)
    check_masks(a, a_valid, "a_valid")
    check_masks(b, b_valid, "b_valid")
    out = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    if a.shape[0] == 0:
        return out
    _launch_gram("lidargs_knn_chamfer", (a, (a * a).sum(-1), a_valid), b, out, valid=b_valid)
    return out


def knn_sqdist(q: torch.Tensor, p: torch.Tensor, kk: int) -> torch.Tensor:
    """N2: [Nq, kk] the kk smallest squared distances from each query row to
    the rows of `p` (the query itself included where it is one), ascending."""
    _on_card("knn_sqdist", q)
    check_points(queries=q, points=p)
    check_k(kk, p.shape[0])
    out = torch.empty((q.shape[0], kk), dtype=torch.float32, device=q.device)
    if q.shape[0] == 0:
        return out
    _launch_gram("lidargs_knn_gram_topk", (q, (q * q).sum(-1)), p, out, kk)
    return out


def knn3_mean_sq_dist(p: torch.Tensor) -> torch.Tensor:
    """N3: [N] each point's mean squared distance to its 3 nearest others,
    by direct differences (0 for N <= 1)."""
    _on_card("knn3_mean_sq_dist", p)
    check_points(points=p)
    n = p.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=p.device)
    if n == 0:
        return out
    plan = plan_on_card(n, n, p.device, direct=True)
    packed = pack_points(p, plan, direct=True)
    cuda_build.launch("knn", "lidargs_knn3_direct", [ctypes.c_int] * 5, (p, packed, out),
                      (n, plan.slice_rows, plan.rows_per_thread, plan.row_blocks, plan.cluster))
    return out
