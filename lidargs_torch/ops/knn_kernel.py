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
synchronization), raises on the launch's `cudaError_t`, and adds one to its
count. `ops/knn.py`'s public functions call them for a CUDA tensor and run
the plain versions for a CPU tensor. The library is built with nvcc at the
first launch (`utils/cuda_build.py`).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build

MAX_K = 8                 # the most smallest values N2 keeps a row (registers)

# Launches of the CUDA kernels since the last reset (plain counts; the CPU
# path does not add to them): N1, N2 and N3.
chamfer_launches = 0
knn_launches = 0
knn3_launches = 0


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


def chamfer_dir(a: torch.Tensor, a_valid: torch.Tensor, b: torch.Tensor,
                b_valid: torch.Tensor) -> torch.Tensor:
    """N1: [Na] squared distance from each valid row of `a` to its nearest
    valid row of `b` (0 where a_i is invalid, +inf where no b_j is)."""
    global chamfer_launches
    _on_card("chamfer_dir", a)
    check_points(a=a, b=b)
    check_masks(a, a_valid, "a_valid")
    check_masks(b, b_valid, "b_valid")
    out = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    if a.shape[0] == 0:
        return out
    a2 = (a * a).sum(-1)
    b2 = torch.where(b_valid, (b * b).sum(-1), torch.inf)
    cuda_build.launch("knn", "lidargs_knn_chamfer", [ctypes.c_int] * 2,
                      (a, a2, a_valid, b, b2, out), (a.shape[0], b.shape[0]))
    chamfer_launches += 1
    return out


def knn_sqdist(q: torch.Tensor, p: torch.Tensor, kk: int) -> torch.Tensor:
    """N2: [Nq, kk] the kk smallest squared distances from each query row to
    the rows of `p` (the query itself included where it is one), ascending."""
    global knn_launches
    _on_card("knn_sqdist", q)
    check_points(queries=q, points=p)
    check_k(kk, p.shape[0])
    out = torch.empty((q.shape[0], kk), dtype=torch.float32, device=q.device)
    if q.shape[0] == 0:
        return out
    q2 = (q * q).sum(-1)
    p2 = (p * p).sum(-1)
    cuda_build.launch("knn", "lidargs_knn_gram_topk", [ctypes.c_int] * 3,
                      (q, q2, p, p2, out), (q.shape[0], p.shape[0], kk))
    knn_launches += 1
    return out


def knn3_mean_sq_dist(p: torch.Tensor) -> torch.Tensor:
    """N3: [N] each point's mean squared distance to its 3 nearest others,
    by direct differences (0 for N <= 1)."""
    global knn3_launches
    _on_card("knn3_mean_sq_dist", p)
    check_points(points=p)
    out = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    if p.shape[0] == 0:
        return out
    cuda_build.launch("knn", "lidargs_knn3_direct", [ctypes.c_int], (p, out), (p.shape[0],))
    knn3_launches += 1
    return out
