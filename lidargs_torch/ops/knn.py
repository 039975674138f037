"""Nearest-neighbour distances: the 3-NN scale estimate and the chamfer
distance / F-score of the depth evaluation.

Counterpart of `lidargs_tpu/ops/knn.py`, with its semantics: squared
distances in the Gram form |x|^2 + |y|^2 - 2 x.y, the product in full
float32 (TF32 off, `lidargs_torch/__init__.py`), the k smallest per row,
`max(d2, 0)`, invalid rows masked out with inf, and the F-score of the
reference on the *squared* distances.

The plain versions chunk the work over query rows so that a chunk's
[rows, N] distance block stays within `BLOCK_ELEMS` elements of its device
(4 GiB of float32 on a card, 64 MiB on the CPU). A chunk's block is
`addmm(|y|^2, x, y^T, alpha=-2)` followed by the row minimum (or the k
smallest) and then `+ |x|^2`: rounding is monotone, so adding the row's
constant after the minimum gives the same value as adding it to every
element first. The kernels keep that order. Nothing here moves a tensor to
another device.

`knn3_mean_sq_dist` is the counterpart of the JAX package's native
`lidargs_tpu.native.knn3_mean_sq_dist` (a grid hash in C++) with its
semantics instead: squared distances from direct coordinate differences,
which keep a near neighbour's distance to float32 rounding of its own size
at any range (no Gram-form cancellation), in chunks of query rows.

On a CUDA tensor the public functions launch the hand-written kernels of
`ops/knn_kernel.py` (`csrc/knn.cu`): N1 for each direction of
`chamfer_distance`, N2 for `knn_sqdist` (and `mean_sq_dist_3nn`), N3 for
`knn3_mean_sq_dist`, with no distance block in memory. On a CPU tensor they
run the plain versions below (`_chamfer_dir_plain`, `knn_sqdist_plain`,
`knn3_mean_sq_dist_plain`). There is no path from one to the other.
"""
from __future__ import annotations

import torch

from . import knn_kernel

BLOCK_ELEMS = {"cuda": 2 ** 30, "cpu": 2 ** 24}


def _check_no_tf32(x: torch.Tensor) -> None:
    """Gram-form distances at street range (|x|^2 ~ 6e3 m^2) carry ~1e-3 m^2
    of float32 error; TF32's 10-bit mantissa would make it metres."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("knn needs full float32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")


def _rows_per_chunk(x: torch.Tensor, n_cols: int, chunk) -> int:
    if chunk is not None:
        return int(chunk)
    return max(1, BLOCK_ELEMS.get(x.device.type, BLOCK_ELEMS["cpu"]) // max(n_cols, 1))


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device, dtype=torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def knn_sqdist(queries, points, k: int, chunk=None, exclude_self: bool = False):
    """k smallest squared distances [Nq, k] (ascending) from each query to
    `points`, on the device of `queries`. With `exclude_self` the k+1
    smallest are taken and the first (the smallest, the zero self-distance
    where the queries are the points) dropped. N2 on a CUDA tensor (k + 1
    at most `knn_kernel.MAX_K`), the plain version on a CPU tensor."""
    q = _f32(queries)
    if q.device.type == "cpu":
        return knn_sqdist_plain(q, points, k, chunk, exclude_self)
    out = knn_kernel.knn_sqdist(q.contiguous(), _f32(points, q.device).contiguous(),
                                k + 1 if exclude_self else k)
    return out[:, 1:] if exclude_self else out


def knn_sqdist_plain(queries, points, k: int, chunk=None, exclude_self: bool = False):
    """The plain version of `knn_sqdist` (and of N2): a chunk's [rows, N]
    block of `addmm(|p|^2, q, p^T, alpha=-2)`, its k smallest, then
    `+ |q|^2`."""
    q = _f32(queries)
    p = _f32(points, q.device)
    _check_no_tf32(q)
    kk = k + 1 if exclude_self else k
    p2 = (p * p).sum(-1)
    q2 = (q * q).sum(-1, keepdim=True)
    pT = p.T.contiguous()
    rows = _rows_per_chunk(q, p.shape[0], chunk)
    out = []
    for s in range(0, q.shape[0], rows):
        blk = torch.addmm(p2[None, :], q[s:s + rows], pT, alpha=-2.0)
        out.append(torch.topk(blk, kk, dim=1, largest=False, sorted=True).values
                   + q2[s:s + rows])
    out = torch.cat(out) if out else q.new_zeros((0, kk))
    return out[:, 1:] if exclude_self else out


def mean_sq_dist_3nn(points, chunk=None) -> torch.Tensor:
    """Mean squared distance to each point's 3 nearest neighbours within its
    own set (the reference's distCUDA2), [N] float32."""
    d2 = knn_sqdist(points, points, k=3, chunk=chunk, exclude_self=True)
    return d2.clamp_min(0.0).mean(1)


def knn3_mean_sq_dist(points, chunk=None) -> torch.Tensor:
    """Mean squared distance to each point's 3 nearest neighbours within its
    own set, [N] float32 on the device of `points`, as the native grid-hash
    version computes it: each squared distance is ((dx^2 + dy^2) + dz^2) of
    the float32 coordinate differences, the point itself is excluded (a
    duplicate counts as a neighbour at 0), the three smallest are summed in
    ascending order and divided by 3 even when fewer than three exist, and
    the result is 0 for N <= 1. N3 on a CUDA tensor (its bits are the plain
    version's), the plain version on a CPU tensor."""
    p = _f32(points)
    if p.device.type == "cpu":
        return knn3_mean_sq_dist_plain(p, chunk)
    return knn_kernel.knn3_mean_sq_dist(p.contiguous())


def knn3_mean_sq_dist_plain(points, chunk=None) -> torch.Tensor:
    """The plain version of `knn3_mean_sq_dist` (and of N3). A chunk is
    `rows` query rows against all N points: three [rows, N] float32 blocks
    at a time, `rows` = a quarter of `BLOCK_ELEMS` // N unless `chunk` is
    given. The sum is divided by a tensor of 3, a true division on either
    device (PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, one rounding more)."""
    p = _f32(points)
    n = p.shape[0]
    if n <= 1:
        return p.new_zeros((n,))
    k = min(3, n - 1)
    cols = p.T.contiguous()                                        # [3, N]
    rows = _rows_per_chunk(p, 4 * n, chunk)
    out = []
    for s in range(0, n, rows):
        q = cols[:, s:s + rows]                                    # [3, B]
        b = q.shape[1]
        d2 = torch.square(cols[0][None, :] - q[0][:, None])
        diff = torch.empty_like(d2)
        for c in (1, 2):
            torch.sub(cols[c][None, :], q[c][:, None], out=diff)
            d2.add_(diff.square_())
        d2[torch.arange(b, device=p.device), torch.arange(s, s + b, device=p.device)] = torch.inf
        best = torch.topk(d2, k, dim=1, largest=False, sorted=True).values
        acc = best[:, 0]
        for j in range(1, k):
            acc = acc + best[:, j]
        out.append(acc / torch.full_like(acc, 3.0))
    return torch.cat(out)


def _chamfer_dir(a, a_valid, b, b_valid, chunk=None) -> torch.Tensor:
    """min_j |a_i - b_j|^2 for every valid a_i (0 where a_i is invalid;
    invalid b rows excluded; +inf where no b row is valid). N1 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return _chamfer_dir_plain(a, a_valid, b, b_valid, chunk)
    return knn_kernel.chamfer_dir(a.contiguous(), a_valid.contiguous(), b.contiguous(),
                                  b_valid.contiguous())


def _chamfer_dir_plain(a, a_valid, b, b_valid, chunk=None) -> torch.Tensor:
    """The plain version of `_chamfer_dir` (and of N1): a chunk's [rows, Nb]
    block of `addmm(|b|^2, a, b^T, alpha=-2)` with +inf norms on the
    invalid b rows, its row minimum, then `+ |a|^2`."""
    _check_no_tf32(a)
    a2 = (a * a).sum(-1)
    if b.shape[0] == 0:
        return torch.where(a_valid, torch.inf, 0.0)
    b2 = torch.where(b_valid, (b * b).sum(-1), torch.inf)
    bT = b.T.contiguous()
    rows = _rows_per_chunk(a, b.shape[0], chunk)
    mins = [torch.addmm(b2[None, :], a[s:s + rows], bT, alpha=-2.0).amin(1)
            for s in range(0, a.shape[0], rows)]
    mins = (torch.cat(mins) if mins else a2.new_zeros((0,))) + a2
    return torch.where(a_valid, mins.clamp_min(0.0), 0.0)


def chamfer_distance(pred, gt, chunk=None, pred_valid=None, gt_valid=None):
    """Bidirectional mean squared chamfer distance and the per-point squared
    distances: (cd, d1, d2, v1, v2) with cd a Python float and the rest
    tensors on the device of `pred`. `pred_valid` / `gt_valid` mask rows
    out (default: every row valid)."""
    a = _f32(pred)
    b = _f32(gt, a.device)
    av = (torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
          if pred_valid is None else pred_valid.to(a.device))
    bv = (torch.ones(b.shape[0], dtype=torch.bool, device=a.device)
          if gt_valid is None else gt_valid.to(a.device))
    d1 = _chamfer_dir(a, av, b, bv, chunk)
    d2 = _chamfer_dir(b, bv, a, av, chunk)
    na, nb = av.sum().clamp_min(1), bv.sum().clamp_min(1)
    cd = d1.sum() / na + d2.sum() / nb
    return float(cd), d1, d2, av, bv


def fscore(d1, d2, threshold: float = 0.05, v1=None, v2=None):
    """F-score at tau on the *squared* chamfer distances (the reference's
    usage): (f, precision, recall) as Python floats. v1/v2: optional
    validity masks."""
    if v1 is None:
        v1 = torch.ones(d1.shape, dtype=torch.bool, device=d1.device)
    if v2 is None:
        v2 = torch.ones(d2.shape, dtype=torch.bool, device=d2.device)
    p1 = ((d1 < threshold) & v1).sum() / v1.sum().clamp_min(1)
    p2 = ((d2 < threshold) & v2).sum() / v2.sum().clamp_min(1)
    denom = p1 + p2
    f = torch.where(denom > 0, 2 * p1 * p2 / denom.clamp_min(1e-20), 0.0)
    return float(f), float(p1), float(p2)
