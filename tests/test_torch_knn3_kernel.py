"""Kernel N3 (`lidargs_torch/csrc/knn.cu`, the exact 3-NN on the sweep
scaffold of N1 and N2) on the CPU: its packed point rows, its launch plan,
and a plain mirror of its algorithm (the set packed and split into the
plan's slices, each slice's four smallest direct distances kept with the
query row's own among them, the lists merged, the first value dropped)
against the plain version `knn3_mean_sq_dist_plain` and the native
`knn3_mean_sq_dist` that the JAX package calls.

Tolerances: the mirror against the plain version bit for bit (both round
each step of ((dx^2 + dy^2) + dz^2) alone and sum the three smallest in
ascending order; the self distance is exactly +0, so dropping it leaves
the plain version's values); against the native grid hash 1e-6 relative
(it may contract a product and a sum into an FMA), on sets of at least 4
points (the native search rings out to 1024 cells while a point has fewer
than three neighbours, and runs for minutes). On a card, N3 itself is held
to the plain version bit for bit (`test_torch_knn_kernel.py`).
"""
import dataclasses

import numpy as np
import pytest
import torch

from lidargs_tpu.native import knn3_mean_sq_dist as native_knn3
from lidargs_torch.ops import knn as tk
from lidargs_torch.ops import knn_kernel as nk
from lidargs_torch.utils.testing import one_torch_thread
from test_torch_knn import _street_points
from test_torch_knn_kernel import H100_SMS, _with_duplicates


DIRECT_K = 4          # N3's list: the three nearest and the row itself (csrc/knn.cu kDirectK)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_direct_packing_is_the_points_and_inf_padding():
    """N3's packed rows: (x, y, z, 0) bit for bit (-0.0 kept), the rows past
    the set +inf in every column."""
    p = torch.from_numpy(_street_points(1, 1003, 0.1))
    p[:3] = -0.0
    plan = nk.launch_plan(1003, 1003, H100_SMS, 6, direct=True)
    packed = nk.pack_points(p, plan, direct=True)
    assert packed.dtype == torch.float32 and tuple(packed.shape) == (plan.packed_rows, 4)
    assert torch.equal(_bits(packed[:1003, :3]), _bits(p))
    assert (_bits(packed[:1003, 3]) == 0).all()
    assert plan.packed_rows > 1003 and torch.isinf(packed[1003:]).all()
    assert (packed[1003:] > 0).all()


@pytest.mark.parametrize("blocks_per_sm,want", [
    # phase 31's 500k background points: 977 row blocks of 512 rows; at the
    # 7 blocks an H100 SM holds (72 registers) two slices fill the 924
    # resident blocks in fuller waves than one (0.705 against 0.529)
    (7, (4, 2, 977, 250_000)),
    (6, (4, 2, 977, 250_000)),
    # at 4 an SM both fill 0.925 of their waves: the smaller cluster
    (4, (4, 1, 977, 500_000)),
])
def test_n3_launch_plan_on_the_smoke_shapes(blocks_per_sm, want):
    plan = nk.launch_plan(500_000, 500_000, H100_SMS, blocks_per_sm, direct=True)
    assert dataclasses.astuple(plan) == want
    assert plan.rows_per_thread == nk.rows_per_thread(direct=True) == 4
    assert nk.launch_plan(500_000, 500_000, H100_SMS, blocks_per_sm, 4) == plan


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 9, 17, 700])
def test_n3_launch_plan_edges(n):
    """The plan covers every row and point with whole groups a slice, a
    cluster of at most TOPK_MAX_CLUSTER blocks and at most one slice a
    group of points."""
    plan = nk.launch_plan(n, n, H100_SMS, 6, direct=True)
    rows = nk.THREADS * plan.rows_per_thread
    assert (plan.row_blocks - 1) * rows < n <= plan.row_blocks * rows
    assert 1 <= plan.cluster <= min(nk.TOPK_MAX_CLUSTER, -(-n // nk.GROUP))
    assert plan.slice_rows % nk.GROUP == 0
    assert 0 <= plan.packed_rows - n < plan.cluster * nk.GROUP


def _mirror(p: torch.Tensor, plan) -> tuple:
    """N3's algorithm in tensor ops: every query row's direct distance to
    every packed row (itself and the +inf padding included), each slice's
    DIRECT_K smallest (+inf where it holds fewer), the merged DIRECT_K
    smallest, then the first dropped and min(3, n - 1) summed ascending and
    divided by 3. Returns (the result, the merged lists)."""
    n = p.shape[0]
    s = nk.pack_points(p, plan, direct=True)[:, :3]
    d2 = torch.square(s[None, :, 0] - p[:, None, 0])
    for c in (1, 2):
        d2 = d2 + torch.square(s[None, :, c] - p[:, None, c])
    kk = DIRECT_K
    lists = []
    for r in range(plan.cluster):
        sl = d2[:, r * plan.slice_rows:(r + 1) * plan.slice_rows]
        best = torch.topk(sl, min(kk, sl.shape[1]), 1, largest=False, sorted=True).values
        lists.append(torch.cat([best, best.new_full((n, kk - best.shape[1]), torch.inf)], 1))
    best = torch.topk(torch.cat(lists, 1), kk, 1, largest=False, sorted=True).values
    k = min(3, n - 1)
    acc = best[:, 1] if k >= 1 else p.new_zeros(n)
    for j in range(2, k + 1):
        acc = acc + best[:, j]
    return acc / torch.full_like(acc, 3.0), best


@pytest.mark.parametrize("case", ["street", "duplicates", "n1", "n2", "n3", "n4", "n5",
                                  "all_equal"])
@pytest.mark.parametrize("cluster", [None, 1, 2])
def test_self_drop_rule_gives_the_plain_versions_bits(case, cluster):
    """The mirror equals the plain version bit for bit on street clusters,
    duplicates (a copy counts at 0), sets of 1-5 points and a set of one
    point repeated, under the package's plan and with one or two slices;
    every merged list starts with an exact +0 (the row's own distance),
    and the rows past the set (the padding) never enter it. Against the
    native grid hash within 1e-6 relative where the set has 4 points."""
    pts = {"street": _street_points(2, 600, 0.1),
           "duplicates": _with_duplicates(_street_points(3, 400), 4),
           "all_equal": np.tile(_street_points(5, 1), (6, 1))}.get(case)
    if pts is None:
        pts = _street_points(6, int(case[1:]))
    p = torch.from_numpy(pts)
    n = len(pts)
    plan = nk.launch_plan(n, n, H100_SMS, 6, direct=True)
    if cluster is not None:
        groups = -(-n // nk.GROUP)
        s = max(1, min(cluster, groups))
        plan = nk.LaunchPlan(plan.rows_per_thread, s, plan.row_blocks,
                             nk.GROUP * -(-groups // s))
    got, best = _mirror(p, plan)
    assert _bits(best[:, 0]).eq(0).all()
    assert torch.isfinite(best[:, :min(DIRECT_K, n)]).all()
    want = tk.knn3_mean_sq_dist_plain(p, chunk=97)
    assert torch.equal(_bits(got), _bits(want))
    if n >= 4:
        np.testing.assert_allclose(got.numpy(), native_knn3(pts), rtol=1e-6, atol=0)
