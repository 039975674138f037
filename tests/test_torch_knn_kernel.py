"""Kernels N1-N3 (`lidargs_torch/csrc/knn.cu`): the plain versions of the
nearest-neighbour distances against the JAX package's `ops/knn.py` and its
native `knn3_mean_sq_dist` on the kernels' edge cases, the public functions
of `lidargs_torch/ops/knn.py` against the plain versions, the wrappers'
input checks, N1's and N2's launch plan and packed point rows, a plain
mirror of their split of the point set and merge against the unsplit plain
versions, and (on a card) the kernels against the plain versions.

Edge cases: validity masks on both sides, an empty valid set (+inf for a
valid row, 0 for an invalid one), duplicates and ties, sets of 0 and 1
points, a k larger than the set, and clusters at street range, where the
Gram form cancels.

Tolerances, each with its reason:
  * the Gram-form distances (N1, N2) against JAX's and against a float64
    brute force: 1e-3 m^2 + 1e-6 (|q|^2 + max |p|^2), the bound that
    `tests/test_torch_knn.py` states (float32 rounds ~13 terms of that size
    in both packages, in different orders);
  * the direct 3-NN (N3) against the native grid hash: 1e-6 relative, the
    bound of `tests/test_torch_camera_data.py` (the native build may
    contract a product and a sum into an FMA);
  * an infinite distance, a masked row's 0 and the public functions against
    the plain versions on the CPU: equal;
  * the packed rows against (-2 p, |p|^2) and the split-and-merge mirror
    against the unsplit plain versions: equal bit for bit (the scaling by
    -2 is exact; a minimum and the k smallest do not depend on how the
    values are split);
  * on the card, N1 and N2 against the plain versions: the Gram bound above
    (the kernels round the dot product and the -2 step in another order than
    cuBLAS's addmm); N3 bit for bit (both round every step alone); two
    launches of each kernel bit for bit (no atomics).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.native import knn3_mean_sq_dist as native_knn3
from lidargs_tpu.ops import knn as jk
from lidargs_torch.ops import knn as tk
from lidargs_torch.ops import knn_kernel as nk
from lidargs_torch.utils.testing import one_torch_thread
from test_torch_knn import _brute, _street_points, _tol


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


def _masks(seed, na, nb, frac=0.3):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=na) > frac, rng.uniform(size=nb) > frac


def _with_duplicates(pts, seed):
    """`pts` with a tenth of its rows copied onto others (ties at 0 and
    equal neighbours at equal distances)."""
    rng = np.random.default_rng(seed)
    out = pts.copy()
    n = len(pts)
    src = rng.integers(0, n, n // 10)
    out[rng.integers(0, n, n // 10)] = pts[src]
    return out


@pytest.mark.parametrize("case", ["masks", "duplicates", "empty_valid", "no_points"])
def test_chamfer_dir_plain_matches_jax(case):
    """N1's plain version against JAX's jitted `_chamfer_dir` with masks on
    both sides: each valid row within the Gram bound, invalid rows 0, and
    +inf for every valid row when no point row is valid."""
    a, b = _street_points(10, 300, 0.1), _street_points(11, 260, 0.1)
    av, bv = _masks(12, 300, 260)
    if case == "duplicates":
        a = _with_duplicates(a, 13)
        b = np.concatenate([_with_duplicates(b, 14), a[:40]])
        bv = np.concatenate([bv, np.ones(40, bool)])
    elif case == "empty_valid":
        bv = np.zeros(260, bool)
    elif case == "no_points":
        b, bv = b[:0], bv[:0]
    got = tk._chamfer_dir_plain(torch.from_numpy(a), torch.from_numpy(av), torch.from_numpy(b),
                                torch.from_numpy(bv), chunk=64).numpy()
    # JAX's minimum over no column raises: it is held there to one invalid row
    jb, jbv = (np.zeros((1, 3), np.float32), np.zeros(1, bool)) if len(b) == 0 else (b, bv)
    want = np.asarray(jk._chamfer_dir(jnp.asarray(a), jnp.asarray(av), jnp.asarray(jb),
                                      jnp.asarray(jbv), 64))
    assert got.dtype == np.float32 and got.shape == (300,)
    assert (got[~av] == 0).all() and (want[~av] == 0).all()
    if not bv.any():
        assert np.isinf(got[av]).all() and np.isinf(want[av]).all()
        return
    tol = _tol(a[av], b[bv])
    oracle = _brute(a[av], b[bv])[:, 0]
    assert (np.abs(got[av] - want[av]) <= tol).all()
    assert (np.abs(got[av] - oracle) <= tol).all()
    if case == "duplicates":
        # the 40 rows of a copied into b find themselves (0 up to the bound)
        assert (got[:40][av[:40]] <= _tol(a[:40], b)[av[:40]]).all()


@pytest.mark.parametrize("k,exclude_self", [(1, False), (3, True), (8, False)])
def test_knn_sqdist_plain_matches_jax(k, exclude_self):
    """N2's plain version against JAX's `knn_sqdist` on street clusters with
    duplicates, up to the kernel's k of 8: the k smallest, ascending, the
    self-distance dropped where asked."""
    pts = _with_duplicates(_street_points(20, 400), 21)
    q = pts if exclude_self else _street_points(22, 150)
    got = tk.knn_sqdist_plain(torch.from_numpy(q), torch.from_numpy(pts), k, chunk=53,
                              exclude_self=exclude_self).numpy()
    want = np.asarray(jk.knn_sqdist(q, pts, k, chunk=64, exclude_self=exclude_self))
    oracle = _brute(q, pts)[:, 1:k + 1] if exclude_self else _brute(q, pts)[:, :k]
    tol = _tol(q, pts)[:, None]
    assert got.shape == want.shape == (len(q), k)
    assert (np.diff(got, axis=1) >= 0).all()
    assert (np.abs(got - want) <= tol).all() and (np.abs(got - oracle) <= tol).all()


def test_knn_sqdist_edge_sets():
    """One point (k = 1: its own zero distance) and a k larger than the set,
    which both packages refuse (`torch.topk`, JAX's `top_k`)."""
    one = np.array([[30.0, -40.0, 1.5]], np.float32)
    got = tk.knn_sqdist_plain(torch.from_numpy(one), torch.from_numpy(one), 1).numpy()
    want = np.asarray(jk.knn_sqdist(one, one, 1, chunk=8))
    assert np.abs(got - want).max() <= _tol(one, one).max() and abs(got[0, 0]) <= 1e-2
    three = _street_points(23, 3)
    with pytest.raises(RuntimeError):
        tk.knn_sqdist_plain(torch.from_numpy(three), torch.from_numpy(three), 4)
    with pytest.raises(ValueError):
        jk.knn_sqdist(three, three, 4, chunk=8)
    with pytest.raises(ValueError, match="exceeds the 3 points"):
        nk.check_k(4, 3)


@pytest.mark.parametrize("name", ["street", "duplicates", "one", "empty"])
def test_knn3_plain_matches_native(name):
    """N3's plain version against the native grid hash (which the JAX
    package calls): street clusters, duplicate points (a copy counts at 0),
    and the sets of one and no point (0 each)."""
    pts = {"street": _street_points(30, 500), "duplicates": _with_duplicates(
        _street_points(31, 400), 32), "one": _street_points(33, 1),
        "empty": np.zeros((0, 3), np.float32)}[name]
    got = tk.knn3_mean_sq_dist_plain(torch.from_numpy(pts), chunk=61).numpy()
    want = native_knn3(pts)
    assert got.dtype == np.float32 and got.shape == (len(pts),)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if len(pts) > 1:
        d2 = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        np.testing.assert_allclose(got, np.sort(d2, 1)[:, :3].mean(1), rtol=1e-5, atol=1e-12)


def test_public_functions_equal_the_plain_versions_on_the_cpu():
    """On a CPU tensor the public functions run the plain versions: the same
    bits, and no kernel launch counted."""
    a, b = _street_points(40, 320, 0.1), _street_points(41, 280, 0.1)
    av, bv = (torch.from_numpy(m) for m in _masks(42, 320, 280))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = (nk.chamfer_launches, nk.knn_launches, nk.knn3_launches)
    cd, d1, d2, _, _ = tk.chamfer_distance(ta, tb, pred_valid=av, gt_valid=bv)
    assert torch.equal(d1, tk._chamfer_dir_plain(ta, av, tb, bv))
    assert torch.equal(d2, tk._chamfer_dir_plain(tb, bv, ta, av))
    assert torch.equal(tk._chamfer_dir(ta, av, tb, bv), d1)
    for k, ex in ((4, False), (3, True)):
        assert torch.equal(tk.knn_sqdist(ta, tb, k, exclude_self=ex),
                           tk.knn_sqdist_plain(ta, tb, k, exclude_self=ex))
    assert torch.equal(tk.mean_sq_dist_3nn(ta),
                       tk.knn_sqdist_plain(ta, ta, 3, exclude_self=True).clamp_min(0).mean(1))
    assert torch.equal(tk.knn3_mean_sq_dist(ta), tk.knn3_mean_sq_dist_plain(ta))
    assert (nk.chamfer_launches, nk.knn_launches, nk.knn3_launches) == before


def _good():
    return dict(a=torch.zeros(5, 3), av=torch.ones(5, dtype=torch.bool), b=torch.zeros(4, 3),
                bv=torch.ones(4, dtype=torch.bool), k=4)


@pytest.mark.parametrize("bad,err", [
    (dict(a=torch.zeros(5, 3, dtype=torch.float64)), TypeError),
    (dict(b=torch.zeros(4, 3, dtype=torch.float16)), TypeError),
    (dict(a=torch.zeros(5, 4)), ValueError),                       # [N, 3] rows
    (dict(b=torch.zeros(12)), ValueError),
    (dict(a=torch.zeros(3, 5).T), ValueError),                     # not contiguous
    (dict(av=torch.ones(5, dtype=torch.uint8)), TypeError),        # bool masks
    (dict(bv=torch.ones(3, dtype=torch.bool)), ValueError),        # one a row
    (dict(av=torch.ones(10, dtype=torch.bool)[::2]), ValueError),  # not contiguous
    (dict(b=torch.zeros(4, 3, device="meta")), ValueError),        # one device
    (dict(k=9), ValueError),                                       # k <= 8
    (dict(k=0), ValueError),
    (dict(k=5), ValueError),                                       # k <= the set
])
def test_kernel_input_checks_raise(bad, err):
    """The checks the wrappers run before a launch refuse what N1-N3 cannot
    take, and a tensor that is not on a card is refused by each wrapper."""
    g = _good()
    nk.check_points(a=g["a"], b=g["b"])
    nk.check_masks(g["a"], g["av"], "a_valid")
    nk.check_masks(g["b"], g["bv"], "b_valid")
    nk.check_k(g["k"], g["b"].shape[0])
    g.update(bad)
    with pytest.raises(err):
        nk.check_points(a=g["a"], b=g["b"])
        nk.check_masks(g["a"], g["av"], "a_valid")
        nk.check_masks(g["b"], g["bv"], "b_valid")
        nk.check_k(g["k"], g["b"].shape[0])


def test_wrappers_refuse_tensors_off_the_card():
    """A wrapper launches only on a CUDA tensor: a CPU or meta tensor raises
    before anything is built, and no launch is counted."""
    g = _good()
    before = (nk.chamfer_launches, nk.knn_launches, nk.knn3_launches)
    for dev in ("cpu", "meta"):
        a, av, b, bv = (g[k].to(dev) for k in ("a", "av", "b", "bv"))
        with pytest.raises(ValueError, match="unsupported device"):
            nk.chamfer_dir(a, av, b, bv)
        with pytest.raises(ValueError, match="unsupported device"):
            nk.knn_sqdist(a, b, 2)
        with pytest.raises(ValueError, match="unsupported device"):
            nk.knn3_mean_sq_dist(a)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.knn3_mean_sq_dist(torch.zeros(4, 3, device="meta"))
    assert (nk.chamfer_launches, nk.knn_launches, nk.knn3_launches) == before


H100_SMS = 132
# blocks of N1's and N2's instances an H100 SM holds (their registers: the
# card's occupancy query, `knn_kernel.card_plan_inputs`)
BLOCKS_PER_SM = {None: 8, 4: 6}


def _plan_ok(plan, n_q, n_p, kk=None, n_sm=H100_SMS, blocks_per_sm=8):
    """The invariants of every launch plan: the row blocks cover the rows,
    the last one ragged at most; whole groups a slice; the slices cover the
    points, the padding less than a group a slice (the last slices may hold
    padding alone); and no other cluster size fills the resident blocks'
    waves better."""
    rows = nk.THREADS * plan.rows_per_thread
    assert plan.rows_per_thread == nk.rows_per_thread(kk) == (8 if kk is None else 4)
    assert (plan.row_blocks - 1) * rows < n_q <= plan.row_blocks * rows
    top = nk.MAX_CLUSTER if kk is None else nk.TOPK_MAX_CLUSTER
    assert 1 <= plan.cluster <= top and plan.slice_rows % nk.GROUP == 0
    assert plan.packed_rows >= n_p and plan.packed_rows - n_p < plan.cluster * nk.GROUP
    resident = n_sm * blocks_per_sm
    fill = lambda s: plan.row_blocks * s / (resident * -(-plan.row_blocks * s // resident))
    assert all(fill(s) <= fill(plan.cluster)
               for s in range(1, min(top, -(-n_p // nk.GROUP)) + 1))


@pytest.mark.parametrize("name,n_q,n_p,kk,want", [
    # phase 21's N1, test frame 0's clouds, one direction: 158 row blocks of
    # 1,024 rows; S = 6 gives 948 blocks, one wave of the 1,056 resident
    ("chamfer_frame", 160_899, 162_912, None, (8, 6, 158, 27_152)),
    # a full frame of the evaluation, both sides 64 x 2650
    ("chamfer_full", 169_600, 169_600, None, (8, 6, 166, 28_272)),
    # N2 on the 500k init cloud (phases 20-21), k = 3 + the query: 977 row
    # blocks of 512 rows, two slices
    ("init_3nn", 500_000, 500_000, 4, (4, 2, 977, 250_000)),
])
def test_launch_plan_on_the_smoke_shapes(name, n_q, n_p, kk, want):
    """N1's and N2's launch plans on the shapes `chip_smoke.py` gives them
    at an H100's 132 SMs."""
    plan = nk.launch_plan(n_q, n_p, H100_SMS, BLOCKS_PER_SM[kk], kk)
    assert dataclasses.astuple(plan) == want
    _plan_ok(plan, n_q, n_p, kk, blocks_per_sm=BLOCKS_PER_SM[kk])


@pytest.mark.parametrize("n_q,n_p,kk,want", [
    (1025, 5000, None, (8, 8, 2, 632)),     # a ragged last row block of one row
    (3000, 100, None, (8, 8, 3, 16)),       # slices shorter than a stage, the last padding
    (3000, 100, 1, (4, 2, 6, 56)),
    (10, 3, 1, (4, 1, 1, 8)),               # fewer points than a group: one slice
    (1025, 9, None, (8, 2, 2, 8)),          # two groups: two slices
    (7, 0, None, (8, 1, 1, 0)),             # N1 against no point: nothing staged
    (4096, 9, 8, (4, 2, 8, 8)),             # k = 8
    (1, 1, None, (8, 1, 1, 8)),
])
def test_launch_plan_edges(n_q, n_p, kk, want):
    """The plan at its edges: a ragged last block, a slice shorter than a
    stage, fewer points than a cluster's blocks, no points, k of 1 and 8."""
    plan = nk.launch_plan(n_q, n_p, H100_SMS, 8, kk)
    assert dataclasses.astuple(plan) == want
    _plan_ok(plan, n_q, n_p, kk)
    assert plan.slice_rows < nk.STAGE_ROWS or n_p > 1000
    with pytest.raises(ValueError, match="no launch plan"):
        nk.launch_plan(0, n_p, H100_SMS, 8, kk)
    with pytest.raises(ValueError, match="no launch plan"):
        nk.launch_plan(n_q, n_p, H100_SMS, 0, kk)


@pytest.mark.parametrize("masked", [False, True])
def test_packed_rows_are_the_scaled_points_and_norms(masked):
    """The wrapper's packed stage rows: (-2 p, |p|^2) bit for bit (the norm
    the plain versions compute, +inf on an invalid row), the rows past the
    set (0, 0, 0, +inf)."""
    p = torch.from_numpy(_with_duplicates(_street_points(80, 1003, 0.1), 81))
    p[:5] = 0.0                                          # -2 * 0 is -0.0
    valid = torch.from_numpy(_masks(82, 1003, 1003)[1]) if masked else None
    plan = nk.launch_plan(777, 1003, H100_SMS, 8, None if masked else 4)
    packed = nk.pack_points(p, plan, valid)
    assert packed.dtype == torch.float32 and tuple(packed.shape) == (plan.packed_rows, 4)
    bits = lambda x: x.contiguous().view(torch.int32)
    want = torch.from_numpy(np.float32(-2.0) * p.numpy())
    assert torch.equal(bits(packed[:1003, :3]), bits(want))
    norms = (p * p).sum(-1)
    if masked:
        norms = torch.where(valid, norms, torch.inf)
        assert torch.isinf(packed[:1003, 3][~valid]).all()
    assert torch.equal(bits(packed[:1003, 3]), bits(norms))
    pad = packed[1003:]
    assert len(pad) > 0 and (bits(pad[:, :3]) == 0).all() and torch.isinf(pad[:, 3]).all()


def _split_merge(values, plan, kk):
    """A plain mirror of N1's / N2's split and merge: `values` [nq, np]
    padded with +inf to the plan's packed rows, each slice's kk smallest
    (+inf where a slice holds fewer), then the kk smallest of the slices'
    lists, ascending."""
    nq, n = values.shape
    v = torch.cat([values, values.new_full((nq, plan.packed_rows - n), torch.inf)], 1)
    lists = []
    for r in range(plan.cluster):
        sl = v[:, r * plan.slice_rows:(r + 1) * plan.slice_rows]
        best = torch.topk(sl, min(kk, sl.shape[1]), dim=1, largest=False, sorted=True).values
        lists.append(torch.cat([best, v.new_full((nq, kk - best.shape[1]), torch.inf)], 1))
    return torch.topk(torch.cat(lists, 1), kk, dim=1, largest=False, sorted=True).values


@pytest.mark.parametrize("kk,n_p,cluster", [(1, 261, 8), (4, 261, 8), (8, 261, 2), (8, 20, 3),
                                            (4, 4, 1), (4, 100, 8)])
def test_split_and_merge_equal_the_unsplit_plain_versions(kk, n_p, cluster):
    """Slices of the point set as a launch plan cuts them, each reduced to
    its minimum (N1) or its kk smallest (N2) and merged, give the unsplit
    plain versions' bits, with ties (duplicate points) and invalid rows;
    slices shorter than kk, and slices of padding alone (100 points in 8
    slices of 16), too."""
    a = _street_points(90, 300, 0.1)
    b = np.concatenate([_with_duplicates(_street_points(91, n_p, 0.1), 92)[:n_p - n_p // 4],
                        a[:n_p // 4]])
    av, bv = (torch.from_numpy(m) for m in _masks(93, 300, n_p))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    groups = -(-n_p // nk.GROUP)
    plan = nk.LaunchPlan(4, cluster, 1, nk.GROUP * -(-groups // cluster))
    # the plain versions' values before + |q|^2: one addmm block each
    gram = lambda q, p, p2: torch.addmm(p2[None, :], q, p.T.contiguous(), alpha=-2.0)
    q2 = (ta * ta).sum(-1)
    got = _split_merge(gram(ta, tb, (tb * tb).sum(-1)), plan, kk) + q2[:, None]
    assert torch.equal(got, tk.knn_sqdist_plain(ta, tb, kk))
    b2 = torch.where(bv, (tb * tb).sum(-1), torch.inf)
    mins = _split_merge(gram(ta, tb, b2), plan, 1)[:, 0] + q2
    assert torch.equal(torch.where(av, mins.clamp_min(0.0), 0.0),
                       tk._chamfer_dir_plain(ta, av, tb, bv))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_n1_matches_plain_on_card():
    """N1 (both directions of `chamfer_distance`) against the plain version
    on the same CUDA tensors, with masks on both sides and an empty valid
    set; two launches give the same bits."""
    dev = _card()
    a, b = _street_points(50, 3000, 0.1), _street_points(51, 2600, 0.1)
    av, bv = _masks(52, 3000, 2600)
    ta, tb, tav, tbv = (torch.from_numpy(x).to(dev) for x in (a, b, av, bv))
    before = nk.chamfer_launches
    cd, d1, d2, _, _ = tk.chamfer_distance(ta, tb, pred_valid=tav, gt_valid=tbv)
    again = tk._chamfer_dir(ta, tav, tb, tbv)
    torch.cuda.synchronize()
    assert nk.chamfer_launches == before + 3 and torch.equal(d1, again)
    for got, (x, xv, y, yv) in ((d1, (ta, tav, tb, tbv)), (d2, (tb, tbv, ta, tav))):
        want = tk._chamfer_dir_plain(x, xv, y, yv).cpu().numpy()
        g, m = got.cpu().numpy(), xv.cpu().numpy()
        assert (g[~m] == 0).all()
        tol = _tol(x.cpu().numpy()[m], y.cpu().numpy()[yv.cpu().numpy()])
        assert (np.abs(g[m] - want[m]) <= tol).all()
    none = tk._chamfer_dir(ta, tav, tb, torch.zeros_like(tbv))
    assert torch.isinf(none[tav]).all() and (none[~tav] == 0).all()


@pytest.mark.cuda
def test_n2_matches_plain_on_card():
    """N2 against the plain version for k = 1..8 (and the 3-NN with the self
    distance dropped), two launches bit for bit; k = 9 raises."""
    dev = _card()
    pts = torch.from_numpy(_with_duplicates(_street_points(60, 5000), 61)).to(dev)
    tol = torch.from_numpy(_tol(pts.cpu().numpy(), pts.cpu().numpy())[:, None]).to(dev)
    for k, ex in ((1, False), (3, True), (8, False)):
        before = nk.knn_launches
        got = tk.knn_sqdist(pts, pts, k, exclude_self=ex)
        again = tk.knn_sqdist(pts, pts, k, exclude_self=ex)
        want = tk.knn_sqdist_plain(pts, pts, k, exclude_self=ex)
        torch.cuda.synchronize()
        assert nk.knn_launches == before + 2 and torch.equal(got, again)
        assert bool(((got - want).abs() <= tol).all())
    with pytest.raises(ValueError, match="1..8"):
        tk.knn_sqdist(pts, pts, 9)


@pytest.mark.cuda
def test_n3_equals_plain_on_card():
    """N3 bit for bit against the plain version, on a set larger than one
    shared-memory stage, with duplicates, and on the sets of 1-5 points."""
    dev = _card()
    pts = torch.from_numpy(_with_duplicates(_street_points(70, 5000), 71)).to(dev)
    before = nk.knn3_launches
    got, again = tk.knn3_mean_sq_dist(pts), tk.knn3_mean_sq_dist(pts)
    assert nk.knn3_launches == before + 2
    assert torch.equal(got, again) and torch.equal(got, tk.knn3_mean_sq_dist_plain(pts))
    for n in range(1, 6):
        assert torch.equal(tk.knn3_mean_sq_dist(pts[:n]), tk.knn3_mean_sq_dist_plain(pts[:n]))


@pytest.mark.cuda
@pytest.mark.parametrize("n_q,n_p", [(1, 1), (1025, 7), (2049, 100), (3 * 1024 + 17, 5003)])
def test_n1_n2_ragged_plans_on_card(n_q, n_p):
    """N1 and N2 (k = 1, 4, 8 where the set has them) where the plan cuts the
    row blocks and the slices raggedly, and a slice is shorter than a stage:
    within the Gram bound of the plain versions, two launches bit for bit."""
    dev = _card()
    q = torch.from_numpy(_street_points(100, n_q, 0.1)).to(dev)
    p = torch.from_numpy(_with_duplicates(_street_points(101, n_p, 0.1), 102)).to(dev)
    qv, pv = (torch.from_numpy(m).to(dev) for m in _masks(103, n_q, n_p))
    qn, pn = q.cpu().numpy(), p.cpu().numpy()
    got, again = tk._chamfer_dir(q, qv, p, pv), tk._chamfer_dir(q, qv, p, pv)
    want = tk._chamfer_dir_plain(q, qv, p, pv)
    assert torch.equal(got, again) and bool((got[~qv] == 0).all())
    m = (qv & (pv.any())).cpu().numpy()
    if m.any():
        tol = torch.from_numpy(_tol(qn[m], pn[pv.cpu().numpy()])).to(dev)
        assert bool(((got[m] - want[m]).abs() <= tol).all())
    for k in (1, 4, 8):
        if k > n_p:
            continue
        got, again = tk.knn_sqdist(q, p, k), tk.knn_sqdist(q, p, k)
        tol = torch.from_numpy(_tol(qn, pn)[:, None]).to(dev)
        assert torch.equal(got, again)
        assert bool(((got - tk.knn_sqdist_plain(q, p, k)).abs() <= tol).all())


@pytest.mark.cuda
def test_refused_cluster_launch_raises_on_card(monkeypatch):
    """A plan the kernel refuses (a cluster beyond 8 blocks) raises at the
    launch, and nothing is counted; nothing runs in its place."""
    dev = _card()
    pts = torch.from_numpy(_street_points(110, 500)).to(dev)
    bad = nk.LaunchPlan(4, 9, 1, 64)
    monkeypatch.setattr(nk, "launch_plan", lambda *a, **k: bad)
    before = nk.knn_launches
    with pytest.raises(RuntimeError, match="launch failed"):
        tk.knn_sqdist(pts, pts, 4)
    assert nk.knn_launches == before
