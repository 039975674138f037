"""The port's nearest-neighbour distances (`lidargs_torch/ops/knn.py`)
against the JAX package's `ops/knn.py`, and both against a float64
brute-force oracle written here.

Tolerances: squared distances within 1e-3 m^2 plus 1e-6 of |x|^2 + |y|^2
(the Gram form |x|^2 + |y|^2 - 2 x.y in float32 rounds about 13 terms of
that size, ~8e-7 of it, and the two packages round its sums in different
orders; at street range, |x|^2 up to ~1e4 m^2, that is ~1e-2 m^2); the
F-score within the share of points whose squared distance lies within
that tolerance of tau (only those can flip); the chamfer distance within
the mean of the per-point tolerances.
"""
import types

import numpy as np
import pytest
import torch

from lidargs_tpu.ops import knn as jk
from lidargs_tpu.train import metrics as jm
from lidargs_torch.ops import knn as tk
from lidargs_torch.train.metrics import evaluate_frame
from lidargs_torch.utils.testing import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


def _tol(q, p):
    """Per query row of `q` against the set `p`: 1e-3 m^2 + 1e-6 (|q_i|^2 +
    max |p|^2)."""
    sq = lambda x: (x.astype(np.float64) ** 2).sum(-1)
    return 1e-3 + 1e-6 * (sq(q) + sq(p).max())


def _street_points(seed, n, spread=0.3):
    """`n` points in clusters at street range (5..75 m), so that neighbours
    are close and |x|^2 is large: the case where the Gram form cancels."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-75.0, 75.0, (n // 8 + 1, 3)) * [1.0, 1.0, 0.05]
    pts = centers[rng.integers(0, len(centers), n)] + rng.normal(0.0, spread, (n, 3))
    return pts.astype(np.float32)


def _brute(q, p):
    """float64 squared distances, sorted per row."""
    d = ((q.astype(np.float64)[:, None] - p.astype(np.float64)[None]) ** 2).sum(-1)
    return np.sort(d, axis=1)


@pytest.mark.parametrize("chunk", [None, 37])
def test_knn_sqdist_matches_jax_and_the_oracle(chunk):
    q, p = _street_points(0, 300), _street_points(1, 500)
    t = tk.knn_sqdist(torch.from_numpy(q), torch.from_numpy(p), k=4, chunk=chunk).numpy()
    j = np.asarray(jk.knn_sqdist(q, p, k=4, chunk=64))
    want = _brute(q, p)[:, :4]
    tol = _tol(q, p)[:, None]
    assert t.shape == j.shape == (300, 4)
    assert (np.abs(t - j) <= tol).all()
    assert (np.abs(t - want) <= tol).all()
    # the chunking does not change a value
    assert np.array_equal(t, tk.knn_sqdist(q, p, k=4, chunk=1000).numpy())


def test_mean_sq_dist_3nn_matches_jax_and_the_oracle():
    pts = _street_points(2, 600)
    pts[5] = pts[6]                                  # a duplicate point
    t = tk.mean_sq_dist_3nn(torch.from_numpy(pts)).numpy()
    j = jk.mean_sq_dist_3nn(pts)
    want = _brute(pts, pts)[:, 1:4].mean(1)
    tol = _tol(pts, pts)
    assert t.dtype == np.float32 and t.shape == (600,)
    assert (np.abs(t - j) <= tol).all()
    assert (np.abs(t - want) <= tol).all()
    assert (t >= 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_and_fscore_match_jax(masked):
    a, b = _street_points(3, 400, 0.1), _street_points(3, 350, 0.1)
    na, nb = (310, 290) if masked else (400, 350)
    av = torch.arange(400) < na
    bv = torch.arange(350) < nb
    cd, d1, d2, v1, v2 = tk.chamfer_distance(torch.from_numpy(a), torch.from_numpy(b),
                                             pred_valid=av if masked else None,
                                             gt_valid=bv if masked else None)
    jcd, jd1, jd2, jv1, jv2 = jk.chamfer_distance(a[:na], b[:nb], capacity=512)
    jd1, jd2 = np.asarray(jd1)[:na], np.asarray(jd2)[:nb]
    t1, t2 = _tol(a[:na], b[:nb]), _tol(b[:nb], a[:na])
    assert (np.abs(d1.numpy()[:na] - jd1) <= t1).all()
    assert (np.abs(d2.numpy()[:nb] - jd2) <= t2).all()
    assert (d1.numpy()[na:] == 0).all() and (d2.numpy()[nb:] == 0).all()
    w1 = _brute(a[:na], b[:nb])[:, 0]
    w2 = _brute(b[:nb], a[:na])[:, 0]
    cd_tol = t1.mean() + t2.mean()
    assert abs(cd - jcd) <= cd_tol and abs(cd - (w1.mean() + w2.mean())) <= cd_tol

    tau = 0.05
    f, p1, p2 = tk.fscore(d1, d2, tau, v1, v2)
    jf, jp1, jp2 = jk.fscore(jd1, jd2, tau)
    near = (np.abs(w1 - tau) <= t1).mean() + (np.abs(w2 - tau) <= t2).mean()
    assert 0.0 < jf < 1.0                            # points on both sides of tau
    assert abs(f - jf) <= near + 1e-6
    assert abs(p1 - jp1) <= near + 1e-6 and abs(p2 - jp2) <= near + 1e-6


def test_empty_clouds_give_jax_values():
    """A render with no return gives cd = inf and F-score 0, as JAX's."""
    rng = np.random.default_rng(5)
    beams = np.linspace(-0.3, 0.05, 8)
    color = np.zeros((2, 8, 32), np.float32)         # ray drop everywhere
    depth = rng.uniform(5, 60, (8, 32)).astype(np.float32)
    gt = np.stack([np.ones((8, 32)), rng.uniform(size=(8, 32)), depth]).astype(np.float32)
    t = evaluate_frame(color, depth, gt, beams)
    j = jm.evaluate_frame(color, depth, gt, beams)
    assert t["depth_cd"] == j["depth_cd"] == float("inf")
    assert t["depth_fscore"] == j["depth_fscore"] == 0.0
    cd, d1, d2, _, _ = tk.chamfer_distance(torch.zeros((0, 3)), torch.ones((4, 3)))
    assert d1.shape == (0,) and (d2 == float("inf")).all()


def test_knn_refuses_tf32(monkeypatch):
    """A card tensor with TF32 products on is refused: at street range TF32
    (10-bit mantissa) would put metres of error into the distances."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tk._check_no_tf32(types.SimpleNamespace(is_cuda=True))
    tk._check_no_tf32(torch.zeros(1))                # the CPU computes in full float32
