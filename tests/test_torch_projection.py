"""The port's projection against the JAX package and the independent float64
oracle (`oracle_projection.py`), on the same numpy inputs.

Tolerances: float fields agree to f32 rounding (atol 1e-5 on unit vectors,
conic at 1e-5 of its own scale, centers to 1e-3 px). Integer fields (radii,
rect) and the validity bit are exact except at f32 boundary crossings:
XLA's CPU atan2/exp are not libm's, so an ulp can move a ceil() or a rect
bound; at most 1% of rows may differ, each by at most one unit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import RasterConfig as JCfg
from lidargs_tpu.lidar.beams import kitti_beam_inclinations, uniform_beam_inclinations
from lidargs_tpu.ops import projection as jp
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops import projection as tp
from lidargs_torch.utils.testing import one_torch_thread

from oracle_projection import oracle_preprocess_one


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


JC, TC = JCfg(), TCfg()


def _t(x):
    return torch.from_numpy(np.array(x))


def _gaussians(seed, n, beams, spread=60.0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, (n, 3))
    scales = rng.uniform(0.02, 1.5, (n, 3))
    q = rng.normal(size=(n, 4))
    quats = q / np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.05, 1.0, n)
    feat = rng.normal(size=(n, 2))
    # elevation-edge rows: around the top and bottom beams and the
    # divergence margin, mid-gap and exact-beam rows; then near/far rows
    rda = JC.ray_divergence_angle
    edges = []
    for el in (beams[-1] + 0.5 * rda, beams[-1] + 2.0 * rda, beams[-1] + 2.1 * rda,
               beams[-1] + 0.1, beams[0] - 0.5 * rda, beams[0] - 2.0 * rda,
               beams[0] - 2.1 * rda, beams[0] - 0.1, 0.5 * (beams[3] + beams[4]), beams[5]):
        edges.append([20.0 * np.cos(el), 0.1, 20.0 * np.sin(el)])
    for r in (JC.near * 0.9, JC.near * 1.1 + 1e-3, JC.far * 0.99, JC.far * 1.01):
        edges.append([r, 0.05, 0.02])
    e = len(edges)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    return (f32(np.concatenate([means, edges])),
            f32(np.concatenate([scales, np.full((e, 3), 0.3)])),
            f32(np.concatenate([quats, np.tile([[1.0, 0, 0, 0]], (e, 1))])),
            f32(np.concatenate([opac, np.full(e, 0.8)])),
            f32(np.concatenate([feat, np.zeros((e, 2))])))


def _pose(seed):
    rng = np.random.default_rng(seed)
    Q, R = np.linalg.qr(rng.normal(size=(3, 3)))
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q.astype(np.float32), rng.normal(scale=2.0, size=3).astype(np.float32)


def _both(beams_name, seed, H=32, W=512, n=512):
    beams = (kitti_beam_inclinations(H) if beams_name == "kitti"
             else uniform_beam_inclinations(10.0, 30.0, H)).astype(np.float32)
    m, s, q, o, f = _gaussians(seed, n, beams.astype(np.float64))
    rot, trans = _pose(seed + 100)
    mask = np.ones(len(m), bool)
    jsp = jax.jit(lambda *a: jp.preprocess_gaussians(*a, W, JC))(
        m, s, q, o, f, mask, rot, trans, beams)
    tsp = tp.preprocess_gaussians(_t(m), _t(s), _t(q), _t(o), _t(f), _t(mask),
                                  _t(rot), _t(trans), _t(beams), W, TC)
    return (m, s, q, rot, trans, beams, W), jsp, tsp


CASES = [("uniform", 0), ("kitti", 1), ("uniform", 2)]


@pytest.mark.parametrize("beams_name,seed", CASES)
def test_preprocess_matches_jax(beams_name, seed):
    _, jsp, tsp = _both(beams_name, seed)
    jv, tv = np.asarray(jsp.valid), tsp.valid.numpy()
    n = len(jv)
    assert (jv != tv).sum() <= max(1, n // 100)
    both = jv & tv
    assert both.sum() > 60
    for name, atol in (("sphere_mean", 1e-5), ("u1", 1e-5), ("u2", 1e-5)):
        np.testing.assert_allclose(getattr(tsp, name).numpy(), np.asarray(getattr(jsp, name)),
                                   atol=atol, err_msg=name)
    np.testing.assert_allclose(tsp.depth.numpy()[both], np.asarray(jsp.depth)[both],
                               rtol=1e-6)
    np.testing.assert_allclose(tsp.opacity.numpy()[both], np.asarray(jsp.opacity)[both])
    np.testing.assert_array_equal(tsp.feat.numpy(), np.asarray(jsp.feat))
    jc, tc = np.asarray(jsp.conic)[both], tsp.conic.numpy()[both]
    scale = np.abs(jc).max(-1, keepdims=True)
    assert (np.abs(tc - jc) <= 1e-5 * scale + 1e-9).all(), "conic"
    np.testing.assert_allclose(tsp.center.numpy()[both], np.asarray(jsp.center)[both],
                               atol=1e-3)
    dr = np.abs(tsp.radii_xy.numpy()[both] - np.asarray(jsp.radii_xy)[both])
    assert dr.max() <= 1
    for name in ("radii_xy", "pix_rect"):
        d = np.abs(getattr(tsp, name).numpy()[both] - np.asarray(getattr(jsp, name))[both])
        assert (d.max(-1) > 0).sum() <= max(1, n // 100), name
    # the invalid rows carry the same sentinels in both
    inv = ~jv & ~tv
    np.testing.assert_array_equal(tsp.depth.numpy()[inv], np.asarray(jsp.depth)[inv])
    np.testing.assert_array_equal(tsp.radii_xy.numpy()[inv], 0)


@pytest.mark.parametrize("beams_name,seed", CASES)
def test_preprocess_matches_oracle(beams_name, seed):
    (m, s, q, rot, trans, beams, W), _, tsp = _both(beams_name, seed)
    valid = tsp.valid.numpy()
    n_boundary = 0
    for i in range(len(m)):
        o = oracle_preprocess_one(
            m[i].astype(np.float64), s[i].astype(np.float64), q[i].astype(np.float64),
            rot.astype(np.float64), trans.astype(np.float64),
            beams.astype(np.float64).tolist(), W, TC.far, TC.near,
            TC.ray_divergence_angle, TC.lowpass,
            block_x=TC.ref_block_x, block_y=TC.ref_block_y)
        if (o is None) != (not valid[i]):
            n_boundary += 1          # f32-vs-f64 boundary flip
            continue
        if o is None:
            continue
        assert abs(float(tsp.depth[i]) - o["depth"]) < 1e-3
        for name in ("sphere_mean", "u1", "u2"):
            np.testing.assert_allclose(getattr(tsp, name)[i].numpy(), o[name], atol=1e-5)
        np.testing.assert_allclose(tsp.conic[i].numpy(), o["conic"],
                                   atol=2e-3 * float(np.abs(o["conic"]).max()) + 1e-6)
        np.testing.assert_allclose(tsp.center[i].numpy(), o["center"], atol=2e-3)
        r = tsp.radii_xy[i].numpy().astype(np.float64)
        if np.any(r != o["radii_xy"]):
            assert np.all(np.abs(r - o["radii_xy"]) <= 1)
            n_boundary += 1
        else:
            np.testing.assert_array_equal(tsp.pix_rect[i].numpy(), o["rect"])
    assert n_boundary <= max(3, len(m) // 100)


def test_pack_splats_matches_jax_on_same_splats():
    """pack_splats on JAX's own Splats: the layouts are bit-identical."""
    _, jsp, _ = _both("uniform", 3, n=128)
    tsp = tp.Splats(*[_t(x) for x in jsp])
    jpk = np.asarray(jp.pack_splats(jsp))
    tpk = tp.pack_splats(tsp).numpy()
    assert tpk.shape == jpk.shape == (len(jpk), tp.PackedCols.width(2))
    np.testing.assert_array_equal(tpk, jpk)
    # leading batch shapes are kept
    np.testing.assert_array_equal(
        tp.pack_splats(tp.Splats(*[x.reshape((2, -1) + tuple(x.shape[1:])) for x in tsp])
                       ).reshape(tpk.shape).numpy(), jpk)


def test_visible_filter_matches_jax():
    beams = uniform_beam_inclinations(2.4, 20.9, 16).astype(np.float32)
    rng = np.random.default_rng(7)
    n = 300
    anchors = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    scales = rng.uniform(0.05, 0.8, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    rot, trans = _pose(8)
    jv = np.asarray(jp.visible_filter(anchors, scales, q, mask, rot, trans, beams, 256, JC))
    tv = tp.visible_filter(_t(anchors), _t(scales), _t(q), _t(mask), _t(rot), _t(trans),
                           _t(beams), 256, TC).numpy()
    assert jv.sum() > 20
    assert (jv != tv).sum() <= 2


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(64, 4))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    s = rng.uniform(0.1, 2.0, (64, 3)).astype(np.float32)
    R = tp.quat_to_rotmat(_t(q)).numpy()
    np.testing.assert_allclose(R, np.asarray(jp.quat_to_rotmat(q)), atol=1e-6)
    np.testing.assert_allclose(tp.build_cov3d(_t(s), _t(q)).numpy(),
                               np.asarray(jp.build_cov3d(s, q)), atol=1e-5)
    np.testing.assert_allclose(tp.quat_rotate(_t(q), _t(v)).numpy(),
                               np.einsum("nij,nj->ni", R, v), atol=1e-5)
    np.testing.assert_allclose(tp.quat_rotate_inv(_t(q), _t(v)).numpy(),
                               np.asarray(jp.quat_rotate_inv(q, v)), atol=1e-6)
