"""The port's camera-scene readers, spherical harmonics, exact 3-NN and small
helpers against the JAX package on the same inputs.

The camera fixtures are the ones `tests/test_aux_utils.py` writes (a COLMAP
binary model, a NeRF-synthetic scene of RGBA PNGs). Tolerances, each with
its reason:
  * the readers, cameras json, normals from a range image: equal (both
    packages run the same NumPy on the host);
  * eval_sh: 1e-6 (float32 polynomials, the same terms in the same order;
    XLA may contract a product and a sum into one rounding);
  * knn3_mean_sq_dist against the native grid hash: 1e-6 relative. Both
    take direct float32 differences ((dx^2 + dy^2) + dz^2); the native
    build may contract them into FMAs;
  * scene_splats: the float fields to 1e-5 of their scale, the validity
    bit on all but 1% of rows (XLA's CPU atan2/exp are not libm's, as in
    `tests/test_torch_projection.py`).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.data import blender as jb
from lidargs_tpu.data import colmap as jc
from lidargs_tpu.native import knn3_mean_sq_dist as native_knn3
from lidargs_tpu.utils import sh as jsh
from lidargs_tpu.utils import testing as jtest
from lidargs_tpu.utils import visualize as jvis
from lidargs_torch.config import RasterConfig as TR
from lidargs_torch.data import blender as tb
from lidargs_torch.data import colmap as tc
from lidargs_torch.ops.knn import knn3_mean_sq_dist
from lidargs_torch.utils import sh as tsh
from lidargs_torch.utils import testing as ttest
from lidargs_torch.utils import visualize as tvis
from lidargs_torch.utils.testing import one_torch_thread
from test_aux_utils import _write_blender_scene, _write_colmap_bin


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


def _equal(a, b, path="") -> None:
    """Equal nested tuples / dicts / lists of arrays and scalars."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif a is None or isinstance(a, (str, int, float, np.floating, np.integer)):
        assert a == b, (path, a, b)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_colmap_binary_and_text_equal_jax(tmp_path):
    d = str(tmp_path / "sparse")
    _write_colmap_bin(d)
    for name in ("read_cameras_binary", "read_images_binary", "read_points3d_binary"):
        fname = {"read_cameras_binary": "cameras.bin", "read_images_binary": "images.bin",
                 "read_points3d_binary": "points3D.bin"}[name]
        _equal(getattr(tc, name)(os.path.join(d, fname)),
               getattr(jc, name)(os.path.join(d, fname)), name)
    _equal(tuple(tc.read_colmap_scene(d)), tuple(jc.read_colmap_scene(d)))
    t = tmp_path / "txt"
    t.mkdir()
    (t / "cameras.txt").write_text("# comment\n1 SIMPLE_PINHOLE 100 80 50.0 50.0 40.0\n"
                                   "2 PINHOLE 64 48 40.0 41.0 32.0 24.0\n")
    (t / "images.txt").write_text("# images\n3 0.7071 0 0.7071 0 1 2 3 2 a.png\n"
                                  "10.5 20.5 7 30 40 -1\n4 1 0 0 0 0 0 0 1 b.png\n\n")
    (t / "points3D.txt").write_text("# points\n7 1 2 3 255 0 10 0.25 3 0\n"
                                    "8 -4 5 -6 0 255 0 0.5\n")
    for name in ("cameras", "images", "points3D"):
        reader = f"read_{name.lower()}_text"
        _equal(getattr(tc, reader)(str(t / f"{name}.txt")),
               getattr(jc, reader)(str(t / f"{name}.txt")), reader)
    _equal(tuple(tc.read_colmap_scene(str(t))), tuple(jc.read_colmap_scene(str(t))))
    assert tc.CAMERA_MODEL_NAMES == jc.CAMERA_MODEL_NAMES


def test_quaternion_round_trip_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        q *= np.sign(q[0])
        R = tc.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jc.qvec2rotmat(q))
        np.testing.assert_array_equal(tc.rotmat2qvec(R), jc.rotmat2qvec(R))
        np.testing.assert_allclose(tc.rotmat2qvec(R), q, atol=1e-8)


@pytest.fixture(scope="module")
def camera_roots(tmp_path_factory):
    """A NeRF-synthetic scene and a COLMAP scene on disk."""
    base = tmp_path_factory.mktemp("cameras")
    nerf = str(base / "nerf")
    _write_blender_scene(nerf)
    colmap = str(base / "colmap")
    _write_colmap_bin(os.path.join(colmap, "sparse", "0"))
    return nerf, colmap


@pytest.mark.parametrize("kind", ["blender", "colmap", "colmap_eval", "blender_all"])
def test_load_camera_scene_equals_jax(camera_roots, kind):
    nerf, colmap = camera_roots
    root, kw = {"blender": (nerf, {}), "blender_all": (nerf, {"eval_split": False}),
                "colmap": (colmap, {}), "colmap_eval": (colmap, {"eval_split": True})}[kind]
    t, j = tb.load_camera_scene(root, **kw), jb.load_camera_scene(root, **kw)
    _equal(tuple(t), tuple(j))
    for cam in t.train_cameras:
        np.testing.assert_array_equal(cam.c2w, jb.CameraFrame(*cam).c2w)


def test_camera_scene_dispatch_refuses_an_unknown_layout(tmp_path):
    with pytest.raises(ValueError, match="transforms_train.json"):
        tb.load_camera_scene(str(tmp_path))


def test_cameras_json_and_lists_by_scale_equal_jax(camera_roots, tmp_path):
    nerf, _ = camera_roots
    t, j = tb.load_camera_scene(nerf), jb.load_camera_scene(nerf)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    ft = tb.save_cameras_json(str(tmp_path / "t"), t)
    fj = jb.save_cameras_json(str(tmp_path / "j"), j)
    assert json.loads(open(ft).read()) == json.loads(open(fj).read())
    for res in (1, 2, -1, 20):
        _equal(tb.camera_lists_by_scale(t, (1.0, 2.0), res),
               jb.camera_lists_by_scale(j, (1.0, 2.0), res), str(res))
    big = t.train_cameras[0]._replace(image=None, width=3200, height=2400)
    assert tuple(tb.load_camera_at_scale(big, 1.0, -1)) == tuple(
        jb.load_camera_at_scale(jb.CameraFrame(*big), 1.0, -1))
    for fov, px in ((0.6911, 32), (1.2, 480)):
        assert tb.fov2focal(fov, px) == jb.fov2focal(fov, px)
        assert tb.focal2fov(tb.fov2focal(fov, px), px) == jb.focal2fov(jb.fov2focal(fov, px), px)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_equals_jax(deg):
    rng = np.random.default_rng(deg)
    d = rng.normal(size=(2, 64, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    sh = rng.normal(size=(2, 64, 3, (deg + 1) ** 2)).astype(np.float32)
    got = tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(d))
    want = np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    rgb = rng.uniform(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))), rtol=1e-6)
    np.testing.assert_allclose(tsh.sh_to_rgb(tsh.rgb_to_sh(torch.from_numpy(rgb))).numpy(), rgb,
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tsh.eval_sh(deg + 1, torch.from_numpy(sh[..., :(deg + 1) ** 2]), torch.from_numpy(d))


def _clouds():
    rng = np.random.default_rng(5)
    uniform = rng.uniform(-50, 50, (1500, 3))
    centers = rng.uniform(-40, 40, (6, 3))
    clustered = (centers[rng.integers(0, 6, 1500)]
                 + rng.normal(scale=0.3, size=(1500, 3)))
    street = uniform * [1.0, 0.2, 0.05] + [3000.0, -1200.0, 40.0]     # far from the origin
    dup = np.concatenate([clustered[:200], clustered[:50], clustered[:50]])
    # (the native search rings out to 1024 cells until it has three
    # neighbours, so it is held to the port only where every point has them)
    return {"uniform": uniform, "clustered": clustered, "far": street, "duplicates": dup,
            "n4": uniform[:4]}


@pytest.mark.parametrize("name", list(_clouds()))
def test_knn3_mean_sq_dist_equals_native(name):
    pts = _clouds()[name].astype(np.float32)
    want = native_knn3(pts)
    got = knn3_mean_sq_dist(torch.from_numpy(pts), chunk=97)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(pts),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(knn3_mean_sq_dist(torch.from_numpy(pts)).numpy(), got.numpy())
    if name == "duplicates":
        # a point with two copies: two neighbours at 0, the third elsewhere
        g = got.numpy()
        np.testing.assert_array_equal(g[200:250], g[:50])
        np.testing.assert_array_equal(g[250:], g[:50])
        d2 = ((pts[:50, None] - pts[None, :200]) ** 2).sum(-1)
        d2[np.arange(50), np.arange(50)] = np.inf
        np.testing.assert_allclose(g[:50], d2.min(1) / 3, rtol=1e-6)


def test_knn3_mean_sq_dist_small_sets():
    for n in (0, 1):
        assert knn3_mean_sq_dist(torch.zeros((n, 3))).tolist() == [0.0] * n
    # fewer than three neighbours: those there are, summed and divided by 3
    two = torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    assert knn3_mean_sq_dist(two).tolist() == [3.0, 3.0]
    three = torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [0.0, 0.0, 6.0]])
    assert knn3_mean_sq_dist(three).tolist() == [15.0, 18.0, 27.0]


def test_normals_from_range_equals_jax():
    from lidargs_torch.lidar.beams import uniform_beam_inclinations

    H, W = 16, 64
    beams = uniform_beam_inclinations(10.0, 20.0, H)
    rng = np.random.default_rng(2)
    depth = rng.uniform(5.0, 40.0, (H, W))
    depth[3, 5:9] = 0.0
    n = tvis.normals_from_range(depth, beams)
    np.testing.assert_array_equal(n, jvis.normals_from_range(depth, beams))
    np.testing.assert_array_equal(tvis.normal_to_rgb(n), jvis.normal_to_rgb(n))
    assert (n[3, 5:9] == 0).all() and n.shape == (H, W, 3)


def test_annotate_names_a_span_in_the_trace(tmp_path):
    from lidargs_torch.utils.profiling import annotate, trace

    x = torch.ones(64, 64)
    with trace(str(tmp_path / "trace")):
        with annotate("dynamic_render"):
            (x @ x).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "dynamic_render" for e in events)


def test_make_optimizer_is_lr_schedules():
    from lidargs_torch.config import OptConfig
    from lidargs_torch.train import make_optimizer
    from lidargs_torch.train.optim import lr_schedules

    ocfg = OptConfig()
    got, want = make_optimizer(ocfg), lr_schedules(ocfg)
    assert sorted(got) == sorted(want)
    for k in want:
        for step in (0, 100, 5000):
            assert float(got[k](step)) == float(want[k](step))


def test_scene_splats_matches_jax():
    from lidargs_tpu.config import RasterConfig as JR

    sc = ttest.make_scene(seed=3, n=300, H=16, W=128)
    jsc = jtest.SyntheticScene(*[jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in sc])
    t = ttest.scene_splats(sc, TR(), device="cpu")
    j = jtest.scene_splats(jsc, JR())
    valid_t, valid_j = t.valid.numpy(), np.asarray(j.valid)
    assert valid_j.sum() > 100 and (valid_t != valid_j).mean() <= 0.01
    both = valid_t & valid_j
    for name in ("depth", "sphere_mean", "u1", "u2", "conic", "opacity", "feat", "center"):
        a, b = getattr(t, name).numpy()[both], np.asarray(getattr(j, name))[both]
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=0, err_msg=name)
