"""The port's dynamic (background / vehicle) decomposition against the JAX
package on the same DyNFL bundle: the scene's bookkeeping, the sub-scenes
`read_dynamic_scene` builds, two masked training steps of each sub-scene,
and two behaviours of the JAX package that the port keeps (a background ray
reads the last listed object; an appearance index beyond the cameras is
clamped).

Both packages read the files that the JAX package's own test writes
(`tests/test_waymo_dynamic.py::_make_bundle`: 50 frames of 8x64, a dynamic
car and a static wall in every frame). Tolerances, each with its reason:
  * masks, poses, ground truth, Kabsch fits: equal (the same float64 NumPy);
  * init points: 1e-6 of each point's norm. The JAX package back-projects
    through its native float32 `pano_to_points` (float32 beams), the port
    in float64;
  * the masked training steps: those of `tests/test_torch_train.py`, each
    step started from JAX's state: loss terms 1e-5 relative, gradients
    (from the first Adam moment) 1e-4 relative norm per leaf, parameters
    1e-6 where the gradient is above 1e-3 of its leaf's largest (Adam's
    first step is a sign step, so a noise-level entry may move either way)
    and every entry within two learning rates.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import ModelConfig as JM
from lidargs_tpu.config import OptConfig as JO
from lidargs_tpu.config import RasterConfig as JR
from lidargs_tpu.data import waymo_dynamic as jwd
from lidargs_tpu.models import field as jf
from lidargs_tpu.train import trainer as jt
from lidargs_torch.config import ModelConfig as TM
from lidargs_torch.config import OptConfig as TO
from lidargs_torch.config import RasterConfig as TR
from lidargs_torch.data import waymo_dynamic as twd
from lidargs_torch.models import field as tf
from lidargs_torch.train import trainer as tt
from lidargs_torch.utils.params import params_from_jax, train_state_from_jax
from lidargs_torch.utils.testing import one_torch_thread
from test_waymo_dynamic import N, _make_bundle


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


INIT_SAMPLES = 4000
MODEL = dict(feat_dim=8, n_offsets=2, mlp_hidden=8, anchor_capacity=4096)
RASTER = dict(max_visible=4096, max_tiles_per_gaussian=8, tile_capacity=64, chunk=8)
OPT = dict(start_stat=0)
VOXEL = 2.0


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dynamic"))
    _make_bundle(root)
    return root


@pytest.fixture(scope="module")
def subscenes(bundle):
    """Each package's read_dynamic_scene of the bundle."""
    js, jm = jwd.read_dynamic_scene(bundle, init_samples=INIT_SAMPLES)
    ts, tm = twd.read_dynamic_scene(bundle, init_samples=INIT_SAMPLES, device="cpu")
    return js, jm, ts, tm


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_kabsch_equals_jax():
    rng = np.random.default_rng(1)
    x1 = rng.normal(size=(30, 3))
    x2 = x1 @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(size=3)
    w = rng.uniform(0.1, 1.0, 30)
    for weights in (None, w):
        for a, b in zip(twd.kabsch(x1, x2, weights), jwd.kabsch(x1, x2, weights)):
            np.testing.assert_array_equal(a, b)


def test_scene_bookkeeping_equals_jax(subscenes):
    js, _, ts, _ = subscenes
    assert ts.dynamic_object_ids() == js.dynamic_object_ids() == ["car_1"]
    assert ts.dynamic_object_counter == js.dynamic_object_counter
    assert ts.object_id_2_type == js.object_id_2_type
    np.testing.assert_array_equal(ts.beam_inclinations, js.beam_inclinations)
    np.testing.assert_array_equal(ts.object_aabb("car_1"), js.object_aabb("car_1"))
    for f in (0, 7, N - 1):
        np.testing.assert_array_equal(ts.static_mask(f), js.static_mask(f))
        for a, b in zip(ts.masks_for_object(f, "car_1"), js.masks_for_object(f, "car_1")):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ts.range_view_gt(f), js.range_view_gt(f))
        np.testing.assert_array_equal(ts.l2w[f], js.l2w[f])
        np.testing.assert_array_equal(ts.object_to_world(f, "car_1"),
                                      js.object_to_world(f, "car_1"))


def _close_points(got, want):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.linalg.norm(got - want, axis=1)
    assert (err <= 1e-6 * np.linalg.norm(want, axis=1)).all(), err.max()


def test_points_equal_jax(subscenes):
    """The back-projected clouds of a frame: equal counts (so the init
    sample draws the same indices) and points within 1e-6 of their norm."""
    js, _, ts, _ = subscenes
    for f in (0, 13, N - 1):
        _close_points(ts.static_points_world(f, "cpu"), js.static_points_world(f))
        _close_points(ts.object_points_canonical(f, f, "car_1", "cpu"),
                      js.object_points_canonical(f, f, "car_1"))


def test_subscenes_equal_jax(subscenes):
    _, jm, _, tm = subscenes
    assert [m.model_id for m in tm] == [m.model_id for m in jm] == [twd.STATIC, "car_1"]
    for t, j in zip(tm, jm):
        np.testing.assert_array_equal(t.beams, j.beams)
        assert len(t.train_frames) == len(j.train_frames) == N - 4
        assert len(t.test_frames) == len(j.test_frames) == 4
        for ft, fj in zip(t.train_frames + t.test_frames, j.train_frames + j.test_frames):
            assert int(ft.uid) == int(fj.uid)
            for name in ("w2s_rot", "w2s_trans", "center", "beams", "gt_image", "pixel_mask"):
                np.testing.assert_array_equal(_np(getattr(ft, name)),
                                              np.asarray(getattr(fj, name)), err_msg=name)
        assert t.init_points.dtype == torch.float32 and t.init_points.device.type == "cpu"
        _close_points(t.init_points, j.init_points)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _relnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def jax_step():
    return jax.jit(functools.partial(jt.train_step, bg=jnp.zeros((2,), jnp.float32),
                                     mcfg=JM(**MODEL), rcfg=JR(**RASTER), ocfg=JO(**OPT)))


@pytest.mark.parametrize("model", [0, 1], ids=["background", "car"])
def test_masked_steps_match_jax(subscenes, jax_step, model):
    """Two masked steps of a sub-scene, each from JAX's state carried
    across: the same losses, gradients and parameters."""
    _, jm, _, tm = subscenes
    jmd, tmd = jm[model], tm[model]
    field = jf.init_field_from_points(jax.random.key(0), JM(**MODEL), jmd.init_points,
                                      voxel_size=VOXEL)
    jstate = jax.tree.map(np.asarray, jt.init_train_state(field, JM(**MODEL)))
    n_compared = 0
    for i in range(2):
        jfr, tfr = jmd.train_frames[i], tmd.train_frames[i]
        assert tfr.pixel_mask is not None and bool(tfr.pixel_mask.any())
        assert not bool(tfr.pixel_mask.all())
        tstate = train_state_from_jax(jstate, device="cpu")
        js1, jmet = jax_step(jax.tree.map(jnp.asarray, jstate), jfr)
        js1 = jax.tree.map(np.asarray, js1)
        ts1, tmet = tt.train_step(tstate, tfr, torch.zeros(2), TM(**MODEL), TR(**RASTER),
                                  TO(**OPT))
        for f in jmet.loss._fields:
            np.testing.assert_allclose(float(getattr(tmet.loss, f)), float(getattr(jmet.loss, f)),
                                       rtol=1e-5, atol=1e-9, err_msg=f)
        assert int(tmet.n_visible) > 0
        lr_max = 0.008                       # the largest rate in OptConfig's defaults
        for (path, m0), (_, mj), (_, mt), (_, pj), (_, pt) in zip(
                _leaves(jstate.opt.mu), _leaves(js1.opt.mu), _leaves(ts1.opt.mu),
                _leaves(js1.params), _leaves(ts1.params)):
            # this step's gradient, from the first moment mu' = 0.9 mu + 0.1 g
            gj = (np.asarray(mj, np.float64) - 0.9 * np.asarray(m0, np.float64)) / 0.1
            gt = (mt.numpy().astype(np.float64) - 0.9 * np.asarray(m0, np.float64)) / 0.1
            pt = pt.numpy()
            if np.abs(gj).max() == 0:
                np.testing.assert_array_equal(gt, 0.0, err_msg=path)
                continue
            assert _relnorm(gt, gj) <= 1e-4, (i, path, _relnorm(gt, gj))
            above = np.abs(gj) > 1e-3 * np.abs(gj).max()
            np.testing.assert_allclose(pt[above], pj[above], rtol=1e-6, atol=1e-6, err_msg=path)
            assert np.abs(pt - pj).max() <= 2 * lr_max + 1e-6, path
            n_compared += int(above.sum())
        jstate = js1
    assert n_compared > 1000


def _wall_last_bundle(root):
    """The JAX test's bundle with the car listed last in every frame (and
    its pixels' per-frame index 1, the wall's 0)."""
    _make_bundle(root)
    ids = np.empty((N, 2), dtype=object)
    ids[:] = ["wall_1", "car_1"]
    np.save(f"{root}/object_ids_per_frame.npy", ids)
    np.save(f"{root}/objects_id_types_per_frame.npy", np.array([[3, 1]] * N, dtype=object))
    idx = np.load(f"{root}/ray_object_indices.npy")
    car, wall = idx == 0, idx == 1
    idx[car], idx[wall] = 1, 0
    np.save(f"{root}/ray_object_indices.npy", idx)


def test_background_ray_reads_the_last_listed_object(tmp_path):
    """With a dynamic vehicle listed last, a background ray (index -1) reads
    it: the JAX package's static mask keeps only the wall, and the car's
    mask takes every background pixel. The port gives the same masks."""
    root = str(tmp_path)
    _wall_last_bundle(root)
    js, ts = jwd.WaymoDynamicScene(root), twd.WaymoDynamicScene(root)
    idx = js.ray_object_indices[0]
    base = js.first_masks[0] & js.valid_normal_flag[0]
    for sc in (js, ts):
        static, car = sc.masks_for_object(0, "car_1")
        np.testing.assert_array_equal(sc.static_mask(0), base & (idx == 0))
        np.testing.assert_array_equal(car, base & (idx != 0))
        np.testing.assert_array_equal(static, base & (idx == 0))
    for f in range(0, N, 7):
        np.testing.assert_array_equal(ts.static_mask(f), js.static_mask(f))
        for a, b in zip(ts.masks_for_object(f, "car_1"), js.masks_for_object(f, "car_1")):
            np.testing.assert_array_equal(a, b)


def test_appearance_index_beyond_the_cameras_is_clamped(subscenes):
    """A vehicle sub-scene's frame uid is its bundle frame index (up to 49),
    while a field trained on it has one appearance row per train frame (46).
    JAX's gather clamps the index to the last row; the port gives the same
    decoded gaussians and trains on such a frame."""
    _, jm, _, tm = subscenes
    jcar, tcar = jm[1], tm[1]
    mcfg = dict(MODEL, appearance_dim=4, feat_dim=16)
    n_cam = len(jcar.train_frames)
    field = jf.init_field_from_points(jax.random.key(1), JM(**mcfg), jcar.init_points,
                                      voxel_size=VOXEL, num_cameras=n_cam)
    params = jax.tree.map(np.asarray, field.params)
    assert params["appearance"].shape[0] == n_cam == 46
    frame = tcar.train_frames[-1]
    uid = int(frame.uid)
    assert uid == N - 1 >= n_cam
    center = np.asarray(jcar.train_frames[-1].center)
    valid, vis = np.asarray(field.valid), np.ones(MODEL["anchor_capacity"], bool)
    # the JAX package's step runs under jit, where the gather clamps
    dec_j = lambda u: jax.jit(lambda p, c: jf.generate_neural_gaussians(
        p, valid, vis, center, JM(**mcfg), cam_uid=c))(field.params, jnp.int32(u))
    jg = dec_j(uid)
    np.testing.assert_array_equal(np.asarray(jg.feat), np.asarray(dec_j(n_cam - 1).feat))
    assert not np.array_equal(np.asarray(jg.feat), np.asarray(dec_j(n_cam - 2).feat))
    tparams = params_from_jax(params, device="cpu")
    tg = tf.generate_neural_gaussians(tparams, torch.tensor(valid), torch.tensor(vis),
                                      torch.tensor(center), TM(**mcfg), cam_uid=frame.uid)
    np.testing.assert_allclose(tg.feat.numpy(), np.asarray(jg.feat), rtol=1e-5, atol=1e-6)
    tstate = tt.init_train_state(tf.AnchorField(params=tparams, valid=torch.tensor(valid),
                                                voxel_size=VOXEL), TM(**mcfg))
    _, grads, _ = tt.loss_and_grads(tstate, frame, torch.zeros(2), TM(**mcfg), TR(**RASTER),
                                    TO(**OPT))
    rows = grads["appearance"].abs().sum(1)
    assert float(rows[n_cam - 1]) > 0 and float(rows[:n_cam - 1].abs().sum()) == 0


def test_parquet_calibration_and_its_missing_reader(bundle, tmp_path, monkeypatch):
    """The parquet calibration wins over beam_inclinations.npy, as in the JAX
    package; without pandas the port raises and names the .npy file."""
    import builtins
    import shutil

    import pandas as pd

    root = tmp_path / "ctx"
    shutil.copytree(bundle, root)
    beams = np.linspace(-0.3, 0.05, 8)
    col = "[LiDARCalibrationComponent].beam_inclination.values"
    pd.DataFrame({col: [list(beams * (i + 1)) for i in range(6)]}).to_parquet(
        root / "training_lidar_calibration.parquet", engine="pyarrow")
    got = twd.WaymoDynamicScene(str(root)).beam_inclinations
    np.testing.assert_array_equal(got, jwd.WaymoDynamicScene(str(root)).beam_inclinations)
    np.testing.assert_array_equal(got, beams * 5)
    real_import = builtins.__import__

    def no_pandas(name, *a, **k):
        if name == "pandas":
            raise ImportError("No module named 'pandas'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pandas)
    with pytest.raises(ImportError, match="beam_inclinations.npy"):
        twd.WaymoDynamicScene(str(root))


def test_entry_points_default_to_the_card(bundle):
    """The reader and the scene helper make tensors on the card unless told
    otherwise, and raise rather than fall back where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from lidargs_torch.utils.testing import make_scene, scene_splats

    with pytest.raises(RuntimeError, match="device='cpu'"):
        twd.read_dynamic_scene(bundle, init_samples=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        twd.WaymoDynamicScene(bundle).static_points_world(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scene_splats(make_scene(seed=0, n=8, H=8, W=64), TR())
