"""The port's data layer against the JAX package's: range-view transforms,
PLY and npz files across the two packages, the procedural datasets, the
scene reader and the field built from a point cloud.

Tolerances: the pano transforms agree to 1e-6 (both float64); files written
by one package read back equal in the other, and the same inputs write the
same bytes; the reader's frames are equal and its init points agree to 1e-6
relative (JAX's reader back-projects through the native helper in float32,
the port in float64); the field's anchors, `valid` and voxel dedup are
equal (including points on exact half-voxel ties), its scales within 1e-5
and its voxel size within 1e-6 relative.
"""
import json
import os

import numpy as np
import pytest
import torch

from lidargs_tpu.data import ply as jply
from lidargs_tpu.data import synthetic as jsyn
from lidargs_tpu.data.waymo import read_lidar_scene as j_read
from lidargs_tpu.lidar import pano as jpano
from lidargs_tpu.models import field as jfield
from lidargs_tpu.native import voxel_unique
from lidargs_tpu.config import ModelConfig as JModelConfig
from lidargs_tpu.train.trainer import init_train_state as j_init_state
from lidargs_tpu.utils import serialization as jser
from lidargs_torch.config import ModelConfig
from lidargs_torch.data import ply as tply
from lidargs_torch.data import synthetic as tsyn
from lidargs_torch.data.waymo import KITTI_TEST_IDX, WAYMO_TEST_IDX
from lidargs_torch.data.waymo import read_lidar_scene as t_read
from lidargs_torch.lidar import pano as tpano
from lidargs_torch.models.field import init_field_from_points, voxelize_points
from lidargs_torch.utils import serialization as tser
from lidargs_torch.utils.testing import one_torch_thread
from test_data_cli import _make_dataset


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def waymo_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo")
    _make_dataset(str(root))                  # 8x128, 50 frames, 46 train / 4 test
    return root


def _kitti(root):
    """The waymo fixture relabelled as KITTI: `transforms_kitti_*.json`, no
    beam table (the reader then uses the KITTI default), test frames at
    13, 26 and 39."""
    meta = json.loads((root / "transforms_train.json").read_text())
    test = json.loads((root / "transforms_test.json").read_text())
    frames = sorted(meta["frames"] + test["frames"], key=lambda f: f["file_path"])
    del meta["beam_inclinations"]
    kroot = root.parent / "kitti"
    kroot.mkdir(exist_ok=True)
    os.symlink(root / "lidar", kroot / "lidar")
    split = {False: [], True: []}
    for i, f in enumerate(frames):
        split[i in KITTI_TEST_IDX].append(f)
    (kroot / "transforms_kitti_train.json").write_text(json.dumps({**meta, "frames": split[False]}))
    (kroot / "transforms_kitti_test.json").write_text(json.dumps({**meta, "frames": split[True]}))
    return kroot


# --- range-view transforms ---

def _pano(seed, H=16, W=64):
    rng = np.random.default_rng(seed)
    beams = np.sort(rng.uniform(-0.4, 0.12, H))
    depth = rng.uniform(1.0, 70.0, (H, W))
    depth[rng.uniform(size=(H, W)) < 0.3] = 0.0
    return beams, depth, rng.uniform(size=(H, W))


@pytest.mark.parametrize("seed", [0, 1])
def test_pano_transforms_match_jax(seed):
    beams, depth, inten = _pano(seed)
    H, W = depth.shape
    angles = np.concatenate([np.linspace(-0.6, 0.3, 50), beams, 0.5 * (beams[1:] + beams[:-1])])
    np.testing.assert_array_equal(tpano.find_closest_beam(beams, angles).numpy(),
                                  jpano.find_closest_beam(beams, angles))
    np.testing.assert_allclose(tpano.ray_dirs_from_beams(H, W, beams).numpy(),
                               jpano.ray_dirs_from_beams(H, W, beams), atol=1e-6)
    got = tpano.pano_to_lidar_with_intensities(torch.from_numpy(depth), inten, beams).numpy()
    want = jpano.pano_to_lidar_with_intensities(depth, inten, beams)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(tpano.pano_to_lidar(depth, lidar_K=(2.0, 26.9)).numpy(),
                               jpano.pano_to_lidar(depth, lidar_K=(2.0, 26.9)), atol=1e-6)
    # back to a panorama (z-buffer: the nearest point of a pixel wins)
    rng = np.random.default_rng(seed + 10)
    pts = np.concatenate([want, np.c_[rng.normal(0, 30, (300, 3)), rng.uniform(size=300)]])
    for kw in (dict(beam_inclinations=beams), dict(lidar_K=(2.0, 26.9))):
        g = tpano.lidar_to_pano_with_intensities(pts, H, W, **kw)
        w = jpano.lidar_to_pano_with_intensities(pts, H, W, **kw)
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6)


# --- files across the packages ---

def _anchor_rows(n=40, k=3, F=8, seed=1):
    rng = np.random.default_rng(seed)
    shapes = ((n, 3), (n, k, 3), (n, F), (n, 6), (n, 4), (n, 1))
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def test_ply_files_cross_packages(tmp_path):
    pts = np.random.default_rng(0).uniform(-10, 10, (100, 3)).astype(np.float32)
    rows = _anchor_rows()
    for writer, reader, tag in ((tply, jply, "t"), (jply, tply, "j")):
        writer.write_point_cloud(str(tmp_path / f"{tag}.ply"), pts)
        np.testing.assert_array_equal(reader.read_point_cloud(str(tmp_path / f"{tag}.ply")), pts)
        writer.write_anchor_model(str(tmp_path / f"{tag}_a.ply"), *rows)
        for got, want in zip(reader.read_anchor_model(str(tmp_path / f"{tag}_a.ply")), rows):
            np.testing.assert_array_equal(got, want)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    assert (tmp_path / "t_a.ply").read_bytes() == (tmp_path / "j_a.ply").read_bytes()


def _states(n_points=300):
    """The same training state in both packages: JAX's from its field,
    the port's as its own tree with JAX's values."""
    import jax

    from lidargs_torch.utils.params import train_state_from_jax

    rng = np.random.default_rng(2)
    mcfg = JModelConfig(voxel_size=2.0, anchor_capacity=512)
    pts = rng.uniform(-20, 20, (n_points, 3)).astype(np.float32)
    jfld = jfield.init_field_from_points(jax.random.key(0), mcfg, pts)
    js = j_init_state(jfld, mcfg)
    js = js._replace(step=js.step + 7, opt=js.opt._replace(count=js.opt.count + 7),
                     offset_denom=js.offset_denom + 3.0)
    host = jax.tree.map(np.asarray, js)
    return js, train_state_from_jax(host, device="cpu"), host


def test_checkpoints_cross_packages(tmp_path):
    """A full TrainState npz written by either package loads in the other,
    every leaf equal, with JAX's key paths."""
    import jax

    js, ts, host = _states()
    jser.save_pytree_npz(str(tmp_path / "j.npz"), js)
    tser.save_pytree_npz(str(tmp_path / "t.npz"), ts)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert set(a.files) == set(b.files)
        assert {"params/anchor", "params/mlp_cov/l1/w", "opt/mu/anchor", "opt/count",
                "valid", "step"} <= set(a.files)
    zero = jax.tree.map(torch.zeros_like, ts)
    back = tser.load_pytree_npz(str(tmp_path / "j.npz"), zero)
    for (k, got), (_, want) in zip(tser.tree_paths(back), tser.tree_paths(ts)):
        assert got.dtype == want.dtype and torch.equal(got, want), k
    jback = jser.load_pytree_npz(str(tmp_path / "t.npz"), jax.tree.map(np.zeros_like, host))
    for got, want in zip(jax.tree.leaves(jback), jax.tree.leaves(host)):
        np.testing.assert_array_equal(got, want)
    assert int(back.step) == 7 and back.valid.dtype == torch.bool
    with pytest.raises(KeyError, match="missing leaf"):
        tser.load_pytree_npz(str(tmp_path / "t.npz"), {"nope": torch.zeros(1)})


@pytest.mark.parametrize("maker", ["make_world_dataset", "make_street_dataset"])
def test_synthetic_datasets_write_jax_files(tmp_path, maker):
    kw = dict(n_frames=4, H=8, W=96, seed=3)
    getattr(tsyn, maker)(str(tmp_path / "t"), **kw)
    getattr(jsyn, maker)(str(tmp_path / "j"), **kw)
    names = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*.*"))
    assert len(names) == 6
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n


# --- the reader ---

@pytest.mark.parametrize("label", ["waymo", "kitti"])
def test_reader_matches_jax(waymo_root, label):
    root = waymo_root if label == "waymo" else _kitti(waymo_root)
    j = j_read(str(root), label, num_frames=50, init_samples=20_000, seed=3)
    t = t_read(str(root), label, num_frames=50, init_samples=20_000, seed=3, device="cpu")
    assert (t.H, t.W, t.data_name) == (j.H, j.W, j.data_name) == (8, 128, label)
    np.testing.assert_array_equal(t.beam_inclinations, j.beam_inclinations)
    n_test = len(WAYMO_TEST_IDX if label == "waymo" else KITTI_TEST_IDX)
    assert len(t.test_frames) == len(j.test_frames) == n_test
    assert len(t.train_frames) == len(j.train_frames) == 50 - n_test
    for tf, jf in zip(t.train_frames + t.test_frames, j.train_frames + j.test_frames):
        for name in ("w2s_rot", "w2s_trans", "center", "beams", "gt_image", "uid"):
            np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)))
    got, want = t.init_points.numpy(), j.init_points
    assert got.dtype == np.float32 and got.shape == want.shape == (20_000, 3)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


# --- the field from a point cloud ---

def test_voxel_dedup_matches_native_on_ties():
    """Points on exact half-voxel ties and either side of them: the port
    rounds points * (1/voxel) half to even, as the native dedup does, and
    orders the rows lexicographically."""
    rng = np.random.default_rng(4)
    voxel = 0.25
    cells = rng.integers(-40, 40, (3000, 3)).astype(np.float64)
    pts = np.concatenate([(cells + 0.5) * voxel, cells * voxel + 1e-9,
                          (cells - 0.5) * voxel - 1e-9, rng.uniform(-10, 10, (3000, 3))])
    np.testing.assert_array_equal(voxelize_points(pts, voxel).numpy(), voxel_unique(pts, voxel))
    np.testing.assert_array_equal(voxelize_points(pts, 0.1).numpy(), voxel_unique(pts, 0.1))


@pytest.mark.parametrize("voxel", [0.0, 0.5])
def test_init_field_from_points_matches_jax(voxel):
    """The same points through both packages' `init_field_from_points`.
    Voxel 0 takes the median 3-NN estimate, on points of an integer grid
    (where the Gram form is exact in float32, so both medians are the same
    number); voxel 0.5 has points on its half-voxel ties."""
    import jax

    rng = np.random.default_rng(6)
    if voxel == 0.0:
        pts = rng.integers(-20, 20, (2000, 3)).astype(np.float32)
    else:
        pts = np.concatenate([rng.uniform(-20, 20, (1500, 3)),
                              (rng.integers(-30, 30, (500, 3)) + 0.5) * 0.5]).astype(np.float32)
    jcfg = JModelConfig(voxel_size=voxel, anchor_capacity=2048, ratio=2)
    tcfg = ModelConfig(voxel_size=voxel, anchor_capacity=2048, ratio=2)
    j = jfield.init_field_from_points(jax.random.key(0), jcfg, pts, num_cameras=3)
    t = init_field_from_points(tcfg, torch.from_numpy(pts), num_cameras=3,
                               generator=torch.Generator().manual_seed(0), device="cpu")
    assert t.voxel_size == pytest.approx(j.voxel_size, rel=1e-6)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    n = int(t.valid.sum())
    assert 0 < n < 2048
    np.testing.assert_array_equal(t.params["anchor"].numpy(), np.asarray(j.params["anchor"]))
    np.testing.assert_allclose(t.params["scaling"].numpy(), np.asarray(j.params["scaling"]),
                               atol=1e-5)
    for name in ("opacity", "rotation", "offset", "feat"):
        np.testing.assert_array_equal(t.params[name].numpy(), np.asarray(j.params[name]))
    assert set(t.params) == set(j.params)
    with pytest.raises(ValueError, match="exceed capacity"):
        init_field_from_points(ModelConfig(voxel_size=0.01, anchor_capacity=64), pts,
                               device="cpu")
