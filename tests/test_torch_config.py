"""The port's configuration, beam tables, frames and import boundary against
the JAX package."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lidargs_tpu.config as jcfg
import lidargs_torch.config as tcfg
from lidargs_tpu.lidar import beams as jbeams
from lidargs_tpu.lidar.frames import LidarFrame as JFrame
from lidargs_torch.lidar import beams as tbeams
from lidargs_torch.lidar.frames import LidarFrame as TFrame
from lidargs_torch.utils.testing import one_torch_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


ROOT = Path(__file__).resolve().parents[1]
PALLAS_ONLY = {"pallas_chunk", "pallas_tiles_per_block", "backend"}


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = f.default_factory()
    return out


@pytest.mark.parametrize("name", ["RasterConfig", "ModelConfig", "OptConfig", "LrSchedule",
                                  "DataConfig", "ParallelConfig"])
def test_shared_defaults_equal(name):
    j = _defaults(getattr(jcfg, name))
    t = _defaults(getattr(tcfg, name))
    dropped = PALLAS_ONLY if name == "RasterConfig" else set()
    assert set(j) - set(t) == dropped
    assert set(t) <= set(j)
    for k, v in t.items():
        jv = j[k]
        if dataclasses.is_dataclass(v):           # an LrSchedule of OptConfig
            assert type(v).__name__ == type(jv).__name__
            v, jv = dataclasses.asdict(v), dataclasses.asdict(jv)
        assert v == jv, f"{name}.{k}: port {v!r} != JAX {jv!r}"


def test_grid_shape_and_replace():
    for th in (1, 2, 4, 8):
        j = jcfg.RasterConfig(tile_h=th)
        t = tcfg.RasterConfig(tile_h=th)
        for H, W in ((64, 2650), (32, 256), (17, 129)):
            assert t.grid_shape(H, W) == j.grid_shape(H, W)
            assert t.num_tiles(H, W) == j.num_tiles(H, W)
    r = tcfg.replace(tcfg.RasterConfig(), tile_capacity=768)
    assert r.tile_capacity == 768 and r.tile_h == 1


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax_statically():
    files = sorted((ROOT / "lidargs_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lidargs_tpu"), f"{f}: imports {mod}"


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, importlib, pkgutil, torch, lidargs_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(lidargs_torch.__path__, 'lidargs_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'lidargs_tpu'))\n"
        "assert not bad, bad\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("args", [(2.4, 20.9, 64), (12.0, 24.0, 32), (2.0, 26.9, 66)])
def test_beam_tables_equal(args):
    np.testing.assert_array_equal(tbeams.uniform_beam_inclinations(*args),
                                  jbeams.uniform_beam_inclinations(*args))
    np.testing.assert_array_equal(tbeams.helios_beam_inclinations(),
                                  jbeams.helios_beam_inclinations())


def test_frame_from_lidar2world_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    l2w = np.eye(4)
    l2w[:3, :3] = Q
    l2w[:3, 3] = rng.normal(size=3)
    beams = tbeams.uniform_beam_inclinations(2.4, 20.9, 8)
    gt = rng.uniform(size=(3, 8, 32)).astype(np.float32)
    mask = rng.uniform(size=(8, 32)) > 0.5
    j = JFrame.from_lidar2world(l2w, beams, gt, uid=3, pixel_mask=mask)
    t = TFrame.from_lidar2world(l2w, beams, gt, uid=3, pixel_mask=mask, device="cpu")
    for name in ("w2s_rot", "w2s_trans", "center", "beams", "gt_image", "uid", "pixel_mask"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    assert (t.H, t.W) == (j.H, j.W) == (8, 32)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(t.transform_to_sensor(torch.from_numpy(pts)).numpy(),
                               np.asarray(j.transform_to_sensor(pts)), atol=1e-6)
    moved = t.to("cpu")
    assert moved.device == torch.device("cpu") and moved.uid.dtype == torch.int32


def test_entry_points_raise_without_a_card():
    """Entry points default to the card and raise, rather than fall back to
    the CPU, when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from lidargs_torch.models.field import init_field_params

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_field_params(tcfg.ModelConfig(anchor_capacity=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TFrame.from_lidar2world(np.eye(4), np.zeros(4), np.zeros((3, 4, 8)))
