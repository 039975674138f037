"""The port's evaluation metrics against the JAX package's, and its render
entry points (`measure_fps`, `run_eval`) on the CPU.

The metrics are numpy/scipy code in both packages, fed the same float32
images: they must agree to 1e-9 (float64 sums, same order). The chamfer
distance sums float32 distances in another order: 1e-5 relative; the
F-score flips only for points within 1e-3 m^2 of tau.
"""
import json

import numpy as np
import pytest
import torch

from lidargs_tpu.train import metrics as jm
from lidargs_torch.config import ModelConfig, RasterConfig
from lidargs_torch.lidar import LidarFrame, uniform_beam_inclinations
from lidargs_torch.train import evaluate_frame, mean_metrics, measure_fps, run_eval
from lidargs_torch.train.metrics import eval_ssim
from lidargs_torch.utils.stage_split import counting
from lidargs_torch.utils.testing import one_torch_thread, sensor_poses, shell_field


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


def _images(seed, H=16, W=64):
    rng = np.random.default_rng(seed)
    color = rng.uniform(size=(2, H, W)).astype(np.float32)
    depth = rng.uniform(0.0, 90.0, (H, W)).astype(np.float32)
    gt = np.stack([(rng.uniform(size=(H, W)) > 0.3).astype(np.float32),
                   rng.uniform(size=(H, W)), rng.uniform(1.0, 85.0, (H, W))]).astype(np.float32)
    return color, depth, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    """With default arguments both packages return the same keys, the depth
    chamfer distance and F-score among them (the JAX default)."""
    color, depth, gt = _images(seed)
    beams = uniform_beam_inclinations(2.4, 20.9, 16)
    j = jm.evaluate_frame(color, depth, gt, beams)
    t = evaluate_frame(torch.from_numpy(color), torch.from_numpy(depth), gt, beams)
    assert set(t) == set(j) and {"depth_cd", "depth_fscore"} <= set(t)
    for k in set(j) - {"depth_cd", "depth_fscore"}:
        assert t[k] == pytest.approx(j[k], rel=1e-9, abs=1e-12), k
    assert t["depth_cd"] == pytest.approx(j["depth_cd"], rel=1e-5)
    assert t["depth_fscore"] == pytest.approx(j["depth_fscore"], abs=1e-3)
    no_cd = evaluate_frame(color, depth, gt, beams, compute_chamfer=False)
    assert set(no_cd) == set(j) - {"depth_cd", "depth_fscore"}
    assert eval_ssim(color[0], gt[1]) == pytest.approx(jm.eval_ssim(color[0], gt[1]), abs=1e-12)
    per = [t, evaluate_frame(*_images(seed + 5)[:2], gt, beams)]
    assert mean_metrics(per) == pytest.approx(jm.mean_metrics(per))


def _scene(n_frames=3, H=8, W=256):
    mcfg = ModelConfig(anchor_capacity=1024)
    rcfg = RasterConfig(tile_h=4, tile_capacity=64, max_tiles_per_gaussian=8,
                        max_visible=4096)
    params, valid = shell_field(mcfg, 800, seed=0, device="cpu")
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    frames = [LidarFrame.from_lidar2world(p, beams, np.zeros((3, H, W), np.float32), uid=i,
                                          device="cpu")
              for i, p in enumerate(sensor_poses(n_frames, seed=1))]
    return mcfg, rcfg, params, valid, frames


def test_measure_fps_and_run_eval_on_cpu(tmp_path):
    mcfg, rcfg, params, valid, frames = _scene()
    bg = torch.zeros(2)
    with counting() as n:
        res = measure_fps(params, valid, frames, mcfg, rcfg, bg, warmup=1, device="cpu")
    assert not any(n.values())                   # the CPU path launches no kernel
    assert res.fps > 0 and len(res.seconds) == len(res.outputs) == 3
    assert all(tuple(o.color.shape) == (2, 8, 256) for o in res.outputs)
    assert all(float(o.occ.mean()) > 0 for o in res.outputs)
    with pytest.raises(ValueError, match="warmup"):
        measure_fps(params, valid, frames, mcfg, rcfg, bg, warmup=3, device="cpu")

    # ground truth made from frame 0's render: the re-render scores exactly
    o0 = res.outputs[0]
    gt = torch.stack([(o0.color[1] > 0.5).float(), o0.color[0].clamp(0, 1),
                      o0.depth.clamp(5.0, 80.0)]).numpy()
    fr = LidarFrame.from_lidar2world(sensor_poses(3, seed=1)[0], frames[0].beams.numpy(), gt,
                                     device="cpu")
    out = run_eval(params, valid, {"test": [fr], "train": frames[1:], "empty": []}, mcfg,
                   rcfg, bg, str(tmp_path), device="cpu")
    assert out["test"]["intensity_l1"] == 0.0 and out["test"]["raydrop_acc"] == 1.0
    assert out["test"]["depth_mae"] == 0.0
    assert out["test"]["visible_count"] == float(o0.visible.sum())
    assert "empty" not in out and set(out["per_view_train"]) == {"00000", "00001"}
    saved = json.loads((tmp_path / "results.json").read_text())
    assert set(saved) == {"test", "train"}
    assert saved["train"] == pytest.approx(out["train"])
    per_view = json.loads((tmp_path / "per_view.json").read_text())
    assert set(per_view) == {"per_view_test", "per_view_train"}
