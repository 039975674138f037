"""Each frozen copy in the benchmark held to its source in the port (or in
`chip_smoke.py`) as they stand, at small shapes."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, counts, rows, scene, tracing
from portbench.run import make_inputs
from portbench.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 5


def test_street_matches_make_street_dataset(tmp_path):
    from lidargs_torch.data.synthetic import make_street_dataset

    H, W, n = 8, 96, 5
    make_street_dataset(str(tmp_path), n_frames=n, H=H, W=W, seed=SEED)
    meta = json.loads((tmp_path / "transforms_train.json").read_text())
    sc = make_scene(SEED, H, W, n)
    for i, (pose, gt) in enumerate(sc.train):
        rv = np.load(tmp_path / meta["frames"][i]["lidar_file_path"])
        np.testing.assert_allclose(gt[2].numpy(), rv[:, :, 2], rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(gt[1].numpy(), np.clip(rv[:, :, 1], 0, 1), atol=1e-5)
        l2w = np.asarray(meta["frames"][i]["lidar2world"])
        np.testing.assert_allclose(pose.center.numpy(), l2w[:3, 3], atol=1e-6)
    np.testing.assert_array_equal(sc.beams.numpy(), np.asarray(meta["beam_inclinations"],
                                                               np.float32))


def make_scene(seed, H, W, n):
    return scene.make_scene(seed, {"H": H, "W": W, "fov_up_deg": 3.0, "fov_deg": 25.0},
                            {"frames": n, "test_frames": [], "init_points": 500,
                             "frame_spacing_m": 0.6, "sensor_height_m": 2.0}, CPU)


def test_voxelize_and_scales_match_the_port():
    from lidargs_torch.models.field import voxelize_points
    from lidargs_torch.ops.knn import knn3_mean_sq_dist

    pts = make_scene(SEED, 8, 96, 3).init_points
    got = scene.voxelize(pts, 0.3)
    torch.testing.assert_close(got, voxelize_points(pts, 0.3), rtol=0, atol=0)
    a = got.to(torch.float32)
    torch.testing.assert_close(scene.knn3_mean_sq(a, rows=64), knn3_mean_sq_dist(a),
                               rtol=0, atol=0)


def test_walked_pairs_match_chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    for name in ("beam-train-street", "surfel-train-street"):
        cell = tiny_cell(name)
        inputs = make_inputs(cell, SEED, CPU)
        probe = {}
        mcfg, rcfg, _ = check.ref_configs(cell.config)
        pose, gt = inputs.scene.train[0]
        with torch.no_grad():
            check.render(inputs.params, inputs.valid, check.ref_frame(pose, gt, inputs.scene.beams),
                         mcfg, rcfg, torch.zeros(2), cell.config["variant"], probe)
        tl = probe["lists"]
        ours = (counts.walked_pairs if name.startswith("beam") else counts.walked_surfel_pairs)(
            tl.inst, tl.counts, tl.pix, 2, rcfg)
        theirs = (chip_smoke.walked_pairs if name.startswith("beam")
                  else chip_smoke.walked_surfel_pairs)(tl.inst, tl.counts, tl.pix, 2, rcfg)
        assert ours == tuple(theirs[:4]) and ours[0] > 0
        assert counts.tile_bytes(tl.counts, ours[3], 22, tl.pix, 7) == chip_smoke.tile_bytes(
            tl.counts, ours[3], 22, tl.pix, 7)
    assert (counts.PEAK_BYTES_PER_S, counts.PEAK_FP32_OPS_PER_S) == (
        chip_smoke.PEAK_BYTES_PER_S, chip_smoke.PEAK_FP32_OPS_PER_S)
    assert (counts.OPS_IN_RECT, counts.OPS_OUT_RECT, counts.OPS_APPLIED_BWD) == (
        chip_smoke.OPS_IN_RECT, chip_smoke.OPS_OUT_RECT, chip_smoke.OPS_APPLIED_BWD)
    assert (counts.OPS_S_IN_RECT, counts.OPS_S_OUT_RECT, counts.OPS_S_FWD_APPLIED,
            counts.OPS_S_BWD_APPLIED) == (chip_smoke.OPS_S_IN_RECT, chip_smoke.OPS_S_OUT_RECT,
                                          chip_smoke.OPS_S_FWD_APPLIED,
                                          chip_smoke.OPS_S_BWD_APPLIED)


def test_row_counts_match_the_port_roofline():
    from types import SimpleNamespace

    from lidargs_torch.utils.roofline import build_stages

    model = tiny_cell("beam-train-street").config["model"]
    k = model["n_offsets"]
    args = SimpleNamespace(H=64, W=2650, tile_h=4, tile_w=128, tile_capacity=768, visible=1,
                           instances=1, anchors=1, n_offsets=k, packed_floats=24,
                           feat_dim=model["feat_dim"], mlp_hidden=model["mlp_hidden"])
    st = {s["name"]: s for s in build_stages(args)[0]}
    assert counts.decode_ops(model) == st["mlp decode (4 heads, 2 GEMMs)"]["ops"]
    assert counts.OPS_PROJECT * k == st["projection + pack"]["ops"]


def test_prefix_rows_match_the_port_prefixes():
    from lidargs_torch.models.field import AnchorField
    from lidargs_torch.train.trainer import init_train_state
    from lidargs_torch.utils.prefixes import grad_prefixes, stage_prefixes
    from portbench.drive import port_configs, port_frame

    cell = tiny_cell("beam-train-street")
    inputs = make_inputs(cell, SEED, CPU)
    mcfg, rcfg, ocfg = port_configs(cell.config)
    state = init_train_state(AnchorField(inputs.params, inputs.valid, inputs.voxel), mcfg)
    frame = port_frame(*inputs.scene.train[0], inputs.scene.beams, 0)
    bg = torch.zeros(2)
    fwd = rows.row_functions(state, frame, mcfg, rcfg, ocfg, bg, "beam", False)
    theirs = dict(stage_prefixes(mcfg, rcfg))
    assert torch.equal(fwd["project"](), theirs["project+pack"](inputs.params, inputs.valid, frame))
    # the port's gather prefix adds the counts and the overflow to the rows
    ours_g = fwd["gather"]()
    assert torch.isfinite(ours_g) and ours_g != 0
    grads = rows.row_functions(state, frame, mcfg, rcfg, ocfg, bg, "beam", True)
    g_theirs = dict(grad_prefixes(mcfg, rcfg, bg))["project+pack"](inputs.params, inputs.valid,
                                                                  frame)
    from lidargs_torch.train.optim import tree_leaves

    for a, b in zip(grads["grad project"](), tree_leaves(g_theirs[0]) + [g_theirs[1]]):
        assert torch.equal(a, b)
    assert set(grads) == {"grad project", "grad gather", "render", "+ loss", "+ grad", "+ adam"}


def test_trace_reduction():
    ev = [{"cat": "user_annotation", "name": tracing.WINDOW, "ts": 100.0, "dur": 100.0},
          {"cat": "kernel", "name": "a", "ts": 90.0, "dur": 20.0},
          {"cat": "kernel", "name": "b", "ts": 105.0, "dur": 10.0},
          {"cat": "gpu_memcpy", "name": "c", "ts": 150.0, "dur": 10.0},
          {"cat": "gpu_user_annotation", "name": "step", "ts": 100.0, "dur": 100.0},
          {"cat": "user_annotation", "name": "densify", "ts": 118.0, "dur": 30.0},
          {"cat": "kernel", "name": "a", "ts": 195.0, "dur": 20.0}]
    s = tracing.reduce_events(ev, 2)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((15 + 10 + 5) * 1e-6)
    assert s.seconds_by_name["a"] == pytest.approx(15e-6)
    assert s.n_ops == 4 and s.units == 2
    assert s.gaps[0][0] == "densify" and s.gaps[0][1] == pytest.approx(35e-6)
    assert tracing.reduce_events(ev[1:], 2) is None
