"""The forward surfel front as one kernel (`ops/front_kernel.py`
`surfel_front_packed`, kernel F2 of `csrc/surfel_front_fwd.cu`) and the
frame that runs it (`models/field.py` `render_surfel_packed`, chosen by
`frame_render` inside `train/graphs.py` `RenderGraphs`).

On the CPU (16x256 range view, feat 8, k = 2, hidden 32, 300 of 512 anchors):
  * `surfel_front_packed`'s plain version is the torch path: the rows of
    `field_surfels`, their depth column, valid and count, bit for bit;
  * a surfel frame through `RenderGraphs` (graphed and eager, with and
    without `fused_gather`) equals `render_field_surfel`'s on the same
    anchor rows, bit for bit;
  * the path follows the layout (`front_kernel.takes`): the cells' layout
    takes `render_surfel_packed`, the layouts F2 refuses `render_field_surfel`;
  * a surfel `Trainer.step` does not run the packed front, its render does;
  * `telemetry.fused_fronts` reads 0 on the CPU;
  * the wrapper refuses a device F2 does not run on, the frame a proxy, and
    `check_front_inputs` what F2 cannot take;
  * `surfel_front_agreement` finds a changed rect, float and valid row.

On a card (`cuda`), `surfel-render-street`'s field at its live extent
(B = 57,344): F2 against the torch surfel front on the card by
`utils/testing.py` `surfel_front_agreement` (FRONT_TOL), one F2 launch a
call; the rendered frame within the cell's check limits; graph replays
equal to eager frames bit for bit; one F2 launch a frame.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lidargs_torch.config import ModelConfig, OptConfig, RasterConfig
from lidargs_torch.lidar import LidarFrame, uniform_beam_inclinations
from lidargs_torch.models.field import (AnchorField, anchor_rows, field_surfels, frame_render,
                                        init_field_params, render_field_surfel,
                                        render_surfel_packed)
from lidargs_torch.ops import front_kernel
from lidargs_torch.ops.surfel import SurfelCols
from lidargs_torch.train import Trainer, graphs, init_train_state
from lidargs_torch.utils.profiling import telemetry
from lidargs_torch.utils.stage_split import counting
from lidargs_torch.utils.testing import (FRONT_TOL, one_torch_thread, sensor_poses,
                                         shell_field, surfel_front_agreement)

H, W = 16, 256
MODEL = dict(feat_dim=8, n_offsets=2, mlp_hidden=32, anchor_capacity=512)
RASTER = dict(tile_h=1, tile_capacity=64, max_tiles_per_gaussian=32, max_visible=2048, chunk=8)
B = 320                      # the anchor rows a frame runs on: the 300 live ones and padding


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


@pytest.fixture(autouse=True)
def _fresh_recorder():
    telemetry.disable()
    telemetry.fused_fronts = 0
    yield
    telemetry.disable()
    telemetry.rings.clear()
    telemetry.spans.clear()


def _frames(n: int, device="cpu") -> list:
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    gt = np.zeros((3, H, W), np.float32)
    return [LidarFrame.from_lidar2world(pose, beams, gt, uid=i, device=device)
            for i, pose in enumerate(sensor_poses(n, seed=2))]


def _field(mcfg: ModelConfig, n_cameras: int = 0):
    params, valid = shell_field(mcfg, 300, seed=0, device="cpu")
    if n_cameras:
        gen = torch.Generator().manual_seed(3)
        params.update({k: v for k, v in init_field_params(mcfg, n_cameras, gen, "cpu").items()
                       if k.startswith(("mlp_", "appearance"))})
    return params, valid


def _equal(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("pose", [0, 1, 2])
def test_plain_surfel_front_is_field_surfels(pose):
    mcfg, rcfg = ModelConfig(**MODEL), RasterConfig(**RASTER)
    params, valid = anchor_rows(*_field(mcfg), B)
    frame = _frames(3)[pose]
    C = mcfg.color_channel
    with torch.no_grad():
        pk, depth, vis, n_valid = front_kernel.surfel_front_packed(params, valid, frame, mcfg,
                                                                   rcfg)
        want = field_surfels(params, valid, frame, mcfg, rcfg)[0]
    assert torch.equal(pk, want)
    assert torch.equal(depth, want[:, SurfelCols.DEPTH])
    assert torch.equal(vis, want[:, SurfelCols.validf(C)] > 0.0)
    assert n_valid.dtype == torch.int64 and int(n_valid) == int(vis.sum()) > 0
    assert pk.shape == (B * mcfg.n_offsets, SurfelCols.width(C))


@pytest.mark.parametrize("graphed", [True, False])
@pytest.mark.parametrize("fused_gather", [False, True])
def test_surfel_frame_through_render_graphs_is_render_field_surfels(graphed, fused_gather):
    mcfg = ModelConfig(**MODEL)
    rcfg = RasterConfig(**{**RASTER, "fused_gather": fused_gather})
    params, valid = _field(mcfg)
    bg = torch.tensor([0.1, 0.2])
    render = graphs.RenderGraphs("surfel", mcfg, rcfg, bg, graphed=graphed)
    assert render.render_for(params, valid.device) is render_surfel_packed
    for frame in _frames(2):
        got = render(params, valid, frame)
        with torch.no_grad():
            want = render_field_surfel(*anchor_rows(params, valid, render.extent.B), frame,
                                       mcfg, rcfg, bg)[0]
        assert render.extent.B == B
        assert _equal(got, want)
        assert int(got.visible.sum()) > 0 and float(got.depth.max()) > 0
    assert telemetry.fused_fronts == 0


LAYOUTS = {
    "cells": ({}, {}, 0, render_surfel_packed),
    "feature bank": ({"use_feat_bank": True}, {}, 0, render_field_surfel),
    "appearance rows": ({"appearance_dim": 4}, {}, 3, render_field_surfel),
    "unfused heads": ({"add_cov_dist": False}, {}, 0, render_field_surfel),
    "visible-anchor cap": ({}, {"visible_anchor_cap": 64}, 0, render_field_surfel),
    "hidden 64": ({"mlp_hidden": 64}, {}, 0, render_field_surfel),
    "5 channels": ({"color_channel": 5}, {}, 0, render_field_surfel),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_the_surfel_path_follows_the_layout(name):
    mkw, rkw, n_cameras, want = LAYOUTS[name]
    mcfg = ModelConfig(**{**MODEL, **mkw})
    rcfg = RasterConfig(**{**RASTER, **rkw})
    params, _ = _field(mcfg, n_cameras)
    assert frame_render("surfel", params, mcfg, rcfg) is want
    assert front_kernel.takes(params, mcfg, rcfg) == (want is render_surfel_packed)


def test_a_surfel_step_does_not_take_the_packed_front(monkeypatch):
    """The step renders through `render_fn` under autograd: the torch
    surfel front. The trainer's render takes the packed frame."""
    calls = []
    plain = front_kernel.surfel_front_packed

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(front_kernel, "surfel_front_packed", counted)
    mcfg, rcfg = ModelConfig(**MODEL), RasterConfig(**RASTER)
    params, valid = _field(mcfg)
    state = init_train_state(AnchorField(params=params, valid=valid, voxel_size=0.2), mcfg)
    trainer = Trainer(mcfg=mcfg, ocfg=OptConfig(), rcfg=rcfg, bg=torch.zeros(2),
                      variant="surfel", graphed=False)
    frame = _frames(1)[0]
    state, metrics = trainer.step(state, frame, 1)
    assert calls == [] and np.isfinite(float(metrics.loss.total))
    with torch.no_grad():
        trainer.render(state.params, state.valid, frame)
    assert calls == [1] and telemetry.fused_fronts == 0


def test_render_surfel_packed_takes_no_proxy():
    mcfg, rcfg = ModelConfig(**MODEL), RasterConfig(**RASTER)
    params, valid = anchor_rows(*_field(mcfg), B)
    proxy = torch.zeros((B, mcfg.n_offsets, 3))
    with pytest.raises(ValueError, match="proxy"):
        render_surfel_packed(params, valid, _frames(1)[0], mcfg, rcfg, torch.zeros(2), proxy)


def test_surfel_front_refuses_a_device_f2_does_not_run_on():
    mcfg, rcfg = ModelConfig(**MODEL), RasterConfig(**RASTER)
    params, valid = anchor_rows(*_field(mcfg), B)
    with pytest.raises(ValueError, match="unsupported device"):
        front_kernel.surfel_front_packed(params, valid.to("meta"), _frames(1)[0], mcfg, rcfg)


def _narrow_heads(p, m):
    p["mlp_cov"] = {"l1": {"w": torch.zeros((36, 16)), "b": torch.zeros(16)},
                    "l2": {"w": torch.zeros((16, 42)), "b": torch.zeros(42)}}


REFUSED = {
    "hidden 16": (_narrow_heads, ValueError),
    "float64 scaling": (lambda p, m: p.update(scaling=p["scaling"].double()), TypeError),
    "feature bank": (lambda p, m: m.update(use_feat_bank=True), ValueError),
    "int valid": (None, TypeError),
    "5 channels": (lambda p, m: m.update(color_channel=5), ValueError),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_check_front_inputs_refuses_what_f2_cannot_take(name):
    mcfg = ModelConfig(**{**MODEL, "feat_dim": 32, "n_offsets": 6})
    rcfg = RasterConfig(**RASTER)
    params, valid, frame = init_field_params(mcfg, device="cpu"), torch.arange(512) < 300, \
        _frames(1)[0]
    assert front_kernel.check_front_inputs(params, valid, frame, mcfg, rcfg) == 32 + 4
    change, error = REFUSED[name]
    kw = {}
    if change is None:
        valid = valid.to(torch.int32)
    else:
        change(params, kw)
    if kw:
        mcfg = dataclasses.replace(mcfg, **kw)
        params = {**params, **{n: v for n, v in init_field_params(mcfg, device="cpu").items()
                               if n.startswith("mlp_")}}
    with pytest.raises(error):
        front_kernel.check_front_inputs(params, valid, frame, mcfg, rcfg)


def test_surfel_front_agreement_finds_what_changed():
    mcfg, rcfg = ModelConfig(**MODEL), RasterConfig(**RASTER)
    params, valid = anchor_rows(*_field(mcfg), B)
    C = mcfg.color_channel
    with torch.no_grad():
        want = front_kernel.surfel_front_packed(params, valid, _frames(1)[0], mcfg, rcfg)
    same = surfel_front_agreement(want, want, valid, C)
    assert same["faults"] == [] and same["dead_rows"] == (B - 300) * mcfg.n_offsets
    assert same["valid_agree"] == 1.0 and same["float_max_abs"] == 0.0
    live = int(torch.nonzero(want[2])[0])
    rect, tw = want[0].clone(), want[0].clone()
    rect[:, SurfelCols.rect(C).start] += 16.0            # every row's rect
    tw[live, SurfelCols.TW.start] += 1e-3                # one live row's centre
    for pk, fault in ((rect, "rect_agree"), (tw, "float_outside")):
        got = (pk, pk[:, SurfelCols.DEPTH], want[2], want[3])
        assert fault in surfel_front_agreement(got, want, valid, C)["faults"]
    flipped = want[2].clone()
    flipped[live] = False
    got = (want[0], want[1], flipped, want[3] - 1)
    assert "own_columns" in surfel_front_agreement(got, want, valid, C)["faults"]
    assert FRONT_TOL["agree"] < 1.0


# --- on a card: the surfel render cell's street field ---

SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def street():
    """(cell, configs, inputs, live extent, frames of 4 novel poses) of
    `surfel-render-street` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from portbench import registry, run
    from portbench.drive import port_configs, port_frame
    from portbench.scene import novel_poses

    dev = torch.device("cuda")
    cell = registry.load_cell("surfel-render-street")
    inputs = run.make_inputs(cell, SEED, dev)
    mcfg, rcfg, _ = port_configs(cell.config)
    ext = graphs.extent_rule(graphs.live_mark(inputs.valid), inputs.valid.shape[0])
    sensor = cell.config["sensor"]
    gt = torch.zeros((3, sensor["H"], sensor["W"]), device=dev)
    poses = novel_poses(SEED, cell.traffic["scene"], cell.traffic, dev)
    frames = [port_frame(poses[i], gt, inputs.scene.beams, 0) for i in (0, 50, 100, 150)]
    return cell, mcfg, rcfg, inputs, ext, frames


@pytest.mark.cuda
def test_f2_matches_the_torch_surfel_front_on_the_card(street):
    cell, mcfg, rcfg, inputs, ext, frames = street
    assert ext == 57344
    params, valid = anchor_rows(inputs.params, inputs.valid, ext)
    C = mcfg.color_channel
    with torch.no_grad():
        anchor_vis = valid & field_surfels(params, valid, frames[0], mcfg, rcfg)[2]
    culled = (~anchor_vis & valid).repeat_interleave(mcfg.n_offsets)
    for frame in frames:
        with torch.no_grad(), counting() as n:
            got = front_kernel.surfel_front_packed(params, valid, frame, mcfg, rcfg)
            want = front_kernel.surfel_front_packed_plain(params, valid, frame, mcfg, rcfg)
        assert n["F2"] == 1
        assert got[0].shape == want[0].shape == (ext * 6, 24)
        numbers = surfel_front_agreement(got, want, valid, C,
                                         culled if frame is frames[0] else None)
        assert not numbers["faults"], numbers
        assert numbers["valid_agree"] >= FRONT_TOL["agree"] and numbers["dead_rows"] > 0


def _render_numbers(cell, got: list, want: list) -> dict:
    from portbench import check

    return check.render_numbers({i: (g.color, g.depth) for i, g in enumerate(got)},
                                {i: (w.color, w.depth) for i, w in enumerate(want)},
                                cell.config["raster"]["far"], cell.limits["far_atol"])


@pytest.mark.cuda
def test_the_f2_frame_is_within_the_render_check_and_replays_bit_for_bit(street):
    cell, mcfg, rcfg, inputs, ext, frames = street
    bg = torch.zeros(2, device="cuda")
    telemetry.enable()
    graphed = graphs.RenderGraphs("surfel", mcfg, rcfg, bg, graphed=True)
    eager = graphs.RenderGraphs("surfel", mcfg, rcfg, bg, graphed=False)
    with counting() as n:
        got = [graphed(inputs.params, inputs.valid, f) for f in frames]
    assert n["F2"] == len(frames) and n["K5"] == len(frames)
    assert telemetry.fused_fronts == 1            # one program, four replays
    again = [graphed(inputs.params, inputs.valid, f) for f in frames]
    plain = [eager(inputs.params, inputs.valid, f) for f in frames]
    assert telemetry.fused_fronts == 1 + len(frames)
    for a, b, c in zip(got, again, plain):
        assert _equal(a, b) and _equal(a, c)
    with torch.no_grad():
        want = [render_field_surfel(*anchor_rows(inputs.params, inputs.valid, ext), f, mcfg,
                                    rcfg, bg)[0] for f in frames]
    numbers = _render_numbers(cell, got, want)
    assert all(numbers[k] <= v for k, v in cell.limits["limits"].items()), numbers


@pytest.mark.cuda
def test_the_fused_gather_f2_frame_equals_the_tiled_one(street):
    cell, mcfg, rcfg, inputs, ext, frames = street
    bg = torch.zeros(2, device="cuda")
    fused = graphs.RenderGraphs("surfel", mcfg, dataclasses.replace(rcfg, fused_gather=True), bg,
                                graphed=True)
    tiled = graphs.RenderGraphs("surfel", mcfg, rcfg, bg, graphed=True)
    with counting() as n:
        got = [fused(inputs.params, inputs.valid, f) for f in frames]
    assert n["F2"] == len(frames) and n["K7"] == len(frames) and n["K5"] == 0
    for g, f in zip(got, frames):
        assert _equal(g, tiled(inputs.params, inputs.valid, f))
