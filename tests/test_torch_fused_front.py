"""The forward beam front as one kernel (`ops/front_kernel.py` `front_packed`,
kernel F1 of `csrc/front_fwd.cu`) and the frame that runs it
(`models/field.py` `render_frame_packed`, chosen by `frame_render` inside
`train/graphs.py` `RenderGraphs`).

On the CPU (16x256 range view, feat 8, k = 2, hidden 32, 300 of 512 anchors):
  * `front_packed`'s plain version is the torch path: `pack_splats` of
    `field_splats`' Splats, their depth, valid and count, bit for bit;
  * `cull_packed` after the split of `cull_sorted_rows` gives the rows and
    the dropped count of the single function it came from;
  * a beam frame through `RenderGraphs` (graphed and eager) equals
    `render_field`'s on the same anchor rows, bit for bit;
  * the path (`front_kernel.takes`): the cells' layout takes the packed
    render; a feature bank, appearance rows, unfused heads, a visible-anchor
    cap, 64 hidden units and 5 channels take `render_field`; the surfel
    variant likewise its packed render (`render_surfel_packed`, F2's
    frame: `tests/test_torch_surfel_front.py`) or `render_field_surfel`;
  * `telemetry.fused_fronts` counts nothing on the CPU, whose packed front
    is the plain version, counts a frame whose front runs on a card (F1
    or F2), and appears in the summary;
  * `check_front_inputs` takes the cells' layout (32 hidden units) and
    refuses what F1 cannot take.

On a card (`cuda`), the render cells' street field at its live extent
(B = 57,344): F1 against the torch path on the card by
`utils/testing.py` `front_agreement` (columns within rtol 1e-5 / atol 1e-6,
the conic within 1e-5 of its diagonal's scale, the discrete columns valid
and rect equal on at least 99.99% of the rows, the rows of dead and culled
anchors); the rendered frame within the beam render's check limits; a graph
replay equal to an eager frame bit for bit; a refined frame through it;
`telemetry.fused_fronts` once a program and once an eager frame.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lidargs_torch.config import ModelConfig, RasterConfig
from lidargs_torch.lidar import LidarFrame, uniform_beam_inclinations
from lidargs_torch.models.field import (anchor_rows, field_splats, frame_render,
                                        init_field_params, render_field, render_field_surfel,
                                        render_frame_packed, render_surfel_packed)
from lidargs_torch.ops import front_kernel
from lidargs_torch.ops.projection import PackedCols, pack_splats
from lidargs_torch.ops.rasterize import cull_packed, cull_sorted_rows, permutation_rows
from lidargs_torch.train import graphs
from lidargs_torch.utils.profiling import telemetry
from lidargs_torch.utils.stage_split import counting
from lidargs_torch.utils.testing import (FRONT_TOL, front_agreement, one_torch_thread,
                                         sensor_poses, shell_field)

H, W = 16, 256
MODEL = dict(feat_dim=8, n_offsets=2, mlp_hidden=32, anchor_capacity=512)
RASTER = dict(tile_h=4, tile_capacity=64, max_tiles_per_gaussian=8, max_visible=2048, chunk=8)
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
def test_plain_front_is_the_torch_path(pose):
    mcfg, rcfg = ModelConfig(**MODEL), RasterConfig(**RASTER)
    params, valid = anchor_rows(*_field(mcfg), B)
    frame = _frames(3)[pose]
    with torch.no_grad():
        pk, depth, vis, n_valid = front_kernel.front_packed(params, valid, frame, mcfg, rcfg)
        sp = field_splats(params, valid, frame, mcfg, rcfg)[0]
    assert torch.equal(pk, pack_splats(sp))
    assert torch.equal(depth, sp.depth) and torch.equal(vis, sp.valid)
    assert n_valid.dtype == torch.int64 and int(n_valid) == int(sp.valid.sum()) > 0
    assert pk.shape == (B * mcfg.n_offsets, PackedCols.width(mcfg.color_channel))


@pytest.mark.parametrize("max_visible", [2048, 100])
def test_cull_packed_is_the_cull_before_the_split(max_visible):
    """`cull_sorted_rows` and `cull_packed` against the single function they
    were split from, written out here; at max_visible 100 valid rows are
    dropped."""
    mcfg = ModelConfig(**MODEL)
    rcfg = RasterConfig(**{**RASTER, "max_visible": max_visible})
    params, valid = anchor_rows(*_field(mcfg), B)
    with torch.no_grad():
        sp = field_splats(params, valid, _frames(1)[0], mcfg, rcfg)[0]
    C = sp.feat.shape[-1]
    pk = pack_splats(sp)
    sel = torch.sort(sp.depth, stable=True).indices
    V = min(max_visible, pk.shape[0])
    want = permutation_rows(pk, sel, V)
    want_drop = sp.valid.sum() - (want[:, PackedCols.validf(C)] > 0.0).sum()
    for pkv, n_dropped in (cull_sorted_rows(sp, rcfg),
                           cull_packed(pk, sp.depth, sp.valid.sum(), rcfg, C)):
        assert torch.equal(pkv, want) and torch.equal(n_dropped, want_drop)
    assert (int(want_drop) > 0) == (max_visible == 100)


@pytest.mark.parametrize("graphed", [True, False])
def test_beam_frame_through_render_graphs_is_render_fields(graphed):
    mcfg, rcfg = ModelConfig(**MODEL), RasterConfig(**RASTER)
    params, valid = _field(mcfg)
    bg = torch.tensor([0.1, 0.2])
    render = graphs.RenderGraphs("beam", mcfg, rcfg, bg, graphed=graphed)
    for frame in _frames(3):
        got = render(params, valid, frame)
        with torch.no_grad():
            want = render_field(*anchor_rows(params, valid, render.extent.B), frame, mcfg, rcfg,
                                bg)[0]
        assert render.extent.B == B
        assert _equal(got, want)
        assert int(got.visible.sum()) > 0 and float(got.depth.max()) > 0


LAYOUTS = {
    "cells": ({}, {}, 0, render_frame_packed),
    "feature bank": ({"use_feat_bank": True}, {}, 0, render_field),
    "appearance rows": ({"appearance_dim": 4}, {}, 3, render_field),
    "unfused heads": ({"add_cov_dist": False}, {}, 0, render_field),
    "visible-anchor cap": ({}, {"visible_anchor_cap": 64}, 0, render_field),
    "hidden 64": ({"mlp_hidden": 64}, {}, 0, render_field),
    "5 channels": ({"color_channel": 5}, {}, 0, render_field),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_the_path_follows_the_layout(name):
    mkw, rkw, n_cameras, want = LAYOUTS[name]
    mcfg = ModelConfig(**{**MODEL, **mkw})
    rcfg = RasterConfig(**{**RASTER, **rkw})
    params, valid = _field(mcfg, n_cameras)
    assert frame_render("beam", params, mcfg, rcfg) is want
    assert front_kernel.takes(params, mcfg, rcfg) == (want is render_frame_packed)
    assert frame_render("surfel", params, mcfg, rcfg) is (
        render_surfel_packed if want is render_frame_packed else render_field_surfel)
    bg = torch.zeros(mcfg.color_channel)
    render = graphs.RenderGraphs("beam", mcfg, rcfg, bg, graphed=True)
    out = render(params, valid, _frames(1)[0])
    assert telemetry.fused_fronts == 0            # the CPU's packed front is the plain one
    assert torch.isfinite(out.color).all()
    with torch.no_grad():
        want_out = render_field(*anchor_rows(params, valid, render.extent.B), _frames(1)[0],
                                mcfg, rcfg, bg)[0]
    assert _equal(out, want_out)


def test_the_surfel_frame_keeps_its_render():
    mcfg = ModelConfig(**MODEL)
    rcfg = RasterConfig(**{**RASTER, "tile_h": 1})
    params, valid = _field(mcfg)
    render = graphs.RenderGraphs("surfel", mcfg, rcfg, torch.zeros(2), graphed=True)
    frame = _frames(1)[0]
    got = render(params, valid, frame)
    with torch.no_grad():
        want = render_field_surfel(*anchor_rows(params, valid, render.extent.B), frame, mcfg,
                                   rcfg, torch.zeros(2))[0]
    assert _equal(got, want) and telemetry.fused_fronts == 0


def test_fused_fronts_counts_programs_and_eager_frames():
    """On the CPU the packed frame's front is the plain version: programs
    and eager frames count nothing. The rule itself (`render_for`) counts
    a frame whose front runs on a card; the summary reports the count and
    switching on starts it afresh. The card case below counts programs and
    eager frames."""
    mcfg, rcfg = ModelConfig(**MODEL), RasterConfig(**RASTER)
    params, valid = _field(mcfg)
    frames = _frames(3)
    telemetry.enable()
    assert telemetry.fused_fronts == 0
    graphed = graphs.RenderGraphs("beam", mcfg, rcfg, torch.zeros(2), graphed=True)
    eager = graphs.RenderGraphs("beam", mcfg, rcfg, torch.zeros(2), graphed=False)
    for f in frames:
        graphed(params, valid, f)
        eager(params, valid, f)
    assert telemetry.fused_fronts == 0
    assert graphed.render_for(params, torch.device("cpu")) is render_frame_packed
    assert telemetry.fused_fronts == 0
    assert graphed.render_for(params, torch.device("cuda")) is render_frame_packed
    assert telemetry.fused_fronts == 1
    surfel = graphs.RenderGraphs("surfel", mcfg, rcfg, torch.zeros(2), graphed=True)
    assert surfel.render_for(params, torch.device("cpu")) is render_surfel_packed
    assert telemetry.fused_fronts == 1
    assert surfel.render_for(params, torch.device("cuda")) is render_surfel_packed
    assert telemetry.fused_fronts == 2
    # a step's render programs, and the summary reports the count
    tr = graphs.RenderGraphs("beam", mcfg, rcfg, torch.zeros(2), graphed=True)
    with telemetry.scope(valid.device):
        tr(params, valid, frames[0])
    s = telemetry.summary("render")
    assert s["fused_fronts"] == telemetry.fused_fronts == 2
    telemetry.disable()
    telemetry.enable()                            # switching on starts the count afresh
    assert telemetry.fused_fronts == 0


def test_render_frame_packed_takes_no_proxy():
    mcfg, rcfg = ModelConfig(**MODEL), RasterConfig(**RASTER)
    params, valid = anchor_rows(*_field(mcfg), B)
    proxy = torch.zeros((B, mcfg.n_offsets, 3))
    with pytest.raises(ValueError, match="proxy"):
        render_frame_packed(params, valid, _frames(1)[0], mcfg, rcfg, torch.zeros(2), proxy)


def _cells_layout():
    """The cells' head layout (feat 32, k 6, hidden 32, 2 channels) on a
    small table, CPU tensors."""
    mcfg = ModelConfig(**{**MODEL, "feat_dim": 32, "n_offsets": 6, "mlp_hidden": 32})
    params = init_field_params(mcfg, device="cpu")
    return mcfg, RasterConfig(**RASTER), params, torch.arange(512) < 300, _frames(1)[0]


def test_check_front_inputs_takes_the_cells_layout():
    mcfg, rcfg, params, valid, frame = _cells_layout()
    assert front_kernel.check_front_inputs(params, valid, frame, mcfg, rcfg) == 32 + 4
    params, valid = anchor_rows(params, valid, 64)
    assert front_kernel.check_front_inputs(params, valid, frame, mcfg, rcfg) == 32 + 4


def _narrow_heads(p, m):
    p["mlp_cov"] = {"l1": {"w": torch.zeros((36, 16)), "b": torch.zeros(16)},
                    "l2": {"w": torch.zeros((16, 42)), "b": torch.zeros(42)}}


REFUSED = {
    "hidden 16": (_narrow_heads, ValueError),
    "float64 feat": (lambda p, m: p.update(feat=p["feat"].double()), TypeError),
    "strided offsets": (lambda p, m: p.update(offset=p["offset"].transpose(0, 1).contiguous()
                                              .transpose(0, 1)), ValueError),
    "int valid": (None, TypeError),
    "5 channels": (lambda p, m: m.update(color_channel=5), ValueError),
    "hidden 64": (lambda p, m: m.update(mlp_hidden=64), ValueError),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_check_front_inputs_refuses_what_f1_cannot_take(name):
    mcfg, rcfg, params, valid, frame = _cells_layout()
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


def test_check_front_inputs_refuses_a_one_beam_table():
    mcfg, rcfg, params, valid, _ = _cells_layout()
    beams = torch.zeros(1)
    frame = LidarFrame(torch.eye(3), torch.zeros(3), torch.zeros(3), beams,
                       torch.zeros((3, 1, W)), 0)
    with pytest.raises(ValueError, match="beam table"):
        front_kernel.check_front_inputs(params, valid, frame, mcfg, rcfg)


# --- on a card: the render cells' street field ---

SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def street():
    """(cell, configs, anchor rows at the live extent, frames of 4 novel
    poses) of `beam-render-street` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from portbench import registry, run
    from portbench.drive import port_configs, port_frame
    from portbench.scene import novel_poses

    dev = torch.device("cuda")
    cell = registry.load_cell("beam-render-street")
    inputs = run.make_inputs(cell, SEED, dev)
    mcfg, rcfg, _ = port_configs(cell.config)
    ext = graphs.extent_rule(graphs.live_mark(inputs.valid), inputs.valid.shape[0])
    sensor = cell.config["sensor"]
    gt = torch.zeros((3, sensor["H"], sensor["W"]), device=dev)
    poses = novel_poses(SEED, cell.traffic["scene"], cell.traffic, dev)
    frames = [port_frame(poses[i], gt, inputs.scene.beams, 0) for i in (0, 50, 100, 150)]
    return cell, mcfg, rcfg, inputs, ext, frames


@pytest.mark.cuda
def test_f1_matches_the_torch_front_on_the_card(street):
    cell, mcfg, rcfg, inputs, ext, frames = street
    assert ext == 57344
    params, valid = anchor_rows(inputs.params, inputs.valid, ext)
    C = mcfg.color_channel
    with torch.no_grad():
        anchor_vis = valid & field_splats(params, valid, frames[0], mcfg, rcfg)[2]
    culled = (~anchor_vis & valid).repeat_interleave(mcfg.n_offsets)
    for frame in frames:
        with torch.no_grad(), counting() as n:
            got = front_kernel.front_packed(params, valid, frame, mcfg, rcfg)
            want = front_kernel.front_packed_plain(params, valid, frame, mcfg, rcfg)
        assert n["F1"] == 1
        assert got[0].shape == want[0].shape == (ext * 6, 24)
        numbers = front_agreement(got, want, valid, C, culled if frame is frames[0] else None)
        assert not numbers["faults"], numbers
        assert numbers["valid_agree"] >= FRONT_TOL["agree"] and numbers["dead_rows"] > 0


def _render_numbers(cell, got: list, want: list) -> dict:
    from portbench import check

    return check.render_numbers({i: (g.color, g.depth) for i, g in enumerate(got)},
                                {i: (w.color, w.depth) for i, w in enumerate(want)},
                                cell.config["raster"]["far"], cell.limits["far_atol"])


@pytest.mark.cuda
def test_the_f1_frame_is_within_the_render_check_and_replays_bit_for_bit(street):
    cell, mcfg, rcfg, inputs, ext, frames = street
    bg = torch.zeros(2, device="cuda")
    graphed = graphs.RenderGraphs("beam", mcfg, rcfg, bg, graphed=True)
    eager = graphs.RenderGraphs("beam", mcfg, rcfg, bg, graphed=False)
    got = [graphed(inputs.params, inputs.valid, f) for f in frames]
    again = [graphed(inputs.params, inputs.valid, f) for f in frames]
    plain = [eager(inputs.params, inputs.valid, f) for f in frames]
    for a, b, c in zip(got, again, plain):
        assert _equal(a, b) and _equal(a, c)
    with torch.no_grad():
        want = [render_field(*anchor_rows(inputs.params, inputs.valid, ext), f, mcfg, rcfg,
                             bg)[0] for f in frames]
    numbers = _render_numbers(cell, got, want)
    assert all(numbers[k] <= v for k, v in cell.limits["limits"].items()), numbers


@pytest.mark.cuda
def test_a_refined_frame_runs_f1_before_the_unet(street):
    from portbench import registry
    from portbench.drive import stage_args

    cell, mcfg, rcfg, inputs, ext, frames = street
    refined = registry.load_cell("beam-render-refined-street")
    stages = [(s, s.draw(refined, SEED, torch.device("cuda"))) for s in refined.stages]
    refine = stage_args(stages)["refine"]
    bg = torch.zeros(2, device="cuda")
    telemetry.fused_fronts = 0
    render = graphs.RenderGraphs("beam", mcfg, rcfg, bg, graphed=True, refine=refine)
    got = [render(inputs.params, inputs.valid, f) for f in frames]
    assert telemetry.fused_fronts == 1
    eager = graphs.RenderGraphs("beam", mcfg, rcfg, bg, graphed=False, refine=refine)
    for g, f in zip(got, frames):
        assert _equal(g, eager(inputs.params, inputs.valid, f))
    with torch.no_grad():
        want = [graphs.refine_frame(refine, render_field(
            *anchor_rows(inputs.params, inputs.valid, ext), f, mcfg, rcfg, bg)[0])[0]
            for f in frames]
    numbers = _render_numbers(refined, got, want)
    assert all(numbers[k] <= v for k, v in refined.limits["limits"].items()), numbers


@pytest.mark.cuda
def test_fused_fronts_counts_programs_and_eager_frames_on_the_card(street):
    cell, mcfg, rcfg, inputs, ext, frames = street
    bg = torch.zeros(2, device="cuda")
    telemetry.enable()
    graphed = graphs.RenderGraphs("beam", mcfg, rcfg, bg, graphed=True)
    with counting() as n:
        for f in frames:
            graphed(inputs.params, inputs.valid, f)
    assert telemetry.fused_fronts == 1            # one program, four replays
    assert n["F1"] == len(frames)
    eager = graphs.RenderGraphs("beam", mcfg, rcfg, bg, graphed=False)
    for f in frames:
        eager(inputs.params, inputs.valid, f)
    assert telemetry.fused_fronts == 1 + len(frames)
    masked = LidarFrame(*(getattr(frames[0], n) for n in graphs.FRAME_FIELDS[:-1]),
                        pixel_mask=torch.ones(frames[0].gt_image.shape[1:], dtype=torch.bool,
                                              device="cuda"))
    graphed(inputs.params, inputs.valid, masked)  # another key: another program
    assert telemetry.fused_fronts == 2 + len(frames)
