"""LiDAR4D's ray-drop UNet inside the render's program (`train/graphs.py`
`RenderGraphs(refine=...)`, `Trainer(refine=...)`) and the benchmark's
refined re-simulation cell (`beam-render-refined-street`: the stage
`portbench/stages/unet_refiner.py`, the plain UNet
`portbench/reference/unet.py`), on the CPU.

  * the port's `UNet` against the plain UNet on seeded weights, 32
    channels on a 32x96 view;
  * a refined `Trainer.render`, graphed (the CPU stand-in) and eager, held
    to the reference field plus the stage's reference by the cell's own
    check (`check.render_numbers`, the cell's limits), on the benchmark's
    tiny cell (8x256, padded to 16x256 for the UNet);
  * each planted fault (`portbench/refiner_faults.py`: the refiner
    skipped, the attention residual dropped) fails that check;
  * without a refiner a frame's program is the field's render alone: the
    same operations, stamps and outputs;
  * the stage's count of a 64x2650 frame: 82,304,892,928 operations of the
    convolutions and attention products (82.3 GFLOP);
  * the recorder: a refined frame is a render with a `refine` stage, and
    its `n_flipped` is the count of pixels whose drop decision moved;
  * the cell loads, and the stage's draw, reference and work load neither
    JAX nor the port;
  * `run_eval` with the refiner in its programs writes what an eager
    refine after each render scores.
"""
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lidargs_torch.config import ModelConfig, RasterConfig
from lidargs_torch.lidar import LidarFrame, uniform_beam_inclinations
from lidargs_torch.models.field import anchor_rows, render_fn
from lidargs_torch.models.raydrop import refine_color, refiner_from_tree
from lidargs_torch.train import evaluate, graphs
from lidargs_torch.train.metrics import evaluate_frame, mean_metrics
from lidargs_torch.train.trainer import Trainer
from lidargs_torch.utils.profiling import IDS, SEQUENCES, telemetry
from lidargs_torch.utils.testing import one_torch_thread, sensor_poses, shell_field
from portbench import check, registry, run
from portbench.drive import port_configs, port_frame
from portbench.refiner_faults import FAULTS, program_frames
from portbench.reference import unet as plain_unet
from portbench.scene import novel_poses
from portbench.tests.tiny import tiny_cell

ROOT = Path(__file__).resolve().parents[1]
CELL = "beam-render-refined-street"
SEED = 2 ** 31 + 45
CPU = torch.device("cpu")
# the packages' BatchNorm (a root of another reduction's variance) and x2
# upsampling (its sums in another order) round apart by ~1e-7 a layer, and
# the normalization of 20 layers amplifies that: 1.8-3.6e-6 at most over
# four seeds on a sigmoid output in (0, 1); the attention residual dropped
# moves it by ~1e-2
UNET_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


@pytest.fixture(autouse=True)
def _recorder_off():
    yield
    telemetry.disable()
    telemetry.rings.clear()


@pytest.fixture(scope="module")
def tiny():
    """(cell, inputs, drawn stages, {index: Pose} of the checked poses,
    the reference's frames) of the tiny refined cell."""
    cell = tiny_cell(CELL)
    inputs = run.make_inputs(cell, SEED, CPU)
    stages = [(s, s.draw(cell, SEED, CPU)) for s in cell.stages]
    poses = novel_poses(SEED, cell.traffic["scene"], cell.traffic, CPU)
    checked = {i: poses[i] for i in (0, 3)}
    want = check.reference_render(cell, inputs, checked, stages=stages)["frames"]
    return cell, inputs, stages, checked, want


def _trainer(cell, **kw) -> Trainer:
    mcfg, rcfg, ocfg = port_configs(cell.config)
    return Trainer(mcfg=mcfg, ocfg=ocfg, rcfg=rcfg, bg=torch.zeros(2), variant="beam", **kw)


def _frame(cell, inputs, pose) -> LidarFrame:
    H, W = cell.config["sensor"]["H"], cell.config["sensor"]["W"]
    return port_frame(pose, torch.zeros((3, H, W)), inputs.scene.beams, 0)


def _numbers(cell, got: dict, want: dict) -> dict:
    return check.render_numbers(got, want, cell.config["raster"]["far"],
                                cell.limits["far_atol"])


@pytest.mark.parametrize("seed", [0, 1])
def test_the_port_unet_equals_the_plain_reference(seed):
    gen = torch.Generator().manual_seed(seed)
    tree = plain_unet.draw_weights(gen, 3, 32, 1)
    model = refiner_from_tree(tree, "cpu")
    x = torch.rand((1, 3, 32, 96), generator=gen)
    with torch.no_grad(), check.precision(False):
        got, want = model(x), plain_unet.unet(x, tree, heads=8)
    assert got.shape == want.shape == (1, 1, 32, 96)
    assert float((got - want).abs().max()) <= UNET_ATOL
    # cropped from a padded view, as refine_color runs it
    rd, inten, dep = torch.rand((3, 30, 90), generator=gen)
    with torch.no_grad(), check.precision(False):
        got = refine_color(model, torch.stack([inten, rd]), dep * 80.0, depth_scale=80.0)
        want = plain_unet.refine_raydrop(tree, rd, inten, dep, heads=8)
    assert torch.equal(got[0], inten) and float((got[1] - want).abs().max()) <= UNET_ATOL


@pytest.mark.parametrize("graphed", [True, False], ids=["graphed", "eager"])
def test_a_refined_render_passes_the_cells_check(tiny, graphed):
    cell, inputs, stages, checked, want = tiny
    stage, drawn = stages[0]
    tr = _trainer(cell, graphed=graphed, **stage.program(drawn))
    got = {}
    for i, pose in checked.items():
        out = tr.render(inputs.params, inputs.valid, _frame(cell, inputs, pose))
        got[i] = (out.color, out.depth)
    numbers = _numbers(cell, got, want)
    assert check.judge(numbers, cell.limits["limits"]), numbers
    # the ray drop is the refiner's: the field's alone fails (see the faults)
    plain = _trainer(cell, graphed=graphed)
    out = plain.render(inputs.params, inputs.valid, _frame(cell, inputs, checked[0]))
    assert torch.equal(out.color[0], got[0][0][0]) and torch.equal(out.depth, got[0][1])
    assert not torch.equal(out.color[1], got[0][0][1])


@pytest.mark.parametrize("fault", FAULTS)
def test_each_planted_fault_fails_the_check(tiny, fault):
    cell, inputs, _, _, _ = tiny
    got, poses, stages = program_frames(cell, SEED, inputs, CPU, fault, seconds=0.0)
    sound, _, _ = program_frames(cell, SEED, inputs, CPU, seconds=0.0)
    want = check.reference_render(cell, inputs, poses, stages=stages)["frames"]
    assert check.judge(_numbers(cell, sound["frames"], want), cell.limits["limits"])
    numbers = _numbers(cell, got["frames"], want)
    assert not check.judge(numbers, cell.limits["limits"]), numbers
    assert numbers["far_share"] > 10 * cell.limits["limits"]["far_share"], numbers


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_without_a_refiner_the_frame_is_the_fields_render_alone(tiny):
    cell, inputs, _, checked, _ = tiny
    frame = _frame(cell, inputs, checked[0])
    telemetry.enable()
    tr = _trainer(cell, graphed=True)
    out = tr.render(inputs.params, inputs.valid, frame)
    ring = telemetry.rings[CPU]
    ring.drain()
    (rec,) = ring.steps.values()
    assert [IDS[i] for i, _ in rec.stamps] == ["begin"] + [s for s, _ in SEQUENCES["render"]]
    assert set(rec.counts) == {"profiled", "n_visible", "rows", "n_overflow", "n_dropped"}
    telemetry.disable()
    prog = tr._renders.programs[True][3]
    assert prog.commit is graphs.end_frame
    mcfg, rcfg, _ = port_configs(cell.config)
    rows = anchor_rows(inputs.params, inputs.valid, tr._renders.programs[True][4])
    bg = torch.zeros(2)
    with _Ops() as program_ops, torch.no_grad():
        prog.compute()
    with _Ops() as field_ops, torch.no_grad():
        want = graphs.stamped_render(render_fn("beam"), *rows, tr._renders.programs[True][2],
                                     mcfg, rcfg, bg)
    assert program_ops.ops == field_ops.ops
    for a, b in zip(out, want):
        assert (a is None and b is None) or torch.equal(a, b)


def test_the_stage_counts_a_64x2650_frame(tiny):
    cell, _, stages, _, _ = tiny
    stage, drawn = stages[0]
    counts = stage.work.__globals__["counts"]
    sizes = registry.load_cell(CELL).config["refiner"]
    assert sizes == drawn["sizes"] == {"in_channels": 3, "channels": 32, "out_channels": 1,
                                       "heads": 8, "depth_scale": 80.0}
    n = counts(sizes, 64, 2650)
    P, T, C = 64 * 2656, 4 * 166, 256
    # per pixel of each level, 2 k^2 C_in C_out: inc 192, down 3 x 27,648 and 9,216, up
    # 3 x 92,160 and 110,592, outc 64; attention's qkv, proj and two products
    convs = 479_488 * P
    assert n["products"] == convs + 2 * C * 3 * C * T + 2 * C * C * T + 4 * T * T * C
    assert n["products"] == 82_304_892_928 and round(n["products"] / 1e8) == 823
    assert 0 < n["elementwise"] < 0.01 * n["products"]
    assert stage.work(drawn, 64, 2650) == (n["products"] + n["elementwise"], n["bytes"])
    # at least the weights (~7.8 M) and the padded input, float32
    assert n["bytes"] > 4 * (7_000_000 + 3 * P)


def test_a_refined_frame_records_the_refine_stage_and_the_flips(tiny):
    cell, inputs, stages, checked, _ = tiny
    stage, drawn = stages[0]
    refine = stage.program(drawn)["refine"]
    frames = [_frame(cell, inputs, p) for p in checked.values()]
    plain = _trainer(cell, graphed=False)
    flips = []
    for f in frames:
        field = plain.render(inputs.params, inputs.valid, f)
        with torch.no_grad():
            flips.append(int(((refine(field.color, field.depth)[1] > 0.5)
                              != (field.color[1] > 0.5)).sum()))
    telemetry.enable()
    tr = _trainer(cell, graphed=True, refine=refine)
    outs = [tr.render(inputs.params, inputs.valid, f) for f in frames]
    ring = telemetry.rings[CPU]
    ring.drain()
    recs = list(ring.steps.values())
    assert len(recs) == len(frames)
    for rec, flipped, out in zip(recs, flips, outs):
        assert [IDS[i] for i, _ in rec.stamps] == ["begin", "front", "raster", "refine", "end"]
        assert rec.kind == "render"
        assert rec.counts["n_flipped"] == flipped > 0
        assert (rec.counts["n_overflow"], rec.counts["n_dropped"]) == (
            int(out.n_overflow), int(out.n_dropped))
    s = telemetry.summary("render")
    assert s["steps"] == len(frames)
    assert list(s["stage_ms"]) == ["front", "raster", "composite", "refine"]
    assert s["graph_ms"] == pytest.approx(sum(s["stage_ms"].values()))
    assert all(v > 0 for v in s["stage_ms"].values())
    assert s["counters"]["n_flipped"] == pytest.approx(
        sum(r.counts["n_flipped"] for r in recs) / len(recs))
    assert telemetry.metric("stage_refine_ms", "render") == s["stage_ms"]["refine"]


def test_the_cell_loads_and_its_stage_loads_no_jax_and_no_port():
    cell = registry.load_cell(CELL)
    assert [s.name for s in cell.stages] == ["unet_refiner"] and cell.chips == 1
    assert cell.config["stages"] == ["unet_refiner"] and cell.traffic["kind"] == "render"
    code = (
        "import sys, torch\n"
        "from portbench import registry, run\n"
        "from portbench.tests.tiny import tiny_cell\n"
        f"cell = tiny_cell({CELL!r})\n"
        "(stage,) = cell.stages\n"
        "drawn = stage.draw(cell, 2 ** 31 + 3, torch.device('cpu'))\n"
        "H, W = cell.config['sensor']['H'], cell.config['sensor']['W']\n"
        "color, depth = torch.rand((2, H, W)), 80 * torch.rand((H, W))\n"
        "got, d = stage.reference(drawn, color, depth)\n"
        "assert got.shape == color.shape and torch.equal(got[0], color[0]) and d is depth\n"
        "assert stage.work(drawn, H, W)[0] > 0\n"
        "assert run.loaded_forbidden() == [], run.loaded_forbidden()\n"
        "assert 'lidargs_torch' not in sys.modules\n"
        "print('ok')\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0 and done.stdout.strip() == "ok", done.stderr[-2000:]


def test_run_eval_refines_inside_its_programs_as_after_them(tmp_path, monkeypatch):
    H, W = 16, 256
    mcfg = ModelConfig(feat_dim=8, n_offsets=2, mlp_hidden=8, anchor_capacity=512)
    rcfg = RasterConfig(tile_h=4, tile_capacity=64, max_tiles_per_gaussian=8,
                        max_visible=2048, chunk=8)
    params, valid = shell_field(mcfg, 300, seed=0, device="cpu")
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    rng = np.random.default_rng(1)
    frames = []
    for i, pose in enumerate(sensor_poses(3, seed=2)):
        gt = np.zeros((3, H, W), np.float32)
        gt[0] = rng.uniform(size=(H, W)) > 0.2
        gt[1] = rng.uniform(size=(H, W)) * gt[0]
        gt[2] = rng.uniform(5.0, 70.0, size=(H, W)) * gt[0]
        frames.append(LidarFrame.from_lidar2world(pose, beams, gt, uid=i, device="cpu"))
    tree = plain_unet.draw_weights(torch.Generator().manual_seed(4), 3, 8, 1)
    refine = functools.partial(refine_color, refiner_from_tree(tree, "cpu"), depth_scale=80.0)
    # the CPU stand-in of the graphs, which the CPU's default (eager) skips
    monkeypatch.setattr(evaluate, "RenderGraphs",
                        functools.partial(graphs.RenderGraphs, graphed=True))
    telemetry.enable()
    res = evaluate.run_eval(params, valid, {"test": frames}, mcfg, rcfg, torch.zeros(2),
                            str(tmp_path), device="cpu", refine=refine)
    # with the recorder on, the sweep's frames carry their stamps (the CLI's eval line)
    s = telemetry.summary("render")
    assert s["steps"] == len(frames) and "refine" in s["stage_ms"]
    assert "n_flipped" in s["counters"]
    telemetry.disable()
    written = json.loads((tmp_path / "results.json").read_text())
    render = graphs.RenderGraphs("beam", mcfg, rcfg, torch.zeros(2), graphed=False)
    per = []
    for fr in frames:
        with torch.no_grad():
            out = render(params, valid, fr)
            per.append(evaluate_frame(refine(out.color, out.depth), out.depth, fr.gt_image,
                                      fr.beams, depth_min=5.0, depth_max=80.0,
                                      compute_chamfer=False))
        per[-1]["visible_count"] = float(out.visible.sum())
    want = mean_metrics(per)
    # the same operations on the same inputs: equal but for the last bits of a
    # metric's float32 sums
    assert written["test"].keys() == want.keys() and res["test"] == written["test"]
    for k, v in want.items():
        assert written["test"][k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    unrefined = evaluate.run_eval(params, valid, {"test": frames}, mcfg, rcfg, torch.zeros(2),
                                  str(tmp_path / "plain"), device="cpu")
    assert unrefined["test"]["raydrop_acc"] != written["test"]["raydrop_acc"]
