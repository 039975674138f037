"""The in-program recorder (`lidargs_torch/utils/profiling.py` `telemetry`):
stage stamps inside the step and render programs, their counters, host
spans, and the benchmark's readers of it (`portbench/metrics/`), on the CPU,
where a stamp appends the host's clock to the device ring's layout.

  * off, a graphed step and render record nothing;
  * on, beam and surfel steps and frames record their stamps once each, in
    order, under consecutive step ids; the counters equal `StepMetrics`'
    (a frame's, its RenderOut's); densify's stamps carry its counts;
  * a `StaticProgram` of the same functions made outside a Trainer (the
    stage split's rows) records nothing while on;
  * under torch.profiler the first Trainer call switches the recorder on,
    its spans reach the profiler, and the profiled steps are left out;
  * each new reader gives None for the other kind and before any record,
    and a number after a few steps;
  * on a card (`cuda`), a graphed beam step's stages are positive and sum
    to its graph span.
16x256 range view, feat 8, k = 2, hidden 8, 300 of 512 anchors.
"""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lidargs_torch.config import ModelConfig, OptConfig, RasterConfig
from lidargs_torch.lidar import LidarFrame, uniform_beam_inclinations
from lidargs_torch.models.field import AnchorField, render_fn
from lidargs_torch.train import graphs
from lidargs_torch.train import trainer as tt
from lidargs_torch.utils.profiling import IDS, SEQUENCES, telemetry
from lidargs_torch.utils.testing import one_torch_thread, sensor_poses, shell_field

ROOT = Path(__file__).resolve().parents[1]
H, W = 16, 256
MODEL = dict(feat_dim=8, n_offsets=2, mlp_hidden=8, anchor_capacity=512)
RASTER = {"beam": dict(tile_h=4, tile_capacity=64, max_tiles_per_gaussian=8, max_visible=2048,
                       chunk=8),
          "surfel": dict(tile_h=1, tile_capacity=64, max_tiles_per_gaussian=8,
                         max_visible=2048, chunk=8)}
OPT = dict(start_stat=0, update_from=0, update_interval=2, update_until=4, dist_from=0,
           normal_from=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


@pytest.fixture(autouse=True)
def _fresh_recorder():
    """The recorder off and empty around each test: it is one per process,
    and keeps its records readable after `disable` (another file's test
    in the same process may have left host spans in it)."""
    telemetry.disable()
    telemetry.rings.clear()
    telemetry.spans.clear()
    yield
    telemetry.disable()
    telemetry.rings.clear()
    telemetry.spans.clear()


def _setup(variant: str, device="cpu", graphed=True):
    mcfg = ModelConfig(**MODEL)
    rcfg = RasterConfig(**RASTER[variant])
    params, valid = shell_field(mcfg, 300, seed=0, device=device)
    state = tt.init_train_state(AnchorField(params=params, valid=valid, voxel_size=0.1), mcfg)
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    rng = np.random.default_rng(1)
    frames = []
    for i, pose in enumerate(sensor_poses(4, seed=2)):
        gt = np.zeros((3, H, W), np.float32)
        gt[0] = rng.uniform(size=(H, W)) > 0.2
        gt[1] = rng.uniform(size=(H, W)) * gt[0]
        gt[2] = rng.uniform(5.0, 70.0, size=(H, W)) * gt[0]
        frames.append(LidarFrame.from_lidar2world(pose, beams, gt, uid=i, device=device))
    tr = tt.Trainer(mcfg=mcfg, ocfg=OptConfig(**OPT), rcfg=rcfg,
                    bg=torch.zeros(2, device=device), variant=variant, graphed=graphed)
    return tr, state, frames


def _run(tr, state, frames, steps=3, renders=2):
    """`steps` steps with a densify after the first, then `renders` frames:
    (each step's metrics, each frame's RenderOut)."""
    ms, outs = [], []
    for it in range(1, steps + 1):
        state, m = tr.step(state, frames[it % len(frames)], it)
        ms.append(tt.clone_metrics(m))
        if it == 1:
            state, _ = tr.densify(state, torch.Generator().manual_seed(7), 0.1)
    for i in range(renders):
        outs.append(tr.render(state.params, state.valid, frames[i]))
    return ms, outs


def _records():
    for ring in telemetry.rings.values():
        ring.drain()
    return [r for ring in telemetry.rings.values() for r in ring.steps.values()]


def test_off_records_nothing():
    tr, state, frames = _setup("beam")
    _run(tr, state, frames, steps=2, renders=1)
    assert not _records() and not telemetry.spans
    assert telemetry.summary("train") is None and telemetry.summary("render") is None


@pytest.mark.parametrize("variant", ["beam", "surfel"])
def test_steps_and_frames_record_their_stages_and_counters(variant):
    tr, state, frames = _setup(variant)
    telemetry.enable()
    ms, outs = _run(tr, state, frames)
    s_train, s_render = telemetry.summary("train"), telemetry.summary("render")
    ring = telemetry.rings[torch.device("cpu")]
    assert sorted(ring.steps) == [1, 2, 3, 4, 5]
    for sid, rec in ring.steps.items():
        kind = "train" if sid <= 3 else "render"
        assert [IDS[i] for i, _ in rec.stamps] == ["begin"] + [s for s, _ in SEQUENCES[kind]]
        t = [v for _, v in rec.stamps]
        assert t == sorted(t) and not rec.profiled
    for sid, m in enumerate(ms, 1):
        c = ring.steps[sid].counts
        assert (c["n_visible"], c["n_overflow"], c["n_dropped"], c["n_anchors"]) == (
            int(m.n_visible), int(m.n_overflow), int(m.n_dropped), int(m.n_anchors))
        # the front's rows: the live extent's (320 of the 512 anchors), k each
        assert tr.extent == 320 and c["rows"] == tr.extent * MODEL["n_offsets"]
    for sid, out in enumerate(outs, 4):
        c = ring.steps[sid].counts
        assert (c["n_visible"], c["n_overflow"], c["n_dropped"]) == (
            int(out.visible.sum()), int(out.n_overflow), int(out.n_dropped))
    assert [IDS[i] for i, _ in ring.steps[1].densify] == ["densify_begin", "densify_end"]
    assert s_train["densify_calls"] == 1 and "n_grown" in s_train["counters"]
    assert s_train["steps"] == 3 and s_render["steps"] == 2
    for s in (s_train, s_render):
        assert s["graph_ms"] == pytest.approx(sum(s["stage_ms"].values()))
        assert all(v > 0 for v in s["stage_ms"].values())
        assert 0 < s["front_fill_pct"] <= 100 and s["host_gap_ms"] > 0
    assert s_train["period_ms"] > 0 and s_train["densify_ms"] > 0
    names = [sp[0] for sp in telemetry.spans]
    assert {"step", "copy_in", "frame_copy", "replay", "clone_metrics", "densify", "grow",
            "prune", "render", "clone_outputs"} <= set(names)
    parents = {sp[0]: telemetry.spans[sp[3]][0] for sp in telemetry.spans if sp[3] >= 0}
    assert parents["replay"] in ("step", "render") and parents["grow"] == "densify"


@pytest.mark.parametrize("variant", ["beam", "surfel"])
def test_stamped_steps_equal_train_step(variant):
    """On a card the step's graph always holds the stamps and the backward
    boundaries: recording, the step gives `train_step`'s state bit for bit."""
    tr, state, frames = _setup(variant)
    telemetry.enable()
    got = want = state
    for it in (1, 2):
        got, m_g = tr.step(got, frames[it], it)
        want, m_w = tt.train_step(want, frames[it], tr.bg, tr.mcfg, tr.rcfg, tr.ocfg,
                                  variant=variant, extent=tr.extent)
        for a, b in zip(tt.state_leaves(got), tt.state_leaves(want)):
            assert torch.equal(a, b), it
        assert torch.equal(m_g.loss.total, m_w.loss.total)
    assert [r.kind for r in _records()] == ["train", "train"]


def test_eager_steps_record_as_graphed_ones():
    tr, state, frames = _setup("beam", graphed=None)
    telemetry.enable()
    _run(tr, state, frames, steps=2, renders=1)
    kinds = [r.kind for r in _records()]
    assert kinds == ["train", "train", "render"]


def test_a_program_outside_a_trainer_records_nothing():
    """The stage split's rows: programs of the step's and the render's
    functions made and run outside `Trainer.step` and `Trainer.render`."""
    tr, state, frames = _setup("beam")
    telemetry.enable()
    fr = frames[0]
    rows = [
        lambda: render_fn("beam")(state.params, state.valid, fr, tr.mcfg, tr.rcfg, tr.bg)[0],
        lambda: tt.train_step(state, fr, tr.bg, tr.mcfg, tr.rcfg, tr.ocfg, update_stats=False),
    ]
    for fn in rows:
        graphs.StaticProgram(fn, lambda out: out, torch.device("cpu")).run()
    assert not _records()


def test_the_profiler_switches_it_on_and_its_steps_are_left_out():
    from torch.profiler import ProfilerActivity, profile

    tr, state, frames = _setup("beam")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for it in (1, 2):
            state, _ = tr.step(state, frames[it], it)
    assert telemetry.on
    for it in (3, 4):
        state, _ = tr.step(state, frames[it % 4], it)
    s = telemetry.summary("train")
    assert s["steps"] == 2 and s["profiled_steps"] == 2
    assert [r.profiled for r in _records()] == [True, True, False, False]
    keys = {e.key for e in prof.key_averages()}
    assert {"step", "copy_in", "replay", "clone_metrics"} <= keys


def _new_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [m for m in bench["per_layer"] if m["source"] in ("program_span", "program_counter")
            and m["name"].split(".")[0] in ("stage_front_ms", "stage_raster_ms",
                                            "stage_composite_ms", "stage_loss_ms",
                                            "stage_adam_ms", "stage_densify_ms", "host_gap_ms",
                                            "front_fill_pct", "tile_overflow")]


def test_the_benchmark_readers_read_the_recorder():
    from portbench import registry

    metrics = _new_metrics()
    assert len(metrics) == 15
    readers = {m["name"]: registry.reader(m["name"]) for m in metrics}
    for name, read in readers.items():
        kind = name.split(".")[1]
        other = "render" if kind == "train" else "train"
        assert read(SimpleNamespace(kind=kind)) is None, name        # nothing recorded
        assert read(SimpleNamespace(kind=other)) is None, name
    tr, state, frames = _setup("beam")
    telemetry.enable()
    _run(tr, state, frames)
    for name, read in readers.items():
        kind = name.split(".")[1]
        v = read(SimpleNamespace(kind=kind))
        assert isinstance(v, float) and np.isfinite(v) and v >= 0, name
        assert read(SimpleNamespace(kind="render" if kind == "train" else "train")) is None


@pytest.mark.cuda
def test_graphed_beam_step_stages_sum_to_its_span_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    tr, state, frames = _setup("beam", device="cuda")
    state, _ = tr.step(state, frames[0], 1)           # the capture, recorder off
    telemetry.enable()
    for it in range(2, 6):
        state, _ = tr.step(state, frames[it % 4], it)
    s = telemetry.summary("train")
    assert s["steps"] == 4 and s["clock"] and s["clock"][0]["error_ns"] >= 0
    for rec in _records():
        t = [v for _, v in rec.stamps]
        assert all(b > a for a, b in zip(t, t[1:])), t
    assert all(v > 0 for v in s["stage_ms"].values())
    assert sum(s["stage_ms"].values()) == pytest.approx(s["graph_ms"], rel=0.01)
