"""The reference agrees with the port's CPU path at a tiny size, and on
the card its control (TF32 on) fails the check."""
import pytest
import torch

from portbench import check
from portbench.drive import RenderDrive, TrainDrive, checked_poses
from portbench.run import make_inputs, reference_numbers
from portbench.scene import novel_poses
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 5


@pytest.mark.parametrize("name", ["beam-train-street", "surfel-train-street"])
def test_reference_steps_agree_with_the_port(name):
    cell = tiny_cell(name)
    inputs = make_inputs(cell, SEED, CPU)
    got = TrainDrive(cell, SEED, inputs, CPU).program_results()
    numbers, want = reference_numbers(cell, inputs, got, None)
    assert check.judge(numbers, cell.limits["limits"]), numbers


class _Segment:
    """A stand-in for the tracer: the traced segment's bounds, no profiler."""

    def __init__(self, start, count):
        self.start, self.count = start, count

    def __call__(self, n):
        pass


@pytest.mark.parametrize("name", ["beam-train-street", "surfel-train-street"])
def test_counts_follow_the_traced_segment(name):
    """The work a traced train step is credited with is counted on the field
    as the traced segment starts and on frames it drew, not on the inputs."""
    cell = tiny_cell(name)
    inputs = make_inputs(cell, SEED, CPU)
    drive = TrainDrive(cell, SEED, inputs, CPU)
    drive.window(0.0, _Segment(3, 4), count=10)
    params, valid, ids = drive.counted_inputs(cell.traffic["counted_frames"])
    assert len(ids) == cell.traffic["counted_frames"]
    assert set(ids) <= set(drive.traced_draws) and len(drive.traced_draws) == 4
    assert not torch.equal(params["feat"], inputs.params["feat"])
    work = check.reference_work(cell, inputs.scene, params, valid, ids)
    assert all(w.live_params == check.live_params(params, int(valid.sum())) for w in work)
    assert all(0 < w.visible_anchors <= int(valid.sum()) for w in work)
    assert all(w.composite_fwd.ops > 0 and w.composite_bwd.ops > w.composite_fwd.ops
               for w in work)


@pytest.mark.parametrize("name", ["beam-render-street", "surfel-render-street"])
def test_reference_frames_agree_with_the_port(name):
    cell = tiny_cell(name)
    inputs = make_inputs(cell, SEED, CPU)
    t = cell.traffic
    poses = novel_poses(SEED, t["scene"], t, CPU)
    ids = checked_poses(SEED, len(poses), t["checked_frames"])
    drive = RenderDrive(cell, SEED, inputs, CPU, poses, ids)
    drive.window(0.3)
    numbers, _ = reference_numbers(cell, inputs, drive.program_results(),
                                   {i: poses[i] for i in ids})
    assert check.judge(numbers, cell.limits["limits"]), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["beam-train-street", "beam-render-street"])
def test_control_fails_on_the_card(name, card):
    """The reference with TF32 on, in the program's place, fails a number."""
    cell = tiny_cell(name)
    cell = cell._replace(config={**cell.config, "sensor": {**cell.config["sensor"],
                                                           "H": 32, "W": 1024}})
    inputs = make_inputs(cell, SEED, card)
    if cell.traffic["kind"] == "train":
        frames = [0, 1, 2]
        want = check.reference_train(cell, inputs, frames)
        ctrl = check.reference_train(cell, inputs, frames, tf32=True)
        numbers = check.train_numbers(ctrl, want, inputs.params)
    else:
        t = cell.traffic
        poses = novel_poses(SEED, t["scene"], t, card)
        sel = {i: poses[i] for i in range(2)}
        want = check.reference_render(cell, inputs, sel)
        ctrl = check.reference_render(cell, inputs, sel, tf32=True)
        numbers = check.render_numbers(ctrl["frames"], want["frames"],
                                       cell.config["raster"]["far"], cell.limits["far_atol"])
    assert not check.judge(numbers, cell.limits["limits"]), numbers
