"""A whole run on the CPU at a tiny size, past the look for a card: sound,
the check holds; with the timed path broken underneath, it does not."""
import time

import pytest
import torch

from portbench import run
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11


def one_run(name: str, seconds: float = 0.5):
    return run.run_cell(tiny_cell(name), SEED, seconds, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", ["beam-train-street", "surfel-train-street",
                                  "beam-render-street", "surfel-render-street"])
def test_sound_run_is_correct(name):
    res = one_run(name)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("name", ["beam-train-street", "surfel-train-street"])
def test_step_that_returns_its_state_unchanged(name, monkeypatch):
    from lidargs_torch.train import trainer

    step = trainer.Trainer.step

    def unchanged(self, state, frame, iteration):
        kept = trainer.clone_state(state)
        _, metrics = step(self, state, frame, iteration)
        return kept, metrics

    monkeypatch.setattr(trainer.Trainer, "step", unchanged)
    res = one_run(name)
    assert not res["correct"]
    assert res["check"]["step_gap"]["value"] > res["check"]["step_gap"]["limit"]


@pytest.mark.parametrize("name", ["beam-train-street", "surfel-train-street"])
def test_half_of_the_batch_left_out(name, monkeypatch):
    from lidargs_torch.train import trainer

    losses = trainer.lidar_losses

    def half(color, depth, gt, *a, **kw):
        rows = gt.shape[-2] // 2
        return losses(color[:, :rows], depth[:rows], gt[:, :rows], *a, **kw)

    monkeypatch.setattr(trainer, "lidar_losses", half)
    res = one_run(name)
    assert not res["correct"]


@pytest.mark.parametrize("name", ["beam-render-street", "surfel-render-street"])
def test_answer_altered_where_it_is_produced(name, monkeypatch):
    from lidargs_torch.train import trainer

    render = trainer.Trainer.render

    def altered(self, params, valid, frame):
        out = render(self, params, valid, frame)
        d, m = out.depth.clone(), out.depth.shape[0] // 2
        d[[m - 1, m]] = out.depth[[m, m - 1]]
        return out._replace(depth=d)

    monkeypatch.setattr(trainer.Trainer, "render", altered)
    res = one_run(name)
    assert not res["correct"]
    assert res["check"]["far_share"]["value"] > res["check"]["far_share"]["limit"]
