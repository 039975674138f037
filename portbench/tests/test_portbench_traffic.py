"""The inputs are the seed's alone; the rates are all work over all time."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import registry
from portbench.drive import checked_poses
from portbench.run import make_inputs
from portbench.scene import novel_poses
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
BIG = 2 ** 31 + 3


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    return [tree]


def test_inputs_are_deterministic_in_the_seed():
    cell = tiny_cell("beam-train-street")
    a, b, c = (make_inputs(cell, s, CPU) for s in (BIG, BIG, BIG + 1))
    for x, y in zip(leaves(a.params) + [a.valid, a.scene.init_points],
                    leaves(b.params) + [b.valid, b.scene.init_points]):
        assert torch.equal(x, y)
    for (p, g), (q, h) in zip(a.scene.train, b.scene.train):
        assert torch.equal(g, h) and all(torch.equal(u, v) for u, v in zip(p, q))
    # the world and the field are the configuration's: every seed asks for
    # the same work, in its own order
    assert torch.equal(a.params["feat"], c.params["feat"])
    t = cell.traffic
    render = tiny_cell("beam-render-street").traffic
    p1, p2, p3 = (novel_poses(s, t["scene"], render, CPU) for s in (BIG, BIG, BIG + 1))
    assert all(torch.equal(u, v) for x, y in zip(p1, p2) for u, v in zip(x, y))
    assert not all(torch.equal(u, v) for x, y in zip(p1, p3) for u, v in zip(x, y))
    assert checked_poses(BIG, 50, 6) == checked_poses(BIG, 50, 6)
    assert checked_poses(BIG, 50, 6) != checked_poses(BIG + 1, 50, 6)
    assert len(set(checked_poses(BIG, 50, 6))) == 6


def rec(**kw):
    base = dict(kind="train", iterations=0, window_s=0.0, latency_ms=[], densify_s=[],
                trace=None, rows={}, work=[])
    return SimpleNamespace(**{**base, **kw})


def test_rates_are_all_work_over_all_time():
    step = registry.reader("train_step_ms")
    frame = registry.reader("render_frame_ms")
    assert step(rec(iterations=400, window_s=5.0)) == pytest.approx(12.5)
    assert frame(rec(kind="render", iterations=2000, window_s=8.0)) == pytest.approx(4.0)
    assert step(rec(kind="render", iterations=10, window_s=1.0)) is None


def test_p95_is_over_every_frame():
    p95 = registry.reader("render_frame_p95_ms")
    lat = list(np.linspace(1.0, 100.0, 1000))
    assert p95(rec(kind="render", latency_ms=lat)) == pytest.approx(np.percentile(lat, 95))
    # one slow frame in twenty moves it: no median of chunks hides it
    lat = [4.0] * 900 + [40.0] * 100
    assert p95(rec(kind="render", latency_ms=lat)) == pytest.approx(40.0)


def test_densify_is_the_mean_of_every_call():
    d = registry.reader("densify_ms.train")
    assert d(rec(densify_s=[0.01, 0.03])) == pytest.approx(20.0)
    assert d(rec()) is None
