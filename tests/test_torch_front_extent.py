"""The live extent (`train/graphs.py` `LiveExtent`, `extent_rule`): a
`Trainer` runs the front of its steps and renders on the anchor rows [0, B)
below which every live anchor lies, on the CPU.

  * the rule, over random `valid` masks with holes, growth and pruning: B
    never falls below the mark, never shrinks, moves in sixteenths of the
    capacity C, is read again only for a new or rewritten `valid`, and is C
    at a full table;
  * one step on B < C against the same step on the whole capacity: the
    parameters, Adam's moments, the four statistics within a relative norm
    of 1e-5 (the heads' weight gradients sum their rows in another order),
    the loss and the counts exactly; at a full table B = C and the
    trainer's step is `train_step`'s bit for bit;
  * `graphed=True` (the CPU stand-in of the graphs) against `graphed=False`
    at B < C, four steps with a densify, bit for bit;
  * a densify that grows the mark past B: the step's programs are made
    anew on the new B (the captures counted), and `Trainer.render` of the
    step's own state equals an eager render on the whole capacity, where
    one on the old B would drop the new anchors;
  * the data-parallel step and the stage split's rows run on the whole
    capacity, as before.
16x256 range view, feat 8, k = 2, hidden 8, 300 of 512 anchors (B 320).
"""
import numpy as np
import pytest
import torch

from lidargs_torch.config import ModelConfig, OptConfig, RasterConfig
from lidargs_torch.lidar import LidarFrame, stack_frames, uniform_beam_inclinations
from lidargs_torch.models.field import AnchorField
from lidargs_torch.parallel.shard import DPTrainer, dp_train_step
from lidargs_torch.train import graphs
from lidargs_torch.train import trainer as tt
from lidargs_torch.utils import prefixes
from lidargs_torch.utils.profiling import telemetry
from lidargs_torch.utils.testing import one_torch_thread, sensor_poses, shell_field

H, W = 16, 256
MODEL = dict(feat_dim=8, n_offsets=2, mlp_hidden=8, anchor_capacity=512)
RASTER = {"beam": dict(tile_h=4, tile_capacity=64, max_tiles_per_gaussian=8, max_visible=2048,
                       chunk=8),
          "surfel": dict(tile_h=1, tile_capacity=64, max_tiles_per_gaussian=8,
                         max_visible=2048, chunk=8)}
# statistics for steps 1-2, a densify after step 2
OPT = dict(start_stat=0, update_from=0, update_interval=2, update_until=3, dist_from=0,
           normal_from=0)
C, K = MODEL["anchor_capacity"], MODEL["n_offsets"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


def _setup(variant: str, n: int = 300):
    """(trainer maker, state of `n` live anchors, 4 frames)."""
    mcfg = ModelConfig(**MODEL)
    rcfg = RasterConfig(**RASTER[variant])
    params, valid = shell_field(mcfg, n, seed=0, device="cpu")
    state = tt.init_train_state(AnchorField(params=params, valid=valid, voxel_size=0.1), mcfg)
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    rng = np.random.default_rng(1)
    frames = []
    for i, pose in enumerate(sensor_poses(4, seed=2)):
        gt = np.zeros((3, H, W), np.float32)
        gt[0] = rng.uniform(size=(H, W)) > 0.2
        gt[1] = rng.uniform(size=(H, W)) * gt[0]
        gt[2] = rng.uniform(5.0, 70.0, size=(H, W)) * gt[0]
        frames.append(LidarFrame.from_lidar2world(pose, beams, gt, uid=i, device="cpu"))

    def make(graphed, cls=tt.Trainer):
        return cls(mcfg=mcfg, ocfg=OptConfig(**OPT), rcfg=rcfg, bg=torch.zeros(2),
                   variant=variant, graphed=graphed)
    return make, state, frames


def _relnorm(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _mark(valid) -> int:
    live = np.flatnonzero(valid.numpy())
    return int(live[-1]) + 1 if live.size else 0


@pytest.mark.parametrize("cap", [512, 300, 2 ** 17])
def test_the_extent_holds_every_live_row(cap, monkeypatch):
    rng = np.random.default_rng(cap)
    q = max(cap // graphs.QUANTA, 1)
    reads = []
    read = graphs.live_mark
    monkeypatch.setattr(graphs, "live_mark", lambda v: reads.append(1) or read(v))
    ext = graphs.LiveExtent()
    valid = torch.arange(cap) < int(0.3 * cap)
    B = ext(valid)
    assert B == graphs.extent_rule(_mark(valid), cap) == min(cap, q * -(-_mark(valid) // q))
    for t in range(60):
        op = rng.integers(4)
        if op == 0:      # prune: holes anywhere, a new tensor (densify's)
            valid = valid & torch.from_numpy(rng.uniform(size=cap) > 0.1)
        elif op == 1:    # grow into the first free rows, a new tensor
            free = torch.nonzero(~valid).flatten()[:int(rng.integers(1, max(cap // 8, 2)))]
            valid = valid.clone()
            valid[free] = True
        elif op == 2:    # written in place: the same tensor, another version
            valid[int(rng.integers(cap))] = True
        n_reads = len(reads)
        prev, B = B, ext(valid)
        assert len(reads) == n_reads + (op != 3)     # op 3: the same tensor as it was
        mark = _mark(valid)
        assert mark <= B <= cap and B >= prev
        assert B == cap or B % q == 0
        if B > prev:     # grown past: the mark rounded up, one quantum of headroom
            assert B == min(cap, q * -(-mark // q) + q)
    full = torch.ones(cap, dtype=torch.bool)
    assert graphs.LiveExtent()(full) == cap
    top = q * ((cap - 1) // q)          # the last multiple of q below C
    assert graphs.extent_rule(top + 1, cap) == graphs.extent_rule(cap, cap) == cap
    assert graphs.extent_rule(0, cap) == q
    # a table of another capacity starts afresh
    assert ext(torch.arange(2 * cap) < 1) == max(2 * cap // graphs.QUANTA, 1)


@pytest.mark.parametrize("variant", ["beam", "surfel"])
def test_a_step_on_the_extent_equals_the_whole_capacity(variant):
    make, state, frames = _setup(variant)
    tr = make(False)
    args = (tr.bg, tr.mcfg, tr.rcfg, tr.ocfg)
    # from the first state and from one two steps on
    later = state
    for it in (1, 2):
        later = tt.train_step(later, frames[it], *args, variant=variant)[0]
    for st in (state, later):
        full, m_f = tt.train_step(st, frames[0], *args, variant=variant, extent=C)
        cut, m_c = tt.train_step(st, frames[0], *args, variant=variant, extent=320)
        for a, b in zip(tt.state_leaves(cut), tt.state_leaves(full)):
            assert a.shape == b.shape
            assert torch.equal(a, b) or _relnorm(a, b) <= 1e-5
        for a, b in zip(list(m_c.loss) + list(m_c[1:]), list(m_f.loss) + list(m_f[1:])):
            assert torch.equal(a, b)
        assert int(m_c.n_visible) > 0
    # a full table: B = C, and the trainer's step is today's bit for bit
    make, state, frames = _setup(variant, n=500)
    tr = make(None)
    got, m_g = tr.step(state, frames[0], 1)
    want, m_w = tt.train_step(state, frames[0], *args, variant=variant)
    assert tr.extent == C
    for a, b in zip(tt.state_leaves(got) + list(m_g.loss), tt.state_leaves(want) + list(m_w.loss)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["beam", "surfel"])
def test_graphed_equals_eager_on_the_extent(variant):
    make, state, frames = _setup(variant)
    tr, eager = make(True), make(False)
    got = want = state
    for it in range(1, 5):
        got, m_g = tr.step(got, frames[it - 1], it)
        want, m_w = eager.step(want, frames[it - 1], it)
        assert tr.extent == eager.extent == 320
        for a, b in zip(tt.state_leaves(got) + list(m_g.loss) + list(m_g[1:]),
                        tt.state_leaves(want) + list(m_w.loss) + list(m_w[1:])):
            assert torch.equal(a, b), it
        if it == 2:
            gen = lambda: torch.Generator().manual_seed(7)
            got, _ = tr.densify(got, gen(), 0.1)
            want, _ = eager.densify(want, gen(), 0.1)
    r_g = tr.render(got.params, got.valid, frames[3])
    r_e = eager.render(want.params, want.valid, frames[3])
    assert r_g.visible.shape == (320 * K,)
    for a, b in zip(r_g, r_e):
        assert a is None and b is None or torch.equal(a, b)


@pytest.mark.parametrize("variant,n", [("beam", 315), ("surfel", 317)])
def test_a_densify_past_the_extent_is_captured_anew(variant, n):
    """`n` live anchors (B 320) that the densify grows past 320."""
    make, state, frames = _setup(variant, n)
    tr = make(True)
    s = state
    for it in (1, 2):
        s, _ = tr.step(s, frames[it - 1], it)
    r_old = tr.render(s.params, s.valid, frames[3])
    assert tr.extent == 320 and r_old.visible.shape == (320 * K,)
    made = telemetry.captures
    s, ds = tr.densify(s, torch.Generator().manual_seed(7), 0.1)
    mark = _mark(s.valid)
    assert int(ds.n_grown) > 0 and mark > 320
    assert tr.extent == 384 >= mark                  # read at the densify, one quantum above
    s, _ = tr.step(s, frames[2], 3)                   # statistics off: a new key
    s, _ = tr.step(s, frames[0], 4)
    assert s is tr._steps.state and _mark(s.valid) == mark
    assert {k[2] for k in tr._steps.programs} == {384}
    got = tr.render(s.params, s.valid, frames[3])     # the static state, rewritten in place
    assert telemetry.captures == made + 2 and telemetry.extent == 384
    eager = graphs.RenderGraphs(variant, tr.mcfg, tr.rcfg, tr.bg, graphed=False)
    want = eager(s.params, s.valid, frames[3], extent=C)
    for name in ("color", "depth", "occ", "n_dropped", "n_overflow"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.visible, want.visible[:384 * K]) and not want.visible[384 * K:].any()
    # the hazard: the old extent would leave the grown anchors out
    stale = eager(s.params, s.valid, frames[3], extent=320)
    assert want.visible[320 * K:].any()
    assert int(stale.visible.sum()) < int(want.visible.sum()) == int(got.visible.sum())


def test_the_data_parallel_step_and_the_rows_run_on_the_whole_capacity():
    make, state, frames = _setup("beam")
    dp = make(True, DPTrainer)
    batch = stack_frames(frames[:2])
    got, m_g = dp.step(state, batch, 1)
    want, m_w = dp_train_step(state, batch, dp.bg, dp.mcfg, dp.rcfg, dp.ocfg)
    assert dp.extent is None and all(len(k) == 2 for k in dp._steps.programs)
    for a, b in zip(tt.state_leaves(got) + list(m_g.loss), tt.state_leaves(want) + list(m_w.loss)):
        assert torch.equal(a, b)
    # the stage split's train rows: the render and the proxy on every row
    rows = dict(prefixes.train_rows(dp.mcfg, dp.rcfg, dp.ocfg, dp.bg))
    out = rows["render fwd"](state, frames[0])
    (_, ng, anchor_vis, _), grads, proxy_grad = rows["fwd + loss + grad"](state, frames[0])
    assert out.visible.shape == (C * K,) and proxy_grad.shape == (C, K, 3)
    assert anchor_vis.shape == (C,) and ng.xyz.shape == (C, K, 3)
    step = rows["full step (stats)"](state, frames[0])[0]
    ref = tt.train_step(state, frames[0], dp.bg, dp.mcfg, dp.rcfg, dp.ocfg, extent=C)[0]
    for a, b in zip(tt.state_leaves(step), tt.state_leaves(ref)):
        assert torch.equal(a, b)
