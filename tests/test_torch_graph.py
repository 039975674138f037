"""The training step and the render as static programs (`train/graphs.py`,
`Trainer(graphed=...)`), on the CPU.

A CUDA graph captures only work that the card does: a tensor built from
Python data (a pageable host-to-device copy) or a read back to the host
cannot be captured. On the CPU, `Trainer(graphed=True)` runs the graphs'
bookkeeping (static state buffers written in place, the state donated,
static frame buffers, one program per key) with the program's function
called in place of a replay. The tests:
  * one beam, one surfel and one masked beam step and render each, with
    `torch.tensor` (and `torch.as_tensor` of Python data, and every read of
    a tensor's value back to Python) patched to raise inside them, but for
    the live extent's one read of the first state's mark, counted;
  * the static-buffer step against `train_step` on the trainer's live
    extent bit for bit over 4 steps,
    with the statistics on for steps 1-2 and off for 3-4 and a densify
    after step 2, for beam, surfel and masked beam; the render of the
    donated state against the eager one;
  * the static-buffer step against JAX's `train_step` for 2 steps, at the
    tolerances of `test_torch_surfel_train.py::test_trainer_steps_follow_jax`:
    the total loss within 1e-3 relative, the accumulated proxy-gradient
    norms within 1e-2 relative norm (Adam's first step is a sign step, so
    later proxy gradients drift), their counts equal;
  * the launcher's count (`utils/cuda_build.py` `launches`): each launch
    under its symbol, none for a launch that returns an error; over a
    program's capture and replays, with `torch.cuda`'s stream and graph
    calls replaced by stand-ins that record them; a failed capture raises;
    every capture warms up on one side stream;
  * the scale regularizer's product, whose backward no longer reads back
    to the host, against `torch.prod`'s value and gradient bit for bit.
16x256 range view, feat 8, k = 2, hidden 8, 300 of 512 anchors.
"""
import collections
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import ModelConfig as JM
from lidargs_tpu.config import OptConfig as JO
from lidargs_tpu.config import RasterConfig as JR
from lidargs_tpu.train import trainer as jt
from lidargs_torch.config import ModelConfig, OptConfig, RasterConfig
from lidargs_torch.lidar import LidarFrame, uniform_beam_inclinations
from lidargs_torch.models.field import AnchorField
from lidargs_torch.train import graphs
from lidargs_torch.train import trainer as tt
from lidargs_torch.utils import cuda_build
from lidargs_torch.utils.params import train_state_from_jax
from lidargs_torch.utils.stage_split import KERNELS
from lidargs_torch.utils.testing import one_torch_thread, sensor_poses, shell_field
from test_torch_surfel_train import MODEL as SMODEL
from test_torch_surfel_train import ON as SON
from test_torch_surfel_train import RASTER as SRASTER
from test_torch_surfel_train import _frames as surfel_frames
from test_torch_surfel_train import _jax_state as surfel_jax_state
from test_torch_surfel_train import _relnorm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


H, W = 16, 256
MODEL = dict(feat_dim=8, n_offsets=2, mlp_hidden=8, anchor_capacity=512)
RASTER = {"beam": dict(tile_h=4, tile_capacity=64, max_tiles_per_gaussian=8, max_visible=2048,
                       chunk=8),
          "surfel": dict(tile_h=1, tile_capacity=64, max_tiles_per_gaussian=8,
                         max_visible=2048, chunk=8)}
# (variant, masked)
KINDS = {"beam": ("beam", False), "surfel": ("surfel", False), "masked": ("beam", True)}
# statistics for steps 1-2, a densify after step 2
OPT = dict(start_stat=0, update_from=0, update_interval=2, update_until=3, dist_from=0,
           normal_from=0)


def _setup(kind: str):
    """(trainer maker, state, frames) of one kind of step."""
    variant, masked = KINDS[kind]
    mcfg = ModelConfig(**MODEL)
    rcfg = RasterConfig(**RASTER[variant])
    params, valid = shell_field(mcfg, 300, seed=0, device="cpu")
    state = tt.init_train_state(AnchorField(params=params, valid=valid, voxel_size=0.1), mcfg)
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    rng = np.random.default_rng(1)
    frames = []
    for i, pose in enumerate(sensor_poses(4, seed=2)):
        gt = np.zeros((3, H, W), np.float32)
        gt[0] = rng.uniform(size=(H, W)) > 0.2
        gt[1] = rng.uniform(size=(H, W)) * gt[0]
        gt[2] = rng.uniform(5.0, 70.0, size=(H, W)) * gt[0]
        mask = rng.uniform(size=(H, W)) > 0.4 if masked else None
        frames.append(LidarFrame.from_lidar2world(pose, beams, gt, uid=i, pixel_mask=mask,
                                                  device="cpu"))

    def make(graphed):
        return tt.Trainer(mcfg=mcfg, ocfg=OptConfig(**OPT), rcfg=rcfg, bg=torch.zeros(2),
                          variant=variant, graphed=graphed)
    return make, state, frames


def _leaves(state):
    return [x.clone() for x in tt.state_leaves(state)]


def _refuse(*_a, **_k):
    raise AssertionError("the graphed path built a tensor from Python data or read one back")


@pytest.mark.parametrize("kind", list(KINDS))
def test_step_and_render_build_no_tensor_from_python_data(kind, monkeypatch):
    make, state, frames = _setup(kind)
    tr = make(True)
    as_tensor = torch.as_tensor

    def as_tensor_of_a_tensor(x, *a, **k):
        if not isinstance(x, torch.Tensor):
            _refuse()
        return as_tensor(x, *a, **k)

    # the live extent's one host read, of the first state's mark, outside
    # the programs: its value is read here, and the reads counted
    mark, reads = graphs.live_mark(state.valid), []
    with monkeypatch.context() as mp:
        mp.setattr(torch, "tensor", _refuse)
        mp.setattr(torch, "as_tensor", as_tensor_of_a_tensor)
        for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__"):
            mp.setattr(torch.Tensor, name, _refuse)
        mp.setattr(graphs, "live_mark", lambda valid: reads.append(valid) or mark)
        s, m = tr.step(state, frames[0], 1)
        s, m = tr.step(s, frames[1], 2)
        out = tr.render(s.params, s.valid, frames[2])
    assert np.isfinite(float(m.loss.total)) and out.color.shape == (2, H, W)
    assert len(reads) == 1 and reads[0] is state.valid and tr.extent == 320


@pytest.mark.parametrize("kind", list(KINDS))
def test_static_buffer_step_equals_train_step(kind):
    """Four steps of `Trainer(graphed=True)` (the static-buffer program,
    called in place of a replay) give `train_step`'s TrainState and
    metrics bit for bit; a densify in between; the state passed in is left
    as it was; the render of the donated state equals the eager one."""
    make, state0, frames = _setup(kind)
    tr, eager = make(True), make(False)
    before = _leaves(state0)
    got = want = state0
    for it in range(1, 5):
        collect = tr.ocfg.start_stat < it < tr.ocfg.update_until
        prev = got
        got, m_g = tr.step(got, frames[it - 1], it)
        # on the anchor rows the trainer's step ran on (its live extent)
        want, m_w = tt.train_step(want, frames[it - 1], eager.bg, eager.mcfg, eager.rcfg,
                                  eager.ocfg, update_stats=collect, variant=eager.variant,
                                  extent=tr.extent)
        if it > 1 and it != 3:
            assert got is prev          # donated: the same buffers, written in place
        for a, b in zip(tt.state_leaves(got), tt.state_leaves(want)):
            assert torch.equal(a, b), it
        for a, b in zip(list(m_g.loss) + list(m_g[1:]), list(m_w.loss) + list(m_w[1:])):
            assert torch.equal(a, b), it
        if it == 2:
            gen = lambda: torch.Generator().manual_seed(7)
            got, st_g = tr.densify(got, gen(), 0.1)
            want, st_w = eager.densify(want, gen(), 0.1)
            assert int(st_g.n_grown) == int(st_w.n_grown)
    assert set(tr._steps.programs) == {(True, graphs.frame_layout(frames[0]), tr.extent),
                                       (False, graphs.frame_layout(frames[0]), tr.extent)}
    for a, b in zip(tt.state_leaves(state0), before):
        assert torch.equal(a, b)
    r_g = tr.render(got.params, got.valid, frames[3])
    r_e = eager.render(want.params, want.valid, frames[3])
    for a, b in zip(r_g, r_e):
        assert torch.equal(a, b)
    # the render program reads the donated buffers where they lie: another
    # step changes what it renders without a new program
    program = tr._renders.programs[frames[3].pixel_mask is None][3]
    got, _ = tr.step(got, frames[0], 5)
    want, _ = tt.train_step(want, frames[0], eager.bg, eager.mcfg, eager.rcfg, eager.ocfg,
                            update_stats=False, variant=eager.variant, extent=tr.extent)
    r_g = tr.render(got.params, got.valid, frames[3])
    assert tr._renders.programs[frames[3].pixel_mask is None][3] is program
    assert torch.equal(r_g.color, eager.render(want.params, want.valid, frames[3]).color)


def test_a_state_of_another_capacity_is_captured_anew():
    make, state, frames = _setup("beam")
    tr = make(True)
    s, _ = tr.step(state, frames[0], 1)
    buffers = tr._steps.state
    mcfg = ModelConfig(**{**MODEL, "anchor_capacity": 256})
    params, valid = shell_field(mcfg, 200, seed=0, device="cpu")
    small = tt.init_train_state(AnchorField(params=params, valid=valid, voxel_size=0.1), mcfg)
    s2, _ = tr.step(small, frames[0], 1)
    assert s2 is not buffers and s2.params["anchor"].shape[0] == 256
    assert len(tr._steps.programs) == 1
    want, _ = tt.train_step(small, frames[0], tr.bg, tr.mcfg, tr.rcfg, tr.ocfg,
                            update_stats=True)
    for a, b in zip(tt.state_leaves(s2), tt.state_leaves(want)):
        assert torch.equal(a, b)


def test_graphed_none_runs_eagerly_on_the_cpu():
    make, state, frames = _setup("beam")
    tr = make(None)
    s, _ = tr.step(state, frames[0], 1)
    tr.render(s.params, s.valid, frames[0])
    assert tr._steps is None and not tr._renders.programs and s is not state
    assert not graphs.use_graphs(None, torch.device("cpu"))
    assert graphs.use_graphs(None, torch.device("cuda"))
    assert not graphs.use_graphs(False, torch.device("cuda"))


@pytest.mark.parametrize("variant", ["beam", "surfel"])
def test_static_buffer_step_follows_jax(variant):
    """Two steps of the static-buffer program against two of JAX's jitted
    `train_step` (its Trainer, state donated: fresh arrays each step), from
    `test_torch_surfel_train.py`'s state and frames, statistics on."""
    opt = dict(SON, start_stat=0, update_from=0)
    bg = np.zeros(2, np.float32)
    jtr = jt.Trainer(mcfg=JM(**SMODEL), ocfg=JO(**opt), rcfg=JR(**SRASTER), bg=jnp.asarray(bg),
                     variant=variant)
    ttr = tt.Trainer(mcfg=ModelConfig(**SMODEL), ocfg=OptConfig(**opt),
                     rcfg=RasterConfig(**SRASTER), bg=torch.from_numpy(bg), variant=variant,
                     graphed=True)
    js_, ts_ = surfel_jax_state(), train_state_from_jax(surfel_jax_state(), device="cpu")
    lj, lt = [], []
    for it, (jfr, tfr) in enumerate(surfel_frames(2, seed=4), start=1):
        s, m = jtr.step(jax.tree.map(jnp.asarray, js_), jfr, it)
        js_ = jax.tree.map(np.asarray, s)
        lj.append(float(m.loss.total))
        ts_, m = ttr.step(ts_, tfr, it)
        lt.append(float(m.loss.total))
    np.testing.assert_allclose(lt, lj, rtol=1e-3)
    assert int(ts_.step) == 2 and float(ts_.anchor_demon.max()) == 2.0
    assert float(ts_.offset_grad_accum.sum()) > 0
    assert _relnorm(ts_.offset_grad_accum.numpy(), js_.offset_grad_accum) <= 1e-2
    np.testing.assert_array_equal(ts_.offset_denom.numpy(), js_.offset_denom)


class _FakeGraph:
    """A stand-in for `torch.cuda.CUDAGraph`: counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _Null:
    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def wait_stream(self, other):
        pass


def _fake_cuda(monkeypatch, capture=_Null):
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Null())
    monkeypatch.setattr(torch.cuda, "Stream", _Null)
    monkeypatch.setattr(torch.cuda, "stream", _Null)
    monkeypatch.setattr(torch.cuda, "device", _Null)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", capture)


@pytest.mark.parametrize("symbol", sorted(KERNELS.values()))
def test_the_launcher_counts_each_launch_under_its_symbol(monkeypatch, symbol):
    """`cuda_build.launch` counts a launch under its symbol; a launch that
    returns an error raises and counts nothing."""
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: SimpleNamespace(cuda_stream=0))
    launches = collections.Counter()
    monkeypatch.setattr(cuda_build, "launches", launches)
    errors = [0, 1]
    monkeypatch.setattr(cuda_build, "entry", lambda name, sym, argtypes: (
        lambda *args: errors.pop(0), lambda err: b"refused"))
    x = torch.zeros(4)
    cuda_build.launch("lib", symbol, [], (x,), ())
    assert launches == {symbol: 1}
    with pytest.raises(RuntimeError, match=f"{symbol} launch failed: refused"):
        cuda_build.launch("lib", symbol, [], (x,), ())
    assert launches == {symbol: 1} and not errors


def test_launch_counters_count_each_replay(monkeypatch):
    """The launcher's count moves at capture only: the program keeps the
    capture's change (and not the warm-up's) and adds it at each replay,
    for every kernel, N1-N3 among them."""
    _fake_cuda(monkeypatch)
    start = {KERNELS["K1"]: 5, KERNELS["K5"]: 5}
    launches = collections.Counter(start)
    monkeypatch.setattr(cuda_build, "launches", launches)
    calls = []
    per_run = {KERNELS["K1"]: 1, KERNELS["K2"]: 1, KERNELS["K8"]: 2, KERNELS["F1"]: 1,
               KERNELS["N1"]: 1}

    def compute():
        calls.append(1)
        launches.update(per_run)
        return torch.ones(3)

    prog = graphs.StaticProgram(compute, lambda out: out * 2, torch.device("cuda"))
    assert len(calls) == graphs.WARMUP + 1
    assert launches == start and prog.delta == per_run
    for i in range(1, 4):
        out = prog.run()
        assert torch.equal(out, torch.full((3,), 2.0)) and prog.graph.replays == i
        assert launches == {k: start.get(k, 0) + i * per_run.get(k, 0)
                            for k in {*start, *per_run}}
    assert len(calls) == graphs.WARMUP + 1      # a replay does not run the function


def test_captures_warm_up_on_one_stream(monkeypatch):
    """Every capture on a device warms up on the same side stream: the
    caching allocator keeps freed blocks per stream, so a stream per
    capture would leave each warm-up's blocks reserved for good."""
    made, used = [], []

    class Counted(_Null):
        def __init__(self, *a, **k):
            made.append(self)

    class Entered(_Null):
        def __init__(self, s):
            used.append(s)

    _fake_cuda(monkeypatch)
    monkeypatch.setattr(torch.cuda, "Stream", Counted)
    monkeypatch.setattr(torch.cuda, "stream", Entered)
    for _ in range(3):
        graphs.StaticProgram(lambda: torch.ones(2), lambda out: out, torch.device("cuda"))
    assert len(made) == 1
    assert len(used) == 3 and all(s is made[0] for s in used)


def test_a_failed_capture_raises_and_leaves_the_counters(monkeypatch):
    class Refused(_Null):
        def __enter__(self):
            raise RuntimeError("operation not permitted when stream is capturing")

    _fake_cuda(monkeypatch, capture=Refused)
    launches = collections.Counter({KERNELS["K2"]: 3})
    monkeypatch.setattr(cuda_build, "launches", launches)

    def compute():
        launches[KERNELS["K1"]] += 1
    with pytest.raises(RuntimeError, match="capturing"):
        graphs.StaticProgram(compute, lambda out: out, torch.device("cuda"))
    assert launches == {KERNELS["K2"]: 3}


def test_prod_last_gives_torch_prods_gradient_bit_for_bit():
    """The scale regularizer's product (`losses.prod_last`): torch.prod's
    value and gradient bit for bit, with and without zero factors, computed
    without reading anything back to the host."""
    from lidargs_torch.train.losses import prod_last

    rng = np.random.default_rng(3)
    for shape in [(400, 3), (300, 2), (5, 4, 3), (200, 1)]:
        for zeros in (False, True):
            x = rng.uniform(0.1, 3.0, size=shape).astype(np.float32)
            if zeros:
                x.reshape(-1)[::17] = 0.0
            g = torch.from_numpy(rng.normal(size=shape[:-1]).astype(np.float32))
            a = torch.from_numpy(x).requires_grad_(True)
            b = torch.from_numpy(x.copy()).requires_grad_(True)
            with pytest.MonkeyPatch.context() as mp:
                for name in ("item", "__bool__", "__int__"):
                    mp.setattr(torch.Tensor, name, _refuse)
                yb = prod_last(b)
                gb, = torch.autograd.grad(yb, b, g)
            ya = torch.prod(a, -1)
            ga, = torch.autograd.grad(ya, a, g)
            assert torch.equal(ya, yb) and torch.equal(ga, gb), (shape, zeros)
    with pytest.raises(ValueError, match="at most 3"):
        prod_last(torch.ones(2, 4))
