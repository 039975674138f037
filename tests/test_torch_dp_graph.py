"""The data-parallel step as static programs (`parallel/shard.py`
`dp_programs`, `DPTrainer(graphed=...)`), on the CPU, and its counts
against the JAX package's `make_dp_trainer`.

`DPTrainer(graphed=True)` runs the programs' bookkeeping on the CPU (static
state and stacked-frame buffers, the static `flat` and `worst` buffers that
the all-reduces work on in place between program A, `local_sums`, and
program B, `apply_sums`; the state donated; one pair of programs per key)
with each program's function called in place of a replay. The tests:
  * `n_visible` (each rank's first frame's, maxed over the data axis)
    against JAX's `make_dp_trainer` over a 1-device mesh with 4 local frames
    and a 2-device mesh with 2 each: equal within 2, the bound of
    `test_torch_parallel.py::test_dp_step_matches_jax` (the packages'
    projections differ by an ulp at the view's edge); the frames' counts
    differ by more than that, so the largest of every frame fails;
  * the graphed step against `graphed=False` bit for bit, every state leaf
    and the metrics, over 4 steps of 2 stacked frames with the statistics on
    for steps 1-2 and off for 3-4 and a densify after step 2, for beam,
    surfel and masked beam; the returned state is the static buffers, the
    state passed in is left as it was; a state of another capacity is
    captured anew;
  * no tensor built from Python data and no value read back inside a step;
  * the launcher's count over capture and replays, with `torch.cuda`'s
    stream and graph calls replaced by stand-ins (`test_torch_graph.py`);
    a failed capture of either program raises and leaves it as it was;
  * on a card (marker `cuda`, skipped here): graphed against eager, every
    leaf bit for bit.
Sizes: `test_torch_graph.py`'s (16x256, feat 8, k = 2, 300 of 512 anchors)
and `test_torch_parallel.py`'s for the JAX comparison (8x256, 200 of 256).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_graph as tg
import test_torch_parallel as tp
from lidargs_tpu.config import ModelConfig as JM
from lidargs_tpu.config import OptConfig as JO
from lidargs_tpu.config import RasterConfig as JR
from lidargs_tpu.lidar.frames import stack_frames as jstack
from lidargs_tpu.parallel.mesh import make_mesh as jmesh
from lidargs_tpu.parallel.shard import make_dp_trainer as jdp
from lidargs_torch.config import ModelConfig as TM
from lidargs_torch.config import OptConfig as TO
from lidargs_torch.config import RasterConfig as TR
from lidargs_torch.lidar import stack_frames
from lidargs_torch.models.field import AnchorField
from lidargs_torch.parallel import DPTrainer
from lidargs_torch.parallel.shard import apply_sums, local_sums
from lidargs_torch.train import graphs
from lidargs_torch.train import trainer as tt
from lidargs_torch.train.optim import tree_map
from lidargs_torch.utils import cuda_build
from lidargs_torch.utils.params import train_state_from_jax
from lidargs_torch.utils.testing import one_torch_thread, shell_field


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided per test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _setup(kind: str, device="cpu"):
    """(DPTrainer maker, state, two batches of two stacked frames) of one
    kind of `test_torch_graph.py`'s steps, on `device`."""
    make, state, frames = tg._setup(kind)
    t = make(False)
    bg = t.bg.to(device)

    def make_dp(graphed):
        return DPTrainer(mcfg=t.mcfg, ocfg=t.ocfg, rcfg=t.rcfg, bg=bg, variant=t.variant,
                         graphed=graphed)
    state = tt.TrainState(tree_map(lambda x: x.to(device), state.params),
                          tt.AdamState(tree_map(lambda x: x.to(device), state.opt.mu),
                                       tree_map(lambda x: x.to(device), state.opt.nu),
                                       state.opt.count.to(device)),
                          *(x.to(device) for x in state[2:]))
    frames = [f.to(device) for f in frames]
    return make_dp, state, [stack_frames(frames[:2]), stack_frames(frames[2:])]


def _assert_equal(got, want, m_g, m_w, it):
    for a, b in zip(tt.state_leaves(got), tt.state_leaves(want)):
        assert torch.equal(a, b), it
    for a, b in zip(list(m_g.loss) + list(m_g[1:]), list(m_w.loss) + list(m_w[1:])):
        assert torch.equal(a, b), it


def _four_steps(make, state0, batches):
    """Four graphed and four eager steps from `state0` (statistics for steps
    1-2, a densify after step 2), held bit for bit after each."""
    tr, eager = make(True if state0.valid.device.type == "cpu" else None), make(False)
    got = want = state0
    for it in range(1, 5):
        want, m_w = eager.step(want, batches[(it - 1) % 2], it)
        prev = got
        got, m_g = tr.step(got, batches[(it - 1) % 2], it)
        assert got is tr._steps.state
        if it > 1 and it != 3:
            assert got is prev          # donated: the same buffers, written in place
        _assert_equal(got, want, m_g, m_w, it)
        if it == 2:
            gen = lambda: torch.Generator(device=state0.valid.device).manual_seed(7)
            got, st_g = tr.densify(got, gen(), 0.1)
            want, st_w = eager.densify(want, gen(), 0.1)
            assert int(st_g.n_grown) == int(st_w.n_grown)
    return tr


@pytest.mark.parametrize("kind", list(tg.KINDS))
def test_graphed_dp_step_equals_eager(kind):
    make, state0, batches = _setup(kind)
    before = [x.clone() for x in tt.state_leaves(state0)]
    tr = _four_steps(make, state0, batches)
    flay = graphs.frame_layout(batches[0])
    assert set(tr._steps.programs) == {(True, flay), (False, flay)}
    for a, b in zip(tt.state_leaves(state0), before):
        assert torch.equal(a, b)


def test_dp_programs_build_no_tensor_from_python_data(monkeypatch):
    make, state, batches = _setup("beam")
    tr = make(True)
    as_tensor = torch.as_tensor

    def as_tensor_of_a_tensor(x, *a, **k):
        if not isinstance(x, torch.Tensor):
            tg._refuse()
        return as_tensor(x, *a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(torch, "tensor", tg._refuse)
        mp.setattr(torch, "as_tensor", as_tensor_of_a_tensor)
        for name in ("item", "tolist", "__bool__", "__int__", "__float__", "__index__"):
            mp.setattr(torch.Tensor, name, tg._refuse)
        s, m = tr.step(state, batches[0], 1)            # statistics on
        s, m = tr.step(s, batches[1], 10)               # and off
    assert np.isfinite(float(m.loss.total)) and len(tr._steps.programs) == 2


def test_a_state_of_another_capacity_is_captured_anew():
    make, state, batches = _setup("beam")
    tr = make(True)
    tr.step(state, batches[0], 1)
    buffers = tr._steps.state
    mcfg = TM(**{**tg.MODEL, "anchor_capacity": 256})
    params, valid = shell_field(mcfg, 200, seed=0, device="cpu")
    small = tt.init_train_state(AnchorField(params=params, valid=valid, voxel_size=0.1), mcfg)
    s2, m2 = tr.step(small, batches[0], 1)
    assert s2 is not buffers and s2.params["anchor"].shape[0] == 256
    assert len(tr._steps.programs) == 1
    want, m_w = make(False).step(small, batches[0], 1)
    _assert_equal(s2, want, m2, m_w, 1)


def _programs_on_a_fake_card(monkeypatch, capture=tg._Null):
    """Every StaticProgram captures as on a card, with `test_torch_graph.py`'s
    stand-ins for the stream and graph calls; the wrappers counted in a
    fresh count, which this returns."""
    tg._fake_cuda(monkeypatch, capture)
    init = graphs.StaticProgram.__init__
    monkeypatch.setattr(graphs.StaticProgram, "__init__",
                        lambda self, compute, commit, device, pool=None:
                        init(self, compute, commit, torch.device("cuda"), pool))
    chip_smoke.count_plain_launches(monkeypatch.setattr)
    launches = collections.Counter()
    monkeypatch.setattr(cuda_build, "launches", launches)
    return launches


def test_launch_counters_count_each_replay(monkeypatch):
    """Program A holds both frames' K1 and K2 launches (its capture's, not
    its warm-up's); each step's replay adds them once, B adds none."""
    launches = _programs_on_a_fake_card(monkeypatch)
    make, state, batches = _setup("beam")
    tr = make(True)
    s = state
    for i in range(1, 4):
        s, _ = tr.step(s, batches[i % 2], 1)
        assert launches == {"lidargs_composite_fwd": 2 * i, "lidargs_composite_bwd": 2 * i}
    assert len(tr._steps.programs) == 1


@pytest.mark.parametrize("failing", [0, 1], ids=["A", "B"])
def test_a_failed_capture_raises_and_leaves_the_counters(monkeypatch, failing):
    captures = []

    class Refused(tg._Null):
        def __enter__(self):
            captures.append(1)
            if len(captures) > failing:
                raise RuntimeError("operation not permitted when stream is capturing")
            return self

    launches = _programs_on_a_fake_card(monkeypatch, capture=Refused)
    make, state, batches = _setup("beam")
    tr = make(True)
    with pytest.raises(RuntimeError, match="capturing"):
        tr.step(state, batches[0], 1)
    assert len(captures) == failing + 1
    assert not launches and not tr._steps.programs


# frames of seed 3 reordered so that frame 0's count (181) is no smaller
# than frame 2's (177) and frame 1's (187) the largest
N_VISIBLE_ORDER = [2, 1, 0, 3]


@pytest.mark.parametrize("devices", [1, 2])
def test_dp_n_visible_matches_jax(devices):
    """JAX's `n_visible` is each device's first local frame's, maxed over
    the data axis: over 1 device with 4 frames frame 0's, over 2 devices
    with 2 each the larger of frames 0 and 2. The port's one-process step
    (eager and graphed) reads frame 0's, and for 2 ranks a fleet's order
    (each half's `local_sums`, the counts maxed) reads the larger of its
    halves' first frames."""
    jfs, tfs = tp._frames(4, seed=3)
    jfs, tfs = [jfs[i] for i in N_VISIBLE_ORDER], [tfs[i] for i in N_VISIBLE_ORDER]
    js0 = tp._jax_state()
    model, raster, opt, bg = tp.MODEL, tp.RASTER, dict(start_stat=0), np.zeros(2, np.float32)
    jstep = jdp(jmesh(data=devices, tile=1), JM(**model), JR(**raster), JO(**opt),
                bg=jnp.asarray(bg))
    _, jm = jstep(tp._fresh(js0), jstack(jfs))
    want = int(jm.n_visible)
    cfgs = (torch.from_numpy(bg), TM(**model), TR(**raster), TO(**opt))
    state = lambda: train_state_from_jax(js0, device="cpu")
    counts = [int(local_sums(state(), stack_frames([f]), *cfgs)[1][0]) for f in tfs]
    # the frames show the fault: the largest count of any frame is not JAX's
    assert abs(max(counts) - want) > 2, (counts, want)
    for graphed in (False, True):
        _, tm = DPTrainer(mcfg=cfgs[1], ocfg=cfgs[3], rcfg=cfgs[2], bg=cfgs[0],
                          graphed=graphed).run_step(state(), stack_frames(tfs), True)
        assert abs(int(tm.n_visible) - want) <= 2, (graphed, int(tm.n_visible), want)
        assert int(tm.n_visible) == counts[0]
    if devices == 2:
        halves = [local_sums(state(), stack_frames(tfs[h:h + 2]), *cfgs) for h in (0, 2)]
        _, tm = apply_sums(state(), halves[0][0] + halves[1][0],
                           torch.maximum(halves[0][1], halves[1][1]), 4, cfgs[3])
        assert abs(int(tm.n_visible) - want) <= 2
        assert int(tm.n_visible) == max(counts[0], counts[2])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(tg.KINDS))
def test_graphed_dp_step_equals_eager_on_the_card(kind, card):
    """On the card `DPTrainer`'s default replays CUDA graphs: four steps
    against `graphed=False`, every leaf and the metrics bit for bit."""
    make, state0, batches = _setup(kind, card)
    tr = _four_steps(make, state0, batches)
    assert tr.graph_pool(card) is not None and len(tr._steps.programs) == 2
