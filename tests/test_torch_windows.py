"""The fused-window gather of the beam variant: `bin_instances_windows`, the
plain versions of kernels K3 and K4 and `mask_unwritten_rows` against the
JAX package, and the port's fused path against its own materialized one.

On the CPU, `_fused_fwd_call` and `_fused_bwd_call` run the TPU kernel
bodies `_fwd_kernel_fused` and `_bwd_kernel_fused` in interpret mode, on
small buffers that the JAX render path builds (T <= 16 tiles, K <= 64).
Tolerances, each with its reason:
  * binning: `gid`, `starts`, `counts` and `n_overflow` equal exactly (the
    same sort of the same int32 keys);
  * K3's plain version against the Pallas body: K1's (atol 1e-5 on the
    features and T, 1e-4 m on the depth, on all but 1% of the elements,
    `assert_close_up_to_flips`: a pixel at the 1e-4 transmittance threshold
    may stop one instance apart);
  * K4's plain version against the Pallas body and `mask_unwritten_rows`:
    each of the 14 + C gradient columns scaled by its largest magnitude,
    over the rows either side touches, per column at most 1% of those rows
    (and at least one) beyond 2e-5 and none beyond 1.0 (a row at a flipped
    pixel moves by up to its whole scale), as K2's plain version against
    its body; rows in no tile's owned range exactly zero in both;
  * the port's fused path against its materialized path on the CPU: the
    forward equal bit for bit on every channel and `n_overflow` equal (the
    same rows reach the same plain composite); gradients to the splat
    inputs within rtol 1e-5, atol 1e-7 (the JAX package's own bound for
    its pair, `tests/test_pallas_composite.py`).

PyTorch runs on one thread in this file. With eight, in about one fresh
process in twenty that had run the JAX pipeline first, one worker thread's
share of the first plain call (two of 16 tiles) came out up to 2.5e-4 off
in T, and the next call in the same process was right again; with one
thread none did in 80 processes (ROADMAP.md, section 3). The bit-for-bit
comparisons here could not survive that.

The `cuda` cases need a card and nvcc, and skip here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import RasterConfig as JCfg
from lidargs_tpu.ops import projection as jp
from lidargs_tpu.ops import rasterize as jr
from lidargs_tpu.ops.pallas_composite import _fused_bwd_call, _fused_fwd_call
from lidargs_tpu.ops.pallas_composite import mask_unwritten_rows as j_mask
from lidargs_torch.config import ModelConfig as TM
from lidargs_torch.config import OptConfig as TO
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.lidar import LidarFrame, uniform_beam_inclinations
from lidargs_torch.models.field import AnchorField
from lidargs_torch.ops import composite_kernel as ck
from lidargs_torch.ops import rasterize as tr
from lidargs_torch.ops.projection import PackedCols, preprocess_gaussians
from lidargs_torch.train import Trainer, init_train_state, loss_and_grads, measure_fps, run_eval
from lidargs_torch.train.optim import tree_leaves
from lidargs_torch.utils.testing import (assert_close_up_to_flips, make_scene, one_torch_thread,
                                         sensor_poses, shell_field)
from test_torch_rasterize import BASE, _bin_inputs, _jax_bin_inputs, _splats

C = 2
NV = 14 + C          # gradient columns: mean, u1, u2, conic, opacity, depth, feat


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


CASES = [
    dict(seed=0, n=200, H=8, W=256, tile_capacity=64),
    # tiny K and a starved instance budget: tiles overflow, so windows leave
    # gaps, and the rank search drops the farthest instances
    dict(seed=1, n=300, H=8, W=256, tile_capacity=16, max_tiles_per_gaussian=16,
         instance_capacity=1024),
    # an opaque pile-up: transmittance saturates, so the early exit fires
    dict(seed=2, n=400, H=8, W=128, tile_capacity=64, scale_px=8.0),
]


@pytest.mark.parametrize("tile_h,cap,budget", [
    (1, 64, 0),           # dense grid
    (1, 64, 300 * 64),    # rank search, budget covers every instance
    (2, 16, 1500),        # rank search, starved budget (farthest dropped)
])
def test_bin_instances_windows_equal_jax(tile_h, cap, budget):
    """Every integer of the window binning equals JAX's, with per-tile
    overflow (K = 16) in each case."""
    kw = dict(tile_h=tile_h, max_tiles_per_gaussian=cap, instance_capacity=budget,
              max_visible=256, tile_capacity=16)
    sc, jsp, tsp = _splats(3, n=300, **kw)
    jcfg, tcfg = JCfg(**{**BASE, **kw}), TCfg(**{**BASE, **kw})
    gy, gx = tcfg.grid_shape(sc.beams.shape[0], sc.W)
    rect, center, valid, _pkv, _ = _bin_inputs(tsp, tcfg, 256)
    jrect, jcenter, jvalid, _ = _jax_bin_inputs(jsp, jcfg)
    got = tr.bin_instances_windows(rect, center, valid, tcfg, gx, gy)
    want = jax.jit(lambda r, c, v: jr.bin_instances_windows(r, c, v, jcfg, gx, gy))(
        jrect, jcenter, jvalid)
    for name, a, b in zip(("gid", "starts", "counts"), got[:3], want[:3]):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(got[3]) == int(want[3]) > 0
    assert (got[2] == 16).any() and bool((got[1][1:] - got[1][:-1] > 16).any())   # gaps


def _window_inputs(seed, n, H, W, scale_px=2.0, **kw):
    """(JAX config, port config, buf, starts, counts, pix) as the JAX fused
    render path builds them (numpy)."""
    kw = {"max_visible": 512, "max_tiles_per_gaussian": 64, "chunk": 8, "fused_gather": True,
          **kw}
    jcfg = JCfg(pallas_chunk=8, backend="pallas", **kw)
    sc = make_scene(seed, n=n, H=H, W=W, scale_px=scale_px)
    beams = jnp.asarray(sc.beams)

    @jax.jit
    def build(*a):
        sp = jp.preprocess_gaussians(*a, beams, W, jcfg)
        P = sp.valid.shape[0]
        _, sel = jax.lax.sort((sp.depth, jnp.arange(P, dtype=jnp.int32)), num_keys=1,
                              is_stable=True)
        pkv = jr.permutation_rows(jp.pack_splats(sp), sel, min(jcfg.max_visible, P))
        gy, gx = jcfg.grid_shape(H, W)
        gid, starts, counts, _ = jr.bin_instances_windows(
            pkv[:, PackedCols.rect(C)].astype(jnp.int32), pkv[:, PackedCols.center(C)],
            pkv[:, PackedCols.validf(C)] > 0.0, jcfg, gx, gy)
        buf = jnp.pad(jnp.take(pkv, gid, axis=0, mode="clip"),
                      ((0, jcfg.tile_capacity), (0, 0)))
        px, py, dirs = jr._tile_pixels(H, W, jcfg, gx, gy, beams)
        return buf, starts, counts, jr._pix_blocks(px, py, dirs)

    out = build(sc.means3d, sc.scales, sc.quats, sc.opacities, sc.feat, sc.mask, sc.w2s_rot,
                sc.w2s_trans)
    return (jcfg, TCfg(**kw)) + tuple(np.array(x) for x in out)


@functools.lru_cache(maxsize=None)
def _case(i):
    """CASES[i]'s inputs, JAX's fused forward on them (the Pallas body in
    interpret mode) and a random cotangent; built once per process."""
    case = dict(CASES[i])
    seed, n, H, W = (case.pop(k) for k in ("seed", "n", "H", "W"))
    jcfg, tcfg, buf, starts, counts, pix = _window_inputs(seed, n, H, W, **case)
    res = np.asarray(jax.jit(lambda *a: _fused_fwd_call(*a, C, jcfg))(buf, starts, counts, pix))
    g = np.random.default_rng(7 + i).normal(size=pix.shape).astype(np.float32)
    g[:, C + 2:] = 0.0
    return jcfg, tcfg, buf, starts, counts, pix, res, g


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _owned(starts, counts, n_rows):
    """[n_rows] bool: the rows some tile owns, [start, start + count)."""
    r = np.arange(n_rows)
    return ((r[None] >= starts[:, None]) & (r[None] < (starts + counts)[:, None])).any(0)


def _compare_dbuf(got, want, starts, counts, nv=NV):
    """The backward bound of the docstring, over the rows either side
    touches; rows no tile owns are zero in both."""
    assert got.shape == want.shape
    own = _owned(starts, counts, got.shape[0])
    np.testing.assert_array_equal(got[~own], 0.0)
    np.testing.assert_array_equal(want[~own], 0.0)
    np.testing.assert_array_equal(got[:, nv:], 0.0)       # rect, center, valid, pad
    g, w = got[:, :nv], want[:, :nv]
    touched = (np.abs(g).max(-1) > 0) | (np.abs(w).max(-1) > 0)
    scale = np.maximum(np.abs(w).max(0), 1e-30)
    d = np.abs(g[touched] - w[touched]) / scale             # [touched rows, nv]
    far = (d > 2e-5).sum(0)
    assert (far <= max(1, 0.01 * touched.sum())).all() and d.max() <= 1.0, (far, d.max())
    assert touched.sum() > 100                               # many rows carry gradient


def _compare_out(out, ref):
    rows = list(range(C)) + [C + 1]
    assert_close_up_to_flips(out[:, rows], ref[:, rows], 1e-5, 2e-2, what="features, T")
    assert_close_up_to_flips(out[:, C], ref[:, C], 1e-4, 2.0, what="depth")
    np.testing.assert_array_equal(out[:, C + 2:], 0.0)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_k3_matches_pallas_fused_body(i):
    _, tcfg, buf, starts, counts, pix, res, _ = _case(i)
    out = ck.composite_windows_plain(*_t(buf, starts, counts, pix), C, tcfg).numpy()
    assert out.shape == res.shape == pix.shape
    _compare_out(out, res)
    assert res[:, C + 1].min() < 0.05 and (counts > 0).any()


@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_k4_matches_pallas_fused_body_and_mask(i):
    """Each side differentiates at its own forward's output."""
    jcfg, tcfg, buf, starts, counts, pix, res, g = _case(i)
    want = np.asarray(jax.jit(lambda *a: j_mask(_fused_bwd_call(*a, C, jcfg), a[1],
                                                jcfg.tile_capacity))(
        buf, starts, counts, pix, res, g))
    tb, ts, tc, tp = _t(buf, starts, counts, pix)
    res_t = ck.composite_windows_plain(tb, ts, tc, tp, C, tcfg)
    got = ck.composite_windows_bwd_plain(tb, ts, tc, tp, res_t, torch.from_numpy(g), C,
                                         tcfg).numpy()
    _compare_dbuf(got, want, starts, counts)


def test_mask_unwritten_rows_equals_jax_and_keeps_the_write_rule():
    """The port's `mask_unwritten_rows` equals JAX's on a buffer of noise,
    and leaves K4's plain output as it is in the overflow case, where
    windows leave gaps and the sentinel tail is long."""
    _, tcfg, buf, starts, counts, pix, res, g = _case(1)
    K = tcfg.tile_capacity
    assert (counts == K).any() and (np.diff(starts) > K).any()
    noise = np.random.default_rng(3).normal(size=buf.shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda d, s: j_mask(d, s, K))(noise, starts))
    got = ck.mask_unwritten_rows(*_t(noise, starts), K).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 0).all(1).any() and not (want == 0).all()
    tb, ts, tc, tp = _t(buf, starts, counts, pix)
    dbuf = ck.composite_windows_bwd_plain(tb, ts, tc, tp, *_t(res, g), C, tcfg)
    np.testing.assert_array_equal(ck.mask_unwritten_rows(dbuf, ts, K).numpy(), dbuf.numpy())


def test_window_wrappers_on_cpu_and_checks():
    """`CompositeWindows` on CPU tensors runs the plain versions and launches
    nothing; a device that is neither CPU nor CUDA, a window past the end of
    buf and a layout the kernels do not take are refused."""
    _, tcfg, buf, starts, counts, pix, _, g = _case(0)
    tb, ts, tc, tp = _t(buf, starts, counts, pix)
    x = tb.clone().requires_grad_(True)
    before = (ck.windows_launches, ck.windows_bwd_launches)
    out = ck.CompositeWindows.apply(x, ts, tc, tp, C, tcfg)
    out.backward(torch.from_numpy(g))
    assert (ck.windows_launches, ck.windows_bwd_launches) == before
    assert torch.equal(out.detach(), ck.composite_windows_plain(tb, ts, tc, tp, C, tcfg))
    assert torch.equal(x.grad, ck.composite_windows_bwd_plain(
        tb, ts, tc, tp, out.detach(), torch.from_numpy(g), C, tcfg))
    meta = [a.to("meta") for a in (tb, ts, tc, tp)]
    with pytest.raises(ValueError, match="unsupported device"):
        ck.composite_windows(*meta, C, tcfg)
    with pytest.raises(ValueError, match="unsupported device"):
        ck.composite_windows_bwd(*meta, out.to("meta"), out.to("meta"), C, tcfg)
    with pytest.raises(ValueError, match="leaves buf"):
        ck.composite_windows_plain(tb[:int(starts.max()) + tcfg.tile_capacity - 1], ts, tc, tp,
                                   C, tcfg)
    args = dict(buf=tb, starts=ts, counts=tc, pix=tp)
    for bad, err in ((dict(starts=ts.long()), TypeError), (dict(buf=tb[:5]), ValueError),
                     (dict(buf=tb.double()), TypeError), (dict(counts=tc[:-1]), ValueError),
                     (dict(buf=tb[:, :20]), ValueError)):
        with pytest.raises(err):
            a = {**args, **bad}
            ck.check_window_inputs(a["buf"], a["starts"], a["counts"], a["pix"],
                                   tcfg.tile_capacity, C, ck.OUT_ROWS - 2, PackedCols.rect(C).stop)


def _splat_leaves(seed, n, H, W, cfg):
    sc = make_scene(seed, n=n, H=H, W=W)
    t = lambda x: torch.from_numpy(np.array(x))
    sp = preprocess_gaussians(t(sc.means3d), t(sc.scales), t(sc.quats), t(sc.opacities),
                              t(sc.feat), t(sc.mask), t(sc.w2s_rot), t(sc.w2s_trans),
                              t(sc.beams), sc.W, cfg)
    return sc, sp


@pytest.mark.parametrize("kw", [
    dict(tile_h=4, tile_capacity=128),
    dict(tile_capacity=16, max_tiles_per_gaussian=16, instance_capacity=1024),
])
def test_fused_render_equals_materialized(kw):
    """`render_tiled` with `fused_gather` against without, on the same
    Splats: the forward bit for bit, the same overflow, and the gradients
    to every float input of the Splats."""
    base = {"max_visible": 512, "max_tiles_per_gaussian": 64, "chunk": 8, **kw}
    cfgs = TCfg(**base), TCfg(**base, fused_gather=True)
    sc, sp = _splat_leaves(4, 200, 8, 256, cfgs[0])
    w = torch.from_numpy(np.random.default_rng(9).uniform(size=(C + 2, 8, 256))
                         .astype(np.float32))
    outs = []
    for cfg in cfgs:
        leaves = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in sp]
        o = tr.render_tiled(type(sp)(*leaves), torch.from_numpy(sc.beams), sc.W,
                            torch.tensor([0.3, 0.7]), cfg)
        ((o.color * w[:C]).sum() + (o.depth * w[C]).sum() + (o.occ * w[C + 1]).sum()).backward()
        outs.append((o, [x.grad for x in leaves if x.requires_grad]))
    (a, ga), (b, gb) = outs
    for name in ("color", "depth", "occ", "final_T"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert int(a.n_overflow) == int(b.n_overflow) and float(a.occ.detach().max()) > 0.5
    if "instance_capacity" in kw:
        assert int(a.n_overflow) > 0
    for x, y in zip(gb, ga):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-7)
    assert sum(float(g.abs().sum()) for g in ga) > 0


# the entry points at a tiny size: the rehearsal size of chip_smoke.py
H, W = 16, 256
MODEL = dict(anchor_capacity=512, feat_dim=8, n_offsets=2, mlp_hidden=8)
RASTER = dict(tile_h=4, tile_capacity=64, max_tiles_per_gaussian=8, max_visible=2048)


def _field_and_frames(n_frames=1):
    mcfg = TM(**MODEL)
    params, valid = shell_field(mcfg, 300, seed=0, device="cpu")
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    rng = np.random.default_rng(4)
    frames = []
    for i, pose in enumerate(sensor_poses(n_frames, seed=2)):
        gt = np.zeros((3, H, W), np.float32)
        gt[0] = rng.uniform(size=(H, W)) > 0.2
        gt[1] = rng.uniform(size=(H, W)) * gt[0]
        gt[2] = rng.uniform(5.0, 70.0, size=(H, W)) * gt[0]
        frames.append(LidarFrame.from_lidar2world(pose, beams, gt, uid=i, device="cpu"))
    return mcfg, params, valid, frames


@pytest.mark.parametrize("variant", ["beam", "surfel"])
def test_entry_points_with_fused_gather(variant, tmp_path):
    """`measure_fps`, `run_eval`, `Trainer.render`, `Trainer.step` and
    `Trainer.densify` with `fused_gather` on CPU tensors, against the same
    calls without: renders equal bit for bit, one step's gradients per
    leaf within the bound above, the step's loss terms and overflow equal."""
    mcfg, params, valid, frames = _field_and_frames(2)
    bg = torch.zeros(2)
    rc = dict(RASTER, tile_h=1) if variant == "surfel" else RASTER
    cfgs = TCfg(**rc), TCfg(**rc, fused_gather=True)
    fps = [measure_fps(params, valid, frames, mcfg, c, bg, warmup=0, device="cpu",
                       variant=variant) for c in cfgs]
    for a, b in zip(*(r.outputs for r in fps)):
        for name in ("color", "depth", "occ"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert int(a.n_overflow) == int(b.n_overflow)
    evals = [run_eval(params, valid, {"test": frames[:1]}, mcfg, c, bg, str(tmp_path / str(i)),
                      5.0, 80.0, device="cpu", variant=variant)
             for i, c in enumerate(cfgs)]
    assert evals[0]["test"] == evals[1]["test"]
    ocfg = TO(start_stat=0, update_from=0, update_interval=1, dist_from=0, normal_from=0)
    state = init_train_state(AnchorField(params=params, valid=valid, voxel_size=1.0), mcfg)
    trainers = [Trainer(mcfg=mcfg, ocfg=ocfg, rcfg=c, bg=bg, variant=variant) for c in cfgs]
    assert torch.equal(trainers[0].render(params, valid, frames[0]).depth,
                       trainers[1].render(params, valid, frames[0]).depth)
    grads = [loss_and_grads(state, frames[0], bg, mcfg, c, ocfg, variant)[1:] for c in cfgs]
    for x, y in zip(tree_leaves(grads[1][0]) + [grads[1][1]],
                    tree_leaves(grads[0][0]) + [grads[0][1]]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-7)
    assert float(grads[0][1].abs().sum()) > 0
    steps = [tr_.step(state, frames[0], 1) for tr_ in trainers]
    for f in steps[0][1].loss._fields:
        assert float(getattr(steps[0][1].loss, f)) == float(getattr(steps[1][1].loss, f)), f
    assert int(steps[0][1].n_overflow) == int(steps[1][1].n_overflow)
    dense, stats = trainers[1].densify(steps[1][0], torch.Generator().manual_seed(0), 1.0)
    assert int(dense.valid.sum()) == int(valid.sum()) + int(stats.n_grown) - int(stats.n_pruned)


@pytest.mark.cuda
def test_cuda_window_kernels_match_tile_kernels_on_card():
    """K3 against K1 bit for bit on the same rows (the window's first
    `count` rows are the tile's list), K4's owned rows against K2's rows
    [0, count) bit for bit and every other row of dbuf exactly zero, and
    each against its plain version (K1's and K2's bounds on the card: the
    kernels walk in sequence where the plain versions take a chunked
    cumprod). The overflow case, so windows leave gaps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _, tcfg, buf, starts, counts, pix, _, g = _case(1)
    dev = torch.device("cuda")
    tb, ts, tc, tp, tg = [x.to(dev) for x in _t(buf, starts, counts, pix, g)]
    K = tcfg.tile_capacity
    inst = ck.window_rows(tb, ts, K).contiguous()
    before = (ck.windows_launches, ck.windows_bwd_launches)
    out = ck.composite_windows(tb, ts, tc, tp, C, tcfg)
    d1 = ck.composite_windows_bwd(tb, ts, tc, tp, out, tg, C, tcfg)
    d2 = ck.composite_windows_bwd(tb, ts, tc, tp, out, tg, C, tcfg)
    torch.cuda.synchronize()
    assert (ck.windows_launches, ck.windows_bwd_launches) == (before[0] + 1, before[1] + 2)
    assert torch.equal(d1, d2)
    assert torch.equal(out, ck.composite_tiles(inst, tc, tp, C, tcfg))
    d_k2 = ck.composite_tiles_bwd(inst, tc, tp, out, tg, C, tcfg)
    assert torch.equal(d1, ck.scatter_windows(d_k2, ts, tc, tb.shape[0]))
    _compare_out(out.cpu().numpy(), ck.composite_windows_plain(tb, ts, tc, tp, C, tcfg)
                 .cpu().numpy())
    ref = ck.composite_windows_bwd_plain(tb, ts, tc, tp, out, tg, C, tcfg)
    _compare_dbuf(d1.cpu().numpy(), ref.cpu().numpy(), starts, counts)
    with pytest.raises(TypeError, match="int32"):
        ck.composite_windows(tb, ts.long(), tc, tp, C, tcfg)
