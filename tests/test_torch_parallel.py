"""The port's data-parallel layer (`lidargs_torch/parallel/`) against the
JAX package's, in one process: the frame schedule, stacked frames, the
tile-window binning and composite, the data-parallel step of both variants,
a batch of identical frames against one step, and the densify interleave.

Small sizes, as `tests/test_parallel.py` (feat 8, k = 2, hidden 8, a
capacity of 256, an 8x256 or 32x256 range view). JAX runs its own
`make_dp_trainer` over a mesh of the conftest's virtual CPU devices; the
port runs its one-process step over the same frames, the whole batch local.
Tolerances, each with its reason:
  * the schedule, binning keys, starts, counts and overflow: equal;
  * window strips: atol 1e-5 color / T and 1e-4 depth against JAX's XLA
    scan, up to threshold flips (`assert_close_up_to_flips`, as
    `test_torch_rasterize.py`); the windows of one grid against the full
    grid's strips: equal bit for bit (tiles composite independently);
  * the data-parallel step against the mean of the port's own single-frame
    gradients: 1e-5 relative norm per leaf (sums in another order);
  * the data-parallel step against JAX's: the losses 1e-5 (beam) / 1e-4
    (surfel) relative, the gradients (10 x the first Adam moment) 1e-4 /
    1e-2 relative norm per leaf, the statistics as in `test_torch_train.py`
    (the plain composites against JAX's XLA scan), parameters at 1e-6
    above the noise floor (beam; Adam's first step is a sign step,
    ROADMAP.md section 3). The surfel bound is the packages' single-frame
    difference: `test_torch_surfel_train.py` holds one frame's gradients to
    2e-3 (measured up to 7e-4); on these four poses one frame's anchor
    gradient differs by ~5e-3, where an atan2 ulp between XLA and libm
    moves a parity rect by a pixel;
  * identical frames against one `train_step`: JAX's test's bounds (params
    atol 1e-5 / rtol 1e-4, visits exactly B x, proxy norms atol 1e-4 /
    rtol 1e-3, loss 1e-5);
  * the densify interleave: grown and pruned counts and `valid` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import ModelConfig as JM
from lidargs_tpu.config import OptConfig as JO
from lidargs_tpu.config import RasterConfig as JR
from lidargs_tpu.lidar.frames import LidarFrame as JFrame
from lidargs_tpu.lidar.frames import stack_frames as jstack
from lidargs_tpu.models import densify as jd
from lidargs_tpu.models import field as jf
from lidargs_tpu.ops import projection as jp
from lidargs_tpu.ops import rasterize as jr
from lidargs_tpu.parallel.mesh import make_mesh as jmesh
from lidargs_tpu.parallel.runtime import frame_schedule as jschedule
from lidargs_tpu.parallel.shard import make_dp_trainer as jdp
from lidargs_tpu.train import trainer as jt
from lidargs_torch.config import ModelConfig as TM
from lidargs_torch.config import OptConfig as TO
from lidargs_torch.config import RasterConfig as TR
from lidargs_torch.lidar import LidarFrame as TFrame
from lidargs_torch.lidar import index_frame, stack_frames, uniform_beam_inclinations
from lidargs_torch.models import densify as td
from lidargs_torch.ops import rasterize as tr
from lidargs_torch.parallel import Runtime, RuntimeConfig, frame_schedule, make_dp_trainer
from lidargs_torch.parallel import make_mesh
from lidargs_torch.parallel.shard import local_sums
from lidargs_torch.train import trainer as tt
from lidargs_torch.utils.params import train_state_from_jax
from lidargs_torch.utils.testing import (
    assert_close_up_to_flips, make_scene, one_torch_thread, sensor_poses, shell_anchors,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


CAP, N_ANCHORS = 256, 200
MODEL = dict(feat_dim=8, n_offsets=2, mlp_hidden=8, anchor_capacity=CAP)
RASTER = dict(max_visible=512, max_tiles_per_gaussian=16, tile_capacity=64, chunk=8)
H, W = 8, 256


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def _relnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jax_state(seed=0):
    """A JAX TrainState as numpy: shell anchors in the first 200 of 256
    rows with random offsets, heads from a JAX key, the opacity head's bias
    raised and the scales enlarged so that the gaussians cover the view."""
    mcfg = JM(**MODEL)
    p = jax.tree.map(np.array, jf.init_field_params(jax.random.key(seed), mcfg))
    for name, arr in shell_anchors(N_ANCHORS, mcfg.feat_dim, seed).items():
        p[name][:N_ANCHORS] = arr
    rng = np.random.default_rng(seed + 1)
    p["offset"][:N_ANCHORS] = rng.normal(size=(N_ANCHORS, mcfg.n_offsets, 3)) * 0.5
    p["scaling"][:N_ANCHORS] += 1.0
    p["mlp_opacity"]["l2"]["b"] += 1.0
    field = jf.AnchorField(params=jax.tree.map(jnp.asarray, p),
                           valid=jnp.asarray(np.arange(CAP) < N_ANCHORS), voxel_size=4.0)
    return jax.tree.map(np.asarray, jt.init_train_state(field, mcfg))


def _frames(n, seed=2):
    """(JAX frames, port frames): sensor poses and random GT images."""
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    rng = np.random.default_rng(seed)
    jfs, tfs = [], []
    for i, pose in enumerate(sensor_poses(n, seed)):
        gt = np.zeros((3, H, W), np.float32)
        gt[0] = rng.uniform(size=(H, W)) > 0.2
        gt[1] = rng.uniform(size=(H, W)) * gt[0]
        gt[2] = rng.uniform(5.0, 70.0, size=(H, W)) * gt[0]
        jfs.append(JFrame.from_lidar2world(pose, beams, gt, uid=i))
        tfs.append(TFrame.from_lidar2world(pose, beams, gt, uid=i, device="cpu"))
    return jfs, tfs


def _fresh(js):
    """JAX's DP step donates its state: a fresh device copy."""
    return jax.tree.map(jnp.asarray, js)


# --- the schedule and the runtime's slices ---

@pytest.mark.parametrize("seed,B,n_frames", [(0, 4, 8), (9, 4, 8), (123, 3, 7), (5, 8, 46),
                                             (1234, 2, 46), (7, 16, 5)])
def test_frame_schedule_matches_jax(seed, B, n_frames):
    for step in (0, 1, 2, 5, 11, 100):
        assert frame_schedule(seed, step, B, n_frames) == jschedule(seed, step, B, n_frames)


def test_local_indices_partition_the_batch():
    idx = frame_schedule(9, 3, 4, 8)
    parts = [Runtime(RuntimeConfig(num_processes=2, process_id=r), torch.device("cpu"), None)
             .local_indices(idx) for r in range(2)]
    assert parts[0] + parts[1] == idx
    with pytest.raises(ValueError, match="not divisible"):
        Runtime(RuntimeConfig(num_processes=3), torch.device("cpu"), None).local_indices(idx)


# --- stacked frames ---

@pytest.mark.parametrize("masked", [False, True])
def test_stack_and_index_frames_round_trip(masked):
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    rng = np.random.default_rng(0)
    frames = [TFrame.from_lidar2world(pose, beams, rng.uniform(size=(3, H, W)), uid=i,
                                      pixel_mask=(rng.uniform(size=(H, W)) > 0.5
                                                  if masked else None), device="cpu")
              for i, pose in enumerate(sensor_poses(3, 1))]
    batch = stack_frames(frames)
    assert tuple(batch.gt_image.shape) == (3, 3, H, W) and tuple(batch.uid.shape) == (3,)
    assert (batch.pixel_mask is None) is not masked
    for i, f in enumerate(frames):
        g = index_frame(batch, i)
        for name in ("w2s_rot", "w2s_trans", "center", "beams", "gt_image", "uid",
                     "pixel_mask"):
            a, b = getattr(g, name), getattr(f, name)
            assert (a is None and b is None) or torch.equal(a, b), name
        assert (g.H, g.W) == (H, W)
    with pytest.raises(ValueError, match="pixel_mask"):
        stack_frames([frames[0], TFrame(*[getattr(frames[1], n) for n in (
            "w2s_rot", "w2s_trans", "center", "beams", "gt_image", "uid")],
            pixel_mask=None if masked else torch.ones(H, W, dtype=torch.bool))])


# --- the tile window ---

def _packed(seed, cfg_kw, Hs=32):
    """Depth-ordered packed rows of a numpy scene through JAX's projection
    (so both packages bin the same floats), and the scene."""
    sc = make_scene(seed, n=200, H=Hs, W=256)
    cfg = JR(**cfg_kw)
    jsp = jax.jit(lambda *a: jp.preprocess_gaussians(*a, sc.W, cfg))(
        sc.means3d, sc.scales, sc.quats, sc.opacities, sc.feat, sc.mask,
        sc.w2s_rot, sc.w2s_trans, sc.beams)
    pk = np.asarray(jp.pack_splats(jsp))
    sel = np.argsort(np.asarray(jsp.depth), kind="stable")[:cfg.max_visible]
    return sc, pk[sel]


WINDOW_CFG = dict(max_visible=512, max_tiles_per_gaussian=16, tile_capacity=32, tile_h=4)


@pytest.mark.parametrize("instance_capacity", [0, 700], ids=["dense", "rank_search"])
@pytest.mark.parametrize("lo,n", [(0, None), (0, 6), (6, 6), (12, 6)],
                         ids=["full", "first", "middle", "overhang"])
def test_tile_window_matches_jax(instance_capacity, lo, n):
    kw = dict(WINDOW_CFG, instance_capacity=instance_capacity)
    sc, pkv = _packed(4, kw)
    C = 2
    jcfg, tcfg = JR(**kw), TR(**kw)
    gy, gx = tcfg.grid_shape(sc.beams.shape[0], sc.W)
    assert gy * gx == 16                     # three windows of 6 overhang by 2
    from lidargs_torch.ops.projection import PackedCols as PC

    rect, center = pkv[:, PC.rect(C)].astype(np.int32), pkv[:, PC.center(C)]
    valid = pkv[:, PC.validf(C)] > 0
    j = jr._bin_sorted(jnp.asarray(rect), jnp.asarray(center), jnp.asarray(valid), jcfg, gx, gy,
                       tile_lo=None if n is None else lo, n_tiles=n)
    t = tr._bin_sorted(torch.from_numpy(rect), torch.from_numpy(center),
                       torch.from_numpy(valid), tcfg, gx, gy, lo, n)
    for name, a, b in zip(("keys", "starts", "counts"), t[:3], j[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert t[3:5] == j[3:5] and int(t[5]) == int(j[5])
    jo = jr.render_packed_window(jnp.asarray(pkv), jnp.asarray(sc.beams), sc.W, jcfg, C,
                                 tile_lo=None if n is None else lo, n_tiles=n)
    to_ = tr.render_packed_window(torch.from_numpy(pkv), torch.from_numpy(sc.beams), sc.W,
                                  tcfg, C, lo, n)
    for a, b, atol, flip in ((to_[0], jo[0], 1e-5, 2e-2), (to_[1], jo[1], 1e-4, 2.0),
                             (to_[2], jo[2], 1e-5, 2e-2)):
        assert_close_up_to_flips(a.numpy(), np.asarray(b), atol, flip)
    assert int(to_[3]) == int(jo[3])


@pytest.mark.parametrize("fused", [False, True], ids=["tiles", "windows"])
def test_windows_tile_the_full_grid_bit_for_bit(fused):
    """Three windows of 6 tiles (the last overhanging the 16-tile grid by
    2) give the full grid's strips exactly, the overhang's tiles empty; the
    overflow counts add up."""
    kw = dict(WINDOW_CFG, fused_gather=fused)
    sc, pkv = _packed(4, kw)
    pkv, beams, cfg = torch.from_numpy(pkv), torch.from_numpy(sc.beams), TR(**kw)
    full = tr.render_packed_window(pkv, beams, sc.W, cfg, 2)
    parts = [tr.render_packed_window(pkv, beams, sc.W, cfg, 2, tile_lo=6 * r, n_tiles=6)
             for r in range(3)]
    for i in range(3):
        got = torch.cat([p[i] for p in parts])
        assert torch.equal(got[:16], full[i])
    assert bool((torch.cat([p[2] for p in parts])[16:] == 1.0).all())   # T stays 1
    assert sum(int(p[3]) for p in parts) == int(full[3]) > 0


# --- the data-parallel step ---

def _setup(variant):
    """(JAX state, JAX frames, port frames, model, raster, opt) of four
    distinct frames: this file's scene for the beam variant, the scene of
    `test_torch_surfel_train.py` (on which the packages' single-frame
    surfel gradients are held to 2e-3) with both regularizers on for the
    surfel variant."""
    if variant == "beam":
        jfs, tfs = _frames(4)
        return _jax_state(), jfs, tfs, MODEL, RASTER, dict(start_stat=0)
    import test_torch_surfel_train as st

    pairs = st._frames(4, seed=4)
    return (st._jax_state(), [p[0] for p in pairs], [p[1] for p in pairs], st.MODEL,
            st.RASTER, dict(start_stat=0, **st.ON))


@pytest.mark.parametrize("variant", ["beam", "surfel"])
def test_dp_step_matches_jax(variant):
    """Four distinct frames: the port's one-process step against JAX's
    `make_dp_trainer` over a 4-device data axis."""
    tol = dict(loss=1e-5, grad=1e-4) if variant == "beam" else dict(loss=1e-4, grad=1e-2)
    js0, jfs, tfs, model, raster, opt = _setup(variant)
    bg = np.zeros(2, np.float32)
    jstep = jdp(jmesh(data=4, tile=1), JM(**model), JR(**raster), JO(**opt),
                bg=jnp.asarray(bg), variant=variant)
    j1, jm = jstep(_fresh(js0), jstack(jfs))
    j1 = jax.tree.map(np.asarray, j1)
    tstep = make_dp_trainer(make_mesh(), TM(**model), TR(**raster), TO(**opt),
                            torch.from_numpy(bg), variant=variant)
    t1, tm = tstep(train_state_from_jax(js0, device="cpu"), stack_frames(tfs))
    np.testing.assert_allclose(float(tm.loss.total), float(jm.loss.total), rtol=tol["loss"])
    for f in ("n_anchors", "n_dropped", "n_overflow"):
        assert abs(int(getattr(tm, f)) - int(getattr(jm, f))) <= 2, f
    # n_visible is each rank's first frame's, maxed over the data axis: JAX's
    # 4 devices read every frame's, as 4 ranks of one frame each do; the
    # one-process step reads its first frame's (test_torch_dp_graph.py holds
    # one process to JAX's 1-device mesh)
    ranks = [local_sums(train_state_from_jax(js0, device="cpu"), stack_frames([f]),
                        torch.from_numpy(bg), TM(**model), TR(**raster), TO(**opt),
                        variant=variant)[1] for f in tfs]
    assert abs(int(torch.stack(ranks).amax(0)[0]) - int(jm.n_visible)) <= 2
    assert int(tm.n_visible) == int(ranks[0][0])
    n_live = 0
    for (path, gj), (_, gt), (_, pj), (_, pt) in zip(
            _leaves(j1.opt.mu), _leaves(t1.opt.mu), _leaves(j1.params), _leaves(t1.params)):
        if np.abs(gj).max() == 0:
            np.testing.assert_array_equal(gt, 0.0, err_msg=path)
            continue
        assert _relnorm(gt, gj) <= tol["grad"], (path, _relnorm(gt, gj))
        if variant == "beam":
            above = np.abs(gj) > 1e-3 * np.abs(gj).max()
            np.testing.assert_allclose(pt[above], pj[above], rtol=1e-6, atol=1e-6, err_msg=path)
        n_live += 1
    assert n_live >= 8
    # the step is the mean of the port's own single-frame gradients (sums in
    # another order)
    per_frame = [tt.loss_and_grads(train_state_from_jax(js0, device="cpu"), f,
                                   torch.from_numpy(bg), TM(**model), TR(**raster), TO(**opt),
                                   variant)[1] for f in tfs]
    for (path, gt), *gs in zip(_leaves(t1.opt.mu), *(_leaves(g) for g in per_frame)):
        mean = sum(g for _, g in gs) / len(gs)
        assert _relnorm(gt / 0.1, mean) <= 1e-5, path
    np.testing.assert_array_equal(t1.anchor_demon.numpy(), j1.anchor_demon)
    assert float(t1.anchor_demon.max()) == 4.0
    np.testing.assert_allclose(t1.opacity_accum.numpy(), j1.opacity_accum, rtol=1e-5, atol=1e-6)
    assert (t1.offset_denom.numpy() != j1.offset_denom).sum() <= 8
    assert _relnorm(t1.offset_grad_accum.numpy(), j1.offset_grad_accum) <= tol["grad"]
    assert float(t1.offset_grad_accum.max()) > 0


def test_identical_frames_equal_one_train_step():
    """Eight identical frames under the DP step give one `train_step`'s
    parameters, the visits eight times (JAX's
    `test_dp_step_matches_single_device_step`, in the port alone)."""
    s0 = train_state_from_jax(_jax_state(), device="cpu")
    tf = _frames(1)[1][0]
    ocfg, bg = TO(start_stat=0), torch.zeros(2)
    s_single, m_single = tt.train_step(s0, tf, bg, TM(**MODEL), TR(**RASTER), ocfg)
    s_dp, m_dp = make_dp_trainer(make_mesh(), TM(**MODEL), TR(**RASTER), ocfg, bg)(
        s0, stack_frames([tf] * 8))
    for k in ("anchor", "offset", "feat", "scaling"):
        np.testing.assert_allclose(s_dp.params[k].numpy(), s_single.params[k].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(s_dp.anchor_demon.numpy(), 8 * s_single.anchor_demon.numpy())
    np.testing.assert_allclose(s_dp.offset_grad_accum.numpy(),
                               8 * s_single.offset_grad_accum.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(float(m_dp.loss.total), float(m_single.loss.total), rtol=1e-5)


def _draws(key, mcfg):
    keys = jax.random.split(key, mcfg.update_depth)
    return np.stack([np.asarray(jax.random.uniform(keys[i], (mcfg.anchor_capacity
                                                             * mcfg.n_offsets,)))
                     for i in range(mcfg.update_depth)])


def test_dp_densify_interleave_matches_jax():
    """JAX's `test_dp_densify_interleave_matches_single_device` schedule:
    six steps of 8 frames (frame (t + i) % 4), a densify after every second
    with the draws of key t; the port in one process, JAX over 8 devices."""
    ocfg = dict(start_stat=0, update_from=0, update_interval=2, densify_grad_threshold=1e-7)
    jfs, tfs = _frames(4)
    js0 = _jax_state()
    mcfg = JM(**MODEL)
    jstep = jdp(jmesh(data=8, tile=1), mcfg, JR(**RASTER), JO(**ocfg), bg=jnp.zeros((2,)))
    tstep = make_dp_trainer(make_mesh(), TM(**MODEL), TR(**RASTER), TO(**ocfg), torch.zeros(2))
    js, ts = _fresh(js0), train_state_from_jax(js0, device="cpu")
    counts = []
    for t in range(6):
        order = [(t + i) % 4 for i in range(8)]
        js, _ = jstep(js, jstack([jfs[i] for i in order]))
        ts, _ = tstep(ts, stack_frames([tfs[i] for i in order]))
        if (t + 1) % 2 == 0:
            js, jds = jd.densify_step(js, jax.random.key(t), mcfg, JO(**ocfg), 4.0,
                                      check_interval=2)
            ts, tds = td.densify_step(ts, TM(**MODEL), TO(**ocfg), 4.0, check_interval=2,
                                      draws=torch.from_numpy(_draws(jax.random.key(t), mcfg)))
            counts.append(((int(tds.n_grown), int(tds.n_pruned)),
                           (int(jds.n_grown), int(jds.n_pruned))))
            np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert [c[0] for c in counts] == [c[1] for c in counts]
    assert sum(sum(c[0]) for c in counts) > 0, "the schedule never densified"
