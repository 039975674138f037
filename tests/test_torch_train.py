"""The port's training step against the JAX package on the same inputs: the
losses, the schedules, Adam, the permutation-gather VJP, one `train_step`
from the same state, three steps of `Trainer`, `densify_step` from the same
state and draws, and the cadence helpers.

Small sizes, as the JAX package's own training tests (feat 16, k = 4,
hidden 16, 400 of 512 anchors, a 16x256 range view), numpy inputs from
seeds. Tolerances, each with its reason:
  * losses and SSIM: 1e-5 relative (f32 sums in another order);
  * gradients (read from the first Adam moment, mu = 0.1 g after one step):
    relative norm per parameter leaf <= 1e-4. On the CPU, JAX takes its
    gradient through the XLA composite scan (which keeps /|u|^2) and the
    port through its plain K2 (which drops it): they agree after the
    projection VJP's normalization, measured ~1e-6;
  * parameters after one step: Adam's first step moves each entry by lr
    times the sign of its gradient (adam_eps = 1e-15), so an entry whose
    gradient is at the noise level may move either way. Entries are held
    to 1e-6 only where |g| > 1e-3 max|g| of their leaf (the noise floor),
    and every entry to within 2 lr of the JAX package's;
  * statistics: the visible counters agree to 2 entries (a projection ulp
    can flip a gaussian's visibility), the accumulated proxy gradient norms
    to 1e-4 relative norm;
  * densify_step from the same state and the same uniform draws: equal
    exactly.
These run on the CPU. On CUDA the backward of the `[T, K, F]` instance
gather is an accumulating index_put whose summation order PyTorch does not
promise, so two identical steps on the card may differ in the last bits;
`chip_smoke.py` reports that difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import LrSchedule as JLr
from lidargs_tpu.config import ModelConfig as JM
from lidargs_tpu.config import OptConfig as JO
from lidargs_tpu.config import RasterConfig as JR
from lidargs_tpu.lidar.frames import LidarFrame as JFrame
from lidargs_tpu.models import densify as jd
from lidargs_tpu.models import field as jf
from lidargs_tpu.ops import rasterize as jras
from lidargs_tpu.train import losses as jl
from lidargs_tpu.train import optim as jo
from lidargs_tpu.train import schedule as js
from lidargs_tpu.train import trainer as jt
from lidargs_torch.config import LrSchedule as TLr
from lidargs_torch.config import ModelConfig as TM
from lidargs_torch.config import OptConfig as TO
from lidargs_torch.config import RasterConfig as TR
from lidargs_torch.lidar import LidarFrame as TFrame
from lidargs_torch.lidar import uniform_beam_inclinations
from lidargs_torch.models import densify as td
from lidargs_torch.ops import rasterize as tras
from lidargs_torch.train import losses as tl
from lidargs_torch.train import optim as to
from lidargs_torch.train import schedule as ts
from lidargs_torch.train import trainer as tt
from lidargs_torch.utils.params import train_state_from_jax
from lidargs_torch.utils.testing import one_torch_thread, sensor_poses, shell_anchors


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


CAP, N_ANCHORS = 512, 400
MODEL = dict(feat_dim=16, n_offsets=4, mlp_hidden=16, anchor_capacity=CAP)
RASTER = dict(tile_h=4, tile_capacity=128, max_tiles_per_gaussian=8, max_visible=2048)
OPT = dict(start_stat=0, update_from=0)
H, W = 16, 256


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.array(tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_state(seed=0):
    """A JAX TrainState: shell anchors in the first rows of 512, random
    offsets, heads from a JAX key. The opacity head's bias is raised and the
    anchors' scales enlarged (e^1), so that ~470 of the 1600 decoded
    gaussians pass the opacity gate and cover ~6% of the view."""
    mcfg = JM(**MODEL)
    p = _np(jf.init_field_params(jax.random.key(seed), mcfg))
    for name, arr in shell_anchors(N_ANCHORS, mcfg.feat_dim, seed).items():
        p[name][:N_ANCHORS] = arr
    rng = np.random.default_rng(seed + 1)
    p["offset"][:N_ANCHORS] = rng.normal(size=(N_ANCHORS, mcfg.n_offsets, 3)) * 0.5
    p["scaling"][:N_ANCHORS] += 1.0
    p["mlp_opacity"]["l2"]["b"] += 1.0
    valid = np.arange(CAP) < N_ANCHORS
    field = jf.AnchorField(params=jax.tree.map(jnp.asarray, p), valid=jnp.asarray(valid),
                           voxel_size=1.0)
    return jt.init_train_state(field, mcfg)


def _frames(n=3, seed=2):
    """(JAX, port) frame pairs: sensor poses and a random GT image each."""
    beams = uniform_beam_inclinations(2.4, 20.9, H)
    rng = np.random.default_rng(seed)
    out = []
    for pose in sensor_poses(n, seed):
        gt = np.zeros((3, H, W), np.float32)
        gt[0] = rng.uniform(size=(H, W)) > 0.2
        gt[1] = rng.uniform(size=(H, W)) * gt[0]
        gt[2] = rng.uniform(5.0, 70.0, size=(H, W)) * gt[0]
        out.append((JFrame.from_lidar2world(pose, beams, gt, uid=0),
                    TFrame.from_lidar2world(pose, beams, gt, uid=0, device="cpu")))
    return out


@pytest.fixture(scope="module")
def three_steps():
    """Three steps of each package's Trainer from the same state."""
    bg = np.zeros(2, np.float32)
    jtr = jt.Trainer(mcfg=JM(**MODEL), ocfg=JO(**OPT), rcfg=JR(**RASTER), bg=jnp.asarray(bg))
    ttr = tt.Trainer(mcfg=TM(**MODEL), ocfg=TO(**OPT), rcfg=TR(**RASTER), bg=torch.from_numpy(bg))
    js0 = jax.tree.map(np.asarray, _jax_state())
    ts0 = train_state_from_jax(js0, device="cpu")
    jstates, tstates, jm, tm = [js0], [ts0], [], []
    for it, (jfr, tfr) in enumerate(_frames(), start=1):
        # the JAX step donates its input state: hand it fresh arrays
        s, m = jtr.step(jax.tree.map(jnp.asarray, jstates[-1]), jfr, it)
        jstates.append(jax.tree.map(np.asarray, s))
        jm.append(m)
        s, m = ttr.step(tstates[-1], tfr, it)
        tstates.append(s)
        tm.append(m)
    return jstates, tstates, jm, tm


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _relnorm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_train_state_from_jax_carries_everything():
    js0 = jax.tree.map(np.asarray, _jax_state())
    s = train_state_from_jax(js0, device="cpu")
    for (pa, a), (pb, b) in zip(_leaves(s.params), _leaves(js0.params)):
        assert pa == pb
        np.testing.assert_array_equal(a.numpy(), b)
    for name in ("valid", "step", "opacity_accum", "anchor_demon", "offset_grad_accum",
                 "offset_denom"):
        np.testing.assert_array_equal(getattr(s, name).numpy(), getattr(js0, name))
    assert int(s.opt.count) == 0 and s.step.dtype == torch.int32


def test_one_train_step_matches_jax(three_steps):
    jstates, tstates, jm, tm = three_steps
    for f in jm[0].loss._fields:
        np.testing.assert_allclose(float(getattr(tm[0].loss, f)), float(getattr(jm[0].loss, f)),
                                   rtol=1e-5, atol=1e-9, err_msg=f)
    for f in ("n_anchors", "n_visible", "n_dropped", "n_overflow"):
        a, b = int(getattr(tm[0], f)), int(getattr(jm[0], f))
        assert abs(a - b) <= 2, (f, a, b)
    j1, t1 = jstates[1], tstates[1]
    lr_max = 0.008                                   # the largest rate in OptConfig's defaults
    n_compared = 0
    for (path, gj), (_, gt_), (_, pj), (_, pt), (_, p0) in zip(
            _leaves(j1.opt.mu), _leaves(t1.opt.mu), _leaves(j1.params), _leaves(t1.params),
            _leaves(jstates[0].params)):
        gj, gt_, pt = np.asarray(gj), gt_.numpy(), pt.numpy()
        if np.abs(gj).max() == 0:                    # frozen groups, unused rows
            np.testing.assert_array_equal(gt_, 0.0, err_msg=path)
            np.testing.assert_array_equal(pt, np.asarray(p0), err_msg=path)
            continue
        assert _relnorm(gt_, gj) <= 1e-4, (path, _relnorm(gt_, gj))
        above = np.abs(gj) > 1e-3 * np.abs(gj).max()
        np.testing.assert_allclose(pt[above], pj[above], rtol=1e-6, atol=1e-6, err_msg=path)
        assert np.abs(pt - pj).max() <= 2 * lr_max + 1e-6, path
        n_compared += int(above.sum())
    assert n_compared > 1000
    assert _relnorm(t1.opt.nu["feat"].numpy(), j1.opt.nu["feat"]) <= 1e-4
    assert int(t1.opt.count) == 1 and int(t1.step) == 1
    # densification statistics
    np.testing.assert_allclose(t1.opacity_accum.numpy(), j1.opacity_accum, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t1.anchor_demon.numpy(), j1.anchor_demon)
    assert (t1.offset_denom.numpy() != j1.offset_denom).sum() <= 2
    assert _relnorm(t1.offset_grad_accum.numpy(), j1.offset_grad_accum) <= 1e-4
    assert float(t1.offset_grad_accum.max()) > 0 and float(t1.anchor_demon.max()) == 1.0


def test_three_steps_follow_jax_loss(three_steps):
    _, tstates, jm, tm = three_steps
    lt = [float(m.loss.total) for m in tm]
    lj = [float(m.loss.total) for m in jm]
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert float(tstates[3].anchor_demon.max()) == 3.0
    for _, x in _leaves(tstates[3].params):
        assert bool(torch.isfinite(x).all())


def test_loss_and_grads_zero_for_unused_heads():
    """A head the configuration does not reach gets zero gradient (not
    None), so its moments decay as in the JAX package."""
    js0 = jax.tree.map(np.asarray, _jax_state())
    s = train_state_from_jax(js0, device="cpu")
    s = s._replace(params={**s.params, "mlp_featbank": {
        "l1": {"w": torch.ones(4, 8), "b": torch.ones(8)},
        "l2": {"w": torch.ones(8, 3), "b": torch.ones(3)}}})
    tfr = _frames(1)[0][1]
    _, grads, proxy_grad = tt.loss_and_grads(s, tfr, torch.zeros(2), TM(**MODEL), TR(**RASTER),
                                             TO(**OPT))
    assert bool((grads["mlp_featbank"]["l1"]["w"] == 0).all())
    assert tuple(proxy_grad.shape) == (CAP, MODEL["n_offsets"], 3)
    assert float(grads["feat"].abs().max()) > 0


def test_projection_dispatch_gives_the_same_gradients():
    """The hand VJP, activation checkpointing of the plain projection
    (`remat_projection`) and plain autograd (`projection_hand_vjp=False`)
    give the same gradients (1e-5 relative norm: sums in another order)."""
    s = train_state_from_jax(jax.tree.map(np.asarray, _jax_state()), device="cpu")
    tfr = _frames(1)[0][1]
    run = lambda **kw: tt.loss_and_grads(s, tfr, torch.zeros(2), TM(**MODEL),
                                         TR(**RASTER, **kw), TO(**OPT))[1:]
    g_hv, p_hv = run()
    for kw in (dict(remat_projection=True), dict(projection_hand_vjp=False)):
        g, pg = run(**kw)
        for (path, a), (_, b) in zip(_leaves(g), _leaves(g_hv)):
            assert _relnorm(a.numpy(), b.numpy()) <= 1e-5, (kw, path)
        assert _relnorm(pg.numpy(), p_hv.numpy()) <= 1e-5, kw


def test_overflow_regularizer_matches_jax():
    """overflow_lambda > 0 under per-tile truncation: the pressure term
    enters the total as in the JAX package (the overflow counts may differ
    by a gaussian or two, hence 1e-4)."""
    js0 = _jax_state()
    jfr, tfr = _frames(1)[0]
    raster = dict(RASTER, tile_capacity=8)
    opt = dict(OPT, overflow_lambda=0.5)
    proxy = np.zeros((CAP, MODEL["n_offsets"], 3), np.float32)
    jtot, (jout, _, _, jlt) = jax.jit(lambda st: jt.frame_loss(
        st.params, proxy, st.valid, st.step, jfr, jnp.zeros(2), JM(**MODEL), JR(**raster),
        JO(**opt)))(js0)
    s = train_state_from_jax(jax.tree.map(np.asarray, js0), device="cpu")
    ttot, (tout, _, _, tlt) = tt.frame_loss(s.params, torch.from_numpy(proxy), s.valid, s.step,
                                            tfr, torch.zeros(2), TM(**MODEL), TR(**raster),
                                            TO(**opt))
    assert int(jout.n_overflow) > 0
    assert abs(int(tout.n_overflow) - int(jout.n_overflow)) <= 2
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-4)
    assert float(ttot) > float(tlt.depth + tlt.intensity + tlt.raydrop + tlt.scale_reg + tlt.grad_x)


def test_anchor_cap_refuses_the_proxy():
    s = train_state_from_jax(jax.tree.map(np.asarray, _jax_state()), device="cpu")
    tfr = _frames(1)[0][1]
    with pytest.raises(ValueError, match="visible_anchor_cap"):
        tt.loss_and_grads(s, tfr, torch.zeros(2), TM(**MODEL),
                          TR(**RASTER, visible_anchor_cap=256), TO(**OPT))


@pytest.mark.parametrize("lo,hi,rtol", [
    (0.0, 1.0, 1e-5),
    # near saturation conv(x^2) - mu^2 cancels: f32 sums in another order
    # move SSIM by ~5e-5 relative
    (0.9, 1.0, 2e-4),
])
def test_ssim_matches_jax(lo, hi, rtol):
    rng = np.random.default_rng(3)
    a = rng.uniform(lo, hi, (1, 24, 40)).astype(np.float32)
    b = rng.uniform(lo, hi, (1, 24, 40)).astype(np.float32)
    np.testing.assert_allclose(float(tl.ssim(_t(a), _t(b))), float(jl.ssim(a, b)), rtol=rtol)
    x = _t(a).requires_grad_(True)
    (1.0 - tl.ssim(x, _t(b))).backward()
    gj = jax.grad(lambda z: 1.0 - jl.ssim(z, b))(a)
    assert bool(torch.isfinite(x.grad).all())
    # the gradient shares the cancellation: a few small entries move by a
    # few percent, the whole by ~1e-5 of its norm
    assert _relnorm(x.grad.numpy(), gj) <= 1e-3


@pytest.mark.parametrize("masked", [False, True])
def test_lidar_losses_match_jax(masked):
    rng = np.random.default_rng(4)
    color = rng.uniform(size=(2, H, W)).astype(np.float32)
    depth = rng.uniform(5, 60, size=(H, W)).astype(np.float32)
    gt = np.stack([rng.uniform(size=(H, W)) > 0.3, rng.uniform(size=(H, W)),
                   rng.uniform(5, 60, size=(H, W))]).astype(np.float32)
    gt[2, :, 1::2] = gt[2, :, 0::2]          # equal neighbours: the azimuth term is live
    scaling = rng.uniform(0.01, 0.3, size=(50, 4, 3)).astype(np.float32)
    smask = rng.uniform(size=(50, 4)) > 0.5
    pm = rng.uniform(size=(H, W)) > 0.2 if masked else None
    j = jl.lidar_losses(color, depth, gt, scaling, smask, pixel_mask=pm)
    t = tl.lidar_losses(_t(color), _t(depth), _t(gt), _t(scaling), _t(smask),
                        pixel_mask=None if pm is None else _t(pm))
    for f in j._fields:
        np.testing.assert_allclose(float(getattr(t, f)), float(getattr(j, f)), rtol=1e-5,
                                   atol=1e-9, err_msg=f)
    assert float(t.grad_x) > 0
    np.testing.assert_allclose(float(tl.psnr(_t(color), _t(gt[:2]))),
                               float(jl.psnr(color, gt[:2])), rtol=1e-5)


@pytest.mark.parametrize("sched", [
    dict(init=0.01, final=1e-4, max_steps=100),
    dict(init=0.005, final=1e-5, delay_steps=50, delay_mult=0.01, max_steps=1000),
    dict(init=0.0, final=0.0),
])
def test_expon_lr_matches_jax(sched):
    fj, ft = js.expon_lr(JLr(**sched)), ts.expon_lr(TLr(**sched))
    for step in (0, 1, 25, 50, 99, 100, 500, 1000, 2000, -1):
        np.testing.assert_allclose(float(ft(step)), float(fj(step)), rtol=1e-6, atol=0,
                                   err_msg=str(step))
        np.testing.assert_allclose(float(ft(torch.tensor(step, dtype=torch.int32))),
                                   float(fj(step)), rtol=1e-6, atol=0)
    assert float(ts.const_lr(0.007)(3)) == np.float32(0.007)


def test_adam_update_matches_jax():
    """Identical params, grads, moments and count through both Adams, for
    groups with scheduled, constant and zero (frozen) rates."""
    rng = np.random.default_rng(5)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    params = {"anchor": r(8, 3), "offset": r(8, 4, 3), "feat": r(8, 5), "rotation": r(8, 4),
              "mlp_opacity": {"l1": {"w": r(6, 4), "b": r(4)}, "l2": {"w": r(4, 2), "b": r(2)}}}
    grads = jax.tree.map(lambda x: r(*x.shape) * 1e-3, params)
    mu = jax.tree.map(lambda x: r(*x.shape) * 1e-3, params)
    nu = jax.tree.map(lambda x: np.abs(r(*x.shape)) * 1e-6, params)
    ocfg_j, ocfg_t = JO(), TO()
    pj, sj = jo.adam_update(params, grads, jo.AdamState(mu, nu, jnp.int32(4)),
                            jo.lr_schedules(ocfg_j), jnp.int32(123), ocfg_j)
    tree = lambda x: jax.tree.map(_t, x)
    pt, st = to.adam_update(tree(params), tree(grads),
                            to.AdamState(tree(mu), tree(nu), torch.tensor(4, dtype=torch.int32)),
                            to.lr_schedules(ocfg_t), torch.tensor(123), ocfg_t)
    for got, want in ((pt, pj), (st.mu, sj.mu), (st.nu, sj.nu)):
        for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9,
                                       err_msg=path)
    assert int(st.count) == 5
    np.testing.assert_array_equal(pt["rotation"].numpy(), params["rotation"])   # frozen
    assert not np.array_equal(st.mu["rotation"].numpy(), mu["rotation"])       # moments move


def test_permutation_rows_backward_matches_jax():
    rng = np.random.default_rng(6)
    P, V = 40, 29
    pk = rng.normal(size=(P, 6)).astype(np.float32)
    sel = rng.permutation(P).astype(np.int32)
    d = rng.normal(size=(V, 6)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jras.permutation_rows(x, sel, V), pk)
    x = _t(pk).requires_grad_(True)
    out = tras.permutation_rows(x, torch.from_numpy(sel).long(), V)
    np.testing.assert_array_equal(out.detach().numpy(), pk[sel[:V]])
    out.backward(_t(d))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(vjp(d)[0]))
    assert (x.grad.numpy()[sel[V:]] == 0).all()


# --- densify_step from the same state and the same draws ---

DMODEL = dict(feat_dim=8, n_offsets=2, mlp_hidden=8, anchor_capacity=512,
              grow_src_cap=1024, grow_cap_per_level=64)
DOPT = dict(update_interval=100, success_threshold=0.1, densify_grad_threshold=5e-4,
            min_opacity=0.005)
VOXEL = 1.0


def _densify_state(seed=0):
    """A JAX TrainState with statistics that grow, dedup, drop on capacity
    and prune: 300 live anchors scattered over 512 rows."""
    mcfg = JM(**DMODEL)
    C, k = mcfg.anchor_capacity, mcfg.n_offsets
    rng = np.random.default_rng(seed)
    p = _np(jf.init_field_params(jax.random.key(seed), mcfg))
    valid = np.zeros(C, bool)
    valid[rng.choice(C, 300, replace=False)] = True
    p["anchor"][valid] = np.round(rng.uniform(-20, 20, (300, 3)))         # on the grid
    p["offset"][valid] = rng.uniform(-3, 3, (300, k, 3))
    p["scaling"][valid] = np.log(rng.uniform(0.5, 2.0, (300, 6)))
    p["feat"][valid] = rng.normal(size=(300, mcfg.feat_dim))
    st = jt.init_train_state(jf.AnchorField(jax.tree.map(jnp.asarray, p), jnp.asarray(valid),
                                            VOXEL), mcfg)
    rf = lambda *s: jnp.asarray(rng.uniform(size=s).astype(np.float32))
    st = st._replace(
        opt=st.opt._replace(mu=jax.tree.map(lambda x: rf(*x.shape), st.opt.mu),
                            nu=jax.tree.map(lambda x: rf(*x.shape), st.opt.nu)),
        offset_denom=jnp.asarray(np.where(np.repeat(valid, k), rng.integers(0, 40, C * k), 0)
                                 .astype(np.float32)),
        anchor_demon=jnp.asarray(np.where(valid, rng.integers(0, 40, C), 0).astype(np.float32)),
    )
    st = st._replace(
        offset_grad_accum=st.offset_denom * rf(C * k) * 3e-3,
        opacity_accum=st.anchor_demon * rf(C) * 0.01,
    )
    return jax.tree.map(np.asarray, st), mcfg


def test_densify_step_matches_jax_exactly():
    js0, mcfg = _densify_state()
    C, k = mcfg.anchor_capacity, mcfg.n_offsets
    key = jax.random.key(3)
    keys = jax.random.split(key, mcfg.update_depth)
    draws = np.stack([np.asarray(jax.random.uniform(keys[i], (C * k,)))
                      for i in range(mcfg.update_depth)])
    jnew, jstats = jd.densify_step(jax.tree.map(jnp.asarray, js0), key, mcfg, JO(**DOPT),
                                   VOXEL, check_interval=100)
    tnew, tstats = td.densify_step(train_state_from_jax(js0, device="cpu"), TM(**DMODEL),
                                   TO(**DOPT), VOXEL, check_interval=100,
                                   draws=torch.from_numpy(draws))
    for f in jstats._fields:
        assert int(getattr(tstats, f)) == int(getattr(jstats, f)), f
    assert int(jstats.n_grown) > 0 and int(jstats.n_pruned) > 0
    assert int(jstats.n_capacity_dropped) > 0
    assert int(tnew.valid.sum()) == int(js0.valid.sum()) + int(tstats.n_grown) - int(tstats.n_pruned)
    for name in ("valid", "opacity_accum", "anchor_demon", "offset_grad_accum", "offset_denom"):
        np.testing.assert_array_equal(getattr(tnew, name).numpy(), np.asarray(getattr(jnew, name)),
                                      err_msg=name)
    for tree_t, tree_j in ((tnew.params, jnew.params), (tnew.opt.mu, jnew.opt.mu),
                           (tnew.opt.nu, jnew.opt.nu)):
        for (path, a), (_, b) in zip(_leaves(tree_t), _leaves(tree_j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=path)


def test_densify_from_a_generator_grows_and_needs_draws():
    js0, mcfg = _densify_state(1)
    s = train_state_from_jax(js0, device="cpu")
    tr = tt.Trainer(mcfg=TM(**DMODEL), ocfg=TO(**DOPT), rcfg=TR(), bg=torch.zeros(2))
    a, sa = tr.densify(s, torch.Generator().manual_seed(0), VOXEL)
    b, _ = tr.densify(s, torch.Generator().manual_seed(0), VOXEL)
    assert int(sa.n_grown) > 0
    assert torch.equal(a.valid, b.valid) and torch.equal(a.params["anchor"], b.params["anchor"])
    with pytest.raises(ValueError, match="generator"):
        td.densify_step(s, TM(**DMODEL), TO(**DOPT), VOXEL)


def test_clamp_cov_scales_and_cadence_match_jax():
    js0, mcfg = _densify_state(2)
    js0 = js0._replace(params={**js0.params, "scaling": js0.params["scaling"] + 0.5})
    jc = jt._clamp_cov_scales(jax.tree.map(jnp.asarray, js0))
    tc = tt._clamp_cov_scales(train_state_from_jax(js0, device="cpu"))
    np.testing.assert_array_equal(tc.params["scaling"].numpy(), np.asarray(jc.params["scaling"]))
    assert float(tc.params["scaling"][:, 3:].max()) == np.float32(0.05)
    np.testing.assert_array_equal(tc.opt.mu["scaling"].numpy(), js0.opt.mu["scaling"])

    ocfg = dict(start_stat=5, update_from=20, update_interval=10, update_until=60)
    jtr = jt.Trainer(mcfg=JM(**DMODEL), ocfg=JO(**ocfg), rcfg=JR(), bg=jnp.zeros(2))
    ttr = tt.Trainer(mcfg=TM(**DMODEL), ocfg=TO(**ocfg), rcfg=TR(), bg=torch.zeros(2))
    for it in range(0, 130):
        for n in (10, 2_000_000):
            assert ttr.should_densify(n, it) == jtr.should_densify(n, it), (n, it)
        assert ttr.should_maintain(it) == jtr.should_maintain(it), it
    assert any(ttr.should_densify(10, it) for it in range(130))
    assert any(ttr.should_maintain(it) for it in range(130))
    with pytest.raises(ValueError, match="variant"):
        tt.frame_loss(None, None, None, None, None, None, TM(), TR(), TO(), variant="disk")
