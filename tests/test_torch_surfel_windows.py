"""The fused-window gather of the surfel (2DGS) variant: the plain versions
of kernels K7 and K8 against the JAX package's fused Pallas bodies, and the
port's fused surfel render against its own materialized one. The window
binning and `mask_unwritten_rows` are shared with the beam variant and held
to JAX's in `tests/test_torch_windows.py`.

On the CPU, `pallas_surfel._fused_fwd_call` and `_fused_bwd_call` run the
TPU kernel bodies `_fwd_kernel_fused` and `_bwd_kernel_fused` in interpret
mode, on small buffers that the JAX render path builds (T <= 16 tiles,
K <= 64). Tolerances, each with its reason:
  * K7's plain version against the Pallas body: K5's (`tests/`
    `test_torch_surfel_kernel.py`: atol 1e-5 on the features, T and normal,
    1e-4 m on the depth and median, 1e-5 on the distortion and M1/M2, on all
    but 1% of the elements, with a max of 2e-2, 2 m on depths);
  * K8's plain version against the Pallas body and `mask_unwritten_rows`:
    K6's (each of the 16 + C gradient columns scaled by its largest
    magnitude, over the rows either side touches: a mean within 1e-6, at
    most 4 elements beyond 2e-5, none beyond 1e-3); rows in no tile's owned
    range exactly zero in both. Each side differentiates at its own
    forward's output: the median's cotangent goes to the row whose
    recomputed depth equals the saved median bit for bit, and XLA and
    PyTorch round a pair's depth differently;
  * the port's fused surfel render against its materialized one on the CPU:
    every channel bit for bit, `n_overflow` equal, and the gradients to the
    packed surfels within rtol 1e-5, atol 1e-7 (the JAX package's bound for
    the beam pair, `tests/test_pallas_composite.py`).

PyTorch runs on one thread in this file, as in `tests/test_torch_windows.py`
(see its docstring).

The `cuda` case needs a card and nvcc, and skips here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidargs_tpu.config import RasterConfig as JCfg
from lidargs_tpu.ops import rasterize as jr
from lidargs_tpu.ops import surfel as js
from lidargs_tpu.ops.pallas_composite import mask_unwritten_rows as j_mask
from lidargs_tpu.ops.pallas_surfel import _fused_bwd_call, _fused_fwd_call
from lidargs_torch.config import RasterConfig as TCfg
from lidargs_torch.ops import composite_kernel as ck
from lidargs_torch.ops import surfel as ts
from lidargs_torch.ops import surfel_kernel as sk
from lidargs_torch.utils.stage_split import counting
from lidargs_torch.utils.testing import make_scene, one_torch_thread
from test_torch_surfel import _inputs
from test_torch_surfel_kernel import _compare_dinst, _compare_out, _cotangent
from test_torch_windows import _owned, _t

C = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


CASES = [
    dict(seed=0, n=160, H=8, W=256, tile_capacity=64),
    # tiny K and a starved instance budget: tiles overflow, windows leave gaps
    dict(seed=1, n=200, H=8, W=256, tile_capacity=16, max_tiles_per_gaussian=16,
         instance_capacity=1024),
    # an opaque pile-up: transmittance saturates and the early exit fires
    dict(seed=2, n=300, H=8, W=128, tile_capacity=64, scale=(2.0, 4.0), opaque=True),
]


def _surfel_windows(seed, n, H, W, scale=(0.3, 1.2), opaque=False, **kw):
    """(JAX config, port config, buf, starts, counts, pix) as the JAX fused
    surfel render path builds them (numpy)."""
    kw = {"max_visible": 512, "max_tiles_per_gaussian": 64, "chunk": 8, "fused_gather": True,
          **kw}
    jcfg = JCfg(pallas_chunk=8, backend="pallas", **kw)
    sc = make_scene(seed, n=n, H=H, W=W)
    rng = np.random.default_rng(seed + 50)
    scales2 = rng.uniform(*scale, (n, 2)).astype(np.float32)
    opac = rng.uniform(0.9, 1.0, n).astype(np.float32) if opaque else sc.opacities
    beams = jnp.asarray(sc.beams)

    @jax.jit
    def build(*a):
        pk = js.preprocess_surfels(*a, beams, W, jcfg)
        S = js.SurfelCols
        _, sel = jax.lax.sort((pk[:, S.DEPTH], jnp.arange(n, dtype=jnp.int32)), num_keys=1,
                              is_stable=True)
        pkv = jr.permutation_rows(pk, sel, min(jcfg.max_visible, n))
        gy, gx = jcfg.grid_shape(H, W)
        gid, starts, counts, _ = jr.bin_instances_windows(
            pkv[:, S.rect(C)].astype(jnp.int32), pkv[:, S.center(C)],
            pkv[:, S.validf(C)] > 0.0, jcfg, gx, gy)
        buf = jnp.pad(jnp.take(pkv, gid, axis=0, mode="clip"),
                      ((0, jcfg.tile_capacity), (0, 0)))
        px, py, dirs = jr._tile_pixels(H, W, jcfg, gx, gy, beams)
        return buf, starts, counts, jr._pix_blocks(px, py, dirs)

    out = build(sc.means3d, scales2, sc.quats, opac, sc.feat, sc.mask, sc.w2s_rot, sc.w2s_trans)
    return (jcfg, TCfg(**kw)) + tuple(np.array(x) for x in out)


@functools.lru_cache(maxsize=None)
def _case(i):
    """CASES[i]'s inputs and JAX's fused forward on them (the Pallas body in
    interpret mode); built once per process."""
    case = dict(CASES[i])
    seed, n, H, W = (case.pop(k) for k in ("seed", "n", "H", "W"))
    jcfg, tcfg, buf, starts, counts, pix = _surfel_windows(seed, n, H, W, **case)
    res = np.asarray(jax.jit(lambda *a: _fused_fwd_call(*a, C, jcfg))(buf, starts, counts, pix))
    return jcfg, tcfg, buf, starts, counts, pix, res


def _compare_dbuf(got, want, starts, counts, far_count=4):
    """K6's bound over the touched rows; rows no tile owns zero in both."""
    own = _owned(starts, counts, got.shape[0])
    np.testing.assert_array_equal(got[~own], 0.0)
    np.testing.assert_array_equal(want[~own], 0.0)
    _compare_dinst(got[None], want[None], far_count)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_k7_matches_pallas_fused_body(i):
    _, tcfg, buf, starts, counts, pix, res = _case(i)
    out = sk.surfel_composite_windows_plain(*_t(buf, starts, counts, pix), C, tcfg).numpy()
    assert out.shape == res.shape == (pix.shape[0], sk.OUT_ROWS, pix.shape[2])
    _compare_out(out, res)
    assert res[:, C + 1].min() < 0.5 and (res[:, C + 5] > 0).any()
    if CASES[i].get("opaque"):
        assert (res[:, C + 1] < 1e-2).mean() > 0.05            # the pile-up saturates


@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_k8_matches_pallas_fused_body_and_mask(i):
    jcfg, tcfg, buf, starts, counts, pix, res = _case(i)
    g = _cotangent(res.shape, 7 + i)
    want = np.asarray(jax.jit(lambda *a: j_mask(_fused_bwd_call(*a, C, jcfg), a[1],
                                                jcfg.tile_capacity))(
        buf, starts, counts, pix, res, g))
    tb, tst, tc, tp = _t(buf, starts, counts, pix)
    res_t = sk.surfel_composite_windows_plain(tb, tst, tc, tp, C, tcfg)
    got = sk.surfel_composite_windows_bwd_plain(tb, tst, tc, tp, res_t, torch.from_numpy(g), C,
                                                tcfg).numpy()
    _compare_dbuf(got, want, starts, counts)
    assert (np.abs(want).max(-1) > 0).sum() > 100                # many rows carry gradient
    K = tcfg.tile_capacity
    np.testing.assert_array_equal(ck.mask_unwritten_rows(torch.from_numpy(got), tst, K).numpy(),
                                  got)


def test_window_autograd_function_on_cpu():
    """`SurfelCompositeWindows` on CPU tensors: forward and backward are the
    plain versions, nothing is launched, and a device that is neither CPU
    nor CUDA is refused."""
    _, tcfg, buf, starts, counts, pix, _ = _case(1)
    tb, tst, tc, tp = _t(buf, starts, counts, pix)
    x = tb.clone().requires_grad_(True)
    with counting() as n:
        out = sk.SurfelCompositeWindows.apply(x, tst, tc, tp, C, tcfg)
        g = torch.from_numpy(_cotangent(tuple(out.shape), 9))
        out.backward(g)
    assert not any(n.values())
    assert torch.equal(out.detach(), sk.surfel_composite_windows_plain(tb, tst, tc, tp, C, tcfg))
    assert torch.equal(x.grad, sk.surfel_composite_windows_bwd_plain(
        tb, tst, tc, tp, out.detach(), g, C, tcfg))
    meta = [a.to("meta") for a in (tb, tst, tc, tp)]
    with pytest.raises(ValueError, match="unsupported device"):
        sk.surfel_composite_windows(*meta, C, tcfg)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.surfel_composite_windows_bwd(*meta, out.to("meta"), g.to("meta"), C, tcfg)


@pytest.mark.parametrize("kw", [
    dict(tile_capacity=64),
    dict(tile_capacity=16, max_tiles_per_gaussian=16, instance_capacity=1024),
])
def test_fused_surfel_render_equals_materialized(kw):
    """`render_surfels` with `fused_gather` against without, on the same
    packed surfels: every channel bit for bit, the same overflow, and the
    gradients to the packed rows."""
    base = {"max_visible": 512, "max_tiles_per_gaussian": 64, "chunk": 8, **kw}
    cfgs = TCfg(**base), TCfg(**base, fused_gather=True)
    args, W = _inputs(6, n=200, H=8)
    pk = ts.preprocess_surfels(*_t(*args), W, cfgs[0])
    beams = torch.from_numpy(np.array(args[-1]))
    names = ("color", "depth", "final_T", "normal", "median_depth", "distortion")
    outs = []
    for cfg in cfgs:
        x = pk.detach().clone().requires_grad_(True)
        o = ts.render_surfels(x, beams, W, torch.tensor([0.2, 0.6]), cfg, C=C)
        loss = sum((getattr(o, n) * torch.from_numpy(np.random.default_rng(8 + j).uniform(
            size=tuple(getattr(o, n).shape)).astype(np.float32))).sum()
            for j, n in enumerate(names))
        loss.backward()
        outs.append((o, x.grad))
    (a, ga), (b, gb) = outs
    for name in names + ("occ",):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert int(a.n_overflow) == int(b.n_overflow)
    if "instance_capacity" in kw:
        assert int(a.n_overflow) > 0
    np.testing.assert_allclose(gb.numpy(), ga.numpy(), rtol=1e-5, atol=1e-7)
    assert float(ga.abs().sum()) > 0


@pytest.mark.cuda
def test_cuda_surfel_window_kernels_match_tile_kernels_on_card():
    """K7 against K5 bit for bit on the same rows (the median included), K8's
    owned rows against K6's rows [0, count) bit for bit and every other row
    of dbuf exactly zero, and each against its plain version (K5's and K6's
    bounds on the card). The overflow case, so windows leave gaps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    _, tcfg, buf, starts, counts, pix, _ = _case(1)
    dev = torch.device("cuda")
    tb, tst, tc, tp = [x.to(dev) for x in _t(buf, starts, counts, pix)]
    inst = ck.window_rows(tb, tst, tcfg.tile_capacity).contiguous()
    with counting() as n:
        out = sk.surfel_composite_windows(tb, tst, tc, tp, C, tcfg)
        g = torch.from_numpy(_cotangent(tuple(out.shape), 10)).to(dev)
        d1 = sk.surfel_composite_windows_bwd(tb, tst, tc, tp, out, g, C, tcfg)
        d2 = sk.surfel_composite_windows_bwd(tb, tst, tc, tp, out, g, C, tcfg)
        torch.cuda.synchronize()
    assert (n["K7"], n["K8"]) == (1, 2)
    assert torch.equal(d1, d2)
    assert torch.equal(out, sk.surfel_composite_tiles(inst, tc, tp, C, tcfg))
    d_k6 = sk.surfel_composite_tiles_bwd(inst, tc, tp, out, g, C, tcfg)
    assert torch.equal(d1, ck.scatter_windows(d_k6, tst, tc, tb.shape[0]))
    _compare_out(out.cpu().numpy(),
                 sk.surfel_composite_windows_plain(tb, tst, tc, tp, C, tcfg).cpu().numpy())
    ref = sk.surfel_composite_windows_bwd_plain(tb, tst, tc, tp, out, g, C, tcfg)
    _compare_dbuf(d1.cpu().numpy(), ref.cpu().numpy(), starts, counts, far_count=64)
