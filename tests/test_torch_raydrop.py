"""The port's ray-drop refiners (`lidargs_torch/models/raydrop.py`) and
segmentation losses (`train/losses.py`) against the JAX package's, on the
CPU: the same numpy inputs, and JAX's initial parameters carried across.

Tolerances (float32 both sides):
  * `frequency_encode`, the MLP's output and its parameter gradients: 1e-6
    absolute / 1e-5 relative (measured: 6e-8, gradients 3e-7 relative);
  * `_bn`, `_upsample2`: 1e-5 absolute;
  * the UNet's output: 1e-4 absolute (sigmoid outputs; both packages lie
    within 1e-5 of a float64 run of the port);
  * the UNet's parameter gradients: the whole within 3e-2 of its norm,
    each leaf within 5e-2 of its norm plus 1e-5 of the whole's. Float32
    rounding is amplified here: BatchNorm's backward takes each channel's
    mean out of the cotangent, and the weight gradients above it sum that
    zero-mean cotangent against positive activations, so an error in the
    mean returns multiplied by about sqrt(pixels). Over ten draws at 32x64,
    channels 8, the packages agreed to 2e-5 in five and differed by 1.5e-3
    to 1.3e-2 (whole) and 2.2e-3 to 2.2e-2 (worst leaf) in the others, by
    either package's error against float64 (XLA's CPU sums more often).
    The leaf term's second part covers `inc/b`, whose exact gradient is zero
    (every path from it meets a BatchNorm);
  * the trainers' loss histories: the MLP's 1e-4 relative (Adam with the
    same math in another rounding order), the UNet's 5e-3 (its gradients
    above; over 2 epochs x 2 frames at 32x64 JAX's float32 history lay
    2.0e-3 from a float64 run of the port, the port's 7.8e-6);
  * the losses: 1e-5 relative.

The card's forward and gradients against the CPU's are the `cuda` case.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lidargs_tpu.models import raydrop as jr
from lidargs_tpu.train import losses as jl
from lidargs_tpu.utils.serialization import load_pytree_npz, save_pytree_npz
from lidargs_torch.models import raydrop as tr
from lidargs_torch.train import losses as tl
from lidargs_torch.utils.serialization import tree_paths
from lidargs_torch.utils.testing import one_torch_thread

_japply_unet = jax.jit(jr.apply_unet)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """PyTorch on one thread in this module (`one_torch_thread`)."""
    yield from one_torch_thread()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port_grads(model) -> dict:
    """The parameter gradients under JAX's path keys and layouts."""
    return {k: (p.grad.T if t else p.grad).cpu().numpy() for k, p, t in tr._jax_params(model)}


def _check_grads(got: dict, want: dict, rel: float, global_rel: float, whole: float = 1.0):
    """Each leaf within `rel` of its norm plus `global_rel` of the whole
    gradient's norm; the whole within `whole` of its norm."""
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    assert set(got) == set(want)
    for k, w in want.items():
        err = float(np.linalg.norm(got[k] - w))
        assert err <= rel * float(np.linalg.norm(w)) + global_rel * total, (k, err)
    err = np.sqrt(sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items()))
    assert err <= whole * total, err


UNET_GRAD_TOL = dict(rel=5e-2, global_rel=1e-5, whole=3e-2)


def _mlp_inputs(seed, n=256):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d, rng.uniform(size=(n, 1)).astype(np.float32),
            rng.uniform(size=(n, 1)).astype(np.float32),
            (rng.uniform(size=n) > 0.5).astype(np.float32))


@pytest.mark.parametrize("degree", [4, 6])
def test_frequency_encode_matches_jax(degree):
    x = np.random.default_rng(degree).uniform(-1, 1, (64, 3)).astype(np.float32)
    want = np.asarray(jr.frequency_encode(jnp.asarray(x), degree))
    got = tr.frequency_encode(torch.from_numpy(x), degree).numpy()
    assert got.shape == want.shape == (64, 3 * 2 * degree)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_raydrop_mlp_matches_jax():
    """`apply_raydrop_mlp`, `refine_raydrop` and the MSE's parameter
    gradients, from JAX's initial parameters."""
    jp = jr.init_raydrop_mlp(jax.random.key(0))
    model = tr.refiner_from_tree(_np(jp), "cpu")
    assert [tuple(lin.weight.shape) for lin in model.layers] == [
        (128, 48)] + [(128, 128)] * 3 + [(1, 128)]
    d, i, z, gt = _mlp_inputs(1)
    want = np.asarray(jr.apply_raydrop_mlp(jp, d, i, z))
    got = tr.apply_raydrop_mlp(model, *_t(d, i, z)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)

    H, W = 8, 32
    img = np.asarray(jr.refine_raydrop(jp, d.reshape(H, W, 3), i.reshape(H, W), z.reshape(H, W)))
    got_img = tr.refine_raydrop(model, *_t(d.reshape(H, W, 3), i.reshape(H, W),
                                           z.reshape(H, W))).detach().numpy()
    np.testing.assert_allclose(got_img, img, atol=1e-6)

    def loss(layers):
        return jnp.mean((jr.apply_raydrop_mlp({**jp, "layers": layers}, d, i, z)[:, 0] - gt) ** 2)

    want_g = dict(tree_paths({"layers": _np(jax.grad(loss)(jp["layers"]))}))
    tr.mlp_loss(model, *_t(d, i[:, 0], z[:, 0], gt)).backward()
    _check_grads(_port_grads(model), want_g, 1e-5, 0.0)


def test_bn_and_upsample_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(1.5, 3.0, (2, 6, 5, 7)).astype(np.float32)
    scale, bias = rng.normal(size=6).astype(np.float32), rng.normal(size=6).astype(np.float32)
    bn = tr._init_bn(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    want = np.asarray(jr._bn({"scale": scale, "bias": bias}, jnp.asarray(x)))
    for mode in (bn.train, bn.eval):               # batch statistics in both modes
        mode()
        np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), want, atol=1e-5)

    y = rng.normal(size=(1, 4, 4, 166)).astype(np.float32)
    up = np.asarray(jr._upsample2(jnp.asarray(y)))
    np.testing.assert_allclose(tr._upsample2(torch.from_numpy(y)).numpy(), up, atol=1e-5)
    # the docstring's align_corners=True is not what JAX computes
    corners = torch.nn.functional.interpolate(torch.from_numpy(y), scale_factor=2,
                                              mode="bilinear", align_corners=True).numpy()
    assert np.abs(corners - up).max() > 0.1


def test_unet_matches_jax():
    """`apply_unet` at channels 8 on 32x64: output and every parameter's
    gradient, from JAX's initial parameters."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(1, 3, 32, 64)).astype(np.float32)
    tgt = rng.uniform(size=(1, 1, 32, 64)).astype(np.float32)
    jp = jr.init_unet(jax.random.key(1), in_channels=3, channels=8)
    model = tr.refiner_from_tree(_np(jp), "cpu")
    assert isinstance(model, tr.UNet) and model.inc.weight.shape == (8, 3, 1, 1)

    def loss(p):
        y = jr.apply_unet(p, x)
        return jnp.mean((y - tgt) ** 2), y

    (_, want), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    got = tr.apply_unet(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    torch.mean((got - torch.from_numpy(tgt)) ** 2).backward()
    _check_grads(_port_grads(model), dict(tree_paths(_np(g))), **UNET_GRAD_TOL)


def test_refine_raydrop_unet_pads_and_crops():
    """30x50 is padded to 32x64 at the bottom and right and cropped back."""
    rng = np.random.default_rng(4)
    rd, inten, dep = (rng.uniform(size=(30, 50)).astype(np.float32) for _ in range(3))
    jp = jr.init_unet(jax.random.key(2), in_channels=3, channels=8)
    want = np.asarray(jax.jit(jr.refine_raydrop_unet)(jp, rd, inten, dep))
    model = tr.refiner_from_tree(_np(jp), "cpu")
    x, hw = tr._pad16(torch.from_numpy(np.stack([rd, inten, dep])))
    assert tuple(x.shape) == (3, 32, 64) and hw == (30, 50) and not x[:, 30:].any()
    got = tr.refine_raydrop_unet(model, *_t(rd, inten, dep)).detach().numpy()
    assert got.shape == (30, 50)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_mlp_trainer_matches_jax():
    """2 epochs x 2 frames from JAX's init (a decay over 2 steps, so the
    schedule moves): the loss histories and the trained outputs."""
    rng = np.random.default_rng(5)
    d = _mlp_inputs(6, 128)[0]
    inten, dep = rng.uniform(size=(2, 2, 128)).astype(np.float32)
    gt = (dep > 0.5).astype(np.float32)
    kw = dict(epochs=2, lr=5e-3, n_iters=2)
    jparams, jhist = jr.train_raydrop_refiner(jax.random.key(0), d, inten, dep, gt, **kw)
    model = tr.refiner_from_tree(_np(jr.init_raydrop_mlp(jax.random.key(0))), "cpu")
    model, hist = tr.train_raydrop_refiner(model, d, inten, dep, gt, **kw)
    assert len(hist) == 2
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    want = np.asarray(jr.apply_raydrop_mlp(jparams, d, inten[0][:, None], dep[0][:, None]))
    got = model(*_t(d, inten[0][:, None], dep[0][:, None])).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_unet_trainer_matches_jax():
    rng = np.random.default_rng(7)
    rd, inten, dep = rng.uniform(size=(3, 2, 32, 64)).astype(np.float32)
    gt = (dep > 0.5).astype(np.float32)
    kw = dict(epochs=2, n_iters=2)
    _, jhist = jr.train_unet_refiner(jax.random.key(0), rd, inten, dep, gt, channels=8, **kw)
    model = tr.refiner_from_tree(
        _np(jr.init_unet(jax.random.key(0), in_channels=3, channels=8)), "cpu")
    model, hist = tr.train_unet_refiner(model, rd, inten, dep, gt, **kw)
    np.testing.assert_allclose(hist, jhist, rtol=5e-3)


@pytest.mark.parametrize("arch", ["mlp", "unet"])
def test_refiner_npz_crosses_packages(arch, tmp_path):
    """JAX's `save_pytree_npz` file loads in the port, and the port's
    `save_refiner` file in JAX's `load_pytree_npz` (integer leaves too),
    both computing the same refined ray drop."""
    rng = np.random.default_rng(8)
    H, W = 32, 64
    rd, inten, dep = (rng.uniform(size=(H, W)).astype(np.float32) for _ in range(3))
    dirs = _mlp_inputs(9, H * W)[0].reshape(H, W, 3)
    if arch == "mlp":
        jinit = lambda k: jr.init_raydrop_mlp(k)
        jrun = lambda p: jr.refine_raydrop(p, dirs, inten, dep)
        trun = lambda m: tr.refine_raydrop(m, *_t(dirs, inten, dep))
        tinit = tr.init_raydrop_mlp
    else:
        jinit = lambda k: jr.init_unet(k, in_channels=3, channels=8)
        jrun = lambda p: _japply_unet(p, np.stack([rd, inten, dep])[None])[0, 0]
        trun = lambda m: tr.refine_raydrop_unet(m, *_t(rd, inten, dep))
        tinit = lambda gen, device: tr.init_unet(gen, channels=8, device=device)

    jax_file = str(tmp_path / "jax.npz")
    jp = jinit(jax.random.key(3))
    save_pytree_npz(jax_file, jp)
    port = tr.load_refiner(jax_file, "cpu")
    np.testing.assert_allclose(trun(port).detach().numpy(), np.asarray(jrun(jp)), atol=1e-4)

    port_file = str(tmp_path / "port.npz")
    model = tinit(torch.Generator().manual_seed(0), device="cpu")
    tr.save_refiner(port_file, model)
    with np.load(port_file) as a, np.load(jax_file) as b:
        assert set(a.files) == set(b.files)
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a.files)
    back = load_pytree_npz(port_file, jinit(jax.random.key(0)))
    np.testing.assert_allclose(np.asarray(jrun(back)), trun(model).detach().numpy(), atol=1e-4)
    if arch == "mlp":
        assert int(back["dir_degree"]) == 4 and int(back["id_degree"]) == 6


def _labels(seed, n=200, C=3):
    """Logits [n, C] and labels with ignores (-1) and class C-1 absent."""
    rng = np.random.default_rng(seed)
    est = rng.normal(size=(n, C)).astype(np.float32) * 2
    gt = rng.integers(0, C - 1, n).astype(np.int32)
    gt[rng.uniform(size=n) < 0.2] = -1
    return est, gt


@pytest.mark.parametrize("case", ["lovasz_grad", "lovasz_softmax_flat", "get_ce_weights",
                                  "raydrop_lossf", "raydrop_lossf_unweighted"])
def test_raydrop_losses_match_jax(case):
    est, gt = _labels(10)
    probs = np.asarray(jax.nn.softmax(est, axis=1))
    if case == "lovasz_grad":
        fg = np.sort((np.random.default_rng(11).uniform(size=64) > 0.6).astype(np.float32))[::-1]
        want, got = jl.lovasz_grad(jnp.asarray(fg)), tl.lovasz_grad(*_t(fg))
    elif case == "lovasz_softmax_flat":
        want = jl.lovasz_softmax_flat(jnp.asarray(probs), jnp.asarray(gt))
        got = tl.lovasz_softmax_flat(*_t(probs, gt.astype(np.int64)))
    elif case == "get_ce_weights":
        want = jl.get_ce_weights(jnp.asarray(gt), 3)
        got = tl.get_ce_weights(torch.from_numpy(gt.astype(np.int64)), 3)
        assert float(got[2]) == 50.0                    # the absent class, clipped
    else:
        rw = case == "raydrop_lossf"
        want = jl.raydrop_lossf(jnp.asarray(est), jnp.asarray(gt), reweight=rw)
        got = tl.raydrop_lossf(*_t(est, gt.astype(np.int64)), reweight=rw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_refiners_on_card_match_cpu():
    """The UNet (channels 32) on the card against the same on the CPU: the
    output within 1e-4 (float32 rounding gives ~1e-5; TF32's unit, 4.9e-4,
    would show), the gradients within the JAX comparison's bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.uniform(size=(1, 3, 64, 256)).astype(np.float32))
    gt = torch.from_numpy((rng.uniform(size=(64, 256)) > 0.5).astype(np.float32))
    cpu = tr.init_unet(torch.Generator().manual_seed(0), device="cpu")
    card = tr.refiner_from_tree(tr.refiner_tree(cpu), "cuda")
    outs, grads = [], []
    for m, dev in ((cpu, "cpu"), (card, "cuda")):
        loss = tr.unet_loss(m, x[0].to(dev), gt.to(dev))
        loss.backward()
        outs.append(m(x.to(dev)).detach().cpu().numpy())
        grads.append(_port_grads(m))
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-4)
    _check_grads(grads[1], grads[0], **UNET_GRAD_TOL)

