"""Neural Gaussian Field: Scaffold-GS anchors decoded by view-conditioned
MLP heads, and the forward render path.

Counterpart of `lidargs_tpu/models/field.py`. Anchor arrays are padded to a
static capacity with a `valid` mask, as in the JAX package, so parameters
carry across unchanged (`utils/params.py`). The decode is anchor-major
[C, k, ...] and is flattened once, at the projection, so `visible` and every
per-gaussian row line up with the JAX package's.

`render_field_surfel` is the surfel (2DGS) variant's render path: the same
decode, the first two decoded covariance scales as the surfel's scales.

`init_field_from_points` builds the field from a point cloud: the voxel
dedup of `voxelize_points` and the initial scales of `ops/knn.py`'s 3-NN.

`anchor_rows` cuts the table to its rows [0, B) for a render: every live
anchor lies below B (`train/graphs.py` `LiveExtent`), and the rows above
are padding that the render masks.

`render_frame_packed` is the forward beam frame whose front is one kernel
(`ops/front_kernel.py` `front_packed`: F1 on a card), `render_surfel_packed`
the surfel frame's (`surfel_front_packed`: F2 on a card); `frame_render`
gives them for the layouts the kernels take (`front_kernel.takes`) and
`render_fn`'s path for every other.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from ..config import ModelConfig, RasterConfig
from ..lidar.frames import LidarFrame
from ..ops import front_kernel
from ..ops.projection import preprocess_gaussians, preprocess_gaussians_hv, unit_x, visible_filter
from ..ops.rasterize import (RenderOut, cull_packed, permutation_rows, render_packed_window,
                             render_tiled, tiled_image)
from ..ops.surfel import SurfelCols, SurfelOut, preprocess_surfels, render_surfels, surfel_image
from ..utils.device import resolve_device
from .mlp import apply_mlp, init_mlp


ANCHOR_ROWS = ("anchor", "offset", "feat", "scaling", "rotation", "opacity")


class AnchorField(NamedTuple):
    """Static-capacity anchor state. `params` entries are trainable."""

    params: dict                 # anchor/offset/feat/scaling/rotation/opacity + mlp_*
    valid: torch.Tensor          # [C] bool anchor liveness
    voxel_size: float


def mlp_input_dims(cfg: ModelConfig, num_cameras: int = 0) -> dict:
    """Head input widths. The appearance rows exist only when an appearance
    embedding is created (appearance_dim > 0 and there are cameras)."""
    d_op = cfg.feat_dim + 3 + (1 if cfg.add_opacity_dist else 0)
    d_cov = cfg.feat_dim + 3 + (1 if cfg.add_cov_dist else 0)
    app = cfg.appearance_dim if (cfg.appearance_dim > 0 and num_cameras > 0) else 0
    d_col = cfg.feat_dim + 3 + (1 if cfg.add_color_dist else 0) + app
    return {"opacity": d_op, "cov": d_cov, "color": d_col, "raydrop": d_col}


def init_field_params(cfg: ModelConfig, num_cameras: int = 0,
                      generator: Optional[torch.Generator] = None,
                      device="cuda") -> dict:
    """MLP heads + empty anchor arrays at capacity. Random draws come from
    `generator` (a CPU generator; seed 0 when omitted) and are then moved to
    `device`."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    C = cfg.anchor_capacity
    dims = mlp_input_dims(cfg, num_cameras)
    f32 = dict(dtype=torch.float32, device=dev)
    rotation = torch.zeros((C, 4), **f32)
    rotation[:, 0] = 1.0
    params = {
        "anchor": torch.zeros((C, 3), **f32),
        "offset": torch.zeros((C, cfg.n_offsets, 3), **f32),
        "feat": torch.zeros((C, cfg.feat_dim), **f32),
        "scaling": torch.zeros((C, 6), **f32),          # log-scale
        "rotation": rotation,
        "opacity": torch.zeros((C, 1), **f32),          # frozen (inverse-sigmoid)
        "mlp_opacity": init_mlp(gen, dims["opacity"], cfg.mlp_hidden, cfg.n_offsets, dev),
        "mlp_cov": init_mlp(gen, dims["cov"], cfg.mlp_hidden, 7 * cfg.n_offsets, dev),
        "mlp_color": init_mlp(gen, dims["color"], cfg.mlp_hidden,
                              (cfg.color_channel - 1) * cfg.n_offsets, dev),
        "mlp_raydrop": init_mlp(gen, dims["color"], cfg.mlp_hidden, cfg.n_offsets, dev),
    }
    if cfg.use_feat_bank:
        params["mlp_featbank"] = init_mlp(gen, 4, cfg.mlp_hidden, 3, dev)
    if cfg.appearance_dim > 0 and num_cameras > 0:
        # torch nn.Embedding's default init: N(0, 1)
        for name in ("appearance", "appearance_rd"):
            params[name] = torch.randn((num_cameras, cfg.appearance_dim),
                                       generator=gen).to(dev)
    return params


def voxelize_points(points, voxel_size: float) -> torch.Tensor:
    """Unique voxel-rounded points, float64, in lexicographic row order:
    round(points * (1/voxel)) (half to even), unique rows, times the voxel.
    The JAX package's native dedup rounds the same product; its numpy
    fallback rounds `points / voxel`, which can pick the other cell at a
    half-voxel tie. The rows are ordered by three stable sorts (z, then y,
    then x), which is faster than `torch.unique(dim=0)` and gives its
    order."""
    pts = torch.as_tensor(points).to(torch.float64)
    cells = torch.round(pts * (1.0 / voxel_size))
    order = torch.arange(cells.shape[0], device=cells.device)
    for col in (2, 1, 0):
        order = order[torch.argsort(cells[order, col], stable=True)]
    cells = cells[order]
    new = torch.ones(cells.shape[0], dtype=torch.bool, device=cells.device)
    new[1:] = (cells[1:] != cells[:-1]).any(1)
    return cells[new] * voxel_size


def init_field_from_points(cfg: ModelConfig, points, voxel_size: Optional[float] = None,
                           num_cameras: int = 0,
                           generator: Optional[torch.Generator] = None,
                           device="cuda") -> AnchorField:
    """The field of a point cloud [N, 3] (the reference's create_from_pcd):
    every `cfg.ratio`-th point, voxelized at `voxel_size` (else
    `cfg.voxel_size`; <= 0: the median of the points' mean squared 3-NN
    distances), log sqrt of the anchors' mean squared 3-NN distance as all
    six initial scales, identity rotations, opacity 0 (sigmoid 0.5). The
    heads come from `init_field_params` with `generator`. Raises when the
    anchors exceed `cfg.anchor_capacity`."""
    from ..ops.knn import mean_sq_dist_3nn

    dev = resolve_device(device)
    pts = torch.as_tensor(points).to(device=dev, dtype=torch.float64)[::cfg.ratio]
    vs = cfg.voxel_size if voxel_size is None else voxel_size
    if vs <= 0:
        # numpy's median (the mean of the two middle values), on the host
        vs = float(np.median(mean_sq_dist_3nn(pts.to(torch.float32)).cpu().numpy()))
    anchors = voxelize_points(pts, vs).to(torch.float32)
    n = anchors.shape[0]
    if n > cfg.anchor_capacity:
        raise ValueError(f"{n} anchors exceed capacity {cfg.anchor_capacity}; raise "
                         "ModelConfig.anchor_capacity")
    d2 = mean_sq_dist_3nn(anchors).clamp_min(1e-7)
    scales = torch.log(torch.sqrt(d2))[:, None].repeat(1, 6)

    params = init_field_params(cfg, num_cameras, generator=generator, device=dev)
    params["anchor"][:n] = anchors
    params["scaling"][:n] = scales
    params["opacity"][:n] = 0.0             # inverse_sigmoid(0.5)
    valid = torch.arange(cfg.anchor_capacity, device=dev) < n
    return AnchorField(params=params, valid=valid, voxel_size=vs)


def anchor_rows(params: dict, valid: torch.Tensor, B: int):
    """(params, valid) with the anchor rows (ANCHOR_ROWS, and valid) cut to
    the views [0, B), the heads as they are; at B >= the capacity, the two
    unchanged. A gradient through the views reaches the whole leaves, zero
    above B."""
    if B >= valid.shape[0]:
        return params, valid
    return {**params, **{n: params[n][:B] for n in ANCHOR_ROWS}}, valid[:B]


def heads_fusable(cfg: ModelConfig, params: dict) -> bool:
    """Whether the four heads read one input (every `add_*_dist` equal and
    no appearance rows), so that their first layers run as one product."""
    return (cfg.add_opacity_dist == cfg.add_color_dist == cfg.add_cov_dist
            and not (cfg.appearance_dim > 0 and "appearance" in params))


class NeuralGaussians(NamedTuple):
    """Decoded per-view gaussians, anchor-major [C, k, ...]."""

    xyz: torch.Tensor            # [C, k, 3]
    feat: torch.Tensor           # [C, k, channels] (intensity..., raydrop)
    opacity: torch.Tensor        # [C, k] raw tanh output (rasterizer opacity)
    scaling: torch.Tensor        # [C, k, 3] cov scales (activated)
    rot: torch.Tensor            # [C, k, 4] normalized
    mask: torch.Tensor           # [C, k] anchor-valid & visible & opacity>0
    neural_opacity: torch.Tensor  # [C, k] pre-mask
    sel_mask: torch.Tensor       # [C, k] opacity>0 & visible


def generate_neural_gaussians(
    params: dict,
    valid: torch.Tensor,
    anchor_visible: torch.Tensor,   # [C] prefilter mask
    cam_center: torch.Tensor,       # [3]
    cfg: ModelConfig,
    cam_uid: Optional[torch.Tensor] = None,
) -> NeuralGaussians:
    """Decode every anchor's k neural gaussians for this view, masked
    instead of compacted."""
    k = cfg.n_offsets
    anchor = params["anchor"]
    Cap = anchor.shape[0]

    ob_view = anchor - cam_center
    # padded anchors can coincide with the sensor origin: guard the norm
    d2 = (ob_view * ob_view).sum(1, keepdim=True)
    ok = d2 > 0.0
    ob_dist = torch.sqrt(torch.where(ok, d2, torch.ones_like(d2)))
    ob_view = torch.where(ok, ob_view, torch.zeros_like(ob_view)) / ob_dist

    feat = params["feat"]
    if cfg.use_feat_bank:
        bank_w = apply_mlp(params["mlp_featbank"], torch.cat([ob_view, ob_dist], 1),
                           final_act=lambda y: torch.softmax(y, dim=1))
        # multi-resolution mixing
        feat = (feat[:, ::4].repeat(1, 4) * bank_w[:, :1]
                + feat[:, ::2].repeat(1, 2) * bank_w[:, 1:2]
                + feat * bank_w[:, 2:])

    cat = torch.cat([feat, ob_view, ob_dist], 1)
    cat_nodist = torch.cat([feat, ob_view], 1)

    if heads_fusable(cfg, params):
        # all four heads read the same input: their first layers run as one
        # product of the concatenated weights, their second layers per head
        x = cat if cfg.add_opacity_dist else cat_nodist
        names = ("mlp_opacity", "mlp_color", "mlp_raydrop", "mlp_cov")
        w1 = torch.cat([params[n]["l1"]["w"] for n in names], 1)
        b1 = torch.cat([params[n]["l1"]["b"] for n in names])
        h = torch.relu(x @ w1 + b1)
        Hd = params["mlp_opacity"]["l1"]["w"].shape[1]
        outs = [h[:, i * Hd:(i + 1) * Hd] @ params[n]["l2"]["w"] + params[n]["l2"]["b"]
                for i, n in enumerate(names)]
        neural_op = torch.tanh(outs[0])                            # [C,k]
        intensity = torch.sigmoid(outs[1])
        raydrop = torch.sigmoid(outs[2])
        scale_rot = outs[3].reshape(Cap, k, 7)
    else:
        op_in = cat if cfg.add_opacity_dist else cat_nodist
        neural_op = apply_mlp(params["mlp_opacity"], op_in, final_act=torch.tanh)

        col_in = cat if cfg.add_color_dist else cat_nodist
        if cfg.appearance_dim > 0 and "appearance" in params:
            # JAX's gather: a negative index counts from the end, and then
            # any index is clamped into the table (a frame uid beyond the
            # cameras, as a dynamic sub-scene gives, reads the last row)
            n_cam = params["appearance"].shape[0]
            uid = torch.where(cam_uid < 0, cam_uid + n_cam, cam_uid).clamp(0, n_cam - 1)
            app = params["appearance"][uid].expand(Cap, cfg.appearance_dim)
            app_rd = params["appearance_rd"][uid].expand(Cap, cfg.appearance_dim)
            col_in_c = torch.cat([col_in, app], 1)
            col_in_r = torch.cat([col_in, app_rd], 1)
        else:
            col_in_c = col_in_r = col_in
        intensity = apply_mlp(params["mlp_color"], col_in_c, final_act=torch.sigmoid)
        raydrop = apply_mlp(params["mlp_raydrop"], col_in_r, final_act=torch.sigmoid)

        cov_in = cat if cfg.add_cov_dist else cat_nodist
        scale_rot = apply_mlp(params["mlp_cov"], cov_in).reshape(Cap, k, 7)
    color = torch.cat([intensity.reshape(Cap, k, cfg.color_channel - 1),
                       raydrop.reshape(Cap, k, 1)], -1)

    # anchor-major epilogue: [C, 1, x] broadcasts instead of [C*k, x] repeats
    scaling_all = torch.exp(params["scaling"])                     # [C,6]
    scaling = scaling_all[:, None, 3:] * torch.sigmoid(scale_rot[..., :3])
    q = scale_rot[..., 3:7]
    qn2 = (q * q).sum(-1, keepdim=True)
    unit = unit_x(4, q.dtype, q.device)
    rot = torch.where(qn2 > 0, q, unit) / torch.sqrt(
        torch.where(qn2 > 0, qn2, torch.ones_like(qn2)))

    xyz = anchor[:, None, :] + params["offset"] * scaling_all[:, None, :3]

    vis = (valid & anchor_visible)[:, None]                        # [C,1]
    sel = neural_op > 0.0                                          # [C,k]
    return NeuralGaussians(
        xyz=xyz,
        feat=color,
        opacity=neural_op,
        scaling=scaling,
        rot=rot,
        mask=vis & sel,
        neural_opacity=neural_op,
        sel_mask=sel & vis,
    )


@torch.no_grad()
def prefilter_anchors(field_params: dict, valid: torch.Tensor,
                      frame: LidarFrame, rcfg: RasterConfig) -> torch.Tensor:
    """Project the raw anchors with their offset scales (scaling[:, :3]) and
    keep those with radii > 0. A mask only, so no gradient is traced."""
    scales = torch.exp(field_params["scaling"][:, :3])
    q = field_params["rotation"]
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True).clamp_min(1e-12)
    return visible_filter(field_params["anchor"], scales, q, valid,
                          frame.w2s_rot, frame.w2s_trans, frame.beams, frame.W, rcfg)


def project_decoded(ng: NeuralGaussians, frame: LidarFrame, rcfg: RasterConfig):
    """Flatten the anchor-major decode once, at the projection boundary, and
    project it. The projection's backward is the hand VJP when
    `projection_hand_vjp` (and not `remat_projection`); with
    `remat_projection` the plain function runs under activation
    checkpointing (recomputed in the backward); else autograd of the plain
    function."""
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    args = (flat(ng.xyz), flat(ng.scaling), flat(ng.rot), flat(ng.opacity),
            flat(ng.feat), flat(ng.mask),
            frame.w2s_rot, frame.w2s_trans, frame.beams, frame.W, rcfg)
    if rcfg.projection_hand_vjp and not rcfg.remat_projection:
        return preprocess_gaussians_hv(*args)
    if rcfg.remat_projection:
        return torch.utils.checkpoint.checkpoint(preprocess_gaussians, *args,
                                                 use_reentrant=False)
    return preprocess_gaussians(*args)


def field_splats(params: dict, valid: torch.Tensor, frame: LidarFrame,
                 mcfg: ModelConfig, rcfg: RasterConfig,
                 sphere_proxy: Optional[torch.Tensor] = None):
    """The front half of `render_field`: prefilter -> decode (`decode_visible`)
    -> project.
    Returns (Splats, NeuralGaussians, anchor_visible, n_anchor_drop), where
    n_anchor_drop counts the visible anchors beyond `visible_anchor_cap`
    (None when the cap is off).

    `sphere_proxy` ([C, k, 3], zeros) is added to the unit-sphere means
    after the projection: its gradient is the densification signal.

    With `rcfg.visible_anchor_cap > 0` the prefiltered anchors are compacted
    to that many rows before the decode (visible anchors first, in their
    order, by one stable sort). The densification statistics index the full
    anchor table, so the cap and the proxy exclude each other."""
    anchor_visible = prefilter_anchors(params, valid, frame, rcfg)
    ng, anchor_visible, n_anchor_drop = decode_visible(params, valid, anchor_visible, frame,
                                                       mcfg, rcfg, sphere_proxy)
    splats = project_decoded(ng, frame, rcfg)
    if sphere_proxy is not None:
        splats = splats._replace(sphere_mean=splats.sphere_mean + sphere_proxy.reshape(-1, 3))
    return splats, ng, anchor_visible, n_anchor_drop


def decode_visible(params: dict, valid: torch.Tensor, anchor_visible: torch.Tensor,
                   frame: LidarFrame, mcfg: ModelConfig, rcfg: RasterConfig,
                   sphere_proxy: Optional[torch.Tensor] = None):
    """The decode step of `field_splats`, after the prefilter: (NeuralGaussians,
    anchor_visible, n_anchor_drop), the anchors first compacted to
    `visible_anchor_cap` rows where it is set (see `field_splats`), which
    refuses a `sphere_proxy`."""
    Ca = rcfg.visible_anchor_cap
    n_anchor_drop = None
    if Ca and Ca > 0:
        if sphere_proxy is not None:
            raise ValueError(
                "visible_anchor_cap is a render/eval-path optimization; the "
                "training step's densification proxy needs the full table")
        C = params["anchor"].shape[0]
        Ca = min(Ca, C)
        vis = valid & anchor_visible
        order = torch.sort((~vis).to(torch.int32), stable=True).indices
        n_vis = vis.sum()
        n_anchor_drop = (n_vis - Ca).clamp_min(0)
        sub = dict(params)
        for name in ANCHOR_ROWS:
            sub[name] = permutation_rows(params[name], order, Ca)
        sub_on = torch.arange(Ca, device=vis.device) < n_vis.clamp_max(Ca)
        params, valid, anchor_visible = sub, sub_on, sub_on
    ng = generate_neural_gaussians(params, valid, anchor_visible, frame.center,
                                   mcfg, cam_uid=frame.uid)
    return ng, anchor_visible, n_anchor_drop


def render_field(params: dict, valid: torch.Tensor, frame: LidarFrame,
                 mcfg: ModelConfig, rcfg: RasterConfig, bg: torch.Tensor,
                 sphere_proxy: Optional[torch.Tensor] = None):
    """Full render path: prefilter -> decode -> project -> tiled splat.
    Returns (RenderOut, NeuralGaussians, anchor_visible). Visible anchors
    beyond `visible_anchor_cap` are counted into n_dropped, k gaussians
    each. `sphere_proxy`: see `field_splats`."""
    splats, ng, anchor_visible, n_anchor_drop = field_splats(
        params, valid, frame, mcfg, rcfg, sphere_proxy)
    out: RenderOut = render_tiled(splats, frame.beams, frame.W, bg, rcfg)
    if n_anchor_drop is not None:
        out = out._replace(n_dropped=out.n_dropped + n_anchor_drop * mcfg.n_offsets)
    return out, ng, anchor_visible


def field_surfels(params: dict, valid: torch.Tensor, frame: LidarFrame,
                  mcfg: ModelConfig, rcfg: RasterConfig,
                  mean_proxy: Optional[torch.Tensor] = None):
    """The front half of `render_field_surfel`: prefilter -> decode ->
    surfel preprocess. Returns (packed [C*k, F] surfel rows,
    NeuralGaussians, anchor_visible).

    The decode is the beam variant's; its first two covariance scales
    parameterize the surfel, whose third local axis is the normal.
    `mean_proxy` ([C, k, 3], zeros) is added to the decoded world means: its
    gradient is the densification signal. With `remat_projection` the
    preprocess runs under activation checkpointing (recomputed in the
    backward)."""
    anchor_visible = prefilter_anchors(params, valid, frame, rcfg)
    ng = generate_neural_gaussians(params, valid, anchor_visible, frame.center, mcfg,
                                   cam_uid=frame.uid)
    xyz = ng.xyz if mean_proxy is None else ng.xyz + mean_proxy
    # the surfel preprocess takes flat [P, ...] rows: flatten the
    # anchor-major decode once, here
    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    args = (flat(xyz), flat(ng.scaling)[:, :2], flat(ng.rot), flat(ng.opacity),
            flat(ng.feat), flat(ng.mask), frame.w2s_rot, frame.w2s_trans, frame.beams,
            frame.W, rcfg)
    if rcfg.remat_projection:
        pk = torch.utils.checkpoint.checkpoint(preprocess_surfels, *args, use_reentrant=False)
    else:
        pk = preprocess_surfels(*args)
    return pk, ng, anchor_visible


def render_field_surfel(params: dict, valid: torch.Tensor, frame: LidarFrame,
                        mcfg: ModelConfig, rcfg: RasterConfig, bg: torch.Tensor,
                        mean_proxy: Optional[torch.Tensor] = None):
    """Surfel (2DGS) render path: prefilter -> decode -> surfel preprocess ->
    tiled surfel splat (K5, K6 on the card). Returns (SurfelOut,
    NeuralGaussians, anchor_visible). `mean_proxy`: see `field_surfels`."""
    pk, ng, anchor_visible = field_surfels(params, valid, frame, mcfg, rcfg, mean_proxy)
    out: SurfelOut = render_surfels(pk, frame.beams, frame.W, bg, rcfg, C=ng.feat.shape[-1])
    return out, ng, anchor_visible


def render_frame_packed(params: dict, valid: torch.Tensor, frame: LidarFrame,
                        mcfg: ModelConfig, rcfg: RasterConfig, bg: torch.Tensor,
                        sphere_proxy: Optional[torch.Tensor] = None):
    """The forward beam frame with its front as one kernel: `front_packed`
    (F1 on a card) -> the cull sort (`cull_packed`) -> the tiled splat ->
    the image. Returns (RenderOut, None, None): no NeuralGaussians and no
    gradient. On the CPU its output is `render_field`'s, bit for bit.
    Takes the layouts of `front_kernel.takes` and no proxy."""
    if sphere_proxy is not None:
        raise ValueError("render_frame_packed is the forward frame: it takes no sphere proxy")
    pk, depth, visible, n_valid = front_kernel.front_packed(params, valid, frame, mcfg, rcfg)
    C = mcfg.color_channel
    pkv, n_dropped = cull_packed(pk, depth, n_valid, rcfg, C)
    color_t, depth_t, final_T_t, n_overflow = render_packed_window(pkv, frame.beams, frame.W,
                                                                   rcfg, C)
    out = tiled_image(color_t, depth_t, final_T_t, frame.beams.shape[0], frame.W, bg, rcfg,
                      visible, n_dropped, n_overflow)
    return out, None, None


def render_surfel_packed(params: dict, valid: torch.Tensor, frame: LidarFrame,
                         mcfg: ModelConfig, rcfg: RasterConfig, bg: torch.Tensor,
                         mean_proxy: Optional[torch.Tensor] = None):
    """The forward surfel frame with its front as one kernel:
    `surfel_front_packed` (F2 on a card) -> the cull sort on its depth and
    count (`cull_packed`) -> `surfel_image` (K5, or K7 with `fused_gather`).
    Returns (SurfelOut, None, None): no NeuralGaussians and no gradient. On
    the CPU its output is `render_field_surfel`'s, bit for bit. Takes the
    layouts of `front_kernel.takes` and no proxy."""
    if mean_proxy is not None:
        raise ValueError("render_surfel_packed is the forward frame: it takes no mean proxy")
    pk, depth, visible, n_valid = front_kernel.surfel_front_packed(params, valid, frame, mcfg,
                                                                   rcfg)
    C = mcfg.color_channel
    pkv, n_dropped = cull_packed(pk, depth, n_valid, rcfg, C, SurfelCols)
    out = surfel_image(pkv, frame.beams, frame.W, bg, rcfg, C, visible, n_dropped)
    return out, None, None


PACKED_FRAMES = {"beam": render_frame_packed, "surfel": render_surfel_packed}


def frame_render(variant: str, params: dict, mcfg: ModelConfig, rcfg: RasterConfig):
    """The forward frame of a variant for this layout: its packed frame
    (`PACKED_FRAMES`: `render_frame_packed`, `render_surfel_packed`) where
    the one-kernel fronts take the layout (`front_kernel.takes`), else
    `render_fn`'s."""
    render = render_fn(variant)
    if front_kernel.takes(params, mcfg, rcfg):
        return PACKED_FRAMES[variant]
    return render


def render_fn(variant: str):
    """The render path of a variant: `render_field` ("beam") or
    `render_field_surfel` ("surfel"). Both take (params, valid, frame, mcfg,
    rcfg, bg, proxy) and return (out, NeuralGaussians, anchor_visible)."""
    if variant == "beam":
        return render_field
    if variant == "surfel":
        return render_field_surfel
    raise ValueError(f"unknown variant {variant!r}: 'beam' or 'surfel'")
