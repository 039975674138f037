"""The configuration the reference reads: a frozen copy of the port's
`RasterConfig`, `ModelConfig`, `LrSchedule` and `OptConfig` (field names
and defaults), filled from the same configuration file as the port's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class RasterConfig:
    """Static configuration of the range-view rasterizer.

    The capacities bound the work per frame: `max_visible` gaussians are
    kept after culling, each touches at most `max_tiles_per_gaussian`
    tiles, and each tile composites its nearest `tile_capacity` instances.
    Overflow is counted and reported, never silently wrong for the
    survivors."""

    channels: int = 2                       # intensity + raydrop
    tile_h: int = 1                         # pixel rows per physical tile
    tile_w: int = 128                       # pixel cols per physical tile
    ref_block_x: int = 16                   # reference's virtual tiling, used for
    ref_block_y: int = 1                    # bit-parity pixel-rect masking
    ray_divergence_angle: float = 0.002
    near: float = 0.0
    far: float = 80.0
    # surfel (2DGS) variant: the divergence rejection of a surfel's center,
    # the per-pair near cut and the distortion map's near/far, and the rho2d
    # low-pass weight
    surfel_ray_divergence_angle: float = 0.006
    surfel_near: float = 0.2
    surfel_far: float = 80.0
    filter_inv_square: float = 2.0
    alpha_min: float = 1.0 / 255.0
    transmittance_min: float = 1e-4
    alpha_clamp: float = 0.99
    lowpass: float = 0.01                   # added to cov2d diagonal pre 1/d^2
    # compact the prefiltered anchors to this many rows before the decode
    # (render/eval path only; 0 = off). Anchors beyond the cap are counted
    # into n_dropped.
    visible_anchor_cap: int = 0
    max_visible: int = 2 ** 18              # gaussians after cull-compaction
    max_tiles_per_gaussian: int = 32        # per-gaussian tile rect cap
    tile_capacity: int = 512                # sorted instances composited / tile
    chunk: int = 16                         # instances per plain-scan step
    # binning key budget: 0/-1 = the exact dense [V, cap] grid; a positive
    # budget emits that many (gaussian, tile) slots by rank search and
    # counts the instances beyond it into n_overflow
    instance_capacity: int = 0
    # per-tile windows of one sorted buffer instead of the [T, K, F]
    # gather: kernels K3/K4 (beam), K7/K8 (surfel) for K1/K2, K5/K6
    fused_gather: bool = False
    # training-only projection knobs, read once the backward is ported
    remat_projection: bool = False
    projection_hand_vjp: bool = True

    def grid_shape(self, H: int, W: int) -> Tuple[int, int]:
        return (-(-H // self.tile_h), -(-W // self.tile_w))

    def num_tiles(self, H: int, W: int) -> int:
        gy, gx = self.grid_shape(H, W)
        return gy * gx


@dataclass(frozen=True)
class ModelConfig:
    """Neural Gaussian Field hyper-parameters."""

    feat_dim: int = 32
    n_offsets: int = 6
    color_channel: int = 2                  # intensity + raydrop
    voxel_size: float = 0.0                 # <=0: median 3-NN distance
    update_depth: int = 3
    update_init_factor: int = 16
    update_hierachy_factor: int = 4
    use_feat_bank: bool = False
    appearance_dim: int = 0
    ratio: int = 1
    add_opacity_dist: bool = True
    add_cov_dist: bool = True
    add_color_dist: bool = True
    mlp_hidden: int = 32
    # anchor arrays are padded to this static capacity
    anchor_capacity: int = 2 ** 17
    max_anchors: int = 1_200_000
    grow_src_cap: int = 2 ** 16
    grow_cap_per_level: int = 2 ** 13


@dataclass(frozen=True)
class LrSchedule:
    init: float = 0.0
    final: float = 0.0
    delay_steps: int = 0
    delay_mult: float = 0.01
    max_steps: int = 10_000


@dataclass(frozen=True)
class OptConfig:
    """Optimization parameters: learning rates, loss weights and the
    densification cadence (the JAX package's `OptConfig`, field for field)."""

    iterations: int = 10_000
    anchor_lr: LrSchedule = field(default_factory=lambda: LrSchedule(0.0, 0.0))
    offset_lr: LrSchedule = field(default_factory=lambda: LrSchedule(0.005, 1e-5))
    feature_lr: float = 0.005
    opacity_lr: float = 0.02
    scaling_lr: float = 0.007
    rotation_lr: float = 0.002
    mlp_opacity_lr: LrSchedule = field(default_factory=lambda: LrSchedule(0.002, 2e-4))
    mlp_cov_lr: LrSchedule = field(default_factory=lambda: LrSchedule(0.004, 4e-4))
    mlp_color_lr: LrSchedule = field(default_factory=lambda: LrSchedule(0.008, 5e-5))
    mlp_raydrop_lr: LrSchedule = field(default_factory=lambda: LrSchedule(0.008, 5e-5))
    mlp_featurebank_lr: LrSchedule = field(default_factory=lambda: LrSchedule(0.001, 1e-5))
    appearance_lr: LrSchedule = field(default_factory=lambda: LrSchedule(0.05, 5e-5))
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    raydrop_lambda: float = 10.0            # 10 waymo / 1 kitti
    scale_reg: float = 0.01
    grad_clip_x: float = 0.01
    # densification
    start_stat: int = 500
    update_from: int = 500
    update_interval: int = 100
    update_until: int = 7000
    min_opacity: float = 0.005
    success_threshold: float = 0.1
    densify_grad_threshold: float = 5e-4
    depth_max: float = 80.0
    depth_min: float = 5.0                  # kitti 1 / waymo 5
    adam_eps: float = 1e-15
    # surfel (2DGS) regularizers: the weights of the distortion and
    # normal-consistency terms and the steps from which each counts
    dist_lambda: float = 100.0
    normal_lambda: float = 0.05
    dist_from: int = 1000
    normal_from: int = 2000
    # keep the prune pass's cov log-scale clamp (min(scaling, 0.05) on the
    # cov columns) running at the update_interval cadence after
    # update_until: with a static per-tile budget, unclamped cov scales let
    # bloated near gaussians take every tile's nearest-K slots
    scale_clamp_after_until: bool = True
    # capacity-pressure regularizer: when instances overflow the per-tile
    # budget, push the decoded set's positive opacities down in proportion
    # to the overflow (off by default)
    overflow_lambda: float = 0.0
