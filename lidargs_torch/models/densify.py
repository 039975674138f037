"""Anchor densification: gradient-driven growing and opacity pruning.

Counterpart of `lidargs_tpu/models/densify.py`. Every array keeps its
static capacity and liveness is the `valid` mask:

  * growing writes new anchors into free (invalid) rows and zeroes their
    Adam moments and statistics;
  * duplicate cells are found by one stable lexicographic sort of
    [existing ++ selected] grid coordinates (coords, then existing before
    selected): a selected cell is kept iff its sorted predecessor has other
    coordinates, which both dedups the selected cells and rejects cells an
    anchor already holds. The sort is a chain of stable sorts from the least
    significant key up, which gives the same order as the JAX package's
    four-key `lax.sort`;
  * the candidate features of a cell are max-reduced over its sorted run
    (`scatter_reduce("amax")`);
  * pruning zeroes rows and clears `valid` instead of compacting.

Semantics as in the JAX package: 3 hierarchy levels with 2^i-scaled
thresholds and a 1 - 0.5^(i+1) random keep, voxel sizes voxel*16/4/1, the
new-anchor init (log(cur_size) scales, identity rotation,
opacity = inverse_sigmoid(0.9), zero offsets), the statistics resets and
the log-scale clamp at 0.05 on prune. The random keep draws come from a
`torch.Generator`, or are passed in (`draws`) so that a test can feed the
JAX package's own.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple, Optional

import torch

from ..config import ModelConfig, OptConfig

if TYPE_CHECKING:                      # train.trainer imports models.field
    from ..train.trainer import TrainState

_COORD_SENTINEL_SEL = 2 ** 30
_COORD_SENTINEL_EXIST = 2 ** 30 - 7
_GROWN = ("anchor", "scaling", "rotation", "opacity", "feat", "offset")


class DensifyStats(NamedTuple):
    n_grown: torch.Tensor
    n_pruned: torch.Tensor
    n_capacity_dropped: torch.Tensor


def _set_rows(x: torch.Tensor, rows: torch.Tensor, values) -> torch.Tensor:
    """A copy of `x` with `x[rows] = values` (rows are distinct)."""
    y = x.clone()
    y[rows] = values
    return y


def _grow_level(state: TrainState, level: int, grads: torch.Tensor,
                offset_mask: torch.Tensor, draw: torch.Tensor,
                mcfg: ModelConfig, ocfg: OptConfig, voxel_size: float):
    """One hierarchy level of growing: (TrainState, n_grown, n_dropped).
    `draw` [C*k] holds the level's uniform keep draws."""
    params = state.params
    valid = state.valid
    dev = valid.device
    i32 = torch.int32
    C = params["anchor"].shape[0]
    k = mcfg.n_offsets
    # the compaction below yields at most C*k candidate rows
    S = min(mcfg.grow_src_cap, mcfg.anchor_capacity * k)
    G = mcfg.grow_cap_per_level

    cur_threshold = ocfg.densify_grad_threshold * ((mcfg.update_hierachy_factor // 2) ** level)
    cand = (grads >= cur_threshold) & offset_mask
    keep_p = 1.0 - 0.5 ** (level + 1)
    cand = cand & (draw > (1.0 - keep_p))
    cand = cand & valid.repeat_interleave(k)

    size_factor = mcfg.update_init_factor // (mcfg.update_hierachy_factor ** level)
    cur_size = voxel_size * size_factor

    # candidate positions = decoded gaussian centers (anchor + offset*scale)
    scaling = torch.exp(params["scaling"][:, :3])
    xyz = (params["anchor"].repeat_interleave(k, 0)
           + params["offset"].reshape(C * k, 3) * scaling.repeat_interleave(k, 0))

    # compact the candidates to S rows, in row order
    order = torch.sort((~cand).to(i32), stable=True).indices[:S]
    sel_ok = cand[order]
    sel_xyz = xyz[order]
    sel_feat = params["feat"].repeat_interleave(k, 0)[order]
    n_dropped_src = cand.sum() - sel_ok.sum()

    sel_coords = torch.round(sel_xyz / cur_size).to(i32)
    sel_coords = torch.where(sel_ok[:, None], sel_coords, _COORD_SENTINEL_SEL)
    exist_coords = torch.round(params["anchor"] / cur_size).to(i32)
    exist_coords = torch.where(valid[:, None], exist_coords, _COORD_SENTINEL_EXIST)

    # merged stable sort on (c1, c2, c3, tag): existing first within a cell
    coords = torch.cat([exist_coords, sel_coords], 0)                 # [C+S,3]
    tag = torch.cat([torch.zeros(C, dtype=i32, device=dev), torch.ones(S, dtype=i32, device=dev)])
    row = torch.cat([torch.full((C,), S, dtype=i32, device=dev),
                     torch.arange(S, dtype=i32, device=dev)])
    perm = torch.arange(C + S, device=dev)
    for key in (tag, coords[:, 2], coords[:, 1], coords[:, 0]):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    c1, c2, c3 = coords[perm].unbind(-1)
    tag_s, row_s = tag[perm], row[perm]
    same_prev = ((c1 == torch.roll(c1, 1)) & (c2 == torch.roll(c2, 1))
                 & (c3 == torch.roll(c3, 1)))
    same_prev[0] = False
    is_sel = tag_s == 1
    keep = is_sel & ~same_prev & (c1 != _COORD_SENTINEL_SEL)          # new cells

    # segment ids over coordinate runs -> max of the candidate features
    seg_id = torch.cumsum((~same_prev).to(i32), 0) - 1                 # [C+S]
    Fd = sel_feat.shape[1]
    neg_inf = torch.tensor(float("-inf"), device=dev)
    feat_sorted = torch.where(is_sel[:, None], sel_feat[row_s.clamp_max(S - 1)], neg_inf)
    seg_feat = torch.full((C + S, Fd), float("-inf"), device=dev).scatter_reduce(
        0, seg_id[:, None].to(torch.int64).expand(-1, Fd), feat_sorted, "amax",
        include_self=False)
    new_feat_sorted = seg_feat[seg_id]                                # [C+S,F]

    # free rows for the kept cells (the first G invalid rows, padded with C)
    rank = torch.cumsum(keep.to(i32), 0) - 1
    free = torch.nonzero(~valid).flatten()[:G]
    free_rows = torch.full((G,), C, dtype=free.dtype, device=dev)
    free_rows[:free.shape[0]] = free
    slot = torch.where(keep & (rank < G), free_rows[rank.clamp(0, G - 1)], C)
    n_grown = (slot < C).sum()
    n_cap_dropped = keep.sum() - n_grown + n_dropped_src

    # write only the rows with a slot (the JAX package's mode="drop")
    wr = slot < C
    dst = slot[wr]
    n = dst.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    new_anchor = torch.stack([c1, c2, c3], -1)[wr].to(torch.float32) * cur_size
    log_size = torch.log(torch.tensor(cur_size, **f32))
    inv_sig_09 = torch.log(torch.tensor(0.9 / 0.1, **f32))
    values = {
        "anchor": new_anchor,
        "scaling": log_size.expand(n, 6),
        "rotation": torch.tensor([1.0, 0.0, 0.0, 0.0], **f32).expand(n, 4),
        "opacity": inv_sig_09.expand(n, 1),
        "feat": new_feat_sorted[wr].clamp_min(-1e30),
        "offset": torch.zeros((n, k, 3), **f32),
    }
    p = dict(params)
    mu, nu = dict(state.opt.mu), dict(state.opt.nu)
    for name in _GROWN:
        p[name] = _set_rows(params[name], dst, values[name])
        # zero Adam moments of the new rows
        mu[name] = _set_rows(mu[name], dst, 0.0)
        nu[name] = _set_rows(nu[name], dst, 0.0)

    # zero statistics of the new rows
    off_dst = (dst[:, None] * k + torch.arange(k, device=dev)[None, :]).reshape(-1)
    new_state = state._replace(
        params=p,
        opt=state.opt._replace(mu=mu, nu=nu),
        valid=_set_rows(valid, dst, True),
        opacity_accum=_set_rows(state.opacity_accum, dst, 0.0),
        anchor_demon=_set_rows(state.anchor_demon, dst, 0.0),
        offset_grad_accum=_set_rows(state.offset_grad_accum, off_dst, 0.0),
        offset_denom=_set_rows(state.offset_denom, off_dst, 0.0),
    )
    return new_state, n_grown, n_cap_dropped


@torch.no_grad()
def densify_step(state: TrainState, mcfg: ModelConfig, ocfg: OptConfig,
                 voxel_size: float, check_interval: int = 100,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[torch.Tensor] = None):
    """Grow over `update_depth` hierarchy levels, reset the statistics and
    prune low-opacity anchors: (TrainState, DensifyStats). The keep draws
    are `draws` [update_depth, C*k] uniforms in [0, 1) when given, else
    drawn from `generator`."""
    C = state.params["anchor"].shape[0]
    k = mcfg.n_offsets
    dev = state.valid.device
    if draws is None:
        if generator is None:
            raise ValueError("densify_step needs a generator or the draws")
        draws = torch.rand((mcfg.update_depth, C * k), generator=generator,
                           device=generator.device)
    draws = draws.to(dev)

    grads = state.offset_grad_accum / state.offset_denom.clamp_min(1e-20)
    grads = torch.where(state.offset_denom > 0, grads, 0.0)
    offset_mask = state.offset_denom > check_interval * ocfg.success_threshold

    st = state
    total_grown = torch.zeros((), dtype=torch.int64, device=dev)
    total_dropped = torch.zeros((), dtype=torch.int64, device=dev)
    for level in range(mcfg.update_depth):
        st, n_grown, n_drop = _grow_level(st, level, grads, offset_mask, draws[level],
                                          mcfg, ocfg, voxel_size)
        total_grown = total_grown + n_grown
        total_dropped = total_dropped + n_drop

    # --- statistics reset for offsets that passed the success threshold ---
    offset_grad_accum = torch.where(offset_mask, 0.0, st.offset_grad_accum)
    offset_denom = torch.where(offset_mask, 0.0, st.offset_denom)

    # --- prune ---
    visited = st.anchor_demon > check_interval * ocfg.success_threshold
    prune = st.valid & visited & (st.opacity_accum < ocfg.min_opacity * st.anchor_demon)
    new_valid = st.valid & ~prune

    # reset statistics of well-visited survivors; clear pruned rows entirely
    opacity_accum = torch.where(visited | prune, 0.0, st.opacity_accum)
    anchor_demon = torch.where(visited | prune, 0.0, st.anchor_demon)
    prune_off = prune.repeat_interleave(k)
    offset_grad_accum = torch.where(prune_off, 0.0, offset_grad_accum)
    offset_denom = torch.where(prune_off, 0.0, offset_denom)

    # zero params and moments of pruned rows (keeps the padded-row invariants)
    p = dict(st.params)
    mu, nu = dict(st.opt.mu), dict(st.opt.nu)
    for name in _GROWN:
        m = prune.reshape((-1,) + (1,) * (p[name].dim() - 1))
        p[name] = torch.where(m, 0.0, p[name])
        mu[name] = torch.where(m, 0.0, mu[name])
        nu[name] = torch.where(m, 0.0, nu[name])
    # the log-scale clamp on prune
    p["scaling"] = torch.cat([p["scaling"][:, :3], p["scaling"][:, 3:].clamp_max(0.05)], 1)

    new_state = st._replace(
        params=p,
        opt=st.opt._replace(mu=mu, nu=nu),
        valid=new_valid,
        opacity_accum=opacity_accum,
        anchor_demon=anchor_demon,
        offset_grad_accum=offset_grad_accum,
        offset_denom=offset_denom,
    )
    stats = DensifyStats(n_grown=total_grown, n_pruned=prune.sum(),
                         n_capacity_dropped=total_dropped)
    return new_state, stats
