"""Speed of light on the NVIDIA H100: of each render stage, and of each of
the port's kernels on the inputs it was given.

The H100's peaks (the SXM part's data sheet, at its 700 W power limit):

  * bytes moved / 3.35 TB/s (HBM3);
  * operations / 67 TFLOP/s (float32 outside the tensor cores).

The port keeps its products in full float32 (TF32 is off,
`lidargs_torch/__init__.py`), so every operation counts at the float32
rate. A speed of light is the larger of the two times, and which of them
it is says what bounds the work (`bound`).

The stages (`build_stages`) are the JAX round's `tools/roofline.py`: the
same bytes and operations for each stage, counted from the shapes alone;
its element-wise operations (`vpu`) and its decode GEMMs (`mxu`) both count
at the float32 rate. Sorts count one pass over their keys, as in the JAX
round: the printed multiple shows a sort's passes instead of hiding them
in a generous bound. The composite stage keeps the JAX round's coarse
count (every kept instance against every pixel of its tile, no credit for
the walk's early exit).

The kernels' finer bounds count the work of one call's inputs: the
pixel-instance pairs of the composites' walk (`walked_pairs`,
`walked_surfel_pairs`) at the operations a pair (`OPS_*`), the rows read
(`tile_bytes`), and the point pairs of the nearest-neighbour kernels
(`knn_bound`).

`main` prints the table; with `--stage-split <json>` (the output of
`python -m lidargs_torch.utils.stage_split --prefix --json ...`) it groups
the stages into the prefix deltas that the split measured and prints each
measured delta beside its speed of light, as a multiple:

    python -m lidargs_torch.utils.roofline [--tile_h 4 --tile_capacity 768]
        [--visible 131072] [--instances 1350000] [--stage-split stages.json]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.composite_kernel import FWD_CHUNK, warp_row_mask
from ..ops.projection import PackedCols
from ..ops.surfel import SurfelCols, pair_geometry

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM float32, CUDA cores

# FP32 operations per pixel-instance pair of the beam composites K1-K4
OPS_IN_RECT = 35               # per pixel-instance pair inside the parity rect
OPS_OUT_RECT = 4               # the rect test alone
OPS_APPLIED_BWD = 80           # K2 per applied pair: the forward recompute and the backward
#                                chain, plus one add per gradient column (14 + C) for the
#                                reduction; K2's other in-rect pairs cost the forward's count
# FP32 operations per pixel-surfel pair, counted from csrc/surfel_common.cuh
# and the kernels' loops (each add, multiply, divide, sqrt, compare or
# select one; expf one):
OPS_S_OUT_RECT = 5             # the valid flag and the four rect compares
OPS_S_IN_RECT = 85             # those, surfel_pair (five 3-dot products, two divides,
#                                the rho2d form, the selects), surfel_alpha, the tests
#                                and the transmittance step
OPS_S_FWD_APPLIED = 28         # + 2 C: K5's accumulators (w, features, depth, normal,
#                                the distortion map and term, M1, M2, the median)
OPS_S_BWD_APPLIED = 288        # + 4 C: K6 per applied pair: the replayed pair (85), the
#                                chain (188 + 3 C) and one add per gradient column
#                                (15 + C) for the reduction
# FP32 operations per point pair of the nearest-neighbour kernels N1-N3
# (csrc/knn.cu; each add, multiply, compare or select one): the Gram value
# |p|^2 - 2 q.p is three multiplies and three adds (the -2 scales the staged
# point once, not per pair), the direct one three subtracts, three
# multiplies and two adds; one compare against the minimum or the k-th
# smallest. The sorted insertion after a compare that wins is left out: it
# runs O(k log N) times a row, not once a pair.
OPS_GRAM_PAIR = 7
OPS_DIRECT_PAIR = 9
# per gaussian: the decode's element-wise operations and the projection
# (F1 and the stages count both; F1's and F2's prefilter projects each anchor
# once), and the surfel preprocess (F2: the rotation 45, the axes and centre
# 60, the normal 40, the projected extent 90, the rect 65)
OPS_DECODE_ELEMENTWISE = 60
OPS_PROJECT = 160
OPS_SURFEL_PROJECT = 300

# (delta name, prefix key of utils/stage_split.py, stages of build_stages):
# the prefix split's deltas in pipeline order, each with the stages it holds
PREFIX_GROUPS = (
    ("prefilter", "prefix prefilter", ()),
    ("decode", "prefix decode", (0,)),
    ("project+pack", "prefix project+pack", (1,)),
    ("cull sort", "prefix cull sort", (2, 3)),
    ("bin sort", "prefix bin sort", (4,)),
    ("gather", "prefix gather", (5,)),
    ("composite", "full_frame", (6,)),
)


def fmt_us(s: float) -> str:
    return f"{s * 1e6:8.1f} us"


def _times(n_bytes, n_ops) -> tuple:
    """(seconds at the HBM peak, seconds at the float32 peak, the larger,
    "bytes" or "operations": which of them it is)."""
    t_mem, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return t_mem, t_ops, max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"


def stage(name, bytes_moved=0.0, vpu_ops=0.0, mxu_flops=0.0, note=""):
    """One stage's counts and speed of light (seconds), and which of bytes
    and operations bounds it."""
    *_, sol_s, by = _times(bytes_moved, vpu_ops + mxu_flops)
    return dict(name=name, bytes=bytes_moved, vpu=vpu_ops, mxu=mxu_flops,
                ops=vpu_ops + mxu_flops, sol_s=sol_s, bound=by, note=note)


def bound(n_bytes: int, n_ops: int) -> dict:
    """The least time the card could take for a function that must move
    `n_bytes` and do `n_ops` FP32 operations: the larger of the two times
    at the card's peak rates, in ms."""
    tb, to, t, by = _times(n_bytes, n_ops)
    return {"bytes": n_bytes, "bytes_ms": tb * 1e3, "ops": n_ops, "ops_ms": to * 1e3,
            "bound_ms": t * 1e3, "bound_by": by}


def knn_bound(kernel: str, n_q: int, n_p: int, pairs: int, kk: int = 1) -> dict:
    """The bound of a nearest-neighbour kernel on `n_q` query rows and `n_p`
    point rows that compares `pairs` point pairs (the valid ones for N1):
    each input read once, each output written once (N1: both sets [N, 3]
    float32 and their bool masks, [n_q] out; N2: both sets, [n_q, kk] out;
    N3: one set of n_q = n_p points, [n_q] out), against `pairs` times the
    operations a pair."""
    if kernel == "N1":
        n_bytes, ops = 13 * (n_q + n_p) + 4 * n_q, OPS_GRAM_PAIR
    elif kernel == "N2":
        n_bytes, ops = 12 * (n_q + n_p) + 4 * n_q * kk, OPS_GRAM_PAIR
    elif kernel == "N3":
        n_bytes, ops = 16 * n_q, OPS_DIRECT_PAIR
    else:
        raise ValueError(f"unknown kernel {kernel}")
    return {**bound(n_bytes, ops * pairs), "pairs": pairs, "ops_per_pair": ops}


def tile_bytes(counts, rows_walked: int, cols: int, pix, *elements: int) -> int:
    """Bytes a composite function over tiles must move: `cols` columns (the
    ones the function reads) of the `rows_walked` rows of the tiles' lists
    that some pixel's walk reaches, the counts, the five rows of each pixel
    block it reads (direction, column, row), and `elements` more f32
    elements (the rows read of other inputs, the output written)."""
    T, _, npix = pix.shape
    return 4 * (rows_walked * cols + counts.numel() + T * 5 * npix + sum(elements))


def warp_rows(pairs) -> int:
    """(tile, warp of 32 pixels, row) triples in which some lane's pair is
    set, of an [tiles, rows, NPIX] mask of pairs (the kernels' warps are 32
    consecutive pixels of a tile, the last one padded). Of the applied
    pairs: the row reductions a backward kernel runs; of the visited pairs:
    the rows a warp walks; of the visited pairs inside the rect: those in
    which a lane does more than the rect test."""
    g, K, npix = pairs.shape
    lanes = torch.nn.functional.pad(pairs.to(torch.uint8), (0, -npix % 32))
    return int(lanes.view(g, K, -1, 32).amax(-1).sum())


def masked_warp_rows(mask, visited) -> int:
    """(tile, warp, row) visits of the forward kernels' masked walk: the
    rows of an [tiles, rows, n_warps] `warp_row_mask` in each chunk of
    FWD_CHUNK rows that the warp walks, which it does unless all its lanes
    are done when the chunk lands, i.e. iff one of its lanes visits the
    chunk's first row ([tiles, rows, NPIX] `visited`)."""
    g, K, npix = visited.shape
    lanes = torch.nn.functional.pad(visited.to(torch.uint8), (0, -npix % 32))
    walks = lanes.view(g, K, -1, 32).amax(-1)[:, ::FWD_CHUNK]         # [g, chunks, n_warps]
    walks = walks.repeat_interleave(FWD_CHUNK, dim=1)[:, :K].bool()
    return int((mask & walks).sum())


def walked_pairs(inst, counts, pix, C: int, cfg, group: int = 16):
    """Pixel-instance pairs that K1's sequential walk visits on these inputs
    (each pixel's live rows up to and including its first transmittance
    crossing), as (applied, other in rect, out of rect, rows, reducing warp
    rows, warp rows visited, warp rows visited in rect, warp rows of the
    masked walk): the pairs that pass and are blended (K2 runs its backward
    chain and reduction on these alone), the other pairs inside the
    instance's parity rect (the alpha arithmetic, then a failed test or the
    crossing), the pairs outside it (the rect test alone), the rows of the
    tiles' lists that some pixel visits (the rows the function must read),
    the `warp_rows` of the applied pairs (K2's row reductions), of the
    visited pairs (what a warp walks when it visits every row, as K2 does)
    and of the visited pairs inside the rect, and the visits of K1's masked
    walk (`masked_warp_rows`): at least the last, as it also counts the
    masked rows of a chunk after the warp's last lane has stopped."""
    T, K, _ = inst.shape
    rc = PackedCols.rect(C).start
    k = torch.arange(K, device=inst.device)[None, :, None]
    n_app = n_in = n_out = n_rows = n_warp = n_wvis = n_wrect = n_wmask = 0
    for t0 in range(0, T, group):
        r = inst[t0:t0 + group]
        col = lambda i: r[:, :, i, None]                            # [g,K,1]
        dirx, diry, dirz, px, py = (pix[t0:t0 + group, i, None, :] for i in range(5))
        live = k < counts[t0:t0 + group, None, None]
        in_rect = (live & (px >= col(rc)) & (px < col(rc + 1))
                   & (py >= col(rc + 2)) & (py < col(rc + 3)))
        dx, dy, dz = col(0) - dirx, col(1) - diry, col(2) - dirz
        ddx = dx * col(3) + dy * col(4) + dz * col(5)
        ddy = dx * col(6) + dy * col(7) + dz * col(8)
        power = -0.5 * (col(9) * ddx * ddx + col(11) * ddy * ddy) - col(10) * ddx * ddy
        alpha = (col(PackedCols.OPACITY) * torch.exp(power)).clamp_max(cfg.alpha_clamp)
        passed = in_rect & (power <= 0.0) & (alpha >= cfg.alpha_min)
        t_incl = torch.cumprod(torch.where(passed, 1.0 - alpha, 1.0), dim=1)
        cross = (passed & (t_incl < cfg.transmittance_min)).to(torch.int32)
        visited = live & ((torch.cumsum(cross, 1) - cross) == 0)
        applied = visited & passed & (cross == 0)
        n_app += int(applied.sum())
        n_in += int((visited & in_rect).sum())
        n_out += int((visited & ~in_rect).sum())
        n_rows += int(visited.any(dim=2).sum())
        n_warp += warp_rows(applied)
        n_wvis += warp_rows(visited)
        n_wrect += warp_rows(visited & in_rect)
        mask = warp_row_mask(r, counts[t0:t0 + group], pix[t0:t0 + group], rc)
        n_wmask += masked_warp_rows(mask, visited)
    return n_app, n_in - n_app, n_out, n_rows, n_warp, n_wvis, n_wrect, n_wmask


def walked_surfel_pairs(inst, counts, pix, C: int, cfg, group: int = 16):
    """Pixel-surfel pairs that K5's sequential walk visits on these inputs
    (each pixel's live rows up to and including its first transmittance
    crossing), as (applied, other past the valid and rect tests, stopped by
    them, rows, reducing warp rows, warp rows visited, warp rows visited
    past the valid and rect tests, warp rows of the masked walk): the pairs
    blended (K5's accumulators and K6's chain run on these alone), the
    other pairs that reach the pair geometry, the pairs that cost the cheap
    tests alone, the rows of the tiles' lists that some pixel visits, the
    `warp_rows` of the applied pairs (K6's row reductions), of the visited
    pairs and of the visited pairs past the cheap tests, and the visits of
    K5's masked walk (`masked_warp_rows`; its mask folds the valid flag in)."""
    T, K, _ = inst.shape
    rc, vf = SurfelCols.rect(C).start, SurfelCols.validf(C)
    k = torch.arange(K, device=inst.device)[None, :, None]
    n_app = n_in = n_out = n_rows = n_warp = n_wvis = n_wrect = n_wmask = 0
    for t0 in range(0, T, group):
        r = inst[t0:t0 + group]
        col = lambda i: r[:, :, i, None]                            # [g,K,1]
        dirx, diry, dirz, px, py = (pix[t0:t0 + group, i, None, :] for i in range(5))
        live = k < counts[t0:t0 + group, None, None]
        cheap = (live & (col(vf) > 0.0) & (px >= col(rc)) & (px < col(rc + 1))
                 & (py >= col(rc + 2)) & (py < col(rc + 3)))
        g = pair_geometry(r, dirx, diry, dirz, px, py, C, cfg)
        passed = live & g.passed
        t_incl = torch.cumprod(torch.where(passed, 1.0 - g.alpha, 1.0), dim=1)
        cross = (passed & (t_incl < cfg.transmittance_min)).to(torch.int32)
        visited = live & ((torch.cumsum(cross, 1) - cross) == 0)
        applied = visited & passed & (cross == 0)
        n_app += int(applied.sum())
        n_in += int((visited & cheap).sum())
        n_out += int((visited & ~cheap).sum())
        n_rows += int(visited.any(dim=2).sum())
        n_warp += warp_rows(applied)
        n_wvis += warp_rows(visited)
        n_wrect += warp_rows(visited & cheap)
        mask = warp_row_mask(r, counts[t0:t0 + group], pix[t0:t0 + group], rc, vf)
        n_wmask += masked_warp_rows(mask, visited)
    return n_app, n_in - n_app, n_out, n_rows, n_warp, n_wvis, n_wrect, n_wmask


def build_stages(args):
    """The stages at the shapes in `args` (the fields of `main`'s flags):
    (list of `stage` rows, number of tiles)."""
    H, W = args.H, args.W
    tiles = -(-H // args.tile_h) * -(-W // args.tile_w)
    K = args.tile_capacity
    V = args.visible                 # gaussians surviving cull+compact
    E = args.instances               # emitted (tile, gaussian) instances
    C = args.anchors                 # anchor rows decoded (capacity-padded)
    k = args.n_offsets
    F = args.packed_floats           # packed splat row width
    fd, hid = args.feat_dim, args.mlp_hidden
    npix = args.tile_h * args.tile_w

    st = []

    # MLP decode: the four heads' two products over C anchors
    d_in = fd + 3 + 1
    outs = k * (1 + 1 + 1 + 7)       # opacity, intensity, raydrop, scale+rot
    gemm_flops = 2.0 * C * (d_in * (4 * hid) + hid * outs)
    decode_bytes = C * (fd + outs + 4 * hid) * 4.0
    st.append(stage("mlp decode (4 heads, 2 GEMMs)", decode_bytes,
                    vpu_ops=C * k * float(OPS_DECODE_ELEMENTWISE), mxu_flops=gemm_flops,
                    note=f"C={C} k={k}"))

    # projection/preprocess: C*k rows -> packed [V, F]
    st.append(stage("projection + pack", (C * k * 16 + C * k * F) * 4.0,
                    vpu_ops=C * k * float(OPS_PROJECT)))

    # cull sort: C*k keys, one-pass data touch
    st.append(stage("cull+compact sort (C*k keys)", 2 * (C * k) * 8.0,
                    note="one-pass touch; the sort takes several"))

    # gather compacted rows [V, F]
    st.append(stage("visible compaction gather", 2 * V * F * 4.0))

    # binning: instance keys (E keys) + sort
    st.append(stage("instance emission + bin sort (E keys)",
                    2 * E * 8.0 + E * 8.0,
                    note=f"E={E} ({E / max(V, 1):.1f}/gaussian); one-pass"))

    # instance gather -> [T, K, F] (materialized path only)
    mat_bytes = tiles * K * F * 4.0 + E * F * 4.0
    st.append(stage("instance gather [T,K,F] (materialized)", mat_bytes,
                    note="fused_gather skips this write"))

    # composite: every kept instance against npix lanes, ~40 f32 ops each
    kept = min(E, tiles * K)
    st.append(stage("composite (K1)",
                    tiles * K * F * 4.0 + tiles * 8 * npix * 4.0,
                    vpu_ops=kept * npix * 40.0,
                    note=f"kept={kept}, no early-exit credit"))

    return st, tiles


def bench_stages(visible=131072, instances=None, tile_h=1,
                 tile_capacity=384, max_tiles_per_gaussian=16,
                 max_visible=131072, H=64, W=2650):
    """The stages at the bench scene's shapes for a raster config.
    `visible` is the decoded gaussians that survive the cull (capped by
    max_visible). The bin sort handles V * max_tiles_per_gaussian static
    key slots, so the instances default to that (the emission is not
    compacted)."""
    V = min(visible, max_visible)
    if instances is None:
        instances = V * max_tiles_per_gaussian
    ns = argparse.Namespace(
        H=H, W=W, tile_h=tile_h, tile_w=128, tile_capacity=tile_capacity,
        anchors=65536, n_offsets=6, feat_dim=32, mlp_hidden=32,
        packed_floats=22, visible=V, instances=instances,
    )
    return build_stages(ns)[0]


def bench_sol_ms(visible=131072, instances=None, **kw) -> float:
    """The sum of the stages' speeds of light in ms at the bench shapes."""
    st = bench_stages(visible=visible, instances=instances, **kw)
    return sum(s["sol_s"] for s in st) * 1e3


def _ms(x):
    """A measured time in ms, or None where the split has none (a CPU
    rehearsal writes "not measured")."""
    return float(x) if isinstance(x, (int, float)) else None


def prefix_table(stages: list, measured: dict, device_ms: dict | None = None) -> list:
    """The prefix split's deltas (PREFIX_GROUPS) against their stages' summed
    speed of light: one dict a delta with the measured ms (`measured`,
    `{prefix key: ms}` as `stage_split` writes it), the device ms delta
    (`device_ms`, the same keys), the SoL in ms, the bound of its costliest
    stage and the multiple. A delta whose prefixes were not measured has
    None there."""
    rows, prev, prev_dev = [], 0.0, 0.0
    device_ms = device_ms or {}
    for name, key, idx in PREFIX_GROUPS:
        t, d = _ms(measured.get(key)), _ms(device_ms.get(key))
        sol = sum(stages[i]["sol_s"] for i in idx) * 1e3
        top = max((stages[i] for i in idx), key=lambda s: s["sol_s"], default=None)
        delta = None if t is None or prev is None else t - prev
        ddelta = None if d is None or prev_dev is None else d - prev_dev
        rows.append({"stage": name, "ms": delta, "device_ms": ddelta,
                     "sol_ms": sol if idx else None,
                     "bound": top["bound"] if top else None,
                     "x_sol": delta / sol if idx and delta is not None else None})
        prev, prev_dev = t, d
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--H", type=int, default=64)
    ap.add_argument("--W", type=int, default=2650)
    ap.add_argument("--tile_h", type=int, default=1)
    ap.add_argument("--tile_w", type=int, default=128)
    ap.add_argument("--tile_capacity", type=int, default=384)
    ap.add_argument("--anchors", type=int, default=65536)
    ap.add_argument("--n_offsets", type=int, default=6)
    ap.add_argument("--feat_dim", type=int, default=32)
    ap.add_argument("--mlp_hidden", type=int, default=32)
    ap.add_argument("--packed_floats", type=int, default=22)
    ap.add_argument("--visible", type=int, default=131072)
    ap.add_argument("--instances", type=int, default=1_350_000)
    ap.add_argument("--stage-split", default=None,
                    help="json of `python -m lidargs_torch.utils.stage_split --json`")
    args = ap.parse_args(argv)

    st, tiles = build_stages(args)
    total = sum(s["sol_s"] for s in st)
    print(f"# {args.H}x{args.W}, {tiles} tiles, K={args.tile_capacity}, V={args.visible}, "
          f"E={args.instances}; H100 peaks {HBM_BYTES_PER_S:.3g} B/s, "
          f"{FP32_OPS_PER_S:.3g} FP32 op/s")
    print(f"{'stage':42s} {'SoL':>12s} {'bound':>10s}  note")
    for s in st:
        print(f"{s['name']:42s} {fmt_us(s['sol_s'])} {s['bound']:>10s}  {s['note']}")
    print(f"{'TOTAL (sum of stage SoLs)':42s} {fmt_us(total)}")
    if not args.stage_split:
        return
    with open(args.stage_split) as f:
        measured = json.load(f)
    print(f"# measured: {measured.get('card', 'card not named')}")
    print(f"{'prefix delta':14s} {'ms':>9s} {'device ms':>10s} {'SoL ms':>9s} "
          f"{'bound':>10s} {'x SoL':>8s}")
    num = lambda x, w, p: f"{x:{w}.{p}f}" if x is not None else f"{'-':>{w}s}"
    for r in prefix_table(st, measured, measured.get("device_ms")):
        print(f"{r['stage']:14s} {num(r['ms'], 9, 3)} {num(r['device_ms'], 10, 3)} "
              f"{num(r['sol_ms'], 9, 4)} {r['bound'] or '-':>10s} {num(r['x_sol'], 8, 1)}")


if __name__ == "__main__":
    main(sys.argv[1:])
