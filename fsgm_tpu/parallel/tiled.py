"""Multi-device tiled stereo SGM — spatial row tiling + frame parallelism.

This is the framework's distribution layer (SURVEY.md §2.2/§3.5; the
reference is single-process with no distribution, so this subsystem is
new here):

  * mesh axis "frame": data parallelism over independent stereo pairs
    (spans hosts in a multi-host run);
  * mesh axis "ty": the image rows are sharded across devices — the
    sequence/context-parallel analog.  Census uses a small row halo; the
    cost volume, horizontal aggregation paths, and all extraction ops are
    row-local; only the vertical/diagonal path families cross tiles.
  * mesh axis "tx" (optional): column tiling via margin windows — each
    tile computes on an x-extended window (margin + D + census radius per
    side) sliced from the all-gathered row band, then crops; bit-exact at
    the auto margin by the SGM forgetting bound (_stereo_tile_tx).

Cross-tile SGM path state is the canonical scan carry of
`ops.aggregate.aggregate_one_path`: the last two L rows, shape (2, W, D)
int32, exchanged with `lax.ppermute` between neighbouring tiles.  Two
modes (SURVEY.md §7.3 item 1):

  * "exact"  — bit-true wavefront.  Downward and upward path families
    stream in OPPOSITE tile orders simultaneously (device k is active for
    the down path at step k and for the up path at step T-1-k), so the
    wavefront bubble of one family overlaps the other's.
  * "fast"   — two-pass margin re-injection.  Pass 1 aggregates every tile
    in parallel from the neutral (zero) carry; the resulting boundary carry
    is ppermuted one hop downstream and pass 2 re-aggregates only the first
    `margin` canonical rows of each tile.  Exact up to SGM's exponential
    forgetting length ~ (Cmax + P2) / P1 rows; near-linear scaling.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from fsgm_tpu.params import SGMParams, DistParams, forgetting_margin
from fsgm_tpu.ops.census import census_transform
from fsgm_tpu.ops.cost import cost_volume_stereo, cost_volume_stereo_right
from fsgm_tpu.ops import aggregate as agg
from fsgm_tpu.ops import extract as ext


# --------------------------------------------------------------------------
# Neighbor exchange helpers (non-wrapping shifts over the "ty" axis)
# --------------------------------------------------------------------------

def _send_down(x, axis: str, t: int):
    """Device k receives device k-1's value (device 0 receives zeros)."""
    _count_halo("down", x)
    return jax.lax.ppermute(x, axis, [(i, i + 1) for i in range(t - 1)])


def _send_up(x, axis: str, t: int):
    """Device k receives device k+1's value (device t-1 receives zeros)."""
    _count_halo("up", x)
    return jax.lax.ppermute(x, axis, [(i + 1, i) for i in range(t - 1)])


def _exchange_row_halo(field: jnp.ndarray, halo: int, axis: str, t: int):
    """Extend a row-tiled (Ht, ...) array with `halo` true neighbor rows on
    each side; global top/bottom use edge replication (matches the golden
    model's pad semantics)."""
    my = jax.lax.axis_index(axis)
    from_above = _send_down(field[-halo:], axis, t)
    from_below = _send_up(field[:halo], axis, t)
    top_rep = jnp.repeat(field[:1], halo, axis=0)
    bot_rep = jnp.repeat(field[-1:], halo, axis=0)
    above = jnp.where(my == 0, top_rep, from_above)
    below = jnp.where(my == t - 1, bot_rep, from_below)
    return jnp.concatenate([above, field, below], axis=0)


# --------------------------------------------------------------------------
# Tiled aggregation
# --------------------------------------------------------------------------

def _split_dirs(dirs: Sequence[Tuple[int, int]]):
    horiz = [r for r in dirs if r[0] == 0]
    down = [r for r in dirs if r[0] > 0]
    up = [r for r in dirs if r[0] < 0]
    assert len(down) == len(up), "direction set must be y-symmetric"
    return horiz, down, up


# Test instrumentation: when set, called as f(tag: str, rows: int) from
# INSIDE the active wavefront branch via jax.debug.callback — so invocations
# count sweeps that actually executed at runtime, proving the lax.cond
# schedule skips inactive tiles instead of masking redundant recompute.
_WORK_CALLBACK = None

# When set, called as f(direction: str, nbytes: int) once per DEVICE per
# ppermute through _send_down/_send_up with the local message size (all
# leaves of the carry pytree) — the measured-halo side of the weak-scaling
# model calibration (multihost.calibrate_weak_scaling_model).
_HALO_CALLBACK = None


def _count_work(tag: str, rows: int):
    if _WORK_CALLBACK is not None:
        jax.debug.callback(functools.partial(_WORK_CALLBACK, tag),
                           jnp.int32(rows))


def _count_halo(direction: str, x):
    if _HALO_CALLBACK is not None:
        nbytes = sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                     for leaf in jax.tree_util.tree_leaves(x))
        jax.debug.callback(
            functools.partial(_HALO_CALLBACK, direction, nbytes),
            jnp.int32(0))


class _XlaFamilyBackend:
    """Family sweeps via the lax.scan aggregation (any platform).

    Carry pytree: tuple of per-direction (2, W, D) int32 canonical carries
    (ops.aggregate.aggregate_one_path contract)."""

    def __init__(self, cost_t, img_t, above2, below2, p1, p2, adaptive,
                 neighbor_min, s_dtype=jnp.int32):
        self.cost, self.img = cost_t, img_t
        self.above2, self.below2 = above2, below2
        self.p1, self.p2, self.adaptive = p1, p2, adaptive
        self.nmin = neighbor_min
        self.s_dtype = s_dtype
        self.w = cost_t.shape[1]

    def zeros_s(self, rows=None):
        ht = self.cost.shape[0] if rows is None else rows
        return jnp.zeros((ht, self.w, self.cost.shape[2]), self.s_dtype)

    def zero_carry(self, family):
        nd = self.cost.shape[2]
        return tuple(jnp.zeros((2, self.w, nd), jnp.int32) for _ in family)

    def _prev2(self, family):
        # canonical (flipped) frame halo order for up families
        return self.above2 if family[0][0] > 0 else self.below2[::-1]

    def horiz_sweep(self, s, r):
        l = agg.aggregate_one_path(self.cost, self.img, r, self.p1, self.p2,
                                   self.adaptive, self.nmin)
        return s + l.astype(self.s_dtype)

    def family_sweep(self, s, family, carry, rows=slice(None)):
        """Aggregate `family` over cost[rows], += into s, return new carry."""
        prev2 = self._prev2(family)
        outs = []
        for r, c in zip(family, carry):
            l, cout = agg.aggregate_one_path(
                self.cost[rows], self.img[rows], r, self.p1, self.p2,
                self.adaptive, self.nmin, init_carry=c, img_prev2=prev2,
                return_carry=True)
            s = s + l.astype(self.s_dtype)
            outs.append(cout)
        return s, tuple(outs)

    def finish(self, s):
        return s


def _aggregate_tiled_exact(cost_t, img_t, above2, below2, dirs, p1, p2,
                           adaptive, axis: str, t: int,
                           neighbor_min=agg.neighbor_min_1d):
    """Bit-true wavefront aggregation of a row tile.  above2/below2 are the
    (2, W) image halos [y=-2, y=-1] and [y=Ht, y=Ht+1].

    Scheduling (SURVEY.md §7.3 item 7): per wavefront step k, ONLY the
    active tile sweeps — device k runs the full down family, device t-1-k
    the full up family, selected by lax.cond on the device index so
    inactive devices execute the trivial branch at runtime (no O(t)
    redundant recompute; total vertical-family work per device is one
    down + one up sweep of its own Ht rows).  The two families stream in
    opposite tile orders so both wavefronts overlap."""
    my = jax.lax.axis_index(axis)
    horiz, down, up = _split_dirs(dirs)
    be = _XlaFamilyBackend(cost_t, img_t, above2, below2, p1, p2,
                           adaptive, neighbor_min)

    s = be.zeros_s()
    for r in horiz:  # row-local
        s = be.horiz_sweep(s, r)

    carry_d = be.zero_carry(down)
    carry_u = be.zero_carry(up)
    ht = cost_t.shape[0]

    def active(family):
        def run(s, carry):
            _count_work("down" if family[0][0] > 0 else "up", ht)
            return be.family_sweep(s, family, carry)
        return run

    def idle(s, carry):
        return s, carry

    for k in range(t):
        s, cout_d = jax.lax.cond(my == k, active(down), idle, s, carry_d)
        s, cout_u = jax.lax.cond(my == t - 1 - k, active(up), idle, s,
                                 carry_u)
        if k < t - 1:
            carry_d = _send_down(cout_d, axis, t)
            carry_u = _send_up(cout_u, axis, t)
    return be.finish(s)


def _aggregate_tiled_fast(cost_t, img_t, above2, below2, dirs, p1, p2,
                          adaptive, axis: str, t: int, margin: int,
                          neighbor_min=agg.neighbor_min_1d):
    """Two-pass margin re-injection (approximate across tile seams unless
    margin >= forgetting_margin AND tiles are at least that tall — see
    params.forgetting_margin).  All devices stay active in both passes:
    near-linear scaling, one ppermute per family.

    Pass 1 sweeps the whole tile from the neutral carry into a per-family
    buffer; pass 2 re-sweeps only the first `margin` canonical rows from
    the received true carry and REPLACES those rows' contribution (a zero
    received carry — the global boundary tile — reproduces pass 1 exactly,
    so no masking is needed)."""
    horiz, down, up = _split_dirs(dirs)
    ht = cost_t.shape[0]
    m = min(margin, ht)
    be = _XlaFamilyBackend(cost_t, img_t, above2, below2, p1, p2,
                           adaptive, neighbor_min)

    s = be.zeros_s()
    for r in horiz:
        s = be.horiz_sweep(s, r)

    for family in (down, up):
        is_down = family[0][0] > 0
        tag = "down" if is_down else "up"
        _count_work(tag, ht)
        s1, cout = be.family_sweep(be.zeros_s(), family,
                                   be.zero_carry(family))
        send = _send_down if is_down else _send_up
        carry = send(cout, axis, t)
        rows = slice(0, m) if is_down else slice(ht - m, ht)
        _count_work(tag, m)
        s_fix, _ = be.family_sweep(be.zeros_s(rows=m), family, carry,
                                   rows=rows)
        if is_down:
            s_fam = jnp.concatenate([s_fix, s1[m:]], axis=0)
        else:
            s_fam = jnp.concatenate([s1[: ht - m], s_fix], axis=0)
        s = s + s_fam
    return be.finish(s)


# --------------------------------------------------------------------------
# Full tiled pipeline (inside shard_map, one frame per call)
# --------------------------------------------------------------------------

def _globalize_cost(cost, in_img, d_valid, invalid_cost):
    """Column-tiled cost fixup in GLOBAL coordinates: out-of-image window
    columns get cost 0 (the NEUTRAL pad value — a path crossing zero-cost
    columns from the window edge keeps L = 0, the neutral state, so the
    first in-image pixel takes L = C as at a real image edge) and in-image columns with a globally out-of-range match get
    invalid_cost.  Only ever forces values, so it composes with the local
    builder's own (stricter-nowhere) masking."""
    cost = jnp.where(d_valid[None, :, :], cost,
                     jnp.asarray(invalid_cost, cost.dtype))
    return jnp.where(in_img[None, :, None], cost, jnp.asarray(0, cost.dtype))

def _stereo_tile(img_l_t, img_r_t, params: SGMParams, dist: DistParams,
                 axis: str, t: int, gx=None, w_global: int | None = None):
    """Row-tile stereo pipeline body: (Ht, W) pair -> (Ht, W) disparity.

    gx / w_global (column-tiled mode): gx is the (W,) GLOBAL x coordinate
    of each local column of an x-extended window (may be out of the global
    [0, w_global) image).  Cost/LR validity then uses global coordinates,
    out-of-image columns get the NEUTRAL zero cost (the kernel's zero-carry
    pad trick reproduces golden edge semantics), and median edge
    replication follows the global image edge."""
    ch, _ = params.census_window
    halo = max(ch // 2, 2)

    il_ext = _exchange_row_halo(img_l_t, halo, axis, t)
    ir_ext = _exchange_row_halo(img_r_t, halo, axis, t)
    cen_l = census_transform(il_ext, params.census_window)[halo:-halo]
    cen_r = census_transform(ir_ext, params.census_window)[halo:-halo]
    cost = cost_volume_stereo(cen_l, cen_r, params.max_disp,
                              params.invalid_cost)

    in_img = None
    if gx is not None:
        ds = jnp.arange(params.max_disp, dtype=jnp.int32)[None, :]
        in_img = (gx >= 0) & (gx < w_global)            # (W,)
        cost = _globalize_cost(cost, in_img, gx[:, None] - ds >= 0,
                               params.invalid_cost)

    def aggregate(cost_v, guide_t, guide_ext):
        above2 = guide_ext[halo - 2: halo]
        ht = guide_t.shape[0]
        below2 = guide_ext[halo + ht: halo + ht + 2]
        if dist.tile_mode == "exact" and t > 1:
            s = _aggregate_tiled_exact(
                cost_v, guide_t, above2, below2, params.dirs, params.p1,
                params.p2, params.adaptive_p2, axis, t)
        elif t > 1:
            margin = dist.margin or forgetting_margin(
                params.p1, params.p2, cmax=params.invalid_cost)
            s = _aggregate_tiled_fast(
                cost_v, guide_t, above2, below2, params.dirs, params.p1,
                params.p2, params.adaptive_p2, axis, t, margin)
        else:
            s = agg.aggregate_paths(cost_v, guide_t, params.dirs, params.p1,
                                    params.p2, params.adaptive_p2)
        return s

    s = aggregate(cost, img_l_t, il_ext)

    d_int = ext.wta(s)
    disp = d_int.astype(jnp.float32)
    if params.subpixel:
        disp = ext.subpixel_refine(s, d_int)
    if params.lr_check:  # row-local (the S diagonal runs along x)
        if params.lr_mode == "reagg":
            # true right-reference re-aggregation: a second wavefront over
            # the right volume, guided by the right image (SURVEY.md M3)
            cost_r = cost_volume_stereo_right(cen_l, cen_r, params.max_disp,
                                              params.invalid_cost)
            if gx is not None:
                ds = jnp.arange(params.max_disp, dtype=jnp.int32)[None, :]
                cost_r = _globalize_cost(cost_r, in_img,
                                         gx[:, None] + ds < w_global,
                                         params.invalid_cost)
            d_right = ext.wta(aggregate(cost_r, img_r_t, ir_ext))
        else:
            d_right = ext.wta_right_from_s(s, params.s_invalid,
                                           gx=gx, w_global=w_global)
        if gx is not None:
            # out-of-image d_right must never satisfy an LR comparison
            d_right = jnp.where(in_img[None, :], d_right,
                                jnp.int32(-(1 << 20)))
        disp = ext.lr_check(disp, d_right, params.lr_max_diff,
                            params.max_disp)
    if params.median_filter:  # needs one true neighbor row on each side
        if gx is not None:
            # golden medians replicate at the GLOBAL image edge: overwrite
            # out-of-image window columns with the edge column's values
            # (only adjacent-to-real at the true edge tiles, where the
            # edge column IS the global edge)
            first = jnp.argmax(in_img)          # leftmost in-image column
            last = gx.shape[0] - 1 - jnp.argmax(in_img[::-1])
            cols = jnp.arange(gx.shape[0])
            left_fill = jnp.take(disp, first, axis=1)[:, None]
            right_fill = jnp.take(disp, last, axis=1)[:, None]
            disp = jnp.where(cols[None, :] < first, left_fill, disp)
            disp = jnp.where(cols[None, :] > last, right_fill, disp)
        disp_ext = _exchange_row_halo(disp, 1, axis, t)
        disp = ext.median_filter_3x3(disp_ext)[1:-1]
    return disp


def _stereo_tile_tx(img_l_t, img_r_t, params: SGMParams, dist: DistParams,
                    axis: str, t: int, tx_axis: str, tx: int):
    """Column-tiled pipeline body (SURVEY.md §2.2 SP "(TY, TX) blocks"):
    (Ht, Wt) shard -> (Ht, Wt) disparity.

    Construction: each tile computes the full pipeline on an x-EXTENDED
    window of ex = margin + D + census_radius columns per side (sliced
    from an all-gathered row band; images are the cheap object — the
    volumes are never materialized at full width), then crops.  By SGM's
    forgetting bound, every aggregated value at a distance >= margin from
    the window edge equals the full-image value, so with the auto margin
    (forgetting_margin) the result is BIT-EXACT, not approximate:

      * final-WTA S needs exactness on [x0, x1): distance ex >= margin;
      * the S-trick right-WTA reads S at x+d <= x1+D-1 and lr_check reads
        d_R down to x0-D — both >= margin from the window edge;
      * the first D window columns may see locally-unavailable cenR[x-d]
        (forced invalid): they are >= margin + census_radius upstream of
        anything consumed, so the forgetting bound absorbs them too.

    Out-of-image window columns carry ZERO cost — the kernels' neutral pad
    value — which reproduces golden image-edge path starts exactly; global
    x validity for cost/right-WTA/LR and median edge replication are
    handled in _stereo_tile via gx/w_global.  Work overhead per tile is
    (Wt + 2 ex)/Wt on the aggregation stage only.
    """
    ch, cw = params.census_window
    mx = dist.margin or forgetting_margin(params.p1, params.p2,
                                          cmax=params.invalid_cost)
    ex = mx + params.max_disp + cw // 2
    ht, wt = img_l_t.shape
    w = wt * tx
    x0 = jax.lax.axis_index(tx_axis) * wt

    def window(img_t):
        full = jax.lax.all_gather(img_t, tx_axis, axis=1, tiled=True)
        padded = jnp.pad(full, ((0, 0), (ex, ex)), mode="edge")
        return jax.lax.dynamic_slice(padded, (jnp.int32(0), x0),
                                     (ht, wt + 2 * ex))

    gx = x0 - ex + jnp.arange(wt + 2 * ex, dtype=jnp.int32)
    disp = _stereo_tile(window(img_l_t), window(img_r_t), params, dist,
                        axis, t, gx=gx, w_global=w)
    return disp[:, ex: ex + wt]


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _stereo_sgm_sharded_jit(img_l, img_r, params: SGMParams,
                            dist: DistParams, mesh: jax.sharding.Mesh):
    t = mesh.shape["ty"]
    tx = mesh.shape.get("tx", 1)

    def body(il, ir):  # local shards: (F_loc, Ht, Wt)
        if tx > 1:
            run = functools.partial(_stereo_tile_tx, params=params,
                                    dist=dist, axis="ty", t=t,
                                    tx_axis="tx", tx=tx)
        else:
            run = functools.partial(_stereo_tile, params=params, dist=dist,
                                    axis="ty", t=t)
        return jax.vmap(run)(il, ir)

    spec = P("frame", "ty", "tx") if tx > 1 else P("frame", "ty", None)
    # check_vma=False: constants created inside the body (neutral scan
    # carries, INF pads) are unvarying-by-construction; the static varying-
    # axes checker would otherwise require pvary noise at every zeros().
    fn = jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                       out_specs=spec, check_vma=False)
    return fn(img_l, img_r)


def stereo_sgm_sharded(img_l, img_r, params: SGMParams, dist: DistParams,
                       mesh: jax.sharding.Mesh):
    """Batched sharded stereo: (F, H, W) uint8 pairs -> (F, H, W) float32.

    F is sharded over mesh axis "frame" (DP), rows over "ty" and columns
    over "tx" (spatial; omit "tx" from the mesh for row-only tiling).
    H (resp. W) must divide evenly by the "ty" (resp. "tx") axis size.
    Tiles aggregate with the `lax.scan` carry API (ops/aggregate.py) on
    every platform.  Column tiling uses the margin-window construction (_stereo_tile_tx):
    bit-exact at the auto margin in BOTH tile modes."""
    return _stereo_sgm_sharded_jit(img_l, img_r, params, dist, mesh)
