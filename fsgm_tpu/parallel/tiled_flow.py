"""Multi-device tiled fSGM flow (SURVEY.md §2.2 / BASELINE config 5).

Same mesh as stereo: "frame" = DP over pairs, "ty" = row tiling with SGM
path-state wavefronts.  Flow-specific differences:

  * The 2D search targets are vertically unbounded (prior flow can point
    anywhere), so the SECOND image's census is computed on the full image
    — each device all-gathers the (H, W) uint8 rows first (tiny: ~2 MB at
    KITTI size vs the ~GB label volume, and once per level).
  * Aggregation reuses the stereo wavefront machinery verbatim with the
    2D-label neighbor-min closure; the carry is (2, W, L) over the label
    axis.
  * The pyramid runs inside shard_map; per-level tile heights are the
    global level heights / T, so H must be divisible by T * 2^(levels-1).
  * The forward-backward check all-gathers the (small) backward flow field
    and checks locally.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fsgm_tpu.params import FlowParams, DistParams, DIRS_8
from fsgm_tpu.ops.census import census_transform
from fsgm_tpu.ops.cost import cost_volume_flow
from fsgm_tpu.ops import aggregate as agg
from fsgm_tpu.ops import extract as ext
from fsgm_tpu.models import flow as mflow
from fsgm_tpu.parallel.tiled import (
    _exchange_row_halo, _aggregate_tiled_exact, _aggregate_tiled_fast)


def _all_gather_rows(x_t, axis: str):
    """(Ht, ...) row tile -> full (H, ...) array on every device."""
    g = jax.lax.all_gather(x_t, axis, tiled=True)
    return g


def _flow_level_tile(i1_t, i2_full, prior_flow_t, params: FlowParams,
                     dist: DistParams, axis: str, t: int,
                     is_coarsest: bool = False):
    """One pyramid level on a row tile; i2_full is the full second image."""
    ht = i1_t.shape[0]
    my = jax.lax.axis_index(axis)
    y0 = my * ht
    ch, _ = params.census_window
    halo = max(ch // 2, 2)

    i1_ext = _exchange_row_halo(i1_t, halo, axis, t)
    cen1 = census_transform(i1_ext, params.census_window)[halo:-halo]
    cen2 = census_transform(i2_full, params.census_window)

    # warp-then-shift cost build needs `radius` TRUE halo rows of the
    # prior flow: the static dv shifts read warped descriptors across
    # tile seams (fsgm_tpu/ops/cost.py::cost_volume_flow tiled mode).
    r = params.search_radius
    flow_ext = _exchange_row_halo(prior_flow_t, r, axis, t)
    base_u = jnp.rint(flow_ext[..., 0]).astype(jnp.int32)
    base_v = jnp.rint(flow_ext[..., 1]).astype(jnp.int32)
    cost = cost_volume_flow(cen1, cen2, base_u, base_v,
                            params.search_radius, params.invalid_cost,
                            y_offset=y0, identity_base=is_coarsest)

    above2 = i1_ext[halo - 2: halo]
    below2 = i1_ext[halo + ht: halo + ht + 2]
    nm = agg.make_neighbor_min_2d(params.search_radius)
    if t > 1 and dist.tile_mode == "exact":
        s = _aggregate_tiled_exact(cost, i1_t, above2, below2, DIRS_8,
                                   params.p1, params.p2, params.adaptive_p2,
                                   axis, t, neighbor_min=nm)
    elif t > 1:
        from fsgm_tpu.params import forgetting_margin
        margin = dist.margin or forgetting_margin(
            params.p1, params.p2, cmax=params.invalid_cost)
        s = _aggregate_tiled_fast(cost, i1_t, above2, below2, DIRS_8,
                                  params.p1, params.p2, params.adaptive_p2,
                                  axis, t, margin, neighbor_min=nm)
    else:
        s = agg.aggregate_paths(cost, i1_t, DIRS_8, params.p1, params.p2,
                                params.adaptive_p2, neighbor_min=nm)

    du, dv, l_int = mflow.wta_flow(s, params.search_radius)
    u = (base_u[r:-r] + du).astype(jnp.float32)
    v = (base_v[r:-r] + dv).astype(jnp.float32)
    if params.subpixel:
        du_off, dv_off = mflow.subpixel_flow(s, l_int, params.search_radius)
        u = u + du_off
        v = v + dv_off
    flow = jnp.stack([u, v], axis=-1)
    if params.median_filter:
        fe = _exchange_row_halo(flow, 1, axis, t)
        flow = jnp.stack([ext.median_filter_3x3(fe[..., 0])[1:-1],
                          ext.median_filter_3x3(fe[..., 1])[1:-1]], axis=-1)
    return flow


def _flow_oneway_tile(img1_t, img2_t, params: FlowParams, dist: DistParams,
                      axis: str, t: int, stop_level: int = 0,
                      final_params=None):
    """Coarse-to-fine pass on row tiles down to `stop_level` (0 = full
    resolution).  `final_params` (if given) replaces `params` for the
    finest level run — the fb_backward="cheap" final-level skip; earlier
    levels always extract fully since they feed priors (models/flow.py)."""
    pyr1 = mflow.build_pyramid(img1_t, params.levels)   # row tiles
    img2_full = _all_gather_rows(img2_t, axis)
    pyr2 = mflow.build_pyramid(img2_full, params.levels)  # full images
    flow = jnp.zeros(pyr1[-1].shape + (2,), dtype=jnp.float32)
    for lvl in range(params.levels - 1, stop_level - 1, -1):
        i1 = pyr1[lvl]
        if lvl < params.levels - 1:
            flow = mflow.upsample_flow_2x(flow, i1.shape[0], i1.shape[1])
        p_lvl = (final_params if lvl == stop_level
                 and final_params is not None else params)
        flow = _flow_level_tile(i1, pyr2[lvl], flow, p_lvl, dist, axis, t,
                                is_coarsest=(lvl == params.levels - 1))
    return flow


def _flow_tile(img1_t, img2_t, params: FlowParams, dist: DistParams,
               axis: str, t: int):
    import dataclasses
    flow = _flow_oneway_tile(img1_t, img2_t, params, dist, axis, t)
    valid = jnp.ones(flow.shape[:2], dtype=bool)
    if params.fb_check:
        # backward-pass variants mirror models/flow.py::flow_fsgm exactly
        # (same per-mode level schedule and extraction flags)
        nosub = dataclasses.replace(params, subpixel=False,
                                    median_filter=False)
        if params.fb_backward == "single":
            img1_full = _all_gather_rows(img1_t, axis)
            bwd_t = _flow_level_tile(img2_t, img1_full, -flow, nosub,
                                     dist, axis, t)
        elif params.fb_backward == "half":
            bwd_half = _flow_oneway_tile(img2_t, img1_t, params, dist,
                                         axis, t, stop_level=1)
            bwd_t = mflow.upsample_flow_2x(bwd_half, flow.shape[0],
                                           flow.shape[1])
        else:
            fp = nosub if params.fb_backward == "cheap" else None
            bwd_t = _flow_oneway_tile(img2_t, img1_t, params, dist, axis,
                                      t, final_params=fp)
        bwd_full = _all_gather_rows(bwd_t, axis)
        ht = flow.shape[0]
        my = jax.lax.axis_index(axis)
        # fb_check gathers at displaced rows: build a row-offset view by
        # padding the local forward flow into global coordinates
        valid = _fb_check_tiled(flow, bwd_full, my * ht,
                                params.fb_max_diff)
    return flow, valid


def _fb_check_tiled(flow_fwd_t, flow_bwd_full, y0, max_diff):
    """Tiled forward-backward check: forward rows are local, backward
    lookups hit global rows.  Returns the (Ht, W) bool validity plane."""
    ht, w = flow_fwd_t.shape[:2]
    hg = flow_bwd_full.shape[0]
    yy = jnp.arange(ht, dtype=jnp.int32)[:, None] + y0
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]
    tx = xx + jnp.rint(flow_fwd_t[..., 0]).astype(jnp.int32)
    ty = yy + jnp.rint(flow_fwd_t[..., 1]).astype(jnp.int32)
    inb = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < hg)
    txc = jnp.clip(tx, 0, w - 1)
    tyc = jnp.clip(ty, 0, hg - 1)
    # flattened linear-index take, as in models/flow.py::fb_check
    b = jnp.take(flow_bwd_full.reshape(hg * w, 2), tyc * w + txc, axis=0)
    err = jnp.sqrt((flow_fwd_t[..., 0] + b[..., 0]) ** 2
                   + (flow_fwd_t[..., 1] + b[..., 1]) ** 2)
    return inb & (err <= max_diff)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _flow_fsgm_sharded_jit(img1, img2, params: FlowParams,
                           dist: DistParams, mesh: jax.sharding.Mesh):
    t = mesh.shape["ty"]

    def body(i1, i2):
        run = functools.partial(_flow_tile, params=params, dist=dist,
                                axis="ty", t=t)
        return jax.vmap(run)(i1, i2)

    in_spec = P("frame", "ty", None)
    fn = jax.shard_map(body, mesh=mesh, in_specs=(in_spec, in_spec),
                       out_specs=(P("frame", "ty", None, None),
                                  P("frame", "ty", None)),
                       check_vma=False)
    return fn(img1, img2)


def flow_fsgm_sharded(img1, img2, params: FlowParams, dist: DistParams,
                      mesh: jax.sharding.Mesh):
    """Batched sharded flow: (F, H, W) uint8 pairs ->
    (flow (F, H, W, 2) f32, valid (F, H, W) bool).

    F over "frame", rows over "ty"; H must divide by ty * 2^(levels-1).
    The FB check runs on the full grid (fb_grid='full') only."""
    if params.fb_check and params.fb_grid != "full":
        raise NotImplementedError(
            f"tiled flow checks FB on the full grid only, got "
            f"fb_grid={params.fb_grid!r}")
    return _flow_fsgm_sharded_jit(img1, img2, params, dist, mesh)
