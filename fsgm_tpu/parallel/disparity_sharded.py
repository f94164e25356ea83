"""Disparity-axis (label) sharding — the tensor-parallel analog.

SURVEY.md §2.2 "TP" row: each device holds D/k disparity planes of the cost
volume.  Useful only for very large label spaces (the per-scan-step
cross-chip reduction is expensive — documented trade-off); implemented as
an optional, exact mode:

  * cost volume: each chip builds its own d-slice (census replicated —
    it is tiny next to the volume);
  * path aggregation: the scan step's min_k L term becomes a local min +
    `lax.pmin` over the "td" axis, and the d±1 neighbor term exchanges a
    one-lane halo with each lane-neighbor chip via `ppermute`;
  * WTA / subpixel / right-WTA: local one-hot lane reductions merged with
    pmin; global argmin with smallest-index tie-break matches golden
    exactly.

Everything stays integer until subpixel, so the mode is bit-exact vs the
single-chip pipeline (tests/distributed/test_disparity_sharded.py).

Backend note: this mode is XLA-only by construction.  The recurrence
needs a cross-device `pmin` inside every scan step (the min_k L term spans
the sharded label axis), which a kernel cannot issue mid-walk; the
`lax.scan` + `pmin` structure is the natural form.  Spatial tiling shards
axes the recurrence only crosses once per sweep (halo at tile edges).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fsgm_tpu.params import SGMParams
from fsgm_tpu.ops.census import census_transform, hamming
from fsgm_tpu.ops import extract as ext

INF32 = np.int32(1 << 28)
BIG = np.int32(1 << 24)


def _axis_info(axis: str):
    k = jax.lax.axis_index(axis)
    n = jax.lax.axis_size(axis)
    return k, n


def cost_volume_slice(cen_l, cen_r, d_lo: jnp.ndarray, d_local: int,
                      invalid_cost: int) -> jnp.ndarray:
    """C[y, x, dl] for global disparities d_lo + dl (u8)."""
    h, w, _ = cen_l.shape
    xs = jnp.arange(w, dtype=jnp.int32)[:, None]
    ds = d_lo + jnp.arange(d_local, dtype=jnp.int32)[None, :]
    src = xs - ds
    valid = src >= 0
    src_c = jnp.clip(src, 0, w - 1)
    cen_r_g = cen_r[:, src_c, :]
    ham = hamming(cen_l[:, :, None, :], cen_r_g)
    return jnp.where(valid[None], ham, invalid_cost).astype(jnp.uint8)


def _neighbor_min_sharded(prev: jnp.ndarray, p1, axis: str):
    """min(prev[d-1], prev[d+1]) + P1 with one-lane halos from the lane-
    neighbor chips.  prev: (W, Dl) int32."""
    k, n = _axis_info(axis)
    # receive last lane of chip k-1 and first lane of chip k+1
    from_lo = jax.lax.ppermute(prev[:, -1:], axis,
                               [(i, i + 1) for i in range(n - 1)])
    from_hi = jax.lax.ppermute(prev[:, :1], axis,
                               [(i + 1, i) for i in range(n - 1)])
    from_lo = jnp.where(k == 0, INF32, from_lo)
    from_hi = jnp.where(k == n - 1, INF32, from_hi)
    shift_m = jnp.concatenate([from_lo, prev[:, :-1]], axis=1)
    shift_p = jnp.concatenate([prev[:, 1:], from_hi], axis=1)
    return jnp.minimum(shift_m, shift_p) + np.int32(p1)


def aggregate_one_path_dsharded(cost_t, img, direction: Tuple[int, int],
                                p1: int, p2: int, adaptive: bool,
                                axis: str):
    """One path over a d-sharded volume; mirrors ops.aggregate semantics
    (zero init carry, x-bounds validity, adaptive P2)."""
    dy, dx = direction
    if dy == 0:
        out = aggregate_one_path_dsharded(
            jnp.swapaxes(cost_t, 0, 1), img.T, (dx, 0), p1, p2, adaptive,
            axis)
        return jnp.swapaxes(out, 0, 1)
    if dy < 0:
        return aggregate_one_path_dsharded(
            cost_t[::-1], img[::-1], (-dy, dx), p1, p2, adaptive, axis)[::-1]

    h, w, dl = cost_t.shape
    img32 = img.astype(jnp.int32)
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]
    valid = jnp.broadcast_to((xx - dx >= 0) & (xx - dx < w), (h, w))
    if adaptive:
        prev2 = jnp.zeros((2, w), jnp.int32)
        extd = jnp.concatenate([prev2, img32], axis=0)
        pred = jax.lax.dynamic_slice_in_dim(extd, 2 - dy, h, axis=0)
        pred = jnp.roll(pred, dx, axis=1)
        diff = jnp.maximum(jnp.abs(img32 - pred), 1)
        p2e = jnp.maximum(np.int32(p1 + 1), np.int32(p2) // diff)
        p2e = jnp.where(valid, p2e, np.int32(p2))
    else:
        p2e = jnp.full((h, w), p2, dtype=jnp.int32)

    def shift_x(row, fill):
        if dx == 0:
            return row
        pad = jnp.full((abs(dx),) + row.shape[1:], fill, row.dtype)
        if dx > 0:
            return jnp.concatenate([pad, row[:-dx]], axis=0)
        return jnp.concatenate([row[-dx:], pad], axis=0)

    def step(carry, xs):
        cost_row, p2e_row, valid_row = xs
        cost_row = cost_row.astype(jnp.int32)
        prev = shift_x(carry[dy - 1], INF32)                # (W, Dl)
        m_local = jnp.min(prev, axis=-1, keepdims=True)
        m = jax.lax.pmin(m_local, axis)                     # global min_k
        nmin = _neighbor_min_sharded(prev, p1, axis)
        best = jnp.minimum(jnp.minimum(prev, nmin),
                           m + p2e_row[:, None])
        l_row = jnp.where(valid_row[:, None], cost_row + best - m, cost_row)
        return jnp.stack([l_row, carry[0]], axis=0), l_row

    carry0 = jnp.zeros((2, w, dl), dtype=jnp.int32)
    _, l_all = jax.lax.scan(step, carry0, (cost_t, p2e, valid))
    return l_all


def _global_argmin(vals: jnp.ndarray, d_lo, axis: str):
    """(.., Dl) -> global (argmin_d, min) with smallest-d tie-break."""
    local_min = jnp.min(vals, axis=-1)
    local_arg = jnp.argmin(vals, axis=-1).astype(jnp.int32) + d_lo
    gmin = jax.lax.pmin(local_min, axis)
    cand = jnp.where(local_min == gmin, local_arg, np.int32(1 << 30))
    garg = jax.lax.pmin(cand, axis)
    return garg, gmin


def _sel_global(sv: jnp.ndarray, target: jnp.ndarray, d_lo, axis: str):
    """S at global lane `target` via masked min + pmin merge (int32)."""
    dl = sv.shape[-1]
    lane = d_lo + jnp.arange(dl, dtype=jnp.int32)
    local = jnp.min(jnp.where(lane == target[..., None], sv, BIG), axis=-1)
    return jax.lax.pmin(local, axis)


def _stereo_dsharded_body(img_l, img_r, params: SGMParams, axis: str):
    k, n = _axis_info(axis)  # n (mesh size) is static under shard_map
    if params.max_disp % n:
        raise ValueError(f"max_disp {params.max_disp} must divide by "
                         f"td axis size {n}")
    dl = params.max_disp // n
    d_lo = k * dl

    cen_l = census_transform(img_l, params.census_window)
    cen_r = census_transform(img_r, params.census_window)
    cost_t = cost_volume_slice(cen_l, cen_r, d_lo, dl, params.invalid_cost)

    s = jnp.zeros(cost_t.shape, dtype=jnp.int32)
    for r in params.dirs:
        s = s + aggregate_one_path_dsharded(cost_t, img_l, r, params.p1,
                                            params.p2, params.adaptive_p2,
                                            axis)

    d_int, s0 = _global_argmin(s, d_lo, axis)
    disp = d_int.astype(jnp.float32)
    if params.subpixel:
        s_m = _sel_global(s, d_int - 1, d_lo, axis)
        s_p = _sel_global(s, d_int + 1, d_lo, axis)
        fm, f0, fp = (x.astype(jnp.float32) for x in (s_m, s0, s_p))
        interior = (d_int > 0) & (d_int < params.max_disp - 1)
        denom = fm - 2.0 * f0 + fp
        ok = interior & (denom > 0)
        off = jnp.where(ok, (fm - fp) / jnp.maximum(2.0 * denom, 1e-12), 0.0)
        disp = disp + jnp.where(ok, jnp.clip(off, -0.5, 0.5), 0.0)
    if params.lr_check:
        # right-WTA diagonal on the local slice, then global merge
        h, w, _ = s.shape
        xs = jnp.arange(w, dtype=jnp.int32)[:, None]
        ds = d_lo + jnp.arange(dl, dtype=jnp.int32)[None, :]
        src = xs + ds
        ok_src = src < w
        diag = jnp.take_along_axis(
            s, jnp.clip(src, 0, w - 1)[None].repeat(h, 0), axis=1)
        diag = jnp.where(ok_src[None], diag, params.s_invalid)
        d_right, _ = _global_argmin(diag, d_lo, axis)
        disp = ext.lr_check(disp, d_right, params.lr_max_diff,
                            params.max_disp)
    if params.median_filter:
        disp = ext.median_filter_3x3(disp)
    return disp


@functools.partial(jax.jit, static_argnums=(2, 3))
def stereo_sgm_dsharded(img_l, img_r, params: SGMParams,
                        mesh: jax.sharding.Mesh):
    """(H, W) pair replicated; cost volume sharded over mesh axis "td"."""
    def body(a, b):
        return _stereo_dsharded_body(a, b, params, "td")

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(P(), P()), out_specs=P(),
                       check_vma=False)
    return fn(img_l, img_r)
