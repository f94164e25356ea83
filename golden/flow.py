"""Golden NumPy fSGM optical-flow model (hierarchical 2D search).

Mirrors the reference flow driver (SURVEY.md §3.2 call stack): a
coarse-to-fine Gaussian/box pyramid; at each level a 2D cost volume over a
(2w+1)^2 label window centered on the 2x-upsampled coarser flow; SGM
aggregation over the 2D label space (P1 for 4-neighbor labels, P2
otherwise); WTA + separable 2D quadratic subpixel; forward-backward
consistency at the finest level; per-level median filtering.

Smoothness convention: the P1/P2 penalty acts on LABEL indices (window
offsets), not absolute flow vectors — neighboring pixels with different
rounded prior flow therefore see a P2-like jump, matching the common
hierarchical-SGM-flow simplification.  Documented here once; the JAX model
must match exactly.
"""

from __future__ import annotations

import numpy as np

from fsgm_tpu.params import FlowParams
from golden.sgm import (
    INF, census_transform, hamming, aggregate_one_path, median_filter_3x3,
)
from fsgm_tpu.params import DIRS_8
import dataclasses


# --------------------------------------------------------------------------
# Pyramid helpers (integer-exact)
# --------------------------------------------------------------------------

def downsample2x(img: np.ndarray) -> np.ndarray:
    """2x2 box downsample with round-half-up: (a+b+c+d+2)//4 on uint8.

    Odd trailing row/col are dropped (floor semantics), matching the
    level dims (H >> l, W >> l).
    """
    h, w = img.shape
    h2, w2 = h // 2, w // 2
    a = img[: 2 * h2 : 2, : 2 * w2 : 2].astype(np.int64)
    b = img[: 2 * h2 : 2, 1 : 2 * w2 : 2].astype(np.int64)
    c = img[1 : 2 * h2 : 2, : 2 * w2 : 2].astype(np.int64)
    d = img[1 : 2 * h2 : 2, 1 : 2 * w2 : 2].astype(np.int64)
    return ((a + b + c + d + 2) // 4).astype(img.dtype)


def build_pyramid(img: np.ndarray, levels: int):
    """[level0 (full res), level1, ...] — levels images total."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2x(pyr[-1]))
    return pyr


def downsample_flow_2x(flow: np.ndarray) -> np.ndarray:
    """2x2 box mean of (H, W, 2), values /2; floor dims (mirror of
    fsgm_tpu/models/flow.py::downsample_flow_2x, temporal-prior seeding)."""
    h, w = flow.shape[:2]
    h2, w2 = h // 2, w // 2
    a = flow[: 2 * h2: 2, : 2 * w2: 2]
    b = flow[: 2 * h2: 2, 1: 2 * w2: 2]
    c = flow[1: 2 * h2: 2, : 2 * w2: 2]
    d = flow[1: 2 * h2: 2, 1: 2 * w2: 2]
    return (a + b + c + d) * 0.125


def upsample_flow_2x(flow: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Nearest-neighbor 2x upsample of a (H, W, 2) flow field; values x2.

    Edge-replicates to reach (out_h, out_w) when the finer level is odd.
    """
    up = np.repeat(np.repeat(flow, 2, axis=0), 2, axis=1) * 2.0
    h, w = up.shape[:2]
    if h < out_h:
        up = np.concatenate([up, up[-1:].repeat(out_h - h, axis=0)], axis=0)
    if w < out_w:
        up = np.concatenate([up, up[:, -1:].repeat(out_w - w, axis=1)], axis=1)
    return up[:out_h, :out_w]


def upsample_valid_2x(valid: np.ndarray, out_h: int, out_w: int
                      ) -> np.ndarray:
    """Nearest-neighbor 2x upsample of a bool validity plane, edge-extended
    (the fb_grid='half' merge; fsgm_tpu/models/flow.py mirrors)."""
    up = np.repeat(np.repeat(valid, 2, axis=0), 2, axis=1)
    h, w = up.shape
    if h < out_h:
        up = np.concatenate([up, up[-1:].repeat(out_h - h, axis=0)], axis=0)
    if w < out_w:
        up = np.concatenate([up, up[:, -1:].repeat(out_w - w, axis=1)],
                            axis=1)
    return up[:out_h, :out_w]


# --------------------------------------------------------------------------
# 2D-label cost volume
# --------------------------------------------------------------------------

def cost_volume_flow(cen1: np.ndarray, cen2: np.ndarray,
                     base_u: np.ndarray, base_v: np.ndarray,
                     radius: int, invalid_cost: int = 255) -> np.ndarray:
    """C[y, x, l] over labels l = (dv + w) * (2w+1) + (du + w).

    Warp-then-shift formulation (the classical coarse-to-fine recipe: a
    single per-pixel warp plus static window shifts instead of a
    per-pixel-per-label gather):

      1. warp the second image's census by the rounded prior flow once:
         cen2w[y, x] = cen2[y + base_v, x + base_u];
      2. the label (du, dv) then matches cen2w at the STATIC offset
         (y + dv, x + du).

    The matched target is therefore pixel
      ((y+dv) + base_v(y+dv, x+du), (x+du) + base_u(y+dv, x+du))
    — the prior flow is sampled at the window position rather than the
    window center.  For the median-filtered, piecewise-smooth priors the
    pyramid produces, the two are equal except near motion boundaries.
    Out-of-bounds window positions or warp sources get invalid_cost.
    """
    h, w = cen1.shape
    ext = 2 * radius + 1
    nl = ext * ext
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sy = yy + base_v
    sx = xx + base_u
    ok_w = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    cen2w = cen2[np.clip(sy, 0, h - 1), np.clip(sx, 0, w - 1)]
    c = np.full((h, w, nl), int(invalid_cost), dtype=np.int64)
    for dv in range(-radius, radius + 1):
        for du in range(-radius, radius + 1):
            l = (dv + radius) * ext + (du + radius)
            ty = yy + dv
            tx = xx + du
            inb = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
            tyc = np.clip(ty, 0, h - 1)
            txc = np.clip(tx, 0, w - 1)
            ok = inb & ok_w[tyc, txc]
            ham = hamming(cen1, cen2w[tyc, txc])
            c[:, :, l] = np.where(ok, ham, int(invalid_cost))
    return c


# --------------------------------------------------------------------------
# 2D-label neighborhood and aggregation
# --------------------------------------------------------------------------

def make_neighbor_min_2d(radius: int):
    """min over the 4-neighborhood in the (2w+1)x(2w+1) label grid, +P1."""
    ext = 2 * radius + 1

    def neighbor_min_2d(prev: np.ndarray, p1: int) -> np.ndarray:
        n = prev.shape[0]
        g = prev.reshape(n, ext, ext)
        inf_row = np.full((n, 1, ext), INF, dtype=np.int64)
        inf_col = np.full((n, ext, 1), INF, dtype=np.int64)
        up = np.concatenate([inf_row, g[:, :-1, :]], axis=1)
        down = np.concatenate([g[:, 1:, :], inf_row], axis=1)
        left = np.concatenate([inf_col, g[:, :, :-1]], axis=2)
        right = np.concatenate([g[:, :, 1:], inf_col], axis=2)
        m = np.minimum(np.minimum(up, down), np.minimum(left, right))
        return m.reshape(n, ext * ext) + p1

    return neighbor_min_2d


def aggregate_paths_flow(cost: np.ndarray, img: np.ndarray,
                         params: FlowParams) -> np.ndarray:
    """8-path SGM aggregation over the 2D label space."""
    nm = make_neighbor_min_2d(params.search_radius)
    s = np.zeros_like(cost)
    for r in DIRS_8:
        s += aggregate_one_path(cost, img, r, params.p1, params.p2,
                                params.adaptive_p2, neighbor_min=nm)
    return s


# --------------------------------------------------------------------------
# Extraction in 2D label space
# --------------------------------------------------------------------------

def wta_flow(s: np.ndarray, radius: int):
    """argmin over labels -> integer (du, dv) offsets."""
    ext = 2 * radius + 1
    l = np.argmin(s, axis=2)
    du = (l % ext) - radius
    dv = (l // ext) - radius
    return du.astype(np.int64), dv.astype(np.int64), l


def subpixel_flow(s: np.ndarray, l_int: np.ndarray, radius: int):
    """Separable parabola refinement: in u at fixed dv, in v at fixed du.

    Same formula and gating as the stereo subpixel (golden/sgm.py).
    """
    ext = 2 * radius + 1
    h, w, _ = s.shape
    g = s.reshape(h, w, ext, ext).astype(np.float64)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    iu = l_int % ext
    iv = l_int // ext

    def parabola(idx, values_m, values_0, values_p, size):
        interior = (idx > 0) & (idx < size - 1)
        denom = values_m - 2.0 * values_0 + values_p
        ok = interior & (denom > 0)
        off = np.where(ok, (values_m - values_p) / np.maximum(2.0 * denom, 1e-12), 0.0)
        return np.clip(off, -0.5, 0.5) * ok

    iuc = np.clip(iu, 1, ext - 2)
    ivc = np.clip(iv, 1, ext - 2)
    du_off = parabola(iu, g[yy, xx, iv, iuc - 1], g[yy, xx, iv, iuc],
                      g[yy, xx, iv, iuc + 1], ext)
    dv_off = parabola(iv, g[yy, xx, ivc - 1, iu], g[yy, xx, ivc, iu],
                      g[yy, xx, ivc + 1, iu], ext)
    return du_off, dv_off


# --------------------------------------------------------------------------
# Pyramid driver
# --------------------------------------------------------------------------

def _flow_one_level(img1, img2, prior_flow, params: FlowParams):
    """One pyramid level: cost -> aggregate -> WTA -> subpixel -> median."""
    h, w = img1.shape
    base_u = np.rint(prior_flow[..., 0]).astype(np.int64)
    base_v = np.rint(prior_flow[..., 1]).astype(np.int64)
    cen1 = census_transform(img1, params.census_window)
    cen2 = census_transform(img2, params.census_window)
    cost = cost_volume_flow(cen1, cen2, base_u, base_v,
                            params.search_radius, params.invalid_cost)
    s = aggregate_paths_flow(cost, img1, params)
    du, dv, l_int = wta_flow(s, params.search_radius)
    u = base_u.astype(np.float64) + du
    v = base_v.astype(np.float64) + dv
    if params.subpixel:
        du_off, dv_off = subpixel_flow(s, l_int, params.search_radius)
        u = u + du_off
        v = v + dv_off
    flow = np.stack([u, v], axis=-1)
    if params.median_filter:
        flow = np.stack([median_filter_3x3(flow[..., 0]),
                         median_filter_3x3(flow[..., 1])], axis=-1)
    return flow


def fb_check(flow_fwd: np.ndarray, flow_bwd: np.ndarray, max_diff: float
             ) -> np.ndarray:
    """Forward-backward consistency: |F(p) + B(p + F(p))| <= max_diff.

    Lookup rounds the forward-displaced position.  Returns the (H, W) bool
    validity plane; flow values are NOT overwritten (an in-range sentinel
    like (-1, -1) would be indistinguishable from real leftward motion).
    """
    h, w = flow_fwd.shape[:2]
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    tx = xx + np.rint(flow_fwd[..., 0]).astype(np.int64)
    ty = yy + np.rint(flow_fwd[..., 1]).astype(np.int64)
    inb = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    txc = np.clip(tx, 0, w - 1)
    tyc = np.clip(ty, 0, h - 1)
    b = flow_bwd[tyc, txc]
    err = np.sqrt((flow_fwd[..., 0] + b[..., 0]) ** 2
                  + (flow_fwd[..., 1] + b[..., 1]) ** 2)
    return inb & (err <= max_diff)


def fsgm_flow(img1: np.ndarray, img2: np.ndarray, params: FlowParams,
              return_intermediates: bool = False, prior_flow=None):
    """Full golden fSGM: coarse-to-fine 2D-label SGM (SURVEY.md §3.2).

    Returns (flow (H, W, 2) float64, valid (H, W) bool).  Validity is an
    explicit plane (mirroring the KITTI encoding's separate validity
    channel), never an in-band flow value.  `prior_flow` mirrors the
    temporal-prior seeding of fsgm_tpu/models/flow.py::flow_fsgm."""
    pyr1 = build_pyramid(img1, params.levels)
    pyr2 = build_pyramid(img2, params.levels)
    init = None
    if prior_flow is not None:
        init = np.asarray(prior_flow, dtype=np.float64)
        for _ in range(params.levels - 1):
            init = downsample_flow_2x(init)
    flow = (np.zeros((*pyr1[-1].shape, 2), dtype=np.float64)
            if init is None else init)
    per_level = []
    for lvl in range(params.levels - 1, -1, -1):
        i1, i2 = pyr1[lvl], pyr2[lvl]
        if lvl < params.levels - 1:
            flow = upsample_flow_2x(flow, i1.shape[0], i1.shape[1])
        flow = _flow_one_level(i1, i2, flow, params)
        per_level.append(flow)
    valid = np.ones(flow.shape[:2], dtype=bool)
    if params.fb_check:
        # backward flow at full resolution only, zero prior at finest level
        # of its own pyramid for cost; reuse the same machinery with swapped
        # images.
        if params.fb_backward == "single":
            # mirror fsgm_tpu/models/flow.py: one backward level at finest
            # resolution with the negated forward flow as prior, no
            # subpixel/median
            bwd_params = dataclasses.replace(
                params, subpixel=False, median_filter=False)
            flow_bwd = _flow_one_level(img2, img1, -flow, bwd_params)
        elif params.fb_backward == "half":
            # mirror fsgm_tpu/models/flow.py: backward pyramid stops at
            # level 1 (half resolution) with FULL extraction at every
            # backward level, result 2x-upsampled for the rounded
            # fb_check lookup
            # fb_backward reset to "full": levels-1 may be 1, which the
            # 'half' validator rejects (and fb_check=False makes the field
            # unused in the recursive call anyway)
            bwd_params = dataclasses.replace(
                params, fb_check=False, levels=params.levels - 1,
                fb_backward="full")
            bwd_prior = (None if init is None
                         else -downsample_flow_2x(
                             np.asarray(prior_flow, dtype=np.float64)))
            bwd_half, _ = fsgm_flow(downsample2x(img2), downsample2x(img1),
                                    bwd_params, prior_flow=bwd_prior)
            bwd_half_native = bwd_half   # fb_grid='half' checks it directly
            flow_bwd = upsample_flow_2x(bwd_half, flow.shape[0],
                                        flow.shape[1])
        else:
            # mirror fsgm_tpu/models/flow.py::_fsgm_flow_both: backward
            # pyramid with full extraction at prior-feeding levels; in
            # "cheap" mode only the final level skips subpixel/median
            final_params = params
            if params.fb_backward == "cheap":
                final_params = dataclasses.replace(
                    params, subpixel=False, median_filter=False)
            bpyr1 = build_pyramid(img2, params.levels)
            bpyr2 = build_pyramid(img1, params.levels)
            flow_bwd = (np.zeros((*bpyr1[-1].shape, 2), dtype=np.float64)
                        if init is None else -init)
            for lvl in range(params.levels - 1, -1, -1):
                i1, i2 = bpyr1[lvl], bpyr2[lvl]
                if lvl < params.levels - 1:
                    flow_bwd = upsample_flow_2x(flow_bwd, i1.shape[0],
                                                i1.shape[1])
                p_lvl = final_params if lvl == 0 else params
                flow_bwd = _flow_one_level(i1, i2, flow_bwd, p_lvl)
        if params.fb_grid == "half":
            # mirror fsgm_tpu/models/flow.py: both fields on the half grid
            # (the 'half' backward field is already there — checked
            # directly, no up/down round trip), tolerance halves with the
            # pixel size, validity plane nearest-upsampled
            bwd_h = (bwd_half_native if params.fb_backward == "half"
                     else downsample_flow_2x(flow_bwd))
            valid_h = fb_check(downsample_flow_2x(flow), bwd_h,
                               params.fb_max_diff * 0.5)
            valid = upsample_valid_2x(valid_h, flow.shape[0], flow.shape[1])
        else:
            valid = fb_check(flow, flow_bwd, params.fb_max_diff)
    if return_intermediates:
        return flow, valid, dict(per_level=per_level)
    return flow, valid


def flow_sequence(frames, params: FlowParams, track_params=None):
    """Golden mirror of fsgm_tpu/models/flow.py::flow_sequence: pair 0
    from scratch, later pairs seeded with the previous pair's field."""
    tp = track_params if track_params is not None else params
    flows, valids = [], []
    prev = None
    for t in range(frames.shape[0] - 1):
        if prev is None:
            f, v = fsgm_flow(frames[t], frames[t + 1], params)
        else:
            f, v = fsgm_flow(frames[t], frames[t + 1], tp, prior_flow=prev)
        flows.append(f)
        valids.append(v)
        # mirror fsgm_tpu: seed the next pair with FB-validated flow only
        prev = np.where(v[..., None], f, 0.0)
    return np.stack(flows), np.stack(valids)
