"""fSGM optical flow — hierarchical coarse-to-fine 2D-label SGM (L4/L5).

JAX realization of the reference's flow driver (SURVEY.md §3.2 call
stack; golden/flow.py is the exact-integer oracle):

  * Gaussian-free integer box pyramid (2x2 round-half-up, exact vs golden).
  * Per level: census -> 2D-offset cost volume over a (2w+1)^2 label window
    centered on the upsampled coarser flow -> SGM aggregation over the 2D
    label space (P1 on 4-neighbor labels, P2 otherwise) -> WTA -> separable
    2D parabola subpixel -> median.
  * The label axis is the innermost axis: (2w+1)^2 labels (81 at w=4) go
    through the same aggregation backends as stereo; only the label
    neighbourhood changes (2D grid instead of d +- 1).
  * Pyramid levels have static per-level shapes; the level loop unrolls at
    trace time (no dynamic shapes under jit).
  * Forward-backward consistency at full resolution mirrors golden fb_check.
"""

from __future__ import annotations


import dataclasses
import functools

import jax
import numpy as np
import jax.numpy as jnp

from fsgm_tpu.backend import aggregate, resolve_backend
from fsgm_tpu.params import FlowParams, DIRS_8
from fsgm_tpu.ops.census import census_transform
from fsgm_tpu.ops.cost import cost_volume_flow
from fsgm_tpu.ops import extract as ext


# --------------------------------------------------------------------------
# Integer-exact pyramid (mirrors golden/flow.py)
# --------------------------------------------------------------------------

def downsample2x(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 box downsample, round-half-up: (a+b+c+d+2)//4; floor dims.

    One lax.reduce_window rather than four stride-2 slices.  Integer sum
    + same rounding: bit-exact vs golden/flow.py::downsample2x."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    s = jax.lax.reduce_window(
        img[: 2 * h2, : 2 * w2].astype(jnp.int32), 0, jax.lax.add,
        (2, 2), (2, 2), "VALID")
    return ((s + 2) // 4).astype(img.dtype)


def build_pyramid(img: jnp.ndarray, levels: int):
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2x(pyr[-1]))
    return pyr


def upsample_flow_2x(flow: jnp.ndarray, out_h: int, out_w: int
                     ) -> jnp.ndarray:
    """Nearest-neighbor 2x upsample of (H, W, 2), values x2, edge-extended
    to (out_h, out_w) for odd finer levels.  broadcast_to+reshape, not
    jnp.repeat (repeat lowers as concatenates; measured ~12% slower)."""
    hh, ww, ch = flow.shape
    up = jnp.broadcast_to(flow[:, None, :, None, :],
                          (hh, 2, ww, 2, ch)).reshape(2 * hh, 2 * ww,
                                                      ch) * 2.0
    h, w = up.shape[:2]
    if h < out_h:
        up = jnp.concatenate(
            [up, jnp.repeat(up[-1:], out_h - h, axis=0)], axis=0)
    if w < out_w:
        up = jnp.concatenate(
            [up, jnp.repeat(up[:, -1:], out_w - w, axis=1)], axis=1)
    return up[:out_h, :out_w]


def downsample_flow_2x(flow: jnp.ndarray) -> jnp.ndarray:
    """2x2 box mean of (H, W, 2), values /2 (flow scales with resolution);
    floor dims — the inverse of upsample_flow_2x for the temporal-prior
    pyramid seeding (golden/flow.py mirrors)."""
    h, w = flow.shape[:2]
    h2, w2 = h // 2, w // 2
    # 2x2 blocks via reshape (stride-2 slices relayout; see downsample2x)
    # but accumulated in golden's exact float order ((a+b)+c)+d — a
    # .sum(axis=(1,3)) reassociates to (a+b)+(c+d), which can differ in
    # the last ulp and flip a rint'd window center (bit-parity hazard)
    x = flow[: 2 * h2, : 2 * w2].reshape(h2, 2, w2, 2, flow.shape[2])
    a, b = x[:, 0, :, 0], x[:, 0, :, 1]
    c, d = x[:, 1, :, 0], x[:, 1, :, 1]
    return (a + b + c + d) * 0.125


# --------------------------------------------------------------------------
# 2D-label extraction
# --------------------------------------------------------------------------

def wta_flow(s: jnp.ndarray, radius: int):
    """argmin over labels -> integer (du, dv) offsets + label index."""
    extw = 2 * radius + 1
    l = jnp.argmin(s, axis=-1).astype(jnp.int32)
    du = l % extw - radius
    dv = l // extw - radius
    return du, dv, l


def _parabola(idx, v_m, v_0, v_p, size):
    """Offset from a 3-point parabola fit; golden gating (interior & denom>0)."""
    v_m, v_0, v_p = (x.astype(jnp.float32) for x in (v_m, v_0, v_p))
    interior = (idx > 0) & (idx < size - 1)
    denom = v_m - 2.0 * v_0 + v_p
    ok = interior & (denom > 0)
    off = jnp.where(ok, (v_m - v_p) / jnp.maximum(2.0 * denom, 1e-12), 0.0)
    return jnp.clip(off, -0.5, 0.5) * ok


def subpixel_flow(s: jnp.ndarray, l_int: jnp.ndarray, radius: int):
    """Separable parabola in u (at fixed dv) and v (at fixed du).

    One-hot lane reductions instead of gathers (same rationale as
    ext.neighborhood_of_min: take_along_axis over the label axis is slow)."""
    extw = 2 * radius + 1
    nl = extw * extw
    big = np.int32(1 << 24)
    lane = jnp.arange(nl, dtype=jnp.int32)
    sv = s.astype(jnp.int32)
    l = l_int[..., None]
    iu = l_int % extw
    iv = l_int // extw

    def sel(target):
        return jnp.min(jnp.where(lane == target, sv, big), axis=-1)

    # u neighbors: labels l +- 1 (clipped like golden's iuc indexing)
    iuc = jnp.clip(iu, 1, extw - 2)
    base_u = iv * extw + iuc
    du_off = _parabola(iu, sel(base_u[..., None] - 1),
                       sel(base_u[..., None]),
                       sel(base_u[..., None] + 1), extw)
    # v neighbors: labels l +- ext
    ivc = jnp.clip(iv, 1, extw - 2)
    base_v = ivc * extw + iu
    dv_off = _parabola(iv, sel(base_v[..., None] - extw),
                       sel(base_v[..., None]),
                       sel(base_v[..., None] + extw), extw)
    return du_off, dv_off


def upsample_valid_2x(valid: jnp.ndarray, out_h: int, out_w: int
                      ) -> jnp.ndarray:
    """Nearest-neighbor 2x upsample of a (h2, w2) bool validity plane,
    edge-extended to (out_h, out_w) — the fb_grid='half' merge (each half-
    grid verdict covers its 2x2 full-res block).  golden/flow.py mirrors."""
    up = jnp.repeat(jnp.repeat(valid, 2, axis=0), 2, axis=1)
    h, w = up.shape
    if h < out_h:
        up = jnp.concatenate(
            [up, jnp.repeat(up[-1:], out_h - h, axis=0)], axis=0)
    if w < out_w:
        up = jnp.concatenate(
            [up, jnp.repeat(up[:, -1:], out_w - w, axis=1)], axis=1)
    return up[:out_h, :out_w]


@jax.named_scope("fb_check")
def fb_check(flow_fwd: jnp.ndarray, flow_bwd: jnp.ndarray, max_diff: float
             ) -> jnp.ndarray:
    """(H, W) bool: |F(p) + B(p + round(F(p)))| <= max_diff.

    Returns an explicit validity plane instead of writing an in-range
    sentinel like (-1, -1) into the field (a real leftward flow of exactly
    (-1, -1) would be indistinguishable from an invalidated pixel)."""
    h, w = flow_fwd.shape[:2]
    yy = jnp.arange(h, dtype=jnp.int32)[:, None]
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]
    tx = xx + jnp.rint(flow_fwd[..., 0]).astype(jnp.int32)
    ty = yy + jnp.rint(flow_fwd[..., 1]).astype(jnp.int32)
    inb = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    txc = jnp.clip(tx, 0, w - 1)
    tyc = jnp.clip(ty, 0, h - 1)
    # flattened linear-index take (tools/fbbench.py compares lowerings);
    # values are identical so golden/flow.py needs no mirror
    b = jnp.take(flow_bwd.reshape(h * w, 2), tyc * w + txc, axis=0)
    err = jnp.sqrt((flow_fwd[..., 0] + b[..., 0]) ** 2
                   + (flow_fwd[..., 1] + b[..., 1]) ** 2)
    return inb & (err <= max_diff)


# --------------------------------------------------------------------------
# Per-level core and pyramid driver
# --------------------------------------------------------------------------

def _level_s(img1, cen1, cen2, base_u, base_v, params: FlowParams,
             backend: str, is_coarsest: bool, block_warp: bool = False):
    """Cost volume + 8-path 2D-label aggregation for one level: the batched
    core shared by the single-direction driver and the fwd/bwd lockstep
    pair (vmapping it folds both directions into one launch set)."""
    with jax.named_scope("cost"):
        cost = cost_volume_flow(cen1, cen2, base_u, base_v,
                                params.search_radius, params.invalid_cost,
                                identity_base=is_coarsest,
                                block_warp=block_warp)
    with jax.named_scope("aggregate"):
        return aggregate(cost, img1, DIRS_8, params.p1, params.p2,
                         params.adaptive_p2, backend,
                         s_max=8 * (params.invalid_cost + params.p2),
                         label_ext=params.window_extent)


@jax.named_scope("extract")
def _level_extract(s, base_u, base_v, params: FlowParams):
    """WTA + optional subpixel refinement / median on an aggregated
    (H, W, L) S."""
    du, dv, l_int = wta_flow(s, params.search_radius)
    u = (base_u + du).astype(jnp.float32)
    v = (base_v + dv).astype(jnp.float32)
    if params.subpixel:
        du_off, dv_off = subpixel_flow(s, l_int, params.search_radius)
        u = u + du_off
        v = v + dv_off
    flow = jnp.stack([u, v], axis=-1)
    if params.median_filter:
        flow = jnp.stack([ext.median_filter_3x3(flow[..., 0]),
                          ext.median_filter_3x3(flow[..., 1])], axis=-1)
    return flow


def _flow_one_level(img1, img2, prior_flow, params: FlowParams,
                    backend: str, is_coarsest: bool = False,
                    cen1=None, cen2=None, block_warp: bool = False):
    base_u = jnp.rint(prior_flow[..., 0]).astype(jnp.int32)
    base_v = jnp.rint(prior_flow[..., 1]).astype(jnp.int32)
    if cen1 is None:
        cen1 = census_transform(img1, params.census_window)
    if cen2 is None:
        cen2 = census_transform(img2, params.census_window)
    s = _level_s(img1, cen1, cen2, base_u, base_v, params, backend,
                 is_coarsest, block_warp)
    return _level_extract(s, base_u, base_v, params)


def _flow_level_pair(i1, i2, c1, c2, prior_f, prior_b,
                     params: FlowParams, bwd_params: FlowParams,
                     backend: str, is_coarsest: bool,
                     block_warp: bool = False):
    """One pyramid level of the forward AND backward passes as a single
    batch-2 vmap: both directions share one launch set (the coarse levels
    are dominated by per-launch cost, not element work).  Per-slice
    arithmetic is identical, so bit-exactness vs the unbatched path (and
    golden) is preserved."""
    bu_f = jnp.rint(prior_f[..., 0]).astype(jnp.int32)
    bv_f = jnp.rint(prior_f[..., 1]).astype(jnp.int32)
    bu_b = jnp.rint(prior_b[..., 0]).astype(jnp.int32)
    bv_b = jnp.rint(prior_b[..., 1]).astype(jnp.int32)
    guide = jnp.stack([i1, i2])
    cen_a = jnp.stack([c1, c2])
    cen_b = jnp.stack([c2, c1])
    bu = jnp.stack([bu_f, bu_b])
    bv = jnp.stack([bv_f, bv_b])
    s2 = jax.vmap(lambda g, ca, cb, u, v: _level_s(
        g, ca, cb, u, v, params, backend, is_coarsest, block_warp))(
        guide, cen_a, cen_b, bu, bv)
    if bwd_params == params:
        # identical extraction both ways (full/half modes): batch it too
        fl2 = jax.vmap(lambda s, u, v: _level_extract(s, u, v, params))(
            s2, bu, bv)
        return fl2[0], fl2[1]
    flow_f = _level_extract(s2[0], bu_f, bv_f, params)
    flow_b = _level_extract(s2[1], bu_b, bv_b, bwd_params)
    return flow_f, flow_b


def _fsgm_flow_oneway(pyr1, pyr2, cens1, cens2, params: FlowParams,
                      backend: str, init_flow=None):
    """Coarse-to-fine pass over precomputed pyramids + census descriptors
    (shared between the forward and backward passes — the backward pass
    uses the same two pyramids with roles swapped, so pyramid/census work
    is computed once per image, not once per direction).

    `init_flow` (coarsest-level scale) seeds the pyramid instead of zeros
    (temporal prior for sequence tracking); the coarsest level then runs
    the real warp path instead of the identity-base fast path."""
    flow = (jnp.zeros(pyr1[-1].shape + (2,), dtype=jnp.float32)
            if init_flow is None else init_flow)
    for lvl in range(params.levels - 1, -1, -1):
        i1, i2 = pyr1[lvl], pyr2[lvl]
        below_top = lvl < params.levels - 1
        if below_top:
            flow = upsample_flow_2x(flow, i1.shape[0], i1.shape[1])
        is_c = lvl == params.levels - 1 and init_flow is None
        # below the top the prior is rint(upsample_flow_2x(...)) —
        # 2x2-block-constant, so the warp can use the blocked patch
        # gather (cost.warp_census_blocked, 4x fewer indices, exact)
        flow = _flow_one_level(i1, i2, flow, params, backend,
                               is_coarsest=is_c,
                               cen1=cens1[lvl], cen2=cens2[lvl],
                               block_warp=below_top)
    return flow


def _fsgm_flow_both(pyr1, pyr2, cens1, cens2, params: FlowParams,
                    bwd_final_params: FlowParams, backend: str,
                    bwd_stop: int, init_flow=None):
    """Forward and backward coarse-to-fine passes in lockstep (see
    _flow_level_pair).  The backward pass runs only at pyramid levels
    >= bwd_stop (0 for full/cheap, 1 for half); below that the forward
    pass continues alone.

    Backward levels ABOVE the final one always extract with the full
    `params` (subpixel + median): their output is the next level's prior,
    and dropping either compounds through the 2x upsampling into
    window-edge outlier populations that wreck fb_check (measured: a
    "cheap" mode that skipped both at every backward level kept only
    ~50% of the pixels of a constant-motion pair; keeping them at prior
    levels restores full-mode validity).  Only the FINAL backward level
    (lvl == bwd_stop), whose output feeds nothing but fb_check's rounded
    1 px-tolerance lookup, uses `bwd_final_params`.

    Returns (flow_fwd at full resolution, flow_bwd at level-bwd_stop
    resolution).  `init_flow` (coarsest scale) seeds the forward pyramid
    and its negation the backward pyramid (temporal prior)."""
    shape_c = pyr1[-1].shape
    if init_flow is None:
        flow_f = jnp.zeros(shape_c + (2,), dtype=jnp.float32)
        flow_b = jnp.zeros(shape_c + (2,), dtype=jnp.float32)
    else:
        flow_f, flow_b = init_flow, -init_flow
    for lvl in range(params.levels - 1, -1, -1):
        i1, i2 = pyr1[lvl], pyr2[lvl]
        below_top = lvl < params.levels - 1
        if below_top:
            flow_f = upsample_flow_2x(flow_f, i1.shape[0], i1.shape[1])
            if lvl >= bwd_stop:
                flow_b = upsample_flow_2x(flow_b, i1.shape[0], i1.shape[1])
        is_c = lvl == params.levels - 1 and init_flow is None
        if lvl >= bwd_stop:
            bp = bwd_final_params if lvl == bwd_stop else params
            flow_f, flow_b = _flow_level_pair(
                i1, i2, cens1[lvl], cens2[lvl], flow_f, flow_b,
                params, bp, backend, is_c, block_warp=below_top)
        else:
            flow_f = _flow_one_level(i1, i2, flow_f, params, backend,
                                     is_coarsest=is_c,
                                     cen1=cens1[lvl], cen2=cens2[lvl],
                                     block_warp=below_top)
    return flow_f, flow_b


@functools.partial(jax.jit, static_argnums=(2, 3))
def _flow_fsgm_jit(img1: jnp.ndarray, img2: jnp.ndarray, params: FlowParams,
                   backend: str, prior_flow=None):
    """Full fSGM: (H, W) uint8 pair -> (flow (H, W, 2) float32, valid
    (H, W) bool).

    `valid` is False where the forward-backward check failed; flow values
    at invalid pixels are the unchecked forward estimates (callers mask).

    `prior_flow` (optional full-resolution (H, W, 2)) seeds the coarsest
    pyramid level — the temporal prior for frame sequences (flow between
    consecutive video frames is piecewise-smooth in time, so the previous
    pair's field lets a shallower pyramid track motion far beyond its own
    search range; see flow_sequence)."""
    with jax.named_scope("pyramid"):
        pyr1 = build_pyramid(img1, params.levels)
        pyr2 = build_pyramid(img2, params.levels)
    with jax.named_scope("census"):
        cens1 = [census_transform(x, params.census_window) for x in pyr1]
        cens2 = [census_transform(x, params.census_window) for x in pyr2]
    init = None
    if prior_flow is not None:
        init = prior_flow
        for _ in range(params.levels - 1):
            init = downsample_flow_2x(init)
    if not params.fb_check:
        flow = _fsgm_flow_oneway(pyr1, pyr2, cens1, cens2, params, backend,
                                 init_flow=init)
        return flow, jnp.ones(flow.shape[:2], dtype=bool)
    if params.fb_backward == "single":
        # one backward SGM level at finest resolution: prior is the
        # negated forward flow, so the (2w+1)^2 window independently
        # re-verifies each pixel; no backward pyramid, no subpixel or
        # median (fb_check rounds and tolerates 1 px).  Golden mirrors.
        flow = _fsgm_flow_oneway(pyr1, pyr2, cens1, cens2, params, backend,
                                 init_flow=init)
        bwd_params = dataclasses.replace(
            params, subpixel=False, median_filter=False)
        flow_bwd = _flow_one_level(pyr2[0], pyr1[0], -flow, bwd_params,
                                   backend, cen1=cens2[0], cen2=cens1[0])
    elif params.fb_backward == "half":
        # backward pyramid stops at level 1 (half resolution): the
        # backward flow feeds only fb_check's rounded 1 px-tolerance
        # lookup, so computing it on the half grid (quarter the
        # aggregation work — the full-res backward level dominates the
        # fwd+bwd cost) and 2x-upsampling costs ~0.5 px of lookup
        # precision.  Subpixel/median are KEPT at every backward level:
        # without subpixel the upsampled backward field only takes even
        # integer values, a systematic ~1 px error sitting exactly at the
        # fb tolerance.  Golden mirrors exactly (same integer pyramid +
        # nearest upsample).
        flow, bwd_half = _fsgm_flow_both(pyr1, pyr2, cens1, cens2,
                                         params, params, backend,
                                         bwd_stop=1, init_flow=init)
        if params.fb_grid == "half":
            # check directly on the half grid: the backward field is
            # already there, the forward field box-downsamples; tolerance
            # halves with the pixel size.  Quarter the gather indices.
            valid_h = fb_check(downsample_flow_2x(flow), bwd_half,
                               params.fb_max_diff * 0.5)
            return flow, upsample_valid_2x(valid_h, flow.shape[0],
                                           flow.shape[1])
        flow_bwd = upsample_flow_2x(bwd_half, flow.shape[0], flow.shape[1])
    else:
        bwd_final = params
        if params.fb_backward == "cheap":
            # drop the sub-0.5 px subpixel refinement and median smoothing
            # from the FINAL backward level only (its output feeds nothing
            # but the rounded 1 px-tolerance fb_check); earlier backward
            # levels keep both — they feed priors (see _fsgm_flow_both)
            bwd_final = dataclasses.replace(
                params, subpixel=False, median_filter=False)
        flow, flow_bwd = _fsgm_flow_both(pyr1, pyr2, cens1, cens2,
                                         params, bwd_final, backend,
                                         bwd_stop=0, init_flow=init)
    if params.fb_grid == "half":
        valid_h = fb_check(downsample_flow_2x(flow),
                           downsample_flow_2x(flow_bwd),
                           params.fb_max_diff * 0.5)
        return flow, upsample_valid_2x(valid_h, flow.shape[0],
                                       flow.shape[1])
    valid = fb_check(flow, flow_bwd, params.fb_max_diff)
    return flow, valid


def flow_fsgm(img1: jnp.ndarray, img2: jnp.ndarray, params: FlowParams,
              backend: str = "auto", prior_flow=None):
    """Public fSGM entry; see _flow_fsgm_jit.  The backend is resolved
    outside the jit so the resolved name is the cache key (mirrors
    models/stereo.py)."""
    return _flow_fsgm_jit(img1, img2, params, resolve_backend(backend),
                          prior_flow=prior_flow)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _flow_fsgm_batch_jit(imgs1, imgs2, params: FlowParams, backend: str):
    return jax.vmap(lambda u, v: _flow_fsgm_jit(u, v, params, backend))(
        imgs1, imgs2)


def flow_fsgm_batch(imgs1, imgs2, params: FlowParams,
                    backend: str = "auto"):
    """Batched fSGM over (B, H, W) pairs in ONE dispatch (one vmap over
    the batch); bit-identical to stacking flow_fsgm."""
    return _flow_fsgm_batch_jit(imgs1, imgs2, params,
                                resolve_backend(backend))


def flow_sequence(frames, params: FlowParams, backend: str = "auto",
                  track_params: FlowParams | None = None):
    """fSGM over a frame sequence with temporal priors.

    frames: (N, H, W) uint8 -> (flows (N-1, H, W, 2) f32,
    valids (N-1, H, W) bool), flows[t] = motion frame t -> t+1.

    Pair 0 runs the full `params` pyramid from scratch; every later pair
    seeds its coarsest level with the previous pair's field (and its
    negation for the backward pass), so `track_params` can use a shallower
    pyramid (fewer levels) while tracking motion far beyond its own search
    range — the temporal analog of the coarse-to-fine trick, and the
    reason fSGM-style methods suit driver-assistance video.  Two jit
    signatures total (first pair, tracked pairs), regardless of N."""
    tp = track_params if track_params is not None else params
    flows, valids = [], []
    prev = None
    for t in range(frames.shape[0] - 1):
        if prev is None:
            f, v = flow_fsgm(frames[t], frames[t + 1], params, backend)
        else:
            f, v = flow_fsgm(frames[t], frames[t + 1], tp, backend,
                             prior_flow=prev)
        flows.append(f)
        valids.append(v)
        # seed the next pair with FB-validated flow only: at invalid
        # pixels the field holds the unchecked forward estimate, and
        # feeding those through the downsample chain poisons the next
        # pair's window centers (measured on constant-motion sequences:
        # unmasked seeding made the full-depth pass WORSE than scratch,
        # 1.68 vs 0.21 px mean error; masked seeding restores it)
        prev = jnp.where(v[..., None], f, 0.0)
    return jnp.stack(flows), jnp.stack(valids)
