"""Disparity/flow extraction ops (XLA): WTA, subpixel, LR-check, median.

Reference capability: SURVEY.md §2.1 rows "WTA + subpixel",
"LR-consistency", "Median / post-filter" (MATLAB post-passes there; here
fused XLA elementwise/gather ops so the whole extraction stage compiles into
the same jit as aggregation).
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from fsgm_tpu.params import INVALID


def wta(s: jnp.ndarray) -> jnp.ndarray:
    """argmin over the last (label) axis; ties -> smallest index (matches
    np.argmin)."""
    return jnp.argmin(s, axis=-1).astype(jnp.int32)


def wta_right_from_s(s: jnp.ndarray, s_invalid: int,
                     gx: jnp.ndarray | None = None,
                     w_global: int | None = None) -> jnp.ndarray:
    """Right-view disparity via the S-volume trick (SURVEY.md §2.1):
    d_R(y,x) = argmin_d S(y, x+d, d);  x+d >= W -> s_invalid.

    One gather along x rather than D per-plane (H, W, 1) temporaries.

    gx / w_global: column-tiled mode — s spans an x-extended window whose
    columns sit at GLOBAL positions gx (see parallel/tiled.py); validity
    of x+d is then judged against the global image width, not the window
    end (window-pad S is 0, which would otherwise win every argmin)."""
    h, w, nd = s.shape
    xs = jnp.arange(w, dtype=jnp.int32)[:, None]           # (W, 1)
    ds = jnp.arange(nd, dtype=jnp.int32)[None, :]          # (1, D)
    src = xs + ds                                          # (W, D)
    valid = src < w
    if gx is not None:
        valid = valid & (gx[:, None] + ds < w_global)
    src_c = jnp.clip(src, 0, w - 1)
    diag = jnp.take_along_axis(s, src_c[None, :, :], axis=1)  # S[y, x+d, d]
    diag = jnp.where(valid[None, :, :], diag, s_invalid)
    return jnp.argmin(diag, axis=-1).astype(jnp.int32)


def neighborhood_of_min(s: jnp.ndarray, d_int: jnp.ndarray):
    """(S[d*-1], S[d*], S[d*+1]) as int32 maps, via one-hot lane reductions.

    Three masked min-reductions fuse into a single streaming pass over S
    instead of a take_along_axis gather.  Out-of-range neighbors
    (d*=0 or D-1) come back as the BIG sentinel — callers gate on the
    interior mask exactly like the golden model, so the values are unused.
    """
    nd = s.shape[-1]
    big = np.int32(1 << 24)
    lane = jnp.arange(nd, dtype=jnp.int32)
    d = d_int[..., None]
    sv = s.astype(jnp.int32)
    s_m = jnp.min(jnp.where(lane == d - 1, sv, big), axis=-1)
    s_0 = jnp.min(jnp.where(lane == d, sv, big), axis=-1)
    s_p = jnp.min(jnp.where(lane == d + 1, sv, big), axis=-1)
    return s_m, s_0, s_p


def subpixel_from_neighborhood(d_int, s_m, s_0, s_p, nd: int
                               ) -> jnp.ndarray:
    """Parabola refinement from precomputed (S[d*-1], S[d*], S[d*+1])."""
    s_m, s_0, s_p = (x.astype(jnp.float32) for x in (s_m, s_0, s_p))
    denom = s_m - 2.0 * s_0 + s_p
    interior = (d_int > 0) & (d_int < nd - 1)
    ok = interior & (denom > 0)
    offset = jnp.where(ok, (s_m - s_p) / jnp.maximum(2.0 * denom, 1e-12), 0.0)
    offset = jnp.clip(offset, -0.5, 0.5)
    return d_int.astype(jnp.float32) + jnp.where(ok, offset, 0.0)


def subpixel_refine(s: jnp.ndarray, d_int: jnp.ndarray) -> jnp.ndarray:
    """Quadratic refinement, formula and gating identical to golden:

        d + clip((S[d-1]-S[d+1]) / (2(S[d-1]-2S[d]+S[d+1])), -.5, .5)

    applied where 0 < d < D-1 and denom > 0.  float32.
    """
    nd = s.shape[-1]
    s_m, s_0, s_p = neighborhood_of_min(s, d_int)
    s_m, s_0, s_p = (x.astype(jnp.float32) for x in (s_m, s_0, s_p))
    denom = s_m - 2.0 * s_0 + s_p
    interior = (d_int > 0) & (d_int < nd - 1)
    ok = interior & (denom > 0)
    offset = jnp.where(ok, (s_m - s_p) / jnp.maximum(2.0 * denom, 1e-12), 0.0)
    offset = jnp.clip(offset, -0.5, 0.5)
    return d_int.astype(jnp.float32) + jnp.where(ok, offset, 0.0)


def lr_check(d_left: jnp.ndarray, d_right: jnp.ndarray, max_diff: int = 1,
             max_disp: int | None = None) -> jnp.ndarray:
    """Invalidate where |d_L(x) - d_R(x - round(d_L))| > max_diff -> INVALID.

    The lookup index x - d_L spans only a max_disp-wide window, so the
    gather is expressed as max_disp static shifts + selects.  Negative
    rounded disparities (possible after subpixel at d*=0) fail the check
    exactly as in the golden model (index out of range -> INVALID).
    """
    h, w = d_left.shape
    d_round = jnp.rint(d_left).astype(jnp.int32)
    if max_disp is None:
        max_disp = w
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    ok = jnp.zeros((h, w), dtype=bool)
    for d in range(max_disp):
        # d_right shifted so position x holds d_right[x - d]
        if d == 0:
            shifted = d_right
        else:
            shifted = jnp.concatenate(
                [jnp.zeros((h, d), d_right.dtype), d_right[:, :w - d]],
                axis=1)
        hit = (d_round == d) & (xs >= d) & \
            (jnp.abs(d - shifted) <= max_diff)
        ok = ok | hit
    return jnp.where(ok, d_left, np.float32(INVALID))


def interpolate_invalid(field: jnp.ndarray, max_disp: int | None = None
                        ) -> jnp.ndarray:
    """Fill INVALID pixels by row-wise background interpolation (the KITTI
    devkit convention the reference relies on for dense output): each
    invalid pixel takes the smaller of its nearest valid left/right
    neighbor in the row ("background" disparity — occlusions are filled
    from the farther surface); rows with no valid pixel stay INVALID.

    Expressed as two directional running-value propagations (lax.scan-free:
    log-step doubling along x) so it stays O(W log W) vector ops.
    """
    h, w = field.shape
    valid = field >= 0
    big = np.float32(1e9)

    def propagate(vals, ok, reverse: bool):
        # nearest valid value at or before x (after at or after x)
        v = jnp.where(ok, vals, big)
        idx = jnp.where(ok, jnp.arange(w, dtype=jnp.int32)[None, :],
                        np.int32(-1) if not reverse else np.int32(1 << 30))
        shift = 1
        # doubling trick: carry the most recent valid (value, position)
        while shift < w:
            if not reverse:
                v_s = jnp.concatenate(
                    [jnp.full((h, shift), big), v[:, :-shift]], axis=1)
                i_s = jnp.concatenate(
                    [jnp.full((h, shift), -1, jnp.int32),
                     idx[:, :-shift]], axis=1)
                take = idx < i_s
            else:
                v_s = jnp.concatenate(
                    [v[:, shift:], jnp.full((h, shift), big)], axis=1)
                i_s = jnp.concatenate(
                    [idx[:, shift:],
                     jnp.full((h, shift), 1 << 30, jnp.int32)], axis=1)
                take = idx > i_s
            v = jnp.where(take, v_s, v)
            idx = jnp.where(take, i_s, idx)
            shift *= 2
        return v

    left = propagate(field, valid, reverse=False)
    right = propagate(field, valid, reverse=True)
    fill = jnp.minimum(left, right)          # background wins
    fill = jnp.where(fill >= big, np.float32(INVALID), fill)
    return jnp.where(valid, field, fill)


def median_filter_3x3(field: jnp.ndarray) -> jnp.ndarray:
    """3x3 median, edge-replicate padding; matches golden median exactly
    (median of 9 = 5th order statistic).

    Uses the optimal 19-exchange median-of-9 network (Paeth 1990) as pure
    elementwise min/max — cheaper than a full sort and bit-identical to it
    for the median element."""
    h, w = field.shape
    padded = jnp.pad(field, 1, mode="edge")
    v = [jax.lax.dynamic_slice(padded, (dy, dx), (h, w))
         for dy in range(3) for dx in range(3)]

    def sort2(i, j):
        lo = jnp.minimum(v[i], v[j])
        hi = jnp.maximum(v[i], v[j])
        v[i], v[j] = lo, hi

    for i, j in [(1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2),
                 (4, 5), (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4),
                 (2, 5), (4, 7), (4, 2), (6, 4), (4, 2)]:
        sort2(i, j)
    return v[4]
