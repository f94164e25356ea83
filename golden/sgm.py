"""Golden NumPy SGM stereo model — the exact-integer parity oracle.

Implements every stage of the reference pipeline (SURVEY.md §2.1 inventory):
census transform, Hamming cost volume, multi-direction scanline DP
aggregation (8/16 paths, optional adaptive P2), WTA, quadratic subpixel,
LR-consistency via the S-volume trick, and 3x3 median filter.

Design rules:
  * Integer arithmetic (int64 internally) from census through S, so any device
    kernel bug is a hard mismatch, not an epsilon (SURVEY.md §4).
  * Vectorized over scanline x disparity; only the sequential DP axis is a
    Python loop, mirroring the recurrence structure in SURVEY.md §3.3.
  * Deliberately boring: clarity over speed.

The SGM recurrence (Hirschmueller PAMI 2008, eq. 13), per path direction r:

    L_r(p, d) = C(p, d) + min( L_r(p-r, d),
                               L_r(p-r, d-1) + P1,
                               L_r(p-r, d+1) + P1,
                               min_k L_r(p-r, k) + P2' ) - min_k L_r(p-r, k)

with L_r(p, d) = C(p, d) where p - r falls outside the image, and
P2' = max(P1+1, P2 // max(1, |I(p) - I(p-r)|)) when adaptive_p2 is on.
"""

from __future__ import annotations

import numpy as np

from fsgm_tpu.params import SGMParams, INVALID

INF = np.int64(1) << 40  # safely addable without overflow in int64


# --------------------------------------------------------------------------
# Census transform
# --------------------------------------------------------------------------

def census_transform(img: np.ndarray, window=(5, 5)) -> np.ndarray:
    """Census transform: per-pixel bitstring comparing window pixels to center.

    Returns uint64 descriptors, one bit per non-center window pixel
    (bit = 1 where neighbor < center; strict less, ties -> 0).  Pixels whose
    window leaves the image use edge-replicated padding.
    """
    img = np.asarray(img)
    assert img.ndim == 2, "grayscale image expected"
    ch, cw = window
    ry, rx = ch // 2, cw // 2
    padded = np.pad(img, ((ry, ry), (rx, rx)), mode="edge").astype(np.int64)
    h, w = img.shape
    center = img.astype(np.int64)
    out = np.zeros((h, w), dtype=np.uint64)
    bit = 0
    for dy in range(-ry, ry + 1):
        for dx in range(-rx, rx + 1):
            if dy == 0 and dx == 0:
                continue
            neighbor = padded[ry + dy : ry + dy + h, rx + dx : rx + dx + w]
            out |= (neighbor < center).astype(np.uint64) << np.uint64(bit)
            bit += 1
    return out


def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Popcount of XOR; uint64 in, int64 out."""
    return np.bitwise_count(a ^ b).astype(np.int64)


# --------------------------------------------------------------------------
# Cost volume
# --------------------------------------------------------------------------

def cost_volume_stereo(cen_l: np.ndarray, cen_r: np.ndarray,
                       max_disp: int, invalid_cost: int = 255) -> np.ndarray:
    """C[y, x, d] = hamming(cenL[y,x], cenR[y,x-d]); x-d < 0 -> invalid_cost.

    Returns int64 (values fit u8).
    """
    h, w = cen_l.shape
    c = np.full((h, w, max_disp), int(invalid_cost), dtype=np.int64)
    for d in range(max_disp):
        if d >= w:
            break
        c[:, d:, d] = hamming(cen_l[:, d:], cen_r[:, : w - d])
    return c


def cost_volume_stereo_right(cen_l: np.ndarray, cen_r: np.ndarray,
                             max_disp: int, invalid_cost: int = 255
                             ) -> np.ndarray:
    """Right-reference volume: C_R[y,x,d] = hamming(cenR[y,x], cenL[y,x+d]);
    x+d >= W -> invalid_cost.  Input to lr_mode='reagg'."""
    h, w = cen_l.shape
    c = np.full((h, w, max_disp), int(invalid_cost), dtype=np.int64)
    for d in range(max_disp):
        if d >= w:
            break
        c[:, : w - d, d] = hamming(cen_r[:, : w - d], cen_l[:, d:])
    return c


# --------------------------------------------------------------------------
# Path aggregation
# --------------------------------------------------------------------------

def neighbor_min_1d(prev: np.ndarray, p1: int) -> np.ndarray:
    """min over the 1D disparity neighbors d+-1, plus P1.  prev: (N, D)."""
    n, _ = prev.shape
    shift_minus = np.concatenate(
        [np.full((n, 1), INF, dtype=np.int64), prev[:, :-1]], axis=1)
    shift_plus = np.concatenate(
        [prev[:, 1:], np.full((n, 1), INF, dtype=np.int64)], axis=1)
    return np.minimum(shift_minus, shift_plus) + p1


def _recurrence(prev: np.ndarray, cost: np.ndarray, valid: np.ndarray,
                p1: int, p2_eff: np.ndarray, neighbor_min=neighbor_min_1d
                ) -> np.ndarray:
    """One DP step, vectorized over (n_scanlines, D).

    prev:   (N, D) int64, predecessor L values (garbage where ~valid)
    cost:   (N, D) int64
    valid:  (N,) bool — predecessor inside the image
    p2_eff: (N,) int64 — effective P2 per scanline position
    neighbor_min: min over P1-neighbors in label space, +P1 included
                  (1D for stereo disparities, 2D grid for flow labels)
    """
    m = prev.min(axis=1)                                   # (N,)
    best = np.minimum(
        np.minimum(prev, neighbor_min(prev, p1)),
        (m + p2_eff)[:, None])
    l_val = cost + best - m[:, None]
    return np.where(valid[:, None], l_val, cost)


def _p2_effective(img_cur: np.ndarray, img_prev: np.ndarray,
                  valid: np.ndarray, p1: int, p2: int,
                  adaptive: bool) -> np.ndarray:
    """Adaptive P2' per SURVEY.md §2.1: max(P1+1, P2 // max(1, |dI|))."""
    if not adaptive:
        return np.full(img_cur.shape, p2, dtype=np.int64)
    diff = np.abs(img_cur.astype(np.int64) - img_prev.astype(np.int64))
    diff = np.maximum(diff, 1)
    out = np.maximum(p1 + 1, p2 // diff)
    return np.where(valid, out, p2)


def aggregate_one_path(cost: np.ndarray, img: np.ndarray, direction,
                       p1: int, p2: int, adaptive_p2: bool = False,
                       neighbor_min=neighbor_min_1d) -> np.ndarray:
    """Aggregate along one path direction r=(dy,dx); returns L_r, int64.

    Traversal: directions with dy != 0 iterate over rows (row y depends only
    on row y-|dy|, so each row is computed vectorized over x and d);
    horizontal directions (dy == 0) iterate over columns, vectorized over y.
    Supports |dy|,|dx| <= 2 (covers the 16-path set).
    """
    dy, dx = direction
    h, w, nd = cost.shape
    img = img.astype(np.int64)
    l_out = np.zeros_like(cost)

    if dy == 0:
        assert dx != 0
        xs = range(w) if dx > 0 else range(w - 1, -1, -1)
        step = abs(dx)
        for i, x in enumerate(xs):
            if i < step:
                l_out[:, x, :] = cost[:, x, :]
                continue
            xp = x - dx
            prev = l_out[:, xp, :]
            valid = np.ones(h, dtype=bool)
            p2e = _p2_effective(img[:, x], img[:, xp], valid, p1, p2, adaptive_p2)
            l_out[:, x, :] = _recurrence(prev, cost[:, x, :], valid, p1, p2e,
                                         neighbor_min)
        return l_out

    # dy != 0: iterate rows.
    ys = range(h) if dy > 0 else range(h - 1, -1, -1)
    ady = abs(dy)
    for i, y in enumerate(ys):
        if i < ady:
            l_out[y] = cost[y]
            continue
        yp = y - dy
        # predecessor row shifted by dx in x, INF-padded
        prev = np.full((w, nd), INF, dtype=np.int64)
        img_prev = np.zeros(w, dtype=np.int64)
        valid = np.zeros(w, dtype=bool)
        if dx == 0:
            prev[:] = l_out[yp]
            img_prev[:] = img[yp]
            valid[:] = True
        elif dx > 0:
            prev[dx:] = l_out[yp, :-dx]
            img_prev[dx:] = img[yp, :-dx]
            valid[dx:] = True
        else:
            prev[:dx] = l_out[yp, -dx:]
            img_prev[:dx] = img[yp, -dx:]
            valid[:dx] = True
        p2e = _p2_effective(img[y], img_prev, valid, p1, p2, adaptive_p2)
        l_out[y] = _recurrence(prev, cost[y], valid, p1, p2e, neighbor_min)
    return l_out


def aggregate_paths(cost: np.ndarray, img: np.ndarray, params: SGMParams
                    ) -> np.ndarray:
    """S = sum over the path set of L_r (SURVEY.md §3.1)."""
    s = np.zeros_like(cost)
    for r in params.dirs:
        s += aggregate_one_path(cost, img, r, params.p1, params.p2,
                                params.adaptive_p2)
    return s


# --------------------------------------------------------------------------
# Extraction: WTA, subpixel, LR, median
# --------------------------------------------------------------------------

def wta(s: np.ndarray) -> np.ndarray:
    """argmin over d; ties -> smallest d (np.argmin convention)."""
    return np.argmin(s, axis=2).astype(np.int64)


def wta_right_from_S(s: np.ndarray, invalid_cost_sum: int) -> np.ndarray:
    """Right-image disparity via the S-volume trick (SURVEY.md §2.1):

        d_R(y, x) = argmin_d S(y, x + d, d)

    Positions with x + d >= W contribute invalid_cost_sum.
    """
    h, w, nd = s.shape
    diag = np.full((h, w, nd), int(invalid_cost_sum), dtype=s.dtype)
    for d in range(nd):
        if d >= w:
            break
        diag[:, : w - d, d] = s[:, d:, d]
    return np.argmin(diag, axis=2).astype(np.int64)


def subpixel_refine(s: np.ndarray, d_int: np.ndarray) -> np.ndarray:
    """Quadratic (parabola) refinement around the integer WTA minimum.

        d_sub = d + (S[d-1] - S[d+1]) / (2 * (S[d-1] - 2 S[d] + S[d+1]))

    Applied only where 0 < d < D-1 and the denominator > 0; elsewhere d.
    """
    h, w, nd = s.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d = d_int
    interior = (d > 0) & (d < nd - 1)
    dc = np.clip(d, 1, nd - 2)
    s_m = s[yy, xx, dc - 1].astype(np.float64)
    s_0 = s[yy, xx, dc].astype(np.float64)
    s_p = s[yy, xx, dc + 1].astype(np.float64)
    denom = s_m - 2.0 * s_0 + s_p
    ok = interior & (denom > 0)
    offset = np.where(ok, (s_m - s_p) / np.maximum(2.0 * denom, 1e-12), 0.0)
    offset = np.clip(offset, -0.5, 0.5)
    return d.astype(np.float64) + np.where(ok, offset, 0.0)


def lr_check(d_left: np.ndarray, d_right: np.ndarray, max_diff: int = 1
             ) -> np.ndarray:
    """Invalidate d_L where |d_L(x) - d_R(x - round(d_L(x)))| > max_diff.

    d_left may be subpixel (float); the lookup index uses the rounded value.
    Returns float field with INVALID (-1) at failed pixels.
    """
    h, w = d_left.shape
    d_round = np.rint(d_left).astype(np.int64)
    xs = np.arange(w)[None, :] - d_round
    valid_idx = (xs >= 0) & (xs < w)
    xs_c = np.clip(xs, 0, w - 1)
    yy = np.arange(h)[:, None]
    d_r = d_right[yy, xs_c]
    ok = valid_idx & (np.abs(d_round - d_r) <= max_diff)
    return np.where(ok, d_left, INVALID)


def median_filter_3x3(field: np.ndarray) -> np.ndarray:
    """3x3 median with edge-replicate padding.

    Invalid pixels (== INVALID) participate as-is: the median of a
    neighborhood that is mostly valid repairs isolated invalid pixels
    (the reference's invalid-pixel interpolation role, SURVEY.md §2.1),
    while solidly-invalid regions stay INVALID.
    """
    padded = np.pad(field, 1, mode="edge")
    h, w = field.shape
    stack = np.empty((9, h, w), dtype=field.dtype)
    k = 0
    for dy in range(3):
        for dx in range(3):
            stack[k] = padded[dy : dy + h, dx : dx + w]
            k += 1
    stack.sort(axis=0)
    return stack[4]




def interpolate_invalid(field: np.ndarray) -> np.ndarray:
    """Row-wise background fill of INVALID pixels (KITTI devkit style):
    an invalid pixel takes min(nearest valid left, nearest valid right);
    rows with no valid pixel stay INVALID."""
    out = field.copy()
    h, w = field.shape
    for y in range(h):
        row = field[y]
        valid_x = np.flatnonzero(row >= 0)
        if valid_x.size == 0:
            continue
        for x in np.flatnonzero(row < 0):
            li = valid_x[valid_x < x]
            ri = valid_x[valid_x > x]
            cands = []
            if li.size:
                cands.append(row[li[-1]])
            if ri.size:
                cands.append(row[ri[0]])
            out[y, x] = min(cands)
    return out


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------

def sgm_stereo(img_l: np.ndarray, img_r: np.ndarray, params: SGMParams,
               return_intermediates: bool = False):
    """Full golden stereo pipeline (call stack mirrors SURVEY.md §3.1)."""
    cen_l = census_transform(img_l, params.census_window)
    cen_r = census_transform(img_r, params.census_window)
    cost = cost_volume_stereo(cen_l, cen_r, params.max_disp,
                              params.invalid_cost)
    s = aggregate_paths(cost, img_l, params)
    d_int = wta(s)
    disp = d_int.astype(np.float64)
    if params.subpixel:
        disp = subpixel_refine(s, d_int)
    if params.lr_check:
        if params.lr_mode == "reagg":
            # true right-reference re-aggregation (SURVEY.md §2.1 / §7.1
            # M3): full SGM over the right volume, guided by the right
            # image — exact LR symmetry at 2x aggregation cost
            cost_r = cost_volume_stereo_right(cen_l, cen_r, params.max_disp,
                                              params.invalid_cost)
            s_r = aggregate_paths(cost_r, img_r, params)
            d_right = wta(s_r)
        else:
            d_right = wta_right_from_S(s, params.s_invalid)
        disp = lr_check(disp, d_right, params.lr_max_diff)
    if params.median_filter:
        disp = median_filter_3x3(disp)
    if params.fill_invalid:
        disp = interpolate_invalid(disp)
    if return_intermediates:
        return disp, dict(census_l=cen_l, census_r=cen_r, cost=cost, S=s,
                          d_int=d_int)
    return disp
