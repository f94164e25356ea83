"""SGM path aggregation in pure JAX (XLA `lax.scan` path).

This is the reference's native hot core (SURVEY.md §2.1 "SGM path
aggregation", C++/MEX there) re-expressed as XLA scans:

  * ONE canonical row-scan implements all 16 directions.  Horizontal
    directions transpose the volume (direction (0,dx) on the transpose is
    (dx,0)); negative dy flips the y axis.  The sequential axis is
    `lax.scan` over rows; everything else (scanline x, disparity d) is
    vectorized within each step (375x128 ≈ 48K elements at KITTI size).
  * Knight-move directions (|dy|=2 or |dx|=2, the 16-path extension) fall
    out of the same kernel: the carry holds the last TWO L rows and the
    predecessor row is x-shifted by dx ∈ {-2..2}.
  * Integer discipline (SURVEY.md §7.3 item 5): int32 compute, values
    bounded by Cmax+P2 per path, exact vs the golden model.
  * The label-space neighbor min is pluggable: 1D (stereo disparity) or 2D
    grid (fSGM flow labels), mirroring golden/sgm.py.

This module is the platform-independent implementation, the reference the
GPU kernel (ops/aggregate_triton.py) is tested against, and the carry API
that tiled execution (parallel/tiled.py) uses.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import jax
import numpy as np
import jax.numpy as jnp

INF32 = np.int32(1 << 28)  # addable headroom in int32


def neighbor_min_1d(prev: jnp.ndarray, p1: int) -> jnp.ndarray:
    """min over disparity neighbors d±1, +P1.  prev: (..., D) int32."""
    shift_minus = jnp.concatenate(
        [jnp.full(prev.shape[:-1] + (1,), INF32), prev[..., :-1]], axis=-1)
    shift_plus = jnp.concatenate(
        [prev[..., 1:], jnp.full(prev.shape[:-1] + (1,), INF32)], axis=-1)
    return jnp.minimum(shift_minus, shift_plus) + np.int32(p1)


def make_neighbor_min_2d(radius: int) -> Callable:
    """min over the 4-neighborhood of the (2w+1)x(2w+1) label grid, +P1."""
    ext = 2 * radius + 1

    def neighbor_min_2d(prev: jnp.ndarray, p1: int) -> jnp.ndarray:
        lead = prev.shape[:-1]
        g = prev.reshape(lead + (ext, ext))
        inf_row = jnp.full(lead + (1, ext), INF32)
        inf_col = jnp.full(lead + (ext, 1), INF32)
        up = jnp.concatenate([inf_row, g[..., :-1, :]], axis=-2)
        down = jnp.concatenate([g[..., 1:, :], inf_row], axis=-2)
        left = jnp.concatenate([inf_col, g[..., :, :-1]], axis=-1)
        right = jnp.concatenate([g[..., :, 1:], inf_col], axis=-1)
        m = jnp.minimum(jnp.minimum(up, down), jnp.minimum(left, right))
        return m.reshape(lead + (ext * ext,)) + np.int32(p1)

    return neighbor_min_2d


def _shift_x(row: jnp.ndarray, dx: int, fill) -> jnp.ndarray:
    """Shift a (W, D) row by dx along W, filling vacated entries."""
    if dx == 0:
        return row
    w = row.shape[0]
    if abs(dx) >= w:                 # every predecessor is off the image
        return jnp.full(row.shape, fill, dtype=row.dtype)
    pad = jnp.full((abs(dx),) + row.shape[1:], fill, dtype=row.dtype)
    if dx > 0:
        return jnp.concatenate([pad, row[: w - dx]], axis=0)
    return jnp.concatenate([row[-dx:], pad], axis=0)


def _p2_effective(img: jnp.ndarray, img_prev2: jnp.ndarray | None,
                  dy: int, dx: int, valid: jnp.ndarray,
                  p1: int, p2: int, adaptive: bool) -> jnp.ndarray:
    """(H, W) int32 effective P2 per pixel for direction (dy, dx), dy>0.

    Matches golden/sgm.py::_p2_effective: max(P1+1, P2 // max(1,|dI|)),
    P2 where the predecessor is invalid.  `img_prev2` optionally provides the
    two image rows ABOVE the tile (canonical scan order: [y=-2, y=-1]) so
    that tiled continuation sees the true cross-tile gradient; without it the
    first dy rows use a placeholder (harmless: a zero init carry makes the
    recurrence degenerate to L=C there regardless of P2).
    """
    if not adaptive:
        return jnp.full(img.shape, p2, dtype=jnp.int32)
    img = img.astype(jnp.int32)
    h, w = img.shape
    if img_prev2 is None:
        img_prev2 = jnp.zeros((2, w), dtype=jnp.int32)
    ext = jnp.concatenate([img_prev2.astype(jnp.int32), img], axis=0)
    pred = jax.lax.dynamic_slice_in_dim(ext, 2 - dy, h, axis=0)
    pred = jnp.roll(pred, dx, axis=1)
    diff = jnp.maximum(jnp.abs(img - pred), 1)
    out = jnp.maximum(np.int32(p1 + 1), np.int32(p2) // diff)
    return jnp.where(valid, out, np.int32(p2))


def _valid_mask(h: int, w: int, dx: int) -> jnp.ndarray:
    """(H, W) bool: predecessor x - dx inside the image.

    Row validity (y >= dy) is NOT encoded here: the zero init carry makes
    the recurrence yield L=C on rows with no predecessor (min over an
    all-zero prev row is 0, so C + 0 - 0), exactly the golden first-row
    semantics — and a real carry from an upstream tile makes those same rows
    continue the scan seamlessly."""
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]
    return jnp.broadcast_to((xx - dx >= 0) & (xx - dx < w), (h, w))


def aggregate_one_path(cost: jnp.ndarray, img: jnp.ndarray,
                       direction: Tuple[int, int], p1: int, p2: int,
                       adaptive_p2: bool = False,
                       neighbor_min: Callable = neighbor_min_1d,
                       init_carry: jnp.ndarray | None = None,
                       img_prev2: jnp.ndarray | None = None,
                       return_carry: bool = False):
    """L_r for one path direction; exact match to golden aggregate_one_path.

    cost: (H, W, D) integer; img: (H, W).  Returns (H, W, D) int32.

    init_carry / img_prev2 / return_carry expose the scan boundary state for
    tiled (halo-wavefront) execution: the carry is the last two L rows in the
    CANONICALIZED frame (dy>0 row scan), shape (2, W, D) int32, row 0 = most
    recent.  A zero carry is the neutral element (start-of-image semantics);
    a real carry continues the scan across a tile boundary.  img_prev2 is
    the matching (2, W) image halo [y=-2, y=-1] for adaptive P2.
    """
    dy, dx = direction
    if dy == 0:
        # horizontal: transpose to a row scan
        out = aggregate_one_path(
            jnp.swapaxes(cost, 0, 1), img.T, (dx, 0), p1, p2, adaptive_p2,
            neighbor_min, init_carry, img_prev2, return_carry)
        if return_carry:
            out, carry = out
            return jnp.swapaxes(out, 0, 1), carry
        return jnp.swapaxes(out, 0, 1)
    if dy < 0:
        # flip y so the scan runs top->bottom
        out = aggregate_one_path(
            cost[::-1], img[::-1], (-dy, dx), p1, p2, adaptive_p2,
            neighbor_min, init_carry, img_prev2, return_carry)
        if return_carry:
            out, carry = out
            return out[::-1], carry
        return out[::-1]

    h, w, nd = cost.shape
    # keep the big volume in its compact dtype (u8) in HBM; cast per-row
    # inside the scan step
    valid = _valid_mask(h, w, dx)
    p2e = _p2_effective(img, img_prev2, dy, dx, valid, p1, p2, adaptive_p2)
    p1_32 = np.int32(p1)

    if init_carry is None:
        carry0 = jnp.zeros((2, w, nd), dtype=jnp.int32)
    else:
        carry0 = init_carry

    def step(carry, xs):
        cost_row, p2e_row, valid_row = xs
        cost_row = cost_row.astype(jnp.int32)
        prev = _shift_x(carry[dy - 1], dx, INF32)          # (W, D)
        m = jnp.min(prev, axis=-1, keepdims=True)          # (W, 1)
        best = jnp.minimum(jnp.minimum(prev, neighbor_min(prev, p1_32)),
                           m + p2e_row[:, None])
        l_row = jnp.where(valid_row[:, None], cost_row + best - m, cost_row)
        new_carry = jnp.stack([l_row, carry[0]], axis=0)
        # L <= Cmax + P2 < 2^15 by SGMParams validation: emit compact i16
        return new_carry, l_row.astype(jnp.int16)

    carry_out, l_all = jax.lax.scan(
        step, carry0, (cost, p2e, valid))
    if return_carry:
        return l_all, carry_out
    return l_all


def _family_scan(cost: jnp.ndarray, img: jnp.ndarray,
                 fam: Sequence[Tuple[int, int]], p1: int, p2: int,
                 adaptive_p2: bool, neighbor_min: Callable) -> jnp.ndarray:
    """One lax.scan computing SUM of L_r over a whole downward family
    (all dy > 0; 3 dirs at 8 paths, 7 with the knight moves).

    vs one scan per direction this reads the cost volume once per FAMILY
    and never materializes per-direction L volumes (the summed row is the
    only output), cutting the XLA path's HBM traffic roughly 35% while
    producing bit-identical values (each direction keeps its own carry
    rows and per-pixel arithmetic).  Per-direction math matches
    aggregate_one_path exactly."""
    h, w, nd = cost.shape
    p1_32 = np.int32(p1)
    valids = jnp.stack([_valid_mask(h, w, dx) for _, dx in fam])   # (n,H,W)
    p2es = jnp.stack([
        _p2_effective(img, None, dy, dx, v, p1, p2, adaptive_p2)
        for (dy, dx), v in zip(fam, valids)])                      # (n,H,W)
    # pytree carry: one (2, W, D) state per direction (a stacked
    # (n, 2, W, D) tensor forces whole-array updates per step)
    carry0 = tuple(jnp.zeros((2, w, nd), dtype=jnp.int32) for _ in fam)

    def step(carry, xs):
        cost_row, p2e_rows, valid_rows = xs
        cost_row = cost_row.astype(jnp.int32)
        s_row = jnp.zeros((w, nd), dtype=jnp.int32)
        new_carry = []
        for i, (dy, dx) in enumerate(fam):
            prev = _shift_x(carry[i][dy - 1], dx, INF32)
            m = jnp.min(prev, axis=-1, keepdims=True)
            best = jnp.minimum(
                jnp.minimum(prev, neighbor_min(prev, p1_32)),
                m + p2e_rows[i][:, None])
            l_row = jnp.where(valid_rows[i][:, None],
                              cost_row + best - m, cost_row)
            s_row = s_row + l_row
            new_carry.append(jnp.stack([l_row, carry[i][0]], axis=0))
        # family sum fits u16: params validation bounds 8*(Cmax+P2) < 2^16
        # and a family holds at most 7 directions — halves output traffic
        return tuple(new_carry), s_row.astype(jnp.uint16)

    _, s = jax.lax.scan(
        step, carry0,
        (cost, jnp.moveaxis(p2es, 1, 0), jnp.moveaxis(valids, 1, 0)))
    return s.astype(jnp.int32)


def aggregate_paths(cost: jnp.ndarray, img: jnp.ndarray,
                    dirs: Sequence[Tuple[int, int]], p1: int, p2: int,
                    adaptive_p2: bool = False,
                    neighbor_min: Callable = neighbor_min_1d) -> jnp.ndarray:
    """S = sum_r L_r, int32.  (SURVEY.md §3.1 HOT #1.)

    Directions are grouped into the four canonical families (down, up,
    right, left — up flips y, horizontals transpose), each as ONE fused
    scan (_family_scan): bit-exact vs summing aggregate_one_path over the
    directions (tests cover both) with one read of the cost volume per
    family instead of per direction.  The per-direction carry API for
    tiled execution lives in aggregate_one_path."""
    s = jnp.zeros(cost.shape, dtype=jnp.int32)
    down = [(dy, dx) for dy, dx in dirs if dy > 0]
    up = [(-dy, dx) for dy, dx in dirs if dy < 0]
    right = [(dx, dy) for dy, dx in dirs if dy == 0 and dx > 0]
    left = [(-dx, dy) for dy, dx in dirs if dy == 0 and dx < 0]
    if down:
        s = s + _family_scan(cost, img, down, p1, p2, adaptive_p2,
                             neighbor_min)
    if up:
        s = s + _family_scan(cost[::-1], img[::-1], up, p1, p2,
                             adaptive_p2, neighbor_min)[::-1]
    if right:
        st = _family_scan(jnp.swapaxes(cost, 0, 1), img.T, right, p1, p2,
                          adaptive_p2, neighbor_min)
        s = s + jnp.swapaxes(st, 0, 1)
    if left:
        st = _family_scan(jnp.swapaxes(cost, 0, 1)[::-1], img.T[::-1],
                          left, p1, p2, adaptive_p2, neighbor_min)[::-1]
        s = s + jnp.swapaxes(st, 0, 1)
    return s
