"""Cost-volume builders (XLA path).

Stereo: C[y,x,d] = hamming(cenL[y,x], cenR[y,x-d]), x-d<0 -> invalid_cost.
Flow:   C[y,x,l] over a (2w+1)^2 label window centered on per-pixel rounded
        prior flow; out-of-bounds targets -> invalid_cost.

Reference capability: SURVEY.md §2.1 "Matching cost / cost volume" (C++/MEX
builder in the reference; here the builder is expressed as D shifted
XOR-popcounts that XLA fuses; the u8 HBM-resident layout is produced by
casting at the end, per SURVEY.md layer L1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fsgm_tpu.ops.census import hamming


def cost_volume_stereo(cen_l: jnp.ndarray, cen_r: jnp.ndarray,
                       max_disp: int, invalid_cost: int = 255
                       ) -> jnp.ndarray:
    """Returns (H, W, D) uint8 cost volume.

    Built as ONE gather of the right descriptors at x-d plus a broadcast
    XOR/popcount that XLA fuses into one elementwise pass (no D separate
    (H, W, 1) temporaries).
    """
    h, w, n_words = cen_l.shape
    xs = jnp.arange(w, dtype=jnp.int32)[:, None]           # (W, 1)
    ds = jnp.arange(max_disp, dtype=jnp.int32)[None, :]    # (1, D)
    src = xs - ds                                          # (W, D)
    valid = src >= 0
    src_c = jnp.clip(src, 0, w - 1)
    # gather: (H, W, D, n_words)
    cen_r_g = cen_r[:, src_c, :]
    ham = hamming(cen_l[:, :, None, :], cen_r_g)           # (H, W, D) int32
    c = jnp.where(valid[None, :, :], ham, invalid_cost)
    return c.astype(jnp.uint8)


def cost_volume_stereo_right(cen_l: jnp.ndarray, cen_r: jnp.ndarray,
                             max_disp: int, invalid_cost: int = 255
                             ) -> jnp.ndarray:
    """(H, W, D) uint8 RIGHT-reference cost volume:
    C_R[y,x,d] = hamming(cenR[y,x], cenL[y,x+d]); x+d >= W -> invalid_cost.

    Used by lr_mode='reagg' (SURVEY.md §2.1 LR-consistency: "re-aggregate
    or S-volume trick" — this is the re-aggregate input)."""
    h, w, n_words = cen_l.shape
    xs = jnp.arange(w, dtype=jnp.int32)[:, None]           # (W, 1)
    ds = jnp.arange(max_disp, dtype=jnp.int32)[None, :]    # (1, D)
    src = xs + ds                                          # (W, D)
    valid = src < w
    src_c = jnp.clip(src, 0, w - 1)
    cen_l_g = cen_l[:, src_c, :]
    ham = hamming(cen_r[:, :, None, :], cen_l_g)           # (H, W, D) int32
    c = jnp.where(valid[None, :, :], ham, invalid_cost)
    return c.astype(jnp.uint8)


def warp_census_blocked(cen2: jnp.ndarray, base_u: jnp.ndarray,
                        base_v: jnp.ndarray) -> jnp.ndarray:
    """cen2w[y, x] = cen2[y + base_v[y, x], x + base_u[y, x]] for base
    fields that are CONSTANT over 2x2 pixel blocks aligned at even
    coordinates — exactly what rint(upsample_flow_2x(coarser)) produces
    (the 2x nearest upsample repeats each coarse value over a 2x2 block;
    the odd-edge extension repeats the last row/col, which is still
    block-constant for the 1-wide edge blocks).

    Gathering ONE 2x2 patch per block instead of one word per pixel
    quarters the number of gather indices.

    Out-of-range positions return arbitrary (pad/clipped) values exactly
    like the clipped per-pixel gather; callers mask with the same
    in-range predicate either way, so masked planes are bit-identical.
    """
    h, w = base_u.shape
    h2, w2 = cen2.shape[:2]
    hb, wb = -(-h // 2), -(-w // 2)
    tail = cen2.shape[2:]
    # patch starts live in [-1, h2] x [-1, w2]: +1 shift indexes a
    # 1-top/left, 2-bottom/right padded copy so both patch rows/cols of
    # any clipped start are in bounds (values under the pad are masked by
    # the caller's ok predicate)
    p = jnp.pad(cen2, ((1, 2), (1, 2)) + ((0, 0),) * (cen2.ndim - 2))
    views = [p[dy:dy + h2 + 2, dx:dx + w2 + 2]
             for dy in (0, 1) for dx in (0, 1)]
    tbl = jnp.stack([v.reshape(((h2 + 2) * (w2 + 2),) + tail)
                     for v in views], axis=1)        # (N, 4) + tail
    yy = 2 * jnp.arange(hb, dtype=jnp.int32)[:, None]
    xx = 2 * jnp.arange(wb, dtype=jnp.int32)[None, :]
    sy = jnp.clip(yy + base_v[0::2, 0::2], -1, h2) + 1
    sx = jnp.clip(xx + base_u[0::2, 0::2], -1, w2) + 1
    g = jnp.take(tbl, sy * (w2 + 2) + sx, axis=0)    # (hb, wb, 4) + tail
    g = g.reshape((hb, wb, 2, 2) + tail)
    g = jnp.transpose(g, (0, 2, 1, 3) + tuple(range(4, g.ndim)))
    return g.reshape((2 * hb, 2 * wb) + tail)[:h, :w]


def _flow_cost_planes(cen1: jnp.ndarray, cen2: jnp.ndarray,
                      base_u: jnp.ndarray, base_v: jnp.ndarray,
                      radius: int, invalid_cost: int,
                      y_offset: int | jnp.ndarray,
                      identity_base: bool,
                      block_warp: bool = False) -> list[jnp.ndarray]:
    """The (2w+1)^2 shifted-hamming planes of the flow cost volume; label
    order l = (dv+w)*(2w+1)+(du+w)."""
    h, w = cen1.shape[:2]
    h2 = cen2.shape[0]
    hb = base_u.shape[0]             # h (untiled) or h + 2*halo (tiled)
    halo = (hb - h) // 2
    yy = jnp.arange(hb, dtype=jnp.int32)[:, None] - halo + y_offset
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]
    sy = yy + base_v
    sx = xx + base_u
    if identity_base:
        # coarsest pyramid level: the prior flow is identically zero, so
        # the per-pixel warp gather is skipped;
        # cen2w rows are just cen2 at the tile's global rows (zero rows
        # outside — masked invalid by ok_w anyway)
        ok_w = jnp.broadcast_to((yy >= 0) & (yy < h2), (hb, w))
        if hb == h2 and isinstance(y_offset, int) and y_offset == 0 \
                and halo == 0:
            cen2w = cen2
        else:
            padded = jnp.pad(
                cen2, ((halo, halo),) + ((0, 0),) * (cen2.ndim - 1))
            cen2w = jax.lax.dynamic_slice_in_dim(
                padded, y_offset + 0, hb, axis=0)
    else:
        ok_w = (sy >= 0) & (sy < h2) & (sx >= 0) & (sx < w) & \
            (yy >= 0) & (yy < h2)
        if block_warp and halo == 0 and hb == h and \
                isinstance(y_offset, int) and y_offset == 0:
            # prior came from a 2x nearest upsample: one patch gather per
            # 2x2 block (4x fewer indices, bit-identical masked planes)
            cen2w = warp_census_blocked(cen2, base_u, base_v)
        else:
            # flattened linear-index take over the (H*W,) descriptors;
            # same values as the 2D advanced-index form
            idx = (jnp.clip(sy, 0, h2 - 1) * w + jnp.clip(sx, 0, w - 1))
            cen2w = jnp.take(cen2.reshape((h2 * w,) + cen2.shape[2:]),
                             idx, axis=0)
    if halo < radius:                # extend with invalid rows
        e = radius - halo
        zrow = jnp.zeros((e,) + cen2w.shape[1:], cen2w.dtype)
        cen2w = jnp.concatenate([zrow, cen2w, zrow], axis=0)
        frow = jnp.zeros((e, w), bool)
        ok_w = jnp.concatenate([frow, ok_w, frow], axis=0)
        halo = radius
    yg = jnp.arange(h, dtype=jnp.int32)[:, None] + y_offset  # center rows
    planes = []
    for dv in range(-radius, radius + 1):
        y0 = halo + dv
        sh = cen2w[y0: y0 + h]
        ok0 = ok_w[y0: y0 + h]
        inb = (yg + dv >= 0) & (yg + dv < h2)
        for du in range(-radius, radius + 1):
            if du > 0:
                shifted = jnp.concatenate(
                    [sh[:, du:],
                     jnp.zeros((h, du) + sh.shape[2:], sh.dtype)], axis=1)
                ok = jnp.concatenate(
                    [ok0[:, du:], jnp.zeros((h, du), bool)], axis=1)
            elif du < 0:
                shifted = jnp.concatenate(
                    [jnp.zeros((h, -du) + sh.shape[2:], sh.dtype),
                     sh[:, :du]], axis=1)
                ok = jnp.concatenate(
                    [jnp.zeros((h, -du), bool), ok0[:, :du]], axis=1)
            else:
                shifted, ok = sh, ok0
            ham = hamming(cen1, shifted)
            planes.append(jnp.where(ok & inb, ham,
                                    invalid_cost).astype(jnp.uint8))
    return planes


def cost_volume_flow(cen1: jnp.ndarray, cen2: jnp.ndarray,
                     base_u: jnp.ndarray, base_v: jnp.ndarray,
                     radius: int, invalid_cost: int = 255,
                     y_offset: int | jnp.ndarray = 0,
                     identity_base: bool = False,
                     block_warp: bool = False) -> jnp.ndarray:
    """(H, W, (2w+1)^2) uint8 flow cost volume, warp-then-shift form.

    Exactly mirrors golden/flow.py::cost_volume_flow: the second image's
    census is warped ONCE by the rounded prior flow (a single per-pixel
    gather instead of one per pixel and label), then the (2w+1)^2 window
    offsets are STATIC shifts of the warped descriptors.  Label order
    l = (dv+w)*(2w+1)+(du+w).

    Tiled mode: cen1 is a row tile, cen2 the FULL second image, y_offset
    the tile's global starting row, and base_u/base_v arrive EXTENDED by
    `radius` true halo rows per side (the dv shifts read warped
    descriptors across tile seams).  Untiled callers pass unextended
    fields; rows beyond the provided halo are invalid-padded internally,
    which matches the golden bounds semantics.
    """
    return jnp.stack(
        _flow_cost_planes(cen1, cen2, base_u, base_v, radius, invalid_cost,
                          y_offset, identity_base, block_warp), axis=-1)
