"""SGM path aggregation as a Pallas kernel on the Triton route (GPU).

The XLA path (ops/aggregate.py) runs each family as a `lax.scan`: one
dependent step per image row or column, each step a handful of small
device kernels whose carries round-trip through device memory.  This
kernel walks the path lines inside the program instead:

  * One `pallas_call` per direction.  A line is the chain p, p+r, p+2r...
    of one direction r; each pixel lies on exactly one line, and a line
    depends only on itself, so lines split freely across programs.  The
    grid is (frame, parity class, block of BLOCK_LINES lines).  Vertical
    and diagonal directions have one line per start column (plus the
    start offsets that enter from the side), horizontal directions one
    per row; knight moves with |dy| = 2 have two interleaved parity
    classes of rows.
  * A program walks its block from the image edge with `lax.fori_loop`,
    keeping the (BLOCK_LINES, D) L state of its lines in registers.  The
    cost is read once per direction, straight from the (H, W, D) u8
    volume: every direction, horizontal ones included, computes its
    pixel addresses, so nothing is transposed or flipped.
  * S is accumulated in place (`input_output_aliases`): within one
    direction no two programs touch the same pixel.  It is kept in the
    narrowest integer type that the S bound allows (u16 for every
    committed preset).
  * The label neighbours (d +- 1, or +-1 / +-(2r+1) on the flow grid) are
    read back from a per-program scratch row padded with INF on both
    sides, at least as wide as the widest shift: the Triton lowering has
    no slice or roll.  The row is double buffered so one barrier per
    step orders its store and loads.
  * Edge rule: the state of a line is zero until the line enters the
    image, so its first in-image pixel takes L = C, as in
    ops/aggregate.py (zero carry, invalid predecessor).  Labels padded to
    a power of two hold INF and never win a min.

Bit-exact against ops/aggregate.py and the golden oracles.  There is no
GPU here to compile for in the tests: they run the kernel with
`interpret=True` on the CPU.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import numpy as np
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

INF = 1 << 28          # same headroom as ops.aggregate.INF32
BLOCK_LINES = 4        # path lines per program
_MIN_PAD = 16          # INF pad of the scratch row for shifts up to 16
NUM_WARPS = 4


def s_dtype(s_max: int):
    """Narrowest exact S dtype for sums bounded by `s_max`."""
    return jnp.uint16 if s_max < (1 << 16) else jnp.int32


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def line_geometry(direction: Tuple[int, int], h: int, w: int) -> dict:
    """Static walk geometry of one direction over an (h, w) image.

    The walk axis is rows when dy != 0, else columns.  Step t of line k
    in parity class p visits walk coordinate p + |r_walk| t (mirrored
    when r_walk < 0) and cross coordinate k + r_cross t."""
    dy, dx = direction
    if dy != 0:
        n_walk, n_cross, r_walk, r_cross = h, w, dy, dx
    else:
        n_walk, n_cross, r_walk, r_cross = w, h, dx, 0
    a = abs(r_walk)
    steps = -(-n_walk // a)
    span = abs(r_cross) * (steps - 1)
    return {"rows": dy != 0, "n_walk": n_walk, "n_cross": n_cross,
            "a": a, "forward": r_walk > 0, "r_cross": r_cross,
            "steps": steps, "k0": -span if r_cross > 0 else 0,
            "n_lines": n_cross + span}


def scratch_pad(label_ext: int | None) -> int:
    """INF pad on each side of the scratch row: a power of two no
    narrower than the widest label shift (1, or flow's 2r+1)."""
    return max(_MIN_PAD, _next_pow2(label_ext or 1))


def _sweep_kernel(*refs, geo, nd, ndp, p1, p2, adaptive, label_ext, pad,
                  accumulate, n_blocks, interpret):
    if accumulate:
        cost_ref, img_ref, _s_in, s_ref, scratch_ref = refs
    else:
        cost_ref, img_ref, s_ref, scratch_ref = refs
    b = pl.program_id(0)
    par = pl.program_id(1)
    blk = pl.program_id(2)
    slot = (b * geo["a"] + par) * n_blocks + blk
    lanes = jnp.arange(ndp, dtype=jnp.int32)
    k = (geo["k0"] + blk * BLOCK_LINES
         + jnp.arange(BLOCK_LINES, dtype=jnp.int32))
    lane_ok = lanes < nd
    bk = (BLOCK_LINES, ndp)
    row_idx = jnp.broadcast_to(
        jnp.arange(BLOCK_LINES, dtype=jnp.int32)[:, None], bk)
    lane_idx = jnp.broadcast_to(lanes[None, :], bk) + pad
    inf_pad = jnp.full((BLOCK_LINES, pad), INF, jnp.int32)
    pad_cols = jnp.broadcast_to(jnp.arange(pad, dtype=jnp.int32)[None, :],
                                (BLOCK_LINES, pad))
    pad_rows = jnp.broadcast_to(
        jnp.arange(BLOCK_LINES, dtype=jnp.int32)[:, None], (BLOCK_LINES, pad))
    for buf in range(2):
        for off in (0, pad + ndp):
            plgpu.store(scratch_ref.at[slot, buf, pad_rows, pad_cols + off],
                        inf_pad)
    if label_ext is not None:
        iu = jax.lax.rem(lanes, np.int32(label_ext))
        u_lo_ok = (iu > 0)[None, :]
        u_hi_ok = (iu < label_ext - 1)[None, :]

    def coords(t):
        u = par + geo["a"] * t
        v = k + geo["r_cross"] * t
        ok = (v >= 0) & (v < geo["n_cross"]) & (u < geo["n_walk"])
        if not geo["forward"]:
            u = geo["n_walk"] - 1 - u
        if geo["rows"]:
            return jnp.broadcast_to(u, v.shape), v, ok
        return v, jnp.broadcast_to(u, v.shape), ok

    def step(t, carry):
        prev, img_prev = carry
        y, x, ok = coords(t)
        ok2 = ok[:, None] & lane_ok[None, :]
        y2 = jnp.broadcast_to(y[:, None], bk)
        x2 = jnp.broadcast_to(x[:, None], bk)
        d2 = jnp.broadcast_to(lanes[None, :], bk)
        c = plgpu.load(cost_ref.at[b, y2, x2, d2], mask=ok2,
                       other=0).astype(jnp.int32)
        m = jnp.min(prev, axis=1)
        buf = jax.lax.bitwise_and(t, 1)
        plgpu.store(scratch_ref.at[slot, buf, row_idx, lane_idx],
                    prev)
        if not interpret:       # the interpreter has no barrier rule and
            plgpu.debug_barrier()   # runs one program's steps in order

        def shifted(off):
            return plgpu.load(
                scratch_ref.at[slot, buf, row_idx, lane_idx + off])

        if label_ext is None:
            nbr = jnp.minimum(shifted(-1), shifted(1))
        else:
            nbr = jnp.minimum(
                jnp.minimum(jnp.where(u_lo_ok, shifted(-1), INF),
                            jnp.where(u_hi_ok, shifted(1), INF)),
                jnp.minimum(shifted(-label_ext), shifted(label_ext)))
        if adaptive:
            g = plgpu.load(img_ref.at[b, y, x], mask=ok,
                           other=0).astype(jnp.int32)
            diff = jnp.maximum(jnp.abs(g - img_prev), 1)
            p2e = jnp.maximum(np.int32(p1 + 1),
                              jax.lax.div(np.int32(p2), diff))
        else:
            g = img_prev
            p2e = jnp.full((BLOCK_LINES,), p2, jnp.int32)
        best = jnp.minimum(jnp.minimum(prev, nbr + p1),
                           (m + p2e)[:, None])
        l_row = c + best - m[:, None]
        l_row = jnp.where(ok[:, None], l_row, 0)
        l_row = jnp.where(lane_ok[None, :], l_row, INF)
        s_idx = s_ref.at[b, y2, x2, d2]
        add = l_row.astype(s_ref.dtype)
        if accumulate:
            add = add + plgpu.load(s_idx, mask=ok2, other=0)
        plgpu.store(s_idx, add, mask=ok2)
        return l_row, g

    prev0 = jnp.where(lane_ok[None, :], jnp.zeros(bk, jnp.int32), INF)
    jax.lax.fori_loop(0, geo["steps"], step,
                      (prev0, jnp.zeros((BLOCK_LINES,), jnp.int32)))


def direction_sweep(cost: jnp.ndarray, img: jnp.ndarray,
                    direction: Tuple[int, int], p1: int, p2: int,
                    adaptive: bool, s: jnp.ndarray | None, out_dtype,
                    label_ext: int | None = None,
                    interpret: bool = False) -> jnp.ndarray:
    """S (+)= L_r for one direction over a batch.

    cost: (B, H, W, D) u8; img: (B, H, W) u8; s: (B, H, W, D) or None
    (then S = L_r is written fresh in `out_dtype`)."""
    nb, h, w, nd = cost.shape
    geo = line_geometry(direction, h, w)
    n_blocks = -(-geo["n_lines"] // BLOCK_LINES)
    ndp = _next_pow2(nd)
    pad = scratch_pad(label_ext)
    grid = (nb, geo["a"], n_blocks)
    n_slots = nb * geo["a"] * n_blocks
    accumulate = s is not None
    dtype = s.dtype if accumulate else out_dtype
    kernel = functools.partial(
        _sweep_kernel, geo=geo, nd=nd, ndp=ndp, p1=p1, p2=p2,
        adaptive=adaptive, label_ext=label_ext, pad=pad,
        accumulate=accumulate,
        n_blocks=n_blocks, interpret=interpret)
    out_shape = (jax.ShapeDtypeStruct(cost.shape, dtype),
                 jax.ShapeDtypeStruct((n_slots, 2, BLOCK_LINES,
                                       ndp + 2 * pad), jnp.int32))
    args = (cost, img) + ((s,) if accumulate else ())
    out, _scratch = pl.pallas_call(
        kernel, out_shape=out_shape, grid=grid,
        input_output_aliases={2: 0} if accumulate else {},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton", interpret=interpret,
        name=f"sgm_sweep_{direction[0]}_{direction[1]}".replace("-", "m"),
    )(*args)
    return out


def _aggregate_batched(cost, img, dirs, p1, p2, adaptive, label_ext,
                       s_max, interpret):
    s = None
    for r in dirs:
        s = direction_sweep(cost, img, r, p1, p2, adaptive, s,
                            s_dtype(s_max), label_ext, interpret)
    return s


def aggregate_paths(cost: jnp.ndarray, img: jnp.ndarray,
                    dirs: Sequence[Tuple[int, int]], p1: int, p2: int,
                    adaptive_p2: bool = False, label_ext: int | None = None,
                    s_max: int | None = None,
                    interpret: bool = False) -> jnp.ndarray:
    """S = sum_r L_r for an (H, W, D) cost volume; drop-in for
    ops.aggregate.aggregate_paths (same values, S in `s_dtype(s_max)`).

    label_ext: flow's label-grid width (2r+1) for the 2D neighbour min;
    None for stereo's 1D disparity neighbours.  s_max bounds S (default:
    len(dirs) * (255 + p2)).  Under `jax.vmap` the frames go into the
    kernel's grid instead of a batching rule around the call."""
    dirs = tuple(tuple(r) for r in dirs)
    if s_max is None:
        s_max = len(dirs) * (255 + p2)

    @jax.custom_batching.custom_vmap
    def batched(c, g):
        return _aggregate_batched(c, g, dirs, p1, p2, adaptive_p2,
                                  label_ext, s_max, interpret)

    @batched.def_vmap
    def _batched_vmap(axis_size, in_batched, c, g):
        c_b, g_b = in_batched
        if not c_b:
            c = jnp.broadcast_to(c, (axis_size,) + c.shape)
        if not g_b:
            g = jnp.broadcast_to(g, (axis_size,) + g.shape)
        lead = c.shape[:2]
        out = batched(c.reshape((-1,) + c.shape[2:]),
                      g.reshape((-1,) + g.shape[2:]))
        return out.reshape(lead + out.shape[1:]), True

    return batched(cost[None], img[None])[0]
