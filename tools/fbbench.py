"""Microbench fb_check gather variants on the device.

The FB consistency gather (backward flow sampled at forward-displaced
positions) is a true dynamic (H, W) gather — the one stage of the flow
pipeline that cannot be restructured as warp-once + static shifts.  This
tool measures the candidate lowerings:

  2ch    current fb_check: flow_bwd[tyc, txc] on an (H, W, 2) f32 field
  linear flattened linear-index take on (H*W, 2)
  packed single (H, W) int32 gather of int16-packed (u, v) (lossless only
         when the backward pass skipped subpixel, i.e. the final-level
         output of cheap/single modes — NOT "half", which keeps subpixel
         exactly because integer-only backward values sit at the fb
         tolerance after 2x upsampling; measured worse anyway)

    python tools/fbbench.py [--shape 368x1232] [--iters 16]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="368x1232")
    ap.add_argument("--iters", type=int, default=16)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    h, w = (int(x) for x in args.shape.split("x"))
    rng = np.random.default_rng(0)
    fwd = jnp.asarray(rng.integers(-20, 20, (h, w, 2)).astype(np.float32))
    bwd = jnp.asarray(rng.integers(-20, 20, (h, w, 2)).astype(np.float32))

    yy = jnp.arange(h, dtype=jnp.int32)[:, None]
    xx = jnp.arange(w, dtype=jnp.int32)[None, :]

    def loop(body):
        @jax.jit
        def run(salt, *arrs):
            def it(i, acc):
                s = (salt + i).astype(jnp.float32)
                return acc + body(s, *arrs)
            return jax.lax.fori_loop(0, args.iters, it, jnp.float32(0))
        return run

    def targets(s, f):
        tx = xx + jnp.rint(f[..., 0] + s).astype(jnp.int32)
        ty = yy + jnp.rint(f[..., 1] - s).astype(jnp.int32)
        inb = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
        return jnp.clip(tx, 0, w - 1), jnp.clip(ty, 0, h - 1), inb

    def v_2ch(s, f, b):
        txc, tyc, inb = targets(s, f)
        bb = b[tyc, txc]
        err = jnp.abs(f[..., 0] + bb[..., 0]) + jnp.abs(f[..., 1]
                                                        + bb[..., 1])
        return jnp.sum(jnp.where(inb, err, 0.0))

    def v_linear(s, f, b):
        txc, tyc, inb = targets(s, f)
        bb = jnp.take(b.reshape(h * w, 2), tyc * w + txc, axis=0)
        err = jnp.abs(f[..., 0] + bb[..., 0]) + jnp.abs(f[..., 1]
                                                        + bb[..., 1])
        return jnp.sum(jnp.where(inb, err, 0.0))

    bq = ((jnp.rint(bwd[..., 0]).astype(jnp.int32) & 0xFFFF)
          | (jnp.rint(bwd[..., 1]).astype(jnp.int32) << 16))

    def v_packed(s, f, bp):
        txc, tyc, inb = targets(s, f)
        pk = bp[tyc, txc]
        bu = (pk << 16) >> 16          # sign-extend low half
        bv = pk >> 16
        err = (jnp.abs(f[..., 0] + bu.astype(jnp.float32))
               + jnp.abs(f[..., 1] + bv.astype(jnp.float32)))
        return jnp.sum(jnp.where(inb, err, 0.0))

    def v_packed_linear(s, f, bp):
        txc, tyc, inb = targets(s, f)
        pk = jnp.take(bp.reshape(h * w), tyc * w + txc, axis=0)
        bu = (pk << 16) >> 16
        bv = pk >> 16
        err = (jnp.abs(f[..., 0] + bu.astype(jnp.float32))
               + jnp.abs(f[..., 1] + bv.astype(jnp.float32)))
        return jnp.sum(jnp.where(inb, err, 0.0))

    print(f"# platform={jax.devices()[0].platform} shape={args.shape} "
          f"iters={args.iters}", file=sys.stderr)
    for name, body, arrs in (("2ch", v_2ch, (fwd, bwd)),
                             ("linear", v_linear, (fwd, bwd)),
                             ("packed", v_packed, (fwd, bq)),
                             ("packed_linear", v_packed_linear, (fwd, bq))):
        run = loop(body)
        float(run(np.float32(251), *arrs))
        times = []
        for rep in range(3):
            t0 = time.perf_counter()
            float(run(np.float32(rep), *arrs))
            times.append(time.perf_counter() - t0)
        ms = 1e3 * float(np.median(times)) / args.iters
        print(f"{name:14s} {ms:7.2f} ms")


if __name__ == "__main__":
    main()
