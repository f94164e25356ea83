"""Sequence-mode throughput: tracked pairs vs from-scratch pairs.

Measures wall-clock per pair (including the per-dispatch cost — sequence
pairs are serially dependent through the temporal prior, so dispatch
cannot be batched away; this is the number a video consumer sees) for:

  scratch  every pair independently (flow_fsgm, no temporal prior),
           `levels` pyramid — the per-pair CLI baseline
  seeded   flow_sequence with the full pyramid every pair (temporal
           prior, same depth)
  tracked  flow_sequence: pair 0 full depth, later pairs through a
           shallower `track_levels` pyramid seeded by the previous field

    python tools/seqbench.py [--shape 368x1232] [--frames 9]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="368x1232")
    ap.add_argument("--frames", type=int, default=9)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--track-levels", dest="track_levels", type=int,
                    default=2)
    ap.add_argument("--radius", type=int, default=4)
    ap.add_argument("--backend", default="auto")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from fsgm_tpu.params import FlowParams
    from fsgm_tpu.models.flow import flow_sequence, flow_fsgm
    from fsgm_tpu.io.synthetic import constant_flow_sequence

    h, w = (int(x) for x in args.shape.split("x"))
    frames_np, gt = constant_flow_sequence(h, w, 3, -2, args.frames,
                                           seed=0)
    p = FlowParams(search_radius=args.radius, levels=args.levels,
                   p1=7, p2=100, fb_backward="half")
    tp = FlowParams(search_radius=args.radius, levels=args.track_levels,
                    p1=7, p2=100, fb_backward="half")
    print(f"# platform={jax.devices()[0].platform} shape={args.shape} "
          f"frames={args.frames}", file=sys.stderr)

    def run_scratch(fr):
        outs = [flow_fsgm(fr[i], fr[i + 1], p, args.backend)
                for i in range(fr.shape[0] - 1)]
        return (jnp.stack([o[0] for o in outs]),
                jnp.stack([o[1] for o in outs]))

    for name, run in (("scratch", run_scratch),
                      ("seeded", lambda fr: flow_sequence(
                          fr, p, args.backend)),
                      ("tracked", lambda fr: flow_sequence(
                          fr, p, args.backend, track_params=tp))):
        fr = jnp.asarray(frames_np)
        for rep in range(3):
            t0 = time.perf_counter()
            flows, valids = jax.block_until_ready(run(fr))
            dt = time.perf_counter() - t0
            err = float(jnp.mean(jnp.abs(flows[-1][..., 0] - 3)))
            if rep == 2:
                n = args.frames - 1
                print(f"{name:8s} {1e3 * dt / n:8.2f} ms/pair wall "
                      f"(last-pair mean |u-3| = {err:.3f}, "
                      f"valid {float(jnp.mean(valids)):.2f})")


if __name__ == "__main__":
    main()
