"""Benchmark harness — one-line JSON on stdout, context on stderr.

Default (driver) config: the BASELINE.json primary target — KITTI stereo
1242x375, D=128, 8 paths, LR-consistency + subpixel (config 2).  Metric is
Mpixel*disp/s = H*W*D*fps/1e6 (BASELINE.md).  `vs_baseline` is measured
throughput over the best prior-art per-chip anchor recorded in BASELINE.md
(embedded-GPU SGM, ~1650 Mpixel*disp/s on Tegra X1; the reference itself
is a single-threaded MATLAB/MEX CPU pipeline, far slower, and publishes no
numbers — BASELINE.json `published: {}`).

It measures the GPU and refuses to run anywhere else.

Env knobs:
  FSGM_BENCH_CONFIG  kitti (default) | tsukuba | kitti16 | flow | 4k | 4kflow
  FSGM_BENCH_BACKEND xla | triton  (default: the platform's, fsgm_tpu.backend)
  FSGM_BENCH_BATCH   frames per dispatch (default per config)
  FSGM_BENCH_STAGES  1 -> per-stage roofline table on stderr (JSONL:
                     wall, modeled HBM bytes, achieved GB/s, % of peak;
                     SURVEY.md §5 "roofline reporting"); stereo cfgs only
  FSGM_BENCH_TRACE   dir -> profile one dispatch into <dir> after the
                     timed runs and print device time per layer
                     (utils/profiling.layer_times) on stderr

Params for each config are loaded from the committed preset file in
configs/ (bench_params) — presets and bench cannot drift
(tests/unit/test_presets.py).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# Anchor throughput (Mpixel*disp/s); see BASELINE.md.
BASELINE_MPDS = 1650.0     # embedded-GPU SGM anchor (best prior art per chip)
REPEATS = 10               # timed dispatches after the compiling one

CONFIGS = {
    # name: (H, W, D_or_labels, batch, metric_name, preset_file)
    "kitti":   (375, 1242, 128, 16, "kitti_stereo_sgm_throughput",
                "kitti_stereo.json"),
    "tsukuba": (288, 384, 64, 16, "tsukuba_stereo_sgm_throughput",
                "tsukuba.json"),
    "kitti16": (375, 1242, 128, 16, "kitti_16path_adaptive_throughput",
                "kitti_16path.json"),
    "4k":      (2160, 3840, 128, 2, "uhd_stereo_sgm_throughput",
                "tiled_4k.json"),
    "flow":    (368, 1232, 81, 8, "kitti_flow_fsgm_throughput",
                "kitti_flow.json"),
    # BASELINE config 5 names "4K stereo / flow": the flow leg, 5 levels
    # (coarsest 135x240), single frame per dispatch
    "4kflow":  (2160, 3840, 81, 1, "uhd_flow_fsgm_throughput",
                "kitti_flow.json"),
}

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs")


def bench_params(cfg: str):
    """The exact params object benchmarked for `cfg`, constructed FROM the
    committed preset file (configs/*.json) so presets and bench can never
    drift (tests/unit/test_presets.py pins this).  The only difference
    applied on top of a preset is documented here: the 4K flow leg runs
    one extra pyramid level (coarsest 135x240 instead of 270x480 — the 4K
    frame needs it for the same relative search range)."""
    import dataclasses
    from fsgm_tpu.params import load_preset
    preset = load_preset(os.path.join(_CONFIG_DIR, CONFIGS[cfg][5]))
    if cfg in ("flow", "4kflow"):
        p = preset["flow"]
        if cfg == "4kflow":
            p = dataclasses.replace(p, levels=5)
        return p
    return preset["sgm"]


def flow_label_pixels(h: int, w: int, fp) -> int:
    """Actually-aggregated label-pixels per frame — the honest flow-Mpd/s
    numerator (a plain `labels * 2 * H*W` would count the
    backward pass as a full-res pyramid while fb_backward='half' runs it
    at half resolution, and under-count the forward pyramid's coarse
    levels).  Sums H_l*W_l over every pyramid level each direction really
    aggregates, times the label count."""
    dims = [(h, w)]
    for _ in range(fp.levels - 1):
        dims.append((dims[-1][0] // 2, dims[-1][1] // 2))
    fwd = sum(hh * ww for hh, ww in dims)
    if fp.fb_backward == "half":
        bwd = sum(hh * ww for hh, ww in dims[1:])
    elif fp.fb_backward == "single":
        bwd = h * w
    else:                       # 'full' / 'cheap' aggregate every level
        bwd = fwd
    return (fwd + bwd) * fp.num_labels


def _timed(run, args, batch, repeats):
    """(per-frame seconds of each warm dispatch, compile seconds)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(run(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        times.append((time.perf_counter() - t0) / batch)
    return times, compile_s


def _stage_roofline(params, h, w, d, backend, iters=32) -> None:
    """Per-stage roofline (SURVEY.md §5): times each pipeline stage as a
    K-iteration in-jit loop and reports achieved HBM bandwidth against a
    modeled byte count.  Each iteration perturbs its input by the loop
    index so XLA cannot hoist the stage out of the loop."""
    import jax
    import jax.numpy as jnp
    from fsgm_tpu.backend import aggregate
    from fsgm_tpu.io.synthetic import random_dot_stereo
    from fsgm_tpu.ops.census import census_transform
    from fsgm_tpu.ops.cost import cost_volume_stereo
    from fsgm_tpu.ops import extract as ext
    from fsgm_tpu.ops.aggregate_triton import s_dtype as kernel_s_dtype
    from fsgm_tpu.utils.profiling import StageTimer, sgm_bytes_model

    il, ir, _ = random_dot_stereo(h, w, d, seed=0)
    il, ir = jnp.asarray(il), jnp.asarray(ir)
    s_dtype = (jnp.int32 if backend == "xla"
               else kernel_s_dtype(params.s_invalid))
    s_item = jnp.zeros((), s_dtype).dtype.itemsize
    model = sgm_bytes_model(h, w, d, params.num_paths, s_itemsize=s_item)
    vol = h * w * d
    n_dirs = len(params.dirs)
    # scan: 4 family passes (sgm_bytes_model); kernel: one cost read per
    # direction plus an S write, and an S read for every direction but
    # the first
    agg_bytes = (model["aggregate"] if backend == "xla" else
                 vol * (n_dirs + (2 * n_dirs - 1) * s_item))

    def cost_of(img_l, img_r):
        cl = census_transform(img_l, params.census_window)
        cr = census_transform(img_r, params.census_window)
        return cost_volume_stereo(cl, cr, params.max_disp,
                                  params.invalid_cost)

    def extract_stage(s_v):
        d_int = ext.wta(s_v)
        disp = ext.subpixel_refine(s_v, d_int)
        d_right = ext.wta_right_from_s(s_v, params.s_invalid)
        disp = ext.lr_check(disp, d_right, params.lr_max_diff,
                            params.max_disp)
        return ext.median_filter_3x3(disp)

    def agg_of(c, g):
        return aggregate(c, g, params.dirs, params.p1, params.p2,
                         params.adaptive_p2, backend, params.s_invalid)

    def loop(body):
        @jax.jit
        def run(*args):
            def it(i, acc):
                s8 = i.astype(jnp.uint8)
                return acc + body(s8, *args)
            return jax.lax.fori_loop(0, iters, it, jnp.float32(0))
        return run

    cost0 = cost_of(il, ir)
    s0 = agg_of(cost0, il)
    stages = {
        "census_cost": (loop(lambda s8, a, b: jnp.sum(
            cost_of(a + s8, b + s8), dtype=jnp.float32)),
            (il, ir), model["cost"]),
        "aggregate": (loop(lambda s8, c, g: jnp.sum(
            agg_of(jnp.clip(c + s8 % 3, 0, 255).astype(jnp.uint8), g),
            dtype=jnp.float32)), (cost0, il), agg_bytes),
        "extract": (loop(lambda s8, s_v: jnp.sum(
            extract_stage(s_v + s8.astype(s_dtype)))),
            (s0,), model["extract"]),
    }
    timer = StageTimer()
    for name, (run, args, nbytes) in stages.items():
        jax.block_until_ready(run(*args))          # compile + warm
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        timer.record(name, time.perf_counter() - t0,
                     bytes_moved=nbytes * iters)
    print("# stage roofline (modeled bytes, measured in-jit loop):",
          file=sys.stderr)
    timer.print_report(file=sys.stderr)


def device_record() -> dict:
    """The device every result names (jax.devices()[0])."""
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def main() -> None:
    import jax
    import jax.numpy as jnp
    from fsgm_tpu.backend import resolve_backend
    from fsgm_tpu.io.synthetic import random_dot_stereo, constant_flow_pair
    from fsgm_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    device = device_record()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {device}")
    cfg = os.environ.get("FSGM_BENCH_CONFIG", "kitti")
    h, w, d, batch_default, metric = CONFIGS[cfg][:5]
    batch = int(os.environ.get("FSGM_BENCH_BATCH", batch_default))
    backend = resolve_backend(os.environ.get("FSGM_BENCH_BACKEND", "auto"))

    if cfg in ("flow", "4kflow"):
        from fsgm_tpu.models.flow import _flow_fsgm_batch_jit as entry
        fparams = bench_params(cfg)
        statics = (fparams, backend)
        pairs = [constant_flow_pair(h, w, 3, -2, seed=s)
                 for s in range(batch)]
        # honest numerator: label-pixels actually aggregated per frame
        # (sum over pyramid levels, fwd + the configured backward)
        label_px = flow_label_pixels(h, w, fparams)
    else:
        from fsgm_tpu.models.stereo import _stereo_sgm_batch_jit as entry
        params = bench_params(cfg)
        assert params.max_disp == d, (cfg, params.max_disp, d)
        statics = (params, backend)
        pairs = [random_dot_stereo(h, w, d, seed=s) for s in range(batch)]
        label_px = h * w * d
    a = jnp.asarray(np.stack([p[0] for p in pairs]))
    b = jnp.asarray(np.stack([p[1] for p in pairs]))

    # the batched entry point's own jit (what stereo_sgm_batch /
    # flow_fsgm_batch dispatch), compiled ahead so the trace reduction
    # can read its HLO
    t0 = time.perf_counter()
    run = entry.lower(a, b, *statics).compile()
    lower_s = time.perf_counter() - t0
    times, compile_s = _timed(run, (a, b), batch, REPEATS)
    compile_s += lower_s
    dt = float(np.median(times))
    q1, q3 = (float(x) for x in np.percentile(times, [25, 75]))
    mpds = label_px / dt / 1e6
    rec = {"metric": metric, "value": round(mpds, 1),
           "unit": "Mpixel*disp/s",
           "vs_baseline": round(mpds / BASELINE_MPDS, 3),
           "ms_per_frame": dt * 1e3, "ms_per_frame_q1_q3": [q1 * 1e3,
                                                            q3 * 1e3],
           "batch": batch, "backend": backend, "device": device}
    print(json.dumps(rec))
    print(f"# cfg={cfg} backend={backend} device={device['kind']} "
          f"batch={batch} frame={dt*1e3:.3f}ms fps={1 / dt:.1f} "
          f"compile={compile_s:.1f}s runs_ms="
          f"{[round(t * 1e3, 3) for t in times]}", file=sys.stderr)

    trace_dir = os.environ.get("FSGM_BENCH_TRACE")
    if trace_dir:
        from fsgm_tpu.utils.profiling import layer_times, trace
        with trace(trace_dir):
            jax.block_until_ready(run(a, b))
        hlo = run.as_text()
        with open(os.path.join(trace_dir, "module.hlo.txt"), "w") as f:
            f.write(hlo)
        rep = layer_times(trace_dir, hlo)
        print("# layers " + json.dumps({"cfg": cfg, "backend": backend,
                                        "batch": batch, **rep}),
              file=sys.stderr)

    if os.environ.get("FSGM_BENCH_STAGES", "0") == "1" and cfg not in (
            "flow", "4kflow"):
        _stage_roofline(params, h, w, d, backend)


if __name__ == "__main__":
    main()
