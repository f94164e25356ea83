"""Multi-host execution (SURVEY.md §2.3, layer L6 "Distribution").

The frame (DP) axis maps across hosts — inter-host traffic is only the
initial frame scatter and final field gather; the chatty per-wavefront
halo exchange stays on the intra-host ("ty") mesh axis, between the
devices of one host (SURVEY.md §2.3).

`init_distributed()` wraps jax.distributed.initialize; `global_mesh()`
builds the ("frame", "ty") mesh with frame spanning processes.  The same
code runs on several GPU hosts and on N localhost CPU processes (the
multi-host test tier, SURVEY.md §4).
"""

from __future__ import annotations

import jax
import numpy as np


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize the multi-controller runtime."""
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(frame_per_process: int = 1):
    """("frame", "ty") mesh: frame axis spans processes, ty is the
    per-process spatial axis.  Requires every process to expose the
    same local device count."""
    n_proc = jax.process_count()
    local = jax.local_device_count()
    frame = n_proc * frame_per_process
    ty = local // frame_per_process
    devs = np.array(jax.devices()).reshape(frame, ty)
    return jax.sharding.Mesh(devs, ("frame", "ty"))


def weak_scaling_report(frames_per_s: float, n_hosts: int,
                        baseline_1host: float) -> dict:
    """BASELINE.json target: >=80% weak-scaling efficiency at N hosts."""
    eff = frames_per_s / (baseline_1host * n_hosts) if baseline_1host else 0.0
    return {"hosts": n_hosts, "frames_per_s": frames_per_s,
            "weak_scaling_efficiency": round(eff, 4)}


def calibrate_weak_scaling_model(h: int = 64, w: int = 48, d: int = 16,
                                 ty: int = 4, margin: int = 8,
                                 num_paths: int = 8) -> dict:
    """Check the structural terms of a ty-tiled weak-scaling model
    against counts from the real tiled implementation on a device mesh.

    Runs the exact-wavefront and fast-margin pipelines with the work- and
    halo-instrumentation hooks (parallel.tiled._WORK_CALLBACK /
    _HALO_CALLBACK) and compares, term by term:

      * rows swept per vertical family (exact): the model says H (each
        row aggregated once, no redundant work);
      * chain depth (exact): N sequential active sweeps per family,
        counted as the number of active-branch firings;
      * rows swept per family (fast): H + N*margin;
      * halo bytes per family boundary: the carry the scan backend
        exchanges, one (2, W, D) int32 state per direction of the family.

    Only work and bytes are compared; times need a measurement on the
    devices themselves.  Returns {"exact": {...}, "fast": {...},
    "halo": {...}}, each with model/counted pairs and an "ok" flag."""
    import jax.numpy as jnp
    from fsgm_tpu.params import SGMParams, DistParams
    from fsgm_tpu.io.synthetic import random_dot_stereo
    from fsgm_tpu.parallel import tiled

    img_l, img_r, _ = random_dot_stereo(h, w, d, seed=23)
    p = SGMParams(max_disp=d, p1=7, p2=60, num_paths=num_paths)
    devs = np.array(jax.devices()[:ty]).reshape(1, ty)
    mesh = jax.sharding.Mesh(devs, ("frame", "ty"))

    def run(mode: str):
        work, halo = [], []
        tiled._WORK_CALLBACK = lambda tag, rows: work.append(
            (tag, int(rows)))
        tiled._HALO_CALLBACK = lambda tag, nbytes, _z: halo.append(
            (tag, int(nbytes)))
        try:
            dist = DistParams(tiles_y=ty, frame_shards=1, tile_mode=mode,
                              margin=margin)
            out = tiled.stereo_sgm_sharded(
                jnp.asarray(img_l)[None], jnp.asarray(img_r)[None], p,
                dist, mesh)
            out.block_until_ready()
            jax.effects_barrier()
        finally:
            tiled._WORK_CALLBACK = None
            tiled._HALO_CALLBACK = None
        return work, halo

    down = [r for r in p.dirs if r[0] > 0]
    model_halo = len(down) * 2 * w * d * 4

    work_e, halo_e = run("exact")
    down_rows = sum(r for t, r in work_e if t == "down")
    chain = sum(1 for t, _ in work_e if t == "down")
    work_f, _ = run("fast")
    down_rows_f = sum(r for t, r in work_f if t == "down")
    # halo messages: census row-halo (2-row u8 pairs) + one carry per
    # family per wavefront step; carry buffers are the large ones
    carry_msgs = sorted({b for _t, b in halo_e}, reverse=True)
    counted_halo = carry_msgs[0] if carry_msgs else 0

    res = {
        "exact": {"model_rows_per_family": h, "counted": down_rows,
                  "model_chain_depth": ty, "counted_chain": chain,
                  "ok": down_rows == h and chain == ty},
        "fast": {"model_rows_per_family": h + ty * margin,
                 "counted": down_rows_f,
                 "ok": down_rows_f == h + ty * margin},
        "halo": {"model_carry_bytes_per_boundary": model_halo,
                 "counted_carry_bytes": counted_halo,
                 "ok": counted_halo == model_halo},
    }
    res["ok"] = all(v["ok"] for v in res.values() if isinstance(v, dict))
    return res
