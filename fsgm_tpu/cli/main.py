"""Command-line interface (layer L7): run_stereo / run_flow / run_bench /
run_eval.

Reference capability (SURVEY.md §2.1 "Demo / CLI": demo.m driving Tsukuba
stereo and a KITTI flow pair).  Subcommands:

  stereo  — disparity for an image pair (PNG/PGM in, KITTI-PNG/PFM out)
  flow    — fSGM flow for a pair (.flo / KITTI-PNG out)
  eval    — D1-all / Fl-all against ground truth
  bench   — throughput harness with per-stage roofline report
  demo    — synthetic end-to-end smoke run (no data needed)

Per-frame structured records (JSONL) per SURVEY.md §5 observability; a
resume manifest makes batch runs idempotent (checkpoint/resume analog).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np


def _params_from_args(args, cls, fallback_default=False):
    from fsgm_tpu import params as P
    if getattr(args, "preset", None):
        preset = P.load_preset(args.preset)
        for v in preset.values():
            if isinstance(v, cls):
                return v
        if not fallback_default:
            raise SystemExit(f"preset {args.preset} has no {cls.__name__}")
        # serve needs BOTH param kinds but presets usually hold one:
        # fall through to CLI-arg/default construction for the other
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = {k: v for k, v in vars(args).items() if k in fields and v is not None}
    if "census_window" in kw:
        kw["census_window"] = tuple(kw["census_window"])
    return cls(**kw)


# aggregation backends a user can pick (fsgm_tpu.backend); 'auto' picks
# from the platform
BACKEND_CHOICES = ["auto", "xla", "triton"]


def _add_stereo_args(sp):
    sp.add_argument("--preset", help="configs/*.json preset file")
    sp.add_argument("--max-disp", dest="max_disp", type=int)
    sp.add_argument("--p1", type=int)
    sp.add_argument("--p2", type=int)
    sp.add_argument("--num-paths", dest="num_paths", type=int)
    sp.add_argument("--census-window", dest="census_window", type=int,
                    nargs=2)
    sp.add_argument("--adaptive-p2", dest="adaptive_p2",
                    action="store_true", default=None)
    sp.add_argument("--no-subpixel", dest="subpixel", action="store_false",
                    default=None)
    sp.add_argument("--no-lr-check", dest="lr_check", action="store_false",
                    default=None)
    sp.add_argument("--no-median", dest="median_filter",
                    action="store_false", default=None)
    sp.add_argument("--backend", default="auto", choices=BACKEND_CHOICES)


def _backend(name: str) -> str:
    from fsgm_tpu.backend import resolve_backend
    return resolve_backend(name)


def cmd_stereo(args) -> int:
    import jax.numpy as jnp
    from fsgm_tpu.params import SGMParams
    from fsgm_tpu.models.stereo import stereo_sgm
    from fsgm_tpu.io.images import load_gray
    from fsgm_tpu.io import kitti

    p = _params_from_args(args, SGMParams)
    img_l, img_r = load_gray(args.left), load_gray(args.right)
    t0 = time.perf_counter()
    disp = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p,
                                 _backend(args.backend)))
    dt = time.perf_counter() - t0
    out = Path(args.output)
    if out.suffix == ".pfm":
        from fsgm_tpu.io.images import write_pfm
        write_pfm(out, disp)
    else:
        kitti.write_disparity_png(out, disp)
    rec = {"cmd": "stereo", "left": str(args.left), "out": str(out),
           "h": img_l.shape[0], "w": img_l.shape[1], "d": p.max_disp,
           "wall_s": round(dt, 4),
           "valid_frac": round(float((disp >= 0).mean()), 4)}
    print(json.dumps(rec))
    return 0


def densify_flow(flow: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Fill FB-invalidated pixels row-wise from the nearest valid left
    neighbor (else nearest right) — the devkit-style densification pass
    for writing dense flow maps (occlusions inherit the occluder's
    row-neighbor motion).  Host-side post-processing only: the parity
    pipeline's output (flow + explicit validity plane) is untouched."""
    h, w = valid.shape
    xs = np.arange(w, dtype=np.int64)[None, :]
    left = np.maximum.accumulate(np.where(valid, xs, -1), axis=1)
    right = np.minimum.accumulate(
        np.where(valid, xs, 1 << 30)[:, ::-1], axis=1)[:, ::-1]
    src = np.where(left >= 0, left, right)
    src_c = np.clip(src, 0, w - 1)
    rows = np.arange(h)[:, None]
    filled = flow[rows, src_c]
    # rows with no valid pixel at all keep the original values
    any_valid = valid.any(axis=1, keepdims=True)
    return np.where((valid | ~any_valid)[..., None], flow, filled)


def cmd_flow(args) -> int:
    import jax.numpy as jnp
    from fsgm_tpu.params import FlowParams
    from fsgm_tpu.models.flow import flow_fsgm
    from fsgm_tpu.io.images import load_gray
    from fsgm_tpu.io import kitti

    p = _params_from_args(args, FlowParams)
    img1, img2 = load_gray(args.first), load_gray(args.second)
    t0 = time.perf_counter()
    flow, valid = flow_fsgm(jnp.asarray(img1), jnp.asarray(img2), p,
                            _backend(args.backend))
    flow, valid = np.asarray(flow), np.asarray(valid)
    dt = time.perf_counter() - t0
    out = Path(args.output)
    if getattr(args, "fill_invalid", False):
        wr, wr_valid = densify_flow(flow, valid), np.ones_like(valid)
    else:
        wr, wr_valid = np.where(valid[..., None], flow, 0), valid
    if out.suffix == ".flo":
        kitti.write_flo(out, wr)
    else:
        kitti.write_flow_png(out, wr, wr_valid)
    print(json.dumps({"cmd": "flow", "out": str(out),
                      "wall_s": round(dt, 4),
                      "valid_frac": round(float(valid.mean()), 4)}))
    return 0


def cmd_video(args) -> int:
    """fSGM over a frame sequence with temporal priors: pair 0 runs the
    full pyramid, later pairs seed their coarsest level with the previous
    pair's field (models/flow.py::flow_sequence), optionally through a
    shallower --track-levels pyramid."""
    import jax.numpy as jnp
    from fsgm_tpu.params import FlowParams
    from fsgm_tpu.models.flow import flow_sequence
    from fsgm_tpu.io.images import load_gray
    from fsgm_tpu.io import kitti

    p = _params_from_args(args, FlowParams)
    tp = (dataclasses.replace(p, levels=args.track_levels)
          if args.track_levels else None)
    frame_paths = [ln.strip() for ln in
                   Path(args.list).read_text().splitlines() if ln.strip()]
    if len(frame_paths) < 2:
        print("need at least 2 frames", file=sys.stderr)
        return 2
    frames = np.stack([load_gray(f) for f in frame_paths])
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    flows, valids = flow_sequence(jnp.asarray(frames), p,
                                  _backend(args.backend), track_params=tp)
    flows, valids = np.asarray(flows), np.asarray(valids)
    dt = time.perf_counter() - t0
    for t in range(flows.shape[0]):
        name = Path(frame_paths[t]).stem
        if getattr(args, "fill_invalid", False):
            fl = densify_flow(flows[t], valids[t])
            wr_valid = np.ones_like(valids[t])    # densified = all valid
        else:
            fl = np.where(valids[t][..., None], flows[t], 0)
            wr_valid = valids[t]
        if args.format == "flo":
            kitti.write_flo(outdir / f"{name}.flo", fl)
        else:
            kitti.write_flow_png(outdir / f"{name}.png", fl, wr_valid)
        print(json.dumps({"cmd": "video", "pair": t,
                          "out": str(outdir / name),
                          "valid_frac": round(float(valids[t].mean()), 4)}))
    print(json.dumps({"cmd": "video", "pairs": int(flows.shape[0]),
                      "wall_s": round(dt, 4),
                      "ms_per_pair": round(1e3 * dt / flows.shape[0], 2)}))
    return 0


def cmd_serve(args) -> int:
    """Persistent serving loop: JSONL requests on stdin -> JSONL responses
    on stdout, keeping the compiled pipelines warm across requests (the
    first request per (task, shape) pays the compile; later ones hit
    jax's jit cache, so a stream of same-camera frames runs at device
    speed instead of paying per-process startup + compile).

    Request:  {"task": "stereo"|"flow", "id": any,
               "left"/"right" | "first"/"second": image paths,
               "out": output path}
              or {"task": "stereo_batch"|"flow_batch",
                  "pairs": [[a, b, out], ...]} — same-shape pairs run
              as ONE batched device dispatch
    Response: {"id", "out", "wall_s", "valid_frac"?} or {"id", "error"}.
    A blank line or EOF ends the loop.  Ordering is preserved; responses
    are flushed per request so a driving process can pipeline."""
    import jax.numpy as jnp
    from fsgm_tpu.params import SGMParams, FlowParams
    from fsgm_tpu.models.stereo import stereo_sgm
    from fsgm_tpu.models.flow import flow_fsgm
    from fsgm_tpu.io.images import load_gray
    from fsgm_tpu.io import kitti

    from collections import deque

    be = _backend(args.backend)
    # a preset usually holds ONE param kind; serve needs both, so the
    # missing one falls back to CLI-arg/default construction
    sp = _params_from_args(args, SGMParams, fallback_default=True)
    fp = _params_from_args(args, FlowParams, fallback_default=True)
    pipeline = max(0, int(getattr(args, "pipeline", 0) or 0))
    print(json.dumps({"serving": True, "backend": be}), flush=True)
    served = 0
    # --pipeline K: single-pair requests dispatch asynchronously (JAX
    # async dispatch — the device result is NOT fetched yet) and park
    # here; results are fetched/written once K newer dispatches are in
    # flight, so the per-request host work (image load, result fetch,
    # PNG encode) overlaps device execution.  Responses drain FIFO,
    # preserving request order.
    # wall_s then includes the queue dwell (dispatch -> drain).
    pending = deque()  # (rid, t0, finish) with finish() -> resp dict

    def _drain(keep: int) -> None:
        nonlocal served
        while len(pending) > keep:
            prid, pt0, finish = pending.popleft()
            try:
                presp = finish()
                presp["wall_s"] = round(time.perf_counter() - pt0, 4)
            except Exception as e:
                presp = {"id": prid, "error": f"{type(e).__name__}: {e}"}
            print(json.dumps(presp), flush=True)
            served += 1

    def _finish_stereo(rid, out, disp_dev):
        def finish():
            disp = np.asarray(disp_dev)
            kitti.write_disparity_png(out, disp)
            return {"id": rid, "out": str(out),
                    "density": round(float((disp >= 0).mean()), 4)}
        return finish

    def _finish_flow(rid, out, flow_dev, valid_dev):
        def finish():
            flow, valid = np.asarray(flow_dev), np.asarray(valid_dev)
            if out.suffix == ".flo":
                kitti.write_flo(out, np.where(valid[..., None], flow, 0))
            else:
                kitti.write_flow_png(out, np.where(valid[..., None],
                                                   flow, 0), valid)
            return {"id": rid, "out": str(out),
                    "valid_frac": round(float(valid.mean()), 4)}
        return finish

    for line in sys.stdin:
        line = line.strip()
        if not line:
            break
        req = None
        try:
            req = json.loads(line)
            rid = req.get("id", served + len(pending))
            out = Path(req["out"]) if "out" in req else None
            t0 = time.perf_counter()
            if pipeline and req["task"] in ("stereo", "flow"):
                if req["task"] == "stereo":
                    il = load_gray(req["left"])
                    ir = load_gray(req["right"])
                    disp_dev = stereo_sgm(jnp.asarray(il),
                                          jnp.asarray(ir), sp, be)
                    pending.append((rid, t0,
                                    _finish_stereo(rid, out, disp_dev)))
                else:
                    i1 = load_gray(req["first"])
                    i2 = load_gray(req["second"])
                    fl_dev, va_dev = flow_fsgm(jnp.asarray(i1),
                                               jnp.asarray(i2), fp, be)
                    pending.append((rid, t0,
                                    _finish_flow(rid, out, fl_dev,
                                                 va_dev)))
                _drain(pipeline)
                continue
            # batch/sync tasks: drain everything first so responses stay
            # in request order
            _drain(0)
            if req["task"] == "stereo":
                il = load_gray(req["left"])
                ir = load_gray(req["right"])
                disp = np.asarray(stereo_sgm(jnp.asarray(il),
                                             jnp.asarray(ir), sp, be))
                kitti.write_disparity_png(out, disp)
                resp = {"id": rid, "out": str(out),
                        "density": round(float((disp >= 0).mean()), 4)}
            elif req["task"] == "stereo_batch":
                # {"task": "stereo_batch", "pairs": [[l, r, out], ...]}:
                # same-shape pairs run as ONE batched device dispatch
                # (stereo_sgm_batch — bit-identical to single requests);
                # "out" above is unused for this task
                from fsgm_tpu.models.stereo import stereo_sgm_batch
                pairs = [(load_gray(lt), load_gray(rt), o)
                         for lt, rt, o in req["pairs"]]
                shapes = {p[0].shape for p in pairs}
                if len(shapes) != 1:
                    raise ValueError(
                        f"stereo_batch needs same-shape pairs, got "
                        f"{sorted(shapes)}")
                disps = np.asarray(stereo_sgm_batch(
                    jnp.asarray(np.stack([p[0] for p in pairs])),
                    jnp.asarray(np.stack([p[1] for p in pairs])), sp, be))
                outs, dens = [], []
                for (_, _, o), dsp in zip(pairs, disps):
                    kitti.write_disparity_png(Path(o), dsp)
                    outs.append(str(o))
                    dens.append(round(float((dsp >= 0).mean()), 4))
                resp = {"id": rid, "outs": outs, "density": dens}
            elif req["task"] == "flow_batch":
                # {"task": "flow_batch", "pairs": [[i1, i2, out], ...]}:
                # same-shape pairs in ONE dispatch via flow_fsgm_batch
                # (chunked internally; bit-identical to single requests)
                from fsgm_tpu.models.flow import flow_fsgm_batch
                pairs = [(load_gray(a), load_gray(b), o)
                         for a, b, o in req["pairs"]]
                shapes = {p[0].shape for p in pairs}
                if len(shapes) != 1:
                    raise ValueError(
                        f"flow_batch needs same-shape pairs, got "
                        f"{sorted(shapes)}")
                flows, valids = flow_fsgm_batch(
                    jnp.asarray(np.stack([p[0] for p in pairs])),
                    jnp.asarray(np.stack([p[1] for p in pairs])), fp, be)
                flows, valids = np.asarray(flows), np.asarray(valids)
                outs, vfs = [], []
                for (_, _, o), fl, va in zip(pairs, flows, valids):
                    o = Path(o)
                    if o.suffix == ".flo":
                        kitti.write_flo(o, np.where(va[..., None], fl, 0))
                    else:
                        kitti.write_flow_png(
                            o, np.where(va[..., None], fl, 0), va)
                    outs.append(str(o))
                    vfs.append(round(float(va.mean()), 4))
                resp = {"id": rid, "outs": outs, "valid_frac": vfs}
            else:
                i1 = load_gray(req["first"])
                i2 = load_gray(req["second"])
                flow, valid = flow_fsgm(jnp.asarray(i1), jnp.asarray(i2),
                                        fp, be)
                flow, valid = np.asarray(flow), np.asarray(valid)
                if out.suffix == ".flo":
                    kitti.write_flo(out, np.where(valid[..., None],
                                                  flow, 0))
                else:
                    kitti.write_flow_png(out, np.where(valid[..., None],
                                                       flow, 0), valid)
                resp = {"id": rid, "out": str(out),
                        "valid_frac": round(float(valid.mean()), 4)}
            resp["wall_s"] = round(time.perf_counter() - t0, 4)
        except Exception as e:  # per-request fault isolation
            # req is None when json.loads itself failed — never attribute
            # the error to a previous request's id.  Drain any in-flight
            # pipelined requests first so responses stay in order.
            _drain(0)
            resp = {"id": req.get("id", served) if isinstance(req, dict)
                    else served, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(resp), flush=True)
        served += 1
    _drain(0)
    import jax
    done = {"served": served}
    stats = jax.devices()[0].memory_stats()
    if stats and "peak_bytes_in_use" in stats:
        done["peak_bytes_in_use"] = stats["peak_bytes_in_use"]
    print(json.dumps(done), flush=True)
    return 0


def cmd_eval(args) -> int:
    from fsgm_tpu.io import kitti
    from fsgm_tpu.eval.metrics import d1_all, fl_all

    if args.task == "stereo":
        pred = kitti.read_disparity_png(args.pred)
        gt = kitti.read_disparity_png(args.gt)
        m = d1_all(pred, gt, gt > 0)
    else:
        pred, pred_valid = kitti.read_flow_png(args.pred)
        gt, valid = kitti.read_flow_png(args.gt)
        m = fl_all(pred, gt, valid, pred_valid=pred_valid)
    print(json.dumps(m))
    return 0


def cmd_demo(args) -> int:
    """Synthetic end-to-end demo: stereo + flow on generated fixtures."""
    import jax.numpy as jnp
    from fsgm_tpu.params import SGMParams, FlowParams
    from fsgm_tpu.models.stereo import stereo_sgm
    from fsgm_tpu.models.flow import flow_fsgm
    from fsgm_tpu.io.synthetic import random_dot_stereo, constant_flow_pair
    from fsgm_tpu.eval.metrics import d1_all, fl_all

    be = _backend(args.backend)
    img_l, img_r, gt = random_dot_stereo(128, 160, 32, seed=1)
    disp = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r),
                                 SGMParams(max_disp=32), be))
    print(json.dumps({"demo": "stereo",
                      **d1_all(disp, gt.astype(np.float64), gt > 0)}))

    i1, i2, fgt = constant_flow_pair(96, 128, 3, -2, seed=2)
    flow, fvalid = flow_fsgm(jnp.asarray(i1), jnp.asarray(i2),
                             FlowParams(search_radius=4, levels=3), be)
    print(json.dumps({"demo": "flow",
                      **fl_all(np.asarray(flow), fgt,
                               pred_valid=np.asarray(fvalid))}))
    return 0


def cmd_batch(args) -> int:
    """Batch stereo over many pairs with resume + fault injection.

    SURVEY.md §5 "Failure detection / elastic recovery": the workload is
    stateless per frame, so recovery = re-queue; the manifest makes reruns
    idempotent.  --fault-inject N simulates a worker dying after N frames
    (tests the recovery path end-to-end).
    """
    import os
    import jax.numpy as jnp
    from fsgm_tpu.params import SGMParams
    from fsgm_tpu.models.stereo import stereo_sgm
    from fsgm_tpu.io.images import load_gray
    from fsgm_tpu.io import kitti
    from fsgm_tpu.utils.manifest import RunManifest

    p = _params_from_args(args, SGMParams)
    pairs = []
    lines = Path(args.list).read_text().splitlines()
    for line in lines:
        if line.strip():
            # tab-separated when a tab is present (paths may contain
            # spaces); whitespace-separated otherwise
            fields = line.split("\t") if "\t" in line else line.split()
            if len(fields) != 3:
                raise SystemExit(
                    f"batch list line needs 3 fields (left right out, "
                    f"tab-separated if paths contain spaces): {line!r}")
            pairs.append(tuple(f.strip() for f in fields))
    manifest = RunManifest(args.manifest)
    todo = manifest.pending([out for _, _, out in pairs])
    be = _backend(args.backend)
    done_now = 0
    queue = [(lt, rt, out) for lt, rt, out in pairs if out in todo]
    bsz = max(1, getattr(args, "dispatch_batch", 1))
    carry = None          # loaded-but-mismatched pair held for next group
    i = 0
    while i < len(queue) or carry is not None:
        # group up to --dispatch-batch same-shape pairs into ONE device
        # dispatch (stereo_sgm_batch): amortizes the per-dispatch cost;
        # per-frame results are bit-identical to single dispatches
        group, shape = [], None
        if carry is not None:
            group.append(carry)
            shape = carry[0].shape
            carry = None
        while i < len(queue) and len(group) < bsz:
            left, right, out = queue[i]
            il, ir = load_gray(left), load_gray(right)
            i += 1
            if shape is None:
                shape = il.shape
            elif il.shape != shape:
                carry = (il, ir, out)
                break
            group.append((il, ir, out))
        if not group:
            continue
        t0 = time.perf_counter()
        if len(group) == 1:
            il, ir, _ = group[0]
            disps = np.asarray(stereo_sgm(jnp.asarray(il), jnp.asarray(ir),
                                          p, be))[None]
        else:
            from fsgm_tpu.models.stereo import stereo_sgm_batch
            disps = np.asarray(stereo_sgm_batch(
                jnp.asarray(np.stack([g[0] for g in group])),
                jnp.asarray(np.stack([g[1] for g in group])), p, be))
        per_frame = round((time.perf_counter() - t0) / len(group), 4)
        for (_, _, out), disp in zip(group, disps):
            kitti.write_disparity_png(out, disp)
            manifest.mark_done(out, out, wall_s=per_frame,
                               valid_frac=round(float((disp >= 0).mean()),
                                                4))
            done_now += 1
            if args.fault_inject and done_now >= args.fault_inject:
                print(json.dumps({"cmd": "batch", "fault_injected": True,
                                  "done": done_now}), flush=True)
                os._exit(17)
    print(json.dumps({"cmd": "batch", "total": len(pairs),
                      "newly_done": done_now,
                      "skipped": len(pairs) - len(todo)}))
    return 0


def cmd_kitti(args) -> int:
    """Run the full KITTI 2012/2015 benchmark from a devkit directory tree
    (SURVEY.md §1 L0 dataset adapters): per-frame JSONL records + the
    aggregate D1-all / Fl-all summary, with optional prediction output."""
    import jax.numpy as jnp
    from fsgm_tpu.params import SGMParams, FlowParams
    from fsgm_tpu.io.datasets import KittiStereoDataset, KittiFlowDataset
    from fsgm_tpu.io import kitti
    from fsgm_tpu.eval.metrics import d1_all, fl_all

    be = _backend(args.backend)
    outdir = Path(args.output_dir) if args.output_dir else None
    if outdir:
        outdir.mkdir(parents=True, exist_ok=True)
    records = []

    if args.task == "stereo":
        from fsgm_tpu.models.stereo import stereo_sgm
        ds = KittiStereoDataset(args.root, year=args.year, split=args.split,
                                occ=not args.noc)
        p = _params_from_args(args, SGMParams)
        for smp in ds:
            t0 = time.perf_counter()
            disp = np.asarray(stereo_sgm(jnp.asarray(smp.left),
                                         jnp.asarray(smp.right), p, be))
            dt = time.perf_counter() - t0
            rec = {"frame": smp.name, "wall_s": round(dt, 4)}
            if smp.gt is not None:
                rec.update(d1_all(disp, smp.gt.astype(np.float64),
                                  smp.gt_valid))
            if outdir:
                kitti.write_disparity_png(outdir / f"{smp.name}_10.png",
                                          disp)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        err_key = "d1_all"
    else:
        from fsgm_tpu.models.flow import flow_fsgm
        ds = KittiFlowDataset(args.root, year=args.year, split=args.split,
                              occ=not args.noc)
        p = FlowParams()
        if getattr(args, "preset", None):
            p = _params_from_args(args, FlowParams)
        for smp in ds:
            t0 = time.perf_counter()
            flow, valid = flow_fsgm(jnp.asarray(smp.img1),
                                    jnp.asarray(smp.img2), p, be)
            flow, valid = np.asarray(flow), np.asarray(valid)
            dt = time.perf_counter() - t0
            rec = {"frame": smp.name, "wall_s": round(dt, 4)}
            if smp.gt is not None:
                rec.update(fl_all(flow, smp.gt, smp.gt_valid,
                                  pred_valid=valid))
            if outdir:
                kitti.write_flow_png(outdir / f"{smp.name}_10.png",
                                     np.where(valid[..., None], flow, 0),
                                     valid)
            print(json.dumps(rec), flush=True)
            records.append(rec)
        err_key = "fl_all"

    scored = [r for r in records if err_key in r]
    summary = {"cmd": "kitti", "task": args.task, "year": args.year,
               "frames": len(records), "scored": len(scored)}
    if scored:
        summary[err_key] = round(
            float(np.mean([r[err_key] for r in scored])), 4)
        summary["mean_wall_s"] = round(
            float(np.mean([r["wall_s"] for r in records])), 4)
    print(json.dumps(summary))
    return 0


def cmd_scale_test(args) -> int:
    """Weak-scaling harness (SURVEY.md §3.5 `run_bench --hosts N`).

    Spawns N localhost processes with jax.distributed (the multi-host test
    tier), each contributing `--devices-per-proc` virtual CPU devices to a
    global (frame, ty) mesh, and times the tiled pipeline at 1..N
    processes; reports frames/s + weak-scaling efficiency.  It checks the
    multi-process machinery and the accounting end-to-end; CPU times say
    nothing about device scaling.
    """
    import subprocess
    import tempfile

    worker = r'''
import os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
os.environ.pop("JAX_PLATFORMS", None)
import jax
jax.config.update("jax_platforms", "cpu")
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
if nproc > 1:
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nproc, process_id=pid)
import numpy as np, jax.numpy as jnp
from fsgm_tpu.params import SGMParams, FlowParams, DistParams
from fsgm_tpu.io.synthetic import random_dot_stereo, constant_flow_pair
from fsgm_tpu.parallel.tiled import stereo_sgm_sharded
from fsgm_tpu.parallel.tiled_flow import flow_fsgm_sharded
from fsgm_tpu.parallel.multihost import global_mesh
mesh = global_mesh()
task = "%s"
dist = DistParams(tiles_y=mesh.shape["ty"], frame_shards=mesh.shape["frame"],
                  tile_mode="fast", margin=8)
F = mesh.shape["frame"]
if task == "stereo":
    p = SGMParams(max_disp=32, p1=7, p2=60)
    pairs = [random_dot_stereo(96, 128, 32, seed=s) for s in range(F)]
    run = lambda a, b: stereo_sgm_sharded(a, b, p, dist, mesh)
else:
    p = FlowParams(search_radius=3, levels=3, p1=7, p2=60)
    dist = DistParams(tiles_y=mesh.shape["ty"],
                      frame_shards=mesh.shape["frame"], tile_mode="exact")
    pairs = [constant_flow_pair(96, 128, 2, -1, seed=s) for s in range(F)]
    run = lambda a, b: flow_fsgm_sharded(a, b, p, dist, mesh)[0]
il = jnp.asarray(np.stack([q[0] for q in pairs]))
ir = jnp.asarray(np.stack([q[1] for q in pairs]))
out = run(il, ir)  # compile
out.block_until_ready()
reps = %d
t0 = time.perf_counter()
for _ in range(reps):
    run(il, ir).block_until_ready()
dt = (time.perf_counter() - t0) / reps
if pid == 0:
    print(f"RESULT {F / dt:.3f}", flush=True)
'''
    repo = str(Path(__file__).resolve().parents[2])
    results = {}
    for nproc in sorted({1, args.procs}):
        src = worker % (args.devices_per_proc, args.task, args.reps)
        with tempfile.NamedTemporaryFile("w", suffix=".py",
                                         delete=False) as f:
            f.write(src)
            wpath = f.name
        env = dict(__import__("os").environ)
        env["PYTHONPATH"] = repo
        env.pop("XLA_FLAGS", None)
        procs = [subprocess.Popen(
            [sys.executable, wpath, str(pid), str(nproc), str(args.port)],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for pid in range(nproc)]
        outs = [pr.communicate(timeout=600)[0].decode() for pr in procs]
        for pr, o in zip(procs, outs):
            if pr.returncode != 0:
                print(o[-2000:], file=sys.stderr)
                return 1
        fps = float([ln for ln in outs[0].splitlines()
                     if ln.startswith("RESULT")][0].split()[1])
        results[nproc] = fps
    from fsgm_tpu.parallel.multihost import weak_scaling_report
    rep = weak_scaling_report(results[args.procs], args.procs, results[1])
    rep["frames_per_s_1host"] = results[1]
    print(json.dumps(rep))
    return 0


def cmd_bench(args) -> int:
    import subprocess
    env = dict(__import__("os").environ)
    if args.backend != "auto":
        env["FSGM_BENCH_BACKEND"] = args.backend
    if args.batch:
        env["FSGM_BENCH_BATCH"] = str(args.batch)
    if args.config:
        env["FSGM_BENCH_CONFIG"] = args.config
    if args.trace:
        # profile one dispatch and print device time per layer
        env["FSGM_BENCH_TRACE"] = args.trace
    if args.stages:
        env["FSGM_BENCH_STAGES"] = "1"
    return subprocess.call([sys.executable,
                            str(Path(__file__).resolve().parents[2]
                                / "bench.py")], env=env)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("fsgm_tpu",
                                 description="SGM stereo / fSGM flow")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("stereo", help="stereo disparity for an image pair")
    sp.add_argument("left"); sp.add_argument("right")
    sp.add_argument("-o", "--output", required=True)
    _add_stereo_args(sp)
    sp.set_defaults(fn=cmd_stereo)

    fp = sub.add_parser("flow", help="fSGM optical flow for an image pair")
    fp.add_argument("first"); fp.add_argument("second")
    fp.add_argument("-o", "--output", required=True)
    fp.add_argument("--preset")
    fp.add_argument("--search-radius", dest="search_radius", type=int)
    fp.add_argument("--levels", type=int)
    fp.add_argument("--p1", type=int); fp.add_argument("--p2", type=int)
    fp.add_argument("--backend", default="auto",
                    choices=BACKEND_CHOICES)
    fp.add_argument("--fill-invalid", dest="fill_invalid",
                    action="store_true",
                    help="densify: fill FB-invalidated pixels from the "
                    "nearest valid row neighbor (devkit-style)")
    fp.set_defaults(fn=cmd_flow)

    vp = sub.add_parser("video",
                        help="fSGM over a frame sequence (temporal prior)")
    vp.add_argument("list", help="file of frame paths, one per line")
    vp.add_argument("-o", "--outdir", required=True)
    vp.add_argument("--format", default="png", choices=["png", "flo"])
    vp.add_argument("--preset")
    vp.add_argument("--search-radius", dest="search_radius", type=int)
    vp.add_argument("--levels", type=int)
    vp.add_argument("--track-levels", dest="track_levels", type=int,
                    default=0, help="pyramid depth for tracked pairs "
                    "(0 = same as --levels)")
    vp.add_argument("--p1", type=int); vp.add_argument("--p2", type=int)
    vp.add_argument("--backend", default="auto",
                    choices=BACKEND_CHOICES)
    vp.add_argument("--fill-invalid", dest="fill_invalid",
                    action="store_true",
                    help="densify: fill FB-invalidated pixels from the "
                    "nearest valid row neighbor (devkit-style)")
    vp.set_defaults(fn=cmd_video)

    ep = sub.add_parser("eval", help="D1-all / Fl-all vs ground truth")
    ep.add_argument("task", choices=["stereo", "flow"])
    ep.add_argument("pred"); ep.add_argument("gt")
    ep.set_defaults(fn=cmd_eval)

    svp = sub.add_parser("serve",
                         help="persistent JSONL request loop (stdin) "
                         "keeping compiled pipelines warm")
    svp.add_argument("--preset")
    svp.add_argument("--max-disp", dest="max_disp", type=int)
    svp.add_argument("--search-radius", dest="search_radius", type=int)
    svp.add_argument("--levels", type=int)
    svp.add_argument("--p1", type=int); svp.add_argument("--p2", type=int)
    svp.add_argument("--backend", default="auto",
                     choices=BACKEND_CHOICES)
    svp.add_argument("--pipeline", type=int, default=0, metavar="K",
                     help="dispatch up to K single-pair requests ahead "
                     "before fetching results (responses stay in request "
                     "order; 0 = fetch per request). Overlaps the "
                     "per-request host work with device execution")
    svp.set_defaults(fn=cmd_serve)

    dp = sub.add_parser("demo", help="synthetic end-to-end smoke run")
    dp.add_argument("--backend", default="auto",
                    choices=BACKEND_CHOICES)
    dp.set_defaults(fn=cmd_demo)

    tp = sub.add_parser("batch",
                        help="batch stereo with resume manifest")
    tp.add_argument("list", help="file of lines: left right out.png")
    tp.add_argument("--manifest", required=True)
    tp.add_argument("--fault-inject", dest="fault_inject", type=int,
                    default=0, help="die after N frames (recovery test)")
    tp.add_argument("--dispatch-batch", dest="dispatch_batch", type=int,
                    default=1,
                    help="same-shape pairs per device dispatch (batched "
                         "stereo_sgm_batch path; amortizes the dispatch "
                         "cost)")
    _add_stereo_args(tp)
    tp.set_defaults(fn=cmd_batch)

    kp = sub.add_parser("kitti",
                        help="run a KITTI 2012/2015 benchmark directory")
    kp.add_argument("task", choices=["stereo", "flow"])
    kp.add_argument("root", help="dataset root (contains training/testing)")
    kp.add_argument("--year", type=int, default=2015,
                    choices=[2012, 2015])
    kp.add_argument("--split", default="training")
    kp.add_argument("--noc", action="store_true",
                    help="score against noc (non-occluded) GT, not occ")
    kp.add_argument("--output-dir", dest="output_dir",
                    help="write predictions here (devkit naming)")
    _add_stereo_args(kp)
    kp.set_defaults(fn=cmd_kitti)

    st = sub.add_parser("scale-test",
                        help="weak-scaling harness over N localhost procs")
    st.add_argument("--task", default="stereo", choices=["stereo", "flow"])
    st.add_argument("--procs", type=int, default=2)
    st.add_argument("--devices-per-proc", dest="devices_per_proc", type=int,
                    default=4)
    st.add_argument("--reps", type=int, default=3)
    st.add_argument("--port", type=int, default=29531)
    st.set_defaults(fn=cmd_scale_test)

    bp = sub.add_parser("bench", help="throughput harness")
    bp.add_argument("--backend", default="auto",
                    choices=BACKEND_CHOICES)
    bp.add_argument("--batch", type=int)
    bp.add_argument("--config",
                    choices=["kitti", "tsukuba", "kitti16", "4k",
                             "flow", "4kflow"])
    bp.add_argument("--trace", metavar="DIR",
                    help="profiler trace of one dispatch into DIR, "
                         "reduced to device time per layer")
    bp.add_argument("--stages", action="store_true",
                    help="per-stage roofline table (stereo configs)")
    bp.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    from fsgm_tpu.utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
