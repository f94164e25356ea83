"""Tracing / profiling harness (SURVEY.md §5 "Tracing / profiling").

  * `trace(dir)` — jax.profiler context producing a Perfetto/XProf trace
    (`FSGM_BENCH_TRACE=<dir> python bench.py`).
  * `layer_times(dir)` — reduces that trace to device time per pipeline
    layer (the `jax.named_scope` names the models set), device busy time
    and the window, so every run computes the layer split the same way.
  * `StageTimer` — wall-clock per-stage timing plus roofline accounting:
    achieved bytes/s against the device's HBM peak from `PEAKS`.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import time

# Published peaks per device kind (jax.devices()[0].device_kind).  NVIDIA
# H100 data sheet, SXM part, dense rates at the 700 W limit; a card set
# to a lower power limit cannot hold them under load.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_GBps": 3350.0, "bf16_TFLOPs": 989.0,
                              "int8_TOPs": 1979.0, "fp32_TFLOPs": 67.0},
}

# Pipeline layers, in the order the models nest them (jax.named_scope);
# layer_times adds "copy" (device memcpy) and "other".
LAYERS = ("pyramid", "census", "cost", "aggregate", "extract", "fb_check")


def peaks(device_kind: str) -> dict:
    """Peak table entry for `device_kind`; an unknown device is an error,
    not a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind "
                         f"{device_kind!r}; known: {sorted(PEAKS)}") from None


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with XProf / Perfetto)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_HLO_OP = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?'
                     r'metadata=\{[^}]*?op_name="([^"]*)"', re.M)
_HLO_CALL = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?'
                       r'calls=%?([\w.\-]+)', re.M)
_HLO_COMP = re.compile(r'^%?([\w.\-]+) .*\{\s*$', re.M)


def hlo_op_names(hlo_text: str) -> dict:
    """{instruction name: op_name} from compiled HLO text.  The GPU
    kernels of a module are named after its fusions; a fusion without
    metadata of its own takes the most common op_name scope of the
    computation it calls.  The op_name carries the `jax.named_scope`
    path."""
    names = dict(_HLO_OP.findall(hlo_text))
    comps, cur = {}, None
    for line in hlo_text.splitlines():
        head = _HLO_COMP.match(line)
        if head and "=" not in line.split("{")[0]:
            cur = comps.setdefault(head.group(1), [])
            continue
        if line.strip() == "}":
            cur = None
            continue
        op = _HLO_OP.match(line)
        if cur is not None and op:
            cur.append(op.group(2))
    for inst, comp in _HLO_CALL.findall(hlo_text):
        if scope_of(names.get(inst, "")) != "other":
            continue
        scopes = [o for o in comps.get(comp, ()) if scope_of(o) != "other"]
        if scopes:
            names[inst] = max(set(scopes), key=scopes.count)
    # GPU kernels are named after the instruction with "." -> "_"
    names.update({k.replace(".", "_"): v for k, v in names.items()})
    return names


def scope_of(op_name: str) -> str:
    """The innermost LAYERS scope in an op_name path, else "other"."""
    best = "other"
    for part in op_name.split("/"):
        part = part.split("(")[-1].rstrip(")")
        if part in LAYERS:
            best = part
    return best


def _layer_of(name: str, op_names: dict) -> str:
    if name.startswith("sgm_sweep"):        # the Pallas aggregation kernel
        return "aggregate"
    if name.startswith("memcpy"):
        return "copy"
    return scope_of(op_names.get(name, ""))


def layer_times(log_dir: str, hlo_text: str = "") -> dict:
    """Device time per layer from the newest trace under `log_dir`.

    Kernels are attributed through `hlo_text`, the compiled HLO of the
    traced program (fusion name -> op_name -> scope): XLA may run a
    module as one CUDA graph, whose kernels carry no op name in the
    trace.  Returns {"window_ms", "busy_ms", "idle_share", "layers_ms":
    {layer: ms}, "kernels": [(name, layer, ms), ...] longest first}.
    Busy is the
    union of the kernel intervals on the GPU planes; the window runs from
    the first kernel start to the last kernel end."""
    import jax
    paths = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    op_names = hlo_op_names(hlo_text)
    spans, layers, kernels = [], {}, {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                dur = ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + dur))
                layer = _layer_of(ev.name, op_names)
                layers[layer] = layers.get(layer, 0.0) + dur / 1e6
                key = (ev.name, layer)
                kernels[key] = kernels.get(key, 0.0) + dur / 1e6
    if not spans:
        raise ValueError(f"no GPU kernel events in {paths[-1]}")
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"window_ms": window / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "layers_ms": layers,
            "kernels": [(k[0], k[1], v) for k, v in ranked]}


class StageTimer:
    """Accumulates per-stage wall times + modeled HBM bytes; prints a
    roofline table (achieved vs peak bandwidth)."""

    def __init__(self, peak_gbs: float | None = None):
        if peak_gbs is None:
            import jax
            peak_gbs = peaks(jax.devices()[0].device_kind)["hbm_GBps"]
        self.peak_gbs = peak_gbs
        self.stages: dict[str, dict] = {}

    @contextlib.contextmanager
    def stage(self, name: str, bytes_moved: int = 0):
        t0 = time.perf_counter()
        yield
        self.record(name, time.perf_counter() - t0, bytes_moved)

    def record(self, name: str, seconds: float, bytes_moved: int = 0):
        """Externally measured time (e.g. an in-jit K-iteration loop whose
        wall clock was taken around block_until_ready)."""
        rec = self.stages.setdefault(name, {"s": 0.0, "bytes": 0, "n": 0})
        rec["s"] += seconds
        rec["bytes"] += bytes_moved
        rec["n"] += 1

    def report(self) -> list[dict]:
        out = []
        for name, r in self.stages.items():
            gbs = r["bytes"] / r["s"] / 1e9 if r["s"] > 0 else 0.0
            out.append({
                "stage": name, "wall_s": round(r["s"], 4), "calls": r["n"],
                "bytes": r["bytes"], "achieved_GBps": round(gbs, 1),
                "pct_of_HBM_peak": round(100 * gbs / self.peak_gbs, 1),
            })
        return out

    def print_report(self, file=None):
        for rec in self.report():
            print(json.dumps(rec), file=file)


def sgm_bytes_model(h: int, w: int, d: int, num_paths: int,
                    s_itemsize: int = 2) -> dict:
    """Modeled HBM traffic of the family-fused scan pipeline (SURVEY.md
    §7.4): per family sweep the cost volume is read once (u8) and S is
    read-modified-written (s_itemsize)."""
    vol = h * w * d
    # 4 family sweeps (down/up/left/right) regardless of 8 vs 16 paths:
    # the knight-move dirs fuse into the same row passes (_family_scan).
    n_sweeps = 4
    per_sweep = vol * (1 + 2 * s_itemsize)
    extract = vol * s_itemsize * 2          # wta + right-wta streaming reads
    cost_build = vol * 1 + 2 * h * w * 4    # write C + census reads
    return {"aggregate": n_sweeps * per_sweep, "extract": extract,
            "cost": cost_build,
            "total": n_sweeps * per_sweep + extract + cost_build}
