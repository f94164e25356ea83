"""Time the aggregation backends against each other on the GPU.

For each bench.py config, runs bench.py once per backend — one process at
a time, the backend order alternating from config to config — with a
profiler trace, and writes one JSON line per run: bench.py's record plus
the device time per layer from the trace (utils/profiling.layer_times).
Its summary lines give the traced device time per layer per frame and
the device's idle share of the traced window.

    python tools/backend_ab.py [--configs kitti flow] [--out ab.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CONFIGS = ("kitti", "tsukuba", "kitti16", "flow", "4k", "4kflow")
BACKENDS = ("xla", "triton")


def run_one(cfg: str, backend: str, trace_dir: Path) -> dict:
    env = dict(os.environ, FSGM_BENCH_CONFIG=cfg,
               FSGM_BENCH_BACKEND=backend, FSGM_BENCH_TRACE=str(trace_dir))
    proc = subprocess.run([sys.executable, str(REPO / "bench.py")],
                          env=env, cwd=REPO, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"bench.py {cfg}/{backend} failed:\n"
                           f"{proc.stderr[-3000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    for line in proc.stderr.splitlines():
        if line.startswith("# layers "):
            rec["trace"] = json.loads(line[len("# layers "):])
        elif line.startswith("# cfg="):
            rec["summary"] = line[2:]
    rec["config"] = cfg
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS))
    ap.add_argument("--out", default="ab.jsonl")
    ap.add_argument("--trace-root", default=str(REPO / "bench_out" /
                                                "traces"))
    ap.add_argument("--hlo-out", help="copy each run's compiled HLO here")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"# card: {smi}", flush=True)
    with open(args.out, "a") as out:
        for i, cfg in enumerate(args.configs):
            order = BACKENDS if i % 2 == 0 else BACKENDS[::-1]
            for be in order:
                rec = run_one(cfg, be, Path(args.trace_root) / f"{cfg}_{be}")
                rec["card"] = smi
                out.write(json.dumps(rec) + "\n")
                out.flush()
                hlo = Path(args.trace_root) / f"{cfg}_{be}" / "module.hlo.txt"
                if args.hlo_out and hlo.exists():
                    Path(args.hlo_out).mkdir(parents=True, exist_ok=True)
                    (Path(args.hlo_out) / f"{cfg}_{be}.hlo.txt").write_text(
                        hlo.read_text())
                tr = rec.get("trace", {})
                layers = {k: round(v / rec["batch"], 3) for k, v in
                          sorted(tr.get("layers_ms", {}).items())}
                print(f"{cfg:8s} {be:7s} {rec['ms_per_frame']:9.3f} "
                      f"ms/frame q1-q3 {rec['ms_per_frame_q1_q3']} "
                      f"traced ms/frame {layers} busy "
                      f"{tr.get('busy_ms', 0.0) / rec['batch']:.3f} idle "
                      f"share {tr.get('idle_share', 0.0):.4f}", flush=True)


if __name__ == "__main__":
    main()
