"""Smoke test of stereo and flow on the GPU, through the user entry points.

    python chip_smoke.py          # one card: device, golden, cpp, serve, full
    python chip_smoke.py --four   # the multi-card modes on 4 cards

The parent process never imports JAX.  Each phase runs in a child process
of its own, one after another, because a JAX process reserves most of the
card's memory when it starts.  A phase that fails ends the run: the exit
code is non-zero and the last line is {"ok": false, ...} (or no result at
all when no GPU is found).  On success the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases:
  device  platform, device kind and count, JAX version, nvidia-smi card
          name and power limit; fails unless the platform is "gpu".
  golden  exact integer parity with the NumPy oracle at reduced size
          (64x136 D=32, 8 paths and 16 paths with adaptive P2, a batch of
          3, a 48x64 flow pair) on every aggregation backend; kernel vs
          XLA scan S bit-exact on flow label grids up to r=8 and at full
          KITTI and 4K size.
  cpp     builds the C++ oracle (golden/cpp) with make and checks the
          kernel's S against it at full KITTI size; a failed build fails
          the phase.
  serve   KITTI-size PNG pairs through `python -m fsgm_tpu.cli serve`,
          outputs read back and checked against ground truth.
  full    stereo_sgm_batch at the kitti16 and 4k bench shapes and
          flow_fsgm_batch at the 4kflow shape, checked against ground
          truth.
  four    (--four) stereo_sgm_sharded on (frame, ty) exact and fast and on
          ty x tx, flow_fsgm_sharded, stereo_sgm_dsharded on td=4, each
          compared with the single-card result on card 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
ONE_CARD = ("device", "golden", "cpp", "serve", "full")
FOUR_CARDS = ("device", "four")
# fast-mode tile seams: mismatch bound from tests/distributed/test_tiled.py
FAST_MISMATCH = 0.05
ATOL = 1e-3          # float32 parabola rounding vs the float64 oracle


# --------------------------------------------------------------------------
# Helpers that need no card
# --------------------------------------------------------------------------

def nvidia_smi() -> str:
    """'name, power.limit' of the first card, as nvidia-smi prints it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def final_line(ok: bool, device: dict | None = None, **extra) -> str:
    """The last line of the run."""
    rec = {"ok": ok}
    if device is not None:
        rec["device"] = {k: device[k] for k in ("platform", "kind",
                                                 "count")}
    rec.update(extra)
    return json.dumps(rec)


def stereo_gt_check(disp, gt, max_disp: int, margin: int = 8) -> dict:
    """Interior disparity vs ground truth (columns >= max_disp have a real
    match): at least 60% valid (the LR check drops occlusions), and under
    5% of the valid pixels off by
    more than 1 px."""
    import numpy as np
    d = np.asarray(disp)[margin:-margin, max_disp + margin:-margin]
    g = np.asarray(gt)[margin:-margin, max_disp + margin:-margin]
    valid = d >= 0
    bad = float((np.abs(d - g) > 1.0)[valid].mean()) if valid.any() else 1.0
    rec = {"valid": float(valid.mean()), "bad": bad}
    rec["ok"] = rec["valid"] > 0.6 and bad < 0.05
    return rec


def flow_gt_check(flow, valid, gt, margin: int = 16) -> dict:
    """Interior flow vs ground truth: at least half FB-valid, and over 90%
    of the valid pixels within 1 px in both components."""
    import numpy as np
    f = np.asarray(flow)[margin:-margin, margin:-margin]
    v = np.asarray(valid)[margin:-margin, margin:-margin]
    g = np.asarray(gt)[margin:-margin, margin:-margin]
    good = (np.abs(f - g) <= 1.0).all(axis=-1)
    rec = {"valid": float(v.mean()),
           "good": float(good[v].mean()) if v.any() else 0.0}
    rec["ok"] = rec["valid"] > 0.5 and rec["good"] > 0.9
    return rec


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _say(*parts) -> None:
    print(*parts, flush=True)


# --------------------------------------------------------------------------
# Phases (each runs in a child process)
# --------------------------------------------------------------------------

def _jax():
    import jax
    from fsgm_tpu.utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    return jax


def _peak_gb(jax) -> float:
    return jax.devices()[0].memory_stats()["peak_bytes_in_use"] / 1e9


def phase_device() -> None:
    jax = _jax()
    dev = jax.devices()[0]
    rec = {"platform": dev.platform, "kind": dev.device_kind,
           "count": len(jax.devices()), "jax": jax.__version__}
    require(dev.platform == "gpu", f"platform is {dev.platform!r}, not gpu")
    _say("card:", nvidia_smi())
    _say("DEVICE " + json.dumps(rec))


def phase_golden() -> None:
    import numpy as np
    jax = _jax()
    import jax.numpy as jnp
    import golden.flow as gf
    import golden.sgm as gs
    from fsgm_tpu.io.synthetic import constant_flow_pair, random_dot_stereo
    from fsgm_tpu.models.flow import flow_fsgm
    from fsgm_tpu.models.stereo import (compute_s_volume, stereo_sgm,
                                        stereo_sgm_batch)
    from fsgm_tpu.ops import aggregate as agg
    from fsgm_tpu.ops import aggregate_triton
    from fsgm_tpu.params import DIRS_8, FlowParams, SGMParams, load_preset

    backends = ("xla", "triton")
    img_l, img_r, _ = random_dot_stereo(64, 136, 32, seed=5)
    for paths, adaptive in ((8, False), (16, True)):
        p = SGMParams(max_disp=32, p1=7, p2=60, num_paths=paths,
                      adaptive_p2=adaptive)
        gold, inter = gs.sgm_stereo(img_l, img_r, p,
                                    return_intermediates=True)
        for be in backends:
            s = np.asarray(compute_s_volume(jnp.asarray(img_l),
                                            jnp.asarray(img_r), p, be))
            require(np.array_equal(s.astype(np.int64), inter["S"]),
                    f"S != golden ({paths} paths, {be})")
            disp = np.asarray(stereo_sgm(jnp.asarray(img_l),
                                         jnp.asarray(img_r), p, be))
            require(np.array_equal(disp < 0, gold < 0)
                    and np.allclose(disp[gold >= 0], gold[gold >= 0],
                                    atol=ATOL),
                    f"disparity != golden ({paths} paths, {be})")
            _say(f"golden stereo 64x136 D=32 {paths} paths "
                 f"adaptive={adaptive} {be}: S exact, disparity within "
                 f"{ATOL}")

    p = SGMParams(max_disp=32, p1=7, p2=60)
    trip = [random_dot_stereo(64, 136, 32, seed=s) for s in range(3)]
    gold = np.stack([gs.sgm_stereo(a, b, p) for a, b, _ in trip])
    for be in backends:
        out = np.asarray(stereo_sgm_batch(
            jnp.asarray(np.stack([t[0] for t in trip])),
            jnp.asarray(np.stack([t[1] for t in trip])), p, be))
        require(np.array_equal(out < 0, gold < 0)
                and np.allclose(out[gold >= 0], gold[gold >= 0], atol=ATOL),
                f"batch of 3 != golden ({be})")
        _say(f"golden stereo batch of 3 {be}: ok")

    i1, i2, _ = constant_flow_pair(48, 64, 2, -1, seed=3)
    fp = FlowParams(search_radius=3, levels=3, p1=7, p2=60)
    gflow, gvalid = gf.fsgm_flow(i1, i2, fp)
    for be in backends:
        flow, valid = flow_fsgm(jnp.asarray(i1), jnp.asarray(i2), fp, be)
        flow, valid = np.asarray(flow), np.asarray(valid)
        require(np.array_equal(valid, gvalid)
                and np.allclose(flow[gvalid], gflow[gvalid], atol=ATOL),
                f"flow != golden ({be})")
        _say(f"golden flow 48x64 {be}: validity exact, flow within {ATOL}")

    # label grids whose +-(2r+1) shift is wider than the smallest pad
    rng = np.random.default_rng(6)
    for radius in (4, 8):
        ext = 2 * radius + 1
        cost = jnp.asarray(rng.integers(0, 256, (48, 64, ext * ext)),
                           jnp.uint8)
        img = jnp.asarray(rng.integers(0, 256, (48, 64)), jnp.uint8)
        want = agg.aggregate_paths(
            cost, img, DIRS_8, 7, 60, True,
            neighbor_min=agg.make_neighbor_min_2d(radius))
        got = aggregate_triton.aggregate_paths(cost, img, DIRS_8, 7, 60,
                                               True, label_ext=ext)
        require(np.array_equal(np.asarray(got).astype(np.int64),
                               np.asarray(want).astype(np.int64)),
                f"kernel S != XLA S on the r={radius} label grid")
        _say(f"kernel vs XLA scan, flow label grid r={radius} "
             f"({ext * ext} labels) 48x64: S bit-exact")

    for name, (h, w), preset in (("kitti", (375, 1242), "kitti_stereo"),
                                 ("4k", (2160, 3840), "tiled_4k")):
        p = load_preset(str(REPO / "configs" / f"{preset}.json"))["sgm"]
        a, b, _ = random_dot_stereo(h, w, p.max_disp, seed=1)
        a, b = jnp.asarray(a), jnp.asarray(b)
        s_x = compute_s_volume(a, b, p, "xla")
        s_k = compute_s_volume(a, b, p, "triton")
        same = bool(jnp.array_equal(s_x, s_k.astype(s_x.dtype)))
        del s_x, s_k
        require(same, f"kernel S != XLA S at {name} size")
        _say(f"kernel vs XLA scan at {name} {h}x{w} D={p.max_disp}: "
             f"S bit-exact")
    _say(f"golden phase peak device memory {_peak_gb(jax):.2f} GB")


def phase_cpp() -> None:
    proc = subprocess.run(["make", "-B", "-C", str(REPO / "golden" / "cpp")],
                          capture_output=True, text=True)
    _say(proc.stdout.strip())
    if proc.returncode != 0:
        _say(proc.stderr.strip()[-3000:])
    require(proc.returncode == 0, f"make golden/cpp exited {proc.returncode}")

    import numpy as np
    _jax()
    import jax.numpy as jnp
    import golden.cpp_binding as cpp
    from fsgm_tpu.io.synthetic import random_dot_stereo
    from fsgm_tpu.models.stereo import compute_s_volume
    from fsgm_tpu.params import load_preset

    p = load_preset(str(REPO / "configs" / "kitti_stereo.json"))["sgm"]
    a, b, _ = random_dot_stereo(375, 1242, p.max_disp, seed=2)
    t0 = time.perf_counter()
    cl, cr = cpp.census_transform(a), cpp.census_transform(b)
    cost = cpp.cost_volume_stereo(cl, cr, p.max_disp, p.invalid_cost)
    s_gold = cpp.aggregate_paths(cost, a, p.dirs, p.p1, p.p2, p.adaptive_p2)
    oracle_s = time.perf_counter() - t0
    s = np.asarray(compute_s_volume(jnp.asarray(a), jnp.asarray(b), p,
                                    "triton"))
    require(np.array_equal(s.astype(np.int64), s_gold),
            "kernel S != C++ oracle S at KITTI size")
    _say(f"cpp oracle at KITTI 375x1242 D={p.max_disp}: kernel S "
         f"bit-exact (oracle took {oracle_s:.1f} s)")


def phase_serve() -> None:
    import numpy as np
    from fsgm_tpu.io import kitti
    from fsgm_tpu.io.images import save_gray
    from fsgm_tpu.io.synthetic import constant_flow_pair, random_dot_stereo

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        gts, reqs = {}, []
        for s in range(3):
            a, b, gt = random_dot_stereo(375, 1242, 128, seed=s)
            save_gray(tmp / f"l{s}.png", a)
            save_gray(tmp / f"r{s}.png", b)
            gts[f"d{s}"] = gt
        for s in range(2):
            reqs.append({"task": "stereo", "id": f"d{s}",
                         "left": str(tmp / f"l{s}.png"),
                         "right": str(tmp / f"r{s}.png"),
                         "out": str(tmp / f"d{s}.png")})
        reqs.append({"task": "stereo_batch", "id": "batch",
                     "pairs": [[str(tmp / f"l{s}.png"),
                                str(tmp / f"r{s}.png"),
                                str(tmp / f"b{s}.png")] for s in range(3)]})
        f1, f2, fgt = constant_flow_pair(368, 1232, 3, -2, seed=4)
        save_gray(tmp / "f1.png", f1)
        save_gray(tmp / "f2.png", f2)
        reqs.append({"task": "flow", "id": "flow",
                     "first": str(tmp / "f1.png"),
                     "second": str(tmp / "f2.png"),
                     "out": str(tmp / "flow.png")})
        stdin = "".join(json.dumps(r) + "\n" for r in reqs)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "fsgm_tpu.cli", "serve", "--preset",
             str(REPO / "configs" / "kitti_stereo.json")],
            input=stdin, capture_output=True, text=True, cwd=REPO,
            env=_child_env())
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            _say(proc.stderr[-3000:])
        require(proc.returncode == 0, f"serve exited {proc.returncode}")
        resps = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.strip()]
        for r in resps:
            _say("serve response " + json.dumps(r))
            require("error" not in r, f"serve error: {r}")
        by_id = {r["id"]: r for r in resps if "id" in r}
        require(set(by_id) == {"d0", "d1", "batch", "flow"},
                f"missing responses: {sorted(by_id)}")
        for s in range(2):
            chk = stereo_gt_check(kitti.read_disparity_png(
                tmp / f"d{s}.png"), gts[f"d{s}"], 128)
            _say(f"serve stereo d{s} vs ground truth {chk}")
            require(chk["ok"], f"serve stereo d{s} off ground truth")
        for s in range(3):
            chk = stereo_gt_check(kitti.read_disparity_png(
                tmp / f"b{s}.png"), gts[f"d{s}"], 128)
            _say(f"serve stereo_batch b{s} vs ground truth {chk}")
            require(chk["ok"], f"serve stereo_batch b{s} off ground truth")
        flow, valid = kitti.read_flow_png(tmp / "flow.png")
        chk = flow_gt_check(flow, valid, fgt)
        _say(f"serve flow vs ground truth {chk}")
        require(chk["ok"], "serve flow off ground truth")
        for r in resps:
            if "wall_s" in r:
                _say(f"serve wall {r['id']}: {r['wall_s']} s "
                     f"(first request per shape includes compile)")
        _say(f"serve total wall {wall:.1f} s for {len(reqs)} requests")
        peak = [r for r in resps if "peak_bytes_in_use" in r]
        require(bool(peak), "serve reported no peak device memory")
        _say(f"serve peak device memory "
             f"{peak[0]['peak_bytes_in_use'] / 1e9:.2f} GB")


def phase_full() -> None:
    import numpy as np
    jax = _jax()
    import jax.numpy as jnp
    import bench
    from fsgm_tpu.io.synthetic import constant_flow_pair, random_dot_stereo
    from fsgm_tpu.models.flow import flow_fsgm_batch
    from fsgm_tpu.models.stereo import stereo_sgm_batch

    for cfg in ("kitti16", "4k", "4kflow"):
        h, w, d, batch = bench.CONFIGS[cfg][:4]
        params = bench.bench_params(cfg)
        if cfg == "4kflow":
            pairs = [constant_flow_pair(h, w, 3, -2, seed=s)
                     for s in range(batch)]
        else:
            pairs = [random_dot_stereo(h, w, d, seed=s)
                     for s in range(batch)]
        a = jnp.asarray(np.stack([p[0] for p in pairs]))
        b = jnp.asarray(np.stack([p[1] for p in pairs]))
        t0 = time.perf_counter()
        if cfg == "4kflow":
            flow, valid = jax.block_until_ready(
                flow_fsgm_batch(a, b, params))
            checks = [flow_gt_check(flow[i], valid[i], pairs[i][2])
                      for i in range(batch)]
        else:
            disp = jax.block_until_ready(stereo_sgm_batch(a, b, params))
            checks = [stereo_gt_check(disp[i], pairs[i][2], d)
                      for i in range(batch)]
        wall = time.perf_counter() - t0
        _say(f"full {cfg} {h}x{w} batch {batch}: first call (compile "
             f"included) {wall:.1f} s, checks {checks}")
        require(all(c["ok"] for c in checks), f"{cfg} off ground truth")
        _say(f"full {cfg} peak device memory {_peak_gb(jax):.2f} GB")


def phase_four() -> None:
    jax = _jax()
    devs = jax.devices()
    require(len(devs) >= 4, f"--four needs 4 cards, found {len(devs)}")
    four_checks(devs[:4])


# (4K stereo tiles, KITTI flow pair, KITTI stereo for td=4), as (H, W)
FOUR_SHAPES = ((2160, 3840), (368, 1232), (375, 1242))


def four_checks(devs, shapes=FOUR_SHAPES, max_disp: int | None = None
                ) -> None:
    """The multi-card modes on the 4 devices `devs`, each against the
    single-device result on devs[0].  `shapes` and `max_disp` (which
    overrides the presets' D) shrink the run for virtual CPU devices."""
    import dataclasses
    import numpy as np
    import jax
    import jax.numpy as jnp
    from fsgm_tpu.io.synthetic import constant_flow_pair, random_dot_stereo
    from fsgm_tpu.models.flow import flow_fsgm_batch
    from fsgm_tpu.models.stereo import stereo_sgm, stereo_sgm_batch
    from fsgm_tpu.params import DistParams, load_preset
    from fsgm_tpu.parallel import (flow_fsgm_sharded, stereo_sgm_dsharded,
                                   stereo_sgm_sharded)

    (sh, sw), (fh, fw), (th, tw) = shapes
    sp = load_preset(str(REPO / "configs" / "tiled_4k.json"))["sgm"]
    p = load_preset(str(REPO / "configs" / "kitti_stereo.json"))["sgm"]
    if max_disp is not None:
        sp = dataclasses.replace(sp, max_disp=max_disp)
        p = dataclasses.replace(p, max_disp=max_disp)
    # the tiled flow path checks FB on the full grid only
    fp = dataclasses.replace(
        load_preset(str(REPO / "configs" / "kitti_flow.json"))["flow"],
        fb_grid="full")

    def single(fn, *args):
        with jax.default_device(devs[0]):
            return np.asarray(fn(*args))

    frames = [random_dot_stereo(sh, sw, sp.max_disp, seed=s)
              for s in range(2)]
    il = np.stack([f[0] for f in frames])
    ir = np.stack([f[1] for f in frames])
    ref = single(lambda a, b: stereo_sgm_batch(a, b, sp), il, ir)
    for (frame, ty, tx), mode in (((2, 2, 1), "exact"),
                                  ((2, 2, 1), "fast"),
                                  ((1, 2, 2), "exact")):
        n = frame * ty * tx
        if tx > 1:
            mesh = jax.make_mesh((frame, ty, tx), ("frame", "ty", "tx"),
                                 devices=devs[:n])
        else:
            mesh = jax.make_mesh((frame, ty), ("frame", "ty"),
                                 devices=devs[:n])
        dist = DistParams(tiles_y=ty, tiles_x=tx, frame_shards=frame,
                          tile_mode=mode)
        t0 = time.perf_counter()
        out = np.asarray(stereo_sgm_sharded(jnp.asarray(il[:frame]),
                                            jnp.asarray(ir[:frame]), sp,
                                            dist, mesh))
        wall = time.perf_counter() - t0
        mism = float(np.mean(np.abs(out - ref[:frame]) > 1e-3))
        _say(f"four stereo {sh}x{sw} frame={frame} ty={ty} tx={tx} {mode}: "
             f"mismatch vs one card {mism:.6f} ({wall:.1f} s incl. "
             f"compile)")
        if mode == "exact":
            require(np.array_equal(out, ref[:frame]),
                    f"exact sharded stereo != one card ({frame},{ty},{tx})")
        else:
            require(mism < FAST_MISMATCH, f"fast mode mismatch {mism}")

    fl = [constant_flow_pair(fh, fw, 3, -2, seed=s) for s in range(2)]
    f1 = np.stack([f[0] for f in fl])
    f2 = np.stack([f[1] for f in fl])
    with jax.default_device(devs[0]):
        rf, rv = flow_fsgm_batch(jnp.asarray(f1), jnp.asarray(f2), fp)
        ref_f, ref_v = np.asarray(rf), np.asarray(rv)
    mesh = jax.make_mesh((2, 2), ("frame", "ty"), devices=devs)
    dist = DistParams(tiles_y=2, frame_shards=2, tile_mode="exact")
    t0 = time.perf_counter()
    out_f, out_v = flow_fsgm_sharded(jnp.asarray(f1), jnp.asarray(f2), fp,
                                     dist, mesh)
    require(np.array_equal(np.asarray(out_v), ref_v)
            and np.array_equal(np.asarray(out_f), ref_f),
            "sharded flow != one card")
    _say(f"four flow {fh}x{fw} frame=2 ty=2 exact: bit-exact vs one card "
         f"({time.perf_counter() - t0:.1f} s incl. compile)")

    a, b, _ = random_dot_stereo(th, tw, p.max_disp, seed=3)
    ref = single(lambda x, y: stereo_sgm(x, y, p), a, b)
    mesh = jax.make_mesh((4,), ("td",), devices=devs)
    t0 = time.perf_counter()
    out = np.asarray(stereo_sgm_dsharded(jnp.asarray(a), jnp.asarray(b), p,
                                         mesh))
    require(np.array_equal(out, ref), "disparity-sharded != one card")
    _say(f"four stereo {th}x{tw} D={p.max_disp} td=4: bit-exact vs one "
         f"card ({time.perf_counter() - t0:.1f} s incl. compile)")


PHASES = {"device": phase_device, "golden": phase_golden, "cpp": phase_cpp,
          "serve": phase_serve, "full": phase_full, "four": phase_four}


# --------------------------------------------------------------------------
# Parent
# --------------------------------------------------------------------------

def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def run_phase(name: str) -> tuple[int, list[str]]:
    """Run one phase in a child process, echoing its output; returns
    (exit code, stdout lines)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"),
                             "--phase", name], stdout=subprocess.PIPE,
                            text=True, cwd=REPO, env=_child_env())
    lines = []
    for line in proc.stdout:
        line = line.rstrip("\n")
        lines.append(line)
        _say(f"[{name}] {line}")
    rc = proc.wait()
    _say(f"[{name}] exit {rc} after {time.perf_counter() - t0:.1f} s")
    return rc, lines


def main(argv: list[str]) -> int:
    if argv[:1] == ["--phase"]:
        PHASES[argv[1]]()
        return 0
    phases = FOUR_CARDS if argv == ["--four"] else ONE_CARD
    if argv not in ([], ["--four"]):
        _say(__doc__)
        return 2
    device, card = None, None
    for name in phases:
        rc, lines = run_phase(name)
        if name == "device":
            found = [ln for ln in lines if ln.startswith("DEVICE ")]
            if rc != 0 or not found:
                return 1                    # no GPU: no result at all
            device = json.loads(found[0][len("DEVICE "):])
            card = next(ln[len("card: "):] for ln in lines
                        if ln.startswith("card: "))
        elif rc != 0:
            _say(final_line(False, device, failed_phase=name))
            return 1
    _say(card)                  # nvidia-smi's name and power limit
    _say(final_line(True, device))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
