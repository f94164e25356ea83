"""Preset <-> bench pinning + backend resolution.

The BASELINE configs are checked in as presets in configs/*.json
(SURVEY.md §5 "Config / flag system"); bench.py constructs its measured
params FROM those files (bench.py::bench_params), and these tests pin
that the files decode into exactly the parameter objects the benchmark
describes — presets and bench can no longer drift.
"""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
from fsgm_tpu.params import (SGMParams, FlowParams, DistParams,  # noqa: E402
                             load_preset)


ALL_PRESETS = sorted(p.name for p in (REPO / "configs").glob("*.json"))


def test_all_presets_decode():
    assert ALL_PRESETS == ["kitti_16path.json", "kitti_flow.json",
                           "kitti_stereo.json", "tiled_4k.json",
                           "tsukuba.json"]
    for name in ALL_PRESETS:
        out = load_preset(str(REPO / "configs" / name))
        assert "description" in out
        assert any(isinstance(v, (SGMParams, FlowParams, DistParams))
                   for v in out.values()), name


@pytest.mark.parametrize("cfg,expected", [
    ("kitti", SGMParams(max_disp=128, p1=7, p2=100, num_paths=8,
                        subpixel=True, lr_check=True, median_filter=True)),
    ("tsukuba", SGMParams(max_disp=64, p1=7, p2=100, num_paths=8,
                          subpixel=True, lr_check=True,
                          median_filter=True)),
    ("kitti16", SGMParams(max_disp=128, p1=7, p2=100, num_paths=16,
                          adaptive_p2=True, subpixel=True, lr_check=True,
                          median_filter=True)),
    ("4k", SGMParams(max_disp=128, p1=7, p2=100, num_paths=8,
                     subpixel=True, lr_check=True, median_filter=True)),
    ("flow", FlowParams(search_radius=4, levels=4, p1=7, p2=100,
                        fb_backward="half", fb_grid="half")),
    ("4kflow", FlowParams(search_radius=4, levels=5, p1=7, p2=100,
                          fb_backward="half", fb_grid="half")),
])
def test_bench_params_match_presets(cfg, expected):
    """bench_params(cfg) == the params the bench describes.

    In particular the drift of kitti_flow.json shipping
    fb_backward="cheap" while the benchmarked default was "half" can
    never recur: the bench builds from the file and this test pins the
    file's contents."""
    assert bench.bench_params(cfg) == expected


def test_flow_label_pixels_honest_accounting():
    """The honest flow-Mpd/s numerator counts exactly the aggregated
    label-pixels: every forward pyramid level, plus the backward levels
    the configured fb_backward mode really runs."""
    fp = bench.bench_params("flow")
    h, w = 368, 1232
    dims = [(368, 1232), (184, 616), (92, 308), (46, 154)]
    fwd = sum(a * b for a, b in dims)
    bwd_half = sum(a * b for a, b in dims[1:])
    assert fp.fb_backward == "half"
    assert bench.flow_label_pixels(h, w, fp) == (fwd + bwd_half) * 81

    import dataclasses
    full = dataclasses.replace(fp, fb_backward="full")
    assert bench.flow_label_pixels(h, w, full) == 2 * fwd * 81
    single = dataclasses.replace(fp, fb_backward="single")
    assert bench.flow_label_pixels(h, w, single) == (fwd + h * w) * 81
    # 'cheap' skips extraction, not aggregation -> same count as full
    cheap = dataclasses.replace(fp, fb_backward="cheap")
    assert bench.flow_label_pixels(h, w, cheap) == 2 * fwd * 81


@pytest.mark.parametrize("cfg", sorted(bench.CONFIGS))
def test_bench_config_shapes_match_presets(cfg):
    """Every CONFIGS row names a committed preset whose label count is
    the row's D (stereo max_disp, flow (2r+1)^2)."""
    h, w, d, batch = bench.CONFIGS[cfg][:4]
    p = bench.bench_params(cfg)
    assert h > 0 and w > 0 and batch >= 1
    assert d == (p.num_labels if isinstance(p, FlowParams) else p.max_disp)


def test_backend_resolution(monkeypatch):
    """'auto' resolves from the platform of the default device — the
    scan on the CPU the tests run on — and explicit names pass through
    validated (fsgm_tpu.backend)."""
    from fsgm_tpu.backend import resolve_backend
    assert resolve_backend("auto") == "xla"
    assert resolve_backend() == "xla"
    for explicit in ("xla", "triton", "triton_interpret"):
        assert resolve_backend(explicit) == explicit
    for gone in ("pallas", "pallas_tr", "mosaic"):
        with pytest.raises(ValueError):
            resolve_backend(gone)
