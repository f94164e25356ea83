"""Backend choice, the peak table, the trace reduction and the compile
cache rule: the parts of running on the GPU that need no card."""

from pathlib import Path

import pytest

import jax

from fsgm_tpu import backend
from fsgm_tpu.utils import compile_cache, profiling

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("platform,expected", [("gpu", "triton"),
                                               ("cpu", "xla")])
def test_platform_backend(platform, expected):
    assert backend.platform_backend(platform) == expected


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_unknown_platform_is_an_error(platform):
    """No silent fallback: a platform without a backend raises."""
    with pytest.raises(RuntimeError):
        backend.platform_backend(platform)


def test_auto_follows_the_default_device():
    assert (backend.resolve_backend("auto")
            == backend.platform_backend(jax.devices()[0].platform))


def test_h100_peaks_from_the_data_sheet():
    pk = profiling.peaks("NVIDIA H100 80GB HBM3")
    assert pk["hbm_GBps"] == 3350.0 and pk["bf16_TFLOPs"] == 989.0


@pytest.mark.parametrize("kind", ["NVIDIA H200", "cpu", "NVIDIA A100"])
def test_unknown_device_kind_is_an_error(kind):
    with pytest.raises(ValueError):
        profiling.peaks(kind)


def test_stage_timer_refuses_a_device_without_peaks():
    """StageTimer takes its peak from the table; on the CPU (no entry)
    it raises instead of defaulting."""
    with pytest.raises(ValueError):
        profiling.StageTimer()
    assert profiling.StageTimer(peak_gbs=1.0).peak_gbs == 1.0


@pytest.mark.parametrize("op_name,layer", [
    ("jit(_stereo_sgm_batch_jit)/vmap(jit(_stereo_sgm_jit))/aggregate/"
     "while/body/add", "aggregate"),
    ("jit(f)/vmap(jit(g))/census/shift_left", "census"),
    ("jit(f)/pyramid/reduce_window", "pyramid"),
    ("jit(f)/aggregate/extract/argmin", "extract"),
    ("jit(f)/transpose", "other"),
])
def test_scope_of_takes_the_innermost_layer(op_name, layer):
    assert profiling.scope_of(op_name) == layer


def test_hlo_op_names_reads_fusion_metadata():
    hlo = ('  %input_reduce_fusion.3 = u8[4]{0} fusion(%p), kind=kInput, '
           'calls=%fused, metadata={op_name="jit(f)/cost/reduce_sum" '
           'source_file="x.py" source_line=3}\n'
           '  ROOT %copy.1 = u8[4]{0} copy(%x), '
           'metadata={op_name="jit(f)/extract/copy"}\n')
    names = profiling.hlo_op_names(hlo)
    # GPU kernels take the instruction's name with "." -> "_"
    assert names == {"input_reduce_fusion.3": "jit(f)/cost/reduce_sum",
                     "copy.1": "jit(f)/extract/copy",
                     "input_reduce_fusion_3": "jit(f)/cost/reduce_sum",
                     "copy_1": "jit(f)/extract/copy"}
    assert profiling._layer_of("input_reduce_fusion.3", names) == "cost"
    assert profiling._layer_of("input_reduce_fusion_3", names) == "cost"
    assert profiling._layer_of("sgm_sweep_1_0", names) == "aggregate"
    assert profiling._layer_of("memcpy128", names) == "copy"


def test_hlo_op_names_falls_back_to_the_called_computation():
    """A fusion line without metadata takes the scope its fused
    computation's instructions carry."""
    hlo = ('%fused_computation.9 (param_0: u8[4]) -> s32[4] {\n'
           '  %param_0 = u8[4]{0} parameter(0)\n'
           '  ROOT %reduce.2 = s32[4]{0} reduce(%param_0), '
           'metadata={op_name="jit(f)/vmap(g)/aggregate/while/body/min"}\n'
           '}\n\n'
           'ENTRY %main (p: u8[4]) -> s32[4] {\n'
           '  ROOT %input_reduce_fusion_9 = s32[4]{0} fusion(%p), '
           'kind=kInput, calls=%fused_computation.9\n'
           '}\n')
    names = profiling.hlo_op_names(hlo)
    assert profiling._layer_of("input_reduce_fusion_9", names) == "aggregate"


def test_compile_cache_defers_to_the_environment():
    assert compile_cache.cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None


def test_compile_cache_default_is_inside_the_checkout():
    path = compile_cache.cache_dir({})
    assert Path(path) == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_configure_compile_cache_sets_jax(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert compile_cache.configure_compile_cache() == str(
            REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(
            REPO / ".jax_cache")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        jax.config.update("jax_compilation_cache_dir", before)
        assert compile_cache.configure_compile_cache() is None
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("name,ok", [("triton", True), ("xla", True),
                                     ("auto", True), ("pallas", False)])
def test_cli_backend_choices(name, ok):
    """The CLI offers the platform pick, the scan and the kernel; the
    old 'pallas' name is refused by argparse."""
    from fsgm_tpu.cli import main as cli
    import argparse
    ap = argparse.ArgumentParser()
    cli._add_stereo_args(ap)
    if ok:
        assert ap.parse_args(["--backend", name]).backend == name
    else:
        with pytest.raises(SystemExit):
            ap.parse_args(["--backend", name])
