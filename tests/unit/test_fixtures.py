"""Frozen golden fixtures (SURVEY.md §4): the oracle's outputs are pinned
as committed .npz files so a silent golden-model regression cannot hide —
the live parity tests compare pipeline-vs-oracle, these compare
oracle-vs-its-own-frozen-past AND pipeline-vs-frozen directly.

Regenerate deliberately with tools/freeze_fixtures.py (see its docstring).
"""

from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp

from fsgm_tpu.params import SGMParams, FlowParams
from fsgm_tpu.models.stereo import stereo_sgm
from fsgm_tpu.models.flow import flow_fsgm
import golden.sgm as gs
import golden.flow as gf

import sys
sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tools"))
import freeze_fixtures as ff  # noqa: E402

FIXDIR = Path(__file__).resolve().parents[1] / "fixtures"
# the XLA scan and the GPU kernel (through the Pallas interpreter here)
BACKENDS = ["xla", "triton_interpret"]


def _load(name):
    path = FIXDIR / f"{name}.npz"
    assert path.exists(), f"missing fixture {path}; run freeze_fixtures.py"
    return np.load(path)


@pytest.mark.parametrize("name", sorted(ff.STEREO_CASES))
def test_golden_stereo_matches_frozen(name):
    """Oracle-drift tripwire: regenerating the golden pipeline must
    reproduce the frozen fixture bit-for-bit (S and disparity)."""
    h, w, d, seed, kw = ff.STEREO_CASES[name]
    fx = _load(name)
    params = SGMParams(**kw)
    disp, inter = gs.sgm_stereo(fx["img_l"], fx["img_r"], params,
                                return_intermediates=True)
    np.testing.assert_array_equal(inter["cost"].astype(np.uint8),
                                  fx["cost"])
    np.testing.assert_array_equal(inter["S"].astype(np.int32), fx["S"])
    np.testing.assert_array_equal(inter["d_int"].astype(np.int32),
                                  fx["d_int"])
    np.testing.assert_array_equal(disp.astype(np.float64), fx["disp"])


@pytest.mark.parametrize("name", sorted(ff.FLOW_CASES))
def test_golden_flow_matches_frozen(name):
    fx = _load(name)
    h, w, u, v, seed, kw = ff.FLOW_CASES[name]
    flow, valid = gf.fsgm_flow(fx["img1"], fx["img2"], FlowParams(**kw))
    np.testing.assert_array_equal(valid, fx["valid"])
    np.testing.assert_array_equal(flow.astype(np.float64), fx["flow"])


@pytest.mark.parametrize("name", sorted(ff.STEREO_CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_stereo_matches_frozen(name, backend):
    """The jit pipeline vs the FROZEN fixture (not the live oracle):
    catches correlated drift that regenerating goldens would mask."""
    h, w, d, seed, kw = ff.STEREO_CASES[name]
    fx = _load(name)
    params = SGMParams(**kw)
    disp = np.asarray(stereo_sgm(jnp.asarray(fx["img_l"]),
                                 jnp.asarray(fx["img_r"]), params, backend))
    np.testing.assert_allclose(disp, fx["disp"].astype(np.float32),
                               atol=1e-3)


@pytest.mark.parametrize("name", sorted(ff.SEQ_CASES))
def test_golden_sequence_matches_frozen(name):
    fx = _load(name)
    h, w, u, v, n, seed, kw = ff.SEQ_CASES[name]
    flows, valids = gf.flow_sequence(fx["frames"], FlowParams(**kw))
    np.testing.assert_array_equal(valids, fx["valids"])
    np.testing.assert_array_equal(flows.astype(np.float64), fx["flows"])


@pytest.mark.parametrize("name", sorted(ff.SEQ_CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_sequence_matches_frozen(name, backend):
    from fsgm_tpu.models.flow import flow_sequence
    fx = _load(name)
    h, w, u, v, n, seed, kw = ff.SEQ_CASES[name]
    flows, valids = flow_sequence(jnp.asarray(fx["frames"]),
                                  FlowParams(**kw), backend)
    np.testing.assert_array_equal(np.asarray(valids), fx["valids"])
    np.testing.assert_allclose(np.asarray(flows), fx["flows"], atol=1e-3)


@pytest.mark.parametrize("name", sorted(ff.FLOW_CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_pipeline_flow_matches_frozen(name, backend):
    fx = _load(name)
    h, w, u, v, seed, kw = ff.FLOW_CASES[name]
    flow, valid = flow_fsgm(jnp.asarray(fx["img1"]),
                            jnp.asarray(fx["img2"]), FlowParams(**kw),
                            backend)
    np.testing.assert_array_equal(np.asarray(valid), fx["valid"])
    np.testing.assert_allclose(np.asarray(flow), fx["flow"], atol=1e-3)
