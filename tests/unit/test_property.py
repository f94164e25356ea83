"""Property tests (SURVEY.md §4): random small images, random penalties,
all backends agree bit-exactly with the golden oracle.

hypothesis drives the shapes/penalties; the XLA path, the Pallas GPU
kernel (interpret mode), and the C++ oracle are each checked against
golden in a single derandomized sweep (CI-stable).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st, HealthCheck

import jax.numpy as jnp

from fsgm_tpu.params import DIRS_16
from fsgm_tpu.ops import aggregate as jagg
from fsgm_tpu.ops import aggregate_triton as kern

import golden.sgm as g

SET = settings(max_examples=12, deadline=None, derandomize=True,
               suppress_health_check=[HealthCheck.too_slow])


@st.composite
def problem(draw):
    h = draw(st.integers(6, 24))
    w = draw(st.integers(6, 28))
    d = draw(st.sampled_from([4, 8, 16]))
    p1 = draw(st.integers(1, 20))
    p2 = draw(st.integers(0, 200))
    adaptive = draw(st.booleans())
    seed = draw(st.integers(0, 2 ** 16))
    return h, w, d, p1, p2, adaptive, seed


def _fixture(h, w, d, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cost = rng.integers(0, 64, (h, w, d)).astype(np.int64)
    return img, cost


@given(problem(), st.sampled_from(range(len(DIRS_16))))
@SET
def test_xla_one_path_matches_golden(prob, dir_idx):
    h, w, d, p1, p2, adaptive, seed = prob
    img, cost = _fixture(h, w, d, seed)
    r = DIRS_16[dir_idx]
    gold = g.aggregate_one_path(cost, img, r, p1, p2, adaptive)
    ours = jagg.aggregate_one_path(
        jnp.asarray(cost, jnp.int32), jnp.asarray(img), r, p1, p2, adaptive)
    np.testing.assert_array_equal(np.asarray(ours).astype(np.int64), gold)


@given(problem())
@SET
def test_pallas_all_dirs_match_golden(prob):
    h, w, d, p1, p2, adaptive, seed = prob
    img, cost = _fixture(h, w, d, seed)
    gold = np.zeros_like(cost)
    for r in DIRS_16:
        gold += g.aggregate_one_path(cost, img, r, p1, p2, adaptive)
    ours = kern.aggregate_paths(
        jnp.asarray(cost, jnp.uint8), jnp.asarray(img), DIRS_16, p1, p2,
        adaptive, interpret=True)
    np.testing.assert_array_equal(np.asarray(ours).astype(np.int64), gold)


@given(problem())
@SET
def test_cpp_matches_golden(prob):
    cpp = pytest.importorskip("golden.cpp_binding")
    try:
        cpp._load()
    except Exception:
        pytest.skip("g++ unavailable")
    h, w, d, p1, p2, adaptive, seed = prob
    img, cost = _fixture(h, w, d, seed)
    gold = np.zeros_like(cost)
    for r in DIRS_16:
        gold += g.aggregate_one_path(cost, img, r, p1, p2, adaptive)
    ours = cpp.aggregate_paths(cost, img, DIRS_16, p1, p2, adaptive)
    np.testing.assert_array_equal(ours, gold)


@given(st.integers(2, 30), st.integers(2, 30), st.integers(0, 2 ** 16))
@SET
def test_median_matches_golden(h, w, seed):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(h, w)).astype(np.float32)
    from fsgm_tpu.ops import extract as ext
    np.testing.assert_array_equal(
        np.asarray(ext.median_filter_3x3(jnp.asarray(f))),
        g.median_filter_3x3(f))


@given(st.integers(3, 14), st.integers(3, 16), st.integers(1, 3),
       st.integers(1, 20), st.integers(0, 200), st.integers(0, 2 ** 16))
@SET
def test_kernel_flow_labels_match_golden(h, w, radius, p1, p2, seed):
    """The kernel's 2D label-grid neighbourhood (+-1 within a grid row,
    +-(2r+1) across rows, INF-padded to a power of two) == the golden
    flow aggregation for random shapes, radii and penalties."""
    import golden.flow as gf
    from fsgm_tpu.params import DIRS_8, FlowParams
    rng = np.random.default_rng(seed)
    ext = 2 * radius + 1
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cost = rng.integers(0, 256, (h, w, ext * ext)).astype(np.int64)
    p = FlowParams(search_radius=radius, p1=p1, p2=p2)
    gold = gf.aggregate_paths_flow(cost, img, p)
    ours = kern.aggregate_paths(
        jnp.asarray(cost, jnp.uint8), jnp.asarray(img), DIRS_8, p1, p2,
        False, label_ext=ext, interpret=True)
    np.testing.assert_array_equal(np.asarray(ours).astype(np.int64), gold)


@given(st.integers(1, 40), st.integers(1, 40),
       st.sampled_from(range(len(DIRS_16))))
@SET
def test_line_geometry_partitions_pixels(h, w, dir_idx):
    """Every pixel lies on exactly one kernel path line, and consecutive
    steps of a line are one direction step apart — the property that
    lets each direction accumulate S in place with no two programs
    touching the same pixel."""
    r = DIRS_16[dir_idx]
    geo = kern.line_geometry(r, h, w)
    hits = np.zeros((h, w), np.int64)
    for par in range(geo["a"]):
        for k in range(geo["k0"], geo["k0"] + geo["n_lines"]):
            prev = None
            for t in range(geo["steps"]):
                u = par + geo["a"] * t
                v = k + geo["r_cross"] * t
                if not (0 <= v < geo["n_cross"] and u < geo["n_walk"]):
                    prev = None
                    continue
                if not geo["forward"]:
                    u = geo["n_walk"] - 1 - u
                y, x = (u, v) if geo["rows"] else (v, u)
                hits[y, x] += 1
                if prev is not None:
                    assert (y - prev[0], x - prev[1]) == r
                prev = (y, x)
    assert (hits == 1).all()
