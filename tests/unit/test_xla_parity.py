"""Exact-parity tests: the JAX pipeline vs the golden NumPy oracle.

SURVEY.md §4 unit tier: census exact, per-direction L_r exact integer match
for all 16 directions, WTA/LR exact, subpixel/median within float tolerance.
Aggregation cases run on both backends: the XLA scan and the GPU kernel
(ops/aggregate_triton.py, here through the Pallas interpreter).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fsgm_tpu.params import SGMParams, DIRS_16
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.ops import census as jcensus
from fsgm_tpu.ops import cost as jcost
from fsgm_tpu.ops import aggregate as jagg
from fsgm_tpu.ops import aggregate_triton as jkern
from fsgm_tpu.ops import extract as jext
from fsgm_tpu.models.stereo import stereo_sgm

import golden.sgm as g

BACKENDS = ["xla", "triton_interpret"]


def _unpack_words_to_u64(words: np.ndarray) -> np.ndarray:
    """(H, W, n_words) uint32 -> (H, W) uint64 (little word order)."""
    out = np.zeros(words.shape[:2], dtype=np.uint64)
    for i in range(words.shape[-1]):
        out |= words[..., i].astype(np.uint64) << np.uint64(32 * i)
    return out


@pytest.fixture(scope="module")
def pair():
    img_l, img_r, gt = random_dot_stereo(40, 56, 16, seed=7)
    return img_l, img_r, gt


@pytest.mark.parametrize("window", [(5, 5), (9, 7), (3, 3)])
def test_census_exact(pair, window):
    img_l, _, _ = pair
    gold = g.census_transform(img_l, window)
    ours = np.asarray(jcensus.census_transform(jnp.asarray(img_l), window))
    np.testing.assert_array_equal(_unpack_words_to_u64(ours), gold)


@pytest.mark.parametrize("window", [(5, 5), (9, 7)])
def test_cost_volume_exact(pair, window):
    img_l, img_r, _ = pair
    d = 16
    gold = g.cost_volume_stereo(g.census_transform(img_l, window),
                                g.census_transform(img_r, window), d)
    ours = jcost.cost_volume_stereo(
        jcensus.census_transform(jnp.asarray(img_l), window),
        jcensus.census_transform(jnp.asarray(img_r), window), d)
    np.testing.assert_array_equal(np.asarray(ours).astype(np.int64), gold)


def test_cost_volume_right_exact(pair):
    img_l, img_r, _ = pair
    d = 16
    gold = g.cost_volume_stereo_right(g.census_transform(img_l),
                                      g.census_transform(img_r), d)
    ours = jcost.cost_volume_stereo_right(
        jcensus.census_transform(jnp.asarray(img_l)),
        jcensus.census_transform(jnp.asarray(img_r)), d)
    np.testing.assert_array_equal(np.asarray(ours).astype(np.int64), gold)


@pytest.mark.parametrize("backend", BACKENDS)
def test_lr_reagg_pipeline_close(pair, backend):
    """lr_mode='reagg' (true right re-aggregation, SURVEY.md M3): validity
    mask exact vs golden, valid values within float tolerance, and the
    result must differ from the S-trick somewhere (it is a different LR
    definition) while keeping high density on the stereogram."""
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60, lr_mode="reagg")
    gold = g.sgm_stereo(img_l, img_r, p)
    ours = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p,
                                 backend))
    np.testing.assert_array_equal(ours < 0, gold < 0)
    both = gold >= 0
    np.testing.assert_allclose(ours[both], gold[both], atol=1e-3)
    assert (gold >= 0).mean() > 0.5, "reagg LR killed too many pixels"


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", DIRS_16)
@pytest.mark.parametrize("adaptive", [False, True])
def test_one_path_exact(pair, direction, adaptive, backend):
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60, adaptive_p2=adaptive)
    cen_l = g.census_transform(img_l, p.census_window)
    cen_r = g.census_transform(img_r, p.census_window)
    cost = g.cost_volume_stereo(cen_l, cen_r, p.max_disp, p.invalid_cost)
    gold = g.aggregate_one_path(cost, img_l, direction, p.p1, p.p2, adaptive)
    if backend == "xla":
        ours = jagg.aggregate_one_path(
            jnp.asarray(cost, dtype=jnp.int32), jnp.asarray(img_l),
            direction, p.p1, p.p2, adaptive)
    else:
        ours = jkern.aggregate_paths(
            jnp.asarray(cost, dtype=jnp.uint8), jnp.asarray(img_l),
            [direction], p.p1, p.p2, adaptive, interpret=True)
    np.testing.assert_array_equal(np.asarray(ours).astype(np.int64), gold,
                                  err_msg=f"dir={direction}")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("num_paths,adaptive", [(8, False), (16, True)])
def test_full_s_and_wta_exact(pair, num_paths, adaptive, backend):
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60, num_paths=num_paths,
                  adaptive_p2=adaptive)
    gold_disp, inter = g.sgm_stereo(img_l, img_r, p,
                                    return_intermediates=True)
    from fsgm_tpu.models.stereo import compute_s_volume
    s = np.asarray(compute_s_volume(jnp.asarray(img_l), jnp.asarray(img_r),
                                    p, backend)).astype(np.int64)
    np.testing.assert_array_equal(s, inter["S"])
    d_int = np.asarray(jext.wta(jnp.asarray(s, dtype=jnp.int32)))
    np.testing.assert_array_equal(d_int.astype(np.int64), inter["d_int"])


@pytest.mark.parametrize("impl", ["family_scan", "per_direction", "kernel"])
@pytest.mark.parametrize("num_paths,adaptive", [(8, False), (16, True)])
def test_fused_family_scan_exact(pair, num_paths, adaptive, impl):
    """Every way S is summed — the family-fused lax.scan, the sum of
    per-direction scans (aggregate_one_path, the tiled carry API) and the
    GPU kernel — must stay bit-exact vs golden S."""
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60, num_paths=num_paths,
                  adaptive_p2=adaptive)
    _, inter = g.sgm_stereo(img_l, img_r, p, return_intermediates=True)
    from fsgm_tpu.ops.census import census_transform
    from fsgm_tpu.ops.cost import cost_volume_stereo
    from fsgm_tpu.ops import aggregate as agg
    cl = census_transform(jnp.asarray(img_l), p.census_window)
    cr = census_transform(jnp.asarray(img_r), p.census_window)
    cost = cost_volume_stereo(cl, cr, p.max_disp, p.invalid_cost)
    img = jnp.asarray(img_l)
    if impl == "family_scan":
        s = agg.aggregate_paths(cost, img, p.dirs, p.p1, p.p2,
                                p.adaptive_p2)
    elif impl == "per_direction":
        s = sum(agg.aggregate_one_path(cost, img, r, p.p1, p.p2,
                                       p.adaptive_p2).astype(jnp.int32)
                for r in p.dirs)
    else:
        s = jkern.aggregate_paths(cost, img, p.dirs, p.p1, p.p2,
                                  p.adaptive_p2, s_max=p.s_invalid,
                                  interpret=True)
    np.testing.assert_array_equal(np.asarray(s).astype(np.int64),
                                  inter["S"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_full_pipeline_close(pair, backend):
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60)
    gold_disp = g.sgm_stereo(img_l, img_r, p)
    ours = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p,
                                 backend))
    # subpixel is float32 vs float64; invalid pattern must match exactly
    np.testing.assert_array_equal(ours < 0, gold_disp < 0)
    both = (ours >= 0)
    np.testing.assert_allclose(ours[both], gold_disp[both], atol=1e-3)


def test_right_wta_and_lr_exact(pair):
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60, subpixel=False,
                  median_filter=False)
    _, inter = g.sgm_stereo(img_l, img_r, p, return_intermediates=True)
    s = inter["S"]
    gold_dr = g.wta_right_from_S(s, p.s_invalid)
    ours_dr = np.asarray(jext.wta_right_from_s(
        jnp.asarray(s, dtype=jnp.int32), p.s_invalid))
    np.testing.assert_array_equal(ours_dr.astype(np.int64), gold_dr)

    gold_lr = g.lr_check(inter["d_int"].astype(np.float64), gold_dr,
                         p.lr_max_diff)
    ours_lr = np.asarray(jext.lr_check(
        jnp.asarray(inter["d_int"], dtype=jnp.float32),
        jnp.asarray(gold_dr, dtype=jnp.int32), p.lr_max_diff))
    np.testing.assert_array_equal(ours_lr, gold_lr.astype(np.float32))


def test_median_exact(rng):
    f = rng.normal(size=(23, 31)).astype(np.float32)
    gold = g.median_filter_3x3(f)
    ours = np.asarray(jext.median_filter_3x3(jnp.asarray(f)))
    np.testing.assert_array_equal(ours, gold)


@pytest.mark.parametrize("backend", BACKENDS)
def test_accuracy_on_stereogram(backend):
    """SURVEY.md §4: SGM must achieve ~0 interior error on a random-dot
    stereogram with known integer disparity."""
    img_l, img_r, gt = random_dot_stereo(96, 128, 24, seed=3)
    p = SGMParams(max_disp=24, p1=7, p2=40)
    disp = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p,
                                 backend))
    valid = disp >= 0
    err = np.abs(disp - gt)
    bad = (err > 1.0) & valid
    assert valid.mean() > 0.8
    assert bad.sum() / valid.sum() < 0.05


def test_interpolate_invalid_exact(rng):
    f = rng.normal(size=(20, 33)).astype(np.float32) * 10
    f[f < 0] = -1.0
    f[3, :] = -1.0  # fully invalid row stays invalid
    gold = g.interpolate_invalid(f.astype(np.float64))
    ours = np.asarray(jext.interpolate_invalid(jnp.asarray(f)))
    np.testing.assert_allclose(ours, gold, atol=1e-5)


def test_full_pipeline_with_fill(pair):
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60, fill_invalid=True)
    gold = g.sgm_stereo(img_l, img_r, p)
    ours = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p))
    np.testing.assert_array_equal(ours < 0, gold < 0)
    both = ours >= 0
    np.testing.assert_allclose(ours[both], gold[both], atol=1e-3)
