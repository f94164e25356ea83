"""fSGM flow parity: JAX pipeline (XLA scan and GPU kernel backends) vs
golden; the kernel runs through the Pallas interpreter here.

SURVEY.md §4: integer stages exact (cost volume, S, WTA labels); float
stages (subpixel, median, fb-check) within float32 tolerance; synthetic
translating pattern recovers known flow (integration tier).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fsgm_tpu.params import FlowParams
from fsgm_tpu.io.synthetic import constant_flow_pair, blockwise_flow_pair
from fsgm_tpu.ops import census as jcensus
from fsgm_tpu.ops import cost as jcost
from fsgm_tpu.models import flow as jflow

import golden.flow as gf
import golden.sgm as gs

BACKENDS = ["xla", "triton_interpret"]


@pytest.fixture(scope="module")
def pair():
    img1, img2, flow_gt = constant_flow_pair(48, 64, 2, -1, seed=3)
    return img1, img2, flow_gt


def test_cost_volume_flow_exact(pair):
    img1, img2, _ = pair
    r = 3
    cen1g = gs.census_transform(img1)
    cen2g = gs.census_transform(img2)
    rng = np.random.default_rng(0)
    bu = rng.integers(-2, 3, img1.shape)
    bv = rng.integers(-2, 3, img1.shape)
    gold = gf.cost_volume_flow(cen1g, cen2g, bu, bv, r)
    ours = jcost.cost_volume_flow(
        jcensus.census_transform(jnp.asarray(img1)),
        jcensus.census_transform(jnp.asarray(img2)),
        jnp.asarray(bu, dtype=jnp.int32), jnp.asarray(bv, dtype=jnp.int32),
        r)
    np.testing.assert_array_equal(np.asarray(ours).astype(np.int64), gold)


def test_pyramid_exact(pair):
    img1, _, _ = pair
    gold = gf.build_pyramid(img1, 3)
    ours = jflow.build_pyramid(jnp.asarray(img1), 3)
    for g, o in zip(gold, ours):
        np.testing.assert_array_equal(np.asarray(o), g)


@pytest.mark.parametrize("backend", BACKENDS)
def test_flow_full_close_to_golden(pair, backend):
    img1, img2, _ = pair
    p = FlowParams(search_radius=3, levels=3, p1=7, p2=60)
    gold, gold_valid = gf.fsgm_flow(img1, img2, p)
    ours, valid = jflow.flow_fsgm(jnp.asarray(img1), jnp.asarray(img2),
                                  p, backend)
    ours, valid = np.asarray(ours), np.asarray(valid)
    # validity planes must agree exactly; valid values within float tol
    np.testing.assert_array_equal(valid, gold_valid)
    np.testing.assert_allclose(ours[gold_valid], gold[gold_valid],
                               atol=1e-3)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["cheap", "single", "half"])
def test_flow_backward_mode_parity(pair, backend, mode):
    # fb_backward variants change only the backward pass feeding fb_check;
    # golden mirrors each mode, so parity stays exact-valid / tol-values
    img1, img2, _ = pair
    p = FlowParams(search_radius=3, levels=3, p1=7, p2=60,
                   fb_backward=mode)
    gold, gold_valid = gf.fsgm_flow(img1, img2, p)
    ours, valid = jflow.flow_fsgm(jnp.asarray(img1), jnp.asarray(img2),
                                  p, backend)
    ours, valid = np.asarray(ours), np.asarray(valid)
    np.testing.assert_array_equal(valid, gold_valid)
    np.testing.assert_allclose(ours[gold_valid], gold[gold_valid],
                               atol=1e-3)
    # the forward flow itself is UNCHANGED by the mode: compare against
    # the default-mode forward estimate (values everywhere, not just valid)
    p0 = FlowParams(search_radius=3, levels=3, p1=7, p2=60)
    base, _ = jflow.flow_fsgm(jnp.asarray(img1), jnp.asarray(img2),
                              p0, backend)
    np.testing.assert_allclose(ours, np.asarray(base), atol=1e-6)


def test_flow_single_backward_validates_constant_translation():
    # with exact constant motion the single-level backward prior (-fwd) is
    # the true backward flow, so fb_check should keep nearly all interior
    # pixels valid and the flow estimate intact
    img1, img2, flow_gt = constant_flow_pair(64, 80, 3, -2, seed=9)
    p = FlowParams(search_radius=4, levels=3, p1=7, p2=60,
                   fb_backward="single")
    out, valid = jflow.flow_fsgm(jnp.asarray(img1), jnp.asarray(img2), p)
    out, valid = np.asarray(out), np.asarray(valid)
    assert valid.mean() > 0.5
    err = np.abs(out - flow_gt)[valid]
    assert np.mean(err <= 1.0) > 0.9, f"flow error too high: {err.mean()}"


def test_flow_recovers_constant_translation():
    img1, img2, flow_gt = constant_flow_pair(64, 80, 3, -2, seed=9)
    p = FlowParams(search_radius=4, levels=3, p1=7, p2=60)
    out, valid = jflow.flow_fsgm(jnp.asarray(img1), jnp.asarray(img2), p)
    out, valid = np.asarray(out), np.asarray(valid)
    assert valid.mean() > 0.5
    err = np.abs(out - flow_gt)[valid]
    assert np.mean(err <= 1.0) > 0.9, f"flow error too high: {err.mean()}"


def test_flow_recovers_negative_u_translation():
    # leftward motion (u < -0.5): regression for the sentinel-collision bug
    # where u <= -0.5 estimates were classified invalid and zeroed
    img1, img2, flow_gt = constant_flow_pair(64, 80, -3, 2, seed=11)
    p = FlowParams(search_radius=4, levels=3, p1=7, p2=60)
    out, valid = jflow.flow_fsgm(jnp.asarray(img1), jnp.asarray(img2), p)
    out, valid = np.asarray(out), np.asarray(valid)
    assert valid.mean() > 0.5
    err = np.abs(out - flow_gt)[valid]
    assert np.mean(err <= 1.0) > 0.9, f"flow error too high: {err.mean()}"


def test_flow_blockwise_motion():
    img1, img2, flow_gt, mask = blockwise_flow_pair(64, 80, 3, seed=4)
    p = FlowParams(search_radius=4, levels=3, p1=7, p2=60)
    out, valid = jflow.flow_fsgm(jnp.asarray(img1), jnp.asarray(img2), p)
    out, valid = np.asarray(out), np.asarray(valid)
    valid = valid & mask
    epe = np.sqrt(((out - flow_gt) ** 2).sum(-1))[valid]
    assert np.mean(epe <= 1.0) > 0.8, f"EPE too high: {epe.mean()}"


@pytest.mark.parametrize("impl", ["family_scan", "per_direction", "kernel"])
def test_fused_family_scan_flow_labels_exact(pair, impl):
    """Every aggregation on the 2D-label (flow) side — the fused family
    scan with make_neighbor_min_2d, the sum of per-direction scans and
    the GPU kernel with its label-grid neighbours — must match the
    per-direction golden aggregation exactly (the stereo-path tests alone
    would miss a label-grid regression)."""
    img1, img2, _ = pair
    p = FlowParams(search_radius=2, levels=1, p1=7, p2=60)
    gold_cen1 = gs.census_transform(img1)
    gold_cen2 = gs.census_transform(img2)
    zero = np.zeros(img1.shape, dtype=np.int64)
    gold_cost = gf.cost_volume_flow(gold_cen1, gold_cen2, zero, zero,
                                    p.search_radius)
    gold_s = gf.aggregate_paths_flow(gold_cost, img1, p)
    from fsgm_tpu.ops import aggregate as agg
    from fsgm_tpu.params import DIRS_8
    cost = jcost.cost_volume_flow(
        jcensus.census_transform(jnp.asarray(img1)),
        jcensus.census_transform(jnp.asarray(img2)),
        jnp.zeros(img1.shape, jnp.int32), jnp.zeros(img1.shape, jnp.int32),
        p.search_radius)
    nm = agg.make_neighbor_min_2d(p.search_radius)
    img = jnp.asarray(img1)
    if impl == "family_scan":
        s = agg.aggregate_paths(cost, img, DIRS_8, p.p1, p.p2,
                                p.adaptive_p2, neighbor_min=nm)
    elif impl == "per_direction":
        s = sum(agg.aggregate_one_path(cost, img, r, p.p1, p.p2,
                                       p.adaptive_p2, nm).astype(jnp.int32)
                for r in DIRS_8)
    else:
        from fsgm_tpu.ops import aggregate_triton
        s = aggregate_triton.aggregate_paths(
            cost, img, DIRS_8, p.p1, p.p2, p.adaptive_p2,
            label_ext=p.window_extent, interpret=True)
    np.testing.assert_array_equal(np.asarray(s).astype(np.int64), gold_s)


def test_flow_half_backward_minimum_levels(pair):
    # levels=2 is the minimum config 'half' allows; the golden mirror
    # must not trip its own validator when the backward recursion drops
    # to a single level (regression: dataclasses.replace re-runs
    # __post_init__ with levels=1 while fb_backward was still 'half')
    img1, img2, _ = pair
    p = FlowParams(search_radius=3, levels=2, p1=7, p2=60,
                   fb_backward="half")
    gold, gold_valid = gf.fsgm_flow(img1, img2, p)
    ours, valid = jflow.flow_fsgm(jnp.asarray(img1), jnp.asarray(img2),
                                  p, "xla")
    np.testing.assert_array_equal(np.asarray(valid), gold_valid)
    np.testing.assert_allclose(np.asarray(ours)[gold_valid],
                               gold[gold_valid], atol=1e-3)


# ---------------------------------------------------------------------------
# Temporal-prior sequence mode
# ---------------------------------------------------------------------------

def test_flow_sequence_parity():
    # 3 frames: pair 0 from scratch, pair 1 seeded with pair 0's field;
    # golden mirrors the prior plumbing (downsample chain + negated
    # backward seed), so validity is exact and values are within tol
    from fsgm_tpu.io.synthetic import constant_flow_sequence
    frames, _ = constant_flow_sequence(48, 64, 2, -1, 3, seed=5)
    p = FlowParams(search_radius=3, levels=3, p1=7, p2=60)
    gold, gold_valid = gf.flow_sequence(frames, p)
    ours, valid = jflow.flow_sequence(jnp.asarray(frames), p, "xla")
    ours, valid = np.asarray(ours), np.asarray(valid)
    np.testing.assert_array_equal(valid, gold_valid)
    np.testing.assert_allclose(ours[gold_valid], gold[gold_valid],
                               atol=1e-3)


def test_flow_sequence_tracks_beyond_search_range():
    # per-pair motion (12, 0); a 2-level radius-3 pyramid reaches only
    # +-9 px from scratch but tracks fine when seeded with the previous
    # pair's field — the point of the temporal prior
    from fsgm_tpu.io.synthetic import constant_flow_sequence
    frames, _ = constant_flow_sequence(48, 96, 12, 0, 3, seed=6)
    full = FlowParams(search_radius=3, levels=4, p1=7, p2=60,
                      fb_check=False)
    track = FlowParams(search_radius=3, levels=2, p1=7, p2=60,
                       fb_check=False)
    flows, _ = jflow.flow_sequence(jnp.asarray(frames), full, "xla",
                                   track_params=track)
    err_tracked = np.abs(np.asarray(flows)[1][8:-8, 16:-16, 0] - 12)
    assert np.mean(err_tracked <= 1.0) > 0.9, err_tracked.mean()

    # control: same shallow pyramid without the prior cannot reach 12 px
    blank, _ = jflow.flow_fsgm(jnp.asarray(frames[1]),
                               jnp.asarray(frames[2]), track, "xla")
    err_blank = np.abs(np.asarray(blank)[8:-8, 16:-16, 0] - 12)
    assert np.mean(err_blank <= 1.0) < 0.5, err_blank.mean()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", ["half", "full"])
def test_flow_fb_grid_half_parity(pair, backend, mode):
    # fb_grid='half' runs the FB check itself on the half grid (tolerance
    # halved with the pixel size, validity nearest-upsampled); golden
    # mirrors, so the validity planes must agree exactly
    img1, img2, _ = pair
    p = FlowParams(search_radius=3, levels=3, p1=7, p2=60,
                   fb_backward=mode, fb_grid="half")
    gold, gold_valid = gf.fsgm_flow(img1, img2, p)
    ours, valid = jflow.flow_fsgm(jnp.asarray(img1), jnp.asarray(img2),
                                  p, backend)
    ours, valid = np.asarray(ours), np.asarray(valid)
    np.testing.assert_array_equal(valid, gold_valid)
    np.testing.assert_allclose(ours[gold_valid], gold[gold_valid],
                               atol=1e-3)
    # the half-grid verdict is constant over each 2x2 block by construction
    h2, w2 = valid.shape[0] // 2 * 2, valid.shape[1] // 2 * 2
    blocks = valid[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2)
    assert bool(np.all(blocks == blocks[:, :1, :, :1]))


def test_warp_census_blocked_matches_general():
    """warp_census_blocked == the per-pixel clipped gather at every
    in-range position, for 2x2-block-constant bases (incl. odd dims and
    multi-word census tails), with out-of-range positions masked by the
    same ok predicate both ways."""
    import numpy as np
    import jax.numpy as jnp
    from fsgm_tpu.ops.cost import warp_census_blocked

    rng = np.random.default_rng(11)
    for h, w, tail in ((20, 30, ()), (21, 31, ()), (19, 26, (2,))):
        cen2 = rng.integers(0, 1 << 31, (h, w) + tail, dtype=np.int64) \
            .astype(np.uint32)
        hb, wb = -(-h // 2), -(-w // 2)
        bu_c = rng.integers(-9, 9, (hb, wb), dtype=np.int64)
        bv_c = rng.integers(-9, 9, (hb, wb), dtype=np.int64)
        bu = np.repeat(np.repeat(bu_c, 2, 0), 2, 1)[:h, :w].astype(np.int32)
        bv = np.repeat(np.repeat(bv_c, 2, 0), 2, 1)[:h, :w].astype(np.int32)
        got = np.asarray(warp_census_blocked(
            jnp.asarray(cen2), jnp.asarray(bu), jnp.asarray(bv)))
        yy = np.arange(h)[:, None] + bv
        xx = np.arange(w)[None, :] + bu
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        want = cen2[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("batch", [1, 3])
def test_flow_fsgm_batch_matches_stacked_singles(backend, batch):
    """flow_fsgm_batch (one vmap over the batch; on the kernel backend the
    frames become a grid axis of each sweep) == stacking flow_fsgm."""
    from fsgm_tpu.models.flow import flow_fsgm_batch

    fp = FlowParams(search_radius=2, levels=2, p1=7, p2=100,
                    fb_backward="half")
    pairs = [constant_flow_pair(24, 40, 1, -1, seed=s)
             for s in range(batch)]
    a = jnp.asarray(np.stack([p[0] for p in pairs]))
    b = jnp.asarray(np.stack([p[1] for p in pairs]))
    ref_f, ref_v = zip(*[jflow.flow_fsgm(a[i], b[i], fp, backend)
                         for i in range(batch)])
    fl, va = flow_fsgm_batch(a, b, fp, backend)
    np.testing.assert_array_equal(np.asarray(fl),
                                  np.stack([np.asarray(x) for x in ref_f]))
    np.testing.assert_array_equal(np.asarray(va),
                                  np.stack([np.asarray(x) for x in ref_v]))
