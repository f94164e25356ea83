"""Distributed tier (SURVEY.md §4): tiled == untiled, bit-exact.

Runs on the 8-virtual-device CPU mesh from conftest.  The integer pipeline
makes halo/wavefront bugs hard mismatches, not epsilons.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fsgm_tpu.params import SGMParams, DistParams
from fsgm_tpu.io.synthetic import random_dot_stereo
from fsgm_tpu.models.stereo import stereo_sgm
from fsgm_tpu.parallel.tiled import stereo_sgm_sharded


def _mesh(frame: int, ty: int):
    devs = jax.devices()[: frame * ty]
    return jax.make_mesh((frame, ty), ("frame", "ty"), devices=devs)


def _mesh3(frame: int, ty: int, tx: int):
    devs = jax.devices()[: frame * ty * tx]
    return jax.make_mesh((frame, ty, tx), ("frame", "ty", "tx"),
                         devices=devs)


@pytest.fixture(scope="module")
def pair():
    return random_dot_stereo(48, 64, 16, seed=11)


@pytest.mark.parametrize("frame,ty", [(1, 4), (2, 4), (1, 8), (2, 2)])
@pytest.mark.parametrize("num_paths,adaptive", [(8, False), (16, True)])
def test_exact_tiled_matches_single(pair, frame, ty, num_paths, adaptive):
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60, num_paths=num_paths,
                  adaptive_p2=adaptive)
    ref = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p))

    il = jnp.asarray(np.stack([img_l] * frame))
    ir = jnp.asarray(np.stack([img_r] * frame))
    dist = DistParams(tiles_y=ty, frame_shards=frame, tile_mode="exact")
    out = np.asarray(stereo_sgm_sharded(il, ir, p, dist, _mesh(frame, ty)))
    for f in range(frame):
        np.testing.assert_array_equal(out[f], ref)


def test_fast_tiled_close(pair):
    """'fast' margin re-injection: tiny fraction of pixels may differ."""
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60)
    ref = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p))
    dist = DistParams(tiles_y=4, tile_mode="fast", margin=8)
    out = np.asarray(stereo_sgm_sharded(
        img_l[None], img_r[None], p, dist, _mesh(1, 4)))[0]
    mismatch = np.mean(np.abs(out - ref) > 0.5)
    assert mismatch < 0.05, f"fast-mode mismatch {mismatch:.3f}"


@pytest.mark.parametrize("ref_backend", ["xla", "triton_interpret"])
def test_exact_tiled_lr_reagg(pair, ref_backend):
    """lr_mode='reagg' under tiling: the right-volume wavefront must also
    be bit-exact vs the single-device reagg pipeline on either
    aggregation backend."""
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60, lr_mode="reagg")
    ref = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p,
                                ref_backend))
    dist = DistParams(tiles_y=4, tile_mode="exact")
    out = np.asarray(stereo_sgm_sharded(
        img_l[None], img_r[None], p, dist, _mesh(1, 4)))[0]
    np.testing.assert_array_equal(out, ref)


def test_exact_wavefront_work_accounting():
    """The lax.cond schedule must SKIP inactive tiles at runtime: total
    vertical-family rows actually swept across all devices must be H per
    family (each row aggregated once), not H * t as the old masked
    redundant-recompute construction did.
    Counted via jax.debug.callback, which only fires from the branch that
    actually executes."""
    from fsgm_tpu.parallel import tiled

    img_l, img_r, _ = random_dot_stereo(32, 48, 8, seed=17)  # unique shape
    p = SGMParams(max_disp=8, p1=7, p2=60)
    dist = DistParams(tiles_y=4, frame_shards=1, tile_mode="exact")

    counts = []
    tiled._WORK_CALLBACK = lambda tag, rows: counts.append(
        (tag, int(rows)))
    try:
        out = stereo_sgm_sharded(img_l[None], img_r[None], p, dist,
                                 _mesh(1, 4))
        out.block_until_ready()
        jax.effects_barrier()
    finally:
        tiled._WORK_CALLBACK = None

    down_rows = sum(r for tag, r in counts if tag == "down")
    up_rows = sum(r for tag, r in counts if tag == "up")
    # 4 wavefront steps x 1 active tile x 8 rows = 32 = H (not H*t = 128)
    assert down_rows == 32, (down_rows, counts)
    assert up_rows == 32, (up_rows, counts)

    # and the result is still exact
    ref = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p))
    np.testing.assert_array_equal(np.asarray(out)[0], ref)


def test_weak_scaling_model_calibration():
    """A weak-scaling model's STRUCTURAL terms (work per family, chain
    depth, fast-mode margin overhead, halo message bytes) must match what
    the real tiled implementation actually does on the virtual mesh.
    Times need the devices themselves and are not checkable here."""
    from fsgm_tpu.parallel.multihost import calibrate_weak_scaling_model
    res = calibrate_weak_scaling_model(h=64, w=48, d=16, ty=4, margin=8)
    assert res["exact"]["ok"], res
    assert res["fast"]["ok"], res
    assert res["halo"]["ok"], res


@pytest.mark.parametrize("frame,ty,tx", [(1, 1, 2), (1, 2, 2), (2, 2, 2),
                                          (1, 1, 4)])
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_column_tiled_matches_single(pair, frame, ty, tx, mode):
    """(ty, tx) block tiling (SURVEY.md §2.2 SP row): the margin-window
    construction along x must be BIT-exact at the auto margin, in both
    tile modes, composed with the y wavefront."""
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60)
    ref = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p))

    il = jnp.asarray(np.stack([img_l] * frame))
    ir = jnp.asarray(np.stack([img_r] * frame))
    dist = DistParams(tiles_y=ty, tiles_x=tx, frame_shards=frame,
                      tile_mode=mode)
    out = np.asarray(stereo_sgm_sharded(il, ir, p, dist,
                                        _mesh3(frame, ty, tx)))
    for f in range(frame):
        np.testing.assert_array_equal(out[f], ref)


@pytest.mark.parametrize("num_paths,adaptive,lr_mode",
                         [(16, True, "s_trick"), (8, False, "reagg")])
def test_column_tiled_variants(pair, num_paths, adaptive, lr_mode):
    """Column tiling with 16-path/adaptive-P2 and with true LR
    re-aggregation (the right volume's +d windows also ride gx)."""
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60, num_paths=num_paths,
                  adaptive_p2=adaptive, lr_mode=lr_mode)
    ref = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p))
    dist = DistParams(tiles_y=2, tiles_x=2, tile_mode="exact")
    out = np.asarray(stereo_sgm_sharded(
        img_l[None], img_r[None], p, dist, _mesh3(1, 2, 2)))[0]
    np.testing.assert_array_equal(out, ref)


def test_margin_sweep_forgetting_bound():
    """Empirical margin-vs-error curve (SURVEY.md §7.3 item 1): 'fast' mode
    must be golden-exact once margin >= forgetting_margin(p1, p2, cmax) =
    ceil((Cmax + P2) / P1), and the auto margin (DistParams.margin=0) must
    therefore be exact whenever tiles are at least that tall."""
    from fsgm_tpu.params import forgetting_margin
    img_l, img_r, _ = random_dot_stereo(128, 64, 16, seed=13)
    p = SGMParams(max_disp=16, p1=7, p2=60)
    bound = forgetting_margin(p.p1, p.p2, cmax=p.invalid_cost)  # 45 rows
    assert bound <= 64, "tile height (64) must cover the bound"
    ref = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p))

    mism = {}
    for margin in (1, 8, bound):
        dist = DistParams(tiles_y=2, tile_mode="fast", margin=margin)
        out = np.asarray(stereo_sgm_sharded(
            img_l[None], img_r[None], p, dist, _mesh(1, 2)))[0]
        mism[margin] = float(np.mean(np.abs(out - ref) > 1e-3))
    assert mism[bound] == 0.0, f"not exact at the bound: {mism}"
    assert mism[1] >= mism[8] >= mism[bound], f"not decreasing: {mism}"

    # auto margin (0) resolves to the bound and must match it exactly
    dist = DistParams(tiles_y=2, tile_mode="fast", margin=0)
    out = np.asarray(stereo_sgm_sharded(
        img_l[None], img_r[None], p, dist, _mesh(1, 2)))[0]
    np.testing.assert_array_equal(out, ref)


def test_fast_large_margin_is_exact(pair):
    """With margin >= tile height the fast mode degenerates to... not exact
    (carry itself is approximate) — but with margin = full tile and only 2
    tiles the single ppermute hop carries the true boundary state, so the
    result must be bit-exact."""
    img_l, img_r, _ = pair
    p = SGMParams(max_disp=16, p1=7, p2=60)
    ref = np.asarray(stereo_sgm(jnp.asarray(img_l), jnp.asarray(img_r), p))
    dist = DistParams(tiles_y=2, tile_mode="fast", margin=1000)
    out = np.asarray(stereo_sgm_sharded(
        img_l[None], img_r[None], p, dist, _mesh(1, 2)))[0]
    np.testing.assert_array_equal(out, ref)
