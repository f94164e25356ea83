"""Tiled flow == single-device flow, bit-exact in 'exact' mode.

The pyramid, cost, and aggregation are integer; subpixel/median are the
same float32 ops on identical integers — so the whole field must match
exactly, not approximately."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fsgm_tpu.params import FlowParams, DistParams
from fsgm_tpu.io.synthetic import constant_flow_pair, blockwise_flow_pair
from fsgm_tpu.models.flow import flow_fsgm
from fsgm_tpu.parallel.tiled_flow import flow_fsgm_sharded


def _mesh(frame, ty):
    devs = jax.devices()[: frame * ty]
    return jax.make_mesh((frame, ty), ("frame", "ty"), devices=devs)


@pytest.mark.parametrize("ref_backend", ["xla", "triton_interpret"])
@pytest.mark.parametrize("frame,ty", [(1, 4), (2, 2)])
def test_tiled_flow_exact(frame, ty, ref_backend):
    """Tiled flow (scan carries across tiles) == single-device flow on
    either aggregation backend."""
    img1, img2, _, _ = blockwise_flow_pair(48, 64, 3, seed=8)
    p = FlowParams(search_radius=3, levels=3, p1=7, p2=60)
    ref, ref_valid = flow_fsgm(jnp.asarray(img1), jnp.asarray(img2), p,
                               ref_backend)
    ref, ref_valid = np.asarray(ref), np.asarray(ref_valid)

    i1 = jnp.asarray(np.stack([img1] * frame))
    i2 = jnp.asarray(np.stack([img2] * frame))
    dist = DistParams(tiles_y=ty, frame_shards=frame, tile_mode="exact")
    out, valid = flow_fsgm_sharded(i1, i2, p, dist, _mesh(frame, ty))
    out, valid = np.asarray(out), np.asarray(valid)
    for f in range(frame):
        np.testing.assert_array_equal(out[f], ref)
        np.testing.assert_array_equal(valid[f], ref_valid)


@pytest.mark.parametrize("mode", ["cheap", "single", "half"])
def test_tiled_flow_backward_modes_exact(mode):
    # the fb_backward variants must follow the same per-mode level
    # schedule as models/flow.py: tiled == single-device, bit-exact
    img1, img2, _, _ = blockwise_flow_pair(48, 64, 3, seed=8)
    p = FlowParams(search_radius=3, levels=3, p1=7, p2=60,
                   fb_backward=mode)
    ref, ref_valid = flow_fsgm(jnp.asarray(img1), jnp.asarray(img2), p)
    ref, ref_valid = np.asarray(ref), np.asarray(ref_valid)
    dist = DistParams(tiles_y=4, tile_mode="exact")
    out, valid = flow_fsgm_sharded(
        img1[None], img2[None], p, dist, _mesh(1, 4))
    np.testing.assert_array_equal(np.asarray(out)[0], ref)
    np.testing.assert_array_equal(np.asarray(valid)[0], ref_valid)


def test_tiled_flow_fast_mode_close():
    img1, img2, fgt = constant_flow_pair(48, 64, 2, -1, seed=2)
    p = FlowParams(search_radius=3, levels=3, p1=7, p2=60)
    ref, ref_valid = flow_fsgm(jnp.asarray(img1), jnp.asarray(img2), p)
    ref, ref_valid = np.asarray(ref), np.asarray(ref_valid)
    dist = DistParams(tiles_y=4, tile_mode="fast", margin=6)
    out, valid = flow_fsgm_sharded(
        img1[None], img2[None], p, dist, _mesh(1, 4))
    out, valid = np.asarray(out)[0], np.asarray(valid)[0]
    valid_both = ref_valid & valid
    mismatch = np.mean(np.abs(out[valid_both] - ref[valid_both]) > 0.5)
    assert mismatch < 0.05


def test_tiled_flow_rejects_half_grid_fb_check():
    """The tiled path checks FB on the full grid only; a half-grid
    preset is refused rather than silently checked another way."""
    p = FlowParams(search_radius=2, levels=2, fb_backward="half",
                   fb_grid="half")
    img = np.zeros((1, 16, 16), np.uint8)
    with pytest.raises(NotImplementedError):
        flow_fsgm_sharded(img, img, p, DistParams(tiles_y=2),
                          _mesh(1, 2))
