"""Stereo SGM pipeline (SURVEY.md §3.1 call stack), jit-compiled.

`stereo_sgm(imL, imR, params)` — the L5 API entry.  `params` is static
(hashable frozen dataclass) so each config compiles once.

Backend selection (fsgm_tpu.backend): 'xla' runs the `lax.scan`
aggregation (ops/aggregate.py); 'triton' the Pallas path-line kernel
(ops/aggregate_triton.py).  Both are exact-integer and bit-identical
through S.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fsgm_tpu.backend import aggregate, resolve_backend
from fsgm_tpu.params import SGMParams
from fsgm_tpu.ops.census import census_transform
from fsgm_tpu.ops.cost import cost_volume_stereo, cost_volume_stereo_right
from fsgm_tpu.ops import extract as ext


@jax.named_scope("aggregate")
def _aggregate(cost: jnp.ndarray, img: jnp.ndarray, params: SGMParams,
               backend: str) -> jnp.ndarray:
    return aggregate(cost, img, params.dirs, params.p1, params.p2,
                     params.adaptive_p2, backend, s_max=params.s_invalid)


def compute_s_volume(img_l: jnp.ndarray, img_r: jnp.ndarray,
                     params: SGMParams, backend: str = "xla") -> jnp.ndarray:
    """census -> cost -> aggregated S volume (H, W, D)."""
    with jax.named_scope("census"):
        cen_l = census_transform(img_l, params.census_window)
        cen_r = census_transform(img_r, params.census_window)
    with jax.named_scope("cost"):
        cost = cost_volume_stereo(cen_l, cen_r, params.max_disp,
                                  params.invalid_cost)
    return _aggregate(cost, img_l, params, backend)


def right_disparity_reagg(cen_l: jnp.ndarray, cen_r: jnp.ndarray,
                          img_r: jnp.ndarray, params: SGMParams,
                          backend: str) -> jnp.ndarray:
    """True LR re-aggregation (SURVEY.md §7.1 M3): full SGM over the
    right-reference cost volume guided by the right image, then WTA.
    Exact LR symmetry at 2x aggregation cost (vs the S-volume trick)."""
    with jax.named_scope("cost"):
        cost_r = cost_volume_stereo_right(cen_l, cen_r, params.max_disp,
                                          params.invalid_cost)
    s_r = _aggregate(cost_r, img_r, params, backend)
    with jax.named_scope("extract"):
        return ext.wta(s_r)


@jax.named_scope("extract")
def extract_disparity(s: jnp.ndarray, params: SGMParams,
                      d_right: jnp.ndarray | None = None) -> jnp.ndarray:
    """S volume -> final disparity field (float32, INVALID=-1).

    d_right: precomputed right-view integer disparity (lr_mode='reagg');
    None -> the S-volume trick d_R(y,x) = argmin_d S(y, x+d, d)."""
    d_int = ext.wta(s)
    disp = d_int.astype(jnp.float32)
    if params.subpixel:
        disp = ext.subpixel_refine(s, d_int)
    if params.lr_check:
        if d_right is None:
            d_right = ext.wta_right_from_s(s, params.s_invalid)
        disp = ext.lr_check(disp, d_right, params.lr_max_diff,
                            params.max_disp)
    if params.median_filter:
        disp = ext.median_filter_3x3(disp)
    if params.fill_invalid:
        disp = ext.interpolate_invalid(disp)
    return disp


@functools.partial(jax.jit, static_argnums=(2, 3))
def _stereo_sgm_jit(img_l: jnp.ndarray, img_r: jnp.ndarray,
                    params: SGMParams, backend: str) -> jnp.ndarray:
    s = compute_s_volume(img_l, img_r, params, backend)
    d_right = None
    if params.lr_check and params.lr_mode == "reagg":
        cen_l = census_transform(img_l, params.census_window)
        cen_r = census_transform(img_r, params.census_window)
        d_right = right_disparity_reagg(cen_l, cen_r, img_r, params,
                                        backend)
    return extract_disparity(s, params, d_right=d_right)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _stereo_sgm_batch_jit(imgs_l: jnp.ndarray, imgs_r: jnp.ndarray,
                          params: SGMParams, backend: str) -> jnp.ndarray:
    return jax.vmap(lambda a, b: _stereo_sgm_jit(a, b, params, backend))(
        imgs_l, imgs_r)


def stereo_sgm_batch(imgs_l: jnp.ndarray, imgs_r: jnp.ndarray,
                     params: SGMParams, backend: str = "auto"
                     ) -> jnp.ndarray:
    """Batched stereo pipeline: (B, H, W) uint8 pairs -> (B, H, W) f32,
    bit-identical to stacking stereo_sgm over the batch.  On the kernel
    backend the frames become one more grid axis of each sweep."""
    return _stereo_sgm_batch_jit(imgs_l, imgs_r, params,
                                 resolve_backend(backend))


def stereo_sgm(img_l: jnp.ndarray, img_r: jnp.ndarray, params: SGMParams,
               backend: str = "auto") -> jnp.ndarray:
    """Full stereo pipeline: (H, W) uint8 pair -> (H, W) float32 disparity.

    backend: 'auto' (picked from the platform, fsgm_tpu.backend), 'xla'
    or 'triton'.  It is resolved outside the jit, so the resolved name is
    the cache key."""
    return _stereo_sgm_jit(img_l, img_r, params, resolve_backend(backend))
