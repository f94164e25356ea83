"""Aggregation backend: which implementation of S = sum_r L_r runs.

  xla     - the `lax.scan` family sweeps (ops/aggregate.py); any platform,
            the reference the kernel is tested against.
  triton  - the Pallas path-line kernel (ops/aggregate_triton.py), compiled
            for the GPU through Triton.

`auto` picks from the platform of the default device: the kernel on the
GPU, the scan on the CPU (where the tests run).  Any other platform is an
error rather than a silent fallback.

The tests also pass `triton_interpret`: the same kernel run by the Pallas
interpreter, which is how it is checked where there is no GPU.  Nothing
selects it by itself.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

BACKENDS = ("xla", "triton", "triton_interpret")
_BY_PLATFORM = {"gpu": "triton", "cpu": "xla"}


def platform_backend(platform: str) -> str:
    """The backend `auto` resolves to on `platform`."""
    try:
        return _BY_PLATFORM[platform]
    except KeyError:
        raise RuntimeError(
            f"no aggregation backend for platform {platform!r}; "
            f"supported: {sorted(_BY_PLATFORM)}") from None


def resolve_backend(backend: str = "auto") -> str:
    """'auto' -> the platform's backend; explicit names are validated."""
    if backend == "auto":
        return platform_backend(jax.devices()[0].platform)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected 'auto' or "
                         f"one of {BACKENDS}")
    return backend


def aggregate(cost: jnp.ndarray, img: jnp.ndarray,
              dirs: Sequence[Tuple[int, int]], p1: int, p2: int,
              adaptive_p2: bool, backend: str, s_max: int,
              label_ext: int | None = None) -> jnp.ndarray:
    """S for an (H, W, D) cost volume on `backend`.  label_ext (flow's
    label-grid width) selects the 2D label neighbourhood on both ends;
    the scan takes it as `neighbor_min`."""
    if backend == "xla":
        from fsgm_tpu.ops import aggregate as agg
        nm = (agg.neighbor_min_1d if label_ext is None
              else agg.make_neighbor_min_2d(label_ext // 2))
        return agg.aggregate_paths(cost, img, dirs, p1, p2, adaptive_p2,
                                   neighbor_min=nm)
    from fsgm_tpu.ops import aggregate_triton
    return aggregate_triton.aggregate_paths(
        cost, img, dirs, p1, p2, adaptive_p2, label_ext=label_ext,
        s_max=s_max, interpret=backend == "triton_interpret")
