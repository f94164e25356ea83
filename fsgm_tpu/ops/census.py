"""Census transform and Hamming cost in JAX (XLA path).

Design notes:
  * Descriptors are packed into uint32 words ((bits+31)//32 words, so the
    9x7 62-bit window needs 2 words) — JAX default has no uint64.
  * Hamming distance uses `lax.population_count` on the XOR, summed over
    words.
  * Bit order matches golden/sgm.py::census_transform exactly (row-major
    window scan, center skipped, bit = neighbor < center).

Reference capability: SURVEY.md §2.1 "Census transform" (reference realizes
it as MATLAB/MEX; here it is a fused XLA elementwise pipeline).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def census_transform(img: jnp.ndarray, window=(5, 5)) -> jnp.ndarray:
    """Census descriptors packed as uint32 words.

    img: (H, W) any integer/uint8 dtype.
    Returns (H, W, n_words) uint32.
    """
    ch, cw = window
    bits = ch * cw - 1
    n_words = (bits + 31) // 32
    ry, rx = ch // 2, cw // 2
    img = img.astype(jnp.int32)
    padded = jnp.pad(img, ((ry, ry), (rx, rx)), mode="edge")
    h, w = img.shape
    words = [jnp.zeros((h, w), dtype=jnp.uint32) for _ in range(n_words)]
    bit = 0
    for dy in range(-ry, ry + 1):
        for dx in range(-rx, rx + 1):
            if dy == 0 and dx == 0:
                continue
            neighbor = jax.lax.dynamic_slice(padded, (ry + dy, rx + dx), (h, w))
            b = (neighbor < img).astype(jnp.uint32)
            words[bit // 32] = words[bit // 32] | (b << jnp.uint32(bit % 32))
            bit += 1
    return jnp.stack(words, axis=-1)


def hamming(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamming distance between packed descriptors; last axis = words.

    Returns int32.
    """
    x = a ^ b
    pc = jax.lax.population_count(x).astype(jnp.int32)
    return jnp.sum(pc, axis=-1)
