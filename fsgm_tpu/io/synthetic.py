"""Synthetic test-data generators (SURVEY.md §4 fixtures).

No KITTI/Tsukuba data exists in this environment (no network, empty
reference mount — SURVEY.md §0), so correctness fixtures are synthetic:

* random-dot stereograms with known piecewise-constant integer disparity —
  SGM must recover ~0 error on these, a very sharp test;
* textured pairs warped by a known flow field for fSGM.

Pure NumPy so the golden model and tests share them without JAX.
"""

from __future__ import annotations

import numpy as np


def _texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Dense high-contrast random texture (uint8) — census-friendly."""
    return rng.integers(0, 256, size=(h, w), dtype=np.uint8)


def _box3(img: np.ndarray) -> np.ndarray:
    """3x3 integer box blur with edge-replicate padding."""
    p = np.pad(img.astype(np.int64), 1, mode="edge")
    acc = np.zeros_like(img, dtype=np.int64)
    h, w = img.shape
    for dy in range(3):
        for dx in range(3):
            acc += p[dy : dy + h, dx : dx + w]
    return acc // 9


def _multiscale_texture(rng: np.random.Generator, h: int, w: int
                        ) -> np.ndarray:
    """Texture with energy at several scales (uint8).

    Pyramid-based matching (fSGM) needs low-frequency structure that
    survives downsampling; pure per-pixel noise decorrelates at coarse
    levels.  Sum nearest-upsampled noise octaves + a light blur.
    """
    acc = np.zeros((h, w), dtype=np.int64)
    weight_total = 0
    for scale, weight in ((1, 2), (4, 3), (16, 4)):
        hh, ww = max(1, -(-h // scale)), max(1, -(-w // scale))
        noise = rng.integers(0, 256, size=(hh, ww), dtype=np.int64)
        up = np.repeat(np.repeat(noise, scale, axis=0), scale, axis=1)
        acc += weight * up[:h, :w]
        weight_total += weight
    acc = _box3(acc // weight_total)
    return np.clip(acc, 0, 255).astype(np.uint8)


def disparity_layers(h: int, w: int, max_disp: int,
                     rng: np.random.Generator, n_layers: int = 3
                     ) -> np.ndarray:
    """Piecewise-constant disparity: background plane + rectangular layers."""
    disp = np.full((h, w), max(1, max_disp // 8), dtype=np.int64)
    for _ in range(n_layers):
        d = int(rng.integers(1, max(2, max_disp - 2)))
        y0 = int(rng.integers(0, max(1, h - h // 3)))
        x0 = int(rng.integers(0, max(1, w - w // 3)))
        hh = int(rng.integers(h // 6, h // 3 + 1))
        ww = int(rng.integers(w // 6, w // 3 + 1))
        disp[y0 : y0 + hh, x0 : x0 + ww] = d
    return disp


def random_dot_stereo(h: int, w: int, max_disp: int, seed: int = 0,
                      n_layers: int = 3):
    """Random-dot stereogram with known integer disparity.

    Builds the RIGHT image as texture, then the LEFT image by sampling
    right at x - d (i.e. left(x) = right(x - d(x))), so SGM run
    left-vs-right with convention C[y,x,d]=cost(L(x), R(x-d)) recovers d.
    Pixels with x - d < 0 are filled with fresh texture (occlusion noise).

    Returns (img_l, img_r, disp_gt) — uint8, uint8, int64.
    """
    rng = np.random.default_rng(seed)
    img_r = _texture(rng, h, w)
    disp = disparity_layers(h, w, max_disp, rng, n_layers)
    xs = np.arange(w)[None, :].repeat(h, axis=0)
    src_x = xs - disp
    valid = src_x >= 0
    src_x_c = np.clip(src_x, 0, w - 1)
    yy = np.arange(h)[:, None].repeat(w, axis=1)
    img_l = img_r[yy, src_x_c]
    noise = _texture(rng, h, w)
    img_l = np.where(valid, img_l, noise).astype(np.uint8)
    return img_l, img_r, disp


def _bilinear(img: np.ndarray, ys: np.ndarray, xs: np.ndarray
              ) -> np.ndarray:
    """Bilinear sample of a float image at (ys, xs), edge-clamped."""
    h, w = img.shape
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)
    fx = np.clip(xs - x0, 0.0, 1.0)
    top = img[y0, x0] * (1 - fx) + img[y0, x1] * fx
    bot = img[y1, x0] * (1 - fx) + img[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def _smooth_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Band-limited float texture: multiscale noise blurred twice, so
    bilinear resampling at fractional offsets is a faithful model of a
    continuous image (pure per-pixel noise aliases under subpixel
    shifts and would make the parabola fit meaningless)."""
    t = _multiscale_texture(rng, h, w).astype(np.float64)
    return _box3(_box3(t).astype(np.int64)).astype(np.float64)


def fractional_shift_stereo(h: int, w: int, disp: float, seed: int = 0):
    """Stereo pair with a constant NON-INTEGER disparity: every other
    stereo fixture uses integer shifts, so without it the quadratic
    subpixel stage would only be parity-tested, never shown to help.

    left(x) = texture(x), right(x) = texture(x + disp) sampled
    bilinearly from a band-limited texture, so C[y,x,d]=cost(L(x),R(x-d))
    is minimized near d = disp.  Returns (img_l, img_r, disp_gt)."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(abs(disp))) + 2
    tex = _smooth_texture(rng, h, w + 2 * pad)
    ys = np.arange(h, dtype=np.float64)[:, None].repeat(w, axis=1)
    xs = np.arange(w, dtype=np.float64)[None, :].repeat(h, axis=0) + pad
    img_l = _bilinear(tex, ys, xs)
    img_r = _bilinear(tex, ys, xs + disp)
    gt = np.full((h, w), disp, dtype=np.float64)
    clip = lambda a: np.clip(np.rint(a), 0, 255).astype(np.uint8)  # noqa
    return clip(img_l), clip(img_r), gt


def fractional_flow_pair(h: int, w: int, u: float, v: float, seed: int = 0):
    """Flow pair with constant NON-INTEGER motion (u, v): img2 is img1
    bilinearly resampled at p - (u, v), i.e. img2(p + (u, v)) = img1(p).
    Same convention as constant_flow_pair.  Returns (img1, img2,
    flow_gt)."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(max(abs(u), abs(v)))) + 2
    tex = _smooth_texture(rng, h + 2 * pad, w + 2 * pad)
    ys = np.arange(h, dtype=np.float64)[:, None].repeat(w, axis=1) + pad
    xs = np.arange(w, dtype=np.float64)[None, :].repeat(h, axis=0) + pad
    img1 = _bilinear(tex, ys, xs)
    img2 = _bilinear(tex, ys - v, xs - u)
    flow = np.zeros((h, w, 2), dtype=np.float64)
    flow[..., 0] = u
    flow[..., 1] = v
    clip = lambda a: np.clip(np.rint(a), 0, 255).astype(np.uint8)  # noqa
    return clip(img1), clip(img2), flow


def constant_flow_pair(h: int, w: int, u: int, v: int, seed: int = 0):
    """Pair where image2 is image1 translated by integer (u, v).

    flow convention: pixel p in image1 moves to p + (u, v) in image2,
    i.e. img2(y + v, x + u) = img1(y, x).  Returns (img1, img2, flow_gt)
    with flow_gt shape (h, w, 2) = (u, v) per pixel.
    """
    rng = np.random.default_rng(seed)
    big = _multiscale_texture(rng, h + 2 * abs(v) + 4, w + 2 * abs(u) + 4)
    oy, ox = abs(v) + 2, abs(u) + 2
    img1 = big[oy : oy + h, ox : ox + w]
    img2 = big[oy - v : oy - v + h, ox - u : ox - u + w]
    flow = np.zeros((h, w, 2), dtype=np.float64)
    flow[..., 0] = u
    flow[..., 1] = v
    return img1.copy(), img2.copy(), flow


def constant_flow_sequence(h: int, w: int, u: int, v: int, n: int,
                           seed: int = 0):
    """N frames sliding over one texture: frame t is the window at offset
    t*(u, v), so every consecutive pair has constant flow (u, v).  Returns
    (frames (N, h, w) uint8, flow_gt (h, w, 2)) — the temporal-prior
    fixture for flow_sequence."""
    rng = np.random.default_rng(seed)
    big = _multiscale_texture(rng, h + (n - 1) * abs(v) + 4,
                              w + (n - 1) * abs(u) + 4)
    oy = 2 + (n - 1) * max(v, 0)
    ox = 2 + (n - 1) * max(u, 0)
    frames = np.stack([
        big[oy - t * v: oy - t * v + h, ox - t * u: ox - t * u + w]
        for t in range(n)])
    flow = np.zeros((h, w, 2), dtype=np.float64)
    flow[..., 0] = u
    flow[..., 1] = v
    return frames.copy(), flow


def blockwise_flow_pair(h: int, w: int, max_mag: int, seed: int = 0):
    """Piecewise-constant flow: a moving rectangle over a static background.

    Returns (img1, img2, flow_gt, valid_mask); pixels revealed from behind
    the moving block are textured noise and marked invalid in the mask.
    """
    rng = np.random.default_rng(seed)
    img1 = _multiscale_texture(rng, h, w)
    u = int(rng.integers(-max_mag, max_mag + 1))
    v = int(rng.integers(-max_mag, max_mag + 1))
    y0, x0 = h // 4, w // 4
    hh, ww = h // 2, w // 2
    flow = np.zeros((h, w, 2), dtype=np.float64)
    flow[y0 : y0 + hh, x0 : x0 + ww, 0] = u
    flow[y0 : y0 + hh, x0 : x0 + ww, 1] = v
    img2 = img1.copy()
    # paint the displaced block into img2
    ys, xs = np.meshgrid(np.arange(y0, y0 + hh), np.arange(x0, x0 + ww),
                         indexing="ij")
    ty, tx = ys + v, xs + u
    ok = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
    img2[ty[ok], tx[ok]] = img1[ys[ok], xs[ok]]
    valid = np.ones((h, w), dtype=bool)
    # background pixels overwritten by the block are inconsistent for the
    # background flow (0,0): mark invalid
    covered = np.zeros((h, w), dtype=bool)
    covered[ty[ok], tx[ok]] = True
    covered[y0 : y0 + hh, x0 : x0 + ww] = False
    valid &= ~covered
    return img1, img2, flow, valid
