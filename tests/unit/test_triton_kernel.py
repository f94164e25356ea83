"""The GPU aggregation kernel (ops/aggregate_triton.py) on the CPU.

The kernel runs here through the Pallas interpreter (`interpret=True`),
against the XLA scan (ops/aggregate.py), which the golden-parity tests
pin to the oracles.  What the interpreter cannot show — whether Triton
accepts the kernel — is checked by lowering it for CUDA, which needs no
card; compiling and running it on the GPU is chip_smoke.py's job.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fsgm_tpu.ops import aggregate as agg
from fsgm_tpu.ops import aggregate_triton as kern
from fsgm_tpu.params import DIRS_8, DIRS_16


def _problem(h, w, d, seed=0, cmax=64):
    rng = np.random.default_rng(seed)
    cost = jnp.asarray(rng.integers(0, cmax, (h, w, d)), jnp.uint8)
    img = jnp.asarray(rng.integers(0, 256, (h, w)), jnp.uint8)
    return cost, img


def _scan(cost, img, dirs, adaptive, p1=7, p2=60, nm=agg.neighbor_min_1d):
    return np.asarray(agg.aggregate_paths(cost, img, dirs, p1, p2, adaptive,
                                          neighbor_min=nm))


def _kernel(cost, img, dirs, adaptive, p1=7, p2=60, label_ext=None):
    return np.asarray(kern.aggregate_paths(
        cost, img, dirs, p1, p2, adaptive, label_ext=label_ext,
        interpret=True)).astype(np.int32)


PATH_SETS = [(DIRS_8[:4], False), (DIRS_8, False), (DIRS_8, True),
             (DIRS_16, False), (DIRS_16, True)]


@pytest.mark.parametrize("h,w,d", [(1, 9, 8), (9, 1, 8), (5, 3, 16),
                                   (2, 17, 4), (13, 21, 16), (7, 40, 32)])
@pytest.mark.parametrize("dirs,adaptive", PATH_SETS,
                         ids=["4", "8", "8a", "16", "16a"])
def test_kernel_matches_scan_on_odd_shapes(h, w, d, dirs, adaptive):
    """Whole path sets on single-row, single-column, narrow and
    non-power-of-two shapes: lines that enter and leave through the
    sides, knight moves with one row of parity, empty parity classes."""
    cost, img = _problem(h, w, d, seed=h * 100 + w)
    np.testing.assert_array_equal(_kernel(cost, img, dirs, adaptive),
                                  _scan(cost, img, dirs, adaptive))


@pytest.mark.parametrize("d", [3, 5, 24, 40, 100])
def test_kernel_label_pad_never_wins(d):
    """Label counts that are not a power of two pad to one with INF
    lanes; the pads must never win a min or a neighbour min."""
    cost, img = _problem(9, 13, d, seed=d)
    np.testing.assert_array_equal(_kernel(cost, img, DIRS_8, True),
                                  _scan(cost, img, DIRS_8, True))


@pytest.mark.parametrize("radius", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("adaptive", [False, True])
def test_kernel_flow_label_grid(radius, adaptive):
    """The 2D label neighbourhood of fSGM flow ((2r+1)^2 labels, 81 at
    r=4, padded to 128) == the scan's make_neighbor_min_2d.  At r=8 the
    +-(2r+1) shift is wider than the smallest scratch pad."""
    ext = 2 * radius + 1
    cost, img = _problem(11, 14, ext * ext, seed=radius, cmax=256)
    nm = agg.make_neighbor_min_2d(radius)
    np.testing.assert_array_equal(
        _kernel(cost, img, DIRS_8, adaptive, label_ext=ext),
        _scan(cost, img, DIRS_8, adaptive, nm=nm))


def test_kernel_vmap_batch_matches_stacked():
    """Under vmap the frames become a grid axis of the kernel."""
    rng = np.random.default_rng(3)
    c = jnp.asarray(rng.integers(0, 200, (3, 9, 17, 16)), jnp.uint8)
    g = jnp.asarray(rng.integers(0, 256, (3, 9, 17)), jnp.uint8)
    got = jax.vmap(lambda a, b: kern.aggregate_paths(
        a, b, DIRS_16, 7, 100, True, interpret=True))(c, g)
    want = np.stack([_scan(c[i], g[i], DIRS_16, True, p2=100)
                     for i in range(3)])
    np.testing.assert_array_equal(np.asarray(got).astype(np.int32), want)


def test_kernel_nested_vmap():
    """Two vmaps (flow's fwd/bwd pair inside a frame batch) fold into one
    batch axis."""
    rng = np.random.default_rng(4)
    c = jnp.asarray(rng.integers(0, 200, (2, 2, 7, 11, 8)), jnp.uint8)
    g = jnp.asarray(rng.integers(0, 256, (2, 2, 7, 11)), jnp.uint8)
    got = jax.vmap(jax.vmap(lambda a, b: kern.aggregate_paths(
        a, b, DIRS_8, 7, 60, False, interpret=True)))(c, g)
    for i in range(2):
        for j in range(2):
            np.testing.assert_array_equal(
                np.asarray(got[i, j]).astype(np.int32),
                _scan(c[i, j], g[i, j], DIRS_8, False))


@pytest.mark.parametrize("batched", ["cost", "img"])
def test_kernel_vmap_broadcasts_unbatched_operand(batched):
    rng = np.random.default_rng(5)
    c = jnp.asarray(rng.integers(0, 200, (2, 6, 10, 8)), jnp.uint8)
    g = jnp.asarray(rng.integers(0, 256, (2, 6, 10)), jnp.uint8)
    if batched == "cost":
        got = jax.vmap(lambda a: kern.aggregate_paths(
            a, g[0], DIRS_8, 7, 60, True, interpret=True))(c)
        want = [_scan(c[i], g[0], DIRS_8, True) for i in range(2)]
    else:
        got = jax.vmap(lambda b: kern.aggregate_paths(
            c[0], b, DIRS_8, 7, 60, True, interpret=True))(g)
        want = [_scan(c[0], g[i], DIRS_8, True) for i in range(2)]
    np.testing.assert_array_equal(np.asarray(got).astype(np.int32),
                                  np.stack(want))


@pytest.mark.parametrize("label_ext,pad", [(None, 16), (9, 16), (16, 16),
                                           (17, 32), (33, 64)])
def test_scratch_pad_covers_widest_shift(label_ext, pad):
    assert kern.scratch_pad(label_ext) == pad


@pytest.mark.parametrize("s_max,dtype", [(100, jnp.uint16),
                                         (2841, jnp.uint16),
                                         ((1 << 16) - 1, jnp.uint16),
                                         (1 << 16, jnp.int32)])
def test_s_dtype_is_narrowest_exact(s_max, dtype):
    assert kern.s_dtype(s_max) == dtype


@pytest.mark.parametrize("direction", [(1, 0), (-1, 1), (0, -1), (2, -1)])
def test_direction_sweep_accumulates_in_place(direction):
    """A sweep given S adds its L_r into it (the aliased S of the
    previous direction), exactly."""
    cost, img = _problem(8, 12, 8, seed=9)
    base = jnp.asarray(np.random.default_rng(1).integers(
        0, 1000, (1, 8, 12, 8)), jnp.uint16)
    got = kern.direction_sweep(cost[None], img[None], direction, 7, 60,
                               True, base, jnp.uint16, interpret=True)
    l_r = agg.aggregate_one_path(cost, img, direction, 7, 60, True)
    np.testing.assert_array_equal(
        np.asarray(got[0]).astype(np.int32),
        np.asarray(base[0]).astype(np.int32)
        + np.asarray(l_r).astype(np.int32))


@pytest.mark.parametrize("dirs,d,label_ext,adaptive", [
    (DIRS_8, 128, None, False), (DIRS_16, 128, None, True),
    (DIRS_8, 64, None, False), (DIRS_8, 81, 9, False),
    (DIRS_8, 25, 5, True)], ids=["8", "16a", "d64", "flow81", "flow25a"])
def test_kernel_lowers_for_cuda(dirs, d, label_ext, adaptive):
    """Every lowering rule the kernel needs exists on the Triton route
    (the installed lowering has no slice, roll or n-ary concatenate; jnp
    `%` and `//` lower through a broken rule): lowering for CUDA runs on
    the CPU, without a card."""
    c = jax.ShapeDtypeStruct((2, 24, 40, d), jnp.uint8)
    g = jax.ShapeDtypeStruct((2, 24, 40), jnp.uint8)
    fn = jax.jit(jax.vmap(lambda a, b: kern.aggregate_paths(
        a, b, dirs, 7, 100, adaptive, label_ext=label_ext)))
    text = fn.trace(c, g).lower(lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == len(dirs)


@pytest.mark.parametrize("direction", DIRS_16)
@pytest.mark.parametrize("h,w", [(1, 1), (1, 6), (6, 1)])
def test_line_geometry_degenerate_images(direction, h, w):
    """Single-pixel, single-row and single-column images: every pixel
    still lies on exactly one line."""
    geo = kern.line_geometry(direction, h, w)
    hits = np.zeros((h, w), np.int64)
    for par in range(geo["a"]):
        for k in range(geo["k0"], geo["k0"] + geo["n_lines"]):
            for t in range(geo["steps"]):
                u, v = par + geo["a"] * t, k + geo["r_cross"] * t
                if 0 <= v < geo["n_cross"] and u < geo["n_walk"]:
                    if not geo["forward"]:
                        u = geo["n_walk"] - 1 - u
                    hits[(u, v) if geo["rows"] else (v, u)] += 1
    assert (hits == 1).all()
