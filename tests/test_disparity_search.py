"""Stereo winner maps: the XLA path and the Triton band kernel (interpret mode
on the CPU) against a brute-force NumPy banded scan in float64."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from odometry_tpu.camera import Pinhole
from odometry_tpu.data.synthetic import make_scene, render_stereo
from odometry_tpu.image import gaussian_blur3
from odometry_tpu.eval.parity import compare_winner_maps
from odometry_tpu.kernels.disparity import (
    PATTERN_OFFSETS, cost_matrix_winner_maps, disparity_winner_maps)
from odometry_tpu.kernels.disparity_triton import band_winner_maps

H = 48
BOUNDARY = 4
# (max_disparity, min_disparity): full search, a narrow band, and a wide
# range-limited band (160 > 96 covers a band wider than the image).
BANDS = [(None, None), (24, None), (160, 3)]


@pytest.fixture(scope="module", params=[96, 320])
def stereo(request):
    W = request.param
    cam = Pinhole.create(140.0, 140.0, W / 2.0, H / 2.0)
    left, right, _ = render_stereo(make_scene(5, depth=10.0), cam, 0.537, jnp.eye(4), H, W)
    return np.asarray(gaussian_blur3(left)), np.asarray(gaussian_blur3(right))


def brute_force(ls, rs, max_disparity, min_disparity, excl=2):
    """(best, match, rmatch, second) by scoring every (x, xr) pair in f64."""
    h, w = ls.shape
    pl, pr = np.pad(ls.astype(np.float64), 2), np.pad(rs.astype(np.float64), 2)
    ssd = np.zeros((h, w, w))
    for dy, dx in PATTERN_OFFSETS:
        a = pl[2 + dy:2 + dy + h, 2 + dx:2 + dx + w]
        b = pr[2 + dy:2 + dy + h, 2 + dx:2 + dx + w]
        ssd += (a[:, :, None] - b[:, None, :]) ** 2
    x = np.arange(w)[:, None]
    xr = np.arange(w)[None, :]
    d = x - xr
    ok = (xr >= BOUNDARY) & (d >= max(1, min_disparity or 1))
    if max_disparity is not None:
        ok &= d <= max_disparity
    ssd = np.where(ok[None], ssd, np.inf)
    best = ssd.min(axis=2)
    match = np.where(np.isfinite(best), ssd.argmin(axis=2), 0)
    rbest = ssd.min(axis=1)
    rmatch = np.where(np.isfinite(rbest), ssd.argmin(axis=1), 0)
    near = np.abs(xr[None] - match[:, :, None]) <= excl
    second = np.where(near, np.inf, ssd).min(axis=2)
    fill = lambda v: np.where(np.isfinite(v), v, 1e10).astype(np.float32)  # noqa: E731
    return fill(best), match.astype(np.int32), rmatch.astype(np.int32), fill(second)


def _xla(ls, rs, **kw):
    """disparity_winner_maps on the CPU: the cost-matrix search."""
    return [np.asarray(v) for v in disparity_winner_maps(
        jnp.asarray(ls), jnp.asarray(rs), **kw)]


def _triton(ls, rs, **kw):
    return [np.asarray(v) for v in band_winner_maps(
        jnp.asarray(ls), jnp.asarray(rs), interpret=True,
        second_best=kw.pop("second_best", False), second_excl=2, **kw)]


def _check(ls, rs, got, max_d, min_d, lr_check):
    want = brute_force(ls, rs, max_d, min_d)
    if not lr_check:
        assert (got[2] == 0).all()
        want = (want[0], want[1], np.zeros_like(want[2]), want[3])
    counts = compare_winner_maps(ls, rs, got, want, boundary=BOUNDARY,
                                 max_disparity=max_d, min_disparity=min_d)
    # Near-ties are rare on this texture: the winners are the reference's.
    assert max(counts.values()) <= 0.002 * ls.size, counts


@pytest.mark.parametrize("lr_check", [False, True])
@pytest.mark.parametrize("max_d,min_d", BANDS)
def test_xla_path_matches_brute_force(stereo, max_d, min_d, lr_check):
    ls, rs = stereo
    got = _xla(ls, rs, boundary=BOUNDARY, max_disparity=max_d,
               min_disparity=min_d, lr_check=lr_check)
    _check(ls, rs, got, max_d, min_d, lr_check)


@pytest.mark.parametrize("max_d,min_d", BANDS)
def test_triton_kernel_matches_brute_force(stereo, max_d, min_d):
    ls, rs = stereo
    got = _triton(ls, rs, boundary=BOUNDARY, max_disparity=max_d,
                  min_disparity=min_d, lr_check=True)
    _check(ls, rs, got, max_d, min_d, True)


@pytest.mark.parametrize("search", [_xla, _triton])
def test_second_best_matches_brute_force(stereo, search):
    """Runner-up SSD outside +-2 px of the winner (the ratio test's rival)."""
    ls, rs = stereo
    got = search(ls, rs, boundary=BOUNDARY, max_disparity=24, min_disparity=None,
                 lr_check=False, second_best=True)
    best, match, _, second = brute_force(ls, rs, 24, None)
    same = got[1] == match  # the rival is defined around the winner
    assert same.mean() > 0.99
    tol = 1e-5 * np.maximum(second, 1.0)[same] + 0.5
    assert np.all(np.abs(got[3][same] - second[same]) <= tol)


@pytest.mark.parametrize("search", [_xla, _triton])
def test_masked_columns_report_rmatch_zero(stereo, search):
    """Right-image columns with no in-band left partner report rmatch == 0:
    those left of `boundary`, and those within min_disparity of the right
    edge."""
    ls, rs = stereo
    W = ls.shape[1]
    _, _, rmatch, _ = search(ls, rs, boundary=BOUNDARY, max_disparity=160,
                             min_disparity=3, lr_check=True)
    assert (rmatch[:, :BOUNDARY] == 0).all()
    assert (rmatch[:, W - 3:] == 0).all()
    assert (rmatch[:, BOUNDARY:W - 3] > 0).all()


def test_dispatch_takes_the_cost_matrix_path_on_cpu(stereo):
    ls, rs = stereo
    kw = dict(boundary=BOUNDARY, max_disparity=24, min_disparity=None, lr_check=True,
              second_best=True, second_excl=2)
    got = jax.jit(lambda a, b: disparity_winner_maps(a, b, **kw))(ls, rs)
    want = jax.jit(lambda a, b: cost_matrix_winner_maps(a, b, **kw))(ls, rs)
    for a, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(x))


@pytest.mark.parametrize("lr_check", [False, True])
def test_cuda_branch_is_the_band_kernel(lr_check):
    """The traced search holds the band kernel (its reverse pass only with
    the lr check) for CUDA; the CPU lowering holds no kernel."""
    x = jnp.ones((16, 64))
    fn = lambda a, b: disparity_winner_maps(a, b, boundary=BOUNDARY,  # noqa: E731
                                            max_disparity=24, lr_check=lr_check)
    kernels = re.findall(r"disparity_band_\w+", str(jax.make_jaxpr(fn)(x, x)))
    want = ["disparity_band_forward"] + (["disparity_band_reverse"] if lr_check else [])
    assert kernels == want
    assert "disparity_band" not in jax.jit(fn).lower(x, x).as_text()


def test_comparison_rejects_a_wrong_winner(stereo):
    """compare_winner_maps (chip_smoke's parity check) must catch a winner
    that is not a near-tie."""
    ls, rs = stereo
    want = brute_force(ls, rs, 24, None)
    got = [v.copy() for v in want]
    y, x = H // 2, ls.shape[1] // 2
    got[1][y, x] = want[1][y, x] - 7  # a valid candidate, but not the minimum
    got[0][y, x] = 1e10
    with pytest.raises(AssertionError):
        compare_winner_maps(ls, rs, got, want, boundary=BOUNDARY,
                            max_disparity=24, min_disparity=None)


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda,cpu")
    return jax.devices()[0]


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_at_kitti_width(gpu):
    """The Triton kernel as compiled for the card, at 376x1241, against the
    cost-matrix search on the CPU (chip_smoke.py's parity phase runs the same
    check through disparity_winner_maps)."""
    cam = Pinhole.create(718.856, 718.856, 607.1928, 185.2157)
    left, right, _ = render_stereo(make_scene(3, depth=14.0), cam, 0.537,
                                   jnp.eye(4), 376, 1241)
    ls, rs = np.asarray(gaussian_blur3(left)), np.asarray(gaussian_blur3(right))
    kw = dict(boundary=BOUNDARY, max_disparity=192, min_disparity=12, lr_check=True,
              second_best=False, second_excl=2)
    got = [np.asarray(v) for v in band_winner_maps(
        jax.device_put(ls, gpu), jax.device_put(rs, gpu), **kw)]
    cpu = jax.devices("cpu")[0]
    want = [np.asarray(v) for v in cost_matrix_winner_maps(
        jax.device_put(ls, cpu), jax.device_put(rs, cpu), **kw)]
    compare_winner_maps(ls, rs, got, want, boundary=BOUNDARY, max_disparity=192,
                        min_disparity=12)
