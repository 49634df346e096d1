"""Pallas (Triton route) grain kernels vs the dav1d-validated reference,
run in interpret mode on the CPU. chip_smoke.py runs the same
comparison with the kernels compiled for the GPU."""

import copy

import numpy as np
import pytest

from av1_builder import sample_grain_params
from grav1synth.ops import grain_jax, grain_ref


def _check(params_list, bit_depth=8, h=64, w=64, host_patterns=False):
    rng = np.random.default_rng(5)
    maxv = (1 << bit_depth) - 1
    b = len(params_list)
    # real AV1 4:2:0 chroma geometry: ceil halving ((w+1)>>1)
    y = rng.integers(0, maxv + 1, (b, h, w)).astype(np.int32)
    cb = rng.integers(0, maxv + 1, (b, (h + 1) // 2, (w + 1) // 2)).astype(np.int32)
    cr = rng.integers(0, maxv + 1, (b, (h + 1) // 2, (w + 1) // 2)).astype(np.int32)
    out = grain_jax.apply_grain(
        y, cb, cr, grain_jax.pack_params(params_list), bit_depth,
        backend="pallas", interpret=True,
        host_params=params_list if host_patterns else None,
    )
    out = [np.asarray(o) for o in out]
    for i, p in enumerate(params_list):
        ref = grain_ref.apply_grain_frame([y[i], cb[i], cr[i]], p, bit_depth, 1, 1)
        for pi in range(3):
            bad = int((out[pi][i].astype(np.int64) != ref[pi].astype(np.int64)).sum())
            assert bad == 0, f"frame {i} plane {pi}: {bad} bad"


def test_single():
    _check([sample_grain_params(seed=777)])


def test_mixed_batch():
    p0 = sample_grain_params(seed=777)
    p1 = copy.deepcopy(p0)
    p1.overlap_flag = False
    p2 = copy.deepcopy(p0)
    p2.chroma_scaling_from_luma = True
    p2.scaling_points_cb = []
    p2.scaling_points_cr = []
    p3 = copy.deepcopy(p0)
    p3.clip_to_restricted_range = True
    _check([p0, p1, p2, p3])


def test_10bit():
    _check([sample_grain_params(seed=777)], bit_depth=10)


def test_odd_and_multistripe():
    _check([sample_grain_params(seed=777)], h=70, w=100)
    _check([sample_grain_params(seed=777)], h=128, w=160)


def test_host_patterns_path():
    _check([sample_grain_params(seed=777)], host_patterns=True)


def test_wide_inkernel_avg():
    """A frame four luma tiles wide (two chroma tiles)."""
    _check([sample_grain_params(seed=777)], h=64, w=512)


def test_shifted_last_group():
    """Ragged last luma and chroma tiles: the chroma kernel's averaged
    luma reads stop at the frame's last column."""
    _check([sample_grain_params(seed=777)], h=40, w=300)


def test_odd_width_edge():
    """Odd frame width duplicates the final luma column in the chroma
    scaling average, inside the first tile and past it."""
    _check([sample_grain_params(seed=777)], h=40, w=99)
    _check([sample_grain_params(seed=777)], h=40, w=301)


def test_monochrome():
    p = sample_grain_params(seed=777)
    p.scaling_points_cb = []
    p.scaling_points_cr = []
    p.ar_coeffs_cb = []
    p.ar_coeffs_cr = []
    rng = np.random.default_rng(8)
    y = rng.integers(0, 256, (2, 64, 64)).astype(np.int32)
    pb = grain_jax.pack_params([p, p])
    yo, cbo, cro = grain_jax.apply_grain(
        y, None, None, pb, 8, 1, 1, True, backend="pallas", interpret=True
    )
    assert cbo is None and cro is None
    for i in range(2):
        ref = grain_ref.apply_grain_frame([y[i]], p, 8, 1, 1)
        assert (np.asarray(yo[i]).astype(np.int64) == ref[0].astype(np.int64)).all()


def test_extreme_scaling_curve():
    """Steep dx=1 segments of the scaling curve."""
    p = sample_grain_params(seed=3)
    p.scaling_points_y = [(0, 0), (1, 255), (2, 0), (128, 200), (255, 10)]
    _check([p])


def test_extreme_scaling_curve_10bit():
    """Worst-case curve at 10-bit, where the LUT interpolates between
    8-bit nodes, on both pattern paths."""
    p = sample_grain_params(seed=3)
    p.scaling_points_y = [(0, 0), (1, 255), (2, 0), (128, 200), (255, 10)]
    _check([p], bit_depth=10)
    _check([p], bit_depth=10, host_patterns=True)


def test_nseg_specialized_10bit():
    """Host-generated patterns at 10-bit."""
    _check([sample_grain_params(seed=777)], bit_depth=10, host_patterns=True)


def test_nseg_dense_curve():
    """A full 14-point curve (the syntax maximum) mixed with a sparse
    one, at 10-bit and 8-bit."""
    p = sample_grain_params(seed=9)
    p.scaling_points_y = [
        (x, (x * 7 + 13 * (i % 5)) % 256)
        for i, x in enumerate(range(0, 256, 19))
    ][:14]
    q = sample_grain_params(seed=10)
    q.scaling_points_y = [(0, 30), (255, 60)]
    _check([p, q], bit_depth=10, host_patterns=True)
    _check([p, q], host_patterns=True)


def test_multi_tile_ragged_width():
    """Several column tiles per stripe with a ragged last tile (and a
    ragged last stripe) in both kernels, mixed tables."""
    from grav1synth.ops.grain_pallas import TILE_W

    p0 = sample_grain_params(seed=777)
    p1 = copy.deepcopy(p0)
    p1.overlap_flag = False
    p1.grain_seed = 4242
    p2 = copy.deepcopy(p0)
    p2.chroma_scaling_from_luma = True
    p2.scaling_points_cb = []
    p2.scaling_points_cr = []
    _check([p0, p1, p2], bit_depth=10, h=50, w=2 * TILE_W + 2 * 37 + 1)


@pytest.mark.gpu
def test_compiled_kernels_match_reference(gpu):
    """The kernels as Triton compiles them for the card (no interpret
    mode), mixed tables at 10-bit on a ragged geometry."""
    p0 = sample_grain_params(seed=777)
    p1 = copy.deepcopy(p0)
    p1.overlap_flag = False
    p2 = copy.deepcopy(p0)
    p2.chroma_scaling_from_luma = True
    p2.scaling_points_cb = []
    p2.scaling_points_cr = []
    p3 = copy.deepcopy(p0)
    p3.clip_to_restricted_range = True
    params_list = [p0, p1, p2, p3]
    rng = np.random.default_rng(5)
    b, h, w = 4, 270, 481
    y = rng.integers(0, 1024, (b, h, w)).astype(np.int32)
    cb = rng.integers(0, 1024, (b, (h + 1) // 2, (w + 1) // 2)).astype(np.int32)
    cr = rng.integers(0, 1024, (b, (h + 1) // 2, (w + 1) // 2)).astype(np.int32)
    out = grain_jax.apply_grain(
        y, cb, cr, grain_jax.pack_params(params_list), 10, backend="pallas",
        host_params=params_list,
    )
    out = [np.asarray(o) for o in out]
    for i, p in enumerate(params_list):
        ref = grain_ref.apply_grain_frame([y[i], cb[i], cr[i]], p, 10, 1, 1)
        for pi in range(3):
            assert (out[pi][i].astype(np.int64) == ref[pi].astype(np.int64)).all()
