"""Bit-exactness of the grain-synthesis reference implementation vs dav1d.

The oracle: encode content with libaom, splice grain parameters with our
rewriter, decode twice with dav1d (film grain off/on). Our synthesis on
the grainless decode must reproduce the grainy decode exactly —
the BASELINE.json north-star correctness criterion.
"""

import copy

import numpy as np
import pytest

from av1_builder import sample_grain_params
from grav1synth.container.ffshim import Decoder, Encoder
from grav1synth.obu import Av1Parser, GrainRewriter, GrainTableSegment
from grav1synth.obu.types import FilmGrainParams
from grav1synth.ops import grain_ref


def _make_stream(bit_depth=8, w=64, h=64, flat=None, seed=3):
    rng = np.random.default_rng(seed)
    maxv = (1 << bit_depth) - 1
    dt = np.uint8 if bit_depth == 8 else np.uint16
    if flat is not None:
        y = np.full((h, w), flat, dt)
    else:
        y = np.clip(
            np.linspace(0, maxv, w)[None, :] + rng.normal(0, 2, (h, w)), 0, maxv
        ).astype(dt)
    u = np.full((h // 2, w // 2), (maxv + 1) // 2, dt)
    v = np.full((h // 2, w // 2), (maxv + 1) // 2, dt)
    enc = Encoder(w, h, bit_depth)
    pkts = enc.encode_frames([(y, u, v)])
    enc.close()
    return pkts


def _oracle_frames(pkts, params):
    """Returns (grainless decode, grainy decode, effective per-frame params)."""
    seg = GrainTableSegment(0, 10**13, params)
    parser = Av1Parser()
    rw = GrainRewriter([seg])
    new = []
    for p in pkts:
        ts = -(-p.pts * 10_000_000 // 30)
        parsed = parser.parse_packet(p.data, ts)
        new.append(rw.rewrite_packet(p.data, parsed, ts, parser.sequence_header))
    d0 = Decoder("libdav1d", apply_grain=False)
    f0 = list(d0.decode_all([(d, i) for i, d in enumerate(new)]))
    d0.close()
    d1 = Decoder("libdav1d", apply_grain=True)
    f1 = list(d1.decode_all([(d, i) for i, d in enumerate(new)]))
    d1.close()
    pp = Av1Parser()
    eff = []
    for d in new:
        for o in pp.parse_packet(d):
            if o.frame is not None and o.frame.grain.params is not None:
                eff.append(o.frame.grain.params)
    return f0, f1, eff


def assert_bit_exact(params, bit_depth=8, w=64, h=64, flat=None):
    pkts = _make_stream(bit_depth, w, h, flat)
    f0, f1, eff = _oracle_frames(pkts, params)
    assert len(f0) == len(f1) == len(eff) == 1
    mine = grain_ref.apply_grain_frame(
        [pl.astype(np.int32) for pl in f0[0].planes], eff[0], bit_depth, 1, 1
    )
    for pi, (got, want) in enumerate(zip(mine, f1[0].planes)):
        bad = int((got.astype(np.int32) != want.astype(np.int32)).sum())
        assert bad == 0, f"plane {pi}: {bad} mismatching pixels"


def _base_luma():
    return FilmGrainParams(
        grain_seed=5000,
        scaling_points_y=[(0, 32), (255, 32)],
        scaling_shift=8,
        ar_coeff_lag=0,
        ar_coeff_shift=6,
        overlap_flag=False,
        clip_to_restricted_range=False,
    )


class TestLuma:
    def test_lag0_flat(self):
        assert_bit_exact(_base_luma(), flat=128)

    def test_lag2(self):
        p = _base_luma()
        p.ar_coeff_lag = 2
        p.ar_coeffs_y = [3, -2, 5, 1, -7, 4, 2, -1, 6, 0, -3, 2]
        assert_bit_exact(p, flat=128)

    def test_lag2_overlap_gradient(self):
        p = _base_luma()
        p.ar_coeff_lag = 2
        p.ar_coeffs_y = [3, -2, 5, 1, -7, 4, 2, -1, 6, 0, -3, 2]
        p.overlap_flag = True
        assert_bit_exact(p)

    def test_nonuniform_scaling_points(self):
        p = _base_luma()
        p.scaling_points_y = [(0, 0), (30, 45), (90, 20), (200, 60), (255, 5)]
        assert_bit_exact(p)


class TestChroma:
    def test_full_chroma(self):
        assert_bit_exact(sample_grain_params())

    def test_clip_to_restricted_range(self):
        p = sample_grain_params()
        p.clip_to_restricted_range = True
        assert_bit_exact(p)

    def test_chroma_scaling_from_luma(self):
        p = sample_grain_params()
        p.chroma_scaling_from_luma = True
        p.scaling_points_cb = []
        p.scaling_points_cr = []
        assert_bit_exact(p)

    def test_lag3(self):
        p = sample_grain_params()
        p.ar_coeff_lag = 3
        p.ar_coeffs_y = [int(v) for v in np.arange(24) % 11 - 5]
        p.ar_coeffs_cb = [int(v) for v in np.arange(25) % 9 - 4]
        p.ar_coeffs_cr = [int(v) for v in np.arange(25) % 7 - 3]
        assert_bit_exact(p)

    def test_shifts(self):
        p = sample_grain_params()
        p.grain_scale_shift = 2
        p.scaling_shift = 10
        assert_bit_exact(p)


class TestGeometry:
    def test_10bit(self):
        assert_bit_exact(sample_grain_params(), bit_depth=10)

    def test_odd_dimensions(self):
        assert_bit_exact(sample_grain_params(), w=100, h=70)

    def test_multi_stripe(self):
        assert_bit_exact(sample_grain_params(), w=160, h=128)
