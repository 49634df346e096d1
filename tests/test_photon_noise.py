"""Ground-truth validation of the photon-noise (generate) model.

The reference delegates to av1-grain's generate_photon_noise_params
(src/main.rs:288-304), itself a port of libaom
tools/photon_noise_table.c. Three layers of validation:

1. golden tables over an ISO x resolution x transfer x range matrix
   (tests/golden_photon_noise.json, reviewed values of the libaom
   algorithm) — any model drift fails loudly;
2. physics invariants the libaom model must satisfy (shot-noise
   sqrt-ISO scaling at highlights, pixel-pitch dependence, limited
   vs full range code-value placement, secant finiteness at black);
3. an end-to-end statistical check: the generated table, pushed
   through the dav1d-validated synthesis engine onto flat frames,
   must reproduce the modeled sigma — model -> table -> bit-exact
   synthesis -> measured noise closes the loop without circularity.
"""

import json
import os

import numpy as np
import pytest

from grav1synth.ops import grain_ref
from grav1synth.ops.photon_noise import (
    SCALING_PER_SIGMA,
    generate_photon_noise_params,
    modeled_sigma_8bit,
    photon_noise_segment,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_photon_noise.json")

MATRIX = [
    # (iso, width, height, transfer, full_range)
    (100, 1920, 1080, "bt1886", False),
    (400, 1920, 1080, "bt1886", False),
    (1600, 1920, 1080, "bt1886", False),
    (6400, 1920, 1080, "bt1886", False),
    (25600, 1920, 1080, "bt1886", False),
    (400, 3840, 2160, "bt1886", False),
    (1600, 3840, 2160, "bt1886", False),
    (6400, 3840, 2160, "bt1886", False),
    (1600, 1280, 720, "bt1886", False),
    (400, 1920, 1080, "smpte2084", False),
    (1600, 1920, 1080, "smpte2084", False),
    (6400, 3840, 2160, "smpte2084", False),
    (400, 1920, 1080, "bt1886", True),
    (1600, 1920, 1080, "bt1886", True),
    (1600, 3840, 2160, "smpte2084", True),
]


def _key(iso, w, h, tf, fr):
    return f"iso{iso}_{w}x{h}_{tf}_{'full' if fr else 'limited'}"


class TestGolden:
    def test_golden_matrix(self):
        with open(GOLDEN) as fh:
            golden = json.load(fh)
        for iso, w, h, tf, fr in MATRIX:
            p = generate_photon_noise_params(iso, w, h, tf, chroma=True, full_range=fr)
            key = _key(iso, w, h, tf, fr)
            assert golden[key]["y"] == [list(pt) for pt in p.scaling_points_y], key
            assert golden[key]["uv"] == [list(pt) for pt in p.scaling_points_cb], key
            assert p.scaling_points_cb == p.scaling_points_cr
            # libaom fixes these for photon noise
            assert p.scaling_shift == 8
            assert p.ar_coeff_lag == 0
            assert p.grain_scale_shift == 0
            assert p.ar_coeff_shift == 6

    def test_limited_range_code_values(self):
        p = generate_photon_noise_params(1600, 1920, 1080, "bt1886", full_range=False)
        xs = [x for x, _ in p.scaling_points_y]
        assert xs[0] == 16 and xs[-1] == 235
        assert xs == sorted(set(xs)) and len(xs) == 14

    def test_full_range_code_values(self):
        p = generate_photon_noise_params(1600, 1920, 1080, "bt1886", full_range=True)
        xs = [x for x, _ in p.scaling_points_y]
        assert xs[0] == 0 and xs[-1] == 255
        assert xs == [round(255 * i / 13) for i in range(14)]


class TestPhysics:
    def test_shot_noise_sqrt_iso_at_midtones(self):
        """In the shot-noise-dominated regime (mid-tones, high ISO —
        highlights at low ISO are PRNU-dominated instead) sigma ~
        sqrt(ISO): a 4x ISO bump doubles the noise."""
        s1600 = modeled_sigma_8bit(1600, 1920, 1080, 128.0)
        s6400 = modeled_sigma_8bit(6400, 1920, 1080, 128.0)
        assert s6400 / s1600 == pytest.approx(2.0, rel=0.07)

    def test_smaller_pixels_noisier(self):
        lo = modeled_sigma_8bit(1600, 1920, 1080, 128.0)
        hi = modeled_sigma_8bit(1600, 3840, 2160, 128.0)
        # half the pixel pitch = 4x fewer electrons; slightly under 2x
        # because read noise and PRNU don't follow shot-noise scaling
        assert hi / lo == pytest.approx(2.0, rel=0.07)

    def test_black_point_finite(self):
        """The +-2sigma secant keeps the gamma curve's infinite black
        tangent from blowing up the first point."""
        for tf in ("bt1886", "smpte2084"):
            p = generate_photon_noise_params(6400, 3840, 2160, tf)
            assert 0 < p.scaling_points_y[0][1] <= 255

    def test_monotone_in_iso(self):
        prev = None
        for iso in (100, 400, 1600, 6400, 25600):
            v = modeled_sigma_8bit(iso, 1920, 1080, 180.0)
            if prev is not None:
                assert v > prev
            prev = v


class TestEndToEnd:
    @pytest.mark.parametrize("full_range", [False, True])
    def test_synthesized_sigma_matches_model(self, full_range):
        """Apply the generated table with the dav1d-validated host
        engine to flat frames and measure the actual noise sigma; it
        must land on the model's prediction (through the known
        7.88-vs-gaussian-table quantization, within sampling noise)."""
        iso, w, h = 6400, 1920, 1080
        params = generate_photon_noise_params(
            iso, w, h, "bt1886", full_range=full_range
        )
        from grav1synth.ops.tables_data import GAUSSIAN_SEQUENCE

        gauss_std = float(np.std(np.asarray(GAUSSIAN_SEQUENCE, np.float64)))
        lut = grain_ref.build_scaling_lut(params.scaling_points_y, 8)
        for code_value in (60, 128, 210):
            measured = []
            for seed in (1000, 2000, 3000):
                params.grain_seed = seed
                frame = np.full((192, 192), code_value, np.int32)
                out = grain_ref.apply_grain_frame([frame], params, 8)[0]
                measured.append(float(np.std(out.astype(np.float64) - code_value)))
            measured_sigma = float(np.mean(measured))
            # exact expectation: the quantized scaling value at this
            # code value times the gaussian table sigma at shift 8
            scale = float(lut[code_value])
            expected = scale * (gauss_std / 16.0) / 256.0
            assert measured_sigma == pytest.approx(expected, rel=0.12), code_value
            # and the table itself encodes the physical model: invert
            # the 7.88 convention to compare in code-value sigma units
            model_sigma = modeled_sigma_8bit(
                iso, w, h, code_value, "bt1886", full_range
            )
            table_sigma = scale / SCALING_PER_SIGMA
            assert table_sigma == pytest.approx(model_sigma, abs=0.5 / SCALING_PER_SIGMA + 0.02 * model_sigma), code_value

    def test_generate_pipeline_uses_stream_range(self, tmp_path):
        """IVF streams: the sequence header's color_range drives the
        model (reference main.rs:296-304 reads it from codecpar)."""
        from grav1synth import pipelines
        from grav1synth.container.ffshim import Encoder
        from grav1synth.container.ivf import IvfHeader, IvfPacket, write_ivf
        from grav1synth.obu import Av1Parser

        rng = np.random.default_rng(5)
        frames = []
        for _ in range(3):
            y = rng.integers(0, 255, (64, 64)).astype(np.uint8)
            u = np.full((32, 32), 128, np.uint8)
            frames.append((y, u, u.copy()))
        enc = Encoder(64, 64, 8, extra_opts="cpu-used=8")
        try:
            pkts = enc.encode_frames(frames)
        finally:
            enc.close()
        src = tmp_path / "in.ivf"
        write_ivf(
            str(src),
            IvfHeader(width=64, height=64, timebase_den=24, timebase_num=1),
            [IvfPacket(p.pts, p.data) for p in pkts],
        )
        # determine what range the encoder actually signaled
        parser = Av1Parser()
        seq = None
        _, rpkts = __import__(
            "grav1synth.container.ivf", fromlist=["read_ivf"]
        ).read_ivf(str(src))
        for p in rpkts:
            for obu in parser.parse_packet(p.data, 0):
                if obu.seq is not None:
                    seq = obu.seq
                    break
            if seq:
                break
        assert seq is not None
        out = tmp_path / "out.ivf"
        pipelines.generate(str(src), str(out), iso=1600, progress=False)
        # inspect the spliced stream and compare against the matching model
        segs = pipelines.inspect(str(out), str(tmp_path / "t.tbl"), progress=False)
        assert segs
        expected = generate_photon_noise_params(
            1600, 64, 64, "bt1886", full_range=seq.color_config.color_range_full
        )
        assert segs[0].params.scaling_points_y == expected.scaling_points_y
