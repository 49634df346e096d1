"""Native shim + real-codec integration tests.

Fixtures are real libaom encodes; oracles are dav1d decodes. This is
the counterpart of the reference's dav1d-test-data conformance tier
(sanity_tests.rs): since the corpus submodule is unavailable here, the
corpus is self-generated through libaom and validated by round-trip
decoding, which additionally proves the rewriter emits conformant
bitstreams (stronger than the reference's parse-only oracle).
"""

import numpy as np
import pytest

from av1_builder import sample_grain_params
from grav1synth.container.ffshim import Decoder, Demuxer, Encoder, Remuxer
from grav1synth.container.ivf import IvfHeader, IvfPacket, read_ivf, write_ivf
from grav1synth.obu import (
    Av1Parser,
    GrainAction,
    GrainRewriter,
    GrainTableSegment,
)


def _gradient_frames(w, h, n, bit_depth=8, seed=7):
    rng = np.random.default_rng(seed)
    maxval = (1 << bit_depth) - 1
    dtype = np.uint8 if bit_depth == 8 else np.uint16
    out = []
    for i in range(n):
        base = np.linspace(0, maxval * 0.8, w, dtype=np.float64)
        y = (base[None, :] + rng.normal(0, maxval * 0.02, (h, w)) + i * 2).clip(
            0, maxval
        ).astype(dtype)
        u = np.full((h // 2, w // 2), (maxval + 1) // 2, dtype)
        v = np.full((h // 2, w // 2), (maxval + 1) // 2, dtype)
        out.append((y, u, v))
    return out


@pytest.fixture(scope="session")
def av1_8bit_packets():
    enc = Encoder(64, 64, 8)
    pkts = enc.encode_frames(_gradient_frames(64, 64, 5))
    enc.close()
    return pkts


@pytest.fixture(scope="session")
def av1_10bit_packets():
    enc = Encoder(64, 64, 10)
    frames = [
        (y.astype(np.uint16) * 4, u.astype(np.uint16) * 4, v.astype(np.uint16) * 4)
        for y, u, v in _gradient_frames(64, 64, 3)
    ]
    pkts = enc.encode_frames(frames)
    enc.close()
    return pkts


def _apply_grain(pkts, segments):
    parser = Av1Parser()
    rw = GrainRewriter(segments)
    out = []
    for p in pkts:
        ts = -(-p.pts * 10_000_000 // 30)
        parsed = parser.parse_packet(p.data, ts)
        out.append(rw.rewrite_packet(p.data, parsed, ts, parser.sequence_header))
    return out


def _decode(datas, apply_grain):
    dec = Decoder("libdav1d", apply_grain=apply_grain)
    frames = list(dec.decode_all([(d, i) for i, d in enumerate(datas)]))
    dec.close()
    return frames


class TestRealStreams:
    def test_parser_handles_libaom_output(self, av1_8bit_packets):
        parser = Av1Parser()
        nframes = 0
        for p in av1_8bit_packets:
            for o in parser.parse_packet(p.data, p.pts):
                if o.frame is not None:
                    nframes += 1
        assert nframes == 5

    def test_parser_handles_10bit(self, av1_10bit_packets):
        parser = Av1Parser()
        seqs = [
            o.seq
            for p in av1_10bit_packets
            for o in parser.parse_packet(p.data, p.pts)
            if o.seq is not None
        ]
        assert seqs[0].color_config.bit_depth == 10

    def test_apply_grain_conformant_and_lossless(self, av1_8bit_packets):
        seg = GrainTableSegment(0, 10**13, sample_grain_params(seed=1234))
        rewritten = _apply_grain(av1_8bit_packets, [seg])

        nograin = _decode(rewritten, apply_grain=False)
        grain = _decode(rewritten, apply_grain=True)
        orig = _decode([p.data for p in av1_8bit_packets], apply_grain=False)
        assert len(nograin) == len(grain) == len(orig) == 5
        # rewrite is pixel-lossless
        for a, b in zip(orig, nograin):
            assert (a.planes[0] == b.planes[0]).all()
        # dav1d actually synthesized grain from our spliced parameters
        for a, b in zip(nograin, grain):
            diff = b.planes[0].astype(int) - a.planes[0].astype(int)
            assert diff.std() > 1.0

    def test_remove_grain_roundtrip(self, av1_8bit_packets):
        seg = GrainTableSegment(0, 10**13, sample_grain_params(seed=99))
        grainy = _apply_grain(av1_8bit_packets, [seg])
        degrained = _apply_grain(
            [IvfPacket(i, d) for i, d in enumerate(grainy)], None
        )
        # re-inspect: no grain headers (the reference's remove oracle)
        parser = Av1Parser()
        for d in degrained:
            for o in parser.parse_packet(d):
                if o.seq is not None:
                    assert not o.seq.film_grain_params_present
                if o.frame is not None:
                    assert o.frame.grain.action == GrainAction.DISABLE
        # decoding with grain ON now changes nothing
        a = _decode(degrained, apply_grain=False)
        b = _decode(degrained, apply_grain=True)
        for x, y in zip(a, b):
            assert (x.planes[0] == y.planes[0]).all()

    def test_ivf_remux_via_shim(self, av1_8bit_packets, tmp_path):
        src = tmp_path / "src.ivf"
        dst = tmp_path / "dst.ivf"
        write_ivf(
            str(src),
            IvfHeader(width=64, height=64, frame_count=len(av1_8bit_packets)),
            [IvfPacket(p.pts, p.data) for p in av1_8bit_packets],
        )
        with Demuxer(str(src)) as dm:
            info = dm.stream_info(dm.best_video_stream())
            assert info.is_video and info.width == 64
            mux = Remuxer(str(dst), dm)
            for pkt in dm.packets():
                mux.write(pkt)
            mux.finish()
        hdr, pkts = read_ivf(str(dst))
        assert len(pkts) == len(av1_8bit_packets)
        decoded = _decode([p.data for p in pkts], apply_grain=False)
        assert len(decoded) == 5
