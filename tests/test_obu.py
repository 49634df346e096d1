"""OBU codec tests on synthetic spec-valid streams."""

import pytest

from av1_builder import (
    MiniSeqConfig,
    build_frame,
    build_sequence_header,
    build_stream,
    build_temporal_delimiter,
    sample_grain_params,
)
from grav1synth.bitio import BitReader
from grav1synth.obu import (
    Av1Parser,
    FrameType,
    GrainAction,
    GrainRewriter,
    GrainTableSegment,
    ObuType,
)
from grav1synth.obu.types import DEFAULT_GRAIN_SEED


def parse_stream(packets):
    """Parse packets, returning (parser, list of per-packet ParsedObu lists)."""
    parser = Av1Parser()
    return parser, [parser.parse_packet(p.data, p.pts) for p in packets]


def shown_frames(parsed_lists):
    out = []
    for obus in parsed_lists:
        for p in obus:
            if p.frame is not None and p.frame.show_frame:
                out.append(p.frame)
    return out


class TestParse:
    def test_sequence_header_fields(self):
        cfg = MiniSeqConfig(width=320, height=240, film_grain_params_present=True)
        data = build_sequence_header(cfg)
        parser = Av1Parser()
        obus = parser.parse_packet(data)
        assert len(obus) == 1
        seq = obus[0].seq
        assert seq is not None
        assert seq.max_frame_width == 320
        assert seq.max_frame_height == 240
        assert seq.film_grain_params_present is True
        assert seq.color_config.bit_depth == 8
        assert seq.color_config.subsampling == (1, 1)
        assert seq.use_128x128_superblock is True

    def test_sequence_header_fgp_bit_offset(self):
        """The recorded flag offset must point at the actual bit."""
        for present in (False, True):
            cfg = MiniSeqConfig(film_grain_params_present=present)
            data = build_sequence_header(cfg)
            parser = Av1Parser()
            p = parser.parse_packet(data)[0]
            r = BitReader(data, start_bit=p.fgp_bit_abs)
            assert bool(r.f(1)) is present

    def test_grain_parse_roundtrip(self):
        cfg = MiniSeqConfig(film_grain_params_present=True)
        params = sample_grain_params()
        packets = build_stream(
            cfg,
            [
                {"grain": params},
                {"grain": params, "frame_type": FrameType.INTER},
                {"grain_disabled_bit": True, "frame_type": FrameType.INTER},
            ],
        )
        _, parsed = parse_stream(packets)
        frames = shown_frames(parsed)
        assert len(frames) == 3
        assert frames[0].grain.action == GrainAction.UPDATE
        got = frames[0].grain.params
        assert got.grain_seed == params.grain_seed
        assert got.scaling_points_y == params.scaling_points_y
        assert got.scaling_points_cb == params.scaling_points_cb
        assert got.ar_coeffs_y == params.ar_coeffs_y
        assert got.ar_coeffs_cb == params.ar_coeffs_cb
        assert got.ar_coeffs_cr == params.ar_coeffs_cr
        assert got.cb_offset == params.cb_offset
        assert got.overlap_flag == params.overlap_flag
        assert frames[1].grain.action == GrainAction.UPDATE
        assert frames[2].grain.action == GrainAction.DISABLE

    def test_no_grain_stream(self):
        cfg = MiniSeqConfig(film_grain_params_present=False)
        packets = build_stream(cfg, [{}, {"frame_type": FrameType.INTER}])
        _, parsed = parse_stream(packets)
        frames = shown_frames(parsed)
        assert all(f.grain.action == GrainAction.DISABLE for f in frames)
        # insertion point recorded even when syntax absent
        for obus in parsed:
            for p in obus:
                if p.frame is not None:
                    gs, ge = p.grain_bit_range
                    assert gs == ge

    def test_exact_grain_bit_consumption(self):
        """Grain span must exactly cover the syntax: re-parsing the span
        alone must consume every bit."""
        cfg = MiniSeqConfig(film_grain_params_present=True)
        params = sample_grain_params()
        packets = build_stream(cfg, [{"grain": params}])
        _, parsed = parse_stream(packets)
        for obus in parsed:
            for p in obus:
                if p.frame is not None and p.frame.grain.action == GrainAction.UPDATE:
                    gs, ge = p.grain_bit_range
                    assert ge > gs
                    # alignment padding after grain must be zero up to tail
                    r = BitReader(packets[0].data, start_bit=ge)
                    while r.pos % 8:
                        assert r.f(1) == 0

    def test_monochrome_grain(self):
        cfg = MiniSeqConfig(film_grain_params_present=True, monochrome=True)
        params = sample_grain_params()
        params.scaling_points_cb = []
        params.scaling_points_cr = []
        params.ar_coeffs_cb = []
        params.ar_coeffs_cr = []
        packets = build_stream(cfg, [{"grain": params}])
        _, parsed = parse_stream(packets)
        frames = shown_frames(parsed)
        assert frames[0].grain.action == GrainAction.UPDATE
        assert frames[0].grain.params.scaling_points_y == params.scaling_points_y
        assert frames[0].grain.params.scaling_points_cb == []

    def test_hidden_frame_not_shown(self):
        cfg = MiniSeqConfig(film_grain_params_present=False)
        packets = build_stream(
            cfg,
            [
                {},
                {"frame_type": FrameType.INTER, "show_frame": False},
                {"frame_type": FrameType.INTER},
            ],
        )
        _, parsed = parse_stream(packets)
        assert len(shown_frames(parsed)) == 2


class TestRewrite:
    def _roundtrip(self, packets, rewriter, ts_of=lambda i: i):
        """Rewrite every packet with a fresh parser, as the pipeline does."""
        parser = Av1Parser()
        out = []
        for i, pkt in enumerate(packets):
            parsed = parser.parse_packet(pkt.data, ts_of(i))
            out.append(
                rewriter.rewrite_packet(
                    pkt.data, parsed, ts_of(i), parser.sequence_header
                )
            )
        return out

    def test_remove_strips_grain(self):
        cfg = MiniSeqConfig(film_grain_params_present=True)
        params = sample_grain_params()
        packets = build_stream(
            cfg,
            [
                {"grain": params},
                {"grain": params, "frame_type": FrameType.INTER},
            ],
        )
        new_data = self._roundtrip(packets, GrainRewriter(None))
        # re-parse: no grain anywhere, fgp flag off
        parser = Av1Parser()
        for data in new_data:
            for p in parser.parse_packet(data):
                if p.seq is not None:
                    assert p.seq.film_grain_params_present is False
                if p.frame is not None:
                    assert p.frame.grain.action == GrainAction.DISABLE
        # output must shrink (grain syntax dropped)
        assert sum(map(len, new_data)) < sum(len(p.data) for p in packets)

    def test_low_overhead_framing_gains_size_field(self):
        """A last-in-TU OBU without a size field (low-overhead framing,
        spec 5.2) parses via packet-end size inference, and a resizing
        rewrite ADDS the size field rather than failing."""
        cfg = MiniSeqConfig(film_grain_params_present=False)
        packets = build_stream(cfg, [{}, {"frame_type": FrameType.INTER}])
        parser = Av1Parser()
        stripped = []
        for pkt in packets:
            parsed = parser.parse_packet(pkt.data, 0)
            last = parsed[-1]
            assert last.header.obu_type == ObuType.FRAME
            buf = bytearray(pkt.data)
            del buf[last.leb_size_pos : last.leb_size_pos + last.leb_size_len]
            buf[last.start_byte] &= ~0x02
            stripped.append(bytes(buf))
        # the stripped stream still parses (size inferred from packet end)
        p2 = Av1Parser()
        for data in stripped:
            parsed = p2.parse_packet(data, 0)
            assert parsed[-1].leb_size_pos is None
            assert parsed[-1].frame is not None

        params = sample_grain_params(seed=100)
        seg = GrainTableSegment(0, 10_000_000_000, params)
        p3 = Av1Parser()
        rw = GrainRewriter([seg])
        out = []
        for i, data in enumerate(stripped):
            parsed = p3.parse_packet(data, i)
            out.append(rw.rewrite_packet(data, parsed, i, p3.sequence_header))
        p4 = Av1Parser()
        n_grain = 0
        for data in out:
            for p in p4.parse_packet(data, 0):
                if p.header.obu_type == ObuType.FRAME:
                    assert p.leb_size_pos is not None  # size field added
                if p.frame is not None:
                    assert p.frame.grain.action == GrainAction.UPDATE
                    n_grain += 1
        assert n_grain == 2

    def test_remove_is_noop_on_grainless_stream_bytes(self):
        """Removing from a stream with fgp=0 must keep frame OBUs
        byte-identical (only the already-zero seq flag is 'flipped')."""
        cfg = MiniSeqConfig(film_grain_params_present=False)
        packets = build_stream(cfg, [{}, {"frame_type": FrameType.INTER}])
        new_data = self._roundtrip(packets, GrainRewriter(None))
        for pkt, nd in zip(packets, new_data):
            assert nd == pkt.data

    def test_apply_inserts_grain(self):
        cfg = MiniSeqConfig(film_grain_params_present=False)
        packets = build_stream(
            cfg, [{}, {"frame_type": FrameType.INTER}, {"frame_type": FrameType.INTER}]
        )
        params = sample_grain_params(seed=100)
        # pts in 1/30s -> av1 ts = ceil(pts * 1e7 / 30)
        seg = GrainTableSegment(0, 10_000_000_000, params)
        ts_of = lambda i: -(-i * 10_000_000 // 30)
        new_data = self._roundtrip(packets, GrainRewriter([seg]), ts_of)
        parser = Av1Parser()
        seeds = []
        for data in new_data:
            for p in parser.parse_packet(data):
                if p.seq is not None:
                    assert p.seq.film_grain_params_present is True
                if p.frame is not None:
                    assert p.frame.grain.action == GrainAction.UPDATE
                    got = p.frame.grain.params
                    assert got.scaling_points_y == params.scaling_points_y
                    assert got.ar_coeffs_y == params.ar_coeffs_y
                    seeds.append(got.grain_seed)
        # per-frame seed decorrelation: base + k*DEFAULT_GRAIN_SEED
        expected = [(100 + k * DEFAULT_GRAIN_SEED) & 0xFFFF for k in (1, 2, 3)]
        assert seeds == expected

    def test_apply_outside_segment_writes_disabled_bit(self):
        cfg = MiniSeqConfig(film_grain_params_present=True)
        params = sample_grain_params()
        packets = build_stream(
            cfg,
            [{"grain": params}, {"grain": params, "frame_type": FrameType.INTER}],
        )
        # segment covers nothing
        seg = GrainTableSegment(10**12, 10**12 + 1, sample_grain_params())
        new_data = self._roundtrip(packets, GrainRewriter([seg]))
        parser = Av1Parser()
        for data in new_data:
            for p in parser.parse_packet(data):
                if p.frame is not None:
                    assert p.frame.grain.action == GrainAction.DISABLE

    def test_apply_then_remove_roundtrip(self):
        """apply -> remove returns to a grain-free stream."""
        cfg = MiniSeqConfig(film_grain_params_present=False)
        packets = build_stream(cfg, [{}, {"frame_type": FrameType.INTER}])
        seg = GrainTableSegment(0, 10**12, sample_grain_params())
        applied = self._roundtrip(packets, GrainRewriter([seg]))
        from grav1synth.container.ivf import IvfPacket

        applied_pkts = [IvfPacket(p.pts, d) for p, d in zip(packets, applied)]
        removed = self._roundtrip(applied_pkts, GrainRewriter(None))
        for orig, rt in zip(packets, removed):
            assert rt == orig.data

    def test_obu_size_fixup(self):
        """Grain insertion grows the frame OBU; its leb128 size must track."""
        cfg = MiniSeqConfig(film_grain_params_present=False)
        packets = build_stream(cfg, [{}])
        seg = GrainTableSegment(0, 10**12, sample_grain_params())
        new_data = self._roundtrip(packets, GrainRewriter([seg]))
        parser = Av1Parser()
        obus = parser.parse_packet(new_data[0])
        # all obus account for the full packet
        assert obus[-1].payload_end == len(new_data[0])
        # tile payload preserved verbatim at the tail
        assert new_data[0].endswith(b"\x00\x01\x02\x03")
