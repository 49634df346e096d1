"""Bit-level tests for rarely-emitted uncompressed_header branches.

Real encoders (the conformance matrix) never produce superres, explicit
render sizes, frame-id numbers or hand-set segmentation data; these
synthetic streams pin the exact bit consumption of those walks, and the
grain splice must still land byte-exactly after each of them.
"""

import pytest

from av1_builder import (
    MiniSeqConfig,
    build_frame_ext,
    build_sequence_header_ext,
    build_show_existing_frame,
    build_temporal_delimiter,
    sample_grain_params,
)
from grav1synth.obu import (
    Av1Parser,
    FrameType,
    GrainAction,
    GrainRewriter,
    GrainTableSegment,
)


def _parse(data):
    parser = Av1Parser()
    return parser, parser.parse_packet(data, 0)


def _frame_obus(obus):
    return [o for o in obus if o.frame is not None]


CFG = MiniSeqConfig(width=64, height=64, film_grain_params_present=True)
GRAIN = sample_grain_params(seed=99)


def _stream(seq_kw, frame_kw):
    data = build_temporal_delimiter()
    data += build_sequence_header_ext(CFG, **seq_kw)
    data += build_frame_ext(CFG, grain=GRAIN, **{**seq_kw, **frame_kw})
    return data


def _check_grain_roundtrip(data):
    """The grain span recorded must re-parse to the same params, and a
    remove-rewrite must yield a stream whose frames report no grain."""
    parser, obus = _parse(data)
    frames = _frame_obus(obus)
    assert len(frames) == 1
    f = frames[0]
    assert f.frame.grain.action == GrainAction.UPDATE
    got = f.frame.grain.params
    assert got.scaling_points_y == GRAIN.scaling_points_y
    assert got.ar_coeffs_cb == GRAIN.ar_coeffs_cb
    # remove round-trip through the rewriter
    parser2 = Av1Parser()
    rw = GrainRewriter(None)
    parsed = parser2.parse_packet(data, 0)
    removed = rw.rewrite_packet(data, parsed, 0, parser2.sequence_header)
    parser3 = Av1Parser()
    for o in parser3.parse_packet(removed, 0):
        if o.frame is not None:
            assert o.frame.grain.action == GrainAction.DISABLE
    assert removed.endswith(b"\x00\x01\x02\x03")


# keys build_frame_ext shares with build_sequence_header_ext
_SEQ_KEYS = ("enable_superres", "frame_id_numbers", "enable_order_hint")


def test_superres():
    data = _stream(
        dict(enable_superres=True),
        dict(use_superres=True, coded_denom=3),
    )
    _check_grain_roundtrip(data)


def test_superres_disabled_bit():
    data = _stream(dict(enable_superres=True), dict(use_superres=False))
    _check_grain_roundtrip(data)


def test_frame_size_override_with_render_size():
    data = _stream(
        {},
        dict(
            frame_size_override=True,
            override_dims=(48, 40),
            render_size_different=True,
            render_dims=(100, 80),
        ),
    )
    _check_grain_roundtrip(data)


def test_frame_id_numbers():
    data = _stream(dict(frame_id_numbers=True), {})
    _check_grain_roundtrip(data)


def test_frame_id_numbers_inter():
    seq_kw = dict(frame_id_numbers=True)
    data = build_temporal_delimiter() + build_sequence_header_ext(CFG, **seq_kw)
    data += build_frame_ext(CFG, frame_type=FrameType.KEY, grain=GRAIN, **seq_kw)
    pkt2 = build_temporal_delimiter() + build_frame_ext(
        CFG, frame_type=FrameType.INTER, grain=GRAIN, **seq_kw
    )
    parser = Av1Parser()
    obus = parser.parse_packet(data, 0)
    obus2 = parser.parse_packet(pkt2, 1)
    frames = _frame_obus(obus) + _frame_obus(obus2)
    assert len(frames) == 2
    assert frames[1].frame.grain.action == GrainAction.UPDATE


def test_order_hint_bits():
    data = _stream(
        dict(enable_order_hint=True, order_hint_bits=7),
        dict(order_hint=93),
    )
    _check_grain_roundtrip(data)


def test_segmentation_with_features():
    data = _stream({}, dict(segmentation=True))
    _check_grain_roundtrip(data)


def test_segmentation_inter_update_flags():
    seq = build_temporal_delimiter() + build_sequence_header_ext(CFG)
    seq += build_frame_ext(CFG, frame_type=FrameType.KEY, grain=GRAIN)
    pkt2 = build_temporal_delimiter() + build_frame_ext(
        CFG, frame_type=FrameType.INTER, grain=GRAIN, segmentation=True
    )
    parser = Av1Parser()
    parser.parse_packet(seq, 0)
    frames = _frame_obus(parser.parse_packet(pkt2, 1))
    assert frames[0].frame.grain.action == GrainAction.UPDATE


def test_delta_q_lf():
    data = _stream({}, dict(delta_q=True))
    _check_grain_roundtrip(data)


def test_loop_filter_deltas():
    data = _stream({}, dict(lf_deltas=True))
    _check_grain_roundtrip(data)


def test_switch_frame():
    """SWITCH frames (spec 5.9.2): error_resilient / size-override /
    refresh_frame_flags all implied (no bits), explicit frame_size in
    the inter path, update_grain NOT coded (INTER only). The splice
    must land byte-exactly after the implied-field walk."""
    data = build_temporal_delimiter()
    data += build_sequence_header_ext(CFG)
    data += build_frame_ext(CFG, frame_type=FrameType.KEY, grain=GRAIN)
    data += build_temporal_delimiter()
    data += build_frame_ext(CFG, frame_type=FrameType.SWITCH, grain=GRAIN)
    parser, obus = _parse(data)
    frames = _frame_obus(obus)
    assert len(frames) == 2
    assert frames[1].frame.frame_type == FrameType.SWITCH
    for f in frames:
        assert f.frame.grain.action == GrainAction.UPDATE
        assert f.frame.grain.params.scaling_points_y == GRAIN.scaling_points_y
    # remove round-trip across the switch frame
    parser2 = Av1Parser()
    rw = GrainRewriter(None)
    parsed = parser2.parse_packet(data, 0)
    removed = rw.rewrite_packet(data, parsed, 0, parser2.sequence_header)
    for o in Av1Parser().parse_packet(removed, 0):
        if o.frame is not None:
            assert o.frame.grain.action == GrainAction.DISABLE


def test_switch_frame_superres():
    data = build_temporal_delimiter()
    data += build_sequence_header_ext(CFG, enable_superres=True)
    data += build_frame_ext(
        CFG, frame_type=FrameType.KEY, grain=GRAIN, enable_superres=True
    )
    data += build_temporal_delimiter()
    data += build_frame_ext(
        CFG,
        frame_type=FrameType.SWITCH,
        grain=GRAIN,
        enable_superres=True,
        use_superres=True,
        coded_denom=5,
    )
    parser, obus = _parse(data)
    frames = _frame_obus(obus)
    assert len(frames) == 2
    assert frames[1].frame.frame_type == FrameType.SWITCH
    assert frames[1].frame.grain.action == GrainAction.UPDATE


def test_everything_at_once():
    data = _stream(
        dict(enable_superres=True, frame_id_numbers=True, enable_order_hint=True),
        dict(
            use_superres=True,
            coded_denom=7,
            order_hint=12,
            segmentation=True,
            delta_q=True,
            lf_deltas=True,
        ),
    )
    _check_grain_roundtrip(data)


def test_show_existing_frame():
    cfg = MiniSeqConfig(width=64, height=64, film_grain_params_present=True)
    data = build_temporal_delimiter() + build_sequence_header_ext(cfg)
    data += build_frame_ext(cfg, grain=GRAIN)
    pkt2 = build_temporal_delimiter() + build_show_existing_frame(2)
    parser = Av1Parser()
    parser.parse_packet(data, 0)
    obus = parser.parse_packet(pkt2, 1)
    frames = _frame_obus(obus)
    assert len(frames) == 1
    f = frames[0].frame
    assert f.show_existing_frame and f.show_frame
    assert f.grain.action == GrainAction.COPY_REF
    # rewriters must pass show_existing frames through untouched
    rw = GrainRewriter([GrainTableSegment(0, 10**12, sample_grain_params())])
    parser2 = Av1Parser()
    parser2.parse_packet(data, 0)
    parsed = parser2.parse_packet(pkt2, 1)
    assert rw.rewrite_packet(pkt2, parsed, 1, parser2.sequence_header) == pkt2


class TestLayerFiltering:
    """Scalable (SVC) streams: OBUs of layers outside the selected
    operating point are skipped by the parser and passed through
    verbatim on rewrite (reference obu.rs:90-113)."""

    def _stream(self):
        from av1_builder import build_frame, build_sequence_header

        # operating point 0 selects temporal layer 0, spatial layer 0
        cfg = MiniSeqConfig(film_grain_params_present=True, op_idc=0x101)
        params = sample_grain_params(seed=44)
        base = build_frame(cfg, FrameType.KEY, grain=params, extension=(0, 0))
        enh = build_frame(
            cfg, FrameType.KEY, grain=params, extension=(1, 0)
        )
        data = (
            build_temporal_delimiter()
            + build_sequence_header(cfg)
            + base
            + enh
        )
        return cfg, data, enh

    def test_dropped_layer_is_skipped(self):
        _, data, enh = self._stream()
        parser = Av1Parser()
        parsed = parser.parse_packet(data, 0)
        frames = [p for p in parsed if p.header.obu_type.name == "FRAME"]
        assert len(frames) == 2
        assert frames[0].frame is not None  # base layer parsed
        assert frames[0].frame.grain.action == GrainAction.UPDATE
        assert frames[1].frame is None  # enhancement layer filtered
        assert frames[1].header.extension.temporal_id == 1

    def test_dropped_layer_passthrough_on_rewrite(self):
        _, data, enh = self._stream()
        parser = Av1Parser()
        parsed = parser.parse_packet(data, 0)
        rw = GrainRewriter(None)  # remove
        out = rw.rewrite_packet(data, parsed, 0, parser.sequence_header)
        assert enh in out  # filtered OBU byte-identical in output
        # base layer's grain is gone, enhancement untouched
        p2 = Av1Parser()
        reparsed = p2.parse_packet(out, 0)
        frames = [p for p in reparsed if p.header.obu_type.name == "FRAME"]
        assert frames[0].frame.grain.action == GrainAction.DISABLE
        assert frames[1].frame is None

    def test_selected_layer_with_extension_parses(self):
        """extension present + idc bit set -> NOT filtered."""
        from av1_builder import build_frame, build_sequence_header

        cfg = MiniSeqConfig(film_grain_params_present=True, op_idc=0x303)
        params = sample_grain_params(seed=45)
        data = (
            build_temporal_delimiter()
            + build_sequence_header(cfg)
            + build_frame(cfg, FrameType.KEY, grain=params, extension=(1, 1))
        )
        parser = Av1Parser()
        parsed = parser.parse_packet(data, 0)
        frames = [p for p in parsed if p.frame is not None]
        assert len(frames) == 1
        assert frames[0].frame.grain.action == GrainAction.UPDATE
