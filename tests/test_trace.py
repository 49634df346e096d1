"""Trace subsystem: format parity + field-for-field FFmpeg oracle diff.

The reference reimplements FFmpeg's ``trace_headers`` bitstream filter
output (trace.rs docstring, README.md:44-52). We hold our tracer to the
original: libavcodec's own trace_headers BSF runs over the same packets
(via the native shim) and every syntax element both tracers name the
same must agree on OBU-anchored bit position and value. A coverage
floor keeps the diff meaningful (name drift can't silently empty the
intersection).
"""

import logging
import re

import numpy as np
import pytest

from av1_builder import sample_grain_params
from grav1synth.container.ffshim import Encoder, trace_headers_ffmpeg
from grav1synth.obu import Av1Parser, GrainRewriter, GrainTableSegment
from grav1synth.utils import trace as trace_mod

# one field line: pos, name, optional binary, value
_FFMPEG_FIELD = re.compile(r"^(\d+)\s+(\S+?)(?:\s+([01]+))?\s+=\s+(-?\d+)\s*$")
# bookkeeping elements with no counterpart (we log leb128 as one field)
_SKIP = {"leb128_byte"}


def _ffmpeg_fields(packets):
    """Per-packet [(fields, sections)] from libavcodec's tracer."""
    results = []
    for text in trace_headers_ffmpeg(packets):
        out = []
        sections = []
        for line in text.splitlines():
            m = _FFMPEG_FIELD.match(line)
            if m:
                name = m.group(2)
                if name.split("[")[0] in _SKIP:
                    continue
                out.append((int(m.group(1)), name, int(m.group(4))))
            elif line and not line.startswith("Packet"):
                sections.append(line.strip())
        results.append((out, sections))
    return results


def _our_fields(packets):
    """Per-packet [(fields, sections)] from our tracer (one stateful
    parser across the stream, as in the pipelines)."""
    parser = Av1Parser()
    results = []
    for pkt in packets:
        fields = []
        sections = []
        parser.trace = lambda name, pos, nbits, value: fields.append(
            (pos, name, value)
        )
        parser.trace_section = sections.append
        parser.parse_packet(pkt, 0)
        results.append((fields, sections))
    return results


@pytest.fixture(scope="module")
def grainy_packets():
    rng = np.random.default_rng(21)
    frames = []
    for _ in range(3):
        y = rng.integers(0, 255, (96, 64)).astype(np.uint8)
        u = np.full((48, 32), 128, np.uint8)
        frames.append((y, u, u.copy()))
    enc = Encoder(64, 96, 8)
    pkts = enc.encode_frames(frames)
    enc.close()
    seg = GrainTableSegment(0, 10**14, sample_grain_params(seed=17))
    parser = Av1Parser()
    rw = GrainRewriter([seg])
    out = []
    for p in pkts:
        ts = -(-p.pts * 10_000_000 // 30)
        parsed = parser.parse_packet(p.data, ts)
        out.append(rw.rewrite_packet(p.data, parsed, ts, parser.sequence_header))
    return out


class TestFfmpegOracle:
    def test_fields_match_ffmpeg(self, grainy_packets):
        """Every (position, name) both tracers emit must carry the same
        value, and the name intersection must cover most of FFmpeg's
        trace — on packets that include spliced film_grain_params."""
        total_ff = 0
        total_common = 0
        for (ff, _), (ours, _) in zip(
            _ffmpeg_fields(grainy_packets), _our_fields(grainy_packets)
        ):
            ff_map = {(pos, name): v for pos, name, v in ff}
            our_map = {(pos, name): v for pos, name, v in ours}
            common = set(ff_map) & set(our_map)
            for key in sorted(common):
                assert ff_map[key] == our_map[key], (
                    f"value mismatch at bit {key[0]} {key[1]}: "
                    f"ffmpeg={ff_map[key]} ours={our_map[key]}"
                )
            total_ff += len(ff_map)
            total_common += len(common)
        assert total_ff > 200  # the oracle actually traced something
        coverage = total_common / total_ff
        assert coverage >= 0.85, f"field-name coverage too low: {coverage:.2f}"

    def test_grain_fields_in_both(self, grainy_packets):
        """The grain syntax itself (the part we splice) must appear in
        both tracers with identical positions and values."""
        grain_names = {
            "apply_grain",
            "grain_seed",
            "num_y_points",
            "ar_coeff_lag",
            "grain_scaling_minus_8",
            "overlap_flag",
        }
        any_grain = False
        for (ff, _), (ours, _) in zip(
            _ffmpeg_fields(grainy_packets), _our_fields(grainy_packets)
        ):
            ff_g = [(p, n, v) for p, n, v in ff if n.split("[")[0] in grain_names]
            our_g = [(p, n, v) for p, n, v in ours if n.split("[")[0] in grain_names]
            assert ff_g == our_g
            any_grain = any_grain or bool(ff_g)
        assert any_grain, "ffmpeg saw no grain fields"

    def test_sections_match(self, grainy_packets):
        """OBU-level sections appear in the same order. (FFmpeg further
        subdivides a Frame OBU into "Frame Header" + "Tile Group"
        sections where the reference — and we — emit one "Frame"
        section, obu.rs:150; only the shared names are compared.)"""
        core_names = {"OBU header", "Temporal Delimiter", "Sequence Header"}
        for (_, ff_sections), (_, our_sections) in zip(
            _ffmpeg_fields(grainy_packets), _our_fields(grainy_packets)
        ):
            core = [s for s in ff_sections if s in core_names]
            ours_core = [s for s in our_sections if s in core_names]
            assert core == ours_core
            # a Frame OBU shows up as "Frame" on our side wherever
            # FFmpeg opened a "Frame Header" section
            assert our_sections.count("Frame") == ff_sections.count(
                "Frame Header"
            ) + ff_sections.count("Frame OBU")


class TestFormat:
    def test_field_line_format(self, caplog):
        """Exact reference line layout (trace.rs:37-49): pos left-12,
        name, binary right-justified so name+binary fill 60 columns."""
        with caplog.at_level(logging.DEBUG, logger="trace_headers"):
            trace_mod.trace_field("seq_profile", 16, 3, 0)
            trace_mod.trace_field("show_frame", 7, 1, 1)
        lines = [r.getMessage() for r in caplog.records]
        assert lines[0] == "16          seq_profile" + "000".rjust(49) + " = 0"
        assert lines[1] == "7           show_frame" + "1".rjust(50) + " = 1"

    def test_packet_and_reparse_lines(self, caplog):
        with caplog.at_level(logging.DEBUG, logger="trace_headers"):
            trace_mod.trace_packet(3019, 5, 5)
            trace_mod.trace_reparse(3030, 5, 5)
        msgs = [r.getMessage() for r in caplog.records]
        assert msgs[0] == "Packet: 3019 bytes, pts 5, dts 5."
        assert msgs[1] == "=== Re-parsing modified packet: 3030 bytes, pts 5, dts 5 ==="

    def test_zero_cost_when_disabled(self):
        parser = Av1Parser()
        assert parser.trace is None and parser.trace_section is None

    def test_auto_install_when_enabled(self, caplog):
        with caplog.at_level(logging.DEBUG, logger="trace_headers"):
            parser = Av1Parser()
            assert parser.trace is trace_mod.trace_field
            assert parser.trace_section is trace_mod.trace_section
