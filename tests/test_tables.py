"""Grain-table format + aggregation unit tests."""

import io

import pytest

from av1_builder import sample_grain_params
from grav1synth.obu.types import (
    FilmGrainParams,
    GrainAction,
    GrainHeader,
    GrainTableSegment,
)
from grav1synth.tables import (
    aggregate_grain_headers,
    merge_segment_runs,
    packet_bounds,
    parse_table,
    write_table,
)
from grav1synth.tables.filmgrn1 import GrainTableError


def _roundtrip(segments):
    buf = io.StringIO()
    write_table(segments, buf)
    return parse_table(buf.getvalue())


class TestFormat:
    def test_roundtrip(self):
        p = sample_grain_params(seed=42)
        segs = [GrainTableSegment(0, 12345678, p)]
        got = _roundtrip(segs)
        assert len(got) == 1
        assert got[0].start_time == 0 and got[0].end_time == 12345678
        q = got[0].params
        assert q.grain_seed == 42
        assert q.scaling_points_y == p.scaling_points_y
        assert q.scaling_points_cb == p.scaling_points_cb
        assert q.ar_coeffs_y == p.ar_coeffs_y
        assert q.ar_coeffs_cb == p.ar_coeffs_cb
        assert q.cb_offset == p.cb_offset
        assert q.overlap_flag == p.overlap_flag

    def test_reference_example_table(self):
        # the reference repo's checked-in example (tests/example-table.tbl)
        text = """filmgrn1
E 0 26460000000 1 7391 1
\tp 0 6 0 8 0 1 0 0 0 0 0 0
\tsY 14  0 26 20 7 39 5 59 4 78 4 98 4 118 4 137 4 157 4 177 4 196 4 216 4 235 4 255 4
\tsCb 0
\tsCr 0
\tcY
\tcCb 0
\tcCr 0
"""
        segs = parse_table(text)
        assert len(segs) == 1
        p = segs[0].params
        assert p.grain_seed == 7391
        assert len(p.scaling_points_y) == 14
        assert p.scaling_points_y[0] == (0, 26)
        assert p.scaling_points_y[-1] == (255, 4)
        assert p.ar_coeff_lag == 0
        assert p.ar_coeffs_cb == [0]
        assert p.overlap_flag is True

    def test_missing_magic(self):
        with pytest.raises(GrainTableError):
            parse_table("E 0 1 1 2 1\n")

    def test_multi_segment(self):
        p1 = sample_grain_params(seed=1)
        p2 = sample_grain_params(seed=2)
        p2.scaling_points_y = [(0, 50), (255, 50)]
        got = _roundtrip(
            [GrainTableSegment(0, 100, p1), GrainTableSegment(100, 200, p2)]
        )
        assert len(got) == 2
        assert got[1].params.scaling_points_y == p2.scaling_points_y


def UH(params):
    return GrainHeader(GrainAction.UPDATE, params)


class TestAggregate:
    def test_packet_bounds_grid(self):
        # 24 fps: 10^7/24 ticks per frame, ceil-accumulated
        s0, e0 = packet_bounds(0, 24, 1)
        s1, e1 = packet_bounds(1, 24, 1)
        assert s0 == 0 and e0 == 416667
        assert s1 == e0 and e1 == 833334

    def test_fold_rules(self):
        p = sample_grain_params(seed=5)
        p2 = sample_grain_params(seed=99)  # same params, different seed
        p3 = sample_grain_params(seed=5)
        p3.scaling_points_y = [(0, 1), (255, 1)]
        headers = [
            UH(p),
            UH(p2),  # equal ignoring seed -> extends
            GrainHeader(GrainAction.COPY_REF),  # extends
            GrainHeader(GrainAction.DISABLE),  # closes
            UH(p3),  # new segment
        ]
        segs = aggregate_grain_headers(headers, 30, 1)
        assert len(segs) == 2
        assert segs[0].start_time == 0
        assert segs[0].end_time == packet_bounds(2, 30, 1)[1]
        assert segs[1].start_time == packet_bounds(4, 30, 1)[0]

    def test_disable_only_yields_empty(self):
        headers = [GrainHeader(GrainAction.DISABLE)] * 5
        assert aggregate_grain_headers(headers, 30, 1) == []

    def test_shard_merge_equals_single_pass(self):
        p = sample_grain_params(seed=5)
        q = sample_grain_params(seed=5)
        q.scaling_points_y = [(0, 9), (255, 9)]
        headers = (
            [UH(p)] * 7
            + [GrainHeader(GrainAction.DISABLE)] * 3
            + [UH(q)] * 10
            + [UH(p)] * 4
        )
        whole = aggregate_grain_headers(headers, 24, 1)
        for split in (1, 5, 8, 12, 17):
            a = aggregate_grain_headers(headers[:split], 24, 1, start_index=0)
            b = aggregate_grain_headers(headers[split:], 24, 1, start_index=split)
            merged = merge_segment_runs([a, b])
            assert [
                (s.start_time, s.end_time, s.params.scaling_points_y)
                for s in merged
            ] == [
                (s.start_time, s.end_time, s.params.scaling_points_y)
                for s in whole
            ], f"split at {split}"
