"""Raw elementary-stream framings: Annex B and bare Section 5.

Covers spec B.2 structure parse/serialize round-trips, format
detection, and the full pipeline oracles (apply -> re-inspect grain
present; remove -> none; no-op rewrite byte-identical) on both raw
framings, cross-checked byte-for-byte against the IVF path.
"""

import numpy as np
import pytest

from av1_builder import sample_grain_params
from grav1synth import pipelines
from grav1synth.container import annexb
from grav1synth.container.ffshim import Decoder, Encoder
from grav1synth.container.ivf import IvfHeader, IvfPacket, write_ivf
from grav1synth.obu import Av1Parser, GrainTableSegment
from grav1synth.tables import dump_table


@pytest.fixture(scope="module")
def encoded_packets():
    rng = np.random.default_rng(5)
    frames = []
    for i in range(6):
        y = (
            np.linspace(0, 180, 64)[None, :]
            + np.linspace(0, 50, 64)[:, None]
            + rng.normal(0, 4, (64, 64))
            + i * 2
        ).clip(0, 255).astype(np.uint8)
        u = np.full((32, 32), 118, np.uint8)
        v = np.full((32, 32), 132, np.uint8)
        frames.append((y, u, v))
    enc = Encoder(64, 64, 8)
    pkts = enc.encode_frames(frames)
    enc.close()
    return [p.data for p in pkts]


def _strip_size_fields(packets):
    """Per packet: the OBUs' raw bytes with internal size fields
    removed (the canonical Annex B shape, where obu_length is external)."""
    parser = Av1Parser()
    out = []
    for data in packets:
        obus = []
        for p in parser.parse_packet(data, 0):
            hdr = bytearray(data[p.start_byte : p.payload_start])
            if p.leb_size_pos is not None:
                del hdr[p.leb_size_pos - p.start_byte :]
                hdr[0] &= ~0x02
            obus.append(bytes(hdr) + data[p.payload_start : p.payload_end])
        out.append(obus)
    return out


@pytest.fixture(scope="module")
def annexb_path(encoded_packets, tmp_path_factory):
    tus = [
        annexb.TemporalUnit([obus]) for obus in _strip_size_fields(encoded_packets)
    ]
    path = tmp_path_factory.mktemp("raw") / "stream.annexb.obu"
    path.write_bytes(annexb.serialize_annexb(tus))
    return str(path)


@pytest.fixture(scope="module")
def section5_path(encoded_packets, tmp_path_factory):
    path = tmp_path_factory.mktemp("raw") / "stream.obu"
    path.write_bytes(b"".join(encoded_packets))
    return str(path)


@pytest.fixture()
def grain_table(tmp_path):
    path = tmp_path / "grain.tbl"
    seg = GrainTableSegment(0, 10**13, sample_grain_params(seed=91))
    dump_table([seg], str(path))
    return str(path)


class TestFraming:
    def test_parse_serialize_roundtrip(self, annexb_path):
        data = open(annexb_path, "rb").read()
        tus = annexb.parse_annexb(data)
        assert annexb.serialize_annexb(tus) == data
        # every OBU in canonical Annex B form has no size field
        assert all(not (o[0] & 0x02) for tu in tus for o in tu.obus())

    def test_detection(self, annexb_path, section5_path):
        ab = open(annexb_path, "rb").read()
        s5 = open(section5_path, "rb").read()
        assert annexb.detect_annexb(ab)
        assert not annexb.detect_section5(ab)
        assert annexb.detect_section5(s5)
        assert not annexb.detect_annexb(s5)
        # container magics must fall through to the shim
        for blob in (b"\x1a\x45\xdf\xa3" + bytes(64), b"\x00\x00\x00\x20ftypisom" + bytes(64)):
            assert not annexb.detect_annexb(blob)
            assert not annexb.detect_section5(blob)

    def test_videofile_kinds(self, annexb_path, section5_path):
        with pipelines.VideoFile(annexb_path) as vf:
            assert vf.kind == "annexb"
            pkts = list(vf.packets())
            assert pkts[0].obu_extents is not None
        with pipelines.VideoFile(section5_path) as vf:
            assert vf.kind == "section5"
            assert list(vf.packets())[0].obu_extents is None

    def test_tu_to_section5_decodes(self, annexb_path, encoded_packets):
        with pipelines.VideoFile(annexb_path) as vf:
            feed = [(pipelines._decodable(p), p.pts) for p in vf.packets()]
        dec = Decoder("libdav1d", apply_grain=False)
        frames = list(dec.decode_all(feed))
        dec.close()
        dec = Decoder("libdav1d", apply_grain=False)
        ref = list(dec.decode_all([(d, i) for i, d in enumerate(encoded_packets)]))
        dec.close()
        assert len(frames) == len(ref)
        for a, b in zip(frames, ref):
            for pa, pb in zip(a.planes, b.planes):
                np.testing.assert_array_equal(pa, pb)

    def test_split_section5_tus(self, encoded_packets, section5_path):
        data = open(section5_path, "rb").read()
        tus = annexb.split_section5_tus(data)
        assert tus == list(encoded_packets)


class TestRawPipelines:
    @pytest.mark.parametrize("which", ["annexb", "section5"])
    def test_apply_remove_roundtrip(
        self, which, annexb_path, section5_path, grain_table, tmp_path
    ):
        src = annexb_path if which == "annexb" else section5_path
        grained = str(tmp_path / f"g.{which}.obu")
        pipelines.apply_table(src, grained, grain_table, progress=False)
        segs = pipelines.inspect(grained, str(tmp_path / "g.tbl"), progress=False)
        assert segs, "apply: re-inspect must report grain"

        degrained = str(tmp_path / f"d.{which}.obu")
        pipelines.remove(grained, degrained, progress=False)
        assert (
            pipelines.inspect(degrained, str(tmp_path / "d.tbl"), progress=False)
            is None
        )

    @pytest.mark.parametrize("which", ["annexb", "section5"])
    def test_noop_rewrite_is_byte_identical(
        self, which, annexb_path, section5_path, tmp_path
    ):
        """remove on a grainless stream must reproduce the input exactly
        (framing, frame-unit grouping, size-field presence included)."""
        src = annexb_path if which == "annexb" else section5_path
        out = str(tmp_path / "noop.obu")
        pipelines.remove(src, out, progress=False)
        assert open(out, "rb").read() == open(src, "rb").read()

    def test_raw_apply_matches_ivf_apply(
        self, encoded_packets, section5_path, grain_table, tmp_path
    ):
        """The same table applied through the raw path and the IVF path
        must produce identical rewritten temporal units."""
        ivf_in = str(tmp_path / "in.ivf")
        write_ivf(
            ivf_in,
            IvfHeader(width=64, height=64, frame_count=len(encoded_packets)),
            [IvfPacket(i, d) for i, d in enumerate(encoded_packets)],
        )
        ivf_out = str(tmp_path / "out.ivf")
        raw_out = str(tmp_path / "out.obu")
        pipelines.apply_table(ivf_in, ivf_out, grain_table, progress=False)
        pipelines.apply_table(section5_path, raw_out, grain_table, progress=False)
        from grav1synth.container.ivf import read_ivf

        _, pkts = read_ivf(ivf_out)
        raw_tus = annexb.split_section5_tus(open(raw_out, "rb").read())
        assert [p.data for p in pkts] == raw_tus

    def test_annexb_apply_grain_decodes_with_grain(
        self, annexb_path, grain_table, tmp_path
    ):
        out = str(tmp_path / "g.annexb.obu")
        pipelines.apply_table(annexb_path, out, grain_table, progress=False)
        with pipelines.VideoFile(out) as vf:
            assert vf.kind == "annexb"
            feed = [(pipelines._decodable(p), p.pts) for p in vf.packets()]
        dec = Decoder("libdav1d", apply_grain=True)
        n = sum(1 for _ in dec.decode_all(feed))
        dec.close()
        assert n == len(feed)
