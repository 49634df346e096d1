"""render pipeline: device-synthesized pixels vs dav1d grain-on decode.

The render subcommand turns the grain engine into a product surface;
its oracle is dav1d itself: for every
displayed frame and plane, render output must be bit-exact with
dav1d's own grain synthesis on the same stream. Fixture matrix covers
the decoder-state machinery (GrainFrameState): plain streams, high bit
depth, monochrome, and hidden alt-refs (show_existing re-display of
saved grain state).
"""

import numpy as np
import pytest

from av1_builder import sample_grain_params
from grav1synth import pipelines
from grav1synth.container.ffshim import Decoder
from grav1synth.container.ivf import IvfHeader, IvfPacket, write_ivf
from grav1synth.container.y4m import Y4mWriter, read_y4m
from grav1synth.obu import Av1Parser, GrainRewriter, GrainTableSegment

from test_conformance import _encode_case, _grain_for

CASES = [
    # (name, w, h, bd, mono, n, opts)
    ("8bit", 96, 66, 8, False, 5, ""),
    ("10bit", 96, 64, 10, False, 4, ""),
    ("mono", 64, 64, 8, True, 4, ""),
    (
        "altref-hidden",
        128,
        96,
        8,
        False,
        12,
        "lag-in-frames=8:auto-alt-ref=1:usage=good:cpu-used=6:crf=30",
    ),
]


def _grainy_ivf(tmp_path, w, h, bd, mono, n, opts):
    pkts = _encode_case(w, h, bd, mono, n, opts)
    seg = GrainTableSegment(0, 10**14, _grain_for(mono))
    parser = Av1Parser()
    rw = GrainRewriter([seg])
    out = []
    for p in pkts:
        ts = -(-p.pts * 10_000_000 // 30)
        parsed = parser.parse_packet(p.data, ts)
        out.append(rw.rewrite_packet(p.data, parsed, ts, parser.sequence_header))
    path = str(tmp_path / "grainy.ivf")
    write_ivf(
        path,
        IvfHeader(width=w, height=h, frame_count=len(out)),
        [IvfPacket(i, d) for i, d in enumerate(out)],
    )
    return path, out


def _dav1d_frames(datas, grain):
    dec = Decoder("libdav1d", apply_grain=grain)
    out = list(dec.decode_all([(d, i) for i, d in enumerate(datas)]))
    dec.close()
    return out


@pytest.mark.parametrize("name,w,h,bd,mono,n,opts", CASES, ids=[c[0] for c in CASES])
def test_render_bit_exact_vs_dav1d(tmp_path, name, w, h, bd, mono, n, opts):
    path, datas = _grainy_ivf(tmp_path, w, h, bd, mono, n, opts)
    out = str(tmp_path / "out.y4m")
    rendered = pipelines.render(path, out, batch=3, progress=False)
    assert rendered == n

    oracle = _dav1d_frames(datas, True)
    frames, fps, rbd, sub, rmono = read_y4m(out)
    assert rbd == bd and rmono == mono
    assert len(frames) == len(oracle) == n
    bad = 0
    for got, want in zip(frames, oracle):
        nplanes = 1 if mono else 3
        for pi in range(nplanes):
            bad += int(
                (got[pi].astype(np.int64) != want.planes[pi].astype(np.int64)).sum()
            )
    assert bad == 0, f"{name}: {bad} mismatching samples vs dav1d"


def test_render_no_grain_matches_clean_decode(tmp_path):
    path, datas = _grainy_ivf(tmp_path, 96, 66, 8, False, 4, "")
    out = str(tmp_path / "clean.y4m")
    pipelines.render(path, out, grain=False, progress=False)
    frames, *_ = read_y4m(out)
    clean = _dav1d_frames(datas, False)
    for got, want in zip(frames, clean):
        for pi in range(3):
            assert (got[pi] == want.planes[pi]).all()


def test_render_stage_stats(tmp_path):
    """stage_stats must record every stage and account for a
    nontrivial share of the wall clock (bench.py relies on this for
    its model-vs-wall reconciliation row)."""
    import time

    path, _ = _grainy_ivf(tmp_path, 96, 66, 8, False, 6, "")
    out = str(tmp_path / "s.y4m")
    stats = {}
    t0 = time.time()
    n = pipelines.render(path, out, batch=3, progress=False, stage_stats=stats)
    wall = time.time() - t0
    assert n == 6
    assert set(stats) == {"decode", "dispatch", "download", "mux"}
    total = sum(stats.values())
    assert 0 < total <= wall
    assert stats["decode"] > 0 and stats["dispatch"] > 0
    assert stats["download"] > 0 and stats["mux"] > 0


def test_render_cli(tmp_path):
    from grav1synth.cli import main

    path, _ = _grainy_ivf(tmp_path, 64, 64, 8, False, 3, "")
    out = tmp_path / "o.y4m"
    assert main(["render", path, "-o", str(out), "--batch", "2", "-y"]) == 0
    frames, *_ = read_y4m(str(out))
    assert len(frames) == 3


def test_y4m_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "t.y4m")
    w = Y4mWriter(path, 33, 21, (24, 1), bit_depth=10, subsampling=(1, 1))
    fr = []
    for _ in range(2):
        y = rng.integers(0, 1024, (21, 33)).astype(np.uint16)
        u = rng.integers(0, 1024, (11, 17)).astype(np.uint16)
        v = rng.integers(0, 1024, (11, 17)).astype(np.uint16)
        fr.append([y, u, v])
        w.write_frame([y, u, v])
    w.close()
    frames, fps, bd, sub, mono = read_y4m(path)
    assert fps == (24, 1) and bd == 10 and sub == (1, 1) and not mono
    for got, want in zip(frames, fr):
        for a, b in zip(got, want):
            assert (a == b).all()


def test_render_sharded_identical(tmp_path):
    """render --shards N (frames spread over the device mesh through
    parallel.mesh.sharded_apply) writes a byte-identical y4m to the
    serial path — batch 5 on 8 devices also exercises the padding."""
    path, _ = _grainy_ivf(tmp_path, 96, 66, 8, False, 7, "")
    serial = tmp_path / "serial.y4m"
    sharded = tmp_path / "sharded.y4m"
    pipelines.render(path, str(serial), batch=5, progress=False)
    pipelines.render(path, str(sharded), batch=5, progress=False, shards=8)
    assert serial.read_bytes() == sharded.read_bytes()


def test_render_threaded_prefetch_identical(tmp_path, monkeypatch):
    """GRAV1_PREFETCH=1 forces the threaded decode pipeline (on small
    hosts maybe_prefetch would fall back to serial); output must stay
    byte-identical to the serial loop — ordering is a single FIFO."""
    path, _ = _grainy_ivf(tmp_path, 96, 66, 8, False, 7, "")
    serial = str(tmp_path / "serial.y4m")
    threaded = str(tmp_path / "threaded.y4m")
    monkeypatch.setenv("GRAV1_PREFETCH", "0")
    pipelines.render(path, serial, batch=3, progress=False)
    monkeypatch.setenv("GRAV1_PREFETCH", "1")
    pipelines.render(path, threaded, batch=3, progress=False)
    assert open(serial, "rb").read() == open(threaded, "rb").read()
