"""ctypes bindings for the native libav* shim (gravnative.cpp).

Provides demux/remux for arbitrary containers (MKV/MP4/IVF/...), AV1
pixel decode (libdav1d with film-grain on/off — the grain-synthesis
bit-exactness oracle), and a libaom encoder for self-generated test
fixtures. Role parity with reference grav1synth src/reader.rs (demux +
decode) and src/parser.rs remuxing, via a C++ shim instead of Rust FFI.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libgravnative.so")


class GravStreamInfoC(C.Structure):
    _fields_ = [
        ("index", C.c_int32),
        ("codec_type", C.c_int32),
        ("codec_id", C.c_int32),
        ("width", C.c_int32),
        ("height", C.c_int32),
        ("bit_depth", C.c_int32),
        ("subsampling_x", C.c_int32),
        ("subsampling_y", C.c_int32),
        ("time_base_num", C.c_int32),
        ("time_base_den", C.c_int32),
        ("frame_rate_num", C.c_int32),
        ("frame_rate_den", C.c_int32),
        ("color_range", C.c_int32),
        ("color_trc", C.c_int32),
        ("nb_frames", C.c_int64),
    ]


class GravPacketViewC(C.Structure):
    _fields_ = [
        ("data", C.POINTER(C.c_uint8)),
        ("size", C.c_int32),
        ("stream_index", C.c_int32),
        ("pts", C.c_int64),
        ("dts", C.c_int64),
        ("duration", C.c_int64),
        ("flags", C.c_int32),
    ]


class GravFrameViewC(C.Structure):
    _fields_ = [
        ("data", C.POINTER(C.c_uint8) * 3),
        ("stride", C.c_int64 * 3),
        ("width", C.c_int32),
        ("height", C.c_int32),
        ("bit_depth", C.c_int32),
        ("subsampling_x", C.c_int32),
        ("subsampling_y", C.c_int32),
        ("num_planes", C.c_int32),
        ("pts", C.c_int64),
    ]


_lib = None


def _build_native() -> None:
    subprocess.run(
        ["make", "-C", _NATIVE_DIR],
        check=True,
        capture_output=True,
    )


def load_native() -> C.CDLL:
    """Load (building on demand) the native shim."""
    global _lib
    if _lib is not None:
        return _lib
    # make is a no-op when the .so is newer than the source
    _build_native()
    lib = C.CDLL(_SO_PATH)

    lib.grav_demux_open.restype = C.c_void_p
    lib.grav_demux_open.argtypes = [C.c_char_p, C.c_char_p, C.c_int]
    lib.grav_demux_stream_count.argtypes = [C.c_void_p]
    lib.grav_demux_best_video_stream.argtypes = [C.c_void_p]
    lib.grav_demux_stream_info.argtypes = [
        C.c_void_p,
        C.c_int,
        C.POINTER(GravStreamInfoC),
    ]
    lib.grav_demux_read.argtypes = [C.c_void_p, C.POINTER(GravPacketViewC)]
    lib.grav_demux_close.argtypes = [C.c_void_p]

    lib.grav_remux_open.restype = C.c_void_p
    lib.grav_remux_open.argtypes = [C.c_char_p, C.c_void_p, C.c_char_p, C.c_int]
    lib.grav_remux_write.argtypes = [
        C.c_void_p,
        C.c_int,
        C.POINTER(C.c_uint8),
        C.c_int,
        C.c_int64,
        C.c_int64,
        C.c_int64,
        C.c_int,
    ]
    lib.grav_remux_finish.argtypes = [C.c_void_p]

    lib.grav_decoder_open.restype = C.c_void_p
    lib.grav_decoder_open.argtypes = [
        C.c_char_p,
        C.c_int,
        C.c_int,
        C.c_char_p,
        C.c_int,
    ]
    lib.grav_decoder_send.argtypes = [
        C.c_void_p,
        C.POINTER(C.c_uint8),
        C.c_int,
        C.c_int64,
    ]
    lib.grav_decoder_receive.argtypes = [C.c_void_p, C.POINTER(GravFrameViewC)]
    lib.grav_decoder_close.argtypes = [C.c_void_p]

    lib.grav_encoder_open.restype = C.c_void_p
    lib.grav_encoder_open.argtypes = [
        C.c_int,
        C.c_int,
        C.c_int,
        C.c_int,
        C.c_int,
        C.c_int,
        C.c_char_p,
        C.c_int,
        C.c_int,
        C.c_char_p,
        C.c_int,
    ]
    lib.grav_encoder_send.argtypes = [
        C.c_void_p,
        C.POINTER(C.c_uint8),
        C.c_int64,
        C.POINTER(C.c_uint8),
        C.POINTER(C.c_uint8),
        C.c_int64,
        C.c_int64,
    ]
    lib.grav_encoder_receive.argtypes = [C.c_void_p, C.POINTER(GravPacketViewC)]
    lib.grav_encoder_close.argtypes = [C.c_void_p]

    lib.grav_demux_disposition.argtypes = [C.c_void_p, C.c_int]
    lib.grav_demux_meta.argtypes = [C.c_void_p, C.c_int, C.c_char_p, C.c_int]
    lib.grav_demux_chapter_count.argtypes = [C.c_void_p]
    lib.grav_demux_chapter.argtypes = [
        C.c_void_p,
        C.c_int,
        C.POINTER(C.c_int64),
        C.POINTER(C.c_int64),
        C.c_char_p,
        C.c_int,
    ]
    lib.grav_make_multistream.argtypes = [
        C.c_char_p,
        C.c_char_p,
        C.c_int,
        C.c_char_p,
        C.c_int,
    ]

    _lib = lib
    return lib


_ERRBUF_LEN = 512


def _errbuf():
    return C.create_string_buffer(_ERRBUF_LEN)


@dataclass
class StreamInfo:
    index: int
    codec_type: int  # 0=video, 1=audio, 3=subtitle (AVMediaType)
    codec_id: int
    width: int
    height: int
    bit_depth: int
    subsampling: Tuple[int, int]
    time_base: Tuple[int, int]
    frame_rate: Tuple[int, int]
    color_range: int
    color_trc: int
    nb_frames: int

    @property
    def is_video(self) -> bool:
        return self.codec_type == 0


@dataclass
class Packet:
    stream_index: int
    data: bytes
    pts: int
    dts: int
    duration: int
    flags: int


@dataclass
class Frame:
    """Decoded planar frame; planes are uint8 (8-bit) or uint16 arrays."""

    planes: List[np.ndarray]
    bit_depth: int
    subsampling: Tuple[int, int]
    pts: int

    @property
    def width(self) -> int:
        return self.planes[0].shape[1]

    @property
    def height(self) -> int:
        return self.planes[0].shape[0]


class Demuxer:
    def __init__(self, path: str):
        self._lib = load_native()
        err = _errbuf()
        self._h = self._lib.grav_demux_open(path.encode(), err, _ERRBUF_LEN)
        if not self._h:
            raise IOError(f"demux open failed: {err.value.decode()}")

    def stream_count(self) -> int:
        return self._lib.grav_demux_stream_count(self._h)

    def best_video_stream(self) -> int:
        idx = self._lib.grav_demux_best_video_stream(self._h)
        if idx < 0:
            raise IOError("no video stream found")
        return idx

    def stream_info(self, idx: int) -> StreamInfo:
        info = GravStreamInfoC()
        if self._lib.grav_demux_stream_info(self._h, idx, C.byref(info)) != 0:
            raise IndexError(f"bad stream index {idx}")
        return StreamInfo(
            index=info.index,
            codec_type=info.codec_type,
            codec_id=info.codec_id,
            width=info.width,
            height=info.height,
            bit_depth=info.bit_depth,
            subsampling=(info.subsampling_x, info.subsampling_y),
            time_base=(info.time_base_num, info.time_base_den),
            frame_rate=(info.frame_rate_num, info.frame_rate_den),
            color_range=info.color_range,
            color_trc=info.color_trc,
            nb_frames=info.nb_frames,
        )

    def packets(self) -> Iterator[Packet]:
        view = GravPacketViewC()
        while True:
            ret = self._lib.grav_demux_read(self._h, C.byref(view))
            if ret == 0:
                return
            if ret < 0:
                raise IOError(f"demux read error {ret}")
            data = C.string_at(view.data, view.size)
            yield Packet(
                view.stream_index, data, view.pts, view.dts, view.duration, view.flags
            )

    def disposition(self, idx: int) -> int:
        """AV_DISPOSITION_* bitmask of a stream."""
        return self._lib.grav_demux_disposition(self._h, idx)

    def metadata(self, stream: int = -1) -> dict:
        """Tag metadata of a stream, or the container's (stream=-1)."""
        buf = C.create_string_buffer(1 << 16)
        n = self._lib.grav_demux_meta(self._h, stream, buf, len(buf))
        if n < 0:
            raise IndexError(f"bad stream index {stream}")
        out = {}
        for line in buf.value.decode("utf-8", "replace").splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                out[k] = v
        return out

    def chapters(self):
        """[(start_ms, end_ms, title), ...]"""
        out = []
        title = C.create_string_buffer(512)
        start = C.c_int64()
        end = C.c_int64()
        for i in range(self._lib.grav_demux_chapter_count(self._h)):
            self._lib.grav_demux_chapter(
                self._h, i, C.byref(start), C.byref(end), title, len(title)
            )
            out.append((start.value, end.value, title.value.decode()))
        return out

    def close(self) -> None:
        if self._h:
            self._lib.grav_demux_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def make_multistream_fixture(
    video_in: str,
    out_path: str,
    audio: bool = True,
    subs: bool = True,
    meta: bool = True,
) -> None:
    """Mux ``video_in``'s AV1 stream with a generated AAC audio track,
    a text subtitle track (SubRip in MKV, tx3g in MP4), chapters and tag
    metadata — the fixture the remux-parity tests feed through
    apply/remove (reference behavior under test: parser.rs:189-253)."""
    lib = load_native()
    err = _errbuf()
    flags = (1 if audio else 0) | (2 if subs else 0) | (4 if meta else 0)
    if lib.grav_make_multistream(
        video_in.encode(), out_path.encode(), flags, err, _ERRBUF_LEN
    ) != 0:
        raise IOError(f"multistream fixture failed: {err.value.decode()}")


class Remuxer:
    """Writes an output container mirroring a Demuxer's A/V/S streams."""

    def __init__(self, path: str, source: Demuxer):
        self._lib = load_native()
        err = _errbuf()
        self._h = self._lib.grav_remux_open(
            path.encode(), source._h, err, _ERRBUF_LEN
        )
        if not self._h:
            raise IOError(f"remux open failed: {err.value.decode()}")

    def write(self, pkt: Packet, data: Optional[bytes] = None) -> None:
        payload = pkt.data if data is None else data
        buf = (C.c_uint8 * len(payload)).from_buffer_copy(payload)
        ret = self._lib.grav_remux_write(
            self._h,
            pkt.stream_index,
            buf,
            len(payload),
            pkt.pts,
            pkt.dts,
            pkt.duration,
            pkt.flags,
        )
        if ret < 0:
            raise IOError(f"remux write error {ret}")

    def finish(self) -> None:
        if self._h:
            ret = self._lib.grav_remux_finish(self._h)
            self._h = None
            if ret < 0:
                raise IOError(f"remux finish error {ret}")


class Decoder:
    """AV1 decoder. codec='libdav1d' exposes apply_grain switching, making
    decode-with-grain minus decode-without-grain the spec grain oracle."""

    def __init__(self, codec: str = "libdav1d", apply_grain: bool = False, threads: int = 0):
        self._lib = load_native()
        err = _errbuf()
        self._h = self._lib.grav_decoder_open(
            codec.encode(), int(apply_grain), threads, err, _ERRBUF_LEN
        )
        if not self._h:
            raise IOError(f"decoder open failed: {err.value.decode()}")

    def send(self, data: Optional[bytes], pts: int = 0) -> None:
        if data is None:
            ret = self._lib.grav_decoder_send(self._h, None, 0, 0)
        else:
            buf = (C.c_uint8 * len(data)).from_buffer_copy(data)
            ret = self._lib.grav_decoder_send(self._h, buf, len(data), pts)
        if ret < 0 and ret != -11:  # -EAGAIN tolerated
            raise IOError(f"decoder send error {ret}")

    def receive(self) -> Optional[Frame]:
        """One frame, or None if more input is needed. Raises EOFError at
        end of stream (after a flush send)."""
        view = GravFrameViewC()
        ret = self._lib.grav_decoder_receive(self._h, C.byref(view))
        if ret == 0:
            return None
        if ret == -1:
            raise EOFError
        if ret < 0:
            raise IOError(f"decoder receive error {ret}")
        return self._frame_from_view(view)

    @staticmethod
    def _frame_from_view(view: GravFrameViewC) -> Frame:
        planes = []
        itemsize = 1 if view.bit_depth == 8 else 2
        dtype = np.uint8 if itemsize == 1 else np.uint16
        for p in range(view.num_planes):
            if p == 0:
                w, h = view.width, view.height
            else:
                w = (view.width + view.subsampling_x) >> view.subsampling_x
                h = (view.height + view.subsampling_y) >> view.subsampling_y
            stride = view.stride[p]
            raw = C.string_at(view.data[p], stride * h)
            arr = np.frombuffer(raw, dtype=np.uint8).reshape(h, stride)
            arr = arr[:, : w * itemsize].copy()
            planes.append(arr.view(dtype))
        return Frame(
            planes=planes,
            bit_depth=view.bit_depth,
            subsampling=(view.subsampling_x, view.subsampling_y),
            pts=view.pts,
        )

    def decode_all(self, packets, flush: bool = True) -> Iterator[Frame]:
        for data, pts in packets:
            self.send(data, pts)
            while True:
                f = self.receive()
                if f is None:
                    break
                yield f
        if flush:
            self.send(None)
            while True:
                try:
                    f = self.receive()
                except EOFError:
                    return
                if f is None:
                    return
                yield f

    def close(self) -> None:
        if self._h:
            self._lib.grav_decoder_close(self._h)
            self._h = None


class Encoder:
    """libaom-av1 encoder used to produce real AV1 fixtures/test content."""

    def __init__(
        self,
        width: int,
        height: int,
        bit_depth: int = 8,
        monochrome: bool = False,
        fps: Tuple[int, int] = (30, 1),
        extra_opts: str = "",
        sub_x: int = 1,
        sub_y: int = 1,
    ):
        self._lib = load_native()
        err = _errbuf()
        self._h = self._lib.grav_encoder_open(
            width,
            height,
            bit_depth,
            int(monochrome),
            fps[0],
            fps[1],
            extra_opts.encode(),
            sub_x,
            sub_y,
            err,
            _ERRBUF_LEN,
        )
        if not self._h:
            raise IOError(f"encoder open failed: {err.value.decode()}")
        self.width, self.height, self.bit_depth = width, height, bit_depth
        self.monochrome = monochrome
        self.sub_x, self.sub_y = sub_x, sub_y

    def _plane_ptr(self, arr: Optional[np.ndarray]):
        if arr is None:
            return None, 0
        arr = np.ascontiguousarray(arr)
        return arr.ctypes.data_as(C.POINTER(C.c_uint8)), arr.strides[0]

    def send(self, y: Optional[np.ndarray], u=None, v=None, pts: int = 0) -> None:
        if y is None:
            ret = self._lib.grav_encoder_send(self._h, None, 0, None, None, 0, 0)
        else:
            y = np.ascontiguousarray(y)
            yp = y.ctypes.data_as(C.POINTER(C.c_uint8))
            if u is not None:
                u = np.ascontiguousarray(u)
                v = np.ascontiguousarray(v)
                up = u.ctypes.data_as(C.POINTER(C.c_uint8))
                vp = v.ctypes.data_as(C.POINTER(C.c_uint8))
                stride_uv = u.strides[0]
            else:
                up = vp = None
                stride_uv = 0
            ret = self._lib.grav_encoder_send(
                self._h, yp, y.strides[0], up, vp, stride_uv, pts
            )
        if ret < 0 and ret != -11:
            raise IOError(f"encoder send error {ret}")

    def receive(self) -> Optional[Packet]:
        view = GravPacketViewC()
        ret = self._lib.grav_encoder_receive(self._h, C.byref(view))
        if ret == 0:
            return None
        if ret == -1:
            raise EOFError
        if ret < 0:
            raise IOError(f"encoder receive error {ret}")
        data = C.string_at(view.data, view.size)
        return Packet(0, data, view.pts, view.dts, view.duration, view.flags)

    def encode_frames(self, frames) -> List[Packet]:
        """Encode a sequence of (y, u, v) ndarray tuples; returns packets."""
        out: List[Packet] = []
        for i, planes in enumerate(frames):
            y, u, v = planes if isinstance(planes, tuple) else (planes, None, None)
            self.send(y, u, v, pts=i)
            while True:
                p = self.receive()
                if p is None:
                    break
                out.append(p)
        self.send(None)
        while True:
            try:
                p = self.receive()
            except EOFError:
                break
            if p is None:
                break
            out.append(p)
        return out

    def close(self) -> None:
        if self._h:
            self._lib.grav_encoder_close(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# FFmpeg trace_headers oracle (tests): libavcodec's own AV1 field tracer


def trace_headers_ffmpeg(packets) -> list:
    """Run libavcodec's ``trace_headers`` BSF over a sequence of
    low-overhead temporal units (ONE filter instance, so sequence-header
    state persists) and return the per-packet captured log texts — the
    external oracle our tracer output is diffed against (the reference's
    trace subsystem mimics exactly this filter, trace.rs docstring)."""
    if isinstance(packets, (bytes, bytearray)):
        packets = [bytes(packets)]
    lib = load_native()
    if not hasattr(lib.grav_trace_headers, "_configured"):
        lib.grav_trace_headers.restype = C.c_int64
        lib.grav_trace_headers.argtypes = [
            C.POINTER(C.c_uint8),
            C.POINTER(C.c_int64),
            C.c_int64,
            C.c_char_p,
            C.c_int64,
            C.c_char_p,
            C.c_int,
        ]
        lib.grav_trace_headers._configured = True
    blob = b"".join(packets)
    sizes = (C.c_int64 * len(packets))(*[len(p) for p in packets])
    out = C.create_string_buffer(1 << 24)
    err = _errbuf()
    buf = (C.c_uint8 * len(blob)).from_buffer_copy(blob)
    n = lib.grav_trace_headers(
        buf, sizes, len(packets), out, len(out), err, _ERRBUF_LEN
    )
    if n < 0:
        raise RuntimeError(f"trace_headers failed: {err.value.decode()}")
    text = out.value.decode(errors="replace")
    parts = text.split("\x1f")
    return parts[: len(packets)]
