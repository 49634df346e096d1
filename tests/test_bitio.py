"""Unit tests for the bit-primitive layer.

Mirrors the coverage of the reference's util.rs tests (leb128/uvlc/ns/su
round trips, alignment, saturation) with our own cases.
"""

import pytest

from grav1synth.bitio import (
    BitReader,
    BitReaderError,
    BitWriter,
    leb128_encode,
    leb128_size,
)


def test_f_basic():
    r = BitReader(bytes([0b1011_0110, 0xFF]))
    assert r.f(1) == 1
    assert r.f(3) == 0b011
    assert r.f(4) == 0b0110
    assert r.f(8) == 0xFF
    assert r.bits_remaining() == 0


def test_f_across_bytes():
    r = BitReader(bytes([0x12, 0x34, 0x56, 0x78]))
    assert r.f(4) == 0x1
    assert r.f(16) == 0x2345
    assert r.f(12) == 0x678


def test_f_overrun():
    r = BitReader(b"\x00")
    with pytest.raises(BitReaderError):
        r.f(9)


def test_bool_and_zero_bit():
    r = BitReader(bytes([0b1000_0000]))
    assert r.bool_() is True
    r.zero_bit()
    with pytest.raises(BitReaderError):
        BitReader(bytes([0b1000_0000]), start_bit=0).zero_bit()


def test_byte_alignment():
    r = BitReader(bytes([0b1000_0000, 0xAB]))
    r.f(1)
    r.byte_alignment()
    assert r.pos == 8
    assert r.f(8) == 0xAB
    # non-zero padding rejected
    r2 = BitReader(bytes([0b1100_0000]))
    r2.f(1)
    with pytest.raises(BitReaderError):
        r2.byte_alignment()


@pytest.mark.parametrize(
    "value,encoding",
    [
        (0, b"\x00"),
        (1, b"\x01"),
        (127, b"\x7f"),
        (128, b"\x80\x01"),
        (0x3FFF, b"\xff\x7f"),
        (0xFFFFFFFF, b"\xff\xff\xff\xff\x0f"),
    ],
)
def test_leb128_known(value, encoding):
    assert leb128_encode(value) == encoding
    assert BitReader(encoding).leb128() == value


def test_leb128_roundtrip_sweep():
    for v in list(range(0, 4096, 7)) + [2**14, 2**21 - 1, 2**28, 2**32 - 1]:
        enc = leb128_encode(v)
        assert len(enc) == leb128_size(v)
        r = BitReader(enc)
        assert r.leb128() == v
        assert r.bits_remaining() == 0


def test_leb128_padded():
    # a size can be written in more bytes than minimal (used for splicing)
    enc = leb128_encode(5, min_bytes=3)
    assert enc == b"\x85\x80\x00"
    assert BitReader(enc).leb128() == 5


def test_leb128_too_long():
    with pytest.raises(BitReaderError):
        BitReader(b"\xff" * 9).leb128()


def test_uvlc():
    # 0 -> '1'; 1 -> '010'; 2 -> '011'; 3 -> '00100'
    r = BitReader(bytes([0b1_010_011_0, 0b0100_0000]))
    assert r.uvlc() == 0
    assert r.uvlc() == 1
    assert r.uvlc() == 2
    assert r.uvlc() == 3


def test_uvlc_saturation():
    # 32 leading zeros saturate to u32::MAX without reading literal bits
    data = b"\x00\x00\x00\x00" + b"\x00"
    r = BitReader(data)
    assert r.uvlc() == 2**32 - 1
    assert r.pos == 32


def test_ns():
    # ns(3): w=2, m=1: values: 0 -> '0'; 1 -> '10'; 2 -> '11'
    r = BitReader(bytes([0b0_10_11_000]))
    assert r.ns(3) == 0
    assert r.ns(3) == 1
    assert r.ns(3) == 2


def test_ns_power_of_two():
    # ns(4) reduces to f(2)
    r = BitReader(bytes([0b11_000000]))
    assert r.ns(4) == 3


def test_su():
    w = BitWriter()
    for v in (-5, 5, -1, 0, 3):
        w.put_su(v, 4)
    w.byte_align()
    r = BitReader(w.getvalue())
    assert [r.su(4) for _ in range(5)] == [-5, 5, -1, 0, 3]


def test_writer_reader_roundtrip_mixed():
    w = BitWriter()
    w.put(1, 1)
    w.put(0x2345, 16)
    w.put(5, 3)
    w.put_leb128(300)
    w.byte_align()
    data = w.getvalue()
    r = BitReader(data)
    assert r.f(1) == 1
    assert r.f(16) == 0x2345
    assert r.f(3) == 5
    assert r.leb128() == 300


def test_writer_value_too_wide():
    w = BitWriter()
    with pytest.raises(ValueError):
        w.put(4, 2)


def test_trailing_bits_alignment():
    w = BitWriter()
    w.put(0b101, 3)
    w.align_trailing_bits()
    assert w.getvalue() == bytes([0b1011_0000])
    w2 = BitWriter()
    w2.put(0xAA, 8)
    w2.align_trailing_bits()
    assert w2.getvalue() == bytes([0xAA, 0x80])


def test_trace_hook():
    seen = []
    r = BitReader(bytes([0b1010_0000]))
    r.trace = lambda name, pos, n, v: seen.append((name, pos, n, v))
    r.f(3, "field_a")
    r.f(2)  # unnamed reads are not traced
    assert seen == [("field_a", 0, 3, 0b101)]
