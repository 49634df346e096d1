"""Conformance sweep over a self-generated encoder matrix.

The reference validates against the dav1d-test-data corpus (740 inspect
/ 739 apply / 739 remove cases); that submodule is unavailable here, so
the corpus is generated by libaom across a feature matrix (bit depths,
resolutions incl. non-multiples of blocks, monochrome, tiles, hidden
frames via alt-ref, long GOPs) and every case runs the full round-trip
oracle chain:

  parse every packet -> apply grain -> re-inspect parity -> dav1d
  decodes the rewritten stream -> grain-off decode is pixel-lossless ->
  remove -> re-inspect reports no grain.
"""

import numpy as np
import pytest

from av1_builder import sample_grain_params
from grav1synth.container.ffshim import Decoder, Encoder
from grav1synth.obu import (
    Av1Parser,
    GrainAction,
    GrainRewriter,
    GrainTableSegment,
)

CASES = [
    # (name, w, h, bit_depth, monochrome, nframes, extra_opts, sub_x, sub_y)
    ("8bit-64", 64, 64, 8, False, 6, "", 1, 1),
    ("8bit-odd", 106, 74, 8, False, 5, "", 1, 1),
    ("10bit", 96, 64, 10, False, 5, "", 1, 1),
    ("12bit", 64, 64, 12, False, 4, "", 1, 1),
    ("mono", 64, 64, 8, True, 4, "", 1, 1),
    ("mono12", 64, 64, 12, True, 3, "", 1, 1),
    ("tiles", 256, 128, 8, False, 4, "tiles=2x2", 1, 1),
    ("altref-hidden", 128, 96, 8, False, 24, "lag-in-frames=16:auto-alt-ref=1:usage=good:cpu-used=4:crf=30", 1, 1),
    ("longgop", 96, 96, 8, False, 10, "usage=good:cpu-used=6:lag-in-frames=4", 1, 1),
    ("tiny", 34, 34, 8, False, 3, "", 1, 1),
    # error-resilient inter frames read explicit ref_order_hint fields
    ("error-resilient", 96, 96, 8, False, 8, "error-resilience=1:usage=good:cpu-used=6", 1, 1),
    ("no-order-hint", 96, 96, 8, False, 6, "aom-params=enable-order-hint=0", 1, 1),
    ("sb64", 128, 96, 8, False, 5, "aom-params=sb-size=64", 1, 1),
    ("screen-tune", 96, 96, 8, False, 5, "tune=psnr:aom-params=enable-intrabc=1", 1, 1),
    # seq profile 2 (4:2:2) and profile 1 (4:4:4), incl. high bit depth
    ("422-8bit", 96, 64, 8, False, 4, "", 1, 0),
    ("422-12bit", 90, 62, 12, False, 4, "", 1, 0),
    ("444-8bit", 96, 64, 8, False, 4, "", 0, 0),
    ("444-10bit", 90, 62, 10, False, 4, "", 0, 0),
    # still_picture sequence header branch (single-packet stream)
    ("still-picture", 128, 96, 8, False, 1, "still-picture=1", 1, 1),
]


def _encode_case(w, h, bd, mono, n, opts, sub_x=1, sub_y=1):
    rng = np.random.default_rng(hash((w, h, bd, n)) % 2**31)
    maxv = (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.uint16
    cw = -(-w // (1 << sub_x))
    ch = -(-h // (1 << sub_y))
    frames = []
    for i in range(n):
        y = np.clip(
            np.linspace(0, maxv * 0.9, w)[None, :]
            + np.linspace(0, maxv * 0.2, h)[:, None]
            + rng.normal(0, maxv * 0.01, (h, w))
            + i * maxv * 0.01,
            0,
            maxv,
        ).astype(dt)
        if mono:
            frames.append((y, None, None))
        else:
            u = np.full((ch, cw), (maxv + 1) // 2, dt)
            frames.append((y, u, u.copy()))
    enc = Encoder(w, h, bd, monochrome=mono, extra_opts=opts, sub_x=sub_x, sub_y=sub_y)
    pkts = enc.encode_frames(frames)
    enc.close()
    return pkts


def _grain_for(mono):
    p = sample_grain_params(seed=31337)
    if mono:
        p.scaling_points_cb = []
        p.scaling_points_cr = []
        p.ar_coeffs_cb = []
        p.ar_coeffs_cr = []
    return p


def run_oracle_chain(pkts, grain_params, n_shown, mono, device_engine=False):
    """The full round-trip oracle on one encoded stream:

    1. parse every packet cleanly (shown-frame count matches)
    2. splice ``grain_params`` into every frame
    3. re-inspect parity: seq flag set, every shown frame carries grain
    4. dav1d accepts the rewritten stream; grain-off decode is
       pixel-lossless vs the original
    5. engine oracle: dav1d's own grain-on decode is bit-exact against
       grain_ref.apply_grain_frame fed the per-frame effective params
       (COPY_REF/show_existing resolved by the render state machine) —
       this is the BASELINE.json north-star check, host-side
    5b. (device_engine=True) the PRODUCTION device engine —
       grain_jax.apply_grain, grain kernels (interpret mode on the
       CPU) with native host patterns — is bit-compared against
       the same dav1d grain-on decode, so the sweep drives the real
       kernels on its random params, not only the host reference
    6. remove round-trip: no grain reported, decode matches original
    """
    from grav1synth.ops import grain_ref
    from grav1synth.pipelines import GrainFrameState

    n = n_shown

    # 1. parse every packet cleanly
    parser = Av1Parser()
    shown = 0
    for p in pkts:
        for o in parser.parse_packet(p.data, p.pts):
            if o.frame is not None and o.frame.show_frame:
                shown += 1
    assert shown == n

    # 2. apply grain
    seg = GrainTableSegment(0, 10**14, grain_params)
    parser = Av1Parser()
    rw = GrainRewriter([seg])
    rewritten = []
    for p in pkts:
        ts = -(-p.pts * 10_000_000 // 30)
        parsed = parser.parse_packet(p.data, ts)
        rewritten.append(
            rw.rewrite_packet(p.data, parsed, ts, parser.sequence_header)
        )

    # 3. re-inspect parity: every shown frame reports grain
    parser = Av1Parser()
    n_update = 0
    for d in rewritten:
        for o in parser.parse_packet(d):
            if o.seq is not None:
                assert o.seq.film_grain_params_present
            if o.frame is not None and o.frame.show_frame:
                assert o.frame.grain.action in (
                    GrainAction.UPDATE,
                    GrainAction.COPY_REF,
                )
                if o.frame.grain.action == GrainAction.UPDATE:
                    n_update += 1
    assert n_update > 0

    # 4. dav1d accepts the rewritten stream; grain-off decode lossless
    def decode(datas, grain):
        dec = Decoder("libdav1d", apply_grain=grain)
        out = list(dec.decode_all([(d, i) for i, d in enumerate(datas)]))
        dec.close()
        return out

    base = decode([p.data for p in pkts], False)
    nograin = decode(rewritten, False)
    withgrain = decode(rewritten, True)
    assert len(base) == len(nograin) == len(withgrain) == n
    for a, b in zip(base, nograin):
        for pa, pb in zip(a.planes, b.planes):
            assert (pa == pb).all()

    # 5. engine oracle: our synthesis == dav1d's, frame by frame
    parser = Av1Parser()
    state = GrainFrameState()
    eff = []
    for i, d in enumerate(rewritten):
        for o in parser.parse_packet(d, i):
            if o.frame is not None and not o.is_redundant_frame_header:
                shown_flag, params = state.frame_params(o.frame)
                if shown_flag:
                    eff.append(params)
    assert len(eff) == n
    for fi, (f_off, f_on, prm) in enumerate(zip(nograin, withgrain, eff)):
        planes_off = [pl.astype(np.int32) for pl in f_off.planes]
        if prm is not None:
            mine = grain_ref.apply_grain_frame(
                planes_off, prm, f_off.bit_depth,
                f_off.subsampling[0], f_off.subsampling[1],
            )
        else:
            mine = planes_off
        for pi, (got, want) in enumerate(zip(mine, f_on.planes)):
            bad = int((got.astype(np.int32) != want.astype(np.int32)).sum())
            assert bad == 0, (
                f"frame {fi} plane {pi}: {bad} px differ from dav1d"
            )

    # 5b. production device engine vs the same dav1d oracle
    if device_engine:
        from grav1synth.ops import grain_jax
        from grav1synth.pipelines import _grain_visible

        todo = [i for i, prm in enumerate(eff) if _grain_visible(prm)]
        if todo:
            bd = nograin[0].bit_depth
            sub = nograin[0].subsampling
            is_mono = len(nograin[0].planes) == 1
            hp = [eff[i] for i in todo]
            pb = grain_jax.pack_params(hp)
            y = np.stack(
                [np.asarray(nograin[i].planes[0]) for i in todo]
            ).astype(np.int16)
            if is_mono:
                yo, cbo, cro = grain_jax.apply_grain(
                    y, None, None, pb, bd, sub[0], sub[1], True,
                    backend="pallas", interpret=True, host_params=hp,
                )
            else:
                cb = np.stack(
                    [np.asarray(nograin[i].planes[1]) for i in todo]
                ).astype(np.int16)
                cr = np.stack(
                    [np.asarray(nograin[i].planes[2]) for i in todo]
                ).astype(np.int16)
                yo, cbo, cro = grain_jax.apply_grain(
                    y, cb, cr, pb, bd, sub[0], sub[1], False,
                    backend="pallas", interpret=True, host_params=hp,
                )
            dev_planes = [np.asarray(yo)]
            if cbo is not None:
                dev_planes += [np.asarray(cbo), np.asarray(cro)]
            for k, i in enumerate(todo):
                for pi in range(len(dev_planes)):
                    got = dev_planes[pi][k].astype(np.int32)
                    want = np.asarray(withgrain[i].planes[pi]).astype(np.int32)
                    bad = int((got != want).sum())
                    assert bad == 0, (
                        f"device engine: frame {i} plane {pi}: "
                        f"{bad} px differ from dav1d"
                    )

    # 6. remove round-trip
    parser = Av1Parser()
    rw = GrainRewriter(None)
    removed = []
    for i, d in enumerate(rewritten):
        parsed = parser.parse_packet(d, i)
        removed.append(rw.rewrite_packet(d, parsed, i, parser.sequence_header))
    parser = Av1Parser()
    for d in removed:
        for o in parser.parse_packet(d):
            if o.seq is not None:
                assert not o.seq.film_grain_params_present
            if o.frame is not None and not o.frame.show_existing_frame:
                # show_existing frames always parse as COPY_REF (spec:
                # grain is loaded from the ref slot), which after remove
                # copies a grainless frame — only coded frames must be
                # DISABLE
                assert o.frame.grain.action == GrainAction.DISABLE
    cleaned = decode(removed, True)
    for a, b in zip(base, cleaned):
        assert (a.planes[0] == b.planes[0]).all()


@pytest.mark.parametrize(
    "name,w,h,bd,mono,n,opts,sub_x,sub_y", CASES, ids=[c[0] for c in CASES]
)
def test_roundtrip_conformance(name, w, h, bd, mono, n, opts, sub_x, sub_y):
    pkts = _encode_case(w, h, bd, mono, n, opts, sub_x, sub_y)
    assert pkts, "encoder produced no packets"
    run_oracle_chain(pkts, _grain_for(mono), n, mono)
