"""dav1d bit-exactness of grain synthesis on 4:2:2 and 4:4:4 content.

The kernels claim sub_x/sub_y in {(1,1),(1,0),(0,0)} support
(grain_ref.py pattern sizing); this proves it against dav1d itself on
real libaom streams (seq profiles 2 and 1), across bit depths and the
chroma parameter variants whose code paths differ under subsampling
(own chroma curves, chroma-scaling-from-luma, overlap blending, odd
dimensions where the chroma edge handling changes).

All three engines are held to the oracle: the host reference, the XLA
formulation, and the production Pallas kernels (interpret mode here;
chip_smoke.py runs them compiled for the GPU).
"""

import numpy as np
import pytest

from av1_builder import sample_grain_params
from grav1synth.container.ffshim import Decoder, Encoder
from grav1synth.obu import Av1Parser, GrainRewriter, GrainTableSegment
from grav1synth.ops import grain_jax, grain_ref


def _encode(w, h, bd, sub_x, sub_y, nframes=2, seed=11):
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.uint16
    cw, ch = -(-w // (1 << sub_x)), -(-h // (1 << sub_y))
    frames = []
    for i in range(nframes):
        y = np.clip(
            np.linspace(0, maxv, w)[None, :]
            + np.linspace(0, maxv * 0.3, h)[:, None]
            + rng.normal(0, maxv * 0.02, (h, w)),
            0,
            maxv,
        ).astype(dt)
        u = np.clip(
            np.linspace(maxv * 0.2, maxv * 0.8, cw)[None, :]
            + rng.normal(0, maxv * 0.01, (ch, cw)),
            0,
            maxv,
        ).astype(dt)
        v = np.full((ch, cw), (maxv + 1) // 2, dt)
        frames.append((y, u, v))
    enc = Encoder(w, h, bd, sub_x=sub_x, sub_y=sub_y)
    pkts = enc.encode_frames(frames)
    enc.close()
    return pkts


def _splice_and_decode(pkts, params):
    seg = GrainTableSegment(0, 10**13, params)
    parser = Av1Parser()
    rw = GrainRewriter([seg])
    new = []
    for p in pkts:
        ts = -(-p.pts * 10_000_000 // 30)
        parsed = parser.parse_packet(p.data, ts)
        new.append(rw.rewrite_packet(p.data, parsed, ts, parser.sequence_header))
    d0 = Decoder("libdav1d", apply_grain=False)
    f0 = list(d0.decode_all([(d, i) for i, d in enumerate(new)]))
    d0.close()
    d1 = Decoder("libdav1d", apply_grain=True)
    f1 = list(d1.decode_all([(d, i) for i, d in enumerate(new)]))
    d1.close()
    pp = Av1Parser()
    eff = []
    for d in new:
        for o in pp.parse_packet(d):
            if o.frame is not None and o.frame.grain.params is not None:
                eff.append(o.frame.grain.params)
    return f0, f1, eff


def _check_all_engines(f0, f1, eff, bd, sub_x, sub_y):
    assert len(f0) == len(f1) == len(eff) >= 1
    for fr in f0:
        assert fr.subsampling == (sub_x, sub_y)
    # host reference
    for frame0, frame1, p in zip(f0, f1, eff):
        mine = grain_ref.apply_grain_frame(
            [pl.astype(np.int32) for pl in frame0.planes], p, bd, sub_x, sub_y
        )
        for pi, (got, want) in enumerate(zip(mine, frame1.planes)):
            bad = int((got.astype(np.int64) != want.astype(np.int64)).sum())
            assert bad == 0, f"ref plane {pi}: {bad} mismatches"
    # device engines, batched over the clip
    import jax.numpy as jnp

    y = jnp.asarray(np.stack([f.planes[0] for f in f0]).astype(np.int32))
    cb = jnp.asarray(np.stack([f.planes[1] for f in f0]).astype(np.int32))
    cr = jnp.asarray(np.stack([f.planes[2] for f in f0]).astype(np.int32))
    pb = grain_jax.pack_params(eff)
    for backend in ("xla", "pallas"):
        out = grain_jax.apply_grain(
            y, cb, cr, pb, bd, sub_x, sub_y, False, backend=backend,
            interpret=backend == "pallas",
        )
        for pi, got in enumerate(out):
            got = np.asarray(got)
            for i, frame1 in enumerate(f1):
                want = frame1.planes[pi].astype(np.int64)
                bad = int((got[i].astype(np.int64) != want).sum())
                assert bad == 0, f"{backend} frame {i} plane {pi}: {bad} mismatches"


SUBSAMPLINGS = [
    pytest.param(1, 0, id="422"),
    pytest.param(0, 0, id="444"),
]


@pytest.mark.parametrize("sub_x,sub_y", SUBSAMPLINGS)
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_full_chroma_params(sub_x, sub_y, bd):
    p = sample_grain_params(seed=909)
    f0, f1, eff = _splice_and_decode(_encode(96, 64, bd, sub_x, sub_y), p)
    _check_all_engines(f0, f1, eff, bd, sub_x, sub_y)


@pytest.mark.parametrize("sub_x,sub_y", SUBSAMPLINGS)
def test_chroma_scaling_from_luma(sub_x, sub_y):
    p = sample_grain_params(seed=404)
    p.chroma_scaling_from_luma = True
    p.scaling_points_cb = []
    p.scaling_points_cr = []
    f0, f1, eff = _splice_and_decode(_encode(64, 64, 10, sub_x, sub_y), p)
    _check_all_engines(f0, f1, eff, 10, sub_x, sub_y)


@pytest.mark.parametrize("sub_x,sub_y", SUBSAMPLINGS)
def test_odd_dimensions_overlap(sub_x, sub_y):
    """Odd frame sizes hit the chroma edge-duplication paths, multiple
    stripes hit vertical overlap rows."""
    p = sample_grain_params(seed=77)
    p.overlap_flag = True
    p.clip_to_restricted_range = True
    f0, f1, eff = _splice_and_decode(_encode(107, 75, 8, sub_x, sub_y), p)
    _check_all_engines(f0, f1, eff, 8, sub_x, sub_y)
