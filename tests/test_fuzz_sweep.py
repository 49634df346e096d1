"""Seeded randomized conformance sweep.

Stands in for the reference's dav1d-test-data corpus oracle (740
inspect / 739 apply / 739 remove conformance cases,
grav1synth tests/sanity_tests.rs:768,1548,2354 — the submodule is
empty in this environment): instead of a fixed corpus, every case is
GENERATED from a seed — random encoder options (GOP structure, tiles,
superblock size, error resilience, order-hint off, screen tuning,
still-picture), random geometry (odd and tiny sizes), every bit depth
and subsampling, and random-but-valid film-grain parameters (lag 0-3,
point counts 0..max, chroma-scaling-from-luma, mult/offset extremes,
all shift ranges) — then run through the exact oracle chain the
curated matrix uses (test_conformance.run_oracle_chain):

  parse every packet -> splice grain -> re-inspect parity -> dav1d
  accepts the rewritten stream -> grain-off decode is pixel-lossless
  -> remove -> re-inspect reports no grain -> decode matches original.

Failures reproduce from the case seed alone (`GRAV1_SWEEP_SEED=<n>`
runs exactly one case). The per-run budget is bounded: the default 12
cases take ~1 minute; `GRAV1_SWEEP_N=120` runs the full sweep
(~10 min) — scripts/fuzz_sweep.py does that and writes a report.
"""

import os

import numpy as np
import pytest

from grav1synth.obu.types import FilmGrainParams
from test_conformance import _encode_case, run_oracle_chain

SWEEP_N = int(os.environ.get("GRAV1_SWEEP_N", "12"))
SEED_BASE = 0xA70000  # fixed schedule: case i uses SEED_BASE + i
_ONLY = os.environ.get("GRAV1_SWEEP_SEED")

# encoder option pools (libaom); combined independently per case
_OPT_POOL = [
    "",
    "tiles=2x2",
    "tiles=4x1",
    "aom-params=sb-size=64",
    "error-resilience=1:usage=good:cpu-used=6",
    "aom-params=enable-order-hint=0",
    "usage=good:cpu-used=6:lag-in-frames=8:auto-alt-ref=1",
    "tune=psnr:aom-params=enable-intrabc=1",
    "usage=good:cpu-used=8:crf=50",
    # (superres is not exposed by this libaom build's aom-params;
    # synthetic superres streams cover that header path in
    # test_obu_branches)
    "aom-params=enable-cdef=0:enable-restoration=1",
    "usage=realtime:cpu-used=8",
]


def random_grain(
    rng: np.random.Generator,
    need_visible: bool = True,
    sub_x: int = 1,
    sub_y: int = 1,
):
    """Random spec-valid film grain parameters.

    Conformance constraint honored (spec 5.9.30, enforced by dav1d —
    the sweep's seed 0xa70000 found this the hard way): for 4:2:0
    streams num_cb_points and num_cr_points must be both zero or both
    nonzero."""

    def points(max_n, lo=0):
        n = int(rng.integers(lo, max_n + 1))
        if n == 0:
            return []
        xs = np.sort(rng.choice(256, size=n, replace=False))
        ys = rng.integers(0, 256, size=n)
        return [(int(x), int(y)) for x, y in zip(xs, ys)]

    lag = int(rng.integers(0, 4))
    n_luma = 2 * lag * (lag + 1)
    csfl = bool(rng.integers(0, 2))
    num_y_min = 1 if need_visible else 0
    pts_y = points(14, num_y_min)
    pts_cb = [] if csfl else points(10)
    pts_cr = [] if csfl else points(10)
    if need_visible and not (pts_y or pts_cb or pts_cr or csfl):
        pts_y = points(14, 1)
    if sub_x == 1 and sub_y == 1 and bool(pts_cb) != bool(pts_cr):
        if rng.integers(0, 2):
            pts_cb, pts_cr = [], []
        else:
            empty = points(10, 1)
            pts_cb = pts_cb or empty
            pts_cr = pts_cr or empty
    n_chroma = n_luma + (1 if pts_y else 0)

    def coeffs(n):
        return [int(c) for c in rng.integers(-128, 128, size=n)]

    has_cb = bool(pts_cb) or csfl
    has_cr = bool(pts_cr) or csfl
    return FilmGrainParams(
        grain_seed=int(rng.integers(0, 1 << 16)),
        scaling_points_y=pts_y,
        scaling_points_cb=pts_cb,
        scaling_points_cr=pts_cr,
        scaling_shift=int(rng.integers(8, 12)),
        ar_coeff_lag=lag,
        ar_coeffs_y=coeffs(n_luma) if pts_y else [],
        ar_coeffs_cb=coeffs(n_chroma) if has_cb else [],
        ar_coeffs_cr=coeffs(n_chroma) if has_cr else [],
        ar_coeff_shift=int(rng.integers(6, 10)),
        cb_mult=int(rng.integers(0, 256)),
        cb_luma_mult=int(rng.integers(0, 256)),
        cb_offset=int(rng.choice([0, 1, 255, 256, 510, 511])),
        cr_mult=int(rng.choice([0, 1, 128, 254, 255])),
        cr_luma_mult=int(rng.integers(0, 256)),
        cr_offset=int(rng.integers(0, 512)),
        chroma_scaling_from_luma=csfl,
        grain_scale_shift=int(rng.integers(0, 4)),
        overlap_flag=bool(rng.integers(0, 2)),
        clip_to_restricted_range=bool(rng.integers(0, 2)),
    )


def gen_case(seed: int):
    """Seed -> (encoder kwargs, grain params). Deterministic."""
    rng = np.random.default_rng(seed)
    bd = int(rng.choice([8, 8, 10, 10, 12]))
    sub = rng.choice([0, 1, 2, 3], p=[0.55, 0.15, 0.15, 0.15])
    mono = sub == 3
    sub_x, sub_y = [(1, 1), (1, 0), (0, 0), (1, 1)][sub]
    # odd/tiny geometries on purpose; chroma-odd included
    w = int(rng.integers(18, 260))
    h = int(rng.integers(18, 200))
    opts = str(rng.choice(_OPT_POOL))
    # libaom rejects tile splits the geometry cannot hold (64px-sb
    # granularity per tile column/row)
    if opts == "tiles=4x1" and w < 256:
        opts = ""
    if opts == "tiles=2x2" and (w < 128 or h < 128):
        opts = ""
    still = rng.integers(0, 12) == 0 and not opts
    if still:
        opts = "still-picture=1"
        n = 1
    else:
        n = int(rng.integers(2, 9))
    grain = random_grain(rng, sub_x=sub_x, sub_y=sub_y)
    if mono:
        grain.scaling_points_cb = []
        grain.scaling_points_cr = []
        grain.ar_coeffs_cb = []
        grain.ar_coeffs_cr = []
        grain.chroma_scaling_from_luma = False
        if not grain.scaling_points_y:
            grain.scaling_points_y = [(0, 40), (255, 40)]
    return dict(w=w, h=h, bd=bd, mono=mono, n=n, opts=opts,
                sub_x=sub_x, sub_y=sub_y), grain


_SEEDS = (
    [int(_ONLY)] if _ONLY else [SEED_BASE + i for i in range(SWEEP_N)]
)


def run_framing_arms(pkts, grain, tmp_path):
    """Annex B / Section 5 framing arms on a sweep case: the same
    table applied through the raw elementary-stream paths must (a)
    produce byte-identical rewritten temporal units to the IVF route
    (Section 5), (b) re-inspect as grainy and remove cleanly (Annex
    B), and (c) round-trip a grainless remove byte-identically."""
    from test_annexb import _strip_size_fields

    from grav1synth import pipelines
    from grav1synth.container import annexb
    from grav1synth.container.ivf import IvfHeader, IvfPacket, write_ivf
    from grav1synth.obu import GrainTableSegment
    from grav1synth.tables import dump_table

    datas = [p.data for p in pkts]
    tbl = str(tmp_path / "t.tbl")
    dump_table([GrainTableSegment(0, 10**14, grain)], tbl)

    ivf_in = str(tmp_path / "in.ivf")
    write_ivf(
        ivf_in,
        IvfHeader(width=64, height=64, frame_count=len(datas)),
        [IvfPacket(i, d) for i, d in enumerate(datas)],
    )
    s5_in = str(tmp_path / "in.obu")
    with open(s5_in, "wb") as fh:
        fh.write(b"".join(datas))
    ab_in = str(tmp_path / "in.annexb.obu")
    tus = [annexb.TemporalUnit([obus]) for obus in _strip_size_fields(datas)]
    with open(ab_in, "wb") as fh:
        fh.write(annexb.serialize_annexb(tus))

    # (a) Section 5 rewrite == IVF rewrite, byte for byte
    ivf_out = str(tmp_path / "out.ivf")
    s5_out = str(tmp_path / "out.obu")
    pipelines.apply_table(ivf_in, ivf_out, tbl, progress=False)
    pipelines.apply_table(s5_in, s5_out, tbl, progress=False)
    from grav1synth.container.ivf import read_ivf

    _, out_pkts = read_ivf(ivf_out)
    raw_tus = annexb.split_section5_tus(open(s5_out, "rb").read())
    assert [p.data for p in out_pkts] == raw_tus, "section5 != ivf rewrite"

    # (b) Annex B apply -> inspect -> remove -> inspect
    ab_out = str(tmp_path / "out.annexb.obu")
    pipelines.apply_table(ab_in, ab_out, tbl, progress=False)
    segs = pipelines.inspect(ab_out, str(tmp_path / "g.tbl"), progress=False)
    assert segs, "annexb apply: re-inspect must report grain"
    ab_clean = str(tmp_path / "clean.annexb.obu")
    pipelines.remove(ab_out, ab_clean, progress=False)
    assert (
        pipelines.inspect(ab_clean, str(tmp_path / "c.tbl"), progress=False)
        is None
    )

    # (c) grainless remove reproduces the input exactly
    noop = str(tmp_path / "noop.obu")
    pipelines.remove(ab_in, noop, progress=False)
    assert open(noop, "rb").read() == open(ab_in, "rb").read()


@pytest.mark.parametrize("seed", _SEEDS, ids=[f"seed{s:#x}" for s in _SEEDS])
def test_fuzz_roundtrip(seed, tmp_path):
    cfg, grain = gen_case(seed)
    pkts = _encode_case(
        cfg["w"], cfg["h"], cfg["bd"], cfg["mono"], cfg["n"], cfg["opts"],
        cfg["sub_x"], cfg["sub_y"],
    )
    assert pkts, f"encoder produced no packets for {cfg}"
    # every 4th case drives the PRODUCTION Pallas kernels (interpret
    # mode) against the dav1d oracle; every 3rd runs the Annex B /
    # Section 5 framing arms — both deterministic functions of the
    # seed so any failure reproduces from GRAV1_SWEEP_SEED alone
    run_oracle_chain(
        pkts, grain, cfg["n"], cfg["mono"],
        device_engine=(seed % 4 == 0),
    )
    if seed % 3 == 1:
        run_framing_arms(pkts, grain, tmp_path)
