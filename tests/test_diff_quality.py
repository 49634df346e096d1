"""Quantitative diff-estimation quality bar on film-like content.

The reference delegates diff estimation to av1-grain's DiffGenerator
(main.rs:420-427), which we re-implemented first-party; this harness
closes the loop without that crate: inject KNOWN grain into realistic
(structured, moving) video with our dav1d-bit-exact synthesis engine,
hand the estimator the pre-grain original as the "denoised" input, and
score the recovered table against the injected one:

- scaling-curve error: the sigma-vs-intensity function each table
  encodes (LUT x pattern-sigma / 2^shift) must match within a relative
  bound over the populated intensity range;
- AR character: normalized autocorrelation of the recovered grain
  pattern vs the injected one at the spec's lag window;
- re-synthesized noise: applying the recovered table reproduces the
  injected noise energy frame-wide.

Plus the sharded statistics path: psum'd per-shard sums must equal the
serial reduction exactly and feed finish() to the same table.
"""

import numpy as np
import pytest

from grav1synth.obu.types import FilmGrainParams
from grav1synth.ops import diff_estimate, grain_ref
from grav1synth.ops.diff_estimate import DiffEstimator, sharded_diff_stats


def film_params() -> FilmGrainParams:
    """A film-like table: lag-2 AR, mid-heavy luma curve, mild chroma."""
    return FilmGrainParams(
        grain_seed=4242,
        scaling_points_y=[(0, 28), (96, 52), (176, 60), (255, 24)],
        scaling_points_cb=[(0, 16), (128, 24), (255, 12)],
        scaling_points_cr=[(0, 12), (128, 20), (255, 10)],
        scaling_shift=8,
        ar_coeff_lag=2,
        ar_coeffs_y=[4, -2, 8, 2, -10, 6, 3, -2, 12, 1, -5, 38],
        ar_coeffs_cb=[2, -1, 4, 1, -5, 3, 2, -1, 6, 0, -2, 20, 8],
        ar_coeffs_cr=[2, -1, 4, 1, -5, 3, 2, -1, 6, 0, -2, 18, 10],
        ar_coeff_shift=7,
        cb_mult=192, cb_luma_mult=128, cb_offset=256,
        cr_mult=192, cr_luma_mult=128, cr_offset=256,
        overlap_flag=True,
    )


def film_like_clip(n=24, h=192, w=256, seed=3):
    """Structured, moving content: gradients, a panning bright disc,
    per-frame exposure wobble — smooth regions plus real texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 50 + 120 * (xx / w) + 30 * (yy / h)
    texture = 8 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
    frames = []
    for i in range(n):
        cx, cy = w * (0.2 + 0.02 * i), h * 0.5
        disc = 70 * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 28.0**2)))
        y = np.clip(base + texture + disc + rng.normal(0, 0.3), 16, 235)
        u = np.clip(110 + 30 * (xx[::2, ::2] / w), 16, 240)
        v = np.clip(130 - 20 * (yy[::2, ::2] / h), 16, 240)
        frames.append(
            (
                y.astype(np.int32),
                u.astype(np.int32),
                v.astype(np.int32),
            )
        )
    return frames


def inject_grain(frames, params):
    """Per-frame grain via the dav1d-validated host engine, with the
    per-frame seed decorrelation the splice path uses."""
    import dataclasses

    out = []
    for i, planes in enumerate(frames):
        p = dataclasses.replace(
            params, grain_seed=(params.grain_seed + i * 173) & 0xFFFF
        )
        out.append(grain_ref.apply_grain_frame(list(planes), p, 8, 1, 1))
    return out


def sigma_curve(params, xs):
    """sigma(intensity) in 8-bit units that a table synthesizes."""
    pat = grain_ref.generate_grain(params, 8, False, 1, 1)
    sg = float(pat.luma[3:, 3:-3].astype(np.float64).std())
    lut = grain_ref.build_scaling_lut(params.scaling_points_y, 8)
    return np.array(
        [lut[x] * sg / (1 << params.scaling_shift) for x in xs]
    )


@pytest.fixture(scope="module")
def recovered():
    params = film_params()
    clean = film_like_clip()
    grainy = inject_grain(clean, params)
    est = DiffEstimator((24, 1), chunk_frames=1000)
    for c, g in zip(clean, grainy):
        est.diff_frame(list(g), list(c))
    segs = est.finish()
    assert len(segs) == 1, "stationary grain must fit one segment"
    return params, segs[0].params


class TestQuality:
    def test_scaling_curve_error(self, recovered):
        injected, got = recovered
        xs = np.arange(40, 236)  # intensity range the content populates
        want = sigma_curve(injected, xs)
        have = sigma_curve(got, xs)
        rel = np.abs(have - want) / np.maximum(want, 1e-6)
        assert float(np.median(rel)) < 0.10, float(np.median(rel))
        assert float(rel.mean()) < 0.15, float(rel.mean())

    def test_ar_character(self, recovered):
        """Grain texture match: normalized autocorrelation of the
        recovered pattern tracks the injected one at short lags."""
        injected, got = recovered

        def autocorr(params):
            pat = grain_ref.generate_grain(params, 8, False, 1, 1).luma[
                3:, 3:-3
            ].astype(np.float64)
            pat = pat - pat.mean()
            var = (pat * pat).mean()
            out = []
            h, w = pat.shape
            for dr, dc in ((0, 1), (1, 0), (1, 1), (0, 2), (2, 0), (1, -1)):
                a = pat[max(dr, 0) : h + min(dr, 0), max(dc, 0) : w + min(dc, 0)]
                b = pat[max(-dr, 0) : h + min(-dr, 0), max(-dc, 0) : w + min(-dc, 0)]
                out.append(float((a * b).mean() / var))
            return np.array(out)

        want = autocorr(injected)
        have = autocorr(got)
        assert np.abs(want - have).max() < 0.12, (want, have)

    def test_resynthesized_energy(self, recovered):
        """Applying the recovered table to the clean clip reproduces the
        injected per-frame noise energy."""
        injected, got = recovered
        clean = film_like_clip(n=4, seed=9)
        e_inj = e_got = 0.0
        for planes in clean:
            a = grain_ref.apply_grain_frame(list(planes), injected, 8, 1, 1)
            b = grain_ref.apply_grain_frame(list(planes), got, 8, 1, 1)
            e_inj += float(((a[0] - planes[0]) ** 2).mean())
            e_got += float(((b[0] - planes[0]) ** 2).mean())
        assert e_got == pytest.approx(e_inj, rel=0.25), (e_inj, e_got)

    def test_chroma_recovered(self, recovered):
        injected, got = recovered
        assert got.scaling_points_cb, "chroma grain missed"
        assert got.scaling_points_cr, "chroma grain missed"


class TestShardedDiff:
    def test_sharded_stats_equal_serial(self):
        import jax

        from grav1synth.parallel import make_mesh

        params = film_params()
        clean = film_like_clip(n=8)
        grainy = inject_grain(clean, params)
        src = [np.stack([g[i] for g in grainy]) for i in range(3)]
        den = [np.stack([c[i] for c in clean]).astype(np.int32) for i in range(3)]
        mesh = make_mesh()
        y_sh, cb_sh, cr_sh = sharded_diff_stats(mesh, src, den, 2, 8)
        # serial reference: per-frame stats summed on host
        import jax.numpy as jnp

        y_ref = None
        for i in range(8):
            s = diff_estimate.frame_pair_stats(
                jnp.asarray(src[0][i]), jnp.asarray(den[0][i]), 2, 8
            )
            if y_ref is None:
                y_ref = {k: np.asarray(v, np.float64) for k, v in s.items()}
            else:
                for k, v in s.items():
                    y_ref[k] += np.asarray(v, np.float64)
        for k in y_ref:
            np.testing.assert_allclose(
                np.asarray(y_sh[k], np.float64), y_ref[k], rtol=1e-5, atol=1e-2
            )

    def test_sharded_diff_table_matches_streaming(self):
        from grav1synth.parallel import make_mesh

        params = film_params()
        clean = film_like_clip(n=8)
        grainy = inject_grain(clean, params)
        # streaming estimator (single chunk)
        est1 = DiffEstimator((24, 1), chunk_frames=1000)
        for c, g in zip(clean, grainy):
            est1.diff_frame(list(g), list(c))
        t1 = est1.finish()
        # sharded reduction feeding add_stats
        src = [np.stack([g[i] for g in grainy]) for i in range(3)]
        den = [np.stack([c[i] for c in clean]).astype(np.int32) for i in range(3)]
        mesh = make_mesh()
        y, cb, cr = sharded_diff_stats(mesh, src, den, 2, 8)
        est2 = DiffEstimator((24, 1), chunk_frames=1000)
        est2.add_stats(
            {k: np.asarray(v) for k, v in y.items()},
            {k: np.asarray(v) for k, v in cb.items()},
            {k: np.asarray(v) for k, v in cr.items()},
            frames=8,
        )
        t2 = est2.finish()
        assert len(t1) == len(t2) == 1
        assert t1[0].params.equal_ignoring_seed(t2[0].params)


class TestBatchedDiff:
    """The production diff path: batch_pair_stats_per_frame feeding
    DiffEstimator.diff_batch must reproduce the streaming estimator's
    tables exactly — including scene-cut chunking — at any batch size
    and shard count (pipelines.diff contract)."""

    def _tables(self, grainy, clean, feed):
        est = DiffEstimator(
            (24, 1), chunk_frames=9, min_chunk_frames=4, sigma_jump=0.25
        )
        feed(est, grainy, clean)
        return est.finish()

    def _clip_with_scene_change(self):
        params = film_params()
        clean = film_like_clip(n=20)
        grainy = inject_grain(clean, params)
        # second half: much stronger grain (a grade change) so the
        # scene-cut logic actually fires mid-stream
        import dataclasses

        strong = dataclasses.replace(
            params,
            scaling_points_y=[(0, 90), (128, 110), (255, 80)],
        )
        grainy[10:] = inject_grain(clean[10:], strong)
        return grainy, clean

    def test_batch_matches_streaming(self):
        grainy, clean = self._clip_with_scene_change()

        def stream(est, g, c):
            for gf, cf in zip(g, c):
                est.diff_frame(list(gf), list(cf))

        def batched(est, g, c):
            for i in range(0, len(g), 6):
                est.diff_batch(
                    [list(f) for f in g[i : i + 6]],
                    [list(f) for f in c[i : i + 6]],
                )

        t1 = self._tables(grainy, clean, stream)
        t2 = self._tables(grainy, clean, batched)
        assert len(t1) == len(t2) >= 2  # chunking + scene cut happened
        for a, b in zip(t1, t2):
            assert (a.start_time, a.end_time) == (b.start_time, b.end_time)
            assert a.params.equal_ignoring_seed(b.params)

    def test_mesh_batch_matches_streaming(self):
        from grav1synth.parallel import make_mesh

        grainy, clean = self._clip_with_scene_change()

        def stream(est, g, c):
            for gf, cf in zip(g, c):
                est.diff_frame(list(gf), list(cf))

        mesh = make_mesh()

        def meshed(est, g, c):
            # batch of 7 on an 8-device mesh: exercises padding too
            for i in range(0, len(g), 7):
                est.diff_batch(
                    [list(f) for f in g[i : i + 7]],
                    [list(f) for f in c[i : i + 7]],
                    mesh=mesh,
                )

        t1 = self._tables(grainy, clean, stream)
        t2 = self._tables(grainy, clean, meshed)
        assert len(t1) == len(t2)
        for a, b in zip(t1, t2):
            assert (a.start_time, a.end_time) == (b.start_time, b.end_time)
            assert a.params.equal_ignoring_seed(b.params)

    def test_batch_mono_and_mixed_depth(self):
        """Luma-only pairs and 10-bit denoised vs 8-bit source both go
        through the batched path (the reference's four monomorphized
        depth arms, main.rs:434-518)."""
        params = film_params()
        clean = film_like_clip(n=8)
        grainy = inject_grain(clean, params)
        est1 = DiffEstimator((24, 1), denoised_bit_depth=10, chunk_frames=1000)
        est2 = DiffEstimator((24, 1), denoised_bit_depth=10, chunk_frames=1000)
        g = [[f[0]] for f in grainy]
        c10 = [[f[0].astype(np.int32) << 2] for f in clean]
        for gf, cf in zip(g, c10):
            est1.diff_frame(gf, cf)
        est2.diff_batch(g, c10)
        t1, t2 = est1.finish(), est2.finish()
        assert len(t1) == len(t2) == 1
        assert t1[0].params.equal_ignoring_seed(t2[0].params)
        assert not t1[0].params.scaling_points_cb  # mono: no chroma fit


class TestPallasStats:
    def test_pallas_matches_xla(self):
        """The device statistics reduction (batch_pair_stats_per_frame)
        must reproduce a float64 numpy computation of the same Gram
        matrix and binned moments, luma and chroma, within float32
        reassociation tolerance."""
        import jax.numpy as jnp

        from grav1synth.ops import diff_ref
        from grav1synth.ops.diff_estimate import (
            _flat_mask,
            batch_pair_stats_per_frame,
        )

        rng = np.random.default_rng(1)
        b, h, w = 2, 150, 260  # not multiples of the flat-mask block
        s = rng.integers(0, 1023, (b, h, w), dtype=np.int32)
        d = rng.integers(0, 1023, (b, h, w), dtype=np.int32)
        sc = rng.integers(0, 1023, (b, h // 2, w // 2), dtype=np.int32)
        dc = rng.integers(0, 1023, (b, h // 2, w // 2), dtype=np.int32)
        out = batch_pair_stats_per_frame(
            *(jnp.asarray(a) for a in (s, d, sc, dc, sc, dc)),
            lag=2, bit_depth=10, sub_x=1, sub_y=1, has_chroma=True,
        )
        for i in range(b):
            aux = diff_ref.chroma_aux(s[i], d[i], h // 2, w // 2, 1, 1)
            want = [
                diff_ref.plane_stats(
                    s[i], d[i], np.asarray(_flat_mask(jnp.asarray(d[i]))), 2, 10
                ),
            ] + [
                diff_ref.plane_stats(
                    sc[i], dc[i], np.asarray(_flat_mask(jnp.asarray(dc[i]))),
                    2, 10, aux=aux,
                )
            ] * 2
            for got, ref in zip(out, want):
                frame = {k: np.asarray(v)[i] for k, v in got.items()}
                assert diff_ref.max_rel_err(frame, ref) < 1e-5
