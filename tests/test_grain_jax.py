"""JAX device grain synthesis vs the dav1d-validated numpy reference.

Runs on the virtual CPU mesh; the same jitted functions run unmodified
on the GPU (chip_smoke.py exercises the card).
"""

import copy

import numpy as np
import pytest

from av1_builder import sample_grain_params
from grav1synth.ops import grain_jax, grain_ref


def _rand_frames(b, h, w, bit_depth, seed=5):
    rng = np.random.default_rng(seed)
    maxv = (1 << bit_depth) - 1
    y = rng.integers(0, maxv + 1, (b, h, w)).astype(np.int32)
    cb = rng.integers(0, maxv + 1, (b, h // 2, w // 2)).astype(np.int32)
    cr = rng.integers(0, maxv + 1, (b, h // 2, w // 2)).astype(np.int32)
    return y, cb, cr


def assert_matches_reference(params_list, bit_depth=8, h=64, w=64):
    y, cb, cr = _rand_frames(len(params_list), h, w, bit_depth)
    pb = grain_jax.pack_params(params_list)
    yj, cbj, crj = grain_jax.apply_grain_batch(y, cb, cr, pb, bit_depth, 1, 1, False)
    yj, cbj, crj = np.asarray(yj), np.asarray(cbj), np.asarray(crj)
    for i, p in enumerate(params_list):
        ref = grain_ref.apply_grain_frame([y[i], cb[i], cr[i]], p, bit_depth, 1, 1)
        for pi, (got, want) in enumerate(zip((yj[i], cbj[i], crj[i]), ref)):
            bad = int((got.astype(np.int64) != want.astype(np.int64)).sum())
            assert bad == 0, f"frame {i} plane {pi}: {bad} mismatches"


def test_single_frame():
    assert_matches_reference([sample_grain_params(seed=777)])


def test_device_patterns_path_matches_reference():
    """apply_grain_batch (patterns generated fully on device by the
    GF(2)-LFSR + wavefront-AR path, then the grain kernels, all in one
    jit) must be bit-exact vs the dav1d-validated host reference; the
    kernels run in interpret mode here."""
    params = [sample_grain_params(seed=s) for s in (777, 991)]
    y, cb, cr = _rand_frames(2, 64, 64, 10)
    pb = grain_jax.pack_params(params)
    yo, cbo, cro = grain_jax.apply_grain_batch(
        y, cb, cr, pb, 10, 1, 1, False, backend="pallas", interpret=True,
    )
    yo, cbo, cro = np.asarray(yo), np.asarray(cbo), np.asarray(cro)
    for i, p in enumerate(params):
        ref = grain_ref.apply_grain_frame([y[i], cb[i], cr[i]], p, 10, 1, 1)
        for pi, (got, want) in enumerate(zip((yo[i], cbo[i], cro[i]), ref)):
            bad = int((got.astype(np.int64) != want.astype(np.int64)).sum())
            assert bad == 0, f"frame {i} plane {pi}: {bad} mismatches"


def test_prepared_patterns_pack_roundtrip():
    """prepare_patterns packs all three planes into one int16 buffer;
    the unpack properties must reproduce the native generator's output
    exactly, and apply_grain(prepared=...) must equal the host_params
    path bit for bit."""
    from grav1synth.ops.grain_native import generate_patterns_native

    params = [sample_grain_params(seed=s) for s in (777, 991)]
    prep = grain_jax.prepare_patterns(params, 8, 1, 1, False)
    lp, cbp, crp = generate_patterns_native(params, 8, 1, 1, False)
    assert (np.asarray(prep.luma) == lp).all()
    assert (np.asarray(prep.cb) == cbp).all()
    assert (np.asarray(prep.cr) == crp).all()
    assert prep.packed.dtype == np.int16
    assert prep.chroma_static

    y, cb, cr = _rand_frames(2, 64, 64, 8)
    pb = grain_jax.pack_params(params)
    a = grain_jax.apply_grain(
        y, cb, cr, pb, 8, 1, 1, False, backend="pallas", interpret=True,
        host_params=params,
    )
    b = grain_jax.apply_grain(
        y, cb, cr, pb, 8, 1, 1, False, backend="pallas", interpret=True,
        prepared=prep,
    )
    for pa, pb_ in zip(a, b):
        assert (np.asarray(pa) == np.asarray(pb_)).all()


def test_mixed_batch_parameters():
    p0 = sample_grain_params(seed=777)
    p1 = copy.deepcopy(p0)
    p1.grain_seed = 4242
    p2 = copy.deepcopy(p0)
    p2.overlap_flag = False
    p2.grain_seed = 999
    p3 = copy.deepcopy(p0)
    p3.ar_coeff_lag = 0
    p3.ar_coeffs_y = []
    p3.ar_coeffs_cb = [0]
    p3.ar_coeffs_cr = [0]
    p4 = copy.deepcopy(p0)
    p4.chroma_scaling_from_luma = True
    p4.scaling_points_cb = []
    p4.scaling_points_cr = []
    p5 = copy.deepcopy(p0)
    p5.clip_to_restricted_range = True
    assert_matches_reference([p0, p1, p2, p3, p4, p5])


def test_10bit():
    p = sample_grain_params(seed=777)
    pc = copy.deepcopy(p)
    pc.clip_to_restricted_range = True
    assert_matches_reference([p, pc], bit_depth=10)


def test_odd_geometry():
    assert_matches_reference([sample_grain_params(seed=777)], h=70, w=100)


def test_multi_stripe():
    assert_matches_reference([sample_grain_params(seed=777)], h=128, w=160)


def test_lfsr_outputs_match_reference():
    seeds = np.asarray([0, 1, 0xFFFF, 5000, 10063], dtype=np.int32)
    n = 200
    got = np.asarray(grain_jax.lfsr_outputs(seeds, n, 11))
    for i, s in enumerate(seeds):
        lf = grain_ref.Lfsr(int(s))
        want = [lf.bits(11) for _ in range(n)]
        assert got[i].tolist() == want


def test_monochrome():
    p = sample_grain_params(seed=31)
    p.scaling_points_cb = []
    p.scaling_points_cr = []
    p.ar_coeffs_cb = []
    p.ar_coeffs_cr = []
    y, _, _ = _rand_frames(2, 64, 64, 8)
    import jax.numpy as jnp

    pb = grain_jax.pack_params([p, p])
    yj, cbj, crj = grain_jax.apply_grain_batch(
        y, None, None, pb, 8, 1, 1, True
    )
    assert cbj is None and crj is None
    for i in range(2):
        ref = grain_ref.apply_grain_frame([y[i]], p, 8, 1, 1)
        assert (np.asarray(yj[i]).astype(np.int64) == ref[0].astype(np.int64)).all()


def test_select_backend_by_platform():
    assert grain_jax.select_backend("gpu") == "pallas"
    assert grain_jax.select_backend("cpu") == "xla"
    assert grain_jax.select_backend() == "xla"  # the CPU test mesh


def test_backend_choice_never_interprets(monkeypatch):
    """A backend picked by select_backend runs the kernels compiled:
    interpret mode only when the caller asks for it."""
    from grav1synth.ops import grain_pallas

    seen = []

    def luma(y, *a, interpret=False, **k):
        seen.append(interpret)
        return y

    def chroma(y, cb, cr, *a, interpret=False, **k):
        seen.append(interpret)
        return cb, cr

    grain_jax.apply_grain_batch.clear_cache()  # trace anew with the stubs
    monkeypatch.setattr(grain_jax, "select_backend", lambda platform=None: "pallas")
    monkeypatch.setattr(grain_pallas, "apply_luma", luma)
    monkeypatch.setattr(grain_pallas, "apply_chroma", chroma)
    params = [sample_grain_params(seed=5)]
    y, cb, cr = _rand_frames(1, 32, 32, 8)
    grain_jax.apply_grain(y, cb, cr, grain_jax.pack_params(params), 8)
    assert seen == [False, False]
    seen.clear()
    grain_jax.apply_grain(
        y, cb, cr, grain_jax.pack_params(params), 8, interpret=True
    )
    assert seen == [True, True]


def test_unknown_backend_rejected():
    params = [sample_grain_params(seed=5)]
    y, cb, cr = _rand_frames(1, 32, 32, 8)
    with pytest.raises(ValueError):
        grain_jax.apply_grain(
            y, cb, cr, grain_jax.pack_params(params), 8, backend="numpy"
        )
