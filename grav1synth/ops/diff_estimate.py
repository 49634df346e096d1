"""Grain-table estimation from a grainy/denoised frame-pair stream.

Replaces the av1-grain crate's DiffGenerator (reference grav1synth
src/main.rs:347-533 diff pipeline): the per-frame noise residual is
reduced on device to (a) lag-window autocovariance moments for the AR
coefficient fit and (b) intensity-binned residual second moments for
the scaling LUT, restricted to flat blocks so denoiser signal leakage
does not bias the fit. Chroma planes get the same treatment with one
extra design column — the collocated subsample-averaged luma residual
— fitting the spec's cross-plane AR coefficient; their scaling input
is linearized to plane intensity via (mult, luma_mult, offset) =
(192, 128, 256). Chunks of frames become grain-table segments;
adjacent chunks with near-identical models merge.

All per-pixel work is one jitted reduction per frame pair; the tiny
normal-equation solve and curve fitting run on host at finish(). The
statistics are plain sums, so multi-shard runs psum/gather them and
finish() once (SURVEY §5 distributed mapping).

Every float product here is held to float32 (``precision=HIGHEST``):
a GPU would otherwise run it in TF32, whose 10-bit mantissa the
tables' rtol 1e-5 agreement cannot absorb.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..obu.types import FilmGrainParams, GrainTableSegment
from ..tables.aggregate import packet_bounds
from . import grain_ref

NUM_BINS = 64
FLAT_BLOCK = 16


def _lag_offsets(lag: int) -> List[Tuple[int, int]]:
    out = []
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            out.append((dr, dc))
    return out


def _flat_mask(den: jnp.ndarray) -> jnp.ndarray:
    """(H, W) 0/1 mask of low-activity blocks of the denoised signal
    (denoiser leakage in textured areas would bias the noise model)."""
    return _flat_mask_batch(den[None])[0]


def _flat_blocks_batch(den: jnp.ndarray) -> jnp.ndarray:
    """(B, H, W) -> (B, H//FB, W//FB) flat-BLOCK map (1 = flat).

    The pixel-level mask is blocks[i//FB, j//FB], zero past the last
    full block. Block means via ``reduce_window``; scatter-free."""
    b, h, w = den.shape
    denf = den.astype(jnp.float32)
    gx = jnp.abs(jnp.diff(denf, axis=2))
    gy = jnp.abs(jnp.diff(denf, axis=1))
    # act[i, j] = gx[i, j] (j<w-1) + gy[i, j] (i<h-1), zero-pad edges
    act = jnp.pad(gx, ((0, 0), (0, 0), (0, 1))) + jnp.pad(
        gy, ((0, 0), (0, 1), (0, 0))
    )
    hb, wb = h // FLAT_BLOCK, w // FLAT_BLOCK
    act_b = jax.lax.reduce_window(
        act[:, : hb * FLAT_BLOCK, : wb * FLAT_BLOCK],
        0.0,
        jax.lax.add,
        (1, FLAT_BLOCK, FLAT_BLOCK),
        (1, FLAT_BLOCK, FLAT_BLOCK),
        "valid",
    ) / (FLAT_BLOCK * FLAT_BLOCK)
    thresh = (
        jnp.percentile(act_b.reshape(b, -1), 50.0, axis=1)[:, None, None]
        * 1.5
        + 1e-3
    )
    return (act_b < thresh).astype(jnp.float32)


def _flat_mask_batch(den: jnp.ndarray) -> jnp.ndarray:
    """(B, H, W) -> (B, H, W) full-resolution flat mask: the block map
    repeated over each block's pixels, zero past the last full block."""
    b, h, w = den.shape
    hb, wb = h // FLAT_BLOCK, w // FLAT_BLOCK
    flat_b = _flat_blocks_batch(den)
    full = jnp.repeat(jnp.repeat(flat_b, FLAT_BLOCK, axis=1), FLAT_BLOCK, axis=2)
    return jnp.pad(
        full, ((0, 0), (0, h - hb * FLAT_BLOCK), (0, w - wb * FLAT_BLOCK))
    )


# rows per normal-equation chunk: bounds the materialized (K, chunk)
# design slab to ~16 MB a frame at 4K; ata accumulates across chunks
_NE_CHUNK_ROWS = 256


def _masked_normal_eqs(r, interior_mask, cols_full, offs, pad):
    """Masked lag-window normal equations; returns (ata, atb, n).

    ``cols_full``: the K predictor source planes, FULL-frame sized;
    column k of the design matrix is cols_full[k] shifted by offs[k]
    relative to the (pad-cropped) interior. Row-chunked: a whole-frame
    (K, N) design matrix would be K frame-sized temporaries per frame,
    so each step of a rolled loop (lax.map) builds one ~256-row slab
    (~16 MB at 4K) with dynamic slices and takes its ata/atb products,
    which are summed after the loop."""
    k = len(cols_full)
    h, w = r.shape
    hp, wp = h - 2 * pad, w - 2 * pad
    ch = _NE_CHUNK_ROWS
    n_chunks = -(-hp // ch)
    # zero-pad rows so every chunk is full-height; mask 0 => no term
    hpad = n_chunks * ch - hp
    mask_p = jnp.pad(interior_mask, ((0, hpad), (0, 0)))
    r_p = jnp.pad(r, ((0, hpad + 2 * pad), (0, 0)))
    cols_p = [jnp.pad(c, ((0, hpad + 2 * pad), (0, 0))) for c in cols_full]

    def chunk(i):
        row = i * ch
        m = jax.lax.dynamic_slice(mask_p, (row, 0), (ch, wp))
        slab = jnp.stack(
            [
                jax.lax.dynamic_slice(
                    cols_p[j], (row + pad + offs[j][0], pad + offs[j][1]),
                    (ch, wp),
                )
                for j in range(k)
            ]
        ).reshape(k, -1) * m.reshape(1, -1)
        r0 = jax.lax.dynamic_slice(r_p, (row + pad, pad), (ch, wp))
        hi = jax.lax.Precision.HIGHEST
        return (
            jnp.matmul(slab, slab.T, precision=hi),
            jnp.matmul(slab, (r0 * m).reshape(-1), precision=hi),
        )

    ata, atb = jax.lax.map(chunk, jnp.arange(n_chunks))
    return jnp.sum(ata, axis=0), jnp.sum(atb, axis=0), jnp.sum(interior_mask)


def _binned_moments(den, r, mask, bit_depth):
    maxval = (1 << bit_depth) - 1
    bins = jnp.clip(den * NUM_BINS // (maxval + 1), 0, NUM_BINS - 1)
    onehot = (bins[..., None] == jnp.arange(NUM_BINS)).astype(jnp.float32)
    m = mask[..., None] * onehot
    bin_cnt = jnp.sum(m, axis=(0, 1))
    bin_sum = jnp.sum(m * r[..., None], axis=(0, 1))
    bin_sumsq = jnp.sum(m * (r[..., None] ** 2), axis=(0, 1))
    return bin_cnt, bin_sum, bin_sumsq


@functools.partial(jax.jit, static_argnames=("lag", "bit_depth"))
def frame_pair_stats(
    src: jnp.ndarray,  # (H, W) int32 luma, source (grainy)
    den: jnp.ndarray,  # (H, W) int32 luma, denoised
    lag: int,
    bit_depth: int,
):
    """Reduce one luma frame pair to sufficient statistics.

    Returns dict with:
      ata (K, K), atb (K,): masked lag-window normal equations
      n_ar: count of contributing pixels
      bin_cnt (NUM_BINS,), bin_sum, bin_sumsq: residual moments per
        denoised-intensity bin (flat blocks only)
    """
    h, w = src.shape
    r = (src - den).astype(jnp.float32)
    mask = _flat_mask(den)

    offs = _lag_offsets(lag)
    pad = lag
    interior = mask[pad : h - pad, pad : w - pad]

    ata, atb, n_ar = _masked_normal_eqs(r, interior, [r] * len(offs), offs, pad)
    bin_cnt, bin_sum, bin_sumsq = _binned_moments(den, r, mask, bit_depth)
    return dict(
        ata=ata, atb=atb, n_ar=n_ar, bin_cnt=bin_cnt, bin_sum=bin_sum,
        bin_sumsq=bin_sumsq,
    )


@functools.partial(
    jax.jit, static_argnames=("lag", "bit_depth", "sub_x", "sub_y")
)
def frame_pair_stats_chroma(
    src_c: jnp.ndarray,  # (Hc, Wc) int32 chroma, source
    den_c: jnp.ndarray,  # (Hc, Wc) int32 chroma, denoised
    r_luma: jnp.ndarray,  # (H, W) f32 luma residual (src - den)
    lag: int,
    bit_depth: int,
    sub_x: int,
    sub_y: int,
):
    """Chroma-plane statistics: the AR design matrix gains a final
    column — the collocated (subsample-averaged) luma residual — to fit
    the spec's cross-plane coefficient (grain_jax._ar_filter_chroma's
    25th term); scaling moments bin on chroma intensity."""
    hc, wc = src_c.shape
    rc = (src_c - den_c).astype(jnp.float32)
    # collocated luma residual average over the subsampling block
    need_h, need_w = hc << sub_y, wc << sub_x
    h, w = r_luma.shape
    rl = jnp.pad(r_luma, ((0, max(0, need_h - h)), (0, max(0, need_w - w))),
                 mode="edge")
    acc = jnp.zeros((hc, wc), jnp.float32)
    for i in range(sub_y + 1):
        for j in range(sub_x + 1):
            acc = acc + rl[i :: 1 << sub_y, j :: 1 << sub_x][:hc, :wc]
    lavg = acc / ((sub_y + 1) * (sub_x + 1))

    mask = _flat_mask(den_c)
    offs = _lag_offsets(lag)
    pad = lag
    interior = mask[pad : hc - pad, pad : wc - pad]

    ata, atb, n_ar = _masked_normal_eqs(
        rc, interior, [rc] * len(offs) + [lavg], offs + [(0, 0)], pad
    )
    bin_cnt, bin_sum, bin_sumsq = _binned_moments(den_c, rc, mask, bit_depth)
    return dict(
        ata=ata, atb=atb, n_ar=n_ar, bin_cnt=bin_cnt, bin_sum=bin_sum,
        bin_sumsq=bin_sumsq,
    )


@dataclass
class _PlaneStats:
    ata: np.ndarray
    atb: np.ndarray
    n_ar: float = 0.0
    bin_cnt: np.ndarray = None
    bin_sum: np.ndarray = None
    bin_sumsq: np.ndarray = None

    @classmethod
    def zero(cls, k):
        return cls(
            ata=np.zeros((k, k)),
            atb=np.zeros(k),
            bin_cnt=np.zeros(NUM_BINS),
            bin_sum=np.zeros(NUM_BINS),
            bin_sumsq=np.zeros(NUM_BINS),
        )

    def add(self, stats) -> None:
        self.ata += np.asarray(stats["ata"], np.float64)
        self.atb += np.asarray(stats["atb"], np.float64)
        self.n_ar += float(stats["n_ar"])
        self.bin_cnt += np.asarray(stats["bin_cnt"], np.float64)
        self.bin_sum += np.asarray(stats["bin_sum"], np.float64)
        self.bin_sumsq += np.asarray(stats["bin_sumsq"], np.float64)

    def sigma_bins(self, scale8: float, min_count: float = 256.0):
        """Per-bin residual sigma in 8-bit units + validity mask."""
        valid = self.bin_cnt > min_count
        mean = np.where(valid, self.bin_sum / np.maximum(self.bin_cnt, 1), 0)
        var = np.where(
            valid,
            self.bin_sumsq / np.maximum(self.bin_cnt, 1) - mean**2,
            0,
        )
        return np.sqrt(np.maximum(var, 0)) / scale8, valid


@dataclass
class _ChunkStats:
    y: _PlaneStats
    cb: _PlaneStats
    cr: _PlaneStats
    frames: int = 0

    @classmethod
    def zero(cls, k):
        # chroma design gains the collocated-luma column
        return cls(
            y=_PlaneStats.zero(k),
            cb=_PlaneStats.zero(k + 1),
            cr=_PlaneStats.zero(k + 1),
        )


def _solve_coeffs(ps: _PlaneStats, shift: int) -> Optional[np.ndarray]:
    k = ps.ata.shape[0]
    ridge = np.eye(k) * (np.trace(ps.ata) / max(k, 1)) * 1e-6
    try:
        coeffs = np.linalg.solve(ps.ata + ridge, ps.atb)
    except np.linalg.LinAlgError:
        return None
    return np.clip(np.round(coeffs * (1 << shift)), -128, 127).astype(int)


def _curve_points(
    vals: np.ndarray, valid: np.ndarray, max_points: int
) -> List[Tuple[int, int]]:
    occ = np.nonzero(valid)[0]
    take = occ if len(occ) <= max_points else occ[
        np.round(np.linspace(0, len(occ) - 1, max_points)).astype(int)
    ]
    pts = []
    for b in take:
        x = int(min(255, round((b + 0.5) * 256 / NUM_BINS)))
        if pts and x <= pts[-1][0]:
            continue
        pts.append((x, int(round(vals[b]))))
    return pts


def _fit_params(
    stats: _ChunkStats, lag: int, bit_depth: int, seed: int,
    unit_sigma=None,
) -> Optional[FilmGrainParams]:
    """Solve the chunk's model: luma + chroma AR coefficients and
    per-plane scaling curves (joint scaling_shift, as the syntax shares
    one field across planes).

    ``unit_sigma``: optional (pattern_2d) -> float measuring the unit
    pattern's sigma. The single-input estimator passes the same
    high-pass its residuals went through, so the filter's attenuation
    of THIS grain's spectral character cancels exactly out of the
    scaling curve; diff leaves it None (plain std)."""
    if stats.frames == 0 or stats.y.n_ar < 1000:
        return None
    if unit_sigma is None:
        unit_sigma = lambda pat: float(pat.astype(np.float64).std())
    shift = 6  # ar_coeff_shift
    coded_y = _solve_coeffs(stats.y, shift)
    if coded_y is None:
        return None

    scale8 = 1 << (bit_depth - 8)
    sigma_y, valid_y = stats.y.sigma_bins(scale8)
    if not valid_y.any() or sigma_y[valid_y].max() < 0.05:
        return None

    # chroma fits are optional: enough flat pixels and non-trivial noise
    def chroma_fit(ps: _PlaneStats):
        if ps.n_ar < 1000:
            return None, None, None
        coded = _solve_coeffs(ps, shift)
        if coded is None:
            return None, None, None
        sigma, valid = ps.sigma_bins(scale8, min_count=64.0)
        if not valid.any() or sigma[valid].max() < 0.05:
            return None, None, None
        return coded, sigma, valid

    coded_cb, sigma_cb, valid_cb = chroma_fit(stats.cb)
    coded_cr, sigma_cr, valid_cr = chroma_fit(stats.cr)

    # measure each fitted unit pattern's sigma (chroma patterns include
    # the cross-plane luma term, so generate all planes together)
    probe = FilmGrainParams(
        grain_seed=seed,
        scaling_points_y=[(0, 1)],
        scaling_points_cb=[(0, 1)] if coded_cb is not None else [],
        scaling_points_cr=[(0, 1)] if coded_cr is not None else [],
        ar_coeff_lag=lag,
        ar_coeffs_y=[int(c) for c in coded_y],
        ar_coeffs_cb=[int(c) for c in coded_cb] if coded_cb is not None else [],
        ar_coeffs_cr=[int(c) for c in coded_cr] if coded_cr is not None else [],
        ar_coeff_shift=shift,
        scaling_shift=8,
    )
    pat = grain_ref.generate_grain(probe, 8, False, 1, 1)
    sigma_g = unit_sigma(pat.luma[3:, 3:-3])
    if sigma_g < 1e-3:
        return None
    sigma_g_cb = (
        unit_sigma(pat.cb[3:, 3:-3]) if coded_cb is not None else 0.0
    )
    sigma_g_cr = (
        unit_sigma(pat.cr[3:, 3:-3]) if coded_cr is not None else 0.0
    )

    # joint scaling_shift: every plane's curve must fit in 8 bits
    def plane_vals(sigma, valid, sg, ss):
        if sigma is None or sg < 1e-3:
            return None
        return np.where(valid, sigma * (1 << ss) / sg, 0)

    scaling_shift = 8
    while scaling_shift < 11:
        peaks = [np.nanmax(plane_vals(sigma_y, valid_y, sigma_g, scaling_shift))]
        for sigma, valid, sg in (
            (sigma_cb, valid_cb, sigma_g_cb),
            (sigma_cr, valid_cr, sigma_g_cr),
        ):
            v = plane_vals(sigma, valid, sg, scaling_shift)
            if v is not None:
                peaks.append(np.nanmax(v))
        if max(peaks) <= 255:
            break
        scaling_shift += 1

    pts_y = _curve_points(
        np.clip(sigma_y * (1 << scaling_shift) / sigma_g, 0, 255), valid_y, 14
    )
    if not pts_y:
        return None

    def chroma_points(sigma, valid, sg):
        if sigma is None or sg < 1e-3:
            return []
        vals = np.clip(sigma * (1 << scaling_shift) / sg, 0, 255)
        pts = _curve_points(vals, valid, 10)
        return pts if any(y > 0 for _, y in pts) else []

    pts_cb = chroma_points(sigma_cb, valid_cb, sigma_g_cb)
    pts_cr = chroma_points(sigma_cr, valid_cr, sigma_g_cr)

    k = coded_y.shape[0]
    return FilmGrainParams(
        grain_seed=seed,
        scaling_points_y=pts_y,
        scaling_points_cb=pts_cb,
        scaling_points_cr=pts_cr,
        scaling_shift=scaling_shift,
        ar_coeff_lag=lag,
        ar_coeffs_y=[int(c) for c in coded_y],
        ar_coeffs_cb=(
            [int(c) for c in coded_cb] if pts_cb else [0] * (k + 1)
        ),
        ar_coeffs_cr=(
            [int(c) for c in coded_cr] if pts_cr else [0] * (k + 1)
        ),
        ar_coeff_shift=shift,
        grain_scale_shift=0,
        # identity linearization of the chroma scaling input:
        # (avg_luma*(128-128) + chroma*(192-128)) >> 6 + (256-256) == chroma
        cb_mult=192, cb_luma_mult=128, cb_offset=256,
        cr_mult=192, cr_luma_mult=128, cr_offset=256,
        overlap_flag=True,
        clip_to_restricted_range=False,
    )


def _frame_sigma(stats) -> float:
    """Whole-frame flat-area residual sigma (8-bit-depth units of the
    source) from one frame's bin moments — the per-frame noise-strength
    signal driving scene-adaptive segmentation."""
    cnt = float(np.sum(np.asarray(stats["bin_cnt"], np.float64)))
    if cnt < 1:
        return 0.0
    s = float(np.sum(np.asarray(stats["bin_sum"], np.float64)))
    ss = float(np.sum(np.asarray(stats["bin_sumsq"], np.float64)))
    mean = s / cnt
    return float(np.sqrt(max(ss / cnt - mean * mean, 0.0)))


@functools.partial(jax.jit, static_argnames=("lag", "bit_depth"))
def batch_pair_stats(src, den, lag: int, bit_depth: int):
    """(B, H, W) luma frame batches -> per-plane statistics summed over
    the batch (the sums are associative, so shards combine exactly)."""
    per = jax.vmap(lambda s, d: frame_pair_stats(s, d, lag, bit_depth))(src, den)
    return {k: jnp.sum(v, axis=0) for k, v in per.items()}


@functools.partial(
    jax.jit, static_argnames=("lag", "bit_depth", "sub_x", "sub_y")
)
def batch_pair_stats_chroma(
    src_c, den_c, src_y, den_y, lag: int, bit_depth: int, sub_x: int, sub_y: int
):
    r_luma = (src_y - den_y).astype(jnp.float32)
    per = jax.vmap(
        lambda sc, dc, rl: frame_pair_stats_chroma(
            sc, dc, rl, lag, bit_depth, sub_x, sub_y
        )
    )(src_c, den_c, r_luma)
    return {k: jnp.sum(v, axis=0) for k, v in per.items()}


@functools.partial(
    jax.jit,
    static_argnames=("lag", "bit_depth", "sub_x", "sub_y", "has_chroma"),
)
def batch_pair_stats_per_frame(
    sy, dy, sc, dc, sr, dr,
    lag: int, bit_depth: int, sub_x: int, sub_y: int, has_chroma: bool,
):
    """One device dispatch reducing a whole (B, H, W) frame-pair batch
    to PER-FRAME statistics (luma + both chroma planes together).

    This is the production diff path: stats stay per-frame (a few
    hundred floats each) so the host-side scene-cut/chunking logic in
    DiffEstimator behaves exactly as in streaming mode, while the pixel
    work — the part the reference spends its time on in its sequential
    dual-decode loop (main.rs:432-521) — runs on device. Returns
    (y_stats, cb_stats|None, cr_stats|None), each a dict of arrays with
    leading batch dim. Inputs may arrive in the decoder's narrow dtype;
    they widen on device."""
    sy, dy = sy.astype(jnp.int32), dy.astype(jnp.int32)
    y = jax.vmap(lambda s, d: frame_pair_stats(s, d, lag, bit_depth))(sy, dy)
    if not has_chroma:
        return y, None, None
    sc, dc = sc.astype(jnp.int32), dc.astype(jnp.int32)
    sr, dr = sr.astype(jnp.int32), dr.astype(jnp.int32)
    rl = (sy - dy).astype(jnp.float32)
    stats_c = jax.vmap(
        lambda s, d, r: frame_pair_stats_chroma(
            s, d, r, lag, bit_depth, sub_x, sub_y
        )
    )
    return y, stats_c(sc, dc, rl), stats_c(sr, dr, rl)


def mesh_pair_stats_per_frame(
    mesh, sy, dy, sc, dc, sr, dr, lag, bit_depth, sub_x, sub_y, has_chroma
):
    """batch_pair_stats_per_frame with the batch axis sharded over a
    device mesh: each device reduces its local frame shard (shard_map:
    every frame's statistics stay on one device); the per-frame stats
    come back tiny, so the gather is negligible. Output tables are
    identical to the serial path at any shard count."""
    fn = _mesh_pair_stats_fn(mesh, lag, bit_depth, sub_x, sub_y, has_chroma)
    # keep the caller's (narrow) dtype on the wire; the stats fn widens
    if has_chroma:
        args = [jnp.asarray(a) for a in (sy, dy, sc, dc, sr, dr)]
    else:
        args = [jnp.asarray(sy), jnp.asarray(dy)]
    with mesh:
        out = fn(*args)
    if has_chroma:
        return out
    return out, None, None


@functools.lru_cache(maxsize=64)
def _mesh_pair_stats_fn(mesh, lag, bit_depth, sub_x, sub_y, has_chroma):
    """Jitted shard_map stats step, cached per (mesh, static config):
    DiffEstimator.diff_batch invokes this once per ~16-frame batch in
    the --shards production path, and rebuilding the closure per call
    would retrace the sharded program every batch."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    shard = P(axis)

    if has_chroma:

        def step(*args):
            return batch_pair_stats_per_frame(
                *args, lag=lag, bit_depth=bit_depth, sub_x=sub_x,
                sub_y=sub_y, has_chroma=True,
            )

        in_specs = (shard,) * 6
        out_specs = (shard, shard, shard)
    else:

        def step(sy_, dy_):
            return batch_pair_stats_per_frame(
                sy_, dy_, None, None, None, None,
                lag=lag, bit_depth=bit_depth, sub_x=sub_x, sub_y=sub_y,
                has_chroma=False,
            )[0]

        in_specs = (shard, shard)
        out_specs = shard
    mapped = jax.shard_map(
        step, mesh=mesh, in_specs=in_specs, out_specs=out_specs
    )
    return jax.jit(mapped)


def sharded_diff_stats(
    mesh,
    src_planes,  # [y, cb, cr] or [y]; each (B, h, w) int32, B % mesh == 0
    den_planes,
    lag: int,
    bit_depth: int,
):
    """Frame-data-parallel diff reduction over a device mesh: each
    device reduces its frame shard, then the sums psum over the mesh
    axis (all-reduce collectives) — the distributed mapping SURVEY §5
    prescribes for diff statistics. Returns (y_stats, cb_stats|None,
    cr_stats|None) as replicated host arrays, exactly equal to the
    serial per-frame sums."""
    has_chroma = len(src_planes) >= 3
    fn = _sharded_diff_stats_fn(mesh, lag, bit_depth, has_chroma)
    if has_chroma:
        args = [
            jnp.asarray(p, jnp.int32)
            for pair in zip(src_planes, den_planes)
            for p in pair
        ]
    else:
        args = [
            jnp.asarray(src_planes[0], jnp.int32),
            jnp.asarray(den_planes[0], jnp.int32),
        ]
    with mesh:
        out = fn(*args)
    if has_chroma:
        return out
    return out[0], None, None


@functools.lru_cache(maxsize=64)
def _sharded_diff_stats_fn(mesh, lag, bit_depth, has_chroma):
    """Jitted psum reduction step, cached per (mesh, static config) so
    repeated batches do not retrace the sharded program."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]
    shard = P(axis)

    def psum_dict(d):
        return {k: jax.lax.psum(v, axis) for k, v in d.items()}

    if has_chroma:

        def step(sy, dy, sc, dc, sr, dr):
            y = psum_dict(batch_pair_stats(sy, dy, lag, bit_depth))
            hc, wc = sc.shape[1:]
            sub_y_ = 1 if hc < sy.shape[1] else 0
            sub_x_ = 1 if wc < sy.shape[2] else 0
            cb = psum_dict(
                batch_pair_stats_chroma(sc, dc, sy, dy, lag, bit_depth, sub_x_, sub_y_)
            )
            cr = psum_dict(
                batch_pair_stats_chroma(sr, dr, sy, dy, lag, bit_depth, sub_x_, sub_y_)
            )
            return y, cb, cr

        in_specs = (shard,) * 6
        out_specs = (P(), P(), P())
    else:

        def step(sy, dy):
            return (psum_dict(batch_pair_stats(sy, dy, lag, bit_depth)),)

        in_specs = (shard, shard)
        out_specs = (P(),)
    mapped = jax.shard_map(
        step, mesh=mesh, in_specs=in_specs, out_specs=out_specs
    )
    return jax.jit(mapped)


class DiffEstimator:
    """Streaming source/denoised comparator producing a grain table.

    Mirrors the reference diff pipeline contract (per-pair feeding,
    finish() -> segments; mixed bit depths normalized to the source's,
    main.rs:420-427) with a scene-adaptive time model: a chunk closes
    when (a) it reaches ``chunk_frames`` pairs, or (b) the per-frame
    noise strength jumps away from the chunk's running level (a grade
    or scene change in the grain character). Adjacent chunks whose
    fitted models agree are merged back, so stationary noise still
    yields one long segment.
    """

    def __init__(
        self,
        fps: Tuple[int, int],
        source_bit_depth: int = 8,
        denoised_bit_depth: int = 8,
        lag: int = 2,
        chunk_frames: int = 60,
        seed: int = 7391,
        min_chunk_frames: int = 8,
        sigma_jump: float = 0.35,
    ):
        self.fps = fps
        self.src_bd = source_bit_depth
        self.den_bd = denoised_bit_depth
        self.lag = lag
        self.chunk_frames = chunk_frames
        self.seed = seed
        self.min_chunk_frames = min_chunk_frames
        self.sigma_jump = sigma_jump
        self._k = len(_lag_offsets(lag))
        self._chunk = _ChunkStats.zero(self._k)
        self._chunk_start = 0
        self._frame_idx = 0
        self._segments: List[GrainTableSegment] = []
        self._chunk_sigmas: List[float] = []

    def _scene_cut(self, sigma: float) -> bool:
        """True when this frame's noise level departs from the chunk's
        running median by more than ``sigma_jump`` (relative) — only
        once the chunk is long enough to have a trustworthy level."""
        if len(self._chunk_sigmas) < self.min_chunk_frames:
            return False
        level = float(np.median(self._chunk_sigmas))
        scale8 = 1 << (self.src_bd - 8)
        return abs(sigma - level) > max(
            self.sigma_jump * level, 0.15 * scale8
        )

    def diff_frame(self, src_planes, den_planes) -> None:
        def norm(plane):
            p = jnp.asarray(plane, jnp.int32)
            if self.den_bd < self.src_bd:
                return p << (self.src_bd - self.den_bd)
            if self.den_bd > self.src_bd:
                return p >> (self.den_bd - self.src_bd)
            return p

        src = jnp.asarray(src_planes[0], jnp.int32)
        den = norm(den_planes[0])
        if den.shape != src.shape:
            raise ValueError(
                f"source/denoised dimensions differ: {src.shape} vs {den.shape}"
            )
        stats = frame_pair_stats(src, den, self.lag, self.src_bd)
        chroma = [None, None]
        if len(src_planes) >= 3 and len(den_planes) >= 3:
            r_luma = (src - den).astype(jnp.float32)
            h, w = src.shape
            hc, wc = src_planes[1].shape
            sub_y = 1 if hc < h else 0
            sub_x = 1 if wc < w else 0
            for k, idx in enumerate((1, 2)):
                sc = jnp.asarray(src_planes[idx], jnp.int32)
                dc = norm(den_planes[idx])
                if dc.shape != sc.shape:
                    continue
                chroma[k] = frame_pair_stats_chroma(
                    sc, dc, r_luma, self.lag, self.src_bd, sub_x, sub_y
                )
        self.add_frame_stats(stats, *chroma)

    def add_frame_stats(self, y_stats, cb_stats=None, cr_stats=None) -> None:
        """Ingest one frame pair's statistics (dicts as returned by
        frame_pair_stats; chroma optional): scene-cut detection, then
        the current chunk, which closes at ``chunk_frames`` pairs."""
        sigma = _frame_sigma(y_stats)
        if self._scene_cut(sigma):
            self._flush_chunk()
        self._chunk_sigmas.append(sigma)
        self._chunk.y.add(y_stats)
        if cb_stats is not None:
            self._chunk.cb.add(cb_stats)
        if cr_stats is not None:
            self._chunk.cr.add(cr_stats)
        self._chunk.frames += 1
        self._frame_idx += 1
        if self._frame_idx - self._chunk_start >= self.chunk_frames:
            self._flush_chunk()

    def diff_batch(self, src_frames, den_frames, mesh=None) -> None:
        """Feed a batch of frame pairs through ONE device dispatch.

        ``src_frames``/``den_frames`` are sequences of per-frame plane
        lists with uniform geometry. Per-frame statistics come back from
        batch_pair_stats_per_frame, then run through the same sequential
        scene-cut/chunking logic as diff_frame — output tables are
        identical to the streaming path; only the dispatch granularity
        changes (the reference processes one pair per loop iteration,
        main.rs:432-521). ``mesh`` shards the batch axis across devices."""
        if not src_frames:
            return
        nshift = self.src_bd - self.den_bd

        def norm(p):
            # bit-depth normalization in int16 (every AV1 depth fits):
            # uploads stay at the decoder's narrow width
            if nshift > 0:
                return p.astype(np.int16) << nshift
            if nshift < 0:
                return p.astype(np.int16) >> -nshift
            return p

        b = len(src_frames)

        def i16_wire(a):
            # uint16 -> int16 reinterpretation is free and value-
            # preserving for every AV1 bit depth (<= 12 bits); uint8
            # stays narrow
            return a.view(np.int16) if a.dtype == np.uint16 else a

        # stack in the decoder's native dtype (uint8/uint16) — the
        # widening happens on device, so host->device transfers are
        # 2-4x smaller than an int32 wire format
        sy = i16_wire(np.stack([np.asarray(f[0]) for f in src_frames]))
        dy = i16_wire(norm(np.stack([np.asarray(f[0]) for f in den_frames])))
        if dy.shape != sy.shape:
            raise ValueError(
                f"source/denoised dimensions differ: {sy.shape} vs {dy.shape}"
            )
        has_chroma = len(src_frames[0]) >= 3 and len(den_frames[0]) >= 3
        sc = dc = sr = dr = None
        sub_x = sub_y = 0
        if has_chroma:
            sc = i16_wire(np.stack([np.asarray(f[1]) for f in src_frames]))
            sr = i16_wire(np.stack([np.asarray(f[2]) for f in src_frames]))
            dc = i16_wire(norm(np.stack([np.asarray(f[1]) for f in den_frames])))
            dr = i16_wire(norm(np.stack([np.asarray(f[2]) for f in den_frames])))
            if dc.shape != sc.shape or dr.shape != sr.shape:
                # chroma geometry mismatch: the streaming path skips
                # only the mismatched plane per frame — route through
                # it so batched and streaming tables stay identical
                # (disabling chroma batch-wide here would diverge)
                for sf, df in zip(src_frames, den_frames):
                    self.diff_frame(sf, df)
                return
            else:
                hc, wc = sc.shape[1:]
                sub_y = 1 if hc < sy.shape[1] else 0
                sub_x = 1 if wc < sy.shape[2] else 0

        if mesh is not None:
            n = mesh.devices.size
            pad = (-b) % n
            if pad:
                def padded(a):
                    return (
                        None if a is None
                        else np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0)
                    )
                sy, dy, sc, dc, sr, dr = map(padded, (sy, dy, sc, dc, sr, dr))
            y_st, cb_st, cr_st = mesh_pair_stats_per_frame(
                mesh, sy, dy, sc, dc, sr, dr,
                self.lag, self.src_bd, sub_x, sub_y, has_chroma,
            )
        else:
            y_st, cb_st, cr_st = batch_pair_stats_per_frame(
                jnp.asarray(sy), jnp.asarray(dy),
                None if sc is None else jnp.asarray(sc),
                None if dc is None else jnp.asarray(dc),
                None if sr is None else jnp.asarray(sr),
                None if dr is None else jnp.asarray(dr),
                lag=self.lag, bit_depth=self.src_bd,
                sub_x=sub_x, sub_y=sub_y, has_chroma=has_chroma,
            )
        # fetch ALL per-batch statistics in ONE device->host transfer
        # (one round trip a batch instead of one per array)
        dicts = [y_st] + ([cb_st, cr_st] if has_chroma else [])
        keys = [sorted(d) for d in dicts]
        bsz = next(iter(y_st.values())).shape[0]
        flat = jnp.concatenate(
            [
                d[k].reshape(bsz, -1).astype(jnp.float32)
                for d, ks in zip(dicts, keys)
                for k in ks
            ],
            axis=1,
        )
        host = np.asarray(flat)
        unpacked = []
        pos = 0
        for d, ks in zip(dicts, keys):
            out = {}
            for k in ks:
                shape = d[k].shape
                n = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 else 1
                out[k] = host[:, pos : pos + n].reshape(
                    (bsz,) + tuple(shape[1:])
                )
                pos += n
            unpacked.append(out)
        y_st = unpacked[0]
        if has_chroma:
            cb_st, cr_st = unpacked[1], unpacked[2]
        for i in range(b):
            self.add_frame_stats(
                *(
                    None if d is None else {k: v[i] for k, v in d.items()}
                    for d in (y_st, cb_st, cr_st)
                )
            )

    def add_stats(
        self, y_stats, cb_stats=None, cr_stats=None, frames: int = 1
    ) -> None:
        """Ingest pre-reduced statistics covering ``frames`` frame pairs
        (e.g. from sharded_diff_stats): the batch joins the current
        chunk as one block — per-frame scene-cut detection happens on
        the producing side (or not at all for single-model fits)."""
        self._chunk.y.add(y_stats)
        if cb_stats is not None:
            self._chunk.cb.add(cb_stats)
        if cr_stats is not None:
            self._chunk.cr.add(cr_stats)
        self._chunk.frames += frames
        self._frame_idx += frames
        if self._frame_idx - self._chunk_start >= self.chunk_frames:
            self._flush_chunk()

    def _flush_chunk(self) -> None:
        if self._chunk.frames == 0:
            return
        params = _fit_params(self._chunk, self.lag, self.src_bd, self.seed)
        start, _ = packet_bounds(self._chunk_start, *self.fps)
        _, end = packet_bounds(self._frame_idx - 1, *self.fps)
        if params is not None:
            merged = False
            if self._segments and self._segments[-1].end_time == start:
                if self._segments[-1].params.equal_ignoring_seed(params):
                    self._segments[-1].end_time = end
                    merged = True
            if not merged:
                self._segments.append(GrainTableSegment(start, end, params))
        self._chunk = _ChunkStats.zero(self._k)
        self._chunk_start = self._frame_idx
        self._chunk_sigmas = []

    def finish(self) -> List[GrainTableSegment]:
        self._flush_chunk()
        return self._segments
