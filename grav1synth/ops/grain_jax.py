"""JAX implementation of AV1 film grain synthesis.

Bit-exact port of grain_ref.py (itself validated against dav1d),
re-structured for data-parallel devices rather than translated:

- The spec's serial 16-bit LFSR is GF(2)-linear, so all N states are
  computed in parallel as one bit-matrix multiply against precomputed
  companion-matrix powers (no sequential dependency).
- AR filtering is a `lax.scan` over wavefronts of raster positions
  whose lag window is a static set of flat-index offsets; each step
  processes the whole frame batch as a vector.
- Noise-plane assembly is four index gathers from the pattern
  (current / left / top / top-left block grain), blended with periodic
  weight masks -- no per-block loops.
- Scaling is one gather from a per-frame LUT built with the spec's
  exact integer construction.

The application runs either as the Triton kernels of grain_pallas (the
GPU's path) or as the plain XLA formulation; select_backend() picks
one from the platform. All functions take a `GrainParamsBatch`
(leading dim = frames) and are jittable with static geometry.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..obu.types import FilmGrainParams
from .tables_data import GAUSSIAN_SEQUENCE

GRAIN_W = 82
GRAIN_H = 73
CHROMA_W_420 = 44
CHROMA_H_420 = 38
BLOCK = 32
MAX_Y_POINTS = 14
MAX_UV_POINTS = 10

# AR lag-3 neighbor slots in spec scan order (deltaRow -3..0, deltaCol
# -3..3, stopping at (0,0)): 24 spatial positions. Lower-lag coefficient
# lists are scattered into these slots host-side so one static window
# serves every lag.
LAG3_OFFSETS: Tuple[Tuple[int, int], ...] = tuple(
    (dr, dc)
    for dr in range(-3, 1)
    for dc in range(-3, 4)
    if not (dr == 0 and dc >= 0)
)
assert len(LAG3_OFFSETS) == 24


def _lag_offsets(lag: int) -> List[Tuple[int, int]]:
    out = []
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                break
            out.append((dr, dc))
    return out


_LAG3_SLOT = {off: i for i, off in enumerate(LAG3_OFFSETS)}


def scatter_coeffs_to_lag3(coeffs: List[int], lag: int) -> np.ndarray:
    """Place a lag-N coefficient list into the 24 lag-3 slots."""
    out = np.zeros(24, dtype=np.int32)
    for c, off in zip(coeffs, _lag_offsets(lag)):
        out[_LAG3_SLOT[off]] = c
    return out


# ---------------------------------------------------------------------------
# Batched parameter container


@jax.tree_util.register_pytree_node_class
@dataclass
class GrainParamsBatch:
    """Per-frame grain parameters as stacked device arrays (leading B)."""

    seed: jnp.ndarray  # (B,) int32
    num_y: jnp.ndarray  # (B,)
    num_cb: jnp.ndarray
    num_cr: jnp.ndarray
    pts_y: jnp.ndarray  # (B, 14, 2) int32, padded with last point
    pts_cb: jnp.ndarray  # (B, 10, 2)
    pts_cr: jnp.ndarray
    coeffs_y: jnp.ndarray  # (B, 24) int32 in lag-3 slots
    coeffs_cb: jnp.ndarray  # (B, 25): 24 slots + luma coeff
    coeffs_cr: jnp.ndarray
    scaling_shift: jnp.ndarray  # (B,)
    ar_shift: jnp.ndarray  # (B,)
    grain_scale_shift: jnp.ndarray  # (B,)
    cb_mult: jnp.ndarray
    cb_luma_mult: jnp.ndarray
    cb_offset: jnp.ndarray
    cr_mult: jnp.ndarray
    cr_luma_mult: jnp.ndarray
    cr_offset: jnp.ndarray
    csfl: jnp.ndarray  # (B,) int32 0/1
    overlap: jnp.ndarray  # (B,) int32 0/1
    clip: jnp.ndarray  # (B,) int32 0/1

    def tree_flatten(self):
        fields = tuple(self.__dataclass_fields__)
        return tuple(getattr(self, f) for f in fields), fields

    @classmethod
    def tree_unflatten(cls, fields, values):
        return cls(**dict(zip(fields, values)))

    @property
    def batch(self) -> int:
        return self.seed.shape[0]


def pack_params(params: List[FilmGrainParams]) -> GrainParamsBatch:
    """Stack host FilmGrainParams into a device batch."""
    b = len(params)

    def pad_points(pts, n):
        out = np.zeros((b, n, 2), dtype=np.int32)
        for i, p in enumerate(pts):
            if p:
                arr = np.asarray(p, dtype=np.int32)
                out[i, : len(p)] = arr
                out[i, len(p) :] = arr[-1]  # pad with last point
        return out

    def arr(get, dtype=np.int32):
        return np.asarray([get(p) for p in params], dtype=dtype)

    coeffs_y = np.stack(
        [scatter_coeffs_to_lag3(p.ar_coeffs_y, p.ar_coeff_lag) for p in params]
    )
    def chroma_coeffs(get_coeffs, active):
        out = np.zeros((b, 25), dtype=np.int32)
        for i, p in enumerate(params):
            cs = get_coeffs(p)
            if not active(p) or not cs:
                continue
            n_spatial = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
            out[i, :24] = scatter_coeffs_to_lag3(cs[:n_spatial], p.ar_coeff_lag)
            if len(p.scaling_points_y) > 0 and len(cs) > n_spatial:
                out[i, 24] = cs[n_spatial]
        return out

    cb_active = lambda p: p.chroma_scaling_from_luma or len(p.scaling_points_cb) > 0
    cr_active = lambda p: p.chroma_scaling_from_luma or len(p.scaling_points_cr) > 0
    return GrainParamsBatch(
        seed=jnp.asarray(arr(lambda p: p.grain_seed)),
        num_y=jnp.asarray(arr(lambda p: len(p.scaling_points_y))),
        num_cb=jnp.asarray(arr(lambda p: len(p.scaling_points_cb))),
        num_cr=jnp.asarray(arr(lambda p: len(p.scaling_points_cr))),
        pts_y=jnp.asarray(pad_points([p.scaling_points_y for p in params], MAX_Y_POINTS)),
        pts_cb=jnp.asarray(pad_points([p.scaling_points_cb for p in params], MAX_UV_POINTS)),
        pts_cr=jnp.asarray(pad_points([p.scaling_points_cr for p in params], MAX_UV_POINTS)),
        coeffs_y=jnp.asarray(coeffs_y),
        coeffs_cb=jnp.asarray(chroma_coeffs(lambda p: p.ar_coeffs_cb, cb_active)),
        coeffs_cr=jnp.asarray(chroma_coeffs(lambda p: p.ar_coeffs_cr, cr_active)),
        scaling_shift=jnp.asarray(arr(lambda p: p.scaling_shift)),
        ar_shift=jnp.asarray(arr(lambda p: p.ar_coeff_shift)),
        grain_scale_shift=jnp.asarray(arr(lambda p: p.grain_scale_shift)),
        cb_mult=jnp.asarray(arr(lambda p: p.cb_mult)),
        cb_luma_mult=jnp.asarray(arr(lambda p: p.cb_luma_mult)),
        cb_offset=jnp.asarray(arr(lambda p: p.cb_offset)),
        cr_mult=jnp.asarray(arr(lambda p: p.cr_mult)),
        cr_luma_mult=jnp.asarray(arr(lambda p: p.cr_luma_mult)),
        cr_offset=jnp.asarray(arr(lambda p: p.cr_offset)),
        csfl=jnp.asarray(arr(lambda p: int(p.chroma_scaling_from_luma))),
        overlap=jnp.asarray(arr(lambda p: int(p.overlap_flag))),
        clip=jnp.asarray(arr(lambda p: int(p.clip_to_restricted_range))),
    )


# ---------------------------------------------------------------------------
# Parallel LFSR: companion-matrix powers over GF(2)


@functools.lru_cache(maxsize=8)
def _lfsr_matrix_powers(n: int) -> np.ndarray:
    """M^1..M^n packed as one (16, n*16) uint8 matrix, where M is the
    GF(2) companion matrix of the spec LFSR r' = (r >> 1) | (parity <<
    15), parity over taps {0, 1, 3, 12}. state_bits(k) = s0_bits @ M^k."""
    m = np.zeros((16, 16), dtype=np.uint8)
    for i in range(1, 16):
        m[i, i - 1] = 1  # b'_{i-1} = b_i
    for tap in (0, 1, 3, 12):
        m[tap, 15] ^= 1  # b'_15 = b0 ^ b1 ^ b3 ^ b12
    out = np.empty((n, 16, 16), dtype=np.uint8)
    acc = m.copy()
    out[0] = acc
    for k in range(1, n):
        acc = (acc.astype(np.uint16) @ m) & 1
        acc = acc.astype(np.uint8)
        out[k] = acc
    return np.ascontiguousarray(out.transpose(1, 0, 2).reshape(16, n * 16))


def lfsr_outputs(seeds: jnp.ndarray, n: int, nbits: int) -> jnp.ndarray:
    """(B,) uint16 seeds -> (B, n) outputs of get_random_number(nbits):
    the top `nbits` of the state after each of n updates."""
    mat = jnp.asarray(_lfsr_matrix_powers(n), dtype=jnp.int32)  # (16, n*16)
    bit_idx = jnp.arange(16, dtype=jnp.int32)
    s0 = (seeds[:, None] >> bit_idx[None, :]) & 1  # (B, 16)
    states = jnp.dot(s0, mat, preferred_element_type=jnp.int32) & 1  # (B, n*16)
    states = states.reshape(seeds.shape[0], n, 16)
    weights = (1 << jnp.arange(16, dtype=jnp.int32))[None, None, :]
    value = jnp.sum(states * weights, axis=-1)  # (B, n) full 16-bit states
    return (value >> (16 - nbits)) & ((1 << nbits) - 1)


def round2(x: jnp.ndarray, shift) -> jnp.ndarray:
    return jnp.where(
        jnp.asarray(shift) > 0, (x + (1 << jnp.maximum(shift - 1, 0))) >> shift, x
    )


# ---------------------------------------------------------------------------
# Pattern generation


def _gaussian_base(
    seeds: jnp.ndarray, h: int, w: int, shift: jnp.ndarray, active: jnp.ndarray
) -> jnp.ndarray:
    """(B,) seeds -> (B, h, w) rounded Gaussian base noise; inactive
    frames produce zeros (the spec does not advance the RNG for them,
    which is immaterial here as every pattern has an independent seed)."""
    idx = lfsr_outputs(seeds, h * w, 11)
    gauss = jnp.asarray(GAUSSIAN_SEQUENCE, dtype=jnp.int32)
    g = jnp.take(gauss, idx, axis=0)
    g = round2(g, shift[:, None]).reshape(-1, h, w)
    return g * active[:, None, None]


def _wavefronts(h: int, w: int) -> Tuple[np.ndarray, int]:
    """Group the AR region's positions into parallel wavefronts.

    Every AR neighbor (deltaRow in [-3, 0], deltaCol in [-3, 3], before
    (0,0) in raster order) of position (y, x) has strictly smaller
    t = 4*y + x, so all positions sharing a t are mutually independent
    and the spec's raster recurrence collapses from h*w sequential
    steps to ~4*h + w wavefront steps.

    Returns (positions (T, P) int32 padded with h*w (a scratch slot),
    P = max positions per wavefront)."""
    groups = {}
    for y in range(3, h):
        for x in range(3, w - 3):
            groups.setdefault(4 * y + x, []).append(y * w + x)
    ts = sorted(groups)
    p_max = max(len(v) for v in groups.values())
    dummy = h * w
    out = np.full((len(ts), p_max), dummy, dtype=np.int32)
    for i, t in enumerate(ts):
        out[i, : len(groups[t])] = groups[t]
    return out, p_max


@functools.partial(jax.jit, static_argnames=("h", "w"))
def _ar_filter(
    pattern: jnp.ndarray,  # (B, h, w) int32
    coeffs: jnp.ndarray,  # (B, 24) int32, lag-3 slots
    ar_shift: jnp.ndarray,  # (B,)
    gmin: jnp.ndarray,  # (B,)
    gmax: jnp.ndarray,  # (B,)
    h: int,
    w: int,
) -> jnp.ndarray:
    """Spec AR recurrence, scheduled as a wavefront scan (see
    _wavefronts) batched across frames."""
    b = pattern.shape[0]
    positions, _ = _wavefronts(h, w)
    # one scratch slot at the end absorbs padded-position writes
    flat = jnp.concatenate(
        [pattern.reshape(b, h * w), jnp.zeros((b, 1), jnp.int32)], axis=1
    )
    rel = jnp.asarray([dr * w + dc for dr, dc in LAG3_OFFSETS], dtype=jnp.int32)
    add = (1 << jnp.maximum(ar_shift - 1, 0))[:, None]
    shift = ar_shift[:, None]

    def step(carry, pos):  # pos: (P,)
        window = carry[:, pos[:, None] + rel[None, :]]  # (B, P, 24)
        s = jnp.einsum("bpk,bk->bp", window, coeffs, preferred_element_type=jnp.int32)
        v = carry[:, pos] + ((s + add) >> shift)
        v = jnp.clip(v, gmin[:, None], gmax[:, None])
        return carry.at[:, pos].set(v), None

    flat, _ = jax.lax.scan(step, flat, jnp.asarray(positions))
    return flat[:, : h * w].reshape(b, h, w)


def _ar_filter_chroma(
    pattern: jnp.ndarray,  # (B, ch, cw)
    luma: jnp.ndarray,  # (B, 73, 82) final luma pattern
    coeffs: jnp.ndarray,  # (B, 25)
    ar_shift: jnp.ndarray,
    gmin: jnp.ndarray,
    gmax: jnp.ndarray,
    sub_x: int,
    sub_y: int,
    num_y: jnp.ndarray,  # (B,)
) -> jnp.ndarray:
    b, ch, cw = pattern.shape
    positions, p_max = _wavefronts(ch, cw)
    flat = jnp.concatenate(
        [pattern.reshape(b, ch * cw), jnp.zeros((b, 1), jnp.int32)], axis=1
    )
    rel = jnp.asarray([dr * cw + dc for dr, dc in LAG3_OFFSETS], dtype=jnp.int32)
    # collocated luma average per chroma position, via strided slices
    # (no gathers): for the filtered region y in [3, ch), x in [3, cw-3)
    # the luma anchor walks rows/cols 3::2^sub
    step_y, step_x = 1 << sub_y, 1 << sub_x
    n_rows, n_cols = ch - 3, cw - 6
    acc = jnp.zeros((b, n_rows, n_cols), jnp.int32)
    for i in range(sub_y + 1):
        for j in range(sub_x + 1):
            sl = luma[:, 3 + i :: step_y, 3 + j :: step_x]
            acc = acc + sl[:, :n_rows, :n_cols]
    avg_region = round2(acc, sub_x + sub_y)
    avg_grid = jnp.zeros((b, ch, cw), jnp.int32)
    avg_grid = avg_grid.at[:, 3:, 3 : cw - 3].set(avg_region)
    avg_full = jnp.concatenate(
        [avg_grid.reshape(b, ch * cw), jnp.zeros((b, 1), jnp.int32)], axis=1
    )

    add = (1 << jnp.maximum(ar_shift - 1, 0))[:, None]
    shift = ar_shift[:, None]
    luma_coeff = (coeffs[:, 24] * (num_y > 0))[:, None]
    spatial = coeffs[:, :24]
    # Fold the collocated-luma term into the window gather itself: the
    # carry is [pattern || luma_coeff * avg], and the luma contribution
    # becomes a 25th window offset (n + 1, the same position in the
    # second half) with unit coefficient — the scan body is then
    # structurally identical to the (hardware-verified) luma filter.
    n1 = ch * cw + 1
    carry0 = jnp.concatenate([flat, luma_coeff * avg_full], axis=1)
    rel25 = jnp.concatenate([rel, jnp.asarray([n1], jnp.int32)])
    coeffs25 = jnp.concatenate([spatial, jnp.ones((b, 1), jnp.int32)], axis=1)

    def step(carry, pos):
        window = carry[:, pos[:, None] + rel25[None, :]]
        s = jnp.einsum(
            "bpk,bk->bp", window, coeffs25, preferred_element_type=jnp.int32
        )
        v = carry[:, pos] + ((s + add) >> shift)
        v = jnp.clip(v, gmin[:, None], gmax[:, None])
        return carry.at[:, pos].set(v), None

    carry, _ = jax.lax.scan(step, carry0, jnp.asarray(positions))
    return carry[:, : ch * cw].reshape(b, ch, cw)


@functools.partial(jax.jit, static_argnames=("bit_depth", "sub_x", "sub_y", "monochrome"))
def generate_patterns(
    p: GrainParamsBatch,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
):
    """Returns (luma (B,73,82), cb, cr) grain patterns (cb/cr None when
    monochrome)."""
    shift = 12 - bit_depth + p.grain_scale_shift
    grain_center = 128 << (bit_depth - 8)
    gmin = jnp.full_like(p.seed, -grain_center)
    gmax = jnp.full_like(p.seed, grain_center - 1)

    luma = _gaussian_base(p.seed, GRAIN_H, GRAIN_W, shift, (p.num_y > 0).astype(jnp.int32))
    luma = _ar_filter(luma, p.coeffs_y, p.ar_shift, gmin, gmax, GRAIN_H, GRAIN_W)
    if monochrome:
        return luma, None, None
    cw = CHROMA_W_420 if sub_x else GRAIN_W
    ch = CHROMA_H_420 if sub_y else GRAIN_H
    cb_active = ((p.num_cb > 0) | (p.csfl > 0)).astype(jnp.int32)
    cr_active = ((p.num_cr > 0) | (p.csfl > 0)).astype(jnp.int32)
    cb = _gaussian_base(p.seed ^ 0xB524, ch, cw, shift, cb_active)
    cr = _gaussian_base(p.seed ^ 0x49D8, ch, cw, shift, cr_active)
    cb = _ar_filter_chroma(
        cb, luma, p.coeffs_cb * cb_active[:, None], p.ar_shift, gmin, gmax,
        sub_x, sub_y, p.num_y,
    )
    cr = _ar_filter_chroma(
        cr, luma, p.coeffs_cr * cr_active[:, None], p.ar_shift, gmin, gmax,
        sub_x, sub_y, p.num_y,
    )
    return luma, cb, cr


# ---------------------------------------------------------------------------
# Block offsets


def block_offsets(seed: jnp.ndarray, num_stripes: int, blocks: int) -> jnp.ndarray:
    """(B,) seeds -> (B, num_stripes, blocks) 8-bit offset randoms with
    the spec per-stripe reseeding."""
    s = jnp.arange(num_stripes, dtype=jnp.int32)
    rr = seed[:, None]
    rr = rr ^ (((s * 37 + 178) & 255) << 8)[None, :]
    rr = rr ^ ((s * 173 + 105) & 255)[None, :]
    flat_seeds = rr.reshape(-1)
    outs = lfsr_outputs(flat_seeds, blocks, 8)
    return outs.reshape(seed.shape[0], num_stripes, blocks)


# ---------------------------------------------------------------------------
# Noise plane assembly (index maps + gathers)


def _noise_plane(
    pattern: jnp.ndarray,  # (B, gh, gw)
    offsets: jnp.ndarray,  # (B, S, NB) 8-bit randoms
    h: int,
    w: int,
    sub_x: int,
    sub_y: int,
    overlap: jnp.ndarray,  # (B,)
    gmin: jnp.ndarray,
    gmax: jnp.ndarray,
) -> jnp.ndarray:
    """Per-pixel grain assembly by index gathers from the pattern.

    Each pixel gathers its own block's window sample and the left, top
    and top-left neighbours' continuation samples (at in-bounds
    indices everywhere; the blend masks keep them only in the overlap
    bands), then blends them as spec 7.18.3 does."""
    b, gh, gw = pattern.shape
    bw = BLOCK >> sub_x
    bh = BLOCK >> sub_y
    ov_cols = 2 >> sub_x
    ov_rows = 2 >> sub_y
    stepx = 2 >> sub_x
    stepy = 2 >> sub_y

    ys = np.arange(h)
    xs = np.arange(w)
    rowpos = ys % bh
    colpos = xs % bw
    r_ov = np.minimum(rowpos, ov_rows - 1)
    c_ov = np.minimum(colpos, ov_cols - 1)
    # block randoms of the left / top neighbours (index clamped at 0:
    # the first row/column of blocks never blends)
    off_left = jnp.concatenate([offsets[:, :, :1], offsets[:, :, :-1]], axis=2)
    off_top = jnp.concatenate([offsets[:, :1], offsets[:, :-1]], axis=1)
    off_tl = jnp.concatenate([off_top[:, :, :1], off_top[:, :, :-1]], axis=2)
    flat = pattern.reshape(b, gh * gw)

    def window(offs, dy, dx):
        rand = jnp.repeat(jnp.repeat(offs, bh, axis=1), bw, axis=2)[:, :h, :w]
        ox = 3 + stepx * (3 + (rand >> 4)) + dx[None, None, :]
        oy = 3 + stepy * (3 + (rand & 15)) + dy[None, :, None]
        idx = (oy * gw + ox).reshape(b, h * w)
        out = jnp.take_along_axis(flat, idx, axis=1).reshape(b, h, w)
        return out.astype(jnp.int32)

    cur = window(offsets, rowpos, colpos)
    left = window(off_left, rowpos, bw + c_ov)
    top = window(off_top, bh + r_ov, colpos)
    topleft = window(off_tl, bh + r_ov, bw + c_ov)

    has_left = (xs // bw > 0) & (colpos < ov_cols)
    has_top = (ys // bh > 0) & (rowpos < ov_rows)
    if sub_x:
        wx_old = np.where(colpos == 0, 23, 0)
        wx_new = np.where(colpos == 0, 22, 32)
    else:
        wx_old = np.select([colpos == 0, colpos == 1], [27, 17], 0)
        wx_new = np.select([colpos == 0, colpos == 1], [17, 27], 32)
    if sub_y:
        wy_old = np.where(rowpos == 0, 23, 0)
        wy_new = np.where(rowpos == 0, 22, 32)
    else:
        wy_old = np.select([rowpos == 0, rowpos == 1], [27, 17], 0)
        wy_new = np.select([rowpos == 0, rowpos == 1], [17, 27], 32)

    has_left = jnp.asarray(has_left)[None, None, :]
    has_top = jnp.asarray(has_top)[None, :, None]
    wx_old = jnp.asarray(wx_old)[None, None, :]
    wx_new = jnp.asarray(wx_new)[None, None, :]
    wy_old = jnp.asarray(wy_old)[None, :, None]
    wy_new = jnp.asarray(wy_new)[None, :, None]
    ov = (overlap > 0)[:, None, None]
    gmin_b = gmin[:, None, None]
    gmax_b = gmax[:, None, None]

    def hblend(old, new):
        blended = jnp.clip((old * wx_old + new * wx_new + 16) >> 5, gmin_b, gmax_b)
        return jnp.where(ov & has_left, blended, new)

    cur_h = hblend(left, cur)
    top_h = hblend(topleft, top)
    blended_v = jnp.clip((top_h * wy_old + cur_h * wy_new + 16) >> 5, gmin_b, gmax_b)
    return jnp.where(ov & has_top, blended_v, cur_h)


# ---------------------------------------------------------------------------
# Scaling: closed-form piecewise-linear evaluation


def _scaling_eval8(
    v: jnp.ndarray,  # (B, h, w) int32 in 8-bit node domain 0..255
    pts: jnp.ndarray,  # (B, P, 2)
    num: jnp.ndarray,  # (B,)
) -> jnp.ndarray:
    """Exact spec LUT value at 8-bit node positions, evaluated directly:
    lut[x] for x in [pt_j, pt_{j+1}) is y_j + ((x - x_j) * delta_j +
    32768) >> 16 with delta_j = dy * ((65536 + dx/2) // dx)."""
    b, p_max, _ = pts.shape
    x_j = pts[:, :, 0]  # (B, P)
    y_j = pts[:, :, 1]
    dx = jnp.diff(x_j, axis=1)  # (B, P-1)
    dy = jnp.diff(y_j, axis=1)
    dx_safe = jnp.maximum(dx, 1)
    delta = dy * ((65536 + (dx_safe >> 1)) // dx_safe)
    seg_valid = (jnp.arange(p_max - 1)[None, :] < (num[:, None] - 1)) & (dx > 0)

    shape = v.shape
    vflat = v.reshape(b, -1)  # (B, N)
    val = jnp.zeros_like(vflat)
    # accumulate one segment at a time (13 fused elementwise passes —
    # keeps peak memory at O(B*N) instead of O(B*P*N))
    for j in range(p_max - 1):
        in_seg = (
            (vflat >= x_j[:, j : j + 1])
            & (vflat < x_j[:, j + 1 : j + 2])
            & seg_valid[:, j : j + 1]
        )
        seg_val = y_j[:, j : j + 1] + (
            ((vflat - x_j[:, j : j + 1]) * delta[:, j : j + 1] + 32768) >> 16
        )
        val = jnp.where(in_seg, seg_val, val)
    below = vflat < x_j[:, :1]
    above = vflat >= jnp.take_along_axis(x_j, jnp.maximum(num - 1, 0)[:, None], axis=1)
    first_y = y_j[:, :1]
    last_y = jnp.take_along_axis(y_j, jnp.maximum(num - 1, 0)[:, None], axis=1)
    val = jnp.where(below, first_y, val)
    val = jnp.where(above, last_y, val)
    val = val * (num > 0)[:, None]
    return val.reshape(shape)


def scaling_lookup(
    v: jnp.ndarray,  # (B, h, w) pixel values
    pts: jnp.ndarray,
    num: jnp.ndarray,
    bit_depth: int,
) -> jnp.ndarray:
    """Spec scaling including high-bit-depth node interpolation."""
    maxval = (1 << bit_depth) - 1
    v = jnp.clip(v, 0, maxval)
    if bit_depth == 8:
        return _scaling_eval8(v, pts, num)
    shift = bit_depth - 8
    pad = 1 << shift
    idx = v >> shift
    rem = v & (pad - 1)
    a = _scaling_eval8(idx, pts, num)
    b_val = _scaling_eval8(jnp.minimum(idx + 1, 255), pts, num)
    interp = a + (((b_val - a) * rem + (pad >> 1)) >> shift)
    return jnp.where(idx >= 255, a, interp)


def scaling_luts(p: GrainParamsBatch, bit_depth: int) -> jnp.ndarray:
    """(B, 3, 2^bit_depth) int32 scaling LUTs for Y, Cb, Cr. Under
    chroma_scaling_from_luma the chroma rows repeat the luma curve."""
    n = 1 << bit_depth
    v = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (p.batch, 1, n))

    def lut(pts, num):
        return scaling_lookup(v, pts, num, bit_depth)[:, 0]

    lut_y = lut(p.pts_y, p.num_y)
    csfl = (p.csfl > 0)[:, None]
    lut_cb = jnp.where(csfl, lut_y, lut(p.pts_cb, p.num_cb))
    lut_cr = jnp.where(csfl, lut_y, lut(p.pts_cr, p.num_cr))
    return jnp.stack([lut_y, lut_cb, lut_cr], axis=1)


# ---------------------------------------------------------------------------
# Full application


def select_backend(platform: Optional[str] = None) -> str:
    """The grain implementation for a JAX platform (by default the
    first device's): "pallas" (the Triton kernels of grain_pallas) on
    "gpu", the plain XLA formulation everywhere else. Interpret mode is
    never chosen here; a caller asks for it with ``interpret=True``."""
    if platform is None:
        platform = jax.devices()[0].platform
    return "pallas" if platform == "gpu" else "xla"


def _avg_luma(y: jnp.ndarray, hc: int, wc: int, sub_x: int, sub_y: int) -> jnp.ndarray:
    """Chroma scaling input: horizontally averaged luma (spec 7.18.3.5;
    vertical subsampling takes the even rows only)."""
    w = y.shape[2]
    ly = y[:, :: 1 << sub_y, :][:, :hc, :]
    if sub_x:
        a = ly[:, :, 0 : 2 * wc : 2]
        if 2 * wc <= w:
            bb = ly[:, :, 1 : 2 * wc : 2]
        else:
            bb = jnp.concatenate([ly[:, :, 1::2], a[:, :, -1:]], axis=2)
        return (a + bb + 1) >> 1
    return ly[:, :, :wc]


@dataclass
class PreparedPatterns:
    """Host-generated grain patterns already resident on device.
    Produced by prepare_patterns(); consumed by apply_grain(prepared=...).
    Exists so callers can overlap batch N+1's pattern generation and
    upload with batch N's device work (double-buffering).

    The three per-plane patterns ride ONE packed int16 buffer
    (B, luma||cb||cr flattened), uploaded in one transfer and sliced
    back apart inside the consuming jit."""

    packed: jnp.ndarray  # (B, n_luma [+ n_cb + n_cr]) int16 on device
    chroma_shape: Optional[Tuple[int, int]]  # (ch, cw) or None
    chroma_static: bool  # some frame of the batch has chroma grain

    @property
    def luma(self) -> jnp.ndarray:
        return _unpack_patterns(self.packed, self.chroma_shape)[0]

    @property
    def cb(self) -> Optional[jnp.ndarray]:
        return _unpack_patterns(self.packed, self.chroma_shape)[1]

    @property
    def cr(self) -> Optional[jnp.ndarray]:
        return _unpack_patterns(self.packed, self.chroma_shape)[2]


def _unpack_patterns(packed, chroma_shape):
    """Slice the packed (B, n) pattern buffer back into (luma, cb, cr).
    Runs on device (inside the consuming jit) or on host numpy."""
    b = packed.shape[0]
    n_luma = GRAIN_H * GRAIN_W
    luma = packed[:, :n_luma].reshape(b, GRAIN_H, GRAIN_W)
    if chroma_shape is None:
        return luma, None, None
    ch, cw = chroma_shape
    n_c = ch * cw
    cb = packed[:, n_luma : n_luma + n_c].reshape(b, ch, cw)
    cr = packed[:, n_luma + n_c : n_luma + 2 * n_c].reshape(b, ch, cw)
    return luma, cb, cr


def _chroma_active(host_params, monochrome: bool) -> bool:
    """Whether any frame of the batch touches chroma (photon-noise
    tables without --chroma and many film tables are luma-only; their
    batches skip the chroma work entirely)."""
    return not monochrome and any(
        hp.chroma_scaling_from_luma
        or len(hp.scaling_points_cb) > 0
        or len(hp.scaling_points_cr) > 0
        for hp in host_params
    )


def prepare_patterns(
    host_params,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
) -> PreparedPatterns:
    """Generate grain patterns natively on host and start their upload.

    The upload (jnp.asarray) is asynchronous, so calling this for batch
    N+1 right after dispatching batch N hides the pattern stage behind
    the running device work."""
    from .grain_native import generate_patterns_native

    with jax.profiler.TraceAnnotation("grain/pattern_gen_native"):
        lp, cbp, crp = generate_patterns_native(
            host_params, bit_depth, sub_x, sub_y, monochrome
        )
    # all planes in ONE int16 buffer (grain values fit: |g| < 2^11 at
    # 12-bit), so a batch costs one host-to-device copy
    b = lp.shape[0]
    parts = [lp.reshape(b, -1)]
    chroma_shape = None
    if cbp is not None:
        chroma_shape = tuple(int(v) for v in cbp.shape[1:])
        parts += [cbp.reshape(b, -1), crp.reshape(b, -1)]
    with jax.profiler.TraceAnnotation("grain/pattern_upload"):
        packed = jnp.asarray(
            np.concatenate(parts, axis=1).astype(np.int16)
        )
    return PreparedPatterns(
        packed, chroma_shape, _chroma_active(host_params, monochrome)
    )


def apply_grain(
    y,
    cb,
    cr,
    p: GrainParamsBatch,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
    backend: Optional[str] = None,
    host_params=None,
    prepared: Optional[PreparedPatterns] = None,
    interpret: bool = False,
):
    """Apply film grain to a batch of frames. Returns (y', cb', cr').

    ``backend``: "pallas" (the Triton kernels, the GPU's path) or "xla"
    (the plain formulation); None picks select_backend(). With
    ``interpret=True`` the kernels run in Pallas interpret mode (tests
    on the CPU).

    ``host_params``: optional list of FilmGrainParams matching ``p``;
    when given, the grain patterns are generated by the native C++
    recurrence on host instead of the on-device scan, and a batch with
    no chroma grain skips the chroma planes.

    ``prepared``: a PreparedPatterns from prepare_patterns(), so the
    caller can overlap the next batch's pattern generation and upload
    with this batch's device work. When given, host_params is not
    consulted."""
    backend = backend or select_backend()
    if prepared is None and host_params is not None:
        prepared = prepare_patterns(host_params, bit_depth, sub_x, sub_y, monochrome)
    with jax.profiler.TraceAnnotation("grain/apply_dispatch"):
        if prepared is None:
            return apply_grain_batch(
                y, cb, cr, p, bit_depth, sub_x, sub_y, monochrome,
                backend=backend, interpret=interpret,
            )
        luma_only = monochrome or not prepared.chroma_static
        y_out, cb_out, cr_out = _apply_packed(
            y, None if luma_only else cb, None if luma_only else cr,
            prepared.packed, prepared.chroma_shape, p, bit_depth, sub_x,
            sub_y, luma_only, backend, interpret,
        )
        if luma_only and not monochrome:
            return y_out, cb, cr
        return y_out, cb_out, cr_out


@functools.partial(
    jax.jit,
    static_argnames=(
        "chroma_shape", "bit_depth", "sub_x", "sub_y", "monochrome",
        "backend", "interpret",
    ),
)
def _apply_packed(
    y, cb, cr, packed, chroma_shape, p: GrainParamsBatch, bit_depth: int,
    sub_x: int, sub_y: int, monochrome: bool, backend: str, interpret: bool,
):
    """apply_grain fed by PreparedPatterns.packed (unpacked on device)."""
    lp, cbp, crp = _unpack_patterns(packed, chroma_shape)
    return _apply_with_patterns(
        y, cb, cr, lp, cbp, crp, p, bit_depth, sub_x, sub_y, monochrome,
        backend, interpret,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "bit_depth", "sub_x", "sub_y", "monochrome", "backend", "interpret",
    ),
)
def apply_grain_batch(
    y: jnp.ndarray,  # (B, H, W) integer samples
    cb: Optional[jnp.ndarray],  # (B, Hc, Wc) or None
    cr: Optional[jnp.ndarray],
    p: GrainParamsBatch,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
    backend: str = "xla",
    interpret: bool = False,
):
    """Apply film grain with the patterns generated on device (GF(2)
    LFSR matrix powers + wavefront AR scan) inside the same jit.
    Returns (y', cb', cr')."""
    luma_pat, cb_pat, cr_pat = generate_patterns(
        p, bit_depth, sub_x, sub_y, monochrome
    )
    return _apply_with_patterns(
        y, cb, cr, luma_pat, cb_pat, cr_pat, p, bit_depth, sub_x, sub_y,
        monochrome, backend, interpret,
    )


def _apply_with_patterns(
    y, cb, cr, luma_pat, cb_pat, cr_pat, p, bit_depth, sub_x, sub_y,
    monochrome, backend, interpret,
):
    if backend == "pallas":
        return _apply_kernels(
            y, cb, cr, luma_pat, cb_pat, cr_pat, p, bit_depth, sub_x, sub_y,
            monochrome, interpret,
        )
    if backend != "xla":
        raise ValueError(f"unknown grain backend {backend!r}")
    return _apply_xla_with_patterns(
        y, cb, cr, luma_pat, cb_pat, cr_pat, p, bit_depth, sub_x, sub_y,
        monochrome,
    )


def _apply_kernels(
    y, cb, cr, luma_pat, cb_pat, cr_pat, p, bit_depth, sub_x, sub_y,
    monochrome, interpret,
):
    from . import grain_pallas as gp

    # frames and patterns ride device memory as int16 (every AV1 bit
    # depth fits); the kernels widen to int32 in registers
    y = y.astype(jnp.int16)
    b, h, w = y.shape
    # named scopes label the HLO so device traces split the cost into
    # offsets / luma / chroma stages
    with jax.named_scope("grain_offsets"):
        offs = block_offsets(
            p.seed, (h + BLOCK - 1) // BLOCK, (w + BLOCK - 1) // BLOCK
        )
        luts = scaling_luts(p, bit_depth)
        scalars = gp.pack_frame_scalars(p, bit_depth)
    with jax.named_scope("grain_luma"):
        y_out = gp.apply_luma(
            y, luma_pat.astype(jnp.int16), offs, luts, scalars, bit_depth,
            interpret=interpret,
        )
    if monochrome:
        return y_out, None, None
    with jax.named_scope("grain_planes"):
        cb_out, cr_out = gp.apply_chroma(
            y, cb.astype(jnp.int16), cr.astype(jnp.int16),
            cb_pat.astype(jnp.int16), cr_pat.astype(jnp.int16), offs, luts,
            scalars, bit_depth, sub_x, sub_y, interpret=interpret,
        )
    return y_out, cb_out, cr_out


def _lut_gather(lut: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """lut (B, N) at v (B, h, w)."""
    b = v.shape[0]
    return jnp.take_along_axis(lut, v.reshape(b, -1), axis=1).reshape(v.shape)


def _apply_xla_with_patterns(
    y: jnp.ndarray,
    cb: Optional[jnp.ndarray],
    cr: Optional[jnp.ndarray],
    luma_pat: jnp.ndarray,
    cb_pat: Optional[jnp.ndarray],
    cr_pat: Optional[jnp.ndarray],
    p: GrainParamsBatch,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
):
    """The plain formulation: whole-plane gathers and elementwise
    blends, left to XLA."""
    y = y.astype(jnp.int32)
    b, h, w = y.shape
    grain_center = 128 << (bit_depth - 8)
    gmin = jnp.full_like(p.seed, -grain_center)
    gmax = jnp.full_like(p.seed, grain_center - 1)
    maxval = (1 << bit_depth) - 1

    num_stripes = (h + BLOCK - 1) // BLOCK
    num_blocks = (w + BLOCK - 1) // BLOCK
    offs = block_offsets(p.seed, num_stripes, num_blocks)
    luts = scaling_luts(p, bit_depth)

    # ---- luma ----
    noise_y = _noise_plane(luma_pat, offs, h, w, 0, 0, p.overlap, gmin, gmax)
    scale_y = _lut_gather(luts[:, 0], jnp.clip(y, 0, maxval))
    ss = p.scaling_shift[:, None, None]
    noise = (scale_y * noise_y + (1 << (ss - 1))) >> ss
    lo = jnp.where(p.clip > 0, 16 << (bit_depth - 8), 0)[:, None, None]
    hi_y = jnp.where(p.clip > 0, 235 << (bit_depth - 8), maxval)[:, None, None]
    y_out = jnp.clip(y + noise, lo, hi_y)
    y_out = jnp.where((p.num_y > 0)[:, None, None], y_out, y)

    if monochrome:
        return y_out, None, None

    hc, wc = cb.shape[1], cb.shape[2]
    avg_luma = _avg_luma(y, hc, wc, sub_x, sub_y)

    hi_c = jnp.where(p.clip > 0, 240 << (bit_depth - 8), maxval)[:, None, None]

    def chroma_plane(src, pat, lut, mult, luma_mult, offset, num):
        src = src.astype(jnp.int32)
        noise_c = _noise_plane(
            pat, offs, hc, wc, sub_x, sub_y, p.overlap, gmin, gmax
        )
        combined = avg_luma * (luma_mult[:, None, None] - 128) + src * (
            mult[:, None, None] - 128
        )
        val_mult = jnp.clip(
            (combined >> 6) + ((offset[:, None, None] - 256) << (bit_depth - 8)),
            0,
            maxval,
        )
        use_csfl = (p.csfl > 0)[:, None, None]
        val = jnp.where(use_csfl, avg_luma, val_mult)
        scale = _lut_gather(lut, val)
        noise = (scale * noise_c + (1 << (ss - 1))) >> ss
        out = jnp.clip(src + noise, lo, hi_c)
        active = ((num > 0) | (p.csfl > 0))[:, None, None]
        return jnp.where(active, out, src)

    cb_out = chroma_plane(
        cb, cb_pat, luts[:, 1], p.cb_mult, p.cb_luma_mult, p.cb_offset, p.num_cb
    )
    cr_out = chroma_plane(
        cr, cr_pat, luts[:, 2], p.cr_mult, p.cr_luma_mult, p.cr_offset, p.num_cr
    )
    return y_out, cb_out, cr_out
