"""Pallas kernels (Triton route) for the film-grain hot path on the GPU.

Two kernels apply grain in one pass over the frame: one for luma and
one for the Cb/Cr pair. Each program owns one (frame, stripe, column
tile) block: a stripe is the spec's 32-luma-row band (16 chroma rows
at 4:2:0) and a tile is ``TILE_W`` samples wide. A program

- loads its pixels once (masked at the ragged right and bottom edges);
- gathers each pixel's grain straight from the frame's int16 pattern
  (73x82 luma, about 12 KB, which stays in L1): the current block's
  window plus the left, top and top-left neighbours' continuation
  samples that the spec's overlap blend needs;
- blends, scales through the frame's scaling LUT (one gather), rounds
  and clips, and stores the result once.

The per-block offset randoms and the per-frame scalars are ordinary
int32 inputs that every program loads for itself. The chroma kernel
shares one set of offset gathers and one averaged-luma computation
(two strided luma loads) between Cb and Cr.

Bit-exact against grain_ref (dav1d-validated). The CPU tests run these
kernels with ``interpret=True``; on the GPU they compile through
Triton.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .grain_jax import BLOCK

# columns per program (a power of two, as Triton blocks must be) and
# warps per program: the fastest of TILE_W in {64, 128, 256} x warps in
# {2, 4, 8} at 4K10 batch 16 on an H100 (PERF.md)
TILE_W = 64
_COMPILER_PARAMS = plgpu.CompilerParams(num_warps=4, num_stages=1)

# per-frame int32 scalars (pack_frame_scalars), one row per frame
F_SHIFT = 0  # scaling_shift
F_OVERLAP = 1
F_LO = 2  # clip floor, all planes
F_HI_Y = 3
F_HI_C = 4
F_ACTIVE = 5  # 5, 6, 7: y, cb, cr
F_USE_MULT = 8  # chroma input = (mult, luma_mult, offset) mix, not avg luma
F_MULT = 9  # 9..11 cb mult/luma_mult/offset, 12..14 cr


def pack_frame_scalars(p, bit_depth: int) -> jnp.ndarray:
    """(B, 15) int32 per-frame scalars read by the kernels."""
    maxval = (1 << bit_depth) - 1
    clip = p.clip > 0
    csfl = p.csfl > 0
    cols = [
        p.scaling_shift,
        p.overlap,
        jnp.where(clip, 16 << (bit_depth - 8), 0),
        jnp.where(clip, 235 << (bit_depth - 8), maxval),
        jnp.where(clip, 240 << (bit_depth - 8), maxval),
        p.num_y > 0,
        csfl | (p.num_cb > 0),
        csfl | (p.num_cr > 0),
        ~csfl,
        p.cb_mult, p.cb_luma_mult, p.cb_offset,
        p.cr_mult, p.cr_luma_mult, p.cr_offset,
    ]
    return jnp.stack([jnp.asarray(c).astype(jnp.int32) for c in cols], axis=1)


def _offset_xy(offs_ref, b, stripe, block, sub_x: int, sub_y: int):
    """Pattern origin of a block's window from its 8-bit offset random."""
    rand = offs_ref[b, stripe, block]
    ox = 3 + (2 >> sub_x) * (3 + (rand >> 4))
    oy = 3 + (2 >> sub_y) * (3 + (rand & 15))
    return ox, oy


def _noise(pat_refs, offs_ref, b, s, rowpos, col, nb: int, overlap, gmin, gmax,
           sub_x: int, sub_y: int):
    """(R, C) blended grain for each pattern in ``pat_refs``.

    ``rowpos`` (R, 1) is the row inside the stripe, ``col`` (1, C) the
    plane column. Neighbour samples are gathered at in-bounds indices
    for every pixel (rows and columns past the overlap band reuse the
    band's last index) and discarded by the blend masks, so no load
    needs a mask."""
    bw_log = 5 - sub_x
    bw = 1 << bw_log
    bh = BLOCK >> sub_y
    ov_c = 2 >> sub_x
    ov_r = 2 >> sub_y
    shape = (rowpos.shape[0], col.shape[1])
    blk = col >> bw_log
    colpos = col & (bw - 1)
    blk_c = jnp.minimum(blk, nb - 1)
    blk_l = jnp.maximum(blk_c - 1, 0)
    s_t = jnp.maximum(s - 1, 0)
    r_ov = jnp.minimum(rowpos, ov_r - 1)
    c_ov = jnp.minimum(colpos, ov_c - 1)
    # (stripe, block, row in window, column in window) of cur/left/top/tl
    windows = (
        (s, blk_c, rowpos, colpos),
        (s, blk_l, rowpos, bw + c_ov),
        (s_t, blk_c, bh + r_ov, colpos),
        (s_t, blk_l, bh + r_ov, bw + c_ov),
    )
    idx = []
    for stripe, block, dy, dx in windows:
        ox, oy = _offset_xy(offs_ref, b, stripe, block, sub_x, sub_y)
        idx.append(
            (jnp.broadcast_to(oy + dy, shape), jnp.broadcast_to(ox + dx, shape))
        )

    if sub_x:
        wx_old = jnp.where(colpos == 0, 23, 0)
        wx_new = jnp.where(colpos == 0, 22, 32)
    else:
        wx_old = jnp.where(colpos == 0, 27, jnp.where(colpos == 1, 17, 0))
        wx_new = jnp.where(colpos == 0, 17, jnp.where(colpos == 1, 27, 32))
    if sub_y:
        wy_old = jnp.where(rowpos == 0, 23, 0)
        wy_new = jnp.where(rowpos == 0, 22, 32)
    else:
        wy_old = jnp.where(rowpos == 0, 27, jnp.where(rowpos == 1, 17, 0))
        wy_new = jnp.where(rowpos == 0, 17, jnp.where(rowpos == 1, 27, 32))
    ov = overlap > 0
    h_sel = ov & (blk > 0) & (colpos < ov_c)
    v_sel = ov & (s > 0) & (rowpos < ov_r)

    def blend(old, new, w_old, w_new):
        return jnp.clip((old * w_old + new * w_new + 16) >> 5, gmin, gmax)

    out = []
    for pat_ref in pat_refs:
        cur, left, top, tl = (
            pat_ref[b, iy, ix].astype(jnp.int32) for iy, ix in idx
        )
        cur_h = jnp.where(h_sel, blend(left, cur, wx_old, wx_new), cur)
        top_h = jnp.where(h_sel, blend(tl, top, wx_old, wx_new), top)
        out.append(jnp.where(v_sel, blend(top_h, cur_h, wy_old, wy_new), cur_h))
    return out


def _grained(src, val, noise, lut_ref, b, plane: int, f_ref, hi_col: int):
    """Scale ``noise`` by the LUT at ``val``, add, clip; inactive planes
    pass through."""
    scale = lut_ref[b, plane, val]
    ss = f_ref[b, F_SHIFT]
    out = jnp.clip(
        src + ((scale * noise + (1 << (ss - 1))) >> ss),
        f_ref[b, F_LO],
        f_ref[b, hi_col],
    )
    return jnp.where(f_ref[b, F_ACTIVE + plane] > 0, out, src)


def _tile(s, t, rows: int):
    rowpos = jax.lax.broadcasted_iota(jnp.int32, (rows, 1), 0)
    col = t * TILE_W + jax.lax.broadcasted_iota(jnp.int32, (1, TILE_W), 1)
    return rowpos, col, (pl.ds(s * rows, rows), pl.ds(t * TILE_W, TILE_W))


def _luma_kernel(y_ref, pat_ref, offs_ref, lut_ref, f_ref, out_ref, *,
                 h, w, nb, bit_depth):
    b, s, t = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    rowpos, col, win = _tile(s, t, BLOCK)
    inside = (s * BLOCK + rowpos < h) & (col < w)
    src = plgpu.load(y_ref.at[b, *win], mask=inside, other=0).astype(jnp.int32)
    grain_center = 128 << (bit_depth - 8)
    (noise,) = _noise(
        (pat_ref,), offs_ref, b, s, rowpos, col, nb, f_ref[b, F_OVERLAP],
        -grain_center, grain_center - 1, 0, 0,
    )
    out = _grained(src, src, noise, lut_ref, b, 0, f_ref, F_HI_Y)
    plgpu.store(out_ref.at[b, *win], out.astype(out_ref.dtype), mask=inside)


def _chroma_kernel(y_ref, cb_ref, cr_ref, cbpat_ref, crpat_ref, offs_ref,
                   lut_ref, f_ref, cbo_ref, cro_ref, *,
                   h, w, hc, wc, nb, bit_depth, sub_x, sub_y):
    b, s, t = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    bh = BLOCK >> sub_y
    rowpos, col, win = _tile(s, t, bh)
    rows = s * bh + rowpos
    inside = (rows < hc) & (col < wc)
    maxval = (1 << bit_depth) - 1
    grain_center = 128 << (bit_depth - 8)
    # chroma scaling input: collocated luma, horizontally averaged
    # under 4:2:x (an odd width repeats the last luma column)
    shape = (bh, TILE_W)
    lr = jnp.broadcast_to(jnp.minimum(rows << sub_y, h - 1), shape)
    if sub_x:
        a = y_ref[b, lr, jnp.broadcast_to(jnp.minimum(2 * col, w - 1), shape)]
        c = y_ref[b, lr, jnp.broadcast_to(jnp.minimum(2 * col + 1, w - 1), shape)]
        avg = (a.astype(jnp.int32) + c.astype(jnp.int32) + 1) >> 1
    else:
        avg = y_ref[b, lr, jnp.broadcast_to(jnp.minimum(col, w - 1), shape)]
        avg = avg.astype(jnp.int32)
    noises = _noise(
        (cbpat_ref, crpat_ref), offs_ref, b, s, rowpos, col, nb,
        f_ref[b, F_OVERLAP], -grain_center, grain_center - 1, sub_x, sub_y,
    )
    planes = ((cb_ref, cbo_ref), (cr_ref, cro_ref))
    for k, ((src_ref, out_ref), noise) in enumerate(zip(planes, noises)):
        src = plgpu.load(src_ref.at[b, *win], mask=inside, other=0)
        src = src.astype(jnp.int32)
        m = F_MULT + 3 * k
        combined = (
            avg * (f_ref[b, m + 1] - 128) + src * (f_ref[b, m] - 128)
        )
        mixed = jnp.clip(
            (combined >> 6) + ((f_ref[b, m + 2] - 256) << (bit_depth - 8)),
            0, maxval,
        )
        val = jnp.where(f_ref[b, F_USE_MULT] > 0, mixed, avg)
        out = _grained(src, val, noise, lut_ref, b, 1 + k, f_ref, F_HI_C)
        plgpu.store(out_ref.at[b, *win], out.astype(out_ref.dtype), mask=inside)


@functools.partial(jax.jit, static_argnames=("bit_depth", "interpret"))
def apply_luma(y, pattern, offsets, lut, scalars, bit_depth: int,
               interpret: bool = False):
    """Grain on a (B, H, W) int16 luma batch.

    ``pattern`` (B, 73, 82) int16, ``offsets`` (B, S, NB) int32 block
    randoms, ``lut`` (B, 3, 2^bit_depth) int32 scaling LUTs (plane 0
    used), ``scalars`` pack_frame_scalars."""
    b, h, w = y.shape
    s_count, nb = offsets.shape[1], offsets.shape[2]
    kernel = functools.partial(
        _luma_kernel, h=h, w=w, nb=nb, bit_depth=bit_depth
    )
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(y.shape, y.dtype),
        grid=(b, s_count, pl.cdiv(w, TILE_W)),
        backend="triton",
        name="grain_luma",
        compiler_params=_COMPILER_PARAMS,
        interpret=interpret,
    )(y, pattern, offsets, lut, scalars)


@functools.partial(
    jax.jit, static_argnames=("bit_depth", "sub_x", "sub_y", "interpret")
)
def apply_chroma(y, cb, cr, cb_pat, cr_pat, offsets, lut, scalars,
                 bit_depth: int, sub_x: int, sub_y: int,
                 interpret: bool = False):
    """Grain on a (B, Hc, Wc) int16 Cb/Cr batch; ``y`` is the source
    luma (the chroma scaling input), ``lut`` planes 1 and 2 apply."""
    b, h, w = y.shape
    hc, wc = cb.shape[1], cb.shape[2]
    s_count, nb = offsets.shape[1], offsets.shape[2]
    kernel = functools.partial(
        _chroma_kernel, h=h, w=w, hc=hc, wc=wc, nb=nb, bit_depth=bit_depth,
        sub_x=sub_x, sub_y=sub_y,
    )
    return pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct(cb.shape, cb.dtype),
            jax.ShapeDtypeStruct(cr.shape, cr.dtype),
        ),
        grid=(b, s_count, pl.cdiv(wc, TILE_W)),
        backend="triton",
        name="grain_chroma",
        compiler_params=_COMPILER_PARAMS,
        interpret=interpret,
    )(y, cb, cr, cb_pat, cr_pat, offsets, lut, scalars)
