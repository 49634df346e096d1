"""Float64 numpy reference for the diff statistics of diff_estimate.

The device reduction sums float32 products in an order of its own; this
module computes the same Gram matrix, right-hand side, pixel count and
binned residual moments in float64, plainly, so tests and chip_smoke.py
can hold the device to rtol 1e-5. The flat mask (a threshold decision,
not a sum) is an input: callers take it from diff_estimate._flat_mask.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .diff_estimate import NUM_BINS, _lag_offsets


def chroma_aux(src_y, den_y, hc: int, wc: int, sub_x: int, sub_y: int):
    """(hc, wc) collocated luma residual averaged over each chroma
    sample's subsampling block (edge-replicated past the frame)."""
    r = np.asarray(src_y, np.float64) - np.asarray(den_y, np.float64)
    need_h, need_w = hc << sub_y, wc << sub_x
    h, w = r.shape
    r = np.pad(r, ((0, max(0, need_h - h)), (0, max(0, need_w - w))), mode="edge")
    r = r[:need_h, :need_w].reshape(hc, 1 << sub_y, wc, 1 << sub_x)
    return r.mean(axis=(1, 3))


def plane_stats(
    src, den, mask, lag: int, bit_depth: int, aux: Optional[np.ndarray] = None
) -> Dict[str, np.ndarray]:
    """One plane's statistics: ata/atb of the masked lag-window normal
    equations (plus the ``aux`` column when given), n_ar, and the
    per-intensity-bin count, sum and sum of squares of the residual."""
    den = np.asarray(den, np.int64)
    r = np.asarray(src, np.float64) - den
    m = np.asarray(mask, np.float64)
    h, w = r.shape
    pad = lag
    sel = m[pad : h - pad, pad : w - pad] > 0
    cols = [
        r[pad + dr : h - pad + dr, pad + dc : w - pad + dc][sel]
        for dr, dc in _lag_offsets(lag)
    ]
    if aux is not None:
        cols.append(np.asarray(aux, np.float64)[pad : h - pad, pad : w - pad][sel])
    x = np.stack(cols)
    r0 = r[pad : h - pad, pad : w - pad][sel]

    maxval = (1 << bit_depth) - 1
    bins = np.clip(den * NUM_BINS // (maxval + 1), 0, NUM_BINS - 1).ravel()
    mv = m.ravel()
    rv = r.ravel()
    return dict(
        ata=x @ x.T,
        atb=x @ r0,
        n_ar=np.float64(sel.sum()),
        bin_cnt=np.bincount(bins, mv, NUM_BINS),
        bin_sum=np.bincount(bins, mv * rv, NUM_BINS),
        bin_sumsq=np.bincount(bins, mv * rv * rv, NUM_BINS),
    )


def max_rel_err(got: Dict, want: Dict) -> float:
    """Largest |got - want| over each statistic's largest |want|."""
    worst = 0.0
    for k, v in want.items():
        g = np.asarray(got[k], np.float64)
        scale = max(float(np.abs(v).max()), 1.0)
        worst = max(worst, float(np.abs(g - v).max()) / scale)
    return worst
