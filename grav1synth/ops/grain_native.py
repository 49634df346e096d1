"""Host-side AV1 grain pattern generation in native code.

The patterns are tiny (73x82 luma, 38x44 chroma at 4:2:0) but their AR
filter is a sequential recurrence, so they are generated here, in C++
(container/native/gravpattern.cpp, built on first use with the system
compiler and no other library), and uploaded; the per-pixel work runs
on the device. Bit-exact with grain_ref (dav1d-validated).
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess

import numpy as np

from .tables_data import GAUSSIAN_SEQUENCE

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "container",
    "native",
)


class GravGrainParamsC(C.Structure):
    _fields_ = [
        ("seed", C.c_int32),
        ("num_y_points", C.c_int32),
        ("num_cb_points", C.c_int32),
        ("num_cr_points", C.c_int32),
        ("chroma_scaling_from_luma", C.c_int32),
        ("ar_coeff_lag", C.c_int32),
        ("ar_coeff_shift", C.c_int32),
        ("grain_scale_shift", C.c_int32),
        ("ar_coeffs_y", C.c_int32 * 24),
        ("ar_coeffs_cb", C.c_int32 * 25),
        ("ar_coeffs_cr", C.c_int32 * 25),
    ]


_lib = None


def _load() -> C.CDLL:
    """Load (building on demand) the pattern library."""
    global _lib
    if _lib is not None:
        return _lib
    # make is a no-op when the .so is newer than the source
    subprocess.run(
        ["make", "-C", _NATIVE_DIR, "libgravpattern.so"],
        check=True,
        capture_output=True,
    )
    lib = C.CDLL(os.path.join(_NATIVE_DIR, "libgravpattern.so"))
    lib.grav_set_gaussian_table.argtypes = [C.POINTER(C.c_int16)]
    lib.grav_set_gaussian_table.restype = None
    lib.grav_generate_grain_patterns.argtypes = [
        C.POINTER(GravGrainParamsC),
        C.c_int,
        C.c_int,
        C.c_int,
        C.c_int,
        C.c_int,
        C.POINTER(C.c_int32),
        C.POINTER(C.c_int32),
        C.POINTER(C.c_int32),
    ]
    lib.grav_generate_grain_patterns.restype = C.c_int
    table = np.ascontiguousarray(GAUSSIAN_SEQUENCE, dtype=np.int16)
    lib.grav_set_gaussian_table(table.ctypes.data_as(C.POINTER(C.c_int16)))
    _lib = lib
    return lib


def generate_patterns_native(
    params_list,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
):
    """Generate AV1 grain patterns for a batch of FilmGrainParams on the
    host (native AR recurrence; bit-exact with ops/grain_ref). Returns
    (luma (n,73,82) int32, cb, cr) with cb/cr None when monochrome."""
    lib = _load()
    n = len(params_list)
    arr = (GravGrainParamsC * n)()
    for i, p in enumerate(params_list):
        s = arr[i]
        s.seed = p.grain_seed
        s.num_y_points = len(p.scaling_points_y)
        s.num_cb_points = len(p.scaling_points_cb)
        s.num_cr_points = len(p.scaling_points_cr)
        s.chroma_scaling_from_luma = int(p.chroma_scaling_from_luma)
        s.ar_coeff_lag = p.ar_coeff_lag
        s.ar_coeff_shift = p.ar_coeff_shift
        s.grain_scale_shift = p.grain_scale_shift
        for j, c in enumerate(p.ar_coeffs_y[:24]):
            s.ar_coeffs_y[j] = c
        for j, c in enumerate(p.ar_coeffs_cb[:25]):
            s.ar_coeffs_cb[j] = c
        for j, c in enumerate(p.ar_coeffs_cr[:25]):
            s.ar_coeffs_cr[j] = c
    luma = np.zeros((n, 73, 82), np.int32)
    if monochrome:
        cb = cr = None
        cb_ptr = cr_ptr = None
    else:
        cw = 44 if sub_x else 82
        ch = 38 if sub_y else 73
        cb = np.zeros((n, ch, cw), np.int32)
        cr = np.zeros((n, ch, cw), np.int32)
        cb_ptr = cb.ctypes.data_as(C.POINTER(C.c_int32))
        cr_ptr = cr.ctypes.data_as(C.POINTER(C.c_int32))
    ret = lib.grav_generate_grain_patterns(
        arr,
        n,
        bit_depth,
        sub_x,
        sub_y,
        int(monochrome),
        luma.ctypes.data_as(C.POINTER(C.c_int32)),
        cb_ptr,
        cr_ptr,
    )
    if ret != 0:
        raise RuntimeError(f"grain pattern generation failed ({ret})")
    return luma, cb, cr
