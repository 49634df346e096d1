"""Smoke test of grav1synth on an NVIDIA GPU, through its entry points.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the render loop on 4 devices and
                                       # the 4-way diff mesh, against one

Phases (one card):

0. Refuse anything but a GPU; print the card's name and power limit.
1. Build the native grain pattern generator from the committed source.
2. Compile every device function at 4K10 (3840x2160, 10-bit, 4:2:0)
   and 1080p8 and print its memory_analysis(). Bit-compare the grain
   kernels with grain_ref on mixed tables; hold the diff statistics to
   a float64 numpy computation (rtol 1e-5) and the fitted tables to
   equality. Time the kernels and the plain XLA versions.
3. The render loop (pipelines.render_frames, batch 16) on 48 4K10
   frames made from --seed with the grain tables of the committed
   stream looped to 48 frames, bit-compared with grain_ref; CLI
   `generate`, `inspect`, `remove` on that stream; the diff loop
   (DiffEstimator.diff_batch, batch 16) on the rendered frames against
   the grain-free ones, checked as in phase 2. (`render` and `diff`
   decode with libav*/dav1d, which the GPU machine this script targets
   does not have, so they run here below the decoder.)

Every failure raises. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".bench_cache", "smoke")
STREAM = os.path.join(REPO, ".bench_cache", "bench_4k10_grainy.ivf")
LOOPS = 8  # 6-frame GOP x 8 = 48 frames
BATCH = 16
RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# phase 0 / 1


def require_gpu():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    for line in smi.splitlines():
        log(f"card: {line}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    return devs


def build_native() -> None:
    native = os.path.join(REPO, "grav1synth", "container", "native")
    t0 = time.time()
    subprocess.run(
        ["make", "-B", "-C", native, "libgravpattern.so"],
        check=True, capture_output=True,
    )
    log(f"phase 1: pattern generator built in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# helpers


def _mixed_params(n: int):
    """n frames of tables cycling base / overlap off / chroma from luma /
    restricted range, each with its own seed."""
    import bench  # noqa: F401  (puts tests/ on sys.path)
    from av1_builder import sample_grain_params

    base = sample_grain_params(seed=777)
    out = []
    for i in range(n):
        p = copy.deepcopy(base)
        p.grain_seed = (777 + i * 10063) & 0xFFFF
        kind = i % 4
        if kind == 1:
            p.overlap_flag = False
        elif kind == 2:
            p.chroma_scaling_from_luma = True
            p.scaling_points_cb = []
            p.scaling_points_cr = []
        elif kind == 3:
            p.clip_to_restricted_range = True
        out.append(p)
    return out


def _frames(b: int, h: int, w: int, bit_depth: int, seed: int):
    """Smooth gradient content plus mild noise, 4:2:0, int16."""
    import numpy as np

    rng = np.random.default_rng(seed)
    maxv = (1 << bit_depth) - 1
    base = (
        np.linspace(0, 0.85 * maxv, w)[None, :]
        + np.linspace(0, 0.1 * maxv, h)[:, None]
    )
    y = np.empty((b, h, w), np.int16)
    for i in range(b):
        y[i] = np.clip(base + rng.normal(0, 1.5, (h, w)) + i, 0, maxv)
    hc, wc = (h + 1) // 2, (w + 1) // 2
    cb = np.clip(rng.normal(maxv / 2, 2, (b, hc, wc)), 0, maxv).astype(np.int16)
    cr = np.clip(rng.normal(maxv / 2 + 8, 2, (b, hc, wc)), 0, maxv).astype(np.int16)
    return y, cb, cr


def _memory(name: str, compiled) -> None:
    m = compiled.memory_analysis()
    log(
        f"  {name}: memory_analysis temp={m.temp_size_in_bytes / 1e6:.1f} MB "
        f"args={m.argument_size_in_bytes / 1e6:.1f} MB "
        f"out={m.output_size_in_bytes / 1e6:.1f} MB"
    )


def _time(fn, reps: int = 10) -> float:
    """Seconds per call of ``fn`` (blocking on each result), after one
    warm-up call."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------------------
# phase 2: grain


def grain_phase(tag: str, h: int, w: int, bit_depth: int, n_check: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from grav1synth.ops import grain_jax, grain_ref

    params = _mixed_params(BATCH)
    y, cb, cr = _frames(BATCH, h, w, bit_depth, seed=h)
    pb = grain_jax.pack_params(params)
    prep = grain_jax.prepare_patterns(params, bit_depth, 1, 1, False)
    dy, dcb, dcr = (jnp.asarray(a) for a in (y, cb, cr))

    results = {}
    for backend in ("pallas", "xla"):
        fn = jax.jit(
            lambda a, b_, c, packed, p, backend=backend: grain_jax._apply_packed(
                a, b_, c, packed, prep.chroma_shape, p, bit_depth, 1, 1,
                False, backend, False,
            )
        )
        t0 = time.time()
        compiled = fn.lower(dy, dcb, dcr, prep.packed, pb).compile()
        log(f"  grain {backend} {tag} B={BATCH}: compiled in {time.time() - t0:.1f} s")
        _memory(f"grain {backend} {tag}", compiled)
        out = [np.asarray(o) for o in compiled(dy, dcb, dcr, prep.packed, pb)]
        sec = _time(lambda: compiled(dy, dcb, dcr, prep.packed, pb))
        log(
            f"  grain {backend} {tag} B={BATCH}: {sec * 1e3:.3f} ms/batch "
            f"= {BATCH / sec:.1f} frames/s (host clock, block_until_ready)"
        )
        results[backend] = (out, sec)

    kern, plain = results["pallas"][0], results["xla"][0]
    for pi in range(3):
        bad = int((kern[pi].astype(np.int64) != plain[pi].astype(np.int64)).sum())
        check(bad == 0, f"grain {tag}: kernel vs plain plane {pi}: {bad} differ")
    for i in range(n_check):
        ref = grain_ref.apply_grain_frame(
            [y[i].astype(np.int32), cb[i].astype(np.int32), cr[i].astype(np.int32)],
            params[i], bit_depth, 1, 1,
        )
        for pi in range(3):
            bad = int((kern[pi][i].astype(np.int64) != ref[pi].astype(np.int64)).sum())
            check(bad == 0, f"grain {tag} frame {i} plane {pi}: {bad} differ from grain_ref")
    log(
        f"phase 2: grain {tag}: 0 mismatching samples vs grain_ref on "
        f"{n_check} frames x 3 planes (mixed tables), kernel == plain on "
        f"all {BATCH}; kernel {results['pallas'][1] * 1e3:.3f} ms vs plain "
        f"{results['xla'][1] * 1e3:.3f} ms per batch"
    )
    return y, cb, cr, kern


# ---------------------------------------------------------------------------
# diff statistics


def reference_stats(src, den, lag: int, bit_depth: int):
    """Float64 statistics of one frame pair (plane lists), as
    diff_estimate reduces them on the device."""
    import jax.numpy as jnp
    import numpy as np

    from grav1synth.ops import diff_ref
    from grav1synth.ops.diff_estimate import _flat_mask

    def mask(d):
        return np.asarray(_flat_mask(jnp.asarray(np.asarray(d, np.int32))))

    y = diff_ref.plane_stats(src[0], den[0], mask(den[0]), lag, bit_depth)
    if len(src) < 3:
        return y, None, None
    h, w = src[0].shape
    hc, wc = src[1].shape
    aux = diff_ref.chroma_aux(
        src[0], den[0], hc, wc, int(wc < w), int(hc < h)
    )
    return y, *(
        diff_ref.plane_stats(src[k], den[k], mask(den[k]), lag, bit_depth, aux=aux)
        for k in (1, 2)
    )


def _stats_of(out, i):
    return [None if d is None else {k: v[i] for k, v in d.items()} for d in out]


def check_stats(tag: str, got_frames, want_frames) -> float:
    from grav1synth.ops import diff_ref

    worst = 0.0
    for got, want in zip(got_frames, want_frames):
        for g, w_ in zip(got, want):
            if w_ is not None:
                worst = max(worst, diff_ref.max_rel_err(g, w_))
    check(worst < RTOL, f"diff {tag}: stats off by {worst:.3g} (> {RTOL})")
    return worst


def tables_equal(tag: str, est_dev, est_ref) -> None:
    a, b = est_dev.finish(), est_ref.finish()
    check(len(a) > 0, f"diff {tag}: no grain fitted")
    check(
        [(s.start_time, s.end_time, s.params) for s in a]
        == [(s.start_time, s.end_time, s.params) for s in b],
        f"diff {tag}: device and float64 tables differ",
    )
    log(f"  diff {tag}: {len(a)} segment(s), device table == float64 table")


def diff_stats_phase(tag: str, src, den, bit_depth: int, n_ref: int):
    """Compile + memory + time of batch_pair_stats_per_frame on a batch,
    and its agreement with float64 on the first n_ref frames; returns
    both sets of per-frame statistics."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from grav1synth.ops.diff_estimate import batch_pair_stats_per_frame

    args = [jnp.asarray(a) for a in (src[0], den[0], src[1], den[1], src[2], den[2])]
    fn = jax.jit(
        lambda *a: batch_pair_stats_per_frame(
            *a, lag=2, bit_depth=bit_depth, sub_x=1, sub_y=1, has_chroma=True
        )
    )
    t0 = time.time()
    compiled = fn.lower(*args).compile()
    b = src[0].shape[0]
    log(f"  diff stats {tag} B={b}: compiled in {time.time() - t0:.1f} s")
    _memory(f"diff stats {tag}", compiled)
    out = jax.device_get(compiled(*args))
    sec = _time(lambda: compiled(*args), reps=5)
    log(
        f"  diff stats {tag} B={b}: {sec * 1e3:.3f} ms/batch = {b / sec:.1f} "
        f"frames/s (host clock, block_until_ready)"
    )
    got = [_stats_of(out, i) for i in range(n_ref)]
    want = [
        reference_stats([p[i] for p in src], [p[i] for p in den], 2, bit_depth)
        for i in range(n_ref)
    ]
    worst = check_stats(tag, got, want)
    log(f"  diff stats {tag}: max rel err vs float64 {worst:.3g} on {n_ref} frames")
    return got, want


def phase2():
    import numpy as np

    from grav1synth.ops.diff_estimate import DiffEstimator

    y, cb, cr, grainy = grain_phase("4k10", 2160, 3840, 10, n_check=4)
    grain_phase("1080p8", 1080, 1920, 8, n_check=4)

    # diff statistics on the engine's own grain: grainy vs clean
    got, want = diff_stats_phase("4k10", grainy, (y, cb, cr), 10, n_ref=BATCH)
    est_dev = DiffEstimator((30, 1), 10, 10)
    est_ref = DiffEstimator((30, 1), 10, 10)
    for g, w_ in zip(got, want):
        est_dev.add_frame_stats(*g)
        est_ref.add_frame_stats(*w_)
    tables_equal("4k10", est_dev, est_ref)

    y8, cb8, cr8 = _frames(2 * BATCH, 1080, 1920, 8, seed=8)
    noisy = [
        np.clip(a + np.random.default_rng(k).normal(0, 3, a.shape), 0, 255).astype(
            np.int16
        )
        for k, a in enumerate((y8, cb8, cr8))
    ]
    diff_stats_phase("1080p8", noisy, (y8, cb8, cr8), 8, n_ref=2)
    log("phase 2: ok")


# ---------------------------------------------------------------------------
# phase 3: render and diff loops below the decoder, CLI on the stream
#
# The card's machine has no libav*/dav1d, so `render` and `diff` cannot
# decode there. Phase 3 feeds their device loops (pipelines.render_frames,
# DiffEstimator.diff_batch) 4K10 frames made from --seed, paired with
# the grain tables parsed from the committed stream, and runs the CLI
# subcommands that need no decoder on that stream.


def _sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def looped_stream() -> str:
    from bench import _looped_ivf

    os.makedirs(WORK, exist_ok=True)
    return _looped_ivf(STREAM, os.path.join(WORK, f"4k10_x{LOOPS}.ivf"), LOOPS)


def stream_params(path: str):
    """Effective grain params of each shown frame, as render resolves
    them from the frame headers."""
    from grav1synth.pipelines import GrainFrameState, VideoFile
    from grav1synth.obu import Av1Parser

    parser, state, out = Av1Parser(), GrainFrameState(), []
    with VideoFile(path) as vf:
        for pkt in vf.packets():
            for obu in parser.parse_packet(pkt.data, pkt.av1_ts):
                if obu.frame is not None and not obu.is_redundant_frame_header:
                    shown, params = state.frame_params(obu.frame)
                    if shown:
                        out.append(params)
    return out


def seeded_frames(n: int, seed: int):
    """n 4K10 4:2:0 frames: a drifting gradient plus low noise."""
    import numpy as np

    from grav1synth.container.ffshim import Frame

    rng = np.random.default_rng(seed)
    h, w = 2160, 3840
    ramp = (np.arange(w, dtype=np.int32) * 870 // w)[None, :] + (
        np.arange(h, dtype=np.int32) * 100 // h
    )[:, None]
    frames = []
    for i in range(n):
        y = ramp + rng.integers(-2, 3, (h, w), dtype=np.int32) + i
        c = [
            512 + 16 * k + rng.integers(-2, 3, (h // 2, w // 2), dtype=np.int32)
            for k in range(2)
        ]
        frames.append(Frame(
            planes=[np.clip(p, 0, 1023).astype(np.uint16) for p in [y, *c]],
            bit_depth=10, subsampling=(1, 1), pts=i,
        ))
    return frames


def cli(*argv: str) -> float:
    from grav1synth import cli as grav_cli

    t0 = time.time()
    rc = grav_cli.main(list(argv))
    check(rc == 0, f"grav1synth {' '.join(argv)}: exit {rc}")
    return time.time() - t0


def _pool():
    from concurrent.futures import ThreadPoolExecutor

    return ThreadPoolExecutor(max(1, min(16, (os.cpu_count() or 2) - 2)))


def render(frames, params, shards: int, check_ref: bool = True) -> str:
    """render_frames at --batch BATCH on ``shards`` devices; with
    ``check_ref`` every output frame is bit-compared with grain_ref."""
    import numpy as np

    from grav1synth.container.y4m import iter_y4m
    from grav1synth.ops import grain_ref
    from grav1synth.pipelines import render_frames

    out = os.path.join(WORK, f"render_s{shards}.y4m")
    t0 = time.time()
    n = render_frames(
        zip(frames, params), out, (30, 1), batch=BATCH, shards=shards
    )
    t_loop = time.time() - t0
    check(n == len(frames), f"render wrote {n} of {len(frames)} frames")
    log(
        f"  render loop --shards {shards}: {n} frames 4K10 in {t_loop:.2f} s "
        f"= {n / t_loop:.2f} frames/s (smoke run, not the benchmark)"
    )
    if check_ref:
        def mismatches(args):
            got, frame, p = args
            ref = grain_ref.apply_grain_frame(
                [a.astype(np.int32) for a in frame.planes], p, 10, 1, 1
            )
            return [int((g != r).sum()) for g, r in zip(got, ref)]

        with _pool() as pool:
            bad = list(pool.map(mismatches, zip(iter_y4m(out), frames, params)))
        check(len(bad) == n and not any(map(any, bad)),
              f"render vs grain_ref mismatching samples per frame: {bad}")
        log(f"  render loop --shards {shards}: 0 mismatching samples vs grain_ref on all {n} frames x 3 planes")
    return out


def diff_loop(rendered: str, clean, mesh=None):
    """DiffEstimator.diff_batch over the rendered (grainy) frames
    against the grain-free ones, BATCH pairs a call."""
    from grav1synth.container.y4m import iter_y4m
    from grav1synth.ops.diff_estimate import DiffEstimator

    est = DiffEstimator((30, 1), 10, 10)
    src_all = list(iter_y4m(rendered))
    check(len(src_all) == len(clean), "rendered and clean frame counts differ")
    t_dev = 0.0
    for lo in range(0, len(clean), BATCH):
        t0 = time.time()
        est.diff_batch(src_all[lo : lo + BATCH], clean[lo : lo + BATCH], mesh=mesh)
        t_dev += time.time() - t0
    return est, src_all, t_dev


def phase3(seed: int):
    import jax.numpy as jnp
    import numpy as np

    from grav1synth.ops.diff_estimate import (
        DiffEstimator,
        batch_pair_stats_per_frame,
    )
    from grav1synth.pipelines import inspect

    stream = looped_stream()
    params = stream_params(stream)
    frames = seeded_frames(len(params), seed)
    render(frames, params, 1, check_ref=False)  # warm-up: compiles
    rendered = render(frames, params, 1)

    gen = os.path.join(WORK, "iso1600.ivf")
    cli("generate", stream, "-o", gen, "--iso", "1600", "--chroma", "-y")
    cli("inspect", gen, "-o", os.path.join(WORK, "iso1600.tbl"), "-y")
    rem = os.path.join(WORK, "removed.ivf")
    cli("remove", gen, "-o", rem, "-y")
    check(inspect(rem, os.path.join(WORK, "removed.tbl"), progress=False) is None,
          "remove left grain headers")
    log("phase 3: CLI generate --iso 1600 --chroma, inspect, remove: ok")

    clean = [f.planes for f in frames]
    diff_loop(rendered, clean)  # warm-up: compiles the batch shapes
    est, src_all, t_dev = diff_loop(rendered, clean)
    n = len(clean)
    log(
        f"phase 3: diff_batch {n} frames 4K10: {t_dev / n * 1e3:.2f} ms/frame "
        f"(stack + upload + device + stats fetch)"
    )
    with _pool() as pool:
        want = list(pool.map(
            lambda sc: reference_stats(sc[0], sc[1], 2, 10), zip(src_all, clean)
        ))
    ref = DiffEstimator((30, 1), 10, 10)
    for w_ in want:
        ref.add_frame_stats(*w_)
    stack = [
        jnp.asarray(np.stack([f[k] for f in fs]).view(np.int16))
        for k in range(3)
        for fs in (src_all[:2], clean[:2])
    ]
    out = batch_pair_stats_per_frame(
        *stack, lag=2, bit_depth=10, sub_x=1, sub_y=1, has_chroma=True
    )
    worst = check_stats("stream", [_stats_of(out, i) for i in range(2)], want[:2])
    log(f"  diff stream: max rel err vs float64 {worst:.3g} on 2 frames")
    tables_equal("stream", est, ref)
    os.remove(rendered)
    log("phase 3: ok")


# ---------------------------------------------------------------------------
# four cards


def four_cards(devs, seed: int) -> None:
    from grav1synth.parallel.mesh import make_mesh

    check(len(devs) >= 4, f"--four-cards needs 4 devices, found {len(devs)}")
    params = stream_params(looped_stream())
    frames = seeded_frames(len(params), seed)
    for shards in (1, 4):  # warm-up: compiles
        render(frames, params, shards, check_ref=False)
    one = render(frames, params, 1, check_ref=False)
    four = render(frames, params, 4, check_ref=False)
    check(_sha(one) == _sha(four), "render --shards 4 output differs from --shards 1")
    log("four cards: render loop --shards 4 y4m bytes == --shards 1")
    clean = [f.planes for f in frames]
    mesh = make_mesh(4)
    for m in (None, mesh):  # warm-up: compiles
        diff_loop(one, clean, mesh=m)
    est1, _, t1 = diff_loop(one, clean)
    est4, _, t4 = diff_loop(one, clean, mesh=mesh)
    a, b = est1.finish(), est4.finish()
    check(len(a) > 0 and [(s.start_time, s.end_time, s.params) for s in a]
          == [(s.start_time, s.end_time, s.params) for s in b],
          "diff on a 4-device mesh fitted another table than on one device")
    n = len(clean)
    log(
        f"four cards: diff_batch on a 4-device mesh fits the 1-device table "
        f"({t4 / n * 1e3:.2f} vs {t1 / n * 1e3:.2f} ms/frame)"
    )
    for path in (one, four):
        os.remove(path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card render and diff paths")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated frames")
    args = ap.parse_args()

    devs = require_gpu()
    sys.path.insert(0, REPO)
    from grav1synth.utils.compile_cache import setup_compile_cache

    log(f"compile cache: {setup_compile_cache()}")
    build_native()
    t0 = time.time()
    if args.four_cards:
        four_cards(devs, args.seed)
    else:
        phase2()
        phase3(args.seed)
    log(f"all phases passed in {time.time() - t0:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
