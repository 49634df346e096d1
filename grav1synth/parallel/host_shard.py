"""Multi-process sharded inspect/rewrite: GOP-parallel packet work.

The reference's packet loop is single-threaded; here the video time
axis is sharded across worker processes (one per host/core), each
walking its own keyframe-aligned packet range with a self-contained
parser. Inspect merges per-shard aggregates associatively
(tables.merge_segment_runs) into the exact single-pass result; rewrite
produces the exact single-pass output BYTES regardless of shard count
by prefix-summing the per-segment seed-decorrelation counters across
shards (SURVEY §7 hard part 6: per-frame seed mutation must not depend
on loop order).

Shard boundaries must sit on keyframes: an AV1 keyframe resets the
reference slots, making the header walk independent of earlier GOPs
(SURVEY §5 — the only cross-frame couplings are GOP-local). IVF files
carry no keyframe flags, so boundaries are discovered with a cheap OBU
probe of each packet's first frame header.
"""

from __future__ import annotations

import json
import logging
import multiprocessing as mp
import os
import pickle
from typing import List, Optional, Sequence, Tuple

log = logging.getLogger("grav1synth")

from ..container import ivf
from ..obu import Av1Parser, GrainAction, GrainRewriter
from ..obu.types import GrainTableSegment
from ..tables import aggregate_grain_headers, merge_segment_runs


def _pin_cpu() -> None:
    """Pool initializer: the workers parse and rewrite bytes only, so
    they keep JAX (imported along with the package) off the GPU and
    leave the card to the parent process."""
    import jax

    jax.config.update("jax_platforms", "cpu")


def _pool(n: int):
    return mp.get_context("spawn").Pool(n, initializer=_pin_cpu)


def _av1_ts(pts: int, tb_num: int, tb_den: int) -> int:
    """pts -> 1/10^7-s ticks, ceiling (same rule as pipelines)."""
    if pts < 0 or tb_den == 0:
        return 0
    return -(-pts * tb_num * 10_000_000 // tb_den)


def _probe_packet_keyframe(data: bytes, seq_box: list) -> bool:
    """Cheap keyframe probe: walks only the OBU framing and the first
    frame header's leading bits (show_existing_frame / frame_type /
    show_frame) — no full uncompressed_header walk, so the pre-shard
    scan costs O(OBU count), not a second parse pass. ``seq_box`` is a
    one-element mutable holder of the current SequenceHeader (sequence
    OBUs still parse fully; they are rare and the probe needs
    reduced_still_picture_header)."""
    from ..bitio import BitReader
    from ..obu.sequence import parse_sequence_header
    from ..obu.types import ObuType

    pos = 0
    n = len(data)
    while pos < n:
        r = BitReader(data, start_bit=pos * 8)
        r.zero_bit()
        obu_type = ObuType(r.f(4))
        ext = r.bool_()
        has_size = r.bool_()
        r.zero_bit()
        if ext:
            r.f(8)
        size = r.leb128() if has_size else n - r.byte_pos()
        payload_start = r.byte_pos()
        payload_end = payload_start + size
        if payload_end > n:
            raise ValueError("OBU size overruns packet")
        if obu_type == ObuType.SEQUENCE_HEADER:
            r.end = payload_end * 8
            seq_box[0] = parse_sequence_header(r, payload_start * 8)
        elif obu_type in (ObuType.FRAME, ObuType.FRAME_HEADER):
            seq = seq_box[0]
            if seq is None:
                return False
            if seq.reduced_still_picture_header:
                return True  # frame_type = KEY, show_frame = 1
            if r.bool_():  # show_existing_frame
                return False
            frame_type = r.f(2)
            show_frame = r.bool_()
            return frame_type == 0 and show_frame
        pos = payload_end
    return False


def keyframe_flags(packets: Sequence[ivf.IvfPacket]) -> List[bool]:
    """True for packets whose first frame is a shown keyframe."""
    seq_box: list = [None]
    flags = []
    for p in packets:
        try:
            flags.append(_probe_packet_keyframe(p.data, seq_box))
        except Exception:
            flags.append(False)
    return flags


def plan_shards(
    keyframes: Sequence[bool], n_shards: int
) -> List[Tuple[int, int]]:
    """Contiguous packet ranges starting at keyframes, balanced to
    roughly equal frame counts."""
    n = len(keyframes)
    key_idx = [i for i, k in enumerate(keyframes) if k]
    if not key_idx or key_idx[0] != 0:
        # no safe split points: single shard (tell the user, who asked
        # for parallelism and would otherwise never learn it was
        # abandoned)
        log.warning(
            "stream has no keyframe-aligned split points "
            "(first packet is not a keyframe); proceeding with 1 shard"
        )
        return [(0, n)]
    target = max(1, n // n_shards)
    bounds = [0]
    for k in key_idx[1:]:
        if k - bounds[-1] >= target and len(bounds) < n_shards:
            bounds.append(k)
    bounds.append(n)
    if len(bounds) - 1 < n_shards:
        log.info(
            "keyframe spacing admits %d shard(s) of the %d requested",
            len(bounds) - 1,
            n_shards,
        )
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def _inspect_shard(args) -> Tuple[int, list]:
    path, start, end, fps_num, fps_den, frame_offset = args
    _, packets = ivf.read_ivf(path)
    parser = Av1Parser()
    headers = []
    for p in packets[start:end]:
        ts = 0  # timestamps don't influence read-only parsing
        for obu in parser.parse_packet(p.data, ts):
            if obu.frame is not None and obu.frame.show_frame:
                headers.append(obu.frame.grain)
    segs = aggregate_grain_headers(
        headers, fps_num, fps_den, start_index=frame_offset
    )
    return len(headers), segs


def sharded_inspect_ivf(
    path: str,
    n_shards: int = 4,
    fps: Optional[Tuple[int, int]] = None,
) -> Optional[List[GrainTableSegment]]:
    """Parallel inspect of an IVF file. Returns merged segments, or None
    when the stream carries no grain (matching pipelines.inspect)."""
    header, packets = ivf.read_ivf(path)
    if fps is None:
        fps = (header.timebase_den, header.timebase_num)
    flags = keyframe_flags(packets)
    shards = plan_shards(flags, n_shards)

    # frame offsets assume one shown frame per packet, which holds for
    # IVF (each temporal unit = one shown frame); shards re-count and
    # the merge validates adjacency
    jobs = []
    offset = 0
    for s, e in shards:
        jobs.append((path, s, e, fps[0], fps[1], offset))
        offset += e - s

    if len(jobs) == 1:
        results = [_inspect_shard(jobs[0])]
    else:
        with _pool(len(jobs)) as pool:
            results = pool.map(_inspect_shard, jobs)

    runs = [segs for _, segs in results]
    merged = merge_segment_runs(runs)
    if not merged:
        return None
    return merged


# ---------------------------------------------------------------------------
# Sharded rewrite (apply / remove)


def _prime_parser(parser: Av1Parser, packets, upto: int) -> None:
    """Feed leading packets until the stream's sequence header is seen —
    shards that start mid-stream still need it for the header walk."""
    for p in packets[:upto]:
        parser.parse_packet(p.data, 0)
        if parser.sequence_header is not None:
            return


def _rewrite_shard(args):
    """Rewrite one keyframe-aligned packet range. Returns (bytes list,
    per-segment match-count deltas). Deltas depend only on timestamps
    and frame headers — never on the initial counts — so a zero-init
    pass yields correct deltas for the cross-shard prefix sum."""
    path, start, end, segments, init_counts = args
    header, packets = ivf.read_ivf(path)
    tb_num, tb_den = header.time_base
    parser = Av1Parser()
    if start > 0:
        _prime_parser(parser, packets, start)
    rw = GrainRewriter(segments)
    if init_counts is not None:
        rw.set_match_counts(init_counts)
    out = []
    for p in packets[start:end]:
        ts = _av1_ts(p.pts, tb_num, tb_den)
        parsed = parser.parse_packet(p.data, ts)
        out.append(rw.rewrite_packet(p.data, parsed, ts, parser.sequence_header))
    return out, rw.seed_match_counts()


# ---------------------------------------------------------------------------
# Per-GOP work manifest (SURVEY §5 checkpoint/resume: "per-GOP work
# manifest + restart" is this build's equivalent of the reference's
# single-process stop/rerun). The rewrite is split into keyframe-
# aligned work units finer than the worker count; each completed unit
# persists its packet bytes + seed-counter delta before the next is
# scheduled, so a killed job restarts at O(remaining units), not O(N).


def _manifest_path(out_path: str) -> str:
    return out_path + ".manifest.json"


def _parts_dir(out_path: str) -> str:
    return out_path + ".parts"


def _input_fingerprint(path: str) -> dict:
    import hashlib

    st = os.stat(path)
    with open(path, "rb") as fh:
        head = fh.read(1 << 16)
    return {"size": st.st_size, "sha1_head": hashlib.sha1(head).hexdigest()}


def _segments_digest(segments) -> str:
    import hashlib

    if segments is None:
        return "remove"
    blob = repr(
        [(s.start_time, s.end_time, s.params) for s in segments]
    ).encode()
    return hashlib.sha1(blob).hexdigest()


def _save_manifest(out_path: str, man: dict) -> None:
    """Atomic write: crash mid-save leaves the previous manifest."""
    mp_ = _manifest_path(out_path)
    tmp = mp_ + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(man, fh)
    os.replace(tmp, mp_)


def _save_part(out_path: str, idx: int, packets_bytes: List[bytes]) -> None:
    os.makedirs(_parts_dir(out_path), exist_ok=True)
    part = os.path.join(_parts_dir(out_path), f"{idx}.part")
    tmp = part + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(packets_bytes, fh)
    os.replace(tmp, part)


def _load_part(out_path: str, idx: int) -> List[bytes]:
    with open(os.path.join(_parts_dir(out_path), f"{idx}.part"), "rb") as fh:
        return pickle.load(fh)


def _cleanup_manifest(out_path: str) -> None:
    import shutil

    for p in (_manifest_path(out_path),):
        if os.path.exists(p):
            os.remove(p)
    shutil.rmtree(_parts_dir(out_path), ignore_errors=True)


def sharded_rewrite_ivf(
    path: str,
    out_path: str,
    segments: Optional[List[GrainTableSegment]],
    n_shards: int = 4,
    resume: bool = False,
) -> int:
    """Parallel apply/remove over an IVF file, byte-identical to the
    single-pass pipeline for any shard count.

    The per-frame seed decorrelation counts segment matches in frame
    order, so shard i must start from the counts accumulated by shards
    < i. Phase 1 runs every unit with zero counts (correct for unit 0,
    and it yields each unit's count DELTAS, which are
    init-independent); units whose prefix sum is nonzero re-run with
    the proper initial counts. Removal (segments=None) has no counters
    and finishes in one phase.

    Fault tolerance: work is planned as keyframe-aligned units (~4 per
    worker); each finished unit's bytes + counter delta persist to
    ``out.parts/`` + ``out.manifest.json`` the moment it completes.
    ``resume=True`` skips persisted units whose recorded initial counts
    still match, re-running only the remainder — restart cost is
    O(remaining units). A manifest whose input fingerprint, segment
    digest, or unit plan disagrees is discarded with a warning. The
    manifest and parts are deleted after the final IVF is written.
    GRAV1_SHARD_FAIL_AFTER=<k> (test hook) aborts the job after k units
    have persisted, simulating a mid-job kill."""
    header, packets = ivf.read_ivf(path)
    flags = keyframe_flags(packets)
    # units finer than the worker count bound restart loss to ~1/4 of
    # one worker's span while keeping per-unit parser-priming cheap
    units = plan_shards(flags, max(n_shards, 1) * 4)
    n_units = len(units)

    fp = _input_fingerprint(path)
    digest = _segments_digest(segments)
    n_seg = len(segments) if segments else 0

    man = None
    if resume and os.path.exists(_manifest_path(out_path)):
        try:
            with open(_manifest_path(out_path)) as fh:
                man = json.load(fh)
        except Exception:
            man = None
        if man is not None and (
            man.get("input") != fp
            or man.get("segments_digest") != digest
            or man.get("units") != [list(u) for u in units]
        ):
            log.warning(
                "resume manifest does not match this job "
                "(input, grain table, or unit plan changed); restarting"
            )
            man = None
    if man is None:
        _cleanup_manifest(out_path)
        man = {
            "input": fp,
            "segments_digest": digest,
            "units": [list(u) for u in units],
            # per unit: None (not done) or {"init": [...], "delta": [...]}
            "done": [None] * n_units,
        }
        _save_manifest(out_path, man)
    else:
        n_done = sum(1 for d in man["done"] if d is not None)
        log.info(
            "resuming sharded rewrite: %d/%d units already complete",
            n_done, n_units,
        )

    fail_after = int(os.environ.get("GRAV1_SHARD_FAIL_AFTER", "0") or 0)
    completed_this_run = 0

    def run_units(jobs_by_idx: dict) -> None:
        """Run units, persisting each the moment it completes — a kill
        at any point loses at most the in-flight units."""
        nonlocal completed_this_run

        def persist(idx, result):
            nonlocal completed_this_run
            out, counts = result
            init = jobs_by_idx[idx][4] or [0] * n_seg
            _save_part(out_path, idx, out)
            man["done"][idx] = {
                "init": list(init),
                "delta": [c - i for c, i in zip(counts, init)]
                if n_seg
                else [],
            }
            _save_manifest(out_path, man)
            completed_this_run += 1
            if fail_after and completed_this_run >= fail_after:
                raise RuntimeError(
                    f"GRAV1_SHARD_FAIL_AFTER={fail_after}: simulated kill"
                )

        items = sorted(jobs_by_idx.items())
        if len(items) == 1:
            persist(items[0][0], _rewrite_shard(items[0][1]))
            return
        with _pool(min(n_shards, len(items))) as pool:
            for (idx, _), res in zip(
                items, pool.imap(_rewrite_shard, [j for _, j in items])
            ):
                persist(idx, res)

    # phase 1: delta pass for units with no persisted result
    pending = {
        i: (path, units[i][0], units[i][1], segments, None)
        for i in range(n_units)
        if man["done"][i] is None
    }
    if pending:
        run_units(pending)

    # phase 2: units whose recorded init counts disagree with the
    # cross-unit prefix sum re-run with the proper counts (deltas are
    # init-independent, so persisted deltas stay valid)
    if segments:
        prefix = [0] * n_seg
        redo = {}
        for i in range(n_units):
            rec = man["done"][i]
            if rec["init"] != prefix:
                redo[i] = (path, units[i][0], units[i][1], segments, list(prefix))
            prefix = [a + b for a, b in zip(prefix, rec["delta"])]
        if redo:
            run_units(redo)

    flat = [d for i in range(n_units) for d in _load_part(out_path, i)]
    ivf.write_ivf(
        out_path, header, [ivf.IvfPacket(p.pts, d) for p, d in zip(packets, flat)]
    )
    _cleanup_manifest(out_path)
    return len(flat)
