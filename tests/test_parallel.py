"""Sharded application on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from av1_builder import sample_grain_params
from grav1synth.ops import grain_jax, grain_ref
from grav1synth.parallel import frame_shards, make_mesh, sharded_apply_with_stats


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_apply_matches_reference(backend):
    """The grain kernels (interpret mode on the CPU mesh) and the XLA
    formulation must both shard over the mesh and stay bit-exact vs the
    dav1d-validated reference, all planes."""
    mesh = make_mesh()
    n = len(mesh.devices)
    b = n
    rng = np.random.default_rng(9)
    y = rng.integers(0, 256, (b, 64, 64)).astype(np.int32)
    cb = rng.integers(0, 256, (b, 32, 32)).astype(np.int32)
    cr = rng.integers(0, 256, (b, 32, 32)).astype(np.int32)
    params = []
    import copy

    base = sample_grain_params(seed=100)
    for i in range(b):
        p = copy.deepcopy(base)
        p.grain_seed = (100 + i * 10063) & 0xFFFF
        params.append(p)
    pb = grain_jax.pack_params(params)
    y2, cb2, cr2, energy, frames = sharded_apply_with_stats(
        mesh, jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), pb, 8,
        backend=backend, interpret=backend == "pallas",
    )
    assert float(frames) == b
    assert float(energy) > 0
    y2, cb2, cr2 = np.asarray(y2), np.asarray(cb2), np.asarray(cr2)
    for i, p in enumerate(params):
        ref = grain_ref.apply_grain_frame([y[i], cb[i], cr[i]], p, 8, 1, 1)
        assert (y2[i].astype(np.int64) == ref[0].astype(np.int64)).all()
        assert (cb2[i].astype(np.int64) == ref[1].astype(np.int64)).all()
        assert (cr2[i].astype(np.int64) == ref[2].astype(np.int64)).all()


def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out[0].shape == args[0].shape


def test_frame_shards():
    shards = frame_shards(100, 8)
    assert shards[0] == (0, 13)
    assert shards[-1] == (88, 100)
    assert sum(e - s for s, e in shards) == 100
    assert all(e > s for s, e in shards)


class TestHostShard:
    def test_sharded_inspect_matches_single(self, tmp_path):
        import numpy as np

        from grav1synth import pipelines
        from grav1synth.container.ffshim import Encoder
        from grav1synth.container.ivf import IvfHeader, IvfPacket, write_ivf
        from grav1synth.obu import Av1Parser, GrainRewriter, GrainTableSegment
        from grav1synth.parallel.host_shard import (
            keyframe_flags,
            plan_shards,
            sharded_inspect_ivf,
        )

        rng = np.random.default_rng(2)
        frames = []
        for i in range(24):
            y = rng.integers(0, 255, (64, 64)).astype(np.uint8)
            u = np.full((32, 32), 128, np.uint8)
            frames.append((y, u, u.copy()))
        # short GOPs -> several keyframes
        enc = Encoder(64, 64, 8, extra_opts="g=6:keyint_min=6")
        pkts = enc.encode_frames(frames)
        enc.close()
        seg = GrainTableSegment(0, 10**14, sample_grain_params(seed=5))
        parser = Av1Parser()
        rw = GrainRewriter([seg])
        grainy = []
        for p in pkts:
            ts = -(-p.pts * 10_000_000 // 24)
            parsed = parser.parse_packet(p.data, ts)
            grainy.append(rw.rewrite_packet(p.data, parsed, ts, parser.sequence_header))
        path = tmp_path / "g.ivf"
        write_ivf(
            str(path),
            IvfHeader(width=64, height=64, timebase_den=24, timebase_num=1),
            [IvfPacket(i, d) for i, d in enumerate(grainy)],
        )
        flags = keyframe_flags(
            [IvfPacket(i, d) for i, d in enumerate(grainy)]
        )
        assert flags[0] and sum(flags) >= 2
        shards = plan_shards(flags, 4)
        assert len(shards) >= 2

        single = pipelines.inspect(str(path), str(tmp_path / "s.tbl"), progress=False)
        sharded = sharded_inspect_ivf(str(path), n_shards=4)
        assert sharded is not None and single is not None
        assert [
            (s.start_time, s.end_time) for s in sharded
        ] == [(s.start_time, s.end_time) for s in single]

    def _multi_gop_ivf(self, tmp_path, name="m.ivf", n=24):
        import numpy as np

        from grav1synth.container.ffshim import Encoder
        from grav1synth.container.ivf import IvfHeader, IvfPacket, write_ivf

        rng = np.random.default_rng(7)
        frames = []
        for _ in range(n):
            y = rng.integers(0, 255, (64, 64)).astype(np.uint8)
            u = np.full((32, 32), 128, np.uint8)
            frames.append((y, u, u.copy()))
        enc = Encoder(64, 64, 8, extra_opts="g=6:keyint_min=6")
        pkts = enc.encode_frames(frames)
        enc.close()
        path = tmp_path / name
        write_ivf(
            str(path),
            IvfHeader(width=64, height=64, timebase_den=24, timebase_num=1),
            [IvfPacket(p.pts, p.data) for p in pkts],
        )
        return str(path)

    @pytest.mark.parametrize("n_shards", [1, 3])
    def test_sharded_apply_rewrite_byte_identical(self, tmp_path, n_shards):
        """Sharded apply must produce the exact single-pass bytes for
        any shard count (seed counters prefix-summed across shards).
        Two segments exercise per-segment counting."""
        from grav1synth import pipelines
        from grav1synth.obu import GrainTableSegment
        from grav1synth.parallel.host_shard import sharded_rewrite_ivf
        from grav1synth.tables import dump_table

        path = self._multi_gop_ivf(tmp_path)
        mid = -(-12 * 10_000_000 // 24)
        segs = [
            GrainTableSegment(0, mid, sample_grain_params(seed=5)),
            GrainTableSegment(mid, 10**14, sample_grain_params(seed=901)),
        ]
        tbl = tmp_path / "t.tbl"
        dump_table(segs, str(tbl))
        serial = tmp_path / "serial.ivf"
        pipelines.apply_table(path, str(serial), str(tbl), progress=False)
        shard_out = tmp_path / f"shard{n_shards}.ivf"
        from grav1synth.tables import load_table

        n = sharded_rewrite_ivf(path, str(shard_out), load_table(str(tbl)), n_shards)
        assert n == 24
        assert shard_out.read_bytes() == serial.read_bytes()

    def test_kill_and_resume_byte_identical(self, tmp_path, monkeypatch):
        """SURVEY §5 checkpoint row: a sharded rewrite killed mid-job
        restarts from its per-GOP manifest, skips the persisted units,
        and still produces the exact single-pass bytes."""
        import json
        import os

        from grav1synth import pipelines
        from grav1synth.obu import GrainTableSegment
        from grav1synth.parallel import host_shard
        from grav1synth.tables import dump_table, load_table

        path = self._multi_gop_ivf(tmp_path, name="k.ivf")
        mid = -(-12 * 10_000_000 // 24)
        segs = [
            GrainTableSegment(0, mid, sample_grain_params(seed=5)),
            GrainTableSegment(mid, 10**14, sample_grain_params(seed=901)),
        ]
        tbl = tmp_path / "k.tbl"
        dump_table(segs, str(tbl))
        serial = tmp_path / "serial.ivf"
        pipelines.apply_table(path, str(serial), str(tbl), progress=False)

        out = tmp_path / "sharded.ivf"
        monkeypatch.setenv("GRAV1_SHARD_FAIL_AFTER", "1")
        with pytest.raises(RuntimeError, match="simulated kill"):
            host_shard.sharded_rewrite_ivf(
                path, str(out), load_table(str(tbl)), 3, resume=False
            )
        # the kill left a manifest with >= 1 persisted unit and parts
        man_path = host_shard._manifest_path(str(out))
        assert os.path.exists(man_path)
        with open(man_path) as fh:
            man = json.load(fh)
        done_idx = [i for i, d in enumerate(man["done"]) if d is not None]
        assert done_idx, "no unit persisted before the simulated kill"
        # pool.imap preserves order, so the persisted unit is unit 0 —
        # whose phase-2 init is always the zero vector, i.e. it is final
        assert done_idx == [0]

        # restart: completed units must be skipped — record every part
        # written during resume (persist always runs in the parent) and
        # assert unit 0 is not among them; output must equal the
        # single-pass bytes; manifest cleaned up on success
        monkeypatch.delenv("GRAV1_SHARD_FAIL_AFTER")
        saved = []
        real_save = host_shard._save_part
        monkeypatch.setattr(
            host_shard, "_save_part",
            lambda op, idx, data: (saved.append(idx), real_save(op, idx, data)),
        )
        n = host_shard.sharded_rewrite_ivf(
            path, str(out), load_table(str(tbl)), 3, resume=True
        )
        assert n == 24
        assert 0 not in saved and saved, f"resume re-ran units {saved}"
        assert out.read_bytes() == serial.read_bytes()
        assert not os.path.exists(man_path)
        assert not os.path.exists(host_shard._parts_dir(str(out)))

    def test_stale_manifest_discarded(self, tmp_path, caplog):
        """A manifest from a different grain table must be discarded,
        and the job must restart cleanly."""
        import logging

        from grav1synth import pipelines
        from grav1synth.obu import GrainTableSegment
        from grav1synth.parallel import host_shard
        from grav1synth.tables import dump_table, load_table

        path = self._multi_gop_ivf(tmp_path, name="s.ivf")
        segs_a = [GrainTableSegment(0, 10**14, sample_grain_params(seed=5))]
        segs_b = [GrainTableSegment(0, 10**14, sample_grain_params(seed=901))]
        tbl_a, tbl_b = tmp_path / "a.tbl", tmp_path / "b.tbl"
        dump_table(segs_a, str(tbl_a))
        dump_table(segs_b, str(tbl_b))
        out = tmp_path / "out.ivf"
        # leave a half-finished manifest for table A
        import os

        os.environ["GRAV1_SHARD_FAIL_AFTER"] = "1"
        try:
            with pytest.raises(RuntimeError):
                host_shard.sharded_rewrite_ivf(
                    path, str(out), load_table(str(tbl_a)), 3
                )
        finally:
            del os.environ["GRAV1_SHARD_FAIL_AFTER"]
        # resume with table B: manifest must be rejected, result correct
        serial = tmp_path / "serial_b.ivf"
        pipelines.apply_table(path, str(serial), str(tbl_b), progress=False)
        with caplog.at_level(logging.WARNING, logger="grav1synth"):
            host_shard.sharded_rewrite_ivf(
                path, str(out), load_table(str(tbl_b)), 3, resume=True
            )
        assert any("does not match" in r.message for r in caplog.records)
        assert out.read_bytes() == serial.read_bytes()

    def test_sharded_remove_byte_identical(self, tmp_path):
        from grav1synth import pipelines
        from grav1synth.obu import GrainTableSegment
        from grav1synth.parallel.host_shard import sharded_rewrite_ivf
        from grav1synth.tables import dump_table

        path = self._multi_gop_ivf(tmp_path, name="m2.ivf")
        # first graft grain on, then compare serial vs sharded removal
        segs = [GrainTableSegment(0, 10**14, sample_grain_params(seed=5))]
        tbl = tmp_path / "t2.tbl"
        dump_table(segs, str(tbl))
        grainy = tmp_path / "grainy.ivf"
        pipelines.apply_table(path, str(grainy), str(tbl), progress=False)
        serial = tmp_path / "serial_rm.ivf"
        pipelines.remove(str(grainy), str(serial), progress=False)
        shard_out = tmp_path / "shard_rm.ivf"
        sharded_rewrite_ivf(str(grainy), str(shard_out), None, 3)
        assert shard_out.read_bytes() == serial.read_bytes()
