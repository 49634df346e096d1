"""Real multi-process jax.distributed execution on a CPU fake pod.

Two OS processes, four virtual CPU devices each, join one 8-device
global mesh via jax.distributed.initialize and run (a) the production
shard_map+Pallas grain-apply step with psum'd statistics, (b) the
per-host file-shard rewrite pipeline with cross-host seed-counter
exchange. The reference has no distributed mode at all (SURVEY §2
P1/P2); this is the device-parallel replacement's integration test, per
SURVEY §4 "Implications" item 5 (CPU fake-mesh multi-host CI).
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

from av1_builder import sample_grain_params

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def grainy_ivf(tmp_path_factory):
    """A multi-GOP grainy IVF + the table used to graft it."""
    from grav1synth import pipelines
    from grav1synth.container.ffshim import Encoder
    from grav1synth.container.ivf import IvfHeader, IvfPacket, write_ivf
    from grav1synth.obu.types import GrainTableSegment
    from grav1synth.tables import dump_table

    tmp = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(3)
    frames = []
    for _ in range(24):
        y = rng.integers(0, 255, (64, 64)).astype(np.uint8)
        u = np.full((32, 32), 128, np.uint8)
        frames.append((y, u, u.copy()))
    enc = Encoder(64, 64, 8, extra_opts="g=6:keyint_min=6")
    pkts = enc.encode_frames(frames)
    enc.close()
    plain = tmp / "plain.ivf"
    write_ivf(
        str(plain),
        IvfHeader(width=64, height=64, timebase_den=24, timebase_num=1),
        [IvfPacket(p.pts, p.data) for p in pkts],
    )
    mid = -(-12 * 10_000_000 // 24)
    segs = [
        GrainTableSegment(0, mid, sample_grain_params(seed=5)),
        GrainTableSegment(mid, 10**14, sample_grain_params(seed=901)),
    ]
    tbl = tmp / "t.tbl"
    dump_table(segs, str(tbl))
    serial = tmp / "serial.ivf"
    pipelines.apply_table(str(plain), str(serial), str(tbl), progress=False)
    return str(plain), str(tbl), str(serial)


@pytest.mark.parametrize("num_processes", [2, 4])
def test_fake_pod(grainy_ivf, tmp_path, num_processes):
    """2- and 4-process pods: same 8-device global mesh, split 4x2 or
    2x4 across OS processes. The 4-process arm exercises >2-party
    collective exchange (allgather of 4 hosts' seed-counter deltas,
    psum over 4 processes' device rows) at zero hardware cost."""
    ivf_path, table_path, serial_path = grainy_ivf
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "").replace(
            "--xla_force_host_platform_device_count=8", ""
        )
        + f" --xla_force_host_platform_device_count={8 // num_processes}"
    ).strip()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    procs = []
    for pid in range(num_processes):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    os.path.join(TESTS_DIR, "multihost_worker.py"),
                    str(pid),
                    str(num_processes),
                    str(port),
                    str(tmp_path),
                    ivf_path,
                    table_path,
                ],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out.decode(errors="replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"

    # both processes saw the same replicated psum'd statistics
    stats = []
    for pid in range(num_processes):
        with open(tmp_path / f"ok_{pid}.json") as fh:
            stats.append(json.load(fh))
    assert stats[0]["devices"] == 8
    for s in stats[1:]:
        assert s["energy"] == pytest.approx(stats[0]["energy"])
    assert all(s["frames"] == 16.0 for s in stats)
    assert all(s["checked"] > 0 for s in stats)

    # merge the per-host rewrite shards: byte-identical to serial
    from grav1synth.container import ivf as ivf_mod

    header, packets = ivf_mod.read_ivf(ivf_path)
    n_shards = stats[0]["n_shards"]
    flat = []
    for i in range(n_shards):
        with open(tmp_path / f"shard_{i}.pkl", "rb") as fh:
            flat.extend(pickle.load(fh))
    assert len(flat) == len(packets)
    merged_path = tmp_path / "merged.ivf"
    ivf_mod.write_ivf(
        str(merged_path),
        header,
        [ivf_mod.IvfPacket(p.pts, d) for p, d in zip(packets, flat)],
    )
    with open(serial_path, "rb") as fh:
        serial_bytes = fh.read()
    assert merged_path.read_bytes() == serial_bytes
