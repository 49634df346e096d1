"""One process of the multi-host CPU fake-pod test (SURVEY §4
"Implications" item 5; reference has no distributed execution at all —
this exercises this build's replacement for it).

Launched by test_multihost.py with JAX_PLATFORMS=cpu and
--xla_force_host_platform_device_count=<local>, one subprocess per
fake host. Each process:

1. joins the pod via jax.distributed.initialize (gRPC coordinator),
2. runs the sharded grain-apply step (shard_map + the grain kernels in
   interpret mode) over the GLOBAL mesh spanning both processes' devices,
   verifying its addressable output shards bit-exactly against the
   dav1d-validated host reference and the psum'd statistics,
3. runs the per-host file-shard rewrite pipeline: each host rewrites
   its own keyframe-aligned packet ranges of a shared IVF, exchanging
   the per-segment seed-decorrelation count deltas between processes
   (process_allgather) so the merged output is byte-identical to the
   serial pipeline for any host count.

Writes OK markers + per-host shard bytes for the parent to merge and
verify. Any assertion failure exits nonzero and fails the pytest.
"""

import json
import os
import pickle
import sys


def main() -> None:
    (
        _,
        process_id,
        num_processes,
        port,
        workdir,
        ivf_path,
        table_path,
    ) = sys.argv
    process_id = int(process_id)
    num_processes = int(num_processes)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    import copy

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from av1_builder import sample_grain_params

    from grav1synth.container import ivf
    from grav1synth.obu import Av1Parser, GrainRewriter
    from grav1synth.ops import grain_jax, grain_ref
    from grav1synth.parallel import make_mesh, sharded_apply_with_stats
    from grav1synth.parallel.host_shard import (
        _rewrite_shard,
        keyframe_flags,
        plan_shards,
    )
    from grav1synth.tables import load_table

    n_local = jax.local_device_count()
    assert jax.process_count() == num_processes, jax.process_count()
    assert jax.device_count() == num_processes * n_local, jax.device_count()

    # ---- part 1: global-mesh sharded apply on the production kernel ----
    mesh = make_mesh()  # spans every device of every process
    n_dev = jax.device_count()
    b = n_dev * 2
    rng = np.random.default_rng(31)  # same data on every process
    y = rng.integers(0, 1024, (b, 64, 64)).astype(np.int32)
    cb = rng.integers(0, 1024, (b, 32, 32)).astype(np.int32)
    cr = rng.integers(0, 1024, (b, 32, 32)).astype(np.int32)
    base = sample_grain_params(seed=41)
    params = []
    for i in range(b):
        p = copy.deepcopy(base)
        p.grain_seed = (41 + i * 10063) & 0xFFFF
        params.append(p)
    pb = grain_jax.pack_params(params)

    shard = NamedSharding(mesh, P(mesh.axis_names[0]))

    def to_global(np_leaf, sharding):
        arr = np.asarray(np_leaf)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    y_g = to_global(y, shard)
    cb_g = to_global(cb, shard)
    cr_g = to_global(cr, shard)
    pb_g = jax.tree.map(lambda leaf: to_global(leaf, shard), pb)

    y2, cb2, cr2, energy, frames = sharded_apply_with_stats(
        mesh, y_g, cb_g, cr_g, pb_g, 10, backend="pallas", interpret=True
    )
    assert float(frames) == b, float(frames)
    assert float(energy) > 0.0

    # each process checks the frames it can address, all planes
    checked = 0
    ref_cache = {}
    for plane_idx, out in enumerate((y2, cb2, cr2)):
        for sh in out.addressable_shards:
            sl = sh.index[0]
            data = np.asarray(sh.data)
            for k, frame_i in enumerate(range(sl.start or 0, sl.stop)):
                if frame_i not in ref_cache:
                    ref_cache[frame_i] = grain_ref.apply_grain_frame(
                        [y[frame_i], cb[frame_i], cr[frame_i]],
                        params[frame_i],
                        10,
                        1,
                        1,
                    )
                ref_plane = ref_cache[frame_i][plane_idx]
                assert (
                    data[k].astype(np.int64) == ref_plane.astype(np.int64)
                ).all(), f"plane {plane_idx} frame {frame_i} mismatch"
                checked += 1
    assert checked > 0

    # ---- part 2: per-host file-shard rewrite, byte-identical ----
    segments = load_table(table_path)
    header, packets = ivf.read_ivf(ivf_path)
    flags = keyframe_flags(packets)
    shards = plan_shards(flags, 2 * num_processes)
    mine = [i for i in range(len(shards)) if i % num_processes == process_id]

    # phase 1: every host runs its shards with zero counters; the count
    # DELTAS are init-independent
    phase1 = {}
    for i in mine:
        s, e = shards[i]
        out, counts = _rewrite_shard((ivf_path, s, e, segments, None))
        phase1[i] = (out, counts)

    # exchange per-shard deltas over the pod (DCN in production): a
    # fixed-shape f32 matrix allgathered across processes
    n_seg = len(segments)
    deltas = np.zeros((len(shards), n_seg), np.float32)
    for i, (_, counts) in phase1.items():
        deltas[i] = counts
    all_deltas = multihost_utils.process_allgather(deltas)  # (P, S, n_seg)
    merged = all_deltas.sum(axis=0)  # each shard's row came from one host

    # phase 2: shards whose prefix is nonzero re-run with proper counts
    outs = {}
    prefix = np.zeros(n_seg)
    for i in range(len(shards)):
        if i in mine:
            if i > 0 and prefix.any():
                s, e = shards[i]
                out, _ = _rewrite_shard(
                    (ivf_path, s, e, segments, [int(v) for v in prefix])
                )
            else:
                out = phase1[i][0]
            outs[i] = out
        prefix += merged[i]

    for i, out in outs.items():
        with open(os.path.join(workdir, f"shard_{i}.pkl"), "wb") as fh:
            pickle.dump(out, fh)

    multihost_utils.sync_global_devices("shards-written")

    with open(os.path.join(workdir, f"ok_{process_id}.json"), "w") as fh:
        json.dump(
            {
                "energy": float(energy),
                "frames": float(frames),
                "checked": checked,
                "devices": n_dev,
                "n_shards": len(shards),
            },
            fh,
        )
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
