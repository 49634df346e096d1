"""Device meshes, frame/GOP sharding, and collectives.

The reference is a single-threaded CLI (SURVEY §2 P1/P2); this layer is
the device-parallel replacement: data parallelism over frames/GOPs on a
`jax.sharding.Mesh`, with per-shard statistics exchanged via XLA
collectives and grain tables merged associatively on host.
"""

from .mesh import (
    frame_shards,
    make_mesh,
    pad_batch,
    sharded_apply,
    sharded_apply_with_stats,
)

__all__ = [
    "frame_shards",
    "make_mesh",
    "pad_batch",
    "sharded_apply",
    "sharded_apply_with_stats",
    "sharded_inspect_ivf",
    "sharded_rewrite_ivf",
]


def __getattr__(name):
    # host_shard pulls in multiprocessing/container deps; import lazily
    if name in ("sharded_inspect_ivf", "sharded_rewrite_ivf"):
        from . import host_shard

        return getattr(host_shard, name)
    raise AttributeError(name)
