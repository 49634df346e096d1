"""Mesh construction and the sharded grain-application step.

Sharding model (SURVEY §5 mapping): the video time axis is the
parallel dimension. Frames batch-shard across the mesh's ``data`` axis
(each device applies grain to its frame shard; pattern generation is
per-frame so it shards identically). The only cross-device data
dependencies are reductions over per-frame statistics — noise energy /
applied-frame counts — realized as psums inside the jitted step, and
grain-table/diff-statistic exchange, which ride all-gathers (or the
host-side associative merge in tables.aggregate for multi-process
runs). Bitstream bytes never cross devices: demux/remux stay host-local
per shard (reference's packet loop becomes per-host work).

Multi-host: `jax.distributed.initialize()` before building the mesh
makes the same code span several hosts; the mesh axis then covers all
processes' devices. The mesh is flat and 1-D: the cards of one host
reach each other all to all, so its order follows the frame axis alone.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..obu.types import FilmGrainParams
from ..ops import grain_jax
from ..ops.grain_jax import GrainParamsBatch


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """1-D device mesh over the frame/batch axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def pad_batch(
    planes: Sequence[np.ndarray], params: List[FilmGrainParams], n: int
) -> Tuple[List[np.ndarray], List[FilmGrainParams], int]:
    """Pad a frame batch to a multiple of the mesh size (padded frames
    replicate the last frame and are dropped after the step)."""
    b = planes[0].shape[0]
    pad = (-b) % n
    if pad == 0:
        return list(planes), params, b
    planes_p = [np.concatenate([pl, np.repeat(pl[-1:], pad, 0)], 0) for pl in planes]
    params_p = params + [params[-1]] * pad
    return planes_p, params_p, b


def _apply_step(
    y, cb, cr, p, bit_depth, sub_x, sub_y, monochrome, backend, interpret, axis
):
    y2, cb2, cr2 = grain_jax.apply_grain(
        y, cb, cr, p, bit_depth, sub_x, sub_y, monochrome, backend=backend,
        interpret=interpret,
    )
    # cross-shard QC statistics: each device reduces its local frame
    # shard, then psums over the mesh axis (an all-reduce); the scalars
    # come back replicated
    d = (y2 - y).astype(jnp.float32)
    energy = jax.lax.psum(jnp.sum(d * d), axis)
    frames = jax.lax.psum(
        jnp.sum(jnp.ones((y.shape[0],), jnp.float32)), axis
    )
    return y2, cb2, cr2, energy, frames


def sharded_apply_with_stats(
    mesh: Mesh,
    y: jnp.ndarray,
    cb: Optional[jnp.ndarray],
    cr: Optional[jnp.ndarray],
    p: GrainParamsBatch,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
    backend: Optional[str] = None,
    interpret: bool = False,
):
    """Apply grain with frames sharded over the mesh; returns
    (y', cb', cr', noise_energy, frame_count) with outputs sharded like
    the inputs and scalars replicated.

    shard_map (not bare jit-with-shardings) is the partitioning
    mechanism: the grain kernels are custom calls GSPMD cannot split,
    so each device runs them on its local frames and only the scalar
    statistics cross devices (psum). The parameter batch shards along
    frames exactly like the planes. ``backend``/``interpret`` as in
    grain_jax.apply_grain."""
    fn = _sharded_apply_fn(
        mesh, bit_depth, sub_x, sub_y, monochrome,
        backend or grain_jax.select_backend(), interpret,
    )
    with mesh:
        return fn(y, cb, cr, p)


@functools.lru_cache(maxsize=64)
def _sharded_apply_fn(
    mesh: Mesh, bit_depth, sub_x, sub_y, monochrome, backend, interpret
):
    """Jitted shard_map apply step, cached per (mesh, static config):
    rebuilding the closure per call would retrace (and, without the
    persistent cache, recompile) the sharded program on every batch of
    the render --shards flush loop."""
    axis = mesh.axis_names[0]
    shard = P(axis)

    fn = functools.partial(
        _apply_step,
        bit_depth=bit_depth,
        sub_x=sub_x,
        sub_y=sub_y,
        monochrome=monochrome,
        backend=backend,
        interpret=interpret,
        axis=axis,
    )
    plane = None if monochrome else shard
    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(shard, plane, plane, shard),
        out_specs=(shard, plane, plane, P(), P()),
        # pallas_call's out_shape carries no varying-mesh-axes type, so
        # the check cannot see through the grain kernels
        check_vma=False,
    )
    return jax.jit(mapped)


def sharded_apply(mesh: Mesh, y, cb, cr, p, bit_depth, **kw):
    """Sharded apply without the stats tuple."""
    y2, cb2, cr2, _, _ = sharded_apply_with_stats(
        mesh, y, cb, cr, p, bit_depth, **kw
    )
    return y2, cb2, cr2


def frame_shards(n_frames: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) frame ranges for multi-process sharding
    of inspect/diff. Shard boundaries should then be snapped to
    keyframes by the caller so per-shard parser state is self-contained
    (SURVEY §5: state machines are GOP-local)."""
    base = n_frames // n_shards
    rem = n_frames % n_shards
    out = []
    start = 0
    for i in range(n_shards):
        size = base + (1 if i < rem else 0)
        out.append((start, start + size))
        start += size
    return out
