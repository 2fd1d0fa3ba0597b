"""Multi-host orchestration — `jax.distributed` glue for multi-process runs.

The reference is single-process/single-device (SURVEY §2.5: no communication
backend beyond host<->GPU copies). This framework scales across hosts by
initializing the JAX distributed runtime and building one global mesh; the
sharded MSM (``parallel/sharded.py``) then runs unchanged — stages 1-4 stay
local to each device's point shard and the window-sum merge is one
all_gather (the all-gathered payload is ~KBs, so network latency is
immaterial).

Usage (same script on every host):

    from msm_tpu.parallel.multihost import init_multihost, global_mesh
    init_multihost("host0:1234", num_processes=2, process_id=rank)
    mesh = global_mesh()                # 1-D mesh over ALL chips, all hosts
    res = msm_tpu.run_tpu_msm_sharded(points, scalars, mesh=mesh)
"""

from __future__ import annotations

import jax
import numpy as np

from msm_tpu.parallel.sharded import default_mesh


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the JAX distributed runtime. Pass the coordinator address,
    process count and this process's id unless the cluster environment
    provides them."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "data"):
    """1-D mesh over every device of every host (jax.devices() is global
    after init_multihost)."""
    return default_mesh(jax.devices(), axis=axis)


def local_device_count() -> int:
    return jax.local_device_count()


def shard_global_inputs(mesh, axis: str, *host_arrays):
    """Build globally-sharded jax.Arrays from identical full host copies.

    The multi-host analogue of ``jax.device_put(x, NamedSharding(mesh, P(axis)))``
    — which only works when every mesh device is process-local. Each process
    materializes ONLY its addressable shards (first axis sharded over
    ``mesh[axis]``), so no host ever holds device memory for another host's
    slice and nothing crosses the network at input time."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    out = []
    for a in host_arrays:
        a = np.asarray(a)
        sharding = NamedSharding(mesh, P(axis, *([None] * (a.ndim - 1))))
        out.append(
            jax.make_array_from_callback(
                a.shape, sharding, lambda idx, a=a: a[idx]
            )
        )
    return tuple(out)


def run_msm_multihost(
    points,
    scalars,
    config=None,
    mesh=None,
    axis: str = "data",
):
    """End-to-end multi-host MSM: every process calls this with the SAME
    points/scalars (SPMD — same program, same data, different shards); the
    result is replicated so each process returns the same JPoint.

    Requires ``init_multihost()`` first. Single-process meshes work too (the
    code path is identical; collectives cross hosts only when they exist).
    """
    from msm_tpu.models import common
    from msm_tpu.models.geometry import pick_geometry
    from msm_tpu.params import pick_config
    from msm_tpu.parallel.sharded import sharded_window_sums

    if len(points) == 0:
        from msm_tpu.oracle.pyecc import IDENTITY

        return IDENTITY
    config = config or pick_config(len(points))
    mesh = mesh if mesh is not None else global_mesh(axis)
    d = mesh.devices.size
    if d & (d - 1):
        raise ValueError(f"device count {d} must be a power of two")
    x_u16, y_u16, s_u16 = common.pad_inputs(
        points, scalars, config, multiple=16 * d
    )
    geom = pick_geometry(x_u16.shape[0] // d, config.chunk_size)
    xd, yd, sd = shard_global_inputs(mesh, axis, x_u16, y_u16, s_u16)
    ws = sharded_window_sums(xd, yd, sd, config, geom, mesh, axis)
    return common.window_sums_to_result(np.asarray(ws), config)
