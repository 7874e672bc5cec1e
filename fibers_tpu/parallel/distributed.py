"""Multi-host initialization and data distribution helpers.

The reference is single-process (its only parallelism is shared-memory
threading, reference: src/dti.jl:258 etc.); fibers_tpu scales the same
workloads across hosts: `initialize()` wires jax.distributed on each
host, `global_mesh()` builds a global ("data", "model") mesh, and
`shard_voxel_batch()` places a host-local voxel batch into a globally
sharded array via `make_array_from_process_local_data` — XLA GSPMD then
inserts the collectives (SURVEY.md §5.8: the only cross-shard
dependencies are a handful of global reductions).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["initialize", "global_mesh", "shard_voxel_batch",
           "process_local_rows"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed for a multi-host run.

    Where no cluster environment announces them, pass all three
    explicitly (e.g. coordinator_address="localhost:<port>").  Safe to
    call once per process, before any other JAX API.  Single-process runs may skip this entirely.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh(model_axis: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """A ("data", "model") mesh over every device in the job (all hosts)."""
    devs = list(devices) if devices is not None else list(jax.devices())
    if len(devs) % model_axis:
        raise ValueError("model_axis must divide the global device count")
    shape = (len(devs) // model_axis, model_axis)
    return jax.make_mesh(shape, ("data", "model"), devices=devs,
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def process_local_rows(n_global: int) -> slice:
    """The half-open row range of the global voxel batch this process
    owns under even data-axis sharding."""
    p = jax.process_count()
    i = jax.process_index()
    per = -(-n_global // p)
    return slice(min(i * per, n_global), min((i + 1) * per, n_global))


def shard_voxel_batch(local_rows: np.ndarray, n_global: int,
                      mesh: Mesh) -> jax.Array:
    """Assemble a globally-sharded voxel batch from each process's local
    rows.

    The returned array has `ceil(n_global / process_count) *
    process_count` rows (single-process: exactly n_global) — rows beyond
    n_global are zero padding that callers must mask or slice off before
    reductions.  Single-process meshes fall back to a plain device_put.
    """
    sharding = NamedSharding(mesh, P("data"))
    if jax.process_count() == 1:
        per = n_global
        buf = local_rows
        if buf.shape[0] != n_global:
            pad = np.zeros((n_global - buf.shape[0],) + buf.shape[1:],
                           buf.dtype)
            buf = np.concatenate([buf, pad], axis=0)
        return jax.device_put(buf, sharding)

    per = -(-n_global // jax.process_count())
    if local_rows.shape[0] != per:
        pad = np.zeros((per - local_rows.shape[0],) + local_rows.shape[1:],
                       local_rows.dtype)
        local_rows = np.concatenate([local_rows, pad], axis=0)
    global_shape = (per * jax.process_count(),) + local_rows.shape[1:]
    return jax.make_array_from_process_local_data(
        sharding, local_rows, global_shape)
