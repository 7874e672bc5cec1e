"""Device-mesh sharding for the voxel/seed batch axes.

The workload is embarrassingly parallel over masked voxels (fits) and seeds
(tractography); the only cross-shard dependencies are the global reductions
(GQI/DSI QA normalization, RUMBA's mean-sigma^2/lambda updates — see
SURVEY.md §5.8).  Sharding is therefore a NamedSharding annotation on the
batch axis plus optional model-axis sharding of the big GEMM operands; XLA
GSPMD inserts the all-reduces.

The mesh is a plain 2-D ("data", "model") grid with no assumption about
how the devices are wired; XLA lowers the collectives (NCCL on GPUs).
(The reference's only parallelism is shared-memory threading,
reference: src/dti.jl:258 etc.)
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "batch_sharding", "batch_model_sharding",
           "put_batch", "pad_to_multiple"]


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """A ("data", "model") mesh over the first n devices.

    `model_axis` > 1 additionally shards GEMM operands (kernel columns /
    ODF vertices) across that many devices.
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"Requested {n_devices} devices, have {len(devs)}")
    if n_devices % model_axis:
        raise ValueError("model_axis must divide n_devices")
    shape = (n_devices // model_axis, model_axis)
    # Auto axis types: let GSPMD propagate shardings through gathers/
    # reductions instead of requiring explicit out_shardings everywhere.
    return jax.make_mesh(shape, ("data", "model"),
                         devices=devs[:n_devices],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (voxel/seed) axis across the data axis."""
    return NamedSharding(mesh, P("data"))


def batch_model_sharding(mesh: Mesh) -> NamedSharding:
    """Shard [batch, feature] across (data, model)."""
    return NamedSharding(mesh, P("data", "model"))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def put_batch(arr: np.ndarray, mesh: Mesh):
    """Pad the leading axis to the data-axis size and place sharded."""
    ndata = mesh.shape["data"]
    n_pad = pad_to_multiple(arr.shape[0], ndata)
    if n_pad != arr.shape[0]:
        pad = np.zeros((n_pad - arr.shape[0],) + arr.shape[1:], arr.dtype)
        arr = np.concatenate([arr, pad], axis=0)
    return jax.device_put(arr, batch_sharding(mesh))
