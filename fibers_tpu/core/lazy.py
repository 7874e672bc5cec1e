"""Lazily-materialized MRI volumes.

Model fits produce their results as dense [Nmask, nframes] batches on
device.  Materializing every result into a host volume eagerly costs a
device->host transfer plus a full-volume scatter — costly for large
frame counts (a whole-brain half-sphere ODF batch is ~1 GB).  A
`LazyVolume` keeps the batch on device; `MRI.vol` transparently
materializes it into the usual [nx,ny,nz,nframes] host array the first
time any host code touches it.  Users that never read the field (e.g. a
pipeline consuming only peaks + FA) never pay the transfer.

The reference has no analogue (all host memory); this is deferred
evaluation at the framework boundary, not a semantic change — the
materialized array is identical to what the eager path produced.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LazyVolume", "LazyArray", "lazy_stack_volumes"]


class LazyArray:
    """Device array that fetches to host on first access (via the tuned
    chunked transfer path, not np.asarray's tiled-layout slow path).

    For fit outputs that are plain arrays rather than volumes (e.g. the
    structure tensor's eigenvector/eigenvalue fields): pipelines that
    keep consuming them on device never pay the device->host transfer.
    """

    def __init__(self, values):
        self._values = values
        self._host = None

    @property
    def device(self):
        """The underlying device array (None once materialized)."""
        return self._values

    @property
    def shape(self):
        return tuple(self._values.shape) if self._host is None \
            else self._host.shape

    @property
    def dtype(self):
        return np.dtype(self._values.dtype) if self._host is None \
            else self._host.dtype

    def __getitem__(self, key):
        return self.materialize()[key]

    def materialize(self) -> np.ndarray:
        if self._host is None:
            from ..ops.transfer import to_host
            self._host = to_host(self._values)
            self._values = None  # release HBM
        return self._host

    def __array__(self, dtype=None):
        a = self.materialize()
        return a.astype(dtype) if dtype is not None else a


class _StackFetch:
    """One [k, n_pad] device array shared by k lazy volumes: the first
    access fetches the whole stack in ONE wide transfer instead of k
    narrow ones."""

    def __init__(self, values):
        self._values = values
        self._host = None

    def row(self, i) -> np.ndarray:
        if self._host is None:
            from ..ops.transfer import to_host
            self._host = to_host(self._values)
            self._values = None  # release HBM
        return self._host[i]


def lazy_stack_volumes(stack_dev, idx, shape3):
    """Split a [k, n_pad] stacked device array into k single-frame
    `LazyVolume`s that share one device->host fetch."""
    fetch = _StackFetch(stack_dev)
    k = int(stack_dev.shape[0])
    return [_LazySliceVolume(fetch, i, idx, shape3) for i in range(k)]


class LazyVolume:
    """Device-resident masked batch that scatters into a host volume on
    demand.

    values: [n_pad, nframes] (or [n_pad]) device array, rows beyond
            len(idx) are padding.
    idx:    flat voxel indices (C order) of the masked voxels.
    shape3: the volume's spatial shape.
    nframes: number of frames (1 -> 3D output volume).
    """

    def __init__(self, values, idx, shape3, nframes):
        self._values = values
        self._idx = np.asarray(idx)
        self._shape3 = tuple(int(s) for s in shape3)
        self._nframes = int(nframes)
        self._host = None

    @property
    def shape(self):
        if self._nframes == 1:
            return self._shape3
        return self._shape3 + (self._nframes,)

    @property
    def dtype(self):
        return np.dtype(np.float32)

    def materialize(self) -> np.ndarray:
        """Fetch + scatter into the host volume (cached)."""
        if self._host is None:
            from ..ops.masked import scatter_frames
            from ..ops.transfer import to_host

            vals = to_host(self._values, n_lead=len(self._idx))
            self._host = scatter_frames(vals, self._idx, self._shape3)
            self._values = None  # release HBM
        return self._host

    def __array__(self, dtype=None):
        a = self.materialize()
        return a.astype(dtype) if dtype is not None else a


class _LazySliceVolume(LazyVolume):
    """A `LazyVolume` whose batch is one row of a shared `_StackFetch`
    (see `lazy_stack_volumes`)."""

    def __init__(self, fetch, row, idx, shape3):
        super().__init__(None, idx, shape3, 1)
        self._fetch = fetch
        self._row = int(row)

    def materialize(self) -> np.ndarray:
        if self._host is None:
            from ..ops.masked import scatter_frames
            vals = self._fetch.row(self._row)[:len(self._idx)]
            self._host = scatter_frames(vals, self._idx, self._shape3)
            self._fetch = None
        return self._host
