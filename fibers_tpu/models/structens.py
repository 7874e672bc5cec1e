"""Structure-tensor reconstruction.

Re-architected from the reference's ImageFiltering convolutions + threaded
per-voxel eigendecomposition (reference: src/structens.jl:13-88) into
separable XLA convolutions (Gaussian smooth, Scharr gradients, reflect
padding) and the batched closed-form 3x3 eigensolver.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["st_recon", "st_eigen"]


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    """Odd-length Gaussian kernel matching ImageFiltering's
    KernelFactors.gaussian default length 4*ceil(sigma)+1."""
    r = int(4 * np.ceil(sigma)) // 2 * 2 // 2
    r = max(r, int(np.ceil(2 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-x * x / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


# Scharr 3-tap factors: derivative [-1/2, 0, 1/2] smoothed by
# [3/16, 10/16, 3/16] along the other axes (ImageFiltering's
# KernelFactors.scharr convention)
_SCHARR_SMOOTH = np.array([3.0, 10.0, 3.0], np.float32) / 16.0
_SCHARR_DERIV = np.array([-0.5, 0.0, 0.5], np.float32)


def _band_matrix(n: int, kernel: np.ndarray) -> np.ndarray:
    """[n, n] banded correlation matrix with the "symmetric" (edge-
    inclusive reflect) boundary folded into the edge rows — so the 1-D
    filtering becomes one GEMM instead of a batch-1/channel-1
    convolution (a shape XLA lowers to a ~100x-underutilized conv)."""
    r = (len(kernel) - 1) // 2
    b = np.zeros((n, n), np.float32)
    for i in range(n):
        for t, w in enumerate(np.asarray(kernel, np.float64)):
            j = i + t - r
            while j < 0 or j >= n:      # multiple reflections for k > n
                j = -1 - j if j < 0 else 2 * n - 1 - j
            b[i, j] += w
    return b


def _conv1d_reflect(vol, kernel, axis):
    """Separable 1D correlation along `axis` with reflect ("symmetric")
    boundary, matching imfilter(..., "reflect"); contracted as a banded
    [n, n] GEMM over the filtered axis (one dense matrix product in
    place of a [1, 1, ...]-shaped convolution)."""
    n = vol.shape[axis]
    b = jnp.asarray(_band_matrix(n, np.asarray(kernel)))
    v = jnp.moveaxis(vol, axis, 0)
    out = jnp.tensordot(b, v, axes=([1], [0]),
                        precision=jax.lax.Precision.HIGHEST)
    return jnp.moveaxis(out, 0, axis)


def _smooth(vol, sigma):
    k = _gaussian_kernel1d(sigma)
    for ax in range(3):
        vol = _conv1d_reflect(vol, k, ax)
    return vol


def _scharr_grad(vol, axis):
    for ax in range(3):
        k = _SCHARR_DERIV if ax == axis else _SCHARR_SMOOTH
        vol = _conv1d_reflect(vol, k, ax)
    return vol


@partial(jax.jit, static_argnames=("sigma", "rho"))
def _st_kernel(vol, sigma, rho):
    if sigma > 0:
        image = _smooth(vol, sigma)
    else:
        image = vol

    gx = _scharr_grad(image, 0)
    gy = _scharr_grad(image, 1)
    gz = _scharr_grad(image, 2)

    comps = [gx * gx, gx * gy, gx * gz, gy * gy, gy * gz, gz * gz]
    if rho > 0:
        comps = [_smooth(c, rho) for c in comps]

    u = jnp.stack(comps, axis=-1)           # [..., 6] unique elements
    from ..ops.eig3 import eigh3
    evals, evecs = eigh3(u)
    # The reference returns Julia `eigen` ordering: ascending eigenvalues
    # (reference: src/structens.jl:26-28); flip our descending output.
    return evecs[..., ::-1], evals[..., ::-1]


def st_eigen(sxx, sxy, sxz, syy, syz, szz):
    """Voxel-wise eigendecomposition of a symmetric tensor field.

    Returns (eigvec [..., 3, 3], eigval [..., 3]) with eigenvalues
    ascending, as in the reference (src/structens.jl:13-34).
    """
    u = jnp.stack([jnp.asarray(sxx), jnp.asarray(sxy), jnp.asarray(sxz),
                   jnp.asarray(syy), jnp.asarray(syz), jnp.asarray(szz)],
                  axis=-1)
    from ..ops.eig3 import eigh3
    from ..ops.transfer import to_host
    evals, evecs = eigh3(u)
    return to_host(evecs[..., ::-1]), to_host(evals[..., ::-1])


def st_recon(vol: np.ndarray, sigma: float, rho: float, lazy: bool = False,
             mesh=None):
    """Structure-tensor reconstruction: Gaussian pre-smooth (sigma), Scharr
    gradients, outer products, Gaussian post-smooth (rho), eigen-
    decomposition.  (reference: src/structens.jl:40-88)

    Returns (eigvec [X,Y,Z,3,3], eigval [X,Y,Z,3]), eigenvalues ascending.

    With `lazy=True` the outputs are `LazyArray`s: the ~110 MB
    evecs/evals fetch (which dominates wall time over the ~0.3 s kernel
    at HCP scale, BASELINE.md) is deferred until host code touches them
    — device-side consumers (e.g. orientation handoff) never pay it.

    With `mesh` (jax.sharding.Mesh) the volume is sharded over the
    mesh's "data" axis along the first volume dimension that divides it;
    the banded-GEMM filters then run data-parallel, with GSPMD inserting
    the halo collectives for the axis being filtered (the volumes are
    MBs, so these are cheap).  Like every other fit, multi-chip
    is a sharding annotation, not new code (SURVEY.md §7).
    """
    from ..core.lazy import LazyArray
    from ..ops.transfer import sync, to_host
    from ..utils.profiling import prof

    v = np.asarray(vol, np.float32)
    if v.ndim == 4:
        v = v[..., 0]
    dev = jnp.asarray(v)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        ndata = mesh.shape["data"]
        axis = next((i for i in range(3) if v.shape[i] % ndata == 0), None)
        if axis is not None:
            spec = [None, None, None]
            spec[axis] = "data"
            dev = jax.device_put(v, NamedSharding(mesh, P(*spec)))
        # no divisible axis: keep the single-device placement (correct,
        # just not sharded)
    with prof("structens.kernel"):
        evecs, evals = _st_kernel(dev, float(sigma), float(rho))
        sync(evals)
    if lazy:
        return LazyArray(evecs), LazyArray(evals)
    with prof("structens.fetch"):
        return to_host(evecs), to_host(evals)
