"""ADC and DTI tensor fitting as batched, jitted XLA computations.

Re-architected from the reference's per-voxel threaded loops
(reference: src/dti.jl:164-316) into the batched shape: gather masked
voxels into a dense [N, nvol] batch, run one fused weighted-least-squares
solve + closed-form 3x3 eigendecomposition over the whole batch, scatter
back into volumes.

The reference's two per-voxel code paths — cached pinv for all-positive
signals, per-voxel pinv of the positive subset otherwise
(reference: src/dti.jl:294-298) — collapse into a single masked WLS normal-
equations solve, which yields the same least-squares solution on the same
data with fixed shapes (no ragged work).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.mri import MRI
from ..io.dispatch import mri_write_struct
from ..ops.eig3 import eigh3
from ..ops.masked import scatter_frames

__all__ = ["DTI", "adc_fit", "dti_fit", "dti_fit_ls", "dti_maps", "dti_write"]


@dataclass
class DTI:
    """Outputs of a DTI fit.  (reference: src/dti.jl:11-22)"""

    s0: MRI
    eigval1: MRI
    eigval2: MRI
    eigval3: MRI
    eigvec1: MRI
    eigvec2: MRI
    eigvec3: MRI
    rd: MRI
    md: MRI
    fa: MRI


def _design_adc(bval: np.ndarray) -> np.ndarray:
    """[nvol, 2] design for log-linear ADC fit.  (reference: src/dti.jl:66-69)"""
    a = np.stack([-bval, np.ones_like(bval)], axis=1)
    return a.astype(np.float32)


def _design_dti(bval: np.ndarray, bvec: np.ndarray) -> np.ndarray:
    """[nvol, 7] design for log-linear tensor fit.
    (reference: src/dti.jl:129-140)"""
    gx, gy, gz = bvec[:, 0], bvec[:, 1], bvec[:, 2]
    a = np.stack([
        gx * gx, 2 * gx * gy, 2 * gx * gz, gy * gy, 2 * gy * gz, gz * gz,
    ], axis=1)
    a = -bval[:, None] * a
    a = np.concatenate([a, np.ones((len(bval), 1))], axis=1)
    return a.astype(np.float32)


def _masked_wls(signals, A, ib0):
    """Masked log-linear least squares over a [N, nvol] batch.

    Uses only strictly positive signals per voxel (reference:
    src/dti.jl:290-298).  Column-equilibrated normal equations keep the
    f32 solve well conditioned for b ~ 1000s.  Returns (d [N, nparam],
    valid [N]).
    """
    nparam = A.shape[1]
    ipos = signals > 0
    w = ipos.astype(signals.dtype)
    npos = w.sum(axis=1)

    # Validity gate (reference: src/dti.jl:294-299): all-positive, or >6
    # positives including a positive b=0 measurement
    has_b0 = (w * ib0[None, :]).sum(axis=1) > 0
    valid = (npos == signals.shape[1]) | ((npos > 6) & has_b0)

    logs = jnp.log(jnp.where(ipos, signals, 1.0))

    # Column equilibration: A_s = A / colnorm
    colnorm = jnp.sqrt((A * A).sum(axis=0))
    As = A / colnorm[None, :]

    # G = As^T diag(w) As  [N, p, p];  rhs = As^T (w .* logs)  [N, p].
    # G contracts as ONE dense [N, nvol] x [nvol, p^2] GEMM against the
    # precomputed per-volume outer products — the per-voxel einsum form
    # lowers to N tiny 7x7 contractions.
    # HIGHEST precision: these solves need true f32 products (reduced-
    # precision matmul inputs lose ~1e-2 relative here).
    b_outer = (As[:, :, None] * As[:, None, :]).reshape(
        A.shape[0], nparam * nparam)
    g = jnp.dot(w, b_outer,
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32).reshape(
        -1, nparam, nparam)
    rhs = jnp.einsum("nv,vi->ni", w * logs, As,
                     precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.float32)

    eye = jnp.eye(nparam, dtype=signals.dtype)
    g = jnp.where(valid[:, None, None], g, eye)
    d = _chol_solve_small(g + 1e-8 * eye, rhs)
    d = d / colnorm[None, :]
    return d, valid


def _chol_solve_small(g, rhs):
    """Batched SPD solve for a small static p (the 7-param tensor fit),
    fully unrolled into [N]-vector ops.

    jnp.linalg.cholesky + cho_solve on [N, 7, 7] batches lowers to a
    loop-heavy LAPACK-shaped program that costs far more than the
    normal-equation GEMM; the unrolled
    Cholesky + two substitutions are ~250 fusable elementwise ops on
    [N] vectors instead."""
    p = g.shape[-1]
    L = [[None] * p for _ in range(p)]
    for i in range(p):
        for j in range(i + 1):
            s = g[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * p
    for i in range(p):
        s = rhs[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * p
    for i in reversed(range(p)):
        s = y[i]
        for k in range(i + 1, p):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=1)


def dti_maps(eigval1, eigval2, eigval3):
    """RD, MD, FA from tensor eigenvalues.  (reference: src/dti.jl:325-335)"""
    rd = eigval2 + eigval3
    md = (eigval1 + rd) / 3
    rd = rd / 2
    denom = eigval1**2 + eigval2**2 + eigval3**2
    fa = jnp.sqrt(
        ((eigval1 - md) ** 2 + (eigval2 - md) ** 2 + (eigval3 - md) ** 2)
        / jnp.maximum(denom, 1e-30) * 1.5)
    return rd, md, fa


@partial(jax.jit, static_argnames=())
def _adc_kernel(signals, A, ib0):
    d, valid = _masked_wls(signals, A, ib0)
    adc = jnp.where(valid, d[:, 0], 0.0)
    s0 = jnp.where(valid, jnp.exp(d[:, 1]), 0.0)
    return adc, s0


# Column layout of the packed DTI result [N, 16]: one device->host fetch
# instead of ten (per-transfer latency dominates small fetches)
_DTI_COLS = dict(s0=(0, 1), eigval1=(1, 2), eigval2=(2, 3), eigval3=(3, 4),
                 eigvec1=(4, 7), eigvec2=(7, 10), eigvec3=(10, 13),
                 rd=(13, 14), md=(14, 15), fa=(15, 16))


@partial(jax.jit, static_argnames=())
def _dti_kernel(signals, A, ib0):
    d, valid = _masked_wls(signals, A, ib0)

    s0 = jnp.exp(d[:, 6])
    evals, evecs = eigh3(d[:, 0:6])

    l1, l2, l3 = evals[:, 0], evals[:, 1], evals[:, 2]
    rd, md, fa = dti_maps(l1, l2, l3)

    packed = jnp.concatenate([
        s0[:, None], l1[:, None], l2[:, None], l3[:, None],
        evecs[:, :, 0], evecs[:, :, 1], evecs[:, :, 2],
        rd[:, None], md[:, None], fa[:, None]], axis=1)
    return jnp.where(valid[:, None], packed, 0.0)


def adc_fit(dwi: MRI, mask: MRI, batch=None):
    """Fit the apparent diffusion coefficient.  Returns (adc, s0) MRIs.

    (reference: src/dti.jl:164-213)

    `batch`: optional prepared `VoxelBatch` to reuse one gather/upload
    across several fits, like dti_fit/gqi_rec."""
    if dwi.bval is None or len(dwi.bval) == 0:
        raise ValueError("Missing b-value table from input DWI structure")

    if batch is None:
        from ..core.batch import prepare_batch
        batch = prepare_batch(dwi, mask)
    idx, signals = batch.idx, batch.signals
    A = _design_adc(np.asarray(dwi.bval, np.float32))
    ib0 = (dwi.bval == dwi.bval.min()).astype(np.float32)

    adc_d, s0_d = _adc_kernel(jnp.asarray(signals), jnp.asarray(A),
                              jnp.asarray(ib0))
    from ..ops.transfer import to_host
    both = to_host(jnp.stack([adc_d, s0_d]))     # one round trip, not two
    adc_v, s0_v = both[0, :len(idx)], both[1, :len(idx)]

    shape3 = mask.vol.shape[:3]
    adc = MRI.like(mask, 1, np.float32)
    s0 = MRI.like(mask, 1, np.float32)
    adc.vol = scatter_frames(adc_v, idx, shape3)
    s0.vol = scatter_frames(s0_v, idx, shape3)
    return adc, s0


def dti_fit(dwi: MRI, mask: MRI, batch=None) -> DTI:
    """Fit tensors to DWIs; returns a `DTI` structure.
    (reference: src/dti.jl:221-232)

    `batch`: optional prepared `VoxelBatch` (see core.batch.prepare_batch)
    to reuse one gather/upload across several fits."""
    if dwi.bval is None or len(dwi.bval) == 0:
        raise ValueError("Missing b-value table from input DWI structure")
    if dwi.bvec is None or np.asarray(dwi.bvec).size == 0:
        raise ValueError("Missing gradient table from input DWI structure")
    return dti_fit_ls(dwi, mask, batch=batch)


def dti_fit_ls(dwi: MRI, mask: MRI, batch=None) -> DTI:
    """Least-squares tensor fit.

    Basser et al. (1994), J Magn Reson B 103(3):247-254.
    (reference: src/dti.jl:243-316)
    """
    from ..utils.profiling import prof

    with prof("dti.gather_upload"):
        if batch is None:
            from ..core.batch import prepare_batch
            batch = prepare_batch(dwi, mask)
    idx, signals = batch.idx, batch.signals
    A = _design_dti(np.asarray(dwi.bval, np.float32),
                    np.asarray(dwi.bvec, np.float32))
    ib0 = (dwi.bval == dwi.bval.min()).astype(np.float32)

    from ..ops.transfer import sync
    with prof("dti.kernel"):
        packed = _dti_kernel(signals, jnp.asarray(A), jnp.asarray(ib0))
        sync(packed)
    from ..ops.transfer import to_host
    with prof("dti.fetch"):
        arr = to_host(packed, n_lead=len(idx))
    out = {k: (arr[:, lo] if hi - lo == 1 else arr[:, lo:hi])
           for k, (lo, hi) in _DTI_COLS.items()}

    shape3 = mask.vol.shape[:3]

    def vol1(name):
        m = MRI.like(mask, 1, np.float32)
        m.vol = scatter_frames(out[name], idx, shape3)
        return m

    def vol3(name):
        m = MRI.like(mask, 3, np.float32)
        m.vol = scatter_frames(out[name], idx, shape3)
        return m

    return DTI(
        s0=vol1("s0"),
        eigval1=vol1("eigval1"), eigval2=vol1("eigval2"),
        eigval3=vol1("eigval3"),
        eigvec1=vol3("eigvec1"), eigvec2=vol3("eigvec2"),
        eigvec3=vol3("eigvec3"),
        rd=vol1("rd"), md=vol1("md"), fa=vol1("fa"),
    )


def dti_write(dti: DTI, basename: str) -> None:
    """Write DTI volumes as <basename>_<field>.nii.gz.
    (reference: src/dti.jl:344-349)"""
    mri_write_struct(dti, basename)
