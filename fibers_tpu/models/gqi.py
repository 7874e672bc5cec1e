"""Generalized Q-space Imaging (GQI) reconstruction.

Re-architected from the reference's per-voxel GEMV + scalar peak loop
(reference: src/gqi.jl:109-171) into one [N, nvol] x [nvol, nvert] GEMM
over the masked voxel batch, a neighbor-gather peak NMS, and a
`lax.top_k` instead of per-voxel sortperm.

Yeh et al. (2010), IEEE TMI 29(9):1626-1635.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..core.lazy import LazyVolume
from ..core.mri import MRI
from ..core.odf import ODF
from ..io.dispatch import mri_write_struct
from ..ops.peaks import build_neighbors, peak_mask, top_peaks

__all__ = ["GQI", "gqi_rec", "gqi_write", "find_peaks"]

NPEAK = 3


@dataclass
class GQI:
    """Outputs of a GQI fit.  (reference: src/gqi.jl:10-14)

    `_peak_dev` keeps the peak batch device-resident for the zero-fetch
    tractography handoff (core.handoff.DevicePeaks); runtime state,
    never written by `gqi_write`."""

    odf: MRI
    peak: List[MRI]
    qa: List[MRI]
    _peak_dev: object = None


def gqi_design(bval: np.ndarray, bvec: np.ndarray, odf_dirs: ODF,
               sigma: float = 1.25) -> np.ndarray:
    """System matrix A [nvert, nvol] = sinc(V_half (bvec sqrt(b*0.01506)
    sigma/pi)^T), normalized sinc.  (reference: src/gqi.jl:66-69)"""
    nvert = odf_dirs.nvert_half
    verts = odf_dirs.vertices[nvert:].astype(np.float64)
    bq = bvec.astype(np.float64) * (
        np.sqrt(bval.astype(np.float64) * 0.01506)[:, None] * (sigma / np.pi))
    return np.sinc(verts @ bq.T).astype(np.float32)


@partial(jax.jit, static_argnames=("npeak",))
def _gqi_kernel(signals, A, verts_first, nbr, nbr_valid, npeak=NPEAK):
    """signals [N, nvol] -> odf [N, nvert], peak vecs [N, npeak, 3],
    qa [N, npeak] (globally normalized), valid [N]."""
    s = jnp.maximum(signals, 0.0)
    valid = s.max(axis=1) > 0

    odf = jnp.dot(s, A.T, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)

    odfmin = odf.min(axis=1)

    is_peak = peak_mask(odf, nbr, nbr_valid)
    vals, idx, pvalid = top_peaks(odf, is_peak, npeak)
    pvalid = pvalid & valid[:, None]

    # Peak orientation vectors come from the FIRST half of the vertex table
    # (the antipode of the directions used in A), matching the reference's
    # vertices[isort[ipeak], :] lookup (reference: src/gqi.jl:154-155).
    vecs = verts_first[idx]                       # [N, npeak, 3]
    vecs = jnp.where(pvalid[..., None], vecs, 0.0)

    qa = jnp.where(pvalid, vals - odfmin[:, None], 0.0)

    # Global QA normalization by the max mean ODF across voxels
    # (reference: src/gqi.jl:164-168).  Out-of-mask voxels are zero there,
    # so the batch max over valid voxels is identical.
    odfmean = jnp.where(valid, odf.mean(axis=1), 0.0)
    odfmax = odfmean.max()
    qa = qa / jnp.maximum(odfmax, 1e-30)

    odf = jnp.where(valid[:, None], odf, 0.0)
    return odf, vecs, qa, valid


def find_peaks(o, odf_dirs: ODF):
    """Local-maximum vertices of ODF amplitudes `o` [..., nvert_half],
    sorted descending.  Returns (sorted indices, count of valid peaks).

    API parity with the reference's `find_peaks!` (reference:
    src/gqi.jl:180-201); batched.
    """
    from ..core.odf import half_sphere
    _, _, faces0 = half_sphere(odf_dirs)
    nvert = odf_dirs.nvert_half
    nbr, ok = build_neighbors(faces0, nvert)
    o = jnp.asarray(o)
    mask = peak_mask(o, jnp.asarray(nbr), jnp.asarray(ok))
    masked = jnp.where(mask, o, 0.0)
    order = jnp.argsort(-masked, axis=-1)
    nvalid = (masked > 0).sum(axis=-1)
    return np.asarray(order), np.asarray(nvalid)


def gqi_rec(dwi: MRI, mask: MRI, odf_dirs: ODF = None,
            sigma: float = 1.25, batch=None) -> GQI:
    """GQI reconstruction of DWIs.  (reference: src/gqi.jl:109-171)

    Returns a `GQI` structure with half-sphere ODF amplitudes, the top-3
    peak orientation vectors, and quantitative anisotropy per peak.
    """
    if dwi.bval is None or len(dwi.bval) == 0:
        raise ValueError("Missing b-value table from input DWI structure")
    if dwi.bvec is None or np.asarray(dwi.bvec).size == 0:
        raise ValueError("Missing gradient table from input DWI structure")

    if odf_dirs is None:
        from ..core import odf as _odf
        odf_dirs = _odf.sphere_642

    from ..utils.profiling import prof

    nvert = odf_dirs.nvert_half
    A = gqi_design(np.asarray(dwi.bval, np.float32),
                   np.asarray(dwi.bvec, np.float32), odf_dirs, sigma)

    from ..core.odf import half_sphere
    _, verts_first, faces0 = half_sphere(odf_dirs)
    nbr, nbr_ok = build_neighbors(faces0, nvert)

    with prof("gqi.gather_upload"):
        if batch is None:
            from ..core.batch import prepare_batch
            batch = prepare_batch(dwi, mask)
    idx, signals = batch.idx, batch.signals

    with prof("gqi.kernel"):
        odf_b, vecs_b, qa_b, valid_b = _gqi_kernel(
            signals, jnp.asarray(A), jnp.asarray(verts_first),
            jnp.asarray(nbr), jnp.asarray(nbr_ok))
        from ..ops.transfer import sync
        sync(vecs_b)

    shape3 = mask.vol.shape[:3]

    # Every large output stays device-resident: odf/peak/qa volumes
    # materialize to host lazily, and the DevicePeaks stash feeds
    # tractography with zero fetch (core.handoff).
    with prof("gqi.lazy_outputs"):
        odf = MRI.like(mask, nvert, np.float32)
        odf.vol = LazyVolume(odf_b, idx, shape3, nvert)

        peak, qa = [], []
        for ip in range(NPEAK):
            pm = MRI.like(mask, 3, np.float32)
            pm.vol = LazyVolume(vecs_b[:, ip, :], idx, shape3, 3)
            peak.append(pm)
            qm = MRI.like(mask, 1, np.float32)
            qm.vol = LazyVolume(qa_b[:, ip], idx, shape3, 1)
            qa.append(qm)

    from ..core.handoff import DevicePeaks
    return GQI(odf=odf, peak=peak, qa=qa,
               _peak_dev=DevicePeaks(vecs=vecs_b, amp=qa_b, idx=idx,
                                     ref=mask))


def gqi_write(gqi: GQI, basename: str) -> None:
    """Write GQI volumes as <basename>_<field>[i].nii.gz.
    (reference: src/gqi.jl:210-225)"""
    mri_write_struct(gqi, basename)
