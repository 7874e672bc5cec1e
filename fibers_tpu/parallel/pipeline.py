"""Fused multi-model reconstruction step, shardable over a device mesh.

One jittable function covering the framework's compute shapes: the DTI
masked-WLS solve, the GQI ODF GEMM + peak extraction, one RUMBA-SD
Richardson-Lucy update, and a block of lockstep streamline-integration
steps.  Used by the multi-chip dry run and as the flagship compile target.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models.dti import _design_dti, _masked_wls, dti_maps
from ..models.gqi import gqi_design
from ..models.rumba import (_build_kernel, _gather_index, _tv_term,
                            besseli_ratio)
from ..ops.eig3 import eigh3
from ..ops.peaks import build_neighbors, peak_mask, top_peaks

__all__ = ["build_constants", "full_recon_step"]


def build_constants(bval, bvec, odf_dirs):
    """Host-side constant operands for `full_recon_step`."""
    from ..core.odf import half_sphere
    A_dti = _design_dti(bval, bvec)
    ib0 = (bval == bval.min()).astype(np.float32)
    A_gqi = gqi_design(bval, bvec, odf_dirs)
    kernel, _ = _build_kernel(bval, bvec, odf_dirs, 1.7e-3, 0.2e-3,
                              3.0e-3, 0.8e-4)
    _, verts_first, faces0 = half_sphere(odf_dirs)
    nbr, nbr_ok = build_neighbors(faces0, odf_dirs.nvert_half)
    return dict(A_dti=A_dti, ib0=ib0, A_gqi=A_gqi, kernel=kernel,
                verts_first=verts_first.astype(np.float32),
                nbr=nbr, nbr_ok=nbr_ok)


def full_recon_step(signals, rumba_signal, fodf, sig2, lam_flat, tv_idx,
                    seeds, seed_vecs, mask_flat, ovecs_flat, A_dti, ib0,
                    A_gqi, kernel, verts_first, nbr, nbr_ok, shape3,
                    tv_shape3, mesh=None):
    """One step of every compute path.  All leading axes are batch axes
    and shard across the mesh's data axis; the nvert/ncomp axes of the
    GEMM operands shard across the model axis.

    `lam_flat`/`tv_idx`/`tv_shape3` drive the RUMBA TV regularizer: the
    per-component difference stencils over the (bbox-cropped) TV grid —
    the one term whose gathers cross the batch sharding, included here so
    the multi-chip dry run proves it compiles and executes under GSPMD
    (reference: src/rusd.jl:183-235, 282-296).  With `mesh`, the TV
    stencil reshards over the component axis and runs per-device inside
    a shard_map.

    Returns (fa, odf, peaks, qa, fodf', sig2', lam', points, npts) —
    enough outputs to keep every path live under jit.  Feed fodf'/sig2'/
    lam' back as fodf/sig2/lam_flat to iterate.
    """
    hp = jax.lax.Precision.HIGHEST

    # --- DTI masked WLS + eigendecomposition ---
    d, valid = _masked_wls(signals, A_dti, ib0)
    evals, evecs = eigh3(d[:, 0:6])
    _, _, fa = dti_maps(evals[:, 0], evals[:, 1], evals[:, 2])
    fa = jnp.where(valid, fa, 0.0)

    # --- GQI ODF + peaks ---
    s = jnp.maximum(signals, 0.0)
    odf = jnp.dot(s, A_gqi.T, precision=hp)
    is_peak = peak_mask(odf, nbr, nbr_ok)
    vals, idx, pvalid = top_peaks(odf, is_peak, 3)
    peaks = jnp.where(pvalid[..., None], verts_first[idx], 0.0)
    odfmax = jnp.where(s.max(axis=1) > 0, odf.mean(axis=1), 0.0).max()
    qa = jnp.where(pvalid, vals - odf.min(axis=1, keepdims=True), 0.0) \
        / jnp.maximum(odfmax, 1e-30)

    # --- one RUMBA-SD Richardson-Lucy + TV update ---
    dodf = jnp.dot(fodf, kernel.T, precision=hp)
    dodf_sig = (rumba_signal * dodf) / sig2
    iratio = besseli_ratio(1, dodf_sig)
    rl = (jnp.dot(rumba_signal * iratio, kernel, precision=hp)
          / (jnp.dot(dodf, kernel, precision=hp) + 1e-7))
    tv_nxyz = int(np.prod(tv_shape3))
    gidx = _gather_index(tv_idx, fodf.shape[0], tv_nxyz)
    tv = _tv_term(fodf, gidx, tv_idx, lam_flat, tv_shape3, tv_nxyz,
                  mesh=mesh)
    fodf_new = jnp.maximum(fodf * rl * tv, 0.0)
    resid = ((rumba_signal ** 2 + dodf ** 2) / 2
             - (sig2 * dodf_sig) * iratio)
    sig2_new = jnp.clip(
        resid.sum(axis=1, keepdims=True) / rumba_signal.shape[1],
        (1.0 / 80) ** 2, (1.0 / 8) ** 2)
    lam_new = jnp.full_like(
        lam_flat, jnp.maximum(sig2_new.mean(), (1.0 / 30) ** 2))

    # --- a block of streamline-integration steps ---
    from ..tract.stream import _propagate
    # _propagate's stopping relies on mask-zeroed orientation vectors
    # (stream._build_ovec_array does this); enforce it here so callers
    # passing unzeroed ovecs keep mask semantics
    ovecs_masked = ovecs_flat * mask_flat[:, None, None]
    pts, saved, npts, _anchor = _propagate(
        seeds, seed_vecs, jnp.zeros(seeds.shape[0], jnp.int32),
        ovecs_masked, 8, shape3, 0.5,
        float(np.cos(np.radians(45.0))), 0.2, 64)

    return fa, odf, peaks, qa, fodf_new, sig2_new, lam_new, pts, npts
