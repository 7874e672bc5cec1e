"""RUMBA-SD: robust and unbiased model-based spherical deconvolution.

Re-architected from the reference's threaded whole-brain matrix iteration
(reference: src/rusd.jl:241-339) into a single jitted update step over the
[Nmask, ndir]/[Nmask, ncomp] batch: Richardson-Lucy ratio via two
GEMMs, Rician/noncentral-chi likelihood through Perron's continued-fraction
Bessel ratio, TV regularization as component-chunked 3D difference
stencils, and the noise-variance/lambda updates as in-graph reductions.

Canales-Rodriguez et al. (2015), PLoS ONE 10(10):e0138910.
"""

from __future__ import annotations

import os

from dataclasses import dataclass
from functools import partial
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..core.mri import MRI
from ..core.odf import ODF
from ..io.dispatch import mri_write_struct
from ..ops.masked import mask_indices
from ..utils.coords import ang2rot, cart2sph

__all__ = ["RUMBASD", "rumba_rec", "rumba_write", "rumba_peaks",
           "tensor_model", "besseli_ratio", "PaceAbortError"]


class PaceAbortError(RuntimeError):
    """Raised by rumba_rec(abort_s_per_iter=...) when the measured
    iteration pace exceeds the budget, so a benchmark runner can abandon
    a run whose device has slowed down instead of recording it."""

NPEAK = 5
FTHRESH = 0.1
# Components per TV stencil pass in the single-device lax.map.  Not
# tuned for the GPU: the value bounds the live stencil volumes.
_TV_CHUNK = 128
_BLOCK_ITERS = 25

# Matmul precision of the R-L GEMMs.  On the H100, XLA lowers a float32
# dot at "high" and at "default" to TF32 tensor-core GEMMs (relative
# error ~1e-4 per product) and at "highest" to a true float32 GEMM
# (~1e-6).  "high" is the default: 25 iterations on a full-width crop
# stay inside the oracle tolerance of tests/test_oracle.py (PERF.md).
_PRECISIONS = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}
DEFAULT_PRECISION = "high"


@dataclass
class RUMBASD:
    """Outputs of a RUMBA-SD fit.  (reference: src/rusd.jl:11-20)

    `_peak_dev` additionally keeps the peak batch device-resident (unit
    directions + volume-fraction amplitudes) so `peaks_to_ovecs(rec,
    device=True)` can hand tractography a zero-copy orientation field;
    it is runtime state, never written by `rumba_write`."""

    fodf: MRI
    fgm: MRI
    fcsf: MRI
    peak: List[MRI]
    gfa: MRI
    var: MRI
    snr_mean: float
    snr_std: float
    _peak_dev: object = None


def tensor_model(phi, theta, lam, b, g, s0=1.0):
    """Expected DWI signal of an axially-oriented tensor.
    (reference: src/rusd.jl:141-153)"""
    lam = np.asarray(lam, np.float64)
    if lam.shape[-1] != 3:
        raise ValueError(f"Length of diffusivity vector {lam} must be 3")
    r = ang2rot(phi, theta)
    d = r @ np.diag(lam) @ r.T
    quad = np.einsum("vi,ij,vj->v", g, d, g)
    return s0 * np.exp(-np.asarray(b, np.float64) * quad)


def besseli_ratio(nu, z):
    """I_nu(z) / I_{nu-1}(z) by Perron's continued fraction.
    (reference: src/rusd.jl:170-177)"""
    return z / ((2 * nu + z)
                - ((2 * nu + 1) * z
                   / (2 * z + (2 * nu + 1)
                      - ((2 * nu + 3) * z
                         / ((2 * nu + 2) + 2 * z
                            - ((2 * nu + 5) * z
                               / ((2 * nu + 3) + 2 * z)))))))


def _build_kernel(bval, bvec, odf_dirs, lam_para, lam_perp, lam_csf, lam_gm):
    """Multi-tensor reconstruction kernel [ndir, nvert + 2].
    (reference: src/rusd.jl:447-517)"""
    ib0 = bval == bval.min()
    gsub = bvec[~ib0]
    gnorm = np.sqrt((gsub ** 2).sum(axis=1, keepdims=True))
    with np.errstate(invalid="ignore"):
        gsub = np.where(gnorm > 0, gsub / gnorm, 0.0)
    g = np.vstack([np.zeros((1, 3)), gsub])
    b = np.concatenate([[0.0], bval[~ib0]])

    nvert = odf_dirs.nvert_half
    verts2 = odf_dirs.vertices[nvert:]           # second half, like the ref
    phi, theta, _ = cart2sph(verts2[:, 0], verts2[:, 1], verts2[:, 2])
    theta = -theta

    kernel = np.zeros((len(b), nvert + 2), np.float64)
    for iv in range(nvert):
        kernel[:, iv] = tensor_model(phi[iv], theta[iv],
                                     [lam_para, lam_perp, lam_perp], b, g)
    kernel[:, nvert] = tensor_model(0.0, 0.0, [lam_csf] * 3, b, g)
    kernel[:, nvert + 1] = tensor_model(0.0, 0.0, [lam_gm] * 3, b, g)
    return kernel.astype(np.float32), ib0


def _angular_neighbors(odf_dirs: ODF):
    """Padded neighbor table within the angular neighborhood used for peak
    NMS (reference: src/rusd.jl:477-493)."""
    nvert = odf_dirs.nvert_half
    half = odf_dirs.vertices[:nvert].astype(np.float64)
    ang_neig = 16.0 if nvert * 2 == 362 else 12.5

    cosang = np.clip(half @ half.T, -1.0, 1.0)
    ang = np.degrees(np.arccos(cosang))
    ang = np.minimum(ang, 180.0 - ang)
    isneig = ang < ang_neig
    np.fill_diagonal(isneig, False)

    maxdeg = int(isneig.sum(axis=1).max())
    nbr = np.zeros((nvert, maxdeg), np.int32)
    ok = np.zeros((nvert, maxdeg), bool)
    for v in range(nvert):
        idxs = np.nonzero(isneig[v])[0]
        nbr[v, :len(idxs)] = idxs
        ok[v, :len(idxs)] = True
    return nbr, ok


def _tv_stencil(v, lam):
    """Forward-difference gradient, normalized, then divergence — the TV
    multiplier volume for a channels-minor [nx, ny, nz, C] component
    stack.  Channels-minor keeps every spatial neighbour read a
    contiguous run of C values, so the shifted reads stream instead of
    striding.  (reference: src/rusd.jl:183-235)"""
    # Forward differences with clamped upper edge
    # (reference: src/rusd.jl:183-188)
    gx = jnp.concatenate([v[1:], v[-1:]], axis=0) - v
    gy = jnp.concatenate([v[:, 1:], v[:, -1:]], axis=1) - v
    gz = jnp.concatenate([v[:, :, 1:], v[:, :, -1:]], axis=2) - v

    # one divide + three multiplies instead of three divides
    ninv = 1.0 / jnp.sqrt(gx * gx + gy * gy + gz * gz + 1e-7)
    gx, gy, gz = gx * ninv, gy * ninv, gz * ninv

    # Divergence with boundary rows (reference: src/rusd.jl:194-206)
    def ddiv(gr, ax):
        lead = jax.lax.slice_in_dim(gr, 0, 1, axis=ax)
        mid = (jax.lax.slice_in_dim(gr, 1, gr.shape[ax] - 1, axis=ax)
               - jax.lax.slice_in_dim(gr, 0, gr.shape[ax] - 2, axis=ax))
        last = -jax.lax.slice_in_dim(gr, gr.shape[ax] - 2,
                                     gr.shape[ax] - 1, axis=ax)
        return jnp.concatenate([lead, mid, last], axis=ax)

    div = ddiv(gx, 0) + ddiv(gy, 1) + ddiv(gz, 2)
    div = div.astype(jnp.float32)
    return 1.0 / (jnp.abs(1.0 - lam[..., None] * div) + 1e-7)


def _tv_term(fodf, gidx, idx_mask, lam_flat, shape3, nxyz, mesh=None,
             tv_bf16=False):
    """Total-variation multiplier for every component.
    (reference: src/rusd.jl:183-235, src/rusd.jl:282-296)

    The mask embedding uses `gidx` (volume voxel -> batch row, padding
    row for out-of-mask) so it lowers to a GATHER — a scatter here
    measured ~1.7 s/iteration at HCP scale, ~90x the rest of the
    iteration combined.  Both gathers move whole [C]-component rows
    (channels minor), which are contiguous reads.
    `shape3`/`nxyz`/`gidx`/`idx_mask` describe the TV grid, which
    rumba_rec crops to the mask bounding box + 1-voxel halo (exact:
    every stencil value a mask voxel reads is reproduced).

    Single-device: components are processed in lax.map chunks so only
    _TV_CHUNK volumes are live at a time.  With `mesh`, the component
    axis is sharded across the mesh instead — each device owns whole TV
    volumes for its components, so the stencil and both gathers stay
    device-local; the only collectives are the two reshards (batch-
    sharded fodf -> component-sharded stack and back), written as
    explicit all-to-alls inside a shard_map.

    `tv_bf16` evaluates the stencil volumes in bfloat16 (the multiplier
    is regularization, not the estimate; memory traffic halves)."""
    n, ncomp = fodf.shape
    nmask = idx_mask.shape[0]
    # gather-back index padded to the row count (padding rows read cell 0
    # of the TV grid; their fODF is identically zero so the value is moot)
    idx_back = idx_mask if nmask == n else jnp.concatenate(
        [idx_mask, jnp.zeros(n - nmask, idx_mask.dtype)])

    lam = lam_flat.reshape(shape3)
    dt = jnp.bfloat16 if tv_bf16 else fodf.dtype

    if mesh is not None:
        # Component-parallel path.  The reshard collectives are explicit
        # so the per-device blocks line up with the outer P("data", None)
        # sharding exactly (no involuntary remat at the boundary): an
        # all-to-all over "data" turns the row-sharded block into
        # full-volume rows x 1/D of the components, a free local slice
        # over the remaining axes splits those further, and the way back
        # is an all-gather over the remaining axes plus the reverse
        # all-to-all.
        ndev = mesh.devices.size
        axes = tuple(mesh.axis_names)
        rest = tuple(a for a in axes if a != "data")
        pad = (-ncomp) % ndev
        cpad = ncomp + pad
        local_c = cpad // ndev
        from jax.sharding import PartitionSpec as P
        fodf_p = jnp.pad(fodf.astype(dt), ((0, 0), (0, pad)))

        def local_tv(fodf_block, lam_l, gidx_l, idx_back_l):
            # [n/D, cpad] -> [n, cpad/D]
            x = jax.lax.all_to_all(fodf_block, "data", split_axis=1,
                                   concat_axis=0, tiled=True)
            if rest:
                ri = jnp.int32(0)
                for a in rest:
                    ri = ri * mesh.shape[a] + jax.lax.axis_index(a)
                # comps are replicated over `rest`: slicing is local
                x = jax.lax.dynamic_slice_in_dim(
                    x, ri * local_c, local_c, axis=1)
            # padding row for the out-of-mask gather target
            x = jnp.concatenate(
                [x, jnp.zeros((1, local_c), x.dtype)], axis=0)
            v = x[gidx_l].reshape(shape3 + (local_c,))
            tvl = _tv_stencil(v, lam_l)
            tvl = tvl.reshape(nxyz, local_c)[idx_back_l]
            if rest:
                tvl = jax.lax.all_gather(
                    tvl, rest, axis=1, tiled=True)      # [n, cpad/D]
            return jax.lax.all_to_all(tvl, "data", split_axis=0,
                                      concat_axis=1, tiled=True)

        tv = jax.shard_map(
            local_tv, mesh=mesh,
            in_specs=(P("data", None), P(), P(), P()),
            out_specs=P("data", None),
            check_vma=False)(fodf_p, lam, gidx, idx_back)
        return tv[:, :ncomp]

    pad = (-ncomp) % _TV_CHUNK
    nchunks = (ncomp + pad) // _TV_CHUNK
    # pad components to the chunk size AND append the zero padding row
    # (the gather target for out-of-mask voxels) once, up front
    fodf_p = jnp.pad(fodf.astype(dt), ((0, 1), (0, pad)))
    chunks = jnp.moveaxis(
        fodf_p.reshape(n + 1, nchunks, _TV_CHUNK), 1, 0)

    def one_chunk(chunk):
        v = chunk[gidx].reshape(shape3 + (_TV_CHUNK,))   # row gather
        tv = _tv_stencil(v, lam)
        return tv.reshape(nxyz, _TV_CHUNK)[idx_back]

    tv_chunks = jax.lax.map(one_chunk, chunks)           # [nc, n, C]
    return jnp.moveaxis(tv_chunks, 0, 1).reshape(
        n, nchunks * _TV_CHUNK)[:, :ncomp]


def _gather_index(idx_mask, n, nxyz):
    """Volume-voxel -> batch-row index (out-of-mask -> padding row n),
    turning the per-iteration mask embedding into a gather.  `n` may
    exceed len(idx_mask) when the batch carries padding rows; those rows
    are simply never gathered."""
    return jnp.full((nxyz,), n, jnp.int32).at[idx_mask].set(
        jnp.arange(idx_mask.shape[0], dtype=jnp.int32))


def _rumba_step_core(fodf, dodf, dodf_sig, sig2, lam_flat, signal, kernel,
                     idx_mask, gidx, n_order, ipat_factor, use_tv, shape3,
                     nxyz, precision=DEFAULT_PRECISION, mesh=None,
                     tv_bf16=False):
    """One RUMBA-SD iteration over the voxel batch (traceable body shared
    by the single-step and fori_loop-block entry points).
    (reference: src/rusd.jl:266-339)"""
    eps = 1e-7
    hp = _PRECISIONS[precision]

    iratio = besseli_ratio(n_order, dodf_sig)

    rl_num = jnp.dot(signal * iratio, kernel, precision=hp)
    rl_den = jnp.dot(dodf, kernel, precision=hp) + eps
    rl = rl_num / rl_den

    if use_tv:
        tv = _tv_term(fodf, gidx, idx_mask, lam_flat, shape3, nxyz,
                      mesh=mesh, tv_bf16=tv_bf16)
    else:
        tv = 1.0

    fodf = jnp.maximum(fodf * rl * tv, 0.0)

    dodf = jnp.dot(fodf, kernel.T, precision=hp)
    dodf_sig = (signal * dodf) / sig2

    # Noise-variance update (reference: src/rusd.jl:314-323)
    resid = ((signal ** 2 + dodf ** 2) / 2
             - (sig2 * dodf_sig) * iratio)
    ndir = signal.shape[1]
    sig2 = resid.sum(axis=1, keepdims=True) / (n_order * ndir)
    sig2 = jnp.clip(sig2, (1.0 / 80) ** 2, (1.0 / 8) ** 2)

    # Lambda update (reference: src/rusd.jl:326-339).  With padding rows
    # in the batch, the mean and scatter use only the real voxels.
    nmask = idx_mask.shape[0]
    if use_tv:
        if ipat_factor == 1:
            lam_flat = jnp.full_like(
                lam_flat, jnp.maximum(sig2[:nmask].mean(), (1.0 / 30) ** 2))
        else:
            lam_flat = jnp.zeros_like(lam_flat).at[idx_mask].set(
                sig2[:nmask, 0])

    snr = 1.0 / jnp.sqrt(sig2)
    return fodf, dodf, dodf_sig, sig2, lam_flat, snr


@partial(jax.jit, static_argnames=("n_order", "ipat_factor", "use_tv",
                                   "shape3", "nxyz", "precision", "mesh",
                                   "tv_bf16"))
def _rumba_step(fodf, dodf, dodf_sig, sig2, lam_flat, signal, kernel,
                idx_mask, n_order, ipat_factor, use_tv, shape3, nxyz,
                precision=DEFAULT_PRECISION, mesh=None, tv_bf16=False):
    gidx = _gather_index(idx_mask, fodf.shape[0], nxyz)
    return _rumba_step_core(fodf, dodf, dodf_sig, sig2, lam_flat, signal,
                            kernel, idx_mask, gidx, n_order, ipat_factor,
                            use_tv, shape3, nxyz, precision, mesh, tv_bf16)


@partial(jax.jit, static_argnames=("k", "n_order", "ipat_factor", "use_tv",
                                   "shape3", "nxyz", "precision", "mesh",
                                   "tv_bf16"))
def _rumba_block(fodf, dodf, dodf_sig, sig2, lam_flat, signal, kernel,
                 idx_mask, k, n_order, ipat_factor, use_tv, shape3, nxyz,
                 precision=DEFAULT_PRECISION, mesh=None, tv_bf16=False):
    """k RUMBA-SD iterations in one dispatch via lax.fori_loop, so the
    600-iteration fit costs 24 dispatches instead of 600."""
    snr = 1.0 / jnp.sqrt(sig2)
    gidx = _gather_index(idx_mask, fodf.shape[0], nxyz)

    def body(_, st):
        fodf, dodf, dodf_sig, sig2, lam_flat, _snr = st
        return _rumba_step_core(
            fodf, dodf, dodf_sig, sig2, lam_flat, signal, kernel,
            idx_mask, gidx, n_order, ipat_factor, use_tv, shape3,
            nxyz, precision, mesh, tv_bf16)

    return jax.lax.fori_loop(
        0, k, body, (fodf, dodf, dodf_sig, sig2, lam_flat, snr))


@partial(jax.jit, static_argnames=("nmask",))
def _snr_stats(sig2, nmask):
    """Mean/std of SNR = 1/sigma over the real (non-padding) voxels,
    reduced on device so the host fetches two scalars."""
    snr = 1.0 / jnp.sqrt(sig2[:nmask, 0])
    m = snr.mean()
    var = ((snr - m) ** 2).sum() / jnp.maximum(nmask - 1, 1)
    return m, jnp.sqrt(jnp.maximum(var, 0.0))


@partial(jax.jit, static_argnames=("nvert",))
def _rumba_post(fodf, nvert):
    """Energy normalization, isotropic-fraction embedding, and GFA — all
    on device (reference: src/rusd.jl:560-596)."""
    fodf = fodf / (fodf.sum(axis=1, keepdims=True) + 1e-7)
    fodf_wm = fodf[:, :nvert]
    fcsf = fodf[:, nvert]
    fgm = fodf[:, nvert + 1]
    f_iso = fcsf + fgm

    fodf_full = fodf_wm + f_iso[:, None]
    s = fodf_full.sum(axis=1, keepdims=True)
    fodf_full = jnp.where(s > 0, fodf_full / jnp.maximum(s, 1e-30), 0.0)

    std = fodf_full.std(axis=1, ddof=1)
    rms = jnp.sqrt((fodf_full ** 2).mean(axis=1))
    gfa = jnp.where(rms > 0, std / jnp.maximum(rms, 1e-30), 0.0)
    return fodf_full, fgm, fcsf, f_iso, gfa


@partial(jax.jit, static_argnames=("npeak",))
def _rumba_peaks_kernel(fodf_full, f_iso, half_verts, nbr, nbr_ok,
                        fthresh, npeak=NPEAK):
    """Batched peak extraction with angular-neighborhood NMS and f_iso-
    scaled threshold (reference: src/rusd.jl:348-373, src/rusd.jl:602-633)."""
    thr_xyz = fthresh / jnp.maximum(1.0 - f_iso, 1e-7)       # [N]
    thr_abs = thr_xyz * fodf_full.max(axis=1)

    gathered = fodf_full[:, nbr]
    neg = jnp.asarray(-jnp.inf, fodf_full.dtype)
    gathered = jnp.where(nbr_ok[None], gathered, neg)
    nbr_max = gathered.max(axis=2)

    surv = (fodf_full > nbr_max) & (fodf_full >= thr_abs[:, None])
    masked = jnp.where(surv, fodf_full, 0.0)
    vals, idx = jax.lax.top_k(masked, npeak)
    pvalid = vals > 0

    amp_sum = (vals * pvalid).sum(axis=1)
    fnorm = (1.0 - f_iso) / jnp.maximum(amp_sum, 1e-30)

    vecs = half_verts[idx] * (vals * fnorm[:, None])[..., None]
    vecs = jnp.where(pvalid[..., None], vecs, 0.0)
    return vecs


def rumba_peaks(fodf, f_iso, odf_dirs: ODF = None, thr: float = FTHRESH):
    """fODF peak finding with angular-neighborhood NMS and the f_iso-
    scaled amplitude threshold; batched over leading axes.

    Returns (sorted vertex indices descending by surviving amplitude,
    number of valid peaks) — the API of the reference's `rumba_peaks!`
    (reference: src/rusd.jl:348-373), vectorized.
    """
    if odf_dirs is None:
        from ..core import odf as _odf
        odf_dirs = _odf.sphere_724

    nbr, nbr_ok = _angular_neighbors(odf_dirs)
    fodf = jnp.asarray(fodf)
    f_iso = jnp.asarray(f_iso)

    thr_xyz = thr / jnp.maximum(1.0 - f_iso, 1e-7)
    thr_abs = thr_xyz * fodf.max(axis=-1)

    gathered = fodf[..., nbr]
    neg = jnp.asarray(-jnp.inf, fodf.dtype)
    gathered = jnp.where(jnp.asarray(nbr_ok), gathered, neg)
    nbr_max = gathered.max(axis=-1)

    surv = (fodf > nbr_max) & (fodf >= thr_abs[..., None])
    masked = jnp.where(surv, fodf, 0.0)
    isort = jnp.argsort(-masked, axis=-1)
    nvalid = (masked > 0).sum(axis=-1)
    return np.asarray(isort), np.asarray(nvalid)


def _tv_bbox(idx, shape3):
    """Crop the TV grid to the mask bounding box + 1-voxel halo (clamped
    to the volume).  Exact: every gradient/divergence cell a mask voxel
    reads lives within the halo, and cells at the halo edge reproduce the
    full-volume values (their neighbors there are all out-of-mask zeros,
    matching the clamped-edge stencil).  Returns (tv_shape3, tv_nxyz,
    idx_tv, lo) with idx_tv the mask voxels' flat indices within the
    crop and lo the crop origin in full-volume coordinates."""
    xyz = np.unravel_index(idx, shape3)
    lo = [max(int(c.min()) - 1, 0) if len(c) else 0 for c in xyz]
    hi = [min(int(c.max()) + 2, s) if len(c) else s
          for c, s in zip(xyz, shape3)]
    tv_shape3 = tuple(h - l for l, h in zip(lo, hi))
    tv_nxyz = int(np.prod(tv_shape3))
    idx_tv = (((xyz[0] - lo[0]) * tv_shape3[1] + (xyz[1] - lo[1]))
              * tv_shape3[2] + (xyz[2] - lo[2])).astype(np.int64)
    return tv_shape3, tv_nxyz, idx_tv, tuple(lo)


@jax.jit
def _signal_from_batch(signals, ib0_idx, idwi_idx):
    """b0-normalized RUMBA signal matrix from a prepared [N, nvol] voxel
    batch, on device (reference: src/rusd.jl:450-465).  Zero padding rows
    yield all-zero signal rows (their fODF collapses to 0 after one
    iteration)."""
    b0 = jnp.maximum(jnp.take(signals, ib0_idx, axis=1), 0).mean(axis=1)
    dwis = jnp.maximum(jnp.take(signals, idwi_idx, axis=1), 0)
    dwis = jnp.where(b0[:, None] > 0,
                     dwis / jnp.maximum(b0[:, None], 1e-30), 0.0)
    sig = jnp.concatenate([(b0 > 0).astype(jnp.float32)[:, None], dwis],
                          axis=1)
    return jnp.minimum(sig, 1.0)


def rumba_rec(dwi: MRI, mask: MRI, odf_dirs: ODF = None,
              niter: int = 600, lam_para: float = 1.7e-3,
              lam_perp: float = 0.2e-3, lam_csf: float = 3.0e-3,
              lam_gm: float = 0.8e-4, ncoils: int = 1,
              coil_combine: str = "SMF-SENSE", ipat_factor: int = 1,
              use_tv: bool = True, verbose: bool = False,
              checkpoint_path: str = None,
              checkpoint_every: int = 0,
              on_mismatch: str = "raise",
              precision: str = DEFAULT_PRECISION, batch=None, mesh=None,
              tv_bf16: bool = False, signal_wire: str = "u12",
              abort_s_per_iter: float = None) -> RUMBASD:
    """RUMBA-SD reconstruction of DWIs.  (reference: src/rusd.jl:419-636)

    With `checkpoint_path` set, the iteration state (fodf, sigma^2, lambda)
    is saved every `checkpoint_every` iterations and the fit resumes from
    the newest checkpoint when restarted — the long-iterative-fit analogue
    of the reference's field-per-file resume convention (the reference has
    no in-loop checkpointing; its 600-iteration fits restart from scratch).
    A checkpoint whose problem identity (voxel count, component count,
    iteration vs niter) does not match this fit raises `ValueError` by
    default — silently discarding an hour-scale fit's progress is worse
    than making the caller look.  Pass `on_mismatch="fresh"` for
    unattended runs that should warn and start from scratch instead.
    (This raise is a deliberate behavior change from pre-round-4
    releases, which warned and restarted.)

    `precision`: matmul precision of the R-L GEMMs.  On the H100 "high"
    (default) and "default" both run as TF32 (~1e-4 relative error per
    product; 25 iterations stay inside the oracle tolerance), "highest"
    as true float32.

    `batch`: optional prepared `VoxelBatch` (core.batch.prepare_batch) to
    reuse one gather/upload across fits; the b0 normalization then runs
    on device.  `mesh`: a jax.sharding.Mesh to run data-parallel — the
    voxel batch shards over the mesh's "data" axis and the TV term
    reshards over components so its stencils stay device-local (inferred
    automatically from a mesh-sharded `batch`).  `tv_bf16` evaluates the
    TV stencil volumes in bfloat16 (~half the HBM traffic of the
    dominant term; the R-L estimate itself stays float32).

    `signal_wire`: host->device encoding of the normalized signal when
    rumba_rec builds it itself (no `batch`) on accelerator backends —
    "u12" (default: packed 12-bit, error 1.3e-4 on the [0,1] signal,
    ~100x below the Rician noise the fit estimates), "u16" (7.7e-6), or
    "f32" (exact).  Ignored with `batch` (the batch's own wire applies)
    and on CPU.

    `abort_s_per_iter`: when set, the wall-clock pace of every ~100
    iterations is measured (one scalar sync per segment) and a
    `PaceAbortError` is raised when any SEGMENT exceeds this many
    seconds per iteration — for benchmark runners on runtimes whose
    execution speed can collapse mid-run, so a doomed timed run dies
    within ~100 iterations of the collapse rather than running to the
    end.  Leave None (default) for production fits.
    """
    if signal_wire not in ("u12", "u16", "f32"):
        raise ValueError(f"signal_wire must be u12/u16/f32, "
                         f"got {signal_wire!r}")
    if dwi.bval is None or len(dwi.bval) == 0:
        raise ValueError("Missing b-value table from input DWI structure")
    if dwi.bvec is None or np.asarray(dwi.bvec).size == 0:
        raise ValueError("Missing gradient table from input DWI structure")

    n_order = 1
    if coil_combine == "SoS-GRAPPA":
        n_order = ncoils
    elif coil_combine != "SMF-SENSE":
        raise ValueError(f"Unknown coil combine mode {coil_combine}")
    if ipat_factor < 1:
        raise ValueError("iPAT factor must be a positive integer")

    if odf_dirs is None:
        from ..core import odf as _odf
        odf_dirs = _odf.sphere_724

    shape3 = tuple(int(s) for s in mask.vol.shape[:3])
    idx = batch.idx if batch is not None else mask_indices(mask.vol)
    nmask = len(idx)

    bval = np.asarray(dwi.bval, np.float32)
    bvec = np.asarray(dwi.bvec, np.float32)
    kernel, ib0 = _build_kernel(bval, bvec, odf_dirs, lam_para, lam_perp,
                                lam_csf, lam_gm)
    ndir, ncomp = kernel.shape
    nvert = ncomp - 2

    # TV runs on the mask bounding box + halo, not the full volume: at
    # HCP scale ~45% of the volume is air the reference's full-grid
    # stencils (src/rusd.jl:282-296) recompute every iteration.
    tv_shape3, tv_nxyz, idx_tv, tv_lo = _tv_bbox(idx, shape3)

    # Infer the mesh from a sharded prepared batch
    if mesh is None and batch is not None:
        mesh = batch.mesh

    from ..ops.transfer import to_device_rows
    from ..utils.profiling import prof

    # Signal matrix: average b0 first, then DWIs, normalized by b0
    # (reference: src/rusd.jl:450-465)
    with prof("rumba.signal"):
        if batch is not None:
            signal_j = _signal_from_batch(
                batch.signals,
                jnp.asarray(np.flatnonzero(ib0)),
                jnp.asarray(np.flatnonzero(~ib0)))
            n_rows = batch.n_pad
        else:
            vol = np.asarray(dwi.vol)
            flat = vol.reshape(-1, vol.shape[3])
            # The normalized signal is clipped to [0, 1]: on accelerator
            # backends it rides the wire 12-bit-packed by default (scale
            # 1/4095, abs error <= 1.3e-4 — ~100x below the Rician noise
            # the fit estimates at clinical SNR) at 37.5% of float32's
            # bytes; signal_wire="u16" (error <= 7.7e-6) or "f32" for
            # tighter wires.  The per-slab producer overlaps the host
            # gather/normalize/quantize with the upload.
            quantize = (signal_wire if jax.default_backend() != "cpu"
                        and signal_wire != "f32" else None)

            from ..native import (as_f32_ptr, as_i32_ptr, as_i64_ptr,
                                  as_u16_ptr, as_u8_ptr, lib)
            nlib = lib()
            native_ok = (quantize is not None and nlib is not None
                         and flat.dtype == np.float32
                         and flat.flags["C_CONTIGUOUS"])
            ib0_i = np.ascontiguousarray(np.flatnonzero(ib0), np.int32)
            idwi_i = np.ascontiguousarray(np.flatnonzero(~ib0), np.int32)

            from ..core.batch import u12_row_bytes
            from ..utils.hostbuf import pool_upload_slabs, scratch
            # only the native fused producer fills slabs in place; the
            # numpy fallback would pay the faults anyway plus a copy
            pool_ok = pool_upload_slabs() and native_ok
            ncol = 1 + int((~ib0).sum())
            rowb = u12_row_bytes(ncol)

            def produce(lo, hi):
                take = idx[lo:min(hi, nmask)]
                if native_ok:
                    # one fused pass: gather + b0 normalize + quantize
                    # (the numpy expression below is ~6 full-size passes
                    # of host memory ahead of every upload slab); pooled
                    # slab: fresh allocations fault at ~0.1 GB/s on the
                    # bench host (utils.hostbuf)
                    take = np.ascontiguousarray(take, np.int64)
                    if quantize == "u12":
                        sig = (scratch(f"upload.rumba.{lo}",
                                       len(take) * rowb, np.uint8)
                               .reshape(len(take), rowb) if pool_ok else
                               np.empty((len(take), rowb), np.uint8))
                        nlib.rumba_signal_u12(
                            as_f32_ptr(flat), as_i64_ptr(take),
                            len(take), flat.shape[1], as_i32_ptr(ib0_i),
                            len(ib0_i), as_i32_ptr(idwi_i), len(idwi_i),
                            as_u8_ptr(sig))
                        return sig
                    sig = (scratch(f"upload.rumba.{lo}",
                                   len(take) * ncol, np.uint16)
                           .reshape(len(take), ncol) if pool_ok else
                           np.empty((len(take), ncol), np.uint16))
                    nlib.rumba_signal_u16(
                        as_f32_ptr(flat), as_i64_ptr(take), len(take),
                        flat.shape[1], as_i32_ptr(ib0_i), len(ib0_i),
                        as_i32_ptr(idwi_i), len(idwi_i), as_u16_ptr(sig))
                    return sig
                rows = flat[take]
                b0_mean = np.maximum(rows[:, ib0], 0).mean(axis=1)
                dwis = np.maximum(rows[:, ~ib0], 0).astype(np.float32)
                with np.errstate(invalid="ignore", divide="ignore"):
                    dwis /= b0_mean[:, None].astype(np.float32)
                dwis[~np.isfinite(dwis)] = 0
                np.clip(dwis, 0.0, 1.0, out=dwis)
                sig = np.concatenate(
                    [(b0_mean > 0).astype(np.float32)[:, None], dwis],
                    axis=1)
                if quantize == "u12":
                    from ..core.batch import _quantize_pack_u12
                    sig = _quantize_pack_u12(sig, 1.0 / 4095.0)
                elif quantize == "u16":
                    sig = (sig * np.float32(65535.0)
                           + np.float32(0.5)).astype(np.uint16)
                return sig

            dev = to_device_rows(
                produce, nmask,
                {"u16": ncol * 2, "u12": rowb}.get(quantize, ncol * 4))
            if quantize == "u12":
                from ..core.batch import _dequant12
                signal_j = _dequant12(dev, 1.0 / 4095.0, ncol)
            elif quantize == "u16":
                from ..core.batch import _dequant
                signal_j = _dequant(dev, 1.0 / 65535.0)
            else:
                signal_j = dev
            n_rows = nmask

    nbr, nbr_ok = _angular_neighbors(odf_dirs)
    half_verts = odf_dirs.vertices[:nvert].astype(np.float32)

    # Ahead-of-time compile of the post/peaks kernels on a daemon
    # thread: they only run once after the iteration drain, so a cold
    # compile cache would otherwise serialize their compiles into the
    # post stage instead of hiding them under the iteration compute.
    if jax.default_backend() != "cpu" and mesh is None:
        import threading

        def _warm_post(nr=n_rows, nc=ncomp, nv=nvert):
            try:
                sds = jax.ShapeDtypeStruct
                _rumba_post.lower(
                    sds((nr, nc), jnp.float32), nv).compile()
                _rumba_peaks_kernel.lower(
                    sds((nr, nv), jnp.float32), sds((nr,), jnp.float32),
                    sds(half_verts.shape, jnp.float32),
                    sds(nbr.shape, nbr.dtype),
                    sds(nbr_ok.shape, nbr_ok.dtype), FTHRESH).compile()
            except Exception as e:      # pragma: no cover - best effort
                import sys
                sys.stderr.write(f"fibers_tpu.rumba: post warm-up "
                                 f"failed: {e!r}\n")

        threading.Thread(target=_warm_post, daemon=True,
                         name="fibers-warmup-rpost").start()

    # Initialization (reference: src/rusd.jl:522-537)
    fodf0 = np.full(ncomp, 1.0 / ncomp, np.float32)
    sigma0 = 1.0 / 15
    lam0 = sigma0 ** 2

    def place(x):
        if mesh is None:
            return x
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.device_put(
            x, NamedSharding(mesh, P("data", *([None] * (x.ndim - 1)))))

    fodf = place(jnp.broadcast_to(jnp.asarray(fodf0),
                                  (n_rows, ncomp)).copy())
    dodf = place(jnp.broadcast_to(jnp.asarray(kernel @ fodf0),
                                  (n_rows, ndir)).copy())
    sig2 = place(jnp.full((n_rows, 1), lam0, jnp.float32))
    dodf_sig = (signal_j * dodf) / sig2
    lam_flat = jnp.full((tv_nxyz,), lam0, jnp.float32)
    kernel_j = jnp.asarray(kernel)
    idx_j = jnp.asarray(idx_tv)

    # Resume from checkpoint if present
    if on_mismatch not in ("raise", "fresh"):
        raise ValueError(f"on_mismatch must be 'raise' or 'fresh', "
                         f"got {on_mismatch!r}")
    it_start = 0
    if checkpoint_path is not None and os.path.isfile(checkpoint_path):
        try:
            with np.load(checkpoint_path) as ck:
                # match on the problem identity (voxels, components);
                # `niter` may differ — resuming into a longer run is the
                # point.  A true identity mismatch raises (default;
                # on_mismatch="fresh" warns and restarts): silently
                # discarding an hour-scale fit's progress is worse than
                # making the caller delete a stale file.
                if (int(ck["nmask"]) != nmask or int(ck["ncomp"]) != ncomp
                        or int(ck["iteration"]) > niter):
                    raise ValueError(
                        f"checkpoint {checkpoint_path} does not match "
                        f"this problem (checkpoint "
                        f"nmask={int(ck['nmask'])} "
                        f"ncomp={int(ck['ncomp'])} "
                        f"iteration={int(ck['iteration'])}; expected "
                        f"nmask={nmask} ncomp={ncomp} niter>="
                        f"{int(ck['iteration'])}).  Delete the file to "
                        "start fresh.")
                # Layout differences are remapped, not discarded: fodf
                # row padding depends on batch/mesh (real rows are the
                # first nmask), and pre-v2 checkpoints stored lam_flat on
                # the full volume instead of the TV crop.
                fodf_ck = np.asarray(ck["fodf"])
                if fodf_ck.ndim != 2 or fodf_ck.shape[1] < ncomp:
                    raise ValueError(
                        f"checkpoint {checkpoint_path} fodf shape "
                        f"{fodf_ck.shape} has fewer than ncomp={ncomp} "
                        "columns")
                fodf_h = fodf_ck[:nmask, :ncomp]
                sig2_h = np.asarray(ck["sig2"], np.float32)
                if sig2_h.ndim == 1:
                    sig2_h = sig2_h[:, None]
                if sig2_h.ndim != 2 or sig2_h.shape[1] != 1:
                    raise ValueError(
                        f"checkpoint {checkpoint_path} sig2 shape "
                        f"{sig2_h.shape} is not a column")
                sig2_h = sig2_h[:nmask]
                if fodf_h.shape[0] < nmask:
                    raise ValueError(
                        f"checkpoint {checkpoint_path} has fewer rows "
                        f"({fodf_h.shape[0]}) than masked voxels "
                        f"({nmask})")
                pad = n_rows - nmask
                if pad:
                    fodf_h = np.pad(fodf_h, ((0, pad), (0, 0)))
                if pad:
                    sig2_h = np.concatenate(
                        [sig2_h, np.full((pad, 1), lam0, np.float32)])
                lam_h = np.asarray(ck["lam_flat"]).reshape(-1)
                if lam_h.size != tv_nxyz:
                    if lam_h.size == int(np.prod(shape3)):
                        # legacy full-volume grid: slice the crop bbox
                        sl = tuple(slice(l, l + s)
                                   for l, s in zip(tv_lo, tv_shape3))
                        lam_h = lam_h.reshape(shape3)[sl].reshape(-1)
                    elif np.ptp(lam_h) == 0:
                        # spatially constant (the ipat_factor==1 update)
                        lam_h = np.full(tv_nxyz, lam_h.flat[0],
                                        np.float32)
                    else:
                        raise ValueError(
                            f"checkpoint {checkpoint_path} lam_flat "
                            f"size {lam_h.size} matches neither the TV "
                            f"crop ({tv_nxyz}) nor the full volume "
                            f"({int(np.prod(shape3))})")
                # Build every resume value in locals and rebind the
                # loop state only after ALL of them validate: a partial
                # rebind surviving into on_mismatch="fresh" would run
                # the fit from a corrupt hybrid of checkpoint and
                # initial state.
                fodf_r = place(jnp.asarray(fodf_h))
                sig2_r = place(jnp.asarray(sig2_h))
                lam_r = jnp.asarray(lam_h.astype(np.float32))
                dodf_r = jnp.dot(fodf_r, kernel_j.T,
                                 precision=jax.lax.Precision.HIGHEST)
                dodf_sig_r = (signal_j * dodf_r) / sig2_r
                fodf, sig2, lam_flat = fodf_r, sig2_r, lam_r
                dodf, dodf_sig = dodf_r, dodf_sig_r
                it_start = int(ck["iteration"])
                print(f"Resuming RUMBA-SD from iteration {it_start} "
                      f"({checkpoint_path})")
        except Exception:
            # not just ValueError: a truncated/corrupt npz raises
            # BadZipFile/OSError, a missing key raises KeyError — all of
            # them mean "this checkpoint is unusable", which is exactly
            # what on_mismatch='fresh' exists to survive unattended
            if on_mismatch == "raise":
                raise
            import warnings
            warnings.warn(
                f"checkpoint {checkpoint_path} does not match this "
                "problem or is unreadable; starting fresh "
                "(on_mismatch='fresh')",
                stacklevel=2)
            it_start = 0

    # Iterate in fori_loop blocks of up to _BLOCK_ITERS per dispatch
    # (verbose mode steps singly to print per-iteration SNR like the
    # reference, reference: src/rusd.jl:543-556).  Checkpoints land on
    # block boundaries.
    snr = 1.0 / jnp.sqrt(sig2)
    it = it_start
    import time as _time
    # Pace gates: force completion with one scalar fetch every ~4 blocks
    # and measure the SEGMENT pace since the previous gate (a cumulative
    # average would dilute a mid-run slowdown behind a fast opening).
    # The timer starts AFTER the first block completes so one-time jit
    # compiles don't read as iteration pace.
    pace_t0 = None
    pace_it0 = None
    pace_gates = []
    if abort_s_per_iter is not None:
        pace_gates = sorted(
            {*range(it_start + 3 * _BLOCK_ITERS, niter + 1,
                    4 * _BLOCK_ITERS), niter})
        pace_gates = [g for g in pace_gates
                      if it_start + _BLOCK_ITERS < g <= niter]
    with prof("rumba.iterate"):
        while it < niter:
            k = niter - it
            if verbose:
                k = 1
            if checkpoint_path is not None and checkpoint_every > 0:
                k = min(k, checkpoint_every - it % checkpoint_every)
            k = min(k, _BLOCK_ITERS)
            fodf, dodf, dodf_sig, sig2, lam_flat, snr = _rumba_block(
                fodf, dodf, dodf_sig, sig2, lam_flat, signal_j, kernel_j,
                idx_j, k, n_order, ipat_factor, use_tv, tv_shape3,
                tv_nxyz, precision, mesh, tv_bf16)
            it += k
            if pace_gates and pace_t0 is None:
                np.asarray(sig2[(0,) * sig2.ndim])   # block 1 + compiles
                pace_t0, pace_it0 = _time.monotonic(), it
            elif pace_gates and it >= pace_gates[0]:
                pace_gates = [g for g in pace_gates if g > it]
                np.asarray(sig2[(0,) * sig2.ndim])
                now = _time.monotonic()
                pace = (now - pace_t0) / (it - pace_it0)
                seg0, pace_t0, pace_it0 = pace_it0, now, it
                if pace > abort_s_per_iter:
                    raise PaceAbortError(
                        f"RUMBA-SD pace {pace:.3f} s/iter over "
                        f"iterations {seg0}..{it} exceeds the abort "
                        f"budget {abort_s_per_iter:.3f} s/iter")
            if verbose:
                sm = float(snr[:nmask].mean())
                ss = float(snr[:nmask].std(ddof=1)) if nmask > 1 else 0.0
                print(f"Iteration {it} of {niter}")
                print(f"Estimated mean SNR (s0/sigma) = {sm} (+-) {ss}")
            if (checkpoint_path is not None and checkpoint_every > 0
                    and it % checkpoint_every == 0 and it < niter):
                tmp = checkpoint_path + ".tmp.npz"
                from ..ops.transfer import to_host
                np.savez(tmp, fodf=to_host(fodf), sig2=to_host(sig2),
                         lam_flat=np.asarray(lam_flat), iteration=it,
                         nmask=nmask, ncomp=ncomp, niter=niter,
                         version=2, n_rows=n_rows,
                         tv_lo=np.asarray(tv_lo),
                         tv_shape3=np.asarray(tv_shape3))
                os.replace(tmp, checkpoint_path)

    # SNR summary as two on-device scalars instead of a fetch of the
    # [N, 1] snr array
    with prof("rumba.drain"):
        sm_d, ss_d = _snr_stats(sig2, nmask)
        snr_mean = float(sm_d)
        snr_std = float(ss_d) if nmask > 1 else 0.0

    from ..core.lazy import LazyVolume

    with prof("rumba.post"):
        # Energy normalization + iso embedding + GFA, all on device
        # (reference: src/rusd.jl:560-596)
        fodf_full, fgm_d, fcsf_d, f_iso_d, gfa_d = _rumba_post(fodf, nvert)

        vecs_d = _rumba_peaks_kernel(
            fodf_full, f_iso_d, jnp.asarray(half_verts), jnp.asarray(nbr),
            jnp.asarray(nbr_ok), FTHRESH)

        # The four scalar maps stay device-resident as one stacked array
        # (one fetch instead of four) and materialize lazily on first
        # host access — a pipeline consuming only peaks (fit->tract
        # chain) never pays the transfer.
        maps_d = jnp.stack([fgm_d, fcsf_d, gfa_d, sig2[:, 0]], axis=0)

    from ..core.lazy import lazy_stack_volumes

    def vol_of(lazy_map):
        m = MRI.like(mask, 1, np.float32)
        m.vol = lazy_map
        return m

    # Peak volumes stay device-resident (fetched lazily on host access,
    # ~43 MB at HCP scale); the device handoff feeds tractography
    # without any fetch at all.
    from ..core.handoff import DevicePeaks, split_unit_amp

    peak = []
    for ip in range(NPEAK):
        m = MRI.like(mask, 3, np.float32)
        m.vol = LazyVolume(vecs_d[:, ip, :], idx, shape3, 3)
        peak.append(m)
    unit_d, amp_d = split_unit_amp(vecs_d)
    peak_dev = DevicePeaks(vecs=unit_d, amp=amp_d, idx=idx, ref=mask)

    # The [N, nvert] fODF sheaf is the one large output: keep it device-
    # resident, materializing to a host volume only on access.
    fodf_mri = MRI.like(mask, nvert, np.float32)
    fodf_mri.vol = LazyVolume(fodf_full, idx, shape3, nvert)

    fgm_l, fcsf_l, gfa_l, var_l = lazy_stack_volumes(maps_d, idx, shape3)
    return RUMBASD(
        fodf=fodf_mri,
        fgm=vol_of(fgm_l),
        fcsf=vol_of(fcsf_l),
        peak=peak,
        gfa=vol_of(gfa_l),
        var=vol_of(var_l),
        snr_mean=snr_mean,
        snr_std=snr_std,
        _peak_dev=peak_dev,
    )


def rumba_write(rumba: RUMBASD, basename: str) -> None:
    """Write RUMBA-SD volumes as <basename>_<field>[i].nii.gz (scalars as
    .txt).  (reference: src/rusd.jl:645-663)"""
    mri_write_struct(rumba, basename)
