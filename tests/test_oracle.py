"""Golden-parity tests: batched device kernels vs independent per-voxel NumPy
transliterations of the reference algorithms (tests/oracle.py).

These are the oracle tests SURVEY.md §4 calls for: if either the batched
kernel or the transliteration drifts from the reference math, they fail.
"""

import numpy as np
import pytest

import fibers_tpu as ft
from fibers_tpu.core.odf import half_sphere

import oracle


def _synth_dwi(rng, shape=(5, 6, 4), ndir=24, nb0=2, noise=0.05):
    """Random multi-tensor DWI with a few nonpositive samples to exercise
    the ragged paths."""
    nvol = ndir + nb0
    bvec = rng.standard_normal((nvol, 3)).astype(np.float32)
    bvec[:nb0] = 0
    norms = np.linalg.norm(bvec[nb0:], axis=1, keepdims=True)
    bvec[nb0:] /= norms
    bval = np.concatenate([np.zeros(nb0), np.full(ndir, 1000.0)]).astype(
        np.float32)

    ax = rng.standard_normal((*shape, 3))
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    dots = np.einsum("xyzi,vi->xyzv", ax, bvec.astype(np.float64))
    quad = 0.3e-3 + (1.5e-3 - 0.3e-3) * dots ** 2
    vol = (90.0 * np.exp(-bval * quad)).astype(np.float32)
    vol += (noise * 90.0) * rng.standard_normal(vol.shape).astype(
        np.float32)
    # sprinkle nonpositive values (ragged path), but keep b0s positive
    drop = rng.random(vol.shape) < 0.02
    drop[..., :nb0] = False
    vol[drop] = -1.0

    dwi = ft.MRI(vol=vol)
    dwi.vox2ras0 = np.eye(4, dtype=np.float32)
    dwi.volsize = np.asarray(shape)
    dwi.width, dwi.height, dwi.depth = shape
    dwi.nframes = nvol
    dwi.set_geometry()
    dwi.bval, dwi.bvec = bval, bvec

    mask = ft.MRI.like(dwi, 1, np.float32)
    m = np.ones(shape, np.float32)
    m[0, 0, 0] = 0
    mask.vol = m
    return dwi, mask


def test_dti_matches_pinv_oracle(rng):
    dwi, mask = _synth_dwi(rng)
    dti = ft.dti_fit(dwi, mask)

    nx, ny, nz = mask.vol.shape
    checked_ragged = 0
    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                if mask.vol[ix, iy, iz] == 0:
                    continue
                s = dwi.vol[ix, iy, iz, :].astype(np.float64)
                ref = oracle.dti_fit_voxel_oracle(s, dwi.bval, dwi.bvec)
                if (s <= 0).any() and ref["fa"] != 0:
                    checked_ragged += 1
                got_l = np.array([dti.eigval1.vol[ix, iy, iz],
                                  dti.eigval2.vol[ix, iy, iz],
                                  dti.eigval3.vol[ix, iy, iz]])
                ref_l = np.array([ref["eigval1"], ref["eigval2"],
                                  ref["eigval3"]])
                np.testing.assert_allclose(got_l, ref_l, rtol=5e-3,
                                           atol=2e-6)
                np.testing.assert_allclose(
                    dti.fa.vol[ix, iy, iz], ref["fa"], rtol=5e-3,
                    atol=5e-4)
                np.testing.assert_allclose(
                    dti.md.vol[ix, iy, iz], ref["md"], rtol=5e-3,
                    atol=2e-6)
                # principal eigenvector up to sign
                v = dti.eigvec1.vol[ix, iy, iz]
                assert abs(float(v @ ref["eigvec1"])) > 0.99
    assert checked_ragged > 0, "no ragged voxels exercised"


def test_u16_wire_matches_oracle_model(rng):
    """prepare_batch's uint16 wire delivers the rows of the oracle's own
    wire model: every sample within one step, nearly all exact (the
    program scales in float32, so a rare half-step tie may round the
    other way), and the sub-step samples arrive as 0 on both sides."""
    dwi, mask = _synth_dwi(rng)
    dwi.vol = np.maximum(dwi.vol, 0.0)
    dwi.vol[1, 1, 1, 5] = 1e-4                  # below half a step
    batch = ft.prepare_batch(dwi, mask, wire="u16")
    got = np.asarray(batch.signals)[:batch.n].astype(np.float64)

    flat = dwi.vol.reshape(-1, dwi.vol.shape[-1])
    raw = flat[batch.idx]
    want = oracle.u16_wire_oracle(raw, raw.max())
    step = raw.max() / 65535.0
    fp = 4 * np.finfo(np.float32).eps * raw.max()   # float32 decode
    err = np.abs(got - want)
    assert err.max() <= step + fp
    assert (err <= fp).mean() > 0.99
    lost = (raw > 0) & (want == 0)
    assert lost.any() and (got[lost] == 0).all()


def test_adc_matches_oracle(rng):
    dwi, mask = _synth_dwi(rng, shape=(4, 4, 3))
    adc, s0 = ft.adc_fit(dwi, mask)
    for ix in range(4):
        for iy in range(4):
            for iz in range(3):
                if mask.vol[ix, iy, iz] == 0:
                    continue
                s = dwi.vol[ix, iy, iz, :].astype(np.float64)
                a_ref, s0_ref = oracle.adc_fit_voxel_oracle(s, dwi.bval)
                np.testing.assert_allclose(adc.vol[ix, iy, iz], a_ref,
                                           rtol=5e-3, atol=1e-7)
                np.testing.assert_allclose(s0.vol[ix, iy, iz], s0_ref,
                                           rtol=5e-3, atol=1e-4)


def test_gqi_matches_oracle(rng):
    dwi, mask = _synth_dwi(rng, shape=(4, 5, 3))
    sph = ft.sphere_362
    gqi = ft.gqi_rec(dwi, mask, sph)

    odf_ref, peak_ref, qa_ref = oracle.gqi_oracle(
        dwi.vol, mask.vol, dwi.bval, dwi.bvec,
        np.asarray(sph.vertices), np.asarray(sph.faces))

    np.testing.assert_allclose(gqi.odf.vol, odf_ref, rtol=1e-4, atol=1e-5)
    for ip in range(3):
        # peak orientation up to tie-order: compare via qa + |dot|
        np.testing.assert_allclose(
            np.squeeze(gqi.qa[ip].vol), qa_ref[ip], rtol=1e-3, atol=1e-5)
        got = gqi.peak[ip].vol
        ref = peak_ref[ip]
        ng = np.linalg.norm(got, axis=-1)
        nr = np.linalg.norm(ref, axis=-1)
        nz = (ng > 0) & (nr > 0)
        # nonzero patterns must agree (up to rare NMS ties)
        assert ((ng > 0) == (nr > 0)).mean() > 0.98
        if nz.sum() == 0:
            continue
        dots = (np.abs(np.einsum("...i,...i->...", got, ref))
                / (ng * nr + 1e-30))[nz]
        assert (dots > 0.999).mean() > 0.99


def test_dsi_matches_oracle(rng):
    # Cartesian q-grid (radius 2), like a miniature DSI acquisition
    r = np.arange(-2, 3)
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    q = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float64)
    q = q[(q ** 2).sum(1) <= 4]
    norm = np.sqrt((q ** 2).sum(1))
    bvec = np.where(norm[:, None] > 0,
                    q / np.maximum(norm, 1e-30)[:, None], 0.0)
    bval = (q ** 2).sum(1) * 1000.0

    shape = (3, 3, 2)
    nvol = len(bval)
    vol = np.abs(rng.standard_normal((*shape, nvol))).astype(np.float32) \
        * 50 + 10
    dwi = ft.MRI(vol=vol)
    dwi.vox2ras0 = np.eye(4, dtype=np.float32)
    dwi.volsize = np.asarray(shape)
    dwi.width, dwi.height, dwi.depth = shape
    dwi.nframes = nvol
    dwi.set_geometry()
    dwi.bval = bval.astype(np.float32)
    dwi.bvec = bvec.astype(np.float32)
    mask = ft.MRI.like(dwi, 1, np.float32)
    mask.vol[:] = 1

    sph = ft.sphere_362
    dsi = ft.dsi_rec(dwi, mask, sph, hann_width=8)
    pdf_vol = np.asarray(dsi.pdf.vol)
    odf_vol = np.asarray(dsi.odf.vol)

    import oracle as orc
    for ix in range(shape[0]):
        for iy in range(shape[1]):
            for iz in range(shape[2]):
                pdf_ref, odf_ref = orc.dsi_voxel_oracle(
                    vol[ix, iy, iz].astype(np.float64), bval, bvec,
                    np.asarray(sph.vertices), hann_width=8)
                np.testing.assert_allclose(pdf_vol[ix, iy, iz], pdf_ref,
                                           rtol=2e-4, atol=2e-6)
                np.testing.assert_allclose(odf_vol[ix, iy, iz], odf_ref,
                                           rtol=2e-4, atol=2e-6)


def test_rumba_step_matches_oracle(rng):
    shape3 = (4, 4, 3)
    nxyz = int(np.prod(shape3))
    idx = np.sort(rng.choice(nxyz, size=30, replace=False))
    n = len(idx)
    ndir, nvert = 20, 40
    ncomp = nvert + 2

    kernel = np.abs(rng.standard_normal((ndir, ncomp))).astype(np.float32)
    signal = rng.uniform(0.05, 1.0, (n, ndir)).astype(np.float32)
    fodf0 = np.full(ncomp, 1.0 / ncomp, np.float32)
    fodf = np.broadcast_to(fodf0, (n, ncomp)).copy()
    dodf = fodf @ kernel.T
    sig2 = np.full((n, 1), (1.0 / 15) ** 2, np.float32)
    dodf_sig = (signal * dodf) / sig2
    lam_vol = np.full(shape3, (1.0 / 15) ** 2)

    # oracle in float64
    o_fodf, o_dodf, o_dsig, o_sig2, o_lam = fodf.astype(np.float64), \
        dodf.astype(np.float64), dodf_sig.astype(np.float64), \
        sig2.astype(np.float64), lam_vol.copy()
    for _ in range(3):
        o_fodf, o_dodf, o_dsig, o_sig2, o_lam = \
            oracle.rumba_iterate_oracle(
                o_fodf, o_dodf, o_dsig, o_sig2, o_lam, signal, kernel,
                idx, shape3)

    # batched kernel, 3 iterations
    import jax.numpy as jnp
    from fibers_tpu.models.rumba import _rumba_step
    st = (jnp.asarray(fodf), jnp.asarray(dodf), jnp.asarray(dodf_sig),
          jnp.asarray(sig2), jnp.asarray(lam_vol.reshape(-1),
                                         dtype=jnp.float32))
    for _ in range(3):
        f, d, ds, s2, lam, _snr = _rumba_step(
            *st, jnp.asarray(signal), jnp.asarray(kernel),
            jnp.asarray(idx), 1, 1, True, shape3, nxyz)
        st = (f, d, ds, s2, lam)

    np.testing.assert_allclose(np.asarray(st[0]), o_fodf, rtol=2e-3,
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(st[3]), o_sig2, rtol=2e-3,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(st[4]).reshape(shape3), o_lam,
                               rtol=2e-3, atol=1e-7)


def test_stream_micro_matches_oracle(rng):
    shape3 = (16, 10, 10)
    mask = np.ones(shape3, bool)
    mask[:, :2, :] = False
    x, y, z = np.meshgrid(*[np.linspace(0, 1, s) for s in shape3],
                          indexing="ij")
    th = 0.5 * x + 0.3 * y
    ov = np.stack([np.cos(th), np.sin(th), 0.15 * np.ones_like(th)],
                  axis=-1)
    ov /= np.linalg.norm(ov, axis=-1, keepdims=True)
    ov *= mask[..., None]
    ovecs = ov[..., None, :].astype(np.float32)

    ovm = ft.MRI(vol=ovecs[..., 0, :])
    ovm.vox2ras0 = np.eye(4, dtype=np.float32)
    ovm.volsize = np.asarray(shape3)
    ovm.width, ovm.height, ovm.depth = shape3
    ovm.nframes = 3
    ovm.set_geometry()
    ovm.volres = np.array([0.01, 0.01, 0.01], np.float32)  # 10 um: micro
    maskm = ft.MRI.like(ovm, 1, np.float32)
    maskm.vol = mask.astype(np.float32)
    maskm.volres = ovm.volres

    sd = 3
    tract = ft.stream(ovm, mask=maskm, nsub=0, search_dist=sd)
    tract.materialize()

    seeds = np.argwhere(mask)
    ref_lines = [oracle.stream_micro_line_oracle(
        sv, ovecs, mask, (sd, sd, sd)) for sv in seeds]
    ref_lines = [l for l in ref_lines if len(l) >= 3]

    assert tract.n_count == len(ref_lines)
    for i, ref in enumerate(ref_lines):
        g = np.asarray(tract.xyz[i]).T
        assert g.shape == ref.shape, f"line {i}: {g.shape} vs {ref.shape}"
        np.testing.assert_allclose(g, ref, atol=1e-4, err_msg=f"line {i}")


def test_structens_matches_oracle(rng):
    vol = rng.standard_normal((10, 9, 8)).astype(np.float32)
    evecs, evals = ft.st_recon(vol, sigma=1.0, rho=1.5)
    evec_ref, eval_ref = oracle.st_recon_oracle(vol, 1.0, 1.5)

    np.testing.assert_allclose(evals, eval_ref, rtol=2e-3, atol=2e-6)
    # eigenvectors up to sign; skip near-degenerate pairs
    gap = np.diff(eval_ref, axis=-1).min(axis=-1)
    sel = gap > 1e-5
    dots = np.abs(np.einsum("...ij,...ij->...j", evecs[sel],
                            evec_ref[sel]))
    assert (dots > 0.99).mean() > 0.98


def test_stream_matches_oracle(rng):
    shape3 = (12, 12, 6)
    mask = np.ones(shape3, bool)
    # smooth orientation field
    x, y, z = np.meshgrid(*[np.linspace(0, 1, s) for s in shape3],
                          indexing="ij")
    th = 0.6 * x + 0.9 * y + 0.3 * z
    ov = np.stack([np.cos(th), np.sin(th), 0.1 * np.ones_like(th)],
                  axis=-1)
    ov /= np.linalg.norm(ov, axis=-1, keepdims=True)
    ovecs = ov[..., None, :].astype(np.float32)   # nvec = 1

    ovm = ft.MRI(vol=ovecs[..., 0, :])
    ovm.vox2ras0 = np.eye(4, dtype=np.float32)
    ovm.volsize = np.asarray(shape3)
    ovm.width, ovm.height, ovm.depth = shape3
    ovm.nframes = 3
    ovm.set_geometry()

    maskm = ft.MRI.like(ovm, 1, np.float32)
    maskm.vol = mask.astype(np.float32)

    tract = ft.stream(ovm, mask=maskm, nsub=0, seed_rng=0)

    # oracle lines over the same seed order (argwhere of the mask)
    seeds = np.argwhere(mask)
    cos45 = np.cos(np.radians(45.0))
    ref_lines = []
    for sv in seeds:
        line = oracle.stream_line_oracle(sv, np.zeros(3), ovecs, mask,
                                         step_size=0.5,
                                         cosang_thresh=cos45,
                                         smooth_coeff=0.2,
                                         len_max=max(shape3))
        if len(line) >= 3:
            ref_lines.append(line)

    assert tract.n_count == len(ref_lines)
    got = tract.xyz
    for i, ref in enumerate(ref_lines):
        g = np.asarray(got[i]).T  # Tract stores [3, npts]
        assert g.shape == ref.shape, f"line {i}: {g.shape} vs {ref.shape}"
        np.testing.assert_allclose(g, ref, rtol=1e-4, atol=1e-4,
                                   err_msg=f"line {i}")
