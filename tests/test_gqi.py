"""GQI reconstruction tests: sphere data, system matrix, peaks, phantoms."""

import numpy as np

import fibers_tpu as ft
from fibers_tpu.core.odf import half_sphere
from fibers_tpu.models.gqi import gqi_design
from fibers_tpu.ops.peaks import build_neighbors, peak_mask

from phantom import make_phantom


class TestSphereData:
    def test_tables(self):
        for name, nv, nf in (("sphere_362", 362, 720),
                             ("sphere_642", 642, 1280),
                             ("sphere_724", 724, 1444)):
            odf = getattr(ft, name)
            assert odf.vertices.shape == (nv, 3)
            assert odf.faces.shape == (nf, 3)
            # unit vertices, antipodal symmetry
            norms = np.linalg.norm(odf.vertices, axis=1)
            assert np.allclose(norms, 1.0, atol=2e-3)
            n = nv // 2
            assert np.allclose(odf.vertices[:n], -odf.vertices[n:])
            # faces are valid 1-based indices
            assert odf.faces.min() >= 1 and odf.faces.max() <= nv

    def test_half_sphere_folding(self):
        odf = ft.sphere_642
        lower, upper, faces0 = half_sphere(odf)
        assert lower.shape == (321, 3)
        assert faces0.min() >= 0 and faces0.max() < 321


class TestPeakMask:
    def test_single_global_max(self):
        odf_dirs = ft.sphere_362
        n = odf_dirs.nvert_half
        _, _, faces0 = half_sphere(odf_dirs)
        nbr, ok = build_neighbors(faces0, n)
        o = np.zeros(n, np.float32)
        o[42] = 1.0
        m = np.asarray(peak_mask(o, nbr, ok))
        assert m[42]
        # neighbors of 42 must not be peaks; distant zeros tie with their
        # zero neighbors and are suppressed too
        assert m.sum() == 1

    def test_ties_suppressed(self):
        odf_dirs = ft.sphere_362
        n = odf_dirs.nvert_half
        _, _, faces0 = half_sphere(odf_dirs)
        nbr, ok = build_neighbors(faces0, n)
        o = np.ones(n, np.float32)  # all tied -> no strict maxima
        m = np.asarray(peak_mask(o, nbr, ok))
        assert m.sum() == 0


class TestGQIRec:
    def test_peak_direction_recovered(self):
        dwi, mask, axes, _ = make_phantom(shape=(6, 6, 6), ndir=60,
                                          bmax=3000.0, two_shell=True)
        gqi = ft.gqi_rec(dwi, mask, ft.sphere_642)

        m = mask.vol > 0
        v1 = gqi.peak[0].vol[m]          # [N, 3]
        ax = axes[m]
        dots = np.abs((v1 * ax).sum(axis=1) / np.linalg.norm(v1, axis=1))
        angs = np.degrees(np.arccos(np.clip(dots, 0, 1)))
        # tessellation quantization: vertices of sphere_642 are up to ~8
        # degrees from an arbitrary direction
        assert angs.max() < 8.5
        assert np.median(angs) < 4.5

        # QA: first peak positive and finite (QA > 1 is possible; the
        # normalizer is the max MEAN odf, not the max amplitude)
        qa1 = gqi.qa[0].vol[m]
        assert qa1.min() > 0
        assert np.isfinite(qa1).all()

        # out-of-mask voxels zero
        assert np.all(gqi.odf.vol[~m] == 0)

    def test_odf_matches_direct_gemm(self):
        dwi, mask, _, _ = make_phantom(shape=(4, 4, 4), ndir=30)
        odf_dirs = ft.sphere_362
        gqi = ft.gqi_rec(dwi, mask, odf_dirs)
        A = gqi_design(dwi.bval, dwi.bvec, odf_dirs)
        ix, iy, iz = 2, 2, 2
        s = np.maximum(dwi.vol[ix, iy, iz], 0)
        expect = A @ s
        got = gqi.odf.vol[ix, iy, iz]
        assert np.allclose(got, expect, rtol=1e-4, atol=1e-4)

    def test_write(self, tmp_path):
        import os
        dwi, mask, _, _ = make_phantom(shape=(4, 4, 4), ndir=12)
        gqi = ft.gqi_rec(dwi, mask, ft.sphere_362)
        base = str(tmp_path / "gqifit")
        ft.gqi_write(gqi, base)
        for f in ("odf", "peak1", "peak2", "peak3", "qa1", "qa3"):
            assert os.path.isfile(f"{base}_{f}.nii.gz"), f

    def test_find_peaks_api(self):
        odf_dirs = ft.sphere_362
        n = odf_dirs.nvert_half
        rng = np.random.default_rng(3)
        o = rng.random((5, n)).astype(np.float32)
        order, nvalid = ft.find_peaks(o, odf_dirs)
        assert order.shape == (5, n)
        assert (nvalid > 0).all()
        # the first sorted index is a strict local max with top value
        _, _, faces0 = half_sphere(odf_dirs)
        nbr, ok = build_neighbors(faces0, n)
        for i in range(5):
            v = order[i, 0]
            nb = nbr[i % 1][ok[i % 1]]  # dummy touch
            nbv = nbr[v][ok[v]]
            assert (o[i, v] > o[i, nbv]).all()
