"""Tractography tests: lockstep integrator semantics on synthetic fields."""

import os

import numpy as np
import pytest

import fibers_tpu as ft


def _vec_field(shape, direction):
    """Uniform unit vector field as an MRI ([x,y,z,3])."""
    v = np.zeros(shape + (3,), np.float32)
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    v[..., 0], v[..., 1], v[..., 2] = d
    m = ft.MRI(vol=v)
    m.vox2ras0 = np.diag([1.0, 1.0, 1.0, 1.0]).astype(np.float32)
    m.volsize = np.asarray(shape)
    m.width, m.height, m.depth = shape
    m.nframes = 3
    m.set_geometry()
    return m


def _mask_mri(ref, arr):
    m = ft.MRI.like(ref, 1, np.float32)
    m.vol = arr.astype(np.float32)
    return m


class TestDeterministic:
    def test_straight_fiber(self):
        shape = (20, 7, 7)
        ov = _vec_field(shape, (1, 0, 0))
        mask = np.zeros(shape, bool)
        mask[:, 3, 3] = True      # a single straight corridor
        seedm = np.zeros(shape, bool)
        seedm[10, 3, 3] = True

        tr = ft.stream(ov, mask=_mask_mri(ov, mask),
                       seed=_mask_mri(ov, seedm), nsub=1, seed_rng=0,
                       len_max=100)
        assert tr.n_count == 1
        tr.materialize()
        pts = tr.xyz[0].T          # [npts, 3]
        # Streamline should span the corridor in x at constant y,z
        assert pts[:, 0].max() - pts[:, 0].min() > 15
        assert np.allclose(pts[:, 1], pts[0, 1], atol=0.6)
        assert np.allclose(pts[:, 2], pts[0, 2], atol=0.6)
        # x strictly monotonic except for the duplicated seed point at the
        # fwd/bwd junction (reference prepend/append order)
        dx = np.diff(pts[:, 0])
        assert (np.abs(dx) <= 0.51).all()
        n_nonmono = ((dx > 0).sum(), (dx < 0).sum())
        assert min(n_nonmono) <= 1

    def test_seed_point_duplicated(self):
        """The seed position is saved once per direction, as in the
        reference (src/stream.jl:648-660)."""
        shape = (20, 7, 7)
        ov = _vec_field(shape, (1, 0, 0))
        mask = np.zeros(shape, bool)
        mask[:, 3, 3] = True
        seedm = np.zeros(shape, bool)
        seedm[10, 3, 3] = True
        tr = ft.stream(ov, mask=_mask_mri(ov, mask),
                       seed=_mask_mri(ov, seedm), nsub=0)
        tr.materialize()
        pts = tr.xyz[0].T
        seed_pos = np.array([10.0, 3.0, 3.0])
        d = np.linalg.norm(pts - seed_pos, axis=1)
        assert (d < 1e-5).sum() == 2

    def test_angle_threshold_stops(self):
        """A sharp 90-degree bend in the field terminates propagation."""
        shape = (20, 20, 5)
        v = np.zeros(shape + (3,), np.float32)
        v[:10, :, :, 0] = 1.0       # x-direction on the left half
        v[10:, :, :, 1] = 1.0       # y-direction on the right half
        ov = ft.MRI(vol=v)
        ov.vox2ras0 = np.eye(4, dtype=np.float32)
        ov.volsize = np.asarray(shape)
        ov.width, ov.height, ov.depth = shape
        ov.nframes = 3
        ov.set_geometry()
        mask = np.zeros(shape, bool)
        mask[:, 10, 2] = True
        mask[12, :, 2] = True       # corridor continues in y after the bend
        seedm = np.zeros(shape, bool)
        seedm[5, 10, 2] = True
        tr = ft.stream(ov, mask=_mask_mri(ov, mask),
                       seed=_mask_mri(ov, seedm), nsub=0, ang_thresh=45)
        tr.materialize()
        pts = tr.xyz[0].T
        # must not turn the 90-degree corner: y stays ~10
        assert np.abs(pts[:, 1] - 10).max() < 1.0

    def test_len_min_filters(self):
        shape = (20, 7, 7)
        ov = _vec_field(shape, (1, 0, 0))
        mask = np.zeros(shape, bool)
        mask[9:12, 3, 3] = True     # 3-voxel corridor -> short lines
        seedm = np.zeros(shape, bool)
        seedm[10, 3, 3] = True
        tr_loose = ft.stream(ov, mask=_mask_mri(ov, mask),
                             seed=_mask_mri(ov, seedm), nsub=0, len_min=3)
        tr_strict = ft.stream(ov, mask=_mask_mri(ov, mask),
                              seed=_mask_mri(ov, seedm), nsub=0, len_min=50)
        assert tr_loose.n_count == 1
        assert tr_strict.n_count == 0

    def test_len_max_bounds_length(self):
        shape = (64, 5, 5)
        ov = _vec_field(shape, (1, 0, 0))
        mask = np.zeros(shape, bool)
        mask[:, 2, 2] = True
        seedm = np.zeros(shape, bool)
        seedm[32, 2, 2] = True
        tr = ft.stream(ov, mask=_mask_mri(ov, mask),
                       seed=_mask_mri(ov, seedm), nsub=0, len_max=10)
        tr.materialize()
        # npts > len_max breaks after saving; the backward pass saves one
        # more before its check, exactly like the reference's shared npts
        # counter: max len_max+2 points total
        assert tr.npts[0] <= 12

    def test_nsub_multiplies_streams(self):
        shape = (20, 7, 7)
        ov = _vec_field(shape, (1, 0, 0))
        mask = np.zeros(shape, bool)
        mask[:, 2:5, 2:5] = True
        seedm = np.zeros(shape, bool)
        seedm[10, 3, 3] = True
        tr = ft.stream(ov, mask=_mask_mri(ov, mask),
                       seed=_mask_mri(ov, seedm), nsub=3)
        assert tr.n_count == 3

    def test_reproducible_with_seed(self):
        shape = (16, 9, 9)
        ov = _vec_field(shape, (1, 0.2, 0))
        mask = np.ones(shape, bool)
        tr1 = ft.stream(ov, mask=_mask_mri(ov, mask), nsub=2, seed_rng=7)
        tr2 = ft.stream(ov, mask=_mask_mri(ov, mask), nsub=2, seed_rng=7)
        assert tr1.n_count == tr2.n_count
        assert np.allclose(tr1.packed_xyz, tr2.packed_xyz)

    def test_trk_output(self, tmp_path):
        shape = (20, 7, 7)
        ov = _vec_field(shape, (1, 0, 0))
        mask = np.zeros(shape, bool)
        mask[:, 2:5, 2:5] = True
        maskm = _mask_mri(ov, mask)
        tr = ft.stream(ov, mask=maskm, nsub=1)
        p = str(tmp_path / "out.trk")
        assert ft.trk_write(tr, p) is False
        t2 = ft.trk_read(p)
        assert t2.n_count == tr.n_count
        assert len(t2) == t2.n_count == len(tr)   # len() = streamlines
        tr.materialize()
        for a, b in zip(t2.xyz[:5], tr.xyz[:5]):
            assert np.allclose(a, b, atol=1e-5)

    def test_two_peak_voxels(self):
        """With two orientation volumes, the integrator picks the less
        bending one per voxel."""
        shape = (20, 20, 5)
        ov1 = _vec_field(shape, (1, 0, 0))
        ov2 = _vec_field(shape, (0, 1, 0))
        mask = np.zeros(shape, bool)
        mask[:, 10, 2] = True
        seedm = np.zeros(shape, bool)
        seedm[10, 10, 2] = True
        tr = ft.stream([ov1, ov2], mask=_mask_mri(ov1, mask),
                       seed=_mask_mri(ov1, seedm), nsub=0, len_max=100)
        tr.materialize()
        pts = tr.xyz[0].T
        # stays on the x corridor (picks ov1 at every step)
        assert pts[:, 0].max() - pts[:, 0].min() > 15
        assert np.abs(pts[:, 1] - 10).max() < 0.6


class TestMicroMode:
    def test_micro_follows_fiber(self):
        shape = (30, 9, 9)
        ov = _vec_field(shape, (1, 0, 0))
        ov.volres = np.array([0.01, 0.01, 0.01], np.float32)  # 10 um
        mask = np.zeros(shape, bool)
        mask[:, 4, 4] = True
        seedm = np.zeros(shape, bool)
        seedm[15, 4, 4] = True
        tr = ft.stream(ov, mask=_mask_mri(ov, mask),
                       seed=_mask_mri(ov, seedm), nsub=0, search_dist=3,
                       len_max=100)
        assert tr.n_count == 1
        tr.materialize()
        pts = tr.xyz[0].T
        assert pts[:, 0].max() - pts[:, 0].min() > 20


class TestLCMMode:
    def test_lcm_propagates_in_plane(self):
        shape = (16, 16, 1)
        # 2D x-oriented field (z component all zero -> through-plane = z)
        v = np.zeros(shape + (3,), np.float32)
        v[..., 0] = 1.0
        ov = ft.MRI(vol=v)
        ov.vox2ras0 = np.eye(4, dtype=np.float32)
        ov.volsize = np.asarray(shape)
        ov.width, ov.height, ov.depth = shape
        ov.nframes = 3
        ov.set_geometry()

        mask = np.zeros(shape, bool)
        mask[:, 8, 0] = True
        seedm = np.zeros(shape, bool)
        seedm[8, 8, 0] = True

        # LCM volume: only the x-through connection (edge pair (0,2) ->
        # vectorized element index 2) is open everywhere
        lcm = np.zeros(shape + (10,), np.float32)
        lcm[..., 2] = 1.0
        lcmm = ft.MRI(vol=lcm)

        tr = ft.stream(ov, mask=_mask_mri(ov, mask),
                       seed=_mask_mri(ov, seedm), lcms=lcmm, nsub=0,
                       step_size=1.0, len_max=100)
        assert tr.n_count == 1
        pts = tr.xyz[0].T
        assert pts[:, 0].max() - pts[:, 0].min() > 10
        assert np.allclose(pts[:, 1], 8, atol=0.5)
        # method-difference scalars recorded per point
        assert tr.n_scalars == 1
        assert tr.scalars[0].shape[1] == pts.shape[0]

    def test_lcm_transition_frequencies(self):
        """Distributional parity: with an LCM opening the straight x
        connection at weight 0.7 and the +y turn at 0.3, the observed
        per-voxel-entry turn frequency matches the weights
        (reference: src/stream.jl:449-452 samples Categorical(lcm))."""
        nx, ny = 48, 200
        shape = (nx, ny, 1)
        # two orientation vector sets: +x and +y, everywhere in-plane
        vx = np.zeros(shape + (3,), np.float32)
        vx[..., 0] = 1.0
        # break the x-only degeneracy so the through-plane dimension is
        # detected as z, not y (the reference's thrudim = the all-zero
        # component of ovecs[1], src/stream.jl:224-226)
        vx[nx - 1, ny - 1, 0, 1] = 1e-3
        vy = np.zeros(shape + (3,), np.float32)
        vy[..., 1] = 1.0

        def mk(v, nfr=3):
            m = ft.MRI(vol=v)
            m.vox2ras0 = np.eye(4, dtype=np.float32)
            m.volsize = np.asarray(shape)
            m.width, m.height, m.depth = shape
            m.nframes = nfr
            m.set_geometry()
            return m

        ovx, ovy = mk(vx), mk(vy)
        mask = np.ones(shape, bool)
        # seeds on the x=0 column: backward (-x) exits the grid instantly,
        # so every counted x-step is a forward draw
        seedm = np.zeros(shape, bool)
        seedm[0, :, 0] = True

        # edge ids (0-based): 0=-x, 1=-y, 2=+x, 3=+y; vectorized LCM pair
        # order [(0,0),(0,1),(0,2),(0,3),(1,1),(1,2),(1,3),(2,2),(2,3),
        # (3,3)].  Entry from -x: straight (0,2)=0.7, turn (0,3)=0.3;
        # entry from -y: straight (1,3)=1.0 (so turned streams keep going
        # +y and never draw in x again).
        lcm = np.zeros(shape + (10,), np.float32)
        lcm[..., 2] = 0.7
        lcm[..., 3] = 0.3
        lcm[..., 6] = 1.0
        lcmm = mk(lcm, nfr=10)

        tr = ft.stream([ovx, ovy], mask=_mask_mri(ovx, mask),
                       seed=_mask_mri(ovx, seedm), lcms=lcmm,
                       nsub=0, step_size=1.0, smooth_coeff=0.0,
                       len_max=300, seed_rng=3)

        tr.materialize()
        turns = 0
        x_entries = 0
        for m in tr.xyz:
            p = np.asarray(m).T
            d = np.diff(p, axis=0)
            d = d[np.abs(d).sum(axis=1) > 1e-6]
            is_x = np.abs(d[:, 0]) > np.abs(d[:, 1])
            x_entries += int(is_x.sum())
            # a turn: the line has both x- and y-direction segments
            if is_x.any() and (~is_x).any():
                turns += 1
        # each x-step is one Bernoulli(0.3) draw that either continues
        # straight or turns (ending the x run)
        assert x_entries > 400
        p_hat = turns / x_entries
        sigma = np.sqrt(0.3 * 0.7 / x_entries)
        assert abs(p_hat - 0.3) < max(4 * sigma, 0.05), \
            f"turn rate {p_hat:.3f} vs 0.3 (n={x_entries})"


class TestTrkSink:
    def test_sink_matches_trk_write(self, tmp_path):
        """stream(trk_sink=...) writes the byte-identical file that
        trk_write produces from the in-memory Tract."""
        shape = (20, 20, 5)
        ov = _vec_field(shape, (1, 0, 0))
        mask = np.zeros(shape, bool)
        mask[:, 8:12, 1:4] = True
        seedm = np.zeros(shape, bool)
        seedm[10, 9:11, 2] = True

        tr_mem = ft.stream(ov, mask=_mask_mri(ov, mask),
                           seed=_mask_mri(ov, seedm), nsub=2, len_max=50)
        p_mem = str(tmp_path / "mem.trk")
        ft.trk_write(tr_mem, p_mem)

        p_sink = str(tmp_path / "sink.trk")
        tr_sink = ft.stream(ov, mask=_mask_mri(ov, mask),
                            seed=_mask_mri(ov, seedm), nsub=2, len_max=50,
                            trk_sink=p_sink)
        assert tr_sink.n_count == tr_mem.n_count
        assert open(p_sink, "rb").read() == open(p_mem, "rb").read()

        back = ft.trk_read(p_sink)
        assert back.n_count == tr_mem.n_count

    def test_sink_empty(self, tmp_path):
        shape = (8, 8, 3)
        ov = _vec_field(shape, (1, 0, 0))
        mask = np.zeros(shape, bool)   # nothing to seed
        p = str(tmp_path / "empty.trk")
        tr = ft.stream(ov, mask=_mask_mri(ov, mask), nsub=1, trk_sink=p)
        assert tr.n_count == 0
        back = ft.trk_read(p)
        assert back.n_count == 0


class TestWireCodec:
    """The int8 error-feedback delta wire is the production codec on
    accelerators; force it on CPU so regressions are visible in CI."""

    def _curved_setup(self):
        shape = (24, 24, 5)
        x, y = np.meshgrid(np.arange(24.0), np.arange(24.0), indexing="ij")
        ang = np.arctan2(y - 11.5, x - 11.5) + np.pi / 2
        v = np.zeros(shape + (3,), np.float32)
        v[..., 0] = np.cos(ang)[..., None]
        v[..., 1] = np.sin(ang)[..., None]
        m = ft.MRI(vol=v)
        m.vox2ras0 = np.eye(4, dtype=np.float32)
        m.volsize = np.asarray(shape)
        m.width, m.height, m.depth = shape
        m.nframes = 3
        m.set_geometry()
        r = np.sqrt((x - 11.5) ** 2 + (y - 11.5) ** 2)
        mask = ((r > 4) & (r < 10))[..., None].repeat(5, axis=2)
        seedm = np.zeros(shape, bool)
        seedm[6:18, 6:18, 2] = mask[6:18, 6:18, 2]
        return m, mask, seedm

    def test_i8_matches_f32(self):
        ov, mask, seedm = self._curved_setup()
        kw = dict(mask=_mask_mri(ov, mask), seed=_mask_mri(ov, seedm),
                  nsub=2, seed_rng=3, len_max=60)
        tr_exact = ft.stream(ov, wire="f32", **kw)
        tr_i8 = ft.stream(ov, wire="i8", **kw)

        assert tr_i8.n_count == tr_exact.n_count > 0
        assert np.array_equal(np.asarray(tr_i8.npts),
                              np.asarray(tr_exact.npts))
        qscale = 127.0 / 0.5
        err = np.abs(tr_i8.packed_xyz - tr_exact.packed_xyz).max()
        assert err <= 2.0 / qscale, f"wire error {err} > 2/qscale"

    def test_i8_sink_consistent(self, tmp_path):
        ov, mask, seedm = self._curved_setup()
        kw = dict(mask=_mask_mri(ov, mask), seed=_mask_mri(ov, seedm),
                  nsub=1, len_max=60)
        tr_mem = ft.stream(ov, wire="i8", **kw)
        p = str(tmp_path / "i8.trk")
        ft.stream(ov, wire="i8", trk_sink=p, **kw)
        back = ft.trk_read(p)
        assert back.n_count == tr_mem.n_count
        assert np.allclose(back.packed_xyz, tr_mem.packed_xyz, atol=1e-4)

    def test_i6_matches_f32(self):
        """The packed 6-bit wire tracks the exact path within its coarser
        error-feedback bound (2/qscale at qscale=31/step), with identical
        line structure."""
        ov, mask, seedm = self._curved_setup()
        kw = dict(mask=_mask_mri(ov, mask), seed=_mask_mri(ov, seedm),
                  nsub=2, seed_rng=3, len_max=60)
        tr_exact = ft.stream(ov, wire="f32", **kw)
        tr_i6 = ft.stream(ov, wire="i6", **kw)

        assert tr_i6.n_count == tr_exact.n_count > 0
        assert np.array_equal(np.asarray(tr_i6.npts),
                              np.asarray(tr_exact.npts))
        qscale = 31.0 / 0.5
        err = np.abs(tr_i6.packed_xyz - tr_exact.packed_xyz).max()
        assert err <= 2.0 / qscale, f"wire error {err} > 2/qscale"

    def test_i6_sink_consistent(self, tmp_path):
        ov, mask, seedm = self._curved_setup()
        kw = dict(mask=_mask_mri(ov, mask), seed=_mask_mri(ov, seedm),
                  nsub=1, len_max=60)
        tr_mem = ft.stream(ov, wire="i6", **kw)
        p = str(tmp_path / "i6.trk")
        ft.stream(ov, wire="i6", trk_sink=p, **kw)
        back = ft.trk_read(p)
        assert back.n_count == tr_mem.n_count
        assert np.allclose(back.packed_xyz, tr_mem.packed_xyz, atol=1e-4)

    def test_i6_sink_zero_point_lines(self, tmp_path):
        """len_min=0 keeps zero-point lines; the fused i6 decoder must
        not read past the wire buffer for a trailing empty line (the
        count word is still written, reference: src/trk.jl:442-482)."""
        ov, mask, seedm = self._curved_setup()
        seedall = np.ones(mask.shape, bool)   # seeds outside the mask
        kw = dict(mask=_mask_mri(ov, mask), seed=_mask_mri(ov, seedall),
                  nsub=1, len_min=0, len_max=60)
        tr = ft.stream(ov, wire="i6", **kw)
        assert (np.asarray(tr.npts) == 0).any()
        p = str(tmp_path / "zero.trk")
        ft.stream(ov, wire="i6", trk_sink=p, **kw)
        back = ft.trk_read(p)
        assert back.n_count == tr.n_count
        assert np.array_equal(np.asarray(back.npts), np.asarray(tr.npts))

    def test_unpack6_roundtrip_exact(self):
        """_compact's 16->3-word packing and _unpack6 (native + numpy
        fallback) are exact inverses over the full 6-bit range."""
        from fibers_tpu.tract.stream import _unpack6

        rng = np.random.default_rng(7)
        vals = rng.integers(-32, 32, 1 << 16).astype(np.int8)
        b = (vals.astype(np.uint32) + 32) & 63
        g = b.reshape(-1, 16).T
        w0 = (g[0] | (g[1] << 6) | (g[2] << 12) | (g[3] << 18)
              | (g[4] << 24) | ((g[5] & 3) << 30))
        w1 = ((g[5] >> 2) | (g[6] << 4) | (g[7] << 10) | (g[8] << 16)
              | (g[9] << 22) | ((g[10] & 15) << 28))
        w2 = ((g[10] >> 4) | (g[11] << 2) | (g[12] << 8) | (g[13] << 14)
              | (g[14] << 20) | (g[15] << 26))
        words = np.stack([w0, w1, w2], axis=1).reshape(-1)

        got = _unpack6(words, len(vals))
        assert np.array_equal(got[:len(vals)], vals)

        import fibers_tpu.native as native
        if native.lib() is not None:
            os.environ["FIBERS_NO_NATIVE"] = "1"
            try:
                saved, native._lib, native._tried = native._lib, None, False
                got_np = _unpack6(words, len(vals))
                assert np.array_equal(got_np[:len(vals)], vals)
            finally:
                native._lib, native._tried = saved, True
                del os.environ["FIBERS_NO_NATIVE"]

    def test_bad_wire_mode(self):
        ov, mask, seedm = self._curved_setup()
        with pytest.raises(ValueError, match="wire"):
            ft.stream(ov, mask=_mask_mri(ov, mask), wire="i4")


class TestNewPointExports:
    """stream_new_point / stream_micro_new_point single-step parity with
    the per-voxel oracle (reference exports stream_new_point! /
    stream_micro_new_point!, src/stream.jl:7-8)."""

    def test_new_point_matches_oracle_chain(self):
        from oracle import stream_line_oracle

        rng = np.random.default_rng(5)
        shape = (12, 12, 12)
        v = rng.standard_normal(shape + (2, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        mask = np.ones(shape, bool)
        mask[:2] = mask[-2:] = False

        ovs = []
        for i in range(2):
            m = ft.MRI(vol=v[..., i, :])
            m.vox2ras0 = np.eye(4, dtype=np.float32)
            m.volsize = np.asarray(shape)
            m.width, m.height, m.depth = shape
            m.nframes = 3
            m.set_geometry()
            ovs.append(m)

        work = ft.StreamWork(ovs, mask=_mask_mri(ovs[0], mask),
                             smooth_coeff=0.0, ang_thresh=90.0)
        ovecs_masked = v * mask[..., None, None]

        # Rebuild the full bidirectional line with stream_new_point using
        # the reference's driver loop, and compare against the line oracle
        seed = np.array([6, 6, 6])
        len_max = 10
        cos_thr = np.cos(np.radians(90.0))
        oracle_pts = stream_line_oracle(
            seed, np.zeros(3), ovecs_masked, mask, smooth_coeff=0.0,
            cosang_thresh=cos_thr, len_max=len_max)

        strline = []
        npts = 0
        for fwd in (1, -1):
            pos = seed.astype(float)
            vec = ovecs_masked[6, 6, 6, 0].astype(float) * fwd
            addpt = (lambda p: strline.insert(0, p)) if fwd == 1 else \
                strline.append
            while True:
                pos_next, vec_next, ok = ft.stream_new_point(pos, vec, work)
                if not ok:
                    break
                addpt(pos.copy())
                npts += 1
                if float(vec @ vec_next) < cos_thr:
                    break
                if npts > len_max:
                    break
                pos, vec = pos_next, vec_next

        assert len(strline) > 0
        assert np.allclose(np.asarray(strline), oracle_pts, atol=1e-5)

    def test_micro_new_point_matches_oracle_chain(self):
        from oracle import stream_micro_line_oracle

        rng = np.random.default_rng(7)
        shape = (16, 16, 16)
        v = rng.standard_normal(shape + (1, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        v[..., 0, :] = (v[..., 0, :] + np.array([1.5, 0, 0])) \
            / np.linalg.norm(v[..., 0, :] + np.array([1.5, 0, 0]),
                             axis=-1, keepdims=True)
        mask = np.ones(shape, bool)

        m = ft.MRI(vol=v[..., 0, :])
        m.vox2ras0 = np.eye(4, dtype=np.float32)
        m.volsize = np.asarray(shape)
        m.width, m.height, m.depth = shape
        m.nframes = 3
        m.set_geometry()

        work = ft.StreamWork(m, mask=_mask_mri(m, mask), smooth_coeff=0.0,
                             ang_thresh=90.0, search_dist=3, search_ang=60.0,
                             step_size=1.0)

        seed = np.array([8, 8, 8])
        len_max = 6
        cos_thr = np.cos(np.radians(90.0))
        oracle_pts = stream_micro_line_oracle(
            seed, v, mask, (3, 3, 3), search_ang=60.0, step_size=1.0,
            ang_thresh=90.0, smooth_coeff=0.0, len_max=len_max)

        strline = []
        npts = 0
        for fwd in (1, -1):
            pos = seed.astype(float)
            vec = v[8, 8, 8, 0].astype(float) * fwd
            addpt = (lambda p: strline.insert(0, p)) if fwd == 1 else \
                strline.append
            while True:
                pos_next, vec_next, ok = ft.stream_micro_new_point(
                    pos, vec, work)
                if not ok:
                    break
                addpt(pos.copy())
                npts += 1
                if float(vec @ vec_next) < cos_thr:
                    break
                if npts > len_max:
                    break
                pos, vec = pos_next, vec_next

        assert len(strline) > 0
        assert np.allclose(np.asarray(strline), oracle_pts, atol=1e-5)


class TestModesWire:
    """LCM and micro modes on the production int8 wire (forced on CPU)."""

    def _micro_setup(self):
        shape = (30, 9, 9)
        ov = _vec_field(shape, (1, 0, 0))
        ov.volres = np.array([0.01, 0.01, 0.01], np.float32)
        mask = np.zeros(shape, bool)
        mask[:, 3:6, 3:6] = True
        seedm = np.zeros(shape, bool)
        seedm[10:20, 4, 4] = True
        return ov, _mask_mri(ov, mask), _mask_mri(ov, seedm)

    def test_micro_i8_exact(self):
        """Cone-search jumps land on integer voxels, so the unit-quantum
        delta wire reproduces the f32 path EXACTLY."""
        ov, mask, seed = self._micro_setup()
        kw = dict(mask=mask, seed=seed, nsub=0, search_dist=3, len_max=100)
        f32 = ft.stream(ov, wire="f32", **kw)
        i8 = ft.stream(ov, wire="i8", **kw)
        np.testing.assert_array_equal(np.asarray(f32.npts),
                                      np.asarray(i8.npts))
        np.testing.assert_array_equal(f32.packed_xyz, i8.packed_xyz)

    def test_micro_sink(self, tmp_path):
        ov, mask, seed = self._micro_setup()
        kw = dict(mask=mask, seed=seed, nsub=0, search_dist=3, len_max=100)
        mem = ft.stream(ov, wire="i8", **kw)
        out = str(tmp_path / "micro.trk")
        ft.stream(ov, wire="i8", trk_sink=out, **kw)
        back = ft.trk_read(out)
        assert back.n_count == mem.n_count
        mem.materialize()
        for i in range(mem.n_count):
            np.testing.assert_allclose(back.xyz[i], mem.xyz[i], atol=1e-4)

    def _lcm_setup(self):
        shape = (16, 16, 1)
        v = np.zeros(shape + (3,), np.float32)
        v[..., 0] = 1.0
        ov = ft.MRI(vol=v)
        ov.vox2ras0 = np.eye(4, dtype=np.float32)
        ov.volsize = np.asarray(shape)
        ov.width, ov.height, ov.depth = shape
        ov.nframes = 3
        ov.set_geometry()
        mask = np.zeros(shape, bool)
        mask[:, 6:10, 0] = True
        seedm = np.zeros(shape, bool)
        seedm[6:10, 8, 0] = True
        lcm = np.zeros(shape + (10,), np.float32)
        lcm[..., 2] = 1.0
        return ov, _mask_mri(ov, mask), _mask_mri(ov, seedm), ft.MRI(vol=lcm)

    def test_lcm_i8_matches_f32(self):
        """Same PRNG keys -> same paths; the i8 wire reproduces the
        coordinates within the 2/qscale bound and the method-difference
        scalars exactly."""
        ov, mask, seed, lcmm = self._lcm_setup()
        kw = dict(mask=mask, seed=seed, lcms=lcmm, nsub=0, step_size=1.0,
                  len_max=100, seed_rng=5)
        f32 = ft.stream(ov, wire="f32", **kw)
        i8 = ft.stream(ov, wire="i8", **kw)
        np.testing.assert_array_equal(np.asarray(f32.npts),
                                      np.asarray(i8.npts))
        np.testing.assert_allclose(i8.packed_xyz, f32.packed_xyz,
                                   atol=2.0 / 127.0)
        np.testing.assert_array_equal(i8.packed_scalars, f32.packed_scalars)

    def test_lcm_sink_with_scalars(self, tmp_path):
        ov, mask, seed, lcmm = self._lcm_setup()
        kw = dict(mask=mask, seed=seed, lcms=lcmm, nsub=0, step_size=1.0,
                  len_max=100, seed_rng=5)
        mem = ft.stream(ov, **kw)
        out = str(tmp_path / "lcm.trk")
        ft.stream(ov, trk_sink=out, **kw)
        back = ft.trk_read(out)
        assert back.n_count == mem.n_count
        assert back.n_scalars == 1
        mem.materialize()
        for i in range(mem.n_count):
            np.testing.assert_allclose(back.xyz[i], mem.xyz[i], atol=1e-4)
            np.testing.assert_allclose(back.scalars[i], mem.scalars[i],
                                       atol=1e-6)

    def test_packed_scalar_trk_roundtrip(self, tmp_path):
        """Packed Tract with per-point scalars writes the same bytes the
        per-line writer produces."""
        ov, mask, seed, lcmm = self._lcm_setup()
        tr = ft.stream(ov, mask=mask, seed=seed, lcms=lcmm, nsub=0,
                       step_size=1.0, len_max=100, seed_rng=5)
        packed_f = str(tmp_path / "packed.trk")
        ft.trk_write(tr, packed_f)

        import copy
        tr2 = ft.stream(ov, mask=mask, seed=seed, lcms=lcmm, nsub=0,
                        step_size=1.0, len_max=100, seed_rng=5)
        tr2.materialize()   # force the per-line writer
        line_f = str(tmp_path / "line.trk")
        ft.trk_write(tr2, line_f)
        with open(packed_f, "rb") as a, open(line_f, "rb") as b:
            assert a.read() == b.read()


class TestPeaksToOvecs:
    def test_rumba_peaks_split_and_track(self):
        """rumba_rec -> peaks_to_ovecs -> stream produces streamlines on
        a single-fiber phantom (the config-4 -> config-5 chain)."""
        from phantom import make_phantom
        dwi, mask, axes, _ = make_phantom(shape=(8, 6, 6), ndir=30)
        rec = ft.rumba_rec(dwi, mask, ft.sphere_362, niter=40)
        ovecs, fs = ft.peaks_to_ovecs(rec)
        assert len(ovecs) == 5 and len(fs) == 5
        m = mask.vol > 0
        norms = np.linalg.norm(ovecs[0].vol[m], axis=-1)
        assert np.allclose(norms[norms > 0], 1.0, atol=1e-5)
        # amplitude volume carries what the magnitude used to
        orig = np.linalg.norm(rec.peak[0].vol[m], axis=-1)
        np.testing.assert_allclose(fs[0].vol[m], orig, atol=1e-6)

        tr = ft.stream(ovecs, f=fs, mask=mask, nsub=1, f_thresh=0.01)
        assert tr.n_count > 10

    def test_gqi_passthrough(self):
        from phantom import make_phantom
        dwi, mask, _, _ = make_phantom(shape=(4, 4, 4), ndir=30)
        rec = ft.gqi_rec(dwi, mask, ft.sphere_362)
        ovecs, fs = ft.peaks_to_ovecs(rec)
        assert ovecs[0] is rec.peak[0]
        assert fs[0] is rec.qa[0]


class TestDevicePeaksHandoff:
    """Device-resident fit->tract handoff (core.handoff.DevicePeaks):
    stream consumes the fit's peak batch with no fetch/rebuild/upload
    and must produce IDENTICAL streamlines to the host-volume path."""

    def _tract_arrays(self, tr):
        pts = np.concatenate([np.asarray(x).T for x in tr.xyz]) \
            if tr.n_count else np.zeros((0, 3))
        return tr.n_count, pts

    def test_gqi_handoff_matches_host_path(self):
        from phantom import make_phantom
        dwi, mask, _, _ = make_phantom(shape=(10, 10, 10), ndir=30)
        gqi = ft.gqi_rec(dwi, mask, ft.sphere_362)

        ovecs, fs = ft.peaks_to_ovecs(gqi)
        host = ft.stream(ovecs, f=fs, mask=mask, nsub=1, f_thresh=0.01)

        pk = ft.peaks_to_ovecs(gqi, device=True)
        dev = ft.stream(pk, mask=mask, nsub=1, f_thresh=0.01)

        n_h, p_h = self._tract_arrays(host)
        n_d, p_d = self._tract_arrays(dev)
        assert n_d == n_h and n_h > 0
        np.testing.assert_array_equal(p_d, p_h)

    def test_rumba_handoff_matches_host_path(self):
        from phantom import make_phantom
        dwi, mask, _, _ = make_phantom(shape=(8, 8, 8), ndir=30)
        rum = ft.rumba_rec(dwi, mask, ft.sphere_362, niter=10)

        ovecs, fs = ft.peaks_to_ovecs(rum)
        host = ft.stream(ovecs, f=fs, mask=mask, nsub=1, f_thresh=0.01)

        pk = ft.peaks_to_ovecs(rum, device=True)
        dev = ft.stream(pk, mask=mask, nsub=1, f_thresh=0.01)

        n_h, p_h = self._tract_arrays(host)
        n_d, p_d = self._tract_arrays(dev)
        assert n_d == n_h and n_h > 0
        np.testing.assert_allclose(p_d, p_h, atol=1e-6)

    def test_handoff_requires_mask(self):
        import pytest
        from phantom import make_phantom
        dwi, mask, _, _ = make_phantom(shape=(8, 8, 8), ndir=30)
        gqi = ft.gqi_rec(dwi, mask, ft.sphere_362)
        pk = ft.peaks_to_ovecs(gqi, device=True)
        with pytest.raises(ValueError, match="mask"):
            ft.stream(pk, nsub=1)

    def test_dsi_handoff_matches_host_path(self):
        import sys
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "benchmarks"))
        from bench_models import dsi_qgrid
        import numpy as np
        rng = np.random.default_rng(0)
        bval, bvec = dsi_qgrid(3)
        shape = (10, 10, 8)
        x, y, z = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape],
                              indexing="ij")
        mask_a = (x**2 + y**2 + z**2) < 0.95
        th = 0.8 * x
        ax = np.stack([np.cos(th), np.sin(th), np.zeros_like(th)], -1)
        dots = np.einsum("xyzi,vi->xyzv", ax, bvec.astype(np.float32))
        vol = (100.0 * np.exp(-bval * (3e-4 + 1.4e-3 * dots**2))
               ).astype(np.float32) * mask_a[..., None]
        dwi = ft.MRI(vol=vol)
        dwi.vox2ras0 = np.eye(4, dtype=np.float32)
        dwi.volsize = np.asarray(shape)
        dwi.width, dwi.height, dwi.depth = shape
        dwi.nframes = len(bval)
        dwi.set_geometry()
        dwi.bval, dwi.bvec = bval, bvec
        maskm = ft.MRI.like(dwi, 1, np.float32)
        maskm.vol = mask_a.astype(np.float32)

        dsi = ft.dsi_rec(dwi, maskm, ft.sphere_362)
        ovecs, fs = ft.peaks_to_ovecs(dsi)
        host = ft.stream(ovecs, f=fs, mask=maskm, nsub=1, f_thresh=0.0)
        pk = ft.peaks_to_ovecs(dsi, device=True)
        dev = ft.stream(pk, mask=maskm, nsub=1, f_thresh=0.0)
        n_h, p_h = self._tract_arrays(host)
        n_d, p_d = self._tract_arrays(dev)
        assert n_d == n_h and n_h > 0
        np.testing.assert_array_equal(p_d, p_h)


class TestHostScratchPool:
    def test_scratch_reuses_and_grows(self):
        import fibers_tpu.utils.hostbuf as hb

        hb._reset()
        a = hb.scratch("t", 100, np.float32)
        base_a = a.base if a.base is not None else a
        b = hb.scratch("t", 80, np.float32)
        base_b = b.base if b.base is not None else b
        assert base_a is base_b            # same pooled buffer
        assert len(b) == 80
        c = hb.scratch("t", 10_000, np.float32)
        assert len(c) == 10_000            # grew
        d = hb.scratch("t", 100, np.int8)  # dtype keys separately
        assert d.dtype == np.int8
        hb._reset()

    def test_sink_fused_appends_share_one_buffer(self, tmp_path):
        """Consecutive fused sink appends must not corrupt each other
        despite sharing the pooled record buffer (written to the file
        before the next chunk reuses it)."""
        import fibers_tpu as ft
        from fibers_tpu.io.trk import Tract, TrkSink
        from fibers_tpu import native
        if native.lib() is None:
            import pytest
            pytest.skip("no native lib")

        rng = np.random.default_rng(3)
        ref = ft.MRI(vol=np.zeros((10, 10, 10), np.float32))
        ref.vox2ras0 = np.eye(4, dtype=np.float32)
        ref.volsize = np.array([10, 10, 10])
        ref.width, ref.height, ref.depth = 10, 10, 10
        ref.set_geometry()
        tr = Tract.from_ref(ref)
        qscale = 62.0
        chunks = []
        for _ in range(3):
            nl = 5
            npts = rng.integers(2, 9, nl).astype(np.int32)
            total = int(npts.sum())
            deltas = rng.integers(-31, 32, total * 3).astype(np.int8)
            b = (deltas.astype(np.uint32) + 32) & 63
            pad = (-len(b)) % 16
            b = np.concatenate([b, np.zeros(pad, np.uint32)])
            g = b.reshape(-1, 16).T
            w0 = (g[0] | (g[1] << 6) | (g[2] << 12) | (g[3] << 18)
                  | (g[4] << 24) | ((g[5] & 3) << 30))
            w1 = ((g[5] >> 2) | (g[6] << 4) | (g[7] << 10) | (g[8] << 16)
                  | (g[9] << 22) | ((g[10] & 15) << 28))
            w2 = ((g[10] >> 4) | (g[11] << 2) | (g[12] << 8)
                  | (g[13] << 14) | (g[14] << 20) | (g[15] << 26))
            words = np.stack([w0, w1, w2], 1).reshape(-1).astype(np.uint32)
            anch = (rng.random((nl, 3)) * 5).astype(np.float32)
            chunks.append((words, npts, anch, deltas))

        p = str(tmp_path / "pool.trk")
        with TrkSink(p, tr, 15) as sink:
            for words, npts, anch, _ in chunks:
                assert sink.append_deltas6(words, npts, anch, qscale)
        back = ft.trk_read(p)
        assert back.n_count == 15
        # check the LAST chunk's first line against a direct decode
        words, npts, anch, deltas = chunks[-1]
        cum = np.cumsum(deltas[:npts[0] * 3].reshape(-1, 3)
                        .astype(np.float64), axis=0)
        want = anch[0] + cum / qscale
        got = np.asarray(back.xyz[10]).T
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_scratch_lru_eviction_keeps_live_views_valid(self):
        import fibers_tpu.utils.hostbuf as hb

        hb._reset()
        old_cap = hb._CAP_BYTES
        try:
            hb._CAP_BYTES = 1 << 20
            a = hb.scratch("one", 200_000, np.float32)
            a[:] = 7.0
            hb.scratch("two", 200_000, np.float32)  # evicts "one"
            assert ("one", np.dtype(np.float32)) not in hb._pool
            assert (a == 7.0).all()      # live view refcount-protected
            # the just-created entry is never evicted
            assert ("two", np.dtype(np.float32)) in hb._pool
        finally:
            hb._CAP_BYTES = old_cap
            hb._reset()
