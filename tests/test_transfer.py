"""Unit tests for the tuned host<->device transfer layer (CPU backend;
the chunking/trim logic is backend-independent)."""

import numpy as np
import jax.numpy as jnp

from fibers_tpu.ops import transfer
from fibers_tpu.ops.transfer import to_device, to_host


def test_to_host_roundtrip_shapes(rng):
    for shape in [(7,), (5, 3), (4, 6, 2), (1,), (3, 1)]:
        x = rng.standard_normal(shape).astype(np.float32)
        got = to_host(jnp.asarray(x) * 2.0)
        np.testing.assert_allclose(got, x * 2.0, rtol=1e-6)
        assert got.shape == shape


def test_to_host_chunked_and_n_lead(rng, monkeypatch):
    # force tiny chunks so the aligned-chunk + overread-trim paths run
    monkeypatch.setattr(transfer, "_CHUNK_BYTES", 256)
    x = rng.standard_normal((100, 7)).astype(np.float32)
    d = jnp.asarray(x) + 1.0

    got = to_host(d)
    np.testing.assert_allclose(got, x + 1.0, rtol=1e-6)

    for n_lead in (1, 13, 99, 100, 250):
        got = to_host(d, n_lead=n_lead)
        n = min(n_lead, 100)
        assert got.shape == (n, 7)
        np.testing.assert_allclose(got, x[:n] + 1.0, rtol=1e-6)


def test_to_host_int_dtypes(rng, monkeypatch):
    monkeypatch.setattr(transfer, "_CHUNK_BYTES", 128)
    x = rng.integers(-100, 100, (64, 5)).astype(np.int32)
    got = to_host(jnp.asarray(x))
    np.testing.assert_array_equal(got, x)


def test_to_device_chunked(rng, monkeypatch):
    monkeypatch.setattr(transfer, "_UP_CHUNK_BYTES", 512)
    x = rng.standard_normal((200, 9)).astype(np.float32)
    d = to_device(x)
    assert d.shape == x.shape
    np.testing.assert_allclose(np.asarray(d), x, rtol=1e-7)

    small = rng.standard_normal((3, 2)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(to_device(small)), small)


def test_prepare_batch_pipelined_matches_gather(rng, monkeypatch):
    """The slab-pipelined single-device upload must equal the plain
    gather_frames+pad_rows batch, including straddling/padding slabs."""
    import fibers_tpu as ft
    from fibers_tpu.ops.masked import gather_frames, mask_indices

    monkeypatch.setattr(transfer, "_UP_CHUNK_BYTES", 1024)  # tiny slabs

    vol = rng.standard_normal((9, 8, 7, 5)).astype(np.float32)
    dwi = ft.MRI(vol=vol)
    dwi.vox2ras0 = np.eye(4, dtype=np.float32)
    dwi.volsize = np.asarray(vol.shape[:3])
    dwi.width, dwi.height, dwi.depth = vol.shape[:3]
    dwi.nframes = 5
    dwi.set_geometry()
    mask = ft.MRI.like(dwi, 1, np.float32)
    mask.vol = (rng.random(vol.shape[:3]) < 0.4).astype(np.float32)

    batch = ft.prepare_batch(dwi, mask)
    idx = mask_indices(mask.vol)
    ref = gather_frames(vol, idx).astype(np.float32)

    got = np.asarray(batch.signals)
    np.testing.assert_array_equal(got[:len(idx)], ref)
    np.testing.assert_array_equal(got[len(idx):], 0.0)


class TestQuantizedBatchWire:
    """uint16 host->device wire for prepared batches (halves the
    dominant e2e upload; BASELINE.md) — forced on CPU so parity is
    CI-checkable without an accelerator."""

    def test_u16_batch_error_bound(self):
        from phantom import make_phantom
        import fibers_tpu as ft

        dwi, mask, _, _ = make_phantom(shape=(8, 8, 6), ndir=30)
        b_f32 = ft.prepare_batch(dwi, mask, wire="f32")
        b_u16 = ft.prepare_batch(dwi, mask, wire="u16")
        assert b_u16.signals.dtype == jnp.float32
        scale = float(np.asarray(dwi.vol).max()) / 65535.0
        err = np.abs(np.asarray(b_u16.signals)
                     - np.asarray(b_f32.signals)).max()
        assert err <= 0.51 * scale + 1e-6

    def test_u16_fit_parity(self):
        from phantom import make_phantom
        import fibers_tpu as ft

        dwi, mask, _, _ = make_phantom(shape=(8, 8, 6), ndir=30)
        b_f32 = ft.prepare_batch(dwi, mask, wire="f32")
        b_u16 = ft.prepare_batch(dwi, mask, wire="u16")

        dti_f = ft.dti_fit(dwi, mask, batch=b_f32)
        dti_q = ft.dti_fit(dwi, mask, batch=b_u16)
        np.testing.assert_allclose(dti_q.fa.vol, dti_f.fa.vol, atol=1e-3)
        np.testing.assert_allclose(dti_q.md.vol, dti_f.md.vol,
                                   rtol=1e-3, atol=1e-9)

        gqi_f = ft.gqi_rec(dwi, mask, ft.sphere_362, batch=b_f32)
        gqi_q = ft.gqi_rec(dwi, mask, ft.sphere_362, batch=b_u16)
        np.testing.assert_allclose(np.asarray(gqi_q.odf.vol),
                                   np.asarray(gqi_f.odf.vol),
                                   rtol=1e-3, atol=1e-5)

    def test_u8_batch_error_bound_and_dsi_parity(self):
        """uint8 wire (DSI's scale-invariant upload): error bound holds
        and the DSI ODF peaks survive the quantization."""
        from phantom import make_phantom
        import fibers_tpu as ft

        dwi, mask, _, _ = make_phantom(shape=(8, 8, 6), ndir=30)
        b_f32 = ft.prepare_batch(dwi, mask, wire="f32")
        b_u8 = ft.prepare_batch(dwi, mask, wire="u8")
        assert b_u8.signals.dtype == jnp.float32
        scale = float(np.asarray(dwi.vol).max()) / 255.0
        err = np.abs(np.asarray(b_u8.signals)
                     - np.asarray(b_f32.signals)).max()
        assert err <= 0.51 * scale + 1e-6

        # native gather_quant_u8 == numpy _quantize_rows fallback
        from fibers_tpu.core.batch import _gather_rows, _quantize_rows
        from fibers_tpu import native
        if native.lib() is not None:
            vol = np.asarray(dwi.vol)
            flat = np.ascontiguousarray(
                vol.reshape(-1, vol.shape[3]), np.float32)
            take = np.flatnonzero(np.asarray(mask.vol).reshape(-1) > 0)
            nat = _gather_rows(flat, take, "u8", scale)
            ref = _quantize_rows(flat[take].astype(np.float32), scale,
                                 "u8")
            np.testing.assert_array_equal(nat, ref)

    def test_u8_dsi_peak_parity(self):
        from test_dsi import make_dsi_phantom
        import fibers_tpu as ft

        dwi, mask, axis = make_dsi_phantom(shape=(5, 5, 5),
                                           axis=(1, 0.3, 0.1))
        b_f32 = ft.prepare_batch(dwi, mask, wire="f32")
        b_u8 = ft.prepare_batch(dwi, mask, wire="u8")
        d_f = ft.dsi_rec(dwi, mask, ft.sphere_362, batch=b_f32)
        d_q = ft.dsi_rec(dwi, mask, ft.sphere_362, batch=b_u8)
        odf_f = np.asarray(d_f.odf.vol)
        odf_q = np.asarray(d_q.odf.vol)
        assert np.abs(odf_q - odf_f).max() <= 5e-3 * np.abs(odf_f).max()
        pk_f = np.asarray(d_f.peak[0].vol)
        pk_q = np.asarray(d_q.peak[0].vol)
        nrm = np.linalg.norm(pk_f, axis=-1) * np.linalg.norm(pk_q, axis=-1)
        live = nrm > 0
        cosang = np.abs((pk_f * pk_q).sum(-1)[live]) / nrm[live]
        assert np.degrees(np.arccos(np.clip(cosang, -1, 1))).max() < 2.0

    def test_auto_wire_is_exact_on_cpu(self):
        from phantom import make_phantom
        import fibers_tpu as ft

        dwi, mask, _, _ = make_phantom(shape=(6, 6, 4), ndir=12)
        b_auto = ft.prepare_batch(dwi, mask)          # auto -> f32 on CPU
        b_f32 = ft.prepare_batch(dwi, mask, wire="f32")
        np.testing.assert_array_equal(np.asarray(b_auto.signals),
                                      np.asarray(b_f32.signals))

    def test_wire_scale_ignores_out_of_mask_artifacts(self):
        """The quantization range comes from the MASKED rows only: a
        bright artifact outside the mask (skull, coil flare) must not
        inflate the scale and waste in-mask wire precision."""
        from phantom import make_phantom
        import fibers_tpu as ft
        from fibers_tpu.core.batch import _resolve_wire

        dwi, mask, _, _ = make_phantom(shape=(8, 8, 6), ndir=12)
        vol = np.asarray(dwi.vol).copy()
        mv = np.asarray(mask.vol).copy()
        mv[0, 0, 0] = 0                       # exclude one corner voxel
        vol[0, 0, 0, :] = 1e6                 # ... and make it blinding
        flat = vol.reshape(-1, vol.shape[3])
        idx = np.flatnonzero(mv.reshape(-1) > 0)
        q, scale = _resolve_wire(flat, "u16", idx)
        assert q == "u16"
        in_mask_max = flat[idx].max()
        assert scale <= in_mask_max / 65535.0 * 1.001
        # whole-volume fallback (no idx) sees the artifact
        _, scale_full = _resolve_wire(flat, "u16")
        assert scale_full > 10 * scale

    def test_u16_rejects_unquantizable(self):
        import pytest
        from phantom import make_phantom
        import fibers_tpu as ft

        dwi, mask, _, _ = make_phantom(shape=(6, 6, 4), ndir=12)
        dwi.vol = np.zeros_like(np.asarray(dwi.vol))   # max == 0
        with pytest.raises(ValueError, match="u16"):
            ft.prepare_batch(dwi, mask, wire="u16")


class TestNativeGatherRows:
    """The one-pass C gather(+quantize) must match the numpy expression
    bit-for-bit (core/batch._gather_rows; the fallback runs when no C
    compiler exists)."""

    def _flat(self, rng, n=300, nvol=37):
        flat = rng.standard_normal((n, nvol)).astype(np.float32) * 50.0
        flat[rng.random((n, nvol)) < 0.1] *= -1.0      # negatives clip
        take = rng.choice(n, size=120, replace=True).astype(np.int64)
        return np.ascontiguousarray(flat), take

    def test_quantized_matches_numpy(self, rng):
        # _gather_rows uses the native kernel when a C compiler exists
        # and the numpy expression otherwise; either way it must equal
        # the reference expression bit-for-bit.
        from fibers_tpu.core.batch import _gather_rows, _quantize_rows

        flat, take = self._flat(rng)
        scale = float(np.abs(flat).max()) / 65535.0
        got = _gather_rows(flat, take, "u16", scale)
        want = _quantize_rows(flat[take].astype(np.float32), scale,
                              "u16")
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got, want)

    def test_f32_matches_numpy(self, rng):
        from fibers_tpu.core.batch import _gather_rows

        flat, take = self._flat(rng)
        got = _gather_rows(flat, take, False, 0.0)
        np.testing.assert_array_equal(got, flat[take])
        assert got.dtype == np.float32

    def test_noncontiguous_falls_back(self, rng):
        from fibers_tpu.core.batch import _gather_rows

        wide, take = self._flat(rng, nvol=74)
        flat = wide[:, ::2]                     # non-contiguous view
        got = _gather_rows(flat, take, False, 0.0)
        np.testing.assert_array_equal(got, flat[take])


def test_native_rumba_signal_matches_numpy(rng):
    """rumba_signal_u16 (one fused C pass) vs the numpy expression it
    replaces — equal to within one quantization grid unit (the b0 mean's
    accumulation order differs in the last ulp)."""
    from fibers_tpu.native import (as_f32_ptr, as_i32_ptr, as_i64_ptr,
                                   as_u16_ptr, lib)
    import pytest

    if lib() is None:
        pytest.skip("no C compiler")
    nvox, nvol = 500, 33
    flat = np.abs(rng.standard_normal((nvox, nvol))).astype(np.float32)
    flat *= 80.0
    flat[rng.random((nvox, nvol)) < 0.05] *= -1.0
    flat[7] = 0.0                                   # a b0==0 voxel
    ib0 = np.zeros(nvol, bool)
    ib0[:4] = True
    idx = rng.choice(nvox, 200, replace=False).astype(np.int64)
    idx = np.ascontiguousarray(idx)

    ib0_i = np.ascontiguousarray(np.flatnonzero(ib0), np.int32)
    idwi_i = np.ascontiguousarray(np.flatnonzero(~ib0), np.int32)
    got = np.empty((len(idx), len(idwi_i) + 1), np.uint16)
    lib().rumba_signal_u16(as_f32_ptr(flat), as_i64_ptr(idx), len(idx),
                           nvol, as_i32_ptr(ib0_i), len(ib0_i),
                           as_i32_ptr(idwi_i), len(idwi_i),
                           as_u16_ptr(got))

    rows = flat[idx]
    b0_mean = np.maximum(rows[:, ib0], 0).mean(axis=1)
    dwis = np.maximum(rows[:, ~ib0], 0).astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        dwis /= b0_mean[:, None].astype(np.float32)
    dwis[~np.isfinite(dwis)] = 0
    np.clip(dwis, 0.0, 1.0, out=dwis)
    sig = np.concatenate(
        [(b0_mean > 0).astype(np.float32)[:, None], dwis], axis=1)
    want = (sig * np.float32(65535.0) + np.float32(0.5)).astype(np.uint16)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_native_rumba_signal_u12_matches_numpy(rng):
    """rumba_signal_u12 (fused gather + b0-normalize + 12-bit pack) vs
    the numpy normalize + _quantize_pack_u12 composition — equal to
    within one grid unit on the pre-pack values (b0-mean accumulation
    order differs in the last ulp; a one-unit flip changes the packed
    bytes, so compare the UNPACKED fields)."""
    import pytest
    from fibers_tpu.core.batch import _quantize_pack_u12, u12_row_bytes
    from fibers_tpu.native import (as_f32_ptr, as_i32_ptr, as_i64_ptr,
                                   as_u8_ptr, lib)

    if lib() is None:
        pytest.skip("no C compiler")
    nvox, nvol = 400, 33
    flat = np.abs(rng.standard_normal((nvox, nvol))).astype(np.float32)
    flat *= 80.0
    flat[7] = 0.0
    ib0 = np.zeros(nvol, bool)
    ib0[:4] = True
    idx = np.ascontiguousarray(
        rng.choice(nvox, 150, replace=False).astype(np.int64))
    ib0_i = np.ascontiguousarray(np.flatnonzero(ib0), np.int32)
    idwi_i = np.ascontiguousarray(np.flatnonzero(~ib0), np.int32)
    ncol = len(idwi_i) + 1
    got = np.empty((len(idx), u12_row_bytes(ncol)), np.uint8)
    lib().rumba_signal_u12(as_f32_ptr(flat), as_i64_ptr(idx), len(idx),
                           nvol, as_i32_ptr(ib0_i), len(ib0_i),
                           as_i32_ptr(idwi_i), len(idwi_i),
                           as_u8_ptr(got))

    rows = flat[idx]
    b0_mean = np.maximum(rows[:, ib0], 0).mean(axis=1)
    dwis = np.maximum(rows[:, ~ib0], 0).astype(np.float32)
    with np.errstate(invalid="ignore", divide="ignore"):
        dwis /= b0_mean[:, None].astype(np.float32)
    dwis[~np.isfinite(dwis)] = 0
    np.clip(dwis, 0.0, 1.0, out=dwis)
    sig = np.concatenate(
        [(b0_mean > 0).astype(np.float32)[:, None], dwis], axis=1)
    want = _quantize_pack_u12(sig, 1.0 / 4095.0)

    def unpack(b):
        b = b.astype(np.uint32)
        v0 = b[:, 0::3] | ((b[:, 1::3] & 0xF) << 8)
        v1 = (b[:, 1::3] >> 4) | (b[:, 2::3] << 4)
        return np.stack([v0, v1], -1).reshape(len(b), -1)[:, :ncol]

    diff = np.abs(unpack(got).astype(np.int64)
                  - unpack(want).astype(np.int64)).max()
    assert diff <= 1


class TestU12Wire:
    def test_u12_batch_error_bound_and_native_parity(self):
        from phantom import make_phantom
        import fibers_tpu as ft
        from fibers_tpu.core.batch import (_gather_rows,
                                           _quantize_pack_u12)
        from fibers_tpu import native

        dwi, mask, _, _ = make_phantom(shape=(8, 8, 6), ndir=31)
        b_f32 = ft.prepare_batch(dwi, mask, wire="f32")
        b_u12 = ft.prepare_batch(dwi, mask, wire="u12")
        assert b_u12.signals.dtype == jnp.float32
        assert b_u12.signals.shape == b_f32.signals.shape
        scale = float(np.asarray(dwi.vol).max()) / 4095.0
        err = np.abs(np.asarray(b_u12.signals)
                     - np.asarray(b_f32.signals)).max()
        assert err <= 0.501 * scale + 1e-4

        if native.lib() is not None:
            vol = np.asarray(dwi.vol)
            flat = np.ascontiguousarray(
                vol.reshape(-1, vol.shape[3]), np.float32)
            take = np.flatnonzero(np.asarray(mask.vol).reshape(-1) > 0)
            nat = _gather_rows(flat, take, "u12", scale)
            ref = _quantize_pack_u12(flat[take].astype(np.float32),
                                     scale)
            np.testing.assert_array_equal(nat, ref)

    def test_u12_fit_parity(self):
        """Structured-phantom fidelity: FA within 5e-4 and GQI peak
        directions within 0.2 degrees of the exact wire."""
        from phantom import make_phantom
        import fibers_tpu as ft

        dwi, mask, _, _ = make_phantom(shape=(10, 10, 8), ndir=30)
        b_f32 = ft.prepare_batch(dwi, mask, wire="f32")
        b_u12 = ft.prepare_batch(dwi, mask, wire="u12")

        dti_f = ft.dti_fit(dwi, mask, batch=b_f32)
        dti_q = ft.dti_fit(dwi, mask, batch=b_u12)
        np.testing.assert_allclose(dti_q.fa.vol, dti_f.fa.vol, atol=5e-4)

        g_f = ft.gqi_rec(dwi, mask, ft.sphere_362, batch=b_f32)
        g_q = ft.gqi_rec(dwi, mask, ft.sphere_362, batch=b_u12)
        p, q = np.asarray(g_f.peak[0].vol), np.asarray(g_q.peak[0].vol)
        nrm = np.linalg.norm(p, axis=-1) * np.linalg.norm(q, axis=-1)
        live = nrm > 0
        cosang = np.abs((p * q).sum(-1)[live]) / nrm[live]
        ang = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
        assert ang.max() < 0.2

    def test_u12_odd_nvol(self, rng):
        """Odd frame counts pad one zero field per packed row."""
        import fibers_tpu as ft
        from fibers_tpu.core.batch import (_dequant12,
                                           _quantize_pack_u12)

        part = (rng.random((40, 9)) * 500).astype(np.float32)
        scale = float(part.max()) / 4095.0
        packed = _quantize_pack_u12(part, scale)
        assert packed.shape == (40, 15)
        dec = np.asarray(_dequant12(jnp.asarray(packed), scale, 9))
        assert dec.shape == (40, 9)
        assert np.abs(dec - part).max() <= 0.501 * scale + 1e-4

    def test_rumba_signal_wire_values(self):
        from phantom import make_phantom
        import fibers_tpu as ft
        import pytest

        dwi, mask, _, _ = make_phantom(shape=(3, 3, 3), ndir=30)
        with pytest.raises(ValueError, match="signal_wire"):
            ft.rumba_rec(dwi, mask, ft.sphere_362, niter=2,
                         signal_wire="u4")
        # on CPU every wire value falls back to exact f32: identical fits
        a = ft.rumba_rec(dwi, mask, ft.sphere_362, niter=4)
        b = ft.rumba_rec(dwi, mask, ft.sphere_362, niter=4,
                         signal_wire="f32")
        np.testing.assert_array_equal(np.asarray(a.fodf.vol),
                                      np.asarray(b.fodf.vol))
