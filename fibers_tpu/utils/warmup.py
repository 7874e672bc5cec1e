"""Asynchronous ahead-of-time compilation of the hot shape buckets.

On a compile-cache miss the pipeline's kernels would otherwise compile
serially inside the first run.  `warm_e2e_async` lowers + compiles the
e2e pipeline's kernels for their real shape buckets on a daemon thread,
so compilation overlaps the host-side scan load and the signal upload.

Compilation is keyed by shapes, not values, so the warm-up needs only
the problem geometry.  Compiled executables land in JAX's in-process
executable cache AND the persistent cache; the pipeline's later calls
with real data hit them directly.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["warm_e2e_async", "warm_rumba_async", "warm_stream_async"]


def _sds(shape, dtype=np.float32):
    import jax

    return jax.ShapeDtypeStruct(shape, dtype)


def _warm_e2e(shape3, nvol, n_pad, sphere, chunk, nvec, wire="i8"):
    import jax

    from ..core import batch as _batch
    from ..core.odf import half_sphere
    from ..models.dti import _adc_kernel, _dti_kernel
    from ..models.gqi import _gqi_kernel
    from ..ops.peaks import build_neighbors

    sig = _sds((n_pad, nvol))

    # batch dequant (uint16 wire)
    jax.jit(_batch._dq_kernel).lower(
        _sds((n_pad, nvol), np.uint16), _sds((), np.float32)).compile()

    # ADC + DTI kernels
    _adc_kernel.lower(sig, _sds((nvol, 2)), _sds((nvol,))).compile()
    _dti_kernel.lower(sig, _sds((nvol, 7)), _sds((nvol,))).compile()

    # GQI kernel — the neighbor table's shape needs the real topology
    # (small host math)
    nvert = sphere.nvert_half
    _, _, faces0 = half_sphere(sphere)
    nbr, nbr_ok = build_neighbors(faces0, nvert)
    _gqi_kernel.lower(
        sig, _sds((nvert, nvol)), _sds((nvert, 3)),
        _sds(nbr.shape, nbr.dtype), _sds(nbr_ok.shape, nbr_ok.dtype),
        npeak=3).compile()

    _warm_stream(shape3, n_pad, nvec, chunk, wire)


def _warm_stream(shape3, n_pad, nvec, chunk, wire="i8"):
    """Compile the tractography shape bucket: device ovec build,
    propagation, meta pack, and the point-compaction caps.  The point
    wire resolves through the same `_wire_mode` that `stream` uses, so
    the warmed propagation bucket is the one the run executes."""
    from ..tract import stream as _st

    n3 = int(np.prod(shape3))
    _st._build_ovec_device.lower(
        _sds((n_pad, nvec, 3)), _sds((n_pad, nvec)),
        _sds((n_pad,), np.int32), _sds((n3,), bool),
        0.0, nxyz=n3).compile()

    nsteps = int(max(shape3)) + 2
    mode, emit, qscale, dmax = _st._wire_mode(_st.StreamConfig(wire=wire),
                                              0.5)
    _st._propagate.lower(
        _sds((chunk, 3)), _sds((chunk, 3)), _sds((chunk,), np.int32),
        _sds((n3, nvec, 3)), nsteps, tuple(shape3), 0.5,
        float(np.cos(np.radians(45.0))), 0.2, int(max(shape3)),
        emit=emit, qscale=qscale, dmax=dmax).compile()
    _st._pack_meta.lower(
        _sds((chunk,), np.int32), _sds((chunk,), np.int32),
        _sds((chunk, 3))).compile()

    if emit == "deltas":
        # compaction cap is the next power of two above the chunk's
        # total saved points — 2^23/2^24 cover the 1M-seed benchmarks
        for cap in (1 << 23, 1 << 24):
            _st._compact.lower(
                _sds((nsteps, chunk, 3), np.int8),
                _sds((nsteps, chunk, 3), np.int8),
                _sds((chunk,), np.int32), _sds((chunk,), np.int32),
                _sds((chunk,), bool), _sds((chunk,), np.int32),
                cap=cap, mode=mode).compile()


def warm_stream_async(shape3, n_pad, nvec, chunk=1 << 17,
                      wire="i8") -> threading.Thread:
    """Start compiling just the tractography bucket in the background
    (the chained fit->tract benchmarks warm the stream shapes while the
    fit runs)."""
    def run():
        try:
            _warm_stream(tuple(shape3), int(n_pad), int(nvec),
                         int(chunk), wire)
        except Exception as e:          # pragma: no cover
            import sys
            sys.stderr.write(f"fibers_tpu.warmup: best-effort warm-up "
                             f"failed: {e!r}\n")

    t = threading.Thread(target=run, daemon=True, name="fibers-warmup-s")
    t.start()
    return t


def warm_e2e_async(shape3, nvol, n_pad, sphere=None, chunk=1 << 17,
                   nvec=1, wire="i8") -> threading.Thread:
    """Start compiling the DTI+GQI+stream shape bucket in the background.

    Returns the (daemon) thread; join() it to bound worst-case cold
    start, or ignore it — compiles that finish first still count.
    Failures are swallowed (warm-up is best-effort; the pipeline
    compiles on demand as before)."""
    if sphere is None:
        from ..core import odf as _odf
        sphere = _odf.sphere_642

    def run():
        try:
            _warm_e2e(tuple(shape3), int(nvol), int(n_pad), sphere,
                      int(chunk), int(nvec), wire)
        except Exception as e:          # pragma: no cover
            import sys
            sys.stderr.write(f"fibers_tpu.warmup: best-effort warm-up "
                             f"failed: {e!r}\n")

    t = threading.Thread(target=run, daemon=True, name="fibers-warmup")
    t.start()
    return t


def warm_rumba_async(tv_shape3, ndir, ncomp, n_rows,
                     k=None) -> threading.Thread:
    """Start compiling the RUMBA iteration block for its shape bucket."""

    def run():
        try:
            from ..models import rumba as _r

            kk = _r._BLOCK_ITERS if k is None else int(k)
            X, Y, Z = (int(s) for s in tv_shape3)
            tv_nxyz = X * Y * Z
            _r._rumba_block.lower(
                _sds((n_rows, ncomp)), _sds((n_rows, ndir)),
                _sds((n_rows, ndir)), _sds((n_rows, 1)),
                _sds((tv_nxyz,)), _sds((n_rows, ndir)),
                _sds((ndir, ncomp)), _sds((n_rows,), np.int64),
                k=kk, n_order=1, ipat_factor=1, use_tv=True,
                shape3=(X, Y, Z), nxyz=tv_nxyz,
                precision=_r.DEFAULT_PRECISION, mesh=None,
                tv_bf16=False).compile()
        except Exception as e:          # pragma: no cover
            import sys
            sys.stderr.write(f"fibers_tpu.warmup: best-effort warm-up "
                             f"failed: {e!r}\n")

    t = threading.Thread(target=run, daemon=True, name="fibers-warmup-r")
    t.start()
    return t
