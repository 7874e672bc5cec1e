"""Model-level benchmarks for BASELINE.md configs 3 and 4.

  python benchmarks/bench_models.py --config 3   # DSI, 96^3 multi-shell
  python benchmarks/bench_models.py --config 4   # RUMBA-SD + structure
                                                 # tensor, HCP resolution

Each run prints one JSON line (same shape as bench.py).  --small shrinks
the problem for CPU smoke runs.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# run as a script from a checkout: the package sits beside this directory
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _geometry(shape, res=1.5):
    import fibers_tpu as ft

    nx, ny, nz = shape
    x, y, z = np.meshgrid(
        np.linspace(-1, 1, nx), np.linspace(-1, 1, ny),
        np.linspace(-1, 1, nz), indexing="ij")
    mask = (x ** 2 / 0.81 + y ** 2 / 0.81 + z ** 2 / 0.92) < 1.0

    th = 0.8 * x + 1.3 * y
    ph = 1.1 * z + 0.5 * x
    ax = np.stack([np.cos(ph) * np.cos(th), np.cos(ph) * np.sin(th),
                   np.sin(ph)], axis=-1).astype(np.float32)
    return mask, ax


def _mri_of(vol, shape, bval, bvec, res=1.5):
    import fibers_tpu as ft

    dwi = ft.MRI(vol=vol)
    dwi.vox2ras0 = np.diag([res, res, res, 1.0]).astype(np.float32)
    dwi.volsize = np.asarray(shape)
    dwi.width, dwi.height, dwi.depth = shape
    dwi.nframes = vol.shape[3]
    dwi.set_geometry()
    dwi.bval, dwi.bvec = bval, bvec
    return dwi


def _signal(mask, ax, bval, bvec, rng):
    lp, lt = 1.7e-3, 0.3e-3
    dots = np.einsum("xyzi,vi->xyzv", ax, bvec.astype(np.float32))
    quad = lt + (lp - lt) * dots ** 2
    vol = (100.0 * np.exp(-bval[None, None, None, :] * quad)).astype(
        np.float32)
    vol *= mask[..., None]
    vol = np.abs(vol + 2.0 * rng.standard_normal(vol.shape).astype(
        np.float32) * mask[..., None])
    return vol


def _signal_cached(tag, shape, mask, ax, bval, bvec, rng):
    """Phantom DWI volume via the shared memmap disk cache
    (benchmarks/_cache.py): the synthetic signal build is ~2 min of
    single-core host time at HCP scale, and even reloading a ~2 GB npz
    costs ~30 s — both would otherwise precede every benchmark run."""
    try:
        import _cache                        # run as a script
    except ImportError:
        from benchmarks import _cache        # imported from the repo root

    base = os.path.join(
        os.environ.get("FIBERS_BENCH_CACHE", tempfile.gettempdir()),
        f"fibers_bench_{tag}_{shape[0]}x{shape[1]}x{shape[2]}_"
        f"{len(bval)}")
    hit = _cache.load(base, bval=bval, bvec=bvec)
    if hit is not None:
        return hit[0]
    vol = _signal(mask, ax, bval, bvec, rng)
    _cache.save(base, vol, bval=bval, bvec=bvec)
    return vol


def dsi_qgrid(radius=5):
    """Cartesian q-space sampling within a ball, DSI-style: b scales with
    |q|^2 (reference grid layout: src/dsi.jl:61-85)."""
    r = np.arange(-radius, radius + 1)
    gx, gy, gz = np.meshgrid(r, r, r, indexing="ij")
    q = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float64)
    keep = (q ** 2).sum(axis=1) <= radius ** 2
    q = q[keep]
    bmax = 8000.0
    norm = np.sqrt((q ** 2).sum(axis=1))
    # exact grid consistency: bvec*sqrt(bval) lands on integer multiples
    bvec = np.where(norm[:, None] > 0,
                    q / np.maximum(norm, 1e-30)[:, None], 0.0)
    bval = (q ** 2).sum(axis=1) * (bmax / radius ** 2)
    return bval.astype(np.float32), bvec.astype(np.float32)


def bench_dsi(small):
    import fibers_tpu as ft

    rng = np.random.default_rng(0)
    shape = (32, 32, 20) if small else (96, 96, 96)
    radius = 3 if small else 5

    bval, bvec = dsi_qgrid(radius)
    sys.stderr.write(f"DSI grid: {len(bval)} q-space samples\n")
    mask, ax = _geometry(shape)
    vol = _signal_cached("dsi", shape, mask, ax, bval, bvec, rng)
    dwi = _mri_of(vol, shape, bval, bvec)
    import fibers_tpu as ft
    maskm = ft.MRI.like(dwi, 1, np.float32)
    maskm.vol = mask.astype(np.float32)

    nmask = int(mask.sum())
    times = []
    for _ in range(2):
        t0 = time.time()
        dsi = ft.dsi_rec(dwi, maskm, ft.sphere_642)
        # materialize peaks only (odf/pdf stay lazy, like a pipeline user)
        np.asarray(dsi.peak[0].vol)
        times.append(time.time() - t0)
        sys.stderr.write(f"dsi_rec: {times[-1]:.1f}s "
                         f"({nmask / times[-1]:.0f} vox/s)\n")
    return {
        "metric": "dsi_rec_96cube_multishell" if not small else
        "dsi_rec_small",
        "value": round(min(times), 3),
        "unit": "seconds",
        "vox_per_sec": round(nmask / min(times)),
    }


def rumba_phantom(shape, ndir, nb0, rng, cache=True):
    """Config-4 phantom: single b=3000 shell, `nb0` b0 volumes, smooth
    orientation field in an ellipsoidal brain mask.  Returns (dwi MRI,
    mask MRI, vol, mask bool array)."""
    import fibers_tpu as ft

    nsh = ndir - nb0
    i = np.arange(nsh)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    zz = 1 - 2 * (i + 0.5) / nsh
    r = np.sqrt(1 - zz * zz)
    dirs = np.stack([r * np.cos(phi), r * np.sin(phi), zz], axis=1)
    bval = np.concatenate([np.zeros(nb0), np.full(nsh, 3000.0)]).astype(
        np.float32)
    bvec = np.concatenate([np.zeros((nb0, 3)), dirs]).astype(np.float32)

    mask, ax = _geometry(shape)
    if cache:
        vol = _signal_cached("rumba", shape, mask, ax, bval, bvec, rng)
    else:
        vol = _signal(mask, ax, bval, bvec, rng)
    dwi = _mri_of(vol, shape, bval, bvec)
    maskm = ft.MRI.like(dwi, 1, np.float32)
    maskm.vol = mask.astype(np.float32)
    return dwi, maskm, vol, mask


def bench_rumba(small, niter=None, tv_bf16=False, chain_stream=False,
                abort_pace=None):
    import fibers_tpu as ft

    rng = np.random.default_rng(0)
    shape = (32, 32, 20) if small else (140, 140, 92)
    ndir = 32 if small else 270
    if niter is None:
        niter = 60 if small else 600

    nb0 = 2 if small else 18
    nsh = ndir - nb0
    dwi, maskm, vol, mask = rumba_phantom(shape, ndir, nb0, rng)
    nmask = int(mask.sum())

    if chain_stream:
        # compile the chained tract stage (5 RUMBA peak vecs, i6 wire)
        # in the background while the fit runs
        from fibers_tpu.ops.masked import padded_size
        from fibers_tpu.utils.warmup import warm_stream_async
        warm_stream_async(shape, padded_size(nmask), nvec=5,
                          chunk=1 << 17, wire="i6")

    # warm the iteration block for this shape bucket so a compile-cache
    # miss compiles under the signal upload instead of inside the timed
    # fit
    from fibers_tpu.models.rumba import _tv_bbox
    from fibers_tpu.ops.masked import mask_indices
    from fibers_tpu.utils.warmup import warm_rumba_async
    idxm = mask_indices(maskm.vol)
    tvs3, _, _, _ = _tv_bbox(idxm, shape)
    warm_rumba_async(tvs3, 1 + nsh, ft.sphere_724.nvert_half + 2,
                     len(idxm))

    t0 = time.time()
    rum = ft.rumba_rec(dwi, maskm, ft.sphere_724, niter=niter,
                       tv_bf16=tv_bf16, abort_s_per_iter=abort_pace)
    # force the peak kernel to completion on DEVICE (the chain consumes
    # device-resident peaks; fetching a volume here would bill a
    # transfer to a stage no pipeline pays)
    from fibers_tpu.ops.transfer import sync
    sync(rum._peak_dev.vecs)
    t_rumba = time.time() - t0
    sys.stderr.write(f"rumba_rec {niter} iters: {t_rumba:.1f}s "
                     f"snr={rum.snr_mean:.1f}\n")
    assert np.isfinite(rum.gfa.vol).all()

    # structure tensor on the mean DWI volume (config 4 pairs them);
    # lazy outputs — a pipeline consumer stays on device, so the stage
    # costs kernel time, not the ~110 MB eigenfield fetch
    t1 = time.time()
    evecs, evals = ft.st_recon(vol.mean(axis=3), sigma=1.0, rho=2.0,
                               lazy=True)
    import jax.numpy as jnp
    assert bool(jnp.isfinite(evals.device).all())
    t_st = time.time() - t1
    sys.stderr.write(f"st_recon: {t_st:.1f}s\n")

    out = {
        "metric": "rumba600_plus_structens_hcp" if not small else
        "rumba_small",
        "value": round(t_rumba + t_st, 3),
        "unit": "seconds",
        "rumba_s": round(t_rumba, 3),
        "structens_s": round(t_st, 3),
        "vox_iters_per_sec": round(nmask * niter / t_rumba),
    }

    if chain_stream:
        # Config 4 -> config 5: RUMBA fODF peaks drive the deterministic
        # tractography, ~1M streams from 3 jittered seeds/voxel.  The
        # peak vectors carry amplitude in their magnitude (reference:
        # src/rusd.jl:602-633); split them into unit directions + `f`
        # amplitude volumes, which the engine thresholds at f_thresh
        # (the propagation math expects unit vectors — the reference's
        # own TODO at src/stream.jl:146).
        # device-resident handoff: no peak fetch, no host orientation
        # rebuild, no re-upload (core.handoff.DevicePeaks)
        pk = ft.peaks_to_ovecs(rum, device=True)

        seed = ft.MRI.like(maskm, 1, np.float32)
        idx = np.flatnonzero(mask)
        nseed_vox = min(1_000_000 // 3, len(idx)) if not small else \
            min(10_000, len(idx))
        pick = idx[np.linspace(0, len(idx) - 1, nseed_vox, dtype=np.int64)]
        sv = np.zeros(mask.size, np.float32)
        sv[pick] = 1
        seed.vol = sv.reshape(mask.shape)

        t2 = time.time()
        # wire="i6": 25% fewer point-fetch bytes (bound 0.032 voxel)
        with tempfile.TemporaryDirectory() as d:
            tract = ft.stream(pk, mask=maskm, seed=seed, nsub=3,
                              wire="i6", trk_sink=os.path.join(d, "rumba.trk"))
        t_tract = time.time() - t2
        sys.stderr.write(f"rumba->stream: {t_tract:.1f}s "
                         f"({tract.n_count} streamlines)\n")
        out["metric"] += "_plus_stream"
        out["stream_s"] = round(t_tract, 3)
        out["streamlines"] = int(tract.n_count)
        out["value"] = round(out["value"] + t_tract, 3)

    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, required=True, choices=(3, 4))
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--niter", type=int, default=None,
                    help="override RUMBA iteration count (config 4)")
    ap.add_argument("--tv-bf16", action="store_true",
                    help="bfloat16 TV stencils (config 4)")
    ap.add_argument("--chain-stream", action="store_true",
                    help="chain RUMBA peaks into deterministic "
                         "tractography (config 4)")
    ap.add_argument("--abort-pace", type=float, default=None,
                    help="abort (exit 3) if the RUMBA iteration pace "
                         "exceeds this many s/iter")
    args = ap.parse_args()

    from fibers_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.config == 3:
        out = bench_dsi(args.small)
    else:
        from fibers_tpu.models.rumba import PaceAbortError
        try:
            out = bench_rumba(args.small, niter=args.niter,
                              tv_bf16=args.tv_bf16,
                              chain_stream=args.chain_stream,
                              abort_pace=args.abort_pace)
        except PaceAbortError as e:
            sys.stderr.write(f"{e}\n")
            sys.exit(3)
    from fibers_tpu.utils.profiling import prof_enabled, prof_summary
    if prof_enabled():
        sys.stderr.write(prof_summary() + "\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
