"""Command-line pipeline runner: `python -m fibers_tpu <command> ...`.

The reference is library-only; this CLI wraps the same public surface
(mri_read/info/disp, the model fits + their field-per-file writers, and
the tractography engine) so a whole reconstruction can be driven from
the shell on a GPU host — the deployment shape batch pipelines want.
Option names/defaults mirror the library kwargs, which mirror the
reference's (SURVEY.md §5.6).

    python -m fibers_tpu info dwi.nii.gz
    python -m fibers_tpu dti dwi.nii.gz mask.nii.gz out/dti
    python -m fibers_tpu gqi dwi.nii.gz mask.nii.gz out/gqi --sphere 362
    python -m fibers_tpu rumba dwi.nii.gz mask.nii.gz out/rumba \
        --niter 600 --checkpoint out/rumba.ckpt.npz --checkpoint-every 100
    python -m fibers_tpu stream out/gqi GQI --fa out/dti_fa.nii.gz \
        --mask mask.nii.gz -o out/tracts.trk
    python -m fibers_tpu pipeline dwi.nii.gz mask.nii.gz out/
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _sphere(name: str):
    import fibers_tpu as ft

    try:
        return {"362": ft.sphere_362, "642": ft.sphere_642,
                "724": ft.sphere_724}[str(name)]
    except KeyError:
        raise SystemExit(f"unknown sphere {name!r} (choose 362/642/724)")


def _mesh(n):
    if not n:
        return None
    from .parallel.mesh import make_mesh

    return make_mesh(int(n))


def _read_pair(dwi_path: str, mask_path: str):
    import fibers_tpu as ft

    dwi = ft.mri_read(dwi_path)
    mask = ft.mri_read(mask_path)
    return dwi, mask


def _batch(dwi, mask, mesh, wire):
    """Shared gather/upload for fits that take `batch=`."""
    from .core.batch import prepare_batch

    return prepare_batch(dwi, mask, mesh=mesh, wire=wire)


def _outdir(base: str) -> None:
    d = os.path.dirname(base)
    if d:
        os.makedirs(d, exist_ok=True)


def cmd_info(args) -> int:
    import fibers_tpu as ft

    ft.info(ft.mri_read(args.vol, headeronly=args.headeronly))
    return 0


def cmd_disp(args) -> int:
    import fibers_tpu as ft

    mri = ft.mri_read(args.vol)
    mod = ft.mri_read(args.mod) if args.mod else None
    ft.disp(mri, mod)
    return 0


def cmd_adc(args) -> int:
    import fibers_tpu as ft

    dwi, mask = _read_pair(args.dwi, args.mask)
    batch = _batch(dwi, mask, _mesh(args.mesh), args.wire)
    adc, s0 = ft.adc_fit(dwi, mask, batch=batch)
    _outdir(args.outbase)
    ft.mri_write(adc, args.outbase + "_adc.nii.gz")
    ft.mri_write(s0, args.outbase + "_s0.nii.gz")
    print(f"wrote {args.outbase}_adc.nii.gz, {args.outbase}_s0.nii.gz")
    return 0


def cmd_dti(args) -> int:
    import fibers_tpu as ft

    dwi, mask = _read_pair(args.dwi, args.mask)
    batch = _batch(dwi, mask, _mesh(args.mesh), args.wire)
    dti = ft.dti_fit(dwi, mask, batch=batch)
    _outdir(args.outbase)
    ft.dti_write(dti, args.outbase)
    print(f"wrote {args.outbase}_*.nii.gz (DTI)")
    return 0


def cmd_gqi(args) -> int:
    import fibers_tpu as ft

    dwi, mask = _read_pair(args.dwi, args.mask)
    batch = _batch(dwi, mask, _mesh(args.mesh), args.wire)
    gqi = ft.gqi_rec(dwi, mask, _sphere(args.sphere), sigma=args.sigma,
                     batch=batch)
    _outdir(args.outbase)
    ft.gqi_write(gqi, args.outbase)
    print(f"wrote {args.outbase}_*.nii.gz (GQI)")
    return 0


def cmd_dsi(args) -> int:
    import fibers_tpu as ft

    dwi, mask = _read_pair(args.dwi, args.mask)
    dsi = ft.dsi_rec(dwi, mask, _sphere(args.sphere),
                     hann_width=args.hann_width, mesh=_mesh(args.mesh),
                     wire=args.wire)
    _outdir(args.outbase)
    ft.dsi_write(dsi, args.outbase)
    print(f"wrote {args.outbase}_*.nii.gz (DSI)")
    return 0


def cmd_rumba(args) -> int:
    import fibers_tpu as ft

    dwi, mask = _read_pair(args.dwi, args.mask)
    rec = ft.rumba_rec(
        dwi, mask, _sphere(args.sphere), niter=args.niter,
        use_tv=not args.no_tv, verbose=args.verbose,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        on_mismatch=args.on_mismatch, signal_wire=args.wire,
        mesh=_mesh(args.mesh))
    _outdir(args.outbase)
    ft.rumba_write(rec, args.outbase)
    print(f"wrote {args.outbase}_*.nii.gz (RUMBA-SD, snr_mean="
          f"{rec.snr_mean:.1f})")
    return 0


def cmd_structens(args) -> int:
    import fibers_tpu as ft

    mri = ft.mri_read(args.vol)
    evec, evals = ft.st_recon(np.asarray(mri.vol), args.sigma, args.rho,
                              mesh=_mesh(args.mesh))
    _outdir(args.outbase)
    ev = ft.MRI.like(mri, 9, np.float32)
    ev.vol = evec.reshape(evec.shape[:3] + (9,)).astype(np.float32)
    el = ft.MRI.like(mri, 3, np.float32)
    el.vol = evals.astype(np.float32)
    ft.mri_write(ev, args.outbase + "_eigvec.nii.gz")
    ft.mri_write(el, args.outbase + "_eigval.nii.gz")
    print(f"wrote {args.outbase}_eigvec.nii.gz, {args.outbase}"
          "_eigval.nii.gz")
    return 0


_STRUCTS = {"GQI": "GQI", "DSI": "DSI", "RUMBASD": "RUMBASD"}


def cmd_stream(args) -> int:
    import fibers_tpu as ft

    if args.struct:
        # peaks from a fit's field-per-file output: mri_read(base, Type)
        typ = getattr(ft, _STRUCTS.get(args.struct.upper(), ""), None)
        if typ is None:
            raise SystemExit(f"unknown result struct {args.struct!r} "
                             "(choose GQI/DSI/RUMBASD)")
        rec = ft.mri_read(args.peaks, typ)
        ovec, f = ft.peaks_to_ovecs(rec)
    else:
        ovec = [ft.mri_read(p) for p in args.peaks.split(",")]
        f = [ft.mri_read(p) for p in args.f.split(",")] if args.f else None

    kw = {}
    if f is not None:
        kw["f"] = f
    if args.fa:
        kw["fa"] = ft.mri_read(args.fa)
    if args.mask:
        kw["mask"] = ft.mri_read(args.mask)
    if args.seed:
        kw["seed"] = ft.mri_read(args.seed)
    if args.lcm:
        kw["lcms"] = ft.mri_read(args.lcm)

    _outdir(args.output)
    tract = ft.stream(
        ovec, f_thresh=args.f_thresh, fa_thresh=args.fa_thresh,
        nsub=args.nsub, len_min=args.len_min,
        ang_thresh=args.ang_thresh, step_size=args.step_size,
        smooth_coeff=args.smooth_coeff, wire=args.wire,
        seed_rng=args.seed_rng, mesh=_mesh(args.mesh),
        trk_sink=args.output, **kw)
    print(f"wrote {args.output} ({tract.n_count} streamlines)")
    return 0


def cmd_pipeline(args) -> int:
    """DTI + GQI fits sharing one upload, then whole-brain deterministic
    tractography — the bench.py end-to-end flow as a shell command."""
    import fibers_tpu as ft

    dwi, mask = _read_pair(args.dwi, args.mask)
    seed = ft.mri_read(args.seed) if args.seed else None
    os.makedirs(args.outdir, exist_ok=True)
    base = os.path.join(args.outdir, "")
    mesh = _mesh(args.mesh)
    batch = _batch(dwi, mask, mesh, args.wire)

    dti = ft.dti_fit(dwi, mask, batch=batch)
    ft.dti_write(dti, base + "dti")
    gqi = ft.gqi_rec(dwi, mask, _sphere(args.sphere), batch=batch)
    ft.gqi_write(gqi, base + "gqi")

    out = os.path.join(args.outdir, "tracts.trk")
    try:
        # zero-fetch handoff: the GQI peak batch stays on device
        ov = ft.peaks_to_ovecs(gqi, device=True)
        tract = ft.stream(ov, fa=dti.fa, mask=mask, seed=seed,
                          f_thresh=0.0, nsub=args.nsub, mesh=mesh,
                          trk_sink=out)
    except ValueError:
        ovec, f = ft.peaks_to_ovecs(gqi)
        tract = ft.stream(ovec, f=f, fa=dti.fa, mask=mask, seed=seed,
                          nsub=args.nsub, mesh=mesh, trk_sink=out)
    print(f"pipeline done: {args.outdir} ({tract.n_count} streamlines)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m fibers_tpu",
        description="diffusion-MRI pipeline in JAX (Fibers.jl rebuild)")
    sub = ap.add_subparsers(dest="command", required=True)

    def add(name, fn, help):
        p = sub.add_parser(name, help=help)
        p.set_defaults(fn=fn)
        return p

    p = add("info", cmd_info, "print a volume's header summary")
    p.add_argument("vol")
    p.add_argument("--full", dest="headeronly", action="store_false",
                   help="read the full payload, not just the header")

    p = add("disp", cmd_disp, "render the middle slice in the terminal")
    p.add_argument("vol")
    p.add_argument("--mod", help="intensity-modulation volume")

    def fit_parser(name, fn, help, wire_default="auto"):
        p = add(name, fn, help)
        p.add_argument("dwi")
        p.add_argument("mask")
        p.add_argument("outbase")
        p.add_argument("--mesh", type=int, default=0,
                       help="shard over N devices (0 = single device)")
        p.add_argument("--wire", default=wire_default,
                       help="host->device signal encoding "
                            "(auto/u16/u12/u8/f32)")
        return p

    fit_parser("adc", cmd_adc, "ADC log-linear fit")
    fit_parser("dti", cmd_dti, "DTI tensor fit + FA/MD/RD maps")

    p = fit_parser("gqi", cmd_gqi, "GQI ODF reconstruction + peaks")
    p.add_argument("--sphere", default="362")
    p.add_argument("--sigma", type=float, default=1.25)

    p = fit_parser("dsi", cmd_dsi, "DSI q-space reconstruction",
                   wire_default="auto8")
    p.add_argument("--sphere", default="642")
    p.add_argument("--hann-width", type=int, default=32)

    p = fit_parser("rumba", cmd_rumba, "RUMBA-SD spherical deconvolution",
                   wire_default="u12")
    p.add_argument("--sphere", default="724")
    p.add_argument("--niter", type=int, default=600)
    p.add_argument("--no-tv", action="store_true",
                   help="disable TV spatial regularization")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for resumable fits")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--on-mismatch", default="raise",
                   choices=("raise", "fresh"))

    p = add("structens", cmd_structens, "structure-tensor reconstruction")
    p.add_argument("vol")
    p.add_argument("outbase")
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--rho", type=float, default=2.0)
    p.add_argument("--mesh", type=int, default=0)

    p = add("stream", cmd_stream, "streamline tractography -> .trk")
    p.add_argument("peaks",
                   help="result-struct basename (with a struct type as "
                        "the 2nd positional) or comma-separated "
                        "orientation volumes")
    p.add_argument("struct", nargs="?", default=None,
                   help="GQI/DSI/RUMBASD: read peaks via "
                        "mri_read(base, Type)")
    p.add_argument("-o", "--output", required=True, help=".trk path")
    p.add_argument("--f", help="comma-separated amplitude volumes")
    p.add_argument("--fa", help="FA volume for fa_thresh masking")
    p.add_argument("--mask")
    p.add_argument("--seed")
    p.add_argument("--lcm", help="LCM volume (probabilistic mode)")
    p.add_argument("--f-thresh", type=float, default=0.03)
    p.add_argument("--fa-thresh", type=float, default=0.1)
    p.add_argument("--nsub", type=int, default=3)
    p.add_argument("--len-min", type=int, default=3)
    p.add_argument("--ang-thresh", type=float, default=45.0)
    p.add_argument("--step-size", type=float, default=0.5)
    p.add_argument("--smooth-coeff", type=float, default=0.2)
    p.add_argument("--seed-rng", type=int, default=0)
    p.add_argument("--wire", default="auto",
                   help="point wire encoding (auto/i8/i6/f32)")
    p.add_argument("--mesh", type=int, default=0)

    p = add("pipeline", cmd_pipeline,
            "DTI+GQI fits + whole-brain tractography (the e2e flow)")
    p.add_argument("dwi")
    p.add_argument("mask")
    p.add_argument("outdir")
    p.add_argument("--sphere", default="362")
    p.add_argument("--seed", help="seed-mask volume (default: the mask)")
    p.add_argument("--nsub", type=int, default=3)
    p.add_argument("--mesh", type=int, default=0)
    p.add_argument("--wire", default="auto")

    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
