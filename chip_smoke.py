"""Proof that the system runs on the GPU: the main paths once, at full
width, each checked against the plain reference in tests/oracle.py.

    python chip_smoke.py               # one card
    python chip_smoke.py --devices 4   # the sharded path on four cards

One card, in one process:
  phase 0  the device, and what each matmul precision lowers to;
  phase 1  `python -m fibers_tpu pipeline` on the HCP-scale phantom of
           bench.py (140x140x92, 198 volumes, sphere_642, 1M seeds):
           NIfTI in -> DTI -> GQI -> device peak handoff -> .trk out;
           FA, ODF, first peak and streamlines against the oracle;
  phase 2  RUMBA-SD with TV on the config-4 phantom (270 directions,
           sphere_724 = 364 fODF components) for 25 iterations, and a
           24^3 crop at full width against the oracle iteration.

With --devices 4 only the sharded path runs: `pipeline --mesh 4`
against `pipeline` on one device, `rumba_rec(mesh=...)` against
`rumba_rec` on one device, and the multi-device dry run, all in the
same process on the same data.

Every phase prints its wall and compile seconds and the FIBERS_PROFILE
stage table.  A failed phase or comparison ends the script with a
non-zero exit code.  The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Full-width sizes (bench.py configs 1+2+5, bench_models.py config 4)
BRAIN_SHAPE = (140, 140, 92)
BRAIN_NDIR = 198
N_SEEDS = 1_000_000
RUMBA_NDIR = 270
RUMBA_NB0 = 18
RUMBA_ITERS = 25
RUMBA_CROP = 24
N_CHECK_VOXELS = 2000
N_CHECK_LINES = 200

# Tolerances, each with its reason (printed beside every comparison)
FA_ATOL = 1e-3          # u16 upload wire adds ~1e-4 to FA; f32 solve
FA_RAW_P99 = 1e-3       # FA vs the raw signal, 99th percentile
FA_RAW_MIN_STEPS = 10   # below 10 u16 steps a sample is off by >= 5 %
ODF_RTOL = 1e-3         # u16 wire: <= max/131070 per sample; f32 GEMM
PEAK_AGREE = 0.99       # near-tied ODF vertices may swap under the wire
LINE_AGREE = 0.99       # f32 device vs f64 oracle rounding ties
RUMBA_RTOL, RUMBA_ATOL = 2e-3, 2e-5     # as tests/test_oracle.py


def _say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ #
# Device and precision
# ------------------------------------------------------------------ #

def card_name_and_power_limit() -> str:
    """`name, power.limit` as nvidia-smi reports them (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu():
    """The JAX GPU backend, or SystemExit: there is no CPU fallback."""
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU; JAX found "
                         f"{jax.default_backend()!r}")
    return jax.devices()


def require_checkout():
    """Import the package beside this script, or SystemExit."""
    for p in (HERE, os.path.join(HERE, "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)
    try:
        import fibers_tpu
        import oracle  # noqa: F401  (tests/oracle.py)
    except ImportError as e:
        raise SystemExit(f"chip_smoke: run it from a checkout ({e})")
    pkg = os.path.dirname(os.path.abspath(fibers_tpu.__file__))
    if pkg != os.path.join(HERE, "fibers_tpu"):
        raise SystemExit(f"chip_smoke: imported fibers_tpu from {pkg}, "
                         "not from this checkout")


def dot_lowering(precision, m=1024, k=253, n=364):
    """(relative error vs float64, how the compiled dot was lowered) for
    a float32 matmul at `precision`."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.random((m, k)).astype(np.float32)
    b = (rng.random((k, n)) * 1e-2).astype(np.float32)
    f = jax.jit(lambda x, y: jnp.dot(x, y, precision=precision))
    txt = f.lower(a, b).compile().as_text()
    how = "?"
    for key in ('"precision_config"', "algorithm="):
        i = txt.find(key)
        if i >= 0:
            how = txt[i:i + 110].split("}")[0] + "}"
            break
    for call in ("__cublas$gemm", "__cublas$lt$matmul",
                 "__triton_gemm", "__triton_nested_gemm_fusion"):
        if call in txt:
            how = f"{call} {how}"
            break
    ref = a.astype(np.float64) @ b.astype(np.float64)
    err = float(np.abs(np.asarray(f(a, b)) - ref).max() / np.abs(ref).max())
    return err, how


# ------------------------------------------------------------------ #
# Phase bookkeeping
# ------------------------------------------------------------------ #

class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, from its own
    monitoring events."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self)

    def __call__(self, event, duration, **kwargs):
        if event in self.EVENTS:
            self.seconds += float(duration)


@contextlib.contextmanager
def phase(name: str, clock: CompileClock):
    """Print a phase's wall and compile seconds and its stage table."""
    from fibers_tpu.utils.profiling import prof_reset, prof_summary

    prof_reset()
    c0, t0 = clock.seconds, time.perf_counter()
    _say(f"== {name}")
    yield
    wall = time.perf_counter() - t0
    _say(f"{name}: wall {wall:.3f} s, compile {clock.seconds - c0:.3f} s")
    _say(prof_summary())


def _report(what: str, value, limit, ok: bool, why: str) -> bool:
    _say(f"  {'PASS' if ok else 'FAIL'} {what}: {value} (limit {limit}; "
         f"{why})")
    return ok


# ------------------------------------------------------------------ #
# Comparisons with tests/oracle.py
# ------------------------------------------------------------------ #

def sample_voxels(mask: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """`n` distinct flat indices of masked voxels, drawn from `seed`."""
    idx = np.flatnonzero(mask > 0)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(idx, min(n, len(idx)), replace=False))


def upload_wire(dwi_vol, mask_vol) -> str:
    """The upload wire `pipeline --wire auto` picks: uint16 on an
    accelerator when the masked signal is finite and non-negative,
    float32 otherwise."""
    import jax

    m = dwi_vol[mask_vol > 0]
    if jax.default_backend() == "cpu" or not np.isfinite(m).all() \
            or m.min() < 0:
        return "f32"
    return "u16"


def check_dti(fa_vol, dwi_vol, mask_vol, bval, bvec, vox,
              wire="f32") -> bool:
    """FA at `vox` against the per-voxel pinv oracle.  With wire "u16"
    the oracle fits its own model of that wire's rows (oracle.
    u16_wire_oracle).  Against the raw signal FA is bounded on the
    voxels whose every sample is at least FA_RAW_MIN_STEPS wire steps
    (the others are counted: the wire's rounding is a large share of a
    small sample, and one below half a step arrives as 0, which sends
    the fit down the reference's ragged path) and, over all voxels, at
    the 99th percentile."""
    import oracle

    flat = dwi_vol.reshape(-1, dwi_vol.shape[-1])
    raw = flat[vox].astype(np.float64)

    def fa_err(rows):
        ref = np.array([oracle.dti_fit_voxel_oracle(r, bval, bvec)["fa"]
                        for r in rows])
        return np.abs(np.asarray(fa_vol).reshape(-1)[vox] - ref)

    e_raw = fa_err(raw)
    why = "matmul precision HIGHEST; f32 solve"
    if wire == "f32":
        err = float(e_raw.max())
        return _report(f"DTI FA max abs error on {len(vox)} voxels "
                       "(float32 wire)", f"{err:.3e}", FA_ATOL,
                       err <= FA_ATOL, why)
    vmax = float(dwi_vol[mask_vol > 0].max())
    wired = oracle.u16_wire_oracle(raw, vmax)
    err = float(fa_err(wired).max())
    ok = _report(f"DTI FA max abs error on {len(vox)} voxels, oracle on "
                 "its own u16 wire model", f"{err:.3e}", FA_ATOL,
                 err <= FA_ATOL, why)
    small = raw.min(axis=1) < FA_RAW_MIN_STEPS * vmax / 65535.0
    err = float(e_raw[~small].max()) if (~small).any() else 0.0
    ok = _report(f"DTI FA max abs error vs the raw signal on the "
                 f"{int((~small).sum())} voxels with every sample >= "
                 f"{FA_RAW_MIN_STEPS} wire steps ({int(small.sum())} "
                 "excluded)", f"{err:.3e}", FA_ATOL, err <= FA_ATOL,
                 why + "; u16 wire ~1e-4") and ok
    p99 = float(np.percentile(e_raw, 99))
    return _report(f"DTI FA vs the raw signal on all {len(vox)} voxels, "
                   f"99th percentile (max {e_raw.max():.3e})",
                   f"{p99:.3e}", FA_RAW_P99, p99 <= FA_RAW_P99,
                   why + "; u16 wire, sub-step samples included") and ok


def check_gqi(odf_vol, peak1_vol, dwi_vol, bval, bvec, sphere,
              vox) -> bool:
    """ODF relative error and first-peak agreement at `vox` against the
    per-voxel GQI oracle."""
    import oracle

    flat = dwi_vol.reshape(-1, dwi_vol.shape[-1])
    sub = flat[vox][:, None, None, :]
    odf_ref, peak_ref, _ = oracle.gqi_oracle(
        sub, np.ones(sub.shape[:3]), bval, bvec,
        np.asarray(sphere.vertices), np.asarray(sphere.faces))
    odf_ref = odf_ref[:, 0, 0]
    p_ref = peak_ref[0][:, 0, 0]
    odf = np.asarray(odf_vol).reshape(-1, odf_ref.shape[1])[vox]
    p1 = np.asarray(peak1_vol).reshape(-1, 3)[vox]
    rel = np.abs(odf - odf_ref).max(axis=1) / np.maximum(
        np.abs(odf_ref).max(axis=1), 1e-30)
    err = float(rel.max())
    agree = float((np.abs((p1 * p_ref).sum(axis=1)) > 0.999).mean())
    ok = _report(f"GQI ODF max relative error on {len(vox)} voxels",
                 f"{err:.3e}", ODF_RTOL, err <= ODF_RTOL,
                 "matmul precision HIGHEST; the u16 upload wire")
    return _report("GQI first-peak agreement", f"{agree:.4f}",
                   f">= {PEAK_AGREE}", agree >= PEAK_AGREE,
                   "same vertex; near-tied vertices may swap") and ok


def check_stream(ovec, f, fa, mask, seed, wire="auto", nsub=3,
                 len_min=3) -> bool:
    """Streamlines from the seeds of `seed` against the per-line oracle
    over the same gated orientation field, within the point wire's
    bound at every point."""
    import jax

    import fibers_tpu as ft
    import oracle
    from fibers_tpu.tract.stream import StreamWork, _wire_mode

    kw = dict(f=f, fa=fa, mask=mask, f_thresh=0.0, nsub=nsub,
              len_min=len_min, wire=wire)
    tract = ft.stream(ovec, seed=seed, **kw)
    work = StreamWork(ovec, **kw)
    mode, _emit, qscale, _dmax = _wire_mode(work.cfg, work.step_size)
    bound = 1e-4 if mode == "f32" else 2.0 / qscale + 1e-4

    subs = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (nsub, 3), minval=-0.5 + 1e-6,
        maxval=0.5 - 1e-6), np.float32)
    svol = np.asarray(seed.vol)
    svol = svol if svol.ndim == 3 else svol[..., 0]
    cos = float(np.cos(np.radians(work.ang_thresh)))
    ref = []
    for sv in np.argwhere(svol > 0):
        for sub in subs:
            line = oracle.stream_line_oracle(
                sv, sub, work.ovec_arr, work.mask_array,
                step_size=work.step_size, cosang_thresh=cos,
                smooth_coeff=work.smooth_coeff, len_max=work.len_max)
            if len(line) >= len_min:
                ref.append(line)
    ok = _report("streamline count", tract.n_count, len(ref),
                 tract.n_count == len(ref), "same seeds, same field")
    if not ok:
        return False
    good, worst = 0, 0.0
    for i, r in enumerate(ref):
        g = np.asarray(tract.xyz[i]).T
        if g.shape == r.shape:
            e = float(np.abs(g - r).max()) if len(r) else 0.0
            worst = max(worst, e)
            good += e <= bound
    frac = good / max(len(ref), 1)
    return _report(
        f"streamlines within {bound:.4f} voxel at every point "
        f"(wire {mode})", f"{good}/{len(ref)} (worst {worst:.2e})",
        f">= {LINE_AGREE}", frac >= LINE_AGREE,
        "quantised point wire bound, no drift; f32 propagation vs "
        "f64 oracle")


def rumba_crop_inputs(dwi_vol, bval, bvec, crop: int):
    """Signal, kernel and initial state of a `crop`^3 centre block, as
    rumba_rec builds them (reference: src/rusd.jl:450-537)."""
    import fibers_tpu as ft
    from fibers_tpu.models.rumba import _build_kernel

    c = [s // 2 - crop // 2 for s in dwi_vol.shape[:3]]
    block = dwi_vol[c[0]:c[0] + crop, c[1]:c[1] + crop, c[2]:c[2] + crop]
    kernel, ib0 = _build_kernel(bval, bvec, ft.sphere_724, 1.7e-3,
                                0.2e-3, 3.0e-3, 0.8e-4)
    rows = block.reshape(-1, block.shape[-1]).astype(np.float64)
    b0 = np.maximum(rows[:, ib0], 0).mean(axis=1)
    dwis = np.maximum(rows[:, ~ib0], 0) / np.maximum(b0, 1e-30)[:, None]
    dwis = np.where(b0[:, None] > 0, dwis, 0.0)
    signal = np.minimum(np.concatenate(
        [(b0 > 0)[:, None].astype(np.float64), dwis], axis=1), 1.0)
    n, ncomp = len(rows), kernel.shape[1]
    fodf = np.full((n, ncomp), 1.0 / ncomp)
    dodf = fodf @ kernel.T.astype(np.float64)
    sig2 = np.full((n, 1), (1.0 / 15) ** 2)
    return dict(signal=signal, kernel=kernel, fodf=fodf, dodf=dodf,
                sig2=sig2, dodf_sig=signal * dodf / sig2,
                lam=(1.0 / 15) ** 2, shape3=(crop,) * 3)


def check_rumba_crop(inp, niter, precisions) -> bool:
    """`niter` device iterations (one _rumba_block) against the float64
    oracle iteration, at each precision in `precisions`: {name:
    required}."""
    import jax.numpy as jnp

    import oracle
    from fibers_tpu.models.rumba import _rumba_block

    shape3 = inp["shape3"]
    nxyz = int(np.prod(shape3))
    idx = np.arange(nxyz)
    o = (inp["fodf"], inp["dodf"], inp["dodf_sig"], inp["sig2"],
         np.full(shape3, inp["lam"]))
    for _ in range(niter):
        o = oracle.rumba_iterate_oracle(*o, inp["signal"],
                                        inp["kernel"].astype(np.float64),
                                        idx, shape3)
    ok = True
    for prec, required in precisions.items():
        st = _rumba_block(
            jnp.asarray(inp["fodf"], jnp.float32),
            jnp.asarray(inp["dodf"], jnp.float32),
            jnp.asarray(inp["dodf_sig"], jnp.float32),
            jnp.asarray(inp["sig2"], jnp.float32),
            jnp.full((nxyz,), inp["lam"], jnp.float32),
            jnp.asarray(inp["signal"], jnp.float32),
            jnp.asarray(inp["kernel"]), jnp.asarray(idx, jnp.int32),
            k=niter, n_order=1, ipat_factor=1, use_tv=True,
            shape3=shape3, nxyz=nxyz, precision=prec)
        got = np.asarray(st[0], np.float64)
        ratio = float((np.abs(got - o[0])
                       / (RUMBA_ATOL + RUMBA_RTOL * np.abs(o[0]))).max())
        good = ratio <= 1.0
        _report(f"RUMBA {niter} iterations on a {shape3[0]}^3 crop x "
                f"{inp['kernel'].shape[1]} components, precision "
                f"{prec!r}{'' if required else ' (informational)'}",
                f"max |err|/(atol+rtol|ref|) = {ratio:.3f}", 1.0, good,
                f"rtol {RUMBA_RTOL}, atol {RUMBA_ATOL} as "
                "tests/test_oracle.py; oracle in float64")
        ok = ok and (good or not required)
    return ok


# ------------------------------------------------------------------ #
# Phases
# ------------------------------------------------------------------ #

def seed_volume(mask_mri, n_seeds: int, nsub: int = 3):
    """bench.py's seed set: n_seeds // nsub voxels spread evenly over
    the mask."""
    import fibers_tpu as ft

    seed = ft.MRI.like(mask_mri, 1, np.float32)
    idx = np.flatnonzero(mask_mri.vol > 0)
    nvox = max(1, min(n_seeds // nsub, len(idx)))
    pick = idx[np.linspace(0, len(idx) - 1, nvox, dtype=np.int64)]
    sv = np.zeros(mask_mri.vol.size, np.float32)
    sv[pick] = 1
    seed.vol = sv.reshape(mask_mri.vol.shape)
    return seed


def write_inputs(workdir, dwi, mask, seed):
    """Uncompressed NIfTI inputs plus b-tables, as a user hands them
    over."""
    import fibers_tpu as ft

    paths = [os.path.join(workdir, f) for f in
             ("dwi.nii", "mask.nii", "seed.nii")]
    for m, p in zip((dwi, mask, seed), paths):
        ft.mri_write(m, p)
    return paths


def run_cli(argv) -> str:
    """`python -m fibers_tpu <argv>` in this process; its stdout."""
    from fibers_tpu.__main__ import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"fibers_tpu {argv[0]} returned {rc}")
    _say("  cli: " + buf.getvalue().strip().replace("\n", "\n  cli: "))
    return buf.getvalue()


def pipeline_phase(dwi, mask, workdir, sphere, n_seeds=N_SEEDS,
                   n_check=N_CHECK_VOXELS, n_lines=N_CHECK_LINES) -> bool:
    """The e2e CLI pipeline from files, then its outputs against the
    oracle."""
    import fibers_tpu as ft

    seed = seed_volume(mask, n_seeds)
    dwi_p, mask_p, seed_p = write_inputs(workdir, dwi, mask, seed)
    out = os.path.join(workdir, "out")
    sph = {321: "642", 181: "362", 362: "724"}[sphere.nvert_half]
    t0 = time.perf_counter()
    run_cli(["pipeline", dwi_p, mask_p, out, "--sphere", sph,
             "--seed", seed_p])
    _say(f"  pipeline CLI: {time.perf_counter() - t0:.3f} s")

    vol = np.asarray(dwi.vol)
    bval = np.asarray(dwi.bval)
    bvec = np.asarray(dwi.bvec)
    vox = sample_voxels(mask.vol, n_check)
    base = os.path.join(out, "")
    fa = ft.mri_read(base + "dti_fa.nii.gz")
    ok = check_dti(fa.vol, vol, mask.vol, bval, bvec, vox,
                   upload_wire(vol, mask.vol))
    peaks = [ft.mri_read(base + f"gqi_peak{i}.nii.gz") for i in (1, 2, 3)]
    qas = [ft.mri_read(base + f"gqi_qa{i}.nii.gz") for i in (1, 2, 3)]
    odf = ft.mri_read(base + "gqi_odf.nii.gz")
    ok = check_gqi(odf.vol, peaks[0].vol, vol, bval, bvec, sphere,
                   vox) and ok
    del odf

    # streamlines: the engine over the pipeline's own peak files, from
    # n_lines/3 of the pipeline's seed voxels
    few = ft.MRI.like(mask, 1, np.float32)
    sidx = np.flatnonzero(seed.vol > 0)
    pick = sidx[np.linspace(0, len(sidx) - 1, max(1, n_lines // 3),
                            dtype=np.int64)]
    sv = np.zeros(seed.vol.size, np.float32)
    sv[pick] = 1
    few.vol = sv.reshape(seed.vol.shape)
    return check_stream(peaks, qas, fa, mask, few) and ok


def rumba_phase(dwi, mask, niter=RUMBA_ITERS, crop=RUMBA_CROP) -> bool:
    """rumba_rec with TV at full width, then a crop against the
    oracle."""
    import fibers_tpu as ft
    from fibers_tpu.models.rumba import DEFAULT_PRECISION

    t0 = time.perf_counter()
    rec = ft.rumba_rec(dwi, mask, ft.sphere_724, niter=niter)
    gfa = np.asarray(rec.gfa.vol)
    _say(f"  rumba_rec {niter} iterations: "
         f"{time.perf_counter() - t0:.3f} s, snr_mean {rec.snr_mean:.3f}")
    finite = bool(np.isfinite(gfa).all() and np.isfinite(rec.snr_mean))
    ok = _report("RUMBA GFA and SNR finite", finite, True, finite,
                 "no NaN or inf anywhere in the volume")
    inp = rumba_crop_inputs(np.asarray(dwi.vol), np.asarray(dwi.bval),
                            np.asarray(dwi.bvec), crop)
    precisions = {"high": False, "highest": True}
    precisions[DEFAULT_PRECISION] = True
    return check_rumba_crop(inp, niter, precisions) and ok


def _vox_rows(path, vox):
    """Rows `vox` of a volume file, as float64 [len(vox), nframes]."""
    import fibers_tpu as ft

    v = np.asarray(ft.mri_read(path).vol)
    v = v.reshape(-1, v.shape[3] if v.ndim > 3 else 1)
    return v[vox].astype(np.float64)


def sharded_phase(dwi, mask, workdir, sphere, ndev, n_seeds=N_SEEDS,
                  n_check=N_CHECK_VOXELS, niter=RUMBA_ITERS) -> bool:
    """`pipeline --mesh N` against `pipeline` on one device,
    rumba_rec(mesh=...) against rumba_rec on one device, and the dry
    run, all on the same data in this process."""
    import jax

    import __graft_entry__
    import fibers_tpu as ft
    from fibers_tpu.parallel.mesh import make_mesh

    seed = seed_volume(mask, n_seeds)
    dwi_p, mask_p, seed_p = write_inputs(workdir, dwi, mask, seed)
    sph = {321: "642", 181: "362", 362: "724"}[sphere.nvert_half]
    runs = {}
    for name, extra in (("mesh", ["--mesh", str(ndev)]), ("one", [])):
        out = os.path.join(workdir, f"out_{name}")
        t0 = time.perf_counter()
        txt = run_cli(["pipeline", dwi_p, mask_p, out, "--sphere", sph,
                       "--seed", seed_p] + extra)
        _say(f"  pipeline CLI {' '.join(extra) or '(one device)'}: "
             f"{time.perf_counter() - t0:.3f} s")
        runs[name] = (os.path.join(out, ""),
                      int(txt.rsplit("(", 1)[1].split()[0]))
        if name == "mesh":
            for d in jax.devices()[:ndev]:
                stats = d.memory_stats() or {}
                _say(f"  {d}: peak bytes in use "
                     f"{stats.get('peak_bytes_in_use')}")
    (base_m, n_m), (base_1, n_1) = runs["mesh"], runs["one"]
    vox = sample_voxels(mask.vol, n_check)
    fa_m = _vox_rows(base_m + "dti_fa.nii.gz", vox)
    fa_1 = _vox_rows(base_1 + "dti_fa.nii.gz", vox)
    err = float(np.abs(fa_m - fa_1).max())
    ok = _report(f"FA, {ndev} devices vs 1", f"{err:.3e}", FA_ATOL,
                 err <= FA_ATOL, "same wire; reduction order differs")
    odf_m = _vox_rows(base_m + "gqi_odf.nii.gz", vox)
    odf_1 = _vox_rows(base_1 + "gqi_odf.nii.gz", vox)
    rel = float((np.abs(odf_m - odf_1).max(axis=1) / np.maximum(
        np.abs(odf_1).max(axis=1), 1e-30)).max())
    ok = _report(f"ODF, {ndev} devices vs 1", f"{rel:.3e}", ODF_RTOL,
                 rel <= ODF_RTOL, "same wire; HIGHEST GEMM") and ok
    ok = _report(f"streamline count, `pipeline --mesh {ndev}` vs "
                 "`pipeline`", f"{n_m} vs {n_1}", "equal", n_m == n_1,
                 "same seeds, same files, same CLI") and ok
    del odf_m, odf_1

    t0 = time.perf_counter()
    r_m = ft.rumba_rec(dwi, mask, ft.sphere_724, niter=niter,
                       mesh=make_mesh(ndev))
    f_m = np.asarray(r_m.fodf.vol)
    f_m = f_m.reshape(-1, f_m.shape[-1])[vox]
    _say(f"  rumba_rec mesh {ndev}: {time.perf_counter() - t0:.3f} s")
    del r_m
    r_1 = ft.rumba_rec(dwi, mask, ft.sphere_724, niter=niter)
    f_1 = np.asarray(r_1.fodf.vol)
    f_1 = f_1.reshape(-1, f_1.shape[-1])[vox]
    ratio = float((np.abs(f_m - f_1)
                   / (RUMBA_ATOL + RUMBA_RTOL * np.abs(f_1))).max())
    ok = _report(f"RUMBA fODF, {ndev} devices vs 1",
                 f"max |err|/(atol+rtol|ref|) = {ratio:.3f}", 1.0,
                 ratio <= 1.0, f"rtol {RUMBA_RTOL}, atol {RUMBA_ATOL}; "
                 "reduction order differs") and ok

    __graft_entry__.dryrun_multichip(ndev)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path on four cards")
    args = ap.parse_args(argv)

    os.environ["FIBERS_PROFILE"] = "1"
    require_checkout()
    devices = require_gpu()
    if len(devices) < args.devices:
        raise SystemExit(f"chip_smoke: --devices {args.devices} needs "
                         f"{args.devices} cards, JAX has {len(devices)}")
    import jax

    from fibers_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    clock = CompileClock()
    dev = devices[0]
    _say(card_name_and_power_limit())
    _say(f"device_kind {dev.device_kind}, {len(devices)} device(s), "
         f"jax {jax.__version__}, compile cache {cache}")
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        err, how = dot_lowering(getattr(jax.lax.Precision, name))
        _say(f"  float32 dot at Precision.{name}: relative error "
             f"{err:.2e}; lowered to {how}")

    import bench
    import fibers_tpu as ft

    ok = True
    with tempfile.TemporaryDirectory() as workdir:
        dwi, mask, _ = bench.make_brain(shape=BRAIN_SHAPE,
                                        ndir=BRAIN_NDIR)
        if args.devices == 4:
            with phase("phase 4x: sharded pipeline, RUMBA-SD, dry run",
                       clock):
                ok = sharded_phase(dwi, mask, workdir, ft.sphere_642, 4)
        else:
            with phase("phase 1: pipeline CLI (DTI + GQI + 1M-seed "
                       "tractography)", clock):
                ok = pipeline_phase(dwi, mask, workdir, ft.sphere_642)
            del dwi, mask
            sys.path.insert(0, os.path.join(HERE, "benchmarks"))
            from bench_models import rumba_phantom

            rdwi, rmask, _, _ = rumba_phantom(
                BRAIN_SHAPE, RUMBA_NDIR, RUMBA_NB0,
                np.random.default_rng(0), cache=False)
            with phase(f"phase 2: RUMBA-SD, TV, {RUMBA_ITERS} iterations",
                       clock):
                ok = rumba_phase(rdwi, rmask) and ok
    if not ok:
        _say("chip_smoke: a comparison failed")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
