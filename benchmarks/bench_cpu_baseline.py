"""CPU comparison for the DTI+GQI fits (BASELINE.md).

No Julia runtime is available, so the comparison comes from two CPU
measurements of the same DTI+GQI workload the GPU e2e runs
(140x140x92, 198 directions, ~715k masked voxels):

1. XLA-CPU batched kernels — the same jitted fits on the host CPU
   (the per-core rate is the scalable quantity, since both XLA-CPU and
   the reference's `julia --threads auto` scale ~linearly over the
   embarrassingly-parallel voxel axis).
2. The NumPy per-voxel oracle (tests/oracle.py) — a faithful stand-in
   for the reference's per-voxel Julia loops, timed on a sample and
   extrapolated.

Prints one JSON line with voxel-fits/s for each; divide the GPU rate
(PERF.md) by these for the speed-up.

  JAX_PLATFORMS=cpu python benchmarks/bench_cpu_baseline.py [--small]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# run as a script from a checkout: the package sits beside this directory
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    import jax

    assert jax.default_backend() == "cpu", "run with JAX_PLATFORMS=cpu"
    import jax.numpy as jnp

    import fibers_tpu as ft
    from fibers_tpu.models.dti import _design_dti, _dti_kernel
    from fibers_tpu.models.gqi import gqi_design

    shape = (48, 48, 32) if args.small else (140, 140, 92)
    ndir = 34 if args.small else 198

    tests = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    # synthetic scan with the e2e bench's geometry
    sys.path.insert(0, __file__.rsplit("/", 2)[0])
    from bench import make_brain

    dwi, mask, _ = make_brain(shape=shape, ndir=ndir)
    m = mask.vol > 0
    idx = np.flatnonzero(m)
    nmask = len(idx)
    flat = np.asarray(dwi.vol).reshape(-1, ndir)
    signals = jnp.asarray(flat[idx])

    bval = np.asarray(dwi.bval, np.float32)
    bvec = np.asarray(dwi.bvec, np.float32)
    A_dti = jnp.asarray(_design_dti(bval, bvec))
    ib0 = jnp.asarray((bval == bval.min()).astype(np.float32))
    A_gqi = jnp.asarray(gqi_design(bval, bvec, ft.sphere_642))

    @jax.jit
    def both(s, A_dti, ib0, A_gqi):
        packed = _dti_kernel.__wrapped__(s, A_dti, ib0)
        odf = jnp.dot(jnp.maximum(s, 0.0), A_gqi.T)
        return packed.sum() + odf.sum()

    float(both(signals, A_dti, ib0, A_gqi))      # compile
    t0 = time.perf_counter()
    float(both(signals, A_dti, ib0, A_gqi))
    t_xla = time.perf_counter() - t0
    xla_rate = 2 * nmask / t_xla                 # 2 fits per voxel

    # per-voxel oracle (the reference's loop shape), sampled
    from oracle import dti_fit_voxel_oracle, gqi_system_matrix

    nsample = 300 if args.small else 1000
    sample = flat[idx[:: max(1, nmask // nsample)]][:nsample]
    t0 = time.perf_counter()
    for row in sample:
        dti_fit_voxel_oracle(row, bval, bvec)
    t_dti = time.perf_counter() - t0

    Ag = gqi_system_matrix(bval, bvec,
                           ft.sphere_642.vertices[:ft.sphere_642.nvert_half])
    t0 = time.perf_counter()
    for row in sample:
        Ag @ np.maximum(row, 0)
    t_gqi = time.perf_counter() - t0
    oracle_rate = 2 * nsample / (t_dti + t_gqi)

    ncpu = 1
    try:
        ncpu = len(__import__("os").sched_getaffinity(0))
    except Exception:
        pass

    sys.stderr.write(
        f"{nmask} voxels: XLA-CPU {t_xla:.1f}s ({xla_rate:.0f} fits/s), "
        f"oracle {oracle_rate:.0f} fits/s (sampled {nsample}), "
        f"{ncpu} core(s)\n")
    print(json.dumps({
        "metric": "cpu_baseline_dti_gqi",
        "value": round(xla_rate),
        "unit": "voxel_fits_per_sec",
        "xla_cpu_fits_per_sec": round(xla_rate),
        "oracle_fits_per_sec": round(oracle_rate),
        "n_cores": ncpu,
        "nmask": nmask,
    }))


if __name__ == "__main__":
    main()
