"""chip_smoke.py: its guards on a machine without a GPU, and its phases
and oracle comparisons at toy scale on the CPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run_script(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert "needs a GPU" in str(e.value.code)


def test_script_exits_nonzero_without_gpu():
    res = _run_script(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs a GPU" in res.stderr


def test_script_alone_exits_nonzero(tmp_path):
    """Copied out of the checkout, the script finds no package and
    prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert res.returncode != 0
    assert res.stdout == ""


def test_seed_volume_matches_bench_seed_set():
    import fibers_tpu as ft

    mask = ft.MRI(vol=np.zeros((10, 10, 10), np.float32))
    mask.vol[2:8, 2:8, 2:8] = 1
    seed = chip_smoke.seed_volume(mask, 90)
    assert int((seed.vol > 0).sum()) == 30
    assert ((seed.vol > 0) <= (mask.vol > 0)).all()


@pytest.fixture(scope="module")
def brain():
    import bench

    dwi, mask, _ = bench.make_brain(shape=(14, 14, 10), ndir=34)
    return dwi, mask


def test_pipeline_phase_tiny(brain, tmp_path):
    """CLI pipeline from files, then FA, ODF, first peak and streamlines
    against the oracle."""
    import fibers_tpu as ft

    dwi, mask = brain
    assert chip_smoke.pipeline_phase(dwi, mask, str(tmp_path),
                                     ft.sphere_362, n_seeds=90,
                                     n_check=60, n_lines=24)
    assert os.path.isfile(tmp_path / "out" / "tracts.trk")


def test_sharded_phase_tiny(brain, tmp_path):
    """pipeline --mesh 4, sharded RUMBA and the dry run against one
    device, on four of the virtual CPU devices."""
    import fibers_tpu as ft

    dwi, mask = brain
    assert chip_smoke.sharded_phase(dwi, mask, str(tmp_path),
                                    ft.sphere_362, 4, n_seeds=90,
                                    n_check=60, niter=3)


def test_check_dti_flags_a_wrong_map(brain):
    dwi, mask = brain
    vox = chip_smoke.sample_voxels(mask.vol, 20)
    wrong = np.full(mask.vol.shape, 0.5, np.float32)
    assert not chip_smoke.check_dti(wrong, np.asarray(dwi.vol), mask.vol,
                                    np.asarray(dwi.bval),
                                    np.asarray(dwi.bvec), vox)


@pytest.mark.parametrize("wire", ["u16", "f32"])
def test_check_dti_passes_the_fit_on_its_wire(brain, wire):
    """A fit whose rows came over `wire` passes every FA limit: against
    the oracle on the oracle's model of that wire and against the raw
    signal."""
    import fibers_tpu as ft

    dwi, mask = brain
    batch = ft.prepare_batch(dwi, mask, wire=wire)
    fa = ft.dti_fit(dwi, mask, batch=batch).fa.vol
    vox = chip_smoke.sample_voxels(mask.vol, 60)
    assert chip_smoke.check_dti(fa, np.asarray(dwi.vol), mask.vol,
                                np.asarray(dwi.bval), np.asarray(dwi.bvec),
                                vox, wire)


def test_check_dti_u16_flags_a_fit_that_ignored_the_wire(brain):
    """The wire model is load-bearing: with a single sub-step sample the
    float32 fit's FA differs from the u16-model oracle's."""
    import fibers_tpu as ft

    dwi, mask = brain
    vol = np.asarray(dwi.vol).copy()
    vox = chip_smoke.sample_voxels(mask.vol, 20)
    flat = vol.reshape(-1, vol.shape[-1])
    flat[vox, 5] = 1e-6 * vol[mask.vol > 0].max()    # rounds to 0 on u16
    d2 = ft.MRI.like(dwi)
    d2.vol, d2.bval, d2.bvec = vol, dwi.bval, dwi.bvec
    fa = ft.dti_fit(d2, mask, batch=ft.prepare_batch(d2, mask,
                                                      wire="f32")).fa.vol
    assert not chip_smoke.check_dti(fa, vol, mask.vol, np.asarray(dwi.bval),
                                    np.asarray(dwi.bvec), vox, "u16")


def test_upload_wire_is_f32_on_the_cpu(brain):
    dwi, mask = brain
    assert chip_smoke.upload_wire(np.asarray(dwi.vol), mask.vol) == "f32"


def test_check_gqi_flags_a_wrong_odf(brain):
    import fibers_tpu as ft

    dwi, mask = brain
    gqi = ft.gqi_rec(dwi, mask, ft.sphere_362)
    vox = chip_smoke.sample_voxels(mask.vol, 20)
    args = (np.asarray(dwi.vol), np.asarray(dwi.bval),
            np.asarray(dwi.bvec), ft.sphere_362, vox)
    assert chip_smoke.check_gqi(gqi.odf.vol, gqi.peak[0].vol, *args)
    assert not chip_smoke.check_gqi(np.asarray(gqi.odf.vol) * 1.01,
                                    gqi.peak[0].vol, *args)


def test_rumba_phase_tiny():
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from bench_models import rumba_phantom

    dwi, mask, _, _ = rumba_phantom((10, 10, 8), 20, 2,
                                    np.random.default_rng(0), cache=False)
    assert chip_smoke.rumba_phase(dwi, mask, niter=3, crop=4)


def test_rumba_crop_check_flags_a_drifted_reference(monkeypatch):
    import oracle

    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from bench_models import rumba_phantom

    dwi, _, _, _ = rumba_phantom((10, 10, 8), 20, 2,
                                 np.random.default_rng(0), cache=False)
    inp = chip_smoke.rumba_crop_inputs(np.asarray(dwi.vol),
                                       np.asarray(dwi.bval),
                                       np.asarray(dwi.bvec), 4)
    assert chip_smoke.check_rumba_crop(inp, 2, {"highest": True})
    real = oracle.rumba_iterate_oracle

    def drifted(*a, **k):
        fodf, *rest = real(*a, **k)
        return (fodf * 1.01, *rest)

    monkeypatch.setattr(oracle, "rumba_iterate_oracle", drifted)
    assert not chip_smoke.check_rumba_crop(inp, 2, {"highest": True})
