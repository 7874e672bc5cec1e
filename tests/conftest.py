"""Test configuration: run everything on a virtual 8-device CPU mesh so that
sharding/pjit paths are exercised without accelerator hardware."""

import os

# Force CPU regardless of the ambient JAX_PLATFORMS: on a GPU host the tests
# still run on the virtual CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def tmp_mri(tmp_path, rng):
    """A small random DWI volume with geometry + b-tables, on disk and in
    memory."""
    import fibers_tpu as ft

    vol = rng.standard_normal((6, 7, 8, 9)).astype(np.float32)
    mri = ft.MRI(vol=vol)
    mri.vox2ras0 = np.array(
        [[-2, 0, 0, 10], [0, 0, 2.5, -20], [0, -2, 0, 30], [0, 0, 0, 1]],
        np.float32)
    mri.bval = np.concatenate([[0.0], np.full(8, 1000.0)]).astype(np.float32)
    bvec = rng.standard_normal((9, 3)).astype(np.float32)
    bvec[0] = 0
    mri.bvec = ft.normalize_bvecs(bvec)
    mri.volsize = np.asarray(vol.shape[:3])
    mri.width, mri.height, mri.depth = vol.shape[:3]
    mri.nframes = vol.shape[3]
    mri.set_geometry()
    return mri, tmp_path
