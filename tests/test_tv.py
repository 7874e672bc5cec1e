"""RUMBA-SD total-variation term: the XLA stencil against the per-volume
oracle, and the component-sharded (shard_map) path against the
single-device one."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle


def _masked_stack(rng, shape, ncomp):
    v = rng.uniform(0.0, 1.0, shape + (ncomp,)).astype(np.float32)
    # zero a margin + random interior cells, like a masked embedding
    v[0] = 0
    v[:, -1] = 0
    v[rng.random(shape) < 0.3] = 0
    lam = rng.uniform(0.001, 0.01, shape).astype(np.float32)
    return v, lam


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 5, 4), (3, 7, 2), (5, 2, 9),
                                   (2, 3, 3)])
def test_tv_stencil_matches_oracle(rng, shape, dtype):
    """Every component of the stacked stencil equals the oracle's
    per-volume multiplier (reference: src/rusd.jl:183-235).  bfloat16
    stacks are compared on the rounded input, at bfloat16's precision."""
    from fibers_tpu.models.rumba import _tv_stencil

    ncomp = 5
    v, lam = _masked_stack(rng, shape, ncomp)
    vj = jnp.asarray(v).astype(dtype)
    got = np.asarray(_tv_stencil(vj, jnp.asarray(lam)))
    assert got.dtype == np.float32 and got.shape == v.shape

    v_in = np.asarray(vj.astype(jnp.float32), np.float64)
    want = np.stack([oracle.rumba_tv_oracle(v_in[..., c], lam)
                     for c in range(ncomp)], axis=-1)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("model_axis,ncomp", [(1, 24), (2, 21)])
def test_tv_term_shardmap_matches_local(rng, model_axis, ncomp):
    """The mesh path reshards components over all 8 devices (padding
    components to a multiple of 8; with a model axis, slicing and
    all-gathering over it) and must match the single-device term."""
    from fibers_tpu.models.rumba import _gather_index, _tv_term
    from fibers_tpu.parallel.mesh import make_mesh

    shape3 = (5, 4, 4)
    nxyz = 80
    n = 16
    idx_mask = np.sort(rng.choice(nxyz, n, replace=False)).astype(np.int32)
    fodf = jnp.asarray(rng.uniform(0.0, 1.0, (n, ncomp)).astype(np.float32))
    lam = jnp.asarray(rng.uniform(0.001, 0.01, nxyz).astype(np.float32))
    idx = jnp.asarray(idx_mask)
    gidx = _gather_index(idx, n, nxyz)

    want = np.asarray(_tv_term(fodf, gidx, idx, lam, shape3, nxyz))
    mesh = make_mesh(8, model_axis=model_axis)
    f = jax.jit(functools.partial(_tv_term, shape3=shape3, nxyz=nxyz,
                                  mesh=mesh))
    got = np.asarray(f(fodf, gidx, idx, lam))
    assert got.shape == (n, ncomp)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ncomp,npad", [(5, 0), (130, 3), (128, 1)])
def test_tv_term_local_matches_oracle(rng, ncomp, npad):
    """The single-device term: rows embedded into the grid (zero outside
    the mask), the stencil in component chunks of _TV_CHUNK (padded when
    ncomp is not a multiple), and the in-mask rows read back.  `npad`
    batch-padding rows (zero fODF) ride along."""
    from fibers_tpu.models.rumba import _gather_index, _tv_term

    shape3 = (4, 5, 3)
    nxyz = int(np.prod(shape3))
    nmask = 40
    idx = np.sort(rng.choice(nxyz, nmask, replace=False)).astype(np.int32)
    n = nmask + npad
    rows = np.zeros((n, ncomp), np.float32)
    rows[:nmask] = rng.uniform(0.0, 1.0, (nmask, ncomp))
    lam = rng.uniform(0.001, 0.01, shape3).astype(np.float32)
    idx_j = jnp.asarray(idx)
    gidx = _gather_index(idx_j, n, nxyz)
    got = np.asarray(_tv_term(jnp.asarray(rows), gidx, idx_j,
                              jnp.asarray(lam.reshape(-1)), shape3, nxyz))
    assert got.shape == (n, ncomp) and got.dtype == np.float32

    vol = np.zeros((nxyz, ncomp))
    vol[idx] = rows[:nmask]
    vol = vol.reshape(shape3 + (ncomp,))
    want = np.stack([oracle.rumba_tv_oracle(vol[..., c], lam)
                     for c in range(ncomp)], axis=-1).reshape(nxyz, ncomp)
    np.testing.assert_allclose(got[:nmask], want[idx], rtol=1e-5,
                               atol=1e-5)
