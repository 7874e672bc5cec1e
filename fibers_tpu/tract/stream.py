"""Streamline tractography as a lockstep masked integrator.

Re-architected from the reference's per-seed data-dependent while loops
(reference: src/stream.jl:625-790) into fixed-trip-count scans advancing all
streams in parallel on device: each step is a batched voxel gather + best-
vector selection + masked state update.  Data-dependent termination becomes
an active mask (monotone decreasing), so saved points form a prefix of the
step axis and host assembly is fully vectorized.

Propagation semantics match the reference exactly in deterministic mode:
nearest-voxel lookup, greedy min-bending-angle vector choice with sign
flip, post-save angle/length stopping rules, EMA direction smoothing
(reference: src/stream.jl:340-374, src/stream.jl:501-541, src/stream.jl:
648-686).  The probabilistic LCM variant samples connection matrices with
explicit PRNG keys (reference: src/stream.jl:380-495), and the microscopy
cone-search variant scans a search window around the tentative next voxel
(reference: src/stream.jl:547-619).
"""

from __future__ import annotations

import sys

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core.mri import MRI
from ..io.trk import Tract
from ..utils.profiling import prof

__all__ = ["stream", "StreamConfig", "StreamWork", "stream_new_line",
           "stream_new_point", "stream_micro_new_point", "propagate_chunk",
           "peaks_to_ovecs"]


def peaks_to_ovecs(rec, device: bool = False):
    """(ovecs, fs) tractography inputs from a reconstruction result.

    GQI/DSI peaks are unit vertex directions with separate `qa` amplitude
    volumes — returned as-is.  RUMBA-SD peaks carry the volume-fraction
    amplitude in their magnitude (reference: src/rusd.jl:602-633) — split
    into unit directions + amplitude volumes, since the propagation math
    (like the reference's, see its TODO at src/stream.jl:146) expects
    unit vectors.  Pass the results to `stream(ovecs, f=fs, ...)`.

    `device=True` returns the fit's `DevicePeaks` instead — the
    orientation field then goes to `stream(peaks, mask=...)` without any
    device->host fetch or re-upload (core.handoff); amplitudes are
    thresholded at `f_thresh` on device.
    """
    if device:
        pk = getattr(rec, "_peak_dev", None)
        if pk is None:
            raise ValueError(
                f"{type(rec).__name__} carries no device-resident peaks "
                "(was it read back from disk?); call without device=True")
        return pk
    if hasattr(rec, "qa"):                      # GQI / DSI
        return list(rec.peak), list(rec.qa)

    ovecs, fs = [], []
    for pk in rec.peak:
        v = np.asarray(pk.vol, np.float32)
        a = np.linalg.norm(v, axis=-1)
        with np.errstate(invalid="ignore", divide="ignore"):
            u = np.where(a[..., None] > 0, v / a[..., None], 0.0)
        ov = MRI.like(pk, 3, np.float32)
        ov.vol = u.astype(np.float32)
        fv = MRI.like(pk, 1, np.float32)
        fv.vol = a.astype(np.float32)
        ovecs.append(ov)
        fs.append(fv)
    return ovecs, fs


@dataclass
class StreamConfig:
    """Tractography parameters; names/defaults mirror the reference's
    `stream` kwargs (reference: src/stream.jl:730)."""

    f_thresh: float = 0.03
    fa_thresh: float = 0.1
    nsub: Optional[int] = 3
    len_min: int = 3
    len_max: Optional[int] = None
    ang_thresh: Optional[float] = 45.0
    step_size: Optional[float] = 0.5
    smooth_coeff: Optional[float] = 0.2
    search_dist: int = 15
    search_ang: float = 10.0
    lcm_thresh: float = 0.099
    verbose: bool = False
    seed_rng: int = 0
    chunk: int = 1 << 17
    # Transfer the propagated points exactly (float32) instead of the
    # default int8 delta wire encoding used on accelerators (error
    # bounded at ~2*step_size/127 voxels, no drift)
    exact_points: bool = False
    # Point wire encoding: "auto" picks int8 deltas on accelerators and
    # exact f32 on CPU; "i8"/"i6"/"f32" force one codec regardless of
    # backend (so the production codecs are testable on CPU CI).  "i6"
    # packs 6-bit deltas — 25% fewer device->host bytes than i8 at a
    # coarser, still drift-free bound (~2*step_size/31 voxels).
    wire: str = "auto"
    # Stream lines to this .trk path as they are fetched (file output
    # overlaps device transfers; the returned Tract carries header +
    # counts but not the point data, which lives in the file)
    trk_sink: Optional[str] = None
    # jax.sharding.Mesh: propagate seed chunks data-parallel across the
    # mesh's "data" axis (the orientation field is replicated; each
    # device integrates its own seeds)
    mesh: Optional[object] = None


# ------------------------------------------------------------------ #
# Device kernels
# ------------------------------------------------------------------ #

def _flat_index(ipos, shape3):
    nx, ny, nz = shape3
    ix, iy, iz = ipos[..., 0], ipos[..., 1], ipos[..., 2]
    inb = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
           & (iz >= 0) & (iz < nz))
    flat = (ix * ny + iy) * nz + iz
    return jnp.where(inb, flat, 0), inb


def _pick_by_angle(vec_now, vecs):
    """Greedy choice among candidate vectors [S, nvec, 3]: max |cos| to the
    current direction, sign-flipped to align.
    (reference: src/stream.jl:340-374)"""
    cos = jnp.einsum("sj,svj->sv", vec_now, vecs)
    iszero = (vecs == 0).all(axis=2)
    cos = jnp.where(iszero, -jnp.inf, cos)
    cabs = jnp.where(iszero, -jnp.inf, jnp.abs(cos))
    ivec = jnp.argmax(cabs, axis=1)
    c = jnp.take_along_axis(cos, ivec[:, None], axis=1)[:, 0]
    v = jnp.take_along_axis(vecs, ivec[:, None, None], axis=1)[:, 0, :]
    ok = jnp.isfinite(c)
    vnext = jnp.where((c > 0)[:, None], v, -v)
    return vnext, ok, ivec


@partial(jax.jit,
         static_argnames=("nsteps", "shape3", "emit", "qscale", "dmax"))
def _propagate(pos0, vec0, npts0, ovecs_flat, nsteps, shape3,
               step_size, cosang_thresh, smooth_coeff, len_max,
               emit="points", qscale=254.0, dmax=127):
    """Lockstep propagation of one direction for S streams.

    Masking is baked into the orientation vectors: callers zero every
    vector outside their mask (see step() and _build_ovec_array).

    Returns (out [nsteps, S, 3], saved [nsteps, S], npts_total [S],
    anchor [S, 3]).  `npts0` carries the running per-line point count
    (forward pass result when propagating backward), so the shared length
    budget matches the reference's single npts counter across both
    directions (reference: src/stream.jl:648-686).

    emit="points": out is the saved float32 positions (exact path).
    emit="deltas": out is int8 error-feedback quantized step deltas at
    1/qscale-voxel resolution — the quantizer carries the decoded
    position, so reconstruction error is bounded by 1/qscale at EVERY
    point (no drift), and the wire cost is 1 byte per coordinate.
    `anchor` is the quantized chain's final position = the line's most
    distal point, exact up to the same bound.
    """

    def step(carry, _):
        pos, vec, pos_q, npts, active = carry

        pos_next = pos + vec * step_size
        ipos = jnp.round(pos_next).astype(jnp.int32)
        flat, inb = _flat_index(ipos, shape3)

        # No separate mask gather: _build_ovec_array zeroes every vector
        # outside the (fa/f-intersected) mask, so an out-of-mask voxel has
        # only zero candidates and okvec is false — identical stopping to
        # the reference's explicit mask check (src/stream.jl:516-518),
        # at half the random-access cost per step.
        vecs = ovecs_flat[flat]                  # [S, nvec, 3]
        vnext, okvec, _ = _pick_by_angle(vec, vecs)

        ok = active & inb & okvec

        # Save the CURRENT position (pre-step), as the reference does
        save = ok
        npts = npts + save.astype(jnp.int32)

        if emit == "deltas":
            d = jnp.clip(jnp.round((pos - pos_q) * qscale),
                         -float(dmax), float(dmax))
            d = jnp.where(save[:, None], d, 0.0)
            pos_q = pos_q + d * (1.0 / qscale)
            out = d.astype(jnp.int8)
        else:
            out = pos

        # Post-save stopping rules
        cosang = (vec * vnext).sum(axis=1)
        cont = save & (cosang >= cosang_thresh) & (npts <= len_max)

        # EMA smoothing, then advance
        vsm = smooth_coeff * vec + (1.0 - smooth_coeff) * vnext
        vsm = vsm / jnp.maximum(
            jnp.sqrt((vsm * vsm).sum(axis=1, keepdims=True)), 1e-20)
        vsm = jnp.where(smooth_coeff == 0.0, vnext, vsm)

        pos_out = jnp.where(cont[:, None], pos_next, pos)
        vec_out = jnp.where(cont[:, None], vsm, vec)

        return (pos_out, vec_out, pos_q, npts, cont), (out, save)

    active0 = jnp.ones(pos0.shape[0], bool)
    (pos, vec, pos_q, npts, active), (outs, saved) = jax.lax.scan(
        step, (pos0, vec0, pos0, npts0, active0), None, length=nsteps)
    return outs, saved, npts, pos_q


def propagate_chunk(seeds, subs, ovecs_flat, shape3, nsteps,
                    step_size, cosang_thresh, smooth_coeff, len_max,
                    emit="points", qscale=254.0, dmax=127):
    """Run forward+backward propagation for a chunk of seed positions.

    seeds: [S, 3] float voxel positions (seed voxel + subvoxel offset).
    Returns (fwd_out, fwd_n, bwd_out, bwd_n, fwd_anchor_flat) with out
    [T, S, 3] (f32 points or i8 deltas per `emit`), the per-stream saved
    counts, and the forward chain's final quantized position flattened
    [3*S] (the line anchor for delta decoding).
    """
    pos0 = jnp.asarray(seeds + subs, jnp.float32)
    ivox = jnp.round(pos0).astype(jnp.int32)
    flat, _ = _flat_index(ivox, shape3)
    # Initial vector: first orientation vector at the seed voxel
    # (reference: src/stream.jl:645-650)
    v0 = ovecs_flat[flat][:, 0, :]

    zero = jnp.zeros(pos0.shape[0], jnp.int32)
    fwd_out, fwd_saved, npts_f, fwd_q = _propagate(
        pos0, v0, zero, ovecs_flat, nsteps, shape3,
        step_size, cosang_thresh, smooth_coeff, len_max, emit, qscale,
        dmax)
    bwd_out, bwd_saved, npts_t, _bwd_q = _propagate(
        pos0, -v0, npts_f, ovecs_flat, nsteps, shape3,
        step_size, cosang_thresh, smooth_coeff, len_max, emit, qscale,
        dmax)

    fwd_n = fwd_saved.sum(axis=0).astype(jnp.int32)
    bwd_n = bwd_saved.sum(axis=0).astype(jnp.int32)
    meta = _pack_meta(fwd_n, bwd_n, fwd_q)
    return fwd_out, fwd_n, bwd_out, bwd_n, meta


@jax.jit
def _pack_meta(fwd_n, bwd_n, fwd_q):
    """Pack per-stream counts + line anchors into ONE flat int32 buffer
    [5*S] (anchors bitcast f32->i32), so the host needs a single small
    fetch per chunk instead of three latency-bound ones.  Integer wire
    only: the float transfer path flushes denormal patterns (small int
    bitcasts!) to zero on this runtime."""
    anchors_i = jax.lax.bitcast_convert_type(fwd_q.reshape(-1), jnp.int32)
    return jnp.concatenate([fwd_n, bwd_n, anchors_i])


def _unpack_meta(meta_host, s):
    """Inverse of _pack_meta on host: (fwd_n, bwd_n, anchors [S, 3])."""
    return (meta_host[:s], meta_host[s:2 * s],
            meta_host[2 * s:].view(np.float32).reshape(s, 3))


# ------------------------------------------------------------------ #
# Device-side compaction + host assembly
# ------------------------------------------------------------------ #

# int8 error-feedback delta encoding for the point transfer: each saved
# point is reconstructed as anchor + cumulative quantized deltas at
# 1/qscale-voxel resolution; the propagation carries the decoded chain,
# so the error at EVERY point is bounded by ~2/qscale voxels (no drift).
# One byte per coordinate instead of four on the slow device->host link.
# qscale = 127/step_size so a full step never saturates int8.


@partial(jax.jit, static_argnames=("cap", "mode"))
def _compact(fwd_out, bwd_out, fwd_n, bwd_n, keep, line_off, cap,
             mode="f32"):
    """Scatter one propagated chunk into its final ragged line layout on
    device and emit a FLAT wire buffer.

    Lines are reversed-forward-prefix then backward-prefix (the
    reference's prepend/append order).  Points of dropped/invalid slots
    scatter out of bounds and are dropped, so only `total` real points
    ever cross the device->host link.

    mode="f32": fwd/bwd_out are saved positions; the wire buffer is
    [cap*3] float32 positions in line order.
    mode="i8":  fwd/bwd_out are int8 step deltas; the wire buffer is
    [cap*3/4] uint32 words holding 4 packed int8 line-order deltas each
    (delta[j] = point[j] - point[j-1]; forward deltas are negated and
    shifted by one because that segment is laid out reversed).  The
    buffer is flat and 32-bit so it transfers as one linear copy.

    mode="i6":  same delta layout, but each delta is a 6-bit sign-offset
    field (+32) and 16 consecutive fields pack exactly into 3 uint32
    words — 25% fewer wire bytes than i8 (2.25 B/point).  Callers emit
    deltas quantized to [-31, 31] (qscale = 31/step_size).
    """
    nsteps, s = fwd_out.shape[:2]
    t_idx = jnp.arange(nsteps, dtype=jnp.int32)[:, None]
    oob = jnp.int32(cap)
    comp = jnp.arange(3, dtype=jnp.int32)[None, :]

    if mode == "f32":
        dst_f = jnp.where((t_idx < fwd_n[None, :]) & keep[None, :],
                          line_off[None, :] + fwd_n[None, :] - 1 - t_idx,
                          oob)
        dst_b = jnp.where((t_idx < bwd_n[None, :]) & keep[None, :],
                          line_off[None, :] + fwd_n[None, :] + t_idx, oob)
        dst_f3 = (dst_f.reshape(-1)[:, None] * 3 + comp).reshape(-1)
        dst_b3 = (dst_b.reshape(-1)[:, None] * 3 + comp).reshape(-1)

        out = jnp.zeros((cap * 3,), fwd_out.dtype)
        out = out.at[dst_f3].set(
            fwd_out.reshape(-1), mode="drop", unique_indices=True)
        out = out.at[dst_b3].set(
            bwd_out.reshape(-1), mode="drop", unique_indices=True)
        return out

    # i8 deltas: line[j] - line[j-1].  Forward segment is reversed, so
    # line delta at off+fwd_n-t is MINUS the forward step delta at t
    # (t >= 1; the line's first slot keeps its zero-init = "no delta").
    dst_f = jnp.where((t_idx >= 1) & (t_idx < fwd_n[None, :])
                      & keep[None, :],
                      line_off[None, :] + fwd_n[None, :] - t_idx, oob)
    dst_b = jnp.where((t_idx < bwd_n[None, :]) & keep[None, :],
                      line_off[None, :] + fwd_n[None, :] + t_idx, oob)
    dst_f3 = (dst_f.reshape(-1)[:, None] * 3 + comp).reshape(-1)
    dst_b3 = (dst_b.reshape(-1)[:, None] * 3 + comp).reshape(-1)

    out = jnp.zeros((cap * 3,), jnp.int8)
    out = out.at[dst_f3].set(
        (-fwd_out).reshape(-1), mode="drop", unique_indices=True)
    out = out.at[dst_b3].set(
        bwd_out.reshape(-1), mode="drop", unique_indices=True)

    if mode == "i6":
        # 16 sign-offset 6-bit fields -> 3 uint32 words (fields 5 and 10
        # straddle word boundaries); cap*3 is divisible by 16 because
        # cap >= 2^16.  Inverse: native unpack_sext6 / _unpack6.
        b = (out.astype(jnp.uint32) + 32) & 63
        g = b.reshape(-1, 16)
        w0 = (g[:, 0] | (g[:, 1] << 6) | (g[:, 2] << 12)
              | (g[:, 3] << 18) | (g[:, 4] << 24) | ((g[:, 5] & 3) << 30))
        w1 = ((g[:, 5] >> 2) | (g[:, 6] << 4) | (g[:, 7] << 10)
              | (g[:, 8] << 16) | (g[:, 9] << 22)
              | ((g[:, 10] & 15) << 28))
        w2 = ((g[:, 10] >> 4) | (g[:, 11] << 2) | (g[:, 12] << 8)
              | (g[:, 13] << 14) | (g[:, 14] << 20) | (g[:, 15] << 26))
        return jnp.stack([w0, w1, w2], axis=1).reshape(-1)

    b = out.astype(jnp.uint32) & 0xFF
    packed = (b[0::4] | (b[1::4] << 8) | (b[2::4] << 16)
              | (b[3::4] << 24))                           # [cap*3/4]
    # Stay on the INTEGER wire: the float transfer path flushes denormal
    # bit patterns to zero on this runtime (a bitcast-f32 word whose top
    # byte is 0 with a clear sign bit below IS a denormal), silently
    # zeroing whole delta packs.
    return packed


@partial(jax.jit, static_argnames=("cap",))
def _compact_scalars(fwd_out, bwd_out, fwd_n, bwd_n, keep, line_off, cap):
    """Line-order compaction of per-point int8 scalar flags (reversed-
    forward prefix then backward prefix, like the coordinates), packed
    4-per-uint32 word for the integer wire."""
    nsteps, s = fwd_out.shape
    t_idx = jnp.arange(nsteps, dtype=jnp.int32)[:, None]
    oob = jnp.int32(cap)
    dst_f = jnp.where((t_idx < fwd_n[None, :]) & keep[None, :],
                      line_off[None, :] + fwd_n[None, :] - 1 - t_idx, oob)
    dst_b = jnp.where((t_idx < bwd_n[None, :]) & keep[None, :],
                      line_off[None, :] + fwd_n[None, :] + t_idx, oob)
    out = jnp.zeros((cap,), jnp.int8)
    out = out.at[dst_f.reshape(-1)].set(
        fwd_out.reshape(-1), mode="drop", unique_indices=True)
    out = out.at[dst_b.reshape(-1)].set(
        bwd_out.reshape(-1), mode="drop", unique_indices=True)
    b = out.astype(jnp.uint32) & 0xFF
    return (b[0::4] | (b[1::4] << 8) | (b[2::4] << 16) | (b[3::4] << 24))


def _compact_chunk(fwd_out, bwd_out, fwd_n, bwd_n, fwd_n_dev, bwd_n_dev,
                   len_min, mode, mesh=None, fwd_scal=None, bwd_scal=None):
    """Device compaction of one propagated chunk given host-side counts.

    Returns (flat wire buffer on device, scalar wire buffer or None,
    total, npts [nkept], keep) — buffer None when nothing survives the
    length filter."""
    tot = fwd_n + bwd_n
    keep = tot >= len_min
    if not keep.any():
        return None, None, 0, np.zeros(0, np.int32), keep

    npts = tot[keep]
    total = int(npts.sum())
    # line offsets for ALL streams (dropped streams get arbitrary offsets
    # but scatter OOB via the keep mask)
    off_all = np.zeros(len(tot), np.int64)
    off_all[keep] = np.concatenate([[0], np.cumsum(npts)[:-1]])

    keep_j = jnp.asarray(keep)
    off_j = jnp.asarray(off_all, jnp.int32)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        shard_s = NamedSharding(mesh, P("data"))
        keep_j = jax.device_put(keep_j, shard_s)
        off_j = jax.device_put(off_j, shard_s)

    cap = max(1 << 16, 1 << int(np.ceil(np.log2(max(total, 1)))))
    with prof("stream.compact_dispatch"):
        out = _compact(fwd_out, bwd_out, fwd_n_dev, bwd_n_dev,
                       keep_j, off_j, cap, mode)
        sout = None
        if fwd_scal is not None:
            sout = _compact_scalars(fwd_scal, bwd_scal, fwd_n_dev,
                                    bwd_n_dev, keep_j, off_j, cap)
    return out, sout, total, npts.astype(np.int32), keep


def _fetch_wire(buf, total, mode, tag=None):
    """Fetch a flat compacted wire buffer (raw, undecoded).  `tag`:
    per-chunk pooled destination (utils.hostbuf) — the raw wire bytes
    are decoded and dropped before the same tag is fetched again, so a
    fresh ~100 MB buffer does not pay its page faults per chunk."""
    from ..ops.transfer import to_host

    with prof("stream.points_fetch"):
        if mode == "i8":
            nwords = (total * 3 + 3) // 4
            return to_host(buf, n_lead=nwords, scratch_tag=tag)
        if mode == "i6":
            nwords = ((total * 3 + 15) // 16) * 3
            return to_host(buf, n_lead=nwords, scratch_tag=tag)
        return to_host(buf, n_lead=total * 3, scratch_tag=tag)


def _unpack6(raw, nvals):
    """Expand the packed 6-bit wire (uint32 words; 16 sign-offset fields
    per 3 words, _compact mode="i6") to int8 deltas of length >= nvals,
    which then feed the int8 decoders unchanged.  The result is a pooled
    scratch view (utils.hostbuf): valid only until the next _unpack6
    call — every caller consumes it before fetching the next chunk."""
    from ..utils.hostbuf import scratch
    w = np.ascontiguousarray(raw.view(np.uint32))
    ngroups = (nvals + 15) // 16
    out = scratch("wire.unpack6", ngroups * 16, np.int8)
    from .. import native
    clib = native.lib()
    if clib is not None:
        clib.unpack_sext6(native.as_u32_ptr(w),
                          np.int64(ngroups * 16), native.as_i8_ptr(out))
        return out
    g = w[:ngroups * 3].reshape(-1, 3)
    w0, w1, w2 = g[:, 0], g[:, 1], g[:, 2]
    v = scratch("wire.unpack6v", ngroups * 16,
                np.uint32).reshape(ngroups, 16)
    v[:, 0] = w0
    v[:, 1] = w0 >> 6
    v[:, 2] = w0 >> 12
    v[:, 3] = w0 >> 18
    v[:, 4] = w0 >> 24
    v[:, 5] = (w0 >> 30) | (w1 << np.uint32(2))
    v[:, 6] = w1 >> 4
    v[:, 7] = w1 >> 10
    v[:, 8] = w1 >> 16
    v[:, 9] = w1 >> 22
    v[:, 10] = (w1 >> 28) | (w2 << np.uint32(4))
    v[:, 11] = w2 >> 2
    v[:, 12] = w2 >> 8
    v[:, 13] = w2 >> 14
    v[:, 14] = w2 >> 20
    v[:, 15] = w2 >> 26
    out[:] = ((v & 63).astype(np.int16) - 32).astype(np.int8).reshape(-1)
    return out


def _decode_points(raw, total, mode, npts=None, anchors=None, out=None,
                   qscale=254.0):
    """Decode a fetched wire buffer to [total, 3] positions (into `out`
    when given, avoiding a concatenation pass).

    mode="i8": raw holds packed int8 line-order deltas; reconstruct each
    line as anchor + cumulative deltas / qscale.
    mode="i6": 6-bit fields — expanded to int8, then decoded as i8."""
    if mode == "i6":
        raw = _unpack6(raw, total * 3)
        mode = "i8"
    if out is None:
        out = np.empty((total, 3), np.float32)
    if mode == "i8":
        with prof("stream.decode"):
            q = np.ascontiguousarray(raw.view(np.int8)[:total * 3])
            off = np.zeros(len(npts), np.int64)
            np.cumsum(npts[:-1], dtype=np.int64, out=off[1:])
            from .. import native
            clib = native.lib()
            if clib is not None:
                # one integer-accumulate pass per line, OpenMP-parallel
                anch = np.ascontiguousarray(anchors, np.float32)
                npts32 = np.ascontiguousarray(npts, np.int32)
                clib.decode_delta_lines(
                    native.as_i8_ptr(q), native.as_i64_ptr(off),
                    native.as_i32_ptr(npts32), native.as_f32_ptr(anch),
                    len(npts), np.float32(1.0 / qscale),
                    native.as_f32_ptr(out))
                return out
            # numpy fallback: global integer cumsum, per-line rebase to
            # the anchor (the first slot of each line holds a zero delta)
            c = np.cumsum(q.reshape(-1, 3), axis=0, dtype=np.int64)
            base = anchors.astype(np.float64) - c[off] * (1.0 / qscale)
            out[:] = (c * (1.0 / qscale)
                      + np.repeat(base, npts, axis=0)).astype(np.float32)
        return out
    out[:] = raw[:total * 3].reshape(total, 3)
    return out


def _wire_mode(cfg, step_size):
    """Resolve the point wire encoding: exact float32 positions on CPU
    (or on user opt-out); int8 error-feedback deltas on accelerators,
    where the device->host link is the bottleneck; opt-in 6-bit deltas
    ("i6") for 25% fewer wire bytes at a coarser but still drift-free
    bound (~2/qscale = step/15.5 voxels at every point; 0.032 vox at
    the default 0.5-vox step).  cfg.wire forces one codec explicitly.
    Returns (mode, emit, qscale, dmax)."""
    if cfg.wire not in ("auto", "f32", "i8", "i6"):
        raise ValueError(f"Unknown wire mode {cfg.wire!r} "
                         "(expected auto/f32/i8/i6)")
    if cfg.wire == "auto":
        mode = "f32" if (cfg.exact_points
                         or jax.default_backend() == "cpu") else "i8"
    else:
        mode = "f32" if cfg.exact_points else cfg.wire
    emit = "points" if mode == "f32" else "deltas"
    # full quantizer range per step regardless of the configured step
    dmax = 31 if mode == "i6" else 127
    return mode, emit, dmax / max(float(step_size), 1e-6), dmax


def _decode_scalars(raw, total):
    """Decode a fetched packed-int8 scalar wire buffer to [total] f32."""
    return raw.view(np.int8)[:total].astype(np.float32)


def _drive_wire(launch, starts, cfg, mode, qscale, tr, mesh=None,
                has_scalars=False):
    """Shared chunk driver for every tractography mode: (1) dispatch
    propagations in waves (the device queue drains at compute speed),
    (2) fetch the small packed per-chunk counts+anchors, (3) dispatch
    compactions (freeing the big point buffers), (4) fetch the compacted
    wire buffers with the link to themselves, decoding chunk i while
    chunk i+1 is on the wire, with TrkSink file output riding under the
    fetches.

    launch(lo) -> (fwd_out, fwd_n_dev, bwd_out, bwd_n_dev, meta) or,
    with has_scalars, (..., fwd_scal, bwd_scal) where the scalar buffers
    are [T, S] int8 per-point flags compacted in line order alongside
    the coordinates.  Returns the finished Tract.

    On hosts with <=2 CPU cores the fetch of chunk i+1 is NOT overlapped
    with decoding/packing chunk i, so the transfer threads and the
    decode do not compete for the cores.  On multi-core hosts the
    overlap stays on."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from ..ops.transfer import to_host

    overlap = (os.cpu_count() or 1) > 2

    # All chunks' raw propagation buffers live until their compaction;
    # int8 chunks are small so everything phases at once, but exact-f32
    # chunks are ~0.9 GB each at the default chunk — bound those to
    # waves of 2.
    wave = len(starts) if mode in ("i8", "i6") else 2

    bufs = []
    for w0 in range(0, len(starts), wave):
        results = [launch(lo) for lo in starts[w0:w0 + wave]]

        # When profiling, drain the propagation first under its own tag
        # so the stage table separates device compute from the counts
        # wire (one extra ~40 ms scalar round trip, profiling only)
        from ..utils.profiling import prof_enabled
        if prof_enabled():
            from ..ops.transfer import sync
            with prof("stream.propagate_drain"):
                sync(results[-1][1])
        # One small fetch per wave for counts + anchors (per-call
        # latency dwarfs these few MB)
        with prof("stream.counts_fetch"):
            meta_all = to_host(
                jnp.concatenate([r[4] for r in results])
                if len(results) > 1 else results[0][4])
        counts = []
        off = 0
        for r in results:
            s = r[1].shape[0]
            counts.append(_unpack_meta(meta_all[off:off + 5 * s], s))
            off += 5 * s

        for i, (r, (fn, bn, anch)) in enumerate(zip(results, counts)):
            fs, bs = (r[5], r[6]) if has_scalars else (None, None)
            buf, sbuf, total, npts_c, keep = _compact_chunk(
                r[0], r[2], fn, bn, r[1], r[3], cfg.len_min, mode,
                mesh=mesh, fwd_scal=fs, bwd_scal=bs)
            bufs.append((buf, sbuf, total, npts_c, anch[keep]))
            results[i] = None     # release the raw point buffers

    live = [b for b in bufs if b[0] is not None]
    bufs.clear()        # live now holds the only device-buffer refs
    npts_parts = [n for _, _, _, n, _ in live]
    npts = np.concatenate(npts_parts) if npts_parts else \
        np.zeros(0, np.int32)

    if has_scalars:
        tr.n_scalars = 1

    def fetch_pair(buf, sbuf, total, i):
        # per-chunk pooled destinations: the raw wire bytes are decoded
        # and dropped before the same ordinal is fetched again
        raw = _fetch_wire(buf, total, mode, tag=f"wire.chunk.{i}")
        sraw = None
        if sbuf is not None:
            with prof("stream.scalars_fetch"):
                sraw = to_host(sbuf, n_lead=(total + 3) // 4,
                               scratch_tag=f"wire.scal.{i}")
        return raw, sraw

    def fetched():
        """(raw, sraw) per live chunk — prefetched one ahead on hosts
        with CPU to spare; on low-CPU hosts ALL chunks are fetched
        up-front instead, so decode/pack run once the device is drained
        and do not compete with transfer threads for the cores (the raw
        wire buffers are hundreds of MB — cheap against host RAM).  Each
        chunk's device wire buffer is dropped as soon as its bytes land
        on the host (the fetch future holds its own reference
        meanwhile), freeing ~GBs of HBM before the decode phase and
        leaving no device state behind it."""
        if overlap:
            with ThreadPoolExecutor(1) as pool:
                futs = [pool.submit(fetch_pair, buf, sbuf, total, i)
                        for i, (buf, sbuf, total, _n, _a)
                        in enumerate(live)]
                for i, fut in enumerate(futs):
                    res = fut.result()
                    live[i] = (None, None) + live[i][2:]
                    yield res
        else:
            out = []
            for i, (buf, sbuf, total, _n, _a) in enumerate(live):
                out.append(fetch_pair(buf, sbuf, total, i))
                live[i] = (None, None) + live[i][2:]
            yield from out

    if cfg.trk_sink is not None:
        # Write each chunk's lines to the .trk as it is fetched+decoded;
        # the file write rides under the next chunk's wire time.
        from ..io.trk import TrkSink

        with TrkSink(cfg.trk_sink, tr, len(npts)) as sink:
            for (raw, sraw), (_, sbuf, total, npts_c, anch_k) in zip(
                    fetched(), live):
                dec, dec_mode = raw, mode
                if mode in ("i8", "i6") and sraw is None:
                    # fused native path: wire deltas -> trk record bytes
                    # in one pass (no [total, 3] f32 intermediate; i6
                    # extracts its 6-bit fields inline too)
                    if mode == "i6":
                        if sink.append_deltas6(raw, npts_c, anch_k,
                                               qscale):
                            continue
                        # no native lib: expand ONCE, reuse for decode
                        dec, dec_mode = _unpack6(raw, total * 3), "i8"
                        q8 = dec
                    else:
                        q8 = raw.view(np.int8)
                    if sink.append_deltas(q8, npts_c, anch_k, qscale):
                        continue
                pts = _decode_points(dec, total, dec_mode, npts=npts_c,
                                     anchors=anch_k, qscale=qscale)
                scal = None if sraw is None else \
                    _decode_scalars(sraw, total)[:, None]
                sink.append(pts, npts_c, scal)
        tr.npts = npts
        tr.n_count = int(len(npts))
        return tr

    total_all = sum(t for _, _, t, _, _ in live)
    flat_pts = np.empty((total_all, 3), np.float32)
    flat_scal = np.empty(total_all, np.float32) if has_scalars else None
    pos = 0
    for (raw, sraw), (_, sbuf, total, npts_c, anch_k) in zip(
            fetched(), live):
        _decode_points(raw, total, mode, npts=npts_c, anchors=anch_k,
                       out=flat_pts[pos:pos + total], qscale=qscale)
        if sraw is not None:
            flat_scal[pos:pos + total] = _decode_scalars(sraw, total)
        pos += total

    # Build the Tract (packed fast path; list view materializes lazily)
    tr.set_packed(flat_pts, npts, scalars=flat_scal)
    return tr

def _assemble(fwd_pts, fwd_n, bwd_pts, bwd_n, len_min):
    """Vectorized ragged assembly: reversed forward prefix + backward prefix
    per stream (prepend/append order of the reference,
    src/stream.jl:652-660).  Returns (flat_pts [total, 3], npts [nkept])."""
    fwd_n = np.asarray(fwd_n)
    bwd_n = np.asarray(bwd_n)
    tot = fwd_n + bwd_n
    keep = tot >= len_min
    if not keep.any():
        return np.zeros((0, 3), np.float32), np.zeros(0, np.int32)

    from ..ops.transfer import to_host
    fwd_n = fwd_n[keep]
    bwd_n = bwd_n[keep]
    # [T, S, 3] -> [S, T, 3] for kept streams
    fwd_pts = np.ascontiguousarray(to_host(fwd_pts).transpose(1, 0, 2)[keep])
    bwd_pts = np.ascontiguousarray(to_host(bwd_pts).transpose(1, 0, 2)[keep])

    npts = fwd_n + bwd_n
    offsets = np.concatenate([[0], np.cumsum(npts)])
    total = int(offsets[-1])
    out = np.empty((total, 3), np.float32)

    sid = np.repeat(np.arange(len(npts)), npts)
    rank = np.arange(total) - np.repeat(offsets[:-1], npts)

    in_fwd = rank < fwd_n[sid]
    # forward points are written in reverse order (prepend semantics)
    src_step = np.where(in_fwd, fwd_n[sid] - 1 - rank, rank - fwd_n[sid])
    out[in_fwd] = fwd_pts[sid[in_fwd], src_step[in_fwd]]
    out[~in_fwd] = bwd_pts[sid[~in_fwd], src_step[~in_fwd]]
    return out, npts.astype(np.int32)


# ------------------------------------------------------------------ #
# Setup + driver
# ------------------------------------------------------------------ #

def _build_ovec_array(ovecs: List[MRI], fs, f_thresh, mask_array, cfg):
    """[nx,ny,nz,nvec,3] orientation array with per-vector amplitude
    masking; accepts 3D vectors or 2D in-plane angles (deg or rad)
    (reference: src/stream.jl:130-173)."""
    nx, ny, nz = ovecs[0].vol.shape[:3]
    nvec = len(ovecs)
    arr = np.zeros((nx, ny, nz, nvec, 3), np.float32)

    for i, ov in enumerate(ovecs):
        vol = ov.vol if ov.vol.ndim == 4 else ov.vol[..., None]
        if fs is not None:
            fvol = fs[i].vol if fs[i].vol.ndim == 3 else fs[i].vol[..., 0]
            omask = mask_array & (fvol >= f_thresh)
        else:
            omask = mask_array

        if vol.shape[3] == 3:
            arr[..., i, :] = vol * omask[..., None]
        elif vol.shape[3] == 1:
            ang = vol[..., 0]
            thrudim = int(np.argmax(ov.volres))
            strdims = [d for d in range(3) if d != thrudim]
            eps = np.finfo(np.float32).eps
            if (ang.min() >= -np.pi / 2 - eps
                    and ang.max() <= np.pi / 2 + eps):
                c, s = np.cos(ang), np.sin(ang)
            elif ang.min() >= -90 and ang.max() <= 90:
                c = np.cos(np.radians(ang))
                s = np.sin(np.radians(ang))
            else:
                raise ValueError("Input orientations should be 3D vectors "
                                 "or angles in [-90, 90]")
            arr[..., i, strdims[0]] = c * omask
            arr[..., i, strdims[1]] = s * omask
        else:
            raise ValueError("Orientation input must have 1 or 3 frames")
    return arr


@partial(jax.jit, static_argnames=("nmask",))
def _amp_quantiles(amp, nmask):
    """(1e-5, 0.9) quantiles of the first-peak amplitude over the real
    batch rows, reduced on device (the f_thresh sanity warning's inputs;
    reference: src/stream.jl:108-117)."""
    a = amp[:nmask, 0]
    return (jnp.quantile(a, 1e-5), jnp.quantile(a, 0.9))


@partial(jax.jit, static_argnames=("nxyz",))
def _build_ovec_device(vecs, amp, idx, gate_flat, f_thresh, nxyz):
    """Masked [nxyz, nvec, 3] orientation array from a device peak batch:
    per-vector amplitude threshold + mask gating + unit directions, all
    in one scatter (the device counterpart of _build_ovec_array;
    reference: src/stream.jl:130-173)."""
    n = idx.shape[0]
    v = vecs[:n]
    ok = (amp[:n] >= f_thresh) & (gate_flat[idx] != 0)[:, None]
    v = jnp.where(ok[..., None], v, 0.0)
    out = jnp.zeros((nxyz,) + v.shape[1:], v.dtype)
    return out.at[idx].set(v)


class StreamWork:
    """Precomputed tractography workspace: resolved config defaults,
    intersected masks, and the packed orientation array.

    Counterpart of the reference's `StreamWork` struct (reference:
    src/stream.jl:43-334); here the per-thread scratch disappears (the
    lockstep engine is functional) and what remains is the setup state
    shared by `stream` and `stream_new_line`.
    """

    def __init__(self, ovec, *, f=None, fa=None, mask=None,
                 cfg: Optional[StreamConfig] = None, **kwargs):
        cfg = cfg or StreamConfig()
        for k, v in kwargs.items():
            if not hasattr(cfg, k):
                raise TypeError(f"Unknown stream option {k}")
            setattr(cfg, k, v)
        self.cfg = cfg

        from ..core.handoff import DevicePeaks
        self.device_peaks = ovec if isinstance(ovec, DevicePeaks) else None
        if self.device_peaks is not None:
            if mask is None:
                raise ValueError(
                    "stream with device-resident peaks requires mask=")
            if f is not None:
                raise ValueError(
                    "device-resident peaks carry their own amplitudes; "
                    "f= is not accepted")
            self.ovecs = None
            self.fs = None
            self.shape3 = self.device_peaks.shape3
            volres = self.device_peaks.volres
        else:
            self.ovecs = [ovec] if isinstance(ovec, MRI) else list(ovec)
            self.fs = None if f is None else (
                [f] if isinstance(f, MRI) else list(f))
            self.shape3 = tuple(self.ovecs[0].vol.shape[:3])
            volres = self.ovecs[0].volres
        nx, ny, nz = self.shape3

        # Microscopy regime switches defaults (reference:
        # src/stream.jl:83-92)
        self.domicro = float(np.min(volres)) <= 0.05
        self.nsub = cfg.nsub if cfg.nsub is not None else \
            (0 if self.domicro else 3)
        self.ang_thresh = cfg.ang_thresh if cfg.ang_thresh is not None \
            else (20.0 if self.domicro else 45.0)
        self.step_size = cfg.step_size if cfg.step_size is not None else \
            (1.0 if self.domicro else 0.5)
        self.smooth_coeff = cfg.smooth_coeff \
            if cfg.smooth_coeff is not None else \
            (0.0 if self.domicro else 0.2)
        self.len_max = cfg.len_max if cfg.len_max is not None else \
            max(nx, ny, nz)

        # Brain mask (reference: src/stream.jl:94-117)
        if mask is None:
            mask_array = np.zeros(self.shape3, bool)
            for ov in self.ovecs:
                vol = ov.vol if ov.vol.ndim == 4 else ov.vol[..., None]
                mask_array |= (vol != 0).any(axis=3)
        else:
            mvol = mask.vol if mask.vol.ndim == 3 else mask.vol[..., 0]
            mask_array = mvol > 0

        if fa is not None:
            favol = fa.vol if fa.vol.ndim == 3 else fa.vol[..., 0]
            inmask = favol[mask_array]
            fa_min = np.quantile(inmask, 1e-5)
            fa_max = np.quantile(inmask, 0.9)
            if cfg.fa_thresh < fa_min or cfg.fa_thresh > fa_max:
                print(f"WARNING: The value of fa_thresh ({cfg.fa_thresh}) "
                      f"is outside the range of most values in the fa "
                      f"volume ({fa_min}, {fa_max})", file=sys.stderr)
            mask_array = mask_array & (favol >= cfg.fa_thresh)

        if self.device_peaks is not None and cfg.f_thresh > 0:
            # f-range sanity warning from the device amplitudes (two
            # scalar fetches; mirrors the host-volume quantile check)
            pk = self.device_peaks
            f_min, f_max = (float(v) for v in _amp_quantiles(
                pk.amp, len(pk.idx)))
            if cfg.f_thresh < f_min or cfg.f_thresh > f_max:
                print(f"WARNING: The value of f_thresh ({cfg.f_thresh}) "
                      f"is outside the range of most values in the f "
                      f"volume ({f_min}, {f_max})", file=sys.stderr)
        elif self.fs is not None:
            f0 = self.fs[0].vol if self.fs[0].vol.ndim == 3 else \
                self.fs[0].vol[..., 0]
            inmask = f0[mask_array]
            f_min = np.quantile(inmask, 1e-5)
            f_max = np.quantile(inmask, 0.9)
            if cfg.f_thresh < f_min or cfg.f_thresh > f_max:
                print(f"WARNING: The value of f_thresh ({cfg.f_thresh}) "
                      f"is outside the range of most values in the f "
                      f"volume ({f_min}, {f_max})", file=sys.stderr)

        self.mask_array = mask_array
        if self.device_peaks is not None:
            # On-device orientation field: scatter the masked, amplitude-
            # thresholded unit vectors straight into the flat [nxyz,
            # nvec, 3] array the propagation engine gathers from — no
            # fetch, no host rebuild, no re-upload.
            pk = self.device_peaks
            self.nvec = pk.nvec
            self.ovec_arr = None
            self.ovec_flat_dev = _build_ovec_device(
                pk.vecs, pk.amp, jnp.asarray(pk.idx, jnp.int32),
                jnp.asarray(mask_array.reshape(-1)),
                float(cfg.f_thresh), int(np.prod(self.shape3)))
        else:
            self.nvec = len(self.ovecs)
            self.ovec_flat_dev = None
            self.ovec_arr = _build_ovec_array(
                self.ovecs, self.fs, cfg.f_thresh, mask_array, cfg)


def stream_new_line(seed_vox, sub_vox, work: StreamWork) -> np.ndarray:
    """Generate the bidirectional streamline of one seed voxel; returns
    the [3, npts] polyline (reference: src/stream.jl:625-686).

    The batched engine propagates a single-stream chunk with exact
    float32 points — useful for inspection/debugging; `stream` is the
    production driver."""
    seeds = np.asarray(seed_vox, np.float32)[None, :]
    subs = np.asarray(sub_vox, np.float32)[None, :]
    ovecs_flat = jnp.asarray(
        work.ovec_arr.reshape(-1, len(work.ovecs), 3))
    nsteps = int(work.len_max) + 2
    cosang = float(np.cos(np.radians(work.ang_thresh)))

    fwd, fwd_n, bwd, bwd_n, _meta = propagate_chunk(
        seeds, subs, ovecs_flat, work.shape3, nsteps,
        float(work.step_size), cosang, float(work.smooth_coeff),
        int(work.len_max), emit="points")
    flat, npts = _assemble(fwd, np.asarray(fwd_n), bwd,
                           np.asarray(bwd_n), 1)
    return np.ascontiguousarray(flat.T)


def stream_new_point(pos_now, vec_now, work: StreamWork):
    """One deterministic (angle-greedy) propagation step.
    (reference: src/stream.jl:501-541, exported as `stream_new_point!`)

    Returns (pos_next [3], vec_next [3], ok).  ok=False mirrors the
    reference's early `return false` (out of volume, out of mask, or no
    valid orientation vector); pos/vec come back unchanged then.  The
    picked vec_next is unsmoothed — the line driver applies the angle
    threshold and EMA smoothing afterwards, exactly like the reference.
    """
    pos_now = np.asarray(pos_now, np.float64)
    vec_now = np.asarray(vec_now, np.float64)
    nx, ny, nz = work.shape3
    pos_next = pos_now + vec_now * float(work.step_size)
    inext = np.round(pos_next).astype(int)
    if not ((0 <= inext[0] < nx) and (0 <= inext[1] < ny)
            and (0 <= inext[2] < nz)):
        return pos_now, vec_now, False
    if not work.mask_array[tuple(inext)]:
        return pos_now, vec_now, False
    vecs = work.ovec_arr[tuple(inext)].astype(np.float64)   # [nvec, 3]
    live = (vecs != 0).any(axis=1)
    if not live.any():
        return pos_now, vec_now, False
    cos = vecs @ vec_now
    cabs = np.where(live, np.abs(cos), -np.inf)
    iv = int(np.argmax(cabs))
    vec_next = vecs[iv] if cos[iv] > 0 else -vecs[iv]
    return pos_next, vec_next, True


def stream_micro_new_point(pos_now, vec_now, work: StreamWork):
    """One microscopy cone-search propagation step.
    (reference: src/stream.jl:547-619, exported as
    `stream_micro_new_point!`)

    Returns (pos_next [3], vec_next [3], ok): pos_next is the chosen
    search-window voxel (integer coordinates, like the reference's jump),
    vec_next the sign-aligned orientation there.
    """
    from .modes import _search_window

    pos_now = np.asarray(pos_now, np.float64)
    vec_now = np.asarray(vec_now, np.float64)
    nx, ny, nz = work.shape3

    win = getattr(work, "_micro_window", None)
    if win is None:
        search_dist = [int(work.cfg.search_dist)] * 3
        ov0 = work.ovecs[0].vol if work.ovecs[0].vol.ndim == 4 \
            else work.ovecs[0].vol[..., None]
        if ov0.shape[3] == 1:
            search_dist[int(np.argmax(work.ovecs[0].volres))] = 0
        win = _search_window(search_dist)
        work._micro_window = win
    win_off, win_dir = win

    pos_next = pos_now + vec_now * float(work.step_size)
    inext = np.round(pos_next).astype(int)
    if not ((0 <= inext[0] < nx) and (0 <= inext[1] < ny)
            and (0 <= inext[2] < nz)):
        return pos_now, vec_now, False
    if not work.mask_array[tuple(inext)]:
        return pos_now, vec_now, False

    search_cos = float(np.cos(np.radians(work.cfg.search_ang)))
    cells = inext[None, :] + win_off                       # [W, 3]
    inb = ((cells >= 0) & (cells < np.array([nx, ny, nz]))).all(axis=1)
    cand = np.where(inb)[0]
    cand = cand[work.mask_array[tuple(cells[cand].T)]]
    cand = cand[(win_dir[cand] @ vec_now) > search_cos]
    if len(cand) == 0:
        return pos_now, vec_now, False

    wvec = work.ovec_arr[tuple(cells[cand].T)][:, 0, :].astype(np.float64)
    cos = wvec @ vec_now
    ib = int(np.argmax(np.abs(cos)))
    if not np.isfinite(cos[ib]):
        return pos_now, vec_now, False
    vec_next = wvec[ib] if cos[ib] > 0 else -wvec[ib]
    return cells[cand[ib]].astype(np.float64), vec_next, True


def stream(ovec: Union[MRI, List[MRI]], *, odf: Optional[MRI] = None,
           f=None, fa: Optional[MRI] = None,
           mask: Optional[MRI] = None, seed: Optional[MRI] = None,
           lcms: Optional[MRI] = None, cfg: Optional[StreamConfig] = None,
           **kwargs) -> Tract:
    """Streamline tractography.  Returns a `Tract`.

    Mirrors the reference's `stream` driver (reference: src/stream.jl:730-
    790): builds masks and the orientation array, seeds nsub jittered
    streams per seed voxel, propagates bidirectionally, and assembles
    surviving lines into a Tract.  Keyword arguments matching
    `StreamConfig` fields override the defaults.

    `odf` is accepted for API parity and ignored, exactly like the
    reference (src/stream.jl:730 declares it; nothing reads it).

    Point precision: on accelerator backends the default wire encoding is
    int8 error-feedback deltas, so returned coordinates are quantized to
    a 1/254-voxel grid along each line (reconstruction error bounded by
    ~2*step_size/127 ~= 0.008 voxel at the default step, with no drift).
    Pass `exact_points=True` (or `wire="f32"`) for bit-exact float32
    points at ~4x the device->host transfer cost; on CPU the exact path
    is already the default.  `wire="i6"` shrinks the transfer a further
    25% (bound ~2*step_size/31 ~= 0.032 voxel).  See docs/parity.md.
    """
    del odf
    work = StreamWork(ovec, f=f, fa=fa, mask=mask, cfg=cfg, **kwargs)
    cfg = work.cfg
    ovecs, fs = work.ovecs, work.fs
    shape3 = work.shape3
    nsub, ang_thresh = work.nsub, work.ang_thresh
    step_size, smooth_coeff = work.step_size, work.smooth_coeff
    len_max, mask_array = work.len_max, work.mask_array

    if lcms is not None or work.domicro:
        if work.device_peaks is not None:
            raise ValueError("device-resident peaks drive the "
                             "deterministic engine only; pass host "
                             "volumes for LCM/microscopy modes")
        from .modes import stream_lcm, stream_micro
        if lcms is not None:
            return stream_lcm(ovecs, fs, mask_array, seed, lcms, cfg,
                              nsub, ang_thresh, step_size, smooth_coeff,
                              len_max)
        return stream_micro(ovecs, fs, mask_array, seed, cfg, nsub,
                            ang_thresh, step_size, smooth_coeff, len_max)

    ovec_arr = work.ovec_arr

    # Seed voxel list (reference: src/stream.jl:743-754)
    if seed is None:
        seed_idx = np.argwhere(mask_array)
    else:
        svol = seed.vol if seed.vol.ndim == 3 else seed.vol[..., 0]
        if svol.shape != mask_array.shape:
            raise ValueError(
                f"Dimension mismatch between seed mask {svol.shape} and "
                f"brain mask {mask_array.shape}")
        seed_idx = np.argwhere(svol > 0)

    # Subvoxel jitter: nsub offsets shared by all seed voxels, drawn once
    # with an explicit PRNG (reference: src/stream.jl:176-181 uses a global
    # RNG; we make the key explicit for reproducibility)
    if nsub > 0:
        key = jax.random.PRNGKey(cfg.seed_rng)
        subs = np.asarray(jax.random.uniform(
            key, (nsub, 3), minval=-0.5 + 1e-6, maxval=0.5 - 1e-6),
            np.float32)
    else:
        subs = np.zeros((1, 3), np.float32)

    # All (seed, sub) pairs
    S = len(seed_idx)
    seeds_all = np.repeat(seed_idx.astype(np.float32), len(subs), axis=0)
    subs_all = np.tile(subs, (S, 1))

    if work.ovec_flat_dev is not None:
        ovecs_flat = work.ovec_flat_dev
    else:
        ovecs_flat = jnp.asarray(ovec_arr.reshape(-1, work.nvec, 3))

    mesh = cfg.mesh
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        ndata = int(mesh.shape["data"])
        shard_seeds = NamedSharding(mesh, P("data"))
        # the orientation field is replicated: every device integrates
        # its own seed rows with purely local gathers
        ovecs_flat = jax.device_put(ovecs_flat, NamedSharding(mesh, P()))

    nsteps = int(len_max) + 2
    cosang_thresh = float(np.cos(np.radians(ang_thresh)))

    # Phased execution over seed chunks: (1) dispatch ALL propagations
    # (device queue drains at compute speed), (2) fetch the small
    # per-chunk counts as each chunk completes, (3) dispatch all
    # compactions (freeing the big point buffers), (4) fetch the
    # compacted points with the wire to itself — no contention between
    # the big fetches and anything else.
    def launch(lo):
        hi = min(lo + cfg.chunk, len(seeds_all))
        seeds_c, subs_c = seeds_all[lo:hi], subs_all[lo:hi]
        # pad the last chunk with out-of-bounds seeds (immediately
        # inactive, filtered by len_min) to keep one compiled shape, AND
        # (sharded) to a multiple of the data-axis size — both can apply
        target = hi - lo
        if target < cfg.chunk and len(seeds_all) > cfg.chunk:
            target = cfg.chunk
        if mesh is not None and target % ndata:
            target += ndata - target % ndata
        padn = target - (hi - lo)
        if padn:
            seeds_c = np.concatenate(
                [seeds_c, np.full((padn, 3), -10.0, np.float32)])
            subs_c = np.concatenate(
                [subs_c, np.zeros((padn, 3), np.float32)])
        if mesh is not None:
            seeds_c = jax.device_put(seeds_c, shard_seeds)
            subs_c = jax.device_put(subs_c, shard_seeds)
        with prof("stream.propagate_dispatch"):
            return propagate_chunk(
                seeds_c, subs_c, ovecs_flat,
                shape3, nsteps, float(step_size), cosang_thresh,
                float(smooth_coeff), int(len_max), emit, qscale, dmax)

    mode, emit, qscale, dmax = _wire_mode(cfg, step_size)

    # Empty seed set (e.g. a mask emptied by thresholds): empty Tract
    if len(seeds_all) == 0:
        ref = mask if mask is not None else ovecs[0]
        tr = Tract.from_ref(ref)
        tr.set_packed(np.zeros((0, 3), np.float32),
                      np.zeros(0, np.int32))
        if cfg.trk_sink is not None:
            from ..io.trk import TrkSink
            TrkSink(cfg.trk_sink, tr, 0).close()
        return tr

    starts = list(range(0, len(seeds_all), cfg.chunk))
    ref = mask if mask is not None else ovecs[0]
    return _drive_wire(launch, starts, cfg, mode, qscale,
                       Tract.from_ref(ref), mesh=mesh)
