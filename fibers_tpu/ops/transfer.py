"""Chunked, parallel host<->device transfer.

`to_host` slices the flattened array into fixed-size chunks and fetches
several in parallel; `to_device`/`to_device_rows` upload in chunks on a
thread pool so host-side row production overlaps the upload.  Slow
chunks are re-issued (hedged).  These mechanisms were built for a slow,
high-latency device link; whether each still pays on a directly attached
GPU is an open measurement (ROADMAP).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np

__all__ = ["to_host", "to_device", "to_device_rows", "sync",
           "quant_u16_scale", "quant_u8_scale", "quant_u12_scale"]


def quant_u16_scale(arr_max, arr_min=0.0) -> float:
    """Global uint16 quantization scale for a non-negative host array
    with the given max, or 0.0 when quantization is unsafe (negative
    values, non-finite range, empty).

    The wire format is round(v / scale) as uint16 with v' = u * scale on
    device; absolute error <= scale/2 = max/131070, i.e. relative error
    <= 0.5/65535 at full scale — below float32 GEMM noise for the fits,
    and exactly the dynamic range scanners record DWIs at (int16 DICOM).
    """
    m = float(arr_max)
    if not np.isfinite(m) or m <= 0 or float(arr_min) < 0:
        return 0.0
    return m / 65535.0


def quant_u8_scale(arr_max, arr_min=0.0) -> float:
    """uint8 variant of `quant_u16_scale`: absolute error <= max/510.
    Only for scale-invariant consumers (DSI's ODF/PDF are normalized by
    the PDF sum, so the global scale cancels; measured peak directions
    are unchanged and ODF relative error ~1.5e-3)."""
    m = float(arr_max)
    if not np.isfinite(m) or m <= 0 or float(arr_min) < 0:
        return 0.0
    return m / 255.0


def quant_u12_scale(arr_max, arr_min=0.0) -> float:
    """12-bit variant of `quant_u16_scale` (packed 2 values per 3 wire
    bytes): absolute error <= max/8190, 16x u16's but still far below
    the fits' own noise at scanner dynamic ranges, for 25% fewer upload
    bytes."""
    m = float(arr_max)
    if not np.isfinite(m) or m <= 0 or float(arr_min) < 0:
        return 0.0
    return m / 4095.0


def sync(x):
    """Force completion of a device computation and return x.

    Fetches one element of EVERY leaf of an array or pytree (cheap
    scalar reads), so leaves produced by separate dispatches are each
    forced to completion — a barrier that holds even on runtimes whose
    block_until_ready returns early.
    """
    for leaf in jax.tree_util.tree_leaves(x):
        if hasattr(leaf, "ndim") and getattr(leaf, "size", 0):
            # scalar-index the first element: a plain slice, NOT ravel,
            # so no eager reshape of the whole leaf is dispatched
            np.asarray(leaf[(0,) * leaf.ndim])
    return x

# Fetch chunk size and thread count.  Not tuned for the GPU host: the
# values were chosen for a slow remote link.  Env-overridable.
import os

_CHUNK_BYTES = int(os.environ.get("FIBERS_D2H_CHUNK_MB", 16)) << 20
_THREADS = int(os.environ.get("FIBERS_D2H_THREADS", 8))
# Hedged fetches: if a chunk makes no progress for this long after its
# predecessor completed, re-issue it on a spare thread and take
# whichever copy finishes first (a single transfer can stall while the
# link itself is healthy); re-reading an immutable device buffer is
# safe.
_HEDGE_AFTER_S = float(os.environ.get("FIBERS_D2H_HEDGE_S", 30))
_pool = None
_hedge_pool = None


def _get_pool():
    global _pool
    if _pool is None:
        _pool = ThreadPoolExecutor(_THREADS)
    return _pool


def _reset_hedge_state():
    """Test hook: forget wedged-hedge bookkeeping."""
    global _hedge_pool, _hedge_pools_made
    _hedge_pool = None
    _hedge_pools_made = 0
    _hedge_inflight.clear()


# A hedge thread that picks up a truly wedged transfer never returns, which
# would permanently consume its pool slot; track in-flight hedge futures
# and replace the pool when every slot is wedged so hedging keeps
# working for the rest of the process (old threads are daemonized by
# never being joined; a capped number of pools bounds thread growth).
_HEDGE_POOL_SIZE = 4
_MAX_HEDGE_POOLS = 4
_hedge_inflight = []
_hedge_pools_made = 0
# hedges are rare (one per stalled chunk), so this lock is uncontended;
# it exists so concurrent to_device_rows/to_host callers can't race on
# the pool-replacement bookkeeping and double-replace a wedged pool
_hedge_lock = threading.Lock()


def _hedge_submit(fn, *args):
    global _hedge_pool, _hedge_pools_made
    import sys

    with _hedge_lock:
        _hedge_inflight[:] = [f for f in _hedge_inflight if not f.done()]
        if _hedge_pool is None:
            _hedge_pool = ThreadPoolExecutor(_HEDGE_POOL_SIZE)
            _hedge_pools_made = 1
        elif len(_hedge_inflight) >= _HEDGE_POOL_SIZE:
            if _hedge_pools_made < _MAX_HEDGE_POOLS:
                sys.stderr.write(
                    "fibers_tpu.transfer: all hedge threads wedged on "
                    "stalled transfers; starting a fresh hedge pool\n")
                _hedge_pool = ThreadPoolExecutor(_HEDGE_POOL_SIZE)
                _hedge_pools_made += 1
                _hedge_inflight.clear()
            else:
                sys.stderr.write(
                    "fibers_tpu.transfer: hedge pool exhausted "
                    f"({_MAX_HEDGE_POOLS} pools wedged); hedging degrades "
                    "to a plain wait\n")
        fut = _hedge_pool.submit(fn, *args)
        _hedge_inflight.append(fut)
    return fut


def _hedged_results(futs, items, resubmit=np.asarray,
                    first_budget=600.0):
    """Consume fetch futures in order with a progress watchdog: a chunk
    that stalls well past the pace of its predecessors is re-issued on a
    spare thread (`resubmit(item)`), and the first SUCCESSFUL copy wins
    (a failure only propagates once both copies have failed).

    The first chunk gets `first_budget` — it may legitimately sit
    behind queued device compute (callers dispatch everything before
    fetching).  Later chunks are paced by the slowest chunk seen so far,
    so a uniformly slow link does not trigger routine hedging (which
    would double traffic exactly when the wire is the bottleneck).
    Hedges are capped per call: a true stall wedges its pool thread
    until the transfer resolves, so unbounded hedging could drain the pool."""
    import concurrent.futures as cf
    import sys
    import time

    thr = _HEDGE_AFTER_S
    hedges_left = 4
    prev = time.monotonic()

    for i, (f, c) in enumerate(zip(futs, items)):
        budget = first_budget if i == 0 else thr
        try:
            part = f.result(timeout=budget)
        except cf.TimeoutError:
            if hedges_left == 0:
                part = f.result()           # out of hedges: just wait
            else:
                hedges_left -= 1
                sys.stderr.write("fibers_tpu.transfer: chunk fetch "
                                 f"stalled >{budget:.0f}s; hedging\n")
                pending = {f, _hedge_submit(resubmit, c)}
                part = None
                while part is None:
                    done, pending = cf.wait(
                        pending, return_when=cf.FIRST_COMPLETED)
                    ok = [d for d in done if d.exception() is None]
                    if ok:
                        part = ok[0].result()
                    elif not pending:       # both copies failed
                        raise done.pop().exception()
        now = time.monotonic()
        if i > 0:
            # pace off completed chunks; chunk 0's duration includes any
            # queued device compute and would inflate the threshold
            thr = max(thr, 3.0 * (now - prev))
        prev = now
        yield part


# Upload chunk size and thread count; like the fetch values above, not
# tuned for the GPU host.
_UP_CHUNK_BYTES = int(os.environ.get("FIBERS_H2D_CHUNK_MB", 16)) << 20
_UP_THREADS = int(os.environ.get("FIBERS_H2D_THREADS", 8))
_upool = None


def _get_upool():
    global _upool
    if _upool is None:
        _upool = ThreadPoolExecutor(_UP_THREADS)
    return _upool


def to_device_rows(producer, n_rows: int, row_bytes: int):
    """Chunked parallel upload from a row producer.

    `producer(lo, hi)` must return the host rows [lo, hi) as a numpy
    array; slabs are produced and device_put on the upload pool so host
    gather work overlaps upload wire time.  Returns the concatenated
    device array of n_rows rows.

    `producer` MUST be pure and safe to call twice concurrently for the
    same span: stalled uploads are hedged — a slab that makes no
    progress is re-produced and re-uploaded on a spare thread while the
    original call may still be executing, and whichever copy finishes
    first wins.  A stateful producer (e.g. one consuming a stream)
    would corrupt the batch.

    On hosts with <=2 CPU cores every slab is produced FIRST and the
    uploads submitted afterwards, so producer CPU work (gather,
    quantization) does not compete with the transfer threads for the
    cores."""
    import os

    import jax.numpy as jnp

    rows = max(1, _UP_CHUNK_BYTES // max(1, row_bytes))
    if n_rows <= rows:
        return jax.device_put(producer(0, n_rows))

    spans = [(lo, min(lo + rows, n_rows))
             for lo in range(0, n_rows, rows)]

    if (os.cpu_count() or 1) <= 2:
        hostparts = {s: producer(*s) for s in spans}

        def slab(lo, hi):
            return jax.device_put(hostparts[(lo, hi)])
    else:
        def slab(lo, hi):
            return jax.device_put(producer(lo, hi))

    futs = [_get_upool().submit(slab, lo, hi) for lo, hi in spans]
    parts = list(_hedged_results(
        futs, spans, resubmit=lambda s: slab(*s),
        first_budget=4 * _HEDGE_AFTER_S))
    return jnp.concatenate(parts, axis=0)


def to_device(arr: np.ndarray):
    """Upload a host array, chunked along the leading axis in parallel.

    Chunks are concatenated on device (one extra device-side copy)."""
    import jax.numpy as jnp

    n = arr.shape[0] if arr.ndim else 0
    if arr.nbytes <= _UP_CHUNK_BYTES or n <= 1:
        return jnp.asarray(arr)
    rows = max(1, _UP_CHUNK_BYTES // max(1, arr.nbytes // n))
    if rows >= n:
        return jnp.asarray(arr)
    parts = [arr[i:min(i + rows, n)] for i in range(0, n, rows)]
    futs = [_get_upool().submit(jax.device_put, p) for p in parts]
    devs = list(_hedged_results(futs, parts, resubmit=jax.device_put,
                                first_budget=4 * _HEDGE_AFTER_S))
    return jnp.concatenate(devs, axis=0)


def to_host(x, n_lead=None, scratch_tag: str = None) -> np.ndarray:
    """Fetch a device array to host: flatten on device, fetch 1-D chunks
    in parallel, reshape on host.

    `scratch_tag`: assemble the result in a pooled scratch buffer
    (utils.hostbuf) instead of a fresh allocation — ONLY for callers
    whose result dies before the tag's next use (e.g. the streamline
    wire buffers, decoded then dropped), so a fresh ~100 MB-scale buffer
    does not pay its first-touch page faults on every call.

    The array is flattened on device (one device-side copy) so the
    transfer is a linear copy of 1-D chunks whatever the array's layout.

    `n_lead`: fetch only the first n_lead rows along axis 0.  The fetch
    overreads to the next chunk boundary and trims host-side, so the set
    of compiled device slice programs depends only on x's (bucketed)
    shape, never on n_lead — no per-value recompiles.
    """
    if x.ndim == 0:
        return np.asarray(x)

    shape = x.shape
    import jax.numpy as jnp

    # Already-1D inputs skip the copy; producers of large wire buffers
    # emit them flat from inside their jit.
    flat = x if x.ndim == 1 else jnp.reshape(x, (-1,))
    n = flat.shape[0]
    row = 1
    for s in shape[1:]:
        row *= int(s)
    n_need = n if n_lead is None else min(n, int(n_lead) * row)
    out_shape = shape if n_lead is None else (min(int(n_lead), shape[0]),) \
        + shape[1:]

    # Split across the whole pool even for mid-size buffers, with a 1 MB
    # floor so small fetches don't fragment into per-call overhead.  The chunk
    # size derives from the buffer's (bucketed) full size, NOT n_lead,
    # preserving the shape-stable slice-program invariant below.
    itemsize = max(1, x.dtype.itemsize)
    chunk_bytes = min(_CHUNK_BYTES,
                      max(1 << 20, -(-(n * itemsize) // _THREADS)))
    elems = max(1, chunk_bytes // itemsize)
    if n <= elems:
        return np.asarray(flat)[:n_need].reshape(out_shape)

    # Aligned fixed-size chunks only: keeps the set of device slice
    # programs small and persistent-cacheable per input shape.
    nchunks = (n_need + elems - 1) // elems
    starts = [i * elems for i in range(nchunks)]
    if starts and starts[-1] + elems > n:
        starts[-1] = n - elems
    chunks = [jax.lax.slice_in_dim(flat, i, i + elems) for i in starts]
    futs = [_get_pool().submit(np.asarray, c) for c in chunks]
    parts = list(_hedged_results(futs, chunks))

    if scratch_tag is not None:
        from ..utils.hostbuf import scratch
        out = scratch(scratch_tag, n_need, x.dtype)
    else:
        out = np.empty(n_need, x.dtype)
    for i, p in zip(starts, parts):
        m = min(elems, n_need - i)
        if m > 0:
            out[i:i + m] = p[:m]
    return out.reshape(out_shape)
