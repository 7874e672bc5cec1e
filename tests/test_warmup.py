"""The tractography warm-up compiles the propagation bucket that
`stream` then runs, for every point wire."""

import numpy as np
import pytest

import fibers_tpu as ft
from fibers_tpu.tract import stream as st
from fibers_tpu.utils import warmup


class _Recorder:
    """Stands in for a jitted kernel: records the static wire arguments
    of calls and of ahead-of-time lowerings, and forwards calls."""

    def __init__(self, real=None):
        self.real = real
        self.calls = []
        self.lowered = []

    def __call__(self, *args, **kwargs):
        self.calls.append(tuple(args[10:13]))
        return self.real(*args, **kwargs)

    def lower(self, *args, **kwargs):
        self.lowered.append((kwargs["emit"], kwargs["qscale"],
                             kwargs["dmax"]))
        return self

    def compile(self):
        return self


class _Stub:
    def lower(self, *args, **kwargs):
        return self

    def compile(self):
        return self


@pytest.mark.parametrize("wire", ["auto", "i8", "i6", "f32"])
def test_warm_bucket_is_the_stream_bucket(monkeypatch, wire):
    shape3 = (6, 6, 4)
    warm = _Recorder()
    monkeypatch.setattr(st, "_propagate", warm)
    for name in ("_build_ovec_device", "_pack_meta", "_compact"):
        monkeypatch.setattr(st, name, _Stub())
    warmup._warm_stream(shape3, n_pad=32, nvec=1, chunk=64, wire=wire)
    monkeypatch.undo()
    assert len(warm.lowered) == 1

    run = _Recorder(st._propagate)
    monkeypatch.setattr(st, "_propagate", run)
    ov = np.zeros(shape3 + (3,), np.float32)
    ov[..., 0] = 1.0
    ovm = ft.MRI(vol=ov)
    ovm.vox2ras0 = np.eye(4, dtype=np.float32)
    ovm.volsize = np.asarray(shape3)
    ovm.width, ovm.height, ovm.depth = shape3
    ovm.nframes = 3
    ovm.set_geometry()
    mask = ft.MRI.like(ovm, 1, np.float32)
    mask.vol = np.ones(shape3, np.float32)
    ft.stream(ovm, mask=mask, nsub=1, wire=wire)
    assert run.calls
    assert set(run.calls) == set(warm.lowered)
