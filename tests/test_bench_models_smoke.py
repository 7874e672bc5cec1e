"""Smoke-run benchmarks/bench_models.py end-to-end at toy scale.

The benchmark scripts run at full scale only on the accelerator, so a
plain-Python bug in them (e.g. a function-local ``import os`` shadowing
the module import) would otherwise surface only there.  Run main()
in-process on the CPU mesh so pytest catches script-level breakage.
"""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))


def _run_main(monkeypatch, capsys, tmp_path, argv):
    import bench_models

    monkeypatch.setenv("FIBERS_BENCH_CACHE", str(tmp_path))
    # JAX's own setting: main() then sets no cache directory in this
    # test process
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["bench_models.py"] + argv)
    bench_models.main()
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


def test_config4_small_chain(monkeypatch, capsys, tmp_path):
    """RUMBA + structure tensor + chained tractography, toy scale."""
    rec = _run_main(monkeypatch, capsys, tmp_path,
                    ["--config", "4", "--small", "--niter", "2",
                     "--chain-stream"])
    assert rec["unit"] == "seconds"
    assert rec["value"] > 0
    assert rec["streamlines"] > 0


def test_config3_small(monkeypatch, capsys, tmp_path):
    """DSI reconstruction, toy scale."""
    rec = _run_main(monkeypatch, capsys, tmp_path,
                    ["--config", "3", "--small"])
    assert rec["metric"] == "dsi_rec_small"
    assert rec["value"] > 0
    assert rec["vox_per_sec"] > 0
