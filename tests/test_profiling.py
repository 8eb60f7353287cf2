"""Observability subsystem (utils/profiling.py): timers, metrics, cost model.

The reference has no analogue (SURVEY §5: wall-clock prints only); these
tests pin the structured replacements, in particular that the per-stage
byte/FLOP roofline estimates are self-consistent and land in the runner's
metrics stream.
"""

import json
import os
import time

import numpy as np
import pytest

from pointcloudprocessor_tpu.utils import profiling as prof


def test_stage_timer_accumulates():
    t = prof.StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        time.sleep(0.01)
    assert t.timings["a"] >= 0.02


def test_metrics_logger_jsonl(tmp_path):
    p = str(tmp_path / "m.jsonl")
    m = prof.MetricsLogger(p)
    m.log("ev", x=1)
    m.log("ev2", y="z")
    lines = [json.loads(l) for l in open(p)]
    assert lines[0]["event"] == "ev" and lines[0]["x"] == 1
    assert lines[1]["y"] == "z"
    prof.MetricsLogger(None).log("noop")  # disabled path


H100 = "NVIDIA H100 80GB HBM3"


def test_roofline_classification():
    peaks = prof.peaks_for(H100)
    f32, bw = peaks["f32_flops"], peaks["hbm_bytes_per_s"]
    # Pure-bandwidth op: 1 flop/byte << ridge (~20 flop/byte for f32).
    r = prof.roofline(1e9, 1e9, f32, bw)
    assert r["bound"] == "memory"
    assert r["speed_of_light_s"] == round(1e9 / bw, 6)
    # Dense matmul-like: far above the ridge.
    r2 = prof.roofline(1e15, 1e9, f32, bw)
    assert r2["bound"] == "compute"
    assert r2["intensity_flop_per_byte"] > r2["ridge_flop_per_byte"]


@pytest.mark.parametrize(
    "kind,bw", [("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12)]
)
def test_peak_table_knows_h100(kind, bw):
    """device_kind strings as JAX reports them (the SXM5 card reads
    "NVIDIA H100 80GB HBM3"); peaks from NVIDIA's data sheet."""
    peaks = prof.peaks_for(kind)
    assert peaks["hbm_bytes_per_s"] == bw
    assert peaks["f32_flops"] < peaks["tf32_flops"] < peaks["bf16_flops"]
    rec = prof.cost_record({"flops": 1e12, "bytes": 1e10}, kind)
    assert rec["speed_of_light_s"] > 0 and rec["bound"] in ("compute", "memory")


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA L4"])
def test_unknown_device_gets_counts_and_no_peak_fields(kind):
    assert prof.peaks_for(kind) is None
    rec = prof.cost_record(prof.nid_cost_estimate(1000, 2), kind)
    assert set(rec) == {"flops", "bytes"}


def test_roofline_needs_explicit_peaks():
    with pytest.raises(TypeError):
        prof.roofline(1e9, 1e9)


def test_stage_estimates_scale_linearly():
    """Cost estimates are analytic in shapes: doubling points doubles both
    sides of the roofline and preserves the bound classification."""
    for fn, kw in (
        (prof.nid_cost_estimate, dict(k_frames=8)),
        (prof.mls_cost_estimate, {}),
    ):
        a = fn(100_000, **kw)
        b = fn(200_000, **kw)
        assert b["flops"] >= 1.9 * a["flops"]
        assert b["bytes"] >= 1.9 * a["bytes"]
    # Grid HPR = linear point term + constant grid-erosion term.
    ga = prof.hpr_cost_estimate(100_000, impl="grid")
    gb = prof.hpr_cost_estimate(200_000, impl="grid")
    assert gb["flops"] - ga["flops"] == 100_000 * 40
    dense = prof.hpr_cost_estimate(262_144, impl="dense")
    grid = prof.hpr_cost_estimate(262_144, impl="grid")
    assert dense["flops"] / grid["flops"] > 1e3  # the O(N^2) -> O(N) win


def test_runner_logs_cost_estimates(tmp_path):
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_pipeline_e2e import small_config, write_dataset

    from pointcloudprocessor_tpu.pipeline import runner

    write_dataset(tmp_path)
    cfg = small_config(tmp_path)
    runner.process(cfg)
    events = [
        json.loads(l) for l in open(os.path.join(cfg.output_path, "metrics.jsonl"))
    ]
    names = {e["event"] for e in events}
    assert {"cost_estimate_nid", "cost_estimate_colorize"} <= names
    nid = next(e for e in events if e["event"] == "cost_estimate_nid")
    # CPU is not in the peak table: counts only, no rate is assumed.
    assert nid["flops"] > 0 and nid["bytes"] > 0
    assert "bound" not in nid and "speed_of_light_s" not in nid
