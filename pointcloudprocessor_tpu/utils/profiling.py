"""Tracing, stage timing, and structured metrics.

The reference's only observability is wall-clock prints around MLS
(`cloudSmooth.cpp:101,165-177`) and Ceres' per-iteration stdout
(`visual_camera_calibration.cpp:209,245-249`). Here observability is a
subsystem:

- :class:`StageTimer` — named stage timings with optional device sync, the
  structured version of the reference's scattered `std::chrono` prints;
- :func:`trace` — JAX profiler capture (XLA-level, viewable in
  TensorBoard/Perfetto) around any block;
- :class:`MetricsLogger` — append-only JSONL metrics stream (one object per
  event) for machine consumption.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


class StageTimer:
    """Collects named stage durations; drop-in for the pipeline's timings
    dict. ``sync`` waits for device completion so a stage's time is real
    execution, not async dispatch."""

    def __init__(self, sync: bool = False):
        self.timings: dict[str, float] = {}
        self._sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync and sync_value is not None:
                import jax

                jax.block_until_ready(sync_value)
            self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str):
    """JAX/XLA profiler capture around a block (open the trace with
    TensorBoard's profile plugin or Perfetto)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a profiler capture (TraceAnnotation)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


# ---------------------------------------------------------------------------
# Per-stage byte/FLOP estimates + roofline positioning (SURVEY §5).
#
# Analytic counts from array shapes — the structured replacement for the
# reference's nothing. Peak rates come from a table keyed by the device's
# `device_kind`; a device that is not in it gets counts and no peak-derived
# field (nothing assumes a rate).
# ---------------------------------------------------------------------------

# Published dense peaks (no sparsity) at the full power limit. Source:
# NVIDIA H100 Tensor Core GPU data sheet (SXM5 and PCIe parts). f32 is the
# CUDA-core rate (what HIGHEST-precision f32 work runs at); tf32 and bf16
# are tensor-core rates.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # SXM5
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
    "NVIDIA H100 PCIe": {
        "f32_flops": 51e12,
        "tf32_flops": 378e12,
        "bf16_flops": 756e12,
        "hbm_bytes_per_s": 2.0e12,
    },
}


def peaks_for(device_kind: str) -> Optional[dict]:
    """Peak rates of ``device_kind`` (`jax.Device.device_kind`), or None for
    a device the table does not know (the CPU included)."""
    return DEVICE_PEAKS.get(device_kind)


def roofline(flops: float, bytes_moved: float,
             peak_flops: float, peak_bw: float) -> dict:
    """Arithmetic intensity + bound classification + speed-of-light time
    against the given peaks (FLOP/s and bytes/s)."""
    intensity = flops / max(bytes_moved, 1.0)
    ridge = peak_flops / peak_bw
    t_compute = flops / peak_flops
    t_memory = bytes_moved / peak_bw
    return {
        "flops": flops,
        "bytes": bytes_moved,
        "intensity_flop_per_byte": round(intensity, 3),
        "ridge_flop_per_byte": round(ridge, 1),
        "bound": "compute" if intensity >= ridge else "memory",
        "speed_of_light_s": round(max(t_compute, t_memory), 6),
    }


def nid_cost_estimate(n_points: int, k_frames: int, bins: int = 16,
                      with_grad: bool = True) -> dict:
    """One multi-keyframe NID evaluation (ops/nid_hist.py semantics).

    Per point: project (~30 flops), spline weights (2x ~16), 16-tap
    histogram accumulate (16 madd); adjoint ~= forward (hand-written bwd).
    Bytes: points xyz + intensity + 16 nibble-packed taps (8 B) per point —
    the histogram reduction stays on chip. Returns {"flops", "bytes"}.
    """
    per_point = 30 + 32 + 2 * 16
    total = n_points * k_frames
    flops = total * per_point * (2.0 if with_grad else 1.0)
    bytes_moved = total * (12 + 4 + 8) * (2.0 if with_grad else 1.0)
    return {"flops": flops, "bytes": bytes_moved}


def colorize_fuse_cost(n_map: int, k_frames: int, height: int, width: int,
                       top_k: int = 5) -> dict:
    """Full fuse pass (pipeline/colorize.py): per keyframe per point
    transform+project+score (~60 flops), one packed-int32 image gather, a
    z-buffer scatter+gather, and a top-K register update (~3*top_k)."""
    per_obs = 60 + 3 * top_k
    flops = n_map * k_frames * per_obs
    bytes_moved = (
        k_frames * height * width * 4        # packed image build + gathers
        + n_map * k_frames * (12 + 4 + 4 + 8)  # xyz in, rgb word, cell, topk rw
    )
    return {"flops": flops, "bytes": bytes_moved}


def mls_cost_estimate(n_points: int, max_neighbors: int = 32) -> dict:
    """One MLS pass (ops/mls.py): 27-cell hash probe, per-neighbor weighted
    covariance (~25), 6x6 normal-equation build (~72) and solve (~200/pt)."""
    per_point = 27 * 8 + max_neighbors * (25 + 72) + 200 + 36
    flops = n_points * per_point
    bytes_moved = n_points * (12 + max_neighbors * 16 + 12 + 24)
    return {"flops": flops, "bytes": bytes_moved}


def hpr_cost_estimate(n_points: int, impl: str = "grid",
                      grid_size: int = 512, window: int = 16) -> dict:
    """HPR cull (ops/hpr.py): dense = N^2 support matmul (3 madd/pair at
    Precision.HIGHEST ~ 6 bf16-pass equivalents); grid = O(N) scatter/gather
    + separable parabolic erosion."""
    if impl == "dense":
        flops = 6.0 * n_points * n_points * 2 * 3
        bytes_moved = n_points * 16 * 2  # blocked: flipped + dirs stream
    else:
        flops = n_points * 40 + grid_size * grid_size * (2 * window + 1) * 2 * 2
        bytes_moved = n_points * (12 + 4 + 4 + 4) + grid_size * grid_size * 4 * 4
    return {"flops": flops, "bytes": bytes_moved}


def cost_record(cost: dict, device_kind: str, peak: str = "f32_flops") -> dict:
    """A stage's {"flops", "bytes"} for the metrics stream, with the
    roofline fields against ``device_kind``'s ``peak`` rate when the peak
    table knows the device, and counts alone when it does not."""
    peaks = peaks_for(device_kind)
    if peaks is None:
        return dict(cost)
    return roofline(cost["flops"], cost["bytes"], peaks[peak],
                    peaks["hbm_bytes_per_s"])


class MetricsLogger:
    """Append-only JSONL metrics: one `{"ts": ..., "event": ..., **fields}`
    object per line. Pass ``path=None`` to disable (no-op)."""

    def __init__(self, path: Optional[str]):
        self._path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **fields) -> None:
        if not self._path:
            return
        rec = {"ts": time.time(), "event": event}
        rec.update(fields)
        with open(self._path, "a") as f:
            f.write(json.dumps(rec) + "\n")
