"""Training observability: JSONL scalar logs + per-step timing.

Replaces the reference's visdom server + loss_log.txt
(*/utils/visualizer.py): scalars go to <save_dir>/metrics.jsonl (one JSON
object per log call), a human-readable line mirrors the reference's
`print_current_scalars`, and wall-clock per-step timing replaces the
`time/itr` print (SURVEY.md §5). A copy of
acfm_video_3d_reconstruction_tpu/train/metrics_logger.py, with
torch.profiler in place of jax.profiler.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Mapping


class MetricsLogger:
    def __init__(self, save_dir: str, name: str = "metrics"):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self._last_t = time.perf_counter()
        self.smoothed_total = 0.0

    def log(self, epoch: int, step: int, scalars: Mapping[str, float], echo: bool = True):
        now = time.perf_counter()
        dt = now - self._last_t
        self._last_t = now
        rec = {"epoch": epoch, "step": step, "time_per_iter": round(dt, 4)}
        for k, v in scalars.items():
            rec[k] = float(v)
        # NaN watchdog: a non-finite loss means the params are already
        # poisoned — fail fast with context instead of silently training
        # on NaN and overwriting good checkpoints (a 40-epoch run once
        # went NaN at epoch 29 and kept saving for 11 more epochs).
        bad = [k for k, v in rec.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
            raise FloatingPointError(
                f"non-finite training metrics at epoch {epoch} step {step}: "
                f"{bad} (full record in {self.path})"
            )
        if "total_loss" in rec:
            self.smoothed_total = 0.99 * self.smoothed_total + 0.01 * rec["total_loss"]
            rec["smoothed_total_loss"] = self.smoothed_total
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if echo:
            parts = ", ".join(f"{k}: {float(v):.4g}" for k, v in scalars.items())
            print(f"(epoch: {epoch}, iters: {step}, t/itr: {dt:.2g}s) {parts}")
        return rec

    def close(self):
        self._f.close()


def start_profiler():
    """A started torch.profiler trace of host and device activity; pass it
    to stop_profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profiler(prof, logdir: str) -> str:
    """Stop the trace and write it to <logdir>/trace.json (chrome format);
    returns the path."""
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    out = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(out)
    return out


def dump_config(save_dir: str, cfg) -> None:
    """Full config dump, replacing the reference's opts.log flag dump."""
    import dataclasses

    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "opts.log"), "w") as f:
        f.write(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
