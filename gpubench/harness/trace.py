"""The traced run's reading of torch.profiler: device busy time, kernel
time by name and by kind, the device time of the kernels launched inside
each of the harness's spans (on the span's own thread, or on any thread
while the span is open), and the longest idle gaps of the device with what
the host was doing then.

The profiler records the window only (bench.Window starts and stops it),
on every thread (the flow pass runs on the loop's prefetch thread).
"""
from __future__ import annotations

import bisect

from torch.autograd import DeviceType

# Kinds of device operations, in order (first match wins): a copy of the
# table of chip_smoke.py's _kinds, kept with the benchmark.
KINDS = (("rasterizer kernels", ("raster_fwd_kernel", "raster_bwd")),
         ("cost volume", ("corr_tile", "corr_split")),
         ("Adam", ("multi_tensor_apply", "adam")),
         ("solve (Cholesky)", ("potrf", "potrs", "trsm", "cholesky", "syrk")),
         ("bilinear upsampling backward (LPIPS)", ("upsample_bilinear2d_backward",)),
         ("convolutions and matmuls (im2col, FFT included)",
          ("conv", "gemm", "cutlass", "xmma", "sm90", "wgrad", "dgrad", "implicit",
           "winograd", "fft", "im2col", "col2im", "complex", "nhwctonchw", "nchwtonhwc")))
OTHER = "other (elementwise, reductions, indexing; the bin pass)"


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, keys in KINDS if any(x in low for x in keys)), OTHER)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _kernel_s(fe, annotations: set) -> float:
    """Device seconds of the kernels launched inside a host event and its
    children on the event's own thread: the profiler can nest another
    thread's events that overlap it in time (the flow pass on the prefetch
    thread under the loop's step). A range annotation (Optimizer.step's,
    the harness's own) also has a device-side event, attached to it like a
    kernel, whose span covers kernels counted on their own: left out by
    name."""
    total, stack = 0.0, [fe]
    while stack:
        node = stack.pop()
        if node.thread == fe.thread:
            total += sum(k.duration for k in node.kernels if k.name not in annotations)
        stack.extend(node.cpu_children)
    return total * 1e-6


def _in_any(t, intervals, starts) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= intervals[i][1]


class Trace:
    """Read from the profiler's events (times in microseconds from the
    trace's start): device operations (kernels, copies and fills, not the
    device side of annotations) and the harness's host spans."""

    def __init__(self, prof):
        events = prof.events()
        annotations = {fe.name for fe in events if getattr(fe, "is_user_annotation", False)}
        self.kernels = []      # (start_us, end_us, name)
        self.annotations = []  # (start_us, end_us, name) of the harness's host spans
        self.span_device = {}
        self.span_count = {}
        self.launches = []     # (host start_us, device seconds) of each op's kernels
        for fe in events:
            if fe.device_type == DeviceType.CPU and fe.kernels:
                t = sum(k.duration for k in fe.kernels if k.name not in annotations)
                if t:
                    self.launches.append((fe.time_range.start, t * 1e-6))
            if fe.device_type == DeviceType.CUDA:
                if fe.name not in annotations:
                    self.kernels.append((fe.time_range.start, fe.time_range.end, fe.name))
            elif fe.device_type == DeviceType.CPU and fe.name.startswith("gpubench."):
                name = fe.name[len("gpubench."):]
                self.annotations.append((fe.time_range.start, fe.time_range.end, name))
                self.span_device[name] = self.span_device.get(name, 0.0) + _kernel_s(
                    fe, annotations)
                self.span_count[name] = self.span_count.get(name, 0) + 1
        self.busy = _merge([(s, e) for s, e, _ in self.kernels])

    def span_device_any_thread(self, name: str) -> float | None:
        """Device seconds of the kernels of every op that began while a
        `name` span was open, on any thread: the backward of an autograd
        call runs its ops on the engine's device thread, not the caller's.
        For a cell where no other thread launches work meanwhile."""
        spans = _merge([(s, e) for s, e, n in self.annotations if n == name])
        if not spans:
            return None
        starts = [s for s, _ in spans]
        return sum(t for s, t in self.launches if _in_any(s, spans, starts))

    @property
    def kernel_total_s(self) -> float:
        """Device seconds of every operation in the window (kernels, copies)."""
        return sum(e - s for s, e, _ in self.kernels) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def kernel_s(self, match) -> tuple:
        """(seconds, launches) of the kernels whose name `match` accepts."""
        t, n = 0, 0
        for s, e, name in self.kernels:
            if match(name):
                t += e - s
                n += 1
        return t * 1e-6, n

    def by_kind(self) -> list:
        out = {}
        for s, e, name in self.kernels:
            k = kind_of(name)
            out[k] = out.get(k, 0) + (e - s)
        return sorted(([k, v * 1e-6] for k, v in out.items()), key=lambda kv: -kv[1])

    def top_kernels(self, n: int = 10) -> list:
        out = {}
        for s, e, name in self.kernels:
            out[name] = out.get(name, 0) + (e - s)
        return sorted(([k[:120], v * 1e-6] for k, v in out.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The `n` longest gaps between device work, each named by the
        innermost harness span that the host was in at the gap's middle."""
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(self.busy, self.busy[1:])]
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:n]:
            mid = (s + e) / 2
            inside = [(ae - as_, name) for as_, ae, name in self.annotations if as_ <= mid <= ae]
            label = min(inside)[1] if inside else "outside the harness's spans"
            out.append([f"host in {label}", length * 1e-6])
        return out
