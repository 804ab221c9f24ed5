"""What the readers of the program's own spans and counters share.

The program (utils/tracing.py) keeps its spans and counters in memory while
a torch profiler records, which is the traced run's window. A reader
returns None for an untraced run, for a program without that module, and
when the window recorded nothing of what it reads.
"""
from __future__ import annotations


def _tracing():
    try:
        from acfm_video_3d_reconstruction_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def self_ms(ctx, name: str, thread: str):
    """Host ms per unit of the window in the program's `name` spans on the
    thread named `thread`, less the time of their child spans.

    The window is the `window_s` that follows the record's first span (the
    profiler starts just before the window opens): a span that ends after
    it is left out, since the profiler's stop, which can take seconds,
    holds open a span on another thread."""
    tracing = _tracing()
    if ctx.trace is None or tracing is None or not ctx.units:
        return None
    spans = tracing.record()
    if not spans:
        return None
    end_ns = min(s.start_ns for s in spans) + ctx.window_s * 1e9
    own = tracing.self_ns(spans)
    mine = [own[s.id] for s in spans
            if s.name == name and s.thread == thread and s.end_ns <= end_ns]
    if not mine:
        return None
    return 1e-6 * sum(mine) / ctx.units


def counter_per_unit(ctx, name: str):
    """The program's counter `name` over the window, per unit."""
    tracing = _tracing()
    if ctx.trace is None or tracing is None or not ctx.units:
        return None
    value = tracing.counters().get(name)
    return None if value is None else value / ctx.units
