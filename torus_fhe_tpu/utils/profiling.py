"""Tracing / profiling aux subsystem (SURVEY §5: per-kernel breakdown).

The reference instruments with wall-clock `@elapsed` / BenchmarkTools
(3-gen-mk-tfhe/perf_comp.jl, measurements/*); here the ground truth is the
profiler's device trace. This module wraps `jax.profiler` so any flow can be
traced with one context manager, and reduces the captured ``.xplane.pb`` to a
per-op and per-category device-time breakdown plus the device's busy and idle
share over the traced window.

Usage:
    with device_trace("trace_dir"):
        out = step(ck, cx, cy); out.b.block_until_ready()
    print(format_summary(summarize_trace("trace_dir")))
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from collections import defaultdict


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a JAX/XLA profiler trace into ``logdir``."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str, sink: dict | None = None):
    """Wall-clock section timer (the reference's `@elapsed`); records into
    ``sink[label]`` seconds if given, else prints."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = sink.get(label, 0.0) + dt
    else:
        print(f"[timed] {label}: {dt:.4f}s")


def _load_xplane(logdir: str):
    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    return ProfileData.from_file(files[-1])


def trace_lanes(logdir: str) -> list[tuple[str, str, int, float]]:
    """Every (plane, line, events, total us) of the newest trace: the map to
    read before trusting which lines `summarize_trace` counts."""
    return [(plane.name, line.name, len(evs),
             sum(e.duration_ns for e in evs) / 1e3)
            for plane in _load_xplane(logdir).planes
            for line in plane.lines
            for evs in [list(line.events)]]


def _op_lines(plane):
    """The lines of ``plane`` whose events are individual device ops.

    A GPU plane (``/device:GPU:N``) has one line per CUDA stream
    ("Stream #13(Compute,Memset)"), whose events are the kernels XLA
    launched, named after their fusion or library kernel. On the CPU backend
    ops run on the XLA compute threads."""
    lines = list(plane.lines)
    streams = [ln for ln in lines if ln.name.startswith("Stream")]
    if streams:
        return streams
    return [ln for ln in lines if ln.name.startswith("tf_XLA")]


# (substring of the kernel name, category); the first match wins
_CATEGORIES = (
    ("gemm", "GEMM"),
    ("dot", "GEMM"),
    ("cudnn", "convolution"),
    ("convolution", "convolution"),
    ("nccl", "collective"),
    ("all-reduce", "collective"),
    ("all-gather", "collective"),
    ("collective-permute", "collective"),
    ("memset", "copy/memset"),
    ("memcpy", "copy/memset"),
    ("copy", "copy/memset"),
    ("transpose", "copy/memset"),
    ("gather", "gather fusion"),
    ("fusion", "elementwise fusion"),
)


def _busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def summarize_trace(logdir: str, top: int = 15) -> dict:
    """Reduce the newest trace under ``logdir`` to device time.

    Returns {"total_device_us", "window_us", "idle_share", "by_op":
    [(name, us, pct)], "by_category"}. Device planes are ``/device:*``; with
    none (CPU backend) the host compute threads stand in. ``idle_share`` is
    1 - busy/window on the busiest plane, where busy is the union of its op
    intervals and the window runs from its first op start to its last op end.
    """
    space = _load_xplane(logdir)
    planes = [p for p in space.planes if p.name.startswith("/device:")]
    if not planes:
        planes = [p for p in space.planes if p.name.startswith("/host:CPU")]
    op_us: dict[str, float] = defaultdict(float)
    idle, window_us = None, 0.0
    for plane in planes:
        intervals = []
        for line in _op_lines(plane):
            for ev in line.events:
                op_us[ev.name] += ev.duration_ns / 1e3
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        if not intervals:
            continue
        window = max(e for _, e in intervals) - min(s for s, _ in intervals)
        if window / 1e3 > window_us:
            window_us = window / 1e3
            idle = 1.0 - _busy_ns(intervals) / window if window else 0.0
    total = sum(op_us.values())
    by_cat: dict[str, float] = defaultdict(float)
    for name, us in op_us.items():
        low = name.lower()
        cat = next((c for key, c in _CATEGORIES if key in low), "other")
        by_cat[cat] += us
    by_op = sorted(op_us.items(), key=lambda kv: -kv[1])[:top]
    return {
        "total_device_us": round(total, 1),
        "window_us": round(window_us, 1),
        "idle_share": None if idle is None else round(idle, 4),
        "by_op": [(n, round(us, 1), round(100 * us / total, 1) if total else 0)
                  for n, us in by_op],
        "by_category": {k: round(v, 1) for k, v in
                        sorted(by_cat.items(), key=lambda kv: -kv[1])},
    }


def format_summary(summary: dict) -> str:
    lines = [f"device total: {summary['total_device_us']/1e3:.2f} ms over a "
             f"{summary['window_us']/1e3:.2f} ms window, idle share "
             f"{summary['idle_share']}"]
    lines.append("by category:")
    for cat, us in summary["by_category"].items():
        lines.append(f"  {cat:28s} {us/1e3:10.2f} ms")
    lines.append("top ops:")
    for name, us, pct in summary["by_op"]:
        lines.append(f"  {pct:5.1f}%  {us/1e3:9.2f} ms  {name[:80]}")
    return "\n".join(lines)
