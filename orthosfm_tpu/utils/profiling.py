"""Profiling utilities: phase wall timers + JAX device traces.

The reference's observability is coarse phase timers persisted to
time_measurements.txt (src/util/timing.cpp) plus per-stage prints. This module
keeps that surface (PhaseTimer) and adds what the reference lacks:
`device_trace` wraps a region in a jax.profiler trace whose output shows
per-op device time (XLA kernels, cuBLAS/cuDNN calls).
"""

from __future__ import annotations

import contextlib
import glob
import os
import time
from typing import Dict, List, Tuple


class PhaseTimer:
    """Named phase wall-clock timing (steady-clock analog of
    reference timing.h:19-31)."""

    def __init__(self):
        self._phases: List[Tuple[str, float]] = []
        self._current: str | None = None
        self._t0 = 0.0

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self._phases.append((name, time.monotonic() - t0))

    def elapsed(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self._phases:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        return "\n".join(f"{name}: {dt:.3f} s" for name, dt in self.elapsed().items())


# ---------------------------------------------------------------------------
# Sub-stage attribution (opt-in). When a collector is active, `stage(name)`
# regions accumulate wall time into it, with a device barrier on exit so async
# device work is attributed to the stage that enqueued it. When no collector
# is active, `stage` is a no-op AND inserts no barriers — the production
# pipeline keeps its deliberately pipelined dispatch (e.g. the octave chain in
# ops/sift.extract_batch).

_STAGES: "Dict[str, float] | None" = None


def _device_barrier() -> None:
    """Block until all previously enqueued device programs complete (a
    device executes one process's programs in stream order, so syncing a
    fresh trivial program fences everything enqueued before it)."""
    import jax
    import jax.numpy as jnp

    jax.block_until_ready(jax.jit(lambda: jnp.zeros(()))())


@contextlib.contextmanager
def collect_stages(out: Dict[str, float]):
    """Activate sub-stage collection into `out` for the enclosed region."""
    global _STAGES
    prev, _STAGES = _STAGES, out
    try:
        yield out
    finally:
        _STAGES = prev


@contextlib.contextmanager
def stage(name: str):
    """Attribute the enclosed region (incl. device work it enqueued) to
    `name` when a collector is active; free otherwise."""
    if _STAGES is None:
        yield
        return
    out = _STAGES
    t0 = time.monotonic()
    try:
        yield
    finally:
        try:
            _device_barrier()
        except Exception:  # pragma: no cover - profiling must never break prod
            pass
        out[name] = out.get(name, 0.0) + (time.monotonic() - t0)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler trace of the enclosed region (view with
    tensorboard --logdir=<logdir>). No-op on failure so production runs never
    break on profiling plumbing."""
    import jax

    started = False
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception:  # pragma: no cover
        pass
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:  # pragma: no cover
                pass


def device_op_summary(logdir: str, top: int = 15) -> List[dict]:
    """Reduce the newest jax.profiler trace under `logdir`, per device plane:
    the window from the first device operation's start to the last one's
    end, busy time (union of operation intervals; idle share = 1 − busy /
    window), and the `top` operations by summed device time with their
    counts. Operations are read from the plane's "XLA Ops" line where it
    has one, else from its stream lines."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                          "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb trace under {logdir}")
    out = []
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = {line.name: list(line.events) for line in plane.lines}
        source = ([n for n in lines if n == "XLA Ops"]
                  or [n for n in lines if n.startswith("Stream")])
        events = [e for n in source for e in lines[n]]
        if not events:
            continue
        totals: Dict[str, List[float]] = {}
        for e in events:
            t = totals.setdefault(e.name, [0.0, 0])
            t[0] += e.duration_ns
            t[1] += 1
        spans = [(e.start_ns, e.end_ns) for e in events]
        window = max(e for _, e in spans) - min(s for s, _ in spans)
        ops = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
        out.append({"plane": plane.name,
                    "lines": {n: len(ev) for n, ev in lines.items()},
                    "source": source, "window_ns": window,
                    "busy_ns": busy_ns(spans),
                    "ops": [(n, t, int(c)) for n, (t, c) in ops]})
    return out


def busy_ns(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, lo, hi = 0.0, None, None
    for s, e in sorted(spans):
        if hi is None or s > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return busy + (0.0 if hi is None else hi - lo)


def format_device_ops(summary: List[dict]) -> str:
    rows = []
    for p in summary:
        w, b = p["window_ns"], p["busy_ns"]
        rows.append(f"{p['plane']}: window {w / 1e6:.3f} ms, busy "
                    f"{b / 1e6:.3f} ms, idle share {1 - b / max(w, 1):.4f} "
                    f"(ops from {p['source'][:3]}; lines {p['lines']})")
        for name, t, c in p["ops"]:
            rows.append(f"  {t / 1e6:12.3f} ms {100 * t / max(b, 1):6.2f}% "
                        f"x{c:<6d} {name[:120]}")
    return "\n".join(rows)
