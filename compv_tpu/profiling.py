"""Profiling / tracing / observability helpers.

Reference (SURVEY.md §5): millisecond timers (CompVTime::nowMillis) around
sections + log-based perf annotations; no real profiler. Equivalents here:
  * Timer / timed(): wall-clock section timers that block on device work.
  * trace(): context manager around jax.profiler traces (TensorBoard files).
  * device_memory_stats(): live device-memory usage per device.
  * collective_stats(): collective counts and payload bytes of a traced
    program.
  * log: leveled logger with pluggable sinks (CompVDebugMgr analogue,
    base/include/compv/base/compv_debug.h:32-59).
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List

import jax

__all__ = ["Timer", "timed", "trace", "device_memory_stats",
           "collective_stats", "Log", "log"]


class Timer:
    """Accumulating section timer (ms), blocking on async device work."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        dt = (time.perf_counter() - t0) * 1000.0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            n = self.counts[k]
            lines.append(f"{k}: {self.totals[k]:.2f} ms total, "
                         f"{self.totals[k] / n:.3f} ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def timed(name: str = "section"):
    t0 = time.perf_counter()
    yield
    print(f"[compv_tpu] {name}: {(time.perf_counter() - t0) * 1000:.2f} ms")


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace -> TensorBoard/perfetto files in ``logdir``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats() -> List[dict]:
    out = []
    for d in jax.devices():
        try:
            s = d.memory_stats() or {}
        except Exception:
            s = {}
        out.append({"device": str(d),
                    "bytes_in_use": s.get("bytes_in_use", -1),
                    "bytes_limit": s.get("bytes_limit", -1)})
    return out


_COLLECTIVES = ("psum", "all_gather", "reduce_scatter", "psum_scatter",
                "ppermute", "all_to_all", "all_reduce")


def collective_stats(closed_jaxpr, loop_mult: int = 1):
    """Count collective primitives and their payload bytes in a traced
    program (``jax.make_jaxpr(fn)(*args)``). Equations inside while/scan
    bodies are multiplied by ``loop_mult`` (e.g. a CG trip count) — stated,
    not guessed. Returns ({primitive: count}, payload bytes)."""
    from jax.extend import core as jcore

    counts: Dict[str, int] = {}
    payload = [0]

    def sub_jaxprs(v):
        if isinstance(v, jcore.ClosedJaxpr):
            yield v.jaxpr
        elif isinstance(v, jcore.Jaxpr):
            yield v
        elif isinstance(v, (tuple, list)):
            for x in v:
                yield from sub_jaxprs(x)

    def visit(jaxpr, mult):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            inner = mult * (loop_mult if name in ("while", "scan") else 1)
            for v in eqn.params.values():
                for sub in sub_jaxprs(v):
                    visit(sub, inner)
            if name.startswith(_COLLECTIVES):
                counts[name] = counts.get(name, 0) + mult
                for iv in eqn.invars:
                    aval = getattr(iv, "aval", None)
                    if aval is not None and hasattr(aval, "size"):
                        payload[0] += mult * aval.size * aval.dtype.itemsize

    visit(closed_jaxpr.jaxpr, 1)
    return counts, int(payload[0])


class Log:
    """Leveled logger with pluggable sinks (CompVDebugMgr analogue)."""

    LEVELS = {"verbose": 0, "info": 1, "warn": 2, "error": 3, "fatal": 4}

    def __init__(self):
        self.level = "info"
        self.sinks: Dict[str, List[Callable[[str], None]]] = {}

    def add_sink(self, level: str, fn: Callable[[str], None]) -> None:
        self.sinks.setdefault(level, []).append(fn)

    def _emit(self, level: str, msg: str) -> None:
        if self.LEVELS[level] < self.LEVELS[self.level]:
            return
        line = f"[compv_tpu {level.upper()}] {msg}"
        sinks = self.sinks.get(level)
        if sinks:
            for fn in sinks:
                fn(line)
        else:
            print(line, flush=True)   # logs must survive piped/buffered IO

    def verbose(self, msg):
        self._emit("verbose", msg)

    def info(self, msg):
        self._emit("info", msg)

    def warn(self, msg):
        self._emit("warn", msg)

    def error(self, msg):
        self._emit("error", msg)


log = Log()
