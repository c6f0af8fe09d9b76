"""Process-wide scoped tracing of outstanding operations.

Reference: velox/common/process/TraceContext.h:50 (scoped counters of in-flight
operations, dumpable for forensics) and ThreadDebugInfo (query/task ids stamped
on threads).  Thread-safe; ``status()`` is the crash-forensics dump.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict

_lock = threading.Lock()
_live: Dict[str, int] = collections.defaultdict(int)
_totals: Dict[str, int] = collections.defaultdict(int)
_since: Dict[str, float] = {}
_thread_local = threading.local()


@contextlib.contextmanager
def trace_context(label: str):
    """Scoped 'operation in progress' marker (reference: TraceContext ctor/dtor)."""
    with _lock:
        _live[label] += 1
        _totals[label] += 1
        _since.setdefault(label, time.time())
    try:
        yield
    finally:
        with _lock:
            _live[label] -= 1
            if _live[label] == 0:
                del _live[label]
                _since.pop(label, None)


def status() -> str:
    """Reference: TraceContext::statusLine — dump of outstanding operations."""
    with _lock:
        now = time.time()
        lines = [
            f"{label}: live={count} total={_totals[label]} "
            f"oldest={now - _since.get(label, now):.1f}s"
            for label, count in sorted(_live.items())
        ]
    return "\n".join(lines) if lines else "(no outstanding operations)"


@contextlib.contextmanager
def xla_profile(log_dir: str):
    """Capture an XLA profiler trace around a query (view in
    TensorBoard/xprof).  The device-level analog of the reference's
    per-operator wall/CPU timers (SURVEY §5.1: 'add XLA profiler/trace
    integration'); host-side counters live in utils/stats + reporter."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def set_thread_query(query_id: str, task_id: str = "") -> None:
    """Reference: ThreadDebugInfo — stamp ids on the current thread."""
    _thread_local.query_id = query_id
    _thread_local.task_id = task_id


def thread_query() -> tuple:
    return (
        getattr(_thread_local, "query_id", None),
        getattr(_thread_local, "task_id", None),
    )
