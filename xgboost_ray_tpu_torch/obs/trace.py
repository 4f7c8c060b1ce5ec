"""Span tracer: bounded ring buffer, JSONL export and timeline helpers.

Port of ``xgboost_ray_tpu/obs/trace.py`` (``:126-440``): ``Tracer``,
``get_tracer``, ``set_default_tracer``, ``use_tracer``,
``validate_trace_records`` and ``recovery_time_s``, with the same record
schema and event names (``TRACE_NAMES``). One record per finished span or
instantaneous event, a plain JSON dict:

``{"kind": "span" | "event", "name": str, "ts": float (epoch seconds),
"seq": int (monotonic per tracer), "dur_s": float (spans only),
"parent": int | None (enclosing span's seq, spans only),
"round": int (optional), "attrs": dict (optional)}``

Records live in a ring buffer of ``RXGB_TRACE_CAPACITY`` (default 8192);
an overflow drops the oldest record and counts it (``dropped``). Spans nest
through a thread-local stack. With ``RXGB_TRACE_DIR`` (or ``trace_dir=``)
every record is also appended to ``<dir>/trace-rank<k>.jsonl``, k the
process's ``torch.distributed`` rank when a group is initialised. The serve
plane emits here: ``serve.route`` per dispatch, ``serve.replica_up`` /
``serve.replica_down`` per pool change, ``serve.scale`` per autoscaler
decision, and the canary's ``serve.shadow`` then ``serve.rollback`` or
``serve.promote``, so a replica loss, a scale cycle and a publish can each
be read back from the timeline alone.
"""

import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "TRACE_NAMES",
    "Tracer",
    "get_tracer",
    "set_default_tracer",
    "use_tracer",
    "validate_trace_records",
    "recovery_time_s",
]

_DEFAULT_CAPACITY = 8192

#: The catalog of span and event names: the JAX package's, kept whole so
#: that timelines of both packages validate against one vocabulary (the
#: optional ``known_names`` of :func:`validate_trace_records`). The port
#: emits the serve names so far.
TRACE_NAMES = frozenset({
    # training rounds and their phases
    "round", "sample", "hist", "split", "partition", "margin", "allreduce",
    # streamed ingestion and its reuse after a world change
    "data.sketch_chunk", "data.bin_chunk", "data.h2d", "data.cuts_merge",
    "data.bin_reuse",
    # the training loop's lifecycle
    "attempt", "failure.detected", "recovered", "backoff",
    "world.shrink", "world.grow", "world.resume", "world.restart",
    "checkpoint.commit", "allreduce.bytes",
    # failure domains
    "world.domain_down", "world.domain_up", "world.deaths_coalesced",
    # elastic scheduling and the launcher
    "elastic.reschedule", "elastic.ready",
    "launcher.spawn", "launcher.hung", "launcher.attempt_failed",
    "checkpoint.load",
    # fault injection
    "fault.injected",
    # vectorised hyperparameter search
    "hpo.lane_prune", "hpo.repack",
    # serving (serve/pool.py, serve/autoscale.py, serve/canary.py): a route
    # event per replica dispatch, replica_up / replica_down per pool change
    # (reason: startup | scale_up | scale_down | rejoin | killed |
    # shutdown), a scale event per autoscaler decision (direction, from / to
    # replica counts, the p99 / queue evidence), and the canary's verdict
    # pair: shadow, then rollback or promote
    "serve.route", "serve.replica_up", "serve.replica_down", "serve.scale",
    "serve.shadow", "serve.rollback", "serve.promote",
})


def _process_rank() -> int:
    """This process's rank for trace-file naming: the ``torch.distributed``
    rank when a process group is initialised, else 0."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 - tracing must never fail the caller
        pass
    return 0


class Tracer:
    """Span/event recorder with a bounded ring buffer.

    ``enabled`` defaults from ``RXGB_TRACE`` (on unless ``"0"``);
    ``capacity`` from ``RXGB_TRACE_CAPACITY``; ``trace_dir`` from
    ``RXGB_TRACE_DIR`` (empty = no streaming). A disabled tracer's
    ``span()``/``event()`` are near-free no-ops.
    """

    def __init__(
        self,
        capacity: Optional[int] = None,
        enabled: Optional[bool] = None,
        trace_dir: Optional[str] = None,
        rank: Optional[int] = None,
    ):
        if enabled is None:
            enabled = os.environ.get("RXGB_TRACE", "1") != "0"
        if capacity is None:
            capacity = int(
                os.environ.get("RXGB_TRACE_CAPACITY", str(_DEFAULT_CAPACITY))
            )
        if trace_dir is None:
            trace_dir = os.environ.get("RXGB_TRACE_DIR", "")
        self.enabled = bool(enabled)
        self.capacity = max(1, int(capacity))
        self._buf: collections.deque = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._seq = 0
        self._dropped = 0
        self._trace_dir = trace_dir or ""
        self._rank = rank
        self._stream_file = None
        self._stream_failed = False

    # -- recording ----------------------------------------------------------

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def _next_seq_locked(self) -> int:
        # _locked suffix: the caller holds self._lock
        self._seq += 1
        return self._seq

    def _append(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self._dropped += 1
            self._buf.append(rec)
            self._stream_locked(rec)

    def _stream_locked(self, rec: Dict[str, Any]) -> None:
        """Append one JSON line to the per-rank trace file (best-effort;
        caller holds the lock)."""
        if not self._trace_dir or self._stream_failed:
            return
        try:
            if self._stream_file is None:
                rank = self._rank if self._rank is not None else _process_rank()
                self._rank = rank
                os.makedirs(self._trace_dir, exist_ok=True)
                path = os.path.join(self._trace_dir, f"trace-rank{rank}.jsonl")
                self._stream_file = open(path, "a", buffering=1)
            # default=str: attrs are caller-supplied (span() hands out the
            # mutable dict) — a numpy scalar or exotic value must degrade to
            # its string form, never raise out of the instrumented code
            self._stream_file.write(json.dumps(rec, default=str) + "\n")
        except Exception:  # noqa: BLE001 - tracing must never fail the caller
            # a dead disk must not take training down; the in-memory ring
            # still has the records
            self._stream_failed = True

    @contextlib.contextmanager
    def span(self, name: str, round: Optional[int] = None, **attrs):
        """Context manager recording one fenced span; yields the (mutable)
        attrs dict so callers can attach results measured inside."""
        if not self.enabled:
            yield attrs
            return
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        with self._lock:
            seq = self._next_seq_locked()
        parent = stack[-1] if stack else None
        stack.append(seq)
        ts = time.time()
        t0 = time.perf_counter()
        try:
            yield attrs
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            self._finish_span(name, ts, dur, seq, parent, round, attrs)

    def add_span(
        self,
        name: str,
        ts: float,
        dur_s: float,
        round: Optional[int] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record an externally-timed span (no nesting bookkeeping)."""
        if not self.enabled:
            return
        with self._lock:
            seq = self._next_seq_locked()
        stack = getattr(self._tls, "stack", None)
        parent = stack[-1] if stack else None
        self._finish_span(name, ts, dur_s, seq, parent, round, attrs)

    def _finish_span(self, name, ts, dur_s, seq, parent, round, attrs):
        rec: Dict[str, Any] = {
            "kind": "span",
            "name": name,
            "ts": ts,
            "seq": seq,
            "dur_s": float(dur_s),
            "parent": parent,
        }
        if round is not None:
            rec["round"] = int(round)
        if attrs:
            rec["attrs"] = dict(attrs)
        self._append(rec)

    def event(
        self,
        name: str,
        round: Optional[int] = None,
        attrs: Optional[Dict[str, Any]] = None,
        **kw,
    ) -> None:
        """Record one instantaneous event; attributes may come as an
        ``attrs`` dict, keyword arguments, or both (merged, kwargs win)."""
        if not self.enabled:
            return
        merged = dict(attrs) if attrs else {}
        merged.update(kw)
        with self._lock:
            seq = self._next_seq_locked()
        rec: Dict[str, Any] = {
            "kind": "event",
            "name": name,
            "ts": time.time(),
            "seq": seq,
        }
        if round is not None:
            rec["round"] = int(round)
        if merged:
            rec["attrs"] = merged
        self._append(rec)

    # -- reading / export ---------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        """Snapshot of the ring buffer (oldest first)."""
        with self._lock:
            return list(self._buf)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "records": len(self._buf),
                "dropped_spans": self._dropped,
                "capacity": self.capacity,
            }

    def export_jsonl(self, path: str) -> int:
        """Write the buffered records as JSON lines; returns record count.
        Non-JSON-serializable attr values degrade to their string form."""
        recs = self.records()
        with open(path, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec, default=str) + "\n")
        return len(recs)

    def close(self) -> None:
        with self._lock:
            if self._stream_file is not None:
                try:
                    self._stream_file.close()
                except OSError:  # pragma: no cover - close is best-effort
                    pass
                self._stream_file = None


# ---------------------------------------------------------------------------
# current-tracer plumbing: thread-local install (train() scopes a fresh
# tracer per run) over a lazily-created process default (launcher-level
# spans outside any train() land there).
# ---------------------------------------------------------------------------

_default_tracer: Optional[Tracer] = None
_default_lock = threading.Lock()
_tls = threading.local()


def get_tracer() -> Tracer:
    """The thread's installed tracer, else the process-default tracer."""
    current = getattr(_tls, "current", None)
    if current is not None:
        return current
    global _default_tracer
    if _default_tracer is None:
        with _default_lock:
            if _default_tracer is None:
                _default_tracer = Tracer()
    return _default_tracer


def set_default_tracer(tracer: Optional[Tracer]) -> None:
    """Replace the process-default tracer (None resets to lazy re-create)."""
    global _default_tracer
    _default_tracer = tracer


@contextlib.contextmanager
def use_tracer(tracer: Tracer):
    """Install ``tracer`` as this thread's current tracer for the scope."""
    prev = getattr(_tls, "current", None)
    _tls.current = tracer
    try:
        yield tracer
    finally:
        _tls.current = prev


# ---------------------------------------------------------------------------
# schema validation + timeline queries
# ---------------------------------------------------------------------------

_ALLOWED_KEYS = {"kind", "name", "ts", "seq", "dur_s", "parent", "round", "attrs"}


def validate_trace_records(
    records: Iterable[Dict[str, Any]],
    known_names: Optional[Iterable[str]] = None,
) -> List[str]:
    """Validate records against the trace schema; returns a list of problem
    strings (empty = valid).

    ``known_names`` opts into vocabulary checking: pass :data:`TRACE_NAMES`
    (or any custom set) and a record whose ``name`` is outside it becomes a
    problem.
    The default (``None``) keeps the historical schema-only behavior."""
    problems: List[str] = []
    seen_seq = set()
    name_vocab = None if known_names is None else set(known_names)
    for i, rec in enumerate(records):
        where = f"record {i}"
        if not isinstance(rec, dict):
            problems.append(f"{where}: not a dict")
            continue
        unknown = set(rec) - _ALLOWED_KEYS
        if unknown:
            problems.append(f"{where}: unknown keys {sorted(unknown)}")
        kind = rec.get("kind")
        if kind not in ("span", "event"):
            problems.append(f"{where}: bad kind {kind!r}")
        name = rec.get("name")
        if not isinstance(name, str) or not name:
            problems.append(f"{where}: bad name {name!r}")
        elif name_vocab is not None and name not in name_vocab:
            problems.append(f"{where}: unknown name {name!r}")
        if not isinstance(rec.get("ts"), (int, float)):
            problems.append(f"{where}: bad ts {rec.get('ts')!r}")
        seq = rec.get("seq")
        if not isinstance(seq, int):
            problems.append(f"{where}: bad seq {seq!r}")
        elif seq in seen_seq:
            problems.append(f"{where}: duplicate seq {seq}")
        else:
            seen_seq.add(seq)
        if kind == "span":
            dur = rec.get("dur_s")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: bad dur_s {dur!r}")
            parent = rec.get("parent")
            if parent is not None and not isinstance(parent, int):
                problems.append(f"{where}: bad parent {parent!r}")
        if "round" in rec and not isinstance(rec["round"], int):
            problems.append(f"{where}: bad round {rec['round']!r}")
        if "attrs" in rec and not isinstance(rec["attrs"], dict):
            problems.append(f"{where}: bad attrs {rec['attrs']!r}")
        if kind == "event" and "dur_s" in rec:
            problems.append(f"{where}: event carries dur_s")
    return problems


def recovery_time_s(records: Iterable[Dict[str, Any]]) -> float:
    """Total failure→first-forward-progress time reconstructed from the
    timeline: each ``recovered`` event closes the clock opened by the most
    recent ``failure.detected`` event (the JAX package's
    ``time_to_recover_s`` accounting, which restarts the clock on repeated
    failures before progress)."""
    total = 0.0
    last_failure: Optional[float] = None
    for rec in records:
        if rec.get("kind") != "event":
            continue
        if rec.get("name") == "failure.detected":
            last_failure = float(rec["ts"])
        elif rec.get("name") == "recovered" and last_failure is not None:
            total += max(0.0, float(rec["ts"]) - last_failure)
            last_failure = None
    return total
