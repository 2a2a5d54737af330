"""Unified telemetry plane: metrics registry, span tracing, Prometheus text.

The survey compares distributed GNN systems on communication volume,
staleness, cache effectiveness, and per-stage latency — exactly the
quantities this repo computes but historically scattered across ad-hoc
counters (``Transport.payload_bytes``, ``EmbeddingCache.hits``,
``ServeStats`` latency lists).  This module is the one place those
numbers flow through:

* :class:`MetricsRegistry` — process-local registry of :class:`Counter`,
  :class:`Gauge`, and :class:`Histogram` metrics keyed by
  ``(name, labels)``.  Asking twice for the same key returns the same
  instance, so independent subsystems (e.g. every
  :class:`~repro_torch.core.comm.Transport` on one path) aggregate into one
  series.  The whole plane sits behind a global enable flag: a record
  against a disabled registry costs one attribute read and one branch.
* :class:`Histogram` — fixed log-spaced buckets for Prometheus
  exposition *plus* the raw samples, so :meth:`Histogram.quantile` is
  exact (``numpy``-style linear interpolation, property-tested against
  ``numpy.percentile``).
* :class:`Tracer` — a lightweight span tracer:
  ``with span("serve.batch"):`` nests via a thread-local stack and each
  span may carry its own clock (``clock=``), which is how serving's
  *virtual* clock produces spans in simulated time.  Export is JSONL,
  one event per line (schema in ``docs/observability.md``).
* :meth:`MetricsRegistry.to_prometheus` — Prometheus text-format
  exposition (``# HELP`` / ``# TYPE`` + cumulative ``_bucket``/``_sum``/
  ``_count`` series); :func:`parse_prometheus` is the matching
  stdlib-only validator the smoke stages use.
* :meth:`MetricsRegistry.snapshot` — a plain-dict view for benchmarks
  and SLO assertions (``BENCH_serving.json``).

Instrumented producers: the communication plane
(:class:`~repro_torch.core.comm.Transport` per-(path, codec) byte/row/send
counters), caching (:class:`~repro_torch.core.caching.FeatureStore` and
:class:`~repro_torch.serving.cache.EmbeddingCache` hit/miss counters), halos
(:class:`~repro_torch.core.halo.HaloExchange` refresh rows, ghost-age
histogram, staleness-violation guard), serving
(:class:`~repro_torch.serving.server.GNNInferenceServer` queue depth, batch
occupancy, latency histograms, virtual-clock spans), training step-time
histograms and prefetcher stall time, and kernel dispatch counters
(:mod:`repro_torch.kernels.ops`).  Enable with ``--metrics-out`` /
``--trace-out`` on ``launch/{train_gnn,serve_gnn}.py`` or
:func:`set_enabled`.
"""
from __future__ import annotations

import json
import math
import re
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
# Prometheus exposition lines: `name{label="v",...} value` (labels optional)
_PROM_SAMPLE_RE = re.compile(
    r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([^\s]+)$')
_PROM_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> Tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds covering ``[lo, hi]`` with
    ``per_decade`` buckets per decade — the one bucket-layout generator,
    so every histogram in the repo is comparable."""
    if not (lo > 0 and hi > lo and per_decade >= 1):
        raise ValueError("need 0 < lo < hi and per_decade >= 1")
    n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    return tuple(lo * 10 ** (i / per_decade) for i in range(n))


# seconds: 10 µs .. 100 s, 4/decade — covers batch compute through epochs
DEFAULT_TIME_BUCKETS = log_buckets(1e-5, 1e2, 4)
# dimensionless small ints (ages, depths, occupancies): 1 .. 1e4
DEFAULT_COUNT_BUCKETS = log_buckets(1.0, 1e4, 4)


class _Metric:
    """Base: a named, labeled series owned by (at most) one registry.

    ``registry=None`` builds a *standalone* always-on metric (e.g. the
    :class:`~repro_torch.serving.server.ServeStats` latency histogram, which
    must record regardless of the global telemetry flag); a
    registry-owned metric records only while the registry is enabled —
    the one branch per record the module docstring promises.
    """

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 registry: Optional["MetricsRegistry"] = None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labels: Dict[str, str] = {k: str(v)
                                       for k, v in (labels or {}).items()}
        self._reg = registry

    @property
    def _on(self) -> bool:
        reg = self._reg
        return reg is None or reg.enabled


class Counter(_Metric):
    """Monotonically increasing count (bytes, rows, hits, dispatches)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels=None, registry=None):
        super().__init__(name, help, labels, registry)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        """Add ``amount`` (must be >= 0) to the count; no-op while the
        owning registry is disabled."""
        if not self._on:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += amount

    def reset(self) -> None:
        """Zero the count (warmup exclusion; see ``Transport.reset_counters``)."""
        self.value = 0.0


class Gauge(_Metric):
    """A value that can go up and down (queue depth, modeled bytes/call)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels=None, registry=None):
        super().__init__(name, help, labels, registry)
        self.value = 0.0

    def set(self, value: float) -> None:
        """Set the gauge; no-op while the owning registry is disabled."""
        if self._on:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        """Add ``amount`` (may be negative)."""
        if self._on:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        """Subtract ``amount``."""
        self.inc(-amount)

    def reset(self) -> None:
        """Zero the gauge."""
        self.value = 0.0


class Histogram(_Metric):
    """Distribution metric: fixed log-spaced buckets + bounded-memory
    exact-then-estimated quantiles.

    Bucket counts feed the Prometheus exposition (cumulative ``_bucket``
    series with ``+Inf``) and are always exact.  Raw samples are kept
    alongside in a *bounded reservoir* of ``max_samples`` float32 values
    (Vitter's Algorithm R, fixed-seed rng for reproducibility): while the
    observation count is at or below the cap, :meth:`quantile`
    interpolates exactly like ``numpy.percentile`` (linear); past the
    cap, every past observation has equal probability of occupying a
    reservoir slot and :meth:`quantile` is an unbiased *estimate* over
    that uniform subsample (``saturated`` reports which regime the
    histogram is in).  ``sum``/``count`` and the bucket counts stay exact
    regardless — only the raw-sample memory is bounded, fixing the
    unbounded growth the pre-reservoir implementation had under
    sustained serving traffic.
    """

    kind = "histogram"

    # default raw-sample cap: 64Ki float32 = 256 KiB per series, far above
    # this repo's test/bench run lengths (those stay exact) and a hard
    # bound under production-length traffic
    DEFAULT_MAX_SAMPLES = 65536

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                 labels=None, registry=None,
                 max_samples: int = DEFAULT_MAX_SAMPLES):
        super().__init__(name, help, labels, registry)
        b = tuple(sorted(float(x) for x in buckets))
        if not b or any(x <= 0 for x in b):
            raise ValueError("buckets must be positive and non-empty")
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        self.buckets = b
        self.bucket_counts = np.zeros(len(b), np.int64)
        self.sum = 0.0
        self.max_samples = int(max_samples)
        self._samples: List[np.ndarray] = []
        self._n_samples = 0              # rows held across self._samples
        self._rng = np.random.default_rng(0)
        self.count = 0

    @property
    def saturated(self) -> bool:
        """True once the reservoir has been capped — quantiles are
        estimates over a uniform subsample from here on."""
        return self.count > self.max_samples

    def _reservoir_insert(self, v: np.ndarray, start_t: int) -> None:
        """Algorithm R: fold new values into the full reservoir.
        ``start_t`` is the 1-based observation index of ``v[0]``."""
        res = self.samples                     # consolidates to one array
        t = start_t + np.arange(len(v))        # observation index of each
        j = (self._rng.random(len(v)) * t).astype(np.int64)
        keep = j < self.max_samples
        # later duplicates of one slot overwrite earlier ones — the same
        # outcome as processing the stream one element at a time
        res[j[keep]] = v[keep]

    def _record(self, v: np.ndarray) -> None:
        """Shared bucket/sum/reservoir update for one batch of values."""
        self.sum += float(v.sum())
        idx = np.searchsorted(self.buckets, v, side="left")
        np.add.at(self.bucket_counts, idx[idx < len(self.buckets)], 1)
        room = self.max_samples - self._n_samples
        head, tail = v[:room], v[room:]
        if len(head):
            self._samples.append(head.astype(np.float32))
            self._n_samples += len(head)
        if len(tail):
            self._reservoir_insert(tail.astype(np.float32),
                                   self.count + len(head) + 1)
        self.count += len(v)

    def observe(self, value: float) -> None:
        """Record one sample; no-op while the owning registry is disabled."""
        if not self._on:
            return
        self._record(np.array([value], np.float64))

    def observe_batch(self, values: np.ndarray) -> None:
        """Vectorized :meth:`observe` for per-row quantities (e.g. the
        ghost-age distribution of a whole refresh plan in one call)."""
        if not self._on:
            return
        v = np.asarray(values, np.float64).ravel()
        if len(v):
            self._record(v)

    @property
    def samples(self) -> np.ndarray:
        """The retained raw samples (float32).  Below the reservoir cap
        this is every observation in observation order; above it, a
        uniform ``max_samples``-sized subsample of the stream."""
        if not self._samples:
            return np.zeros(0, np.float32)
        if len(self._samples) > 1:
            self._samples = [np.concatenate(self._samples)]
        return self._samples[0]

    def quantile(self, q: float) -> float:
        """``q``-quantile of the retained samples (numpy linear
        interpolation; 0.0 when empty).  Exact until the reservoir
        saturates (``count > max_samples``), an unbiased estimate after."""
        s = self.samples
        return float(np.quantile(s, q)) if len(s) else 0.0

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """Prometheus-style cumulative ``(le, count)`` pairs ending with
        ``(+inf, count)``."""
        cum = np.cumsum(self.bucket_counts)
        out = [(le, int(c)) for le, c in zip(self.buckets, cum)]
        out.append((math.inf, self.count))
        return out

    def reset(self) -> None:
        """Drop all samples and bucket counts (the reservoir cap and rng
        state survive — a reset histogram starts a fresh exact regime)."""
        self.bucket_counts[:] = 0
        self.sum = 0.0
        self.count = 0
        self._samples = []
        self._n_samples = 0


class SpanError(RuntimeError):
    """Raised on malformed tracer usage (exit without matching enter)."""


class Tracer:
    """Nesting span tracer with pluggable clocks and JSONL export.

    ``with tracer.span("serve.batch", bucket=16):`` records one event on
    exit: ``{seq, name, ts, dur, depth, parent, attrs}`` where ``ts`` is
    the span's start on its clock, ``depth`` the nesting level (0 = root)
    and ``parent`` the enclosing span's name (``None`` at the root).  The
    stack is thread-local, so prefetcher-thread spans nest independently
    of the main thread's.

    Clocks: the default is ``time.perf_counter`` (wall).  A span may
    override with ``clock=``, which is how serving traces in *virtual*
    time — the server passes a callable that maps wall progress onto its
    simulated clock, so queueing delay and compute show up on the same
    axis as the reported p50/p99 (see
    ``GNNInferenceServer._virtual_now``).

    Recording is gated on the owning registry's enable flag (one branch
    per span); a disabled tracer's ``span`` still yields, costing only
    the context-manager machinery.
    """

    def __init__(self, registry: Optional["MetricsRegistry"] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self._reg = registry
        self.clock = clock
        self.events: List[dict] = []
        self._local = threading.local()
        self._seq = 0

    @property
    def _on(self) -> bool:
        reg = self._reg
        return reg is None or reg.enabled

    def _stack(self) -> List[str]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextmanager
    def span(self, name: str, clock: Optional[Callable[[], float]] = None,
             **attrs):
        """Context manager recording one span event on exit (see class
        docstring for the event schema)."""
        if not self._on:
            yield
            return
        clk = clock or self.clock
        stack = self._stack()
        parent = stack[-1] if stack else None
        depth = len(stack)
        stack.append(name)
        t0 = clk()
        try:
            yield
        finally:
            dur = clk() - t0
            popped = stack.pop()
            if popped != name:
                raise SpanError(f"span stack corrupted: popped {popped!r}, "
                                f"expected {name!r}")
            self.events.append({
                "seq": self._seq, "name": name, "ts": t0, "dur": dur,
                "depth": depth, "parent": parent,
                "attrs": {k: v for k, v in attrs.items()},
            })
            self._seq += 1

    def export_jsonl(self, path: str) -> int:
        """Write one JSON object per event line; returns the event count."""
        with open(path, "w", encoding="utf-8") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return len(self.events)

    def reset(self) -> None:
        """Drop recorded events (the per-thread stacks survive — resetting
        mid-span keeps nesting coherent for later events)."""
        self.events = []
        self._seq = 0


class MetricsRegistry:
    """Process-local registry: the one place every subsystem's counters,
    gauges, histograms, and spans live.

    ``counter/gauge/histogram(name, **labels)`` get-or-create: the same
    ``(name, labels)`` key always returns the same instance, so two
    :class:`~repro_torch.core.comm.Transport` objects on the same path
    aggregate into one series — the behavior the cross-Transport
    aggregation test pins.  A name must keep one metric kind across all
    label sets.

    ``enabled=False`` makes every record on every owned metric (and every
    span of the owned :class:`Tracer`) a single-branch no-op; flip it
    with :func:`set_enabled` (module level) or ``registry.enabled``.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: Dict[Tuple[str, LabelKey], _Metric] = {}
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()
        self.tracer = Tracer(registry=self)

    # -- get-or-create -----------------------------------------------------
    def _get(self, cls, name: str, help: str, labels: Dict[str, str],
             **kwargs) -> _Metric:
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                if self._kinds.setdefault(name, cls.kind) != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{self._kinds[name]}, not {cls.kind}")
                m = cls(name, help, labels=labels, registry=self, **kwargs)
                self._metrics[key] = m
                if help:
                    self._help.setdefault(name, help)
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        """Get-or-create the :class:`Counter` for ``(name, labels)``."""
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        """Get-or-create the :class:`Gauge` for ``(name, labels)``."""
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  max_samples: int = Histogram.DEFAULT_MAX_SAMPLES,
                  **labels) -> Histogram:
        """Get-or-create the :class:`Histogram` for ``(name, labels)``
        (``buckets``/``max_samples`` apply only on first creation)."""
        return self._get(Histogram, name, help, labels, buckets=buckets,
                         max_samples=max_samples)

    def span(self, name: str, clock=None, **attrs):
        """Shorthand for ``registry.tracer.span(...)``."""
        return self.tracer.span(name, clock=clock, **attrs)

    # -- reads -------------------------------------------------------------
    def collect(self) -> List[_Metric]:
        """All registered metrics, sorted by ``(name, labels)``."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def value(self, name: str, **labels) -> float:
        """Value of one counter/gauge series (0.0 if never registered)."""
        m = self._metrics.get((name, _label_key(labels)))
        return float(m.value) if m is not None else 0.0

    def total(self, name: str, **label_filter) -> float:
        """Sum of every counter/gauge series named ``name`` whose labels
        contain ``label_filter`` — e.g. ``total("comm_bytes_total",
        path="serving.features")`` sums payload and header kinds."""
        want = set(_label_key(label_filter))
        return float(sum(
            m.value for m in self.collect()
            if m.name == name and not isinstance(m, Histogram)
            and want <= set(_label_key(m.labels))))

    def get_histogram(self, name: str, **labels) -> Optional[Histogram]:
        """The histogram for ``(name, labels)`` or ``None``."""
        m = self._metrics.get((name, _label_key(labels)))
        return m if isinstance(m, Histogram) else None

    def snapshot(self) -> dict:
        """Plain-dict view of every series — counters/gauges as values,
        histograms as ``{count, sum, p50, p99}`` — keyed by name then by
        a ``k=v,...`` label string (``""`` for unlabeled)."""
        out: Dict[str, dict] = {}
        for m in self.collect():
            lk = ",".join(f"{k}={v}" for k, v in _label_key(m.labels))
            entry = out.setdefault(m.name, {"kind": m.kind, "series": {}})
            if isinstance(m, Histogram):
                entry["series"][lk] = {
                    "count": m.count, "sum": m.sum,
                    "p50": m.quantile(0.50), "p99": m.quantile(0.99)}
            else:
                entry["series"][lk] = m.value
        return out

    # -- exposition --------------------------------------------------------
    @staticmethod
    def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in _label_key(labels)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def to_prometheus(self) -> str:
        """Prometheus text-format exposition of every registered series."""
        by_name: Dict[str, List[_Metric]] = {}
        for m in self.collect():
            by_name.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(by_name):
            ms = by_name[name]
            help_ = self._help.get(name) or ms[0].help
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {ms[0].kind}")
            for m in ms:
                if isinstance(m, Histogram):
                    for le, c in m.cumulative_buckets():
                        le_s = "+Inf" if math.isinf(le) else repr(le)
                        lab = self._fmt_labels(m.labels,
                                               'le="%s"' % le_s)
                        lines.append(f"{name}_bucket{lab} {c}")
                    lab = self._fmt_labels(m.labels)
                    lines.append(f"{name}_sum{lab} {repr(m.sum)}")
                    lines.append(f"{name}_count{lab} {m.count}")
                else:
                    v = m.value
                    v_s = repr(v) if v != int(v) else str(int(v))
                    lines.append(f"{name}{self._fmt_labels(m.labels)} {v_s}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str) -> None:
        """Write :meth:`to_prometheus` output to ``path``."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(self.to_prometheus())

    def reset(self) -> None:
        """Zero every metric and drop trace events (metric identities and
        bucket layouts survive — warmup exclusion, not teardown)."""
        for m in self.collect():
            m.reset()
        self.tracer.reset()


# ---------------------------------------------------------------------------
# the module-level default registry (the instrumented hot paths' sink)
# ---------------------------------------------------------------------------

# Disabled by default: an uninstrumented run pays one branch per record.
# Launchers enable it when --metrics-out/--trace-out is passed; tests and
# benches via set_enabled(True).
_REGISTRY = MetricsRegistry(enabled=False)


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every instrumented path records
    into."""
    return _REGISTRY


def set_enabled(on: bool) -> bool:
    """Flip the global telemetry flag; returns the previous value."""
    prev = _REGISTRY.enabled
    _REGISTRY.enabled = bool(on)
    return prev


def enabled() -> bool:
    """Whether the default registry is recording."""
    return _REGISTRY.enabled


def counter(name: str, help: str = "", **labels) -> Counter:
    """``get_registry().counter(...)``."""
    return _REGISTRY.counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    """``get_registry().gauge(...)``."""
    return _REGISTRY.gauge(name, help, **labels)


def histogram(name: str, help: str = "",
              buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
              **labels) -> Histogram:
    """``get_registry().histogram(...)``."""
    return _REGISTRY.histogram(name, help, buckets=buckets, **labels)


def span(name: str, clock=None, **attrs):
    """``get_registry().span(...)``."""
    return _REGISTRY.span(name, clock=clock, **attrs)


# ---------------------------------------------------------------------------
# exposition validation (stdlib-only; the obs smoke + tests use this)
# ---------------------------------------------------------------------------

def parse_prometheus(text: str) -> Dict[str, Dict[LabelKey, float]]:
    """Parse (and validate) Prometheus text format back into
    ``{series_name: {label_key: value}}``; raises ``ValueError`` on any
    malformed line.  ``series_name`` includes the ``_bucket``/``_sum``/
    ``_count`` suffixes of histogram series."""
    out: Dict[str, Dict[LabelKey, float]] = {}
    typed: Dict[str, str] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in ("counter", "gauge",
                                                   "histogram"):
                raise ValueError(f"line {i}: malformed TYPE: {line!r}")
            typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            if not line.startswith("# HELP "):
                raise ValueError(f"line {i}: unknown comment: {line!r}")
            continue
        m = _PROM_SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {i}: malformed sample: {line!r}")
        name, labels_s, value_s = m.groups()
        try:
            value = float(value_s.replace("+Inf", "inf"))
        except ValueError:
            raise ValueError(f"line {i}: bad value {value_s!r}")
        labels: Dict[str, str] = {}
        if labels_s:
            body = labels_s[1:-1]
            if body and not re.match(
                    r'^[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
                    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*$', body):
                raise ValueError(f"line {i}: malformed labels {labels_s!r}")
            labels = dict(_PROM_LABEL_RE.findall(body))
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if base not in typed and name not in typed:
            raise ValueError(f"line {i}: sample {name!r} has no TYPE line")
        out.setdefault(name, {})[_label_key(labels)] = value
    return out


def validate_trace_jsonl(path: str) -> int:
    """Validate a trace file written by :meth:`Tracer.export_jsonl`:
    every line is a JSON object with the span schema, ``seq`` is dense
    ascending, and depths are sane.  Returns the event count."""
    n = 0
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            ev = json.loads(line)
            for k in ("seq", "name", "ts", "dur", "depth", "parent",
                      "attrs"):
                if k not in ev:
                    raise ValueError(f"event {i}: missing key {k!r}")
            if ev["seq"] != i:
                raise ValueError(f"event {i}: seq {ev['seq']} not dense")
            if ev["dur"] < 0 or ev["depth"] < 0:
                raise ValueError(f"event {i}: negative dur/depth")
            if ev["depth"] == 0 and ev["parent"] is not None:
                raise ValueError(f"event {i}: root span with parent")
            if ev["depth"] > 0 and ev["parent"] is None:
                raise ValueError(f"event {i}: nested span without parent")
            n += 1
    return n
