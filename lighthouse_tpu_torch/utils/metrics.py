"""Process-global metrics registry (reference:
``common/lighthouse_metrics/src/lib.rs`` — a lazy_static Prometheus
registry with counters/gauges/histograms AND label-vector families
(``IntCounterVec``/``HistogramVec`` behind ``try_create_*_vec`` +
``metrics::get_metric(&VEC, &[label])`` handles) used by every subsystem,
scraped by ``http_metrics``).

Same shape here: module-level registry, get-or-create metric handles,
``*_vec`` families whose :meth:`~_MetricVec.with_labels` returns a child
handle per label combination, and Prometheus text exposition (HELP/TYPE
headers, escaped help text and label values) for the metrics endpoint.
No external deps. The port's own copy of the JAX package's
``utils/metrics.py``: the same families, names and exposition format, in
a registry of its own.

Concurrency contract: every mutator and every exposition/quantile read
holds the metric's lock, so a scrape observes a consistent snapshot even
while hot paths observe into the same family from worker threads.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Sequence, Tuple


def _escape_help(s: str) -> str:
    """Prometheus text format: HELP text escapes backslash and newline."""
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    """Label values escape backslash, double-quote and newline — an
    adversarial peer id or engine name must not corrupt the scrape."""
    return (
        s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _label_str(names: Sequence[str], values: Sequence[str]) -> str:
    return ",".join(
        f'{n}="{_escape_label_value(v)}"' for n, v in zip(names, values)
    )


class _Metric:
    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str):
        super().__init__(name, help_)
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def expose(self, labels: str = "") -> str:
        with self._lock:
            v = self.value
        return f"{self.name}{{{labels}}} {v}" if labels else f"{self.name} {v}"


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_: str):
        super().__init__(name, help_)
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def expose(self, labels: str = "") -> str:
        with self._lock:
            v = self.value
        return f"{self.name}{{{labels}}} {v}" if labels else f"{self.name} {v}"


class Histogram(_Metric):
    kind = "histogram"

    DEFAULT_BUCKETS = (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
        0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    )

    def __init__(self, name: str, help_: str, buckets: Sequence[float] | None = None):
        super().__init__(name, help_)
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.total = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.sum += v
            self.total += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def time(self):
        """Context manager: observe elapsed seconds."""
        return _Timer(self)

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket counts (upper bound)."""
        with self._lock:
            if self.total == 0:
                return 0.0
            target = q * self.total
            acc = 0
            for i, b in enumerate(self.buckets):
                acc += self.counts[i]
                if acc >= target:
                    return b
            return float("inf")

    def snapshot(self) -> tuple[int, float, tuple[int, ...]]:
        """(total, sum, cumulative bucket counts incl. +Inf) — one
        consistent read for reporting (bench stage attribution)."""
        with self._lock:
            acc, cum = 0, []
            for c in self.counts:
                acc += c
                cum.append(acc)
            return self.total, self.sum, tuple(cum)

    def expose(self, labels: str = "") -> str:
        with self._lock:
            counts = list(self.counts)
            total, sum_ = self.total, self.sum
        sep = labels + "," if labels else ""
        tail = f"{{{labels}}}" if labels else ""
        lines = []
        acc = 0
        for i, b in enumerate(self.buckets):
            acc += counts[i]
            lines.append(f'{self.name}_bucket{{{sep}le="{b}"}} {acc}')
        acc += counts[-1]
        lines.append(f'{self.name}_bucket{{{sep}le="+Inf"}} {acc}')
        lines.append(f"{self.name}_sum{tail} {sum_}")
        lines.append(f"{self.name}_count{tail} {total}")
        return "\n".join(lines)


class _Timer:
    def __init__(self, h: Histogram):
        self.h = h

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.h.observe(time.perf_counter() - self.t0)
        return False


# ---------------------------------------------------------------------------
# Label-vector families (reference ``try_create_int_counter_vec`` + the
# ``get_metric(&VEC, &[..])`` handle pattern): one registered family, one
# child metric per label-value combination, created on first touch.
# ---------------------------------------------------------------------------


class _MetricVec(_Metric):
    _child_cls: type = _Metric  # overridden

    def __init__(self, name: str, help_: str, labelnames: Sequence[str], **kw):
        super().__init__(name, help_)
        labelnames = tuple(labelnames)
        if not labelnames:
            raise ValueError(f"{name}: a metric vec needs >= 1 label name")
        if len(set(labelnames)) != len(labelnames):
            raise ValueError(f"{name}: duplicate label names {labelnames}")
        self.labelnames = labelnames
        self._kw = kw
        self._children: Dict[Tuple[str, ...], _Metric] = {}
        self._lock = threading.Lock()

    @property
    def kind(self) -> str:
        return self._child_cls.kind

    def with_labels(self, *values, **kwvalues):
        """Child handle for one label combination (Lighthouse's
        ``get_metric(&VEC, &[v, ...])``). Accepts positional values in
        ``labelnames`` order, or keyword values by label name."""
        if kwvalues:
            if values:
                raise TypeError("label values: positional OR keyword, not both")
            if set(kwvalues) != set(self.labelnames):
                raise ValueError(
                    f"{self.name}: keyword labels {sorted(kwvalues)} != "
                    f"declared {sorted(self.labelnames)}"
                )
            values = tuple(kwvalues[n] for n in self.labelnames)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected {len(self.labelnames)} label values "
                f"{self.labelnames}, got {len(values)}"
            )
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._child_cls(self.name, self.help, **self._kw)
                self._children[values] = child
            return child

    # prometheus-client spelling, same handle
    labels = with_labels

    def children(self) -> Dict[Tuple[str, ...], _Metric]:
        """Snapshot of label-values -> child (reporting/bench reads)."""
        with self._lock:
            return dict(self._children)

    def expose(self) -> str:
        with self._lock:
            items = sorted(self._children.items())
        return "\n".join(
            child.expose(_label_str(self.labelnames, values))
            for values, child in items
        )


class CounterVec(_MetricVec):
    _child_cls = Counter


class GaugeVec(_MetricVec):
    _child_cls = Gauge


class HistogramVec(_MetricVec):
    _child_cls = Histogram


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, _Metric] = {}
_reg_lock = threading.Lock()


def _get_or_create(cls, name: str, help_: str, **kw):
    with _reg_lock:
        m = _REGISTRY.get(name)
        if m is None:
            m = cls(name, help_, **kw)
            _REGISTRY[name] = m
            return m
        if type(m) is not cls:
            # one name, one metric type — a family silently re-registered
            # as another kind would corrupt the scrape
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}"
            )
        # omitted labelnames/buckets = fetch-by-name; provided ones must
        # match what the family was registered with (a silently ignored
        # mismatch would skew every reader)
        if isinstance(m, _MetricVec) and kw.get("labelnames") and tuple(
            kw["labelnames"]
        ) != m.labelnames:
            raise ValueError(
                f"metric {name!r} already registered with labels "
                f"{m.labelnames}, not {tuple(kw['labelnames'])}"
            )
        if kw.get("buckets") is not None:
            have = (
                m.buckets
                if isinstance(m, Histogram)
                else tuple(m._kw.get("buckets") or Histogram.DEFAULT_BUCKETS)
            )
            if tuple(kw["buckets"]) != have:
                raise ValueError(
                    f"metric {name!r} already registered with buckets "
                    f"{have}, not {tuple(kw['buckets'])}"
                )
        return m


def get(name: str):
    """Registered metric by name (None if absent): the read-side fetch
    that does not need to repeat a vec's label names."""
    with _reg_lock:
        return _REGISTRY.get(name)


def counter(name: str, help_: str = "") -> Counter:
    return _get_or_create(Counter, name, help_)


def gauge(name: str, help_: str = "") -> Gauge:
    return _get_or_create(Gauge, name, help_)


def histogram(name: str, help_: str = "", buckets=None) -> Histogram:
    return _get_or_create(Histogram, name, help_, buckets=buckets)


def counter_vec(name: str, help_: str = "", labelnames: Sequence[str] = ()) -> CounterVec:
    return _get_or_create(CounterVec, name, help_, labelnames=labelnames)


def gauge_vec(name: str, help_: str = "", labelnames: Sequence[str] = ()) -> GaugeVec:
    return _get_or_create(GaugeVec, name, help_, labelnames=labelnames)


def histogram_vec(
    name: str, help_: str = "", labelnames: Sequence[str] = (), buckets=None
) -> HistogramVec:
    return _get_or_create(
        HistogramVec, name, help_, labelnames=labelnames, buckets=buckets
    )


def registry_snapshot() -> Dict[str, _Metric]:
    """Name -> metric, one consistent read (the hygiene gate's surface)."""
    with _reg_lock:
        return dict(_REGISTRY)


_SAMPLE_RE = re.compile(
    r'^([a-z_][a-zA-Z0-9_]*)(\{(?:[a-zA-Z_][a-zA-Z0-9_]*='
    r'"(?:[^"\\\n]|\\["\\n])*",?)*\})? (.+)$'
)


def parse_exposition(text: str) -> List[Tuple[str, str, float]]:
    """Parse text in the format :func:`gather` produces; returns
    ``(name, raw label block, value)`` per sample line and raises
    ``ValueError`` on any malformed one. Lives next to the producer so
    the format's one grammar has one home (the metrics gates share it)."""
    samples = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line: {line!r}")
        samples.append((m.group(1), m.group(2) or "", float(m.group(3))))
    return samples


def gather() -> str:
    """Prometheus text exposition of every registered metric."""
    out = []
    with _reg_lock:
        metrics = list(_REGISTRY.values())
    for m in sorted(metrics, key=lambda m: m.name):
        out.append(f"# HELP {m.name} {_escape_help(m.help)}")
        out.append(f"# TYPE {m.name} {m.kind}")
        body = m.expose()
        if body:  # a vec with no children yet has headers only
            out.append(body)
    return "\n".join(out) + "\n"
