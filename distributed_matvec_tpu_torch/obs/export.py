# Ported from distributed_matvec_tpu/obs/export.py.
"""OpenMetrics export — the scrape plane over the metrics registry.

This module renders :func:`~.metrics.snapshot` — the registry the service
emits as a ``metrics_snapshot`` event — into the Prometheus / OpenMetrics
text exposition format, and serves it three ways:

* **Per-rank HTTP endpoint** (:func:`start_exporter`): a stdlib
  ``ThreadingHTTPServer`` answering ``GET /metrics`` (fresh snapshot per
  scrape) and ``GET /healthz`` (rank identity + uptime).  The port comes
  from ``DMT_OBS_PORT`` / ``config.obs_port`` **plus the process rank**,
  so every rank of a multi-process run is scrapeable side by side;
  unset/0 means no server (and with ``DMT_OBS=off`` no socket is ever
  bound).
* **Textfile mode** (:func:`write_textfile`): the same rendering written
  atomically to ``<run_dir>/rank_<r>/metrics.prom`` — the node-exporter
  textfile-collector path.
* **Rank-0 aggregation**: rank 0's ``/metrics`` merges every peer's
  textfile under the shared run directory behind its own snapshot
  (:func:`merge_openmetrics`), so one scrape target covers the run.

Naming contract: every sample is ``dmt_<name>`` with the registry's labels,
counters gain the OpenMetrics ``_total`` suffix, histograms export
cumulative ``_bucket{le=...}``/``_sum``/``_count``, and a ``rank`` label
pins each sample to its producer.  HELP text comes from
``obs/directions.py``.  Values are rendered with ``repr`` (shortest
round-trip form), so a scraped number is **exactly** the registry value.
The text is the JAX package's, byte for byte, for the same registry.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.config import get_config
from ..utils.logging import _process_index, log_info, log_warn
from . import metrics as _metrics
from .events import obs_enabled, run_dir

__all__ = [
    "render_openmetrics",
    "parse_openmetrics",
    "merge_openmetrics",
    "write_textfile",
    "textfile_path",
    "start_exporter",
    "stop_exporter",
    "MetricsServer",
]

_PREFIX = "dmt_"


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt(value) -> str:
    """Shortest exact decimal form: ints stay ints, floats render via
    ``repr`` (round-trips bit-exactly through ``float()``) — the parity
    contract with the JSONL ``metrics_snapshot`` depends on this."""
    if isinstance(value, bool):
        return str(int(value))
    if isinstance(value, int):
        return str(value)
    v = float(value)
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def _split_series(sname: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of :func:`~.metrics.series_name`:
    ``name{k=v,...}`` → ``(name, {k: v})``."""
    if "{" not in sname:
        return sname, {}
    name, _, rest = sname.partition("{")
    labels: Dict[str, str] = {}
    for pair in rest.rstrip("}").split(","):
        if pair:
            k, _, v = pair.partition("=")
            labels[k] = v
    return name, labels


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _help_line(base: str) -> str:
    from .directions import metric_meta
    return metric_meta(base)["help"]


def render_openmetrics(snap: Optional[dict] = None,
                       extra_labels: Optional[Dict[str, str]] = None,
                       info: Optional[Dict[str, str]] = None) -> str:
    """The registry snapshot as OpenMetrics text.  ``extra_labels`` are
    stamped onto every sample (the per-rank exporter passes
    ``{"rank": "<r>"}``); ``info`` fields ride a ``dmt_run_info`` gauge
    (trace/job identity — labels, value always 1)."""
    if snap is None:
        snap = _metrics.snapshot()
    extra = dict(extra_labels or {})
    lines: List[str] = []

    def _family(sname: str) -> Tuple[str, str]:
        base, labels = _split_series(sname)
        labels.update(extra)
        return _PREFIX + base, _label_str(labels)

    seen_types: set = set()

    def _head(fam: str, mtype: str, base: str) -> None:
        if fam not in seen_types:
            seen_types.add(fam)
            lines.append(f"# TYPE {fam} {mtype}")
            lines.append(f"# HELP {fam} {_escape_label(_help_line(base))}")

    for sname in sorted(snap.get("counters", {})):
        base, _ = _split_series(sname)
        fam, lab = _family(sname)
        _head(fam, "counter", base)
        lines.append(f"{fam}_total{lab} {_fmt(snap['counters'][sname])}")
    for sname in sorted(snap.get("gauges", {})):
        base, _ = _split_series(sname)
        fam, lab = _family(sname)
        _head(fam, "gauge", base)
        lines.append(f"{fam}{lab} {_fmt(snap['gauges'][sname])}")
    for sname in sorted(snap.get("histograms", {})):
        base, labels = _split_series(sname)
        labels.update(extra)
        fam = _PREFIX + base
        _head(fam, "histogram", base)
        h = snap["histograms"][sname]
        cum = 0
        for ub, c in zip(list(h["buckets"]) + ["+Inf"], h["counts"]):
            cum += c
            blab = _label_str({**labels, "le": ub if ub == "+Inf"
                               else _fmt(ub)})
            lines.append(f"{fam}_bucket{blab} {cum}")
        lab = _label_str(labels)
        lines.append(f"{fam}_sum{lab} {_fmt(h['sum'])}")
        lines.append(f"{fam}_count{lab} {h['count']}")
    if info:
        fam = _PREFIX + "run_info"
        lines.append(f"# TYPE {fam} gauge")
        lines.append(f"# HELP {fam} Run identity (labels carry the ids)")
        lines.append(f"{fam}{_label_str({**info, **extra})} 1")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def parse_openmetrics(text: str,
                      drop_labels: Iterable[str] = ("rank",)) -> dict:
    """Inverse of :func:`render_openmetrics` back into the
    :func:`~.metrics.snapshot` shape (the parity tests' other half).
    ``drop_labels`` strips exporter-added labels (``rank``) so the
    reconstructed series names match the registry's own."""
    drop = set(drop_labels)
    types: Dict[str, str] = {}
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    hists: Dict[str, dict] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line == "# EOF":
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        # sample: name{labels} value   (label values may contain spaces)
        if "}" in line:
            head, _, val = line.rpartition(" ")
            name, _, rest = head.partition("{")
            labels = {}
            for m in rest.rstrip("}").split('",'):
                if not m:
                    continue
                k, _, v = m.partition("=")
                labels[k.strip()] = (v.strip().strip('"')
                                     .replace(r'\"', '"')
                                     .replace(r"\n", "\n")
                                     .replace(r"\\", "\\"))
        else:
            name, _, val = line.partition(" ")
            labels = {}
        value = float(val)
        le = labels.pop("le", None)
        labels = {k: v for k, v in labels.items() if k not in drop}
        base = name
        kind = None
        for suffix, k in (("_bucket", "histogram"), ("_sum", "histogram"),
                          ("_count", "histogram"), ("_total", "counter")):
            fam = name[: -len(suffix)] if name.endswith(suffix) else None
            if fam and types.get(fam) == k:
                base, kind = fam, k
                break
        if kind is None:
            kind = types.get(name, "gauge")
        if base == _PREFIX + "run_info":
            continue
        short = base[len(_PREFIX):] if base.startswith(_PREFIX) else base
        sname = _metrics.series_name(short, labels)
        if kind == "counter":
            iv = int(value)
            out["counters"][sname] = iv if iv == value else value
        elif kind == "gauge":
            out["gauges"][sname] = value
        else:
            h = hists.setdefault(sname, {"buckets": [], "cum": [],
                                         "sum": 0.0, "count": 0})
            if name.endswith("_bucket"):
                if le != "+Inf":
                    h["buckets"].append(float(le))
                h["cum"].append(int(value))
            elif name.endswith("_sum"):
                h["sum"] = value
            elif name.endswith("_count"):
                h["count"] = int(value)
    for sname, h in hists.items():
        counts = [c - p for c, p in zip(h["cum"], [0] + h["cum"][:-1])]
        out["histograms"][sname] = {"buckets": h["buckets"],
                                    "counts": counts, "sum": h["sum"],
                                    "count": h["count"]}
    return out


def merge_openmetrics(texts: List[str]) -> str:
    """Concatenate exposition texts from several ranks into one valid
    document: one ``# TYPE``/``# HELP`` head per family (first writer
    wins — every rank derives them from the same shared table), samples
    appended in input order (they are disjoint by their ``rank`` label),
    one trailing ``# EOF``."""
    seen: set = set()
    out: List[str] = []
    for text in texts:
        for line in text.splitlines():
            if line == "# EOF" or not line.strip():
                continue
            if line.startswith("# TYPE") or line.startswith("# HELP"):
                if line in seen:
                    continue
                seen.add(line)
            out.append(line)
    out.append("# EOF")
    return "\n".join(out) + "\n"


def _identity() -> Dict[str, str]:
    from . import trace as _trace
    info: Dict[str, str] = {}
    tid = _trace.trace_id()
    if tid:
        info["trace_id"] = tid
        jid = _trace.job_id()
        if jid:
            info["job_id"] = jid
    return info


def _render_self() -> str:
    rank = _process_index()
    return render_openmetrics(extra_labels={"rank": str(rank)},
                              info=_identity())


def textfile_path(rank: Optional[int] = None) -> Optional[str]:
    """``<run_dir>/rank_<r>/metrics.prom``, or None without a sink dir."""
    d = run_dir()
    if not d:
        return None
    r = _process_index() if rank is None else int(rank)
    return os.path.join(d, f"rank_{r}", "metrics.prom")


def write_textfile(path: Optional[str] = None) -> Optional[str]:
    """Render this rank's snapshot to its textfile atomically (tmp +
    rename — a collector never reads a torn file).  Returns the path, or
    None when the layer is off or no run directory is configured."""
    if not obs_enabled():
        return None
    path = path or textfile_path()
    if not path:
        return None
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(_render_self())
        os.replace(tmp, path)
    except OSError as e:
        log_warn(f"metrics textfile write failed ({path}): {e!r}")
        return None
    return path


def _peer_textfiles(own_rank: int) -> List[str]:
    d = run_dir()
    if not d or not os.path.isdir(d):
        return []
    texts = []
    for name in sorted(os.listdir(d)):
        if not name.startswith("rank_"):
            continue
        try:
            r = int(name[len("rank_"):])
        except ValueError:
            continue
        if r == own_rank:
            continue
        path = os.path.join(d, name, "metrics.prom")
        try:
            with open(path) as f:
                texts.append(f.read())
        except OSError:
            continue
    return texts


def _aggregate() -> str:
    """Rank 0's scrape body: own fresh snapshot + every peer's textfile
    merged into one document (non-zero ranks serve only themselves)."""
    rank = _process_index()
    own = _render_self()
    if rank != 0:
        return own
    peers = _peer_textfiles(own_rank=0)
    return merge_openmetrics([own] + peers) if peers else own


class MetricsServer:
    """Tiny stdlib HTTP exporter: ``/metrics`` (OpenMetrics, fresh
    snapshot per scrape; rank 0 aggregates peer textfiles) and
    ``/healthz`` (JSON liveness: rank, trace id, uptime)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        t_start = time.time()

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):    # scrapes must not spam stderr
                pass

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path == "/metrics":
                        self._send(200, _aggregate(),
                                   "application/openmetrics-text; "
                                   "version=1.0.0; charset=utf-8")
                    elif path == "/healthz":
                        body = json.dumps(
                            {"status": "ok", "rank": _process_index(),
                             "uptime_s": round(time.time() - t_start, 3),
                             **_identity()})
                        self._send(200, body + "\n", "application/json")
                    else:
                        self._send(404, "not found\n", "text/plain")
                except BrokenPipeError:   # scraper hung up mid-response
                    pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="dmt-metrics-exporter",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_server: Optional[MetricsServer] = None
_server_lock = threading.Lock()


def _resolve_port() -> int:
    """``DMT_OBS_PORT`` / ``config.obs_port`` plus the process index
    (side-by-side rank endpoints); 0/unset means no exporter."""
    env = os.environ.get("DMT_OBS_PORT")
    base = int(env) if env is not None else int(get_config().obs_port)
    if base <= 0:
        return 0
    return base + _process_index()


def start_exporter(port: Optional[int] = None,
                   host: str = "127.0.0.1") -> Optional[MetricsServer]:
    """Start (or return) this process's exporter.  ``port=None`` resolves
    ``DMT_OBS_PORT``/``config.obs_port`` (+rank) and returns None when
    unset — the knob is opt-in; an explicit ``port=0`` binds an ephemeral
    port (tests).  With ``DMT_OBS=off`` this returns None without ever
    touching a socket (the provable-no-op contract)."""
    global _server
    if not obs_enabled():
        return None
    with _server_lock:
        if _server is not None:
            return _server
        p = _resolve_port() if port is None else int(port)
        if port is None and p <= 0:
            return None
        try:
            _server = MetricsServer(p, host=host)
        except OSError as e:
            log_warn(f"metrics exporter failed to bind :{p}: {e!r}")
            return None
        log_info(f"metrics exporter serving http://{host}:{_server.port}"
                 f"/metrics (rank {_process_index()})")
        return _server


def stop_exporter() -> None:
    """Shut the exporter down (idempotent)."""
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None
