"""The live ``/metrics`` exporter — the counterpart of
``tpuddp/observability/exporter.py``: an opt-in HTTP endpoint on a daemon
thread (``observability.exporter``, off by default).

Endpoints (``ThreadingHTTPServer``):

- ``/metrics``: the Prometheus text exposition (gauges, counters,
  quantile-labelled summaries);
- ``/healthz``: ``{"status": "ok", "uptime_s": ...}``;
- ``/snapshot``: the merged source dicts as JSON (exact values);
- ``/trace``: the tracing plane's live view (the last completed spans and
  the open ones, :mod:`~tpuddp_torch.observability.trace`) when a trace
  source is set (:meth:`MetricsExporter.set_trace_source`); 404 otherwise.

A scrape reads host dicts that the ``step_stats`` window's wait or the
epoch's end already filled: it never reads a tensor and never waits for
the device. Every response is whole: the body is rendered before a byte is
sent (Content-Length framing), and a rendering error answers a whole 500,
so a writer that changes the sources during a scrape can never make it
read a torn payload. A source is a zero-argument callable returning
``{series_name: series}`` (:func:`gauge`, :func:`counter`,
:func:`summary`); a failing source is left out of that scrape with a
warning.

``port=0`` binds an ephemeral port. The bound port goes into the run's
``run_meta`` header and, with a run directory, into ``<dir>/exporter.port``
(``exporter_p<host>.port`` past host 0: one file per host on a shared
directory), two lines, the port and the bound host. A port file is a hint:
:func:`read_live_port` trusts it only after a ``/healthz`` answer.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from tpuddp_torch.observability.metrics import json_sanitize

logger = logging.getLogger("tpuddp")

PORT_FILENAME = "exporter.port"
_PREFIX = "tpuddp_"


def gauge(value, help: str = "") -> dict:
    """A point-in-time value (epoch, queue depth)."""
    return {"type": "gauge", "help": help, "value": value}


def counter(value, help: str = "") -> dict:
    """A total that only grows (steps, samples, bytes)."""
    return {"type": "counter", "help": help, "value": value}


def summary(quantiles: Dict[str, object], help: str = "", count=None) -> dict:
    """Quantile values ``{"0.5": ms, ...}`` (None ones left out when
    rendered) and an optional observation count."""
    return {"type": "summary", "help": help, "quantiles": dict(quantiles), "count": count}


def _escape_label(value) -> str:
    """The exposition format's label-value escapes: backslash, double quote
    and newline (one unescaped quote would spoil the whole page)."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(value) -> Optional[str]:
    """A sample's value, or None to leave the sample out."""
    if value is None or isinstance(value, bool):
        return None
    try:
        f = float(value)
    except (TypeError, ValueError):
        return None
    return repr(f) if f != int(f) else str(int(f))


class MetricsExporter:
    """The endpoint: :meth:`start` binds and serves, :meth:`stop` tears
    down (idempotent; the loops' ``finally``). ``port_filename`` names the
    discovery file in ``run_dir``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, run_dir: Optional[str] = None,
                 port_filename: str = PORT_FILENAME):
        self.host = host
        self.requested_port = int(port)
        self.port: Optional[int] = None  # the bound port, known after start()
        self.run_dir = run_dir
        self.port_filename = port_filename
        self._sources: Dict[str, Callable[[], dict]] = {}
        self.trace_source: Optional[Callable[[], dict]] = None  # None: /trace is a 404
        self._lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.monotonic()
        self.scrapes = 0

    def register_source(self, name: str, fn: Callable[[], dict]) -> None:
        with self._lock:
            self._sources[name] = fn

    def unregister_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def set_trace_source(self, fn: Optional[Callable[[], dict]]) -> None:
        """Set (None: clear) the ``/trace`` feed, a zero-argument callable
        returning the span payload."""
        with self._lock:
            self.trace_source = fn

    def collect(self) -> Dict[str, dict]:
        """Every source's series merged; a failing source is skipped."""
        with self._lock:
            sources = list(self._sources.items())
        merged: Dict[str, dict] = {}
        for name, fn in sources:
            try:
                series = fn() or {}
            except Exception as e:  # noqa: BLE001 — the scrape must survive
                logger.warning("exporter: source %r failed: %s", name, e)
                continue
            merged.update(series)
        return merged

    def render_prometheus(self) -> str:
        lines = []
        for name, series in sorted(self.collect().items()):
            full = name if name.startswith(_PREFIX) else _PREFIX + name
            stype = series.get("type", "gauge")
            if series.get("help"):
                lines.append(f"# HELP {full} {series['help']}")
            lines.append(f"# TYPE {full} {stype}")
            if stype == "summary":
                for q, v in series.get("quantiles", {}).items():
                    s = _fmt(v)
                    if s is not None:
                        lines.append(f'{full}{{quantile="{_escape_label(q)}"}} {s}')
                c = _fmt(series.get("count"))
                if c is not None:
                    lines.append(f"{full}_count {c}")
            else:
                s = _fmt(series.get("value"))
                if s is not None:
                    labels = series.get("labels")
                    if labels:
                        lab = ",".join(f'{k}="{_escape_label(v)}"'
                                       for k, v in sorted(labels.items()))
                        lines.append(f"{full}{{{lab}}} {s}")
                    else:
                        lines.append(f"{full} {s}")
                for extra_labels, v in series.get("values", []):
                    s = _fmt(v)
                    if s is None:
                        continue
                    lab = ",".join(f'{k}="{_escape_label(val)}"'
                                   for k, val in sorted(extra_labels.items()))
                    lines.append(f"{full}{{{lab}}} {s}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        return {
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "scrapes": self.scrapes,
            "series": json_sanitize(self.collect()),
        }

    def start(self) -> "MetricsExporter":
        if self._server is not None:
            return self
        # a killed predecessor's port file names a port nobody serves: remove
        # it before binding, so a reader polling now sees no port yet
        if self.run_dir is not None:
            try:
                os.remove(os.path.join(self.run_dir, self.port_filename))
            except OSError:
                pass
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # the logger speaks, not stderr
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server's name
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        exporter.scrapes += 1
                        self._send(200, exporter.render_prometheus().encode(),
                                   "text/plain; version=0.0.4")
                    elif path == "/healthz":
                        body = json.dumps({
                            "status": "ok",
                            "uptime_s": round(time.monotonic() - exporter._t0, 3),
                        }).encode()
                        self._send(200, body, "application/json")
                    elif path == "/snapshot":
                        body = json.dumps(exporter.snapshot(), allow_nan=False).encode()
                        self._send(200, body, "application/json")
                    elif path == "/trace":
                        with exporter._lock:
                            source = exporter.trace_source
                        if source is None:
                            self._send(404, b"tracing not enabled\n", "text/plain")
                        else:
                            body = json.dumps(json_sanitize(source()), allow_nan=False).encode()
                            self._send(200, body, "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except BrokenPipeError:
                    pass  # the client went away
                except Exception as e:  # noqa: BLE001 — a whole 500, never a torn body
                    # every body above is rendered before _send: nothing is on
                    # the wire yet when rendering fails
                    logger.warning("exporter: scrape failed: %s", e)
                    try:
                        self._send(500, f"scrape failed: {e}\n".encode(), "text/plain")
                    except Exception:  # noqa: BLE001 — the socket is gone
                        pass

        self._server = ThreadingHTTPServer((self.host, self.requested_port), Handler)
        self._server.daemon_threads = True
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="tpuddp-exporter", daemon=True)
        self._thread.start()
        self._write_port_file()
        logger.info("exporter: /metrics /healthz /snapshot live on %s:%d", self.host, self.port)
        return self

    def _write_port_file(self) -> None:
        """``<run_dir>/<port_filename>``, staged and renamed: line 1 the
        port, line 2 the bound host."""
        if self.run_dir is None or self.port is None:
            return
        try:
            os.makedirs(self.run_dir, exist_ok=True)
            path = os.path.join(self.run_dir, self.port_filename)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(f"{self.port}\n{self.host}\n")
            os.replace(tmp, path)
        except OSError as e:  # a discovery aid, never fatal
            logger.warning("exporter: port file write failed: %s", e)

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is None:
            return
        server.shutdown()
        server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self.run_dir is not None:
            try:
                os.remove(os.path.join(self.run_dir, self.port_filename))
            except OSError:
                pass

    def describe(self) -> dict:
        """The run_meta ``observability.exporter`` field."""
        return {"host": self.host, "port": self.port}


def read_live_port(run_dir: str, port_filename: str = PORT_FILENAME, host: Optional[str] = None,
                   probe_timeout: float = 1.0) -> Optional[int]:
    """The port in ``<run_dir>/<port_filename>`` once a ``/healthz`` probe
    of it answers ``{"status": "ok"}``; None for a missing or garbled file,
    a dead port or another answer. The probe goes to the file's line-2 host
    (loopback for a bind-all or missing one) unless ``host`` is given."""
    import urllib.request

    path = os.path.join(run_dir, port_filename)
    try:
        with open(path) as f:
            lines = f.read().splitlines()
        port = int(lines[0].strip())
    except (OSError, ValueError, IndexError):
        return None
    if host is None:
        host = lines[1].strip() if len(lines) > 1 and lines[1].strip() else ""
        if not host or host in ("0.0.0.0", "::"):
            host = "127.0.0.1"
    try:
        with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                    timeout=probe_timeout) as resp:
            health = json.load(resp)
    except Exception:  # noqa: BLE001 — a dead or foreign port is not live
        return None
    if isinstance(health, dict) and health.get("status") == "ok":
        return port
    return None


def exporter_from_config(obs_cfg: dict, run_dir=None,
                         process_index: Optional[int] = None) -> Optional[MetricsExporter]:
    """An exporter (not started) from a resolved ``observability`` block
    (:func:`tpuddp_torch.config.resolve_observability`); None when off.
    Past host 0 (``process_index``, default this process's host) the port
    file is ``exporter_p<host>.port``."""
    if not obs_cfg or not obs_cfg.get("exporter"):
        return None
    if process_index is None:
        from tpuddp_torch.parallel import backend

        process_index = backend.host_index()
    return MetricsExporter(
        host=str(obs_cfg.get("exporter_host") or "127.0.0.1"),
        port=int(obs_cfg.get("exporter_port") or 0),
        run_dir=run_dir,
        port_filename=PORT_FILENAME if process_index == 0 else f"exporter_p{process_index}.port",
    )
