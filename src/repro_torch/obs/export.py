"""Exporters over the metrics registry: Prometheus text format + HTTP.

  prometheus_text(reg)        the text exposition format (counters with
                              _total names as-is, histograms as cumulative
                              le= buckets + _sum/_count).
  parse_prometheus_text(s)    minimal parser -> {name: [(labels, value)]},
                              used by CI smoke and tests to assert the
                              dump round-trips.
  MetricsServer               stdlib ThreadingHTTPServer on a daemon
                              thread: GET /metrics (Prometheus text) and
                              GET /statusz (the registry snapshot as
                              JSON). `serve_gp --metrics-port` starts one.

No third-party dependencies — the wire formats are plain text/JSON.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import MetricsRegistry, default_registry

__all__ = ["prometheus_text", "parse_prometheus_text", "MetricsServer",
           "start_metrics_server"]


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


def prometheus_text(registry: MetricsRegistry | None = None) -> str:
    """Render every series in the Prometheus text exposition format."""
    reg = registry if registry is not None else default_registry()
    lines = []
    for m in reg.metrics():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if m.kind == "histogram":
            for labels, s in m.collect():
                cum = 0
                for bound, c in zip(m.buckets, s["counts"]):
                    cum += c
                    ll = dict(labels, le=_fmt_value(bound))
                    lines.append(f"{m.name}_bucket{_fmt_labels(ll)} {cum}")
                cum += s["overflow"]
                ll = dict(labels, le="+Inf")
                lines.append(f"{m.name}_bucket{_fmt_labels(ll)} {cum}")
                lines.append(f"{m.name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(s['sum'])}")
                lines.append(f"{m.name}_count{_fmt_labels(labels)} "
                             f"{s['count']}")
        else:
            for labels, v in m.collect():
                lines.append(f"{m.name}{_fmt_labels(labels)} "
                             f"{_fmt_value(v)}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Minimal exposition-format parser: {metric: [(labels, value)]}.

    Raises ValueError on malformed sample lines — what the CI smoke step
    runs against the `--metrics-dump` artifact to prove the dump parses.
    """
    out: dict[str, list[tuple[dict, float]]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, labels, rest = line, {}, None
        if "{" in line:
            name, rest = line.split("{", 1)
            labelstr, rest = rest.rsplit("}", 1)
            for item in _split_labels(labelstr):
                if "=" not in item:
                    raise ValueError(f"line {lineno}: bad label {item!r}")
                k, v = item.split("=", 1)
                if len(v) < 2 or v[0] != '"' or v[-1] != '"':
                    raise ValueError(f"line {lineno}: unquoted label "
                                     f"value {v!r}")
                labels[k] = v[1:-1].replace('\\"', '"').replace("\\\\", "\\")
        else:
            parts = line.split(None, 1)
            if len(parts) != 2:
                raise ValueError(f"line {lineno}: no value in {line!r}")
            name, rest = parts
        try:
            value = float(rest.strip().replace("+Inf", "inf"))
        except ValueError as e:
            raise ValueError(f"line {lineno}: bad value {rest!r}") from e
        out.setdefault(name.strip(), []).append((labels, value))
    return out


def _split_labels(s: str) -> list[str]:
    """Split `a="x",b="y,z"` on commas outside quotes."""
    items, cur, inq, esc = [], [], False, False
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            inq = not inq
        elif ch == "," and not inq:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        items.append("".join(cur))
    return [i for i in (x.strip() for x in items) if i]


class MetricsServer:
    """HTTP scrape endpoint over a registry, on a daemon thread.

        srv = MetricsServer(port=9109).start()
        ... GET http://127.0.0.1:9109/metrics   (Prometheus text)
        ... GET http://127.0.0.1:9109/statusz   (snapshot JSON)
        srv.stop()

    port=0 binds an ephemeral port (tests); the bound port is `srv.port`
    after `start()`.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None \
            else default_registry()
        self._host = host
        self._port = int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> "MetricsServer":
        reg = self.registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?")[0] == "/metrics":
                    body = prometheus_text(reg).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.split("?")[0] == "/statusz":
                    body = json.dumps(reg.snapshot(), indent=2,
                                      sort_keys=True).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404, "try /metrics or /statusz")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):     # keep scrapes off stderr
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="gp-metrics", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join()
            self._httpd = self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def start_metrics_server(port: int = 0, *, host: str = "127.0.0.1",
                         registry: MetricsRegistry | None = None
                         ) -> MetricsServer:
    """Convenience: construct + start a MetricsServer."""
    return MetricsServer(port=port, host=host, registry=registry).start()
