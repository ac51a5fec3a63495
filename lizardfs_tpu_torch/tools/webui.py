"""Web status UI — the CGI monitoring panel, modernized.

The reference ships a Python CGI rendering master state tables + charts
(reference: src/cgi/mfs.cgi.in). This is the stdlib-only equivalent: a
small HTTP server that queries the master's admin protocol and serves a
live HTML dashboard plus raw JSON endpoints.

    python -m lizardfs_tpu_torch.tools.webui --master 127.0.0.1:9420 --port 9425

Endpoints: /  (dashboard), /api/info, /api/health, /api/metrics,
/api/top (cluster-wide per-session workload rollup),
/api/rebuild (RebuildEngine progress/ETA JSON),
/metrics (Prometheus text exposition of the master's registry),
/health (cluster health rollup JSON — SLO burn, per-CS snapshots)
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.runtime.tracing import READ_PHASES

PAGE = """<!doctype html>
<html><head><title>lizardfs-tpu status</title>
<meta http-equiv="refresh" content="5">
<style>
 body {{ font-family: monospace; margin: 2em; background: #111; color: #ddd; }}
 h1 {{ color: #7fd4a0; }} h2 {{ color: #8ab4f8; margin-top: 1.5em; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #444; padding: 4px 10px; text-align: left; }}
 th {{ background: #222; }}
 .ok {{ color: #7fd4a0; }} .bad {{ color: #f28b82; }}
</style></head><body>
<h1>lizardfs-tpu &mdash; {personality} @ v{version}</h1>
<h2>cluster</h2>
<table>
<tr><th>inodes</th><td>{inodes}</td></tr>
<tr><th>chunks</th><td>{chunks}</td></tr>
<tr><th>sessions</th><td>{sessions}</td></tr>
<tr><th>chunks healthy / endangered / lost</th>
    <td><span class="ok">{healthy}</span> /
        <span class="{endangered_cls}">{endangered}</span> /
        <span class="{lost_cls}">{lost}</span></td></tr>
</table>
<h2>chunkservers</h2>
<table><tr><th>id</th><th>address</th><th>label</th><th>state</th>
<th>used / total GiB</th></tr>{servers}</table>
<h2>rebuild engine</h2>
<table>
<tr><th>queued (lost / endangered / rebalance)</th>
    <td><span class="{lostq_cls}">{q_lost}</span> /
        {q_endangered} / {q_rebalance}</td></tr>
<tr><th>active / cap</th><td>{rb_active} / {rb_cap}</td></tr>
<tr><th>throttle</th><td>{rb_throttle}</td></tr>
<tr><th>completed / failed</th><td>{rb_completed} / {rb_failed}</td></tr>
<tr><th>rate / ETA</th><td>{rb_rate} MB/s &mdash; {rb_eta}</td></tr>
</table>
<h2>workload top &mdash; per-session (ops/s over the accounting window)</h2>
<table><tr><th>session</th><th>who</th><th>ops/s</th><th>p99 ms</th>
<th>hot classes</th><th>read roofline</th>
<th>exemplar trace</th></tr>{top_rows}</table>
<h2>metadata ops (last 120 s)</h2>
<pre>{ops}</pre>
<h2>charts &mdash; range: {range_links} (showing {span})</h2>
{charts}
<h2>chunkserver charts ({span})</h2>
{cs_charts}
</body></html>
"""

# resolution -> human span of the full ring (runtime.metrics.RESOLUTIONS)
SPANS = {
    "sec": "2 min", "min": "3 h", "tenmin": "1 day",
    "hour": "1 week", "day": "3 months",
}


def sparkline(points, width=480, height=60, color="#8ab4f8"):
    """Inline SVG sparkline of a numeric series (charts rendering)."""
    pts = [max(float(p), 0.0) for p in points][-120:]
    if not pts:
        pts = [0.0]
    peak = max(pts) or 1.0
    n = len(pts)
    step = width / max(n - 1, 1)
    coords = " ".join(
        f"{i * step:.1f},{height - 2 - (v / peak) * (height - 6):.1f}"
        for i, v in enumerate(pts)
    )
    return (
        f'<svg width="{width}" height="{height}" '
        f'style="background:#1a1a1a;border:1px solid #333">'
        f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
        f'points="{coords}"/>'
        f'<text x="4" y="12" fill="#888" font-size="10">peak {peak:.0f}</text>'
        f"</svg>"
    )


async def _admin(addr, msg):
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(*addr), 5.0
    )
    try:
        await framing.send_message(writer, msg)
        return await framing.read_message(reader)
    finally:
        writer.close()


class Dashboard:
    def __init__(self, master_addr: tuple[str, int]):
        self.master_addr = master_addr
        self.loop = asyncio.new_event_loop()
        threading.Thread(target=self.loop.run_forever, daemon=True).start()

    def _call(self, msg):
        fut = asyncio.run_coroutine_threadsafe(
            _admin(self.master_addr, msg), self.loop
        )
        return fut.result(10)

    def info(self) -> dict:
        return json.loads(self._call(m.AdminInfo(req_id=1)).json)

    def health(self) -> dict:
        return json.loads(
            self._call(
                m.AdminCommand(req_id=1, command="chunks-health", json="{}")
            ).json
        )

    def cluster_health(self) -> dict:
        """The master's cluster-wide health rollup (SLO burn, breach
        counts, per-chunkserver snapshots, endangered/lost chunks)."""
        return json.loads(
            self._call(
                m.AdminCommand(req_id=1, command="health", json="{}")
            ).json
        )

    def rebuild_status(self) -> dict:
        """The master RebuildEngine's progress/ETA document."""
        return json.loads(
            self._call(
                m.AdminCommand(req_id=1, command="rebuild-status", json="{}")
            ).json
        )

    def top(self) -> dict:
        """The master's cluster-wide per-session workload rollup
        (`lizardfs-admin top` over the admin link)."""
        return json.loads(
            self._call(
                m.AdminCommand(req_id=1, command="top", json="{}")
            ).json
        )

    def heat(self) -> dict:
        """The cluster heat map: hottest chunks/inodes/servers, goal
        boosts, placement loads (`lizardfs-admin heat`)."""
        return json.loads(
            self._call(
                m.AdminCommand(req_id=1, command="heat", json="{}")
            ).json
        )

    def metrics(self, resolution: str = "sec") -> dict:
        return json.loads(
            self._call(
                m.AdminCommand(
                    req_id=1, command="metrics",
                    json=json.dumps({"resolution": resolution}),
                )
            ).json
        )

    def metrics_prom(self) -> str:
        """Prometheus text exposition of the master's registry (the
        daemon renders it; this just unwraps the admin relay)."""
        return json.loads(
            self._call(
                m.AdminCommand(req_id=1, command="metrics-prom", json="{}")
            ).json
        )["text"]

    def cs_metrics_all(self, addrs: list[tuple[str, int]],
                       resolution: str = "sec") -> list[dict | None]:
        """Fetch every chunkserver's metrics concurrently; a slow or
        dead CS yields None after a short timeout instead of stalling
        the whole page render."""

        async def one(addr):
            try:
                reply = await asyncio.wait_for(
                    _admin(addr, m.AdminCommand(
                        req_id=1, command="metrics",
                        json=json.dumps({"resolution": resolution}),
                    )),
                    timeout=3.0,
                )
                return json.loads(reply.json)
            except Exception:  # noqa: BLE001
                return None

        async def all_():
            return await asyncio.gather(*(one(a) for a in addrs))

        return asyncio.run_coroutine_threadsafe(all_(), self.loop).result(10)

    def render(self, res: str = "sec") -> str:
        info = self.info()
        health = self.health()
        try:
            rb = self.rebuild_status()
        except Exception:  # noqa: BLE001 — older master: no verb
            rb = {}
        try:
            top = self.top()
        except Exception:  # noqa: BLE001 — older master: no verb
            top = {}
        top_rows = []
        sessions = sorted(
            top.get("sessions", {}).items(),
            key=lambda kv: -kv[1].get("master", {}).get("rate_ops", 0.0),
        )
        from html import escape as _esc

        for label, entry in sessions[:12]:
            mrow = entry.get("master", {})
            classes = mrow.get("classes", {})
            hot = " ".join(
                f"{cls}:{v.get('ops', 0)}"
                for cls, v in sorted(
                    classes.items(), key=lambda kv: -kv[1].get("ops", 0)
                )[:3]
            )
            # session info and gateway-pushed fields are CLIENT-supplied
            # strings (CltomaRegister.info / CltomaSessionStats JSON) —
            # escape everything interpolated, or a hostile client's
            # registration string runs as script in the operator's
            # browser
            who = entry.get("info", "") or "?"
            gw = entry.get("gateway")
            if gw:
                who += f" ({gw.get('role', '?')} gateway)"
            exemplar = str(mrow.get("exemplar", entry.get("exemplar", "")))
            # client-pushed read PhaseBreakdown (top_report lifts it
            # from the session-stats doc): name the dominant phase so
            # the table answers "what bounds this session's reads"
            phases = entry.get("read_phases") or {}
            roofline = ""
            if phases.get("reps"):
                # the top-level phases only: a part of one never dominates
                busy = {
                    p: phases[f"{p}_ms"] for p in READ_PHASES
                    if f"{p}_ms" in phases
                }
                if busy:
                    dom = max(busy, key=lambda k: busy[k])
                    roofline = f"{dom} {busy[dom]:.0f}ms"
            top_rows.append(
                f"<tr><td>{_esc(str(label))}</td><td>{_esc(who)}</td>"
                f"<td>{mrow.get('rate_ops', 0.0):.1f}</td>"
                f"<td>{mrow.get('p99_ms', 0.0):.1f}</td>"
                f"<td>{_esc(hot)}</td><td>{_esc(roofline)}</td>"
                f"<td>{_esc(exemplar)}</td></tr>"
            )
        rows = []
        for s in info.get("chunkservers", []):
            state = (
                '<span class="ok">up</span>' if s["connected"]
                else '<span class="bad">DOWN</span>'
            )
            rows.append(
                f"<tr><td>{s['cs_id']}</td><td>{s['host']}:{s['port']}</td>"
                f"<td>{s['label']}</td><td>{state}</td>"
                f"<td>{s['used_space']/2**30:.1f} / {s['total_space']/2**30:.1f}</td></tr>"
            )
        if res not in SPANS:
            res = "sec"
        metrics = self.metrics(res)
        sec_metrics = metrics if res == "sec" else self.metrics("sec")
        ops_lines = []
        for name, series in sec_metrics.items():
            if name.startswith("op.") or name == "metadata_ops":
                pts = series["points"][-60:]
                ops_lines.append(
                    f"{name:<24s} total={series['total']:<10.0f} "
                    f"last120s={sum(pts):.0f}"
                )
        charts_html = []
        for name in ("metadata_ops", "chunks", "chunkservers_connected",
                     "chunks_per_server"):
            series = metrics.get(name)
            if series:
                tag = " (derived)" if series.get("kind") == "derived" else ""
                charts_html.append(
                    f"<div><b>{name}</b>{tag}<br>"
                    f"{sparkline(series['points'])}</div>"
                )
        cs_charts = []
        live = [s for s in info.get("chunkservers", []) if s["connected"]]
        fetched = self.cs_metrics_all(
            [(s["host"], s["port"]) for s in live], res
        )
        for s, csm in zip(live, fetched):
            if csm is None:
                continue
            row = []
            for name in ("bytes_read", "bytes_written", "bytes_total"):
                series = csm.get(name)
                if series:
                    row.append(
                        f"<div style='display:inline-block;margin-right:1em'>"
                        f"<b>cs{s['cs_id']} {name}</b><br>"
                        f"{sparkline(series['points'], width=300)}</div>"
                    )
            cs_charts.append("<div>" + "".join(row) + "</div>")
        range_links = " | ".join(
            (f"<b>[{r}]</b>" if r == res
             else f'<a style="color:#8ab4f8" href="/?res={r}">{r}</a>')
            for r in SPANS
        )
        rb_q = rb.get("queued", {})
        rb_thr = rb.get("throttle", {})
        rb_eta = rb.get("eta_s")
        rb_bps = rb_thr.get("rebuild_bps", 0)
        return PAGE.format(
            q_lost=rb_q.get("lost", 0),
            q_endangered=rb_q.get("endangered", 0),
            q_rebalance=rb_q.get("rebalance", 0),
            lostq_cls="bad" if rb_q.get("lost") else "ok",
            rb_active=len(rb.get("active", [])),
            rb_cap=rb_thr.get("rebuild_concurrency", 0),
            rb_throttle=(f"{rb_bps / 1e6:.1f} MB/s" if rb_bps
                         else "unlimited"),
            rb_completed=rb.get("completed", 0),
            rb_failed=rb.get("failed", 0),
            rb_rate=f"{rb.get('rate_bps', 0) / 1e6:.1f}",
            # eta None means EITHER no backlog (idle) or a backlog with
            # no completions in the rate window yet (stalled/starting)
            # — during an incident the second reading is the one that
            # matters, so never render it as "idle"
            rb_eta=(f"{rb_eta:.0f} s backlog" if rb_eta is not None
                    else ("stalled backlog, no recent completions"
                          if rb.get("pending_bytes", 0) else "idle")),
            personality=info.get("personality", "?"),
            version=info.get("version", 0),
            inodes=info.get("inodes", 0),
            chunks=info.get("chunks", 0),
            sessions=info.get("sessions", 0),
            healthy=health.get("healthy", 0),
            endangered=health.get("endangered", 0),
            lost=health.get("lost", 0),
            endangered_cls="bad" if health.get("endangered") else "ok",
            lost_cls="bad" if health.get("lost") else "ok",
            top_rows="".join(top_rows)
            or "<tr><td colspan=6>no sessions tracked</td></tr>",
            servers="".join(rows) or "<tr><td colspan=5>none</td></tr>",
            ops="\n".join(sorted(ops_lines)) or "(no ops yet)",
            charts="".join(charts_html) or "(no series yet)",
            cs_charts="".join(cs_charts) or "(no chunkservers)",
            range_links=range_links,
            span=SPANS[res],
        )


def make_handler(dash: Dashboard):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, body: str, ctype: str = "text/html"):
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            try:
                if self.path == "/metrics":
                    # standard Prometheus scrape endpoint
                    self._send(
                        dash.metrics_prom(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif self.path == "/health":
                    # cluster health rollup — the load-balancer/monitor
                    # probe endpoint ("is the cluster healthy?")
                    self._send(
                        json.dumps(dash.cluster_health()),
                        "application/json",
                    )
                elif self.path == "/api/top":
                    # cluster-wide per-session workload rollup (the
                    # `lizardfs-admin top` document)
                    self._send(json.dumps(dash.top()), "application/json")
                elif self.path == "/api/heat":
                    # cluster heat map (the `lizardfs-admin heat` doc)
                    self._send(json.dumps(dash.heat()), "application/json")
                elif self.path == "/api/rebuild":
                    # RebuildEngine progress/ETA (rebuild-status verb)
                    self._send(
                        json.dumps(dash.rebuild_status()),
                        "application/json",
                    )
                elif self.path == "/api/info":
                    self._send(json.dumps(dash.info()), "application/json")
                elif self.path == "/api/health":
                    self._send(json.dumps(dash.health()), "application/json")
                elif self.path.startswith("/api/metrics"):
                    res = self.path.rpartition("=")[2] if "=" in self.path else "sec"
                    self._send(json.dumps(dash.metrics(res)), "application/json")
                else:
                    res = "sec"
                    if "res=" in self.path:
                        res = self.path.rpartition("res=")[2].split("&")[0]
                    self._send(dash.render(res))
            except Exception as e:  # noqa: BLE001
                self.send_error(502, f"master unreachable: {e}")

    return Handler


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lizardfs-webui", description=__doc__)
    p.add_argument("--master", default="127.0.0.1:9420")
    p.add_argument("--port", type=int, default=9425)
    p.add_argument("--host", default="127.0.0.1")
    args = p.parse_args(argv)
    host, _, port = args.master.rpartition(":")
    dash = Dashboard((host or "127.0.0.1", int(port)))
    server = ThreadingHTTPServer((args.host, args.port), make_handler(dash))
    print(f"lizardfs-tpu web UI on http://{args.host}:{server.server_port}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
