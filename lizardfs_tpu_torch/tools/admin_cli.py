"""`lizardfs-admin` — cluster administration CLI (reference: src/admin/).

    python -m lizardfs_tpu_torch.tools.admin_cli <host:port> <command>

Commands: info, list-chunkservers, list-sessions, chunks-health,
save-metadata, metadata-checksum, promote-shadow, faults, qos.

``qos`` shows the master's multi-tenant fair-share state (weights,
per-class rates, sheds, per-tenant objectives) and sets it live::

    lizardfs-admin HOST:PORT qos                   # show
    lizardfs-admin HOST:PORT qos weight bulk 2     # tenant weight
    lizardfs-admin HOST:PORT qos rate locate 3000  # class ops/s
    lizardfs-admin HOST:PORT qos data-inflight-mb 32

``faults`` steers the live fault-injection rule set of any daemon
(runtime/faults.py) over the tweaks/admin channel::

    lizardfs-admin HOST:PORT faults                 # list rules + fires
    lizardfs-admin HOST:PORT faults arm 'chunkserver:disk_pread flip,limit=1'
    lizardfs-admin HOST:PORT faults clear
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from lizardfs_tpu_torch.proto import framing
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime.tracing import READ_PHASES


async def _admin(addr: tuple[str, int], command: str, payload: str = "{}",
                 password: str | None = None):
    # bounded dial: an admin command against a blackholed daemon must
    # error out in seconds, not the OS SYN timeout
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(*addr), 5.0
    )
    try:
        if password:
            # challenge-response: the password never crosses the wire
            import hmac

            await framing.send_message(
                writer,
                m.AdminCommand(req_id=1, command="auth-challenge", json="{}"),
            )
            ch = await framing.read_message(reader)
            nonce = json.loads(ch.json).get("nonce", "")
            digest = hmac.new(
                password.encode(), nonce.encode(), "sha256"
            ).hexdigest()
            await framing.send_message(
                writer,
                m.AdminCommand(
                    req_id=2, command="auth",
                    json=json.dumps({"digest": digest}),
                ),
            )
            auth = await framing.read_message(reader)
            if getattr(auth, "status", 1) != st.OK:
                return auth
        if command == "info":
            await framing.send_message(writer, m.AdminInfo(req_id=1))
        else:
            await framing.send_message(
                writer, m.AdminCommand(req_id=1, command=command, json=payload)
            )
        return await framing.read_message(reader)
    finally:
        writer.close()


def _parse_trace_id(raw: str) -> int:
    """Accept ids as timelines display them (0x-prefixed hex) as well
    as decimal; a bare hex string with letters also parses, so
    copy-pasting from any output works."""
    try:
        return int(raw, 0)
    except ValueError:
        return int(raw, 16)


async def _amain(argv) -> int:
    p = argparse.ArgumentParser(prog="lizardfs-admin", description=__doc__)
    p.add_argument("master", help="daemon host:port (master or chunkserver)")
    p.add_argument(
        "command",
        choices=[
            "info", "list-chunkservers", "list-sessions", "chunks-health",
            "save-metadata", "metadata-checksum", "promote-shadow",
            "metrics", "metrics-csv", "metrics-prom", "tweaks", "tweaks-set",
            "trace-dump", "health", "slowops", "rebuild-status", "faults",
            "top", "profile", "qos", "heat",
        ],
    )
    p.add_argument("extra", nargs="*",
                   help="tweaks-set: NAME VALUE; metrics: [resolution]; "
                        "trace-dump: [trace_id]; "
                        "faults: [arm RULE | clear]; "
                        "top: [watch]; profile: [top_n]; "
                        "qos: [weight TENANT W | rate CLASS OPS | "
                        "data-inflight-mb MB | data-bps BPS | "
                        "rebuild-weight W]")
    p.add_argument("--attribute", action="store_true",
                   help="trace-dump: append the latency attribution "
                        "(queue/disk/net/compute/unattributed buckets)")
    p.add_argument("--password", default=None,
                   help="admin password (challenge-response)")
    args = p.parse_args(argv)
    host, _, port = args.master.rpartition(":")
    addr = (host or "127.0.0.1", int(port))

    cmd = args.command
    if cmd in ("list-chunkservers", "list-sessions"):
        reply = await _admin(addr, "info", password=args.password)
    elif cmd in ("metrics", "metrics-csv"):
        resolution = args.extra[0] if args.extra else "sec"
        reply = await _admin(addr, cmd, json.dumps({"resolution": resolution}), password=args.password)
        if cmd == "metrics-csv" and reply.status == 0:
            print(json.loads(reply.json)["csv"], end="")
            return 0
    elif cmd == "metrics-prom":
        reply = await _admin(addr, cmd, password=args.password)
        if reply.status == 0:
            # raw Prometheus text exposition, ready to pipe to a scraper
            print(json.loads(reply.json)["text"], end="")
            return 0
    elif cmd == "trace-dump":
        trace_id = _parse_trace_id(args.extra[0]) if args.extra else 0
        reply = await _admin(
            addr, cmd, json.dumps({"trace_id": trace_id}),
            password=args.password,
        )
        if reply.status == 0:
            from lizardfs_tpu_torch.runtime import tracing

            spans = json.loads(reply.json).get("spans", [])
            if trace_id:
                # merged per-request timeline for one trace
                timeline = tracing.merge_timeline(spans, trace_id)
                print(tracing.format_timeline(timeline))
                if args.attribute:
                    # where the milliseconds went: bucket decomposition
                    # of the same timeline (sums exactly to wall)
                    print(tracing.format_attribution(
                        tracing.attribute_timeline(timeline)
                    ))
            else:
                print(json.dumps(spans, indent=2))
            return 0
    elif cmd == "faults":
        sub = args.extra[0] if args.extra else "list"
        if sub == "arm":
            if len(args.extra) != 2:
                print("usage: faults arm 'ROLE:SITE[:OP[:PEER]] ACTION...'",
                      file=sys.stderr)
                return 2
            reply = await _admin(
                addr, "faults-arm",
                json.dumps({"rule": args.extra[1]}),
                password=args.password,
            )
        elif sub == "clear":
            reply = await _admin(addr, "faults-clear",
                                 password=args.password)
        elif sub == "list":
            reply = await _admin(addr, "faults", password=args.password)
        else:
            print("usage: faults [arm RULE | clear]", file=sys.stderr)
            return 2
        if getattr(reply, "status", 1) == st.OK:
            _print_faults(json.loads(reply.json))
            return 0
    elif cmd == "top":
        # live cluster workload view (the cluster analog of the
        # reference's per-mount .oplog): `top watch` refreshes until ^C
        watch = bool(args.extra) and args.extra[0] == "watch"
        while True:
            reply = await _admin(addr, "top", password=args.password)
            if getattr(reply, "status", 1) != st.OK:
                break
            if watch:
                print("\x1b[2J\x1b[H", end="")  # clear + home
            _print_top(json.loads(reply.json))
            if not watch:
                return 0
            await asyncio.sleep(2.0)
    elif cmd == "profile":
        top_n = int(args.extra[0]) if args.extra else 0
        reply = await _admin(
            addr, "profile",
            json.dumps({"top": top_n} if top_n else {}),
            password=args.password,
        )
        if getattr(reply, "status", 1) == st.OK:
            doc = json.loads(reply.json)
            print(
                f"# profiler role={doc.get('role', '?')} "
                f"enabled={doc.get('enabled')} "
                f"samples={doc.get('samples', 0)} "
                f"stacks={doc.get('stacks', 0)} "
                f"interval={doc.get('interval_ms', 0)}ms "
                f"cost={doc.get('sample_cost_us', 0)}us "
                f"budget={doc.get('overhead_budget_pct', 0)}%",
                file=sys.stderr,
            )
            # stdout carries pure collapsed-stack text, ready to pipe
            # into flamegraph.pl
            if doc.get("collapsed"):
                print(doc["collapsed"])
            return 0
    elif cmd == "qos":
        payload: dict = {}
        if args.extra:
            sub = args.extra[0]
            try:
                if sub == "weight" and len(args.extra) == 3:
                    payload = {"weight": {args.extra[1]:
                                          float(args.extra[2])}}
                elif sub == "rate" and len(args.extra) == 3:
                    payload = {"rate": {args.extra[1]:
                                        float(args.extra[2])}}
                elif sub in ("data-inflight-mb", "data-bps",
                             "rebuild-weight") and len(args.extra) == 2:
                    payload = {sub.replace("-", "_"):
                               float(args.extra[1])}
                else:
                    raise ValueError(sub)
            except ValueError:
                print("usage: qos [weight TENANT W | rate CLASS OPS | "
                      "data-inflight-mb MB | data-bps BPS | "
                      "rebuild-weight W]", file=sys.stderr)
                return 2
        reply = await _admin(addr, "qos", json.dumps(payload),
                             password=args.password)
        if getattr(reply, "status", 1) == st.OK:
            _print_qos(json.loads(reply.json))
            return 0
    elif cmd == "tweaks-set":
        if len(args.extra) != 2:
            print("usage: tweaks-set NAME VALUE", file=sys.stderr)
            return 2
        reply = await _admin(
            addr, cmd,
            json.dumps({"name": args.extra[0], "value": args.extra[1]}),
            password=args.password,
        )
    else:
        reply = await _admin(addr, cmd, password=args.password)
    if getattr(reply, "status", 1) != st.OK:
        print(f"error: {st.name(reply.status)} {getattr(reply, 'json', '')}",
              file=sys.stderr)
        return 1
    doc = json.loads(reply.json) if reply.json else {}
    if cmd == "health":
        _print_health(doc)
    elif cmd == "rebuild-status":
        _print_rebuild(doc)
    elif cmd == "heat":
        _print_heat(doc)
    elif cmd == "slowops":
        for e in doc.get("slowops", []):
            cap = "captured" if e.get("captured") else "uncaptured"
            attr = e.get("attribution") or {}
            dom = attr.get("dominant", "")
            dom_s = (
                f"  {dom} {attr.get('pct', {}).get(dom, 0.0):.0f}%"
                if dom else ""
            )
            print(
                f"{e['ms']:>10.1f} ms  {e['op_class']:<10s} "
                f"{e['name']:<20s} trace 0x{e['trace_id']:x}  ({cap})"
                f"{dom_s}"
            )
        if not doc.get("slowops"):
            print("(no SLO breaches recorded)")
    elif cmd == "list-chunkservers":
        for srv in doc.get("chunkservers", []):
            state = "up" if srv["connected"] else "DOWN"
            used = srv["used_space"] / 2**30
            total = srv["total_space"] / 2**30
            print(
                f"cs{srv['cs_id']:<3d} {srv['host']}:{srv['port']:<6d} "
                f"label={srv['label']:<8s} {state:<4s} "
                f"{used:.1f}/{total:.1f} GiB"
            )
    elif cmd == "list-sessions":
        print(f"sessions: {doc.get('sessions', 0)}")
    else:
        print(json.dumps(doc, indent=2, sort_keys=True))
    return 0


def _spark(points: list, width: int = 24) -> str:
    """ASCII sparkline of a metrics-history ring (trend rendering for
    the `top` view; empty ring -> empty string)."""
    pts = [max(float(p), 0.0) for p in points][-width:]
    if not pts:
        return ""
    peak = max(pts) or 1.0
    marks = " .:-=+*#%@"
    return "".join(
        marks[min(int(v / peak * (len(marks) - 1)), len(marks) - 1)]
        for v in pts
    )


def _print_top(doc: dict) -> None:
    """Render the master's cluster-wide `top` rollup: per-session op
    rates / bytes / p99 / exemplars, gateway protocol mixes, and the
    metrics-history trends."""
    totals = doc.get("totals", {})
    if not doc.get("enabled", True):
        print("per-session accounting is DISABLED (LZ_TOP=0)")
    print(
        f"cluster top — {totals.get('rate_ops', 0):.1f} ops/s across "
        f"{totals.get('sessions_tracked', 0)} tracked sessions "
        f"({totals.get('sessions_connected', 0)} connected)"
    )
    history = doc.get("history", {})
    for name in ("session_ops_rate", "cluster_slo_breaches",
                 "endangered_queue"):
        pts = history.get(name) or []
        if pts:
            print(f"  {name:<22s} [{_spark(pts):<24s}] now "
                  f"{pts[-1]:.1f}")
    # per-tenant rollup: aggregate rates + the admission verdict per
    # tenant (the multi-tenant QoS view; absent pre-QoS masters)
    tenants = doc.get("tenants", {})
    for tenant, row in sorted(
        tenants.items(), key=lambda kv: -kv[1].get("rate_ops", 0.0)
    ):
        flag = "  THROTTLED" if row.get("throttled") else ""
        print(f"  tenant {tenant:<12s} {row.get('sessions', 0)} sessions  "
              f"{row.get('rate_ops', 0.0):8.1f} ops/s{flag}")
    rows = sorted(
        doc.get("sessions", {}).items(),
        key=lambda kv: -kv[1].get("master", {}).get("rate_ops", 0.0),
    )
    print(
        f"  {'session':<10s} {'who':<22s} {'tenant':<10s} {'ops/s':>8s} "
        f"{'MB/s':>8s} {'p99 ms':>8s}  hot (class: ops/s, p99) / exemplar"
    )
    for label, entry in rows:
        mrow = entry.get("master", {})
        # bytes move on the data plane: sum this session's chunkserver
        # legs (the master leg has no payload bytes)
        cs_bytes = sum(
            r.get("rate_bytes", 0.0)
            for r in entry.get("chunkservers", {}).values()
        )
        who = (entry.get("info", "") or "?")[:22]
        classes = mrow.get("classes", {})
        hot = sorted(
            classes.items(), key=lambda kv: -kv[1].get("ops", 0)
        )[:2]
        hot_s = " ".join(
            f"{cls}:{v.get('ops', 0)}op/{v.get('p99_ms', 0):.0f}ms"
            for cls, v in hot
        )
        exemplar = mrow.get("exemplar", entry.get("exemplar", ""))
        print(
            f"  {label:<10s} {who:<22s} "
            f"{(entry.get('tenant', '') or '-')[:10]:<10s} "
            f"{mrow.get('rate_ops', 0.0):>8.1f} "
            f"{cs_bytes / 1e6:>8.2f} "
            f"{mrow.get('p99_ms', 0.0):>8.1f}  "
            f"{hot_s}{('  trace ' + exemplar) if exemplar else ''}"
        )
        phases = entry.get("read_phases")
        if phases and phases.get("reps"):
            # the top-level phases only: a part of one never dominates
            busy = {
                p: phases[f"{p}_ms"] for p in READ_PHASES
                if f"{p}_ms" in phases
            }
            dom = max(busy, key=lambda k: busy[k]) if busy else "?"
            busy_s = " ".join(
                f"{k}={v:.0f}ms" for k, v in sorted(
                    busy.items(), key=lambda kv: -kv[1]
                ) if v > 0
            )
            print(
                f"             `- read phases ({phases.get('reps', 0)} "
                f"reads, wall {phases.get('wall_ms', 0.0):.0f}ms) "
                f"dominant {dom}  {busy_s}"
            )
        gw = entry.get("gateway")
        if gw and gw.get("protocol"):
            proto = gw.get("protocol") or []
            mix = proto[0].get("classes", {}) if proto else {}
            top3 = sorted(
                mix.items(), key=lambda kv: -kv[1].get("ops", 0)
            )[:3]
            mix_s = " ".join(
                f"{cls}={v.get('ops', 0)}" for cls, v in top3
            )
            print(
                f"             `- {gw.get('role', '?')} gateway "
                f"{gw.get('endpoint', '')}  {mix_s}  "
                f"(pushed {gw.get('age_s', 0)}s ago)"
            )
    if not rows:
        print("  (no sessions tracked yet)")


def _print_qos(doc: dict) -> None:
    """Render the master's multi-tenant QoS state."""
    state = "armed" if doc.get("armed") else "unconfigured (admits all)"
    if not doc.get("enabled", True):
        state = "DISABLED (LZ_QOS off)"
    print(f"qos: {state}  generation {doc.get('generation', 0)}")
    rates = doc.get("rates", {})
    if rates:
        print("  rates   " + "  ".join(
            f"{cls}={int(r)}/s" for cls, r in sorted(rates.items())
        ))
    data = doc.get("data", {})
    if data:
        print(f"  data    inflight {data.get('inflight_mb', 0):.0f} MiB"
              f"  bps {int(data.get('data_bps', 0)) or 'off'}"
              f"  rebuild-weight {data.get('rebuild_weight', 1.0):g}")
    weights = doc.get("weights", {})
    sheds = doc.get("sheds", {})
    objectives = doc.get("objectives", {})
    active = set(doc.get("active_tenants", []))
    for tenant in sorted(set(weights) | set(sheds) | active):
        shed = sheds.get(tenant, {})
        obj = objectives.get(tenant)
        obj_s = ""
        if obj:
            flag = "BREACHED" if obj.get("breached") else "ok"
            obj_s = (f"  p99 {obj.get('p99_ms', 0):.1f}/"
                     f"{obj.get('objective_ms', 0):.0f}ms {flag}")
        print(f"  tenant {tenant:<12s} weight {weights.get(tenant, 1.0):g}"
              f"  {'active ' if tenant in active else '       '}"
              f"sheds {shed.get('count', 0)}"
              + (f" ({shed.get('age_s', 0)}s ago)" if shed else "")
              + obj_s)
    if not weights and not active:
        print("  (no tenants configured or active)")


def _print_faults(doc: dict) -> None:
    """Render a daemon's live fault-injection state."""
    state = "ARMED" if doc.get("active") else "inactive"
    print(f"faults: {state}  seed={doc.get('seed', 0)}  "
          f"role={doc.get('role', '?')}")
    for r in doc.get("rules", []):
        alias = f"  (alias {r['alias']})" if r.get("alias") else ""
        limit = f"/{r['limit']}" if r.get("limit") else ""
        print(f"  rule {r['rule']}  fired {r['fired']}{limit} "
              f"of {r['matched']} matches{alias}")
    if not doc.get("rules"):
        print("  (no rules armed)")
    for e in doc.get("events", [])[-8:]:
        print(f"  event {e['role']}:{e['site']}:{e['op']} -> {e['action']}")


def _print_rebuild(doc: dict) -> None:
    """Render the master RebuildEngine's progress report."""
    q = doc.get("queued", {})
    thr = doc.get("throttle", {})
    bps = thr.get("rebuild_bps", 0)
    eta = doc.get("eta_s")
    print(
        f"queued: lost {q.get('lost', 0)}  "
        f"endangered {q.get('endangered', 0)}  "
        f"rebalance {q.get('rebalance', 0)}  "
        f"(endangered-fifo {doc.get('endangered_queue', 0)})"
    )
    print(
        f"active {len(doc.get('active', []))}/"
        f"{thr.get('rebuild_concurrency', 0)}  "
        f"throttle {bps if bps else 'unlimited'} B/s  "
        f"rate {doc.get('rate_bps', 0):.0f} B/s  "
        f"eta {f'{eta:.0f}s' if eta is not None else '-'}"
    )
    print(
        f"completed {doc.get('completed', 0)}  "
        f"failed {doc.get('failed', 0)}  "
        f"bytes {doc.get('bytes_rebuilt', 0)}"
    )
    for rb in doc.get("active", []):
        print(
            f"  active {rb['kind']:<9s} chunk {rb['chunk_id']:016X} "
            f"part {rb['part']:<3d} [{rb['class']}] "
            f"{rb['running_s']:.1f}s trace 0x{rb['trace_id']:x}"
        )
    for e in doc.get("recent", [])[:8]:
        state = "ok" if e["ok"] else "FAILED"
        print(
            f"  recent {e['kind']:<9s} chunk {e['chunk_id']:016X} "
            f"part {e['part']:<3d} [{e['class']}] {state} {e['ms']:.0f}ms"
        )


def _print_health(doc: dict) -> None:
    """Render a health report: the master's cluster rollup, or a single
    daemon's snapshot when pointed at a chunkserver."""
    if "summary" not in doc:  # single-daemon snapshot
        print(f"{doc.get('role', '?')}: {doc.get('status', '?')}")
        for cls, s in sorted(doc.get("slo", {}).items()):
            print(
                f"  slo {cls:<10s} {s['status']:<9s} "
                f"burn {s['burn_fast']:.2f}/{s['burn_slow']:.2f}  "
                f"breaches {s['breaches']}/{s['ops']}"
            )
        print(
            f"  stalls {doc.get('loop_stalls', 0)}  "
            f"span-drops {doc.get('span_ring_dropped', 0)}  "
            f"disk-errors {doc.get('disk_errors', 0)}"
        )
        return
    s = doc["summary"]
    print(
        f"cluster: {doc['status'].upper()}  "
        f"(endangered {s['endangered']}, lost {s['lost']}, "
        f"cs-unhealthy {s['cs_unhealthy']}, "
        f"breaches {s['breaches_total']}, "
        f"worst-burn {s['worst_burn_fast']:.2f})"
    )
    master = doc.get("master", {})
    print(
        f"  master        {master.get('status', '?'):<9s} "
        f"breaches {master.get('breaches_total', 0)}  "
        f"stalls {master.get('loop_stalls', 0)}  "
        f"span-drops {master.get('span_ring_dropped', 0)}"
    )
    # multi-tenant QoS: NAME currently-throttled tenants + breached
    # per-tenant objectives right in the health render
    qos = doc.get("qos") or {}
    if qos.get("throttled"):
        print("  qos throttled: " + ", ".join(qos["throttled"]))
    for tenant, obj in sorted((qos.get("objectives") or {}).items()):
        if obj.get("breached"):
            print(f"  qos objective BREACHED: {tenant} p99 "
                  f"{obj.get('p99_ms', 0):.1f}ms > "
                  f"{obj.get('objective_ms', 0):.0f}ms")
    # shadow read replicas: applied-position lag per connected shadow
    # (the incident metric for the replica plane — staleness retries
    # climb when lag does)
    for i, sh in enumerate(doc.get("shadows", [])):
        print(
            f"  shadow{i:<7d} "
            f"{'serving' if sh.get('serving') else 'standby':<9s} "
            f"v{sh.get('version', 0)}  lag {sh.get('lag', 0)}  "
            f"acked {sh.get('age_s', 0)}s ago"
        )
    for cs_id, snap in sorted(doc.get("chunkservers", {}).items(),
                              key=lambda kv: int(kv[0])):
        print(
            f"  cs{cs_id:<12s} {snap.get('status', '?'):<9s} "
            f"breaches {snap.get('breaches_total', 0)}  "
            f"stalls {snap.get('loop_stalls', 0)}  "
            f"disk-errors {snap.get('disk_errors', 0)}"
        )


def _print_heat(doc: dict) -> None:
    """Render the cluster heat map: hottest chunks / inodes / servers
    (decayed scores), standing goal boosts, placement loads, and any
    heat-armed QoS pressure."""
    if not doc.get("enabled", True):
        print("cluster heat loop is DISABLED (LZ_HEAT=0)")
    th = doc.get("thresholds", {})
    print(
        f"heat map — half-life {doc.get('half_life_s', 0):.0f}s, "
        f"boost at {th.get('heat_boost_bytes', 0) / 2**20:.0f} MiB, "
        f"demote under {th.get('heat_demote_bytes', 0) / 2**20:.0f} MiB, "
        f"+{th.get('heat_boost_copies', 0)} copies, "
        f"max {th.get('heat_max_boosted', 0)} boosted"
    )
    boosted = doc.get("boosted") or {}
    if boosted:
        print("  boosted: " + ", ".join(
            f"chunk {cid} (+{b})" for cid, b in sorted(
                boosted.items(), key=lambda kv: int(kv[0])
            )
        ))
    if doc.get("qos_pressure"):
        print("  qos pressure armed on: " + ", ".join(doc["qos_pressure"]))
    for kind in ("chunks", "inodes", "servers"):
        rows = doc.get(kind) or []
        if not rows:
            continue
        print(f"  hottest {kind}:")
        for r in rows[:8]:
            trace = f"  trace {r['trace_id']}" if r.get("trace_id") else ""
            print(
                f"    {kind[:-1]:>6s} {r['key']:<12d} "
                f"{r['heat_bytes'] / 2**20:>8.1f} MiB-heat "
                f"{r['heat_ops']:>8.1f} ops-heat  "
                f"(lifetime {r['total_bytes'] / 2**20:.1f} MiB / "
                f"{r['total_ops']} ops){trace}"
            )
    load = doc.get("server_load") or {}
    if load:
        print("  placement load: " + ", ".join(
            f"cs{cs}={v:.2f}" for cs, v in sorted(
                load.items(), key=lambda kv: int(kv[0])
            )
        ))


def main(argv=None) -> int:
    try:
        return asyncio.run(_amain(argv if argv is not None else sys.argv[1:]))
    except KeyboardInterrupt:
        return 0  # `top watch` exits via ^C by design
    except (ConnectionError, OSError, asyncio.TimeoutError) as e:
        # TimeoutError: the bounded 5 s dial — on 3.10 it is not an
        # OSError subclass, and a blackholed daemon must print the
        # clean error, not a traceback
        print(f"error: cannot reach daemon: {str(e) or 'dial timed out'}",
              file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
