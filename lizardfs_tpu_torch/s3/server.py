"""S3-compatible object gateway: asyncio HTTP server over the cluster
``Client``.

The third protocol front door (after FUSE and the NFS gateway),
following the proven pattern: protocol server -> internal ``Client`` ->
data plane. One asyncio process, one cluster client session shared by
every consumer.

Namespace mapping (bucket = directory, object = file):

* buckets are directories directly under the export root; bucket names
  follow the S3 grammar (3-63 chars of ``[a-z0-9.-]``) and never start
  with a dot — dot-names are the gateway's private area;
* object keys map to paths under the bucket; ``/`` in a key creates
  real intermediate directories (so FUSE/NFS see the same tree);
* every PUT lands in the hidden ``.s3mpu`` staging dir and RENAMES
  into place — a GET never observes a torn object;
* multipart uploads stage parts as files; CompleteMultipartUpload maps
  chunk-aligned parts onto the master's O(1) ``appendchunks``
  chunk-share concat (no re-copy of uploaded bytes; a non-aligned tail
  falls back to a positional copy, counted separately in metrics).

Lifecycle tiering: ``PUT /bucket?lifecycle`` stores the rule as the
``S3_LIFECYCLE_XATTR`` JSON on the bucket directory plus the
``EATTR_LIFECYCLE`` marker bit; the MASTER's lifecycle scanner demotes
cold objects through the tapeserver flow, and a GET of a demoted object
triggers a recall (``CltomaTapeRecall``) and then serves the original
bytes.

Runtime substrate: every request begins an ``s3_<op>`` trace span whose
id propagates into master RPCs and the data plane, feeds the ``s3`` SLO
class (FlightRecorder on breach), counts into a metrics-lint-clean
registry served at ``GET /metrics``, passes the ``http_recv``/
``http_send`` fault-injection sites, and runs under one end-to-end
request deadline (ambient ``RetryPolicy`` budget on every nested dial).

No AWS signature verification: the gateway trusts its network like the
NFS gateway trusts AUTH_SYS — front it with your own authn or keep it
on a private network (doc/operations.md runbook).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import secrets
import time
import urllib.parse

from lizardfs_tpu_torch import constants
from lizardfs_tpu_torch.client.client import Client
from lizardfs_tpu_torch.constants import EATTR_LIFECYCLE, MFSCHUNKSIZE
from lizardfs_tpu_torch.proto import messages as m
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime import accounting
from lizardfs_tpu_torch.runtime import faults as faultsmod
from lizardfs_tpu_torch.runtime import profiler as profmod
from lizardfs_tpu_torch.runtime import retry as retrymod
from lizardfs_tpu_torch.runtime import slo as slomod
from lizardfs_tpu_torch.runtime import tracing
from lizardfs_tpu_torch.runtime.metrics import Metrics
from lizardfs_tpu_torch.s3 import xmlutil

log = logging.getLogger("lizardfs.s3")

MPU_DIR = ".s3mpu"  # staging area under the export root (never listed)
MAX_KEYS_CAP = 1000
# one request's wall budget: bounds every nested master RPC / data-plane
# dial through the ambient RetryPolicy deadline
REQUEST_DEADLINE_S = 120.0
MAX_HEADER_BYTES = 16 * 1024
MAX_BODY_BYTES = 1 << 31  # 2 GiB per PUT/part; multipart scales beyond
IO_TIMEOUT_S = 60.0  # per read/write on the HTTP socket

_HOP_STATUS = {
    200: "OK", 204: "No Content", 206: "Partial Content",
    307: "Temporary Redirect", 400: "Bad Request", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
    411: "Length Required", 413: "Payload Too Large",
    416: "Range Not Satisfiable", 500: "Internal Server Error",
    501: "Not Implemented", 503: "Service Unavailable",
}


class _HttpError(Exception):
    """Maps straight to an S3 error response."""

    def __init__(self, http: int, code: str, message: str):
        self.http = http
        self.code = code
        self.message = message
        super().__init__(f"{http} {code}: {message}")


def _status_error(e: st.StatusError, resource: str) -> _HttpError:
    table = {
        st.ENOENT: (404, "NoSuchKey", "not found"),
        st.ENOTDIR: (404, "NoSuchKey", "not found"),
        st.EISDIR: (404, "NoSuchKey", "key names a directory"),
        st.EEXIST: (409, "BucketAlreadyExists", "already exists"),
        st.ENOTEMPTY: (409, "BucketNotEmpty", "bucket not empty"),
        st.EACCES: (403, "AccessDenied", "access denied"),
        st.EPERM: (403, "AccessDenied", "access denied"),
        st.EROFS: (403, "AccessDenied", "read-only session"),
        st.QUOTA_EXCEEDED: (403, "QuotaExceeded", "quota exceeded"),
        st.TAPE_RECALL: (
            503, "RestoreInProgress",
            "object is on the tape tier; restore in progress — retry",
        ),
        st.CHUNK_BUSY: (503, "SlowDown", "busy; retry"),
        # QoS fair-share shed: this bucket's tenant is over budget —
        # S3 semantics are exactly SlowDown (client backs off)
        st.BUSY: (503, "SlowDown", "tenant over fair share; slow down"),
        st.NO_CHUNK_SERVERS: (503, "SlowDown", "no chunkservers"),
        # recall-path failures are transient by contract (tape server
        # restarting / restore outliving one RPC budget): retryable,
        # never a permanent InternalError
        st.NOT_POSSIBLE: (503, "SlowDown",
                          "tape tier unavailable; retry"),
        st.TIMEOUT: (503, "SlowDown", "timed out; retry"),
    }
    http, code, msg = table.get(e.code, (500, "InternalError", str(e)))
    return _HttpError(http, code, f"{msg} ({resource})")


def _valid_bucket(name: str) -> bool:
    if not (3 <= len(name) <= 63) or name in (
        "metrics", "healthz", "profile", "top"
    ):
        return False
    if name[0] in ".-" or name[-1] in ".-":
        return False
    return all(c.islower() or c.isdigit() or c in ".-" for c in name)


def _key_segments(key: str) -> list[str]:
    """Split an object key into path segments; reject anything that
    could escape the bucket or collide with gateway-private names."""
    if not key or len(key) > 4096 or key.endswith("/"):
        raise _HttpError(400, "InvalidArgument", f"bad key {key!r}")
    segs = key.split("/")
    for s in segs:
        if not s or s in (".", "..") or len(s) > 255:
            raise _HttpError(400, "InvalidArgument", f"bad key {key!r}")
    if segs[0].startswith("."):
        raise _HttpError(400, "InvalidArgument", "keys may not start with .")
    return segs


def _http_date(epoch: int) -> str:
    return time.strftime(
        "%a, %d %b %Y %H:%M:%S GMT", time.gmtime(max(epoch, 0))
    )


def _iso8601(epoch: int) -> str:
    return time.strftime(
        "%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(max(epoch, 0))
    )


class _Request:
    __slots__ = ("method", "path", "query", "headers", "body", "peer")

    def __init__(self, method, path, query, headers, body, peer):
        self.method = method
        self.path = path
        self.query = query  # dict[str, str] (first value wins)
        self.headers = headers  # dict[str, str], lower-cased keys
        self.body = body
        self.peer = peer


class S3Gateway:
    """One process serving the S3 REST subset (plus ``/metrics`` and
    ``/healthz`` observability endpoints) over one cluster session.

    ``root`` names the cluster directory exported as the bucket
    namespace ("/" by default — buckets appear at the filesystem
    root, visible identically over FUSE and NFS)."""

    def __init__(
        self,
        master_host: str,
        master_port: int,
        host: str = "127.0.0.1",
        port: int = 0,
        root: str = "/",
        encoder=None,
    ) -> None:
        # gateway-local registry shared with the embedded Client (the
        # NFS gateway pattern): client-side write-window/cache series
        # land next to the s3 op counters and SLO gauges, all served
        # from GET /metrics in one lint-clean page
        self.metrics = Metrics()
        self.client = Client(master_host, master_port, metrics=self.metrics,
                             encoder=encoder)
        self.host = host
        self.port = port
        self.root = root
        self.root_inode = 0
        self._mpu_inode = 0
        self._server: asyncio.Server | None = None
        self.request_deadline_s = REQUEST_DEADLINE_S
        # the s3 SLO class: per-request latency objectives feeding the
        # FlightRecorder (slowops/incidents) and the health rollup
        self.slo = slomod.SloEngine(
            self.metrics, role="s3",
            span_source=self.client.trace_ring.dump,
        )
        # per-session protocol-op accounting, pushed to the master's
        # `top` rollup (CltomaSessionStats) — the NFS gateway pattern
        self.session_ops = accounting.SessionOps(
            self.metrics, "s3", max_sessions=8
        )
        self.stats_push_interval_s = 5.0
        self._stats_task: asyncio.Task | None = None
        # always-on sampling profiler (process-wide shared instance),
        # served at GET /profile
        self.profiler = profmod.process_profiler(role="s3")
        self.slo.profiler = self.profiler
        self.slo.recorder.profile_source = self.profiler.collapsed
        self.metrics.counter(
            "s3_bytes_in", help="object bytes received in PUT/UploadPart"
        )
        self.metrics.counter(
            "s3_bytes_out", help="object bytes served by GET"
        )
        self.metrics.counter(
            "s3_mpu_parts_shared",
            help="multipart parts assembled via O(1) appendchunks "
                 "chunk-share (no byte re-copy)",
        )
        self.metrics.counter(
            "s3_mpu_parts_copied",
            help="multipart parts assembled by positional re-copy "
                 "(previous part left a non-chunk-aligned tail)",
        )
        self.metrics.counter(
            "s3_mpu_copied_bytes",
            help="bytes re-copied by non-aligned multipart assembly",
        )
        self.metrics.counter(
            "s3_recalls",
            help="GETs that triggered a tape-tier recall before serving",
        )

    # --- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        if not constants.s3_enabled():
            raise RuntimeError(
                "S3 gateway disabled by the LZ_S3 kill switch"
            )
        # one 30 s startup budget over every dial the nested connect
        # makes (gateway racing master startup/election — NFS pattern)
        await retrymod.RetryPolicy(
            attempts=10, base_delay=0.2, max_delay=2.0, deadline=30.0,
        ).run(
            lambda: self.client.connect(info="s3-gateway"),
            what="s3 gateway master connect", log=log,
        )
        root = await self.client.resolve(self.root)
        self.root_inode = root.inode
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self.profiler.start()  # no-op under LZ_PROF=0
        self._stats_task = asyncio.ensure_future(self._stats_push_loop())
        log.info("s3 gateway on port %d (root %s)", self.port, self.root)

    async def stop(self) -> None:
        if self._stats_task is not None:
            self._stats_task.cancel()
            try:
                await self._stats_task
            except asyncio.CancelledError:
                pass
        self.profiler.stop()
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                pass
        await self.client.close()

    def _stats_doc(self) -> dict:
        """Workload summary pushed to the master (`top` rollup) and
        mirrored at GET /top: protocol-op mix + the embedded Client's
        logical data-op accounting."""
        return {
            "role": "s3",
            "endpoint": f"{self.host}:{self.port}",
            "protocol": self.session_ops.top(8),
            "data": self.client.session_ops.top(8),
        }

    def _stats_push_loop(self):
        """The shared gateway push contract (CltomaSessionStats every
        few seconds — runtime/accounting.py owns the loop so the NFS
        and S3 gateways cannot drift apart on it)."""
        return accounting.gateway_stats_push_loop(
            self.client, self._stats_doc, self.stats_push_interval_s, log
        )

    # --- HTTP framing ------------------------------------------------------

    async def _serve_conn(self, reader, writer) -> None:
        peer = writer.get_extra_info("peername")
        peer_s = f"{peer[0]}:{peer[1]}" if isinstance(peer, tuple) else "?"
        try:
            while True:
                try:
                    req = await self._read_request(reader, writer, peer_s)
                except _HttpError as e:
                    # framing-level refusal (chunked TE, oversized body):
                    # answer once, then drop the connection
                    await self._respond(
                        writer, "BadRequest", peer_s, e.http,
                        xmlutil.error_xml(e.code, e.message).encode(),
                        {"Content-Type": "application/xml",
                         "Connection": "close"},
                    )
                    return
                if req is None:
                    return
                keep = await self._dispatch(req, writer)
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.TimeoutError, asyncio.LimitOverrunError):
            pass  # peer went away / fault injection killed the exchange
        except Exception:  # noqa: BLE001 — a crashed handler must not kill the gateway
            log.exception("s3 connection from %s crashed", peer_s)
        finally:
            await retrymod.close_writer(writer, swallow_cancel=True)

    async def _read_request(self, reader, writer, peer_s):
        # keep-alive park: an idle client may sit between requests for
        # as long as it likes — the wait owns no budget by design
        # lint: waive(unbounded-await): keep-alive idle park between requests; the peer owns the cadence
        line = await reader.readline()
        if not line:
            return None
        try:
            method, target, _version = line.decode("ascii").split(" ", 2)
        except (UnicodeDecodeError, ValueError):
            return None
        headers: dict[str, str] = {}
        total = len(line)
        while True:
            hl = await retrymod.bounded_wait(reader.readline(), IO_TIMEOUT_S)
            total += len(hl)
            if total > MAX_HEADER_BYTES:
                return None
            if hl in (b"\r\n", b"\n", b""):
                break
            name, _, value = hl.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        if faultsmod.ACTIVE:
            await faultsmod.async_point(
                "http_recv", op=method, peer=peer_s, role="s3"
            )
        if headers.get("transfer-encoding", "").lower() == "chunked":
            raise _HttpError(501, "NotImplemented",
                             "chunked transfer encoding")
        body = b""
        clen = int(headers.get("content-length", "0") or "0")
        if clen:
            if clen > MAX_BODY_BYTES:
                raise _HttpError(413, "EntityTooLarge", "body too large")
            if headers.get("expect", "").lower() == "100-continue":
                writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                await asyncio.wait_for(writer.drain(), IO_TIMEOUT_S)
            body = await retrymod.bounded_wait(
                reader.readexactly(clen), IO_TIMEOUT_S
            )
        parsed = urllib.parse.urlsplit(target)
        query = {
            k: (v[0] if v else "")
            for k, v in urllib.parse.parse_qs(
                parsed.query, keep_blank_values=True
            ).items()
        }
        path = urllib.parse.unquote(parsed.path)
        return _Request(method, path, query, headers, body, peer_s)

    async def _respond(
        self, writer, opname: str, peer: str, code: int,
        body: bytes = b"", headers: dict | None = None, head_only=False,
    ) -> None:
        if faultsmod.ACTIVE:
            await faultsmod.async_point(
                "http_send", op=opname, peer=peer, role="s3"
            )
        hdrs = {
            "x-amz-request-id": secrets.token_hex(8),
            "Content-Length": str(len(body)),
            "Connection": "keep-alive",
            **(headers or {}),
        }
        lines = [f"HTTP/1.1 {code} {_HOP_STATUS.get(code, 'OK')}"]
        lines += [f"{k}: {v}" for k, v in hdrs.items()]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        if body and not head_only:
            # separate write: headers + a multi-MB object body must not
            # concatenate into a second full copy of the object
            writer.write(body)
        await asyncio.wait_for(writer.drain(), IO_TIMEOUT_S)

    # --- dispatch ----------------------------------------------------------

    def _route(self, req: _Request) -> tuple[str, object, tuple]:
        """(op name, handler, args) for one parsed request."""
        path = req.path.strip("/")
        if req.method == "GET" and path == "metrics":
            return "Metrics", self._op_metrics, ()
        if req.method == "GET" and path == "healthz":
            return "Healthz", self._op_healthz, ()
        if req.method == "GET" and path == "profile":
            return "Profile", self._op_profile, ()
        if req.method == "GET" and path == "top":
            return "Top", self._op_top, ()
        if not path:
            if req.method == "GET":
                return "ListBuckets", self._op_list_buckets, ()
            raise _HttpError(405, "MethodNotAllowed", req.method)
        bucket, _, key = path.partition("/")
        if not key:
            if "lifecycle" in req.query:
                ops = {"PUT": ("PutBucketLifecycle", self._op_put_lifecycle),
                       "GET": ("GetBucketLifecycle", self._op_get_lifecycle),
                       "DELETE": ("DeleteBucketLifecycle",
                                  self._op_delete_lifecycle)}
                if req.method in ops:
                    name, fn = ops[req.method]
                    return name, fn, (bucket,)
                raise _HttpError(405, "MethodNotAllowed", req.method)
            ops = {"PUT": ("CreateBucket", self._op_create_bucket),
                   "DELETE": ("DeleteBucket", self._op_delete_bucket),
                   "HEAD": ("HeadBucket", self._op_head_bucket),
                   "GET": ("ListObjectsV2", self._op_list_objects)}
            if req.method in ops:
                name, fn = ops[req.method]
                return name, fn, (bucket,)
            raise _HttpError(405, "MethodNotAllowed", req.method)
        if req.method == "POST" and "uploads" in req.query:
            return "CreateMultipartUpload", self._op_mpu_create, (bucket, key)
        if req.method == "POST" and "uploadId" in req.query:
            return ("CompleteMultipartUpload", self._op_mpu_complete,
                    (bucket, key))
        if req.method == "PUT" and "uploadId" in req.query:
            return "UploadPart", self._op_mpu_part, (bucket, key)
        if req.method == "DELETE" and "uploadId" in req.query:
            return "AbortMultipartUpload", self._op_mpu_abort, (bucket, key)
        ops = {"PUT": ("PutObject", self._op_put_object),
               "GET": ("GetObject", self._op_get_object),
               "HEAD": ("HeadObject", self._op_head_object),
               "DELETE": ("DeleteObject", self._op_delete_object)}
        if req.method in ops:
            name, fn = ops[req.method]
            return name, fn, (bucket, key)
        raise _HttpError(405, "MethodNotAllowed", req.method)

    async def _dispatch(self, req: _Request, writer) -> bool:
        """Handle one request; returns keep-alive. The request is the
        trace root: the id issued here rides every master RPC and
        data-plane frame the op triggers, and the op feeds the s3 SLO
        class + per-op request counters."""
        opname = "Unknown"
        t0 = time.perf_counter()
        tid, fresh = tracing.begin()
        code = 500
        try:
            try:
                opname, handler, args = self._route(req)
                code, body, headers, head_only = await retrymod.RetryPolicy(
                    attempts=1, deadline=self.request_deadline_s,
                ).run(
                    lambda: handler(req, *args),
                    what=f"s3 {opname}", log=log,
                )
            except _HttpError as e:
                code, body, headers, head_only = (
                    e.http,
                    xmlutil.error_xml(e.code, e.message, req.path).encode(),
                    {"Content-Type": "application/xml"},
                    req.method == "HEAD",
                )
            except st.StatusError as e:
                he = _status_error(e, req.path)
                code, body, headers, head_only = (
                    he.http,
                    xmlutil.error_xml(he.code, he.message, req.path).encode(),
                    {"Content-Type": "application/xml"},
                    req.method == "HEAD",
                )
            except retrymod.RetryError:
                code, body, headers, head_only = (
                    503,
                    xmlutil.error_xml(
                        "SlowDown", "request deadline exhausted", req.path
                    ).encode(),
                    {"Content-Type": "application/xml"},
                    req.method == "HEAD",
                )
            await self._respond(
                writer, opname, req.peer, code, body, headers, head_only
            )
            return req.headers.get("connection", "").lower() != "close"
        finally:
            t1 = time.perf_counter()
            dt = t1 - t0
            self.metrics.labeled_counter(
                "s3_requests", {"op": opname, "code": str(code)},
                help="S3 gateway requests by operation and HTTP status",
            ).inc()
            self.client.trace_ring.record(
                tid, f"s3_{opname}", t0, t1, role="s3"
            )
            self.slo.observe("s3", dt, trace_id=tid, name=f"s3_{opname}")
            # per-session protocol accounting: the op charged to this
            # gateway's cluster session for the master's `top` rollup
            self.session_ops.record(
                self.client.session_id, f"s3_{opname}", dt,
                nbytes=len(req.body), trace_id=tid,
            )
            tracing.end(fresh)

    # --- namespace helpers -------------------------------------------------

    async def _bucket_attr(self, bucket: str) -> m.Attr:
        if not _valid_bucket(bucket):
            raise _HttpError(400, "InvalidBucketName", bucket)
        try:
            attr = await self.client.lookup(self.root_inode, bucket)
        except st.StatusError as e:
            if e.code == st.ENOENT:
                raise _HttpError(404, "NoSuchBucket", bucket) from None
            raise
        if attr.ftype != m.FTYPE_DIR:
            raise _HttpError(404, "NoSuchBucket", bucket)
        return attr

    async def _resolve_key(self, bucket_inode: int, key: str) -> m.Attr:
        attr = None
        parent = bucket_inode
        for seg in _key_segments(key):
            attr = await self.client.lookup(parent, seg)
            parent = attr.inode
        if attr is None or attr.ftype != m.FTYPE_FILE:
            raise st.StatusError(st.ENOENT, key)
        return attr

    async def _ensure_dirs(self, parent: int, segs: list[str]) -> int:
        """mkdir -p for a key's intermediate directories."""
        for seg in segs:
            try:
                attr = await self.client.mkdir(parent, seg)
            except st.StatusError as e:
                if e.code != st.EEXIST:
                    raise
                attr = await self.client.lookup(parent, seg)
                if attr.ftype != m.FTYPE_DIR:
                    raise _HttpError(
                        409, "InvalidArgument",
                        f"key prefix {seg!r} names an object",
                    ) from None
            parent = attr.inode
        return parent

    async def _mpu_root(self) -> int:
        if self._mpu_inode:
            return self._mpu_inode
        try:
            attr = await self.client.mkdir(self.root_inode, MPU_DIR)
        except st.StatusError as e:
            if e.code != st.EEXIST:
                raise
            attr = await self.client.lookup(self.root_inode, MPU_DIR)
        self._mpu_inode = attr.inode
        return attr.inode

    async def _write_staged(self, name: str, data: bytes) -> m.Attr:
        """Create + write a file in the staging area (trash-time 0: a
        replaced/aborted stage must free its chunks immediately).
        Names are caller-generated random tokens, so EEXIST only means
        a dead gateway's leftover — replace it."""
        staging = await self._mpu_root()
        try:
            attr = await self.client.create(staging, name)
        except st.StatusError as e:
            if e.code != st.EEXIST:
                raise
            await self.client.unlink(staging, name)
            attr = await self.client.create(staging, name)
        await self.client.settrashtime(attr.inode, 0)
        if data:
            await self.client.write_file(attr.inode, data)
        return attr

    async def _set_etag(self, inode: int, etag: str) -> None:
        await self.client.set_xattr(
            inode, constants.S3_ETAG_XATTR, etag.encode()
        )

    async def _get_etag(self, inode: int) -> str | None:
        try:
            raw = await self.client.get_xattr(
                inode, constants.S3_ETAG_XATTR
            )
            return raw.decode("ascii", "replace")
        except st.StatusError:
            return None

    async def _publish(self, bucket: str, key: str,
                       staged_name: str) -> None:
        """Atomically move a staged object into place: the key becomes
        visible fully-written or not at all (rename replaces any
        previous object under the key in the same step)."""
        battr = await self._bucket_attr(bucket)
        segs = _key_segments(key)
        parent = await self._ensure_dirs(battr.inode, segs[:-1])
        staging = await self._mpu_root()
        await self.client.rename(staging, staged_name, parent, segs[-1])

    # --- service / bucket ops ---------------------------------------------

    async def _op_metrics(self, req: _Request):
        text = self.metrics.to_prometheus().encode()
        return 200, text, {"Content-Type": "text/plain; version=0.0.4"}, False

    async def _op_healthz(self, req: _Request):
        doc = {
            "role": "s3",
            "status": self.slo.status() if slomod.enabled() else "ok",
            "slo": self.slo.snapshot() if slomod.enabled() else {},
            "slow_ops": len(self.slo.recorder.slowops()),
        }
        return (200, json.dumps(doc).encode(),
                {"Content-Type": "application/json"}, False)

    async def _op_profile(self, req: _Request):
        doc = self.profiler.snapshot()
        doc["role"] = "s3"  # process-wide sampler, this surface's dump
        doc["collapsed"] = self.profiler.collapsed()
        return (200, json.dumps(doc).encode(),
                {"Content-Type": "application/json"}, False)

    async def _op_top(self, req: _Request):
        return (200, json.dumps(self._stats_doc()).encode(),
                {"Content-Type": "application/json"}, False)

    async def _op_list_buckets(self, req: _Request):
        entries = await self.client.readdir(self.root_inode)
        rows = []
        for e in sorted(entries, key=lambda e: e.name):
            if e.ftype != m.FTYPE_DIR or not _valid_bucket(e.name):
                continue
            attr = await self.client.getattr(e.inode)
            rows.append(
                f"<Bucket><Name>{xmlutil.esc(e.name)}</Name>"
                f"<CreationDate>{_iso8601(attr.ctime)}</CreationDate>"
                f"</Bucket>"
            )
        body = (
            f"{xmlutil.XML_DECL}<ListAllMyBucketsResult"
            f" xmlns=\"{xmlutil.S3_NS}\"><Owner><ID>lizardfs</ID></Owner>"
            f"<Buckets>{''.join(rows)}</Buckets></ListAllMyBucketsResult>"
        )
        return 200, body.encode(), {"Content-Type": "application/xml"}, False

    async def _op_create_bucket(self, req: _Request, bucket: str):
        if not _valid_bucket(bucket):
            raise _HttpError(400, "InvalidBucketName", bucket)
        try:
            await self.client.mkdir(self.root_inode, bucket)
        except st.StatusError as e:
            if e.code != st.EEXIST:
                raise
            existing = await self.client.lookup(self.root_inode, bucket)
            if existing.ftype != m.FTYPE_DIR:
                raise _HttpError(409, "BucketAlreadyExists", bucket) from None
            # idempotent re-create of an existing bucket: S3 allows it
        return 200, b"", {"Location": f"/{bucket}"}, False

    async def _op_head_bucket(self, req: _Request, bucket: str):
        await self._bucket_attr(bucket)
        return 200, b"", {}, True

    async def _op_delete_bucket(self, req: _Request, bucket: str):
        await self._bucket_attr(bucket)
        await self.client.rmdir(self.root_inode, bucket)
        return 204, b"", {}, False

    # --- lifecycle config --------------------------------------------------

    async def _op_put_lifecycle(self, req: _Request, bucket: str):
        rule = xmlutil.parse_lifecycle(req.body)
        if rule is None:
            raise _HttpError(400, "MalformedXML",
                             "no parseable Transition rule")
        attr = await self._bucket_attr(bucket)
        await self.client.set_xattr(
            attr.inode, constants.S3_LIFECYCLE_XATTR,
            json.dumps(rule).encode(),
        )
        eattr = await self.client.geteattr(attr.inode)
        if not eattr & EATTR_LIFECYCLE:
            await self.client.seteattr(attr.inode, eattr | EATTR_LIFECYCLE)
        return 200, b"", {}, False

    async def _op_get_lifecycle(self, req: _Request, bucket: str):
        attr = await self._bucket_attr(bucket)
        try:
            raw = await self.client.get_xattr(
                attr.inode, constants.S3_LIFECYCLE_XATTR
            )
        except st.StatusError:
            raise _HttpError(
                404, "NoSuchLifecycleConfiguration", bucket
            ) from None
        try:
            rule = json.loads(raw.decode())
        except ValueError:
            raise _HttpError(
                404, "NoSuchLifecycleConfiguration", bucket
            ) from None
        body = xmlutil.render_lifecycle(rule)
        return 200, body.encode(), {"Content-Type": "application/xml"}, False

    async def _op_delete_lifecycle(self, req: _Request, bucket: str):
        attr = await self._bucket_attr(bucket)
        try:
            await self.client.remove_xattr(
                attr.inode, constants.S3_LIFECYCLE_XATTR
            )
        except st.StatusError:
            pass  # idempotent
        eattr = await self.client.geteattr(attr.inode)
        if eattr & EATTR_LIFECYCLE:
            await self.client.seteattr(attr.inode, eattr & ~EATTR_LIFECYCLE)
        return 204, b"", {}, False

    # --- listing -----------------------------------------------------------

    async def _walk_keys(self, dir_inode: int, prefix: str,
                         out: dict[str, int]) -> None:
        """Collect key -> inode for the whole subtree (inodes come from
        readdir, so the listing window never re-resolves keys
        segment-by-segment)."""
        entries = await self.client.readdir(dir_inode)
        for e in sorted(entries, key=lambda e: e.name):
            if e.name.startswith(".") and not prefix:
                continue  # gateway-private names live at bucket root only
            if e.ftype == m.FTYPE_DIR:
                await self._walk_keys(e.inode, prefix + e.name + "/", out)
            elif e.ftype == m.FTYPE_FILE:
                out[prefix + e.name] = e.inode

    async def _op_list_objects(self, req: _Request, bucket: str):
        battr = await self._bucket_attr(bucket)
        prefix = req.query.get("prefix", "")
        delimiter = req.query.get("delimiter", "")
        try:
            max_keys = min(
                int(req.query.get("max-keys", str(MAX_KEYS_CAP))),
                MAX_KEYS_CAP,
            )
            if max_keys < 0:
                raise ValueError(max_keys)
        except ValueError:
            raise _HttpError(400, "InvalidArgument", "max-keys") from None
        token = req.query.get("continuation-token", "")
        after = ""
        if token:
            try:
                after = base64.urlsafe_b64decode(token.encode()).decode()
            except (ValueError, UnicodeDecodeError):
                raise _HttpError(
                    400, "InvalidArgument", "continuation-token"
                ) from None
        key_inodes: dict[str, int] = {}
        await self._walk_keys(battr.inode, "", key_inodes)
        keys = sorted(key_inodes)
        # delimiter grouping over the prefix-filtered, post-token tail:
        # items are (sort key, is_prefix); S3 interleaves Contents and
        # CommonPrefixes in one lexicographic stream
        items: list[tuple[str, bool]] = []
        seen_prefixes: set[str] = set()
        for k in keys:
            if not k.startswith(prefix):
                continue
            if delimiter:
                rest = k[len(prefix):]
                cut = rest.find(delimiter)
                if cut >= 0:
                    cp = prefix + rest[: cut + len(delimiter)]
                    if cp not in seen_prefixes:
                        seen_prefixes.add(cp)
                        items.append((cp, True))
                    continue
            items.append((k, False))
        items = [it for it in items if it[0] > after]
        window = items[:max_keys]
        truncated = len(items) > len(window)
        contents, cprefixes = [], []
        for name, is_prefix in window:
            if is_prefix:
                cprefixes.append(
                    f"<CommonPrefixes><Prefix>{xmlutil.esc(name)}</Prefix>"
                    f"</CommonPrefixes>"
                )
                continue
            attr = await self.client.getattr(key_inodes[name])
            etag = await self._get_etag(attr.inode) or ""
            contents.append(
                f"<Contents><Key>{xmlutil.esc(name)}</Key>"
                f"<LastModified>{_iso8601(attr.mtime)}</LastModified>"
                f"<ETag>&quot;{xmlutil.esc(etag)}&quot;</ETag>"
                f"<Size>{attr.length}</Size>"
                f"<StorageClass>STANDARD</StorageClass></Contents>"
            )
        next_token = ""
        if truncated and window:
            next_token = base64.urlsafe_b64encode(
                window[-1][0].encode()
            ).decode()
        body = (
            f"{xmlutil.XML_DECL}<ListBucketResult xmlns=\"{xmlutil.S3_NS}\">"
            f"<Name>{xmlutil.esc(bucket)}</Name>"
            f"<Prefix>{xmlutil.esc(prefix)}</Prefix>"
            f"<Delimiter>{xmlutil.esc(delimiter)}</Delimiter>"
            f"<KeyCount>{len(window)}</KeyCount>"
            f"<MaxKeys>{max_keys}</MaxKeys>"
            f"<IsTruncated>{'true' if truncated else 'false'}</IsTruncated>"
            + (f"<NextContinuationToken>{next_token}"
               f"</NextContinuationToken>" if next_token else "")
            + "".join(contents) + "".join(cprefixes)
            + "</ListBucketResult>"
        )
        return 200, body.encode(), {"Content-Type": "application/xml"}, False

    # --- object ops --------------------------------------------------------

    async def _op_put_object(self, req: _Request, bucket: str, key: str):
        await self._bucket_attr(bucket)
        _key_segments(key)
        etag = hashlib.md5(req.body).hexdigest()
        name = f"put-{secrets.token_hex(12)}"
        staged = await self._write_staged(name, req.body)
        await self._set_etag(staged.inode, etag)
        await self._publish(bucket, key, name)
        self.metrics.counter("s3_bytes_in").inc(float(len(req.body)))
        return 200, b"", {"ETag": f'"{etag}"'}, False

    def _parse_range(self, req: _Request, length: int):
        spec = req.headers.get("range", "")
        if not spec.startswith("bytes="):
            return 0, length, False
        lo_s, _, hi_s = spec[len("bytes="):].partition("-")
        try:
            if lo_s:
                lo = int(lo_s)
                hi = int(hi_s) if hi_s else length - 1
            else:
                # suffix form: last N bytes
                lo = max(length - int(hi_s), 0)
                hi = length - 1
        except ValueError:
            return 0, length, False
        if lo > hi or lo >= max(length, 1):
            raise _HttpError(416, "InvalidRange", spec)
        hi = min(hi, length - 1)
        return lo, hi - lo + 1, True

    async def _read_with_recall(self, inode: int, off: int,
                                size: int) -> bytes:
        """read_file that survives the tape tier: a TAPE_RECALL status
        triggers the master-side recall (bounded by the ambient request
        deadline) and one retry once the bytes are back."""
        try:
            return await self.client.read_file(inode, off, size)
        except st.StatusError as e:
            if e.code != st.TAPE_RECALL:
                raise
        self.metrics.counter("s3_recalls").inc()
        await self.client.tape_recall(inode)
        return await self.client.read_file(inode, off, size)

    async def _op_get_object(self, req: _Request, bucket: str, key: str,
                             head_only: bool = False):
        battr = await self._bucket_attr(bucket)
        attr = await self._resolve_key(battr.inode, key)
        etag = await self._get_etag(attr.inode)
        info_headers = {
            "Last-Modified": _http_date(attr.mtime),
            "Content-Type": "application/octet-stream",
            "Accept-Ranges": "bytes",
        }
        if etag:
            info_headers["ETag"] = f'"{etag}"'
        if head_only:
            info_headers["Content-Length"] = str(attr.length)
            return 200, b"", info_headers, True
        off, size, partial = self._parse_range(req, attr.length)
        data = b""
        if size > 0 and attr.length > 0:
            data = await self._read_with_recall(attr.inode, off, size)
        self.metrics.counter("s3_bytes_out").inc(float(len(data)))
        if partial:
            info_headers["Content-Range"] = (
                f"bytes {off}-{off + len(data) - 1}/{attr.length}"
            )
            return 206, data, info_headers, False
        return 200, data, info_headers, False

    async def _op_head_object(self, req: _Request, bucket: str, key: str):
        return await self._op_get_object(req, bucket, key, head_only=True)

    async def _op_delete_object(self, req: _Request, bucket: str, key: str):
        battr = await self._bucket_attr(bucket)
        segs = _key_segments(key)
        try:
            parent = battr.inode
            for seg in segs[:-1]:
                parent = (await self.client.lookup(parent, seg)).inode
            await self.client.unlink(parent, segs[-1])
        except st.StatusError as e:
            # idempotent at ANY depth: a missing intermediate prefix is
            # the same "key does not exist" as a missing leaf
            if e.code not in (st.ENOENT, st.ENOTDIR):
                raise
        return 204, b"", {}, False  # S3 DELETE is idempotent

    # --- multipart upload --------------------------------------------------

    async def _mpu_dir(self, upload_id: str, bucket: str,
                       key: str) -> m.Attr:
        if not upload_id.isalnum():
            raise _HttpError(404, "NoSuchUpload", upload_id)
        staging = await self._mpu_root()
        try:
            attr = await self.client.lookup(staging, f"up-{upload_id}")
            raw = await self.client.get_xattr(
                attr.inode, "lizardfs.s3.upload"
            )
            bound = json.loads(raw.decode())
        except (st.StatusError, ValueError):
            raise _HttpError(404, "NoSuchUpload", upload_id) from None
        # an uploadId is bound to the bucket/key it was created for
        # (S3 semantics): a mismatched part/complete/abort must not
        # touch another key's staging
        if bound.get("bucket") != bucket or bound.get("key") != key:
            raise _HttpError(404, "NoSuchUpload", upload_id)
        return attr

    async def _op_mpu_create(self, req: _Request, bucket: str, key: str):
        await self._bucket_attr(bucket)
        _key_segments(key)
        upload_id = secrets.token_hex(16)
        staging = await self._mpu_root()
        attr = await self.client.mkdir(staging, f"up-{upload_id}")
        await self.client.set_xattr(
            attr.inode, "lizardfs.s3.upload",
            json.dumps({"bucket": bucket, "key": key}).encode(),
        )
        body = (
            f"{xmlutil.XML_DECL}<InitiateMultipartUploadResult"
            f" xmlns=\"{xmlutil.S3_NS}\">"
            f"<Bucket>{xmlutil.esc(bucket)}</Bucket>"
            f"<Key>{xmlutil.esc(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId>"
            f"</InitiateMultipartUploadResult>"
        )
        return 200, body.encode(), {"Content-Type": "application/xml"}, False

    async def _op_mpu_part(self, req: _Request, bucket: str, key: str):
        try:
            part_no = int(req.query.get("partNumber", "0"))
        except ValueError:
            raise _HttpError(400, "InvalidArgument", "partNumber") from None
        if not 1 <= part_no <= 10_000:
            raise _HttpError(400, "InvalidArgument", "partNumber")
        updir = await self._mpu_dir(
            req.query.get("uploadId", ""), bucket, key
        )
        etag = hashlib.md5(req.body).hexdigest()
        name = f"part.{part_no:05d}"
        # stage + rename INTO the upload dir: a retransmitted part
        # replaces its predecessor atomically
        tmp_name = f"part-{secrets.token_hex(12)}"
        tmp = await self._write_staged(tmp_name, req.body)
        await self._set_etag(tmp.inode, etag)
        staging = await self._mpu_root()
        await self.client.rename(staging, tmp_name, updir.inode, name)
        self.metrics.counter("s3_bytes_in").inc(float(len(req.body)))
        return 200, b"", {"ETag": f'"{etag}"'}, False

    async def _op_mpu_complete(self, req: _Request, bucket: str, key: str):
        upload_id = req.query.get("uploadId", "")
        updir = await self._mpu_dir(upload_id, bucket, key)
        wanted = xmlutil.parse_complete_multipart(req.body)
        if not wanted:
            raise _HttpError(400, "MalformedXML",
                             "CompleteMultipartUpload body")
        parts: list[tuple[int, m.Attr, str]] = []
        for num, want_etag in wanted:
            try:
                pattr = await self.client.lookup(
                    updir.inode, f"part.{num:05d}"
                )
            except st.StatusError:
                raise _HttpError(400, "InvalidPart",
                                 f"part {num} missing") from None
            etag = await self._get_etag(pattr.inode) or ""
            if want_etag and want_etag != etag:
                raise _HttpError(400, "InvalidPart",
                                 f"part {num} etag mismatch")
            parts.append((num, pattr, etag))
        # assemble into a staged file: chunk-aligned tails concat via
        # the master's O(1) appendchunks chunk share (the uploaded
        # bytes are never copied again); a non-aligned tail forces a
        # positional re-copy of the NEXT part, counted separately
        dest_name = f"asm-{secrets.token_hex(12)}"
        dest = await self._write_staged(dest_name, b"")
        assembled = 0
        for _num, pattr, _etag in parts:
            if pattr.length == 0:
                continue
            if assembled % MFSCHUNKSIZE == 0:
                await self.client.append_chunks(dest.inode, pattr.inode)
                self.metrics.counter("s3_mpu_parts_shared").inc()
            else:
                data = await self.client.read_file(
                    pattr.inode, 0, pattr.length
                )
                await self.client.pwrite(dest.inode, assembled, data)
                self.metrics.counter("s3_mpu_parts_copied").inc()
                self.metrics.counter("s3_mpu_copied_bytes").inc(
                    float(len(data))
                )
            assembled += pattr.length
        digest = hashlib.md5()
        for _num, _pattr, etag in parts:
            digest.update(bytes.fromhex(etag))
        final_etag = f"{digest.hexdigest()}-{len(parts)}"
        await self._set_etag(dest.inode, final_etag)
        await self._publish(bucket, key, dest_name)
        # uploaded part files shared their chunks into the object;
        # dropping them releases only their references
        await self._mpu_cleanup(upload_id, updir)
        body = (
            f"{xmlutil.XML_DECL}<CompleteMultipartUploadResult"
            f" xmlns=\"{xmlutil.S3_NS}\">"
            f"<Bucket>{xmlutil.esc(bucket)}</Bucket>"
            f"<Key>{xmlutil.esc(key)}</Key>"
            f"<ETag>&quot;{final_etag}&quot;</ETag>"
            f"</CompleteMultipartUploadResult>"
        )
        return 200, body.encode(), {"Content-Type": "application/xml"}, False

    async def _mpu_cleanup(self, upload_id: str, updir: m.Attr) -> None:
        staging = await self._mpu_root()
        for e in await self.client.readdir(updir.inode):
            try:
                await self.client.unlink(updir.inode, e.name)
            except st.StatusError:
                pass
        try:
            await self.client.rmdir(staging, f"up-{upload_id}")
        except st.StatusError:
            pass

    async def _op_mpu_abort(self, req: _Request, bucket: str, key: str):
        upload_id = req.query.get("uploadId", "")
        updir = await self._mpu_dir(upload_id, bucket, key)
        await self._mpu_cleanup(upload_id, updir)
        return 204, b"", {}, False


async def main(argv: list[str] | None = None) -> None:
    """``python -m lizardfs_tpu_torch.s3 HOST:PORT [--port N] [--root /path]``"""
    import argparse

    ap = argparse.ArgumentParser(description="LizardFS-TPU S3 gateway")
    ap.add_argument("master", help="master HOST:PORT")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9444)
    ap.add_argument("--root", default="/",
                    help="cluster directory exported as the bucket root")
    args = ap.parse_args(argv)
    mhost, mport = args.master.rsplit(":", 1)
    gw = S3Gateway(mhost, int(mport), host=args.host, port=args.port,
                   root=args.root)
    await gw.start()
    try:
        # lint: waive(unbounded-await): the gateway process parks here until killed by design
        await asyncio.Event().wait()
    finally:
        await gw.stop()


if __name__ == "__main__":
    asyncio.run(main())
