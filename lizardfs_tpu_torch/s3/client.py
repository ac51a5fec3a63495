"""Minimal asyncio S3/HTTP client for the gateway's consumers in-tree:
tests, the chaos harness, and the cluster bench.

Deliberately tiny — one keep-alive connection, no signing (the gateway
does not verify signatures), bytes in / bytes out. Not a general S3
SDK; it speaks exactly the subset the gateway serves.
"""

from __future__ import annotations

import asyncio
import urllib.parse
import xml.etree.ElementTree as ET

from lizardfs_tpu_torch.runtime import retry as retrymod

IO_TIMEOUT_S = 60.0


class S3Error(Exception):
    def __init__(self, status: int, code: str, body: bytes):
        self.status = status
        self.code = code
        self.body = body
        super().__init__(f"HTTP {status} {code}")


class _Response:
    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, headers: dict, body: bytes):
        self.status = status
        self.headers = headers
        self.body = body

    @property
    def etag(self) -> str:
        return self.headers.get("etag", "").strip('"')


def _error_code(body: bytes) -> str:
    try:
        root = ET.fromstring(body)
        el = root.find("Code")
        return el.text or "" if el is not None else ""
    except ET.ParseError:
        return ""


class S3Client:
    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None

    async def __aenter__(self) -> "S3Client":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        if self._writer is not None:
            await retrymod.close_writer(self._writer, swallow_cancel=True)
            self._reader = self._writer = None

    async def _conn(self):
        if self._writer is None or self._writer.is_closing():
            self._reader, self._writer = await retrymod.bounded_wait(
                asyncio.open_connection(self.host, self.port), 10.0
            )
        return self._reader, self._writer

    async def request(
        self, method: str, path: str, query: dict | None = None,
        body: bytes = b"", ok=(200, 204, 206), headers: dict | None = None,
    ) -> _Response:
        qs = urllib.parse.urlencode(query or {})
        target = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        req = [f"{method} {target} HTTP/1.1",
               f"Host: {self.host}:{self.port}",
               f"Content-Length: {len(body)}"]
        req += [f"{k}: {v}" for k, v in (headers or {}).items()]
        for attempt in (0, 1):
            reader, writer = await self._conn()
            try:
                writer.write(("\r\n".join(req) + "\r\n\r\n").encode() + body)
                await asyncio.wait_for(writer.drain(), IO_TIMEOUT_S)
                resp = await self._read_response(
                    reader, head_only=(method == "HEAD")
                )
                break
            except (ConnectionError, asyncio.IncompleteReadError, OSError):
                # server closed the keep-alive connection; one redial
                await self.close()
                if attempt:
                    raise
        if resp.status not in ok:
            raise S3Error(resp.status, _error_code(resp.body), resp.body)
        return resp

    async def _read_response(self, reader, head_only: bool) -> _Response:
        line = await retrymod.bounded_wait(reader.readline(), IO_TIMEOUT_S)
        if not line:
            raise ConnectionError("gateway closed the connection")
        parts = line.decode("latin-1").split(" ", 2)
        status = int(parts[1])
        headers: dict[str, str] = {}
        while True:
            hl = await retrymod.bounded_wait(reader.readline(), IO_TIMEOUT_S)
            if hl in (b"\r\n", b"\n", b""):
                break
            name, _, value = hl.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        body = b""
        clen = int(headers.get("content-length", "0") or "0")
        if clen and not head_only:
            body = await retrymod.bounded_wait(
                reader.readexactly(clen), IO_TIMEOUT_S
            )
        return _Response(status, headers, body)

    # --- convenience verbs -------------------------------------------------

    async def create_bucket(self, bucket: str) -> None:
        await self.request("PUT", f"/{bucket}")

    async def delete_bucket(self, bucket: str) -> None:
        await self.request("DELETE", f"/{bucket}")

    async def list_buckets(self) -> list[str]:
        r = await self.request("GET", "/")
        root = ET.fromstring(r.body)
        for el in root.iter():
            el.tag = el.tag.rsplit("}", 1)[-1]
        return [el.text for el in root.iter("Name") if el.text]

    async def put_object(self, bucket: str, key: str,
                         data: bytes) -> _Response:
        return await self.request("PUT", f"/{bucket}/{key}", body=data)

    async def get_object(self, bucket: str, key: str,
                         range_: str | None = None) -> _Response:
        hdrs = {"Range": range_} if range_ else None
        return await self.request("GET", f"/{bucket}/{key}", headers=hdrs)

    async def head_object(self, bucket: str, key: str) -> _Response:
        return await self.request("HEAD", f"/{bucket}/{key}")

    async def delete_object(self, bucket: str, key: str) -> None:
        await self.request("DELETE", f"/{bucket}/{key}")

    async def list_objects(
        self, bucket: str, prefix: str = "", delimiter: str = "",
        max_keys: int = 1000, token: str = "",
    ) -> dict:
        q = {"list-type": "2", "max-keys": str(max_keys)}
        if prefix:
            q["prefix"] = prefix
        if delimiter:
            q["delimiter"] = delimiter
        if token:
            q["continuation-token"] = token
        r = await self.request("GET", f"/{bucket}", query=q)
        root = ET.fromstring(r.body)
        for el in root.iter():
            el.tag = el.tag.rsplit("}", 1)[-1]
        return {
            "keys": [
                {
                    "key": c.findtext("Key"),
                    "size": int(c.findtext("Size") or 0),
                    "etag": (c.findtext("ETag") or "").strip('"'),
                }
                for c in root.iter("Contents")
            ],
            "prefixes": [
                p.findtext("Prefix") for p in root.iter("CommonPrefixes")
            ],
            "truncated": (root.findtext("IsTruncated") == "true"),
            "token": root.findtext("NextContinuationToken") or "",
        }

    async def create_multipart(self, bucket: str, key: str) -> str:
        r = await self.request("POST", f"/{bucket}/{key}",
                               query={"uploads": ""})
        root = ET.fromstring(r.body)
        for el in root.iter():
            el.tag = el.tag.rsplit("}", 1)[-1]
        return root.findtext("UploadId") or ""

    async def upload_part(self, bucket: str, key: str, upload_id: str,
                          part_no: int, data: bytes) -> str:
        r = await self.request(
            "PUT", f"/{bucket}/{key}",
            query={"partNumber": str(part_no), "uploadId": upload_id},
            body=data,
        )
        return r.etag

    async def complete_multipart(
        self, bucket: str, key: str, upload_id: str,
        parts: list[tuple[int, str]],
    ) -> _Response:
        rows = "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\"</ETag></Part>"
            for n, e in parts
        )
        body = (f"<CompleteMultipartUpload>{rows}"
                f"</CompleteMultipartUpload>").encode()
        return await self.request(
            "POST", f"/{bucket}/{key}", query={"uploadId": upload_id},
            body=body,
        )

    async def abort_multipart(self, bucket: str, key: str,
                              upload_id: str) -> None:
        await self.request("DELETE", f"/{bucket}/{key}",
                           query={"uploadId": upload_id})

    async def put_lifecycle(self, bucket: str, demote_after_s: float) -> None:
        body = (
            "<LifecycleConfiguration><Rule><Status>Enabled</Status>"
            f"<Transition><Seconds>{demote_after_s:g}</Seconds>"
            "<StorageClass>TAPE</StorageClass></Transition>"
            "</Rule></LifecycleConfiguration>"
        ).encode()
        await self.request("PUT", f"/{bucket}", query={"lifecycle": ""},
                           body=body)

    async def get_lifecycle(self, bucket: str) -> bytes:
        r = await self.request("GET", f"/{bucket}", query={"lifecycle": ""})
        return r.body

    async def metrics(self) -> str:
        r = await self.request("GET", "/metrics")
        return r.body.decode()
