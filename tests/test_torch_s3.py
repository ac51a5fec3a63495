"""The port's S3 gateway against the JAX package's, on the CPU.

* Source: ``s3/xmlutil.py``, ``client.py``, ``__init__.py`` and
  ``__main__.py`` are verbatim copies (the package name changed in
  imports); ``s3/server.py`` differs only in the gateway's ``encoder``
  keyword, which it hands to its ``Client``, and its spans' clock
  (``tests/torch_timing_departs.py``). The port's constants carry
  the gateway's ``LZ_S3`` switch and ETag xattr (pinned in
  ``tests/test_torch_ops.py``).
* Scenario: a port cluster with the port's gateway (its client on
  ``CudaChunkEncoder(device="cpu")``) and a JAX cluster with the JAX
  gateway serve the same seeded S3 session: buckets, a PUT of a nested
  key, GET, HEAD, a ranged GET, ListObjectsV2, a multipart upload of
  three parts (the first shared into the object by the master's
  chunk-aligned ``appendchunks``, the others copied into the shared
  chunk, which copies it on write), the multipart object's GET, the
  error replies; then a holder of a data part of chunk 0 of each object
  stops and both objects are read again through the gateway (recovery).
  Staged objects take the goal of the gateway's staging directory,
  which the scenario makes first and sets to the goal under test. Both
  runs give the same statuses, headers, XML bodies and ETags, the same
  object bytes and the same part files by (chunk id, part id), at
  ec(3,2) on six servers and at the shipped ec(8,4) on thirteen.
* Masks: the ``x-amz-request-id`` header (random per reply), the
  ``Last-Modified`` header and the ``<LastModified>`` and
  ``<CreationDate>`` elements (wall clock) and the multipart ``UploadId``
  (random per upload).
* Interop: the JAX package's ``S3Client`` against the port's gateway
  gives the JAX run's replies.
* The ``LZ_S3`` switch off refuses the port's gateway, as the JAX
  package's refuses its own.

Every case is in process on ephemeral ports and closes both packages'
pools after its loop.
"""

import re

import pytest

from tests.test_torch_client import (  # noqa: F401 (autouse fixtures)
    ENCODER, GOALS, Cluster, asyncio_jax_client, payload, pkgs_of, run, two_threads)
from tests.test_torch_master import assert_copy, assert_departs, mod

COPIES = ["s3/__init__.py", "s3/__main__.py", "s3/xmlutil.py", "s3/client.py"]
GEOMETRY = {"ec32": (6, 3, 5), "ec84": (13, 8, 12)}  # servers, data parts, parts
SIZE = 9 * 65536 + 123
MPU_PARTS = (200_000, 150_000, 77_777)
ANY_STATUS = tuple(range(100, 600))
_REFERENCE: dict = {}


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    assert_copy(rel)


def test_gateway_departs_only_by_its_encoder():
    assert_departs(
        "s3/server.py",
        ["self.client = Client(master_host, master_port, metrics=self.metrics)"],
        ["encoder=None,", "self.client = Client(master_host, master_port, metrics=self.metrics,",
         "encoder=encoder)"])


def test_gateway_without_an_encoder_needs_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod("port", "s3.server").S3Gateway("127.0.0.1", 1)


@pytest.mark.parametrize("off", ["0", "off"])
def test_kill_switch_off_refuses_the_gateway(monkeypatch, off):
    """``LZ_S3`` off refuses both packages' gateways before they dial."""
    monkeypatch.setenv("LZ_S3", off)

    async def go():
        for pkg in ("jax", "port"):
            gw = gateway(pkg, 1)
            with pytest.raises(RuntimeError, match="LZ_S3"):
                await gw.start()
            assert gw.port == 0

    run(go())


def gateway(pkg: str, master_port: int):
    cls = mod(pkg, "s3.server").S3Gateway
    return cls("127.0.0.1", master_port, **({"encoder": ENCODER} if pkg == "port" else {}))


def masked(resp) -> tuple:
    """A reply's status, headers and body, without its request id and
    times, and with any upload id masked."""
    headers = {k: v for k, v in resp.headers.items()
               if k not in ("x-amz-request-id", "last-modified")}
    body = re.sub(rb"<(LastModified|CreationDate)>[^<]*</\1>", rb"<\1/>", resp.body)
    body = re.sub(rb"<UploadId>[0-9a-f]+</UploadId>", b"<UploadId/>", body)
    return resp.status, headers, body


async def staging_dir(admin, goal: int) -> None:
    """The gateway's staging directory, made first at ``goal``: every
    object is written there and renamed into its bucket."""
    staging = await admin.mkdir(1, ".s3mpu")
    await admin.setgoal(staging.inode, goal)


def _session(root, kind: str, goal: str, s3_client: str):
    n_cs, data_parts, _ = GEOMETRY[goal]
    blob = payload(SIZE, SIZE)
    pieces = [payload(i, n) for i, n in enumerate(MPU_PARTS)]
    gw_pkg = pkgs_of(kind)["client"]

    async def go():
        cluster = Cluster(root / f"{kind}-{goal}-{s3_client}", n_cs=n_cs, **pkgs_of(kind))
        await cluster.start(health_interval=30.0)
        gw = None
        out = []
        try:
            admin = await cluster.client()
            await staging_dir(admin, GOALS[goal])
            gw = gateway(gw_pkg, cluster.master.port)
            await gw.start()
            async with mod(s3_client, "s3.client").S3Client("127.0.0.1", gw.port) as s3:
                async def call(method, path, query=None, body=b"", headers=None):
                    resp = await s3.request(method, path, query=query, body=body,
                                            ok=ANY_STATUS, headers=headers)
                    query = {k: "<masked>" if k == "uploadId" else v for k, v in (query or {}).items()}
                    out.append((method, path, query, masked(resp)))
                    return resp

                await call("PUT", "/demo")
                await call("GET", "/")
                await call("PUT", "/demo/a/b/hello.bin", body=blob)
                await call("GET", "/demo/a/b/hello.bin")
                await call("HEAD", "/demo/a/b/hello.bin")
                await call("GET", "/demo/a/b/hello.bin", headers={"Range": "bytes=100-199"})
                await call("GET", "/demo", query={"list-type": "2"})
                up = await s3.create_multipart("demo", "big.bin")
                etags = [await s3.upload_part("demo", "big.bin", up, n + 1, piece)
                         for n, piece in enumerate(pieces)]
                out.append(("part etags", etags))
                await call("POST", "/demo/big.bin", query={"uploadId": up},
                           body=("<CompleteMultipartUpload>" + "".join(
                               f"<Part><PartNumber>{n + 1}</PartNumber><ETag>\"{e}\"</ETag></Part>"
                               for n, e in enumerate(etags)) + "</CompleteMultipartUpload>").encode())
                await call("GET", "/demo/big.bin")
                await call("GET", "/demo", query={"list-type": "2", "prefix": "a/"})
                await call("GET", "/demo/missing.bin")
                await call("GET", "/nobucket/x")
                await call("PUT", "/demo")
                await call("DELETE", "/demo")
                out.append(("assembly", [gw.metrics.counter(name).total for name in (
                    "s3_mpu_parts_shared", "s3_mpu_parts_copied", "s3_mpu_copied_bytes")]))
                parts = cluster.live_parts()
                # degraded: a data part of chunk 0 of each object gone
                objects = [(await admin.resolve(f"/demo/{key}")).inode
                           for key in ("a/b/hello.bin", "big.bin")]
                for inode in objects:
                    if inode in cluster.master.meta.fs.nodes:
                        out.append(("chunk 0 parts", await cluster.stop_data_holder(inode, data_parts)))
                for inode in objects:
                    gw.client.cache.invalidate(inode)
                degraded = [(await s3.get_object("demo", key)).body
                            for key in ("a/b/hello.bin", "big.bin")]
                return out, degraded, parts
        finally:
            if gw is not None:
                await gw.stop()
            await cluster.stop()

    return run(go())


def reference(root, goal: str):
    if goal not in _REFERENCE:
        _REFERENCE[goal] = _session(root, "jax", goal, "jax")
    return _REFERENCE[goal]


def check(out, degraded, goal: str) -> None:
    blob = payload(SIZE, SIZE)
    whole = b"".join(payload(i, n) for i, n in enumerate(MPU_PARTS))
    bodies = {(method, path): reply[2] for method, path, _, reply in
              (o for o in out if len(o) == 4) if reply[0] == 200}
    assert bodies[("GET", "/demo/a/b/hello.bin")] == blob
    assert bodies[("GET", "/demo/big.bin")] == whole
    assert degraded == [blob, whole]
    assert out.count(("chunk 0 parts", GEOMETRY[goal][2])) == 2
    assert ("assembly", [1, 2, sum(MPU_PARTS[1:])]) in out


@pytest.mark.parametrize("goal", sorted(GEOMETRY))
def test_gateway_session_matches_reference(tmp_path, goal):
    out, degraded, parts = _session(tmp_path, "port", goal, "port")
    ref_out, ref_degraded, ref_parts = reference(tmp_path, goal)
    check(out, degraded, goal)
    assert out == ref_out
    assert degraded == ref_degraded
    assert parts == ref_parts and parts


def test_jax_client_on_the_port_gateway(tmp_path):
    out, degraded, parts = _session(tmp_path, "port", "ec32", "jax")
    ref_out, ref_degraded, ref_parts = reference(tmp_path, "ec32")
    check(out, degraded, "ec32")
    assert out == ref_out and degraded == ref_degraded
    assert parts == ref_parts
