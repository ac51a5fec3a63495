"""The port's NFSv3 gateway against the JAX package's, on the CPU.

* Source: ``nfs/xdr.py``, ``rpc.py``, ``client.py`` and ``__init__.py``
  are verbatim copies (the package name changed in imports);
  ``nfs/server.py`` differs only in the gateway's ``encoder`` keyword,
  which it hands to its ``Client``. The native C NFSv3 client
  (``nfs/cnfs.py``) is pinned and driven in
  ``tests/test_torch_native_fast_paths.py``.
* Scenario: a port cluster with the port's gateway (its client on
  ``CudaChunkEncoder(device="cpu")``) and a JAX cluster with the JAX
  gateway run the same seeded NFS3 session on one seed: MNT, FSINFO,
  MKDIR, CREATE, UNSTABLE WRITEs and COMMIT, GETATTR, READs, a FILE_SYNC
  overwrite, LOOKUP, READDIR and READDIRPLUS, SETATTR, SYMLINK,
  READLINK, LINK, RENAME, REMOVE and the error replies; then a holder of
  a data part of chunk 0 stops and the file is read again through the
  gateway (recovery). Both give the same replies, read bytes and part
  files by (chunk id, part id), at ec(3,2) on six servers and at the
  shipped ec(8,4) on thirteen.
* Masks: the three times of every fattr3 (wall clock), the write
  verifier (random per gateway) and the READDIR cookie verifiers are not
  compared. File handles are compared: they pack the inode, which both
  masters allocate alike.
* Interop: the JAX package's ``Nfs3Client`` against the port's gateway
  gives the JAX run's replies.

The gateway's idle flush of gathered writes is set beyond the scenario's
length, so COMMIT alone flushes them in both runs (the same writes reach
the chunkservers). Every case is in process on ephemeral ports and
closes both packages' pools after its loop.
"""

import pytest

from tests.test_torch_client import (  # noqa: F401 (autouse fixtures)
    ENCODER, GOALS, Cluster, asyncio_jax_client, payload, pkgs_of, run, two_threads)
from tests.test_torch_master import assert_copy, assert_departs, mod

COPIES = ["nfs/__init__.py", "nfs/xdr.py", "nfs/rpc.py", "nfs/client.py"]
GEOMETRY = {"ec32": (6, 3), "ec84": (13, 8)}  # servers, data parts
PARTS = {"ec32": 5, "ec84": 12}
SIZE = 9 * 65536 + 123
WRITE_COUNT = 2 * 65536
READ_COUNT = 200_000
_REFERENCE: dict = {}


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    assert_copy(rel)


def test_gateway_departs_only_by_its_encoder():
    assert_departs(
        "nfs/server.py",
        ["self.client = Client(master_host, master_port, metrics=self.metrics)"],
        ["encoder=None,", "self.client = Client(master_host, master_port, metrics=self.metrics,",
         "encoder=encoder)"])


def test_gateway_without_an_encoder_needs_the_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod("port", "nfs.server").NfsGateway("127.0.0.1", 1)


def gateway(pkg: str, master_port: int):
    cls = mod(pkg, "nfs.server").NfsGateway
    gw = cls("127.0.0.1", master_port, **({"encoder": ENCODER} if pkg == "port" else {}))
    gw.GATHER_IDLE_S = 3600.0  # COMMIT flushes the gathered writes
    return gw


def untimed(attr: dict) -> dict:
    return {k: v for k, v in attr.items() if k != "times"}


def _session(root, kind: str, goal: str, nfs_client: str):
    n_cs, data_parts = GEOMETRY[goal]
    data = payload(SIZE, SIZE)
    gw_pkg = pkgs_of(kind)["client"]
    nfs = mod(gw_pkg, "nfs.server")
    packer = mod(nfs_client, "nfs.xdr").Packer

    async def go():
        cluster = Cluster(root / f"{kind}-{goal}-{nfs_client}", n_cs=n_cs, **pkgs_of(kind))
        await cluster.start(health_interval=30.0)
        gw = None
        out = []
        try:
            admin = await cluster.client()
            await admin.setgoal(1, GOALS[goal])
            gw = gateway(gw_pkg, cluster.master.port)
            await gw.start()
            async with mod(nfs_client, "nfs.client").Nfs3Client("127.0.0.1", gw.port) as c:
                root_fh = await c.mnt("/")
                out.append(("mnt", root_fh))
                out.append(("fsinfo", await c.fsinfo(root_fh)))
                docs = await c.mkdir(root_fh, "docs")
                out.append(("mkdir", docs))
                # a new file takes its directory's goal; MKDIR's is 1
                code, fh = await c.create(root_fh, "data.bin")
                out.append(("create", code, fh))
                for off in range(0, SIZE, WRITE_COUNT):
                    piece = data[off:off + WRITE_COUNT]
                    out.append(("write", off, await c.write(fh, off, piece, stable=0)))
                await c.commit(fh)  # its verifier is random per gateway
                out.append(("getattr", untimed(await c.getattr(fh))))
                back = b""
                for off in range(0, SIZE + 1, READ_COUNT):
                    piece, eof = await c.read(fh, off, READ_COUNT)
                    back += piece
                    out.append(("read", off, len(piece), eof))
                out.append(("read back", back == data))
                out.append(("write stable", await c.write(fh, 100, b"HELLO", stable=2)))
                out.append(("read", await c.read(fh, 98, 9)))
                code, fh2, attr = await c.lookup(root_fh, "data.bin")
                out.append(("lookup", code, fh2, untimed(attr)))
                out.append(("lookup ..", (await c.lookup(docs, ".."))[:2]))
                out.append(("readdir", await c.readdir(docs), await c.readdir(root_fh, plus=True)))
                out.append(("setattr", await c.setattr(fh, mode=0o600)))
                out.append(("getattr", untimed(await c.getattr(fh))))
                u = await c.call(10, packer().opaque(docs).string("ln").boolean(False)
                                 .boolean(False).boolean(False).boolean(False).u32(0).u32(0)
                                 .string("/data.bin").bytes())
                code = u.u32()
                u.boolean()
                link_fh = u.opaque(64)
                out.append(("symlink", code, link_fh))
                u = await c.call(5, packer().opaque(link_fh).bytes())
                code = u.u32()
                c.skip_post_op(u)
                out.append(("readlink", code, u.string(4096)))
                u = await c.call(15, packer().opaque(fh).opaque(docs).string("hard").bytes())
                out.append(("link", u.u32()))
                out.append(("nlink", (await c.getattr(fh))["nlink"]))
                code, other = await c.create(root_fh, "other.txt")
                await c.write(other, 0, b"other", stable=2)
                u = await c.call(14, packer().opaque(root_fh).string("other.txt")
                                 .opaque(docs).string("moved.txt").bytes())
                out.append(("rename", u.u32()))
                u = await c.call(12, packer().opaque(docs).string("moved.txt").bytes())
                out.append(("remove", u.u32()))
                out.append(("removed", (await c.lookup(docs, "moved.txt"))[0]))
                for proc, args in ((1, packer().opaque(b"XXXXXXXX")),
                                   (1, packer().opaque(nfs.fh_pack(999999))),
                                   (11, packer().opaque(root_fh).string("dev").u32(3))):
                    out.append(("error", proc, (await c.call(proc, args.bytes())).u32()))
                out.append(("guarded create", (await c.create(root_fh, "data.bin", how=1))[0]))
                want = data[:100] + b"HELLO" + data[105:]
                inode = nfs.fh_unpack(fh)
                parts = cluster.live_parts()
                # degraded: a data part of chunk 0 gone, read through recovery
                out.append(("chunk 0 parts", await cluster.stop_data_holder(inode, data_parts)))
                gw.client.cache.invalidate(inode)
                back = b""
                for off in range(0, SIZE, READ_COUNT):
                    back += (await c.read(fh, off, READ_COUNT))[0]
                return out, back, want, parts
        finally:
            if gw is not None:
                await gw.stop()
            await cluster.stop()

    return run(go())


def reference(root, goal: str):
    if goal not in _REFERENCE:
        _REFERENCE[goal] = _session(root, "jax", goal, "jax")
    return _REFERENCE[goal]


@pytest.mark.parametrize("goal", sorted(GEOMETRY))
def test_gateway_session_matches_reference(tmp_path, goal):
    out, back, want, parts = _session(tmp_path, "port", goal, "port")
    ref_out, ref_back, ref_want, ref_parts = reference(tmp_path, goal)
    assert out == ref_out
    assert ("read back", True) in out and ("chunk 0 parts", PARTS[goal]) in out
    assert back == ref_back == want == ref_want
    assert parts == ref_parts and len({cid for cid, _ in parts}) >= 1


def test_jax_client_on_the_port_gateway(tmp_path):
    out, back, want, parts = _session(tmp_path, "port", "ec32", "jax")
    ref_out, ref_back, _, ref_parts = reference(tmp_path, "ec32")
    assert out == ref_out
    assert back == ref_back == want
    assert parts == ref_parts
