"""The port's tape server against the JAX package's, on the CPU.

* Source: ``tapeserver/__init__.py`` and ``__main__.py`` are verbatim
  copies (the package name changed in imports); ``tapeserver/server.py``
  differs only in the ``encoder`` keyword, which the server keeps and
  hands to the ``Client`` it builds when it connects.
* Demote and recall: on a port cluster with a port tape server (both on
  ``CudaChunkEncoder(device="cpu")``) and on a JAX cluster with a JAX
  tape server, a file written at the goal under test is demoted to tape
  (the master's forced archive, then its chunks freed), recalled (the
  tape server writes the archived bytes back through its client, so the
  parity comes from the encoder again), read back, and read once more
  with a holder of a data part of chunk 0 stopped. Both runs give the
  same archive (file names, bytes and sidecars), the same tape info,
  the same restored and degraded bytes and the same part files by
  (chunk id, part id), at ec(3,2) on six servers and at the shipped
  ec(8,4) on thirteen.
* S3 recall: a GET of a demoted object through the port's S3 gateway
  recalls it through the port's tape server, as the JAX package's
  gateway and tape server do.
* Masks: the file's mtime (wall clock), in the archive's names and
  sidecars and in the tape info, and the tape copy's time stamp there.
* Interop: the port's tape server registered on a JAX master archives
  and recalls as the JAX package's does.

Every case is in process on ephemeral ports, polls with a bound of a few
seconds and closes both packages' pools after its loop.
"""

import asyncio
import json
import time

import pytest

from tests.test_torch_client import (  # noqa: F401 (autouse fixtures)
    ENCODER, GOALS, Cluster, asyncio_jax_client, payload, pkgs_of, run, two_threads)
from tests.test_torch_master import assert_copy, assert_departs, mod
from tests.test_torch_s3 import gateway as s3_gateway
from tests.test_torch_s3 import staging_dir

COPIES = ["tapeserver/__init__.py", "tapeserver/__main__.py"]
GEOMETRY = {"ec32": (6, 3, 5), "ec84": (13, 8, 12)}  # servers, data parts, parts
SIZE = 9 * 65536 + 123
_REFERENCE: dict = {}


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    assert_copy(rel)


def test_server_departs_only_by_its_encoder():
    assert_departs(
        "tapeserver/server.py",
        ["self.client = Client(*self.master_addr)"],
        ["encoder=None,", "self.encoder = encoder",
         "self.client = Client(*self.master_addr, encoder=self.encoder)"])


def test_server_without_an_encoder_needs_the_card(tmp_path):
    """The tape server builds its client when it connects: with no
    encoder that needs the card, before any dial."""

    async def go():
        ts = mod("port", "tapeserver.server").TapeServer(str(tmp_path / "tape"), ("127.0.0.1", 1))
        try:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                await ts.start()
            assert ts.client is None and ts.master is None
        finally:
            await ts.stop()

    run(go())


def tape_server(pkg: str, root, master_port: int):
    cls = mod(pkg, "tapeserver.server").TapeServer
    return cls(str(root), ("127.0.0.1", master_port), label="vault",
               **({"encoder": ENCODER} if pkg == "port" else {}))


async def demote(client, inode: int, timeout: float = 10.0) -> None:
    """Demote through the master's forced archive: CHUNK_BUSY until the
    tape copy lands."""
    st = mod("port" if type(client).__module__.startswith("lizardfs_tpu_torch") else "jax",
             "proto.status")
    deadline = time.monotonic() + timeout
    while True:
        try:
            await client.tape_demote(inode)
            return
        except st.StatusError as e:
            assert e.code == st.CHUNK_BUSY and time.monotonic() < deadline, e
            await asyncio.sleep(0.05)


def archive(folder, mtime: int) -> dict:
    """The tape server's archive: name -> bytes (a sidecar parsed), with
    the file's mtime masked."""
    out = {}
    for path in sorted(folder.iterdir()):
        name = path.name.replace(f"_{mtime}_", "_<mtime>_")
        data = path.read_bytes()
        if path.suffix == ".json":
            data = {k: "<mtime>" if k == "mtime" else v for k, v in json.loads(data).items()}
        out[name] = data
    return out


def untimed(info: dict) -> dict:
    info = dict(info)
    info["copies"] = [{k: v for k, v in c.items() if k not in ("mtime", "ts")}
                      for c in info["copies"]]
    return info


def _demote_recall(root, kind: str, goal: str, tape_pkg: str):
    n_cs, data_parts, _ = GEOMETRY[goal]
    data = payload(SIZE, SIZE)
    folder = root / f"{kind}-{goal}-{tape_pkg}"

    async def go():
        cluster = Cluster(folder, n_cs=n_cs, **pkgs_of(kind))
        await cluster.start(health_interval=30.0)
        ts = None
        try:
            ts = tape_server(tape_pkg, folder / "tape", cluster.master.port)
            await ts.start()
            c = await cluster.client()
            f = await c.create(1, "cold.bin")
            await c.setgoal(f.inode, GOALS[goal])
            await c.write_file(f.inode, data)
            before = cluster.live_parts()
            mtime = (await c.getattr(f.inode)).mtime
            await demote(c, f.inode)
            node = cluster.master.meta.fs.nodes[f.inode]
            demoted = (f.inode in cluster.master.meta.demoted, list(node.chunks), node.length)
            info = untimed(await c.tape_info(f.inode))
            kept = archive(folder / "tape", mtime)
            await c.tape_recall(f.inode)
            restored = await c.read_file(f.inode)
            after = cluster.live_parts()
            n_parts = await cluster.stop_data_holder(f.inode, data_parts)
            c.cache.invalidate(f.inode)
            degraded = await c.read_file(f.inode)
            return demoted, info, kept, restored, degraded, before, after, n_parts
        finally:
            if ts is not None:
                await ts.stop()
            await cluster.stop()

    return run(go())


def reference(root, goal: str):
    if goal not in _REFERENCE:
        _REFERENCE[goal] = _demote_recall(root, "jax", goal, "jax")
    return _REFERENCE[goal]


def check(got, ref, goal: str) -> None:
    data = payload(SIZE, SIZE)
    demoted, info, kept, restored, degraded, before, after, n_parts = got
    assert demoted == (True, [], SIZE)
    assert info["copies"] and info["copies"][0]["label"] == "vault"
    assert [v for k, v in kept.items() if k.endswith(f"_<mtime>_{SIZE}.tape")] == [data]
    assert restored == degraded == data
    assert n_parts == GEOMETRY[goal][2] and after
    assert got == ref


@pytest.mark.parametrize("goal", sorted(GEOMETRY))
def test_demote_and_recall_match_reference(tmp_path, goal):
    check(_demote_recall(tmp_path, "port", goal, "port"), reference(tmp_path, goal), goal)


def test_port_tape_server_on_a_jax_master(tmp_path):
    check(_demote_recall(tmp_path, "jax", "ec32", "port"), reference(tmp_path, "ec32"), "ec32")


def _s3_recall(root, kind: str):
    blob = payload(5, SIZE)
    folder = root / f"s3-{kind}"
    pkg = pkgs_of(kind)["client"]

    async def go():
        cluster = Cluster(folder, n_cs=6, **pkgs_of(kind))
        await cluster.start(health_interval=30.0)
        ts = gw = None
        try:
            admin = await cluster.client()
            await staging_dir(admin, GOALS["ec32"])
            ts = tape_server(pkg, folder / "tape", cluster.master.port)
            await ts.start()
            gw = s3_gateway(pkg, cluster.master.port)
            await gw.start()
            async with mod(pkg, "s3.client").S3Client("127.0.0.1", gw.port) as s3:
                await s3.create_bucket("cold")
                put = await s3.put_object("cold", "archive/me.bin", blob)
                inode = (await admin.resolve("/cold/archive/me.bin")).inode
                await demote(admin, inode)
                freed = list(cluster.master.meta.fs.nodes[inode].chunks)
                got = await s3.get_object("cold", "archive/me.bin")
                recalls = gw.metrics.counter("s3_recalls").total
                return put.etag, freed, got.status, got.etag, got.body, recalls, cluster.live_parts()
        finally:
            if gw is not None:
                await gw.stop()
            if ts is not None:
                await ts.stop()
            await cluster.stop()

    return run(go())


def test_s3_get_recalls_a_demoted_object_as_the_reference(tmp_path):
    got = _s3_recall(tmp_path, "port")
    ref = _s3_recall(tmp_path, "jax")
    etag, freed, status, get_etag, body, recalls, parts = got
    assert freed == [] and status == 200 and recalls == 1
    assert body == payload(5, SIZE) and get_etag == etag and parts
    assert got == ref
