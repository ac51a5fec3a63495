"""The port's operator tools against the JAX package's, on the CPU.

* Source: ``tools/metadump.py``, ``metarestore.py``, ``admin_cli.py`` and
  ``webui.py`` are copies (the package name changed in imports); the
  last two rank a session's dominant read phase over the top-level
  phases only (``tests/torch_timing_departs.py``); ``tools/cli.py`` differs only by its ``encoder`` keyword
  (``main``, ``_amain`` and ``_connect`` hand it to the ``Client``).
* Tools on clusters: the cases of ``tests/test_tools.py`` and
  ``tests/test_restore_tools.py`` run on a port cluster (its tools, a
  port master, port chunkservers on ``CudaChunkEncoder(device="cpu")``,
  the file CLI on ``get_encoder("cpu")``) beside a JAX cluster with the
  JAX package's tools, on one seed and a pinned clock. The file CLI's
  commands, the admin CLI's and the web UI's JSON give the same output,
  byte for byte, once the addresses (ports differ) are masked and the
  placement of parts on servers is set aside (it differs between the
  packages); ``metarestore`` and ``metadump`` run across the packages,
  the port's on a JAX master's data folder and the reverse.

The JAX client runs its asyncio data path (its native exchange set
aside). Every case is in process on ephemeral localhost ports and
closes both packages' connection pools after its loop.
"""

import asyncio
import contextlib
import io
import json
import re
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from lizardfs_tpu.runtime import faults as ref_faults
from lizardfs_tpu_torch.core.encoder import get_encoder
from lizardfs_tpu_torch.runtime import faults
from lizardfs_tpu_torch.tools import cli
from tests.test_torch_client import (  # noqa: F401 (autouse fixtures)
    Cluster, asyncio_jax_client, payload, pkgs_of, run, two_threads)
from tests.test_torch_master import assert_copy, assert_departs, mod

COPIES = ["tools/__init__.py", "tools/metadump.py", "tools/metarestore.py",
          "tools/admin_cli.py", "tools/webui.py"]
ADDR = re.compile(rb"127\.0\.0\.1:\d+")
CLOCK = 1_700_000_000.5


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    """Both masters stamp the same times, so their outputs compare."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_matches_reference(rel):
    assert_copy(rel)


def test_cli_departs_only_by_its_encoder():
    assert_departs(
        "tools/cli.py",
        ["async def _connect(args) -> Client:", 'c = Client("", 0, master_addrs=addrs)',
         "async def _amain(argv) -> int:", "c = await _connect(args)",
         "def main(argv=None) -> int:",
         "return asyncio.run(_amain(argv if argv is not None else sys.argv[1:]))"],
        ["async def _connect(args, encoder=None) -> Client:",
         "# encoder None: the client's default, the card's encoder",
         'c = Client("", 0, master_addrs=addrs, encoder=encoder)',
         "async def _amain(argv, encoder=None) -> int:", "c = await _connect(args, encoder)",
         "def main(argv=None, encoder=None) -> int:",
         "return asyncio.run(_amain(argv if argv is not None else sys.argv[1:], encoder))"],
    )


def test_cli_without_an_encoder_needs_the_card():
    """Given no encoder the CLI's client takes the card's, and raises
    here: the file tool never lands on the CPU unless asked to."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--master", "127.0.0.1:1", "ls", "/"])


# --- helpers -------------------------------------------------------------------------


async def captured(amain, argv, **kw) -> tuple[int, bytes, str]:
    """A tool's ``_amain`` with its standard output and error captured."""
    out, err = io.BytesIO(), io.StringIO()
    text = io.TextIOWrapper(out, encoding="utf-8", write_through=True)
    with contextlib.redirect_stdout(text), contextlib.redirect_stderr(err):
        rc = await amain(argv, **kw)
    text.flush()
    return rc, out.getvalue(), err.getvalue()


def file_cli(pkg: str, master: str):
    """``lizardfs`` of the package: the port's on the CPU codec."""
    async def go(*argv):
        if pkg == "port":
            return await captured(cli._amain, ["--master", master, *argv],
                                  encoder=get_encoder("cpu"))
        return await captured(mod("jax", "tools.cli")._amain, ["--master", master, *argv])

    return go


def masked(out: bytes) -> bytes:
    """Addresses masked, and ``fileinfo``'s part lines (which server holds
    which part) reduced to the sorted part names."""
    lines = ADDR.sub(b"ADDR", out).split(b"\n")
    parts = sorted(line.split(b" on ")[0] for line in lines if line.startswith(b"    part "))
    rest = [line for line in lines if not line.startswith(b"    part ")]
    return b"\n".join(rest + parts)


def untraced(doc):
    """A JSON document without its trace ids (random in each run)."""
    if isinstance(doc, dict):
        return {k: untraced(v) for k, v in doc.items() if k != "trace_id"}
    if isinstance(doc, list):
        return [untraced(v) for v in doc]
    return doc


# --- the file CLI ---------------------------------------------------------------------


def _cli_session(root, pkg):
    """The commands of tests/test_tools.py's two CLI cases, each one's
    return code and masked output, and the bytes read back."""
    data = payload(0, 200_000)
    (root / pkg).mkdir()
    local, tail, small = root / pkg / "payload.bin", root / pkg / "tail.bin", root / pkg / "p.bin"
    local.write_bytes(data)
    tail.write_bytes(b"tail-bytes" * 100)
    small.write_bytes(b"snapshot me")

    async def go():
        cluster = Cluster(root / pkg / "cluster", n_cs=5, **pkgs_of(pkg))
        await cluster.start(health_interval=30.0)
        run_cli = file_cli(pkg, f"127.0.0.1:{cluster.master.port}")
        log, reads = [], []

        async def step(*argv):
            rc, out, err = await run_cli(*argv)
            log.append((argv[0], rc, masked(out), ADDR.sub(b"ADDR", err.encode())))
            return rc, out

        try:
            await step("mkdir", "/docs")
            await step("put", str(local), "/docs/a.bin", "--goal", "10")
            out = root / pkg / "out.bin"
            await step("get", "/docs/a.bin", str(out))
            reads.append(out.read_bytes())
            for argv in (("ls", "/docs"), ("getgoal", "/docs/a.bin"),
                         ("fileinfo", "/docs/a.bin"), ("checkfile", "/docs/a.bin"),
                         ("settrashtime", "3600", "/docs/a.bin"),
                         ("gettrashtime", "/docs/a.bin"), ("dirinfo", "/"),
                         ("mv", "/docs/a.bin", "/b.bin"), ("stat", "/b.bin"),
                         ("filerepair", "/b.bin"), ("put", str(tail), "/docs/tail.bin"),
                         ("appendchunks", "/b.bin", "/docs/tail.bin"),
                         ("put", str(small), "/orig.bin"), ("snapshot", "/orig.bin", "/snap.bin"),
                         ("cat", "/snap.bin"), ("setxattr", "/orig.bin", "user.k", "v1"),
                         ("getxattr", "/orig.bin", "user.k"), ("listxattr", "/orig.bin"),
                         ("quota-set", "user", "0", "--hard-bytes", "1000000"), ("quota-rep",),
                         ("rm", "/orig.bin")):
                await step(*argv)
            _, listing = await step("trash-list")
            await step("undelete", listing.split()[1].decode())
            await step("cat", "/orig.bin")
            # degraded: a holder of a data part of /b.bin's first chunk
            # stops; checkfile names the chunk, get recovers it
            inode = next(n for n, node in cluster.master.meta.fs.nodes.items()
                         if node.chunks and node.length == 2**26 + 1000)
            await cluster.stop_data_holder(inode, 3)
            await step("checkfile", "/b.bin")
            await step("get", "/b.bin", str(out))
            reads.append(out.read_bytes())
            await step("rremove", "/docs")
            await step("ls", "/")
            await step("stat", "/nope")
            return log, reads
        finally:
            await cluster.stop()

    return run(go())


def test_cli_matches_reference(tmp_path):
    """The file CLI end to end (put, get, ls, goals, fileinfo, checkfile,
    trash time, dirinfo, mv, stat, filerepair, appendchunks, snapshot,
    cat, xattrs, quotas, trash and undelete, a degraded checkfile and
    get, rremove, an error) on a port cluster and a JAX cluster: the same
    return codes, outputs and bytes."""
    port, port_reads = _cli_session(tmp_path, "port")
    ref, ref_reads = _cli_session(tmp_path, "jax")
    assert port == ref
    data = payload(0, 200_000)
    assert port_reads == ref_reads
    assert port_reads[0] == data and port_reads[1][:len(data)] == data
    assert port_reads[1][2**26:] == b"tail-bytes" * 100
    rcs = {cmd: rc for cmd, rc, _, _ in port}
    assert rcs["stat"] == 1 and rcs["undelete"] == 0
    text = b"".join(out for _, _, out, _ in port)
    for want in (b"goal 10", b"ec(3,2)", b"OK", b"3600", b"1 files", b"zeroed 0",
                 b"now 67109864", b"snapshot me", b"v1", b"user.k", b"orig.bin",
                 b"ENDANGERED"):
        assert want in text, want


# --- the admin CLI and the web UI ------------------------------------------------------


ADMIN_SAME = [  # commands whose output is a function of the metadata alone
    ("metadata-checksum",), ("chunks-health",), ("rebuild-status",), ("promote-shadow",),
    ("faults",), ("faults", "arm", "chunkserver:disk_pread flip,limit=1"),
    ("faults", "arm", "not-a-rule"), ("faults", "clear"),
]
ADMIN_RUNS = [("info",), ("list-chunkservers",), ("list-sessions",), ("save-metadata",),
              ("health",), ("qos",), ("top",), ("heat",), ("metrics-prom",)]


def _admin_session(root, pkg):
    admin_cli = mod(pkg, "tools.admin_cli")
    webui = mod(pkg, "tools.webui")

    async def go():
        cluster = Cluster(root / pkg, n_cs=2, **pkgs_of(pkg))
        await cluster.start(health_interval=30.0)
        master = f"127.0.0.1:{cluster.master.port}"
        try:
            c = await cluster.client()
            d = await c.mkdir(1, "dir")
            f = await c.create(d.inode, "x")
            await c.write_file(f.inode, b"data")
            same = [await captured(admin_cli._amain, [master, *argv]) for argv in ADMIN_SAME]
            runs = {argv[0]: await captured(admin_cli._amain, [master, *argv])
                    for argv in ADMIN_RUNS}
            dash = webui.Dashboard(("127.0.0.1", cluster.master.port))
            httpd = ThreadingHTTPServer(("127.0.0.1", 0), webui.make_handler(dash))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()

            def fetch(path):
                url = f"http://127.0.0.1:{httpd.server_port}{path}"
                with urllib.request.urlopen(url, timeout=10) as r:
                    return r.read().decode()

            try:
                pages = {path: await asyncio.to_thread(fetch, path)
                         for path in ("/", "/api/info", "/api/health", "/api/rebuild",
                                      "/api/heat")}
            finally:
                httpd.shutdown()
                httpd.server_close()
            return same, runs, pages
        finally:
            faults.clear()
            ref_faults.clear()
            await cluster.stop()

    return run(go())


def test_admin_cli_and_webui_match_reference(tmp_path):
    """``lizardfs-admin`` and the web UI on a port master and on a JAX
    master holding the same metadata: the checksum, the chunk health,
    the rebuild status, the refused promotion and the fault-rule session
    print the same; the other commands succeed on both with the same
    fields; the web UI serves the same health, rebuild and heat JSON."""
    port_same, port_runs, port_pages = _admin_session(tmp_path, "port")
    ref_same, ref_runs, ref_pages = _admin_session(tmp_path, "jax")
    assert port_same == ref_same
    rcs = [rc for rc, _, _ in port_same]
    assert rcs == [0, 0, 0, 1, 0, 0, 1, 0]
    assert b"checksum" in port_same[0][1] and b"queued: lost 0" in port_same[2][1]
    assert b"ARMED" in port_same[5][1] and b"inactive" in port_same[7][1]
    for cmd, (rc, out, err) in port_runs.items():
        ref_rc, ref_out, _ = ref_runs[cmd]
        assert rc == ref_rc == 0, (cmd, err)
        if out.startswith(b"{"):
            assert json.loads(out).keys() == json.loads(ref_out).keys(), cmd
    info = json.loads(port_runs["info"][1])
    assert info["personality"] == "master" and len(info["chunkservers"]) == 2
    assert port_runs["list-chunkservers"][1].count(b"up") == 2
    for path in ("/api/health", "/api/rebuild", "/api/heat"):
        assert untraced(json.loads(port_pages[path])) == untraced(json.loads(ref_pages[path])), path
    assert json.loads(port_pages["/api/info"]).keys() == json.loads(ref_pages["/api/info"]).keys()
    for want in ("lizardfs-tpu", "chunkservers", "rebuild engine"):
        assert want in port_pages["/"] and want in ref_pages["/"]


def _metrics_csv(root, pkg):
    admin_cli = mod(pkg, "tools.admin_cli")

    async def go():
        cluster = Cluster(root / pkg, n_cs=1, **pkgs_of(pkg))
        await cluster.start(health_interval=30.0)
        try:
            c = await cluster.client()
            f = await c.create(1, "x")
            await c.write_file(f.inode, b"data")
            await asyncio.sleep(1.2)  # the 1 s metrics sampler ticks
            return await captured(admin_cli._amain,
                                  [f"127.0.0.1:{cluster.master.port}", "metrics-csv"])
        finally:
            await cluster.stop()

    return run(go())


def test_admin_metrics_csv_matches_reference(tmp_path):
    """The master's metrics history as CSV: the same series, numbers in
    the cells."""
    rc, csv, _ = _metrics_csv(tmp_path, "port")
    ref_rc, ref_csv, _ = _metrics_csv(tmp_path, "jax")
    assert rc == ref_rc == 0 and csv.startswith(b"series,")

    def series(text):
        return sorted(line.split(b",")[0] for line in text.splitlines()[1:])

    assert series(csv) == series(ref_csv)
    row = next(line for line in csv.decode().splitlines() if line.startswith("metadata_ops,"))
    cells = [cell for cell in row.split(",")[1:] if cell]
    assert cells and all(cell.replace(".", "", 1).replace("-", "", 1).isdigit()
                         for cell in cells)


# --- metarestore and metadump, across the packages --------------------------------------


def _master_folder(root, pkg):
    """A cluster of the package writes a small tree and stops (its
    teardown dumps a final image); returns its data folder and the live
    checksum and version."""
    async def go():
        cluster = Cluster(root / pkg, n_cs=3, **pkgs_of(pkg))
        await cluster.start(health_interval=30.0)
        try:
            c = await cluster.client()
            d = await c.mkdir(1, "docs")
            f = await c.create(d.inode, "f.bin")
            await c.write_file(f.inode, b"q" * 50_000)
            await c.symlink(1, "s", "/docs/f.bin")
            return cluster.master.meta.checksum(), cluster.master.changelog.version
        finally:
            await cluster.stop()

    checksum, version = run(go())
    return root / pkg / "master", checksum, version


def _restore_and_dump(tool_pkg, folder, out, capsys):
    """``tool_pkg``'s metarestore of ``folder`` into ``out``, the restored
    checksum, and its metadump's text."""
    start, final = mod(tool_pkg, "tools.metarestore").restore(str(folder), str(out),
                                                              verbose=False)
    version, doc = mod(tool_pkg, "master.changelog").load_image(str(out))
    store = mod(tool_pkg, "master.metadata").MetadataStore()
    store.load_sections(doc)
    capsys.readouterr()
    assert mod(tool_pkg, "tools.metadump").dump(str(out)) == 0
    return final, version, store.checksum(), capsys.readouterr().out


@pytest.mark.parametrize("master_pkg", ["port", "jax"])
def test_metarestore_and_dump_across_packages(tmp_path, capsys, master_pkg):
    """Each package's metarestore and metadump on the other's master
    folder (and its own): the restored image has the live version and
    checksum, and both dumps print the same tree."""
    folder, checksum, version = _master_folder(tmp_path, master_pkg)
    port = _restore_and_dump("port", folder, tmp_path / "by-port", capsys)
    ref = _restore_and_dump("jax", folder, tmp_path / "by-jax", capsys)
    assert port == ref
    final, restored_version, restored, text = port
    assert final == restored_version == version and restored == checksum
    assert "docs/" in text and "f.bin" in text and "[chunks]" in text
    assert f"# metadata version {version}" in text
    # the command-line entry points print the same
    for tool_pkg in ("port", "jax"):
        out = tmp_path / f"main-{tool_pkg}"
        assert mod(tool_pkg, "tools.metarestore").main(
            ["-d", str(folder), "-o", str(out)]) == 0
    lines = capsys.readouterr().out.replace(str(tmp_path / "main-port"), "OUT").replace(
        str(tmp_path / "main-jax"), "OUT").splitlines()
    assert lines[: len(lines) // 2] == lines[len(lines) // 2:]
