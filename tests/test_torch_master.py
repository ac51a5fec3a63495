"""The port's master modules against the JAX package's, on the CPU.

* Source: the master's modules are verbatim copies, equal to their
  originals with the package name changed in imports, line for line;
  a line may differ only where the original cites one of the JAX
  package's own change requests by number and the copy does not. The
  entry point is the one exception: it refuses an election
  configuration, which the port does not run yet.
* State: the same seeded sequence of operations on the JAX and the port
  objects gives equal results and equal state, value for value: the
  metadata store (its ``FsTree``, ``ChunkRegistry``, ``QuotaDatabase``,
  ``LockManager``, ACLs and xattrs, through the changelog ops), the
  changelog lines and the metadata image, written by either package and
  read by the other, and the lock, quota, ACL, RichACL, placement, heat
  and rebuild-queue objects on their own.

Every case is in process and exact; the master clusters run in
``tests/test_torch_client.py``.
"""

import base64
import importlib
import random
import re
from pathlib import Path

import numpy as np
import pytest

from lizardfs_tpu_torch.master import __main__ as master_main

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": "lizardfs_tpu", "port": "lizardfs_tpu_torch"}
MASTER_COPIES = [
    "master/__init__.py", "master/acl.py", "master/richacl.py", "master/locks.py",
    "master/quotas.py", "master/exports.py", "master/assignment.py", "master/tasks.py",
    "master/changelog.py", "master/heat.py", "master/fs.py", "master/chunks.py",
    "master/rebuild.py", "master/metadata.py", "master/server.py", "utils/io_limits.py",
]
# A citation of one of the JAX package's own change requests, which the
# copies reword away.
CHANGE_REFERENCE = re.compile(r"\bPR[- ]\d+")


def renamed(rel: str) -> str:
    """The JAX package's source of ``rel`` with its own package name
    changed to the port's."""
    text = (ROOT / "lizardfs_tpu" / rel).read_text()
    return re.sub(r"\blizardfs_tpu(?=[. ])", "lizardfs_tpu_torch", text)


def assert_copy(rel: str) -> None:
    """The port's ``rel`` is the renamed original line for line, but for
    lines that drop a change-request citation."""
    ref = renamed(rel).split("\n")
    port = (ROOT / "lizardfs_tpu_torch" / rel).read_text().split("\n")
    assert len(port) == len(ref), rel
    for want, got in zip(ref, port):
        assert got == want or (CHANGE_REFERENCE.search(want)
                               and not CHANGE_REFERENCE.search(got)), (rel, want, got)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PACKAGES[pkg]}.{name}")


def both(fn, *args):
    """``fn(pkg, *args)`` for each package; the two results must be equal."""
    ref, port = fn("jax", *args), fn("port", *args)
    assert port == ref
    return port


@pytest.mark.parametrize("rel", MASTER_COPIES)
def test_copied_module_matches_reference(rel):
    assert_copy(rel)


@pytest.mark.parametrize("key", master_main.HA_KEYS)
def test_entry_point_refuses_an_election(tmp_path, monkeypatch, key):
    cfg = tmp_path / "master.cfg"
    cfg.write_text(f"DATA_PATH = {tmp_path / 'data'}\nLISTEN_PORT = 0\n{key} = a=127.0.0.1:1\n")
    monkeypatch.setattr("sys.argv", ["master", str(cfg)])
    with pytest.raises(SystemExit, match=f"{key}: the port's master runs no quorum election"):
        master_main.main()
    assert not (tmp_path / "data").exists(), "refused before the server was built"


# --- the metadata store, driven by seeded changelog ops ---------------------------


def _ops(seed: int, count: int = 240) -> list[dict]:
    """A seeded stream of changelog ops over a small namespace, chosen
    against a JAX ``MetadataStore`` that tracks the state (some ops fail
    on purpose: a name that exists, a directory that is not empty)."""
    rng = random.Random(seed)
    store = mod("jax", "master.metadata").MetadataStore()
    ops = []
    next_inode, next_chunk, sid = 2, 1, 1
    names = [f"n{i}" for i in range(6)]
    for _ in range(count):
        fs = store.fs
        dirs = [i for i, n in fs.nodes.items() if n.ftype == 2]
        files = [i for i, n in fs.nodes.items() if n.ftype == 1]
        anyn = list(fs.nodes)
        ts = 1_700_000_000 + len(ops)
        kind = rng.choice([
            "mknode", "mknode", "mknode", "unlink", "rmdir", "rename", "link",
            "setattr", "setgoal", "seteattr", "set_length", "chunk", "set_acl",
            "set_rich_acl", "set_xattr", "set_quota", "acquire", "release", "lock",
            "session_new", "purge_trash", "undelete", "goal_boost",
        ])
        if (not files and kind in ("link", "set_length", "chunk", "acquire", "release", "lock")
                or not fs.trash and kind in ("purge_trash", "undelete")):
            kind = "mknode"  # the op needs a file, or a file in the trash
        if kind == "mknode":
            ftype = rng.choice([1, 1, 2, 3])
            op = {"op": "mknode", "parent": rng.choice(dirs), "name": rng.choice(names),
                  "inode": next_inode, "ftype": ftype, "mode": rng.choice([0o644, 0o755, 0o600]),
                  "uid": rng.choice([0, 1000, 1001]), "gid": rng.choice([0, 100]), "ts": ts,
                  "goal": rng.choice([1, 2, 10]), "trash_time": rng.choice([0, 86400])}
            if ftype == 3:
                op["symlink_target"] = "/" + rng.choice(names)
            next_inode += 1
        elif kind in ("unlink", "rmdir"):
            parent = rng.choice(dirs)
            children = list(fs.nodes[parent].children) or ["missing"]
            op = {"op": kind, "parent": parent, "name": rng.choice(children), "ts": ts}
            if kind == "unlink":
                op["to_trash"] = rng.random() < 0.5
        elif kind == "rename":
            src = rng.choice(dirs)
            op = {"op": "rename", "parent_src": src,
                  "name_src": rng.choice(list(fs.nodes[src].children) or ["missing"]),
                  "parent_dst": rng.choice(dirs), "name_dst": rng.choice(names), "ts": ts}
        elif kind == "link":
            op = {"op": "link", "inode": rng.choice(files), "parent": rng.choice(dirs),
                  "name": rng.choice(names), "ts": ts}
        elif kind == "setattr":
            op = {"op": "setattr", "inode": rng.choice(anyn), "set_mask": rng.randrange(64),
                  "mode": rng.choice([0o640, 0o700]), "uid": rng.choice([0, 1000]),
                  "gid": rng.choice([0, 100]), "atime": ts - 5, "mtime": ts - 3, "ts": ts,
                  "trash_time": rng.choice([0, 3600])}
        elif kind == "setgoal":
            op = {"op": "setgoal", "inode": rng.choice(anyn), "goal": rng.randrange(1, 12), "ts": ts}
        elif kind == "seteattr":
            op = {"op": "seteattr", "inode": rng.choice(anyn), "eattr": rng.randrange(16), "ts": ts}
        elif kind == "set_length":
            op = {"op": "set_length", "inode": rng.choice(files),
                  "length": rng.choice([0, 100, 65536 * 3 + 7, 70 * 2**20]), "ts": ts,
                  "drop_chunks": rng.random() < 0.8}
        elif kind == "chunk":
            ops.append({"op": "create_chunk", "slice_type": rng.choice([0, 1, 60]),
                        "chunk_id": next_chunk, "version": 1, "copies": rng.choice([1, 2]),
                        "goal_id": rng.choice([1, 2, 10])})
            store_apply(store, ops[-1])
            op = {"op": "set_chunk", "inode": rng.choice(files),
                  "chunk_index": rng.randrange(3), "chunk_id": next_chunk}
            if rng.random() < 0.3:
                ops.append(op)
                store_apply(store, op)
                op = {"op": "bump_chunk_version", "chunk_id": next_chunk, "version": 2}
            next_chunk += 1
        elif kind == "set_acl":
            op = {"op": "set_acl", "inode": rng.choice(anyn), "ts": ts,
                  "access": {"users": {"1000": rng.randrange(8)}, "groups": {"100": 5},
                             "mask": rng.choice([None, 5, 7])} if rng.random() < 0.8 else None,
                  "default": {"users": {}, "groups": {"7": 4}, "mask": None}}
        elif kind == "set_rich_acl":
            op = {"op": "set_rich_acl", "inode": rng.choice(anyn), "ts": ts,
                  "acl": {"aces": [{"t": rng.randrange(2), "f": rng.randrange(16),
                                    "m": rng.randrange(8), "w": rng.choice(["owner@", "u:1000", "g:5"])}
                                   for _ in range(rng.randrange(1, 4))]}}
        elif kind == "set_xattr":
            value = base64.b64encode(rng.randbytes(rng.randrange(0, 9))).decode()
            op = {"op": "set_xattr", "inode": rng.choice(anyn), "name": rng.choice(["user.a", "user.b"]),
                  "value": value, "ts": ts}
        elif kind == "set_quota":
            op = {"op": "set_quota", "kind": rng.choice(["user", "group", "dir"]),
                  "owner_id": rng.choice([0, 1000, 100]), "remove": rng.random() < 0.2,
                  "soft_inodes": rng.randrange(10), "hard_inodes": rng.randrange(20),
                  "soft_bytes": rng.randrange(1 << 20), "hard_bytes": rng.randrange(1 << 24)}
        elif kind in ("acquire", "release"):
            op = {"op": kind, "inode": rng.choice(files), "sid": rng.randrange(1, 4)}
        elif kind == "lock":
            lk = rng.choice(["lock_posix", "lock_flock", "lock_release_session"])
            op = {"op": lk, "inode": rng.choice(files), "sid": rng.randrange(1, 4),
                  "token": rng.randrange(3), "ltype": rng.randrange(3)}
            if lk == "lock_posix":
                op.update(start=rng.randrange(100), end=rng.choice([0, 150, 300]))
        elif kind == "session_new":
            op = {"op": "session_new", "sid": sid}
            sid += 1
        elif kind in ("purge_trash", "undelete"):
            op = {"op": kind, "inode": rng.choice(list(fs.trash)), "ts": ts}
        else:
            op = {"op": "goal_boost", "chunk_id": rng.randrange(1, next_chunk + 1),
                  "boost": rng.randrange(3)}
        ops.append(op)
        store_apply(store, op)
    return ops


def store_apply(store, op) -> str:
    """Apply one op; returns "ok" or the failure's type and text."""
    try:
        store.apply(op)
        return "ok"
    except Exception as e:  # the op is refused the same way in both packages
        return f"{type(e).__name__}: {e}"


def _replay(pkg: str, ops: list[dict]):
    store = mod(pkg, "master.metadata").MetadataStore()
    outcomes = [store_apply(store, op) for op in ops]
    return store, outcomes


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_metadata_store_replays_like_reference(seed):
    ops = _ops(seed)
    (ref, ref_out), (port, port_out) = _replay("jax", ops), _replay("port", ops)
    assert port_out == ref_out
    assert "ok" in port_out and any(o != "ok" for o in port_out), "both kinds of outcome"
    assert port.to_sections() == ref.to_sections()
    assert port.checksum() == ref.checksum()
    # the incremental digest matches too (refused ops can leave it off the
    # full one in both packages: a live master validates before it logs)
    assert port.full_digest() == ref.full_digest() and port._digest == ref._digest
    assert port.fs.checksum_data() == ref.fs.checksum_data()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_changelog_and_image_cross_packages(tmp_path, writer):
    """Changelog lines and the metadata image written by one package are
    the other's byte for byte, and each package reads the other's."""
    ops = _ops(7, count=120)
    reader = "port" if writer == "jax" else "jax"
    files = {}
    for pkg in ("jax", "port"):
        log = mod(pkg, "master.changelog").Changelog(str(tmp_path / pkg))
        versions = [log.append(op) for op in ops]
        log.close()
        assert versions == list(range(1, len(ops) + 1))
        files[pkg] = Path(log.path).read_bytes()
    assert files["port"] == files["jax"]
    read_log = mod(reader, "master.changelog").Changelog(str(tmp_path / writer))
    entries = list(read_log.iter_entries(0))
    assert [v for v, _ in entries] == list(range(1, len(ops) + 1))
    assert [op for _, op in entries] == ops

    store, _ = _replay(writer, ops)
    for pkg in ("jax", "port"):
        (tmp_path / f"img_{pkg}").mkdir()
    image = mod(writer, "master.changelog").save_image(
        str(tmp_path / f"img_{writer}"), len(ops), store.to_sections())
    other_image = mod(reader, "master.changelog").save_image(
        str(tmp_path / f"img_{reader}"), len(ops), _replay(reader, ops)[0].to_sections())
    assert Path(image).read_bytes() == Path(other_image).read_bytes()
    version, sections = mod(reader, "master.changelog").load_image(str(tmp_path / f"img_{writer}"))
    loaded = mod(reader, "master.metadata").MetadataStore()
    loaded.load_sections(sections)
    assert version == len(ops)
    assert loaded.to_sections() == store.to_sections()
    assert loaded.full_digest() == store.full_digest()


# --- the master's objects on their own ---------------------------------------------


def _locks(pkg, seed):
    locks = mod(pkg, "master.locks")
    mgr = locks.LockManager()
    rng = random.Random(seed)
    out = []
    for _ in range(300):
        inode, sid, token = rng.randrange(1, 4), rng.randrange(1, 4), rng.randrange(2)
        ltype = rng.randrange(3)
        start = rng.randrange(0, 200)
        end = rng.choice([0, start + rng.randrange(1, 100)])
        kind = rng.randrange(5)
        if kind == 0:
            out.append(mgr.posix(inode, sid, token, start, end, ltype))
        elif kind == 1:
            out.append(mgr.flock(inode, sid, token, ltype))
        elif kind == 2:
            r = mgr.test(inode, sid, token, start, end, ltype)
            out.append(None if r is None else (r.start, r.end, r.ltype, r.owner.session_id))
        elif kind == 3:
            r = mgr.test_flock(inode, sid, token, ltype)
            out.append(None if r is None else (r.ltype, r.owner.session_id, r.owner.token))
        else:
            out.append((mgr.release_session(sid), mgr.session_inodes(sid)))
    held = {inode: [(r.start, r.end, r.ltype, r.owner.session_id, r.owner.token) for r in fl.ranges]
            for inode, fl in mgr.posix_files.items()}
    return out, held


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lock_manager_matches_reference(seed):
    out, _ = both(_locks, seed)
    assert True in out and False in out


def _quotas(pkg, seed):
    quotas = mod(pkg, "master.quotas")
    db = quotas.QuotaDatabase()
    rng = random.Random(seed)
    out = []
    for _ in range(300):
        uid, gid = rng.choice([0, 1000, 1001]), rng.choice([0, 100])
        kind = rng.randrange(5)
        if kind == 0:
            db.set_limits(rng.choice([quotas.KIND_USER, quotas.KIND_GROUP, quotas.KIND_DIR]),
                          rng.choice([uid, gid, 5]), rng.randrange(5), rng.randrange(10),
                          rng.randrange(1000), rng.randrange(4000))
        elif kind == 1:
            db.remove(rng.choice([quotas.KIND_USER, quotas.KIND_GROUP]), rng.choice([uid, gid]))
        elif kind == 2:
            db.charge(uid, gid, rng.randrange(-2, 3), rng.randrange(-500, 800))
        elif kind == 3:
            out.append(db.check(uid, gid, rng.randrange(3), rng.randrange(1500)))
        else:
            entry = db.entry(quotas.KIND_DIR, 5)
            out.append(None if entry is None else
                       db.check_dir((rng.randrange(10), rng.randrange(5000)), entry,
                                    rng.randrange(3), rng.randrange(900)))
    return out, db.to_dict(), quotas.QuotaDatabase.from_dict(db.to_dict()).to_dict()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_quota_database_matches_reference(seed):
    out, _, _ = both(_quotas, seed)
    assert True in out and False in out


def _acl_checks(pkg, seed):
    acl = mod(pkg, "master.acl")
    rng = random.Random(seed)
    out = []
    for _ in range(400):
        a = None if rng.random() < 0.2 else acl.Acl(
            named_users={u: rng.randrange(8) for u in rng.sample([1, 2, 3], rng.randrange(3))},
            named_groups={g: rng.randrange(8) for g in rng.sample([10, 11], rng.randrange(3))},
            mask=rng.choice([None, rng.randrange(8)]))
        if a is not None:
            a = acl.Acl.from_dict(a.to_dict())
        out.append(acl.check_access(rng.randrange(0o1000), rng.choice([1, 2]), rng.choice([10, 11]),
                                    a, rng.choice([0, 1, 2, 3, 4]),
                                    rng.sample([10, 11, 12], rng.randrange(3)), rng.randrange(1, 8)))
    return out


def _rich_acl_checks(pkg, seed):
    richacl = mod(pkg, "master.richacl")
    acl = mod(pkg, "master.acl")
    rng = random.Random(seed)
    whos = [richacl.OWNER, richacl.GROUP, richacl.EVERYONE, "u:2", "g:11"]
    out = []
    for _ in range(200):
        rich = richacl.RichAcl.from_dict({"aces": [
            {"t": rng.randrange(2), "f": rng.randrange(16), "m": rng.randrange(8),
             "w": rng.choice(whos)} for _ in range(rng.randrange(1, 6))]})
        mode = rng.choice([None, rng.randrange(0o1000)])
        out.append((
            rich.check_access(1, 10, rng.choice([0, 1, 2, 3]), rng.sample([10, 11, 12], 2),
                              rng.randrange(1, 8), mode=mode),
            rich.compute_max_masks(rng.choice([1, 2])),
            [(r.to_dict() if r else None) for r in (rich.inherited(True), rich.inherited(False))],
        ))
        posix = acl.Acl(named_users={2: rng.randrange(8)}, named_groups={11: rng.randrange(8)},
                        mask=rng.choice([None, 5]))
        out.append(richacl.from_posix(rng.randrange(0o1000), posix).to_dict())
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_acl_checks_match_reference(seed):
    out = both(_acl_checks, seed)
    assert True in out and False in out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_rich_acl_matches_reference(seed):
    both(_rich_acl_checks, seed)


def _placement(pkg, seed):
    """Register servers of three labels, create chunks of each slice
    kind, place their parts through ``choose_servers`` (the seeded
    registry RNG and the assignment solver), then disconnect servers and
    evaluate every chunk's redundancy."""
    chunks = mod(pkg, "master.chunks")
    geometry = mod(pkg, "core.geometry")
    reg = chunks.ChunkRegistry()
    reg._rng = random.Random(seed)
    rng = random.Random(seed + 100)
    servers = [reg.register_server("127.0.0.1", 9500 + i, rng.choice(["_", "ssd", "hdd"]),
                                   1 << 40, rng.randrange(1 << 39)) for i in range(9)]
    types = [int(geometry.SliceType(geometry.STANDARD)), int(geometry.xor_type(3)),
             int(geometry.ec_type(3, 2)), int(geometry.ec_type(8, 4))]
    out = []
    for _ in range(40):
        t = geometry.SliceType(rng.choice(types))
        c = reg.create_chunk(int(t), copies=rng.choice([1, 2]))
        count = c.copies if t.is_standard else t.expected_parts
        labels = [rng.choice(["_", "ssd", "hdd"]) for _ in range(count)]
        chosen = reg.choose_servers(count, labels=labels)
        out.append([s.cs_id for s in chosen])
        for part, s in enumerate(chosen):
            reg.add_part(c.chunk_id, s.cs_id,
                         geometry.ChunkPartType(t, 0 if t.is_standard else part).id, c.version)
    for s in rng.sample(servers, 3):
        out.append(sorted(reg.server_disconnected(s.cs_id)))
    for c in reg.chunks.values():
        state = reg.evaluate(c)
        out.append((c.chunk_id, state.missing_parts, state.redundant, state.crowded,
                    state.is_safe, state.is_readable, state.is_endangered, state.needs_work))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_placement_and_redundancy_match_reference(seed):
    both(_placement, seed)


def _assignment(pkg, seed):
    assignment = mod(pkg, "master.assignment")
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(30):
        n = int(rng.integers(1, 7))
        cost = rng.integers(0, 50, (n, n + int(rng.integers(0, 4)))).tolist()
        out.append(assignment.solve(cost))
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_assignment_solver_matches_reference(seed):
    both(_assignment, seed)


def _heat(pkg, seed):
    heat = mod(pkg, "master.heat")
    tracker = heat.HeatTracker(capacity=8, half_life_s=5.0)
    rng = random.Random(seed)
    now = 1000.0
    for _ in range(400):
        now += rng.random()
        tracker.charge(rng.choice(["chunk", "inode", "server"]), rng.choice(range(20)),
                       ops=1.0, nbytes=rng.randrange(1 << 20))
        if rng.random() < 0.05:
            tracker.tick(now)
    return ([tracker.top(kind, 5) for kind in ("chunk", "inode", "server")],
            tracker.evictions, tracker.boost_decisions({}))


@pytest.mark.parametrize("seed", [1, 2])
def test_heat_tracker_matches_reference(seed):
    both(_heat, seed)


def _rebuild_queue(pkg, seed):
    rebuild = mod(pkg, "master.rebuild")
    engine = rebuild.RebuildEngine()
    rng = random.Random(seed)
    out = []
    for i in range(60):
        rb = rebuild.Rebuild(chunk_id=rng.randrange(1, 20), part=rng.randrange(4),
                             priority=rng.choice(sorted(rebuild.PRIORITY_NAMES)),
                             bytes_est=rng.randrange(1 << 20), queued_at=float(i))
        out.append(engine.submit(rb))
        if rng.random() < 0.3:
            batch = engine.next_batch()
            out.append([(b.chunk_id, b.part, b.priority) for b in batch])
            for b in batch:
                engine.finished(b, ok=rng.random() < 0.8, nbytes=b.bytes_est)
    return out, engine.completed, engine.failed, engine.bytes_rebuilt


@pytest.mark.parametrize("seed", [1, 2])
def test_rebuild_queue_matches_reference(seed):
    both(_rebuild_queue, seed)


EXPORTS = """\
# address  path  options
127.0.0.1  /  rw,alldirs,maproot=0
10.0.0.0/8  /data  ro,password=secret
* /pub ro
"""
TOPOLOGY = "10.0.0.0/16 1\n10.1.0.0/16 2\n192.168.1.5 3\n"


def _exports(pkg):
    exports = mod(pkg, "master.exports")
    ex = exports.Exports.load(EXPORTS)
    topo = exports.Topology.load(TOPOLOGY)
    out = []
    for ip, pw in [("127.0.0.1", ""), ("10.1.2.3", ""), ("10.1.2.3", "secret"),
                   ("8.8.8.8", ""), ("192.168.1.5", "x")]:
        rule = ex.match(ip, pw)
        out.append(None if rule is None else sorted(vars(rule).items()))
    for a, b in [("10.0.0.1", "10.0.9.9"), ("10.0.0.1", "10.1.0.1"), ("192.168.1.5", "8.8.8.8")]:
        out.append((topo.rack_of(a), topo.distance(a, b)))
    return out


def test_exports_and_topology_match_reference():
    both(_exports)


@pytest.mark.parametrize("text", [
    "subsystem blkio\nlimit /a 1000\nlimit /a/b 10\nlimit unclassified 5\n",
    "limit / 4096\n# comment\n\nlimit /x 0\n",
])
def test_io_limits_match_reference(text):
    def run(pkg):
        io_limits = mod(pkg, "utils.io_limits")
        subsystem, limits = io_limits.parse_limits_cfg(text)
        return subsystem, limits, [io_limits.resolve_limit(g, limits)
                                   for g in ("/a/b/c", "/a", "/x/y", "/zzz", "unclassified")]
    both(run)
