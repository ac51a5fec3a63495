"""On-disk chunk store — the hddspacemgr analog.

The port's copy of the JAX package's ``chunkserver/chunk_store.py``: the
same on-disk format, byte for byte, so a part either package writes
scans, reads and tests in the other (tests pin it). Its CRCs run on the
host (``ops/crc32.py``), as the reference's do; only the encoder seam
runs on the card.

Disk layout mirrors the reference's header-file format (reference:
src/chunkserver/chunk.h:154-176 MooseFSChunk): each chunk part is one
file named ``chunk_<id:016X>_P<part:08X>_<version:08X>.liz`` inside 256
hash subfolders (``<low byte of id:02X>/``), containing:

  [1 KiB signature block][4 KiB CRC table][block data...]

  signature: magic "LIZTPU10" + chunk_id:u64 + version:u32 + part_id:u32
  CRC table: 1024 big-endian u32 slots (one per possible block)

Every 64 KiB block carries CRC32; reads verify, writes update. The store
is synchronous — the serving layer wraps calls in worker threads (the
bgjobs pool analog, src/chunkserver/bgjobs.h).
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import struct
import threading
import time

from lizardfs_tpu_torch.constants import MFSBLOCKSIZE, MFSBLOCKSINCHUNK, MFSHDRSIZE
from lizardfs_tpu_torch.core import geometry
from lizardfs_tpu_torch.ops import crc32 as crc_mod
from lizardfs_tpu_torch.proto import status as st
from lizardfs_tpu_torch.runtime import faults as _faults

MAGIC = b"LIZTPU10"
SIGNATURE_SIZE = 1024
CRC_TABLE_SIZE = 4 * MFSBLOCKSINCHUNK  # 4 KiB
HEADER_SIZE = SIGNATURE_SIZE + CRC_TABLE_SIZE
assert HEADER_SIZE == MFSHDRSIZE
_SIG = struct.Struct(">8sQII")

# CRC of an empty (all-zero) block, used for sparse/unwritten slots.
EMPTY_BLOCK_CRC = crc_mod.crc32(b"\0" * MFSBLOCKSIZE)


@contextlib.contextmanager
def _flocked(f, exclusive: bool):
    """File lock shared with the native data plane: the C++ serving
    threads hold their own open file descriptions, so flock (not the
    in-process ChunkFile.lock) is what keeps block+CRC updates atomic
    across the two planes."""
    fcntl.flock(f.fileno(), fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH)
    try:
        yield
    finally:
        # drain Python's userspace buffer while the lock is still held —
        # otherwise the trailing CRC-slot write lands after LOCK_UN and
        # a reader in the window sees new data with a stale CRC
        if exclusive:
            f.flush()
        fcntl.flock(f.fileno(), fcntl.LOCK_UN)


class ChunkStoreError(Exception):
    def __init__(self, code: int, msg: str = ""):
        self.code = code
        super().__init__(f"{st.name(code)}{(': ' + msg) if msg else ''}")


def _disk_fault(site: str, chunk_id: int, part_id: int):
    """Fault choke point for the block-IO layer (runtime/faults.py).
    Runs in worker threads, so delays are plain sleeps. Returns a
    Decision for the payload actions (flip/short) the caller applies;
    delay/error/drop resolve here. A disk op's role is always
    "chunkserver" — only chunkservers own stores."""
    dec = _faults.decide(
        site, op=f"{chunk_id:016X}:{part_id}", role="chunkserver"
    )
    if dec is None:
        return None
    if dec.action == "delay":
        time.sleep(dec.ms / 1e3)
        return None
    if dec.action in ("error", "drop"):
        raise ChunkStoreError(
            dec.code or st.EIO,
            f"fault injected: {dec.action} {site} "
            f"chunk {chunk_id:016X}:{part_id}",
        )
    return dec  # flip / short: payload actions, site-specific


def chunk_filename(chunk_id: int, part_id: int, version: int) -> str:
    """The part id is IN the name: a server may legitimately hold
    several parts of one chunk (more parts than servers, rebalancing),
    and omitting it made them collide on one path (data loss)."""
    return f"chunk_{chunk_id:016X}_P{part_id:08X}_{version:08X}.liz"


def parse_chunk_filename(name: str):
    """-> (chunk_id, part_id, version) or None. part_id is None for a
    legacy (pre-part-in-name) file — the scan migrates those using the
    part id stored in the signature."""
    if not (name.startswith("chunk_") and name.endswith(".liz")):
        return None
    parts = name[6:-4].split("_")
    try:
        if (len(parts) == 3 and len(parts[0]) == 16
                and parts[1][:1] == "P" and len(parts[1]) == 9
                and len(parts[2]) == 8):
            return int(parts[0], 16), int(parts[1][1:], 16), int(parts[2], 16)
        if len(parts) == 2 and len(parts[0]) == 16 and len(parts[1]) == 8:
            return int(parts[0], 16), None, int(parts[1], 16)
    except ValueError:
        pass
    return None


class ChunkFile:
    """One chunk part on disk."""

    __slots__ = ("chunk_id", "version", "part_id", "path", "lock")

    def __init__(self, chunk_id: int, version: int, part_id: int, path: str):
        self.chunk_id = chunk_id
        self.version = version
        self.part_id = part_id
        self.path = path
        self.lock = threading.Lock()

    @property
    def part_type(self) -> geometry.ChunkPartType:
        return geometry.ChunkPartType.from_id(self.part_id)

    def max_blocks(self) -> int:
        return geometry.number_of_blocks_in_part(self.part_type)

    def data_length(self) -> int:
        try:
            return max(0, os.path.getsize(self.path) - HEADER_SIZE)
        except OSError:
            return 0


class ChunkStore:
    """All chunk parts under one data folder (one mfshdd.cfg line)."""

    def __init__(self, folder: str):
        self.folder = folder
        self._chunks: dict[tuple[int, int], ChunkFile] = {}
        self._lock = threading.Lock()
        os.makedirs(folder, exist_ok=True)

    # --- scan (hddspacemgr.cc:986-1060 folder scan) ------------------------

    def scan(self) -> list[ChunkFile]:
        """Discover chunk files; newest version wins, stale versions are
        removed (the reference keeps one version per chunk part)."""
        found: dict[tuple[int, int], ChunkFile] = {}
        for sub in range(256):
            subdir = os.path.join(self.folder, f"{sub:02X}")
            if not os.path.isdir(subdir):
                continue
            for name in os.listdir(subdir):
                parsed = parse_chunk_filename(name)
                if parsed is None:
                    continue
                chunk_id, name_part, version = parsed
                path = os.path.join(subdir, name)
                try:
                    with open(path, "rb") as f:
                        sig = f.read(_SIG.size)
                    magic, sid, sver, part_id = _SIG.unpack(sig)
                    if magic != MAGIC or sid != chunk_id or sver != version:
                        continue  # damaged signature: skip (reported later)
                    if name_part is None:
                        # legacy name without the part id: migrate; if
                        # the rename fails (read-only folder), keep
                        # serving under the old path rather than
                        # dropping a healthy part
                        new_path = os.path.join(
                            subdir, chunk_filename(chunk_id, part_id, version)
                        )
                        try:
                            os.rename(path, new_path)
                            path = new_path
                        except OSError:
                            pass
                    elif name_part != part_id:
                        continue  # name/signature disagree: damaged
                except (OSError, struct.error):
                    continue
                cf = ChunkFile(chunk_id, version, part_id, path)
                key = (chunk_id, part_id)
                prev = found.get(key)
                if prev is None or prev.version < version:
                    if prev is not None:
                        try:
                            os.unlink(prev.path)
                        except OSError:
                            pass
                    found[key] = cf
        with self._lock:
            self._chunks = found
        return list(found.values())

    # --- lookup -------------------------------------------------------------

    def get(self, chunk_id: int, part_id: int) -> ChunkFile | None:
        with self._lock:
            return self._chunks.get((chunk_id, part_id))

    def require(self, chunk_id: int, version: int, part_id: int) -> ChunkFile:
        cf = self.get(chunk_id, part_id)
        if cf is None:
            raise ChunkStoreError(st.NO_CHUNK, f"chunk {chunk_id:016X}:{part_id}")
        if cf.version != version:
            raise ChunkStoreError(
                st.WRONG_VERSION,
                f"chunk {chunk_id:016X} has v{cf.version}, want v{version}",
            )
        return cf

    def all_parts(self) -> list[ChunkFile]:
        with self._lock:
            return list(self._chunks.values())

    def _path_for(self, chunk_id: int, part_id: int, version: int) -> str:
        subdir = os.path.join(self.folder, f"{chunk_id & 0xFF:02X}")
        os.makedirs(subdir, exist_ok=True)
        return os.path.join(subdir, chunk_filename(chunk_id, part_id, version))

    # --- chunk ops (hddspacemgr.h:153-161) -----------------------------------

    def create(self, chunk_id: int, version: int, part_id: int) -> ChunkFile:
        key = (chunk_id, part_id)
        with self._lock:
            if key in self._chunks:
                raise ChunkStoreError(st.EEXIST, f"chunk {chunk_id:016X}:{part_id}")
        path = self._path_for(chunk_id, part_id, version)
        with open(path, "wb") as f:
            f.write(_SIG.pack(MAGIC, chunk_id, version, part_id))
            f.write(b"\0" * (SIGNATURE_SIZE - _SIG.size))
            f.write(b"\0" * CRC_TABLE_SIZE)
        cf = ChunkFile(chunk_id, version, part_id, path)
        with self._lock:
            self._chunks[key] = cf
        return cf

    def delete(self, chunk_id: int, version: int, part_id: int) -> None:
        cf = self.require(chunk_id, version, part_id)
        with self._lock:
            self._chunks.pop((chunk_id, part_id), None)
        try:
            os.unlink(cf.path)
        except OSError:
            pass

    def duplicate(
        self, src_chunk_id: int, src_version: int, part_id: int,
        new_chunk_id: int, new_version: int,
    ) -> ChunkFile:
        """Local copy of a part under a new chunk id (COW duplicate,
        hdd duplicate op analog)."""
        src = self.require(src_chunk_id, src_version, part_id)
        key = (new_chunk_id, part_id)
        with self._lock:
            if key in self._chunks:
                raise ChunkStoreError(st.EEXIST, f"chunk {new_chunk_id:016X}")
        new_path = self._path_for(new_chunk_id, part_id, new_version)
        with src.lock, open(src.path, "rb") as fin, open(new_path, "wb") as fout:
            fin.seek(SIGNATURE_SIZE)
            fout.write(_SIG.pack(MAGIC, new_chunk_id, new_version, part_id))
            fout.write(b"\0" * (SIGNATURE_SIZE - _SIG.size))
            while True:
                buf = fin.read(1 << 20)
                if not buf:
                    break
                fout.write(buf)
        cf = ChunkFile(new_chunk_id, new_version, part_id, new_path)
        with self._lock:
            self._chunks[key] = cf
        return cf

    def set_version(self, chunk_id: int, old_version: int, new_version: int,
                    part_id: int) -> ChunkFile:
        cf = self.require(chunk_id, old_version, part_id)
        with cf.lock:
            new_path = self._path_for(chunk_id, part_id, new_version)
            with open(cf.path, "r+b") as f:
                f.write(_SIG.pack(MAGIC, chunk_id, new_version, part_id))
            os.rename(cf.path, new_path)
            cf.path = new_path
            cf.version = new_version
        return cf

    # --- block io (hddspacemgr.h:64-69 read/write with CRC) -----------------

    def _read_crc_slot(self, f, block: int) -> int:
        f.seek(SIGNATURE_SIZE + 4 * block)
        return struct.unpack(">I", f.read(4))[0]

    def _write_crc_slot(self, f, block: int, crc: int) -> None:
        f.seek(SIGNATURE_SIZE + 4 * block)
        f.write(struct.pack(">I", crc))

    def read(
        self, chunk_id: int, version: int, part_id: int, offset: int, size: int
    ) -> list[tuple[int, bytes, int]]:
        """Read [offset, offset+size) of a part.

        Returns a list of (part_offset, data, crc) pieces, one per
        touched block: full blocks carry their stored CRC (verified);
        partial pieces carry the CRC of the piece itself. Reads past the
        stored data return zero bytes (sparse semantics match the
        write-anywhere block store).
        """
        cf = self.require(chunk_id, version, part_id)
        max_bytes = cf.max_blocks() * MFSBLOCKSIZE
        if offset < 0 or size < 0 or offset + size > max_bytes:
            raise ChunkStoreError(st.EINVAL, f"read range {offset}+{size}")
        fault = (
            _disk_fault("disk_pread", chunk_id, part_id)
            if _faults.ACTIVE else None
        )
        pieces = []
        with cf.lock, open(cf.path, "rb") as f, _flocked(f, exclusive=False):
            data_len = cf.data_length()
            pos = offset
            end = offset + size
            while pos < end:
                block = pos // MFSBLOCKSIZE
                block_start = block * MFSBLOCKSIZE
                piece_end = min(end, block_start + MFSBLOCKSIZE)
                piece_len = piece_end - pos
                # load the whole block to verify its CRC
                f.seek(HEADER_SIZE + block_start)
                raw = f.read(MFSBLOCKSIZE)
                raw = raw + b"\0" * (MFSBLOCKSIZE - len(raw))
                stored = self._read_crc_slot(f, block)
                if block_start < data_len or stored != 0:
                    # slot 0 inside the data region = sparse hole => empty
                    # block CRC expected (recompute_crc_if_block_empty
                    # analog, crc.cc:235-243)
                    expected = stored if stored != 0 else EMPTY_BLOCK_CRC
                    if crc_mod.crc32(raw) != expected:
                        raise ChunkStoreError(
                            st.CRC_ERROR,
                            f"chunk {chunk_id:016X}:{part_id} block {block}",
                        )
                piece = raw[pos - block_start : pos - block_start + piece_len]
                if piece_len == MFSBLOCKSIZE:
                    crc = stored if stored != 0 else EMPTY_BLOCK_CRC
                else:
                    crc = crc_mod.crc32(piece)
                pieces.append((pos, piece, crc))
                pos = piece_end
        if fault is not None and pieces:
            if fault.action == "flip":
                # corrupt one bit of one piece AFTER the store's own CRC
                # verification, keeping the advertised CRC: the receiver
                # (client / replicator) must catch it — the degraded-
                # read CRC-reject drill
                idx = fault.rule.rand_index(len(pieces))
                pos0, piece, crc = pieces[idx]
                pieces[idx] = (
                    pos0, _faults.flip_bit(piece, fault.rule), crc
                )
            elif fault.action == "short":
                pieces.pop()  # short read: the final piece goes missing
        return pieces

    def write(
        self,
        chunk_id: int,
        version: int,
        part_id: int,
        block: int,
        offset_in_block: int,
        data: bytes,
        data_crc: int,
    ) -> None:
        """Write a piece into one block; verifies the piece CRC from the
        wire, patches the block, updates the stored block CRC."""
        cf = self.require(chunk_id, version, part_id)
        if block >= cf.max_blocks():
            raise ChunkStoreError(st.INDEX_TOO_BIG, f"block {block}")
        if offset_in_block + len(data) > MFSBLOCKSIZE:
            raise ChunkStoreError(st.EINVAL, "write crosses block boundary")
        if crc_mod.crc32(data) != data_crc:
            raise ChunkStoreError(st.CRC_ERROR, "piece crc mismatch on write")
        fault = (
            _disk_fault("disk_pwrite", chunk_id, part_id)
            if _faults.ACTIVE else None
        )
        with cf.lock, open(cf.path, "r+b") as f, _flocked(f, exclusive=True):
            block_start = block * MFSBLOCKSIZE
            if len(data) == MFSBLOCKSIZE:
                new_block = bytes(data)
                new_crc = data_crc
            else:
                f.seek(HEADER_SIZE + block_start)
                raw = bytearray(f.read(MFSBLOCKSIZE))
                raw.extend(b"\0" * (MFSBLOCKSIZE - len(raw)))
                raw[offset_in_block : offset_in_block + len(data)] = data
                new_block = bytes(raw)
                new_crc = crc_mod.crc32(new_block)
            if fault is not None and fault.action == "flip":
                # latent corruption: the block lands with a bit flipped
                # AFTER its CRC was computed, so the stored slot no
                # longer matches — a later read (or the scrubber)
                # raises CRC_ERROR
                new_block = _faults.flip_bit(new_block, fault.rule)
            f.seek(HEADER_SIZE + block_start)
            f.write(new_block)
            if fault is not None and fault.action == "short":
                return  # torn write: data landed, CRC slot never updated
            self._write_crc_slot(f, block, new_crc)

    def truncate_part(
        self, chunk_id: int, version: int, part_id: int, part_length: int
    ) -> None:
        """Truncate a part's data region to part_length bytes; the
        trailing partial block is zero-padded and its CRC refreshed."""
        cf = self.require(chunk_id, version, part_id)
        with cf.lock, open(cf.path, "r+b") as f, _flocked(f, exclusive=True):
            nblocks = (part_length + MFSBLOCKSIZE - 1) // MFSBLOCKSIZE
            f.truncate(HEADER_SIZE + part_length)
            if part_length % MFSBLOCKSIZE:
                last = nblocks - 1
                f.seek(HEADER_SIZE + last * MFSBLOCKSIZE)
                raw = f.read(MFSBLOCKSIZE)
                raw = raw + b"\0" * (MFSBLOCKSIZE - len(raw))
                self._write_crc_slot(f, last, crc_mod.crc32(raw))
            # clear CRC slots beyond the end
            for b in range(nblocks, MFSBLOCKSINCHUNK):
                self._write_crc_slot(f, b, 0)

    def prefetch(self, chunk_id: int, version: int, part_id: int,
                 offset: int, size: int) -> None:
        """Advise the kernel to cache a part range (hdd prefetch /
        posix_fadvise WILLNEED analog). Best-effort; never raises."""
        try:
            cf = self.require(chunk_id, version, part_id)
            with open(cf.path, "rb") as f:
                os.posix_fadvise(
                    f.fileno(), HEADER_SIZE + offset, size,
                    os.POSIX_FADV_WILLNEED,
                )
        except (ChunkStoreError, OSError, AttributeError):
            pass

    # --- chunk tester (hdd_test_chunk analog) --------------------------------

    def test_part(self, cf: ChunkFile) -> bool:
        """Verify all stored CRCs of one part; False = damaged."""
        try:
            with cf.lock, open(cf.path, "rb") as f, \
                    _flocked(f, exclusive=False):
                data_len = cf.data_length()
                nblocks = (data_len + MFSBLOCKSIZE - 1) // MFSBLOCKSIZE
                for b in range(nblocks):
                    f.seek(HEADER_SIZE + b * MFSBLOCKSIZE)
                    raw = f.read(MFSBLOCKSIZE)
                    raw = raw + b"\0" * (MFSBLOCKSIZE - len(raw))
                    stored = self._read_crc_slot(f, b)
                    if stored == 0:
                        continue  # sparse/unwritten slot
                    if crc_mod.crc32(raw) != stored:
                        return False
            return True
        except OSError:
            return False

    def space(self) -> tuple[int, int]:
        """(total_bytes, used_bytes) of the folder's filesystem."""
        s = os.statvfs(self.folder)
        total = s.f_blocks * s.f_frsize
        free = s.f_bavail * s.f_frsize
        return total, total - free


class MultiStore:
    """Several data folders behind the single-store API (mfshdd.cfg
    analog: one chunkserver, many disks — reference parses a folder
    list and scans each, hddspacemgr.cc).

    New parts land on the folder with the most free space; lookups fan
    out. A folder that fails to scan is marked damaged and its parts are
    reported so the master re-replicates elsewhere.
    """

    def __init__(self, folders: list[str]):
        if not folders:
            raise ValueError("at least one data folder required")
        self.stores = [ChunkStore(f) for f in folders]
        self.damaged_folders: list[str] = []

    # --- scan ---------------------------------------------------------------

    def scan(self) -> list[ChunkFile]:
        out: list[ChunkFile] = []
        for store in list(self.stores):
            try:
                out.extend(store.scan())
            except OSError:
                self.damaged_folders.append(store.folder)
                self.stores.remove(store)
        return out

    # --- lookup -------------------------------------------------------------

    def _store_of(self, chunk_id: int, part_id: int) -> ChunkStore | None:
        for store in self.stores:
            if store.get(chunk_id, part_id) is not None:
                return store
        return None

    def get(self, chunk_id: int, part_id: int) -> ChunkFile | None:
        store = self._store_of(chunk_id, part_id)
        return store.get(chunk_id, part_id) if store else None

    def require(self, chunk_id: int, version: int, part_id: int) -> ChunkFile:
        store = self._store_of(chunk_id, part_id)
        if store is None:
            raise ChunkStoreError(st.NO_CHUNK, f"chunk {chunk_id:016X}:{part_id}")
        return store.require(chunk_id, version, part_id)

    def all_parts(self) -> list[ChunkFile]:
        out: list[ChunkFile] = []
        for store in self.stores:
            out.extend(store.all_parts())
        return out

    # --- placement ----------------------------------------------------------

    def _emptiest(self) -> ChunkStore:
        def free(s: ChunkStore) -> int:
            total, used = s.space()
            return total - used

        return max(self.stores, key=free)

    def create(self, chunk_id: int, version: int, part_id: int) -> ChunkFile:
        if self._store_of(chunk_id, part_id) is not None:
            raise ChunkStoreError(st.EEXIST, f"chunk {chunk_id:016X}:{part_id}")
        return self._emptiest().create(chunk_id, version, part_id)

    def duplicate(self, src_chunk_id, src_version, part_id, new_chunk_id,
                  new_version) -> ChunkFile:
        store = self._store_of(src_chunk_id, part_id)
        if store is None:
            raise ChunkStoreError(st.NO_CHUNK, f"chunk {src_chunk_id:016X}")
        return store.duplicate(
            src_chunk_id, src_version, part_id, new_chunk_id, new_version
        )

    # --- delegated ops ------------------------------------------------------

    def _delegate(self, name, chunk_id, part_id, *args):
        store = self._store_of(chunk_id, part_id)
        if store is None:
            raise ChunkStoreError(st.NO_CHUNK, f"chunk {chunk_id:016X}:{part_id}")
        return getattr(store, name)(*args)

    def delete(self, chunk_id, version, part_id):
        return self._delegate("delete", chunk_id, part_id, chunk_id, version, part_id)

    def set_version(self, chunk_id, old_version, new_version, part_id):
        return self._delegate(
            "set_version", chunk_id, part_id, chunk_id, old_version,
            new_version, part_id,
        )

    def read(self, chunk_id, version, part_id, offset, size):
        return self._delegate(
            "read", chunk_id, part_id, chunk_id, version, part_id, offset, size
        )

    def write(self, chunk_id, version, part_id, block, offset_in_block, data,
              data_crc):
        return self._delegate(
            "write", chunk_id, part_id, chunk_id, version, part_id, block,
            offset_in_block, data, data_crc,
        )

    def truncate_part(self, chunk_id, version, part_id, part_length):
        return self._delegate(
            "truncate_part", chunk_id, part_id, chunk_id, version, part_id,
            part_length,
        )

    def prefetch(self, chunk_id, version, part_id, offset, size) -> None:
        store = self._store_of(chunk_id, part_id)
        if store is not None:
            store.prefetch(chunk_id, version, part_id, offset, size)

    def test_part(self, cf: ChunkFile) -> bool:
        for store in self.stores:
            if store.get(cf.chunk_id, cf.part_id) is cf:
                return store.test_part(cf)
        return ChunkStore.test_part(self.stores[0], cf)

    def space(self) -> tuple[int, int]:
        total = used = 0
        for store in self.stores:
            t, u = store.space()
            total += t
            used += u
        return total, used
