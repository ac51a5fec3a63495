"""Append-only changelog + metadata image persistence.

The durability backbone, mirroring the reference's design (reference:
src/master/changelog.h:34-54 append/rotate, filesystem_store.cc
metadata image, restore.cc replay):

  * every metadata mutation appends one line ``<version>: <json-op>`` to
    ``changelog.0.log``; the version counter is the global metadata
    version,
  * a metadata image (``metadata.liz``) snapshots the whole state at
    some version; on startup the image is loaded and newer changelog
    lines are replayed on top (crash recovery, filesystem_store.h:38),
  * ``rotate()`` shifts changelog.N.log -> changelog.N+1.log after each
    image dump,
  * shadows/metaloggers receive the same lines over the wire and apply
    or archive them.

The image is a versioned JSON document — structured, explicit, and
diff-friendly; sections mirror the reference's tagged sections (NODE/
EDGE/CHUNKS/...).
"""

from __future__ import annotations

import json
import os

IMAGE_FORMAT = "lizardfs-tpu-metadata-1"
MAX_KEPT_LOGS = 2


class Changelog:
    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.version = 0  # version of the last applied mutation
        self._file = None

    @property
    def path(self) -> str:
        return os.path.join(self.data_dir, "changelog.0.log")

    def open(self) -> None:
        self._file = open(self.path, "a", encoding="utf-8")

    def append(self, op: dict) -> int:
        """Assign the next version to ``op``, persist, return version."""
        self.version += 1
        if self._file is None:
            self.open()
        self._file.write(f"{self.version}: {json.dumps(op, sort_keys=True)}\n")
        self._file.flush()
        return self.version

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def rotate(self) -> None:
        """changelog.N -> changelog.N+1 after an image dump
        (changelog.h:41)."""
        self.close()
        for n in range(MAX_KEPT_LOGS, 0, -1):
            src = os.path.join(self.data_dir, f"changelog.{n - 1}.log")
            dst = os.path.join(self.data_dir, f"changelog.{n}.log")
            if os.path.exists(src):
                os.replace(src, dst)

    @staticmethod
    def parse_line(line: str) -> tuple[int, dict] | None:
        line = line.strip()
        if not line:
            return None
        version_s, _, payload = line.partition(": ")
        try:
            return int(version_s), json.loads(payload)
        except (ValueError, json.JSONDecodeError):
            raise ValueError(f"corrupt changelog line: {line[:120]!r}") from None

    def iter_entries(self, after_version: int):
        """Yield (version, op) with version > after_version from all kept
        logs in order (oldest first)."""
        files = []
        for n in range(MAX_KEPT_LOGS, -1, -1):
            p = os.path.join(self.data_dir, f"changelog.{n}.log")
            if os.path.exists(p):
                files.append(p)
        for p in files:
            with open(p, encoding="utf-8") as f:
                for line in f:
                    parsed = self.parse_line(line)
                    if parsed is None:
                        continue
                    version, op = parsed
                    if version > after_version:
                        yield version, op


def save_image(data_dir: str, version: int, sections: dict) -> str:
    """Atomically write the metadata image (fork-less MetadataDumper
    analog — the tree is small enough to serialize inline; background
    dumping can move to a thread when trees grow)."""
    path = os.path.join(data_dir, "metadata.liz")
    tmp = path + ".tmp"
    doc = {"format": IMAGE_FORMAT, "version": version, **sections}
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_image(data_dir: str) -> tuple[int, dict] | None:
    path = os.path.join(data_dir, "metadata.liz")
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("format") != IMAGE_FORMAT:
        raise ValueError(f"unknown metadata image format {doc.get('format')!r}")
    return doc["version"], doc
