"""`lizardfs-metadump` — dump a metadata image as readable text.

The mfsmetadump analog (reference: src/metadump/mfsmetadump.cc).

    python -m lizardfs_tpu_torch.tools.metadump /path/to/data-dir
"""

from __future__ import annotations

import argparse
import sys

from lizardfs_tpu_torch.core import geometry
from lizardfs_tpu_torch.master.changelog import load_image
from lizardfs_tpu_torch.master.metadata import MetadataStore

TYPE_NAMES = {1: "file", 2: "dir", 3: "symlink"}


def dump(data_dir: str, out=None) -> int:
    out = out if out is not None else sys.stdout  # bind at call time
    loaded = load_image(data_dir)
    if loaded is None:
        print(f"no metadata image in {data_dir}", file=sys.stderr)
        return 1
    version, doc = loaded
    store = MetadataStore()
    store.load_sections(doc)
    fs = store.fs
    print(f"# metadata version {version}", file=out)
    print(f"# checksum {store.checksum()}", file=out)
    print(f"# {len(fs.nodes)} inodes, {len(store.registry.chunks)} chunks,"
          f" {len(fs.trash)} trashed", file=out)
    print("\n[nodes]", file=out)

    def walk(inode: int, path: str):
        n = fs.nodes[inode]
        kind = TYPE_NAMES.get(n.ftype, "?")
        extra = ""
        if n.ftype == 1:
            extra = f" length={n.length} goal={n.goal} chunks={[hex(c) for c in n.chunks]}"
        elif n.ftype == 3:
            extra = f" -> {n.symlink_target}"
        print(
            f"{n.inode:>8d} {kind:<7s} mode={n.mode:o} uid={n.uid} gid={n.gid}"
            f"{extra}  {path}", file=out,
        )
        if n.ftype == 2:
            for name, child in sorted(n.children.items()):
                walk(child, f"{path}{name}" + ("/" if fs.nodes[child].ftype == 2 else ""))

    walk(1, "/")
    print("\n[chunks]", file=out)
    for c in sorted(store.registry.chunks.values(), key=lambda c: c.chunk_id):
        t = geometry.SliceType(c.slice_type)
        print(
            f"{c.chunk_id:016X} v{c.version} {t.to_string()} copies={c.copies}"
            f" refs={c.refcount} goal={c.goal_id}", file=out,
        )
    print("\n[trash]", file=out)
    for inode, (name, expires, parent) in sorted(fs.trash.items()):
        print(f"{inode:>8d} expires={expires} parent={parent} {name}", file=out)
    if store.quotas.entries:
        print("\n[quotas]", file=out)
        for (kind, oid), e in sorted(store.quotas.entries.items()):
            print(f"{kind}:{oid} {e.to_dict()}", file=out)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lizardfs-metadump", description=__doc__)
    p.add_argument("data_dir")
    args = p.parse_args(argv)
    return dump(args.data_dir)


if __name__ == "__main__":
    sys.exit(main())
