"""`lizardfs-metarestore` — offline metadata recovery tool.

The metarestore analog (reference: src/metarestore/main.cc + merger.cc):
merge a metadata image with changelog files (the master's own, a
shadow's, or a metalogger's archive) into a fresh image, so a new master
can start from the most recent durable state.

    python -m lizardfs_tpu_torch.tools.metarestore \
        -d /path/to/data-dir [-o /path/to/output-dir] [--dry-run]

Reads ``metadata.liz`` + every ``changelog*.log`` in the data dir,
replays lines newer than the image, and writes the merged image.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from lizardfs_tpu_torch.master.changelog import Changelog, load_image, save_image
from lizardfs_tpu_torch.master.metadata import MetadataStore


def restore(data_dir: str, output_dir: str | None = None,
            dry_run: bool = False, verbose: bool = True) -> tuple[int, int]:
    """Returns (start_version, final_version)."""
    store = MetadataStore()
    start_version = 0
    loaded = load_image(data_dir)
    if loaded is not None:
        start_version, doc = loaded
        store.load_sections(doc)
        if verbose:
            print(f"loaded metadata image at version {start_version}")
    # gather every changelog line from all logs present, sorted by version
    entries: dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(data_dir, "changelog*.log"))):
        count = 0
        with open(path, encoding="utf-8") as f:
            for line in f:
                parsed = Changelog.parse_line(line)
                if parsed is None:
                    continue
                version, op = parsed
                if version > start_version:
                    entries.setdefault(version, op)
                    count += 1
        if verbose:
            print(f"{os.path.basename(path)}: {count} applicable entries")
    version = start_version
    for v in sorted(entries):
        if v != version + 1:
            print(
                f"warning: changelog gap at version {v} (expected {version + 1})"
                " — stopping replay here", file=sys.stderr,
            )
            break
        store.apply(entries[v])
        version = v
    if verbose:
        print(f"replayed {version - start_version} entries -> version {version}")
        print(f"checksum: {store.checksum()}")
    if not dry_run:
        out = output_dir or data_dir
        os.makedirs(out, exist_ok=True)
        path = save_image(out, version, store.to_sections())
        if verbose:
            print(f"wrote {path}")
    return start_version, version


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lizardfs-metarestore", description=__doc__)
    p.add_argument("-d", "--data-dir", required=True)
    p.add_argument("-o", "--output-dir", default=None)
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)
    try:
        restore(args.data_dir, args.output_dir, args.dry_run)
    except Exception as e:  # noqa: BLE001
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
