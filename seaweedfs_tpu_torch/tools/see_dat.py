"""see_dat: walk a raw `.dat` volume file and print every needle record.

The port's copy of seaweedfs_tpu/tools/see_dat.py (unmaintained/see_dat/
see_dat.go upstream): what is on disk (offsets, ids, cookies, sizes,
flags, append times) with no server and no `.idx`.  ``walk_dat`` is what
the CLI's ``fix`` rebuilds an index from.

    python -m seaweedfs_tpu_torch.tools.see_dat /path/to/1.dat [-v]
"""

from __future__ import annotations

import argparse
import os
import sys

from ..storage.needle import NEEDLE_HEADER_SIZE, Needle, needle_body_length
from ..storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
from ..storage.types import size_is_valid


def walk_dat(path: str):
    """(0, superblock), then (offset, needle) for every record; raises on
    a malformed superblock and stops at a torn tail.  Reads one record at
    a time, so a 30 GB volume walks in a record's memory."""
    total = os.path.getsize(path)
    with open(path, "rb") as f:
        sb = SuperBlock.from_bytes(f.read(SUPER_BLOCK_SIZE + 0xFFFF))
        yield 0, sb
        offset = sb.block_size
        f.seek(offset)
        while offset + NEEDLE_HEADER_SIZE <= total:
            n = Needle()
            n.parse_header(f.read(NEEDLE_HEADER_SIZE))
            size = n.size if size_is_valid(n.size) else 0
            body_len = needle_body_length(size, sb.version)
            body = f.read(body_len)
            if len(body) < body_len:
                print(f"torn tail at offset {offset}", file=sys.stderr)
                return
            n.read_body_bytes(body, sb.version)
            yield offset, n
            offset += NEEDLE_HEADER_SIZE + body_len


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dat", help="path to a .dat volume file")
    ap.add_argument("-v", action="store_true", help="also print names/mimes")
    args = ap.parse_args(argv)
    count = 0
    for offset, rec in walk_dat(args.dat):
        if isinstance(rec, SuperBlock):
            print(f"superblock: version={int(rec.version)} "
                  f"replica={rec.replica_placement} ttl={rec.ttl} "
                  f"compact_revision={rec.compaction_revision}")
            continue
        n = rec
        line = (f"offset {offset:>12} id {n.id:>8} cookie {n.cookie:08x} "
                f"size {n.size:>8} flags {n.flags:02x} "
                f"append_ns {n.append_at_ns}")
        if args.v and (n.name or n.mime):
            line += f" name={n.name!r} mime={n.mime!r}"
        print(line)
        count += 1
    print(f"{count} needle records")
    return 0


if __name__ == "__main__":
    sys.exit(main())
