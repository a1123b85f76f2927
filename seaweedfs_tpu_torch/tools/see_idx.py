"""see_idx: print every entry of a `.idx` / `.ecx` index file.

The port's copy of seaweedfs_tpu/tools/see_idx.py (unmaintained/see_idx/
see_idx.go upstream).  Entries are 16 bytes (4-byte offsets) or 17 bytes
(5-byte offsets, volumes past 32 GB).  The width is read from the sibling
`.dat`'s superblock when there is one; ``-offset5`` forces 17-byte entries
for an index without its `.dat`.

    python -m seaweedfs_tpu_torch.tools.see_idx /path/to/1.idx [-offset5]
"""

from __future__ import annotations

import argparse
import os
import sys

from ..storage import idx as idx_mod
from ..storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
from ..storage.types import TOMBSTONE_FILE_SIZE


def sniff_offset_size(idx_path: str) -> int:
    """4 or 5, from the sibling `.dat`'s superblock; 4 without one."""
    dat = os.path.splitext(idx_path)[0] + ".dat"
    try:
        with open(dat, "rb") as f:
            return SuperBlock.from_bytes(
                f.read(SUPER_BLOCK_SIZE + 0xFFFF)).offset_size
    except (OSError, ValueError):
        return 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("idx", help="path to a .idx or .ecx file")
    ap.add_argument("-offset5", action="store_true",
                    help="force 5-byte offsets (17-byte entries); by "
                         "default the sibling .dat's superblock says")
    args = ap.parse_args(argv)
    offset_size = 5 if args.offset5 else sniff_offset_size(args.idx)
    n = 0
    for key, offset, size in idx_mod.iter_index_file(args.idx, offset_size):
        mark = " TOMBSTONE" if size == TOMBSTONE_FILE_SIZE else ""
        print(f"key {key:>12} offset {offset:>12} size {size:>10}{mark}")
        n += 1
    print(f"{n} entries ({offset_size}-byte offsets)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
