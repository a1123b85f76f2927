"""Gzip helpers for the upload/read path (weed/util/compression.go, by way
of seaweedfs_tpu/utils/compression.py): a needle stored with
FLAG_IS_COMPRESSED holds gzip bytes, served as they are to a client that
accepts gzip and decompressed for one that does not."""

from __future__ import annotations

import gzip
import io


def is_gzipped_content(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == 31 and data[1] == 139


def gzip_data(data: bytes) -> bytes:
    buf = io.BytesIO()
    # fixed mtime=0 so identical input -> identical stored bytes
    with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as f:
        f.write(data)
    return buf.getvalue()


def ungzip_data(data: bytes) -> bytes:
    return gzip.decompress(data)
