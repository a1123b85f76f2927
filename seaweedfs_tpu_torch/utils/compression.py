"""Gzip helpers for the upload/read path (weed/util/compression.go, by way
of seaweedfs_tpu/utils/compression.py): a needle stored with
FLAG_IS_COMPRESSED holds gzip bytes, served as they are to a client that
accepts gzip and decompressed for one that does not.  The client's
upload sniffs with IsCompressableFileType's ext/mime table and keeps a
gzip only when it wins 10% (MaybeGzipData)."""

from __future__ import annotations

import gzip
import io
import zlib

_COMPRESS_EXT = {
    ".svg", ".bmp", ".wav", ".pdf", ".txt", ".html", ".htm", ".css",
    ".js", ".json", ".php", ".java", ".go", ".rb", ".c", ".cpp",
    ".h", ".hpp",
}
_NO_COMPRESS_EXT = {
    ".zip", ".rar", ".gz", ".bz2", ".xz", ".zst", ".br",
    ".png", ".jpg", ".jpeg",
}
_WAV_MIMES = {"wave", "wav", "x-wav", "x-pn-wav"}


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


def maybe_gzip_data(data: bytes) -> bytes:
    """Gzip unless already gzipped or the win is under 10% (MaybeGzipData,
    compression.go:16-28); returns ``data`` itself when not gzipped."""
    if is_gzipped_content(data):
        return data
    gzipped = gzip_data(data)
    if len(gzipped) * 10 > len(data) * 9:
        return data
    return gzipped


def maybe_decompress_data(data: bytes) -> bytes:
    """Gunzip gzip-magic bytes; anything that is not really gzip (bad
    header, truncation, corrupt deflate) comes back as it is."""
    if is_gzipped_content(data):
        try:
            return ungzip_data(data)
        except (OSError, EOFError, zlib.error):
            return data
    return data


def is_compressable_file_type(ext: str, mtype: str) -> tuple[bool, bool]:
    """(should_be_compressed, i_am_sure): IsCompressableFileType,
    compression.go:102-155."""
    ext = ext.lower()
    if mtype.startswith("text/"):
        return True, True
    if ext in (".svg", ".bmp", ".wav"):
        return True, True
    if mtype.startswith("image/"):
        return False, True
    if ext in _NO_COMPRESS_EXT:
        return False, True
    if ext in _COMPRESS_EXT:
        return True, True
    if mtype.startswith("application/"):
        if mtype.endswith("zstd") or mtype.endswith("vnd.rar"):
            return False, True
        if mtype.endswith("xml") or mtype.endswith("script"):
            return True, True
    if mtype.startswith("audio/"):
        if mtype[len("audio/"):] in _WAV_MIMES:
            return True, True
    return False, False
