"""File-level erasure coding, serial row by row: `.dat` -> `.ec00`..`.ec13`
(+ `.ecx`, `.eci`), rebuild of missing shards, and the decode back to a
volume (`.ec00`..`.ec09` + `.ecx`/`.ecj` -> `.dat` + `.idx`).

Semantics ported from weed/storage/erasure_coding/ec_encoder.go through
seaweedfs_tpu/ec/encoder.py.  This is the plain serial path the streaming
pipeline (ec/streaming.py) is held against; both write byte-identical
files.  The IO chunk is a free parameter: output bytes are invariant to it.

Striping (encodeDatFile, ec_encoder.go:194-231):
  while remaining >  data_shards*large: encode one large-block row
  while remaining >  0:                 encode one small-block row
Rows are strict `>` comparisons — a file of exactly N*(10*large) bytes puts
its last 10*large bytes into small-block rows; tails are zero-padded
(encodeDataOneBatch, ec_encoder.go:172-176).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..observability import get_tracer
from ..storage import idx as idx_mod
from ..storage.needle import get_actual_size
from ..storage.needle_map import MemDb
from ..storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
from ..storage.types import NEEDLE_ID_SIZE, size_is_deleted
from ..utils.ioutil import pread_padded
from .codec import ReedSolomon
from .integrity import (
    CorruptSurvivor,
    EciSidecar,
    ShardCorruptError,
    SidecarBuilder,
    note_corruption,
    sidecar_path,
)
from .layout import DATA_SHARDS_COUNT, LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, to_ext

DEFAULT_CHUNK = 4 * 1024 * 1024  # IO chunk; output is invariant to this


def _remove_quietly(paths) -> None:
    for p in paths:
        try:
            os.remove(p)
        except OSError:
            pass


def write_sorted_file_from_idx(base_file_name: str) -> None:
    """`.idx` -> ascending-key `.ecx` (ec_encoder.go:27-54)."""
    db = MemDb.from_idx_file(base_file_name + ".idx")
    db.write_sorted_file(base_file_name + ".ecx")


def _encode_row(dat_file, rs: ReedSolomon, start_offset: int, block_size: int,
                outputs, chunk: int, builder: SidecarBuilder) -> None:
    """Encode one row of data_shards blocks of block_size each
    (encodeData/encodeDataOneBatch, ec_encoder.go:120-192)."""
    scratch = np.empty((rs.parity_shards, min(chunk, block_size)),
                       dtype=np.uint8)
    for chunk_off in range(0, block_size, chunk):
        n = min(chunk, block_size - chunk_off)
        data = np.empty((rs.data_shards, n), dtype=np.uint8)
        for i in range(rs.data_shards):
            data[i] = pread_padded(dat_file, n,
                                   start_offset + i * block_size + chunk_off)
        parity = rs.encode_into(data, scratch[:, :n])
        rows = list(data) + list(parity)
        for i, row in enumerate(rows):
            outputs[i].write(row.tobytes())
            builder.update(i, row)


def write_ec_files(base_file_name: str, rs: ReedSolomon,
                   large_block_size: int = LARGE_BLOCK_SIZE,
                   small_block_size: int = SMALL_BLOCK_SIZE,
                   chunk: int = DEFAULT_CHUNK) -> None:
    """WriteEcFiles (ec_encoder.go:57): stripe `.dat` into `.ec00`..`.ecNN`,
    plus the `.eci` block-crc sidecar built as shard bytes stream out.  A
    failed encode leaves no shard or sidecar behind."""
    dat_path = base_file_name + ".dat"
    remaining = os.path.getsize(dat_path)
    processed = 0
    builder = SidecarBuilder(rs.total_shards)
    out_paths = [base_file_name + to_ext(i) for i in range(rs.total_shards)]
    with get_tracer().span("ec.write_ec_files", path=dat_path,
                           bytes=remaining, k=rs.data_shards,
                           r=rs.parity_shards,
                           backend=rs.engine.name), \
            open(dat_path, "rb") as dat:
        outputs = []
        ok = False
        try:
            for p in out_paths:
                outputs.append(open(p, "wb"))
            while remaining > large_block_size * rs.data_shards:
                _encode_row(dat, rs, processed, large_block_size, outputs,
                            chunk, builder)
                remaining -= large_block_size * rs.data_shards
                processed += large_block_size * rs.data_shards
            while remaining > 0:
                _encode_row(dat, rs, processed, small_block_size, outputs,
                            chunk, builder)
                remaining -= small_block_size * rs.data_shards
                processed += small_block_size * rs.data_shards
            builder.finalize().save(base_file_name)
            ok = True
        finally:
            for f in outputs:
                f.close()
            if not ok:
                _remove_quietly(out_paths + [sidecar_path(base_file_name)])


def rebuild_ec_files(base_file_name: str, rs: ReedSolomon,
                     chunk: int = SMALL_BLOCK_SIZE) -> list[int]:
    """RebuildEcFiles (ec_encoder.go:61, :89-118, :233-287): regenerate every
    missing `.ecNN` from the >= data_shards present ones.  Returns generated
    shard ids.

    Survivors are verified block by block against the `.eci` sidecar as
    they stream in: a crc-mismatching survivor is demoted to an erasure
    and the rebuild restarts without it (which also regenerates it);
    ShardCorruptError when demotions leave fewer than data_shards clean
    shards."""
    sidecar = EciSidecar.load(base_file_name)
    demoted: set[int] = set()
    while True:
        try:
            return _rebuild_ec_attempt(base_file_name, rs, chunk, sidecar,
                                       demoted)
        except CorruptSurvivor as e:
            demoted.add(e.shard_id)
            note_corruption("rebuild", e.shard_id, base_file_name,
                            block=e.block)


def _rebuild_ec_attempt(base_file_name: str, rs: ReedSolomon, chunk: int,
                        sidecar: Optional[EciSidecar],
                        demoted: set[int]) -> list[int]:
    has_data = [os.path.exists(base_file_name + to_ext(i))
                and i not in demoted for i in range(rs.total_shards)]
    if sum(has_data) < rs.data_shards:
        if demoted:
            raise ShardCorruptError(
                f"unrepairable: only {sum(has_data)} clean shards after "
                f"demoting corrupt {sorted(demoted)}", tuple(sorted(demoted)))
        raise ValueError(
            f"unrepairable: only {sum(has_data)} of {rs.total_shards} shards present")
    generated = [i for i in range(rs.total_shards) if not has_data[i]]
    if not generated:
        return []
    if sidecar is not None:
        # chunk reads land on sidecar block boundaries so every block crc
        # is checked against exactly its covered bytes
        bs = sidecar.block_size
        chunk = max(bs, chunk - chunk % bs)

    inputs = {i: open(base_file_name + to_ext(i), "rb")
              for i in range(rs.total_shards) if has_data[i]}
    # validate survivors BEFORE creating outputs: an empty .ecNN left by a
    # failed rebuild would count as "present" next time and mask the gap
    try:
        shard_size = os.fstat(next(iter(inputs.values())).fileno()).st_size
        for f in inputs.values():
            if os.fstat(f.fileno()).st_size != shard_size:
                raise ValueError("ec shard size mismatch")
    except BaseException:
        for f in inputs.values():
            f.close()
        raise
    if sidecar is not None and sidecar.shard_size != shard_size:
        sidecar = None  # stale sidecar: unverifiable, not evidence of rot
    outputs = {i: open(base_file_name + to_ext(i), "wb") for i in generated}
    ok = False
    try:
        with get_tracer().span("ec.rebuild_ec_files", path=base_file_name,
                               missing=len(generated), k=rs.data_shards,
                               r=rs.parity_shards, backend=rs.engine.name,
                               demoted=len(demoted)):
            offset = 0
            while offset < shard_size:
                n = min(chunk, shard_size - offset)
                shards: list[Optional[np.ndarray]] = [None] * rs.total_shards
                for i, f in inputs.items():
                    raw = os.pread(f.fileno(), n, offset)
                    if len(raw) != n:
                        raise IOError(f"short read on shard {i}: "
                                      f"{len(raw)} < {n}")
                    if sidecar is not None:
                        bad = sidecar.verify_range(i, offset, raw)
                        if bad is not None:
                            raise CorruptSurvivor(i, bad)
                    shards[i] = np.frombuffer(raw, dtype=np.uint8)
                rs.reconstruct(shards)
                for i in generated:
                    outputs[i].write(shards[i].tobytes())
                offset += n
        ok = True
    finally:
        for f in inputs.values():
            f.close()
        for f in outputs.values():
            f.close()
        if not ok:  # no partial shards under the final names
            _remove_quietly(base_file_name + to_ext(i) for i in generated)
    return generated


# --- decode back to a normal volume (ec_decoder.go) -------------------------

def write_dat_file(base_file_name: str, dat_file_size: int) -> None:
    """WriteDatFile (ec_decoder.go:154-195): concatenate data-shard blocks
    into `.dat`.  No GF math: data shards hold the original bytes.  Rows
    are `>=` comparisons here against `>` in write_ec_files, as in the
    reference (ec_decoder.go:173 vs ec_encoder.go:214)."""
    k = DATA_SHARDS_COUNT
    inputs = [open(base_file_name + to_ext(i), "rb") for i in range(k)]
    positions = [0] * k
    try:
        with open(base_file_name + ".dat", "wb") as dat:
            remaining = dat_file_size
            while remaining >= k * LARGE_BLOCK_SIZE:
                for i in range(k):
                    buf = os.pread(inputs[i].fileno(), LARGE_BLOCK_SIZE,
                                   positions[i])
                    if len(buf) != LARGE_BLOCK_SIZE:
                        raise IOError(f"short read on shard {i}")
                    dat.write(buf)
                    positions[i] += LARGE_BLOCK_SIZE
                    remaining -= LARGE_BLOCK_SIZE
            while remaining > 0:
                for i in range(k):
                    to_read = min(remaining, SMALL_BLOCK_SIZE)
                    buf = os.pread(inputs[i].fileno(), to_read, positions[i])
                    if len(buf) != to_read:
                        raise IOError(f"short read on shard {i}")
                    dat.write(buf)
                    positions[i] += to_read
                    remaining -= to_read
                    if remaining <= 0:
                        break
    finally:
        for f in inputs:
            f.close()


def iterate_ecj_file(base_file_name: str):
    """The needle ids journalled as deleted in `.ecj`, in order."""
    path = base_file_name + ".ecj"
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        while True:
            buf = f.read(NEEDLE_ID_SIZE)
            if len(buf) != NEEDLE_ID_SIZE:
                return
            yield int.from_bytes(buf, "big")


def write_idx_file_from_ec_index(base_file_name: str) -> None:
    """WriteIdxFileFromEcIndex (ec_decoder.go:18-43): `.idx` = `.ecx`
    copied verbatim + one tombstone entry per `.ecj` key."""
    with open(base_file_name + ".ecx", "rb") as ecx, \
            open(base_file_name + ".idx", "wb") as out:
        out.write(ecx.read())
        for key in iterate_ecj_file(base_file_name):
            out.write(idx_mod.pack_entry(key, 0, -1))


def find_dat_file_size(base_file_name: str) -> int:
    """FindDatFileSize (ec_decoder.go:48-70): the end of the last live
    `.ecx` entry's record."""
    with open(base_file_name + to_ext(0), "rb") as f:
        version = SuperBlock.from_bytes(
            f.read(SUPER_BLOCK_SIZE + 0xFFFF)).version
    with open(base_file_name + ".ecx", "rb") as f:
        entries = idx_mod.parse_entries(f.read())
    dat_size = 0
    for i in range(len(entries)):
        size = int(entries["size"][i])
        if size_is_deleted(size):
            continue
        dat_size = max(dat_size, int(entries["offset"][i]) * 8
                       + get_actual_size(size, version))
    return dat_size
