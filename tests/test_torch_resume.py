"""The port's checkpoint-resume encode against seaweedfs_tpu's clean encode.

``StreamingEncoder(device="cpu")`` runs the same pipeline as on the card,
drain threads included, through the plain version.  A host fault in the
middle of an encode (a failed fill read, an injected ``ec.dispatch`` or
``ec.drain`` fault) must resume from the last written checkpoint, not
from byte 0, and leave shards and `.eci` byte-identical to the JAX
package's ``write_ec_files`` on its CPU codec (tolerance 0).  A CUDA-type
error is never retried, and an encode that fails for good leaves nothing
behind.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import seaweedfs_tpu_torch.ec.streaming as streaming
from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.ec.codec import CpuEngine
from seaweedfs_tpu.ec.codec import ReedSolomon as RefRS
from seaweedfs_tpu_torch.ec.layout import to_ext
from seaweedfs_tpu_torch.ec.streaming import StreamingEncoder
from seaweedfs_tpu_torch.ops.gf_matmul import KernelError
from seaweedfs_tpu_torch.utils import faultinject as fi

# every plan entry a whole 10_000-byte small block (large rows of 1 MB
# never fit a 2 MB file), six entries to a 65536-byte dispatch: a 2 MB
# volume is 20 entries of each shard in 4 dispatches
LARGE, SMALL, DISPATCH_B = 1_000_000, 10_000, 65536
EXTS = [to_ext(i) for i in range(14)] + [".eci"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_armed_points():
    fi.clear()
    yield
    fi.clear()


def _files(base: str) -> dict[str, bytes]:
    return {ext: open(base + ext, "rb").read() for ext in EXTS
            if os.path.exists(base + ext)}


def _reference(tmp_path, size: int, seed: int, large: int = LARGE,
               small: int = SMALL) -> tuple[str, dict]:
    """A seeded .dat and the JAX package's clean encode of it."""
    base = str(tmp_path / "ref")
    rng = np.random.default_rng(seed)
    with open(base + ".dat", "wb") as f:
        f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    ref_encoder.write_ec_files(base, RefRS(10, 4, engine=CpuEngine()),
                               large_block_size=large, small_block_size=small)
    return base + ".dat", _files(base)


def _encoder(depth: int = 3, async_drain: bool = True,
             drain_pool: int = 0) -> StreamingEncoder:
    enc = StreamingEncoder(device="cpu")
    enc.dispatch_b = DISPATCH_B
    enc.depth = depth
    enc.async_drain = async_drain
    if drain_pool:
        enc.drain_pool = drain_pool
    return enc


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    return _reference(tmp_path_factory.mktemp("resume"), 2_000_000, seed=9)


@pytest.mark.parametrize("async_drain", [True, False],
                         ids=["async", "inline"])
def test_fill_fault_resumes_from_checkpoint(volume, tmp_path, monkeypatch,
                                            async_drain):
    """The 15th fill read fails (dispatch 3 of 4): the retry resumes past
    what the drain wrote and the bytes equal the clean reference's.  With
    depth 1 (two slots) dispatch 3 has a slot only once dispatch 1 is
    written, so the checkpoint is past byte 0 whichever thread drains."""
    dat, ref = volume
    real = streaming.preadv_into
    calls = {"n": 0}

    def flaky(f, views, off):
        calls["n"] += 1
        if calls["n"] == 15:
            raise OSError("injected fill IO error")
        return real(f, views, off)

    monkeypatch.setattr(streaming, "preadv_into", flaky)
    enc = _encoder(depth=1, async_drain=async_drain)
    out = str(tmp_path / "o")
    enc.encode_file(dat, out, LARGE, SMALL)
    assert _files(out) == ref
    assert enc.stats["retries"] == 1
    assert enc.stats["resume_byte"] > 0
    assert enc.stats["resume_byte"] % SMALL == 0


@pytest.mark.parametrize("point", ["ec.dispatch", "ec.drain"])
@pytest.mark.parametrize("async_drain", [True, False],
                         ids=["async", "inline"])
def test_fault_point_resumes_from_checkpoint(volume, tmp_path, point,
                                             async_drain):
    dat, ref = volume
    fi.enable(point, error_rate=1.0, max_hits=1, after=2)  # dispatch 3
    enc = _encoder(depth=1, async_drain=async_drain)
    out = str(tmp_path / "o")
    enc.encode_file(dat, out, LARGE, SMALL)
    assert fi.fired(point) == 1
    assert _files(out) == ref
    assert enc.stats["retries"] == 1
    assert enc.stats["resume_byte"] > 0
    # the resumed attempt started past the checkpoint: fewer dispatches
    # than the whole encode's 4
    assert enc.stats["dispatches"] < 4


def test_staged_resume_entrypoint_is_byte_exact(tmp_path):
    """Wreck every shard past a plan-entry boundary, re-enter
    _encode_file_staged at that checkpoint: the bytes, `.eci` included,
    equal a clean encode (packing after a resume differs; bytes may
    not)."""
    dat, ref = _reference(tmp_path, 1_500_000, seed=10)
    enc = _encoder()
    out = str(tmp_path / "o")
    enc.encode_file(dat, out, LARGE, SMALL)
    assert _files(out) == ref
    ck_entry, ck_byte = 7, 7 * SMALL
    for i in range(14):
        with open(out + to_ext(i), "r+b") as f:
            f.seek(ck_byte)
            tail = len(f.read())
            f.seek(ck_byte)
            f.write(b"\xAA" * (tail + 5000))  # longer than it was, too
    os.remove(out + ".eci")
    enc._encode_file_staged(dat, out, LARGE, SMALL, start_entry=ck_entry,
                            start_byte=ck_byte)
    assert _files(out) == ref
    assert enc.stats["resume_byte"] == ck_byte


@pytest.mark.parametrize("async_drain", [True, False],
                         ids=["async", "inline"])
def test_depth_four_is_byte_identical(tmp_path, async_drain):
    """Five slots in flight, with and without the drain threads: shards
    and the write-order `.eci` equal the reference's, and a drain fault
    late in the encode still resumes to the same bytes."""
    dat, ref = _reference(tmp_path, 6_000_000, seed=12, large=200_000,
                          small=20_000)
    enc = _encoder(depth=4, async_drain=async_drain, drain_pool=3)
    out = str(tmp_path / "o")
    enc.encode_file(dat, out, 200_000, 20_000)
    assert _files(out) == ref
    assert enc.stats["drain_pool"] == (3 if async_drain else 0)
    assert enc.stats["parity_bytes_drained"] == 4 * os.path.getsize(
        out + to_ext(0))
    assert enc.stats["retries"] == 0
    fi.enable("ec.drain", error_rate=1.0, max_hits=1, after=7)
    os.remove(out + ".eci")
    enc.encode_file(dat, out, 200_000, 20_000)
    assert _files(out) == ref
    assert enc.stats["retries"] == 1 and enc.stats["resume_byte"] > 0


def test_retries_exhausted_leave_nothing_behind(volume, tmp_path):
    dat, _ = volume
    fi.enable("ec.dispatch", error_rate=1.0, after=3)
    enc = _encoder(depth=1)
    assert enc.max_encode_retries == 2
    out = str(tmp_path / "o")
    with pytest.raises(OSError, match="fault injected at ec.dispatch"):
        enc.encode_file(dat, out, LARGE, SMALL)
    assert fi.fired("ec.dispatch") == 3  # the first attempt and 2 retries
    assert enc.stats["retries"] == 2
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("where", ["kernel", "oom", "parity_fetch"])
def test_cuda_errors_are_not_retried(volume, tmp_path, monkeypatch, where):
    """An error of the card itself is raised at once: no resume, no
    second launch, no output left and no output file left open.  At the
    parity fetch the pipeline's closing synchronize fails too, as it does
    on a lost context, and must still raise a KernelError."""
    dat, _ = volume
    calls = {"n": 0}
    if where == "parity_fetch":
        real = streaming._Pipeline._parity

        def failing(self, slot, n):
            calls["n"] += 1
            if calls["n"] == 2:
                self.copy = "stream"  # close() now waits on the card
                raise KernelError("parity fetch on cuda: CUDA error 700")
            return real(self, slot, n)

        def sync_fails(device=None):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

        monkeypatch.setattr(streaming._Pipeline, "_parity", failing)
        monkeypatch.setattr(streaming.torch.cuda, "synchronize", sync_fails)
        expected, fail_at = KernelError, 2
    else:
        error = (KernelError("gf_matmul kernel launch failed: CUDA error 700")
                 if where == "kernel"
                 else torch.cuda.OutOfMemoryError("CUDA out of memory"))
        real = streaming.gf_matmul

        def failing(*args, **kw):
            calls["n"] += 1
            if calls["n"] == 3:
                raise error
            return real(*args, **kw)

        monkeypatch.setattr(streaming, "gf_matmul", failing)
        expected, fail_at = type(error), 3
    opened = []

    def tracked_open(*args, **kw):
        f = open(*args, **kw)
        opened.append(f)
        return f

    monkeypatch.setattr(streaming, "open", tracked_open, raising=False)
    enc = _encoder(depth=1)
    out = str(tmp_path / "o")
    with pytest.raises(expected):
        enc.encode_file(dat, out, LARGE, SMALL)
    assert calls["n"] == fail_at
    assert enc.stats["retries"] == 0
    assert os.listdir(tmp_path) == []
    assert opened and all(f.closed for f in opened)
