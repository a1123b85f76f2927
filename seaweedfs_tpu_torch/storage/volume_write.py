"""Group commit: fsync writes and deletes batched under one fsync.

seaweedfs_tpu/storage/volume_write.py (weed/storage/volume_write.go:94-305,
needle/async_request.go).  Writers submit requests to a queue; one worker
thread a volume takes them in batches of at most 4 MiB of payload or 128
requests, appends every record under the volume's write lock, then makes
the batch durable with one fsync of the `.dat` and one of the `.idx` before
it answers the requests (the reference fsyncs the `.dat` alone, so the
crash check may cut an acknowledged record whose index entry was lost).

A request's own logical error (cookie mismatch, read-only volume) fails
that request only.  A failed append or fsync rolls the batch back: the
`.dat` and the `.idx` are cut back to where the batch began, the needle map
is reloaded (of the volume's kind, its `.ldb` snapshot removed) and
published, and every request of the batch fails, so a running server
stays consistent without a restart.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

from .needle import Needle

MAX_BATCH_BYTES = 4 * 1024 * 1024
MAX_BATCH_REQUESTS = 128


class WorkerStoppedError(RuntimeError):
    """The worker stopped before it took the request: nothing of it was
    written, so the caller may submit it again (Volume.write_needle2
    does, to the worker made after a commit, or writes it directly)."""


class AsyncRequest:
    """One queued write or delete and, once its batch is done, its result."""

    __slots__ = ("needle", "is_write", "_done", "offset", "size",
                 "unchanged", "error")

    def __init__(self, needle: Needle, is_write: bool):
        self.needle = needle
        self.is_write = is_write
        self._done = threading.Event()
        self.offset = 0
        self.size = 0
        self.unchanged = False
        self.error: Optional[BaseException] = None

    def complete(self, offset: int, size: int, unchanged: bool) -> None:
        if self._done.is_set():
            return
        self.offset, self.size, self.unchanged = offset, size, unchanged
        self._done.set()

    def fail(self, err: BaseException) -> None:
        if self._done.is_set():  # the first outcome stands
            return
        self.error = err
        self._done.set()

    def wait(self, timeout: Optional[float] = None):
        """Block until the request's batch is durable -> (offset, size,
        unchanged), or raise the request's error."""
        if not self._done.wait(timeout):
            raise TimeoutError("group-commit request timed out")
        if self.error is not None:
            raise self.error
        return self.offset, self.size, self.unchanged

    def estimated_bytes(self) -> int:
        return len(self.needle.data) + 256


class GroupCommitWorker:
    """The single writer thread of one Volume; ``submit_*`` are
    thread-safe.  ``fsync_count`` counts durable batches, each a `.dat`
    and an `.idx` fsync.  ``request_count``, ``batch_count``, ``fsync_count`` and
    ``rollback_count`` are written by the worker thread alone."""

    def __init__(self, volume, max_batch_bytes: int = MAX_BATCH_BYTES,
                 max_batch_requests: int = MAX_BATCH_REQUESTS):
        self.volume = volume
        self.max_batch_bytes = max_batch_bytes
        self.max_batch_requests = max_batch_requests
        self._q: queue.Queue[Optional[AsyncRequest]] = queue.Queue()
        self._stopped = False
        self._submit_lock = threading.Lock()
        self.request_count = 0
        self.batch_count = 0
        self.fsync_count = 0
        self.rollback_count = 0
        self._thread = threading.Thread(
            target=self._run, name=f"group-commit-{volume.id}", daemon=True)
        self._thread.start()

    # --- producers --------------------------------------------------------
    def submit_write(self, n: Needle) -> AsyncRequest:
        return self._submit(AsyncRequest(n, True))

    def submit_delete(self, n: Needle) -> AsyncRequest:
        return self._submit(AsyncRequest(n, False))

    def _submit(self, req: AsyncRequest) -> AsyncRequest:
        # the check and the put are one step against stop(): a request
        # queued after the worker took the sentinel would wait forever
        with self._submit_lock:
            if self._stopped or not self._thread.is_alive():
                req.fail(WorkerStoppedError("group-commit worker stopped"))
                return req
            self._q.put(req)
        return req

    def stop(self) -> None:
        """Commit what is queued, then end the thread."""
        with self._submit_lock:
            first = not self._stopped
            if first:
                self._stopped = True
                self._q.put(None)
        if first:
            self.wait_stopped()

    def wait_stopped(self) -> None:
        self._thread.join(timeout=30)

    # --- the worker -------------------------------------------------------
    def _next_batch(self) -> tuple[list[AsyncRequest], bool]:
        """Wait for one request, then take what is already queued, up to
        the batch limits (startWorker, volume_write.go:246-270)."""
        first = self._q.get()
        if first is None:
            return [], True
        batch = [first]
        total = first.estimated_bytes()
        while (len(batch) < self.max_batch_requests
               and total < self.max_batch_bytes):
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is None:
                return batch, True
            batch.append(req)
            total += req.estimated_bytes()
        return batch, False

    def _run(self) -> None:
        while True:
            batch, stopping = self._next_batch()
            if batch:
                try:
                    self._commit_batch(batch)
                except BaseException as e:  # the thread must stay up
                    for req in batch:
                        req.fail(e)
            if stopping:
                # fail whatever came after the sentinel
                while True:
                    try:
                        req = self._q.get_nowait()
                    except queue.Empty:
                        return
                    if req is not None:
                        req.fail(WorkerStoppedError("group-commit worker stopped"))

    def _commit_batch(self, batch: list[AsyncRequest]) -> None:
        v = self.volume
        applied: list[tuple[AsyncRequest, tuple]] = []
        failed_early: set[int] = set()
        # appends, the fsyncs and a rollback all under the write lock: no
        # direct write lands inside the rollback's window
        with v.write_lock:
            v._writable()
            dat_start = v.data_size
            idx_start = (os.path.getsize(v.idx_path)
                         if os.path.exists(v.idx_path) else 0)
            try:
                for req in batch:
                    try:
                        if req.is_write:
                            result = v._do_write(req.needle)
                        else:
                            result = (0, v._do_delete(req.needle), False)
                        applied.append((req, result))
                    except (KeyError, ValueError, PermissionError) as e:
                        req.fail(e)
                        failed_early.add(id(req))
                v._sync_files()
                self.fsync_count += 1
            except Exception as e:
                # whatever failed, roll back and fail the batch: a dead
                # worker would hang every later fsync writer
                self.rollback_count += 1
                v._rollback_appends(dat_start, idx_start)
                for req in batch:
                    if id(req) not in failed_early:
                        req.fail(e)
                return
        self.batch_count += 1
        self.request_count += len(batch)
        for req, (offset, size, unchanged) in applied:
            req.complete(offset, size, unchanged)
