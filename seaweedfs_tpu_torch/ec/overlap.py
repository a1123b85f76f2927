"""FIFO-preserving asynchronous drain for the streaming encode.

The port's copy of ``AsyncDrainer`` (seaweedfs_tpu/ec/overlap.py:638-767)
and of ``DrainerGroup`` (:769-837), the per-card drain lanes of
``-ec.engine mesh``.

The encode's producer thread hands each dispatch to the drainer and goes
on filling the next slot; the drainer waits for the dispatch's parity on a
small fetch pool and writes it on ONE writer thread, in submission order,
so the shard append order and the `.eci` crc stream are those of a serial
drain.

Not ported: ``ProcessOverlapWorker`` and ``FileParityWorker``
(:557-636), which feed the reference's CPU codec from worker processes;
the port's parity comes from the card.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from typing import Callable, Optional


class AsyncDrainer:
    """``fetch(meta)`` runs on a pool of ``pool_size`` threads;
    ``write(meta, result)`` runs on one writer thread, fed in submission
    order through a bounded queue, however the fetches complete.

    Error model: the first fetch or write exception is kept (later
    results are consumed and discarded, never written), re-raised from
    ``finish()`` and readable through ``.error`` for the producer to poll
    between dispatches.  ``abort()`` is the abnormal-exit path: it drops
    queued work, joins the threads and never raises."""

    def __init__(self, fetch: Callable, write: Callable, pool_size: int = 1,
                 queue_depth: int = 8, name: str = "ec-drain"):
        self._fetch_fn = fetch
        self._write_fn = write
        self.pool_size = max(1, int(pool_size))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.pool_size, thread_name_prefix=f"{name}-fetch")
        # sized by the caller to its slot count: a put never blocks in
        # practice, and the queue cannot grow without bound
        self._wq: queue.Queue = queue.Queue(maxsize=max(2, int(queue_depth)))
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None  # guarded by _lock
        self._inflight = 0  # guarded by _lock
        self._finished = False  # guarded by _lock
        # a monotonic flag read without the lock: the unwinding caller
        # must never block on it
        self.aborting = False
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name=f"{name}-writer")
        self._writer.start()

    @property
    def error(self) -> Optional[BaseException]:
        with self._lock:
            return self._error

    @property
    def inflight(self) -> int:
        """Dispatches submitted and not yet written or discarded."""
        with self._lock:
            return self._inflight

    def submit(self, meta) -> None:
        with self._lock:
            err = self._error
            if err is None:
                self._inflight += 1
        if err is not None:
            raise err
        fut = self._pool.submit(self._fetch_fn, meta)
        self._wq.put((meta, fut))

    def _write_loop(self) -> None:
        while True:
            item = self._wq.get()
            if item is None:
                return
            meta, fut = item
            try:
                result = fut.result()
                if not self.aborting and self.error is None:
                    self._write_fn(meta, result)
            except (KeyboardInterrupt, SystemExit):  # pragma: no cover
                raise
            except BaseException as e:  # noqa: BLE001 - kept for finish()
                with self._lock:
                    if self._error is None and not self.aborting:
                        self._error = e
            finally:
                with self._lock:
                    self._inflight -= 1

    def finish(self, timeout: Optional[float] = None) -> None:
        """Wait until every submitted dispatch is fetched AND written,
        then re-raise the first error kept."""
        with self._lock:
            finished, self._finished = self._finished, True
        if not finished:
            self._wq.put(None)
        self._writer.join(timeout)
        if self._writer.is_alive():
            raise RuntimeError("async drain writer stalled")
        self._pool.shutdown(wait=True)
        err = self.error
        if err is not None:
            raise err

    def abort(self) -> None:
        """Drop queued work and join the threads; never raises (the
        caller is already unwinding an exception)."""
        self.aborting = True
        with self._lock:
            finished, self._finished = self._finished, True
        if not finished:
            try:
                self._wq.put(None, timeout=1.0)
            except queue.Full:  # pragma: no cover - contract breach
                pass
        try:
            self._writer.join(timeout=30)
            self._pool.shutdown(wait=True)
        except Exception:  # noqa: BLE001 - best-effort teardown
            pass


class DrainerGroup:
    """One AsyncDrainer per lane: lane i fetches its card's parity on its
    own thread and writes through its own writer, so a slow card
    back-pressures only its own dispatch queue.

    FIFO is per lane; the order across lanes is the caller's contract
    (the mesh encode pwrites parity at known shard offsets and retires
    the `.eci` crc stream and the checkpoint through an ordered
    completion tracker).  The error and abort surface is AsyncDrainer's,
    so the encode's resume treats N lanes as one drain: ``error`` is the
    first lane error kept, ``finish()`` joins every lane and then
    re-raises it, ``abort()`` tears every lane down, and the lock-free
    ``aborting`` flag fans out to every lane."""

    def __init__(self, lanes: int, fetch: Callable, write: Callable,
                 queue_depth: int = 8, name: str = "ec-mesh-drain"):
        self.drainers = [
            AsyncDrainer(fetch, write, pool_size=1, queue_depth=queue_depth,
                         name=f"{name}-{i}")
            for i in range(max(1, int(lanes)))]
        self.pool_size = len(self.drainers)

    @property
    def error(self) -> Optional[BaseException]:
        for d in self.drainers:
            err = d.error
            if err is not None:
                return err
        return None

    @property
    def inflight(self) -> int:
        return sum(d.inflight for d in self.drainers)

    @property
    def aborting(self) -> bool:
        return any(d.aborting for d in self.drainers)

    @aborting.setter
    def aborting(self, value: bool) -> None:
        for d in self.drainers:
            d.aborting = value

    def submit(self, lane: int, meta) -> None:
        self.drainers[lane].submit(meta)

    def finish(self, timeout: Optional[float] = None) -> None:
        """Join every lane, then re-raise the FIRST lane error: one
        failing card fails the encode where a single drain would have."""
        first: Optional[BaseException] = None
        for d in self.drainers:
            try:
                d.finish(timeout)
            except (KeyboardInterrupt, SystemExit):  # pragma: no cover
                raise
            except BaseException as e:  # noqa: BLE001 - re-raised below
                if first is None:
                    first = e
        if first is not None:
            raise first

    def abort(self) -> None:
        for d in self.drainers:
            d.abort()
