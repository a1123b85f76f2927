"""File-id key sequencers (weed/sequence/), as seaweedfs_tpu/master/
sequence.py has them.

Memory sequencer mirrors sequence/memory_sequencer.go:13-37; snowflake
mirrors sequence/snowflake_sequencer.go (41-bit ms timestamp, 10-bit node,
12-bit step).
"""

from __future__ import annotations

import threading
import time


class MemorySequencer:
    def __init__(self, start: int = 1):
        self._counter = start
        self._lock = threading.Lock()

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            start = self._counter
            self._counter += count
            return start

    def set_max(self, seen: int) -> None:
        with self._lock:
            if seen > self._counter:
                self._counter = seen + 1

    def peek(self) -> int:
        return self._counter


class SnowflakeSequencer:
    EPOCH_MS = 1234567890000

    def __init__(self, node_id: int = 1):
        self.node_id = node_id & 0x3FF
        self._lock = threading.Lock()
        self._last_ms = 0
        self._step = 0

    def next_file_id(self, count: int = 1) -> int:
        """Reserves `count` contiguous step values (the reference's
        snowflake ignores count — snowflake_sequencer.go:38-40 — which makes
        batch-assign fids collide with the next assign; reserving the full
        range is strictly safer)."""
        with self._lock:
            now = int(time.time() * 1000)
            if now == self._last_ms:
                if self._step + count > 4096:
                    while now <= self._last_ms:
                        now = int(time.time() * 1000)
                    self._step = 0
            else:
                self._step = 0
            self._last_ms = now
            first_step = self._step
            self._step += count
            return (((now - self.EPOCH_MS) & ((1 << 41) - 1)) << 22
                    | self.node_id << 12 | first_step)

    def set_max(self, seen: int) -> None:
        pass  # time-ordered; nothing to do

    def peek(self) -> int:
        return 0  # time-ordered; no replicable counter state
