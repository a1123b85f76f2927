"""The port's AsyncDrainer against seaweedfs_tpu's, fed the same callbacks.

Both drainers get the same seeded fetch delays (so fetches complete out of
submission order on a pool of four), the same failing fetch or write, and
the same abort; what each writes, in which order, what ``finish()``
raises and what ``.error`` reads must be equal.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.ec.overlap import AsyncDrainer as RefAsyncDrainer
from seaweedfs_tpu_torch.ec.overlap import AsyncDrainer

SIDES = {"ref": RefAsyncDrainer, "port": AsyncDrainer}
N = 24


class _Boom(Exception):
    pass


def _delays(seed: int) -> list[float]:
    """Later dispatches fetch faster: completions come back reversed."""
    rng = np.random.default_rng(seed)
    return [0.002 * (N - i) + float(rng.uniform(0, 0.002)) for i in range(N)]


def _drive(cls, delays, fail_fetch=None, fail_write=None, pool_size=4):
    """Submit N dispatches; -> (written metas in order, fetch completion
    order, the error finish() raised, drainer.error after)."""
    written, fetched = [], []
    lock = threading.Lock()

    def fetch(meta):
        time.sleep(delays[meta])
        with lock:
            fetched.append(meta)
        if meta == fail_fetch:
            raise _Boom(f"fetch {meta}")
        return meta * 10

    def write(meta, result):
        if meta == fail_write:
            raise _Boom(f"write {meta}")
        assert result == meta * 10
        written.append(meta)

    d = cls(fetch, write, pool_size=pool_size, queue_depth=N + 2)
    raised = None
    try:
        for meta in range(N):
            d.submit(meta)
        d.finish()
    except _Boom as e:
        raised = str(e)
    finally:
        d.abort()
    return written, fetched, raised, (str(d.error) if d.error else None)


def test_writes_in_submission_order_under_out_of_order_fetches():
    out = {side: _drive(cls, _delays(1)) for side, cls in SIDES.items()}
    for side in SIDES:
        written, fetched, raised, err = out[side]
        assert written == list(range(N)), side
        assert fetched != sorted(fetched), side  # completions were reordered
        assert raised is None and err is None
    assert out["port"][0] == out["ref"][0]


@pytest.mark.parametrize("where", ["fetch", "write"])
def test_first_error_is_reraised_and_later_results_dropped(where):
    kw = {f"fail_{where}": 9}
    out = {side: _drive(cls, _delays(2), **kw) for side, cls in SIDES.items()}
    assert out["port"][0] == out["ref"][0] == list(range(9))
    assert out["port"][2] == out["ref"][2] == f"{where} 9"
    assert out["port"][3] == out["ref"][3] == f"{where} 9"


def test_error_is_polled_and_submit_refuses_after_it():
    for side, cls in SIDES.items():
        d = cls(lambda m: m, lambda m, r: (_ for _ in ()).throw(_Boom("w")),
                pool_size=2)
        d.submit(0)
        deadline = time.monotonic() + 10
        while d.error is None:
            assert time.monotonic() < deadline, side
            time.sleep(0.01)
        assert str(d.error) == "w"
        with pytest.raises(_Boom):
            d.submit(1)
        d.abort()
        assert d.inflight == 0, side


def test_abort_joins_and_never_raises():
    """An abort with slow fetches still queued returns without raising,
    writes nothing more, and leaves no drain thread alive."""
    for side, cls in SIDES.items():
        before = set(threading.enumerate())
        written = []
        gate = threading.Event()

        def fetch(meta, gate=gate):
            gate.wait(5)
            raise _Boom("late")

        d = cls(fetch, lambda m, r, w=written: w.append(m), pool_size=2)
        for meta in range(4):
            d.submit(meta)
        # the fetches end only once the abort is under way
        threading.Timer(0.2, gate.set).start()
        d.abort()
        d.abort()  # a second abort is harmless
        assert written == [] and d.error is None, side
        left = [t for t in set(threading.enumerate()) - before
                if t.is_alive() and not isinstance(t, threading.Timer)]
        assert left == [], (side, left)


def test_finish_waits_for_every_write():
    for side, cls in SIDES.items():
        written = []
        d = cls(lambda m: (time.sleep(0.01), m)[1],
                lambda m, r: written.append(r), pool_size=3)
        for meta in range(10):
            d.submit(meta)
        d.finish()
        assert written == list(range(10)) and d.inflight == 0, side
        assert d.pool_size == 3
