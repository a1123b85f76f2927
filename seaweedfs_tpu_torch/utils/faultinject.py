"""Fault injection: named fault points that raise or stall on chosen hits.

The port's copy of seaweedfs_tpu/utils/faultinject.py, with the points the
port's EC pipeline, its repair coordinator, its volumes' disk IO and
their tier moves hit.  A
point is free when nothing is armed (one dict-emptiness check at each
site); tests and drills arm it:

    from seaweedfs_tpu_torch.utils import faultinject as fi

    fi.enable("ec.dispatch", error_rate=1.0, max_hits=1, after=12)
    ...
    fi.clear()

A server started from the command line arms points from the
``WEED_FAULTS`` environment variable (``arm_from_env``).

``delay`` (the reference's key) stalls each hit that much before it
returns or raises, so a drill can slow the coordinator's legs
(``coord.exec:delay=1``) and kill its master mid-repair.  ``after`` is
the port's addition: the first ``after`` hits of an armed point pass, so
a drill can fail the 13th dispatch of an encode and not the first.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Optional

_lock = threading.Lock()
_points: dict[str, dict] = {}
_counts: dict[str, int] = {}

# every hit()/corrupt_block() site in the port names one of these, and
# each is hit somewhere in the port (tests/test_torch_faultinject.py
# checks both ways); the shell's fault.list prints the table
FAULT_POINTS: dict[str, str] = {
    "ec.dispatch": "streaming encode, after a slot is filled and before "
                   "its dispatch is launched: an injected error fails the "
                   "attempt, which resumes from the last written "
                   "checkpoint (ec/streaming.py)",
    "ec.drain": "streaming encode, when a dispatch's parity is fetched "
                "for writing: an injected error fails the attempt, which "
                "resumes from the checkpoint (ec/streaming.py)",
    "ec.shard.corrupt": "deterministic bit flip on EC shard reads "
                        "(corrupt_block): params {shard, offset, bit}; the "
                        "bit-rot drill behind verify-on-use and the "
                        "scrubber (ec/ec_volume.py, ec/integrity.py, "
                        "ec/streaming.py rebuild)",
    "disk.read": "a volume's .dat positional read, pread or mapped "
                 "(storage/backend.py DiskFile, MemoryMappedFile)",
    "disk.write": "a volume's .dat positional write (storage/backend.py "
                  "DiskFile): an injected error fails the append, which "
                  "is truncated back",
    "disk.sync": "the fsync of a volume's .dat (a group-commit batch, "
                 "a direct fsync write, sync, close): an injected error "
                 "rolls the batch back (storage/backend.py DiskFile, "
                 "storage/volume.py)",
    "tier.upload": "tier phase-1 upload, hit with the .tier manifest on "
                   "disk and no remote byte sent yet: a delay opens the "
                   "mid-upload kill window, after which the local .dat "
                   "stays authoritative and the partial remote object is "
                   "collected (storage/volume.py tier_upload_begin)",
    "tier.recall": "tier recall download, hit with the manifest in "
                   "'recalling' and only a temp file partial: after a "
                   "kill there the remote copy stays authoritative "
                   "(storage/volume.py tier_download)",
    "coord.plan": "the coordinator's planning cycle: an injected error "
                  "is contained (the loop survives, last_error shows it, "
                  "the next cycle re-plans) (ops/coordinator.py)",
    "coord.exec": "every /admin/ec/* and /ec/scrub/start leg the plan "
                  "executor posts: an injected error fails the current "
                  "repair or move, so the re-plan and no-orphan cleanup "
                  "paths run (ops/coordinator.py)",
}


def list_points() -> list[tuple[str, str]]:
    """The registry as sorted (name, description) pairs: what the shell's
    fault.list prints."""
    return sorted(FAULT_POINTS.items())


def enable(name: str, error_rate: float = 0.0, max_hits: int = 0,
           params: Optional[dict] = None, after: int = 0,
           delay: float = 0.0) -> None:
    """Arm a fault point: a hit raises OSError with probability
    error_rate in [0, 1] and first sleeps ``delay`` seconds; each hit
    that sleeps or raises counts as injected, and max_hits > 0 disarms
    the point after that many; the first ``after`` hits pass untouched.
    params carries site data for data-mutation points
    (ec.shard.corrupt's shard/offset/bit)."""
    with _lock:
        _points[name] = {
            "error_rate": error_rate,
            "delay": delay,
            "max_hits": max_hits,
            "hits": 0,
            "after": after,
            "passed": 0,
            "params": dict(params) if params else None,
        }


def disable(name: str) -> None:
    with _lock:
        _points.pop(name, None)


def clear() -> None:
    with _lock:
        _points.clear()
        _counts.clear()


def fired(name: str) -> int:
    """How many times this point actually injected a fault."""
    return _counts.get(name, 0)


def _spent(p: dict) -> bool:
    """Under _lock: True while the point lets this hit pass (still in its
    ``after`` window, or out of hits)."""
    if p["passed"] < p["after"]:
        p["passed"] += 1
        return True
    return bool(p["max_hits"] and p["hits"] >= p["max_hits"])


def hit(name: str) -> None:
    """The instrumented call: a no-op unless armed (callers guard with
    ``if faultinject._points:`` so an unarmed site costs one check)."""
    if not _points:
        return
    with _lock:
        p = _points.get(name)
        if p is None or _spent(p):
            return
        inject_error = bool(p["error_rate"]
                            and random.random() < p["error_rate"])
        delay = p["delay"]
        if not (inject_error or delay):
            return
        p["hits"] += 1
        _counts[name] = _counts.get(name, 0) + 1
    if delay:
        time.sleep(delay)
    if inject_error:
        raise OSError(f"fault injected at {name}")


def arm_from_env(spec: Optional[str] = None) -> int:
    """Arm fault points from a ``WEED_FAULTS`` spec, so a drill reaches
    servers started in other processes.  Format
    ``name:key=val,key=val;name2:...``, e.g.
    ``WEED_FAULTS="ec.dispatch:error_rate=1,max_hits=1,after=12"`` or
    ``WEED_FAULTS="coord.exec:delay=1"``.  Keys: error_rate and delay
    (floats, delay in seconds), max_hits and after (ints).  Returns the
    number of points armed."""
    if spec is None:
        spec = os.environ.get("WEED_FAULTS", "")
    armed = 0
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, kvs = part.partition(":")
        kwargs: dict = {}
        for kv in kvs.split(","):
            k, _, v = kv.strip().partition("=")
            k = k.strip()
            if k in ("max_hits", "after"):
                kwargs[k] = int(v)
            elif k in ("error_rate", "delay"):
                kwargs[k] = float(v)
        enable(name.strip(), **kwargs)
        armed += 1
    return armed


def corrupt_block(name: str, shard_id: int, data, file_offset: int = 0):
    """Data-mutation fault (ec.shard.corrupt): flip one bit of a shard
    read.  Armed with ``enable(name, params={"shard": id, "offset": byte,
    "bit": 0-7})``, any read of ``shard_id`` whose [file_offset,
    file_offset + len) covers ``offset`` comes back with that bit flipped,
    as on-media rot would.  Returns ``data`` untouched when unarmed or out
    of range; counts a hit only when it flips.  Takes bytes or a 1-D
    uint8 ndarray (flipped in place when writable, else on a copy)."""
    if not _points:
        return data
    with _lock:
        p = _points.get(name)
        prm = p.get("params") if p is not None else None
        if not prm or int(prm.get("shard", -1)) != shard_id:
            return data
        if p["max_hits"] and p["hits"] >= p["max_hits"]:
            return data
        target = int(prm.get("offset", 0))
        if not (file_offset <= target < file_offset + len(data)):
            return data
        p["hits"] += 1
        _counts[name] = _counts.get(name, 0) + 1
        bit = int(prm.get("bit", 0)) & 7
    rel = target - file_offset
    if isinstance(data, (bytes, bytearray, memoryview)):
        buf = bytearray(data)
        buf[rel] ^= 1 << bit
        return bytes(buf)
    arr = data if getattr(data.flags, "writeable", False) else data.copy()
    arr[rel] ^= 1 << bit
    return arr
