"""Volume-server store: data directories, volumes, EC volumes, heartbeats.

The subset of seaweedfs_tpu/volume_server/store.py (weed/storage/store.go +
store_ec.go) that the volume server's HTTP surface calls: create, mount,
delete and describe volumes, write, read and delete needles, EC-encode a
volume (`-ec.engine=tpu` in the reference: the streaming pipeline),
compact a volume and commit the compaction, check a volume's needles and
rewrite its replica placement, open a volume copied from another server,
delete, rebuild and serve shards, read needles from the shards with
remote fetch or reconstruction of what is missing, decode back to a
volume, and build the master's full and delta heartbeats.  Every GF
product goes through ops.gf_matmul on ``device``; with ``ec_engine``
"mesh" (``-ec.engine mesh``) the EC encode, rebuild and reconstruction
run over the lanes of ``ec_mesh_devices`` instead (store.go's reference
counterpart: seaweedfs_tpu/volume_server/store.py:173-184, :760-805).

EC volumes are mounted, unmounted and swapped under ``ec_swap()``, so a
reader never finds a volume briefly absent while the scrubber quarantines
a shard.  A reader holds the volume it found (``ec_volume_held``) for the
whole read, remote fetch and reconstruction included, without holding the
swap back: an unmounted volume closes its files when its last reader
leaves.

Live-volume reads go through the needle cache (needle_cache.py,
``-dataplane.cacheMB``, 0 disables): a needle read twice stays in memory
until a write or delete of it, or an unmount, delete or vacuum commit of
its volume, drops it; a read offers what it read under the volume's
write epoch taken before the read, so a racing write is never undone.

A write or delete with ``fsync`` goes through its volume's group-commit
worker (``Volume.write_needle2``, storage/volume_write.py) with no lock of
the store held while it waits, so concurrent fsync writers share the
batch's fsyncs (the `.dat`'s and the `.idx`'s); without ``fsync`` it appends under the volume's write
lock alone.  Volumes open with the compact needle map, their `.dat`
mapped with ``use_mmap`` (``volume -mmap``).  A directory's volumes are
its `.dat` files and its `.vif` files: a tiered volume has only the
`.vif` and the `.idx` here, its `.dat` in a backend; each opens through
``Volume``, which first finishes or rolls back a tier move a crash
interrupted.  An EC encode of a tiered volume fails as the reference's
does: the encoder opens the local `.dat`, which is not there.  A volume
with 5-byte offsets (``add_volume(..., offset_5=True)``, volumes past
32 GB) serves every needle op, and its EC encode is refused before
anything is written, as the reference's is: the `.ecx` and shard reads
speak 16-byte entries only.

With the native data plane attached (``attach_native_plane``,
dataplane.py, ``volume -dataplane native``) every volume it can take
(version 3, 4-byte offsets, not tiered: ``_plane_eligible``) is
registered with it, and ``write_needle``, ``delete_needle`` and
``read_needle`` of such a volume go through the plane, its single writer.
The needle cache is not used then: the plane reads every needle.  An
``fsync`` write or delete waits for the plane's group sync.  Work on a
volume's files quiesces it first (``native_quiesced``: EC encode, vacuum
from compact to commit or cleanup, tier moves, fsck, replica placement,
read-only flips): the plane lets go of it and the Python Volume reloads,
replaying the `.idx` the plane appended to; needle ops in that window take
the shared side of the volume's swap lock and use the Python engine (its
group commit for ``fsync``); the last hold's release registers the volume
again.  Unmount and delete take it off the plane first; mount, a copy and
``ec_to_volume`` register theirs.  Heartbeats and ``volume_info`` read a
held volume's size and counts from the plane.
"""

from __future__ import annotations

import contextlib
import glob
import os
import re
import threading
import time
from typing import Callable, Optional

from ..ec import encoder as ec_encoder
from ..ec.codec import MeshEngine, ReedSolomon
from ..ec.ec_volume import EcVolume, NeedleNotFoundError
from ..ec.layout import DATA_SHARDS_COUNT, PARITY_SHARDS_COUNT, to_ext
from ..ec.streaming import StreamingEncoder
from ..master.topology import ShardBits
from ..ops.gf_matmul import resolve_device
from ..parallel.mesh import lanes_for
from ..storage.needle import Needle
from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import TTL
from ..storage.types import Version, size_is_deleted
from ..storage.volume import (CookieMismatchError, DeletedError,
                              NotFoundError, Volume, volume_file_prefix)
from .needle_cache import NeedleCache

_VOLUME_NAME = re.compile(r"(?:[\w.-]+_)?\d+")


def parse_volume_file_name(name: str) -> tuple[str, int]:
    """'collection_vid' or 'vid' -> (collection, vid)."""
    if "_" in name:
        collection, vid_str = name.rsplit("_", 1)
    else:
        collection, vid_str = "", name
    return collection, int(vid_str)


def _discover_volumes(directory: str) -> list[tuple[str, int]]:
    """A directory's volumes: a `.dat`, or a tiered volume's `.vif`."""
    return sorted(set(_discover(directory, ".dat"))
                  | set(_discover(directory, ".vif")))


def _discover(directory: str, ext: str) -> list[tuple[str, int]]:
    found = set()
    for path in glob.glob(os.path.join(directory, "*" + ext)):
        name = os.path.basename(path)[:-len(ext)]
        if _VOLUME_NAME.fullmatch(name):
            found.add(parse_volume_file_name(name))
    return sorted(found)


class _SwapLock:
    """Many needle ops (shared) or one plane swap (exclusive).  The
    quiesce window's fallback writes and reads take the shared side: they
    serialize against a detach or reattach, never against each other (a
    group commit's batches survive) or against a compaction holding the
    volume's lock.  A queued swap holds back new shared holders, so steady
    traffic cannot starve it."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._waiting = 0

    @contextlib.contextmanager
    def shared(self):
        with self._cond:
            while self._exclusive or self._waiting:
                self._cond.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                if not self._shared:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            self._waiting += 1
            try:
                while self._exclusive or self._shared:
                    self._cond.wait()
                self._exclusive = True
            finally:
                self._waiting -= 1
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


def _plane_gone(exc: BaseException) -> bool:
    """Did the plane let go of the volume between ``has`` and the call (a
    quiesce raced the op)?  The op then goes to the Python engine."""
    from .dataplane import DP_NO_VOLUME, DataPlaneError

    return isinstance(exc, DataPlaneError) and exc.code == DP_NO_VOLUME


class Store:
    def __init__(self, directories: list[str], ip: str = "127.0.0.1",
                 port: int = 8080, public_url: str = "",
                 max_volume_count: int = 8, device="cuda",
                 needle_cache_mb: int = 64, use_mmap: bool = False,
                 ec_engine: str = "", ec_mesh_devices=None):
        """Volumes under ``directories``, served at ``ip:port``; EC work on
        ``device`` ("cuda" needs a card, "cpu" runs the plain versions);
        a needle cache of ``needle_cache_mb`` MiB (0: none); each `.dat`
        mapped with ``use_mmap``.  ``ec_engine`` names the reference's
        engine the store runs ("" is the device's own: "tpu" on a card,
        "cpu" on the CPU); "mesh" runs EC over
        ``ec_mesh_devices``: a lane list, or an -ec.mesh.devices spec over
        every visible card (the CPU alone for a "cpu" device), validated
        here so a bad spec fails at start, not at the first encode."""
        self.device = resolve_device(device)
        if ec_engine not in ("", "tpu", "cpu", "mesh"):
            raise ValueError(f"ec_engine must be tpu, cpu or mesh, got "
                             f"{ec_engine!r}")
        self.ec_engine = ec_engine or (
            "cpu" if self.device.type == "cpu" else "tpu")
        self.ec_mesh_devices = ec_mesh_devices
        self.mesh_lanes: Optional[list] = None
        if ec_engine == "mesh":
            self.mesh_lanes = lanes_for(ec_mesh_devices, self.device)
        self.use_mmap = use_mmap
        self.ip, self.port = ip, port
        self.needle_cache = NeedleCache(
            max_bytes=max(0, int(needle_cache_mb)) << 20)
        self.public_url = public_url or f"{ip}:{port}"
        self.max_volume_count = max_volume_count
        self.volume_size_limit = 30 * 1000 * 1000 * 1000
        self.directories = list(directories)
        for d in self.directories:
            os.makedirs(d, exist_ok=True)
        self.volumes: dict[int, Volume] = {}
        self.volume_locks: dict[int, threading.Lock] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        self.ec_collections: dict[int, str] = {}
        # held to find a volume in ec_volumes and to change the table; a
        # reader holds only the volume it found (_ec_holders), so a swap
        # never waits on a read's IO or kernel launch
        self._ec_lock = threading.RLock()
        self._ec_holders: dict[EcVolume, int] = {}
        self._ec_unmounted: set[EcVolume] = set()
        # request threads ask for the codec and the encoder at once: each
        # is made once, under this lock
        self._init_lock = threading.Lock()
        self._rs: Optional[ReedSolomon] = None
        self._encoder: Optional[StreamingEncoder] = None
        self._mesh_encoder: Optional[StreamingEncoder] = None
        # delta-heartbeat bookkeeping (volume_grpc_client_to_master.go:48
        # streams new/deleted volume and EC-shard lists between full syncs)
        self._delta_lock = threading.Lock()
        self._new_vids: set[int] = set()
        self._gone_vids: set[int] = set()
        self._new_ec_vids: set[int] = set()
        self._gone_ec_vids: set[int] = set()
        # the native data plane, once attached; a volume's outstanding
        # quiesce holds (the last release registers it again) and its
        # swap lock
        self.native_plane = None
        # False under a whitelist: the plane has none, so its TCP port
        # takes no W or D frame of any volume
        self.native_tcp_writes_ok = True
        self._native_hold_lock = threading.Lock()
        self._native_holds: dict[int, int] = {}
        self._swap_locks: dict[int, _SwapLock] = {}
        for d in self.directories:
            for collection, vid in _discover_volumes(d):
                if vid not in self.volumes:
                    self._open_volume(self._volume(d, collection, vid))
            for collection, vid in _discover(d, ".ecx"):
                if vid not in self.ec_volumes:
                    self._open_ec_volume(d, collection, vid)

    def rs(self) -> ReedSolomon:
        """The RS(10,4) codec on this store's device, or over its mesh
        lanes (MeshEngine) for ``ec_engine`` "mesh"."""
        with self._init_lock:
            if self._rs is None:
                engine = (MeshEngine(devices=self.mesh_lanes)
                          if self.mesh_lanes is not None else None)
                self._rs = ReedSolomon(DATA_SHARDS_COUNT, PARITY_SHARDS_COUNT,
                                       device=self.device, engine=engine)
            return self._rs

    def streaming_encoder(self, engine: Optional[str] = None
                          ) -> StreamingEncoder:
        """The streaming encoder for ``engine`` (a request's, or else the
        store's): "mesh" is the per-card dispatch queues over the mesh
        lanes, anything else the device engine on ``device``."""
        name = engine or self.ec_engine
        with self._init_lock:
            if name == "mesh":
                if self._mesh_encoder is None:
                    lanes = self.mesh_lanes or lanes_for(
                        self.ec_mesh_devices, self.device)
                    self._mesh_encoder = StreamingEncoder(
                        device=self.device, engine="mesh", devices=lanes)
                return self._mesh_encoder
            if self._encoder is None:
                self._encoder = StreamingEncoder(device=self.device)
            return self._encoder

    def _volume(self, directory: str, collection: str, vid: int,
                **kwargs) -> Volume:
        return Volume(directory, collection, vid, use_mmap=self.use_mmap,
                      **kwargs)

    def _open_volume(self, v: Volume) -> Volume:
        self.volumes[v.id] = v
        self.volume_locks[v.id] = threading.Lock()
        self.note_volume_change(v.id)
        return v

    def _open_ec_volume(self, directory: str, collection: str,
                        vid: int) -> EcVolume:
        ev = EcVolume(volume_file_prefix(directory, collection, vid), vid)
        self.ec_volumes[vid] = ev
        self.ec_collections[vid] = collection
        self.note_ec_change(vid)
        return ev

    # --- delta heartbeat ---------------------------------------------------
    def note_volume_change(self, vid: int, gone: bool = False) -> None:
        with self._delta_lock:
            if gone:
                self._new_vids.discard(vid)
                self._gone_vids.add(vid)
            else:
                self._gone_vids.discard(vid)
                self._new_vids.add(vid)

    def note_ec_change(self, vid: int, gone: bool = False) -> None:
        with self._delta_lock:
            if gone:
                self._new_ec_vids.discard(vid)
                self._gone_ec_vids.add(vid)
            else:
                self._gone_ec_vids.discard(vid)
                self._new_ec_vids.add(vid)

    def _ec_shard_info(self, vid: int, ev: EcVolume) -> dict:
        return {"volume_id": vid,
                "collection": self.ec_collections.get(vid, ""),
                "ec_index_bits": ShardBits.of(ev.shards).bits}

    def pop_heartbeat_delta(self) -> Optional[dict]:
        """Changes since the last pop as an incremental heartbeat body;
        None when nothing changed.  A caller whose send fails must
        requeue_heartbeat_delta, so no change is lost."""
        with self._delta_lock:
            if not (self._new_vids or self._gone_vids
                    or self._new_ec_vids or self._gone_ec_vids):
                return None
            new_vids, self._new_vids = self._new_vids, set()
            gone_vids, self._gone_vids = self._gone_vids, set()
            new_ec, self._new_ec_vids = self._new_ec_vids, set()
            gone_ec, self._gone_ec_vids = self._gone_ec_vids, set()
        new_volumes = []
        for vid in sorted(new_vids):
            v = self.volumes.get(vid)
            if v is None:  # raced with a delete after the note
                gone_vids.add(vid)
            else:
                new_volumes.append(self.volume_info(v))
        new_ec_shards = []
        for vid in sorted(new_ec):
            ev = self.ec_volumes.get(vid)
            if ev is None:
                gone_ec.add(vid)
            else:
                new_ec_shards.append(self._ec_shard_info(vid, ev))
        return {"new_volumes": new_volumes,
                "deleted_volumes": sorted(gone_vids),
                "new_ec_shards": new_ec_shards,
                "deleted_ec_shards": sorted(gone_ec)}

    def requeue_heartbeat_delta(self, delta: dict) -> None:
        with self._delta_lock:
            for v in delta.get("new_volumes", []):
                self._new_vids.add(int(v["id"]))
            self._gone_vids.update(delta.get("deleted_volumes", []))
            for e in delta.get("new_ec_shards", []):
                self._new_ec_vids.add(int(e["volume_id"]))
            self._gone_ec_vids.update(delta.get("deleted_ec_shards", []))

    def collect_heartbeat(self) -> dict:
        """The full heartbeat (store.go:216 CollectHeartbeat)."""
        return {
            "ip": self.ip, "port": self.port, "public_url": self.public_url,
            "max_volume_count": self.max_volume_count,
            "volumes": [self.volume_info(v)
                        for v in list(self.volumes.values())],
            "ec_shards": [self._ec_shard_info(vid, ev)
                          for vid, ev in list(self.ec_volumes.items())],
        }

    def volume_info(self, v: Volume) -> dict:
        """``to_volume_information``, with the plane's size and counts
        while it holds the volume (the Python map is stale then: the
        master reseeds its sequencer from max_file_key)."""
        info = v.to_volume_information()
        plane = self.native_plane
        st = plane.stat(v.id) if plane is not None and plane.has(v.id) \
            else None
        if st is not None:
            dat_size, file_count, max_key, deleted_bytes, _ = st
            info["size"] = dat_size
            info["file_count"] = max(info["file_count"], file_count)
            info["max_file_key"] = max(info["max_file_key"], max_key)
            info["deleted_byte_count"] = max(info["deleted_byte_count"],
                                             deleted_bytes)
        return info

    # --- volumes ------------------------------------------------------------
    def add_volume(self, vid: int, collection: str = "",
                   replication: str = "000", ttl: str = "",
                   offset_5: bool = False) -> Volume:
        """AllocateVolume: a new volume with this replica placement, TTL
        and, with ``offset_5``, 5-byte offsets in its superblock (an
        existing volume is returned as is); on the plane if it can take
        it."""
        if vid in self.volumes:
            return self.volumes[vid]
        directory = min(self.directories,
                        key=lambda d: sum(1 for v in self.volumes.values()
                                          if v.directory == d))
        v = self._open_volume(self._volume(
            directory, collection, vid,
            replica_placement=ReplicaPlacement.parse(replication),
            ttl=TTL.parse(ttl), offset_5=offset_5))
        self._native_add(v)
        return v

    def get_volume(self, vid: int) -> Volume:
        v = self.volumes.get(vid)
        if v is None:
            raise KeyError(f"volume {vid} not found")
        return v

    def _native_drop(self, vid: int) -> None:
        """Off the plane for good, holds and all (unmount, delete)."""
        if self.native_plane is not None:
            self.native_plane.remove_volume(vid)
            with self._native_hold_lock:
                self._native_holds.pop(vid, None)

    def delete_volume(self, vid: int) -> None:
        self._native_drop(vid)
        v = self.volumes.pop(vid, None)
        self.volume_locks.pop(vid, None)
        self.needle_cache.invalidate_volume(vid, "unmount")
        if v is not None:
            v.destroy()
            self.note_volume_change(vid, gone=True)

    def unmount_volume(self, vid: int) -> None:
        self._native_drop(vid)
        v = self.volumes.pop(vid, None)
        self.volume_locks.pop(vid, None)
        self.needle_cache.invalidate_volume(vid, "unmount")
        if v is not None:
            v.close()
            self.note_volume_change(vid, gone=True)

    def mount_volume(self, vid: int) -> None:
        for d in self.directories:
            for collection, found in _discover_volumes(d):
                if found == vid:
                    self._open_volume(self._volume(d, collection, vid))
                    self.native_register(vid)
                    return
        raise KeyError(f"volume {vid} not found on disk")

    # --- the native data plane (csrc/dataplane.cpp) ----------------------
    def attach_native_plane(self, plane) -> None:
        """Register every volume the plane can take: from here on their
        needle ops go through it."""
        self.native_plane = plane
        for v in list(self.volumes.values()):
            self._native_add(v)

    def detach_native_plane(self) -> None:
        """Hand every volume back to the Python engine, each reloaded as
        a quiesce reloads it, then forget the plane (the caller stops
        it): no Python append ever lands on a stale end of a `.dat` the
        plane wrote to."""
        plane = self.native_plane
        if plane is None:
            return
        for vid in sorted(plane.vids):
            self.native_detach(vid)
        self.native_plane = None

    def _plane_eligible(self, v: Optional[Volume]) -> bool:
        """The plane speaks version 3 records and 16-byte `.idx` entries
        of a local `.dat`: a tiered or 5-byte volume stays Python's."""
        return (v is not None and not v.tiered and v.version == Version.V3
                and v.offset_size == 4)

    def _native_add(self, v: Volume) -> None:
        if self.native_plane is None or not self._plane_eligible(v):
            return
        # a frame skips the HTTP plane's replica fan-out: TCP writes only
        # for replication 000 (volume_server_tcp_handlers_write.go is
        # local-only too)
        tcp_ok = (self.native_tcp_writes_ok
                  and v.super_block.replica_placement.to_byte() == 0)
        self.native_plane.add_volume(v.id, v.dat_path, v.idx_path,
                                     read_only=v.read_only,
                                     tcp_writable=tcp_ok)

    def _swap_lock(self, vid: int) -> _SwapLock:
        with self._native_hold_lock:
            sl = self._swap_locks.get(vid)
            if sl is None:
                sl = self._swap_locks[vid] = _SwapLock()
            return sl

    def _release_hold(self, vid: int) -> int:
        """One hold fewer; -> how many there were."""
        with self._native_hold_lock:
            n = self._native_holds.get(vid, 0)
            if n <= 1:
                self._native_holds.pop(vid, None)
            else:
                self._native_holds[vid] = n - 1
            return n

    def native_detach(self, vid: int) -> None:
        """Quiesce: take one hold, let the plane go of the volume and
        reload the Python Volume, which replays everything the plane
        appended (``Volume.reload``: the same object, no tier recovery,
        so a pending two-phase tier move survives).  Needle ops use the Python engine until the last hold
        is released (``native_reattach``).  The removal and the reopen
        happen under the volume's lock and the swap lock's exclusive side,
        so no reattach and no fallback op interleaves with them."""
        plane = self.native_plane
        if plane is None:
            return
        with self._native_hold_lock:
            self._native_holds[vid] = self._native_holds.get(vid, 0) + 1
        lock = self.volume_locks.get(vid)
        if lock is None:  # deleted meanwhile: the hold must not leak
            self._release_hold(vid)
            return
        with lock, self._swap_lock(vid).exclusive():
            if not plane.has(vid):
                return
            plane.remove_volume(vid)
            v = self.volumes.get(vid)
            if v is not None:
                v.reload()

    def native_reattach(self, vid: int) -> None:
        """Release one hold; the last one registers the volume again.  A
        call with no hold outstanding does nothing, so it never takes
        another operation's hold."""
        plane = self.native_plane
        if plane is None:
            return
        lock = self.volume_locks.get(vid)
        if lock is None:
            with self._native_hold_lock:
                held = self._native_holds.get(vid, 0)
            if held:
                self._release_hold(vid)
            return
        with lock, self._swap_lock(vid).exclusive():
            with self._native_hold_lock:
                n = self._native_holds.get(vid, 0)
                if n == 0:
                    return
                if n > 1:
                    self._native_holds[vid] = n - 1
                    return
            # the last hold stays counted until the volume is back, so a
            # read that missed on a stale volume settles on the swap lock
            v = self.volumes.get(vid)
            try:
                if v is not None and not plane.has(vid):
                    self._native_add(v)
            finally:
                self._release_hold(vid)

    def native_register(self, vid: int) -> None:
        """Register a volume that can newly go on the plane (mount, copy,
        tier recall, ec_to_volume); nothing while a hold is out."""
        plane = self.native_plane
        lock = self.volume_locks.get(vid)
        if plane is None or plane.has(vid) or lock is None:
            return
        with lock, self._swap_lock(vid).exclusive():
            with self._native_hold_lock:
                if self._native_holds.get(vid, 0):
                    return
            v = self.volumes.get(vid)
            if v is not None and not plane.has(vid):
                self._native_add(v)

    def native_refresh(self, vid: int) -> None:
        """Register again with the volume's flags (read-only); nothing
        while a hold is out: its release picks them up."""
        plane = self.native_plane
        if plane is None or not plane.has(vid):
            return
        with self._native_hold_lock:
            if self._native_holds.get(vid, 0):
                return
        with self.native_quiesced(vid):
            pass

    @contextlib.contextmanager
    def native_quiesced(self, vid: int):
        """Work on a volume's files with the plane off it."""
        self.native_detach(vid)
        try:
            yield
        finally:
            self.native_reattach(vid)

    def _on_plane(self, vid: int):
        """The plane, if this volume's ops go through it: it holds the
        volume, or a quiesce of it is in flight; else None."""
        plane = self.native_plane
        if plane is None or plane.has(vid) or self._native_holds.get(vid):
            return plane
        return plane if self._plane_eligible(self.volumes.get(vid)) \
            else None

    def _native_append(self, plane, vid: int, n: Needle,
                       fsync: bool) -> tuple[int, bool]:
        """The funnel's write: Python serializes the record (name, mime,
        flags, TTL), the plane appends it under its volume lock.  Unlike
        the Python engine it does not skip an unchanged rewrite."""
        v = self.get_volume(vid)
        if not n.append_at_ns:
            n.append_at_ns = time.time_ns()
        blob = n.to_bytes(v.version)
        plane.append(vid, n.id, n.cookie, blob, n.size)
        if fsync:
            self._plane_sync(plane, vid)
        self.note_volume_change(vid)
        return n.size, False

    def _native_delete(self, plane, vid: int, n: Needle, fsync: bool) -> int:
        size = plane.delete(vid, n.id, n.cookie)
        if fsync:
            self._plane_sync(plane, vid)
        self.note_volume_change(vid)
        return size

    def _plane_sync(self, plane, vid: int) -> None:
        """The plane's group sync of an append it took.  A plane that let
        go of the volume since has the append in the files all the same:
        they are fsynced through the Python volume (an fsync covers the
        file, whichever descriptor wrote), never appended again."""
        try:
            plane.sync(vid)
        except OSError as e:
            if not _plane_gone(e):
                raise
            self.get_volume(vid).sync()

    def _native_read(self, plane, vid: int, key: int,
                     cookie: Optional[int]) -> Needle:
        blob, size = plane.read_record(vid, key, cookie)
        return Needle.from_bytes(blob, size, self.get_volume(vid).version)

    def _through_plane(self, plane, vid: int, native, python):
        """``native(plane)`` while the plane holds the volume; in a
        quiesce window ``python()`` on the shared side of the swap lock,
        after a second look (a reattach may have won the race)."""
        if plane.has(vid):
            try:
                return native(plane)
            except OSError as e:
                if not _plane_gone(e):
                    raise
        with self._swap_lock(vid).shared():
            if plane.has(vid):
                try:
                    return native(plane)
                except OSError as e:
                    if not _plane_gone(e):
                        raise
            return python()

    # --- needle ops ----------------------------------------------------------
    def write_needle(self, vid: int, n: Needle,
                     fsync: bool = False) -> tuple[int, bool]:
        """Append a needle, durable on return with ``fsync``; returns
        (size, unchanged).  An fsync write goes through the volume's
        group-commit worker (writeNeedle2) with no lock of the store
        held, so concurrent fsync writers share a batch's fsyncs; on the
        plane, through its group sync."""
        plane = self._on_plane(vid)
        if plane is not None:
            return self._through_plane(
                plane, vid, lambda p: self._native_append(p, vid, n, fsync),
                lambda: self._python_write(vid, n, fsync))
        return self._python_write(vid, n, fsync)

    def _python_write(self, vid: int, n: Needle,
                      fsync: bool) -> tuple[int, bool]:
        _, size, unchanged = self.get_volume(vid).write_needle2(
            n, fsync=fsync)
        # after the write: the epoch also fences a read racing it
        self.needle_cache.invalidate(vid, n.id, "write")
        self.note_volume_change(vid)
        return size, unchanged

    def delete_needle(self, vid: int, n: Needle, fsync: bool = False) -> int:
        plane = self._on_plane(vid)
        if plane is not None:
            return self._through_plane(
                plane, vid, lambda p: self._native_delete(p, vid, n, fsync),
                lambda: self._python_delete(vid, n, fsync))
        return self._python_delete(vid, n, fsync)

    def _python_delete(self, vid: int, n: Needle, fsync: bool) -> int:
        size = self.get_volume(vid).delete_needle2(n, fsync=fsync)
        self.needle_cache.invalidate(vid, n.id, "delete")
        self.note_volume_change(vid)
        return size

    def read_needle(self, vid: int, key: int,
                    cookie: Optional[int] = None) -> Needle:
        """A live volume's needle: through the plane while it holds the
        volume, else through the needle cache; a tiered volume's is
        always read from its remote object."""
        plane = self.native_plane
        if plane is not None:
            return self._plane_read(plane, vid, key, cookie)
        cache = self.needle_cache
        if not cache.enabled or self.get_volume(vid).tiered:
            return self.get_volume(vid).read_needle(key, cookie)
        n = cache.get(vid, key)
        if n is not None:
            # the disk path's cookie check: a hit reads as a pread would
            if cookie is not None and n.cookie != cookie:
                raise CookieMismatchError(f"cookie mismatch for {key}")
            return n
        epoch = cache.epoch(vid)
        n = self.get_volume(vid).read_needle(key, cookie)
        cache.offer(vid, key, n, epoch=epoch)
        return n

    def _plane_read(self, plane, vid: int, key: int,
                    cookie: Optional[int]) -> Needle:
        """Two tries on the plane (a DP_NO_VOLUME may be a reattach in
        flight), then the Python volume.  A miss there may come from a
        volume a quiesce swapped under the read (its map frozen at the
        attach, its handle closed): with a hold out or the plane back, it
        settles on the swap lock's shared side and asks both again."""
        for _ in range(2):
            if not plane.has(vid):
                break
            try:
                return self._native_read(plane, vid, key, cookie)
            except OSError as e:
                if not _plane_gone(e):
                    raise
        try:
            return self.get_volume(vid).read_needle(key, cookie)
        except (NotFoundError, DeletedError, CookieMismatchError,
                ValueError, OSError):
            if not self._native_holds.get(vid) and not plane.has(vid):
                raise  # a volume the plane never takes: a plain miss
            return self._through_plane(
                plane, vid,
                lambda p: self._native_read(p, vid, key, cookie),
                lambda: self.get_volume(vid).read_needle(key, cookie))

    # --- vacuum (volume_grpc_vacuum.go) -------------------------------------
    def vacuum_compact(self, vid: int) -> None:
        """Compact under the volume's lock, so an EC encode never reads
        half-written files.  The plane stays off the volume from here to
        the commit or the cleanup: writes meanwhile go to the Python
        engine, so the commit's makeup replay sees them."""
        self.native_detach(vid)
        try:
            with self.volume_locks[vid]:
                self.get_volume(vid).compact()
        except BaseException:
            # a failed compact gets no commit or cleanup from the master
            self.native_reattach(vid)
            raise

    def vacuum_commit(self, vid: int) -> None:
        """Swap the compacted files in under the volume's lock; the next
        heartbeat carries the new size, revision and counters."""
        with self.volume_locks[vid]:
            self.get_volume(vid).commit_compact()
        # the compaction dropped needles the per-key hooks never saw
        self.needle_cache.invalidate_volume(vid, "vacuum")
        self.note_volume_change(vid)
        self.native_reattach(vid)

    def vacuum_cleanup(self, vid: int) -> None:
        """Drop a compaction's files without committing them."""
        self.get_volume(vid).cleanup_compact()
        self.native_reattach(vid)

    def open_copied_volume(self, collection: str, vid: int) -> Volume:
        """/admin/volume_copy: mount the `.dat`/`.idx` it downloaded into
        the first directory, through the crash check every open runs."""
        v = self._open_volume(self._volume(self.directories[0],
                                           collection, vid))
        self.native_register(vid)
        return v

    # --- volume.fsck and volume.configure.replication backends ------------
    def check_volume(self, vid: int) -> dict:
        """/admin/volume_check: every live needle of the volume parsed with
        its CRC, with no lock (``Volume.check_needles``); the scanned
        volume's counts go out with the next heartbeat."""
        with self.native_quiesced(vid):  # the map must see every needle
            result = self.get_volume(vid).check_needles()
        self.note_volume_change(vid)
        return result

    def configure_replication(self, vid: int,
                              replication: str) -> ReplicaPlacement:
        """/admin/configure_replication: the superblock's placement
        rewritten under the volume's lock (no EC encode or compact reads
        it meanwhile), then queued for the heartbeat."""
        rp = ReplicaPlacement.parse(replication)
        # the plane registers again with the new placement's TCP gate
        with self.native_quiesced(vid), self.volume_locks[vid]:
            self.get_volume(vid).configure_replication(rp)
        self.note_volume_change(vid)
        return rp

    # --- EC (store_ec.go + volume_grpc_erasure_coding.go backends) --------
    def ec_generate(self, vid: int, engine: Optional[str] = None) -> None:
        """VolumeEcShardsGenerate: mark the volume read-only, then .dat ->
        .ec00..13 + .eci through the streaming pipeline of ``engine``
        (``streaming_encoder``), and .idx -> .ecx.
        The plane is off the volume meanwhile; it takes it back read-only
        and serves its reads while the shards spread.  A volume with
        5-byte offsets is refused before anything is written."""
        if self.get_volume(vid).offset_size != 4:
            raise ValueError(
                f"volume {vid} uses 5-byte offsets; EC encoding "
                "supports 4-byte-offset volumes only")
        with self.native_quiesced(vid):
            self._ec_generate(vid, engine)

    def _ec_generate(self, vid: int, engine: Optional[str] = None) -> None:
        v = self.get_volume(vid)
        with self.volume_locks[vid]:
            v.read_only = True
            self.streaming_encoder(engine).encode_file(
                v.file_prefix + ".dat", v.file_prefix)
            ec_encoder.write_sorted_file_from_idx(v.file_prefix)

    def ec_rebuild(self, vid: int, collection: str = "",
                   engine: Optional[str] = None) -> list[int]:
        """VolumeEcShardsRebuild: regenerate missing local shards."""
        return self.streaming_encoder(engine).rebuild_files(
            self._ec_base(vid, collection))

    def _ec_base(self, vid: int, collection: str = "") -> str:
        ev = self.ec_volumes.get(vid)
        if ev is not None:
            return ev.base_file_name
        for d in self.directories:
            base = volume_file_prefix(d, collection, vid)
            if (glob.glob(base + ".ec[0-9][0-9]")
                    or os.path.exists(base + ".ecx")
                    or os.path.exists(base + ".dat")):
                return base
        return volume_file_prefix(self.directories[0], collection, vid)

    @contextlib.contextmanager
    def ec_volume_held(self, vid: int):
        """The EC volume mounted as ``vid`` (None if there is none), kept
        open until the block ends even if a swap unmounts it meanwhile."""
        with self._ec_lock:
            ev = self.ec_volumes.get(vid)
            if ev is not None:
                self._ec_holders[ev] = self._ec_holders.get(ev, 0) + 1
        try:
            yield ev
        finally:
            if ev is not None:
                with self._ec_lock:
                    left = self._ec_holders.pop(ev) - 1
                    if left:
                        self._ec_holders[ev] = left
                    elif ev in self._ec_unmounted:
                        self._ec_unmounted.discard(ev)
                        ev.close()

    def _close_ec_volume(self, ev: EcVolume) -> None:
        """Under _ec_lock: close now, or when the last reader leaves."""
        if ev in self._ec_holders:
            self._ec_unmounted.add(ev)
        else:
            ev.close()

    def ec_swap(self):
        """Context in which mounts, unmounts and file renames of EC
        volumes happen as one step for readers."""
        return self._ec_lock

    def ec_mount(self, vid: int, collection: str = "") -> None:
        with self.ec_swap():
            self.ec_unmount(vid)
            base = self._ec_base(vid, collection)
            self._open_ec_volume(os.path.dirname(base), collection, vid)

    def ec_unmount(self, vid: int) -> None:
        with self.ec_swap():
            ev = self.ec_volumes.pop(vid, None)
            self.ec_collections.pop(vid, None)
            if ev is not None:
                self._close_ec_volume(ev)
                self.note_ec_change(vid, gone=True)

    def ec_delete_shards(self, vid: int, shard_ids: list[int],
                         collection: str = "") -> None:
        with self.ec_swap():
            base = self._ec_base(vid, collection)
            was_mounted = vid in self.ec_volumes
            self.ec_unmount(vid)
            for sid in shard_ids:
                p = base + to_ext(sid)
                if os.path.exists(p):
                    os.remove(p)
            if not glob.glob(base + ".ec[0-9][0-9]"):
                # last shard gone: the index, journal, crc sidecar and any
                # quarantined .bad evidence go too
                for path in [base + ext for ext in (".ecx", ".ecj", ".eci")] \
                        + glob.glob(base + ".ec[0-9][0-9].bad"):
                    if os.path.exists(path):
                        os.remove(path)
            elif was_mounted:
                self.ec_mount(vid, collection)

    def ec_shard_read(self, vid: int, shard_id: int, offset: int,
                      length: int) -> bytes:
        with self.ec_volume_held(vid) as ev:
            if ev is None or shard_id not in ev.shards:
                raise NeedleNotFoundError(f"shard {vid}.{shard_id} not here")
            return ev.shards[shard_id].read_at(length, offset)

    def read_ec_needle(self, vid: int, key: int,
                       fetch_remote: Optional[
                           Callable[[int, int, int, int], bytes]] = None,
                       ) -> tuple[bytes, int]:
        """ReadEcShardNeedle (store_ec.go:125-163): each interval from its
        local shard, verified against the `.eci`, else from
        ``fetch_remote(vid, shard, offset, size)``, else reconstructed
        from the local survivors on the card.  Returns (record, size)."""
        rs = self.rs()
        with self.ec_volume_held(vid) as ev:
            if ev is None:
                raise KeyError(f"ec volume {vid} not found")
            _, size, intervals = ev.locate_ec_shard_needle(key)
            if size_is_deleted(size):
                raise NeedleNotFoundError(f"needle {key} deleted")
            return b"".join(ev.read_interval(iv, rs, fetch_remote)
                            for iv in intervals), size

    def ec_delete_needle(self, vid: int, key: int) -> None:
        with self.ec_volume_held(vid) as ev:
            if ev is None:
                raise KeyError(f"ec volume {vid} not found")
            ev.delete_needle(key)

    def ec_to_volume(self, vid: int, collection: str = "") -> None:
        """VolumeEcShardsToVolume (volume_grpc_erasure_coding.go:382-413):
        `.ec00`..`.ec09` + `.ecx`/`.ecj` back into a `.dat` + `.idx`, which
        is then mounted in place of the EC volume."""
        base = self._ec_base(vid, collection)
        self.unmount_volume(vid)  # a still-mounted original is rewritten
        ec_encoder.write_dat_file(base, ec_encoder.find_dat_file_size(base))
        ec_encoder.write_idx_file_from_ec_index(base)
        self.ec_unmount(vid)
        self._open_volume(self._volume(os.path.dirname(base), collection,
                                       vid))
        self.native_register(vid)

    def close(self) -> None:
        for v in self.volumes.values():
            v.close()
        self.volumes.clear()
        with self.ec_swap():
            for ev in self.ec_volumes.values():
                self._close_ec_volume(ev)
            self.ec_volumes.clear()
