"""Cluster topology: Topology -> DataCenter -> Rack -> DataNode, volume
layouts, placement and the EC shard registry.

The port's copy of seaweedfs_tpu/master/topology.py (weed/topology/
topology.go, node.go, data_center.go, rack.go, data_node.go,
volume_layout.go, topology_ec.go): plain Python objects under one
topology lock.  Random choices (a writable volume, growth placement, the
node an assign names) draw from ``Topology.rng``, a ``random.Random`` of
its own that a test may seed; the reference draws from the global
``random``.

Every volume and EC volume a node gains or loses is a location event
(``location_seq``, a bounded history): ``/cluster/watch`` long-polls
``watch_locations`` and the push-updated client (client/wdclient.py)
applies the events to its map, or a ``location_snapshot`` when it is new
or fell behind the history (master_grpc_server.go KeepConnected).
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..ec.layout import DATA_SHARDS_COUNT
from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import TTL


@dataclass
class VolumeInfo:
    """Master-side view of one volume replica (master heartbeat payload)."""
    id: int
    size: int = 0
    collection: str = ""
    file_count: int = 0
    delete_count: int = 0
    deleted_byte_count: int = 0
    read_only: bool = False
    replica_placement: int = 0
    version: int = 3
    ttl: int = 0
    compact_revision: int = 0
    modified_at_second: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "VolumeInfo":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})


class ShardBits:
    """u32 bitmask of which of the (up to 14) EC shards a node holds
    (ec_volume_info.go:65-117); heartbeats carry it as ``ec_index_bits``."""

    def __init__(self, bits: int = 0):
        self.bits = bits

    @classmethod
    def of(cls, shard_ids) -> "ShardBits":
        bits = 0
        for sid in shard_ids:
            bits |= 1 << sid
        return cls(bits)

    def add(self, shard_id: int) -> "ShardBits":
        return ShardBits(self.bits | (1 << shard_id))

    def remove(self, shard_id: int) -> "ShardBits":
        return ShardBits(self.bits & ~(1 << shard_id))

    def has(self, shard_id: int) -> bool:
        return bool(self.bits & (1 << shard_id))

    def shard_ids(self) -> list[int]:
        return [i for i in range(32) if self.has(i)]

    def count(self) -> int:
        return bin(self.bits).count("1")

    def plus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self.bits | other.bits)

    def minus(self, other: "ShardBits") -> "ShardBits":
        return ShardBits(self.bits & ~other.bits)


@dataclass
class EcVolumeInfo:
    """One server's shards for one EC volume (ec_volume_info.go:9-63)."""
    volume_id: int
    collection: str = ""
    shard_bits: ShardBits = field(default_factory=ShardBits)


class DataNode:
    """One volume server (topology/data_node.go)."""

    def __init__(self, ip: str, port: int, public_url: str = "",
                 max_volume_count: int = 8, rack: "Rack" = None):
        self.ip = ip
        self.port = port
        self.public_url = public_url or f"{ip}:{port}"
        self.max_volume_count = max_volume_count
        self.rack = rack
        self.volumes: dict[int, VolumeInfo] = {}
        self.ec_shards: dict[int, EcVolumeInfo] = {}
        self.last_seen = time.time()

    @property
    def url(self) -> str:
        return f"{self.ip}:{self.port}"

    @property
    def dc(self) -> "DataCenter":
        return self.rack.dc if self.rack else None

    def volume_count(self) -> int:
        return len(self.volumes)

    def ec_shard_count(self) -> int:
        return sum(e.shard_bits.count() for e in self.ec_shards.values())

    def free_space(self) -> int:
        # EC shards count fractionally against volume slots, like the
        # reference's erasure_coding.DataShardsCount accounting
        used = len(self.volumes) + (self.ec_shard_count() + DATA_SHARDS_COUNT - 1
                                    ) // DATA_SHARDS_COUNT
        return self.max_volume_count - used

    def to_map(self) -> dict:
        return {
            "Url": self.url,
            "PublicUrl": self.public_url,
            "Volumes": len(self.volumes),
            "EcShards": self.ec_shard_count(),
            "Max": self.max_volume_count,
            "Free": self.free_space(),
            "VolumeIds": sorted(self.volumes),
            "VolumeInfos": [{
                "id": v.id, "collection": v.collection,
                "size": v.size, "file_count": v.file_count,
                "delete_count": v.delete_count,
                "modified_at": v.modified_at_second,
                "read_only": v.read_only,
            } for _, v in sorted(self.volumes.items())],
        }


class Rack:
    def __init__(self, name: str, dc: "DataCenter"):
        self.name = name
        self.dc = dc
        self.nodes: dict[str, DataNode] = {}

    def get_or_create_node(self, ip: str, port: int, public_url: str,
                           max_volume_count: int) -> DataNode:
        key = f"{ip}:{port}"
        node = self.nodes.get(key)
        if node is None:
            node = DataNode(ip, port, public_url, max_volume_count, rack=self)
            self.nodes[key] = node
        node.max_volume_count = max_volume_count
        node.last_seen = time.time()
        return node


class DataCenter:
    def __init__(self, name: str):
        self.name = name
        self.racks: dict[str, Rack] = {}

    def get_or_create_rack(self, name: str) -> Rack:
        if name not in self.racks:
            self.racks[name] = Rack(name, self)
        return self.racks[name]


class VolumeLayout:
    """Writable/readonly volume tracking for one (collection, rp, ttl)
    (topology/volume_layout.go)."""

    def __init__(self, rp: ReplicaPlacement, ttl: TTL, volume_size_limit: int,
                 rng: random.Random):
        self.rp = rp
        self.ttl = ttl
        self.volume_size_limit = volume_size_limit
        self.rng = rng
        self.vid_to_nodes: dict[int, list[DataNode]] = {}
        self.writables: set[int] = set()
        self.readonly: set[int] = set()
        self.oversized: set[int] = set()

    def register(self, v: VolumeInfo, node: DataNode) -> None:
        nodes = self.vid_to_nodes.setdefault(v.id, [])
        if node not in nodes:
            nodes.append(node)
        # membership in oversized/readonly tracks the CURRENT heartbeat:
        # a vacuumed volume that shrank below the limit becomes writable
        # again instead of being stuck forever
        if v.size >= self.volume_size_limit:
            self.oversized.add(v.id)
            self.writables.discard(v.id)
        elif v.read_only:
            self.oversized.discard(v.id)
            self.readonly.add(v.id)
            self.writables.discard(v.id)
        else:
            self.oversized.discard(v.id)
            self.readonly.discard(v.id)
            self.ensure_correct_writables(v.id)

    def unregister(self, vid: int, node: DataNode) -> None:
        nodes = self.vid_to_nodes.get(vid, [])
        if node in nodes:
            nodes.remove(node)
        if not nodes:
            self.vid_to_nodes.pop(vid, None)
            self.writables.discard(vid)
        else:
            self.ensure_correct_writables(vid)

    def ensure_correct_writables(self, vid: int) -> None:
        """volume_layout.go:217: writable iff enough replicas and none
        oversized/readonly."""
        nodes = self.vid_to_nodes.get(vid, [])
        if (len(nodes) >= self.rp.copy_count and vid not in self.oversized
                and vid not in self.readonly):
            self.writables.add(vid)
        else:
            self.writables.discard(vid)

    def set_readonly(self, vid: int, readonly: bool) -> None:
        """Take a volume out of the writable set (a vacuum in progress),
        or put it back where its replicas allow."""
        if readonly:
            self.readonly.add(vid)
            self.writables.discard(vid)
        else:
            self.readonly.discard(vid)
            self.ensure_correct_writables(vid)

    def pick_for_write(self) -> tuple[int, list[DataNode]]:
        """volume_layout.go:275: random writable volume."""
        if not self.writables:
            raise LookupError("no writable volumes")
        vid = self.rng.choice(sorted(self.writables))
        return vid, self.vid_to_nodes[vid]


def layout_key(collection: str, rp: ReplicaPlacement, ttl: TTL) -> tuple:
    return (collection, str(rp), str(ttl))


class Topology:
    """topology/topology.go: the master's world view."""

    def __init__(self, volume_size_limit: int = 30 * 1000 * 1000 * 1000,
                 pulse_seconds: float = 5.0):
        self.lock = threading.RLock()
        self.volume_size_limit = volume_size_limit
        self.pulse_seconds = pulse_seconds
        self.rng = random.Random()
        self.data_centers: dict[str, DataCenter] = {}
        self.layouts: dict[tuple, VolumeLayout] = {}
        self.max_volume_id = 0
        # EC registry: vid -> {shard_id -> [DataNode]} (topology_ec.go:69)
        self.ec_shard_locations: dict[int, dict[int, list[DataNode]]] = {}
        self.ec_collections: dict[int, str] = {}
        # the location broadcast: long-pollers wait on _watch_cond for
        # events past their cursor, kept in a bounded history
        self._watch_cond = threading.Condition(self.lock)
        self._loc_events: deque[dict] = deque(maxlen=10_000)
        self.location_seq = 0

    # --- registration -----------------------------------------------------
    def get_or_create_dc(self, name: str) -> DataCenter:
        if name not in self.data_centers:
            self.data_centers[name] = DataCenter(name)
        return self.data_centers[name]

    def register_node(self, ip: str, port: int, public_url: str = "",
                      dc: str = "DefaultDataCenter", rack: str = "DefaultRack",
                      max_volume_count: int = 8) -> DataNode:
        with self.lock:
            return (self.get_or_create_dc(dc)
                    .get_or_create_rack(rack)
                    .get_or_create_node(ip, port, public_url, max_volume_count))

    def find_node(self, ip: str, port: int) -> Optional[DataNode]:
        """Known node lookup for delta heartbeats: a delta from an unknown
        node means THIS master is missing state (a restart) and must ask
        for a full resync instead of guessing."""
        with self.lock:
            for node in self.all_nodes():
                if node.ip == ip and node.port == port:
                    return node
        return None

    def apply_volume_deltas(self, node: DataNode,
                            new_volumes: list[VolumeInfo],
                            deleted_vids: list[int]) -> None:
        """Incremental heartbeat ingest (master_grpc_server.go delta
        branch): new/changed volumes register, deleted ones unregister."""
        with self.lock:
            for vid in deleted_vids:
                old = node.volumes.pop(vid, None)
                if old is not None:
                    self._layout_for_volume(old).unregister(vid, node)
                    self._emit_location(vid, node, "del")
            for v in new_volumes:
                self._register_volume(v, node)
            node.last_seen = time.time()

    def apply_ec_deltas(self, node: DataNode,
                        new_ec: list[EcVolumeInfo],
                        deleted_vids: list[int]) -> None:
        with self.lock:
            for vid in deleted_vids:
                old = node.ec_shards.pop(vid, None)
                if old is not None:
                    self._unregister_ec(old, node)
            for e in new_ec:
                self._replace_ec(e, node)
            node.last_seen = time.time()

    def get_layout(self, collection: str, rp: ReplicaPlacement,
                   ttl: TTL) -> VolumeLayout:
        key = layout_key(collection, rp, ttl)
        if key not in self.layouts:
            self.layouts[key] = VolumeLayout(rp, ttl, self.volume_size_limit,
                                             self.rng)
        return self.layouts[key]

    def sync_node_volumes(self, node: DataNode,
                          volumes: list[VolumeInfo]) -> None:
        """Full heartbeat sync (master_grpc_server.go:21-180 semantics):
        register new, update changed, unregister vanished."""
        with self.lock:
            new_ids = {v.id for v in volumes}
            for vid in list(node.volumes):
                if vid not in new_ids:
                    old = node.volumes.pop(vid)
                    self._layout_for_volume(old).unregister(vid, node)
                    self._emit_location(vid, node, "del")
            for v in volumes:
                self._register_volume(v, node)
            node.last_seen = time.time()

    def _register_volume(self, v: VolumeInfo, node: DataNode) -> None:
        if v.id not in node.volumes:
            self._emit_location(v.id, node, "add")
        node.volumes[v.id] = v
        self.max_volume_id = max(self.max_volume_id, v.id)
        self._layout_for_volume(v).register(v, node)

    def _layout_for_volume(self, v: VolumeInfo) -> VolumeLayout:
        rp = ReplicaPlacement.from_byte(v.replica_placement)
        return self.get_layout(v.collection, rp, TTL.from_u32(v.ttl))

    def sync_node_ec_shards(self, node: DataNode,
                            ec_infos: list[EcVolumeInfo]) -> None:
        """topology_ec.go:16-66: full EC shard sync for one node."""
        with self.lock:
            new_ids = {e.volume_id for e in ec_infos}
            for vid in list(node.ec_shards):
                if vid not in new_ids:
                    self._unregister_ec(node.ec_shards.pop(vid), node)
            for e in ec_infos:
                self._replace_ec(e, node)

    def _replace_ec(self, e: EcVolumeInfo, node: DataNode) -> None:
        old = node.ec_shards.get(e.volume_id)
        if old is not None:
            if old.shard_bits.bits == e.shard_bits.bits:
                return  # unchanged: no churn
            self._unregister_ec(old, node)
        node.ec_shards[e.volume_id] = e
        self._register_ec(e, node)

    def _register_ec(self, e: EcVolumeInfo, node: DataNode) -> None:
        locs = self.ec_shard_locations.setdefault(e.volume_id, {})
        held_before = any(node in ns for ns in locs.values())
        self.ec_collections[e.volume_id] = e.collection
        for sid in e.shard_bits.shard_ids():
            nodes = locs.setdefault(sid, [])
            if node not in nodes:
                nodes.append(node)
        if not held_before and e.shard_bits.count():
            self._emit_location(e.volume_id, node, "add", kind="ec")

    def _unregister_ec(self, e: EcVolumeInfo, node: DataNode) -> None:
        locs = self.ec_shard_locations.get(e.volume_id, {})
        for sid in e.shard_bits.shard_ids():
            if node in locs.get(sid, []):
                locs[sid].remove(node)
        if not any(locs.values()):
            self.ec_shard_locations.pop(e.volume_id, None)
            self.ec_collections.pop(e.volume_id, None)
        if not any(node in ns for ns in locs.values()):
            self._emit_location(e.volume_id, node, "del", kind="ec")

    def unregister_node(self, node: DataNode) -> None:
        with self.lock:
            self.sync_node_volumes(node, [])
            self.sync_node_ec_shards(node, [])
            if node.rack:
                node.rack.nodes.pop(node.url, None)

    # --- the location broadcast (wdclient's KeepConnected push) -----------
    def _emit_location(self, vid: int, node: DataNode, op: str,
                       kind: str = "volume") -> None:  # holds: lock
        self.location_seq += 1
        self._loc_events.append({
            "seq": self.location_seq, "op": op, "kind": kind, "vid": vid,
            "url": node.url, "public_url": node.public_url or node.url,
            "data_center": node.rack.dc.name if node.rack else ""})
        self._watch_cond.notify_all()

    @staticmethod
    def _location(node: DataNode) -> dict:
        return {"url": node.url, "public_url": node.public_url or node.url,
                "data_center": node.rack.dc.name if node.rack else ""}

    def location_snapshot(self) -> dict:
        """Every vid's locations, plain and EC (vid_map.go's contents),
        with the seq they stand at."""
        with self.lock:
            vols: dict[str, list[dict]] = {}
            for node in self.all_nodes():
                for vid in node.volumes:
                    vols.setdefault(str(vid), []).append(
                        self._location(node))
            ecs: dict[str, list[dict]] = {}
            for vid, shards in self.ec_shard_locations.items():
                seen: dict[str, dict] = {}
                for nodes in shards.values():
                    for node in nodes:
                        seen[node.url] = self._location(node)
                ecs[str(vid)] = list(seen.values())
            return {"volumes": vols, "ec_volumes": ecs,
                    "seq": self.location_seq}

    def watch_locations(self, since_seq: int, timeout: float = 14.0) -> dict:
        """Long-poll: the events after ``since_seq``, ``{"events": []}``
        when none came within ``timeout``, or a snapshot for a new client
        (cursor 0 on a cluster with locations), a cursor that fell off
        the history, or one ahead of this master (a restart reset the
        seq)."""
        deadline = time.time() + timeout
        with self._watch_cond:
            if (since_seq == 0 and self.location_seq > 0) \
                    or since_seq + 1 < self._oldest_seq() \
                    or since_seq > self.location_seq:
                return self.location_snapshot()
            while self.location_seq <= since_seq:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return {"events": [], "seq": self.location_seq}
                self._watch_cond.wait(remaining)
            # events evicted while waiting are never skipped silently
            if since_seq + 1 < self._oldest_seq():
                return self.location_snapshot()
            return {"events": [e for e in self._loc_events
                               if e["seq"] > since_seq],
                    "seq": self.location_seq}

    def _oldest_seq(self) -> int:  # holds: lock
        return self._loc_events[0]["seq"] if self._loc_events else \
            self.location_seq + 1

    # --- lookup -----------------------------------------------------------
    def lookup(self, vid: int, collection: str = "") -> list[DataNode]:
        with self.lock:
            for key, layout in self.layouts.items():
                if collection and key[0] != collection:
                    continue
                if vid in layout.vid_to_nodes:
                    return list(layout.vid_to_nodes[vid])
            # EC volumes resolve to all shard holders
            locs = self.ec_shard_locations.get(vid)
            if locs:
                seen, out = set(), []
                for nodes in locs.values():
                    for n in nodes:
                        if n.url not in seen:
                            seen.add(n.url)
                            out.append(n)
                return out
            return []

    def lookup_ec_shards(self, vid: int) -> Optional[dict[int, list[DataNode]]]:
        with self.lock:
            locs = self.ec_shard_locations.get(vid)
            return {k: list(v) for k, v in locs.items()} if locs else None

    # --- node iteration ---------------------------------------------------
    def all_nodes(self) -> list[DataNode]:
        out = []
        for dc in self.data_centers.values():
            for rack in dc.racks.values():
                out.extend(rack.nodes.values())
        return out

    def dead_nodes(self, timeout_factor: float = 10.0) -> list[DataNode]:
        """Nodes silent for ``timeout_factor`` pulses.  The reference
        unregisters on gRPC stream break, not a timer; this poll must
        tolerate heartbeat threads starved by load, so the cutoff errs
        long."""
        cutoff = time.time() - self.pulse_seconds * timeout_factor
        return [n for n in self.all_nodes() if n.last_seen < cutoff]

    def next_volume_id(self) -> int:
        with self.lock:
            self.max_volume_id += 1
            return self.max_volume_id

    def to_map(self) -> dict:
        with self.lock:
            return {
                "Max": sum(n.max_volume_count for n in self.all_nodes()),
                "Free": sum(n.free_space() for n in self.all_nodes()),
                "DataCenters": [
                    {
                        "Id": dc.name,
                        "Racks": [
                            {
                                "Id": rack.name,
                                "DataNodes": [n.to_map() for n in rack.nodes.values()],
                            }
                            for rack in dc.racks.values()
                        ],
                    }
                    for dc in self.data_centers.values()
                ],
                "Layouts": [
                    {
                        "collection": key[0],
                        "replication": key[1],
                        "ttl": key[2],
                        "writables": sorted(layout.writables),
                        "volumes": sorted(layout.vid_to_nodes),
                    }
                    for key, layout in self.layouts.items()
                ],
                "EcVolumes": {
                    str(vid): {str(sid): [n.url for n in nodes]
                               for sid, nodes in locs.items()}
                    for vid, locs in self.ec_shard_locations.items()
                },
                "EcCollections": {
                    str(vid): c for vid, c in self.ec_collections.items()
                },
            }
