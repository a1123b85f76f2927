"""Volume growth: choose servers honoring replica placement, allocate.

The port's copy of seaweedfs_tpu/master/volume_growth.py
(weed/topology/volume_growth.go:123-219, findEmptySlotsForOneVolume):
pick a main server, then spread the remaining copies across other DCs /
other racks / the same rack per the xyz digits.  Shuffles draw from
``Topology.rng``.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..storage.super_block import ReplicaPlacement
from ..storage.ttl import TTL
from .topology import DataNode, Topology, VolumeInfo


def find_empty_slots(topo: Topology, rp: ReplicaPlacement,
                     preferred_dc: str = "") -> list[DataNode]:
    """Returns rp.copy_count nodes honoring the placement, or raises."""
    with topo.lock:
        candidates = [n for n in topo.all_nodes() if n.free_space() > 0]
        if preferred_dc:
            main_pool = [n for n in candidates
                         if n.dc and n.dc.name == preferred_dc]
        else:
            main_pool = candidates
        if not main_pool:
            raise LookupError("no free volume slots")
        topo.rng.shuffle(main_pool)

        for main in main_pool:
            picked = _pick_replicas(topo, main, candidates, rp)
            if picked is not None:
                return picked
        raise LookupError(
            f"cannot satisfy replica placement {rp} with available nodes")


def _pick_replicas(topo: Topology, main: DataNode,
                   candidates: list[DataNode],
                   rp: ReplicaPlacement) -> list[DataNode] | None:
    picked = [main]
    used = {main.url}

    def take(pool: list[DataNode], count: int) -> bool:
        pool = [n for n in pool if n.url not in used and n.free_space() > 0]
        if len(pool) < count:
            return False
        topo.rng.shuffle(pool)
        for n in pool[:count]:
            picked.append(n)
            used.add(n.url)
        return True

    # the three pools the xyz digits draw from, relative to main
    same_rack = list(main.rack.nodes.values())
    diff_rack = [n for r in main.dc.racks.values() if r is not main.rack
                 for n in r.nodes.values()]
    diff_dc = [n for n in candidates if n.dc is not main.dc]
    if rp.same_rack and not take(same_rack, rp.same_rack):
        return None
    if rp.diff_rack and not take(diff_rack, rp.diff_rack):
        return None
    if rp.diff_dc and not take(diff_dc, rp.diff_dc):
        return None
    return picked


def grow_volume(topo: Topology, collection: str, rp: ReplicaPlacement,
                ttl: TTL, allocate: Callable[[DataNode, int, str, str, str],
                                             None],
                preferred_dc: str = "", count: int = 1,
                commit_ids: Optional[Callable[[], None]] = None
                ) -> list[int]:
    """VolumeGrowth.grow (volume_growth.go:221): allocate ``count`` new
    volumes on chosen servers through ``allocate``, then register them
    at once; heartbeats confirm.

    ``commit_ids`` quorum-replicates the reserved max_volume_id before
    any allocate call runs (the reference commits MaxVolumeId through the
    raft log first, topology.go NextVolumeId); when the commit cannot
    reach a quorum the grow fails with no volume created, so a new
    leader can never issue the same id to other servers."""
    grown = []
    for _ in range(count):
        nodes = find_empty_slots(topo, rp, preferred_dc)
        vid = topo.next_volume_id()
        if commit_ids is not None:
            commit_ids()
        for node in nodes:
            allocate(node, vid, collection, str(rp), str(ttl))
        info = VolumeInfo(id=vid, collection=collection,
                          replica_placement=rp.to_byte(), ttl=ttl.to_u32())
        layout = topo.get_layout(collection, rp, ttl)
        with topo.lock:
            for node in nodes:
                node.volumes[vid] = info
                layout.register(info, node)
                topo._emit_location(vid, node, "add")
        grown.append(vid)
    return grown
