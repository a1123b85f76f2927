"""ShardBits: the u32 mask of the EC shards a server holds, as heartbeats
carry it in ``ec_index_bits`` (ec_volume_info.go:65-117).  The part of
seaweedfs_tpu/master/topology.py's ShardBits that a volume server uses."""

from __future__ import annotations


class ShardBits:
    def __init__(self, bits: int = 0):
        self.bits = bits

    def add(self, shard_id: int) -> "ShardBits":
        return ShardBits(self.bits | (1 << shard_id))

    @classmethod
    def of(cls, shard_ids) -> "ShardBits":
        bits = cls()
        for sid in shard_ids:
            bits = bits.add(sid)
        return bits
