"""`.vif` sidecar: a volume's version and the remote file it is tiered to.

The port's copy of seaweedfs_tpu/storage/volume_info.py (weed/storage/
volume_info/volume_info.go:84, MaybeLoadVolumeInfo / SaveVolumeInfo over
volume_server_pb.VolumeInfo): JSON of the proto's fields, the version and
a list of remote files {backend_type, backend_id, key, file_size,
modified_time}.  The files are byte-equal to the reference's.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class RemoteFileInfo:
    backend_type: str = ""
    backend_id: str = ""
    key: str = ""
    file_size: int = 0
    modified_time: int = 0

    def to_dict(self) -> dict:
        return {"backend_type": self.backend_type,
                "backend_id": self.backend_id, "key": self.key,
                "file_size": self.file_size,
                "modified_time": self.modified_time}

    @classmethod
    def from_dict(cls, d: dict) -> "RemoteFileInfo":
        return cls(d.get("backend_type", ""), d.get("backend_id", ""),
                   d.get("key", ""), int(d.get("file_size", 0)),
                   int(d.get("modified_time", 0)))


@dataclass
class VolumeInfo:
    version: int = 3
    files: list[RemoteFileInfo] = field(default_factory=list)

    @property
    def remote_file(self) -> Optional[RemoteFileInfo]:
        return self.files[0] if self.files else None


def vif_path(file_prefix: str) -> str:
    return file_prefix + ".vif"


def maybe_load_volume_info(file_prefix: str) -> Optional[VolumeInfo]:
    """The `.vif`, or None when there is none or it does not parse."""
    p = vif_path(file_prefix)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return VolumeInfo(
        version=int(d.get("version", 3)),
        files=[RemoteFileInfo.from_dict(x) for x in d.get("files", [])])


def save_volume_info(file_prefix: str, info: VolumeInfo) -> None:
    """Write the `.vif` through a temporary file renamed over it."""
    tmp = vif_path(file_prefix) + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": info.version,
                   "files": [x.to_dict() for x in info.files]}, f)
    os.replace(tmp, vif_path(file_prefix))
