"""security.toml -> guards.

The port's copy of seaweedfs_tpu/security/config.py (the reference's
scaffold/security.toml, read by every server command):

    [jwt.signing]          key, expires_after_seconds   (volume writes)
    [jwt.signing.read]     key, expires_after_seconds   (volume reads)
    [guard]                white_list = ["ip", "cidr"]
    [tls]                  ca, cert, key, verify_client (tls.py)

Not ported: ``filer_guard`` and ``[jwt.filer_signing]`` (they wait for
the filer).
"""

from __future__ import annotations

from ..utils.config import Configuration, load_configuration
from .guard import Guard


def load_security_configuration(search_dirs=None) -> Configuration:
    return load_configuration("security", search_dirs=search_dirs)


def volume_guard(conf: Configuration) -> Guard:
    return Guard(
        white_list=conf.get("guard.white_list", []) or [],
        signing_key=conf.get_string("jwt.signing.key"),
        expires_after_sec=conf.get_int("jwt.signing.expires_after_seconds", 10),
        read_signing_key=conf.get_string("jwt.signing.read.key"),
        read_expires_after_sec=conf.get_int(
            "jwt.signing.read.expires_after_seconds", 60),
    )


def master_guard(conf: Configuration) -> Guard:
    """The master signs with the volume write key: it mints the assign
    tokens."""
    return volume_guard(conf)
