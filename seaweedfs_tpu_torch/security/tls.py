"""Cluster TLS and mTLS: SSL contexts from security.toml's [tls].

The port's copy of seaweedfs_tpu/security/tls.py (weed/security/tls.go,
LoadServerTLS / LoadClientTLS).  With a cert and a key configured, one
call to ``enable_cluster_tls`` switches the process: its servers listen
with HTTPS (and, with a CA, require a client certificate: mutual TLS),
and every outgoing ``http://`` URL is upgraded and verified
(utils/httpd.py ``set_client_tls``).

    [tls]
    ca            = "/etc/seaweedfs/ca.crt"    # the peers' root
    cert          = "/etc/seaweedfs/node.crt"  # this node's certificate
    key           = "/etc/seaweedfs/node.key"
    verify_client = true                       # mTLS (the default with ca)
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass
from typing import Optional

from ..utils.httpd import set_client_tls


@dataclass
class TlsConfig:
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    verify_client: bool = True

    @property
    def enabled(self) -> bool:
        return bool(self.cert_file and self.key_file)


def from_configuration(conf) -> TlsConfig:
    """security.toml [tls] -> TlsConfig (no section: off)."""
    return TlsConfig(
        ca_file=conf.get_string("tls.ca") or "",
        cert_file=conf.get_string("tls.cert") or "",
        key_file=conf.get_string("tls.key") or "",
        verify_client=bool(conf.get("tls.verify_client", True)),
    )


def server_context(cfg: TlsConfig) -> Optional[ssl.SSLContext]:
    """The context ``serve(..., tls_context=...)`` takes; None when off."""
    if not cfg.enabled:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    if cfg.ca_file:
        ctx.load_verify_locations(cfg.ca_file)
        if cfg.verify_client:
            ctx.verify_mode = ssl.CERT_REQUIRED  # mutual TLS
    return ctx


def client_context(cfg: TlsConfig) -> Optional[ssl.SSLContext]:
    """The context of outgoing calls: it verifies the server against the
    CA and presents this node's certificate (mTLS's client half)."""
    if not cfg.enabled:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cfg.ca_file or cfg.cert_file)
    # cluster certificates name nodes, not the IPs servers dial each
    # other by: the CA's signature is the trust anchor
    ctx.check_hostname = False
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    return ctx


def enable_cluster_tls(cfg: TlsConfig) -> Optional[ssl.SSLContext]:
    """Install the client side process-wide and return the server context
    for ``serve``; None, with nothing installed, when TLS is off."""
    if not cfg.enabled:
        return None
    set_client_tls(client_context(cfg))
    return server_context(cfg)
