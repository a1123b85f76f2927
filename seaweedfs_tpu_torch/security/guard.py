"""Request guard: the IP whitelist and JWT checks of a server.

The port's copy of seaweedfs_tpu/security/guard.py (weed/security/
guard.go:53-120).  A guard with neither a whitelist nor a write key is
inactive and passes every request, as the reference's isWriteActive
short-circuit does.  The whitelist holds literal IPs and CIDRs; the peer
is the socket's, never an X-Forwarded-For header (the reference's choice
too: a proxied deployment whitelists its proxy).
"""

from __future__ import annotations

import ipaddress
from typing import Optional

from .jwt import JwtError, decode_jwt, gen_jwt_for_filer_server, get_jwt


class Guard:
    def __init__(self, white_list: Optional[list[str]] = None,
                 signing_key: str = "", expires_after_sec: int = 10,
                 read_signing_key: str = "", read_expires_after_sec: int = 60):
        self.white_list = [w for w in (white_list or []) if w]
        self.signing_key = signing_key
        self.expires_after_sec = expires_after_sec
        self.read_signing_key = read_signing_key
        self.read_expires_after_sec = read_expires_after_sec
        self.is_write_active = bool(self.white_list or self.signing_key)

    # --- whitelist (guard.go:65-130) -------------------------------------
    def check_white_list(self, remote_host: str) -> bool:
        if not self.white_list:
            return True
        for entry in self.white_list:
            if "/" in entry:
                try:
                    if (ipaddress.ip_address(remote_host)
                            in ipaddress.ip_network(entry, strict=False)):
                        return True
                except ValueError:
                    continue
            elif entry == remote_host:
                return True
        return False

    @staticmethod
    def actual_remote_host(req) -> str:
        """The TCP peer's address."""
        return req.handler.client_address[0]

    def white_list_ok(self, req) -> bool:
        if not self.is_write_active:
            return True
        return self.check_white_list(self.actual_remote_host(req))

    # --- jwt ---------------------------------------------------------------
    def check_write_jwt(self, req, fid: str) -> Optional[str]:
        """A write's or delete's check: None, or the error.  The claim must
        name the exact fid the master signed at assign."""
        if not self.signing_key:
            return None
        return self._check(req, self.signing_key,
                           lambda c: None if c.get("fid") == fid else
                           f"jwt fid mismatch: {c.get('fid')} != {fid}")

    def check_read_jwt(self, req, fid: str) -> Optional[str]:
        """A read's check: a bare read token, or one for this fid."""
        if not self.read_signing_key:
            return None
        return self._check(req, self.read_signing_key,
                           lambda c: None if c.get("fid") in (None, fid)
                           else "jwt fid mismatch")

    @staticmethod
    def _check(req, key: str, claims_error) -> Optional[str]:
        token = get_jwt(req.headers, req.query)
        if not token:
            return "missing jwt"
        try:
            claims = decode_jwt(key, token)
        except JwtError as e:
            return str(e)
        return claims_error(claims)

    def gen_read_token(self) -> str:
        """A bare read token (valid for any read) signed with the read key:
        the master puts it on /dir/lookup answers."""
        return gen_jwt_for_filer_server(self.read_signing_key,
                                        self.read_expires_after_sec)
