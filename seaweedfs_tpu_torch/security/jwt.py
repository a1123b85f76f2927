"""Compact JWS HS256 tokens for write and read authorization.

The port's copy of seaweedfs_tpu/security/jwt.py (weed/security/jwt.go):
the master signs a per-fid claim that the volume server verifies before a
write or delete (SeaweedFileIdClaims, jwt.go:18-49), and a bare claim
authorizes reads (SeaweedFilerClaims, jwt.go:52-72).  Built on the
standard library's hmac and hashlib.  For the same key, fid and clock the
tokens are byte-equal to the reference's: the same header, the same
compact JSON, the same unpadded base64url.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Optional

EncodedJwt = str
SigningKey = bytes


class JwtError(Exception):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


_HEADER = _b64url(json.dumps(
    {"alg": "HS256", "typ": "JWT"}, separators=(",", ":")).encode())


def _key(signing_key) -> bytes:
    return signing_key.encode() if isinstance(signing_key, str) \
        else signing_key


def _sign(signing_key: SigningKey, payload: dict) -> EncodedJwt:
    body = _b64url(json.dumps(payload, separators=(",", ":")).encode())
    msg = f"{_HEADER}.{body}".encode()
    sig = _b64url(hmac.new(signing_key, msg, hashlib.sha256).digest())
    return f"{_HEADER}.{body}.{sig}"


def gen_jwt_for_volume_server(signing_key: SigningKey | str,
                              expires_after_sec: int,
                              file_id: str) -> EncodedJwt:
    """A token for exactly ``file_id`` (jwt.go:30-49); "" without a key.
    ``exp`` is set only for a positive ``expires_after_sec``."""
    key = _key(signing_key)
    if not key:
        return ""
    claims: dict = {"fid": file_id}
    if expires_after_sec > 0:
        claims["exp"] = int(time.time()) + expires_after_sec
    return _sign(key, claims)


def gen_jwt_for_filer_server(signing_key: SigningKey | str,
                             expires_after_sec: int) -> EncodedJwt:
    """A bare token, no fid (jwt.go:52-72): the master's read token."""
    key = _key(signing_key)
    if not key:
        return ""
    claims: dict = {}
    if expires_after_sec > 0:
        claims["exp"] = int(time.time()) + expires_after_sec
    return _sign(key, claims)


def decode_jwt(signing_key: SigningKey | str, token: EncodedJwt) -> dict:
    """Verify the signature and ``exp``; -> the claims (jwt.go:91-99).
    Raises JwtError with the reference's messages."""
    key = _key(signing_key)
    parts = token.split(".")
    if len(parts) != 3:
        raise JwtError("malformed token")
    try:
        header = json.loads(_unb64url(parts[0]))
    except Exception:  # noqa: BLE001 - any undecodable header
        raise JwtError("malformed header") from None
    if header.get("alg") != "HS256":
        raise JwtError("unknown token method")
    msg = f"{parts[0]}.{parts[1]}".encode()
    want = hmac.new(key, msg, hashlib.sha256).digest()
    try:
        got = _unb64url(parts[2])
    except Exception:  # noqa: BLE001 - any undecodable signature
        raise JwtError("malformed signature") from None
    if not hmac.compare_digest(want, got):
        raise JwtError("signature mismatch")
    try:
        claims = json.loads(_unb64url(parts[1]))
    except Exception:  # noqa: BLE001 - any undecodable claims
        raise JwtError("malformed claims") from None
    exp = claims.get("exp")
    if exp is not None and time.time() > exp:
        raise JwtError("token expired")
    return claims


def get_jwt(headers, query: Optional[dict] = None) -> EncodedJwt:
    """The token of ``?jwt=``, else of ``Authorization: Bearer``
    (jwt.go:76-89); "" when there is none."""
    token = (query or {}).get("jwt", "")
    if not token:
        bearer = headers.get("Authorization", "") if headers else ""
        if len(bearer) > 7 and bearer[:6].upper() == "BEARER":
            token = bearer[7:]
    return token
