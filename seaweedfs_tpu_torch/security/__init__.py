"""Security: write and read JWTs, the IP whitelist guard, cluster mTLS.

The port's copy of seaweedfs_tpu/security (weed/security/): ``jwt``
signs and verifies the HS256 tokens the master mints at assign and
lookup, ``guard`` holds a server's whitelist and keys, ``config`` builds
guards from ``security.toml`` and ``tls`` the cluster's SSL contexts.

Not ported: ``filer_guard`` (it waits for the filer).
"""

from .guard import Guard
from .jwt import (EncodedJwt, JwtError, SigningKey, decode_jwt,
                  gen_jwt_for_filer_server, gen_jwt_for_volume_server,
                  get_jwt)

__all__ = [
    "EncodedJwt", "SigningKey", "decode_jwt", "gen_jwt_for_filer_server",
    "gen_jwt_for_volume_server", "get_jwt", "Guard", "JwtError",
]
