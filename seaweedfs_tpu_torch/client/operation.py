"""Client verbs: assign, upload, lookup, download, delete.

The port's copy of the HTTP verbs of seaweedfs_tpu/client/operation.py
(weed/operation/ assign_file_id.go:37, upload_content.go, lookup.go,
delete_content.go, submit.go) with its vid -> locations TTL cache
(wdclient/vid_map.go).

``upload_tcp`` and ``download_tcp`` are the framed-TCP verbs (``benchmark
-useTcp``): the assign goes to the master's framed front (op ``A``), the
write and the read to the holder's framed plane (volume_server/tcp.py),
each on the HTTP port + 20000.  A read that a native data plane answers
"volume not on native plane" (a volume quiesced off it for maintenance,
or one it never takes) goes over HTTP, which serves it from the Python
engine.

On a secured cluster the client carries the master's tokens, as the
reference's does: the assign's ``auth`` goes on the write as
``Authorization: BEARER``, the lookup's read token on every GET, and a
delete asks the master for the fid's ``writeAuth``.

``WeedClient(keep_connected=True)`` reads locations from a push-updated
map (client/wdclient.py, the master's ``/cluster/watch``) once it has
synced, and asks /dir/lookup before then; on a secured cluster (its
first lookup carries a read token) it stops the watch and asks
/dir/lookup, whose answer carries the tokens.  ``close()`` stops it.
"""

from __future__ import annotations

import json
import os
import random
import time
import urllib.parse
from dataclasses import dataclass
from typing import Optional

from ..utils.compression import (is_compressable_file_type,
                                 maybe_decompress_data, maybe_gzip_data)
from ..utils.httpd import HttpError, http_bytes, http_json


@dataclass
class Assignment:
    fid: str
    url: str
    public_url: str
    count: int
    auth: str = ""  # the master's write token for exactly this fid


class MasterClient:
    """vid -> locations cache with TTL (wdclient/vid_map.go:44-160)."""

    CACHE_SECONDS = 10.0

    def __init__(self, master_url: str):
        self.master_url = master_url
        self._cache: dict[int, tuple[float, list[str], str]] = {}

    def assign(self, count: int = 1, collection: str = "",
               replication: str = "", ttl: str = "",
               data_center: str = "") -> Assignment:
        q = urllib.parse.urlencode({
            "count": count, "collection": collection,
            "replication": replication, "ttl": ttl,
            "dataCenter": data_center})
        r = http_json("GET", f"http://{self.master_url}/dir/assign?{q}",
                      timeout=30.0)
        if r.get("error"):
            raise HttpError(500, r["error"])
        return Assignment(r["fid"], r["url"], r.get("publicUrl", r["url"]),
                          int(r.get("count", count)), r.get("auth", ""))

    def lookup(self, vid: int) -> list[str]:
        return self.lookup_with_auth(vid)[0]

    def lookup_with_auth(self, vid: int) -> tuple[list[str], str]:
        """(urls, read token), cached; the token is "" on a cluster
        without a read key."""
        cached = self._cache.get(vid)
        now = time.time()
        if cached and now - cached[0] < self.CACHE_SECONDS:
            return cached[1], cached[2]
        r = http_json("GET",
                      f"http://{self.master_url}/dir/lookup?volumeId={vid}",
                      timeout=30.0)
        urls = [loc["url"] for loc in r.get("locations", [])]
        auth = r.get("auth", "")
        self._cache[vid] = (now, urls, auth)
        return urls, auth

    def lookup_uncached(self, vid: int) -> list[str]:
        """The volume's holders as the master names them now."""
        self.invalidate(vid)
        return self.lookup(vid)

    def lookup_file(self, fid: str) -> tuple[list[str], str, str]:
        """(urls, read token, write token) for one fid, uncached: the
        write token lets its holder delete exactly this file."""
        vid = int(fid.split(",")[0])
        r = http_json(
            "GET", f"http://{self.master_url}/dir/lookup?"
            f"volumeId={vid}&fileId={fid}", timeout=30.0)
        urls = [loc["url"] for loc in r.get("locations", [])]
        return urls, r.get("auth", ""), r.get("writeAuth", "")

    def invalidate(self, vid: int) -> None:
        self._cache.pop(vid, None)


class WeedClient:
    """One-shot operations against a master and its volume servers
    (operation/submit.go flavor).  Reads pick a holder at random from
    ``rng`` and fail over to the next; ``last_read_from`` names the
    server that answered the last read.  ``keep_connected`` looks
    locations up in a push-updated map (same ``data_center`` first)."""

    def __init__(self, master_url: str, keep_connected: bool = False,
                 data_center: str = ""):
        self.master = MasterClient(master_url)
        self.rng = random.Random()
        self.last_read_from = ""
        # the framed verbs' per-thread connections, made at first use;
        # whether the master's framed assign answered (None: not tried)
        self._tcp = None
        self._tcp_assign_ok: Optional[bool] = None
        # whether the first lookup carried a read token (None: not yet)
        self._secured: Optional[bool] = None
        self.wd = None
        if keep_connected:
            from .wdclient import WdClient

            self.wd = WdClient(master_url, data_center=data_center).start()

    def close(self) -> None:
        if self.wd is not None:
            self.wd.stop()

    def _locate(self, vid: int) -> tuple[list[str], str]:
        """(urls, read token), from the push map on an open cluster."""
        if self._secured is None:
            urls, auth = self.master.lookup_with_auth(vid)
            self._secured = bool(auth)
            if self._secured and self.wd is not None:
                # a secured cluster never reads the map: no long-poll
                # parked on the master for nothing
                self.wd.stop()
                self.wd = None
            return urls, auth
        if self._secured or self.wd is None \
                or not self.wd._synced.is_set():
            return self.master.lookup_with_auth(vid)
        return self.wd.lookup(vid), ""

    def upload(self, data: bytes, name: str = "", mime: str = "",
               collection: str = "", replication: str = "",
               ttl: str = "", compress: Optional[bool] = None,
               internal: bool = False) -> str:
        """Assign + POST; returns the fid.

        compress=None sniffs the name/mime the way the reference client
        does (upload_content.go:116, IsCompressableFileType); a gzip win
        goes out with Content-Encoding so the volume server flags the
        needle compressed.  ``internal`` marks the PUT a server's proxied
        hop (``?type=proxied``: the master's /submit), which the request
        log does not count as client traffic."""
        a = self.master.assign(collection=collection, replication=replication,
                               ttl=ttl)
        params = {}
        if name:
            params["name"] = name
        if ttl:
            params["ttl"] = ttl
        if internal:
            params["type"] = "proxied"
        q = "?" + urllib.parse.urlencode(params) if params else ""
        headers = {"Content-Type": mime} if mime else {}
        if compress is None and (name or mime):
            ext = os.path.splitext(name)[1] if name else ""
            compress, _ = is_compressable_file_type(ext, mime)
        if compress:
            gz = maybe_gzip_data(data)
            if gz is not data:
                data = gz
                headers["Content-Encoding"] = "gzip"
        last_err = None
        for attempt in range(5):
            hdrs = dict(headers)
            if a.auth:
                hdrs["Authorization"] = f"BEARER {a.auth}"
            status, body, _ = http_bytes(
                "POST", f"http://{a.url}/{a.fid}{q}", data,
                headers=hdrs or None, timeout=60.0)
            if status in (200, 201):
                return a.fid
            last_err = HttpError(status, body.decode(errors="replace"))
            if status == 409 or b"read only" in body:
                # the volume went readonly (ec.encode, an operator fence)
                # between assign and write: a FRESH assignment routes to a
                # writable volume once the readonly delta reaches the
                # master, within one heartbeat pulse
                time.sleep(0.15 * (attempt + 1))
                a = self.master.assign(collection=collection,
                                       replication=replication, ttl=ttl)
                continue
            break
        raise last_err

    def _tcp_client(self):
        from ..volume_server.tcp import TcpVolumeClient

        if self._tcp is None:
            self._tcp = TcpVolumeClient()
        return self._tcp

    def upload_tcp(self, data: bytes, collection: str = "",
                   replication: str = "", ttl: str = "") -> str:
        """Framed-TCP assign + write; returns the fid.  The assign falls
        back to HTTP when the master's framed front does not answer (a
        follower, a port taken) and remembers which worked; a volume that
        went read-only is re-assigned; a holder whose framed plane is
        closed takes the write over HTTP."""
        from ..volume_server.tcp import tcp_address

        tcp = self._tcp_client()
        a = None
        if self._tcp_assign_ok is not False:
            try:
                r = json.loads(tcp.request(
                    tcp_address(self.master.master_url), b"A", "",
                    json.dumps({"collection": collection,
                                "replication": replication,
                                "ttl": ttl}).encode()))
                a = Assignment(r["fid"], r["url"],
                               r.get("publicUrl", r["url"]),
                               int(r.get("count", 1)), r.get("auth", ""))
                self._tcp_assign_ok = True
            except (OSError, ValueError, KeyError):
                self._tcp_assign_ok = False
        if a is None:
            a = self.master.assign(collection=collection,
                                   replication=replication, ttl=ttl)
        for attempt in range(5):
            try:
                tcp.write(tcp_address(a.url), a.fid, data)
                return a.fid
            except (ConnectionError, OSError) as e:
                if "read only" in str(e) and attempt < 4:
                    # fenced between the assign and the write: re-assign
                    # once the read-only delta reaches the master
                    time.sleep(0.15 * (attempt + 1))
                    a = self.master.assign(collection=collection,
                                           replication=replication, ttl=ttl)
                    continue
                # the holder's framed plane is closed (a secured server,
                # a port taken): the assignment stands, and the write goes
                # over HTTP, which carries the token
                headers = {"Authorization": f"BEARER {a.auth}"} if a.auth \
                    else None
                status, body, _ = http_bytes(
                    "POST", f"http://{a.url}/{a.fid}", data,
                    headers=headers, timeout=60.0)
                if status in (200, 201):
                    return a.fid
                if (status == 409 or b"read only" in body) and attempt < 4:
                    time.sleep(0.15 * (attempt + 1))
                    a = self.master.assign(collection=collection,
                                           replication=replication, ttl=ttl)
                    continue
                raise HttpError(status, body.decode(errors="replace"))
        return a.fid  # pragma: no cover

    def download_tcp(self, fid: str) -> bytes:
        """Framed-TCP read from the volume's first holder; a holder whose
        framed plane is closed, or whose native plane does not hold the
        volume, is read over HTTP.  Any other error frame (a missing
        needle, an EC volume) raises OSError with its text."""
        from ..volume_server.tcp import tcp_address

        tcp = self._tcp_client()
        vid = int(fid.split(",")[0])
        urls, _ = self._locate_retry(vid)
        if not urls:
            raise HttpError(404, f"volume {vid} has no locations")
        try:
            return tcp.read(tcp_address(urls[0]), fid)
        except OSError as e:
            if isinstance(e, ConnectionError) or \
                    "not on native plane" in str(e):
                return self.download(fid)
            raise

    def download(self, fid: str) -> bytes:
        """Full-blob GET; a gzip-encoded reply is decompressed."""
        body, headers = self._get(fid, None)
        if headers.get("Content-Encoding") == "gzip":
            return maybe_decompress_data(body)
        return body

    def download_range(self, fid: str, offset: int, size: int) -> bytes:
        """Ranged GET: only [offset, offset+size) travels the wire."""
        if size <= 0:
            return b""
        body, _ = self._get(
            fid, {"Range": f"bytes={offset}-{offset + size - 1}"},
            ok=(200, 206))
        return body

    def _locate_retry(self, vid: int) -> tuple[list[str], str]:
        """(the volume's holders, the read token), riding out transient
        unregistration: a starved heartbeat can drop a node for a pulse
        and the next pulse re-registers it."""
        for attempt in range(3):
            try:
                urls, auth = self._locate(vid)
            except HttpError as e:
                if e.status != 404 or attempt == 2:
                    raise
                urls, auth = [], ""
            if urls:
                return urls, auth
            time.sleep(0.3)
            self.master.invalidate(vid)
        return [], ""

    def _get(self, fid: str, extra_headers: Optional[dict],
             ok: tuple = (200,)) -> tuple[bytes, dict]:
        vid = int(fid.split(",")[0])
        urls, auth = self._locate_retry(vid)
        if not urls:
            raise HttpError(404, f"volume {vid} has no locations")
        headers = dict(extra_headers or {})
        if auth:
            headers["Authorization"] = f"BEARER {auth}"
        last_err = None
        for url in self.rng.sample(urls, len(urls)):
            status, body, rhdrs = http_bytes("GET", f"http://{url}/{fid}",
                                             headers=headers or None,
                                             timeout=60.0)
            if status in ok:
                self.last_read_from = url
                return body, rhdrs
            if status == 302:
                continue
            if status == 0:  # dead server: fail over to the next holder
                self.master.invalidate(vid)
            last_err = HttpError(status or 503, body.decode(errors="replace"))
        raise last_err or HttpError(404, "not found")

    def delete(self, fid: str) -> None:
        """DELETE at the first holder, with the fid's write token on a
        secured cluster."""
        vid = int(fid.split(",")[0])
        urls: list = []
        write_auth = ""
        for attempt in range(3):
            try:
                urls, _, write_auth = self.master.lookup_file(fid)
            except HttpError as e:
                if e.status != 404 or attempt == 2:
                    raise
            if urls:
                break
            time.sleep(0.3)  # transient unregistration: next pulse heals
        if not urls:
            raise HttpError(404, f"volume {vid} has no locations")
        headers = ({"Authorization": f"BEARER {write_auth}"}
                   if write_auth else None)
        http_bytes("DELETE", f"http://{urls[0]}/{fid}", headers=headers,
                   timeout=60.0)
