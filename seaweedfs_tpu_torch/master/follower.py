"""master.follower: a read-only lookup server beside the master.

The port's copy of seaweedfs_tpu/master/follower.py (weed/command/
master_follower.go).  It follows the leader's location push
(client/wdclient.py) and answers /dir/lookup from its own map, asking the
master only for a vid the map lacks, so read-heavy clients spare the
leader; /dir/assign, /vol/grow and /vol/vacuum answer 307 to the master.
"""

from __future__ import annotations

from ..client.wdclient import WdClient
from ..utils.httpd import (HttpError, Request, Response, Router, serve,
                           stop_server)


class MasterFollower:
    def __init__(self, master_url: str, host: str = "127.0.0.1",
                 port: int = 9334):
        self.master_url = master_url
        self.host, self.port = host, port
        self.wd = WdClient(master_url)
        self.router = Router("master-follower")
        self._register_routes()
        self._server = None

    @property
    def url(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "MasterFollower":
        self.wd.start()
        self._server = serve(self.router, self.host, self.port)
        return self

    def stop(self) -> None:
        if self._server:
            stop_server(self._server)
        self.wd.stop()

    def _register_routes(self) -> None:
        r = self.router

        @r.route("GET", "/dir/lookup")
        def lookup(req: Request) -> Response:
            vid_str = req.query.get("volumeId", "")
            vid = int(vid_str.split(",")[0])
            locs = self.wd.vid_map.lookup(vid)
            if not locs:
                # a miss: ask the master once (a vid before the snapshot)
                urls = self.wd.lookup(vid)
                if not urls:
                    return Response({"volumeId": vid_str,
                                     "error": "volume id not found"},
                                    status=404)
                return Response({"volumeId": vid_str, "locations": [
                    {"url": u, "publicUrl": u} for u in urls]})
            return Response({"volumeId": vid_str, "locations": [
                {"url": l.url, "publicUrl": l.public_url} for l in locs]})

        @r.route("GET", "/dir/status")
        def status(req: Request) -> Response:
            return Response({
                "IsFollower": True,
                "Leader": self.master_url,
                "Synced": self.wd._synced.is_set(),
            })

        # every other master call belongs on the real master
        @r.route("GET", "/dir/assign")
        @r.route("GET", "/vol/grow")
        @r.route("GET", "/vol/vacuum")
        def redirect(req: Request) -> Response:
            raise HttpError(307, "read-only follower; ask the master",
                            headers={"Location":
                                     f"http://{self.master_url}"
                                     f"{req.handler.path}"})
