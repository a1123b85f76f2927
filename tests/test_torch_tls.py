"""Cluster TLS and mTLS in the port (security/tls.py, utils/httpd.py).

Certificates come from the ``openssl`` command line, as in
tests/test_tls_streaming.py: a CA and a node certificate it signed.  A
port listener under ``server_context`` refuses a plaintext client and a
TLS client without a certificate (mutual TLS) and serves a peer that has
one through the ``http://`` URLs every call site builds.  A port client
talks to a reference server and a reference client to a port server,
JSON, bytes, a streamed file and a Range alike; the pooled client keeps
one TLS connection per peer across calls and replaces one the server
closed.  Then a whole cluster under mTLS: a port master, a port and a
reference volume server, the port's WeedClient writing, reading and
deleting, the framed planes closed, the master's redirect and the
shell's commands working.  Each test leaves both packages' client TLS
off.
"""

from __future__ import annotations

import json
import os
import socket
import ssl
import subprocess
import time
import urllib.request

import pytest

from seaweedfs_tpu.security import tls as ref_tls
from seaweedfs_tpu.utils import httpd as ref_httpd
from seaweedfs_tpu.volume_server.server import VolumeServer as RefVolumeServer
from seaweedfs_tpu_torch.client.operation import WeedClient
from seaweedfs_tpu_torch.master.server import MasterServer
from seaweedfs_tpu_torch.security import tls
from seaweedfs_tpu_torch.utils import httpd
from seaweedfs_tpu_torch.utils.framing import tcp_port_for
from seaweedfs_tpu_torch.volume_server.server import VolumeServer
from tests.conftest import free_port


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """A self-signed CA and one node certificate signed by it."""
    d = tmp_path_factory.mktemp("certs")

    def run(*argv):
        subprocess.run(argv, check=True, capture_output=True)

    ca_key, ca_crt = str(d / "ca.key"), str(d / "ca.crt")
    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", ca_key, "-out", ca_crt, "-days", "2",
        "-subj", "/CN=test-ca")
    node_key, node_csr, node_crt = (str(d / "node.key"), str(d / "node.csr"),
                                    str(d / "node.crt"))
    run("openssl", "req", "-newkey", "rsa:2048", "-nodes",
        "-keyout", node_key, "-out", node_csr, "-subj", "/CN=node")
    run("openssl", "x509", "-req", "-in", node_csr, "-CA", ca_crt,
        "-CAkey", ca_key, "-CAcreateserial", "-out", node_crt, "-days", "2")
    return {"port": tls.TlsConfig(ca_file=ca_crt, cert_file=node_crt,
                                  key_file=node_key),
            "ref": ref_tls.TlsConfig(ca_file=ca_crt, cert_file=node_crt,
                                     key_file=node_key)}


@pytest.fixture(autouse=True)
def tls_off():
    yield
    httpd.set_client_tls(None)
    ref_httpd.set_client_tls(None)


BLOB = os.urandom(3 * (1 << 20) + 4321)


def _router(mod, blob_path: str):
    r = mod.Router("tlstest")

    @r.route("GET", "/ping")
    def ping(req):
        return mod.Response({"pong": True, "peer": req.handler.client_address[0]})

    @r.route("POST", "/echo")
    def echo(req):
        return mod.Response(raw=req.body)

    @r.route("GET", "/file")
    def file_(req):
        return mod.Response(file_path=blob_path)

    @r.route("GET", "/range")
    def range_(req):
        return mod.Response(file_path=blob_path, file_range=(100, 2048))

    return r


def _serve(mod, tls_mod, cfg, tmp_path):
    blob = tmp_path / "blob.bin"
    blob.write_bytes(BLOB)
    port = free_port()
    srv = mod.serve(_router(mod, str(blob)), "127.0.0.1", port,
                    tls_context=tls_mod.server_context(cfg))
    return srv, f"127.0.0.1:{port}"


def test_mtls_refuses_plaintext_and_certless_clients(certs, tmp_path):
    srv, url = _serve(httpd, tls, certs["port"], tmp_path)
    try:
        assert type(srv).__name__ == "FastHTTPServer"
        with pytest.raises(httpd.HttpError):
            httpd.http_json("GET", f"http://{url}/ping", timeout=3.0)
        naked = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        naked.load_verify_locations(certs["port"].ca_file)
        naked.check_hostname = False
        with pytest.raises(Exception):
            urllib.request.urlopen(f"https://{url}/ping", timeout=3.0,
                                   context=naked).read()
        httpd.set_client_tls(tls.client_context(certs["port"]))
        assert httpd.http_json("GET", f"http://{url}/ping", timeout=5.0) == \
            {"pong": True, "peer": "127.0.0.1"}
    finally:
        httpd.stop_server(srv)


@pytest.mark.parametrize("client,server", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_clients_and_servers_of_both_packages_interoperate(certs, tmp_path,
                                                           client, server):
    mods = {"port": (httpd, tls), "ref": (ref_httpd, ref_tls)}
    smod, stls = mods[server]
    cmod, ctls = mods[client]
    srv, url = _serve(smod, stls, certs[server], tmp_path)
    try:
        cmod.set_client_tls(ctls.client_context(certs[client]))
        assert cmod.http_json("GET", f"http://{url}/ping")["pong"] is True
        body = os.urandom(200_000)
        status, got, _ = cmod.http_bytes("POST", f"http://{url}/echo", body)
        assert (status, got) == (200, body)
        dest = str(tmp_path / "dest.bin")
        assert cmod.http_download("GET", f"http://{url}/file", dest) == 200
        assert open(dest, "rb").read() == BLOB
        assert cmod.http_download("GET", f"http://{url}/range", dest) == 200
        assert open(dest, "rb").read() == BLOB[100:2148]
    finally:
        smod.stop_server(srv)


def test_the_pool_keeps_one_tls_connection_and_replaces_a_closed_one(
        certs, tmp_path):
    srv, url = _serve(httpd, tls, certs["port"], tmp_path)
    httpd.set_client_tls(tls.client_context(certs["port"]))
    try:
        for _ in range(20):
            httpd.http_json("GET", f"http://{url}/ping")
        conns = [c for k, c in httpd._pool.conns.items()
                 if k == ("https", url)]
        assert len(conns) == 1 and conns[0].tls
        first = conns[0]
        for _ in range(5):
            httpd.http_bytes("POST", f"http://{url}/echo", b"x" * 1000)
        assert httpd._pool.conns[("https", url)] is first
        first.sock.shutdown(socket.SHUT_RDWR)  # gone bad in the pool
        assert httpd.http_bytes("POST", f"http://{url}/echo", b"y")[1] == b"y"
        assert httpd._pool.conns[("https", url)] is not first
    finally:
        httpd.stop_server(srv)


def test_enable_cluster_tls_is_one_switch(certs, tmp_path):
    ctx = tls.enable_cluster_tls(certs["port"])
    assert ctx is not None and httpd._client_tls is not None
    port = free_port()
    srv = httpd.serve(_router(httpd, str(tmp_path / "none")), "127.0.0.1",
                      port, tls_context=ctx)
    try:
        assert httpd.http_json("GET", f"http://127.0.0.1:{port}/ping",
                               timeout=5.0)["pong"] is True
    finally:
        httpd.stop_server(srv)
    httpd.set_client_tls(None)
    assert tls.enable_cluster_tls(tls.TlsConfig()) is None
    assert httpd._client_tls is None
    assert httpd._prep_url("http://a:1/x") == ("http://a:1/x", None)


def test_a_cluster_under_mtls(certs, tmp_path):
    """A port master, a port and a reference volume server, all under the
    same mTLS (each package's client side installed, as the CLI's
    ``_cluster_tls`` does): registration, assign, replicated writes,
    reads, a delete, the shell, and no framed plane."""
    from seaweedfs_tpu_torch.shell import CommandEnv, run_command

    ctx = tls.enable_cluster_tls(certs["port"])
    ref_ctx = ref_tls.enable_cluster_tls(certs["ref"])
    m = MasterServer(port=free_port(), pulse_seconds=0.4,
                     tls_context=ctx).start()
    servers = [
        VolumeServer([str(tmp_path / "p")], m.url, port=free_port(),
                     pulse_seconds=0.4, device="cpu", tls_context=ctx),
        RefVolumeServer([str(tmp_path / "r")], m.url, port=free_port(),
                        pulse_seconds=0.4, ec_engine="cpu",
                        tls_context=ref_ctx)]
    for vs in servers:
        vs.start()
    try:
        deadline = time.time() + 10
        while time.time() < deadline and len(m.topo.all_nodes()) < 2:
            time.sleep(0.05)
        assert len(m.topo.all_nodes()) == 2
        assert m._tcp_server is None and servers[0]._tcp_server is None
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", tcp_port_for(m.port)),
                                     timeout=2).close()
        c = WeedClient(m.url)
        fids = {c.upload(b"mtls %d" % i, replication="001"): b"mtls %d" % i
                for i in range(6)}
        for fid, data in fids.items():
            for url in c.master.lookup(int(fid.split(",")[0])):
                st, body, _ = httpd.http_bytes("GET", f"http://{url}/{fid}")
                assert (st, body) == (200, data)
        fid = next(iter(fids))
        c.delete(fid)
        with pytest.raises(httpd.HttpError):
            c.download(fid)
        # the master's redirect to a holder, followed over TLS
        st, body, _ = httpd.http_bytes("GET", f"http://{m.url}/{fid[:0]}"
                                       f"{list(fids)[1]}")
        assert (st, body) == (200, fids[list(fids)[1]])
        env = CommandEnv(m.url)
        env.lock()
        try:
            out = run_command(env, "volume.list")
        finally:
            env.unlock()
        assert servers[1].url in out and servers[0].url in out
        # a plaintext caller gets nothing from any of them
        httpd.set_client_tls(None)
        for url in [m.url] + [vs.url for vs in servers]:
            with pytest.raises(httpd.HttpError):
                httpd.http_json("GET", f"http://{url}/status", timeout=3.0)
    finally:
        httpd.set_client_tls(tls.client_context(certs["port"]))
        for vs in servers:
            vs.stop()
        m.stop()


def test_security_toml_tls_section_drives_the_cli_helpers(certs, tmp_path,
                                                          monkeypatch):
    from seaweedfs_tpu_torch import __main__ as cli

    cfg = certs["port"]
    (tmp_path / "security.toml").write_text(
        f'[tls]\nca = "{cfg.ca_file}"\ncert = "{cfg.cert_file}"\n'
        f'key = "{cfg.key_file}"\n')
    monkeypatch.chdir(tmp_path)
    ctx = cli._cluster_tls()
    assert isinstance(ctx, ssl.SSLContext)
    assert ctx.verify_mode == ssl.CERT_REQUIRED
    assert httpd._client_tls is not None
    (tmp_path / "security.toml").write_text("[guard]\n")
    httpd.set_client_tls(None)
    assert cli._cluster_tls() is None and httpd._client_tls is None
    assert json.loads(json.dumps(cli._tier_backends(["a=/x", "b=/y/z"]))) \
        == {"a": {"type": "dir", "root": "/x"},
            "b": {"type": "dir", "root": "/y/z"}}
    with pytest.raises(SystemExit):
        cli._tier_backends(["nodir"])
