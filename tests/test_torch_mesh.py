"""The port's multi-card GF programs against seaweedfs_tpu's mesh.

``parallel/mesh.py`` runs over lanes; here eight CPU lanes, each running
the plain version, stand where the reference runs its eight virtual CPU
devices (tests/conftest.py).  The same seeded numpy inputs go through the
reference's ``sharded_encode_fn``, ``training_step_fn``,
``ring_rebuild_fn``, ``MeshEngine`` and ``parse_device_spec`` and through
the port's, and the bytes must be equal (tolerance 0).  ``DrainerGroup``
is held to the reference's error, abort and FIFO contract.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec.codec import CpuEngine
from seaweedfs_tpu.ec.codec import MeshEngine as RefMeshEngine
from seaweedfs_tpu.ec.codec import ReedSolomon as RefRS
from seaweedfs_tpu.ec.gf256 import mat_invert, mat_mul
from seaweedfs_tpu.ec.overlap import DrainerGroup as RefDrainerGroup
from seaweedfs_tpu.ops.gf_matmul import expand_matrix_bitplanes
from seaweedfs_tpu.parallel import mesh as ref_mesh
from seaweedfs_tpu_torch.ec.codec import MeshEngine, ReedSolomon
from seaweedfs_tpu_torch.ec.overlap import DrainerGroup
from seaweedfs_tpu_torch.parallel import mesh
from seaweedfs_tpu_torch.parallel.mesh import resolve_lanes, visible_lanes

CPU8 = [torch.device("cpu")] * 8

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parity_rows(d: int = 10, p: int = 4) -> np.ndarray:
    return RefRS(d, p, engine=CpuEngine()).matrix[d:]


def _rec_rows(d: int, p: int, missing: list[int]) -> tuple[np.ndarray, list]:
    matrix = RefRS(d, p, engine=CpuEngine()).matrix
    survivors = [i for i in range(d + p) if i not in missing][:d]
    decode = mat_invert([[int(v) for v in matrix[i]] for i in survivors])
    rows = mat_mul([[int(v) for v in matrix[m]] for m in missing], decode)
    return np.array(rows, dtype=np.uint8), survivors


@pytest.mark.parametrize("dp,sp,tp",
                         [(8, 1, 1), (2, 2, 2), (1, 2, 4), (2, 1, 4)])
def test_sharded_encode_matches_the_reference(dp, sp, tp):
    rng = np.random.default_rng(100 + dp * 16 + sp * 4 + tp)
    m = _parity_rows()
    data = rng.integers(0, 256, (10, 2 * dp, 128 * sp), dtype=np.uint8)
    ref = ref_mesh.make_mesh(dp, sp, tp)
    want = np.asarray(jax.device_get(ref_mesh.sharded_encode_fn(ref)(
        jax.numpy.asarray(expand_matrix_bitplanes(m)),
        ref_mesh.shard_data(ref, data))))
    lanes = mesh.make_mesh(dp, sp, tp, devices=CPU8)
    assert lanes.shape == (dp, sp, tp)
    got = mesh.sharded_encode_fn(lanes)(m, data)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    # a torch input gives the same bytes
    assert torch.equal(mesh.sharded_encode_fn(lanes)(
        torch.from_numpy(m), torch.from_numpy(data)), got)


def test_sharded_encode_refuses_what_does_not_split():
    lanes = mesh.make_mesh(1, 1, 3, devices=CPU8)
    with pytest.raises(ValueError, match=r"8\*K=80 not divisible by tp=3"):
        mesh.sharded_encode_fn(lanes)(_parity_rows(),
                                      np.zeros((10, 1, 64), np.uint8))
    lanes = mesh.make_mesh(2, 2, 2, devices=CPU8)
    with pytest.raises(ValueError, match="does not split"):
        mesh.sharded_encode_fn(lanes)(_parity_rows(),
                                      np.zeros((10, 3, 64), np.uint8))
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        mesh.make_mesh(4, 2, 2, devices=CPU8)


def test_training_step_matches_the_reference():
    rng = np.random.default_rng(7)
    m = _parity_rows()
    # the reference's decode row for data shard 0 from survivors 1..9 and
    # parity row 10, exactly as tests/test_parallel.py builds it
    matrix = RefRS(10, 4).matrix
    sub = [[int(v) for v in matrix[i]] for i in list(range(1, 10)) + [10]]
    decode = np.array(mat_invert(sub), dtype=np.uint8)[:1]
    data = rng.integers(0, 256, (10, 4, 256), dtype=np.uint8)
    ref = ref_mesh.make_mesh(2, 2, 2)
    want, want_bad = ref_mesh.training_step_fn(ref)(
        jax.numpy.asarray(expand_matrix_bitplanes(m)),
        jax.numpy.asarray(expand_matrix_bitplanes(decode)),
        ref_mesh.shard_data(ref, data))
    parity, bad = mesh.training_step_fn(mesh.make_mesh(2, 2, 2,
                                                       devices=CPU8))(
        m, decode, data)
    assert bad == int(want_bad) == 0
    assert np.array_equal(parity.numpy(), np.asarray(jax.device_get(want)))
    # a wrong decode row shows as mismatches, as in the reference
    wrong = np.roll(decode, 1, axis=1)
    _, want_bad = ref_mesh.training_step_fn(ref)(
        jax.numpy.asarray(expand_matrix_bitplanes(m)),
        jax.numpy.asarray(expand_matrix_bitplanes(wrong)),
        ref_mesh.shard_data(ref, data))
    _, bad = mesh.training_step_fn(mesh.make_mesh(2, 2, 2, devices=CPU8))(
        m, wrong, data)
    assert bad == int(want_bad) > 0


@pytest.mark.parametrize("d,p,ring,missing",
                         [(8, 4, 8, [0, 5]), (10, 4, 2, [2, 11]),
                          (10, 4, 5, [0, 3, 11, 13])],
                         ids=["rs8.4-ring8", "rs10.4-ring2", "rs10.4-ring5"])
def test_ring_rebuild_matches_the_reference(d, p, ring, missing):
    rng = np.random.default_rng(d * 100 + ring)
    codec = RefRS(d, p, engine=CpuEngine())
    data = rng.integers(0, 256, (d, 256), dtype=np.uint8)
    shards = np.concatenate([data, codec.encode(data)])
    rec, survivors = _rec_rows(d, p, missing)
    ref = ref_mesh.make_mesh(1, 1, ring, devices=jax.devices()[:ring])
    planes = jax.numpy.asarray(ref_mesh.ring_plane_layout(
        expand_matrix_bitplanes(rec), d, ring))
    want = np.asarray(jax.device_get(ref_mesh.ring_rebuild_fn(ref)(
        planes, jax.numpy.asarray(shards[survivors]))))
    assert np.array_equal(want, shards[missing])
    lanes = mesh.make_mesh(*mesh.factor_mesh(ring), devices=CPU8[:ring])
    got = mesh.ring_rebuild_fn(lanes)(rec, shards[survivors])
    assert np.array_equal(got.numpy(), want)


def test_ring_rebuild_refuses_survivors_that_do_not_split():
    lanes = mesh.make_mesh(1, 1, 3, devices=CPU8)
    rec, _ = _rec_rows(10, 4, [0])
    with pytest.raises(ValueError, match="ring of 3"):
        mesh.ring_rebuild_fn(lanes)(rec, np.zeros((10, 64), np.uint8))


@pytest.mark.parametrize("lanes", [8, 4, 3, 1])
def test_mesh_engine_matches_the_reference(lanes):
    rng = np.random.default_rng(40 + lanes)
    ref = RefMeshEngine(devices=jax.devices()[:lanes])
    port = MeshEngine(devices=CPU8[:lanes])
    assert port.dims == ref.dims == mesh.factor_mesh(lanes)
    assert port.name == "mesh" and len(port.devices) == lanes
    m = _parity_rows()
    for width in (1, 7, 64, 1000, 4096):
        data = rng.integers(0, 256, (10, width), dtype=np.uint8)
        want = ref.matmul(m, data)
        assert np.array_equal(port.matmul(m, data), want), width
        out = np.empty((4, width), dtype=np.uint8)
        assert port.matmul_into(m, data, out) is out
        assert np.array_equal(out, want)


def test_mesh_engine_serves_threads_at_once():
    """A store's degraded reads call its MeshEngine from several request
    threads at once: each call's product is still its own."""
    rng = np.random.default_rng(29)
    port = MeshEngine(devices=CPU8[:4])
    cases = []
    for i in range(16):
        m = rng.integers(0, 256, (1 + i % 4, 10), dtype=np.uint8)
        data = rng.integers(0, 256, (10, 4096 + 517 * i), dtype=np.uint8)
        cases.append((m, data, CpuEngine().matmul(m, data)))
    got: dict = {}

    def call(i: int) -> None:
        m, data, _ = cases[i]
        got[i] = port.matmul(m, data)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(call, range(len(cases))))
    for i, (_, _, want) in enumerate(cases):
        np.testing.assert_array_equal(got[i], want)


def test_mesh_engine_refuses_a_contraction_that_does_not_split():
    ref = RefMeshEngine(mesh=ref_mesh.make_mesh(1, 1, 3))
    port = MeshEngine(mesh=mesh.make_mesh(1, 1, 3, devices=CPU8))
    data = np.zeros((10, 64), dtype=np.uint8)
    with pytest.raises(ValueError) as want:
        ref.matmul(_parity_rows(), data)
    with pytest.raises(ValueError) as got:
        port.matmul(_parity_rows(), data)
    assert str(got.value) == str(want.value)


def test_reed_solomon_on_the_mesh_engine_matches_the_reference():
    rng = np.random.default_rng(11)
    ref = RefRS(10, 4, engine=RefMeshEngine())
    port = ReedSolomon(10, 4, engine=MeshEngine(devices=CPU8))
    assert port.engine.name == "mesh"
    data = rng.integers(0, 256, (10, 3001), dtype=np.uint8)
    parity = port.encode(data)
    assert np.array_equal(parity, ref.encode(data))
    shards = list(np.concatenate([data, parity]))
    got, want = list(shards), list(shards)
    for i in (1, 4, 10, 13):
        got[i] = want[i] = None
    port.reconstruct(got)
    ref.reconstruct(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert np.array_equal(np.stack(got), np.concatenate([data, parity]))


SPECS = [None, "", "all", " all ", "3", 5, "3,", "5,2", "0,7,1", "0", "9",
         "x", "1,1", "5,9", ",", "2,x", "-1,"]


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_parse_device_spec_vocabulary_and_errors(spec):
    """Index stand-ins for the devices, so which ones were picked shows;
    errors must match the reference's in type and message."""
    devices = list(range(8))
    try:
        want = ref_mesh.parse_device_spec(spec, devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.parse_device_spec(spec, devices)
        assert str(got.value) == str(e)
    else:
        assert mesh.parse_device_spec(spec, devices) == want
    # the reference's own devices, by default, against CPU lanes
    try:
        n = len(ref_mesh.parse_device_spec(spec))
    except ValueError:
        with pytest.raises(ValueError):
            mesh.parse_device_spec(spec, CPU8)
    else:
        assert mesh.parse_device_spec(spec, CPU8) == CPU8[:n]


def test_lanes_need_a_card_unless_they_are_cpu():
    assert resolve_lanes(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert mesh.lanes_for(CPU8[:3]) == CPU8[:3]
    # a spec over a CPU entry point's lanes: the CPU alone
    assert mesh.lanes_for("all", "cpu") == [torch.device("cpu")]
    assert mesh.lanes_for("1", torch.device("cpu")) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="out of range"):
        mesh.lanes_for("2", "cpu")
    if not torch.cuda.is_available():
        for call in (visible_lanes, lambda: resolve_lanes(None),
                     lambda: resolve_lanes(["cpu", "cuda"]),
                     lambda: mesh.parse_device_spec("all"),
                     lambda: MeshEngine()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
    with pytest.raises(ValueError, match="empty lane list"):
        resolve_lanes([])


def test_factor_mesh_matches_the_reference():
    for n in range(1, 17):
        assert mesh.factor_mesh(n) == ref_mesh.factor_mesh(n)


# --- DrainerGroup -------------------------------------------------------

def _group_run(cls, fail_lane=None):
    """Three lanes, 12 items round-robin; each lane's fetch sleeps a
    little longer for earlier items, so completions race across lanes.
    Returns each lane's write order and the error finish() raised."""
    written: dict[int, list[int]] = {0: [], 1: [], 2: []}
    lock = threading.Lock()

    def fetch(meta):
        lane, i = meta
        time.sleep(0.002 * (12 - i) / 12)
        if lane == fail_lane and i >= 4:
            raise OSError(f"lane {lane} fetch {i} failed")
        return i * 10

    def write(meta, result):
        lane, i = meta
        assert result == i * 10
        with lock:
            written[lane].append(i)

    group = cls(3, fetch, write, queue_depth=8)
    assert group.pool_size == 3
    for i in range(12):
        group.submit(i % 3, (i % 3, i))
    err = None
    try:
        group.finish()
    except OSError as e:
        err = e
    return written, err, group


@pytest.mark.parametrize("cls", [RefDrainerGroup, DrainerGroup],
                         ids=["reference", "port"])
def test_drainer_group_keeps_fifo_per_lane(cls):
    written, err, group = _group_run(cls)
    assert err is None and group.error is None and group.inflight == 0
    assert written == {lane: list(range(lane, 12, 3)) for lane in range(3)}


@pytest.mark.parametrize("cls", [RefDrainerGroup, DrainerGroup],
                         ids=["reference", "port"])
def test_drainer_group_raises_the_first_lane_error(cls):
    written, err, group = _group_run(cls, fail_lane=1)
    assert isinstance(err, OSError) and "lane 1 fetch 4 failed" in str(err)
    assert group.error is err
    # the failing lane writes nothing after its error; the others all
    assert written[1] == [1]
    assert written[0] == [0, 3, 6, 9] and written[2] == [2, 5, 8, 11]
    # a submit after the error re-raises it
    with pytest.raises(OSError):
        group.submit(1, (1, 99))


@pytest.mark.parametrize("cls", [RefDrainerGroup, DrainerGroup],
                         ids=["reference", "port"])
def test_drainer_group_abort_fans_out(cls):
    gate = threading.Event()
    written = []

    def fetch(meta):
        gate.wait(5)
        return meta

    group = cls(4, fetch, lambda meta, r: written.append(meta))
    for i in range(8):
        group.submit(i % 4, i)
    assert group.inflight == 8 and not group.aborting
    group.aborting = True
    assert all(d.aborting for d in group.drainers) and group.aborting
    gate.set()
    group.abort()
    # aborted lanes write nothing and keep no error
    assert written == [] and group.error is None
    assert all(d.aborting for d in group.drainers)
