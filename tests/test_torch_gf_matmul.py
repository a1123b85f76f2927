"""The port's GF(2^8) product against seaweedfs_tpu's, on the CPU.

The same seeded numpy inputs go through the port's ``gf_matmul`` on CPU
tensors (its plain bit-plane version), seaweedfs_tpu's ``gf_matmul_xla``,
its ``CpuEngine`` LUT codec and, at a few small widths, its Pallas kernel
in interpret mode (the way tests/test_ec_codec.py runs it on the CPU).
The kernel's own scheme, its per-matrix nibble tables
(``gf_table_plain``) and its lookups (``gf_lookup_plain``), is held
against the same references, and so is the width -> (columns a thread,
blocks) choice of its launches.  Every comparison is byte-exact: GF
arithmetic is exact, the tolerance is 0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import gf256 as ref_gf
from seaweedfs_tpu.ec.codec import CpuEngine
from seaweedfs_tpu.ops.gf_matmul import (INTERPRET_TILE_B,
                                         expand_matrix_bitplanes as ref_planes,
                                         gf_matmul_pallas, gf_matmul_xla)
import seaweedfs_tpu_torch.ops.gf_matmul as gf_matmul_mod
from seaweedfs_tpu_torch.ops.gf_matmul import (BLOCKS_PER_SM,
                                               NARROW_THREADS, THREADS,
                                               TorchEngine,
                                               expand_matrix_bitplanes,
                                               gf_lookup_plain, gf_matmul,
                                               gf_matmul_plain,
                                               gf_table_build, gf_table_plain,
                                               launch_geometry, width_classes)

WIDTHS = [1, 7, 64, 1000, 4096, 65537]
XLA_WIDTH = 65664  # the widest width rounded up to 128 lanes
GEOMETRIES = [(10, 4), (6, 3), (12, 4)]
KINDS = {"vandermonde": ref_gf.build_encoding_matrix,
         "cauchy": ref_gf.build_cauchy_matrix}
ERASURES = [(0,), (2, 11), (2, 7, 12), (0, 3, 11, 13)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version's float matmul would take every core; the suite
    runs several workers side by side, some of them timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decode_rows(full: np.ndarray, k: int, missing) -> np.ndarray:
    """The composed [missing, k] rebuild matrix (ec/streaming.py)."""
    survivors = [i for i in range(full.shape[0]) if i not in missing][:k]
    decode = ref_gf.mat_invert([[int(v) for v in full[i]]
                                for i in survivors])
    return np.array(ref_gf.mat_mul([[int(v) for v in full[m]]
                                    for m in missing], decode),
                    dtype=np.uint8)


def _matrices() -> dict[str, np.ndarray]:
    out = {}
    for kind, build in KINDS.items():
        for k, r in GEOMETRIES:
            out[f"parity-{k}.{r}-{kind}"] = build(k, k + r)[k:]
        full = build(10, 14)
        for missing in ERASURES:
            out[f"decode-{len(missing)}-{kind}"] = _decode_rows(full, 10,
                                                                missing)
    return out


MATRICES = _matrices()


def _data(k: int, width: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (k, width),
                                                dtype=np.uint8)


def _port(m: np.ndarray, data: np.ndarray) -> np.ndarray:
    return gf_matmul(torch.from_numpy(m.copy()),
                     torch.from_numpy(data)).numpy()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_plain_matches_xla_and_cpu_engine(name, width):
    m = MATRICES[name]
    data = _data(m.shape[1], width, seed=width)
    got = _port(m, data)
    assert got.shape == (m.shape[0], width) and got.dtype == np.uint8
    assert np.array_equal(got, CpuEngine().matmul(m, data))
    # one XLA program per matrix shape: zero columns past the width leave
    # the product's first columns as they are
    padded = np.pad(data, ((0, 0), (0, XLA_WIDTH - width)))
    want = np.asarray(gf_matmul_xla(jnp.asarray(ref_planes(m)),
                                    jnp.asarray(padded)))[:, :width]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("width", [1, 7, 1000])
@pytest.mark.parametrize("name", ["parity-10.4-vandermonde",
                                  "parity-10.4-cauchy",
                                  "decode-4-vandermonde"])
def test_plain_matches_pallas_interpret(name, width):
    m = MATRICES[name]
    data = _data(m.shape[1], width, seed=100 + width)
    pad = (-width) % INTERPRET_TILE_B
    padded = np.pad(data, ((0, 0), (0, pad)))
    want = np.asarray(gf_matmul_pallas(jnp.asarray(ref_planes(m)),
                                       jnp.asarray(padded),
                                       tile_b=INTERPRET_TILE_B,
                                       interpret=True))[:, :width]
    assert np.array_equal(_port(m, data), want)


@pytest.mark.parametrize("name", ["parity-10.4-vandermonde",
                                  "decode-2-cauchy", "parity-12.4-cauchy"])
def test_bitplanes_match_reference(name):
    m = MATRICES[name]
    assert np.array_equal(expand_matrix_bitplanes(m), ref_planes(m))


def test_row_strided_views():
    """A streaming slot [K, b] used at width n < b: data and out are
    row-strided views; only the first n columns are touched."""
    m = MATRICES["parity-10.4-vandermonde"]
    slot = _data(10, 4096, seed=3)
    n = 1000
    out = torch.full((4, 4096), 0xAB, dtype=torch.uint8)
    gf_matmul(torch.from_numpy(m.copy()), torch.from_numpy(slot)[:, :n],
              out=out[:, :n])
    assert np.array_equal(out[:, :n].numpy(),
                          CpuEngine().matmul(m, slot[:, :n]))
    assert bool((out[:, n:] == 0xAB).all())


def test_plain_chunking_is_invisible(monkeypatch):
    m = MATRICES["decode-3-cauchy"]
    data = torch.from_numpy(_data(10, 5000, seed=4))
    mt = torch.from_numpy(m.copy())
    whole = gf_matmul_plain(mt, data)
    monkeypatch.setattr(gf_matmul_mod, "PLAIN_CHUNK", 333)
    assert torch.equal(gf_matmul_plain(mt, data), whole)


def test_cpu_tensors_never_count_launches():
    before = gf_matmul.launches
    _port(MATRICES["parity-6.3-vandermonde"], _data(6, 64, seed=5))
    assert gf_matmul.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "out_shape",
                                 "strided_rows", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    m = torch.from_numpy(MATRICES["parity-10.4-vandermonde"].copy())
    data = torch.from_numpy(_data(10, 64, seed=6))
    out = None
    if bad == "dtype":
        data = data.to(torch.int32)
    elif bad == "shape":
        data = data[:9]
    elif bad == "out_shape":
        out = torch.empty((4, 63), dtype=torch.uint8)
    elif bad == "strided_rows":
        data = data[:, ::2]
    elif bad == "device":
        m = m.to("meta")
    with pytest.raises(ValueError):
        gf_matmul(m, data, out)


def test_engine_matmul_into_and_readonly_input():
    m = MATRICES["decode-2-vandermonde"]
    data = _data(10, 777, seed=7)
    data.setflags(write=False)  # survivors read straight from bytes
    eng = TorchEngine("cpu")
    out = np.zeros((2, 777), dtype=np.uint8)
    eng.matmul_into(m, data, out)
    assert np.array_equal(out, CpuEngine().matmul(m, data))
    assert np.array_equal(eng.matmul(m, data), out)
    assert eng.name == "torch-cpu"


TWIN_WIDTHS = [1, 15, 17, 4097]


def _xla(m: np.ndarray, data: np.ndarray) -> np.ndarray:
    padded = np.pad(data, ((0, 0), (0, XLA_WIDTH - data.shape[1])))
    return np.asarray(gf_matmul_xla(jnp.asarray(ref_planes(m)),
                                    jnp.asarray(padded)))[:, :data.shape[1]]


def _twin(m: np.ndarray, data: np.ndarray) -> np.ndarray:
    return gf_lookup_plain(gf_table_plain(m), m.shape[0], data)


@pytest.mark.parametrize("width", TWIN_WIDTHS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_lookup_twin_matches_xla(name, width):
    """The kernel's nibble tables and lookups, in numpy, equal the
    reference's bit-plane product for every family the main path runs."""
    m = MATRICES[name]
    data = _data(m.shape[1], width, seed=200 + width)
    got = _twin(m, data)
    assert got.shape == (m.shape[0], width) and got.dtype == np.uint8
    assert np.array_equal(got, _xla(m, data))


@pytest.mark.parametrize("width", [1, 15, 17])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_lookup_twin_matches_pallas_interpret(name, width):
    m = MATRICES[name]
    data = _data(m.shape[1], width, seed=300 + width)
    padded = np.pad(data, ((0, 0), (0, (-width) % INTERPRET_TILE_B)))
    want = np.asarray(gf_matmul_pallas(jnp.asarray(ref_planes(m)),
                                       jnp.asarray(padded),
                                       tile_b=INTERPRET_TILE_B,
                                       interpret=True))[:, :width]
    assert np.array_equal(_twin(m, data), want)


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 9])
def test_lookup_twin_row_groups(rows):
    """R <= 4 is one group of the table; R > 4 is the wrapper's row split
    into groups of four, the last one short."""
    m = _data(rows, 10, seed=400 + rows)
    table = gf_table_plain(m)
    assert table.shape == (-(-rows // 4), 10, 32)
    # a short last group leaves its missing rows' bytes 0
    if rows % 4:
        assert not (table[-1] >> np.uint32(8 * (rows % 4))).any()
    data = _data(10, 4097, seed=500 + rows)
    assert np.array_equal(_twin(m, data), _xla(m, data))


def test_lookup_twin_on_row_strided_views():
    """A slot [K, b] used at width n from column c: the twin sees the view
    the kernel sees, and equals the reference on it."""
    m = MATRICES["decode-2-cauchy"]
    slot = _data(10, 5000, seed=6)
    view = slot[:, 3:3 + 4097]
    assert not view.flags.c_contiguous
    assert np.array_equal(_twin(m, view), _xla(m, np.ascontiguousarray(view)))


@pytest.mark.parametrize("name", ["parity-10.4-vandermonde",
                                  "decode-3-cauchy", "parity-6.3-cauchy"])
def test_table_words_are_the_field_products(name):
    """Word x of lo and of hi for row k holds, in byte r, M[r, k] times x
    and times x << 4 by the reference's multiplication table."""
    m = MATRICES[name]
    table = gf_table_plain(m)
    for r in range(m.shape[0]):
        for k in range(m.shape[1]):
            for x in range(16):
                lo = int(table[r // 4, k, x] >> (8 * (r % 4))) & 0xFF
                hi = int(table[r // 4, k, 16 + x] >> (8 * (r % 4))) & 0xFF
                assert lo == ref_gf.gf_mul(int(m[r, k]), x)
                assert hi == ref_gf.gf_mul(int(m[r, k]), x << 4)


def test_table_build_on_the_cpu_is_the_twin():
    m = MATRICES["parity-12.4-vandermonde"]
    before = gf_table_build.launches
    got = gf_table_build(torch.from_numpy(m.copy()))
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 12, 32)
    assert np.array_equal(got.numpy().view(np.uint32), gf_table_plain(m))
    assert gf_table_build.launches == before


def _covered(width: int, cols: int, threads: int,
             grid: int) -> np.ndarray:
    """How often each column is written by the kernel's grid-stride loop:
    thread t of block b takes chunks b * threads + t, then every grid *
    threads after, cols columns a chunk clipped at the width."""
    seen = np.zeros(width, dtype=np.int64)
    chunks = -(-width // cols)
    for first in range(grid * threads):
        for chunk in range(first, chunks, grid * threads):
            seen[chunk * cols:min(width, (chunk + 1) * cols)] += 1
    return seen


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("width", [1, 15, 17, 1064, 4097, 64 << 10,
                                   (1 << 20) + 3, 8 << 20])
def test_launch_geometry_covers_every_column_once(width, sms):
    cols, threads, grid = launch_geometry(width, sms)
    assert cols in (4, 16) and threads in (NARROW_THREADS, THREADS)
    assert 1 <= grid <= BLOCKS_PER_SM * sms
    # every SM gets a block wherever the width has a small block's worth
    # of four-column chunks for each
    assert grid >= min(sms, -(-width // (4 * NARROW_THREADS)))
    if width <= (64 << 10) and sms == 132:
        assert (cols, threads) == (4, NARROW_THREADS)
    if width >= 16 * THREADS * sms:
        assert (cols, threads) == (16, THREADS)
    if width <= (1 << 20) or sms == 1:
        assert (_covered(width, cols, threads, grid) == 1).all()


def test_launch_geometry_at_the_timed_widths():
    """On a 132-SM card: the 8 MiB encode walks tiles in two blocks an SM,
    1 MiB gives every SM a block of 16-column threads, 64 KiB spreads over
    256 small blocks of 4-column threads, a 1 KiB read over four."""
    assert launch_geometry(8 << 20, 132) == (16, THREADS, 264)
    assert launch_geometry(1 << 20, 132) == (16, THREADS, 256)
    assert launch_geometry(64 << 10, 132) == (4, NARROW_THREADS, 256)
    assert launch_geometry(1024, 132) == (4, NARROW_THREADS, 4)


def test_width_classes():
    from collections import Counter

    edges = Counter({1: 1, 4096: 1, 4097: 1, 65536: 1, 65537: 1,
                     1 << 20: 1, (1 << 20) + 1: 1})
    assert width_classes(edges) == {"<=4KiB": 2, "<=64KiB": 2,
                                    "<=1MiB": 2, ">1MiB": 1}
    assert width_classes(Counter({1064: 7, 8 << 20: 2, 70000: 1})) == {
        "<=4KiB": 7, "<=64KiB": 0, "<=1MiB": 1, ">1MiB": 2}


def test_cpu_tensors_never_count_widths():
    before = dict(gf_matmul.widths)
    _port(MATRICES["parity-6.3-vandermonde"], _data(6, 64, seed=8))
    assert dict(gf_matmul.widths) == before
