"""Reed-Solomon codec over GF(2^8) on TorchEngine or MeshEngine.

Semantics-compatible with the reference's klauspost/reedsolomon usage:
``Encode`` fills parity shards (ec_encoder.go:179), ``Reconstruct`` fills any
missing shards from >= data_shards survivors (ec_encoder.go:270,
store_ec.go:331), ``ReconstructData`` only restores data shards
(store_ec.go:367).  The heavy operation in all three is one GF matmul
``out[R,B] = M[R,K] . shards[K,B]``, which ops.gf_matmul runs: the CUDA
kernel for ``device="cuda"``, the plain PyTorch version for "cpu".
``MeshEngine`` (seaweedfs_tpu/ec/codec.py:118-193) is the codec's face of
``-ec.engine mesh``: one product split over a [dp, sp, tp] mesh of lanes
(parallel/mesh.py), every lane's share kernel 1.

Port of seaweedfs_tpu/ec/codec.py's ReedSolomon without its engine
fallback: a kernel that fails raises to the caller, it is never replaced
by a CPU recomputation (so there is no ``engine_fallback`` event either).

The ``ec.encode`` and ``ec.reconstruct`` spans bound the card's time too:
TorchEngine hands back host bytes, so the copy home ends inside them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..observability import get_tracer
from ..ops.gf_matmul import TorchEngine
from ..parallel.mesh import (factor_mesh, lanes_for, make_mesh,
                             sharded_encode_fn)
from .gf256 import build_cauchy_matrix, build_encoding_matrix, mat_invert, mat_mul


class MeshEngine:
    """GfMatmulEngine over a mesh of lanes: ONE product with the byte
    stream cut into dp x sp blocks and the K shard rows over tp, the tp
    partials folded by XOR (parallel/mesh.py ``sharded_encode_fn``).
    Host numpy in, host numpy out, byte-identical to TorchEngine; each
    lane keeps its slices of the last few matrices resident.

    ``devices`` is a lane list (which may repeat a device) or an
    -ec.mesh.devices spec over every visible card; ``mesh`` a ready
    Mesh.  The streaming encoder's per-card dispatch queues are the other
    face of the same flag (ec/streaming.py)."""

    name = "mesh"

    def __init__(self, devices=None, mesh=None):
        if mesh is None:
            lanes = lanes_for(devices)
            mesh = make_mesh(*factor_mesh(len(lanes)), devices=lanes)
        self.mesh = mesh
        self.dims = mesh.shape
        self.devices = list(mesh.devices.reshape(-1))
        self._encode = sharded_encode_fn(mesh)

    def matmul(self, m: np.ndarray, shards: np.ndarray) -> np.ndarray:
        """out[R, B] = m[R, K] . shards[K, B]; all uint8 host arrays.
        A width that does not split over dp*sp is zero-padded, and the
        pad cut off the result; ValueError when 8K does not split over
        tp."""
        dp, sp, _ = self.dims
        m = np.ascontiguousarray(m, dtype=np.uint8)
        k, width = shards.shape
        pad = (-width) % (dp * sp)
        data = np.zeros((k, width + pad), dtype=np.uint8)
        data[:, :width] = shards
        # [K, B'] -> [K, dp, B'/dp]: dp contiguous chunks of the byte
        # stream, sp splitting each; the inverse reshape restores order
        out = self._encode(m, data.reshape(k, dp, -1)).numpy()
        return out.reshape(out.shape[0], -1)[:, :width]

    def matmul_into(self, m: np.ndarray, shards: np.ndarray,
                    out: np.ndarray) -> np.ndarray:
        out[:] = self.matmul(m, shards)
        return out


class ReedSolomon:
    """One (data, parity) geometry with its cached encoding matrix."""

    def __init__(self, data_shards: int, parity_shards: int,
                 matrix_kind: str = "vandermonde", device="cuda",
                 engine=None):
        """``engine`` (a TorchEngine or MeshEngine) runs the products;
        None is ``TorchEngine(device)``."""
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("shard counts must be positive")
        if data_shards + parity_shards > 256:
            raise ValueError("too many shards for GF(2^8)")
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.total_shards = data_shards + parity_shards
        self.matrix_kind = matrix_kind
        if matrix_kind == "cauchy":
            self.matrix = build_cauchy_matrix(data_shards, self.total_shards)
        else:
            self.matrix = build_encoding_matrix(data_shards, self.total_shards)
        self.parity_matrix = self.matrix[data_shards:]
        self.engine = engine if engine is not None else TorchEngine(device)

    # --- core ---------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data[data_shards, B] -> parity[parity_shards, B]."""
        if data.shape[0] != self.data_shards:
            raise ValueError(f"expected {self.data_shards} data shards")
        with get_tracer().span("ec.encode", k=self.data_shards,
                               r=self.parity_shards, bytes=int(data.nbytes),
                               backend=self.engine.name):
            return self.engine.matmul(self.parity_matrix, data)

    def encode_into(self, data: np.ndarray, out: np.ndarray) -> np.ndarray:
        """Parity-only output variant of encode(): the product lands in
        the caller-provided out[parity_shards, B] scratch, so chunked
        encoders recycle one buffer across all chunks."""
        if data.shape[0] != self.data_shards:
            raise ValueError(f"expected {self.data_shards} data shards")
        if out.shape != (self.parity_shards, data.shape[1]) \
                or out.dtype != np.uint8 or out.strides[1] != 1:
            raise ValueError("out must be uint8 [parity_shards, B] "
                             "with contiguous rows")
        with get_tracer().span("ec.encode", k=self.data_shards,
                               r=self.parity_shards, bytes=int(data.nbytes),
                               backend=self.engine.name):
            return self.engine.matmul_into(self.parity_matrix, data, out)

    def encode_shards(self, shards: list[np.ndarray]) -> None:
        """klauspost Encode: shards[0:data] in, shards[data:total] overwritten."""
        parity = self.encode(np.stack(shards[: self.data_shards]))
        for i in range(self.parity_shards):
            shards[self.data_shards + i][:] = parity[i]

    def verify(self, shards: Sequence[np.ndarray]) -> bool:
        parity = self.encode(np.stack(shards[: self.data_shards]))
        return all(
            np.array_equal(parity[i], shards[self.data_shards + i])
            for i in range(self.parity_shards)
        )

    def reconstruct(self, shards: list[Optional[np.ndarray]],
                    data_only: bool = False) -> None:
        """Fill None entries in-place from >= data_shards survivors.

        One kernel pass for every missing shard, data and parity alike:
        every shard obeys shard_i = matrix[i] @ data (the identity top
        makes the matrix systematic) and data = inv(matrix[sub]) @
        survivors, so the missing shards are (matrix[missing] @
        inv(matrix[sub])) @ survivors.
        """
        if len(shards) != self.total_shards:
            raise ValueError(f"expected {self.total_shards} shards")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) == self.total_shards:
            return
        if len(present) < self.data_shards:
            raise ValueError("too few shards to reconstruct")
        size = next(len(shards[i]) for i in present)
        for i in present:
            if len(shards[i]) != size:
                raise ValueError("inconsistent shard sizes")

        sub_rows = present[: self.data_shards]
        upto = self.data_shards if data_only else self.total_shards
        missing = [i for i in range(upto) if shards[i] is None]
        if not missing:
            return
        with get_tracer().span(
                "ec.reconstruct", k=self.data_shards,
                r=self.parity_shards, missing=len(missing),
                bytes=size * self.data_shards, backend=self.engine.name):
            sub = [[int(v) for v in self.matrix[i]] for i in sub_rows]
            want = [[int(v) for v in self.matrix[m]] for m in missing]
            rows = np.array(mat_mul(want, mat_invert(sub)), dtype=np.uint8)
            restored = self.engine.matmul(
                rows, np.stack([shards[i] for i in sub_rows]))
            for out_i, shard_i in enumerate(missing):
                shards[shard_i] = restored[out_i]

    def reconstruct_data(self, shards: list[Optional[np.ndarray]]) -> None:
        self.reconstruct(shards, data_only=True)
