"""Multi-card GF(2^8) products over lanes: the port of
seaweedfs_tpu/parallel/mesh.py.

A lane is a torch.device with a copy and a compute stream of its own.
One process drives every lane, as the reference drives its mesh from one
``jit``: no torch.distributed, no NCCL, no rendezvous.  A lane list may
name one card several times; each lane still has its own streams.

The reference's three mesh axes keep their meaning:

  - "dp" and "sp": the byte stream [K, S, B] is cut into dp x sp blocks,
    S over dp and B over sp.  Blocks need no communication: parity is
    pointwise in the byte stream.
  - "tp": the contraction.  The TPU splits the 8K bit-plane rows over tp
    and folds int32 popcounts with ``psum`` before the mod 2.  Here lane
    t of a block runs kernel 1 on its own slice of shard rows,
    ``M[:, k0:k1] . data[k0:k1]``, and the tp partials are copied to the
    block's first lane and folded with ``bitwise_xor_``.  GF(2^8)
    addition is XOR, so the fold is exact.

The ring rebuild hops one accumulator around the ring instead of the
TPU's ``ppermute``: ``acc = acc.to(next_lane) ^ partial``, ring - 1
times, each partial kernel 1 on that lane's K/ring survivors.  In the GF
domain the survivors' columns are contiguous, so ``ring_plane_layout``
has no counterpart.

Every product is csrc/gf_matmul.cu through ``gf_matmul`` on its lane (a
CPU lane runs the plain version); the fold and the hops are the
collectives' counterparts, not kernels.  ``device_encode_fn``, the
one-card program of the per-card dispatch queues, is ``_Lane.launch`` in
ec/streaming.py: kernel 1 on the lane's compute stream between its
copies.  Its u32 lane packing was for the TPU's link and is dropped, as
in ops/gf_matmul.py.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..ops.gf_matmul import gf_matmul, resolve_device

# resident matrices per lane set: every erasure pattern is its own matrix
MATRIX_CACHE = 8


def visible_lanes() -> list[torch.device]:
    """One lane for each card this process sees: cuda:0 ... cuda:N-1.
    Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass CPU lanes "
                           "for the plain PyTorch version")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_lanes(devices=None) -> list[torch.device]:
    """A lane list: None is every visible card; else each entry resolved
    as ``resolve_device`` does, so a "cuda" lane needs a card and raises
    without one, and only "cpu" lanes select the plain versions.  A list
    may name one device several times: each lane still gets its own
    streams."""
    if devices is None:
        return visible_lanes()
    lanes = [resolve_device(d) for d in devices]
    if not lanes:
        raise ValueError("empty lane list")
    return lanes


def parse_device_spec(spec=None, devices: list | None = None) -> list:
    """The `-ec.mesh.devices` flag vocabulary -> a concrete lane list:

      ''/None/'all'  every visible card (or every entry of ``devices``)
      'N'            the first N (a bare integer is a COUNT)
      'i,j,k'        exactly those indices ('3,' selects index 3 -- the
                     trailing comma forces index form)

    ValueError on empty selections, non-integers, out-of-range or
    duplicate indices: the flag fails at server start, not at the first
    encode.  ``devices`` defaults to every visible card."""
    devices = list(devices) if devices is not None else visible_lanes()
    if spec is None:
        return list(devices)
    if isinstance(spec, int):
        spec = str(spec)
    s = str(spec).strip()
    if s in ("", "all"):
        return list(devices)
    if "," not in s:
        try:
            n = int(s)
        except ValueError:
            raise ValueError(
                f"bad -ec.mesh.devices {spec!r}: expected '', 'all', a "
                f"device count, or comma-separated indices") from None
        if not 1 <= n <= len(devices):
            raise ValueError(
                f"-ec.mesh.devices={n} out of range: have "
                f"{len(devices)} device(s)")
        return list(devices[:n])
    try:
        idxs = [int(t) for t in s.split(",") if t.strip() != ""]
    except ValueError:
        raise ValueError(
            f"bad -ec.mesh.devices {spec!r}: indices must be "
            f"integers") from None
    if not idxs:
        raise ValueError(f"bad -ec.mesh.devices {spec!r}: empty selection")
    if len(set(idxs)) != len(idxs):
        raise ValueError(
            f"bad -ec.mesh.devices {spec!r}: duplicate indices")
    bad = [i for i in idxs if not 0 <= i < len(devices)]
    if bad:
        raise ValueError(
            f"-ec.mesh.devices indices {bad} out of range: have "
            f"{len(devices)} device(s)")
    return [devices[i] for i in idxs]


def lanes_for(devices=None, device=None) -> list:
    """A caller's lanes: a list or tuple is taken as it is (it may repeat
    a device), anything else is an -ec.mesh.devices spec over the visible
    lanes.  Those are every visible card, unless ``device`` (the entry
    point's one-card device) is the CPU: then the CPU alone."""
    if isinstance(devices, (list, tuple)):
        return resolve_lanes(devices)
    if device is not None and torch.device(device).type == "cpu":
        return parse_device_spec(devices, [torch.device(device)])
    return parse_device_spec(devices)


class Lane:
    """A device with a copy and a compute stream of its own (none on the
    CPU, where every call runs to its end at once)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.copy = self.compute = None
        if device.type == "cuda":
            self.copy = torch.cuda.Stream(device)
            self.compute = torch.cuda.Stream(device)

    def after(self, other: "Lane") -> None:
        """Order this lane's compute stream after ``other``'s."""
        if self.compute is not None:
            self.compute.wait_stream(other.compute)


def factor_mesh(n_devices: int) -> tuple[int, int, int]:
    """Factor n into (dp, sp, tp), preferring all three axes real."""
    tp = 2 if n_devices % 2 == 0 else 1
    rem = n_devices // tp
    sp = 2 if rem % 2 == 0 else 1
    dp = rem // sp
    return dp, sp, tp


class Mesh:
    """A [dp, sp, tp] array of lanes.  ``devices`` holds their
    torch.devices, ``lanes`` the Lane objects (streams included) in the
    same shape."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = tuple(int(x) for x in devices.shape)
        flat = np.empty(devices.size, dtype=object)
        flat[:] = [Lane(d) for d in devices.reshape(-1)]
        self.lanes = flat.reshape(devices.shape)
        self.on_card = any(d.type == "cuda" for d in devices.reshape(-1))


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1,
              devices: list | None = None) -> Mesh:
    devices = resolve_lanes(devices)
    n = dp * sp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(dp, sp, tp))


def split_rows(k: int, parts: int) -> list[int]:
    """Row bounds of k shard rows cut into ``parts`` slices: slice t is
    rows [bounds[t], bounds[t + 1]), possibly empty when k < parts."""
    return [t * k // parts for t in range(parts + 1)]


class LaneMatrices:
    """Each lane's column slice ``M[:, k0:k1]`` of a GF matrix, resident on
    the lane's device, for the last MATRIX_CACHE matrices.  Lane i of
    ``lanes`` owns slice ``i % parts`` of ``split_rows(K, parts)``.  Safe
    to share between threads."""

    def __init__(self, lanes: list, parts: int):
        self.lanes = lanes
        self.parts = parts
        self._cache: OrderedDict[bytes, list] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, m: np.ndarray) -> list:
        m = np.ascontiguousarray(m, dtype=np.uint8)
        key = m.tobytes() + repr(m.shape).encode()
        with self._lock:
            got = self._cache.get(key)
            if got is not None:
                self._cache.move_to_end(key)
                return got
        bounds = split_rows(m.shape[1], self.parts)
        got = []
        for i, lane in enumerate(self.lanes):
            t = i % self.parts
            k0, k1 = bounds[t], bounds[t + 1]
            got.append(torch.from_numpy(np.ascontiguousarray(
                m[:, k0:k1])).to(lane.device) if k1 > k0 else None)
        if any(lane.device.type == "cuda" for lane in self.lanes):
            # the uploads ran on the current streams; the lanes' own
            # streams must not read the matrices before they land
            for d in {lane.device for lane in self.lanes}:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)
        with self._lock:
            self._cache[key] = got
            self._cache.move_to_end(key)
            while len(self._cache) > MATRIX_CACHE:
                self._cache.popitem(last=False)
        return got


class BlockBuffers:
    """The device buffers of one split dispatch over ``mesh``: each
    lane's input rows [k_t, w] and partial [R, w], and where a partial
    lives on another card than its block's first lane, the buffer it is
    copied into there.

    The allocator hands them out on each device's current stream and
    does not see the lanes' streams.  So the lanes' streams wait for the
    current streams here, and the owner keeps the buffers referenced
    until every event of the dispatches that use them has completed:
    freed earlier, they could go to another thread's call while this
    one's copies and kernels are still queued."""

    def __init__(self, mesh: Mesh, k: int, r: int, w: int):
        tp = mesh.shape[2]
        bounds = split_rows(k, tp)
        rows = [bounds[t + 1] - bounds[t] for t in range(tp)]
        home_t = next(t for t in range(tp) if rows[t])
        flat = mesh.lanes.reshape(-1, tp)
        self.inp: list = []
        self.part: list = []
        self.recv: list = []
        for blk in flat:
            home = blk[home_t]
            for t, lane in enumerate(blk):
                d = lane.device
                cuda = d.type == "cuda"
                live = rows[t] > 0
                self.inp.append(torch.empty((rows[t], w), dtype=torch.uint8,
                                            device=d)
                                if live and cuda else None)
                self.part.append(torch.empty((r, w), dtype=torch.uint8,
                                             device=d) if live else None)
                self.recv.append(
                    torch.empty((r, w), dtype=torch.uint8,
                                device=home.device)
                    if live and cuda and t != home_t and d != home.device
                    else None)
        for lane in mesh.lanes.reshape(-1):
            if lane.compute is not None:
                cur = torch.cuda.current_stream(lane.device)
                lane.copy.wait_stream(cur)
                lane.compute.wait_stream(cur)


def dispatch_blocks(mesh: Mesh, mats: list, src: torch.Tensor,
                    dst: torch.Tensor, bufs: BlockBuffers) -> list:
    """``dst[:, blk] = XOR over t of mats[i] . src[rows_t, blk]`` for each
    of the dp*sp column blocks ``blk`` of the host tensors src [K, Q*w]
    and dst [R, Q*w]: block b runs on lanes ``mesh.lanes[d, s, :]`` (b =
    d*sp + s), lane t on rows ``split_rows(K, tp)[t:t + 2]``, and its
    partials fold on the block's first lane with rows.  On a card
    everything is queued on the lanes' streams (src and dst should be
    pinned) and the events marking each block home are returned; on the
    CPU the work is done when it returns.  ``mats`` and ``bufs`` must
    stay referenced until those events have completed."""
    dp, sp, tp = mesh.shape
    q = dp * sp
    k, width = src.shape
    r = dst.shape[0]
    w = width // q
    if w * q != width or tuple(dst.shape) != (r, width):
        raise ValueError(f"src {tuple(src.shape)} / dst {tuple(dst.shape)} "
                         f"do not split into {q} blocks")
    bounds = split_rows(k, tp)
    flat = mesh.lanes.reshape(-1, tp)
    events = []
    for b in range(q):
        c0, c1 = b * w, (b + 1) * w
        live = []
        for t in range(tp):
            k0, k1 = bounds[t], bounds[t + 1]
            if k1 == k0:
                continue
            i = b * tp + t
            lane = flat[b][t]
            live.append((i, lane))
            if lane.compute is None:
                gf_matmul(mats[i], src[k0:k1, c0:c1], out=bufs.part[i])
                continue
            inp = bufs.inp[i]
            with torch.cuda.stream(lane.copy):
                for row in range(k0, k1):
                    inp[row - k0].copy_(src[row, c0:c1], non_blocking=True)
            lane.compute.wait_stream(lane.copy)
            with torch.cuda.stream(lane.compute):
                gf_matmul(mats[i], inp, out=bufs.part[i])
        hi, home = live[0]
        acc = bufs.part[hi]
        with torch.cuda.stream(home.compute):
            for i, lane in live[1:]:
                p = bufs.part[i]
                if lane.device == home.device:
                    home.after(lane)
                else:
                    # the copy runs on the producer's stream; torch orders
                    # it after home.compute and home.compute after it
                    with torch.cuda.stream(lane.compute):
                        p = bufs.recv[i].copy_(p, non_blocking=True)
                acc.bitwise_xor_(p)
        if home.copy is None:
            dst[:, c0:c1].copy_(acc)
            continue
        home.copy.wait_stream(home.compute)
        with torch.cuda.stream(home.copy):
            for j in range(r):
                dst[j, c0:c1].copy_(acc[j], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(home.copy)
        events.append(ev)
    return events


def _host_u8(x) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x
    if t.dtype != torch.uint8:
        raise ValueError("GF products take uint8")
    return t.cpu()


def sharded_encode_fn(mesh: Mesh):
    """The sharded encode (sharded_encode_fn, :149-181): (m [R, K] GF
    matrix, data [K, S, B]) -> parity [R, S, B] on the host, S split over
    dp, B over sp, and the K shard rows over tp.  ValueError when 8K does
    not split over tp, as the reference's bit-plane split, or S or B does
    not split over dp or sp."""
    dp, sp, tp = mesh.shape
    mats = LaneMatrices(list(mesh.lanes.reshape(-1)), tp)

    def encode(m, data) -> torch.Tensor:
        m = _host_u8(m)
        data = _host_u8(data)
        r, k = m.shape
        if (8 * k) % tp:
            raise ValueError(f"8*K={8 * k} not divisible by tp={tp}")
        if data.dim() != 3 or data.shape[0] != k:
            raise ValueError(f"data {tuple(data.shape)} is not [{k}, S, B]")
        _, s, b = data.shape
        if s % dp or b % sp:
            raise ValueError(f"[K, S, B] = {tuple(data.shape)} does not "
                             f"split over dp={dp}, sp={sp}")
        s1, b1 = s // dp, b // sp
        q, w = dp * sp, s1 * b1
        if w == 0:
            return torch.empty((r, s, b), dtype=torch.uint8)
        # the (d, s) block of [K, S, B] becomes columns [b*w, (b+1)*w)
        src = data.reshape(k, dp, s1, sp, b1).permute(0, 1, 3, 2, 4) \
            .reshape(k, q * w)
        if mesh.on_card:
            src = src.pin_memory()
        dst = torch.empty((r, q * w), dtype=torch.uint8,
                          pin_memory=mesh.on_card)
        mat = mats.get(m.numpy())
        bufs = BlockBuffers(mesh, k, r, w)
        # mat and bufs outlive every queued copy and kernel (BlockBuffers)
        for ev in dispatch_blocks(mesh, mat, src, dst, bufs):
            ev.synchronize()
        return dst.reshape(r, dp, sp, s1, b1).permute(0, 1, 3, 2, 4) \
            .reshape(r, s, b)

    return encode


def training_step_fn(mesh: Mesh):
    """The full step (training_step_fn, :184-201): the sharded encode,
    then the degraded self-check -- data shard 0 re-derived from shards
    1..K-1 and parity row 0 through ``decode_m`` [1, K] -- and its
    mismatch count.  (m, decode_m, data [K, S, B]) -> (parity, int)."""
    encode = sharded_encode_fn(mesh)

    def step(m, decode_m, data):
        data = _host_u8(data)
        parity = encode(m, data)
        recovered = encode(decode_m, torch.cat([data[1:], parity[:1]]))
        return parity, int((recovered[0] != data[0]).sum())

    return step


def ring_rebuild_fn(mesh: Mesh):
    """The ring rebuild (ring_rebuild_fn, :204-278) over every lane of
    ``mesh`` in order: (rec [M, K] GF matrix, survivors [K, B]) -> [M, B]
    on the host.  Lane j holds survivors [j*K/ring, (j+1)*K/ring), runs
    kernel 1 on them with its columns of ``rec``, and the accumulator
    hops lane to lane, each hop XORing in the next partial."""
    ring = list(mesh.lanes.reshape(-1))
    n = len(ring)
    mats = LaneMatrices(ring, n)

    def rebuild(rec, shards) -> torch.Tensor:
        rec = _host_u8(rec)
        shards = _host_u8(shards)
        m, k = rec.shape
        if k % n or shards.shape[0] != k:
            raise ValueError(f"{shards.shape[0]} survivors for K={k} do not "
                             f"split over a ring of {n}")
        kl = k // n
        mat = mats.get(rec.numpy())
        parts = []
        for j, lane in enumerate(ring):
            x = shards[j * kl:(j + 1) * kl]
            with torch.cuda.stream(lane.compute):
                parts.append(gf_matmul(
                    mat[j], x.to(lane.device, non_blocking=True)))
        acc = parts[0]
        for j in range(1, n):
            lane, prev = ring[j], ring[j - 1]
            with torch.cuda.stream(lane.compute):
                if lane.device == prev.device:
                    lane.after(prev)
                else:
                    with torch.cuda.stream(prev.compute):
                        acc = acc.to(lane.device, non_blocking=True)
                acc = parts[j].bitwise_xor_(acc)
        with torch.cuda.stream(ring[-1].compute):
            return acc.cpu()

    return rebuild
