"""The delivery step of every tick: the CUDA kernel ``csrc/deliver.cu``
on the card, its plain PyTorch version (``netsim.deliver_reference``)
on the CPU.

Replaces the Pallas kernel ``maelstrom_tpu/ops/delivery.py``
(``_deliver_kernel`` via ``deliver_pallas``). The kernel is memory
bound: at I=4096, NT=9, L=20 it must move 13,799,424 B at S=16, K=1
(the flagship lin-kv run: 0.004119 ms at 3.35 TB/s) and 107,843,584 B
at S=128, K=8 (the CLI defaults: 0.032192 ms).

Design (the header of ``csrc/deliver.cu`` has the details), against
the limits of the first kernel of this port, which gave one block of
256 threads to a few instances:

- one warp per instance and only ``__syncwarp`` between phases, so
  there is no block-wide barrier and I=4096 puts 4096 warps on the
  card instead of 256 blocks run phase after phase;
- selection by rank with warp ballots and shared-memory broadcasts,
  instead of K serial max-scans over S slots by one thread per
  (instance, endpoint) with most of the block idle;
- 16-byte ``cp.async`` loads and 16-byte stores where ``L % 4 == 0``,
  neighbouring lanes on neighbouring addresses, instead of scalar loads
  and per-thread row stores 80 B apart;
- a shared-memory row stride padded to an odd number of 16-byte units
  (of words on the 4-byte path), so the lanes reading slot headers hit
  distinct banks.

:func:`geometry` sizes the launch; :func:`deliver` is the entry point.

The minor carry layout keeps the pool batch-last, ``[S, L, I]``. Its
entry, :func:`deliver_minor`, launches ``deliver_minor_kernel`` of the
same source: a block of W warps for each W neighbouring instances (W =
8 wherever the block fits in shared memory), a warp per instance. The
block stages its tile of the pool, ``[S, L, W]``, and its partition
planes into shared memory with ``cp.async`` (16-byte units of four
instances where ``I % 4 == 0``), classifies and ranks each instance's
slots with warp ballots as the lead kernel does (bucketed by endpoint
above 128 slots), and writes pool' row by row and the tile's inbox as
one contiguous stretch from shared memory, with two block barriers in
all (the source's second header has the design). Where one instance's rows do not fit, the same
kernel reads them straight from device memory. It replaces no Pallas
kernel (the JAX package's minor layout runs XLA); it exists because the
card's main path runs no plain version. :func:`minor_geometry` sizes
it; its plain version is ``netsim.deliver_reference_minor``. The two
entries count their launches apart.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from .. import netsim
from ..netsim import NetConfig

SOURCE = "deliver"
# the kernels' symbols, as the profiler names them
KERNEL_NAME = "deliver_warp_kernel"
MINOR_KERNEL_NAME = "deliver_minor_kernel"
MAX_SLOTS = 256
SMEM_OPTIN_BYTES = 232_448      # an H100 block's shared-memory limit
_MAX_WARPS_PER_BLOCK = 4
# the batch-last kernel stages a tile's partition planes up to this size
MINOR_PLANE_BYTES = 4096


class Geometry(NamedTuple):
    row_stride: int       # int32 per staged row in shared memory
    warp_bytes: int       # shared memory of one warp (one instance)
    warps_per_block: int  # the launch has ceil(I / warps_per_block) blocks


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def geometry(S: int, L: int, NT: int, K: int, vec: bool) -> Geometry:
    """The launch shape of one delivery round: the same layout as
    ``warp_smem`` in ``csrc/deliver.cu`` (staged rows, compacted
    (priority, tag) pairs, cleared-slot masks, the (endpoint, k) -> slot
    table), which the kernel's launcher checks."""
    if not (1 <= S <= MAX_SLOTS and 1 <= K <= S and NT >= 1 and L >= 8):
        raise ValueError(f"deliver: no geometry for S={S} L={L} NT={NT} "
                         f"K={K} (1 <= K <= S <= {MAX_SLOTS}, L >= 8)")
    if vec:
        units = L // 4
        rs = L if units % 2 else L + 4
    else:
        rs = L if L % 2 else L + 1
    spl = 1 if S <= 32 else 2 if S <= 64 else 4 if S <= 128 else 8
    warp_bytes = _round16(_round16(S * rs * 4) + 8 * S + 4 * spl
                          + 2 * NT * K)
    if warp_bytes > SMEM_OPTIN_BYTES:
        raise ValueError(f"deliver: one instance needs {warp_bytes} B of "
                         f"shared memory (limit {SMEM_OPTIN_BYTES})")
    wpb = max(1, min(_MAX_WARPS_PER_BLOCK, SMEM_OPTIN_BYTES // warp_bytes))
    return Geometry(rs, warp_bytes, wpb)


class MinorGeometry(NamedTuple):
    instances: int    # W: instances (warps) a block, ceil(I / W) blocks
    slot_stride: int  # int32 a staged slot in shared memory (0: unstaged)
    smem_bytes: int   # shared memory of one block
    vec: bool         # 16-byte units of four instances (staged only)
    staged: bool      # the tile's rows in shared memory


def _minor_stride(L: int, W: int, vec: bool) -> int:
    """The staged slot stride: ``L * W`` padded to an odd number of
    16-byte units (of words on the 4-byte path), so lanes reading the
    headers of consecutive slots spread over the banks."""
    ss = L * W
    if vec:
        ss = -(-ss // 4) * 4
        return ss + 4 if (ss // 4) % 2 == 0 else ss
    return ss + 1 if ss % 2 == 0 else ss


@functools.lru_cache(maxsize=64)
def minor_geometry(S: int, L: int, NT: int, K: int,
                   vec: bool) -> MinorGeometry:
    """The launch shape of one batch-last round, as ``minor_geometry`` in
    ``csrc/deliver.cu`` (which the launcher checks): the largest W of 8,
    4, 2, 1 whose block fits in shared memory: the staged tile ``[S, L,
    W]``, then the compacted entries ``[W, S]``, the bucket offsets
    ``[W, NT + 1]``, the cleared bytes ``[S, 8]``, the (endpoint, k) ->
    slot tables ``[W, NT * K]`` and the tile's partition planes where
    they take at most ``MINOR_PLANE_BYTES``. Where not even one
    instance's rows fit, the unstaged branch (the tables alone, 4-byte
    units). ``vec`` asks for 16-byte units (``I % 4 == 0`` and aligned
    pointers); they need W >= 4. Raises for a shape the kernel does not
    take."""
    if not (1 <= S <= MAX_SLOTS and 1 <= K <= S and NT >= 1 and L >= 8):
        raise ValueError(f"deliver_minor: no geometry for S={S} L={L} "
                         f"NT={NT} K={K} (1 <= K <= S <= {MAX_SLOTS}, "
                         f"L >= 8)")
    widths = (8, 4, 2, 1)
    aux = {W: 8 * W * S + 4 * W * (NT + 1) + 8 * S + 2 * W * NT * K
           + (W * NT * NT + 32 if W * NT * NT <= MINOR_PLANE_BYTES else 0)
           for W in widths}
    for W in widths:
        v = vec and W % 4 == 0
        ss = _minor_stride(L, W, v)
        smem = _round16(_round16(4 * S * ss) + aux[W])
        if smem <= SMEM_OPTIN_BYTES:
            return MinorGeometry(W, ss, smem, v, True)
    for W in widths:
        smem = _round16(aux[W])
        if smem <= SMEM_OPTIN_BYTES:
            return MinorGeometry(W, 0, smem, False, False)
    raise ValueError(f"deliver_minor: one instance's tables need "
                     f"{_round16(aux[1])} B of shared memory (limit "
                     f"{SMEM_OPTIN_BYTES})")


_launch_fn = None
_minor_launch_fn = None


def _resolve(symbol: str, n_int: int):
    """A launch function of the built library: ``symbol``, with ``n_int``
    int arguments after the seven pointers and ``t``, then the
    stream."""
    from . import build
    fn = getattr(build.load(SOURCE), symbol)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launcher():
    """``deliver_launch`` of the built library, resolved once."""
    global _launch_fn
    if _launch_fn is None:
        _launch_fn = _resolve("deliver_launch", 9)
    return _launch_fn


def _minor_launcher():
    """``deliver_minor_launch`` of the built library, resolved once."""
    global _minor_launch_fn
    if _minor_launch_fn is None:
        _minor_launch_fn = _resolve("deliver_minor_launch", 9)
    return _minor_launch_fn


def _check_partitions(partitions: torch.Tensor, pool: torch.Tensor,
                      I: int, NT: int, name: str) -> None:
    if partitions.dtype not in (torch.bool, torch.uint8) \
            or tuple(partitions.shape) != (I, NT, NT) \
            or not partitions.is_contiguous():
        raise ValueError(
            f"{name}: partitions must be contiguous bool/uint8 "
            f"[{I}, {NT}, {NT}], got {partitions.dtype} "
            f"{tuple(partitions.shape)}")
    if partitions.device != pool.device:
        raise ValueError(f"{name}: pool and partitions on different "
                         f"devices")


def _count(entry, dev: torch.device) -> None:
    entry.launches += 1
    by_dev = entry.launches_by_device
    by_dev[str(dev)] = by_dev.get(str(dev), 0) + 1


def deliver_cuda(pool: torch.Tensor, partitions: torch.Tensor, t: int,
                 cfg: NetConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Launch the delivery kernel on the current stream."""
    I, S, L = pool.shape
    NT, K = cfg.n_total, cfg.inbox_k
    if pool.dtype != torch.int32 or not pool.is_contiguous():
        raise ValueError("deliver: pool must be contiguous int32 [I, S, L]")
    _check_partitions(partitions, pool, I, NT, "deliver")
    if L != cfg.lanes or S != cfg.pool_slots or K > S:
        raise ValueError(f"deliver: pool shape {tuple(pool.shape)} does "
                         f"not match the net config")
    dev = pool.device
    pool_out = torch.empty_like(pool)
    inbox = torch.empty((I, NT, K, L), dtype=torch.int32, device=dev)
    n_del = torch.empty((I,), dtype=torch.int32, device=dev)
    n_drop = torch.empty((I,), dtype=torch.int32, device=dev)
    if I == 0:
        return pool_out, inbox, n_del, n_drop
    vec = L % 4 == 0 and all(x.data_ptr() % 16 == 0
                             for x in (pool, pool_out, inbox))
    geo = geometry(S, L, NT, K, vec)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pool.data_ptr(), partitions.data_ptr(), int(t),
                 pool_out.data_ptr(), inbox.data_ptr(), n_del.data_ptr(),
                 n_drop.data_ptr(), I, S, L, NT, K, geo.row_stride,
                 geo.warp_bytes, geo.warps_per_block, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"deliver kernel launch failed: CUDA error {err}")
    _count(deliver, dev)
    return pool_out, inbox, n_del, n_drop


def deliver_minor_cuda(pool: torch.Tensor, partitions: torch.Tensor, t: int,
                       cfg: NetConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Launch the batch-last delivery kernel on the current stream."""
    S, L, I = pool.shape
    NT, K = cfg.n_total, cfg.inbox_k
    if pool.dtype != torch.int32 or not pool.is_contiguous():
        raise ValueError("deliver_minor: pool must be contiguous int32 "
                         "[S, L, I]")
    _check_partitions(partitions, pool, I, NT, "deliver_minor")
    if L != cfg.lanes or S != cfg.pool_slots or K > S or L < 8:
        raise ValueError(f"deliver_minor: pool shape {tuple(pool.shape)} "
                         f"does not match the net config")
    dev = pool.device
    pool_out = torch.empty_like(pool)
    inbox = torch.empty((I, NT, K, L), dtype=torch.int32, device=dev)
    n_del = torch.empty((I,), dtype=torch.int32, device=dev)
    n_drop = torch.empty((I,), dtype=torch.int32, device=dev)
    if I == 0:
        return pool_out, inbox, n_del, n_drop
    vec = I % 4 == 0 and all(x.data_ptr() % 16 == 0
                             for x in (pool, pool_out))
    geo = minor_geometry(S, L, NT, K, vec)
    fn = _minor_launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pool.data_ptr(), partitions.data_ptr(), int(t),
                 pool_out.data_ptr(), inbox.data_ptr(), n_del.data_ptr(),
                 n_drop.data_ptr(), I, S, L, NT, K, geo.instances,
                 geo.slot_stride, geo.smem_bytes, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"deliver_minor kernel launch failed: CUDA "
                           f"error {err}")
    _count(deliver_minor, dev)
    return pool_out, inbox, n_del, n_drop


def deliver(pool: torch.Tensor, partitions: torch.Tensor, t: int,
            cfg: NetConfig):
    """One delivery round for ``pool [I, S, L]``: the kernel for a CUDA
    tensor, the plain version for a CPU tensor. Returns ``(pool', inbox
    [I, NT, K, L], n_delivered [I], n_dropped [I])``."""
    if pool.is_cuda:
        return deliver_cuda(pool, partitions, t, cfg)
    return netsim.deliver_reference(pool, partitions, t, cfg)


def deliver_minor(pool: torch.Tensor, partitions: torch.Tensor, t: int,
                  cfg: NetConfig):
    """One delivery round for the batch-last ``pool [S, L, I]``: the
    batch-last kernel for a CUDA tensor, the plain version for a CPU
    tensor. Returns ``(pool' [S, L, I], inbox [I, NT, K, L], n_delivered
    [I], n_dropped [I])``."""
    if pool.is_cuda:
        return deliver_minor_cuda(pool, partitions, t, cfg)
    return netsim.deliver_reference_minor(pool, partitions, t, cfg)


def reset_launches() -> None:
    """Set both entries' launch counts to 0 (a run reads them after)."""
    for entry in (deliver, deliver_minor):
        entry.launches = 0
        entry.launches_by_device = {}


# launches of each kernel, in all and by device ("cuda:0": n):
# incremented where it is launched and nowhere else, so a run can show
# that its delivery went through the kernel on every device it used
reset_launches()
