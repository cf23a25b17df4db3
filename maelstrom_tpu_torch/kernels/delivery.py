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
same source: a block of eight warps for each 32 instances, a lane of
each warp on one instance, the warps splitting its slots to classify
and rank them and then pool' and the inbox to move them, so a warp's
loads of ``pool[s, l, i..i+31]`` are 128 contiguous bytes (the source's
second header has the design). It replaces no Pallas kernel (the JAX package's minor layout
runs XLA); it exists because the card's main path runs no plain
version. :func:`minor_smem` sizes it; its plain version is
``netsim.deliver_reference_minor``. The two entries count their
launches apart.
"""

from __future__ import annotations

import ctypes
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


def minor_smem(S: int, NT: int, K: int) -> int:
    """Shared bytes of one block of the batch-last kernel (its 32
    instances' compacted entries, cleared masks, three counters and
    (endpoint, k) -> slot tables), as ``minor_block_smem`` in
    ``csrc/deliver.cu``; raises for a shape the kernel does not take."""
    if not (1 <= S <= MAX_SLOTS and 1 <= K <= S and NT >= 1):
        raise ValueError(f"deliver_minor: no geometry for S={S} NT={NT} "
                         f"K={K} (1 <= K <= S <= {MAX_SLOTS})")
    smem = _round16(32 * (8 * S + 4 * -(-S // 32) + 4 * 3 + 2 * NT * K))
    if smem > SMEM_OPTIN_BYTES:
        raise ValueError(f"deliver_minor: 32 instances need {smem} B of "
                         f"shared memory (limit {SMEM_OPTIN_BYTES})")
    return smem


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
        _minor_launch_fn = _resolve("deliver_minor_launch", 5)
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
    minor_smem(S, NT, K)
    fn = _minor_launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pool.data_ptr(), partitions.data_ptr(), int(t),
                 pool_out.data_ptr(), inbox.data_ptr(), n_del.data_ptr(),
                 n_drop.data_ptr(), I, S, L, NT, K, stream)
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
