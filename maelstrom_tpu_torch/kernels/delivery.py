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
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .. import netsim
from ..netsim import NetConfig

SOURCE = "deliver"
# the kernel's symbol, as the profiler names it
KERNEL_NAME = "deliver_warp_kernel"
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


_launch_fn = None


def _launcher():
    """``deliver_launch`` of the built library, resolved once."""
    global _launch_fn
    if _launch_fn is None:
        from . import build
        fn = build.load(SOURCE).deliver_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p] + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch_fn = fn
    return _launch_fn


def deliver_cuda(pool: torch.Tensor, partitions: torch.Tensor, t: int,
                 cfg: NetConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Launch the delivery kernel on the current stream."""
    I, S, L = pool.shape
    NT, K = cfg.n_total, cfg.inbox_k
    if pool.dtype != torch.int32 or not pool.is_contiguous():
        raise ValueError("deliver: pool must be contiguous int32 [I, S, L]")
    if partitions.dtype not in (torch.bool, torch.uint8) \
            or tuple(partitions.shape) != (I, NT, NT) \
            or not partitions.is_contiguous():
        raise ValueError(
            f"deliver: partitions must be contiguous bool/uint8 "
            f"[{I}, {NT}, {NT}], got {partitions.dtype} "
            f"{tuple(partitions.shape)}")
    if partitions.device != pool.device:
        raise ValueError("deliver: pool and partitions on different devices")
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
    deliver.launches += 1
    return pool_out, inbox, n_del, n_drop


def deliver(pool: torch.Tensor, partitions: torch.Tensor, t: int,
            cfg: NetConfig):
    """One delivery round for ``pool [I, S, L]``: the kernel for a CUDA
    tensor, the plain version for a CPU tensor. Returns ``(pool', inbox
    [I, NT, K, L], n_delivered [I], n_dropped [I])``."""
    if pool.is_cuda:
        return deliver_cuda(pool, partitions, t, cfg)
    return netsim.deliver_reference(pool, partitions, t, cfg)


# launches of the kernel: incremented where it is launched and nowhere
# else, so a run can show that its delivery went through the kernel
deliver.launches = 0
