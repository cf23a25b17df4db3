"""The delivery step of every tick: the CUDA kernel ``csrc/deliver.cu``
on the card, its plain PyTorch version (``netsim.deliver_reference``)
on the CPU.

Replaces the Pallas kernel ``maelstrom_tpu/ops/delivery.py``
(``_deliver_kernel`` via ``deliver_pallas``). The kernel is memory
bound; the header of ``csrc/deliver.cu`` gives its bound and design.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import netsim
from ..netsim import NetConfig

SOURCE = "deliver"
_SMEM_BUDGET = 48 * 1024
_MAX_IPB = 16
_THREADS = 256


def _lib():
    from . import build
    lib = build.load(SOURCE)
    fn = lib.deliver_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def instances_per_block(S: int, L: int) -> int:
    per = S * L * 4 + 2 * S
    return max(1, min(_MAX_IPB, _SMEM_BUDGET // per))


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
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pool.data_ptr(), partitions.data_ptr(), int(t),
                 pool_out.data_ptr(), inbox.data_ptr(), n_del.data_ptr(),
                 n_drop.data_ptr(), I, S, L, NT, K,
                 instances_per_block(S, L), _THREADS, stream)
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
