// Delivery kernel for the simulated network: one tick's message hand-off
// for a whole batch of protocol instances.
//
// Replaces the Pallas TPU kernel maelstrom_tpu/ops/delivery.py
// (_deliver_kernel, launched by deliver_pallas). Bit-identical to
// netsim.deliver_reference in this package, and so to the JAX
// netsim.deliver:
//   - a slot is due when VALID == 1 and DTICK <= t;
//   - a due slot whose (dest, origin) edge is partitioned is dropped;
//   - each endpoint takes up to K of its deliverable slots, best priority
//     first, priority = ((1 << 20) - DTICK) * S + (S - slot) (int32 wrap);
//   - taken rows go to inbox[i, endpoint, k], zero rows where none;
//   - taken and dropped slots are cleared from the pool;
//   - n_del / n_drop count them per instance.
//
// Bound on an H100: memory. Per instance it reads the pool (S*L int32)
// and the partition plane (NT*NT bytes) once and writes pool', the inbox
// (NT*K*L int32) and two counts; there are a few integer compares per
// slot and endpoint, far below the card's operation rate. At the
// flagship shape (I=4096, S=16, L=20, NT=9, K=1) that is ~13.8 MB, about
// 4 us at 3.35 TB/s: the launch itself costs as much.
//
// Design: a block stages the pool rows of IPB consecutive instances in
// shared memory with coalesced loads (the rows of neighbouring instances
// are contiguous), classifies every slot once (deliverable / dropped),
// then runs one thread per (instance, endpoint). Every slot has exactly
// one DEST, so the endpoints' candidate sets are disjoint: each thread's
// K max-scans over S are independent, and a slot is marked taken only by
// its own endpoint's thread (no atomics, no "clear from every row" pass
// as in the TPU kernel). The pool is written back coalesced, with taken
// and dropped slots zeroed, and one thread per instance sums the counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kValid = 0;
constexpr int kDest = 2;
constexpr int kDtick = 3;
constexpr int kOrigin = 7;

// slot status in shared memory
constexpr unsigned char kNone = 0;
constexpr unsigned char kDeliverable = 1;
constexpr unsigned char kDropped = 2;

__global__ void deliver_kernel(const int32_t* __restrict__ pool,
                               const uint8_t* __restrict__ part,
                               int t,
                               int32_t* __restrict__ pool_out,
                               int32_t* __restrict__ inbox,
                               int32_t* __restrict__ n_del,
                               int32_t* __restrict__ n_drop,
                               int I, int S, int L, int NT, int K, int ipb) {
  extern __shared__ int32_t smem[];
  const int i0 = blockIdx.x * ipb;
  const int n_inst = min(ipb, I - i0);
  if (n_inst <= 0) return;
  int32_t* rows = smem;                                   // [ipb, S, L]
  unsigned char* status =
      reinterpret_cast<unsigned char*>(rows + ipb * S * L);  // [ipb, S]
  unsigned char* taken = status + ipb * S;                 // [ipb, S]

  const int row_elems = n_inst * S * L;
  const int32_t* src = pool + static_cast<size_t>(i0) * S * L;
  for (int e = threadIdx.x; e < row_elems; e += blockDim.x) rows[e] = src[e];
  __syncthreads();

  // classify every slot once
  for (int e = threadIdx.x; e < n_inst * S; e += blockDim.x) {
    const int li = e / S;
    const int32_t* r = rows + e * L;
    unsigned char st = kNone;
    if (r[kValid] == 1 && r[kDtick] <= t) {
      const int dest = min(max(r[kDest], 0), NT - 1);
      const int origin = min(max(r[kOrigin], 0), NT - 1);
      const uint8_t blocked =
          part[(static_cast<size_t>(i0 + li) * NT + dest) * NT + origin];
      st = blocked ? kDropped : kDeliverable;
    }
    status[e] = st;
    taken[e] = 0;
  }
  __syncthreads();

  // one thread per (instance, endpoint): K independent max-scans
  for (int w = threadIdx.x; w < n_inst * NT; w += blockDim.x) {
    const int li = w / NT;
    const int node = w % NT;
    const int32_t* irows = rows + li * S * L;
    const unsigned char* ist = status + li * S;
    unsigned char* itaken = taken + li * S;
    int32_t* out = inbox +
        ((static_cast<size_t>(i0 + li) * NT + node) * K) * L;
    for (int k = 0; k < K; ++k) {
      int best = -1;
      int32_t bestp = 0;
      for (int s = 0; s < S; ++s) {
        if (ist[s] != kDeliverable || itaken[s]) continue;
        const int32_t* r = irows + s * L;
        if (r[kDest] != node) continue;
        // int32 wrap, as the JAX priority arithmetic
        const int32_t p = static_cast<int32_t>(
            static_cast<uint32_t>((1 << 20) - r[kDtick]) *
                static_cast<uint32_t>(S) +
            static_cast<uint32_t>(S - s));
        if (p > bestp) {
          bestp = p;
          best = s;
        }
      }
      int32_t* o = out + k * L;
      if (best >= 0) {
        itaken[best] = 1;
        const int32_t* r = irows + best * L;
        for (int l = 0; l < L; ++l) o[l] = r[l];
      } else {
        for (int l = 0; l < L; ++l) o[l] = 0;
      }
    }
  }
  __syncthreads();

  // pool' with taken and dropped slots cleared (coalesced)
  int32_t* dst = pool_out + static_cast<size_t>(i0) * S * L;
  for (int e = threadIdx.x; e < row_elems; e += blockDim.x) {
    const int slot = e / L;   // instance-major slot index in the block
    const bool cleared = taken[slot] || status[slot] == kDropped;
    dst[e] = cleared ? 0 : rows[e];
  }
  for (int li = threadIdx.x; li < n_inst; li += blockDim.x) {
    int32_t d = 0, x = 0;
    for (int s = 0; s < S; ++s) {
      d += taken[li * S + s];
      x += status[li * S + s] == kDropped;
    }
    n_del[i0 + li] = d;
    n_drop[i0 + li] = x;
  }
}

}  // namespace

extern "C" {

// Shared memory a block of `ipb` instances needs.
size_t deliver_smem_bytes(int S, int L, int ipb) {
  return static_cast<size_t>(ipb) * S * L * sizeof(int32_t) +
         2 * static_cast<size_t>(ipb) * S;
}

// Launch on `stream`; returns cudaGetLastError() of the launch.
int deliver_launch(const int32_t* pool, const uint8_t* part, int t,
                   int32_t* pool_out, int32_t* inbox, int32_t* n_del,
                   int32_t* n_drop, int I, int S, int L, int NT, int K,
                   int ipb, int threads, void* stream) {
  const size_t smem = deliver_smem_bytes(S, L, ipb);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        deliver_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (I + ipb - 1) / ipb;
  deliver_kernel<<<blocks, threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      pool, part, t, pool_out, inbox, n_del, n_drop, I, S, L, NT, K, ipb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
