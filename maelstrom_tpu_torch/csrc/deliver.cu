// Delivery kernel for the simulated network: one tick's message hand-off
// for a whole batch of protocol instances.
//
// Replaces the Pallas TPU kernel maelstrom_tpu/ops/delivery.py
// (_deliver_kernel, launched by deliver_pallas). Bit-identical to
// netsim.deliver_reference in this package, and so to the JAX
// netsim.deliver:
//   - a slot is due when VALID == 1 and DTICK <= t;
//   - a due slot whose (dest, origin) edge is partitioned is dropped; the
//     lookup normalises DEST and ORIGIN as JAX indexing does (a negative
//     index counts from the end, then clamp to [0, NT));
//   - each endpoint takes up to K of its deliverable slots whose priority
//     ((1 << 20) - DTICK) * S + (S - slot) (int32 wrap) is > 0, highest
//     first, the lower slot first on a tie; candidacy compares the raw
//     DEST with the endpoint;
//   - taken rows go to inbox[i, endpoint, k], zero rows where none;
//   - taken and dropped slots are cleared from the pool;
//   - n_del / n_drop count them per instance.
//
// Bound on an H100: memory. Per instance it must read the pool (S*L
// int32) and the partition plane (NT*NT bytes) once and write pool', the
// inbox (NT*K*L int32) and two counts. At I=4096, NT=9, L=20 that is
// 13,799,424 B (S=16, K=1: 4.12 us at 3.35 TB/s) and 107,843,584 B
// (S=128, K=8: 32.19 us). The selection's integer work is far below the
// card's operation rate at both shapes.
//
// Design: one warp per instance, no block-wide barrier anywhere.
//   1. The warp copies its instance's S rows into its own shared-memory
//      region with cp.async, 16 bytes a lane where L % 4 == 0 (rows of
//      neighbouring lanes are contiguous, so the loads coalesce), 4
//      bytes otherwise. The row stride in shared memory is padded to an
//      odd number of 16-byte units (odd number of words on the 4-byte
//      path), so lanes reading the headers of consecutive rows hit
//      distinct banks.
//   2. Lane l owns slots l, l + 32, ... (S / 32 rounded up, at most 8) and
//      classifies each in registers: due, dropped, eligible, priority.
//      __ballot_sync gives the dropped and eligible masks; the eligible
//      slots' (priority, dest, slot) are compacted into shared memory.
//   3. Selection by rank: an eligible slot is taken iff fewer than K
//      eligible slots of its own endpoint rank above it (higher
//      priority, or equal priority and a lower slot). Its rank is its
//      inbox row. Each lane counts over the E compacted entries, read as
//      shared-memory broadcasts: E * S / 32 compares per lane instead of
//      a K * S serial scan per (instance, endpoint) thread.
//   4. The inbox and pool' are written from shared memory with 16-byte
//      stores, neighbouring lanes on neighbouring addresses; a row table
//      (endpoint, k) -> slot and the cleared-slot bit masks (from the
//      ballots) decide what each unit holds, with no division per unit.
//   Only __syncwarp separates the phases, so the warps of one SM overlap
//   one instance's loads with another's selection and stores, and
//   I=4096 launches 4096 warps (31 per SM on 132 SMs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kValid = 0;
constexpr int kDest = 2;
constexpr int kDtick = 3;
constexpr int kOrigin = 7;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void copy_async(void* smem, const void* gmem,
                                           bool vec) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  }
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// JAX's index normalisation: a negative index counts from the end, then
// the result is clamped into [0, n)
__device__ __forceinline__ int jax_index(int x, int n) {
  if (x < 0) x += n;
  return min(max(x, 0), n - 1);
}

// Units of V int32 (V = 4 on the vector path, 1 otherwise) walked by a
// lane in steps of 32 units over rows of VL units: (row, q) is kept
// incrementally, so no unit needs a division.
struct RowCursor {
  int row, q, drow, dq, vl;
  __device__ RowCursor(int lane, int vl_)
      : row(lane / vl_), q(lane % vl_), drow(32 / vl_), dq(32 % vl_),
        vl(vl_) {}
  __device__ void next() {
    row += drow;
    q += dq;
    if (q >= vl) {
      q -= vl;
      ++row;
    }
  }
};

template <int V>
struct Unit;
template <>
struct Unit<4> {
  using T = int4;
  __device__ static T zero() { return make_int4(0, 0, 0, 0); }
};
template <>
struct Unit<1> {
  using T = int32_t;
  __device__ static T zero() { return 0; }
};

// bytes of a warp's staged rows, rounded up to 16
__host__ __device__ __forceinline__ size_t rows_bytes(int S, int rs) {
  return (static_cast<size_t>(S) * rs * 4 + 15) / 16 * 16;
}

// kSpl: slots per lane (S <= 32 * kSpl); kVec: 16-byte units
template <int kSpl, bool kVec>
__global__ void __launch_bounds__(128) deliver_warp_kernel(
    const int32_t* __restrict__ pool, const uint8_t* __restrict__ part,
    int t, int32_t* __restrict__ pool_out, int32_t* __restrict__ inbox,
    int32_t* __restrict__ n_del, int32_t* __restrict__ n_drop, int I,
    int S, int L, int NT, int K, int rs, int warp_bytes) {
  constexpr int V = kVec ? 4 : 1;
  using U = typename Unit<V>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int i = blockIdx.x * (blockDim.x >> 5) + wib;
  if (i >= I) return;  // the whole warp leaves together

  unsigned char* base = smem + static_cast<size_t>(wib) * warp_bytes;
  int32_t* rows = reinterpret_cast<int32_t*>(base);   // [S, rs]
  // compacted eligible slots: (priority, dest << 16 | slot)
  int2* ckey = reinterpret_cast<int2*>(base + rows_bytes(S, rs));  // [S]
  uint32_t* cleared = reinterpret_cast<uint32_t*>(ckey + S);  // [kSpl]
  int16_t* src = reinterpret_cast<int16_t*>(cleared + kSpl);  // [NT*K]

  // 1. stage the instance's rows (contiguous in the pool)
  const int vl = L / V;
  const int32_t* gpool = pool + static_cast<size_t>(i) * S * L;
  {
    RowCursor c(lane, vl);
    for (int u = lane; u < S * vl; u += 32, c.next())
      copy_async(rows + c.row * rs + c.q * V, gpool + u * V, kVec);
  }
  for (int r = lane; r < NT * K; r += 32) src[r] = -1;
  copy_async_wait();
  __syncwarp();

  // 2. classify the lane's slots in registers
  const uint8_t* ipart = part + static_cast<size_t>(i) * NT * NT;
  int32_t prio[kSpl];
  int dest[kSpl];
  bool elig[kSpl];
  unsigned elig_mask[kSpl], drop_mask[kSpl];
  int n_elig = 0;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    const int s = lane + 32 * j;
    bool drop = false;
    elig[j] = false;
    dest[j] = -1;
    prio[j] = 0;
    if (s < S) {
      const int32_t* r = rows + s * rs;
      int valid, dtick, origin;
      if (kVec) {
        const int4 h0 = *reinterpret_cast<const int4*>(r);
        const int4 h1 = *reinterpret_cast<const int4*>(r + 4);
        valid = h0.x;
        dest[j] = h0.z;
        dtick = h0.w;
        origin = h1.w;
      } else {
        valid = r[kValid];
        dest[j] = r[kDest];
        dtick = r[kDtick];
        origin = r[kOrigin];
      }
      if (valid == 1 && dtick <= t) {
        const bool blocked =
            __ldg(ipart + jax_index(dest[j], NT) * NT +
                  jax_index(origin, NT)) != 0;
        drop = blocked;
        // int32 wrap, as the JAX priority arithmetic
        prio[j] = static_cast<int32_t>(
            (static_cast<uint32_t>(1 << 20) -
             static_cast<uint32_t>(dtick)) * static_cast<uint32_t>(S) +
            static_cast<uint32_t>(S - s));
        elig[j] = !blocked && dest[j] >= 0 && dest[j] < NT && prio[j] > 0;
      }
    }
    drop_mask[j] = __ballot_sync(kFull, drop);
    elig_mask[j] = __ballot_sync(kFull, elig[j]);
    if (elig[j]) {
      const int at = n_elig + __popc(elig_mask[j] & below);
      ckey[at] = make_int2(prio[j], (dest[j] << 16) | s);
    }
    n_elig += __popc(elig_mask[j]);
  }
  __syncwarp();

  // 3. rank of each eligible slot among its endpoint's eligible slots
  int rank[kSpl];
#pragma unroll
  for (int j = 0; j < kSpl; ++j) rank[j] = 0;
  for (int e = 0; e < n_elig; ++e) {
    const int2 key = ckey[e];   // one 8-byte broadcast read
    const int32_t p = key.x;
    const int d = key.y >> 16;
    const int s2 = key.y & 0xffff;
#pragma unroll
    for (int j = 0; j < kSpl; ++j) {
      const int s = lane + 32 * j;
      rank[j] += (d == dest[j]) &
                 ((p > prio[j]) | ((p == prio[j]) & (s2 < s)));
    }
  }
  int ndel = 0, ndrop = 0;
#pragma unroll
  for (int j = 0; j < kSpl; ++j) {
    const bool take = elig[j] && rank[j] < K;
    if (take)
      src[dest[j] * K + rank[j]] = static_cast<int16_t>(lane + 32 * j);
    const unsigned tmask = __ballot_sync(kFull, take);
    if (lane == 0) cleared[j] = tmask | drop_mask[j];
    ndel += __popc(tmask);
    ndrop += __popc(drop_mask[j]);
  }
  if (lane == 0) {
    n_del[i] = ndel;
    n_drop[i] = ndrop;
  }
  __syncwarp();

  // 4a. inbox rows: the taken slot's row, or zeros
  {
    U* out =
        reinterpret_cast<U*>(inbox + static_cast<size_t>(i) * NT * K * L);
    RowCursor c(lane, vl);
    for (int u = lane; u < NT * K * vl; u += 32, c.next()) {
      const int sl = src[c.row];
      out[u] = sl >= 0
                   ? *reinterpret_cast<const U*>(rows + sl * rs + c.q * V)
                   : Unit<V>::zero();
    }
  }
  // 4b. pool' with taken and dropped slots cleared
  {
    U* out =
        reinterpret_cast<U*>(pool_out + static_cast<size_t>(i) * S * L);
    RowCursor c(lane, vl);
    for (int u = lane; u < S * vl; u += 32, c.next()) {
      const bool gone = (cleared[c.row >> 5] >> (c.row & 31)) & 1u;
      out[u] = gone ? Unit<V>::zero()
                    : *reinterpret_cast<const U*>(rows + c.row * rs +
                                                  c.q * V);
    }
  }
}

// Shared memory one warp needs; the Python geometry helper
// (kernels/delivery.py) computes the same.
size_t warp_smem(int S, int rs, int NT, int K, int spl) {
  const size_t b = rows_bytes(S, rs) + 8 * static_cast<size_t>(S) +
                   4 * static_cast<size_t>(spl) +
                   2 * static_cast<size_t>(NT) * K;
  return (b + 15) / 16 * 16;
}

template <int kSpl, bool kVec>
cudaError_t launch(const int32_t* pool, const uint8_t* part, int t,
                   int32_t* pool_out, int32_t* inbox, int32_t* n_del,
                   int32_t* n_drop, int I, int S, int L, int NT, int K,
                   int rs, int warp_bytes, int wpb, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(warp_bytes) * wpb;
  auto* kern = deliver_warp_kernel<kSpl, kVec>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (I + wpb - 1) / wpb;
  kern<<<blocks, 32 * wpb, smem, stream>>>(pool, part, t, pool_out, inbox,
                                           n_del, n_drop, I, S, L, NT, K, rs,
                                           warp_bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` with `wpb` warps (instances) per block, row stride
// `rs` int32 in shared memory and `warp_bytes` of shared memory per warp;
// `vec` selects 16-byte units (L % 4 == 0, rs % 4 == 0, 16-byte aligned
// pointers). Returns the launch's cudaError_t: cudaErrorInvalidValue for
// a geometry the kernel does not take.
int deliver_launch(const int32_t* pool, const uint8_t* part, int t,
                   int32_t* pool_out, int32_t* inbox, int32_t* n_del,
                   int32_t* n_drop, int I, int S, int L, int NT, int K,
                   int rs, int warp_bytes, int wpb, int vec, void* stream) {
  const int spl = S <= 32 ? 1 : S <= 64 ? 2 : S <= 128 ? 4 : 8;
  if (S < 1 || S > 256 || K < 1 || K > S || NT < 1 || L < 8 || rs < L ||
      wpb < 1 || wpb > 4 || (vec && (L % 4 || rs % 4)) ||
      static_cast<size_t>(warp_bytes) < warp_smem(S, rs, NT, K, spl) ||
      warp_bytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DELIVER_LAUNCH(SPL, VEC)                                          \
  launch<SPL, VEC>(pool, part, t, pool_out, inbox, n_del, n_drop, I, S, L, \
                   NT, K, rs, warp_bytes, wpb, st)
  cudaError_t e;
  if (vec) {
    e = spl == 1   ? DELIVER_LAUNCH(1, true)
        : spl == 2 ? DELIVER_LAUNCH(2, true)
        : spl == 4 ? DELIVER_LAUNCH(4, true)
                   : DELIVER_LAUNCH(8, true);
  } else {
    e = spl == 1   ? DELIVER_LAUNCH(1, false)
        : spl == 2 ? DELIVER_LAUNCH(2, false)
        : spl == 4 ? DELIVER_LAUNCH(4, false)
                   : DELIVER_LAUNCH(8, false);
  }
#undef DELIVER_LAUNCH
  return static_cast<int>(e);
}

}  // extern "C"
