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

// ---------------------------------------------------------------------------
// The batch-last entry: the same function over the minor carry layout's
// pool [S, L, I] (instances minormost, contiguous), read and written in
// that orientation. It replaces no Pallas kernel: the JAX package's minor
// layout runs XLA's netsim.deliver under vmap. It exists because the
// card's main path runs no plain version, and a transpose of the pool to
// [I, S, L] and back each tick would move the pool three times more.
// Partitions stay batch-leading [I, NT, NT] (the tick builds them so);
// the inbox comes out [I, NT, K, L] and the counts [I], as the JAX minor
// tick's batch-leading outputs. Its bound is the lead kernel's: the pool
// and the partition plane read once, pool', the inbox and the counts
// written once.
//
// Design: a block of kMinorWarps warps owns 32 neighbouring instances,
// one per lane, so a warp's loads of pool[s, l, i0..i0+31] are 128
// contiguous bytes.
//   1. Classify: warp w walks slots w, w + kMinorWarps, ... of its
//      lane's instance (four coalesced header loads a slot). Dropped
//      slots set bits in the instance's cleared mask; eligible ones
//      append (priority, dest << 16 | slot) to the instance's column of
//      shared memory (entry e of instance x at [e * 32 + x]: a warp's
//      accesses are consecutive words) through a shared counter, in an
//      order that does not matter: the rank below reads none.
//   2. Rank: warp w takes entries w, w + kMinorWarps, ... of its lane's
//      instance. An entry is taken iff fewer than K entries of its
//      endpoint rank above it (higher priority, or equal priority and a
//      lower slot): E * E compares for E eligible slots in all, its rank
//      its inbox row. The (endpoint, k) -> slot table goes to shared
//      memory, and taken slots join the cleared mask.
//   3. Every warp moves data: pool' by rows (s, l) of 32 instances, warp
//      w taking rows w, w + kMinorWarps, ... (a coalesced 128-byte load
//      and store a row, 0 for a cleared slot); the inbox of the 32
//      instances, one contiguous stretch of the output, word by word over
//      the block's threads, each word gathered from the pool through the
//      row table.
//   Three block barriers separate the steps.

constexpr int kMinorWarps = 32;

// Shared memory of one block (the Python geometry helper computes the
// same): compacted entries, cleared masks, the row table, and three
// counters, for 32 instances.
size_t minor_block_smem(int S, int NT, int K) {
  const size_t b = 32 * (8 * static_cast<size_t>(S) +
                         4 * static_cast<size_t>((S + 31) / 32) + 4 * 3 +
                         2 * static_cast<size_t>(NT) * K);
  return (b + 15) / 16 * 16;
}

__global__ void __launch_bounds__(32 * kMinorWarps) deliver_minor_kernel(
    const int32_t* __restrict__ pool, const uint8_t* __restrict__ part,
    int t, int32_t* __restrict__ pool_out, int32_t* __restrict__ inbox,
    int32_t* __restrict__ n_del, int32_t* __restrict__ n_drop, int I,
    int S, int L, int NT, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int x = threadIdx.x;
  const int lane = x & 31;
  const int warp = x >> 5;
  const int i0 = blockIdx.x * 32;   // the block's first instance
  const int nw = min(32, I - i0);   // instances of this block
  const int i = i0 + lane;
  const bool own = lane < nw;
  const int R = NT * K;
  const int W = (S + 31) / 32;
  int2* ckey = reinterpret_cast<int2*>(smem);                    // [S][32]
  uint32_t* cleared = reinterpret_cast<uint32_t*>(ckey + 32 * S);  // [W][32]
  int* n_elig = reinterpret_cast<int*>(cleared + 32 * W);          // [32]
  int* ndel = n_elig + 32;                                         // [32]
  int* ndrop = ndel + 32;                                          // [32]
  int16_t* src = reinterpret_cast<int16_t*>(ndrop + 32);           // [R][32]
  const size_t plane = static_cast<size_t>(L) * I;   // one slot's words

  for (int k = x; k < 32 * (W + 3); k += 32 * kMinorWarps)
    cleared[k] = 0u;   // the masks and the three counters
  for (int k = x; k < 32 * R; k += 32 * kMinorWarps) src[k] = -1;
  __syncthreads();

  // 1. classify
  if (own) {
    const uint8_t* ipart = part + static_cast<size_t>(i) * NT * NT;
#pragma unroll 4
    for (int s = warp; s < S; s += kMinorWarps) {
      const int32_t* col = pool + s * plane + i;
      const int valid = col[static_cast<size_t>(kValid) * I];
      const int dtick = col[static_cast<size_t>(kDtick) * I];
      const int dest = col[static_cast<size_t>(kDest) * I];
      const int origin = col[static_cast<size_t>(kOrigin) * I];
      if (valid != 1 || dtick > t) continue;
      const bool blocked =
          __ldg(ipart + jax_index(dest, NT) * NT + jax_index(origin, NT)) !=
          0;
      if (blocked) {
        atomicOr(&cleared[(s >> 5) * 32 + lane], 1u << (s & 31));
        atomicAdd(&ndrop[lane], 1);
        continue;
      }
      // int32 wrap, as the JAX priority arithmetic
      const int32_t prio = static_cast<int32_t>(
          (static_cast<uint32_t>(1 << 20) - static_cast<uint32_t>(dtick)) *
              static_cast<uint32_t>(S) +
          static_cast<uint32_t>(S - s));
      if (dest >= 0 && dest < NT && prio > 0)
        ckey[atomicAdd(&n_elig[lane], 1) * 32 + lane] =
            make_int2(prio, (dest << 16) | s);
    }
  }
  __syncthreads();

  // 2. rank
  if (own) {
    const int n = n_elig[lane];
    for (int a = warp; a < n; a += kMinorWarps) {
      const int2 ka = ckey[a * 32 + lane];
      const int da = ka.y >> 16, sa = ka.y & 0xffff;
      int rank = 0;
      for (int b = 0; b < n && rank < K; ++b) {
        const int2 kb = ckey[b * 32 + lane];
        rank += ((kb.y >> 16) == da) &
                ((kb.x > ka.x) | ((kb.x == ka.x) & ((kb.y & 0xffff) < sa)));
      }
      if (rank < K) {
        src[(da * K + rank) * 32 + lane] = static_cast<int16_t>(sa);
        atomicOr(&cleared[(sa >> 5) * 32 + lane], 1u << (sa & 31));
        atomicAdd(&ndel[lane], 1);
      }
    }
  }
  __syncthreads();
  if (warp == 0 && own) {
    n_del[i] = ndel[lane];
    n_drop[i] = ndrop[lane];
  }

  // 3a. pool' by rows (s, l) of the block's instances
  if (own) {
    for (int row = warp; row < S * L; row += kMinorWarps) {
      const int s = row / L;
      const size_t at = s * plane + static_cast<size_t>(row - s * L) * I + i;
      const bool gone = (cleared[(s >> 5) * 32 + lane] >> (s & 31)) & 1u;
      pool_out[at] = gone ? 0 : pool[at];
    }
  }
  // 3b. the block's inbox stretch [nw * R * L] words, thread by word
  const int RL = R * L;
  int32_t* out = inbox + static_cast<size_t>(i0) * RL;
  for (int u = x; u < nw * RL; u += 32 * kMinorWarps) {
    const int n = u / RL;
    const int rem = u - n * RL;
    const int r = rem / L;
    const int q = rem - r * L;
    const int sl = src[r * 32 + n];
    out[u] = sl >= 0 ? pool[sl * plane + static_cast<size_t>(q) * I + i0 + n]
                     : 0;
  }
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

// The batch-last entry on `stream`: pool and pool_out [S, L, I], inbox
// [I, NT, K, L], partitions [I, NT, NT]; a block of 32 * kMinorWarps
// threads for each 32 instances, with minor_block_smem(S, NT, K) bytes of
// shared memory. Returns the launch's cudaError_t: cudaErrorInvalidValue
// for a geometry the kernel does not take.
int deliver_minor_launch(const int32_t* pool, const uint8_t* part, int t,
                         int32_t* pool_out, int32_t* inbox, int32_t* n_del,
                         int32_t* n_drop, int I, int S, int L, int NT,
                         int K, void* stream) {
  const size_t smem = minor_block_smem(S, NT, K);
  if (S < 1 || S > 256 || K < 1 || K > S || NT < 1 || L < 8 || I < 1 ||
      smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        deliver_minor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (I + 31) / 32;
  deliver_minor_kernel<<<blocks, 32 * kMinorWarps, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      pool, part, t, pool_out, inbox, n_del, n_drop, I, S, L, NT, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
