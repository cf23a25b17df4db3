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
// layout runs XLA's netsim.deliver under vmap
// (maelstrom_tpu/tpu/runtime.py, the minor tick). It exists because the
// card's main path runs no plain version, and a transpose of the pool to
// [I, S, L] and back each tick would move the pool three times more.
// Partitions stay batch-leading [I, NT, NT] (the tick builds them so);
// the inbox comes out [I, NT, K, L] and the counts [I], as the JAX minor
// tick's batch-leading outputs.
//
// Bound on an H100: memory, the lead kernel's bytes (the pool and the
// partition plane read once; pool', the inbox and the two counts written
// once): 13,799,424 B at I=4096, S=16, K=1, NT=9, L=20 (4.12 us at 3.35
// TB/s), 107,843,584 B at S=128, K=8 (32.19 us).
//
// Design: a block of W warps owns a tile of W neighbouring instances, one
// warp per instance (W = 8 wherever the block fits in shared memory: a
// row (s, l) of the tile is then 32 contiguous bytes of [S, L, I], whole
// sectors). ceil(I / W) blocks: 512 at I=4096, up to 6 resident on an SM
// at the small shapes, so one block's copies overlap another's selection
// and stores.
//   1. Stage: the block copies the tile's pool [S, L, W] into shared
//      memory with cp.async, every copy in flight together: 16-byte
//      units (four instances of a row) where I % 4 == 0 and the pointers
//      are 16-byte aligned, 4-byte units otherwise. The pool is read from
//      device memory once, headers included. The slot stride is padded
//      to an odd number of 16-byte units (of words on the 4-byte path),
//      so lanes reading the headers of consecutive slots spread over the
//      banks (unpadded, L=20 and W=8 put them all in one bank). The
//      tile's partition planes [W, NT, NT] come along where they take at
//      most kPlaneBytes; wider ones (broadcast-25's 20,000 B) are read
//      through the read-only cache, since staging them would cost the
//      block its second place on an SM.
//   2. Classify and rank, a warp per instance, as the lead kernel: a lane
//      per slot (at most 8 a lane), headers from the staged tile;
//      __ballot_sync masks for the dropped slots; each eligible slot's
//      rank among its endpoint's eligible slots (higher priority, or
//      equal and a lower slot) from compacted (priority, dest << 8 |
//      slot) entries read as shared-memory broadcasts (E * S / 32
//      compares a lane). Above 128 slots the entries are first bucketed
//      by endpoint (count with shared atomics, a warp scan, scatter), so
//      a slot compares only with its own endpoint's. A taken slot fills
//      the (endpoint, k) -> slot table, and a byte per (slot, instance)
//      marks the cleared slots. Only __syncwarp inside the step.
//   3. Store from shared memory, coalesced, no global gather: pool' row
//      by row (16-byte stores on the vector path, 0 for a cleared slot),
//      then the tile's inbox [W, NT, K, L], one contiguous stretch of the
//      output, consecutive threads on consecutive 16-byte units (words
//      where L % 4 != 0), each read from the tile through the table. The
//      indices advance incrementally (Cursor3): no division per unit.
//   Two block barriers: after the copy and before the stores. Where not
//   even one instance's S * L words fit (S * L * 4 above ~227 KB: at 256
//   slots, L above ~220), the same kernel (kStaged = false) keeps its
//   tables in shared memory and reads the headers, pool' and the inbox
//   rows straight from device memory.

constexpr int kMinorMaxW = 8;
constexpr int kPlaneBytes = 4096;     // partition planes staged up to this
constexpr size_t kSmemOptin = 232448; // an H100 block's limit

__host__ __device__ __forceinline__ size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// (a, b, c) over dims (., B, C), c fastest, advanced by a fixed step of d
// units at a time: no division per unit
struct Cursor3 {
  int a, b, c, da, db, dc, B, C;
  __device__ Cursor3(int x, int d, int B_, int C_) : B(B_), C(C_) {
    c = x % C_;
    b = (x / C_) % B_;
    a = x / C_ / B_;
    dc = d % C_;
    db = (d / C_) % B_;
    da = d / C_ / B_;
  }
  __device__ void next() {
    c += dc;
    int carry = c >= C;
    if (carry) c -= C;
    b += db + carry;
    carry = b >= B;
    if (carry) b -= B;
    a += da + carry;
  }
};

// The launch shape of one batch-last round; the Python geometry helper
// (kernels/delivery.py, minor_geometry) computes the same and the launcher
// checks it.
struct MinorGeo {
  int W;         // instances (warps) a block; 0: no geometry
  int ss;        // int32 a staged slot in shared memory; 0: unstaged
  bool vec;      // 16-byte units of four instances (staged only)
  size_t smem;   // shared memory of a block
};

// Beside the tile: compacted entries [W][S] int2, bucket offsets [W][NT +
// 1] int, cleared bytes [S][kMinorMaxW], the (endpoint, k) -> slot table
// [W][NT * K] int16, then the partition planes where they are staged
// (W * NT * NT bytes, with room to align them as in device memory).
size_t minor_aux(int S, int NT, int K, int W) {
  const size_t planes = static_cast<size_t>(W) * NT * NT;
  return 8 * static_cast<size_t>(W) * S +
         4 * static_cast<size_t>(W) * (NT + 1) +
         kMinorMaxW * static_cast<size_t>(S) +
         2 * static_cast<size_t>(W) * NT * K +
         (planes <= kPlaneBytes ? planes + 32 : 0);
}

int minor_stride(int L, int W, bool vec) {
  int ss = L * W;
  if (vec) {
    ss = (ss + 3) / 4 * 4;
    if ((ss / 4) % 2 == 0) ss += 4;
  } else if (ss % 2 == 0) {
    ss += 1;
  }
  return ss;
}

MinorGeo minor_geometry(int S, int L, int NT, int K, bool vec) {
  for (int W = kMinorMaxW; W >= 1; W /= 2) {
    const bool v = vec && W % 4 == 0;
    const int ss = minor_stride(L, W, v);
    const size_t smem = round16(round16(4 * static_cast<size_t>(S) * ss) +
                                minor_aux(S, NT, K, W));
    if (smem <= kSmemOptin) return {W, ss, v, smem};
  }
  for (int W = kMinorMaxW; W >= 1; W /= 2) {
    const size_t smem = round16(minor_aux(S, NT, K, W));
    if (smem <= kSmemOptin) return {W, 0, false, smem};
  }
  return {0, 0, false, 0};
}

__device__ __forceinline__ int4 cleared_unit(int4 v, const uint8_t* g) {
  const uint32_t m = *reinterpret_cast<const uint32_t*>(g);
  return make_int4(m & 0xffu ? 0 : v.x, m & 0xff00u ? 0 : v.y,
                   m & 0xff0000u ? 0 : v.z, m & 0xff000000u ? 0 : v.w);
}
__device__ __forceinline__ int32_t cleared_unit(int32_t v, const uint8_t* g) {
  return *g ? 0 : v;
}

// The tile's rows (s, l) of nw instances, as units of V int32 (V = 4: 16
// bytes), walked by the block's threads: `gtile` the tile in device
// memory ([S, L, I], I words a row), `tile` in shared memory (ss words a
// slot, W a row).
template <int V>
__device__ void stage_rows(int32_t* tile, const int32_t* gtile, int x,
                           int nthr, int S, int L, size_t I, int ss, int W,
                           int nw) {
  const int upr = nw / V;
  Cursor3 c(x, nthr, L, upr);
  for (int u = x; u < S * L * upr; u += nthr, c.next())
    copy_async(tile + c.a * ss + c.b * W + c.c * V,
               gtile + (static_cast<size_t>(c.a) * L + c.b) * I + c.c * V,
               V == 4);
}

// pool' of the tile: each unit from shared memory (or, unstaged, from
// device memory), 0 for an instance whose slot is cleared
template <int V, bool kStaged>
__device__ void store_rows(int32_t* out, const int32_t* tile,
                           const int32_t* gtile, const uint8_t* gone, int x,
                           int nthr, int S, int L, size_t I, int ss, int W,
                           int nw) {
  using U = typename Unit<V>::T;
  const int upr = nw / V;
  Cursor3 c(x, nthr, L, upr);
  for (int u = x; u < S * L * upr; u += nthr, c.next()) {
    const size_t g = (static_cast<size_t>(c.a) * L + c.b) * I + c.c * V;
    const U v =
        kStaged
            ? *reinterpret_cast<const U*>(tile + c.a * ss + c.b * W + c.c * V)
            : __ldg(reinterpret_cast<const U*>(gtile + g));
    *reinterpret_cast<U*>(out + g) =
        cleared_unit(v, gone + c.a * kMinorMaxW + c.c * V);
  }
}

// kSpl: slots a lane (S <= 32 * kSpl); kVec: 16-byte units of the pool;
// kStaged: the tile's rows in shared memory (ss > 0). The unstaged branch
// has one instance, <8, false, false>: it takes any S and I.
template <int kSpl, bool kVec, bool kStaged>
__global__ void __launch_bounds__(32 * kMinorMaxW, kSpl <= 2 ? 6 : 2)
    deliver_minor_kernel(const int32_t* __restrict__ pool,
                         const uint8_t* __restrict__ part, int t,
                         int32_t* __restrict__ pool_out,
                         int32_t* __restrict__ inbox,
                         int32_t* __restrict__ n_del,
                         int32_t* __restrict__ n_drop, int I, int S, int L,
                         int NT, int K, int W, int ss) {
  constexpr int V = kVec ? 4 : 1;
  constexpr bool kBucket = kSpl == 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int x = threadIdx.x;
  const int nthr = blockDim.x;   // 32 * W
  const int lane = x & 31;
  const int w = x >> 5;          // the warp's instance in the tile
  const int i0 = blockIdx.x * W;
  const int nw = min(W, I - i0);   // instances of this tile
  const int R = NT * K;
  const int P = NT * NT;           // bytes of one partition plane
  const size_t Is = static_cast<size_t>(I);
  // row (s, l) of the tile at tile[s * ss + l * W], W instances
  int32_t* tile = reinterpret_cast<int32_t*>(smem);
  const size_t tile_bytes =
      kStaged ? round16(4 * static_cast<size_t>(S) * ss) : 0;
  int2* ckey = reinterpret_cast<int2*>(smem + tile_bytes);       // [W][S]
  int* boff = reinterpret_cast<int*>(ckey + W * S);               // [W][NT+1]
  uint8_t* gone = reinterpret_cast<uint8_t*>(boff + W * (NT + 1));  // [S][8]
  int16_t* src = reinterpret_cast<int16_t*>(gone + kMinorMaxW * S);  // [W][R]
  // the tile's planes: byte k of the stretch part[i0 * P ...] at
  // planes[k], where planes - 4 .. planes + W * P lie in shared memory
  // and planes has the stretch's alignment mod 4
  const uint8_t* gplanes = part + static_cast<size_t>(i0) * P;
  const bool staged_planes = W * P <= kPlaneBytes;
  uint8_t* planes = reinterpret_cast<uint8_t*>(
      ((reinterpret_cast<uintptr_t>(src + W * R) + 15) & ~uintptr_t(15)) +
      4 + (reinterpret_cast<uintptr_t>(gplanes) & 3));
  // word (s, l, n) of the tile in device memory at (s * L + l) * I + n
  const int32_t* gtile = pool + i0;
  auto word = [&](int s, int l, int n) -> int32_t {
    return kStaged ? tile[s * ss + l * W + n]
                   : __ldg(gtile + (static_cast<size_t>(s) * L + l) * Is + n);
  };

  // 1. stage the tile (16-byte units: nw % 4 == 0) and its planes
  if (kStaged) stage_rows<V>(tile, gtile, x, nthr, S, L, Is, ss, W, nw);
  if (staged_planes) {
    // 4-byte copies over the aligned middle, bytes at the two ends
    const int nb = nw * P;
    const int head = min(nb, static_cast<int>(
                                 (4 - (reinterpret_cast<uintptr_t>(gplanes) &
                                       3)) & 3));
    const int words = (nb - head) / 4;
    for (int k = x; k < words; k += nthr)
      copy_async(planes + head + 4 * k, gplanes + head + 4 * k, false);
    for (int k = x; k < nb - 4 * words; k += nthr) {
      const int at = k < head ? k : 4 * words + k;
      planes[at] = gplanes[at];
    }
  }
  for (int r = x; r < W * R; r += nthr) src[r] = -1;
  if (kBucket)
    for (int r = x; r < W * (NT + 1); r += nthr) boff[r] = 0;
  copy_async_wait();
  __syncthreads();

  // 2. classify and rank the warp's instance
  if (w < nw) {
    const int i = i0 + w;
    int2* key = ckey + w * S;
    int16_t* wsrc = src + w * R;
    int32_t prio[kSpl];
    int dest[kSpl], pidx[kSpl], rank[kSpl];
    bool due[kSpl], drop[kSpl], elig[kSpl];
    unsigned drop_mask[kSpl];
#pragma unroll
    for (int j = 0; j < kSpl; ++j) {
      const int s = lane + 32 * j;
      due[j] = false;
      dest[j] = -1;
      pidx[j] = 0;
      prio[j] = 0;
      if (s < S) {
        const int valid = word(s, kValid, w);
        const int dtick = word(s, kDtick, w);
        dest[j] = word(s, kDest, w);
        const int origin = word(s, kOrigin, w);
        due[j] = valid == 1 && dtick <= t;
        pidx[j] = jax_index(dest[j], NT) * NT + jax_index(origin, NT);
        // int32 wrap, as the JAX priority arithmetic
        prio[j] = static_cast<int32_t>(
            (static_cast<uint32_t>(1 << 20) - static_cast<uint32_t>(dtick)) *
                static_cast<uint32_t>(S) +
            static_cast<uint32_t>(S - s));
      }
    }
    // every partition byte of the lane in flight together
    if (staged_planes) {
      const uint8_t* ipart = planes + w * P;
#pragma unroll
      for (int j = 0; j < kSpl; ++j)
        drop[j] = due[j] && ipart[pidx[j]] != 0;
    } else {
      const uint8_t* ipart = part + static_cast<size_t>(i) * P;
#pragma unroll
      for (int j = 0; j < kSpl; ++j)
        drop[j] = due[j] && __ldg(ipart + pidx[j]) != 0;
    }
#pragma unroll
    for (int j = 0; j < kSpl; ++j) {
      elig[j] = due[j] && !drop[j] && dest[j] >= 0 && dest[j] < NT &&
                prio[j] > 0;
      drop_mask[j] = __ballot_sync(kFull, drop[j]);
      rank[j] = 0;
    }
    if constexpr (kBucket) {
      // the eligible slots in buckets by endpoint: count, scan, scatter
      int* off = boff + w * (NT + 1);
      int pos[kSpl];
#pragma unroll
      for (int j = 0; j < kSpl; ++j)
        pos[j] = elig[j] ? atomicAdd(&off[dest[j]], 1) : 0;
      __syncwarp();
      int carry = 0;
      for (int b = 0; b < NT; b += 32) {
        const int d = b + lane;
        const int v = d < NT ? off[d] : 0;
        int incl = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        if (d < NT) off[d] = carry + incl - v;
        carry += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) off[NT] = carry;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kSpl; ++j)
        if (elig[j])
          key[off[dest[j]] + pos[j]] = make_int2(prio[j], lane + 32 * j);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        if (!elig[j]) continue;
        const int s = lane + 32 * j;
        const int e1 = off[dest[j] + 1];
        for (int e = off[dest[j]]; e < e1 && rank[j] < K; ++e) {
          const int2 k2 = key[e];
          rank[j] += (k2.x > prio[j]) | ((k2.x == prio[j]) & (k2.y < s));
        }
      }
    } else {
      // the eligible slots compacted in slot order, read as broadcasts
      int n_elig = 0;
      const unsigned below = (1u << lane) - 1u;
#pragma unroll
      for (int j = 0; j < kSpl; ++j) {
        const unsigned em = __ballot_sync(kFull, elig[j]);
        if (elig[j])
          key[n_elig + __popc(em & below)] =
              make_int2(prio[j], (dest[j] << 8) | (lane + 32 * j));
        n_elig += __popc(em);
      }
      __syncwarp();
      for (int e = 0; e < n_elig; ++e) {
        const int2 k2 = key[e];   // one 8-byte broadcast read
        const int d = k2.y >> 8;
        const int s2 = k2.y & 0xff;
#pragma unroll
        for (int j = 0; j < kSpl; ++j)
          rank[j] += (d == dest[j]) &
                     ((k2.x > prio[j]) |
                      ((k2.x == prio[j]) & (s2 < lane + 32 * j)));
      }
    }
    int ndel = 0, ndrop = 0;
#pragma unroll
    for (int j = 0; j < kSpl; ++j) {
      const int s = lane + 32 * j;
      const bool take = elig[j] && rank[j] < K;
      if (take) wsrc[dest[j] * K + rank[j]] = static_cast<int16_t>(s);
      const unsigned tmask = __ballot_sync(kFull, take);
      if (s < S)
        gone[s * kMinorMaxW + w] =
            static_cast<uint8_t>(((tmask | drop_mask[j]) >> lane) & 1u);
      ndel += __popc(tmask);
      ndrop += __popc(drop_mask[j]);
    }
    if (lane == 0) {
      n_del[i] = ndel;
      n_drop[i] = ndrop;
    }
  }
  __syncthreads();

  // 3a. pool', row by row, cleared slots 0
  store_rows<V, kStaged>(pool_out + i0, tile, gtile, gone, x, nthr, S, L, Is,
                         ss, W, nw);
  // 3b. the tile's inbox [nw, R, L], one contiguous stretch
  int32_t* out = inbox + static_cast<size_t>(i0) * R * L;
  if (L % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    const int L4 = L / 4;
    Cursor3 c(x, nthr, R, L4);
    for (int u = x; u < nw * R * L4; u += nthr, c.next()) {
      const int sl = src[c.a * R + c.b];
      const int l = 4 * c.c;
      reinterpret_cast<int4*>(out)[u] =
          sl >= 0 ? make_int4(word(sl, l, c.a), word(sl, l + 1, c.a),
                              word(sl, l + 2, c.a), word(sl, l + 3, c.a))
                  : make_int4(0, 0, 0, 0);
    }
  } else {
    Cursor3 c(x, nthr, R, L);
    for (int u = x; u < nw * R * L; u += nthr, c.next()) {
      const int sl = src[c.a * R + c.b];
      out[u] = sl >= 0 ? word(sl, c.c, c.a) : 0;
    }
  }
}

template <int kSpl, bool kVec, bool kStaged>
cudaError_t launch_minor(const int32_t* pool, const uint8_t* part, int t,
                         int32_t* pool_out, int32_t* inbox, int32_t* n_del,
                         int32_t* n_drop, int I, int S, int L, int NT, int K,
                         const MinorGeo& g, cudaStream_t stream) {
  auto* kern = deliver_minor_kernel<kSpl, kVec, kStaged>;
  if (g.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (I + g.W - 1) / g.W;
  kern<<<blocks, 32 * g.W, g.smem, stream>>>(pool, part, t, pool_out, inbox,
                                             n_del, n_drop, I, S, L, NT, K,
                                             g.W, g.ss);
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

// The batch-last entry on `stream`: pool and pool_out [S, L, I], inbox
// [I, NT, K, L], partitions [I, NT, NT]; `vec` asks for 16-byte units (I
// % 4 == 0, pool and pool_out 16-byte aligned). A block of 32 * W threads
// for each W instances, with `smem` bytes of shared memory and a staged
// slot stride of `ss` int32 (0: unstaged), as minor_geometry gives them
// (the launcher checks). Returns the launch's cudaError_t:
// cudaErrorInvalidValue for a geometry the kernel does not take.
int deliver_minor_launch(const int32_t* pool, const uint8_t* part, int t,
                         int32_t* pool_out, int32_t* inbox, int32_t* n_del,
                         int32_t* n_drop, int I, int S, int L, int NT,
                         int K, int W, int ss, int smem, int vec,
                         void* stream) {
  if (S < 1 || S > 256 || K < 1 || K > S || NT < 1 || L < 8 || I < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const MinorGeo g = minor_geometry(S, L, NT, K, vec != 0);
  if (g.W == 0 || g.W != W || g.ss != ss ||
      g.smem != static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int spl = S <= 32 ? 1 : S <= 64 ? 2 : S <= 128 ? 4 : 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MINOR_LAUNCH(SPL, VEC, STAGED)                                     \
  launch_minor<SPL, VEC, STAGED>(pool, part, t, pool_out, inbox, n_del,    \
                                 n_drop, I, S, L, NT, K, g, st)
#define MINOR_BY_SPL(VEC)                                                  \
  (spl == 1   ? MINOR_LAUNCH(1, VEC, true)                                 \
   : spl == 2 ? MINOR_LAUNCH(2, VEC, true)                                 \
   : spl == 4 ? MINOR_LAUNCH(4, VEC, true)                                 \
              : MINOR_LAUNCH(8, VEC, true))
  const cudaError_t e = g.ss == 0 ? MINOR_LAUNCH(8, false, false)
                        : g.vec   ? MINOR_BY_SPL(true)
                                  : MINOR_BY_SPL(false);
#undef MINOR_BY_SPL
#undef MINOR_LAUNCH
  return static_cast<int>(e);
}

}  // extern "C"
