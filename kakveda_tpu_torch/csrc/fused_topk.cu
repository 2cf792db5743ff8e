// Fused cosine score + streaming top-k for the GFKB match, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kakveda_tpu/ops/pallas_knn.py::fused_topk
// (body _tile_kernel). Same contract, bit for bit in its selection rule:
//   * scores = bf16(q) . bf16(emb)^T with f32 accumulation;
//   * rows whose `valid` byte is 0 score -2.0 (they stay selectable, with
//     their real row id, exactly as in the Pallas kernel);
//   * per row tile of ROW_TILE rows the Pallas kernel runs k rounds of "take
//     the max, lowest column on ties, overwrite it with -2.0", and pads lanes
//     k..7 with (-2.0, 0);
//   * the [n_tiles, B, 8] candidates merge by a stable top-k: highest score
//     first, lowest candidate position on ties (lax.top_k's rule).
// Rows past `rows` in the last, ragged tile do not exist: TMA zero-fills
// them and they are never selected.
//
// The per-tile rounds have a closed form, which lets the tile stream through
// shared memory instead of holding all its scores at once. With A = the
// tile's rows scoring above -2.0 in (score desc, column asc) order:
//   round i < |A|          -> A[i]
//   else, if any row >= -2 -> (-2.0, lowest column scoring >= -2.0)
//   else (all rows < -2)   -> round 0 takes the max (lowest column), later
//                             rounds that column again at -2.0.
// (After the rows above -2.0 are taken, every score is <= -2.0 and the
// -2.0 ones are the taken rows plus the rows that scored -2.0; the lowest of
// them is picked, and overwriting it with -2.0 changes nothing.) So per
// (query, tile) the kernel keeps: the strict top-k of rows above -2.0, the
// lowest column >= -2.0, and the arg-max.
//
// Bound at the main-path shape (rows = 2^20, D = 2048, bf16): the index is
// read once, 2^20 * 2048 * 2 B = 4.29 GB, 1.28 ms at 3.35 TB/s; the product
// at B = 64 is 275 GFLOP, 0.28 ms at 989 TFLOP/s. Bytes bound it. The design
// keeps the memory system busy and the index read once per 64 queries:
//   * a persistent grid: one block per SM (per group of 64 queries) walks a
//     contiguous range of 1024-row tiles and keeps a stable running top-k of
//     the candidates its tiles emit (exact for contiguous ranges in tile
//     order), so it writes KPAD candidates per query, not KPAD per tile;
//   * warp specialization: one producer warp issues TMA loads (128-byte
//     swizzle, 64-column boxes: 256 index rows and the group's N queries a
//     stage) into a ring of full/empty mbarriers, 4-6 stages deep; rows past
//     the end come back as zeros;
//   * two consumer warpgroups multiply with wgmma m64nNk16 (A = 128 index
//     rows each, B = the N queries, both K-major from the swizzled ring),
//     N = the real query count padded to 8, 16, 32 or 64, accumulators in
//     registers across the 32 k slices of a 256-row sub-chunk;
//   * the fold runs on those registers while the producer keeps loading: a
//     score goes further only if it beats the query's current k-th entry
//     (and, from a block's second tile on, the block's running k-th);
//     the lowest column >= -2.0 and the arg-max are reduced with shuffles and
//     shared-memory atomics; each warp's top-k of the survivors goes through
//     a warp merge into the tile state; named barriers of the 256 consumer
//     threads only, never a __syncthreads that would stall the ring.
// A second small kernel, one block per query, merges the [bpad, n_cta, 8]
// candidates (query-major, coalesced): each of k rounds takes the best
// candidate strictly worse than the previous pick, so nothing is rescanned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROW_TILE = 1024;  // rows per tile: the Pallas kernel's DEFAULT_ROW_TILE
constexpr int KPAD = 8;         // candidate lanes per tile
constexpr int SUB = 256;        // rows per sub-chunk: one TMA box, 128 per warpgroup
constexpr int KC = 64;          // k slice per stage: 128 bytes a row, the swizzle span
constexpr int QGROUP = 64;      // queries per block: the widest wgmma N used
constexpr int CWARPS = 8;       // consumer warps: two warpgroups
constexpr int CONSUMERS = CWARPS * 32;
constexpr int THREADS = CONSUMERS + 32;  // plus the producer warp
constexpr int SMEM_BUDGET = 225 * 1024;
constexpr int FOLD_BAR = 1;  // named barrier of the consumer threads
constexpr float NEG = -2.0f;
constexpr int NONE = 0x7fffffff;

template <int N>
struct State {
  float sv[N][CWARPS][KPAD];  // a sub-chunk's survivors: each warp's top-k per query
  int sc[N][CWARPS][KPAD];
  int sn[N][CWARPS];          // how many each warp wrote
  float lv[N][KPAD];          // the tile's strict top-k of rows above -2.0, (desc, asc)
  int lc[N][KPAD];
  int len[N];
  float thr_v[N];             // its k-th entry once full, else (-inf, NONE)
  int thr_c[N];
  int flag[N];                // some warp has survivors for this query
  int minge[N];               // lowest tile column scoring >= -2.0
  unsigned long long amax[N];  // arg-max over existing columns, as an order key
  float rv[N][KPAD];          // the block's running top-k of its tiles' candidates
  int rp[N][KPAD];            // candidate position: tile * KPAD + lane
  int ri[N][KPAD];            // row id
  float run_kth[N];           // its k-th score once full, else -inf
};

template <int N>
__host__ __device__ constexpr int stage_elems() { return (SUB + N) * KC; }
template <int N>
__host__ __device__ constexpr int n_stages() {
  return (SMEM_BUDGET - 1024 - (int)sizeof(State<N>)) / (stage_elems<N>() * 2 + 16) > 6
             ? 6
             : (SMEM_BUDGET - 1024 - (int)sizeof(State<N>)) / (stage_elems<N>() * 2 + 16);
}
template <int N>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + n_stages<N>() * (stage_elems<N>() * 2 + 16) + (int)sizeof(State<N>);
}

__device__ __forceinline__ bool better(float v, int c, float bv, int bc) {
  return v > bv || (v == bv && c < bc);
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    int oc = __shfl_xor_sync(0xffffffffu, bc, off);
    if (better(ov, oc, bv, bc)) {
      bv = ov;
      bc = oc;
    }
  }
}

// (score desc, column asc) as one unsigned key: max of keys = the arg-max.
__device__ __forceinline__ unsigned long long amax_key(float v, int c) {
  uint32_t u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (uint32_t)(~c);
}
__device__ __forceinline__ void amax_decode(unsigned long long key, float& v, int& c) {
  uint32_t u = (uint32_t)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  v = __uint_as_float(u);
  c = ~(int)(uint32_t)key;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// A wait past ~2^26 polls (seconds, where a stage takes microseconds) is a
// broken pipeline: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void fold_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(FOLD_BAR), "n"(CONSUMERS) : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading offset is unused for swizzled K-major layouts. The ring's stages
// are 1024-byte aligned, so a k step is a 32-byte move of the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[2][N / 2]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[m][i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] . B[N x 16]^T, both K-major in shared memory;
// scale_d = 0 starts a new sum.
template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma<8>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<16>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}


// grid (n_cta, bpad / N), block THREADS, dynamic shared memory smem_bytes<N>().
// Block c walks tiles [t0, t1) (cta_tile_ranges in ops/fused_topk.py) for
// queries [blockIdx.y * 64, + N) and writes cand_[vi][query][c][0..7].
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
topk_kernel(const __grid_constant__ CUtensorMap emb_map, const __grid_constant__ CUtensorMap q_map,
            const uint8_t* __restrict__ valid, int rows, int dim, int b, int k, int n_cta,
            float* __restrict__ cand_v, int* __restrict__ cand_i) {
  constexpr int STAGES = n_stages<N>();
  constexpr int EE = SUB * KC;  // index elements a stage
  constexpr int QE = N * KC;    // query elements a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* ering = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* qring = ering + STAGES * EE;
  State<N>& st = *reinterpret_cast<State<N>*>(qring + STAGES * QE);
  uint64_t* full = reinterpret_cast<uint64_t*>(&st + 1);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int cta = blockIdx.x;
  const int group = blockIdx.y;
  const int n_tiles = (rows + ROW_TILE - 1) / ROW_TILE;
  const int per = n_tiles / n_cta, rem = n_tiles % n_cta;
  const int t0 = cta * per + min(cta, rem);
  const int t1 = t0 + per + (cta < rem ? 1 : 0);
  const int nq = min(N, b - group * QGROUP);  // real queries of this block
  const int n_k = dim / KC;

  for (int i = tid; i < N; i += THREADS) {
    st.len[i] = 0;
    st.thr_v[i] = -INFINITY;
    st.thr_c[i] = NONE;
    st.flag[i] = 0;
    st.minge[i] = NONE;
    st.amax[i] = 0;
    st.run_kth[i] = -INFINITY;
  }
  for (int i = tid; i < N * KPAD; i += THREADS) {
    (&st.rv[0][0])[i] = -INFINITY;
    (&st.rp[0][0])[i] = NONE;
    (&st.ri[0][0])[i] = 0;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CWARPS) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = t0; t < t1; ++t) {
        const int r0 = t * ROW_TILE;
        const int n_sub = min(ROW_TILE, rows - r0 + SUB - 1) / SUB;
        for (int sub = 0; sub < n_sub; ++sub)
          for (int kc = 0; kc < n_k; ++kc) {
            mbar_wait(&empty[s], ph ^ 1);
            mbar_expect_tx(&full[s], stage_elems<N>() * 2);
            tma_load_2d(ering + s * EE, &emb_map, &full[s], kc * KC, r0 + sub * SUB);
            tma_load_2d(qring + s * QE, &q_map, &full[s], kc * KC, group * QGROUP);
            if (++s == STAGES) {
              s = 0;
              ph ^= 1;
            }
          }
      }
    }
    return;
  }

  // The consumers. Warp w of warpgroup wg holds, for m tile mt and half eh,
  // sub-chunk row wg*128 + mt*64 + w*16 + lane/4 + eh*8, and queries
  // 8j + 2*(lane%4) + h: acc[mt][4j + 2eh + h]. The 8 lanes of one lane%4
  // "group" hold the same queries over 32 rows.
  const int wg = warp >> 2;
  const int grp = lane & 3;
  const unsigned gmask = 0x11111111u << grp;
  const bool leader = lane < 4;
  float acc[2][N / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.0f;
  int s = 0;
  uint32_t ph = 0;
  for (int t = t0; t < t1; ++t) {
    const int r0 = t * ROW_TILE;
    const int n_sub = min(ROW_TILE, rows - r0 + SUB - 1) / SUB;
    for (int sub = 0; sub < n_sub; ++sub) {
      int col[4];
      bool present[4], ok[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        col[i] = sub * SUB + wg * 128 + (i >> 1) * 64 + (warp & 3) * 16 + (lane >> 2) + (i & 1) * 8;
        present[i] = r0 + col[i] < rows;
        ok[i] = present[i] && valid[r0 + col[i]] != 0;
      }
      for (int kc = 0; kc < n_k; ++kc) {
        mbar_wait(&full[s], ph);
        __syncwarp();  // the fold diverges by lane group; wgmma wants whole warps
        fence_acc<N>(acc);
        wgmma_fence();
        const __nv_bfloat16* e = ering + s * EE + wg * 128 * KC;
        const __nv_bfloat16* qq = qring + s * QE;
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          const uint64_t db = sw128_desc(qq + ks * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            wgmma<N>(acc[mt], sw128_desc(e + mt * 64 * KC + ks * 16), db, (kc | ks) != 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_acc<N>(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }

      fold_sync();  // the previous fold is done with the survivors and the state
      // Fold, part 1, on the registers: the lowest column >= -2.0 and the
      // arg-max; the scores that beat the k-th entry, each group's top k of
      // them to shared memory. A tile's candidates come after every entry of
      // the block's running top-k, so once that is full with a k-th score
      // rk > -2.0 only scores above rk can still reach the output: the
      // others, and the tile's fill lanes (<= -2.0), are left out, which
      // keeps what the running top-k becomes exactly as it was.
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = 8 * j + 2 * grp + h;
          if (n >= nq) continue;  // uniform in the group
          const float rk = st.run_kth[n];
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = acc[i >> 1][4 * j + 2 * (i & 1) + h];
            v[i] = ok[i] ? a : (present[i] ? NEG : -INFINITY);
          }
          if (!(rk > NEG)) {  // the fill lanes may still count
            int ge = NONE;
            unsigned long long key = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (present[i]) {
                if (v[i] >= NEG) ge = min(ge, col[i]);
                const unsigned long long kk = amax_key(v[i], col[i]);
                key = kk > key ? kk : key;
              }
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              ge = min(ge, __shfl_xor_sync(gmask, ge, off));
              const unsigned long long ok2 = __shfl_xor_sync(gmask, key, off);
              key = ok2 > key ? ok2 : key;
            }
            if (leader) {
              if (ge < st.minge[n]) atomicMin(&st.minge[n], ge);
              if (key > st.amax[n]) atomicMax(&st.amax[n], key);
            }
          }
          const float tv = st.thr_v[n];
          const int tc = st.thr_c[n];
          unsigned take = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (v[i] > NEG && v[i] > rk && better(v[i], col[i], tv, tc)) take |= 1u << i;
          int r = 0;
          while (r < k && __any_sync(gmask, take != 0)) {
            float bv = -INFINITY;
            int bc = NONE;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (((take >> i) & 1u) && better(v[i], col[i], bv, bc)) {
                bv = v[i];
                bc = col[i];
              }
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              const float ov = __shfl_xor_sync(gmask, bv, off);
              const int oc = __shfl_xor_sync(gmask, bc, off);
              if (better(ov, oc, bv, bc)) {
                bv = ov;
                bc = oc;
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (col[i] == bc) take &= ~(1u << i);
            if (leader) {
              st.sv[n][warp][r] = bv;
              st.sc[n][warp][r] = bc;
            }
            ++r;
          }
          if (leader) {
            st.sn[n][warp] = r;
            if (r) st.flag[n] = 1;
          }
        }
      fold_sync();
      // Fold, part 2: one warp a query merges the state with the 8 warps'
      // survivors (k rounds of warp arg-max; columns are distinct).
      for (int n = warp; n < nq; n += CWARPS) {
        if (!st.flag[n]) continue;
        const int len = st.len[n];
        float a0 = -INFINITY, a1 = -INFINITY, a2 = -INFINITY;
        int c0 = NONE, c1 = NONE, c2 = NONE;
        if (lane < len) {
          a0 = st.lv[n][lane];
          c0 = st.lc[n][lane];
        }
        if ((lane & 7) < st.sn[n][lane >> 3]) {
          a1 = st.sv[n][lane >> 3][lane & 7];
          c1 = st.sc[n][lane >> 3][lane & 7];
        }
        if ((lane & 7) < st.sn[n][4 + (lane >> 3)]) {
          a2 = st.sv[n][4 + (lane >> 3)][lane & 7];
          c2 = st.sc[n][4 + (lane >> 3)][lane & 7];
        }
        float nv = -INFINITY;
        int nc = NONE, n_out = 0;
        for (int r = 0; r < k; ++r) {
          float bv = a0;
          int bc = c0;
          if (better(a1, c1, bv, bc)) {
            bv = a1;
            bc = c1;
          }
          if (better(a2, c2, bv, bc)) {
            bv = a2;
            bc = c2;
          }
          warp_argmax(bv, bc);
          if (bc == NONE) break;
          if (c0 == bc) a0 = -INFINITY, c0 = NONE;
          if (c1 == bc) a1 = -INFINITY, c1 = NONE;
          if (c2 == bc) a2 = -INFINITY, c2 = NONE;
          if (lane == r) {
            nv = bv;
            nc = bc;
          }
          n_out = r + 1;
        }
        __syncwarp();
        if (lane < n_out) {
          st.lv[n][lane] = nv;
          st.lc[n][lane] = nc;
        }
        const float kv = __shfl_sync(0xffffffffu, nv, k - 1);
        const int kcol = __shfl_sync(0xffffffffu, nc, k - 1);
        if (lane == 0) {
          st.len[n] = n_out;
          st.flag[n] = 0;
          st.thr_v[n] = n_out == k ? kv : -INFINITY;
          st.thr_c[n] = n_out == k ? kcol : NONE;
        }
      }
    }
    fold_sync();
    // Tile done: its 8 candidates by the closed form of the Pallas rounds
    // (lanes 0-7), merged with the block's running top-k (lanes 8-15) by
    // (score desc, position asc); then the tile state starts over. Past a
    // full running top-k above -2.0 the fill lanes cannot win (part 1).
    for (int n = warp; n < nq; n += CWARPS) {
      float v = -INFINITY;
      int p = NONE, id = 0;
      if (lane < KPAD) {
        v = NEG;
        p = t * KPAD + lane;
        if (lane >= st.len[n] && st.run_kth[n] > NEG) {
          v = -INFINITY;
        } else if (lane < k) {
          if (lane < st.len[n]) {
            v = st.lv[n][lane];
            id = r0 + st.lc[n][lane];
          } else if (st.minge[n] != NONE) {
            id = r0 + st.minge[n];
          } else {
            float mv;
            int mc;
            amax_decode(st.amax[n], mv, mc);
            if (lane == 0) v = mv;
            id = r0 + mc;
          }
        }
      } else if (lane < KPAD + k) {
        v = st.rv[n][lane - KPAD];
        p = st.rp[n][lane - KPAD];
        id = st.ri[n][lane - KPAD];
      }
      float ov = -INFINITY;
      int op = NONE, oid = 0;
      for (int r = 0; r < k; ++r) {
        float bv = v;
        int bp = p, bid = id;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float xv = __shfl_xor_sync(0xffffffffu, bv, off);
          const int xp = __shfl_xor_sync(0xffffffffu, bp, off);
          const int xid = __shfl_xor_sync(0xffffffffu, bid, off);
          if (better(xv, xp, bv, bp)) {
            bv = xv;
            bp = xp;
            bid = xid;
          }
        }
        if (p == bp) v = -INFINITY, p = NONE;
        if (lane == r) {
          ov = bv;
          op = bp;
          oid = bid;
        }
      }
      __syncwarp();
      if (lane < k) {
        st.rv[n][lane] = ov;
        st.rp[n][lane] = op;
        st.ri[n][lane] = oid;
      }
      const float kth = __shfl_sync(0xffffffffu, ov, k - 1);
      if (lane == 0) {
        st.run_kth[n] = kth;
        st.len[n] = 0;
        st.thr_v[n] = -INFINITY;
        st.thr_c[n] = NONE;
        st.minge[n] = NONE;
        st.amax[n] = 0;
      }
    }
  }
  // The block's candidates, query-major; lanes k..7 never win the merge.
  for (int n = warp; n < nq; n += CWARPS) {
    __syncwarp();
    if (lane < KPAD) {
      const size_t o = ((size_t)(group * QGROUP + n) * n_cta + cta) * KPAD + lane;
      cand_v[o] = lane < k ? st.rv[n][lane] : -INFINITY;
      cand_i[o] = lane < k ? st.ri[n][lane] : 0;
    }
  }
}

constexpr int MTHREADS = 256;

// grid (b), block MTHREADS: the stable top-k of one query's n candidates.
// Round r takes the best candidate strictly worse, in (value desc, position
// asc), than round r-1's pick: positions are distinct, so nothing is taken
// twice and no list of taken ones is kept.
__global__ void __launch_bounds__(MTHREADS)
merge_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i, int n, int k,
             float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float wv[MTHREADS / 32];
  __shared__ int wp[MTHREADS / 32];
  __shared__ float pick_v;
  __shared__ int pick_p;
  const int qi = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* cv = cand_v + (size_t)qi * n;
  float last_v = INFINITY;
  int last_p = -1;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bp = NONE;
    for (int p = threadIdx.x; p < n; p += MTHREADS) {
      const float v = cv[p];
      if (better(last_v, last_p, v, p) && better(v, p, bv, bp)) {
        bv = v;
        bp = p;
      }
    }
    warp_argmax(bv, bp);
    if (lane == 0) {
      wv[warp] = bv;
      wp[warp] = bp;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < MTHREADS / 32 ? wv[lane] : -INFINITY;
      bp = lane < MTHREADS / 32 ? wp[lane] : NONE;
      warp_argmax(bv, bp);
      if (lane == 0) {
        out_v[(size_t)qi * k + r] = bv;
        out_i[(size_t)qi * k + r] = cand_i[(size_t)qi * n + bp];
        pick_v = bv;
        pick_p = bp;
      }
    }
    __syncthreads();
    last_v = pick_v;
    last_p = pick_p;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded: the
// library links no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res) !=
            cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess) return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [n_rows, dim] bf16 row-major tensor read in boxes of box_rows x KC with
// the 128-byte swizzle; rows past n_rows read as zeros.
bool encode_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int n_rows, int dim, int box_rows) {
  const cuuint64_t gdim[2] = {(cuuint64_t)dim, (cuuint64_t)n_rows};
  const cuuint64_t gstride[1] = {(cuuint64_t)dim * 2};
  const cuuint32_t box[2] = {(cuuint32_t)KC, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), gdim, gstride, box, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N>
cudaError_t launch_tiles(const CUtensorMap& emb_map, const CUtensorMap& q_map, const void* valid, int rows,
                         int dim, int b, int k, int n_cta, int groups, void* cand_v, void* cand_i,
                         cudaStream_t s) {
  static_assert(smem_bytes<N>() <= 232448, "shared memory past the H100's 227 KB");
  static_assert(n_stages<N>() >= 4, "ring too shallow");
  cudaError_t err =
      cudaFuncSetAttribute(topk_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<N>());
  if (err != cudaSuccess) return err;
  topk_kernel<N><<<dim3(n_cta, groups), THREADS, smem_bytes<N>(), s>>>(
      emb_map, q_map, static_cast<const uint8_t*>(valid), rows, dim, b, k, n_cta, static_cast<float*>(cand_v),
      static_cast<int*>(cand_i));
  return cudaGetLastError();
}

}  // namespace

// emb [rows, dim] bf16 (dim % 64 == 0, 16-byte aligned), valid [rows] bytes
// (0/1), q [bpad, dim] bf16 with bpad = 8, 16, 32 or 64 for b <= 64, else
// ceil(b / 64) * 64 (query_pad in ops/fused_topk.py); n_sm the card's SMs;
// scratch cand_v/cand_i of cand_n >= bpad * min(n_sm, n_tiles) * 8 elements;
// outputs out_v [b, k] f32 and out_i [b, k] i32. Launches on `stream`, does
// not synchronise; returns the CUDA error code (0 on success).
extern "C" int kkv_fused_topk(const void* emb, const void* valid, const void* q, int rows, int dim, int bpad,
                              int b, int k, int n_sm, void* cand_v, void* cand_i, int cand_n, void* out_v,
                              void* out_i, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int want_pad = b > QGROUP ? (b + QGROUP - 1) / QGROUP * QGROUP
                                  : (b <= 8 ? 8 : b <= 16 ? 16 : b <= 32 ? 32 : 64);
  if (rows < 1 || dim < KC || dim % KC != 0 || k < 1 || k > KPAD || b < 1 || bpad != want_pad || n_sm < 1 ||
      reinterpret_cast<uintptr_t>(emb) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (rows + ROW_TILE - 1) / ROW_TILE;
  const int n_cta = n_sm < n_tiles ? n_sm : n_tiles;
  if (cand_n < 0 || (long long)cand_n < (long long)bpad * n_cta * KPAD) return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const int width = bpad < QGROUP ? bpad : QGROUP;
  CUtensorMap emb_map, q_map;
  if (!encode_map(fn, &emb_map, emb, rows, dim, SUB) || !encode_map(fn, &q_map, q, bpad, dim, width))
    return (int)cudaErrorInvalidValue;
  const int groups = bpad / width;
  cudaError_t err;
  switch (width) {
    case 8:
      err = launch_tiles<8>(emb_map, q_map, valid, rows, dim, b, k, n_cta, groups, cand_v, cand_i, s);
      break;
    case 16:
      err = launch_tiles<16>(emb_map, q_map, valid, rows, dim, b, k, n_cta, groups, cand_v, cand_i, s);
      break;
    case 32:
      err = launch_tiles<32>(emb_map, q_map, valid, rows, dim, b, k, n_cta, groups, cand_v, cand_i, s);
      break;
    default:
      err = launch_tiles<64>(emb_map, q_map, valid, rows, dim, b, k, n_cta, groups, cand_v, cand_i, s);
  }
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<b, MTHREADS, 0, s>>>(static_cast<const float*>(cand_v), static_cast<const int*>(cand_i),
                                      n_cta * KPAD, k, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

// The tile kernel's dynamic shared memory and ring depth at wgmma width
// `width` (8, 16, 32 or 64); -1 for another width.
extern "C" int kkv_fused_topk_smem_bytes(int width) {
  return width == 8 ? smem_bytes<8>() : width == 16 ? smem_bytes<16>() : width == 32 ? smem_bytes<32>()
                                                    : width == 64 ? smem_bytes<64>() : -1;
}
extern "C" int kkv_fused_topk_stages(int width) {
  return width == 8 ? n_stages<8>() : width == 16 ? n_stages<16>() : width == 32 ? n_stages<32>()
                                                  : width == 64 ? n_stages<64>() : -1;
}
