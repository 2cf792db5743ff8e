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
// Rows past `rows` in the last, ragged tile do not exist: they are never
// read (zero-filled) and never selected.
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
// Bound at the main-path shape (rows = 2^20, D = 2048, B = 64, bf16): the
// index is read once, 2^20 * 2048 * 2 B = 4.29 GB, 1.28 ms at 3.35 TB/s; the
// product is 2 * 64 * 2^20 * 2048 = 275 GFLOP, 0.28 ms at 989 TFLOP/s bf16.
// Bytes bound it as long as the product runs on the tensor cores and the
// index is read once, which is what the design is for:
//   * one block per (1024-row tile, group of QB queries): QB = 16 when
//     B <= 16 (the single warn), else 64, so each index byte leaves device
//     memory once per 64 queries; the groups of one tile are neighbours in
//     launch order;
//   * the tile streams in SUB = 128-row sub-chunks; each sub-chunk's rows and
//     the group's queries stream through a cp.async ring of KC = 64-wide k
//     slices (coalesced 16-byte copies, 128 contiguous bytes a row, zero-fill
//     past the last row), one continuous pipeline across sub-chunks; 4 stages
//     for QB = 16 and 2 for QB = 64, so that two blocks fit on an SM;
//   * 8 warps run wmma bf16 16x16x16 (mma.sync) with f32 accumulators; the
//     [QB, SUB] scores go to shared memory and each warp folds its queries'
//     scores into the streaming per-(query, tile) state.
// A second small kernel, one block per query, merges the per-tile
// candidates. TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int ROW_TILE = 1024;  // rows per tile: the Pallas kernel's DEFAULT_ROW_TILE
constexpr int KPAD = 8;         // candidate lanes per tile
constexpr int SUB = 128;        // rows per sub-chunk
constexpr int KC = 64;          // k slice per pipeline stage: 128 contiguous bytes a row
constexpr int QBIG = 64;        // queries per block when B > 16
constexpr int STAGES_SMALL = 4;  // ring depth for 16-query blocks (92 KB: 2 blocks/SM)
constexpr int STAGES_BIG = 2;    // ring depth for 64-query blocks (94 KB: 2 blocks/SM)
constexpr int LDS = KC + 8;     // staged row stride (elements), keeps wmma alignment
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SLD = SUB + 4;    // score row stride (floats)
constexpr float NEG = -2.0f;
constexpr int NONE = 0x7fffffff;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int QB, int STAGES>
struct Smem {
  __nv_bfloat16 e[STAGES][SUB][LDS];
  __nv_bfloat16 q[STAGES][QB][LDS];
  float scores[QB][SLD];
  float lv[QB][KPAD];  // strict top-k of the rows above -2.0, (desc, asc)
  int lc[QB][KPAD];
  int len[QB];
  int minge[QB];  // lowest column scoring >= -2.0
  float maxv[QB];  // arg-max over existing columns
  int maxc[QB];
};

// grid (bpad / QB, n_tiles), block THREADS, dynamic shared memory
// sizeof(Smem<QB, STAGES>).
template <int QB, int STAGES>
__global__ void __launch_bounds__(THREADS)
tile_topk_kernel(const __nv_bfloat16* __restrict__ emb, const uint8_t* __restrict__ valid,
                 const __nv_bfloat16* __restrict__ q, int rows, int dim, int bpad, int k,
                 float* __restrict__ cand_v, int* __restrict__ cand_i) {
  constexpr int WARPS_M = QB / 32 > 0 ? QB / 32 : 1;  // 2 for QB = 64, else 1
  constexpr int WARPS_N = WARPS / WARPS_M;
  constexpr int FM = QB / 16 / WARPS_M;
  constexpr int FN = SUB / 16 / WARPS_N;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<QB, STAGES>& sm = *reinterpret_cast<Smem<QB, STAGES>*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int group = blockIdx.x;  // groups of one tile are neighbours in launch order
  const int tile = blockIdx.y;
  const int base = tile * ROW_TILE;
  const int n_sub = min(ROW_TILE, rows - base + SUB - 1) / SUB;  // sub-chunks with rows
  const int n_k = dim / KC;
  const int n_steps = n_sub * n_k;
  const __nv_bfloat16* qg = q + (size_t)group * QB * dim;

  for (int m = tid; m < QB; m += THREADS) {
    sm.len[m] = 0;
    sm.minge[m] = NONE;
    sm.maxv[m] = -INFINITY;
    sm.maxc[m] = NONE;
  }

  auto load_stage = [&](int step) {
    const int buf = step % STAGES;
    const int r0 = base + (step / n_k) * SUB;
    const int k0 = (step % n_k) * KC;
    constexpr int PARTS = KC / 8;  // 16-byte pieces per row slice
    for (int idx = tid; idx < SUB * PARTS; idx += THREADS) {
      const int r = idx / PARTS, p = idx % PARTS;
      const bool ok = r0 + r < rows;
      const __nv_bfloat16* src = emb + (size_t)(ok ? r0 + r : 0) * dim + k0 + p * 8;
      cp_async16(&sm.e[buf][r][p * 8], src, ok);
    }
    for (int idx = tid; idx < QB * PARTS; idx += THREADS) {
      const int r = idx / PARTS, p = idx % PARTS;
      cp_async16(&sm.q[buf][r][p * 8], qg + (size_t)r * dim + k0 + p * 8, true);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load_stage(s);
    cp_async_commit();
  }

  FragC acc[FM][FN];
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (step + STAGES - 1 < n_steps) load_stage(step + STAGES - 1);
    cp_async_commit();

    const int buf = step % STAGES;
    const int kc = step % n_k;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    }
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      FragA a[FM];
      FragB b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], &sm.q[buf][(wm * FM + i) * 16][kk], LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], &sm.e[buf][(wn * FN + j) * 16][kk], LDS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (kc != n_k - 1) continue;

    // Sub-chunk done: scores to shared memory, then fold them into the state.
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(&sm.scores[(wm * FM + i) * 16][(wn * FN + j) * 16], acc[i][j],
                                SLD, wmma::mem_row_major);
    __syncthreads();
    const int col0 = (step / n_k) * SUB;  // tile column of the sub-chunk's first row
    for (int m = warp; m < QB; m += WARPS) {
      float v[SUB / 32];
      int ge = NONE;
      float mv = -INFINITY;
      int mc = NONE;
#pragma unroll
      for (int j = 0; j < SUB / 32; ++j) {
        const int c = col0 + lane + 32 * j;
        const int row = base + c;
        if (row < rows) {
          const float s = valid[row] ? sm.scores[m][lane + 32 * j] : NEG;
          v[j] = s;
          if (s >= NEG && c < ge) ge = c;
          if (better(s, c, mv, mc)) {
            mv = s;
            mc = c;
          }
        } else {
          v[j] = -INFINITY;  // absent row: never above -2.0
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ge = min(ge, __shfl_xor_sync(0xffffffffu, ge, off));
      warp_argmax(mv, mc);

      const int len = sm.len[m];
      const float tv = len == k ? sm.lv[m][k - 1] : -INFINITY;
      const int tc = len == k ? sm.lc[m][k - 1] : NONE;
      // Only rows above -2.0 that beat the current k-th entry can enter.
      unsigned take = 0;
#pragma unroll
      for (int j = 0; j < SUB / 32; ++j)
        if (v[j] > NEG && better(v[j], col0 + lane + 32 * j, tv, tc)) take |= 1u << j;
      const bool any = __any_sync(0xffffffffu, take != 0);
      if (lane == 0) {
        sm.minge[m] = min(sm.minge[m], ge);
        if (better(mv, mc, sm.maxv[m], sm.maxc[m])) {
          sm.maxv[m] = mv;
          sm.maxc[m] = mc;
        }
      }
      if (!any) continue;
      // Merge: k rounds of warp argmax over the old entries (lane i holds
      // entry i) and the new candidates.
      bool old_live = lane < len;
      const float ov = old_live ? sm.lv[m][lane] : -INFINITY;
      const int oc = old_live ? sm.lc[m][lane] : NONE;
      float nv = 0.0f;
      int nc = 0;
      int n_out = 0;
      for (int r = 0; r < k; ++r) {
        float bv = -INFINITY;
        int bc = NONE;
        if (old_live) {
          bv = ov;
          bc = oc;
        }
#pragma unroll
        for (int j = 0; j < SUB / 32; ++j)
          if ((take >> j) & 1u && better(v[j], col0 + lane + 32 * j, bv, bc)) {
            bv = v[j];
            bc = col0 + lane + 32 * j;
          }
        warp_argmax(bv, bc);
        if (bc == NONE) break;
        if (old_live && oc == bc) old_live = false;
#pragma unroll
        for (int j = 0; j < SUB / 32; ++j)
          if (col0 + lane + 32 * j == bc) take &= ~(1u << j);
        if (lane == r) {
          nv = bv;
          nc = bc;
        }
        n_out = r + 1;
      }
      __syncwarp();
      if (lane < n_out) {
        sm.lv[m][lane] = nv;
        sm.lc[m][lane] = nc;
      }
      if (lane == 0) sm.len[m] = n_out;
      __syncwarp();
    }
  }
  __syncthreads();

  // Emit the tile's candidates by the closed form of the Pallas rounds.
  for (int idx = tid; idx < QB * KPAD; idx += THREADS) {
    const int m = idx / KPAD, i = idx % KPAD;
    float ov = NEG;
    int oc = 0;
    if (i < k) {
      if (i < sm.len[m]) {
        ov = sm.lv[m][i];
        oc = base + sm.lc[m][i];
      } else if (sm.minge[m] != NONE) {
        oc = base + sm.minge[m];
      } else {
        ov = i == 0 ? sm.maxv[m] : NEG;
        oc = base + sm.maxc[m];
      }
    }
    const size_t out = ((size_t)tile * bpad + (size_t)group * QB + m) * KPAD + i;
    cand_v[out] = ov;
    cand_i[out] = oc;
  }
}

// grid (b), block THREADS: stable top-k of one query's n_tiles * KPAD candidates.
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i, int n_tiles,
             int bpad, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ int chosen[KPAD];
  __shared__ float wv[WARPS];
  __shared__ int wp[WARPS];
  const int qi = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = n_tiles * KPAD;
  for (int it = 0; it < k; ++it) {
    float bv = -INFINITY;
    int bp = NONE;
    for (int p = threadIdx.x; p < n; p += THREADS) {
      bool taken = false;
      for (int c = 0; c < it; ++c) taken |= (chosen[c] == p);
      if (taken) continue;
      const float v = cand_v[((size_t)(p / KPAD) * bpad + qi) * KPAD + (p % KPAD)];
      if (better(v, p, bv, bp)) {
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
    if (threadIdx.x == 0) {
      for (int w = 1; w < WARPS; ++w)
        if (better(wv[w], wp[w], bv, bp)) {
          bv = wv[w];
          bp = wp[w];
        }
      chosen[it] = bp;
      out_v[(size_t)qi * k + it] = bv;
      out_i[(size_t)qi * k + it] =
          cand_i[((size_t)(bp / KPAD) * bpad + qi) * KPAD + (bp % KPAD)];
    }
    __syncthreads();
  }
}

template <int QB, int STAGES>
cudaError_t launch_tiles(const void* emb, const void* valid, const void* q, int rows, int dim,
                         int bpad, int k, void* cand_v, void* cand_i, cudaStream_t s) {
  const int bytes = (int)sizeof(Smem<QB, STAGES>);
  cudaError_t err = cudaFuncSetAttribute(tile_topk_kernel<QB, STAGES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (rows + ROW_TILE - 1) / ROW_TILE;
  tile_topk_kernel<QB, STAGES><<<dim3(bpad / QB, n_tiles), THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(emb), static_cast<const uint8_t*>(valid),
      static_cast<const __nv_bfloat16*>(q), rows, dim, bpad, k, static_cast<float*>(cand_v),
      static_cast<int*>(cand_i));
  return cudaGetLastError();
}

}  // namespace

// emb [rows, dim] bf16 (dim % 32 == 0), valid [rows] bytes (0/1), q [bpad, dim]
// bf16 with bpad == 16 or bpad % 64 == 0, scratch cand_v/cand_i
// [ceil(rows/1024), bpad, 8], outputs out_v [b, k] f32 and out_i [b, k] i32
// for the first b queries. Launches on `stream`, does not synchronise;
// returns the CUDA error code (0 on success).
extern "C" int kkv_fused_topk(const void* emb, const void* valid, const void* q, int rows,
                              int dim, int bpad, int b, int k, void* cand_v, void* cand_i,
                              void* out_v, void* out_i, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dim % KC != 0 || k < 1 || k > KPAD || (bpad != 16 && bpad % QBIG != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = bpad == 16
                        ? launch_tiles<16, STAGES_SMALL>(emb, valid, q, rows, dim, bpad, k, cand_v, cand_i, s)
                        : launch_tiles<QBIG, STAGES_BIG>(emb, valid, q, rows, dim, bpad, k, cand_v, cand_i, s);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (rows + ROW_TILE - 1) / ROW_TILE;
  merge_kernel<<<b, THREADS, 0, s>>>(static_cast<const float*>(cand_v),
                                     static_cast<const int*>(cand_i), n_tiles, bpad, k,
                                     static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
