// The float32 body of the blockwise online-softmax GQA attention over a
// head-major KV cache, for Hopper (sm_90a). Built as one library per head_dim
// (ops/_build.py passes -DKKV_HEAD_DIM=64 or 128, beside the bf16 libraries
// of flash_gqa_cache.cu, all compiled in parallel).
//
// Replaces the Pallas TPU kernel kakveda_tpu/models/attention.py::
// flash_gqa_cache (pl.pallas_call at attention.py:284, body _flash_kernel
// through _flash_body) where the model runs in float32: the JAX package's
// kernel takes any dtype where _flash_ok holds (D = 64 or a multiple of 128),
// and its f32 path is f32 end to end (p.astype(v.dtype) keeps P in f32). It
// computes what flash_gqa_cache.cu's bf16 body computes, with every operand
// and product in f32:
//   * the R = H / KV query heads of one kv head fold into the q rows: folded
//     row i of (b, g) is sequence position pos0 + i / R, with pos0 one host
//     int or, given the device vector pos0_vec [B], pos0_vec[b];
//   * S = Q.K^T * D^-0.5 in f32; with an attention softcap S becomes
//     cap * tanh(S / cap) before the mask;
//   * keep(i, l) = l < L && q_pos >= l && kv_valid[b, l]
//                  && (window == 0 || q_pos - l < window);
//     masked scores are -1e30, and p is masked again after the exp;
//   * online softmax in f32 over 64-row cache tiles (m, l, acc), P kept in
//     f32 for P.V;
//   * out = acc / max(l, 1e-20): a row that sees no slot emits zeros.
//
// Arithmetic: FFMA on the CUDA cores, not the tensor cores. TF32 mma keeps a
// 10-bit mantissa (~1e-3 from the f32 function), which is another function;
// the 3xTF32 split would restore f32 accuracy at three products a step. The
// shapes this body serves are bound by bytes: decode reads 8 bytes of K/V for
// every 2 flops of a query row (S*R = 4 rows: ~1 flop a byte, where the
// card's f32 rate binds only past ~20 flops a byte), so plain FFMA costs
// little there and gives f32 sums exactly as the plain version takes them, up
// to their order. Prefill pieces (S*R in the thousands) are compute-bound in
// f32 either way; their FFMA rate is the price of the exact function.
//
// The contract is the bf16 body's: split L across blocks with per-device
// tickets (graph-capturable), pos0 as a host int or a device pos0_vec,
// kv_valid, window and softcap, tiles no row of the block sees skipped before
// any copy, and the split count read from Cfg::BLOCKS.
//
// Shared memory. An f32 K/V tile of 64 rows at D = 128 is 33 KB (rows padded
// to D + 4 floats, so that the 8 rows of a 16-byte load phase fall on
// distinct banks), one stage of K and V 66 KB: the bf16 body's 3-stage ring
// with its 64 q rows would pass the 227 KB a block may hold. The ring is
// re-planned by stage count: 3 stages (198 KB) at D = 128 for decode blocks
// (16 q rows), one block per SM with two tiles in flight; 2 stages where the
// block holds 64 q rows or at D = 64, where two blocks per SM then fit.
//
// Work split. A block has 4 warps and 16 (S*R <= 16, every decode) or 64 q
// rows. With 16 rows the 4 warps split each tile's 64 cache rows, 16 each,
// and keep their own (m, l, o), merged through shared memory at the end; with
// 64 rows each warp owns 16 q rows and all 64 cache rows. Q.K^T: lanes run
// along a warp's cache rows (16 or 32 lanes, one or two rows each) and down
// its q rows; the row's max and sum go by shuffles. P goes through shared
// memory to P.V, where each lane owns D / 32 output columns of every q row.
// Each lane works on 4 q rows at a time, so the FMA chains of a row group
// are independent; warps skip the groups past the block's real rows (a
// decode's S*R = 4 of 16), a test that is uniform across the warp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef KKV_HEAD_DIM
#error "build one library per head_dim: nvcc -DKKV_HEAD_DIM=64 or 128 (ops/_build.py does)"
#endif

namespace {

constexpr int BN = 64;        // cache rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_TPS = 256;    // tiles per split (the live-tile list in shared memory)
constexpr int MAX_SPLITS = 64;  // splits of one (b*kv, q block): the combine's weights in shared memory
constexpr float NEG_INF = -1e30f;

template <int D, int NQW>
struct Cfg {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static constexpr int QB = 16 * NQW;      // folded q rows of a block
  static constexpr int WPQ = WARPS / NQW;  // warps sharing one 16-row q tile
  static constexpr int CW = BN / WPQ;      // cache rows of each tile that one warp takes
  static constexpr int RS = D + 4;         // floats per K, V or q row in shared memory
  static constexpr int PS = CW + 4;        // floats per P row (16-byte aligned rows)
  static constexpr int STAGES = (D >= 128 && NQW == 1) ? 3 : 2;
  static constexpr int TILE = BN * RS * 4;  // bytes of K or V of one stage
  static constexpr int STAGE = 2 * TILE;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int RED = (WARPS * 16 * D + 2 * WARPS * 16 + 2 * 64) * 4;  // per-warp o, m, l; per-row m, l
  static constexpr int COMB = MAX_SPLITS * 64 * 2 * 4;                      // the split combine's m and l
  static constexpr int MAIN = RING > RED ? (RING > COMB ? RING : COMB) : (RED > COMB ? RED : COMB);
  static constexpr int QSM = QB * RS * 4;
  static constexpr int PSM = WARPS * 16 * PS * 4;
  static constexpr int CSM = WARPS * 16 * 4;
  static constexpr int SMEM = MAIN + QSM + PSM + CSM + MAX_TPS * 8 + MAX_TPS * 2 + 16;
  static_assert(SMEM <= 227 * 1024, "one block's shared memory");
  // Resident blocks per SM the launch bounds and the split count plan for
  // (read through kkv_flash_gqa_cache_blocks_per_sm): two where their
  // shared memory fits the SM's 228 KB (1 KB of it reserved per block).
  static constexpr int BLOCKS = 2 * (SMEM + 1024) <= 228 * 1024 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int N>
struct Vec;
template <>
struct Vec<2> {
  using T = float2;
  __device__ static void get(const T& v, float (&o)[2]) { o[0] = v.x; o[1] = v.y; }
  __device__ static T make(const float (&o)[2]) { return make_float2(o[0], o[1]); }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static void get(const T& v, float (&o)[4]) { o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w; }
  __device__ static T make(const float (&o)[4]) { return make_float4(o[0], o[1], o[2], o[3]); }
};

// grid (B * KV, ceil(SR / (16 * NQW)), n_split), block THREADS, dynamic
// shared memory Cfg<D, NQW>::SMEM. NQW is the number of 16-row q tiles of a
// block: 1 when S*R <= 16, else 4. CAP: scores are softcapped at `cap`.
template <int D, int NQW, bool CAP>
__global__ void __launch_bounds__(THREADS, Cfg<D, NQW>::BLOCKS)
flash_gqa_f32_kernel(const float* __restrict__ q,        // [B*KV, SR, D]
                     const float* __restrict__ k,        // [B*KV, L, D]
                     const float* __restrict__ v,
                     const uint8_t* __restrict__ valid,  // [B, L] or null
                     float* __restrict__ out,            // [B*KV, SR, D]
                     float* __restrict__ part,           // split partials (n_split > 1)
                     int* __restrict__ tickets,          // [B*KV * q blocks], zero between launches
                     const int* __restrict__ pos0_vec,   // [B] or null (then pos0)
                     int kv, int sr, int r, int L, int pos0_, int window, float scale, float cap,
                     int tps) {
  using C = Cfg<D, NQW>;
  constexpr int QB = C::QB;
  constexpr int WPQ = C::WPQ;
  constexpr int CW = C::CW;
  constexpr int RS = C::RS;
  constexpr int PS = C::PS;
  constexpr int LC = CW < 32 ? CW : 32;  // lanes along a warp's cache rows
  constexpr int LH = 32 / LC;            // lane groups down its q rows
  constexpr int CPL = CW / LC;           // cache rows per lane
  constexpr int RPL = 16 / LH;           // q rows per lane
  constexpr int NC = D / 32;             // P.V output columns per lane
  constexpr int G = 4;                   // q rows a lane works on at once
  using V = Vec<NC>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* qs = reinterpret_cast<float*>(smem + C::MAIN);                      // [QB][RS]
  float* ps = reinterpret_cast<float*>(smem + C::MAIN + C::QSM);             // [WARPS][16][PS]
  float* cs = reinterpret_cast<float*>(smem + C::MAIN + C::QSM + C::PSM);    // [WARPS][16]
  unsigned char* lists = smem + C::MAIN + C::QSM + C::PSM + C::CSM;
  uint2* vmask = reinterpret_cast<uint2*>(lists);  // per tile: valid bits, even / odd rows
  short* live = reinterpret_cast<short*>(lists + MAX_TPS * 8);
  int* flag = reinterpret_cast<int*>(lists + MAX_TPS * 10);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c = lane % LC;  // this lane's first cache row within the warp's
  const int h = lane / LC;  // ... and its first q row within the warp's 16
  const int bkv = blockIdx.x;
  const int bq = bkv * gridDim.y + blockIdx.y;
  const int z = blockIdx.z;
  const int n_split = gridDim.z;
  const int row0 = blockIdx.y * QB;
  const int rows = min(QB, sr - row0);  // real rows of this block
  const int qt = warp % NQW;            // this warp's q tile
  const int cw0 = (warp / NQW) * CW;    // its first cache row within a tile
  const int wrow = row0 + qt * 16;
  const int nr = max(0, min(16, rows - qt * 16));  // real rows of this warp's q tile
  const int n_tiles = (L + BN - 1) / BN;
  const int t0 = z * tps;
  const int ntl = min(tps, n_tiles - t0);  // tiles of this split
  const size_t kv_base = (size_t)bkv * L;
  const uint8_t* vrow = valid ? valid + (size_t)(bkv / kv) * L : nullptr;
  const int pos0 = pos0_vec ? __ldg(pos0_vec + bkv / kv) : pos0_;
  const int qmin = pos0 + row0 / r;
  const int qmax = pos0 + (row0 + rows - 1) / r;

  // 1. Which tiles of the split can a row of this block see? One warp vote
  //    per tile over its validity bytes and the block's causal and window
  //    bounds; then warp 0 lists the live ones in order.
  for (int i = warp; i < ntl; i += WARPS) {
    const int c0 = (t0 + i) * BN + 2 * lane;
    const bool v0 = c0 < L && (vrow == nullptr || vrow[c0] != 0);
    const bool v1 = c0 + 1 < L && (vrow == nullptr || vrow[c0 + 1] != 0);
    const bool r0 = c0 <= qmax && (window == 0 || qmin - c0 < window);
    const bool r1 = c0 + 1 <= qmax && (window == 0 || qmin - c0 - 1 < window);
    const unsigned b0 = __ballot_sync(0xffffffffu, v0);
    const unsigned b1 = __ballot_sync(0xffffffffu, v1);
    const bool any = __any_sync(0xffffffffu, (v0 && r0) || (v1 && r1));
    if (lane == 0) {
      vmask[i] = make_uint2(b0, b1);
      live[i] = any ? 1 : 0;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < ntl; base += 32) {
      const int i = base + lane;
      const bool f = i < ntl && live[i] != 0;
      const unsigned b = __ballot_sync(0xffffffffu, f);
      if (f) live[n + __popc(b & ((1u << lane) - 1u))] = (short)i;
      n += __popc(b);
    }
    if (lane == 0) *flag = n;
  }
  __syncthreads();
  const int n_live = *flag;

  auto load_tile = [&](int tile, int stage) {
    constexpr int CH = D / 4;  // 16-byte chunks per cache row
    const int l0 = tile * BN;
    float* st = ring + stage * (C::STAGE / 4);
    const float* kg = k + kv_base * D;
    const float* vg = v + kv_base * D;
    for (int idx = tid; idx < BN * CH; idx += THREADS) {
      const int rr = idx / CH, cc = idx % CH;
      const bool ok = l0 + rr < L;
      const size_t off = ok ? (size_t)(l0 + rr) * D + cc * 4 : 0;
      cp_async16(st + rr * RS + cc * 4, kg + off, ok);
      cp_async16(st + C::TILE / 4 + rr * RS + cc * 4, vg + off, ok);
    }
  };

  // 2. Start the first stages' copies, then stage the block's q rows (zeros past
  //    SR); the first tile's barrier publishes them.
  for (int i = 0; i < C::STAGES - 1; ++i) {
    if (i < n_live) load_tile(t0 + live[i], i);
    cp_async_commit();
  }
  if (n_live > 0) {
    const float4* qg = reinterpret_cast<const float4*>(q + ((size_t)bkv * sr + row0) * D);
    for (int idx = tid; idx < QB * (D / 4); idx += THREADS) {
      const int rr = idx / (D / 4), cc = idx % (D / 4);
      *reinterpret_cast<float4*>(qs + rr * RS + cc * 4) =
          rr < rows ? __ldg(qg + (size_t)rr * (D / 4) + cc) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

  float o[16][NC];  // P.V accumulators: this warp's 16 q rows, columns lane * NC + n
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) o[i][n] = 0.0f;
  float m[RPL], l[RPL];  // running max and sum of q rows h + LH * i (whole rows: every lane of the group)
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
  }
  float* pw = ps + warp * 16 * PS;
  float* cwr = cs + warp * 16;
  const float* qw = qs + qt * 16 * RS;

  // 3. The live tiles through the ring, one barrier a tile.
  for (int it = 0; it < n_live; ++it) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile `it` visible to all; the stage read at it - 1 is free
    {
      const int nx = it + C::STAGES - 1;
      if (nx < n_live) load_tile(t0 + live[nx], nx % C::STAGES);
      cp_async_commit();
    }
    if (nr == 0) continue;
    const int li = live[it];
    const float* kt = ring + (it % C::STAGES) * (C::STAGE / 4) + cw0 * RS;
    const float* vt = kt + C::TILE / 4;
    const uint2 vm = vmask[li];
    const int lt = (t0 + li) * BN + cw0;  // cache row of this warp's first column

    // S = Q.K^T for q rows h + LH * i and cache rows c + LC * j, G rows at a
    // time: G * CPL independent FMA chains, and the groups past the warp's
    // real rows skipped (a test uniform across the warp).
    float sc[RPL][CPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j) sc[i][j] = 0.0f;
#pragma unroll
    for (int i0 = 0; i0 < RPL; i0 += G) {
      if (LH * i0 >= nr) break;
#pragma unroll 4
      for (int d4 = 0; d4 < D / 4; ++d4) {
        float4 kk[CPL];
#pragma unroll
        for (int j = 0; j < CPL; ++j) kk[j] = *reinterpret_cast<const float4*>(kt + (c + LC * j) * RS + 4 * d4);
#pragma unroll
        for (int i = i0; i < i0 + G; ++i) {
          const float4 qq = *reinterpret_cast<const float4*>(qw + (h + LH * i) * RS + 4 * d4);
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            float s = sc[i][j];
            s = fmaf(qq.x, kk[j].x, s);
            s = fmaf(qq.y, kk[j].y, s);
            s = fmaf(qq.z, kk[j].z, s);
            s = fmaf(qq.w, kk[j].w, s);
            sc[i][j] = s;
          }
        }
      }
    }
    // Scale, cap and mask; each row's max and sum over the warp's cache rows
    // (lanes of one group, xor offsets below LC); P and the correction to
    // shared memory for P.V.
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int ri = h + LH * i;
      const int qp = pos0 + (wrow + ri) / r;
      bool kp[CPL];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int cl = cw0 + c + LC * j;  // column within the tile
        const int col = lt + c + LC * j;
        const bool vb = (((cl & 1) ? vm.y : vm.x) >> (cl >> 1)) & 1u;
        kp[j] = ri < nr && vb && qp >= col && (window == 0 || qp - col < window);
        float x = sc[i][j] * scale;
        if constexpr (CAP) x = cap * tanhf(x / cap);
        sc[i][j] = kp[j] ? x : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = LC / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      m[i] = mn;
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const float p = kp[j] ? expf(sc[i][j] - mn) : 0.0f;
        s += p;
        pw[ri * PS + c + LC * j] = p;
      }
#pragma unroll
      for (int off = LC / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      l[i] = l[i] * corr + s;
      if (c == 0) cwr[ri] = corr;
    }
    __syncwarp();
    // O = O * corr + P.V over the warp's CW cache rows, four at a time, for
    // G q rows at a time (G * NC independent chains), the groups past the
    // warp's real rows skipped.
#pragma unroll
    for (int i0 = 0; i0 < 16; i0 += G) {
      if (i0 >= nr) break;
#pragma unroll
      for (int i = i0; i < i0 + G; ++i) {
        const float f = cwr[i];
#pragma unroll
        for (int n = 0; n < NC; ++n) o[i][n] *= f;
      }
#pragma unroll 2
      for (int j4 = 0; j4 < CW / 4; ++j4) {
        float vv[4][NC];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          V::get(*reinterpret_cast<const typename V::T*>(vt + (4 * j4 + u) * RS + lane * NC), vv[u]);
#pragma unroll
        for (int i = i0; i < i0 + G; ++i) {
          const float4 p = *reinterpret_cast<const float4*>(pw + i * PS + 4 * j4);
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            float a = o[i][n];
            a = fmaf(p.x, vv[0][n], a);
            a = fmaf(p.y, vv[1][n], a);
            a = fmaf(p.z, vv[2][n], a);
            a = fmaf(p.w, vv[3][n], a);
            o[i][n] = a;
          }
        }
      }
    }
    __syncwarp();  // P and the corrections are read before the next tile writes them
  }

  // 4. Each warp's (m, l, o) to shared memory (the ring is free now); then
  //    the warps that share a q tile merge.
  cp_async_wait<0>();
  __syncthreads();
  float* red_o = ring;                     // [WARPS][16][D]
  float* red_m = red_o + WARPS * 16 * D;   // [WARPS][16]
  float* red_l = red_m + WARPS * 16;
  if (nr > 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < nr) *reinterpret_cast<typename V::T*>(red_o + (warp * 16 + i) * D + lane * NC) = V::make(o[i]);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        red_m[warp * 16 + h + LH * i] = m[i];
        red_l[warp * 16 + h + LH * i] = l[i];
      }
    }
  }
  __syncthreads();
  // Per row: the merge's weights e^(m_w - m) in place of the warps' m (over
  // max(l, 1e-20) where this block writes the output), the row's m and l.
  float* row_m = red_l + WARPS * 16;  // [QB]
  float* row_l = row_m + 64;          // [QB]
  const bool split = n_split > 1;
  if (tid < rows) {
    const int w0 = tid >> 4, ri = tid & 15;  // q tile and row within it
    float mx = NEG_INF;
#pragma unroll
    for (int s = 0; s < WPQ; ++s) mx = fmaxf(mx, red_m[(s * NQW + w0) * 16 + ri]);
    float e[WPQ], ls = 0.0f;
#pragma unroll
    for (int s = 0; s < WPQ; ++s) {
      const int w = s * NQW + w0;
      e[s] = expf(red_m[w * 16 + ri] - mx);
      ls += red_l[w * 16 + ri] * e[s];
    }
    const float inv = split ? 1.0f : 1.0f / fmaxf(ls, 1e-20f);
#pragma unroll
    for (int s = 0; s < WPQ; ++s) red_m[(s * NQW + w0) * 16 + ri] = e[s] * inv;
    row_m[tid] = mx;
    row_l[tid] = ls;
  }
  __syncthreads();

  float* og = out + ((size_t)bkv * sr + row0) * D;
  // This split's partials: [QB][D] acc, then [QB] m and [QB] l.
  constexpr int PF = QB * (D + 2);  // floats per split
  float* pz = split ? part + ((size_t)bq * n_split + z) * PF : nullptr;
  for (int idx = tid; idx < rows * (D / 4); idx += THREADS) {
    const int rr = idx / (D / 4), cc = (idx % (D / 4)) * 4;
    const int w0 = rr >> 4, ri = rr & 15;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int s = 0; s < WPQ; ++s) {
      const int w = s * NQW + w0;
      const float e = red_m[w * 16 + ri];
      const float4 x = *reinterpret_cast<const float4*>(&red_o[(w * 16 + ri) * D + cc]);
      a.x += x.x * e;
      a.y += x.y * e;
      a.z += x.z * e;
      a.w += x.w * e;
    }
    if (!split) {
      *reinterpret_cast<float4*>(&og[(size_t)rr * D + cc]) = a;
    } else {
      *reinterpret_cast<float4*>(&pz[rr * D + cc]) = a;
      if (cc == 0) {
        pz[QB * D + rr] = row_m[rr];
        pz[QB * D + QB + rr] = row_l[rr];
      }
    }
  }
  if (!split) return;

  // 5. The last split of this (b*kv, q block) to finish combines them all:
  //    per row the weights e^(m_s - m*) / max(l*, 1e-20) into shared
  //    memory, then one pass of float4 loads over the splits' acc.
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&tickets[bq], 1) == n_split - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* pb = part + (size_t)bq * n_split * PF;
  float* cw = ring;                // [n_split][QB] m, then weights
  float* cl = cw + n_split * QB;   // [n_split][QB] l
  for (int idx = tid; idx < n_split * rows; idx += THREADS) {
    const int s = idx / rows, rr = idx % rows;
    cw[s * QB + rr] = __ldcg(pb + s * PF + QB * D + rr);
    cl[s * QB + rr] = __ldcg(pb + s * PF + QB * D + QB + rr);
  }
  __syncthreads();
  for (int rr = tid; rr < rows; rr += THREADS) {
    float mx = NEG_INF;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, cw[s * QB + rr]);
    float ls = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float e = expf(cw[s * QB + rr] - mx);
      cw[s * QB + rr] = e;
      ls += cl[s * QB + rr] * e;
    }
    const float inv = 1.0f / fmaxf(ls, 1e-20f);
    for (int s = 0; s < n_split; ++s) cw[s * QB + rr] *= inv;
  }
  __syncthreads();
  for (int idx = tid; idx < rows * (D / 4); idx += THREADS) {
    const int rr = idx / (D / 4), cc = (idx % (D / 4)) * 4;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float e = cw[s * QB + rr];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(pb + s * PF + rr * D + cc));
      a.x += x.x * e;
      a.y += x.y * e;
      a.z += x.z * e;
      a.w += x.w * e;
    }
    *reinterpret_cast<float4*>(&og[(size_t)rr * D + cc]) = a;
  }
  if (tid == 0) tickets[bq] = 0;  // ready for the next launch
}

struct Args {
  const void *q, *k, *v, *valid;
  void *out, *part, *tickets;
  const void* pos0_vec;
  int bkv, kv, sr, r, L, pos0, window;
  float scale, cap;
  int n_split, tps;
};

template <int D, int NQW, bool CAP>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int bytes = Cfg<D, NQW>::SMEM;
  static bool attr_set = false;  // setting it twice is harmless
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_gqa_f32_kernel<D, NQW, CAP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(a.bkv, (a.sr + 16 * NQW - 1) / (16 * NQW), a.n_split);
  flash_gqa_f32_kernel<D, NQW, CAP><<<grid, THREADS, bytes, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
      static_cast<const uint8_t*>(a.valid), static_cast<float*>(a.out), static_cast<float*>(a.part),
      static_cast<int*>(a.tickets), static_cast<const int*>(a.pos0_vec), a.kv, a.sr, a.r, a.L, a.pos0,
      a.window, a.scale, a.cap, a.tps);
  return cudaGetLastError();
}

template <int D, int NQW>
cudaError_t launch_cap(const Args& a, cudaStream_t s) {
  return a.cap > 0.0f ? launch<D, NQW, true>(a, s) : launch<D, NQW, false>(a, s);
}

template <int D, int NQW>
int occupancy() {
  constexpr int bytes = Cfg<D, NQW>::SMEM;
  int n = 0;
  if (cudaFuncSetAttribute(flash_gqa_f32_kernel<D, NQW, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_gqa_f32_kernel<D, NQW, false>, THREADS, bytes) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// The interface of flash_gqa_cache.cu's libraries, for an f32 model: q
// [bkv, sr, d] f32 (the R heads of each kv head folded into the rows), k, v
// [bkv, L, d] f32 (k_scale and v_scale must be null: an int8 cache is not
// this body's), valid [bkv / kv, L] bytes 0/1 or null (all valid), out
// [bkv, sr, d] f32. pos0_vec, when not null, is an int32 [bkv / kv] on the
// device whose entry b takes the place of pos0 for batch row b. d is the
// library's own head_dim (KKV_HEAD_DIM: 64 or 128); every pointer 16-byte
// aligned. softcap > 0 caps the scaled scores at softcap * tanh(s / softcap)
// before the mask. The cache's 64-row tiles split into n_split ranges of
// ceil(tiles / n_split) tiles, none empty, none over 256 tiles, and at most
// 64 splits. With n_split > 1, part holds part_floats floats and tickets
// n_tickets ints that are zero, and are zero again when the kernel ends; the
// launch needs kkv_flash_gqa_cache_part_floats(...) floats and
// bkv * ceil(sr / qb) tickets (qb = 16 when sr <= 16, else 64) and refuses
// less. Launches on `stream`, does not synchronise; returns the CUDA error
// code (0 on success).
extern "C" long long kkv_flash_gqa_cache_part_floats(int bkv, int sr, int d, int n_split) {
  const int qb = sr <= 16 ? 16 : 64;
  return n_split > 1 ? (long long)bkv * ((sr + qb - 1) / qb) * n_split * qb * (d + 2) : 0;
}

// Resident blocks per SM at head_dim d for a block of sr <= 16 rows or more:
// with planned != 0 the count the launch bounds and the split count plan
// for, else what the card's occupancy calculator grants. -1 for a d this
// library does not take, or an int8 cache.
extern "C" int kkv_flash_gqa_cache_blocks_per_sm(int d, int kv8, int sr, int planned) {
  if (d != KKV_HEAD_DIM || kv8 != 0) return -1;
  if (planned) return sr > 16 ? Cfg<KKV_HEAD_DIM, 4>::BLOCKS : Cfg<KKV_HEAD_DIM, 1>::BLOCKS;
  return sr > 16 ? occupancy<KKV_HEAD_DIM, 4>() : occupancy<KKV_HEAD_DIM, 1>();
}

extern "C" int kkv_flash_gqa_cache(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale, const void* valid,
                                   void* out, void* part, long long part_floats, void* tickets,
                                   int n_tickets, int bkv, int kv, int sr, int r, int L, int d,
                                   int pos0, const void* pos0_vec, int window, float scale,
                                   float softcap, int n_split, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bkv < 1 || kv < 1 || bkv % kv || sr < 1 || r < 1 || L < 1 || window < 0 || k_scale != nullptr ||
      v_scale != nullptr || n_split < 1 || !(softcap >= 0.0f) || d != KKV_HEAD_DIM)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (L + BN - 1) / BN;
  const int tps = (n_tiles + n_split - 1) / n_split;
  const int qb = sr <= 16 ? 16 : 64;
  if (tps > MAX_TPS || n_split > MAX_SPLITS || (n_split - 1) * tps >= n_tiles ||
      (n_split > 1 && (part == nullptr || tickets == nullptr ||
                       part_floats < kkv_flash_gqa_cache_part_floats(bkv, sr, d, n_split) ||
                       (long long)n_tickets < (long long)bkv * ((sr + qb - 1) / qb))))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, valid, out, part, tickets, pos0_vec, bkv, kv, sr, r, L, pos0,
               window, scale, softcap, n_split, tps};
  return sr <= 16 ? (int)launch_cap<KKV_HEAD_DIM, 1>(a, s) : (int)launch_cap<KKV_HEAD_DIM, 4>(a, s);
}
