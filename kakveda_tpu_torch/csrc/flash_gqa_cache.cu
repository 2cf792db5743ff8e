// Blockwise online-softmax GQA attention over a head-major KV cache, for
// Hopper (sm_90a). One template, two bodies: a bf16 cache and an int8 cache
// with f32 per-row scales. Built as one library per head_dim (ops/_build.py
// passes -DKKV_HEAD_DIM=<head_dim>, and the five compile in parallel).
//
// Replaces the Pallas TPU kernel kakveda_tpu/models/attention.py::
// flash_gqa_cache (pl.pallas_call at attention.py:284), bodies _flash_kernel
// (bf16 cache) and _flash_kernel_kv8 (int8 cache), both through _flash_body.
// It computes what _flash_body computes:
//   * the R = H / KV query heads of one kv head fold into the q rows: folded
//     row i of (b, g) is sequence position pos0 + i / R, where pos0 is one
//     host int for the whole batch or, given the device vector pos0_vec
//     [B], pos0_vec[b] per batch row (the serving engine's speculative
//     verify chunk: token i of slot b sits at slot_pos[b] + i; the JAX
//     package builds that [B, S, L] mask in kakveda_tpu/models/serving.py::
//     _forward_wide and takes _gqa_xla, and the vector replaces it here:
//     no mask bytes, exact tile skipping, and positions that never visit
//     the host);
//   * S = Q.K^T * D^-0.5 with bf16 operands and f32 accumulation; with an
//     attention softcap (Gemma-2) S becomes cap * tanh(S / cap) in f32
//     before the mask, the order of _gqa_xla (the softcap instantiations
//     replace the JAX package's XLA path for those shapes; the others keep
//     the code they had);
//   * keep(i, l) = l < L && q_pos >= l && kv_valid[b, l]
//                  && (window == 0 || q_pos - l < window);
//     masked scores are -1e30 (never -inf: an all-masked tile would give
//     NaN), and p is masked again after the exp;
//   * online softmax in f32 over 64-row cache tiles (m, l, acc), P cast to
//     bf16 before P.V (p.astype(v.dtype)), f32 accumulation;
//   * out = acc / max(l, 1e-20): a row that sees no slot emits zeros.
// int8 body: each K/V element dequantizes as bf16(int8) * bf16(scale), one
// bf16 product rounded once: the order of _kv_dequant (llama.py:728-731),
// bit for bit.
//
// Bound: bytes. The cache is read once, B*KV*2*L*D*2 bytes for bf16 and
// B*KV*2*L*(D+4) for int8 (values and scales), against 4*B*KV*S*R*L*D flops:
// at decode (S*R = 4) ~1 flop a byte, ~300x under the point where the
// tensor cores would bind. So the design aims at parallelism and bytes in
// flight, and keeps mma.sync m16n8k16:
//   * split L across blocks (flash-decoding): grid (B*KV, q blocks, n_split).
//     Each split runs the online softmax over its own tiles; with n_split > 1
//     it leaves (m, l, acc) in f32 in a workspace, and the last split of a
//     (b*kv, q block) to finish (an atomic ticket, which it resets to 0)
//     combines: m* = max m_i, l* = sum l_i e^(m_i - m*),
//     out = sum acc_i e^(m_i - m*) / max(l*, 1e-20). A split that sees
//     nothing has (-1e30, 0, 0) and weighs nothing. The host picks n_split
//     from the shapes and the SM count: as many splits as one wave of two
//     resident blocks per SM holds, counting only the tiles before pos0 + S
//     or the caller's reach hint (an admission at pos0 = 0, or an engine
//     decode whose slots are at row 95, reaches two tiles at most and
//     takes one split);
//   * every warp on the math: when S*R <= 16 (every decode) the folded rows
//     are one m16 tile and each of the 4 warps takes 16 cache rows of every
//     tile with its own (m, l, o); when S*R > 16 each warp owns 16 q rows
//     and all 64 cache rows. Warps merge through shared memory at the end;
//   * fragments come from shared memory by ldmatrix (K) and ldmatrix.trans
//     (V), 16 bytes a lane, in place of scalar 16- and 32-bit loads;
//   * tiles that no query row of the block can see (causal and window
//     bounds of the block's rows, kv_valid) are found before any copy, by a
//     warp vote over each tile's validity bytes, and never loaded. Exact: a
//     fully masked tile leaves m, l and acc unchanged;
//   * a 3-stage (bf16) or 4-stage (int8) cp.async ring of K/V tiles, two
//     blocks per SM; the int8 scales go through the same ring. At D = 256 a
//     bf16 3-stage ring is 3 x 2 x 64 x 528 = 202,752 bytes: one block per
//     SM, and a 2-stage ring when S*R > 16;
//   * at D = 256 the q rows' fragments do not stay in registers (64 more a
//     lane beside the 128 of the P.V accumulators): the block stages its q
//     rows in shared memory once and each tile reads them back with
//     ldmatrix (the int8 body's k permutation applied when staging);
//   * int8 in registers: ldmatrix reads the int8 tiles as byte pairs and
//     each fragment dequantizes as it is loaded (exact int8 -> f32 by a byte
//     permute and one subtraction, times the bf16-rounded scale, rounded to
//     bf16 once). The int8 body keeps no bf16 copy of a tile.
// ldmatrix moves 16-bit elements, so for int8 it hands each lane 4 bytes of
// one row (K) or 2 bytes of two rows (V). The dot product's k axis and the
// output's column axis are permuted to match (Q's fragments are loaded
// under the same permutation, the output is written back in place); a sum
// does not depend on the order of its terms' indices. At D = 96 a K row is
// one x4 load (64 bytes) and one x2 load (32 bytes).
//
// At D = 32 a K row is 64 bytes (bf16: one x4 ldmatrix, two k16 steps) or 32
// bytes (int8: one x2 load, as D = 96's tail), P.V four n8 tiles; the
// split combine's weights then set the shared memory, not the ring.
//
// D is 32, 64, 96, 128 or 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef KKV_HEAD_DIM
#error "build one library per head_dim: nvcc -DKKV_HEAD_DIM=32, 64, 96, 128 or 256 (ops/_build.py does)"
#endif

namespace {

constexpr int BN = 64;        // cache rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_TPS = 256;  // tiles per split (the live-tile list in shared memory)
constexpr int MAX_SPLITS = 64;  // splits of one (b*kv, q block): the combine's weights in shared memory
constexpr float NEG_INF = -1e30f;

template <int D, bool KV8, int NQW>
struct Cfg {
  static_assert(D == 32 || D == 64 || D == 96 || D == 128 || D == 256, "head_dim 32, 64, 96, 128 or 256");
  // Q fragments from shared memory (D = 256: registers), in rows of QRS bytes.
  static constexpr bool QS = D >= 256;
  static constexpr int QRS = (D + 8) * 2;
  static constexpr int QSM = QS ? 16 * NQW * QRS : 0;
  static constexpr int STAGES = KV8 ? 4 : (D >= 256 && NQW > 1 ? 2 : 3);
  // Bytes per cache row in shared memory, padded so that the 8 rows of an
  // ldmatrix phase fall on distinct banks.
  static constexpr int RS = KV8 ? D + 16 : (D + 8) * 2;
  static constexpr int TILE = BN * RS;                   // K or V of one stage
  static constexpr int STAGE = 2 * TILE + (KV8 ? 2 * BN * 4 : 0);  // + K and V scales
  static constexpr int RING = STAGES * STAGE;
  static constexpr int RED = (WARPS * 16 * (D + 2) + 2 * 64) * 4;  // per-warp o, m, l; per-row m, l
  static constexpr int COMB = MAX_SPLITS * 64 * 2 * 4;  // the split combine's m and l
  static constexpr int MAIN = RING > RED ? (RING > COMB ? RING : COMB) : (RED > COMB ? RED : COMB);
  static constexpr int SMEM = MAIN + QSM + MAX_TPS * 8 + MAX_TPS * 2 + 16;
  static_assert(SMEM <= 227 * 1024, "one block's shared memory");
  // Resident blocks per SM the launch bounds and the split count plan for
  // (the wrapper reads it through kkv_flash_gqa_cache_blocks_per_sm): two
  // where their shared memory fits the SM's 228 KB (1 KB of it reserved
  // per block), else one.
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
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}
// Byte i of an int8 quad as an exact float: u is the quad XOR 0x80808080
// (each byte + 128); the byte goes into the mantissa of 2^23 and the bias
// comes off in one exact subtraction.
__device__ __forceinline__ float i8f(uint32_t u, int i) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)) - 8388736.0f;
}
// bf16(int8) * bf16(scale) rounded once: the product of two bf16 values is
// exact in f32, so one rounding gives the bf16 product.
__device__ __forceinline__ uint32_t dq2(uint32_t u, int i, float si, int j, float sj) {
  return pack2f(i8f(u, i) * si, i8f(u, j) * sj);
}
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// grid (B * KV, ceil(SR / (16 * NQW)), n_split), block THREADS, dynamic
// shared memory Cfg<D, KV8, NQW>::SMEM. NQW is the number of 16-row q tiles
// of a block: 1 when S*R <= 16, else 4. CAP: scores are softcapped at `cap`.
template <int D, bool KV8, int NQW, bool CAP>
__global__ void __launch_bounds__(THREADS, Cfg<D, KV8, NQW>::BLOCKS)
flash_gqa_kernel(const __nv_bfloat16* __restrict__ q,  // [B*KV, SR, D]
                 const void* __restrict__ k_,           // [B*KV, L, D] bf16 or int8
                 const void* __restrict__ v_,
                 const float* __restrict__ k_scale,     // [B*KV, L] (int8 only)
                 const float* __restrict__ v_scale,
                 const uint8_t* __restrict__ valid,     // [B, L] or null
                 __nv_bfloat16* __restrict__ out,       // [B*KV, SR, D]
                 float* __restrict__ part,              // split partials (n_split > 1)
                 int* __restrict__ tickets,             // [B*KV * q blocks], zero between launches
                 const int* __restrict__ pos0_vec,      // [B] or null (then pos0)
                 int kv, int sr, int r, int L, int pos0_, int window, float scale, float cap,
                 int tps) {
  using C = Cfg<D, KV8, NQW>;
  constexpr int QB = 16 * NQW;      // folded q rows of a block
  constexpr int WPQ = WARPS / NQW;  // warps sharing one 16-row q tile
  constexpr int CW = BN / WPQ;      // cache rows of each tile that one warp takes
  constexpr int EB = KV8 ? 1 : 2;   // bytes per cache element
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* qsm = smem + C::MAIN;  // [QB][QRS] q rows (C::QS only)
  uint2* vmask = reinterpret_cast<uint2*>(smem + C::MAIN + C::QSM);  // per tile: valid bits, even / odd rows
  short* live = reinterpret_cast<short*>(smem + C::MAIN + C::QSM + MAX_TPS * 8);
  int* flag = reinterpret_cast<int*>(smem + C::MAIN + C::QSM + MAX_TPS * 10);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the fragment
  const int t = lane & 3;   // column pair within the fragment
  const int bkv = blockIdx.x;
  const int bq = bkv * gridDim.y + blockIdx.y;
  const int z = blockIdx.z;
  const int n_split = gridDim.z;
  const int row0 = blockIdx.y * QB;
  const int rows = min(QB, sr - row0);  // real rows of this block
  const int qt = warp % NQW;            // this warp's q tile
  const int cw0 = (warp / NQW) * CW;    // its first cache row within a tile
  const int wrow = row0 + qt * 16;
  const bool active = wrow < sr;
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
    constexpr int CH = D * EB / 16;  // 16-byte chunks per cache row
    const int l0 = tile * BN;
    unsigned char* st = ring + stage * C::STAGE;
    const unsigned char* kg = static_cast<const unsigned char*>(k_) + kv_base * D * EB;
    const unsigned char* vg = static_cast<const unsigned char*>(v_) + kv_base * D * EB;
    for (int idx = tid; idx < BN * CH; idx += THREADS) {
      const int rr = idx / CH, c = idx % CH;
      const bool ok = l0 + rr < L;
      const size_t off = ok ? (size_t)(l0 + rr) * D * EB + c * 16 : 0;
      cp_async16(st + rr * C::RS + c * 16, kg + off, ok);
      cp_async16(st + C::TILE + rr * C::RS + c * 16, vg + off, ok);
    }
    if constexpr (KV8) {
      float* ss = reinterpret_cast<float*>(st + 2 * C::TILE);
      if (tid < BN) {
        const bool ok = l0 + tid < L;
        const size_t off = kv_base + (ok ? l0 + tid : 0);
        cp_async4(ss + tid, k_scale + off, ok);
        cp_async4(ss + BN + tid, v_scale + off, ok);
      }
    }
  };

  // 2. Issue the first stages, then this warp's q rows as mma A fragments,
  //    straight from global memory (rows past SR are zeros). The int8 body
  //    reads the k axis under the permutation its K fragments arrive in.
  //    With C::QS the block's q rows go to shared memory instead, each
  //    16-column chunk's 32-bit words in the order ldmatrix hands the
  //    fragments out (for int8, logical word w < 4 is physical word 2w, and
  //    w >= 4 is 2(w - 4) + 1); the first tile's barrier publishes them.
  for (int i = 0; i < C::STAGES - 1; ++i) {
    if (i < n_live) load_tile(t0 + live[i], i);
    cp_async_commit();
  }
  uint32_t qa[C::QS ? 1 : D / 16][4];
  if constexpr (C::QS) {
    if (n_live > 0) {
      const uint32_t* qg = reinterpret_cast<const uint32_t*>(q + ((size_t)bkv * sr + row0) * D);
      for (int idx = tid; idx < QB * (D / 2); idx += THREADS) {
        const int rr = idx / (D / 2), w = idx % (D / 2);
        const int wl = w & 7;
        const int src = KV8 ? (w & ~7) + (wl < 4 ? 2 * wl : 2 * (wl - 4) + 1) : w;
        *reinterpret_cast<uint32_t*>(qsm + rr * C::QRS + w * 4) =
            rr < rows ? __ldg(qg + (size_t)rr * (D / 2) + src) : 0u;
      }
    }
  } else if (n_live > 0) {
    const __nv_bfloat16* qg = q + (size_t)bkv * sr * D;
    const int ra = wrow + g, rb = wrow + g + 8;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int c = 16 * kc + (KV8 ? 4 * t : 2 * t);
      const int c2 = c + (KV8 ? 2 : 8);
      qa[kc][0] = ra < sr ? ldg32(qg + (size_t)ra * D + c) : 0u;
      qa[kc][1] = rb < sr ? ldg32(qg + (size_t)rb * D + c) : 0u;
      qa[kc][2] = ra < sr ? ldg32(qg + (size_t)ra * D + c2) : 0u;
      qa[kc][3] = rb < sr ? ldg32(qg + (size_t)rb * D + c2) : 0u;
    }
  }

  float o[D / 8][4];  // P.V accumulators: rows g and g + 8
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows g and g + 8
  float l0s = 0.0f, l1s = 0.0f;      // this lane's share of the running sums
  const int qp0 = pos0 + (wrow + g) / r;
  const int qp1 = pos0 + (wrow + g + 8) / r;
  const int lrow = lane & 7;   // ldmatrix: the row whose address this lane gives
  const int lmat = lane >> 3;  // ... of matrix lmat

  // 3. The live tiles through the ring, one barrier a tile.
  for (int it = 0; it < n_live; ++it) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile `it` visible to all; the stage read at it - 1 is free
    {
      const int nx = it + C::STAGES - 1;
      if (nx < n_live) load_tile(t0 + live[nx], nx % C::STAGES);
      cp_async_commit();
    }
    if (!active) continue;
    const int li = live[it];
    const unsigned char* st = ring + (it % C::STAGES) * C::STAGE;
    const uint32_t ks_addr = smem_u32(st) + cw0 * C::RS;
    const uint32_t vs_addr = ks_addr + C::TILE;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * C::TILE) + cw0;
    const float* vsc = ksc + BN;
    const uint2 vm = vmask[li];
    const int lt = (t0 + li) * BN + cw0;  // cache row of this warp's first column

    // S = Q.K^T for this warp's 16 q rows and CW cache rows.
    float sc[CW / 8][4];
#pragma unroll
    for (int nc = 0; nc < CW / 8; ++nc) sc[nc][0] = sc[nc][1] = sc[nc][2] = sc[nc][3] = 0.0f;
    if constexpr (C::QS) {
      // k slices outer, so each A fragment is read from shared memory once a
      // tile: lane l gives row l % 16, 16-byte half l / 16 of a 32-byte chunk.
      const uint32_t qs_addr = smem_u32(qsm) + (qt * 16 + (lane & 15)) * C::QRS + (lane >> 4) * 16;
      if constexpr (!KV8) {
#pragma unroll
        for (int kp = 0; kp < D / 32; ++kp) {
          uint32_t a0[4], a1[4];
          ldsm_x4(a0, qs_addr + (2 * kp) * 32);
          ldsm_x4(a1, qs_addr + (2 * kp + 1) * 32);
#pragma unroll
          for (int nc = 0; nc < CW / 8; ++nc) {
            uint32_t b[4];
            ldsm_x4(b, ks_addr + (nc * 8 + lrow) * C::RS + (4 * kp + lmat) * 16);
            mma_bf16(sc[nc], a0, b[0], b[1]);
            mma_bf16(sc[nc], a1, b[2], b[3]);
          }
        }
      } else {
#pragma unroll
        for (int kq = 0; kq < D / 64; ++kq) {
          uint32_t a[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ldsm_x4(a[i], qs_addr + (4 * kq + i) * 32);
#pragma unroll
          for (int nc = 0; nc < CW / 8; ++nc) {
            const float s = bf16r(ksc[nc * 8 + g]);
            uint32_t b[4];
            ldsm_x4(b, ks_addr + (nc * 8 + lrow) * C::RS + (4 * kq + lmat) * 16);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint32_t u = b[i] ^ 0x80808080u;
              mma_bf16(sc[nc], a[i], dq2(u, 0, s, 1, s), dq2(u, 2, s, 3, s));
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int nc = 0; nc < CW / 8; ++nc) {
        const uint32_t ra = ks_addr + (nc * 8 + lrow) * C::RS;
        if constexpr (!KV8) {
#pragma unroll
          for (int kp = 0; kp < D / 32; ++kp) {
            uint32_t b[4];
            ldsm_x4(b, ra + (4 * kp + lmat) * 16);
            mma_bf16(sc[nc], qa[2 * kp], b[0], b[1]);
            mma_bf16(sc[nc], qa[2 * kp + 1], b[2], b[3]);
          }
        } else {
          const float s = bf16r(ksc[nc * 8 + g]);
#pragma unroll
          for (int kq = 0; kq < D / 64; ++kq) {
            uint32_t b[4];
            ldsm_x4(b, ra + (4 * kq + lmat) * 16);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint32_t u = b[i] ^ 0x80808080u;
              mma_bf16(sc[nc], qa[4 * kq + i], dq2(u, 0, s, 1, s), dq2(u, 2, s, 3, s));
            }
          }
          if constexpr (D % 64 != 0) {  // D = 96: the last 32 bytes of the row
            constexpr int kq = D / 64;
            uint32_t b[2];
            ldsm_x2(b, ra + (4 * kq + (lmat & 1)) * 16);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint32_t u = b[i] ^ 0x80808080u;
              mma_bf16(sc[nc], qa[4 * kq + i], dq2(u, 0, s, 1, s), dq2(u, 2, s, 3, s));
            }
          }
        }
      }
    }
    // Scale and mask; keep bit 4 * nc + e for element e of chunk nc.
    uint32_t keep = 0;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nc = 0; nc < CW / 8; ++nc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = cw0 + nc * 8 + 2 * t + (e & 1);  // column within the tile
        const int col = lt + nc * 8 + 2 * t + (e & 1);
        const int qp = e < 2 ? qp0 : qp1;
        const bool vb = (((e & 1) ? vm.y : vm.x) >> (cl >> 1)) & 1u;
        const bool kp = vb && qp >= col && (window == 0 || qp - col < window);
        float x = sc[nc][e] * scale;
        if constexpr (CAP) x = cap * tanhf(x / cap);
        sc[nc][e] = kp ? x : NEG_INF;
        keep |= (uint32_t)kp << (4 * nc + e);
      }
      mx0 = fmaxf(mx0, fmaxf(sc[nc][0], sc[nc][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nc][2], sc[nc][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nc = 0; nc < CW / 8; ++nc) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[nc][e] = (keep >> (4 * nc + e)) & 1u ? expf(sc[nc][e] - (e < 2 ? mn0 : mn1)) : 0.0f;
      ps0 += sc[nc][0] + sc[nc][1];
      ps1 += sc[nc][2] + sc[nc][3];
    }
    l0s = l0s * corr0 + ps0;
    l1s = l1s * corr1 + ps1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][0] *= corr0;
      o[nd][1] *= corr0;
      o[nd][2] *= corr1;
      o[nd][3] *= corr1;
    }
    // O += bf16(P).V: the S accumulators of chunks 2j, 2j+1 are the A
    // fragment of k-slice j.
#pragma unroll
    for (int j = 0; j < CW / 16; ++j) {
      const uint32_t pa[4] = {pack2f(sc[2 * j][0], sc[2 * j][1]), pack2f(sc[2 * j][2], sc[2 * j][3]),
                              pack2f(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                              pack2f(sc[2 * j + 1][2], sc[2 * j + 1][3])};
      // Matrices of an x4: rows 0-7 / 8-15 of the slice, two 16-byte column segments.
      const uint32_t va = vs_addr + (16 * j + (lmat & 1) * 8 + lrow) * C::RS + (lmat >> 1) * 16;
      if constexpr (!KV8) {
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          ldsm_x4_t(b, va + np * 32);
          mma_bf16(o[2 * np], pa, b[0], b[1]);
          mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
        }
      } else {
        // Lane (g, t) holds bytes (row 2t, cols 2g, 2g+1; row 2t+1, same
        // cols) of a segment: output chunk 2 * seg takes the even column,
        // 2 * seg + 1 the odd one.
        const float sa0 = bf16r(vsc[16 * j + 2 * t]), sb0 = bf16r(vsc[16 * j + 2 * t + 1]);
        const float sa1 = bf16r(vsc[16 * j + 2 * t + 8]), sb1 = bf16r(vsc[16 * j + 2 * t + 9]);
#pragma unroll
        for (int cq = 0; cq < D / 32; ++cq) {
          uint32_t b[4];
          ldsm_x4_t(b, va + cq * 32);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int seg = 2 * cq + h;
            const uint32_t lo = b[2 * h] ^ 0x80808080u, hi = b[2 * h + 1] ^ 0x80808080u;
            mma_bf16(o[2 * seg], pa, dq2(lo, 0, sa0, 2, sb0), dq2(hi, 0, sa1, 2, sb1));
            mma_bf16(o[2 * seg + 1], pa, dq2(lo, 1, sa0, 3, sb0), dq2(hi, 1, sa1, 3, sb1));
          }
        }
      }
    }
  }

  // 4. Each warp's (m, l, o) to shared memory (the ring is free now), in the
  //    output's own column order; then the warps that share a q tile merge.
  cp_async_wait<0>();
  __syncthreads();
  float* red_o = reinterpret_cast<float*>(ring);  // [WARPS][16][D]
  float* red_m = red_o + WARPS * 16 * D;          // [WARPS][16]
  float* red_l = red_m + WARPS * 16;
  l0s += __shfl_xor_sync(0xffffffffu, l0s, 1);
  l0s += __shfl_xor_sync(0xffffffffu, l0s, 2);
  l1s += __shfl_xor_sync(0xffffffffu, l1s, 1);
  l1s += __shfl_xor_sync(0xffffffffu, l1s, 2);
  if (active) {
    float* wo = red_o + warp * 16 * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 2 * t + (e & 1);  // column within chunk nd
        const int col = KV8 ? 16 * (nd >> 1) + 2 * n + (nd & 1) : 8 * nd + n;
        wo[(g + (e >> 1) * 8) * D + col] = o[nd][e];
      }
    }
    if (t == 0) {
      red_m[warp * 16 + g] = m0;
      red_m[warp * 16 + g + 8] = m1;
      red_l[warp * 16 + g] = l0s;
      red_l[warp * 16 + g + 8] = l1s;
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

  __nv_bfloat16* og = out + ((size_t)bkv * sr + row0) * D;
  // This split's partials: [QB][D] acc, then [QB] m and [QB] l.
  constexpr int PS = QB * (D + 2);  // floats per split
  float* pz = split ? part + ((size_t)bq * n_split + z) * PS : nullptr;
  for (int idx = tid; idx < rows * (D / 4); idx += THREADS) {
    const int rr = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const int w0 = rr >> 4, ri = rr & 15;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int s = 0; s < WPQ; ++s) {
      const int w = s * NQW + w0;
      const float e = red_m[w * 16 + ri];
      const float4 x = *reinterpret_cast<const float4*>(&red_o[(w * 16 + ri) * D + c]);
      a.x += x.x * e;
      a.y += x.y * e;
      a.z += x.z * e;
      a.w += x.w * e;
    }
    if (!split) {
      *reinterpret_cast<uint2*>(&og[(size_t)rr * D + c]) = make_uint2(pack2f(a.x, a.y), pack2f(a.z, a.w));
    } else {
      *reinterpret_cast<float4*>(&pz[rr * D + c]) = a;
      if (c == 0) {
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
  const float* pb = part + (size_t)bq * n_split * PS;
  float* cw = reinterpret_cast<float*>(ring);  // [n_split][QB] m, then weights
  float* cl = cw + n_split * QB;               // [n_split][QB] l
  for (int idx = tid; idx < n_split * rows; idx += THREADS) {
    const int s = idx / rows, rr = idx % rows;
    cw[s * QB + rr] = __ldcg(pb + s * PS + QB * D + rr);
    cl[s * QB + rr] = __ldcg(pb + s * PS + QB * D + QB + rr);
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
    const int rr = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float e = cw[s * QB + rr];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(pb + s * PS + rr * D + c));
      a.x += x.x * e;
      a.y += x.y * e;
      a.z += x.z * e;
      a.w += x.w * e;
    }
    *reinterpret_cast<uint2*>(&og[(size_t)rr * D + c]) = make_uint2(pack2f(a.x, a.y), pack2f(a.z, a.w));
  }
  if (tid == 0) tickets[bq] = 0;  // ready for the next launch
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *valid;
  void *out, *part, *tickets;
  const void* pos0_vec;
  int bkv, kv, sr, r, L, pos0, window;
  float scale, cap;
  int n_split, tps;
};

template <int D, bool KV8, int NQW, bool CAP>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr int bytes = Cfg<D, KV8, NQW>::SMEM;
  static bool attr_set = false;  // setting it twice is harmless
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_gqa_kernel<D, KV8, NQW, CAP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(a.bkv, (a.sr + 16 * NQW - 1) / (16 * NQW), a.n_split);
  flash_gqa_kernel<D, KV8, NQW, CAP><<<grid, THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k, a.v, static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const uint8_t*>(a.valid),
      static_cast<__nv_bfloat16*>(a.out), static_cast<float*>(a.part), static_cast<int*>(a.tickets),
      static_cast<const int*>(a.pos0_vec), a.kv, a.sr, a.r, a.L, a.pos0, a.window, a.scale, a.cap, a.tps);
  return cudaGetLastError();
}

template <int D, bool KV8, int NQW>
cudaError_t launch_cap(const Args& a, cudaStream_t s) {
  return a.cap > 0.0f ? launch<D, KV8, NQW, true>(a, s) : launch<D, KV8, NQW, false>(a, s);
}

template <int D>
cudaError_t launch_d(const Args& a, cudaStream_t s) {
  const bool kv8 = a.ks != nullptr;
  if (a.sr <= 16) return kv8 ? launch_cap<D, true, 1>(a, s) : launch_cap<D, false, 1>(a, s);
  return kv8 ? launch_cap<D, true, 4>(a, s) : launch_cap<D, false, 4>(a, s);
}

template <int D, bool KV8, int NQW>
int occupancy() {
  constexpr int bytes = Cfg<D, KV8, NQW>::SMEM;
  int n = 0;
  if (cudaFuncSetAttribute(flash_gqa_kernel<D, KV8, NQW, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_gqa_kernel<D, KV8, NQW, false>, THREADS,
                                                    bytes) != cudaSuccess)
    return -1;
  return n;
}

template <int D>
int blocks_d(bool kv8, bool wide, bool planned) {
  if (planned)
    return kv8 ? (wide ? Cfg<D, true, 4>::BLOCKS : Cfg<D, true, 1>::BLOCKS)
               : (wide ? Cfg<D, false, 4>::BLOCKS : Cfg<D, false, 1>::BLOCKS);
  return kv8 ? (wide ? occupancy<D, true, 4>() : occupancy<D, true, 1>())
             : (wide ? occupancy<D, false, 4>() : occupancy<D, false, 1>());
}

}  // namespace

// q [bkv, sr, d] bf16 (the R heads of each kv head folded into the rows),
// k, v [bkv, L, d] bf16, or int8 with k_scale, v_scale [bkv, L] f32 (null
// for bf16), valid [bkv / kv, L] bytes 0/1 or null (all valid), out
// [bkv, sr, d] bf16. pos0_vec, when not null, is an int32 [bkv / kv] on the
// device whose entry b takes the place of pos0 for batch row b. d is the
// library's own head_dim (KKV_HEAD_DIM: 32, 64, 96, 128 or 256); every
// pointer 16-byte aligned. softcap > 0 caps the scaled scores at softcap * tanh(s /
// softcap) before the mask; 0 leaves them. The cache's 64-row tiles split
// into n_split ranges of ceil(tiles / n_split) tiles, none empty, none over
// 256 tiles, and at most 64 splits. With n_split > 1, part holds part_floats
// floats and tickets n_tickets ints that are zero, and are zero again when
// the kernel ends; the launch needs kkv_flash_gqa_cache_part_floats(...)
// floats and bkv * ceil(sr / qb) tickets (qb = 16 when sr <= 16, else 64)
// and refuses less. Launches on `stream`, does not synchronise; returns the
// CUDA error code (0 on success).
extern "C" long long kkv_flash_gqa_cache_part_floats(int bkv, int sr, int d, int n_split) {
  const int qb = sr <= 16 ? 16 : 64;
  return n_split > 1 ? (long long)bkv * ((sr + qb - 1) / qb) * n_split * qb * (d + 2) : 0;
}

// Resident blocks per SM at head_dim d for a block of sr <= 16 rows or
// more: with planned != 0 the count the launch bounds and the split count
// plan for, else what the card's occupancy calculator grants. -1 for a d
// this library does not take.
extern "C" int kkv_flash_gqa_cache_blocks_per_sm(int d, int kv8, int sr, int planned) {
  return d == KKV_HEAD_DIM ? blocks_d<KKV_HEAD_DIM>(kv8 != 0, sr > 16, planned != 0) : -1;
}

extern "C" int kkv_flash_gqa_cache(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale, const void* valid,
                                   void* out, void* part, long long part_floats, void* tickets,
                                   int n_tickets, int bkv, int kv, int sr, int r, int L, int d,
                                   int pos0, const void* pos0_vec, int window, float scale,
                                   float softcap, int n_split, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bkv < 1 || kv < 1 || bkv % kv || sr < 1 || r < 1 || L < 1 || window < 0 ||
      (k_scale == nullptr) != (v_scale == nullptr) || n_split < 1 || !(softcap >= 0.0f))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (L + BN - 1) / BN;
  const int tps = (n_tiles + n_split - 1) / n_split;
  const int qb = sr <= 16 ? 16 : 64;
  if (tps > MAX_TPS || n_split > MAX_SPLITS || (n_split - 1) * tps >= n_tiles ||
      (n_split > 1 && (part == nullptr || tickets == nullptr ||
                       part_floats < kkv_flash_gqa_cache_part_floats(bkv, sr, d, n_split) ||
                       (long long)n_tickets < (long long)bkv * ((sr + qb - 1) / qb))))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scale, v_scale, valid, out, part, tickets, pos0_vec, bkv, kv, sr, r, L, pos0,
               window, scale, softcap, n_split, tps};
  return d == KKV_HEAD_DIM ? (int)launch_d<KKV_HEAD_DIM>(a, s) : (int)cudaErrorInvalidValue;
}
