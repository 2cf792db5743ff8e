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
// and sum f32-grade:
//   * the R = H / KV query heads of one kv head fold into the q rows: folded
//     row i of (b, g) is sequence position pos0 + i / R, with pos0 one host
//     int or, given the device vector pos0_vec [B], pos0_vec[b];
//   * S = Q.K^T * D^-0.5; with an attention softcap S becomes
//     cap * tanh(S / cap) before the mask;
//   * keep(i, l) = l < L && q_pos >= l && kv_valid[b, l]
//                  && (window == 0 || q_pos - l < window);
//     masked scores are -1e30, and give p = 0;
//   * online softmax in f32 over 64-row cache tiles (m, l, acc), P kept in
//     f32 for P.V;
//   * out = acc / max(l, 1e-20): a row that sees no slot emits zeros.
//
// What bounds it on this card. Decode (S*R = 4 folded rows) and the verify
// chunk (S*R = 20) read 8 bytes of K and V for every 4 * S*R flops (per
// cache row and column): 2 and 10 flops a byte, under the ~49 flops a byte
// at which the tensor cores' f32-grade rate (below) meets 3.35 TB/s, so
// both are bound by bytes. A prefill piece
// (S*R in the thousands, every K/V tile shared by its q blocks through L2) is
// bound by operations, at 165 TFLOP/s.
//
// Arithmetic: both products on the tensor cores in 3xTF32 (mma.sync m16n8k8
// .tf32, f32 accumulators). Each f32 operand x splits exactly into
// hi = x & 0xffffe000 (x cut to TF32's 10-bit mantissa) and lo = x - hi, and
// a.b is taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b: 495 / 3 = 165 TFLOP/s
// of f32-grade products where FFMA on the CUDA cores gives 67. The tensor
// cores read the top 19 bits of a TF32 operand, so lo enters cut to 10 bits
// as well, and hi can be handed over as x itself (ptxas does so). One
// product (1xTF32) moves the output by ~3e-3: another function. This one
// lands within 3e-5 of the plain version (chip_smoke.py's f32 rows on an
// H100; the most at the 512-row piece), most of it from the tensor cores'
// accumulation, which rounds toward zero: each of the 3 * L / 8 mma results
// that P.V adds into the running o can shrink it by an ulp. Summing P.V and
// Q.K^T in fresh accumulators, added to o in f32, halved the piece's error
// but spilled every D = 128 instantiation and cost 29 % of its time;
// rounding hi (x + 0x1000 before the cut) moved the rows' errors by -32 % to
// +20 % for 6 % of the piece's time: neither is taken. cvt.rna.tf32.f32
// has no single instruction on sm_90. The max, exp and sum stay in f32 on
// the CUDA cores (scores in log2 units, p = 2^(x - m) by ex2.approx); P
// stays f32 and is split like any other operand. mma.sync and not wgmma:
// wgmma takes TF32 operands from shared memory only K-major, so P.V would
// need V transposed there, and a B operand read from shared memory would
// need its lo half stored there too, twice a stage's bytes; mma.sync takes
// both from registers, split in place.
//
// Work split. A block has 4 warps and QB = 16 (S*R <= 16, every decode), 32
// (S*R <= 32, the verify chunk at k = 4..7 with R = 4) or 64 q rows (wider).
// Each warp owns one 16-row q tile (the m16 of Q.K^T) and CW = 16, 32 or 64
// of each cache tile's 64 rows: with fewer than 64 q rows the warps that
// share a q tile split the cache rows and keep their own (m, l, o), merged
// through shared memory at the end, so every warp of a 16- or 32-row block
// works on real rows. Q.K^T: a lane holds its q rows g and g + 8 in
// registers in the mma's A order (d ordered so that one float4 of K feeds two
// k-steps); S comes out in the accumulator layout, which is P.V's operand
// layout once the cache rows of a k-step are taken in the order (2t,
// 2t + 1): P never leaves registers. P.V runs as O^T = V^T.P^T, so that P's
// accumulator pairs are the B operand as they stand and V enters as float2s,
// with no register moves; o is put back in row order when it is written.
// Tiles that every row of a warp sees whole skip the per-score mask.
//
// Shared memory. K and V tiles go through one ring of slots of 64 cache rows,
// K and V alternating (K of tile t, V of t, K of t + 1, ...), one barrier a
// slot, so that while one is in use the next one or more are in flight. K
// rows are D + 16 floats apart (the 16-byte loads of 8 lanes along 8 rows
// fall on distinct banks), V rows D + 4 (the 8-byte loads of 16 lanes along
// 4 row pairs likewise). A slot is 64 * (D + 16) * 4 bytes: 36,864 at
// D = 128, 20,480 at D = 64.
//   * D = 128: 3 slots (110,592 bytes; 113,168 with the live-tile list),
//     two resident blocks per SM. Decode too: a deeper ring at one block per
//     SM would halve the split count, and the split with the most live
//     tiles sets a decode's time.
//   * D = 64: 5 slots (102,400), two blocks per SM.
// The per-warp o, m and l of the merge and the split combine's weights reuse
// the ring after the last tile.
//
// The contract is the bf16 body's: split L across blocks with per-device
// tickets (graph-capturable), pos0 as a host int or a device pos0_vec,
// kv_valid, window and softcap, tiles no row of the block sees skipped before
// any copy, and the split count read from Cfg::BLOCKS.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// 16-row q tiles of a block for S*R folded rows: the block plan
// (kakveda_tpu_torch/models/attention.py, kernel_f32_q_rows).
constexpr int q_tiles(int sr) { return sr <= 16 ? 1 : (sr <= 32 ? 2 : 4); }

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int D, int NQW>
struct Cfg {
  static_assert(D == 64 || D == 128, "head_dim 64 or 128");
  static constexpr int QB = 16 * NQW;      // folded q rows of a block
  static constexpr int WPQ = WARPS / NQW;  // warps sharing one 16-row q tile
  static constexpr int CW = BN / WPQ;      // cache rows of each tile that one warp takes
  static constexpr int NT = CW / 8;        // its n-tiles of S, k-steps of P.V
  static constexpr int KS = D + 16;        // floats per K row in shared memory
  static constexpr int VS = D + 4;         // floats per V row
  static constexpr int RO = D + 4;         // floats per row of the merge's o
  static constexpr int SLOT = BN * KS * 4;  // bytes of one K or V tile
  static constexpr int SLOTS = D == 64 ? 5 : 3;
  static constexpr int RING = SLOTS * SLOT;
  static constexpr int RED = (WARPS * 16 * RO + 2 * WARPS * 16 + 2 * 64) * 4;  // per-warp o, m, l; per-row m, l
  static constexpr int COMB = MAX_SPLITS * 64 * 2 * 4;                       // the split combine's m and l
  static constexpr int MAIN = cmax(RING, cmax(RED, COMB));
  static constexpr int SMEM = MAIN + MAX_TPS * 8 + MAX_TPS * 2 + 16;
  static_assert(SMEM <= 227 * 1024, "one block's shared memory");
  // Resident blocks per SM the launch bounds and the split count plan for
  // (read through kkv_flash_gqa_cache_blocks_per_sm): two, whose shared
  // memory fits the SM's 228 KB (1 KB of it reserved per block).
  static constexpr int BLOCKS = 2;
  static_assert(BLOCKS * (SMEM + 1024) <= 228 * 1024, "two resident blocks per SM");
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

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x; 0 below 2^-126
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four f32 values as TF32 halves, x = hi + lo exactly (hi: x cut to 10
// mantissa bits).
__device__ __forceinline__ void split4(float a0, float a1, float a2, float a3, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = __float_as_uint(a[i]) & 0xffffe000u;
    lo[i] = __float_as_uint(a[i] - __uint_as_float(hi[i]));
  }
}

// c += a.b on the tensor cores: a 16x8 (row), b 8x8 (col), f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32 from split halves: the two cross terms, then hi.hi.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// grid (B * KV, ceil(SR / (16 * NQW)), n_split), block THREADS, dynamic
// shared memory Cfg<D, NQW>::SMEM. NQW is the number of 16-row q tiles of a
// block (q_tiles(SR)). CAP: scores are softcapped at `cap`.
//
// Fragments (mma m16n8k8 .tf32; lane = 4 g + t): A rows g, g + 8 and k
// columns t, t + 4; B k rows t, t + 4 and n column g; C rows g, g + 8 and n
// columns 2t, 2t + 1.
//   * Q.K^T, k-steps 2p and 2p + 1 take d = 16p + 4t + (0, 1) and
//     16p + 4t + (2, 3) as their k columns t, t + 4: one float4 of K row
//     8j + g serves both.
//   * P.V as O^T = V^T.P^T, k-step j: cache rows 8j + 2t, 8j + 2t + 1 as k
//     rows t, t + 4, which is where S's accumulators put them (P^T's B pair
//     of q rows g and g + 8); A rows g, g + 8 of m-tile i are V's columns
//     16i + 2g and 16i + 2g + 1, one float2 per cache row.
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
  constexpr int NT = C::NT;
  constexpr int KS = C::KS;
  constexpr int VS = C::VS;
  constexpr int RO = C::RO;
  constexpr int KP = D / 16;  // Q.K^T k-step pairs
  constexpr int MT = D / 16;  // m-tiles of O^T
  constexpr float L2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  unsigned char* lists = smem + C::MAIN;
  uint2* vmask = reinterpret_cast<uint2*>(lists);  // per tile: valid bits, even / odd rows
  short* live = reinterpret_cast<short*>(lists + MAX_TPS * 8);
  int* flag = reinterpret_cast<int*>(lists + MAX_TPS * 10);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
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
  const int n_units = 2 * n_live;  // K of each live tile, then its V

  // Unit u (K of live tile u / 2 when u is even, else its V) into its slot:
  // each thread copies one 16-byte chunk of every RPI-th row, at constant
  // offsets; only a tile that runs past L tests its rows.
  auto load_unit = [&](int u) {
    constexpr int CH = D / 4;          // 16-byte chunks per cache row
    constexpr int RPI = THREADS / CH;  // rows one pass of the block copies
    const int l0 = (t0 + live[u >> 1]) * BN;
    const int rr = tid / CH, cc = tid % CH;
    const float* base = ((u & 1) ? v : k) + kv_base * D;
    const float* src = base + (size_t)(l0 + rr) * D + cc * 4;
    float* dst = ring + (u % C::SLOTS) * (C::SLOT / 4) + cc * 4;
    auto copy = [&](auto stride) {
      constexpr int RS = decltype(stride)::value;
      float* d0 = dst + rr * RS;
      if (l0 + BN <= L) {
#pragma unroll
        for (int i = 0; i < BN / RPI; ++i) cp_async16(d0 + i * RPI * RS, src + (size_t)i * RPI * D, true);
      } else {
#pragma unroll
        for (int i = 0; i < BN / RPI; ++i) {
          const bool ok = l0 + rr + i * RPI < L;
          cp_async16(d0 + i * RPI * RS, ok ? src + (size_t)i * RPI * D : base, ok);
        }
      }
    };
    if (u & 1) copy(std::integral_constant<int, VS>());
    else copy(std::integral_constant<int, KS>());
  };
  // Unit u's slot is visible to all, the one read at u - 1 is free and
  // takes unit u + SLOTS - 1.
  auto advance = [&](int u) {
    cp_async_wait<C::SLOTS - 2>();
    __syncthreads();
    const int nx = u + C::SLOTS - 1;
    if (nx < n_units) load_unit(nx);
    cp_async_commit();
  };

  // 2. Start the first slots' copies, then this lane's q rows g and g + 8
  //    into registers in A order (zeros past the warp's real rows): qf[p][h]
  //    is k-step 2p + h's (row g: d, d + 1 as k t, t + 4; row g + 8 alike).
  for (int i = 0; i < C::SLOTS - 1; ++i) {
    if (i < n_units) load_unit(i);
    cp_async_commit();
  }
  float qf[KP][2][4];
  {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4* qg = reinterpret_cast<const float4*>(q + ((size_t)bkv * sr + wrow) * D) + t;
    const bool ra = n_live > 0 && g < nr, rb = n_live > 0 && g + 8 < nr;
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      const float4 a = ra ? __ldg(qg + (size_t)g * (D / 4) + 4 * p) : zero;
      const float4 b = rb ? __ldg(qg + (size_t)(g + 8) * (D / 4) + 4 * p) : zero;
      qf[p][0][0] = a.x, qf[p][0][1] = b.x, qf[p][0][2] = a.y, qf[p][0][3] = b.y;
      qf[p][1][0] = a.z, qf[p][1][1] = b.z, qf[p][1][2] = a.w, qf[p][1][3] = b.w;
    }
  }

  // O^T accumulators: o[2i + h] holds columns 16i + 2g (c0, c1) and + 1
  // (c2, c3) of rows 8h + 2t (c0, c2) and 8h + 2t + 1 (c1, c3).
  float o[2 * MT][4];
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows g, g + 8, log2 units (the same in a row's 4 lanes)
  float l0 = 0.0f, l1 = 0.0f;        // running sums of this lane's columns
  float sc[NT][4];                   // S, then P, of the tile in flight
  const int qp0 = pos0 + (wrow + g) / r;
  const int qp1 = pos0 + (wrow + g + 8) / r;
  const int qlo = pos0 + wrow / r;
  const int qhi = pos0 + (wrow + max(nr, 1) - 1) / r;
  constexpr unsigned WBITS = CW == 64 ? 0xffffffffu : (1u << (CW / 2)) - 1u;
  const unsigned wbits = WBITS << (cw0 >> 1);  // validity bits of this warp's cache rows
  const float sx = CAP ? scale : scale * L2E;

  // 3. The live tiles through the ring: K (Q.K^T and the softmax), then V
  //    (P.V), one barrier each.
  for (int it = 0; it < n_live; ++it) {
    advance(2 * it);
    const int li = live[it];
    if (nr > 0) {
      const float* kt = ring + ((2 * it) % C::SLOTS) * (C::SLOT / 4) + (cw0 + g) * KS + 4 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        // Opaque to the compiler, so that q's split stays here and is not
        // hoisted out of the loop as twice q's registers.
        asm volatile("" : "+f"(qf[p][0][0]), "+f"(qf[p][0][1]), "+f"(qf[p][0][2]), "+f"(qf[p][0][3]));
        asm volatile("" : "+f"(qf[p][1][0]), "+f"(qf[p][1][1]), "+f"(qf[p][1][2]), "+f"(qf[p][1][3]));
        uint32_t ah0[4], al0[4], ah1[4], al1[4];
        split4(qf[p][0][0], qf[p][0][1], qf[p][0][2], qf[p][0][3], ah0, al0);
        split4(qf[p][1][0], qf[p][1][1], qf[p][1][2], qf[p][1][3], ah1, al1);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 kk = *reinterpret_cast<const float4*>(kt + j * 8 * KS + 16 * p);
          uint32_t bh[4], bl[4];
          split4(kk.x, kk.y, kk.z, kk.w, bh, bl);
          mma3(sc[j], ah0, al0, bh[0], bh[1], bl[0], bl[1]);
          mma3(sc[j], ah1, al1, bh[2], bh[3], bl[2], bl[3]);
        }
      }
      // Scale (to log2 units) and cap; mask where not every row of the warp
      // sees every one of its cache rows; each row's max over its 4 lanes;
      // P in place of S, the rows' corrections applied to o.
      const uint2 vm = vmask[li];
      const int lt = (t0 + li) * BN + cw0;  // cache row of this warp's column 0
      const bool full = (vm.x & wbits) == wbits && (vm.y & wbits) == wbits && lt + CW - 1 <= qlo &&
                        (window == 0 || qhi - lt < window);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * sx;
          if constexpr (CAP) x = cap * L2E * tanhf(x / cap);
          sc[j][e] = x;
        }
      if (!full) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = lt + 8 * j + 2 * t + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            const unsigned w = (e & 1) ? vm.y : vm.x;
            const bool keep =
                ((w >> ((cw0 >> 1) + 4 * j + t)) & 1u) && qp >= col && (window == 0 || qp - col < window);
            if (!keep) sc[j][e] = NEG_INF;
          }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp2_approx(m0 - mn0), c1 = exp2_approx(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // A row that has seen nothing yet (max -1e30) takes 0 as its max: its
      // masked scores then give p = 2^-1e30 = 0, as they do under any real max.
      const float ms0 = mn0 == NEG_INF ? 0.0f : mn0, ms1 = mn1 == NEG_INF ? 0.0f : mn1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sc[j][0] = exp2_approx(sc[j][0] - ms0);
        sc[j][1] = exp2_approx(sc[j][1] - ms0);
        sc[j][2] = exp2_approx(sc[j][2] - ms1);
        sc[j][3] = exp2_approx(sc[j][3] - ms1);
        sum0 += sc[j][0] + sc[j][1];
        sum1 += sc[j][2] + sc[j][3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
      // o holds rows 2t, 2t + 1 (and 8 on): their corrections from lanes
      // 8t and 8t + 4, whose rows g are 2t and 2t + 1; none where no row's
      // max moved.
      const float ra = __shfl_sync(0xffffffffu, c0, 8 * t), rb = __shfl_sync(0xffffffffu, c0, 8 * t + 4);
      const float rc = __shfl_sync(0xffffffffu, c1, 8 * t), rd = __shfl_sync(0xffffffffu, c1, 8 * t + 4);
      if (!__all_sync(0xffffffffu, c0 == 1.0f && c1 == 1.0f)) {
#pragma unroll
        for (int i = 0; i < 2 * MT; i += 2) {
          o[i][0] *= ra;
          o[i][1] *= rb;
          o[i][2] *= ra;
          o[i][3] *= rb;
          o[i + 1][0] *= rc;
          o[i + 1][1] *= rd;
          o[i + 1][2] *= rc;
          o[i + 1][3] *= rd;
        }
      }
    }
    advance(2 * it + 1);
    if (nr > 0) {
      const float* vt = ring + ((2 * it + 1) % C::SLOTS) * (C::SLOT / 4) + (cw0 + 2 * t) * VS + 2 * g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh[4], bl[4];  // P^T: the pairs of q rows g and g + 8
        split4(sc[j][0], sc[j][1], sc[j][2], sc[j][3], bh, bl);
        const float* v0 = vt + 8 * j * VS;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * i);
          const float2 x1 = *reinterpret_cast<const float2*>(v0 + VS + 16 * i);
          uint32_t ah[4], al[4];
          split4(x0.x, x0.y, x1.x, x1.y, ah, al);
          mma3(o[2 * i], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma3(o[2 * i + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      }
    }
  }

  // 4. Each warp's (m, l, o) to shared memory (the ring is free now), o in
  //    row order; then the warps that share a q tile merge.
  cp_async_wait<0>();
  __syncthreads();
  float* red_o = ring;                     // [WARPS][16][RO]
  float* red_m = red_o + WARPS * 16 * RO;  // [WARPS][16]
  float* red_l = red_m + WARPS * 16;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (nr > 0) {
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) {
      float* r0 = red_o + (warp * 16 + 8 * (i & 1) + 2 * t) * RO + 16 * (i >> 1) + 2 * g;
      *reinterpret_cast<float2*>(r0) = make_float2(o[i][0], o[i][2]);
      *reinterpret_cast<float2*>(r0 + RO) = make_float2(o[i][1], o[i][3]);
    }
    if (t == 0) {
      red_m[warp * 16 + g] = m0;
      red_m[warp * 16 + g + 8] = m1;
      red_l[warp * 16 + g] = l0;
      red_l[warp * 16 + g + 8] = l1;
    }
  }
  __syncthreads();
  // Per row: the merge's weights 2^(m_w - m) in place of the warps' m (over
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
      e[s] = exp2_approx(red_m[w * 16 + ri] - mx);
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
  // This split's partials: [QB][D] acc, then [QB] m and [QB] l (m in log2 units).
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
      const float4 x = *reinterpret_cast<const float4*>(&red_o[(w * 16 + ri) * RO + cc]);
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
  //    per row the weights 2^(m_s - m*) / max(l*, 1e-20) into shared
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
      const float e = exp2_approx(cw[s * QB + rr] - mx);
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
// bkv * ceil(sr / qb) tickets (qb = 16 when sr <= 16, 32 when sr <= 32, else
// 64) and refuses less. Launches on `stream`, does not synchronise; returns
// the CUDA error code (0 on success).
extern "C" long long kkv_flash_gqa_cache_part_floats(int bkv, int sr, int d, int n_split) {
  const int qb = 16 * q_tiles(sr);
  return n_split > 1 ? (long long)bkv * ((sr + qb - 1) / qb) * n_split * qb * (d + 2) : 0;
}

// Resident blocks per SM at head_dim d for a block of sr folded rows (the
// block plan above): with planned != 0 the count the launch bounds and the
// split count plan for, else what the card's occupancy calculator grants.
// -1 for a d this library does not take, or an int8 cache.
extern "C" int kkv_flash_gqa_cache_blocks_per_sm(int d, int kv8, int sr, int planned) {
  if (d != KKV_HEAD_DIM || kv8 != 0 || sr < 1) return -1;
  constexpr int D = KKV_HEAD_DIM;
  switch (q_tiles(sr)) {
    case 1: return planned ? Cfg<D, 1>::BLOCKS : occupancy<D, 1>();
    case 2: return planned ? Cfg<D, 2>::BLOCKS : occupancy<D, 2>();
    default: return planned ? Cfg<D, 4>::BLOCKS : occupancy<D, 4>();
  }
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
  const int qb = 16 * q_tiles(sr);
  if (tps > MAX_TPS || n_split > MAX_SPLITS || (n_split - 1) * tps >= n_tiles ||
      (n_split > 1 && (part == nullptr || tickets == nullptr ||
                       part_floats < kkv_flash_gqa_cache_part_floats(bkv, sr, d, n_split) ||
                       (long long)n_tickets < (long long)bkv * ((sr + qb - 1) / qb))))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, valid, out, part, tickets, pos0_vec, bkv, kv, sr, r, L, pos0,
               window, scale, softcap, n_split, tps};
  constexpr int D = KKV_HEAD_DIM;
  switch (q_tiles(sr)) {
    case 1: return (int)launch_cap<D, 1>(a, s);
    case 2: return (int)launch_cap<D, 2>(a, s);
    default: return (int)launch_cap<D, 4>(a, s);
  }
}
