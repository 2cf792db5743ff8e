// Blockwise online-softmax GQA attention over a head-major KV cache, for
// Hopper (sm_90a). One template, two bodies: a bf16 cache and an int8 cache
// with f32 per-row scales.
//
// Replaces the Pallas TPU kernel kakveda_tpu/models/attention.py::
// flash_gqa_cache (pl.pallas_call at attention.py:284), bodies _flash_kernel
// (bf16 cache) and _flash_kernel_kv8 (int8 cache), both through _flash_body.
// It computes what _flash_body computes:
//   * the R = H / KV query heads of one kv head fold into the q rows: folded
//     row i of (b, g) is sequence position pos0 + i / R;
//   * S = Q.K^T * D^-0.5 with bf16 operands and f32 accumulation;
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
// Design, simple first:
//   * one block of 4 warps per (b * KV + g, 64 folded q rows); each warp owns
//     16 q rows (a warp whose rows all lie past S*R skips the math);
//   * a loop over the cache in 64-row tiles takes the place of the TPU's
//     sequential third grid axis; K/V tiles stream through a 2-stage
//     cp.async ring (16-byte copies, zero-fill past L). The int8 body copies
//     int8 tiles and dequantizes them into bf16 tiles in shared memory;
//   * mma.sync m16n8k16 bf16 with f32 accumulators for both products; the
//     S accumulator's register layout is reused as the A operand of P.V, so
//     scores and probabilities never leave registers;
//   * mask, max, exp and sums in f32 registers, row reductions across the
//     four lanes that share a row.
//
// Bound: bytes. The cache is read once, B*KV*2*L*D*2 bytes for bf16 and
// B*KV*2*L*(D+4) for int8 (values and scales), against 4*B*KV*S*R*L*D flops.
// At decode (S*R = 4) that is ~1 flop a byte, far below the ~295 at which
// the H100's tensor cores would bind. Decode at 8 slots gives B*KV = 64
// blocks for 132 SMs, so half the card streams the cache; splitting L across
// blocks (flash-decoding), TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // folded q rows per block
constexpr int BN = 64;   // cache rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

template <int D>
struct Cfg {
  static constexpr int LD = D + 8;  // bf16 row stride in shared memory (conflict-free fragments)
  static constexpr int TILE = BN * LD;
};

template <int D, bool KV8>
constexpr int smem_bytes() {
  // Q tile, then K and V bf16 tiles (2 stages for bf16; 1 dequantized stage
  // for int8), then the int8 ring (2 stages of K and V).
  return (BM * Cfg<D>::LD + (KV8 ? 2 : 4) * Cfg<D>::TILE) * 2 + (KV8 ? 4 * BN * D : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat16 dequant(int8_t q, __nv_bfloat16 s) {
  // bf16(int8) is exact; the product of two bf16 values is exact in f32, so
  // one rounding to bf16 gives the bf16 product.
  return __float2bfloat16(static_cast<float>(q) * __bfloat162float(s));
}

// grid (B * KV, ceil(SR / BM)), block THREADS, dynamic shared memory
// smem_bytes<D, KV8>().
template <int D, bool KV8>
__global__ void __launch_bounds__(THREADS)
flash_gqa_kernel(const __nv_bfloat16* __restrict__ q,  // [B*KV, SR, D]
                 const void* __restrict__ k_,           // [B*KV, L, D] bf16 or int8
                 const void* __restrict__ v_,
                 const float* __restrict__ k_scale,     // [B*KV, L] (int8 only)
                 const float* __restrict__ v_scale,
                 const uint8_t* __restrict__ valid,     // [B, L] or null
                 __nv_bfloat16* __restrict__ out,       // [B*KV, SR, D]
                 int kv, int sr, int r, int L, int pos0, int window, float scale) {
  using C = Cfg<D>;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Kb = Qs + BM * LD;                      // bf16 K tiles
  __nv_bfloat16* Vb = Kb + (KV8 ? 1 : 2) * C::TILE;      // bf16 V tiles
  int8_t* K8 = reinterpret_cast<int8_t*>(Vb + (KV8 ? 1 : 2) * C::TILE);  // int8 ring
  int8_t* V8 = K8 + 2 * BN * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within the fragment
  const int t = lane & 3;   // column pair within the fragment
  const int bkv = blockIdx.x;
  const int row0 = blockIdx.y * BM;
  const int wrow = row0 + warp * 16;  // first folded row of this warp
  const bool active = wrow < sr;
  const size_t kv_base = (size_t)bkv * L;
  const uint8_t* vrow = valid ? valid + (size_t)(bkv / kv) * L : nullptr;

  // Q tile (rows past SR zero-filled); joins the first commit group.
  const __nv_bfloat16* qg = q + (size_t)bkv * sr * D;
  for (int idx = tid; idx < BM * (D / 8); idx += THREADS) {
    const int rr = idx / (D / 8), c = idx % (D / 8);
    const bool ok = row0 + rr < sr;
    cp_async16(&Qs[rr * LD + c * 8], qg + (ok ? (size_t)(row0 + rr) * D + c * 8 : 0), ok);
  }

  auto load_tile = [&](int tile, int stage) {
    const int l0 = tile * BN;
    if constexpr (KV8) {
      const int8_t* kg = static_cast<const int8_t*>(k_) + kv_base * D;
      const int8_t* vg = static_cast<const int8_t*>(v_) + kv_base * D;
      for (int idx = tid; idx < BN * (D / 16); idx += THREADS) {
        const int rr = idx / (D / 16), c = idx % (D / 16);
        const bool ok = l0 + rr < L;
        const size_t off = ok ? (size_t)(l0 + rr) * D + c * 16 : 0;
        cp_async16(&K8[(stage * BN + rr) * D + c * 16], kg + off, ok);
        cp_async16(&V8[(stage * BN + rr) * D + c * 16], vg + off, ok);
      }
    } else {
      const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(k_) + kv_base * D;
      const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(v_) + kv_base * D;
      for (int idx = tid; idx < BN * (D / 8); idx += THREADS) {
        const int rr = idx / (D / 8), c = idx % (D / 8);
        const bool ok = l0 + rr < L;
        const size_t off = ok ? (size_t)(l0 + rr) * D + c * 8 : 0;
        cp_async16(&Kb[stage * C::TILE + rr * LD + c * 8], kg + off, ok);
        cp_async16(&Vb[stage * C::TILE + rr * LD + c * 8], vg + off, ok);
      }
    }
  };

  const int n_tiles = (L + BN - 1) / BN;
  load_tile(0, 0);
  cp_async_commit();

  uint32_t qa[D / 16][4];  // this warp's 16 q rows as mma A fragments
  float o[D / 8][4];       // P.V accumulators: rows g and g + 8, columns 8 * nd + 2t (+1)
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows g and g + 8
  float l0s = 0.0f, l1s = 0.0f;      // this lane's share of the running sums
  const int qp0 = pos0 + (wrow + g) / r;
  const int qp1 = pos0 + (wrow + g + 8) / r;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) load_tile(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();

    if (tile == 0 && active) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* p = &Qs[(warp * 16 + g) * LD + kc * 16 + 2 * t];
        qa[kc][0] = ld32(p);
        qa[kc][1] = ld32(p + 8 * LD);
        qa[kc][2] = ld32(p + 8);
        qa[kc][3] = ld32(p + 8 * LD + 8);
      }
    }

    const __nv_bfloat16* Ks;
    const __nv_bfloat16* Vs;
    const int lt = tile * BN;
    if constexpr (KV8) {
      // Dequantize the int8 stage into the bf16 tiles.
      for (int idx = tid; idx < BN * (D / 8); idx += THREADS) {
        const int rr = idx / (D / 8), c = idx % (D / 8);
        const bool ok = lt + rr < L;
        const __nv_bfloat16 ks = __float2bfloat16(ok ? k_scale[kv_base + lt + rr] : 0.0f);
        const __nv_bfloat16 vs = __float2bfloat16(ok ? v_scale[kv_base + lt + rr] : 0.0f);
        const int8_t* kp = &K8[(stage * BN + rr) * D + c * 8];
        const int8_t* vp = &V8[(stage * BN + rr) * D + c * 8];
        const uint2 kraw = *reinterpret_cast<const uint2*>(kp);
        const uint2 vraw = *reinterpret_cast<const uint2*>(vp);
        const int8_t* kq = reinterpret_cast<const int8_t*>(&kraw);
        const int8_t* vq = reinterpret_cast<const int8_t*>(&vraw);
        uint4 kd, vd;
        kd.x = pack2(dequant(kq[0], ks), dequant(kq[1], ks));
        kd.y = pack2(dequant(kq[2], ks), dequant(kq[3], ks));
        kd.z = pack2(dequant(kq[4], ks), dequant(kq[5], ks));
        kd.w = pack2(dequant(kq[6], ks), dequant(kq[7], ks));
        vd.x = pack2(dequant(vq[0], vs), dequant(vq[1], vs));
        vd.y = pack2(dequant(vq[2], vs), dequant(vq[3], vs));
        vd.z = pack2(dequant(vq[4], vs), dequant(vq[5], vs));
        vd.w = pack2(dequant(vq[6], vs), dequant(vq[7], vs));
        *reinterpret_cast<uint4*>(&Kb[rr * LD + c * 8]) = kd;
        *reinterpret_cast<uint4*>(&Vb[rr * LD + c * 8]) = vd;
      }
      __syncthreads();
      Ks = Kb;
      Vs = Vb;
    } else {
      Ks = Kb + stage * C::TILE;
      Vs = Vb + stage * C::TILE;
    }

    if (active) {
      // S = Q.K^T for this warp's 16 rows and the tile's 64 cache rows.
      float sc[BN / 8][4];
#pragma unroll
      for (int nc = 0; nc < BN / 8; ++nc) sc[nc][0] = sc[nc][1] = sc[nc][2] = sc[nc][3] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
        for (int nc = 0; nc < BN / 8; ++nc) {
          const __nv_bfloat16* p = &Ks[(nc * 8 + g) * LD + kc * 16 + 2 * t];
          mma_bf16(sc[nc], qa[kc], ld32(p), ld32(p + 8));
        }
      }
      // Scale and mask; keep bit 4 * nc + e for element e of chunk nc.
      uint32_t keep = 0;
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int nc = 0; nc < BN / 8; ++nc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = lt + nc * 8 + 2 * t + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          const bool kp = col < L && qp >= col && (vrow == nullptr || vrow[col] != 0) &&
                          (window == 0 || qp - col < window);
          const float s = kp ? sc[nc][e] * scale : NEG_INF;
          sc[nc][e] = s;
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
      for (int nc = 0; nc < BN / 8; ++nc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (keep >> (4 * nc + e)) & 1u ? expf(sc[nc][e] - (e < 2 ? mn0 : mn1)) : 0.0f;
          sc[nc][e] = p;
        }
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
      for (int j = 0; j < BN / 16; ++j) {
        const uint32_t pa[4] = {pack2f(sc[2 * j][0], sc[2 * j][1]),
                                pack2f(sc[2 * j][2], sc[2 * j][3]),
                                pack2f(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                                pack2f(sc[2 * j + 1][2], sc[2 * j + 1][3])};
        const __nv_bfloat16* vp = &Vs[(j * 16 + 2 * t) * LD + g];
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const __nv_bfloat16* p = vp + nd * 8;
          const uint32_t b0 = pack2(p[0], p[LD]);
          const uint32_t b1 = pack2(p[8 * LD], p[9 * LD]);
          mma_bf16(o[nd], pa, b0, b1);
        }
      }
    }
    __syncthreads();  // the stage just read is the next prefetch's target
  }

  if (!active) return;
  l0s += __shfl_xor_sync(0xffffffffu, l0s, 1);
  l0s += __shfl_xor_sync(0xffffffffu, l0s, 2);
  l1s += __shfl_xor_sync(0xffffffffu, l1s, 1);
  l1s += __shfl_xor_sync(0xffffffffu, l1s, 2);
  const float d0 = fmaxf(l0s, 1e-20f), d1 = fmaxf(l1s, 1e-20f);
  const int r0 = wrow + g, r1 = wrow + g + 8;
  __nv_bfloat16* og = out + (size_t)bkv * sr * D;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int c = nd * 8 + 2 * t;
    if (r0 < sr)
      *reinterpret_cast<uint32_t*>(&og[(size_t)r0 * D + c]) = pack2f(o[nd][0] / d0, o[nd][1] / d0);
    if (r1 < sr)
      *reinterpret_cast<uint32_t*>(&og[(size_t)r1 * D + c]) = pack2f(o[nd][2] / d1, o[nd][3] / d1);
  }
}

template <int D, bool KV8>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* valid, void* out, int bkv, int kv, int sr, int r, int L, int pos0,
                   int window, float scale, cudaStream_t s) {
  constexpr int bytes = smem_bytes<D, KV8>();
  static bool attr_set = false;  // setting it twice is harmless
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_gqa_kernel<D, KV8>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(bkv, (sr + BM - 1) / BM);
  flash_gqa_kernel<D, KV8><<<grid, THREADS, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const uint8_t*>(valid),
      static_cast<__nv_bfloat16*>(out), kv, sr, r, L, pos0, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q [bkv, sr, d] bf16 (the R heads of each kv head folded into the rows),
// k, v [bkv, L, d] bf16, or int8 with k_scale, v_scale [bkv, L] f32 (null
// for bf16), valid [bkv / kv, L] bytes 0/1 or null (all valid), out
// [bkv, sr, d] bf16. d is 64 or 128; every pointer 16-byte aligned. Launches
// on `stream`, does not synchronise; returns the CUDA error code (0 on
// success).
extern "C" int kkv_flash_gqa_cache(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale, const void* valid,
                                   void* out, int bkv, int kv, int sr, int r, int L, int d,
                                   int pos0, int window, float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bkv < 1 || kv < 1 || bkv % kv || sr < 1 || r < 1 || L < 1 || window < 0 ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool kv8 = k_scale != nullptr;
  cudaError_t err;
  if (d == 128)
    err = kv8 ? launch<128, true>(q, k, v, k_scale, v_scale, valid, out, bkv, kv, sr, r, L, pos0,
                                  window, scale, s)
              : launch<128, false>(q, k, v, k_scale, v_scale, valid, out, bkv, kv, sr, r, L, pos0,
                                   window, scale, s);
  else if (d == 64)
    err = kv8 ? launch<64, true>(q, k, v, k_scale, v_scale, valid, out, bkv, kv, sr, r, L, pos0,
                                 window, scale, s)
              : launch<64, false>(q, k, v, k_scale, v_scale, valid, out, bkv, kv, sr, r, L, pos0,
                                  window, scale, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}
