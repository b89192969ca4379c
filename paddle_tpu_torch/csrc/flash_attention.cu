// Flash attention for Hopper (sm_90a): the forward, and the two kernels of
// the backward (dK/dV, then dQ), on (B, L, H, D) tensors.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
//   _fwd_kernel  (via _fwd)  -> flash_fwd_kernel
//   _dkv_kernel  (via _bwd)  -> flash_dkv_kernel
//   _dq_kernel   (via _bwd)  -> flash_dq_kernel
// reached through flash_attention / _flash_core and the sdpa override in
// paddle_tpu/ops/pallas/__init__.py.
//
// Semantics, as the TPU kernels: scores s = q.k * scale in float32;
// bottom-right causal (row r sees cols c <= r + Lk - Lq); a sliding window
// (with causal) keeps c > r + Lk - Lq - window; an optional additive float32
// mask with element (b, h, r, c) at mask[b*m_sb + h*m_sh + r*m_sr + c] (a
// stride of 0 broadcasts, so batch, head and row broadcasts are never
// materialised); GQA, q head h reading kv head h / (H / Hkv).  The forward
// keeps an online softmax per row in float32, casts p to the value dtype
// before P.V (as the TPU kernel does), and writes o and lse = m + log(l);
// a row that sees nothing writes o = 0 and lse = -inf.  The backward
// recomputes p = exp(s - lse), with lse taken as 0 where it is not finite,
// and takes delta = rowsum(dO * O) from the caller.
//
// Tiles of 64 query rows and 64 key rows; a tile pair is skipped when the
// causal band, the window or the key length leaves it empty, with the TPU
// kernels' own tests.  Lengths need not be multiples of 64: rows and
// columns past Lq / Lk are zero-filled on load and masked.
//
// Bound, at the GPT training shape (B 4, L 1024, H 16, D 128, causal,
// bf16): the forward moves ~67 MB for ~17 GFLOP and is bound by bytes
// (~0.020 ms at 3.35 TB/s); dK/dV (4 products) and dQ (3 products) are
// bound by operations (~0.035 and ~0.026 ms at 989 TFLOP/s).
//
// Design (simple and right first; flash_attention_sm90.cu holds the
// TMA/wgmma/warp-specialised forward, dK/dV and dQ for bf16 / fp16 at D 64
// and 128, flash_fwd_fp32.cu the float32 forward on the CUDA cores,
// flash_decode.cu the forward of short queries, and the wrapper routes
// only the rest here: the float32 backward, other head dims):
//  * one block of 4 warps per (64-row tile, head, batch); each warp owns 16
//    rows of the block's tile.  A loop inside the block over the other
//    operand's tiles replaces the TPU's sequential grid axis and its VMEM
//    scratch: the running state lives in registers for the whole loop, and
//    the outputs are written once, with no atomics (dK/dV loops over the
//    g query heads of its kv head times the query tiles, as the TPU grid
//    folds the group into its last axis).
//  * products run on the tensor cores through mma.sync m16n8k16 for bf16
//    and fp16, with float32 accumulation, from operand tiles staged in
//    shared memory.  float32 runs the same loops on the CUDA cores in full
//    float32 (no TF32), so it can be held to 1e-5 against the plain
//    version; float32 forwards now go to flash_fwd_fp32.cu, and this
//    file's float32 forward runs only when forced (A/B timing, tests).
//  * p (forward) and p, dS (backward) pass through shared memory in the
//    input dtype to become tensor-core operands: in bf16 / fp16 the backward
//    therefore rounds p and dS where the TPU kernel keeps float32.
//  * q, k, v, o, dO and the gradients are addressed through (batch, row,
//    head) strides, so the q/k/v views of a fused qkv projection need no
//    copy; the last dimension must be contiguous and rows 16-byte aligned.
//  * head dims: D a multiple of 8 from 8 to 128, in tiles of 64 or 128
//    (zero-padded).  Templates are instantiated on dtype and head-dim tile
//    only; causal, window, mask layout and lengths are runtime arguments.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_params.cuh"

namespace {

constexpr int TILE = 64;      // rows of every tile
constexpr int THREADS = 128;  // 4 warps of 16 rows each

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float from(float x) { return x; }
  static __device__ __forceinline__ void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float x,
                                                float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Cvt<__half> {
  static __device__ __forceinline__ __half from(float x) {
    return __float2half(x);
  }
  static __device__ __forceinline__ void store2(__half* p, float x, float y) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x, y);
  }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// two 16-bit elements p[0] (low half) and p[S] (high half) in one register
template <int S, typename T>
__device__ __forceinline__ uint32_t ld_pair(const T* p) {
  if constexpr (S == 1) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
    const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + S);
    return lo | (hi << 16);
  }
}

// One warp: acc[NT][4] += A (16 x KD) * B (KD x 8 NT), both in shared
// memory, A(m, k) at sA[m * AM + k * AK] and B(k, n) at sB[k * BK + n * BN].
// acc is in the mma.sync m16n8 accumulator layout: with g = lane / 4 and
// t = lane % 4, acc[nt] holds (g, 8nt + 2t), (g, 8nt + 2t + 1),
// (g + 8, 8nt + 2t), (g + 8, 8nt + 2t + 1).  float32 computes the same
// elements with scalar FMAs.
template <typename T, int NT, int KD, int AM, int AK, int BK, int BN>
__device__ __forceinline__ void warp_gemm(const T* __restrict__ sA,
                                          const T* __restrict__ sB,
                                          float (*acc)[4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 4) {
#pragma unroll 4
    for (int k = 0; k < KD; ++k) {
      const float a0 = sA[g * AM + k * AK];
      const float a1 = sA[(g + 8) * AM + k * AK];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float b0 = sB[k * BK + (nt * 8 + 2 * t) * BN];
        const float b1 = sB[k * BK + (nt * 8 + 2 * t + 1) * BN];
        acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
        acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
        acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
        acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
      }
    }
  } else {
#pragma unroll 2
    for (int kk = 0; kk < KD; kk += 16) {
      uint32_t a[4];
      a[0] = ld_pair<AK>(sA + g * AM + (kk + 2 * t) * AK);
      a[1] = ld_pair<AK>(sA + (g + 8) * AM + (kk + 2 * t) * AK);
      a[2] = ld_pair<AK>(sA + g * AM + (kk + 2 * t + 8) * AK);
      a[3] = ld_pair<AK>(sA + (g + 8) * AM + (kk + 2 * t + 8) * AK);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        b[0] = ld_pair<BK>(sB + (kk + 2 * t) * BK + (nt * 8 + g) * BN);
        b[1] = ld_pair<BK>(sB + (kk + 2 * t + 8) * BK + (nt * 8 + g) * BN);
        Cvt<T>::mma(acc[nt], a, b);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

// rows row0 .. row0 + TILE - 1 of a (rows, D) slab with row stride `ld`
// into a shared tile [TILE][LD] of DT columns; rows >= rows and columns
// >= D are zero.  16-byte loads: D is a multiple of 16 / sizeof(T) and the
// wrapper checks the row alignment.
template <typename T, int DT, int LD>
__device__ __forceinline__ void load_tile(T* __restrict__ s,
                                          const T* __restrict__ g,
                                          int64_t ld, int row0, int rows,
                                          int D) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = DT / VEC;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < TILE * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = (i - r * CPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows && c < D)
      val = __ldg(reinterpret_cast<const uint4*>(g + (int64_t)(row0 + r) * ld +
                                                 c));
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// the TPU kernels' test for a (query tile, key tile) pair with any visible
// element: inside the key length, not wholly above the causal diagonal,
// not wholly left of the window
__device__ __forceinline__ bool tile_runs(const FlashParams& p, int q0,
                                          int k0) {
  const int off = p.Lk - p.Lq;
  bool run = k0 < p.Lk;
  if (p.causal) run = run && (q0 + TILE + off > k0);
  if (p.window) run = run && (k0 + TILE - 1 > q0 + off - p.window);
  return run;
}

// s * scale for a visible (row, col), plus the additive mask; -inf else
__device__ __forceinline__ float score(const FlashParams& p,
                                       const float* __restrict__ mg, float s,
                                       int row, int col) {
  const int off = p.Lk - p.Lq;
  bool keep = row < p.Lq && col < p.Lk;
  if (p.causal) {
    keep = keep && row + off >= col;
    if (p.window) keep = keep && col > row + off - p.window;
  }
  if (!keep) return -INFINITY;
  s *= p.scale;
  if (mg != nullptr) s += __ldg(mg + (int64_t)row * p.m_sr + col);
  return s;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int DT>
struct Geom {
  static constexpr int LD = DT + 16 / sizeof(T);    // operand tile stride
  static constexpr int LP = TILE + 16 / sizeof(T);  // p / dS tile stride
  static constexpr int NTD = DT / 8;                // n-tiles over D
  static constexpr int NTK = TILE / 8;              // n-tiles over a tile
  static constexpr size_t TILE_BYTES = sizeof(T) * TILE * LD;
  static constexpr size_t P_BYTES = sizeof(T) * TILE * LP;
  static constexpr size_t FWD_SMEM = 3 * TILE_BYTES + P_BYTES;
  static constexpr size_t DKV_SMEM =
      4 * TILE_BYTES + 2 * P_BYTES + 2 * TILE * sizeof(float);
  static constexpr size_t DQ_SMEM = 4 * TILE_BYTES + P_BYTES;
};

// ------------------------------------------------------------------ forward
// grid (ceil(Lq / 64), H, B): a block owns 64 query rows of one head
template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const FlashParams p) {
  using G = Geom<T, DT>;
  constexpr int LD = G::LD, LP = G::LP, NTD = G::NTD, NTK = G::NTK;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + TILE * LD;
  T* sV = sK + TILE * LD;
  T* sP = sV + TILE * LD;

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* mg =
      p.mask == nullptr ? nullptr : p.mask + b * p.m_sb + h * p.m_sh;

  load_tile<T, DT, LD>(sQ, qg, p.q_sl, q0, p.Lq, p.D);

  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // rows in the tile
  float acc[NTD][4];
  zero<NTD>(acc);
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  const int nk = (p.Lk + TILE - 1) / TILE;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * TILE;
    if (!tile_runs(p, q0, k0)) continue;  // uniform across the block
    __syncthreads();
    load_tile<T, DT, LD>(sK, kg, p.k_sl, k0, p.Lk, p.D);
    load_tile<T, DT, LD>(sV, vg, p.v_sl, k0, p.Lk, p.D);
    __syncthreads();

    float s[NTK][4];
    zero<NTK>(s);
    // S = Q K^T: B(k = d, n = key) = sK[n][d]
    warp_gemm<T, NTK, DT, LD, 1, 1, LD>(sQ + warp * 16 * LD, sK, s);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        s[nt][i] = score(p, mg, s[nt][i], q0 + rl[r],
                         k0 + nt * 8 + 2 * t + (i & 1));
        mx[r] = fmaxf(mx[r], s[nt][i]);
      }
    float m_safe[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      m_safe[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = expf(m_run[r] - m_safe[r]);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = expf(s[nt][i] - m_safe[i >> 1]);
        sum[i >> 1] += s[nt][i];
      }
      const int c = nt * 8 + 2 * t;
      Cvt<T>::store2(sP + rl[0] * LP + c, s[nt][0], s[nt][1]);
      Cvt<T>::store2(sP + rl[1] * LP + c, s[nt][2], s[nt][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + quad_sum(sum[r]);
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }
    __syncwarp();
    // O += P V: A = P (this warp's rows), B(k = key, n = d) = sV[k][n]
    warp_gemm<T, NTD, TILE, LP, 1, LD, 1>(sP + warp * 16 * LP, sV, acc);
  }

  T* og = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl[r];
    if (row >= p.Lq) continue;
    const float l_safe = l_run[r] == 0.f ? 1.f : l_run[r];
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < p.D)
        Cvt<T>::store2(og + row * p.o_sl + c, acc[nt][2 * r] / l_safe,
                       acc[nt][2 * r + 1] / l_safe);
    }
    if (t == 0)
      p.lse_out[((int64_t)b * p.H + h) * p.Lq + row] =
          m_run[r] + logf(l_safe);
  }
}

// --------------------------------------------------------------- dK and dV
// grid (ceil(Lk / 64), Hkv, B): a block owns 64 key rows of one kv head and
// loops over the g query heads of its group times the query tiles
template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
    flash_dkv_kernel(const FlashParams p) {
  using G = Geom<T, DT>;
  constexpr int LD = G::LD, LP = G::LP, NTD = G::NTD;
  constexpr int NTH = TILE / 16;  // n-tiles in half a query tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + TILE * LD;
  T* sQ = sV + TILE * LD;
  T* sO = sQ + TILE * LD;  // dO
  T* sP = sO + TILE * LD;
  T* sS = sP + TILE * LP;  // dS
  float* sLse = reinterpret_cast<float*>(sS + TILE * LP);
  float* sDelta = sLse + TILE;

  const int k0 = blockIdx.x * TILE, hk = blockIdx.y, b = blockIdx.z;
  const int grp = p.H / p.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // key rows

  load_tile<T, DT, LD>(sK, static_cast<const T*>(p.k) + b * p.k_sb +
                               hk * p.k_sh, p.k_sl, k0, p.Lk, p.D);
  load_tile<T, DT, LD>(sV, static_cast<const T*>(p.v) + b * p.v_sb +
                               hk * p.v_sh, p.v_sl, k0, p.Lk, p.D);
  float dk[NTD][4], dv[NTD][4];
  zero<NTD>(dk);
  zero<NTD>(dv);

  const int nq = (p.Lq + TILE - 1) / TILE;
  for (int j = 0; j < grp; ++j) {
    const int h = hk * grp + j;
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const float* lse = p.lse + ((int64_t)b * p.H + h) * p.Lq;
    const float* delta = p.delta + ((int64_t)b * p.H + h) * p.Lq;
    const float* mg =
        p.mask == nullptr ? nullptr : p.mask + b * p.m_sb + h * p.m_sh;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * TILE;
      if (!tile_runs(p, q0, k0)) continue;  // uniform across the block
      __syncthreads();
      load_tile<T, DT, LD>(sQ, qg, p.q_sl, q0, p.Lq, p.D);
      load_tile<T, DT, LD>(sO, dog, p.do_sl, q0, p.Lq, p.D);
      for (int i = threadIdx.x; i < TILE; i += THREADS) {
        const bool in = q0 + i < p.Lq;
        const float l = in ? lse[q0 + i] : 0.f;
        sLse[i] = isfinite(l) ? l : 0.f;
        sDelta[i] = in ? delta[q0 + i] : 0.f;
      }
      __syncthreads();

      // in two halves of 32 query rows, to keep registers for dK and dV:
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 key rows
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = half * (TILE / 2);
        float st[NTH][4], dpt[NTH][4];
        zero<NTH>(st);
        zero<NTH>(dpt);
        warp_gemm<T, NTH, DT, LD, 1, 1, LD>(sK + warp * 16 * LD,
                                            sQ + c0 * LD, st);
        warp_gemm<T, NTH, DT, LD, 1, 1, LD>(sV + warp * 16 * LD,
                                            sO + c0 * LD, dpt);
#pragma unroll
        for (int nt = 0; nt < NTH; ++nt) {
          float pv[4], ds[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int qc = c0 + nt * 8 + 2 * t + (i & 1);  // query in tile
            const float sv = score(p, mg, st[nt][i], q0 + qc, k0 + rl[i >> 1]);
            pv[i] = expf(sv - sLse[qc]);
            ds[i] = pv[i] * (dpt[nt][i] - sDelta[qc]);
          }
          const int c = c0 + nt * 8 + 2 * t;
          Cvt<T>::store2(sP + rl[0] * LP + c, pv[0], pv[1]);
          Cvt<T>::store2(sP + rl[1] * LP + c, pv[2], pv[3]);
          Cvt<T>::store2(sS + rl[0] * LP + c, ds[0], ds[1]);
          Cvt<T>::store2(sS + rl[1] * LP + c, ds[2], ds[3]);
        }
      }
      __syncwarp();
      // dV += P^T dO and dK += dS^T Q: B(k = query, n = d) = tile[k][n]
      warp_gemm<T, NTD, TILE, LP, 1, LD, 1>(sP + warp * 16 * LP, sO, dv);
      warp_gemm<T, NTD, TILE, LP, 1, LD, 1>(sS + warp * 16 * LP, sQ, dk);
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + rl[r];
    if (row >= p.Lk) continue;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < p.D) {
        Cvt<T>::store2(dkg + row * p.dk_sl + c, dk[nt][2 * r] * p.scale,
                       dk[nt][2 * r + 1] * p.scale);
        Cvt<T>::store2(dvg + row * p.dv_sl + c, dv[nt][2 * r],
                       dv[nt][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------- dQ
// grid (ceil(Lq / 64), H, B): a block owns 64 query rows of one head
template <typename T, int DT>
__global__ void __launch_bounds__(THREADS)
    flash_dq_kernel(const FlashParams p) {
  using G = Geom<T, DT>;
  constexpr int LD = G::LD, LP = G::LP, NTD = G::NTD, NTK = G::NTK;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + TILE * LD;  // dO
  T* sK = sO + TILE * LD;
  T* sV = sK + TILE * LD;
  T* sS = sV + TILE * LD;  // dS

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* mg =
      p.mask == nullptr ? nullptr : p.mask + b * p.m_sb + h * p.m_sh;

  load_tile<T, DT, LD>(sQ, static_cast<const T*>(p.q) + b * p.q_sb +
                               h * p.q_sh, p.q_sl, q0, p.Lq, p.D);
  load_tile<T, DT, LD>(sO, static_cast<const T*>(p.dout) + b * p.do_sb +
                               h * p.do_sh, p.do_sl, q0, p.Lq, p.D);
  const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl[r];
    const int64_t at = ((int64_t)b * p.H + h) * p.Lq + row;
    const float l = row < p.Lq ? p.lse[at] : 0.f;
    lse[r] = isfinite(l) ? l : 0.f;
    delta[r] = row < p.Lq ? p.delta[at] : 0.f;
  }
  float dq[NTD][4];
  zero<NTD>(dq);

  const int nk = (p.Lk + TILE - 1) / TILE;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * TILE;
    if (!tile_runs(p, q0, k0)) continue;  // uniform across the block
    __syncthreads();
    load_tile<T, DT, LD>(sK, kg, p.k_sl, k0, p.Lk, p.D);
    load_tile<T, DT, LD>(sV, vg, p.v_sl, k0, p.Lk, p.D);
    __syncthreads();

    float s[NTK][4], dp[NTK][4];
    zero<NTK>(s);
    zero<NTK>(dp);
    warp_gemm<T, NTK, DT, LD, 1, 1, LD>(sQ + warp * 16 * LD, sK, s);
    warp_gemm<T, NTK, DT, LD, 1, 1, LD>(sO + warp * 16 * LD, sV, dp);
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float sv =
            score(p, mg, s[nt][i], q0 + rl[r], k0 + nt * 8 + 2 * t + (i & 1));
        ds[i] = expf(sv - lse[r]) * (dp[nt][i] - delta[r]);
      }
      const int c = nt * 8 + 2 * t;
      Cvt<T>::store2(sS + rl[0] * LP + c, ds[0], ds[1]);
      Cvt<T>::store2(sS + rl[1] * LP + c, ds[2], ds[3]);
    }
    __syncwarp();
    // dQ += dS K: B(k = key, n = d) = sK[k][n]
    warp_gemm<T, NTD, TILE, LP, 1, LD, 1>(sS + warp * 16 * LP, sK, dq);
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl[r];
    if (row >= p.Lq) continue;
#pragma unroll
    for (int nt = 0; nt < NTD; ++nt) {
      const int c = nt * 8 + 2 * t;
      if (c < p.D)
        Cvt<T>::store2(dqg + row * p.dq_sl + c, dq[nt][2 * r] * p.scale,
                       dq[nt][2 * r + 1] * p.scale);
    }
  }
}

enum Which { FWD = 0, DKV = 1, DQ = 2 };

template <typename T, int DT>
cudaError_t launch(const FlashParams& p, Which which, cudaStream_t st) {
  using G = Geom<T, DT>;
  const int nq = (p.Lq + TILE - 1) / TILE;
  const int nk = (p.Lk + TILE - 1) / TILE;
  void (*kernel)(const FlashParams);
  size_t smem;
  dim3 grid;
  if (which == FWD) {
    kernel = flash_fwd_kernel<T, DT>;
    smem = G::FWD_SMEM;
    grid = dim3(nq, p.H, p.B);
  } else if (which == DKV) {
    kernel = flash_dkv_kernel<T, DT>;
    smem = G::DKV_SMEM;
    grid = dim3(nk, p.Hkv, p.B);
  } else {
    kernel = flash_dq_kernel<T, DT>;
    smem = G::DQ_SMEM;
    grid = dim3(nq, p.H, p.B);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_tile(const FlashParams& p, Which which, cudaStream_t st) {
  if (p.D <= 64) return launch<T, 64>(p, which, st);
  return launch<T, 128>(p, which, st);
}

int run(const FlashParams* p, Which which, int dtype, int device,
        void* stream) {
  if (p == nullptr || p->B < 1 || p->B > 65535 || p->Hkv < 1 ||
      p->H < p->Hkv || p->H % p->Hkv || p->H > 65535 || p->Lq < 1 ||
      p->Lk < 1 || p->D < 8 || p->D > 128 || p->D % 8 || p->window < 0 ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)by_tile<float>(*p, which, st);
  if (dtype == 1) return (int)by_tile<__nv_bfloat16>(*p, which, st);
  return (int)by_tile<__half>(*p, which, st);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  Each returns a cudaError_t
// code: cudaErrorInvalidValue for shapes the kernels do not take, else the
// result of cudaGetLastError() right after the launch.
extern "C" int flash_attention_fwd(const FlashParams* p, int dtype,
                                   int device, void* stream) {
  return run(p, FWD, dtype, device, stream);
}

extern "C" int flash_attention_bwd_dkv(const FlashParams* p, int dtype,
                                       int device, void* stream) {
  return run(p, DKV, dtype, device, stream);
}

extern "C" int flash_attention_bwd_dq(const FlashParams* p, int dtype,
                                      int device, void* stream) {
  return run(p, DQ, dtype, device, stream);
}

extern "C" int flash_attention_params_size() { return sizeof(FlashParams); }

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
