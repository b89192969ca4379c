// The float32 flash-attention forward for Hopper (sm_90a), on the CUDA
// cores in exact float32: FMAs, no TF32 and no 3xTF32, on (B, L, H, D)
// tensors.
//
// Replaces, for float32 queries of more than 16 rows (shorter ones take
// flash_decode.cu), the Pallas TPU kernel of
// paddle_tpu/ops/pallas/flash_attention.py
//   _fwd_kernel (:84, via _fwd :183, call :215) -> flash_fwd_fp32_kernel
// with the semantics of flash_attention.cu: scores s = q.k * scale in
// float32; bottom-right causal (row r sees cols c <= r + Lk - Lq); a
// sliding window (with causal) keeps c > r + Lk - Lq - window; the additive
// float32 mask with element (b, h, r, c) at mask[b*m_sb + h*m_sh + r*m_sr +
// c] (strides of 0 broadcast); GQA, q head h reading kv head h / (H / Hkv)
// without a repeat; o and lse = m + log(l), lse a natural log as the
// backward reads it; a row that sees nothing writes o = 0 and lse = -inf.
// D is a multiple of 8 up to 128; q, k and v are read through (batch, row,
// head) strides with the last dimension contiguous and every row 16-byte
// aligned, so the views of a fused qkv projection need no copy.
//
// Bound: operations.  At ERNIE's shape (B 32, L 128, H 12, D 64,
// non-causal) a call does 2 products of 2 * L * L * D flops a head, 1.61
// GFLOP, 0.0240 ms at the 67 TFLOP/s of 132 SMs x 128 FMA lanes; it moves
// 25 MB (q, k, v read, o written, lse), 0.0075 ms at 3.35 TB/s.  The
// products decide the time, and the shared-memory loads that feed them.
//
// Design (flash_attention.cu's float32 path loaded 2 + 2 NT scalars from
// shared memory for 4 NT FMAs, ran every element through the visibility
// tests, and copied each tile synchronously between two barriers):
//  * A block owns 64 query rows of one (batch, head): grid (ceil(Lq / 64),
//    H, B), 128 threads.  Thread (tr, tc) of a warp's 4 x 8 lanes holds
//    rows tr + 16 i (i < 4) and, of each 32-key tile, keys tc + 8 j (j <
//    4): a 4 x 4 micro-tile of S; of O, the same rows times columns 4 tc +
//    32 n + e (n < DT / 32, e < 4): 4 x 8 floats at DT 64, 4 x 16 at DT
//    128.  A row's 8 lanes sit in one warp, so its max and sum reduce by
//    three xor shuffles.
//  * Q, K and V stay row-major in shared memory as they arrive, rows
//    padded to DT + 4 floats.  A step of 4 along D reads one float4 of Q
//    for each of the 4 rows and one float4 of K for each of the 4 keys (8
//    loads, 64 FMAs); O += P V reads one float4 of P for each row per 4
//    keys and one float4 of V per key and column group (12 loads for 128
//    FMAs at DT 64, 20 for 256 at DT 128).  With the padding the 8 lanes
//    of a row read 8 consecutive rows of K, or 128 contiguous bytes of V,
//    and the 4 rows of a warp lie 16 bytes apart in the banks: no load
//    conflicts.  P (float32, rows padded to 40) goes through shared memory
//    for P V; a warp reads only its own rows, so a __syncwarp suffices.
//  * K and V tiles of 32 keys arrive by cp.async (16-byte copies, rows
//    past Lk and columns past D zero-filled) in a ring of 2 stages; Q goes
//    with the first stage, and each tile's copy overlaps the previous
//    tile's products.  A key-vector mask (m_sr == 0, the padding mask of
//    ERNIE and BERT) travels with its stage: 32 floats, 4-byte copies.
//  * Only edge tiles test elements: the causal diagonal, the window's
//    edge and the ragged Lk tail, decided once per tile for the block.
//    Tiles that see nothing are never visited: the walk covers the key
//    tiles from the window's first to the causal band's last.  Rows past
//    Lq compute on zero-filled Q and are neither written nor stored in
//    lse.  A full-row mask is loaded per element (from L2, at clamped
//    addresses, before the tile's product) only in its own instantiation.
//  * The softmax runs in log2 units: scores times scale * log2(e) (a mask
//    value times log2(e) added by one FMA) and exp2f; each lane keeps its
//    own partial row sum, reduced once at the end; lse = m ln 2 + log(l).
//  * Shared memory: Q 17 KB + 2 stages of (K, V, mask) 34.25 KB + P 10 KB
//    = 61.25 KB at DT 64, so 3 blocks (12 warps) an SM: at ERNIE's shape
//    the 768 blocks run in 1.94 waves of 396.  At DT 128, Q 33 KB + 2
//    stages 66.25 KB + P 10 KB = 109.25 KB: 2 blocks (8 warps) an SM.
//    Launch bounds name those blocks an SM, so ptxas keeps registers
//    within 168 and 255 a thread.
//  * Under causal masking the longest blocks start first (the q tiles in
//    reverse order).  Templates on the head-dim tile (64, 128) and the
//    mask mode (none, key vector, full rows); causal, window and lengths
//    are runtime arguments.  No atomics: two launches give equal bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_params.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int BQ = 64;        // query rows a block
constexpr int BK = 32;        // keys a tile
constexpr int RT = 4;         // rows a thread: tr + 16 i
constexpr int CT = BK / 8;    // keys a thread in a tile: tc + 8 j
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int MASK_NONE = 0;
constexpr int MASK_KEYS = 1;  // m_sr == 0: one row of Lk per (batch, head)
constexpr int MASK_FULL = 2;

template <int DT>
struct Geom {
  static constexpr int LD = DT + 4;  // Q, K, V row stride (floats)
  static constexpr int LP = BK + 8;  // P row stride
  static constexpr int ND = DT / 32; // float4 column groups of O a thread
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int KV_FLOATS = BK * LD;  // one K or V tile
  static constexpr int STAGE_FLOATS = 2 * KV_FLOATS + BK;  // K, V, mask
  static constexpr int SMEM =
      sizeof(float) * (Q_FLOATS + STAGES * STAGE_FLOATS + BQ * LP);
  static constexpr int MIN_BLOCKS = DT == 64 ? 3 : 2;
};

// 16 bytes from global to shared memory, bypassing L1; `bytes` 0 fills
// the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, as cp_async16
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// max and sum over the 8 lanes of a row (lanes 8 k .. 8 k + 7)
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// rows row0 .. row0 + R - 1 of a (rows, D) slab with row stride `ld` into
// the shared tile at `dst` (row stride LD floats); rows >= rows and
// columns >= D are zero-filled
template <int R, int DT>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src,
                                          const void* base, int64_t ld,
                                          int row0, int rows, int D) {
  constexpr int CH = DT / 4;  // 16-byte chunks a row
  constexpr int LD = Geom<DT>::LD;
  static_assert(R * CH % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < R * CH / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int r = i / CH, c = (i - r * CH) * 4;
    const bool ok = row0 + r < rows && c < D;
    cp_async16(dst + (r * LD + c) * 4,
               ok ? static_cast<const void*>(src + (row0 + r) * ld + c)
                  : base,
               ok ? 16 : 0);
  }
}

// grid (ceil(Lq / 64), H, B): a block owns 64 query rows of one head
template <int DT, int MODE>
__global__ void __launch_bounds__(THREADS, Geom<DT>::MIN_BLOCKS)
    flash_fwd_fp32_kernel(const FlashParams p) {
  using G = Geom<DT>;
  constexpr int LD = G::LD, LP = G::LP, ND = G::ND;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sRing = sQ + G::Q_FLOATS;  // STAGES x {K [BK][LD], V, mask [BK]}
  float* sP = sRing + STAGES * G::STAGE_FLOATS;
  const uint32_t s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int nq = gridDim.x;
  const int qt = p.causal ? nq - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tr = warp * 4 + (lane >> 3);  // rows tr + 16 i
  const int tc = lane & 7;                // keys tc + 8 j; O cols 4 tc + 32 n
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* mg =
      MODE == MASK_NONE ? nullptr : p.mask + b * p.m_sb + h * p.m_sh;
  const int off = p.Lk - p.Lq;

  // the key tiles any row of this block sees: [kb, ke)
  int kb = 0, ke = (p.Lk + BK - 1) / BK;
  if (p.causal) {
    const int hi = q0 + BQ - 1 + off;  // the last key the last row sees
    ke = hi < 0 ? 0 : min(ke, hi / BK + 1);
    if (p.window) {
      const int lo = q0 + off - p.window + 1;  // the first row's first key
      kb = lo <= 0 ? 0 : lo / BK;
    }
  }

  // key tile t into its stage of the ring
  auto issue = [&](int t) {
    const int k0 = t * BK;
    const uint32_t st =
        s_base + 4 * (G::Q_FLOATS + ((t - kb) % STAGES) * G::STAGE_FLOATS);
    load_rows<BK, DT>(st, kg, p.k, p.k_sl, k0, p.Lk, p.D);
    load_rows<BK, DT>(st + 4 * G::KV_FLOATS, vg, p.v, p.v_sl, k0, p.Lk, p.D);
    if constexpr (MODE == MASK_KEYS) {
      const int x = threadIdx.x;
      if (x < BK) {
        const bool ok = k0 + x < p.Lk;
        cp_async4(st + 4 * (2 * G::KV_FLOATS + x),
                  ok ? static_cast<const void*>(mg + k0 + x) : p.mask,
                  ok ? 4 : 0);
      }
    }
  };

  // Q with the first stage, then the second: one group each
  load_rows<BQ, DT>(s_base, qg, p.q, p.q_sl, q0, p.Lq, p.D);
  if (kb < ke) issue(kb);
  cp_commit();
  if (kb + 1 < ke) issue(kb + 1);
  cp_commit();

  float o[RT][ND][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  float m_run[RT], l_run[RT];  // log2 units; l over this lane's keys
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  const float sl2 = p.scale * LOG2E;

  for (int t = kb; t < ke; ++t) {
    cp_wait<1>();  // tile t (and Q) landed; tile t + 1 may still travel
    __syncthreads();
    const float* sK = sRing + ((t - kb) % STAGES) * G::STAGE_FLOATS;
    const float* sV = sK + G::KV_FLOATS;
    const float* sM = sV + G::KV_FLOATS;
    const int k0 = t * BK;

    // the mask's values: a full row's loads travel over the product
    float mv[RT][CT];
    if constexpr (MODE == MASK_KEYS) {
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        mv[0][j] = sM[tc + 8 * j];
#pragma unroll
        for (int i = 1; i < RT; ++i) mv[i][j] = mv[0][j];
      }
    } else if constexpr (MODE == MASK_FULL) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int64_t row = min(q0 + tr + 16 * i, p.Lq - 1);
#pragma unroll
        for (int j = 0; j < CT; ++j)
          mv[i][j] =
              __ldg(mg + row * p.m_sr + min(k0 + tc + 8 * j, p.Lk - 1));
      }
    }

    // S = Q K^T for this thread's 4 rows x 4 keys
    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DT; d += 4) {
      float4 a[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = ld4(sQ + (tr + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float4 kv = ld4(sK + (tc + 8 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          s[i][j] = fmaf(a[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, kv.w, s[i][j]);
        }
      }
    }

    // a tile wholly visible to every row of the block takes no test
    const bool edge =
        k0 + BK > p.Lk ||
        (p.causal && (k0 + BK - 1 > q0 + off ||
                      (p.window && k0 <= q0 + BQ - 1 + off - p.window)));
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = q0 + tr + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        float x = s[i][j] * sl2;
        if constexpr (MODE != MASK_NONE) x = fmaf(mv[i][j], LOG2E, x);
        if (edge) {
          const int col = k0 + tc + 8 * j;
          bool keep = col < p.Lk;
          if (p.causal) {
            keep = keep && row + off >= col;
            if (p.window) keep = keep && col > row + off - p.window;
          }
          if (!keep) x = -INFINITY;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[i], row_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m_run[i] - m_safe);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const float pj = exp2f(s[i][j] - m_safe);
        sum += pj;
        sP[(tr + 16 * i) * LP + tc + 8 * j] = pj;
      }
      l_run[i] = l_run[i] * corr + sum;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][n][e] *= corr;
    }
    __syncwarp();

    // O += P V
#pragma unroll 2
    for (int k = 0; k < BK; k += 4) {
      float4 pa[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) pa[i] = ld4(sP + (tr + 16 * i) * LP + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const float4 vv = ld4(sV + (k + kk) * LD + 4 * tc + 32 * n);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            const float pv = at(pa[i], kk);
            o[i][n][0] = fmaf(pv, vv.x, o[i][n][0]);
            o[i][n][1] = fmaf(pv, vv.y, o[i][n][1]);
            o[i][n][2] = fmaf(pv, vv.z, o[i][n][2]);
            o[i][n][3] = fmaf(pv, vv.w, o[i][n][3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage and its P rows
    if (t + STAGES < ke) issue(t + STAGES);
    cp_commit();
  }
  cp_wait<0>();

  float* og = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float l = row_sum(l_run[i]);
    const int row = q0 + tr + 16 * i;
    if (row >= p.Lq) continue;
    const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 4 * tc + 32 * n;
      if (c < p.D)
        *reinterpret_cast<float4*>(og + row * p.o_sl + c) =
            make_float4(o[i][n][0] / l_safe, o[i][n][1] / l_safe,
                        o[i][n][2] / l_safe, o[i][n][3] / l_safe);
    }
    if (tc == 0)
      p.lse_out[((int64_t)b * p.H + h) * p.Lq + row] =
          m_run[i] * LN2 + logf(l_safe);
  }
}

template <int DT, int MODE>
cudaError_t launch(const FlashParams& p, int device, cudaStream_t st) {
  constexpr int smem = Geom<DT>::SMEM;
  const void* kernel =
      reinterpret_cast<const void*>(flash_fwd_fp32_kernel<DT, MODE>);
  // cudaFuncSetAttribute once per kernel and device, not on every launch
  static std::atomic<uint64_t> done{0};
  const uint64_t bit = 1ull << (device & 63);
  if (!(done.load(std::memory_order_acquire) & bit)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((p.Lq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_fp32_kernel<DT, MODE><<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int DT>
cudaError_t by_mask(const FlashParams& p, int device, cudaStream_t st) {
  if (p.mask == nullptr) return launch<DT, MASK_NONE>(p, device, st);
  if (p.m_sr == 0) return launch<DT, MASK_KEYS>(p, device, st);
  return launch<DT, MASK_FULL>(p, device, st);
}

// 16-byte aligned base and (batch, row, head) strides in elements that
// keep every row 16-byte aligned (0 for a broadcast dimension)
bool operand_ok(const void* x, int64_t sb, int64_t sl, int64_t sh) {
  return x != nullptr && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         sb % 4 == 0 && sl % 4 == 0 && sh % 4 == 0;
}

}  // namespace

// dtype must be 0 (float32).  Returns a cudaError_t code:
// cudaErrorInvalidValue for what the kernel does not take, else the result
// of cudaGetLastError() right after the launch.
extern "C" int flash_fwd_fp32_fwd(const FlashParams* p, int dtype,
                                  int device, void* stream) {
  if (p == nullptr || dtype != 0 || p->B < 1 || p->B > 65535 ||
      p->Hkv < 1 || p->H < p->Hkv || p->H % p->Hkv || p->H > 65535 ||
      p->Lq < 1 || p->Lk < 1 || p->D < 8 || p->D > 128 || p->D % 8 ||
      p->window < 0 || p->out == nullptr || p->lse_out == nullptr ||
      !operand_ok(p->q, p->q_sb, p->q_sl, p->q_sh) ||
      !operand_ok(p->k, p->k_sb, p->k_sl, p->k_sh) ||
      !operand_ok(p->v, p->v_sb, p->v_sl, p->v_sh) ||
      !operand_ok(p->out, p->o_sb, p->o_sl, p->o_sh))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->D <= 64) return (int)by_mask<64>(*p, device, st);
  return (int)by_mask<128>(*p, device, st);
}

extern "C" int flash_fwd_fp32_params_size() { return sizeof(FlashParams); }

extern "C" const char* flash_fwd_fp32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
