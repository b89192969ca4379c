// Flash decoding for Hopper (sm_90a): the flash-attention forward for short
// queries (a decode step, Lq 1, or a speculative verify step, Lq k + 1), on
// (B, L, H, D) tensors in float32, bfloat16 or float16.
//
// Replaces, for the short queries the wrapper sends here, the Pallas TPU
// kernel of paddle_tpu/ops/pallas/flash_attention.py
//   _fwd_kernel (:84, via _fwd, call :215) -> flash_decode_mma_kernel
//       (bfloat16 / float16) or flash_decode_kernel (float32), then
//       flash_decode_merge_kernel
// with the semantics of flash_attention.cu: scores s = q.k * scale in
// float32; bottom-right causal (row r sees cols c <= r + Lk - Lq); a
// sliding window (with causal) keeps c > r + Lk - Lq - window; the additive
// float32 mask with element (b, h, r, c) at mask[b*m_sb + h*m_sh + r*m_sr +
// c] (strides of 0 broadcast); GQA, q head h reading kv head h / (H / Hkv)
// without a repeat; p rounded to the value dtype before P.V, as the TPU
// kernel does (:135); o in q's dtype and lse = m + log(l) in float32; a row
// that sees nothing writes o = 0 and lse = -inf.  D is a multiple of 8 up
// to 128; q, k and v are read through (batch, row, head) strides with the
// last dimension contiguous and every row 16-byte aligned.
//
// Bound: memory.  A call reads K and V once, B * Lk * Hkv * D elements each
// (9.4 MB at Mistral-7B's decode shape, B 4, Lk 576, Hkv 8, D 128, bf16:
// 2.8 us at 3.35 TB/s), and does 4 flops per element read times the g Lq
// query rows of a kv head, far below the card's ~295 flops/byte balance
// point.  The flash_attention.cu forward loses here for three reasons: a
// 64-row query tile holds one real row, each of the g query heads of a
// kv head reads its K/V again, and its grid (1, H, B) walks every key tile
// in one block with a synchronous load per tile.
//
// Design ("flash-decoding"):
//  * The grid is (Hkv, B, splits).  A block covers all g * Lq query rows of
//    one (kv head, batch) - row j is query head j / Lq of the group at query
//    position j % Lq: 4 rows for Mistral at Lq 1, 35 for Qwen2's verify
//    step (g 7, Lq 5) - so each K/V row is read from memory once per group;
//    a block with more rows than it holds at once walks its keys once per
//    chunk of rows, the later walks from L2.
//  * The keys are split across blocks: splits = ceil(Lk / 64), at most 64
//    (ops/flash_attention.py `decode_split_plan`), from Lk alone, never
//    from the mask's contents, so a captured CUDA graph keeps its shape.
//  * bfloat16 / float16 (flash_decode_mma_kernel): a chunk is 16 rows,
//    zero-padded, the A operand of mma.sync m16n8k16; each of the 4 warps
//    takes 16 keys of every 64-key tile, whose K and V come into shared
//    memory by cp.async (16-byte copies; two stages when a split has more
//    than one tile, so the next tile's copies travel while this one
//    computes).  S = Q K^T (K by ldmatrix), the online softmax on the
//    accumulator fragments in float32, p rounded to T as the A operand of
//    O += P V (V by ldmatrix.trans), float32 accumulation; the warps'
//    states merge through shared memory.  On the tensor cores a 16-key
//    slice costs a warp a few dozen instructions; the same work on the
//    CUDA cores (a lane per 8 elements of D, xor reductions, a softmax
//    that each lane of a token repeats) took 10x more and set the time
//    (PERF.md).
//  * float32 (flash_decode_kernel), on the CUDA cores in full float32: a
//    "token group" of lpt lanes (the smallest power of two that covers D
//    in 16-byte vectors) takes U tokens a round; a lane holds one 16-byte
//    vector of q of each of its G rows (G = 1, 2, 4 or 8), and of K and V
//    of each token.  K and V come through a ring of STAGES rounds in
//    shared memory filled by cp.async, STAGES - 1 rounds ahead: each lane
//    copies and later reads only its own slots, so the ring needs no
//    barrier.  The group reduces q.k with xor shuffles and keeps its own
//    online softmax state per row in registers; the groups' states merge
//    through shared memory.
//  * Both compute a tile's or a round's scores side by side: the mask
//    loads (at clamped, always valid columns, with no branch) first, so
//    they travel while the products run, then a branch-free online
//    softmax.  A hidden score is -inf; while a row has seen nothing its
//    maximum stays -inf and the exponents run against 0, so its state
//    stays (m -inf, l 0, acc 0) and no -inf - -inf NaN arises, and a split
//    that sees nothing (the window's left tail, the masked tail beyond
//    pos) merges as empty.
//  * With one split the block writes o and lse.  With more, each block
//    writes its partial state (acc[D], m, l per row) to float32 partials
//    that the wrapper allocates per call with torch.empty, and a second
//    small launch (flash_decode_merge_kernel, a block per row and a thread
//    per element) merges them by their maxima.  Partials per call, rather
//    than the paged kernel's per-device workspace that grows and is
//    replaced, because this kernel runs inside a captured CUDA graph:
//    torch.empty during capture takes the memory from the graph's own
//    pool, so a replay never reads a freed buffer, and two graphs of
//    different Lk never share one.  No arrival counters, so nothing has to
//    be zeroed or left at zero.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_params.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int STAGES = 4;     // rounds of the cp.async ring
constexpr int U = 2;          // tokens a group takes a round

// a float32 output element as T
template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

// the four float32 elements of a 16-byte vector
__device__ __forceinline__ void unpack4(const uint4& v, float* o) {
  o[0] = __uint_as_float(v.x);
  o[1] = __uint_as_float(v.y);
  o[2] = __uint_as_float(v.z);
  o[3] = __uint_as_float(v.w);
}

// 16 bytes from global to shared memory, bypassing L1; `bytes` 0 fills
// the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

// ------------------------------------------------- float32: CUDA cores
// grid (Hkv, B, splits); G query rows in registers at once.  part_acc
// [B, H, Lq, splits, D] and part_ml [B, H, Lq, splits, 2] (m, l) are
// written, and o / lse not, when splits > 1.
template <int G>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const FlashParams p, float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int split_keys,
                        int lpt) {
  using T = float;
  constexpr int VEC = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  // the ring: slot (stage, u, K or V) of thread x at uint4 index
  // ((stage * U + u) * 2 + kv) * THREADS + x; after the walk the same
  // memory holds the groups' states
  const uint4* ring = reinterpret_cast<const uint4*>(smem);
  const uint32_t ring_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int g = p.H / p.Hkv;
  const int rows = g * p.Lq;
  const int nv = p.D / VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tpw = 32 / lpt;                  // token groups per warp
  const int ngrp = (THREADS / 32) * tpw;     // token groups per block
  const int gl = lane % lpt;                 // lane within its group
  const int grp = warp * tpw + lane / lpt;   // this lane's group
  const bool has = gl < nv;                  // the lane holds a vector
  const int off = p.Lk - p.Lq;
  const int t_begin = split * split_keys;
  const int t_end = min(p.Lk, t_begin + split_keys);
  const int step = U * ngrp;                 // tokens a block takes a round
  const int nrounds = t_end > t_begin ? (t_end - t_begin + step - 1) / step
                                      : 0;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh +
                gl * VEC;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh +
                gl * VEC;

  float* sm_m = reinterpret_cast<float*>(smem);  // [ngrp][G]
  float* sm_l = sm_m + ngrp * G;                 // [ngrp][G]
  float* sm_acc = sm_l + ngrp * G;               // [ngrp][G][D]

  // copy round `it` into its stage: U tokens of K and V for this lane
  auto issue = [&](int it) {
    if (it < nrounds) {
      const int st = it % STAGES;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t_begin + it * step + u * ngrp + grp;
        const bool ok = has && t < t_end;
        const uint32_t dk =
            ring_s + (((st * U + u) * 2) * THREADS + threadIdx.x) * 16;
        cp_async16(dk, ok ? kg + t * p.k_sl : p.k, ok ? 16 : 0);
        cp_async16(dk + THREADS * 16, ok ? vg + t * p.v_sl : p.v,
                   ok ? 16 : 0);
      }
    }
    cp_commit();   // an empty group past the last round keeps the count
  };

  for (int r0 = 0; r0 < rows; r0 += G) {
    const int gc = min(G, rows - r0);
    float qr[G][VEC], acc[G][VEC], m[G], l[G];
    const float* mrow[G];   // this row's mask at column 0, or null
    int qpos[G];            // this row's query position
#pragma unroll
    for (int h = 0; h < G; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.f;
      mrow[h] = nullptr;
      qpos[h] = 0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[h][e] = acc[h][e] = 0.f;
      if (h < gc) {
        const int j = r0 + h;
        const int r = j % p.Lq;
        const int qh = kvh * g + j / p.Lq;
        qpos[h] = r;
        if (has)
          unpack4(__ldg(reinterpret_cast<const uint4*>(
                      static_cast<const T*>(p.q) + b * p.q_sb + r * p.q_sl +
                      qh * p.q_sh + gl * VEC)),
                  qr[h]);
        if (p.mask != nullptr)
          mrow[h] = p.mask + b * p.m_sb + qh * p.m_sh + r * p.m_sr;
      }
    }

#pragma unroll
    for (int it = 0; it < STAGES - 1; ++it) issue(it);
    // every lane of the block takes the same number of rounds, so the
    // full-mask shuffles below are safe; a token past the split (or a
    // lane past D) computes on zeros and is left out as not live
    for (int it = 0; it < nrounds; ++it) {
      issue(it + STAGES - 1);
      cp_wait<STAGES - 1>();
      const int st = it % STAGES;
      float kf[U][VEC], vf[U][VEC];
      int tok[U];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = ((st * U + u) * 2) * THREADS + threadIdx.x;
        unpack4(ring[slot], kf[u]);
        unpack4(ring[slot + THREADS], vf[u]);
        tok[u] = t_begin + it * step + u * ngrp + grp;
        live[u] = tok[u] < t_end;
      }
      // what each (row, token) adds to its score: the mask element, or
      // -inf where causal, the window or the split's end hide it.  The
      // mask loads take a clamped (always valid) column and no branch, so
      // they all travel while the dot products below run.
      float add[G][U];
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          bool vis = live[u];
          if (p.causal) {
            vis = vis && tok[u] <= qpos[h] + off;
            if (p.window) vis = vis && tok[u] > qpos[h] + off - p.window;
          }
          add[h][u] = 0.f;
          if (mrow[h] != nullptr)
            add[h][u] = __ldg(mrow[h] + min(tok[u], t_end - 1));
          if (!vis) add[h][u] = -INFINITY;
        }
      // q.k of every (row, token), then the group's xor reduction, all
      // G * U sums side by side
      float s[G][U];
#pragma unroll
      for (int h = 0; h < G; ++h)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[h][u] = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            s[h][u] = fmaf(qr[h][e], kf[u][e], s[h][u]);
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        if (o < lpt) {   // uniform across the block
#pragma unroll
          for (int h = 0; h < G; ++h)
#pragma unroll
            for (int u = 0; u < U; ++u)
              s[h][u] += __shfl_xor_sync(0xffffffffu, s[h][u], o);
        }
      }
      // the online softmax, branch free: while a row has seen nothing its
      // maximum stays -inf and the exponents run against 0, so p, corr,
      // l and acc stay 0 and no -inf - -inf arises
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float mn = m[h];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[h][u] = fmaf(s[h][u], p.scale, add[h][u]);
          mn = fmaxf(mn, s[h][u]);
        }
        const float ms = mn == -INFINITY ? 0.f : mn;
        const float corr = expf(m[h] - ms);
        l[h] *= corr;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][e] *= corr;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float pe = expf(s[h][u] - ms);   // 0 where hidden
          l[h] += pe;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[h][e] = fmaf(pe, vf[u][e], acc[h][e]);
        }
        m[h] = mn;
      }
    }
    cp_wait<0>();
    __syncthreads();   // every lane is done with the ring: reuse it

#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h < gc) {
        if (gl == 0) {
          sm_m[grp * G + h] = m[h];
          sm_l[grp * G + h] = l[h];
        }
        if (has) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            sm_acc[(grp * G + h) * p.D + gl * VEC + e] = acc[h][e];
        }
      }
    }
    __syncthreads();

    // merge the groups' states; a group that saw nothing has m = -inf and
    // weight 0, and a row that saw nothing writes the empty state
    for (int idx = threadIdx.x; idx < gc * p.D; idx += THREADS) {
      const int h = idx / p.D;
      const int d = idx - h * p.D;
      float mx = -INFINITY;
      for (int s = 0; s < ngrp; ++s) mx = fmaxf(mx, sm_m[s * G + h]);
      float num = 0.f, den = 0.f;
      if (mx != -INFINITY) {
        for (int s = 0; s < ngrp; ++s) {
          const float w = expf(sm_m[s * G + h] - mx);
          num = fmaf(sm_acc[(s * G + h) * p.D + d], w, num);
          den = fmaf(sm_l[s * G + h], w, den);
        }
      }
      const int j = r0 + h;
      const int r = j % p.Lq;
      const int qh = kvh * g + j / p.Lq;
      const int64_t row = ((int64_t)b * p.H + qh) * p.Lq + r;
      if (splits == 1) {
        T* og = static_cast<T*>(p.out);
        og[b * p.o_sb + r * p.o_sl + qh * p.o_sh + d] =
            from_float<T>(mx != -INFINITY ? num / den : 0.f);
        if (d == 0)
          p.lse_out[row] = mx != -INFINITY ? mx + logf(den) : -INFINITY;
      } else {
        const int64_t at = row * splits + split;
        part_acc[at * p.D + d] = num;
        if (d == 0) {
          part_ml[2 * at] = mx;
          part_ml[2 * at + 1] = den;
        }
      }
    }
    __syncthreads();   // the next rows' ring reuses the states' memory
  }
}

// ------------------------------------------------- bfloat16 / float16: mma
// two 16-bit elements packed in one register, x in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x, float y) {
  __half2 v = __floats2half2_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (m16 x n8, float32) += a (m16 x k16) * b (k16 x n8): the mma.sync
// fragments (with g = lane / 4, t = lane % 4: c holds (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1); a holds rows g and g + 8 at k 2t, 2t + 1
// and 2t + 8, 2t + 9; b holds k 2t, 2t + 1 and 2t + 8, 2t + 9 at n g)
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// four 8 x 8 matrices of 16-bit elements from shared memory; lane l gives
// the address of row l % 8 of matrix l / 8.  Plain: lane (g, t) receives
// row g, columns 2t and 2t + 1 of each; trans: rows 2t and 2t + 1, column g
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

constexpr int TK = 64;   // keys of a tile, 16 a warp

// the same computation on the tensor cores, for bfloat16 / float16: a
// chunk of 16 query rows (the g * Lq rows of the kv head, zero-padded) is
// the A operand of mma.sync m16n8k16; each warp takes 16 keys of every
// 64-key tile, whose K and V arrive in shared memory by cp.async (a ring
// of nst stages, 2 when a split has more than one tile); S = Q K^T (K by
// ldmatrix), the online softmax on the accumulator fragments in float32,
// p rounded to T as the A operand of O += P V (V by ldmatrix.trans).  The
// four warps' states merge through shared memory at the end of a chunk.
// DT: D rounded up to 64 or 128 (columns past D are zero).  3 blocks an
// SM (at most 168 registers a thread): Mistral's decode shape, 288 blocks,
// then runs in one wave on 132 SMs, where 2 blocks an SM measured slower.
template <typename T, int DT>
__global__ void __launch_bounds__(THREADS, 3)
    flash_decode_mma_kernel(const FlashParams p, float* __restrict__ part_acc,
                            float* __restrict__ part_ml, int split_keys,
                            int nst) {
  constexpr int LD = DT + 8;    // smem row stride: ldmatrix conflict-free
  constexpr int CPR = DT / 8;   // 16-byte chunks of a row
  constexpr int NT = DT / 8;    // n-tiles of O
  constexpr int KS = DT / 16;   // k-steps of S
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t smem_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // stage st: K tile [TK][LD] at sK(st), V tile after it
  auto sK = [&](int st) { return smem_s + st * 2 * TK * LD * 2; };
  float* so = reinterpret_cast<float*>(smem);   // [4][16][DT], after a chunk
  float* sm_m = so + 4 * 16 * DT;               // [4][16]
  float* sm_l = sm_m + 4 * 16;                  // [4][16]

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int g = p.H / p.Hkv;
  const int rows = g * p.Lq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int off = p.Lk - p.Lq;
  const int t_begin = split * split_keys;
  const int t_end = min(p.Lk, t_begin + split_keys);
  const int ntiles = t_end > t_begin ? (t_end - t_begin + TK - 1) / TK : 0;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // tile `it` of the split into stage it % nst, by every thread
  auto load = [&](int it) {
    const int st = it % nst;
    const int t0 = t_begin + it * TK;
    for (int i = threadIdx.x; i < TK * CPR; i += THREADS) {
      const int r = i / CPR, c = (i - r * CPR) * 8;
      const int t = t0 + r;
      const bool ok = t < t_end && c < p.D;
      const uint32_t dk = sK(st) + (r * LD + c) * 2;
      cp_async16(dk, ok ? kg + t * p.k_sl + c : p.k, ok ? 16 : 0);
      cp_async16(dk + TK * LD * 2, ok ? vg + t * p.v_sl + c : p.v,
                 ok ? 16 : 0);
    }
    cp_commit();
  };

  for (int r0 = 0; r0 < rows; r0 += 16) {
    // this lane's two rows of the chunk: gq and gq + 8
    int qpos[2];
    bool valid[2];
    const float* mrow[2];
    uint32_t qa[KS][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = r0 + gq + 8 * i;
      valid[i] = j < rows;
      const int r = valid[i] ? j % p.Lq : 0;
      const int qh = kvh * g + (valid[i] ? j / p.Lq : 0);
      qpos[i] = r;
      mrow[i] = p.mask == nullptr || !valid[i]
                    ? nullptr
                    : p.mask + b * p.m_sb + qh * p.m_sh + r * p.m_sr;
      const T* qrow = static_cast<const T*>(p.q) + b * p.q_sb + r * p.q_sl +
                      qh * p.q_sh;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const int col = kk * 16 + 2 * tq + 8 * hlf;
          qa[kk][i + 2 * hlf] =
              valid[i] && col < p.D
                  ? *reinterpret_cast<const uint32_t*>(qrow + col)
                  : 0u;
        }
    }
    float o[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    if (ntiles > 0) load(0);
    for (int it = 0; it < ntiles; ++it) {
      const int k0 = t_begin + it * TK + warp * 16;   // this warp's keys
      // the mask elements of this lane's scores, loaded (clamped, no
      // branch) before the wait for the tile, so that they travel with it
      float add[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = k0 + nt * 8 + 2 * tq + (e & 1);
          add[nt][e] = mrow[i] != nullptr
                           ? __ldg(mrow[i] + min(col, t_end - 1))
                           : 0.f;
          bool vis = col < t_end;
          if (p.causal) {
            vis = vis && col <= qpos[i] + off;
            if (p.window) vis = vis && col > qpos[i] + off - p.window;
          }
          if (!vis) add[nt][e] = -INFINITY;
        }
      if (it + 1 < ntiles) {
        load(it + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();   // tile it has landed for every thread's copies
      const uint32_t kt = sK(it % nst), vt = kt + TK * LD * 2;
      // S = Q K^T over this warp's 16 keys: two n-tiles of 8
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb[4];   // (keys 0-7, k lo), (0-7, hi), (8-15, lo), (8-15, hi)
        const int mat = lane >> 3;
        ldsm4(kb, kt + ((warp * 16 + (mat >> 1) * 8 + (lane & 7)) * LD +
                        kk * 16 + (mat & 1) * 8) * 2);
        Mma<T>::run(sc[0], qa[kk], kb[0], kb[1]);
        Mma<T>::run(sc[1], qa[kk], kb[2], kb[3]);
      }
      // online softmax on rows gq (elements 0, 1) and gq + 8 (2, 3); a row
      // that has seen nothing keeps m = -inf and runs against 0
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = fmaf(sc[nt][e], p.scale, add[nt][e]);
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
        }
      float ms[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        ms[i] = mx[i] == -INFINITY ? 0.f : mx[i];
        const float corr = expf(m[i] - ms[i]);
        l[i] *= corr;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          o[nt][2 * i] *= corr;
          o[nt][2 * i + 1] *= corr;
        }
        m[i] = mx[i];
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = expf(sc[nt][e] - ms[e >> 1]);   // 0 where hidden
          l[e >> 1] += sc[nt][e];
        }
      // P (16 rows x this warp's 16 keys) as the A operand, rounded to T
      const uint32_t pa[4] = {pack2<T>(sc[0][0], sc[0][1]),
                              pack2<T>(sc[0][2], sc[0][3]),
                              pack2<T>(sc[1][0], sc[1][1]),
                              pack2<T>(sc[1][2], sc[1][3])};
      // O += P V: V [keys, d] by ldmatrix.trans, two n-tiles a load
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t vb[4];   // (keys 0-7, d nt), (8-15, nt), (0-7, nt+1), (8-15, nt+1)
        const int mat = lane >> 3;
        ldsm4_t(vb, vt + ((warp * 16 + (mat & 1) * 8 + (lane & 7)) * LD +
                          (nt + (mat >> 1)) * 8) * 2);
        Mma<T>::run(o[nt], pa, vb[0], vb[1]);
        Mma<T>::run(o[nt + 1], pa, vb[2], vb[3]);
      }
      __syncthreads();   // every warp is done with the stage
    }
    cp_wait<0>();
    __syncthreads();   // the ring is free: the states take its memory

    // this warp's state: l summed over the quad, then everything to smem
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int row = gq + 8 * i;
      if (tq == 0) {
        sm_m[warp * 16 + row] = m[i];
        sm_l[warp * 16 + row] = l[i];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        so[(warp * 16 + row) * DT + nt * 8 + 2 * tq] = o[nt][2 * i];
        so[(warp * 16 + row) * DT + nt * 8 + 2 * tq + 1] = o[nt][2 * i + 1];
      }
    }
    __syncthreads();

    // merge the four warps' states; a row that saw nothing writes the
    // empty state
    const int nrow = min(16, rows - r0);
    for (int idx = threadIdx.x; idx < nrow * DT; idx += THREADS) {
      const int row = idx / DT, d = idx - row * DT;
      if (d >= p.D) continue;
      float mw[4], mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        mw[w] = sm_m[w * 16 + row];
        mx = fmaxf(mx, mw[w]);
      }
      float num = 0.f, den = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float wt = expf(mw[w] - mx);
          num = fmaf(so[(w * 16 + row) * DT + d], wt, num);
          den = fmaf(sm_l[w * 16 + row], wt, den);
        }
      }
      const int j = r0 + row;
      const int r = j % p.Lq;
      const int qh = kvh * g + j / p.Lq;
      const int64_t orow = ((int64_t)b * p.H + qh) * p.Lq + r;
      if (splits == 1) {
        T* og = static_cast<T*>(p.out);
        og[b * p.o_sb + r * p.o_sl + qh * p.o_sh + d] =
            from_float<T>(mx != -INFINITY ? num / den : 0.f);
        if (d == 0)
          p.lse_out[orow] = mx != -INFINITY ? mx + logf(den) : -INFINITY;
      } else {
        const int64_t at = orow * splits + split;
        part_acc[at * p.D + d] = num;
        if (d == 0) {
          part_ml[2 * at] = mx;
          part_ml[2 * at + 1] = den;
        }
      }
    }
    __syncthreads();   // the next chunk's tiles reuse the states' memory
  }
}

// one block per output row (b, query head, query position), a thread per
// element of D: merges the splits' partial states by their maxima, eight
// splits at a time (their loads issued together, the running sums
// rescaled when the maximum grows).  Every thread walks the splits' (m, l)
// itself (the same addresses across the block), so the merge needs no
// shared memory and no barrier; an empty split (m = -inf) gets weight 0
// and adds its zero partials.
static_assert(THREADS >= 128, "the merge takes a thread per element of D");

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_decode_merge_kernel(const FlashParams p,
                              const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml,
                              int splits) {
  const int64_t row = blockIdx.x;
  const int d = threadIdx.x;
  const int r = (int)(row % p.Lq);
  const int qh = (int)((row / p.Lq) % p.H);
  const int b = (int)(row / ((int64_t)p.Lq * p.H));
  const float* ml = part_ml + row * splits * 2;
  const float* pa = part_acc + row * splits * p.D + min(d, p.D - 1);
  float mx = -INFINITY, num = 0.f, den = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 8) {
    float mv[8], lv[8], av[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = min(s0 + i, splits - 1);
      const bool ok = s0 + i < splits;
      mv[i] = ok ? ml[2 * s] : -INFINITY;
      lv[i] = ml[2 * s + 1];
      av[i] = pa[(int64_t)s * p.D];
    }
    float mn = mx;
#pragma unroll
    for (int i = 0; i < 8; ++i) mn = fmaxf(mn, mv[i]);
    if (mn != -INFINITY) {
      const float corr = expf(mx - mn);   // 0 while mx is -inf
      num *= corr;
      den *= corr;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float w = expf(mv[i] - mn);   // 0 for an empty split
        num = fmaf(av[i], w, num);
        den = fmaf(lv[i], w, den);
      }
      mx = mn;
    }
  }
  if (d < p.D) {
    T* og = static_cast<T*>(p.out) + b * p.o_sb + r * p.o_sl + qh * p.o_sh;
    og[d] = from_float<T>(mx != -INFINITY ? num / den : 0.f);
  }
  if (d == 0) p.lse_out[row] = mx != -INFINITY ? mx + logf(den) : -INFINITY;
}

// the merge of the splits' partials, when there is more than one split
template <typename T>
cudaError_t merge(const FlashParams& p, float* part_acc, float* part_ml,
                  int splits, cudaStream_t st) {
  const int64_t rows = (int64_t)p.B * p.H * p.Lq;
  flash_decode_merge_kernel<T><<<(unsigned)rows, THREADS, 0, st>>>(
      p, part_acc, part_ml, splits);
  return cudaGetLastError();
}

// float32, on the CUDA cores: G query rows in registers at once
template <int G>
cudaError_t launch_cores(const FlashParams& p, float* part_acc,
                         float* part_ml, int splits, int split_keys,
                         cudaStream_t st) {
  constexpr int VEC = 4;
  const int nv = p.D / VEC;
  int lpt = 1;
  while (lpt < nv) lpt <<= 1;   // nv <= 32: D <= 128
  const int ngrp = THREADS / lpt;
  // the ring, or the groups' states after it (ngrp * D <= THREADS * VEC,
  // so both stay under 48 KB and need no opt-in attribute)
  const size_t ring = (size_t)STAGES * U * 2 * THREADS * 16;
  const size_t states = sizeof(float) * (size_t)ngrp * G * (2 + p.D);
  const size_t smem = ring > states ? ring : states;
  const dim3 grid(p.Hkv, p.B, splits);
  flash_decode_kernel<G><<<grid, THREADS, smem, st>>>(
      p, part_acc, part_ml, split_keys, lpt);
  return cudaGetLastError();
}

// cudaFuncSetAttribute once per kernel and device, not on every launch
cudaError_t smem_once(std::atomic<uint64_t>& done, int device,
                      const void* kernel, int bytes) {
  const uint64_t bit = 1ull << (device & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// bfloat16 / float16, on the tensor cores
template <typename T, int DT>
cudaError_t launch_mma(const FlashParams& p, float* part_acc, float* part_ml,
                       int splits, int split_keys, int device,
                       cudaStream_t st) {
  constexpr int LD = DT + 8;
  constexpr int STAGE_BYTES = 2 * TK * LD * 2;
  constexpr int STATE_BYTES = sizeof(float) * 4 * 16 * (DT + 2);
  // two stages when a split has more than one tile (over 48 KB at D 128:
  // the attribute is set once), else one
  const int nst = split_keys > TK ? 2 : 1;
  const int smem = nst * STAGE_BYTES > STATE_BYTES ? nst * STAGE_BYTES
                                                   : STATE_BYTES;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = smem_once(
      done, device,
      reinterpret_cast<const void*>(flash_decode_mma_kernel<T, DT>),
      2 * STAGE_BYTES > STATE_BYTES ? 2 * STAGE_BYTES : STATE_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hkv, p.B, splits);
  flash_decode_mma_kernel<T, DT><<<grid, THREADS, smem, st>>>(
      p, part_acc, part_ml, split_keys, nst);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const FlashParams& p, float* part, int splits,
                   int split_keys, int device, cudaStream_t st) {
  const int64_t rows = (int64_t)p.B * p.H * p.Lq;
  float* part_acc = part;
  float* part_ml = part == nullptr ? nullptr : part + rows * splits * p.D;
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    const int g_rows = (p.H / p.Hkv) * p.Lq;
    err = g_rows == 1   ? launch_cores<1>(p, part_acc, part_ml, splits,
                                          split_keys, st)
          : g_rows == 2 ? launch_cores<2>(p, part_acc, part_ml, splits,
                                          split_keys, st)
          : g_rows <= 4 ? launch_cores<4>(p, part_acc, part_ml, splits,
                                          split_keys, st)
                        : launch_cores<8>(p, part_acc, part_ml, splits,
                                          split_keys, st);
  } else {
    err = p.D <= 64 ? launch_mma<T, 64>(p, part_acc, part_ml, splits,
                                        split_keys, device, st)
                    : launch_mma<T, 128>(p, part_acc, part_ml, splits,
                                         split_keys, device, st);
  }
  if (err != cudaSuccess || splits == 1) return err;
  return merge<T>(p, part_acc, part_ml, splits, st);
}

// 16-byte aligned base and (batch, row, head) strides in elements that
// keep every row 16-byte aligned (0 for a broadcast dimension)
bool operand_ok(const void* x, int64_t sb, int64_t sl, int64_t sh, int vec) {
  return x != nullptr && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         sb % vec == 0 && sl % vec == 0 && sh % vec == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  splits blocks of split_keys
// keys each along Lk (the last may be shorter; none starts past Lk); with
// splits > 1, part holds B * H * Lq * splits * (D + 2) floats, which the
// kernel overwrites (no zeroing needed).  Returns a cudaError_t code:
// cudaErrorInvalidValue for what the kernel does not take, else the result
// of cudaGetLastError() right after the last launch.
extern "C" int flash_decode_fwd(const FlashParams* p, void* part, int splits,
                                int split_keys, int dtype, int device,
                                void* stream) {
  if (p == nullptr || dtype < 0 || dtype > 2) return (int)cudaErrorInvalidValue;
  const int vec = dtype == 0 ? 4 : 8;
  if (p->B < 1 || p->B > 65535 || p->Hkv < 1 || p->Hkv > 65535 ||
      p->H < p->Hkv || p->H % p->Hkv || p->Lq < 1 || p->Lk < 1 ||
      p->D < 8 || p->D > 128 || p->D % 8 || p->window < 0 || splits < 1 ||
      splits > 65535 || split_keys < 1 ||
      (int64_t)splits * split_keys < p->Lk ||
      (int64_t)(splits - 1) * split_keys >= p->Lk ||
      (splits > 1 && part == nullptr) || p->out == nullptr ||
      p->lse_out == nullptr ||
      !operand_ok(p->q, p->q_sb, p->q_sl, p->q_sh, vec) ||
      !operand_ok(p->k, p->k_sb, p->k_sl, p->k_sh, vec) ||
      !operand_ok(p->v, p->v_sb, p->v_sl, p->v_sh, vec))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  if (dtype == 0)
    return (int)launch<float>(*p, pp, splits, split_keys, device, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(*p, pp, splits, split_keys, device,
                                      st);
  return (int)launch<__half>(*p, pp, splits, split_keys, device, st);
}

extern "C" int flash_decode_params_size() { return sizeof(FlashParams); }

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
