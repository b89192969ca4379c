// Paged decode attention for Hopper (sm_90a): one query token per row
// attends its whole context through a block table into the paged KV pool.
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/paged_attention.py::_decode_kernel
// (reached through paged_decode_attention and the paged_attention
// override in paddle_tpu/ops/pallas/__init__.py).
//
// Layouts (all contiguous):
//   q       [B, H, D]            (the [B, 1, H, D] decode query)
//   k_pool  [N, bs, Hkv, D]      v_pool the same
//   tables  [B, M]   int32       pool block ids, position-ordered
//   lens    [B]      int32       visible tokens per row, the one just
//                                written included (pos + 1)
//   out     [B, H, D]            same dtype as q
// Accepts float32, bfloat16 and float16; any bs >= 1; D a multiple of 8
// with 8 <= D <= 256; H a multiple of Hkv (GQA: q head h reads kv head
// h / (H / Hkv)).  Scores, softmax and the P.V sum run in float32.  A row
// of length 0 writes zeros.  Lengths are clamped to [0, M * bs]; block ids
// must lie in [0, N).
//
// Bound: memory.  A call must read sum(lens) * Hkv * D elements of K and
// as many of V; the arithmetic is 4 flops per element read times the GQA
// group, far below the card's ~295 flops/byte balance point.
//
// Design: one thread block per (kv head, row), covering the g = H / Hkv
// query heads of that kv head, so each K/V row is read from memory once
// per group.  Inside the block a "token group" of lpt lanes (the smallest
// power of two that covers D in 16-byte vectors) owns one token at a
// time: each lane loads 16 bytes of K and of V, the group reduces the q.k
// dot products with xor shuffles, and every group keeps its own online
// softmax state (m, l, acc) in registers.  Blocks at or past the length
// are never read.  At the end the groups' states are merged through
// shared memory.  Query heads beyond 8 per kv head are taken in chunks of
// 8, re-reading K/V once per chunk.
//
// Known limit: the grid is B * Hkv blocks, which under-fills the 132 SMs
// of an H100 at small batch (16 x 16 = 256 blocks on the 1.3B serving
// shape, fewer with GQA) and leaves each block one long serial walk over
// its context.  Splitting the context across blocks and merging the
// partial softmax states ("flash-decoding") is the fix, for a later
// change.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load16(const float* p, float* o) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ float to_float(float x) { return x; }
  static __device__ __forceinline__ float from_float(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                                float* o) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

template <>
struct Io<__half> {
  static __device__ __forceinline__ void load16(const __half* p, float* o) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float to_float(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half from_float(float x) {
    return __float2half(x);
  }
};

// G: query heads held in registers at once (a chunk of the GQA group).
// VPL: 16-byte vectors of a K/V row per lane (2 only for float32, D > 128).
template <typename T, int G, int VPL>
__global__ void __launch_bounds__(256) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lens, T* __restrict__ out, int H, int Hkv,
    int D, int bs, int M, int lpt, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int EPL = VEC * VPL;
  extern __shared__ float smem[];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = H / Hkv;
  const int nv = D / VEC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tpw = 32 / lpt;                 // token groups per warp
  const int ngrp = (blockDim.x >> 5) * tpw;  // token groups per block
  const int gl = lane % lpt;                // lane within its group
  const int grp = warp * tpw + lane / lpt;  // this lane's group
  const int len = max(0, min(lens[b], M * bs));
  const int* table = tables + (int64_t)b * M;
  const int64_t tok_stride = (int64_t)Hkv * D;

  float* sm_m = smem;               // [ngrp][G]
  float* sm_l = sm_m + ngrp * G;    // [ngrp][G]
  float* sm_acc = sm_l + ngrp * G;  // [ngrp][G][D]

  for (int h0 = 0; h0 < g; h0 += G) {
    const int gc = min(G, g - h0);
    const int qh0 = kvh * g + h0;
    float qr[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      m[h] = -INFINITY;
      l[h] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        acc[h][e] = 0.f;
        qr[h][e] = 0.f;
      }
      if (h < gc) {
        const T* qp = q + ((int64_t)b * H + qh0 + h) * D;
#pragma unroll
        for (int r = 0; r < VPL; ++r) {
          const int j = gl + r * lpt;
          if (j < nv) {
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              qr[h][r * VEC + i] = Io<T>::to_float(qp[j * VEC + i]);
          }
        }
      }
    }

    // The loop bound is uniform across the warp (every lane steps through
    // the same t0 values), so the full-mask shuffles below are safe; a
    // group whose token is past the length computes on zeros and keeps
    // its state unchanged.
    for (int t0 = warp * tpw; t0 < len; t0 += ngrp) {
      const int t = t0 + lane / lpt;
      const bool live = t < len;
      float kf[EPL], vf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        kf[e] = 0.f;
        vf[e] = 0.f;
      }
      if (live) {
        const int blk = __ldg(table + t / bs);
        const int64_t row =
            ((int64_t)blk * bs + (t % bs)) * tok_stride + (int64_t)kvh * D;
#pragma unroll
        for (int r = 0; r < VPL; ++r) {
          const int j = gl + r * lpt;
          if (j < nv) {
            Io<T>::load16(k_pool + row + j * VEC, kf + r * VEC);
            Io<T>::load16(v_pool + row + j * VEC, vf + r * VEC);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        if (h < gc) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s = fmaf(qr[h][e], kf[e], s);
          for (int off = lpt >> 1; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if (live) {
            s *= scale;
            const float mn = fmaxf(m[h], s);
            const float corr = expf(m[h] - mn);  // 0 on the first token
            const float p = expf(s - mn);
            l[h] = l[h] * corr + p;
#pragma unroll
            for (int e = 0; e < EPL; ++e)
              acc[h][e] = fmaf(acc[h][e], corr, p * vf[e]);
            m[h] = mn;
          }
        }
      }
    }

#pragma unroll
    for (int h = 0; h < G; ++h) {
      if (h < gc) {
        if (gl == 0) {
          sm_m[grp * G + h] = m[h];
          sm_l[grp * G + h] = l[h];
        }
#pragma unroll
        for (int r = 0; r < VPL; ++r) {
          const int j = gl + r * lpt;
          if (j < nv) {
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              sm_acc[(grp * G + h) * D + j * VEC + i] = acc[h][r * VEC + i];
          }
        }
      }
    }
    __syncthreads();

    // merge the groups' (m, l, acc) states; a group that saw no token has
    // m = -inf and weight 0, and a row with no token at all writes 0
    for (int idx = threadIdx.x; idx < gc * D; idx += blockDim.x) {
      const int h = idx / D;
      const int d = idx - h * D;
      float mx = -INFINITY;
      for (int s = 0; s < ngrp; ++s) mx = fmaxf(mx, sm_m[s * G + h]);
      float o = 0.f;
      if (mx != -INFINITY) {
        float num = 0.f, den = 0.f;
        for (int s = 0; s < ngrp; ++s) {
          const float w = expf(sm_m[s * G + h] - mx);
          num = fmaf(sm_acc[(s * G + h) * D + d], w, num);
          den = fmaf(sm_l[s * G + h], w, den);
        }
        o = num / den;
      }
      out[((int64_t)b * H + qh0 + h) * D + d] = Io<T>::from_float(o);
    }
    __syncthreads();
  }
}

template <typename T, int G, int VPL>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* lens, void* out, int B,
                   int H, int Hkv, int D, int bs, int M, float scale,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = D / VEC;
  int lpt = 1;
  while (lpt < nv && lpt < 32) lpt <<= 1;
  const int nwarps = G <= 4 ? 8 : 4;
  const int ngrp = nwarps * (32 / lpt);
  // ngrp * D <= nwarps * 32 * VEC, so this stays under 48 KB for every
  // accepted shape and needs no opt-in attribute
  const size_t smem = sizeof(float) * (size_t)ngrp * G * (2 + D);
  const dim3 grid(Hkv, B);
  paged_decode_kernel<T, G, VPL><<<grid, nwarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lens, static_cast<T*>(out), H,
      Hkv, D, bs, M, lpt, scale);
  return cudaGetLastError();
}

template <typename T, int VPL>
cudaError_t by_group(int g, const void* q, const void* k_pool,
                     const void* v_pool, const int* tables, const int* lens,
                     void* out, int B, int H, int Hkv, int D, int bs, int M,
                     float scale, cudaStream_t stream) {
  if (g == 1)
    return launch<T, 1, VPL>(q, k_pool, v_pool, tables, lens, out, B, H, Hkv,
                             D, bs, M, scale, stream);
  if (g == 2)
    return launch<T, 2, VPL>(q, k_pool, v_pool, tables, lens, out, B, H, Hkv,
                             D, bs, M, scale, stream);
  if (g <= 4)
    return launch<T, 4, VPL>(q, k_pool, v_pool, tables, lens, out, B, H, Hkv,
                             D, bs, M, scale, stream);
  return launch<T, 8, VPL>(q, k_pool, v_pool, tables, lens, out, B, H, Hkv, D,
                           bs, M, scale, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  Returns a cudaError_t code:
// cudaErrorInvalidValue for shapes the kernel does not take, else the
// result of cudaGetLastError() right after the launch.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lens, void* out, int B,
                                      int H, int Hkv, int D, int bs, int M,
                                      float scale, int dtype, int device,
                                      void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || H < Hkv || H % Hkv || D < 8 ||
      D > 256 || D % 8 || bs < 1 || M < 1 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int g = H / Hkv;
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D > 128)
      return (int)by_group<float, 2>(g, q, k_pool, v_pool, tb, ln, out, B, H,
                                     Hkv, D, bs, M, scale, st);
    return (int)by_group<float, 1>(g, q, k_pool, v_pool, tb, ln, out, B, H,
                                   Hkv, D, bs, M, scale, st);
  }
  if (dtype == 1)
    return (int)by_group<__nv_bfloat16, 1>(g, q, k_pool, v_pool, tb, ln, out,
                                           B, H, Hkv, D, bs, M, scale, st);
  return (int)by_group<__half, 1>(g, q, k_pool, v_pool, tb, ln, out, B, H,
                                  Hkv, D, bs, M, scale, st);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
