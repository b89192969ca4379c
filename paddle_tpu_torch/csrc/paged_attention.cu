// Paged decode attention for Hopper (sm_90a): one query token per row
// attends its whole context through a block table into the paged KV pool.
//
// Replaces the Pallas TPU kernel
//   paddle_tpu/ops/pallas/paged_attention.py::_decode_kernel (:41)
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
// Design ("flash-decoding"): each row's context is cut into partitions of
// split_tokens tokens (a multiple of bs; 512 tokens, 32 blocks of 16, by
// measurement on the card: PERF.md), and the grid is (Hkv, B, splits) with
// splits = ceil(M * bs / split_tokens) from the table's width, which the
// host knows, never from lens, which lives on the card.  One thread block of
// 4 warps per (kv head, row, partition) covers the g = H / Hkv query heads
// of that kv head, so each K/V row is read from memory once per group.
// Inside the block a "token group" of lpt lanes (the smallest power of two
// that covers D in 16-byte vectors) takes U tokens a round (8 for a GQA
// group of 1 or 2, 4 for 4, 2 for 8; half that for float32 above D 128):
// their block ids are loaded a round ahead and each lane loads 16 bytes of K
// and of V of every one before it uses the first, so 2 U loads a lane are in
// flight and a round waits on one memory latency; the group reduces the q.k
// dot products with xor shuffles, and every group keeps its own online
// softmax state (m, l, acc) in registers, rescaled once a round.  At the end
// the groups' states are merged through shared memory.  Query heads beyond 8
// per kv head are taken in chunks of 8, re-reading K/V once per chunk.
//
// With one split the block writes out directly and touches no workspace.
// With more, each block writes its partial state (acc[D], m, l per query
// head) to a float32 workspace; a block whose partition starts at or past
// the row's length writes only an empty state (m = -inf) and reads no K/V.
// The last block of a (row, kv head) to arrive merges the partial states
// by their maxima and writes out, in the same launch: every block fences
// its writes (__threadfence) and adds one to an int32 arrival counter of
// the (row, kv head); the block that finds splits - 1 there is last, reads
// the partials from L2 and resets the counter to 0 for the next launch.
// The wrapper allocates the workspace and zeroed counters once per device
// (growing them when a call needs more), so a call adds no memset and no
// second launch.  Launches that share a workspace must run in stream order.
//
// Bound: memory.  A call must read sum(lens) * Hkv * D elements of K and
// as many of V; the arithmetic is 4 flops per element read times the GQA
// group, far below the card's ~295 flops/byte balance point.  Splitting
// bounds each block's walk by the partition: at the 1.3B serving shape
// one block per (row, kv head) gives 256 blocks, the longest of which
// walks 1,056 tokens while the blocks of short rows have long finished;
// partitions of 512 tokens give 768 blocks there, the longest walking 512.
// Smaller partitions measured slower: each block pays a fixed prologue
// and merge (PERF.md).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 4 warps a block: at the ~128 registers a thread that U tokens in flight
// take, 4 blocks fit on an SM, so one block's prologue and merge overlap
// the others' loads
constexpr int THREADS = 128;

template <typename T>
struct Io;

// unpack16: the VEC = 16 / sizeof(T) elements of a 16-byte vector as floats
template <>
struct Io<float> {
  static __device__ __forceinline__ void unpack16(const uint4& v, float* o) {
    o[0] = __uint_as_float(v.x);
    o[1] = __uint_as_float(v.y);
    o[2] = __uint_as_float(v.z);
    o[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ float to_float(float x) { return x; }
  static __device__ __forceinline__ float from_float(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void unpack16(const uint4& v, float* o) {
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
  static __device__ __forceinline__ void unpack16(const uint4& v, float* o) {
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

// the block ids of tokens t, t + step, .. (U of them), -1 for a token at
// or past t_end
template <int U>
__device__ __forceinline__ void block_ids(int (&blk)[U],
                                          const int* __restrict__ table, int t,
                                          int step, int t_end, int bs) {
#pragma unroll
  for (int u = 0; u < U; ++u, t += step)
    blk[u] = t < t_end ? __ldg(table + t / bs) : -1;
}

// G: query heads held in registers at once (a chunk of the GQA group).
// VPL: 16-byte vectors of a K/V row per lane (2 only for float32, D > 128).
// part: the partial states, acc [B, H, splits, D] then (m, l) [B, H,
// splits, 2]; arrivals [B, Hkv]; both unused with one split.
template <typename T, int G, int VPL>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lens, T* __restrict__ out, float* part,
    int* arrivals, int H, int Hkv, int D, int bs, int M, int lpt,
    int split_tokens, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int EPL = VEC * VPL;
  // tokens a group has in flight: as many as registers allow
  constexpr int U = (G <= 2 ? 8 : G == 4 ? 4 : 2) / VPL;
  extern __shared__ float smem[];
  __shared__ bool last;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int g = H / Hkv;
  const int nv = D / VEC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tpw = 32 / lpt;                 // token groups per warp
  const int ngrp = (blockDim.x >> 5) * tpw;  // token groups per block
  const int gl = lane % lpt;                // lane within its group
  const int grp = warp * tpw + lane / lpt;  // this lane's group
  const int len = max(0, min(lens[b], M * bs));
  const int t_begin = split * split_tokens;
  const int t_end = min(len, t_begin + split_tokens);
  const int* table = tables + (int64_t)b * M;
  const int64_t tok_stride = (int64_t)Hkv * D;
  // (m, l) of the partial states, after their acc
  float* part_ml =
      splits > 1 ? part + (int64_t)gridDim.y * H * splits * D : nullptr;

  float* sm_m = smem;               // [ngrp][G]
  float* sm_l = sm_m + ngrp * G;    // [ngrp][G]
  float* sm_acc = sm_l + ngrp * G;  // [ngrp][G][D]

  if (splits > 1 && t_begin >= len) {
    // nothing of this row in the partition: an empty state, no K/V read
    for (int h = threadIdx.x; h < g; h += blockDim.x) {
      const int64_t at = ((int64_t)b * H + kvh * g + h) * splits + split;
      part_ml[2 * at] = -INFINITY;
      part_ml[2 * at + 1] = 0.f;
    }
  } else {
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

      // A group takes U tokens a round, ngrp apart.  Their block ids are
      // loaded a round ahead, and all their K and V vectors before the
      // first is used, so each lane keeps 2 U 16-byte loads in flight and
      // a round waits on one memory latency.  The loop bound is uniform
      // across the warp (every lane steps through the same t0 values), so
      // the full-mask shuffles below are safe; a token past the partition
      // (block id -1) computes on zeros and leaves the state unchanged.
      int t0 = t_begin + warp * tpw;
      int blk[U];
      block_ids<U>(blk, table, t0 + lane / lpt, ngrp, t_end, bs);
      for (; t0 < t_end; t0 += U * ngrp) {
        uint4 kr[U][VPL], vr[U][VPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = t0 + u * ngrp + lane / lpt;
          const int64_t row =
              ((int64_t)blk[u] * bs + t % bs) * tok_stride + (int64_t)kvh * D;
#pragma unroll
          for (int r = 0; r < VPL; ++r) {
            const int j = gl + r * lpt;
            kr[u][r] = vr[u][r] = make_uint4(0u, 0u, 0u, 0u);
            if (blk[u] >= 0 && j < nv) {
              kr[u][r] =
                  __ldg(reinterpret_cast<const uint4*>(k_pool + row + j * VEC));
              vr[u][r] =
                  __ldg(reinterpret_cast<const uint4*>(v_pool + row + j * VEC));
            }
          }
        }
        int live[U];
#pragma unroll
        for (int u = 0; u < U; ++u) live[u] = blk[u] >= 0;
        block_ids<U>(blk, table, t0 + U * ngrp + lane / lpt, ngrp, t_end, bs);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (h < gc) {
            float s[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              float kf[EPL];
#pragma unroll
              for (int r = 0; r < VPL; ++r)
                Io<T>::unpack16(kr[u][r], kf + r * VEC);
              s[u] = 0.f;
#pragma unroll
              for (int e = 0; e < EPL; ++e) s[u] = fmaf(qr[h][e], kf[e], s[u]);
            }
            for (int off = lpt >> 1; off > 0; off >>= 1)
#pragma unroll
              for (int u = 0; u < U; ++u)
                s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
            if (live[0]) {   // the group has a token this round
              float mn = m[h];
#pragma unroll
              for (int u = 0; u < U; ++u) {
                s[u] *= scale;
                if (live[u]) mn = fmaxf(mn, s[u]);
              }
              const float corr = expf(m[h] - mn);  // 0 on the first token
              l[h] *= corr;
#pragma unroll
              for (int e = 0; e < EPL; ++e) acc[h][e] *= corr;
#pragma unroll
              for (int u = 0; u < U; ++u) {
                if (!live[u]) continue;
                const float p = expf(s[u] - mn);
                float vf[EPL];
#pragma unroll
                for (int r = 0; r < VPL; ++r)
                  Io<T>::unpack16(vr[u][r], vf + r * VEC);
                l[h] += p;
#pragma unroll
                for (int e = 0; e < EPL; ++e)
                  acc[h][e] = fmaf(p, vf[e], acc[h][e]);
              }
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

      // merge the groups' (m, l, acc) states; a group that saw no token
      // has m = -inf and weight 0, and a row with no token at all writes 0
      for (int idx = threadIdx.x; idx < gc * D; idx += blockDim.x) {
        const int h = idx / D;
        const int d = idx - h * D;
        float mx = -INFINITY;
        for (int s = 0; s < ngrp; ++s) mx = fmaxf(mx, sm_m[s * G + h]);
        float num = 0.f, den = 0.f;
        if (mx != -INFINITY) {
          for (int s = 0; s < ngrp; ++s) {
            const float w = expf(sm_m[s * G + h] - mx);
            num = fmaf(sm_acc[(s * G + h) * D + d], w, num);
            den = fmaf(sm_l[s * G + h], w, den);
          }
        }
        if (splits == 1) {
          out[((int64_t)b * H + qh0 + h) * D + d] =
              Io<T>::from_float(mx != -INFINITY ? num / den : 0.f);
        } else {
          const int64_t at = ((int64_t)b * H + qh0 + h) * splits + split;
          part[at * D + d] = num;
          if (d == 0) {
            part_ml[2 * at] = mx;
            part_ml[2 * at + 1] = den;
          }
        }
      }
      __syncthreads();
    }
  }
  if (splits == 1) return;

  // arrive; the last block of this (row, kv head) merges the splits
  __threadfence();
  __syncthreads();
  int* counter = arrivals + (int64_t)b * Hkv + kvh;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < g * D; idx += blockDim.x) {
    const int h = idx / D;
    const int d = idx - h * D;
    const int64_t at = ((int64_t)b * H + kvh * g + h) * splits;
    float mx = -INFINITY;
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, __ldcg(part_ml + 2 * (at + s)));
    float num = 0.f, den = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < splits; ++s) {
        const float ms = __ldcg(part_ml + 2 * (at + s));
        if (ms == -INFINITY) continue;    // an empty split: acc unwritten
        const float w = expf(ms - mx);
        num = fmaf(__ldcg(part + (at + s) * D + d), w, num);
        den = fmaf(__ldcg(part_ml + 2 * (at + s) + 1), w, den);
      }
    }
    out[((int64_t)b * H + kvh * g + h) * D + d] =
        Io<T>::from_float(mx != -INFINITY ? num / den : 0.f);
  }
  if (threadIdx.x == 0) *counter = 0;
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const int *tables, *lens;
  void* out;
  float* part;
  int* arrivals;
  int B, H, Hkv, D, bs, M, splits, split_tokens;
  float scale;
  cudaStream_t stream;
};

template <typename T, int G, int VPL>
cudaError_t launch(const Args& a) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = a.D / VEC;
  int lpt = 1;
  while (lpt < nv && lpt < 32) lpt <<= 1;
  const int ngrp = THREADS / lpt;
  // ngrp * D <= THREADS * VEC, so this stays under 48 KB for every
  // accepted shape and needs no opt-in attribute
  const size_t smem = sizeof(float) * (size_t)ngrp * G * (2 + a.D);
  const dim3 grid(a.Hkv, a.B, a.splits);
  paged_decode_kernel<T, G, VPL><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), a.tables, a.lens,
      static_cast<T*>(a.out), a.part, a.arrivals, a.H, a.Hkv, a.D, a.bs,
      a.M, lpt, a.split_tokens, a.scale);
  return cudaGetLastError();
}

template <typename T, int VPL>
cudaError_t by_group(const Args& a) {
  const int g = a.H / a.Hkv;
  if (g == 1) return launch<T, 1, VPL>(a);
  if (g == 2) return launch<T, 2, VPL>(a);
  if (g <= 4) return launch<T, 4, VPL>(a);
  return launch<T, 8, VPL>(a);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  splits partitions of
// split_tokens tokens each must cover the table (splits * split_tokens >=
// M * bs); with splits > 1, part holds B * H * splits * (D + 2) floats and
// arrivals B * Hkv int32 zeros (the kernel leaves them zero).  Returns a
// cudaError_t code: cudaErrorInvalidValue for shapes the kernel does not
// take, else the result of cudaGetLastError() right after the launch.
extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lens, void* out, void* part,
                                      void* arrivals, int B, int H, int Hkv,
                                      int D, int bs, int M, int splits,
                                      int split_tokens, float scale,
                                      int dtype, int device, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || H < Hkv || H % Hkv || D < 8 ||
      D > 256 || D % 8 || bs < 1 || M < 1 || dtype < 0 || dtype > 2 ||
      splits < 1 || splits > 65535 || split_tokens < 1 ||
      (int64_t)splits * split_tokens < (int64_t)M * bs ||
      (splits > 1 && (part == nullptr || arrivals == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q, k_pool, v_pool, static_cast<const int*>(tables),
               static_cast<const int*>(lens), out, static_cast<float*>(part),
               static_cast<int*>(arrivals), B, H, Hkv, D, bs, M, splits,
               split_tokens, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return (int)(D > 128 ? by_group<float, 2>(a) : by_group<float, 1>(a));
  if (dtype == 1) return (int)by_group<__nv_bfloat16, 1>(a);
  return (int)by_group<__half, 1>(a);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
