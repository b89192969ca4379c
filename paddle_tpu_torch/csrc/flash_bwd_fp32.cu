// The float32 flash-attention backward for Hopper (sm_90a), on the CUDA
// cores in exact float32: FMAs, no TF32 and no 3xTF32, on (B, L, H, D)
// tensors.  Two kernels, dK/dV and then dQ, as the TPU backward has them.
//
// Replaces, for float32, the Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py
//   _dkv_kernel (:262, via _bwd, call :397) -> flash_dkv_fp32_kernel
//   _dq_kernel  (:312, via _bwd, call :436) -> flash_dq_fp32_kernel
// with the semantics of flash_attention.cu's backward: p = exp(s - lse)
// with s = q.k * scale (+ the additive mask) and lse taken as 0 where it is
// not finite; dS = p (dP - delta) with dP = dO.v and delta = rowsum(dO * O)
// from the caller; dV = sum P^T dO and dK = scale * sum dS^T Q, over the
// query heads of the kv head's GQA group (no repeat) and every query
// tile; dQ = scale * sum dS K.  Bottom-right causal (row r sees cols c <=
// r + Lk - Lq), a window (with causal) keeping c > r + Lk - Lq - window,
// the additive float32 mask with element (b, h, r, c) at mask[b*m_sb +
// h*m_sh + r*m_sr + c] (none, a key vector with m_sr == 0, or full rows).
// D is a multiple of 8 up to 128; q, k, v and dO are read through (batch,
// row, head) strides with the last dimension contiguous and every row
// 16-byte aligned, so the views of a fused qkv projection need no copy.
//
// Bound: operations.  At ERNIE's shape (B 32, L 128, H 12, D 64,
// non-causal) dK/dV does 4 products of 2 * L * L * D flops a head (3.22
// GFLOP, 0.0481 ms at the 67 TFLOP/s of 132 SMs x 128 FMA lanes) and dQ
// 3 (0.0361 ms); each moves 25-31 MB (0.008-0.009 ms at 3.35 TB/s).  The
// FMAs decide the time, and the shared-memory loads that feed them.
//
// Design (flash_attention.cu's float32 backward loaded 2 + 2 NT scalars
// from shared memory for 4 NT FMAs, ran every element through the
// visibility tests and a global load of the mask, copied each tile
// synchronously between two barriers, and ran 2 blocks of 4 warps an SM
// at D 64; this carries flash_fwd_fp32.cu's design over):
//  * Both kernels run 256 threads: 8 warps in two roles of 4.  A block
//    owns 64 stationary rows (dK/dV: keys of one kv head; dQ: queries of
//    one head) and walks 32-row tiles of the other side.  Thread (tr, tc)
//    of a role's 16 x 8 lanes holds rows tr + 16 i (i < 4) and, of each
//    tile, rows tc + 8 j (j < 4): a 4 x 4 micro-tile.  Role 0 computes S
//    (dK/dV: S^T = K Q^T; dQ: S = Q K^T) and p, role 1 dP (V dO^T; dO V^T)
//    over the same elements, each with the forward's 8 float4 loads for 64
//    FMAs a step of 4 along D; so each warp holds one 4 x 4 tile and one
//    set of accumulators, and the two roles share one code path.
//  * p goes to shared memory in float32 (rows padded to 40); after one
//    barrier role 1 turns it into dS with its dP.  dK/dV: role 0 sums dV
//    += P^T dO over its own rows (a warp reads only its own rows of P),
//    role 1 dK += dS^T Q over its own (written by its own lanes: a
//    __syncwarp), so each thread holds 4 rows x DT / 8 columns of one of
//    dK and dV: 32 floats at DT 64, 64 at DT 128.  dQ: dS overwrites p in
//    place, and after a second barrier both roles sum dQ += dS K, role h
//    over columns [h DT / 2, (h + 1) DT / 2): 16 or 32 floats a thread.
//  * Operand tiles stay row-major as they arrive, rows padded to DT + 4
//    floats: a row's 8 lanes read 8 consecutive rows, or 128 contiguous
//    bytes, and a warp's 4 rows lie 16 bytes apart in the banks: no load
//    conflicts.
//  * The streamed tiles arrive by cp.async (16-byte copies, rows past the
//    length and columns past D zero-filled) in a ring of 2 stages: dK/dV's
//    stage holds Q, dO and the tile's lse and delta slices (4-byte
//    copies), dQ's K, V and, for a key-vector mask (m_sr == 0, the padding
//    mask of ERNIE and BERT), its 32 values.  The stationary tiles go with
//    the first stage; each tile's copy overlaps the previous tile's
//    products.  dK/dV reads a key-vector mask once a tile per thread (4
//    keys, the same for every query tile of a head: L1 hits); a full-row
//    mask is loaded per element (from L2, at clamped addresses) in its
//    own instantiation only.
//  * Only edge tiles test elements: the causal diagonal, the window's
//    edge, and the ragged tail of the streamed side (dQ: keys past Lk;
//    dK/dV: rows past Lq), decided once per tile for the block.  The
//    stationary side's tail needs no test: its rows are zero-filled and
//    never written.  The walk covers only the tiles that see something
//    (dK/dV: from the first query row that sees the block's first key to
//    the last that sees its last key, for every query head of the group;
//    dQ: as the forward).  Under causal masking the longest blocks start
//    first (dQ: q tiles in reverse; dK/dV: key block 0, seen by every
//    query, is already first).
//  * The softmax is recomputed in log2 units: p = exp2f(s * scale * log2e
//    + mask * log2e - lse * log2e), by two FMAs.
//  * Shared memory (floats x 4 bytes), DT 64: dK/dV K, V 34 KB + 2 stages
//    of (Q, dO, lse, delta) 34.5 KB + P, dS 20 KB = 88.5 KB; dQ Q, dO 34
//    KB + 2 stages of (K, V, mask) 34.25 KB + P 10 KB = 78.25 KB: 2 blocks
//    (16 warps) an SM.  DT 128: 152.5 KB and 142.25 KB, 1 block (8 warps).
//    Launch bounds name those blocks an SM: ptxas keeps a thread within
//    128 registers at DT 64 and 255 at DT 128.  ptxas (nvcc 12.9, as
//    chip_smoke.py's build phase records it): dK/dV 128 registers at DT 64
//    and 168 at DT 128, dQ 128 and 160-164; 0 spills in all 12.
//  * Templates on the head-dim tile (64, 128) and the mask mode (none, key
//    vector, full rows); causal, window, lengths and strides are runtime
//    arguments.  No atomics: two launches give equal bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_params.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps: two roles of 4
constexpr int RT = 4;         // stationary rows a thread: tr + 16 i
constexpr int CT = 4;         // rows of a streamed tile a thread: tc + 8 j
constexpr int BR = 16 * RT;   // stationary rows a block
constexpr int BC = 8 * CT;    // rows of a streamed tile
constexpr int LP = BC + 8;    // p / dS row stride
constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int MASK_NONE = 0;
constexpr int MASK_KEYS = 1;  // m_sr == 0: one row of Lk per (batch, head)
constexpr int MASK_FULL = 2;

template <int DT>
struct Geom {
  static constexpr int LD = DT + 4;          // operand row stride (floats)
  static constexpr int ROWS = BR * LD;       // a stationary tile
  static constexpr int TILE = BC * LD;       // a streamed tile
  static constexpr int DKV_STAGE = 2 * TILE + 2 * BC;  // Q, dO, lse, delta
  static constexpr int DQ_STAGE = 2 * TILE + BC;       // K, V, mask
  static constexpr int DKV_SMEM =
      sizeof(float) * (2 * ROWS + STAGES * DKV_STAGE + 2 * BR * LP);
  static constexpr int DQ_SMEM =
      sizeof(float) * (2 * ROWS + STAGES * DQ_STAGE + BR * LP);
  static constexpr int MIN_BLOCKS = DT == 64 ? 2 : 1;
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

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// s[i][j] = A[16 i] . B[8 j] over DT columns: A and B point at the
// thread's first row of each (row stride LD)
template <int DT>
__device__ __forceinline__ void rows_dot(const float* A, const float* B,
                                         float (&s)[RT][CT]) {
  constexpr int LD = Geom<DT>::LD;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DT; d += 4) {
    float4 a[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = ld4(A + 16 * i * LD + d);
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float4 b = ld4(B + 8 * j * LD + d);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
      }
    }
  }
}

// acc[i][n][e] += sum over the BC tile rows k of P[16 i][k] * B[k][32 n +
// e]: P points at the thread's first row of p or dS (row stride LP), B at
// its first column of the tile (row stride LD)
template <int LD, int NN>
__device__ __forceinline__ void rows_times(const float* P, const float* B,
                                           float (&acc)[RT][NN][4]) {
#pragma unroll 2
  for (int k = 0; k < BC; k += 4) {
    float4 pa[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) pa[i] = ld4(P + 16 * i * LP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const float4 bv = ld4(B + (k + kk) * LD + 32 * n);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float pv = at(pa[i], kk);
          acc[i][n][0] = fmaf(pv, bv.x, acc[i][n][0]);
          acc[i][n][1] = fmaf(pv, bv.y, acc[i][n][1]);
          acc[i][n][2] = fmaf(pv, bv.z, acc[i][n][2]);
          acc[i][n][3] = fmaf(pv, bv.w, acc[i][n][3]);
        }
      }
    }
  }
}

// lse in log2 units, 0 where it is not finite
__device__ __forceinline__ float lse2(float l) {
  return isfinite(l) ? l * LOG2E : 0.f;
}

// whether row `row` sees key `col` under causal masking and the window
__device__ __forceinline__ bool sees(const FlashParams& p, int row,
                                     int col) {
  const int off = p.Lk - p.Lq;
  return row + off >= col && (!p.window || col > row + off - p.window);
}

// ------------------------------------------------------------ dK and dV
// grid (ceil(Lk / 64), Hkv, B): a block owns 64 keys of one kv head and
// walks the query tiles of each query head of its group
template <int DT, int MODE>
__global__ void __launch_bounds__(THREADS, Geom<DT>::MIN_BLOCKS)
    flash_dkv_fp32_kernel(const FlashParams p) {
  using G = Geom<DT>;
  constexpr int LD = G::LD, ND = DT / 32;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + G::ROWS;
  float* sRing = sV + G::ROWS;  // STAGES x {Q [BC][LD], dO, lse, delta}
  float* sP = sRing + STAGES * G::DKV_STAGE;
  float* sS = sP + BR * LP;
  const uint32_t s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int k0 = blockIdx.x * BR, hk = blockIdx.y, b = blockIdx.z;
  const int grp = p.H / p.Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int role = warp >> 2;  // 0: S, P, dV; 1: dP, dS, dK
  const int tr = (warp & 3) * 4 + (lane >> 3);  // keys tr + 16 i
  const int tc = lane & 7;  // query rows tc + 8 j; columns 4 tc + 32 n
  const int off = p.Lk - p.Lq;

  // the query tiles that see any key of this block: [qb, qe)
  const int nq = (p.Lq + BC - 1) / BC;
  int qb = 0, qe = nq;
  if (p.causal) {
    const int lo = k0 - off;  // the first row that sees key k0
    qb = lo <= 0 ? 0 : min(nq, lo / BC);
    if (p.window) {  // the last row that sees key k0 + 63
      const int hi = k0 + BR - 2 - off + p.window;
      qe = hi < 0 ? 0 : min(nq, hi / BC + 1);
    }
  }
  const int nqt = max(qe - qb, 0);
  const int n_it = grp * nqt;  // (query head, query tile) pairs

  // tile `it` (head hk * grp + it / nqt, query tile qb + it % nqt) into
  // its stage of the ring
  auto issue = [&](int it) {
    const int h = hk * grp + it / nqt;
    const int q0 = (qb + it % nqt) * BC;
    const uint32_t st =
        s_base + 4 * (2 * G::ROWS + (it % STAGES) * G::DKV_STAGE);
    load_rows<BC, DT>(st,
                      static_cast<const float*>(p.q) + b * p.q_sb +
                          h * p.q_sh,
                      p.q, p.q_sl, q0, p.Lq, p.D);
    load_rows<BC, DT>(st + 4 * G::TILE,
                      static_cast<const float*>(p.dout) + b * p.do_sb +
                          h * p.do_sh,
                      p.dout, p.do_sl, q0, p.Lq, p.D);
    const int x = threadIdx.x;
    if (x < 2 * BC) {  // lse (x < 32), then delta
      const float* src = x < BC ? p.lse : p.delta;
      const int r = q0 + (x & (BC - 1));
      const bool ok = r < p.Lq;
      cp_async4(st + 4 * (2 * G::TILE + x),
                ok ? static_cast<const void*>(
                         src + ((int64_t)b * p.H + h) * p.Lq + r)
                   : src,
                ok ? 4 : 0);
    }
  };

  // K and V with the first stage
  load_rows<BR, DT>(s_base,
                    static_cast<const float*>(p.k) + b * p.k_sb +
                        hk * p.k_sh,
                    p.k, p.k_sl, k0, p.Lk, p.D);
  load_rows<BR, DT>(s_base + 4 * G::ROWS,
                    static_cast<const float*>(p.v) + b * p.v_sb +
                        hk * p.v_sh,
                    p.v, p.v_sl, k0, p.Lk, p.D);
  if (n_it > 0) issue(0);
  cp_commit();

  float acc[RT][ND][4];  // role 0: dV, role 1: dK / scale
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  const float sl2 = p.scale * LOG2E;
  // role 0: S^T = K Q^T, then dV += P^T dO; role 1: dP^T = V dO^T, then
  // dK += dS^T Q
  const float* sA = (role ? sV : sK) + tr * LD;
  const float* sPS = (role ? sS : sP) + tr * LP;

  for (int it = 0; it < n_it; ++it) {
    cp_wait_all();  // tile it landed
    __syncthreads();  // and every warp is done with tile it - 1
    if (it + 1 < n_it) issue(it + 1);
    cp_commit();
    const int h = hk * grp + it / nqt;
    const int q0 = (qb + it % nqt) * BC;
    const float* st = sRing + (it % STAGES) * G::DKV_STAGE;
    const float* sQ = st;
    const float* sO = st + G::TILE;

    float s[RT][CT];
    rows_dot<DT>(sA, (role ? sO : sQ) + tc * LD, s);

    if (role == 0) {
      const float* lse = st + 2 * G::TILE;
      float mv[RT][CT];
      if constexpr (MODE == MASK_KEYS) {
        const float* mg = p.mask + b * p.m_sb + h * p.m_sh;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          mv[i][0] = __ldg(mg + min(k0 + tr + 16 * i, p.Lk - 1));
#pragma unroll
          for (int j = 1; j < CT; ++j) mv[i][j] = mv[i][0];
        }
      } else if constexpr (MODE == MASK_FULL) {
        const float* mg = p.mask + b * p.m_sb + h * p.m_sh;
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j)
            mv[i][j] = __ldg(
                mg + (int64_t)min(q0 + tc + 8 * j, p.Lq - 1) * p.m_sr +
                min(k0 + tr + 16 * i, p.Lk - 1));
      }
      // a tile whose every row sees every key of the block takes no test
      const bool edge =
          q0 + BC > p.Lq ||
          (p.causal && (k0 + BR - 1 > q0 + off ||
                        (p.window && k0 <= q0 + BC - 1 + off - p.window)));
      float l2[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) l2[j] = lse2(lse[tc + 8 * j]);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          float x = fmaf(s[i][j], sl2, -l2[j]);
          if constexpr (MODE != MASK_NONE) x = fmaf(mv[i][j], LOG2E, x);
          if (edge) {
            const int row = q0 + tc + 8 * j;
            const bool keep = row < p.Lq &&
                              (!p.causal || sees(p, row, k0 + tr + 16 * i));
            if (!keep) x = -INFINITY;
          }
          sP[(tr + 16 * i) * LP + tc + 8 * j] = exp2f(x);
        }
    }
    __syncthreads();  // p of the whole tile is in place
    if (role == 1) {
      const float* delta = st + 2 * G::TILE + BC;
      float dl[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) dl[j] = delta[tc + 8 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int at_ = (tr + 16 * i) * LP + tc + 8 * j;
          sS[at_] = sP[at_] * (s[i][j] - dl[j]);
        }
      __syncwarp();  // a warp reads only the dS rows its lanes wrote
    }
    rows_times<LD, ND>(sPS, (role ? sQ : sO) + 4 * tc, acc);
  }
  cp_wait_all();

  float* out = static_cast<float*>(role ? p.dk : p.dv) +
               b * (role ? p.dk_sb : p.dv_sb) +
               hk * (role ? p.dk_sh : p.dv_sh);
  const int64_t sl = role ? p.dk_sl : p.dv_sl;
  const float mul = role ? p.scale : 1.f;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = k0 + tr + 16 * i;
    if (row >= p.Lk) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 4 * tc + 32 * n;
      if (c < p.D)
        *reinterpret_cast<float4*>(out + row * sl + c) =
            make_float4(acc[i][n][0] * mul, acc[i][n][1] * mul,
                        acc[i][n][2] * mul, acc[i][n][3] * mul);
    }
  }
}

// ---------------------------------------------------------------------- dQ
// grid (ceil(Lq / 64), H, B): a block owns 64 query rows of one head and
// walks the key tiles they see
template <int DT, int MODE>
__global__ void __launch_bounds__(THREADS, Geom<DT>::MIN_BLOCKS)
    flash_dq_fp32_kernel(const FlashParams p) {
  using G = Geom<DT>;
  constexpr int LD = G::LD, NH = DT / 64;  // column groups of a role's half
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = sQ + G::ROWS;  // dO
  float* sRing = sO + G::ROWS;  // STAGES x {K [BC][LD], V, mask [BC]}
  float* sP = sRing + STAGES * G::DQ_STAGE;  // p, then dS in place
  const uint32_t s_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int nqb = gridDim.x;
  const int qt = p.causal ? nqb - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BR, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int role = warp >> 2;  // 0: S, P; 1: dP, dS; both: dQ's halves
  const int tr = (warp & 3) * 4 + (lane >> 3);  // rows tr + 16 i
  const int tc = lane & 7;  // keys tc + 8 j; columns 4 tc + 32 n + DT/2 role
  const float* kg =
      static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg =
      static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* mg =
      MODE == MASK_NONE ? nullptr : p.mask + b * p.m_sb + h * p.m_sh;
  const int off = p.Lk - p.Lq;

  // the key tiles any row of this block sees: [kb, ke)
  int kb = 0, ke = (p.Lk + BC - 1) / BC;
  if (p.causal) {
    const int hi = q0 + BR - 1 + off;  // the last key the last row sees
    ke = hi < 0 ? 0 : min(ke, hi / BC + 1);
    if (p.window) {
      const int lo = q0 + off - p.window + 1;  // the first row's first key
      kb = lo <= 0 ? 0 : lo / BC;
    }
  }

  // key tile t into its stage of the ring
  auto issue = [&](int t) {
    const int k0 = t * BC;
    const uint32_t st =
        s_base + 4 * (2 * G::ROWS + ((t - kb) % STAGES) * G::DQ_STAGE);
    load_rows<BC, DT>(st, kg, p.k, p.k_sl, k0, p.Lk, p.D);
    load_rows<BC, DT>(st + 4 * G::TILE, vg, p.v, p.v_sl, k0, p.Lk, p.D);
    if constexpr (MODE == MASK_KEYS) {
      const int x = threadIdx.x;
      if (x < BC) {
        const bool ok = k0 + x < p.Lk;
        cp_async4(st + 4 * (2 * G::TILE + x),
                  ok ? static_cast<const void*>(mg + k0 + x) : p.mask,
                  ok ? 4 : 0);
      }
    }
  };

  // Q and dO with the first stage
  load_rows<BR, DT>(s_base,
                    static_cast<const float*>(p.q) + b * p.q_sb +
                        h * p.q_sh,
                    p.q, p.q_sl, q0, p.Lq, p.D);
  load_rows<BR, DT>(s_base + 4 * G::ROWS,
                    static_cast<const float*>(p.dout) + b * p.do_sb +
                        h * p.do_sh,
                    p.dout, p.do_sl, q0, p.Lq, p.D);
  if (kb < ke) issue(kb);
  cp_commit();

  // this thread's rows' lse (log2 units) and delta
  float l2[RT], dl[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + tr + 16 * i;
    const int64_t at_ = ((int64_t)b * p.H + h) * p.Lq + row;
    l2[i] = row < p.Lq ? lse2(p.lse[at_]) : 0.f;
    dl[i] = row < p.Lq ? p.delta[at_] : 0.f;
  }
  float acc[RT][NH][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  const float sl2 = p.scale * LOG2E;
  // role 0: S = Q K^T; role 1: dP = dO V^T
  const float* sA = (role ? sO : sQ) + tr * LD;
  float* sPr = sP + tr * LP;

  for (int t = kb; t < ke; ++t) {
    cp_wait_all();  // tile t landed
    __syncthreads();  // and every warp is done with tile t - 1
    if (t + 1 < ke) issue(t + 1);
    cp_commit();
    const float* sK = sRing + ((t - kb) % STAGES) * G::DQ_STAGE;
    const float* sV = sK + G::TILE;
    const int k0 = t * BC;

    float s[RT][CT];
    rows_dot<DT>(sA, (role ? sV : sK) + tc * LD, s);

    if (role == 0) {
      float mv[RT][CT];
      if constexpr (MODE == MASK_KEYS) {
        const float* sM = sV + G::TILE;
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
      // a tile wholly visible to every row of the block takes no test
      const bool edge =
          k0 + BC > p.Lk ||
          (p.causal && (k0 + BC - 1 > q0 + off ||
                        (p.window && k0 <= q0 + BR - 1 + off - p.window)));
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          float x = fmaf(s[i][j], sl2, -l2[i]);
          if constexpr (MODE != MASK_NONE) x = fmaf(mv[i][j], LOG2E, x);
          if (edge) {
            const int col = k0 + tc + 8 * j;
            const bool keep = col < p.Lk &&
                              (!p.causal || sees(p, q0 + tr + 16 * i, col));
            if (!keep) x = -INFINITY;
          }
          sPr[16 * i * LP + tc + 8 * j] = exp2f(x);
        }
    }
    __syncthreads();  // p of the whole tile is in place
    if (role == 1) {
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          float* x = sPr + 16 * i * LP + tc + 8 * j;
          *x = *x * (s[i][j] - dl[i]);
        }
    }
    __syncthreads();  // dS of the whole tile is in place
    rows_times<LD, NH>(sPr, sK + 4 * tc + role * (DT / 2), acc);
  }
  cp_wait_all();

  float* og = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= p.Lq) continue;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int c = 4 * tc + 32 * n + role * (DT / 2);
      if (c < p.D)
        *reinterpret_cast<float4*>(og + row * p.dq_sl + c) = make_float4(
            acc[i][n][0] * p.scale, acc[i][n][1] * p.scale,
            acc[i][n][2] * p.scale, acc[i][n][3] * p.scale);
    }
  }
}

template <int DT, int MODE, bool DKV>
cudaError_t launch(const FlashParams& p, int device, cudaStream_t st) {
  using G = Geom<DT>;
  constexpr int smem = DKV ? G::DKV_SMEM : G::DQ_SMEM;
  const void* kernel =
      DKV ? reinterpret_cast<const void*>(flash_dkv_fp32_kernel<DT, MODE>)
          : reinterpret_cast<const void*>(flash_dq_fp32_kernel<DT, MODE>);
  // cudaFuncSetAttribute once per kernel and device, not on every launch
  static std::atomic<uint64_t> done{0};
  const uint64_t bit = 1ull << (device & 63);
  if (!(done.load(std::memory_order_acquire) & bit)) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done.fetch_or(bit, std::memory_order_release);
  }
  if constexpr (DKV) {
    const dim3 grid((p.Lk + BR - 1) / BR, p.Hkv, p.B);
    flash_dkv_fp32_kernel<DT, MODE><<<grid, THREADS, smem, st>>>(p);
  } else {
    const dim3 grid((p.Lq + BR - 1) / BR, p.H, p.B);
    flash_dq_fp32_kernel<DT, MODE><<<grid, THREADS, smem, st>>>(p);
  }
  return cudaGetLastError();
}

template <int DT, bool DKV>
cudaError_t by_mask(const FlashParams& p, int device, cudaStream_t st) {
  if (p.mask == nullptr) return launch<DT, MASK_NONE, DKV>(p, device, st);
  if (p.m_sr == 0) return launch<DT, MASK_KEYS, DKV>(p, device, st);
  return launch<DT, MASK_FULL, DKV>(p, device, st);
}

// 16-byte aligned base and (batch, row, head) strides in elements that
// keep every row 16-byte aligned (0 for a broadcast dimension)
bool operand_ok(const void* x, int64_t sb, int64_t sl, int64_t sh) {
  return x != nullptr && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         sb % 4 == 0 && sl % 4 == 0 && sh % 4 == 0;
}

template <bool DKV>
int run(const FlashParams* p, int dtype, int device, void* stream) {
  if (p == nullptr || dtype != 0 || p->B < 1 || p->B > 65535 ||
      p->Hkv < 1 || p->H < p->Hkv || p->H % p->Hkv || p->H > 65535 ||
      p->Lq < 1 || p->Lk < 1 || p->D < 8 || p->D > 128 || p->D % 8 ||
      p->window < 0 || p->lse == nullptr || p->delta == nullptr ||
      !operand_ok(p->q, p->q_sb, p->q_sl, p->q_sh) ||
      !operand_ok(p->k, p->k_sb, p->k_sl, p->k_sh) ||
      !operand_ok(p->v, p->v_sb, p->v_sl, p->v_sh) ||
      !operand_ok(p->dout, p->do_sb, p->do_sl, p->do_sh) ||
      (DKV ? !operand_ok(p->dk, p->dk_sb, p->dk_sl, p->dk_sh) ||
                 !operand_ok(p->dv, p->dv_sb, p->dv_sl, p->dv_sh)
           : !operand_ok(p->dq, p->dq_sb, p->dq_sl, p->dq_sh)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->D <= 64) return (int)by_mask<64, DKV>(*p, device, st);
  return (int)by_mask<128, DKV>(*p, device, st);
}

}  // namespace

// dtype must be 0 (float32).  Each returns a cudaError_t code:
// cudaErrorInvalidValue for what the kernels do not take, else the result
// of cudaGetLastError() right after the launch.
extern "C" int flash_bwd_fp32_dkv(const FlashParams* p, int dtype,
                                  int device, void* stream) {
  return run<true>(p, dtype, device, stream);
}

extern "C" int flash_bwd_fp32_dq(const FlashParams* p, int dtype, int device,
                                 void* stream) {
  return run<false>(p, dtype, device, stream);
}

extern "C" int flash_bwd_fp32_params_size() { return sizeof(FlashParams); }

extern "C" const char* flash_bwd_fp32_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
