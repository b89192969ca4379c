// Flash attention for Hopper (sm_90a): the forward and both kernels of the
// backward (dK/dV, dQ), redesigned around TMA, wgmma and warp
// specialisation, on (B, L, H, D) tensors in bfloat16 or float16 with D 64
// or 128.
//
// Replaces, for the shapes it takes, the Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py
//   _fwd_kernel (:84, via _fwd :183)  -> flash_fwd_sm90_kernel
//   _dkv_kernel (:262, via _bwd :358) -> flash_dkv_sm90_kernel
//   _dq_kernel  (:312, via _bwd :358) -> flash_dq_sm90_kernel
// with the semantics of flash_attention.cu (bottom-right causal, a sliding
// window with causal, GQA, ragged lengths; a row that sees nothing gives
// o = 0 and lse = -inf; the backward takes lse, with lse taken as 0 where
// it is not finite, and delta = rowsum(dO * O) from the caller).
//
// Bound, at the GPT training shape (B 4, L 1024, H 16, D 128, causal,
// bf16): the forward moves ~67 MB for ~17 GFLOP and is bound by bytes
// (0.0201 ms at 3.35 TB/s); dK/dV does four products (~34 GFLOP) and dQ
// three (~26 GFLOP), both bound by operations (0.0348 and 0.0261 ms at
// 989 TFLOP/s).
//
// Design: three kernels on one mainloop shape.
//  * A block has two consumer warpgroups of 64 rows each and a producer
//    warpgroup whose first warp only feeds shared memory; setmaxnreg moves
//    registers from the producer (24) to the consumers (240).
//  * The forward and dQ are q-stationary: a block owns 128 query rows of
//    one (batch, head).  Q (and dO for dQ) are loaded once; K and V tiles
//    of BC keys stream through a ring of STAGES stages with full / empty
//    mbarriers, so the producer runs ahead of the products.  The forward
//    takes BC 128 in 2 stages (fewer, wider wgmmas; S and O are 64 floats
//    a thread each; 161 KB of shared memory at D 128); dQ takes BC 64 in 3
//    stages, since S, dP and the dQ accumulator live together (32 + 32 +
//    64 floats).
//  * dK/dV is kv-stationary: a block owns 128 keys of one (batch, kv head);
//    K and V are loaded once and stay resident, and Q, dO, lse and delta
//    tiles of 64 query rows stream through a 3-stage ring (163 KB of
//    shared memory at D 128).  The GQA group is folded into the loop (the
//    block walks g query heads x the query tiles that see its keys, as
//    _dkv_kernel's grid folds it into its last axis), so dK and dV are
//    written once, with no atomics: the result is deterministic.  lse and delta belong to the accumulator's columns,
//    so the producer warp's lanes copy them per stage into shared memory
//    (rows past Lq as 0) and arrive on the stage's full barrier beside the
//    TMA bytes.  dK and dV take 64 + 64 floats a thread at D 128, S^T and
//    dP^T 32 + 32.
//  * Tensor maps are rank 4 (D, H, L, B) with byte strides, built on the
//    host in the C entry, so the q/k/v views of a fused qkv projection
//    need no copy; rows past Lq or Lk come back zero-filled from TMA.
//  * Every tile is two boxes of 64 columns (128 bytes, the widest a
//    128-byte swizzle takes) at D 128, one at D 64; the wgmma descriptors
//    step across them.
//  * Forward: S = Q K^T is wgmma with A and B in shared memory (K-major).
//    The online softmax runs in registers in float32 with exp2 and
//    scale * log2(e) folded into one multiply; p is rounded to the input
//    dtype in registers and becomes the register A operand of O += P V,
//    whose B operand is the V tile as loaded ([keys, D], MN-major, through
//    wgmma's transpose-B immediate).
//  * dQ: S = Q K^T and dP = dO V^T from shared memory; P = exp2(S c -
//    lse log2(e)) and dS = P (dP - delta) in registers; dS, rounded to the
//    input dtype, is the register A operand of dQ += dS K with K MN-major
//    from the stage already in shared memory; the scale is applied once,
//    in the epilogue.
//  * dK/dV: S^T = K Q^T and dP^T = V dO^T from shared memory (both
//    K-major along D); P^T and dS^T in registers; dV += P^T dO and dK +=
//    dS^T Q with P^T and dS^T, rounded to the input dtype, as the register
//    A operand and dO and Q MN-major from the stage; the scale once, in
//    the epilogue.  P and dS round where the flash_attention.cu kernels
//    round them, so both families err alike against the plain version.
//  * Tiles wholly visible to a warpgroup run with no per-element test; the
//    edge tiles (causal diagonal, the window's edge, the ragged Lq / Lk
//    tails) test each element, and a dK/dV warpgroup skips a query tile
//    that sees none of its keys.  Causal and window are runtime
//    arguments, tested once per tile.
//  * Under causal masking the longest blocks start first: the forward and
//    dQ grids (H, B, q tiles) take the q tiles in reverse order, the dK/dV
//    grid (Hkv, B, key tiles) the key tiles in order (the left ones see
//    the most rows).  cudaFuncSetAttribute runs once per kernel and
//    device.
//
//  * The forward takes the additive float32 mask of flash_attention.cu
//    (element (b, h, r, c) at mask[b*m_sb + h*m_sh + r*m_sr + c], strides
//    of 0 broadcasting): scores are in units of log2, so it adds mask *
//    log2(e).  A consumer thread loads its 64 elements of a tile from
//    global memory (through L2; pairs of columns as one 8-byte load where
//    the rows are 8-byte aligned), with no branch per element, right after
//    issuing the tile's S = Q K^T, so the loads travel while the product
//    runs; with a mask every tile takes the per-element branch,
//    since tile_full and key_range know only causal and the window.
//    Loading mask tiles by TMA is later work.
//
//  * dK/dV and dQ take the same mask (a padded fine-tune, BERT / ERNIE,
//    trains under one), in three instantiations picked at launch: none,
//    a key vector (m_sr == 0: every query row of a (batch, head) reads
//    one row of Lk values, as a padding mask does) and full rows.  The
//    additive mask needs no visibility test of its own, so interior tiles
//    keep the no-branch path under either; only causal, the window and
//    the ragged tails test each element.  p = exp2(s c + (mask - lse)
//    log2(e)): a bool mask's -inf gives p = 0 and dS = 0, and a row that
//    sees nothing (lse -inf, taken as 0) gives 0, with no NaN.
//    - Key vector, dK/dV: the keys are the accumulator's rows, so a
//      consumer thread needs the values of its own two keys only; it
//      loads them when the query head of the GQA loop changes, not per
//      tile.  dQ: the producer warp's lanes copy the stage's BC values,
//      times log2(e), into shared memory beside the K / V bytes (as dK/dV
//      copies lse and delta) and arrive on full[s]; consumers read their
//      columns as float2.
//    - Full rows: per-thread loads from L2 issued right after the S (S^T)
//      products, as the forward does (in dK/dV the two rows of a pair are
//      m_sr apart, so the loads are scalar; 4 rows x 8 keys a warp, 32-byte
//      runs).  A TMA tile would not fit: at D 128 the dK/dV ring takes 163
//      KB and a float32 mask tile of 64 x 128 adds 32 KB a stage, and the
//      mask's rows (Lk floats) need not be 16-byte aligned.
//
// Not taken (the wrapper routes these to flash_attention.cu before any
// launch): float32, D other than 64 or 128, and operands whose base or
// (batch, row, head) strides are not 16-byte aligned.  The C entries
// return cudaErrorInvalidValue for them.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "flash_params.cuh"

namespace {

constexpr int BR = 128;        // query rows per block
constexpr int THREADS = 384;   // consumer warpgroups 0 and 1, producer 2
constexpr int BOX = 64;        // columns of one TMA box (128 bytes)
constexpr int CONSUMER_WARPS = 8;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// the backward kernels' mask instantiations
constexpr int MASK_NONE = 0;
constexpr int MASK_KEYS = 1;   // m_sr == 0: one row of Lk per (batch, head)
constexpr int MASK_FULL = 2;
// a full barrier that a warp's lanes arrive on besides the TMA arrival
constexpr int WARP_FULL_ARRIVALS = 1 + 32;

// ---------------------------------------------------------------- wgmma
// d (m64 x N, float32, the accumulator layout: with warp w, g = lane / 4,
// t = lane % 4, d[4j + e] is row 16w + g + 8 (e / 2), column 8j + 2t +
// e % 2) += A (m64 x k16) * B (k16 x N).  ss: A and B from shared memory,
// both K-major; `acc` 0 overwrites d.  rs: A from registers (the
// m64k16 A fragment, pairs of 16-bit values), B from shared memory,
// MN-major.
template <typename T, int N>
struct Wgmma;

template <>
struct Wgmma<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<__nv_bfloat16, 128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<__half, 64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<__half, 128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of an accumulator above the wait
// of the wgmma that writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a 128-byte-swizzled wgmma operand in shared memory: start
// address, leading and stride byte offsets, layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A tile of R rows x D columns lies in shared memory as D / 64 blocks of
// R rows x 128 bytes (block j at tile + j R 128), each as TMA's 128-byte
// swizzle writes it.  K-major: the k16 slice kk over the columns, rows
// from r0 on; 8-row groups 1024 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return make_desc(tile + (kk >> 2) * R * 128 + r0 * 128 + (kk & 3) * 32,
                   16, 1024);
}

// MN-major (the columns are the N dimension): the k16 slice kk over the
// rows; 8-row groups 1024 bytes apart, 64-column blocks R 128 apart
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, R * 128, 1024);
}

// -------------------------------------------------- barriers, TMA, misc
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a rank-4 (D, H, L, B) tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(batch), "r"(bar)
      : "memory");
}

// a tile of `rows` rows x D columns: D / 64 boxes
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int head, int row,
                                         int batch, int rows) {
#pragma unroll
  for (int j = 0; j < D / BOX; ++j)
    tma_load(dst + j * rows * 128, map, bar, j * BOX, head, row, batch);
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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

// accumulator d (m64 x 16 kk ..) -> the A fragments of the k16 slices:
// slice kk holds columns 16 kk .. 16 kk + 15, i.e. d[8 kk .. 8 kk + 7]
template <typename T, int N>
__device__ __forceinline__ void to_a_frags(const float (&d)[N / 2],
                                           uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack2<T>(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// ------------------------------------------------------------ masking
// the key tiles [kb, ke) a block of query rows q0 .. q0 + BR - 1 visits:
// inside the key length, not wholly above the causal diagonal, not wholly
// left of the window
template <int BC>
__device__ __forceinline__ void key_range(const FlashParams& p, int q0,
                                          int& kb, int& ke) {
  const int off = p.Lk - p.Lq;
  kb = 0;
  ke = (p.Lk + BC - 1) / BC;
  if (p.causal) {
    const int last = min(q0 + BR, p.Lq) - 1 + off;  // rightmost visible col
    ke = last < 0 ? 0 : min(ke, last / BC + 1);
    if (p.window) {
      const int first = q0 + off - p.window + 1;    // leftmost visible col
      kb = first <= 0 ? 0 : first / BC;
    }
  }
}

// every element of rows r0 .. r0 + 63 x keys k0 .. k0 + BC - 1 visible
template <int BC>
__device__ __forceinline__ bool tile_full(const FlashParams& p, int r0,
                                          int k0) {
  if (k0 + BC > p.Lk) return false;
  if (!p.causal) return true;
  const int off = p.Lk - p.Lq;
  if (k0 + BC - 1 > r0 + off) return false;
  return !p.window || k0 > r0 + 63 + off - p.window;
}

__device__ __forceinline__ bool visible(const FlashParams& p, int row,
                                        int col) {
  const int off = p.Lk - p.Lq;
  bool keep = col < p.Lk;
  if (p.causal) {
    keep = keep && col <= row + off;
    if (p.window) keep = keep && col > row + off - p.window;
  }
  return keep;
}

// column of accumulator element i for lane quarter t, from key k0
__device__ __forceinline__ int acc_col(int k0, int i, int t) {
  return k0 + 8 * (i >> 2) + 2 * t + (i & 1);
}

// -------------------------------------------------------- shared layout
template <int D, int BC, int STAGES, int NQ, int VEC = 0>
struct Smem {
  // NQ tiles of BR rows (Q, and dO for dQ), then per stage K and V tiles
  // of BC rows, then per stage VEC floats (dQ under a key-vector mask: the
  // stage's mask values times log2(e)), then full[STAGES], empty[STAGES]
  // and the Q barrier
  static constexpr int Q_BYTES = BR * D * 2;
  static constexpr int KV_BYTES = BC * D * 2;
  static constexpr int ROWS = NQ * Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int BARS = ROWS + STAGES * VEC * 4;
  static constexpr int BYTES = BARS + 8 * (2 * STAGES + 1) + 1024;  // + align
  static_assert(BYTES <= 232448, "over the 227 KB a block can use");

  uint32_t base;
  unsigned char* ptr;   // base as a generic pointer
  __device__ __forceinline__ explicit Smem(unsigned char* raw)
      : base((smem_u32(raw) + 1023u) & ~1023u),
        ptr(raw + (base - smem_u32(raw))) {}
  __device__ __forceinline__ float* vec(int s) const {
    return reinterpret_cast<float*>(ptr + ROWS + s * VEC * 4);
  }
  __device__ __forceinline__ uint32_t q(int i) const {
    return base + i * Q_BYTES;
  }
  __device__ __forceinline__ uint32_t k(int s) const {
    return base + NQ * Q_BYTES + s * 2 * KV_BYTES;
  }
  __device__ __forceinline__ uint32_t v(int s) const {
    return k(s) + KV_BYTES;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + BARS + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + BARS + 8 * (STAGES + s);
  }
  __device__ __forceinline__ uint32_t qbar() const {
    return base + BARS + 16 * STAGES;
  }
};

// barriers: full[s] completes when the producer's bytes of stage s have
// landed (and, for dK/dV and a key-masked dQ, its lanes' stores of lse and
// delta or of the mask are done);
// empty[s] when every consumer warp is done with stage s
template <class S, int STAGES>
__device__ __forceinline__ void init_barriers(const S& sm,
                                              uint32_t full_arrivals = 1) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), full_arrivals);
      mbar_init(sm.empty(s), CONSUMER_WARPS);
    }
    mbar_init(sm.qbar(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// the producer: Q (and dO) once, then K and V of each key tile through
// the ring; one thread issues every load.  With KEYS (dQ under a
// key-vector mask) the whole warp runs it: lane 0 issues the loads, and
// each lane copies its columns of the tile's mask row mk, times log2(e),
// into the stage's vector (columns past Lk as 0), then arrives on full[s]
template <int D, int BC, int STAGES, int NQ, bool KEYS = false, class S>
__device__ __forceinline__ void produce(const S& sm, const CUtensorMap* tq,
                                        const CUtensorMap* tdo,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int h, int hk,
                                        int b, int q0, int kb, int ntiles,
                                        const float* mk = nullptr,
                                        int Lk = 0) {
  const int lane = threadIdx.x & 31;
  const bool lead = !KEYS || lane == 0;
  if (lead) {
    mbar_expect_tx(sm.qbar(), NQ * S::Q_BYTES);
    tma_tile<D>(sm.q(0), tq, sm.qbar(), h, q0, b, BR);
    if constexpr (NQ == 2) tma_tile<D>(sm.q(1), tdo, sm.qbar(), h, q0, b, BR);
  }
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    mbar_wait(sm.empty(s), ((it / STAGES) & 1) ^ 1);
    const int k0 = (kb + it) * BC;
    if (lead) {
      mbar_expect_tx(sm.full(s), 2 * S::KV_BYTES);
      tma_tile<D>(sm.k(s), tk, sm.full(s), hk, k0, b, BC);
      tma_tile<D>(sm.v(s), tv, sm.full(s), hk, k0, b, BC);
    }
    if constexpr (KEYS) {
      float* mv = sm.vec(s);
#pragma unroll
      for (int i = lane; i < BC; i += 32)
        mv[i] = k0 + i < Lk ? __ldg(mk + k0 + i) * LOG2E : 0.f;
      mbar_arrive(sm.full(s));
    }
  }
}

// a consumer warp is done with stage s (its wgmmas have retired)
__device__ __forceinline__ void release(uint32_t empty_bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty_bar);
}

// ---------------------------------------------------------------- forward
constexpr int FWD_BC = 128;    // keys per stage
constexpr int FWD_STAGES = 2;

// this thread's elements of the additive mask for the key tile at k0:
// mv[i] is the element of accumulator element i (row rows[(i >> 1) & 1],
// column k0 + 8 (i >> 2) + 2t + (i & 1)), from the mask of this (batch,
// head) mg (element (row, col) at mg[row * m_sr + col]).  The caller
// issues them all before the S product retires, so the loads travel
// (through L2: every head and batch that broadcasts the mask reads the same
// lines) while it runs; none waits on a branch.  Inside the key length
// the two columns of an element pair are one 8-byte load where the mask's
// rows are 8-byte aligned (`vec`); at the ragged edge the column is
// clamped into the mask, as a row past Lq always is, so every load is
// valid: such an element is never visible, and its value is never used.
template <int N>
__device__ __forceinline__ void load_mask(float (&mv)[N],
                                          const float* __restrict__ mg,
                                          const FlashParams& p,
                                          const int (&rows)[2], int k0,
                                          int t, bool vec) {
  const float* base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    base[r] = mg + (int64_t)min(rows[r], p.Lq - 1) * p.m_sr + k0 + 2 * t;
  if (vec && k0 + 2 * N <= p.Lk) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(base[r] +
                                                               8 * j));
        mv[4 * j + 2 * r] = v.x;
        mv[4 * j + 2 * r + 1] = v.y;
      }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int col = min(k0 + 8 * (i >> 2) + 2 * t + (i & 1), p.Lk - 1);
      mv[i] = __ldg(base[(i >> 1) & 1] - k0 - 2 * t + col);
    }
  }
}

// one key tile of the online softmax: mask (edge tiles, and every tile
// when there is an additive mask), running maximum m (in units of log2),
// row sums l (this thread's columns; the quad sums them in the epilogue),
// p = exp2(s c - m) in place, corr the factor that rescales the earlier
// output.  With ADD, mv holds the additive mask's elements (`load_mask`),
// added in units of log2
template <bool MASK, bool ADD, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const FlashParams& p,
                                             const float (&mv)[N],
                                             const int (&rows)[2], int k0,
                                             int t, float c) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    s[i] *= c;
    if (ADD) s[i] = fmaf(mv[i], LOG2E, s[i]);
    if (MASK && !visible(p, rows[r], acc_col(k0, i, t))) s[i] = -INFINITY;
    mx[r] = fmaxf(mx[r], s[i]);
  }
  float ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    ms[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    corr[r] = ex2(m[r] - ms[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(s[i] - ms[r]);
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// grid (H, B, ceil(Lq / 128)): a block owns 128 query rows of one head
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                          const __grid_constant__ CUtensorMap tmK,
                          const __grid_constant__ CUtensorMap tmV,
                          const FlashParams p) {
  constexpr int BC = FWD_BC, STAGES = FWD_STAGES;
  using S = Smem<D, BC, STAGES, 1>;
  extern __shared__ unsigned char smem_raw[];
  const S sm(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BR;   // longest first
  const int hk = h / (p.H / p.Hkv);
  int kb, ke;
  key_range<BC>(p, q0, kb, ke);
  const int ntiles = max(ke - kb, 0);
  init_barriers<S, STAGES>(sm);

  if (threadIdx.x >= 2 * 128) {
    // ---- producer warpgroup
    reg_dealloc<24>();
    if (threadIdx.x == 2 * 128 && ntiles > 0)
      produce<D, BC, STAGES, 1>(sm, &tmQ, nullptr, &tmK, &tmV, h, hk, b, q0,
                                kb, ntiles);
  } else {
    // ---- consumer warpgroups
    reg_alloc<240>();
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * 64;
    const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
    const float c = p.scale * LOG2E;
    // tile_full and key_range know causal and the window only: with a
    // mask every tile takes the per-element branch
    const float* mg =
        p.mask == nullptr ? nullptr : p.mask + b * p.m_sb + h * p.m_sh;
    // the mask's rows 8-byte aligned: its pairs of columns load as float2
    const bool mvec = reinterpret_cast<uintptr_t>(p.mask) % 8 == 0 &&
                      p.m_sb % 2 == 0 && p.m_sh % 2 == 0 && p.m_sr % 2 == 0;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    if (ntiles > 0) mbar_wait(sm.qbar(), 0);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % STAGES;
      const int k0 = (kb + it) * BC;
      mbar_wait(sm.full(st), (it / STAGES) & 1);
      // S = Q K^T
      float s[BC / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, BC>::ss(s, desc_k<BR>(sm.q(0), wg * 64, kk),
                         desc_k<BC>(sm.k(st), 0, kk), kk > 0);
      wgmma_commit();
      float mv[BC / 2];
      if (mg != nullptr) load_mask(mv, mg, p, rows, k0, t, mvec);
      wgmma_wait();
      fence_regs(s);
      float corr[2];
      if (mg != nullptr)
        softmax_tile<true, true>(s, m, l, corr, p, mv, rows, k0, t, c);
      else if (tile_full<BC>(p, r0, k0))
        softmax_tile<false, false>(s, m, l, corr, p, mv, rows, k0, t, c);
      else
        softmax_tile<true, false>(s, m, l, corr, p, mv, rows, k0, t, c);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      // O += P V: P from registers, V [keys, D] MN-major
      uint32_t pa[BC / 16][4];
      to_a_frags<T, BC>(s, pa);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
        Wgmma<T, D>::rs(o, pa[kk], desc_mn<BC>(sm.v(st), kk));
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      release(sm.empty(st));
    }

    T* og = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lt = quad_sum(l[r]);
      const int row = rows[r];
      if (row >= p.Lq) continue;
      const float l_safe = lt == 0.f ? 1.f : lt;
      const float inv = 1.f / l_safe;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(og + row * p.o_sl + 8 * j + 2 * t) =
            pack2<T>(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      if (t == 0)
        p.lse_out[((int64_t)b * p.H + h) * p.Lq + row] =
            m[r] == -INFINITY ? -INFINITY : m[r] * LN2 + logf(l_safe);
    }
  }
}

// --------------------------------------------------------------------- dQ
constexpr int DQ_BC = 64;
constexpr int DQ_STAGES = 3;

// grid (H, B, ceil(Lq / 128)): a block owns 128 query rows of one head.
// MODE: the mask's instantiation (MASK_NONE, MASK_KEYS, MASK_FULL)
template <typename T, int D, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                         const __grid_constant__ CUtensorMap tmK,
                         const __grid_constant__ CUtensorMap tmV,
                         const __grid_constant__ CUtensorMap tmdO,
                         const FlashParams p) {
  constexpr int BC = DQ_BC, STAGES = DQ_STAGES;
  constexpr bool KEYS = MODE == MASK_KEYS;
  using S = Smem<D, BC, STAGES, 2, KEYS ? BC : 0>;
  extern __shared__ unsigned char smem_raw[];
  const S sm(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BR;   // longest first
  const int hk = h / (p.H / p.Hkv);
  int kb, ke;
  key_range<BC>(p, q0, kb, ke);
  const int ntiles = max(ke - kb, 0);
  init_barriers<S, STAGES>(sm, KEYS ? WARP_FULL_ARRIVALS : 1);
  // the mask of this (batch, head): element (row, col) at mg[row * m_sr +
  // col]
  const float* mg =
      MODE == MASK_NONE ? nullptr : p.mask + b * p.m_sb + h * p.m_sh;

  if (threadIdx.x >= 2 * 128) {
    reg_dealloc<24>();
    if constexpr (KEYS) {
      if (threadIdx.x < 2 * 128 + 32 && ntiles > 0)
        produce<D, BC, STAGES, 2, true>(sm, &tmQ, &tmdO, &tmK, &tmV, h, hk,
                                        b, q0, kb, ntiles, mg, p.Lk);
    } else if (threadIdx.x == 2 * 128 && ntiles > 0) {
      produce<D, BC, STAGES, 2>(sm, &tmQ, &tmdO, &tmK, &tmV, h, hk, b, q0,
                                kb, ntiles);
    }
  } else {
    reg_alloc<240>();
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * 64;
    const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
    const float c = p.scale * LOG2E;
    // a full mask's rows 8-byte aligned: its pairs of columns load as float2
    const bool mvec = MODE == MASK_FULL &&
                      reinterpret_cast<uintptr_t>(p.mask) % 8 == 0 &&
                      p.m_sb % 2 == 0 && p.m_sh % 2 == 0 && p.m_sr % 2 == 0;
    float lse2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t at = ((int64_t)b * p.H + h) * p.Lq + rows[r];
      const float v = rows[r] < p.Lq ? p.lse[at] : 0.f;
      lse2[r] = isfinite(v) ? v * LOG2E : 0.f;
      delta[r] = rows[r] < p.Lq ? p.delta[at] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    if (ntiles > 0) mbar_wait(sm.qbar(), 0);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % STAGES;
      const int k0 = (kb + it) * BC;
      mbar_wait(sm.full(st), (it / STAGES) & 1);
      // S = Q K^T and dP = dO V^T
      float s[BC / 2], dp[BC / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, BC>::ss(s, desc_k<BR>(sm.q(0), wg * 64, kk),
                         desc_k<BC>(sm.k(st), 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<T, BC>::ss(dp, desc_k<BR>(sm.q(1), wg * 64, kk),
                         desc_k<BC>(sm.v(st), 0, kk), kk > 0);
      wgmma_commit();
      // the mask's elements of this tile: a full mask's from L2 while the
      // products run, a key vector's (already times log2(e)) from the stage
      float mv[BC / 2];
      if constexpr (MODE == MASK_FULL)
        load_mask(mv, mg, p, rows, k0, t, mvec);
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);
      if constexpr (KEYS) {
        const float* mk = sm.vec(st);
#pragma unroll
        for (int j = 0; j < BC / 8; ++j) {
          const float2 v = *reinterpret_cast<const float2*>(mk + 8 * j +
                                                            2 * t);
          mv[4 * j] = mv[4 * j + 2] = v.x;
          mv[4 * j + 1] = mv[4 * j + 3] = v.y;
        }
      }
      // dS = P (dP - delta), P = exp2(s c + (mask - lse) log2 e), in place
      // in s
      const bool full = tile_full<BC>(p, r0, k0);
#pragma unroll
      for (int i = 0; i < BC / 2; ++i) {
        const int r = (i >> 1) & 1;
        float x;
        if constexpr (MODE == MASK_NONE)
          x = fmaf(s[i], c, -lse2[r]);
        else if constexpr (KEYS)
          x = fmaf(s[i], c, mv[i] - lse2[r]);
        else
          x = fmaf(s[i], c, fmaf(mv[i], LOG2E, -lse2[r]));
        float pv = ex2(x);
        if (!full && !visible(p, rows[r], acc_col(k0, i, t))) pv = 0.f;
        s[i] = pv * (dp[i] - delta[r]);
      }
      // dQ += dS K: dS from registers, K [keys, D] MN-major
      uint32_t da[BC / 16][4];
      to_a_frags<T, BC>(s, da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk)
        Wgmma<T, D>::rs(dq, da[kk], desc_mn<BC>(sm.k(st), kk));
      wgmma_commit();
      wgmma_wait();
      fence_regs(dq);
      release(sm.empty(st));
    }

    T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rows[r];
      if (row >= p.Lq) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dqg + row * p.dq_sl + 8 * j + 2 * t) =
            pack2<T>(dq[4 * j + 2 * r] * p.scale,
                     dq[4 * j + 2 * r + 1] * p.scale);
    }
  }
}

// ------------------------------------------------------------------ dK/dV
constexpr int BKV = 128;       // keys per block
constexpr int BQ = 64;         // query rows per stage
constexpr int DKV_STAGES = 3;

// K and V of the block's keys (resident), then per stage Q and dO tiles of
// BQ rows, then per stage lse * log2(e) and delta of those rows (float32),
// then full[STAGES], empty[STAGES] and the K/V barrier
template <int D, int STAGES>
struct DkvSmem {
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int VEC_BYTES = 2 * BQ * 4;
  static constexpr int ROWS = 2 * KV_BYTES + STAGES * 2 * Q_BYTES;
  static constexpr int BARS = ROWS + STAGES * VEC_BYTES;
  static constexpr int BYTES = BARS + 8 * (2 * STAGES + 1) + 1024;
  static_assert(BYTES <= 232448, "over the 227 KB a block can use");

  uint32_t base;
  unsigned char* ptr;   // base as a generic pointer
  __device__ __forceinline__ explicit DkvSmem(unsigned char* raw)
      : base((smem_u32(raw) + 1023u) & ~1023u),
        ptr(raw + (base - smem_u32(raw))) {}
  __device__ __forceinline__ uint32_t k() const { return base; }
  __device__ __forceinline__ uint32_t v() const { return base + KV_BYTES; }
  __device__ __forceinline__ uint32_t q(int s) const {
    return base + 2 * KV_BYTES + s * 2 * Q_BYTES;
  }
  __device__ __forceinline__ uint32_t dout(int s) const {
    return q(s) + Q_BYTES;
  }
  __device__ __forceinline__ float* lse2(int s) const {
    return reinterpret_cast<float*>(ptr + ROWS + s * VEC_BYTES);
  }
  __device__ __forceinline__ float* delta(int s) const {
    return lse2(s) + BQ;
  }
  __device__ __forceinline__ uint32_t full(int s) const {
    return base + BARS + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return base + BARS + 8 * (STAGES + s);
  }
  __device__ __forceinline__ uint32_t qbar() const {   // K and V
    return base + BARS + 16 * STAGES;
  }
};

// the query tiles [qb, qe) of BQ rows that see any of the keys k0 ..
// k0 + BKV - 1: not wholly below the causal diagonal's reach (rows before
// k0 - off see none of them), not wholly right of the window
__device__ __forceinline__ void query_range(const FlashParams& p, int k0,
                                            int& qb, int& qe) {
  const int off = p.Lk - p.Lq;
  qb = 0;
  qe = (p.Lq + BQ - 1) / BQ;
  if (p.causal) {
    const int first = k0 - off;          // first row that sees key k0
    if (first > 0) qb = min(first / BQ, qe);
    if (p.window) {                      // last row that sees the last key
      const int last = min(k0 + BKV, p.Lk) - 1 - off + p.window - 1;
      qe = last < 0 ? 0 : min(qe, last / BQ + 1);
    }
  }
}

// rows q0 .. q0 + BQ - 1 x keys c0 .. c0 + 63: some element visible
__device__ __forceinline__ bool kv_tile_any(const FlashParams& p, int q0,
                                            int c0) {
  if (c0 >= p.Lk) return false;
  if (!p.causal) return true;
  const int off = p.Lk - p.Lq;
  if (c0 > min(q0 + BQ, p.Lq) - 1 + off) return false;
  return !p.window || min(c0 + 64, p.Lk) - 1 > q0 + off - p.window;
}

// every element visible
__device__ __forceinline__ bool kv_tile_full(const FlashParams& p, int q0,
                                             int c0) {
  if (q0 + BQ > p.Lq || c0 + 64 > p.Lk) return false;
  if (!p.causal) return true;
  const int off = p.Lk - p.Lq;
  if (c0 + 63 > q0 + off) return false;
  return !p.window || c0 > q0 + BQ - 1 + off - p.window;
}

// the producer warp: K and V once (one lane), then per (query head of the
// group, query tile) the Q and dO tiles by TMA (lane 0) and lse * log2(e)
// and delta of the tile's rows by the warp's loads, rows past Lq as 0 and a
// lse that is not finite as 0; every lane arrives on full[s] after its
// stores, lane 0 once more with the TMA bytes
template <int D, int STAGES, class S>
__device__ __forceinline__ void produce_dkv(
    const S& sm, const FlashParams& p, const CUtensorMap* tq,
    const CUtensorMap* tdo, const CUtensorMap* tk, const CUtensorMap* tv,
    int hk, int b, int k0, int qb, int nq, int ntiles) {
  const int lane = threadIdx.x & 31;
  const int grp = p.H / p.Hkv;
  if (lane == 0) {
    mbar_expect_tx(sm.qbar(), 2 * S::KV_BYTES);
    tma_tile<D>(sm.k(), tk, sm.qbar(), hk, k0, b, BKV);
    tma_tile<D>(sm.v(), tv, sm.qbar(), hk, k0, b, BKV);
  }
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % STAGES;
    const int h = hk * grp + it / nq;
    const int q0 = (qb + it % nq) * BQ;
    mbar_wait(sm.empty(s), ((it / STAGES) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(sm.full(s), 2 * S::Q_BYTES);
      tma_tile<D>(sm.q(s), tq, sm.full(s), h, q0, b, BQ);
      tma_tile<D>(sm.dout(s), tdo, sm.full(s), h, q0, b, BQ);
    }
    const int64_t at = ((int64_t)b * p.H + h) * p.Lq;
    float* lse2 = sm.lse2(s);
    float* delta = sm.delta(s);
#pragma unroll
    for (int i = lane; i < BQ; i += 32) {
      const int row = q0 + i;
      const float l = row < p.Lq ? p.lse[at + row] : 0.f;
      lse2[i] = isfinite(l) ? l * LOG2E : 0.f;
      delta[i] = row < p.Lq ? p.delta[at + row] : 0.f;
    }
    mbar_arrive(sm.full(s));
  }
}

// a full mask's elements for the dK/dV tile of query rows q0 .. q0 + BQ -
// 1: mv[i] is the element of S^T element i (key kc[(i >> 1) & 1], query row
// q0 + 8 (i >> 2) + 2t + (i & 1)) in the mask mh of this (batch, head).
// The two rows of an element pair are m_sr apart, so the loads are scalar;
// a row past Lq is clamped into the mask, as the caller clamps keys past
// Lk, so every load is valid (such an element is never visible).
template <int N>
__device__ __forceinline__ void load_mask_kv(float (&mv)[N],
                                             const float* __restrict__ mh,
                                             const FlashParams& p,
                                             const int (&kc)[2], int q0,
                                             int t) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int row = min(q0 + 8 * (i >> 2) + 2 * t + (i & 1), p.Lq - 1);
    mv[i] = __ldg(mh + (int64_t)row * p.m_sr + kc[(i >> 1) & 1]);
  }
}

// grid (Hkv, B, ceil(Lk / 128)): a block owns 128 keys of one kv head and
// walks the g query heads of its group times the query tiles that see
// them.  MODE: the mask's instantiation (MASK_NONE, MASK_KEYS, MASK_FULL)
template <typename T, int D, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                          const __grid_constant__ CUtensorMap tmK,
                          const __grid_constant__ CUtensorMap tmV,
                          const __grid_constant__ CUtensorMap tmdO,
                          const FlashParams p) {
  constexpr int STAGES = DKV_STAGES;
  using S = DkvSmem<D, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const S sm(smem_raw);
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;   // the left tiles, which see the most
                                     // rows under causal, start first
  int qb, qe;
  query_range(p, k0, qb, qe);
  const int nq = max(qe - qb, 0);
  const int ntiles = nq * (p.H / p.Hkv);
  init_barriers<S, STAGES>(sm, WARP_FULL_ARRIVALS);

  if (threadIdx.x >= 2 * 128) {
    reg_dealloc<24>();
    if (threadIdx.x < 2 * 128 + 32 && ntiles > 0)
      produce_dkv<D, STAGES>(sm, p, &tmQ, &tmdO, &tmK, &tmV, hk, b, k0, qb,
                             nq, ntiles);
  } else {
    reg_alloc<240>();
    const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int c0 = k0 + wg * 64;
    const int keys[2] = {c0 + warp * 16 + g, c0 + warp * 16 + g + 8};
    const float c = p.scale * LOG2E;
    // the mask: this batch's (mb), and this thread's keys clamped into it;
    // under a key vector, the values of those keys times log2(e) for query
    // head hm, loaded when the GQA loop reaches another head
    const float* mb = MODE == MASK_NONE ? nullptr : p.mask + b * p.m_sb;
    const int kc[2] = {min(keys[0], p.Lk - 1), min(keys[1], p.Lk - 1)};
    float mk[2] = {0.f, 0.f};
    int hm = -1;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    if (ntiles > 0) mbar_wait(sm.qbar(), 0);
    for (int it = 0; it < ntiles; ++it) {
      const int st = it % STAGES;
      const int q0 = (qb + it % nq) * BQ;
      const int h = hk * (p.H / p.Hkv) + it / nq;
      mbar_wait(sm.full(st), (it / STAGES) & 1);
      if (kv_tile_any(p, q0, c0)) {
        // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
        float s[BQ / 2], dp[BQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T, BQ>::ss(s, desc_k<BKV>(sm.k(), wg * 64, kk),
                           desc_k<BQ>(sm.q(st), 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<T, BQ>::ss(dp, desc_k<BKV>(sm.v(), wg * 64, kk),
                           desc_k<BQ>(sm.dout(st), 0, kk), kk > 0);
        wgmma_commit();
        // the mask's elements, loaded while the products run
        float mv[BQ / 2];
        if constexpr (MODE == MASK_KEYS) {
          if (h != hm) {
            hm = h;
#pragma unroll
            for (int r = 0; r < 2; ++r)
              mk[r] = __ldg(mb + h * p.m_sh + kc[r]) * LOG2E;
          }
        } else if constexpr (MODE == MASK_FULL) {
          load_mask_kv(mv, mb + h * p.m_sh, p, kc, q0, t);
        }
        wgmma_wait();
        fence_regs(s);
        fence_regs(dp);
        // P^T = exp2(s c + (mask - lse) log2 e) in s, dS^T = P^T (dP^T -
        // delta) in dp; lse and delta belong to the column (the query row),
        // a key vector's values to the row
        const float* lse2 = sm.lse2(st);
        const float* delta = sm.delta(st);
        const bool full = kv_tile_full(p, q0, c0);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
          const float2 dl =
              *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float l = (e & 1) ? l2.y : l2.x;
            float x;
            if constexpr (MODE == MASK_NONE)
              x = fmaf(s[i], c, -l);
            else if constexpr (MODE == MASK_KEYS)
              x = fmaf(s[i], c, mk[e >> 1] - l);
            else
              x = fmaf(s[i], c, fmaf(mv[i], LOG2E, -l));
            float pv = ex2(x);
            if (!full) {
              const int row = acc_col(q0, i, t);
              if (row >= p.Lq || !visible(p, row, keys[e >> 1])) pv = 0.f;
            }
            s[i] = pv;
            dp[i] = pv * (dp[i] - ((e & 1) ? dl.y : dl.x));
          }
        }
        // dV += P^T dO and dK += dS^T Q: A from registers, dO and Q
        // [queries, D] MN-major from the stage
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
        to_a_frags<T, BQ>(s, pa);
        to_a_frags<T, BQ>(dp, da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<T, D>::rs(dv, pa[kk], desc_mn<BQ>(sm.dout(st), kk));
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<T, D>::rs(dk, da[kk], desc_mn<BQ>(sm.q(st), kk));
        wgmma_commit();
        wgmma_wait();
        fence_regs(dv);
        fence_regs(dk);
      }
      release(sm.empty(st));
    }

    T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
    T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = keys[r];
      if (key >= p.Lk) continue;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkg + key * p.dk_sl + 8 * j + 2 * t) =
            pack2<T>(dk[4 * j + 2 * r] * p.scale,
                     dk[4 * j + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvg + key * p.dv_sl + 8 * j + 2 * t) =
            pack2<T>(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------- host
PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }();
  return fn;
}

// rank-4 (D, heads, L, B) map of a 16-bit tensor with element strides
// (head, row, batch), boxes of 64 columns x `rows` rows, 128-byte swizzle;
// reads past L come back as zeros
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType dt,
              int D, int heads, int L, int B, int64_t sh, int64_t sl,
              int64_t sb, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                           (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, dt, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

template <typename T, int D>
cudaError_t launch_fwd(const FlashParams& p, CUtensorMapDataType dt,
                       int device, cudaStream_t st) {
  constexpr int BYTES = Smem<D, FWD_BC, FWD_STAGES, 1>::BYTES;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, dt, D, p.H, p.Lq, p.B, p.q_sh, p.q_sl, p.q_sb,
                BR) ||
      !make_map(&tk, p.k, dt, D, p.Hkv, p.Lk, p.B, p.k_sh, p.k_sl, p.k_sb,
                FWD_BC) ||
      !make_map(&tv, p.v, dt, D, p.Hkv, p.Lk, p.B, p.v_sh, p.v_sl, p.v_sb,
                FWD_BC))
    return cudaErrorInvalidValue;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = smem_once(
      done, device, reinterpret_cast<const void*>(flash_fwd_sm90_kernel<T, D>),
      BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B, (p.Lq + BR - 1) / BR);
  flash_fwd_sm90_kernel<T, D><<<grid, THREADS, BYTES, st>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <typename T, int D, int MODE>
cudaError_t launch_dq(const FlashParams& p, CUtensorMapDataType dt,
                      int device, cudaStream_t st) {
  constexpr int BYTES =
      Smem<D, DQ_BC, DQ_STAGES, 2, MODE == MASK_KEYS ? DQ_BC : 0>::BYTES;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, p.q, dt, D, p.H, p.Lq, p.B, p.q_sh, p.q_sl, p.q_sb,
                BR) ||
      !make_map(&tk, p.k, dt, D, p.Hkv, p.Lk, p.B, p.k_sh, p.k_sl, p.k_sb,
                DQ_BC) ||
      !make_map(&tv, p.v, dt, D, p.Hkv, p.Lk, p.B, p.v_sh, p.v_sl, p.v_sb,
                DQ_BC) ||
      !make_map(&tdo, p.dout, dt, D, p.H, p.Lq, p.B, p.do_sh, p.do_sl,
                p.do_sb, BR))
    return cudaErrorInvalidValue;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = smem_once(
      done, device,
      reinterpret_cast<const void*>(flash_dq_sm90_kernel<T, D, MODE>),
      BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, p.B, (p.Lq + BR - 1) / BR);
  flash_dq_sm90_kernel<T, D, MODE><<<grid, THREADS, BYTES, st>>>(
      tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

template <typename T, int D, int MODE>
cudaError_t launch_dkv(const FlashParams& p, CUtensorMapDataType dt,
                       int device, cudaStream_t st) {
  constexpr int BYTES = DkvSmem<D, DKV_STAGES>::BYTES;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, p.q, dt, D, p.H, p.Lq, p.B, p.q_sh, p.q_sl, p.q_sb,
                BQ) ||
      !make_map(&tk, p.k, dt, D, p.Hkv, p.Lk, p.B, p.k_sh, p.k_sl, p.k_sb,
                BKV) ||
      !make_map(&tv, p.v, dt, D, p.Hkv, p.Lk, p.B, p.v_sh, p.v_sl, p.v_sb,
                BKV) ||
      !make_map(&tdo, p.dout, dt, D, p.H, p.Lq, p.B, p.do_sh, p.do_sl,
                p.do_sb, BQ))
    return cudaErrorInvalidValue;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = smem_once(
      done, device,
      reinterpret_cast<const void*>(flash_dkv_sm90_kernel<T, D, MODE>),
      BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hkv, p.B, (p.Lk + BKV - 1) / BKV);
  flash_dkv_sm90_kernel<T, D, MODE><<<grid, THREADS, BYTES, st>>>(
      tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

// a TMA operand: 16-byte aligned base and nonzero 16-byte (batch, row,
// head) strides
bool operand_ok(const void* x, int64_t sb, int64_t sl, int64_t sh) {
  return x != nullptr && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         sb > 0 && sl > 0 && sh > 0 && sb % 8 == 0 && sl % 8 == 0 &&
         sh % 8 == 0;
}

enum Which { FWD = 0, DQ = 1, DKV = 2 };

template <typename T, int D, int MODE>
cudaError_t launch_bwd(const FlashParams& p, Which which,
                       CUtensorMapDataType dt, int device, cudaStream_t st) {
  if (which == DQ) return launch_dq<T, D, MODE>(p, dt, device, st);
  return launch_dkv<T, D, MODE>(p, dt, device, st);
}

// the backward's mask instantiation from the mask and its row stride
template <typename T, int D>
cudaError_t launch(const FlashParams& p, Which which, CUtensorMapDataType dt,
                   int device, cudaStream_t st) {
  if (which == FWD) return launch_fwd<T, D>(p, dt, device, st);
  if (p.mask == nullptr)
    return launch_bwd<T, D, MASK_NONE>(p, which, dt, device, st);
  if (p.m_sr == 0)
    return launch_bwd<T, D, MASK_KEYS>(p, which, dt, device, st);
  return launch_bwd<T, D, MASK_FULL>(p, which, dt, device, st);
}

int run(const FlashParams* p, Which which, int dtype, int device,
        void* stream) {
  const bool bwd = which != FWD;
  if (p == nullptr || p->B < 1 || p->B > 65535 || p->Hkv < 1 ||
      p->H < p->Hkv || p->H % p->Hkv || p->H > 65535 || p->Lq < 1 ||
      p->Lk < 1 || (p->Lq + BR - 1) / BR > 65535 ||
      (p->Lk + BKV - 1) / BKV > 65535 || (p->D != 64 && p->D != 128) ||
      p->window < 0 || (dtype != 1 && dtype != 2) ||
      !operand_ok(p->q, p->q_sb, p->q_sl, p->q_sh) ||
      !operand_ok(p->k, p->k_sb, p->k_sl, p->k_sh) ||
      !operand_ok(p->v, p->v_sb, p->v_sl, p->v_sh) ||
      (bwd && !operand_ok(p->dout, p->do_sb, p->do_sl, p->do_sh)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const CUtensorMapDataType dt = dtype == 1
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  if (dtype == 1)
    return (int)(p->D == 64
                     ? launch<__nv_bfloat16, 64>(*p, which, dt, device, st)
                     : launch<__nv_bfloat16, 128>(*p, which, dt, device, st));
  return (int)(p->D == 64 ? launch<__half, 64>(*p, which, dt, device, st)
                          : launch<__half, 128>(*p, which, dt, device, st));
}

}  // namespace

// dtype: 1 bfloat16, 2 float16.  The same FlashParams as the
// flash_attention.cu entries, with real (nonzero) strides for q, k, v and
// dO: the tensor maps are built from them here.  Each returns a
// cudaError_t code: cudaErrorInvalidValue for what the kernels do not
// take, else the result of cudaGetLastError() right after the launch.
extern "C" int flash_attention_sm90_fwd(const FlashParams* p, int dtype,
                                        int device, void* stream) {
  return run(p, FWD, dtype, device, stream);
}

extern "C" int flash_attention_sm90_bwd_dq(const FlashParams* p, int dtype,
                                           int device, void* stream) {
  return run(p, DQ, dtype, device, stream);
}

extern "C" int flash_attention_sm90_bwd_dkv(const FlashParams* p, int dtype,
                                            int device, void* stream) {
  return run(p, DKV, dtype, device, stream);
}

extern "C" int flash_attention_sm90_params_size() {
  return sizeof(FlashParams);
}

extern "C" const char* flash_attention_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
