// Launch parameters shared by the flash-attention sources
// (flash_attention.cu and flash_attention_sm90.cu), mirrored field for
// field by ctypes in paddle_tpu_torch/ops/flash_attention.py.
#pragma once
#include <stdint.h>

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // backward: dO
  const float* lse;     // backward input, [B, H, Lq]
  const float* delta;   // backward input, [B, H, Lq]
  const float* mask;    // additive float32, or null
  void* out;            // forward: o
  float* lse_out;       // forward: lse, [B, H, Lq]
  void* dq;
  void* dk;
  void* dv;
  // element strides (batch, row, head); the last dimension is contiguous
  int64_t q_sb, q_sl, q_sh;
  int64_t k_sb, k_sl, k_sh;
  int64_t v_sb, v_sl, v_sh;
  int64_t o_sb, o_sl, o_sh;
  int64_t do_sb, do_sl, do_sh;
  int64_t dq_sb, dq_sl, dq_sh;
  int64_t dk_sb, dk_sl, dk_sh;
  int64_t dv_sb, dv_sl, dv_sh;
  int64_t m_sb, m_sh, m_sr;
  int B, H, Hkv, Lq, Lk, D;
  int causal, window;   // window 0: none
  float scale;
};
