// Native image-pipeline kernels (reference analog: the C++ data-loader ops
// in paddle/fluid/operators/data_norm* and the DALI-style preprocessing the
// reference's DataLoader workers run).  One pass fuses what the Python
// pipeline does in three (uint8->float, /255 + normalize, HWC->CHW
// transpose) — this is the host-side hot loop feeding the card.  The
// port's copy of paddle_tpu/io/native/imgproc.cc.
#include <cstdint>

extern "C" {

// dst[ch][y][x] = (src[y][x][ch] * (unit_scale ? 1/255 : 1) - mean[ch])
//                 * inv_std[ch]
void hwc_u8_to_chw_f32(const unsigned char* src, float* dst,
                       long h, long w, long c,
                       const float* mean, const float* inv_std,
                       int unit_scale) {
  const float s = unit_scale ? (1.0f / 255.0f) : 1.0f;
  const long hw = h * w;
  for (long ch = 0; ch < c; ++ch) {
    const float mu = mean ? mean[ch] : 0.0f;
    const float iv = inv_std ? inv_std[ch] : 1.0f;
    float* d = dst + ch * hw;
    const unsigned char* sp = src + ch;
    for (long i = 0; i < hw; ++i) {
      d[i] = (static_cast<float>(sp[i * c]) * s - mu) * iv;
    }
  }
}

// batched variant: src [n, h, w, c] u8 -> dst [n, c, h, w] f32
void batch_hwc_u8_to_chw_f32(const unsigned char* src, float* dst,
                             long n, long h, long w, long c,
                             const float* mean, const float* inv_std,
                             int unit_scale) {
  const long in_stride = h * w * c;
  const long out_stride = c * h * w;
  for (long i = 0; i < n; ++i) {
    hwc_u8_to_chw_f32(src + i * in_stride, dst + i * out_stride,
                      h, w, c, mean, inv_std, unit_scale);
  }
}

}  // extern "C"
