// K1: Detectron RoIAlign forward on NHWC features with per-image rois, and
// K7: its backward, the features' gradient.
//
// K1 replaces mask_rcnn_tpu/ops/roi_align.py::roi_align_grouped (lines
// 235-301, with _interp_matrix 36-100 and _roi_align_matrices 103-146). The
// JAX package wrote RoIAlign as two einsums over one-hot interpolation
// matrices so that the TPU's matrix unit does the work; on Hopper a gather
// is the natural form: one block per (image, roi) and channel tile, one
// thread per channel, so that each bilinear tap is a coalesced load of
// neighbouring NHWC channels.
//
// What bounds K1 on an H100: reads. At the slice's shapes (features
// (1, 52, 84, 1024) bf16 = 8.9 MB, which stays in the 50 MB L2) each output
// value costs 4 * gy * gx taps; no tensor-core work exists. The design keeps
// the whole per-roi sample grid in registers and accumulates in fp32, so
// device memory sees the features once (from L2 after that) and the output
// once.
//
// K7 replaces the autodiff transpose of those einsums (XLA's transpose of
// roi_align.py:282-301; the rois are stop_gradient, :113). It walks the same
// samples as K1 (the same position code below, so the same skip decisions)
// and scatters grad_out * tap weight / (gy * gx) to the four taps with
// float32 atomicAdd into an NHWC buffer, one thread per channel, so that
// neighbouring threads hit neighbouring addresses. What bounds it: the
// atomics, 4 * gy * gx per output value, resolved in L2 (the float32 buffer
// at the train shape, (2, 52, 84, 1024) = 36 MB, fits in it). The sums'
// order follows the atomics' order, so the last bits vary from run to run;
// the wrapper casts the buffer to the feature type at the end.
//
// Semantics reproduced exactly (mask_rcnn_tpu/ops/roi_align.py:22-27,
// 113-134):
//   * rois are read as f32 whatever the feature type;
//   * start = roi * scale, extent = max(end - start, 1);
//   * bins (0, s, 2s, ...) of a virtual P*s grid (bin_stride s), so with
//     s > 1 only every s-th bin of the virtual grid gets a gradient;
//   * adaptive grid ceil(extent / (P*s)) clipped to [1, ceil(size / (P*s))]
//     when sampling_ratio == 0, else sampling_ratio;
//   * samples at start + p*s*bin + (k + .5) * (bin / grid);
//   * a sample with y < -1 or y > H (x likewise) is skipped, and the divisor
//     gy*gx still counts it;
//   * y <= 0 -> 0; y_low >= H-1 -> y_low = y_high = H-1 with weight 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Tap {
  int low, high;
  float lw, hw;
};

// One axis of one sample: returns false when the sample is skipped.
__device__ __forceinline__ bool axis_tap(float c, int size, Tap* t) {
  if (c < -1.0f || c > (float)size) return false;
  c = fmaxf(c, 0.0f);
  int low = (int)floorf(c);
  if (low >= size - 1) {
    t->low = t->high = size - 1;
    t->lw = 0.0f;
  } else {
    t->low = low;
    t->high = low + 1;
    t->lw = c - (float)low;
  }
  t->hw = 1.0f - t->lw;
  return true;
}

// The per-roi sampling geometry. Sample coordinates decide the
// discontinuous skip rule, so they are computed with round-to-nearest
// intrinsics (no FMA contraction) in the plain version's operation order:
// bit-identical positions, shared by K1 and K7.
struct RoiGeom {
  float start_y, start_x, bin_y, bin_x, step_y, step_x, inv_count;
  int gy, gx;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* box,
                                            float spatial_scale, int P,
                                            int bin_stride, int sampling_ratio,
                                            int H, int W) {
  RoiGeom g;
  g.start_y = __fmul_rn(box[0], spatial_scale);
  g.start_x = __fmul_rn(box[1], spatial_scale);
  const float extent_y =
      fmaxf(__fsub_rn(__fmul_rn(box[2], spatial_scale), g.start_y), 1.0f);
  const float extent_x =
      fmaxf(__fsub_rn(__fmul_rn(box[3], spatial_scale), g.start_x), 1.0f);
  const int full = P * bin_stride;
  g.bin_y = __fdiv_rn(extent_y, (float)full);
  g.bin_x = __fdiv_rn(extent_x, (float)full);
  if (sampling_ratio > 0) {
    g.gy = g.gx = sampling_ratio;
  } else {
    const int max_gy = (H + full - 1) / full;
    const int max_gx = (W + full - 1) / full;
    g.gy = min(max((int)ceilf(g.bin_y), 1), max_gy);
    g.gx = min(max((int)ceilf(g.bin_x), 1), max_gx);
  }
  g.step_y = __fdiv_rn(g.bin_y, (float)g.gy);
  g.step_x = __fdiv_rn(g.bin_x, (float)g.gx);
  g.inv_count = 1.0f / (float)(g.gy * g.gx);
  return g;
}

// Origin of bin p (of the computed ones) along one axis.
__device__ __forceinline__ float bin_origin(float start, int p, int bin_stride,
                                            float bin) {
  return __fadd_rn(start, __fmul_rn((float)(p * bin_stride), bin));
}

// Coordinate of sample k of a bin along one axis.
__device__ __forceinline__ float sample_at(float origin, int k, float step) {
  return __fadd_rn(origin, __fmul_rn((float)k + 0.5f, step));
}

template <typename T>
__global__ void roi_align_fwd_kernel(const T* __restrict__ feats,
                                     const float* __restrict__ rois,
                                     T* __restrict__ out, int R, int H, int W,
                                     int C, int P, float spatial_scale,
                                     int sampling_ratio, int bin_stride) {
  const int roi = blockIdx.x;  // image * R + r
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int n = roi / R;
  const RoiGeom g = roi_geom(rois + (size_t)roi * 4, spatial_scale, P,
                             bin_stride, sampling_ratio, H, W);

  const T* f = feats + (size_t)n * H * W * C + c;
  T* o = out + (size_t)roi * P * P * C + c;

  for (int ph = 0; ph < P; ++ph) {
    const float y0 = bin_origin(g.start_y, ph, bin_stride, g.bin_y);
    for (int pw = 0; pw < P; ++pw) {
      const float x0 = bin_origin(g.start_x, pw, bin_stride, g.bin_x);
      float acc = 0.0f;
      for (int iy = 0; iy < g.gy; ++iy) {
        Tap ty;
        if (!axis_tap(sample_at(y0, iy, g.step_y), H, &ty)) continue;
        const T* row_l = f + (size_t)ty.low * W * C;
        const T* row_h = f + (size_t)ty.high * W * C;
        for (int ix = 0; ix < g.gx; ++ix) {
          Tap tx;
          if (!axis_tap(sample_at(x0, ix, g.step_x), W, &tx)) continue;
          const size_t xl = (size_t)tx.low * C;
          const size_t xh = (size_t)tx.high * C;
          acc += ty.hw * (tx.hw * load_f(row_l + xl) +
                          tx.lw * load_f(row_l + xh)) +
                 ty.lw * (tx.hw * load_f(row_h + xl) +
                          tx.lw * load_f(row_h + xh));
        }
      }
      store_f(o + (size_t)(ph * P + pw) * C, acc * g.inv_count);
    }
  }
}

__device__ __forceinline__ void scatter(float* p, float v) {
  if (v != 0.0f) atomicAdd(p, v);
}

template <typename T>
__global__ void roi_align_bwd_kernel(const T* __restrict__ grad_out,
                                     const float* __restrict__ rois,
                                     float* __restrict__ grad_feats, int R,
                                     int H, int W, int C, int P,
                                     float spatial_scale, int sampling_ratio,
                                     int bin_stride) {
  const int roi = blockIdx.x;  // image * R + r
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int n = roi / R;
  const RoiGeom g = roi_geom(rois + (size_t)roi * 4, spatial_scale, P,
                             bin_stride, sampling_ratio, H, W);

  float* f = grad_feats + (size_t)n * H * W * C + c;
  const T* go = grad_out + (size_t)roi * P * P * C + c;

  for (int ph = 0; ph < P; ++ph) {
    const float y0 = bin_origin(g.start_y, ph, bin_stride, g.bin_y);
    for (int pw = 0; pw < P; ++pw) {
      const float d = load_f(go + (size_t)(ph * P + pw) * C) * g.inv_count;
      if (d == 0.0f) continue;
      const float x0 = bin_origin(g.start_x, pw, bin_stride, g.bin_x);
      for (int iy = 0; iy < g.gy; ++iy) {
        Tap ty;
        if (!axis_tap(sample_at(y0, iy, g.step_y), H, &ty)) continue;
        float* row_l = f + (size_t)ty.low * W * C;
        float* row_h = f + (size_t)ty.high * W * C;
        const float dl = d * ty.hw, dh = d * ty.lw;
        for (int ix = 0; ix < g.gx; ++ix) {
          Tap tx;
          if (!axis_tap(sample_at(x0, ix, g.step_x), W, &tx)) continue;
          const size_t xl = (size_t)tx.low * C;
          const size_t xh = (size_t)tx.high * C;
          scatter(row_l + xl, dl * tx.hw);
          scatter(row_l + xh, dl * tx.lw);
          scatter(row_h + xl, dh * tx.hw);
          scatter(row_h + xh, dh * tx.lw);
        }
      }
    }
  }
}

}  // namespace

// feats (N, H, W, C) contiguous, dtype 0 = float32, 1 = bfloat16;
// rois (N, R, 4) float32 contiguous; out (N, R, P, P, C) of the feature type.
// Returns a cudaError_t (0 on success).
extern "C" int mrcnn_roi_align_fwd(const void* feats, const float* rois,
                                   void* out, int dtype, int N, int R, int H,
                                   int W, int C, int P, float spatial_scale,
                                   int sampling_ratio, int bin_stride,
                                   void* stream) {
  if (N * R == 0 || C == 0) return 0;
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  const dim3 grid(N * R, (C + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, threads, 0, s>>>(
        (const float*)feats, rois, (float*)out, R, H, W, C, P, spatial_scale,
        sampling_ratio, bin_stride);
  } else if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        (const __nv_bfloat16*)feats, rois, (__nv_bfloat16*)out, R, H, W, C, P,
        spatial_scale, sampling_ratio, bin_stride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// grad_out (N, R, P, P, C) contiguous, dtype 0 = float32, 1 = bfloat16;
// rois (N, R, 4) float32; grad_feats (N, H, W, C) float32, zeroed by the
// caller, accumulated into. Returns a cudaError_t (0 on success).
extern "C" int mrcnn_roi_align_bwd(const void* grad_out, const float* rois,
                                   float* grad_feats, int dtype, int N, int R,
                                   int H, int W, int C, int P,
                                   float spatial_scale, int sampling_ratio,
                                   int bin_stride, void* stream) {
  if (N * R == 0 || C == 0) return 0;
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  const dim3 grid(N * R, (C + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    roi_align_bwd_kernel<float><<<grid, threads, 0, s>>>(
        (const float*)grad_out, rois, grad_feats, R, H, W, C, P,
        spatial_scale, sampling_ratio, bin_stride);
  } else if (dtype == 1) {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        (const __nv_bfloat16*)grad_out, rois, grad_feats, R, H, W, C, P,
        spatial_scale, sampling_ratio, bin_stride);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
