// K1: Detectron RoIAlign forward on NHWC features with per-image rois, and
// K7: its backward, the features' gradient.
//
// K1 replaces mask_rcnn_tpu/ops/roi_align.py::roi_align_grouped (lines
// 235-301, with _interp_matrix 36-100 and _roi_align_matrices 103-146). The
// JAX package wrote RoIAlign as two einsums over one-hot interpolation
// matrices so that the TPU's matrix unit does the work; on Hopper a gather
// is the natural form.
//
// What bounds K1 on an H100: the bilinear taps' reads, from L2. At the
// slice's shapes (features (1, 52, 84, 1024) bf16 = 8.9 MB, which stays in
// the 50 MB L2) each output value costs 4 * gy * gx taps, ~1.5 GB of tap
// reads at 1000 proposal-like rois; no tensor-core work exists. It replaces
// a one-thread-per-channel kernel, in which a warp's tap was a 64-byte
// request and every thread recomputed the roi's geometry and samples.
// This design, one block per (roi, output row ph):
//   * the block computes the row's sample taps once into shared memory
//     (row index, weight and skip flag per sample row and column, with the
//     position code below, so every skip decision stays bit-identical
//     between K1, K4, K7 and K13);
//   * each thread owns a group of 16 bytes of channels (8 bf16 or 4
//     float32): each tap is one 16-byte load, summed into 8 (4) float32
//     accumulators, and each output one 16-byte store, so a warp's tap is
//     a 512-byte request;
//   * threads walk the row's P bins with the same channel group, and each
//     channel's sum keeps the one-thread-per-channel kernel's order (iy,
//     then ix) and its float32 four-tap expression, with the FMAs written
//     out (bilerp) so that the float32 output stays bit-identical to it.
// A C that is not a multiple of the group (the tests use 70) takes the
// scalar form of the same kernel: each group is read channel by channel and
// the last group holds the C mod 8 (4) tail. The wrapper refuses features
// that are not 16-byte aligned.
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
// K4 and K13 are the same two kernels on flat rois (R, 4) with a per-roi
// image index (R,) int32: K4 replaces mask_rcnn_tpu/ops/roi_align.py::
// roi_align (lines 149-232, the separable matrices with the index * H row
// offset), K13 the autodiff transpose of its einsums. The grouped launch
// passes a null index and the image is roi / R; the flat launch reads the
// image from the index, which its wrapper has checked to lie in [0, N) (the
// kernels also skip any other value, so they never read or write outside
// the features). Same bounds, same design: a roi's image changes nothing of
// the per-thread work.
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
#include <limits.h>
#include <stdint.h>

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

// Samples per bin along an axis: sampling_ratio, else the adaptive grid
// `want` = ceil(bin) clipped to [1, ceil(size / full)] (full = P *
// bin_stride). roi_geom takes it on the device; the forward launcher sizes
// its tap buffer with want = INT_MAX, the most any roi can take.
__host__ __device__ __forceinline__ int grid_size(int want, int size,
                                                  int full,
                                                  int sampling_ratio) {
  if (sampling_ratio > 0) return sampling_ratio;
  const int most = (size + full - 1) / full;
  const int g = want > 1 ? want : 1;
  return g < most ? g : most;
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
  g.gy = grid_size((int)ceilf(g.bin_y), H, full, sampling_ratio);
  g.gx = grid_size((int)ceilf(g.bin_x), W, full, sampling_ratio);
  g.step_y = __fdiv_rn(g.bin_y, (float)g.gy);
  g.step_x = __fdiv_rn(g.bin_x, (float)g.gx);
  g.inv_count = 1.0f / (float)(g.gy * g.gx);
  return g;
}

// The image of a roi: its index in the flat form (K4/K13), else the row of
// the grouped (N, R) layout (K1/K7).
__device__ __forceinline__ int image_of(int roi, const int* roi_idx, int R) {
  return roi_idx ? roi_idx[roi] : roi / R;
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

// A sample's tap in shared memory; low < 0 marks a skipped sample.
__device__ __forceinline__ Tap sample_tap(float c, int size) {
  Tap t;
  if (!axis_tap(c, size, &t)) {
    t.low = t.high = -1;
    t.lw = t.hw = 0.0f;
  }
  return t;
}

// One sample's four taps, ty.hw * (tx.hw * ll + tx.lw * lh) +
// ty.lw * (tx.hw * hl + tx.lw * hh), with the FMA contraction that nvcc gave
// the float32 one-thread-per-channel kernel, written out so that no
// compiler choice changes a bit.
__device__ __forceinline__ float bilerp(const Tap& ty, const Tap& tx,
                                        float ll, float lh, float hl,
                                        float hh) {
  const float top = __fmaf_rn(tx.lw, lh, __fmul_rn(tx.hw, ll));
  const float bottom = __fmaf_rn(tx.hw, hl, __fmul_rn(tx.lw, hh));
  return __fmaf_rn(ty.hw, top, __fmul_rn(ty.lw, bottom));
}

// A group of kVec = 16 / sizeof(T) channels: one 16-byte load or store, or
// (kVector false) nc <= kVec scalar ones.
template <typename T>
struct Group {
  static constexpr int kVec = 16 / (int)sizeof(T);
};

template <bool kVector>
__device__ __forceinline__ void load_group(const float* p, float* v, int nc) {
  if (kVector) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < nc ? __ldg(p + e) : 0.0f;
  }
}

template <bool kVector>
__device__ __forceinline__ void load_group(const __nv_bfloat16* p, float* v,
                                           int nc) {
  if (kVector) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      v[2 * e] = f.x;
      v[2 * e + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = e < nc ? load_f(p + e) : 0.0f;
  }
}

template <bool kVector>
__device__ __forceinline__ void store_group(float* p, const float* v,
                                            int nc) {
  if (kVector) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int e = 0; e < nc; ++e) p[e] = v[e];
  }
}

template <bool kVector>
__device__ __forceinline__ void store_group(__nv_bfloat16* p, const float* v,
                                            int nc) {
  if (kVector) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    }
    *reinterpret_cast<uint4*>(p) = x;
  } else {
    for (int e = 0; e < nc; ++e) store_f(p + e, v[e]);
  }
}

constexpr int kFwdThreads = 256;

// K1/K4. grid (rois, P): block (roi, ph) computes output row ph of one roi.
// Dynamic shared memory: max_gy y taps, then P * max_gx x taps.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kFwdThreads)
roi_align_fwd_kernel(const T* __restrict__ feats,
                     const float* __restrict__ rois,
                     const int* __restrict__ roi_idx, T* __restrict__ out,
                     int N, int R, int H, int W, int C, int P,
                     float spatial_scale, int sampling_ratio, int bin_stride,
                     int max_gy) {
  constexpr int kVec = Group<T>::kVec;
  extern __shared__ Tap taps[];
  const int roi = blockIdx.x;  // grouped: image * R + r; flat: r
  const int ph = blockIdx.y;
  const int groups = (C + kVec - 1) / kVec;
  T* o = out + ((size_t)roi * P + ph) * P * C;
  const int n = image_of(roi, roi_idx, R);
  if (n < 0 || n >= N) {  // the wrapper refuses such an index; never read
    for (int i = threadIdx.x; i < P * C; i += blockDim.x) store_f(o + i, 0.0f);
    return;
  }
  const RoiGeom g = roi_geom(rois + (size_t)roi * 4, spatial_scale, P,
                             bin_stride, sampling_ratio, H, W);
  Tap* sy = taps;
  Tap* sx = taps + max_gy;
  const float y0 = bin_origin(g.start_y, ph, bin_stride, g.bin_y);
  for (int i = threadIdx.x; i < g.gy; i += blockDim.x) {
    sy[i] = sample_tap(sample_at(y0, i, g.step_y), H);
  }
  for (int i = threadIdx.x; i < P * g.gx; i += blockDim.x) {
    const int pw = i / g.gx;
    const float x0 = bin_origin(g.start_x, pw, bin_stride, g.bin_x);
    sx[i] = sample_tap(sample_at(x0, i - pw * g.gx, g.step_x), W);
  }
  __syncthreads();

  const size_t row = (size_t)W * C;
  const T* f = feats + (size_t)n * H * row;
  for (int item = threadIdx.x; item < P * groups; item += blockDim.x) {
    const int pw = item / groups;
    const int c0 = (item - pw * groups) * kVec;
    const int nc = min(kVec, C - c0);
    float acc[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
    for (int iy = 0; iy < g.gy; ++iy) {
      const Tap ty = sy[iy];
      if (ty.low < 0) continue;
      const T* row_l = f + ty.low * row + c0;
      const T* row_h = f + ty.high * row + c0;
      for (int ix = 0; ix < g.gx; ++ix) {
        const Tap tx = sx[pw * g.gx + ix];
        if (tx.low < 0) continue;
        const size_t xl = (size_t)tx.low * C;
        const size_t xh = (size_t)tx.high * C;
        float ll[kVec], lh[kVec], hl[kVec], hh[kVec];
        load_group<kVector>(row_l + xl, ll, nc);
        load_group<kVector>(row_l + xh, lh, nc);
        load_group<kVector>(row_h + xl, hl, nc);
        load_group<kVector>(row_h + xh, hh, nc);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          acc[e] = __fadd_rn(acc[e], bilerp(ty, tx, ll[e], lh[e], hl[e],
                                            hh[e]));
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] *= g.inv_count;
    store_group<kVector>(o + (size_t)pw * C + c0, acc, nc);
  }
}

__device__ __forceinline__ void scatter(float* p, float v) {
  if (v != 0.0f) atomicAdd(p, v);
}

template <typename T>
__global__ void roi_align_bwd_kernel(const T* __restrict__ grad_out,
                                     const float* __restrict__ rois,
                                     const int* __restrict__ roi_idx,
                                     float* __restrict__ grad_feats, int N,
                                     int R, int H, int W, int C, int P,
                                     float spatial_scale, int sampling_ratio,
                                     int bin_stride) {
  const int roi = blockIdx.x;  // grouped: image * R + r; flat: r
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int n = image_of(roi, roi_idx, R);
  if (n < 0 || n >= N) return;  // refused by the wrapper; never written
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

template <typename T, bool kVector>
int launch_fwd_t(const void* feats, const float* rois, const int* roi_idx,
                 void* out, int N, int R, int blocks, int H, int W, int C,
                 int P, float spatial_scale, int sampling_ratio,
                 int bin_stride, cudaStream_t s) {
  const int groups = (C + Group<T>::kVec - 1) / Group<T>::kVec;
  // threads = channel groups (each thread keeps its group across the row's
  // bins), or the whole row's (bin, group) items when groups are few
  const int want = (groups >= 32 ? groups : P * groups) + 31;
  const int threads = want / 32 * 32 < kFwdThreads ? want / 32 * 32
                                                   : kFwdThreads;
  const int max_gy = grid_size(INT_MAX, H, P * bin_stride, sampling_ratio);
  const int max_gx = grid_size(INT_MAX, W, P * bin_stride, sampling_ratio);
  const size_t smem = (size_t)(max_gy + P * max_gx) * sizeof(Tap);
  auto kernel = roi_align_fwd_kernel<T, kVector>;
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  kernel<<<dim3(blocks, P), threads, smem, s>>>(
      (const T*)feats, rois, roi_idx, (T*)out, N, R, H, W, C, P,
      spatial_scale, sampling_ratio, bin_stride, max_gy);
  return (int)cudaGetLastError();
}

// The 16-byte form when every pixel's channels start on a 16-byte boundary
// (C a multiple of the group, aligned base pointers), else the scalar form.
template <typename T>
int launch_fwd(const void* feats, const float* rois, const int* roi_idx,
               void* out, int N, int R, int blocks, int H, int W, int C,
               int P, float spatial_scale, int sampling_ratio,
               int bin_stride, cudaStream_t s) {
  if (((uintptr_t)feats | (uintptr_t)out) % 16) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (C % Group<T>::kVec == 0) {
    return launch_fwd_t<T, true>(feats, rois, roi_idx, out, N, R, blocks, H,
                                 W, C, P, spatial_scale, sampling_ratio,
                                 bin_stride, s);
  }
  return launch_fwd_t<T, false>(feats, rois, roi_idx, out, N, R, blocks, H,
                                W, C, P, spatial_scale, sampling_ratio,
                                bin_stride, s);
}

template <typename T>
void launch_bwd(const void* grad_out, const float* rois, const int* roi_idx,
                float* grad_feats, int N, int R, int blocks, int H, int W,
                int C, int P, float spatial_scale, int sampling_ratio,
                int bin_stride, cudaStream_t s) {
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  const dim3 grid(blocks, (C + threads - 1) / threads);
  roi_align_bwd_kernel<T><<<grid, threads, 0, s>>>(
      (const T*)grad_out, rois, roi_idx, grad_feats, N, R, H, W, C, P,
      spatial_scale, sampling_ratio, bin_stride);
}

int fwd(const void* feats, const float* rois, const int* roi_idx, void* out,
        int dtype, int N, int R, int blocks, int H, int W, int C, int P,
        float spatial_scale, int sampling_ratio, int bin_stride,
        void* stream) {
  if (blocks == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_fwd<float>(feats, rois, roi_idx, out, N, R, blocks, H, W, C,
                             P, spatial_scale, sampling_ratio, bin_stride, s);
  }
  if (dtype == 1) {
    return launch_fwd<__nv_bfloat16>(feats, rois, roi_idx, out, N, R, blocks,
                                     H, W, C, P, spatial_scale,
                                     sampling_ratio, bin_stride, s);
  }
  return (int)cudaErrorInvalidValue;
}

int bwd(const void* grad_out, const float* rois, const int* roi_idx,
        float* grad_feats, int dtype, int N, int R, int blocks, int H, int W,
        int C, int P, float spatial_scale, int sampling_ratio, int bin_stride,
        void* stream) {
  if (blocks == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    launch_bwd<float>(grad_out, rois, roi_idx, grad_feats, N, R, blocks, H,
                      W, C, P, spatial_scale, sampling_ratio, bin_stride, s);
  } else if (dtype == 1) {
    launch_bwd<__nv_bfloat16>(grad_out, rois, roi_idx, grad_feats, N, R,
                              blocks, H, W, C, P, spatial_scale,
                              sampling_ratio, bin_stride, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K1: feats (N, H, W, C) contiguous and 16-byte aligned, dtype 0 = float32,
// 1 = bfloat16; rois (N, R, 4) float32 contiguous; out (N, R, P, P, C) of
// the feature type, 16-byte aligned. Returns a cudaError_t (0 on success).
extern "C" int mrcnn_roi_align_fwd(const void* feats, const float* rois,
                                   void* out, int dtype, int N, int R, int H,
                                   int W, int C, int P, float spatial_scale,
                                   int sampling_ratio, int bin_stride,
                                   void* stream) {
  return fwd(feats, rois, nullptr, out, dtype, N, R, N * R, H, W, C, P,
             spatial_scale, sampling_ratio, bin_stride, stream);
}

// K7: grad_out (N, R, P, P, C) contiguous, dtype 0 = float32, 1 = bfloat16;
// rois (N, R, 4) float32; grad_feats (N, H, W, C) float32, zeroed by the
// caller, accumulated into. Returns a cudaError_t (0 on success).
extern "C" int mrcnn_roi_align_bwd(const void* grad_out, const float* rois,
                                   float* grad_feats, int dtype, int N, int R,
                                   int H, int W, int C, int P,
                                   float spatial_scale, int sampling_ratio,
                                   int bin_stride, void* stream) {
  return bwd(grad_out, rois, nullptr, grad_feats, dtype, N, R, N * R, H, W,
             C, P, spatial_scale, sampling_ratio, bin_stride, stream);
}

// K4: the flat form. rois (R, 4) float32 and roi_idx (R,) int32 in [0, N)
// (checked by the wrapper), both contiguous; out (R, P, P, C).
extern "C" int mrcnn_roi_align_flat_fwd(const void* feats, const float* rois,
                                        const int* roi_idx, void* out,
                                        int dtype, int N, int R, int H, int W,
                                        int C, int P, float spatial_scale,
                                        int sampling_ratio, int bin_stride,
                                        void* stream) {
  return fwd(feats, rois, roi_idx, out, dtype, N, R, R, H, W, C, P,
             spatial_scale, sampling_ratio, bin_stride, stream);
}

// K13: the flat form's backward. grad_out (R, P, P, C); rois and roi_idx as
// for K4; grad_feats (N, H, W, C) float32, zeroed, accumulated into.
extern "C" int mrcnn_roi_align_flat_bwd(const void* grad_out,
                                        const float* rois, const int* roi_idx,
                                        float* grad_feats, int dtype, int N,
                                        int R, int H, int W, int C, int P,
                                        float spatial_scale,
                                        int sampling_ratio, int bin_stride,
                                        void* stream) {
  return bwd(grad_out, rois, roi_idx, grad_feats, dtype, N, R, R, H, W, C, P,
             spatial_scale, sampling_ratio, bin_stride, stream);
}
