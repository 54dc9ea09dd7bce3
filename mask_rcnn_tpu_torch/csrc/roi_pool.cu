// The reference's alternate RoI poolers on flat rois (R, 4) with per-roi
// batch indices (R,), on NHWC features, forward and backward:
//
//   K5  crop_resize_fwd_kernel: integer crop + align-corners bilinear resize,
//       replaces mask_rcnn_tpu/ops/roi_align.py::crop_and_resize (304-378);
//   K11 crop_resize_bwd_kernel: its transpose (the autodiff of those einsums);
//   K6  roi_pool_fwd_kernel: chainer's quantized max RoI pooling, replaces
//       mask_rcnn_tpu/ops/roi_align.py::roi_pool (381-479);
//   K12 roi_pool_bwd_kernel: jax.grad of roi_pool's chained maxima.
//
// The JAX package wrote K5 as two einsums over one-hot interpolation
// matrices and K6 as static loops of gathers and jnp.maximum, so that the
// TPU's matrix and vector units do the work; on Hopper both are gathers.
// Every kernel runs one block per (roi, output row) and channel tile, one
// thread per channel, so that a warp reads 32 neighbouring channels of one
// NHWC tap; each thread walks the row's P cells. A block per output cell
// would mean ~0.8 M blocks of a few loads each at 1000 rois, bound by block
// scheduling (PERF.md).
//
// What bounds them on an H100: memory traffic. At the slice's shapes the
// features ((1 or 2, 52, 84, 1024) bf16, 9-18 MB) stay in the 50 MB L2;
// K5 reads four taps per output value, K6 a bin of at most
// (ceil(H/P)+1) x (ceil(W/P)+1) values, and both write (R, 14, 14, 1024)
// (0.4 GB in bf16 at R = 1000), which is most of their device-memory bytes.
// K11 and K12 scatter float32 atomicAdds into an (N, H, W, C) buffer that
// also stays in L2 (36 MB at the train shape); a zero gradient (3/4 of the
// cells under res5's stride-2 1x1 convs) returns before any work. The sums'
// order follows the atomics', so their last bits vary from run to run; the
// wrapper casts the buffer to the feature type at the end.
//
// Bit-exact positions: the crop, the sample coordinates and the bin bounds
// feed floor/ceil, so they use round-to-nearest intrinsics (no FMA
// contraction) in the plain version's operation order, rintf (half to
// even, as jnp.round; roundf would round half away from zero) and true
// divisions (__fdiv_rn).
//
// K12 reproduces jax.grad, not chainer's argmax rule: the JAX function takes
// the max over rows first (for every column), then over columns, each as a
// chain acc = max(acc, v) from -inf, and lax.max splits a tie's gradient in
// half. For a chain whose maximum ties at positions i1 < ... < im the
// weights are 2^-(m-1) for i1, and 2^-(m-k+1) for ik, k >= 2 (1 when m = 1).
// A feature gets g * (its column's weight among the bin's column maxima) *
// (its weight among its column's rows), summed over every bin that reads
// it. Relu'd features hold many exact zeros, so ties are common.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Output row (roi, py) of this block and the thread's channel; the row's
// cells (roi, py, px, c) sit at (blockIdx.x * P + px) * C + c.
struct Row {
  int roi, py, c;
};

__device__ __forceinline__ Row this_row(int P) {
  Row k;
  k.roi = blockIdx.x / P;
  k.py = blockIdx.x % P;
  k.c = blockIdx.y * blockDim.x + threadIdx.x;
  return k;
}

// ---------------------------------------------------------------- K5 / K11

struct Tap {
  int low, high;
  float lw, hw;
};

// Sample i of P along one axis (roi_align.py:327-338): the crop
// [lo, hi) = [rint(s*y1), max(rint(s*y2), lo+1)), samples at
// lo + i * (crop - 1) / max(P - 1, 1) clipped to [0, size - 1].
__device__ __forceinline__ Tap crop_tap(float box_lo, float box_hi,
                                        float scale, int i, int P, int size) {
  const float lo = rintf(__fmul_rn(box_lo, scale));
  const float hi = fmaxf(rintf(__fmul_rn(box_hi, scale)), __fadd_rn(lo, 1.0f));
  const float step =
      __fdiv_rn(__fsub_rn(__fsub_rn(hi, lo), 1.0f), (float)max(P - 1, 1));
  float c = __fadd_rn(lo, __fmul_rn((float)i, step));
  c = fminf(fmaxf(c, 0.0f), (float)(size - 1));
  Tap t;
  t.low = min((int)floorf(c), size - 1);
  t.high = min(t.low + 1, size - 1);
  t.lw = __fsub_rn(c, (float)t.low);
  t.hw = __fsub_rn(1.0f, t.lw);
  return t;
}

template <typename T>
__global__ void crop_resize_fwd_kernel(const T* __restrict__ feats,
                                       const float* __restrict__ rois,
                                       const int* __restrict__ idx,
                                       T* __restrict__ out, int N, int H,
                                       int W, int C, int P, float scale) {
  const Row k = this_row(P);
  if (k.c >= C) return;
  const float* box = rois + (size_t)k.roi * 4;
  const int n = idx[k.roi];
  T* o = out + (size_t)blockIdx.x * P * C + k.c;
  if (n < 0 || n >= N) {  // a roi of another image's index pools zeros
    for (int px = 0; px < P; ++px) store_f(o + (size_t)px * C, 0.0f);
    return;
  }
  const Tap ty = crop_tap(box[0], box[2], scale, k.py, P, H);
  const T* f = feats + (size_t)n * H * W * C + k.c;
  const T* rl = f + (size_t)ty.low * W * C;
  const T* rh = f + (size_t)ty.high * W * C;
  for (int px = 0; px < P; ++px) {
    const Tap tx = crop_tap(box[1], box[3], scale, px, P, W);
    const size_t xl = (size_t)tx.low * C, xh = (size_t)tx.high * C;
    // y first, then x: the plain version's einsum order
    const float acc =
        tx.hw * (ty.hw * load_f(rl + xl) + ty.lw * load_f(rh + xl)) +
        tx.lw * (ty.hw * load_f(rl + xh) + ty.lw * load_f(rh + xh));
    store_f(o + (size_t)px * C, acc);
  }
}

__device__ __forceinline__ void scatter(float* p, float v) {
  if (v != 0.0f) atomicAdd(p, v);
}

template <typename T>
__global__ void crop_resize_bwd_kernel(const T* __restrict__ grad_out,
                                       const float* __restrict__ rois,
                                       const int* __restrict__ idx,
                                       float* __restrict__ grad_feats, int N,
                                       int H, int W, int C, int P,
                                       float scale) {
  const Row k = this_row(P);
  if (k.c >= C) return;
  const int n = idx[k.roi];
  if (n < 0 || n >= N) return;
  const float* box = rois + (size_t)k.roi * 4;
  const T* go = grad_out + (size_t)blockIdx.x * P * C + k.c;
  const Tap ty = crop_tap(box[0], box[2], scale, k.py, P, H);
  float* f = grad_feats + (size_t)n * H * W * C + k.c;
  float* rl = f + (size_t)ty.low * W * C;
  float* rh = f + (size_t)ty.high * W * C;
  for (int px = 0; px < P; ++px) {
    const float g = load_f(go + (size_t)px * C);
    if (g == 0.0f) continue;
    const Tap tx = crop_tap(box[1], box[3], scale, px, P, W);
    const size_t xl = (size_t)tx.low * C, xh = (size_t)tx.high * C;
    const float gl = g * tx.hw, gh = g * tx.lw;
    // at the border low == high: both taps land on one row and add up to
    // weight 1, as the one-hot matrix's sum does
    scatter(rl + xl, gl * ty.hw);
    scatter(rh + xl, gl * ty.lw);
    scatter(rl + xh, gh * ty.hw);
    scatter(rh + xh, gh * ty.lw);
  }
}

// ---------------------------------------------------------------- K6 / K12

// Bin p of P along one axis (roi_align.py:404-414, 441-449): [start, end)
// with start = floor(p * stride) + lo, end = ceil((p + 1) * stride) + lo,
// stride = max(hi - lo + 1, 1) / P, clipped to [0, size]; the JAX loop reads
// at most smax = ceil(size / P) + 1 rows of a bin.
__device__ __forceinline__ void pool_bin(float box_lo, float box_hi,
                                         float scale, int p, int P, int size,
                                         int* start, int* end) {
  const float lo = rintf(__fmul_rn(box_lo, scale));
  const float hi = rintf(__fmul_rn(box_hi, scale));
  const float extent = fmaxf(__fadd_rn(__fsub_rn(hi, lo), 1.0f), 1.0f);
  const float stride = __fdiv_rn(extent, (float)P);
  float s = __fadd_rn(floorf(__fmul_rn((float)p, stride)), lo);
  float e = __fadd_rn(ceilf(__fmul_rn((float)(p + 1), stride)), lo);
  s = fminf(fmaxf(s, 0.0f), (float)size);
  e = fminf(fmaxf(e, 0.0f), (float)size);
  const int smax = (size + P - 1) / P + 1;
  *start = (int)s;
  *end = min((int)e, *start + smax);
}

template <typename T>
__global__ void roi_pool_fwd_kernel(const T* __restrict__ feats,
                                    const float* __restrict__ rois,
                                    const int* __restrict__ idx,
                                    T* __restrict__ out, int N, int H, int W,
                                    int C, int P, float scale) {
  const Row k = this_row(P);
  if (k.c >= C) return;
  const float* box = rois + (size_t)k.roi * 4;
  const int n = idx[k.roi];
  T* o = out + (size_t)blockIdx.x * P * C + k.c;
  int ys = 0, ye = 0;  // a roi of another image's index pools zeros
  if (n >= 0 && n < N) pool_bin(box[0], box[2], scale, k.py, P, H, &ys, &ye);
  const T* f = feats + (size_t)max(n, 0) * H * W * C + k.c;
  for (int px = 0; px < P; ++px) {
    int xs, xe;
    pool_bin(box[1], box[3], scale, px, P, W, &xs, &xe);
    float m = -INFINITY;
    for (int y = ys; y < ye; ++y) {
      const T* row = f + (size_t)y * W * C;
      for (int x = xs; x < xe; ++x) m = fmaxf(m, load_f(row + (size_t)x * C));
    }
    // an empty bin gives 0
    store_f(o + (size_t)px * C, isfinite(m) ? m : 0.0f);
  }
}

// Weight of the k-th (1-based, in loop order) of m tied positions of one
// chain of pairwise maxima that split ties in half.
__device__ __forceinline__ float tie_weight(int k, int m) {
  return ldexpf(1.0f, k == 1 ? 1 - m : k - m - 1);
}

// Max over rows [ys, ye) of one column, and how many rows reach it.
template <typename T>
__device__ __forceinline__ float column_max(const T* col, size_t row_stride,
                                            int ys, int ye, int* count) {
  float m = -INFINITY;
  int cnt = 0;
  for (int y = ys; y < ye; ++y) {
    const float v = load_f(col + (size_t)y * row_stride);
    if (v > m) {
      m = v;
      cnt = 1;
    } else if (v == m) {
      ++cnt;
    }
  }
  *count = cnt;
  return m;
}

// One bin's share of K12: g times the tie weight of each position that
// reaches the bin's max, rows [ys, ye) and columns [xs, xe).
template <typename T>
__device__ __forceinline__ void pool_bin_grad(const T* f, float* df,
                                              size_t row_stride, int C,
                                              int ys, int ye, int xs, int xe,
                                              float g) {
  // the bin's max over the column maxima, and how many columns reach it
  float m = -INFINITY;
  int mc = 0;
  for (int x = xs; x < xe; ++x) {
    int cnt;
    const float cm = column_max(f + (size_t)x * C, row_stride, ys, ye, &cnt);
    if (cm > m) {
      m = cm;
      mc = 1;
    } else if (cm == m) {
      ++mc;
    }
  }
  if (!isfinite(m)) return;  // empty bin: the output is 0, no gradient

  int kc = 0;
  for (int x = xs; x < xe; ++x) {
    const T* col = f + (size_t)x * C;
    int mr;
    if (column_max(col, row_stride, ys, ye, &mr) != m) continue;
    const float gc = g * tie_weight(++kc, mc);
    int kr = 0;
    for (int y = ys; y < ye; ++y) {
      if (load_f(col + (size_t)y * row_stride) == m) {
        atomicAdd(df + (size_t)y * row_stride + (size_t)x * C,
                  gc * tie_weight(++kr, mr));
      }
    }
  }
}

template <typename T>
__global__ void roi_pool_bwd_kernel(const T* __restrict__ grad_out,
                                    const T* __restrict__ feats,
                                    const float* __restrict__ rois,
                                    const int* __restrict__ idx,
                                    float* __restrict__ grad_feats, int N,
                                    int H, int W, int C, int P, float scale) {
  const Row k = this_row(P);
  if (k.c >= C) return;
  const int n = idx[k.roi];
  if (n < 0 || n >= N) return;
  const float* box = rois + (size_t)k.roi * 4;
  const T* go = grad_out + (size_t)blockIdx.x * P * C + k.c;
  int ys, ye;
  pool_bin(box[0], box[2], scale, k.py, P, H, &ys, &ye);
  const size_t row_stride = (size_t)W * C;
  const T* f = feats + (size_t)n * H * W * C + k.c;
  float* df = grad_feats + (size_t)n * H * W * C + k.c;
  for (int px = 0; px < P; ++px) {
    const float g = load_f(go + (size_t)px * C);
    if (g == 0.0f) continue;
    int xs, xe;
    pool_bin(box[1], box[3], scale, px, P, W, &xs, &xe);
    pool_bin_grad(f, df, row_stride, C, ys, ye, xs, xe, g);
  }
}

int threads_for(int C) { return C >= 256 ? 256 : ((C + 31) / 32) * 32; }

}  // namespace

// Every entry point: rois (R, 4) float32 contiguous (y1, x1, y2, x2) in
// image coordinates, idx (R,) int32 batch indices, features (N, H, W, C)
// contiguous, dtype 0 = float32, 1 = bfloat16; pooled tensors
// (R, P, P, C) of that dtype; gradient buffers (N, H, W, C) float32, zeroed
// by the caller and accumulated into. Each returns a cudaError_t (0 on
// success).

#define MRCNN_DISPATCH(KERNEL, ...)                                         \
  if (N * R == 0 || C == 0) return 0;                                       \
  const int threads = threads_for(C);                                       \
  const dim3 grid(R * P, (C + threads - 1) / threads);                      \
  cudaStream_t s = (cudaStream_t)stream;                                    \
  if (dtype == 0) {                                                         \
    using T = float;                                                        \
    KERNEL<T><<<grid, threads, 0, s>>>(__VA_ARGS__);                        \
  } else if (dtype == 1) {                                                  \
    using T = __nv_bfloat16;                                                \
    KERNEL<T><<<grid, threads, 0, s>>>(__VA_ARGS__);                        \
  } else {                                                                  \
    return (int)cudaErrorInvalidValue;                                      \
  }                                                                         \
  return (int)cudaGetLastError();

extern "C" int mrcnn_crop_resize_fwd(const void* feats, const float* rois,
                                     const int* idx, void* out, int dtype,
                                     int N, int R, int H, int W, int C, int P,
                                     float scale, void* stream) {
  MRCNN_DISPATCH(crop_resize_fwd_kernel, (const T*)feats, rois, idx, (T*)out,
                 N, H, W, C, P, scale)
}

extern "C" int mrcnn_crop_resize_bwd(const void* grad_out, const float* rois,
                                     const int* idx, float* grad_feats,
                                     int dtype, int N, int R, int H, int W,
                                     int C, int P, float scale, void* stream) {
  MRCNN_DISPATCH(crop_resize_bwd_kernel, (const T*)grad_out, rois, idx,
                 grad_feats, N, H, W, C, P, scale)
}

extern "C" int mrcnn_roi_pool_fwd(const void* feats, const float* rois,
                                  const int* idx, void* out, int dtype, int N,
                                  int R, int H, int W, int C, int P,
                                  float scale, void* stream) {
  MRCNN_DISPATCH(roi_pool_fwd_kernel, (const T*)feats, rois, idx, (T*)out, N,
                 H, W, C, P, scale)
}

extern "C" int mrcnn_roi_pool_bwd(const void* grad_out, const void* feats,
                                  const float* rois, const int* idx,
                                  float* grad_feats, int dtype, int N, int R,
                                  int H, int W, int C, int P, float scale,
                                  void* stream) {
  MRCNN_DISPATCH(roi_pool_bwd_kernel, (const T*)grad_out, (const T*)feats,
                 rois, idx, grad_feats, N, H, W, C, P, scale)
}
