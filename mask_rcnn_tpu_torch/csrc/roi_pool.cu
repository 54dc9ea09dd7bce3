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
// K5, K11 and K6 run one block per (roi, output row) and channel tile, one
// thread per channel, so that a warp reads 32 neighbouring channels of one
// NHWC tap; each thread walks the row's P cells. A block per output cell
// would mean ~0.8 M blocks of a few loads each at 1000 rois, bound by block
// scheduling (PERF.md). K12 (redesigned) keeps the block per (roi, output
// row) but gives each thread 16 bytes of channels and reads each feature
// of the row's bins once (see roi_pool_bwd_kernel).
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
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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

// 2^e as a float, e in [-126, 127], from its exponent bits.
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((127 + e) << 23);
}

// The tie weights of one chain of pairwise maxima that split ties in half,
// in loop order: m tied positions get 2^(1-m), 2^(1-m), 2^(2-m), ..., 1/2
// (1 when m = 1). next() returns the next position's weight.
struct TieWeights {
  float w = 1.0f;
  int k = 1;
  TieWeights() = default;
  __device__ explicit TieWeights(int m) : w(pow2f(1 - m)) {}
  __device__ float next() {
    const float out = w;
    if (k++ >= 2) w *= 2.0f;
    return out;
  }
};

// V channels of T as one load: 16 bytes (8 bf16 or 4 float32) when V > 1,
// else one scalar; unpack() turns them into floats.
template <typename T, int V>
struct Vec {
  using Raw = typename std::conditional<
      V == 1, T, typename std::conditional<sizeof(T) == 4, float4,
                                           uint4>::type>::type;
  static_assert(V == 1 || V * sizeof(T) == 16, "16-byte vectors");

  __device__ static __forceinline__ Raw load(const T* p) {
    if constexpr (V == 1) {
      return *p;
    } else {
      return __ldg(reinterpret_cast<const Raw*>(p));
    }
  }

  __device__ static __forceinline__ void unpack(const Raw& r,
                                                float (&v)[V]) {
    if constexpr (V == 1 && sizeof(T) == 4) {
      v[0] = r;
    } else if constexpr (V == 1) {
      v[0] = __bfloat162float(r);
    } else if constexpr (sizeof(T) == 4) {
      v[0] = r.x;
      v[1] = r.y;
      v[2] = r.z;
      v[3] = r.w;
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    }
  }
};

template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  Vec<T, V>::unpack(Vec<T, V>::load(p), v);
}

// V float32 sums into the gradient buffer: float4 atomics (Hopper's vector
// atomic) when V > 1, sums of 0 not issued.
template <int V>
__device__ __forceinline__ void scatter_vec(float* p, const float (&a)[V]) {
  if constexpr (V == 1) {
    if (a[0] != 0.0f) atomicAdd(p, a[0]);
  } else {
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      if (a[q] != 0.0f || a[q + 1] != 0.0f || a[q + 2] != 0.0f ||
          a[q + 3] != 0.0f) {
        atomicAdd(reinterpret_cast<float4*>(p + q),
                  make_float4(a[q], a[q + 1], a[q + 2], a[q + 3]));
      }
    }
  }
}

// K12. One block per (roi, py) row of bins and channel tile; a thread owns
// V adjacent channels (16 bytes of features). All bins of the row share the
// rows [ys, ye) (at most ceil(H/P) + 1 <= 32 of them), and a column x of
// those rows has one max over them and one set of tied rows, whichever bin
// reads it. So the thread walks the row's bins px in order and computes
// each column once, reading its features once: the column max and the
// bitmask of rows that reach it go to a ring of `ring` = ceil(W/P) + 1
// column slots in shared memory (bins are monotone in px and at most that
// wide, so a bin's columns are all in the ring). From those, a bin's max,
// its tied columns and their weights need no feature; each tied column
// adds g * its column weight to the column's coefficient G. When no later
// bin can read a column (x < the next bin's start, or the row ends) it is
// flushed: G times each tied row's weight, one vector atomic per (row,
// column), so the column two bins share gets one atomic per row, not two.
// A bin whose gradient is zero is skipped before it reads a feature, so a
// thread whose gradient row is all zero (every odd py under res5's
// stride-2 1x1 convs, which leave 3/4 of the cells without gradient) reads
// none; each bin's gradient is loaded one bin ahead. A column's rows are loaded kRowBatch at a time
// before any compare, so that a thread keeps that many 16-byte loads in
// flight (a block holds few threads: the ring's shared memory bounds it).
// Shared memory: three arrays [ring][V][threads] (G float32, the column
// max in the feature type, the row mask in 8 bits when bins have at most 8
// rows), thread-private, so no barrier.
constexpr int kRowBatch = 8;

template <typename T, int V, typename M>
__global__ void __launch_bounds__(64)
roi_pool_bwd_kernel(const T* __restrict__ grad_out,
                    const T* __restrict__ feats,
                    const float* __restrict__ rois,
                    const int* __restrict__ idx,
                    float* __restrict__ grad_feats, int N, int H, int W,
                    int C, int P, float scale, int ring) {
  extern __shared__ float pool_smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const int roi = blockIdx.x / P, py = blockIdx.x % P;
  const int c0 = (blockIdx.y * threads + tid) * V;
  if (c0 >= C) return;
  const int n = idx[roi];
  if (n < 0 || n >= N) return;
  const float* box = rois + (size_t)roi * 4;
  int ys, ye;
  pool_bin(box[0], box[2], scale, py, P, H, &ys, &ye);
  if (ys >= ye) return;  // empty bins: the output is 0, no gradient

  const T* go = grad_out + (size_t)blockIdx.x * P * C + c0;
  const size_t row_stride = (size_t)W * C;
  const T* f = feats + (size_t)n * H * W * C + c0;
  float* df = grad_feats + (size_t)n * H * W * C + c0;
  // the column max is a feature value: exact in T
  float* s_g = pool_smem;
  T* s_max = reinterpret_cast<T*>(s_g + ring * V * threads);
  M* s_rows = reinterpret_cast<M*>(s_max + ring * V * threads);
  // column x's entry for channel j: slot(x) + j * threads
  const auto slot = [&](int x) { return (x % ring) * V * threads + tid; };

  // Columns [lo, hi) are in the ring, waiting for their atomics: G times
  // each tied row's weight, rows in order, one vector atomic per row that
  // any of the V channels reaches.
  const auto flush = [&](int x0, int x1) {
    for (int x = x0; x < x1; ++x) {
      const int e = slot(x);
      float gx[V];
      uint32_t rows[V], todo = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        gx[j] = s_g[e + j * threads];
        rows[j] = gx[j] != 0.0f ? s_rows[e + j * threads] : 0u;
        todo |= rows[j];
      }
      if (!todo) continue;
      TieWeights wr[V] = {};
#pragma unroll
      for (int j = 0; j < V; ++j) wr[j] = TieWeights(__popc(rows[j]));
      while (todo) {
        const int r = __ffs(todo) - 1;
        todo &= todo - 1;
        float a[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a[j] = (rows[j] >> r) & 1u ? gx[j] * wr[j].next() : 0.0f;
        }
        scatter_vec<V>(df + (size_t)(ys + r) * row_stride + (size_t)x * C,
                       a);
      }
    }
  };

  // A zero gradient row reads no feature: every bin is skipped. Each bin's
  // gradient is loaded one bin ahead.
  float g_next[V];
  load_vec<V>(go, g_next);
  int lo = 0, hi = 0;
  for (int px = 0; px < P; ++px) {
    float g[V];
    bool live = false;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      g[j] = g_next[j];
      live |= g[j] != 0.0f;
    }
    if (px + 1 < P) load_vec<V>(go + (size_t)(px + 1) * C, g_next);
    if (!live) continue;
    int xs, xe;
    pool_bin(box[1], box[3], scale, px, P, W, &xs, &xe);
    if (xs >= xe) continue;
    flush(lo, min(hi, xs));
    lo = xs;
    if (hi < xs) hi = xs;
    for (int x = hi; x < xe; ++x) {  // the bin's new columns, read once
      float cm[V];
      uint32_t rows[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        cm[j] = -INFINITY;
        rows[j] = 0;
      }
      // kRowBatch rows' loads in flight at once, then their compares
      for (int y0 = ys; y0 < ye; y0 += kRowBatch) {
        typename Vec<T, V>::Raw raw[kRowBatch];
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) {
          if (y0 + u < ye) {
            raw[u] = Vec<T, V>::load(f + (size_t)(y0 + u) * row_stride +
                                     (size_t)x * C);
          }
        }
#pragma unroll
        for (int u = 0; u < kRowBatch; ++u) {
          if (y0 + u >= ye) break;
          float v[V];
          Vec<T, V>::unpack(raw[u], v);
          const uint32_t bit = 1u << (y0 + u - ys);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            if (v[j] > cm[j]) {
              cm[j] = v[j];
              rows[j] = bit;
            } else if (v[j] == cm[j]) {
              rows[j] |= bit;
            }
          }
        }
      }
      const int e = slot(x);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        store_f(s_max + e + j * threads, cm[j]);
        s_rows[e + j * threads] = (M)rows[j];
        s_g[e + j * threads] = 0.0f;
      }
    }
    hi = xe;

    // The bin's max over its column maxima and how many columns reach it,
    // then each tied column's weight, in column order.
    float m[V];
    int mc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = -INFINITY;
      mc[j] = 0;
    }
    for (int x = xs; x < xe; ++x) {
      const int e = slot(x);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = to_float(s_max[e + j * threads]);
        if (v > m[j]) {
          m[j] = v;
          mc[j] = 1;
        } else if (v == m[j]) {
          ++mc[j];
        }
      }
    }
    TieWeights wc[V] = {};
#pragma unroll
    for (int j = 0; j < V; ++j) wc[j] = TieWeights(mc[j]);
    for (int x = xs; x < xe; ++x) {
      const int e = slot(x);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        // a non-finite max is an output of 0: no gradient
        if (isfinite(m[j]) && to_float(s_max[e + j * threads]) == m[j]) {
          s_g[e + j * threads] += g[j] * wc[j].next();
        }
      }
    }
  }
  flush(lo, hi);
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

// K12: the vector form (V = 8 bf16 or 4 float32 channels a thread) when C
// is a multiple of V and grad_out, feats and grad_feats start on 16-byte
// boundaries, else one channel a thread; 8-bit row masks when a bin has at
// most 8 rows (ceil(H / P) + 1 <= 8), else 32-bit ones (at most 32 rows).
template <typename T, int V, typename M>
int launch_roi_pool_bwd(const void* grad_out, const void* feats,
                        const float* rois, const int* idx, float* grad_feats,
                        int N, int R, int H, int W, int C, int P, float scale,
                        cudaStream_t s) {
  const int groups = C / V;
  int threads = groups >= 64 ? 64 : ((groups + 31) / 32) * 32;
  const int ring = (W + P - 1) / P + 1;
  const size_t per_thread = (size_t)ring * V * (4 + sizeof(T) + sizeof(M));
  if (per_thread * threads > 200 * 1024 && threads > 32) threads = 32;
  const size_t smem = per_thread * threads;
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)roi_pool_bwd_kernel<T, V, M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  const dim3 grid(R * P, (groups + threads - 1) / threads);
  roi_pool_bwd_kernel<T, V, M><<<grid, threads, smem, s>>>(
      (const T*)grad_out, (const T*)feats, rois, idx, grad_feats, N, H, W, C,
      P, scale, ring);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_roi_pool_bwd_rows(int rows, const void* grad_out,
                             const void* feats, const float* rois,
                             const int* idx, float* grad_feats, int N, int R,
                             int H, int W, int C, int P, float scale,
                             cudaStream_t s) {
  if (rows <= 8) {
    return launch_roi_pool_bwd<T, V, uint8_t>(grad_out, feats, rois, idx,
                                              grad_feats, N, R, H, W, C, P,
                                              scale, s);
  }
  return launch_roi_pool_bwd<T, V, uint32_t>(grad_out, feats, rois, idx,
                                             grad_feats, N, R, H, W, C, P,
                                             scale, s);
}

extern "C" int mrcnn_roi_pool_bwd(const void* grad_out, const void* feats,
                                  const float* rois, const int* idx,
                                  float* grad_feats, int dtype, int N, int R,
                                  int H, int W, int C, int P, float scale,
                                  void* stream) {
  if (N * R == 0 || C == 0) return 0;
  const int rows = (H + P - 1) / P + 1;
  if (rows > 32) return (int)cudaErrorInvalidValue;
  const bool aligned = ((uintptr_t)grad_out | (uintptr_t)feats |
                        (uintptr_t)grad_feats) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const auto args = [&](auto launch) {
    return launch(rows, grad_out, feats, rois, idx, grad_feats, N, R, H, W,
                  C, P, scale, s);
  };
  if (dtype == 0) {
    if (aligned && C % 4 == 0)
      return args(launch_roi_pool_bwd_rows<float, 4>);
    return args(launch_roi_pool_bwd_rows<float, 1>);
  }
  if (dtype == 1) {
    if (aligned && C % 8 == 0)
      return args(launch_roi_pool_bwd_rows<__nv_bfloat16, 8>);
    return args(launch_roi_pool_bwd_rows<__nv_bfloat16, 1>);
  }
  return (int)cudaErrorInvalidValue;
}
