// K10: the ResNet stem in one pass: conv1 7x7 stride 2 pad 3 (3 -> 64
// channels), the frozen affine (acc * scale + bias), relu, and the 3x3
// stride-2 pad-1 max pool, on NHWC input.
//
// K10 replaces mask_rcnn_tpu/models/resnet.py::stem_forward (lines 103-150).
// The JAX package rewrote the stem as a space-to-depth-4 block conv so that
// the TPU's matrix unit sees 48 input channels instead of 3, and turned the
// max pool into shifted maxes on block channels. Here the four stages are
// fused into one kernel, so the 64-channel conv output (4x the pooled
// tensor) never reaches device memory: what leaves the kernel is the pooled
// (N, ceil(ceil(H/2)/2), ceil(ceil(W/2)/2), 64) tensor, rounded once to the
// input's type.
//
// What bounds it on an H100: operations. At (1, 832, 1344, 3) the conv is
// 416*672*64*147*2 = 5.26 GFLOP against 6.7 MB in and 8.9 MB out (4.7 us at
// 3.35 TB/s). This first version runs on the CUDA cores in float32, so it
// is held by the float32 FMA rate (67 TFLOP/s, 79 us for the conv alone);
// tensor cores are for a later version. The design feeds that rate from
// shared memory with a register tile: each thread accumulates 5 conv
// positions x 16 output channels (80 sums), so that per tap 5 input loads
// and 4 16-byte weight loads (the same address across the warp: a
// broadcast) feed 80 FMAs. A first version kept the 37.6 KB of weights in
// constant memory, one conv position x 64 channels a thread: the constant
// cache could not hold them and it ran at 11% of the float32 rate, twice as
// slow as the four-op stem it replaces.
//
// Tiles: one block per 8x8 tile of pooled outputs and all 64 channels. The
// tile's pooled rows 2*py-1 .. 2*py+1 cover a 17x17 tile of conv positions,
// which read a 39x39x3 input patch (4*8+7 rows and columns, zero outside
// the image); the block recomputes the one-row and one-column conv halo it
// shares with its neighbours (289 conv positions for 256, 1.13x). The patch
// is stored by channel plane with even and odd columns apart, so that the
// stride-2 reads of neighbouring positions hit neighbouring banks. The conv
// tile, after affine and relu, is kept in shared memory with a row stride
// of 65 floats (no bank conflicts when a warp's threads write their
// channels), then pooled, one thread per output channel value, so that the
// stores of a warp are 32 neighbouring channels. Shared memory: weights
// 37.6 KB + patch 18.7 KB + conv tile 75.1 KB, one block of 256 threads an
// SM.
//
// The pool's -inf padding is equivalent to 0 after the relu: every pool
// window holds at least one real conv output (row 2*py <= CH-1 because
// py < ceil(CH/2)), and that output is >= 0, so a 0 for a conv position
// outside the conv grid never changes the max. Max commutes with the final
// monotone rounding, so the result equals rounding each relu'd value first.
//
// Any H and W work (the JAX package switches to the direct conv when they do
// not divide by 4, resnet.py:116-120): every edge is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KS = 7;  // conv kernel size
constexpr int CIN = 3;
constexpr int COUT = 64;
constexpr int TAPS = KS * KS * CIN;  // 147
constexpr int TP = 8;                // pooled tile (TP x TP)
constexpr int TC = 2 * TP + 1;       // conv tile, 17
constexpr int NPOS = TC * TC;        // 289 conv positions
constexpr int TI = 4 * TP + 7;       // input patch, 39
constexpr int HALF = (TI + 1) / 2;   // 20 even (or odd) columns
constexpr int PROW = 2 * HALF;       // a patch row: even half, odd half
constexpr int PLANE = TI * PROW;     // one channel of the patch
constexpr int CSTRIDE = COUT + 1;
constexpr int THREADS = 256;
constexpr int QG = 16;                    // channels per thread
constexpr int SLOTS = THREADS / (COUT / QG);  // 64 position slots
constexpr int PPT = (NPOS + SLOTS - 1) / SLOTS;  // 5 positions per thread
constexpr size_t SMEM_BYTES =
    (size_t)(TAPS * COUT + CIN * PLANE + NPOS * CSTRIDE) * sizeof(float);

// One kernel for both types (dtype 0 = float32, 1 = bfloat16, a uniform
// branch at the loads and stores).
__device__ __forceinline__ float load_x(const void* x, size_t i, int dtype) {
  return dtype ? __bfloat162float(((const __nv_bfloat16*)x)[i])
               : __ldg((const float*)x + i);
}
__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          int dtype) {
  if (dtype)
    ((__nv_bfloat16*)out)[i] = __float2bfloat16_rn(v);
  else
    ((float*)out)[i] = v;
}

__global__ void __launch_bounds__(THREADS, 1)
    stem_kernel(const void* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ scale,
                const float* __restrict__ bias, void* __restrict__ out,
                int dtype, int H, int W, int CH, int CW, int PH, int PW) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [TAPS][COUT]
  float* patch = w_s + TAPS * COUT;               // [CIN][TI][PROW]
  float* conv = patch + CIN * PLANE;              // [NPOS][CSTRIDE]

  const int n = blockIdx.z;
  const int py0 = blockIdx.y * TP, px0 = blockIdx.x * TP;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // conv tile origin
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // input patch origin
  const size_t xn = (size_t)n * H * W * CIN;

  for (int i = threadIdx.x; i < TAPS * COUT / 4; i += THREADS)
    smem4[i] = __ldg(reinterpret_cast<const float4*>(w) + i);
  // the input patch, zero outside the image; a row of it is contiguous
  for (int i = threadIdx.x; i < TI * TI * CIN; i += THREADS) {
    const int r = i / (TI * CIN), rem = i - r * (TI * CIN);
    const int col = rem / CIN, c = rem - col * CIN;
    const int iy = iy0 + r, ix = ix0 + col;
    patch[c * PLANE + r * PROW + (col & 1) * HALF + (col >> 1)] =
        (iy >= 0 && iy < H && ix >= 0 && ix < W)
            ? load_x(x, xn + ((size_t)iy * W + ix) * CIN + c, dtype)
            : 0.0f;
  }
  __syncthreads();

  // conv: 5 positions x 16 channels a thread; the channel group is
  // uniform across a warp, so the weight loads are broadcasts
  const int q = threadIdx.x / SLOTS;  // channel group
  const int slot = threadIdx.x - q * SLOTS;
  int base[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = min(slot + j * SLOTS, NPOS - 1);
    const int ry = p / TC, rx = p - ry * TC;
    base[j] = 2 * ry * PROW + rx;
  }
  float acc[PPT][QG];
#pragma unroll
  for (int j = 0; j < PPT; ++j)
#pragma unroll
    for (int o = 0; o < QG; ++o) acc[j][o] = 0.0f;

  for (int c = 0; c < CIN; ++c) {
    for (int ky = 0; ky < KS; ++ky) {
      const float* prow = patch + c * PLANE + ky * PROW;
#pragma unroll
      for (int kx = 0; kx < KS; ++kx) {
        const int tap = (ky * KS + kx) * CIN + c;
        const float4* wq =
            reinterpret_cast<const float4*>(w_s + tap * COUT + q * QG);
        float wv[QG];
#pragma unroll
        for (int k = 0; k < QG / 4; ++k) {
          const float4 t = wq[k];
          wv[4 * k] = t.x;
          wv[4 * k + 1] = t.y;
          wv[4 * k + 2] = t.z;
          wv[4 * k + 3] = t.w;
        }
        // column 2*rx + kx: parity kx & 1, half-index rx + kx / 2
        const int off = (kx & 1) * HALF + (kx >> 1);
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float v = prow[base[j] + off];
#pragma unroll
          for (int o = 0; o < QG; ++o) acc[j][o] = fmaf(v, wv[o], acc[j][o]);
        }
      }
    }
  }

  // affine -> relu into the conv tile; 0 outside the conv grid
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = slot + j * SLOTS;
    if (p >= NPOS) break;
    const int ry = p / TC, rx = p - ry * TC;
    const int cy = cy0 + ry, cx = cx0 + rx;
    const bool inside = cy >= 0 && cy < CH && cx >= 0 && cx < CW;
#pragma unroll
    for (int o = 0; o < QG; ++o) {
      const int ch = q * QG + o;
      // the plain version's two roundings: acc * scale, then + bias
      const float a =
          __fadd_rn(__fmul_rn(acc[j][o], __ldg(scale + ch)), __ldg(bias + ch));
      conv[p * CSTRIDE + ch] = inside ? fmaxf(a, 0.0f) : 0.0f;
    }
  }
  __syncthreads();

  // 3x3 stride-2 max pool, one thread per (pooled position, channel)
  for (int i = threadIdx.x; i < TP * TP * COUT; i += THREADS) {
    const int qq = i / COUT, o = i - qq * COUT;
    const int qy = qq / TP, qx = qq - qy * TP;
    const int py = py0 + qy, px = px0 + qx;
    if (py >= PH || px >= PW) continue;
    // pooled (qy, qx) reads conv rows 2qy .. 2qy+2 of the tile
    float m = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        m = fmaxf(m, conv[((2 * qy + dy) * TC + 2 * qx + dx) * CSTRIDE + o]);
    store_out(out, (((size_t)n * PH + py) * PW + px) * COUT + o, m, dtype);
  }
}

}  // namespace

// x (N, H, W, 3) contiguous, dtype 0 = float32, 1 = bfloat16; w (147, 64)
// float32 with rows (ky, kx, c), 16-byte aligned; scale, bias (64,)
// float32; out (N, PH, PW, 64) of x's type. Returns a cudaError_t (0 on
// success).
extern "C" int mrcnn_stem_fwd(const void* x, const float* w,
                              const float* scale, const float* bias,
                              void* out, int dtype, int N, int H, int W,
                              void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int CH = (H + 1) / 2, CW = (W + 1) / 2;
  const int PH = (CH + 1) / 2, PW = (CW + 1) / 2;
  const dim3 grid((PW + TP - 1) / TP, (PH + TP - 1) / TP, N);
  stem_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      x, w, scale, bias, out, dtype, H, W, CH, CW, PH, PW);
  return (int)cudaGetLastError();
}
