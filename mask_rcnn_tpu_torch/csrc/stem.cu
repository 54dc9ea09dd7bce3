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
// 3.35 TB/s; 5.3 us at the bf16 tensor-core rate). Two forms, chosen by
// the input's type, share the tiling: one block per 8x8 tile of pooled
// outputs and all 64 channels. The tile's pooled rows 2*py-1 .. 2*py+1
// cover a 17x17 tile of conv positions, which read a 39x39x3 input patch
// (4*8+7 rows and columns, zero outside the image); the block recomputes
// the one-row and one-column conv halo it shares with its neighbours (289
// conv positions for 256, 1.13x). The conv tile, after affine and relu, is
// kept in shared memory, then max-pooled, and only the pooled tile leaves.
//
// bfloat16 (the main path): the conv is a product on the tensor cores,
// mma.sync.m16n8k16 bf16 -> float32, of an im2col tile (289 conv positions,
// padded to 19 row tiles of 16) by the (taps x 64) weights. The taps are
// ordered (ky, kx, c) with each ky's 21 taps padded to 24, so that a pair
// of neighbouring taps is a pair of neighbouring values of one patch row
// (patch row 2*ry + ky, element 6*rx + kx*3 + c): each A fragment register
// is one 4-byte shared-memory load, no index table. K = 7 * 24 = 168,
// padded to 176 (11 steps of 16); the wrapper packs conv1's weights into
// that (64, 176) bf16 matrix (models/resnet.py::pack_stem_weights, zero on
// the padded taps), and each warp loads its part of it in the B fragments'
// register order. The bf16 weights are the JAX stem's (it casts them to
// the input type, resnet.py:125), and a bf16 x bf16 product is exact in
// float32, so the products are the float32 stem's; only the order of the
// float32 sums changes. Each warp owns half of the 64 channels (4 column
// tiles of 8) and holds their B fragments for all 11 steps in registers
// (88), so shared memory serves only the A fragments; the 8 warps are 2
// channel halves x 4 groups of row tiles (5, 5, 5, 4 tiles). The
// epilogue applies the affine with the plain version's two roundings (acc *
// scale, then + bias) and the relu, and keeps the conv tile in bf16
// (rounded once: max commutes with the monotone rounding, so pooling
// rounded values gives the rounded pooled value) with a row stride of 72
// values (no bank conflicts); the pool reads and writes 16 bytes (8
// channels) a thread. Shared memory 50.5 KB, at most 128 registers: two
// blocks of 256 threads an SM.
//
// float32: on the CUDA cores (TF32 would not hold float32's tolerance),
// each thread accumulating 5 conv positions x 16 output channels (80
// sums) from shared memory, so that per tap 5 input loads and 4 16-byte
// weight loads (the same address across the warp: a broadcast) feed 80
// FMAs; weights (37.6 KB) and patch in shared memory, the conv tile in
// float32 with a row stride of 65 floats, one block of 256 threads an SM.
// A first version kept the weights in constant memory, one conv position x
// 64 channels a thread: the constant cache could not hold them and it ran
// at 11% of the float32 rate.
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
#include <stdint.h>

namespace {

constexpr int KS = 7;  // conv kernel size
constexpr int CIN = 3;
constexpr int COUT = 64;
constexpr int TAPS = KS * KS * CIN;  // 147
constexpr int TP = 8;                // pooled tile (TP x TP)
constexpr int TC = 2 * TP + 1;       // conv tile, 17
constexpr int NPOS = TC * TC;        // 289 conv positions
constexpr int TI = 4 * TP + 7;       // input patch, 39
constexpr int THREADS = 256;

// -- float32: CUDA-core FMAs ------------------------------------------------

constexpr int HALF = (TI + 1) / 2;   // 20 even (or odd) columns
constexpr int PROW = 2 * HALF;       // a patch row: even half, odd half
constexpr int PLANE = TI * PROW;     // one channel of the patch
constexpr int CSTRIDE = COUT + 1;
constexpr int QG = 16;                    // channels per thread
constexpr int SLOTS = THREADS / (COUT / QG);  // 64 position slots
constexpr int PPT = (NPOS + SLOTS - 1) / SLOTS;  // 5 positions per thread
constexpr size_t SMEM_F32 =
    (size_t)(TAPS * COUT + CIN * PLANE + NPOS * CSTRIDE) * sizeof(float);

__global__ void __launch_bounds__(THREADS, 1)
    stem_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int H, int W, int CH, int CW, int PH, int PW) {
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
            ? __ldg(x + xn + ((size_t)iy * W + ix) * CIN + c)
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
    out[(((size_t)n * PH + py) * PW + px) * COUT + o] = m;
  }
}

// -- bfloat16: tensor cores ---------------------------------------------------

constexpr int KGROUP = 24;              // a ky's 21 taps, padded
constexpr int KPAD = 176;               // 7 * 24 = 168, padded to 11 * 16
constexpr int KSTEPS = KPAD / 16;       // 11
constexpr int NT = 4;                   // column tiles of 8 channels a warp
constexpr int MTILES = (NPOS + 15) / 16;  // 19 row tiles of 16 positions
constexpr int MGROUPS = THREADS / 32 / 2;  // warps per half of the channels
constexpr int PSTRIDE = 120;            // a patch row: 39 * 3 values, padded
constexpr int PROWS = TI + 1;           // + a zero row read by taps >= 168
constexpr int PATCH = PROWS * PSTRIDE;
constexpr int VSTRIDE = COUT + 8;       // conv tile row, bf16 values
constexpr size_t SMEM_BF16 =
    (size_t)NPOS * VSTRIDE * sizeof(__nv_bfloat16)      // conv tile
    + (size_t)PATCH * sizeof(__nv_bfloat16)             // input patch
    + 2 * COUT * sizeof(float);                         // scale, bias

// The patch offset of tap k (k a multiple of 8, so k .. k + 6 share a ky):
// row ky = k / 24, element k % 24.
__host__ __device__ constexpr int tap_offset(int k) {
  return (k / KGROUP) * PSTRIDE + k % KGROUP;
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const unsigned short* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS, 2)
    stem_bf16_kernel(const unsigned short* __restrict__ x,
                     const uint32_t* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int H, int W, int CH,
                     int CW, int PH, int PW) {
  extern __shared__ uint4 smem16[];
  __nv_bfloat16* conv =
      reinterpret_cast<__nv_bfloat16*>(smem16);         // [NPOS][VSTRIDE]
  unsigned short* patch = reinterpret_cast<unsigned short*>(
      conv + NPOS * VSTRIDE);                           // [PROWS][PSTRIDE]
  float* s_scale = reinterpret_cast<float*>(patch + PATCH);
  float* s_bias = s_scale + COUT;

  const int n = blockIdx.z;
  const int py0 = blockIdx.y * TP, px0 = blockIdx.x * TP;
  const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;  // conv tile origin
  const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;  // input patch origin
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int half = warp & 1;  // channels 32 * half .. + 31

  // This warp's B fragments (mma.m16n8k16 .col) for all 11 steps, held in
  // registers: lane (g, tig) of column tile t holds taps 16s + 2tig (+1)
  // and 16s + 2tig + 8 (+9) of channel 32 * half + 8t + g, two
  // neighbouring bf16 of the (64, 176) weights a register. Issued first,
  // so that their latency overlaps the patch's.
  uint32_t bfr[KSTEPS][NT][2];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const uint32_t* row = w + (32 * half + 8 * t + g) * (KPAD / 2) + tig;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      bfr[s][t][0] = __ldg(row + 8 * s);
      bfr[s][t][1] = __ldg(row + 8 * s + 4);
    }
  }
  // the input patch, rows of 39 pixels x 3 channels, zero outside the
  // image and on the padding (read against zero weights, must be finite);
  // unrolled so that every thread's loads are in flight together
  const size_t xn = (size_t)n * H * W * CIN;
  unsigned short v[(PATCH + THREADS - 1) / THREADS];
#pragma unroll
  for (int j = 0; j < (PATCH + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / PSTRIDE, e = i - r * PSTRIDE;
    const int col = e / CIN, c = e - col * CIN;
    const int iy = iy0 + r, ix = ix0 + col;
    const bool in = i < PATCH && r < TI && col < TI && iy >= 0 && iy < H &&
                    ix >= 0 && ix < W;
    v[j] = in ? x[xn + ((size_t)iy * W + ix) * CIN + c] : (unsigned short)0;
  }
#pragma unroll
  for (int j = 0; j < (PATCH + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (i < PATCH) patch[i] = v[j];
  }
  for (int i = threadIdx.x; i < COUT; i += THREADS) {
    s_scale[i] = __ldg(scale + i);
    s_bias[i] = __ldg(bias + i);
  }
  __syncthreads();

  for (int mt = warp >> 1; mt < MTILES; mt += MGROUPS) {
    // A rows g and g + 8 of the tile: conv positions (ry, rx), read from
    // patch row 2ry + ky, element 6rx + kx*3 + c (padding rows clamp to
    // the last position and are dropped). Taps 16s + 2tig (+8) of one step
    // share their ky, so each A register is the address base + 2tig plus
    // a constant of the step.
    int base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = min(mt * 16 + g + 8 * h, NPOS - 1);
      const int ry = p / TC, rx = p - ry * TC;
      base[h] = 2 * ry * PSTRIDE + 6 * rx + 2 * tig;
    }
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][q] = 0.0f;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const uint32_t a0 = lds32(patch + base[0] + tap_offset(16 * s));
      const uint32_t a1 = lds32(patch + base[1] + tap_offset(16 * s));
      const uint32_t a2 = lds32(patch + base[0] + tap_offset(16 * s + 8));
      const uint32_t a3 = lds32(patch + base[1] + tap_offset(16 * s + 8));
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        mma_bf16(acc[t], a0, a1, a2, a3, bfr[s][t][0], bfr[s][t][1]);
      }
    }
    // affine (the plain version's two roundings) -> relu -> bf16 into the
    // conv tile; 0 outside the conv grid. Sums c0, c1 are row g, channels
    // 32 * half + 8t + 2tig (+1); c2, c3 row g + 8.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + 8 * h;
      if (p >= NPOS) continue;
      const int ry = p / TC, rx = p - ry * TC;
      const int cy = cy0 + ry, cx = cx0 + rx;
      const bool inside = cy >= 0 && cy < CH && cx >= 0 && cx < CW;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int ch = 32 * half + 8 * t + 2 * tig;
        float o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float a = __fadd_rn(
              __fmul_rn(acc[t][2 * h + j], s_scale[ch + j]), s_bias[ch + j]);
          o[j] = inside ? fmaxf(a, 0.0f) : 0.0f;
        }
        *reinterpret_cast<__nv_bfloat162*>(conv + p * VSTRIDE + ch) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
    }
  }
  __syncthreads();

  // 3x3 stride-2 max pool, one thread per (pooled position, 8 channels):
  // 16-byte loads and stores
  for (int i = threadIdx.x; i < TP * TP * (COUT / 8); i += THREADS) {
    const int qq = i / (COUT / 8), o = (i - qq * (COUT / 8)) * 8;
    const int qy = qq / TP, qx = qq - qy * TP;
    const int py = py0 + qy, px = px0 + qx;
    if (py >= PH || px >= PW) continue;
    uint4 mv = make_uint4(0u, 0u, 0u, 0u);  // bf16 +0
    __nv_bfloat162* m = reinterpret_cast<__nv_bfloat162*>(&mv);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint4 cv = *reinterpret_cast<const uint4*>(
            conv + ((2 * qy + dy) * TC + 2 * qx + dx) * VSTRIDE + o);
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&cv);
#pragma unroll
        for (int j = 0; j < 4; ++j) m[j] = __hmax2(m[j], h2[j]);
      }
    *reinterpret_cast<uint4*>(out + (((size_t)n * PH + py) * PW + px) * COUT +
                              o) = mv;
  }
}

}  // namespace

// x (N, H, W, 3) contiguous, dtype 0 = float32, 1 = bfloat16; w: for
// float32 (147, 64) float32 with rows (ky, kx, c), for bfloat16 (64, 176)
// bfloat16 with columns ky * 24 + kx * 3 + c and zeros elsewhere
// (models/resnet.py::pack_stem_weights); w and out 16-byte aligned;
// scale, bias (64,) float32; out (N, PH, PW, 64) of x's type. Returns a
// cudaError_t (0 on success).
extern "C" int mrcnn_stem_fwd(const void* x, const void* w,
                              const float* scale, const float* bias,
                              void* out, int dtype, int N, int H, int W,
                              void* stream) {
  if (N == 0 || H == 0 || W == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)w | (uintptr_t)out) % 16) {
    return (int)cudaErrorMisalignedAddress;
  }
  const int CH = (H + 1) / 2, CW = (W + 1) / 2;
  const int PH = (CH + 1) / 2, PW = (CW + 1) / 2;
  const dim3 grid((PW + TP - 1) / TP, (PH + TP - 1) / TP, N);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        stem_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_F32);
    if (err != cudaSuccess) return (int)err;
    stem_f32_kernel<<<grid, THREADS, SMEM_F32, s>>>(
        (const float*)x, (const float*)w, scale, bias, (float*)out, H, W, CH,
        CW, PH, PW);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        stem_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BF16);
    if (err != cudaSuccess) return (int)err;
    stem_bf16_kernel<<<grid, THREADS, SMEM_BF16, s>>>(
        (const unsigned short*)x, (const uint32_t*)w, scale, bias,
        (__nv_bfloat16*)out, H, W, CH, CW, PH, PW);
  }
  return (int)cudaGetLastError();
}
