// K2 and K3: exact greedy NMS over score-sorted boxes, first max_out
// survivors, batched over independent problems (images, or image x class).
//
// K2 replaces mask_rcnn_tpu/ops/nms.py::nms_blocked_mask (113-174, with
// _cross_suppression 91-110) on the proposal path: 6000 sorted boxes ->
// 1000 at IoU 0.7. K3 replaces nms.py::nms_fixpoint_mask (48-88) plus the
// compaction of nms_padded (234-244) on the decode path: 80 classes x 256
// sorted boxes -> 100 at IoU 0.5.
//
// The TPU formulations avoided a serial loop (a fixpoint of whole-matrix
// sweeps, blocked against a compact kept set). On Hopper the pairwise test
// is cheap and parallel, and the greedy scan over a bitmask is short, so
// both kernels are the classic two-phase form:
//   1. every pair (i, j > i) is tested once, in parallel, into 64-bit
//      suppression words;
//   2. one scan in score order keeps box i when it is valid and no kept box
//      has set its bit, ORs in row i, and stops at max_out kept.
// What bounds them on an H100: latency, not bytes or FLOPs. K2's mask is
// 6000 x 94 words (4.5 MB, L2-resident); its scan is a dependent chain of
// ~max_out row loads. K3 keeps its <= 1024 boxes and the whole bitmask in
// shared memory, one block per problem, so its scan touches no device
// memory.
//
// The predicate is the division-free one of mask_rcnn_tpu/ops/nms.py:27-45
// and 107-109, inter > t * (area_i + area_j - inter) with
// area = max(h,0) * max(w,0), written with round-to-nearest intrinsics so
// that nvcc cannot contract it into FMAs: decisions are bit-identical to
// the float32 plain version.
// Rows with valid == 0 are never kept and so never suppress.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;

// a, b = (y1, x1, y2, x2)
__device__ __forceinline__ bool suppresses(const float4 a, const float4 b,
                                           float thresh) {
  const float ih = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float iw = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(ih, iw);
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.0f),
                                 fmaxf(__fsub_rn(a.w, a.y), 0.0f));
  const float area_b = __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                                 fmaxf(__fsub_rn(b.w, b.y), 0.0f));
  return inter > __fmul_rn(thresh, __fsub_rn(__fadd_rn(area_a, area_b), inter));
}

// K2 phase 1. grid (col_blocks, col_blocks, B), block kTile threads.
// mask[b, i, cb] bit k: box i suppresses box cb*64 + k (> i). Words left of
// the diagonal block are never written and never read.
__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int N,
                                int col_blocks, float thresh,
                                uint64_t* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;
  const int row_size = min(N - rb * kTile, kTile);
  const int col_size = min(N - cb * kTile, kTile);
  const float4* bx = boxes + (size_t)b * N;

  __shared__ float4 cols[kTile];
  if ((int)threadIdx.x < col_size) {
    cols[threadIdx.x] = bx[cb * kTile + threadIdx.x];
  }
  __syncthreads();
  if ((int)threadIdx.x >= row_size) return;

  const int i = rb * kTile + threadIdx.x;
  const float4 a = bx[i];
  uint64_t bits = 0;
  for (int k = (cb == rb) ? (int)threadIdx.x + 1 : 0; k < col_size; ++k) {
    if (suppresses(a, cols[k], thresh)) bits |= 1ULL << k;
  }
  mask[((size_t)b * N + i) * col_blocks + cb] = bits;
}

// K2 phase 2. grid B, one warp per problem; `removed` lives in shared
// memory (col_blocks words), each lane ORs every 32nd word of a kept row.
__global__ void nms_scan_kernel(const uint64_t* __restrict__ mask,
                                const uint8_t* __restrict__ valid, int N,
                                int col_blocks, int max_out,
                                int* __restrict__ out_pos,
                                uint8_t* __restrict__ out_mask) {
  extern __shared__ uint64_t removed[];
  const int b = blockIdx.x, lane = threadIdx.x;
  for (int w = lane; w < col_blocks; w += 32) removed[w] = 0;
  __syncwarp();

  const uint64_t* m = mask + (size_t)b * N * col_blocks;
  const uint8_t* v = valid + (size_t)b * N;
  int* pos = out_pos + (size_t)b * max_out;
  uint8_t* ok = out_mask + (size_t)b * max_out;
  int count = 0;
  for (int i = 0; i < N && count < max_out; ++i) {
    const int wi = i / kTile;
    if (!v[i] || ((removed[wi] >> (i % kTile)) & 1ULL)) continue;
    if (lane == 0) {
      pos[count] = i;
      ok[count] = 1;
    }
    ++count;
    const uint64_t* row = m + (size_t)i * col_blocks;
    for (int w = wi + lane; w < col_blocks; w += 32) removed[w] |= row[w];
    __syncwarp();
  }
  for (int k = count + lane; k < max_out; k += 32) {
    pos[k] = -1;
    ok[k] = 0;
  }
}

// K3. grid B, one block per problem; dynamic shared memory holds the N
// boxes, the N x words bitmask and the scan's `removed` words.
__global__ void nms_small_kernel(const float4* __restrict__ boxes,
                                 const uint8_t* __restrict__ valid, int N,
                                 float thresh, int max_out,
                                 int* __restrict__ out_pos,
                                 uint8_t* __restrict__ out_mask) {
  extern __shared__ float4 smem[];
  const int words = (N + kTile - 1) / kTile;
  float4* sb = smem;
  uint64_t* sm = reinterpret_cast<uint64_t*>(sb + N);
  uint64_t* removed = sm + (size_t)N * words;

  const int b = blockIdx.x;
  const float4* bx = boxes + (size_t)b * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) sb[i] = bx[i];
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0;
  __syncthreads();

  for (int t = threadIdx.x; t < N * words; t += blockDim.x) {
    const int i = t / words, w = t % words;
    const int j1 = min((w + 1) * kTile, N);
    const float4 a = sb[i];
    uint64_t bits = 0;
    for (int j = max(w * kTile, i + 1); j < j1; ++j) {
      if (suppresses(a, sb[j], thresh)) bits |= 1ULL << (j - w * kTile);
    }
    sm[t] = bits;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const uint8_t* v = valid + (size_t)b * N;
  int* pos = out_pos + (size_t)b * max_out;
  uint8_t* ok = out_mask + (size_t)b * max_out;
  int count = 0;
  for (int i = 0; i < N && count < max_out; ++i) {
    const int wi = i / kTile;
    if (!v[i] || ((removed[wi] >> (i % kTile)) & 1ULL)) continue;
    pos[count] = i;
    ok[count] = 1;
    ++count;
    const uint64_t* row = sm + (size_t)i * words;
    for (int w = wi; w < words; ++w) removed[w] |= row[w];
  }
  for (; count < max_out; ++count) {
    pos[count] = -1;
    ok[count] = 0;
  }
}

}  // namespace

// K2. boxes (B, N, 4) float32 sorted, valid (B, N) uint8, scratch mask
// (B, N, ceil(N/64)) uint64; out_pos (B, max_out) int32, out_mask
// (B, max_out) uint8. Returns a cudaError_t (0 on success).
extern "C" int mrcnn_nms_blocked(const void* boxes, const void* valid,
                                 void* scratch, int B, int N, float thresh,
                                 int max_out, void* out_pos, void* out_mask,
                                 void* stream) {
  if (B == 0 || max_out == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int col_blocks = (N + kTile - 1) / kTile;
  if (N > 0) {
    nms_mask_kernel<<<dim3(col_blocks, col_blocks, B), kTile, 0, s>>>(
        (const float4*)boxes, N, col_blocks, thresh, (uint64_t*)scratch);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  nms_scan_kernel<<<B, 32, (size_t)col_blocks * sizeof(uint64_t), s>>>(
      (const uint64_t*)scratch, (const uint8_t*)valid, N, col_blocks, max_out,
      (int*)out_pos, (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}

// Largest N whose boxes and bitmask fit K3's shared memory (144 KB at 1024);
// ops/nms.py::SMALL_MAX_N routes larger N to K2.
constexpr int kSmallMaxN = 1024;

// K3. Same buffers as K2 without the scratch; N <= kSmallMaxN.
extern "C" int mrcnn_nms_small(const void* boxes, const void* valid, int B,
                               int N, float thresh, int max_out, void* out_pos,
                               void* out_mask, void* stream) {
  if (B == 0 || max_out == 0) return 0;
  if (N > kSmallMaxN) return (int)cudaErrorInvalidValue;
  const int words = (N + kTile - 1) / kTile;
  const size_t smem = (size_t)N * sizeof(float4) +
                      ((size_t)N * words + words) * sizeof(uint64_t);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        nms_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  nms_small_kernel<<<B, 256, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const uint8_t*)valid, N, thresh, max_out,
      (int*)out_pos, (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}
