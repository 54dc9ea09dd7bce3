// K8: the mask-target crop-resize, and K9: anchor and proposal matching to
// the gt boxes, the two device-side halves of the training target creators.
//
// K8 replaces mask_rcnn_tpu/models/targets.py::_crop_resize_masks_indexed
// (lines 190-238) with _mask_sample_coords (136-170): a cv2-parity bilinear
// crop-resize of each sampled positive roi's gt mask to M x M, binarised at
// > 0.5. The JAX package gathered whole mask rows and then columns, so that
// the TPU's vector unit sees contiguous reads. Here one thread computes one
// output cell (roi, i, j): it recomputes the roi's two sample coordinates,
// reads its four taps' bytes straight from the (bit-packed) gt mask and
// interpolates. What bounds it: nothing on this card at the train shape
// (2 x 128 x 14 x 14 cells, four byte reads each from L2-resident masks);
// it is latency, one launch. The design keeps it to one pass with no
// intermediate rows. The sample coordinate (i + .5) * (crop / M) - .5 and
// the interpolation sum are written with round-to-nearest intrinsics in the
// plain version's order, so that exact-0.5 ties binarise the same way.
//
// K9 replaces the matching part of models/targets.py::anchor_targets
// (54-101: IoU of every anchor with every gt, masked for invalid gts and
// anchors outside the image, per-anchor max and first-index argmax, per-gt
// max with ties, the pre-sampling label in {-1, 0, 1}) and of
// proposal_targets (276-298: IoU, argmax, max with the zero-gt rule, the
// positive and negative candidacy). The JAX package materialised the
// (S, G) IoU matrix and reduced it both ways. Here a block holds its
// image's <= kMaxG gt boxes in shared memory and each thread one anchor or
// candidate, so the matrix never exists. The per-gt max over all anchors
// is a cross-block reduction: a first pass takes max(iou, 0) per warp and
// folds it into the result with atomicMax on its int bits (exact, since
// non-negative floats order as their bits, and is_gt_argmax needs
// gt_max > 0); a second pass compares each anchor's IoU with it for
// equality. The IoU is computed with round-to-nearest intrinsics and a true
// division, as the plain bbox_iou computes it: the rules downstream
// (thresholds, ==) are discontinuous. What bounds it: launch latency and
// the 65520 x G IoUs, ~1 us of arithmetic; the design is two short passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxG = 256;
constexpr int kThreads = 256;

// bbox_iou of one box with one gt box, op for op (mask_rcnn_tpu/ops/
// boxes.py:21-35, the port's ops/boxes.py::bbox_iou).
__device__ __forceinline__ float iou_rn(const float* a, const float* b) {
  const float tly = fmaxf(a[0], b[0]), tlx = fmaxf(a[1], b[1]);
  const float bry = fminf(a[2], b[2]), brx = fminf(a[3], b[3]);
  const float ih = fmaxf(__fsub_rn(bry, tly), 0.0f);
  const float iw = fmaxf(__fsub_rn(brx, tlx), 0.0f);
  const float inter = __fmul_rn(ih, iw);
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a[2], a[0]), 0.0f),
                                 fmaxf(__fsub_rn(a[3], a[1]), 0.0f));
  const float area_b = __fmul_rn(fmaxf(__fsub_rn(b[2], b[0]), 0.0f),
                                 fmaxf(__fsub_rn(b[3], b[1]), 0.0f));
  const float denom = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return denom > 0.0f ? __fdiv_rn(inter, denom) : 0.0f;
}

// Loads image n's gt boxes and validity into shared memory.
__device__ __forceinline__ void load_gt(const float* gt, const uint8_t* valid,
                                        int n, int G, float* s_gt,
                                        uint8_t* s_valid) {
  for (int k = threadIdx.x; k < G * 4; k += blockDim.x)
    s_gt[k] = gt[(size_t)n * G * 4 + k];
  for (int k = threadIdx.x; k < G; k += blockDim.x)
    s_valid[k] = valid[(size_t)n * G + k];
  __syncthreads();
}

__device__ __forceinline__ bool inside_image(const float* a, float h,
                                             float w) {
  return a[0] >= 0.0f && a[1] >= 0.0f && a[2] <= h && a[3] <= w;
}

// Pass 1: gt_max[n, g] = max over anchors of max(masked iou, 0), as float
// bits in an int buffer zeroed beforehand.
__global__ void anchor_gt_max_kernel(const float* __restrict__ anchors,
                                     const float* __restrict__ gt,
                                     const uint8_t* __restrict__ gt_valid,
                                     int S, int G, float h, float w,
                                     int* __restrict__ gt_max) {
  __shared__ float s_gt[kMaxG * 4];
  __shared__ uint8_t s_valid[kMaxG];
  const int n = blockIdx.y;
  load_gt(gt, gt_valid, n, G, s_gt, s_valid);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool in = false;
  if (s < S) {
    for (int k = 0; k < 4; ++k) a[k] = anchors[(size_t)s * 4 + k];
    in = inside_image(a, h, w);
  }
  const int lane = threadIdx.x & 31;
  for (int g = 0; g < G; ++g) {
    float m = (in && s_valid[g]) ? fmaxf(iou_rn(a, s_gt + g * 4), 0.0f) : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0 && m > 0.0f) atomicMax(gt_max + n * G + g, __float_as_int(m));
  }
}

// Pass 2: per anchor, argmax / max of the masked IoU, is_gt_argmax and the
// pre-sampling label.
__global__ void anchor_label_kernel(const float* __restrict__ anchors,
                                    const float* __restrict__ gt,
                                    const uint8_t* __restrict__ gt_valid,
                                    const int* __restrict__ gt_max, int S,
                                    int G, float h, float w, float pos_thresh,
                                    float neg_thresh,
                                    int64_t* __restrict__ argmax,
                                    int32_t* __restrict__ label) {
  __shared__ float s_gt[kMaxG * 4];
  __shared__ uint8_t s_valid[kMaxG];
  __shared__ float s_max[kMaxG];
  const int n = blockIdx.y;
  for (int k = threadIdx.x; k < G; k += blockDim.x)
    s_max[k] = __int_as_float(gt_max[n * G + k]);
  load_gt(gt, gt_valid, n, G, s_gt, s_valid);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  float a[4];
  for (int k = 0; k < 4; ++k) a[k] = anchors[(size_t)s * 4 + k];
  const bool in = inside_image(a, h, w);
  int best = 0;
  float best_iou = -1.0f;
  bool is_gt_argmax = false;
  for (int g = 0; g < G; ++g) {
    const float v = (in && s_valid[g]) ? iou_rn(a, s_gt + g * 4) : -1.0f;
    if (g == 0 || v > best_iou) {
      best = g;
      best_iou = v;
    }
    is_gt_argmax |= s_valid[g] && s_max[g] > 0.0f && v == s_max[g];
  }
  int lab = -1;
  if (in && best_iou < neg_thresh) lab = 0;
  if (in && is_gt_argmax) lab = 1;
  if (in && best_iou >= pos_thresh) lab = 1;
  argmax[(size_t)n * S + s] = best;
  label[(size_t)n * S + s] = lab;
}

__global__ void proposal_match_kernel(
    const float* __restrict__ cand, const uint8_t* __restrict__ cand_valid,
    const float* __restrict__ gt, const uint8_t* __restrict__ gt_valid, int P,
    int G, float pos_thresh, float neg_hi, float neg_lo,
    int64_t* __restrict__ argmax, uint8_t* __restrict__ pos,
    uint8_t* __restrict__ neg) {
  __shared__ float s_gt[kMaxG * 4];
  __shared__ uint8_t s_valid[kMaxG];
  const int n = blockIdx.y;
  load_gt(gt, gt_valid, n, G, s_gt, s_valid);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t i = (size_t)n * P + p;
  const float* a = cand + i * 4;
  int best = 0;
  float best_iou = -1.0f;
  bool any_gt = false;
  for (int g = 0; g < G; ++g) {
    const float v = s_valid[g] ? iou_rn(a, s_gt + g * 4) : -1.0f;
    if (g == 0 || v > best_iou) {
      best = g;
      best_iou = v;
    }
    any_gt |= s_valid[g] != 0;
  }
  // No valid gt: every candidate is IoU-0 background (targets.py:279-291).
  const float max_iou =
      cand_valid[i] ? fmaxf(best_iou, any_gt ? -1.0f : 0.0f) : -1.0f;
  argmax[i] = best;
  pos[i] = max_iou >= pos_thresh;
  neg[i] = max_iou < neg_hi && max_iou >= neg_lo;
}

// One axis of _mask_sample_coords for output index i.
struct MaskTap {
  int lo, hi;
  float l;
};

__device__ __forceinline__ MaskTap mask_tap(int i, int start, int crop, int M,
                                            int size) {
  const float c = (float)max(crop, 1);
  float v = __fsub_rn(__fmul_rn((float)i + 0.5f, __fdiv_rn(c, (float)M)),
                      0.5f);
  v = fminf(fmaxf(v, 0.0f), c - 1.0f);
  v = __fadd_rn(v, (float)start);
  const int f = (int)floorf(v);
  MaskTap t;
  t.hi = min(max(f + 1, 0), size - 1);
  t.lo = min(max(f, 0), size - 1);
  t.l = __fsub_rn(v, (float)t.lo);
  return t;
}

__device__ __forceinline__ float mask_at(const uint8_t* row, int x,
                                         int packed) {
  if (packed) return (float)((row[x >> 3] >> (7 - (x & 7))) & 1);
  return (float)row[x];
}

__global__ void mask_crop_resize_kernel(
    const uint8_t* __restrict__ masks, const int64_t* __restrict__ gt_index,
    const float* __restrict__ rois, int G, int H, int Wm, int W, int Q, int M,
    int packed, int total, int32_t* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int j = t % M;
  const int i = (t / M) % M;
  const int roi = t / (M * M);  // image * Q + q
  const int n = roi / Q;
  const float* box = rois + (size_t)roi * 4;
  // np.round / jnp.round: half to even.
  const int y1 = __float2int_rn(box[0]), x1 = __float2int_rn(box[1]);
  const int y2 = __float2int_rn(box[2]), x2 = __float2int_rn(box[3]);
  const MaskTap ty = mask_tap(i, y1, y2 - y1, M, H);
  const MaskTap tx = mask_tap(j, x1, x2 - x1, M, W);
  const uint8_t* m =
      masks + ((size_t)n * G + (size_t)gt_index[roi]) * H * Wm;
  const uint8_t* r0 = m + (size_t)ty.lo * Wm;
  const uint8_t* r1 = m + (size_t)ty.hi * Wm;
  const float wy0 = __fsub_rn(1.0f, ty.l), wy1 = ty.l;
  const float wx0 = __fsub_rn(1.0f, tx.l), wx1 = tx.l;
  float v = __fmul_rn(mask_at(r0, tx.lo, packed), __fmul_rn(wy0, wx0));
  v = __fadd_rn(v, __fmul_rn(mask_at(r0, tx.hi, packed), __fmul_rn(wy0, wx1)));
  v = __fadd_rn(v, __fmul_rn(mask_at(r1, tx.lo, packed), __fmul_rn(wy1, wx0)));
  v = __fadd_rn(v, __fmul_rn(mask_at(r1, tx.hi, packed), __fmul_rn(wy1, wx1)));
  out[t] = v > 0.5f ? 1 : 0;
}

}  // namespace

// anchors (S, 4) f32; gt (N, G, 4) f32; gt_valid (N, G) bool; gt_max (N, G)
// int scratch; argmax (N, S) int64; label (N, S) int32. Returns a
// cudaError_t (0 on success).
extern "C" int mrcnn_anchor_match(const float* anchors, const float* gt,
                                  const uint8_t* gt_valid, int* gt_max, int N,
                                  int S, int G, float h, float w,
                                  float pos_thresh, float neg_thresh,
                                  int64_t* argmax, int32_t* label,
                                  void* stream) {
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (N * S == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(gt_max, 0, sizeof(int) * N * G, st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + kThreads - 1) / kThreads, N);
  anchor_gt_max_kernel<<<grid, kThreads, 0, st>>>(anchors, gt, gt_valid, S, G,
                                                  h, w, gt_max);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  anchor_label_kernel<<<grid, kThreads, 0, st>>>(anchors, gt, gt_valid,
                                                 gt_max, S, G, h, w,
                                                 pos_thresh, neg_thresh,
                                                 argmax, label);
  return (int)cudaGetLastError();
}

// cand (N, P, 4) f32; cand_valid (N, P) bool; gt (N, G, 4); gt_valid (N, G)
// bool; argmax (N, P) int64; pos, neg (N, P) bool.
extern "C" int mrcnn_proposal_match(const float* cand,
                                    const uint8_t* cand_valid,
                                    const float* gt, const uint8_t* gt_valid,
                                    int N, int P, int G, float pos_thresh,
                                    float neg_hi, float neg_lo,
                                    int64_t* argmax, uint8_t* pos,
                                    uint8_t* neg, void* stream) {
  if (G < 1 || G > kMaxG) return (int)cudaErrorInvalidValue;
  if (N * P == 0) return 0;
  const dim3 grid((P + kThreads - 1) / kThreads, N);
  proposal_match_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      cand, cand_valid, gt, gt_valid, P, G, pos_thresh, neg_hi, neg_lo,
      argmax, pos, neg);
  return (int)cudaGetLastError();
}

// masks (N, G, H, Wm) uint8, bit-packed along W (Wm = W / 8, np.packbits'
// big-endian bit order) when packed, else Wm = W; gt_index (N, Q) int64 in
// [0, G); rois (N, Q, 4) f32; out (N, Q, M, M) int32 in {0, 1}.
extern "C" int mrcnn_mask_crop_resize(const uint8_t* masks,
                                      const int64_t* gt_index,
                                      const float* rois, int N, int G, int H,
                                      int Wm, int Q, int M, int packed,
                                      int32_t* out, void* stream) {
  const int total = N * Q * M * M;
  if (total == 0) return 0;
  const int W = packed ? Wm * 8 : Wm;
  mask_crop_resize_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)stream>>>(
      masks, gt_index, rois, G, H, Wm, W, Q, M, packed, total, out);
  return (int)cudaGetLastError();
}
