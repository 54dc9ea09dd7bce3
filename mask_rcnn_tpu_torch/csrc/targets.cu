// The training target creators, one launch each: K9a, anchor_targets whole,
// and K9b, proposal_targets whole with the mask-target crop-resize K8.
//
// K9a replaces mask_rcnn_tpu/models/targets.py::anchor_targets (54-120)
// with _sample_masked (31-41): the IoU of every anchor with every gt
// (masked for invalid gts and anchors outside the image), each anchor's max
// and first-index argmax, each gt's max over the anchors (ties included),
// the label in {-1, 0, 1}, the uniform sample of up to 128 positives and
// n_sample - n_pos negatives by the given priorities, and the regression
// targets. The JAX package materialised the (S, G) IoU matrix, reduced it
// both ways and sorted all S priorities twice. Here one thread-block
// cluster of kCluster blocks takes an image, each block a contiguous chunk
// of its anchors, with the gt boxes in shared memory; the per-gt max is
// folded with atomicMax on the int bits of max(iou, 0) (exact: non-negative
// floats order as their bits) and merged across the cluster through
// distributed shared memory (DSMEM). Only the sampled set matters on the
// anchor side, so instead of a sort each group's threshold is found by a
// cluster-wide radix select over an order-preserving uint32 image of the
// priorities (four 8-bit digits, histograms merged through DSMEM); keys at
// the threshold are taken in index order (the stable sort's tie order) by a
// block scan, offset by the tie counts of the lower-ranked blocks. What
// bounds it: latency (2 x 65520 anchors x 8 gts of IoU at the train shape,
// ~5 MB of inputs and outputs); the design is one launch and seven cluster
// barriers.
//
// K9b replaces proposal_targets (241-345) with _crop_resize_masks_indexed
// (190-238) and _mask_sample_coords (136-170): the candidates are the rois
// then the gt boxes; each is matched (argmax, max IoU with the zero-gt
// rule, positive and negative candidacy); the outputs are slot-ordered
// (positives in top-k order, then negatives, then the unpicked entries of
// both top-k lists in their concatenated order, then zero padding), so
// here the two groups' keys (priority descending, index ascending;
// non-candidates after, by index) are bitonic-sorted in shared memory, each
// by its own block of the image's cluster, and the other blocks read the
// sorted prefixes through DSMEM. The slots' rois, labels and normalised
// locs are gathered from the sorted order, and the first min(pos_quota,
// n_sample) slots' gt masks are cropped and resized (cv2-parity sample
// coordinates, binarised at > 0.5) straight from the (bit-packed) masks,
// one thread per output cell, spread over the cluster. What bounds it:
// latency (the sort's 66 barriers at 2008 candidates); ~3 MB of inputs
// and outputs.
//
// Arithmetic: the IoU, bbox2loc and the mask sample coordinates are written
// with round-to-nearest intrinsics and true divisions in the plain
// versions' order (ops/targets.py, ops/boxes.py), so that nvcc contracts
// nothing into an FMA: the rules downstream (thresholds, iou == gt max,
// interp > 0.5) are discontinuous, and the kernels must pick the same
// samples as the plain versions.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxG = 256;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCluster = 8;           // blocks per image, anchor kernel
constexpr int kMaxChunk = 24576;      // anchors per block: 8 bytes of smem each
constexpr int kMaxCand = 4096;        // rois + gts per image, proposal kernel
constexpr int kPropCluster = 4;       // blocks per image, proposal kernel

enum { kAll = 0, kNone = 1, kSelect = 2 };

// bbox_iou of one box with one gt box, op for op (mask_rcnn_tpu/ops/
// boxes.py:21-35, the port's ops/boxes.py::bbox_iou).
__device__ __forceinline__ float iou_rn(const float* a, const float* b) {
  const float tly = fmaxf(a[0], b[0]), tlx = fmaxf(a[1], b[1]);
  const float bry = fminf(a[2], b[2]), brx = fminf(a[3], b[3]);
  const float ih = fmaxf(__fsub_rn(bry, tly), 0.0f);
  const float iw = fmaxf(__fsub_rn(brx, tlx), 0.0f);
  const float inter = __fmul_rn(ih, iw);
  if (inter == 0.0f) return 0.0f;  // what the division below gives
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a[2], a[0]), 0.0f),
                                 fmaxf(__fsub_rn(a[3], a[1]), 0.0f));
  const float area_b = __fmul_rn(fmaxf(__fsub_rn(b[2], b[0]), 0.0f),
                                 fmaxf(__fsub_rn(b[3], b[1]), 0.0f));
  const float denom = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return denom > 0.0f ? __fdiv_rn(inter, denom) : 0.0f;
}

// bbox2loc of one box pair, op for op (ops/boxes.py::bbox2loc): heights and
// widths clamped to float32 eps, true divisions, logf.
__device__ __forceinline__ float4 bbox2loc_rn(const float* src,
                                              const float* dst) {
  const float eps = 1.1920928955078125e-07f;
  float height = __fsub_rn(src[2], src[0]);
  float width = __fsub_rn(src[3], src[1]);
  const float ctr_y = __fadd_rn(src[0], __fmul_rn(0.5f, height));
  const float ctr_x = __fadd_rn(src[1], __fmul_rn(0.5f, width));
  const float base_h = __fsub_rn(dst[2], dst[0]);
  const float base_w = __fsub_rn(dst[3], dst[1]);
  const float base_y = __fadd_rn(dst[0], __fmul_rn(0.5f, base_h));
  const float base_x = __fadd_rn(dst[1], __fmul_rn(0.5f, base_w));
  height = fmaxf(height, eps);
  width = fmaxf(width, eps);
  float4 r;
  r.x = __fdiv_rn(__fsub_rn(base_y, ctr_y), height);
  r.y = __fdiv_rn(__fsub_rn(base_x, ctr_x), width);
  r.z = logf(__fdiv_rn(fmaxf(base_h, eps), height));
  r.w = logf(__fdiv_rn(fmaxf(base_w, eps), width));
  return r;
}

// A uint32 that orders as the float: larger priority, larger key.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
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

__device__ __forceinline__ void load_box(const float* p, float* a) {
  for (int k = 0; k < 4; ++k) a[k] = p[k];
}

// Adds one to hist[bin] for each active lane, one shared atomic per
// distinct bin of the warp (uniform priorities share their top digits).
// Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(unsigned* hist, bool active,
                                         unsigned bin) {
  const unsigned lanes = __ballot_sync(kFull, active);
  if (!active) return;
  const unsigned peers = __match_any_sync(lanes, bin);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(hist + bin,
                                                         __popc(peers));
}

// One warp: in a 256-bin histogram of the keys that match the digits fixed
// so far, the digit at which the count from the top reaches `remaining`
// (1 <= remaining <= the histogram's sum). Writes it, and the count of the
// keys above it, from the lane that finds it.
__device__ __forceinline__ void find_digit(const unsigned* hist,
                                           unsigned remaining,
                                           unsigned* digit,
                                           unsigned* above) {
  const int lane = threadIdx.x & 31;
  unsigned c[8], sum = 0;
  for (int k = 0; k < 8; ++k) {
    c[k] = hist[255 - 8 * lane - k];
    sum += c[k];
  }
  unsigned incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  unsigned acc = incl - sum;
  if (acc < remaining && remaining <= incl) {
    for (int k = 0; k < 8; ++k) {
      if (acc + c[k] >= remaining) {
        *digit = 255 - 8 * lane - k;
        *above = acc;
        break;
      }
      acc += c[k];
    }
  }
}

// K9a. grid (kCluster, N), clusters of kCluster blocks along x: one cluster
// an image, block r of it the anchors [r * chunk, (r + 1) * chunk).
// Dynamic shared memory: chunk ints of state (bits 0-1 label + 1, bit 2
// inside the image, bits 8-15 argmax) and chunk words that hold the max IoU
// until the labels are known, then the sampling key of the anchor's group.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
anchor_targets_kernel(const float* __restrict__ anchors,
                      const float* __restrict__ gt,
                      const uint8_t* __restrict__ gt_valid,
                      const float* __restrict__ pri_pos,
                      const float* __restrict__ pri_neg, int S, int G,
                      float h, float w, float pos_thresh, float neg_thresh,
                      int pos_quota, int n_sample, float* __restrict__ loc,
                      int32_t* __restrict__ label) {
  __shared__ float s_gt[kMaxG * 4];
  __shared__ uint8_t s_valid[kMaxG];
  __shared__ unsigned s_gt_max[kMaxG];     // this block's, float bits
  __shared__ float s_max[kMaxG];           // the cluster's
  __shared__ unsigned s_hist[2][2][256];   // [pass parity][group][digit]
  __shared__ unsigned s_total[2][256];     // the cluster's, this pass
  __shared__ unsigned s_count[2];          // this block's candidates
  __shared__ unsigned s_warp[2][kWarps];
  __shared__ unsigned s_tile[2];
  __shared__ unsigned s_key[2], s_need[2], s_run[2];
  __shared__ int s_mode[2];
  __shared__ float s_min_max;
  extern __shared__ int s_dyn[];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int n = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int chunk = (S + kCluster - 1) / kCluster;
  const int begin = rank * chunk, end = min(S, begin + chunk);
  const int tiles = (chunk + kThreads - 1) / kThreads;
  int* s_state = s_dyn;
  float* s_iou = reinterpret_cast<float*>(s_dyn + chunk);
  unsigned* s_kv = reinterpret_cast<unsigned*>(s_dyn + chunk);  // aliases

  for (int g = tid; g < G; g += kThreads) s_gt_max[g] = 0u;
  if (tid < 2) s_count[tid] = 0u;
  load_gt(gt, gt_valid, n, G, s_gt, s_valid);

  // Match: each anchor's max and first-index argmax; each gt's max.
  for (int t = 0; t < tiles; ++t) {
    const int i = t * kThreads + tid, s = begin + i;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    bool in = false;
    if (s < end) {
      load_box(anchors + (size_t)s * 4, a);
      in = inside_image(a, h, w);
    }
    int best = 0;
    float best_iou = -1.0f;
    for (int g = 0; g < G; ++g) {
      const float v = (in && s_valid[g]) ? iou_rn(a, s_gt + g * 4) : -1.0f;
      if (g == 0 || v > best_iou) {
        best = g;
        best_iou = v;
      }
      float m = fmaxf(v, 0.0f);
      if (__any_sync(kFull, m > 0.0f)) {
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
        if (lane == 0) atomicMax(s_gt_max + g, __float_as_uint(m));
      }
    }
    if (s < end) {
      s_state[i] = (best << 8) | (in ? 4 : 0);
      s_iou[i] = best_iou;
    }
  }
  cluster.sync();
  for (int g = tid; g < G; g += kThreads) {
    unsigned m = 0u;
    for (int r = 0; r < kCluster; ++r)
      m = max(m, *cluster.map_shared_rank(s_gt_max + g, r));
    s_max[g] = __uint_as_float(m);
  }
  __syncthreads();
  if (warp == 0) {  // the smallest positive per-gt max: below it, no tie
    float lo = INFINITY;
    for (int g = lane; g < G; g += 32)
      if (s_max[g] > 0.0f) lo = fminf(lo, s_max[g]);
    for (int off = 16; off > 0; off >>= 1)
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, off));
    if (lane == 0) s_min_max = lo;
  }
  __syncthreads();

  // Labels before sampling; count the candidates of each group.
  unsigned cnt_pos = 0u, cnt_neg = 0u;
  for (int t = 0; t < tiles; ++t) {
    const int i = t * kThreads + tid, s = begin + i;
    if (s >= end) continue;
    const int st = s_state[i];
    const bool in = st & 4;
    const float best_iou = s_iou[i];
    bool gt_argmax = false;
    if (in && best_iou < pos_thresh && best_iou >= s_min_max) {
      float a[4];
      load_box(anchors + (size_t)s * 4, a);
      for (int g = 0; g < G && !gt_argmax; ++g)
        gt_argmax = s_max[g] > 0.0f && iou_rn(a, s_gt + g * 4) == s_max[g];
    }
    int lab = -1;
    if (in && best_iou < neg_thresh) lab = 0;
    if (in && gt_argmax) lab = 1;
    if (in && best_iou >= pos_thresh) lab = 1;
    s_state[i] = st | (lab + 1);
    s_kv[i] = lab == 1   ? order_key(pri_pos[(size_t)n * S + s])
              : lab == 0 ? order_key(pri_neg[(size_t)n * S + s])
                         : 0u;
    cnt_pos += lab == 1;
    cnt_neg += lab == 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt_pos += __shfl_xor_sync(kFull, cnt_pos, off);
    cnt_neg += __shfl_xor_sync(kFull, cnt_neg, off);
  }
  if (lane == 0) {
    atomicAdd(s_count, cnt_pos);
    atomicAdd(s_count + 1, cnt_neg);
  }
  cluster.sync();
  if (tid == 0) {
    unsigned tot[2] = {0u, 0u};
    for (int r = 0; r < kCluster; ++r) {
      const unsigned* c = cluster.map_shared_rank(s_count, r);
      tot[0] += c[0];
      tot[1] += c[1];
    }
    const unsigned quota0 = (unsigned)max(pos_quota, 0);
    const unsigned n_pos = min(tot[0], quota0);
    const unsigned quota[2] = {quota0,
                               (unsigned)max(n_sample - (int)n_pos, 0)};
    for (int grp = 0; grp < 2; ++grp) {
      s_mode[grp] = tot[grp] <= quota[grp] ? kAll
                    : quota[grp] == 0u     ? kNone
                                           : kSelect;
      s_key[grp] = 0u;
      s_need[grp] = quota[grp];
    }
  }
  __syncthreads();

  // Radix select of each group's threshold key T and of the number of keys
  // equal to T to take, one 8-bit digit a pass, from the top.
  const bool select = s_mode[0] == kSelect || s_mode[1] == kSelect;
  unsigned fixed = 0u;  // the digits fixed so far
  for (int pass = 0; select && pass < 4; ++pass) {
    const int shift = 24 - 8 * pass, buf = pass & 1;
    unsigned* hist = &s_hist[buf][0][0];
    for (int k = tid; k < 512; k += kThreads) hist[k] = 0u;
    __syncthreads();
    const unsigned prefix[2] = {s_key[0], s_key[1]};
    for (int t = 0; t < tiles; ++t) {
      const int i = t * kThreads + tid, s = begin + i;
      const int lab = s < end ? (s_state[i] & 3) - 1 : -1;
      const unsigned key = s < end ? s_kv[i] : 0u;
      const int grp = lab == 1 ? 0 : 1;  // a candidate is in one group
      const bool act = lab >= 0 && s_mode[grp] == kSelect &&
                       (key & fixed) == prefix[grp];
      hist_add(hist, act, grp * 256 + ((key >> shift) & 255u));
    }
    cluster.sync();
    for (int k = tid; k < 512; k += kThreads) {
      unsigned sum = 0u;
      if (s_mode[k >> 8] == kSelect)
        for (int r = 0; r < kCluster; ++r)
          sum += cluster.map_shared_rank(hist, r)[k];
      (&s_total[0][0])[k] = sum;
    }
    __syncthreads();
    if (warp < 2 && s_mode[warp] == kSelect) {
      __shared__ unsigned s_digit[2], s_above[2];
      find_digit(s_total[warp], s_need[warp], s_digit + warp,
                 s_above + warp);
      __syncwarp();
      if (lane == 0) {
        s_key[warp] |= s_digit[warp] << shift;
        s_need[warp] -= s_above[warp];
      }
    }
    fixed |= 255u << shift;
    __syncthreads();
  }
  // This block's first tie rank per group: the keys equal to T in the
  // lower-ranked blocks (their last pass's count at T's last digit).
  if (tid < 2) {
    unsigned run = 0u;
    if (s_mode[tid] == kSelect)
      for (int r = 0; r < (int)rank; ++r)
        run += cluster.map_shared_rank(&s_hist[1][tid][0], r)[s_key[tid] &
                                                              255u];
    s_run[tid] = run;
  }
  __syncthreads();
  unsigned run[2] = {s_run[0], s_run[1]};
  const int mode[2] = {s_mode[0], s_mode[1]};
  const unsigned thresh[2] = {s_key[0], s_key[1]};
  const unsigned need[2] = {s_need[0], s_need[1]};

  // Sample and write, tile by tile in index order.
  for (int t = 0; t < tiles; ++t) {
    const int i = t * kThreads + tid, s = begin + i;
    const int st = s < end ? s_state[i] : 0;
    const int lab = (st & 3) - 1;
    bool pick = false, tie[2] = {false, false};
    for (int grp = 0; grp < 2; ++grp) {
      if (lab != 1 - grp) continue;
      if (mode[grp] == kAll) {
        pick = true;
      } else if (mode[grp] == kSelect) {
        const unsigned key = s_kv[i];
        pick = key > thresh[grp];
        tie[grp] = key == thresh[grp];
      }
    }
    unsigned below[2];
    for (int grp = 0; grp < 2; ++grp) {
      const unsigned b = __ballot_sync(kFull, tie[grp]);
      below[grp] = __popc(b & ((1u << lane) - 1u));
      if (lane == 0) s_warp[grp][warp] = __popc(b);
    }
    __syncthreads();
    if (warp == 0) {
      for (int grp = 0; grp < 2; ++grp) {
        const unsigned v = s_warp[grp][lane];
        unsigned incl = v;
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned u = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += u;
        }
        s_warp[grp][lane] = incl - v;
        if (lane == 31) s_tile[grp] = incl;
      }
    }
    __syncthreads();
    for (int grp = 0; grp < 2; ++grp) {
      if (tie[grp] && run[grp] + s_warp[grp][warp] + below[grp] < need[grp])
        pick = true;
      run[grp] += s_tile[grp];
    }
    __syncthreads();
    if (s < end) {
      label[(size_t)n * S + s] = pick ? lab : -1;
      float a[4];
      load_box(anchors + (size_t)s * 4, a);
      reinterpret_cast<float4*>(loc)[(size_t)n * S + s] =
          bbox2loc_rn(a, s_gt + ((st >> 8) & 255) * 4);
    }
  }
  cluster.sync();  // no block leaves while another may read its memory
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

// Cell (i, j) of the M x M crop-resize of mask m (H rows of Wm bytes, W
// columns) to the roi `box`, binarised (_crop_resize_masks_indexed).
__device__ __forceinline__ int mask_cell(const uint8_t* m, const float* box,
                                         int i, int j, int M, int H, int Wm,
                                         int W, int packed) {
  // np.round / jnp.round: half to even.
  const int y1 = __float2int_rn(box[0]), x1 = __float2int_rn(box[1]);
  const int y2 = __float2int_rn(box[2]), x2 = __float2int_rn(box[3]);
  const MaskTap ty = mask_tap(i, y1, y2 - y1, M, H);
  const MaskTap tx = mask_tap(j, x1, x2 - x1, M, W);
  const uint8_t* r0 = m + (size_t)ty.lo * Wm;
  const uint8_t* r1 = m + (size_t)ty.hi * Wm;
  const float wy0 = __fsub_rn(1.0f, ty.l), wy1 = ty.l;
  const float wx0 = __fsub_rn(1.0f, tx.l), wx1 = tx.l;
  float v = __fmul_rn(mask_at(r0, tx.lo, packed), __fmul_rn(wy0, wx0));
  v = __fadd_rn(v, __fmul_rn(mask_at(r0, tx.hi, packed), __fmul_rn(wy0, wx1)));
  v = __fadd_rn(v, __fmul_rn(mask_at(r1, tx.lo, packed), __fmul_rn(wy1, wx0)));
  v = __fadd_rn(v, __fmul_rn(mask_at(r1, tx.hi, packed), __fmul_rn(wy1, wx1)));
  return v > 0.5f ? 1 : 0;
}

struct LocNorm {
  float mean[4], std[4];
};

// The sample counts of proposal_targets' compaction.
struct Slots {
  int n_pos, n_neg, k_pos, k_neg, L;
};

// Slot j of the compaction `sort(~all_picked, stable)[:n_sample]` of
// [pos top-k..., neg top-k..., zero padding]: its candidate index, whether
// it was picked and whether it is a positive. keys holds the two groups'
// sorted keys, L each, the candidate index in the low 32 bits.
__device__ __forceinline__ int slot_entry(int j, const Slots& c,
                                          const unsigned long long* keys,
                                          bool* picked, bool* pos) {
  *pos = j < c.n_pos;
  *picked = j < c.n_pos + c.n_neg;
  if (j < c.n_pos) return (int)(uint32_t)keys[j];
  int u = j - c.n_pos;
  if (u < c.n_neg) return (int)(uint32_t)keys[c.L + u];
  u -= c.n_neg;
  if (u < c.k_pos - c.n_pos) return (int)(uint32_t)keys[c.n_pos + u];
  u -= c.k_pos - c.n_pos;
  if (u < c.k_neg - c.n_neg) return (int)(uint32_t)keys[c.L + c.n_neg + u];
  return 0;
}

// K9b + K8. grid (kPropCluster, N), clusters of kPropCluster blocks along
// x: one cluster an image. Every block matches the image's P = P0 + G
// candidates; block 0 sorts the positive group's keys and block 1 the
// negative group's, and the other blocks copy the sorted prefixes that the
// slots read through DSMEM. Then each block writes a quarter of the slots
// and every fourth 32-cell run of the mask targets. Dynamic shared memory:
// the two groups' 8-byte keys, L each (L the power of two >= P).
__global__ void __cluster_dims__(kPropCluster, 1, 1)
    __launch_bounds__(kThreads, 1) proposal_targets_kernel(
        const float* __restrict__ roi, const uint8_t* __restrict__ roi_valid,
        const float* __restrict__ gt, const uint8_t* __restrict__ gt_valid,
        const int32_t* __restrict__ gt_class,
        const uint8_t* __restrict__ masks, const float* __restrict__ pri_pos,
        const float* __restrict__ pri_neg, int P0, int G, int L, int H,
        int Wm, int packed, float pos_thresh, float neg_hi, float neg_lo,
        int ns, int pos_quota, int M, LocNorm norm,
        float* __restrict__ sample_roi, float* __restrict__ gt_loc,
        int64_t* __restrict__ gt_label, int32_t* __restrict__ gt_mask) {
  __shared__ float s_gt[kMaxG * 4];
  __shared__ uint8_t s_valid[kMaxG];
  __shared__ uint8_t s_arg[kMaxCand];
  __shared__ unsigned s_count[2];
  extern __shared__ unsigned long long s_keys[];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, P = P0 + G;
  if (tid < 2) s_count[tid] = 0u;
  load_gt(gt, gt_valid, n, G, s_gt, s_valid);
  const bool any_gt = __syncthreads_or(tid < G && s_valid[tid]);

  // Match; blocks 0 and 1 also build their group's sort keys: non-
  // candidates take priority -inf (after every candidate, by index), as in
  // _sample_masked.
  unsigned cnt_pos = 0u, cnt_neg = 0u;
  unsigned long long* own = s_keys + min(rank, 1) * L;
  const float* own_pri = (rank == 0 ? pri_pos : pri_neg) + (size_t)n * P;
  for (int p = tid; p < L; p += kThreads) {
    unsigned long long key = ~0ull;
    if (p < P) {
      float a[4];
      bool valid;
      if (p < P0) {
        load_box(roi + ((size_t)n * P0 + p) * 4, a);
        valid = roi_valid[(size_t)n * P0 + p];
      } else {
        load_box(s_gt + (p - P0) * 4, a);
        valid = s_valid[p - P0];
      }
      int best = 0;
      float best_iou = -1.0f;
      for (int g = 0; g < G; ++g) {
        const float v = s_valid[g] ? iou_rn(a, s_gt + g * 4) : -1.0f;
        if (g == 0 || v > best_iou) {
          best = g;
          best_iou = v;
        }
      }
      // No valid gt: every candidate is IoU-0 background (targets.py:286).
      const float max_iou =
          valid ? fmaxf(best_iou, any_gt ? -1.0f : 0.0f) : -1.0f;
      const bool pos = max_iou >= pos_thresh;
      const bool neg = max_iou < neg_hi && max_iou >= neg_lo;
      s_arg[p] = (uint8_t)best;
      if (rank < 2) {
        const bool cand = rank == 0 ? pos : neg;
        key = ((unsigned long long)~order_key(cand ? own_pri[p] : -INFINITY)
               << 32) | (unsigned)p;
      }
      cnt_pos += pos;
      cnt_neg += neg;
    }
    if (rank < 2) own[p] = key;
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt_pos += __shfl_xor_sync(kFull, cnt_pos, off);
    cnt_neg += __shfl_xor_sync(kFull, cnt_neg, off);
  }
  if (lane == 0) {
    atomicAdd(s_count, cnt_pos);
    atomicAdd(s_count + 1, cnt_neg);
  }
  __syncthreads();

  // Bitonic sort of the block's group, ascending: priority descending, then
  // index ascending (the stable descending sort's order).
  if (rank < 2) {
    for (int k = 2; k <= L; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int t = tid; t < (L >> 1); t += kThreads) {
          const int i = 2 * t - (t & (j - 1));
          const unsigned long long x = own[i], y = own[i + j];
          if ((x > y) == ((i & k) == 0)) {
            own[i] = y;
            own[i + j] = x;
          }
        }
        __syncthreads();
      }
    }
  }

  Slots c;
  c.L = L;
  c.k_pos = min(max(pos_quota, 0), P);
  c.k_neg = min(ns, P);
  c.n_pos = min((int)s_count[0], c.k_pos);
  c.n_neg = min(min((int)s_count[1], c.k_neg), max(ns - c.n_pos, 0));
  // The sorted prefixes that the slots read: positions [0, k_pos) of the
  // positive order, [0, k_neg) of the negative one.
  cluster.sync();
  for (int grp = 0; grp < 2; ++grp) {
    if (grp == rank) continue;
    const unsigned long long* src =
        cluster.map_shared_rank(s_keys + grp * L, grp);
    for (int r = tid; r < (grp == 0 ? c.k_pos : c.k_neg); r += kThreads)
      s_keys[grp * L + r] = src[r];
  }
  __syncthreads();

  const int j0 = rank * ns / kPropCluster;
  const int j1 = (rank + 1) * ns / kPropCluster;
  for (int j = j0 + tid; j < j1; j += kThreads) {
    bool picked, pos;
    const int idx = slot_entry(j, c, s_keys, &picked, &pos);
    float b[4];
    load_box(idx < P0 ? roi + ((size_t)n * P0 + idx) * 4
                      : s_gt + (idx - P0) * 4, b);
    const int g = s_arg[idx];
    const size_t o = (size_t)n * ns + j;
    reinterpret_cast<float4*>(sample_roi)[o] = make_float4(b[0], b[1], b[2],
                                                           b[3]);
    float4 l = bbox2loc_rn(b, s_gt + g * 4);
    l.x = __fdiv_rn(__fsub_rn(l.x, norm.mean[0]), norm.std[0]);
    l.y = __fdiv_rn(__fsub_rn(l.y, norm.mean[1]), norm.std[1]);
    l.z = __fdiv_rn(__fsub_rn(l.z, norm.mean[2]), norm.std[2]);
    l.w = __fdiv_rn(__fsub_rn(l.w, norm.mean[3]), norm.std[3]);
    reinterpret_cast<float4*>(gt_loc)[o] = l;
    int64_t cls = -1;
    if (picked) cls = pos ? (int64_t)gt_class[(size_t)n * G + g] + 1 : 0;
    gt_label[o] = cls;
  }

  // K8: the positive slots' mask targets, -1 elsewhere; the positive slots
  // come first, so the cells go round the cluster's warps in runs of 32.
  const int W = packed ? Wm * 8 : Wm, MM = M * M;
  const int n_crop = min(max(pos_quota, 0), ns);
  const int stride = kPropCluster * kThreads;
  for (int e0 = (rank * kWarps + warp) * 32; e0 < ns * MM; e0 += stride) {
    const int e = e0 + lane;
    if (e >= ns * MM) break;
    const int j = e / MM, cell = e - j * MM;
    int v = -1;
    if (j < n_crop) {
      bool picked, pos;
      const int idx = slot_entry(j, c, s_keys, &picked, &pos);
      if (pos) {
        float b[4];
        load_box(idx < P0 ? roi + ((size_t)n * P0 + idx) * 4
                          : s_gt + (idx - P0) * 4, b);
        const uint8_t* m =
            masks + ((size_t)n * G + s_arg[idx]) * (size_t)H * Wm;
        v = mask_cell(m, b, cell / M, cell % M, M, H, Wm, W, packed);
      }
    }
    gt_mask[(size_t)n * ns * MM + e] = v;
  }
  cluster.sync();  // blocks 0 and 1 stay until the others have copied
}

}  // namespace

// The launchers' limits, for the wrappers' checks: out[0] gt boxes an
// image, out[1] anchors, out[2] rois + gts an image.
extern "C" int mrcnn_targets_limits(int* out) {
  out[0] = kMaxG;
  out[1] = kCluster * kMaxChunk;
  out[2] = kMaxCand;
  return 0;
}

// anchors (S, 4) f32; gt (N, G, 4) f32; gt_valid (N, G) bool; pri_pos,
// pri_neg (N, S) f32; loc (N, S, 4) f32, 16-byte aligned; label (N, S)
// int32. Returns a cudaError_t (0 on success).
extern "C" int mrcnn_anchor_targets(const float* anchors, const float* gt,
                                    const uint8_t* gt_valid,
                                    const float* pri_pos,
                                    const float* pri_neg, int N, int S,
                                    int G, float h, float w,
                                    float pos_thresh, float neg_thresh,
                                    int pos_quota, int n_sample, float* loc,
                                    int32_t* label, void* stream) {
  if (G < 1 || G > kMaxG || S < 1 || S > kCluster * kMaxChunk)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int chunk = (S + kCluster - 1) / kCluster;
  const size_t smem = (size_t)chunk * 8;
  cudaError_t e = cudaFuncSetAttribute(
      anchor_targets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  anchor_targets_kernel<<<dim3(kCluster, N), kThreads, smem,
                          (cudaStream_t)stream>>>(
      anchors, gt, gt_valid, pri_pos, pri_neg, S, G, h, w, pos_thresh,
      neg_thresh, pos_quota, n_sample, loc, label);
  return (int)cudaGetLastError();
}

// roi (N, P0, 4) f32; roi_valid (N, P0) bool; gt (N, G, 4) f32; gt_valid
// (N, G) bool; gt_class (N, G) int32; masks (N, G, H,
// Wm) uint8, bit-packed along W (Wm = W / 8, np.packbits' order) when
// packed; pri_pos, pri_neg (N, P0 + G) f32; norm: 4 means then 4 stds, on
// the host. Outputs: sample_roi, gt_loc (N, ns, 4) f32, 16-byte aligned;
// gt_label (N, ns) int64; gt_mask (N, ns, M, M) int32.
extern "C" int mrcnn_proposal_targets(
    const float* roi, const uint8_t* roi_valid, const float* gt,
    const uint8_t* gt_valid, const int32_t* gt_class, const uint8_t* masks, const float* pri_pos, const float* pri_neg,
    const float* norm, int N, int P0, int G, int H, int Wm, int packed,
    float pos_thresh, float neg_hi, float neg_lo, int ns, int pos_quota,
    int M, float* sample_roi, float* gt_loc, int64_t* gt_label,
    int32_t* gt_mask, void* stream) {
  const int P = P0 + G;
  if (G < 1 || G > kMaxG || P0 < 0 || P > kMaxCand || ns < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  int L = 1;
  while (L < P) L <<= 1;
  const size_t smem = (size_t)2 * L * sizeof(unsigned long long);
  cudaError_t e = cudaFuncSetAttribute(
      proposal_targets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  LocNorm ln;
  for (int k = 0; k < 4; ++k) {
    ln.mean[k] = norm[k];
    ln.std[k] = norm[4 + k];
  }
  proposal_targets_kernel<<<dim3(kPropCluster, N), kThreads, smem,
                            (cudaStream_t)stream>>>(
      roi, roi_valid, gt, gt_valid, gt_class, masks, pri_pos,
      pri_neg, P0, G, L, H, Wm, packed, pos_thresh, neg_hi, neg_lo, ns,
      pos_quota, M, ln, sample_roi, gt_loc, gt_label, gt_mask);
  return (int)cudaGetLastError();
}
