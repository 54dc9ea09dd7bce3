// K2 and K3: exact greedy NMS over score-sorted boxes, first max_out
// survivors, batched over independent problems; and K3's main-path form,
// the decode's whole selection in one launch.
//
// K2 replaces mask_rcnn_tpu/ops/nms.py::nms_blocked_mask (113-174, with
// _cross_suppression 91-110) on the proposal path: 6000 sorted boxes ->
// 1000 at IoU 0.7 when serving, (2, 12000) -> 2000 in the train step.
// K3 replaces nms.py::nms_fixpoint_mask (48-88) plus the compaction of
// nms_padded (234-244), and, on the decode path, the selection half of
// mask_rcnn_tpu/models/mask_rcnn.py::_decode_single (170-219): per class
// the lax.top_k of its probabilities, the NMS at 0.5 down to D = 100, the
// rounded-zero-area drop, then per image the final lax.top_k over the
// n_fg x D kept boxes (80 x 100 at COCO).
//
// The NMS core (tiled_scan) is one block per problem: a greedy scan in
// tiles of 64 candidates over a compact kept set held in shared memory
// (the JAX function's (max_out, 4) buffer). Per tile:
//   1. every warp tests the tile's 64 candidates (two per lane, in
//      registers) against its stride of the kept set and ORs its ballots
//      into one 64-bit "suppressed by a kept box" word;
//   2. meanwhile the warps build the tile's 64 x 64 upper-triangular
//      suppression bits (one ballot pair per row) and stage the next tile,
//      loaded from device memory at the start of the tile, with its
//      validity, into shared memory;
//   3. one warp resolves the tile greedily on those bits (a find-first-set
//      walk over ~removed & valid, the survivors only), appends them to the
//      kept set and the output in order, and stops at max_out.
// K2 runs it with 1024 threads a problem (nms_tiled_kernel<1024>); past
// kKeptCap kept boxes the rest live in a (max_out - kKeptCap, 4) float32
// scratch that the caller allocates, read back through L1 by the same
// block. The standalone K3 (nms_small, N <= 1024) runs the same kernel with
// 256 threads a problem and its whole kept set in shared memory.
//
// K3 on the decode path (decode_select_kernel) is one launch for a batch:
// one 1024-thread block per (image, foreground class), which
//   a. compacts the class's rows that are valid and above score_thresh
//      (warp-aggregated shared-memory atomics) into packed 64-bit keys,
//      (order-preserving probability bits << 32) | ~row, so that a
//      descending order is lax.top_k's: probability, then the lower row;
//   b. sorts them with a bitonic sort (only the valid rows, padded to a
//      power of two: no library sort of all Rp), a key a thread in
//      registers with warp shuffles up to 1024 keys, else in shared memory;
//   c. runs the NMS core on the first k (nms_topk_per_class, or all) at
//      nms_thresh, the boxes gathered by row from the (N, Rp, C, 4) decoded
//      boxes as the scan stages each tile, and stops at D kept;
//   d. drops kept boxes whose rounded (rintf, half to even) area is not
//      > 0, and writes the rest, in order, to a (N, n_fg, D) scratch;
//   e. takes a ticket: after a __threadfence(), an atomicAdd on the image's
//      counter. The block that draws the last ticket merges the image's
//      n_fg sorted lists, keys (score bits << 32) | ~(class * D + slot), in
//      a tree of log2(n_fg) rounds of pairwise merges that keep the top D
//      (each key placed by a binary search in its partner list), writes
//      them out, and resets the counter to 0 for the next launch.
// The last-arriving block was chosen over a cluster that splits the
// classes (as K9a merges through distributed shared memory): a cluster
// holds at most 16 blocks, so 80 classes would run 5-10 to a block one
// after another, while the ticket keeps one block per class in parallel
// and costs one atomic a block and a D-list read back through L2.
//
// What bounds it on an H100: latency, not bytes or operations. Bytes are
// the n_fg x Rp probabilities and validity, the boxes of the <= k selected
// rows and the D outputs (~0.39 MB at COCO serving); the critical path is
// a block's chain of barriers: the sort's stages across warps, a scan step
// per tile, and the merge's rounds.
//
// The predicate is the division-free one of mask_rcnn_tpu/ops/nms.py:27-45
// and 107-109, inter > t * (area_i + area_j - inter) with
// area = max(h,0) * max(w,0), written with round-to-nearest intrinsics so
// that nvcc cannot contract it into FMAs: decisions are bit-identical to
// the float32 plain version. The scan computes each box's area once, with
// the same operations, so a precomputed area changes no decision. The
// decode does no other arithmetic than the predicate and the rounded area,
// so its outputs equal the plain version's bit for bit.
// Rows with valid == 0 are never kept and so never suppress.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
// Kept boxes of K2 held in shared memory (80 KB with their areas); more
// spill to the caller's scratch, sized by mrcnn_nms_kept_cap().
constexpr int kKeptCap = 4096;
// The standalone K3: N <= kSmallMaxN boxes a problem, 256 threads.
constexpr int kSmallMaxN = 1024;
constexpr int kSmallThreads = 256;
// The decode kernel's limits: rows a class (Rp), n_fg * D candidates of the
// merge (keys in shared memory, 8 bytes each), classes, and D.
constexpr int kDecThreads = 1024;
constexpr int kDecMaxRows = 4096;
constexpr int kDecMaxCands = 8192;
constexpr int kDecMaxClasses = 1024;
constexpr int kDecMaxOut = 1024;

// a = (y1, x1, y2, x2)
__device__ __forceinline__ float box_area(const float4 a) {
  return __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.0f),
                   fmaxf(__fsub_rn(a.w, a.y), 0.0f));
}

// Does the earlier box a (area area_a) suppress the later box b?
__device__ __forceinline__ bool suppresses_area(const float4 a, float area_a,
                                                const float4 b, float area_b,
                                                float thresh) {
  const float ih = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float iw = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(ih, iw);
  return inter >
         __fmul_rn(thresh, __fsub_rn(__fadd_rn(area_a, area_b), inter));
}

// Shared memory of the NMS core: kept[cap] float4, tile[2][64] float4,
// rows[64] uint64, kept_area[cap] float, tile_valid[2][64] uint8.
struct ScanSmem {
  float4* kept;
  float4* tile;
  uint64_t* rows;
  float* kept_area;
  uint8_t* tile_valid;
};

__host__ __device__ inline size_t scan_smem_bytes(int cap) {
  return (size_t)cap * (sizeof(float4) + sizeof(float)) +
         2 * kTile * sizeof(float4) + kTile * sizeof(uint64_t) +
         2 * kTile * sizeof(uint8_t);
}

__device__ __forceinline__ ScanSmem scan_smem(void* base, int cap) {
  ScanSmem s;
  s.kept = reinterpret_cast<float4*>(base);
  s.tile = s.kept + cap;
  s.rows = reinterpret_cast<uint64_t*>(s.tile + 2 * kTile);
  s.kept_area = reinterpret_cast<float*>(s.rows + kTile);
  s.tile_valid = reinterpret_cast<uint8_t*>(s.kept_area + cap);
  return s;
}

// The NMS core: a greedy scan of src's N candidates (src.load(i, &box,
// &valid), in score order) that keeps at most max_out, the first cap of
// them in sm.kept and the rest in spill (null when max_out <= cap); each
// kept candidate i goes to src.emit(slot, i) in order. Every thread of the
// block calls it; returns the number kept.
template <int kThreads, class Src>
__device__ __forceinline__ int tiled_scan(const Src& src, int N,
                                          float thresh, int max_out, int cap,
                                          const ScanSmem& sm, float4* spill) {
  __shared__ uint64_t s_sup;
  __shared__ int s_count;
  constexpr int n_warps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  if (tid < kTile) {
    float4 box = zero;
    bool v = false;
    if (tid < N) src.load(tid, &box, &v);
    sm.tile[tid] = box;
    sm.tile_valid[tid] = v;
  }
  if (tid == 0) {
    s_sup = 0;
    s_count = 0;
  }
  __syncthreads();

  const int n_tiles = (N + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int count = s_count;
    if (count >= max_out) break;
    const int base = t * kTile;
    const float4* cur = sm.tile + (t & 1) * kTile;
    const uint8_t* cur_valid = sm.tile_valid + (t & 1) * kTile;

    // The next tile, loaded now and staged after the tests.
    const int nxt = base + kTile + tid;
    float4 next_box = zero;
    bool next_valid = false;
    if (tid < kTile && nxt < N) src.load(nxt, &next_box, &next_valid);

    // 1. Candidates lane and lane + 32 against this warp's kept boxes.
    const float4 c0 = cur[lane], c1 = cur[lane + 32];
    const float a0 = box_area(c0), a1 = box_area(c1);
    bool s0 = false, s1 = false;
    const int in_smem = count < cap ? count : cap;
    int k = warp;
    for (; k < in_smem; k += n_warps) {
      const float4 kb = sm.kept[k];
      const float ka = sm.kept_area[k];
      s0 |= suppresses_area(kb, ka, c0, a0, thresh);
      s1 |= suppresses_area(kb, ka, c1, a1, thresh);
    }
    for (; k < count; k += n_warps) {  // the spilled part of the kept set
      const float4 kb = spill[k - cap];
      const float ka = box_area(kb);
      s0 |= suppresses_area(kb, ka, c0, a0, thresh);
      s1 |= suppresses_area(kb, ka, c1, a1, thresh);
    }
    const uint64_t sup = (uint64_t)__ballot_sync(0xffffffffu, s0) |
                         ((uint64_t)__ballot_sync(0xffffffffu, s1) << 32);
    if (lane == 0 && sup) atomicOr((unsigned long long*)&s_sup, sup);

    // 2. Row i of the tile: bit j set when i < j and i suppresses j.
    for (int i = warp; i < kTile; i += n_warps) {
      const float4 a = cur[i];
      const float ai = box_area(a);
      const bool r0 = lane > i && suppresses_area(a, ai, c0, a0, thresh);
      const bool r1 = lane + 32 > i && suppresses_area(a, ai, c1, a1, thresh);
      const uint64_t row = (uint64_t)__ballot_sync(0xffffffffu, r0) |
                           ((uint64_t)__ballot_sync(0xffffffffu, r1) << 32);
      if (lane == 0) sm.rows[i] = row;
    }
    if (tid < kTile) {
      sm.tile[((t + 1) & 1) * kTile + tid] = next_box;
      sm.tile_valid[((t + 1) & 1) * kTile + tid] = next_valid;
    }
    __syncthreads();

    // 3. One warp resolves the tile in score order (slots past N were
    // staged with valid 0).
    if (warp == 0) {
      const uint64_t live =
          (uint64_t)__ballot_sync(0xffffffffu, cur_valid[lane] != 0) |
          ((uint64_t)__ballot_sync(0xffffffffu, cur_valid[lane + 32] != 0)
           << 32);
      uint64_t keep = 0;
      if (lane == 0) {
        uint64_t todo = live & ~s_sup;
        s_sup = 0;
        for (int room = max_out - count; todo && room > 0; --room) {
          const int i = __ffsll((long long)todo) - 1;
          keep |= 1ULL << i;
          todo &= todo - 1;
          todo &= ~sm.rows[i];
        }
        s_count = count + __popcll(keep);
      }
      keep = __shfl_sync(0xffffffffu, keep, 0);
      for (int j = lane; j < kTile; j += 32) {
        if (!((keep >> j) & 1ULL)) continue;
        const int r = count + __popcll(keep & ((1ULL << j) - 1));
        src.emit(r, base + j);
        const float4 box = cur[j];
        if (r < cap) {
          sm.kept[r] = box;
          sm.kept_area[r] = box_area(box);
        } else {
          spill[r - cap] = box;
        }
      }
    }
    __syncthreads();
  }
  return s_count;
}

// Candidates of K2 and the standalone K3: one problem's sorted boxes and
// valid flags in device memory; kept positions to (out_pos, out_mask).
struct SortedBoxes {
  const float4* boxes;
  const uint8_t* valid;
  int* pos;
  uint8_t* ok;
  __device__ void load(int i, float4* box, bool* v) const {
    *box = boxes[i];
    *v = valid[i] != 0;
  }
  __device__ void emit(int r, int i) const {
    pos[r] = i;
    ok[r] = 1;
  }
};

// K2 (kThreads 1024) and the standalone K3 (256). grid B; dynamic shared
// memory scan_smem_bytes(cap). spill (B, max_out - cap) float4 holds kept
// boxes cap.. when max_out > cap, else it is null.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
nms_tiled_kernel(const float4* __restrict__ boxes,
                 const uint8_t* __restrict__ valid, int N, float thresh,
                 int max_out, int cap, float4* spill,
                 int* __restrict__ out_pos, uint8_t* __restrict__ out_mask) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.x;
  SortedBoxes src;
  src.boxes = boxes + (size_t)b * N;
  src.valid = valid + (size_t)b * N;
  src.pos = out_pos + (size_t)b * max_out;
  src.ok = out_mask + (size_t)b * max_out;
  float4* sp = spill ? spill + (size_t)b * (max_out - cap) : nullptr;
  const int kept = tiled_scan<kThreads>(src, N, thresh, max_out, cap,
                                        scan_smem(smem, cap), sp);
  for (int k = kept + threadIdx.x; k < max_out; k += kThreads) {
    src.pos[k] = -1;
    src.ok[k] = 0;
  }
}

template <int kThreads>
int launch_nms(const void* boxes, const void* valid, void* spill, int B,
               int N, float thresh, int max_out, int cap, void* out_pos,
               void* out_mask, void* stream) {
  const size_t smem = scan_smem_bytes(cap);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)nms_tiled_kernel<kThreads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  nms_tiled_kernel<kThreads><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const uint8_t*)valid, N, thresh, max_out, cap,
      (float4*)spill, (int*)out_pos, (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ decode (K3)

// Unsigned bits whose order is the float order (-0 below +0; NaN never
// reaches a key: it fails the score threshold).
__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Key of value f at index i: descending order is f's, then the lower i.
__device__ __forceinline__ unsigned long long sort_key(float f, uint32_t i) {
  return ((unsigned long long)order_bits(f) << 32) | (0xffffffffu - i);
}

__device__ __forceinline__ uint32_t key_index(unsigned long long key) {
  return 0xffffffffu - (uint32_t)key;
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  return from_order_bits((uint32_t)(key >> 32));
}

// Smallest power of two >= n (1 for n <= 1).
__device__ __forceinline__ int pow2_at_least(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

// Sorts keys[0, n) (n a power of two) descending; every thread of the block
// calls it after the keys are written, and they are sorted on return.
template <int kThreads>
__device__ void bitonic_sort_desc(unsigned long long* keys, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool desc = (i & size) == 0;
        const unsigned long long a = keys[i], b = keys[j];
        if ((a < b) == desc) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Sorts keys descending when n (a power of two) <= kThreads, one key a
// thread in a register: compare-exchanges within a warp by shuffles, across
// warps through keys[0, kThreads) in shared memory (two barriers a stage,
// 15 of the 55 stages at n = 1024). mine is thread t's key (0 past the
// data); on return keys[0, n) is sorted.
template <int kThreads>
__device__ void bitonic_sort_reg(unsigned long long* keys,
                                 unsigned long long mine, int n) {
  const int t = threadIdx.x;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      unsigned long long other;
      if (stride >= 32) {
        keys[t] = mine;
        __syncthreads();
        other = keys[t ^ stride];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(0xffffffffu, mine, stride);
      }
      const bool keep_max = ((t & stride) == 0) == ((t & size) == 0);
      mine = keep_max ? max(mine, other) : min(mine, other);
    }
  }
  keys[t] = mine;
  __syncthreads();
}

// Does a kept box keep a positive area after rounding its corners (half to
// even, as torch.round / jnp.round)?
__device__ __forceinline__ bool rounded_area_positive(const float4 b) {
  const float h = __fsub_rn(rintf(b.z), rintf(b.x));
  const float w = __fsub_rn(rintf(b.w), rintf(b.y));
  return __fmul_rn(h, w) > 0.0f;
}

// Candidates of one (image, class): the sorted keys' rows, boxes gathered
// from the decoded boxes (row stride C float4s); kept slots record which
// sorted candidate they hold.
struct ClassCandidates {
  const unsigned long long* keys;
  const float4* boxes;
  int C;
  int* kept_cand;
  __device__ void load(int i, float4* box, bool* v) const {
    *box = boxes[(size_t)key_index(keys[i]) * C];
    *v = true;
  }
  __device__ void emit(int r, int i) const { kept_cand[r] = i; }
};

size_t decode_smem_bytes(int keys_cap, int D) {
  return (size_t)keys_cap * sizeof(unsigned long long) + scan_smem_bytes(D) +
         (size_t)D * sizeof(int);
}

// grid (n_fg, N), kDecThreads threads; dynamic shared memory
// decode_smem_bytes: keys[keys_cap] uint64, the NMS core's (cap D), then
// kept_cand[D] int.
__global__ void __launch_bounds__(kDecThreads)
decode_select_kernel(const float* __restrict__ prob,
                     const float4* __restrict__ boxes,
                     const uint8_t* __restrict__ roi_valid, int Rp, int C,
                     float score_thresh, int k, float nms_thresh, int D,
                     int keys_cap, float4* __restrict__ s_boxes,
                     float* __restrict__ s_scores, int* __restrict__ s_counts,
                     unsigned* __restrict__ tickets,
                     float4* __restrict__ out_boxes,
                     int* __restrict__ out_labels,
                     float* __restrict__ out_scores,
                     uint8_t* __restrict__ out_valid) {
  extern __shared__ unsigned long long dsm[];
  unsigned long long* keys = dsm;
  const ScanSmem sm = scan_smem(keys + keys_cap, D);
  int* kept_cand = reinterpret_cast<int*>(sm.tile_valid + 2 * kTile);
  __shared__ int s_cnt, s_last;
  __shared__ int s_len[2][kDecMaxClasses];  // list lengths of the merge

  const int n_fg = gridDim.x, l = blockIdx.x, n = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // a. The class's valid rows above the threshold, as sort keys.
  if (tid == 0) s_cnt = 0;
  __syncthreads();
  const float* p_img = prob + (size_t)n * Rp * C + (l + 1);
  const uint8_t* v_img = roi_valid + (size_t)n * Rp;
  for (int r0 = 0; r0 < Rp; r0 += kDecThreads) {
    const int r = r0 + tid;
    float p = 0.0f;
    bool ok = false;
    if (r < Rp) {
      p = p_img[(size_t)r * C];
      ok = v_img[r] && p > score_thresh;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, ok);
    int base = 0;
    if (lane == 0 && ball) base = atomicAdd(&s_cnt, __popc(ball));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (ok) keys[base + __popc(ball & ((1u << lane) - 1))] = sort_key(p, r);
  }
  __syncthreads();
  const int cnt = s_cnt;

  // b. Sort them (padded with 0, below every key).
  const int n_sort = pow2_at_least(cnt);
  if (n_sort <= kDecThreads) {
    const unsigned long long mine = tid < cnt ? keys[tid] : 0;
    __syncthreads();
    bitonic_sort_reg<kDecThreads>(keys, mine, n_sort);
  } else {
    for (int i = cnt + tid; i < n_sort; i += kDecThreads) keys[i] = 0;
    __syncthreads();
    bitonic_sort_desc<kDecThreads>(keys, n_sort);
  }

  // c. Greedy NMS over the first k.
  const int k_eff = (k > 0 && k < Rp) ? k : Rp;
  ClassCandidates src;
  src.keys = keys;
  src.boxes = boxes + (size_t)n * Rp * C + (l + 1);
  src.C = C;
  src.kept_cand = kept_cand;
  const int kept = tiled_scan<kDecThreads>(src, min(cnt, k_eff), nms_thresh,
                                           D, D, sm, nullptr);

  // d. The rounded-area drop, then the survivors in order to the scratch.
  const size_t list = (size_t)n * n_fg + l;
  if (warp == 0) {
    int out = 0;
    for (int j0 = 0; j0 < kept; j0 += 32) {
      const int j = j0 + lane;
      const bool pass = j < kept && rounded_area_positive(sm.kept[j]);
      const unsigned ball = __ballot_sync(0xffffffffu, pass);
      if (pass) {
        const int slot = out + __popc(ball & ((1u << lane) - 1));
        s_boxes[list * D + slot] = sm.kept[j];
        s_scores[list * D + slot] = key_value(keys[kept_cand[j]]);
      }
      out += __popc(ball);
    }
    if (lane == 0) s_counts[list] = out;
  }

  // e. The last block of the image to finish merges the n_fg lists.
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[n], 1u) == (unsigned)(n_fg - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // Each class's list is sorted (score, then slot): a tree of pairwise
  // merges keeps the top D, each element placed by its rank, its index in
  // its list plus a binary search in the partner list (keys are unique).
  // A round's lists live at i * D in `from`; the merged ones go to `to`.
  if (tid < n_fg) s_len[0][tid] = __ldcg(s_counts + (size_t)n * n_fg + tid);
  const float4* img_boxes = s_boxes + (size_t)n * n_fg * D;
  const float* img_scores = s_scores + (size_t)n * n_fg * D;
  __syncthreads();
  unsigned long long* from = keys;
  unsigned long long* to = keys + (size_t)n_fg * D;
  for (int e = tid; e < n_fg * D; e += kDecThreads) {
    if (e % D < s_len[0][e / D]) {
      from[e] = sort_key(__ldcg(img_scores + e), (uint32_t)e);
    }
  }
  __syncthreads();
  int lists = n_fg, cur = 0;
  while (lists > 1) {
    const int* len = s_len[cur];
    for (int e = tid; e < lists * D; e += kDecThreads) {
      const int li = e / D, p = e - li * D;
      if (p >= len[li]) continue;
      const unsigned long long key = from[e];
      int rank = p;
      if ((li ^ 1) < lists) {
        const unsigned long long* other = from + (size_t)(li ^ 1) * D;
        int lo = 0, hi = len[li ^ 1];
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (other[mid] > key) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        rank += lo;
      }
      if (rank < D) to[(size_t)(li >> 1) * D + rank] = key;
    }
    const int merged = (lists + 1) / 2;
    if (tid < merged) {
      const int second = 2 * tid + 1 < lists ? len[2 * tid + 1] : 0;
      s_len[cur ^ 1][tid] = min(len[2 * tid] + second, D);
    }
    __syncthreads();
    unsigned long long* tmp = from;
    from = to;
    to = tmp;
    cur ^= 1;
    lists = merged;
  }

  for (int s = tid; s < D; s += kDecThreads) {
    const size_t o = (size_t)n * D + s;
    if (s < s_len[cur][0]) {
      const unsigned long long key = from[s];
      const uint32_t e = key_index(key);
      out_boxes[o] = __ldcg(img_boxes + e);
      out_labels[o] = (int)(e / D);
      out_scores[o] = key_value(key);
      out_valid[o] = 1;
    } else {
      out_boxes[o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      out_labels[o] = -1;
      out_scores[o] = 0.0f;
      out_valid[o] = 0;
    }
  }
  if (tid == 0) tickets[n] = 0;
}

}  // namespace

// K2's kept boxes in shared memory: past this many, mrcnn_nms_blocked takes
// a spill for the rest.
extern "C" int mrcnn_nms_kept_cap() { return kKeptCap; }

// K2. boxes (B, N, 4) float32 sorted, valid (B, N) uint8; spill
// (B, max_out - mrcnn_nms_kept_cap(), 4) float32 when max_out exceeds the
// cap, else null; out_pos (B, max_out) int32, out_mask (B, max_out) uint8.
// Returns a cudaError_t (0 on success).
extern "C" int mrcnn_nms_blocked(const void* boxes, const void* valid,
                                 void* spill, int B, int N, float thresh,
                                 int max_out, void* out_pos, void* out_mask,
                                 void* stream) {
  if (B == 0 || max_out == 0) return 0;
  if (max_out > kKeptCap && !spill) return (int)cudaErrorInvalidValue;
  const int cap = max_out < kKeptCap ? max_out : kKeptCap;
  return launch_nms<1024>(boxes, valid, spill, B, N, thresh, max_out, cap,
                          out_pos, out_mask, stream);
}

// K3, standalone. Same buffers as K2 without the spill; N <= kSmallMaxN
// (ops/nms.py::SMALL_MAX_N routes larger N to K2), so the kept set,
// min(max_out, N) boxes, fits in shared memory.
extern "C" int mrcnn_nms_small(const void* boxes, const void* valid, int B,
                               int N, float thresh, int max_out, void* out_pos,
                               void* out_mask, void* stream) {
  if (B == 0 || max_out == 0) return 0;
  if (N > kSmallMaxN) return (int)cudaErrorInvalidValue;
  const int cap = max_out < N ? max_out : N;
  return launch_nms<kSmallThreads>(boxes, valid, nullptr, B, N, thresh,
                                   max_out, cap, out_pos, out_mask, stream);
}

// The decode kernel's limits, for ops/nms.py::decode_limits(): out[0] rows
// a class, out[1] n_fg * D, out[2] classes, out[3] D.
extern "C" int mrcnn_decode_limits(int* out) {
  out[0] = kDecMaxRows;
  out[1] = kDecMaxCands;
  out[2] = kDecMaxClasses;
  out[3] = kDecMaxOut;
  return 0;
}

// K3 on the decode path. prob (N, Rp, C) float32 with class 0 the
// background, boxes (N, Rp, C, 4) float32 decoded and clipped, roi_valid
// (N, Rp) uint8; scratch s_boxes (N, C - 1, D, 4) float32, s_scores
// (N, C - 1, D) float32, s_counts (N, C - 1) int32 (no contents needed);
// tickets (N) uint32, zero before the first call and left zero by each;
// out_boxes (N, D, 4) float32, out_labels (N, D) int32, out_scores (N, D)
// float32, out_valid (N, D) uint8. k <= 0 or k >= Rp keeps every row a
// class. Returns a cudaError_t (0 on success).
extern "C" int mrcnn_decode_select(
    const void* prob, const void* boxes, const void* roi_valid, int N, int Rp,
    int C, float score_thresh, int k, float nms_thresh, int D, void* s_boxes,
    void* s_scores, void* s_counts, void* tickets, void* out_boxes,
    void* out_labels, void* out_scores, void* out_valid, void* stream) {
  const int n_fg = C - 1;
  if (N == 0 || D == 0) return 0;
  if (Rp > kDecMaxRows || n_fg < 1 || n_fg > kDecMaxClasses ||
      D > kDecMaxOut || (long long)n_fg * D > kDecMaxCands)
    return (int)cudaErrorInvalidValue;
  // keys: a class's rows padded to a power of two (at least one a thread);
  // the merge's lists and its first round's output. Even: the core's
  // float4s follow.
  int keys_cap = kDecThreads;
  while (keys_cap < Rp) keys_cap <<= 1;
  keys_cap = max(keys_cap, (n_fg + (n_fg + 1) / 2) * D);
  keys_cap += keys_cap & 1;
  const size_t smem = decode_smem_bytes(keys_cap, D);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)decode_select_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  decode_select_kernel<<<dim3(n_fg, N), kDecThreads, smem,
                         (cudaStream_t)stream>>>(
      (const float*)prob, (const float4*)boxes, (const uint8_t*)roi_valid, Rp,
      C, score_thresh, k, nms_thresh, D, keys_cap, (float4*)s_boxes,
      (float*)s_scores, (int*)s_counts, (unsigned*)tickets,
      (float4*)out_boxes, (int*)out_labels, (float*)out_scores,
      (uint8_t*)out_valid);
  return (int)cudaGetLastError();
}
