// K2 and K3: exact greedy NMS over score-sorted boxes, first max_out
// survivors, batched over independent problems (images, or image x class).
//
// K2 replaces mask_rcnn_tpu/ops/nms.py::nms_blocked_mask (113-174, with
// _cross_suppression 91-110) on the proposal path: 6000 sorted boxes ->
// 1000 at IoU 0.7 when serving, (2, 12000) -> 2000 in the train step. K3
// replaces nms.py::nms_fixpoint_mask (48-88) plus the compaction of
// nms_padded (234-244) on the decode path: 80 classes x 256 sorted boxes ->
// 100 at IoU 0.5.
//
// K2 is one launch, one block of 1024 threads per problem: a greedy scan in
// tiles of 64 candidates over a compact kept set, the JAX function's
// (max_out, 4) buffer, held in shared memory. Per tile:
//   1. every warp tests the tile's 64 candidates (two per lane, in
//      registers) against its stride of the kept set and ORs its ballots
//      into one 64-bit "suppressed by a kept box" word;
//   2. meanwhile the warps build the tile's 64 x 64 upper-triangular
//      suppression bits (one ballot pair per row) and stage the next tile,
//      loaded from device memory at the start of the tile;
//   3. one warp resolves the tile greedily on those bits (a find-first-set
//      walk over the survivors only), appends them to the kept set and the
//      output in order, and stops at max_out.
// It replaces a two-launch form (an all-pairs N x N/64 bitmask, 4.5 MB
// at 6000 and 36 MB at (2, 12000), then a one-warp scan that ORed each kept
// box's row in from L2: ~max_out dependent L2 round trips).
// What bounds it on an H100: the pair tests of one SM, |kept| x 64 per tile
// up to the tile where max_out is reached (~0.9 M pairs serving, ~3.7 M an
// image at the train counts, ~15 float32 operations each), plus a short
// shared-memory chain per tile. Bytes are negligible (N x 17 in, max_out x 5
// out). No quadratic pass, no scratch at main-path counts, and the critical
// path is one shared-memory walk per tile, not an L2 round trip per kept
// box. When max_out exceeds kKeptCap the kept boxes past it live in a
// (max_out - kKeptCap, 4) float32 scratch that the caller allocates, read
// back through L1 by the same block; the scan never gives up on a size.
// K3 keeps its <= 1024 boxes and the whole bitmask in shared memory, one
// block per problem, so its scan touches no device memory.
//
// The predicate is the division-free one of mask_rcnn_tpu/ops/nms.py:27-45
// and 107-109, inter > t * (area_i + area_j - inter) with
// area = max(h,0) * max(w,0), written with round-to-nearest intrinsics so
// that nvcc cannot contract it into FMAs: decisions are bit-identical to
// the float32 plain version. K2 computes each box's area once, with the
// same operations, so a precomputed area changes no decision.
// Rows with valid == 0 are never kept and so never suppress.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kNmsThreads = 1024;
// Kept boxes of K2 held in shared memory (80 KB with their areas); more
// spill to the caller's scratch, sized by mrcnn_nms_kept_cap().
constexpr int kKeptCap = 4096;

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

__device__ __forceinline__ bool suppresses(const float4 a, const float4 b,
                                           float thresh) {
  return suppresses_area(a, box_area(a), b, box_area(b), thresh);
}

// K2. grid B, kNmsThreads threads; dynamic shared memory (see
// nms_tiled_smem): kept[cap] float4, tile[2][64] float4, rows[64] uint64,
// kept_area[cap] float, tile_valid[2][64] uint8. spill (B, max_out - cap)
// float4 holds kept boxes cap.. when max_out > cap, else it is null.
__global__ void __launch_bounds__(kNmsThreads)
nms_tiled_kernel(const float4* __restrict__ boxes,
                 const uint8_t* __restrict__ valid, int N, float thresh,
                 int max_out, int cap, float4* spill,
                 int* __restrict__ out_pos, uint8_t* __restrict__ out_mask) {
  extern __shared__ float4 smem[];
  float4* kept = smem;
  float4* tile = kept + cap;
  uint64_t* rows = reinterpret_cast<uint64_t*>(tile + 2 * kTile);
  float* kept_area = reinterpret_cast<float*>(rows + kTile);
  uint8_t* tile_valid = reinterpret_cast<uint8_t*>(kept_area + cap);
  __shared__ uint64_t s_sup;
  __shared__ int s_count;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = kNmsThreads / 32;
  const float4* bx = boxes + (size_t)b * N;
  const uint8_t* v = valid + (size_t)b * N;
  float4* sp = spill ? spill + (size_t)b * (max_out - cap) : nullptr;
  int* pos = out_pos + (size_t)b * max_out;
  uint8_t* ok = out_mask + (size_t)b * max_out;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  if (tid < kTile) {
    tile[tid] = tid < N ? bx[tid] : zero;
    tile_valid[tid] = tid < N ? v[tid] : 0;
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
    const float4* cur = tile + (t & 1) * kTile;
    const uint8_t* cur_valid = tile_valid + (t & 1) * kTile;

    // The next tile, loaded now and staged after the tests.
    const int nxt = base + kTile + tid;
    float4 next_box = zero;
    uint8_t next_valid = 0;
    if (tid < kTile && nxt < N) {
      next_box = bx[nxt];
      next_valid = v[nxt];
    }

    // 1. Candidates lane and lane + 32 against this warp's kept boxes.
    const float4 c0 = cur[lane], c1 = cur[lane + 32];
    const float a0 = box_area(c0), a1 = box_area(c1);
    bool s0 = false, s1 = false;
    const int in_smem = count < cap ? count : cap;
    int k = warp;
    for (; k < in_smem; k += n_warps) {
      const float4 kb = kept[k];
      const float ka = kept_area[k];
      s0 |= suppresses_area(kb, ka, c0, a0, thresh);
      s1 |= suppresses_area(kb, ka, c1, a1, thresh);
    }
    for (; k < count; k += n_warps) {  // the spilled part of the kept set
      const float4 kb = sp[k - cap];
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
      if (lane == 0) rows[i] = row;
    }
    if (tid < kTile) {
      tile[((t + 1) & 1) * kTile + tid] = next_box;
      tile_valid[((t + 1) & 1) * kTile + tid] = next_valid;
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
          todo &= ~rows[i];
        }
        s_count = count + __popcll(keep);
      }
      keep = __shfl_sync(0xffffffffu, keep, 0);
      for (int j = lane; j < kTile; j += 32) {
        if (!((keep >> j) & 1ULL)) continue;
        const int r = count + __popcll(keep & ((1ULL << j) - 1));
        pos[r] = base + j;
        ok[r] = 1;
        const float4 box = cur[j];
        if (r < cap) {
          kept[r] = box;
          kept_area[r] = box_area(box);
        } else {
          sp[r - cap] = box;
        }
      }
    }
    __syncthreads();
  }

  for (int k = s_count + tid; k < max_out; k += kNmsThreads) {
    pos[k] = -1;
    ok[k] = 0;
  }
}

size_t nms_tiled_smem(int cap) {
  return (size_t)cap * (sizeof(float4) + sizeof(float)) +
         2 * kTile * sizeof(float4) + kTile * sizeof(uint64_t) +
         2 * kTile * sizeof(uint8_t);
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
  const size_t smem = nms_tiled_smem(cap);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        nms_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  nms_tiled_kernel<<<B, kNmsThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const uint8_t*)valid, N, thresh, max_out, cap,
      (float4*)spill, (int*)out_pos, (uint8_t*)out_mask);
  return (int)cudaGetLastError();
}

// Largest N whose boxes and bitmask fit K3's shared memory (144 KB at 1024);
// ops/nms.py::SMALL_MAX_N routes larger N to K2.
constexpr int kSmallMaxN = 1024;

// K3. Same buffers as K2 without the spill; N <= kSmallMaxN.
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
