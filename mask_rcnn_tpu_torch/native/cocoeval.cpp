// Native host-side evaluation kernels, a copy of
// mask_rcnn_tpu/native/cocoeval.cpp for the PyTorch port (host code, not a
// device kernel).
//
// The reference leans on pycocotools' C extension for exactly these loops
// (mask IoU + greedy matching); since pycocotools is not a dependency of
// this framework, the hot loops live here. Compiled on demand by
// mask_rcnn_tpu_torch/utils/native.py (g++ -O3 -shared, into the package's
// _build/ directory), bound via ctypes.
//
// All functions use a plain C ABI with caller-allocated outputs.

#include <cstdint>
#include <cstring>

extern "C" {

// Greedy COCO matching for one (image, category, area-range) cell.
//
// ious:        (D, G) row-major, dets sorted by descending score, gts sorted
//              ignored-last.
// gt_ignore:   (G,) 0/1 after area-range marking.
// gt_crowd:    (G,) 0/1 crowd flags — only crowd gts may be matched by more
//              than one det (pycocotools: `gtm>0 and not iscrowd -> continue`);
//              area-ignored non-crowd gts are single-match like regular gts.
// det_ignore:  (D,) 0/1 det-outside-area-range flags.
// thresholds:  (T,) IoU thresholds.
// dtm (T, D):  matched gt index or -1 (output).
// dt_ig (T, D): det-ignored flags (output).
void coco_match_image(const double* ious, const uint8_t* gt_ignore,
                      const uint8_t* gt_crowd,
                      const uint8_t* det_ignore, const double* thresholds,
                      int64_t d, int64_t g, int64_t t,
                      int64_t* dtm, uint8_t* dt_ig) {
  // gtm scratch per threshold
  for (int64_t ti = 0; ti < t; ++ti) {
    int64_t* dtm_row = dtm + ti * d;
    uint8_t* dt_ig_row = dt_ig + ti * d;
    // -1 init
    for (int64_t di = 0; di < d; ++di) dtm_row[di] = -1;
    // gt matched flags
    // (stack alloc would need VLA; use a small heap buffer)
    int64_t* gtm = new int64_t[g];
    for (int64_t gi = 0; gi < g; ++gi) gtm[gi] = -1;

    const double thr = thresholds[ti];
    for (int64_t di = 0; di < d; ++di) {
      double best = thr < (1.0 - 1e-10) ? thr : (1.0 - 1e-10);
      int64_t m = -1;
      const double* iou_row = ious + di * g;
      for (int64_t gi = 0; gi < g; ++gi) {
        if (gtm[gi] >= 0 && !gt_crowd[gi]) continue;
        // gts sorted ignored-last: stop once we have an unignored match and
        // the remaining gts are ignored
        if (m > -1 && !gt_ignore[m] && gt_ignore[gi]) break;
        if (iou_row[gi] < best) continue;
        best = iou_row[gi];
        m = gi;
      }
      if (m == -1) continue;
      dtm_row[di] = m;
      dt_ig_row[di] = gt_ignore[m];
      gtm[m] = di;
    }
    for (int64_t di = 0; di < d; ++di) {
      if (dtm_row[di] < 0 && det_ignore[di]) dt_ig_row[di] = 1;
    }
    delete[] gtm;
  }
}

// Pairwise mask IoU from bit-packed masks.
//
// det_bits: (D, NW) uint64 words; gt_bits: (G, NW); crowd: (G,) 0/1.
// out: (D, G) doubles. Crowd gts use union = det area (COCO semantics).
void mask_iou_packed(const uint64_t* det_bits, const uint64_t* gt_bits,
                     const uint8_t* crowd, int64_t d, int64_t g, int64_t nw,
                     double* out) {
  int64_t* det_area = new int64_t[d];
  for (int64_t i = 0; i < d; ++i) {
    int64_t a = 0;
    const uint64_t* row = det_bits + i * nw;
    for (int64_t k = 0; k < nw; ++k) a += __builtin_popcountll(row[k]);
    det_area[i] = a;
  }
  for (int64_t j = 0; j < g; ++j) {
    const uint64_t* grow = gt_bits + j * nw;
    int64_t ga = 0;
    for (int64_t k = 0; k < nw; ++k) ga += __builtin_popcountll(grow[k]);
    for (int64_t i = 0; i < d; ++i) {
      const uint64_t* drow = det_bits + i * nw;
      int64_t inter = 0;
      for (int64_t k = 0; k < nw; ++k)
        inter += __builtin_popcountll(drow[k] & grow[k]);
      double uni = crowd[j] ? (double)det_area[i]
                            : (double)(det_area[i] + ga - inter);
      out[i * g + j] = uni > 0 ? (double)inter / uni : 0.0;
    }
  }
  delete[] det_area;
}

// Box-local detection/gt intersections + detection areas.
//
// The evaluator scores detections from their box-local binarized masks
// (utils/masks.py::boxlocal_masks): a predicted mask is zero outside its
// expanded clipped box, so IoU needs only the gt pixels under that box.
// This kernel is the hot loop of add_boxlocal — intersections and areas
// over ~100 dets x gts per image were a Python-level loop of numpy slices.
//
// det_locals: concatenated row-major 0/1 uint8 local masks (det i occupies
//             [offsets[i], offsets[i+1]) = h_i * w_i bytes).
// det_meta:   (D, 4) int64 rows [y0, x0, h, w] (already clipped to image).
// gt_masks:   (G, H, W) row-major 0/1 uint8.
// det_labels / gt_labels: (D,) / (G,) int64; intersections are computed
//             only for label-equal pairs (others left 0 — the evaluator
//             never reads cross-class pairs).
// out_inter:  (D, G) int64 (fully written).
// out_area:   (D,) int64 (local mask pixel counts).
// out_gt_area: (G,) int64 (full gt mask pixel counts — numpy's bool-axis
//             reduction runs ~6x slower than this byte-sum loop).
void boxlocal_inter(const uint8_t* det_locals, const int64_t* offsets,
                    const int64_t* det_meta, int64_t d,
                    const uint8_t* gt_masks, int64_t g, int64_t hh,
                    int64_t ww, const int64_t* det_labels,
                    const int64_t* gt_labels, int64_t* out_inter,
                    int64_t* out_area, int64_t* out_gt_area) {
  for (int64_t gi = 0; gi < g; ++gi) {
    const uint8_t* gbase = gt_masks + gi * hh * ww;
    int64_t a = 0;
    for (int64_t k = 0; k < hh * ww; ++k) a += gbase[k];
    out_gt_area[gi] = a;
  }
  for (int64_t di = 0; di < d; ++di) {
    const uint8_t* local = det_locals + offsets[di];
    const int64_t y0 = det_meta[di * 4 + 0];
    const int64_t x0 = det_meta[di * 4 + 1];
    const int64_t h = det_meta[di * 4 + 2];
    const int64_t w = det_meta[di * 4 + 3];
    int64_t area = 0;
    for (int64_t k = 0; k < h * w; ++k) area += local[k];
    out_area[di] = area;
    int64_t* inter_row = out_inter + di * g;
    for (int64_t gi = 0; gi < g; ++gi) {
      inter_row[gi] = 0;
      if (gt_labels[gi] != det_labels[di] || area == 0) continue;
      const uint8_t* gbase = gt_masks + gi * hh * ww;
      int64_t inter = 0;
      for (int64_t y = 0; y < h; ++y) {
        const uint8_t* lrow = local + y * w;
        const uint8_t* grow = gbase + (y0 + y) * ww + x0;
        int64_t acc = 0;
        for (int64_t x = 0; x < w; ++x) acc += lrow[x] & grow[x];
        inter += acc;
      }
      inter_row[gi] = inter;
    }
  }
}

// Column-major RLE encoding of a binary mask: returns number of runs
// written into counts (alternating 0/1 runs starting with zeros).
// mask: (H, W) row-major uint8; counts capacity must be >= H*W + 1.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                   uint32_t* counts) {
  int64_t n = 0;
  uint8_t cur = 0;
  uint32_t run = 0;
  for (int64_t x = 0; x < w; ++x) {
    for (int64_t y = 0; y < h; ++y) {
      uint8_t v = mask[y * w + x] ? 1 : 0;
      if (v == cur) {
        ++run;
      } else {
        counts[n++] = run;
        cur = v;
        run = 1;
      }
    }
  }
  counts[n++] = run;
  return n;
}

}  // extern "C"
