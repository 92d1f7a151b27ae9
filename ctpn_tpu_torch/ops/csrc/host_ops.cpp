// Host-side geometry for ctpn_tpu_torch (``native.py``): greedy NMS, dense
// IoU and intersection fractions, and the text-proposal graph's successor
// edges.
//
// The port's own copy of the JAX package's native/host_ops.cpp, with the
// same ctypes ABI. The card path never calls these: they serve host-side
// tooling and parity checks against the numpy oracles
// (utils/host_ref.py, postprocess/oracle.py).
//
// Contracts:
//  * +1 pixel areas everywhere;
//  * NMS suppresses at IoU >= thresh, candidates ordered by the caller;
//  * graph builder: nearest-column successor within max_gap, vertical IoU
//    and size-similarity thresholds, mutual-best-by-score edge rule.
//
// Built at first use by ops/_build.py with -ffp-contract=off (no FMA
// contraction: the IoU must round as the oracles' separate operations do).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Greedy NMS over dets = n rows of [x1, y1, x2, y2, score].
// Caller passes rows in evaluation order (score-descending for the
// reference semantics). keep_out must hold n ints; returns kept count.
int ctpn_nms(const float* dets, int n, float thresh, int* keep_out) {
  std::vector<float> areas(n);
  std::vector<uint8_t> suppressed(n, 0);
  for (int i = 0; i < n; ++i) {
    const float* b = dets + 5 * i;
    areas[i] = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
  }
  int kept = 0;
  for (int i = 0; i < n; ++i) {
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    const float* bi = dets + 5 * i;
    for (int j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      const float* bj = dets + 5 * j;
      float xx1 = std::max(bi[0], bj[0]);
      float yy1 = std::max(bi[1], bj[1]);
      float xx2 = std::min(bi[2], bj[2]);
      float yy2 = std::min(bi[3], bj[3]);
      float w = std::max(0.0f, xx2 - xx1 + 1.0f);
      float h = std::max(0.0f, yy2 - yy1 + 1.0f);
      float inter = w * h;
      float ovr = inter / (areas[i] + areas[j] - inter);
      if (ovr >= thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

// Dense pairwise IoU: boxes (n x 4) vs query (k x 4) -> out (n x k).
void ctpn_bbox_overlaps(const float* boxes, int n, const float* query, int k,
                        float* out) {
  for (int q = 0; q < k; ++q) {
    const float* qb = query + 4 * q;
    float qarea = (qb[2] - qb[0] + 1.0f) * (qb[3] - qb[1] + 1.0f);
    for (int i = 0; i < n; ++i) {
      const float* b = boxes + 4 * i;
      float iw = std::min(b[2], qb[2]) - std::max(b[0], qb[0]) + 1.0f;
      float v = 0.0f;
      if (iw > 0) {
        float ih = std::min(b[3], qb[3]) - std::max(b[1], qb[1]) + 1.0f;
        if (ih > 0) {
          float area = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
          v = iw * ih / (area + qarea - iw * ih);
        }
      }
      out[i * k + q] = v;
    }
  }
}

// Intersection fraction over query area: boxes (n x 4) vs query (k x 4).
void ctpn_bbox_intersections(const float* boxes, int n, const float* query,
                             int k, float* out) {
  for (int q = 0; q < k; ++q) {
    const float* qb = query + 4 * q;
    float qarea = (qb[2] - qb[0] + 1.0f) * (qb[3] - qb[1] + 1.0f);
    for (int i = 0; i < n; ++i) {
      const float* b = boxes + 4 * i;
      float iw = std::min(b[2], qb[2]) - std::max(b[0], qb[0]) + 1.0f;
      float ih = std::min(b[3], qb[3]) - std::max(b[1], qb[1]) + 1.0f;
      float v = 0.0f;
      if (iw > 0 && ih > 0) v = iw * ih / qarea;
      out[i * k + q] = v;
    }
  }
}

namespace {

struct GraphCtx {
  const float* boxes;
  const float* scores;
  int n;
  int im_w;
  int max_gap;
  float min_v;
  float min_sim;
  std::vector<std::vector<int>> table;  // per-column box indices
  std::vector<float> heights;

  bool meet(int i, int j) const {
    float h1 = heights[i], h2 = heights[j];
    float y0 = std::max(boxes[4 * i + 1], boxes[4 * j + 1]);
    float y1 = std::min(boxes[4 * i + 3], boxes[4 * j + 3]);
    float ov = std::max(0.0f, y1 - y0 + 1.0f) / std::min(h1, h2);
    float sim = std::min(h1, h2) / std::max(h1, h2);
    return ov >= min_v && sim >= min_sim;
  }
};

}  // namespace

// Successor edges of the proposal graph. boxes: n x 4 (caller pre-filters
// to valid proposals), scores: n. succ_out[i] = j of the kept edge i->j, or
// -1. Mirrors build_graph() of the reference, O(n * max_gap).
void ctpn_build_graph(const float* boxes, const float* scores, int n,
                      int im_w, int max_gap, float min_v, float min_sim,
                      int* succ_out) {
  GraphCtx ctx{boxes, scores, n, im_w, max_gap, min_v, min_sim, {}, {}};
  ctx.table.assign(std::max(im_w, 1), {});
  ctx.heights.resize(n);
  for (int i = 0; i < n; ++i) {
    ctx.heights[i] = boxes[4 * i + 3] - boxes[4 * i + 1] + 1.0f;
    int col = static_cast<int>(boxes[4 * i]);
    if (col >= 0 && col < im_w) ctx.table[col].push_back(i);
  }

  auto successions = [&](int i, std::vector<int>& out) {
    out.clear();
    int c0 = static_cast<int>(boxes[4 * i]);
    int hi = std::min(c0 + max_gap + 1, im_w);
    for (int col = c0 + 1; col < hi; ++col) {
      for (int j : ctx.table[col])
        if (ctx.meet(j, i)) out.push_back(j);
      if (!out.empty()) return;
    }
  };
  auto precursors = [&](int j, std::vector<int>& out) {
    out.clear();
    int c0 = static_cast<int>(boxes[4 * j]);
    int lo = std::max(c0 - max_gap, 0) - 1;
    for (int col = c0 - 1; col > lo; --col) {
      for (int i : ctx.table[col])
        if (ctx.meet(i, j)) out.push_back(i);
      if (!out.empty()) return;
    }
  };

  std::vector<int> succs, precs;
  for (int i = 0; i < n; ++i) {
    succ_out[i] = -1;
    successions(i, succs);
    if (succs.empty()) continue;
    int best = succs[0];
    for (int j : succs)
      if (scores[j] > scores[best]) best = j;
    precursors(best, precs);
    float pmax = -1e30f;
    for (int p : precs) pmax = std::max(pmax, scores[p]);
    if (scores[i] >= pmax) succ_out[i] = best;
  }
}

}  // extern "C"
