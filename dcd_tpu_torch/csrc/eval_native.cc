// Native fused KITTI AP matching.
//
// C++ counterpart of the reference's numba-JIT'd matching loops
// (GMW/evaluation/kitti_object_eval_python/eval.py: compute_statistics_jit
// :156-273 and fused_compute_statistics :276-335): one call per image runs
// the greedy TP/FP match for ALL score thresholds, so the Python layer no
// longer pays (images x thresholds) interpreter passes. Semantics match
// the Python protocol loop, dcd_tpu_torch/evaluation/kitti_eval.py::
// compute_statistics, exactly (tests cross-check the two paths). Host code,
// built with g++ by dcd_tpu_torch/evaluation/native.py; a copy of the JAX
// package's dcd_tpu/native/eval_native.cc.

#include <cstdint>
#include <cmath>
#include <vector>

namespace {

constexpr double kNoDetection = -10000000.0;

// One greedy matching pass (the body of compute_statistics with
// compute_fp=true), accumulating into pr[4] = {tp, fp, fn, similarity}.
void match_one_threshold(const double* overlaps,  // det x gt, row-major
                         int det_size, int gt_size,
                         const double* dt_scores, const double* dt_alphas,
                         const double* gt_alphas,
                         const double* dt_dc_overlap,  // det x dc, row-major
                         int dc_size,
                         const int64_t* ignored_gt, const int64_t* ignored_det,
                         int metric, double min_overlap, double thresh,
                         bool compute_aos, double* pr) {
  std::vector<char> assigned(det_size, 0);
  std::vector<char> ignored_threshold(det_size, 0);
  for (int j = 0; j < det_size; ++j) {
    if (dt_scores[j] < thresh) ignored_threshold[j] = 1;
  }
  double tp = 0, fp = 0, fn = 0;
  std::vector<double> delta;
  delta.reserve(gt_size);

  for (int i = 0; i < gt_size; ++i) {
    if (ignored_gt[i] == -1) continue;
    int det_idx = -1;
    double valid_detection = kNoDetection;
    double max_overlap = 0;
    bool assigned_ignored_det = false;

    for (int j = 0; j < det_size; ++j) {
      if (ignored_det[j] == -1) continue;
      if (assigned[j]) continue;
      if (ignored_threshold[j]) continue;
      const double overlap = overlaps[j * gt_size + i];
      if (overlap > min_overlap &&
          (overlap > max_overlap || assigned_ignored_det) &&
          ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = false;
      } else if (overlap > min_overlap && valid_detection == kNoDetection &&
                 ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1;
        assigned_ignored_det = true;
      }
    }

    if (valid_detection == kNoDetection && ignored_gt[i] == 0) {
      fn += 1;
    } else if (valid_detection != kNoDetection &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_detection != kNoDetection) {
      tp += 1;
      if (compute_aos) delta.push_back(gt_alphas[i] - dt_alphas[det_idx]);
      assigned[det_idx] = 1;
    }
  }

  for (int j = 0; j < det_size; ++j) {
    if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1 ||
          ignored_threshold[j])) {
      fp += 1;
    }
  }
  // DontCare absorption (metric 0 / bbox only)
  double nstuff = 0;
  if (metric == 0 && dc_size > 0) {
    for (int i = 0; i < dc_size; ++i) {
      for (int j = 0; j < det_size; ++j) {
        if (assigned[j]) continue;
        if (ignored_det[j] == -1 || ignored_det[j] == 1) continue;
        if (ignored_threshold[j]) continue;
        if (dt_dc_overlap[j * dc_size + i] > min_overlap) {
          assigned[j] = 1;
          nstuff += 1;
        }
      }
    }
  }
  fp -= nstuff;

  pr[0] += tp;
  pr[1] += fp;
  pr[2] += fn;
  if (compute_aos) {
    double similarity = 0;
    for (double d : delta) similarity += (1.0 + std::cos(d)) / 2.0;
    // reference: similarity = -1 when tp+fp == 0; callers skip -1
    if (tp > 0 || fp > 0) {
      pr[3] += similarity;
    }
  }
}

}  // namespace

extern "C" {

// Phase 1 of eval_class: collect the scores of matched TPs at thresh=0
// (compute_statistics with compute_fp=false). Writes up to gt_size scores
// into out_scores; returns the count.
int kitti_match_scores(const double* overlaps, int det_size, int gt_size,
                       const double* dt_scores, const int64_t* ignored_gt,
                       const int64_t* ignored_det, double min_overlap,
                       double* out_scores) {
  std::vector<char> assigned(det_size, 0);
  int n = 0;
  for (int i = 0; i < gt_size; ++i) {
    if (ignored_gt[i] == -1) continue;
    int det_idx = -1;
    double valid_detection = kNoDetection;
    for (int j = 0; j < det_size; ++j) {
      if (ignored_det[j] == -1) continue;
      if (assigned[j]) continue;
      const double overlap = overlaps[j * gt_size + i];
      if (overlap > min_overlap && dt_scores[j] > valid_detection) {
        det_idx = j;
        valid_detection = dt_scores[j];
      }
    }
    if (valid_detection == kNoDetection && ignored_gt[i] == 0) {
      // fn — nothing to record
    } else if (valid_detection != kNoDetection &&
               (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = 1;
    } else if (valid_detection != kNoDetection) {
      out_scores[n++] = dt_scores[det_idx];
      assigned[det_idx] = 1;
    }
  }
  return n;
}

// Phase 2: fused greedy matching over all T thresholds for one image.
// pr is a T x 4 row-major array accumulated in place ({tp, fp, fn, sim}).
void kitti_fused_statistics(const double* overlaps, int det_size, int gt_size,
                            const double* dt_scores, const double* dt_alphas,
                            const double* gt_alphas,
                            const double* dt_dc_overlap, int dc_size,
                            const int64_t* ignored_gt,
                            const int64_t* ignored_det, int metric,
                            double min_overlap, const double* thresholds,
                            int num_thresholds, int compute_aos, double* pr) {
  for (int t = 0; t < num_thresholds; ++t) {
    match_one_threshold(overlaps, det_size, gt_size, dt_scores, dt_alphas,
                        gt_alphas, dt_dc_overlap, dc_size, ignored_gt,
                        ignored_det, metric, min_overlap, thresholds[t],
                        compute_aos != 0, pr + t * 4);
  }
}

}  // extern "C"
