// Signal-to-sequence resquiggle alignment: coarse-to-fine banded DTW.
//
// Native equivalent of the reference's vendored cwDTW_nano binary
// (continuous-wavelet DTW signal<->sequence aligner, invoked at
// chiron/chiron_label.py:265-270; no source in the reference repo).
// Re-designed rather than reimplemented: the multi-scale seeding that cwDTW
// gets from a continuous wavelet transform is provided here by an
// average-pooling pyramid (FastDTW-style): full DTW at the coarsest level,
// then the warping path is projected down one level at a time and refined
// inside a +/-radius band. Linear time and memory in the signal length.
//
// Exposed as a C ABI for ctypes (chiron_tpu_torch/tools/resquiggle.py; built by
// chiron_tpu_torch/ops/host_build.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct Band {
  // per-row [lo, hi) column bounds of the search band
  std::vector<int> lo, hi;
};

inline double sq(double x) { return x * x; }

// Full O(n*m) DTW inside a band. Returns the warping path as (i, j) pairs
// in increasing order, plus the alignment cost.
double banded_dtw(const float* a, int n, const float* b, int m,
                  const Band& band, std::vector<std::pair<int, int>>* path) {
  // cost[i][j] stored sparsely per row inside the band
  std::vector<std::vector<double>> cost(n);
  std::vector<std::vector<int8_t>> move(n);  // 0=diag,1=up(i-1),2=left(j-1)
  for (int i = 0; i < n; ++i) {
    int lo = band.lo[i], hi = band.hi[i];
    cost[i].assign(hi - lo, kInf);
    move[i].assign(hi - lo, 0);
    for (int j = lo; j < hi; ++j) {
      double d = sq(a[i] - b[j]);
      double best = kInf;
      int8_t mv = 0;
      if (i == 0 && j == 0) {
        best = 0.0;
      } else {
        // diag
        if (i > 0 && j > 0 && j - 1 >= band.lo[i - 1] && j - 1 < band.hi[i - 1]) {
          double c = cost[i - 1][j - 1 - band.lo[i - 1]];
          if (c < best) { best = c; mv = 0; }
        }
        // up: same sequence position consumes another signal sample
        if (i > 0 && j >= band.lo[i - 1] && j < band.hi[i - 1]) {
          double c = cost[i - 1][j - band.lo[i - 1]];
          if (c < best) { best = c; mv = 1; }
        }
        // left: sequence position skipped within one signal sample
        if (j - 1 >= lo) {
          double c = cost[i][j - 1 - lo];
          if (c < best) { best = c; mv = 2; }
        }
      }
      if (best < kInf) {
        cost[i][j - lo] = best + d;
        move[i][j - lo] = mv;
      }
    }
  }
  // traceback from (n-1, m-1)
  int i = n - 1, j = m - 1;
  if (j < band.lo[i] || j >= band.hi[i] || cost[i][j - band.lo[i]] == kInf) {
    return -1.0;
  }
  double total = cost[i][j - band.lo[i]];
  path->clear();
  while (true) {
    path->push_back({i, j});
    if (i == 0 && j == 0) break;
    int8_t mv = move[i][j - band.lo[i]];
    if (mv == 0) { --i; --j; }
    else if (mv == 1) { --i; }
    else { --j; }
    if (i < 0 || j < 0) break;
  }
  std::reverse(path->begin(), path->end());
  return total;
}

Band full_band(int n, int m) {
  Band b;
  b.lo.assign(n, 0);
  b.hi.assign(n, m);
  return b;
}

// Project a coarse path (on half-resolution sequences) to fine resolution
// and expand by `radius` in the column direction.
Band project_band(const std::vector<std::pair<int, int>>& coarse_path,
                  int n, int m, int radius) {
  Band b;
  b.lo.assign(n, m);
  b.hi.assign(n, 0);
  auto widen = [&](int i, int jlo, int jhi) {
    if (i < 0 || i >= n) return;
    b.lo[i] = std::min(b.lo[i], std::max(0, jlo));
    b.hi[i] = std::max(b.hi[i], std::min(m, jhi));
  };
  for (auto& p : coarse_path) {
    int ci = p.first, cj = p.second;
    for (int di = 0; di < 2; ++di) {
      int i = 2 * ci + di;
      widen(i, 2 * cj - radius, 2 * cj + radius + 2);
    }
  }
  // fill any uncovered rows from neighbours and enforce monotonic bounds
  int last_lo = 0, last_hi = 1;
  for (int i = 0; i < n; ++i) {
    if (b.lo[i] > b.hi[i]) { b.lo[i] = last_lo; b.hi[i] = last_hi; }
    b.lo[i] = std::min(b.lo[i], last_hi);  // keep rows connected
    last_lo = b.lo[i];
    last_hi = b.hi[i];
  }
  b.hi[n - 1] = m;  // terminal cell must be reachable
  b.lo[n - 1] = std::min(b.lo[n - 1], m - 1);
  return b;
}

std::vector<float> halve(const float* x, int n) {
  int h = n / 2;
  std::vector<float> out(h);
  for (int i = 0; i < h; ++i) out[i] = 0.5f * (x[2 * i] + x[2 * i + 1]);
  return out;
}

double fast_dtw(const float* a, int n, const float* b, int m, int radius,
                int min_size, std::vector<std::pair<int, int>>* path) {
  if (n <= min_size || m <= min_size) {
    Band band = full_band(n, m);
    return banded_dtw(a, n, b, m, band, path);
  }
  std::vector<float> a2 = halve(a, n);
  std::vector<float> b2 = halve(b, m);
  std::vector<std::pair<int, int>> coarse;
  double c = fast_dtw(a2.data(), (int)a2.size(), b2.data(), (int)b2.size(),
                      radius, min_size, &coarse);
  if (c < 0) {
    Band band = full_band(n, m);
    return banded_dtw(a, n, b, m, band, path);
  }
  Band band = project_band(coarse, n, m, radius);
  double r = banded_dtw(a, n, b, m, band, path);
  if (r < 0) {
    Band band2 = full_band(n, m);
    return banded_dtw(a, n, b, m, band2, path);
  }
  return r;
}

}  // namespace

extern "C" {

// Align signal (length n) to an expected per-base level sequence (length m).
// Writes starts[m+1]: starts[k] = first signal index assigned to base k;
// starts[m] = n. Returns alignment cost (>= 0) or -1 on failure.
double chiron_resquiggle(const float* signal, int n, const float* expected,
                         int m, int radius, int32_t* starts) {
  if (n <= 0 || m <= 0 || radius < 1) return -1.0;
  std::vector<std::pair<int, int>> path;
  // signal on rows (i), sequence on columns (j)
  double cost = fast_dtw(signal, n, expected, m, radius, 64, &path);
  if (cost < 0 || path.empty()) return -1.0;
  for (int k = 0; k <= m; ++k) starts[k] = -1;
  for (auto& p : path) {
    if (starts[p.second] < 0) starts[p.second] = p.first;
  }
  starts[m] = n;
  // fill skipped bases (left-moves may skip assigning a first sample)
  for (int k = m - 1; k >= 0; --k) {
    if (starts[k] < 0) starts[k] = starts[k + 1];
  }
  starts[0] = 0;
  return cost;
}

// Plain banded DTW on two z-normalised series (utility; band = Sakoe-Chiba).
double chiron_dtw_distance(const float* a, int n, const float* b, int m,
                           int radius) {
  if (n <= 0 || m <= 0) return -1.0;
  std::vector<std::pair<int, int>> path;
  return fast_dtw(a, n, b, m, radius, 64, &path);
}

}  // extern "C"
