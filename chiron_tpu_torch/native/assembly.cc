// Overlap-consensus assembly (glue/stick kernels) for very long reads.
//
// Native equivalent of the Python loop in chiron_tpu_torch/assembly/consensus.py
// (itself a re-design of chiron/utils/easy_assembler.py:276-300,393-442):
// the per-window glue displacement search is O(k^2) in the overlap bound
// and the count accumulation is O(len) per window — fine in numpy for
// example-sized reads, but a megabase read with thousands of windows
// deserves a single native pass. Semantics are identical to the Python
// kernels (scoring 2*matches - overlap, displacement = prev_len - best).
//
// Exposed as a C ABI for ctypes (chiron_tpu_torch/assembly/consensus.py; built by
// chiron_tpu_torch/ops/host_build.py).

#include <algorithm>
#include <array>
#include <cstdint>
#include <vector>

namespace {

inline int base_index(char c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return -1;
  }
}

// Best suffix(prev)/prefix(cur) overlap length (glue kernel).
long long glue_overlap(const char* prev, long long prev_n,
                       const char* cur, long long cur_n) {
  long long max_overlap = std::min(prev_n / 10, cur_n);
  long long best_i = 0, best_score = 0;
  for (long long i = 1; i < max_overlap; ++i) {
    long long matches = 0;
    const char* tail = prev + prev_n - i;
    for (long long j = 0; j < i; ++j) matches += (cur[j] == tail[j]);
    long long score = 2 * matches - i;
    if (score > best_score) {
      best_score = score;
      best_i = i;
    }
  }
  return best_i;
}

}  // namespace

extern "C" {

// Assemble n_windows base strings (concatenated in `bases`, window w spans
// bases[offsets[w] .. offsets[w+1])) into [4, cap] consensus count and
// quality matrices (row-major doubles, caller-zeroed). `stick` selects the
// stick kernel (displacement = len(prev)) instead of glue. Returns the
// consensus length, or -needed_capacity if cap is too small.
long long chiron_assemble_glue(const char* bases, const long long* offsets,
                               long long n_windows, const float* qs,
                               int stick, double* consensus,
                               double* consensus_qs, long long cap) {
  long long pos = 0, length = 0;
  for (long long w = 0; w < n_windows; ++w) {
    const char* cur = bases + offsets[w];
    const long long cur_n = offsets[w + 1] - offsets[w];
    long long start;
    if (w == 0) {
      start = 0;
    } else {
      const char* prev = bases + offsets[w - 1];
      const long long prev_n = offsets[w] - offsets[w - 1];
      const long long disp =
          stick ? prev_n : prev_n - glue_overlap(prev, prev_n, cur, cur_n);
      pos += disp;
      start = pos > 0 ? pos : 0;
    }
    const long long end = start + cur_n;
    if (end > cap) return -(end + 1);
    const double q = qs ? static_cast<double>(qs[w]) : 0.0;
    for (long long j = 0; j < cur_n; ++j) {
      const int b = base_index(cur[j]);
      if (b < 0) continue;
      consensus[b * cap + start + j] += 1.0;
      if (consensus_qs) consensus_qs[b * cap + start + j] += q;
    }
    length = std::max(length, end);
  }
  return length;
}

// Displacement from the longest gap-free block of an affine-gap global
// alignment of prev (a) vs cur (b) — the `global` assembly kernel. The DP
// mirrors consensus.py:_nw_align cell for cell (same scores, same
// first-max tie order M,X,Y; all values are small integers so int64 here
// equals the Python float64 arithmetic exactly). Returns pos_a - pos_b of
// the longest block's end (first-max tie on length), or INT64_MIN when the
// alignment has no gap-free block.
long long chiron_global_disp(const char* a, long long n, const char* b,
                             long long m) {
  const long long neg = -1000000000LL;  // matches the Python -1e9 sentinel
  const long long match = 1, mismatch = -3, gap_open = -5, gap_extend = -2;
  const long long w = m + 1;
  std::vector<long long> M(static_cast<size_t>((n + 1) * w), neg);
  std::vector<long long> X(static_cast<size_t>((n + 1) * w), neg);
  std::vector<long long> Y(static_cast<size_t>((n + 1) * w), neg);
  std::vector<int8_t> pM(static_cast<size_t>((n + 1) * w), 0);
  std::vector<int8_t> pX(static_cast<size_t>((n + 1) * w), 0);
  std::vector<int8_t> pY(static_cast<size_t>((n + 1) * w), 0);
  M[0] = 0;
  for (long long j = 1; j <= m; ++j) Y[j] = gap_open + gap_extend * (j - 1);
  for (long long i = 1; i <= n; ++i) {
    const long long* Mp = M.data() + (i - 1) * w;
    const long long* Xp = X.data() + (i - 1) * w;
    const long long* Yp = Y.data() + (i - 1) * w;
    long long* Mi = M.data() + i * w;
    long long* Xi = X.data() + i * w;
    long long* Yi = Y.data() + i * w;
    int8_t* pMi = pM.data() + i * w;
    int8_t* pXi = pX.data() + i * w;
    int8_t* pYi = pY.data() + i * w;
    for (long long j = 0; j <= m; ++j) {
      const long long openx = Mp[j] + gap_open + gap_extend;
      const long long extx = Xp[j] + gap_extend;
      Xi[j] = extx > openx ? extx : openx;
      pXi[j] = extx > openx;
    }
    for (long long j = 1; j <= m; ++j) {
      const long long yopen = Mi[j - 1] + gap_open + gap_extend;
      const long long yext = Yi[j - 1] + gap_extend;
      if (yext > yopen) {
        Yi[j] = yext;
        pYi[j] = 2;
      } else {
        Yi[j] = yopen;
      }
      const long long c0 = Mp[j - 1], c1 = Xp[j - 1], c2 = Yp[j - 1];
      int k = 0;
      long long best = c0;
      if (c1 > best) { best = c1; k = 1; }
      if (c2 > best) { best = c2; k = 2; }
      const long long sub = a[i - 1] == b[j - 1] ? match : mismatch;
      Mi[j] = best + sub;
      pMi[j] = static_cast<int8_t>(k);
    }
  }
  // traceback -> column moves (0 = both, 1 = a only, 2 = b only), reversed
  const size_t end = static_cast<size_t>(n * w + m);
  int state = 0;
  {
    long long best = M[end];
    if (X[end] > best) { best = X[end]; state = 1; }
    if (Y[end] > best) { state = 2; }
  }
  std::vector<int8_t> moves;
  moves.reserve(static_cast<size_t>(n + m));
  long long i = n, j = m;
  while (i > 0 || j > 0) {
    const size_t c = static_cast<size_t>(i * w + j);
    if (state == 0 && i > 0 && j > 0) {
      moves.push_back(0);
      state = pM[c];
      --i;
      --j;
    } else if (state == 1 && i > 0) {
      moves.push_back(1);
      state = pX[c] == 0 ? 0 : 1;
      --i;
    } else if (j > 0) {
      moves.push_back(2);
      state = pY[c] == 0 ? 0 : 2;
      --j;
    } else {
      break;
    }
  }
  // scan forward (reverse order) for gap-free runs; keep the longest
  // (first-max), recording a/b end positions — consensus.py:_match_blocks
  long long pos_a = 0, pos_b = 0, run = 0;
  long long best_len = -1, best_disp = 0;
  for (size_t t = moves.size(); t-- > 0;) {
    const int mv = moves[t];
    if (mv == 0) {
      ++run;
    } else if (run > 0) {
      if (run > best_len) {
        best_len = run;
        best_disp = pos_a - pos_b;
      }
      run = 0;
    }
    if (mv != 2) ++pos_a;
    if (mv != 1) ++pos_b;
  }
  // a block reaching the alignment's end is recorded one short: parity with
  // consensus.py:_match_blocks, whose final append uses the last loop index
  // (idx - tmp_start) rather than the run length
  if (run > 0 && run - 1 > best_len) {
    best_len = run - 1;
    best_disp = pos_a - pos_b;
  }
  if (best_len < 0) return INT64_MIN;
  return best_disp;
}

// difflib.SequenceMatcher-equivalent matching blocks for the `simple`
// assembly kernel (no-junk regime; the Python caller keeps difflib for
// len(b) >= 200 where autojunk changes semantics). Writes (i, j, size)
// triples including the (n, m, 0) sentinel into out (capacity cap triples);
// returns the triple count, or -1 if cap is too small.
long long chiron_simple_blocks(const char* a, long long n, const char* b,
                               long long m, long long* out, long long cap) {
  struct Span {
    long long alo, ahi, blo, bhi;
  };
  std::vector<long long> prev(static_cast<size_t>(m), 0);
  std::vector<long long> cur(static_cast<size_t>(m), 0);
  std::vector<std::array<long long, 3>> blocks;
  std::vector<Span> queue;
  queue.push_back({0, n, 0, m});
  while (!queue.empty()) {
    const Span s = queue.back();
    queue.pop_back();
    // longest match in a[alo:ahi] x b[blo:bhi]: row DP over match-run
    // lengths ending at (i, j); strict > keeps the earliest-ending (and
    // therefore earliest-starting, then earliest-j) maximal block —
    // difflib.find_longest_match's documented tie-breaking
    long long besti = s.alo, bestj = s.blo, bestsize = 0;
    std::fill(prev.begin(), prev.end(), 0);
    for (long long i = s.alo; i < s.ahi; ++i) {
      const char ai = a[i];
      for (long long j = s.blo; j < s.bhi; ++j) {
        if (b[j] == ai) {
          const long long len =
              (j > s.blo ? prev[static_cast<size_t>(j - 1)] : 0) + 1;
          cur[static_cast<size_t>(j)] = len;
          if (len > bestsize) {
            bestsize = len;
            besti = i - len + 1;
            bestj = j - len + 1;
          }
        } else {
          cur[static_cast<size_t>(j)] = 0;
        }
      }
      std::swap(prev, cur);
      std::fill(cur.begin() + s.blo, cur.begin() + s.bhi, 0);
    }
    if (bestsize > 0) {
      blocks.push_back({besti, bestj, bestsize});
      if (s.alo < besti && s.blo < bestj)
        queue.push_back({s.alo, besti, s.blo, bestj});
      if (besti + bestsize < s.ahi && bestj + bestsize < s.bhi)
        queue.push_back({besti + bestsize, s.ahi, bestj + bestsize, s.bhi});
    }
    std::fill(prev.begin() + s.blo, prev.begin() + s.bhi, 0);
  }
  std::sort(blocks.begin(), blocks.end());
  // merge adjacent blocks, append the terminal sentinel
  long long count = 0;
  long long i1 = 0, j1 = 0, k1 = 0;
  for (const auto& bl : blocks) {
    if (i1 + k1 == bl[0] && j1 + k1 == bl[1]) {
      k1 += bl[2];
    } else {
      if (k1) {
        if (count + 1 > cap) return -1;
        out[3 * count] = i1;
        out[3 * count + 1] = j1;
        out[3 * count + 2] = k1;
        ++count;
      }
      i1 = bl[0];
      j1 = bl[1];
      k1 = bl[2];
    }
  }
  if (k1) {
    if (count + 1 > cap) return -1;
    out[3 * count] = i1;
    out[3 * count + 1] = j1;
    out[3 * count + 2] = k1;
    ++count;
  }
  if (count + 1 > cap) return -1;
  out[3 * count] = n;
  out[3 * count + 1] = m;
  out[3 * count + 2] = 0;
  return count + 1;
}

}  // extern "C"
