// Fast whitespace-separated numeric text parser for .signal/.label files.
//
// The reference reads .signal files by splitting text in Python
// (chiron/chiron_input.py:527-539); at ~170ns/token that costs ~50ms for a
// 280k-sample read and lands on the basecall critical path. This parser
// runs the common integer case at memory speed (single pass, no
// allocation) and falls back to strtof for float tokens.
//
// Exposed as a C ABI for ctypes (chiron_tpu_torch/io/signal.py; built by
// chiron_tpu_torch/ops/host_build.py).

#include <cstdlib>

namespace {

inline bool is_space(char c) {
  return c == ' ' || c == '\n' || c == '\t' || c == '\r' || c == '\v' ||
         c == '\f';
}

}  // namespace

extern "C" {

// Parses up to max_out numbers from buf[0..n) into out. buf MUST be
// NUL-terminated at buf[n] (CPython bytes objects are). Returns the count
// of numbers parsed.
long long chiron_parse_signal(const char* buf, long long n, float* out,
                              long long max_out) {
  const char* p = buf;
  const char* end = buf + n;
  long long count = 0;
  while (p < end && count < max_out) {
    while (p < end && is_space(*p)) ++p;
    if (p >= end) break;
    const char* tok = p;
    bool neg = false;
    if (*p == '-' || *p == '+') {
      neg = (*p == '-');
      ++p;
    }
    long long v = 0;
    int digits = 0;
    while (p < end && *p >= '0' && *p <= '9' && digits < 18) {
      v = v * 10 + (*p - '0');
      ++p;
      ++digits;
    }
    const bool more = p < end && !is_space(*p);  // '.', 'e', long runs, junk
    if (digits > 0 && !more) {
      // negate the float, not the integer: "-0" is -0.0, as strtof and
      // numpy read it (the JAX package's copy gives +0.0 there)
      const float f = static_cast<float>(v);
      out[count++] = neg ? -f : f;
    } else {
      char* q;
      float f = strtof(tok, &q);
      if (q == tok) {  // unparsable token; skip it
        while (p < end && !is_space(*p)) ++p;
        continue;
      }
      out[count++] = f;
      p = q;
    }
  }
  return count;
}

}  // extern "C"
