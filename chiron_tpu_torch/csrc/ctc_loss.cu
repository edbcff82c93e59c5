// CTC loss (forward algorithm) and its gradient through the log-softmax,
// blank = last class.
//
// Replaces, on the card, the port's plain version (ops/ctc_loss.py:_CTCLoss,
// one Python loop over T each way, ~10 launches a frame). The JAX package
// computes the same recursions with lax.scan, not with a Pallas kernel
// (chiron_tpu/ops/ctc_loss.py:79-105 the alpha, :151-190 the beta and the
// posterior):
//   ctc_alpha_kernel     <- the forward: each frame's log-softmax, the alpha
//                           recursion over the blank-interleaved labels, nll
//   ctc_beta_grad_kernel <- the backward: the beta recursion, the posterior,
//                           dlogits = g (dlp - softmax * sum(dlp))
// The arithmetic is the plain version's, term for term, in float32: the same
// -1e30 sentinel for "impossible" (slots past 2L + 1 and forbidden skips add
// it, shifts fill with it), torch.logaddexp's max + log1p(exp(-|a - b|)) with
// accurate expf / log1pf (no fast math), alpha frozen from t = len on, beta
// reset to its start at t >= len - 1, the posterior exp(min(gamma, 0)) where
// gamma > -5e29 on active frames, zero loss and gradient where the label is
// longer than the logits, and the one-hot product's rule that a label outside
// [0, C) emits 0.
//
// What bounds it on an H100: per row the T frames are sequential and a frame
// is two logaddexps a slot (accurate expf and log1pf) over S = 2U + 1 slots,
// so each kernel is bound by the latency of a frame times T and by the SMs'
// instruction throughput over B * S slots, not by bytes: the logits in, lp and the
// [B, T, S] alpha residual out and back in, dlogits out take ~95 us at
// 3.35 TB/s at the train step's B = T = 400, S = 241. The design keeps the
// frame short and its work to the slots a path can reach:
//  - one block a row, a slot a thread (SPT slots a thread where S exceeds
//    what a block's threads cover: the only choice made from the input);
//  - alpha (forward) and beta + emit + mask (backward) in shared memory,
//    double-buffered by frame parity, so ONE __syncthreads a frame;
//  - the emit (the row's lp gathered at the slot's class) and the alpha
//    residual are loaded a frame or two ahead into registers;
//  - a logaddexp of two sentinel-scale values (slots past the label, or not
//    yet reachable) exits before expf and log1pf with the same bits;
//  - the backward sums each class's posterior in a fixed order, so two runs
//    give the same bits: each warp adds its own slots' posteriors from
//    registers (a butterfly of shuffles, before the frame's barrier), the
//    last warp adds the warps' sums in warp order after it, and writes the
//    frame's dlogits after the next frame's barrier. There is no [T, B, S]
//    beta, gamma or posterior tensor and no one-hot product.

#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xFFFFFFFFu;

// torch.logaddexp's formula (ATen's CUDA kernel), bit for bit. Below -2^25
// the log1p term (at most ln 2) is under half an ulp of the max, so the sum
// rounds to the max: the sentinel-scale values of unreachable slots take
// that exit and skip expf and log1pf (a NaN operand does not)
__device__ __forceinline__ float log_add_exp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b), d = a - b;
  if (m < -33554432.f && d == d) return m;
  return m + log1pf(expf(-fabsf(d)));
}

// log-softmax of one frame in the order of torch's CUDA log_softmax (its
// persistent warp softmax for C <= 1024, PersistentSoftmax.cuh): lane l of
// a warp sums exp(x - max) over classes l, l + 32, ..., then a butterfly adds
// the lanes (lanes past C add exact zeros, so 32 lanes give the same bits as
// next_pow2(C)); out = (x - max) - log(sum). One thread walks that tree, so
// lp, and with it alpha, beta and nll, are the plain version's bit for bit.
__device__ __forceinline__ void log_softmax_frame(const float* xt, float* out, int C) {
  float m = xt[0];
  for (int c = 1; c < C; ++c) m = fmaxf(m, xt[c]);
  float v[32];
#pragma unroll
  for (int l = 0; l < 32; ++l) {
    float sum = 0.f;
    for (int c = l; c < C; c += 32) sum += expf(xt[c] - m);
    v[l] = sum;
  }
#define TREE_LEVEL(OFF)                            \
  _Pragma("unroll") for (int l = 0; l < OFF; ++l) \
    v[l] += v[l + OFF];
  TREE_LEVEL(16)
  TREE_LEVEL(8)
  TREE_LEVEL(4)
  TREE_LEVEL(2)
  TREE_LEVEL(1)
#undef TREE_LEVEL
  const float lse = logf(v[0]);
  for (int c = 0; c < C; ++c) out[c] = (xt[c] - m) - lse;
}

// the one-hot product lp[t] . onehot(cls): lp[t, cls], or 0 for no class
__device__ __forceinline__ float emit(const float* lpt, int cls) {
  return cls >= 0 ? lpt[cls] : 0.f;
}

// row b's blank-interleaved labels into ex[0, S): the blank on even slots,
// labels[b, (s - 1) / 2] on odd ones (padding included, as given)
__device__ __forceinline__ void load_extended(int* ex, const int* labels, int b, int U, int S,
                                              int blank) {
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    ex[s] = (s & 1) ? labels[(size_t)b * U + (s >> 1)] : blank;
}

// the most threads a block of SPT slots a thread runs, so that each thread
// keeps its slots in registers (1024 threads leave 64 registers a thread, 320
// leave 200); ops/ctc_loss.py:SLOTS_PER_THREAD holds the same numbers
constexpr int max_threads(int spt) { return spt <= 2 ? 1024 : spt <= 8 ? 512 : 320; }

template <int SPT>
__global__ void __launch_bounds__(max_threads(SPT), 1)
ctc_alpha_kernel(const float* __restrict__ logits, const int* __restrict__ logit_len,
                 const int* __restrict__ labels, const int* __restrict__ label_len,
                 float* lp, float* __restrict__ alpha, float* __restrict__ nll_out,
                 float* __restrict__ loss_out, int T, int C, int U) {
  extern __shared__ float smem[];
  const int S = 2 * U + 1, b = blockIdx.x, nth = blockDim.x, blank = C - 1;
  float* abuf = smem;                              // [2][S] alpha by frame parity
  int* ex = reinterpret_cast<int*>(smem + 2 * S);  // [S]
  const int len = logit_len[b], L = label_len[b];
  const float* x = logits + (size_t)b * T * C;
  // lp is written here and read back below by other threads: plain loads
  // (no read-only path), ordered by the barrier
  float* lpb = lp + (size_t)b * T * C;
  float* ab = alpha + (size_t)b * T * S;

  for (int t = threadIdx.x; t < T; t += nth)
    log_softmax_frame(x + (size_t)t * C, lpb + (size_t)t * C, C);
  load_extended(ex, labels, b, U, S, blank);
  __syncthreads();

  // per slot: its class, and bits of the slot mask (0 inside 2L + 1) and of
  // the skip s - 2 -> s (allowed between two different labels)
  int cls[SPT];
  unsigned valid = 0, skip = 0;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int s = threadIdx.x + k * nth;
    const int e = s < S ? ex[s] : blank;
    const int e2 = s >= 2 && s < S ? ex[s - 2] : blank;
    cls[k] = e >= 0 && e < C ? e : -1;
    if (e != blank && e != e2) skip |= 1u << k;
    if (s < 2 * L + 1) valid |= 1u << k;
  }
#define SLOT_MASK(k) ((valid >> (k)) & 1u ? 0.f : NEG)

  // frame 0: the blank and the first label, then the slot mask
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int s = threadIdx.x + k * nth;
    if (s < S) {
      float a = NEG;
      if (s == 0) a = emit(lpb, cls[k]);
      if (s == 1) a = L > 0 ? emit(lpb, cls[k]) : NEG;
      a += SLOT_MASK(k);
      abuf[s] = a;
      ab[s] = a;
    }
  }
  __syncthreads();

  // frames 1 .. len - 1; alpha keeps its value from t = len on
  const int tend = min(len, T);
  float e_next[SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k)
    e_next[k] = 1 < tend && threadIdx.x + k * nth < S ? emit(lpb + C, cls[k]) : 0.f;
  for (int t = 1; t < tend; ++t) {
    const float* cur = abuf + ((t - 1) & 1) * S;
    float* nxt = abuf + (t & 1) * S;
    float e_t[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      e_t[k] = e_next[k];
      e_next[k] = t + 1 < tend && threadIdx.x + k * nth < S
                      ? emit(lpb + (size_t)(t + 1) * C, cls[k]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = threadIdx.x + k * nth;
      if (s < S) {
        const float a1 = s >= 1 ? cur[s - 1] : NEG;
        const float a2 = (s >= 2 ? cur[s - 2] : NEG) + ((skip >> k) & 1u ? 0.f : NEG);
        const float a = log_add_exp(log_add_exp(cur[s], a1), a2) + e_t[k] + SLOT_MASK(k);
        nxt[s] = a;
        ab[(size_t)t * S + s] = a;
      }
    }
    __syncthreads();
  }
#undef SLOT_MASK

  if (threadIdx.x == 0) {
    const float* af = abuf + ((max(tend, 1) - 1) & 1) * S;
    const int last = max(min(2 * L, S - 1), 0);
    const float a_prev = L > 0 && last > 0 ? af[last - 1] : NEG;
    const float nll = -log_add_exp(af[last], a_prev);
    nll_out[b] = nll;
    loss_out[b] = L > len ? 0.f : nll;
  }
}

template <int SPT>
__global__ void __launch_bounds__(max_threads(SPT), 1)
ctc_beta_grad_kernel(const float* __restrict__ lp, const float* __restrict__ alpha,
                     const float* __restrict__ nll, const float* __restrict__ g,
                     const int* __restrict__ logit_len, const int* __restrict__ labels,
                     const int* __restrict__ label_len, float* __restrict__ dlogits, int T, int C,
                     int U) {
  extern __shared__ float smem[];
  const int S = 2 * U + 1, b = blockIdx.x, nth = blockDim.x, blank = C - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = nth >> 5;
  float* nbuf = smem;               // [2][S] beta + emit + mask of the frame after, by parity
  float* wpart = smem + 2 * S;      // [2][nwarps][C] each warp's posterior sum of each class
  float* dsum = wpart + 2 * nwarps * C;  // [2][C] -(the posterior summed over a class's slots)
  int* ex = reinterpret_cast<int*>(dsum + 2 * C);  // [S]
  const int len = logit_len[b], L = label_len[b];
  const int tend = max(min(len, T), 0);
  const bool ignore = L > len;
  float* out = dlogits + (size_t)b * T * C;
  // frames past the length, and every frame of an ignored row: zero gradient
  for (int i = (ignore ? 0 : tend * C) + threadIdx.x; i < T * C; i += nth) out[i] = 0.f;
  if (ignore || tend == 0) return;  // the same for every thread of the block

  load_extended(ex, labels, b, U, S, blank);
  __syncthreads();
  const float* lpb = lp + (size_t)b * T * C;
  const float* ab = alpha + (size_t)b * T * S;
  const float nl = nll[b], gb = g[b];

  // per slot: its class; bits of the slot mask, of the skip s + 2 -> s (the
  // skip into slot s + 2 of the forward) and of beta's start (0 at the last
  // two slots of the label)
  int cls[SPT];
  unsigned valid = 0, skip2 = 0, start = 0;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int s = threadIdx.x + k * nth;
    const int e = s < S ? ex[s] : blank;
    const int e2 = s + 2 < S ? ex[s + 2] : blank;
    cls[k] = e >= 0 && e < C ? e : -1;
    if (s < 2 * L + 1) valid |= 1u << k;
    if (e2 != blank && e2 != e) skip2 |= 1u << k;
    if (s == 2 * L || (s == 2 * L - 1 && L > 0)) start |= 1u << k;
  }
#define SLOT_MASK(k) ((valid >> (k)) & 1u ? 0.f : NEG)
#define START(k) ((start >> (k)) & 1u ? 0.f : NEG)

  // the last warp turns a frame's class sums into its dlogits, the plain
  // version's roundings: dlp - exp(lp) * sum(dlp), then times g
  const int mine = nth - 1 - threadIdx.x;
  auto write_frame = [&](int t, const float* sums) {
    for (int c = mine; c < C; c += nth) {
      float total = 0.f;
      for (int j = 0; j < C; ++j) total += sums[j];
      const float p = expf(lpb[(size_t)t * C + c]);
      out[(size_t)t * C + c] = (sums[c] - __fmul_rn(p, total)) * gb;
    }
  };

  const int top = tend - 1;
  // what frame top's beta reads: only a row longer than T recurses at its
  // last frame, from beta's start and the emit of frame min(top + 1, T - 1)
  if (top < len - 1) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = threadIdx.x + k * nth;
      if (s < S) nbuf[s] = START(k) + emit(lpb + (size_t)(T - 1) * C, cls[k]) + SLOT_MASK(k);
    }
  }
  float a0[SPT], a1[SPT];  // alpha of frames t and t - 1
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int s = threadIdx.x + k * nth;
    a0[k] = s < S ? ab[(size_t)top * S + s] : 0.f;
    a1[k] = s < S && top >= 1 ? ab[(size_t)(top - 1) * S + s] : 0.f;
  }
  __syncthreads();

  int it = 0;
  for (int t = top; t >= 0; --t, ++it) {
    const int par = it & 1;
    const float* nin = nbuf + par * S;
    float* nout = nbuf + (par ^ 1) * S;
    // a frame or two ahead: alpha of frame t - 2, the emit of frame t (read
    // by frame t - 1's beta)
    float a2[SPT], e[SPT], post[SPT];
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = threadIdx.x + k * nth;
      a2[k] = s < S && t >= 2 ? ab[(size_t)(t - 2) * S + s] : 0.f;
      e[k] = s < S && t >= 1 ? emit(lpb + (size_t)t * C, cls[k]) : 0.f;
    }
    const bool recur = t < len - 1;
    bool live = false;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = threadIdx.x + k * nth;
      post[k] = 0.f;
      if (s < S) {
        float beta = START(k);
        if (recur) {
          const float n1 = s + 1 < S ? nin[s + 1] : NEG;
          const float n2 = s + 2 < S ? nin[s + 2] + ((skip2 >> k) & 1u ? 0.f : NEG) : NEG;
          beta = log_add_exp(log_add_exp(nin[s], n1), n2);
        }
        const float gamma = a0[k] + beta + nl;
        if (gamma > NEG / 2) post[k] = expf(fminf(gamma, 0.f));
        live |= post[k] != 0.f;
        if (t >= 1) nout[s] = beta + e[k] + SLOT_MASK(k);
      }
      a0[k] = a1[k];
      a1[k] = a2[k];
    }
    // this warp's posterior sum of each class: its slots in order, then a
    // butterfly of shuffles (a fixed order; a warp with no posterior adds 0)
    float* wp = wpart + (par * nwarps + warp) * C;
    if (__any_sync(FULL, live)) {
      for (int c0 = 0; c0 < C; c0 += 8) {
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = 0.f;
#pragma unroll
          for (int k = 0; k < SPT; ++k) v[j] += cls[k] == c0 + j ? post[k] : 0.f;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (c0 + j < C) v[j] += __shfl_xor_sync(FULL, v[j], o);
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (c0 + j < C) wp[c0 + j] = v[j];
        }
      }
    } else if (lane == 0) {
      for (int c = 0; c < C; ++c) wp[c] = 0.f;
    }
    __syncthreads();
    // frame t's class sums over the warps in order; frame t + 1's dlogits
    // from its sums, complete since the barrier before this one
    for (int c = mine; c < C; c += nth) {
      float acc = 0.f;
      for (int w = 0; w < nwarps; ++w) acc += wpart[(par * nwarps + w) * C + c];
      dsum[par * C + c] = -acc;
    }
    if (it > 0) write_frame(t + 1, dsum + (par ^ 1) * C);
  }
  __syncthreads();
  write_frame(0, dsum + ((it - 1) & 1) * C);
#undef SLOT_MASK
#undef START
}

template <int SPT>
int alpha_instance(const float* logits, const int* logit_len, const int* labels,
                   const int* label_len, float* lp, float* alpha, float* nll, float* loss, int B,
                   int T, int C, int U, int threads, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_alpha_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  ctc_alpha_kernel<SPT><<<B, threads, smem, stream>>>(logits, logit_len, labels, label_len, lp,
                                                      alpha, nll, loss, T, C, U);
  return (int)cudaGetLastError();
}

template <int SPT>
int beta_instance(const float* lp, const float* alpha, const float* nll, const float* g,
                  const int* logit_len, const int* labels, const int* label_len, float* dlogits,
                  int B, int T, int C, int U, int threads, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_beta_grad_kernel<SPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  ctc_beta_grad_kernel<SPT><<<B, threads, smem, stream>>>(lp, alpha, nll, g, logit_len, labels,
                                                          label_len, dlogits, T, C, U);
  return (int)cudaGetLastError();
}

bool geometry_ok(int B, int T, int C, int U, int spt, int threads) {
  return B >= 1 && T >= 1 && C >= 1 && U >= 0 && threads >= 32 && threads % 32 == 0 &&
         threads <= max_threads(spt) && (long long)spt * threads >= 2LL * U + 1;
}

}  // namespace

extern "C" {

// logits: [B, T, C] float32; logit_len, label_len: [B] int32; labels: [B, U]
// int32. Writes lp [B, T, C], alpha [B, T, 2U + 1] (frames t < logit_len,
// and frame 0), nll and loss [B] (loss 0 where label_len > logit_len).
int ctc_alpha_launch(const float* logits, const int* logit_len, const int* labels,
                     const int* label_len, float* lp, float* alpha, float* nll, float* loss,
                     int B, int T, int C, int U, int spt, int threads, int smem, void* stream) {
  if (!geometry_ok(B, T, C, U, spt, threads)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define ALPHA_CASE(N) \
  case N:             \
    return alpha_instance<N>(logits, logit_len, labels, label_len, lp, alpha, nll, loss, B, T, \
                             C, U, threads, smem, st);
  switch (spt) {
    ALPHA_CASE(1)
    ALPHA_CASE(2)
    ALPHA_CASE(8)
    ALPHA_CASE(16)
  }
#undef ALPHA_CASE
  return (int)cudaErrorInvalidValue;
}

// lp, alpha, nll from ctc_alpha_launch; g: [B] float32, the loss's
// cotangent. Writes dlogits [B, T, C].
int ctc_beta_grad_launch(const float* lp, const float* alpha, const float* nll, const float* g,
                         const int* logit_len, const int* labels, const int* label_len,
                         float* dlogits, int B, int T, int C, int U, int spt, int threads,
                         int smem, void* stream) {
  if (!geometry_ok(B, T, C, U, spt, threads)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define BETA_CASE(N) \
  case N:            \
    return beta_instance<N>(lp, alpha, nll, g, logit_len, labels, label_len, dlogits, B, T, C, \
                            U, threads, smem, st);
  switch (spt) {
    BETA_CASE(1)
    BETA_CASE(2)
    BETA_CASE(8)
    BETA_CASE(16)
  }
#undef BETA_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
