// The CRF decode of a linear-chain basecaller (Bonito's CTC-CRF models):
// forward-backward edge posteriors over S = 4^state_len states, then Viterbi
// over their logs, per row over its own frames. ops/crf.py holds the
// semantics and the plain version; this file holds the kernels.
//
//   M[t, s, 0] = blank, M[t, s, k + 1] = z[b, t, 4 s + k]   (k = 0..3)
//   pred(s, 0) = s, pred(s, k + 1) = k N + s / 4            (N = S / 4)
//   alpha_0 = 0, alpha_{t+1}[s] = lse_c(alpha_t[pred(s, c)] + M[t, s, c])
//   beta_n = 0,  beta_t[p] = lse over the edges (s, c) with pred(s, c) = p of
//                beta_{t+1}[s] + M[t, s, c]
//   lpe[t, s, c] = log(exp(alpha_t[pred(s, c)] + M[t, s, c] + beta_{t+1}[s] - logZ)
//                      + 1e-8),  logZ = lse_s(beta_0[s])
//   v_0 = 0, v_{t+1}[s] = max_c(v_t[pred(s, c)] + lpe[t, s, c])
//
// What bounds it on an H100. At Bonito's HAC size (S = 1,024, T = 800, a batch
// of 400 rows) the decode reads each row-frame's 4,096 float32 scores (16 KB)
// in each of its two scans and beta (4 KB) twice, and writes a byte of
// traceback a (frame, state): ~41 KB a row-frame, 13 GB a batch, ~4 ms at
// 3.35 TB/s. Its arithmetic is ~20 exp / log a (frame, state). The scans are
// recurrences over 800 frames, so a row is one block and the frames follow
// one another; the card holds 2 blocks of 512 threads an SM, 264 rows at once.
//
// crf_beta_kernel: one block a row, a thread for S / blockDim states. Each
// thread keeps its states' beta_{t+1} in registers and reads its states'
// four scores of the frame as one coalesced float4 (prefetched a frame
// ahead). Thread of state s forms the four contributions beta_{t+1}[s] +
// M[t, s, k + 1] to the predecessors k N + s / 4 and stores them in shared
// memory as E[k][s % 4][s / 4] (row pitch N + 8, so the stores of a warp hit
// 32 banks); after one barrier the thread of state p = k N + u reads its four
// E[k][j][u] (consecutive u: no conflict) and adds its own stay. E is double
// buffered: one barrier a frame.
//
// crf_viterbi_kernel: one block a row, forwards. alpha_t and v_t of all S
// states live in shared memory (double buffered: one barrier a frame); a
// thread reads its states' predecessors there (4 threads share each: a
// broadcast), its scores as a float4 and its beta_{t+1} from global memory,
// both a frame ahead, and writes alpha_{t+1}, v_{t+1} and the traceback byte
// (the best column, lowest on ties). The frame's largest and second largest
// lpe are reduced within each warp and left in a ring of 64 frames in shared
// memory; every 32 frames warp 0 reduces them across the warps (a lane a
// frame) and adds the gaps, so the reduction costs no barrier of its own.
// The row's score and final state (lowest on ties) are reduced at the end.
//
// crf_traceback_kernel: a thread a row follows the traceback from the final
// state back to frame 0 and writes the path's column a frame (-1 past the
// row's length).
//
// Arithmetic: expf / logf / log1pf-free logsumexp as max + log(sum exp(x -
// max)), summed in column order, accurate (no fast-math intrinsics).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int RING = 64;          // frames of warp top-2 kept for warp 0
constexpr float POST_EPS = 1e-8f;

__device__ __forceinline__ float lse5(const float (&v)[5]) {
  float m = v[0];
#pragma unroll
  for (int c = 1; c < 5; ++c) m = fmaxf(m, v[c]);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 5; ++c) s += expf(v[c] - m);
  return m + logf(s);
}

// (a1 >= a2) merged with (b1 >= b2): the two largest of the four
__device__ __forceinline__ void merge_top2(float& a1, float& a2, float b1, float b2) {
  const float hi = fmaxf(a1, b1);
  const float lo = fmaxf(fminf(a1, b1), fmaxf(a2, b2));
  a1 = hi;
  a2 = lo;
}

__device__ __forceinline__ float4 load_scores(const float* zrow, int s) {
  return *reinterpret_cast<const float4*>(zrow + 4 * (size_t)s);
}

template <int SPT>
__global__ void __launch_bounds__(MAX_THREADS, 2)
crf_beta_kernel(const float* __restrict__ z, const int* __restrict__ lengths,
                float* __restrict__ beta, int T, int S, float blank) {
  extern __shared__ float sm[];
  const int N = S >> 2, P = N + 8;
  const int b = blockIdx.x;
  const int n = min(max(lengths[b], 0), T);
  const float* zb = z + (size_t)b * T * 4 * S;
  float* bb = beta + (size_t)b * (T + 1) * S;
  int st[SPT];
  bool on[SPT];
  float bt[SPT];
  float4 zc[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    st[i] = threadIdx.x + i * blockDim.x;
    on[i] = st[i] < S;
    bt[i] = 0.f;
    zc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on[i]) {
      bb[(size_t)n * S + st[i]] = 0.f;
      if (n > 0) zc[i] = load_scores(zb + (size_t)(n - 1) * 4 * S, st[i]);
    }
  }
  for (int t = n - 1; t >= 0; --t) {
    float* E = sm + (t & 1) * 16 * P;
    float4 zn[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      zn[i] = (on[i] && t > 0) ? load_scores(zb + (size_t)(t - 1) * 4 * S, st[i])
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      if (on[i]) {
        const int j = st[i] & 3, u = st[i] >> 2;
        E[(0 * 4 + j) * P + u] = bt[i] + zc[i].x;
        E[(1 * 4 + j) * P + u] = bt[i] + zc[i].y;
        E[(2 * 4 + j) * P + u] = bt[i] + zc[i].z;
        E[(3 * 4 + j) * P + u] = bt[i] + zc[i].w;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      if (on[i]) {
        const int k = st[i] / N, u = st[i] - k * N;
        float v[5];
        v[0] = bt[i] + blank;
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j + 1] = E[(k * 4 + j) * P + u];
        bt[i] = lse5(v);
        bb[(size_t)t * S + st[i]] = bt[i];
      }
      zc[i] = zn[i];
    }
  }
}

template <int SPT>
__global__ void __launch_bounds__(MAX_THREADS, 2)
crf_viterbi_kernel(const float* __restrict__ z, const int* __restrict__ lengths,
                   const float* __restrict__ beta, uint8_t* __restrict__ tb,
                   float* __restrict__ score, float* __restrict__ prob,
                   int* __restrict__ final_state, float* __restrict__ post, int T, int S,
                   float blank) {
  extern __shared__ float sm[];
  const int nw = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* A = sm;                     // [2][S] alpha
  float* V = A + 2 * S;              // [2][S] Viterbi
  float* top = V + 2 * S;            // [RING][nw][2] warp top-2 of lpe
  float* red = top + RING * nw * 2;  // [nw] block reductions
  int* redi = reinterpret_cast<int*>(red + nw);  // [nw]
  const int N = S >> 2;
  const int b = blockIdx.x;
  const int n = min(max(lengths[b], 0), T);
  const float* zb = z + (size_t)b * T * 4 * S;
  const float* bb = beta + (size_t)b * (T + 1) * S;
  int st[SPT];
  bool on[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    st[i] = threadIdx.x + i * blockDim.x;
    on[i] = st[i] < S;
  }

  // logZ = lse_s(beta_0[s]): block max, then block sum of exp(beta_0 - max)
  float m = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < SPT; ++i)
    if (on[i]) m = fmaxf(m, bb[st[i]]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < nw; ++w) m = fmaxf(m, red[w]);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < SPT; ++i)
    if (on[i]) sum += expf(bb[st[i]] - m);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  __syncthreads();  // every warp has read red[] as the maxima
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = 0.f;
  for (int w = 0; w < nw; ++w) sum += red[w];
  const float logz = m + logf(sum);

  float4 zc[SPT];
  float bc[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    zc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    bc[i] = 0.f;
    if (on[i]) {
      A[st[i]] = 0.f;
      V[st[i]] = 0.f;
      if (n > 0) {
        zc[i] = load_scores(zb, st[i]);
        bc[i] = bb[(size_t)S + st[i]];
      }
    }
  }
  float gap = 0.f;  // warp 0: the gaps of the frames its lanes reduced
  __syncthreads();
  for (int t = 0; t < n; ++t) {
    const float* Ac = A + (t & 1) * S;
    const float* Vc = V + (t & 1) * S;
    float* An = A + ((t + 1) & 1) * S;
    float* Vn = V + ((t + 1) & 1) * S;
    float t1 = -CUDART_INF_F, t2 = -CUDART_INF_F;
    float4 zn[SPT];
    float bn[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const bool ahead = on[i] && t + 1 < n;
      zn[i] = ahead ? load_scores(zb + (size_t)(t + 1) * 4 * S, st[i])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      bn[i] = ahead ? bb[(size_t)(t + 2) * S + st[i]] : 0.f;
      if (!on[i]) continue;
      const int s = st[i], u = s >> 2;
      int p[5] = {s, u, N + u, 2 * N + u, 3 * N + u};
      float a[5] = {Ac[s] + blank, Ac[p[1]] + zc[i].x, Ac[p[2]] + zc[i].y,
                    Ac[p[3]] + zc[i].z, Ac[p[4]] + zc[i].w};
      An[s] = lse5(a);
      const float shift = bc[i] - logz;
      float best = -CUDART_INF_F;
      int arg = 0;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const float lpe = logf(expf(a[c] + shift) + POST_EPS);
        const float w = Vc[p[c]] + lpe;
        if (w > best) {
          best = w;
          arg = c;
        }
        if (lpe > t1) {
          t2 = t1;
          t1 = lpe;
        } else if (lpe > t2) {
          t2 = lpe;
        }
        if (post != nullptr) post[(((size_t)b * T + t) * S + s) * 5 + c] = lpe;
      }
      Vn[s] = best;
      tb[((size_t)b * T + t) * S + s] = (uint8_t)arg;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      merge_top2(t1, t2, __shfl_xor_sync(0xffffffffu, t1, o),
                 __shfl_xor_sync(0xffffffffu, t2, o));
    if (lane == 0) {
      top[((t & (RING - 1)) * nw + warp) * 2] = t1;
      top[((t & (RING - 1)) * nw + warp) * 2 + 1] = t2;
    }
    __syncthreads();
    if (warp == 0 && ((t & 31) == 31 || t == n - 1)) {
      const int f = (t & ~31) + lane;
      if (f <= t) {
        const float* tf = top + (f & (RING - 1)) * nw * 2;
        float f1 = tf[0], f2 = tf[1];
        for (int w = 1; w < nw; ++w) merge_top2(f1, f2, tf[2 * w], tf[2 * w + 1]);
        gap += f1 - f2;
      }
    }
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      zc[i] = zn[i];
      bc[i] = bn[i];
    }
  }

  // the best final state (lowest on ties) and its score; the mean gap
  const float* Vf = V + (n & 1) * S;
  float best = -CUDART_INF_F;
  int arg = 0x7fffffff;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    if (on[i] && (Vf[st[i]] > best || (Vf[st[i]] == best && st[i] < arg))) {
      best = Vf[st[i]];
      arg = st[i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) gap += __shfl_xor_sync(0xffffffffu, gap, o);
  }
  __syncthreads();  // the loop's last reads of red[] are done
  if (lane == 0) {
    red[warp] = best;
    redi[warp] = arg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < nw; ++w) {
      if (red[w] > best || (red[w] == best && redi[w] < arg)) {
        best = red[w];
        arg = redi[w];
      }
    }
    score[b] = best;
    final_state[b] = arg;
    prob[b] = gap / (float)max(n, 1);
  }
}

__global__ void crf_traceback_kernel(const uint8_t* __restrict__ tb,
                                     const int* __restrict__ final_state,
                                     const int* __restrict__ lengths, int* __restrict__ path,
                                     int B, int T, int S) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int N = S >> 2;
  const int n = min(max(lengths[b], 0), T);
  int* pb = path + (size_t)b * T;
  for (int t = n; t < T; ++t) pb[t] = -1;
  int s = final_state[b];
  for (int t = n - 1; t >= 0; --t) {
    const int c = tb[((size_t)b * T + t) * S + s];
    pb[t] = c;
    s = c == 0 ? s : (c - 1) * N + (s >> 2);
  }
}

int threads_for(int S, int spt) {
  const int t = (S + spt - 1) / spt;
  return t < 32 ? 32 : (t + 31) / 32 * 32;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// z [B, T, 4S] float32, lengths [B] int32, beta [B, T + 1, S] float32 (written
// for frames 0..length). S = 4^state_len, 4 <= S <= 1024.
int crf_beta_launch(const float* z, const int* lengths, float* beta, int B, int T, int S,
                    float blank, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 4 || S > 1024 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int spt = S > MAX_THREADS ? 2 : 1;
  const int threads = threads_for(S, spt);
  const size_t smem = sizeof(float) * 2 * 16 * ((size_t)(S >> 2) + 8);
  cudaError_t err;
  if (spt == 2) {
    err = set_smem(crf_beta_kernel<2>, smem);
    if (err != cudaSuccess) return (int)err;
    crf_beta_kernel<2><<<B, threads, smem, st>>>(z, lengths, beta, T, S, blank);
  } else {
    err = set_smem(crf_beta_kernel<1>, smem);
    if (err != cudaSuccess) return (int)err;
    crf_beta_kernel<1><<<B, threads, smem, st>>>(z, lengths, beta, T, S, blank);
  }
  return (int)cudaGetLastError();
}

// tb [B, T, S] uint8, score / prob [B] float32, final_state [B] int32; post
// [B, T, S, 5] float32 or null (the tests' copy of every lpe).
int crf_viterbi_launch(const float* z, const int* lengths, const float* beta, uint8_t* tb,
                       float* score, float* prob, int* final_state, float* post, int B, int T,
                       int S, float blank, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 4 || S > 1024 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int spt = S > MAX_THREADS ? 2 : 1;
  const int threads = threads_for(S, spt);
  const int nw = threads / 32;
  const size_t smem = sizeof(float) * (4 * (size_t)S + RING * nw * 2 + 2 * nw);
  cudaError_t err;
  if (spt == 2) {
    err = set_smem(crf_viterbi_kernel<2>, smem);
    if (err != cudaSuccess) return (int)err;
    crf_viterbi_kernel<2><<<B, threads, smem, st>>>(z, lengths, beta, tb, score, prob,
                                                     final_state, post, T, S, blank);
  } else {
    err = set_smem(crf_viterbi_kernel<1>, smem);
    if (err != cudaSuccess) return (int)err;
    crf_viterbi_kernel<1><<<B, threads, smem, st>>>(z, lengths, beta, tb, score, prob,
                                                     final_state, post, T, S, blank);
  }
  return (int)cudaGetLastError();
}

// path [B, T] int32: the best path's column a frame, -1 past each length
int crf_traceback_launch(const uint8_t* tb, const int* final_state, const int* lengths,
                         int* path, int B, int T, int S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 4 || S > 1024 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  crf_traceback_kernel<<<(B + 127) / 128, 128, 0, st>>>(tb, final_state, lengths, path, B, T,
                                                         S);
  return (int)cudaGetLastError();
}

}  // extern "C"
