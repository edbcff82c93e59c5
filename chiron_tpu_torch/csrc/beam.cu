// CTC prefix beam search (search + traceback), blank = last class.
//
// Replaces the TPU kernels in chiron_tpu/ops/pallas/beam.py:
//   beam_search_kernel     <- beam_search_pallas's search (_beam_kernel/_beam_step)
//   beam_traceback_kernel  <- _traceback_kernel
// with the semantics of the XLA twin chiron_tpu/ops/ctc_beam.py:50-188
// (which the Pallas kernel matches exactly): per step, stay and extend
// candidates scored in log space with the -1e30 sentinel, length_bonus on
// every extend (merged extend mass included), extends merged into stays
// with an equal 32-bit rolling prefix hash (h * 2654435761 + label + 1,
// wrapping uint32), then the exact top-W of the candidate pool
// [stays | extends by label 0 | ... ] with ties to the lowest index (the
// lax.top_k order). Rows past their length freeze and emit no-op records.
//
// What bounds it on an H100: nothing the card's peak rates see -- per row
// the T steps are sequential and each step is a few hundred operations on
// a (nlab+1)*W candidate pool, so it is bound by per-step latency (block
// synchronisations and shared-memory round trips). The design: one block
// per batch row, the beam state in shared memory, one thread per
// candidate; the top-W is a rank count (each candidate counts the
// candidates ahead of it in (score desc, index asc) order, O(cand^2) compares
// spread over cand threads, no serial extract-max loop); the (parent, char)
// trace goes to global memory as (char + 1) * W + parent, and the traceback
// walks it with one thread per row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr uint32_t MULT = 2654435761u;
constexpr int MAX_W = 64;
constexpr int MAX_C = 8;
constexpr int MAX_CAND = MAX_W * MAX_C;

__device__ __forceinline__ float lae(float a, float b) {
  const float mx = fmaxf(a, b);
  const float mn = fminf(a, b);
  return mx <= NEG ? NEG : mx + log1pf(expf(mn - mx));
}

__global__ void beam_search_kernel(const float* __restrict__ lp, const int* __restrict__ lens,
                                   int* __restrict__ trace, float* __restrict__ pb_out,
                                   float* __restrict__ pnb_out, int T, int C, int W,
                                   float bonus) {
  __shared__ float pb[MAX_W], pnb[MAX_W], pbnb[MAX_W], stay_pb[MAX_W], stay_pnb0[MAX_W];
  __shared__ uint32_t hs[MAX_W];
  __shared__ int last[MAX_W];
  __shared__ float ext_pnb[MAX_CAND];
  __shared__ uint32_t ext_h[MAX_CAND];
  __shared__ float cand_pb[MAX_CAND], cand_pnb[MAX_CAND], score[MAX_CAND];
  __shared__ int sel[MAX_W];
  __shared__ float lps[MAX_C];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nlab = C - 1;
  const int n_ext = nlab * W;
  const int cand = W + n_ext;
  const int len = lens[b];

  if (tid < W) {
    pb[tid] = tid == 0 ? 0.f : NEG;
    pnb[tid] = NEG;
    hs[tid] = tid == 0 ? 1u : (uint32_t)tid * 7919u + 3u;
    last[tid] = -1;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (tid < C) lps[tid] = lp[((size_t)b * T + t) * C + tid];
    __syncthreads();
    const float lp_blank = lps[nlab];
    // stay candidates
    if (tid < W) {
      const float m = lae(pb[tid], pnb[tid]);
      pbnb[tid] = m;
      stay_pb[tid] = m + lp_blank;
      const int l = last[tid];
      stay_pnb0[tid] = l >= 0 ? pnb[tid] + lps[l] : NEG;
    }
    __syncthreads();
    // extend candidates: e = c * W + x
    if (tid < n_ext) {
      const int c = tid / W;
      const int x = tid - c * W;
      const float base = c == last[x] ? pb[x] : pbnb[x];
      ext_pnb[tid] = lps[c] + base + bonus;
      ext_h[tid] = hs[x] * MULT + (uint32_t)(c + 1);
    }
    __syncthreads();
    // merge extends into equal-hash stays; assemble the candidate pool
    if (tid < W) {
      const uint32_t hy = hs[tid];
      float mmax = NEG;
      for (int e = 0; e < n_ext; ++e)
        if (ext_h[e] == hy) mmax = fmaxf(mmax, ext_pnb[e]);
      float msum = 0.f;
      for (int e = 0; e < n_ext; ++e)
        if (ext_h[e] == hy) msum += expf(ext_pnb[e] - mmax);
      const float merged = mmax > NEG / 2 ? mmax + logf(fmaxf(msum, 1e-37f)) : NEG;
      const float spnb = lae(stay_pnb0[tid], merged);
      cand_pb[tid] = stay_pb[tid];
      cand_pnb[tid] = spnb;
      score[tid] = lae(stay_pb[tid], spnb);
    } else if (tid < cand) {
      const int e = tid - W;
      const uint32_t he = ext_h[e];
      bool killed = false;
      for (int y = 0; y < W; ++y) killed |= hs[y] == he;
      const float v = killed ? NEG : ext_pnb[e];
      cand_pb[tid] = NEG;
      cand_pnb[tid] = v;
      score[tid] = lae(NEG, v);
    }
    __syncthreads();
    // exact top-W: rank in (score desc, index asc) order
    if (tid < cand) {
      const float s = score[tid];
      int rank = 0;
      for (int j = 0; j < cand; ++j) {
        const float o = score[j];
        rank += (o > s) || (o == s && j < tid);
      }
      if (rank < W) sel[rank] = tid;
    }
    __syncthreads();
    const bool active = t < len;
    float npb = 0.f, npnb = 0.f;
    uint32_t nh = 0u;
    int nlast = 0;
    if (tid < W) {
      const int i = sel[tid];
      const bool is_stay = i < W;
      const int parent = is_stay ? i : (i - W) % W;
      const int ch = is_stay ? -1 : (i - W) / W;
      npb = cand_pb[i];
      npnb = cand_pnb[i];
      nh = is_stay ? hs[parent] : hs[parent] * MULT + (uint32_t)(ch + 1);
      nlast = is_stay ? last[parent] : ch;
      trace[((size_t)b * T + t) * W + tid] = active ? (ch + 1) * W + parent : tid;
    }
    __syncthreads();
    if (tid < W && active) {
      pb[tid] = npb;
      pnb[tid] = npnb;
      hs[tid] = nh;
      last[tid] = nlast;
    }
    __syncthreads();
  }
  if (tid < W) {
    pb_out[b * W + tid] = pb[tid];
    pnb_out[b * W + tid] = pnb[tid];
  }
}

__global__ void beam_traceback_kernel(const int* __restrict__ trace, const int* __restrict__ best,
                                      int* __restrict__ chars, int B, int T, int W) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int w = best[b];
  for (int t = T - 1; t >= 0; --t) {
    const int v = trace[((size_t)b * T + t) * W + w];
    chars[(size_t)b * T + t] = v / W - 1;
    w = v % W;
  }
}

}  // namespace

extern "C" {

int beam_max_width() { return MAX_W; }
int beam_max_classes() { return MAX_C; }

// lp: [B, T, C] float32 log-softmax (blank = C - 1); lens: [B] int32.
// trace: [B, T, W] int32; pb_out, pnb_out: [B, W] float32.
int beam_search_launch(const float* lp, const int* lens, int* trace, float* pb_out,
                       float* pnb_out, int B, int T, int C, int W, float bonus, void* stream) {
  const int cand = W * C;
  const int threads = ((cand + 31) / 32) * 32;
  beam_search_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(lp, lens, trace, pb_out, pnb_out,
                                                              T, C, W, bonus);
  return (int)cudaGetLastError();
}

// trace: [B, T, W] int32, best: [B] int32 -> chars: [B, T] int32 (-1 = none).
int beam_traceback_launch(const int* trace, const int* best, int* chars, int B, int T, int W,
                          void* stream) {
  beam_traceback_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(trace, best, chars,
                                                                          B, T, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
