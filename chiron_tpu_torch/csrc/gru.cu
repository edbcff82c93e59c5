// One GRU layer, the whole T-step recurrence in one launch: both directions
// (bigru_launch) or one (gru_launch), through the same kernel.
//
// Replaces the TPU kernels chiron_tpu/ops/pallas/gru.py:bigru_layer_pallas
// (_bigru_kernel) and gru_layer_pallas (_gru_kernel). Same function, over the
// precomputed input projections gx = x @ wx_g + b_g ([T, B, 2H], columns r
// then u) and cx = x @ wx_c + b_c ([T, B, H]):
//   [r, u] = sig(gx[t] + h @ whg);  cand = tanh(cx[t] + (r * h) @ whc)
//   h' = u * h + (1 - u) * cand
// Each row is active on a window start <= t < start + len (the fused layer's
// forward rows start at 0, its backward rows read the time-FLIPPED sequence
// and start at T - len; a single direction takes an optional starts array).
// Outside its window a row's state is frozen and its output is zero.
//
// What bounds it on an H100: per step a direction does [B, H] x [H, 2H] and
// [B, H] x [H, H] products (~31 GFLOP per layer at B = T = 400, H = 128),
// but the T steps are sequential and each step has two dependent products
// (the candidate needs the whole row of r), so the kernel is bound by
// per-step latency, not by the card's peak rate. The design is bilstm.cu's:
// one block per (direction, tile of R batch rows), one thread per gate
// column (2H threads), the tile's h in shared memory, each thread streaming
// its weight column from L2 once per step for all R rows. The extra stage:
// the gate threads leave r * h and u in shared memory, a barrier, then the
// first H threads do the candidate product from r * h and update h. h of the
// previous step stays intact until both products are done: each thread of
// the second stage overwrites only its own element, after reading it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 8;  // batch rows per block
constexpr int MAX_H = 512;  // one thread per gate column: 2H <= 1024

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// THREADS bounds the block (2H rounded up to a warp): 256 covers H <= 128, 512
// H <= 256 and 1024 H <= 512, so that the registers of one block always fit an
// SM. The second
// bound (one block per SM is enough) lets the compiler spend registers on
// unrolling the product loops, which keeps several weight loads in flight
// against the L2 latency that bounds a step: builds that aimed at more
// blocks per SM (48-64 registers) took 2.2-2.4x as long on an H100.
template <int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
gru_kernel(const float* __restrict__ gx_f, const float* __restrict__ cx_f,
           const float* __restrict__ gx_b, const float* __restrict__ cx_b,
           const float* __restrict__ whg_f, const float* __restrict__ whc_f,
           const float* __restrict__ whg_b, const float* __restrict__ whc_b,
           const int* __restrict__ lens, const int* __restrict__ starts_f,
           const int* __restrict__ starts_b, float* __restrict__ out_f,
           float* __restrict__ out_b, int T, int B, int H) {
  extern __shared__ float smem[];
  float* h_s = smem;            // [R][H]
  float* rh_s = h_s + R * H;    // [R][H]  r * h
  float* u_s = rh_s + R * H;    // [R][H]

  const int dir = blockIdx.y;  // 0 forward, 1 backward (flipped input)
  const float* gx = dir == 0 ? gx_f : gx_b;
  const float* cx = dir == 0 ? cx_f : cx_b;
  const float* whg = dir == 0 ? whg_f : whg_b;
  const float* whc = dir == 0 ? whc_f : whc_b;
  const int* starts = dir == 0 ? starts_f : starts_b;  // null: every row starts at 0
  float* out = dir == 0 ? out_f : out_b;
  const int b0 = blockIdx.x * R;
  const int G = 2 * H;
  const int col = threadIdx.x;

  for (int i = threadIdx.x; i < R * H; i += blockDim.x) h_s[i] = 0.f;
  int lo[R], hi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + r;
    const int len = b < B ? lens[b] : 0;
    const int st = (b < B && starts != nullptr) ? starts[b] : 0;
    lo[r] = st;
    hi[r] = st + len;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // stage 1: the gates r (columns < H) and u, from gx[t] + h @ whg
    if (col < G) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        acc[r] = b < B ? gx[((size_t)t * B + b) * G + col] : 0.f;
      }
      for (int k = 0; k < H; ++k) {
        const float wv = whg[(size_t)k * G + col];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(h_s[r * H + k], wv, acc[r]);
      }
      if (col < H) {
#pragma unroll
        for (int r = 0; r < R; ++r) rh_s[r * H + col] = sigm(acc[r]) * h_s[r * H + col];
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) u_s[r * H + col - H] = sigm(acc[r]);
      }
    }
    __syncthreads();
    // stage 2: the candidate from cx[t] + (r * h) @ whc, the update, the mask
    if (col < H) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        acc[r] = b < B ? cx[((size_t)t * B + b) * H + col] : 0.f;
      }
      for (int k = 0; k < H; ++k) {
        const float wv = whc[(size_t)k * H + col];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(rh_s[r * H + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        if (b >= B) continue;
        float hv = 0.f;
        if (t >= lo[r] && t < hi[r]) {
          const float u = u_s[r * H + col];
          hv = u * h_s[r * H + col] + (1.f - u) * tanhf(acc[r]);
          h_s[r * H + col] = hv;
        }
        out[((size_t)t * B + b) * H + col] = hv;
      }
    }
    __syncthreads();
  }
}

int launch(int dirs, const float* gx_f, const float* cx_f, const float* gx_b, const float* cx_b,
           const float* whg_f, const float* whc_f, const float* whg_b, const float* whc_b,
           const int* lens, const int* starts_f, const int* starts_b, float* out_f, float* out_b,
           int T, int B, int H, void* stream) {
  if (H < 1 || H > MAX_H) return (int)cudaErrorInvalidValue;
  const int threads = ((2 * H + 31) / 32) * 32;
  const size_t smem = (size_t)R * 3 * H * sizeof(float);
  auto kernel = threads <= 256 ? gru_kernel<256> : threads <= 512 ? gru_kernel<512>
                                                                  : gru_kernel<1024>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + R - 1) / R, dirs);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      gx_f, cx_f, gx_b, cx_b, whg_f, whc_f, whg_b, whc_b, lens, starts_f, starts_b, out_f, out_b,
      T, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// gx_*: [T, B, 2H] float32, cx_*: [T, B, H], whg_*: [H, 2H], whc_*: [H, H],
// lens/starts: [B] int32, out_*: [T, B, H]. H <= 512.
int bigru_launch(const float* gx_f, const float* cx_f, const float* gx_b, const float* cx_b,
                 const float* whg_f, const float* whc_f, const float* whg_b, const float* whc_b,
                 const int* lens, const int* starts, float* out_f, float* out_b, int T, int B,
                 int H, void* stream) {
  return launch(2, gx_f, cx_f, gx_b, cx_b, whg_f, whc_f, whg_b, whc_b, lens, nullptr, starts,
                out_f, out_b, T, B, H, stream);
}

// One direction; starts may be null (every row's window is [0, len)).
int gru_launch(const float* gx, const float* cx, const float* whg, const float* whc,
               const int* lens, const int* starts, float* out, int T, int B, int H,
               void* stream) {
  return launch(1, gx, cx, nullptr, nullptr, whg, whc, nullptr, nullptr, lens, starts, nullptr,
                out, nullptr, T, B, H, stream);
}

}  // extern "C"
