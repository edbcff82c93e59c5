// One LSTM layer, the whole T-step recurrence in one launch: both directions
// (bilstm_launch) or one (lstm_launch), through the same kernel.
//
// Replaces the TPU kernels chiron_tpu/ops/pallas/lstm.py:bilstm_layer_pallas
// (_bilstm_kernel) and lstm_layer_pallas (_lstm_kernel). Same function, over
// precomputed xw = x @ wx + b ([T, B, 4H] per direction, gate order i, g, f,
// o; forget bias +1):
//   gates = xw[t] + h @ wh;  c' = sig(f + 1) * c + sig(i) * tanh(g)
//   h' = sig(o) * tanh(c')
// Each row is active on a window start <= t < start + len. The fused layer's
// forward rows start at 0; its backward rows, which read the time-FLIPPED
// sequence, at start = T - len. A single direction takes an optional starts
// array (none: every row starts at 0). Outside its window a row's state is
// frozen and its output is zero.
//
// What bounds it on an H100: per step a direction does a [B, H] x [H, 4H]
// product (~42 GFLOP per layer at B = T = 400, H = 128), but the T steps
// are sequential, so the kernel is bound by per-step latency and by
// re-reading wh, not by the card's peak rate. One direction's wh is
// 128 x 512 float32 = 256 KB, more than the 227 KB of shared memory a block
// may use, so it cannot sit in one block's shared memory. The simple
// design here: one block per (direction, tile of R batch rows), one thread
// per gate column (4H threads); the tile's h lives in shared memory and
// each thread streams its wh column from L2 (both directions' wh, 512 KB,
// stay resident in the 50 MB L2) once per step for all R rows, then the
// block does the elementwise c/h update and the mask. Splitting wh between
// registers and shared memory in a persistent block per SM is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 8;  // batch rows per block

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void bilstm_kernel(const float* __restrict__ xw_f, const float* __restrict__ xw_b,
                              const float* __restrict__ wh_f, const float* __restrict__ wh_b,
                              const int* __restrict__ lens, const int* __restrict__ starts_f,
                              const int* __restrict__ starts_b, float* __restrict__ out_f, float* __restrict__ out_b, int T, int B,
                              int H) {
  extern __shared__ float smem[];
  float* h_s = smem;              // [R][H]
  float* c_s = h_s + R * H;       // [R][H]
  float* g_s = c_s + R * H;       // [R][4H]

  const int dir = blockIdx.y;  // 0 forward, 1 backward (flipped input)
  const float* xw = dir == 0 ? xw_f : xw_b;
  const float* wh = dir == 0 ? wh_f : wh_b;
  const int* starts = dir == 0 ? starts_f : starts_b;  // null: every row starts at 0
  float* out = dir == 0 ? out_f : out_b;
  const int b0 = blockIdx.x * R;
  const int G = 4 * H;
  const int col = threadIdx.x;

  for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
    h_s[i] = 0.f;
    c_s[i] = 0.f;
  }
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
    // gate pre-activations for the tile's rows: xw[t] + h @ wh (column col)
    if (col < G) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        acc[r] = b < B ? xw[((size_t)t * B + b) * G + col] : 0.f;
      }
      for (int k = 0; k < H; ++k) {
        const float wv = wh[(size_t)k * G + col];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(h_s[r * H + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) g_s[r * G + col] = acc[r];
    }
    __syncthreads();
    // elementwise cell update + active-window mask
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      const int r = idx / H;
      const int j = idx - r * H;
      const int b = b0 + r;
      if (b >= B) continue;
      const float* g = g_s + r * G;
      const bool active = t >= lo[r] && t < hi[r];
      float hv = 0.f;
      if (active) {
        const float nc = sigm(g[2 * H + j] + 1.f) * c_s[idx] + sigm(g[j]) * tanhf(g[H + j]);
        hv = sigm(g[3 * H + j]) * tanhf(nc);
        c_s[idx] = nc;
        h_s[idx] = hv;
      }
      out[((size_t)t * B + b) * H + j] = hv;
    }
    __syncthreads();
  }
}

int launch(int dirs, const float* xw_f, const float* xw_b, const float* wh_f, const float* wh_b,
           const int* lens, const int* starts_f, const int* starts_b, float* out_f, float* out_b,
           int T, int B, int H, void* stream) {
  const int threads = ((4 * H + 31) / 32) * 32;
  const size_t smem = (size_t)R * 6 * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(bilstm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + R - 1) / R, dirs);
  bilstm_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      xw_f, xw_b, wh_f, wh_b, lens, starts_f, starts_b, out_f, out_b, T, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xw_*: [T, B, 4H] float32, wh_*: [H, 4H], lens/starts: [B] int32,
// out_*: [T, B, H]. H <= 256.
int bilstm_launch(const float* xw_f, const float* xw_b, const float* wh_f, const float* wh_b,
                  const int* lens, const int* starts, float* out_f, float* out_b, int T, int B,
                  int H, void* stream) {
  return launch(2, xw_f, xw_b, wh_f, wh_b, lens, nullptr, starts, out_f, out_b, T, B, H, stream);
}

// One direction; starts may be null (every row's window is [0, len)).
int lstm_launch(const float* xw, const float* wh, const int* lens, const int* starts, float* out,
                int T, int B, int H, void* stream) {
  return launch(1, xw, nullptr, wh, nullptr, lens, starts, nullptr, out, nullptr, T, B, H, stream);
}

}  // extern "C"
