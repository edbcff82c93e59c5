// Fused prologue-affine + 1-D convolution + per-channel output moments.
//
// Replaces the TPU kernel chiron_tpu/ops/pallas/convbn.py:conv_bn_pallas
// (_conv_bn_kernel). Same function:
//   x = relu?(sum_i raw_i * a_i + b_i)           (one or two terms)
//   x is zero-padded AFTER the prologue (XLA SAME arithmetic, any stride)
//   y[b, t, n] = sum_{tap, c} x[b, t*s - lpad + tap, c] * w[tap, c, n]
//   sums[n] = sum_{b,t} y,  sqs[n] = sum_{b,t} y^2
//
// What bounds it on an H100: at dna_model1's shapes ([400, 400, 256],
// 256 -> 256 channels) a k=3 conv is ~63 GFLOP against ~0.5 GB of traffic,
// so it is bound by operations (float32, 67 TFLOP/s outside the tensor
// cores; the float32 result must stay float32 for parity with the JAX
// reference, so no TF32). The design is a plain shared-memory implicit GEMM
// on the CUDA cores: a block owns a 64-row x 64-channel output tile of one
// batch row, walks (tap, 16-channel slice) steps, applies the prologue
// while staging its input slice in shared memory, and each thread keeps a
// 4x4 accumulator tile in registers. Tensor-core (3xTF32 or wgmma) variants
// are later work.
//
// Moments: the TPU kernel carried its sums in scratch across sequential
// grid steps. CUDA blocks run in no order, so each block writes its tile's
// per-channel partial sums to a scratch buffer and a second kernel reduces
// the partials in a fixed order (float64 accumulation) -- the result is
// the same from run to run, with no float atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output time rows per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // input channels per staging step
constexpr int NT = 256;  // threads per block (16 x 16, 4x4 outputs each)

__global__ void __launch_bounds__(NT)
conv_bn_tile_kernel(const float* __restrict__ raw0, const float* __restrict__ raw1,
                    const float* __restrict__ a0, const float* __restrict__ b0,
                    const float* __restrict__ a1, const float* __restrict__ b1,
                    const float* __restrict__ w, float* __restrict__ y,
                    float* __restrict__ partial, int T, int cin, int cout, int k,
                    int stride, int lpad, int out_t, int relu_in) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN];
  __shared__ float red_s[16][BN];
  __shared__ float red_q[16][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group
  const int t0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const size_t in_base = (size_t)b * T * cin;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < k; ++tap) {
    for (int c0 = 0; c0 < cin; c0 += BK) {
      // stage the prologue-normalised input slice: BM rows x BK channels
#pragma unroll
      for (int q = 0; q < (BM * BK) / NT; ++q) {
        const int l = tid + q * NT;
        const int kk = l % BK;
        const int m = l / BK;
        const int c = c0 + kk;
        const int to = t0 + m;
        const int tin = to * stride - lpad + tap;
        float v = 0.f;
        if (c < cin && to < out_t && tin >= 0 && tin < T) {
          const size_t off = in_base + (size_t)tin * cin + c;
          v = raw0[off] * a0[c] + b0[c];
          if (raw1 != nullptr) v += raw1[off] * a1[c] + b1[c];
          if (relu_in) v = fmaxf(v, 0.f);
        }
        As[kk][m] = v;
      }
      // stage the weight slice: BK channels x BN outputs
#pragma unroll
      for (int q = 0; q < (BK * BN) / NT; ++q) {
        const int l = tid + q * NT;
        const int n = l % BN;
        const int kk = l / BN;
        const int c = c0 + kk;
        float v = 0.f;
        if (c < cin && n0 + n < cout) v = w[((size_t)tap * cin + c) * cout + n0 + n];
        Bs[kk][n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: raw output + this tile's per-channel partial moments.
  // Rows past out_t hold exact zeros (their staged input was zero), so they
  // add nothing to the moments and are simply not stored.
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int to = t0 + ty + 16 * i;
      const float v = acc[i][j];
      if (to < out_t && n < cout) y[((size_t)b * out_t + to) * cout + n] = v;
      s += v;
      sq += v * v;
    }
    red_s[ty][tx + 16 * j] = s;
    red_q[ty][tx + 16 * j] = sq;
  }
  __syncthreads();
  const size_t tile = (size_t)b * gridDim.x + blockIdx.x;
  const size_t n_tiles = (size_t)gridDim.x * gridDim.z;
  if (tid < BN) {
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += red_s[r][tid];
    if (n0 + tid < cout) partial[tile * cout + n0 + tid] = s;
  } else if (tid < 2 * BN) {
    const int col = tid - BN;
    float sq = 0.f;
    for (int r = 0; r < 16; ++r) sq += red_q[r][col];
    if (n0 + col < cout) partial[(n_tiles + tile) * cout + n0 + col] = sq;
  }
}

// Second pass: fixed-order reduction of the per-tile partial moments.
// Block (32 channels x 32 tile lanes): lane ty sums tiles ty, ty+32, ... of
// channel n in float64 (reads coalesced across channels), then lane 0 adds
// the 32 lane sums in order -- the same result on every run.
constexpr int RED_C = 32;
constexpr int RED_T = 32;

__global__ void __launch_bounds__(RED_C * RED_T)
moments_reduce_kernel(const float* __restrict__ partial, float* __restrict__ sums,
                      float* __restrict__ sqs, int n_tiles, int cout) {
  __shared__ double red_s[RED_T][RED_C];
  __shared__ double red_q[RED_T][RED_C];
  const int n = blockIdx.x * RED_C + threadIdx.x;
  double s = 0.0, q = 0.0;
  if (n < cout) {
    for (int t = threadIdx.y; t < n_tiles; t += RED_T) {
      s += (double)partial[(size_t)t * cout + n];
      q += (double)partial[((size_t)n_tiles + t) * cout + n];
    }
  }
  red_s[threadIdx.y][threadIdx.x] = s;
  red_q[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && n < cout) {
    for (int r = 1; r < RED_T; ++r) {
      s += red_s[r][threadIdx.x];
      q += red_q[r][threadIdx.x];
    }
    sums[n] = (float)s;
    sqs[n] = (float)q;
  }
}

}  // namespace

extern "C" {

// Number of row tiles (partial-moment rows) the scratch buffer must hold
// per moment: batch * ceil(out_t / 64).
int conv_bn_row_tiles(int batch, int out_t) { return batch * ((out_t + BM - 1) / BM); }

// raw1/a1/b1 may be null (one term). partial: [2, row_tiles, cout] float32.
int conv_bn_launch(const float* raw0, const float* raw1, const float* a0, const float* b0,
                   const float* a1, const float* b1, const float* w, float* y,
                   float* partial, float* sums, float* sqs, int batch, int T, int cin,
                   int cout, int k, int stride, int lpad, int out_t, int relu_in,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((out_t + BM - 1) / BM, (cout + BN - 1) / BN, batch);
  conv_bn_tile_kernel<<<grid, NT, 0, st>>>(raw0, raw1, a0, b0, a1, b1, w, y, partial, T, cin,
                                           cout, k, stride, lpad, out_t, relu_in);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = conv_bn_row_tiles(batch, out_t);
  moments_reduce_kernel<<<(cout + RED_C - 1) / RED_C, dim3(RED_C, RED_T), 0, st>>>(
      partial, sums, sqs, n_tiles, cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
