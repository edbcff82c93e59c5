// One LSTM direction for training: forward with residuals, and its reverse-time BPTT.
//
// Replaces the TPU kernels chiron_tpu/ops/pallas/lstm_grad.py:_forward_with_residuals
// (_fwd_kernel) and chiron_tpu/ops/pallas/lstm_grad.py:_bwd_rule (_bwd_kernel).
// Over precomputed xw = x @ wx + b ([T, B, 4H], gate order i, g, f, o; forget bias +1),
// a row is active at step t when t < len[b]; outside it the state is frozen and the
// output is zero.
//
//   forward  (lstm_fwd_kernel):  gates = act(xw[t] + h @ wh);  c' = f * c + i * g;
//            h' = o * tanh(c');  writes out, the activated gates, and the carried c / h.
//   backward (lstm_bwd_kernel):  per step in reverse time, the gate gradients
//            da = [di, dg, df, do] (written as dxw) and dh_{t-1} = da @ wh^T; masked
//            steps pass dh and dc through untouched and dhs does not flow into them.
//            dwh = sum_t h_{t-1}^T da_t is a second pass over hc and dxw
//            (lstm_dwh_partial_kernel + lstm_dwh_reduce_kernel).
//
// What bounds it on an H100: the recurrences are T sequential steps, each a
// [B, H] x [H, 4H] product (forward) or [B, 4H] x [4H, H] product (backward) that
// is far too small to fill the card, so each kernel is bound by per-step latency:
// re-reading the recurrent matrix and two or three block barriers per step, not by
// the card's peak rate. One direction's wh is 128 x 512 float32 = 256 KB, more than
// the 227 KB of shared memory a block may use. As in bilstm.cu, one block owns a
// tile of R batch rows for the whole recurrence; its h (or da) lives in shared
// memory, and each thread streams one column of wh (forward) or of wh^T (backward,
// the wrapper passes wh^T so that the reads stay coalesced) from L2 once per step
// for all R rows. In the backward the 4H-long dots are split four ways over all 4H
// threads and the four partial sums are added in a fixed order.
//
// dwh is the one large product here ([H, T*B] x [T*B, 4H], ~15.7 GFLOP at
// T = 400, B = 300, H = 128): a tiled SIMT GEMM splits the T*B rows into `splits`
// fixed ranges, each block writes its tile's partial sum, and a second kernel adds
// the partials in order. No float atomics, so the same inputs give the same bits
// on every run. Tensor cores (3xTF32 wgmma) and a persistent recurrence that keeps
// wh split between registers and shared memory are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 8;  // batch rows per block of the recurrent kernels

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(1024)
    lstm_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                    const int* __restrict__ lens, float* __restrict__ out,
                    float* __restrict__ gates, float* __restrict__ cc, float* __restrict__ hc,
                    int T, int B, int H) {
  extern __shared__ float smem[];
  float* h_s = smem;          // [R][H]
  float* c_s = h_s + R * H;   // [R][H]
  float* g_s = c_s + R * H;   // [R][4H] gate pre-activations

  const int b0 = blockIdx.x * R;
  const int G = 4 * H;
  const int col = threadIdx.x;

  for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
    h_s[i] = 0.f;
    c_s[i] = 0.f;
  }
  int len[R];
#pragma unroll
  for (int r = 0; r < R; ++r) len[r] = b0 + r < B ? lens[b0 + r] : 0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
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
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      const int r = idx / H;
      const int j = idx - r * H;
      const int b = b0 + r;
      if (b >= B) continue;
      const float* g = g_s + r * G;
      const float ig = sigm(g[j]);
      const float gg = tanhf(g[H + j]);
      const float fg = sigm(g[2 * H + j] + 1.f);
      const float og = sigm(g[3 * H + j]);
      const float nc = fg * c_s[idx] + ig * gg;
      const float nh = og * tanhf(nc);
      const bool active = t < len[r];
      if (active) {
        c_s[idx] = nc;
        h_s[idx] = nh;
      }
      const size_t row = (size_t)t * B + b;
      float* gr = gates + row * G;
      gr[j] = ig;
      gr[H + j] = gg;
      gr[2 * H + j] = fg;
      gr[3 * H + j] = og;
      out[row * H + j] = active ? nh : 0.f;
      cc[row * H + j] = c_s[idx];
      hc[row * H + j] = h_s[idx];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024)
    lstm_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cc,
                    const float* __restrict__ dhs, const float* __restrict__ wh_t,
                    const int* __restrict__ lens, float* __restrict__ dxw, int T, int B,
                    int H) {
  extern __shared__ float smem[];
  float* dh_s = smem;              // [R][H] carried dh
  float* dc_s = dh_s + R * H;      // [R][H] carried dc
  float* da_s = dc_s + R * H;      // [R][4H] this step's gate gradients
  float* part_s = da_s + R * 4 * H;  // [4][R][H] partial sums of da @ wh^T

  const int b0 = blockIdx.x * R;
  const int G = 4 * H;
  const int tid = threadIdx.x;

  for (int i = tid; i < R * H; i += blockDim.x) {
    dh_s[i] = 0.f;
    dc_s[i] = 0.f;
  }
  int len[R];
#pragma unroll
  for (int r = 0; r < R; ++r) len[r] = b0 + r < B ? lens[b0 + r] : 0;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // gate gradients of the tile's rows (zero for masked and padding rows)
    for (int idx = tid; idx < R * H; idx += blockDim.x) {
      const int r = idx / H;
      const int j = idx - r * H;
      const int b = b0 + r;
      float* da = da_s + r * G;
      if (b >= B || t >= len[r]) {
        da[j] = da[H + j] = da[2 * H + j] = da[3 * H + j] = 0.f;
        if (b < B) {
          float* dr = dxw + ((size_t)t * B + b) * G;
          dr[j] = dr[H + j] = dr[2 * H + j] = dr[3 * H + j] = 0.f;
        }
        continue;
      }
      const size_t row = (size_t)t * B + b;
      const float* gr = gates + row * G;
      const float ig = gr[j], gg = gr[H + j], fg = gr[2 * H + j], og = gr[3 * H + j];
      const float c_t = cc[row * H + j];
      const float c_prev = t > 0 ? cc[(row - B) * H + j] : 0.f;
      const float tc = tanhf(c_t);
      const float dh_new = dhs[row * H + j] + dh_s[idx];
      const float dc_new = dc_s[idx] + dh_new * og * (1.f - tc * tc);
      const float d_o = dh_new * tc * og * (1.f - og);
      const float d_f = dc_new * c_prev * fg * (1.f - fg);
      const float d_i = dc_new * gg * ig * (1.f - ig);
      const float d_g = dc_new * ig * (1.f - gg * gg);
      da[j] = d_i;
      da[H + j] = d_g;
      da[2 * H + j] = d_f;
      da[3 * H + j] = d_o;
      float* dr = dxw + row * G;
      dr[j] = d_i;
      dr[H + j] = d_g;
      dr[2 * H + j] = d_f;
      dr[3 * H + j] = d_o;
      dc_s[idx] = dc_new * fg;
    }
    __syncthreads();
    // partial dots: thread (q, j) sums da[:, qH:(q+1)H] * wh^T[qH:(q+1)H, j]
    if (tid < G) {
      const int q = tid / H;
      const int j = tid - q * H;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      for (int c = q * H; c < (q + 1) * H; ++c) {
        const float wv = wh_t[(size_t)c * H + j];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(da_s[r * G + c], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) part_s[(q * R + r) * H + j] = acc[r];
    }
    __syncthreads();
    // dh_{t-1} for active rows, in a fixed order; masked rows keep their dh
    for (int idx = tid; idx < R * H; idx += blockDim.x) {
      const int r = idx / H;
      const int j = idx - r * H;
      if (b0 + r >= B || t >= len[r]) continue;
      dh_s[idx] = ((part_s[(0 * R + r) * H + j] + part_s[(1 * R + r) * H + j]) +
                   part_s[(2 * R + r) * H + j]) +
                  part_s[(3 * R + r) * H + j];
    }
    __syncthreads();
  }
}

// dwh partials: block (x, y, z) owns dwh[y*64 : +64, x*64 : +64] over the rows
// n in [z * chunk, (z + 1) * chunk) of the flattened [T*B] axis, where
// h_prev[n] = hc[n - B] (zero for the first B rows, time 0). 256 threads, each
// 4 x 4 outputs; 16 rows of h_prev and dxw staged in shared memory at a time.
constexpr int TILE = 64, TR = 16;

__global__ void __launch_bounds__(256)
    lstm_dwh_partial_kernel(const float* __restrict__ hc, const float* __restrict__ dxw,
                            float* __restrict__ part, int n_rows, int chunk, int B, int H) {
  __shared__ float a_s[TR][TILE];  // h_prev rows, k
  __shared__ float b_s[TR][TILE];  // dxw rows, c
  const int G = 4 * H;
  const int k0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE;
  const int n_begin = blockIdx.z * chunk;
  const int n_end = min(n_begin + chunk, n_rows);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += TR) {
    for (int e = threadIdx.x; e < TR * TILE; e += blockDim.x) {
      const int rr = e / TILE, cc = e - rr * TILE;
      const int n = n0 + rr;
      const int k = k0 + cc, c = c0 + cc;
      a_s[rr][cc] = (n < n_end && n >= B && k < H) ? hc[(size_t)(n - B) * H + k] : 0.f;
      b_s[rr][cc] = (n < n_end && c < G) ? dxw[(size_t)n * G + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < TR; ++rr) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[rr][ty * 4 + i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) bv[jj] = b_s[rr][tx * 4 + jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }
  float* dst = part + (size_t)blockIdx.z * H * G;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= H) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = c0 + tx * 4 + jj;
      if (c < G) dst[(size_t)k * G + c] = acc[i][jj];
    }
  }
}

__global__ void lstm_dwh_reduce_kernel(const float* __restrict__ part, float* __restrict__ dwh,
                                       int splits, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];
  dwh[i] = s;
}

int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" {

// xw: [T, B, 4H] float32, wh: [H, 4H], lens: [B] int32; out, cc, hc: [T, B, H],
// gates: [T, B, 4H]. 1 <= H <= 256, T, B >= 1.
int lstm_fwd_launch(const float* xw, const float* wh, const int* lens, float* out, float* gates,
                    float* cc, float* hc, int T, int B, int H, void* stream) {
  const int threads = ((4 * H + 31) / 32) * 32;
  const size_t smem = (size_t)R * 6 * H * sizeof(float);
  int err = set_smem((const void*)lstm_fwd_kernel, smem);
  if (err) return err;
  lstm_fwd_kernel<<<(B + R - 1) / R, threads, smem, (cudaStream_t)stream>>>(
      xw, wh, lens, out, gates, cc, hc, T, B, H);
  return (int)cudaGetLastError();
}

// gates: [T, B, 4H], cc, hc, dhs: [T, B, H], wh_t: [4H, H] (wh transposed),
// lens: [B] int32; dxw: [T, B, 4H], dwh: [H, 4H]; part: scratch [splits, H, 4H].
int lstm_bwd_launch(const float* gates, const float* cc, const float* hc, const float* dhs,
                    const float* wh_t, const int* lens, float* dxw, float* dwh, float* part,
                    int splits, int T, int B, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int G = 4 * H;
  const int threads = ((G + 31) / 32) * 32;
  const size_t smem = (size_t)R * 10 * H * sizeof(float);
  int err = set_smem((const void*)lstm_bwd_kernel, smem);
  if (err) return err;
  lstm_bwd_kernel<<<(B + R - 1) / R, threads, smem, s>>>(gates, cc, dhs, wh_t, lens, dxw, T,
                                                          B, H);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int n_rows = T * B;
  const int chunk = (n_rows + splits - 1) / splits;
  dim3 grid((G + TILE - 1) / TILE, (H + TILE - 1) / TILE, splits);
  lstm_dwh_partial_kernel<<<grid, 256, 0, s>>>(hc, dxw, part, n_rows, chunk, B, H);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int n = H * G;
  lstm_dwh_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, dwh, splits, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
