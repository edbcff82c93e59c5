// One recurrent-batch-norm LSTM layer (arxiv 1603.09025), the whole T-step
// recurrence in one cooperative launch: both directions (bibnlstm_launch) or
// one (bnlstm_launch), through the same kernels.
//
// Replaces the TPU kernels chiron_tpu/ops/pallas/bnlstm.py:bnlstm_layer_pallas
// (_bnlstm_kernel) and bibnlstm_layer_pallas (_bibnlstm_kernel). Same
// function, over the raw input projection xw = x @ wx WITHOUT bias
// ([T, B, 4H], gate order i, g, f, o; forget bias +1). With BN(v) = (v - mean)
// * rsqrt(var + 1e-5) * scale, mean and var taken per column over the rows
// that are active at step t (len > t; the count is at least 1):
//   gates = BN_x(xw[t]) + BN_h(h @ wh) + b
//   c' = sig(f + 1) * c + sig(i) * tanh(g)
//   h' = sig(o) * tanh(BN_c(c') + offset_c)
// A row past its length keeps its state and puts out zero. Both directions
// mask on t < len (the caller reverses the backward input within each
// length): there is no start offset, because the moments must cover exactly
// the rows that are active at a step.
//
// What bounds it on an H100: the products are the LSTM's (~42 GFLOP per
// two-direction layer at B = T = 400, H = 128), but each step's three
// normalisations couple every row of the batch, so a step cannot finish in
// one block: the kernel is bound by the latency of T sequential steps with
// two grid-wide exchanges each. The design:
//  - BN_x's moments do not depend on the state: a pre-pass kernel takes them
//    for all T steps at once (one thread per (t, column), rows in order).
//  - The recurrence is bilstm.cu's tiling (one block per direction and tile
//    of batch rows, one thread per gate column, the tile's h and c in shared
//    memory, wh streamed from L2), launched cooperatively so that all blocks
//    are resident, with a barrier on a global counter per direction. Per step
//    each block writes its tile's (count, mean, M2) of h @ wh per column, all
//    blocks meet, and every block combines all tiles' partials in tile order
//    (Chan's pairwise update); the same again for c'. Two barriers a step, no
//    float atomics, the same bits on every run.
//  - A tile is a multiple of 8 rows, worked in register sub-tiles of 8. When
//    the grid of 8-row tiles cannot be co-resident the launcher returns
//    cudaErrorCooperativeLaunchTooLarge and the caller asks for larger tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 8;  // rows per register sub-tile
constexpr int MAX_H = 512;  // 4H gate columns over at most 1024 threads, two a thread
constexpr float BN_EPS = 1e-5f;

struct Dir {
  const float* xw;        // [T, B, 4H]
  const float* wh;        // [H, 4H]
  const float* b;         // [4H]
  const float* scale_x;   // [4H]
  const float* scale_h;   // [4H]
  const float* scale_c;   // [H]
  const float* offset_c;  // [H]
  float* out;             // [T, B, H]
};

struct Args {
  Dir d[2];
  const int* lens;  // [B]
  float* xmom;      // [dirs][T][4H][2]   mean and rsqrt(var + eps) of xw[t]
  float* part_h;    // [dirs][tiles][4H][2]  per-tile mean and M2 of h @ wh
  float* part_c;    // [dirs][tiles][H][2]   per-tile mean and M2 of c'
  float* cnt_h;     // [dirs][tiles]  per-tile active rows, written with part_h
  float* cnt_c;     // [dirs][tiles]  the same, written with part_c
  unsigned* bar;    // [dirs] barrier counters, zero at launch
  int T, B, H, rows;
};

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// Moments of xw[t] per column over the rows with len > t, two passes in row
// order (the same form as the TPU kernel's _bn_step).
__global__ void bnlstm_xmoments_kernel(Args a) {
  const int G = 4 * a.H;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  const int dir = blockIdx.z;
  if (col >= G) return;
  const float* x = a.d[dir].xw + (size_t)t * a.B * G + col;
  float sum = 0.f, n = 0.f;
  for (int b = 0; b < a.B; ++b) {
    if (a.lens[b] > t) {
      sum += x[(size_t)b * G];
      n += 1.f;
    }
  }
  const float cnt = fmaxf(n, 1.f);
  const float mean = sum / cnt;
  float m2 = 0.f;
  for (int b = 0; b < a.B; ++b) {
    if (a.lens[b] > t) {
      const float dlt = x[(size_t)b * G] - mean;
      m2 = fmaf(dlt, dlt, m2);
    }
  }
  float* o = a.xmom + (((size_t)dir * a.T + t) * G + col) * 2;
  o[0] = mean;
  o[1] = rsqrtf(m2 / cnt + BN_EPS);
}

// All blocks of one direction meet: the counter only grows, and the k-th
// meeting is over when it reaches k * blocks. Needs every block resident
// (a cooperative launch).
__device__ __forceinline__ void direction_barrier(unsigned* counter, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*((volatile unsigned*)counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// A tile's mean and M2 of column values v[r * stride] over its active rows.
__device__ __forceinline__ void tile_moments(const float* v, int stride, const int* len_s,
                                             int rows, int t, float sum, int n, float* part) {
  const float mean = n > 0 ? sum / (float)n : 0.f;
  float m2 = 0.f;
  for (int r = 0; r < rows; ++r) {
    if (len_s[r] > t) {
      const float dlt = v[r * stride] - mean;
      m2 = fmaf(dlt, dlt, m2);
    }
  }
  __stcg(part, mean);
  __stcg(part + 1, m2);
}

// Combine every tile's (count, mean, M2) in tile order into the batch's mean
// and rsqrt(var + eps); part and cnt were written by other blocks before the
// barrier, so they are read past L1.
__device__ __forceinline__ void combine(const float* part, int stride, const float* cnt,
                                        int tiles, float* mean_out, float* inv_out) {
  float n = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll 4
  for (int k = 0; k < tiles; ++k) {
    const float nb = __ldcg(cnt + k);
    const float mb = __ldcg(part + (size_t)k * stride);
    const float m2b = __ldcg(part + (size_t)k * stride + 1);
    const float tot = n + nb;
    const float w = nb > 0.f ? nb / tot : 0.f;
    const float dlt = mb - mean;
    mean = fmaf(dlt, w, mean);
    m2 += m2b + dlt * dlt * n * w;
    n = tot;
  }
  *mean_out = mean;
  *inv_out = rsqrtf(m2 / fmaxf(n, 1.f) + BN_EPS);
}

// THREADS bounds the block (4H rounded up to a warp): 512 covers H <= 128,
// 1024 the rest, so that the registers of one block always fit an SM; one
// block per SM is all the cooperative grid asks for, which leaves the
// compiler the registers to unroll the product loop. Above 4H = 1024 each
// thread walks COLS gate columns, col = threadIdx.x + j * THREADS (COLS = 2
// covers H <= 512); every column's arithmetic is the same whatever COLS.
template <int THREADS, int COLS>
__global__ void __launch_bounds__(THREADS, 1) bnlstm_kernel(Args a) {
  extern __shared__ float smem[];
  const int H = a.H, G = 4 * a.H, rows = a.rows, B = a.B, T = a.T;
  float* h_s = smem;                    // [rows][H]
  float* c_s = h_s + rows * H;          // [rows][H]
  float* g_s = c_s + rows * H;          // [rows][4H]
  int* len_s = (int*)(g_s + rows * G);  // [rows]

  const int dir = blockIdx.y;
  const Dir d = a.d[dir];
  const int tiles = gridDim.x, tile = blockIdx.x;
  const int b0 = tile * rows;
  float* part_h = a.part_h + (size_t)dir * tiles * G * 2;
  float* part_c = a.part_c + (size_t)dir * tiles * H * 2;
  float* cnt_h = a.cnt_h + dir * tiles;
  float* cnt_c = a.cnt_c + dir * tiles;
  unsigned* bar = a.bar + dir;
  unsigned meetings = 0;

  for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
    h_s[i] = 0.f;
    c_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    len_s[r] = b0 + r < B ? a.lens[b0 + r] : 0;
  float sx[COLS], sh[COLS], bias[COLS], sc[COLS], oc[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int col = threadIdx.x + j * THREADS;
    sx[j] = sh[j] = bias[j] = sc[j] = oc[j] = 0.f;
    if (col < G) {
      sx[j] = d.scale_x[col];
      sh[j] = d.scale_h[col];
      bias[j] = d.b[col];
    }
    if (col < H) {
      sc[j] = d.scale_c[col];
      oc[j] = d.offset_c[col];
    }
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // 1. hw = h @ wh for the tile's rows (column col), and the tile's moments
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int col = threadIdx.x + j * THREADS;
      if (col >= G) continue;
      float sum = 0.f;
      int n = 0;
      for (int r0 = 0; r0 < rows; r0 += R) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
        for (int k = 0; k < H; ++k) {
          const float wv = d.wh[(size_t)k * G + col];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(h_s[(r0 + r) * H + k], wv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          g_s[(r0 + r) * G + col] = acc[r];
          if (len_s[r0 + r] > t) {
            sum += acc[r];
            ++n;
          }
        }
      }
      tile_moments(g_s + col, G, len_s, rows, t, sum, n, part_h + ((size_t)tile * G + col) * 2);
      if (col == 0) __stcg(cnt_h + tile, (float)n);
    }
    direction_barrier(bar, ++meetings * tiles);
    // 2. gates = BN_x(xw[t]) + BN_h(hw) + b, left in g_s
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int col = threadIdx.x + j * THREADS;
      if (col >= G) continue;
      float mean, inv;
      combine(part_h + col * 2, G * 2, cnt_h, tiles, &mean, &inv);
      const float* xm = a.xmom + (((size_t)dir * T + t) * G + col) * 2;
      const float mx = xm[0], ix = xm[1];
      for (int r = 0; r < rows; ++r) {
        const int b = b0 + r;
        if (b >= B) break;
        const float x = d.xw[((size_t)t * B + b) * G + col];
        g_s[r * G + col] = (x - mx) * ix * sx[j] + (g_s[r * G + col] - mean) * inv * sh[j] + bias[j];
      }
    }
    __syncthreads();
    // 3. c' per hidden column (kept in the g gate's slot), and its tile moments
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int col = threadIdx.x + j * THREADS;
      if (col >= H) continue;
      float sum = 0.f;
      int n = 0;
      for (int r = 0; r < rows; ++r) {
        float* g = g_s + r * G;
        const float nc = sigm(g[2 * H + col] + 1.f) * c_s[r * H + col]
                         + sigm(g[col]) * tanhf(g[H + col]);
        g[H + col] = nc;
        if (len_s[r] > t) {
          sum += nc;
          ++n;
        }
      }
      tile_moments(g_s + H + col, G, len_s, rows, t, sum, n,
                   part_c + ((size_t)tile * H + col) * 2);
      if (col == 0) __stcg(cnt_c + tile, (float)n);
    }
    direction_barrier(bar, ++meetings * tiles);
    // 4. h' = sig(o) * tanh(BN_c(c') + offset_c), the state update and the mask
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int col = threadIdx.x + j * THREADS;
      if (col >= H) continue;
      float mean, inv;
      combine(part_c + col * 2, H * 2, cnt_c, tiles, &mean, &inv);
      for (int r = 0; r < rows; ++r) {
        const int b = b0 + r;
        if (b >= B) break;
        const float* g = g_s + r * G;
        float hv = 0.f;
        if (len_s[r] > t) {
          const float nc = g[H + col];
          hv = sigm(g[3 * H + col]) * tanhf((nc - mean) * inv * sc[j] + oc[j]);
          c_s[r * H + col] = nc;
          h_s[r * H + col] = hv;
        }
        d.out[((size_t)t * B + b) * H + col] = hv;
      }
    }
    __syncthreads();
  }
}

// vec_*: one direction's b | scale_x | scale_h (4H each) | scale_c | offset_c
// (H each), 14H floats. scratch: dirs * (T * 8H + tiles * (10H + 2)) floats.
int launch(int dirs, const float* xw_f, const float* xw_b, const float* wh_f, const float* wh_b,
           const float* vec_f, const float* vec_b, const int* lens, float* out_f, float* out_b,
           float* scratch, unsigned* bar, int T, int B, int H, int rows, void* stream) {
  const int G = 4 * H;
  const int tiles = (B + rows - 1) / rows;
  if (H < 1 || H > MAX_H) return (int)cudaErrorInvalidValue;
  const int threads = min(((G + 31) / 32) * 32, 1024);
  const size_t smem = (size_t)rows * (6 * H + 1) * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;

  Args a;
  const float* xw[2] = {xw_f, xw_b};
  const float* wh[2] = {wh_f, wh_b};
  const float* vec[2] = {vec_f, vec_b};
  float* out[2] = {out_f, out_b};
  for (int i = 0; i < 2; ++i) {
    a.d[i] = Dir{xw[i], wh[i], vec[i], vec[i] + G, vec[i] + 2 * G, vec[i] + 3 * G,
                 vec[i] + 3 * G + H, out[i]};
  }
  a.lens = lens;
  a.xmom = scratch;
  a.part_h = a.xmom + (size_t)dirs * T * G * 2;
  a.part_c = a.part_h + (size_t)dirs * tiles * G * 2;
  a.cnt_h = a.part_c + (size_t)dirs * tiles * H * 2;
  a.cnt_c = a.cnt_h + (size_t)dirs * tiles;
  a.bar = bar;
  a.T = T;
  a.B = B;
  a.H = H;
  a.rows = rows;

  int dev = 0, coop = 0, sms = 0, smem_max = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  if (smem > (size_t)smem_max) return (int)cudaErrorCooperativeLaunchTooLarge;
  const void* kernel = threads <= 512 ? (const void*)bnlstm_kernel<512, 1>
                       : G <= 1024    ? (const void*)bnlstm_kernel<1024, 1>
                                      : (const void*)bnlstm_kernel<1024, 2>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // every block must be resident at once, or the barrier never completes
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)per_sm * sms < (long long)tiles * dirs)
    return (int)cudaErrorCooperativeLaunchTooLarge;

  bnlstm_xmoments_kernel<<<dim3((G + 127) / 128, T, dirs), 128, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(tiles, dirs), dim3(threads), params,
                                          smem, s);
}

}  // namespace

extern "C" {

// xw_*: [T, B, 4H] float32 (no bias), wh_*: [H, 4H], vec_*: [14H] (see
// launch), lens: [B] int32, out_*: [T, B, H], scratch: floats (see launch),
// bar: 2 zeroed uint32. rows: batch rows per block, a multiple of 8. H <= 512.
// Returns cudaErrorCooperativeLaunchTooLarge (720), with nothing launched,
// when the grid for this `rows` cannot be co-resident.
int bibnlstm_launch(const float* xw_f, const float* xw_b, const float* wh_f, const float* wh_b,
                    const float* vec_f, const float* vec_b, const int* lens, float* out_f,
                    float* out_b, float* scratch, unsigned* bar, int T, int B, int H, int rows,
                    void* stream) {
  return launch(2, xw_f, xw_b, wh_f, wh_b, vec_f, vec_b, lens, out_f, out_b, scratch, bar, T, B,
                H, rows, stream);
}

int bnlstm_launch(const float* xw, const float* wh, const float* vec, const int* lens, float* out,
                  float* scratch, unsigned* bar, int T, int B, int H, int rows, void* stream) {
  return launch(1, xw, xw, wh, wh, vec, vec, lens, out, out, scratch, bar, T, B, H, rows, stream);
}

}  // extern "C"
