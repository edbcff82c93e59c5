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
// is far too small to fill the card, so each kernel is bound by per-step latency,
// not by the card's peak rate; by bytes the forward's floor is the residuals it
// writes. One direction's wh is 128 x 512 float32 = 256 KB, more than the 227 KB of
// shared memory a block may use.
//
// The forward keeps wh on chip all the same: a thread-block CLUSTER owns a tile of
// R = 8 batch rows, and block j of the cluster holds the columns of the hidden units
// [j * HS, (j + 1) * HS) of all four gates, [H, 4 * HS] float32, in its shared memory,
// loaded once per launch (H = 128: 2 blocks of 128 KB; H = 256: 8 blocks of 128 KB;
// any H <= 256 fits some cluster of 1, 2, 4 or 8, so no width streams wh any more;
// the wrapper chooses the cluster from (B, H)). No weight traffic is left in the
// T-step loop. Because a block holds i, g, f and o of its units it finishes c' and h'
// for them with no exchange, then stores its slice of the new h into its own and its
// peers' shared memory (distributed shared memory). h is double-buffered by step
// parity, so ONE cluster barrier a step is enough: a block that runs ahead writes the
// buffer that the others finished reading before the barrier they all passed. The
// barrier is split (arrive.release ... wait.acquire) and the residual stores to global
// memory are sent between the two halves. xw[t + 1] arrives by cp.async into a
// double-buffered tile while step t computes, so no global load sits on the step's
// chain. One thread per gate column keeps R accumulators in registers, reads its
// weight from shared memory (conflict-free) and h as float4 broadcasts along k, and
// adds the k terms in order with fmaf, so the sum order is the plain loop's.
// Rows past their length keep c and h (out is zero; gates, cc, hc are still written);
// rows b >= B of the last tile compute on zeros and store nothing.
//
// The backward (unchanged): one block owns a tile of R batch rows for the whole
// recurrence; its da lives in shared memory, and each thread streams one column of
// wh^T (the wrapper passes wh^T so that the reads stay coalesced) from L2 once per
// step for all R rows. The 4H-long dots are split four ways over all 4H threads and
// the four partial sums are added in a fixed order.
//
// dwh is the one large product here ([H, T*B] x [T*B, 4H], ~15.7 GFLOP at
// T = 400, B = 300, H = 128): a tiled SIMT GEMM splits the T*B rows into `splits`
// fixed ranges, each block writes its tile's partial sum, and a second kernel adds
// the partials in order. No float atomics, so the same inputs give the same bits
// on every run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 8;  // batch rows per block (backward) or per cluster (forward)

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Floats of dynamic shared memory of one forward block (plus R ints of lengths):
// wh slice [HP][LC], h [2][R][HP], c [R][HS], gate pre-activations [R][LC], xw tiles
// [2][R][LC]; HP = H rounded up to 4, LC = 4 * HS.
inline int fwd_smem_floats(int H, int HS) {
  const int HP = (H + 3) & ~3, LC = 4 * HS;
  return HP * LC + 2 * R * HP + R * HS + R * LC + 2 * R * LC;
}

// tools/kernel_probe.py builds this file with -DLSTM_PROBE: thread 0 of block 0 then
// adds up the clocks it spends in each phase of a step.
#ifdef LSTM_PROBE
__device__ long long lstm_probe_clocks[8];
#define PROBE_INIT long long probe_last = clock64();
#define PROBE(i)                                \
  if (threadIdx.x == 0 && blockIdx.x == 0) {    \
    const long long now = clock64();            \
    lstm_probe_clocks[i] += now - probe_last;   \
    probe_last = now;                           \
  }
#else
#define PROBE_INIT
#define PROBE(i)
#endif

// THREADS >= 4 * HS, one thread per gate column of the block's slice (256 covers
// HS <= 64, 512 the rest, so that a block's registers always fit an SM). One block
// per SM: the registers go to the unrolled product loop.
constexpr int K_UNROLL = 4;  // k loop of the product: 16 weights and 32 h reads in flight
constexpr int EPT = 2;  // (row, unit) elements and 16-byte xw chunks per thread: R * HS <= 2 * THREADS

template <int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ wh,
                    const int* __restrict__ lens, float* __restrict__ out,
                    float* __restrict__ gates, float* __restrict__ cc, float* __restrict__ hc,
                    int T, int B, int H, int HS, int vec) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CS) * R;
  const int HP = (H + 3) & ~3;
  const int LC = 4 * HS;
  const int G = 4 * H;
  const int u0 = rank * HS;                      // first hidden unit of this block
  const int hs = max(0, min(HS, H - u0));        // its units (the last slice may be ragged)
  const int tid = threadIdx.x;

  float* ws = smem;                 // [HP][LC] wh[:, gate * H + u0 + u] at column gate * HS + u
  float* h_s = ws + HP * LC;        // [2][R][HP] the whole h of the tile, by step parity
  float* c_s = h_s + 2 * R * HP;    // [R][HS] c of this block's units
  float* g_s = c_s + R * HS;        // [R][LC] gate pre-activations
  float* xs = g_s + R * LC;         // [2][R][LC] xw tiles, by step parity
  int* len_s = reinterpret_cast<int*>(xs + 2 * R * LC);  // [R]

  for (int i = tid; i < HP * LC; i += THREADS) {
    const int k = i / LC, lc = i - k * LC;
    const int gate = lc / HS, u = lc - gate * HS;
    ws[i] = (k < H && u < hs) ? wh[(size_t)k * G + gate * H + u0 + u] : 0.f;
  }
  for (int i = tid; i < 2 * R * HP; i += THREADS) h_s[i] = 0.f;
  for (int i = tid; i < R * HS; i += THREADS) c_s[i] = 0.f;
  for (int i = tid; i < 2 * R * LC; i += THREADS) xs[i] = 0.f;  // padding rows and units stay 0
  if (tid < R) len_s[tid] = b0 + tid < B ? lens[b0 + tid] : 0;

  // This thread's share of one xw tile, the same at every step. With vec, 16-byte
  // chunks (runs of HS / 4 per row and gate) spread over all threads: offsets in the
  // tile and in xw[t], -1 for none. Without, 4-byte copies of the thread's own
  // column, row by row: xw_col is the column's offset in xw[t] for row b0, -1 for none.
  int xw_dst[EPT], xw_src[EPT], xw_col;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    xw_dst[i] = -1;
    xw_src[i] = 0;
    if (vec) {
      const int q = HS / 4;
      const int e = tid + i * THREADS;
      const int r = e / (4 * q);
      const int rem = e - r * 4 * q;
      const int gate = rem / q;
      const int u = (rem - gate * q) * 4;
      if (r < R && b0 + r < B && u < hs) {
        xw_dst[i] = r * LC + gate * HS + u;
        xw_src[i] = (b0 + r) * G + gate * H + u0 + u;
      }
    }
  }
  {
    const int gate = tid / HS, u = tid - gate * HS;
    xw_col = (!vec && tid < LC && u < hs) ? b0 * G + gate * H + u0 + u : -1;
  }
  auto prefetch = [&](int t) {
    float* dst = xs + (t & 1) * R * LC;
    const float* src = xw + (size_t)t * B * G;
    if (vec) {
#pragma unroll
      for (int i = 0; i < EPT; ++i)
        if (xw_dst[i] >= 0) cp_async16(dst + xw_dst[i], src + xw_src[i]);
    } else if (xw_col >= 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (b0 + r < B) cp_async4(dst + r * LC + tid, src + xw_col + r * G);
    }
    cp_async_commit();
  };

  // this thread's (row, unit) elements of the gate stage, the same at every step
  int el_r[EPT], el_u[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / HS;
    el_r[i] = -1;
    el_u[i] = e - r * HS;
    if (r < R && el_u[i] < hs) el_r[i] = r;
  }

  __syncthreads();  // the zeros are down before any cp.async lands on them
  prefetch(0);
  cp_async_wait_all();
  cluster.sync();  // every block of the cluster is initialised before a peer writes into it

  PROBE_INIT
  for (int t = 0; t < T; ++t) {
    const float* h_cur = h_s + (t & 1) * R * HP;
    float* h_next = h_s + ((t + 1) & 1) * R * HP;

    // pre-activations of this thread's column: xw[t] + h @ wh, k in order
    if (tid < LC) {
      const float* xt = xs + (t & 1) * R * LC + tid;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = xt[r * LC];
      const float4* h4 = reinterpret_cast<const float4*>(h_cur);
      const float* wp = ws + tid;
#pragma unroll K_UNROLL
      for (int k = 0; k < HP; k += 4) {
        const float w0 = wp[k * LC], w1 = wp[(k + 1) * LC], w2 = wp[(k + 2) * LC],
                    w3 = wp[(k + 3) * LC];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv = h4[(r * HP + k) >> 2];
          acc[r] = fmaf(hv.x, w0, acc[r]);
          acc[r] = fmaf(hv.y, w1, acc[r]);
          acc[r] = fmaf(hv.z, w2, acc[r]);
          acc[r] = fmaf(hv.w, w3, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) g_s[r * LC + tid] = acc[r];
    }
    // xw[t + 1] is asked for here, once the last step's residual stores have drained
    // (asked for before the product, the copies queue behind them), and has the gate
    // stage to land
    PROBE(0)  // the product
    if (t + 1 < T) prefetch(t + 1);
    __syncthreads();
    PROBE(1)  // the prefetch's start and the block barrier

    // gates, c', h' of this block's units; the new h goes to every block of the cluster
    float v_i[EPT], v_g[EPT], v_f[EPT], v_o[EPT], v_c[EPT], v_h[EPT], v_out[EPT];
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      if (el_r[i] < 0) continue;
      const int r = el_r[i], u = el_u[i];
      const float* g = g_s + r * LC + u;
      const float ig = sigm(g[0]);
      const float gg = tanhf(g[HS]);
      const float fg = sigm(g[2 * HS] + 1.f);
      const float og = sigm(g[3 * HS]);
      const float c_old = c_s[r * HS + u];
      const float h_old = h_cur[r * HP + u0 + u];
      const float nc = fg * c_old + ig * gg;
      const float nh = og * tanhf(nc);
      const bool active = t < len_s[r];
      const float c_new = active ? nc : c_old;
      const float h_new = active ? nh : h_old;
      c_s[r * HS + u] = c_new;
      float* slot = h_next + r * HP + u0 + u;
      for (int p = 0; p < CS; ++p) *cluster.map_shared_rank(slot, p) = h_new;
      v_i[i] = ig;
      v_g[i] = gg;
      v_f[i] = fg;
      v_o[i] = og;
      v_c[i] = c_new;
      v_h[i] = h_new;
      v_out[i] = active ? nh : 0.f;
    }
    PROBE(2)  // the gate stage and the stores of h into the cluster
    cp_async_wait_all();  // xw[t + 1] is down: the barrier below publishes it too
    cluster_arrive();
    // the residuals leave while the cluster gathers
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      if (el_r[i] < 0 || b0 + el_r[i] >= B) continue;
      const size_t row = (size_t)t * B + b0 + el_r[i];
      const int j = u0 + el_u[i];
      float* gr = gates + row * G + j;
      gr[0] = v_i[i];
      gr[H] = v_g[i];
      gr[2 * H] = v_f[i];
      gr[3 * H] = v_o[i];
      out[row * H + j] = v_out[i];
      cc[row * H + j] = v_c[i];
      hc[row * H + j] = v_h[i];
    }
    PROBE(3)  // the wait for xw[t + 1], the barrier's arrive and the residual stores
    cluster_wait();
    PROBE(4)  // the barrier's wait
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

#ifdef LSTM_PROBE
// Copies the phase clocks to dst[8] and sets them to 0.
int lstm_probe_read(long long* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, lstm_probe_clocks, sizeof(long long) * 8);
  if (err != cudaSuccess) return (int)err;
  const long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(lstm_probe_clocks, zero, sizeof(zero));
}
#endif

// xw: [T, B, 4H] float32, wh: [H, 4H], lens: [B] int32; out, cc, hc: [T, B, H],
// gates: [T, B, 4H]. 1 <= H <= 256, T, B >= 1. The geometry comes from the caller:
// rows of a batch tile (must be 8), blocks of a cluster (1, 2, 4 or 8, each holding
// ceil(H / cluster) hidden units) and the dynamic shared memory of a block.
int lstm_fwd_launch(const float* xw, const float* wh, const int* lens, float* out, float* gates,
                    float* cc, float* hc, int T, int B, int H, int rows, int cluster,
                    int smem_bytes, void* stream) {
  if (rows != R || cluster < 1 || cluster > 8 || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  const int HS = (H + cluster - 1) / cluster;
  const int need = (int)sizeof(float) * fwd_smem_floats(H, HS) + (int)sizeof(int) * R;
  if (4 * HS > 512 || smem_bytes < need) return (int)cudaErrorInvalidValue;
  const int threads = 4 * HS <= 256 ? 256 : 512;
  auto kernel = threads == 256 ? lstm_fwd_kernel<256> : lstm_fwd_kernel<512>;
  int err = set_smem((const void*)kernel, (size_t)smem_bytes);
  if (err) return err;
  const int vec = (H % 4 == 0 && HS % 4 == 0 && (reinterpret_cast<uintptr_t>(xw) & 15) == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + R - 1) / R) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, xw, wh, lens, out, gates, cc, hc, T, B, H, HS, vec);
  if (err) return err;
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
