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
// any H up to ~360 fits some cluster of 1, 2, 4 or 8, wider ones take the WG
// variant below; the wrapper chooses the cluster from (B, H)). No weight traffic is
// left in the T-step loop. Because a block holds i, g, f and o of its units it finishes c' and h'
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
// The backward keeps wh^T ([4H, H], 256 KB at H = 128) on chip the same way: a
// cluster owns a tile of RB batch rows (1..16, a template parameter chosen by the
// wrapper with the cluster size), and block j holds wh^T[:, j * HS : (j + 1) * HS],
// [4H, HS], in its shared memory for the whole launch. Per step, in reverse time,
// block j computes da = [di, dg, df, do] for its own units (dh and dc of its
// elements stay in registers), writes its da slice into every block's shared
// memory (double-buffered by parity), sends the dxw stores between the arrive and
// the wait of one split cluster barrier, and then computes dh[:, own units] =
// da @ wh^T[:, own units]: thread (q, u) sums gate q's H terms in order, and the
// four partial sums are added in the fixed order ((q0 + q1) + q2) + q3, so runs are
// bit-identical. The step's residuals (gates, dhs and cc[t - 1]; cc[t] is the
// previous step's cc[t - 1], hence two cc tiles) arrive by cp.async for step t - 1
// while step t exchanges da and computes its product: each thread copies exactly
// the elements it consumes, so no block barrier guards them, and one tile of each
// is enough.
//
// dwh is the one large product here ([H, T*B] x [T*B, 4H], ~15.7 GFLOP at
// T = 400, B = 300, H = 128): a register-blocked SIMT GEMM in full float32 (128 x
// 128 tiles, 8 x 8 outputs a thread, rows staged by cp.async, double-buffered)
// splits the T*B rows into `splits` fixed ranges, each block writes its tile's
// partial sum, and a second kernel adds the partials in order. No float atomics,
// so the same inputs give the same bits on every run. (The tensor cores would add
// with truncation over these long sums, see conv_bn.cu.)
//
// Above H ~ 330 (forward: ~ 360) no cluster of at most 8 blocks holds the
// slices of wh (wh^T); the WG variant of each recurrence then reads every
// block's slice from device memory (L2 holds a direction's 1-4 MB), laid out
// by the wrapper exactly as it would lie in shared memory, so the addresses,
// the order of the sums and the bits are those of the resident kernel. H <=
// 512 for the backward (4 * HS <= 256 threads, a cluster of at most 8), H <=
// 1024 for the forward (4 * HS <= 512); the wrappers cap both at 512.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 8;  // batch rows per cluster of the forward

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
// wh slice [HP][LC] (not with wh_global), h [2][R][HP], c [R][HS], gate
// pre-activations [R][LC], xw tiles [2][R][LC]; HP = H rounded up to 4, LC = 4 * HS.
inline int fwd_smem_floats(int H, int HS, bool wh_global) {
  const int HP = (H + 3) & ~3, LC = 4 * HS;
  return (wh_global ? 0 : HP * LC) + 2 * R * HP + R * HS + R * LC + 2 * R * LC;
}

// tools/kernel_probe.py builds this file with -DLSTM_PROBE: thread 0 of block 0 then
// adds up the clocks it spends in each phase of a step (slots 0-7 the forward's,
// 8-15 the backward's).
#ifdef LSTM_PROBE
__device__ long long lstm_probe_clocks[16];
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

template <int THREADS, bool WG>
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
  float* h_s = ws + (WG ? 0 : HP * LC);  // [2][R][HP] the whole h of the tile, by step parity
  float* c_s = h_s + 2 * R * HP;    // [R][HS] c of this block's units
  float* g_s = c_s + R * HS;        // [R][LC] gate pre-activations
  float* xs = g_s + R * LC;         // [2][R][LC] xw tiles, by step parity
  int* len_s = reinterpret_cast<int*>(xs + 2 * R * LC);  // [R]

  if constexpr (!WG) {
    for (int i = tid; i < HP * LC; i += THREADS) {
      const int k = i / LC, lc = i - k * LC;
      const int gate = lc / HS, u = lc - gate * HS;
      ws[i] = (k < H && u < hs) ? wh[(size_t)k * G + gate * H + u0 + u] : 0.f;
    }
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
      if constexpr (WG) wp = wh + (size_t)rank * HP * LC + tid;
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

// The backward: 256 threads, one per (gate q, unit u) of a block's slice in the
// product (4 * HS <= 256), and EPT (row, unit) elements a thread in the gate-gradient
// stage (RB * HS <= 4 * 256).
constexpr int BWD_THREADS = 256;
constexpr int BWD_MAX_ROWS = 16;
constexpr int BWD_EPT = 4;

// Floats of dynamic shared memory of one backward block (plus RB ints of lengths):
// wh^T slice [4][HP][HS] (not with wh_global), da of the tile [2][RB][4][HP],
// partial sums [4][RB][HS], gates [4][RB * HS], cc [2][RB * HS] and dhs [RB * HS] of
// its units.
inline int bwd_smem_floats(int H, int HS, int RB, bool wh_global) {
  const int HP = (H + 3) & ~3;
  return (wh_global ? 0 : 4 * HP * HS) + 8 * RB * HP + (4 + 4 + 2 + 1) * RB * HS;
}

template <int RB, bool WG>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    lstm_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cc,
                    const float* __restrict__ dhs, const float* __restrict__ wh_t,
                    const int* __restrict__ lens, float* __restrict__ dxw, int T, int B, int H,
                    int HS) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / CS) * RB;
  const int HP = (H + 3) & ~3;
  const int G = 4 * H;
  const int E = RB * HS;                         // elements of one tile of this block
  const int u0 = rank * HS;
  const int hs = max(0, min(HS, H - u0));
  const int tid = threadIdx.x;

  float* ws = smem;                  // [4][HP][HS] wh^T[q * H + k][u0 + u] at (q * HP + k) * HS + u
  float* da_s = ws + (WG ? 0 : 4 * HP * HS);  // [2][RB][4][HP] da of the whole tile, by step parity
  float* part_s = da_s + 8 * RB * HP;  // [4][RB][HS] partial sums of da @ wh^T, by gate
  // A thread copies (cp.async) and reads only its own elements of the residual
  // tiles, and has used step t's values before it asks for step t - 1's, so one
  // tile of each is enough, and two of cc: cc[s] in slot s & 1, read at steps s
  // and s + 1.
  float* gt_s = part_s + 4 * E;      // [4][E] activated gates of this block's units
  float* cc_s = gt_s + 4 * E;        // [2][E] carried c
  float* dhs_s = cc_s + 2 * E;       // [E] output gradient
  int* len_s = reinterpret_cast<int*>(dhs_s + E);  // [RB]

  if constexpr (!WG) {
    for (int i = tid; i < 4 * HP * HS; i += BWD_THREADS) {
      const int qk = i / HS, u = i - qk * HS;
      const int q = qk / HP, k = qk - q * HP;
      ws[i] = (k < H && u < hs) ? wh_t[(size_t)(q * H + k) * H + u0 + u] : 0.f;
    }
  }
  // da's padding units stay 0; the tiles of padding rows are never copied
  for (int i = tid; i < 8 * RB * HP + 11 * E; i += BWD_THREADS) da_s[i] = 0.f;
  if (tid < RB) len_s[tid] = b0 + tid < B ? lens[b0 + tid] : 0;

  // this thread's (row, unit) elements, the same at every step; b < B for the copies
  int el_r[BWD_EPT], el_u[BWD_EPT];
  bool el_in[BWD_EPT];
#pragma unroll
  for (int i = 0; i < BWD_EPT; ++i) {
    const int e = tid + i * BWD_THREADS;
    const int r = e / HS;
    el_u[i] = e - r * HS;
    el_r[i] = (r < RB && el_u[i] < hs) ? r : -1;
    el_in[i] = el_r[i] >= 0 && b0 + r < B;
  }
  // the residuals of step s: gates[s], dhs[s] and cc[s - 1]
  auto prefetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < BWD_EPT; ++i) {
      if (!el_in[i]) continue;
      const int e = tid + i * BWD_THREADS;
      const size_t row = (size_t)s * B + b0 + el_r[i];
      const int j = u0 + el_u[i];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        cp_async4(gt_s + q * E + e, gates + row * G + q * H + j);
      cp_async4(dhs_s + e, dhs + row * H + j);
      if (s > 0) cp_async4(cc_s + ((s - 1) & 1) * E + e, cc + (row - B) * H + j);
    }
    cp_async_commit();
  };

  __syncthreads();  // the zeros are down before any cp.async lands on them
#pragma unroll
  for (int i = 0; i < BWD_EPT; ++i)
    if (el_in[i])
      cp_async4(cc_s + ((T - 1) & 1) * E + tid + i * BWD_THREADS,
                cc + ((size_t)(T - 1) * B + b0 + el_r[i]) * H + u0 + el_u[i]);
  prefetch(T - 1);
  cp_async_wait_all();
  cluster.sync();  // every block is initialised before a peer writes into it

  float dh[BWD_EPT], dc[BWD_EPT];
  int el_len[BWD_EPT];
  bool act_next[BWD_EPT];  // the row was active at step t + 1: its dh comes from the product
#pragma unroll
  for (int i = 0; i < BWD_EPT; ++i) {
    dh[i] = dc[i] = 0.f;
    act_next[i] = false;
    el_len[i] = el_r[i] >= 0 ? len_s[el_r[i]] : 0;
  }

  PROBE_INIT
  for (int t = T - 1; t >= 0; --t) {
    // gate gradients of this block's units; masked steps pass dh and dc through
    float d[BWD_EPT][4];
#pragma unroll
    for (int i = 0; i < BWD_EPT; ++i) {
      d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
      if (el_r[i] < 0) continue;
      const int r = el_r[i], u = el_u[i];
      const int e = tid + i * BWD_THREADS;
      if (act_next[i])
        dh[i] = ((part_s[r * HS + u] + part_s[(RB + r) * HS + u]) + part_s[(2 * RB + r) * HS + u]) +
                part_s[(3 * RB + r) * HS + u];
      const bool active = t < el_len[i];
      act_next[i] = active;
      if (active) {
        const float* g = gt_s + e;
        const float ig = g[0], gg = g[E], fg = g[2 * E], og = g[3 * E];
        const float c_t = cc_s[(t & 1) * E + e];
        const float c_prev = t > 0 ? cc_s[((t + 1) & 1) * E + e] : 0.f;
        const float tc = tanhf(c_t);
        const float dh_new = dhs_s[e] + dh[i];
        const float dc_new = dc[i] + dh_new * og * (1.f - tc * tc);
        d[i][3] = dh_new * tc * og * (1.f - og);
        d[i][2] = dc_new * c_prev * fg * (1.f - fg);
        d[i][0] = dc_new * gg * ig * (1.f - ig);
        d[i][1] = dc_new * ig * (1.f - gg * gg);
        dc[i] = dc_new * fg;
      }
    }
    PROBE(8)  // the gate gradients
    // step t - 1's residuals are asked for as soon as step t's are read (into
    // registers, and used): they have the rest of the step to land
    if (t > 0) prefetch(t - 1);
    PROBE(9)  // the prefetch's start
#pragma unroll
    for (int i = 0; i < BWD_EPT; ++i) {
      if (el_r[i] < 0) continue;
      float* slot = da_s + ((t & 1) * RB + el_r[i]) * 4 * HP + u0 + el_u[i];
      for (int p = 0; p < CS; ++p) {
        float* dst = cluster.map_shared_rank(slot, p);
        dst[0] = d[i][0];
        dst[HP] = d[i][1];
        dst[2 * HP] = d[i][2];
        dst[3 * HP] = d[i][3];
      }
    }
    PROBE(10)  // the stores of da into the cluster
    cluster_arrive();
    // dxw leaves while the cluster gathers
#pragma unroll
    for (int i = 0; i < BWD_EPT; ++i) {
      if (!el_in[i]) continue;
      float* dr = dxw + ((size_t)t * B + b0 + el_r[i]) * G + u0 + el_u[i];
      dr[0] = d[i][0];
      dr[H] = d[i][1];
      dr[2 * H] = d[i][2];
      dr[3 * H] = d[i][3];
    }
    PROBE(11)  // the barrier's arrive and the dxw stores
    cluster_wait();
    PROBE(12)  // the barrier's wait
    if (t == 0) break;
    // dh of step t - 1 for this block's units: thread (q, u) sums gate q's terms in order
    if (tid < 4 * HS) {
      const int q = tid / HS, u = tid - q * HS;
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
      const float4* d4 = reinterpret_cast<const float4*>(da_s + (t & 1) * RB * 4 * HP + q * HP);
      const float* wp = ws + q * HP * HS + u;
      if constexpr (WG) wp = wh_t + ((size_t)rank * 4 + q) * HP * HS + u;
#pragma unroll K_UNROLL
      for (int k = 0; k < HP; k += 4) {
        const float w0 = wp[k * HS], w1 = wp[(k + 1) * HS], w2 = wp[(k + 2) * HS],
                    w3 = wp[(k + 3) * HS];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 dv = d4[(r * 4 * HP + k) >> 2];
          acc[r] = fmaf(dv.x, w0, acc[r]);
          acc[r] = fmaf(dv.y, w1, acc[r]);
          acc[r] = fmaf(dv.z, w2, acc[r]);
          acc[r] = fmaf(dv.w, w3, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) part_s[(q * RB + r) * HS + u] = acc[r];
    }
    PROBE(13)  // the product
    cp_async_wait_all();  // this thread's residuals of step t - 1 are down
    __syncthreads();      // the partial sums are down
    PROBE(14)  // the wait for the residuals and the block barrier
  }
}

using BwdKernel = void (*)(const float*, const float*, const float*, const float*, const int*,
                           float*, int, int, int, int);

// lstm_bwd_kernel<rows, wh_global> for rows in 1..RB, nullptr otherwise
template <int RB>
BwdKernel bwd_kernel_for_rows(int rows, bool wh_global) {
  if (rows == RB) return wh_global ? lstm_bwd_kernel<RB, true> : lstm_bwd_kernel<RB, false>;
  if constexpr (RB > 1) return bwd_kernel_for_rows<RB - 1>(rows, wh_global);
  return nullptr;
}

// dwh partials: block (x, y, z) owns dwh[y*128 : +128, x*128 : +128] over the
// rows n in [z * chunk, (z + 1) * chunk) of the flattened [T*B] axis, where
// h_prev[n] = hc[n - B] (zero for the first B rows, time 0). 256 threads, each
// 8 x 8 outputs (two runs of 4 rows and of 4 columns, 64 apart, so that a warp's
// float4 reads of a staged row are broadcasts or contiguous); 8 rows of h_prev
// and dxw staged a stage by 4-byte cp.async with zero fill, two stages in flight.
// Each output adds its rows in order with fmaf.
constexpr int DW_TILE = 128, DW_ROWS = 8;

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__global__ void __launch_bounds__(256)
    lstm_dwh_partial_kernel(const float* __restrict__ hc, const float* __restrict__ dxw,
                            float* __restrict__ part, int n_rows, int chunk, int B, int H) {
  __shared__ __align__(16) float a_s[2][DW_ROWS][DW_TILE];  // h_prev rows, k
  __shared__ __align__(16) float b_s[2][DW_ROWS][DW_TILE];  // dxw rows, c
  const int G = 4 * H;
  const int k0 = blockIdx.y * DW_TILE, c0 = blockIdx.x * DW_TILE;
  const int n_begin = blockIdx.z * chunk;
  const int n_end = min(n_begin + chunk, n_rows);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto stage = [&](int n0, int buf) {
#pragma unroll
    for (int i = 0; i < DW_ROWS * DW_TILE / 256; ++i) {
      const int e = tid + i * 256;
      const int rr = e / DW_TILE, cc = e - rr * DW_TILE;
      const int n = n0 + rr, k = k0 + cc, c = c0 + cc;
      const bool va = n < n_end && n >= B && k < H;
      const bool vb = n < n_end && c < G;
      cp_async4_zfill(&a_s[buf][rr][cc], va ? hc + (size_t)(n - B) * H + k : hc, va);
      cp_async4_zfill(&b_s[buf][rr][cc], vb ? dxw + (size_t)n * G + c : dxw, vb);
    }
    cp_async_commit();
  };
  const int stages = n_end > n_begin ? (n_end - n_begin + DW_ROWS - 1) / DW_ROWS : 0;
  if (stages > 0) stage(n_begin, 0);
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      stage(n_begin + (s + 1) * DW_ROWS, (s + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const int buf = s & 1;
#pragma unroll
    for (int rr = 0; rr < DW_ROWS; ++rr) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][rr][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[buf][rr][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[buf][rr][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[buf][rr][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the buffer is read before the stage after next lands on it
  }
  float* dst = part + (size_t)blockIdx.z * H * G;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c < G) dst[(size_t)k * G + c] = acc[i][j];
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
// Copies the phase clocks to dst[16] and sets them to 0.
int lstm_probe_read(long long* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, lstm_probe_clocks, sizeof(long long) * 16);
  if (err != cudaSuccess) return (int)err;
  const long long zero[16] = {0};
  return (int)cudaMemcpyToSymbol(lstm_probe_clocks, zero, sizeof(zero));
}
#endif

// xw: [T, B, 4H] float32, wh: [H, 4H], lens: [B] int32; out, cc, hc: [T, B, H],
// gates: [T, B, 4H]. 1 <= H, 4 * ceil(H / cluster) <= 512, T, B >= 1. The geometry
// comes from the caller: rows of a batch tile (must be 8), blocks of a cluster (1,
// 2, 4 or 8, each holding ceil(H / cluster) hidden units), the dynamic shared
// memory of a block, and wh_global: wh is then [cluster][HP][4 * HS] slices read
// from device memory (HP = H rounded up to 4, HS = ceil(H / cluster), zero padded).
int lstm_fwd_launch(const float* xw, const float* wh, const int* lens, float* out, float* gates,
                    float* cc, float* hc, int T, int B, int H, int rows, int cluster,
                    int smem_bytes, int wh_global, void* stream) {
  if (rows != R || cluster < 1 || cluster > 8 || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  const int HS = (H + cluster - 1) / cluster;
  const int need = (int)sizeof(float) * fwd_smem_floats(H, HS, wh_global != 0) +
                   (int)sizeof(int) * R;
  if (4 * HS > 512 || smem_bytes < need) return (int)cudaErrorInvalidValue;
  const int threads = 4 * HS <= 256 ? 256 : 512;
  auto kernel = threads == 256 ? (wh_global ? lstm_fwd_kernel<256, true> : lstm_fwd_kernel<256, false>)
                               : (wh_global ? lstm_fwd_kernel<512, true> : lstm_fwd_kernel<512, false>);
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
// The recurrence's geometry comes from the caller: rows of a batch tile (1..16),
// blocks of a cluster (1, 2, 4 or 8, each holding ceil(H / cluster) <= 64 hidden
// units), the dynamic shared memory of a block, and wh_global: wh_t is then
// [cluster][4][HP][HS] slices read from device memory (zero padded).
int lstm_bwd_launch(const float* gates, const float* cc, const float* hc, const float* dhs,
                    const float* wh_t, const int* lens, float* dxw, float* dwh, float* part,
                    int splits, int T, int B, int H, int rows, int cluster, int smem_bytes,
                    int wh_global, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int G = 4 * H;
  if (cluster < 1 || cluster > 8 || (cluster & (cluster - 1)) || H < 1 || T < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const BwdKernel kernel = bwd_kernel_for_rows<BWD_MAX_ROWS>(rows, wh_global != 0);
  const int HS = (H + cluster - 1) / cluster;
  const int need = (int)sizeof(float) * bwd_smem_floats(H, HS, rows, wh_global != 0) +
                   (int)sizeof(int) * rows;
  if (kernel == nullptr || 4 * HS > BWD_THREADS || rows * HS > BWD_EPT * BWD_THREADS ||
      smem_bytes < need)
    return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)kernel, (size_t)smem_bytes);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + rows - 1) / rows) * cluster);
  cfg.blockDim = dim3(BWD_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, gates, cc, dhs, wh_t, lens, dxw, T, B, H, HS);
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err) return err;
  const int n_rows = T * B;
  const int chunk = (n_rows + splits - 1) / splits;
  dim3 grid((G + DW_TILE - 1) / DW_TILE, (H + DW_TILE - 1) / DW_TILE, splits);
  lstm_dwh_partial_kernel<<<grid, 256, 0, s>>>(hc, dxw, part, n_rows, chunk, B, H);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int n = H * G;
  lstm_dwh_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, dwh, splits, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
