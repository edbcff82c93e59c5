// One recurrent-batch-norm LSTM layer (arxiv 1603.09025), the whole T-step
// recurrence in one launch after a moments pre-pass: both directions
// (bibnlstm_launch) or one (bnlstm_launch), through the same kernels.
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
// normalisations couple every row of the batch, so the T steps are a chain
// of [B, H] x [H, 4H] products, each followed by two reductions over all B
// rows: the kernel is bound by the latency of a step, not by the card's peak.
// BN_x's moments do not depend on the state: a pre-pass kernel takes them for
// all T steps at once (one thread per (t, column), rows in order).
//
// Two instances of the recurrence, chosen by shape in ops/bnlstm.py:geometry:
//
//  - bnlstm_cluster_kernel<RT, UT> (the main one). One or two thread-block
//    clusters of up to 16 blocks (16 is not portable; the launcher allows
//    it) hold one direction's batch. A cluster's blocks are RG row groups x
//    US unit slices: block (rg, us) owns a row group's rows and the four gate
//    columns of ceil(H / US) hidden units, and keeps in shared memory, for
//    the whole launch, its slice of wh ([H][units][4], the four gates of a
//    unit side by side) and the h of its row group (k-major, [H][rows]);
//    xw[t] of its rows and units arrives by one TMA tensor copy a step,
//    issued before the product and waited for after it. A thread owns RT
//    rows x UT units: RT x UT x 4 accumulators, k one at a time, h as float4
//    along the rows and wh as float4 along the gates, so each weight read
//    from shared memory feeds RT rows; c', BN_c and h' of its units need no
//    exchange beyond the moments. Per step, BN_h and BN_c each take the
//    block's (mean, M2) per column in two passes over its rows (the thread
//    tiles' partials summed in tile order), send them to the blocks of the
//    same unit slice through distributed shared memory, meet at the cluster
//    barrier and combine the RG partials in row-group order (Chan's
//    update). With two clusters a direction, each unit slice's leader (row
//    group 0) then stores its cluster's moments into device memory as 64-bit
//    words that carry the step's tag, and every block combines both
//    clusters' moments in cluster order once the other's words carry the
//    tag: no counter, no fence. The new h of a block's units is written into
//    its own h, then sent to the other blocks of its row group as one
//    distributed-shared-memory bulk copy each, counted on their mbarrier,
//    which they wait for before the next product. Two cluster barriers a
//    step (one, split around the product, with one row group); no counter
//    is spun on. At B = 400, H = 128 the product is bound by shared memory
//    handing the lanes h and wh (~108 of its 128 bytes a clock, measured):
//    two clusters a direction halve it at the cost of the two exchanges.
//  - bnlstm_kernel<THREADS, COLS> (the cooperative kernel, for the shapes no cluster
//    holds: more rows than a cluster's shared memory takes, or H above ~470,
//    where a cluster of 16 no longer holds wh). One block per direction and
//    tile of rows, launched cooperatively, one thread per gate column, wh
//    streamed from L2, two grid-wide barriers a step on a global counter per
//    direction; each block combines every tile's (count, mean, M2) in tile
//    order.
//
// Both instances sum h @ wh over k in order with fmaf from zero, and combine
// the moments in an order fixed by the geometry alone, which depends on
// (B, H) and not on the other direction: the same bits on every run, and the
// fused launch equal to two single launches wherever both take one geometry.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap (the encoder comes from the runtime's driver entry point)
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 8;  // rows per register sub-tile of the cooperative kernel
constexpr int MAX_H = 512;  // 4H gate columns over at most 1024 threads, two a thread
constexpr float BN_EPS = 1e-5f;
constexpr int MAX_CLUSTER = 16;  // blocks of a cluster (non-portable above 8)
constexpr int MAX_SPLIT = 2;     // clusters of one direction

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
  CUtensorMap xmap[2];  // the cluster kernel's tensor maps of xw (vec), one a direction
  Dir d[2];
  const int* lens;  // [B]
  float* xmom;      // [dirs][T][4H][2]   mean and rsqrt(var + eps) of xw[t]
  // the cooperative kernel's scratch
  float* part_h;    // [dirs][tiles][4H][2]  per-tile mean and M2 of h @ wh
  float* part_c;    // [dirs][tiles][H][2]   per-tile mean and M2 of c'
  float* cnt_h;     // [dirs][tiles]  per-tile active rows, written with part_h
  float* cnt_c;     // [dirs][tiles]  the same, written with part_c
  unsigned* bar;    // [dirs] barrier counters, zero at launch
  // the cluster kernel's exchange between the clusters of a direction, zeroed
  // at launch: [dirs][2: BN_h, BN_c][2: parity][CPD][US][2 * LC + 2] tagged words
  unsigned long long* cross;
  int T, B, H;
  int rows;         // the cooperative kernel's rows per block
  int RG, US, CPD, vec;  // the cluster kernel's row groups and unit slices of a cluster,
                         // clusters per direction, tensor copies of xw
};

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// A tensor copy (TMA) of the box at (c0, c1, c2) of the 3-D tensor map into
// this block's shared memory (128-byte aligned), counted on `bar`.
__device__ __forceinline__ void tensor_copy_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                               int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}
// A bulk copy of `bytes` (a multiple of 16) from this block's shared memory
// into the same offset of block `peer` of the cluster, counted on the peer's
// mbarrier at the offset of `bar`.
__device__ __forceinline__ void bulk_copy_to_peer(float* at, unsigned bytes, uint64_t* bar,
                                                  unsigned peer) {
  unsigned dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(smem_addr(at)), "r"(peer));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(smem_addr(bar)), "r"(peer));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "r"(smem_addr(at)), "r"(bytes), "r"(rbar)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// tools/kernel_probe.py builds this file with -DBNLSTM_PROBE: thread 0 of block
// (0, 0) then adds up the clocks it spends in each phase of a step (slots 0-6
// the cooperative kernel, 8-14 the cluster kernel).
#ifdef BNLSTM_PROBE
__device__ long long bnlstm_probe_clocks[24];
#define PROBE_INIT long long probe_last = clock64();
#define PROBE(i)                                                       \
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {        \
    const long long now = clock64();                                   \
    bnlstm_probe_clocks[i] += now - probe_last;                        \
    probe_last = now;                                                  \
  }
#else
#define PROBE_INIT
#define PROBE(i)
#endif

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

// ---- the cooperative instance ------------------------------------------------

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

  PROBE_INIT
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
      if (j == 0) {
        PROBE(0)  // the product
      }
      tile_moments(g_s + col, G, len_s, rows, t, sum, n, part_h + ((size_t)tile * G + col) * 2);
      if (col == 0) __stcg(cnt_h + tile, (float)n);
      if (j == 0) {
        PROBE(1)  // the BN_h tile moments
      }
    }
    direction_barrier(bar, ++meetings * tiles);
    PROBE(2)  // barrier 1
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
    PROBE(3)  // the BN_h combine and the gates
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
    PROBE(4)  // c' and its tile moments
    direction_barrier(bar, ++meetings * tiles);
    PROBE(5)  // barrier 2
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
    PROBE(6)  // the BN_c combine, h' and the stores
  }
}


// ---- the cluster instance ----------------------------------------------------

// Threads a block of the cluster kernel may have: 128 registers a thread hold
// the 4 x 1 tile's accumulators and the product's operands unspilled; the
// tiles of 8 or more (row, unit) elements, beside the step's loop-invariant
// state, need up to 255 (256 threads).
constexpr int CLUSTER_THREADS = 512;
__host__ __device__ constexpr int cluster_max_threads(int rt, int ut) {
  return rt * ut >= 8 ? 256 : CLUSTER_THREADS;
}

// Shared memory of one block of the cluster kernel, in floats from the start
// (ops/bnlstm.py:cluster_smem_bytes computes the same total). Every array that
// is read as float4 starts at a multiple of 4 floats.
struct Layout {
  int HSL, HS, HSU, LC, HP, RB, NT, RBP, LCR;
  int xs, ws, hs, xm, cs, red, mb, coef, prm, xh, xc, cst, prc, xn, lens, bar, floats;
};

__host__ __device__ inline Layout cluster_layout(int H, int B, int RG, int US, int RT, int UT,
                                                int CPD) {
  Layout L;
  L.HSL = (H + US - 1) / US;    // hidden units of a slice (the block's first is us * HSL)
  L.HSU = (L.HSL + UT - 1) / UT;  // thread tiles along the units
  L.HS = L.HSU * UT;            // the block's units, padded to UT
  L.LC = 4 * L.HS;              // its gate columns
  L.HP = (H + 3) & ~3;          // k padded to quads
  L.RB = (B + RG * CPD - 1) / (RG * CPD);  // batch rows of a row group
  L.NT = (L.RB + RT - 1) / RT;  // thread tiles along the rows
  L.RBP = L.NT * RT;
  L.LCR = L.LC + 4;             // a row of red: LC partial sums, the tile's active rows
  int o = 0;
  L.xs = o;   o += L.RBP * L.LC;       // [RBP][4][HS] xw[t] of the block's rows and units
  L.ws = o;   o += L.HP * L.LC;        // [HP][HS][4] wh[k][gate * H + u0 + unit]
  L.hs = o;   o += L.HP * L.RBP;       // [HP][RBP] h of the row group, k-major
  L.xm = o;   o += 2 * L.LC;           // [4][HS][2] xw[t]'s moments of the block's columns
  L.cs = o;   o += L.RBP * L.HS;       // [RBP][HS] c of the block's rows and units
  L.red = o;  o += L.NT * L.LCR;       // [NT][LC + 4] the thread tiles' partial sums
  L.mb = o;   o += L.LC;               // the block's means of the pass in flight
  L.coef = o; o += 4 * L.LC;           // [LC][4] mean_x, inv_x, mean_h, inv_h of step t
  L.prm = o;  o += 3 * L.LC;           // [3][LC] scale_x, scale_h, b
  L.xh = o;   o += 2 * RG * L.LC;      // [RG][LC][2] each row group's (mean, M2) of h @ wh
  L.xc = o;   o += (2 * RG * L.HS + 3) & ~3;  // [RG][HS][2] the same of c'
  L.cst = o;  o += (2 * L.HS + 3) & ~3;       // [HS][2] mean_c, inv_c of step t
  L.prc = o;  o += (2 * L.HS + 3) & ~3;       // [2][HS] scale_c, offset_c
  L.xn = o;   o += (2 * RG + 3) & ~3;         // [2][RG] each row group's active rows, by parity
  L.lens = o; o += (L.RBP + 1) & ~1;          // [RBP] the block's lengths (int)
  L.bar = o;  o += 4;                         // mbarriers: the copy of xw[t], the peers' h
  L.floats = o;
  return L;
}

// The cluster kernel's step is a chain of short stages, so its arithmetic is
// branch-free: sigmoid and tanh from expf and __fdividef (a few ulp, no
// slow path), which lets the compiler interleave a thread's (row, unit)
// chains; the cooperative kernel keeps sigm / tanhf.
__device__ __forceinline__ float sigm_fast(float x) { return __fdividef(1.f, 1.f + expf(-x)); }
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, 1.f + expf(2.f * x));
}

// Chan's update of (n, mean, M2) by a partial (nb, mb, m2b).
__device__ __forceinline__ void chan_add(float4& m, float nb, float mb, float m2b) {
  const float tot = m.x + nb;
  const float w = nb > 0.f ? __fdividef(nb, tot) : 0.f;
  const float dlt = mb - m.y;
  m.y = fmaf(dlt, w, m.y);
  m.z += m2b + dlt * dlt * m.x * w;
  m.x = tot;
}

// (n, mean, M2) of `parts` (mean, M2) partials with counts cnt, combined in order.
__device__ __forceinline__ float4 chan_combine(const float* part, int stride, const float* cnt,
                                               int parts) {
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < parts; ++k) chan_add(m, cnt[k], part[k * stride], part[k * stride + 1]);
  return m;
}

__device__ __forceinline__ float bn_inv(const float4& m) {
  return rsqrtf(__fdividef(m.z, fmaxf(m.x, 1.f)) + BN_EPS);
}

__device__ __forceinline__ void st_tagged(unsigned long long* p, unsigned tag, float v) {
  const unsigned long long w = ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}
// The value of a tagged word once its tag is `tag`; a word that never gets it
// traps instead of hanging.
__device__ __forceinline__ float ld_tagged(const unsigned long long* p, unsigned tag) {
  unsigned long long w;
  long long spins = 0;
  do {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
    if (++spins > (1LL << 24)) __trap();
  } while ((unsigned)(w >> 32) != tag);
  return __uint_as_float((unsigned)w);
}

// The clusters of one direction trade their cluster-level moments of a step
// through device memory. Block (rg = 0, us) of cluster c is its unit slice's
// leader: its owners have put the slice's (n, mean, M2) of every column
// (`cols`) into `own` ([cols] float4 in shared memory) and store them into the
// slot of (c, us) as 64-bit words, each value beside the step's tag, so a
// word is its own flag: no fence, one read. Every block of the slice reads
// the other clusters' words once they carry the tag and combines all
// clusters' moments in cluster order into `own`, the same bits in every
// cluster. The slots alternate by step parity and start zeroed (tags count
// from 1); the kernel needs every cluster resident at once (checked at
// launch).
__device__ void cross_cluster_combine(const Args& a, float4* own, int cols, int slot, int kind,
                                      int t, int dir, int c, int rg, int us) {
  const int CPD = a.CPD, US = a.US, tid = threadIdx.x, nthr = blockDim.x;
  unsigned long long* base =
      a.cross + (size_t)(((dir * 2 + kind) * 2 + (t & 1)) * CPD) * US * slot;
  const unsigned tag = 2u * (unsigned)t + 1u + (unsigned)kind;
  if (rg == 0) {
    unsigned long long* mine = base + (size_t)(c * US + us) * slot;
    for (int col = tid; col < cols; col += nthr) {
      st_tagged(mine + 2 * col, tag, own[col].y);
      st_tagged(mine + 2 * col + 1, tag, own[col].z);
      if (col == 0) st_tagged(mine + slot - 1, tag, own[0].x);
    }
  }
  for (int col = tid; col < cols; col += nthr) {
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < CPD; ++q) {
      if (q == c) {
        chan_add(m, own[col].x, own[col].y, own[col].z);
      } else {
        const unsigned long long* theirs = base + (size_t)(q * US + us) * slot;
        chan_add(m, ld_tagged(theirs + slot - 1, tag), ld_tagged(theirs + 2 * col, tag),
                 ld_tagged(theirs + 2 * col + 1, tag));
      }
    }
    own[col] = m;
  }
  __syncthreads();
}

__device__ __forceinline__ void fma4(float* acc, float h, const float4& w) {
  acc[0] = fmaf(h, w.x, acc[0]);
  acc[1] = fmaf(h, w.y, acc[1]);
  acc[2] = fmaf(h, w.z, acc[2]);
  acc[3] = fmaf(h, w.w, acc[3]);
}

// One cluster per direction (blockIdx.y), its blocks ranked rg * US + us. A
// thread owns RT rows (a multiple of 4: h is read as float4 along the rows)
// and UT units, j * HSU + up for j < UT: neighbouring threads read
// neighbouring float4 of wh.
template <int RT, int UT>
__global__ void __launch_bounds__(cluster_max_threads(RT, UT), 1)
    bnlstm_cluster_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int RG = a.RG, US = a.US;
  const int rank = (int)cluster.block_rank();
  const int rg = rank / US, us = rank - rg * US;
  const int cl = blockIdx.x / (RG * US);  // the direction's cluster
  const int H = a.H, G = 4 * H, B = a.B, T = a.T;
  const Layout L = cluster_layout(H, B, RG, US, RT, UT, a.CPD);
  const int HS = L.HS, HSU = L.HSU, LC = L.LC, NT = L.NT, RBP = L.RBP, LCR = L.LCR;
  const int u0 = us * L.HSL, b0 = (cl * RG + rg) * L.RB;
  const int nrows = max(0, min(L.RB, B - b0));    // batch rows of this block
  const int nunits = max(0, min(L.HSL, H - u0));  // hidden units of this block
  const int dir = blockIdx.y;
  const Dir d = a.d[dir];
  const float* xmom = a.xmom + (size_t)dir * T * G * 2;
  float* ws = smem + L.ws;
  float* hs = smem + L.hs;
  float* xs = smem + L.xs;
  float* xm = smem + L.xm;
  float* cs = smem + L.cs;
  float* red = smem + L.red;
  float* mb = smem + L.mb;
  float* coef = smem + L.coef;
  float* prm = smem + L.prm;
  float* xh = smem + L.xh;
  float* xc = smem + L.xc;
  float* cst = smem + L.cst;
  float* prc = smem + L.prc;
  float* xn = smem + L.xn;
  int* lens_s = reinterpret_cast<int*>(smem + L.lens);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + L.bar);
  uint64_t* hbar = xbar + 1;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const bool tile = tid < HSU * NT;  // this thread owns RT rows x UT units
  const int rt = tile ? tid / HSU : 0;
  const int up = tile ? tid - rt * HSU : 0;
  const int r0 = rt * RT;

  for (int i = tid; i < L.HP * LC; i += nthr) {
    const int k = i / LC, rem = i - k * LC, uu = rem >> 2, g = rem & 3;
    ws[i] = (k < H && uu < nunits) ? d.wh[(size_t)k * G + g * H + u0 + uu] : 0.f;
  }
  for (int i = tid; i < L.HP * RBP; i += nthr) hs[i] = 0.f;
  for (int i = tid; i < RBP * LC; i += nthr) xs[i] = 0.f;  // padding rows and units stay 0
  for (int i = tid; i < RBP * HS; i += nthr) cs[i] = 0.f;
  for (int i = tid; i < LC; i += nthr) {
    const int uu = i >> 2, g = i & 3, gc = g * H + u0 + uu;
    const bool ok = uu < nunits;
    prm[i] = ok ? d.scale_x[gc] : 0.f;
    prm[LC + i] = ok ? d.scale_h[gc] : 0.f;
    prm[2 * LC + i] = ok ? d.b[gc] : 0.f;
  }
  for (int i = tid; i < HS; i += nthr) {
    prc[i] = i < nunits ? d.scale_c[u0 + i] : 0.f;
    prc[HS + i] = i < nunits ? d.offset_c[u0 + i] : 0.f;
  }
  for (int r = tid; r < RBP; r += nthr) lens_s[r] = r < nrows ? a.lens[b0 + r] : 0;
  if (tid == 0) {
    mbar_init(xbar, 1);
    mbar_init(hbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();  // the zeros above are down before any bulk copy lands

  // The copy of xw[t] and its moments into xs and xm. Where H and the slice
  // are multiples of 4, xw is aligned and a box holds the block (a.vec),
  // its last thread issues one tensor copy (TMA) of the box [RB rows][4 gates][HS
  // units] at (u0, 0, t * B + b0) of the map [T * B][4][H] (units past H
  // arrive as zeros; rows past B belong to no row of the block), counted on
  // the mbarrier xbar, whose phase t & 1 the block waits for before the gate
  // stage; else every thread copies single floats (cp.async). The moments of
  // xw[t] (8 bytes a column) always go by cp.async.
  const unsigned x_bytes = (unsigned)(L.RB * LC) * sizeof(float);
  auto prefetch = [&](int t) {
    if (a.vec) {
      if (tid == nthr - 1) {  // a thread past the tiles where the block has one
        fence_proxy_async();
        mbar_arrive_expect_tx(xbar, x_bytes);
        tensor_copy_3d(xs, &a.xmap[dir], u0, 0, t * B + b0, xbar);
      }
    } else {
      const float* src = d.xw + ((size_t)t * B + b0) * G + u0;
      for (int e = tid; e < 4 * nunits; e += nthr) {
        const int g = e / nunits, j = e - g * nunits;
        for (int r = 0; r < nrows; ++r)
          cp_async4(xs + r * LC + g * HS + j, src + (size_t)r * G + g * H + j);
      }
    }
    for (int e = tid; e < 4 * nunits; e += nthr) {
      const int g = e / nunits, j = e - g * nunits;
      cp_async8(xm + 2 * (g * HS + j), xmom + ((size_t)t * G + g * H + u0 + j) * 2);
    }
    cp_async_commit();
  };
  auto prefetch_wait = [&](int t) {
    if (a.vec) mbar_wait(xbar, t & 1);
    cp_async_wait_all();
  };

  __syncthreads();
  cluster_barrier();  // every block of the cluster is initialised before a peer writes into it

  // the new h of the block's units goes to the other blocks of its row group
  // as one bulk copy each (its [units][RBP] slice of hs is contiguous)
  const unsigned h_bytes = (unsigned)(nunits * RBP) * sizeof(float);
  const unsigned h_expect = (unsigned)((H - nunits) * RBP) * sizeof(float);

  PROBE_INIT
  for (int t = 0; t < T; ++t) {
    prefetch(t);  // lands while the product runs
    PROBE(15)  // the start of the copies of xw[t] and its moments
    if (t > 0 && US > 1) mbar_wait(hbar, (t - 1) & 1);  // the peers' h of step t is down
    PROBE(14)  // the wait for the peers' h

    // 1. hw = h @ wh for the tile's RT rows and the four gates of its UT units, k in order
    float acc[RT][UT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < UT; ++j) acc[r][j][0] = acc[r][j][1] = acc[r][j][2] = acc[r][j][3] = 0.f;
    if (tile) {
      const float* hk = hs + r0;
      const float4* wk = reinterpret_cast<const float4*>(ws) + up;
#pragma unroll 2
      for (int k = 0; k < H; ++k) {
        float4 w[UT];
#pragma unroll
        for (int j = 0; j < UT; ++j) w[j] = wk[k * HS + j * HSU];
#pragma unroll
        for (int r4 = 0; r4 < RT; r4 += 4) {
          const float4 h4 = *reinterpret_cast<const float4*>(hk + k * RBP + r4);
#pragma unroll
          for (int j = 0; j < UT; ++j) {
            fma4(acc[r4][j], h4.x, w[j]);
            fma4(acc[r4 + 1][j], h4.y, w[j]);
            fma4(acc[r4 + 2][j], h4.z, w[j]);
            fma4(acc[r4 + 3][j], h4.w, w[j]);
          }
        }
      }
    }
    // one row group: the only barrier of the step, split around the moments;
    // its wait comes before the new h is written
    if (RG == 1) cluster_arrive();
    PROBE(8)  // the product

    // 2. BN_h: the block's mean and M2 per gate column over its active rows, two passes
    bool act[RT];
    int n_t = 0;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      act[r] = lens_s[r0 + r] > t;
      n_t += act[r];
    }
    if (tile) {
#pragma unroll
      for (int j = 0; j < UT; ++j) {
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (act[r]) {
            s.x += acc[r][j][0];
            s.y += acc[r][j][1];
            s.z += acc[r][j][2];
            s.w += acc[r][j][3];
          }
        }
        *reinterpret_cast<float4*>(red + rt * LCR + 4 * (j * HSU + up)) = s;
      }
      if (up == 0) red[rt * LCR + LC] = (float)n_t;
    }
    __syncthreads();
    for (int col = tid; col < LC; col += nthr) {
      float s = 0.f, n = 0.f;
      for (int k = 0; k < NT; ++k) {
        s += red[k * LCR + col];
        n += red[k * LCR + LC];
      }
      mb[col] = n > 0.f ? __fdividef(s, n) : 0.f;
    }
    __syncthreads();
    if (tile) {
#pragma unroll
      for (int j = 0; j < UT; ++j) {
        const float4 m = *reinterpret_cast<const float4*>(mb + 4 * (j * HSU + up));
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (act[r]) {
            const float d0 = acc[r][j][0] - m.x, d1 = acc[r][j][1] - m.y,
                        d2 = acc[r][j][2] - m.z, d3 = acc[r][j][3] - m.w;
            s.x = fmaf(d0, d0, s.x);
            s.y = fmaf(d1, d1, s.y);
            s.z = fmaf(d2, d2, s.z);
            s.w = fmaf(d3, d3, s.w);
          }
        }
        *reinterpret_cast<float4*>(red + rt * LCR + 4 * (j * HSU + up)) = s;
      }
    }
    __syncthreads();
    // the block's (mean, M2) go to every block of its unit slice, slot rg
    for (int col = tid; col < LC; col += nthr) {
      float m2 = 0.f, n = 0.f;
      for (int k = 0; k < NT; ++k) {
        m2 += red[k * LCR + col];
        n += red[k * LCR + LC];
      }
      const float2 part = make_float2(mb[col], m2);
      for (int p = 0; p < RG; ++p) {
        const int peer = p * US + us;
        reinterpret_cast<float2*>(cluster.map_shared_rank(xh, peer))[rg * LC + col] = part;
        if (col == 0) cluster.map_shared_rank(xn, peer)[(t & 1) * RG + rg] = n;
      }
    }
    PROBE(9)  // the BN_h block moments and their stores into the peers
    if (RG > 1) {
      cluster_barrier();
    } else {
      __syncthreads();
    }
    PROBE(10)  // cluster barrier 1

    // 3. the row groups' moments combined in order; gates, c' and BN_c's block moments
    prefetch_wait(t);  // xw[t] and its moments are down
    __syncthreads();
    float4* coef4 = reinterpret_cast<float4*>(coef);
    for (int col = tid; col < LC; col += nthr)
      coef4[col] = chan_combine(xh + 2 * col, 2 * LC, xn + (t & 1) * RG, RG);
    if (a.CPD > 1) {
      __syncthreads();
      PROBE(16)  // the BN_h combine of the cluster's row groups
      cross_cluster_combine(a, coef4, LC, 2 * LC + 2, 0, t, dir, cl, rg, us);
      PROBE(17)  // the BN_h exchange between the clusters
    }
    for (int col = tid; col < LC; col += nthr) {
      const float4 m = coef4[col];
      const int uu = col >> 2, g = col & 3;
      float4 cf = make_float4(0.f, 0.f, 0.f, 0.f);
      if (uu < nunits) {  // gate = (x - cf.x) * cf.y + (hw - cf.z) * cf.w + b
        const float2 xmv = reinterpret_cast<const float2*>(xm)[g * HS + uu];
        cf = make_float4(xmv.x, xmv.y * prm[col], m.y, bn_inv(m) * prm[LC + col]);
      }
      coef4[col] = cf;
    }
    __syncthreads();
    float nc[RT][UT], og[RT][UT];
    if (tile) {
#pragma unroll
      for (int j = 0; j < UT; ++j) {
        const int u = j * HSU + up;
        const float4* cf = reinterpret_cast<const float4*>(coef) + 4 * u;
        const float4 bs = reinterpret_cast<const float4*>(prm + 2 * LC)[u];
        const float4 c0 = cf[0], c1 = cf[1], c2 = cf[2], c3 = cf[3];
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float* x = xs + (r0 + r) * LC + u;
          const float gi = (x[0] - c0.x) * c0.y + (acc[r][j][0] - c0.z) * c0.w + bs.x;
          const float gg = (x[HS] - c1.x) * c1.y + (acc[r][j][1] - c1.z) * c1.w + bs.y;
          const float gf = (x[2 * HS] - c2.x) * c2.y + (acc[r][j][2] - c2.z) * c2.w + bs.z;
          const float go = (x[3 * HS] - c3.x) * c3.y + (acc[r][j][3] - c3.z) * c3.w + bs.w;
          nc[r][j] = sigm_fast(gf + 1.f) * cs[(r0 + r) * HS + u] + sigm_fast(gi) * tanh_fast(gg);
          og[r][j] = sigm_fast(go);
          if (act[r]) s += nc[r][j];
        }
        red[rt * LCR + u] = s;
      }
    }
    __syncthreads();
    for (int uu = tid; uu < HS; uu += nthr) {
      float s = 0.f, n = 0.f;
      for (int k = 0; k < NT; ++k) {
        s += red[k * LCR + uu];
        n += red[k * LCR + LC];
      }
      mb[uu] = n > 0.f ? __fdividef(s, n) : 0.f;
    }
    __syncthreads();
    if (tile) {
#pragma unroll
      for (int j = 0; j < UT; ++j) {
        const int u = j * HSU + up;
        const float m = mb[u];
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (act[r]) {
            const float dlt = nc[r][j] - m;
            s = fmaf(dlt, dlt, s);
          }
        }
        red[rt * LCR + u] = s;
      }
    }
    __syncthreads();
    for (int uu = tid; uu < HS; uu += nthr) {
      float m2 = 0.f;
      for (int k = 0; k < NT; ++k) m2 += red[k * LCR + uu];
      const float2 part = make_float2(mb[uu], m2);
      for (int p = 0; p < RG; ++p)
        reinterpret_cast<float2*>(cluster.map_shared_rank(xc, p * US + us))[rg * HS + uu] = part;
    }
    PROBE(11)  // the BN_h combine, the gates, c' and the BN_c block moments
    if (RG > 1) {
      cluster_barrier();
    } else {
      __syncthreads();
    }
    PROBE(12)  // cluster barrier 2

    // 4. BN_c combined (the active rows are BN_h's); h', c and the outputs; the
    //    new h into the block's own hs, then its slice to the row group's
    //    other blocks
    float4* mc = reinterpret_cast<float4*>(mb);  // the BN_c moments (mb's passes are over)
    for (int uu = tid; uu < HS; uu += nthr)
      mc[uu] = chan_combine(xc + 2 * uu, 2 * HS, xn + (t & 1) * RG, RG);
    if (a.CPD > 1) {
      __syncthreads();
      PROBE(18)  // the BN_c combine of the cluster's row groups
      cross_cluster_combine(a, mc, HS, 2 * LC + 2, 1, t, dir, cl, rg, us);
      PROBE(19)  // the BN_c exchange between the clusters
    }
    for (int uu = tid; uu < HS; uu += nthr) {
      const float4 m = mc[uu];
      cst[2 * uu] = m.y;
      cst[2 * uu + 1] = bn_inv(m) * prc[uu];
    }
    __syncthreads();
    if (RG == 1) cluster_wait();  // every product of the step has read h and its copies are down
    if (tile) {
#pragma unroll
      for (int j = 0; j < UT; ++j) {
        const int u = j * HSU + up;
        if (u >= nunits) continue;
        const float mean = cst[2 * u], inv = cst[2 * u + 1], oc = prc[HS + u];
        float* hcol = hs + (u0 + u) * RBP + r0;
#pragma unroll
        for (int r4 = 0; r4 < RT; r4 += 4) {
          float4 hv = *reinterpret_cast<const float4*>(hcol + r4);
          float* hp = reinterpret_cast<float*>(&hv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r4 + i;
            float v = 0.f;
            if (act[r]) {
              v = og[r][j] * tanh_fast((nc[r][j] - mean) * inv + oc);
              cs[(r0 + r) * HS + u] = nc[r][j];
              hp[i] = v;
            }
            if (r0 + r < nrows) d.out[((size_t)t * B + b0 + r0 + r) * H + u0 + u] = v;
          }
          *reinterpret_cast<float4*>(hcol + r4) = hv;
        }
      }
    }
    __syncthreads();
    if (tid == 0 && US > 1 && t + 1 < T) {
      fence_proxy_async();  // the block's h writes above, before the copies read them
      mbar_arrive_expect_tx(hbar, h_expect);
      if (nunits > 0) {
        for (int p = 0; p < US; ++p)
          if (p != us) bulk_copy_to_peer(hs + u0 * RBP, h_bytes, hbar, rg * US + p);
      }
    }
    PROBE(13)  // the BN_c combine, h', the outputs and the h copies into the peers
  }
}

using ClusterKernel = void (*)(const Args);

// cuTensorMapEncodeTiled, through the runtime (the library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// bnlstm_cluster_kernel<rt, ut> for the tiles 4 x 1, 8 x 1 and 8 x 2, nullptr
// otherwise
ClusterKernel cluster_kernel_for(int rt, int ut) {
  if (rt == 4 && ut == 1) return bnlstm_cluster_kernel<4, 1>;
  if (rt == 8 && ut == 1) return bnlstm_cluster_kernel<8, 1>;
  if (rt == 8 && ut == 2) return bnlstm_cluster_kernel<8, 2>;
  return nullptr;
}

// vec_*: one direction's b | scale_x | scale_h (4H each) | scale_c | offset_c
// (H each), 14H floats. scratch: dirs * T * 8H floats (the xw moments), and
// for the cooperative instance dirs * tiles * (10H + 2) more. bar: zeroed
// uint32, 2, and for a direction split over clusters (split > 1) the 64-bit
// words of the exchange after them, dirs * 4 * split * US * (2 * LC + 2).
// instance 0: cooperative, `rows` batch rows a block (a multiple of 8);
// instance 1: `split` clusters a direction, each of `cluster` blocks in
// `row_groups` row groups, a thread's tile `rows` x `units` of 4 x 1, 8 x 1
// or 8 x 2.
int launch(int dirs, const float* xw_f, const float* xw_b, const float* wh_f, const float* wh_b,
           const float* vec_f, const float* vec_b, const int* lens, float* out_f, float* out_b,
           float* scratch, unsigned* bar, int T, int B, int H, int instance, int cluster,
           int split, int row_groups, int rows, int units, int smem_bytes, void* stream) {
  const int G = 4 * H;
  if (H < 1 || H > MAX_H || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;

  Args a = {};
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
  a.T = T;
  a.B = B;
  a.H = H;

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const void* kernel = nullptr;
  int threads = 0;
  if (instance == 1) {
    kernel = (const void*)cluster_kernel_for(rows, units);
    // several clusters a direction exchange the moments their row groups have
    // combined, so they need more than one row group
    if (kernel == nullptr || cluster < 1 || cluster > MAX_CLUSTER || row_groups < 1 ||
        cluster % row_groups || split < 1 || split > MAX_SPLIT || (split > 1 && row_groups < 2))
      return (int)cudaErrorInvalidValue;
    a.RG = row_groups;
    a.US = cluster / row_groups;
    a.CPD = split;
    const Layout L = cluster_layout(H, B, a.RG, a.US, rows, units, split);
    a.cross = reinterpret_cast<unsigned long long*>(bar + 2);
    threads = ((L.HSU * L.NT + 31) / 32) * 32;
    if (threads > cluster_max_threads(rows, units) || smem_bytes < (int)sizeof(float) * L.floats)
      return (int)cudaErrorInvalidValue;
    const uintptr_t align = reinterpret_cast<uintptr_t>(xw_f) | reinterpret_cast<uintptr_t>(xw_b);
    a.vec = (H % 4 == 0 && L.HSL % 4 == 0 && (align & 15) == 0 && L.RB <= 256 && L.HSL <= 256 &&
             L.HS == L.HSL);
    if (a.vec) {
      const EncodeTiled encode = tensor_map_encoder();
      if (encode == nullptr) return (int)cudaErrorNotSupported;
      for (int i = 0; i < dirs; ++i) {
        // [T * B rows][4 gates][H units] of float32, a box of the block's share
        const cuuint64_t dims[3] = {(cuuint64_t)H, 4, (cuuint64_t)T * B};
        const cuuint64_t strides[2] = {(cuuint64_t)H * sizeof(float),
                                       (cuuint64_t)G * sizeof(float)};
        const cuuint32_t box[3] = {(cuuint32_t)L.HSL, 4, (cuuint32_t)L.RB};
        const cuuint32_t unit[3] = {1, 1, 1};
        const CUresult res = encode(&a.xmap[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                                    const_cast<float*>(xw[i]), dims, strides, box, unit,
                                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
      }
    }
  } else {
    if (rows < R || rows % R) return (int)cudaErrorInvalidValue;
    const int tiles = (B + rows - 1) / rows;
    a.rows = rows;
    a.part_h = a.xmom + (size_t)dirs * T * G * 2;
    a.part_c = a.part_h + (size_t)dirs * tiles * G * 2;
    a.cnt_h = a.part_c + (size_t)dirs * tiles * H * 2;
    a.cnt_c = a.cnt_h + (size_t)dirs * tiles;
    a.bar = bar;
    threads = min(((G + 31) / 32) * 32, 1024);
    if (smem_bytes < rows * (6 * H + 1) * (int)sizeof(float)) return (int)cudaErrorInvalidValue;
    int coop = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return (int)cudaErrorNotSupported;
    kernel = threads <= 512 ? (const void*)bnlstm_kernel<512, 1>
             : G <= 1024    ? (const void*)bnlstm_kernel<1024, 1>
                            : (const void*)bnlstm_kernel<1024, 2>;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (instance == 1) {
    if (cluster > 8) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    cfg.gridDim = dim3(cluster * split, dirs);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    // a cluster of this size must fit the card, and a direction's clusters,
    // which wait for each other, must all be resident at once
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < (split > 1 ? split * dirs : 1)) return (int)cudaErrorInvalidConfiguration;
  } else {
    // every block must be resident at once, or the barrier never completes
    const int tiles = (B + rows - 1) / rows;
    int per_sm = 0, sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    if ((long long)per_sm * sms < (long long)tiles * dirs)
      return (int)cudaErrorCooperativeLaunchTooLarge;
    cfg.gridDim = dim3(tiles, dirs);
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  }

  bnlstm_xmoments_kernel<<<dim3((G + 127) / 128, T, dirs), 128, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  void* params[] = {&a};
  err = cudaLaunchKernelExC(&cfg, kernel, params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef BNLSTM_PROBE
// Copies the phase clocks to dst[24] and sets them to 0.
int bnlstm_probe_read(long long* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, bnlstm_probe_clocks, sizeof(long long) * 24);
  if (err != cudaSuccess) return (int)err;
  const long long zero[24] = {0};
  return (int)cudaMemcpyToSymbol(bnlstm_probe_clocks, zero, sizeof(zero));
}
#endif

// How many clusters of `cluster` blocks of the cluster kernel (the instance
// with `rows` x `units` a thread, `threads` threads, `smem_bytes` of dynamic
// shared memory) the card holds at once, in *count; returns a CUDA error code.
int bnlstm_active_clusters(int cluster, int rows, int units, int threads, int smem_bytes,
                           int* count) {
  const void* kernel = (const void*)cluster_kernel_for(rows, units);
  if (kernel == nullptr || cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
}

// xw_*: [T, B, 4H] float32 (no bias), wh_*: [H, 4H], vec_*: [14H] (see
// launch), lens: [B] int32, out_*: [T, B, H], scratch: floats and bar: zeroed
// uint32 (see launch). H <= 512. The geometry comes from the caller
// (ops/bnlstm.py:geometry): instance (0 cooperative, 1 cluster), cluster size,
// clusters a direction, row groups of a cluster, rows (a block's for the
// cooperative instance, a thread's for the cluster one), units (a thread's, in
// the cluster instance) and the dynamic shared memory of a block. Returns a
// CUDA error code, with nothing launched when the geometry does not fit the
// card.
int bibnlstm_launch(const float* xw_f, const float* xw_b, const float* wh_f, const float* wh_b,
                    const float* vec_f, const float* vec_b, const int* lens, float* out_f,
                    float* out_b, float* scratch, unsigned* bar, int T, int B, int H, int instance,
                    int cluster, int split, int row_groups, int rows, int units, int smem_bytes,
                    void* stream) {
  return launch(2, xw_f, xw_b, wh_f, wh_b, vec_f, vec_b, lens, out_f, out_b, scratch, bar, T, B,
                H, instance, cluster, split, row_groups, rows, units, smem_bytes, stream);
}

int bnlstm_launch(const float* xw, const float* wh, const float* vec, const int* lens, float* out,
                  float* scratch, unsigned* bar, int T, int B, int H, int instance, int cluster,
                  int split, int row_groups, int rows, int units, int smem_bytes, void* stream) {
  return launch(1, xw, xw, wh, wh, vec, vec, lens, out, out, scratch, bar, T, B, H, instance,
                cluster, split, row_groups, rows, units, smem_bytes, stream);
}

}  // extern "C"
