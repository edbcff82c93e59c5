// One LSTM layer for inference, the whole T-step recurrence in one launch: both
// directions (bilstm_launch) or one (lstm_launch), through the same kernel.
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
// product, but the T steps are sequential, so the kernel is bound by per-step
// latency, not by the card's peak rate. One direction's wh is 128 x 512
// float32 = 256 KB, more than the 227 KB of shared memory a block may use.
//
// The design is that of the training forward (csrc/lstm_grad.cu:lstm_fwd_kernel)
// without its residuals. A thread-block CLUSTER owns a tile of R batch rows of
// one direction, and block j of the cluster holds the columns of the hidden units
// [j * HS, (j + 1) * HS) of all four gates, [H, 4 * HS] float32, in its shared
// memory, loaded once per launch: no weight traffic is left in the T-step loop.
// A block finishes c' and h' for its own units with no exchange (c and h of its
// elements stay in registers), then stores its slice of the new h into its own
// and its peers' shared memory (distributed shared memory), double-buffered by
// step parity, so ONE split cluster barrier a step is enough; the out stores go
// between its arrive and its wait. xw[t + 1] arrives by cp.async into a
// double-buffered tile while step t computes. One thread per gate column keeps R
// accumulators in registers, reads its weight from shared memory and h as float4
// broadcasts along k, and adds the k terms in order with fmaf from xw[t], so the
// bits do not depend on the geometry (fused and single launches agree bit for
// bit). The grid holds the clusters of both directions (gridDim.y = dirs), so
// the fused layer is one launch. The wrapper chooses the cluster size and the
// rows per tile (ops/lstm_grad.py:cluster_geometry): at B = 400, H = 128 a
// cluster of 2 with 13 rows puts both directions on 124 SMs, one wave.
//
// Above H ~ 330 no cluster of at most 8 blocks holds the slices (at H = 384 a
// block's slice is 295 KB, at H = 512 512 KB). There the WG variant of the
// same kernel reads each block's slice from device memory instead (L2 holds a
// direction's 1-4 MB), laid out by the wrapper exactly as it would lie in
// shared memory ([cluster][HP][LC]), so the product's addresses, its order of
// sums and its bits are those of the resident kernel. H <= 512: a block holds
// at most 64 hidden units (4 * HS <= 256 threads) and a cluster 8 blocks.
//
// bf16 inference mode (the JAX kernels stream bf16 xw and write bf16 h): the
// kernel is a template on XT, the element type of xw and out, with a float32
// and a bfloat16 instance. The bf16 instance keeps the xw tiles in shared memory
// as bf16 (half the bytes) and converts each element to float32 where it starts a
// column's k sum; c, h, the shared h broadcast, wh and the product stay float32,
// and only the out store rounds, to nearest even. So on bf16 xw it equals the
// float32 instance on the same xw upcast, with out rounded afterwards, bit for
// bit. The two instances are built into two libraries, in parallel (this file
// with -DLSTM_XW_BF16 is the bf16 one: ops/cuda_build.py), which halves the
// build's wall time against one file with both (63 s measured on an H100's
// host). The prefetch copies xw in one of three ways (the launcher picks by shape and
// alignment): 16-byte chunks (4 float32 or 8 bf16 elements of one gate's run of
// the block's units), 4-byte chunks (one float32 or two bf16 elements; a thread
// a column, or a pair of columns), or, for bf16 where H or the slice is odd or
// xw is only 2-byte aligned, one element at a time through registers (a plain
// load that the thread waits for before the block barrier).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;   // one per gate column of a block's slice: 4 * HS <= 256
constexpr int MAX_ROWS = 16;   // batch rows of a tile, a template parameter 1..16
constexpr int EPT = 4;         // (row, unit) elements and 16-byte xw chunks a thread: R * HS <= 4 * THREADS

// how the prefetch copies a step's xw tile (see the head of the file)
constexpr int COPY_ELEMENTS = 0;  // one element at a time, through registers (bf16 only)
constexpr int COPY_4B = 1;        // 4-byte cp.async: one float32 or two bf16 a copy
constexpr int COPY_16B = 2;       // 16-byte cp.async: four float32 or eight bf16 a copy
constexpr int K_UNROLL = 4;    // k loop of the product: 16 weights and 4R h reads in flight

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename XT>
__device__ __forceinline__ XT from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// Bytes of dynamic shared memory of one block: wh slice [HP][LC] (not with
// wh_global), h [2][R][HP] and gate pre-activations [R][LC] in float32, xw tiles
// [2][R][LC] of xw_bytes each, and 2R ints of windows; HP = H rounded up to 4,
// LC = 4 * HS.
inline int infer_smem_bytes(int H, int HS, int R, bool wh_global, int xw_bytes) {
  const int HP = (H + 3) & ~3, LC = 4 * HS;
  return (int)sizeof(float) * ((wh_global ? 0 : HP * LC) + 2 * R * HP + R * LC) +
         xw_bytes * 2 * R * LC + 2 * (int)sizeof(int) * R;
}

// tools/kernel_probe.py builds this file with -DLSTM_PROBE: thread 0 of block
// (0, 0) then adds up the clocks it spends in each phase of a step.
#ifdef LSTM_PROBE
__device__ long long infer_probe_clocks[8];
#define PROBE_INIT long long probe_last = clock64();
#define PROBE(i)                                                       \
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {        \
    const long long now = clock64();                                   \
    infer_probe_clocks[i] += now - probe_last;                         \
    probe_last = now;                                                  \
  }
#else
#define PROBE_INIT
#define PROBE(i)
#endif

template <typename XT, int R, bool WG>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_infer_kernel(const XT* __restrict__ xw_f, const XT* __restrict__ xw_b,
                      const float* __restrict__ wh_f, const float* __restrict__ wh_b,
                      const int* __restrict__ lens, const int* __restrict__ starts_f,
                      const int* __restrict__ starts_b, XT* __restrict__ out_f,
                      XT* __restrict__ out_b, int T, int B, int H, int HS, int copy) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int dir = blockIdx.y;  // 0 forward, 1 backward (flipped input)
  const XT* xw = dir == 0 ? xw_f : xw_b;
  const float* wh = dir == 0 ? wh_f : wh_b;
  const int* starts = dir == 0 ? starts_f : starts_b;  // null: every row starts at 0
  XT* out = dir == 0 ? out_f : out_b;
  const int b0 = (blockIdx.x / CS) * R;
  const int HP = (H + 3) & ~3;
  const int LC = 4 * HS;
  const int G = 4 * H;
  const int u0 = rank * HS;                      // first hidden unit of this block
  const int hs = max(0, min(HS, H - u0));        // its units (the last slice may be ragged)
  const int tid = threadIdx.x;

  float* ws = smem;                 // [HP][LC] wh[:, gate * H + u0 + u] at column gate * HS + u
  float* h_s = ws + (WG ? 0 : HP * LC);  // [2][R][HP] the whole h of the tile, by step parity
  float* g_s = h_s + 2 * R * HP;    // [R][LC] gate pre-activations
  XT* xs = reinterpret_cast<XT*>(g_s + R * LC);  // [2][R][LC] xw tiles, by step parity
  int* lo_s = reinterpret_cast<int*>(xs + 2 * R * LC);  // [R] window start
  int* hi_s = lo_s + R;                                 // [R] window end

  if constexpr (!WG) {
    for (int i = tid; i < HP * LC; i += THREADS) {
      const int k = i / LC, lc = i - k * LC;
      const int gate = lc / HS, u = lc - gate * HS;
      ws[i] = (k < H && u < hs) ? wh[(size_t)k * G + gate * H + u0 + u] : 0.f;
    }
  }
  for (int i = tid; i < 2 * R * HP; i += THREADS) h_s[i] = 0.f;
  for (int i = tid; i < 2 * R * LC; i += THREADS) xs[i] = from_float<XT>(0.f);  // padding stays 0
  if (tid < R) {
    const int b = b0 + tid;
    const int len = b < B ? lens[b] : 0;
    const int st = (b < B && starts != nullptr) ? starts[b] : 0;
    lo_s[tid] = st;
    hi_s[tid] = st + len;
  }

  // This thread's share of one xw tile, the same at every step. COPY_16B: 16-byte
  // chunks of CE elements (runs of HS / CE per row and gate) spread over all
  // threads: offsets in the tile and in xw[t], -1 for none. Otherwise the thread's
  // own group of PE columns (PE elements in 4 bytes: COPY_4B; one column:
  // COPY_ELEMENTS), row by row: xw_col is the group's offset in xw[t] for row b0,
  // -1 for none.
  constexpr int CE = 16 / (int)sizeof(XT);
  const int PE = copy == COPY_4B ? 4 / (int)sizeof(XT) : 1;
  int xw_dst[EPT], xw_src[EPT], xw_col;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    xw_dst[i] = -1;
    xw_src[i] = 0;
    if (copy == COPY_16B) {
      const int q = HS / CE;
      const int e = tid + i * THREADS;
      const int r = e / (4 * q);
      const int rem = e - r * 4 * q;
      const int gate = rem / q;
      const int u = (rem - gate * q) * CE;
      if (r < R && b0 + r < B && u < hs) {
        xw_dst[i] = r * LC + gate * HS + u;
        xw_src[i] = (b0 + r) * G + gate * H + u0 + u;
      }
    }
  }
  {
    const int lc = tid * PE;
    const int gate = lc / HS, u = lc - gate * HS;
    xw_col = (copy != COPY_16B && lc < LC && u < hs) ? b0 * G + gate * H + u0 + u : -1;
  }
  auto prefetch = [&](int t) {
    XT* dst = xs + (t & 1) * R * LC;
    const XT* src = xw + (size_t)t * B * G;
    if (copy == COPY_16B) {
#pragma unroll
      for (int i = 0; i < EPT; ++i)
        if (xw_dst[i] >= 0) cp_async16(dst + xw_dst[i], src + xw_src[i]);
    } else if (xw_col >= 0) {
      const int lc = tid * PE;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (b0 + r >= B) continue;
        if (copy == COPY_4B)
          cp_async4(dst + r * LC + lc, src + xw_col + r * G);
        else
          dst[r * LC + lc] = src[xw_col + r * G];
      }
    }
    cp_async_commit();
  };

  __syncthreads();  // the zeros and the windows are down before any cp.async lands
  prefetch(0);
  cp_async_wait_all();
  cluster.sync();  // every block of the cluster is initialised before a peer writes into it

  // this thread's (row, unit) elements of the gate stage, the same at every
  // step, with their window and their c and h
  int el_r[EPT], el_u[EPT], el_lo[EPT], el_hi[EPT];
  float c_reg[EPT], h_reg[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / HS;
    el_u[i] = e - r * HS;
    el_r[i] = (r < R && el_u[i] < hs) ? r : -1;
    el_lo[i] = el_r[i] >= 0 ? lo_s[r] : 0;
    el_hi[i] = el_r[i] >= 0 ? hi_s[r] : 0;
    c_reg[i] = 0.f;
    h_reg[i] = 0.f;
  }

  PROBE_INIT
  for (int t = 0; t < T; ++t) {
    const float* h_cur = h_s + (t & 1) * R * HP;
    float* h_next = h_s + ((t + 1) & 1) * R * HP;

    // pre-activations of this thread's column: xw[t] + h @ wh, k in order
    if (tid < LC) {
      const XT* xt = xs + (t & 1) * R * LC + tid;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = to_float(xt[r * LC]);
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
    PROBE(0)  // the product
    if (t + 1 < T) prefetch(t + 1);
    __syncthreads();
    PROBE(1)  // the prefetch's start and the block barrier

    // gates, c', h' of this block's units; the new h goes to every block of the cluster
    float v_out[EPT];
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      v_out[i] = 0.f;
      if (el_r[i] < 0) continue;
      const int r = el_r[i], u = el_u[i];
      const float* g = g_s + r * LC + u;
      const float ig = sigm(g[0]);
      const float gg = tanhf(g[HS]);
      const float fg = sigm(g[2 * HS] + 1.f);
      const float og = sigm(g[3 * HS]);
      const float nc = fg * c_reg[i] + ig * gg;
      const float nh = og * tanhf(nc);
      const bool active = t >= el_lo[i] && t < el_hi[i];
      if (active) {
        c_reg[i] = nc;
        h_reg[i] = nh;
        v_out[i] = nh;
      }
      float* slot = h_next + r * HP + u0 + u;
      for (int p = 0; p < CS; ++p) *cluster.map_shared_rank(slot, p) = h_reg[i];
    }
    PROBE(2)  // the gate stage and the stores of h into the cluster
    cp_async_wait_all();  // xw[t + 1] is down: the barrier below publishes it too
    cluster_arrive();
    // the outputs leave while the cluster gathers
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      if (el_r[i] < 0 || b0 + el_r[i] >= B) continue;
      out[((size_t)t * B + b0 + el_r[i]) * H + u0 + el_u[i]] = from_float<XT>(v_out[i]);
    }
    PROBE(3)  // the wait for xw[t + 1], the barrier's arrive and the out stores
    cluster_wait();
    PROBE(4)  // the barrier's wait
  }
}

// the element type of xw and out that this library's instance streams
#ifdef LSTM_XW_BF16
using XW = __nv_bfloat16;
#else
using XW = float;
#endif

template <typename XT>
using InferKernel = void (*)(const XT*, const XT*, const float*, const float*, const int*,
                             const int*, const int*, XT*, XT*, int, int, int, int, int);

// lstm_infer_kernel<XT, rows, wh_global> for rows in 1..R, nullptr otherwise
template <typename XT, int R>
InferKernel<XT> kernel_for_rows(int rows, bool wh_global) {
  if (rows == R)
    return wh_global ? lstm_infer_kernel<XT, R, true> : lstm_infer_kernel<XT, R, false>;
  if constexpr (R > 1) return kernel_for_rows<XT, R - 1>(rows, wh_global);
  return nullptr;
}

template <typename XT>
int launch(int dirs, const XT* xw_f, const XT* xw_b, const float* wh_f, const float* wh_b,
           const int* lens, const int* starts_f, const int* starts_b, XT* out_f, XT* out_b,
           int T, int B, int H, int rows, int cluster, int smem_bytes, int wh_global,
           void* stream) {
  if (cluster < 1 || cluster > 8 || (cluster & (cluster - 1)) || H < 1 || T < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const InferKernel<XT> kernel = kernel_for_rows<XT, MAX_ROWS>(rows, wh_global != 0);
  const int HS = (H + cluster - 1) / cluster;
  const int need = infer_smem_bytes(H, HS, rows, wh_global != 0, (int)sizeof(XT));
  if (kernel == nullptr || 4 * HS > THREADS || rows * HS > EPT * THREADS || smem_bytes < need)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  // the widest copy that the shape and the pointers allow (see the head of the file);
  // xw_b is null for one direction
  const uintptr_t align = reinterpret_cast<uintptr_t>(xw_f) | reinterpret_cast<uintptr_t>(xw_b);
  constexpr int CE = 16 / (int)sizeof(XT), PE = 4 / (int)sizeof(XT);
  const int copy = (H % CE == 0 && HS % CE == 0 && (align & 15) == 0) ? COPY_16B
                   : (H % PE == 0 && HS % PE == 0 && (align & 3) == 0) ? COPY_4B
                                                                        : COPY_ELEMENTS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((B + rows - 1) / rows) * cluster, dirs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xw_f, xw_b, wh_f, wh_b, lens, starts_f, starts_b, out_f,
                           out_b, T, B, H, HS, copy);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef LSTM_PROBE
// Copies the phase clocks to dst[8] and sets them to 0.
int infer_probe_read(long long* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, infer_probe_clocks, sizeof(long long) * 8);
  if (err != cudaSuccess) return (int)err;
  const long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(infer_probe_clocks, zero, sizeof(zero));
}
#endif

// xw_*: [T, B, 4H], out_*: [T, B, H], both float32, or bfloat16 in the
// library built with -DLSTM_XW_BF16 (bf16 must say which: a call for the other
// element type returns cudaErrorInvalidValue); wh_*: [H, 4H] float32,
// lens/starts: [B] int32. 1 <= H <= 512. The geometry
// comes from the caller: rows of a batch tile (1..16), blocks of a cluster (1, 2,
// 4 or 8, each holding ceil(H / cluster) <= 64 hidden units), the dynamic shared
// memory of a block, and wh_global: wh_* are then [cluster][HP][4 * HS] slices
// read from device memory (HP = H rounded up to 4, HS = ceil(H / cluster), zero
// padded).
int bilstm_launch(const void* xw_f, const void* xw_b, const float* wh_f, const float* wh_b,
                  const int* lens, const int* starts, void* out_f, void* out_b, int T, int B,
                  int H, int rows, int cluster, int smem_bytes, int wh_global, int bf16,
                  void* stream) {
  if ((bf16 != 0) != (sizeof(XW) == 2)) return (int)cudaErrorInvalidValue;
  return launch(2, static_cast<const XW*>(xw_f), static_cast<const XW*>(xw_b), wh_f, wh_b, lens,
                nullptr, starts, static_cast<XW*>(out_f), static_cast<XW*>(out_b), T, B, H, rows,
                cluster, smem_bytes, wh_global, stream);
}

// One direction; starts may be null (every row's window is [0, len)).
int lstm_launch(const void* xw, const float* wh, const int* lens, const int* starts, void* out,
                int T, int B, int H, int rows, int cluster, int smem_bytes, int wh_global,
                int bf16, void* stream) {
  if ((bf16 != 0) != (sizeof(XW) == 2)) return (int)cudaErrorInvalidValue;
  return launch(1, static_cast<const XW*>(xw), static_cast<const XW*>(nullptr), wh, nullptr,
                lens, starts, nullptr, static_cast<XW*>(out), static_cast<XW*>(nullptr), T, B, H,
                rows, cluster, smem_bytes, wh_global, stream);
}

}  // extern "C"
