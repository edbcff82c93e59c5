// One GRU layer for inference, the whole T-step recurrence in one launch: both
// directions (bigru_launch) or one (gru_launch), through the same kernel.
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
// [B, H] x [H, H] products, but the T steps are sequential and each step has
// two dependent products (the candidate needs the whole row of r * h, the
// next step the whole h), so the kernel is bound by the latency of a step, not
// by the card's peak rate. A direction's recurrent weights are 3H^2 floats:
// 196,608 bytes at H = 128, which fit ONE block's 232,448 bytes of shared
// memory. So, unlike the LSTM (4H^2, a cluster of 2), no cluster is needed.
//
// One block owns a tile of 8 batch rows of one direction and keeps the
// direction's whg and whc in its shared memory for the whole launch (the
// resident instance), with the tile's h and r * h. The products run on the
// tensor cores as mma.sync m16n8k8 TF32 with the output columns as M (16
// hidden units of one gate), the k as K and the tile's 8 rows as N: the
// weights are the A operand, packed by the wrapper in fragment order (one
// float4 a lane, [gate][unit tile][k step][lane]), h (or r * h) the B operand.
// A CUDA-core product at this size is bound by shared memory's delivery of
// operands to the lanes (~128 bytes a clock: every FMA needs its h and its
// weight in a register, and with 8 rows a block a thread's tile cannot reuse
// them enough); an MMA takes 16 x 8 weights and 8 x 8 h for 1,024 FMA. The
// results stay float32-grade as in conv_bn.cu (3xTF32): each operand is split
// into a TF32 head and its tail; head*head of each k step
// runs from a zero accumulator (the tensor cores add with truncation) and the
// k steps are summed in order with float32 adds onto gx (or cx); head*tail and
// tail*head, ~2^-11 of it, run through all k steps in accumulators of their
// own and are added at the end.
//
// A warp owns one unit tile (two in the WG variant below): for each, its r,
// u and candidate m-tiles, whose accumulator fragments cover the same (unit, row) elements,
// so the gates, r * h, u and the update stay in the thread that owns the
// element, with no exchange. A step is: the gate product, the gates and r * h
// into shared memory, a block barrier, the candidate product, the update and
// the output stores, a block barrier: two __syncthreads and no cluster
// barrier. Each thread loads its own elements of gx[t + 1] and cx[t + 1] into
// registers after step t's first barrier, in flight while the candidate
// product runs (a stage in shared memory filled by cp.async, after the barrier
// or at the head of the step, took 8-10% longer a step at H = 128: its writes
// and reads meet the products' operand traffic there). The activations are
// branch-free (expf and __fdividef).
//
// The resident instance gathers its fragments from whg and whc into shared
// memory once a launch. Where they do not fit a block (H above 128: 3 gates x
// 9 unit tiles of 16 x 20 k steps of 8 are 276,480 bytes), the WG variant of
// the same kernel reads the same fragments, packed by the wrapper, from device
// memory (L2 holds a direction's 0.3-3 MB), with the same order of sums.
// Each output's sum is one thread's chain, k step by k step in order,
// whatever the tile, the warps or the variant: the fused layer equals two
// single launches bit for bit, either instance the other, and a run the
// next. The wrapper packs the weights for the WG variant
// (ops/gru.py:pack_weights) and chooses the instance and geometry before the
// launch (ops/gru.py:geometry).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigm_fast(float x) { return __fdividef(1.f, 1.f + expf(-x)); }
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, 1.f + expf(2.f * x));
}

// x = head + tail in two operations: head x with its low 13 bits cleared (a
// TF32 value), tail the float32 rest (exact), which the tensor cores read as
// TF32 by dropping its low bits: 2^-20 of x at most, as is the tail * tail
// term the products leave out
__device__ __forceinline__ void split_tf32(float x, uint32_t& head, uint32_t& tail) {
  head = __float_as_uint(x) & 0xffffe000u;
  tail = __float_as_uint(x - __uint_as_float(head));
}

// d = a * b, from a zero accumulator
__device__ __forceinline__ void mma_first(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  const float z = 0.f;
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(z));
}

// d += a * b
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split4(const float4 v, uint32_t (&h)[4], uint32_t (&t)[4]) {
  split_tf32(v.x, h[0], t[0]);
  split_tf32(v.y, h[1], t[1]);
  split_tf32(v.z, h[2], t[2]);
  split_tf32(v.w, h[3], t[3]);
}

// tools/kernel_probe.py builds this file with -DGRU_PROBE: thread 0 of block
// (0, 0) then adds up the clocks it spends in each phase of a step.
#ifdef GRU_PROBE
__device__ long long gru_probe_clocks[16];
#define PROBE_INIT long long probe_last = clock64();
#define PROBE(i)                                                       \
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {        \
    const long long now = clock64();                                   \
    gru_probe_clocks[i] += now - probe_last;                           \
    probe_last = now;                                                  \
  }
#else
#define PROBE_INIT
#define PROBE(i)
#endif

// The packed weights of one direction: 3 gates x UTL unit tiles x KS k steps
// x 32 lanes float4 (UTL = H / 16 rounded up; KS = H / 8 rounded up to a
// multiple of 4, so that the k loop runs in unrolled groups of 4; zero
// padded). Dynamic shared memory of one block: the weights (not with WG), h
// and r * h [R][HS] floats each (HS = 8 * KS + 4: B fragment reads hit 32
// banks), and the rows' windows.
constexpr int R = 8;  // batch rows of a block: the n of one m16n8k8 tile
__host__ __device__ inline int k_steps(int H) { return 4 * ((H + 31) / 32); }

inline long smem_bytes_for(int H, bool wg) {
  const long utl = (H + 15) / 16, ks = k_steps(H);
  return (wg ? 0 : 3 * utl * ks * 32 * 16) + 2L * R * (8 * ks + 4) * 4 + 2L * R * 4;
}

// the WG variant runs in blocks of up to 512 threads (128 registers a thread, H
// up to 512), the resident one in blocks of up to 256 (it holds H <= 128: 8
// unit tiles)
constexpr int max_threads(bool wg) { return wg ? 512 : 256; }

// WG: the packed weights read from device memory. A warp owns one unit tile of
// the resident instance (H <= 128: up to 8 warps) and two of the WG variant
// (warp w owns w and w + warps: up to 16 warps at H = 512).
template <bool WG>
__global__ void __launch_bounds__(max_threads(WG), 1)
gru_kernel(const float* __restrict__ gx_f, const float* __restrict__ cx_f,
           const float* __restrict__ gx_b, const float* __restrict__ cx_b,
           const float* __restrict__ whg_f, const float* __restrict__ whc_f,
           const float* __restrict__ whg_b, const float* __restrict__ whc_b,
           const float4* __restrict__ w_f, const float4* __restrict__ w_b,
           const int* __restrict__ lens, const int* __restrict__ starts_f,
           const int* __restrict__ starts_b, float* __restrict__ out_f,
           float* __restrict__ out_b, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  constexpr int UPW = WG ? 2 : 1;  // unit tiles a warp
  const int dir = blockIdx.y;  // 0 forward, 1 backward (flipped input)
  const float* gx = dir == 0 ? gx_f : gx_b;
  const float* cx = dir == 0 ? cx_f : cx_b;
  const float* whg = dir == 0 ? whg_f : whg_b;
  const float* whc = dir == 0 ? whc_f : whc_b;
  const float4* wp = dir == 0 ? w_f : w_b;  // the packed fragments (WG only)
  const int* starts = dir == 0 ? starts_f : starts_b;  // null: every row starts at 0
  float* out = dir == 0 ? out_f : out_b;
  const int UTL = (H + 15) / 16, KS = k_steps(H), HS = 8 * KS + 4, G = 2 * H;
  const int b0 = blockIdx.x * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // fragment coordinates

  float4* w_s = reinterpret_cast<float4*>(smem);
  float* h_s = smem + (WG ? 0 : 3 * UTL * KS * 32 * 4);  // [R][HS]
  float* rh_s = h_s + R * HS;                             // [R][HS] r * h
  int* lo_s = reinterpret_cast<int*>(rh_s + R * HS);
  int* hi_s = lo_s + R;

  if constexpr (!WG) {
    // the A fragments from whg and whc, once a launch: for (gate, unit tile, k
    // step, lane) the float4 W[k][u], W[k][u + 1], W[k + 4][u], W[k + 4][u + 1]
    // with k = 8 * step + lane % 4, u = 16 * tile + 2 * (lane / 4) (fragment
    // rows g and g + 8; ops/gru.py:pack_weights lays out the same values for
    // the WG variant). Read along the units (coalesced), written to the slots.
    float* wf = smem;
    const int UP = 16 * UTL, KP = 8 * KS;
    for (int i = tid; i < 3 * KP * UP; i += blockDim.x) {
      const int u = i % UP, k = (i / UP) % KP, gate = i / (UP * KP);
      float v = 0.f;
      if (k < H && u < H)
        v = gate < 2 ? whg[(size_t)k * G + gate * H + u] : whc[(size_t)k * H + u];
      const int m = ((u & 15) >> 1) + 8 * (u & 1), kk = k & 7;
      const int slot = ((gate * UTL + u / 16) * KS + k / 8) * 32 + (m & 7) * 4 + (kk & 3);
      wf[4 * slot + (m >> 3) + 2 * (kk >> 2)] = v;
    }
  }
  for (int i = tid; i < 2 * R * HS; i += blockDim.x) h_s[i] = 0.f;
  if (tid < R) {
    const int b = b0 + tid;
    const int len = b < B ? lens[b] : 0;
    const int st = (b < B && starts != nullptr) ? starts[b] : 0;
    lo_s[tid] = st;
    hi_s[tid] = st + len;
  }
  __syncthreads();
  const float4* wa = WG ? wp : w_s;

  // The thread's elements: for each of its unit tiles p, the accumulator
  // fragment's (row m, column) pairs e = 0..3, m = g (+8 for e >= 2), column
  // 2 * t4 (+1 for odd e), are the (unit, row) pairs unit[p][e >> 1], row
  // 2 * t4 + (e & 1). Fragment row m holds the tile's unit
  // 2 * (m % 8) + m / 8, so the thread's two units lie side by side and move
  // as one float2 (`pair`: both real, H even). A padded unit tile (ut >= UTL)
  // or unit (>= H) computes zeros and stores nothing.
  int unit[UPW][2];
  bool own[UPW][2], pair[UPW];
#pragma unroll
  for (int p = 0; p < UPW; ++p) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = 16 * (warp + p * warps) + 2 * g + s;
      own[p][s] = j < H;
      unit[p][s] = own[p][s] ? j : 0;
    }
    pair[p] = own[p][1] && (H & 1) == 0;
  }

  // the windows of the thread's rows 2 * t4 + o
  int lo[2], hi[2];
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    lo[o] = lo_s[2 * t4 + o];
    hi[o] = hi_s[2 * t4 + o];
  }

  // stores v0 (unit[p][0]) and v1 (unit[p][1]) at row offset `at` of an array
  // with the units along its rows: one float2 for a pair, else each it owns
  auto store2 = [&](float* at, int p, float v0, float v1) {
    if (pair[p]) {
      *reinterpret_cast<float2*>(at + unit[p][0]) = make_float2(v0, v1);
    } else {
      if (own[p][0]) at[unit[p][0]] = v0;
      if (own[p][1]) at[unit[p][1]] = v1;
    }
  };
  // this step's gx (r, u) and cx of the thread's elements, loaded a step ahead
  float gxv[UPW][4][2], cxv[UPW][4];
  auto load = [&](int t) {
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int b = b0 + 2 * t4 + o;
      const bool in = b < B;
      const float* gr = gx + ((size_t)t * B + (in ? b : 0)) * G;
      const float* cr = cx + ((size_t)t * B + (in ? b : 0)) * H;
#pragma unroll
      for (int p = 0; p < UPW; ++p) {
        const int j = unit[p][0];
        if (pair[p]) {
          const float2 z = make_float2(0.f, 0.f);
          const float2 r = in ? __ldg(reinterpret_cast<const float2*>(gr + j)) : z;
          const float2 u = in ? __ldg(reinterpret_cast<const float2*>(gr + H + j)) : z;
          const float2 c = in ? __ldg(reinterpret_cast<const float2*>(cr + j)) : z;
          gxv[p][o][0] = r.x, gxv[p][o + 2][0] = r.y;
          gxv[p][o][1] = u.x, gxv[p][o + 2][1] = u.y;
          cxv[p][o] = c.x, cxv[p][o + 2] = c.y;
        } else {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const bool ok = in && own[p][s];
            const int e = o + 2 * s, js = unit[p][s];
            gxv[p][e][0] = ok ? __ldg(gr + js) : 0.f;
            gxv[p][e][1] = ok ? __ldg(gr + H + js) : 0.f;
            cxv[p][e] = ok ? __ldg(cr + js) : 0.f;
          }
        }
      }
    }
  };
  load(0);

  // acc[p][q] += the product of gate gate0 + q's unit tile of p with the B
  // operand `src` ([R][HS]); two gates at once share B. Per k step the main
  // term head * head runs from a zero accumulator and is added in float32 in
  // k order; the two small terms tail * head and head * tail (<= 2^-10 of it)
  // run through the k steps in accumulators of their own, added at the end:
  // no MMA waits for another of its k step.
  // k steps unrolled in groups of KG, KU groups: all 16 k steps of H = 128
  // with one unit tile a warp (the more MMAs in flight, the faster: 4 / 8 / 16
  // k steps took 1.55 / 1.44 / 1.38 ms at T = B = 400, H = 128, both
  // directions, on an H100), fewer where the registers hold two unit tiles
  // (blocks of 512 threads have 128 registers a thread)
  constexpr int KG = WG ? 2 : 4;
  constexpr int KU = WG ? 1 : 4;
  auto product = [&](float (&acc)[UPW][2][4], const float* src, int gate0, int gates) {
#pragma unroll
    for (int p = 0; p < UPW; ++p) {
      const int ut = warp + p * warps;
      if (ut >= UTL) continue;
      float small[2][2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) small[q][0][e] = small[q][1][e] = 0.f;
#pragma unroll KU
      for (int ks0 = 0; ks0 < KS; ks0 += KG)
#pragma unroll
      for (int ks = ks0; ks < ks0 + KG; ++ks) {
        uint32_t bh[2], bt[2];
        const float* row = src + g * HS + 8 * ks + t4;
        split_tf32(row[0], bh[0], bt[0]);
        split_tf32(row[4], bh[1], bt[1]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q >= gates) break;
          uint32_t ah[4], at[4];
          split4(wa[(((gate0 + q) * UTL + ut) * KS + ks) * 32 + lane], ah, at);
          float d[4];
          mma_first(d, ah, bh);
          mma_acc(small[q][0], at, bh);
          mma_acc(small[q][1], ah, bt);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][q][e] += d[e];
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= gates) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][q][e] += small[q][0][e] + small[q][1][e];
      }
    }
  };

  PROBE_INIT
  for (int t = 0; t < T; ++t) {
    // 1. the gates r and u: gx[t] + h @ whg
    float acc[UPW][2][4];
#pragma unroll
    for (int p = 0; p < UPW; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[p][0][e] = gxv[p][e][0];
        acc[p][1][e] = gxv[p][e][1];
      }
    product(acc, h_s, 0, 2);
    PROBE(8)  // the gate product
    // branch-free over the thread's elements, so that their chains interleave
    float uv[UPW][4], hv_own[UPW][4];
#pragma unroll
    for (int p = 0; p < UPW; ++p)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        // unit[p][0] is even; its neighbour lies in the row's padding where
        // it is not the thread's, so the float2 stays inside h_s
        const float2 hv =
            *reinterpret_cast<const float2*>(h_s + (2 * t4 + o) * HS + unit[p][0]);
        hv_own[p][o] = hv.x;
        hv_own[p][o + 2] = hv.y;
      }
#pragma unroll
    for (int p = 0; p < UPW; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uv[p][e] = sigm_fast(acc[p][1][e]);
        acc[p][0][e] = sigm_fast(acc[p][0][e]) * hv_own[p][e];
      }
#pragma unroll
    for (int p = 0; p < UPW; ++p)
#pragma unroll
      for (int o = 0; o < 2; ++o)
        store2(rh_s + (2 * t4 + o) * HS, p, acc[p][0][o], acc[p][0][o + 2]);
    PROBE(9)  // the gates and the r * h stores
    __syncthreads();
    PROBE(10)  // barrier 1
    // 2. the candidate: cx[t] + (r * h) @ whc
#pragma unroll
    for (int p = 0; p < UPW; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][0][e] = cxv[p][e];
    if (t + 1 < T) load(t + 1);  // in flight while the product runs
    PROBE(11)  // the next step's loads issued
    product(acc, rh_s, 2, 1);
    PROBE(12)  // the candidate product
    // 3. the update of the thread's own elements of h (no other thread reads h
    // until the barrier below), the window, the outputs; u * h + (1 - u) * cand
    // as one explicit fmaf (the same rounding in every instance, whatever the
    // compiler would contract), computed for every element before any store
#pragma unroll
    for (int p = 0; p < UPW; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float cand = tanh_fast(acc[p][0][e]);
        acc[p][0][e] = fmaf(uv[p][e], hv_own[p][e] - cand, cand);
      }
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int row = 2 * t4 + o, b = b0 + row;
      const bool active = t >= lo[o] && t < hi[o];
#pragma unroll
      for (int p = 0; p < UPW; ++p) {
        const float h0 = acc[p][0][o], h1 = acc[p][0][o + 2];
        store2(h_s + row * HS, p, active ? h0 : hv_own[p][o], active ? h1 : hv_own[p][o + 2]);
        if (b < B)
          store2(out + ((size_t)t * B + b) * H, p, active ? h0 : 0.f, active ? h1 : 0.f);
      }
    }
    PROBE(13)  // the update and the stores
    __syncthreads();
    PROBE(14)  // barrier 2
  }
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                        const float*, const float*, const float*, const float4*, const float4*,
                        const int*, const int*, const int*, float*, float*, int, int, int);

int launch(int dirs, const float* gx_f, const float* cx_f, const float* gx_b, const float* cx_b,
           const float* whg_f, const float* whc_f, const float* whg_b, const float* whc_b,
           const float* w_f, const float* w_b, const int* lens, const int* starts_f,
           const int* starts_b, float* out_f, float* out_b, int T, int B, int H, int wg,
           int smem_bytes, void* stream) {
  if (H < 1 || H > 512 || T < 1 || B < 1 || (wg && w_f == nullptr))
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = wg ? gru_kernel<true> : gru_kernel<false>;
  const int utl = (H + 15) / 16, upw = wg ? 2 : 1;
  const int threads = 32 * ((utl + upw - 1) / upw);
  if (threads > max_threads(wg != 0) || smem_bytes < smem_bytes_for(H, wg != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + R - 1) / R, dirs);
  kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      gx_f, cx_f, gx_b, cx_b, whg_f, whc_f, whg_b, whc_b, reinterpret_cast<const float4*>(w_f),
      reinterpret_cast<const float4*>(w_b), lens, starts_f, starts_b, out_f, out_b, T, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef GRU_PROBE
// Copies the phase clocks to dst[16] and sets them to 0.
int gru_probe_read(long long* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, gru_probe_clocks, sizeof(long long) * 16);
  if (err != cudaSuccess) return (int)err;
  const long long zero[16] = {0};
  return (int)cudaMemcpyToSymbol(gru_probe_clocks, zero, sizeof(zero));
}
#endif

// gx_*: [T, B, 2H] float32, cx_*: [T, B, H], whg_*: [H, 2H], whc_*: [H, H];
// w_*: with wg, a direction's whg and whc packed by ops/gru.py:pack_weights
// (3 x ceil(H / 16) x k_steps(H) x 32 float4), else null; lens/starts: [B]
// int32, out_*: [T, B, H]. 1 <= H <= 512. The
// geometry comes from the caller (ops/gru.py:geometry): wg (the weights read
// from device memory instead of shared memory) and the dynamic shared memory.
int bigru_launch(const float* gx_f, const float* cx_f, const float* gx_b, const float* cx_b,
                 const float* whg_f, const float* whc_f, const float* whg_b, const float* whc_b,
                 const float* w_f, const float* w_b, const int* lens, const int* starts,
                 float* out_f, float* out_b, int T, int B, int H, int wg, int smem_bytes,
                 void* stream) {
  return launch(2, gx_f, cx_f, gx_b, cx_b, whg_f, whc_f, whg_b, whc_b, w_f, w_b, lens, nullptr,
                starts, out_f, out_b, T, B, H, wg, smem_bytes, stream);
}

// One direction; starts may be null (every row's window is [0, len)).
int gru_launch(const float* gx, const float* cx, const float* whg, const float* whc,
               const float* w, const int* lens, const int* starts, float* out, int T, int B,
               int H, int wg, int smem_bytes, void* stream) {
  return launch(1, gx, cx, nullptr, nullptr, whg, whc, nullptr, nullptr, w, nullptr, lens, starts,
                nullptr, out, nullptr, T, B, H, wg, smem_bytes, stream);
}

}  // extern "C"
