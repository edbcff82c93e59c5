// One LSTM direction for inference where no cluster of at most 8 blocks holds
// the recurrent weights: wh resident in a non-portable cluster of 16 blocks,
// the product on the tensor cores in three TF32 passes summed in float32.
//
// Same function as csrc/bilstm.cu's one-direction launch (it replaces the
// same TPU kernel, chiron_tpu/ops/pallas/lstm.py:lstm_layer_pallas), over
// precomputed xw = x @ wx + b ([T, B, 4H], gate order i, g, f, o; forget
// bias +1):
//   gates = xw[t] + h @ wh;  c' = sig(f + 1) * c + sig(i) * tanh(g)
//   h' = sig(o) * tanh(c')
// Row b is active on starts[b] <= t < starts[b] + lens[b] (no starts: from 0);
// outside its window its state is frozen and its output is zero.
//
// Why a kernel of its own. At H = 384 (Bonito's HAC model) one direction's wh
// is 2.36 MB of float32. A block of a cluster of 8 would need 295 KB of it,
// more than the 227 KB a block may use, so csrc/bilstm.cu streams each block's
// slice from L2 on every one of the T steps, with a cluster tile of at most 16
// rows: at B = 400 that is two waves of clusters, ~24 us a step each.
//
// The design. A cluster of 16 blocks owns a tile of up to 64 batch rows for the
// whole recurrence. Block j holds the four gate columns of the hidden units
// [24 j, 24 j + 24): its slice of wh, [384][96] float32 = 147 KB, loaded once.
// The wrapper (ops/lstm.py) asks the card how many such clusters it holds at
// once (7 on an H100's 132 SMs) and gives each cluster ceil(B / clusters)
// rows rounded up to 16, so B = 400 runs in one wave; a B that one wave does
// not hold is walked tile by tile inside the launch.
//
// Each step, block j computes its [rows x 384] x [384 x 96] product with
// mma.sync m16n8k8 TF32 in the scheme of csrc/conv_bn.cu: each operand is split
// in registers into a TF32 head and tail, and head*tail + tail*head +
// head*head run on the tensor cores. The tensor cores add with truncation, so
// a chain from a zero accumulator covers one peer's 24 units (three k8 slices,
// nine MMAs) and the 16 chains are added to the float32 gate accumulator on
// the CUDA cores, which starts from xw[t]. The dropped tail*tail term is ~2^-22
// relative: the result is float32-class, never a single TF32 pass (against the
// plain version at Bonito HAC's shape, 3.8e-7 where chains of three MMAs read
// 5.4e-7 and the streamed FFMA kernel 1.3e-6). The order of every sum is
// fixed, so the output is the same bits from run to run.
//
// h goes between the blocks through distributed shared memory. A full copy of
// the tile's h beside wh does not fit (64 x 384 float32 is 98 KB, twice for
// double buffering), so each block keeps only its own units' h, [2][64][24]
// by step parity, and the warps read their A fragments of the peers' units
// straight from the peers' shared memory. One split cluster barrier a step:
// the new h goes into the other parity, which no block reads before the
// barrier; the output stores go between its arrive and its wait. Each block
// walks the peers starting from itself, so the 16 blocks read 16 different
// peers at a time.
//
// Threads: 8 warps, 4 row groups of 16 rows x 2 column groups of 12 hidden
// units (fewer row groups for a smaller tile). A warp's 6 n-tiles of 8 columns
// each hold 4 units x 2 gates, interleaved (column 2 u + gate % 2 of the
// tile), so a thread's accumulator fragment holds all four gates of its 3
// units x 2 rows: the gate stage runs in registers, with no shared-memory
// round trip. xw[t + 1] is loaded into registers while step t runs. The wh
// slice and the h slices lie in shared memory in the order the fragments read
// them: a lane's B or A operands of a k8 slice are one 16-byte load, a warp's
// 512 contiguous bytes, local or from a peer.
//
// What bounds it: the T steps are sequential, and at B = 400 a step is ~21,500
// clocks, ~18,500 of them the product, which is bound by its 6,912 mma.sync a
// block (with every split taken out it is 8% shorter; reading h from the
// block's own shared memory instead of the peers', 5%): 9.5 ms a layer at
// T = 800 against 38.2 ms for the streamed instance (tools/kernel_probe.py
// lstm, H100).
//
// H: 1..384. Every block does the 384-deep product; hidden units past H have
// zero weights and stay zero. Where a cluster of at most 8 blocks holds wh
// (H up to ~320-336), csrc/bilstm.cu keeps it resident; the wrapper takes this
// kernel only where that kernel would stream wh.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 16;        // blocks of a cluster (non-portable above 8)
constexpr int HS = 24;             // hidden units a block
constexpr int KD = CLUSTER * HS;   // 384: depth of the product, the largest H
constexpr int LC = 4 * HS;         // 96 gate columns a block
constexpr int MAX_ROWS = 64;       // rows of a tile: 4 row groups of 16
constexpr int CGROUPS = 2;         // column groups of a block: 12 units each
constexpr int NT = 6;              // n-tiles of a warp: 3 groups of 4 units x 2 gate pairs
constexpr int UG = 3;              // 4-unit groups of a warp
constexpr int SLICE = MAX_ROWS * HS;  // floats of a block's h at one step parity

// sigmoid and tanh from __expf and __fdividef (a few ulp; tanh x = 2 sig(2x) - 1,
// within ~2e-7 of tanhf): 7% of the kernel's time against expf and tanhf
__device__ __forceinline__ float sigm(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }
__device__ __forceinline__ float tanh_(float x) { return 2.f * sigm(2.f * x) - 1.f; }

// x = head + tail: head the nearest TF32 value (ties away from zero, as
// csrc/conv_bn.cu rounds), tail the exact rest, which the tensor cores read as
// TF32 by dropping its low 13 bits: an error under 2^-21 |x|, where rounding the
// tail too (two more operations a split, most of what the loop executes) gives
// 2^-22
__device__ __forceinline__ void split_tf32(float x, uint32_t& head, uint32_t& tail) {
  head = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  tail = __float_as_uint(x - __uint_as_float(head));
}
// d = a * b (from a zero accumulator)
__device__ __forceinline__ void mma_first(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(z));
}
// d += a * b
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Bytes of dynamic shared memory of a block: the wh slice (384 x 96) and the
// block's h (2 x 64 x 24), float32.
constexpr int SMEM_BYTES = (int)sizeof(float) * (KD * LC + 2 * SLICE);

// tools/kernel_probe.py builds this file with -DLSTM_C16_PROBE: thread 0 of
// block 0 then adds up the clocks it spends in each phase of a step.
#ifdef LSTM_C16_PROBE
__device__ long long c16_probe_clocks[8];
#define PROBE_INIT long long probe_last = clock64();
#define PROBE(i)                                                \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                    \
    const long long now = clock64();                            \
    c16_probe_clocks[i] += now - probe_last;                    \
    probe_last = now;                                           \
  }
#else
#define PROBE_INIT
#define PROBE(i)
#endif

__global__ void __launch_bounds__(CGROUPS * 4 * 32, 1)
    lstm_infer_kernel_c16(const float* __restrict__ xw, const float* __restrict__ wh,
                          const int* __restrict__ lens, const int* __restrict__ starts,
                          float* __restrict__ out, int T, int B, int H, int rows) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int G = 4 * H;
  const int u_base = rank * HS;  // the block's first hidden unit
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row_groups = rows >> 4;
  const int rgi = warp % row_groups, cgi = warp / row_groups;

  // Both live in shared memory in the order the MMA fragments read them, so a
  // lane's operands of a k8 slice are one 16-byte load and a warp's 512
  // contiguous bytes (no bank conflicts, a quarter of the load instructions):
  //  - ws, float4 [48 k8 slices][2 column groups][3 unit groups a][32 lanes]:
  //    the B fragments (b0, b1) of n-tiles 2a and 2a + 1. N-tile nt = 2 a + p
  //    holds gates 2p, 2p + 1 of the column group's units 4a..4a + 3 at column
  //    n = 2 u4 + gate % 2, so a thread's accumulator holds all four gates of
  //    its units;
  //  - hs, float4 [2 parities][4 row groups][3 k8 slices][32 lanes]: the A
  //    fragments (a0..a3) of the block's 24 units as a k8 slice of the
  //    product, written there by the units' owners.
  float4* ws = reinterpret_cast<float4*>(smem);
  float* hs = smem + KD * LC;

  for (int i = tid; i < KD * LC; i += blockDim.x) {
    // wh[k, gate * H + unit] in wh's order: a gate's 24 units side by side
    const int k = i / LC, rem = i - k * LC;
    const int gate = rem / HS, uu = rem - gate * HS;
    const int cgc = uu / 12, a = (uu % 12) >> 2, u4 = uu & 3;
    const int lane_b = (2 * u4 + (gate & 1)) * 4 + (k & 3);  // g = column, tig = k % 4
    const int at = (((k >> 3) * CGROUPS + cgc) * UG + a) * 32 + lane_b;
    const int unit = u_base + uu;
    smem[4 * at + 2 * (gate >> 1) + ((k >> 2) & 1)] =
        (k < H && unit < H) ? wh[(size_t)k * G + gate * H + unit] : 0.f;
  }

  // this thread's elements: 3 units (a) x 2 rows (half); its unit of group a
  // and its rows within the tile
  int unit[UG], h_at[UG][2];
  const int r0 = 16 * rgi + g;  // rows r0 and r0 + 8
#pragma unroll
  for (int a = 0; a < UG; ++a) {
    const int uu = 12 * cgi + 4 * a + tig;
    unit[a] = u_base + uu;
    // where h of (row r0 + 8 half, unit uu) lies in the A fragments of k8 slice uu / 8
    const int kk = uu & 7;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      h_at[a][half] = (((rgi * 3 + (uu >> 3)) * 32 + g * 4 + (kk & 3)) << 2) + half +
                      2 * (kk >> 2);
  }
  const float4* w_lane = ws + cgi * UG * 32 + lane;  // + k8 slice * CGROUPS * UG * 32
  const int a_lane = rgi * 3 * 32 + lane;             // float4 of slice q: + q * 32

  const int tiles = (B + rows - 1) / rows;
  const int n_clusters = gridDim.x / CLUSTER;
  for (int tile = blockIdx.x / CLUSTER; tile < tiles; tile += n_clusters) {
    const int b0 = tile * rows;
    for (int i = tid; i < 2 * SLICE; i += blockDim.x) hs[i] = 0.f;
    int lo[2], hi[2];
    bool row_ok[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = b0 + r0 + 8 * half;
      row_ok[half] = b < B;
      const int st = (row_ok[half] && starts != nullptr) ? starts[b] : 0;
      lo[half] = st;
      hi[half] = st + (row_ok[half] ? lens[b] : 0);
    }
    float c_reg[UG][2], h_reg[UG][2];
#pragma unroll
    for (int a = 0; a < UG; ++a)
#pragma unroll
      for (int half = 0; half < 2; ++half) c_reg[a][half] = h_reg[a][half] = 0.f;

    // xw of the thread's accumulator elements: nt = 2 a + p, element 2 half + s
    // is gate 2 p + s of unit[a], row r0 + 8 half
    auto load_xw = [&](int t, float (&dst)[NT][4]) {
      const float* src = xw + (size_t)t * B * G;
#pragma unroll
      for (int a = 0; a < UG; ++a)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              const bool ok = row_ok[half] && unit[a] < H && t < T;
              dst[2 * a + p][2 * half + s] =
                  ok ? src[(size_t)(b0 + r0 + 8 * half) * G + (2 * p + s) * H + unit[a]] : 0.f;
            }
    };
    float xw_next[NT][4];
    load_xw(0, xw_next);
    __syncthreads();  // wh and the zeros are down
    cluster.sync();   // in every block of the cluster, before any peer reads them

    PROBE_INIT
    for (int t = 0; t < T; ++t) {
      const int par = t & 1;
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = xw_next[nt][i];
      load_xw(t + 1, xw_next);  // lands while the product runs

      // the product, peer by peer starting from this block's own h, 3 k8 slices a peer;
      // a peer's A values are loaded while the previous peer multiplies
      auto load_a = [&](int pi, float4 (&dst)[3]) {
        const int p = (rank + pi) & (CLUSTER - 1);
        const float4* src =
            reinterpret_cast<const float4*>(cluster.map_shared_rank(hs + par * SLICE, p)) +
            a_lane;
#pragma unroll
        for (int q = 0; q < 3; ++q) dst[q] = src[q * 32];
      };
      auto multiply = [&](int pi, const float4 (&a_raw)[3]) {
        const int c0 = ((rank + pi) & (CLUSTER - 1)) * 3;  // the peer's first k8 slice
        // one chain of nine MMAs from zero a peer, the small products of each
        // k8 slice first, the six chains side by side; added to the float32
        // accumulator once a peer
        float part[NT][4];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          uint32_t ah[4], al[4];
          split_tf32(a_raw[q].x, ah[0], al[0]);
          split_tf32(a_raw[q].y, ah[1], al[1]);
          split_tf32(a_raw[q].z, ah[2], al[2]);
          split_tf32(a_raw[q].w, ah[3], al[3]);
          uint32_t bh[NT][2], bl[NT][2];
          const float4* wk = w_lane + (c0 + q) * CGROUPS * UG * 32;
#pragma unroll
          for (int a = 0; a < UG; ++a) {
            const float4 w = wk[a * 32];
            split_tf32(w.x, bh[2 * a][0], bl[2 * a][0]);
            split_tf32(w.y, bh[2 * a][1], bl[2 * a][1]);
            split_tf32(w.z, bh[2 * a + 1][0], bl[2 * a + 1][0]);
            split_tf32(w.w, bh[2 * a + 1][1], bl[2 * a + 1][1]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (q == 0)
              mma_first(part[nt], al, bh[nt]);
            else
              mma_acc(part[nt], al, bh[nt]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_acc(part[nt], ah, bl[nt]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_acc(part[nt], ah, bh[nt]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] += part[nt][i];
      };
      float4 a_even[3], a_odd[3];
      load_a(0, a_even);
      for (int pi = 0; pi < CLUSTER; pi += 2) {
        load_a(pi + 1, a_odd);
        multiply(pi, a_even);
        if (pi + 2 < CLUSTER) load_a(pi + 2, a_even);
        multiply(pi + 1, a_odd);
      }
      PROBE(0)  // the product (with the issue of xw[t + 1]'s loads)

      // gates, c', h' of the thread's elements; the new h into the other parity
      float* h_next = hs + (par ^ 1) * SLICE;
      float v_out[UG][2];
#pragma unroll
      for (int a = 0; a < UG; ++a)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float ig = sigm(acc[2 * a][2 * half]);
          const float gg = tanh_(acc[2 * a][2 * half + 1]);
          const float fg = sigm(acc[2 * a + 1][2 * half] + 1.f);
          const float og = sigm(acc[2 * a + 1][2 * half + 1]);
          const float nc = fg * c_reg[a][half] + ig * gg;
          const float nh = og * tanh_(nc);
          const bool active = t >= lo[half] && t < hi[half];
          v_out[a][half] = 0.f;
          if (active) {
            c_reg[a][half] = nc;
            h_reg[a][half] = nh;
            v_out[a][half] = nh;
          }
          h_next[h_at[a][half]] = h_reg[a][half];
        }
      PROBE(1)  // the gate stage and the h stores
      cluster_arrive();
      // the outputs leave while the cluster gathers
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!row_ok[half]) continue;
        float* o = out + ((size_t)t * B + b0 + r0 + 8 * half) * H;
#pragma unroll
        for (int a = 0; a < UG; ++a)
          if (unit[a] < H) o[unit[a]] = v_out[a][half];
      }
      PROBE(2)  // the barrier's arrive and the out stores
      cluster_wait();
      PROBE(3)  // the barrier's wait
    }
  }
}

}  // namespace

extern "C" {

#ifdef LSTM_C16_PROBE
// Copies the phase clocks to dst[8] and sets them to 0.
int c16_probe_read(long long* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, c16_probe_clocks, sizeof(long long) * 8);
  if (err != cudaSuccess) return (int)err;
  const long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(c16_probe_clocks, zero, sizeof(zero));
}
#endif

// The dynamic shared memory a block asks for (ops/lstm.py:C16_SMEM_BYTES).
int lstm_c16_smem_bytes(void) { return SMEM_BYTES; }

static cudaError_t prepare(int smem_bytes) {
  const void* kernel = (const void*)lstm_infer_kernel_c16;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

static void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int clusters,
                           int rows, void* stream) {
  cfg.gridDim = dim3(clusters * CLUSTER);
  cfg.blockDim = dim3(CGROUPS * (rows / 16) * 32);
  cfg.dynamicSmemBytes = (size_t)SMEM_BYTES;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// How many clusters of 16 blocks of a full tile (64 rows) the current device
// holds at once, into *count.
int lstm_c16_active_clusters(int* count) {
  cudaError_t err = prepare(SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, 1, MAX_ROWS, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(count, (const void*)lstm_infer_kernel_c16, &cfg);
}

// xw: [T, B, 4H], out: [T, B, H], float32; wh: [H, 4H] float32; lens,
// starts: [B] int32 (starts may be null: every window from 0). 1 <= H <= 384.
// The geometry comes from the caller (ops/lstm.py): rows of a tile (16, 32, 48
// or 64) and the clusters of the grid, each walking tiles cluster, cluster +
// clusters, ... of the ceil(B / rows).
int lstm_c16_launch(const float* xw, const float* wh, const int* lens, const int* starts,
                    float* out, int T, int B, int H, int rows, int clusters, void* stream) {
  if (H < 1 || H > KD || T < 1 || B < 1 || rows < 16 || rows > MAX_ROWS || rows % 16 != 0 ||
      clusters < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, clusters, rows, stream);
  err = cudaLaunchKernelEx(&cfg, lstm_infer_kernel_c16, xw, wh, lens, starts, out, T, B, H, rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
