// The first port of the GRU kernel, kept as the yardstick of csrc/gru.cu:
// chip_smoke.py and tools/kernel_probe.py time it beside the package's kernel
// in the same run.
// The package never launches it. One block per (direction, tile of 8 batch
// rows), one thread per gate column (2H threads), the tile's h in shared
// memory, each thread streaming its column of whg and whc from L2 at every k
// of every step; the candidate product runs on the first H threads. The same
// function as csrc/gru.cu (see there), over gx [T, B, 2H], cx [T, B, H], whg
// [H, 2H] and whc [H, H] as they are. Above H = 256 its 1024-thread instance
// spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 8;  // batch rows per block
constexpr int MAX_H = 512;  // one thread per gate column: 2H <= 1024

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

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

// THREADS bounds the block (2H rounded up to a warp): 256 covers H <= 128, 512
// H <= 256 and 1024 H <= 512, so that the registers of one block always fit an
// SM. The second
// bound (one block per SM is enough) lets the compiler spend registers on
// unrolling the product loops, which keeps several weight loads in flight
// against the L2 latency that bounds a step: builds that aimed at more
// blocks per SM (48-64 registers) took 2.2-2.4x as long on an H100.
template <int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
gru_kernel(const float* __restrict__ gx_f, const float* __restrict__ cx_f,
           const float* __restrict__ gx_b, const float* __restrict__ cx_b,
           const float* __restrict__ whg_f, const float* __restrict__ whc_f,
           const float* __restrict__ whg_b, const float* __restrict__ whc_b,
           const int* __restrict__ lens, const int* __restrict__ starts_f,
           const int* __restrict__ starts_b, float* __restrict__ out_f,
           float* __restrict__ out_b, int T, int B, int H) {
  extern __shared__ float smem[];
  float* h_s = smem;            // [R][H]
  float* rh_s = h_s + R * H;    // [R][H]  r * h
  float* u_s = rh_s + R * H;    // [R][H]

  const int dir = blockIdx.y;  // 0 forward, 1 backward (flipped input)
  const float* gx = dir == 0 ? gx_f : gx_b;
  const float* cx = dir == 0 ? cx_f : cx_b;
  const float* whg = dir == 0 ? whg_f : whg_b;
  const float* whc = dir == 0 ? whc_f : whc_b;
  const int* starts = dir == 0 ? starts_f : starts_b;  // null: every row starts at 0
  float* out = dir == 0 ? out_f : out_b;
  const int b0 = blockIdx.x * R;
  const int G = 2 * H;
  const int col = threadIdx.x;

  for (int i = threadIdx.x; i < R * H; i += blockDim.x) h_s[i] = 0.f;
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

  PROBE_INIT
  for (int t = 0; t < T; ++t) {
    // stage 1: the gates r (columns < H) and u, from gx[t] + h @ whg
    if (col < G) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        acc[r] = b < B ? gx[((size_t)t * B + b) * G + col] : 0.f;
      }
      PROBE(0)  // the gx load
      for (int k = 0; k < H; ++k) {
        const float wv = whg[(size_t)k * G + col];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(h_s[r * H + k], wv, acc[r]);
      }
      PROBE(1)  // the gate product
      if (col < H) {
#pragma unroll
        for (int r = 0; r < R; ++r) rh_s[r * H + col] = sigm(acc[r]) * h_s[r * H + col];
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) u_s[r * H + col - H] = sigm(acc[r]);
      }
      PROBE(2)  // the r * h and u stores
    }
    __syncthreads();
    PROBE(3)  // barrier 1
    // stage 2: the candidate from cx[t] + (r * h) @ whc, the update, the mask
    if (col < H) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        acc[r] = b < B ? cx[((size_t)t * B + b) * H + col] : 0.f;
      }
      PROBE(4)  // the cx load
      for (int k = 0; k < H; ++k) {
        const float wv = whc[(size_t)k * H + col];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(rh_s[r * H + k], wv, acc[r]);
      }
      PROBE(5)  // the candidate product
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        if (b >= B) continue;
        float hv = 0.f;
        if (t >= lo[r] && t < hi[r]) {
          const float u = u_s[r * H + col];
          hv = u * h_s[r * H + col] + (1.f - u) * tanhf(acc[r]);
          h_s[r * H + col] = hv;
        }
        out[((size_t)t * B + b) * H + col] = hv;
      }
      PROBE(6)  // the update and the stores
    }
    __syncthreads();
    PROBE(7)  // barrier 2
  }
}

int launch(int dirs, const float* gx_f, const float* cx_f, const float* gx_b, const float* cx_b,
           const float* whg_f, const float* whc_f, const float* whg_b, const float* whc_b,
           const int* lens, const int* starts_f, const int* starts_b, float* out_f, float* out_b,
           int T, int B, int H, void* stream) {
  if (H < 1 || H > MAX_H) return (int)cudaErrorInvalidValue;
  const int threads = ((2 * H + 31) / 32) * 32;
  const size_t smem = (size_t)R * 3 * H * sizeof(float);
  auto kernel = threads <= 256 ? gru_kernel<256> : threads <= 512 ? gru_kernel<512>
                                                                  : gru_kernel<1024>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + R - 1) / R, dirs);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      gx_f, cx_f, gx_b, cx_b, whg_f, whc_f, whg_b, whc_b, lens, starts_f, starts_b, out_f, out_b,
      T, B, H);
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

// gx_*: [T, B, 2H] float32, cx_*: [T, B, H], whg_*: [H, 2H], whc_*: [H, H],
// lens/starts: [B] int32, out_*: [T, B, H]. H <= 512.
int baseline_bigru_launch(const float* gx_f, const float* cx_f, const float* gx_b,
                          const float* cx_b, const float* whg_f, const float* whc_f,
                          const float* whg_b, const float* whc_b, const int* lens,
                          const int* starts, float* out_f, float* out_b, int T, int B, int H,
                          void* stream) {
  return launch(2, gx_f, cx_f, gx_b, cx_b, whg_f, whc_f, whg_b, whc_b, lens, nullptr, starts,
                out_f, out_b, T, B, H, stream);
}

// One direction; starts may be null (every row's window is [0, len)).
int baseline_gru_launch(const float* gx, const float* cx, const float* whg, const float* whc,
                        const int* lens, const int* starts, float* out, int T, int B, int H,
                        void* stream) {
  return launch(1, gx, cx, nullptr, nullptr, whg, whc, nullptr, nullptr, lens, starts, nullptr,
                out, nullptr, T, B, H, stream);
}

}  // extern "C"
