// Start rate of mma.sync.m16n8k8 TF32, for tools/kernel_probe.py: every warp runs 20
// independent accumulator tiles (5 A fragments x 4 B fragments, the shape of
// conv_bn_mma_kernel's inner loop) with nothing else in the loop. With extra > 0 each
// group of 4 MMAs is followed by `extra` integer adds, to show whether other
// operations hide behind the MMAs or add to them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int EXTRA>
__global__ void __launch_bounds__(128) mma_rate_kernel(float* out, int iters) {
  float acc[5][4][4];
  uint32_t a[5][4], b[4][2];
  for (int i = 0; i < 5; ++i)
    for (int j = 0; j < 4; ++j) a[i][j] = threadIdx.x * (i + 3) + j;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 2; ++j) b[i][j] = threadIdx.x * (i + 7) + j;
  for (int i = 0; i < 5; ++i)
    for (int n = 0; n < 4; ++n)
      for (int j = 0; j < 4; ++j) acc[i][n][j] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int mt = 0; mt < 5; ++mt) {
#pragma unroll
      for (int e = 0; e < EXTRA; ++e) a[mt][e & 3] += it;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[mt][nt][0]), "+f"(acc[mt][nt][1]), "+f"(acc[mt][nt][2]),
              "+f"(acc[mt][nt][3])
            : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]), "r"(b[nt][0]),
              "r"(b[nt][1]));
    }
  }
  float s = 0.f;
  for (int i = 0; i < 5; ++i)
    for (int n = 0; n < 4; ++n)
      for (int j = 0; j < 4; ++j) s += acc[i][n][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// out: [blocks * 128] float32. Each of the blocks' 4 warps runs iters * 20 MMAs;
// extra = 0, 4 or 8 integer adds per 4 MMAs.
int mma_rate_launch(float* out, int iters, int blocks, int extra, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (extra == 0) {
    mma_rate_kernel<0><<<blocks, 128, 0, st>>>(out, iters);
  } else if (extra == 4) {
    mma_rate_kernel<4><<<blocks, 128, 0, st>>>(out, iters);
  } else if (extra == 8) {
    mma_rate_kernel<8><<<blocks, 128, 0, st>>>(out, iters);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
