// Fused prologue-affine + 1-D convolution + per-channel output moments.
//
// Replaces the TPU kernel chiron_tpu/ops/pallas/convbn.py:conv_bn_pallas
// (_conv_bn_kernel). Same function:
//   x = relu?(sum_i raw_i * a_i + b_i)           (one or two terms)
//   x is zero-padded AFTER the prologue (XLA SAME arithmetic, any stride)
//   y[b, t, n] = sum_{tap, c} x[b, t*s - lpad + tap, c] * w[tap, c, n]
//   sums[n] = sum_{b,t} y,  sqs[n] = sum_{b,t} y^2
//
// What bounds it on an H100. At dna_model1's shapes ([400, 400, 256],
// 256 -> 256 channels) a k=3 conv is ~63 GFLOP against ~0.5 GB of traffic:
// bound by operations. The result must stay float32-grade for parity with the
// JAX reference. A single TF32 product is excluded (2e-3 absolute error at this
// depth, 20x over the 1e-4 gate), but three are float32-grade: each operand is
// split in registers into a TF32 head and a TF32 tail (x rounded to TF32 as
// cvt.rna.tf32.f32 rounds, then x - head rounded) and head*head + head*tail + tail*head is accumulated in
// float32 (the dropped tail*tail term is ~2^-22 relative). The tensor cores add
// with truncation, so the MMAs run in chains of three from a zero accumulator and
// the chains are summed with float32 adds (see the loop). So the operations
// bound is 3 x the product's FLOP over the tensor cores' 495 TFLOP/s TF32
// (0.38 ms for the k=3 shape), instead of the FLOP over 67 TFLOP/s (0.94 ms)
// that holds for the CUDA cores. With one input channel (the first convs of
// res1 and the strided k=9 / k=8 fronts) the product is tiny and the kernel
// is bound by the bytes of the output it writes.
//
// The design, two kernels behind one entry point, chosen by shape:
//
// conv_bn_mma_kernel (cin >= 8, cin and cout multiples of 4, 16-byte aligned
// pointers): a block of 4 warps owns 80 output rows (5 m16 tiles: dna-pre's
// and rna-pre's out_t = 400 is 5 tiles with no waste; dna-slow-pre's and the
// default preset's out_t = 500 is 7 tiles = 560 rows, 10.7% past the end) of
// one batch row and 128 output channels, so the input is read and normalised
// by at most two blocks at 256 channels; each warp keeps an 80 x 32
// accumulator tile (80 registers) and runs mma.sync m16n8k8 TF32. Per slice
// of 32 input channels the raw input rows (79 * stride + k of them) arrive by
// cp.async into a raw slab while the previous slice multiplies (a thread
// refills exactly the slots it has just normalised, so one buffer is enough);
// one pass applies the prologue and the zero padding (rows outside [0, T)
// become zeros) into the slab Xs, and all k taps read shifted rows of Xs, so
// the MMA loop has no predicates and the prologue runs once per element and
// slice. Weight tiles [32, 128] of one (slice, tap) arrive through a ring of
// two cp.async stages: tile q + 1 loads while tile q multiplies. Pitches: Xs
// 36 floats (A fragments: bank = 4 * row + column, conflict-free at stride 1
// and 5; float4 staging stores), weights 136 floats (B fragments: bank =
// 8 * k + n, conflict-free; w is n-fastest in memory, so the "column-major" B
// fragment is read straight from the [k][n] tile). Dynamic shared memory
// 57-68 KB (one or two terms at stride 1) and 168 registers: three blocks per
// SM. Measured on an H100 with tools/kernel_probe.py (k=3, 256 -> 256, 1.6 ms):
// with the staging taken out the MMA loop alone runs 1.28 ms and the staging
// alone 0.56 ms, so the loop bounds the kernel. Bare mma.sync TF32 starts once
// per 7 clocks per SM quarter with one to three warps a scheduler (61% of the
// wgmma rate; 0.62 ms for this shape); this loop, with ~5 other operations
// per MMA (fragment loads, the head/tail splits, the float32 adds of the
// partial sums), runs at 14.5. Rounding with two integer operations instead
// of cvt.rna.tf32.f32 (five after nvcc's expansion) took 8% off. Tried and
// left out, each within 5% or slower: chains of six MMAs (they spill at three
// blocks per SM), deeper rings, and the input and the weights split once into
// shared-memory planes (fewer operations, but twice the weight traffic and
// two blocks per SM).
//
// conv_bn_direct_kernel (everything else): a CUDA-core kernel. With k * cin <=
// 16 (the narrow inputs of the three fronts) the block stages its prologue-
// normalised slab in shared memory, each thread keeps the k * cin weights of
// its four output channels in registers and writes float4 runs of channels,
// 1 KB contiguous per row across the block: bound by the output write. Other
// shapes (channel counts that are no multiple of 4, unaligned views) take
// the same kernel with the input normalised on the fly from global memory:
// slow, but the entry point takes any shape.
//
// Moments: the TPU kernel carried its sums in scratch across sequential
// grid steps. CUDA blocks run in no order, so each block writes per-channel
// partial sums of its rows < out_t (from the accumulators, reduced in a fixed
// order) to a scratch buffer [2, batch * ceil(out_t / 80), cout] and a second
// kernel reduces the partials in a fixed order (float64 accumulation): the
// result is the same from run to run, with no float atomics. On the tensor-
// core kernel only the sum of squares is taken that way. A tensor-core MMA
// truncates its sum towards zero; chains of three MMAs from a zero accumulator,
// added up on the CUDA cores, keep y within 6e-6 of the plain version, but a
// per-channel offset of ~5e-8 remains, which over 160,000 rows is up to 2e-4 of
// a channel sum that nearly cancels. So that kernel takes sum(y) from the
// conv's linearity instead: per-tile column sums of the normalised input per
// (tap, channel), reduced over the tiles and multiplied by w in float64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 80;        // output time rows per block (both kernels)
constexpr int MT = BM / 16;   // m16 tiles per block
constexpr int BN = 128;       // output channels per block (mma kernel)
constexpr int WN = 32;        // output channels per warp
constexpr int NTL = WN / 8;   // n8 tiles per warp
constexpr int KC = 32;        // input channels per slice
constexpr int NS = 2;         // weight ring stages
constexpr int PX = KC + 4;    // slab pitch (floats)
constexpr int PW = BN + 8;    // weight tile pitch (floats)
constexpr int NT = (BN / WN) * 32;  // threads per block of the mma kernel
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The nearest TF32 value (ties away from zero, as cvt.rna.tf32.f32 rounds), in two
// integer operations: nvcc expands the cvt into five with its NaN handling, and
// the splits are most of what the MMA loop executes.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = head + tail with both representable in TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& head, uint32_t& tail) {
  head = round_tf32(x);
  tail = round_tf32(x - __uint_as_float(head));
}

// d = a * b (a zero accumulator comes in)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  const float z = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(z));
}

// d += a * b
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(NT, 3)
conv_bn_mma_kernel(const float* __restrict__ raw0, const float* __restrict__ raw1,
                   const float* __restrict__ a0, const float* __restrict__ b0,
                   const float* __restrict__ a1, const float* __restrict__ b1,
                   const float* __restrict__ w, float* __restrict__ y,
                   float* __restrict__ partial, float* __restrict__ xpart, int T, int cin,
                   int cout, int k, int stride, int lpad, int out_t, int relu_in) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // fragment row group / thread in group
  const int t0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const bool two = raw1 != nullptr;
  const int slab_rows = (BM - 1) * stride + k;
  const int tin0 = t0 * stride - lpad;  // input row of slab row 0
  const int raw_buf = slab_rows * KC;   // floats of one term of the raw slab
  float* Xs = smem;                     // [slab_rows][PX] normalised input slice
  float* Ws = Xs + slab_rows * PX;      // [NS][KC][PW] weight ring
  float* Rs = Ws + NS * KC * PW;        // [terms][slab_rows][KC] raw slab
  const int n_slices = (cin + KC - 1) / KC;
  const int nq = n_slices * k;          // weight tiles: (slice, tap) in order
  const size_t in_base = (size_t)b * T * cin;

  // weight tile q = (slice, tap) -> ring stage q % NS; zeros outside w
  auto fetch_w = [&](int q) {
    if (q >= nq) return;
    const int s = q / k, tap = q - s * k;
    float* dst = Ws + (q % NS) * KC * PW;
    for (int e = tid; e < KC * (BN / 4); e += NT) {
      const int kk = e / (BN / 4), n4 = (e - kk * (BN / 4)) * 4;
      const int c = s * KC + kk, n = n0 + n4;
      float* d = dst + kk * PW + n4;
      if (c < cin && n < cout) {
        cp_async16(d, w + ((size_t)tap * cin + c) * cout + n);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  // A thread stages the same four channels c4 .. c4 + 3 of every slice, in the
  // slab rows j0, j0 + JS, ...
  constexpr int JS = NT / (KC / 4);
  const int c4 = (tid % (KC / 4)) * 4;
  const int j0 = tid / (KC / 4);
  // raw input rows of slice s -> the raw slab (rows and channels that exist;
  // the others are never read). A thread copies into the slots that it alone
  // normalises, so it may refill them as soon as it has read them.
  auto fetch_raw = [&](int s) {
    const int c = s * KC + c4;
    if (c >= cin) return;
    for (int j = j0; j < slab_rows; j += JS) {
      const int tin = tin0 + j;
      if (tin >= 0 && tin < T) {
        const size_t off = in_base + (size_t)tin * cin + c;
        cp_async16(Rs + j * KC + c4, raw0 + off);
        if (two) cp_async16(Rs + raw_buf + j * KC + c4, raw1 + off);
      }
    }
  };
  // the prologue's scales and shifts of this thread's channels in slice s
  float4 sa, sb, ta, tb;
  auto load_affine = [&](int s) {
    const int c = s * KC + c4;
    sa = sb = ta = tb = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < cin) {
      sa = __ldg(reinterpret_cast<const float4*>(a0 + c));
      sb = __ldg(reinterpret_cast<const float4*>(b0 + c));
      if (two) {
        ta = __ldg(reinterpret_cast<const float4*>(a1 + c));
        tb = __ldg(reinterpret_cast<const float4*>(b1 + c));
      }
    }
  };
  // prologue + zero padding of slice s: raw buffer -> Xs
  auto normalise = [&](int s) {
    const bool has_c = s * KC + c4 < cin;
    for (int j = j0; j < slab_rows; j += JS) {
      const int tin = tin0 + j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (has_c && tin >= 0 && tin < T) {
        const float4 r = *reinterpret_cast<const float4*>(Rs + j * KC + c4);
        v.x = fmaf(r.x, sa.x, sb.x);
        v.y = fmaf(r.y, sa.y, sb.y);
        v.z = fmaf(r.z, sa.z, sb.z);
        v.w = fmaf(r.w, sa.w, sb.w);
        if (two) {
          const float4 r1 = *reinterpret_cast<const float4*>(Rs + raw_buf + j * KC + c4);
          v.x += fmaf(r1.x, ta.x, tb.x);
          v.y += fmaf(r1.y, ta.y, tb.y);
          v.z += fmaf(r1.z, ta.z, tb.z);
          v.w += fmaf(r1.w, ta.w, tb.w);
        }
        if (relu_in) {
          v.x = fmaxf(v.x, 0.f);
          v.y = fmaxf(v.y, 0.f);
          v.z = fmaxf(v.z, 0.f);
          v.w = fmaxf(v.w, 0.f);
        }
      }
      *reinterpret_cast<float4*>(Xs + j * PX + c4) = v;
    }
  };

  float acc[MT][NTL][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // One cp.async group per weight tile, committed NS - 1 tiles ahead; the raw
  // slab of slice s + 1 rides in the group committed at the first tap of slice s,
  // right after slice s was normalised out of the same slots.
  fetch_raw(0);
  fetch_w(0);
  cp_async_commit();
#pragma unroll
  for (int j = 1; j < NS - 1; ++j) {
    fetch_w(j);
    cp_async_commit();
  }

  for (int q = 0; q < nq; ++q) {
    const int s = q / k, tap = q - s * k;
    if (tap == 0) {
      load_affine(s);      // in flight while the copies land
      cp_async_wait<0>();  // this slice's raw slab and its first weight tile
    } else {
      cp_async_wait<NS - 2>();  // weight tile q
    }
    __syncthreads();  // tile q visible; every warp is done with tile q - 1 and, at tap 0, with Xs
#ifndef CONV_PROBE_NO_STAGING  // tools/kernel_probe.py: the MMA loop alone, on whatever is there
    if (tap == 0) {
      normalise(s);
      if (s + 1 < n_slices) fetch_raw(s + 1);
    }
    fetch_w(q + NS - 1);
#endif
    cp_async_commit();
    if (tap == 0) {
      __syncthreads();  // Xs visible
      // Column sums of the normalised input over this tile's output rows, one per
      // (tap, channel): sum_y[n] = sum_{tap, c} w[tap, c, n] * sum_rows x[row * s + tap, c]
      // (the conv is linear), which the second pass evaluates in float64.
      // Four lanes share a (tap, channel) column, each adding every fourth row
      // with two running sums; the lanes' sums are combined in a fixed order.
      if (blockIdx.y == 0) {
        const int rows = min(BM, out_t - t0);
        const int qd = tid & 3;
        for (int p = tid >> 2; p < k * KC; p += NT / 4) {  // k * KC % 32 == 0: warps stay whole
          const int tp = p / KC, cc = p - tp * KC;
          const float* col = Xs + tp * PX + cc;
          float s0 = 0.f, s1 = 0.f;
          for (int m = qd; m < rows; m += 8) {
            s0 += col[m * stride * PX];
            if (m + 4 < rows) s1 += col[(m + 4) * stride * PX];
          }
          float sum = s0 + s1;
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          if (qd == 0 && s * KC + cc < cin)
            xpart[((size_t)b * gridDim.x + blockIdx.x) * k * cin + tp * cin + s * KC + cc] = sum;
        }
      }
    }

    const float* Wq = Ws + (q % NS) * KC * PW + warp * WN;
    const float* Xq = Xs + tap * PX;
#ifndef CONV_PROBE_NO_MMA  // tools/kernel_probe.py: the staging alone
#pragma unroll
    for (int k8 = 0; k8 < KC; k8 += 8) {
      if (s * KC + k8 < cin) {  // the same for the whole block
        uint32_t bh[NTL][2], bl[NTL][2];
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) {
          split_tf32(Wq[(k8 + tig) * PW + nt * 8 + g], bh[nt][0], bl[nt][0]);
          split_tf32(Wq[(k8 + tig + 4) * PW + nt * 8 + g], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float* xa = Xq + (mt * 16 + g) * stride * PX + k8 + tig;
          const float* xb = xa + 8 * stride * PX;
          uint32_t ah[4], al[4];
          split_tf32(xa[0], ah[0], al[0]);
          split_tf32(xb[0], ah[1], al[1]);
          split_tf32(xa[4], ah[2], al[2]);
          split_tf32(xb[4], ah[3], al[3]);
          // The tensor cores add into their accumulator with truncation, not
          // round to nearest: a chain of K / 8 x 3 MMAs on one accumulator drifts
          // towards zero (7e-5 absolute at K = 768, 1e-3 of the moments). So a
          // chain is three MMAs from zero, the two small products first, and the
          // sum over k is taken with round-to-nearest adds on the CUDA cores.
          // (the four chains of an m16 tile are started side by side: back to back,
          // the three dependent MMAs of one chain would each wait out the last one's latency)
#ifdef CONV_PROBE_LONG_CHAINS  // tools/kernel_probe.py: what one chain over all of K costs in accuracy
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt) {
            mma_tf32(acc[mt][nt], al, bh[nt]);
            mma_tf32(acc[mt][nt], ah, bl[nt]);
            mma_tf32(acc[mt][nt], ah, bh[nt]);
          }
#else
          float part[NTL][4];
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt) mma_tf32_first(part[nt], al, bh[nt]);
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt) mma_tf32(part[nt], ah, bl[nt]);
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt) mma_tf32(part[nt], ah, bh[nt]);
#pragma unroll
          for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[nt][i];
#endif
        }
      }
    }
#endif
  }
  cp_async_wait<0>();

  // epilogue: raw output and this tile's per-channel partial sums of y^2 over
  // its rows < out_t. A warp owns its 32 channels for all 80 rows: thread
  // (g, tig) holds rows mt * 16 + g (+ 8) of channels nt * 8 + 2 * tig (+ 1).
  const size_t tile = (size_t)b * gridDim.x + blockIdx.x;
  const size_t n_tiles = (size_t)gridDim.x * gridDim.z;
#pragma unroll
  for (int nt = 0; nt < NTL; ++nt) {
    const int n = n0 + warp * WN + nt * 8 + 2 * tig;
    float q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int to = t0 + mt * 16 + g + 8 * half;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (to < out_t) {
          if (n < cout)  // cout is even here, so n + 1 < cout too
            *reinterpret_cast<float2*>(y + ((size_t)b * out_t + to) * cout + n) =
                make_float2(v0, v1);
          q0 = fmaf(v0, v0, q0);
          q1 = fmaf(v1, v1, q1);
        }
      }
    }
    // add the 8 row groups (lanes that differ in g) in a fixed order
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      q0 += __shfl_xor_sync(0xffffffffu, q0, m);
      q1 += __shfl_xor_sync(0xffffffffu, q1, m);
    }
    if (g == 0 && n < cout) {
      partial[(n_tiles + tile) * cout + n] = q0;
      partial[(n_tiles + tile) * cout + n + 1] = q1;
    }
  }
}

// ---- CUDA-core kernel: narrow inputs (bytes-bound) and odd shapes -----------

constexpr int NW = 16;    // k * cin up to which the weights live in registers
constexpr int DT = 256;   // threads per block

struct Prologue {
  const float *raw0, *raw1, *a0, *b0, *a1, *b1;
  int T, cin, relu_in;
  __device__ __forceinline__ float at(size_t row_base, int tin, int c) const {
    if (tin < 0 || tin >= T) return 0.f;
    const size_t off = (row_base + tin) * cin + c;
    float v = fmaf(raw0[off], a0[c], b0[c]);
    if (raw1 != nullptr) v += fmaf(raw1[off], a1[c], b1[c]);
    return relu_in ? fmaxf(v, 0.f) : v;
  }
};

// w[row][n .. n + 3], zeros past cout; one 16-byte load when vec
__device__ __forceinline__ float4 load_w4(const float* __restrict__ w, size_t row, int n,
                                          int cout, bool vec) {
  const float* p = w + row * cout + n;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v;
  v.x = n < cout ? __ldg(p) : 0.f;
  v.y = n + 1 < cout ? __ldg(p + 1) : 0.f;
  v.z = n + 2 < cout ? __ldg(p + 2) : 0.f;
  v.w = n + 3 < cout ? __ldg(p + 3) : 0.f;
  return v;
}

__device__ __forceinline__ void fma4(float4& acc, float x, const float4& wv) {
  acc.x = fmaf(x, wv.x, acc.x);
  acc.y = fmaf(x, wv.y, acc.y);
  acc.z = fmaf(x, wv.z, acc.z);
  acc.w = fmaf(x, wv.w, acc.w);
}

// Block (TX, TY), TX * TY = 256: thread (tx, ty) owns the four output channels
// 4 * (ng0 + tx) .. + 3 and the rows ty, ty + TY, ... of the block's 80.
// NARROW: k * cin <= NW, the normalised slab [(BM - 1) * stride + k][cin] in
// shared memory and the thread's weights in registers.
template <bool NARROW>
__global__ void __launch_bounds__(DT)
conv_bn_direct_kernel(Prologue pro, const float* __restrict__ w, float* __restrict__ y,
                      float* __restrict__ partial, int cout, int k, int stride, int lpad,
                      int out_t, int slab_floats, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                   // NARROW: the slab
  float4* red_s = reinterpret_cast<float4*>(smem + slab_floats);  // [TY][TX]
  float4* red_q = red_s + DT;
  const int TX = blockDim.x, TY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int t0 = blockIdx.x * BM;
  const int b = blockIdx.z;
  const int cin = pro.cin;
  const int kc = k * cin;
  const size_t row_base = (size_t)b * pro.T;
  const int tin0 = t0 * stride - lpad;

  if (NARROW) {
    const int n_el = ((BM - 1) * stride + k) * cin;
    for (int e = tid; e < n_el; e += DT) {
      const int j = e / cin;
      xs[e] = pro.at(row_base, tin0 + j, e - j * cin);
    }
    __syncthreads();
  }

  const int NG = (cout + 3) / 4;
  const size_t tile = (size_t)b * gridDim.x + blockIdx.x;
  const size_t n_tiles = (size_t)gridDim.x * gridDim.z;
  for (int ng0 = 0; ng0 < NG; ng0 += TX) {
    const int n = (ng0 + tx) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f), sq = s;
    if (n < cout) {
      float4 wreg[NW];
      if (NARROW) {
#pragma unroll
        for (int i = 0; i < NW; ++i)
          wreg[i] = i < kc ? load_w4(w, i, n, cout, vec) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int r = ty; r < BM && t0 + r < out_t; r += TY) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        if (NARROW) {
          // slab[(r * stride + tap) * cin + c] = slab[r * stride * cin + (tap * cin + c)]
          const float* xr = xs + r * stride * cin;
#pragma unroll
          for (int i = 0; i < NW; ++i)
            if (i < kc) fma4(acc, xr[i], wreg[i]);
        } else {
          for (int tap = 0; tap < k; ++tap)
            for (int c = 0; c < cin; ++c)
              fma4(acc, pro.at(row_base, tin0 + r * stride + tap, c),
                   load_w4(w, (size_t)tap * cin + c, n, cout, vec));
        }
        float* dst = y + ((size_t)b * out_t + t0 + r) * cout + n;
        if (vec) {
          *reinterpret_cast<float4*>(dst) = acc;
        } else {
          dst[0] = acc.x;
          if (n + 1 < cout) dst[1] = acc.y;
          if (n + 2 < cout) dst[2] = acc.z;
          if (n + 3 < cout) dst[3] = acc.w;
        }
        s.x += acc.x; s.y += acc.y; s.z += acc.z; s.w += acc.w;
        sq.x = fmaf(acc.x, acc.x, sq.x);
        sq.y = fmaf(acc.y, acc.y, sq.y);
        sq.z = fmaf(acc.z, acc.z, sq.z);
        sq.w = fmaf(acc.w, acc.w, sq.w);
      }
    }
    red_s[tid] = s;
    red_q[tid] = sq;
    __syncthreads();
    if (ty == 0 && n < cout) {
      for (int r = 1; r < TY; ++r) {  // fixed order
        const float4 ps = red_s[r * TX + tx], pq = red_q[r * TX + tx];
        s.x += ps.x; s.y += ps.y; s.z += ps.z; s.w += ps.w;
        sq.x += pq.x; sq.y += pq.y; sq.z += pq.z; sq.w += pq.w;
      }
      const float sv[4] = {s.x, s.y, s.z, s.w}, qv[4] = {sq.x, sq.y, sq.z, sq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < cout) {
          partial[tile * cout + n + i] = sv[i];
          partial[(n_tiles + tile) * cout + n + i] = qv[i];
        }
    }
    __syncthreads();
  }
}

// Second pass: fixed-order reduction of the per-tile partial moments.
// Block (32 channels x 32 tile lanes): lane ty sums tiles ty, ty+32, ... of
// channel n in float64 (reads coalesced across channels), then lane 0 adds
// the 32 lane sums in order -- the same result on every run.
constexpr int RED_C = 32;
constexpr int RED_T = 32;

__global__ void __launch_bounds__(RED_C * RED_T)
moments_reduce_kernel(const float* __restrict__ partial, float* __restrict__ sums,
                      float* __restrict__ sqs, int n_tiles, int cout) {
  __shared__ double red_s[RED_T][RED_C];
  __shared__ double red_q[RED_T][RED_C];
  const int n = blockIdx.x * RED_C + threadIdx.x;
  double s = 0.0, q = 0.0;
  if (n < cout) {
    for (int t = threadIdx.y; t < n_tiles; t += RED_T) {
      if (sums != nullptr) s += (double)partial[(size_t)t * cout + n];
      q += (double)partial[((size_t)n_tiles + t) * cout + n];
    }
  }
  red_s[threadIdx.y][threadIdx.x] = s;
  red_q[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && n < cout) {
    for (int r = 1; r < RED_T; ++r) {
      s += red_s[r][threadIdx.x];
      q += red_q[r][threadIdx.x];
    }
    if (sums != nullptr) sums[n] = (float)s;
    sqs[n] = (float)q;
  }
}

// The tensor-core path's sum of y. Each MMA truncates its sum towards zero, which
// leaves y with a per-channel offset of ~5e-8 (its single values stay within 6e-6 of
// the plain version); summed over 160,000 rows that offset is 1e-2, up to 2e-4 of
// a channel sum that nearly cancels. The conv is linear, so the sum over rows of y
// is w applied to the sum over rows of x: first the column sums of x, per-tile
// partials added over the tiles in a fixed order in float64 ...
__global__ void __launch_bounds__(256)
colsum_reduce_kernel(const float* __restrict__ xpart, double* __restrict__ colsum, int n_tiles,
                     int kc) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= kc) return;
  double s = 0.0;
  for (int t = 0; t < n_tiles; ++t) s += (double)xpart[(size_t)t * kc + j];
  colsum[j] = s;
}

// ... then sums[n] = sum_j w[j, n] * colsum[j] (j over taps and input channels).
__global__ void __launch_bounds__(256)
sums_from_colsum_kernel(const float* __restrict__ w, const double* __restrict__ colsum,
                        float* __restrict__ sums, int kc, int cout) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= cout) return;
  double s = 0.0;
  for (int j = 0; j < kc; ++j) s += (double)w[(size_t)j * cout + n] * colsum[j];
  sums[n] = (float)s;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Number of row tiles (partial-moment rows) the scratch buffer must hold
// per moment: batch * ceil(out_t / 80).
int conv_bn_row_tiles(int batch, int out_t) { return batch * ((out_t + BM - 1) / BM); }

// Which kernel a shape takes (pointers assumed 16-byte aligned): 2 the tensor-
// core kernel, 1 the CUDA-core kernel with its slab and weights on chip
// (narrow inputs), 0 the CUDA-core kernel reading global memory.
int conv_bn_route(int cin, int cout, int k, int stride, int two_terms) {
  const int slab_rows = (BM - 1) * stride + k;
  const size_t mma_smem =
      sizeof(float) * ((size_t)slab_rows * PX + NS * KC * PW +
                       (two_terms ? 2 : 1) * (size_t)slab_rows * KC);
  if (cin >= 8 && cin % 4 == 0 && cout % 4 == 0 && mma_smem <= MAX_SMEM) return 2;
  const size_t narrow_smem = sizeof(float) * ((size_t)slab_rows * cin + 8 * DT);
  if (k * cin <= NW && narrow_smem <= MAX_SMEM) return 1;
  return 0;
}

// raw1/a1/b1 may be null (one term). partial: [2, row_tiles, cout] float32. xpart
// ([row_tiles, k * cin] float32) and colsum ([k * cin] float64) are scratch of the
// tensor-core route (conv_bn_route(...) == 2) and may be null otherwise; without them
// the launch takes the CUDA-core kernel.
int conv_bn_launch(const float* raw0, const float* raw1, const float* a0, const float* b0,
                   const float* a1, const float* b1, const float* w, float* y,
                   float* partial, float* xpart, double* colsum, float* sums, float* sqs,
                   int batch, int T, int cin,
                   int cout, int k, int stride, int lpad, int out_t, int relu_in,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int row_tiles = (out_t + BM - 1) / BM;
  const int slab_rows = (BM - 1) * stride + k;
  const bool two = raw1 != nullptr;
  const bool aligned = aligned16(raw0) && aligned16(raw1) && aligned16(a0) && aligned16(b0) &&
                       aligned16(a1) && aligned16(b1) && aligned16(w) && aligned16(y);
  int route = conv_bn_route(cin, cout, k, stride, two);
  if (route == 2 && !(aligned && xpart != nullptr && colsum != nullptr))
    route = k * cin <= NW ? 1 : 0;
  cudaError_t err;
  if (route == 2) {
    const size_t smem = sizeof(float) * ((size_t)slab_rows * PX + NS * KC * PW +
                                         (two ? 2 : 1) * (size_t)slab_rows * KC);
    err = cudaFuncSetAttribute(conv_bn_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(row_tiles, (cout + BN - 1) / BN, batch);
    conv_bn_mma_kernel<<<grid, NT, smem, st>>>(raw0, raw1, a0, b0, a1, b1, w, y, partial, xpart,
                                               T, cin, cout, k, stride, lpad, out_t, relu_in);
  } else {
    const Prologue pro{raw0, raw1, a0, b0, a1, b1, T, cin, relu_in};
    const int vec = (cout % 4 == 0 && aligned16(w) && aligned16(y)) ? 1 : 0;
    const int groups = (cout + 3) / 4;
    int tx = 1;
    while (tx < groups && tx < 64) tx *= 2;
    dim3 block(tx, DT / tx), grid(row_tiles, 1, batch);
    const int slab_floats = route == 1 ? ((slab_rows * cin + 3) / 4) * 4 : 0;
    const size_t smem = sizeof(float) * ((size_t)slab_floats + 8 * DT);
    auto kernel = route == 1 ? conv_bn_direct_kernel<true> : conv_bn_direct_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, block, smem, st>>>(pro, w, y, partial, cout, k, stride, lpad, out_t,
                                      slab_floats, vec);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the sums of squares always from the partials; the sums too, except on the
  // tensor-core route, whose partial sums are not written
  moments_reduce_kernel<<<(cout + RED_C - 1) / RED_C, dim3(RED_C, RED_T), 0, st>>>(
      partial, route == 2 ? nullptr : sums, sqs, batch * row_tiles, cout);
  err = cudaGetLastError();
  if (err != cudaSuccess || route != 2) return (int)err;
  const int kc = k * cin;
  colsum_reduce_kernel<<<(kc + 255) / 256, 256, 0, st>>>(xpart, colsum, batch * row_tiles, kc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sums_from_colsum_kernel<<<(cout + 255) / 256, 256, 0, st>>>(w, colsum, sums, kc, cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
