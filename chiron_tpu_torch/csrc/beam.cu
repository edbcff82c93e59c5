// CTC prefix beam search (search + traceback), blank = last class.
//
// Replaces the TPU kernels in chiron_tpu/ops/pallas/beam.py:
//   beam_warp_kernel / beam_block_kernel <- beam_search_pallas's search (beam.py:418)
//   beam_traceback_kernel                <- _traceback_kernel (beam.py:462)
// with the semantics of the XLA twin chiron_tpu/ops/ctc_beam.py:50-188
// (which the Pallas kernel matches exactly): per step, stay and extend
// candidates scored in log space with the -1e30 sentinel, length_bonus on
// every extend (merged extend mass included), extends merged into stays
// with an equal 32-bit rolling prefix hash (h * 2654435761 + label + 1,
// wrapping uint32, whatever the label), then the exact top-W of the
// candidate pool [stays | extends by label 0 | ...] with ties to the lowest
// index (the lax.top_k order). Rows past their length freeze and emit
// identity records; the trace holds (char + 1) * W + parent.
//
// What bounds it on an H100: nothing the card's peak rates see. Per row the
// T steps are sequential and each step is a few hundred operations on a
// W * C candidate pool (150 at W = 30, C = 5), so the search is bound by the
// latency of one step times T, and the traceback by T dependent loads a row.
// The design attacks that latency:
//  - beam_warp_kernel (W <= 32, C <= 8: the `call --beam 30` path): ONE WARP
//    A ROW, several rows a block, no block barrier at all. Lane x owns beam
//    x: its state (pb, pnb, hash, last label) and its C candidates (the stay
//    and the C - 1 extends) stay in registers. The row's lp is staged in
//    shared memory by cp.async in chunks of TCH steps, double-buffered, so
//    no step waits on device memory. Merge by match: each extend compares
//    its hash with the W stay hashes (16-byte broadcast loads from shared
//    memory, no branch) and, on a match,
//    counts itself into that stay (shared atomics) and leaves its mass
//    there; a stay matched once takes that mass as it is (the plain
//    version's max-then-sum of one term is the term), a stay matched more
//    than once (a hash collision) scans the extends in ascending order with
//    the plain version's max-then-sum. Top-W: each lane sorts its C keys
//    (score descending, pool index ascending) in registers, then W rounds of
//    a warp max (redux.sync) over the lanes' heads pick the candidates in
//    order; a tied max goes to the lowest pool index. Three __syncwarp a step.
//  - beam_block_kernel (any other W and C: the wide beams): one block a row,
//    threads loop over beams and candidates, the pool in dynamic shared
//    memory sized from (W, C) (raised past 48 KB), the same merge by match,
//    and the top-W by a bitonic sort of 64-bit keys (order-preserving score
//    bits, then the complement of the pool index) in shared memory. The
//    launcher refuses only a pool that a block's 227 KB cannot hold.
//  - beam_traceback_kernel: one block a row stages the row's [T, W] trace in
//    shared memory in chunks (cp.async, 16 bytes where aligned), latest steps
//    first, splits each record into (char, parent) in parallel, and one
//    thread walks a chunk while the block copies the one before it: T
//    dependent shared-memory loads instead of T L2 round trips.
// Scores are compared through order_key, which maps a float to a uint32 of
// the same order (-0 taken as +0), so the selection is exactly
// torch.sort(..., descending=True, stable=True) on finite scores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr uint32_t MULT = 2654435761u;
constexpr uint32_t NONE = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int TCH = 64;         // steps of lp staged per chunk
constexpr int WARP_ROWS = 4;    // rows (warps) per block of the warp kernel
constexpr int WARP_MAX_W = 32;
constexpr int WARP_MAX_C = 8;
constexpr int BLOCK_THREADS = 256;
constexpr int MAX_SMEM = 232448;
constexpr int TB_THREADS = 256;
constexpr int TB_CHUNK_INTS = 4096;  // trace ints of one traceback chunk (two chunks: 32 KB)

// tools/kernel_probe.py builds this file with -DBEAM_PROBE: thread 0 of block 0
// (the first row) then adds up the clocks it spends in each phase of a step.
#ifdef BEAM_PROBE
__device__ long long beam_probe_clocks[8];
#define PROBE_INIT long long probe_last = clock64();
#define PROBE(i)                                \
  if (threadIdx.x == 0 && blockIdx.x == 0) {    \
    const long long now = clock64();            \
    beam_probe_clocks[i] += now - probe_last;   \
    probe_last = now;                           \
  }
#else
#define PROBE_INIT
#define PROBE(i)
#endif

__device__ __forceinline__ float lae(float a, float b) {
  const float mx = fmaxf(a, b);
  const float mn = fminf(a, b);
  return mx <= NEG ? NEG : mx + log1pf(expf(mn - mx));
}

// float -> uint32 of the same order (-0 taken as +0). Every real score's key
// is > 0, so 0 serves as "no candidate".
// lae(NEG, v), the score of an extend (its pb is NEG): v itself, or NEG
__device__ __forceinline__ float ext_score(float v) { return v > NEG ? v : NEG; }

__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Merged extend mass of a stay with hash hy that `count` extends matched: one
// match is its mass as it is (max-then-sum of one term); with `scan` (some
// hash matched more than once: a collision) every stay combines its matches as
// the plain version does, max then sum of exps in ascending extend order,
// which gives the same value for zero or one match.
__device__ __forceinline__ float merged_mass(bool scan, int count, float single, uint32_t hy,
                                             const float* ext_raw, const uint32_t* ext_h,
                                             int n_ext) {
  if (count == 0 && !scan) return NEG;
  float mmax = single;
  if (scan) {
    mmax = NEG;
    for (int e = 0; e < n_ext; ++e)
      if (ext_h[e] == hy) mmax = fmaxf(mmax, ext_raw[e]);
    float msum = 0.f;
    for (int e = 0; e < n_ext; ++e)
      if (ext_h[e] == hy) msum += expf(ext_raw[e] - mmax);
    return mmax > NEG / 2 ? mmax + logf(fmaxf(msum, 1e-37f)) : NEG;
  }
  return mmax > NEG / 2 ? mmax : NEG;
}

// ---- the warp kernel: W <= 32, C <= 8, one warp a row ----------------------

// The warp kernel's key: order_key of the score, except that candidates at
// the NEG sentinel (which tie) get distinct keys below every real score's, in
// pool-index order (scores are never below NEG, so those keys are free).
__device__ __forceinline__ uint32_t warp_key(float score, uint32_t idx) {
  constexpr uint32_t KNEG = 0x0EB60D35u;  // order_key(NEG)
  const uint32_t k = order_key(score);
  return k == KNEG ? KNEG - 1u - idx : k;
}

// drop the head of a lane's sorted candidates when it won the round
template <int C>
__device__ __forceinline__ void shift_head(uint32_t (&key)[C], uint32_t (&idx)[C], bool mine) {
#pragma unroll
  for (int c = 0; c + 1 < C; ++c) {
    key[c] = mine ? key[c + 1] : key[c];
    idx[c] = mine ? idx[c + 1] : idx[c];
  }
  key[C - 1] = mine ? 0u : key[C - 1];
  idx[C - 1] = mine ? NONE : idx[C - 1];
}

// Floats of one warp's shared memory: lp chunks [2][TCH][C], candidate pnb
// [32 * C], raw extend mass and hashes [32 * (C - 1)] each, stay pb [32],
// hashes and last labels [2][32] each (by step parity), match counts and
// matched mass [64] each (32 stays, then a slot a lane for the extends that
// match nothing) and selections [32].
__host__ __device__ constexpr int warp_floats(int C) {
  return 2 * TCH * C + WARP_MAX_W * (C + 2 * (C - 1) + 10);
}

// One block of WARP_ROWS warps an SM is enough (a row is one warp, and the
// step's latency, not the SM's throughput, bounds it): the registers go to the
// lane's candidates and the unrolled merge, with no spill.
template <int C>
__global__ void __launch_bounds__(32 * WARP_ROWS, 1)
    beam_warp_kernel(const float* __restrict__ lp, const int* __restrict__ lens,
                     int* __restrict__ trace, float* __restrict__ pb_out,
                     float* __restrict__ pnb_out, int B, int T, int W, float bonus) {
  constexpr int NL = C - 1;  // labels
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARP_ROWS + warp;
  if (b >= B) return;  // the whole warp: no block barrier follows
  float* lp_s = smem + warp * warp_floats(C);      // [2][TCH][C]
  float* cpnb = lp_s + 2 * TCH * C;                 // [W * C] candidate pnb, pool order
  float* ext_raw = cpnb + WARP_MAX_W * C;           // [NL * W] extend mass before the kill
  uint32_t* ext_h = reinterpret_cast<uint32_t*>(ext_raw + WARP_MAX_W * NL);  // [NL * W]
  float* spb = reinterpret_cast<float*>(ext_h + WARP_MAX_W * NL);           // [W] stay pb
  uint32_t* hs = reinterpret_cast<uint32_t*>(spb + WARP_MAX_W);  // [2][W] hashes, by parity
  int* lst = reinterpret_cast<int*>(hs + 2 * WARP_MAX_W);        // [2][W] last labels
  int* mcnt = lst + 2 * WARP_MAX_W;                                         // [W] match counts
  float* mval = reinterpret_cast<float*>(mcnt + 2 * WARP_MAX_W);            // [W] matched mass
  uint32_t* sel = reinterpret_cast<uint32_t*>(mval + 2 * WARP_MAX_W);       // [W] selections

  const int len = min(max(lens[b], 0), T);
  const float* lp_row = lp + (size_t)b * T * C;
  int* tr = trace + (size_t)b * T * W;
  const bool beam = lane < W;
  const int n_ext = NL * W;

  auto stage = [&](int chunk) {  // steps [chunk * TCH, ...) below len
    float* dst = lp_s + (chunk & 1) * TCH * C;
    const int n = min(TCH, len - chunk * TCH) * C;
    const float* src = lp_row + (size_t)chunk * TCH * C;
    for (int i = lane; i < n; i += 32) cp_async4(dst + i, src + i);
    cp_async_commit();
  };

  float pb = lane == 0 ? 0.f : NEG, pnb = NEG;
  uint32_t h = lane == 0 ? 1u : (uint32_t)lane * 7919u + 3u;
  int last = -1;
  mcnt[lane] = 0;
  mcnt[WARP_MAX_W + lane] = 0;
  if (len > 0) stage(0);

  PROBE_INIT
  for (int t = 0; t < len; ++t) {
    if (t % TCH == 0) {
      cp_async_wait_all();
      __syncwarp();  // this chunk is down for every lane; the other buffer is free
      if (t + TCH < len) stage(t / TCH + 1);
    }
    const float* lpt = lp_s + ((t / TCH) & 1) * TCH * C + (t % TCH) * C;
    float lpv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) lpv[c] = lpt[c];
    // the beams' hashes and last labels where every lane reads them (by step
    // parity: the slots written here were last read two steps ago)
    uint32_t* hcur = hs + (t & 1) * WARP_MAX_W;
    int* lcur = lst + (t & 1) * WARP_MAX_W;
    hcur[lane] = h;
    lcur[lane] = last;
    __syncwarp();
    PROBE(0)  // the lp fetch (a chunk wait every TCH steps) and the state's publication

    // stay and extends of beam `lane`
    const float pbnb = lae(pb, pnb);
    const float stay_pb = pbnb + lpv[NL];
    float lp_last = NEG;
#pragma unroll
    for (int c = 0; c < NL; ++c)
      if (c == last) lp_last = lpv[c];
    const float stay_pnb0 = last >= 0 ? pnb + lp_last : NEG;
    float ext[NL];
    uint32_t eh[NL];
    const uint32_t hm = h * MULT;
#pragma unroll
    for (int c = 0; c < NL; ++c) {
      ext[c] = lpv[c] + (c == last ? pb : pbnb) + bonus;
      eh[c] = hm + (uint32_t)(c + 1);
      if (beam) {
        ext_raw[c * W + lane] = ext[c];
        ext_h[c * W + lane] = eh[c];
      }
    }
    PROBE(1)  // the stay and extend values

    // merge by match: every extend against the W stay hashes, without a
    // branch; the matches (rare) are then counted into their stays
    int my_y[NL], nm[NL];
#pragma unroll
    for (int c = 0; c < NL; ++c) my_y[c] = nm[c] = 0;
    // the hashes four at a time (16-byte broadcast loads, all in flight at once)
#pragma unroll
    for (int q = 0; q < WARP_MAX_W / 4; ++q) {
      if (4 * q >= W) break;
      const uint4 h4 = reinterpret_cast<const uint4*>(hcur)[q];
      const uint32_t hq[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int y = 4 * q + j;
#pragma unroll
        for (int c = 0; c < NL; ++c) {
          const bool m = eh[c] == hq[j] && y < W;
          my_y[c] = m ? y : my_y[c];
          nm[c] += m;
        }
      }
    }
    // every extend counts itself into the stay it matched, or into its lane's
    // own slot past the stays when it matched none (no branch)
    bool multi = false;
#pragma unroll
    for (int c = 0; c < NL; ++c) {
      const bool hit = beam && nm[c] > 0;
      const int slot = hit ? my_y[c] : WARP_MAX_W + lane;
      atomicAdd(&mcnt[slot], 1);
      mval[slot] = ext[c];  // read only when it is the stay's one match
      multi |= nm[c] > 1 && beam;
    }
    multi = __any_sync(FULL, multi);
    __syncwarp();
    PROBE(2)  // the hash match

    uint32_t key[C], idx[C];
    if (beam) {
      const int count = mcnt[lane];
      const float merged =
          merged_mass(multi || count > 1, count, mval[lane], h, ext_raw, ext_h, n_ext);
      mcnt[lane] = 0;
      const float stay_pnb = lae(stay_pnb0, merged);
      spb[lane] = stay_pb;
      cpnb[lane] = stay_pnb;
      key[0] = warp_key(lae(stay_pb, stay_pnb), lane);
      idx[0] = (uint32_t)lane;
#pragma unroll
      for (int c = 0; c < NL; ++c) {
        const float v = nm[c] > 0 ? NEG : ext[c];  // an extend that matched a stay is merged
        cpnb[W + c * W + lane] = v;
        idx[c + 1] = (uint32_t)(W + c * W + lane);
        key[c + 1] = warp_key(ext_score(v), idx[c + 1]);
      }
      // this lane's candidates in (score descending, index ascending) order
#pragma unroll
      for (int i = 1; i < C; ++i)
#pragma unroll
        for (int j = i; j > 0; --j) {
          const bool up = key[j] > key[j - 1] || (key[j] == key[j - 1] && idx[j] < idx[j - 1]);
          const uint32_t k0 = key[j - 1], i0 = idx[j - 1];
          key[j - 1] = up ? key[j] : k0;
          idx[j - 1] = up ? idx[j] : i0;
          key[j] = up ? k0 : key[j];
          idx[j] = up ? i0 : idx[j];
        }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        key[c] = 0u;
        idx[c] = NONE;
      }
    }
    PROBE(3)  // the merge, the scores and the lane's sort

    // top-W: W rounds of a warp max (one redux.sync) over the lanes' heads,
    // the winner shifting its list by selects. Two heads with one key (equal
    // finite scores) would both win a round: a vote off the critical path
    // notes it, and the rounds are then run again from the sorted lists with
    // a second redux.sync that gives the round to the lowest pool index.
    uint32_t key0[C], idx0[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      key0[c] = key[c];
      idx0[c] = idx[c];
    }
    unsigned ties = 0;
    for (int k = 0; k < W; ++k) {
      const uint32_t best = __reduce_max_sync(FULL, key[0]);
      const bool mine = key[0] == best;
      const unsigned won = __ballot_sync(FULL, mine);
      ties |= won & (won - 1);
      if (mine) sel[k] = idx[0];
      shift_head<C>(key, idx, mine);
    }
    if (ties) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        key[c] = key0[c];
        idx[c] = idx0[c];
      }
      for (int k = 0; k < W; ++k) {
        const uint32_t best = __reduce_max_sync(FULL, key[0]);
        const uint32_t win = __reduce_min_sync(FULL, key[0] == best ? idx[0] : NONE);
        const bool mine = idx[0] == win;
        if (mine) sel[k] = win;
        shift_head<C>(key, idx, mine);
      }
    }
    __syncwarp();
    PROBE(4)  // the top-W

    if (beam) {
      const int i = (int)sel[lane];
      const bool is_stay = i < W;
      const int parent = is_stay ? i : (i - W) % W;
      const int ch = is_stay ? -1 : (i - W) / W;
      const uint32_t ph = hcur[parent];
      pb = is_stay ? spb[i] : NEG;
      pnb = cpnb[i];
      h = is_stay ? ph : ph * MULT + (uint32_t)(ch + 1);
      last = is_stay ? lcur[parent] : ch;
      tr[(size_t)t * W + lane] = (ch + 1) * W + parent;
    }
    PROBE(5)  // the state update and the trace store
  }
  for (int i = lane; i < (T - len) * W; i += 32) tr[(size_t)len * W + i] = i % W;
  if (beam) {
    pb_out[(size_t)b * W + lane] = pb;
    pnb_out[(size_t)b * W + lane] = pnb;
  }
}

// ---- the block kernel: any W and C, one block a row -------------------------

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Bytes of the block kernel's shared memory: sort keys [NP] (8 bytes each,
// NP = W * C rounded up to a power of two), lp chunks [2][TCH][C], state
// [2][W] x (pb, pnb, hash, last), stay pb [W], candidate pnb [W * C], raw
// extend mass and hashes [(C - 1) * W] each, match counts and matched mass [W],
// and a flag (16 bytes).
__host__ __device__ inline long long block_smem_bytes(int W, int C) {
  const long long np = pow2_at_least(W * C);
  return 8 * np + 4LL * (2 * TCH * C + 8LL * W + W + (long long)W * C + 2LL * (C - 1) * W +
                         2LL * W) + 16;
}

__global__ void __launch_bounds__(BLOCK_THREADS)
    beam_block_kernel(const float* __restrict__ lp, const int* __restrict__ lens,
                      int* __restrict__ trace, float* __restrict__ pb_out,
                      float* __restrict__ pnb_out, int T, int C, int W, float bonus) {
  extern __shared__ __align__(16) unsigned long long sm64[];
  const int NL = C - 1, n_ext = NL * W, cand = W * C;
  const int NP = pow2_at_least(cand);
  unsigned long long* keys = sm64;                                   // [NP]
  float* lp_s = reinterpret_cast<float*>(keys + NP);                 // [2][TCH][C]
  float* st_pb = lp_s + 2 * TCH * C;                                 // [2][W] by step parity
  float* st_pnb = st_pb + 2 * W;                                     // [2][W]
  uint32_t* st_h = reinterpret_cast<uint32_t*>(st_pnb + 2 * W);      // [2][W]
  int* st_last = reinterpret_cast<int*>(st_h + 2 * W);               // [2][W]
  float* spb = reinterpret_cast<float*>(st_last + 2 * W);            // [W]
  float* cpnb = spb + W;                                             // [W * C]
  float* ext_raw = cpnb + cand;                                      // [NL * W]
  uint32_t* ext_h = reinterpret_cast<uint32_t*>(ext_raw + n_ext);    // [NL * W]
  int* mcnt = reinterpret_cast<int*>(ext_h + n_ext);                 // [W]
  float* mval = reinterpret_cast<float*>(mcnt + W);                  // [W]
  int* multi = reinterpret_cast<int*>(mval + W);  // some extend matched two stays this step

  const int b = blockIdx.x, tid = threadIdx.x;
  const int len = min(max(lens[b], 0), T);
  const float* lp_row = lp + (size_t)b * T * C;
  int* tr = trace + (size_t)b * T * W;

  auto stage = [&](int chunk) {
    float* dst = lp_s + (chunk & 1) * TCH * C;
    const int n = min(TCH, len - chunk * TCH) * C;
    const float* src = lp_row + (size_t)chunk * TCH * C;
    for (int i = tid; i < n; i += BLOCK_THREADS) cp_async4(dst + i, src + i);
    cp_async_commit();
  };

  for (int x = tid; x < W; x += BLOCK_THREADS) {
    st_pb[x] = x == 0 ? 0.f : NEG;
    st_pnb[x] = NEG;
    st_h[x] = x == 0 ? 1u : (uint32_t)x * 7919u + 3u;
    st_last[x] = -1;
    mcnt[x] = 0;
  }
  if (len > 0) stage(0);

  PROBE_INIT
  for (int t = 0; t < len; ++t) {
    const int cur = (t & 1) * W, nxt = W - cur;
    if (t % TCH == 0) {
      cp_async_wait_all();
      __syncthreads();
      if (t + TCH < len) stage(t / TCH + 1);
    }
    const float* lpt = lp_s + ((t / TCH) & 1) * TCH * C + (t % TCH) * C;
    const float lp_blank = lpt[NL];
    PROBE(0)  // the lp fetch
    if (tid == 0) *multi = 0;
    for (int x = tid; x < W; x += BLOCK_THREADS) {
      const float pb = st_pb[cur + x], pnb = st_pnb[cur + x];
      const int last = st_last[cur + x];
      const uint32_t hm = st_h[cur + x] * MULT;
      const float pbnb = lae(pb, pnb);
      spb[x] = pbnb + lp_blank;
      cpnb[x] = last >= 0 ? pnb + lpt[last] : NEG;  // the stay's own pnb, before the merge
      for (int c = 0; c < NL; ++c) {
        ext_raw[c * W + x] = lpt[c] + (c == last ? pb : pbnb) + bonus;
        ext_h[c * W + x] = hm + (uint32_t)(c + 1);
      }
    }
    __syncthreads();
    PROBE(1)  // the stay and extend values
    // merge by match: each extend against the W stay hashes, without a
    // branch; the matches (rare) are then counted into their stays
    for (int e = tid; e < n_ext; e += BLOCK_THREADS) {
      const uint32_t he = ext_h[e];
      int my = 0, n = 0;
#pragma unroll 4
      for (int y = 0; y < W; ++y) {
        const bool m = st_h[cur + y] == he;
        my = m ? y : my;
        n += m;
      }
      const float v = ext_raw[e];
      if (n > 0) {
        atomicAdd(&mcnt[my], 1);
        mval[my] = v;  // read only when it is the stay's one match
        if (n > 1) *multi = 1;
      }
      const float vk = n > 0 ? NEG : v;
      cpnb[W + e] = vk;
      keys[W + e] = ((unsigned long long)order_key(ext_score(vk)) << 32) | (NONE - (uint32_t)(W + e));
    }
    for (int i = cand + tid; i < NP; i += BLOCK_THREADS) keys[i] = 0ull;
    __syncthreads();
    PROBE(2)  // the hash match
    for (int x = tid; x < W; x += BLOCK_THREADS) {
      const int count = mcnt[x];
      const float merged = merged_mass(*multi != 0 || count > 1, count, mval[x], st_h[cur + x],
                                       ext_raw, ext_h, n_ext);
      mcnt[x] = 0;
      const float stay_pnb = lae(cpnb[x], merged);
      cpnb[x] = stay_pnb;
      keys[x] = ((unsigned long long)order_key(lae(spb[x], stay_pnb)) << 32) | (NONE - (uint32_t)x);
    }
    __syncthreads();
    PROBE(3)  // the merge and the scores
    // bitonic sort of the keys, descending: best score first, then lowest index
    for (int size = 2; size <= NP; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < NP / 2; i += BLOCK_THREADS) {
          const int lo = 2 * i - (i & (stride - 1));
          const int hi = lo + stride;
          const unsigned long long a = keys[lo], c = keys[hi];
          if ((a < c) == ((lo & size) == 0)) {
            keys[lo] = c;
            keys[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    PROBE(4)  // the top-W
    for (int k = tid; k < W; k += BLOCK_THREADS) {
      const int i = (int)(NONE - (uint32_t)keys[k]);
      const bool is_stay = i < W;
      const int parent = is_stay ? i : (i - W) % W;
      const int ch = is_stay ? -1 : (i - W) / W;
      const uint32_t ph = st_h[cur + parent];
      st_pb[nxt + k] = is_stay ? spb[i] : NEG;
      st_pnb[nxt + k] = cpnb[i];
      st_h[nxt + k] = is_stay ? ph : ph * MULT + (uint32_t)(ch + 1);
      st_last[nxt + k] = is_stay ? st_last[cur + parent] : ch;
      tr[(size_t)t * W + k] = (ch + 1) * W + parent;
    }
    __syncthreads();
    PROBE(5)  // the state update and the trace store
  }
  for (int i = tid; i < (T - len) * W; i += BLOCK_THREADS) tr[(size_t)len * W + i] = i % W;
  const int fin = (len & 1) * W;
  for (int x = tid; x < W; x += BLOCK_THREADS) {
    pb_out[(size_t)b * W + x] = st_pb[fin + x];
    pnb_out[(size_t)b * W + x] = st_pnb[fin + x];
  }
}

// ---- the traceback ----------------------------------------------------------

// steps of one traceback chunk: two chunks of TC * W ints in shared memory
__host__ __device__ inline int tb_chunk_steps(int T, int W) {
  return max(1, min(T, TB_CHUNK_INTS / W));
}

__global__ void __launch_bounds__(TB_THREADS)
    beam_traceback_kernel(const int* __restrict__ trace, const int* __restrict__ best,
                          int* __restrict__ chars, int T, int W) {
  extern __shared__ __align__(16) int tsm[];  // [2][TC * W]
  const int b = blockIdx.x, tid = threadIdx.x;
  const int TC = tb_chunk_steps(T, W);
  const int nch = (T + TC - 1) / TC;
  const int* tr = trace + (size_t)b * T * W;
  int* out = chars + (size_t)b * T;
  // 16-byte copies where the row and every chunk start on 16 bytes
  const bool vec = (reinterpret_cast<uintptr_t>(tr) & 15) == 0 && ((TC * W) & 3) == 0;

  // chunk k: steps [k * TC, min(T, (k + 1) * TC)), ints [first, first + n) of the row
  auto stage = [&](int k) {
    const int first = k * TC * W, n = (min(T, (k + 1) * TC) - k * TC) * W;
    int* dst = tsm + (k & 1) * TC * W;
    if (vec && (n & 3) == 0) {
      for (int i = 4 * tid; i < n; i += 4 * TB_THREADS) cp_async16(dst + i, tr + first + i);
    } else {
      for (int i = tid; i < n; i += TB_THREADS) cp_async4(dst + i, tr + first + i);
    }
    cp_async_commit();
  };
  // each thread turns the records it copied, (char + 1) * W + parent, into
  // (char + 1) << 16 | parent (W < 65536)
  auto split = [&](int k) {
    const int n = (min(T, (k + 1) * TC) - k * TC) * W;
    int* buf = tsm + (k & 1) * TC * W;
    const bool v16 = vec && (n & 3) == 0;
    const int step = v16 ? 4 * TB_THREADS : TB_THREADS, run = v16 ? 4 : 1;
    for (int i = v16 ? 4 * tid : tid; i < n; i += step)
      for (int j = i; j < i + run; ++j) {
        const int v = buf[j];
        buf[j] = ((v / W) << 16) | (v % W);
      }
  };

  stage(nch - 1);
  int w = best[b];
  for (int k = nch - 1; k >= 0; --k) {
    cp_async_wait_all();
    split(k);
    __syncthreads();  // chunk k is down and split; chunk k + 1's buffer has been walked
    if (k > 0) stage(k - 1);
    if (tid == 0) {
      const int* buf = tsm + (k & 1) * TC * W;
      const int t0 = k * TC;
      for (int t = min(T, t0 + TC) - 1; t >= t0; --t) {
        const int p = buf[(t - t0) * W + w];
        out[t] = (p >> 16) - 1;
        w = p & 0xFFFF;
      }
    }
  }
}

// Which kernel takes (W, C): 1 the warp kernel, 2 the block kernel, 0 none
// (the block kernel's pool would not fit a block's shared memory); the
// wrapper's ops/beam.py:search_route mirrors it.
int search_route(int W, int C) {
  if (W < 1 || C < 2 || W > 65535) return 0;
  if (W <= WARP_MAX_W && C <= WARP_MAX_C) return 1;
  return block_smem_bytes(W, C) <= MAX_SMEM ? 2 : 0;
}

}  // namespace

extern "C" {

#ifdef BEAM_PROBE
// Copies the phase clocks to dst[8] and sets them to 0.
int beam_probe_read(long long* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, beam_probe_clocks, sizeof(long long) * 8);
  if (err != cudaSuccess) return (int)err;
  const long long zero[8] = {0};
  return (int)cudaMemcpyToSymbol(beam_probe_clocks, zero, sizeof(zero));
}
#endif

// lp: [B, T, C] float32 log-softmax (blank = C - 1); lens: [B] int32.
// trace: [B, T, W] int32; pb_out, pnb_out: [B, W] float32.
int beam_search_launch(const float* lp, const int* lens, int* trace, float* pb_out,
                       float* pnb_out, int B, int T, int C, int W, float bonus, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int route = search_route(W, C);
  if (route == 0 || B < 1 || T < 1) return (int)cudaErrorInvalidValue;
  if (route == 1) {
    const int smem = WARP_ROWS * warp_floats(C) * (int)sizeof(float);
    const dim3 grid((B + WARP_ROWS - 1) / WARP_ROWS), block(32 * WARP_ROWS);
    switch (C) {
#define BEAM_WARP_CASE(CC)                                                                    \
  case CC:                                                                                    \
    beam_warp_kernel<CC><<<grid, block, smem, s>>>(lp, lens, trace, pb_out, pnb_out, B, T, W, \
                                                   bonus);                                    \
    break;
      BEAM_WARP_CASE(2)
      BEAM_WARP_CASE(3)
      BEAM_WARP_CASE(4)
      BEAM_WARP_CASE(5)
      BEAM_WARP_CASE(6)
      BEAM_WARP_CASE(7)
      BEAM_WARP_CASE(8)
#undef BEAM_WARP_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  const int smem = (int)block_smem_bytes(W, C);
  cudaError_t err = cudaFuncSetAttribute((const void*)beam_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  beam_block_kernel<<<B, BLOCK_THREADS, smem, s>>>(lp, lens, trace, pb_out, pnb_out, T, C, W,
                                                   bonus);
  return (int)cudaGetLastError();
}

// trace: [B, T, W] int32, best: [B] int32 -> chars: [B, T] int32 (-1 = none).
int beam_traceback_launch(const int* trace, const int* best, int* chars, int B, int T, int W,
                          void* stream) {
  if (B < 1 || T < 1 || W < 1 || W > 65535) return (int)cudaErrorInvalidValue;
  const int smem = 2 * tb_chunk_steps(T, W) * W * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute((const void*)beam_traceback_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  beam_traceback_kernel<<<B, TB_THREADS, smem, (cudaStream_t)stream>>>(trace, best, chars, T, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
