// The exact 0-1 knapsack row selector for long general-integer rows of the
// Z sweep, for every (block row, replica), written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/zsweep.py:
// _dp_select_pallas. That kernel keeps a [W, 128] table tile in VMEM with
// the replicas on the vector lanes and rolls it by a_s for every slot. It
// computes, and this file computes bit for bit, for each row b of a block
// and each replica:
//   rq_s = r_s when minimizing, -r_s when maximizing, DP_BIG on masked slots;
//   f[w] = 0 at w = -lo, DP_BIG elsewhere (w the gcd-scaled activity minus
//     lo, the row's least activity), chosen-set words all 0;
//   per slot s with scaled factor a_s: cand = f[w - a_s] + rq_s (DP_BIG
//     where w - a_s falls outside [0, W)); where cand < f[w] strictly,
//     f[w] = cand and the words of w become those of w - a_s (0 outside)
//     with bit s set in word s / 32;
//   the answer is the lowest w in [wlo, whi] with the least f (the lowest w
//     of all when none is below DP_BIG there); its bits are the chosen set.
// A row of the block that is no DP row gets an all-zero set (the sweep
// discards it).
//
// Design ("shared" variant, dpselect_kernel_shared). One CUDA block owns
// one row b of the block and G replicas; its threads are (g, t), replica
// fastest, with the T lanes t striding over w. The table lives in shared
// memory, laid out [w][G] so a warp reads consecutive words: two buffers
// of f (a slot reads the old one and writes the new one, so one barrier
// per slot separates them and no walk direction is needed) and, instead
// of carrying the chosen-set words along with f, one "take" word per
// (w, g) and 32 slots: bit s says that slot s improved f[w]. Only the
// thread that owns w ever touches its take words, so they need no barrier.
// The chosen set is read back at the end by walking from the best w
// through the slots in reverse: where bit s of w is set, slot s is chosen
// and w moves to w - a_s (outside [0, W) the carried words were 0: the
// walk stops). That is the same set the carried words hold, by induction
// over the slots. The reduced costs of the G replicas and the row's
// factors are staged in shared memory once; a masked slot of factor 0
// (rq = DP_BIG: cand = f[w] + DP_BIG is never below f[w]) is skipped by the
// whole CUDA block. The argmin reduces the pair (f, w) by "smaller f, then
// smaller w", first over a thread's own entries, then by xor shuffles in
// the warp, then over the warps in shared memory: any order gives the
// lowest w of the least f.
//
// What bounds it on this card: one barrier per live slot, each after
// W / T table entries per thread (a few shared-memory round trips), plus
// the argmin's reduction and the Kr-step walk back; neither the bytes (r
// read once, the set written once) nor the five operations per entry.
//
// The first design stays in the file as the "device_table" variant
// (dpselect_kernel_device_table): one thread per (row, replica), the table
// and the carried words in a device-memory scratch. The launch plan
// (ops/zsweep.py:dp_launch_plan) picks it for tables that fit shared
// memory at no group size.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. The DP is one add and one compare
// per entry, so it rounds exactly as the plain PyTorch version
// (ops/zsweep.py: dp_select_reference) does, and the two agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float DP_BIG = 1e30f;  // ops/zsweep.py DP_BIG
constexpr int U = 16;            // device_table: entries per chunk of the walk
constexpr unsigned FULL = 0xFFFFFFFFu;

// ---------------------------------------------------------------------------
// "shared" variant
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(1024) dpselect_kernel_shared(
    const int32_t* __restrict__ rows_c, const float* __restrict__ r,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ dp_row,
    const int32_t* __restrict__ dp_fac, const int32_t* __restrict__ dp_lo,
    const int32_t* __restrict__ dp_blo, const int32_t* __restrict__ dp_bhi,
    uint8_t* __restrict__ out, int Kr, int R, int W, int nw, int minimize,
    int G, int T) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int g = tid & (G - 1);
  const int t = tid / G;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * G;
  const int row = rows_c[b];
  const size_t RR = (size_t)R;
  uint8_t* ob = out + (size_t)b * Kr * RR + r0 + g;  // ob[s * R]

  if (!dp_row[row]) {  // the same for the whole CUDA block
    for (int s = t; s < Kr; s += T) ob[s * RR] = 0;
    return;
  }

  const int nwarps = (G * T) >> 5;
  float* fo = smem;                                 // [W][G] old table
  float* fn = fo + W * G;                           // [W][G] new table
  uint32_t* tw = (uint32_t*)(fn + W * G);           // [nw][W][G] take words
  float* rq = (float*)(tw + (size_t)nw * W * G);    // [Kr][G]
  int* fac = (int*)(rq + Kr * G);                   // [Kr]
  int* live = fac + Kr;                             // [Kr]
  float* redv = (float*)(live + Kr);                // [nwarps][G]
  int* redw = (int*)(redv + nwarps * G);            // [nwarps][G]
  uint32_t* sel = (uint32_t*)(redw + nwarps * G);   // [nw][G]

  const int lo = dp_lo[row];
  const int wlo = dp_blo[row] - lo;
  const int whi = dp_bhi[row] - lo;

  for (int w = t; w < W; w += T) {
    fo[w * G + g] = (w == -lo) ? 0.0f : DP_BIG;
    for (int q = 0; q < nw; ++q) tw[((size_t)q * W + w) * G + g] = 0u;
  }
  for (int s = t; s < Kr; s += T) {
    const float rv = r[((size_t)b * Kr + s) * RR + r0 + g];
    const int on = mask[(size_t)b * Kr + s];
    rq[s * G + g] = on ? (minimize ? rv : -rv) : DP_BIG;
    if (g == 0) {
      const int a = dp_fac[(size_t)row * Kr + s];
      fac[s] = a;
      live[s] = on || a != 0;
    }
  }
  __syncthreads();

  for (int s = 0; s < Kr; ++s) {
    // a masked slot with a = 0 takes nowhere (f + DP_BIG is never below f):
    // the whole CUDA block skips it
    if (!live[s]) continue;
    const int a = fac[s];
    const float q = rq[s * G + g];
    const int word = s >> 5;
    const uint32_t bit = 1u << (s & 31);
    for (int w = t; w < W; w += T) {
      const int src = w - a;
      const float fs = (src >= 0 && src < W) ? fo[src * G + g] : DP_BIG;
      const float cur = fo[w * G + g];
      const float cand = fs + q;
      const bool take = cand < cur;
      fn[w * G + g] = take ? cand : cur;
      if (take) tw[((size_t)word * W + w) * G + g] |= bit;
    }
    __syncthreads();
    float* tmp = fo;
    fo = fn;
    fn = tmp;
  }

  // the lowest w with the least f, with f outside [wlo, whi] read as DP_BIG
  float best = INFINITY;
  int wbest = 0x7FFFFFFF;
  for (int w = t; w < W; w += T) {
    const float v = (w >= wlo && w <= whi) ? fo[w * G + g] : DP_BIG;
    if (v < best) {
      best = v;
      wbest = w;
    }
  }
  for (int off = G; off < 32; off <<= 1) {
    const float ov = __shfl_xor_sync(FULL, best, off);
    const int ow = __shfl_xor_sync(FULL, wbest, off);
    if (ov < best || (ov == best && ow < wbest)) {
      best = ov;
      wbest = ow;
    }
  }
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (lane < G) {
    redv[warp * G + g] = best;
    redw[warp * G + g] = wbest;
  }
  __syncthreads();
  if (tid < G) {
    // with G < 32 the first warp holds every replica once in lanes < G; with
    // G = 32 each lane is its own replica
    best = redv[g];
    wbest = redw[g];
    for (int q = 1; q < nwarps; ++q) {
      const float ov = redv[q * G + g];
      const int ow = redw[q * G + g];
      if (ov < best || (ov == best && ow < wbest)) {
        best = ov;
        wbest = ow;
      }
    }
    // walk back through the slots: the carried words of wbest
    int w = wbest;
    uint32_t acc = 0u;
    for (int s = Kr - 1; s >= 0; --s) {
      if (w >= 0 && w < W &&
          ((tw[((size_t)(s >> 5) * W + w) * G + g] >> (s & 31)) & 1u)) {
        acc |= 1u << (s & 31);
        w -= fac[s];
      }
      if ((s & 31) == 0) {
        sel[(s >> 5) * G + g] = acc;
        acc = 0u;
      }
    }
  }
  __syncthreads();
  for (int s = t; s < Kr; s += T)
    ob[s * RR] = (uint8_t)((sel[(s >> 5) * G + g] >> (s & 31)) & 1u);
}

// ---------------------------------------------------------------------------
// "device_table" variant: one thread per (block row, replica), 32 replicas
// per CUDA block; f [B, W, R] and the carried words [B, nw, W, R] in device
// memory, updated in place: w is walked downward when a_s >= 0 and upward
// when a_s < 0, so f[w - a_s] is read before this slot writes it, in
// chunks of U entries whose reads all precede their writes
// ---------------------------------------------------------------------------

__global__ void dpselect_kernel_device_table(
    const int32_t* __restrict__ rows_c, const float* __restrict__ r,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ dp_row,
    const int32_t* __restrict__ dp_fac, const int32_t* __restrict__ dp_lo,
    const int32_t* __restrict__ dp_blo, const int32_t* __restrict__ dp_bhi,
    float* f, uint32_t* words, uint8_t* __restrict__ out, int Kr, int R, int W,
    int nw, int minimize) {
  const int rep = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (rep >= R) return;
  const int row = rows_c[b];
  const size_t RR = (size_t)R;
  if (!dp_row[row]) {
    for (int s = 0; s < Kr; ++s) out[((size_t)b * Kr + s) * RR + rep] = 0;
    return;
  }
  const int lo = dp_lo[row];
  const int wlo = dp_blo[row] - lo;
  const int whi = dp_bhi[row] - lo;
  float* fb = f + (size_t)b * W * RR + rep;             // fb[w * R]
  uint32_t* mb = words + (size_t)b * nw * W * RR + rep;  // mb[(t * W + w) * R]

  for (int w = 0; w < W; ++w) fb[w * RR] = (w == -lo) ? 0.0f : DP_BIG;
  for (int t = 0; t < nw * W; ++t) mb[t * RR] = 0u;

  for (int s = 0; s < Kr; ++s) {
    const int a = dp_fac[(size_t)row * Kr + s];
    const float rv = r[((size_t)b * Kr + s) * RR + rep];
    const float rq = mask[(size_t)b * Kr + s] ? (minimize ? rv : -rv) : DP_BIG;
    const int word = s >> 5;
    const uint32_t bit = 1u << (s & 31);
    const int dir = a >= 0 ? -1 : 1;
    const int w0 = a >= 0 ? W - 1 : 0;
    for (int c = 0; c < W; c += U) {
      float fo[U], fs[U];
      bool ok[U], take[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int w = w0 + dir * (c + u);
        const int src = w - a;
        const bool in = c + u < W;
        ok[u] = in && src >= 0 && src < W;
        fo[u] = in ? fb[w * RR] : 0.0f;
        fs[u] = ok[u] ? fb[src * RR] : DP_BIG;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int w = w0 + dir * (c + u);
        const float cand = fs[u] + rq;
        take[u] = (c + u < W) && cand < fo[u];
        if (take[u]) fb[w * RR] = cand;
      }
      for (int t = 0; t < nw; ++t) {
        uint32_t ms[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int src = w0 + dir * (c + u) - a;
          ms[u] = (take[u] && ok[u]) ? mb[((size_t)t * W + src) * RR] : 0u;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int w = w0 + dir * (c + u);
          if (take[u])
            mb[((size_t)t * W + w) * RR] = t == word ? (ms[u] | bit) : ms[u];
        }
      }
    }
  }

  // the lowest w with the least f, with f outside [wlo, whi] read as DP_BIG
  float best = INFINITY;
  int wbest = 0;
  for (int w = 0; w < W; ++w) {
    const float v = (w >= wlo && w <= whi) ? fb[w * RR] : DP_BIG;
    if (v < best) {
      best = v;
      wbest = w;
    }
  }
  for (int s = 0; s < Kr; ++s) {
    const uint32_t wd = mb[((size_t)(s >> 5) * W + wbest) * RR];
    out[((size_t)b * Kr + s) * RR + rep] = (uint8_t)((wd >> (s & 31)) & 1u);
  }
}

}  // namespace

// variant 0: device_table (f and words: its scratch tensors); variant 1:
// shared, with G replicas and T lanes over w per CUDA block and smem_bytes
// of dynamic shared memory, which must be what this layout needs.
extern "C" int dpselect_launch(const void* rows_c, const void* r,
                               const void* mask, const void* dp_row,
                               const void* dp_fac, const void* dp_lo,
                               const void* dp_blo, const void* dp_bhi, void* f,
                               void* words, void* out, int B, int Kr, int R,
                               int W, int minimize, int variant, int G, int T,
                               int smem_bytes, void* stream) {
  if (B < 1 || B > 65535 || Kr < 1 || R < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int nw = (Kr + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) {
    if (f == nullptr || words == nullptr) return (int)cudaErrorInvalidValue;
    dpselect_kernel_device_table<<<dim3((R + 31) / 32, B), 32, 0, st>>>(
        (const int32_t*)rows_c, (const float*)r, (const uint8_t*)mask,
        (const uint8_t*)dp_row, (const int32_t*)dp_fac, (const int32_t*)dp_lo,
        (const int32_t*)dp_blo, (const int32_t*)dp_bhi, (float*)f,
        (uint32_t*)words, (uint8_t*)out, Kr, R, W, nw, minimize);
    return (int)cudaGetLastError();
  }
  if (G < 1 || G > 32 || (G & (G - 1)) || R % G || T < 1 || (G * T) % 32 ||
      G * T > 1024)
    return (int)cudaErrorInvalidValue;
  const long long nwarps = G * T / 32;
  const long long need =
      4LL * ((2LL + nw) * W * G + (long long)Kr * G + 2LL * Kr +
             2LL * nwarps * G + (long long)nw * G);
  if (need != (long long)smem_bytes) return (int)cudaErrorInvalidValue;
  static int allowed = 48 * 1024;  // dynamic shared memory the kernel may use
  if (smem_bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        dpselect_kernel_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = smem_bytes;
  }
  dpselect_kernel_shared<<<dim3(R / G, B), G * T, smem_bytes, st>>>(
      (const int32_t*)rows_c, (const float*)r, (const uint8_t*)mask,
      (const uint8_t*)dp_row, (const int32_t*)dp_fac, (const int32_t*)dp_lo,
      (const int32_t*)dp_blo, (const int32_t*)dp_bhi, (uint8_t*)out, Kr, R, W,
      nw, minimize, G, T);
  return (int)cudaGetLastError();
}
