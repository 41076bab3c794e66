// The exact 0-1 knapsack row selector for long general-integer rows of the
// Z sweep, for every (block row, replica), written for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/zsweep.py:
// _dp_select_pallas. It computes what that kernel computes, for each row b
// of a block and each replica:
//   rq_s = r_s when minimizing, -r_s when maximizing, DP_BIG on masked slots;
//   f[w] = 0 at w = -lo, DP_BIG elsewhere (w the gcd-scaled activity minus
//     lo, the row's least activity), chosen-set words all 0;
//   per slot s with scaled factor a_s: cand = f[w - a_s] + rq_s (DP_BIG
//     where w - a_s falls outside [0, W)); where cand < f[w] strictly,
//     f[w] = cand and the words of w become those of w - a_s (0 outside)
//     with bit s set in word s / 32;
//   the answer is the lowest w in [wlo, whi] with the least f (the lowest w
//     of all when none is below DP_BIG there); its bits are the chosen set.
//
// Design (first, simple version): one thread per (block row, replica),
// 32 replicas per CUDA block, grid (R/32, B). The table f[W] and the
// ceil(Kr/32) mask words live in a scratch in device memory that the
// wrapper allocates, laid out [B, W, R] and [B, nw, W, R] with the replica
// innermost, so the 32 threads of a warp touch one 128-byte line at each w.
// At the main path's shape (B 8, W 88, Kr 24, R 512) that is 2.9 MB, which
// stays in L2. The update is in place: w is walked downward when a_s >= 0
// and upward when a_s < 0, so f[w - a_s] is always read before this slot
// writes it (the 0-1 knapsack order), which gives exactly the TPU kernel's
// "shift the old table" semantics. The walk goes in chunks of U entries:
// all of a chunk's reads are issued before any of its writes (a chunk
// writes only entries that later chunks of the same slot never read), so
// U loads are in flight at once instead of one.
//
// What bounds it on this card: neither the bytes it must move (r read once,
// the chosen set written once) nor its operations (five per slot and w),
// but the latency of the table traffic through L1/L2: each thread runs
// Kr * W / U dependent rounds of loads, and a block of B rows is only
// B * R threads (4096 at the main path's shape) on 132 SMs. Tables in
// shared memory and several threads per (row, replica) are later work.
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
constexpr int U = 16;            // table entries per chunk of the walk

__global__ void dpselect_kernel(
    const int32_t* __restrict__ rows_c, const float* __restrict__ r,
    const uint8_t* __restrict__ mask, const int32_t* __restrict__ dp_fac,
    const int32_t* __restrict__ dp_lo, const int32_t* __restrict__ dp_blo,
    const int32_t* __restrict__ dp_bhi, float* f, uint32_t* words,
    uint8_t* __restrict__ out, int Kr, int R, int W, int nw, int minimize) {
  const int rep = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (rep >= R) return;
  const int row = rows_c[b];
  const int lo = dp_lo[row];
  const int wlo = dp_blo[row] - lo;
  const int whi = dp_bhi[row] - lo;
  const size_t RR = (size_t)R;
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

extern "C" int dpselect_launch(const void* rows_c, const void* r,
                               const void* mask, const void* dp_fac,
                               const void* dp_lo, const void* dp_blo,
                               const void* dp_bhi, void* f, void* words,
                               void* out, int B, int Kr, int R, int W,
                               int minimize, void* stream) {
  if (B < 1 || B > 65535 || Kr < 1 || R < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const int nw = (Kr + 31) / 32;
  const dim3 block(32);
  const dim3 grid((R + 31) / 32, B);
  dpselect_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rows_c, (const float*)r, (const uint8_t*)mask,
      (const int32_t*)dp_fac, (const int32_t*)dp_lo, (const int32_t*)dp_blo,
      (const int32_t*)dp_bhi, (float*)f, (uint32_t*)words, (uint8_t*)out, Kr,
      R, W, nw, minimize);
  return (int)cudaGetLastError();
}
