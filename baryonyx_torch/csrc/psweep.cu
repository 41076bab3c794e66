// One block-Jacobi Wedelin sweep over the scheduled rows, for every
// replica: the fused sweep of the solver's optimize loop, written for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/psweep.py:_make_kernel
// (launched by _psweep_call). It computes what that kernel computes:
//   phase A, per row of a block, against S as it stood at block entry:
//     reduced cost r = c_j (+CQ_j) - (S_j + a(theta-1)P), negated where
//     a < 0, plus amp*c_j; tie noise from a splitmix counter hash of
//     (seed pair, row k, slot s, replica); running order statistics
//     (count of keys <= 0, the J_bot smallest and J_top largest keys,
//     the largest nonpositive and the smallest positive key);
//   selection: selected, the threshold key, d and dpi;
//   phase B, row by row: P <- theta*P +- d, S updated incrementally,
//     masked write of x (the later row wins), then pi += dpi.
//
// Design (first, simple version): one thread per replica, 32 replicas per
// block, grid R/32. The state stays in device memory in the replica-
// innermost layout [*, R], so the 32 threads of a warp touch the same
// (row, slot) or variable at once and every load and store is one
// coalesced 128-byte transaction. Each thread walks the shared row order
// block by block; the order statistics live in registers
// (J_bot + J_top <= 8), the per-row threshold, d and dpi in a small local
// array, the noised keys in a [Bb, Kr, R] scratch tensor.
//
// What bounds it: bytes. Per sweep, for each scheduled (row, replica)
// pair, it reads P twice (phase A, then phase B rewrites it), gathers S_j
// per slot twice, writes and reads back the keys, and writes x per slot;
// an unscheduled pair reads only its sched byte. The arithmetic per byte
// is a few operations. At R <= 2048 the grid is at
// most 64 blocks of one warp each, so most of the 132 SMs sit idle and
// each SM has a single warp to hide memory latency with: the first design
// is latency bound well above its byte bound. Shared-memory tiles of S,
// several threads per replica-row and CUDA graphs are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// --fmad=false -shared -Xcompiler -fPIC. --fmad=false keeps every product
// and sum separately rounded, as PyTorch's separate ops round them, so the
// kernel and the plain PyTorch version (ops/psweep.py) agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_B = 16;  // rows per block (ops/psweep.py MAX_B)
constexpr int JMAX = 8;    // J_bot + J_top <= 8 (ops/layout.py)

__device__ __forceinline__ float draw_u(uint32_t seed_u, uint32_t rep,
                                        uint32_t k, uint32_t s) {
  uint32_t h = rep * 0x85EBCA6Bu + seed_u + k * 0xC2B2AE35u + s * 0x27D4EB2Fu;
  h = h ^ (h >> 15);
  h = h * 0x2C1B3C6Du;
  h = h ^ (h >> 12);
  h = h * 0x297A2D39u;
  h = h ^ (h >> 15);
  return (float)(h >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// The Pallas kernel's _pick over its first J registers: an index in
// [0, J-2] selects that register, anything else (negative or too large)
// the last one, regs[J-1].
__device__ __forceinline__ float pick(const float (&regs)[JMAX], int J,
                                      int idx) {
  float acc = regs[0];
#pragma unroll
  for (int t = 0; t < JMAX; ++t)
    if (t == J - 1) acc = regs[t];
#pragma unroll
  for (int t = 0; t < JMAX; ++t)
    if (t < J - 1 && idx == t) acc = regs[t];
  return acc;
}

// Running ascending insert: regs stays the JMAX smallest keys seen. The
// first J entries of a longer network equal those of a J-entry one.
__device__ __forceinline__ void insert_min(float (&regs)[JMAX], float v) {
#pragma unroll
  for (int t = JMAX - 1; t > 0; --t)
    regs[t] = v < regs[t - 1] ? regs[t - 1] : fminf(regs[t], v);
  regs[0] = fminf(regs[0], v);
}

__device__ __forceinline__ void insert_max(float (&regs)[JMAX], float v) {
#pragma unroll
  for (int t = JMAX - 1; t > 0; --t)
    regs[t] = v > regs[t - 1] ? regs[t - 1] : fmaxf(regs[t], v);
  regs[0] = fmaxf(regs[0], v);
}

template <bool UNIT, bool MINIMIZE, bool HAS_CQ>
__global__ void __launch_bounds__(32) psweep_kernel(
    float* __restrict__ S,             // [n, R]
    int32_t* __restrict__ x,           // [n, R]
    float* __restrict__ pi,            // [m, R]
    float* __restrict__ P,             // [m, Kr, R]
    float* __restrict__ keys,          // [Bb, Kr, R] scratch
    const uint8_t* __restrict__ sched, // [m, R] bool
    const int32_t* __restrict__ order, // [mp] rows, sentinel m
    const int32_t* __restrict__ n_rows_ptr,  // [1]
    const int32_t* __restrict__ rowmeta,     // [m, 5]
    const int32_t* __restrict__ row_vars,    // [m, Kr]
    const float* __restrict__ row_factor,    // [m, Kr]
    const float* __restrict__ cost,          // [n]
    const float* __restrict__ CQ,            // [n, R] or null
    const float* __restrict__ kappa,         // [R]
    const float* __restrict__ amp,           // [R]
    const float* __restrict__ delta,         // [R]
    const float* __restrict__ theta,         // [R]
    const int32_t* __restrict__ seed,        // [2]
    int m, int Kr, int R, int mp, int Bb, int J_bot, int J_top) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float inf = INFINITY;
  const float th = theta[r];
  const float de = delta[r];
  const float am = amp[r];
  const float kap = kappa[r];
  const float kp = kap / (1.0f - kap);
  const uint32_t seed_u =
      (uint32_t)seed[0] * 0x9E3779B9u + (uint32_t)seed[1];

  // n_rows is read here, on the device, so the caller never syncs
  int n_blocks = (*n_rows_ptr + Bb - 1) / Bb;
  n_blocks = min(max(n_blocks, 0), mp / Bb);

  float thr_b[MAX_B], d_b[MAX_B], dpi_b[MAX_B];

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int base = blk * Bb;

    // ---- phase A: decisions against block-entry S
    for (int b = 0; b < Bb; ++b) {
      const int k = order[base + b];
      if (k < 0 || k >= m) continue;  // padding: the sentinel is no index
      // an unscheduled (row, replica) pair changes nothing: dpi is 0, P
      // keeps its value, x is not written; skip both phases for it
      if (!sched[(size_t)k * R + r]) continue;
      const int32_t* meta = rowmeta + 5 * (size_t)k;
      const int bmin = meta[0], bmax = meta[1], csz = meta[2];
      const int rsz = meta[3], iseq = meta[4];
      const size_t rk = (size_t)k * Kr;

      int cnt = 0;
      float bots[JMAX], tops[JMAX];
#pragma unroll
      for (int t = 0; t < JMAX; ++t) {
        bots[t] = inf;
        tops[t] = -inf;
      }
      float mx_np = -inf, mn_p = inf;

      for (int s = 0; s < rsz; ++s) {
        const int j = row_vars[rk + s];
        float cj = cost[j];
        if (HAS_CQ) cj = cj + CQ[(size_t)j * R + r];
        const float Sj = S[(size_t)j * R + r];
        const float pr = P[(rk + s) * R + r];
        float rr;
        if (UNIT) {
          rr = cj - (Sj + (th - 1.0f) * pr);
        } else {
          const float af = row_factor[rk + s];
          rr = cj - (Sj + af * (th - 1.0f) * pr);
          if (af < 0.0f) rr = -rr;
        }
        rr = rr + am * cj;
        float sv = MINIMIZE ? rr : -rr;
        const float u = draw_u(seed_u, (uint32_t)r, (uint32_t)k, (uint32_t)s);
        sv = sv * (1.0f + (u - 0.5f) * 2e-6f) + (u - 0.5f) * (de * 1e-3f);
        keys[((size_t)b * Kr + s) * R + r] = sv;

        cnt += sv <= 0.0f ? 1 : 0;
        insert_min(bots, sv);
        insert_max(tops, sv);
        mx_np = fmaxf(mx_np, sv <= 0.0f ? sv : -inf);
        mn_p = fminf(mn_p, sv > 0.0f ? sv : inf);
      }

      // ---- selection (the sort-free scheme of ops/psweep.py)
      const int lo = bmin + csz;
      const int hi = min(bmax + csz, rsz);
      const int sel_eq = min(bmin + csz, rsz) - 1;
      const int sel_ineq = min(max(cnt, lo), hi) - 1;  // hi wins if lo > hi
      const int selected = iseq ? sel_eq : sel_ineq;
      const bool unclipped = !iseq && (selected + 1 == cnt);
      const bool bot_ok = selected >= 0 && selected < J_bot;
      const float sv_sel =
          unclipped ? mx_np
                    : (bot_ok ? pick(bots, J_bot, selected)
                              : pick(tops, J_top, rsz - 1 - selected));
      const float sv_sel1 =
          unclipped ? mn_p
                    : (selected + 1 < J_bot
                           ? pick(bots, J_bot, selected + 1)
                           : pick(tops, J_top, rsz - 2 - selected));
      const float Rs_sel = MINIMIZE ? sv_sel : -sv_sel;
      const float Rs_sel1 = MINIMIZE ? sv_sel1 : -sv_sel1;
      const float Rs0 = MINIMIZE ? bots[0] : -bots[0];
      const bool case_none = selected < 0;
      const bool case_all = selected + 1 >= rsz;
      const float gap = case_none ? Rs0 * 0.5f
                                  : (case_all ? Rs_sel * 1.5f : Rs_sel1 - Rs_sel);
      const float d = de + kp * gap;
      const float dpi =
          (case_none || case_all) ? 0.0f : (Rs_sel + Rs_sel1) * 0.5f;
      d_b[b] = d;
      dpi_b[b] = dpi;
      thr_b[b] = case_none ? -inf : sv_sel;
    }

    // ---- phase B: apply row by row (later rows win x conflicts)
    for (int b = 0; b < Bb; ++b) {
      const int k = order[base + b];
      if (k < 0 || k >= m || !sched[(size_t)k * R + r]) continue;
      const int rsz = rowmeta[5 * (size_t)k + 3];
      const float d = d_b[b];
      const float dpi = dpi_b[b];
      const float thr = thr_b[b];
      const size_t rk = (size_t)k * Kr;
      for (int s = 0; s < rsz; ++s) {
        const int j = row_vars[rk + s];
        const bool chosen = keys[((size_t)b * Kr + s) * R + r] <= thr;
        const float sgn = chosen ? 1.0f : -1.0f;
        const size_t pidx = (rk + s) * R + r;
        const size_t sidx = (size_t)j * R + r;
        const float pr = P[pidx];
        if (UNIT) {
          const float new_p = th * pr + sgn * d;
          P[pidx] = new_p;
          S[sidx] = S[sidx] + ((dpi + new_p) - pr);
          x[sidx] = chosen ? 1 : 0;
        } else {
          const float af = row_factor[rk + s];
          const float new_p =
              th * pr + (sgn * (af < 0.0f ? -1.0f : 1.0f)) * d;
          P[pidx] = new_p;
          S[sidx] = S[sidx] + af * ((dpi + new_p) - pr);
          x[sidx] = (sgn * af > 0.0f) ? 1 : 0;
        }
      }
      pi[(size_t)k * R + r] = pi[(size_t)k * R + r] + dpi;
    }
  }
}

template <bool UNIT, bool MINIMIZE>
void launch_cq(bool has_cq, dim3 grid, dim3 block, cudaStream_t stream,
               float* S, int32_t* x, float* pi, float* P, float* keys,
               const uint8_t* sched, const int32_t* order,
               const int32_t* n_rows, const int32_t* rowmeta,
               const int32_t* row_vars, const float* row_factor,
               const float* cost, const float* cq, const float* kappa,
               const float* amp, const float* delta, const float* theta,
               const int32_t* seed, int m, int Kr, int R, int mp, int Bb,
               int J_bot, int J_top) {
  if (has_cq)
    psweep_kernel<UNIT, MINIMIZE, true><<<grid, block, 0, stream>>>(
        S, x, pi, P, keys, sched, order, n_rows, rowmeta, row_vars,
        row_factor, cost, cq, kappa, amp, delta, theta, seed, m, Kr, R, mp,
        Bb, J_bot, J_top);
  else
    psweep_kernel<UNIT, MINIMIZE, false><<<grid, block, 0, stream>>>(
        S, x, pi, P, keys, sched, order, n_rows, rowmeta, row_vars,
        row_factor, cost, cq, kappa, amp, delta, theta, seed, m, Kr, R, mp,
        Bb, J_bot, J_top);
}

}  // namespace

extern "C" int psweep_launch(
    void* S, void* x, void* pi, void* P, void* keys, const void* sched,
    const void* order, const void* n_rows, const void* rowmeta,
    const void* row_vars, const void* row_factor, const void* cost,
    const void* cq, const void* kappa, const void* amp, const void* delta,
    const void* theta, const void* seed, int m, int Kr, int R, int mp,
    int Bb, int J_bot, int J_top, int unit, int minimize, void* stream) {
  if (Bb < 1 || Bb > MAX_B || J_bot < 1 || J_top < 1 ||
      J_bot + J_top > JMAX)
    return (int)cudaErrorInvalidValue;
  const dim3 block(32);
  const dim3 grid((R + 31) / 32);
  cudaStream_t st = (cudaStream_t)stream;
  const bool has_cq = cq != nullptr;
#define BX_ARGS                                                          \
  has_cq, grid, block, st, (float*)S, (int32_t*)x, (float*)pi, (float*)P, \
      (float*)keys, (const uint8_t*)sched, (const int32_t*)order,         \
      (const int32_t*)n_rows, (const int32_t*)rowmeta,                    \
      (const int32_t*)row_vars, (const float*)row_factor,                 \
      (const float*)cost, (const float*)cq, (const float*)kappa,          \
      (const float*)amp, (const float*)delta, (const float*)theta,        \
      (const int32_t*)seed, m, Kr, R, mp, Bb, J_bot, J_top
  if (unit) {
    if (minimize)
      launch_cq<true, true>(BX_ARGS);
    else
      launch_cq<true, false>(BX_ARGS);
  } else {
    if (minimize)
      launch_cq<false, true>(BX_ARGS);
    else
      launch_cq<false, false>(BX_ARGS);
  }
#undef BX_ARGS
  return (int)cudaGetLastError();
}
