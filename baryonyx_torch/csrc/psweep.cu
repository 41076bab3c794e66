// One block-Jacobi Wedelin sweep over the scheduled rows, for every
// replica: the fused sweep of the solver's optimize loop, written for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/psweep.py:_make_kernel
// (launched by _psweep_call). That kernel walks the row order on one TPU
// core with the replicas on the 128 vector lanes, a whole row block's
// tiles in VMEM, and the grid steps in order. It computes, and this file
// computes bit for bit:
//   phase A, per row of a block, against S as it stood at block entry:
//     reduced cost r = c_j (+CQ_j) - (S_j + a(theta-1)P), negated where
//     a < 0, plus amp*c_j; tie noise from a splitmix counter hash of
//     (seed pair, row k, slot s, replica); order statistics (count of keys
//     <= 0, the J_bot smallest and J_top largest keys, the largest
//     nonpositive and the smallest positive key);
//   selection: selected, the threshold key, d and dpi;
//   phase B, row by row: P <- theta*P +- d, S updated incrementally,
//     masked write of x (the later row wins), then pi += dpi.
// The order lists every row at most once (it is a permutation of the rows,
// padded with the sentinel m).
//
// What is parallel: replicas throughout; within a row block, phase A per
// (row, slot) and the order statistics in any reduction order (they are
// counts, minima and maxima of exact values); in phase B the slots of one
// row (a row's variables are distinct). What is not: the rows of a block
// in phase B (S[j] += is a float add whose order over rows must hold, and
// the later row wins x), and the row blocks of a sweep.
//
// What bounds it on this card: not its bytes and not its operations but
// the serial chain of row blocks (up to mp / Bb of them per sweep, each
// strictly after the one before). A dependent load from L2 or device
// memory costs 300 to 800 cycles here, a barrier with its skew 100 or
// more, so what a row block leaves on that chain decides the sweep's time,
// whatever the number of threads; the byte bound assumes the chain away.
//
// Design ("group" variant). One CUDA block owns G replicas (G = 8: every
// access to a [*, R] array is one whole 32-byte sector) and walks the
// whole order for them. It has Bb x Wr warps: warp (b, wr) works on row b
// of the current row block; its 32 lanes are 32/G slot lanes x G replicas,
// replica fastest, so a row has Ls = Wr * 32/G slot lanes and lane ls takes
// slots ls, ls + Ls, ... below the row's length. Each lane keeps its own
// order statistics in registers (arrays of JB = 2, 4 or 8 entries, the
// smallest size that holds J_bot and J_top); the lanes of a (row, replica)
// merge them by xor shuffles inside the warp, and the Wr warps of a row
// through a small shared-memory stage; then every lane of the row holds
// the merged statistics and computes the selection itself. Every skip is a
// decision the whole CUDA block takes alike: a row block none of the G
// replicas schedules costs one barrier, a row none schedules costs none,
// and a replica that does not schedule a row idles its lanes. Where it
// fits, the group's S [n][G] stays in shared memory for the whole sweep,
// which takes the S gathers and the S read-modify-writes off the chain.
//   psweep_kernel_group_regs, for rows of up to NQ slots per lane: a lane
//   keeps its slots' keys, P values and variable indices in registers from
//   phase A to phase B, and everything a row block reads that an earlier
//   row block cannot change is loaded ahead of the chain, in three stages:
//   the row index three blocks ahead; sched and the row's bounds two ahead;
//   its variable indices, P and pi one ahead. After the selection every
//   lane writes its new P at once; only S[j] += and the x write go row by
//   row. On the chain stay the S reads, the arithmetic, the merge, one
//   barrier, the selection, and per scheduled row the S adds and a barrier.
//   psweep_kernel_group_tile, for longer rows: the keys wait in a
//   shared-memory tile [Bb][Kr][G]; the loads of UB slots go out together;
//   thr, d and dpi go through shared memory, and in phase B all warps of
//   the CUDA block share each row's slots.
// Neither uses the device-memory key scratch; the regs kernel reads P once,
// the tile kernel's second read of P hits L2 (a second tile for P was
// measured and gained nothing).
//
// The first design stays in the file as the "replica_thread" variant
// (psweep_kernel_replica_thread): one thread per replica, keys in a
// device-memory scratch. The launch plan (ops/psweep.py:launch_plan) picks
// it for shapes whose key tile fits shared memory at no group size.
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
constexpr int NQ = 8;      // slots per lane kept in registers (ops/psweep.py)
constexpr int UB = 4;      // tile variant: slots whose loads go out together
constexpr int NSTAT = 3 + JMAX;  // floats of one partial in the merge stage
constexpr unsigned FULL = 0xFFFFFFFFu;

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
template <int JB>
__device__ __forceinline__ float pick(const float (&regs)[JB], int J, int idx) {
  float acc = regs[0];
#pragma unroll
  for (int t = 0; t < JB; ++t)
    if (t == J - 1) acc = regs[t];
#pragma unroll
  for (int t = 0; t < JB; ++t)
    if (t < J - 1 && idx == t) acc = regs[t];
  return acc;
}

// Running ascending insert: regs stays the JB smallest keys seen. The
// first J entries of a longer network equal those of a J-entry one.
template <int JB>
__device__ __forceinline__ void insert_min(float (&regs)[JB], float v) {
#pragma unroll
  for (int t = JB - 1; t > 0; --t)
    regs[t] = v < regs[t - 1] ? regs[t - 1] : fminf(regs[t], v);
  regs[0] = fminf(regs[0], v);
}

template <int JB>
__device__ __forceinline__ void insert_max(float (&regs)[JB], float v) {
#pragma unroll
  for (int t = JB - 1; t > 0; --t)
    regs[t] = v > regs[t - 1] ? regs[t - 1] : fmaxf(regs[t], v);
  regs[0] = fmaxf(regs[0], v);
}

// The order statistics of the keys seen so far, JB >= max(J_bot, J_top).
template <int JB>
struct Stats {
  int cnt;            // keys <= 0
  float mx_np, mn_p;  // largest nonpositive, smallest positive key
  float bots[JB], tops[JB];

  __device__ __forceinline__ void reset() {
    cnt = 0;
    mx_np = -INFINITY;
    mn_p = INFINITY;
#pragma unroll
    for (int t = 0; t < JB; ++t) {
      bots[t] = INFINITY;
      tops[t] = -INFINITY;
    }
  }

  __device__ __forceinline__ void add(float sv) {
    cnt += sv <= 0.0f ? 1 : 0;
    insert_min<JB>(bots, sv);
    insert_max<JB>(tops, sv);
    mx_np = fmaxf(mx_np, sv <= 0.0f ? sv : -INFINITY);
    mn_p = fminf(mn_p, sv > 0.0f ? sv : INFINITY);
  }

  // the statistics of the lane `off` away join this lane's (and the other
  // way round: after the rounds off = G, 2G, .. every lane of the warp
  // holds the statistics of all lanes of its replica)
  __device__ __forceinline__ void merge_lane(int off, int J_bot, int J_top) {
    float ob[JB], ot[JB];
#pragma unroll
    for (int t = 0; t < JB; ++t) {
      ob[t] = __shfl_xor_sync(FULL, bots[t], off);
      ot[t] = __shfl_xor_sync(FULL, tops[t], off);
    }
    cnt += __shfl_xor_sync(FULL, cnt, off);
    mx_np = fmaxf(mx_np, __shfl_xor_sync(FULL, mx_np, off));
    mn_p = fminf(mn_p, __shfl_xor_sync(FULL, mn_p, off));
#pragma unroll
    for (int t = 0; t < JB; ++t) {
      if (t < J_bot) insert_min<JB>(bots, ob[t]);
      if (t < J_top) insert_max<JB>(tops, ot[t]);
    }
  }

  // one warp's statistics to and from the merge stage, pp[f * G]
  __device__ __forceinline__ void put(float* pp, int G, int J_bot,
                                      int J_top) const {
    pp[0] = __int_as_float(cnt);
    pp[G] = mx_np;
    pp[2 * G] = mn_p;
#pragma unroll
    for (int t = 0; t < JB; ++t) {
      if (t < J_bot) pp[(3 + t) * G] = bots[t];
      if (t < J_top) pp[(3 + J_bot + t) * G] = tops[t];
    }
  }

  __device__ __forceinline__ void take(const float* pp, int G, int J_bot,
                                       int J_top) {
    cnt += __float_as_int(pp[0]);
    mx_np = fmaxf(mx_np, pp[G]);
    mn_p = fminf(mn_p, pp[2 * G]);
#pragma unroll
    for (int t = 0; t < JB; ++t) {
      if (t < J_bot) insert_min<JB>(bots, pp[(3 + t) * G]);
      if (t < J_top) insert_max<JB>(tops, pp[(3 + J_bot + t) * G]);
    }
  }
};

// One slot's noised key (phase A's arithmetic, shared by all variants).
template <bool UNIT>
__device__ __forceinline__ float noised_key(float cj, float Sj, float pr,
                                            float af, float th, float am,
                                            float de, bool minimize,
                                            uint32_t seed_u, uint32_t r,
                                            uint32_t k, uint32_t s) {
  float rr;
  if (UNIT) {
    rr = cj - (Sj + (th - 1.0f) * pr);
  } else {
    rr = cj - (Sj + af * (th - 1.0f) * pr);
    if (af < 0.0f) rr = -rr;
  }
  rr = rr + am * cj;
  float sv = minimize ? rr : -rr;
  const float u = draw_u(seed_u, r, k, s);
  return sv * (1.0f + (u - 0.5f) * 2e-6f) + (u - 0.5f) * (de * 1e-3f);
}

// The sort-free selection of ops/psweep.py from a row's order statistics:
// the threshold key, d and dpi.
template <int JB>
__device__ __forceinline__ void select_row(const Stats<JB>& st, int bmin,
                                           int bmax, int csz, int rsz,
                                           int iseq, int J_bot, int J_top,
                                           bool minimize, float de, float kp,
                                           float& thr, float& d, float& dpi) {
  const int lo = bmin + csz;
  const int hi = min(bmax + csz, rsz);
  const int sel_eq = min(bmin + csz, rsz) - 1;
  const int sel_ineq = min(max(st.cnt, lo), hi) - 1;  // hi wins if lo > hi
  const int selected = iseq ? sel_eq : sel_ineq;
  const bool unclipped = !iseq && (selected + 1 == st.cnt);
  const bool bot_ok = selected >= 0 && selected < J_bot;
  const float sv_sel =
      unclipped ? st.mx_np
                : (bot_ok ? pick<JB>(st.bots, J_bot, selected)
                          : pick<JB>(st.tops, J_top, rsz - 1 - selected));
  const float sv_sel1 =
      unclipped ? st.mn_p
                : (selected + 1 < J_bot
                       ? pick<JB>(st.bots, J_bot, selected + 1)
                       : pick<JB>(st.tops, J_top, rsz - 2 - selected));
  const float Rs_sel = minimize ? sv_sel : -sv_sel;
  const float Rs_sel1 = minimize ? sv_sel1 : -sv_sel1;
  const float Rs0 = minimize ? st.bots[0] : -st.bots[0];
  const bool case_none = selected < 0;
  const bool case_all = selected + 1 >= rsz;
  const float gap = case_none ? Rs0 * 0.5f
                              : (case_all ? Rs_sel * 1.5f : Rs_sel1 - Rs_sel);
  d = de + kp * gap;
  dpi = (case_none || case_all) ? 0.0f : (Rs_sel + Rs_sel1) * 0.5f;
  thr = case_none ? -INFINITY : sv_sel;
}

// Phase B for one slot, the part no other row sees: writes the new P, gives
// the x bit, returns what the slot adds to S[j].
template <bool UNIT>
__device__ __forceinline__ float slot_update(float key, float pr, float af,
                                             float thr, float d, float dpi,
                                             float th, float* Pp,
                                             int32_t& bit) {
  const bool chosen = key <= thr;
  const float sgn = chosen ? 1.0f : -1.0f;
  if (UNIT) {
    const float new_p = th * pr + sgn * d;
    *Pp = new_p;
    bit = chosen ? 1 : 0;
    return (dpi + new_p) - pr;
  }
  const float new_p = th * pr + (sgn * (af < 0.0f ? -1.0f : 1.0f)) * d;
  *Pp = new_p;
  bit = (sgn * af > 0.0f) ? 1 : 0;
  return af * ((dpi + new_p) - pr);
}

// Phase B for one slot: the new P, S[j] (Sj as read before) and the x bit.
template <bool UNIT>
__device__ __forceinline__ void apply_slot(float key, float pr, float af,
                                           float Sj, float thr, float d,
                                           float dpi, float th, float* Pp,
                                           float* Sp, int32_t* xp) {
  int32_t bit;
  const float upd = slot_update<UNIT>(key, pr, af, thr, d, dpi, th, Pp, bit);
  *Sp = Sj + upd;
  *xp = bit;
}

// Everything a sweep reads or writes, and how it is launched.
struct Args {
  float* S;                 // [n, R]
  int32_t* x;               // [n, R]
  float* pi;                // [m, R]
  float* P;                 // [m, Kr, R]
  float* keys;              // [Bb, Kr, R] scratch (replica_thread only)
  const uint8_t* __restrict__ sched;     // [m, R] bool
  const int32_t* __restrict__ order;     // [mp] rows, sentinel m
  const int32_t* __restrict__ n_rows;    // [1]
  const int32_t* __restrict__ rowmeta;   // [m, 5]: bmin, bmax, csz, rsz, iseq
  const int32_t* __restrict__ row_vars;  // [m, Kr]
  const float* __restrict__ row_factor;  // [m, Kr]
  const float* __restrict__ cost;        // [n]
  const float* __restrict__ cq;          // [n, R] or null
  const float* __restrict__ kappa;       // [R]
  const float* __restrict__ amp;         // [R]
  const float* __restrict__ delta;       // [R]
  const float* __restrict__ theta;       // [R]
  const int32_t* __restrict__ seed;      // [2]
  int m, n, Kr, R, mp, Bb, J_bot, J_top, minimize;
  int G, Wr, s_res, smem_bytes;
  cudaStream_t stream;
};

// A thread's place in the "group" variants, and its replica's parameters.
struct Lane {
  int tid, lane, warp, g, b_own, wr, Ls, ls, r0, r;
  float th, de, am, kp;
  uint32_t seed_u;

  __device__ __forceinline__ Lane(const Args& a) {
    tid = threadIdx.x;
    lane = tid & 31;
    warp = tid >> 5;
    g = lane & (a.G - 1);
    b_own = warp / a.Wr;
    wr = warp - b_own * a.Wr;
    Ls = a.Wr * (32 / a.G);
    ls = wr * (32 / a.G) + lane / a.G;
    r0 = blockIdx.x * a.G;
    r = r0 + g;
    th = a.theta[r];
    de = a.delta[r];
    am = a.amp[r];
    const float kap = a.kappa[r];
    kp = kap / (1.0f - kap);
    seed_u = (uint32_t)a.seed[0] * 0x9E3779B9u + (uint32_t)a.seed[1];
  }
};

// n_rows is read on the device, so the caller never syncs
__device__ __forceinline__ int row_blocks(const Args& a) {
  const int nb = (*a.n_rows + a.Bb - 1) / a.Bb;
  return min(max(nb, 0), a.mp / a.Bb);
}

// The row at position b of row block blk, -1 for padding and past the end.
__device__ __forceinline__ int row_at(const Args& a, int blk, int n_blocks,
                                      int b) {
  if (blk >= n_blocks) return -1;
  const int k = a.order[blk * a.Bb + b];
  return (k >= 0 && k < a.m) ? k : -1;  // the sentinel is no index
}

__device__ __forceinline__ void load_S(const Args& a, float* Ssh, int r0) {
  for (int i = threadIdx.x; i < a.n * a.G; i += blockDim.x)
    Ssh[i] = a.S[(size_t)(i / a.G) * a.R + r0 + (i & (a.G - 1))];
  __syncthreads();
}

__device__ __forceinline__ void store_S(const Args& a, const float* Ssh,
                                        int r0) {
  __syncthreads();
  for (int i = threadIdx.x; i < a.n * a.G; i += blockDim.x)
    a.S[(size_t)(i / a.G) * a.R + r0 + (i & (a.G - 1))] = Ssh[i];
}

// ---------------------------------------------------------------------------
// "group" variant, keys in registers
// ---------------------------------------------------------------------------

template <bool UNIT, bool HAS_CQ, int JB>
__global__ void __launch_bounds__(256, 2) psweep_kernel_group_regs(
    const Args a) {
  extern __shared__ float smem[];
  __shared__ int sh_on[MAX_B];  // does a replica of the group schedule row b

  const Lane t(a);
  const bool minimize = a.minimize != 0;
  const int G = a.G, Wr = a.Wr, Bb = a.Bb, Kr = a.Kr;
  const int J_bot = a.J_bot, J_top = a.J_top;
  const size_t RR = (size_t)a.R;
  const int n_blocks = row_blocks(a);

  // dynamic shared memory: the merge stage, then S
  float* part = smem;                                      // [Bb][Wr][NSTAT][G]
  float* Ssh = part + (Wr > 1 ? Bb * Wr * NSTAT * G : 0);  // [n][G]
  // S as this thread addresses it: Sp[j * Ss] is S[j, r]
  float* Sp = a.s_res ? Ssh + t.g : a.S + t.r;
  const size_t Ss = a.s_res ? (size_t)G : RR;

  // The loads ahead of the chain. Stage 1, three blocks ahead: the row.
  // Stage 2, two blocks ahead, from the row: who schedules it and its
  // bounds. Stage 3, one block ahead, from those: its variables, P and pi.
  // A row block changes none of these for a later one. (The costs are a
  // small table that stays in L1 and are read when needed.)
  int k3;                                          // row of block blk + 3
  int k2, me2 = 0, meta2[5] = {0, 0, 0, 0, 0};     // of blk + 2
  int k1, me1 = 0, meta1[5] = {0, 0, 0, 0, 0};     // of blk + 1
  int k0, me0 = 0, meta0[5] = {0, 0, 0, 0, 0};     // of blk ...
  int j0[NQ];                                      // ... loaded by stage 3
  float p0[NQ], a0[NQ], pi0 = 0.0f;
  int jn[NQ];                                      // stage 3 of blk + 1
  float pn[NQ], an[NQ], pin = 0.0f;

  auto stage2 = [&](int k, int& me, int (&meta)[5]) {
    me = 0;
    if (k >= 0) {
      me = a.sched[(size_t)k * RR + t.r];
#pragma unroll
      for (int i = 0; i < 5; ++i) meta[i] = a.rowmeta[5 * (size_t)k + i];
    }
  };
  auto stage3 = [&](int k, int me, const int (&meta)[5]) {
    if (k >= 0 && me) {
      const int nq = (meta[3] + t.Ls - 1) / t.Ls;  // the same for the warp
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q >= nq) break;
        const int s = t.ls + q * t.Ls;
        if (s < meta[3]) {
          jn[q] = a.row_vars[(size_t)k * Kr + s];
          pn[q] = a.P[((size_t)k * Kr + s) * RR + t.r];
          if (!UNIT) an[q] = a.row_factor[(size_t)k * Kr + s];
        }
      }
      if (t.ls == 0) pin = a.pi[(size_t)k * RR + t.r];
    }
  };

#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    jn[q] = 0;
    pn[q] = 0.0f;
    an[q] = 1.0f;
  }
  k0 = row_at(a, 0, n_blocks, t.b_own);
  k1 = row_at(a, 1, n_blocks, t.b_own);
  k2 = row_at(a, 2, n_blocks, t.b_own);
  k3 = row_at(a, 3, n_blocks, t.b_own);
  stage2(k0, me0, meta0);
  stage2(k1, me1, meta1);
  stage2(k2, me2, meta2);
  stage3(k0, me0, meta0);

  if (a.s_res) load_S(a, Ssh, t.r0);

  for (int blk = 0; blk < n_blocks; ++blk) {
    // ---- this block's loads have arrived; the later blocks' go out
    if (blk > 0) {
      k0 = k1;
      me0 = me1;
#pragma unroll
      for (int i = 0; i < 5; ++i) meta0[i] = meta1[i];
      k1 = k2;
      me1 = me2;
#pragma unroll
      for (int i = 0; i < 5; ++i) meta1[i] = meta2[i];
      k2 = k3;
      stage2(k2, me2, meta2);
      k3 = row_at(a, blk + 3, n_blocks, t.b_own);
    }
    pi0 = pin;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      j0[q] = jn[q];
      p0[q] = pn[q];
      a0[q] = an[q];
    }
    stage3(k1, me1, meta1);

    const bool me_on = k0 >= 0 && me0 != 0;
    const bool row_on = __any_sync(FULL, me_on);  // warp-uniform
    const int rsz = meta0[3];
    const size_t rk = (size_t)(k0 >= 0 ? k0 : 0) * Kr;

    // ---- phase A: this lane's slots against block-entry S
    const int nq = (rsz + t.Ls - 1) / t.Ls;  // the same for the warp
    Stats<JB> st;
    st.reset();
    float key0[NQ];  // the slot's key; after the selection its S update
    if (me_on) {
      float S_q[NQ], c_q[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q >= nq) break;
        S_q[q] = c_q[q] = 0.0f;
        if (t.ls + q * t.Ls < rsz) {
          S_q[q] = Sp[(size_t)j0[q] * Ss];
          c_q[q] = a.cost[j0[q]];
          if (HAS_CQ) c_q[q] = c_q[q] + a.cq[(size_t)j0[q] * RR + t.r];
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q >= nq) break;
        const int s = t.ls + q * t.Ls;
        if (s < rsz) {
          key0[q] = noised_key<UNIT>(c_q[q], S_q[q], p0[q], a0[q], t.th, t.am,
                                     t.de, minimize, t.seed_u, (uint32_t)t.r,
                                     (uint32_t)k0, (uint32_t)s);
          st.add(key0[q]);
        }
      }
    }

    // ---- merge the lanes of each (row, replica): in the warp, then across
    // the Wr warps of the row
    if (row_on) {
      for (int off = G; off < 32; off <<= 1) st.merge_lane(off, J_bot, J_top);
      if (Wr > 1 && t.lane < G)
        st.put(part + ((size_t)(t.b_own * Wr + t.wr) * NSTAT) * G + t.g, G,
               J_bot, J_top);
    }
    if (t.wr == 0 && t.lane == 0) sh_on[t.b_own] = row_on;
    // phase A has read S everywhere before phase B writes it anywhere; a row
    // block nobody of the group schedules: all threads skip it alike
    if (!__syncthreads_or(row_on)) continue;
    uint32_t rows_on = 0;
    for (int b = 0; b < Bb; ++b) rows_on |= sh_on[b] ? 1u << b : 0u;
    if (Wr > 1 && row_on) {
      st.reset();
      for (int w2 = 0; w2 < Wr; ++w2)
        st.take(part + ((size_t)(t.b_own * Wr + w2) * NSTAT) * G + t.g, G,
                J_bot, J_top);
    }

    // ---- selection, by every lane for its own (row, replica); then the part
    // of phase B that no other row sees: the new P, and what the slot will
    // add to S[j] and write to x[j]
    uint32_t bits = 0;
    if (me_on) {
      float thr, d, dpi;
      select_row<JB>(st, meta0[0], meta0[1], meta0[2], rsz, meta0[4], J_bot,
                     J_top, minimize, t.de, t.kp, thr, d, dpi);
      if (t.ls == 0) a.pi[(size_t)k0 * RR + t.r] = pi0 + dpi;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (q >= nq) break;
        const int s = t.ls + q * t.Ls;
        if (s < rsz) {
          int32_t bit;
          key0[q] = slot_update<UNIT>(key0[q], p0[q], a0[q], thr, d, dpi, t.th,
                                      a.P + (rk + s) * RR + t.r, bit);
          bits |= (uint32_t)bit << q;
        }
      }
    }

    // ---- the ordered part of phase B, row by row: S[j] += in row order, and
    // the later row wins x. The slots of a row touch distinct variables.
    for (int b = 0; b < Bb; ++b) {
      if (!((rows_on >> b) & 1u)) continue;  // the same for every thread
      if (b == t.b_own && me_on) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (q >= nq) break;
          if (t.ls + q * t.Ls < rsz) {
            float* Sj = Sp + (size_t)j0[q] * Ss;
            *Sj = *Sj + key0[q];
            a.x[(size_t)j0[q] * RR + t.r] = (bits >> q) & 1u;
          }
        }
      }
      __syncthreads();
    }
  }

  if (a.s_res) store_S(a, Ssh, t.r0);
}

// ---------------------------------------------------------------------------
// "group" variant, keys in the shared-memory tile
// ---------------------------------------------------------------------------

template <bool UNIT, bool HAS_CQ, int JB>
__global__ void __launch_bounds__(512) psweep_kernel_group_tile(const Args a) {
  extern __shared__ float smem[];
  __shared__ int sh_k[MAX_B];         // the block's rows, -1 where nobody is on
  __shared__ int sh_rsz[MAX_B];
  __shared__ uint32_t sh_sch[MAX_B];  // bit g: replica g schedules the row
  __shared__ float sh_thr[MAX_B][32], sh_d[MAX_B][32], sh_dpi[MAX_B][32];

  const Lane t(a);
  const bool minimize = a.minimize != 0;
  const int G = a.G, Wr = a.Wr, Bb = a.Bb, Kr = a.Kr;
  const int J_bot = a.J_bot, J_top = a.J_top;
  const size_t RR = (size_t)a.R;
  const int n_blocks = row_blocks(a);

  // dynamic shared memory: the merge stage, the key tile, S
  float* part = smem;  // [Bb][Wr][NSTAT][G]
  float* tile = part + (Wr > 1 ? Bb * Wr * NSTAT * G : 0);  // [Bb][Kr][G]
  float* Ssh = tile + Bb * Kr * G;                          // [n][G]
  float* Sp = a.s_res ? Ssh + t.g : a.S + t.r;
  const size_t Ss = a.s_res ? (size_t)G : RR;

  // phase B shares a row's slots among all warps of the CUDA block
  const int LB = Bb * t.Ls;                        // slot lanes in phase B
  const int lb = t.warp * (32 / G) + t.lane / G;   // this thread's

  // the row two blocks ahead; sched and the bounds one block ahead
  // (and pi for the lane that will update it)
  int k2, k1, me1 = 0, meta1[5] = {0, 0, 0, 0, 0};
  float pi1 = 0.0f;
  auto stage2 = [&](int k, int& me, int (&meta)[5], float& piv) {
    me = 0;
    if (k >= 0) {
      me = a.sched[(size_t)k * RR + t.r];
#pragma unroll
      for (int i = 0; i < 5; ++i) meta[i] = a.rowmeta[5 * (size_t)k + i];
      if (t.ls == 0) piv = a.pi[(size_t)k * RR + t.r];
    }
  };
  k1 = row_at(a, 0, n_blocks, t.b_own);
  k2 = row_at(a, 1, n_blocks, t.b_own);
  stage2(k1, me1, meta1, pi1);

  if (a.s_res) load_S(a, Ssh, t.r0);

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int k0 = k1;
    const bool me_on = k0 >= 0 && me1 != 0;
    const float pi0 = pi1;
    int meta0[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) meta0[i] = meta1[i];
    k1 = k2;
    stage2(k1, me1, meta1, pi1);
    k2 = row_at(a, blk + 2, n_blocks, t.b_own);

    const uint32_t bal = __ballot_sync(FULL, me_on);
    const bool row_on = bal != 0;  // warp-uniform
    const int rsz = meta0[3];
    const size_t rk = (size_t)(k0 >= 0 ? k0 : 0) * Kr;

    // ---- phase A: this lane's slots against block-entry S; the loads of
    // UB slots go out together
    Stats<JB> st;
    st.reset();
    if (me_on) {
      for (int s0 = t.ls; s0 < rsz; s0 += UB * t.Ls) {
        int j_u[UB];
        float c_u[UB], S_u[UB], p_u[UB];
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          const int s = s0 + u * t.Ls;
          j_u[u] = s < rsz ? a.row_vars[rk + s] : 0;
        }
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          const int s = s0 + u * t.Ls;
          c_u[u] = S_u[u] = p_u[u] = 0.0f;
          if (s < rsz) {
            c_u[u] = a.cost[j_u[u]];
            if (HAS_CQ) c_u[u] = c_u[u] + a.cq[(size_t)j_u[u] * RR + t.r];
            S_u[u] = Sp[(size_t)j_u[u] * Ss];
            p_u[u] = a.P[(rk + s) * RR + t.r];
          }
        }
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          const int s = s0 + u * t.Ls;
          if (s < rsz) {
            const float af = UNIT ? 1.0f : a.row_factor[rk + s];
            const float sv = noised_key<UNIT>(
                c_u[u], S_u[u], p_u[u], af, t.th, t.am, t.de, minimize,
                t.seed_u, (uint32_t)t.r, (uint32_t)k0, (uint32_t)s);
            tile[(t.b_own * Kr + s) * G + t.g] = sv;
            st.add(sv);
          }
        }
      }
    }

    // ---- merge the lanes of each (row, replica): in the warp, then across
    // the Wr warps of the row
    if (row_on) {
      for (int off = G; off < 32; off <<= 1) st.merge_lane(off, J_bot, J_top);
      if (Wr > 1 && t.lane < G)
        st.put(part + ((size_t)(t.b_own * Wr + t.wr) * NSTAT) * G + t.g, G,
               J_bot, J_top);
    }
    if (t.wr == 0 && t.lane == 0) {
      sh_k[t.b_own] = row_on ? k0 : -1;
      sh_rsz[t.b_own] = rsz;
      sh_sch[t.b_own] = bal & (G == 32 ? FULL : ((1u << G) - 1u));
    }
    // phase A has read S everywhere before phase B writes it anywhere; a row
    // block nobody of the group schedules: all threads skip it alike
    if (!__syncthreads_or(row_on)) continue;
    if (Wr > 1 && row_on) {
      st.reset();
      for (int w2 = 0; w2 < Wr; ++w2)
        st.take(part + ((size_t)(t.b_own * Wr + w2) * NSTAT) * G + t.g, G,
                J_bot, J_top);
    }

    // ---- selection, by the first lane of each (row, replica)
    if (me_on && t.ls == 0) {
      float thr, d, dpi;
      select_row<JB>(st, meta0[0], meta0[1], meta0[2], rsz, meta0[4], J_bot,
                     J_top, minimize, t.de, t.kp, thr, d, dpi);
      sh_thr[t.b_own][t.g] = thr;
      sh_d[t.b_own][t.g] = d;
      sh_dpi[t.b_own][t.g] = dpi;
      a.pi[(size_t)k0 * RR + t.r] = pi0 + dpi;
    }
    __syncthreads();
    uint32_t rows_on = 0;  // read before any row's barrier lets a thread run on
    for (int b = 0; b < Bb; ++b) rows_on |= sh_k[b] >= 0 ? 1u << b : 0u;

    // ---- phase B: row by row (later rows win x conflicts), all warps on
    // each row; its slots touch distinct variables and go in parallel, so
    // all of a lane's S reads may precede its S writes
    for (int b = 0; b < Bb; ++b) {
      if (!((rows_on >> b) & 1u)) continue;  // the same for every thread
      const int kb = sh_k[b];
      if ((sh_sch[b] >> t.g) & 1u) {
        const int rszb = sh_rsz[b];
        const size_t rkb = (size_t)kb * Kr;
        const float thr = sh_thr[b][t.g], d = sh_d[b][t.g];
        const float dpi = sh_dpi[b][t.g];
        for (int s0 = lb; s0 < rszb; s0 += UB * LB) {
          int j_u[UB];
          float S_u[UB], p_u[UB];
#pragma unroll
          for (int u = 0; u < UB; ++u) {
            const int s = s0 + u * LB;
            j_u[u] = s < rszb ? a.row_vars[rkb + s] : 0;
          }
#pragma unroll
          for (int u = 0; u < UB; ++u) {
            const int s = s0 + u * LB;
            S_u[u] = p_u[u] = 0.0f;
            if (s < rszb) {
              S_u[u] = Sp[(size_t)j_u[u] * Ss];
              p_u[u] = a.P[(rkb + s) * RR + t.r];
            }
          }
#pragma unroll
          for (int u = 0; u < UB; ++u) {
            const int s = s0 + u * LB;
            if (s < rszb) {
              const float af = UNIT ? 1.0f : a.row_factor[rkb + s];
              apply_slot<UNIT>(tile[(b * Kr + s) * G + t.g], p_u[u], af, S_u[u],
                               thr, d, dpi, t.th, a.P + (rkb + s) * RR + t.r,
                               Sp + (size_t)j_u[u] * Ss,
                               a.x + (size_t)j_u[u] * RR + t.r);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  if (a.s_res) store_S(a, Ssh, t.r0);
}

// ---------------------------------------------------------------------------
// "replica_thread" variant: one thread per replica, 32 replicas per CUDA
// block, keys in a [Bb, Kr, R] scratch in device memory
// ---------------------------------------------------------------------------

template <bool UNIT, bool HAS_CQ>
__global__ void __launch_bounds__(32) psweep_kernel_replica_thread(
    const Args a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.R) return;
  const bool minimize = a.minimize != 0;
  const int Kr = a.Kr, Bb = a.Bb;
  const size_t RR = (size_t)a.R;
  const float th = a.theta[r];
  const float de = a.delta[r];
  const float am = a.amp[r];
  const float kap = a.kappa[r];
  const float kp = kap / (1.0f - kap);
  const uint32_t seed_u =
      (uint32_t)a.seed[0] * 0x9E3779B9u + (uint32_t)a.seed[1];
  const int n_blocks = row_blocks(a);

  float thr_b[MAX_B], d_b[MAX_B], dpi_b[MAX_B];

  for (int blk = 0; blk < n_blocks; ++blk) {
    const int base = blk * Bb;

    // ---- phase A: decisions against block-entry S
    for (int b = 0; b < Bb; ++b) {
      const int k = a.order[base + b];
      if (k < 0 || k >= a.m) continue;
      // an unscheduled (row, replica) pair changes nothing: dpi is 0, P
      // keeps its value, x is not written; skip both phases for it
      if (!a.sched[(size_t)k * RR + r]) continue;
      const int32_t* meta = a.rowmeta + 5 * (size_t)k;
      const int rsz = meta[3];
      const size_t rk = (size_t)k * Kr;
      Stats<JMAX> st;
      st.reset();
      for (int s = 0; s < rsz; ++s) {
        const int j = a.row_vars[rk + s];
        float cj = a.cost[j];
        if (HAS_CQ) cj = cj + a.cq[(size_t)j * RR + r];
        const float af = UNIT ? 1.0f : a.row_factor[rk + s];
        const float sv = noised_key<UNIT>(
            cj, a.S[(size_t)j * RR + r], a.P[(rk + s) * RR + r], af, th, am, de,
            minimize, seed_u, (uint32_t)r, (uint32_t)k, (uint32_t)s);
        a.keys[((size_t)b * Kr + s) * RR + r] = sv;
        st.add(sv);
      }
      select_row<JMAX>(st, meta[0], meta[1], meta[2], rsz, meta[4], a.J_bot,
                       a.J_top, minimize, de, kp, thr_b[b], d_b[b], dpi_b[b]);
    }

    // ---- phase B: apply row by row (later rows win x conflicts)
    for (int b = 0; b < Bb; ++b) {
      const int k = a.order[base + b];
      if (k < 0 || k >= a.m || !a.sched[(size_t)k * RR + r]) continue;
      const int rsz = a.rowmeta[5 * (size_t)k + 3];
      const size_t rk = (size_t)k * Kr;
      for (int s = 0; s < rsz; ++s) {
        const int j = a.row_vars[rk + s];
        const size_t pidx = (rk + s) * RR + r;
        const size_t sidx = (size_t)j * RR + r;
        const float af = UNIT ? 1.0f : a.row_factor[rk + s];
        apply_slot<UNIT>(a.keys[((size_t)b * Kr + s) * RR + r], a.P[pidx], af,
                         a.S[sidx], thr_b[b], d_b[b], dpi_b[b], th, a.P + pidx,
                         a.S + sidx, a.x + sidx);
      }
      a.pi[(size_t)k * RR + r] = a.pi[(size_t)k * RR + r] + dpi_b[b];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, int* allowed, const Args& a, int grid,
                   int threads) {
  // dynamic shared memory above 48 KB has to be allowed per kernel
  if (a.smem_bytes > *allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (e != cudaSuccess) return e;
    *allowed = a.smem_bytes;
  }
  kernel<<<grid, threads, a.smem_bytes, a.stream>>>(a);
  return cudaGetLastError();
}

template <bool UNIT, bool HAS_CQ, int JB>
cudaError_t launch_group(const Args& a, int key_regs) {
  // without leave a kernel's static and dynamic shared memory stay under
  // 48 KB together; the static part is under 8 KB
  static int allowed_regs = 40 * 1024, allowed_tile = 40 * 1024;
  const int grid = a.R / a.G, threads = a.Bb * a.Wr * 32;
  if (key_regs)
    return launch(psweep_kernel_group_regs<UNIT, HAS_CQ, JB>, &allowed_regs, a,
                  grid, threads);
  return launch(psweep_kernel_group_tile<UNIT, HAS_CQ, JB>, &allowed_tile, a,
                grid, threads);
}

template <bool UNIT, bool HAS_CQ>
cudaError_t launch_variant(const Args& a, int variant, int key_regs) {
  if (variant == 0) {
    psweep_kernel_replica_thread<UNIT, HAS_CQ>
        <<<(a.R + 31) / 32, 32, 0, a.stream>>>(a);
    return cudaGetLastError();
  }
  const int J = max(a.J_bot, a.J_top);
  if (J <= 2) return launch_group<UNIT, HAS_CQ, 2>(a, key_regs);
  if (J <= 4) return launch_group<UNIT, HAS_CQ, 4>(a, key_regs);
  return launch_group<UNIT, HAS_CQ, JMAX>(a, key_regs);
}

}  // namespace

// variant 0: replica_thread (keys: the [Bb, Kr, R] scratch); variant 1:
// group, with G replicas per CUDA block, Wr warps per row, the keys in
// registers (key_regs) or in the shared-memory tile, S resident in shared
// memory (s_res), and smem_bytes of dynamic shared memory, which must be
// what this layout needs.
extern "C" int psweep_launch(
    void* S, void* x, void* pi, void* P, void* keys, const void* sched,
    const void* order, const void* n_rows, const void* rowmeta,
    const void* row_vars, const void* row_factor, const void* cost,
    const void* cq, const void* kappa, const void* amp, const void* delta,
    const void* theta, const void* seed, int m, int n, int Kr, int R, int mp,
    int Bb, int J_bot, int J_top, int unit, int minimize, int variant, int G,
    int Wr, int key_regs, int s_res, int smem_bytes, void* stream) {
  if (Bb < 1 || Bb > MAX_B || J_bot < 1 || J_top < 1 ||
      J_bot + J_top > JMAX || mp % Bb)
    return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    if (keys == nullptr) return (int)cudaErrorInvalidValue;
  } else {
    if (G < 1 || G > 32 || (G & (G - 1)) || R % G || Wr < 1)
      return (int)cudaErrorInvalidValue;
    const int threads = Bb * Wr * 32;
    const int Ls = Wr * (32 / G);
    if (threads > (key_regs ? 256 : 512) || (key_regs && Kr > NQ * Ls))
      return (int)cudaErrorInvalidValue;
    const long long tile = (long long)Bb * Kr * G;
    const long long need =
        4LL * ((Wr > 1 ? (long long)Bb * Wr * NSTAT * G : 0) +
               (key_regs ? 0 : tile) + (s_res ? (long long)n * G : 0));
    if (need != (long long)smem_bytes) return (int)cudaErrorInvalidValue;
  }
  const Args a{(float*)S, (int32_t*)x, (float*)pi, (float*)P, (float*)keys,
               (const uint8_t*)sched, (const int32_t*)order,
               (const int32_t*)n_rows, (const int32_t*)rowmeta,
               (const int32_t*)row_vars, (const float*)row_factor,
               (const float*)cost, (const float*)cq, (const float*)kappa,
               (const float*)amp, (const float*)delta, (const float*)theta,
               (const int32_t*)seed, m, n, Kr, R, mp, Bb, J_bot, J_top,
               minimize, G, Wr, s_res, smem_bytes,
               (cudaStream_t)stream};
  const bool has_cq = cq != nullptr;
  cudaError_t e;
  if (unit)
    e = has_cq ? launch_variant<true, true>(a, variant, key_regs)
               : launch_variant<true, false>(a, variant, key_regs);
  else
    e = has_cq ? launch_variant<false, true>(a, variant, key_regs)
               : launch_variant<false, false>(a, variant, key_regs);
  return (int)e;
}
