// K fused greedy placement steps of one pod template on one thread-block
// cluster; and the batched entry that runs one cluster per template.
//
// What it replaces.  fused_steps_kernel replaces the JAX package's Pallas
// TPU kernel cluster_capacity_tpu/engine/fused.py `_build_kernel`
// (pallas_call in `_compiled_call`).  fused_steps_batched_kernel replaces
// the batched one, cluster_capacity_tpu/engine/fused_batched.py
// `_build_batched_kernel` (pallas_call in `_compiled_batched_call`,
// grid=(B,), per-template numbers from an SMEM scalar table).  Both compute
// the same function bit for bit in float32: the same planes in the same
// [P, S, 128] layout, the same scalars block (placed_count, stopped,
// next_start, aff_total) and `chosen` (-1 after the stop).  Per-template
// numbers that the single TPU kernel compiles in as literals are read here
// from an int32 and a float32 table (layout generated from engine/fused.py
// INT_FIELDS / FLOAT_FIELDS into fused_layout.h), so one build serves every
// problem; the batched entry gives each cluster its own table row.  The TPU
// batched kernel's group-wide soft-spread domain loop (to max_dnh) counts
// the same domains as the per-row ss_dnh bound here: a row's domain ids are
// all below its own count.
//
// What bounds it.  Per step the kernel reads each const and carry plane of
// the problem once (the 10,000-node bench `scan` cell: 10 const + 8 carry
// planes of 40 KB) and writes back the few carry entries the placement
// touches: well under a microsecond of bytes at 3.35 TB/s.  What bounds it
// is latency: every step is a chain of reductions over the whole node axis
// (hard-spread minima, any-feasible, the sampling search, the score
// normalisers, the soft-spread min/max, the argmax), and the next step
// depends on this step's argmax.  A step costs the per-node work of the
// longest node slice plus one barrier chain per reduction.
//
// The design.  One template's node axis is cut into C contiguous slices of
// a multiple of 128 lanes, one per CTA of a thread-block cluster of C CTAs
// (C = 1, 2, 4, 8 or 16).  The launch plan (engine/fused.py `launch_plan`) picks C,
// the threads, the slice width and which planes live in dynamic shared
// memory for the whole launch, in the order scratch, carry, const; each
// CTA copies its slice of those planes in once, with the int table and
// the float table but its log tail, runs the K steps from shared memory
// and registers, and writes its carry slice to `yout` at the end.  A per-CTA table of generic plane base pointers (PT) points each
// plane into shared memory or into device memory, so the step has one code
// path whatever is resident.  Each thread owns the same nodes of its slice
// for the whole launch, so per-node state needs no synchronisation; only
// the reductions do.  A reduction runs inside the CTA (warp shuffles, then
// warp 0 over the warp partials), publishes the CTA's partial in a shared
// slot double-buffered by reduction parity, crosses one cluster barrier
// (barrier.cluster arrive.release / wait.acquire), and then every CTA reads
// the C partials through distributed shared memory (map_shared_rank: lane r
// of warp 0 reads rank r's) and combines them, and warp 0 hands the result
// to the CTA through shared memory.  The double buffer makes one barrier enough: a CTA writes
// slot p again only after the next barrier, which no CTA passes before it
// has read slot p.  Every CTA computes the same step scalars; cluster rank
// 0 alone writes `chosen` and `sout`; each CTA commits its own slice,
// reading the chosen node's domain ids from the const planes in device
// memory.  The batched entry is a grid of B x C CTAs with cluster dims C:
// template b = blockIdx.x / C, every pointer offset by its own slab, table
// row, `chosen` row and 4-plane scratch.
//
// Why the result does not depend on C.  Every reduction is a min, a max, an
// OR of bit masks, a sum of 0/1 counts (exact in float32 up to 2^24 terms),
// or an argmax whose ties go to the lowest node index; each is exact in any
// order and any grouping, so the partials of any slicing combine to the
// same value.  A min or max can return either zero sign when +0 and -0
// meet, and no use of a reduced value tells them apart (compares, and
// sums with a nonzero term).  Per-node arithmetic is the same code on the
// same operands whatever CTA holds the node.
//
// Exactness.  Built with -fmad=false (no a*b+c contraction: the fit
// `acc + per*w` left fold and the spread `cnt*tp + (skew-1)` round after
// each operation, as the JAX step's separate ops do), IEEE division and
// sqrtf (-prec-div, -prec-sqrt, no fast math), rintf for jnp.round (half to
// even), truncf for jnp.trunc, floorf(a / fmaxf(b, 1e-30f)) for _floor_div,
// and the log of the spread's topology size read from the float32 log
// table.  Argmax ties go to the lowest real node index; padded lanes never
// win.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "fused_layout.h"

namespace cg = cooperative_groups;

#define BIGF 2147483647.0f
#define OP_MAX 0
#define OP_MIN 1
#define OP_SUM 2
#define OP_OR 3
#define MAX_WARPS 32
#define RED_WORDS (6 + MAX_SPREAD)
#define MAX_PLANES (MAX_CONST_PLANES + MAX_CARRY_PLANES + SCRATCH_PLANES)
#define CLUSTER_UNSCHEDULABLE (-1)

extern __shared__ __align__(16) float res_smem[];

__device__ __forceinline__ float combine(int op, float a, float b) {
  if (op == OP_MAX) return fmaxf(a, b);
  if (op == OP_MIN) return fminf(a, b);
  if (op == OP_OR) return __uint_as_float(__float_as_uint(a) | __float_as_uint(b));
  return a + b;
}

__device__ __forceinline__ float identity(int op) {
  if (op == OP_MAX) return -INFINITY;
  if (op == OP_MIN) return INFINITY;
  return 0.f;  // sum; for OR the all-zero bit pattern
}

__device__ __forceinline__ void cluster_barrier(int ncta) {
  if (ncta > 1) cg::this_cluster().sync();
  else __syncthreads();
}

__device__ __forceinline__ const float* partial_of(float* mine, int r,
                                                   int ncta) {
  return ncta > 1 ? cg::this_cluster().map_shared_rank(mine, r) : mine;
}

// Cluster-wide reduction of NV words at once; every thread of every CTA
// gets the results.  C = 1: one __syncthreads; C > 1: a __syncthreads, one
// cluster barrier and a __syncthreads after warp 0's DSMEM reads.
template <int NV>
__device__ void cluster_reduce(float (&v)[NV], const int (&ops)[NV],
                               float* stage, float (*slot)[RED_WORDS],
                               float* bcast, int& parity, int ncta) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int q = 0; q < NV; ++q)
      v[q] = combine(ops[q], v[q], __shfl_xor_sync(0xffffffffu, v[q], off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < NV; ++q) stage[q * MAX_WARPS + warp] = v[q];
  __syncthreads();
  float* mine = slot[parity];
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      float x = lane < nw ? stage[q * MAX_WARPS + lane] : identity(ops[q]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x = combine(ops[q], x, __shfl_xor_sync(0xffffffffu, x, off));
      if (lane == 0) mine[q] = x;
    }
  }
  cluster_barrier(ncta);
  const float* res = mine;
  if (ncta > 1) {
    // warp 0 reads the C partials (lane r those of rank r) and broadcasts
    if (warp == 0) {
      const float* pr = lane < ncta ? partial_of(mine, lane, ncta) : mine;
#pragma unroll
      for (int q = 0; q < NV; ++q) {
        float x = lane < ncta ? pr[q] : identity(ops[q]);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          x = combine(ops[q], x, __shfl_xor_sync(0xffffffffu, x, off));
        if (lane == 0) bcast[q] = x;
      }
    }
    __syncthreads();
    res = bcast;
  }
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = res[q];
  parity ^= 1;
}

// Argmax with the lowest index winning ties; padded lanes carry indices
// >= n so that a real lane always beats them at equal value.
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

__device__ void cluster_argmax(float& v, int& idx, float* stage,
                               float (*slot)[RED_WORDS], float* bcast,
                               int& parity, int ncta) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
    better(v, idx, v2, i2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    stage[warp] = v;
    stage[MAX_WARPS + warp] = __int_as_float(idx);
  }
  __syncthreads();
  float* mine = slot[parity];
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    float x = lane < nw ? stage[lane] : -INFINITY;
    int xi = lane < nw ? __float_as_int(stage[MAX_WARPS + lane]) : 0x7fffffff;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float v2 = __shfl_xor_sync(0xffffffffu, x, off);
      int i2 = __shfl_xor_sync(0xffffffffu, xi, off);
      better(x, xi, v2, i2);
    }
    if (lane == 0) { mine[0] = x; mine[1] = __int_as_float(xi); }
  }
  cluster_barrier(ncta);
  const float* res = mine;
  if (ncta > 1) {
    if (warp == 0) {
      const float* pr = lane < ncta ? partial_of(mine, lane, ncta) : mine;
      float x = lane < ncta ? pr[0] : -INFINITY;
      int xi = lane < ncta ? __float_as_int(pr[1]) : 0x7fffffff;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        float v2 = __shfl_xor_sync(0xffffffffu, x, off);
        int i2 = __shfl_xor_sync(0xffffffffu, xi, off);
        better(x, xi, v2, i2);
      }
      if (lane == 0) { bcast[0] = x; bcast[1] = __int_as_float(xi); }
    }
    __syncthreads();
    res = bcast;
  }
  v = res[0];
  idx = __float_as_int(res[1]);
  parity ^= 1;
}

__device__ __forceinline__ int pmod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

// helper.BuildBrokenLinearFunction on the table's float32 shape constants.
__device__ float piecewise(float util, const float* ft, int n_seg) {
  float out = ft[FT_SHAPE_Y0];
  for (int q = 0; q < n_seg; ++q) {
    float x_lo = ft[FT_SEG_XLO + q], x_hi = ft[FT_SEG_XHI + q];
    float qv = (ft[FT_SEG_DY + q] * (util - x_lo)) / ft[FT_SEG_DX + q];
    float seg = ft[FT_SEG_YLO + q] + truncf(qv);
    if (util > x_lo && util <= x_hi) out = seg;
  }
  if (util > ft[FT_SHAPE_XLAST]) out = ft[FT_SHAPE_YLAST];
  return out;
}

// The K steps of one template, run by one CTA of its cluster on the node
// slice [lo, lo + nl) of width `lanes`; the first n_res planes of the
// order (scratch, carry, const) live in dynamic shared memory.
__device__ __forceinline__ void
fused_steps_body(const float* __restrict__ cst,
                 const float* __restrict__ yin,
                 const float* __restrict__ sin_,
                 const int* __restrict__ itab,
                 const float* __restrict__ ft,
                 float* __restrict__ yout, float* __restrict__ sout,
                 int* __restrict__ chosen_out, float* __restrict__ scratch,
                 int k, int s, int n_const, int n_carry, int ncta, int rank,
                 int lanes, int n_res) {
  __shared__ int T[TABLE_INT_WIDTH];
  __shared__ float F[FT_LOG];   // the float table but its log tail
  __shared__ float stage[RED_WORDS * MAX_WARPS];
  __shared__ float slot[2][RED_WORDS];
  __shared__ float bcast[RED_WORDS];
  __shared__ float* PT[MAX_PLANES];
  __shared__ float sc[4];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int npad = s * LANES;
  const int lo = min(rank * lanes, npad);
  const int nl = min(lanes, npad - lo);
  const int n_planes = n_const + n_carry + SCRATCH_PLANES;
  for (int i = tid; i < TABLE_INT_WIDTH; i += nt) T[i] = itab[i];
  for (int i = tid; i < FT_LOG; i += nt) F[i] = ft[i];
  if (tid < 4) sc[tid] = sin_[tid];
  // plane p: const 0..n_const-1, carry n_const.., scratch last; resident
  // slot order scratch, carry, const
  for (int p = tid; p < n_planes; p += nt) {
    int res;
    float* dev;
    if (p < n_const) {
      res = SCRATCH_PLANES + n_carry + p;
      dev = const_cast<float*>(cst) + (size_t)p * npad + lo;
    } else if (p < n_const + n_carry) {
      res = SCRATCH_PLANES + (p - n_const);
      dev = yout + (size_t)(p - n_const) * npad + lo;
    } else {
      res = p - n_const - n_carry;
      dev = scratch + (size_t)res * npad + lo;
    }
    PT[p] = res < n_res ? res_smem + (size_t)res * lanes : dev;
  }
  // copy this slice in: resident carry and const planes to shared memory,
  // the other carry planes yin -> yout (16-byte vectors; lo and nl are
  // multiples of 128)
  const int nv = nl >> 2;
  for (int r = SCRATCH_PLANES; r < n_res; ++r) {
    const int q = r - SCRATCH_PLANES;
    const float* src = q < n_carry ? yin + (size_t)q * npad + lo
                                   : cst + (size_t)(q - n_carry) * npad + lo;
    float4* dst = reinterpret_cast<float4*>(res_smem + (size_t)r * lanes);
    for (int e = tid; e < nv; e += nt)
      dst[e] = reinterpret_cast<const float4*>(src)[e];
  }
  for (int q = max(0, n_res - SCRATCH_PLANES); q < n_carry; ++q) {
    const float4* src = reinterpret_cast<const float4*>(yin + (size_t)q * npad + lo);
    float4* dst = reinterpret_cast<float4*>(yout + (size_t)q * npad + lo);
    for (int e = tid; e < nv; e += nt) dst[e] = src[e];
  }
  cluster_barrier(ncta);

#define CP(p) (PT[(p)])
#define YP(p) (PT[n_const + (p)])
#define CG(p, i) (cst[(size_t)(p) * npad + (i)])
  const int n = T[IT_N];
  const int ch = T[IT_CH], cs = T[IT_CS], g = T[IT_G];
  const int w_fit = T[IT_W_FIT], w_bal = T[IT_W_BAL], w_taint = T[IT_W_TAINT];
  const int w_na = T[IT_W_NA], w_il = T[IT_W_IL], w_spread = T[IT_W_SPREAD];
  const int w_ipa = T[IT_W_IPA];
  const bool norm_on = w_taint || w_na || w_spread || w_ipa;
  float* feas = PT[n_const + n_carry];
  float* scor_buf = PT[n_const + n_carry + 1];
  float* sraw = PT[n_const + n_carry + 2];
  float* iraw = PT[n_const + n_carry + 3];
  const float NINF = -INFINITY, PINF = INFINITY;
  int parity = 0;

  for (int step = 0; step < k; ++step) {
    const float placed_count = sc[0], stopped = sc[1];
    const float next_start = sc[2], aff_total = sc[3];
    if (stopped > 0.5f) {
      // a stopped step changes nothing (place = false, next_start kept)
      if (tid == 0 && rank == 0) chosen_out[step] = -1;
      continue;
    }

    // ---- hard spread: min match count over countable nodes -------------
    float mm[MAX_SPREAD] = {0.f, 0.f, 0.f, 0.f};
    if (ch > 0) {
      float v[MAX_SPREAD] = {BIGF, BIGF, BIGF, BIGF};
      const int ops[MAX_SPREAD] = {OP_MIN, OP_MIN, OP_MIN, OP_MIN};
      for (int li = tid; li < nl; li += nt)
        for (int c = 0; c < ch; ++c)
          v[c] = fminf(v[c], CP(T[IT_C_SH_COUNTABLE + c])[li] > 0.5f
                                 ? YP(T[IT_Y_SH_CNT + c])[li] : BIGF);
      cluster_reduce<MAX_SPREAD>(v, ops, stage, slot, bcast, parity, ncta);
      for (int c = 0; c < ch; ++c) mm[c] = T[IT_SH_MINZERO + c] ? 0.f : v[c];
    }

    // ---- feasibility ---------------------------------------------------
    int any_local = 0;
    for (int li = tid; li < nl; li += nt) {
      bool f = CP(T[IT_C_STATIC_MASK])[li] > 0.5f;
      if (T[IT_FIT_FILTER_ON]) {
        bool ok = !(YP(T[IT_Y_REQUESTED + IDX_PODS])[li] + 1.0f >
                    CP(T[IT_C_ALLOC + IDX_PODS])[li]);
        for (int j = 0; j < T[IT_R]; ++j) {
          if (j == IDX_PODS) continue;
          const float rv = F[FT_REQ_VEC + j], shr = F[FT_SHARED_REQ_VEC + j];
          const float free_ = CP(T[IT_C_ALLOC + j])[li] - YP(T[IT_Y_REQUESTED + j])[li];
          if (T[IT_DRA_SHARED_COLOCATE] && shr != 0.f) {
            const float rvj = rv + (placed_count == 0.f ? shr : 0.f);
            ok = ok && !(rvj > free_);
          } else if (rv > 0.f) {
            ok = ok && !(rv > free_);
          }
        }
        f = f && ok;
      }
      const float placed = YP(T[IT_Y_PLACED])[li];
      if (T[IT_CLONE_HAS_PORTS]) f = f && !(placed > 0.f);
      if (T[IT_VOLUME_FILTER_ON]) f = f && CP(T[IT_C_VOLUME_MASK])[li] > 0.5f;
      if (T[IT_VOLUME_SELF_CONFLICT]) f = f && !(placed > 0.f);
      if (T[IT_RWOP_SELF_CONFLICT]) f = f && placed_count == 0.f;
      if (T[IT_DRA_SHARED_COLOCATE]) f = f && (placed > 0.f || placed_count == 0.f);
      if (ch > 0) {
        bool violated = false;
        for (int c = 0; c < ch; ++c) {
          const float cnt = YP(T[IT_Y_SH_CNT + c])[li];
          const float skew = (cnt + (T[IT_SH_SELF + c] ? 1.0f : 0.0f)) - mm[c];
          const bool has_key = CP(T[IT_C_SH_DOM + c])[li] >= 0.f;
          violated = violated || (skew > F[FT_SH_SKEW + c] && has_key);
        }
        f = f && !(CP(T[IT_C_SH_MISSING])[li] > 0.5f || violated);
      }
      if (T[IT_IPA_FILTER_ON]) {
        bool aff_ok = true;
        if (T[IT_IPA_AFF_ON]) {
          bool pods_exist = true, all_keys = true;
          for (int q = 0; q < g; ++q) {
            if (!T[IT_GHAS_AFF + q]) continue;
            const bool has_key = CP(T[IT_C_IPA_DOM + q])[li] >= 0.f;
            const float tot = CP(T[IT_C_IPA_AFF_SCNT + q])[li] + YP(T[IT_Y_AFF_CNT + q])[li];
            pods_exist = pods_exist && has_key && tot > 0.f;
            all_keys = all_keys && has_key;
          }
          aff_ok = T[IT_IPA_ESCAPE] ? (pods_exist || (all_keys && aff_total == 0.f))
                                    : pods_exist;
        }
        bool anti_fail = false, eanti_dyn = false;
        if (T[IT_IPA_ANTI_ON]) {
          for (int q = 0; q < g; ++q) {
            if (!T[IT_GHAS_ANTI + q]) continue;
            const bool has_key = CP(T[IT_C_IPA_DOM + q])[li] >= 0.f;
            const float dyn = YP(T[IT_Y_ANTI_CNT + q])[li];
            anti_fail = anti_fail || (has_key && CP(T[IT_C_IPA_ANTI_SCNT + q])[li] + dyn > 0.f);
            eanti_dyn = eanti_dyn || (has_key && dyn > 0.f);
          }
        }
        const bool eanti_fail = CP(T[IT_C_IPA_EANTI_STATIC])[li] > 0.5f || eanti_dyn;
        f = f && aff_ok && !anti_fail && !eanti_fail;
      }
      feas[li] = f ? 1.f : 0.f;
      any_local |= f;
    }
    // any-feasible rides the normaliser reduction when there is one
    bool any_feasible = false;
    if (!norm_on) {
      float v[1] = {any_local ? 1.f : 0.f};
      const int ops[1] = {OP_MAX};
      cluster_reduce<1>(v, ops, stage, slot, bcast, parity, ncta);
      any_feasible = v[0] > 0.5f;
    }

    // ---- sampling (numFeasibleNodesToFind emulation) -------------------
    float new_next_start = next_start;
    const float* scor = feas;
    const int sample_k = T[IT_SAMPLE_K];
    if (sample_k > 0) {
      const int start = (int)next_start;
      int lo_r = 0, hi_r = n - 1;
      for (int it = 0; it < T[IT_BS_ITERS]; ++it) {
        const int mid = (lo_r + hi_r) >> 1;
        float v[1] = {0.f};
        const int ops[1] = {OP_SUM};
        for (int li = tid; li < nl; li += nt) {
          const int i = lo + li;
          const int rank_i = i < n ? pmod(i - start, n) : n;
          if (feas[li] > 0.5f && rank_i <= mid) v[0] += 1.f;
        }
        cluster_reduce<1>(v, ops, stage, slot, bcast, parity, ncta);
        if ((int)v[0] >= sample_k) hi_r = mid; else lo_r = mid + 1;
      }
      for (int li = tid; li < nl; li += nt) {
        const int i = lo + li;
        const int rank_i = i < n ? pmod(i - start, n) : n;
        scor_buf[li] = (feas[li] > 0.5f && rank_i <= hi_r) ? 1.f : 0.f;
      }
      scor = scor_buf;
      new_next_start = (float)pmod(start + (hi_r + 1), n);
    }

    // ---- reductions the score normalisers need -------------------------
    float tmax = 0.f, nmax = 0.f, host_size = 0.f, imax = NINF, imin = PINF;
    unsigned dmask[MAX_SPREAD] = {0u, 0u, 0u, 0u};
    if (norm_on) {
      float v[RED_WORDS] = {NINF, NINF, 0.f, NINF, PINF,
                            any_local ? 1.f : 0.f, 0.f, 0.f, 0.f, 0.f};
      const int ops[RED_WORDS] = {OP_MAX, OP_MAX, OP_SUM, OP_MAX, OP_MIN,
                                  OP_MAX, OP_OR, OP_OR, OP_OR, OP_OR};
      unsigned lmask[MAX_SPREAD] = {0u, 0u, 0u, 0u};
      for (int li = tid; li < nl; li += nt) {
        const bool sc_ = scor[li] > 0.5f;
        if (w_taint) v[0] = fmaxf(v[0], sc_ ? CP(T[IT_C_TAINT_RAW])[li] : 0.f);
        if (w_na) v[1] = fmaxf(v[1], sc_ ? CP(T[IT_C_NA_RAW])[li] : 0.f);
        if (w_spread && sc_ && !(CP(T[IT_C_SS_IGNORED])[li] > 0.5f)) {
          v[2] += 1.f;
          for (int c = 0; c < cs; ++c) {
            if (T[IT_SS_HOST + c]) continue;
            const float d = CP(T[IT_C_SS_DOM + c])[li];
            if (d >= 0.f && d < (float)T[IT_SS_DNH + c]) lmask[c] |= 1u << (int)d;
          }
        }
        if (w_ipa) {
          float raw = CP(T[IT_C_IPA_STATIC_PREF])[li];
          if (T[IT_IPA_PREF_ON])
            for (int q = 0; q < g; ++q)
              raw = raw + (CP(T[IT_C_IPA_DOM + q])[li] >= 0.f ? YP(T[IT_Y_PREF_CNT + q])[li] : 0.f);
          iraw[li] = raw;
          if (sc_) { v[3] = fmaxf(v[3], raw); v[4] = fminf(v[4], raw); }
        }
      }
#pragma unroll
      for (int c = 0; c < MAX_SPREAD; ++c) v[6 + c] = __uint_as_float(lmask[c]);
      cluster_reduce<RED_WORDS>(v, ops, stage, slot, bcast, parity, ncta);
      tmax = v[0]; nmax = v[1]; host_size = v[2]; imax = v[3]; imin = v[4];
      any_feasible = v[5] > 0.5f;
#pragma unroll
      for (int c = 0; c < MAX_SPREAD; ++c) dmask[c] = __float_as_uint(v[6 + c]);
    }

    if (!any_feasible) {
      if (tid == 0) {
        if (rank == 0) chosen_out[step] = -1;
        sc[1] = 1.f;
        sc[2] = new_next_start;
      }
      __syncthreads();
      continue;
    }

    // ---- soft spread raw scores and their min/max ------------------------
    float smax = 0.f, smin = 0.f;
    if (w_spread) {
      float tp[MAX_SPREAD];
      for (int c = 0; c < cs; ++c) {
        int size;
        if (T[IT_SS_HOST + c]) {
          size = (int)host_size;
        } else {
          const int dnh = T[IT_SS_DNH + c];
          const unsigned m = dnh >= 32 ? 0xffffffffu : ((1u << dnh) - 1u);
          size = __popc(dmask[c] & m);
        }
        tp[c] = ft[FT_LOG + size];
      }
      float v[2] = {NINF, PINF};
      const int ops[2] = {OP_MAX, OP_MIN};
      for (int li = tid; li < nl; li += nt) {
        float raw = 0.f;
        for (int c = 0; c < cs; ++c) {
          const float dom = CP(T[IT_C_SS_DOM + c])[li];
          float term = 0.f;
          if (dom >= 0.f) {
            float cnt;
            if (T[IT_SS_HOST + c]) {
              cnt = CP(T[IT_C_SS_EXISTING + c])[li];
              if (T[IT_SS_SELF + c]) cnt = cnt + YP(T[IT_Y_PLACED])[li];
            } else {
              cnt = YP(T[IT_Y_SS_CNT + c])[li];
            }
            term = __fadd_rn(__fmul_rn(cnt, tp[c]), F[FT_SS_SKEW_M1 + c]);
          }
          raw = raw + term;
        }
        raw = rintf(raw);
        sraw[li] = raw;
        if (scor[li] > 0.5f && !(CP(T[IT_C_SS_IGNORED])[li] > 0.5f)) {
          v[0] = fmaxf(v[0], raw);
          v[1] = fminf(v[1], raw);
        }
      }
      cluster_reduce<2>(v, ops, stage, slot, bcast, parity, ncta);
      if (host_size > 0.f) { smax = v[0]; smin = v[1]; }
    }

    // ---- total score and host selection --------------------------------
    float best = NINF;
    int best_i = 0x7fffffff;
    for (int li = tid; li < nl; li += nt) {
      const int i = lo + li;
      const bool sc_ = scor[li] > 0.5f;
      float total = 0.f;
      if (w_fit) {
        float acc = 0.f, wsum = 0.f;
        const int strat = T[IT_FIT_STRATEGY];
        for (int k2 = 0; k2 < T[IT_N_FIT]; ++k2) {
          const int j = T[IT_FIT_IDX + k2];
          const float alloc = CP(T[IT_C_ALLOC + j])[li];
          float req = T[IT_FIT_NZ + k2]
                          ? YP(j == IDX_CPU ? T[IT_Y_NONZERO0] : T[IT_Y_NONZERO1])[li]
                          : YP(T[IT_Y_REQUESTED + j])[li];
          req = req + F[FT_FIT_REQ + k2];
          float per;
          if (strat == FIT_MOST) {
            per = alloc > 0.f ? floorf((fminf(req, alloc) * 100.0f) / fmaxf(alloc, 1e-30f)) : 0.f;
          } else if (strat == FIT_RTC) {
            const float util = alloc > 0.f ? floorf((req * 100.0f) / fmaxf(alloc, 1e-30f)) : 0.f;
            per = truncf(piecewise(util, F, T[IT_N_SEG]));
            per = alloc > 0.f ? per : 0.f;
          } else {
            per = req > alloc ? 0.f : floorf(((alloc - req) * 100.0f) / fmaxf(alloc, 1e-30f));
            per = alloc > 0.f ? per : 0.f;
          }
          const float w = F[FT_FIT_W + k2];
          acc = acc + per * w;
          const bool counted = strat == FIT_RTC ? (alloc > 0.f && per > 0.f) : alloc > 0.f;
          wsum = wsum + (counted ? w : 0.f);
        }
        float score;
        if (strat == FIT_RTC)
          score = wsum > 0.f ? floorf(acc / fmaxf(wsum, 1e-30f) + 0.5f) : 0.f;
        else
          score = wsum > 0.f ? floorf(acc / fmaxf(wsum, 1e-30f)) : 0.f;
        total = total + (float)w_fit * (sc_ ? score : 0.f);
      }
      if (w_bal) {
        float count = 0.f, fsum = 0.f;
        const int nb = T[IT_N_BAL];
        for (int k2 = 0; k2 < nb; ++k2) {
          const int j = T[IT_BAL_IDX + k2];
          const float alloc = CP(T[IT_C_ALLOC + j])[li];
          const float req = YP(T[IT_Y_REQUESTED + j])[li] + F[FT_BAL_REQ + k2];
          const bool valid = alloc > 0.f;
          count = count + (valid ? 1.f : 0.f);
          fsum = fsum + (valid ? fminf(req / fmaxf(alloc, 1e-30f), 1.0f) : 0.f);
        }
        const float mean = fsum / fmaxf(count, 1.0f);
        float vsum = 0.f;
        for (int k2 = 0; k2 < nb; ++k2) {
          const int j = T[IT_BAL_IDX + k2];
          const float alloc = CP(T[IT_C_ALLOC + j])[li];
          const float req = YP(T[IT_Y_REQUESTED + j])[li] + F[FT_BAL_REQ + k2];
          const bool valid = alloc > 0.f;
          const float fr = valid ? fminf(req / fmaxf(alloc, 1e-30f), 1.0f) : 0.f;
          const float d = fr - mean;
          vsum = vsum + (valid ? d * d : 0.f);
        }
        const float var = vsum / fmaxf(count, 1.0f);
        const float stdv = count >= 2.f ? sqrtf(var) : 0.f;
        const float score = truncf((1.0f - stdv) * 100.0f);
        total = total + (float)w_bal * (sc_ ? score : 0.f);
      }
      if (w_taint) {
        const float raw = CP(T[IT_C_TAINT_RAW])[li];
        float scaled = tmax > 0.f ? floorf((100.0f * raw) / tmax) : raw;
        scaled = tmax > 0.f ? 100.0f - scaled : 100.0f;
        total = total + (float)w_taint * (sc_ ? scaled : 0.f);
      }
      if (w_na) {
        const float raw = CP(T[IT_C_NA_RAW])[li];
        const float scaled = nmax > 0.f ? floorf((100.0f * raw) / nmax) : raw;
        total = total + (float)w_na * (sc_ ? scaled : 0.f);
      }
      if (w_il) total = total + (float)w_il * (sc_ ? CP(T[IT_C_IL_SCORE])[li] : 0.f);
      if (w_spread) {
        const bool ssc = sc_ && !(CP(T[IT_C_SS_IGNORED])[li] > 0.5f);
        const float out = smax == 0.f
            ? 100.0f
            : floorf((100.0f * ((smax + smin) - sraw[li])) / fmaxf(smax, 1e-30f));
        total = total + (float)w_spread * (ssc ? out : 0.f);
      }
      if (w_ipa) {
        const float diff = imax - imin;
        const float norm = diff > 0.f ? floorf((100.0f * (iraw[li] - imin)) / diff) : 0.f;
        total = total + (float)w_ipa * (sc_ ? norm : 0.f);
      }
      const float keyed = sc_ ? total : -1.0f;
      better(best, best_i, keyed, i < n ? i : n + i);
    }
    cluster_argmax(best, best_i, stage, slot, bcast, parity, ncta);
    const int chosen = best_i < n ? best_i : 0;

    // ---- commit (place is true here): each CTA its own slice -------------
    float sh_dom_ch[MAX_SPREAD], sh_inc[MAX_SPREAD];
    for (int c = 0; c < ch; ++c) {
      sh_dom_ch[c] = CG(T[IT_C_SH_DOM + c], chosen);
      sh_inc[c] = CG(T[IT_C_SH_COUNTABLE + c], chosen) * 1.0f;
    }
    float ss_dom_ch[MAX_SPREAD], ss_inc[MAX_SPREAD];
    for (int c = 0; c < cs; ++c) {
      ss_dom_ch[c] = CG(T[IT_C_SS_DOM + c], chosen);
      ss_inc[c] = CG(T[IT_C_SS_COUNTABLE + c], chosen) * 1.0f;
    }
    const bool ipa_commit = T[IT_IPA_AFF_ON] || T[IT_IPA_ANTI_ON] || T[IT_IPA_PREF_ON];
    float ipa_dom_ch[MAX_GROUPS], ipa_valid[MAX_GROUPS];
    float new_aff_total = aff_total;
    if (ipa_commit) {
      for (int q = 0; q < g; ++q) {
        ipa_dom_ch[q] = CG(T[IT_C_IPA_DOM + q], chosen);
        ipa_valid[q] = ipa_dom_ch[q] >= 0.f ? 1.f : 0.f;
        if (T[IT_IPA_AFF_ON] && F[FT_AFF_GINC + q] != 0.f)
          new_aff_total = new_aff_total + (F[FT_AFF_GINC + q] * ipa_valid[q]) * 1.0f;
      }
    }
    for (int li = tid; li < nl; li += nt) {
      if (lo + li == chosen) {
        for (int j = 0; j < T[IT_R]; ++j) {
          const float rv = F[FT_REQ_VEC + j], shr = F[FT_SHARED_REQ_VEC + j];
          float* y = YP(T[IT_Y_REQUESTED + j]);
          if (T[IT_DRA_SHARED_COLOCATE] && shr != 0.f)
            y[li] = y[li] + (rv + (placed_count == 0.f ? shr : 0.f));
          else if (rv != 0.f)
            y[li] = y[li] + rv;
        }
        if (F[FT_REQ_NONZERO] != 0.f)
          YP(T[IT_Y_NONZERO0])[li] = YP(T[IT_Y_NONZERO0])[li] + F[FT_REQ_NONZERO];
        if (F[FT_REQ_NONZERO + 1] != 0.f)
          YP(T[IT_Y_NONZERO1])[li] = YP(T[IT_Y_NONZERO1])[li] + F[FT_REQ_NONZERO + 1];
        YP(T[IT_Y_PLACED])[li] = YP(T[IT_Y_PLACED])[li] + 1.0f;
      }
      for (int c = 0; c < ch; ++c) {
        if (!T[IT_SH_SELF + c]) continue;
        const float dom = CP(T[IT_C_SH_DOM + c])[li];
        if (dom == sh_dom_ch[c] && dom >= 0.f) {
          float* y = YP(T[IT_Y_SH_CNT + c]);
          y[li] = y[li] + sh_inc[c];
        }
      }
      for (int c = 0; c < cs; ++c) {
        if (!T[IT_SS_SELF + c]) continue;
        const float dom = CP(T[IT_C_SS_DOM + c])[li];
        if (dom == ss_dom_ch[c] && dom >= 0.f) {
          float* y = YP(T[IT_Y_SS_CNT + c]);
          y[li] = y[li] + ss_inc[c];
        }
      }
      if (ipa_commit) {
        for (int q = 0; q < g; ++q) {
          const float dom = CP(T[IT_C_IPA_DOM + q])[li];
          if (!(dom == ipa_dom_ch[q] && dom >= 0.f)) continue;
          if (T[IT_IPA_AFF_ON] && F[FT_AFF_GINC + q] != 0.f) {
            float* y = YP(T[IT_Y_AFF_CNT + q]);
            y[li] = y[li] + (F[FT_AFF_GINC + q] * ipa_valid[q]) * 1.0f;
          }
          if (T[IT_IPA_ANTI_ON] && F[FT_ANTI_GINC + q] != 0.f) {
            float* y = YP(T[IT_Y_ANTI_CNT + q]);
            y[li] = y[li] + (F[FT_ANTI_GINC + q] * ipa_valid[q]) * 1.0f;
          }
          if (T[IT_IPA_PREF_ON] && F[FT_PREF_GW + q] != 0.f) {
            float* y = YP(T[IT_Y_PREF_CNT + q]);
            y[li] = y[li] + (F[FT_PREF_GW + q] * ipa_valid[q]) * 1.0f;
          }
        }
      }
    }
    if (tid == 0) {
      if (rank == 0) chosen_out[step] = chosen;
      sc[0] = placed_count + 1.0f;
      sc[2] = new_next_start;
      sc[3] = new_aff_total;
    }
    __syncthreads();
  }
#undef CP
#undef YP
#undef CG

  // write the resident carry slice back; no CTA leaves while another may
  // still read its reduction slots
  __syncthreads();
  for (int q = 0; q < n_carry && SCRATCH_PLANES + q < n_res; ++q) {
    const float4* src = reinterpret_cast<const float4*>(
        res_smem + (size_t)(SCRATCH_PLANES + q) * lanes);
    float4* dst = reinterpret_cast<float4*>(yout + (size_t)q * npad + lo);
    for (int e = tid; e < nv; e += nt) dst[e] = src[e];
  }
  if (rank == 0 && tid < 4) sout[tid] = sc[tid];
  cluster_barrier(ncta);
}

// One template on one cluster of gridDim.x CTAs.
extern "C" __global__ void __launch_bounds__(1024, 1)
fused_steps_kernel(const float* __restrict__ cst,
                   const float* __restrict__ yin,
                   const float* __restrict__ sin_,
                   const int* __restrict__ itab,
                   const float* __restrict__ ft,
                   float* __restrict__ yout, float* __restrict__ sout,
                   int* __restrict__ chosen_out, float* __restrict__ scratch,
                   int k, int s, int n_const, int n_carry, int lanes,
                   int n_res) {
  cg::cluster_group cl = cg::this_cluster();
  fused_steps_body(cst, yin, sin_, itab, ft, yout, sout, chosen_out, scratch,
                   k, s, n_const, n_carry, (int)cl.num_blocks(),
                   (int)cl.block_rank(), lanes, n_res);
}

// Cluster b runs template b: const [B, n_const, S, 128], carry [B, n_carry,
// S, 128], scalars [B, 4], int table [B, TABLE_INT_WIDTH], float table [B,
// f_width], chosen [B, k], scratch [B, 4, S * 128].
extern "C" __global__ void __launch_bounds__(1024, 1)
fused_steps_batched_kernel(const float* __restrict__ cst,
                           const float* __restrict__ yin,
                           const float* __restrict__ sin_,
                           const int* __restrict__ itab,
                           const float* __restrict__ ft,
                           float* __restrict__ yout, float* __restrict__ sout,
                           int* __restrict__ chosen_out,
                           float* __restrict__ scratch,
                           int k, int s, int n_const, int n_carry,
                           int f_width, int lanes, int n_res) {
  cg::cluster_group cl = cg::this_cluster();
  const int ncta = (int)cl.num_blocks();
  const size_t b = blockIdx.x / ncta;
  const size_t npad = (size_t)s * LANES;
  fused_steps_body(cst + b * n_const * npad, yin + b * n_carry * npad,
                   sin_ + 4 * b, itab + b * TABLE_INT_WIDTH, ft + b * f_width,
                   yout + b * n_carry * npad, sout + 4 * b,
                   chosen_out + b * k, scratch + b * SCRATCH_PLANES * npad, k,
                   s, n_const, n_carry, ncta, (int)cl.block_rank(), lanes,
                   n_res);
}

// ---- host side: configure, check the card can schedule, launch ----------

static cudaLaunchConfig_t launch_config(int grid, int ncta, int threads,
                                        int smem, void* stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of ncta CTAs the card can hold at once for this launch shape:
// >= 1 when it can schedule one, 0 when it cannot, -error on a CUDA error.
static int active_clusters(const void* fn, int ncta, int threads, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(ncta, ncta, threads, smem, 0, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();  // the query's error is reported by the return value
    return -(int)e;
  }
  return n;
}

// Clusters of ncta CTAs that both entries can hold on the card at once at
// this block size and dynamic shared memory: 0 if none, -error on failure.
extern "C" int fused_steps_active_clusters(int ncta, int threads, int smem) {
  const int a = active_clusters((const void*)fused_steps_kernel, ncta,
                                threads, smem);
  if (a <= 0) return a;
  const int b = active_clusters((const void*)fused_steps_batched_kernel, ncta,
                                threads, smem);
  return b < a ? b : a;
}

// Static shared memory of the larger entry, in bytes (-error on failure).
extern "C" int fused_steps_static_smem() {
  cudaFuncAttributes a1, a2;
  cudaError_t e = cudaFuncGetAttributes(&a1, (const void*)fused_steps_kernel);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a2, (const void*)fused_steps_batched_kernel);
  if (e != cudaSuccess) return -(int)e;
  return (int)(a1.sharedSizeBytes > a2.sharedSizeBytes ? a1.sharedSizeBytes
                                                       : a2.sharedSizeBytes);
}

// Returns 0, a CUDA error code, or CLUSTER_UNSCHEDULABLE.
extern "C" int fused_steps_launch(const float* cst, const float* yin,
                                  const float* sin_, const int* itab,
                                  const float* ftab, float* yout, float* sout,
                                  int* chosen, float* scratch, int k, int s,
                                  int n_const, int n_carry, int ncta,
                                  int threads, int lanes, int n_res, int smem,
                                  void* stream) {
  const int fit = active_clusters((const void*)fused_steps_kernel, ncta,
                                  threads, smem);
  if (fit < 0) return -fit;
  if (fit == 0) return CLUSTER_UNSCHEDULABLE;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(ncta, ncta, threads, smem, stream, attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, fused_steps_kernel, cst, yin, sin_,
                                     itab, ftab, yout, sout, chosen, scratch,
                                     k, s, n_const, n_carry, lanes, n_res);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int fused_steps_batched_launch(const float* cst, const float* yin,
                                          const float* sin_, const int* itab,
                                          const float* ftab, float* yout,
                                          float* sout, int* chosen,
                                          float* scratch, int b, int k, int s,
                                          int n_const, int n_carry,
                                          int f_width, int ncta, int threads,
                                          int lanes, int n_res, int smem,
                                          void* stream) {
  const int fit = active_clusters((const void*)fused_steps_batched_kernel,
                                  ncta, threads, smem);
  if (fit < 0) return -fit;
  if (fit == 0) return CLUSTER_UNSCHEDULABLE;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(b * ncta, ncta, threads, smem, stream,
                                         attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, fused_steps_batched_kernel, cst,
                                     yin, sin_, itab, ftab, yout, sout, chosen,
                                     scratch, k, s, n_const, n_carry, f_width,
                                     lanes, n_res);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
