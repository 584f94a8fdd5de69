// K fused greedy placement steps of one pod template, on one thread block;
// and the batched entry that runs one block per template of a group.
//
// fused_steps_kernel replaces the JAX package's Pallas TPU kernel
// cluster_capacity_tpu/engine/fused.py `_build_kernel` (pallas_call in
// `_compiled_call`).  fused_steps_batched_kernel replaces the batched one,
// cluster_capacity_tpu/engine/fused_batched.py `_build_batched_kernel`
// (pallas_call in `_compiled_batched_call`, grid=(B,), per-template numbers
// from an SMEM scalar table).  Both compute the same function bit for bit in
// float32: the same planes in the same [P, S, 128] layout, the same scalars
// block (placed_count, stopped, next_start, aff_total) and `chosen` (-1
// after the stop).  Per-template numbers that the single TPU kernel compiles
// in as literals are read here from an int32 and a float32 table (layout
// generated from engine/fused.py INT_FIELDS / FLOAT_FIELDS into
// fused_layout.h), so one build serves every problem; the batched entry
// gives each block its own table row.  The TPU batched kernel's group-wide
// soft-spread domain loop (to max_dnh) counts the same domains as the
// per-row ss_dnh bound here: a row's domain ids are all below its own count.
//
// What bounds it on the card.  Per step it reads each const and carry plane
// of the problem once (the 10,000-node bench `scan` cell: 10 const + 8 carry
// planes of 40 KB, about 0.7 MB, all L2-resident) and writes back the few
// carry planes the placement touches, so the bytes bound is about 0.2 us a
// step at 3.35 TB/s.  The real bound is latency: each thread walks its
// nodes one after another through a chain of dependent L2 loads, and every
// step is a chain of block-wide reductions (hard-spread minima,
// any-feasible, the score normalisers, the sampling binary search, the
// argmax) separated by __syncthreads, about 5 for the scan cell and
// 5 + ceil(log2 N) + 1 with sampling; the next step depends on this step's
// argmax.  The batched entry does the same per block: the bench sweep group
// (10,000 nodes, one hard zone spread) moves about 0.7 MB and runs 4
// block-wide reductions per template per step.
//
// Why one block per template.  The steps of one template are strictly
// sequential (each argmax feeds the next step's carry), and a grid-wide
// barrier per reduction would cost far more than the block barrier.  A
// block of 1024 threads walks the node axis with a stride, each thread
// owning the same nodes for the whole run, so per-node state needs no
// synchronisation and only the reductions do.  Independent templates are
// independent blocks: the batched entry is the same body with gridDim.x = B,
// every pointer offset by the block's own slab, table row, `chosen` row and
// 4-plane scratch.  At 64 registers a thread, one 1024-thread block fills an
// SM's 65,536-register file, so at most one block runs per SM: a group of
// B <= 132 templates runs in one wave on an H100, B = 256 in two.
//
// Exactness.  Built with -fmad=false (no a*b+c contraction: the fit
// `acc + per*w` left fold and the spread `cnt*tp + (skew-1)` round after
// each operation, as the JAX step's separate ops do), IEEE division and sqrtf (-prec-div,
// -prec-sqrt, no fast math), rintf for jnp.round (half to even), truncf for
// jnp.trunc, floorf(a / fmaxf(b, 1e-30f)) for _floor_div, and the log of the
// spread's topology size read from the float32 log table.  Argmax ties go to
// the lowest real node index; padded lanes never win.

#include <cuda_runtime.h>
#include <math.h>

#include "fused_layout.h"

#define BIGF 2147483647.0f
#define OP_MAX 0
#define OP_MIN 1
#define OP_SUM 2
#define MAX_WARPS 32

__device__ __forceinline__ float combine(int op, float a, float b) {
  if (op == OP_MAX) return fmaxf(a, b);
  if (op == OP_MIN) return fminf(a, b);
  return a + b;
}

// Block-wide reduction of NV values at once; every thread gets the results.
// Sums are only taken over 0/1 counts, which are exact in any order.
template <int NV>
__device__ void block_reduce(float (&v)[NV], const int (&ops)[NV],
                             float* stage) {
  for (int off = 16; off > 0; off >>= 1)
    for (int q = 0; q < NV; ++q)
      v[q] = combine(ops[q], v[q], __shfl_xor_sync(0xffffffffu, v[q], off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0)
    for (int q = 0; q < NV; ++q) stage[q * MAX_WARPS + warp] = v[q];
  __syncthreads();
  const int nw = blockDim.x >> 5;
  for (int q = 0; q < NV; ++q) {
    float r = stage[q * MAX_WARPS];
    for (int w = 1; w < nw; ++w) r = combine(ops[q], r, stage[q * MAX_WARPS + w]);
    v[q] = r;
  }
  __syncthreads();
}

// Argmax with the lowest index winning ties; padded lanes carry indices
// >= n so that a real lane always beats them at equal value.
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
}

__device__ void block_argmax(float& v, int& idx, float* fstage, int* istage) {
  for (int off = 16; off > 0; off >>= 1) {
    float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    int i2 = __shfl_xor_sync(0xffffffffu, idx, off);
    better(v, idx, v2, i2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { fstage[warp] = v; istage[warp] = idx; }
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = fstage[0];
  idx = istage[0];
  for (int w = 1; w < nw; ++w) better(v, idx, fstage[w], istage[w]);
  __syncthreads();
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

// The K steps of one template, run by one whole block on its own operands.
__device__ __forceinline__ void
fused_steps_body(const float* __restrict__ cst,
                 const float* __restrict__ yin,
                 const float* __restrict__ sin_,
                 const int* __restrict__ itab,
                 const float* __restrict__ ft,
                 float* __restrict__ yout, float* __restrict__ sout,
                 int* __restrict__ chosen_out, float* __restrict__ scratch,
                 int k, int s, int n_carry) {
  __shared__ int T[TABLE_INT_WIDTH];
  __shared__ float stage[8 * MAX_WARPS];
  __shared__ int istage[MAX_WARPS];
  __shared__ unsigned dmask[MAX_SPREAD];
  __shared__ float sc[4];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int npad = s * LANES;
  for (int i = tid; i < TABLE_INT_WIDTH; i += nt) T[i] = itab[i];
  for (int i = tid; i < n_carry * npad; i += nt) yout[i] = yin[i];
  if (tid < 4) sc[tid] = sin_[tid];
  __syncthreads();

#define CP(p) (cst + (size_t)(p) * npad)
#define YP(p) (yout + (size_t)(p) * npad)
  const int n = T[IT_N];
  const int ch = T[IT_CH], cs = T[IT_CS], g = T[IT_G];
  const int w_fit = T[IT_W_FIT], w_bal = T[IT_W_BAL], w_taint = T[IT_W_TAINT];
  const int w_na = T[IT_W_NA], w_il = T[IT_W_IL], w_spread = T[IT_W_SPREAD];
  const int w_ipa = T[IT_W_IPA];
  float* feas = scratch;
  float* scor_buf = scratch + npad;
  float* sraw = scratch + 2 * (size_t)npad;
  float* iraw = scratch + 3 * (size_t)npad;
  const float NINF = -INFINITY, PINF = INFINITY;

  for (int step = 0; step < k; ++step) {
    const float placed_count = sc[0], stopped = sc[1];
    const float next_start = sc[2], aff_total = sc[3];
    if (stopped > 0.5f) {
      // a stopped step changes nothing (place = false, next_start kept)
      if (tid == 0) chosen_out[step] = -1;
      continue;
    }
    if (tid < MAX_SPREAD) dmask[tid] = 0u;

    // ---- hard spread: min match count over countable nodes -------------
    float mm[MAX_SPREAD] = {0.f, 0.f, 0.f, 0.f};
    if (ch > 0) {
      float v[MAX_SPREAD] = {BIGF, BIGF, BIGF, BIGF};
      const int ops[MAX_SPREAD] = {OP_MIN, OP_MIN, OP_MIN, OP_MIN};
      for (int i = tid; i < npad; i += nt)
        for (int c = 0; c < ch; ++c)
          v[c] = fminf(v[c], CP(T[IT_C_SH_COUNTABLE + c])[i] > 0.5f
                                 ? YP(T[IT_Y_SH_CNT + c])[i] : BIGF);
      block_reduce<MAX_SPREAD>(v, ops, stage);
      for (int c = 0; c < ch; ++c) mm[c] = T[IT_SH_MINZERO + c] ? 0.f : v[c];
    }

    // ---- feasibility ---------------------------------------------------
    int any_local = 0;
    for (int i = tid; i < npad; i += nt) {
      bool f = CP(T[IT_C_STATIC_MASK])[i] > 0.5f;
      if (T[IT_FIT_FILTER_ON]) {
        bool ok = !(YP(T[IT_Y_REQUESTED + IDX_PODS])[i] + 1.0f >
                    CP(T[IT_C_ALLOC + IDX_PODS])[i]);
        for (int j = 0; j < T[IT_R]; ++j) {
          if (j == IDX_PODS) continue;
          const float rv = ft[FT_REQ_VEC + j], shr = ft[FT_SHARED_REQ_VEC + j];
          const float free_ = CP(T[IT_C_ALLOC + j])[i] - YP(T[IT_Y_REQUESTED + j])[i];
          if (T[IT_DRA_SHARED_COLOCATE] && shr != 0.f) {
            const float rvj = rv + (placed_count == 0.f ? shr : 0.f);
            ok = ok && !(rvj > free_);
          } else if (rv > 0.f) {
            ok = ok && !(rv > free_);
          }
        }
        f = f && ok;
      }
      const float placed = YP(T[IT_Y_PLACED])[i];
      if (T[IT_CLONE_HAS_PORTS]) f = f && !(placed > 0.f);
      if (T[IT_VOLUME_FILTER_ON]) f = f && CP(T[IT_C_VOLUME_MASK])[i] > 0.5f;
      if (T[IT_VOLUME_SELF_CONFLICT]) f = f && !(placed > 0.f);
      if (T[IT_RWOP_SELF_CONFLICT]) f = f && placed_count == 0.f;
      if (T[IT_DRA_SHARED_COLOCATE]) f = f && (placed > 0.f || placed_count == 0.f);
      if (ch > 0) {
        bool violated = false;
        for (int c = 0; c < ch; ++c) {
          const float cnt = YP(T[IT_Y_SH_CNT + c])[i];
          const float skew = (cnt + (T[IT_SH_SELF + c] ? 1.0f : 0.0f)) - mm[c];
          const bool has_key = CP(T[IT_C_SH_DOM + c])[i] >= 0.f;
          violated = violated || (skew > ft[FT_SH_SKEW + c] && has_key);
        }
        f = f && !(CP(T[IT_C_SH_MISSING])[i] > 0.5f || violated);
      }
      if (T[IT_IPA_FILTER_ON]) {
        bool aff_ok = true;
        if (T[IT_IPA_AFF_ON]) {
          bool pods_exist = true, all_keys = true;
          for (int q = 0; q < g; ++q) {
            if (!T[IT_GHAS_AFF + q]) continue;
            const bool has_key = CP(T[IT_C_IPA_DOM + q])[i] >= 0.f;
            const float tot = CP(T[IT_C_IPA_AFF_SCNT + q])[i] + YP(T[IT_Y_AFF_CNT + q])[i];
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
            const bool has_key = CP(T[IT_C_IPA_DOM + q])[i] >= 0.f;
            const float dyn = YP(T[IT_Y_ANTI_CNT + q])[i];
            anti_fail = anti_fail || (has_key && CP(T[IT_C_IPA_ANTI_SCNT + q])[i] + dyn > 0.f);
            eanti_dyn = eanti_dyn || (has_key && dyn > 0.f);
          }
        }
        const bool eanti_fail = CP(T[IT_C_IPA_EANTI_STATIC])[i] > 0.5f || eanti_dyn;
        f = f && aff_ok && !anti_fail && !eanti_fail;
      }
      feas[i] = f ? 1.f : 0.f;
      any_local |= f;
    }
    const bool any_feasible = __syncthreads_or(any_local) != 0;

    // ---- sampling (numFeasibleNodesToFind emulation) -------------------
    float new_next_start = next_start;
    const float* scor = feas;
    const int sample_k = T[IT_SAMPLE_K];
    if (sample_k > 0) {
      const int start = (int)next_start;
      int lo = 0, hi = n - 1;
      for (int it = 0; it < T[IT_BS_ITERS]; ++it) {
        const int mid = (lo + hi) >> 1;
        float v[1] = {0.f};
        const int ops[1] = {OP_SUM};
        for (int i = tid; i < npad; i += nt) {
          const int rank = i < n ? pmod(i - start, n) : n;
          if (feas[i] > 0.5f && rank <= mid) v[0] += 1.f;
        }
        block_reduce<1>(v, ops, stage);
        if ((int)v[0] >= sample_k) hi = mid; else lo = mid + 1;
      }
      for (int i = tid; i < npad; i += nt) {
        const int rank = i < n ? pmod(i - start, n) : n;
        scor_buf[i] = (feas[i] > 0.5f && rank <= hi) ? 1.f : 0.f;
      }
      scor = scor_buf;
      new_next_start = (float)pmod(start + (hi + 1), n);
    }

    if (!any_feasible) {
      if (tid == 0) {
        chosen_out[step] = -1;
        sc[1] = 1.f;
        sc[2] = new_next_start;
      }
      __syncthreads();
      continue;
    }

    // ---- reductions the score normalisers need -------------------------
    float tmax = 0.f, nmax = 0.f, host_size = 0.f, imax = NINF, imin = PINF;
    if (w_taint || w_na || w_spread || w_ipa) {
      float v[5] = {NINF, NINF, 0.f, NINF, PINF};
      const int ops[5] = {OP_MAX, OP_MAX, OP_SUM, OP_MAX, OP_MIN};
      unsigned lmask[MAX_SPREAD] = {0u, 0u, 0u, 0u};
      for (int i = tid; i < npad; i += nt) {
        const bool sc_ = scor[i] > 0.5f;
        if (w_taint) v[0] = fmaxf(v[0], sc_ ? CP(T[IT_C_TAINT_RAW])[i] : 0.f);
        if (w_na) v[1] = fmaxf(v[1], sc_ ? CP(T[IT_C_NA_RAW])[i] : 0.f);
        if (w_spread && sc_ && !(CP(T[IT_C_SS_IGNORED])[i] > 0.5f)) {
          v[2] += 1.f;
          for (int c = 0; c < cs; ++c) {
            if (T[IT_SS_HOST + c]) continue;
            const float d = CP(T[IT_C_SS_DOM + c])[i];
            if (d >= 0.f && d < (float)T[IT_SS_DNH + c]) lmask[c] |= 1u << (int)d;
          }
        }
        if (w_ipa) {
          float raw = CP(T[IT_C_IPA_STATIC_PREF])[i];
          if (T[IT_IPA_PREF_ON])
            for (int q = 0; q < g; ++q)
              raw = raw + (CP(T[IT_C_IPA_DOM + q])[i] >= 0.f ? YP(T[IT_Y_PREF_CNT + q])[i] : 0.f);
          iraw[i] = raw;
          if (sc_) { v[3] = fmaxf(v[3], raw); v[4] = fminf(v[4], raw); }
        }
      }
      for (int c = 0; c < cs; ++c)
        if (lmask[c]) atomicOr(&dmask[c], lmask[c]);
      block_reduce<5>(v, ops, stage);
      tmax = v[0]; nmax = v[1]; host_size = v[2]; imax = v[3]; imin = v[4];
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
      for (int i = tid; i < npad; i += nt) {
        float raw = 0.f;
        for (int c = 0; c < cs; ++c) {
          const float dom = CP(T[IT_C_SS_DOM + c])[i];
          float term = 0.f;
          if (dom >= 0.f) {
            float cnt;
            if (T[IT_SS_HOST + c]) {
              cnt = CP(T[IT_C_SS_EXISTING + c])[i];
              if (T[IT_SS_SELF + c]) cnt = cnt + YP(T[IT_Y_PLACED])[i];
            } else {
              cnt = YP(T[IT_Y_SS_CNT + c])[i];
            }
            term = __fadd_rn(__fmul_rn(cnt, tp[c]), ft[FT_SS_SKEW_M1 + c]);
          }
          raw = raw + term;
        }
        raw = rintf(raw);
        sraw[i] = raw;
        if (scor[i] > 0.5f && !(CP(T[IT_C_SS_IGNORED])[i] > 0.5f)) {
          v[0] = fmaxf(v[0], raw);
          v[1] = fminf(v[1], raw);
        }
      }
      block_reduce<2>(v, ops, stage);
      if (host_size > 0.f) { smax = v[0]; smin = v[1]; }
    }

    // ---- total score and host selection --------------------------------
    float best = NINF;
    int best_i = 0x7fffffff;
    for (int i = tid; i < npad; i += nt) {
      const bool sc_ = scor[i] > 0.5f;
      float total = 0.f;
      if (w_fit) {
        float acc = 0.f, wsum = 0.f;
        const int strat = T[IT_FIT_STRATEGY];
        for (int k2 = 0; k2 < T[IT_N_FIT]; ++k2) {
          const int j = T[IT_FIT_IDX + k2];
          const float alloc = CP(T[IT_C_ALLOC + j])[i];
          float req = T[IT_FIT_NZ + k2]
                          ? YP(j == IDX_CPU ? T[IT_Y_NONZERO0] : T[IT_Y_NONZERO1])[i]
                          : YP(T[IT_Y_REQUESTED + j])[i];
          req = req + ft[FT_FIT_REQ + k2];
          float per;
          if (strat == FIT_MOST) {
            per = alloc > 0.f ? floorf((fminf(req, alloc) * 100.0f) / fmaxf(alloc, 1e-30f)) : 0.f;
          } else if (strat == FIT_RTC) {
            const float util = alloc > 0.f ? floorf((req * 100.0f) / fmaxf(alloc, 1e-30f)) : 0.f;
            per = truncf(piecewise(util, ft, T[IT_N_SEG]));
            per = alloc > 0.f ? per : 0.f;
          } else {
            per = req > alloc ? 0.f : floorf(((alloc - req) * 100.0f) / fmaxf(alloc, 1e-30f));
            per = alloc > 0.f ? per : 0.f;
          }
          const float w = ft[FT_FIT_W + k2];
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
          const float alloc = CP(T[IT_C_ALLOC + j])[i];
          const float req = YP(T[IT_Y_REQUESTED + j])[i] + ft[FT_BAL_REQ + k2];
          const bool valid = alloc > 0.f;
          count = count + (valid ? 1.f : 0.f);
          fsum = fsum + (valid ? fminf(req / fmaxf(alloc, 1e-30f), 1.0f) : 0.f);
        }
        const float mean = fsum / fmaxf(count, 1.0f);
        float vsum = 0.f;
        for (int k2 = 0; k2 < nb; ++k2) {
          const int j = T[IT_BAL_IDX + k2];
          const float alloc = CP(T[IT_C_ALLOC + j])[i];
          const float req = YP(T[IT_Y_REQUESTED + j])[i] + ft[FT_BAL_REQ + k2];
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
        const float raw = CP(T[IT_C_TAINT_RAW])[i];
        float scaled = tmax > 0.f ? floorf((100.0f * raw) / tmax) : raw;
        scaled = tmax > 0.f ? 100.0f - scaled : 100.0f;
        total = total + (float)w_taint * (sc_ ? scaled : 0.f);
      }
      if (w_na) {
        const float raw = CP(T[IT_C_NA_RAW])[i];
        const float scaled = nmax > 0.f ? floorf((100.0f * raw) / nmax) : raw;
        total = total + (float)w_na * (sc_ ? scaled : 0.f);
      }
      if (w_il) total = total + (float)w_il * (sc_ ? CP(T[IT_C_IL_SCORE])[i] : 0.f);
      if (w_spread) {
        const bool ssc = sc_ && !(CP(T[IT_C_SS_IGNORED])[i] > 0.5f);
        const float out = smax == 0.f
            ? 100.0f
            : floorf((100.0f * ((smax + smin) - sraw[i])) / fmaxf(smax, 1e-30f));
        total = total + (float)w_spread * (ssc ? out : 0.f);
      }
      if (w_ipa) {
        const float diff = imax - imin;
        const float norm = diff > 0.f ? floorf((100.0f * (iraw[i] - imin)) / diff) : 0.f;
        total = total + (float)w_ipa * (sc_ ? norm : 0.f);
      }
      const float keyed = sc_ ? total : -1.0f;
      better(best, best_i, keyed, i < n ? i : n + i);
    }
    block_argmax(best, best_i, stage, istage);
    const int chosen = best_i < n ? best_i : 0;

    // ---- commit (place is true here) -----------------------------------
    float sh_dom_ch[MAX_SPREAD], sh_inc[MAX_SPREAD];
    for (int c = 0; c < ch; ++c) {
      sh_dom_ch[c] = CP(T[IT_C_SH_DOM + c])[chosen];
      sh_inc[c] = CP(T[IT_C_SH_COUNTABLE + c])[chosen] * 1.0f;
    }
    float ss_dom_ch[MAX_SPREAD], ss_inc[MAX_SPREAD];
    for (int c = 0; c < cs; ++c) {
      ss_dom_ch[c] = CP(T[IT_C_SS_DOM + c])[chosen];
      ss_inc[c] = CP(T[IT_C_SS_COUNTABLE + c])[chosen] * 1.0f;
    }
    const bool ipa_commit = T[IT_IPA_AFF_ON] || T[IT_IPA_ANTI_ON] || T[IT_IPA_PREF_ON];
    float ipa_dom_ch[MAX_GROUPS], ipa_valid[MAX_GROUPS];
    float new_aff_total = aff_total;
    if (ipa_commit) {
      for (int q = 0; q < g; ++q) {
        ipa_dom_ch[q] = CP(T[IT_C_IPA_DOM + q])[chosen];
        ipa_valid[q] = ipa_dom_ch[q] >= 0.f ? 1.f : 0.f;
        if (T[IT_IPA_AFF_ON] && ft[FT_AFF_GINC + q] != 0.f)
          new_aff_total = new_aff_total + (ft[FT_AFF_GINC + q] * ipa_valid[q]) * 1.0f;
      }
    }
    for (int i = tid; i < npad; i += nt) {
      if (i == chosen) {
        for (int j = 0; j < T[IT_R]; ++j) {
          const float rv = ft[FT_REQ_VEC + j], shr = ft[FT_SHARED_REQ_VEC + j];
          float* y = YP(T[IT_Y_REQUESTED + j]);
          if (T[IT_DRA_SHARED_COLOCATE] && shr != 0.f)
            y[i] = y[i] + (rv + (placed_count == 0.f ? shr : 0.f));
          else if (rv != 0.f)
            y[i] = y[i] + rv;
        }
        if (ft[FT_REQ_NONZERO] != 0.f)
          YP(T[IT_Y_NONZERO0])[i] = YP(T[IT_Y_NONZERO0])[i] + ft[FT_REQ_NONZERO];
        if (ft[FT_REQ_NONZERO + 1] != 0.f)
          YP(T[IT_Y_NONZERO1])[i] = YP(T[IT_Y_NONZERO1])[i] + ft[FT_REQ_NONZERO + 1];
        YP(T[IT_Y_PLACED])[i] = YP(T[IT_Y_PLACED])[i] + 1.0f;
      }
      for (int c = 0; c < ch; ++c) {
        if (!T[IT_SH_SELF + c]) continue;
        const float dom = CP(T[IT_C_SH_DOM + c])[i];
        if (dom == sh_dom_ch[c] && dom >= 0.f) {
          float* y = YP(T[IT_Y_SH_CNT + c]);
          y[i] = y[i] + sh_inc[c];
        }
      }
      for (int c = 0; c < cs; ++c) {
        if (!T[IT_SS_SELF + c]) continue;
        const float dom = CP(T[IT_C_SS_DOM + c])[i];
        if (dom == ss_dom_ch[c] && dom >= 0.f) {
          float* y = YP(T[IT_Y_SS_CNT + c]);
          y[i] = y[i] + ss_inc[c];
        }
      }
      if (ipa_commit) {
        for (int q = 0; q < g; ++q) {
          const float dom = CP(T[IT_C_IPA_DOM + q])[i];
          if (!(dom == ipa_dom_ch[q] && dom >= 0.f)) continue;
          if (T[IT_IPA_AFF_ON] && ft[FT_AFF_GINC + q] != 0.f) {
            float* y = YP(T[IT_Y_AFF_CNT + q]);
            y[i] = y[i] + (ft[FT_AFF_GINC + q] * ipa_valid[q]) * 1.0f;
          }
          if (T[IT_IPA_ANTI_ON] && ft[FT_ANTI_GINC + q] != 0.f) {
            float* y = YP(T[IT_Y_ANTI_CNT + q]);
            y[i] = y[i] + (ft[FT_ANTI_GINC + q] * ipa_valid[q]) * 1.0f;
          }
          if (T[IT_IPA_PREF_ON] && ft[FT_PREF_GW + q] != 0.f) {
            float* y = YP(T[IT_Y_PREF_CNT + q]);
            y[i] = y[i] + (ft[FT_PREF_GW + q] * ipa_valid[q]) * 1.0f;
          }
        }
      }
    }
    if (tid == 0) {
      chosen_out[step] = chosen;
      sc[0] = placed_count + 1.0f;
      sc[2] = new_next_start;
      sc[3] = new_aff_total;
    }
    __syncthreads();
  }
  if (tid < 4) sout[tid] = sc[tid];
#undef CP
#undef YP
}

extern "C" __global__ void __launch_bounds__(1024)
fused_steps_kernel(const float* __restrict__ cst,
                   const float* __restrict__ yin,
                   const float* __restrict__ sin_,
                   const int* __restrict__ itab,
                   const float* __restrict__ ft,
                   float* __restrict__ yout, float* __restrict__ sout,
                   int* __restrict__ chosen_out, float* __restrict__ scratch,
                   int k, int s, int n_carry) {
  fused_steps_body(cst, yin, sin_, itab, ft, yout, sout, chosen_out, scratch,
                   k, s, n_carry);
}

// Block b runs template b: const [B, n_const, S, 128], carry [B, n_carry, S,
// 128], scalars [B, 4], int table [B, TABLE_INT_WIDTH], float table [B,
// f_width], chosen [B, k], scratch [B, 4, S * 128].
extern "C" __global__ void __launch_bounds__(1024)
fused_steps_batched_kernel(const float* __restrict__ cst,
                           const float* __restrict__ yin,
                           const float* __restrict__ sin_,
                           const int* __restrict__ itab,
                           const float* __restrict__ ft,
                           float* __restrict__ yout, float* __restrict__ sout,
                           int* __restrict__ chosen_out,
                           float* __restrict__ scratch,
                           int k, int s, int n_const, int n_carry,
                           int f_width) {
  const size_t b = blockIdx.x;
  const size_t npad = (size_t)s * LANES;
  fused_steps_body(cst + b * n_const * npad, yin + b * n_carry * npad,
                   sin_ + 4 * b, itab + b * TABLE_INT_WIDTH, ft + b * f_width,
                   yout + b * n_carry * npad, sout + 4 * b,
                   chosen_out + b * k, scratch + b * 4 * npad, k, s, n_carry);
}

extern "C" int fused_steps_launch(const float* cst, const float* yin,
                                  const float* sin_, const int* itab,
                                  const float* ftab, float* yout, float* sout,
                                  int* chosen, float* scratch, int k, int s,
                                  int n_carry, int threads, void* stream) {
  fused_steps_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      cst, yin, sin_, itab, ftab, yout, sout, chosen, scratch, k, s, n_carry);
  return (int)cudaGetLastError();
}

extern "C" int fused_steps_batched_launch(const float* cst, const float* yin,
                                          const float* sin_, const int* itab,
                                          const float* ftab, float* yout,
                                          float* sout, int* chosen,
                                          float* scratch, int b, int k, int s,
                                          int n_const, int n_carry,
                                          int f_width, int threads,
                                          void* stream) {
  fused_steps_batched_kernel<<<b, threads, 0, (cudaStream_t)stream>>>(
      cst, yin, sin_, itab, ftab, yout, sout, chosen, scratch, k, s, n_const,
      n_carry, f_width);
  return (int)cudaGetLastError();
}
