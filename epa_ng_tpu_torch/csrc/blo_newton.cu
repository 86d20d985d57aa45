// Thorough-placement Newton branch-length optimisation for DNA (K = 4) and
// protein (K = 20) models, single-matrix and matrix-mixture, on Hopper
// (sm_90a): the pplacer smoothing loop of the trilinear eigenbasis form,
// one warp per (query, edge) pair.
//
// Replaces (epa_ng_tpu/ops/pallas_blo.py):
//   _blo_kernel_blocked       (K1, the fused step's and the exact path's)
//   _blo_kernel               (K3, the per-pair-window variant)
//   _blo_kernel_blocked_pinv  (K2, K1 with the +I invariant-site term)
//   _blo_kernel_pinv          (K4, K3 with the +I invariant-site term)
//   _blo_kernel_counted       (K5, K3 counting its Newton trips)
// and their shared body _blo_compute. The TPU kernels compute the same
// per-pair function and differ only in how a 128-pair block's site window
// reaches VMEM; here every pair reads its OWN window [begin, begin+span)
// of the full site-last stores tU/tV [E, RK, S] and tQ [Q, K, S] (a
// mixture's per-category [Q, RK, S]) by edge and query id, so the TPU
// path's row gather tU[e_ids] and its
// [NP,RK,S] -> [RK,S,NP] relayout disappear. +I (HAS_PINV) is a template
// flag; the K5 counters are a null-or-not output pointer.
//
// Per pair (cf. _blo_compute):
//   T1 = contract(wA-back-transform(tU e^{x lp}), A-back-transform(tV e^{x ld}))
//        * tQ                                      (piA factorisation)
//   repeat <= max_smoothings times, while |dlogl| >= 0.1 and not worse:
//     pendant Newton on T1 (<= 30 iterations, slide/snap, flat-region stops)
//     T2 = contract(wA-bt(tU e^{x lprox}), A-bt(tQ e^{x lpend})) * tV
//     distal Newton on T2
//     T1 = T at the new lengths; rescore; roll back if worse
// With +I every site likelihood is g = omp * f + pv (omp = 1 - pinv,
// pv = exp(invq[q, s] - ls[e, s]) the linear invariant term in the CLVs'
// scaled space), and the Newton derivatives carry the omp factor.
//
// What bounds it on this card: operations, not bytes. Each pair reads its
// windows (2*RK + K floats per site, 144 B at RK = 16; +8 B for invq and
// ls with +I) and then runs ~80 FMA-class operations per site per Newton
// iteration and ~440 per sumtable build, for ~5-15 Newton iterations per
// solve and 2-4 smoothings. At K = 20 the build grows with K^2 (~2400
// operations per site and rate against ~100) and the bound stays
// operations. The working set that must stay on chip is T, RK floats per
// site (64 KB for a 1024-site window at RK = 16, 80 KB for 256 sites at
// RK = 80; one more row, pv, with +I), not the TPU's ~five [RK, W, 128]
// tile sets (1 MB each at W = 128, RK = 16), which do not fit the 227 KB
// of shared memory a block may use.
//
// Design against that bound:
//   * one warp per pair: lanes stride over the window's sites, d1/d2 and
//     the score are reduced with an xor-butterfly of shuffles, which
//     leaves the bit-identical sum in every lane, so the whole warp takes
//     the same Newton/smoothing branches with no barrier at all;
//   * T lives in shared memory, [RK (+1)][width] floats per warp, reused
//     for T1 and T2 (T1 is dead once the pendant solve is done); each lane
//     only touches its own sites, so T needs no synchronisation either;
//     the +I row pv is filled once per pair and read by every score and
//     Newton iteration (the TPU path materialises an [NP, S] pinv_lin
//     tensor instead);
//   * tU/tV/tQ are re-read from device memory (L2) at each sumtable build,
//     coalesced along sites (the stores are site-last);
//   * the exponential scale factors e^{x_j t} are per-pair scalars computed
//     redundantly by every lane; the zero-eigenvalue lanes j == K-1 (mod K)
//     (ops/eigen.py snaps that eigenvalue to exactly 0) skip their exp and
//     their derivative terms, as _blo_compute does statically;
//   * every pair iterates on its own: a finished pair's warp takes the
//     next pair, no lock step across pairs (the TPU kernel freezes done
//     lanes instead). So the K5 counters are per pair: that pair's own
//     executed Newton iterations (both solves, all smoothings) and
//     smoothings, where the TPU kernel reports one count per 128-pair
//     block, the lock-step trips that the block's slowest lanes set.
// Windows too wide for shared memory ((RK (+1)) * width * 4 bytes of T per
// warp above ops/blo_kernel.py::max_shared_sites) keep T in a
// device-memory scratch instead, one slice per resident warp; the grid is
// then capped to the scratch's slices and each warp loops over pairs. The
// arithmetic is the same, so a window of any width runs the kernel.
//
// Built without --use_fast_math (tiny is FLT_MIN and the rollback test
// |new| * 1e-14 must stay as written) and with -fmad=false: the kernel
// then rounds every product and sum as its plain version
// (ops/blo_kernel.py::blo_newton_plain) does and agrees with it on every
// pair, so a fault that touches a few pairs still shows. On the main
// path's pairs, mul+add contraction saves about 4% of the kernel's time,
// and it parts from the plain version, in f32 and in f64 alike, by up to
// a few logl units on about one pair in two thousand, where f32 is
// borderline (``python3 chip_smoke.py --fmad-ab``; PERF.md).
//
// The source is compiled twice, with BLO_HAS_PINV 0 and 1, into two
// libraries that build in parallel; each holds the 16 DNA instantiations
// (rate count x sumtable home) of its flavour, and the K = 20 ones
// (WideCtx below: {single, mixture} x sumtable home without +I, single x
// home with it; the JAX package takes no +I with a mixture).

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#ifndef BLO_HAS_PINV
#define BLO_HAS_PINV 0
#endif

namespace {

constexpr int K = 4;
constexpr int WARP = 32;
constexpr int MAX_ITERS = 30;
constexpr float BRLEN_MIN = 1e-6f;
constexpr float BRLEN_MAX = 100.0f;
constexpr float BRLEN_DEFAULT = 0.1f;
constexpr float DEFAULT_PENDANT = 0.10536051565782628f;  // -log(0.9)
constexpr float OPT_BRANCH_EPSILON = 1e-1f;
constexpr float GAIN_EPSILON = 1e-2f;
constexpr float D1_EPSILON = 1e-4f;
// scalar tables at the head of shared memory: x_rk, wA, A, piA take
// RK + RK*K + 2*K*K = 20*R + 32 floats, 192 at the widest instantiation
// (R = 8); ops/blo_kernel.py::_TAB_BYTES must match
constexpr int MAX_R = 8;
constexpr int TAB_FLOATS = 192;
static_assert(20 * MAX_R + 2 * K * K <= TAB_FLOATS, "scalar tables");

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: lane i adds v_i + v_{i^m}, lane i^m adds v_{i^m} + v_i,
  // which is the same float, so every lane ends with the identical total
#pragma unroll
  for (int m = WARP / 2; m > 0; m >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, m);
  }
  return v;
}

template <int R, bool HAS_PINV>
struct PairCtx {
  static constexpr int RK = R * K;
  const float* __restrict__ tu;  // tU row block of this pair's edge [RK, S]
  const float* __restrict__ tv;
  const float* __restrict__ tq;  // tQ row block of this pair's query [K, S]
  const float* __restrict__ iq;  // invq row of this pair's query [S] (+I)
  const float* __restrict__ ls;  // ls row of this pair's edge [S] (+I)
  int S;
  int begin;
  int span;
  int width;                     // T row stride (>= span)
  int lane;
  float omp;                     // 1 - pinv (+I)
  float* T;                      // [RK (+1)][width], this warp's slice
  const float* xrk;              // [RK]      shared
  const float* wA;               // [RK][K]   shared
  const float* A;                // [K][K]    shared
  const float* piA;              // [K][K]    shared

  __device__ __forceinline__ void exps(float t, float* E) const {
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      E[j] = (j % K == K - 1) ? 1.0f : expf(xrk[j] * t);
    }
  }

  // h[i] = sum_k coef[i][k] * x[k] (sequential in k, as _blo_compute)
  __device__ __forceinline__ void back(const float* coef, const float* x,
                                       float* h) const {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float acc = coef[i * K] * x[0];
#pragma unroll
      for (int k = 1; k < K; ++k) acc += coef[i * K + k] * x[k];
      h[i] = acc;
    }
  }

  // T[r*K+k] = sum_i piA[i][k] * hA[i] * hB[i]
  __device__ __forceinline__ float contract(const float* hA, const float* hB,
                                            int k) const {
    float acc = piA[k] * (hA[0] * hB[0]);
#pragma unroll
    for (int i = 1; i < K; ++i) acc += piA[i * K + k] * (hA[i] * hB[i]);
    return acc;
  }

  // the +I row of T: pv = exp(invq - ls) over the pair's span, once per
  // pair (one exponential of the difference, as the JAX package's
  // parallel/mesh.py does; an invq of -inf gives 0). Never read beyond
  // the span, like every other row.
  __device__ void fill_pv() {
    for (int w = lane; w < span; w += WARP) {
      const int s = begin + w;
      T[RK * width + w] = expf(iq[s] - ls[s]);
    }
  }

  // the site likelihood from the eigen-sum f at window site w
  __device__ __forceinline__ float site_g(float f, int w) const {
    if constexpr (HAS_PINV) {
      return omp * f + T[RK * width + w];
    } else {
      return f;
    }
  }

  // pendant sumtable at edge lengths (lp, ld): T1 of _blo_compute.build_T
  __device__ void build_t1(float lp, float ld) {
    float EU[RK], EV[RK];
    exps(lp, EU);
    exps(ld, EV);
    for (int w = lane; w < span; w += WARP) {
      const int s = begin + w;
      float q[K];
#pragma unroll
      for (int k = 0; k < K; ++k) q[k] = tq[k * S + s];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float u[K], v[K], hU[K], hV[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = r * K + k;
          u[k] = tu[j * S + s];
          v[k] = tv[j * S + s];
          if (k != K - 1) {
            u[k] *= EU[j];
            v[k] *= EV[j];
          }
        }
        back(wA + r * K * K, u, hU);
        back(A, v, hV);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          T[(r * K + k) * width + w] = contract(hU, hV, k) * q[k];
        }
      }
    }
  }

  // distal sumtable: proximal CLV x pendant-scaled query tip, times tV
  __device__ void build_t2(float lprox, float lpend) {
    float EU[RK], EQ[RK];
    exps(lprox, EU);
    exps(lpend, EQ);
    for (int w = lane; w < span; w += WARP) {
      const int s = begin + w;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float u[K], q[K], hU[K], hQ[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = r * K + k;
          u[k] = tu[j * S + s];
          q[k] = tq[k * S + s];
          if (k != K - 1) {
            u[k] *= EU[j];
            q[k] *= EQ[j];
          }
        }
        back(wA + r * K * K, u, hU);
        back(A, q, hQ);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = r * K + k;
          T[j * width + w] = contract(hU, hQ, k) * tv[j * S + s];
        }
      }
    }
  }

  // masked log-likelihood (scaled space) from T at pendant length lq
  __device__ float score(float lq) const {
    float E[RK];
    exps(lq, E);
    float acc = 0.0f;
    for (int w = lane; w < span; w += WARP) {
      float f = 0.0f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float t = T[j * width + w];
        f += (j % K == K - 1) ? t : t * E[j];
      }
      acc += logf(fmaxf(site_g(f, w), FLT_MIN));
    }
    return warp_sum(acc);
  }

  // safeguarded Newton on dlogl/dt over T (see _blo_compute.newton);
  // adds the iterations it executes to ``iters``
  __device__ float newton(float xmin, float xmax, float xtol, float guess,
                          int& iters) const {
    float x = fminf(fmaxf(guess, xmin), xmax);
    float slid = 0.0f;
    bool done = false;
    for (int it = 0; it < MAX_ITERS && !done; ++it) {
      ++iters;
      float E[RK];
      exps(x, E);
      float d1p = 0.0f, d2p = 0.0f;
      for (int w = lane; w < span; w += WARP) {
        float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          const float t = T[j * width + w];
          if (j % K == K - 1) {
            f0 += t;  // zero-eigenvalue lane: x_j == 0 exactly
          } else {
            const float xj = xrk[j];
            const float tE = t * E[j];
            f0 += tE;
            f1 += tE * xj;
            f2 += tE * (xj * xj);
          }
        }
        // +I: g = omp f0 + pv, r1 = (omp f1) / g, f2 -> omp f2, in
        // _blo_compute's order of operations
        const float g = fmaxf(site_g(f0, w), FLT_MIN);
        const float inv_g = 1.0f / g;
        if constexpr (HAS_PINV) {
          f1 = omp * f1;
          f2 = omp * f2;
        }
        const float r1 = f1 * inv_g;
        d1p += r1;
        d2p += f2 * inv_g - r1 * r1;
      }
      const float d1 = warp_sum(d1p);
      const float d2 = warp_sum(d2p);
      const float newton_x = x - d1 / (d2 == 0.0f ? 1.0f : d2);
      const float dirn = d1 > 0.0f ? 1.0f : -1.0f;
      const bool snap = (d2 >= 0.0f) && (slid * dirn > 0.0f);
      const float bound = d1 > 0.0f ? xmax : xmin;
      const float slide =
          snap ? bound : (d1 > 0.0f ? (x + xmax) / 2.0f : (x + xmin) / 2.0f);
      const float xn =
          fminf(fmaxf(d2 < 0.0f ? newton_x : slide, xmin), xmax);
      slid = d2 < 0.0f ? 0.0f : dirn;
      done = (fabsf(xn - x) < xtol) || (fabsf(d1) <= D1_EPSILON) ||
             ((d2 < 0.0f) && (d1 * d1 <= GAIN_EPSILON * -d2));
      x = xn;
    }
    return x;
  }
};

// out: logl, pendant, distal, proximal, done; counts: smoothings, Newton
// iterations executed by this pair. Ctx is PairCtx (DNA) or WideCtx
// (K = 20).
template <bool HAS_PINV, class Ctx>
__device__ void solve_pair(const Ctx& c_in, float orig, int max_smoothings,
                           float* out, int* counts) {
  Ctx c = c_in;
  const float half = orig * 0.5f;
  const float dist_min = fminf(BRLEN_MIN / 2.0f, half);
  const float dist_tol = dist_min / 10.0f;
  const float dist_max = orig - dist_tol;

  if constexpr (HAS_PINV) c.fill_pv();
  float pendant = DEFAULT_PENDANT;
  float distal = half;
  float proximal = half;
  c.build_t1(half, half);
  float neg = -c.score(pendant);
  bool done = false;
  int smoothings = 0;
  int iters = 0;
  for (int it = 0; it < max_smoothings && !done; ++it) {
    ++smoothings;
    // --- pendant Newton on T1 (lp, ld fixed)
    const float guess =
        (pendant < BRLEN_MIN || pendant > BRLEN_MAX) ? BRLEN_DEFAULT : pendant;
    const float new_pendant =
        c.newton(BRLEN_MIN, BRLEN_MAX, BRLEN_MIN / 10.0f, guess, iters);
    // --- distal Newton on the role-swapped T2
    c.build_t2(proximal, new_pendant);
    const float guess2 =
        (distal < dist_min || distal > dist_max) ? half : distal;
    const float new_distal =
        c.newton(dist_min, dist_max, dist_tol, guess2, iters);
    const float new_proximal = orig - new_distal;
    // --- rescore; T at the accepted lengths is the next pendant sumtable
    c.build_t1(new_proximal, new_distal);
    const float new_neg = -c.score(new_pendant);
    const bool worse = (new_neg - neg) > fabsf(new_neg) * 1e-14f;
    const bool converged = fabsf(new_neg - neg) < OPT_BRANCH_EPSILON;
    if (!worse) {
      pendant = new_pendant;
      distal = new_distal;
      proximal = new_proximal;
      neg = new_neg;
    }
    done = worse || converged;
  }
  out[0] = -neg;
  out[1] = pendant;
  out[2] = distal;
  out[3] = proximal;
  out[4] = done ? 1.0f : 0.0f;
  counts[0] = smoothings;
  counts[1] = iters;
}

// GLOBAL_T: T in t_scratch (one [RK (+1)][width] slice per warp of the
// grid) rather than in shared memory
template <int R, bool GLOBAL_T, bool HAS_PINV>
__global__ void __launch_bounds__(128)
blo_newton_kernel(const float* __restrict__ tU, const float* __restrict__ tV,
                  const float* __restrict__ tQ, int S,
                  const float* __restrict__ invq,
                  const float* __restrict__ ls,
                  const float* __restrict__ omp,
                  const int* __restrict__ e_ids, const int* __restrict__ q_ids,
                  const int* __restrict__ begins,
                  const int* __restrict__ spans,
                  const float* __restrict__ orig_len,
                  const float* __restrict__ skip,
                  const float* __restrict__ x_rk,
                  const float* __restrict__ wA, const float* __restrict__ A,
                  const float* __restrict__ piA, int P, int width,
                  int max_smoothings, float* __restrict__ t_scratch,
                  float* __restrict__ out_logl,
                  float* __restrict__ out_pendant,
                  float* __restrict__ out_distal,
                  float* __restrict__ out_proximal,
                  float* __restrict__ out_done,
                  int* __restrict__ out_smoothings,
                  int* __restrict__ out_iters) {
  constexpr int RK = R * K;
  constexpr int ROWS = RK + (HAS_PINV ? 1 : 0);
  static_assert(R <= MAX_R, "rate categories");
  extern __shared__ float smem[];
  float* s_x = smem;                 // [RK]
  float* s_wA = s_x + RK;            // [RK * K]
  float* s_A = s_wA + RK * K;        // [K * K]
  float* s_piA = s_A + K * K;        // [K * K]
  for (int i = threadIdx.x; i < RK; i += blockDim.x) s_x[i] = x_rk[i];
  for (int i = threadIdx.x; i < RK * K; i += blockDim.x) s_wA[i] = wA[i];
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) {
    s_A[i] = A[i];
    s_piA[i] = piA[i];
  }
  __syncthreads();

  const int warps = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const size_t slot = static_cast<size_t>(blockIdx.x) * warps + warp;

  PairCtx<R, HAS_PINV> c;
  c.S = S;
  c.width = width;
  c.lane = lane;
  c.omp = HAS_PINV ? omp[0] : 1.0f;
  c.iq = nullptr;
  c.ls = nullptr;
  if constexpr (GLOBAL_T) {
    c.T = t_scratch + slot * ROWS * width;
  } else {
    c.T = smem + TAB_FLOATS + static_cast<size_t>(warp) * ROWS * width;
  }
  c.xrk = s_x;
  c.wA = s_wA;
  c.A = s_A;
  c.piA = s_piA;
  // the counters are optional (null: off); the branch is uniform over the
  // grid, so it costs no divergence
  const bool count = out_iters != nullptr;

  // warp-uniform loop: every lane of a warp holds the same p
  for (int p = static_cast<int>(slot); p < P; p += gridDim.x * warps) {
    const float orig = orig_len[p];
    float out[5];
    int counts[2] = {0, 0};
    if (skip[p] > 0.0f) {
      // dead lane: the frozen state _blo_compute reports for it
      out[0] = 0.0f;
      out[1] = DEFAULT_PENDANT;
      out[2] = orig * 0.5f;
      out[3] = orig * 0.5f;
      out[4] = 1.0f;
    } else {
      const int64_t e = e_ids[p];
      const int64_t q = q_ids[p];
      c.tu = tU + e * RK * S;
      c.tv = tV + e * RK * S;
      c.tq = tQ + q * K * S;
      if constexpr (HAS_PINV) {
        c.iq = invq + q * S;
        c.ls = ls + e * S;
      }
      c.begin = max(begins[p], 0);
      c.span = min(min(spans[p], width), S - c.begin);
      solve_pair<HAS_PINV>(c, orig, max_smoothings, out, counts);
    }
    if (lane == 0) {
      out_logl[p] = out[0];
      out_pendant[p] = out[1];
      out_distal[p] = out[2];
      out_proximal[p] = out[3];
      out_done[p] = out[4];
      if (count) {
        out_smoothings[p] = counts[0];
        out_iters[p] = counts[1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K = 20 (protein), one substitution matrix or a matrix mixture (LG4M/LG4X).
//
// PairCtx keeps its exponential rows, u, v and h in registers; at K = 20,
// R = 4 (RK = 80) two float E[RK] arrays alone are 160 floats a thread. So:
//   * the exponential row e^{x_j t} of a length (a per-pair scalar row) is
//     computed once per warp into shared memory, lane l filling entries l,
//     l+32, ..., then read as a broadcast: every lane reads the identical
//     float, so the warp still takes one branch everywhere;
//   * the back-transform and the piA contraction run per eigen row i:
//     hU_i and hV_i from u[K] and v[K] (sums over k), then
//     acc[k] += piA[i][k] * (hU_i * hV_i) (sum over i), _blo_compute's
//     orders, with about 3K floats (u, v, acc) live per (site, rate);
//   * R is a runtime loop bound and K a template constant whose inner loops
//     unroll, which keeps the build to two instantiations per flavour and
//     sumtable home;
//   * a mixture carries per-rate A and piA rows [RK][K] (rate r reads rows
//     r*K..r*K+K-1) and a per-category query tip tQ [Q, RK, S]: T1
//     multiplies T[r*K+k] by tip row r*K+k, T2 back-transforms tip rows
//     r*K+k with rate r's A. The zero-eigenvalue lanes j % K == K-1 are
//     exactly 0 in every component (ops/eigen.py), so they are skipped as
//     in the DNA code.
// Tables at the head of shared memory: x_rk [RK], wA [RK][K], A and piA
// ([K][K], a mixture's [RK][K]), rounded up to 32 floats; then two
// exponential rows [RK] per warp; then (shared home) T per warp.
// ops/blo_kernel.py::_tab_bytes and _exp_bytes must match.

__host__ __device__ inline int wide_tab_floats(int ns, int R, bool mix) {
  const int rk = R * ns;
  const int n = rk + rk * ns + (mix ? 2 * rk * ns : 2 * ns * ns);
  return (n + 31) / 32 * 32;
}

template <int NS, bool MIX, bool HAS_PINV>
struct WideCtx {
  const float* __restrict__ tu;  // tU row block of this pair's edge [RK, S]
  const float* __restrict__ tv;
  const float* __restrict__ tq;  // tQ rows of this pair's query [NS|RK, S]
  const float* __restrict__ iq;  // invq row of this pair's query [S] (+I)
  const float* __restrict__ ls;  // ls row of this pair's edge [S] (+I)
  int S;
  int R;
  int begin;
  int span;
  int width;                     // T row stride (>= span)
  int lane;
  float omp;                     // 1 - pinv (+I)
  float* T;                      // [RK (+1)][width], this warp's slice
  float* E0;                     // [RK] shared, this warp's exponential rows
  float* E1;                     // [RK]
  const float* xrk;              // [RK]         shared
  const float* wA;               // [RK][NS]     shared
  const float* A;                // [NS|RK][NS]  shared
  const float* piA;              // [NS|RK][NS]  shared

  // E[j] = exp(x_j t) (1 on the zero-eigenvalue lanes, never read), one
  // shared row per warp. The first barrier lets every lane finish reading
  // the row's previous values, the second publishes the new ones.
  __device__ void exps(float t, float* E) const {
    __syncwarp();
    for (int j = lane; j < R * NS; j += WARP) {
      E[j] = (j % NS == NS - 1) ? 1.0f : expf(xrk[j] * t);
    }
    __syncwarp();
  }

  __device__ void fill_pv() {
    const int rk = R * NS;
    for (int w = lane; w < span; w += WARP) {
      const int s = begin + w;
      T[rk * width + w] = expf(iq[s] - ls[s]);
    }
  }

  __device__ __forceinline__ float site_g(float f, int w) const {
    if constexpr (HAS_PINV) {
      return omp * f + T[R * NS * width + w];
    } else {
      return f;
    }
  }

  // T1 (T2 false): contract(wA-bt(tU e^{x la}), A-bt(tV e^{x lb})) * tQ
  // T2 (T2 true):  contract(wA-bt(tU e^{x la}), A-bt(tQ e^{x lb})) * tV
  template <bool T2>
  __device__ void build(float la, float lb) {
    exps(la, E0);
    exps(lb, E1);
    for (int w = lane; w < span; w += WARP) {
      const int s = begin + w;
      for (int r = 0; r < R; ++r) {
        // a barrier for the compiler only: with T in device memory nothing
        // in these loops writes shared memory, and a single matrix's 2 K^2
        // coefficients are then loop-invariant; without the barrier they
        // were hoisted out of the site and rate loops and spilled (72
        // registers, 9.8 KB of spill), and read volatile they lost the
        // wide shared loads (PERF.md)
        asm volatile("" ::: "memory");
        const float* cw = wA + r * NS * NS;
        const float* ca = MIX ? A + r * NS * NS : A;
        const float* cp = MIX ? piA + r * NS * NS : piA;
        float u[NS], v[NS], acc[NS];
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int j = r * NS + k;
          u[k] = tu[j * S + s];
          v[k] = T2 ? tq[(MIX ? j : k) * S + s] : tv[j * S + s];
          if (k != NS - 1) {
            u[k] *= E0[j];
            v[k] *= E1[j];
          }
        }
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float hu = cw[i * NS] * u[0];
          float hv = ca[i * NS] * v[0];
#pragma unroll
          for (int k = 1; k < NS; ++k) {
            hu += cw[i * NS + k] * u[k];
            hv += ca[i * NS + k] * v[k];
          }
          const float p = hu * hv;
#pragma unroll
          for (int k = 0; k < NS; ++k) {
            acc[k] = (i == 0) ? cp[k] * p : acc[k] + cp[i * NS + k] * p;
          }
        }
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int j = r * NS + k;
          const float o = T2 ? tv[j * S + s] : tq[(MIX ? j : k) * S + s];
          T[j * width + w] = acc[k] * o;
        }
      }
    }
  }

  __device__ void build_t1(float lp, float ld) { build<false>(lp, ld); }
  __device__ void build_t2(float lprox, float lpend) {
    build<true>(lprox, lpend);
  }

  // masked log-likelihood (scaled space) from T at pendant length lq
  __device__ float score(float lq) const {
    exps(lq, E0);
    float acc = 0.0f;
    for (int w = lane; w < span; w += WARP) {
      float f = 0.0f;
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int j = r * NS + k;
          const float t = T[j * width + w];
          f += (k == NS - 1) ? t : t * E0[j];
        }
      }
      acc += logf(fmaxf(site_g(f, w), FLT_MIN));
    }
    return warp_sum(acc);
  }

  // safeguarded Newton, PairCtx::newton's arithmetic over the shared row
  __device__ float newton(float xmin, float xmax, float xtol, float guess,
                          int& iters) const {
    float x = fminf(fmaxf(guess, xmin), xmax);
    float slid = 0.0f;
    bool done = false;
    for (int it = 0; it < MAX_ITERS && !done; ++it) {
      ++iters;
      exps(x, E0);
      float d1p = 0.0f, d2p = 0.0f;
      for (int w = lane; w < span; w += WARP) {
        float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int k = 0; k < NS; ++k) {
            const int j = r * NS + k;
            const float t = T[j * width + w];
            if (k == NS - 1) {
              f0 += t;  // zero-eigenvalue lane: x_j == 0 exactly
            } else {
              const float xj = xrk[j];
              const float tE = t * E0[j];
              f0 += tE;
              f1 += tE * xj;
              f2 += tE * (xj * xj);
            }
          }
        }
        const float g = fmaxf(site_g(f0, w), FLT_MIN);
        const float inv_g = 1.0f / g;
        if constexpr (HAS_PINV) {
          f1 = omp * f1;
          f2 = omp * f2;
        }
        const float r1 = f1 * inv_g;
        d1p += r1;
        d2p += f2 * inv_g - r1 * r1;
      }
      const float d1 = warp_sum(d1p);
      const float d2 = warp_sum(d2p);
      const float newton_x = x - d1 / (d2 == 0.0f ? 1.0f : d2);
      const float dirn = d1 > 0.0f ? 1.0f : -1.0f;
      const bool snap = (d2 >= 0.0f) && (slid * dirn > 0.0f);
      const float bound = d1 > 0.0f ? xmax : xmin;
      const float slide =
          snap ? bound : (d1 > 0.0f ? (x + xmax) / 2.0f : (x + xmin) / 2.0f);
      const float xn =
          fminf(fmaxf(d2 < 0.0f ? newton_x : slide, xmin), xmax);
      slid = d2 < 0.0f ? 0.0f : dirn;
      done = (fabsf(xn - x) < xtol) || (fabsf(d1) <= D1_EPSILON) ||
             ((d2 < 0.0f) && (d1 * d1 <= GAIN_EPSILON * -d2));
      x = xn;
    }
    return x;
  }
};

// blo_newton_kernel for K = NS states with a runtime rate count R
template <int NS, bool MIX, bool GLOBAL_T, bool HAS_PINV>
__global__ void __launch_bounds__(128)
blo_newton_wide_kernel(const float* __restrict__ tU,
                       const float* __restrict__ tV,
                       const float* __restrict__ tQ, int S, int R,
                       const float* __restrict__ invq,
                       const float* __restrict__ ls,
                       const float* __restrict__ omp,
                       const int* __restrict__ e_ids,
                       const int* __restrict__ q_ids,
                       const int* __restrict__ begins,
                       const int* __restrict__ spans,
                       const float* __restrict__ orig_len,
                       const float* __restrict__ skip,
                       const float* __restrict__ x_rk,
                       const float* __restrict__ wA,
                       const float* __restrict__ A,
                       const float* __restrict__ piA, int P, int width,
                       int max_smoothings, float* __restrict__ t_scratch,
                       float* __restrict__ out_logl,
                       float* __restrict__ out_pendant,
                       float* __restrict__ out_distal,
                       float* __restrict__ out_proximal,
                       float* __restrict__ out_done,
                       int* __restrict__ out_smoothings,
                       int* __restrict__ out_iters) {
  const int RK = R * NS;
  const int KQ = MIX ? RK : NS;  // tip rows; also A/piA rows
  const size_t ROWS = RK + (HAS_PINV ? 1 : 0);
  const int tab = wide_tab_floats(NS, R, MIX);
  extern __shared__ float smem[];
  float* s_x = smem;                 // [RK]
  float* s_wA = s_x + RK;            // [RK * NS]
  float* s_A = s_wA + RK * NS;       // [KQ * NS]
  float* s_piA = s_A + KQ * NS;      // [KQ * NS]
  for (int i = threadIdx.x; i < RK; i += blockDim.x) s_x[i] = x_rk[i];
  for (int i = threadIdx.x; i < RK * NS; i += blockDim.x) s_wA[i] = wA[i];
  for (int i = threadIdx.x; i < KQ * NS; i += blockDim.x) {
    s_A[i] = A[i];
    s_piA[i] = piA[i];
  }
  __syncthreads();

  const int warps = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  const size_t slot = static_cast<size_t>(blockIdx.x) * warps + warp;

  WideCtx<NS, MIX, HAS_PINV> c;
  c.S = S;
  c.R = R;
  c.width = width;
  c.lane = lane;
  c.omp = HAS_PINV ? omp[0] : 1.0f;
  c.iq = nullptr;
  c.ls = nullptr;
  c.E0 = smem + tab + static_cast<size_t>(warp) * 2 * RK;
  c.E1 = c.E0 + RK;
  if constexpr (GLOBAL_T) {
    c.T = t_scratch + slot * ROWS * width;
  } else {
    c.T = smem + tab + static_cast<size_t>(warps) * 2 * RK +
          static_cast<size_t>(warp) * ROWS * width;
  }
  c.xrk = s_x;
  c.wA = s_wA;
  c.A = s_A;
  c.piA = s_piA;
  const bool count = out_iters != nullptr;

  // warp-uniform loop: every lane of a warp holds the same p
  for (int p = static_cast<int>(slot); p < P; p += gridDim.x * warps) {
    const float orig = orig_len[p];
    float out[5];
    int counts[2] = {0, 0};
    if (skip[p] > 0.0f) {
      out[0] = 0.0f;
      out[1] = DEFAULT_PENDANT;
      out[2] = orig * 0.5f;
      out[3] = orig * 0.5f;
      out[4] = 1.0f;
    } else {
      const int64_t e = e_ids[p];
      const int64_t q = q_ids[p];
      c.tu = tU + e * RK * S;
      c.tv = tV + e * RK * S;
      c.tq = tQ + q * KQ * S;
      if constexpr (HAS_PINV) {
        c.iq = invq + q * S;
        c.ls = ls + e * S;
      }
      c.begin = max(begins[p], 0);
      c.span = min(min(spans[p], width), S - c.begin);
      solve_pair<HAS_PINV>(c, orig, max_smoothings, out, counts);
    }
    if (lane == 0) {
      out_logl[p] = out[0];
      out_pendant[p] = out[1];
      out_distal[p] = out[2];
      out_proximal[p] = out[3];
      out_done[p] = out[4];
      if (count) {
        out_smoothings[p] = counts[0];
        out_iters[p] = counts[1];
      }
    }
  }
}

struct Args {
  const float* tU;
  const float* tV;
  const float* tQ;
  int S;
  const float* invq;
  const float* ls;
  const float* omp;
  const int* e_ids;
  const int* q_ids;
  const int* begins;
  const int* spans;
  const float* orig_len;
  const float* skip;
  const float* x_rk;
  const float* wA;
  const float* A;
  const float* piA;
  int P;
  int width;
  int max_smoothings;
  int pairs_per_block;
  int blocks;
  float* t_scratch;
  float* logl;
  float* pendant;
  float* distal;
  float* proximal;
  float* done;
  int* smoothings;
  int* iters;
  int num_rates;
};

template <int R, bool GLOBAL_T, bool HAS_PINV>
int launch_as(const Args& a, cudaStream_t stream) {
  constexpr int ROWS = R * K + (HAS_PINV ? 1 : 0);
  const size_t t_floats =
      GLOBAL_T ? 0 : static_cast<size_t>(a.pairs_per_block) * ROWS * a.width;
  const size_t smem = sizeof(float) * (TAB_FLOATS + t_floats);
  cudaError_t err = cudaFuncSetAttribute(
      blo_newton_kernel<R, GLOBAL_T, HAS_PINV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  blo_newton_kernel<R, GLOBAL_T, HAS_PINV>
      <<<a.blocks, WARP * a.pairs_per_block, smem, stream>>>(
          a.tU, a.tV, a.tQ, a.S, a.invq, a.ls, a.omp, a.e_ids, a.q_ids,
          a.begins, a.spans, a.orig_len, a.skip, a.x_rk, a.wA, a.A, a.piA,
          a.P, a.width, a.max_smoothings, a.t_scratch, a.logl, a.pendant,
          a.distal, a.proximal, a.done, a.smoothings, a.iters);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool HAS_PINV = BLO_HAS_PINV != 0;
  if (a.t_scratch != nullptr) return launch_as<R, true, HAS_PINV>(a, stream);
  return launch_as<R, false, HAS_PINV>(a, stream);
}

template <int NS, bool MIX, bool GLOBAL_T, bool HAS_PINV>
int launch_wide_as(const Args& a, cudaStream_t stream) {
  const int rk = a.num_rates * NS;
  const size_t rows = rk + (HAS_PINV ? 1 : 0);
  const size_t t_floats =
      GLOBAL_T ? 0 : static_cast<size_t>(a.pairs_per_block) * rows * a.width;
  const size_t smem =
      sizeof(float) * (wide_tab_floats(NS, a.num_rates, MIX) +
                       static_cast<size_t>(a.pairs_per_block) * 2 * rk +
                       t_floats);
  cudaError_t err = cudaFuncSetAttribute(
      blo_newton_wide_kernel<NS, MIX, GLOBAL_T, HAS_PINV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  blo_newton_wide_kernel<NS, MIX, GLOBAL_T, HAS_PINV>
      <<<a.blocks, WARP * a.pairs_per_block, smem, stream>>>(
          a.tU, a.tV, a.tQ, a.S, a.num_rates, a.invq, a.ls, a.omp, a.e_ids,
          a.q_ids, a.begins, a.spans, a.orig_len, a.skip, a.x_rk, a.wA, a.A,
          a.piA, a.P, a.width, a.max_smoothings, a.t_scratch, a.logl,
          a.pendant, a.distal, a.proximal, a.done, a.smoothings, a.iters);
  return static_cast<int>(cudaGetLastError());
}

template <bool MIX>
int launch_wide(const Args& a, cudaStream_t stream) {
  constexpr bool HAS_PINV = BLO_HAS_PINV != 0;
  if (a.t_scratch != nullptr) {
    return launch_wide_as<20, MIX, true, HAS_PINV>(a, stream);
  }
  return launch_wide_as<20, MIX, false, HAS_PINV>(a, stream);
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t code. num_states (4 or 20), num_rates (1-8)
// and mixture (per-rate A/piA [RK][K] and tQ [Q, RK, S]; K = 20 only, and
// not in the +I library) select the instantiation, RK = num_states *
// num_rates; -1 means an unsupported combination, -2 a missing +I input.
// t_scratch is null for T in shared memory, else blocks * pairs_per_block
// slices of [RK (+1)][width] floats in device memory. invq [Q, S], ls
// [E, S] and omp [1] are read only by the +I library; smoothings and
// iters [P] are both null (no counters) or both set.
int blo_newton_launch(const float* tU, const float* tV, const float* tQ,
                      int S, int num_states, int num_rates, int mixture,
                      const float* invq,
                      const float* ls, const float* omp, const int* e_ids,
                      const int* q_ids, const int* begins, const int* spans,
                      const float* orig_len, const float* skip,
                      const float* x_rk, const float* wA, const float* A,
                      const float* piA, int P, int width, int max_smoothings,
                      int pairs_per_block, int blocks, float* t_scratch,
                      float* logl, float* pendant, float* distal,
                      float* proximal, float* done, int* smoothings,
                      int* iters, void* stream) {
  if (P <= 0) return 0;
  if (BLO_HAS_PINV && (invq == nullptr || ls == nullptr || omp == nullptr)) {
    return -2;
  }
  if ((smoothings == nullptr) != (iters == nullptr)) return -2;
  const Args a{tU,     tV,      tQ,     S,       invq,           ls,
               omp,    e_ids,   q_ids,  begins,  spans,          orig_len,
               skip,   x_rk,    wA,     A,       piA,            P,
               width,  max_smoothings,  pairs_per_block,         blocks,
               t_scratch,       logl,   pendant, distal,         proximal,
               done,   smoothings,      iters,  num_rates};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_rates < 1 || num_rates > MAX_R) return -1;
  if (num_states == 20) {
    if (mixture) {
#if BLO_HAS_PINV
      return -1;  // no +I with a matrix mixture
#else
      return launch_wide<true>(a, st);
#endif
    }
    return launch_wide<false>(a, st);
  }
  if (num_states != K || mixture) return -1;
  switch (num_rates) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 3: return launch<3>(a, st);
    case 4: return launch<4>(a, st);
    case 5: return launch<5>(a, st);
    case 6: return launch<6>(a, st);
    case 7: return launch<7>(a, st);
    case 8: return launch<8>(a, st);
    default: return -1;
  }
}

const char* blo_newton_error_string(int code) {
  if (code == -1) {
    return "unsupported state count, rate count or mixture (4 or 20 "
           "states, 1-8 rates, mixtures at 20 states without +I)";
  }
  if (code == -2) return "missing +I input or counter output";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
