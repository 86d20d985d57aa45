// Thorough-placement Newton branch-length optimisation for DNA (K = 4) and
// protein (K = 20) models, single-matrix and matrix-mixture, on Hopper
// (sm_90a): the pplacer smoothing loop of the trilinear eigenbasis form,
// one warp per (query, edge) pair at K = 4, a team of 256 threads per pair
// at K = 20.
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
// solve and 2-4 smoothings. At K = 20 the build grows with K^2 (2418
// operations per site and rate against 98; ~90% of the pair's work at
// ~7 builds and ~11 Newton iterations) and the bound stays operations:
// the windows are 720 B per site at RK = 80 (960 B for a mixture), read
// through L2 at every build, against ~70,000 operations per site.
// The working set that must stay on chip is T, RK floats per site, not
// the TPU's ~five [RK, W, 128] tile sets (1 MB each at W = 128, RK = 16),
// which do not fit the 227 KB of shared memory a block may use.
//
// DNA (K = 4, PairCtx, blo_newton_kernel), one warp per pair:
//   * lanes stride over the window's sites, d1/d2 and the score are
//     reduced with an xor-butterfly of shuffles, which leaves the
//     bit-identical sum in every lane, so the whole warp takes the same
//     Newton/smoothing branches with no barrier at all;
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
//   Windows too wide for shared memory ((RK (+1)) * width * 4 bytes of T
//   per warp above ops/blo_kernel.py::max_shared_sites) keep T in a
//   device-memory scratch instead, one slice per resident warp; the grid
//   is then capped to the scratch's slices and each warp loops over pairs.
//
// Protein (K = 20, TeamCtx, blo_newton_team_kernel). A warp per pair held
// four pairs of T (4 x 40 KB at RK = 80, width 128) in one block per SM:
// 4 warps on an SM, each stalling in turn on its loads, its exponentials
// and its barriers with nothing to cover them, re-reading its windows
// from L2 at every build (~7 per pair), and a block of tables per four
// slots, dead or alive. So:
//   * one CTA per pair, a team of 256 threads (8 warps): at the main
//     path's width each thread owns two (site, rate) units of a build
//     (128 sites x 4 rates), rate-major with neighbouring lanes on
//     neighbouring sites, so T rows (r*20+k)*width + w are free of bank
//     conflicts; a rate gets 8/R warps (a tile of 256/R sites, in 32s), a
//     thread the units w, w + tile, ... of its rate, and warps past R
//     tiles idle. __launch_bounds__(256, 1) leaves ptxas up to 255
//     registers, and the unrolled 20 x 20 back-transforms take 178-235
//     without spill, so the register file holds one team: 8 warps an SM.
//     512 threads (one unit each, 16 warps an SM at 128 registers) spilled
//     40-140 B and ran 1.5% slower on protein pairs and 30% slower on
//     mixture pairs (PERF.md);
//   * persistent CTAs: the grid is what the 132 SMs hold at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and each CTA walks
//     pairs p = blockIdx.x, p + gridDim.x, ... with the tables loaded into
//     shared memory once; a dead slot costs its skip flag and its frozen
//     outputs, and p is uniform over the team, so nothing diverges;
//   * T lives in shared memory and the builds read the pair's windows
//     (tU, tV [RK, span], tQ's K or RK rows) from L2, coalesced along
//     sites, as the DNA code does. At RK = 80, width 128: 9,984 B of
//     tables + 2 KB of exponential rows + 12.1 KB of reduction buffers +
//     T 40,960 B = 65 KB; registers, not shared memory, hold an SM to one
//     CTA. Staging the windows in shared memory once per pair (cp.async,
//     92 KB more) was measured no faster than L2 on the main paths' pairs
//     (PERF.md). Past max_shared_sites T goes to the device-memory
//     scratch, one slice per CTA; ops/blo_kernel.py::wide_geometry and
//     max_shared_sites mirror TeamLayout. The +I row pv is computed into
//     T once per pair;
//   * each warp keeps its own row of its rate's 20 exponentials (lane k
//     fills entry k; __syncwarp only);
//   * sums: the owner of unit (site, rate) sums its 20 eigen lanes in k
//     order (the zero lane adds to f0 only) into a shared partial; after a
//     barrier thread t adds the rates of its sites t, t + tile, ... in
//     order r = 0..R-1 and the sites in that order, then the warp
//     butterfly, then the warps in a fixed tree that every thread reads
//     after one more barrier. One barrier publishes a chunk of 512 units
//     (two tiles at R = 4); partials and warp slots alternate between two
//     buffers, so one barrier per chunk and one per reduction suffice, and
//     the whole team takes the same slide/snap/stop branches.
//
// Built without --use_fast_math (tiny is FLT_MIN and the rollback test
// |new| * 1e-14 must stay as written) and with -fmad=false: the kernel
// then rounds every product and sum as its plain version
// (ops/blo_kernel.py::blo_newton_plain, which repeats both reduction
// orders) does and agrees with it on every pair, so a fault that touches a
// few pairs still shows. It also caps every instantiation at half the
// card's FMA rate: 2 x the operation bound at best. On the DNA main
// path's pairs, mul+add contraction saves about 4% of the kernel's time,
// and it parts from the plain version, in f32 and in f64 alike, by up to
// a few logl units on about one pair in two thousand, where f32 is
// borderline (``python3 chip_smoke.py --fmad-ab``; PERF.md).
//
// The source is compiled twice, with BLO_HAS_PINV 0 and 1, into two
// libraries that build in parallel; each holds the 16 DNA instantiations
// (rate count x sumtable home) of its flavour, and the K = 20 ones
// ({single, mixture} x home without +I, single x home with it; the JAX
// package takes no +I with a mixture).

#include <cuda_runtime.h>

#include <algorithm>
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
// iterations executed by this pair. Ctx is PairCtx (DNA, one warp) or
// TeamCtx (K = 20, a team of TEAM threads; every thread returns the same
// values, its sums being the team's).
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
// K = 20 (protein), one substitution matrix or a matrix mixture (LG4M/LG4X):
// a team of TEAM threads per pair in one persistent CTA (the design is in
// the header).
//
// Shared memory of a CTA, in floats, each region on a 32-float boundary
// (TeamLayout; ops/blo_kernel.py::wide_geometry must match):
//   tables   x_rk [RK], wA [RK][NS], A and piA ([NS][NS], a mixture's
//            [RK][NS])                                 wide_tab_floats
//   exps     two rows of 32 floats per warp: e^{x t} of the warp's rate
//   red      [2][3][RED_UNITS] per-unit partial sums, one buffer per chunk
//            parity
//   slots    [2][2][TEAM_WARPS] warp sums, one buffer per reduction parity
//   T        [RK (+1)][width]             (in t_scratch instead: GLOBAL_T)

constexpr int TEAM = 256;
constexpr int TEAM_WARPS = TEAM / WARP;
// (site, rate) units whose partial sums one barrier publishes: a chunk of
// RED_UNITS / R sites (RED_UNITS / TEAM tiles)
constexpr int RED_UNITS = 512;
static_assert(RED_UNITS % TEAM == 0, "a chunk holds whole tiles");
constexpr int SMEM_LIMIT_FLOATS = 232448 / 4;  // 227 KB a block may use

__host__ __device__ inline int round32(int n) { return (n + 31) / 32 * 32; }

__host__ __device__ inline int wide_tab_floats(int ns, int R, bool mix) {
  const int rk = R * ns;
  return round32(rk + rk * ns + (mix ? 2 * rk * ns : 2 * ns * ns));
}

struct TeamLayout {
  int exps, red, slots, t, t_end;
  __host__ __device__ TeamLayout(int ns, int R, bool mix, bool pinv,
                                 int width) {
    const int rk = R * ns;
    exps = wide_tab_floats(ns, R, mix);
    red = exps + TEAM_WARPS * 2 * 32;
    slots = red + 2 * 3 * RED_UNITS;
    t = slots + round32(2 * 2 * TEAM_WARPS);
    t_end = t + round32((rk + (pinv ? 1 : 0)) * width);
  }
};

template <int NS, bool MIX, bool HAS_PINV>
struct TeamCtx {
  // the pair's window rows in device memory (row stride ld = S, site w at
  // column begin + w)
  const float* wu;               // [RK] rows of tU
  const float* wv;               // [RK] rows of tV
  const float* wq;               // [NS|RK] rows of tQ
  int ld;
  int R;
  int span;
  int width;                     // T row stride (>= span)
  int tile;                      // sites per tile: 32 x the warps of a rate
  int chunk;                     // sites per barrier: RED_UNITS / TEAM tiles
  int tid;
  int lane;
  int rate;                      // this warp's rate (>= R: an idle warp)
  int site;                      // this thread's site within a tile
  int sbuf;                      // slot buffer of the next reduction
  float omp;                     // 1 - pinv (+I)
  float* T;                      // [RK (+1)][width]
  float* E0;                     // [32] shared, this warp's exponential rows
  float* E1;
  float* red;                    // [2][3][RED_UNITS] shared
  float* slots;                  // [2][2][TEAM_WARPS] shared
  const float* xrk;              // [RK]         shared
  const float* wA;               // [RK][NS]     shared
  const float* A;                // [NS|RK][NS]  shared
  const float* piA;              // [NS|RK][NS]  shared

  // E[k] = exp(x_{rate*NS+k} t) (1 on the zero-eigenvalue lane, never
  // read): the warp's own row, lane k filling entry k. The first
  // __syncwarp lets every lane finish reading the previous values, the
  // second publishes the new ones; no block barrier.
  __device__ void exps(float t, float* E) const {
    if (rate >= R) return;  // warp-uniform
    __syncwarp();
    if (lane < NS) {
      E[lane] = (lane == NS - 1) ? 1.0f : expf(xrk[rate * NS + lane] * t);
    }
    __syncwarp();
  }

  // the pv row is filled before the barrier that opens the pair
  // (blo_newton_team_kernel)
  __device__ void fill_pv() {}

  __device__ __forceinline__ float site_g(float f, int w) const {
    if constexpr (HAS_PINV) {
      return omp * f + T[R * NS * width + w];
    } else {
      return f;
    }
  }

  // T1 (T2 false): contract(wA-bt(tU e^{x la}), A-bt(tV e^{x lb})) * tQ
  // T2 (T2 true):  contract(wA-bt(tU e^{x la}), A-bt(tQ e^{x lb})) * tV
  // Each thread builds the units (site, its rate) w = site, site + tile,
  // ...; the barrier at the end publishes T.
  template <bool T2>
  __device__ void build(float la, float lb) {
    exps(la, E0);
    exps(lb, E1);
    if (rate < R) {
      const int r = rate;
      for (int w = site; w < span; w += tile) {
        // a barrier for the compiler only: it keeps ptxas from hoisting
        // a single matrix's 2 K^2 loop-invariant coefficients out of the
        // unit loop into registers, which spills (PERF.md)
        asm volatile("" ::: "memory");
        const float* cw = wA + r * NS * NS;
        const float* ca = MIX ? A + r * NS * NS : A;
        const float* cp = MIX ? piA + r * NS * NS : piA;
        float u[NS], v[NS], acc[NS];
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const int j = r * NS + k;
          u[k] = wu[j * ld + w];
          v[k] = T2 ? wq[(MIX ? j : k) * ld + w] : wv[j * ld + w];
          if (k != NS - 1) {
            u[k] *= E0[k];
            v[k] *= E1[k];
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
          const float o = T2 ? wv[j * ld + w] : wq[(MIX ? j : k) * ld + w];
          T[j * width + w] = acc[k] * o;
        }
      }
    }
    __syncthreads();
  }

  __device__ void build_t1(float lp, float ld_) { build<false>(lp, ld_); }
  __device__ void build_t2(float lprox, float lpend) {
    build<true>(lprox, lpend);
  }

  // N sums over the team, returned in every thread: each thread's value
  // (its sites, in tile order), the warp's xor butterfly, then the warps in
  // a fixed tree (a[i] += a[i + h], h = TEAM_WARPS/2 .. 1), every thread
  // reading the same slots. The slots alternate between two buffers, so
  // one barrier per reduction suffices.
  template <int N>
  __device__ void team_sum(float (&v)[N]) {
    float* s = slots + sbuf * 2 * TEAM_WARPS;
    sbuf ^= 1;
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) s[n * TEAM_WARPS + tid / WARP] = v[n];
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float a[TEAM_WARPS];
#pragma unroll
      for (int i = 0; i < TEAM_WARPS; ++i) a[i] = s[n * TEAM_WARPS + i];
#pragma unroll
      for (int h = TEAM_WARPS / 2; h > 0; h >>= 1) {
#pragma unroll
        for (int i = 0; i < h; ++i) a[i] = a[i] + a[i + h];
      }
      v[n] = a[0];
    }
  }

  // masked log-likelihood (scaled space) from T at pendant length lq: per
  // chunk, each unit's sum over its 20 eigen lanes (k order) into red, a
  // barrier, then thread t adds the rates of its sites t, t + tile, ... in
  // order r = 0..R-1. The partials alternate between two buffers, so one
  // barrier per chunk suffices.
  __device__ float score(float lq) {
    exps(lq, E0);
    float acc[1] = {0.0f};
    int buf = 0;
    for (int base = 0; base < span; base += chunk, buf ^= 1) {
      float* part = red + buf * 3 * RED_UNITS;
      const int end = min(base + chunk, span);
      if (rate < R) {
        for (int w = base + site; w < end; w += tile) {
          float f = 0.0f;
#pragma unroll
          for (int k = 0; k < NS; ++k) {
            const float t = T[(rate * NS + k) * width + w];
            f += (k == NS - 1) ? t : t * E0[k];
          }
          part[rate * chunk + w - base] = f;
        }
      }
      __syncthreads();
      if (tid < tile) {
        for (int ws = base + tid; ws < end; ws += tile) {
          float f = part[ws - base];
          for (int r = 1; r < R; ++r) f += part[r * chunk + ws - base];
          acc[0] += logf(fmaxf(site_g(f, ws), FLT_MIN));
        }
      }
    }
    team_sum(acc);
    return acc[0];
  }

  // safeguarded Newton, PairCtx::newton's step over the team's sums: f0,
  // f1, f2 per unit (k order; the zero lane adds to f0 only), the rates in
  // order per site, then d1 and d2 over the sites in one reduction
  __device__ float newton(float xmin, float xmax, float xtol, float guess,
                          int& iters) {
    float x = fminf(fmaxf(guess, xmin), xmax);
    float slid = 0.0f;
    bool done = false;
    const int rc = R * chunk;
    // the rate's exponent lanes, in registers for the whole solve
    float xs[NS - 1];
#pragma unroll
    for (int k = 0; k < NS - 1; ++k) {
      xs[k] = rate < R ? xrk[rate * NS + k] : 0.0f;
    }
    for (int it = 0; it < MAX_ITERS && !done; ++it) {
      ++iters;
      exps(x, E0);
      float d[2] = {0.0f, 0.0f};
      int buf = 0;
      for (int base = 0; base < span; base += chunk, buf ^= 1) {
        float* part = red + buf * 3 * RED_UNITS;
        const int end = min(base + chunk, span);
        if (rate < R) {
          for (int w = base + site; w < end; w += tile) {
            float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
#pragma unroll
            for (int k = 0; k < NS; ++k) {
              const float t = T[(rate * NS + k) * width + w];
              if (k == NS - 1) {
                f0 += t;  // zero-eigenvalue lane: x_j == 0 exactly
              } else {
                const float xj = xs[k];
                const float tE = t * E0[k];
                f0 += tE;
                f1 += tE * xj;
                f2 += tE * (xj * xj);
              }
            }
            const int u = rate * chunk + w - base;
            part[u] = f0;
            part[rc + u] = f1;
            part[2 * rc + u] = f2;
          }
        }
        __syncthreads();
        if (tid < tile) {
          for (int ws = base + tid; ws < end; ws += tile) {
            const int u = ws - base;
            float f0 = part[u], f1 = part[rc + u], f2 = part[2 * rc + u];
            for (int r = 1; r < R; ++r) {
              f0 += part[r * chunk + u];
              f1 += part[rc + r * chunk + u];
              f2 += part[2 * rc + r * chunk + u];
            }
            const float g = fmaxf(site_g(f0, ws), FLT_MIN);
            const float inv_g = 1.0f / g;
            if constexpr (HAS_PINV) {
              f1 = omp * f1;
              f2 = omp * f2;
            }
            const float r1 = f1 * inv_g;
            d[0] += r1;
            d[1] += f2 * inv_g - r1 * r1;
          }
        }
      }
      team_sum(d);
      const float d1 = d[0];
      const float d2 = d[1];
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

// K = NS states with a runtime rate count R: CTA b takes pairs b, b + grid,
// ... (the grid is what the SMs hold at once), every thread of the team
// holding the same p, so no thread diverges on it. GLOBAL_T: T in
// t_scratch, one slice per CTA.
template <int NS, bool MIX, bool GLOBAL_T, bool HAS_PINV>
__global__ void __launch_bounds__(TEAM, 1)
blo_newton_team_kernel(const float* __restrict__ tU,
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
                       int max_smoothings,
                       float* __restrict__ t_scratch,
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
  const TeamLayout L(NS, R, MIX, HAS_PINV, width);
  extern __shared__ __align__(16) float team_smem[];
  float* smem = team_smem;
  float* s_x = smem;                 // [RK]
  float* s_wA = s_x + RK;            // [RK * NS]
  float* s_A = s_wA + RK * NS;       // [KQ * NS]
  float* s_piA = s_A + KQ * NS;      // [KQ * NS]
  for (int i = threadIdx.x; i < RK; i += TEAM) s_x[i] = x_rk[i];
  for (int i = threadIdx.x; i < RK * NS; i += TEAM) s_wA[i] = wA[i];
  for (int i = threadIdx.x; i < KQ * NS; i += TEAM) {
    s_A[i] = A[i];
    s_piA[i] = piA[i];
  }
  __syncthreads();

  const int tid = threadIdx.x;
  const int warp = tid / WARP;
  const int lane = tid % WARP;
  const int per_rate = TEAM_WARPS / R;  // warps of a rate
  TeamCtx<NS, MIX, HAS_PINV> c;
  c.ld = S;
  c.R = R;
  c.width = width;
  c.tile = per_rate * WARP;
  c.chunk = c.tile * (RED_UNITS / TEAM);
  c.tid = tid;
  c.lane = lane;
  c.rate = warp / per_rate;
  c.site = (warp % per_rate) * WARP + lane;
  c.omp = HAS_PINV ? omp[0] : 1.0f;
  c.E0 = smem + L.exps + warp * 64;
  c.E1 = c.E0 + 32;
  c.red = smem + L.red;
  c.slots = smem + L.slots;
  if constexpr (GLOBAL_T) {
    c.T = t_scratch + static_cast<size_t>(blockIdx.x) * ROWS * width;
  } else {
    c.T = smem + L.t;
  }
  c.xrk = s_x;
  c.wA = s_wA;
  c.A = s_A;
  c.piA = s_piA;
  const bool count = out_iters != nullptr;

  for (int p = blockIdx.x; p < P; p += gridDim.x) {
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
      const int begin = max(begins[p], 0);
      const int span = min(min(spans[p], width), S - begin);
      c.span = span;
      c.sbuf = 0;
      c.wu = tU + e * RK * S + begin;
      c.wv = tV + e * RK * S + begin;
      c.wq = tQ + q * KQ * S + begin;
      if constexpr (HAS_PINV) {
        // the +I row of T: pv = exp(invq - ls) over the span, once per pair
        for (int w = tid; w < span; w += TEAM) {
          const int s = begin + w;
          c.T[RK * width + w] = expf(invq[q * S + s] - ls[e * S + s]);
        }
      }
      __syncthreads();
      solve_pair<HAS_PINV>(c, orig, max_smoothings, out, counts);
    }
    if (tid == 0) {
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

// Sets the instantiation's shared memory, reads how many of its CTAs an SM
// holds (the runtime's occupancy) and, with ``a``, launches that many
// persistent CTAs per SM (never more than ``blocks``, the pairs or the
// device-memory scratch's slices). geo = {threads per CTA, CTAs per SM,
// dynamic shared bytes, T in shared memory}.
template <int NS, bool MIX, bool GLOBAL_T, bool HAS_PINV>
int launch_team_as(const Args* a, int smem_floats, int* geo,
                   cudaStream_t stream) {
  const auto kernel = blo_newton_team_kernel<NS, MIX, GLOBAL_T, HAS_PINV>;
  const int smem = smem_floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        TEAM, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  geo[0] = TEAM;
  geo[1] = per_sm;
  geo[2] = smem;
  geo[3] = GLOBAL_T ? 0 : 1;
  if (a == nullptr) return 0;
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int grid = std::max(1, std::min(a->blocks, per_sm * sms));
  kernel<<<grid, TEAM, smem, stream>>>(
      a->tU, a->tV, a->tQ, a->S, a->num_rates, a->invq, a->ls, a->omp,
      a->e_ids, a->q_ids, a->begins, a->spans, a->orig_len, a->skip,
      a->x_rk, a->wA, a->A, a->piA, a->P, a->width, a->max_smoothings,
      a->t_scratch, a->logl, a->pendant, a->distal, a->proximal, a->done,
      a->smoothings, a->iters);
  return static_cast<int>(cudaGetLastError());
}

// the sumtable's home: shared memory where T fits, else (``device_t``: a
// t_scratch given) device memory; with ``a`` null only geo is filled
template <bool MIX>
int launch_team(const Args* a, int R, int width, bool device_t, int* geo,
                cudaStream_t stream) {
  constexpr bool HAS_PINV = BLO_HAS_PINV != 0;
  const TeamLayout L(20, R, MIX, HAS_PINV, width);
  if (device_t) {
    return launch_team_as<20, MIX, true, HAS_PINV>(a, L.t, geo, stream);
  }
  if (L.t_end <= SMEM_LIMIT_FLOATS) {
    return launch_team_as<20, MIX, false, HAS_PINV>(a, L.t_end, geo,
                                                    stream);
  }
  return -3;
}

int blo_newton_team(const Args* a, int R, int mixture, int width,
                    bool device_t, int* geo, cudaStream_t stream) {
  if (mixture) {
#if BLO_HAS_PINV
    return -1;  // no +I with a matrix mixture
#else
    return launch_team<true>(a, R, width, device_t, geo, stream);
#endif
  }
  return launch_team<false>(a, R, width, device_t, geo, stream);
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t code. num_states (4 or 20), num_rates (1-8)
// and mixture (per-rate A/piA [RK][K] and tQ [Q, RK, S]; K = 20 only, and
// not in the +I library) select the instantiation, RK = num_states *
// num_rates; -1 means an unsupported combination, -2 a missing +I input,
// -3 a K = 20 sumtable too wide for shared memory without a t_scratch.
// DNA: blocks of pairs_per_block warps; t_scratch is null for T in shared
// memory, else blocks * pairs_per_block slices of [RK (+1)][width] floats
// in device memory. K = 20: pairs_per_block is not read; at most
// ``blocks`` persistent CTAs, and t_scratch is null (T in shared memory)
// or holds ``blocks`` such slices. invq [Q, S], ls
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
    int geo[4];
    return blo_newton_team(&a, num_rates, mixture, width,
                           t_scratch != nullptr, geo, st);
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

// The geometry a K = 20 launch at this rate count, mixture flag and width
// takes (device_t: with a t_scratch), as the launcher reads it from the
// runtime: geo[4] = {threads per CTA, CTAs per SM, dynamic shared bytes,
// 1 if T is in shared memory}. Returns 0 or an error code as
// blo_newton_launch does.
int blo_newton_team_geometry(int num_rates, int mixture, int width,
                             int device_t, int* geo) {
  if (num_rates < 1 || num_rates > MAX_R || width < 1) return -1;
  return blo_newton_team(nullptr, num_rates, mixture, width, device_t != 0,
                         geo, nullptr);
}

const char* blo_newton_error_string(int code) {
  if (code == -1) {
    return "unsupported state count, rate count or mixture (4 or 20 "
           "states, 1-8 rates, mixtures at 20 states without +I)";
  }
  if (code == -2) return "missing +I input or counter output";
  if (code == -3) {
    return "the K = 20 sumtable does not fit shared memory at this width "
           "(pass a device-memory scratch)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
