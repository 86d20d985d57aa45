// Thorough-placement Newton branch-length optimisation for DNA (K = 4) and
// protein (K = 20) models, single-matrix and matrix-mixture, on Hopper
// (sm_90a): the pplacer smoothing loop of the trilinear eigenbasis form,
// one team of threads per (query, edge) pair in a persistent CTA: 128
// threads at K = 4, 256 at K = 20.
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
// Every pair iterates on its own: a finished pair's team takes the next
// pair, no lock step across pairs (the TPU kernel freezes done lanes
// instead). So the K5 counters are per pair: that pair's own executed
// Newton iterations (both solves, all smoothings) and smoothings, where
// the TPU kernel reports one count per 128-pair block, the lock-step trips
// that the block's slowest lanes set.
//
// DNA (K = 4, DnaTeamCtx, blo_newton_dna_kernel). One warp per pair gave
// each warp its own T of [RK (+1)][width] floats (16 KB at RK = 16, width
// 256; 64 KB a block of four warps): 12 warps an SM to hide the shared
// loads, the IEEE expf and divisions and the two butterflies of every
// Newton iteration. A launch of the main path holds ~1,200 live pairs,
// about one wave of such warps, so the slowest pairs' serial chains (a
// few to a few hundred Newton iterations) set its time; a block kept its
// 64 KB until its slowest pair ended; and every lane computed all RK
// exponentials. So:
//   * one CTA per pair, a team of DNA_TEAM = 128 threads (4 warps):
//     thread t owns the window's sites t, t + 128, ... (two at width 256)
//     and sums each site's RK eigen lanes in j order; the zero-eigenvalue
//     lanes j == K-1 (mod K) (ops/eigen.py snaps that eigenvalue to
//     exactly 0) skip their exp and their derivative terms, as
//     _blo_compute does statically;
//   * one T per CTA in shared memory up to max_shared_sites (2,880 sites
//     at RK = 16, with or without +I), so registers, not T, set how many
//     teams an SM holds. T is site-major, [width][TS]: a site's RK sums,
//     rate r's four as float4 r, then the +I pv (filled once per pair),
//     padded to TS = 4 mod 8 floats (20 at RK = 16), so 8 threads on 8
//     consecutive sites read float4s from 32 distinct banks, and a rate's
//     sums, exponentials and x_rk come in three 16-byte loads, not twelve
//     loads and their address arithmetic (rows of a runtime stride were
//     1-4% slower: PERF.md). Each thread reads and writes only
//     its own sites, so T needs no barrier. Past max_shared_sites T goes
//     to a device-memory scratch, one slice per CTA, where the R <= 8
//     rate loops stay rolled (unrolled, their float4 loads in flight
//     spilled);
//   * persistent CTAs: the grid is what the SMs hold at once, the tables
//     are loaded once per CTA, and a CTA that finishes a pair takes the
//     next untaken one from an atomic counter (a pair's work runs up to 3x
//     the mean, and a grid-stride walk, as at K = 20, was 3-8% slower:
//     PERF.md); a dead slot costs its skip flag and its frozen outputs;
//   * each warp keeps its own row of the RK exponentials e^{x_j t}, lane j
//     filling entry j once per evaluation (__syncwarp only), where every
//     lane computed all RK; the sites read the row where they use it;
//   * the SMs are bound by instruction issue, not by latency: 40% more
//     CTAs (72 registers) bought 1.5%, and 72-102-register caps spilled
//     and lost. Unbounded, ptxas hoists every rate's window loads to the
//     head of a site (150-165 registers, 3 CTAs an SM); the shared home
//     below R = 7 is capped at 128 (__launch_bounds__(128, 4): 4 CTAs),
//     which a compiler barrier at every other rate of a build keeps free
//     of spills; the Newton iteration reads x_j^2 from a table instead of
//     multiplying (PERF.md);
//   * sums: each thread over its sites, the warp's xor butterfly, then a
//     fixed tree over the 4 warps through shared slots (team_sum; a Newton
//     iteration's d1 and d2 in one reduction with one barrier), which
//     leaves the same float in every thread, so the whole team takes the
//     same Newton/smoothing branches;
//   * tU/tV/tQ are re-read from L2 at each sumtable build (~5.7 a pair),
//     coalesced along sites (the stores are site-last);
//   * R stays a template parameter (the rate loops unrolled) up to
//     MAX_R = 8: 16 DNA instantiations a library (R 1-8 x home). Past 8
//     rates (GTR+G16, +R10) one runtime-R instantiation (RC = 0) a home
//     takes any R up to the cap (ops/blo_kernel.py::max_rates, 312): its
//     tables take 24 R + 32 floats (416 at R = 16), and each lane fills
//     ceil(RK / 32) entries of its warp's exponential row. At R = 16 T is
//     68 floats (272 B) a site, with or without +I, so 832 sites fit in
//     shared memory: the headline's windows of up to 512 sites stay in
//     the shared home.
//
// DNA past 8 rate categories (RC = 0). Rolled over R at run time, the
// rate loops sat inside the site loop: every (site, rate) of a Newton
// evaluation loaded T, e, x and x^2 (4 LDS.128, 30 instructions), every
// one of a build the wA row, A, piA and both exponentials (14 LDS.128,
// 147 instructions), and a thread worked one site's chain at a time
// (K1 GTR+G16 at 11.9% of bound; PERF.md). So:
//   * site-blocked loops: a thread takes its sites w0, w0 + 128, ... in
//     blocks of SB = 2 rows (both of its sites at the main path's width;
//     one where the warp's first lane has only one in the span, so no
//     lane diverges; a lane past the span computes on entries it never
//     adds, T holding the width rounded up to 32 sites, dna_t_sites, and
//     a build clamps its window reads to the span), keeps each row's sums
//     in registers and walks the rates outer: a Newton evaluation or a
//     score in unrolled chunks of CH = 4 rates (then the rest one at a
//     time) loads a rate's e, x, x^2 once for the block's rows, and a
//     build (rates rolled) its wA row and two exponentials once, with A
//     and piA in registers for the whole build. Each site still adds its
//     rates in order and the thread its sites in order, so the plain
//     version did not change. At two rows: 2.5 LDS.128 and ~23
//     instructions per (site, rate) in a Newton evaluation, 3 and ~130 in
//     a build. Four-row blocks took 168 registers and ran no faster,
//     two-rate chunks and a build unrolled by two rates slower (PERF.md);
//   * __launch_bounds__(128, 3) in the shared home: at most 168 registers
//     a thread (ptxas takes fewer, without spill), so the 3 CTAs an SM
//     that shared memory holds at width 256 (73,472 B each at R = 16)
//     stay resident; the device home takes what it needs;
//   * R 1-8 keep their unrolled per-site loops: the blocked ones, given
//     to them, ran 0.918 / 0.966 / 0.973 / 0.961 / 0.981 / 1.023 / 1.097
//     / 1.151x as fast at R = 1-8 (+I at R = 4 0.953x; 4096 DNA headline
//     pairs, kernel_ab.py in turns; PERF.md), more than 3% slower at
//     R = 1, 2, 4 and with +I;
//   * the pairs come in the caller's order. Sorting each launch's pairs
//     by (edge, begin), so that the pairs in flight share their edges'
//     windows in L2 (528 B a site at R = 16; ~400 pairs in flight, ~52 MB
//     of distinct windows against the 50 MB L2), took 4096 pairs four to
//     an edge from 1.2819 to 1.0600 ms, but the sort (a torch argsort a
//     launch) cost more than it saved on the main path's own launches
//     (2.49 live pairs an edge; 6.9020 ms against 6.7892 without it), so
//     it went (PERF.md).
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
//     scratch, one slice per CTA; ops/blo_kernel.py::kernel_geometry and
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
// Protein past 8 rate categories (R = 9-64: LG+G16, a 16- or
// 32-component mixture): a thread-block cluster of C = ceil(R / 8) CTAs
// per pair (CLUSTER). One CTA walking all R rates (two or more a warp)
// held every rate's tables and T, 1,280 B a site at R = 16, so T fitted
// shared memory only up to 128 sites (96 for a mixture): the protein
// windows (up to 256 sites) took the device-memory scratch, every Newton
// evaluation re-read the pair's T (up to 320 KB) through L2 and every
// build wrote it, and each warp reloaded each rate's exponent lanes at
// every evaluation. Hopper's clusters let C CTAs on neighbouring SMs read
// each other's shared memory (DSMEM). So:
//   * CTA c of a cluster owns the rates [8c, min(8c + 8, R)), one a warp,
//     and is an R = 8 team otherwise (the same layout, tile and chunk): it
//     loads only its slice's x_rk and wA rows (a mixture's A and piA rows;
//     a single matrix's A and piA whole) and keeps only its rates' rows of
//     T, so T at R = 16 is 640 B a site a CTA (644 with +I) and the
//     protein windows keep it in shared memory (288 sites for LG, 256 for
//     a mixture); past that, the device-memory scratch, one slice a CTA;
//   * builds run on each CTA's own rates, with no traffic between CTAs;
//   * a Newton evaluation or score: each warp writes its units' partials
//     into its own CTA's double-buffered partials, a cluster barrier
//     stands where the R <= 8 team's __syncthreads stands, and the first
//     32 threads of EVERY CTA then add the sites t, t + 32, ... of the
//     chunk, reading rate r's partial from CTA r / 8 (map_shared_rank) in
//     order r = 0..R-1, then team_sum inside the CTA. Every CTA so holds
//     the same d1 and d2 and takes the same branches, with no broadcast.
//     The order is the walking build's (a 32-site tile, the rates in
//     order, the butterfly, the fixed tree), so the plain version did not
//     change. The partials' buffer parity runs on across evaluations (a
//     remote reducer may still read the last chunk's buffer when the next
//     evaluation begins), and a cluster barrier ends every pair, so no CTA
//     takes the next pair, or exits, while another reads its partials;
//   * persistent clusters: the grid is as many clusters as the card holds
//     at once (cudaOccupancyMaxActiveClusters; a GPC's spare SMs idle at
//     C >= 3), launched with cudaLaunchKernelEx and a runtime cluster
//     dimension; cluster g walks pairs g, g + clusters, ..., and rank 0
//     writes the outputs. A launch the runtime refuses returns its code;
//     nothing falls back.

// The guarded snap (``cancelled``): where a Newton solve would stop on, or
// crawl from, an evaluation whose site likelihood has cancelled in the
// eigenbasis sum (near the lower bound, in f32), it backs off or doubles
// the length instead; without it such a pair stalled at its initial
// lengths, as the TPU kernel's still does (PERF.md).
//
// Built without --use_fast_math (tiny is FLT_MIN and the rollback test
// |new| * 1e-14 must stay as written) and with -fmad=false: the kernel
// then rounds every product and sum as its plain version
// (ops/blo_kernel.py::blo_newton_plain, which repeats both teams'
// reduction orders) does and agrees with it bit for bit, so a fault that
// touches a few pairs still shows. It also caps every instantiation at half
// the card's FMA rate: 2 x the operation bound at best. On the DNA main
// path's pairs, mul+add contraction saved about 4% of PR 1's kernel time,
// and it parts from the plain version, in f32 and in f64 alike, by up to
// a few logl units on about one pair in two thousand, where f32 is
// borderline (``python3 chip_smoke.py --fmad-ab``; PERF.md).
//
// The source is compiled five times, into libraries that build in
// parallel (one nvcc each): BLO_HAS_PINV 0 and 1 (without and with +I)
// times BLO_PART, the part of the instantiations a library holds
// (ops/blo_kernel.py::PARTS): 0 the 18 DNA ones (rate count 1-8 and
// runtime x sumtable home), 1 the K = 20 single-matrix ones (home x {up
// to 8 rates, cluster}) and 2, without +I only, the K = 20 mixture ones
// (the JAX package takes no +I with a mixture). A launch of another part
// returns -1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <type_traits>

#ifndef BLO_HAS_PINV
#define BLO_HAS_PINV 0
#endif
#define BLO_PART_DNA 0
#define BLO_PART_TEAM 1
#define BLO_PART_MIX 2
#ifndef BLO_PART
#error "BLO_PART selects the instantiations to build (0, 1 or 2)"
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
// K = 4: R = 1..MAX_R are compile-time instantiations (the rate loops
// unrolled), R > MAX_R one runtime-R instantiation (RC = 0, rolled). The
// DNA scalar tables at the head of shared memory, x_rk, wA, A, piA and
// x_rk^2, take RK + RK*K + 2*K*K + RK = 24*R + 32 floats: TAB_FLOATS for
// every compile-time instantiation (R = 8's), 24*R + 32 rounded up to 32
// beyond (416 at R = 16); ops/blo_kernel.py::_tab_bytes must match
constexpr int MAX_R = 8;
constexpr int TAB_FLOATS = 224;
static_assert(24 * MAX_R + 2 * K * K <= TAB_FLOATS, "scalar tables");

// threads per pair: DNA_TEAM at K = 4, TEAM at K = 20
// (ops/blo_kernel.py DNA_TEAM, WIDE_TEAM)
constexpr int DNA_TEAM = 128;
constexpr int DNA_WARPS = DNA_TEAM / WARP;
constexpr int TEAM = 256;
constexpr int TEAM_WARPS = TEAM / WARP;
// the compile-time instantiations' exponential rows are one lane an entry;
// the runtime-R one's lanes fill ceil(RK / 32) entries each
static_assert(K * MAX_R <= WARP, "a warp's lanes fill its exponential row");
// K = 20: (site, rate) units whose partial sums one barrier publishes: a
// chunk of RED_UNITS / R sites (RED_UNITS / TEAM tiles; past TEAM_WARPS
// rates a CTA's, of its TEAM_WARPS rates)
constexpr int RED_UNITS = 512;
static_assert(RED_UNITS % TEAM == 0, "a chunk holds whole tiles");
// K = 20 past TEAM_WARPS rates: CTAs of a cluster, TEAM_WARPS rates each
// (the most a portable cluster holds; ops/blo_kernel.py MAX_CLUSTER)
constexpr int MAX_CLUSTER = 8;
constexpr int SMEM_LIMIT_FLOATS = 232448 / 4;  // 227 KB a block may use

__host__ __device__ inline int round32(int n) { return (n + 31) / 32 * 32; }

// K = 4 scalar tables, in floats
__host__ __device__ inline int dna_tab_floats(int R) {
  const int n = round32(24 * R + 2 * K * K);
  return n > TAB_FLOATS ? n : TAB_FLOATS;
}

// K = 20: the CTAs of a pair's cluster (one up to TEAM_WARPS rates) and
// the rate slots of each, which size its tables, partials and T
__host__ __device__ inline int cluster_ctas(int R) {
  return (R + TEAM_WARPS - 1) / TEAM_WARPS;
}
__host__ __device__ inline int slice_rates(int R) {
  return R > TEAM_WARPS ? TEAM_WARPS : R;
}

__host__ __device__ inline int wide_tab_floats(int ns, int R, bool mix) {
  const int rk = R * ns;
  return round32(rk + rk * ns + (mix ? 2 * rk * ns : 2 * ns * ns));
}

// K = 4: floats per site of T, which is site-major ([width][stride]): the
// rows (RK sums, +I's pv), padded to 4 mod 8 floats, so that 8 threads on
// 8 consecutive sites read float4s from 32 distinct banks
__host__ __device__ constexpr int dna_t_stride(int rows) {
  const int padded = (rows + 3) / 4 * 4;
  return padded % 8 == 0 ? padded + 4 : padded;
}

// K = 4: the sites T holds, the width rounded up to a warp's 32: the
// runtime-R loops give every lane of a warp work while its first lane is
// in the span, so they write T up to the span rounded up to 32 sites
__host__ __device__ inline int dna_t_sites(int width) {
  return round32(width);
}

// Shared memory of a CTA, in floats, each region on a 32-float boundary
// (ops/blo_kernel.py::kernel_geometry must match), for R rate slots (at
// K = 20 past TEAM_WARPS rates a cluster CTA's slice_rates):
//   tables   x_rk [RK], wA [RK][NS], A and piA ([NS][NS], a mixture's
//            [RK][NS]) and at K = 4 x_rk^2 [RK]: dna_tab_floats at K = 4,
//            wide_tab_floats at K = 20
//   exps     two rows per warp, e^{x t}: at K = 4 the RK exponentials, 32
//            floats or RK rounded up to 32; at K = 20 32 floats
//   red      K = 20: [2][3][RED_UNITS] per-unit partial sums, one buffer
//            per chunk parity
//   slots    [2][2][warps] warp sums, one buffer per reduction parity; at
//            K = 4 then [2] ints, the next pair's index, and max |x_rk|
//   T        [RK (+1)][width] at K = 20, [dna_t_sites(width)]
//            [dna_t_stride(RK (+1))] at K = 4 (in t_scratch instead:
//            GLOBAL_T, one slice of that size per CTA)
struct TeamLayout {
  int exps, erow, red, slots, t, t_end;
  __host__ __device__ TeamLayout(int ns, int R, bool mix, bool pinv,
                                 int width) {
    const int rk = R * ns;
    const int warps = ns == K ? DNA_WARPS : TEAM_WARPS;
    exps = ns == K ? dna_tab_floats(R) : wide_tab_floats(ns, R, mix);
    erow = ns == K && rk > WARP ? round32(rk) : WARP;
    red = exps + warps * 2 * erow;
    slots = red + (ns == K ? 0 : 2 * 3 * RED_UNITS);
    t = slots + round32(2 * 2 * warps + (ns == K ? 3 : 0));
    const int rows = rk + (pinv ? 1 : 0);
    t_end = t + round32(ns == K ? dna_t_stride(rows) * dna_t_sites(width)
                                : rows * width);
  }
};

// The guarded snap (ops/newton.py::cancelled): the Newton evaluation at x
// has cancelled where |d1| * x exceeds 1 + lam_span * x (lam_span: the
// fastest eigen rate max|x_j| times the pair's span), or is NaN. A site
// likelihood adds at most ~2/t to d1 near t = 0 and at least -max|x_j|,
// and a solve stops only where d1 is balanced or points into a bound, well
// inside that; past it a site likelihood has cancelled in the eigenbasis
// sum (f32: terms up to 1e8 times larger), and a stop there would leave
// the length at or near its lower bound and the smoothing would roll the
// pair back to its initial lengths. Such a stop is not taken: the iterate
// backs off halfway to x_hi, the last point evaluated soundly with d1 < 0.
// Nor is such an evaluation's crawling step (d1 > 0, d2 < 0, under x / 8:
// a sound one near the bound at least doubles x, and the crawl would spend
// the solve's iterations): x doubles instead.
__device__ __forceinline__ bool cancelled(float d1, float x,
                                          float lam_span) {
  return !(fabsf(d1) * x <= 1.0f + lam_span * x);
}

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: lane i adds v_i + v_{i^m}, lane i^m adds v_{i^m} + v_i,
  // which is the same float, so every lane ends with the identical total
#pragma unroll
  for (int m = WARP / 2; m > 0; m >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, m);
  }
  return v;
}

// N sums over a team of WARPS warps, returned in every thread: each
// thread's value (its sites, in order), the warp's xor butterfly, then the
// warps in a fixed tree (a[i] += a[i + h], h = WARPS/2 .. 1), every thread
// reading the same slots (ops/blo_kernel.py::team_site_sum repeats it).
// ``slots`` holds two buffers of [2][WARPS] that alternate (``sbuf``), so
// one barrier per reduction suffices.
template <int WARPS, int N>
__device__ void team_sum(float (&v)[N], float* slots,
                         int& sbuf, int tid) {
  static_assert(N <= 2, "two sums a reduction");
  float* s = slots + sbuf * 2 * WARPS;
  sbuf ^= 1;
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
  if (tid % WARP == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) s[n * WARPS + tid / WARP] = v[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float a[WARPS];
#pragma unroll
    for (int i = 0; i < WARPS; ++i) a[i] = s[n * WARPS + i];
#pragma unroll
    for (int h = WARPS / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int i = 0; i < h; ++i) a[i] = a[i] + a[i + h];
    }
    v[n] = a[0];
  }
}

// RC: the rate count, 1..MAX_R at compile time, or 0: R > MAX_R at run time
// (``nr``; the rate loops rolled, the exponential rows filled in strides)
template <int RC, bool HAS_PINV, bool GLOBAL_T>
struct DnaTeamCtx {
  static constexpr bool RUNTIME_R = RC == 0;
  static constexpr int TSC = dna_t_stride(RC * K + (HAS_PINV ? 1 : 0));
  const float* __restrict__ tu;  // tU row block of this pair's edge [RK, S]
  const float* __restrict__ tv;
  const float* __restrict__ tq;  // tQ row block of this pair's query [K, S]
  const float* __restrict__ iq;  // invq row of this pair's query [S] (+I)
  const float* __restrict__ ls;  // ls row of this pair's edge [S] (+I)
  int S;
  int nr;                        // rates (RUNTIME_R)
  int begin;
  int span;
  int tid;
  int lane;
  int sbuf;                      // slot buffer of the next reduction
  float omp;                     // 1 - pinv (+I)
  float* T;                      // [width][TS], this CTA's
  float* E0;                     // [32 | RK] shared, this warp's exponential
  float* E1;                     //   rows
  float* slots;                  // [2][2][DNA_WARPS] shared, then [2] ints
                                 // (the next pair) and max |x_rk| at LAM
  static constexpr int LAM = 2 * 2 * DNA_WARPS + 2;
  // shared, each on a 16-byte boundary (RK is a multiple of 4)
  const float* xrk;              // [RK]
  const float* x2;               // [RK] x_rk * x_rk
  const float* wA;               // [RK][K]
  const float* A;                // [K][K]
  const float* piA;              // [K][K]

  __device__ __forceinline__ int rates() const {
    if constexpr (RUNTIME_R) {
      return nr;
    } else {
      return RC;
    }
  }
  __device__ __forceinline__ int rk() const { return rates() * K; }
  // floats of T a site
  __device__ __forceinline__ int ts() const {
    if constexpr (RUNTIME_R) {
      return dna_t_stride(rk() + (HAS_PINV ? 1 : 0));
    } else {
      return TSC;
    }
  }

  // f(r) for the rates r = 0 .. RC-1 in order: unrolled with T in shared
  // memory; one at a time with T in device memory, where the unrolled
  // rates' float4 loads in flight take every register and spill (a
  // runtime rate count takes the site-blocked loops below instead)
  template <class F>
  __device__ __forceinline__ void for_rates(F f) const {
    if constexpr (GLOBAL_T) {
#pragma unroll 1
      for (int r = 0; r < rates(); ++r) f(r);
    } else {
#pragma unroll
      for (int r = 0; r < RC; ++r) f(r);
    }
  }

  // E[j] = exp(x_j t) (1 on the zero-eigenvalue lanes, never read) in
  // this warp's row, lane j filling entry j (and j + 32, ... at a runtime
  // rate count). The first __syncwarp lets every lane finish reading the
  // previous values, the second publishes the new ones. Rate r's four
  // entries are float4 r.
  __device__ __forceinline__ const float4* exps(float t, float* E) const {
    __syncwarp();
    if constexpr (RUNTIME_R) {
      for (int j = lane; j < rk(); j += WARP) {
        E[j] = (j % K == K - 1) ? 1.0f : expf(xrk[j] * t);
      }
    } else {
      if (lane < RC * K) {
        E[lane] = (lane % K == K - 1) ? 1.0f : expf(xrk[lane] * t);
      }
    }
    __syncwarp();
    return reinterpret_cast<const float4*>(E);
  }

  // window site w of T: rate r's four sums are float4 r, the +I pv
  // follows them
  __device__ __forceinline__ float4* site(int w) const {
    return reinterpret_cast<float4*>(T + w * ts());
  }

  // h[i] = sum_k coef[i][k] * x[k] (sequential in k, as _blo_compute),
  // each row of coef one float4
  __device__ __forceinline__ static void back(const float4* coef,
                                              const float* x, float* h) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float4 c = coef[i];
      float acc = c.x * x[0];
      acc += c.y * x[1];
      acc += c.z * x[2];
      acc += c.w * x[3];
      h[i] = acc;
    }
  }

  // (T[r*K+k])_k = sum_i p[i][k] * hA[i] * hB[i] (sequential in i), each
  // row of p (piA) one float4
  __device__ __forceinline__ static float4 contract(const float4* p,
                                                    const float* hA,
                                                    const float* hB) {
    float4 c = p[0];
    float h = hA[0] * hB[0];
    float4 acc = make_float4(c.x * h, c.y * h, c.z * h, c.w * h);
#pragma unroll
    for (int i = 1; i < K; ++i) {
      c = p[i];
      h = hA[i] * hB[i];
      acc.x += c.x * h;
      acc.y += c.y * h;
      acc.z += c.z * h;
      acc.w += c.w * h;
    }
    return acc;
  }

  // the +I entry of T: pv = exp(invq - ls) at the thread's sites of the
  // span, once per pair (one exponential of the difference, as the JAX
  // package's parallel/mesh.py does; an invq of -inf gives 0). Never read
  // beyond the span, like every other entry.
  __device__ void fill_pv() {
    for (int w = tid; w < span; w += DNA_TEAM) {
      const int s = begin + w;
      T[w * ts() + rk()] = expf(iq[s] - ls[s]);
    }
  }

  // the site likelihood from the eigen-sum f at window site w
  __device__ __forceinline__ float site_g(float f, int w) const {
    if constexpr (HAS_PINV) {
      return omp * f + T[w * ts() + rk()];
    } else {
      return f;
    }
  }

  // one rate's four sums at one site: contract(wr-bt(u e^{x la}), a-bt(v
  // e^{x lb})) * o with p, for the rate's wA rows wr, A's rows a and
  // piA's rows p, the site's window entries u, v and o, and the rate's
  // exponentials ea, eb (the zero lane's not applied)
  __device__ __forceinline__ static float4 sums(const float4* wr,
                                                const float4* a,
                                                const float4* p, float* u,
                                                float* v, const float* o,
                                                float4 ea, float4 eb) {
    float hU[K], hV[K];
    u[0] *= ea.x;
    u[1] *= ea.y;
    u[2] *= ea.z;
    v[0] *= eb.x;
    v[1] *= eb.y;
    v[2] *= eb.z;
    back(wr, u, hU);
    back(a, v, hV);
    const float4 c = contract(p, hU, hV);
    return make_float4(c.x * o[0], c.y * o[1], c.z * o[2], c.w * o[3]);
  }

  // rate r's four sums at site s, the tables read from shared memory, with
  // a and b the rate's four rows (row stride S)
  __device__ __forceinline__ float4 build_rate(const float* a,
                                               const float* b,
                                               const float* o, int s,
                                               int r, float4 ea,
                                               float4 eb) const {
    float u[K], v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      u[k] = a[k * S + s];
      v[k] = b[k * S + s];
    }
    return sums(reinterpret_cast<const float4*>(wA) + r * K,
                reinterpret_cast<const float4*>(A),
                reinterpret_cast<const float4*>(piA), u, v, o, ea, eb);
  }

  // ---- RC = 0 (a runtime rate count): site-blocked loops. A thread takes
  // its sites w0, w0 + DNA_TEAM, ... in blocks of up to SB rows, keeps
  // each row's sums in registers and walks the rates outer, so a rate's
  // exponentials, x_rk and x_rk^2 (a build's wA row and exponentials) load
  // once for the block's rows; Newton evaluations and scores in unrolled
  // chunks of CH rates and the remainder one at a time. Each site still
  // adds its rates in order, and the thread its sites in order.
  static constexpr int SB = 2;
  static constexpr int CH = 4;

  // the rows of the block at w0 that this warp holds in the span: its
  // first site's, the same in every lane (so no lane diverges); a lane
  // past the span in the last row computes on entries it never adds (T
  // up to the span rounded up to 32 sites, which dna_t_sites makes T
  // hold whatever the width) and a build clamps its window reads to the
  // span
  __device__ __forceinline__ int rows(int w0) const {
    const int n = (span - (w0 - lane) + DNA_TEAM - 1) / DNA_TEAM;
    return n < SB ? n : SB;
  }

  // f(integral_constant N) for N = rows(w0), 1 or SB
  static_assert(SB == 2, "with_rows takes blocks of one or two rows");
  template <class F>
  __device__ __forceinline__ void with_rows(int w0, F f) const {
    if (rows(w0) == 1) {
      f(std::integral_constant<int, 1>{});
    } else {
      f(std::integral_constant<int, SB>{});
    }
  }

  // g(r) for r = 0 .. R-1 in order: unrolled chunks of CH, then the rest
  template <class G>
  __device__ __forceinline__ void rate_chunks(G g) const {
    const int R = nr;
    int r = 0;
#pragma unroll 1
    for (; r + CH <= R; r += CH) {
#pragma unroll
      for (int c = 0; c < CH; ++c) g(r + c);
    }
#pragma unroll 1
    for (; r < R; ++r) g(r);
  }

  // the float4s between a thread's rows of T
  __device__ __forceinline__ int row_stride() const {
    return ts() / 4 * DNA_TEAM;
  }

  // the pendant (t1) or distal (t2) sumtable, site-blocked: t1 reads tU
  // (exponentials EA) and tV (EB) and multiplies by tQ; t2 reads tU and
  // the query tip tQ (EB) and multiplies by tV; A and piA in registers for
  // the whole build, a rate's wA row and exponentials once per block
  template <bool T2>
  __device__ void build_blocked(const float4* EA, const float4* EB) {
    float4 a4[K], p4[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      a4[i] = reinterpret_cast<const float4*>(A)[i];
      p4[i] = reinterpret_cast<const float4*>(piA)[i];
    }
    const float4* W4 = reinterpret_cast<const float4*>(wA);
    const int stride = row_stride();
    for (int w0 = tid; w0 - lane < span; w0 += SB * DNA_TEAM) {
      with_rows(w0, [&](auto n) {
        constexpr int N = decltype(n)::value;
        int s[N];
        float q[N][K];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          s[i] = begin + min(w0 + i * DNA_TEAM, span - 1);
#pragma unroll
          for (int k = 0; k < K; ++k) q[i][k] = tq[k * S + s[i]];
        }
        float4* t = site(w0);
#pragma unroll 1
        for (int r = 0; r < nr; ++r) {
          const float4 ea = EA[r], eb = EB[r];
          const float4 wr[K] = {W4[r * K], W4[r * K + 1], W4[r * K + 2],
                                W4[r * K + 3]};
          const float* a = tu + r * K * S;
          const float* b = tv + r * K * S;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            float u[K], v[K], o[K];
#pragma unroll
            for (int k = 0; k < K; ++k) {
              u[k] = a[k * S + s[i]];
              v[k] = T2 ? q[i][k] : b[k * S + s[i]];
              o[k] = T2 ? b[k * S + s[i]] : q[i][k];
            }
            t[i * stride + r] = sums(wr, a4, p4, u, v, o, ea, eb);
          }
        }
      });
    }
  }

  // a Newton evaluation's per-thread sums d1, d2 (d[0], d[1]) at the
  // exponentials E, site-blocked
  __device__ __forceinline__ void newton_blocked(const float4* E,
                                                 float (&d)[2]) const {
    const float4* X = reinterpret_cast<const float4*>(xrk);
    const float4* X2 = reinterpret_cast<const float4*>(x2);
    const int stride = row_stride();
    for (int w0 = tid; w0 - lane < span; w0 += SB * DNA_TEAM) {
      with_rows(w0, [&](auto n) {
        constexpr int N = decltype(n)::value;
        const float4* t = site(w0);
        float f0[N], f1[N], f2[N];
#pragma unroll
        for (int i = 0; i < N; ++i) f0[i] = f1[i] = f2[i] = 0.0f;
        rate_chunks([&](int r) {
          const float4 e = E[r], xr = X[r], xx = X2[r];
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float4 tr = t[i * stride + r];
            lane_terms(tr.x, e.x, xr.x, xx.x, f0[i], f1[i], f2[i]);
            lane_terms(tr.y, e.y, xr.y, xx.y, f0[i], f1[i], f2[i]);
            lane_terms(tr.z, e.z, xr.z, xx.z, f0[i], f1[i], f2[i]);
            f0[i] += tr.w;
          }
        });
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int w = w0 + i * DNA_TEAM;
          if (w < span) site_derivs(f0[i], f1[i], f2[i], w, d);
        }
      });
    }
  }

  // a score's per-thread sum of log site likelihoods at the exponentials
  // E, site-blocked
  __device__ __forceinline__ float score_blocked(const float4* E) const {
    const int stride = row_stride();
    float acc = 0.0f;
    for (int w0 = tid; w0 - lane < span; w0 += SB * DNA_TEAM) {
      with_rows(w0, [&](auto n) {
        constexpr int N = decltype(n)::value;
        const float4* t = site(w0);
        float f[N];
#pragma unroll
        for (int i = 0; i < N; ++i) f[i] = 0.0f;
        rate_chunks([&](int r) {
          const float4 e = E[r];
#pragma unroll
          for (int i = 0; i < N; ++i) {
            const float4 tr = t[i * stride + r];
            f[i] += tr.x * e.x;
            f[i] += tr.y * e.y;
            f[i] += tr.z * e.z;
            f[i] += tr.w;
          }
        });
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const int w = w0 + i * DNA_TEAM;
          if (w < span) acc += logf(fmaxf(site_g(f[i], w), FLT_MIN));
        }
      });
    }
    return acc;
  }

  // pendant sumtable at edge lengths (lp, ld): T1 of _blo_compute.build_T
  __device__ void build_t1(float lp, float ld) {
    const float4* EU = exps(lp, E0);
    const float4* EV = exps(ld, E1);
    if constexpr (RUNTIME_R) {
      build_blocked<false>(EU, EV);
    } else {
      for (int w = tid; w < span; w += DNA_TEAM) {
        const int s = begin + w;
        float q[K];
#pragma unroll
        for (int k = 0; k < K; ++k) q[k] = tq[k * S + s];
        float4* t = site(w);
        for_rates([&](int r) {
          // a barrier for the compiler only, at every other rate: it keeps
          // ptxas from hoisting all R rates' window loads to the head of the
          // site, which takes 150-165 registers (PERF.md)
          if (r % 2 == 0) asm volatile("" ::: "memory");
          t[r] = build_rate(tu + r * K * S, tv + r * K * S, q, s, r, EU[r],
                            EV[r]);
        });
      }
    }
  }

  // distal sumtable: proximal CLV x pendant-scaled query tip, times tV
  __device__ void build_t2(float lprox, float lpend) {
    const float4* EU = exps(lprox, E0);
    const float4* EQ = exps(lpend, E1);
    if constexpr (RUNTIME_R) {
      build_blocked<true>(EU, EQ);
    } else {
      for (int w = tid; w < span; w += DNA_TEAM) {
        const int s = begin + w;
        float4* t = site(w);
        for_rates([&](int r) {
          if (r % 2 == 0) asm volatile("" ::: "memory");
          float o[K];
#pragma unroll
          for (int k = 0; k < K; ++k) o[k] = tv[(r * K + k) * S + s];
          t[r] = build_rate(tu + r * K * S, tq, o, s, r, EU[r], EQ[r]);
        });
      }
    }
  }

  // masked log-likelihood (scaled space) from T at pendant length lq; per
  // site the RK lanes in j order, the zero lanes adding T alone
  __device__ float score(float lq) {
    const float4* E = exps(lq, E0);
    float acc[1] = {0.0f};
    if constexpr (RUNTIME_R) {
      acc[0] = score_blocked(E);
    } else {
      for (int w = tid; w < span; w += DNA_TEAM) {
        const float4* t = site(w);
        float f = 0.0f;
        for_rates([&](int r) {
          const float4 tr = t[r], e = E[r];
          f += tr.x * e.x;
          f += tr.y * e.y;
          f += tr.z * e.z;
          f += tr.w;
        });
        acc[0] += logf(fmaxf(site_g(f, w), FLT_MIN));
      }
    }
    team_sum<DNA_WARPS>(acc, slots, sbuf, tid);
    return acc[0];
  }

  // a site's terms of d1 and d2 from its eigen-sums f0, f1, f2 (+I: g =
  // omp f0 + pv, r1 = (omp f1) / g, f2 -> omp f2, in _blo_compute's order
  // of operations)
  __device__ __forceinline__ void site_derivs(float f0, float f1, float f2,
                                              int w, float (&d)[2]) const {
    const float g = fmaxf(site_g(f0, w), FLT_MIN);
    const float inv_g = 1.0f / g;
    if constexpr (HAS_PINV) {
      f1 = omp * f1;
      f2 = omp * f2;
    }
    const float r1 = f1 * inv_g;
    d[0] += r1;
    d[1] += f2 * inv_g - r1 * r1;
  }

  // a non-zero lane's terms of f0, f1, f2 (x2 = x * x)
  __device__ __forceinline__ static void lane_terms(float t, float e,
                                                    float x, float x2,
                                                    float& f0, float& f1,
                                                    float& f2) {
    const float tE = t * e;
    f0 += tE;
    f1 += tE * x;
    f2 += tE * x2;
  }

  // safeguarded Newton on dlogl/dt over T (see _blo_compute.newton);
  // adds the iterations it executes to ``iters``
  __device__ float newton(float xmin, float xmax, float xtol, float guess,
                          int& iters) {
    float x = fminf(fmaxf(guess, xmin), xmax);
    float x_hi = x;      // the last point evaluated soundly with d1 < 0
    float slid = 0.0f;
    bool done = false;
    for (int it = 0; it < MAX_ITERS && !done; ++it) {
      ++iters;
      const float4* E = exps(x, E0);
      float d[2] = {0.0f, 0.0f};
      if constexpr (RUNTIME_R) {
        newton_blocked(E, d);
      } else {
        const float4* X = reinterpret_cast<const float4*>(xrk);
        const float4* X2 = reinterpret_cast<const float4*>(x2);
        for (int w = tid; w < span; w += DNA_TEAM) {
          const float4* t = site(w);
          float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
          for_rates([&](int r) {
            const float4 tr = t[r], e = E[r], xr = X[r], xx = X2[r];
            lane_terms(tr.x, e.x, xr.x, xx.x, f0, f1, f2);
            lane_terms(tr.y, e.y, xr.y, xx.y, f0, f1, f2);
            lane_terms(tr.z, e.z, xr.z, xx.z, f0, f1, f2);
            f0 += tr.w;  // zero-eigenvalue lane: x_j == 0 exactly
          });
          site_derivs(f0, f1, f2, w, d);
        }
      }
      team_sum<DNA_WARPS>(d, slots, sbuf, tid);
      const float d1 = d[0];
      const float d2 = d[1];
      const float newton_x = x - d1 / (d2 == 0.0f ? 1.0f : d2);
      const float dirn = d1 > 0.0f ? 1.0f : -1.0f;
      const bool snap = (d2 >= 0.0f) && (slid * dirn > 0.0f);
      const float bound = d1 > 0.0f ? xmax : xmin;
      const float slide =
          snap ? bound : (d1 > 0.0f ? (x + xmax) / 2.0f : (x + xmin) / 2.0f);
      float xn =
          fminf(fmaxf(d2 < 0.0f ? newton_x : slide, xmin), xmax);
      slid = d2 < 0.0f ? 0.0f : dirn;
      done = (fabsf(xn - x) < xtol) || (fabsf(d1) <= D1_EPSILON) ||
             ((d2 < 0.0f) && (d1 * d1 <= GAIN_EPSILON * -d2));
      const bool bad =
          cancelled(d1, x, slots[LAM] * static_cast<float>(span));
      if (bad && !done && d1 > 0.0f && d2 < 0.0f && xn - x < x * 0.125f) {
        // a cancelled evaluation's step crawls (under x / 8, where a
        // sound one near the bound at least doubles x): double x
        xn = fminf(x + x, xmax);
        slid = 0.0f;
      }
      if (done && bad && x < x_hi) {
        done = false;
        xn = (x_hi + x) * 0.5f;
        slid = 0.0f;
      }
      if (!bad && d1 < 0.0f) x_hi = x;
      x = xn;
    }
    return x;
  }
};

// out: logl, pendant, distal, proximal, done; counts: smoothings, Newton
// iterations executed by this pair. Ctx is DnaTeamCtx (K = 4) or TeamCtx
// (K = 20); every thread of the team returns the same values, its sums
// being the team's.
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

// K = 4 with RC rate categories (0: ``num_rates``, more than MAX_R): CTA b
// takes pair b first (the grid is what the SMs hold at once), then the next
// untaken pair, gridDim.x + atomicAdd(next_pair, 1), until none is left,
// every thread of the team holding the same p. ``next_pair`` is 0 at
// launch. GLOBAL_T: T in t_scratch, one slice per
// CTA. At most 128 registers a thread with T in shared memory below R = 7
// (4 CTAs an SM) and 168 at the runtime rate count (3 CTAs an SM, as many
// as its shared memory holds at width 256 and R = 16); R = 7-8 and the
// device home take what they need, without spill.
template <int RC, bool GLOBAL_T, bool HAS_PINV>
__global__ void __launch_bounds__(DNA_TEAM,
                                  GLOBAL_T || RC > 6 ? 1 : RC == 0 ? 3 : 4)
blo_newton_dna_kernel(const float* __restrict__ tU,
                      const float* __restrict__ tV,
                      const float* __restrict__ tQ, int S, int num_rates,
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
                      int* __restrict__ next_pair,
                      float* __restrict__ out_logl,
                      float* __restrict__ out_pendant,
                      float* __restrict__ out_distal,
                      float* __restrict__ out_proximal,
                      float* __restrict__ out_done,
                      int* __restrict__ out_smoothings,
                      int* __restrict__ out_iters) {
  static_assert(RC <= MAX_R, "rate categories");
  const int R = RC ? RC : num_rates;
  const int RK = R * K;
  const TeamLayout L(K, R, false, HAS_PINV, width);
  extern __shared__ __align__(16) float dna_smem[];
  float* smem = dna_smem;
  float* s_x = smem;                 // [RK]
  float* s_wA = s_x + RK;            // [RK * K]
  float* s_A = s_wA + RK * K;        // [K * K]
  float* s_piA = s_A + K * K;        // [K * K]
  float* s_x2 = s_piA + K * K;       // [RK]
  for (int i = threadIdx.x; i < RK; i += DNA_TEAM) {
    s_x[i] = x_rk[i];
    s_x2[i] = x_rk[i] * x_rk[i];
  }
  for (int i = threadIdx.x; i < RK * K; i += DNA_TEAM) s_wA[i] = wA[i];
  for (int i = threadIdx.x; i < K * K; i += DNA_TEAM) {
    s_A[i] = A[i];
    s_piA[i] = piA[i];
  }
  if (threadIdx.x == 0) {
    // max |x_rk|, the fastest eigen rate (the guarded snap), in shared
    // memory after the next-pair ints: a register less through the solve
    float lam = 0.0f;
    for (int i = 0; i < RK; ++i) lam = fmaxf(lam, fabsf(x_rk[i]));
    smem[L.slots + DnaTeamCtx<RC, HAS_PINV, GLOBAL_T>::LAM] = lam;
  }
  __syncthreads();

  const int tid = threadIdx.x;
  DnaTeamCtx<RC, HAS_PINV, GLOBAL_T> c;
  c.S = S;
  c.nr = R;
  c.tid = tid;
  c.lane = tid % WARP;
  c.omp = HAS_PINV ? omp[0] : 1.0f;
  c.iq = nullptr;
  c.ls = nullptr;
  c.E0 = smem + L.exps + (tid / WARP) * 2 * L.erow;
  c.E1 = c.E0 + L.erow;
  c.slots = smem + L.slots;
  // the next pair's index, two buffers (after the warp slots)
  int* s_next = reinterpret_cast<int*>(smem + L.slots + 2 * 2 * DNA_WARPS);
  if constexpr (GLOBAL_T) {
    c.T = t_scratch +
          static_cast<size_t>(blockIdx.x) * c.ts() * dna_t_sites(width);
  } else {
    c.T = smem + L.t;
  }
  c.xrk = s_x;
  c.x2 = s_x2;
  c.wA = s_wA;
  c.A = s_A;
  c.piA = s_piA;
  // the counters are optional (null: off); the branch is uniform over the
  // grid, so it costs no divergence
  const bool count = out_iters != nullptr;

  for (int p = blockIdx.x, i = 0; p < P; ++i) {
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
      c.sbuf = 0;
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
      s_next[i & 1] = gridDim.x + atomicAdd(next_pair, 1);
    }
    // publishes the next pair; it also keeps the next pair's first
    // reduction from writing slots that a thread still reads
    __syncthreads();
    p = s_next[i & 1];
  }
}

// ---------------------------------------------------------------------------
// K = 20 (protein), one substitution matrix or a matrix mixture (LG4M/LG4X):
// a team of TEAM threads per pair in one persistent CTA, or past TEAM_WARPS
// rates one in each CTA of a cluster (the design is in the header).

// the cluster's PTX (cooperative_groups' this_cluster(), sync() and
// map_shared_rank() are these instructions): this CTA's rank in its
// cluster, a barrier of every thread of every CTA (arrive releases, wait
// acquires: their default semantics), and the generic address of *p in
// the shared memory of the cluster's CTA ``rank`` (mapa)
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n\t"
      "barrier.cluster.wait.aligned;" ::: "memory");
}
__device__ __forceinline__ const float* cluster_map(const float* p,
                                                    int rank) {
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;"
      : "=l"(out)
      : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// CLUSTER: more than TEAM_WARPS rates, this CTA of the pair's cluster
// holding the rates [r0, r0 + R) of ``rates`` (its own tables, rows of T
// and partial sums; a build of its own, so the instantiations up to 8
// rates keep their code)
template <int NS, bool MIX, bool HAS_PINV, bool CLUSTER>
struct TeamCtx {
  // the pair's window rows in device memory (row stride ld = S, site w at
  // column begin + w; with CLUSTER from this CTA's first rate on)
  const float* wu;               // [RK] rows of tU
  const float* wv;               // [RK] rows of tV
  const float* wq;               // [NS|RK] rows of tQ
  int ld;
  int R;                         // rates this CTA holds
  int rates;                     // CLUSTER: the pair's rate count
  int rank;                      // CLUSTER: this CTA's rank in the cluster
  int rc;                        // units of a partial-sum array
  int span;
  int width;                     // T row stride (>= span)
  int tile;                      // sites per tile: 32 x the warps of a rate
  int chunk;                     // sites per barrier: RED_UNITS / TEAM tiles
  int tid;
  int lane;
  int rate;                      // this warp's rate (>= R: idle)
  int site;                      // this thread's site within a tile
  int sbuf;                      // slot buffer of the next reduction
  int pbuf;                      // CLUSTER: partials buffer of the next chunk
  float omp;                     // 1 - pinv (+I)
  float lam;                     // max |x_rk|, the fastest eigen rate
  float* T;                      // [R * NS (+1)][width]
  float* E0;                     // [32] shared, this warp's exponential
  float* E1;                     //   rows
  float* red;                    // [2][3][RED_UNITS] shared
  float* slots;                  // [2][2][TEAM_WARPS] shared
  const float* xrk;              // [RK]         shared (this CTA's rates)
  const float* wA;               // [RK][NS]     shared
  const float* A;                // [NS|RK][NS]  shared
  const float* piA;              // [NS|RK][NS]  shared

  // E[k] = exp(x_{rate*NS+k} t) (1 on the zero-eigenvalue lane, never
  // read): the warp's own row, lane k filling entry k. The first __syncwarp
  // lets every lane finish reading the previous values, the second
  // publishes the new ones; no block barrier.
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

  // publishes a chunk's partial sums: to the CTA, or with CLUSTER to every
  // CTA of the cluster
  __device__ __forceinline__ static void publish() {
    if constexpr (CLUSTER) {
      cluster_sync();
    } else {
      __syncthreads();
    }
  }

  // unit u's sums over the rates, r = 0..R-1 in order, of the N partial
  // arrays at ``part`` (stride rc): with CLUSTER over every CTA's rates,
  // rate r's partial read from CTA r / TEAM_WARPS (DSMEM; each CTA's
  // TEAM_WARPS loaded at once, then added in order)
  template <int N>
  __device__ __forceinline__ void rate_sums(const float* part, int u,
                                            float (&f)[N]) const {
    if constexpr (CLUSTER) {
      for (int c = 0, r = 0; r < rates; ++c) {
        const float* p = c == rank ? part : cluster_map(part, c);
        float v[N][TEAM_WARPS];
#pragma unroll
        for (int j = 0; j < TEAM_WARPS; ++j) {
#pragma unroll
          for (int n = 0; n < N; ++n) {
            v[n][j] = r + j < rates ? p[n * rc + j * chunk + u] : 0.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < TEAM_WARPS; ++j, ++r) {
          if (r < rates) {
#pragma unroll
            for (int n = 0; n < N; ++n) {
              f[n] = r == 0 ? v[n][j] : f[n] + v[n][j];
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) f[n] = part[n * rc + u];
      for (int r = 1; r < R; ++r) {
#pragma unroll
        for (int n = 0; n < N; ++n) f[n] += part[n * rc + r * chunk + u];
      }
    }
  }

  // T1 (T2 false): contract(wA-bt(tU e^{x la}), A-bt(tV e^{x lb})) * tQ
  // T2 (T2 true):  contract(wA-bt(tU e^{x la}), A-bt(tQ e^{x lb})) * tV
  // Each thread builds the units (its warp's rate, sites site, site +
  // tile, ...); the barrier at the end publishes T (each CTA's own).
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

  // masked log-likelihood (scaled space) from T at pendant length lq: per
  // chunk, each unit's sum over its 20 eigen lanes (k order) into red, a
  // barrier, then thread t adds the rates of its sites t, t + tile, ... in
  // order r = 0..R-1. The partials alternate between two buffers, so one
  // barrier per chunk suffices; with CLUSTER the alternation runs on
  // across evaluations, since another CTA's reducers may still read this
  // CTA's last chunk when the next evaluation begins.
  __device__ float score(float lq) {
    exps(lq, E0);
    float acc[1] = {0.0f};
    int buf = CLUSTER ? pbuf : 0;
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
      publish();
      if (tid < tile) {
        for (int ws = base + tid; ws < end; ws += tile) {
          float f[1];
          rate_sums(part, ws - base, f);
          acc[0] += logf(fmaxf(site_g(f[0], ws), FLT_MIN));
        }
      }
    }
    if constexpr (CLUSTER) pbuf = buf;
    team_sum<TEAM_WARPS>(acc, slots, sbuf, tid);
    return acc[0];
  }

  // safeguarded Newton, PairCtx::newton's step over the team's sums: f0,
  // f1, f2 per unit (k order; the zero lane adds to f0 only), the rates in
  // order per site, then d1 and d2 over the sites in one reduction
  __device__ float newton(float xmin, float xmax, float xtol, float guess,
                          int& iters) {
    float x = fminf(fmaxf(guess, xmin), xmax);
    float x_hi = x;      // the last point evaluated soundly with d1 < 0
    float slid = 0.0f;
    bool done = false;
    // the rate's exponent lanes, in registers for the whole solve
    float xs[NS - 1];
#pragma unroll
    for (int k = 0; k < NS - 1; ++k) {
      xs[k] = rate < R ? xrk[rate * NS + k] : 0.0f;
    }
    int buf = CLUSTER ? pbuf : 0;
    for (int it = 0; it < MAX_ITERS && !done; ++it) {
      ++iters;
      exps(x, E0);
      float d[2] = {0.0f, 0.0f};
      if constexpr (!CLUSTER) buf = 0;
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
        publish();
        if (tid < tile) {
          for (int ws = base + tid; ws < end; ws += tile) {
            float f[3];
            rate_sums(part, ws - base, f);
            const float g = fmaxf(site_g(f[0], ws), FLT_MIN);
            const float inv_g = 1.0f / g;
            float f1 = f[1], f2 = f[2];
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
      team_sum<TEAM_WARPS>(d, slots, sbuf, tid);
      const float d1 = d[0];
      const float d2 = d[1];
      const float newton_x = x - d1 / (d2 == 0.0f ? 1.0f : d2);
      const float dirn = d1 > 0.0f ? 1.0f : -1.0f;
      const bool snap = (d2 >= 0.0f) && (slid * dirn > 0.0f);
      const float bound = d1 > 0.0f ? xmax : xmin;
      const float slide =
          snap ? bound : (d1 > 0.0f ? (x + xmax) / 2.0f : (x + xmin) / 2.0f);
      float xn =
          fminf(fmaxf(d2 < 0.0f ? newton_x : slide, xmin), xmax);
      slid = d2 < 0.0f ? 0.0f : dirn;
      done = (fabsf(xn - x) < xtol) || (fabsf(d1) <= D1_EPSILON) ||
             ((d2 < 0.0f) && (d1 * d1 <= GAIN_EPSILON * -d2));
      const bool bad = cancelled(d1, x, lam * static_cast<float>(span));
      if (bad && !done && d1 > 0.0f && d2 < 0.0f && xn - x < x * 0.125f) {
        // a cancelled evaluation's step crawls (under x / 8, where a
        // sound one near the bound at least doubles x): double x
        xn = fminf(x + x, xmax);
        slid = 0.0f;
      }
      if (done && bad && x < x_hi) {
        done = false;
        xn = (x_hi + x) * 0.5f;
        slid = 0.0f;
      }
      if (!bad && d1 < 0.0f) x_hi = x;
      x = xn;
    }
    if constexpr (CLUSTER) pbuf = buf;
    return x;
  }
};

// K = NS states with a runtime rate count R: CTA b takes pairs b, b + grid,
// ... (the grid is what the SMs hold at once), every thread of the team
// holding the same p, so no thread diverges on it. GLOBAL_T: T in
// t_scratch, one slice per CTA. CLUSTER: R > TEAM_WARPS, a cluster of
// cluster_ctas(R) CTAs per pair (launched with its dimension at run time),
// cluster g taking pairs g, g + clusters, ..., and its CTA of rank c
// holding the rates [8c, min(8c + 8, R)); a cluster barrier ends every
// pair.
template <int NS, bool MIX, bool GLOBAL_T, bool HAS_PINV, bool CLUSTER>
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
  // the launch's cluster dimension is cluster_ctas(R) (launch_team)
  int rank = 0, ctas = 1;
  if constexpr (CLUSTER) {
    rank = cluster_rank();
    ctas = cluster_ctas(R);
  }
  const int r0 = rank * TEAM_WARPS;         // this CTA's first rate
  const int RS = CLUSTER ? TEAM_WARPS : R;  // its rate slots
  const int RL = CLUSTER ? min(TEAM_WARPS, R - r0) : R;  // its rates
  const int RK = R * NS;
  const int KQ = MIX ? RK : NS;  // tip rows; also A/piA rows
  const int RKS = RS * NS;
  const int KQS = MIX ? RKS : NS;
  const int RKL = RL * NS;
  const int KQL = MIX ? RKL : NS;
  const size_t ROWS = RKS + (HAS_PINV ? 1 : 0);
  const TeamLayout L(NS, RS, MIX, HAS_PINV, width);
  extern __shared__ __align__(16) float team_smem[];
  float* smem = team_smem;
  float* s_x = smem;                 // [RKS]
  float* s_wA = s_x + RKS;           // [RKS * NS]
  float* s_A = s_wA + RKS * NS;      // [KQS * NS]
  float* s_piA = s_A + KQS * NS;     // [KQS * NS]
  // this CTA's rows of the tables (a single matrix's A and piA whole)
  const float* g_x = x_rk + r0 * NS;
  const float* g_wA = wA + r0 * NS * NS;
  const float* g_A = MIX ? A + r0 * NS * NS : A;
  const float* g_piA = MIX ? piA + r0 * NS * NS : piA;
  for (int i = threadIdx.x; i < RKL; i += TEAM) s_x[i] = g_x[i];
  for (int i = threadIdx.x; i < RKL * NS; i += TEAM) s_wA[i] = g_wA[i];
  for (int i = threadIdx.x; i < KQL * NS; i += TEAM) {
    s_A[i] = g_A[i];
    s_piA[i] = g_piA[i];
  }
  __syncthreads();
  // the fastest eigen rate over every rate of the pair
  float lam = 0.0f;
  for (int i = 0; i < RK; ++i) {
    lam = fmaxf(lam, fabsf(CLUSTER ? x_rk[i] : s_x[i]));
  }

  const int tid = threadIdx.x;
  const int warp = tid / WARP;
  const int lane = tid % WARP;
  // TEAM_WARPS / R warps a rate up to TEAM_WARPS rates; one a rate in each
  // CTA of a cluster
  const int per_rate = TEAM_WARPS / RS;
  TeamCtx<NS, MIX, HAS_PINV, CLUSTER> c;
  c.ld = S;
  c.R = RL;
  c.rates = R;
  c.rank = rank;
  c.width = width;
  c.tile = per_rate * WARP;
  c.chunk = c.tile * (RED_UNITS / TEAM);
  c.rc = RS * c.chunk;
  c.tid = tid;
  c.lane = lane;
  c.rate = warp / per_rate;
  c.site = (warp % per_rate) * WARP + lane;
  c.omp = HAS_PINV ? omp[0] : 1.0f;
  c.lam = lam;
  c.E0 = smem + L.exps + warp * 2 * L.erow;
  c.E1 = c.E0 + L.erow;
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
  // the window rows from this CTA's first rate on (a single matrix's tip
  // rows serve every rate)
  const int64_t row0 = static_cast<int64_t>(r0) * NS * S;

  for (int p = blockIdx.x / ctas; p < P; p += gridDim.x / ctas) {
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
      c.pbuf = 0;
      c.wu = tU + e * RK * S + row0 + begin;
      c.wv = tV + e * RK * S + row0 + begin;
      c.wq = tQ + q * KQ * S + (MIX ? row0 : 0) + begin;
      if constexpr (HAS_PINV) {
        // the +I row of T: pv = exp(invq - ls) over the span, once per pair
        // (in every CTA of a cluster: its reducers read it)
        for (int w = tid; w < span; w += TEAM) {
          const int s = begin + w;
          c.T[RKL * width + w] = expf(invq[q * S + s] - ls[e * S + s]);
        }
      }
      __syncthreads();
      solve_pair<HAS_PINV>(c, orig, max_smoothings, out, counts);
    }
    if (tid == 0 && rank == 0) {
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
    // no CTA takes the next pair, or exits, while another of its cluster
    // still reads its partial sums
    if constexpr (CLUSTER) cluster_sync();
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
  int blocks;
  float* t_scratch;
  int* next_pair;
  float* logl;
  float* pendant;
  float* distal;
  float* proximal;
  float* done;
  int* smoothings;
  int* iters;
  int num_rates;
};

// geo's entries: {threads per CTA, CTAs per SM, dynamic shared bytes, T in
// shared memory, registers per thread, CTAs per cluster, clusters the card
// holds at once}
constexpr int GEO_N = 7;

// Sets the kernel's shared memory and reads how many of its CTAs an SM
// holds (the runtime's occupancy) into geo (a cluster of one CTA, the
// card holding CTAs per SM x SMs of them); with ``a``, ``grid`` is that
// many persistent CTAs, never more than ``blocks`` (the pairs or the
// device-memory scratch's slices).
template <class Kernel>
int persistent_grid(Kernel kernel, int threads, bool global_t,
                    const Args* a, int smem_floats, int* geo, int* grid) {
  const int smem = smem_floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaFuncAttributes attr;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g[GEO_N] = {threads,      per_sm, smem, global_t ? 0 : 1,
                        attr.numRegs, 1,      per_sm * sms};
  std::copy(g, g + GEO_N, geo);
  if (a == nullptr) return 0;
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  *grid = std::max(1, std::min(a->blocks, per_sm * sms));
  return 0;
}

// K = 20 past TEAM_WARPS rates: clusters of C CTAs, launched with their
// dimension at run time (cudaLaunchKernelEx). geo as persistent_grid's,
// the card's clusters from cudaOccupancyMaxActiveClusters; with ``a``
// the grid is that many persistent clusters, never more than ``blocks``
// / C (``blocks``: CTAs, the device-memory scratch's slices). A cluster
// the card cannot hold returns cudaErrorLaunchOutOfResources, and a
// launch the runtime refuses its code.
template <class Kernel>
int cluster_launch(Kernel kernel, int C, bool global_t, const Args* a,
                   int smem_floats, int* geo, cudaStream_t stream) {
  const int smem = smem_floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute dims[1];
  dims[0].id = cudaLaunchAttributeClusterDimension;
  dims[0].val.clusterDim.x = C;
  dims[0].val.clusterDim.y = 1;
  dims[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(TEAM, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = dims;
  cfg.numAttrs = 1;
  int per_sm = 0, clusters = 0;
  cudaFuncAttributes attr;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TEAM,
                                                      smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g[GEO_N] = {TEAM, per_sm, smem, global_t ? 0 : 1, attr.numRegs,
                        C,    clusters};
  std::copy(g, g + GEO_N, geo);
  if (a == nullptr) return 0;
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  cfg.gridDim =
      dim3(C * std::max(1, std::min(a->blocks / C, clusters)), 1, 1);
  err = cudaLaunchKernelEx(
      &cfg, kernel, a->tU, a->tV, a->tQ, a->S, a->num_rates, a->invq, a->ls,
      a->omp, a->e_ids, a->q_ids, a->begins, a->spans, a->orig_len, a->skip,
      a->x_rk, a->wA, a->A, a->piA, a->P, a->width, a->max_smoothings,
      a->t_scratch, a->logl, a->pendant, a->distal, a->proximal, a->done,
      a->smoothings, a->iters);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the sumtable's home: shared memory where T fits, else (``device_t``: a
// t_scratch given) device memory; with ``a`` null only geo is filled. RC:
// the instantiation's rate count (0: R, past MAX_R, at run time)
template <int RC>
int launch_dna(const Args* a, int R, int width, bool device_t, int* geo,
               cudaStream_t stream) {
  constexpr bool HAS_PINV = BLO_HAS_PINV != 0;
  const TeamLayout L(K, R, false, HAS_PINV, width);
  if (!device_t && L.t_end > SMEM_LIMIT_FLOATS) return -3;
  const auto kernel = device_t ? blo_newton_dna_kernel<RC, true, HAS_PINV>
                               : blo_newton_dna_kernel<RC, false, HAS_PINV>;
  const int smem_floats = device_t ? L.t : L.t_end;
  int grid = 0;
  const int rc = persistent_grid(kernel, DNA_TEAM, device_t, a, smem_floats,
                                 geo, &grid);
  if (rc != 0 || a == nullptr) return rc;
  kernel<<<grid, DNA_TEAM, smem_floats * sizeof(float), stream>>>(
      a->tU, a->tV, a->tQ, a->S, R, a->invq, a->ls, a->omp, a->e_ids,
      a->q_ids, a->begins, a->spans, a->orig_len, a->skip, a->x_rk, a->wA,
      a->A,
      a->piA, a->P, a->width, a->max_smoothings, a->t_scratch, a->next_pair,
      a->logl, a->pendant, a->distal, a->proximal, a->done, a->smoothings,
      a->iters);
  return static_cast<int>(cudaGetLastError());
}

// K = 20: one CTA a pair up to TEAM_WARPS rates, a cluster of
// cluster_ctas(R) past them, each CTA laid out for its slice_rates(R)
template <bool MIX>
int launch_team(const Args* a, int R, int width, bool device_t, int* geo,
                cudaStream_t stream) {
  constexpr bool HAS_PINV = BLO_HAS_PINV != 0;
  constexpr int N = 20;
  const TeamLayout L(N, slice_rates(R), MIX, HAS_PINV, width);
  if (!device_t && L.t_end > SMEM_LIMIT_FLOATS) return -3;
  const int smem_floats = device_t ? L.t : L.t_end;
  if (R > TEAM_WARPS) {
    const auto kernel =
        device_t ? blo_newton_team_kernel<N, MIX, true, HAS_PINV, true>
                 : blo_newton_team_kernel<N, MIX, false, HAS_PINV, true>;
    return cluster_launch(kernel, cluster_ctas(R), device_t, a, smem_floats,
                          geo, stream);
  }
  const auto kernel =
      device_t ? blo_newton_team_kernel<N, MIX, true, HAS_PINV, false>
               : blo_newton_team_kernel<N, MIX, false, HAS_PINV, false>;
  int grid = 0;
  const int rc = persistent_grid(kernel, TEAM, device_t, a, smem_floats, geo,
                                 &grid);
  if (rc != 0 || a == nullptr) return rc;
  kernel<<<grid, TEAM, smem_floats * sizeof(float), stream>>>(
      a->tU, a->tV, a->tQ, a->S, a->num_rates, a->invq, a->ls, a->omp,
      a->e_ids, a->q_ids, a->begins, a->spans, a->orig_len, a->skip,
      a->x_rk, a->wA, a->A, a->piA, a->P, a->width, a->max_smoothings,
      a->t_scratch, a->logl, a->pendant, a->distal, a->proximal, a->done,
      a->smoothings, a->iters);
  return static_cast<int>(cudaGetLastError());
}

int blo_newton_team(const Args* a, int num_states, int R, int mixture,
                    int width, bool device_t, int* geo,
                    cudaStream_t stream) {
  // the rate caps (ops/blo_kernel.py::max_rates): at K = 4 the tables (and
  // rows and buffers) beside one 32-site tile of T with +I must fit; at
  // K = 20 the cluster holds at most MAX_CLUSTER CTAs
  if (R < 1 || width < 1 || (num_states != K && num_states != 20) ||
      (num_states == K &&
       TeamLayout(K, R, false, true, WARP).t_end > SMEM_LIMIT_FLOATS) ||
      (num_states == 20 && R > MAX_CLUSTER * TEAM_WARPS)) {
    return -1;
  }
  if (num_states == 20) {
    if (mixture) {
#if BLO_PART == BLO_PART_MIX && !BLO_HAS_PINV
      return launch_team<true>(a, R, width, device_t, geo, stream);
#else
      return -1;  // another library's part; no +I with a matrix mixture
#endif
    }
#if BLO_PART == BLO_PART_TEAM
    return launch_team<false>(a, R, width, device_t, geo, stream);
#else
    return -1;
#endif
  }
  if (num_states != K || mixture) return -1;
#if BLO_PART == BLO_PART_DNA
  switch (R) {
    case 1: return launch_dna<1>(a, 1, width, device_t, geo, stream);
    case 2: return launch_dna<2>(a, 2, width, device_t, geo, stream);
    case 3: return launch_dna<3>(a, 3, width, device_t, geo, stream);
    case 4: return launch_dna<4>(a, 4, width, device_t, geo, stream);
    case 5: return launch_dna<5>(a, 5, width, device_t, geo, stream);
    case 6: return launch_dna<6>(a, 6, width, device_t, geo, stream);
    case 7: return launch_dna<7>(a, 7, width, device_t, geo, stream);
    case 8: return launch_dna<8>(a, 8, width, device_t, geo, stream);
    default: return launch_dna<0>(a, R, width, device_t, geo, stream);
  }
#else
  return -1;
#endif
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t code. num_states (4 or 20), num_rates (1 to
// the cap of ops/blo_kernel.py::max_rates; past 8 the K = 4 runtime-R
// instantiation and the K = 20 cluster) and mixture (per-rate A/piA
// [RK][K] and tQ [Q, RK, S]; K = 20 only, and not in the +I library)
// select the instantiation, RK = num_states *
// num_rates; -1 means an unsupported combination, -2 a missing +I input,
// -3 a sumtable too wide for shared memory without a t_scratch. At most
// ``blocks`` persistent CTAs (whole clusters of them past 8 rates at
// K = 20); t_scratch is null (T in shared memory) or holds ``blocks``
// slices of T in device memory ([RK (+1)][width] floats, RK a CTA's rate
// slots x num_states; at K = 4 [dna_t_sites(width)][dna_t_stride(RK (+1))]).
// next_pair [1] is the K = 4 kernel's pair counter, 0 at launch (the
// K = 20 kernel walks its pairs by grid stride and reads no counter).
// invq [Q, S], ls [E, S] and omp [1] are read only by the +I library;
// smoothings and iters [P] are both null (no counters) or both set.
int blo_newton_launch(const float* tU, const float* tV, const float* tQ,
                      int S, int num_states, int num_rates, int mixture,
                      const float* invq,
                      const float* ls, const float* omp, const int* e_ids,
                      const int* q_ids, const int* begins, const int* spans,
                      const float* orig_len, const float* skip,
                      const float* x_rk, const float* wA, const float* A,
                      const float* piA, int P, int width, int max_smoothings,
                      int blocks, float* t_scratch, int* next_pair,
                      float* logl, float* pendant, float* distal,
                      float* proximal, float* done, int* smoothings,
                      int* iters, void* stream) {
  if (P <= 0) return 0;
  if (BLO_HAS_PINV && (invq == nullptr || ls == nullptr || omp == nullptr)) {
    return -2;
  }
  if (num_states == K && next_pair == nullptr) return -2;
  if ((smoothings == nullptr) != (iters == nullptr)) return -2;
  const Args a{tU,     tV,      tQ,     S,       invq,           ls,
               omp,    e_ids,   q_ids,  begins,  spans,          orig_len,
               skip,   x_rk,    wA,     A,       piA,            P,
               width,  max_smoothings,  blocks,  t_scratch,      next_pair,
               logl,   pendant, distal, proximal, done,          smoothings,
               iters,  num_rates};
  int geo[GEO_N];
  return blo_newton_team(&a, num_states, num_rates, mixture, width,
                         t_scratch != nullptr, geo,
                         static_cast<cudaStream_t>(stream));
}

// The geometry a launch at this state count, rate count, mixture flag and
// width takes (device_t: with a t_scratch), as the launcher reads it from
// the runtime: geo[7] = {threads per CTA, CTAs per SM, dynamic shared
// bytes, 1 if T is in shared memory, registers per thread, CTAs per
// cluster, clusters the card holds at once}. Returns 0 or an error code
// as blo_newton_launch does.
int blo_newton_team_geometry(int num_states, int num_rates, int mixture,
                             int width, int device_t, int* geo) {
  return blo_newton_team(nullptr, num_states, num_rates, mixture, width,
                         device_t != 0, geo, nullptr);
}

const char* blo_newton_error_string(int code) {
  if (code == -1) {
    return "unsupported state count, rate count or mixture (4 or 20 "
           "states; at 4 the rates whose tables fit shared memory beside "
           "a 32-site tile of T, at 20 up to 64; mixtures at 20 states "
           "without +I), or a launch of another library's part";
  }
  if (code == -2) {
    return "missing +I input, counter output or K = 4 pair counter";
  }
  if (code == -3) {
    return "the sumtable does not fit shared memory at this width (pass a "
           "device-memory scratch)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
