// The fused Metropolis-Hastings chain kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_kernel` (mh_tpu/kernels/fused_mh.py:405):
// one launch runs every MH step of every chain -- counter-RNG proposal, the
// seven-term layout objective, the Boltzmann accept and the commit -- and then
// reports each chain's weighted cost breakdown. The plain PyTorch version of
// this exact algorithm is `fused_chains_reference` in ../fused_mh.py; both
// sum in the same fixed order (per-thread strided sums over THREADS lanes,
// then a halving tree over the THREADS partials), so they agree bit for bit
// when the math library does: a max is exact in any order, so the symmetry
// state below changes no bit either.
//
// Layout: one thread block per chain, THREADS threads, thread t owning object
// lanes t, t + THREADS, ... The current pose P and the proposed ("star") pose
// S (6 planes x N each) live in shared memory, with S == P at the start of
// every step: a move writes only the <= 2 lanes it picks into S (a compound
// step the lanes its moves pick, listed once each), and the commit copies
// just those lanes S -> P on accept or P -> S on reject. The scene is read
// from global memory (it is small and stays in L1/L2).
//
// A step proposes one move (translate / rotate / swap), or with `moves > 1`
// a compound block proposal of `moves` sequential moves (`iter_body_multi`,
// fused_mh.py:1444-1575; the deterministic form of the reference's
// blockxDim per-thread proposals, Kernel.cu:798-828), and accepts against
// one uniform or, with `accept_draws = K > 1`, against the minimum of K
// (Kernel.cu:819). For a compound step the threads draw and decode up to
// THREADS moves at once; thread 0 then applies them in order.
//
// What bounds it, and what the design does about it. The work a step needs
// is small: at 100 objects x 1024 chains ~5 Mflop (0.07 ms per 1000 steps
// at the card's f32 peak), so the step is bound by instruction issue and
// latency, not by bytes or flops. Three things held it back:
//
// 1. The symmetry term was O(N^2) a step: every reflection matched against
//    every candidate (10^4 sym_val at 100 objects). The kernel now keeps
//    O(N) state per chain: each reflection's best match value and the
//    lowest candidate index that reaches it (argbest). A step evaluates
//      - each unmoved reflection against the moved candidates only (a max
//        is exact in any order, so the value equals the full row's), and
//      - a full row, one warp per row (lanes stride the candidates, then
//        two warp reductions pick value and index), only for moved
//        reflections and those whose argbest moved: ~3-4 N evaluations a
//        step in place of N^2.
//    The proposed best / argbest is kept beside the current one and taken
//    on accept. Where a compound step moves so many lanes that this costs
//    more than the full match (4 M >= N, decided by the wrapper), every row
//    is rescanned by its own thread, as before; both give the same bits.
//    In every scan a candidate whose squared distance already rules out
//    reaching the row's best skips its two square roots (beat_limit).
//    FIXED mode with a weighted off-limits term sums it slab by slab, as
//    the JAX kernel does (off_state_init / so_star_batched,
//    fused_mh.py:1208-1355): cell (s, i) is object i's overlap with the
//    objects j > i of slab s (W objects), kept for every (s, i) in shared
//    memory with each object's row sum. A move of object k's box
//    invalidates slab row s(k) and column k; a step recomputes just those
//    cells at the star pose into a few star slots (~W N / 2 + W S pair
//    overlaps at a single move, where the j > i sum is N^2 / 2), spread
//    over all threads, and re-sums only the rows they change. Nothing is
//    restored on reject: the thread that wrote a star slot copies it into
//    the current cells at the start of the next step, if that step's
//    predecessor accepted. Row and column updates call one function,
//    off_cell_at, so a cell has the same bits whichever wrote it and the state
//    equals a from-scratch slab sum bit for bit. Where a step's moves
//    could touch every slab, the cells are so few that the bookkeeping
//    costs more than they do, or the state does not fit in shared memory
//    (fused_mh.off_incremental), no cell is kept: each thread sums its
//    objects' slab rows from scratch in the same order.
// 2. Fourteen block-wide barriers a step, around a shared-memory halving
//    tree per reduced row and thread 0's serial work. Each warp now reduces
//    whole rows in the tree's order (lane l forms the first two levels,
//    (p[l] + p[l+64]) + (p[l+32] + p[l+96]), and __shfl_down_sync the other
//    five). A single-move step has 4 barriers: after the move is applied,
//    after the per-lane terms (which list the rows to rescan), after the
//    rescans and after the reduction. Warp 0 alone then scores, accepts and
//    commits; warp 1 draws and decodes the next move during the reduction;
//    the other warps go straight on to the next step.
// 3. Per-object work for objects that did not move. The focal term (sinf,
//    cosf, sqrtf, a division) is cached per object and recomputed for
//    moved lanes only; balance, outside area and clearance rows are a few
//    flops, summed by each thread over its own objects into its strided
//    partials (one box per object for every row). The relationship,
//    angle and clearance-surface sums (lane 0 of warps 0, 1 and 2, each in
//    its order) are reused while none of their objects moved.
//
// 4. Instruction fetch. The step's code did not fit the SM's instruction
//    caches: with 8 chains to an SM each at its own phase, every phase
//    waited on fetches, and more so with each path added to the loop. Loops
//    whose trip count is known only at run time are not unrolled
//    (NO_UNROLL), which takes the kernel from ~17.6k to ~10.8k SASS
//    instructions and the step at 100 objects from ~9.3 to ~7.7 us
//    (weighted FIXED from ~23.8 to ~14.1 us; H100, PERF.md).
//
// What is left at 100 objects is a floor of ~7.7 us a step spread over every
// phase, with 8 chains to an SM (64 registers x 128 threads): a chain alone
// on an SM steps in ~0.7 of that time, so issue, not only latency, sets it.
// There is no matrix product: the TPU kernel's one-hot MXU gathers are
// indexed loads here.
//
// Numerics: build with --fmad=false and without --use_fast_math, so every
// operation is rounded as the PyTorch version rounds it. The reference's
// plane expressions add a signed zero to every lane a move does not pick,
// which turns -0.0 into +0.0 there. A chain whose start pose holds -0.0
// therefore commits an accepted single move through those expressions on
// every lane, and applies each move of a compound step to every lane
// (and commits or restores every lane), so its zeros' signs match too.
// The accept count is stored as its int32 bits in the f32 stats row.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

extern __shared__ float mh_fused_smem[];

// a loop whose trip count is known only at run time stays rolled (point 4)
#define NO_UNROLL _Pragma("unroll 1")

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 8;  // 8 x 128 threads x 64 registers fill an SM's registers
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int PROPOSAL_LANES = 8;  // uniforms one move consumes
constexpr int DRAW_LANES = 128;    // uniforms per (chain, draw counter)
constexpr int MAX_ACCEPT_DRAWS = DRAW_LANES - PROPOSAL_LANES;
constexpr int N_STATS = 10;

// -DMH_PHASE_PROFILE builds a library whose step loop adds, per warp, the
// clock cycles its lane 0 spends in each phase of a single-move step (the
// barrier waits are phases of their own) into mh_phase_cycles, with the
// number of blocks last; mh_phase_cycles_read / _reset reach it. Without
// the define the markers compile to nothing.
constexpr int N_PHASES = 12;
#ifdef MH_PHASE_PROFILE
__device__ unsigned long long mh_phase_cycles[WARPS * N_PHASES + 1];
#define PHASE_DECLARE()                           \
  __shared__ long long phase_acc[WARPS][N_PHASES]; \
  long long phase_t = 0;                          \
  if (threadIdx.x < WARPS * N_PHASES) (&phase_acc[0][0])[threadIdx.x] = 0;
#define PHASE_START() phase_t = clock64();
#define PHASE(k)                                  \
  if ((threadIdx.x & 31) == 0) {                  \
    const long long now = clock64();              \
    phase_acc[threadIdx.x >> 5][k] += now - phase_t; \
    phase_t = now;                                \
  }
#define PHASE_FLUSH()                                                             \
  if ((threadIdx.x & 31) == 0)                                                    \
    for (int k = 0; k < N_PHASES; ++k)                                            \
      atomicAdd(&mh_phase_cycles[(threadIdx.x >> 5) * N_PHASES + k],              \
                static_cast<unsigned long long>(phase_acc[threadIdx.x >> 5][k])); \
  if (threadIdx.x == 0) atomicAdd(&mh_phase_cycles[WARPS * N_PHASES], 1ull);
#else
#define PHASE_DECLARE()
#define PHASE_START()
#define PHASE(k)
#define PHASE_FLUSH()
#endif
constexpr float NEG_HUGE = -1e30f;
constexpr float TRUE_PI = 3.14159265358979323846f;
constexpr float HALF_PI = 1.57079632679489661923f;
constexpr float TWO_PI_TRUE = 6.28318530717958647692f;

// per-object planes of `planes` (f32[N_PLANES, N]) -- same numbering as fused_mh.py
enum { P_MASK, P_OK, P_RANK, P_AREA, P_OV0X, P_OTAILX, P_OMINX, P_OMINY, P_OMAXX, P_OMAXY };
// scalar slots of `sc` -- same numbering as fused_mh.py
enum {
  S_WPW, S_WVB, S_WFP, S_WSY, S_WCL, S_WOL, S_WSA,
  S_CX2, S_CY2, S_FX, S_FY, S_FROT, S_UX, S_UY,
  S_MNX, S_MNY, S_MXX, S_MXY,
  S_SIGX, S_SIGY, S_SIGT, S_BETA, S_NOBJ, S_NUNF,
  S_ADAPTR, S_TARGET, S_PI, S_DENOM
};
// reduced rows; clearance c reduces in row R_CLR0 + c
enum { R_NX, R_NY, R_FP, R_OBJOUT, R_SYM, R_OFF, R_CLR0 };
// move kinds; a swap drawn in a scene of fewer than two objects does nothing
enum { MOVE_TRANSLATE, MOVE_ROTATE, MOVE_SWAP, MOVE_NONE };
// per-move rows of the compound step's move table (THREADS entries each)
enum { M_DX, M_DY, M_DROT, M_KIND, M_I1, M_I2, N_MOVE_ROWS };

struct Params {
  const float* pose_in;   // f32[C, N, 6]
  float* pose_out;        // f32[C, N, 6]
  float* stats;           // f32[C, N_STATS]: breakdown[8], n_accept, step_scale
  const float* planes;    // f32[10, N]
  const int* unf_idx;     // i32[n_unf]: lane of the r-th movable object
  const float* sc;        // f32[32]
  const int* rel_idx;     // i32[n_rel, 2]
  const float* rel_p;     // f32[n_rel, 3]: lo, hi, mask
  const int* ang_idx;     // i32[n_ang, 2]
  const float* ang_p;     // f32[n_ang, 3]: amin, amax, mask
  const int* clr_idx;     // i32[n_clr, 2]: source object, surface-area anchor
  const float* clr_p;     // f32[n_clr, 6]: v0x, tail_min_x, min_x, min_y, max_x, max_y
  int n_rel, n_ang, n_clr, n, n_chains;
  uint32_t seed;
  int iterations, first_chain, parity, track_off, adapt;
  int moves, accept_draws;  // moves per step (compound if > 1); K accept uniforms
  int incremental;          // 1: best / argbest state; 0: rescan every row each step
  // with track_off: objects per slab (W), slabs (S) and 1 to update only the
  // cells a step's moves change (needs `incremental`), 0 to recompute all;
  // with off_incremental, the star row and column slots (2 per move)
  int off_width, off_slabs, off_incremental, off_slots;
  // where the off-limits state lies in shared memory (offsets in words; see
  // the layout below), computed once by the host
  struct {
    int oc, ox, oy, oyc, rows, tsi, bmq, tsl, bml, end;
  } off;
};

// One decoded move (fused_mh.py:1478-1491, :1657-1693)
struct Move {
  float dx, dy, drot;
  int kind, i1, i2;
};

// Per-block values that one thread writes and all threads read.
struct Shared {
  float u_acc;
  Move next;              // the next single move, unscaled, and its accept draw
  float next_u_acc;
  Move mv;                // the single move of this step (for the -0.0 commit)
  float r1v[6], r2v[6];   // current pose planes at its two picks
  float pw, pwa, sa_clr;  // entity terms of the last evaluated pose
  float pw_c, pwa_c, sa_clr_c;  // and of the current pose
  int n_moved, n_rescan;  // entries of the moved-lane and rescan lists
  // off-limits state, by step parity: the star row slots (touched slabs)
  // and column slots (lanes whose box moved) listed; this step's last row
  // that a touched slab changes; which row-sum buffer is current
  int n_rows[2], n_cols[2], off_lim, rsel;
  int acc;                // the last step accepted
  float scale;            // the step scale of a compound step's moves
};

// ---- dynamic shared memory: words of 4 bytes, offsets in units of N --------
// P[6N] current pose planes (x, y, z, rotX, rotY, rotZ), S[6N] star planes,
// MASK[N], FPc / FPs[N] focal term per object (current / star), Bc / Bs[N]
// best symmetry match per reflection, Ac / As[N] argbest, MV[N] moved-lane
// flags, LIST[N] rows to rescan, MVL[N] moved lanes; then, for the K =
// R_CLR0 + n_clr reduced rows, RS[K] their sums and RED[K x THREADS] their
// strided partials, a compound step's move table [N_MOVE_ROWS x THREADS]
// and, with track_off, the off-limits state: OC[S x N] the cells (current;
// without off_incremental, the star pose's, all recomputed each step) and,
// with off_incremental and T = off_slots: OX[T x N] the star rows of the
// touched slabs, OY[T x S] the star columns of the lanes whose box moved and
// OYC[T x S] the cell each column slot replaces (-1: none), OR[2 x N] the
// row sums (current and star, swapped on accept), TSI[S] each slab's row
// slot and BMQ[N] each lane's column slot (-1: none), TSL[2 x T] and
// BML[2 x T] the slabs and lanes of the slots, by step parity. Keep in step
// with smem_bytes in fused_mh.py.
constexpr int SMEM_WORDS_PER_OBJECT = 22;
__device__ __forceinline__ float* sP(int) { return mh_fused_smem; }
__device__ __forceinline__ float* sS(int N) { return mh_fused_smem + 6 * N; }
__device__ __forceinline__ float* sMASK(int N) { return mh_fused_smem + 12 * N; }
__device__ __forceinline__ float* sFPc(int N) { return mh_fused_smem + 13 * N; }
__device__ __forceinline__ float* sFPs(int N) { return mh_fused_smem + 14 * N; }
__device__ __forceinline__ float* sBc(int N) { return mh_fused_smem + 15 * N; }
__device__ __forceinline__ float* sBs(int N) { return mh_fused_smem + 16 * N; }
__device__ __forceinline__ int* sAc(int N) {
  return reinterpret_cast<int*>(mh_fused_smem + 17 * N);
}
__device__ __forceinline__ int* sAs(int N) {
  return reinterpret_cast<int*>(mh_fused_smem + 18 * N);
}
__device__ __forceinline__ int* sMV(int N) {
  return reinterpret_cast<int*>(mh_fused_smem + 19 * N);
}
__device__ __forceinline__ int* sLIST(int N) {
  return reinterpret_cast<int*>(mh_fused_smem + 20 * N);
}
__device__ __forceinline__ int* sMVL(int N) {
  return reinterpret_cast<int*>(mh_fused_smem + 21 * N);
}
__device__ __forceinline__ float* sRS(int N) { return mh_fused_smem + 22 * N; }
__device__ __forceinline__ float* sRED(int N, int K) { return sRS(N) + K; }
__device__ __forceinline__ float* sOC(const Params& p) { return mh_fused_smem + p.off.oc; }
__device__ __forceinline__ float* sOX(const Params& p) { return mh_fused_smem + p.off.ox; }
__device__ __forceinline__ float* sOY(const Params& p) { return mh_fused_smem + p.off.oy; }
__device__ __forceinline__ int* sOYC(const Params& p) {
  return reinterpret_cast<int*>(mh_fused_smem + p.off.oyc);
}
__device__ __forceinline__ float* sOR(const Params& p) { return mh_fused_smem + p.off.rows; }
__device__ __forceinline__ int* sTSI(const Params& p) {
  return reinterpret_cast<int*>(mh_fused_smem + p.off.tsi);
}
__device__ __forceinline__ int* sBMQ(const Params& p) {
  return reinterpret_cast<int*>(mh_fused_smem + p.off.bmq);
}
__device__ __forceinline__ int* sTSL(const Params& p) {
  return reinterpret_cast<int*>(mh_fused_smem + p.off.tsl);
}
__device__ __forceinline__ int* sBML(const Params& p) {
  return reinterpret_cast<int*>(mh_fused_smem + p.off.bml);
}

// ---- geometry (fused_mh.py:319-577) -----------------------------------------
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float a = mn / fmaxf(mx, 1e-30f);
  const float s = a * a;
  float p = -0.0117212f * s + 0.05265332f;
  p = p * s + -0.11643287f;
  p = p * s + 0.19354346f;
  p = p * s + -0.33262347f;
  p = p * s + 0.99997726f;
  float r = a * p;
  r = ay > ax ? HALF_PI - r : r;
  r = x < 0.f ? TRUE_PI - r : r;
  return y < 0.f ? -r : r;
}

__device__ __forceinline__ float aabb_minx(bool parity, float v0x, float tailx, float minx,
                                           float tx) {
  return parity ? fminf(v0x, tailx + tx) : minx + tx;
}

__device__ __forceinline__ float inter_area(float amnx, float amny, float amxx, float amxy,
                                            float bmnx, float bmny, float bmxx, float bmxy) {
  const float x5 = fmaxf(amnx, bmnx), y5 = fmaxf(amny, bmny);
  const float x6 = fminf(amxx, bmxx), y6 = fminf(amxy, bmxy);
  return (x5 >= x6 || y5 >= y6) ? 0.f : (x6 - x5) * (y6 - y5);
}

// area of a rect outside the surface: area minus overlap, clamped at 0
__device__ __forceinline__ float outside_area(const float* sc, float mnx, float mny, float mxx,
                                              float mxy) {
  const float ov = inter_area(mnx, mny, mxx, mxy, sc[S_MNX], sc[S_MNY], sc[S_MXX], sc[S_MXY]);
  return fmaxf((mxx - mnx) * (mxy - mny) - ov, 0.f);
}

__device__ __forceinline__ float floor_mod(float a, float b) {
  const float r = fmodf(a, b);
  return (r != 0.f && ((r < 0.f) != (b < 0.f))) ? r + b : r;
}

// single conditional wrap into [0, 2 pi] (Kernel.cu:648-651)
__device__ __forceinline__ float wrap_once(float a, float two_pi) {
  a = a < 0.f ? a + two_pi : a;
  return a > two_pi ? a - two_pi : a;
}

// match score of a candidate at squared distance d2 and rotation cr from a
// reflection of rotation rr (Kernel.cu:301-312)
__device__ __forceinline__ float sym_score(float d2, float cr, float rr, float pi,
                                           float two_pi) {
  const float dp = sqrtf(d2);
  float dt = cr - rr;
  dt = dt > pi ? dt - two_pi : dt;
  return 5.f - sqrtf(dp) - 0.4f * fabsf(dt);
}

__device__ __forceinline__ float dist2(float cx, float cy, float rx, float ry) {
  const float ddx = cx - rx, ddy = cy - ry;
  return ddx * ddx + ddy * ddy;
}

// The squared distance past which a candidate scores below `best`, so its
// two square roots can be skipped: with s = sqrt(sqrt(d2)) correctly
// rounded, d2 > (5 - best + 1e-3)^4 gives s > 5 - best + 4e-4 for any
// 5 - best < 1000, and so a score 5 - s - 0.4|dt| < best after rounding.
// Skipping changes no bit of a max, nor of the lowest index reaching it.
__device__ __forceinline__ float beat_limit(float best) {
  const float t = 5.f - best;
  if (!(t < 1000.f)) return __int_as_float(0x7f800000);  // +inf: no skipping
  const float lim = t + 1e-3f;
  const float l2 = lim * lim;
  return l2 * l2;
}

// object i's reflection across the focal axis (Kernel.cu:283-300)
struct Refl {
  float x, y, r;
};
__device__ __forceinline__ Refl reflect(const float* sc, float x, float y, float rot) {
  const float pi = sc[S_PI], two_pi = 2.f * pi;
  const float ux = sc[S_UX], uy = sc[S_UY];
  const float fxy = sc[S_FX] * ux + sc[S_FY] * uy;
  const float s = 2.f * (fxy - (x * ux + y * uy));
  float rr = 2.f * sc[S_FROT] - rot;
  rr = rr < -pi ? rr + two_pi : rr;
  return {x + s * ux, y + s * uy, rr};
}

// the order on (value, candidate): larger value first, then lower index; an
// index of -1 (no candidate yet) loses every tie
__device__ __forceinline__ bool better(float v, int j, float best, int arg) {
  return v > best || (v == best && static_cast<unsigned>(j) < static_cast<unsigned>(arg));
}

// an int whose signed order is the float order (no NaN); its own inverse
__device__ __forceinline__ int order_key(int bits) { return bits ^ ((bits >> 31) & 0x7fffffff); }

// object i's off-limits AABB at (x, y)
struct Box {
  float mnx, mny, mxx, mxy;
};
__device__ __forceinline__ Box obj_box(const float* pl, int N, bool parity, int i, float x,
                                       float y) {
  return {aabb_minx(parity, pl[P_OV0X * N + i], pl[P_OTAILX * N + i], pl[P_OMINX * N + i], x),
          pl[P_OMINY * N + i] + y, pl[P_OMAXX * N + i] + x, pl[P_OMAXY * N + i] + y};
}

// focal term of one object by angle addition (fused_mh.py:876-883), masked
__device__ __forceinline__ float focal_term(const float* sc, float x, float y, float rot,
                                            float m) {
  const float dxf = sc[S_FX] - x, dyf = sc[S_FY] - y;
  const float rf = sqrtf(dxf * dxf + dyf * dyf);
  const float srot = sinf(rot);
  float cph = (dxf * srot - dyf * cosf(rot)) / (rf > 0.f ? rf : 1.f);
  cph = rf > 0.f ? cph : srot;
  return -cph * m;
}

// off-limits overlap of object i with every later object (Kernel.cu:485-514):
// the final report's unslabbed row
__device__ __forceinline__ float off_row(const Params& p, const float* S, const float* MASK,
                                         int i) {
  const int N = p.n;
  const bool parity = p.parity;
  const Box a = obj_box(p.planes, N, parity, i, S[i], S[N + i]);
  float row = 0.f;
  NO_UNROLL
  for (int j = i + 1; j < N; ++j) {
    const Box b = obj_box(p.planes, N, parity, j, S[j], S[N + j]);
    row = row + inter_area(a.mnx, a.mny, a.mxx, a.mxy, b.mnx, b.mny, b.mxx, b.mxy) * MASK[j];
  }
  return row;
}

// ---- the FIXED off-limits slab state (fused_mh.py:1208-1355) ----------------
// Cell (s, i) at the star pose, given object i's box a: object i's overlaps
// with the objects j > i of slab s, summed in ascending j from 0 (off_cells
// in fused_mh.py). Every cell -- the start, a row update, a column update,
// a recomputed row -- goes through this function, so the state never drifts.
__device__ __forceinline__ float off_cell_at(const Params& p, const Box& a, int s, int i) {
  const int N = p.n;
  const float* S = sS(N);
  const float* MASK = sMASK(N);
  const int end = min((s + 1) * p.off_width, N);
  float cell = 0.f;
  NO_UNROLL
  for (int j = max(s * p.off_width, i + 1); j < end; ++j) {
    const Box b = obj_box(p.planes, N, p.parity, j, S[j], S[N + j]);
    cell = cell + inter_area(a.mnx, a.mny, a.mxx, a.mxy, b.mnx, b.mny, b.mxx, b.mxy) * MASK[j];
  }
  return cell;
}

__device__ __forceinline__ float off_cell(const Params& p, int s, int i) {
  const float* S = sS(p.n);
  if (max(s * p.off_width, i + 1) >= min((s + 1) * p.off_width, p.n)) return 0.f;
  return off_cell_at(p, obj_box(p.planes, p.n, p.parity, i, S[i], S[p.n + i]), s, i);
}

// Object i's slab row from scratch, its cells summed over s ascending (the
// cells of the slabs before its own are 0), by the calling thread alone:
// the rows without off_incremental, no cell kept.
__device__ __forceinline__ float off_slab_row(const Params& p, int i) {
  const float* S = sS(p.n);
  const Box a = obj_box(p.planes, p.n, p.parity, i, S[i], S[p.n + i]);
  float row = 0.f;
  NO_UNROLL
  for (int s = i / p.off_width; s < p.off_slabs; ++s) row = row + off_cell_at(p, a, s, i);
  return row;
}

// Every cell at the star pose into OC, by every thread: the start of a run
// that keeps the state (off_incremental).
__device__ void off_all_cells(const Params& p) {
  const int N = p.n;
  float* OC = sOC(p);
  NO_UNROLL
  for (int c = threadIdx.x; c < p.off_slabs * N; c += THREADS) {
    const int s = c / N;
    OC[c] = off_cell(p, s, c - s * N);
  }
}

// List the slab of lane k, whose box moved, as a star row slot and the lane
// as a star column slot, once each (thread 0; par: the step's parity). A
// touched slab's row changes for the objects before its last one.
__device__ __forceinline__ void off_note(const Params& p, Shared& sh, int k, int par) {
  const int s = k / p.off_width, T = p.off_slots;
  int* TSI = sTSI(p);
  int* BMQ = sBMQ(p);
  if (TSI[s] < 0) {
    TSI[s] = sh.n_rows[par];
    sTSL(p)[par * T + sh.n_rows[par]++] = s;
    sh.off_lim = max(sh.off_lim, min((s + 1) * p.off_width, p.n) - 1);
  }
  if (BMQ[k] < 0) {
    BMQ[k] = sh.n_cols[par];
    sBML(p)[par * T + sh.n_cols[par]++] = k;
  }
}

// Open step parity par's slot lists (thread 0): the last step's slabs and
// lanes lose their slots; its lists stay for the commit in off_update.
__device__ __forceinline__ void off_begin(const Params& p, Shared& sh, int par) {
  const int q = par ^ 1, T = p.off_slots;
  NO_UNROLL
  for (int t = 0; t < sh.n_rows[q]; ++t) sTSI(p)[sTSL(p)[q * T + t]] = -1;
  NO_UNROLL
  for (int t = 0; t < sh.n_cols[q]; ++t) sBMQ(p)[sBML(p)[q * T + t]] = -1;
  sh.n_rows[par] = sh.n_cols[par] = 0;
  sh.off_lim = 0;
}

// The star slots of step parity par, by every thread (off_incremental). Row
// slot t holds cell (TSL[t], i) for every i, written by the thread owning
// lane i; column slot y = q S + s holds cell (s, BML[q]) of a later slab no
// row slot covers, written by thread THREADS - 1 - y mod THREADS. Each thread
// first copies the slots it wrote in the last step into OC if that step
// accepted (`took`): the same thread reads and writes a slot, and nothing
// else reads OC before the next barrier.
__device__ void off_update(const Params& p, const Shared& sh, int par, bool took) {
  const int N = p.n, S = p.off_slabs, T = p.off_slots, tid = threadIdx.x;
  float* OC = sOC(p);
  float* OX = sOX(p);
  float* OY = sOY(p);
  int* OYC = sOYC(p);
  const int* TSL = sTSL(p);
  const int* BML = sBML(p);
  if (took) {
    const int q = par ^ 1;
    NO_UNROLL
    for (int t = 0; t < sh.n_rows[q]; ++t) {
      const int s = TSL[q * T + t];
      NO_UNROLL
      for (int i = tid; i < N; i += THREADS) OC[s * N + i] = OX[t * N + i];
    }
    NO_UNROLL
    for (int y = THREADS - 1 - tid; y < sh.n_cols[q] * S; y += THREADS)
      if (OYC[y] >= 0) OC[OYC[y]] = OY[y];
  }
  NO_UNROLL
  for (int t = 0; t < sh.n_rows[par]; ++t) {
    const int s = TSL[par * T + t];
    NO_UNROLL
    for (int i = tid; i < N; i += THREADS) OX[t * N + i] = off_cell(p, s, i);
  }
  const int* TSI = sTSI(p);
  NO_UNROLL
  for (int y = THREADS - 1 - tid; y < sh.n_cols[par] * S; y += THREADS) {
    const int q = y / S, s = y - q * S, k = BML[par * T + q];
    const bool stale = s > k / p.off_width && TSI[s] < 0;
    OYC[y] = stale ? s * N + k : -1;
    if (stale) OY[y] = off_cell(p, s, k);
  }
}

// Each thread's strided partial of the off-limits row at the star pose:
// object i's row sums its cells over s ascending (the cells of the slabs
// before its own are 0), times its mask, as the plain version's _block_sum
// adds objects t, t + THREADS, ... Without off_incremental from scratch;
// with it from the state: a row no star slot changes keeps its current sum,
// every row's star sum goes to the star row-sum buffer, and `all` sums every
// row from OC (the start).
__device__ void off_rows(const Params& p, const Shared& sh, bool all) {
  const int N = p.n, S = p.off_slabs, W = p.off_width;
  const float* OC = sOC(p);
  const float* MASK = sMASK(N);
  float acc = 0.f;
  if (!p.off_incremental) {
    NO_UNROLL
    for (int i = threadIdx.x; i < N; i += THREADS) acc = acc + off_slab_row(p, i) * MASK[i];
    sRED(N, R_CLR0 + p.n_clr)[R_OFF * THREADS + threadIdx.x] = acc;
    return;
  }
  const float* OX = sOX(p);
  const float* OY = sOY(p);
  const int* TSI = sTSI(p);
  const int* BMQ = sBMQ(p);
  const float* Rc = sOR(p) + sh.rsel * N;
  float* Rs = sOR(p) + (sh.rsel ^ 1) * N;
  NO_UNROLL
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const int q = all ? -1 : BMQ[i];
    float row;
    if (all || i < sh.off_lim || q >= 0) {
      row = 0.f;
      NO_UNROLL
      for (int s = i / W; s < S; ++s) {
        const int t = all ? -1 : TSI[s];
        row = row + (t >= 0 ? OX[t * N + i]
                            : (q >= 0 && s > i / W ? OY[q * S + s] : OC[s * N + i]));
      }
    } else {
      row = Rc[i];
    }
    Rs[i] = row;
    acc = acc + row * MASK[i];
  }
  sRED(N, R_CLR0 + p.n_clr)[R_OFF * THREADS + threadIdx.x] = acc;
}

// ---- proposal ---------------------------------------------------------------
// The move that 8 uniforms u[0..7] drive (fused_mh.py:1478-1491): kind from
// u0, Box-Muller steps from u2..u5, and two objects picked by rank among the
// movable ones from u6, u7 (fused_mh.py:1675-1693). Lane 1 is the accept draw.
// The steps come unscaled: `scaled` applies the step scale, which rounds
// as the last factor of the reference's product does.
__device__ __forceinline__ Move decode_move(const Params& p, const float* u) {
  const float* sc = p.sc;
  Move m;
  const int move = min(static_cast<int>(u[0] * 3.f), 2);
  const float r1 = sqrtf(-2.f * logf(u[2]));
  const float r2 = sqrtf(-2.f * logf(u[4]));
  m.dx = r1 * cosf(TWO_PI_TRUE * u[3]) * sc[S_SIGX];
  m.dy = r1 * sinf(TWO_PI_TRUE * u[3]) * sc[S_SIGY];
  m.drot = r2 * cosf(TWO_PI_TRUE * u[5]) * sc[S_SIGT];
  const float n_unf = sc[S_NUNF];
  const float n_unf_m1 = fmaxf(n_unf - 1.f, 0.f);
  const float k1 = fminf(floorf(u[6] * n_unf), n_unf_m1) + 1.f;
  const float k2 = fminf(floorf(u[7] * n_unf), n_unf_m1) + 1.f;
  const bool has_unfrozen = n_unf > 0.f;
  m.i1 = has_unfrozen ? p.unf_idx[static_cast<int>(k1) - 1] : -1;
  m.i2 = has_unfrozen ? p.unf_idx[static_cast<int>(k2) - 1] : -1;
  m.kind = (move == 2 && !(sc[S_NOBJ] >= 2.f)) ? MOVE_NONE : move;
  return m;
}

__device__ __forceinline__ Move scaled(Move m, float scale) {
  m.dx = m.dx * scale;
  m.dy = m.dy * scale;
  m.drot = m.drot * scale;
  return m;
}

// min over lanes lane0 .. lane0 + k - 1 of one draw counter, computed by the
// whole calling warp (every lane of it must call) and returned to every lane
__device__ __forceinline__ float warp_min_uniform(uint32_t seed, uint32_t gchain,
                                                  uint32_t counter, uint32_t lane0, int k) {
  float m = 2.f;  // above every uniform
  NO_UNROLL
  for (int j = threadIdx.x & 31; j < k; j += 32)
    m = fminf(m, mh_uniform(seed, gchain, counter, lane0 + j));
  for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(FULL_MASK, m, o));
  return m;
}

// list lane k as moved, once (thread 0; `listed` counts the list)
// The uniforms and the unscaled move of single-move step t -> sh.next,
// sh.next_u_acc, by the calling warp (every lane of it must call). Step t
// reads lanes lanes * (t % unroll) + [0, lanes) of draw counter t / unroll
// (fused_mh.py:1868-1875), its K accept draws at lanes 8 .. 8+K-1.
__device__ void draw_single(const Params& p, uint32_t gchain, int t, int lanes, int unroll,
                            Shared& sh) {
  const int lane = threadIdx.x & 31, K = p.accept_draws;
  const uint32_t counter = static_cast<uint32_t>(t / unroll);
  const uint32_t lane0 = static_cast<uint32_t>(lanes * (t % unroll));
  const float u_min =
      K > 1 ? warp_min_uniform(p.seed, gchain, counter, lane0 + PROPOSAL_LANES, K) : 0.f;
  const float mine =
      lane < PROPOSAL_LANES ? mh_uniform(p.seed, gchain, counter, lane0 + lane) : 0.f;
  float u[PROPOSAL_LANES];
  for (int k = 0; k < PROPOSAL_LANES; ++k) u[k] = __shfl_sync(FULL_MASK, mine, k);
  if (lane == 0) {
    sh.next = decode_move(p, u);
    sh.next_u_acc = K > 1 ? u_min : u[1];
  }
}

// list lane k as moved, once; with the off-limits state and a moved `box`,
// give it and its slab star slots (thread 0; `listed` counts the lanes)
__device__ __forceinline__ void note_moved(const Params& p, Shared& sh, int& listed, int k,
                                           bool box, int par) {
  int* MV = sMV(p.n);
  if (!MV[k]) {
    MV[k] = 1;
    sMVL(p.n)[listed++] = k;
  }
  if (box && p.off_incremental) off_note(p, sh, k, par);
}

// list the lanes move m writes (thread 0): the pick of a translate or
// rotate, both picks of a swap of two
__device__ __forceinline__ void list_move(const Params& p, Shared& sh, const Move& m,
                                          int& listed, int par) {
  if (m.i1 < 0) return;
  if (m.kind == MOVE_TRANSLATE || m.kind == MOVE_ROTATE) {
    note_moved(p, sh, listed, m.i1, m.kind == MOVE_TRANSLATE, par);
  } else if (m.kind == MOVE_SWAP && m.i1 != m.i2) {
    note_moved(p, sh, listed, m.i1, true, par);
    note_moved(p, sh, listed, m.i2, true, par);
  }
}

// Apply one move to the six star planes S at its picks (thread 0 only).
// Each update rounds as the plane expressions of iter_body_multi
// (fused_mh.py:1493-1512) round at the picked lanes: x + (clip(x+dx) - x),
// rot + (wrapped - rot), and a swap as v1 + (v2 - v1), v2 - (v2 - v1) from
// the pre-swap values. One move rounds the same way (fused_mh.py:1696-1723
// at weight 1).
__device__ __forceinline__ void apply_move(const float* sc, int N, float two_pi, const Move& m) {
  float* S = sS(N);
  if (m.i1 < 0) return;
  if (m.kind == MOVE_TRANSLATE) {
    const float x = S[m.i1], y = S[N + m.i1];
    S[m.i1] = x + (fminf(fmaxf(x + m.dx, sc[S_MNX]), sc[S_MXX]) - x);
    S[N + m.i1] = y + (fminf(fmaxf(y + m.dy, sc[S_MNY]), sc[S_MXY]) - y);
  } else if (m.kind == MOVE_ROTATE) {
    const float rot = S[4 * N + m.i1];
    S[4 * N + m.i1] = rot + (wrap_once(rot + m.drot, two_pi) - rot);
  } else if (m.kind == MOVE_SWAP && m.i1 != m.i2) {
    for (int q = 0; q < 6; ++q) {
      const float v1 = S[q * N + m.i1], v2 = S[q * N + m.i2];
      const float d = v2 - v1;
      S[q * N + m.i1] = v1 + d;
      S[q * N + m.i2] = v2 - d;
    }
  }
}

// plane q's value at lane k as the reference's one-hot sum gives it
// (sum(sel * plane), a sum of zeros and that value): the value, except that a
// zero comes out +0.0, and +0.0 where nothing is picked
__device__ __forceinline__ float one_hot_sum(const float* plane, int k) {
  const float v = k >= 0 ? plane[k] : 0.f;
  return v == 0.f ? 0.f : v;
}

// One move of a compound step on every lane of the six star planes, by warp
// 0 (every lane of it must call): the plane expressions of iter_body_multi
// (fused_mh.py:1493-1512) as the plain version's compound_move computes
// them. On the lanes the move does not pick they add a signed zero, which
// changes only the sign of a -0.0; a chain whose pose holds one takes this.
__device__ void apply_move_all_lanes(const float* sc, int N, float two_pi, const Move& m,
                                     float gate) {
  float* S = sS(N);
  const int lane = threadIdx.x & 31;
  const float is_t = m.kind == MOVE_TRANSLATE ? 1.f : 0.f;
  const float is_r = m.kind == MOVE_ROTATE ? 1.f : 0.f;
  const float sw = (m.kind == MOVE_SWAP ? 1.f : 0.f) * gate;
  NO_UNROLL
  for (int i = lane; i < N; i += 32) {
    const float s1 = i == m.i1 ? 1.f : 0.f;
    const float w_t = is_t * s1 * gate;
    const float x = S[i], y = S[N + i], rot = S[4 * N + i];
    S[i] = x + w_t * (fminf(fmaxf(x + m.dx, sc[S_MNX]), sc[S_MXX]) - x);
    S[N + i] = y + w_t * (fminf(fmaxf(y + m.dy, sc[S_MNY]), sc[S_MXY]) - y);
    S[4 * N + i] = rot + (is_r * s1 * gate) * (wrap_once(rot + m.drot, two_pi) - rot);
  }
  __syncwarp();
  float d[6];
  for (int q = 0; q < 6; ++q) d[q] = one_hot_sum(S + q * N, m.i2) - one_hot_sum(S + q * N, m.i1);
  __syncwarp();
  NO_UNROLL
  for (int i = lane; i < N; i += 32) {
    const float swd = sw * ((i == m.i1 ? 1.f : 0.f) - (i == m.i2 ? 1.f : 0.f));
    for (int q = 0; q < 6; ++q) S[q * N + i] = S[q * N + i] + swd * d[q];
  }
  __syncwarp();
}

// The single-move star and commit expressions of every lane, by warp 0
// (fused_mh.py:1696-1723): x + gate (tdx + swd (x2 - x1)) and so on. On
// every lane but the picks they add a zero, which changes nothing but the
// sign of a -0.0; a chain whose pose holds one commits through this.
__device__ void commit_all_planes(const float* sc, int N, const Shared& sh, float gate,
                                  float two_pi) {
  float* P = sP(N);
  float* S = sS(N);
  const Move& m = sh.mv;
  const float is_t = m.kind == MOVE_TRANSLATE ? 1.f : 0.f;
  const float is_r = m.kind == MOVE_ROTATE ? 1.f : 0.f;
  const float sw = (m.kind == MOVE_SWAP ? 1.f : 0.f) * gate;
  NO_UNROLL
  for (int i = threadIdx.x; i < N; i += 32) {
    const float s1 = i == m.i1 ? 1.f : 0.f, s2 = i == m.i2 ? 1.f : 0.f;
    const float swd = sw * (s1 - s2);
    const float x = P[i], y = P[N + i], rot = P[4 * N + i];
    const float wt = is_t * s1;
    const float tdx = wt * (fminf(fmaxf(x + m.dx, sc[S_MNX]), sc[S_MXX]) - x);
    const float tdy = wt * (fminf(fmaxf(y + m.dy, sc[S_MNY]), sc[S_MXY]) - y);
    const float tdr = (is_r * s1) * (wrap_once(rot + m.drot, two_pi) - rot);
    P[i] = x + gate * (tdx + swd * (sh.r2v[0] - sh.r1v[0]));
    P[N + i] = y + gate * (tdy + swd * (sh.r2v[1] - sh.r1v[1]));
    P[4 * N + i] = rot + gate * (tdr + swd * (sh.r2v[4] - sh.r1v[4]));
    for (int q = 2; q < 6; ++q) {  // z, rotX, rotZ: only a swap moves them
      if (q == 4) continue;
      P[q * N + i] = P[q * N + i] + gate * (0.f + swd * (sh.r2v[q] - sh.r1v[q]));
    }
    for (int q = 0; q < 6; ++q) S[q * N + i] = P[q * N + i];
  }
}

// ---- the objective (costs_of, fused_mh.py:675-1067) -------------------------
// Row i of the symmetry match, by the calling warp: the best candidate for
// reflection i at the star pose -> Bs[i], As[i]. Each lane keeps its first
// best (candidates ascend), then two warp reductions pick the best value
// and the lowest lane-best index that holds it.
__device__ __forceinline__ void rescan_row(const Params& p, int i) {
  const int N = p.n, lane = threadIdx.x & 31;
  const float* S = sS(N);
  const float* MASK = sMASK(N);
  const float pi = p.sc[S_PI], two_pi = 2.f * pi;
  const Refl r = reflect(p.sc, S[i], S[N + i], S[4 * N + i]);
  float best = NEG_HUGE, limit = beat_limit(best);
  int arg = -1;
  NO_UNROLL
  for (int j = lane; j < N; j += 32) {
    if (MASK[j] > 0.f) {
      const float d2 = dist2(S[j], S[N + j], r.x, r.y);
      if (d2 > limit) continue;
      const float v = sym_score(d2, S[4 * N + j], r.r, pi, two_pi);
      if (v > best) {
        best = v;
        arg = j;
        limit = beat_limit(best);
      }
    }
  }
  const int key = order_key(__float_as_int(best));
  const int top = __reduce_max_sync(FULL_MASK, key);
  const unsigned at = __reduce_min_sync(FULL_MASK, key == top ? static_cast<unsigned>(arg) : ~0u);
  if (lane == 0) {
    sBs(N)[i] = __int_as_float(order_key(top));
    sAs(N)[i] = static_cast<int>(at);
  }
}

// Row i of the symmetry match by the calling thread alone, value only: the
// scheme where every row is rescanned keeps no argbest.
__device__ __forceinline__ void full_row(const Params& p, int i) {
  const int N = p.n;
  const float* S = sS(N);
  const float* MASK = sMASK(N);
  const float pi = p.sc[S_PI], two_pi = 2.f * pi;
  const Refl r = reflect(p.sc, S[i], S[N + i], S[4 * N + i]);
  float best = NEG_HUGE, limit = beat_limit(best);
  for (int j = 0; j < N; ++j) {  // unrolled: the block layout's every-row rescan
    if (MASK[j] > 0.f) {
      const float d2 = dist2(S[j], S[N + j], r.x, r.y);
      if (d2 > limit) continue;
      const float v = sym_score(d2, S[4 * N + j], r.r, pi, two_pi);
      if (v > best) {
        best = v;
        limit = beat_limit(best);
      }
    }
  }
  sBs(N)[i] = best;
}

// The relationship, angle and clearance-surface terms of the star pose: a
// few entities each, summed in order, on lane 0 of warps 0, 1 and 2. A sum
// none of whose objects moved is the current pose's (`all`: recompute all).
__device__ void entity_terms(const Params& p, Shared& sh, bool all) {
  const int N = p.n, tid = threadIdx.x;
  const float* X = sS(N);
  const float* Y = X + N;
  const float* R = X + 4 * N;
  const int* MV = sMV(N);
  const bool parity = p.parity;
  const float two_pi = 2.f * p.sc[S_PI];
  if (tid == 0) {
    bool touched = all;
    NO_UNROLL
    for (int r = 0; r < p.n_rel && !touched; ++r)
      touched = MV[p.rel_idx[2 * r]] || MV[p.rel_idx[2 * r + 1]];
    if (!touched) {
      sh.pw = sh.pw_c;
      return;
    }
    float pw = 0.f;
    NO_UNROLL
    for (int r = 0; r < p.n_rel; ++r) {
      const int s = p.rel_idx[2 * r], t = p.rel_idx[2 * r + 1];
      const float lo = p.rel_p[3 * r], hi = p.rel_p[3 * r + 1], rm = p.rel_p[3 * r + 2];
      const float ddx = X[s] - X[t], ddy = Y[s] - Y[t];
      const float d = sqrtf(ddx * ddx + ddy * ddy);
      const float q_near = d / (lo > 0.f ? lo : 1.f);
      const float q_far = hi / (d > 0.f ? d : 1.f);
      const float pen = d < lo ? -(q_near * q_near) : (d > hi ? -(q_far * q_far) : 0.f);
      pw = pw + pen * rm;
    }
    sh.pw = pw;
  } else if (tid == 32) {
    bool touched = all;
    NO_UNROLL
    for (int a = 0; a < p.n_ang && !touched; ++a)
      touched = MV[p.ang_idx[2 * a]] || MV[p.ang_idx[2 * a + 1]];
    if (!touched) {
      sh.pwa = sh.pwa_c;
      return;
    }
    float pwa = 0.f;
    NO_UNROLL
    for (int a = 0; a < p.n_ang; ++a) {
      const int s = p.ang_idx[2 * a], t = p.ang_idx[2 * a + 1];
      const float amin = p.ang_p[3 * a], amax = p.ang_p[3 * a + 1], am = p.ang_p[3 * a + 2];
      float th = atan2_poly(Y[s] - Y[t], X[s] - X[t]);
      th = th < 0.f ? two_pi + th : th;
      th = th - R[t];
      th = th < 0.f ? two_pi + th : th;
      const float dev = fminf(fabsf(th - amin), fabsf(th - amax));
      const bool wrap_case = amin > amax;
      const float norm_wrap = wrap_case ? (amin - amax) / 2.f : 1.f;
      const bool cond_wrap = floor_mod(amin + th, two_pi) > amax;
      const float npl_raw = (two_pi - (amax - amin)) / 2.f;
      const float npl = npl_raw != 0.f ? npl_raw : 1.f;
      const bool cond_plain = parity ? (amin < th || th < amax) : (th < amin || th > amax);
      const float apen = wrap_case ? (cond_wrap ? -dev / norm_wrap : 0.f)
                                   : (cond_plain ? -dev / npl : 0.f);
      pwa = pwa + apen * am;
    }
    sh.pwa = pwa;
  } else if (tid == 64) {
    bool touched = all;
    NO_UNROLL
    for (int c = 0; c < p.n_clr && !touched; ++c) touched = MV[p.clr_idx[2 * c + 1]];
    if (!touched) {
      sh.sa_clr = sh.sa_clr_c;
      return;
    }
    float sa_acc = 0.f;
    NO_UNROLL
    for (int c = 0; c < p.n_clr; ++c) {
      const float* cp = p.clr_p + 6 * c;
      const int anc = p.clr_idx[2 * c + 1];
      const float pax = X[anc], pay = Y[anc];
      sa_acc = sa_acc + outside_area(p.sc, aabb_minx(parity, cp[0], cp[1], cp[2], pax),
                                     cp[3] + pay, cp[4] + pax, cp[5] + pay);
    }
    sh.sa_clr = -sa_acc;
  }
}

// Each thread's strided partials of the reduced rows at the star pose,
// all but the symmetry row: RED[k][t] sums objects t, t + THREADS, ... in
// that order from 0, as the plain version's _block_sum does. The off-limits
// row only with `full_off` (the final report's unslabbed rows; the slab
// rows come from off_rows).
__device__ void lane_partials(const Params& p, bool full_off) {
  const int N = p.n, tid = threadIdx.x, K = R_CLR0 + p.n_clr;
  const float* S = sS(N);
  const float* MASK = sMASK(N);
  const float* pl = p.planes;
  const bool parity = p.parity;
  float* red = sRED(N, K) + tid;
  NO_UNROLL
  for (int k = 0; k < K; ++k) red[k * THREADS] = 0.f;
  NO_UNROLL
  for (int i = tid; i < N; i += THREADS) {
    const float m = MASK[i], x = S[i], y = S[N + i];
    red[R_NX * THREADS] += pl[P_AREA * N + i] * (x * m);
    red[R_NY * THREADS] += pl[P_AREA * N + i] * (y * m);
    red[R_FP * THREADS] += sFPs(N)[i];
    const Box b = obj_box(pl, N, parity, i, x, y);
    red[R_OBJOUT * THREADS] += outside_area(p.sc, b.mnx, b.mny, b.mxx, b.mxy) * m;
    if (full_off) red[R_OFF * THREADS] += off_row(p, S, MASK, i) * m;
    // clearance rects, anchored at their source objects, against this object
    for (int c = 0; c < p.n_clr; ++c) {
      const float* cp = p.clr_p + 6 * c;
      const int src = p.clr_idx[2 * c];
      const float cax = S[src], cay = S[N + src];
      red[(R_CLR0 + c) * THREADS] +=
          inter_area(aabb_minx(parity, cp[0], cp[1], cp[2], cax), cp[3] + cay, cp[4] + cax,
                     cp[5] + cay, b.mnx, b.mny, b.mxx, b.mxy) *
          m;
    }
  }
}

// Every reduced row -> RS, one warp per row, in the order of the halving
// tree over the THREADS strided partials: lane l folds the tree's first two
// levels, (p[l] + p[l+64]) + (p[l+32] + p[l+96]), then shuffles. The
// symmetry row's partials are summed here from the best matches.
__device__ void reduce_rows(const Params& p, bool with_off) {
  const int N = p.n, lane = threadIdx.x & 31, K = R_CLR0 + p.n_clr;
  const float* red = sRED(N, K);
  const float* Bs = sBs(N);
  const float* MASK = sMASK(N);
  NO_UNROLL
  for (int k = threadIdx.x >> 5; k < K; k += WARPS) {
    if (k == R_OFF && !with_off) continue;
    float q[4];
    for (int h = 0; h < 4; ++h) {
      if (k == R_SYM) {
        float acc = 0.f;
        NO_UNROLL
        for (int i = lane + 32 * h; i < N; i += THREADS) acc += fmaxf(Bs[i], 0.f) * MASK[i];
        q[h] = acc;
      } else {
        q[h] = red[k * THREADS + lane + 32 * h];
      }
    }
    float t = (q[0] + q[2]) + (q[1] + q[3]);
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(FULL_MASK, t, o);
    if (lane == 0) sRS(N)[k] = t;
  }
}

// The weighted total of the reduced rows (Kernel.cu:516-550); every thread
// computes the same bits. terms (if given) gets the seven weighted terms.
__device__ __forceinline__ float total_of(const Params& p, const Shared& sh, bool with_off,
                                          float* terms) {
  const float* sc = p.sc;
  const float* RS = sRS(p.n);
  const bool parity = p.parity;
  const float nx = RS[R_NX] / sc[S_DENOM];
  const float ny = RS[R_NY] / sc[S_DENOM];
  const float ex = nx - sc[S_CX2], ey = ny - sc[S_CY2];
  const float vb = -sqrtf(ex * ex + ey * ey);
  const float fp = RS[R_FP];
  const float sym = -RS[R_SYM];
  float clr = 0.f;
  NO_UNROLL
  for (int c = 0; c < p.n_clr; ++c) clr = clr - RS[R_CLR0 + c];
  const float sa = sh.sa_clr + -RS[R_OBJOUT];
  const float pair = parity ? sh.pw * sh.pwa : sh.pw + sh.pwa;

  const float pair_w = sc[S_WPW] * pair, vb_w = sc[S_WVB] * vb, fp_w = sc[S_WFP] * fp;
  const float sym_w = sc[S_WSY] * sym, clr_w = sc[S_WCL] * clr, sa_w = sc[S_WSA] * sa;
  // the JAX kernel's order: sym after the other terms, off-limits last
  float total = pair_w + vb_w + fp_w + clr_w + sa_w;
  total = total + sym_w;
  float off_w = 0.f;
  if (with_off) {
    off_w = sc[S_WOL] * -RS[R_OFF];
    if (!parity) total = total + off_w;
  }
  if (terms) {
    terms[0] = pair_w;
    terms[1] = vb_w;
    terms[2] = fp_w;
    terms[3] = sym_w;
    terms[4] = clr_w;
    terms[5] = off_w;
    terms[6] = sa_w;
  }
  return total;
}


// How score_all takes the off-limits term: not at all, in slab order (the
// start with track_off), or unslabbed (the report)
enum { OFF_NONE, OFF_SLAB, OFF_FULL };

// The full objective of the star pose, every term from scratch (the start
// and the final report). Every thread calls it; it returns synchronized.
__device__ float score_all(const Params& p, Shared& sh, int off, float* terms) {
  const int N = p.n;
  const float* S = sS(N);
  const float* MASK = sMASK(N);
  NO_UNROLL
  for (int i = threadIdx.x; i < N; i += THREADS)
    sFPs(N)[i] = focal_term(p.sc, S[i], S[N + i], S[4 * N + i], MASK[i]);
  lane_partials(p, off == OFF_FULL);
  entity_terms(p, sh, true);
  NO_UNROLL
  for (int i = threadIdx.x >> 5; i < N; i += WARPS) rescan_row(p, i);
  if (off == OFF_SLAB) {
    if (p.off_incremental) {
      off_all_cells(p);
      __syncthreads();
    }
    off_rows(p, sh, true);
  }
  __syncthreads();
  reduce_rows(p, off != OFF_NONE);
  __syncthreads();
  return total_of(p, sh, off != OFF_NONE, terms);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) fused_mh_kernel(const Params p) {
  __shared__ Shared sh;
  PHASE_DECLARE()
  const int N = p.n, tid = threadIdx.x, chain = blockIdx.x;
  const bool compound = p.moves > 1, incremental = p.incremental;
  float* P = sP(N);
  float* S = sS(N);
  float* MASK = sMASK(N);
  float* FPc = sFPc(N);
  float* FPs = sFPs(N);
  int* MV = sMV(N);
  int* MVL = sMVL(N);
  // compound: N_MOVE_ROWS x THREADS
  float* mvt = sRED(N, R_CLR0 + p.n_clr) + (R_CLR0 + p.n_clr) * THREADS;
  const float* sc = p.sc;

  const float* pin = p.pose_in + static_cast<size_t>(chain) * N * 6;
  bool neg_zero_here = false;
  NO_UNROLL
  for (int k = tid; k < 6 * N; k += THREADS) {
    const float v = pin[k];
    P[(k % 6) * N + k / 6] = v;
    S[(k % 6) * N + k / 6] = v;
    neg_zero_here |= __float_as_uint(v) == 0x80000000u;
  }
  NO_UNROLL
  for (int i = tid; i < N; i += THREADS) {
    MASK[i] = p.planes[P_MASK * N + i];
    MV[i] = 0;
    if (p.off_incremental) sBMQ(p)[i] = -1;
  }
  if (p.off_incremental)
    for (int s = tid; s < p.off_slabs; s += THREADS) sTSI(p)[s] = -1;
  if (tid == 0) {
    sh.acc = 0;
    sh.scale = 1.f;
    sh.n_rows[0] = sh.n_rows[1] = sh.n_cols[0] = sh.n_cols[1] = 0;
    sh.off_lim = 0;
    sh.rsel = 0;
  }
  // a chain whose pose holds -0.0 commits single moves through every lane,
  // and applies a compound step's moves to every lane (`every_lane`)
  const bool neg_zero = __syncthreads_or(neg_zero_here);
  const bool every_lane = neg_zero && compound;

  // warp 0 carries the chain's scalar state (its lanes hold the same bits)
  float cur = score_all(p, sh, p.track_off ? OFF_SLAB : OFF_NONE, nullptr), log_scale = 0.f;
  int n_acc = 0;
  NO_UNROLL
  for (int i = tid; i < N; i += THREADS) {
    FPc[i] = FPs[i];
    sBc(N)[i] = sBs(N)[i];
    sAc(N)[i] = sAs(N)[i];
  }
  if (tid == 0) {
    sh.pw_c = sh.pw;
    sh.pwa_c = sh.pwa;
    sh.sa_clr_c = sh.sa_clr;
    sh.rsel = 1;  // off_rows wrote the start's row sums to buffer 1
  }

  const float two_pi = 2.f * sc[S_PI];
  const float gate = sc[S_NUNF] > 0.f ? 1.f : 0.f;
  const int K = p.accept_draws;
  // single move: `lanes` uniforms per step, `unroll` steps per draw counter
  // (fused_mh.py:1868-1875); step t reads lanes lanes*(t % unroll) + [0, lanes)
  // of counter t / unroll, the K accept draws at lanes 8 .. 8+K-1 of its slice
  const int lanes = K == 1 ? PROPOSAL_LANES : PROPOSAL_LANES + K;
  const int unroll = min(4, max(1, DRAW_LANES / lanes));
  const uint32_t gchain = static_cast<uint32_t>(p.first_chain + chain);
  // warp 1 draws and decodes each single move a step ahead, during the
  // reduction, where it has the fewest rows
  if (!compound && tid >> 5 == 1 && p.iterations > 0) draw_single(p, gchain, 0, lanes, unroll, sh);
  __syncthreads();
  PHASE_START()
  for (int t = 0; t < p.iterations; ++t) {
    // 1. draw the move(s) and apply them to S, listing the moved lanes
    if (!compound) {
      if (tid == 0) {
        sh.n_rescan = 0;
        if (p.off_incremental) off_begin(p, sh, t & 1);
        const Move m = scaled(sh.next, p.adapt ? expf(log_scale) : 1.f);
        sh.u_acc = sh.next_u_acc;
        if (neg_zero) {
          sh.mv = m;
          for (int q = 0; q < 6; ++q) {
            sh.r1v[q] = one_hot_sum(P + q * N, m.i1);
            sh.r2v[q] = one_hot_sum(P + q * N, m.i2);
          }
        }
        int listed = 0;
        apply_move(sc, N, two_pi, m);
        if (incremental) list_move(p, sh, m, listed, t & 1);
        sh.n_moved = listed;
      }
      PHASE(0)
      __syncthreads();
      PHASE(1)
    } else {
      // compound step t: the accept draw(s) come from counter t (M + 1), move
      // m from counter t (M + 1) + 1 + m (one draw_block each, fused_mh.py:1453,1477)
      const uint32_t c0 = static_cast<uint32_t>(t) * static_cast<uint32_t>(p.moves + 1);
      if (tid < 32) {
        const float u_acc = K > 1 ? warp_min_uniform(p.seed, gchain, c0, 1, K)
                                  : mh_uniform(p.seed, gchain, c0, 1);
        if (tid == 0) {
          sh.n_rescan = 0;
          if (p.off_incremental) off_begin(p, sh, t & 1);
          sh.u_acc = u_acc;
        }
      }
      int listed = 0;  // thread 0: moved lanes listed so far
      NO_UNROLL
      for (int m0 = 0; m0 < p.moves; m0 += THREADS) {
        const int count = min(THREADS, p.moves - m0);
        if (tid < count) {
          float u[PROPOSAL_LANES];
          const uint32_t ctr = c0 + 1u + static_cast<uint32_t>(m0 + tid);
          for (int k = 0; k < PROPOSAL_LANES; ++k) u[k] = mh_uniform(p.seed, gchain, ctr, k);
          const Move m = scaled(decode_move(p, u), sh.scale);
          // kinds and lanes are small integers, exact in f32
          mvt[M_DX * THREADS + tid] = m.dx;
          mvt[M_DY * THREADS + tid] = m.dy;
          mvt[M_DROT * THREADS + tid] = m.drot;
          mvt[M_KIND * THREADS + tid] = static_cast<float>(m.kind);
          mvt[M_I1 * THREADS + tid] = static_cast<float>(m.i1);
          mvt[M_I2 * THREADS + tid] = static_cast<float>(m.i2);
        }
        __syncthreads();
        // thread 0 applies the moves in order at their picks (warp 0 on
        // every lane for a chain holding -0.0) and lists what they touch
        if (tid == 0 && !every_lane) {
          NO_UNROLL
          for (int j = 0; j < count; ++j) {
            const Move m{mvt[M_DX * THREADS + j], mvt[M_DY * THREADS + j],
                         mvt[M_DROT * THREADS + j], static_cast<int>(mvt[M_KIND * THREADS + j]),
                         static_cast<int>(mvt[M_I1 * THREADS + j]),
                         static_cast<int>(mvt[M_I2 * THREADS + j])};
            apply_move(sc, N, two_pi, m);
            if (incremental) list_move(p, sh, m, listed, t & 1);
          }
        } else if (every_lane && tid < 32) {
          NO_UNROLL
          for (int j = 0; j < count; ++j) {
            const Move m{mvt[M_DX * THREADS + j], mvt[M_DY * THREADS + j],
                         mvt[M_DROT * THREADS + j], static_cast<int>(mvt[M_KIND * THREADS + j]),
                         static_cast<int>(mvt[M_I1 * THREADS + j]),
                         static_cast<int>(mvt[M_I2 * THREADS + j])};
            apply_move_all_lanes(sc, N, two_pi, m, gate);
            if (tid == 0 && incremental) list_move(p, sh, m, listed, t & 1);
          }
        }
        if (tid == 0) sh.n_moved = listed;
        __syncthreads();
      }
    }

    // 2. per-lane terms of the moved lanes (of every lane without the
    // state, which lists no lanes); the symmetry rows that the moved
    // candidates settle, and the list of rows to rescan; the entity terms.
    // Each thread first takes the last step's accepted state of its rows
    // (and of its off-limits star slots). With the off-limits state, the
    // star cells the moves change.
    const int n_moved = sh.n_moved;
    const bool took = sh.acc;
    NO_UNROLL
    for (int i = tid; i < N; i += THREADS) {
      const bool moved = MV[i] != 0;
      if (moved || !incremental) FPs[i] = focal_term(sc, S[i], S[N + i], S[4 * N + i], MASK[i]);
      if (incremental) {
        if (took) {
          sBc(N)[i] = sBs(N)[i];
          sAc(N)[i] = sAs(N)[i];
        }
        const int a = sAc(N)[i];
        if (moved || (a >= 0 && MV[a])) {
          sLIST(N)[atomicAdd(&sh.n_rescan, 1)] = i;
        } else {
          // the best over the unmoved candidates is still Bc[i], at Ac[i]
          float best = sBc(N)[i];
          int arg = a;
          const Refl r = reflect(sc, S[i], S[N + i], S[4 * N + i]);
          const float limit = beat_limit(best);
          NO_UNROLL
          for (int q = 0; q < n_moved; ++q) {
            const int k = MVL[q];
            if (MASK[k] > 0.f) {
              const float d2 = dist2(S[k], S[N + k], r.x, r.y);
              if (d2 > limit) continue;
              const float v = sym_score(d2, S[4 * N + k], r.r, sc[S_PI], two_pi);
              if (better(v, k, best, arg)) {
                best = v;
                arg = k;
              }
            }
          }
          sBs(N)[i] = best;
          sAs(N)[i] = arg;
        }
      }
    }
    PHASE(2)
    lane_partials(p, false);
    entity_terms(p, sh, !incremental);
    PHASE(3)
    if (p.off_incremental) off_update(p, sh, t & 1, took);
    PHASE(4)
    if (incremental) __syncthreads();
    PHASE(5)

    // 3. rescan the listed rows, a warp each (without the state every row,
    // a thread each); each thread's off-limits partial from the cells and
    // the star slots
    if (incremental) {
      NO_UNROLL
      for (int r = tid >> 5; r < sh.n_rescan; r += WARPS) rescan_row(p, sLIST(N)[r]);
    } else {
      NO_UNROLL
      for (int i = tid; i < N; i += THREADS) full_row(p, i);
    }
    PHASE(6)
    if (p.track_off) off_rows(p, sh, false);
    PHASE(7)
    __syncthreads();
    PHASE(8)

    // 4. reduce the rows; warp 1 then draws the next single move
    reduce_rows(p, p.track_off);
    if (!compound && tid >> 5 == 1 && t + 1 < p.iterations)
      draw_single(p, gchain, t + 1, lanes, unroll, sh);
    PHASE(9)
    __syncthreads();
    PHASE(10)

    // 5. warp 0 scores and accepts, then commits the moved lanes (S -> P)
    // or drops them (P -> S), every lane without the state or where every
    // lane moved, and clears their flags; on accept the star row sums become
    // current (the star cells at the next step); the other warps go on to
    // the next step's first barrier
    if (tid < 32) {
      const float total = total_of(p, sh, p.track_off, nullptr);
      const float ratio = expf(fminf(sc[S_BETA] * (total - cur), 0.f));
      const bool acc = sh.u_acc < ratio && gate > 0.f;
      if (acc) cur = total;
      n_acc += acc;
      if (p.adapt) log_scale = log_scale + sc[S_ADAPTR] * ((acc ? 1.f : 0.f) - sc[S_TARGET]);
      const bool all_planes = acc && neg_zero && !compound;
      if (all_planes) commit_all_planes(sc, N, sh, gate, two_pi);
      const bool by_list = incremental && !every_lane;
      const int n_commit = by_list ? n_moved : N;
      NO_UNROLL
      for (int q = tid; q < n_commit; q += 32) {
        const int k = by_list ? MVL[q] : q;
        MV[k] = 0;
        if (acc) {
          if (!all_planes)
            for (int c = 0; c < 6; ++c) P[c * N + k] = S[c * N + k];
          FPc[k] = FPs[k];
        } else {
          for (int c = 0; c < 6; ++c) S[c * N + k] = P[c * N + k];
          FPs[k] = FPc[k];
        }
      }
      if (tid == 0) {
        sh.acc = acc;
        sh.scale = p.adapt ? expf(log_scale) : 1.f;
        if (acc) {
          sh.pw_c = sh.pw;
          sh.pwa_c = sh.pwa;
          sh.sa_clr_c = sh.sa_clr;
          sh.rsel ^= 1;
        }
      }
      PHASE(11)
      __syncwarp();
    }
    // a compound step's draws read sh.scale
    if (compound) __syncthreads();
  }
  __syncthreads();
  PHASE_FLUSH()

  // final breakdown; off-limits is always evaluated for the report
  float terms[7];
  const float total = score_all(p, sh, OFF_FULL, terms);
  float* pout = p.pose_out + static_cast<size_t>(chain) * N * 6;
  NO_UNROLL
  for (int k = tid; k < 6 * N; k += THREADS) pout[k] = P[(k % 6) * N + k / 6];
  if (tid == 0) {
    float* st = p.stats + static_cast<size_t>(chain) * N_STATS;
    st[0] = total;
    for (int k = 0; k < 7; ++k) st[1 + k] = terms[k];
    st[8] = __int_as_float(n_acc);  // the count's bits: exact past 2^24
    st[9] = expf(log_scale);
  }
}

__global__ void uniform_block_kernel(float* out, uint32_t seed, uint32_t counter,
                                     int first_chain) {
  const uint32_t chain = static_cast<uint32_t>(first_chain) + blockIdx.x;
  out[static_cast<size_t>(blockIdx.x) * DRAW_LANES + threadIdx.x] =
      mh_uniform(seed, chain, counter, threadIdx.x);
}

}  // namespace

extern "C" {

// Runs `iterations` MH steps of `n_chains` chains on `stream`. Returns the
// cudaError_t of the launch (0 on success); the kernel runs asynchronously.
int mh_fused_run(const float* pose_in, float* pose_out, float* stats, const float* planes,
                 const int* unf_idx, const float* sc, const int* rel_idx, const float* rel_p,
                 const int* ang_idx, const float* ang_p, const int* clr_idx,
                 const float* clr_p, int n_rel, int n_ang, int n_clr, int n, int n_chains,
                 uint32_t seed, int iterations, int first_chain, int parity, int track_off,
                 int adapt, int moves, int accept_draws, int incremental, int off_width,
                 int off_incremental, void* stream) {
  if (moves < 1 || accept_draws < 1 || accept_draws > MAX_ACCEPT_DRAWS ||
      (track_off && off_width < 1) || (off_incremental && !(track_off && incremental)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int off_slabs = track_off ? (n + off_width - 1) / off_width : 0;
  const int off_slots = off_incremental ? 2 * moves : 0;
  const int S = off_incremental ? off_slabs : 0, T = off_slots;
  Params p{pose_in, pose_out, stats, planes, unf_idx, sc, rel_idx, rel_p,
           ang_idx, ang_p, clr_idx, clr_p, n_rel, n_ang, n_clr, n, n_chains,
           seed, iterations, first_chain, parity, track_off, adapt, moves, accept_draws,
           incremental, off_width, off_slabs, off_incremental, off_slots, {}};
  // SMEM_WORDS_PER_OBJECT words per object, the reduced rows' sums and
  // partials, the compound step's move table, then the off-limits state
  // (sizes < 2^31 words: smem_bytes in fused_mh.py caps n first)
  p.off.oc = SMEM_WORDS_PER_OBJECT * n + (R_CLR0 + n_clr) * (1 + THREADS) +
             (moves > 1 ? N_MOVE_ROWS * THREADS : 0);
  p.off.ox = p.off.oc + S * n;
  p.off.oy = p.off.ox + T * n;
  p.off.oyc = p.off.oy + T * S;
  p.off.rows = p.off.oyc + T * S;
  p.off.tsi = p.off.rows + 2 * n;
  p.off.bmq = p.off.tsi + S;
  p.off.tsl = p.off.bmq + n;
  p.off.bml = p.off.tsl + 2 * T;
  p.off.end = off_incremental ? p.off.bml + 2 * T : p.off.oc;
  const size_t smem = sizeof(float) * static_cast<size_t>(p.off.end);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_mh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n_chains > 0)
    fused_mh_kernel<<<n_chains, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Writes the uniforms of one draw counter: out f32[n_chains, 128].
int mh_uniform_block(float* out, uint32_t seed, uint32_t counter, int first_chain,
                     int n_chains, void* stream) {
  if (n_chains > 0)
    uniform_block_kernel<<<n_chains, DRAW_LANES, 0, static_cast<cudaStream_t>(stream)>>>(
        out, seed, counter, first_chain);
  return static_cast<int>(cudaGetLastError());
}

#ifdef MH_PHASE_PROFILE
// mh_phase_cycles -> out (u64[WARPS * N_PHASES + 1]), or to zero
int mh_phase_cycles_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, mh_phase_cycles, sizeof(mh_phase_cycles)));
}
int mh_phase_cycles_reset() {
  void* at = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&at, mh_phase_cycles);
  return static_cast<int>(e != cudaSuccess ? e : cudaMemset(at, 0, sizeof(mh_phase_cycles)));
}
#endif

const char* mh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
