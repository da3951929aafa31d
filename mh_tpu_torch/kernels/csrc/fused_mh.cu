// The fused Metropolis-Hastings chain kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_kernel` (mh_tpu/kernels/fused_mh.py:405):
// one launch runs every MH step of every chain -- counter-RNG proposal, the
// seven-term layout objective, the Boltzmann accept and the commit -- and then
// reports each chain's weighted cost breakdown. The plain PyTorch version of
// this exact algorithm is `fused_chains_reference` in ../fused_mh.py; both
// sum in the same fixed order (per-thread strided sums, then a halving tree
// over THREADS partials), so they agree bit for bit when the math library does.
//
// Layout: one thread block per chain, THREADS threads, thread t owning object
// lanes t, t + THREADS, ... The current pose (6 planes x N) and the proposed
// ("star") planes live in shared memory; the scene is read from global
// memory (it is small and stays in L1/L2).
//
// A step proposes one move (translate / rotate / swap), or with
// `moves > 1` a compound block proposal of `moves` sequential moves
// (`iter_body_multi`, fused_mh.py:1444-1575: the deterministic form of the
// reference's blockxDim per-thread proposals, Kernel.cu:798-828), and
// accepts against one uniform or, with `accept_draws = K > 1`, against the
// minimum of K (Kernel.cu:819). For a compound step the threads draw and
// decode up to THREADS moves at once; thread 0 then applies them in order,
// each touching only the <= 2 objects it picked in the six star planes.
//
// What bounds it: the symmetry term is O(N^2) arithmetic per chain per step
// (every object's reflection is matched against every object: 10^4 sym_val
// evaluations per step at 100 objects), and FIXED mode with a weighted
// off-limits term adds another O(N^2) overlap sum. This version recomputes
// both in full every step, as the JAX kernel's `incremental=False` path
// does; carrying per-slab maxima to make the step O(N) (fused_mh.py:
// 1082-1173) is later work. There is no matrix product: the TPU kernel's
// one-hot MXU gathers are plain indexed loads here.
//
// Numerics: build with --fmad=false and without --use_fast_math, so every
// operation is rounded as the PyTorch version rounds it.

#include <cstdint>
#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int PROPOSAL_LANES = 8;  // uniforms one move consumes
constexpr int DRAW_LANES = 128;    // uniforms per (chain, draw counter)
constexpr int MAX_ACCEPT_DRAWS = DRAW_LANES - PROPOSAL_LANES;
constexpr int N_STATS = 10;
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
// rows of the reduction buffer; clearance c reduces in row R_CLR0 + c
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
};

// Per-block values that one thread computes and all threads read.
struct Shared {
  float u_acc, dx, dy, drot, is_t, is_r, sw, scale;
  int i1, i2;             // lanes of the two picked objects (-1: none)
  float r1v[6], r2v[6];   // current pose planes at i1 / i2
  float total, terms[7];  // costs of the last evaluated pose
  float pw, pwa, sa_clr;  // entity terms of the last evaluated pose
  int acc;
};

// One decoded move (fused_mh.py:1478-1491, :1657-1693)
struct Move {
  float dx, dy, drot;
  int kind, i1, i2;
};

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

// match score of candidate c vs reflection r (Kernel.cu:301-312)
__device__ __forceinline__ float sym_val(float cx, float cy, float cr, float rx, float ry,
                                         float rr, float pi, float two_pi) {
  const float ddx = cx - rx, ddy = cy - ry;
  const float dp = sqrtf(ddx * ddx + ddy * ddy);
  float dt = cr - rr;
  dt = dt > pi ? dt - two_pi : dt;
  return 5.f - sqrtf(dp) - 0.4f * fabsf(dt);
}

// ---- proposal ---------------------------------------------------------------
// The move that 8 uniforms u[0..7] drive (fused_mh.py:1478-1491): kind from
// u0, Box-Muller steps from u2..u5, and two objects picked by rank among the
// movable ones from u6, u7 (fused_mh.py:1675-1693). Lane 1 is the accept draw.
__device__ __forceinline__ Move decode_move(const Params& p, const float* u, float scale) {
  const float* sc = p.sc;
  Move m;
  const int move = min(static_cast<int>(u[0] * 3.f), 2);
  const float r1 = sqrtf(-2.f * logf(u[2]));
  const float r2 = sqrtf(-2.f * logf(u[4]));
  m.dx = r1 * cosf(TWO_PI_TRUE * u[3]) * sc[S_SIGX] * scale;
  m.dy = r1 * sinf(TWO_PI_TRUE * u[3]) * sc[S_SIGY] * scale;
  m.drot = r2 * cosf(TWO_PI_TRUE * u[5]) * sc[S_SIGT] * scale;
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

__device__ __forceinline__ void draw_move_uniforms(const Params& p, uint32_t gchain,
                                                   uint32_t counter, uint32_t lane0, float* u) {
  for (int k = 0; k < PROPOSAL_LANES; ++k) u[k] = mh_uniform(p.seed, gchain, counter, lane0 + k);
}

// min over lanes lane0 .. lane0 + k - 1 of one draw counter, computed by the
// whole calling warp (every lane of it must call) and returned to every lane
__device__ __forceinline__ float warp_min_uniform(uint32_t seed, uint32_t gchain,
                                                  uint32_t counter, uint32_t lane0, int k) {
  float m = 2.f;  // above every uniform
  for (int j = threadIdx.x & 31; j < k; j += 32)
    m = fminf(m, mh_uniform(seed, gchain, counter, lane0 + j));
  for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Apply one move of a compound step to the six star planes S (thread 0 only).
// Each update rounds as the plane expressions of iter_body_multi
// (fused_mh.py:1493-1512) round at the picked lanes: x + w (clip(x+dx) - x)
// and rot + w (wrapped - rot) with w = 1, and a swap as v1 + (v2 - v1),
// v2 - (v2 - v1) from the pre-swap values.
__device__ __forceinline__ void apply_move(const float* sc, float* S, int N, float two_pi,
                                           const Move& m) {
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

// The weighted objective of the pose planes (X, Y, R) -> sh.total, sh.terms
// (costs_of, fused_mh.py:675-1067). Every thread calls it; it ends synchronized.
__device__ void eval_costs(const Params& p, const float* X, const float* Y, const float* R,
                           const float* MASK, float* red, Shared& sh, bool with_off) {
  const int N = p.n, tid = threadIdx.x, K = R_CLR0 + p.n_clr;
  const float* pl = p.planes;
  const float* sc = p.sc;
  const bool parity = p.parity;
  const float pi = sc[S_PI], two_pi = 2.f * pi;
  const float fx = sc[S_FX], fy = sc[S_FY], ux = sc[S_UX], uy = sc[S_UY];
  const float fxy = fx * ux + fy * uy;
  const float frot2 = 2.f * sc[S_FROT];

  for (int k = 0; k < K; ++k) red[k * THREADS + tid] = 0.f;
  for (int i = tid; i < N; i += THREADS) {
    const float m = MASK[i], x = X[i], y = Y[i], rot = R[i];
    const float area = pl[P_AREA * N + i];
    red[R_NX * THREADS + tid] += area * (x * m);
    red[R_NY * THREADS + tid] += area * (y * m);

    // focal point by angle addition (fused_mh.py:876-883)
    const float dxf = fx - x, dyf = fy - y;
    const float rf = sqrtf(dxf * dxf + dyf * dyf);
    const float srot = sinf(rot);
    float cph = (dxf * srot - dyf * cosf(rot)) / (rf > 0.f ? rf : 1.f);
    cph = rf > 0.f ? cph : srot;
    red[R_FP * THREADS + tid] += -cph * m;

    const float omnx = aabb_minx(parity, pl[P_OV0X * N + i], pl[P_OTAILX * N + i],
                                 pl[P_OMINX * N + i], x);
    const float omny = pl[P_OMINY * N + i] + y;
    const float omxx = pl[P_OMAXX * N + i] + x;
    const float omxy = pl[P_OMAXY * N + i] + y;
    red[R_OBJOUT * THREADS + tid] += outside_area(sc, omnx, omny, omxx, omxy) * m;

    // symmetry: best match of i's reflection over every candidate j
    const float s = 2.f * (fxy - (x * ux + y * uy));
    const float rx = x + s * ux, ry = y + s * uy;
    float rr = frot2 - rot;
    rr = rr < -pi ? rr + two_pi : rr;
    float best = NEG_HUGE;
    for (int j = 0; j < N; ++j) {
      const float v = MASK[j] > 0.f ? sym_val(X[j], Y[j], R[j], rx, ry, rr, pi, two_pi)
                                    : NEG_HUGE;
      best = fmaxf(best, v);
    }
    red[R_SYM * THREADS + tid] += fmaxf(best, 0.f) * m;

    // off-limits overlap with every later object (Kernel.cu:485-514)
    if (with_off) {
      float row = 0.f;
      for (int j = i + 1; j < N; ++j) {
        const float jx = X[j], jy = Y[j];
        const float ar = inter_area(
            omnx, omny, omxx, omxy,
            aabb_minx(parity, pl[P_OV0X * N + j], pl[P_OTAILX * N + j], pl[P_OMINX * N + j], jx),
            pl[P_OMINY * N + j] + jy, pl[P_OMAXX * N + j] + jx, pl[P_OMAXY * N + j] + jy);
        row = row + ar * MASK[j];
      }
      red[R_OFF * THREADS + tid] += row * m;
    }

    // clearance rects (anchored at their source object) vs this object
    for (int c = 0; c < p.n_clr; ++c) {
      const float* cp = p.clr_p + 6 * c;
      const int src = p.clr_idx[2 * c];
      const float cax = X[src], cay = Y[src];
      const float ar = inter_area(aabb_minx(parity, cp[0], cp[1], cp[2], cax), cp[3] + cay,
                                  cp[4] + cax, cp[5] + cay, omnx, omny, omxx, omxy);
      red[(R_CLR0 + c) * THREADS + tid] += ar * m;
    }
  }

  if (tid == 0) {
    // relationship, angle and clearance-surface terms: a few entities, summed in order
    float pw = 0.f;
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
    float pwa = 0.f;
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
    float sa_acc = 0.f;
    for (int c = 0; c < p.n_clr; ++c) {
      const float* cp = p.clr_p + 6 * c;
      const int anc = p.clr_idx[2 * c + 1];
      const float pax = X[anc], pay = Y[anc];
      sa_acc = sa_acc + outside_area(sc, aabb_minx(parity, cp[0], cp[1], cp[2], pax),
                                     cp[3] + pay, cp[4] + pax, cp[5] + pay);
    }
    sh.pw = pw;
    sh.pwa = pwa;
    sh.sa_clr = -sa_acc;
  }
  __syncthreads();

  // fixed-order tree over the THREADS partials of every row
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int k = 0; k < K; ++k) red[k * THREADS + tid] += red[k * THREADS + tid + s];
    __syncthreads();
  }

  if (tid == 0) {
    const float nx = red[R_NX * THREADS] / sc[S_DENOM];
    const float ny = red[R_NY * THREADS] / sc[S_DENOM];
    const float ex = nx - sc[S_CX2], ey = ny - sc[S_CY2];
    const float vb = -sqrtf(ex * ex + ey * ey);
    const float fp = red[R_FP * THREADS];
    const float sym = -red[R_SYM * THREADS];
    float clr = 0.f;
    for (int c = 0; c < p.n_clr; ++c) clr = clr - red[(R_CLR0 + c) * THREADS];
    const float sa = sh.sa_clr + -red[R_OBJOUT * THREADS];
    const float pair = parity ? sh.pw * sh.pwa : sh.pw + sh.pwa;

    const float pair_w = sc[S_WPW] * pair, vb_w = sc[S_WVB] * vb, fp_w = sc[S_WFP] * fp;
    const float sym_w = sc[S_WSY] * sym, clr_w = sc[S_WCL] * clr, sa_w = sc[S_WSA] * sa;
    // the JAX kernel's order: sym after the other terms, off-limits last
    float total = pair_w + vb_w + fp_w + clr_w + sa_w;
    total = total + sym_w;
    float off_w = 0.f;
    if (with_off) {
      off_w = sc[S_WOL] * -red[R_OFF * THREADS];
      if (!parity) total = total + off_w;
    }
    sh.total = total;
    sh.terms[0] = pair_w;
    sh.terms[1] = vb_w;
    sh.terms[2] = fp_w;
    sh.terms[3] = sym_w;
    sh.terms[4] = clr_w;
    sh.terms[5] = off_w;
    sh.terms[6] = sa_w;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) fused_mh_kernel(const Params p) {
  extern __shared__ float smem[];
  __shared__ Shared sh;
  const int N = p.n, tid = threadIdx.x, chain = blockIdx.x;
  const bool compound = p.moves > 1;
  float* P = smem;  // 6 x N current pose planes (x, y, z, rotX, rotY, rotZ)
  // star planes: x, y, rotY for one move; all six for a compound step, whose
  // swaps also move z, rotX and rotZ
  float* S = P + 6 * N;
  float* X = S;
  float* Y = S + N;
  float* R = compound ? S + 4 * N : S + 2 * N;
  float* MASK = S + (compound ? 6 : 3) * N;  // object mask
  float* red = MASK + N;                      // (R_CLR0 + n_clr) x THREADS partial sums
  float* mv = red + (R_CLR0 + p.n_clr) * THREADS;  // compound: N_MOVE_ROWS x THREADS
  const float* sc = p.sc;

  const float* pin = p.pose_in + static_cast<size_t>(chain) * N * 6;
  for (int k = tid; k < 6 * N; k += THREADS) P[(k % 6) * N + k / 6] = pin[k];
  for (int i = tid; i < N; i += THREADS) MASK[i] = p.planes[P_MASK * N + i];
  __syncthreads();

  eval_costs(p, P, P + N, P + 4 * N, MASK, red, sh, p.track_off);
  // thread 0 carries the chain's scalar state
  float cur = sh.total, log_scale = 0.f;
  int n_acc = 0;

  const float two_pi = 2.f * sc[S_PI];
  const float gate = sc[S_NUNF] > 0.f ? 1.f : 0.f;
  const int K = p.accept_draws;
  // single move: `lanes` uniforms per step, `unroll` steps per draw counter
  // (fused_mh.py:1868-1875); step t reads lanes lanes*(t % unroll) + [0, lanes)
  // of counter t / unroll, the K accept draws at lanes 8 .. 8+K-1 of its slice
  const int lanes = K == 1 ? PROPOSAL_LANES : PROPOSAL_LANES + K;
  const int unroll = min(4, max(1, DRAW_LANES / lanes));
  const uint32_t gchain = static_cast<uint32_t>(p.first_chain + chain);
  for (int t = 0; t < p.iterations; ++t) {
    if (!compound) {
      if (tid < 32) {
        const uint32_t counter = static_cast<uint32_t>(t / unroll);
        const uint32_t lane0 = static_cast<uint32_t>(lanes * (t % unroll));
        const float u_min =
            K > 1 ? warp_min_uniform(p.seed, gchain, counter, lane0 + PROPOSAL_LANES, K) : 0.f;
        if (tid == 0) {
          float u[PROPOSAL_LANES];
          draw_move_uniforms(p, gchain, counter, lane0, u);
          const Move m = decode_move(p, u, p.adapt ? expf(log_scale) : 1.f);
          sh.u_acc = K > 1 ? u_min : u[1];
          sh.dx = m.dx;
          sh.dy = m.dy;
          sh.drot = m.drot;
          sh.i1 = m.i1;
          sh.i2 = m.i2;
          sh.is_t = m.kind == MOVE_TRANSLATE ? 1.f : 0.f;
          sh.is_r = m.kind == MOVE_ROTATE ? 1.f : 0.f;
          sh.sw = (m.kind == MOVE_SWAP ? 1.f : 0.f) * gate;
          for (int q = 0; q < 6; ++q) {
            sh.r1v[q] = m.i1 >= 0 ? P[q * N + m.i1] : 0.f;
            sh.r2v[q] = m.i2 >= 0 ? P[q * N + m.i2] : 0.f;
          }
        }
      }
      __syncthreads();

      // star pose: translate / rotate the first pick, or swap the two picks
      // (the plane expressions of fused_mh.py:1696-1723)
      const float sw = sh.sw;
      for (int i = tid; i < N; i += THREADS) {
        const float s1 = i == sh.i1 ? 1.f : 0.f, s2 = i == sh.i2 ? 1.f : 0.f;
        const float swd = sw * (s1 - s2);
        const float x = P[i], y = P[N + i], rot = P[4 * N + i];
        const float wt = sh.is_t * s1;
        const float tdx = wt * (fminf(fmaxf(x + sh.dx, sc[S_MNX]), sc[S_MXX]) - x);
        const float tdy = wt * (fminf(fmaxf(y + sh.dy, sc[S_MNY]), sc[S_MXY]) - y);
        const float tdr = (sh.is_r * s1) * (wrap_once(rot + sh.drot, two_pi) - rot);
        X[i] = x + gate * (tdx + swd * (sh.r2v[0] - sh.r1v[0]));
        Y[i] = y + gate * (tdy + swd * (sh.r2v[1] - sh.r1v[1]));
        R[i] = rot + gate * (tdr + swd * (sh.r2v[4] - sh.r1v[4]));
      }
      __syncthreads();
    } else {
      // compound step t: the accept draw(s) come from counter t (M + 1), move
      // m from counter t (M + 1) + 1 + m (one draw_block each, fused_mh.py:1453,1477)
      const uint32_t c0 = static_cast<uint32_t>(t) * static_cast<uint32_t>(p.moves + 1);
      for (int k = tid; k < 6 * N; k += THREADS) S[k] = P[k];
      if (tid < 32) {
        const float u_acc = K > 1 ? warp_min_uniform(p.seed, gchain, c0, 1, K)
                                  : mh_uniform(p.seed, gchain, c0, 1);
        if (tid == 0) {
          sh.u_acc = u_acc;
          sh.scale = p.adapt ? expf(log_scale) : 1.f;  // once per step, before the moves
        }
      }
      __syncthreads();
      for (int m0 = 0; m0 < p.moves; m0 += THREADS) {
        const int count = min(THREADS, p.moves - m0);
        if (tid < count) {
          float u[PROPOSAL_LANES];
          draw_move_uniforms(p, gchain, c0 + 1u + static_cast<uint32_t>(m0 + tid), 0, u);
          const Move m = decode_move(p, u, sh.scale);
          // kinds and lanes are small integers, exact in f32
          mv[M_DX * THREADS + tid] = m.dx;
          mv[M_DY * THREADS + tid] = m.dy;
          mv[M_DROT * THREADS + tid] = m.drot;
          mv[M_KIND * THREADS + tid] = static_cast<float>(m.kind);
          mv[M_I1 * THREADS + tid] = static_cast<float>(m.i1);
          mv[M_I2 * THREADS + tid] = static_cast<float>(m.i2);
        }
        __syncthreads();
        if (tid == 0) {
          for (int j = 0; j < count; ++j) {
            const Move m{mv[M_DX * THREADS + j], mv[M_DY * THREADS + j],
                         mv[M_DROT * THREADS + j], static_cast<int>(mv[M_KIND * THREADS + j]),
                         static_cast<int>(mv[M_I1 * THREADS + j]),
                         static_cast<int>(mv[M_I2 * THREADS + j])};
            apply_move(sc, S, N, two_pi, m);
          }
        }
        __syncthreads();
      }
    }

    eval_costs(p, X, Y, R, MASK, red, sh, p.track_off);

    if (tid == 0) {
      const float ratio = expf(fminf(sc[S_BETA] * (sh.total - cur), 0.f));
      const bool acc = sh.u_acc < ratio && gate > 0.f;
      if (acc) cur = sh.total;
      n_acc += acc;
      if (p.adapt) log_scale = log_scale + sc[S_ADAPTR] * ((acc ? 1.f : 0.f) - sc[S_TARGET]);
      sh.acc = acc;
    }
    __syncthreads();

    if (sh.acc) {
      if (compound) {
        for (int k = tid; k < 6 * N; k += THREADS) P[k] = S[k];
      } else {
        const float sw = sh.sw;
        for (int i = tid; i < N; i += THREADS) {
          const float swd = sw * ((i == sh.i1 ? 1.f : 0.f) - (i == sh.i2 ? 1.f : 0.f));
          P[i] = X[i];
          P[N + i] = Y[i];
          P[4 * N + i] = R[i];
          for (int q = 2; q < 6; ++q) {  // z, rotX, rotZ: only a swap moves them
            if (q == 4) continue;
            P[q * N + i] = P[q * N + i] + gate * (0.f + swd * (sh.r2v[q] - sh.r1v[q]));
          }
        }
      }
    }
    __syncthreads();
  }

  // final breakdown; off-limits is always evaluated for the report
  eval_costs(p, P, P + N, P + 4 * N, MASK, red, sh, true);
  float* pout = p.pose_out + static_cast<size_t>(chain) * N * 6;
  for (int k = tid; k < 6 * N; k += THREADS) pout[k] = P[(k % 6) * N + k / 6];
  if (tid == 0) {
    float* st = p.stats + static_cast<size_t>(chain) * N_STATS;
    st[0] = sh.total;
    for (int k = 0; k < 7; ++k) st[1 + k] = sh.terms[k];
    st[8] = static_cast<float>(n_acc);
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
                 int adapt, int moves, int accept_draws, void* stream) {
  if (moves < 1 || accept_draws < 1 || accept_draws > MAX_ACCEPT_DRAWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{pose_in, pose_out, stats, planes, unf_idx, sc, rel_idx, rel_p,
                 ang_idx, ang_p, clr_idx, clr_p, n_rel, n_ang, n_clr, n, n_chains,
                 seed, iterations, first_chain, parity, track_off, adapt, moves, accept_draws};
  // pose 6N + star 3N (6N compound) + mask N, the reduction rows, and the
  // compound step's move table
  const bool compound = moves > 1;
  const size_t smem =
      sizeof(float) * ((compound ? 13 : 10) * static_cast<size_t>(n) +
                       static_cast<size_t>(R_CLR0 + n_clr) * THREADS +
                       (compound ? N_MOVE_ROWS * THREADS : 0));
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

const char* mh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
