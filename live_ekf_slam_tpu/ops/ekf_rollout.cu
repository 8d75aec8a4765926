// Fused sim + EKF-SLAM / RI-EKF-SLAM Monte-Carlo rollout for Hopper (sm_90a).
//
// One warp owns one world for the whole T-tick rollout: truth propagation,
// FOV-culled range-bearing sensing, filter predict and the sequential
// per-landmark updates/insertions all run inside one launch, with the
// world's covariance resident in shared memory from the first tick to the
// last. Device memory sees only the command and noise streams in and the
// final state out.
//
// Layout decisions (see ops/fused_rollout.py for the Python side and the
// plain-JAX reference that computes the same algebra):
//   * P is stored packed lower-triangular (D(D+1)/2 floats, D = 3 + 2N).
//     At N = 20 that is 3.7 KB per world, so four worlds per 128-thread
//     block fit eight blocks per SM: 32 worlds per SM, 4224 on 132 SMs,
//     i.e. the 4096-world batch runs in one wave. Packed storage also keeps
//     P exactly symmetric, so the update P -= K (H P) can read H P from the
//     same columns as P H^T.
//   * landmark slot == landmark id, so every index is a plain integer; a
//     world that does not see landmark j skips its update/insertion with a
//     warp-uniform branch (one warp = one world).
//   * the rank-2 downdate walks the packed triangle with a per-block
//     (row, col) table so every lane does the same number of elements.
//
// Noise is injected: noise[b, t, :] = (u_d, u_h, u_r[0..N), u_b[0..N)) in
// [-1, 1), the same draws the reference and the closed-form sim consume.
//
// Host build (interpret mode): compiled by a C++ compiler instead of nvcc,
// the same source runs with a warp of one lane and one world per block, so
// every lane loop runs serially and the barriers are no-ops. It checks the
// kernel's algebra and indexing on the CPU; the lane parallelism, barrier
// placement and shared-memory sizing are exercised only on the GPU.

#include <cstdint>
#include <cmath>
#include <string>
#include <vector>

#include "xla/ffi/api/ffi.h"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#define __host__
#define __device__
#define __forceinline__ inline
struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
inline void __syncwarp() {}
inline void __syncthreads() {}
#endif

namespace ffi = xla::ffi;

namespace {

#ifdef __CUDACC__
constexpr int kWarp = 32;
#else
constexpr int kWarp = 1;
#endif
constexpr int kMaxWorldsPerBlock = 4;
constexpr int kMaxSmem = 227 * 1024;
constexpr float kTwoPi = 6.283185307179586f;

// params[] layout; must match _kernel_params in ops/fused_rollout.py.
enum Param {
  kV00s, kV11s, kW00s, kW11s,      // sim noise half-widths (scaled)
  kV00f, kV11f, kW00f, kW11f,      // filter noise variances
  kVd, kVth, kWr, kWb,             // filter noise means
  kDMax, kThMax, kRMax, kFovMin, kFovMax,
  kX0, kY0, kYaw0,
  kStale, kWrapInnov, kCalibrated, kIekf,
  kV00, kV11,                      // unscaled process half-widths (moments)
  kNumParams
};
constexpr int kParamSlots = 32;

__device__ __forceinline__ float wrap_angle(float t) {
  // C remainder(t, 2*pi), as utils/geometry.wrap_angle.
  return t - kTwoPi * rintf(t / kTwoPi);
}

__device__ __forceinline__ int tri(int a) { return a * (a + 1) / 2; }

__device__ __forceinline__ int pidx(int a, int b) {
  return a >= b ? tri(a) + b : tri(b) + a;
}

__host__ __device__ __forceinline__ int align2(int n) { return (n + 1) & ~1; }

// Mean and std of clip(c + u, lo, hi), u ~ U(-v, v) (core/noise.py).
__device__ void clip_uniform_moments(float c, float v, float lo, float hi,
                                     float* mean, float* std) {
  float l = fminf(fmaxf(lo - c, -v), v);
  float h = fminf(fmaxf(hi - c, -v), v);
  float p_lo = (l + v) / (2.0f * v);
  float p_hi = (v - h) / (2.0f * v);
  float mean_g = p_lo * l + p_hi * h + (h * h - l * l) / (4.0f * v);
  float m2_g = p_lo * l * l + p_hi * h * h + (h * h * h - l * l * l) / (6.0f * v);
  float var = fmaxf(m2_g - mean_g * mean_g, 0.0f);
  *mean = c + mean_g;
  *std = sqrtf(var);
}

struct WorldSmem {
  float* P;      // packed lower triangle
  float* x;      // state mean (D)
  float* xs;     // tick-start snapshot for the stale-landmark quirk (D)
  float2* pp;    // (P h_r^T, P h_b^T) columns, or new rows on insertion (D)
  float2* kk;    // Kalman gain columns (D)
  float* g;      // RI-EKF yaw-noise column / correction xi (D)
  float* lx;     // true landmarks (N)
  float* ly;
  float* seen;   // per-slot seen flag (N)
  float* vis;    // this tick's visibility (N)
  float* rn;     // noisy range (N)
  float* bn;     // noisy bearing (N)
};

__host__ __device__ inline int world_floats(int n) {
  int d = 3 + 2 * n;
  return align2(d * (d + 1) / 2) + 2 * align2(d) + 2 * (2 * d) +
         align2(d) + 6 * align2(n);
}

__host__ __device__ inline int table_words(int n) {
  int d = 3 + 2 * n;
  return align2(d * (d + 1) / 2);
}

// Result pointers of one rollout; traj is null unless emit_traj.
struct Outputs {
  float* stats;
  float* x;
  float* p;
  float* seen;
  float* traj;
};

// One block's share of the rollout: thread `tid` of `nthreads` in block
// `block`, with `smem` the block's shared memory.
__device__ void rollout_block(float* smem, int tid, int nthreads, int block,
                              const float* __restrict__ params,
                              const float* __restrict__ lms,
                              const float* __restrict__ cmds,
                              const float* __restrict__ noise,
                              int B, int T, int N, int wpb, Outputs out) {
  const int D = 3 + 2 * N;
  const int ntri = D * (D + 1) / 2;
  const int K = 2 + 2 * N;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  float* prm = smem + table_words(N);

  for (int e = tid; e < ntri; e += nthreads) {
    int a = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
    while (tri(a + 1) <= e) ++a;
    while (tri(a) > e) --a;
    tab[e] = (static_cast<uint32_t>(a) << 16) | static_cast<uint32_t>(e - tri(a));
  }
  for (int i = tid; i < kNumParams; i += nthreads) prm[i] = params[i];
  __syncthreads();

  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int w = block * wpb + warp;
  if (w >= B) return;  // no block-wide barrier follows

  float* base = prm + kParamSlots + warp * world_floats(N);
  WorldSmem s;
  s.P = base;
  s.x = s.P + align2(ntri);
  s.xs = s.x + align2(D);
  s.pp = reinterpret_cast<float2*>(s.xs + align2(D));
  s.kk = s.pp + D;
  s.g = reinterpret_cast<float*>(s.kk + D);
  s.lx = s.g + align2(D);
  s.ly = s.lx + align2(N);
  s.seen = s.ly + align2(N);
  s.vis = s.seen + align2(N);
  s.rn = s.vis + align2(N);
  s.bn = s.rn + align2(N);

  const bool iekf = prm[kIekf] > 0.5f;
  const bool stale = prm[kStale] > 0.5f;
  const bool wrap_innov = prm[kWrapInnov] > 0.5f;
  const bool calibrated = prm[kCalibrated] > 0.5f;

  // ---- init (ekf.cpp:11-18)
  for (int e = lane; e < ntri; e += kWarp) s.P[e] = 0.0f;
  for (int a = lane; a < D; a += kWarp) s.x[a] = 0.0f;
  for (int j = lane; j < N; j += kWarp) {
    s.lx[j] = lms[(static_cast<size_t>(w) * N + j) * 2 + 0];
    s.ly[j] = lms[(static_cast<size_t>(w) * N + j) * 2 + 1];
    s.seen[j] = 0.0f;
  }
  __syncwarp();
  if (lane == 0) {
    s.P[0] = 0.01f * 0.01f;
    s.P[2] = 0.01f * 0.01f;
    s.P[5] = 0.005f * 0.005f;
    s.x[0] = prm[kX0];
    s.x[1] = prm[kY0];
    s.x[2] = prm[kYaw0];
  }
  float tx = prm[kX0], ty = prm[kY0], tth = prm[kYaw0];
  float err_sum = 0.0f, err_max = 0.0f;

  for (int t = 0; t < T; ++t) {
    const size_t wt = static_cast<size_t>(w) * T + t;
    const float fwd = cmds[wt * 2 + 0];
    const float ang = cmds[wt * 2 + 1];
    const float* u = noise + wt * K;

    // ---- truth propagation (sim_node.py:216-222)
    float d_n = fminf(fmaxf(fwd + prm[kV00s] * u[0], 0.0f), prm[kDMax]);
    float h_n = fminf(fmaxf(ang + prm[kV11s] * u[1], -prm[kThMax]), prm[kThMax]);
    tx = tx + d_n * cosf(tth);
    ty = ty + d_n * sinf(tth);
    tth = tth + h_n;  // deliberately unwrapped

    // ---- sensing (sim_node.py:228-250), lanes over landmarks
    for (int j = lane; j < N; j += kWarp) {
      float dxl = s.lx[j] - tx;
      float dyl = s.ly[j] - ty;
      float r = sqrtf(dxl * dxl + dyl * dyl);
      float beta = wrap_angle(atan2f(dyl, dxl) - tth);
      bool v = (r <= prm[kRMax]) && (beta > prm[kFovMin]) && (beta < prm[kFovMax]);
      s.vis[j] = v ? 1.0f : 0.0f;
      s.rn[j] = r + prm[kW00s] * u[2 + j];
      s.bn[j] = beta + prm[kW11s] * u[2 + N + j];
    }
    __syncwarp();

    // ---- predict (ekf.cpp:41-61 / models/iekf.py)
    const float th = s.x[2];
    const float c = cosf(th);
    const float sn = sinf(th);
    float eff_d, eff_th, var_d, var_th, jac_d;
    if (calibrated) {
      const float s3 = 1.7320508075688772f;
      float sig_d, sig_th;
      float c_d = fwd + prm[kVd];
      float c_th = ang + prm[kVth];
      if (prm[kV00] > 0.0f) {
        clip_uniform_moments(c_d, prm[kV00], 0.0f, prm[kDMax], &eff_d, &sig_d);
        sig_d = fmaxf(sig_d, 0.1f * prm[kV00] / s3);
      } else {
        eff_d = c_d;
        sig_d = 1e-6f;
      }
      if (prm[kV11] > 0.0f) {
        clip_uniform_moments(c_th, prm[kV11], -prm[kThMax], prm[kThMax],
                             &eff_th, &sig_th);
        sig_th = fmaxf(sig_th, 0.1f * prm[kV11] / s3);
      } else {
        eff_th = c_th;
        sig_th = 1e-6f;
      }
      var_d = sig_d * sig_d;
      var_th = sig_th * sig_th;
      jac_d = eff_d;
    } else {
      eff_d = fwd + prm[kVd];
      eff_th = ang + prm[kVth];
      var_d = prm[kV00f];
      var_th = prm[kV11f];
      jac_d = fwd;  // F_x from the raw command (ekf.cpp:47-50)
    }

    if (!iekf) {
      // F = I + u e2^T: rows 0,1 gain u * row 2, then columns 0,1 gain
      // the updated column 2 times u (lower triangle only).
      const float u0 = -jac_d * sn;
      const float u1 = jac_d * c;
      for (int a = 3 + lane; a < D; a += kWarp) {
        float p2 = s.P[tri(a) + 2];
        s.P[tri(a) + 0] = s.P[tri(a) + 0] + p2 * u0;
        s.P[tri(a) + 1] = s.P[tri(a) + 1] + p2 * u1;
      }
      if (lane == 0) {
        float p00 = s.P[0], p10 = s.P[1], p11 = s.P[2];
        float p20 = s.P[3], p21 = s.P[4], p22 = s.P[5];
        float c20 = p20 + u0 * p22;  // updated column 2, rows 0 and 1
        float c21 = p21 + u1 * p22;
        s.P[0] = (p00 + u0 * p20) + c20 * u0 + c * c * var_d;
        s.P[1] = (p10 + u1 * p20) + c21 * u0 + sn * c * var_d;
        s.P[2] = (p11 + u1 * p21) + c21 * u1 + sn * sn * var_d;
        s.P[3] = p20 + p22 * u0;
        s.P[4] = p21 + p22 * u1;
        s.P[5] = p22 + var_th;
      }
    } else {
      // F = I; yaw-noise column g couples into every active translation
      // slot: one rank-1 pass over the triangle.
      for (int a = lane; a < D; a += kWarp) {
        float gv;
        if (a == 0) {
          gv = jac_d * sn + s.x[1];
        } else if (a == 1) {
          gv = -jac_d * c - s.x[0];
        } else if (a == 2) {
          gv = 1.0f;
        } else {
          int jj = (a - 3) / 2;
          gv = ((a - 3) % 2 == 0) ? s.seen[jj] * s.x[a + 1]
                                   : -s.seen[jj] * s.x[a - 1];
        }
        s.g[a] = gv;
      }
      __syncwarp();
      for (int e = lane; e < ntri; e += kWarp) {
        uint32_t ab = tab[e];
        int a = ab >> 16, b = ab & 0xffff;
        s.P[e] = s.P[e] + var_th * s.g[a] * s.g[b];
      }
      __syncwarp();
      if (lane == 0) {
        s.P[0] = s.P[0] + c * c * var_d;
        s.P[1] = s.P[1] + sn * c * var_d;
        s.P[2] = s.P[2] + sn * sn * var_d;
      }
    }
    __syncwarp();
    if (lane == 0) {
      s.x[0] = s.x[0] + eff_d * c;
      s.x[1] = s.x[1] + eff_d * sn;
      s.x[2] = wrap_angle(th + eff_th);
    }
    __syncwarp();
    if (stale) {
      for (int a = lane; a < D; a += kWarp) s.xs[a] = s.x[a];
    }

    // ---- sequential per-landmark update / insertion (ekf.cpp:73-174)
    for (int j = 0; j < N; ++j) {
      __syncwarp();
      const float visj = s.vis[j];
      const float seenj = s.seen[j];
      if (visj == 0.0f) continue;
      const int li = 3 + 2 * j;
      const float rn = s.rn[j];
      const float bn = s.bn[j];
      const float xv = s.x[0], yv = s.x[1], thv = s.x[2];

      if (seenj > 0.0f && !iekf) {
        // ------- EKF update (ekf.cpp:110-140)
        const float lmx = stale ? s.xs[li] : s.x[li];
        const float lmy = stale ? s.xs[li + 1] : s.x[li + 1];
        float ddx = lmx - xv, ddy = lmy - yv;
        float d2 = fmaxf(ddx * ddx + ddy * ddy, 1e-12f);
        float dist = sqrtf(d2);
        float a_r = ddx / dist, b_r = ddy / dist;
        float a_b = ddy / d2, b_b = ddx / d2;
        for (int a = lane; a < D; a += kWarp) {
          float c0 = s.P[pidx(a, 0)], c1 = s.P[pidx(a, 1)], c2 = s.P[pidx(a, 2)];
          float cl0 = s.P[pidx(a, li)], cl1 = s.P[pidx(a, li + 1)];
          float pr = (cl0 - c0) * a_r + (cl1 - c1) * b_r;
          float pb = (c0 - cl0) * a_b + (cl1 - c1) * b_b - c2;
          s.pp[a] = make_float2(pr, pb);
        }
        __syncwarp();
        float2 q0 = s.pp[0], q1 = s.pp[1], q2 = s.pp[2];
        float2 ql = s.pp[li], ql1 = s.pp[li + 1];
        float s00 = (-a_r * q0.x - b_r * q1.x + a_r * ql.x + b_r * ql1.x) + prm[kW00f];
        float s01 = (-a_r * q0.y - b_r * q1.y + a_r * ql.y + b_r * ql1.y);
        float s10 = a_b * q0.x - b_b * q1.x - q2.x - a_b * ql.x + b_b * ql1.x;
        float s11 = (a_b * q0.y - b_b * q1.y - q2.y - a_b * ql.y + b_b * ql1.y) + prm[kW11f];
        float det = s00 * s11 - s01 * s10;
        det = fabsf(det) > 1e-20f ? det : 1.0f;
        float i00 = s11 / det, i01 = -s01 / det, i10 = -s10 / det, i11 = s00 / det;
        float ang_lm = wrap_angle(atan2f(ddy, ddx) - thv);
        float nu_r = rn - dist - prm[kWr];
        float nu_b = bn - ang_lm - prm[kWb];
        if (wrap_innov) nu_b = wrap_angle(nu_b);
        for (int a = lane; a < D; a += kWarp) {
          float2 q = s.pp[a];
          float k0 = q.x * i00 + q.y * i10;
          float k1 = q.x * i01 + q.y * i11;
          s.kk[a] = make_float2(k0, k1);
          s.x[a] = s.x[a] + k0 * nu_r + k1 * nu_b;
        }
        __syncwarp();
        if (lane == 0) s.x[2] = wrap_angle(s.x[2]);
      } else if (seenj > 0.0f) {
        // ------- RI-EKF update (models/iekf.py): H = [-I | 0 | +I]
        const float lmx = s.x[li], lmy = s.x[li + 1];
        float cth = cosf(thv), sth = sinf(thv);
        float cbn = cosf(bn), sbn = sinf(bn);
        float c1 = cth * cbn - sth * sbn;
        float s1 = sth * cbn + cth * sbn;
        float yw0 = rn * c1, yw1 = rn * s1;
        float rr2 = rn * rn;
        float w00f = prm[kW00f], w11f = prm[kW11f];
        float rt00 = w00f * c1 * c1 + w11f * rr2 * s1 * s1;
        float rt01 = (w00f - w11f * rr2) * c1 * s1;
        float rt11 = w00f * s1 * s1 + w11f * rr2 * c1 * c1;
        for (int a = lane; a < D; a += kWarp) {
          float pr = s.P[pidx(a, li)] - s.P[pidx(a, 0)];
          float pb = s.P[pidx(a, li + 1)] - s.P[pidx(a, 1)];
          s.pp[a] = make_float2(pr, pb);
        }
        __syncwarp();
        float2 q0 = s.pp[0], q1 = s.pp[1], ql = s.pp[li], ql1 = s.pp[li + 1];
        float s00 = ql.x - q0.x + rt00;
        float s01 = ql.y - q0.y + rt01;
        float s10 = ql1.x - q1.x + rt01;
        float s11 = ql1.y - q1.y + rt11;
        float det = s00 * s11 - s01 * s10;
        det = fabsf(det) > 1e-20f ? det : 1.0f;
        float i00 = s11 / det, i01 = -s01 / det, i10 = -s10 / det, i11 = s00 / det;
        float nu0 = yw0 - (lmx - xv);
        float nu1 = yw1 - (lmy - yv);
        for (int a = lane; a < D; a += kWarp) {
          float2 q = s.pp[a];
          float k0 = q.x * i00 + q.y * i10;
          float k1 = q.x * i01 + q.y * i11;
          s.kk[a] = make_float2(k0, k1);
          s.g[a] = k0 * nu0 + k1 * nu1;  // xi
        }
        __syncwarp();
        // exp retraction: rotate every translation pair by R(dth), add V xi
        float dth = s.g[2];
        float cd = cosf(dth), sd = sinf(dth);
        bool small = fabsf(dth) < 1e-6f;
        float dsafe = small ? 1.0f : dth;
        float va = small ? 1.0f - dth * dth / 6.0f : sd / dsafe;
        float vb = small ? 0.5f * dth : (1.0f - cd) / dsafe;
        for (int jj = lane; jj < N; jj += kWarp) {
          int a0 = 3 + 2 * jj;
          float lxj = s.x[a0], lyj = s.x[a0 + 1];
          float kx = s.g[a0], ky = s.g[a0 + 1];
          s.x[a0] = va * kx - vb * ky + cd * lxj - sd * lyj;
          s.x[a0 + 1] = vb * kx + va * ky + sd * lxj + cd * lyj;
        }
        if (lane == 0) {
          float xi0 = s.g[0], xi1 = s.g[1];
          s.x[0] = va * xi0 - vb * xi1 + cd * xv - sd * yv;
          s.x[1] = vb * xi0 + va * xi1 + sd * xv + cd * yv;
          s.x[2] = wrap_angle(thv + dth);
        }
      } else {
        // ------- insertion (ekf.cpp:141-173 / RI-EKF copy of the
        // vehicle-position rows); reads first, then writes
        float sx, sy, b00, b01, b11;
        float p00 = s.P[0], p01 = s.P[1], p11 = s.P[2];
        if (!iekf) {
          float tb = thv + bn;
          float ct = cosf(tb), st = sinf(tb);
          sx = xv + rn * ct;
          sy = yv + rn * st;
          float ga = -rn * st, gb = rn * ct;
          float p02 = s.P[3], p12 = s.P[4], p22 = s.P[5];
          float w00f = prm[kW00f], w11f = prm[kW11f];
          b00 = p00 + 2.0f * ga * p02 + ga * ga * p22 + ct * ct * w00f + ga * ga * w11f;
          b01 = p01 + gb * p02 + ga * p12 + ga * gb * p22 + ct * st * w00f + ga * gb * w11f;
          b11 = p11 + 2.0f * gb * p12 + gb * gb * p22 + st * st * w00f + gb * gb * w11f;
          for (int a = lane; a < D; a += kWarp) {
            float r2 = s.P[pidx(2, a)];
            s.pp[a] = make_float2(s.P[pidx(0, a)] + ga * r2, s.P[pidx(1, a)] + gb * r2);
          }
        } else {
          float cth = cosf(thv), sth = sinf(thv);
          float cbn = cosf(bn), sbn = sinf(bn);
          float c1 = cth * cbn - sth * sbn;
          float s1 = sth * cbn + cth * sbn;
          sx = xv + rn * c1;
          sy = yv + rn * s1;
          float rr2 = rn * rn;
          float w00f = prm[kW00f], w11f = prm[kW11f];
          b00 = p00 + (w00f * c1 * c1 + w11f * rr2 * s1 * s1);
          b01 = p01 + ((w00f - w11f * rr2) * c1 * s1);
          b11 = p11 + (w00f * s1 * s1 + w11f * rr2 * c1 * c1);
          for (int a = lane; a < D; a += kWarp) {
            s.pp[a] = make_float2(s.P[pidx(0, a)], s.P[pidx(1, a)]);
          }
        }
        __syncwarp();
        for (int a = lane; a < D; a += kWarp) {
          if (a == li || a == li + 1) continue;
          float2 q = s.pp[a];
          s.P[pidx(li, a)] = q.x;
          s.P[pidx(li + 1, a)] = q.y;
        }
        if (lane == 0) {
          s.x[li] = sx;
          s.x[li + 1] = sy;
          s.P[tri(li) + li] = b00;
          s.P[tri(li + 1) + li] = b01;
          s.P[tri(li + 1) + li + 1] = b11;
          s.seen[j] = 1.0f;
        }
        continue;
      }

      // P -= K (H P); H P rows equal the P H^T columns in pp (P symmetric)
      for (int e = lane; e < ntri; e += kWarp) {
        uint32_t ab = tab[e];
        float2 k = s.kk[ab >> 16];
        float2 q = s.pp[ab & 0xffff];
        s.P[e] = (s.P[e] - k.x * q.x) - k.y * q.y;
      }
    }
    __syncwarp();

    // ---- error metric (plotting_node.py:195-218), online
    float ex = s.x[0] - tx, ey = s.x[1] - ty;
    float e = sqrtf(ex * ex + ey * ey);
    err_sum += e;
    // NaN-propagating running max (NaN is the only value unequal to itself)
    err_max = (err_max != err_max || e != e) ? NAN : fmaxf(err_max, e);
    if (out.traj != nullptr && lane == 0) {
      float* o = out.traj + wt * 6;
      o[0] = s.x[0];
      o[1] = s.x[1];
      o[2] = s.x[2];
      o[3] = tx;
      o[4] = ty;
      o[5] = tth;
    }
  }
  __syncwarp();

  if (lane == 0) {
    float* st = out.stats + static_cast<size_t>(w) * 5;
    st[0] = err_sum;
    st[1] = err_max;
    st[2] = tx;
    st[3] = ty;
    st[4] = tth;
  }
  for (int a = lane; a < D; a += kWarp) out.x[static_cast<size_t>(w) * D + a] = s.x[a];
  for (int e = lane; e < D * D; e += kWarp) {
    out.p[static_cast<size_t>(w) * D * D + e] = s.P[pidx(e / D, e % D)];
  }
  for (int j = lane; j < N; j += kWarp) out.seen[static_cast<size_t>(w) * N + j] = s.seen[j];
}

struct Dims {
  int B, T, N;
};

ffi::Error CheckDims(ffi::Buffer<ffi::F32>& params, ffi::Buffer<ffi::F32>& lms,
                     ffi::Buffer<ffi::F32>& cmds, ffi::Buffer<ffi::F32>& noise,
                     Dims* dims) {
  auto ld = lms.dimensions();
  auto cd = cmds.dimensions();
  auto nd = noise.dimensions();
  if (ld.size() != 3 || cd.size() != 3 || nd.size() != 3 || ld[2] != 2 ||
      cd[2] != 2) {
    return ffi::Error::InvalidArgument("expected lms (B,N,2), cmds (B,T,2)");
  }
  const int B = static_cast<int>(cd[0]);
  const int T = static_cast<int>(cd[1]);
  const int N = static_cast<int>(ld[1]);
  if (ld[0] != B || nd[0] != B || nd[1] != T || nd[2] != 2 + 2 * N) {
    return ffi::Error::InvalidArgument("noise must be (B, T, 2 + 2N)");
  }
  if (params.element_count() != kNumParams) {
    return ffi::Error::InvalidArgument("wrong number of kernel params");
  }
  *dims = {B, T, N};
  return ffi::Error::Success();
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(kWarp * kMaxWorldsPerBlock, 8)
rollout_kernel(const float* __restrict__ params,
               const float* __restrict__ lms,
               const float* __restrict__ cmds,
               const float* __restrict__ noise,
               int B, int T, int N, int wpb, Outputs out) {
  extern __shared__ __align__(16) float smem[];
  rollout_block(smem, threadIdx.x, blockDim.x, blockIdx.x, params, lms, cmds,
                noise, B, T, N, wpb, out);
}

ffi::Error Launch(cudaStream_t stream, ffi::Buffer<ffi::F32> params,
                  ffi::Buffer<ffi::F32> lms, ffi::Buffer<ffi::F32> cmds,
                  ffi::Buffer<ffi::F32> noise, Outputs out) {
  Dims dm;
  ffi::Error bad = CheckDims(params, lms, cmds, noise, &dm);
  if (bad.failure()) return bad;
  const int B = dm.B, T = dm.T, N = dm.N;
  if (B == 0 || T == 0) return ffi::Error::Success();
  const size_t fixed = sizeof(float) * (table_words(N) + kParamSlots);
  const size_t per_world = sizeof(float) * world_floats(N);
  int wpb = kMaxWorldsPerBlock;
  while (wpb > 1 && fixed + wpb * per_world > kMaxSmem) --wpb;
  const size_t smem = fixed + wpb * per_world;
  if (smem > kMaxSmem) {
    return ffi::Error::InvalidArgument(
        "too many landmarks for one world's covariance in shared memory: N=" +
        std::to_string(N));
  }
  cudaFuncSetAttribute(rollout_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int grid = (B + wpb - 1) / wpb;
  rollout_kernel<<<grid, kWarp * wpb, smem, stream>>>(
      params.typed_data(), lms.typed_data(), cmds.typed_data(),
      noise.typed_data(), B, T, N, wpb, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("rollout launch failed: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

#define STREAM_PARAM cudaStream_t stream,
#define STREAM_ARG stream,
#define BIND_CTX .Ctx<ffi::PlatformStream<cudaStream_t>>()

#else  // host build: one lane per warp, one world per block, in turn

ffi::Error Launch(ffi::Buffer<ffi::F32> params, ffi::Buffer<ffi::F32> lms,
                  ffi::Buffer<ffi::F32> cmds, ffi::Buffer<ffi::F32> noise,
                  Outputs out) {
  Dims dm;
  ffi::Error bad = CheckDims(params, lms, cmds, noise, &dm);
  if (bad.failure()) return bad;
  std::vector<float> smem(table_words(dm.N) + kParamSlots + world_floats(dm.N));
  for (int w = 0; w < dm.B; ++w) {
    rollout_block(smem.data(), 0, 1, w, params.typed_data(), lms.typed_data(),
                  cmds.typed_data(), noise.typed_data(), dm.B, dm.T, dm.N, 1,
                  out);
  }
  return ffi::Error::Success();
}

#define STREAM_PARAM
#define STREAM_ARG
#define BIND_CTX

#endif  // __CUDACC__

ffi::Error Rollout(STREAM_PARAM ffi::Buffer<ffi::F32> params,
                   ffi::Buffer<ffi::F32> lms, ffi::Buffer<ffi::F32> cmds,
                   ffi::Buffer<ffi::F32> noise,
                   ffi::ResultBuffer<ffi::F32> stats,
                   ffi::ResultBuffer<ffi::F32> x_out,
                   ffi::ResultBuffer<ffi::F32> p_out,
                   ffi::ResultBuffer<ffi::F32> seen_out) {
  return Launch(STREAM_ARG params, lms, cmds, noise,
                {stats->typed_data(), x_out->typed_data(), p_out->typed_data(),
                 seen_out->typed_data(), nullptr});
}

ffi::Error RolloutTraj(STREAM_PARAM ffi::Buffer<ffi::F32> params,
                       ffi::Buffer<ffi::F32> lms, ffi::Buffer<ffi::F32> cmds,
                       ffi::Buffer<ffi::F32> noise,
                       ffi::ResultBuffer<ffi::F32> stats,
                       ffi::ResultBuffer<ffi::F32> x_out,
                       ffi::ResultBuffer<ffi::F32> p_out,
                       ffi::ResultBuffer<ffi::F32> seen_out,
                       ffi::ResultBuffer<ffi::F32> traj) {
  return Launch(STREAM_ARG params, lms, cmds, noise,
                {stats->typed_data(), x_out->typed_data(), p_out->typed_data(),
                 seen_out->typed_data(), traj->typed_data()});
}

}  // namespace

#define ROLLOUT_ARGS                                      \
  ffi::Ffi::Bind()                                        \
      BIND_CTX                                            \
      .Arg<ffi::Buffer<ffi::F32>>()                       \
      .Arg<ffi::Buffer<ffi::F32>>()                       \
      .Arg<ffi::Buffer<ffi::F32>>()                       \
      .Arg<ffi::Buffer<ffi::F32>>()                       \
      .Ret<ffi::Buffer<ffi::F32>>()                       \
      .Ret<ffi::Buffer<ffi::F32>>()                       \
      .Ret<ffi::Buffer<ffi::F32>>()                       \
      .Ret<ffi::Buffer<ffi::F32>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(EkfRollout, Rollout, ROLLOUT_ARGS);
XLA_FFI_DEFINE_HANDLER_SYMBOL(EkfRolloutTraj, RolloutTraj,
                              ROLLOUT_ARGS.Ret<ffi::Buffer<ffi::F32>>());
