// Kerr null-geodesic tracer for Hopper (sm_90a), float32, one thread a ray.
//
// Replaces the two jitted lax.scan loops of the JAX package's device trace
// (bhnerf_tpu/geodesics/integrator.py:123-215, `terminal_mino_time` and
// `sample_rays`, run by trace_geodesics(backend='device')), which XLA
// fuses step by step on the accelerator. That is not a Pallas kernel: the
// JAX package left this loop to XLA. Carried into eager PyTorch, the same
// loop issues ~130 elementwise launches per RK4 step and ~9,500 steps per
// table; here each ray walks its whole loop in registers. The plain version
// (bhnerf_tpu_torch/geodesics/integrator.py: `initial_state`,
// `terminal_mino_time`, `sample_rays` in float32, `trace_rays_plain`)
// computes the same function and is what the CPU tests run.
//
// What it computes, per ray (the integrator module docstring has the
// physics): second-order Mino-time RK4 in (u = 1/r, ud, c = cos theta, cd)
// with a polynomial right-hand side, phi and coordinate time t beside it,
// t summed with Kahan compensation (t_c).
//   Pass 1: up to n_fine steps of h = tau_max / n_fine with u clipped to
//   [u_floor, u_clip] inside the right-hand side; the ray stops at its
//   first step i (0-based) whose result has u >= u_clip or u <= u_escape,
//   and tau_final = i * h ("round down", integrator.py:141-144), else
//   tau_final = tau_max. The reference's `where` only freezes a state that
//   is never read again, so `break` is the same function.
//   Pass 2: from the same initial state, ngeo - 1 segments of Mino length
//   tau_final / (ngeo - 1), the first in first_substeps RK4 steps, the
//   others in substeps; a ray whose state before a step has u >= u_clip or
//   (u <= u_escape and ud < 0) is frozen (it stays frozen: the test reads
//   only the state it keeps), and after each step u = max(u, u_floor).
//   Samples 0 (the initial state), 1 (after the first segment) and one
//   after each later segment record u, c, phi, t, t_c, sign(ud), sign(cd).
//
// Layouts: inputs are seven (n,) state rows and lam, eta (n,); the output
// `out` is (7, ngeo, n) in the order above, so that neighbouring threads
// write neighbouring addresses; tau_final is (n,). The host wrapper
// (trace_rays) allocates both; nothing is allocated here.
//
// Precision is the contract:
//   * never build with --use_fast_math: it would let the compiler drop
//     Kahan's (t_new - t) - y as zero, and turn the IEEE divisions into
//     approximations (-prec-div=true is nvcc's default and is kept);
//   * FMA contraction (nvcc's default) stays on: it moves results by the
//     last bits against the plain PyTorch loop and XLA, as any f32
//     reordering does; Kahan's three additions contain no product, so
//     contraction cannot touch them;
//   * sign(0) = 0 as torch.sign gives it: (x > 0) - (x < 0), not copysignf;
//   * the stop constants arrive as float32 and are compared as float32, as
//     torch compares a float32 tensor with a Python float; the clamps are
//     written with comparisons, which pass a NaN through as torch.clamp
//     does (fminf/fmaxf would hide it);
//   * every scalar constant (spin^2, 4 spin^2, the step) is rounded to f32
//     by the wrapper from the same float64 expression the plain version
//     hands torch, and the right-hand side keeps the plain version's
//     order of operations.
//
// What bounds it on this card. Work: ~240 float operations per RK4 step
// (four right-hand sides of ~40 operations and 4 IEEE divisions each, the
// stage updates and the weighted sum; integrator.py), times the steps the
// rays take: at 4096 rays and n_fine 8192, ~9,500 steps a ray, 9.3 GFLOP,
// 0.14 ms at the card's 67 TFLOP/s of FP32 (H100 SXM data sheet). Bytes
// are small: 36 B in and 28 B a sample out per ray (11.5 MB at 4096 x 100,
// 3.4 us at 3.35 TB/s). Latency: one ray is one dependent chain of four
// right-hand sides a step, each through three divisions in a row (1/u, then
// spin / Delta, then the rates), so a ray's time is its step count times
// that chain, and a single 64x64 table (4096 threads, 31 per SM) cannot
// hide it: the longest ray's chain, not the FLOP rate, sets the floor
// there. Blocks are small (64 threads) so that one table reaches every SM;
// an ensemble stacks its tables into one launch and gives each SM more
// warps to hide the chain behind. The design asks for a kernel that is
// right; it is not tuned.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;
constexpr int kFields = 7;   // u, c, phi, t, t_c, pm_r, pm_th

struct Params {
  float spin;      // a
  float a2;        // f32(a^2)
  float four_a2;   // f32(4 a^2)
  float u_clip;    // 1 / (r_+ * r_stop_factor): pass 1 stop, pass 2 freeze
  float u_escape;  // (1 / r_o) * (1 - 1e-9)
  float u_floor;   // 0.5 / r_o
  float h_fine;    // f32(tau_max / n_fine)
  float tau_max;
  int n;
  int n_fine;
  int ngeo;
  int substeps;
  int first_substeps;
};

// per-ray constants of the right-hand side, rounded as the plain version's
// expressions (kerr.py) round them
struct Ray {
  float lam;
  float c2;        // a^2 - a lam
  float k;         // eta + (lam - a)^2
  float two_A;     // 2 (a^2 - eta - lam^2)
  float a_lam;     // a lam
};

struct State {
  float u, ud, c, cd, phi, t, t_c;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // torch.clamp: min(max(x, lo), hi), a NaN passes through
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

__device__ __forceinline__ float sign_torch(float x) {
  return (float)(x > 0.0f) - (float)(x < 0.0f);
}

// d/dtau of (u, ud, c, cd, phi, t) for the backward ray (integrator.py
// _rk4_step.f): (ud, dU/du / 2, cd, dC/dc / 2, -phi_rate, -t_rate)
__device__ __forceinline__ void rhs(const Params& p, const Ray& q, float u_in,
                                    float ud, float c, float cd,
                                    float (&k)[6]) {
  const float u = clampf(u_in, p.u_floor, p.u_clip);
  const float uu = u * u;
  // kerr.dU_du: 4 c2 u a_ - k (2u - 6u^2 + 4 a^2 u^3), a_ = 1 + c2 u^2
  const float a_ = 1.0f + q.c2 * uu;
  const float dU = 4.0f * q.c2 * u * a_
                   - q.k * (2.0f * u - 6.0f * uu + p.four_a2 * (uu * u));
  // kerr.dC_dc: 2 (a^2 - eta - lam^2) c - 4 a^2 c^3
  const float cc = c * c;
  const float dC = q.two_A * c - p.four_a2 * (cc * c);
  // kerr.phi_rate and kerr.t_rate in (u, c)
  const float r = 1.0f / u;
  const float rr = r * r;
  const float delta = rr - 2.0f * r + p.a2;
  const float one_m_cc = 1.0f - cc;
  const float sin2 = one_m_cc < 1e-12f ? 1e-12f : one_m_cc;
  const float rr_a2 = rr + p.a2;
  const float w = rr_a2 - q.a_lam;
  const float phi_rate = p.spin / delta * w + q.lam / sin2 - p.spin;
  const float t_rate = rr_a2 / delta * w
                       + p.spin * (q.lam - p.spin * one_m_cc);
  k[0] = ud;
  k[1] = 0.5f * dU;
  k[2] = cd;
  k[3] = 0.5f * dC;
  k[4] = -phi_rate;
  k[5] = -t_rate;
}

// one classic RK4 step of size h (integrator.py _rk4_step), t by Kahan
__device__ __forceinline__ void rk4(const Params& p, const Ray& q, float h,
                                    State& s) {
  float k1[6], k2[6], k3[6], k4[6];
  const float hh = 0.5f * h;
  rhs(p, q, s.u, s.ud, s.c, s.cd, k1);
  rhs(p, q, s.u + hh * k1[0], s.ud + hh * k1[1], s.c + hh * k1[2],
      s.cd + hh * k1[3], k2);
  rhs(p, q, s.u + hh * k2[0], s.ud + hh * k2[1], s.c + hh * k2[2],
      s.cd + hh * k2[3], k3);
  rhs(p, q, s.u + h * k3[0], s.ud + h * k3[1], s.c + h * k3[2],
      s.cd + h * k3[3], k4);
  const float h6 = h / 6.0f;
  float d[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    d[i] = h6 * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
  // Kahan: t reaches O(r_o) while the physics downstream needs O(1)
  // differences of it
  const float y = d[5] - s.t_c;
  const float t_new = s.t + y;
  s.t_c = (t_new - s.t) - y;
  s.t = t_new;
  s.u += d[0];
  s.ud += d[1];
  s.c += d[2];
  s.cd += d[3];
  s.phi += d[4];
}

__device__ __forceinline__ void record(const State& s, float* out, int g,
                                       int ray, int ngeo, int n) {
  const long long plane = (long long)ngeo * n;
  float* o = out + (long long)g * n + ray;
  o[0] = s.u;
  o[plane] = s.c;
  o[2 * plane] = s.phi;
  o[3 * plane] = s.t;
  o[4 * plane] = s.t_c;
  o[5 * plane] = sign_torch(s.ud);
  o[6 * plane] = sign_torch(s.cd);
}

// pass 2's frozen test on the state before a step (integrator.py:199)
__device__ __forceinline__ bool frozen(const Params& p, const State& s) {
  return (s.u >= p.u_clip) | ((s.u <= p.u_escape) & (s.ud < 0.0f));
}

__global__ void __launch_bounds__(kBlock)
geodesic_trace_kernel(const float* __restrict__ state0,
                      const float* __restrict__ lam,
                      const float* __restrict__ eta, float* __restrict__ out,
                      float* __restrict__ tau_final, Params p) {
  const int ray = blockIdx.x * kBlock + threadIdx.x;
  if (ray >= p.n) return;
  const int n = p.n;
  State s0;
  s0.u = state0[ray];
  s0.ud = state0[n + ray];
  s0.c = state0[2 * n + ray];
  s0.cd = state0[3 * n + ray];
  s0.phi = state0[4 * n + ray];
  s0.t = state0[5 * n + ray];
  s0.t_c = state0[6 * n + ray];
  Ray q;
  q.lam = lam[ray];
  const float e = eta[ray];
  q.a_lam = p.spin * q.lam;
  q.c2 = p.a2 - q.a_lam;
  const float lm = q.lam - p.spin;
  q.k = e + lm * lm;
  q.two_A = 2.0f * ((p.a2 - e) - q.lam * q.lam);

  // pass 1: the terminal Mino time
  float tau = p.tau_max;
  State s = s0;
  for (int i = 0; i < p.n_fine; ++i) {
    rk4(p, q, p.h_fine, s);
    if ((s.u >= p.u_clip) | (s.u <= p.u_escape)) {
      tau = (float)i * p.h_fine;
      break;
    }
  }
  tau_final[ray] = tau;

  // pass 2: ngeo uniform Mino-time samples
  const float tau_seg = tau / (float)(p.ngeo - 1);
  s = s0;
  record(s, out, 0, ray, p.ngeo, n);
  bool done = frozen(p, s);
  for (int g = 1; g < p.ngeo; ++g) {
    const int nsub = g == 1 ? p.first_substeps : p.substeps;
    const float h = tau_seg / (float)nsub;
    for (int j = 0; j < nsub && !done; ++j) {
      rk4(p, q, h, s);
      s.u = s.u < p.u_floor ? p.u_floor : s.u;
      done = frozen(p, s);
    }
    record(s, out, g, ray, p.ngeo, n);
  }
}

}  // namespace

extern "C" {

int geodesic_trace_fields() { return kFields; }

// state0 (7, n): u, ud, c, cd, phi, t, t_c; lam, eta (n,); out (7, ngeo, n):
// u, c, phi, t, t_c, sign(ud), sign(cd); tau_final (n,). All float32 on
// the device of `stream`. Returns cudaGetLastError() after the launch.
int geodesic_trace(const float* state0, const float* lam, const float* eta,
                   float* out, float* tau_final, int n, float spin, float a2,
                   float four_a2, float u_clip, float u_escape, float u_floor,
                   float h_fine, float tau_max, int n_fine, int ngeo,
                   int substeps, int first_substeps, void* stream) {
  if (n <= 0 || ngeo < 2 || n_fine < 1 || substeps < 1 || first_substeps < 1)
    return (int)cudaErrorInvalidValue;
  Params p{spin, a2, four_a2, u_clip, u_escape, u_floor, h_fine, tau_max,
           n, n_fine, ngeo, substeps, first_substeps};
  const int grid = (n + kBlock - 1) / kBlock;
  geodesic_trace_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      state0, lam, eta, out, tau_final, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
