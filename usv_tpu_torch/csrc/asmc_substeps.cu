// The ASMC substep loop for Hopper (sm_90a), hand-written CUDA.
//
// Replaces no TPU kernel: the JAX package leaves this loop to XLA, which
// fuses the `lax.scan` of `asmc_compute` (usv_tpu/control/asmc.py) into a few
// kernels. The port ran it as a Python loop of PyTorch ops, ~240 elementwise
// kernels a substep on (B,) float32 vectors, so a 10-substep step launched
// ~2,400 kernels of ~1.2 us whose work is worth nanoseconds. This kernel is
// that whole loop in one launch: usv_tpu_torch/control/asmc.py::asmc_compute
// routes CUDA float32 inputs here (launcher: ops/asmc_cuda.py).
//
// What it computes, per env, for each of n_substeps substeps (dt each):
//   asmc_control        the sideslip-compensated heading setpoint (offset
//                       mode: asin, hypot, the single-branch wrap) or the
//                       absolute setpoint (atan2 wraps of the setpoint's
//                       finite difference and of the heading error), the
//                       second-order r_d filter, the adaptive gains with dead
//                       zone and floor, the sqrt-sigma reaching law and the
//                       thruster mixing;
//   perturbation_force  when do_perturb: the sinusoidal force at
//                       perturb_step + i, rotated into the body frame;
//   dynamics_step       thrust allocation, the Fossen 3-DOF acceleration
//                       (speed-dependent damping, CRB + CA Coriolis, M^-1 in
//                       closed form), and the trapezoids of nu and then eta.
// It stores the advanced controller state (10 floats), the dynamics state
// (pose, vel, accel_last, eta_dot_last: 12 floats), perturb_step + n, and
// the last substep's e_psi, sigma_u, sigma_psi, tport, tstbd, tx, tz.
//
// What bounds it. Per env it reads 22 floats of state, 2 of action and an
// int, and writes 29 floats and an int: ~220 bytes, 0.27 us for 4096 envs at
// 3.35 TB/s. A substep is ~300 float32 operations and ~10 library calls
// (sinf, cosf, atan2f, asinf, hypotf, sqrtf), each a dependent chain, so the
// 10 substeps are one long chain of dependent instructions per env: the
// kernel is bound by that chain's latency, not by bytes or issue rate. Its
// design follows:
//   * One thread per env, the whole loop in registers. The state never
//     leaves the thread between substeps.
//   * Small blocks (the launcher's choice, 64 threads): at 4096 envs a
//     128-thread block would put the 128 warps on 32 of the 132 SMs, four to
//     an SM, where they would share issue slots; small blocks spread them
//     over the SMs, where each chain runs at its own latency. On the card
//     the difference is small (PERF.md §6): 32, 64 and 128 threads take
//     ~11.7-12.0 us at 4096 envs, as one env alone does.
//   * The constants (gains, vehicle model, dt) are kernel arguments, passed
//     by value, so a CUDA graph captures them with the launch and a replay
//     reads no host memory.
//
// Numerics: bit for bit the PyTorch ops of the eager loop on the card, so
// build WITHOUT --use_fast_math and with -fmad=false, and round every
// operation as the tensor op it stands for rounds:
//   * Each tensor op is one rounded float32 operation, in the association
//     order of the Python source. FMA contraction would fuse a product into
//     the following sum and round once where the eager loop rounds twice.
//   * Every Python-side constant arrives folded as Python folds it (in
//     double: 0.5 * dt, m - Y_v_dot, 1 / (m - X_u_dot), det, ...) and cast to
//     float32, as PyTorch casts a Python scalar where it meets a tensor. The
//     launcher packs them (ops/asmc_cuda.py::pack_constants).
//   * A tensor divided by a Python float is, on the card, a multiply by the
//     divisor's reciprocal, taken in double and cast to float32 (PyTorch's
//     div_true kernel for a CPU scalar): those divisors arrive as that
//     reciprocal (inv_*). A tensor divided by a tensor stays a true division.
//   * sinf, cosf, atan2f, asinf, hypotf and sqrtf are the full-precision
//     library forms that PyTorch's kernels call; sign is torch.sign's
//     (0 < a) - (a < 0), 0 at 0 and at NaN; a `torch.where` is a select of
//     both computed branches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

// physics/dynamics.py's Python-side constants, folded as it folds them.
struct FossenConstants {
  // hydrodynamic_coefficients
  float u_fast, xu_fast, xu_slow, xuu_fast, xuu_slow;
  float yv_scale, yv_form, yr_scale, nv_scale, nr_scale, hull_d, hull_k;
  // surge_yaw_model_terms
  float m_minus_yvd, g_u, neg_xud_plus_yvd, g_psi;
  // thruster_allocation
  float c, half_b;
  // fossen_acceleration
  float neg_m, m, y_v_dot, neg_y_v_dot, half_yrd_nvd, xud_m;
  float yvv, yvr, yrv, yrr, nvv, nvr, nrv, nrr;
  float inv_m11, m22, m23, m32, m33, inv_det;
};

// control/asmc.py::asmc_control's Python-side constants.
struct AsmcConstants {
  float f1, f2, f3, hypot_eps, pi, two_pi;
  float lambda_u, lambda_psi, kmin_u, kmin_psi, k_u, k_psi, mu_u, mu_psi, k2_u, k2_psi;
  float inv_g_u, inv_g_psi, inv_two, inv_b, inv_two_c, inv_b_c;
};

// The substep's dt and the perturbation force's constants.
struct StepConstants {
  float dt, half_dt, inv_dt, perturb_k, perturb_magnitude;
};

struct SubstepConstants {
  FossenConstants fossen;
  AsmcConstants asmc;
  StepConstants step;
};

constexpr int kCtrlFields = 10;  // AsmcState's fields, in declaration order
constexpr int kMaxThreads = 1024;

struct Inputs {
  const float* ctrl[kCtrlFields];
  const float* pose;          // (B, 3)
  const float* vel;           // (B, 3)
  const float* accel_last;    // (B, 3)
  const float* eta_dot_last;  // (B, 3)
  const int32_t* perturb_step;
  const float* action;        // (B, 2) at the strides below, in elements
  long long action_stride_env, action_stride_channel;
};

// One float32 block of (10 + 12 + 7) * B: the controller
// fields as rows of B, then pose, vel, accel_last and eta_dot_last as (B, 3)
// each, then the last substep's fields as rows of B; and the int32 counter.
struct Outputs {
  float* block;
  int32_t* perturb_step;
};

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ float sign_of(float a) {
  return (float)((0.0f < a) - (a < 0.0f));
}

// core/angles.py::wrap_angle
__device__ __forceinline__ float wrap_angle(float a) {
  return atan2f(sinf(a), cosf(a));
}

// core/angles.py::wrap_angle_once
__device__ __forceinline__ float wrap_angle_once(float a, const AsmcConstants& k) {
  const float m = fabsf(a);
  const float wrapped = sign_of(a) * (m - k.two_pi);
  return m > k.pi ? wrapped : a;
}

__device__ __forceinline__ Vec3 load3(const float* p, long long b) {
  return {p[3 * b], p[3 * b + 1], p[3 * b + 2]};
}

__device__ __forceinline__ void store3(float* p, long long b, Vec3 v) {
  p[3 * b] = v.x;
  p[3 * b + 1] = v.y;
  p[3 * b + 2] = v.z;
}

// ---------------------------------------------------------------------------
// The Fossen model, physics/dynamics.py op for op, apart from the controller:
// the AITSMC loop's kernel can share it.

struct Hydro {
  float Xu, Xuu, Yv, Yr, Nv, Nr;
};

// hydrodynamic_coefficients
__device__ __forceinline__ Hydro hydrodynamic_coefficients(const FossenConstants& k, float u,
                                                           float v) {
  const bool fast = fabsf(u) > k.u_fast;
  Hydro h;
  h.Xu = fast ? k.xu_fast : k.xu_slow;
  h.Xuu = fast ? k.xuu_fast : k.xuu_slow;
  const float speed = sqrtf(u * u + v * v);
  h.Yv = k.yv_scale * fabsf(v) * 0.5f * k.yv_form;
  h.Yr = k.yr_scale * speed * k.hull_d * k.hull_d * k.hull_k;
  h.Nv = k.nv_scale * speed * k.hull_d * k.hull_d * k.hull_k;
  h.Nr = k.nr_scale * speed * k.hull_d * k.hull_d * k.hull_k * k.hull_k;
  return h;
}

// surge_yaw_model_terms: (f_u, f_psi); g_u and g_psi are constants
__device__ __forceinline__ void surge_yaw_model_terms(const FossenConstants& k, const Hydro& h,
                                                      Vec3 vel, float* f_u, float* f_psi) {
  const float u = vel.x, v = vel.y, r = vel.z;
  *f_u = (k.m_minus_yvd * v * r + (h.Xuu * fabsf(u) + h.Xu * u)) * k.g_u;
  *f_psi = (k.neg_xud_plus_yvd * u * v + h.Nr * r) * k.g_psi;
}

// fossen_acceleration, with the coefficients of the same vel
__device__ __forceinline__ Vec3 fossen_acceleration(const FossenConstants& k, const Hydro& h,
                                                    Vec3 vel, float tau_x, float tau_y,
                                                    float tau_z) {
  const float u = vel.x, v = vel.y, r = vel.z;
  const float c13 = k.neg_m * v + 2.0f * (k.y_v_dot * v + k.half_yrd_nvd * r);
  const float c23 = k.m * u - k.xud_m * u;
  const float c31 = k.m * v + 2.0f * (k.neg_y_v_dot * v - k.half_yrd_nvd * r);
  const float c32 = k.neg_m * u + k.xud_m * u;

  const float abs_u = fabsf(u), abs_v = fabsf(v), abs_r = fabsf(r);
  const float d11 = -h.Xu - h.Xuu * abs_u;
  const float d22 = -h.Yv - (k.yvv * abs_v + k.yvr * abs_r);
  const float d23 = -h.Yr - (k.yrv * abs_v + k.yrr * abs_r);
  const float d32 = -h.Nv - (k.nvv * abs_v + k.nvr * abs_r);
  const float d33 = -h.Nr - (k.nrv * abs_v + k.nrr * abs_r);

  const float rhs_u = tau_x - c13 * r - d11 * u;
  const float rhs_v = tau_y - c23 * r - (d22 * v + d23 * r);
  const float rhs_r = tau_z - (c31 * u + c32 * v) - (d32 * v + d33 * r);

  return {rhs_u * k.inv_m11, (k.m33 * rhs_v - k.m23 * rhs_r) * k.inv_det,
          (k.m22 * rhs_r - k.m32 * rhs_v) * k.inv_det};
}

struct Dynamics {
  Vec3 pose, vel, accel_last, eta_dot_last;
};

// dynamics_step: thrust -> acceleration -> the trapezoids. `h` holds the
// coefficients of s.vel; cos_psi, sin_psi those of s.pose.z. A perturbed
// step adds (perturb_x, perturb_y) to tau_x and to a zero tau_y, as the
// tensor ops add them.
__device__ __forceinline__ void dynamics_step(const FossenConstants& k, float half_dt,
                                              const Hydro& h, float cos_psi, float sin_psi,
                                              Dynamics& s, float tport, float tstbd,
                                              bool perturbed, float perturb_x, float perturb_y) {
  float tau_x = tport + k.c * tstbd;
  const float tau_z = k.half_b * (tport - k.c * tstbd);
  float tau_y = 0.0f;
  if (perturbed) {
    tau_x = tau_x + perturb_x;
    tau_y = tau_y + perturb_y;
  }
  const Vec3 a = fossen_acceleration(k, h, s.vel, tau_x, tau_y, tau_z);
  const Vec3 vel = {s.vel.x + half_dt * (a.x + s.accel_last.x),
                    s.vel.y + half_dt * (a.y + s.accel_last.y),
                    s.vel.z + half_dt * (a.z + s.accel_last.z)};
  const Vec3 eta_dot = {cos_psi * vel.x - sin_psi * vel.y, sin_psi * vel.x + cos_psi * vel.y,
                        vel.z};
  s.pose = {s.pose.x + half_dt * (eta_dot.x + s.eta_dot_last.x),
            s.pose.y + half_dt * (eta_dot.y + s.eta_dot_last.y),
            s.pose.z + half_dt * (eta_dot.z + s.eta_dot_last.z)};
  s.vel = vel;
  s.accel_last = a;
  s.eta_dot_last = eta_dot;
}

// ---------------------------------------------------------------------------

// AsmcState, control/asmc.py's field order
struct Ctrl {
  float psi_d_last, o, o_dot, o_dot_dot_last, e_u_last, e_u_int, ka_u, ka_psi, ka_dot_u_last,
      ka_dot_psi_last;
};

struct Last {
  float e_psi, sigma_u, sigma_psi, tport, tstbd, tx, tz;
};

// control/asmc.py::asmc_control: advances c, returns (tport, tstbd) in `last`
__device__ __forceinline__ void asmc_control(const SubstepConstants& K, const Hydro& h, Ctrl& c,
                                             float u_d, float heading, const Dynamics& s,
                                             bool absolute_heading, Last& last) {
  const AsmcConstants& k = K.asmc;
  const float u = s.vel.x, v = s.vel.y, r = s.vel.z;
  const float psi = s.pose.z;

  float psi_d;
  if (absolute_heading) {
    psi_d = heading;
  } else {
    const float beta = asinf(v / (hypotf(u, v) + k.hypot_eps));
    psi_d = psi + beta + heading;
  }

  float psi_d_diff = psi_d - c.psi_d_last;
  if (absolute_heading) psi_d_diff = wrap_angle(psi_d_diff);
  const float r_d_raw = psi_d_diff * K.step.inv_dt;
  const float o_dot_dot = ((r_d_raw - c.o) * k.f1 - k.f3 * c.o_dot) * k.f2;
  const float o_dot = K.step.half_dt * (o_dot_dot + c.o_dot_dot_last) + c.o_dot;
  const float o = K.step.half_dt * (o_dot + c.o_dot) + c.o;
  const float r_d = o;

  float f_u, f_psi;
  surge_yaw_model_terms(K.fossen, h, s.vel, &f_u, &f_psi);

  const float e_psi = absolute_heading ? wrap_angle(psi_d - psi) : wrap_angle_once(psi_d - psi, k);
  const float e_psi_dot = r_d - r;
  const float e_u = u_d - u;
  const float e_u_int = K.step.half_dt * (e_u + c.e_u_last) + c.e_u_int;

  const float sigma_u = e_u + k.lambda_u * e_u_int;
  const float sigma_psi = e_psi_dot + k.lambda_psi * e_psi;

  const float ka_dot_u = c.ka_u > k.kmin_u ? k.k_u * sign_of(fabsf(sigma_u) - k.mu_u) : k.kmin_u;
  const float ka_dot_psi =
      c.ka_psi > k.kmin_psi ? k.k_psi * sign_of(fabsf(sigma_psi) - k.mu_psi) : k.kmin_psi;
  const float ka_u = K.step.half_dt * (ka_dot_u + c.ka_dot_u_last) + c.ka_u;
  const float ka_psi = K.step.half_dt * (ka_dot_psi + c.ka_dot_psi_last) + c.ka_psi;

  const float ua_u = -ka_u * sqrtf(fabsf(sigma_u)) * sign_of(sigma_u) - k.k2_u * sigma_u;
  const float ua_psi =
      -ka_psi * sqrtf(fabsf(sigma_psi)) * sign_of(sigma_psi) - k.k2_psi * sigma_psi;
  const float tx = (k.lambda_u * e_u - f_u - ua_u) * k.inv_g_u;
  const float tz = (k.lambda_psi * e_psi - f_psi - ua_psi) * k.inv_g_psi;

  last.tport = tx * k.inv_two + tz * k.inv_b;
  last.tstbd = tx * k.inv_two_c - tz * k.inv_b_c;
  last.e_psi = e_psi;
  last.sigma_u = sigma_u;
  last.sigma_psi = sigma_psi;
  last.tx = tx;
  last.tz = tz;

  c = {psi_d, o, o_dot, o_dot_dot, e_u, e_u_int, ka_u, ka_psi, ka_dot_u, ka_dot_psi};
}

__global__ void asmc_substeps_kernel(Inputs in, Outputs out, SubstepConstants K, int B,
                                     int n_substeps, int absolute_heading, int do_perturb) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Ctrl c = {in.ctrl[0][b], in.ctrl[1][b], in.ctrl[2][b], in.ctrl[3][b], in.ctrl[4][b],
            in.ctrl[5][b], in.ctrl[6][b], in.ctrl[7][b], in.ctrl[8][b], in.ctrl[9][b]};
  Dynamics s = {load3(in.pose, b), load3(in.vel, b), load3(in.accel_last, b),
                load3(in.eta_dot_last, b)};
  const float* a = in.action + b * in.action_stride_env;
  const float u_d = a[0], heading = a[in.action_stride_channel];
  const int32_t perturb_step = in.perturb_step[b];

  Last last = {};
  for (int i = 0; i < n_substeps; ++i) {
    const Hydro h = hydrodynamic_coefficients(K.fossen, s.vel.x, s.vel.y);
    asmc_control(K, h, c, u_d, heading, s, absolute_heading != 0, last);
    const float cos_psi = cosf(s.pose.z), sin_psi = sinf(s.pose.z);
    float px = 0.0f, py = 0.0f;
    if (do_perturb) {
      // (perturb_step + i) as int32 tensors add: wrapping
      const int32_t n = (int32_t)((uint32_t)perturb_step + (uint32_t)i);
      const float t = (float)n * K.step.dt;
      const float fx = cosf(t * K.step.perturb_k) * K.step.perturb_magnitude;
      const float fy = cosf(t + K.step.perturb_k + 10.0f) * K.step.perturb_magnitude;
      px = cos_psi * fx + sin_psi * fy;
      py = -sin_psi * fx + cos_psi * fy;
    }
    dynamics_step(K.fossen, K.step.half_dt, h, cos_psi, sin_psi, s, last.tport, last.tstbd,
                  do_perturb != 0, px, py);
  }

  // rows of B: the controller's fields, then the (B, 3) blocks, then `last`
  float* o = out.block + b;
  const long long n = B;
  o[0] = c.psi_d_last;
  o[n] = c.o;
  o[2 * n] = c.o_dot;
  o[3 * n] = c.o_dot_dot_last;
  o[4 * n] = c.e_u_last;
  o[5 * n] = c.e_u_int;
  o[6 * n] = c.ka_u;
  o[7 * n] = c.ka_psi;
  o[8 * n] = c.ka_dot_u_last;
  o[9 * n] = c.ka_dot_psi_last;
  float* dyn = out.block + kCtrlFields * n;
  store3(dyn, b, s.pose);
  store3(dyn + 3 * n, b, s.vel);
  store3(dyn + 6 * n, b, s.accel_last);
  store3(dyn + 9 * n, b, s.eta_dot_last);
  o = out.block + (kCtrlFields + 12) * n + b;
  o[0] = last.e_psi;
  o[n] = last.sigma_u;
  o[2 * n] = last.sigma_psi;
  o[3 * n] = last.tport;
  o[4 * n] = last.tstbd;
  o[5 * n] = last.tx;
  o[6 * n] = last.tz;
  out.perturb_step[b] = (int32_t)((uint32_t)perturb_step + (uint32_t)n_substeps);
}

}  // namespace

// Launches the loop over B envs on `stream` and returns cudaGetLastError()
// (0 = ok). `inputs`: 15 device pointers (the 10 controller fields,
// pose, vel, accel_last, eta_dot_last, perturb_step); `constants`: host
// floats in the order of SubstepConstants' fields, copied into the launch's
// arguments; flags are 0/1.
extern "C" int usv_asmc_substeps_launch(const void* const* inputs, const float* action,
                                        long long action_stride_env,
                                        long long action_stride_channel, float* out_block,
                                        int32_t* out_perturb_step, const float* constants,
                                        int n_constants, int B, int n_substeps,
                                        int absolute_heading, int do_perturb, int threads,
                                        void* stream_ptr) {
  if (n_constants != (int)(sizeof(SubstepConstants) / sizeof(float)) || threads < 1 ||
      threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  Inputs in;
  for (int f = 0; f < kCtrlFields; ++f) in.ctrl[f] = static_cast<const float*>(inputs[f]);
  in.pose = static_cast<const float*>(inputs[kCtrlFields]);
  in.vel = static_cast<const float*>(inputs[kCtrlFields + 1]);
  in.accel_last = static_cast<const float*>(inputs[kCtrlFields + 2]);
  in.eta_dot_last = static_cast<const float*>(inputs[kCtrlFields + 3]);
  in.perturb_step = static_cast<const int32_t*>(inputs[kCtrlFields + 4]);
  in.action = action;
  in.action_stride_env = action_stride_env;
  in.action_stride_channel = action_stride_channel;
  SubstepConstants K;
  memcpy(&K, constants, sizeof(K));
  if (B > 0) {
    const int grid = (B + threads - 1) / threads;
    asmc_substeps_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        in, Outputs{out_block, out_perturb_step}, K, B, n_substeps, absolute_heading,
        do_perturb);
  }
  return (int)cudaGetLastError();
}
