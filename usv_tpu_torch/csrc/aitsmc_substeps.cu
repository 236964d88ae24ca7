// The AITSMC substep loop for Hopper (sm_90a), hand-written CUDA.
//
// Replaces no TPU kernel: the JAX package leaves this loop to XLA, which
// fuses the `lax.scan` of `aitsmc_compute` (usv_tpu/control/aitsmc.py) into
// a few kernels. The port ran it as a Python loop of PyTorch ops, ~240
// elementwise kernels a substep on (B,) float32 vectors, so a 5-substep step
// of usv-curved-aitsmc launched ~1,200 kernels of ~1.25 us whose work is
// worth nanoseconds. This kernel is that whole loop in one launch:
// usv_tpu_torch/control/aitsmc.py::aitsmc_compute routes CUDA float32 inputs
// here (launcher: ops/aitsmc_cuda.py). The ASMC loop has a kernel of its own
// (csrc/asmc_substeps.cu); the two share the Fossen model (csrc/fossen.cuh)
// and nothing of their controller laws.
//
// What it computes, per env, for each of n_substeps substeps (dt each):
//   aitsmc_control      the surge/yaw model terms, the errors of the surge
//                       and yaw-rate setpoints, the trapezoidal integrals of
//                       sig(e)^beta (beta = 0.5: sqrt(|e|) * sign(e), the
//                       square root PyTorch's pow takes for 0.5), the
//                       integral-terminal sliding surfaces, the adaptive
//                       gains with dead zone and floor, the sqrt-sigma
//                       reaching law with the setpoint's feedforward, and
//                       the thrust allocation under the asymmetric clip;
//   dynamics_step       the Fossen step (csrc/fossen.cuh), with the caller's
//                       body force (tau_x, tau_y, tau_z) added when given:
//                       constant over the substeps.
// It stores the advanced controller state (8 floats), the dynamics state
// (pose, vel, accel_last, eta_dot_last: 12 floats) and the last substep's
// sigma_u, sigma_r, tport and tstbd.
//
// What bounds it. Per env it reads 20 floats of state, 2 to 4 of setpoint
// and 0 or 3 of force, and writes 24 floats: ~190 bytes, 0.23 us for 4096
// envs at 3.35 TB/s. A substep is ~200 float32 operations, five square roots
// and a sine and cosine, each a dependent chain, so the 5 substeps are one
// chain of dependent instructions per env: the kernel is bound by that
// chain's latency, not by bytes or issue rate. Its design is the ASMC
// kernel's: one thread per env with the whole loop in registers, small blocks
// (the launcher's choice) that spread the chains over the SMs, and every
// constant a kernel argument passed by value, so a CUDA graph captures it
// with the launch.
//
// Numerics: bit for bit the PyTorch ops of the eager loop on the card, by
// the rules of csrc/asmc_substeps.cu: -fmad=false and no fast math; each
// tensor op one rounded float32 operation in the association order of the
// Python source; each Python-side constant folded in double as Python folds
// it, then cast to float32; a tensor divided by a Python float multiplied by
// float32 of the reciprocal taken in double (inv_*); sign is torch.sign's;
// a `torch.where` a select of both computed branches; torch.clamp with
// number bounds returns a NaN as it is, else min(max(v, lo), hi). A
// feedforward given as a Python number is added as float32 of it, as
// PyTorch adds a scalar to a tensor.

#include <string.h>

#include "fossen.cuh"

namespace {

// control/aitsmc.py::aitsmc_control's Python-side constants.
struct AitsmcConstants {
  float lambda_u, lambda_r, kmin_u, kmin_r, k_u, k_r, mu_u, mu_r, k2_u, k2_r, t_min, t_max;
  float inv_g_u, inv_g_r, inv_two, inv_b, inv_two_c, inv_b_c;
};

// The substep's 0.5 * dt.
struct StepConstants {
  float half_dt;
};

struct SubstepConstants {
  FossenConstants fossen;
  AitsmcConstants aitsmc;
  StepConstants step;
};

constexpr int kCtrlFields = 8;  // AitsmcState's fields, in declaration order
constexpr int kSetpoints = 4;   // u, r, dot_u, dot_r
constexpr int kMaxThreads = 1024;

struct Inputs {
  const float* ctrl[kCtrlFields];
  const float* pose;          // (B, 3)
  const float* vel;           // (B, 3)
  const float* accel_last;    // (B, 3)
  const float* eta_dot_last;  // (B, 3)
  // (B,) at the strides below, in elements; a null dot_u or dot_r reads the
  // number of the same name, the feedforward the caller gave as one
  const float* setpoint[kSetpoints];
  long long setpoint_stride[kSetpoints];
  float dot_u, dot_r;
  const float* perturb;  // (B, 3) at the strides below, or null: no force
  long long perturb_stride_env, perturb_stride_channel;
};

// AitsmcState, control/aitsmc.py's field order
struct Ctrl {
  float e_u_int, e_r_int, e_u_last, e_r_last, ka_u, ka_r, ka_dot_u_last, ka_dot_r_last;
};

struct Last {
  float sigma_u, sigma_r, tport, tstbd;
};

// control/aitsmc.py::_sig_pow at beta = 0.5
__device__ __forceinline__ float sig_sqrt(float x) {
  return sqrtf(fabsf(x)) * sign_of(x);
}

// torch.clamp(v, lo, hi) with number bounds
__device__ __forceinline__ float clamp_to(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// control/aitsmc.py::aitsmc_control: advances c, returns the last fields
__device__ __forceinline__ void aitsmc_control(const SubstepConstants& K, const Hydro& h, Ctrl& c,
                                               float sp_u, float sp_r, float dot_u, float dot_r,
                                               Vec3 vel, Last& last) {
  const AitsmcConstants& k = K.aitsmc;
  const float half_dt = K.step.half_dt;
  const float u = vel.x, r = vel.z;

  float f_u, f_r;
  surge_yaw_model_terms(K.fossen, h, vel, &f_u, &f_r);

  const float e_u = sp_u - u;
  const float e_r = sp_r - r;

  const float sig_e_u = sig_sqrt(e_u);
  const float sig_e_r = sig_sqrt(e_r);
  const float e_u_int = half_dt * (sig_e_u + sig_sqrt(c.e_u_last)) + c.e_u_int;
  const float e_r_int = half_dt * (sig_e_r + sig_sqrt(c.e_r_last)) + c.e_r_int;
  const float sigma_u = e_u + k.lambda_u * e_u_int;
  const float sigma_r = e_r + k.lambda_r * e_r_int;

  const float ka_dot_u = c.ka_u > k.kmin_u ? k.k_u * sign_of(fabsf(sigma_u) - k.mu_u) : k.kmin_u;
  const float ka_dot_r = c.ka_r > k.kmin_r ? k.k_r * sign_of(fabsf(sigma_r) - k.mu_r) : k.kmin_r;
  const float ka_u = half_dt * (ka_dot_u + c.ka_dot_u_last) + c.ka_u;
  const float ka_r = half_dt * (ka_dot_r + c.ka_dot_r_last) + c.ka_r;

  const float ua_u = -ka_u * sqrtf(fabsf(sigma_u)) * sign_of(sigma_u) - k.k2_u * sigma_u;
  const float ua_r = -ka_r * sqrtf(fabsf(sigma_r)) * sign_of(sigma_r) - k.k2_r * sigma_r;

  const float tx = (dot_u + k.lambda_u * sig_e_u - f_u - ua_u) * k.inv_g_u;
  const float tz = (dot_r + k.lambda_r * sig_e_r - f_r - ua_r) * k.inv_g_r;

  last.tport = clamp_to(tx * k.inv_two + tz * k.inv_b, k.t_min, k.t_max);
  last.tstbd = clamp_to(tx * k.inv_two_c - tz * k.inv_b_c, k.t_min, k.t_max);
  last.sigma_u = sigma_u;
  last.sigma_r = sigma_r;

  c = {e_u_int, e_r_int, e_u, e_r, ka_u, ka_r, ka_dot_u, ka_dot_r};
}

__global__ void aitsmc_substeps_kernel(Inputs in, float* out, SubstepConstants K, int B,
                                       int n_substeps) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  Ctrl c = {in.ctrl[0][b], in.ctrl[1][b], in.ctrl[2][b], in.ctrl[3][b],
            in.ctrl[4][b], in.ctrl[5][b], in.ctrl[6][b], in.ctrl[7][b]};
  Dynamics s = {load3(in.pose, b), load3(in.vel, b), load3(in.accel_last, b),
                load3(in.eta_dot_last, b)};
  const float sp_u = in.setpoint[0][b * in.setpoint_stride[0]];
  const float sp_r = in.setpoint[1][b * in.setpoint_stride[1]];
  const float dot_u = in.setpoint[2] ? in.setpoint[2][b * in.setpoint_stride[2]] : in.dot_u;
  const float dot_r = in.setpoint[3] ? in.setpoint[3][b * in.setpoint_stride[3]] : in.dot_r;
  const bool perturbed = in.perturb != nullptr;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (perturbed) {
    const float* p = in.perturb + b * in.perturb_stride_env;
    px = p[0];
    py = p[in.perturb_stride_channel];
    pz = p[2 * in.perturb_stride_channel];
  }

  Last last = {};
  for (int i = 0; i < n_substeps; ++i) {
    const Hydro h = hydrodynamic_coefficients(K.fossen, s.vel.x, s.vel.y);
    aitsmc_control(K, h, c, sp_u, sp_r, dot_u, dot_r, s.vel, last);
    const float cos_psi = cosf(s.pose.z), sin_psi = sinf(s.pose.z);
    dynamics_step(K.fossen, K.step.half_dt, h, cos_psi, sin_psi, s, last.tport, last.tstbd,
                  perturbed, px, py, perturbed, pz);
  }

  // rows of B: the controller's fields, then the (B, 3) blocks, then `last`
  float* o = out + b;
  const long long n = B;
  o[0] = c.e_u_int;
  o[n] = c.e_r_int;
  o[2 * n] = c.e_u_last;
  o[3 * n] = c.e_r_last;
  o[4 * n] = c.ka_u;
  o[5 * n] = c.ka_r;
  o[6 * n] = c.ka_dot_u_last;
  o[7 * n] = c.ka_dot_r_last;
  float* dyn = out + kCtrlFields * n;
  store3(dyn, b, s.pose);
  store3(dyn + 3 * n, b, s.vel);
  store3(dyn + 6 * n, b, s.accel_last);
  store3(dyn + 9 * n, b, s.eta_dot_last);
  o = out + (kCtrlFields + 12) * n + b;
  o[0] = last.sigma_u;
  o[n] = last.sigma_r;
  o[2 * n] = last.tport;
  o[3 * n] = last.tstbd;
}

}  // namespace

// Launches the loop over B envs on `stream` and returns cudaGetLastError()
// (0 = ok). `inputs`: 12 device pointers (the 8 controller fields, pose,
// vel, accel_last, eta_dot_last); `setpoint`: 4 device pointers (u, r,
// dot_u, dot_r; a null dot_* reads the number of that name) at
// `setpoint_strides`;
// `perturb`: (B, 3) at its strides, or null; `out_block`: (8 + 12 + 4) * B
// floats; `constants`: host floats in the order of SubstepConstants' fields,
// copied into the launch's arguments.
extern "C" int usv_aitsmc_substeps_launch(const void* const* inputs, const void* const* setpoint,
                                          const long long* setpoint_strides, float dot_u,
                                          float dot_r, const float* perturb,
                                          long long perturb_stride_env,
                                          long long perturb_stride_channel, float* out_block,
                                          const float* constants, int n_constants, int B,
                                          int n_substeps, int threads, void* stream_ptr) {
  if (n_constants != (int)(sizeof(SubstepConstants) / sizeof(float)) || threads < 1 ||
      threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  Inputs in;
  for (int f = 0; f < kCtrlFields; ++f) in.ctrl[f] = static_cast<const float*>(inputs[f]);
  in.pose = static_cast<const float*>(inputs[kCtrlFields]);
  in.vel = static_cast<const float*>(inputs[kCtrlFields + 1]);
  in.accel_last = static_cast<const float*>(inputs[kCtrlFields + 2]);
  in.eta_dot_last = static_cast<const float*>(inputs[kCtrlFields + 3]);
  for (int f = 0; f < kSetpoints; ++f) {
    in.setpoint[f] = static_cast<const float*>(setpoint[f]);
    in.setpoint_stride[f] = setpoint_strides[f];
  }
  in.dot_u = dot_u;
  in.dot_r = dot_r;
  in.perturb = perturb;
  in.perturb_stride_env = perturb_stride_env;
  in.perturb_stride_channel = perturb_stride_channel;
  SubstepConstants K;
  memcpy(&K, constants, sizeof(K));
  if (B > 0) {
    const int grid = (B + threads - 1) / threads;
    aitsmc_substeps_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
        in, out_block, K, B, n_substeps);
  }
  return (int)cudaGetLastError();
}
