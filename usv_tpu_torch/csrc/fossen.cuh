// The Fossen 3-DOF model of physics/dynamics.py, op for op, as device
// functions that the substep kernels share: csrc/asmc_substeps.cu and
// csrc/aitsmc_substeps.cu include this header and keep their own controller
// laws. The numerics notes at the top of those files hold here too: build
// with -fmad=false and without fast math, every line one rounded float32
// operation in the association order of the Python source, every
// Python-side constant folded in double as Python folds it and cast to
// float32 (ops/_substeps.py::fossen_constants packs them).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

struct Vec3 {
  float x, y, z;
};

// torch.sign: (0 < a) - (a < 0), 0 at 0 and at NaN
__device__ __forceinline__ float sign_of(float a) {
  return (float)((0.0f < a) - (a < 0.0f));
}

__device__ __forceinline__ Vec3 load3(const float* p, long long b) {
  return {p[3 * b], p[3 * b + 1], p[3 * b + 2]};
}

__device__ __forceinline__ void store3(float* p, long long b, Vec3 v) {
  p[3 * b] = v.x;
  p[3 * b + 1] = v.y;
  p[3 * b + 2] = v.z;
}

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
// step adds (perturb_x, perturb_y) to tau_x and to a zero tau_y, and with
// perturbed_z perturb_z to tau_z, as the tensor ops add them; an unperturbed
// component adds nothing (a Python zero is skipped there, and -0 + 0 is +0).
__device__ __forceinline__ void dynamics_step(const FossenConstants& k, float half_dt,
                                              const Hydro& h, float cos_psi, float sin_psi,
                                              Dynamics& s, float tport, float tstbd,
                                              bool perturbed, float perturb_x, float perturb_y,
                                              bool perturbed_z = false, float perturb_z = 0.0f) {
  float tau_x = tport + k.c * tstbd;
  float tau_z = k.half_b * (tport - k.c * tstbd);
  float tau_y = 0.0f;
  if (perturbed) {
    tau_x = tau_x + perturb_x;
    tau_y = tau_y + perturb_y;
  }
  if (perturbed_z) tau_z = tau_z + perturb_z;
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

}  // namespace
