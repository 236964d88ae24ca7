// usv_native — C++ CPU oracle of the USV dynamics, controllers, and sensor.
//
// Role in the framework (SURVEY.md §2.2): the reference ships a native C++
// library (usv_libs: DynamicModel / ASMC / AITSMC via pybind11) plus a numba
// raycast kernel. On TPU the compute path is XLA/Pallas; this translation
// unit is the native CPU tier — an independently written implementation of
// the same math (spec: reference control/usv_asmc.py:53-244 and
// usv_asmc_ca_env.py:439-461) used as a bit-parity oracle for the JAX
// kernels and as a fast host-side single-env backend. Exposed as a plain C
// ABI consumed via ctypes (no pybind11 in this image).
//
// State layouts (double):
//   dyn[12]  = x, y, psi, u, v, r, du, dv, dr (accel_last), ex, ey, er (eta_dot_last)
//   asmc[12] = psi_d_last, o, o_last, o_dot, o_dot_last, o_dot_dot_last,
//              e_u_last, e_u_int, ka_u, ka_psi, ka_dot_u_last, ka_dot_psi_last
//   aitsmc[10] = e_u_int, e_r_int, e_u_last, e_r_last, ka_u, ka_r,
//                ka_dot_u_last, ka_dot_r_last, e_u_dbg, e_r_dbg
//   pid[2]   = e_u_last, e_u_int

#include <cmath>
#include <cstring>
#include <algorithm>

namespace {

// Vehicle coefficients (Gonzalez-Garcia & Castañeda model).
constexpr double X_u_dot = -2.25;
constexpr double Y_v_dot = -23.13;
constexpr double Y_r_dot = -1.31;
constexpr double N_v_dot = -16.41;
constexpr double N_r_dot = -2.79;
constexpr double Yvv = -99.99, Yvr = -5.49, Yrv = -5.49, Yrr = -8.8;
constexpr double Nvv = -5.49, Nvr = -8.8, Nrv = -8.8, Nrr = -3.49;
constexpr double MASS = 30.0, IZ = 4.1, BB = 0.41, CC = 0.78;
constexpr double REF_PI = 3.141592;  // the reference spells pi this way

constexpr double M11 = MASS - X_u_dot;
constexpr double M22 = MASS - Y_v_dot;
constexpr double M23 = -Y_r_dot;
constexpr double M32 = -N_v_dot;
constexpr double M33 = IZ - N_r_dot;

const double YV_FORM =
    1.1 + 0.0045 * (1.01 / 0.09) - 0.1 * (0.27 / 0.09) +
    0.016 * (0.27 / 0.09) * (0.27 / 0.09);

inline double sgn(double x) { return (x > 0) - (x < 0); }

inline double wrap_once(double a) {
  return std::fabs(a) > M_PI ? sgn(a) * (std::fabs(a) - 2.0 * M_PI) : a;
}

inline double wrap_atan2(double a) { return std::atan2(std::sin(a), std::cos(a)); }

void hydro(double u, double v, double& Xu, double& Xuu, double& Yv, double& Yr,
           double& Nv, double& Nr) {
  if (std::fabs(u) > 1.2) {
    Xu = 64.55;
    Xuu = -70.92;
  } else {
    Xu = -25.0;
    Xuu = 0.0;
  }
  const double speed = std::sqrt(u * u + v * v);
  Yv = 0.5 * (-40.0 * 1000.0 * std::fabs(v)) * YV_FORM;
  Yr = 6.0 * (-REF_PI * 1000.0) * speed * 0.09 * 0.09 * 1.01;
  Nv = 0.06 * (-REF_PI * 1000.0) * speed * 0.09 * 0.09 * 1.01;
  Nr = 0.02 * (-REF_PI * 1000.0) * speed * 0.09 * 0.09 * 1.01 * 1.01;
}

// f/g simplification shared by all three controllers.
void fg_terms(double u, double v, double r, double& f_u, double& f_psi,
              double& g_u, double& g_psi) {
  double Xu, Xuu, Yv, Yr, Nv, Nr;
  hydro(u, v, Xu, Xuu, Yv, Yr, Nv, Nr);
  g_u = 1.0 / (MASS - X_u_dot);
  g_psi = 1.0 / (IZ - N_r_dot);
  f_u = ((MASS - Y_v_dot) * v * r + (Xuu * std::fabs(u) + Xu * u)) * g_u;
  f_psi = ((-X_u_dot + Y_v_dot) * u * v + Nr * r) * g_psi;
}

}  // namespace

extern "C" {

void usv_dyn_init(double* dyn, double x, double y, double psi) {
  std::memset(dyn, 0, 12 * sizeof(double));
  dyn[0] = x;
  dyn[1] = y;
  dyn[2] = psi;
}

// One trapezoidal substep: thrusters (+ optional body-frame perturb force).
void usv_dyn_step(double* dyn, double tport, double tstbd, double dt,
                  const double* perturb3) {
  const double psi = dyn[2];
  const double u = dyn[3], v = dyn[4], r = dyn[5];

  double tau_x = tport + CC * tstbd;
  double tau_y = 0.0;
  double tau_z = 0.5 * BB * (tport - CC * tstbd);
  if (perturb3) {
    tau_x += perturb3[0];
    tau_y += perturb3[1];
    tau_z += perturb3[2];
  }

  double Xu, Xuu, Yv, Yr, Nv, Nr;
  hydro(u, v, Xu, Xuu, Yv, Yr, Nv, Nr);

  const double c13 = -MASS * v + 2.0 * (Y_v_dot * v + 0.5 * (Y_r_dot + N_v_dot) * r);
  const double c23 = MASS * u - X_u_dot * MASS * u;
  const double c31 = MASS * v + 2.0 * (-Y_v_dot * v - 0.5 * (Y_r_dot + N_v_dot) * r);
  const double c32 = -MASS * u + X_u_dot * MASS * u;

  const double d11 = -Xu - Xuu * std::fabs(u);
  const double d22 = -Yv - (Yvv * std::fabs(v) + Yvr * std::fabs(r));
  const double d23 = -Yr - (Yrv * std::fabs(v) + Yrr * std::fabs(r));
  const double d32 = -Nv - (Nvv * std::fabs(v) + Nvr * std::fabs(r));
  const double d33 = -Nr - (Nrv * std::fabs(v) + Nrr * std::fabs(r));

  const double rhs_u = tau_x - c13 * r - d11 * u;
  const double rhs_v = tau_y - c23 * r - (d22 * v + d23 * r);
  const double rhs_r = tau_z - (c31 * u + c32 * v) - (d32 * v + d33 * r);

  const double det = M22 * M33 - M23 * M32;
  const double au = rhs_u / M11;
  const double av = (M33 * rhs_v - M23 * rhs_r) / det;
  const double ar = (M22 * rhs_r - M32 * rhs_v) / det;

  const double nu = u + 0.5 * dt * (au + dyn[6]);
  const double nv = v + 0.5 * dt * (av + dyn[7]);
  const double nr = r + 0.5 * dt * (ar + dyn[8]);

  const double cp = std::cos(psi), sp = std::sin(psi);
  const double ex = cp * nu - sp * nv;
  const double ey = sp * nu + cp * nv;
  const double er = nr;

  dyn[0] += 0.5 * dt * (ex + dyn[9]);
  dyn[1] += 0.5 * dt * (ey + dyn[10]);
  dyn[2] += 0.5 * dt * (er + dyn[11]);
  dyn[3] = nu;
  dyn[4] = nv;
  dyn[5] = nr;
  dyn[6] = au;
  dyn[7] = av;
  dyn[8] = ar;
  dyn[9] = ex;
  dyn[10] = ey;
  dyn[11] = er;
}

void usv_asmc_init(double* asmc) { std::memset(asmc, 0, 12 * sizeof(double)); }

// One 100 Hz ASMC update; outputs thrusters (unsaturated, per the spec).
void usv_asmc_control(double* a, const double* dyn, double u_d,
                      double heading, int absolute_heading, double dt,
                      double* tport_out, double* tstbd_out) {
  const double psi = dyn[2];
  const double u = dyn[3], v = dyn[4], r = dyn[5];

  // ASMC gains (spec control/usv_asmc.py:26-41)
  const double k_u = 0.1, k_psi = 0.2, kmin_u = 0.05, kmin_psi = 0.2;
  const double k2_u = 0.02, k2_psi = 0.1, mu_u = 0.05, mu_psi = 0.1;
  const double lambda_u = 0.001, lambda_psi = 1.0;
  const double f1 = 2.0, f2 = 2.0, f3 = 2.0;

  double psi_d;
  if (absolute_heading) {
    psi_d = heading;
  } else {
    const double beta = std::asin(v / (0.001 + std::hypot(u, v)));
    psi_d = psi + beta + heading;
  }

  // second-order filter for r_d (absolute mode: the setpoint lives on the
  // circle — wrap the finite difference across the +-pi seam)
  double psi_d_diff = psi_d - a[0];
  if (absolute_heading) psi_d_diff = wrap_atan2(psi_d_diff);
  const double r_d_raw = psi_d_diff / dt;
  const double o_dot_dot = ((r_d_raw - a[2]) * f1 - f3 * a[4]) * f2;
  const double o_dot = 0.5 * dt * (o_dot_dot + a[5]) + a[3];
  const double o = 0.5 * dt * (o_dot + a[4]) + a[1];
  const double r_d = o;

  double f_u, f_psi, g_u, g_psi;
  fg_terms(u, v, r, f_u, f_psi, g_u, g_psi);

  // offset mode keeps the reference's single-branch wrap; absolute mode
  // needs the total wrap (psi is unbounded — matches the JAX side)
  const double e_psi = absolute_heading ? wrap_atan2(psi_d - psi)
                                        : wrap_once(psi_d - psi);
  const double e_psi_dot = r_d - r;
  const double e_u = u_d - u;
  const double e_u_int = 0.5 * dt * (e_u + a[6]) + a[7];

  const double sigma_u = e_u + lambda_u * e_u_int;
  const double sigma_psi = e_psi_dot + lambda_psi * e_psi;

  const double ka_dot_u =
      a[8] > kmin_u ? k_u * sgn(std::fabs(sigma_u) - mu_u) : kmin_u;
  const double ka_dot_psi =
      a[9] > kmin_psi ? k_psi * sgn(std::fabs(sigma_psi) - mu_psi) : kmin_psi;
  const double ka_u = 0.5 * dt * (ka_dot_u + a[10]) + a[8];
  const double ka_psi = 0.5 * dt * (ka_dot_psi + a[11]) + a[9];

  const double ua_u =
      -ka_u * std::sqrt(std::fabs(sigma_u)) * sgn(sigma_u) - k2_u * sigma_u;
  const double ua_psi = -ka_psi * std::sqrt(std::fabs(sigma_psi)) * sgn(sigma_psi) -
                        k2_psi * sigma_psi;

  const double tx = (lambda_u * e_u - f_u - ua_u) / g_u;
  const double tz = (lambda_psi * e_psi - f_psi - ua_psi) / g_psi;

  *tport_out = tx / 2.0 + tz / BB;
  *tstbd_out = tx / (2.0 * CC) - tz / (BB * CC);

  a[0] = psi_d;
  a[1] = o;
  a[2] = o;
  a[3] = o_dot;
  a[4] = o_dot;
  a[5] = o_dot_dot;
  a[6] = e_u;
  a[7] = e_u_int;
  a[8] = ka_u;
  a[9] = ka_psi;
  a[10] = ka_dot_u;
  a[11] = ka_dot_psi;
}

// N substeps of {ASMC -> dynamics} with optional sinusoidal perturbation —
// the update_controller_and_model_n analog. perturb_step advances per substep.
void usv_asmc_compute(double* asmc, double* dyn, double u_d, double heading,
                      int absolute_heading, int do_perturb, int n, double dt,
                      long long* perturb_step) {
  for (int i = 0; i < n; ++i) {
    double tport, tstbd;
    usv_asmc_control(asmc, dyn, u_d, heading, absolute_heading, dt, &tport, &tstbd);
    double perturb[3] = {0.0, 0.0, 0.0};
    if (do_perturb) {
      const double freq = 10.0, magnitude = 5.0;
      const double t = static_cast<double>(*perturb_step) * dt;
      const double k = freq * 2.0 * M_PI;
      const double fx = std::cos(t * k) * magnitude;
      const double fy = std::cos(t + k + 10.0) * magnitude;
      const double cp = std::cos(dyn[2]), sp = std::sin(dyn[2]);
      perturb[0] = cp * fx + sp * fy;
      perturb[1] = -sp * fx + cp * fy;
    }
    usv_dyn_step(dyn, tport, tstbd, dt, perturb);
    ++*perturb_step;
  }
}

void usv_pid_init(double* pid) { std::memset(pid, 0, 2 * sizeof(double)); }

void usv_pid_control(double* p, const double* dyn, double u_d, double heading,
                     double dt, double* tport_out, double* tstbd_out) {
  const double psi = dyn[2];
  const double u = dyn[3], v = dyn[4], r = dyn[5];
  const double kp_u = 1.6, ki_u = 0.2, kd_u = 0.1, kp_psi = 22.625, kd_psi = 10.0;

  const double beta = std::asin(v / (0.001 + std::hypot(u, v)));
  const double psi_d = wrap_atan2(psi + heading + beta);

  double f_u, f_psi, g_u, g_psi;
  fg_terms(u, v, r, f_u, f_psi, g_u, g_psi);

  const double e_psi = wrap_atan2(psi_d - psi);
  const double e_u = u_d - u;
  const double e_u_int = 0.5 * dt * (e_u + p[0]) + p[1];
  const double e_u_dot = (e_u - p[0]) / dt;

  const double ua_u = kp_u * e_u + ki_u * e_u_int + kd_u * e_u_dot;
  const double ua_psi = kp_psi * e_psi + kd_psi * (-r);

  const double tx = (-f_u + ua_u) / g_u;
  const double tz = (-f_psi + ua_psi) / g_psi;
  *tport_out = std::clamp(tx / 2.0 + tz / BB, -30.0, 30.0);
  *tstbd_out = std::clamp(tx / (2.0 * CC) - tz / (BB * CC), -30.0, 30.0);

  // e_u_last (p[0]) intentionally NOT updated — reference quirk: usv_pid.py
  // never writes it back, so it stays 0.
  p[1] = e_u_int;
}

void usv_aitsmc_init(double* a) { std::memset(a, 0, 10 * sizeof(double)); }

// AITSMC gains struct passed flat:
// g[12] = k_u, k_r, kmin_u, kmin_r, mu_u, mu_r, k2_u, k2_r,
//         lambda_u, lambda_r, beta, t_min (t_max implied 36.5 unless g[11]<0)
void usv_aitsmc_control(double* a, const double* dyn, const double* g,
                        double u_sp, double r_sp, double dot_u, double dot_r,
                        double dt, double* tport_out, double* tstbd_out) {
  const double u = dyn[3], v = dyn[4], r = dyn[5];
  const double k_u = g[0], k_r = g[1], kmin_u = g[2], kmin_r = g[3];
  const double mu_u = g[4], mu_r = g[5], k2_u = g[6], k2_r = g[7];
  const double lambda_u = g[8], lambda_r = g[9], beta = g[10];
  const double t_min = g[11], t_max = 36.5;

  double f_u, f_r, g_u, g_r;
  fg_terms(u, v, r, f_u, f_r, g_u, g_r);

  auto sig = [beta](double x) { return std::pow(std::fabs(x), beta) * sgn(x); };

  const double e_u = u_sp - u;
  const double e_r = r_sp - r;
  const double e_u_int = 0.5 * dt * (sig(e_u) + sig(a[2])) + a[0];
  const double e_r_int = 0.5 * dt * (sig(e_r) + sig(a[3])) + a[1];
  const double sigma_u = e_u + lambda_u * e_u_int;
  const double sigma_r = e_r + lambda_r * e_r_int;

  const double ka_dot_u = a[4] > kmin_u ? k_u * sgn(std::fabs(sigma_u) - mu_u) : kmin_u;
  const double ka_dot_r = a[5] > kmin_r ? k_r * sgn(std::fabs(sigma_r) - mu_r) : kmin_r;
  const double ka_u = 0.5 * dt * (ka_dot_u + a[6]) + a[4];
  const double ka_r = 0.5 * dt * (ka_dot_r + a[7]) + a[5];

  const double ua_u = -ka_u * std::sqrt(std::fabs(sigma_u)) * sgn(sigma_u) - k2_u * sigma_u;
  const double ua_r = -ka_r * std::sqrt(std::fabs(sigma_r)) * sgn(sigma_r) - k2_r * sigma_r;

  const double tx = (dot_u + lambda_u * sig(e_u) - f_u - ua_u) / g_u;
  const double tz = (dot_r + lambda_r * sig(e_r) - f_r - ua_r) / g_r;

  *tport_out = std::clamp(tx / 2.0 + tz / BB, t_min, t_max);
  *tstbd_out = std::clamp(tx / (2.0 * CC) - tz / (BB * CC), t_min, t_max);

  a[0] = e_u_int;
  a[1] = e_r_int;
  a[2] = e_u;
  a[3] = e_r;
  a[4] = ka_u;
  a[5] = ka_r;
  a[6] = ka_dot_u;
  a[7] = ka_dot_r;
  a[8] = e_u;
  a[9] = e_r;
}

// Sorted-first-hit raycast, semantics of the numba kernel
// (spec usv_asmc_ca_env.py:439-461): obstacles visited nearest-boundary-first,
// first in-front intersection with distance < max_range wins.
void usv_raycast(const double* position3, int sensor_count, double max_range,
                 double resolution, const double* obs_x, const double* obs_y,
                 const double* obs_r, int num_obs, double* out_dist) {
  const double x = position3[0], y = position3[1], psi = position3[2];

  // order obstacles by boundary distance (simple insertion-sorted indices)
  int order[256];
  double key[256];
  const int n = num_obs > 256 ? 256 : num_obs;
  for (int j = 0; j < n; ++j) {
    order[j] = j;
    key[j] = std::hypot(obs_x[j] - x, obs_y[j] - y) - obs_r[j];
  }
  std::sort(order, order + n, [&](int a, int b) { return key[a] < key[b]; });

  for (int i = 0; i < sensor_count; ++i) {
    const double ang = psi - 2.0 * M_PI / 3.0 + i * resolution;
    const double c = std::cos(ang), s = std::sin(ang);
    double best = max_range;
    for (int jj = 0; jj < n; ++jj) {
      const int j = order[jj];
      const double nx = obs_x[j] - x, ny = obs_y[j] - y;
      const double ox = c * nx + s * ny;
      if (ox < 0) continue;  // behind the sensor
      const double oy = s * nx - c * ny;
      const double delta = obs_r[j] * obs_r[j] - oy * oy;
      if (delta < 0) continue;
      const double d = ox - std::sqrt(delta);
      if (d < max_range) {
        best = std::min(d, best);
        break;
      }
    }
    out_dist[i] = best;
  }
}

}  // extern "C"
