// Ray-cast obstacle sensor for Hopper (sm_90a), hand-written CUDA.
//
// Replaces the TPU kernel `_batched_kernel` of usv_tpu/ops/raycast_pallas.py
// (launched by the pl.pallas_call in `raycast_pallas_batched`), together with
// that function's host-side prep (obstacle-major transposes, the
// q = r^2 - d^2 prefold, the mask folded into the key as +inf): all of it
// happens here, in one launch, on the caller's (B, ...) layout.
//
// What it computes, per env b and ray i, over K masked circle obstacles:
//   c, s   = cos/sin of the ray's world angle (addition identity on the
//            host-computed per-ray table, or the direct cosf/sinf form)
//   xk     = c*nx + s*ny                      (obstacle centre along the ray)
//   delta  = q + xk*xk, q = r^2 - |n|^2       (fold_lateral)
//          | r^2 - yk*yk, yk = s*nx - c*ny    (no fold: tangency-safe form)
//   first hit : the obstacle with the least key (boundary distance, +inf on
//               masked slots) among hits with xk >= 0 and distance < range;
//               slots are tested in ascending order with a strict <, so the
//               first slot wins an exact tie.
//     defer_sqrt: the hit test runs in squared space,
//               delta >= max(xk - range, 0)^2, and one sqrt runs on the
//               winner, clamped to max_range (the in-loop form guaranteed
//               outputs strictly below range; the squared test admits a
//               ~1 ulp band above it).
//     no defer: dist = xk - sqrt(delta); a miss gives NaN, which fails
//               `dist < range`.
//   true min  : min over xk >= 0 & delta >= 0 & mask of xk - sqrt(max(delta,0)),
//               starting at max_range.
//   No hit gives max_range.
//
// Mapping: threadIdx.x runs over rays (output writes coalesce along R),
// threadIdx.y over the few envs a block holds. A block first stages each of
// its envs' K obstacle scalars in shared memory (nx, ny, q or r^2, key),
// computed once per env, then every thread loops over K for its rays.
// Ragged B and R are masked; rays beyond blockDim.x loop.
//
// Bound at the main-path shapes (B=4096, R=128, K=32, ~22 valid slots):
//   bytes: pose 12 + obs_xy 256 + obs_r 128 + mask 32 + boundary 128 bytes
//   per env in (2.28 MB), 512 bytes per env out (2.10 MB): 4.4 MB, ~1.3 us
//   at 3.35 TB/s.
//   operations: per ray-obstacle pair of the default path 14 f32 ops
//   (xk 3, delta 2, t 2, t*t 1, three compares, three selects); 16.8 M pairs
//   (11.5 M on valid slots) -> ~3.5 us (2.4 us valid-only) at 67 TFLOP/s.
//   So it is bound by operations, not bytes. chip_smoke.py computes the bound
//   from each run's inputs. A correct, simple kernel comes first; making it
//   fast (skipping masked slots, several envs per warp at small R) is later
//   work.
//
// Numerics: build WITHOUT --use_fast_math and with -fmad=false. FMA
// contraction would round `q + xk*xk` (and xk itself) differently from the
// plain PyTorch version, and near a tangency, where delta ~ 0, that one
// rounding moves sqrt(delta) far more than the 1e-4 tolerance. With
// contraction off every op rounds as the plain version's separate tensor ops
// do. sqrtf/cosf/sinf are the IEEE/full-precision library forms.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// -2*pi/3 rounded to float, as the TPU kernel's weak-typed constant is
constexpr float kFirstRay = -2.0943951023931953f;

template <bool FIRST_HIT, bool DEFER, bool FOLD, bool ANGLE_ADD>
__global__ void __launch_bounds__(kThreads) raycast_kernel(
    const float* __restrict__ pose,      // (B, 3) x, y, psi
    const float* __restrict__ obs_xy,    // (B, K, 2)
    const float* __restrict__ obs_r,     // (B, K)
    const uint8_t* __restrict__ mask,    // (B, K) 0/1
    const float* __restrict__ boundary,  // (B, K) ordering key (first hit)
    const float* __restrict__ ray_cs,    // (2, R) cos, sin (angle addition)
    float* __restrict__ out,             // (B, R)
    int B, int R, int K, float max_range, float resolution) {
  extern __shared__ float smem[];
  const int env = threadIdx.y;
  const long long b = (long long)blockIdx.x * blockDim.y + env;
  float* s_nx = smem + (size_t)env * 4 * K;
  float* s_ny = s_nx + K;
  float* s_q = s_ny + K;
  float* s_key = s_q + K;

  float x = 0.f, y = 0.f, psi = 0.f;
  if (b < B) {
    x = pose[b * 3 + 0];
    y = pose[b * 3 + 1];
    psi = pose[b * 3 + 2];
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const long long j = b * K + k;
      const float nx = obs_xy[2 * j] - x;
      const float ny = obs_xy[2 * j + 1] - y;
      const float r = obs_r[j];
      s_nx[k] = nx;
      s_ny[k] = ny;
      s_q[k] = FOLD ? r * r - (nx * nx + ny * ny) : r * r;
      if (FIRST_HIT) {
        s_key[k] = mask[j] ? boundary[j] : CUDART_INF_F;
      } else {
        s_key[k] = mask[j] ? 1.f : 0.f;
      }
    }
  }
  __syncthreads();
  if (b >= B) return;

  float cp = 0.f, sp = 0.f;
  if (ANGLE_ADD) {
    cp = cosf(psi);
    sp = sinf(psi);
  }
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    float c, s;
    if (ANGLE_ADD) {
      const float rc = ray_cs[i], rs = ray_cs[R + i];
      c = cp * rc - sp * rs;
      s = sp * rc + cp * rs;
    } else {
      const float a = (psi + kFirstRay) + (float)i * resolution;
      c = cosf(a);
      s = sinf(a);
    }

    float best_key = CUDART_INF_F;
    float best_dist = max_range;  // no-defer first hit and true min
    float best_xk = 0.f, best_delta = CUDART_INF_F;  // defer first hit
    for (int k = 0; k < K; ++k) {
      const float nx = s_nx[k], ny = s_ny[k];
      const float xk = c * nx + s * ny;
      float delta;
      if (FOLD) {
        delta = s_q[k] + xk * xk;
      } else {
        const float yk = s * nx - c * ny;
        delta = s_q[k] - yk * yk;
      }
      const float key = s_key[k];
      if (FIRST_HIT && DEFER) {
        const float t = fmaxf(xk - max_range, 0.f);
        const bool better = (xk >= 0.f) & (delta >= t * t) & (key < best_key);
        best_xk = better ? xk : best_xk;
        best_delta = better ? delta : best_delta;
        best_key = better ? key : best_key;
      } else if (FIRST_HIT) {
        const float dist = xk - sqrtf(delta);
        const bool better = (xk >= 0.f) & (dist < max_range) & (key < best_key);
        best_dist = better ? dist : best_dist;
        best_key = better ? key : best_key;
      } else {
        const float dist = xk - sqrtf(fmaxf(delta, 0.f));
        const bool valid = (xk >= 0.f) & (delta >= 0.f) & (key > 0.5f);
        best_dist = fminf(best_dist, valid ? dist : max_range);
      }
    }
    float result;
    if (FIRST_HIT && DEFER) {
      const float d = fminf(best_xk - sqrtf(best_delta), max_range);
      result = isfinite(best_key) ? d : max_range;
    } else if (FIRST_HIT) {
      result = isfinite(best_key) ? best_dist : max_range;
    } else {
      result = best_dist;
    }
    out[b * R + i] = result;
  }
}

template <bool FIRST_HIT, bool DEFER, bool FOLD, bool ANGLE_ADD>
void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
            const float* pose, const float* obs_xy, const float* obs_r,
            const uint8_t* mask, const float* boundary, const float* ray_cs,
            float* out, int B, int R, int K, float max_range, float resolution) {
  raycast_kernel<FIRST_HIT, DEFER, FOLD, ANGLE_ADD><<<grid, block, smem, stream>>>(
      pose, obs_xy, obs_r, mask, boundary, ray_cs, out, B, R, K, max_range,
      resolution);
}

template <bool FIRST_HIT, bool DEFER, bool FOLD>
void launch_angle(bool angle_add, dim3 grid, dim3 block, size_t smem,
                  cudaStream_t stream, const float* pose, const float* obs_xy,
                  const float* obs_r, const uint8_t* mask, const float* boundary,
                  const float* ray_cs, float* out, int B, int R, int K,
                  float max_range, float resolution) {
  if (angle_add)
    launch<FIRST_HIT, DEFER, FOLD, true>(grid, block, smem, stream, pose, obs_xy,
                                         obs_r, mask, boundary, ray_cs, out, B,
                                         R, K, max_range, resolution);
  else
    launch<FIRST_HIT, DEFER, FOLD, false>(grid, block, smem, stream, pose,
                                          obs_xy, obs_r, mask, boundary, ray_cs,
                                          out, B, R, K, max_range, resolution);
}

template <bool FIRST_HIT, bool DEFER>
void launch_fold(bool fold, bool angle_add, dim3 grid, dim3 block, size_t smem,
                 cudaStream_t stream, const float* pose, const float* obs_xy,
                 const float* obs_r, const uint8_t* mask, const float* boundary,
                 const float* ray_cs, float* out, int B, int R, int K,
                 float max_range, float resolution) {
  if (fold)
    launch_angle<FIRST_HIT, DEFER, true>(angle_add, grid, block, smem, stream,
                                         pose, obs_xy, obs_r, mask, boundary,
                                         ray_cs, out, B, R, K, max_range,
                                         resolution);
  else
    launch_angle<FIRST_HIT, DEFER, false>(angle_add, grid, block, smem, stream,
                                          pose, obs_xy, obs_r, mask, boundary,
                                          ray_cs, out, B, R, K, max_range,
                                          resolution);
}

}  // namespace

// Threads per block along rays and envs for a given R; the launcher in
// ops/raycast_cuda.py reads these to size shared memory.
extern "C" void usv_raycast_block_dims(int R, int* rays_per_block,
                                       int* envs_per_block) {
  int rx = ((R + 31) / 32) * 32;
  if (rx > kThreads) rx = kThreads;
  if (rx < 32) rx = 32;
  *rays_per_block = rx;
  *envs_per_block = kThreads / rx;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// Mode flags are 0/1; true min ignores defer_sqrt and takes no boundary.
extern "C" int usv_raycast_launch(
    const float* pose, const float* obs_xy, const float* obs_r,
    const uint8_t* mask, const float* boundary, const float* ray_cs, float* out,
    int B, int R, int K, float max_range, float resolution, int first_hit,
    int defer_sqrt, int fold_lateral, int angle_addition, void* stream_ptr) {
  int rx, ey;
  usv_raycast_block_dims(R, &rx, &ey);
  const dim3 block(rx, ey);
  const dim3 grid((B + ey - 1) / ey);
  const size_t smem = (size_t)ey * 4 * K * sizeof(float);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B > 0) {
    if (first_hit && defer_sqrt)
      launch_fold<true, true>(fold_lateral, angle_addition, grid, block, smem,
                              stream, pose, obs_xy, obs_r, mask, boundary,
                              ray_cs, out, B, R, K, max_range, resolution);
    else if (first_hit)
      launch_fold<true, false>(fold_lateral, angle_addition, grid, block, smem,
                               stream, pose, obs_xy, obs_r, mask, boundary,
                               ray_cs, out, B, R, K, max_range, resolution);
    else
      launch_fold<false, false>(fold_lateral, angle_addition, grid, block, smem,
                                stream, pose, obs_xy, obs_r, mask, boundary,
                                ray_cs, out, B, R, K, max_range, resolution);
  }
  return (int)cudaGetLastError();
}
