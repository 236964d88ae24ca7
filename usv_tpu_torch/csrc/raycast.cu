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
//   first hit : the obstacle with the least key (boundary distance) among
//               unmasked hits with xk >= 0 and distance < range; a strict <
//               keeps the earlier slot on an exact tie.
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
//   n_acc (1-4): accumulator a takes the slots whose index k has
//               k % n_acc == a, in ascending k, and the accumulators merge in
//               order with a strict < (first hit) or fminf (true min), as the
//               TPU kernel strides them. Only exact key ties can tell the
//               values of n_acc apart.
//
// What bounds it. At the main-path shapes (B=4096, R=128, K=32, 15-29 slots
// valid) the inputs are 556 bytes per env and the output 512: 4.4 MB, 1.3 us
// at 3.35 TB/s, and that is the bound: a ray can hit only the few obstacles
// whose disc covers its direction, and the 14 float32 operations of the
// default path (xk 3, delta 2, t 2, t*t 1, three compares, three selects) on
// those pairs alone, plus one look at each valid slot, take less than the
// bytes. Done on every valid ray-obstacle pair they would take ~2.4 us at
// the 67 TFLOP/s of the data sheet, and twice that in issue slots: the peak
// counts a fused multiply-add as two, and this kernel's operations are
// unfused on purpose (see Numerics), so each takes a whole slot, and the
// compares, selects and max run at half rate besides. So the work per pair
// is what to cut first. The scarce things are issue slots, shared-memory
// instructions and registers, and the design spends on those:
//   * Cone culling. A ray can hit only an obstacle whose direction lies
//     within asin(r/d) of its own. The rays that register j of an env's
//     lanes hold are neighbours, a cone about the heading, so the staging
//     pass gives each register its own list of the slots whose direction
//     lies within that cone's half width plus asin(r/d), with margins
//     several times float32's rounding. A culled pair is a miss in the plain version
//     too, so no output bit changes; at the main-path shapes a list keeps ~4
//     of ~22 valid slots. Lists are padded to one length with a slot that
//     can never win (key +inf, delta < 0), so the loop has no branch.
//   * Valid-slot compaction. A masked slot can never change a result, so the
//     staging pass drops it: a warp ballot and a popcount prefix write the
//     kept slots in ascending order, and the loop runs to the kept count
//     (uniform over the lanes of one env). Slot order among the kept ones is
//     unchanged, so ties and every output bit are.
//   * One 16-byte shared load per slot. A slot is one float4 (nx, ny, q, key);
//     all lanes of an env read the same address (a broadcast), and the rows of
//     the envs that share a warp start an odd number of float4s apart, so
//     their loads fall on distinct banks.
//   * Several rays per thread: four where the launch fills more than half the
//     card (issue-bound: four independent select chains, cones a quarter as
//     wide), one below that (latency-bound: more threads, shorter chains).
//   * Per-env work once. cosf/sinf of the heading (the full-precision library
//     forms) are computed in the staging pass and kept in the row's header
//     beside the loop count.
//   * Two loop-carried selects, not three. The deferred-sqrt path carries the
//     winner's key and its position in the list, and derives xk and delta of
//     the winner again after the loop with the same unfused expression.
//   * Lanes follow rays x envs. An env takes the least power of two of lanes
//     that covers its rays, so at R=16 two envs share a warp and no lane
//     idles. A warp stages exactly the envs it computes, so only a
//     __syncwarp separates staging from the loop (a block barrier only when
//     an env spans several warps). Rays are dealt to lanes with stride
//     `lanes`, so each store instruction of a warp writes neighbouring
//     addresses.
//   With n_acc > 1 the kept slots of class a = k % n_acc go to list positions
//   a, a + n_acc, ...; short classes are padded like short lists.
//
// What the card's other machinery is not for here: the product
// xk = c*nx + s*ny has depth 2, far too thin for wgmma, and TF32 would break
// the tangency bounds; with 556 input bytes per env and a 1.3 us bytes bound,
// TMA, cp.async rings and clusters have nothing to hide.
//
// Numerics: build WITHOUT --use_fast_math and with -fmad=false. FMA
// contraction would round `q + xk*xk` (and xk itself) differently from the
// plain PyTorch version, and near a tangency, where delta ~ 0, that one
// rounding moves sqrt(delta) far more than the 1e-4 tolerance. With
// contraction off every op rounds as the plain version's separate tensor ops
// do. sqrtf/cosf/sinf are the IEEE/full-precision library forms.
//
// PERF.md has the time each of these parts gave on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block, a power of two >= 32
// half the threads one H100 holds at once (132 SMs of 2048)
constexpr long long kLatencyBoundRays = 132LL * 2048 / 2;
// rays per thread of a launch too large for one ray per thread
constexpr int kManyRays = 4;
// warps an SM should hold at once: the main path's grid is 7.8 of its blocks
// an SM, so 64 registers a thread keep it to one wave (asked of the
// single-accumulator instances only; the others would spill)
constexpr int kResidentWarps = 32;
constexpr int kMaxAcc = 4;
constexpr int kUnroll = 2;  // of the loop over a list
// -2*pi/3 rounded to float, as the TPU kernel's weak-typed constant is
constexpr float kFirstRay = -2.0943951023931953f;
// Culling margins. A pair that float32 calls a hit has delta >= 0 up to the
// error of q + xk*xk. c and s are off by ~3e-7 and xk's own roundings add
// ~2e-7 d, so xk*xk is off by ~1e-6 d^2; q and the sum add ~3e-7 d^2. With
// delta = r^2 - (d sin)^2 off by 1.4e-6 d^2, the true sine of the angle
// between ray and obstacle is below sqrt((r/d)^2 + 1.4e-6) <= r/d + 1.2e-3.
// kSineMargin covers that three times over. The errors scale with d, the
// distance from boat to obstacle, not with the pose: nx and ny are single
// subtractions. kAngleMargin covers the rounding of the ray angles: 1e-6 rad
// with the table, an ulp of the heading without it, which is why a heading
// beyond kMaxCullHeading (ulp 6e-5 rad) culls nothing.
constexpr float kSineMargin = 4e-3f;
constexpr float kAngleMargin = 2e-3f;
constexpr float kMaxCullHeading = 1e3f;
// obstacles wider than 30 degrees as seen from the boat go to every group
constexpr float kMaxCullSine = 0.5f;

struct Slot {
  float nx, ny, q, key;
};

// A slot that changes no result: its key never wins a strict <, and its
// delta is negative whatever the ray (xk = 0, yk = 0).
__device__ __forceinline__ Slot dead_slot() {
  return {0.f, 0.f, -1.f, CUDART_INF_F};
}

__device__ __forceinline__ Slot load_slot(const float4* list, int idx) {
  const float4 v = list[idx];
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ void store_slot(float4* list, int idx, const Slot& o) {
  list[idx] = make_float4(o.nx, o.ny, o.q, o.key);
}

// One MUFU.RSQ: the cone test needs three digits, and a flushed denormal
// gives +inf, which keeps the slot.
__device__ __forceinline__ float rough_rsqrt(float v) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(v));
  return y;
}

template <bool FOLD>
__device__ __forceinline__ void geometry(float c, float s, const Slot& o,
                                         float& xk, float& delta) {
  xk = c * o.nx + s * o.ny;
  if (FOLD) {
    delta = o.q + xk * xk;
  } else {
    const float yk = s * o.nx - c * o.ny;
    delta = o.q - yk * yk;
  }
}

// The rays of group j (register j of every lane of an env) as a cone about
// the heading: cos and sin of its centre angle, cos and sin of its half
// width. Where the groups are not cones the test below can use, the third is
// -inf and no obstacle is outside.
struct Groups {
  float4 cone[kManyRays];
};

// How a launch lays rays, envs and shared memory out; see the note above.
struct Plan {
  int rays;            // rays per thread
  int log2_lanes;      // lanes per env = 1 << log2_lanes, at most kThreads
  int log2_seg;        // staging lanes per env = 1 << log2_seg, at most 32
  int cap;             // slots a list holds
  int stride;          // float4s per env row (a header and the lists), odd
  int envs_per_block;
  size_t smem;
  Groups groups;
};

Plan make_plan(int B, int R, int K, float resolution) {
  Plan p;
  // Where a thread for every ray fills no more than half the card, the launch
  // is bound by the latency of one thread's chain, and more threads make it
  // shorter; above that it is bound by issue, and four rays a thread share
  // each pass of the loop and get cones a quarter as wide.
  p.rays = (long long)B * R > kLatencyBoundRays ? kManyRays : 1;
  const int per_lane = (R + p.rays - 1) / p.rays;
  p.log2_lanes = 0;
  while ((1 << p.log2_lanes) < per_lane && (1 << p.log2_lanes) < kThreads)
    ++p.log2_lanes;
  p.log2_seg = 0;
  while ((1 << p.log2_seg) < K && p.log2_seg < 5) ++p.log2_seg;
  p.cap = K + kMaxAcc - 1;  // K slots and the padding of short n_acc classes
  p.stride = (1 + p.rays * p.cap) | 1;
  p.envs_per_block = kThreads >> p.log2_lanes;
  p.smem = (size_t)p.envs_per_block * p.stride * sizeof(float4);

  // group j holds rays j * lanes ... (j + 1) * lanes - 1, cut at R - 1 (a ray
  // beyond R repeats the last). Rays that take several passes over the lanes
  // (R > lanes * rays) are in no one cone, and a cone too wide for the test's
  // monotone range is none either.
  const int lanes = 1 << p.log2_lanes;
  bool cones = R <= lanes * p.rays;
  for (int j = 0; j < p.rays; ++j) {
    const int lo = min(j * lanes, R - 1), hi = min((j + 1) * lanes - 1, R - 1);
    const double centre = (double)kFirstRay + 0.5 * (lo + hi) * (double)resolution;
    const double half = 0.5 * (hi - lo) * fabs((double)resolution) + kAngleMargin;
    if (half + asin((double)kMaxCullSine + kSineMargin) > 3.0) cones = false;
    p.groups.cone[j] = make_float4((float)cos(centre), (float)sin(centre),
                                   (float)cos(half), (float)sin(half));
  }
  if (!cones)
    for (int j = 0; j < p.rays; ++j) p.groups.cone[j] = make_float4(1.f, 0.f, -INFINITY, 0.f);
  return p;
}

template <bool FIRST_HIT, bool DEFER, bool FOLD, bool ANGLE_ADD, int NACC, int RAYS>
__global__ void __launch_bounds__(kThreads, NACC == 1 ? kResidentWarps * 32 / kThreads : 1)
raycast_kernel(
    const float* __restrict__ pose,      // (B, 3) x, y, psi
    const float* __restrict__ obs_xy,    // (B, K, 2)
    const float* __restrict__ obs_r,     // (B, K)
    const uint8_t* __restrict__ mask,    // (B, K) 0/1
    const float* __restrict__ boundary,  // (B, K) ordering key (first hit)
    const float* __restrict__ ray_cs,    // (2, R) cos, sin (angle addition)
    float* __restrict__ out,             // (B, R)
    int B, int R, int K, float max_range, float resolution, int log2_lanes,
    int log2_seg, int cap, int stride, const Groups groups) {
  extern __shared__ float4 smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int lanes = 1 << log2_lanes;
  // (the launcher keeps every index below 2^31)
  const int block_env0 = blockIdx.x * (kThreads >> log2_lanes);

  // lane g of an env takes rays g, g + lanes, ...; their table entries are
  // asked for before the staging pass, whose loads they do not depend on
  const int env = tid >> log2_lanes;
  const int g = tid & (lanes - 1);
  const int b = block_env0 + env;
  float rc[RAYS], rs[RAYS];
  auto load_table = [&](int base) {
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      const int i = min(base + j * lanes, R - 1);  // a ray beyond R repeats the last
      rc[j] = ray_cs[i];
      rs[j] = ray_cs[R + i];
    }
  };
  if (ANGLE_ADD && b < B) load_table(g);

  // --- staging: each warp stages the envs it computes (the first warp of an
  // env that spans several), 32 >> log2_seg envs at a time
  const int warp_env0 = (tid & ~31) >> log2_lanes;
  const int warp_envs = lanes >= 32 ? 1 : 32 >> log2_lanes;
  if (lanes <= 32 || ((tid & ~31) & (lanes - 1)) == 0) {
    const int seg = 1 << log2_seg;
    const int seg_lane = lane & (seg - 1);
    const int seg_id = lane >> log2_seg;
    const unsigned seg_bits = seg == 32 ? 0xffffffffu : (1u << seg) - 1u;
    const unsigned below = (1u << seg_lane) - 1u;
    for (int e0 = 0; e0 < warp_envs; e0 += 32 >> log2_seg) {
      const int e = e0 + seg_id;
      const int be = block_env0 + warp_env0 + e;
      const bool env_ok = e < warp_envs && be < B;
      float4* row = smem + (size_t)(warp_env0 + e) * stride;
      float x = 0.f, y = 0.f, psi = 0.f;
      if (env_ok) {
        x = pose[be * 3 + 0];
        y = pose[be * 3 + 1];
        psi = pose[be * 3 + 2];
      }
      const float cp = cosf(psi), sp = sinf(psi);
      // the groups' centre directions in the world frame
      float ux[RAYS], uy[RAYS];
#pragma unroll
      for (int l = 0; l < RAYS; ++l) {
        ux[l] = cp * groups.cone[l].x - sp * groups.cone[l].y;
        uy[l] = sp * groups.cone[l].x + cp * groups.cone[l].y;
      }
      int count[RAYS][NACC];
#pragma unroll
      for (int l = 0; l < RAYS; ++l) {
#pragma unroll
        for (int a = 0; a < NACC; ++a) count[l][a] = 0;
      }
      for (int k0 = 0; k0 < K; k0 += seg) {
        const int k = k0 + seg_lane;
        const int cls = k % NACC;
        bool keep = false;
        Slot o = dead_slot();
        float r = 0.f;
        if (env_ok && k < K) {
          const int j = be * K + k;
          const bool valid = mask[j] != 0;
          const float2 centre = reinterpret_cast<const float2*>(obs_xy)[j];
          r = obs_r[j];
          const float nx = centre.x - x, ny = centre.y - y;
          if (valid)
            o = {nx, ny, FOLD ? r * r - (nx * nx + ny * ny) : r * r,
                 FIRST_HIT ? boundary[j] : 0.f};
          keep = valid;
        }
        // The cone test: a ray can hit only an obstacle whose direction is
        // within asin(r/d) of the ray's; a group of rays only one within its
        // half width plus that. cos is monotone on [0, pi], so the angle test
        // is one of cosines. Every doubt (a wide or near obstacle, NaN) keeps
        // the slot.
        // (the margins dwarf the error of the fast reciprocal square root)
        const float per_reach = rough_rsqrt(o.nx * o.nx + o.ny * o.ny);
        const float sine = fabsf(r) * per_reach + kSineMargin;
        const bool narrow = sine < kMaxCullSine && fabsf(psi) < kMaxCullHeading;
        const float cos2 = 1.f - sine * sine;
        const float cosine = cos2 * rough_rsqrt(cos2);
#pragma unroll
        for (int l = 0; l < RAYS; ++l) {
          const bool outside = (o.nx * ux[l] + o.ny * uy[l]) * per_reach <
                               groups.cone[l].z * cosine - groups.cone[l].w * sine;
          const bool mine = keep && !(narrow && outside);
          int pos = 0;
#pragma unroll
          for (int a = 0; a < NACC; ++a) {
            const unsigned kept =
                (__ballot_sync(0xffffffffu, mine && cls == a) >> (seg_id << log2_seg)) &
                seg_bits;
            if (cls == a) pos = count[l][a] + __popc(kept & below);
            count[l][a] += __popc(kept);
          }
          if (mine) store_slot(row + 1 + l * cap, pos * NACC + cls, o);
        }
      }
      int loops = 0;
#pragma unroll
      for (int l = 0; l < RAYS; ++l) {
#pragma unroll
        for (int a = 0; a < NACC; ++a) loops = max(loops, count[l][a]);
      }
      if ((RAYS > 1 || NACC > 1) && env_ok) {
        // pad every list's classes up to the common loop count
#pragma unroll
        for (int l = 0; l < RAYS; ++l) {
          for (int j = seg_lane; j < loops * NACC; j += seg) {
            const int a = j % NACC;
            int kept = count[l][0];
#pragma unroll
            for (int a2 = 1; a2 < NACC; ++a2) kept = a == a2 ? count[l][a2] : kept;
            if (j / NACC >= kept) store_slot(row + 1 + l * cap, j, dead_slot());
          }
        }
      }
      if (env_ok && seg_lane == 0)
        row[0] = make_float4(cp, sp, psi, __int_as_float(loops));
    }
  }
  if (lanes > 32) {
    __syncthreads();
  } else {
    __syncwarp();
  }

  // --- the rays
  if (b >= B) return;
  const float4* row = smem + (size_t)env * stride;
  const float4 head = row[0];
  const float cp = head.x, sp = head.y, psi = head.z;
  const int loops = __float_as_int(head.w);

  for (int base = g; base < R; base += lanes * RAYS) {
    if (ANGLE_ADD && base != g) load_table(base);
    float c[RAYS], s[RAYS];
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      if (ANGLE_ADD) {
        c[j] = cp * rc[j] - sp * rs[j];
        s[j] = sp * rc[j] + cp * rs[j];
      } else {
        const int i = min(base + j * lanes, R - 1);
        const float a = (psi + kFirstRay) + (float)i * resolution;
        c[j] = cosf(a);
        s[j] = sinf(a);
      }
    }

    float best_key[RAYS][NACC];
    float best_dist[RAYS][NACC];   // no-defer first hit and true min
    int best_idx[RAYS][NACC];      // defer first hit: the winner's list position
#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        best_key[j][a] = CUDART_INF_F;
        best_dist[j][a] = max_range;
        best_idx[j][a] = 0;
      }
    }

#pragma unroll kUnroll
    for (int it = 0; it < loops; ++it) {
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        const int idx = it * NACC + a;
#pragma unroll
        for (int j = 0; j < RAYS; ++j) {
          const Slot o = load_slot(row + 1 + j * cap, idx);
          float xk, delta;
          geometry<FOLD>(c[j], s[j], o, xk, delta);
          if (FIRST_HIT && DEFER) {
            const float t = fmaxf(xk - max_range, 0.f);
            const bool better =
                (xk >= 0.f) & (delta >= t * t) & (o.key < best_key[j][a]);
            best_idx[j][a] = better ? idx : best_idx[j][a];
            best_key[j][a] = better ? o.key : best_key[j][a];
          } else if (FIRST_HIT) {
            const float dist = xk - sqrtf(delta);
            const bool better =
                (xk >= 0.f) & (dist < max_range) & (o.key < best_key[j][a]);
            best_dist[j][a] = better ? dist : best_dist[j][a];
            best_key[j][a] = better ? o.key : best_key[j][a];
          } else {
            const float dist = xk - sqrtf(fmaxf(delta, 0.f));
            const bool valid = (xk >= 0.f) & (delta >= 0.f);
            best_dist[j][a] = fminf(best_dist[j][a], valid ? dist : max_range);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < RAYS; ++j) {
      // merge the accumulators in order; the earlier one keeps a tie
#pragma unroll
      for (int a = 1; a < NACC; ++a) {
        if (FIRST_HIT) {
          const bool take = best_key[j][a] < best_key[j][0];
          best_key[j][0] = take ? best_key[j][a] : best_key[j][0];
          best_dist[j][0] = take ? best_dist[j][a] : best_dist[j][0];
          best_idx[j][0] = take ? best_idx[j][a] : best_idx[j][0];
        } else {
          best_dist[j][0] = fminf(best_dist[j][0], best_dist[j][a]);
        }
      }
      float result;
      if (FIRST_HIT && DEFER) {
        // no winner: the list's first slot may be stale, and is not used
        float xk, delta;
        geometry<FOLD>(c[j], s[j], load_slot(row + 1 + j * cap, best_idx[j][0]), xk, delta);
        const float d = fminf(xk - sqrtf(delta), max_range);
        result = isfinite(best_key[j][0]) ? d : max_range;
      } else if (FIRST_HIT) {
        result = isfinite(best_key[j][0]) ? best_dist[j][0] : max_range;
      } else {
        result = best_dist[j][0];
      }
      const int i = base + j * lanes;
      if (i < R) out[b * R + i] = result;
    }
  }
}

struct Args {
  const float *pose, *obs_xy, *obs_r;
  const uint8_t* mask;
  const float *boundary, *ray_cs;
  float* out;
  int B, R, K;
  float max_range, resolution;
  cudaStream_t stream;
};

template <bool FIRST_HIT, bool DEFER, bool FOLD, bool ANGLE_ADD, int NACC>
void launch(const Args& a) {
  const Plan p = make_plan(a.B, a.R, a.K, a.resolution);
  const int grid = (a.B + p.envs_per_block - 1) / p.envs_per_block;
  auto kernel = p.rays == 1 ? raycast_kernel<FIRST_HIT, DEFER, FOLD, ANGLE_ADD, NACC, 1>
                            : raycast_kernel<FIRST_HIT, DEFER, FOLD, ANGLE_ADD, NACC, kManyRays>;
  kernel<<<grid, kThreads, p.smem, a.stream>>>(
      a.pose, a.obs_xy, a.obs_r, a.mask, a.boundary, a.ray_cs, a.out, a.B, a.R,
      a.K, a.max_range, a.resolution, p.log2_lanes, p.log2_seg, p.cap, p.stride,
      p.groups);
}

template <bool FIRST_HIT, bool DEFER, bool FOLD, bool ANGLE_ADD>
void launch_acc(int n_acc, const Args& a) {
  switch (n_acc) {
    case 1: return launch<FIRST_HIT, DEFER, FOLD, ANGLE_ADD, 1>(a);
    case 2: return launch<FIRST_HIT, DEFER, FOLD, ANGLE_ADD, 2>(a);
    case 3: return launch<FIRST_HIT, DEFER, FOLD, ANGLE_ADD, 3>(a);
    default: return launch<FIRST_HIT, DEFER, FOLD, ANGLE_ADD, 4>(a);
  }
}

template <bool FIRST_HIT, bool DEFER>
void launch_mode(bool fold, bool angle_add, int n_acc, const Args& a) {
  if (fold && angle_add) return launch_acc<FIRST_HIT, DEFER, true, true>(n_acc, a);
  if (fold) return launch_acc<FIRST_HIT, DEFER, true, false>(n_acc, a);
  if (angle_add) return launch_acc<FIRST_HIT, DEFER, false, true>(n_acc, a);
  return launch_acc<FIRST_HIT, DEFER, false, false>(n_acc, a);
}

// Does nothing: what a launch of this grid costs before any of its work. The
// port's paths never launch it; the smoke script times it beside the kernel.
__global__ void empty_kernel() {}

}  // namespace

// Launches the empty kernel with the grid, block and dynamic shared memory a
// ray-cast launch of these shapes takes; returns cudaGetLastError().
extern "C" int usv_raycast_launch_empty(int B, int R, int K, float resolution,
                                        void* stream_ptr) {
  if (B > 0 && R > 0) {
    const Plan p = make_plan(B, R, K, resolution);
    const int grid = (B + p.envs_per_block - 1) / p.envs_per_block;
    empty_kernel<<<grid, kThreads, p.smem, static_cast<cudaStream_t>(stream_ptr)>>>();
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a launch at these shapes; the launcher in
// ops/raycast_cuda.py holds it against the 48 KB a block gets without opt-in.
extern "C" long long usv_raycast_smem_bytes(int B, int R, int K) {
  return (long long)make_plan(B, R, K, 0.f).smem;
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// Mode flags are 0/1; true min ignores defer_sqrt and takes no boundary;
// n_acc is 1 to 4.
extern "C" int usv_raycast_launch(
    const float* pose, const float* obs_xy, const float* obs_r,
    const uint8_t* mask, const float* boundary, const float* ray_cs, float* out,
    int B, int R, int K, float max_range, float resolution, int first_hit,
    int defer_sqrt, int fold_lateral, int angle_addition, int n_acc,
    void* stream_ptr) {
  if (n_acc < 1 || n_acc > kMaxAcc) return (int)cudaErrorInvalidValue;
  const Args a = {pose, obs_xy, obs_r, mask, boundary, ray_cs, out, B, R, K,
                  max_range, resolution, static_cast<cudaStream_t>(stream_ptr)};
  if (B > 0 && R > 0) {
    if (first_hit && defer_sqrt)
      launch_mode<true, true>(fold_lateral, angle_addition, n_acc, a);
    else if (first_hit)
      launch_mode<true, false>(fold_lateral, angle_addition, n_acc, a);
    else
      launch_mode<false, false>(fold_lateral, angle_addition, n_acc, a);
  }
  return (int)cudaGetLastError();
}
