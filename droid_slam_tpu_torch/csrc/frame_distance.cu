// Flow-magnitude frame distance of a list of frame pairs for Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX computes the distance in XLA
// (droid_slam_tpu/geom/distance.py, in chunks of pairs in
// droid_slam_tpu/state/video.py:225-250), which the port first ran as the
// same chain of plain PyTorch ops, geom/distance.py::frame_distance, over
// chunks of 32768 pairs: per chunk and direction the rays, the relative
// poses, the SE3 action broadcast over [pairs, h, w, 4], two flow
// magnitudes, the translation-only warp and four sums, ~364 launches a chunk
// and some 600 bytes of device memory a pixel and direction. Over the 512^2
// pairs of a global-BA proposal at 30x40 that took ~0.28 s of device time,
// about 28% of a pass of the global BA. The function stays as this kernel's
// plain twin.
//
// Semantics. For pair k (i = ii[k], j = jj[k]) and the direction i -> j,
// with G = poses[j] * poses[i]^-1 = (t, q) and each pixel (u, v) of frame i
// at disparity d = disps[i, v, u], X0 = ((u - cx) / fx, (v - cy) / fy, 1):
//   full warp         X1 = R(q) X0 + d t
//   translation only  X1 = X0 + d t
// each gives the flow |(fx X1.x / z + cx - u, fy X1.y / z + cy - v)| (z := 1
// where X1.z <= 0) and valid = X1.z > MIN_DEPTH_BA. With S the sums over
// the pixels of flow * valid and n those of valid,
//   a = beta S_full + (1 - beta) S_trans,
//   m = beta n_full + (1 - beta) n_trans,
//   d_ij = 1000 if m / (h w) < 0.75, else a / (m if m > 0 else 1);
// out[k] = 0.5 (d_ij + d_ji), or d_ij alone when not bidirectional. Every
// operation is the twin's, in the twin's order, each rounded once: the
// __f*_rn intrinsics keep nvcc from fusing a product into an add, and the
// divisions and square roots are IEEE (no fast math). The counts are
// integers, combined as the twin combines its exact f32 sums of 0/1, so the
// 1000 branch and the m > 0 guard read the twin's values. Only the order of
// the sums of flows differs from the twin's.
//
// Bound. Per pixel and direction ~72 operations (the quaternion rotation 30,
// the translation twice 9, two projections with two divisions each, two
// square roots, the sums), counting a division or a square root as one: at
// 30x40 over 512^2 pairs, both directions, 45 GFLOP, 0.68 ms at the H100's
// 67 TFLOP/s outside the tensor cores. Its bytes (the disparities of the
// frames, 2.4 MB at t=512, the poses, the pairs and one float a pair out)
// stay in L2, ~8 MB once from device memory: so it is bound by operations,
// and an IEEE division or square root costs several instructions (a MUFU
// approximation, its Newton steps and a range check).
//
// Design. One warp computes one pair: every lane computes both relative
// poses (G_ij, G_ji) in registers, then the lanes stride over the h*w
// pixels, each pixel's ray from its index and the intrinsics (no grid
// tensor), both directions in the same iteration (independent chains), the
// disparities of frames i and j read straight from the video (coalesced).
// Each lane sums its flows in f32 and counts its valid pixels as integers;
// shuffles combine the lanes, and lane 0 stores the pair's one float. No
// intermediate touches device memory; one launch covers every pair.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float MIN_DEPTH_BA = 0.25f;  // geom/projective.py
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// one rounding each, never fused
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}

struct V3 {
  float x, y, z;
};

struct Pose {
  V3 t;
  float qx, qy, qz, qw;
};

__device__ __forceinline__ V3 v_add(V3 a, V3 b) {
  return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)};
}

__device__ __forceinline__ V3 v_scale(float s, V3 a) {
  return {mul(s, a.x), mul(s, a.y), mul(s, a.z)};
}

// torch.linalg.cross
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}

// lie/se3.py::quat_rotate: v + w (2 qv x v) + qv x (2 qv x v)
__device__ __forceinline__ V3 rotate(const Pose& g, V3 v) {
  const V3 qv = {g.qx, g.qy, g.qz};
  const V3 uv = v_scale(2.0f, cross(qv, v));
  return v_add(v_add(v, v_scale(g.qw, uv)), cross(qv, uv));
}

// lie/se3.py::relative(gi, gj) = mul(gj, inv(gi))
__device__ __forceinline__ Pose relative(const Pose& gi, const Pose& gj) {
  Pose inv;
  inv.qx = -gi.qx;
  inv.qy = -gi.qy;
  inv.qz = -gi.qz;
  inv.qw = gi.qw;
  const V3 r = rotate(inv, gi.t);
  inv.t = {-r.x, -r.y, -r.z};
  Pose g;
  g.t = v_add(rotate(gj, inv.t), gj.t);
  const float x1 = gj.qx, y1 = gj.qy, z1 = gj.qz, w1 = gj.qw;
  const float x2 = inv.qx, y2 = inv.qy, z2 = inv.qz, w2 = inv.qw;
  g.qx = sub(add(add(mul(w1, x2), mul(x1, w2)), mul(y1, z2)), mul(z1, y2));
  g.qy = sub(add(add(mul(w1, y2), mul(y1, w2)), mul(z1, x2)), mul(x1, z2));
  g.qz = sub(add(add(mul(w1, z2), mul(z1, w2)), mul(x1, y2)), mul(y1, x2));
  g.qw = sub(sub(sub(mul(w1, w2), mul(x1, x2)), mul(y1, y2)), mul(z1, z2));
  return g;
}

__device__ __forceinline__ Pose load_pose(const float* poses, long long row) {
  const float* p = poses + row * 7;
  Pose g;
  g.t = {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
  g.qx = __ldg(p + 3);
  g.qy = __ldg(p + 4);
  g.qz = __ldg(p + 5);
  g.qw = __ldg(p + 6);
  return g;
}

struct Intr {
  float fx, fy, cx, cy;
};

// geom/distance.py's flow_mag: adds flow * valid to s and valid to n
__device__ __forceinline__ void flow(const Intr& k, V3 X, float u, float v,
                                     float& s, int& n) {
  const float zsafe = X.z <= 0.0f ? 1.0f : X.z;
  const float du = sub(add(mul(k.fx, dvd(X.x, zsafe)), k.cx), u);
  const float dv = sub(add(mul(k.fy, dvd(X.y, zsafe)), k.cy), v);
  const bool ok = X.z > MIN_DEPTH_BA;
  // times 0.0f, not a branch: an infinite flow of an invalid pixel gives
  // NaN, as in the twin
  s = add(s, mul(__fsqrt_rn(add(mul(du, du), mul(dv, dv))), ok ? 1.0f : 0.0f));
  n += ok ? 1 : 0;
}

// one direction of one pixel: the full warp's and the translation's terms
__device__ __forceinline__ void pixel(const Intr& k, const Pose& g, V3 X0,
                                      float d, float u, float v, float (&s)[2],
                                      int (&n)[2]) {
  const V3 dt = v_scale(d, g.t);
  flow(k, v_add(rotate(g, X0), dt), u, v, s[0], n[0]);
  flow(k, v_add(X0, dt), u, v, s[1], n[1]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the twin's combination of one direction's sums
__device__ __forceinline__ float directed(const float (&s)[2],
                                          const int (&n)[2], float beta,
                                          float omb, float hw) {
  const float a = add(mul(beta, warp_sum(s[0])), mul(omb, warp_sum(s[1])));
  const float m =
      add(mul(beta, (float)__reduce_add_sync(0xffffffffu, n[0])),
          mul(omb, (float)__reduce_add_sync(0xffffffffu, n[1])));
  const float frac = dvd(m, hw);
  const float d = dvd(a, m > 0.0f ? m : 1.0f);
  return frac < 0.75f ? 1000.0f : d;
}

struct DistArgs {
  const float* poses;       // [N, 7]
  const float* disps;       // [N, h, w]
  const float* intrinsics;  // [4]: fx, fy, cx, cy
  const void* ii;           // [E] int32 or int64
  const void* jj;
  float* out;               // [E]
  int N, h, w, E;
  float beta, omb, hw;      // beta, 1 - beta, h*w + 1e-8 (in f32)
};

template <typename Row, bool BIDIR>
__global__ void __launch_bounds__(NTHREADS) frame_distance_kernel(DistArgs a) {
  const int lane = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * NWARPS + (threadIdx.x >> 5);
  if (k >= a.E) return;  // uniform across the warp
  const long long i = static_cast<const Row*>(a.ii)[k];
  const long long j = static_cast<const Row*>(a.jj)[k];
  if (i < 0 || i >= a.N || j < 0 || j >= a.N) {  // no such frame
    if (lane == 0) a.out[k] = __int_as_float(0x7fc00000);  // NaN
    return;
  }
  const Intr K = {__ldg(a.intrinsics), __ldg(a.intrinsics + 1),
                  __ldg(a.intrinsics + 2), __ldg(a.intrinsics + 3)};
  const Pose gi = load_pose(a.poses, i);
  const Pose gj = load_pose(a.poses, j);
  const Pose gij = relative(gi, gj);
  const Pose gji = BIDIR ? relative(gj, gi) : gij;
  const int HW = a.h * a.w;
  const float* di = a.disps + i * HW;
  const float* dj = a.disps + j * HW;

  float s_ij[2] = {0.0f, 0.0f}, s_ji[2] = {0.0f, 0.0f};
  int n_ij[2] = {0, 0}, n_ji[2] = {0, 0};
  int x = lane % a.w, y = lane / a.w;
  for (int p = lane; p < HW; p += 32) {
    const float u = (float)x, v = (float)y;
    const V3 X0 = {dvd(sub(u, K.cx), K.fx), dvd(sub(v, K.cy), K.fy), 1.0f};
    pixel(K, gij, X0, __ldg(di + p), u, v, s_ij, n_ij);
    if (BIDIR) pixel(K, gji, X0, __ldg(dj + p), u, v, s_ji, n_ji);
    for (x += 32; x >= a.w; x -= a.w) ++y;
  }
  float d = directed(s_ij, n_ij, a.beta, a.omb, a.hw);
  if (BIDIR) d = mul(0.5f, add(d, directed(s_ji, n_ji, a.beta, a.omb, a.hw)));
  if (lane == 0) a.out[k] = d;
}

template <typename Row>
void launch(const DistArgs& a, bool bidirectional, cudaStream_t st) {
  const dim3 grid((unsigned)((a.E + NWARPS - 1) / NWARPS));
  if (bidirectional) {
    frame_distance_kernel<Row, true><<<grid, NTHREADS, 0, st>>>(a);
  } else {
    frame_distance_kernel<Row, false><<<grid, NTHREADS, 0, st>>>(a);
  }
}

}  // namespace

// Launches the frame distance of E pairs on `stream`.
//   poses:      [N, 7] f32 contiguous (world-to-camera, [t, q])
//   disps:      [N, h, w] f32 contiguous
//   intrinsics: [4] f32 (fx, fy, cx, cy) on the device
//   ii, jj:     [E] frame rows, int64 if rows_are_64 else int32; a pair with
//               a row outside [0, N) reads NaN
//   out:        [E] f32
// beta and one_minus_beta are the blend's weights as the twin rounds them
// to f32. Returns the cudaError_t of the launch (0 on success).
extern "C" int droid_frame_distance(const float* poses, const float* disps,
                                    const float* intrinsics, int N, int h,
                                    int w, const void* ii, const void* jj,
                                    int rows_are_64, int E, float beta,
                                    float one_minus_beta, int bidirectional,
                                    float* out, void* stream) {
  // h*w below 2^24: every count and h*w are exact in f32
  if (E <= 0 || N < 0 || h <= 0 || w <= 0 ||
      (long long)h * w >= (1LL << 24) ||
      (E + (long long)NWARPS - 1) / NWARPS > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  DistArgs a;
  a.poses = poses;
  a.disps = disps;
  a.intrinsics = intrinsics;
  a.ii = ii;
  a.jj = jj;
  a.out = out;
  a.N = N;
  a.h = h;
  a.w = w;
  a.E = E;
  a.beta = beta;
  a.omb = one_minus_beta;
  a.hw = (float)((double)h * w + 1e-8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows_are_64) {
    launch<int64_t>(a, bidirectional != 0, st);
  } else {
    launch<int32_t>(a, bidirectional != 0, st);
  }
  return (int)cudaGetLastError();
}
