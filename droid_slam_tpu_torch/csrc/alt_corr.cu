// On-the-fly ("alt") correlation of the global BA for Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX's global BA correlates on the fly in XLA
// (droid_slam_tpu/ops/corr.py::alt_lookup), which the port first ran as
// plain PyTorch, ops/corr.py::alt_lookup: per level and grid row a gather of
// an [E,HW,8,128] bf16 tensor, its f32 copy and a gemv against one vector
// per pixel, ~600 launches a sweep chunk and 82% of the device time of the
// global BA. That function stays as this kernel's plain twin. Semantics:
// altcorr_kernel.cu of the CUDA reference. For each edge e (source row
// ii[e], target row jj[e] of a channels-last bf16 feature pyramid
// [N, h_l, w_l, 128]), pixel p and level l, at c = coords[e,p] / 2^l:
//  1. the (2r+2)^2 = 64 integer grid points (floor(c) - r + (i, j)),
//  2. at each, the dot product of the 128 level-0 source channels of p with
//     the 128 target channels there, bf16 x bf16 products (exact in f32)
//     summed in f32, divided by 16; zero where the point is off the map,
//  3. blended bilinearly to (2r+1)^2 = 49 taps, written x-offset-major into
//     out[e, p, l*49 : (l+1)*49] (level-major).
// Only the order of each 128-term sum differs from the twin's.
//
// Bound. A chunk of the tum cell (E = 127 edges, HW = 1200 pixels of 30x40,
// 4 levels) is 2*E*HW*4*64*128 = 10.0 GFLOP: 0.15 ms of f32 FMA at the
// H100's 67 TFLOP/s on CUDA cores. Its bytes, each read once, are the f32
// output (120 MB), the source and target frames' maps and the coordinates:
// ~0.14 GB, 0.04 ms at 3.35 TB/s. So it is bound by operations, and each
// product costs an FMA plus the integer op that widens its bf16 target to
// f32. The grid points' reads, 64 rows of 256 bytes per pixel and level,
// are 10 GB a chunk from L1: they must hit there, not in device memory.
// Measured on the H100 (700 W): 0.76 ms a chunk, against the twin's 54 ms;
// 1 to 4 blocks an SM and 2 to 8 pixels a warp read 0.77-1.03 ms, so the
// issue slots and L1, not latency, hold it there.
//
// Design. One warp computes one pixel's 256 dot products at all levels:
//  * the pixel's 128 source channels stay in registers as f32 across its
//    256 grid points: lane (s, k), s = lane / 8, k = lane % 8, holds the
//    16-byte chunks k and k + 8 (16 channels);
//  * each load instruction reads four grid points' 128-byte halves (eight
//    lanes, 16 bytes each, of one 256-byte row): four whole L1 lines, at
//    offsets fixed at compile time from the grid row's first point;
//  * group s takes grid rows 2s and 2s+1 of a level, one at a time: a lane
//    sums 16 channels of the row's 8 points, 8 independent FMA chains; a
//    recursive-halving reduce-scatter over the group's 8 lanes (7 shuffles)
//    leaves lane k the finished dot product of column k, which goes to
//    shared memory ([level][y][x], 1 KB a warp);
//  * the lanes then blend the 49 taps of each level and store the pixel's
//    contiguous 4*49-float output row with coalesced writes;
//  * a block's 8 warps take 8 neighbouring pixels at a time, PPW times over:
//    their warped windows overlap, so the target rows they read hit L1/L2.
// No intermediate touches device memory; one launch covers every level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 3;
constexpr int D = 2 * R + 2;    // 8 grid points per axis
constexpr int RD = 2 * R + 1;   // 7 taps per axis
constexpr int NT = RD * RD;     // 49 taps per level
constexpr int C = 128;          // feature channels
constexpr int MAX_LEVELS = 4;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PPW = 4;                 // pixels per warp
constexpr int PB = NWARPS * PPW;       // pixels per block

struct AltArgs {
  const __nv_bfloat16* fmap[MAX_LEVELS];  // [N, h[l], w[l], C]
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int levels;
  int N;                 // rows of the pyramid
  int HW;                // pixels of level 0 (h[0] * w[0])
  int blocks_per_edge;
  const float* coords;   // [E, HW, 2]
  const void* ii;        // [E] int32 or int64
  const void* jj;
  float* out;            // [E, HW, levels * NT]
};

// a[l] without indexing the kernel's parameters dynamically (which would
// copy them to local memory)
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[MAX_LEVELS], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// The 8 bf16 of a 16-byte chunk as f32 (exact: a bf16 is the top half of
// its f32).
__device__ __forceinline__ void widen(const uint4 v, float f[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// acc + sum_i a[i] * b[i] over one chunk, in order; each product is exact
__device__ __forceinline__ float dot8(const float a[8], const uint4 v,
                                      float acc) {
  float b[8];
  widen(v, b);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc = fmaf(a[i], b[i], acc);
  return acc;
}

// One step of the reduce-scatter over the 8 lanes of a group: of the 2*NH
// partial sums, the lane keeps the half its bit O selects, adds the
// partner's partial sums of that half, and hands over the other half.
template <int O, int NH>
__device__ __forceinline__ void halve(float (&acc)[D], int k) {
  const bool upper = (k & O) != 0;
#pragma unroll
  for (int q = 0; q < NH; ++q) {
    const float send = upper ? acc[q] : acc[q + NH];
    const float keep = upper ? acc[q + NH] : acc[q];
    acc[q] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <typename Row>
__global__ void __launch_bounds__(NTHREADS, 2) alt_corr_kernel(AltArgs a) {
  __shared__ float grid_dots[NWARPS][MAX_LEVELS * D * D];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = lane >> 3;  // group: grid rows 2s, 2s+1
  const int k = lane & 7;   // 16-byte chunks k and k + 8 of every row
  const int e = blockIdx.x / a.blocks_per_edge;
  const int p0 = (blockIdx.x - e * a.blocks_per_edge) * PB;
  const long long src = static_cast<const Row*>(a.ii)[e];
  const long long dst = static_cast<const Row*>(a.jj)[e];
  // a row outside the pyramid reads zeros
  const bool rows_ok = src >= 0 && src < a.N && dst >= 0 && dst < a.N;
  const int L = a.levels;
  const int NC = L * NT;
  float* dots = grid_dots[warp];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int n = 0; n < PPW; ++n) {
    const int p = p0 + n * NWARPS + warp;
    if (p >= a.HW) break;  // uniform across the warp
    const float2 xy =
        reinterpret_cast<const float2*>(a.coords)[(size_t)e * a.HW + p];

    float f1[2][8];  // source channels 8k .. 8k+7 and 64+8k .. 64+8k+7
    {
      const uint4* row = reinterpret_cast<const uint4*>(
          a.fmap[0] + ((size_t)(rows_ok ? src : 0) * a.HW + p) * C);
      widen(rows_ok ? __ldg(row + k) : zero, f1[0]);
      widen(rows_ok ? __ldg(row + k + 8) : zero, f1[1]);
    }

#pragma unroll
    for (int l = 0; l < MAX_LEVELS; ++l) {
      if (l >= L) break;
      const int hl = pick(a.h, l);
      const int wl = pick(a.w, l);
      const float scale = 1.0f / (float)(1 << l);  // exact: a power of two
      // clamp before the int conversion (a NaN maps to the low end): such
      // grids are all zeros, and a NaN coordinate still gives NaN taps
      // through the blend's weights, as in the twin
      const int xs =
          (int)fminf(fmaxf(floorf(xy.x * scale), -1.0e6f), 1.0e6f) - R;
      const int ys =
          (int)fminf(fmaxf(floorf(xy.y * scale), -1.0e6f), 1.0e6f) - R +
          2 * s;
      // the group's first grid row of the target map, in 16-byte chunks,
      // from x = xs; dereferenced only inside the map
      const uint4* row = reinterpret_cast<const uint4*>(pick(a.fmap, l)) +
                         ((long long)(rows_ok ? dst : 0) * hl * wl +
                          (long long)ys * wl + xs) * (C / 8) + k;
      float* level_dots = dots + l * D * D;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr, row += (size_t)wl * (C / 8)) {
        const int yy = ys + rr;
        const bool y_ok = rows_ok && yy >= 0 && yy < hl;
        float acc[D];
#pragma unroll
        for (int c = 0; c < D; ++c) {
          const bool ok = y_ok && xs + c >= 0 && xs + c < wl;
          const uint4 v0 = ok ? __ldg(row + c * (C / 8)) : zero;
          const uint4 v1 = ok ? __ldg(row + c * (C / 8) + 8) : zero;
          acc[c] = dot8(f1[1], v1, dot8(f1[0], v0, 0.0f));
        }
        halve<4, 4>(acc, k);
        halve<2, 2>(acc, k);
        halve<1, 1>(acc, k);
        // lane k now holds the dot product of column k of grid row 2s + rr
        level_dots[(2 * s + rr) * D + k] = acc[0] * 0.0625f;
      }
    }
    __syncwarp();

    float* out = a.out + ((size_t)e * a.HW + p) * NC;
    for (int t = lane; t < NC; t += 32) {
      const int l = t / NT;
      const int tap = t - l * NT;
      const int ix = tap / RD;  // x-offset-major
      const int iy = tap - ix * RD;
      const float scale = 1.0f / (float)(1 << l);
      const float x = xy.x * scale;
      const float y = xy.y * scale;
      const float dx = x - floorf(x);
      const float dy = y - floorf(y);
      const float* g = dots + l * D * D + iy * D + ix;
      out[t] = ((1.0f - dx) * (1.0f - dy)) * g[0] + (dx * (1.0f - dy)) * g[1] +
               ((1.0f - dx) * dy) * g[D] + (dx * dy) * g[D + 1];
    }
    __syncwarp();
  }
}

}  // namespace

// Launches the correlation over `levels` pyramid levels on `stream`.
//   f0..f3:  [N, h[l], w[l], 128] bf16 contiguous, 16-byte aligned; level 0
//            also holds the source rows, so h[0] * w[0] == HW
//   coords:  [E, HW, 2] f32 contiguous, level-0 scale
//   ii, jj:  [E] source and target rows, int64 if rows_are_64 else int32;
//            a row outside [0, N) reads zeros
//   out:     [E, HW, levels*49] f32 contiguous
// Returns the cudaError_t of the launch (0 on success).
extern "C" int droid_alt_corr(int levels, const void* f0, const void* f1,
                              const void* f2, const void* f3, const int* h,
                              const int* w, int N, int E, int HW,
                              const float* coords, const void* ii,
                              const void* jj, int rows_are_64, float* out,
                              void* stream) {
  const void* maps[MAX_LEVELS] = {f0, f1, f2, f3};
  if (levels < 1 || levels > MAX_LEVELS || E <= 0 || HW <= 0 || N < 0 ||
      h[0] * w[0] != HW ||
      (reinterpret_cast<uintptr_t>(coords) & 7u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  AltArgs a;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    if (l < levels && (reinterpret_cast<uintptr_t>(maps[l]) & 15u) != 0) {
      return (int)cudaErrorInvalidValue;
    }
    a.fmap[l] = static_cast<const __nv_bfloat16*>(l < levels ? maps[l]
                                                             : maps[0]);
    a.h[l] = l < levels ? h[l] : 0;
    a.w[l] = l < levels ? w[l] : 0;
  }
  a.levels = levels;
  a.N = N;
  a.HW = HW;
  a.blocks_per_edge = (HW + PB - 1) / PB;
  if ((long long)a.blocks_per_edge * E > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  a.coords = coords;
  a.ii = ii;
  a.jj = jj;
  a.out = out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.blocks_per_edge * E);
  if (rows_are_64) {
    alt_corr_kernel<int64_t><<<grid, NTHREADS, 0, st>>>(a);
  } else {
    alt_corr_kernel<int32_t><<<grid, NTHREADS, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
