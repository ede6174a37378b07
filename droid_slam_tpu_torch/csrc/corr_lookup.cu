// Correlation-pyramid window lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel droid_slam_tpu/ops/corr_pallas.py::lookup_level_slots
// (body _lookup_kernel, wrapper lookup_pyramid_slots). For each active edge e,
// pixel p and pyramid level l, it samples a bilinear (2r+1)^2 = 49-tap window,
// r = 3, around the warped coordinate coords[e,p] / 2^l in the correlation
// volume vol_l[slots[e], p] (an h2 x w2 map), zero outside the map, and writes
// the taps x-offset-major into out[e, p, l*49 : (l+1)*49] (level-major, the
// layout of the JAX wrapper). Semantics: corr_index_forward_kernel of the CUDA
// reference; plain twin: ops/corr.py::lookup_level_plain.
//
// Design. The Pallas kernel selects the window with two one-hot matmuls
// because Mosaic cannot gather; a GPU gathers directly. One thread per
// (edge, pixel, level) reads the 8 x 8 integer neighbourhood of its own volume
// row (bf16 or f32), blends it into the 49 taps in f32 (the altcorr D-trick),
// and stages them in shared memory so that the block writes its 128 pixels'
// taps as contiguous 196-byte runs instead of 49 scattered stores per thread.
//
// Bound. The kernel moves the output, EA*HW*196*4 bytes (96 MB at 48 edges of
// 40x64 pixels), plus the volume elements its windows touch (at most 64 per
// pixel and level, 2 bytes each for bf16), plus coords and slots; its
// arithmetic (~4 FMA per tap) is negligible against that, so it is bound by
// memory traffic. Each thread's window reads are scattered (one volume row per
// pixel), which the staging cannot fix; that is the first thing to change
// when the kernel is made fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 3;
constexpr int RD = 2 * R + 1;   // 7 taps per axis
constexpr int D = 2 * R + 2;    // 8-wide integer neighbourhood
constexpr int NT = RD * RD;     // 49 taps per level
constexpr int PB = 128;         // pixels (threads) per block
constexpr int MAX_LEVELS = 4;

struct LookupArgs {
  const void* vol[MAX_LEVELS];
  int h2[MAX_LEVELS];
  int w2[MAX_LEVELS];
  int EB;
  int HW;
  int out_stride;
  const float* coords;
  const int32_t* slots;
  float* out;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(PB) corr_lookup_kernel(LookupArgs a) {
  __shared__ float tile[PB * NT];
  const int lvl = blockIdx.z;
  const int e = blockIdx.y;
  const int p0 = blockIdx.x * PB;
  const int p = p0 + threadIdx.x;
  const int h2 = a.h2[lvl];
  const int w2 = a.w2[lvl];

  if (p < a.HW) {
    const float scale = 1.0f / (float)(1 << lvl);  // exact: a power of two
    const size_t ep = (size_t)e * a.HW + p;
    const float x = a.coords[2 * ep] * scale;
    const float y = a.coords[2 * ep + 1] * scale;
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float dx = x - x0;
    const float dy = y - y0;
    // clamp before the int conversion (a NaN maps to the low end); windows
    // that far out are all zeros, and a NaN coordinate still gives NaN taps
    // through dx/dy, as in the plain version
    const int xs = (int)fminf(fmaxf(x0, -1.0e6f), 1.0e6f) - R;
    const int ys = (int)fminf(fmaxf(y0, -1.0e6f), 1.0e6f) - R;
    const int s = a.slots[e];
    const bool slot_ok = s >= 0 && s < a.EB;
    const T* row = static_cast<const T*>(a.vol[lvl]) +
                   ((size_t)(slot_ok ? s : 0) * a.HW + p) * (size_t)(h2 * w2);

    float t[D][D];  // t[i][j]: value at (xs + i, ys + j)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int yy = ys + j;
      const bool yin = slot_ok && yy >= 0 && yy < h2;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const int xx = xs + i;
        t[i][j] = (yin && xx >= 0 && xx < w2) ? to_float(row[yy * w2 + xx])
                                              : 0.0f;
      }
    }
    const float w00 = (1.0f - dx) * (1.0f - dy);
    const float w10 = dx * (1.0f - dy);
    const float w01 = (1.0f - dx) * dy;
    const float w11 = dx * dy;
    float* o = tile + threadIdx.x * NT;  // stride 49: no bank conflicts
#pragma unroll
    for (int ia = 0; ia < RD; ++ia) {
#pragma unroll
      for (int jb = 0; jb < RD; ++jb) {
        o[ia * RD + jb] = w00 * t[ia][jb] + w10 * t[ia + 1][jb] +
                          w01 * t[ia][jb + 1] + w11 * t[ia + 1][jb + 1];
      }
    }
  }
  __syncthreads();

  const int n = min(PB, a.HW - p0);
  float* out = a.out + ((size_t)e * a.HW + p0) * a.out_stride + lvl * NT;
  for (int k = threadIdx.x; k < n * NT; k += PB) {
    const int pp = k / NT;
    out[(size_t)pp * a.out_stride + (k - pp * NT)] = tile[k];
  }
}

}  // namespace

// Launches the lookup over `levels` pyramid levels on `stream`.
//   vols[l]: [EB, HW, h2[l], w2[l]] contiguous, bf16 if vol_is_bf16 else f32
//   coords:  [EA, HW, 2] f32 contiguous, level-0 scale
//   slots:   [EA] int32
//   out:     [EA, HW, levels*49] f32 contiguous
// Returns the cudaError_t of the launch (0 on success).
extern "C" int droid_corr_lookup(int levels, const void* v0, const void* v1,
                                 const void* v2, const void* v3,
                                 const int* h2, const int* w2,
                                 int vol_is_bf16, int EA, int EB, int HW,
                                 const float* coords, const int32_t* slots,
                                 float* out, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || EA <= 0 || HW <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  LookupArgs a;
  const void* vols[MAX_LEVELS] = {v0, v1, v2, v3};
  for (int l = 0; l < MAX_LEVELS; ++l) {
    a.vol[l] = vols[l];
    a.h2[l] = l < levels ? h2[l] : 0;
    a.w2[l] = l < levels ? w2[l] : 0;
  }
  a.EB = EB;
  a.HW = HW;
  a.out_stride = levels * NT;
  a.coords = coords;
  a.slots = slots;
  a.out = out;

  const dim3 grid((HW + PB - 1) / PB, EA, levels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vol_is_bf16) {
    corr_lookup_kernel<__nv_bfloat16><<<grid, PB, 0, s>>>(a);
  } else {
    corr_lookup_kernel<float><<<grid, PB, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
