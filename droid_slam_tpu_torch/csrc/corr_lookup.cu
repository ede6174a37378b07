// Correlation-pyramid window lookup for Hopper (sm_90a).
//
// Replaces the TPU kernel droid_slam_tpu/ops/corr_pallas.py::lookup_level_slots
// (body _lookup_kernel, wrapper lookup_pyramid_slots). For each active edge e,
// pixel p and pyramid level l, it samples a bilinear (2r+1)^2 = 49-tap window,
// r = 3, around the warped coordinate coords[e,p] / 2^l in the correlation
// volume vol_l[slots[e], p] (an h2 x w2 map), zero outside the map (and for a
// slot outside [0, EB)), and writes the taps x-offset-major into
// out[e, p, l*49 : (l+1)*49] (level-major, the layout of the JAX wrapper).
// Semantics: corr_index_forward_kernel of the CUDA reference; plain twin:
// ops/corr.py::lookup_level_plain.
//
// Bound. The kernel must write the output, EA*HW*L*49*4 bytes (96 MB at 48
// edges of 40x64 pixels, 4 levels), and read the volume elements its windows
// touch (at most 8 x 8 per pixel and level, 2 bytes each in bf16, ~40 MB),
// plus coords and slots; ~4 FMA per tap is negligible against that, so it is
// bound by memory traffic, 70% of it the writes. Measured on the H100 (the
// kernel with its stores or its volume reads switched off): the earlier
// one-thread-per-window kernel spent ~0.15 ms on each side; here the writes
// alone take ~0.07 ms and the reads ~0.10 ms. The reads stay the limit: each
// window row is a 16-byte span of its own 32-byte sector (8 rows, ~1.4
// sectors each, per window), scattered over the edge's maps.
//
// Design. The Pallas kernel selects the window with two one-hot matmuls
// because Mosaic cannot gather; a GPU gathers directly. One block covers 64
// pixels of one edge at every level:
//  * the pixels' coordinates are staged once in shared memory;
//  * eight lanes share one (pixel, level) window, lane j reading window row
//    j. For bf16 maps whose rows are whole 16-byte chunks (w2 % 8 == 0; all
//    four levels of a 320x512 image), the lane reads the row's eight
//    elements from x0 - 3 with two aligned 16-byte loads and a funnel shift
//    (x0 is not aligned), so one warp load reads 32 window rows instead of
//    one thread issuing 64 scattered 2-byte loads; other maps (and f32
//    volumes, which the main path does not use) are read element by element.
//    Each lane keeps ILP windows' loads in flight before it blends any;
//  * the vertical blend takes row j+1 from the next lane (__shfl_down_sync);
//  * a warp's four windows are one pixel's four levels, so its seven store
//    instructions (lane j writes the taps of y offset j) together write the
//    pixel's whole contiguous L*49-float output row, and L2 merges them into
//    full sectors. Staging the block's [64, L*49] tile in shared memory for
//    16-byte stores (tried) wrote no faster and, at 50 KB a block, cut the
//    warps in flight for the reads: 0.17 ms against 0.14 ms on the H100.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 3;
constexpr int RD = 2 * R + 1;   // 7 taps per axis
constexpr int NT = RD * RD;     // 49 taps per level
constexpr int MAX_LEVELS = 4;
constexpr int PB = 64;          // pixels per block
constexpr int NTHREADS = 256;
constexpr int ILP = 4;          // windows per lane in flight at once
constexpr int LANES = 8;        // lanes per window: one window row each
constexpr int WPP = NTHREADS / LANES;  // windows per pass

struct LookupArgs {
  const void* vol[MAX_LEVELS];
  int h2[MAX_LEVELS];
  int w2[MAX_LEVELS];
  int vec[MAX_LEVELS];  // rows of this level read as aligned 16-byte chunks
  int levels;
  int EB;
  int HW;
  const float* coords;
  const int32_t* slots;
  float* out;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Elements x0 .. x0+7 of a bf16 row whose 16-byte chunks are whole
// (nchunks = w2 / 8 of them), zeros outside the row.
__device__ __forceinline__ void load_row_bf16(const __nv_bfloat16* row,
                                              int nchunks, int x0, bool ok,
                                              float t[8]) {
  const int c = x0 >> 3;  // floor(x0 / 8), also for negative x0
  const int k = x0 & 7;   // element offset inside chunk c
  const uint4* p = reinterpret_cast<const uint4*>(row);
  uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
  if (ok && c >= 0 && c < nchunks) lo = __ldg(p + c);
  if (ok && c + 1 >= 0 && c + 1 < nchunks) hi = __ldg(p + c + 1);
  const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = k >> 1;
  const unsigned sh = (k & 1) * 16u;
  uint32_t sel[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    sel[i] = q == 0 ? v[i] : q == 1 ? v[i + 1] : q == 2 ? v[i + 2] : v[i + 3];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = __funnelshift_r(sel[i], sel[i + 1], sh);
    t[2 * i] = __uint_as_float(w << 16);            // bf16 -> f32 is exact
    t[2 * i + 1] = __uint_as_float(w & 0xffff0000u);
  }
}

// a[l] without indexing the kernel's parameters dynamically (which would
// copy them to local memory)
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[MAX_LEVELS], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 4) corr_lookup_kernel(LookupArgs a) {
  __shared__ float2 xy[PB];

  const int e = blockIdx.y;
  const int p0 = blockIdx.x * PB;
  const int n = min(PB, a.HW - p0);
  const int L = a.levels;
  const int C = L * NT;
  const float2* coords = reinterpret_cast<const float2*>(a.coords) +
                         (size_t)e * a.HW + p0;
  for (int i = threadIdx.x; i < n; i += NTHREADS) xy[i] = coords[i];
  const int s = a.slots[e];
  const bool slot_ok = s >= 0 && s < a.EB;
  float* out = a.out + ((size_t)e * a.HW + p0) * C;
  __syncthreads();

  const int lane = threadIdx.x % LANES;  // window row: y offset
  const int g = threadIdx.x / LANES;     // window of the pass
  for (int w0 = 0; w0 < n * L; w0 += WPP * ILP) {
    // ILP windows per lane, their loads issued before any is used
    float t[ILP][8];   // t[u][i]: value at (xs + i, yy) of window u
    float dx[ILP], dy[ILP];
    int base[ILP];     // out offset of the window's taps, -1 if inactive
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      const int wi = w0 + u * WPP + g;
      const bool active = wi < n * L;
      const int pix = active ? wi / L : 0;
      const int lvl = active ? wi - pix * L : 0;
      const int h2 = pick(a.h2, lvl);
      const int w2 = pick(a.w2, lvl);
      const float scale = 1.0f / (float)(1 << lvl);  // exact: a power of two
      const float x = xy[pix].x * scale;
      const float y = xy[pix].y * scale;
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      dx[u] = x - x0;
      dy[u] = y - y0;
      base[u] = active ? pix * C + lvl * NT + lane : -1;
      // clamp before the int conversion (a NaN maps to the low end); windows
      // that far out are all zeros, and a NaN coordinate still gives NaN
      // taps through dx/dy, as in the plain version
      const int xs = (int)fminf(fmaxf(x0, -1.0e6f), 1.0e6f) - R;
      const int yy = (int)fminf(fmaxf(y0, -1.0e6f), 1.0e6f) - R + lane;
      const bool row_ok = active && slot_ok && yy >= 0 && yy < h2;
      const T* row = static_cast<const T*>(pick(a.vol, lvl)) +
                     ((size_t)(slot_ok ? s : 0) * a.HW + p0 + pix) *
                         (size_t)(h2 * w2) +
                     (size_t)(row_ok ? yy : 0) * w2;
      bool vec = false;
      if constexpr (sizeof(T) == 2) vec = pick(a.vec, lvl) != 0;
      if (vec) {
        load_row_bf16(reinterpret_cast<const __nv_bfloat16*>(row), w2 >> 3,
                      xs, row_ok, t[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int xx = xs + i;
          t[u][i] = (row_ok && xx >= 0 && xx < w2) ? to_float(row[xx]) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      float nb[8];  // nb[i]: value at (xs + i, yy + 1), from the next lane
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        nb[i] = __shfl_down_sync(0xffffffffu, t[u][i], 1, LANES);
      }
      if (base[u] >= 0 && lane < RD) {
        const float w00 = (1.0f - dx[u]) * (1.0f - dy[u]);
        const float w10 = dx[u] * (1.0f - dy[u]);
        const float w01 = (1.0f - dx[u]) * dy[u];
        const float w11 = dx[u] * dy[u];
        float* o = out + base[u];
#pragma unroll
        for (int ia = 0; ia < RD; ++ia) {
          o[ia * RD] = w00 * t[u][ia] + w10 * t[u][ia + 1] +
                       w01 * nb[ia] + w11 * nb[ia + 1];
        }
      }
    }
  }
}

template <typename T>
int launch(const LookupArgs& a, int EA, cudaStream_t stream) {
  const dim3 grid((a.HW + PB - 1) / PB, EA);
  corr_lookup_kernel<T><<<grid, NTHREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
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
  if (levels < 1 || levels > MAX_LEVELS || EA <= 0 || HW <= 0 ||
      (reinterpret_cast<uintptr_t>(coords) & 7u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  LookupArgs a;
  const void* vols[MAX_LEVELS] = {v0, v1, v2, v3};
  for (int l = 0; l < MAX_LEVELS; ++l) {
    a.vol[l] = vols[l];
    a.h2[l] = l < levels ? h2[l] : 0;
    a.w2[l] = l < levels ? w2[l] : 0;
    // 16-byte chunks of a row are whole and aligned when the row is a
    // multiple of 8 bf16 and the volume starts 16-byte aligned (then every
    // map and every row does)
    a.vec[l] = l < levels && vol_is_bf16 && w2[l] % 8 == 0 &&
               (reinterpret_cast<uintptr_t>(vols[l]) & 15u) == 0;
  }
  a.levels = levels;
  a.EB = EB;
  a.HW = HW;
  a.coords = coords;
  a.slots = slots;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vol_is_bf16 ? launch<__nv_bfloat16>(a, EA, s) : launch<float>(a, EA, s);
}
