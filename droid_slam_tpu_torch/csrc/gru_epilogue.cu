// The ConvGRU's two gate epilogues for Hopper (sm_90a).
//
// Replace the TPU kernels droid_slam_tpu/ops/gru_pallas.py::gru_epilogue_a
// (body _epi_a_kernel) and ::gru_epilogue_b (body _epi_b_kernel), in the
// port's NCHW layout. Between the GRU's zr convolution and its q convolution,
// epilogue A computes, per edge e, channel c < 128 and pixel p,
//     zr_k = zrc[e,k,p] + cf[e,k,p] + pre_zr[e,k,p] + gzr[e,k]   (k = c, 128+c)
//     z = sigmoid(zr_c),  r = sigmoid(zr_{128+c})
// and writes z and r*net. After the q convolution, epilogue B computes
//     q = tanh(qc[e,c,p] + cf[e,256+c,p] + pre_q[e,c,p] + gq[e,c])
// and writes (1-z)*net + z*q, the new hidden state. cf is the merged
// corr/flow conv output [E,384,HW]; its channel blocks are read in place by
// offset. The maths is f32 (1/(1+expf(-x)) and tanhf, no fast-math), each
// output is rounded once to the tensors' type (bf16 or f32). Plain twins:
// ops/gru.py::gru_epilogue_a_plain / gru_epilogue_b_plain.
//
// Design. Both are pure elementwise passes, so they are bound by memory
// traffic: A reads 7 planes and writes 2 for each (e, c), B reads 5 and
// writes 1, and both do ~10 flops per element. One thread handles 8
// consecutive pixels of one (e, c) plane with 16-byte loads and stores (one
// uint4 of 8 bf16, or two float4), so neighbouring threads read neighbouring
// addresses and every operand byte is moved once. The Pallas design (one edge
// per grid step, whole (1,h,w,C) planes in VMEM) is not carried over. When the
// plane size is not a multiple of 8 or a pointer is not 16-byte aligned, the
// wrapper asks for the scalar variant, one pixel per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 128;      // hidden-state channels
constexpr int THREADS = 256;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// N consecutive elements to f32: N = 8 as 16-byte vector loads, N = 1 plain.
template <int N>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (N == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (N == 8) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[0];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <int N>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (N == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    p[0] = v[0];
  }
}

template <int N>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (N == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    }
    reinterpret_cast<uint4*>(p)[0] = u;
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

// The thread's (edge, channel, first pixel); false past the end.
template <int N>
__device__ __forceinline__ bool locate(int E, int HW, int64_t* e, int* c,
                                       int64_t* p) {
  const int64_t chunks = HW / N;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)E * C * chunks) return false;
  *e = t / (C * chunks);
  *c = (int)((t / chunks) % C);
  *p = (t % chunks) * N;
  return true;
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
epilogue_a_kernel(const T* __restrict__ zrc, const T* __restrict__ cf,
                  const T* __restrict__ pre_zr, const T* __restrict__ net,
                  const T* __restrict__ gzr, T* __restrict__ z_out,
                  T* __restrict__ rnet_out, int E, int HW) {
  int64_t e, p;
  int c;
  if (!locate<N>(E, HW, &e, &c, &p)) return;
  const int64_t z2 = (e * 2 * C + c) * HW + p;      // [E,256,HW], channel c
  const int64_t r2 = z2 + (int64_t)C * HW;          // channel 128+c
  const int64_t zf = (e * 3 * C + c) * HW + p;      // cf [E,384,HW]
  const int64_t rf = zf + (int64_t)C * HW;
  const int64_t o = (e * C + c) * HW + p;           // [E,128,HW]
  const float gz = to_f(gzr[e * 2 * C + c]);
  const float gr = to_f(gzr[e * 2 * C + C + c]);

  float a[N], b[N], d[N], x[N];
  load<N>(zrc + z2, a);
  load<N>(cf + zf, b);
  load<N>(pre_zr + z2, d);
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = sigmoid_f(((a[k] + b[k]) + d[k]) + gz);
  store<N>(z_out + o, x);

  load<N>(zrc + r2, a);
  load<N>(cf + rf, b);
  load<N>(pre_zr + r2, d);
  load<N>(net + o, x);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    x[k] = sigmoid_f(((a[k] + b[k]) + d[k]) + gr) * x[k];
  }
  store<N>(rnet_out + o, x);
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
epilogue_b_kernel(const T* __restrict__ qc, const T* __restrict__ cf,
                  const T* __restrict__ pre_q, const T* __restrict__ net,
                  const T* __restrict__ z, const T* __restrict__ gq,
                  T* __restrict__ out, int E, int HW) {
  int64_t e, p;
  int c;
  if (!locate<N>(E, HW, &e, &c, &p)) return;
  const int64_t o = (e * C + c) * HW + p;               // [E,128,HW]
  const int64_t qf = (e * 3 * C + 2 * C + c) * HW + p;  // cf channel 256+c
  const float g = to_f(gq[e * C + c]);

  float a[N], b[N], d[N], h[N], zz[N];
  load<N>(qc + o, a);
  load<N>(cf + qf, b);
  load<N>(pre_q + o, d);
  load<N>(net + o, h);
  load<N>(z + o, zz);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float q = tanhf(((a[k] + b[k]) + d[k]) + g);
    // _rn: no contraction into an FMA, so the rounding is the twin's
    a[k] = __fadd_rn(__fmul_rn(1.0f - zz[k], h[k]), __fmul_rn(zz[k], q));
  }
  store<N>(out + o, a);
}

dim3 grid_for(int E, int HW, int n) {
  const int64_t threads = (int64_t)E * C * (HW / n);
  return dim3((unsigned)((threads + THREADS - 1) / THREADS));
}

}  // namespace

// Epilogue A on `stream`. Every tensor is contiguous, of one type (bf16 if
// is_bf16 else f32): zrc, pre_zr [E,256,HW]; cf [E,384,HW]; net, z, rnet
// [E,128,HW]; gzr [E,256]. vec8 selects the 8-pixel vector variant (HW a
// multiple of 8, pointers 16-byte aligned). Returns the launch's cudaError_t.
extern "C" int droid_gru_epilogue_a(int is_bf16, int vec8, int E, int HW,
                                    const void* zrc, const void* cf,
                                    const void* pre_zr, const void* net,
                                    const void* gzr, void* z, void* rnet,
                                    void* stream) {
  if (E <= 0 || HW <= 0 || (vec8 && HW % 8 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(E, HW, vec8 ? 8 : 1);
#define EPI_A(T, N)                                                         \
  epilogue_a_kernel<T, N><<<grid, THREADS, 0, s>>>(                         \
      (const T*)zrc, (const T*)cf, (const T*)pre_zr, (const T*)net,         \
      (const T*)gzr, (T*)z, (T*)rnet, E, HW)
  if (is_bf16) {
    if (vec8) EPI_A(__nv_bfloat16, 8); else EPI_A(__nv_bfloat16, 1);
  } else {
    if (vec8) EPI_A(float, 8); else EPI_A(float, 1);
  }
#undef EPI_A
  return (int)cudaGetLastError();
}

// Epilogue B on `stream`: qc, pre_q, net, z, out [E,128,HW]; cf [E,384,HW];
// gq [E,128]; types and vec8 as for epilogue A.
extern "C" int droid_gru_epilogue_b(int is_bf16, int vec8, int E, int HW,
                                    const void* qc, const void* cf,
                                    const void* pre_q, const void* net,
                                    const void* z, const void* gq, void* out,
                                    void* stream) {
  if (E <= 0 || HW <= 0 || (vec8 && HW % 8 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(E, HW, vec8 ? 8 : 1);
#define EPI_B(T, N)                                                         \
  epilogue_b_kernel<T, N><<<grid, THREADS, 0, s>>>(                         \
      (const T*)qc, (const T*)cf, (const T*)pre_q, (const T*)net,           \
      (const T*)z, (const T*)gq, (T*)out, E, HW)
  if (is_bf16) {
    if (vec8) EPI_B(__nv_bfloat16, 8); else EPI_B(__nv_bfloat16, 1);
  } else {
    if (vec8) EPI_B(float, 8); else EPI_B(float, 1);
  }
#undef EPI_B
  return (int)cudaGetLastError();
}
