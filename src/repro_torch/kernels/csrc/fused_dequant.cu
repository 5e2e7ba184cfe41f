// General fused dequant matrix product for Hopper (sm_90a), by hand.
//
// Replaces repro/kernels/fused.py::_fused_dequant_kernel: f32 activations
// times a stored weight of any kind (int8, int4 in int8 storage, packed
// int4, fp8 e4m3 codes, fp4 e2m1 codes, packed fp4), decoded to f32 and
// multiplied by its per-channel (1, N) or per-group (G, N) scale, with an
// optional activation step against the static scalar sa:
//   none  - x as is;
//   qdq   - clip(rint(x / sa), -128, 127) * sa (the fake-quant grid);
//   quant - clip(rint(x / sa), -128, 127), and the sum times sa at the end.
//
// Design. One thread block per (BM, BN) output tile loops over K in BK
// tiles; nothing carries between blocks, and ragged M/N/K edges are masked
// (zero weights and activations) instead of padded. The activation tile
// takes its act step once on its way into shared memory; the weight tile
// is decoded and multiplied by sw[k / g][n] (g = K / G) on its way in, so
// a scale group may start anywhere inside a tile. fp8/fp4 codes decode by
// the same bit arithmetic as quant/quantize.py::fp_decode, for every code
// (0x7F is 480 in e4m3 here, not NaN), and never through the hardware fp8
// type.
//
// Numerics and tolerance. Accumulation is FP32 FFMA on CUDA cores. The
// decode, the scale multiply and the act step are the same single-rounded
// f32 operations as kernels/ref.py::fused_dequant_mm_ref, so the only
// difference from the plain version is the order of summation. Both sums
// are within gamma_K * sum_k |x_k w_k| of the exact one (gamma_K = K u /
// (1 - K u), u = 2^-24), so they agree to 2 gamma_K * (|x| @ |w|)
// elementwise; that is the tolerance chip_smoke.py holds the kernel to.
//
// Bound. One decode step of qwen2-0.5b at 8 slots (M = 8) runs this
// kernel on 24 layers x 7 projection shapes: 197.7 MB to read and write
// (int4 packed weights, f32 activations, outputs, scales) and 5.7 GFLOP.
// At 3.35 TB/s and 67 TFLOP/s (f32 on CUDA cores) that is at least
// 0.059 ms for the bytes and 0.085 ms for the operations. This first
// version takes 43.5 ms (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py):
// it is latency-bound. At M = 8 three quarters of the 32-row tile are
// empty, each BK step is a round trip to device memory and a barrier
// with nothing in flight, and N = 896 gives 28 blocks for 132 SMs.
// Rows in registers, K split across warps, 16-byte loads and cp.async
// double buffering are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int THREADS = 128;
constexpr int ROW_STEP = THREADS / BN;   // 4
constexpr int RPT = BM / ROW_STEP;       // 8 output rows per thread

enum Kind { INT8 = 0, INT4 = 1, INT4_PACKED = 2, FP8 = 3, FP4 = 4,
            FP4_PACKED = 5 };
enum Act { ACT_NONE = 0, ACT_QDQ = 1, ACT_QUANT = 2 };

// quant/quantize.py::fp_decode: sig * 2^(e - man_bits), exact
__device__ __forceinline__ float fp_decode(int c, int eb, int mb, int bias) {
  const int sign = (c >> (eb + mb)) & 1;
  const int ef = (c >> mb) & ((1 << eb) - 1);
  const int man = c & ((1 << mb) - 1);
  const int sig = ef > 0 ? man + (1 << mb) : man;
  const int e = ef > 0 ? ef - bias : 1 - bias;
  const float v = ldexpf(static_cast<float>(sig), e - mb);
  return sign ? -v : v;
}

template <int KIND>
__device__ __forceinline__ float decode(const void* __restrict__ w, int k,
                                        int n, int N) {
  const int8_t* s8 = static_cast<const int8_t*>(w);
  const uint8_t* u8 = static_cast<const uint8_t*>(w);
  if (KIND == INT8 || KIND == INT4) {
    return static_cast<float>(s8[(size_t)k * N + n]);
  } else if (KIND == INT4_PACKED) {
    const int p = s8[(size_t)(k >> 1) * N + n];
    const int q = (k & 1) ? (p >> 4) : (((p & 0xF) ^ 8) - 8);
    return static_cast<float>(q);
  } else if (KIND == FP8) {
    return fp_decode(u8[(size_t)k * N + n], 4, 3, 7);
  } else if (KIND == FP4) {
    return fp_decode(u8[(size_t)k * N + n], 2, 1, 1);
  } else {  // FP4_PACKED: unsigned nibbles
    const int p = u8[(size_t)(k >> 1) * N + n];
    const int c = (k & 1) ? ((p >> 4) & 0xF) : (p & 0xF);
    return fp_decode(c, 2, 1, 1);
  }
}

template <int KIND, int ACT>
__global__ void __launch_bounds__(THREADS)
fused_dequant_kernel(const float* __restrict__ x, const void* __restrict__ w,
                     const float* __restrict__ sw,
                     const float* __restrict__ sa_ptr,
                     float* __restrict__ out, int M, int N, int K, int g) {
  __shared__ float Xs[BM][BK];
  __shared__ float Ws[BK][BN];
  const int t = threadIdx.x;
  const int tx = t % BN;
  const int ty = t / BN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float sa = ACT == ACT_NONE ? 0.0f : *sa_ptr;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = t; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      float v = 0.0f;
      if (m < M && k < K) {
        v = x[(size_t)m * K + k];
        if (ACT != ACT_NONE) {
          float q = rintf(v / sa);
          q = fminf(fmaxf(q, -128.0f), 127.0f);
          v = ACT == ACT_QDQ ? q * sa : q;
        }
      }
      Xs[r][c] = v;
    }
    for (int i = t; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      float v = 0.0f;
      if (k < K && n < N) {
        v = decode<KIND>(w, k, n, N) * sw[(size_t)(k / g) * N + n];
      }
      Ws[r][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float wv = Ws[kk][tx];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        acc[i] = fmaf(Xs[ty + i * ROW_STEP][kk], wv, acc[i]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + i * ROW_STEP;
    if (m < M) {
      out[(size_t)m * N + n] = ACT == ACT_QUANT ? acc[i] * sa : acc[i];
    }
  }
}

template <int KIND>
void launch_kind(int act, dim3 grid, cudaStream_t s, const float* x,
                 const void* w, const float* sw, const float* sa, float* out,
                 int M, int N, int K, int g) {
  if (act == ACT_NONE) {
    fused_dequant_kernel<KIND, ACT_NONE><<<grid, THREADS, 0, s>>>(
        x, w, sw, sa, out, M, N, K, g);
  } else if (act == ACT_QDQ) {
    fused_dequant_kernel<KIND, ACT_QDQ><<<grid, THREADS, 0, s>>>(
        x, w, sw, sa, out, M, N, K, g);
  } else {
    fused_dequant_kernel<KIND, ACT_QUANT><<<grid, THREADS, 0, s>>>(
        x, w, sw, sa, out, M, N, K, g);
  }
}

}  // namespace

// x (M, K) f32; w the stored operand ((K, N), or (K/2, N) for the packed
// kinds); sw (G, N) f32 with K % G == 0; sa a device pointer to one f32
// (unused, may be null, when act is none); out (M, N) f32. kind and act
// take the enum values above. Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for a kind or act out of range.
extern "C" int fused_dequant_launch(const void* x, const void* w,
                                    const void* sw, const void* sa, void* out,
                                    int M, int N, int K, int G, int kind,
                                    int act, void* stream) {
  if (kind < INT8 || kind > FP4_PACKED || act < ACT_NONE || act > ACT_QUANT ||
      G < 1 || K % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const float* xf = static_cast<const float*>(x);
  const float* swf = static_cast<const float*>(sw);
  const float* saf = static_cast<const float*>(sa);
  float* o = static_cast<float*>(out);
  const int g = K / G;
  switch (kind) {
    case INT8: launch_kind<INT8>(act, grid, s, xf, w, swf, saf, o, M, N, K, g); break;
    case INT4: launch_kind<INT4>(act, grid, s, xf, w, swf, saf, o, M, N, K, g); break;
    case INT4_PACKED: launch_kind<INT4_PACKED>(act, grid, s, xf, w, swf, saf, o, M, N, K, g); break;
    case FP8: launch_kind<FP8>(act, grid, s, xf, w, swf, saf, o, M, N, K, g); break;
    case FP4: launch_kind<FP4>(act, grid, s, xf, w, swf, saf, o, M, N, K, g); break;
    default: launch_kind<FP4_PACKED>(act, grid, s, xf, w, swf, saf, o, M, N, K, g); break;
  }
  return static_cast<int>(cudaGetLastError());
}
