// Exact integer matrix products for Hopper (sm_90a), written by hand.
//
// Replaces three Pallas TPU kernels of the reference package:
//   * repro/kernels/qmm.py::_qmm_kernel         int8 x int8 -> int32
//   * repro/kernels/qmm.py::_qmm_packed_kernel  int8 x packed int4 -> int32
//   * repro/kernels/fused.py::_fused_qmm_kernel f32 acts quantized against
//     the static scale sa in the block, int8 or packed-int4 weights, int32
//     accumulation, epilogue (acc * sa) * sw[n]
// One template serves all three (FUSED: quantize step + epilogue; PACKED:
// nibble unpack of the weight tile).
//
// Design. The TPU kernels walk a sequential k grid axis and revisit the
// output block; here each thread block owns one (BM, BN) output tile and
// loops over K itself, so nothing carries between blocks. Ragged M/N/K
// edges are masked on load (zeros contribute nothing to an integer sum)
// and on store, so the wrapper never pads a copy. The weight tile is
// stored transposed in shared memory (k contiguous per column) so that
// one 32-bit word holds four consecutive k of one column, and the
// activation tile row-major for the same reason: __dp4a then does four
// int8 multiply-adds into an int32 accumulator per instruction. Integer
// arithmetic is exact in any order, so the result is bit-equal to
// kernels/ref.py (qmm_ref, fused_qmm_ref).
//
// Exactness of the fused step. The activation quantize is
// clamp(__float2int_rn(x / sa), -128, 127): IEEE division (this file must
// never be built with --use_fast_math) and round-half-to-even, the same as
// jnp.round(x / sa) / torch.round. The epilogue is two separate f32
// multiplies in the reference's order, ((float)acc * sa) * sw[n].
//
// Bound. At the decode shape (M = 8 slots) these kernels do far fewer
// operations per byte than the card's int8 rate needs, so the least
// time is the bytes read (weights once, activations once) and written
// over the memory bandwidth. One decode step of qwen2-0.5b (24 layers x
// 7 projections) moves 369.5 MB through qmm (int8), 190.6 MB through
// qmm_packed and 376.6 MB through fused_qmm: at 3.35 TB/s, 0.110, 0.057
// and 0.112 ms. This first version takes 13.4, 8.9 and 16.7 ms (NVIDIA
// H100 80GB HBM3, 700 W; chip_smoke.py): few blocks at N = 896, a
// 32-row tile for 8 rows, and one byte loaded per thread with nothing in
// flight across the K loop. 16-byte loads, cp.async or TMA staging,
// split-K for narrow N and mma.sync s8 are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr int ROW_STEP = THREADS / BN;     // 4 thread rows per block
constexpr int RPT = BM / ROW_STEP;         // 8 output rows per thread
constexpr int WS_STRIDE = BK + 4;          // 68 bytes = 17 words: odd, so
                                           // 32 columns hit 32 banks

template <bool FUSED, bool PACKED>
__global__ void __launch_bounds__(THREADS)
int_mm_kernel(const void* __restrict__ a_ptr, const int8_t* __restrict__ w,
              const float* __restrict__ sw, const float* __restrict__ sa_ptr,
              void* __restrict__ out_ptr, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[BM * BK];
  __shared__ __align__(16) int8_t Ws[BN * WS_STRIDE];
  const int t = threadIdx.x;
  const int tx = t % BN;
  const int ty = t / BN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float sa = FUSED ? *sa_ptr : 0.0f;
  int acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // activation tile (BM, BK), k contiguous
    for (int i = t; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      int8_t v = 0;
      if (m < M && k < K) {
        if (FUSED) {
          const float xv = static_cast<const float*>(a_ptr)[(size_t)m * K + k];
          int q = __float2int_rn(xv / sa);
          q = min(max(q, -128), 127);
          v = static_cast<int8_t>(q);
        } else {
          v = static_cast<const int8_t*>(a_ptr)[(size_t)m * K + k];
        }
      }
      As[r * BK + c] = v;
    }
    // weight tile (BK, BN), stored transposed: Ws[n][k]
    if (PACKED) {
      // byte (k2, n) = (w[2*k2+1] << 4) | (w[2*k2] & 0xF), both nibbles
      // sign-extended
      for (int i = t; i < (BK / 2) * BN; i += THREADS) {
        const int r2 = i / BN, c = i % BN;
        const int k2 = k0 / 2 + r2, n = n0 + c;
        int lo = 0, hi = 0;
        if (k2 < K / 2 && n < N) {
          const int p = w[(size_t)k2 * N + n];
          lo = ((p & 0xF) ^ 8) - 8;
          hi = p >> 4;
        }
        Ws[c * WS_STRIDE + 2 * r2] = static_cast<int8_t>(lo);
        Ws[c * WS_STRIDE + 2 * r2 + 1] = static_cast<int8_t>(hi);
      }
    } else {
      for (int i = t; i < BK * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        const int k = k0 + r, n = n0 + c;
        Ws[c * WS_STRIDE + r] = (k < K && n < N) ? w[(size_t)k * N + n] : 0;
      }
    }
    __syncthreads();
    const int* wcol = reinterpret_cast<const int*>(Ws + tx * WS_STRIDE);
#pragma unroll
    for (int kk = 0; kk < BK / 4; ++kk) {
      const int wv = wcol[kk];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int av =
            reinterpret_cast<const int*>(As + (ty + i * ROW_STEP) * BK)[kk];
        acc[i] = __dp4a(av, wv, acc[i]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tx;
  if (n >= N) return;
  const float swn = FUSED ? sw[n] : 0.0f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + i * ROW_STEP;
    if (m >= M) continue;
    if (FUSED) {
      const float y = static_cast<float>(acc[i]) * sa;
      static_cast<float*>(out_ptr)[(size_t)m * N + n] = y * swn;
    } else {
      static_cast<int32_t*>(out_ptr)[(size_t)m * N + n] = acc[i];
    }
  }
}

dim3 grid_for(int M, int N) {
  return dim3((N + BN - 1) / BN, (M + BM - 1) / BM);
}

}  // namespace

// a (M, K) int8; b (K, N) int8, or (K/2, N) packed bytes when packed;
// out (M, N) int32. Returns the launch's cudaError_t.
extern "C" int qmm_launch(const void* a, const void* b, void* out, int M,
                          int N, int K, int packed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(b);
  if (packed) {
    int_mm_kernel<false, true><<<grid_for(M, N), THREADS, 0, s>>>(
        a, w, nullptr, nullptr, out, M, N, K);
  } else {
    int_mm_kernel<false, false><<<grid_for(M, N), THREADS, 0, s>>>(
        a, w, nullptr, nullptr, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (M, K) f32; w (K, N) int8 or (K/2, N) packed bytes; sw (N,) f32;
// sa a device pointer to one f32; out (M, N) f32.
extern "C" int fused_qmm_launch(const void* x, const void* w, const void* sw,
                                const void* sa, void* out, int M, int N,
                                int K, int packed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wb = static_cast<const int8_t*>(w);
  const float* swf = static_cast<const float*>(sw);
  const float* saf = static_cast<const float*>(sa);
  if (packed) {
    int_mm_kernel<true, true><<<grid_for(M, N), THREADS, 0, s>>>(
        x, wb, swf, saf, out, M, N, K);
  } else {
    int_mm_kernel<true, false><<<grid_for(M, N), THREADS, 0, s>>>(
        x, wb, swf, saf, out, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
