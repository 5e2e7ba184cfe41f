// Bounded-alignment approximate FP16 inner product at matmul scale (the
// paper's IPU(w) arithmetic), for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel repro/kernels/mpmm.py::_mpmm_kernel and
// the round_to_fp epilogue the reference runs after it. Every output
// element is bit-for-bit what the reference computes for the same f16
// operands and IPUConfig: per K-group of n products the EHU takes the
// group's largest product exponent, each product's alignment shift and
// the software-precision mask; then either nine nibble-plane iterations
// (faithful: 5-bit signed plane products << (w - 9), a truncating
// alignment shift, a w-bit adder tree) or one 22-bit plane on a
// w_f = min(w, 26)-bit datapath (fused) feed the (33 + t + l)-bit
// accumulator with its swap-and-shift; at the end the accumulator is
// rounded to nearest even into fp32, fp16 or bf16.
//
// Design. The TPU kernel walks a sequential k grid axis and carries the
// two-limb accumulator (hi, lo, exp) across it in revisited int32 output
// blocks. Blocks here run in no order, so each thread owns one output
// element and each block loops over all K-groups itself; the
// accumulator stays in registers and never reaches device memory. The
// block stages whole K-groups of its (BM x chunk) and (chunk x BN) f16
// tiles in shared memory, decoded once there into one 32-bit word per
// element: the exponent and the three signed nibble planes (faithful) or
// the 12-bit signed magnitude (fused). The EHU runs once per (m, n) and
// group, and the nine plane iterations reuse its shifts and mask. Ragged
// M, N and K load as f16 +0 (exponent -14, magnitude 0), which is what
// the reference's zero padding gives.
//
// Exactness. The reference's two int32 limbs (V = hi * 2^24 + lo) become
// one int64 with the same saturations: a right shift of 48 or more
// clears the magnitude (the limbs' _shr_unsigned), the swap shift is
// clamped at 63, a net right shift at 2^20 and a left shift at 23;
// adder-tree shifts clamp at 31. Truncation is sign-magnitude (shift
// |v|, reapply the sign); rounding="floor" shifts arithmetically. Left
// shifts of signed values are taken as multiplies, so no shift here is
// undefined in C++. The accumulator's magnitude stays below 2^48 (the
// limbs' canonical range) for every configuration IPUConfig admits, so
// 63 - __clzll(|acc|) is the limbs' frexp-based msb_index. Inputs are
// not checked for inf/NaN, as the reference does not check them.
//
// Bound. This is integer CUDA-core work with no tensor-core form: every
// product takes its own data-dependent shift before the sum. One decode
// step of qwen2-0.5b (M = 8 rows, the 168 projections, 357.8 M weights)
// is 9 x 8 x 357.8 M = 25.8 G nibble products; at a multiply, a shift
// and an add each that is 77 G int32 operations, which the card's
// 132 SMs x 64 INT32 lanes do in about 4.6 ms at 1.98 GHz, against
// 0.21 ms to read the 715.6 MB of f16 weights: operations bound it.
// This first version gives one thread one output, so at M = 8 a narrow
// projection (N = 128) fills 4 blocks of the 132 SMs; splitting each
// group's products across a warp, operands in registers and cp.async
// staging are later work. No build flag may add --use_fast_math.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;              // output rows per block
constexpr int BN = 32;             // output columns per block (one warp)
constexpr int THREADS = BM * BN;   // one thread per output element
constexpr int STAGE_K = 64;        // k staged per pass, in whole groups
constexpr int NEG_INF_EXP = -(1 << 20);
constexpr int SMEM_DEFAULT = 48 * 1024;

struct OutFormat {
  int mant, exp_bits, bias, min_exp, max_exp, bits;
};

// f16 bits -> one word: faithful {n0, n1, n2, exp} as four signed bytes,
// fused (sign * mag) * 256 | exp byte.
template <bool FUSED>
__device__ __forceinline__ int encode(uint16_t h) {
  const int sign = (h >> 15) ? -1 : 1;
  const int e = (h >> 10) & 0x1F;
  const int m = h & 0x3FF;
  const int mag = e == 0 ? m : (m | 0x400);
  const int exp = e == 0 ? -14 : e - 15;
  if (FUSED) return (sign * mag) * 256 | (exp & 0xFF);
  const int n2 = sign * ((mag >> 7) & 0xF);
  const int n1 = sign * ((mag >> 3) & 0xF);
  const int n0 = sign * ((mag & 0x7) << 1);
  return static_cast<int>((static_cast<uint32_t>(n0 & 0xFF)) |
                          (static_cast<uint32_t>(n1 & 0xFF) << 8) |
                          (static_cast<uint32_t>(n2 & 0xFF) << 16) |
                          (static_cast<uint32_t>(exp & 0xFF) << 24));
}

template <bool FUSED>
__device__ __forceinline__ int exp_of(int word) {
  return FUSED ? static_cast<int>(static_cast<int8_t>(word & 0xFF))
               : (word >> 24);
}

__device__ __forceinline__ int byte_at(int word, int i) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * i)) & 0xFF));
}

// core.ipu._shr_i32: s >= 0, clamped at 31
template <bool FLOOR>
__device__ __forceinline__ int shr_i32(int d, int s) {
  s = min(s, 31);
  if (FLOOR) return d >> s;
  const int r = (d < 0 ? -d : d) >> s;
  return d < 0 ? -r : r;
}

// two-limb right shift by s >= 0: trunc or floor, 48 or more clears
template <bool FLOOR>
__device__ __forceinline__ long long shr64(long long v, int s) {
  if (FLOOR) {
    if (s >= 48) return v < 0 ? -1 : 0;
    return v >> s;
  }
  if (s >= 48) return 0;
  const long long r = (v < 0 ? -v : v) >> s;
  return v < 0 ? -r : r;
}

// core.ipu.accumulate with extra_shift = 0
template <bool FLOOR>
__device__ __forceinline__ void accumulate(long long& acc, int& exp_acc,
                                           int s_tree, int mx, int pre,
                                           int w) {
  if (mx > exp_acc) {
    acc = shr64<FLOOR>(acc, min(mx - exp_acc, 63));
    exp_acc = mx;
  }
  const int net = pre + (exp_acc - mx) - (33 - w);
  long long v = s_tree;
  if (net < 0) {
    v *= 1LL << min(-net, 23);
  } else {
    v = shr64<FLOOR>(v, min(net, 1 << 20));
  }
  acc += v;
}

// fixedpoint.round_to_fp: value acc * 2^(exp - 30), RNE into the format;
// returns the format's bit pattern
__device__ uint32_t round_to_fp(long long acc, int exp, const OutFormat f) {
  if (acc == 0) return 0u;  // +0
  const uint32_t sign_bit = acc < 0 ? 1u : 0u;
  const unsigned long long mag =
      acc < 0 ? static_cast<unsigned long long>(-acc)
              : static_cast<unsigned long long>(acc);
  const int nb = 63 - __clzll(static_cast<long long>(mag));
  const int e_val = exp - 30 + nb;
  const int mt = f.mant + 1;
  int keep = nb + 1 - mt;
  keep += max(f.min_exp - e_val, 0);
  const int keep_pos = max(keep, 0);
  unsigned long long q = keep_pos >= 48 ? 0ull : (mag >> keep_pos);
  const int rb_pos = max(keep_pos - 1, 0);
  const bool rb = keep_pos > 0 && ((mag >> min(rb_pos, 47)) & 1ull);
  const bool sticky =
      rb_pos >= 48 ? true : (mag & ((1ull << rb_pos) - 1ull)) != 0;
  if (rb && (sticky || (q & 1ull))) q += 1;
  int qi = static_cast<int>(q);
  if (keep < 0) qi <<= min(-keep, mt - 1);
  int e_q = e_val;
  if (qi >= (1 << mt)) {
    qi >>= 1;
    e_q += 1;
  }
  e_q = max(e_q, f.min_exp);
  const uint32_t top = sign_bit << (f.bits - 1);
  if (e_q > f.max_exp) {
    return top | (((1u << f.exp_bits) - 1u) << f.mant);
  }
  const uint32_t e_field =
      qi < (1 << f.mant) ? 0u : static_cast<uint32_t>(e_q + f.bias);
  return top | (e_field << f.mant) |
         (static_cast<uint32_t>(qi) & ((1u << f.mant) - 1u));
}

int stage_k(int g) { return (STAGE_K / g > 0 ? STAGE_K / g : 1) * g; }

template <bool FUSED, bool FLOOR>
__global__ void __launch_bounds__(THREADS)
mpmm_kernel(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
            void* __restrict__ out, int M, int N, int K, int g, int chunk,
            int w, int thresh, OutFormat fmt) {
  extern __shared__ int smem[];
  int* sA = smem;                  // [BM][chunk]
  int* sB = smem + BM * chunk;     // [chunk][BN]
  const int t = threadIdx.x;
  const int tx = t % BN;
  const int ty = t / BN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kp = (K + g - 1) / g * g;
  const int wf = min(w, 26);
  const int fused_lsh = max(wf - 22, 0);
  long long acc = 0;
  int exp_acc = NEG_INF_EXP;

  for (int k0 = 0; k0 < kp; k0 += chunk) {
    const int kc = min(chunk, kp - k0);   // whole groups
    for (int i = t; i < BM * kc; i += THREADS) {
      const int r = i / kc, c = i % kc;
      const int m = m0 + r, k = k0 + c;
      const uint16_t h = (m < M && k < K) ? A[(size_t)m * K + k] : 0;
      sA[r * chunk + c] = encode<FUSED>(h);
    }
    for (int i = t; i < kc * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      const uint16_t h = (k < K && n < N) ? B[(size_t)k * N + n] : 0;
      sB[r * BN + c] = encode<FUSED>(h);
    }
    __syncthreads();
    const int* arow = sA + ty * chunk;
    for (int gk = 0; gk < kc; gk += g) {
      // EHU: the group's largest product exponent
      int mx = INT_MIN;
      for (int k = gk; k < gk + g; ++k) {
        mx = max(mx, exp_of<FUSED>(arow[k]) + exp_of<FUSED>(sB[k * BN + tx]));
      }
      if (FUSED) {
        int s_tree = 0;
        for (int k = gk; k < gk + g; ++k) {
          const int a = arow[k], b = sB[k * BN + tx];
          const int sh = mx - (exp_of<true>(a) + exp_of<true>(b));
          if (sh > thresh) continue;
          const int d = (a >> 8) * (b >> 8);        // |d| < 2^22
          const int rs = sh + 22 - wf;
          int al = shr_i32<FLOOR>(d, max(rs, 0));
          if (rs < 0) al *= 1 << min(-rs, fused_lsh);
          s_tree += al;
        }
        accumulate<FLOOR>(acc, exp_acc, s_tree, mx, 1 + wf - w, w);
      } else {
        int s_tree[9];
#pragma unroll
        for (int p = 0; p < 9; ++p) s_tree[p] = 0;
        for (int k = gk; k < gk + g; ++k) {
          const int a = arow[k], b = sB[k * BN + tx];
          const int sh = mx - (exp_of<false>(a) + exp_of<false>(b));
          if (sh > thresh) continue;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const int ai = byte_at(a, i) * (1 << (w - 9));
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              s_tree[3 * i + j] += shr_i32<FLOOR>(ai * byte_at(b, j), sh);
            }
          }
        }
        // within a group the nine updates commute (only the first can
        // swap), so the iteration order of the config does not matter
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            accumulate<FLOOR>(acc, exp_acc, s_tree[3 * i + j], mx,
                              4 * (4 - i - j), w);
          }
        }
      }
    }
    __syncthreads();
  }

  const int m = m0 + ty, n = n0 + tx;
  if (m >= M || n >= N) return;
  const uint32_t bits = round_to_fp(acc, exp_acc, fmt);
  if (fmt.bits == 32) {
    static_cast<uint32_t*>(out)[(size_t)m * N + n] = bits;
  } else {
    static_cast<uint16_t*>(out)[(size_t)m * N + n] =
        static_cast<uint16_t>(bits);
  }
}

template <bool FUSED, bool FLOOR>
cudaError_t launch(const uint16_t* a, const uint16_t* b, void* out, int M,
                   int N, int K, int g, int w, int thresh, OutFormat fmt,
                   cudaStream_t s) {
  const int chunk = stage_k(g);
  const size_t smem = (size_t)(BM + BN) * chunk * sizeof(int);
  if (smem > SMEM_DEFAULT) {
    const cudaError_t err = cudaFuncSetAttribute(
        mpmm_kernel<FUSED, FLOOR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  mpmm_kernel<FUSED, FLOOR><<<grid, THREADS, smem, s>>>(
      a, b, out, M, N, K, g, chunk, w, thresh, fmt);
  return cudaGetLastError();
}

}  // namespace

// a (M, K) f16 and b (K, N) f16 as raw bits; out (M, N) in the accumulator
// format (out_exp_bits, out_mant_bits: fp32 8/23, fp16 5/10, bf16 8/7).
// g = IPUConfig.n, w = IPUConfig.w, thresh = IPUConfig.mask_threshold.
// Returns the launch's cudaError_t.
extern "C" int mpmm_launch(const void* a, const void* b, void* out, int M,
                           int N, int K, int g, int w, int thresh, int fused,
                           int floor_rounding, int out_exp_bits,
                           int out_mant_bits, void* stream) {
  OutFormat f;
  f.mant = out_mant_bits;
  f.exp_bits = out_exp_bits;
  f.bias = (1 << (out_exp_bits - 1)) - 1;
  f.min_exp = 1 - f.bias;
  f.max_exp = (1 << out_exp_bits) - 2 - f.bias;
  f.bits = 1 + out_exp_bits + out_mant_bits;
  const uint16_t* pa = static_cast<const uint16_t*>(a);
  const uint16_t* pb = static_cast<const uint16_t*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fused) {
    err = floor_rounding
              ? launch<true, true>(pa, pb, out, M, N, K, g, w, thresh, f, s)
              : launch<true, false>(pa, pb, out, M, N, K, g, w, thresh, f, s);
  } else {
    err = floor_rounding
              ? launch<false, true>(pa, pb, out, M, N, K, g, w, thresh, f, s)
              : launch<false, false>(pa, pb, out, M, N, K, g, w, thresh, f,
                                     s);
  }
  return static_cast<int>(err);
}
