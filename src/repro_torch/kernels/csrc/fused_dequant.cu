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
// fp8/fp4 codes decode by the same bit arithmetic as
// quant/quantize.py::fp_decode, for every code (0x7F is 480 in e4m3 here,
// not NaN), and never through the hardware fp8 type.
//
// Numerics and tolerance. Accumulation is FP32 FFMA on the CUDA cores, no
// tensor-core MMA (TF32 or bf16 operands would break the tolerance). The
// decode, the scale multiply and the act step are the same single-rounded
// f32 operations as kernels/ref.py::fused_dequant_mm_ref (IEEE x / sa and
// rintf: never build with --use_fast_math), so the only difference from
// the plain version is the order of summation. Both sums are within
// gamma_K * sum_k |x_k w_k| of the exact one (gamma_K = K u / (1 - K u),
// u = 2^-24), so they agree to 2 gamma_K * (|x'| @ |w'|) elementwise; that
// is the tolerance chip_smoke.py holds the kernel to. The order is fixed
// by the launch plan, so a launch repeated, or replayed from a CUDA
// graph, gives the same bits.
//
// Bound. One decode step of qwen2-0.5b at 8 slots (M = 8) runs this
// kernel on 24 layers x 7 projection shapes: 197.7 MB to read and write
// (int4 packed weights, f32 activations, outputs, scales) and 5.7 GFLOP.
// At 3.35 TB/s and 67 TFLOP/s (f32 on CUDA cores) that is at least
// 0.059 ms for the bytes and 0.085 ms for the operations: f32 FFMA
// operations bound it at M = 8, bytes at M = 1 and at the narrow
// projections (N = 128). The first version of this file (one 32 x 32
// tile kernel for every M) took 43.0-43.3 ms for that step replayed from
// a CUDA graph, 510x the bound; this one takes 1.34-1.35 ms, 16x (NVIDIA
// H100 80GB HBM3, 700.00 W; chip_smoke.py). What is left is latency: a
// launch of a small projection takes 5.6-6.8 us, most of it the launch,
// the first weight bytes' trip from memory and the cluster's reduction.
//
// Design: decode_mm_kernel, launched with a plan chosen by
// kernels/fused.py::plan_fused_dequant. Against what held the first
// version back:
//   * Wasted tile: the rows live in registers. A block takes a chunk of
//     MR rows, MR the least power of two >= M up to 16 (more rows take
//     several chunks), and each thread keeps acc[MR][4] for four
//     consecutive columns, so a decode step multiplies no empty 32-row
//     tile. Each weight element is decoded once, multiplied by its scale
//     once, and used from a register for all MR rows.
//   * Too few blocks: a block covers BN (128, 64 or 32) columns and one
//     of up to 8 K ranges, and its 8 warps split that range again; the
//     plan fills up to two blocks per SM.
//   * No overlap: the weight range streams through an 8-stage cp.async
//     ring of 4 KB stages (16-byte copies, neighbouring threads on
//     neighbouring addresses); the act step of the block's activation
//     slice runs once, while the first stages are in flight, into
//     shared memory (k-major, so a thread reads its MR values with
//     vector loads).
//   * Byte-wide weight loads: each thread reads one 32-bit word of the
//     staged tile per k-row (4 columns); for the packed kinds that word
//     holds both k-rows of 4 columns, so no byte is read twice. A scale
//     is read from memory once per (group, column) a thread meets.
//   * Repeated activation step: a block steps only its own K range, once.
// Split-K is deterministic and one launch: the K ranges of one tile form
// a thread block cluster. Each block owns an equal share of the tile's
// outputs, and every block stores its partial sums into their owners'
// shared memory (distributed shared memory), one slot per split; after
// one cluster barrier each owner adds its slots in split order, applies
// quant's x sa and writes out. No workspace, no atomics, no memset. A
// version that summed the partials through a global workspace, the last
// block of a tile taking a ticket from a counter, took 1.78 ms for the
// step: the partials' round trips through L2 cost more than the cluster.
//
// Large M (prefill waves) takes the same kernel on chunks of 16 rows:
// 0.44 ms for one 256-row layer of qwen2-0.5b, replayed from a CUDA
// graph, where the first version's tile kernel took 1.97 ms (same card
// and script).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

enum Kind { INT8 = 0, INT4 = 1, INT4_PACKED = 2, FP8 = 3, FP4 = 4,
            FP4_PACKED = 5 };
enum Act { ACT_NONE = 0, ACT_QDQ = 1, ACT_QUANT = 2 };

__host__ __device__ constexpr bool is_packed(int kind) {
  return kind == INT4_PACKED || kind == FP4_PACKED;
}

// Decoding without int-to-float conversions, which Hopper issues at a
// quarter of the FFMA rate (one per weight element would cap the main
// loop). An f32 whose bits are 0x4B4000bb is 1.5 * 2^23 + bb exactly, so
// a byte becomes a float with a byte permute and an exact subtraction.
constexpr uint32_t kMagic = 0x4B400000u;
constexpr float kMagicF = 12582912.0f;

// byte C of v as 1.5 * 2^23 + byte
template <int C>
__device__ __forceinline__ float byte_f(uint32_t v) {
  return __uint_as_float(__byte_perm(v, kMagic, 0x7640 | C));
}

// bits of v moved from position FROM to position TO, then masked
template <int FROM, int TO>
__device__ __forceinline__ uint32_t move_bits(uint32_t v, uint32_t mask) {
  return (TO >= FROM ? v << (TO - FROM) : v >> (FROM - TO)) & mask;
}

// quant/quantize.py::fp_decode by bit construction. t holds the code's
// exponent and mantissa fields where an f32 keeps them (ef << 23 |
// man << (23 - MB)), sign the sign bit at bit 31. A normal code is
// (1 + man / 2^MB) 2^(ef - BIAS): t with the exponent rebiased. A
// subnormal one is man * 2^(1 - BIAS - MB), exactly (1 + man / 2^MB)
// 2^(1 - BIAS) - 2^(1 - BIAS). The sign goes on last (code 0 with the
// sign set is -0, as there); every code decodes, 0x7F of e4m3 to 480.
template <int MB, int BIAS>
__device__ __forceinline__ float fp_fields(uint32_t t, uint32_t sign) {
  constexpr uint32_t kSubBase = (128u - BIAS) << 23;   // 2^(1 - BIAS)
  const float v = t >= (1u << 23)
                      ? __uint_as_float(t + ((127u - BIAS) << 23))
                      : __uint_as_float(kSubBase | t) -
                            __uint_as_float(kSubBase);
  return __uint_as_float(__float_as_uint(v) | sign);
}

// the value of column C (byte C) of a stored 32-bit word; HI picks the
// packed kinds' high nibble (the odd k-row)
template <int KIND, bool HI, int C>
__device__ __forceinline__ float decode_col(uint32_t word) {
  if (KIND == INT8 || KIND == INT4) {           // signed bytes
    return byte_f<C>(word ^ 0x80808080u) - (kMagicF + 128.0f);
  } else if (KIND == INT4_PACKED) {             // signed nibbles
    const uint32_t v = ((HI ? word >> 4 : word) & 0x0F0F0F0Fu) ^ 0x08080808u;
    return byte_f<C>(v) - (kMagicF + 8.0f);
  } else if (KIND == FP8) {                     // e4m3, bias 7
    return fp_fields<3, 7>(move_bits<8 * C, 20>(word, 0x7Fu << 20),
                           move_bits<8 * C + 7, 31>(word, 1u << 31));
  } else {                                      // e2m1 codes, bias 1
    const uint32_t v = KIND == FP4_PACKED && HI ? word >> 4 : word;
    return fp_fields<1, 1>(move_bits<8 * C, 22>(v, 0x7u << 22),
                           move_bits<8 * C + 3, 31>(v, 1u << 31));
  }
}

// the act step of one activation, as kernels/ref.py orders it
__device__ __forceinline__ float act_step(float v, int act, float sa) {
  if (act == ACT_NONE) return v;
  float q = rintf(v / sa);
  q = fminf(fmaxf(q, -128.0f), 127.0f);
  return act == ACT_QDQ ? q * sa : q;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// ------------------------------------------------- decode_mm_kernel

constexpr int THREADS = 256;
constexpr int STAGES = 8;
constexpr int STAGE_BYTES = 4096;      // one stage of stored weight bytes
constexpr int ROWS_PER_LANE = 4;       // stored rows a k-lane takes a stage
constexpr int X_SLICE_BYTES = 147456;  // the block's act slice, at most
constexpr int MAX_ROWS = 16;
constexpr int MAX_BN = 128;
constexpr int MAX_SPLITS = 8;          // a portable cluster
constexpr int K_STEP = 32;             // a split's k-rows: a multiple
constexpr int MAX_SMEM = X_SLICE_BYTES + STAGES * STAGE_BYTES +
                         (MAX_ROWS * MAX_BN + MAX_SPLITS) * 4;
static_assert(THREADS * MAX_ROWS * 16 <= X_SLICE_BYTES, "reduction fits");
static_assert(MAX_SMEM <= 232448, "one block's shared memory");

// Copy stage `stage` of this block's stored rows [r0, r1) (columns
// [n0, n0 + bn)) into `dst`, zero past r1 and past N, `vec` bytes a copy:
// 16 or 4 through cp.async (the wrapper checked the pointer and the row
// stride), 1 as plain loads and stores.
__device__ __forceinline__ void load_stage(uint8_t* dst,
                                           const uint8_t* __restrict__ w,
                                           int stage, int r0, int r1, int N,
                                           int n0, int bn, int bn_shift,
                                           int vec) {
  const int rows = STAGE_BYTES >> bn_shift;
  const int row0 = r0 + stage * rows;
  if (vec == 16) {
    const int cshift = bn_shift - 4;
    for (int i = threadIdx.x; i < STAGE_BYTES / 16; i += THREADS) {
      const int r = i >> cshift, c = (i - (r << cshift)) << 4;
      const bool ok = row0 + r < r1 && n0 + c < N;
      cp_async16(dst + (r << bn_shift) + c,
                 ok ? w + (size_t)(row0 + r) * N + n0 + c : w, ok ? 16 : 0);
    }
  } else if (vec == 4) {
    const int cshift = bn_shift - 2;
    for (int i = threadIdx.x; i < STAGE_BYTES / 4; i += THREADS) {
      const int r = i >> cshift, c = (i - (r << cshift)) << 2;
      const bool ok = row0 + r < r1 && n0 + c < N;
      cp_async4(dst + (r << bn_shift) + c,
                ok ? w + (size_t)(row0 + r) * N + n0 + c : w, ok ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < STAGE_BYTES; i += THREADS) {
      const int r = i >> bn_shift, c = i - (r << bn_shift);
      const bool ok = row0 + r < r1 && n0 + c < N;
      dst[i] = ok ? w[(size_t)(row0 + r) * N + n0 + c] : uint8_t(0);
    }
  }
}

// acc[m][c] += xs[m] * wv[c] for MR activations at xs (16-byte aligned
// when MR % 4 == 0)
template <int MR>
__device__ __forceinline__ void fma_row(float (&acc)[MR][4],
                                        const float* xs,
                                        const float (&wv)[4]) {
  float xa[MR];
  if (MR % 4 == 0) {
#pragma unroll
    for (int q = 0; q < MR / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(xs)[q];
      xa[4 * q] = v.x;
      xa[4 * q + 1] = v.y;
      xa[4 * q + 2] = v.z;
      xa[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < MR; ++m) xa[m] = xs[m];
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xa[m], wv[c], acc[m][c]);
  }
}

// sc = row k / g of sw at columns n..n+3 (0 past N); gend = the first k
// of the next scale group
__device__ __forceinline__ void load_scales(int k, int g,
                                            const float* __restrict__ sw,
                                            int N, int n, float (&sc)[4],
                                            int& gend) {
  const int grp = k / g;
  gend = (grp + 1) * g;
  const float* s = sw + (size_t)grp * N + n;
#pragma unroll
  for (int c = 0; c < 4; ++c) sc[c] = n + c < N ? __ldg(s + c) : 0.0f;
}

// wv = the four columns of k-row k in `word`, decoded and times their
// scales sc. A thread's k only grows, so it reloads sc only where a
// scale group ends.
template <int KIND, bool HI>
__device__ __forceinline__ void scale_row(uint32_t word, int k, int g,
                                          const float* __restrict__ sw,
                                          int N, int n, float (&sc)[4],
                                          int& gend, float (&wv)[4]) {
  if (k >= gend) load_scales(k, g, sw, N, n, sc, gend);
  wv[0] = decode_col<KIND, HI, 0>(word) * sc[0];
  wv[1] = decode_col<KIND, HI, 1>(word) * sc[1];
  wv[2] = decode_col<KIND, HI, 2>(word) * sc[2];
  wv[3] = decode_col<KIND, HI, 3>(word) * sc[3];
}

// v[u][m] = x[m][k + u * THREADS] for the XU k-rows a thread stages in
// one pass (0 past k1 and past M)
template <int MR, int XU>
__device__ __forceinline__ void load_x(float (&v)[XU][MR],
                                       const float* __restrict__ x, int k,
                                       int k1, int M, int K) {
#pragma unroll
  for (int u = 0; u < XU; ++u) {
    const int ku = k + u * THREADS;
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      v[u][m] = (m < M && ku < k1) ? x[(size_t)m * K + ku] : 0.0f;
    }
  }
}

// One block: columns [n0, n0 + bn) (blockIdx.x) over k-rows
// [k0, k0 + kc) (blockIdx.y, the split) for MR rows (blockIdx.z). Thread
// t takes the four columns 4 * (t % (bn / 4)) and k-lane t / (bn / 4):
// stored row r of a stage belongs to lane r % lanes. The splits of one
// (column tile, row chunk) form one thread block cluster.
template <int KIND, int MR>
__global__ void __launch_bounds__(THREADS)
decode_mm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ sw,
                 const float* __restrict__ sa_ptr, float* __restrict__ out,
                 int M, int N, int K, int g, int act, int bn, int bn_shift,
                 int kc, int vec) {
  constexpr int PK = is_packed(KIND) ? 2 : 1;   // k-rows per stored row
  extern __shared__ __align__(16) uint8_t smem[];
  const int m0 = blockIdx.z * MR;
  x += (size_t)m0 * K;
  out += (size_t)m0 * N;
  M = min(MR, M - m0);
  const int t = threadIdx.x;
  const int lane_shift = bn_shift - 2;             // bn / 4 threads a row
  const int tn = t & ((bn >> 2) - 1);
  const int kl = t >> lane_shift;
  const int lanes = THREADS >> lane_shift;
  const int n0 = blockIdx.x * bn;
  const int n = n0 + 4 * tn;
  const int k0 = blockIdx.y * kc;
  const int k1 = min(K, k0 + kc);
  const int r0 = k0 / PK, r1 = k1 / PK;           // stored rows
  const int stage_rows = STAGE_BYTES >> bn_shift;
  const int n_stages = (r1 - r0 + stage_rows - 1) / stage_rows;
  const int kcs = n_stages * stage_rows * PK;      // k-rows of the slice
  float* xs = reinterpret_cast<float*>(smem);      // [kcs][MR]
  uint8_t* ring = smem + (size_t)kcs * MR * 4;
  const float sa = act == ACT_NONE ? 1.0f : *sa_ptr;
  // with K split, every block of the cluster will write into the others'
  // shared memory: it signals now that it has started, and waits for the
  // others' signals before its first remote store
  if (gridDim.y > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) {
      load_stage(ring + s * STAGE_BYTES, w, s, r0, r1, N, n0, bn, bn_shift,
                 vec);
    }
    cp_async_commit();
  }
  float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int gend = k1;                         // the first k past the scales held
  if (k0 < k1) load_scales(k0, g, sw, N, n, sc, gend);   // early, for k0

  // the act step, once per activation of the slice, while they land;
  // XU k-rows per thread a pass, their loads issued before any division
  constexpr int XU = MR >= 16 ? 2 : 32 / MR;
  for (int kb = t; kb < kcs; kb += XU * THREADS) {
    float v[XU][MR];
    load_x<MR, XU>(v, x, k0 + kb, k1, M, K);
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int kk = kb + u * THREADS;
      if (kk >= kcs) break;
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        if (m < M && k0 + kk < k1) v[u][m] = act_step(v[u][m], act, sa);
      }
      float* dst = xs + (size_t)kk * MR;
      if (MR % 4 == 0) {
#pragma unroll
        for (int q = 0; q < MR / 4; ++q) {
          reinterpret_cast<float4*>(dst)[q] =
              make_float4(v[u][4 * q], v[u][4 * q + 1], v[u][4 * q + 2],
                          v[u][4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int m = 0; m < MR; ++m) dst[m] = v[u][m];
      }
    }
  }

  float acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < n_stages) {
      load_stage(ring + ((i + STAGES - 1) % STAGES) * STAGE_BYTES, w,
                 i + STAGES - 1, r0, r1, N, n0, bn, bn_shift, vec);
    }
    cp_async_commit();
    const uint8_t* st = ring + (i % STAGES) * STAGE_BYTES;
    const int valid = min(stage_rows, r1 - r0 - i * stage_rows);
#pragma unroll
    for (int j = 0; j < ROWS_PER_LANE; ++j) {
      const int r = kl + j * lanes;
      if (r >= valid) break;
      const uint32_t word =
          *reinterpret_cast<const uint32_t*>(st + (r << bn_shift) + 4 * tn);
      const int kk = (i * stage_rows + r) * PK;   // k-row in the slice
      float wv[4];
      scale_row<KIND, false>(word, k0 + kk, g, sw, N, n, sc, gend, wv);
      fma_row<MR>(acc, xs + (size_t)kk * MR, wv);
      if (PK == 2) {
        scale_row<KIND, true>(word, k0 + kk + 1, g, sw, N, n, sc, gend, wv);
        fma_row<MR>(acc, xs + (size_t)(kk + 1) * MR, wv);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the k-lanes' sums, added in lane order: the block's partial tile
  float* red = reinterpret_cast<float*>(smem);       // [lanes][MR][bn]
  // [splits][share] slots, at the same offset in every block of the
  // cluster: past the slice of a full K range and the ring, or past red
  const int kcs_full = (kc / PK + stage_rows - 1) / stage_rows * stage_rows * PK;
  float* part = reinterpret_cast<float*>(
      smem + max((size_t)kcs_full * MR * 4 + STAGES * STAGE_BYTES,
                 (size_t)THREADS * MR * 16));
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    reinterpret_cast<float4*>(red + (size_t)(kl * MR + m) * bn)[tn] =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  const int splits = gridDim.y;
  const float post = act == ACT_QUANT ? sa : 1.0f;
  // with K split, block `split` of the cluster owns outputs [split *
  // share, (split + 1) * share) of the tile; every block stores its sum
  // of each output into slot `split` of the output's owner
  const int split = blockIdx.y;
  const int share = (M * bn + splits - 1) / splits;
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::);
  for (int o = t; o < M * bn; o += THREADS) {
    const int m = o >> bn_shift, c = o - (m << bn_shift);
    float s = red[o];                      // lane l at o + l * MR * bn
    for (int l = 1; l < lanes; l += 8) {   // 8 loads in flight
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u] = l + u < lanes ? red[(size_t)(l + u) * MR * bn + o] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (l + u < lanes) s += v[u];
      }
    }
    if (splits > 1) {
      const int owner = o / share;
      cluster.map_shared_rank(part, owner)[split * share + o - owner * share] = s;
    } else if (n0 + c < N) {
      out[(size_t)m * N + n0 + c] = act == ACT_QUANT ? s * post : s;
    }
  }
  if (splits == 1) return;

  // a cluster barrier (release, acquire), then each block adds its
  // share's slots in split order (the same order whichever block owns
  // it) and writes out; no block reads another's memory after it
  cluster.sync();
  const int o0 = split * share;
  for (int i = t; i < share && o0 + i < M * bn; i += THREADS) {
    const int o = o0 + i;
    const int m = o >> bn_shift, c = o - (m << bn_shift);
    float s = part[i];
    for (int q = 1; q < splits; ++q) s += part[q * share + i];
    if (n0 + c < N) out[(size_t)m * N + n0 + c] = act == ACT_QUANT ? s * post : s;
  }
}

// ------------------------------------------------- launch

struct Args {
  const float* x;
  const uint8_t* w;
  const float* sw;
  const float* sa;
  float* out;
  int M, N, K, g, act;
};

template <int KIND, int MR>
cudaError_t launch_rows(const Args& a, dim3 grid, size_t smem, int bn,
                        int bn_shift, int kc, int vec, cudaStream_t s) {
  // above 48 KB of shared memory a kernel must ask first: it asks once
  // per device for the most it may use
  static unsigned long long ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!((ready >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(decode_mm_kernel<KIND, MR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return err;
    ready |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;       // the splits of one tile
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_mm_kernel<KIND, MR>, a.x, a.w, a.sw,
                            a.sa, a.out, a.M, a.N, a.K, a.g, a.act, bn,
                            bn_shift, kc, vec);
}

template <int KIND>
cudaError_t launch_kind(const Args& a, int rows, int bn, int splits, int kc,
                        int vec, cudaStream_t s) {
  const int bn_shift = bn == 128 ? 7 : bn == 64 ? 6 : 5;
  const int stage_k = (STAGE_BYTES >> bn_shift) * (is_packed(KIND) ? 2 : 1);
  const size_t kcs = (size_t)((kc + stage_k - 1) / stage_k) * stage_k;
  const size_t x_bytes = kcs * rows * 4;
  if (x_bytes > X_SLICE_BYTES) return cudaErrorInvalidValue;
  const size_t red_bytes = (size_t)THREADS * rows * 16;
  const size_t ring_end = x_bytes + STAGES * STAGE_BYTES;
  const size_t smem = (ring_end > red_bytes ? ring_end : red_bytes) +
                      ((size_t)rows * bn + MAX_SPLITS) * 4;
  const dim3 grid((a.N + bn - 1) / bn, splits, (a.M + rows - 1) / rows);
  switch (rows) {
    case 1: return launch_rows<KIND, 1>(a, grid, smem, bn, bn_shift, kc, vec, s);
    case 2: return launch_rows<KIND, 2>(a, grid, smem, bn, bn_shift, kc, vec, s);
    case 4: return launch_rows<KIND, 4>(a, grid, smem, bn, bn_shift, kc, vec, s);
    case 8: return launch_rows<KIND, 8>(a, grid, smem, bn, bn_shift, kc, vec, s);
    default: return launch_rows<KIND, 16>(a, grid, smem, bn, bn_shift, kc, vec, s);
  }
}

}  // namespace

// x (M, K) f32; w the stored operand ((K, N), or (K/2, N) for the packed
// kinds); sw (G, N) f32 with K % G == 0; sa a device pointer to one f32
// (unused, may be null, when act is none); out (M, N) f32. kind and act
// take the enum values above. The plan (kernels/fused.py::FusedPlan):
// chunks of `rows` rows (1, 2, 4, 8 or 16), bn columns a block (32, 64
// or 128) and `splits` K ranges (at most 8: one cluster) of kc k-rows (a
// multiple of 32, only the last one ragged, the act slice within its
// bound), the weight copied `vec` bytes at a time (16 or 4: the pointer
// and N must allow it; 1 always works). Returns the launch's
// cudaError_t, or cudaErrorInvalidValue for arguments out of range.
extern "C" int fused_dequant_launch(const void* x, const void* w,
                                    const void* sw, const void* sa, void* out,
                                    int M, int N, int K, int G, int kind,
                                    int act, int rows, int bn, int splits,
                                    int kc, int vec, void* stream) {
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  const bool plan_ok =
      (rows == 1 || rows == 2 || rows == 4 || rows == 8 || rows == 16) &&
      (M + rows - 1) / rows <= 65535 && (bn == 32 || bn == 64 || bn == 128) &&
      kc >= K_STEP && kc % K_STEP == 0 && splits >= 1 &&
      splits <= MAX_SPLITS && (long long)splits * kc >= K &&
      (splits == 1 || (long long)(splits - 1) * kc < K) &&
      (vec == 1 || (vec == 4 && (wp | (uintptr_t)N) % 4 == 0) ||
       (vec == 16 && (wp | (uintptr_t)N) % 16 == 0));
  if (kind < INT8 || kind > FP4_PACKED || act < ACT_NONE || act > ACT_QUANT ||
      G < 1 || K % G != 0 || M < 1 || N < 1 || (act != ACT_NONE && !sa) ||
      !plan_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(x), static_cast<const uint8_t*>(w),
               static_cast<const float*>(sw), static_cast<const float*>(sa),
               static_cast<float*>(out), M, N, K, K / G, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case INT8: err = launch_kind<INT8>(a, rows, bn, splits, kc, vec, s); break;
    case INT4: err = launch_kind<INT4>(a, rows, bn, splits, kc, vec, s); break;
    case INT4_PACKED: err = launch_kind<INT4_PACKED>(a, rows, bn, splits, kc, vec, s); break;
    case FP8: err = launch_kind<FP8>(a, rows, bn, splits, kc, vec, s); break;
    case FP4: err = launch_kind<FP4>(a, rows, bn, splits, kc, vec, s); break;
    default: err = launch_kind<FP4_PACKED>(a, rows, bn, splits, kc, vec, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
