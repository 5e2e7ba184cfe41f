// Exact integer matrix products for Hopper (sm_90a), written by hand.
//
// Replaces three Pallas TPU kernels of the reference package:
//   * repro/kernels/qmm.py::_qmm_kernel         int8 x int8 -> int32
//   * repro/kernels/qmm.py::_qmm_packed_kernel  int8 x packed int4 -> int32
//   * repro/kernels/fused.py::_fused_qmm_kernel f32 acts quantized against
//     the static scale sa in the block, int8 or packed-int4 weights, int32
//     accumulation, epilogue (acc * sa) * sw[n]
// qmm runs its own kernel on the int8 tensor cores (qmm_tc_kernel, with
// its own note below). qmm_packed and fused_qmm share the __dp4a template
// int_mm_kernel (FUSED: quantize step + epilogue; PACKED: nibble unpack of
// the weight tile).
//
// int_mm_kernel. The TPU kernels walk a sequential k grid axis and
// revisit the output block; here each thread block owns one (BM, BN)
// output tile and loops over K itself, so nothing carries between
// blocks. Ragged M/N/K edges are masked on load (zeros contribute nothing
// to an integer sum) and on store, so the wrapper never pads a copy. The
// weight tile is stored transposed in shared memory (k contiguous per
// column) so that one 32-bit word holds four consecutive k of one column,
// and the activation tile row-major for the same reason: __dp4a then does
// four int8 multiply-adds into an int32 accumulator per instruction.
// Integer arithmetic is exact in any order, so the result is bit-equal to
// kernels/ref.py (qmm_ref, fused_qmm_ref).
//
// Exactness of the fused step. The activation quantize is
// clamp(__float2int_rn(x / sa), -128, 127): IEEE division (this file must
// never be built with --use_fast_math) and round-half-to-even, the same as
// jnp.round(x / sa) / torch.round. The epilogue is two separate f32
// multiplies in the reference's order, ((float)acc * sa) * sw[n].
//
// Bound of int_mm_kernel. At the decode shape (M = 8 slots) these kernels
// do far fewer operations per byte than the card's int8 rate needs, so
// the least time is the bytes read (weights once, activations once) and
// written over the memory bandwidth: one decode step of qwen2-0.5b
// (24 layers x 7 projections) moves 190.6 MB through qmm_packed and
// 376.6 MB through fused_qmm, 0.057 and 0.112 ms at 3.35 TB/s. This
// template takes 8.9 and 16.7 ms (NVIDIA H100 80GB HBM3, 700 W;
// chip_smoke.py): few blocks at N = 896, a 32-row tile for 8 rows, and
// one byte loaded per thread with nothing in flight across the K loop.
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

// ------------------------------------------------------------------ qmm
//
// qmm_tc_kernel: int8 x int8 -> int32 on the int8 tensor cores. Replaces
// repro/kernels/qmm.py::_qmm_kernel; bit-equal to kernels/ref.py qmm_ref.
//
// Bound. At the decode shape (M = 8) the work is bytes: one decode step
// of qwen2-0.5b (168 projections) reads 357.8 MB of int8 weights, 0.1103
// ms at 3.35 TB/s, against 5.7 GOP of int8 operations (0.003 ms). At a
// 256-row prefill wave one layer moves 30.5 MB (about 9 us) against 7.6
// GOP on the tensor cores (about 3.9 us at 1979 TOP/s): bytes again. The
// __dp4a template above reached 28 GB/s at decode. What this design does:
//
// * mma.sync m16n8k32 s8 (no .satfinite: the s32 sum wraps mod 2^32, as
//   the reference's and qmm_ref's do), in the swapped orientation
//   out^T = W^T A^T. The weight tile is the MMA's A operand (16 n x 32 k)
//   and the activations its B operand (32 k x 8 m), whose "col" layout is
//   the activations' own row-major (M, K): 8 decode rows fill n8 exactly.
//   A warp carries MT m8-tiles (MT = 1, 2, 4) and reuses each weight
//   fragment across them; a grid axis over m takes larger M. Both MT
//   and the block width are template parameters, so every offset of the
//   inner loop is a constant.
// * The weight is (K, N), N contiguous, but an A fragment register holds
//   four consecutive k of one row. A warp covers 32 n as two m16 tiles
//   whose rows are permuted: tile 0 row g is n = 4g, row g+8 is 4g+1, tile
//   1 rows g and g+8 are 4g+2 and 4g+3. Thread (g, t) then reads one word
//   (n = 4g..4g+3) from each of k-rows 4t..4t+3 and a 4x4 byte transpose
//   (eight __byte_perm) yields a0/a1 of both tiles; k-rows 16+4t.. give
//   a2/a3. The C fragments come back as 4 consecutive n for each of 2
//   rows m: one 16-byte store each. Shared rows carry 32 bytes of padding
//   after every 4 rows, so the 4 k-rows a quad reads fall in 4 distinct
//   8-bank groups; activation rows are padded to 80 bytes (20 words), so
//   8 rows x 4 words hit 32 banks.
// * cp.async staging in a ring of STAGES = 4 slots of BK = 64 k-rows:
//   copies of three slots are in flight while one is multiplied. Where
//   both operands' pointers and row strides are 16-byte aligned (every
//   projection of the models), a template path copies with cp.async.cg
//   16 bytes (src-size zero-fill at ragged edges), and each thread's
//   chunks, addresses and edge sizes are fixed for the whole K loop, so
//   a stage costs a few adds: with a division per chunk and the copy
//   width chosen at run time, a warp's loop is bound by the latency of
//   those instructions (measured on an H100: no faster from L2 than
//   from DRAM), not by memory.
//   Otherwise 4-byte copies (cp.async.ca) where the operand is 4-byte
//   aligned, plain byte loads below that (odd N or K, or a pointer off
//   by one). The wrapper passes the alignment it found.
// * Split-K for narrow N: grid z splits [0, K) into ranges of kc (a
//   multiple of 32). With more than one split every block adds its
//   partial sums to an output the wrapper zeroed, with int32 atomicAdd:
//   integer addition wraps associatively, so the result is bit-exact in
//   any order. The plan (MT, block width BN = 32, 64 or 128 columns with
//   one warp per 32, splits, kc) is chosen in Python (kernels/qmm.py,
//   plan_qmm) for about one block per SM, which took less time in total
//   than two or four per SM (chip_smoke.py phase 2, "qmm_plans_us").
//
// What holds it back now: at decode each launch costs a few us however
// few its bytes (launch latency, the ramp of a one-wave grid, and the
// zeroing of the output that a split plan needs, a kernel of its own),
// so the four small projections of a layer sit near that floor and the
// three 4.4 MB ones at a fraction of the memory rate. A ring deeper
// than 4 stages did not help there. wgmma and TMA would matter once the
// MMA rate and not bytes or latency bound it (prefill waves of many
// rows).

namespace tc {

constexpr int BK = 64;             // k-rows per stage: two mma k-steps
constexpr int STAGES = 4;
constexpr int A_STRIDE = BK + 16;  // activation row in shared memory

__host__ __device__ constexpr int w_stage_bytes(int bn) {
  return BK * bn + (BK / 4) * 32;
}
__host__ __device__ constexpr int a_stage_bytes(int mt) {
  return 8 * mt * A_STRIDE;
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
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

// w[j] holds bytes (r_j, c0..c3) of a 4x4 byte block; afterwards w[i]
// holds (r0..r3, c_i)
__device__ __forceinline__ void transpose4x4(uint32_t w[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void mma_s8(int c[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copy rows [0, rows) x bytes [0, width) of a row-major int8 operand
// (row stride ld, rows at or past row_end and bytes at or past col_end
// read as zero) into shared memory at dst with row offsets row_off(r),
// at the copy width vec the operand's alignment allows. The path for
// operands that are not both 16-byte aligned: runtime widths, a division
// per chunk.
template <typename RowOff>
__device__ __forceinline__ void stage_copy(uint8_t* dst, const int8_t* src,
                                           size_t ld, int rows, int width,
                                           int row_end, int col_end, int vec,
                                           RowOff row_off) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (vec == 16) {
    const int cpr = width / 16;
    for (int i = tid; i < rows * cpr; i += nt) {
      const int r = i / cpr, c = 16 * (i - r * cpr);
      const int bytes = r < row_end ? clampi(col_end - c, 0, 16) : 0;
      cp_async16(dst + row_off(r) + c, bytes ? src + r * ld + c : src, bytes);
    }
  } else if (vec == 4) {
    const int cpr = width / 4;
    for (int i = tid; i < rows * cpr; i += nt) {
      const int r = i / cpr, c = 4 * (i - r * cpr);
      const int bytes = r < row_end ? clampi(col_end - c, 0, 4) : 0;
      cp_async4(dst + row_off(r) + c, bytes ? src + r * ld + c : src, bytes);
    }
  } else {
    for (int i = tid; i < rows * width; i += nt) {
      const int r = i / width, c = i - r * width;
      dst[row_off(r) + c] =
          (r < row_end && c < col_end) ? src[r * ld + c] : int8_t(0);
    }
  }
}

// byte offset of weight k-row r in a stage of BN columns
template <int BN>
__device__ __forceinline__ constexpr int w_off(int r) {
  return r * BN + (r >> 2) * 32;
}

// The fast path, both operands 16-byte aligned: every thread copies the
// same chunks of every stage (BK / 16 weight chunks of one 16-byte
// column, and its share of the activation chunks), so their addresses
// and edge sizes are worked out once and a stage costs a few adds and
// its cp.async instructions.
template <int MT, int BN>
struct FastCopy {
  static constexpr int W_CHUNKS = BK / 16;            // per thread
  static constexpr int A_CHUNKS = 8 * MT * (BK / 16);  // per block
  static constexpr int A_PER_THREAD = (A_CHUNKS + BN - 1) / BN;
  const int8_t* a;         // operand bases: the source of empty copies
  const int8_t* w;
  const int8_t* wsrc;      // this thread's column at k-row kb + wr
  int wdst, wr, wbytes;    // its shared offset, first row, column bytes
  const int8_t* asrc[A_PER_THREAD];
  int adst[A_PER_THREAD], ac[A_PER_THREAD];
  bool arow[A_PER_THREAD];  // the chunk is this thread's and its row < M

  __device__ __forceinline__ FastCopy(const int8_t* a_, const int8_t* w_,
                                      int M, int N, int K, int m0, int n0,
                                      int kb)
      : a(a_), w(w_) {
    constexpr int CPR = BN / 16;
    const int tid = threadIdx.x;
    wr = tid / CPR;
    const int c = 16 * (tid % CPR);
    wbytes = clampi(N - n0 - c, 0, 16);
    wsrc = w + (size_t)(kb + wr) * N + n0 + c;
    wdst = w_off<BN>(wr) + c;
#pragma unroll
    for (int j = 0; j < A_PER_THREAD; ++j) {
      const int i = tid + j * BN;
      const int r = i / (BK / 16), cc = 16 * (i % (BK / 16));
      ac[j] = cc;
      arow[j] = i < A_CHUNKS && m0 + r < M;
      asrc[j] = a + (size_t)(m0 + r) * K + kb + cc;
      adst[j] = r * A_STRIDE + cc;
    }
  }

  // stage s: k-rows [kb + s*BK, kb + (s+1)*BK), zero at or past ke
  __device__ __forceinline__ void load(uint8_t* ws, uint8_t* as, int s,
                                       int kb, int ke, int N) const {
    const int k0 = kb + s * BK;
#pragma unroll
    for (int j = 0; j < W_CHUNKS; ++j) {
      const int bytes = k0 + wr + 16 * j < ke ? wbytes : 0;
      cp_async16(ws + wdst + j * (16 * BN + 128),
                 bytes ? wsrc + (size_t)(s * BK + 16 * j) * N : w, bytes);
    }
#pragma unroll
    for (int j = 0; j < A_PER_THREAD; ++j) {
      if (A_CHUNKS % BN != 0 && threadIdx.x + j * BN >= A_CHUNKS) break;
      const int bytes = arow[j] ? clampi(ke - k0 - ac[j], 0, 16) : 0;
      cp_async16(as + adst[j], bytes ? asrc[j] + s * BK : a, bytes);
    }
  }
};

template <int MT, int BN, bool FAST>
__global__ void __launch_bounds__(BN)
qmm_tc_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
              int32_t* __restrict__ out, int M, int N, int K, int kc,
              int a_vec, int w_vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int WSB = w_stage_bytes(BN), ASB = a_stage_bytes(MT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * 8 * MT;
  const int kb = blockIdx.z * kc;
  const int ke = min(K, kb + kc);
  const int nst = max(0, (ke - kb + BK - 1) / BK);
  uint8_t* ws = smem;
  uint8_t* as = smem + STAGES * WSB;

  const FastCopy<MT, BN> fast(a, w, M, N, K, m0, n0, kb);
  auto load = [&](int s) {
    const int slot = s % STAGES;
    if constexpr (FAST) {
      fast.load(ws + slot * WSB, as + slot * ASB, s, kb, ke, N);
    } else {
      const int k0 = kb + s * BK;
      stage_copy(ws + slot * WSB, w + (size_t)k0 * N + n0, (size_t)N, BK,
                 BN, ke - k0, N - n0, w_vec,
                 [](int r) { return w_off<BN>(r); });
      stage_copy(as + slot * ASB, a + (size_t)m0 * K + k0, (size_t)K, 8 * MT,
                 BK, M - m0, ke - k0, a_vec,
                 [](int r) { return r * A_STRIDE; });
    }
  };

  int acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }
  // this thread's words: column 4g of its warp's 32, k-rows 4t + j (and
  // + 16) of each k-step; activation row g, bytes 4t of each k-step
  const int wbase = warp * 32 + 4 * g + w_off<BN>(4 * t);
  const int abase = g * A_STRIDE + 4 * t;
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();              // slot it ready; slot it-1 free
    if (it + STAGES - 1 < nst) load(it + STAGES - 1);
    cp_async_commit();
    const int slot = it % STAGES;
    const uint8_t* wsl = ws + slot * WSB + wbase;
    const uint8_t* asl = as + slot * ASB + abase;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // k-row 32ks + 4t + j: w_off adds (8ks + t) * 32 of padding
        const int off = (32 * ks + j) * BN + 8 * ks * 32;
        lo[j] = *reinterpret_cast<const uint32_t*>(wsl + off);
        hi[j] = *reinterpret_cast<const uint32_t*>(wsl + off + 16 * BN + 128);
      }
      transpose4x4(lo);
      transpose4x4(hi);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* ap = asl + i * 8 * A_STRIDE + 32 * ks;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(ap);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(ap + 16);
        mma_s8(acc[i][0], lo[0], lo[1], hi[0], hi[1], b0, b1);
        mma_s8(acc[i][1], lo[2], lo[3], hi[2], hi[3], b0, b1);
      }
    }
  }

  // thread (g, t) holds rows m = 2t, 2t+1 of each m8-tile at the four
  // columns n = 4g..4g+3 of its warp's 32
  const int n = n0 + warp * 32 + 4 * g;
  const bool atomic = gridDim.z > 1;
  const bool vec_out =
      ((reinterpret_cast<uintptr_t>(out) | (uintptr_t)N * 4) & 15) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + i * 8 + 2 * t + h;
      if (m >= M) continue;
      const int v[4] = {acc[i][0][h], acc[i][0][2 + h], acc[i][1][h],
                        acc[i][1][2 + h]};
      int32_t* o = out + (size_t)m * N + n;
      if (atomic) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < N) atomicAdd(o + c, v[c]);
      } else if (vec_out && n + 3 < N) {
        *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (n + c < N) o[c] = v[c];
      }
    }
  }
}

bool valid_vec(int v) { return v == 1 || v == 4 || v == 16; }

template <int MT, int BN>
void launch_bn(dim3 grid, size_t shmem, cudaStream_t s, const int8_t* a,
               const int8_t* w, int32_t* out, int M, int N, int K, int kc,
               int a_vec, int w_vec) {
  if (a_vec == 16 && w_vec == 16) {
    qmm_tc_kernel<MT, BN, true><<<grid, BN, shmem, s>>>(a, w, out, M, N, K,
                                                        kc, a_vec, w_vec);
  } else {
    qmm_tc_kernel<MT, BN, false><<<grid, BN, shmem, s>>>(a, w, out, M, N, K,
                                                         kc, a_vec, w_vec);
  }
}

template <int MT>
void launch_mt(int bn, dim3 grid, size_t shmem, cudaStream_t s,
               const int8_t* a, const int8_t* w, int32_t* out, int M, int N,
               int K, int kc, int a_vec, int w_vec) {
  if (bn == 32) {
    launch_bn<MT, 32>(grid, shmem, s, a, w, out, M, N, K, kc, a_vec, w_vec);
  } else if (bn == 64) {
    launch_bn<MT, 64>(grid, shmem, s, a, w, out, M, N, K, kc, a_vec, w_vec);
  } else {
    launch_bn<MT, 128>(grid, shmem, s, a, w, out, M, N, K, kc, a_vec, w_vec);
  }
}

cudaError_t launch_tc(const int8_t* a, const int8_t* w, int32_t* out, int M,
                      int N, int K, int mt, int bn, int splits, int kc,
                      int a_vec, int w_vec, cudaStream_t s) {
  const int rows = 8 * mt;
  // the plan must cover [0, K) with non-empty ranges (one empty range
  // for K = 0, which writes zeros)
  const bool ok =
      (mt == 1 || mt == 2 || mt == 4) && (bn == 32 || bn == 64 || bn == 128) &&
      kc > 0 && kc % 32 == 0 && splits >= 1 && splits <= 65535 &&
      (long long)splits * kc >= K &&
      (splits == 1 || (long long)(splits - 1) * kc < K) &&
      (M + rows - 1) / rows <= 65535 && valid_vec(a_vec) && valid_vec(w_vec);
  if (!ok) return cudaErrorInvalidValue;
  const dim3 grid((N + bn - 1) / bn, (M + rows - 1) / rows, splits);
  const size_t shmem = STAGES * (w_stage_bytes(bn) + a_stage_bytes(mt));
  if (mt == 1) {
    launch_mt<1>(bn, grid, shmem, s, a, w, out, M, N, K, kc, a_vec, w_vec);
  } else if (mt == 2) {
    launch_mt<2>(bn, grid, shmem, s, a, w, out, M, N, K, kc, a_vec, w_vec);
  } else {
    launch_mt<4>(bn, grid, shmem, s, a, w, out, M, N, K, kc, a_vec, w_vec);
  }
  return cudaSuccess;
}

}  // namespace tc

}  // namespace

// a (M, K) int8; b (K, N) int8, or (K/2, N) packed bytes when packed;
// out (M, N) int32. Unpacked: the plan (mt m8-tiles per warp, bn columns
// per block, splits of kc k-rows; out zeroed when splits > 1) and the
// copy width each operand's alignment allows (16, 4 or 1 bytes); packed
// ignores them. Returns the launch's cudaError_t.
extern "C" int qmm_launch(const void* a, const void* b, void* out, int M,
                          int N, int K, int packed, int mt, int bn,
                          int splits, int kc, int a_vec, int w_vec,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(b);
  if (packed) {
    int_mm_kernel<false, true><<<grid_for(M, N), THREADS, 0, s>>>(
        a, w, nullptr, nullptr, out, M, N, K);
  } else {
    const cudaError_t err = tc::launch_tc(
        static_cast<const int8_t*>(a), w, static_cast<int32_t*>(out), M, N,
        K, mt, bn, splits, kc, a_vec, w_vec, s);
    if (err != cudaSuccess) return static_cast<int>(err);
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
