// Exact integer matrix products for Hopper (sm_90a), written by hand.
//
// Replaces three Pallas TPU kernels of the reference package:
//   * repro/kernels/qmm.py::_qmm_kernel         int8 x int8 -> int32
//   * repro/kernels/qmm.py::_qmm_packed_kernel  int8 x packed int4 -> int32
//   * repro/kernels/fused.py::_fused_qmm_kernel f32 acts quantized against
//     the static scale sa in the block, int8 or packed-int4 weights, int32
//     accumulation, epilogue (acc * sa) * sw[n]
// All three run on the int8 tensor cores (mma.sync m16n8k32 s8). qmm has
// its own kernel, qmm_tc_kernel; qmm_packed and fused_qmm share its
// sibling int_tc_kernel, which adds the f32 activation stage, packed
// weights and a split-K summed inside a thread block cluster. Each has
// its own note below.
//
// Exactness. Integer sums wrap mod 2^32 and are exact in any order, so
// every kernel here is bit-equal to kernels/ref.py (qmm_ref,
// fused_qmm_ref) whatever its split of K. The activation quantize is
// clamp(__float2int_rn(x / sa), -128, 127): IEEE division (this file
// must never be built with --use_fast_math) and round-half-to-even, the
// same as jnp.round(x / sa) / torch.round. The epilogue is two separate
// f32 multiplies in the reference's order, ((float)acc * sa) * sw[n].
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

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
// __dp4a template this file first held reached 28 GB/s at decode. What
// this design does:
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

// ------------------------------------------------- fused_qmm, qmm_packed
//
// int_tc_kernel: qmm_tc_kernel's mainloop (mma.sync m16n8k32 s8 in the
// swapped orientation, the permuted weight rows and the 4x4 byte
// transpose, a 4-stage cp.async ring of BK = 64 k-rows) for the two int
// kernels qmm_tc_kernel does not take. Template parameters: FUSED (f32
// activations quantized in the block, the f32 epilogue; otherwise int8
// activations and an int32 store) and PACKED (packed int4 weights;
// otherwise int8 rows, which also hold the int4 kind). Replaces
// repro/kernels/fused.py::_fused_qmm_kernel (FUSED) and
// repro/kernels/qmm.py::_qmm_packed_kernel (PACKED, not FUSED).
//
// Bound. At the decode shape (M = 8) the work is bytes: one decode step
// of qwen2-0.5b (168 projections) moves 376.6 MB through fused_qmm over
// int8 rows (357.8 MB of weights, f32 activations and outputs, scales),
// 0.1124 ms at 3.35 TB/s, and 190.6 MB through qmm_packed (0.0569 ms),
// against 5.7 GOP of int8 operations (0.003 ms at 1979 TOP/s). The
// __dp4a template these two kernels first ran on took 16.2 and 8.6 ms
// for it, replayed from a CUDA graph: a 32-row tile for 8 rows, few
// blocks at N = 896, and one byte loaded per thread with nothing in
// flight. This kernel takes 0.92-0.93 ms (fused_qmm over int8 rows or
// packed int4) and 0.72 ms (qmm_packed), 3.7-4.0 us a launch for the
// small projections, the launch latency qmm_tc_kernel also sits at
// (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py). What this design adds
// to qmm_tc_kernel's:
//
// * The f32 activation stage. Each stage's 8 * MT f32 rows x 64 k are
//   copied by 16-byte cp.async into a ring of their own (2 KB a stage
//   at MT = 1), and once a stage has landed the block quantizes it, each
//   element once, into one int8 slot in the layout qmm_tc_kernel's B
//   fragments read (a float4 read, four IEEE divisions, round, clamp,
//   four bytes packed into one word); a second barrier, then the MMAs.
//   One slot, not a ring, keeps a 256-row block small enough for three
//   a SM. The divisions are repeated by every column tile of the grid,
//   so the planner takes 128-column blocks: at 256 rows the quantize
//   still doubles a layer's time against qmm_packed's.
// * Packed weights in the A fragment. An A register holds 4
//   consecutive k of one weight column; the two packed bytes of that
//   column at k2-rows 2t and 2t + 1 hold exactly those 4 k. A thread
//   reads the words (k2, n..n+3) of those two k2-rows, sign-extends
//   their low and high nibbles in every byte lane (__vsub4 of the
//   nibble xor 8, so no borrow crosses a lane) into four words of 4 k
//   rows x 4 columns, and the same 4x4 byte transpose as qmm_tc_kernel
//   yields the fragments. Only half the weight bytes are copied. A
//   packed stage is 32 k2-rows; rows carry 32 bytes of padding after
//   every 2 (not 4), so the k2-rows 2t a quad reads fall in 4 distinct
//   8-bank groups at every block width.
// * Split-K without atomics: the K ranges of one output tile (grid z,
//   at most 8) form a thread block cluster. C fragment group q (the 4
//   columns of one output row a thread holds) belongs to the block of
//   cluster rank q % splits; every other block pushes its int32 partial
//   of that group into the owner's shared memory (one slot per split),
//   then one cluster barrier, and the owner adds the slots to its own
//   sum (any order: the sum is exact), applies the epilogue and stores.
//   No zeroed output, no workspace, no second launch. No activation
//   slice is held whole in shared memory, so 8 ranges take any K.
//
// A block is 128 columns, one warp per 32: blocks of 32 or 64 columns
// quantized the same activations for fewer columns, and each launch
// took longer. The plan (MT, splits of kc k-rows) is chosen in Python
// (kernels/qmm.py::plan_int_tc). Where every operand's pointer and row
// stride are 16-byte aligned (every projection of the models), a
// template path copies with per-thread addresses fixed for the whole K
// loop; otherwise qmm_tc_kernel's stage_copy takes 4-byte or byte
// copies (f32 activations always allow 4).

namespace itc {

using tc::A_STRIDE;
using tc::BK;
using tc::STAGES;
using tc::clampi;
using tc::cp_async16;

constexpr int BN = 128;           // columns a block: four warps of 32
constexpr int MAX_SPLITS = 8;     // a portable cluster
constexpr int X_ROW = BK * 4;     // an f32 activation row of a stage

// byte offset of stored weight row r in a stage of BN columns: 32 bytes
// of padding after every 4 int8 rows (as qmm_tc_kernel) or 2 packed rows
template <bool PACKED>
__host__ __device__ constexpr int w_off(int r) {
  return r * BN + (PACKED ? r >> 1 : r >> 2) * 32;
}
template <bool PACKED>
__host__ __device__ constexpr int w_stage_bytes() {
  return w_off<PACKED>(PACKED ? BK / 2 : BK);
}
template <int MT, bool FUSED>
__host__ __device__ constexpr int x_stage_bytes() {
  return FUSED ? 8 * MT * X_ROW : 0;
}
// int8 activation stages: one ring slot a stage, or with FUSED the one
// slot the block quantizes each landed f32 stage into
template <bool FUSED>
__host__ __device__ constexpr int a_slots() {
  return FUSED ? 1 : STAGES;
}
template <int MT, bool FUSED, bool PACKED>
__host__ __device__ constexpr int ring_bytes() {
  return STAGES * (w_stage_bytes<PACKED>() + x_stage_bytes<MT, FUSED>()) +
         a_slots<FUSED>() * tc::a_stage_bytes(MT);
}
// the partial-sum slots: [splits][groups an owner holds][BN threads]
__host__ __device__ constexpr int part_bytes(int mt, int splits) {
  return splits > 1 ? splits * ((2 * mt + splits - 1) / splits) * BN * 16 : 0;
}
template <int MT, bool FUSED, bool PACKED>
__host__ __device__ constexpr int max_smem() {
  int most = 0;
  for (int s = 2; s <= MAX_SPLITS; ++s) {
    most = part_bytes(MT, s) > most ? part_bytes(MT, s) : most;
  }
  return ring_bytes<MT, FUSED, PACKED>() + most;
}

// both nibbles of every byte lane of p, sign-extended: bytes
// ((p >> 4k) & 0xF) ^ 8) - 8, lane by lane
__device__ __forceinline__ uint32_t nibbles_lo(uint32_t p) {
  return __vsub4((p & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t nibbles_hi(uint32_t p) {
  return __vsub4(((p >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ uint32_t quantize4(float4 v, float sa) {
  const int q0 = clampi(__float2int_rn(v.x / sa), -128, 127);
  const int q1 = clampi(__float2int_rn(v.y / sa), -128, 127);
  const int q2 = clampi(__float2int_rn(v.z / sa), -128, 127);
  const int q3 = clampi(__float2int_rn(v.w / sa), -128, 127);
  return (uint32_t(q0) & 0xFFu) | (uint32_t(q1) & 0xFFu) << 8 |
         (uint32_t(q2) & 0xFFu) << 16 | uint32_t(q3) << 24;
}

// The aligned path: every thread copies the same chunks of every stage
// (W_PASSES 16-byte weight chunks of one column chunk, and its share of
// the activation chunks, whose row and k offset stay fixed), so a stage
// costs a few adds and its cp.async instructions. ES is the activation
// element's bytes (4: f32, 1: int8).
template <int MT, int ES, bool PACKED>
struct TileCopy {
  static constexpr int PK = PACKED ? 2 : 1;        // k-rows a stored row
  static constexpr int WR = BK / PK;               // stored rows a stage
  static constexpr int W_PASSES = WR / 16;         // BN / 16 chunks a row
  static constexpr int ACPR = BK * ES / 16;        // act chunks a row
  static constexpr int ARS = BN / ACPR;            // act rows a pass
  static constexpr int A_ROWS = 8 * MT;
  static constexpr int A_PASSES = (A_ROWS + ARS - 1) / ARS;
  static constexpr int A_ROW = ES == 1 ? A_STRIDE : X_ROW;
  const int8_t* x;        // operand bases: the source of empty copies
  const int8_t* w;
  const int8_t* wsrc;     // this thread's column chunk at stored row wrow
  const int8_t* xsrc;     // its act chunk at row xrow, k kb
  int wrow, wdst, wbytes, xr, xrow, xc, xdst, kb;

  __device__ __forceinline__ TileCopy(const int8_t* x_, const int8_t* w_,
                                      int N, int K, int m0, int n0, int kb_)
      : x(x_), w(w_), kb(kb_) {
    constexpr int CPR = BN / 16;
    const int tid = threadIdx.x;
    const int wr = tid / CPR, c = 16 * (tid % CPR);
    wbytes = clampi(N - n0 - c, 0, 16);
    wrow = kb / PK + wr;
    wsrc = w + (size_t)wrow * N + n0 + c;
    wdst = w_off<PACKED>(wr) + c;
    xr = tid / ACPR;
    xc = 16 * (tid % ACPR);
    xrow = m0 + xr;
    xsrc = x + ((size_t)xrow * K + kb) * ES + xc;
    xdst = xr * A_ROW + xc;
  }

  // stage s: k-rows [kb + s*BK, kb + (s+1)*BK), zero at or past ke and
  // in rows at or past M
  __device__ __forceinline__ void load(uint8_t* ws, uint8_t* xs, int s,
                                       int ke, int M, int N, int K) const {
    const int k0 = kb + s * BK;
#pragma unroll
    for (int j = 0; j < W_PASSES; ++j) {
      const int bytes = wrow + s * WR + 16 * j < ke / PK ? wbytes : 0;
      cp_async16(ws + wdst + w_off<PACKED>(16 * j),
                 bytes ? wsrc + (size_t)(s * WR + 16 * j) * N : w, bytes);
    }
    const int kbytes = clampi((ke - k0) * ES - xc, 0, 16);
#pragma unroll
    for (int j = 0; j < A_PASSES; ++j) {
      if (xr + j * ARS >= A_ROWS) break;
      const int bytes = xrow + j * ARS < M ? kbytes : 0;
      cp_async16(xs + xdst + j * ARS * A_ROW,
                 bytes ? xsrc + ((size_t)j * ARS * K + s * BK) * ES : x,
                 bytes);
    }
  }
};

// Quantize one landed f32 stage (8 * MT rows x BK k) into the int8 stage
// the B fragments read: each element once per block.
template <int MT>
__device__ __forceinline__ void quantize_stage(const uint8_t* xs,
                                               uint8_t* as, float sa) {
  constexpr int QUADS = 8 * MT * (BK / 4);
  static_assert(QUADS % BN == 0, "whole passes");
#pragma unroll
  for (int j = 0; j < QUADS / BN; ++j) {
    const int i = threadIdx.x + j * BN;
    const int r = i / (BK / 4), c = i % (BK / 4);
    const float4 v = *reinterpret_cast<const float4*>(xs + r * X_ROW + 16 * c);
    *reinterpret_cast<uint32_t*>(as + r * A_STRIDE + 4 * c) = quantize4(v, sa);
  }
}

template <bool FUSED>
__device__ __forceinline__ void store4(void* out, int M, int N, int m, int n,
                                       const int v[4], float sa,
                                       const float swv[4], bool vec_out) {
  if (m >= M) return;
  if constexpr (FUSED) {
    float y[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      y[c] = (static_cast<float>(v[c]) * sa) * swv[c];
    }
    float* o = static_cast<float*>(out) + (size_t)m * N + n;
    if (vec_out && n + 3 < N) {
      *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n + c < N) o[c] = y[c];
    }
  } else {
    int32_t* o = static_cast<int32_t*>(out) + (size_t)m * N + n;
    if (vec_out && n + 3 < N) {
      *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n + c < N) o[c] = v[c];
    }
  }
}

// One block: columns [n0, n0 + BN) (blockIdx.x), rows [m0, m0 + 8 MT)
// (blockIdx.y), k-rows [kb, kb + kc) (blockIdx.z, the split; the splits
// of one tile are one cluster). x is (M, K) f32 (FUSED) or int8; w is
// (K, N) int8 or (K/2, N) packed bytes; out (M, N) f32 (FUSED) or int32.
template <int MT, bool FUSED, bool PACKED, bool FAST>
__global__ void __launch_bounds__(BN)
int_tc_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ sw, const float* __restrict__ sa_ptr,
              void* __restrict__ out, int M, int N, int K, int kc,
              int x_vec, int w_vec) {
  constexpr int ES = FUSED ? 4 : 1;
  constexpr int PK = PACKED ? 2 : 1;
  constexpr int WSB = w_stage_bytes<PACKED>();
  constexpr int ASB = tc::a_stage_bytes(MT);
  constexpr int XSB = x_stage_bytes<MT, FUSED>();
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * 8 * MT;
  const int splits = gridDim.z;
  const int kb = blockIdx.z * kc;
  const int ke = min(K, kb + kc);
  const int nst = max(0, (ke - kb + BK - 1) / BK);
  uint8_t* ws = smem;
  uint8_t* as = ws + STAGES * WSB;
  uint8_t* xs = as + a_slots<FUSED>() * ASB;    // f32 stages (FUSED)
  int4* part = reinterpret_cast<int4*>(xs + STAGES * XSB);
  // with K split, every block will write into its owners' shared
  // memory: it signals now that it has started, and waits for the
  // others' signals before its first remote store
  if (splits > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);

  using Copy = TileCopy<MT, ES, PACKED>;
  const Copy fast(x, w, N, K, m0, n0, kb);
  auto load = [&](int s) {
    const int slot = s % STAGES;
    uint8_t* xslot = FUSED ? xs + slot * XSB : as + slot * ASB;
    if constexpr (FAST) {
      fast.load(ws + slot * WSB, xslot, s, ke, M, N, K);
    } else {
      const int k0 = kb + s * BK;
      tc::stage_copy(ws + slot * WSB, w + (size_t)(k0 / PK) * N + n0,
                     (size_t)N, BK / PK, BN, (ke - k0) / PK, N - n0, w_vec,
                     [](int r) { return w_off<PACKED>(r); });
      tc::stage_copy(xslot, x + ((size_t)m0 * K + k0) * ES, (size_t)K * ES,
                     8 * MT, BK * ES, M - m0, (ke - k0) * ES, x_vec,
                     [](int r) { return r * Copy::A_ROW; });
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    tc::cp_async_commit();
  }
  // thread (g, t) ends with rows 2t, 2t+1 of each m8-tile at columns
  // n..n+3; the scales it needs are read now, while the copies fly
  const int n = n0 + warp * 32 + 4 * g;
  float sa = 0.0f, swv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (FUSED) {
    sa = *sa_ptr;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (n + c < N) swv[c] = sw[n + c];
  }

  int acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  // this thread's words: column 4g of its warp's 32 at k-rows 4t + j (or
  // k2-rows 2t, 2t + 1) and 16 further (8 k2-rows); act row g, bytes 4t
  const int wbase = warp * 32 + 4 * g + w_off<PACKED>(PACKED ? 2 * t : 4 * t);
  const int abase = g * A_STRIDE + 4 * t;
  for (int it = 0; it < nst; ++it) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();              // slot it landed; slot it-1 free
    if (it + STAGES - 1 < nst) load(it + STAGES - 1);
    tc::cp_async_commit();
    const int slot = it % STAGES;
    // with FUSED, the one int8 slot is free: every thread has passed the
    // barrier above, so it has done the previous stage's MMAs
    if constexpr (FUSED) {
      quantize_stage<MT>(xs + slot * XSB, as, sa);
      __syncthreads();
    }
    const uint8_t* wsl = ws + slot * WSB + wbase;
    const uint8_t* asl = as + (FUSED ? 0 : slot * ASB) + abase;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t lo[4], hi[4];
      if constexpr (PACKED) {
        // k2-rows 16ks + 2t + d and 16ks + 8 + 2t + d: w_off adds
        // (8ks + t) * 32 and (8ks + 4 + t) * 32 of padding
        const uint8_t* p = wsl + 16 * ks * BN + 8 * ks * 32;
        const uint32_t p0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t p1 = *reinterpret_cast<const uint32_t*>(p + BN);
        const uint32_t q0 =
            *reinterpret_cast<const uint32_t*>(p + 8 * BN + 128);
        const uint32_t q1 =
            *reinterpret_cast<const uint32_t*>(p + 9 * BN + 128);
        lo[0] = nibbles_lo(p0);
        lo[1] = nibbles_hi(p0);
        lo[2] = nibbles_lo(p1);
        lo[3] = nibbles_hi(p1);
        hi[0] = nibbles_lo(q0);
        hi[1] = nibbles_hi(q0);
        hi[2] = nibbles_lo(q1);
        hi[3] = nibbles_hi(q1);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // k-row 32ks + 4t + j: w_off adds (8ks + t) * 32 of padding
          const int off = (32 * ks + j) * BN + 8 * ks * 32;
          lo[j] = *reinterpret_cast<const uint32_t*>(wsl + off);
          hi[j] = *reinterpret_cast<const uint32_t*>(wsl + off + 16 * BN + 128);
        }
      }
      tc::transpose4x4(lo);
      tc::transpose4x4(hi);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* ap = asl + i * 8 * A_STRIDE + 32 * ks;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(ap);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(ap + 16);
        tc::mma_s8(acc[i][0], lo[0], lo[1], hi[0], hi[1], b0, b1);
        tc::mma_s8(acc[i][1], lo[2], lo[3], hi[2], hi[3], b0, b1);
      }
    }
  }

  // group q = 2i + h: row m0 + 8i + 2t + h at columns n..n+3
  const bool vec_out =
      ((reinterpret_cast<uintptr_t>(out) | (uintptr_t)N * 4) & 15) == 0;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v[4] = {acc[i][0][h], acc[i][0][2 + h], acc[i][1][h],
                          acc[i][1][2 + h]};
        store4<FUSED>(out, M, N, m0 + 8 * i + 2 * t + h, n, v, sa, swv,
                      vec_out);
      }
    return;
  }
  // group q belongs to cluster rank q % splits, in its slot
  // [rank of the pusher][q / splits][thread]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int held = (2 * MT + splits - 1) / splits;
  asm volatile("barrier.cluster.wait.aligned;\n" ::);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * i + h;
      const int owner = q % splits;
      if (owner == rank) continue;
      int4* dst = cluster.map_shared_rank(part, owner);
      dst[(rank * held + q / splits) * BN + threadIdx.x] = make_int4(
          acc[i][0][h], acc[i][0][2 + h], acc[i][1][h], acc[i][1][2 + h]);
    }
  // a cluster barrier (release, acquire); then each owner adds its
  // groups' slots and stores; no block reads another's memory after it
  cluster.sync();
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * i + h;
      if (q % splits != rank) continue;
      int v[4] = {acc[i][0][h], acc[i][0][2 + h], acc[i][1][h],
                  acc[i][1][2 + h]};
      for (int s = 0; s < splits; ++s) {
        if (s == rank) continue;
        // int32 sums wrap mod 2^32, as the MMA's do: add as unsigned
        const int4 p = part[(s * held + q / splits) * BN + threadIdx.x];
        v[0] = static_cast<int>(static_cast<uint32_t>(v[0]) + p.x);
        v[1] = static_cast<int>(static_cast<uint32_t>(v[1]) + p.y);
        v[2] = static_cast<int>(static_cast<uint32_t>(v[2]) + p.z);
        v[3] = static_cast<int>(static_cast<uint32_t>(v[3]) + p.w);
      }
      store4<FUSED>(out, M, N, m0 + 8 * i + 2 * t + h, n, v, sa, swv,
                    vec_out);
    }
}

struct Args {
  const int8_t* x;
  const int8_t* w;
  const float* sw;
  const float* sa;
  void* out;
  int M, N, K, kc, x_vec, w_vec;
};

template <int MT, bool FUSED, bool PACKED, bool FAST>
cudaError_t launch_one(const Args& a, dim3 grid, cudaStream_t s) {
  auto kernel = int_tc_kernel<MT, FUSED, PACKED, FAST>;
  // above 48 KB of shared memory a kernel must ask first: it asks once
  // per device for the most this instantiation may use
  static unsigned long long ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!((ready >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem<MT, FUSED, PACKED>());
    if (err != cudaSuccess) return err;
    ready |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(BN);
  cfg.dynamicSmemBytes = ring_bytes<MT, FUSED, PACKED>() +
                         part_bytes(MT, grid.z);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;        // the splits of one tile
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a.x, a.w, a.sw, a.sa, a.out, a.M,
                            a.N, a.K, a.kc, a.x_vec, a.w_vec);
}

template <int MT, bool FUSED, bool PACKED>
cudaError_t launch_fast(const Args& a, dim3 grid, cudaStream_t s) {
  if (a.x_vec == 16 && a.w_vec == 16) {
    return launch_one<MT, FUSED, PACKED, true>(a, grid, s);
  }
  return launch_one<MT, FUSED, PACKED, false>(a, grid, s);
}

template <bool FUSED, bool PACKED>
cudaError_t launch_mt(const Args& a, int mt, dim3 grid, cudaStream_t s) {
  if (mt == 1) return launch_fast<1, FUSED, PACKED>(a, grid, s);
  if (mt == 2) return launch_fast<2, FUSED, PACKED>(a, grid, s);
  return launch_fast<4, FUSED, PACKED>(a, grid, s);
}

// the copy width vec (16, 4 or 1 bytes) that a row-major operand at p
// with rows of row_bytes allows
bool vec_ok(int vec, const void* p, long long row_bytes) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) | (uintptr_t)row_bytes;
  return (vec == 16 || vec == 4 || vec == 1) && bits % vec == 0;
}

}  // namespace itc

}  // namespace

// a (M, K) int8; b (K, N) int8; out (M, N) int32. The plan (mt m8-tiles
// per warp, bn columns per block, splits of kc k-rows; out zeroed when
// splits > 1) and the copy width each operand's alignment allows (16, 4
// or 1 bytes). Returns the launch's cudaError_t.
extern "C" int qmm_launch(const void* a, const void* b, void* out, int M,
                          int N, int K, int mt, int bn, int splits, int kc,
                          int a_vec, int w_vec, void* stream) {
  const cudaError_t err = tc::launch_tc(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int32_t*>(out), M, N, K, mt, bn, splits, kc, a_vec, w_vec,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// fused_qmm (fused = 1): x (M, K) f32; sw (N,) f32; sa a device pointer
// to one f32; out (M, N) f32. qmm_packed (fused = 0): x (M, K) int8; sw
// and sa unused (may be null); out (M, N) int32. w (K, N) int8 rows, or
// (K/2, N) packed bytes when packed (K even). Unfused int8 rows are
// qmm's kernel and refused here. The plan (kernels/qmm.py::IntTcPlan):
// mt m8-tiles per warp (1, 2, 4), blocks of 128 columns, splits K
// ranges (1 to 8: one cluster) of kc k-rows (a multiple of 32,
// only the last one ragged); x_vec and w_vec the copy widths the
// operands allow (16, 4 or 1 bytes; f32 activations 16 or 4). Returns
// the launch's cudaError_t, or cudaErrorInvalidValue for arguments out
// of range.
extern "C" int int_tc_launch(const void* x, const void* w, const void* sw,
                             const void* sa, void* out, int M, int N, int K,
                             int fused, int packed, int mt, int splits,
                             int kc, int x_vec, int w_vec, void* stream) {
  const int rows = 8 * mt;
  const bool ok =
      (fused == 0 || fused == 1) && (packed == 0 || packed == 1) &&
      (fused || packed) && M >= 1 && N >= 1 && K >= 0 &&
      !(packed && K % 2) && (!fused || (sw && sa)) &&
      (mt == 1 || mt == 2 || mt == 4) && kc > 0 && kc % 32 == 0 &&
      splits >= 1 && splits <= itc::MAX_SPLITS && (long long)splits * kc >= K &&
      (splits == 1 || (long long)(splits - 1) * kc < K) &&
      (M + rows - 1) / rows <= 65535 && !(fused && x_vec == 1) &&
      itc::vec_ok(x_vec, x, (long long)K * (fused ? 4 : 1)) &&
      itc::vec_ok(w_vec, w, N);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const itc::Args a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                    static_cast<const float*>(sw), static_cast<const float*>(sa),
                    out, M, N, K, kc, x_vec, w_vec};
  const dim3 grid((N + itc::BN - 1) / itc::BN, (M + rows - 1) / rows, splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!fused) {
    err = itc::launch_mt<false, true>(a, mt, grid, s);
  } else if (packed) {
    err = itc::launch_mt<true, true>(a, mt, grid, s);
  } else {
    err = itc::launch_mt<true, false>(a, mt, grid, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
