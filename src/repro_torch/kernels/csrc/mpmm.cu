// Bounded-alignment approximate FP16 inner product at matmul scale (the
// paper's IPU(w) arithmetic), for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel repro/kernels/mpmm.py::_mpmm_kernel and
// the round_to_fp epilogue the reference runs after it. Every output
// element is bit-for-bit what the reference computes for the same f16
// operands and IPUConfig: per K-group of n products the EHU takes the
// group's largest product exponent mx, each product's alignment shift
// and the software-precision mask; then either nine nibble-plane
// iterations (faithful: 5-bit signed plane products << (w - 9), a
// truncating alignment shift, a w-bit adder tree) or one 22-bit plane on
// a w_f = min(w, 26)-bit datapath (fused) feed the (33 + t + l)-bit
// accumulator with its swap-and-shift; at the end the accumulator is
// rounded to nearest even into fp32, fp16 or bf16.
//
// Why the K-groups of one output can run in parallel, exactly. Let
// E_g = max(E_{g-1}, mx_g), from NEG_INF_EXP, be the prefix max of the
// group maxima. Group g's nine adder-tree sums s_p enter the accumulator
// with the net shifts pre_p + (E_g - mx_g) - (33 - w), which depend on
// the group's own data and on E_g alone: its contribution c_g is a
// function of (group, E_g). The accumulator is truncated only where E
// rises (a "record", shr(acc, E_g - E_{g-1})); between two records the
// contributions add exactly in int64, in any order. So once the E_g are
// known, the c_g are independent, and the in-order fold needs one shift
// and one add per group, walked in K order.
//
// Design. The reference's grid walks the K-groups in order and carries
// a two-limb accumulator across them. Here a block takes bn columns and
// a chunk of MR rows (1, 2, 4 or 8, held in registers); its 256 threads
// are bn columns (neighbouring lanes on neighbouring columns) by
// tk = 256 / bn k-lanes; `splits` blocks (1..8) of one tile form a
// thread block cluster. The K-groups go in rounds of splits x tk: in a
// round, lane l of rank c takes group round * splits * tk + c * tk + l
// for all MR rows, so each weight element's exponent and nibble planes
// are decoded once for MR rows. The launch plan (rows, bn, splits) comes
// from kernels/mpmm.py::plan_mpmm. A round runs
//   1. staging: the round's B rows and A's slice by cp.async (16-byte
//      copies where pointers and strides allow it, else 4 or 2 bytes),
//      issued one round ahead; A's slice is then decoded once for all
//      columns into a 16-byte word per element (three plane magnitudes
//      pre-scaled by 2^(w - 9), the exponent), its exponent and its sign;
//   2. the exponent pass: mx per (row, column, group) and the block's max
//      per (row, column), which the cluster's other ranks read through
//      distributed shared memory: every thread then has E_g for its
//      group (the max over the lower ranks, the lower lanes and its own);
//   3. the plane pass: nine plane sums per row in registers, each kept
//      product a multiply, a shift and a signed add (trunc: the sign
//      applied after the magnitude's shift, a masked product shifted
//      out; floor: signed operands and an arithmetic shift); then c_g
//      from the sums and E_g - mx_g, pushed with mx_g into the owner's
//      inbox (the cluster's blocks own equal shares of the tile);
//   4. the ordered fold: each owner walks the round's entries in K order
//      from its inbox: a shift where mx exceeds its running exponent,
//      then one add. The accumulator and exponent stay in the owner's
//      shared memory from round to round; a round's storage is its
//      splits x tk entries per output, whatever K is.
// The two cluster barriers of a round are split (arrive, other work,
// wait), so the plane pass hides the one and the next exponent pass the
// other. No atomics, workspace or memset: a launch repeated, or replayed
// from a CUDA graph, gives the same bits. Zero padding (ragged M, N and
// K) is f16 +0, exponent -14 and magnitude 0, as the reference pads.
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
// and an add each, and 4 operations of exponent work per product, that
// is 88.7 G int32 operations, which the card's 132 SMs x 64 INT32 lanes
// do in about 5.3 ms at 1.98 GHz, against 0.21 ms to read the 715.6 MB
// of f16 weights: operations bound it. The first version of this file
// (one thread per output, the K-groups walked serially, 28 blocks for a
// 896-column projection at M = 8) took 65.1 ms for that step replayed
// from a CUDA graph; this one takes 10.5 ms, 2.0x the bound, and a
// 256-row layer 9.5 ms against 16.3 (NVIDIA H100 80GB HBM3, 700.00 W;
// chip_smoke.py, mpmm_ab.py). The plane pass issues 31 instructions a
// kept product, 18 of them integer multiplies; the same products through
// fp32 FMAs with a rounding-mode magic number measured slower. No build
// flag may add --use_fast_math.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int KC_MAX = 32;          // k-rows of a group a lane stages at once
constexpr int MAX_SPLITS = 8;       // a portable cluster
constexpr int NEG_INF_EXP = -(1 << 20);
constexpr int NO_GROUP = -(1 << 21);  // mx of a lane with no group this round

struct OutFormat {
  int mant, exp_bits, bias, min_exp, max_exp, bits;
};

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
// the two halves of a cluster barrier: arrive (release) and wait
// (acquire); a thread does other work between them. A lone block (no
// cluster) takes a block barrier at the wait.
__device__ __forceinline__ void cluster_arrive(bool lone) {
  if (!lone) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait(bool lone) {
  if (lone) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// the f16 fields of bits h: sign bit, exponent (-14 for subnormals and
// zero) and 11-bit magnitude
__device__ __forceinline__ void fields(uint32_t h, int& neg, int& exp,
                                       int& mag) {
  const int e = (h >> 10) & 0x1F;
  const int m = h & 0x3FF;
  mag = e == 0 ? m : (m | 0x400);
  exp = e == 0 ? -14 : e - 15;
  neg = (h >> 15) & 1;
}

// A's staged word: faithful {n0, n1, n2} plane magnitudes times
// 2^(w - 9) (signed for floor), fused the signed 11-bit magnitude; .w is
// the exponent
template <bool FUSED, bool FLOOR>
__device__ __forceinline__ int4 encode_a(uint32_t h, int scale) {
  int neg, exp, mag;
  fields(h, neg, exp, mag);
  int4 v;
  v.w = exp;
  if (FUSED) {
    v.x = neg ? -mag : mag;
    v.y = v.z = 0;
  } else {
    const int s = FLOOR && neg ? -scale : scale;
    v.x = ((mag & 0x7) << 1) * s;
    v.y = ((mag >> 3) & 0xF) * s;
    v.z = ((mag >> 7) & 0xF) * s;
  }
  return v;
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

// an adder-tree sum aligned to the accumulator by core.ipu.accumulate's
// net shift: an exact left shift (clamped at 23) where it is negative,
// else the limbs' right shift. The sum is an int32, so a right shift of
// 31 or more leaves what one of 48 or more does (0, or -1 under floor),
// and the int32 shift serves; both cases are one shift and one widening
// multiply, with no branch.
template <bool FLOOR>
__device__ __forceinline__ long long align(int s_tree, int net) {
  const int t = shr_i32<FLOOR>(s_tree, max(net, 0));
  return static_cast<long long>(t) *
         static_cast<long long>(1 << min(max(-net, 0), 23));
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

// byte offsets of the shared-memory regions (each 16-byte aligned), the
// same in every block of a cluster; `total` is the dynamic size
struct Layout {
  int in_c, sacc, sA, sAe, sAs, sB, sAr, in_mx, smx, sbmax, scpre, sE, sexp;
  int total;
};

// a 16-byte aligned region of `bytes` at `at`, which moves past it
__host__ __device__ inline int take(int& at, int bytes) {
  const int here = at;
  at += (bytes + 15) & ~15;
  return here;
}

__host__ __device__ inline Layout layout(int rows, int bn, int kc,
                                         int splits) {
  const int tk = THREADS / bn;
  const int pairs = rows * bn;
  const int share = (pairs + splits - 1) / splits;
  const int share2 = (share + 1) & ~1;
  const int entries = splits * tk;
  const int a_words = tk * kc * rows, b_words = tk * kc * bn;
  Layout L;
  int at = 0;
  L.in_c = take(at, 2 * entries * share2 * 8);   // [2][entries][share2] c_g
  L.sacc = take(at, share2 * 8);                 // owners' accumulators
  L.sA = take(at, a_words * 16);                 // [tk][kc][rows] A words
  L.sAe = take(at, a_words * 4);                 // [tk][kc][rows] A exponents
  L.sAs = take(at, a_words * 4);                 // [tk][kc][rows] A signs
  L.sB = take(at, 2 * b_words * 2);              // [2][tk][kc][bn] B bits
  L.sAr = take(at, 2 * a_words * 2);             // [2][tk][rows][kc] A bits
  L.in_mx = take(at, 2 * entries * share2 * 4);  // [2][entries][share2] mx_g
  L.smx = take(at, tk * pairs * 4);              // [tk][rows][bn] mx_g
  L.sbmax = take(at, 2 * pairs * 4);             // [2][rows][bn] block max
  L.scpre = take(at, pairs * 4);                 // E before this rank
  L.sE = take(at, pairs * 4);                    // E before this round
  L.sexp = take(at, share2 * 4);                 // owners' exponents
  L.total = at;
  return L;
}

struct Geometry {
  int M, N, K, g, G;      // G = ceil(K / g) groups
  int bn, tk, kc;         // block columns, k-lanes, staged k-rows per lane
  int b_vec, a_vec;       // bytes a copy of B and of A
  int splits, rank, m0, n0;
};

// B rows of round q, chunk ch into `dst` ([tk * kc][bn] f16 bits): row
// (lane, kk) is k-row ch * kc + kk of the lane's group; zero past the
// group, past K and past N
__device__ __forceinline__ void stage_b(uint16_t* dst,
                                        const uint16_t* __restrict__ B,
                                        const Geometry& s, int q, int ch) {
  const int per = s.b_vec / 2;              // columns a copy
  const int cols = s.bn / per;
  const int total = s.tk * s.kc * cols;
  const int g0 = (q * s.splits + s.rank) * s.tk;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int row = i / cols;
    const int c = (i - row * cols) * per;
    const int lane = row / s.kc;
    const int kg = ch * s.kc + (row - lane * s.kc);
    const int gi = g0 + lane;
    const long long k = (long long)gi * s.g + kg;
    const int n = s.n0 + c;
    const bool ok = gi < s.G && kg < s.g && k < s.K && n < s.N;
    const uint16_t* src = ok ? B + k * s.N + n : B;
    if (s.b_vec == 16) {
      cp_async16(dst + row * s.bn + c, src, ok ? 16 : 0);
    } else if (s.b_vec == 4) {
      cp_async4(dst + row * s.bn + c, src, ok ? 4 : 0);
    } else {
      dst[row * s.bn + c] = ok ? *src : uint16_t(0);
    }
  }
}

// A's raw f16 bits of round q, chunk ch into `dst` ([tk][MR][kc]): the
// kc k-rows of a lane's group for one row lie together, as in A; zero
// past the group, past K and past M
template <int MR>
__device__ __forceinline__ void stage_a(uint16_t* dst,
                                        const uint16_t* __restrict__ A,
                                        const Geometry& s, int q, int ch) {
  const int per = s.a_vec / 2;              // k-rows a copy
  const int runs = s.kc / per;
  const int total = s.tk * MR * runs;
  const int g0 = (q * s.splits + s.rank) * s.tk;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int rest = i / runs;
    const int kk = (i - rest * runs) * per;
    const int r = rest % MR;
    const int lane = rest / MR;
    const int kg = ch * s.kc + kk;
    const int gi = g0 + lane;
    const long long k = (long long)gi * s.g + kg;
    const int m = s.m0 + r;
    const bool ok = gi < s.G && kg < s.g && k < s.K && m < s.M;
    const uint16_t* src = ok ? A + (size_t)m * s.K + k : A;
    uint16_t* d = dst + rest * s.kc + kk;
    if (s.a_vec == 16) {
      cp_async16(d, src, ok ? 16 : 0);
    } else if (s.a_vec == 4) {
      cp_async4(d, src, ok ? 4 : 0);
    } else {
      *d = ok ? *src : uint16_t(0);
    }
  }
}

// the staged raw A decoded, once for all columns: words [tk][kc][MR]
// (encode_a), and beside them exponents and signs (+-1)
template <bool FUSED, bool FLOOR, int MR>
__device__ __forceinline__ void decode_a(int4* words, int* exps, int* signs,
                                         const uint16_t* raw,
                                         const Geometry& s, int scale) {
  const int total = s.tk * MR * s.kc;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int rest = i / s.kc;               // lane * MR + r
    const int kk = i - rest * s.kc;
    const int r = rest % MR;
    const int lane = rest / MR;
    const int4 v = encode_a<FUSED, FLOOR>(raw[i], scale);
    const int at = (lane * s.kc + kk) * MR + r;
    words[at] = v;
    exps[at] = v.w;
    signs[at] = (raw[i] >> 15) ? -1 : 1;
  }
}

template <bool FUSED, bool FLOOR, int MR>
__global__ void __launch_bounds__(THREADS, 2)
mpmm_kernel(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
            void* __restrict__ out, int M, int N, int K, int g, int w,
            int thresh, OutFormat fmt, int bn, int kc, int b_vec,
            int a_vec) {
  constexpr int NP = FUSED ? 1 : 9;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();   // remote addresses
  Geometry s;
  s.M = M;
  s.N = N;
  s.K = K;
  s.g = g;
  s.G = (K + g - 1) / g;
  s.bn = bn;
  s.tk = THREADS / bn;
  s.kc = kc;
  s.b_vec = b_vec;
  s.a_vec = a_vec;
  s.splits = gridDim.y;
  s.rank = blockIdx.y;
  s.m0 = blockIdx.z * MR;
  s.n0 = blockIdx.x * bn;
  const int t = threadIdx.x;
  const int tx = t % bn;
  const int ty = t / bn;
  const int tk = s.tk;
  const int pairs = MR * bn;                  // outputs of the tile
  const int share = (pairs + s.splits - 1) / s.splits;
  const int share2 = (share + 1) & ~1;
  const int entries = s.splits * tk;         // groups of a round
  const bool lone = s.splits == 1;
  const int nch = (g + kc - 1) / kc;          // chunks of a group
  const int rounds = (s.G + entries - 1) / entries;
  const bool ahead = nch == 1;                // staged one round ahead
  const int b_words = tk * kc * bn;
  const int a_words = tk * kc * MR;
  const int scale = 1 << (w - 9);
  const int wf = min(w, 26);
  const int fused_lsh = max(wf - 22, 0);

  // shared memory, the same layout in every block of the cluster
  const Layout L = layout(MR, bn, kc, s.splits);
  long long* in_c = reinterpret_cast<long long*>(smem + L.in_c);
  long long* sacc = reinterpret_cast<long long*>(smem + L.sacc);
  int4* sA = reinterpret_cast<int4*>(smem + L.sA);
  int* sAe = reinterpret_cast<int*>(smem + L.sAe);
  int* sAs = reinterpret_cast<int*>(smem + L.sAs);
  uint16_t* sB = reinterpret_cast<uint16_t*>(smem + L.sB);
  uint16_t* sAr = reinterpret_cast<uint16_t*>(smem + L.sAr);
  int* in_mx = reinterpret_cast<int*>(smem + L.in_mx);
  int* smx = reinterpret_cast<int*>(smem + L.smx);
  int* sbmax = reinterpret_cast<int*>(smem + L.sbmax);
  int* scpre = reinterpret_cast<int*>(smem + L.scpre);
  int* sE = reinterpret_cast<int*>(smem + L.sE);
  int* sexp = reinterpret_cast<int*>(smem + L.sexp);

  for (int p = t; p < pairs; p += THREADS) sE[p] = NEG_INF_EXP;
  for (int j = t; j < share; j += THREADS) {
    sacc[j] = 0;
    sexp[j] = NEG_INF_EXP;
  }
  if (ahead && rounds > 0) {
    stage_b(sB, B, s, 0, 0);
    stage_a<MR>(sAr, A, s, 0, 0);
  }
  cp_async_commit();

  // 4. the ordered fold of a round's entries, from the inbox, by the
  // owners of this block's share: entries in order are groups in K order
  auto fold = [&](int par) {
    for (int j = t; j < share; j += THREADS) {
      if (s.rank * share + j >= pairs) break;
      const int* im = in_mx + par * entries * share2 + j;
      const long long* ic = in_c + par * entries * share2 + j;
      long long a = sacc[j];
      int e = sexp[j];
#pragma unroll 8
      for (int en = 0; en < entries; ++en) {
        const int v = im[en * share2];
        if (v > e) {
          a = shr64<FLOOR>(a, min(v - e, 63));
          e = v;
        }
        a += ic[en * share2];
      }
      sacc[j] = a;
      sexp[j] = e;
    }
  };

  // Each round has two cluster barriers, each split so that local work
  // hides it: A1 publishes the block maxima (arrive before the plane
  // pass, wait after it), A2 the pushed entries (arrive after the push,
  // wait after the next round's exponent pass, then that round's fold).
  for (int q = 0; q < rounds; ++q) {
    const int par = q & 1;
    const int gi = (q * s.splits + s.rank) * tk + ty;
    const bool valid = gi < s.G;
    const uint16_t* bst = sB + (ahead ? par * b_words : 0);

    // 1. staging: the round's B rows and A slice (the next round's
    // copies issued first), then A decoded once
    auto stage = [&](int ch) {
      if (ahead) {
        if (q + 1 < rounds) {
          stage_b(sB + (par ^ 1) * b_words, B, s, q + 1, 0);
          stage_a<MR>(sAr + (par ^ 1) * a_words, A, s, q + 1, 0);
        }
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        __syncthreads();          // the last chunk's readers are done
        stage_b(sB, B, s, q, ch);
        stage_a<MR>(sAr, A, s, q, ch);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      decode_a<FUSED, FLOOR, MR>(sA, sAe, sAs, sAr + (ahead ? par * a_words : 0),
                                 s, scale);
      __syncthreads();
    };

    // 2. the exponent pass
    int mx[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) mx[r] = NO_GROUP;
    for (int ch = 0; ch < nch; ++ch) {
      stage(ch);
      const int kn = valid ? min(kc, g - ch * kc) : 0;
      for (int kk = 0; kk < kn; ++kk) {
        const int row = ty * kc + kk;
        int neg, eb, mag;
        fields(bst[row * bn + tx], neg, eb, mag);
        const int* ae = sAe + row * MR;
        if (MR % 4 == 0) {
#pragma unroll
          for (int r = 0; r < MR; r += 4) {
            const int4 v = *reinterpret_cast<const int4*>(ae + r);
            mx[r] = max(mx[r], v.x + eb);
            mx[r + 1] = max(mx[r + 1], v.y + eb);
            mx[r + 2] = max(mx[r + 2], v.z + eb);
            mx[r + 3] = max(mx[r + 3], v.w + eb);
          }
        } else {
#pragma unroll
          for (int r = 0; r < MR; ++r) mx[r] = max(mx[r], ae[r] + eb);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MR; ++r) smx[(ty * MR + r) * bn + tx] = mx[r];
    __syncthreads();
    // the block's max per output, published (A1) for the other ranks
    int* bmx = sbmax + par * pairs;
    for (int p = t; p < pairs; p += THREADS) {
      int v = NO_GROUP;
      for (int l = 0; l < tk; ++l) v = max(v, smx[l * pairs + p]);
      bmx[p] = v;
    }
    if (q > 0) {
      cluster_wait(lone);         // A2 of the last round: its entries
      fold(par ^ 1);
    }
    cluster_arrive(lone);         // A1
#pragma unroll
    for (int r = 0; r < MR; ++r) mx[r] = smx[(ty * MR + r) * bn + tx];

    // 3. the plane pass
    int acc[MR][NP];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
#pragma unroll
      for (int p = 0; p < NP; ++p) acc[r][p] = 0;
    }
    for (int ch = 0; ch < nch; ++ch) {
      if (!ahead) stage(ch);      // the exponent pass left the last chunk
      const int kn = valid ? min(kc, g - ch * kc) : 0;
      for (int kk = 0; kk < kn; ++kk) {
        const int row = ty * kc + kk;
        int nb, eb, mag;
        fields(bst[row * bn + tx], nb, eb, mag);
        const int4* aw = sA + row * MR;
        if (FUSED) {
          const int db = nb ? -mag : mag;
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            const int4 a = aw[r];
            const int sh = mx[r] - (a.w + eb);
            const int rs = sh + 22 - wf;
            int al = shr_i32<FLOOR>(a.x * db, max(rs, 0));
            if (rs < 0) al *= 1 << min(-rs, fused_lsh);
            acc[r][0] += sh <= thresh ? al : 0;
          }
        } else {
          int b[3];
          b[0] = (mag & 0x7) << 1;
          b[1] = (mag >> 3) & 0xF;
          b[2] = (mag >> 7) & 0xF;
          const int sb = nb ? -1 : 1;
          const int* as = sAs + row * MR;
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            const int4 a = aw[r];
            const int sh = mx[r] - (a.w + eb);
            const int ai[3] = {a.x, a.y, a.z};
            if (FLOOR) {
              // signed planes, the mask on B's side, arithmetic shift
              const int sgn = sh <= thresh ? sb : 0;
              const int shc = min(sh, 31);
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                const int bj = b[j] * sgn;
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                  acc[r][3 * i + j] += (ai[i] * bj) >> shc;
                }
              }
            } else {
              // magnitudes shifted, then the product's sign; a masked
              // product shifts by 31, which clears it (thresh <= 31)
              const int sgn = as[r] * sb;
              const int shc = sh <= thresh ? sh : 31;
#pragma unroll
              for (int i = 0; i < 3; ++i) {
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                  acc[r][3 * i + j] += ((ai[i] * b[j]) >> shc) * sgn;
                }
              }
            }
          }
        }
      }
    }
    // the max over the lower ranks and over the whole cluster
    cluster_wait(lone);           // A1
    for (int p = t; p < pairs; p += THREADS) {
      int v[MAX_SPLITS];
#pragma unroll
      for (int c = 0; c < MAX_SPLITS; ++c) {    // every load in flight
        if (c < s.splits) v[c] = cluster.map_shared_rank(bmx, c)[p];
      }
      int lower = NO_GROUP, all = NO_GROUP;
#pragma unroll
      for (int c = 0; c < MAX_SPLITS; ++c) {
        if (c < s.rank) lower = max(lower, v[c]);
        if (c < s.splits) all = max(all, v[c]);
      }
      const int e_prev = sE[p];
      scpre[p] = max(e_prev, lower);
      sE[p] = max(e_prev, all);
    }
    __syncthreads();

    // c_g per row (E_g: the max over the lower ranks, the lower lanes
    // and this group), pushed with mx_g into the owner's inbox: entry
    // rank * tk + lane, so entries in order are groups in K order
    const int entry = s.rank * tk + ty;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      int e_in = scpre[r * bn + tx];
      for (int l = 0; l < ty; ++l) e_in = max(e_in, smx[(l * MR + r) * bn + tx]);
      const int de = max(e_in, mx[r]) - mx[r];
      long long c = 0;
      if (FUSED) {
        c = align<FLOOR>(acc[r][0], (1 + wf - w) + de - (33 - w));
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            c += align<FLOOR>(acc[r][3 * i + j],
                              4 * (4 - i - j) + de - (33 - w));
          }
        }
      }
      const int o = r * bn + tx;
      const int owner = o / share;
      const int at = (par * entries + entry) * share2 + o - owner * share;
      if (owner == s.rank) {
        in_mx[at] = valid ? mx[r] : NO_GROUP;
        in_c[at] = valid ? c : 0;
      } else {
        cluster.map_shared_rank(in_mx, owner)[at] = valid ? mx[r] : NO_GROUP;
        cluster.map_shared_rank(in_c, owner)[at] = valid ? c : 0;
      }
    }
    cluster_arrive(lone);         // A2
  }
  cp_async_wait<0>();
  if (rounds > 0) {
    cluster_wait(lone);           // A2 of the last round
    fold((rounds - 1) & 1);
  }

  // every remote access of this cluster came before the last barrier:
  // the owners round and write out
  for (int j = t; j < share; j += THREADS) {
    const int o = s.rank * share + j;
    if (o >= pairs) break;
    const int r = o / bn, x = o - r * bn;
    const int m = s.m0 + r, n = s.n0 + x;
    if (m >= M || n >= N) continue;
    const uint32_t bits = round_to_fp(sacc[j], sexp[j], fmt);
    if (fmt.bits == 32) {
      static_cast<uint32_t*>(out)[(size_t)m * N + n] = bits;
    } else {
      static_cast<uint16_t*>(out)[(size_t)m * N + n] =
          static_cast<uint16_t>(bits);
    }
  }
}

struct Args {
  const uint16_t* a;
  const uint16_t* b;
  void* out;
  int M, N, K, g, w, thresh;
  OutFormat fmt;
  int bn, kc, b_vec, a_vec;
};

template <bool FUSED, bool FLOOR, int MR>
cudaError_t launch_rows(const Args& a, int splits, cudaStream_t s) {
  const size_t smem = layout(MR, a.bn, a.kc, splits).total;
  // above 48 KB of shared memory a kernel must ask first: it asks once
  // per device for the most any plan uses
  static unsigned long long ready = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!((ready >> dev) & 1ull)) {
    size_t most = 0;
    for (int bn = 32; bn <= 256; bn *= 2) {
      for (int c = 1; c <= MAX_SPLITS; ++c) {
        const size_t b = layout(MR, bn, KC_MAX, c).total;
        most = b > most ? b : most;
      }
    }
    err = cudaFuncSetAttribute(mpmm_kernel<FUSED, FLOOR, MR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)most);
    if (err != cudaSuccess) return err;
    ready |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + a.bn - 1) / a.bn, splits, (a.M + MR - 1) / MR);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;        // the K ranges of one tile
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, mpmm_kernel<FUSED, FLOOR, MR>, a.a, a.b,
                            a.out, a.M, a.N, a.K, a.g, a.w, a.thresh, a.fmt,
                            a.bn, a.kc, a.b_vec, a.a_vec);
}

template <bool FUSED, bool FLOOR>
cudaError_t launch_mode(const Args& a, int rows, int splits,
                        cudaStream_t s) {
  switch (rows) {
    case 1: return launch_rows<FUSED, FLOOR, 1>(a, splits, s);
    case 2: return launch_rows<FUSED, FLOOR, 2>(a, splits, s);
    case 4: return launch_rows<FUSED, FLOOR, 4>(a, splits, s);
    default: return launch_rows<FUSED, FLOOR, 8>(a, splits, s);
  }
}

}  // namespace

// a (M, K) f16 and b (K, N) f16 as raw bits; out (M, N) in the accumulator
// format (out_exp_bits, out_mant_bits: fp32 8/23, fp16 5/10, bf16 8/7).
// g = IPUConfig.n, w = IPUConfig.w, thresh = IPUConfig.mask_threshold
// (at most 31: a masked product's shift).
// The plan (kernels/mpmm.py::MpmmPlan): chunks of `rows` rows (1, 2, 4
// or 8), bn columns a block (32, 64, 128 or 256), `splits` blocks a
// cluster (1 to 8), kc = min(g, 32) k-rows staged per lane; b copied
// `vec` bytes at a time (16 or 4: b's pointer and row stride must allow
// it; 2 always works). Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for arguments out of range.
extern "C" int mpmm_launch(const void* a, const void* b, void* out, int M,
                           int N, int K, int g, int w, int thresh, int fused,
                           int floor_rounding, int out_exp_bits,
                           int out_mant_bits, int rows, int bn, int splits,
                           int vec, void* stream) {
  const uintptr_t bp = reinterpret_cast<uintptr_t>(b);
  const uintptr_t row_bytes = 2 * (uintptr_t)N;
  const bool plan_ok =
      (rows == 1 || rows == 2 || rows == 4 || rows == 8) &&
      (M + rows - 1) / rows <= 65535 &&
      (bn == 32 || bn == 64 || bn == 128 || bn == 256) && splits >= 1 &&
      splits <= MAX_SPLITS &&
      (vec == 2 || (vec == 4 && (bp | row_bytes) % 4 == 0) ||
       (vec == 16 && (bp | row_bytes) % 16 == 0));
  if (M < 1 || N < 1 || K < 0 || g < 1 || w < 10 || w > 30 || thresh < 0 ||
      thresh > 31 || !plan_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args;
  args.a = static_cast<const uint16_t*>(a);
  args.b = static_cast<const uint16_t*>(b);
  args.out = out;
  args.M = M;
  args.N = N;
  args.K = K;
  args.g = g;
  args.w = w;
  args.thresh = thresh;
  args.fmt.mant = out_mant_bits;
  args.fmt.exp_bits = out_exp_bits;
  args.fmt.bias = (1 << (out_exp_bits - 1)) - 1;
  args.fmt.min_exp = 1 - args.fmt.bias;
  args.fmt.max_exp = (1 << out_exp_bits) - 2 - args.fmt.bias;
  args.fmt.bits = 1 + out_exp_bits + out_mant_bits;
  args.bn = bn;
  args.kc = g < KC_MAX ? g : KC_MAX;
  args.b_vec = vec;
  // A's runs of kc k-rows start at multiples of kc within a group
  const uintptr_t ap = reinterpret_cast<uintptr_t>(a);
  const uintptr_t a_row = 2 * (uintptr_t)K;
  args.a_vec = (ap | a_row) % 16 == 0 && g % 8 == 0 && args.kc % 8 == 0
                   ? 16
                   : (ap | a_row) % 4 == 0 && g % 2 == 0 && args.kc % 2 == 0
                         ? 4
                         : 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fused) {
    err = floor_rounding ? launch_mode<true, true>(args, rows, splits, s)
                         : launch_mode<true, false>(args, rows, splits, s);
  } else {
    err = floor_rounding ? launch_mode<false, true>(args, rows, splits, s)
                         : launch_mode<false, false>(args, rows, splits, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
