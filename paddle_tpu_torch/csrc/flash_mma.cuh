// Building blocks shared by the flash-attention kernels, forward
// (flash_attention_fwd.cu) and backward (flash_attention_bwd_dq.cu,
// flash_attention_bwd_dkv.cu), for Hopper (sm_90a): asynchronous 16-byte
// tile loads into a swizzled shared-memory layout, and warp-level
// tensor-core products through mma.sync.
//
// Numerics. bf16 and fp16 operands take one m16n8k16 MMA of their type per
// product (and one more for the residual of P or dS where that gradient is
// written in f32, see a_res below); the two share fragments, ldmatrix and
// code (Mma16), and differ in their conversions and the MMA's type. fp16
// rounds P and dS as the hardware does: a value past its range becomes inf
// (never clamped), so an overflowing dS reaches the gradient. fp32
// operands take m16n8k8 TF32 MMAs as 3xTF32: each operand x is split in
// registers into big = x rounded to TF32 and small = x - big rounded to
// TF32 (see split), and the product is small*big + big*small + big*big.
// The tensor cores truncate as they accumulate, so every fp32 k-step (8
// products, three MMAs) is summed from zero and added to its f32
// accumulator in one round-to-nearest add (mma_add), never chained
// through a long run of MMAs. That leaves about fp32 accuracy (relative
// error under 1e-6 at D = 128), where one TF32 product would keep about
// 1e-3. Both cost time (PERF.md): held against a float64 step on
// BERT-base's gradients, a truncating split with chained k-steps put the
// q/k projections' gradients several times farther from float64 than a
// dense float32 step (ROADMAP C7).
//
// Fragments (PTX ISA, mma.m16n8k8 / m16n8k16; g = lane / 4, t = lane % 4):
// an accumulator tile of 16 x 8 holds (g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1) in c[0..3], so a row's values sit in the four lanes t of
// one group g (row sums and maxima: shfl_xor 1 and 2). A product whose A
// operand is an earlier accumulator (P or dS) reads it straight from those registers: in fp32
// the k index of one 8-wide step is permuted (k = t holds column 2t,
// k = t+4 column 2t+1) and the matching B rows are read in the same order,
// which leaves the sum unchanged; in bf16 and fp16 two accumulator tiles
// pack into one 16-wide A fragment as they stand.
//
// Shared-memory layout. A tile is rows of D elements with no padding; the
// 16-byte chunk c of row r is stored at chunk c ^ (r % 8) (rows of 4
// chunks, bf16 and fp16 at D = 32: c ^ (r / 2 % 4)). Every fragment read
// below (eight rows at one logical chunk, or four rows two apart) then
// touches 32 distinct banks, and the 16-byte cp.async writes stay whole.
#pragma once
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace fmma {

// the C entry points' type codes: 0 float32, 1 bfloat16, 2 float16
template <typename T>
__host__ __device__ constexpr int type_code() {
  return std::is_same<T, float>::value           ? 0
         : std::is_same<T, __nv_bfloat16>::value ? 1
                                                 : 2;
}

// -- asynchronous copies ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !in (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- swizzled tiles -----------------------------------------------------------

// element offset of (row r, column c) in a tile of rows of D elements of T
template <typename T, int D>
__device__ __forceinline__ int sw(int r, int c) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int NC = D / EPC;          // chunks per row
  static_assert(NC >= 4 && (NC & (NC - 1)) == 0, "unsupported row width");
  const int x = NC >= 8 ? (r & 7) : ((r >> 1) & 3);
  return r * D + (((c / EPC) ^ x) * EPC) + (c % EPC);
}

// Start the copy of rows [row0, row0 + ROWS) of a [rows, D] global view
// (row stride `stride` elements, D contiguous, 16-byte aligned) into the
// swizzled tile s; rows at or past n_rows are zero-filled.
template <typename T, int D, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(T* s, const T* g, int64_t stride,
                                          int row0, int n_rows, int tid) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int NC = D / EPC;
#pragma unroll
  for (int i = tid; i < ROWS * NC; i += NTHREADS) {
    const int r = i / NC, c = i % NC;
    const bool in = row0 + r < n_rows;
    const T* src = in ? g + (int64_t)(row0 + r) * stride + c * EPC : g;
    cp_async16(s + sw<T, D>(r, c * EPC), src, in);
  }
}

// -- tensor-core fragments ----------------------------------------------------

// The split: big = x rounded to nearest TF32 (ties away from zero, as
// cvt.rna.tf32.f32 rounds, in two integer operations: cvt itself is slow
// on sm_90a), small = x - big (exact in f32) rounded the same way, so the
// MMA's reading of an operand's top 19 bits drops nothing. A product then
// misses only small*small and small's rounding, each under 2^-22 of its
// size and of either sign, where truncating both (two operations fewer)
// lost up to 2^-20, always toward zero.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) &
          0xFFFFE000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x - bf16(x) for two neighbours, packed as bf16
__device__ __forceinline__ uint32_t res_bf16(float x0, float x1) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
  return pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
}

__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a,
                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rounds to nearest; past float16's range it gives inf
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x - f16(x) for two neighbours, packed as fp16
__device__ __forceinline__ uint32_t res_f16(float x0, float x1) {
  const __half2 hi = __floats2half2_rn(x0, x1);
  return pack_f16(x0 - __low2float(hi), x1 - __high2float(hi));
}

// what tells the two 16-bit operand types apart in Mma16
struct Bf16Ops {
  __device__ static uint32_t pack(float lo, float hi) {
    return pack_bf16(lo, hi);
  }
  __device__ static uint32_t res(float x0, float x1) {
    return res_bf16(x0, x1);
  }
  __device__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    mma_bf16(c, a, b);
  }
};

struct F16Ops {
  __device__ static uint32_t pack(float lo, float hi) {
    return pack_f16(lo, hi);
  }
  __device__ static uint32_t res(float x0, float x1) {
    return res_f16(x0, x1);
  }
  __device__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    mma_f16(c, a, b);
  }
};

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// One warp's products C[16 x 8] += A[16 x K] B[K x 8], K = Mma<T>::K, with
// the four ways the kernels read their operands:
//   a_rows: A from a tile whose rows are A's rows (Q, dO, K, V)
//   b_rows: B from a tile whose rows are B's columns (B^T stored: K, V, Q, dO
//           as the second factor of S = Q K^T and the like)
//   b_cols: B from a tile whose rows are B's rows (V in P V; K in dS K;
//           Q, dO in dS^T Q, P^T dO), read in the permuted k order of a_acc
//   a_acc:  A from accumulator registers c[NT][4] (P, dS), k-step kk
//   a_res:  the part of a_acc's operand that its rounding lost, where the
//           type rounds (bf16, fp16): P and dS rounded to bf16 carry a
//           relative error near 2^-9 (fp16 2^-12), which a 16-bit output
//           of the gradient hides but an f32 output (grad_dtypes) would
//           show; one more MMA with the residual x - T(x) brings it near
//           2^-17. Returns whether it filled r (never for fp32, whose split
//           keeps fp32 accuracy).
// The tile loads take row offsets that are multiples of 8 (of 16 for a_rows
// and, in bf16 and fp16, for k) and an Off of per-lane offsets computed
// once: the swizzle of every fragment then reduces to one XOR with a
// per-lane key (row r of a fragment has r % 8 fixed by the lane).
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int K = 8;
  struct A { uint32_t big[4], small[4]; };
  struct B { uint32_t big[2], small[2]; };
  // rows/cols patterns: element (g, t) of a_rows/b_rows at ar + (k ^ xa);
  // (2t, g) of b_cols at br + (n ^ xb)
  struct Off { int ar, xa, br, xb; };

  template <int D>
  __device__ static Off offsets(int lane) {
    const int g = lane >> 2, t = lane & 3;
    return {g * D + t, 4 * g, 2 * t * D + (g & 3), (4 * (g >> 2)) ^ (8 * t)};
  }

  template <int D>
  __device__ static void a_rows(A& a, const float* s, const Off& o, int m0,
                                int k0) {
    const float* p = s + m0 * D + o.ar;
    const int c = k0 ^ o.xa;
    const float x[4] = {p[c], p[8 * D + c], p[c ^ 4], p[8 * D + (c ^ 4)]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[i], a.big[i], a.small[i]);
  }

  template <int D>
  __device__ static void b_rows(B& b, const float* s, const Off& o, int n0,
                                int k0) {
    const float* p = s + n0 * D + o.ar;
    const int c = k0 ^ o.xa;
    split(p[c], b.big[0], b.small[0]);
    split(p[c ^ 4], b.big[1], b.small[1]);
  }

  template <int D>
  __device__ static void b_cols(B& b, const float* s, const Off& o, int k0,
                                int n0) {
    const float* p = s + k0 * D + o.br;
    const int c = n0 ^ o.xb;
    split(p[c], b.big[0], b.small[0]);
    split(p[D + (c ^ 4)], b.big[1], b.small[1]);
  }

  __device__ static void a_acc(A& a, const float (*c)[4], int kk) {
    split(c[kk][0], a.big[0], a.small[0]);
    split(c[kk][2], a.big[1], a.small[1]);
    split(c[kk][1], a.big[2], a.small[2]);
    split(c[kk][3], a.big[3], a.small[3]);
  }

  __device__ static bool a_res(A&, const float (*)[4], int, bool) {
    return false;
  }

  __device__ static void mma(float* c, const A& a, const B& b) {
    mma_tf32(c, a.small, b.big);
    mma_tf32(c, a.big, b.small);
    mma_tf32(c, a.big, b.big);
  }

  // c += A B for one k-step: its three MMAs summed from zero, then added
  // to c in one round-to-nearest add
  __device__ static void mma_add(float* c, const A& a, const B& b) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma(t, a, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += t[i];
  }
};

// bf16 and fp16 (T), whose conversions and MMA come from Ops
template <typename T, typename Ops>
struct Mma16 {
  static constexpr int K = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  // the address lane l hands ldmatrix: row offset + (k or n ^ key)
  struct Off { int la, ka, lb, kb, kc; };

  template <int D>
  __device__ static Off offsets(int lane) {
    const int r = lane & 7, hi = (lane >> 3) & 1;
    const int x = 8 * (D >= 64 ? r : (r >> 1) & 3);  // sw()'s chunk key
    return {(r + 8 * hi) * D, (8 * (lane >> 4)) ^ x, r * D, (8 * hi) ^ x, x};
  }

  template <int D>
  __device__ static void a_rows(A& a, const T* s, const Off& o, int m0,
                                int k0) {
    ldsm_x4(a.r, s + m0 * D + o.la + (k0 ^ o.ka));
  }

  template <int D>
  __device__ static void b_rows(B& b, const T* s, const Off& o, int n0,
                                int k0) {
    ldsm_x2(b.r, s + n0 * D + o.lb + (k0 ^ o.kb));
  }

  template <int D>
  __device__ static void b_cols(B& b, const T* s, const Off& o, int k0,
                                int n0) {
    ldsm_x2_trans(b.r, s + k0 * D + o.la + (n0 ^ o.kc));
  }

  __device__ static void a_acc(A& a, const float (*c)[4], int kk) {
    a.r[0] = Ops::pack(c[2 * kk][0], c[2 * kk][1]);
    a.r[1] = Ops::pack(c[2 * kk][2], c[2 * kk][3]);
    a.r[2] = Ops::pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a.r[3] = Ops::pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }

  __device__ static bool a_res(A& a, const float (*c)[4], int kk,
                               bool want) {
    if (!want) return false;
    a.r[0] = Ops::res(c[2 * kk][0], c[2 * kk][1]);
    a.r[1] = Ops::res(c[2 * kk][2], c[2 * kk][3]);
    a.r[2] = Ops::res(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a.r[3] = Ops::res(c[2 * kk + 1][2], c[2 * kk + 1][3]);
    return true;
  }

  __device__ static void mma(float* c, const A& a, const B& b) {
    Ops::mma(c, a.r, b.r);
  }

  // one MMA a k-step, chained: the operands' 16-bit rounding is far
  // above what the accumulation's truncation loses
  __device__ static void mma_add(float* c, const A& a, const B& b) {
    Ops::mma(c, a.r, b.r);
  }
};

template <>
struct Mma<__nv_bfloat16> : Mma16<__nv_bfloat16, Bf16Ops> {};

template <>
struct Mma<__half> : Mma16<__half, F16Ops> {};

// c[n] += P B over one warp's 32 rows of the tile s (k rows k0..k0+31, b_cols)
// for every 8-wide column tile n of D, with P held in the accumulators p
// (a_acc; plus its residual where `two`). Each column tile's sum over the 32
// rows starts from zero and reaches c in one round-to-nearest add: the
// tensor cores truncate as they accumulate, and a running sum fed by one
// MMA per k-step over a long sequence would drift by that bias (dK 1.1e-5
// of max |dK| from float64 at S = 1024 in fp32; 3.7e-6 with these sums).
// In fp32 each of its k-steps is itself summed from zero (mma_add).
template <typename T, int D>
__device__ __forceinline__ void mma_rows(float (*c)[4], const float (*p)[4],
                                         bool two, const T* s,
                                         const typename Mma<T>::Off& o,
                                         int k0) {
  using M = Mma<T>;
  constexpr int KS = 32 / M::K;
  typename M::A a[KS], res[KS];
  bool use_res = false;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    M::a_acc(a[kk], p, kk);
    use_res = M::a_res(res[kk], p, kk, two);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      typename M::B b;
      M::template b_cols<D>(b, s, o, k0 + kk * M::K, 8 * n);
      M::mma_add(t, a[kk], b);
      if (use_res) M::mma(t, res[kk], b);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] += t[i];
  }
}

// -- rows of an accumulator ---------------------------------------------------

// max and sum over the four lanes t that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- output -------------------------------------------------------------------

// two neighbouring elements (i, i + 1) of an output, i even, in the type
// of code out (type_code: 0 float32, 1 bfloat16, 2 float16; float16 past
// its range is inf)
__device__ __forceinline__ void store2(void* base, int64_t i, float x0,
                                       float x1, int out) {
  if (out == 1)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(base) +
                                       i) = __floats2bfloat162_rn(x0, x1);
  else if (out == 2)
    *reinterpret_cast<__half2*>(static_cast<__half*>(base) + i) =
        __floats2half2_rn(x0, x1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(base) + i) =
        make_float2(x0, x1);
}

}  // namespace fmma
