// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_attention.py::_fa_kernel
// (launched by _fa_fwd_with_lse). Same contract: exact attention with an
// online softmax (f32 running max m, sum l and accumulator), padded keys
// masked by k_idx < Skv, causal mask q_idx >= k_idx aligned top-left (also
// when Sq != Skv) with the key loop cut after ceil((q0 + BQ) / BK) tiles,
// output O in the input type and f32 LSE = m + log(max(l, 1e-30)).
// Masked scores take -1e30, never -inf, and masked probabilities are 0, so
// a row that sees no key gives O = 0 instead of NaN. No atomics: every
// output row is owned by one block, and the two warps that share a row
// merge their halves in a fixed order, so the result is deterministic.
//
// Layout: q/k/v/o are [B, S, H, D] read and written through their
// (b, s, h) strides with D contiguous; there is no transpose and no
// padding copy, the ragged tails are zero-filled by the loads and masked.
// Every base pointer and stride must be 16-byte aligned (the wrapper
// checks). lse is [B, H, Sq] f32, contiguous.
//
// What bounds it on the H100: two products per visible (q, k) pair (S and
// P V), 4*B*H*D*pairs operations. In bf16 and fp16 they run at the 989
// TFLOP/s of the tensor cores; in fp32 as 3xTF32 (flash_mma.cuh), three
// TF32 MMAs per product at 495 TFLOP/s, so the fp32-accurate bound is
// 3 * 4*B*H*D*pairs / 495e12. At B=4, S=1024, H=16, D=128 causal that is
// 0.104 ms (bf16, fp16 0.017 ms) against 134 MB of traffic (0.04 ms):
// bound by operations.
// What the design does about it: one block of 8 warps per (batch, head,
// 64-row q tile), heaviest causal tiles issued first. Q stays in shared
// memory (fp32: scaled in f32 before it is split, as the JAX kernel
// scales it, here by scale * log2(e)); K and V tiles of 64 keys stream
// through a three-stage ring of cp.async loads (tiles t+1 and t+2 load
// while tile t multiplies, one barrier per tile). The softmax runs in base
// 2 (scores scaled by scale * log2(e), p = exp2(s - m), LSE = m ln 2 +
// log(l)). Warp (r, c) owns q rows 16r..16r+15 and keys 32c..32c+31 of
// each tile and carries its own online softmax over its half of the keys:
// it forms S with mma.sync (bf16 and fp16: scaled in f32 after the
// product, since a scale folded into 16-bit operands would move the LSE
// by up to ~1e-2), takes the row maxima over the four lanes of a row,
// turns S into P in registers and feeds P straight from its accumulators
// as the A operand of O += P V, so P never touches shared memory. The row
// sums come from the f32 P, before bf16 or fp16 rounds it for the
// product. Each tile's P V is summed on the tensor cores from zero and
// added to the rescaled O in f32 (mma_rows), so the cores' truncating
// accumulation does not drift over a long key loop. Masks are applied
// only in the diagonal tile and the ragged last tile. At the end the two
// key halves' (m, l, O) meet once in shared memory. What still bounds it:
// mma.sync issues at a fraction of the wgmma rate, and every warp splits
// each fp32 operand it reads for 3xTF32.
#include <type_traits>

#include "flash_mma.cuh"

namespace {

using namespace fmma;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per streamed tile
constexpr int STAGES = 3;     // K/V tiles in flight: one barrier per tile
constexpr int THREADS = 256;  // 8 warps: 4 row groups x 2 key halves
constexpr float NEG_INF = -1e30f;
constexpr double LOG2E = 1.4426950408889634;
constexpr float LN2 = 0.6931471805599453f;

template <typename T, int D>
constexpr size_t smem_bytes() {
  // Q and STAGES stages each of K and V (fp32 at D = 128: 224 KiB)
  return sizeof(T) * (size_t)((1 + 2 * STAGES) * BQ * D);
}

// Online softmax over one warp's 16 x 32 scores of a tile, in base 2: s
// (scaled by scale * log2(e)) in, P = 2^(s - m) out in place; m, l (this
// thread's partial row sums) and the output rows o rescaled to the new
// maximum. MASK: some pair of the tile is masked (keys past Skv, or above
// the causal diagonal).
template <bool MASK, int NS, int ND>
__device__ __forceinline__ void softmax_tile(float (*s)[4], float* m,
                                             float* l, float (*o)[4],
                                             int row0, int col0, int Skv,
                                             int causal) {
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 8 * (i >> 1);
        const int col = col0 + 8 * j + (i & 1);
        if (col >= Skv || (causal && row < col)) s[j][i] = NEG_INF;
      }
  }
  float m_new[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    m_new[r] = fmaxf(m[r], quad_max(mx));
    alpha[r] = exp2f(m[r] - m_new[r]);
    m[r] = m_new[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = s[j][i];
      const float p =
          (MASK && x == NEG_INF) ? 0.f : exp2f(x - m_new[i >> 1]);
      s[j][i] = p;
      l[i >> 1] += p;
    }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] *= alpha[i >> 1];
}

// bf16 and fp16 keep two blocks on an SM (128 registers: bf16 at D = 128
// spills 152 bytes and still runs 6% faster than one block of 192
// registers, PERF.md); fp32 needs its ~240 registers and one block
template <typename T, int D>
__global__ void __launch_bounds__(THREADS,
                                  std::is_same<T, float>::value ? 1 : 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Skv,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 float scale_log2, int causal) {
  using M = Mma<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int TILE = BQ * D;
  constexpr int NS = BK / 2 / 8;  // 8-wide key tiles of S per warp
  constexpr int ND = D / 8;       // 8-wide column tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + TILE;           // [STAGES][TILE]
  T* sV = sK + STAGES * TILE;  // [STAGES][TILE]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) & 3;  // q rows 16 wr ..
  const int wc = tid >> 7;        // keys 32 wc .. of each tile
  const int g = lane >> 2, t = lane & 3;
  const typename M::Off off = M::template offsets<D>(lane);

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  int n_kt = (Skv + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  // start the copy of key tile kt into its stage
  auto load_kv = [&](int kt) {
    const int st = kt % STAGES;
    load_tile<T, D, BK, THREADS>(sK + st * TILE, kb, k_ss, kt * BK, Skv, tid);
    load_tile<T, D, BK, THREADS>(sV + st * TILE, vb, v_ss, kt * BK, Skv, tid);
  };
  load_kv(0);
  if constexpr (F32) {
    // Q scaled in f32 on its way in, while the first K/V tile loads
    constexpr int NC = D / 4;
#pragma unroll
    for (int i = tid; i < BQ * NC; i += THREADS) {
      const int r = i / NC, c = i % NC;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < Sq)
        x = *reinterpret_cast<const float4*>(qb + (int64_t)(q0 + r) * q_ss +
                                             4 * c);
      x.x *= scale_log2;
      x.y *= scale_log2;
      x.z *= scale_log2;
      x.w *= scale_log2;
      *reinterpret_cast<float4*>(sQ + sw<T, D>(r, 4 * c)) = x;
    }
  } else {
    load_tile<T, D, BQ, THREADS>(sQ, qb, q_ss, q0, Sq, tid);
  }
  cp_async_commit();
  if (n_kt > 1) load_kv(1);
  cp_async_commit();  // one group per tile, empty past the last

  // this thread's accumulator rows: r0 (c[0], c[1]) and r0 + 8 (c[2], c[3])
  const int r0 = q0 + 16 * wr + g;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<1>();  // tile kt has landed (tile kt + 1 may be loading)
    // tile kt is visible to every warp, and every warp is done with tile
    // kt - 1, whose stage tile kt + 2 now takes
    __syncthreads();
    if (kt + 2 < n_kt) load_kv(kt + 2);
    cp_async_commit();
    const T* cK = sK + (kt % STAGES) * TILE;
    const T* cV = sV + (kt % STAGES) * TILE;
    const int kw = 32 * wc;  // this warp's first key in the tile

    // S = Q K^T over this warp's 16 x 32 pairs
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += M::K) {
      typename M::A aq;
      M::template a_rows<D>(aq, sQ, off, 16 * wr, k0);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        typename M::B bk;
        M::template b_rows<D>(bk, cK, off, kw + 8 * j, k0);
        M::mma_add(s[j], aq, bk);
      }
    }
    if constexpr (!F32) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] *= scale_log2;
    }

    // P = 2^(S - m) under the masks, the rows' m and l, O rescaled
    const int c0 = kt * BK + kw + 2 * t;
    const bool edge = (kt + 1) * BK > Skv || (causal && kt * BK + BK - 1 > q0);
    if (edge)
      softmax_tile<true, NS, ND>(s, m, l, acc, r0, c0, Skv, causal);
    else
      softmax_tile<false, NS, ND>(s, m, l, acc, r0, c0, Skv, causal);

    // O += P V, P straight from the accumulators
    mma_rows<T, D>(acc, s, false, cV, off, kw);
  }
  __syncthreads();  // every warp is done with the K and V stages

  // the two key halves meet in shared memory (the K and V stages are free
  // now): each warp's rows' m and l, and the column tiles of O the other
  // half finishes (column tile n by warp half n/(ND/2))
  float* red = reinterpret_cast<float*>(sK);
  float* sml = reinterpret_cast<float*>(sV);  // [2 halves][m, l][BQ]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if (t == 0) {
      const int row = 16 * wr + g + 8 * r;
      sml[(2 * wc) * BQ + row] = m[r];
      sml[(2 * wc + 1) * BQ + row] = l[r];
    }
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
    if (n / (ND / 2) != wc)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[((wr * ND + n) * 4 + i) * 32 + lane] = acc[n][i];
  __syncthreads();
  float f_own[2], f_other[2], den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * wr + g + 8 * r;
    const float m_o = sml[(2 * (1 - wc)) * BQ + row];
    const float l_o = sml[(2 * (1 - wc) + 1) * BQ + row];
    const float mx = fmaxf(m[r], m_o);
    f_own[r] = exp2f(m[r] - mx);
    f_other[r] = exp2f(m_o - mx);
    const float denom = fmaxf(l[r] * f_own[r] + l_o * f_other[r], 1e-30f);
    den[r] = denom;
    const int grow = r0 + 8 * r;
    if (wc == 0 && t == 0 && grow < Sq)
      lse[((int64_t)b * H + h) * Sq + grow] = mx * LN2 + logf(denom);
  }
  const int64_t ob = b * o_sb + h * o_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (n / (ND / 2) != wc) continue;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = (acc[n][i] * f_own[i >> 1] +
              red[((wr * ND + n) * 4 + i) * 32 + lane] * f_other[i >> 1]) /
             den[i >> 1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row < Sq)
        store2(o, ob + row * o_ss + 8 * n + 2 * t, x[2 * hh], x[2 * hh + 1],
               type_code<T>());
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Sq, int Skv,
                   const int64_t* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Skv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], (float)(scale * LOG2E), causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int H, int Sq, int Skv,
                       const int64_t* st, float scale, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Skv, st, scale,
                            causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 values, (b, s, h) element strides of q, k, v and o in
// that order; dtype 0 = float32, 1 = bfloat16, 2 = float16. Returns a
// cudaError_t.
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int H, int Sq, int Skv, int D,
                                      const int64_t* strides, float scale,
                                      int causal, int dtype, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, q, k, v, o, l, B, H, Sq, Skv, strides, scale,
                            causal, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, o, l, B, H, Sq, Skv, strides,
                                    scale, causal, s);
  else if (dtype == 2)
    err = dispatch_d<__half>(D, q, k, v, o, l, B, H, Sq, Skv, strides, scale,
                             causal, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* pt_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
