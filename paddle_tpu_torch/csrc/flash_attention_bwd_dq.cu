// Flash-attention backward, dQ, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// paddle_tpu/ops/pallas_attention.py::_fa_bwd_dq_kernel (launched by
// _fa_bwd_with_lse). Same contract: recompute P = exp(s*scale - lse) under
// the forward's masks (keys past Skv never count; causal q_idx >= k_idx
// aligned top-left, also when Sq != Skv), dS = P * (dO.V^T - delta),
// dQ = scale * sum_k dS.K, all accumulated in f32; dQ is written in the
// output type the caller asks for (JAX's grad_dtypes). Masked
// probabilities are exactly 0, so a masked pair adds nothing. No atomics:
// every dQ row is owned by one block, and the two warps that share a row
// add their halves in a fixed order, so the result is deterministic.
//
// Layout: q/k/v/dO/dQ are [B, S, H, D] read and written through their
// (b, s, h) strides with D contiguous; no transpose and no padding copy,
// the ragged tails are zero-filled by the loads and masked. Every base
// pointer and stride must be 16-byte aligned (the wrapper checks). lse and
// delta are [B, H, Sq] f32, contiguous.
//
// What bounds it on the H100: three products per visible (q, k) pair (S,
// dP and dQ), 6*B*H*D*pairs operations. In bf16 and fp16 they run at the
// 989 TFLOP/s of the tensor cores; in fp32 as 3xTF32 (flash_mma.cuh),
// three TF32 MMAs per product at 495 TFLOP/s, so the fp32-accurate bound
// is 3 * 6*B*H*D*pairs / 495e12. At B=4, S=1024, H=16, D=128 causal that
// is 0.156 ms (bf16, fp16 0.026 ms) against about 170 MB of traffic (0.05 ms):
// bound by operations.
// What the design does about it: one block of 8 warps per (batch, head,
// 64-row q tile), heaviest causal tiles issued first. Q and dO stay in
// shared memory; K and V tiles of 64 keys stream through a two-stage ring
// of cp.async loads (tile t+1 loads while tile t multiplies) up to B1's
// causal trip count. Warp (r, c) owns q rows 16r..16r+15 and keys
// 32c..32c+31 of each tile: it forms S and dP with mma.sync, turns them
// into dS in registers, and feeds dS straight from its accumulators as
// the A operand of dQ += dS.K, so P and dS never touch shared memory; each
// tile's dQ contribution is summed on the tensor cores from zero and added
// to the running dQ in f32 (mma_rows), so the cores' truncating
// accumulation does not drift over a long key loop. At the end the two
// key halves' dQ partials meet once in shared memory. Tiles are unpadded
// and swizzled, so fragment reads are free of bank conflicts. What still
// bounds it: mma.sync issues at a fraction of the wgmma rate, and every
// warp splits each fp32 operand it reads for 3xTF32 (five operations,
// see split), also where warps share a tile.
#include "flash_mma.cuh"

namespace {

using namespace fmma;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per streamed tile
constexpr int THREADS = 256;  // 8 warps: 4 row groups x 2 key halves

template <typename T, int D>
constexpr size_t smem_bytes() {
  // Q, dO, and two stages each of K and V
  return sizeof(T) * (size_t)(6 * BQ * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, void* __restrict__ dq,
                    int H, int Sq, int Skv,
                    int64_t q_sb, int64_t q_ss, int64_t q_sh,
                    int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    int64_t v_sb, int64_t v_ss, int64_t v_sh,
                    int64_t o_sb, int64_t o_ss, int64_t o_sh,
                    int64_t g_sb, int64_t g_ss, int64_t g_sh,
                    float scale, int causal, int out_type) {
  using M = Mma<T>;
  constexpr int TILE = BQ * D;
  constexpr int NS = BK / 2 / 8;  // 8-wide key tiles of S per warp
  constexpr int ND = D / 8;       // 8-wide column tiles of dQ
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + TILE;
  T* sK = sO + TILE;      // [2][TILE]
  T* sV = sK + 2 * TILE;  // [2][TILE]

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
  const T* ob = dout + b * o_sb + h * o_sh;

  int n_kt = (Skv + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  load_tile<T, D, BQ, THREADS>(sQ, qb, q_ss, q0, Sq, tid);
  load_tile<T, D, BQ, THREADS>(sO, ob, o_ss, q0, Sq, tid);
  load_tile<T, D, BK, THREADS>(sK, kb, k_ss, 0, Skv, tid);
  load_tile<T, D, BK, THREADS>(sV, vb, v_ss, 0, Skv, tid);
  cp_async_commit();

  // this thread's accumulator rows: r0 (c[0], c[1]) and r0 + 8 (c[2], c[3])
  const int r0 = q0 + 16 * wr + g;
  const float* lse_bh = lse + ((int64_t)b * H + h) * Sq;
  const float* delta_bh = delta + ((int64_t)b * H + h) * Sq;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lse_r[i] = row < Sq ? lse_bh[row] : 0.f;
    delta_r[i] = row < Sq ? delta_bh[row] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {  // the next tile loads while this one multiplies
      const int nxt = (kt + 1) & 1;
      load_tile<T, D, BK, THREADS>(sK + nxt * TILE, kb, k_ss, (kt + 1) * BK,
                                   Skv, tid);
      load_tile<T, D, BK, THREADS>(sV + nxt * TILE, vb, v_ss, (kt + 1) * BK,
                                   Skv, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + (kt & 1) * TILE;
    const T* cV = sV + (kt & 1) * TILE;
    const int kw = 32 * wc;  // this warp's first key in the tile

    // S = Q K^T and dP = dO V^T over this warp's 16 x 32 pairs
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += M::K) {
      typename M::A aq, ao;
      M::template a_rows<D>(aq, sQ, off, 16 * wr, k0);
      M::template a_rows<D>(ao, sO, off, 16 * wr, k0);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        typename M::B bk, bv;
        M::template b_rows<D>(bk, cK, off, kw + 8 * j, k0);
        M::mma_add(s[j], aq, bk);
        M::template b_rows<D>(bv, cV, off, kw + 8 * j, k0);
        M::mma_add(dp[j], ao, bv);
      }
    }

    // P = exp(S*scale - lse) under the forward's masks; dS = P (dP - delta)
    const int c0 = kt * BK + kw + 2 * t;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + 8 * (i >> 1);
        const int col = c0 + 8 * j + (i & 1);
        const bool ok = row < Sq && col < Skv && (!causal || row >= col);
        const float p = ok ? expf(s[j][i] * scale - lse_r[i >> 1]) : 0.f;
        s[j][i] = p * (dp[j][i] - delta_r[i >> 1]);
      }

    // dQ += dS K, dS straight from the accumulators (and, for bf16 or fp16
    // inputs with an f32 dQ, the residual that dS's rounding lost)
    mma_rows<T, D>(acc, s, out_type == 0, cK, off, kw);
    __syncthreads();  // every warp is done with this stage
  }

  // the two key halves' partials meet in shared memory (K's stages are
  // free now): column tile n is finished and written by warp half n/(ND/2)
  float* red = reinterpret_cast<float*>(sK);
#pragma unroll
  for (int n = 0; n < ND; ++n)
    if (n / (ND / 2) != wc)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[((wr * ND + n) * 4 + i) * 32 + lane] = acc[n][i];
  __syncthreads();
  const int64_t gb = b * g_sb + h * g_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (n / (ND / 2) != wc) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[n][i] += red[((wr * ND + n) * 4 + i) * 32 + lane];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row < Sq)
        store2(dq, gb + row * g_ss + 8 * n + 2 * t, acc[n][2 * hh] * scale,
               acc[n][2 * hh + 1] * scale, out_type);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int H, int Sq, int Skv, const int64_t* st,
                   float scale, int causal, int out_type,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dq,
      H, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[12], st[13], st[14], scale, causal,
      out_type);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, int B, int H, int Sq,
                       int Skv, const int64_t* st, float scale, int causal,
                       int out_type, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st,
                           scale, causal, out_type, stream);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st,
                           scale, causal, out_type, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st,
                            scale, causal, out_type, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 15 int64 values, the (b, s, h) element strides of q, k, v, dout
// and dq in that order; dtype (of q, k, v and dout) and out_dtype (of dq):
// 0 = float32, 1 = bfloat16, 2 = float16. lse and delta are [B, H, Sq] f32,
// contiguous.
// Returns a cudaError_t.
extern "C" int pt_flash_attention_bwd_dq(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, int B, int H, int Sq,
                                         int Skv, int D,
                                         const int64_t* strides, float scale,
                                         int causal, int dtype, int out_dtype,
                                         void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || B > 65535 || H > 65535 ||
      out_dtype < 0 || out_dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, q, k, v, dout, l, dl, dq, B, H, Sq, Skv,
                            strides, scale, causal, out_dtype, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, dout, l, dl, dq, B, H, Sq,
                                    Skv, strides, scale, causal, out_dtype, s);
  else if (dtype == 2)
    err = dispatch_d<__half>(D, q, k, v, dout, l, dl, dq, B, H, Sq, Skv,
                             strides, scale, causal, out_dtype, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* pt_flash_attention_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
