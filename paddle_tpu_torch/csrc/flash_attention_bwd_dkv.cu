// Flash-attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
// paddle_tpu/ops/pallas_attention.py::_fa_bwd_dkv_kernel (launched by
// _fa_bwd_with_lse). Same contract: for each key tile, recompute
// P = exp(s*scale - lse) under the forward's masks (keys past Skv never
// count; causal q_idx >= k_idx aligned top-left, also when Sq != Skv) over
// the query tiles from the first one the causal mask lets see the tile,
// and accumulate dV += P^T.dO and dK += dS^T.(scale Q) with
// dS = P * (dO.V^T - delta), all in f32. dK and dV are written in the
// output types the caller asks for (JAX's grad_dtypes). No atomics: every
// dK/dV row is owned by one block, and the two warps that share a row add
// their halves in a fixed order, so the result is deterministic.
//
// Layout: q/k/v/dO/dK/dV are [B, S, H, D] read and written through their
// (b, s, h) strides with D contiguous; no transpose and no padding copy,
// the ragged tails are zero-filled by the loads and masked. Every base
// pointer and stride must be 16-byte aligned (the wrapper checks). lse and
// delta are [B, H, Sq] f32, contiguous.
//
// What bounds it on the H100: four products per visible (q, k) pair (S,
// dP, dV and dK), 8*B*H*D*pairs operations. In bf16 and fp16 they run at
// the 989 TFLOP/s of the tensor cores; in fp32 as 3xTF32 (flash_mma.cuh),
// three TF32 MMAs per product at 495 TFLOP/s, so the fp32-accurate bound
// is 3 * 8*B*H*D*pairs / 495e12. At B=4, S=1024, H=16, D=128 causal that
// is 0.208 ms (bf16, fp16 0.035 ms) against about 200 MB of traffic (0.06 ms):
// bound by operations.
// What the design does about it: one block of 8 warps per (batch, head,
// 64-key tile); the key tiles with the longest causal loops have the
// lowest block index and are issued first. K and V stay in shared memory;
// Q, dO, lse and delta tiles of 64 query rows stream through a two-stage
// ring of cp.async loads (tile t+1 loads while tile t multiplies), from
// the first tile the causal mask lets see key k0. Warp (r, c) owns keys
// 16r..16r+15 and query rows 32c..32c+31 of each tile. It forms the
// transposed scores S^T = K Q^T and dP^T = V dO^T with mma.sync, so that
// P^T and dS^T come out as accumulators in the layout of an A operand and
// feed dV += P^T dO and dK += dS^T Q from registers: P and dS never touch
// shared memory. Each tile's contributions are summed on the tensor cores
// from zero and added to the running dK and dV in f32 (mma_rows), so the
// cores' truncating accumulation does not drift over a long query loop. At
// the end the two query halves' dK/dV partials meet once in shared memory.
// Tiles are unpadded and swizzled, so fragment reads are free of bank
// conflicts. What still bounds it: mma.sync issues at a fraction of the
// wgmma rate; every warp splits each fp32 operand it reads for 3xTF32
// (five operations, see split); and at fp32 D=128 the dK and dV
// accumulators (128 registers a thread) leave none spare: 255 registers.
#include "flash_mma.cuh"

namespace {

using namespace fmma;

constexpr int BQ = 64;        // query rows per streamed tile
constexpr int BK = 64;        // keys per block
constexpr int THREADS = 256;  // 8 warps: 4 key groups x 2 query halves

template <typename T, int D>
constexpr size_t smem_bytes() {
  // K, V, two stages each of Q and dO, and two stages of lse and delta
  return sizeof(T) * (size_t)(6 * BQ * D) + sizeof(float) * 4 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, void* __restrict__ dk,
                     void* __restrict__ dv, int H, int Sq, int Skv,
                     int64_t q_sb, int64_t q_ss, int64_t q_sh,
                     int64_t k_sb, int64_t k_ss, int64_t k_sh,
                     int64_t v_sb, int64_t v_ss, int64_t v_sh,
                     int64_t o_sb, int64_t o_ss, int64_t o_sh,
                     int64_t dk_sb, int64_t dk_ss, int64_t dk_sh,
                     int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                     float scale, int causal, int dk_type, int dv_type) {
  using M = Mma<T>;
  constexpr int TILE = BQ * D;
  constexpr int NS = BQ / 2 / 8;  // 8-wide query tiles of S^T per warp
  constexpr int ND = D / 8;       // 8-wide column tiles of dK and dV
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + TILE;
  T* sQ = sV + TILE;      // [2][TILE]
  T* sO = sQ + 2 * TILE;  // [2][TILE]
  float* sL = reinterpret_cast<float*>(sO + 2 * TILE);  // [2][BQ] lse
  float* sD = sL + 2 * BQ;                               // [2][BQ] delta

  const int kt = blockIdx.x;  // low tiles see the most queries: first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * BK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) & 3;  // keys 16 wr ..
  const int wc = tid >> 7;        // query rows 32 wc .. of each tile
  const int g = lane >> 2, t = lane & 3;
  const typename M::Off off = M::template offsets<D>(lane);

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const T* ob = dout + b * o_sb + h * o_sh;
  const float* lse_bh = lse + ((int64_t)b * H + h) * Sq;
  const float* delta_bh = delta + ((int64_t)b * H + h) * Sq;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;  // rows above k0 see no key here

  // start the copy of query tile qt into stage st
  auto load_q = [&](int qt, int st) {
    const int r0 = qt * BQ;
    load_tile<T, D, BQ, THREADS>(sQ + st * TILE, qb, q_ss, r0, Sq, tid);
    load_tile<T, D, BQ, THREADS>(sO + st * TILE, ob, o_ss, r0, Sq, tid);
    if (tid < 2 * BQ) {
      const int i = tid % BQ, row = r0 + i;
      const float* src = tid < BQ ? lse_bh : delta_bh;
      float* dst = tid < BQ ? sL : sD;
      cp_async4(dst + st * BQ + i, row < Sq ? src + row : src, row < Sq);
    }
  };

  load_tile<T, D, BK, THREADS>(sK, kb, k_ss, k0, Skv, tid);
  load_tile<T, D, BK, THREADS>(sV, vb, v_ss, k0, Skv, tid);
  if (qt0 < n_qt) load_q(qt0, 0);
  cp_async_commit();

  float gk[ND][4], gv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) gk[n][i] = gv[n][i] = 0.f;

  // this thread's accumulator rows are keys r0 and r0 + 8
  const int r0 = k0 + 16 * wr + g;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < n_qt) {  // the next tile loads while this one multiplies
      load_q(qt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cQ = sQ + st * TILE;
    const T* cO = sO + st * TILE;
    const float* cL = sL + st * BQ;
    const float* cD = sD + st * BQ;
    const int qw = 32 * wc;  // this warp's first query row in the tile

    // S^T = K Q^T and dP^T = V dO^T over this warp's 16 x 32 pairs
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += M::K) {
      typename M::A ak, av;
      M::template a_rows<D>(ak, sK, off, 16 * wr, d0);
      M::template a_rows<D>(av, sV, off, 16 * wr, d0);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        typename M::B bq, bo;
        M::template b_rows<D>(bq, cQ, off, qw + 8 * j, d0);
        M::mma_add(s[j], ak, bq);
        M::template b_rows<D>(bo, cO, off, qw + 8 * j, d0);
        M::mma_add(dp[j], av, bo);
      }
    }

    // P^T = exp(S^T*scale - lse) under the forward's masks, kept in s;
    // dS^T = P^T (dP^T - delta), kept in dp
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = r0 + 8 * (i >> 1);
        const int c = qw + 8 * j + 2 * t + (i & 1);  // query row in tile
        const int row = qt * BQ + c;
        const bool ok = row < Sq && key < Skv && (!causal || row >= key);
        const float p = ok ? expf(s[j][i] * scale - cL[c]) : 0.f;
        s[j][i] = p;
        dp[j][i] = p * (dp[j][i] - cD[c]);
      }

    // dV += P^T dO and dK += dS^T Q, both A operands from the accumulators
    // (and, for bf16 or fp16 inputs with an f32 gradient, the residual
    // that the rounding of P or dS lost)
    mma_rows<T, D>(gv, s, dv_type == 0, cO, off, qw);
    mma_rows<T, D>(gk, dp, dk_type == 0, cQ, off, qw);
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();  // a block whose causal loop is empty still loaded K, V
  __syncthreads();

  // the two query halves' partials meet in shared memory (the Q and dO
  // stages are free now): column tile n is finished and written by warp
  // half n/(ND/2)
  float* red = reinterpret_cast<float*>(sQ);
  constexpr int PART = 4 * ND * 4 * 32;  // one gradient's floats
#pragma unroll
  for (int n = 0; n < ND; ++n)
    if (n / (ND / 2) != wc)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = ((wr * ND + n) * 4 + i) * 32 + lane;
        red[at] = gk[n][i];
        red[PART + at] = gv[n][i];
      }
  __syncthreads();
  const int64_t kbase = b * dk_sb + h * dk_sh;
  const int64_t vbase = b * dv_sb + h * dv_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (n / (ND / 2) != wc) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int at = ((wr * ND + n) * 4 + i) * 32 + lane;
      gk[n][i] += red[at];
      gv[n][i] += red[PART + at];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= Skv) continue;
      const int col = 8 * n + 2 * t;
      store2(dk, kbase + row * dk_ss + col, gk[n][2 * hh] * scale,
             gk[n][2 * hh + 1] * scale, dk_type);
      store2(dv, vbase + row * dv_ss + col, gv[n][2 * hh],
             gv[n][2 * hh + 1], dv_type);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int H, int Sq, int Skv,
                   const int64_t* st, float scale, int causal, int dk_type,
                   int dv_type, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dk,
      dv, H, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15], st[16],
      st[17], scale, causal, dk_type, dv_type);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H,
                       int Sq, int Skv, const int64_t* st, float scale,
                       int causal, int dk_type, int dv_type,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv,
                           st, scale, causal, dk_type, dv_type, stream);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv,
                           st, scale, causal, dk_type, dv_type, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv,
                            st, scale, causal, dk_type, dv_type, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 18 int64 values, the (b, s, h) element strides of q, k, v, dout,
// dk and dv in that order; dtype (of q, k, v and dout), dk_dtype and
// dv_dtype: 0 = float32, 1 = bfloat16, 2 = float16. lse and delta are
// [B, H, Sq] f32, contiguous. Returns a cudaError_t.
extern "C" int pt_flash_attention_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int H,
                                          int Sq, int Skv, int D,
                                          const int64_t* strides, float scale,
                                          int causal, int dtype, int dk_dtype,
                                          int dv_dtype, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || B > 65535 || H > 65535 ||
      dk_dtype < 0 || dk_dtype > 2 || dv_dtype < 0 || dv_dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, q, k, v, dout, l, dl, dk, dv, B, H, Sq, Skv,
                            strides, scale, causal, dk_dtype, dv_dtype, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, dout, l, dl, dk, dv, B, H,
                                    Sq, Skv, strides, scale, causal, dk_dtype,
                                    dv_dtype, s);
  else if (dtype == 2)
    err = dispatch_d<__half>(D, q, k, v, dout, l, dl, dk, dv, B, H, Sq, Skv,
                             strides, scale, causal, dk_dtype, dv_dtype, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* pt_flash_attention_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
