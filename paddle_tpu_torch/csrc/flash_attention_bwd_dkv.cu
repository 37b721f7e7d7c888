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
// dK/dV row is owned by one block, so the result is deterministic.
//
// Layout: q/k/v/dO/dK/dV are [B, S, H, D] read and written through their
// (b, s, h) strides with D contiguous; there is no transpose and no padding
// copy, the ragged tails are masked instead. lse and delta are [B, H, Sq]
// f32, contiguous.
//
// What bounds it on the H100: the main path runs it in fp32, and the card
// has no fp32 tensor-core rate (TF32 is off for parity), so the bound is
// the 67 TFLOP/s of fp32 FMA: four products per visible (q, k) pair (S,
// dP, dV and dK), 8*B*H*D*pairs flops, against (2*Sq + 2*Skv)*B*H*D*elem
// bytes plus lse, delta, dK and dV. At B=4, S=1024, H=16, D=128 causal
// that is 34.4 GFLOP (0.513 ms) against about 200 MB (0.06 ms): compute
// bound.
// What the design does about it: one block per (batch, head, 64-row key
// tile). K and V stay in shared memory; Q (pre-scaled), dO, lse and delta
// tiles stream through shared memory starting at query row k0 when causal
// (the first row that sees key k0), so fully masked tiles are never
// loaded. Every thread holds a 4x4 block of S and of dP and 4 x D/16 blocks
// of dK and dV in registers, so each shared load feeds several FMAs; the
// key tiles with the longest causal loops have the lowest block index and
// are issued first. bf16 inputs are widened to f32 on load and take the
// same FMA path; wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per inner tile
constexpr int BK = 64;        // keys per block
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int PSTR = BK + 1;  // padded row stride of the P and dS tiles

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// out_bf16: 0 writes float32, 1 writes bfloat16
__device__ __forceinline__ void store_out(void* base, int64_t i, float x,
                                          int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(base)[i] = x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * PSTR + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
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
                     float scale, int causal, int dk_bf16, int dv_bf16) {
  constexpr int KSTR = D + 1;  // padded row stride of the K, V, Q, dO tiles
  constexpr int CPT = D / 16;  // dK/dV columns per thread
  extern __shared__ float smem[];
  float* sK = smem;              // [BK][KSTR]
  float* sV = sK + BK * KSTR;    // [BK][KSTR]
  float* sQ = sV + BK * KSTR;    // [BQ][KSTR], pre-scaled
  float* sO = sQ + BQ * KSTR;    // [BQ][KSTR], dO
  float* sP = sO + BQ * KSTR;    // [BQ][PSTR], P
  float* sS = sP + BQ * PSTR;    // [BQ][PSTR], dS
  float* sL = sS + BQ * PSTR;    // [BQ], lse
  float* sD = sL + BQ;           // [BQ], delta

  const int kt = blockIdx.x;     // low tiles see the most queries: first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * BK;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const T* ob = dout + b * o_sb + h * o_sh;
  const float* lse_bh = lse + ((int64_t)b * H + h) * Sq;
  const float* delta_bh = delta + ((int64_t)b * H + h) * Sq;

  for (int idx = tid; idx < BK * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int col = k0 + r;
    const bool in = col < Skv;
    sK[r * KSTR + d] = in ? load_f(kb + col * k_ss + d) : 0.f;
    sV[r * KSTR + d] = in ? load_f(vb + col * v_ss + d) : 0.f;
  }

  float gk[4][CPT], gv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) gk[i][c] = gv[i][c] = 0.f;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt0 = causal ? k0 / BQ : 0;  // rows above k0 see no key here

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done (and sK/sV written)
    for (int idx = tid; idx < BQ * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int row = q0 + r;
      const bool in = row < Sq;
      sQ[r * KSTR + d] = in ? load_f(qb + row * q_ss + d) * scale : 0.f;
      sO[r * KSTR + d] = in ? load_f(ob + row * o_ss + d) : 0.f;
    }
    if (tid < BQ) {
      const int row = q0 + tid;
      sL[tid] = row < Sq ? lse_bh[row] : 0.f;
      sD[tid] = row < Sq ? delta_bh[row] : 0.f;
    }
    __syncthreads();

    // S = (scale Q) K^T and dP = dO V^T; this thread's pairs are query rows
    // ty + 16 i and keys tx + 16 j of the tile
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], o[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sQ[(ty + 16 * i) * KSTR + d];
        o[i] = sO[(ty + 16 * i) * KSTR + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = sK[(tx + 16 * j) * KSTR + d];
        bv[j] = sV[(tx + 16 * j) * KSTR + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(o[i], bv[j], dp[i][j]);
        }
    }

    // P = exp(S - lse) under the forward's masks, dS = P (dP - delta)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = row < Sq && col < Skv && (!causal || row >= col);
        const float p = ok ? expf(s[i][j] - sL[r]) : 0.f;
        sP[r * PSTR + tx + 16 * j] = p;
        sS[r * PSTR + tx + 16 * j] = p * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T (scale Q); this thread's rows are keys
    // ty + 16 i of the tile, its columns tx + 16 c
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float p[4], ds[4], o[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = sP[qq * PSTR + ty + 16 * i];
        ds[i] = sS[qq * PSTR + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        o[c] = sO[qq * KSTR + tx + 16 * c];
        qv[c] = sQ[qq * KSTR + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          gv[i][c] = fmaf(p[i], o[c], gv[i][c]);
          gk[i][c] = fmaf(ds[i], qv[c], gk[i][c]);
        }
    }
  }

  const int64_t kbase = b * dk_sb + h * dk_sh;
  const int64_t vbase = b * dv_sb + h * dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Skv) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      store_out(dk, kbase + row * dk_ss + tx + 16 * c, gk[i][c], dk_bf16);
      store_out(dv, vbase + row * dv_ss + tx + 16 * c, gv[i][c], dv_bf16);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int H, int Sq, int Skv,
                   const int64_t* st, float scale, int causal, int dk_bf16,
                   int dv_bf16, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
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
      st[17], scale, causal, dk_bf16, dv_bf16);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H,
                       int Sq, int Skv, const int64_t* st, float scale,
                       int causal, int dk_bf16, int dv_bf16,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv,
                           st, scale, causal, dk_bf16, dv_bf16, stream);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv,
                           st, scale, causal, dk_bf16, dv_bf16, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv,
                            st, scale, causal, dk_bf16, dv_bf16, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 18 int64 values, the (b, s, h) element strides of q, k, v, dout,
// dk and dv in that order; dtype (of q, k, v and dout), dk_dtype and
// dv_dtype: 0 = float32, 1 = bfloat16. lse and delta are [B, H, Sq] f32,
// contiguous. Returns a cudaError_t.
extern "C" int pt_flash_attention_bwd_dkv(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int H,
                                          int Sq, int Skv, int D,
                                          const int64_t* strides, float scale,
                                          int causal, int dtype, int dk_dtype,
                                          int dv_dtype, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || B > 65535 || H > 65535 ||
      (dk_dtype != 0 && dk_dtype != 1) || (dv_dtype != 0 && dv_dtype != 1))
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
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* pt_flash_attention_bwd_dkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
