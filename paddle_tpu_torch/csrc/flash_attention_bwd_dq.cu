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
// every dQ row is owned by one block, so the result is deterministic.
//
// Layout: q/k/v/dO/dQ are [B, S, H, D] read and written through their
// (b, s, h) strides with D contiguous; there is no transpose and no padding
// copy, the ragged tail of the last tile is masked instead. lse and delta
// are [B, H, Sq] f32, contiguous.
//
// What bounds it on the H100: the main path runs it in fp32, and the card
// has no fp32 tensor-core rate (TF32 is off for parity), so the bound is
// the 67 TFLOP/s of fp32 FMA: three products per visible (q, k) pair (S,
// dP and dQ), 6*B*H*D*pairs flops, against (2*Sq + 2*Skv)*B*H*D*elem
// bytes plus lse, delta and dQ. At B=4, S=1024, H=16, D=128 causal that is
// 25.8 GFLOP (0.385 ms) against about 170 MB (0.05 ms): compute bound.
// What the design does about it: one block per (batch, head, 64-row q
// tile), as the forward kernel. Q (pre-scaled) and dO stay in shared memory
// and each thread keeps its rows' lse and delta in registers for the whole
// key loop; K and V tiles stream through shared memory up to the forward's
// causal trip count ceil((q0 + 64) / 64). Every thread holds a 4x4 block of
// S and of dP and a 4 x D/16 block of dQ in registers, so each shared load
// feeds several FMAs. Heavy causal tiles are issued first. bf16 inputs are
// widened to f32 on load and take the same FMA path; wgmma and TMA are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per inner tile
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int PSTR = BK + 1;  // padded row stride of the dS tile

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
  return sizeof(float) * (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * PSTR);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
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
                    float scale, int causal, int out_bf16) {
  constexpr int KSTR = D + 1;  // padded row stride of the Q, dO, K, V tiles
  constexpr int CPT = D / 16;  // dQ columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][KSTR], pre-scaled
  float* sO = sQ + BQ * KSTR;    // [BQ][KSTR], dO
  float* sK = sO + BQ * KSTR;    // [BK][KSTR]
  float* sV = sK + BK * KSTR;    // [BK][KSTR]
  float* sS = sV + BK * KSTR;    // [BQ][PSTR], dS

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const T* ob = dout + b * o_sb + h * o_sh;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int row = q0 + r;
    const bool in = row < Sq;
    sQ[r * KSTR + d] = in ? load_f(qb + row * q_ss + d) * scale : 0.f;
    sO[r * KSTR + d] = in ? load_f(ob + row * o_ss + d) : 0.f;
  }

  const float* lse_bh = lse + ((int64_t)b * H + h) * Sq;
  const float* delta_bh = delta + ((int64_t)b * H + h) * Sq;
  float lse_r[4], delta_r[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < Sq ? lse_bh[row] : 0.f;
    delta_r[i] = row < Sq ? delta_bh[row] : 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (Skv + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done (and sQ/sO written)
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int col = k0 + r;
      const bool in = col < Skv;
      sK[r * KSTR + d] = in ? load_f(kb + col * k_ss + d) : 0.f;
      sV[r * KSTR + d] = in ? load_f(vb + col * v_ss + d) : 0.f;
    }
    __syncthreads();

    // S = (scale Q) K^T and dP = dO V^T for this thread's 4 x 4 pairs
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
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = row < Sq && col < Skv && (!causal || row >= col);
        const float p = ok ? expf(s[i][j] - lse_r[i]) : 0.f;
        sS[(ty + 16 * i) * PSTR + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sS[(ty + 16 * i) * PSTR + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = sK[kk * KSTR + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(a[i], kv[c], acc[i][c]);
    }
  }

  const int64_t gb = b * g_sb + h * g_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store_out(dq, gb + row * g_ss + tx + 16 * c, acc[i][c] * scale, out_bf16);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int H, int Sq, int Skv, const int64_t* st,
                   float scale, int causal, int out_bf16,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
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
      out_bf16);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dq, int B, int H, int Sq,
                       int Skv, const int64_t* st, float scale, int causal,
                       int out_bf16, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st,
                           scale, causal, out_bf16, stream);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st,
                           scale, causal, out_bf16, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv, st,
                            scale, causal, out_bf16, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 15 int64 values, the (b, s, h) element strides of q, k, v, dout
// and dq in that order; dtype (of q, k, v and dout) and out_dtype (of dq):
// 0 = float32, 1 = bfloat16. lse and delta are [B, H, Sq] f32, contiguous.
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
      (out_dtype != 0 && out_dtype != 1))
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
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* pt_flash_attention_bwd_dq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
