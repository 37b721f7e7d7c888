// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/pallas_attention.py::_fa_kernel
// (launched by _fa_fwd_with_lse). Same contract: exact attention with an
// online softmax (f32 running max m, sum l and accumulator), padded keys
// masked by k_idx < Skv, causal mask q_idx >= k_idx aligned top-left (also
// when Sq != Skv) with the key loop cut after ceil((q0 + BQ) / BK) tiles,
// output O in the input type and f32 LSE = m + log(max(l, 1e-30)).
// Masked scores take -1e30, never -inf, and masked probabilities are 0, so
// a row that sees no key gives O = 0 instead of NaN.
//
// Layout: q/k/v/o are [B, S, H, D] read through their (b, s, h) strides
// with D contiguous; there is no transpose and no padding copy, the ragged
// tail of the last tile is masked instead. lse is [B, H, Sq] contiguous.
//
// What bounds it on the H100: the main path runs it in fp32, and the card
// has no fp32 tensor-core rate (TF32 is off for parity), so the bound is
// the 67 TFLOP/s of fp32 FMA: 4*B*H*Sq*Skv*D flops (about halved when
// causal) against (2*Sq + 2*Skv)*B*H*D*4 bytes plus the LSE. At B=4,
// S=1024, H=16, D=128 causal that is 17.2 GFLOP (0.26 ms) against 134 MB
// (0.04 ms): compute bound.
// What the design does about it: each block owns one (batch, head,
// 64-row q tile) and keeps Q, one 64-key K/V tile and the P tile in shared
// memory; every thread holds a 4x4 block of scores and a 4 x D/16 block of
// the output in registers, so each shared-memory load feeds several FMAs.
// Causal tiles are issued heaviest first. bf16 inputs are widened to f32
// on load and use the same FMA path; wgmma, TMA and a tuned tile shape are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per inner tile
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int PSTR = BK + 1;  // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// sum / max over the 16 lanes that share one score row
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PSTR);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Skv,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 float scale, int causal) {
  constexpr int KSTR = D + 1;  // padded row stride of the Q and K tiles
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][KSTR], pre-scaled
  float* sK = sQ + BQ * KSTR;   // [BK][KSTR]
  float* sV = sK + BK * KSTR;   // [BK][D]
  float* sP = sV + BK * D;      // [BQ][PSTR]

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

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int row = q0 + r;
    sQ[r * KSTR + d] = row < Sq ? load_f(qb + row * q_ss + d) * scale : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (Skv + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ + BK - 1) / BK);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done (and sQ is written)
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int col = k0 + r;
      const bool in = col < Skv;
      sK[r * KSTR + d] = in ? load_f(kb + col * k_ss + d) : 0.f;
      sV[r * D + d] = in ? load_f(vb + col * v_ss + d) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * KSTR + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * KSTR + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < Skv && (!causal || row >= col);
        s[i][j] = ok[j] ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * PSTR + tx + 16 * j] = p;
        rs += p;
      }
      rs = row_sum16(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * PSTR + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store_f(ob + row * o_ss + tx + 16 * c, acc[i][c] / denom);
    if (tx == 0) lse[((int64_t)b * H + h) * Sq + row] = m[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Sq, int Skv,
                   const int64_t* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Skv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, float* lse, int B, int H, int Sq, int Skv,
                       const int64_t* st, float scale, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 values, (b, s, h) element strides of q, k, v and o in
// that order; dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t.
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
    err = dispatch_d<float>(D, q, k, v, o, l, B, H, Sq, Skv, strides, scale, causal, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, o, l, B, H, Sq, Skv, strides, scale, causal, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* pt_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
