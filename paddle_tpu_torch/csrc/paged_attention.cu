// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/paged_attention.py::
// _paged_attn_kernel (launched by paged_attention). Same contract: one
// query per sequence attends over K/V rows scattered across a page arena;
// logical row j of sequence s lives at page block_tables[s, j / page] and
// in-page row j % page; rows j <= positions[s] are visible (the token just
// written sees itself); online softmax across pages; a sequence that sees
// no row gets 0.
//
// The TPU grid walked the page axis as its innermost sequential grid axis
// and carried m/l/acc across steps in VMEM scratch, with the page ids
// scalar-prefetched into the BlockSpec index maps. Here one block owns one
// (sequence, head): it reads its own block-table row and its warps walk the
// visible rows in an interleaved loop, each warp carrying its own m/l/acc
// in registers; the warps' partial softmax states are merged once through
// shared memory at the end. Pages past positions[s] / page are never read.
//
// The arena arguments are ONE layer's view of a [P+1, L, page, H, D] arena,
// so they are strided: the page, row and head strides are passed in and
// nothing is copied. Block-table entries outside [0, n_arena_pages) are
// treated as masked rather than read.
//
// What bounds it on the H100: bytes. A decode step reads every visible K
// and V row once, 2 * sum_s(positions[s] + 1) * H * D * elem bytes, and does
// 4 flops per element read, so at 3.35 TB/s the memory time is far above
// the compute time. What the design does about it: each lane issues the
// loads of four K rows and four V rows before it uses any of them, and
// neighbouring lanes read neighbouring elements of a row, so every warp
// keeps eight coalesced 32-element reads in flight. Splitting long
// sequences across blocks (flash decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 4;  // rows each warp loads per step
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_arena,
                       const T* __restrict__ v_arena, T* __restrict__ out,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ positions, int H,
                       int page_size, int pages_per_seq, int n_arena_pages,
                       int64_t q_ss, int64_t q_sh,
                       int64_t k_sp, int64_t k_sr, int64_t k_sh,
                       int64_t v_sp, int64_t v_sr, int64_t v_sh,
                       int64_t bt_ss, float scale) {
  constexpr int E = D / 32;  // elements of a row per lane
  __shared__ float s_m[WARPS];
  __shared__ float s_l[WARPS];
  __shared__ float s_acc[WARPS][D];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  float qv[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    qv[e] = load_f(q + s * q_ss + h * q_sh + e * 32 + lane) * scale;

  const int* bt = block_tables + s * bt_ss;
  const int n_rows = min(positions[s] + 1, pages_per_seq * page_size);

  float m = NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  for (int j0 = warp * ROWS; j0 < n_rows; j0 += WARPS * ROWS) {
    float kr[ROWS][E], vr[ROWS][E];
    bool ok[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int j = j0 + r;
      const int pid = j < n_rows ? bt[j / page_size] : -1;
      ok[r] = pid >= 0 && pid < n_arena_pages;
      const int64_t row = (j % page_size);
      const T* kp = k_arena + pid * k_sp + row * k_sr + h * k_sh;
      const T* vp = v_arena + pid * v_sp + row * v_sr + h * v_sh;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[r][e] = ok[r] ? load_f(kp + e * 32 + lane) : 0.f;
        vr[r][e] = ok[r] ? load_f(vp + e * 32 + lane) : 0.f;
      }
    }
    float sc[ROWS];
    float mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qv[e], kr[r][e], dot);
      dot = warp_sum(dot);
      sc[r] = ok[r] ? dot : NEG_INF;
      mx = fmaxf(mx, sc[r]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float p = ok[r] ? expf(sc[r] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(p, vr[r][e], acc[e]);
    }
    m = m_new;
  }

  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) s_acc[warp][e * 32 + lane] = acc[e];
  __syncthreads();

  for (int c = threadIdx.x; c < D; c += THREADS) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, s_m[w]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(s_m[w] - M);
      L = fmaf(s_l[w], f, L);
      A = fmaf(s_acc[w][c], f, A);
    }
    store_f(out + ((int64_t)s * H + h) * D + c, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* bt, const int* pos, int S, int H, int page,
                   int pps, int n_pages, const int64_t* st, float scale,
                   cudaStream_t stream) {
  dim3 grid(S, H);
  paged_attention_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bt, pos, H, page, pps,
      n_pages, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, const int* bt, const int* pos, int S,
                       int H, int page, int pps, int n_pages,
                       const int64_t* st, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, bt, pos, S, H, page, pps, n_pages, st, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, bt, pos, S, H, page, pps, n_pages, st, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, bt, pos, S, H, page, pps, n_pages, st, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 8 int64 element strides, in order q (s, h), k arena (page, row,
// head), v arena (page, row, head); bt_ss is the block-table row stride.
// dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int pt_paged_attention(const void* q, const void* k_arena,
                                  const void* v_arena, void* out,
                                  const void* block_tables,
                                  const void* positions, int S, int H, int D,
                                  int page_size, int pages_per_seq,
                                  int n_arena_pages, const int64_t* strides,
                                  int64_t bt_ss, float scale, int dtype,
                                  void* stream) {
  if (S < 1 || H < 1 || page_size < 1 || pages_per_seq < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  int64_t st[9];
  for (int i = 0; i < 8; ++i) st[i] = strides[i];
  st[8] = bt_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* pos = static_cast<const int*>(positions);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, q, k_arena, v_arena, out, bt, pos, S, H,
                            page_size, pages_per_seq, n_arena_pages, st,
                            scale, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, q, k_arena, v_arena, out, bt, pos, S,
                                    H, page_size, pages_per_seq,
                                    n_arena_pages, st, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* pt_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
