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
// scalar-prefetched into the BlockSpec index maps. Here the visible rows
// of each sequence are cut into chunks of chunk_pages pages, and one block
// owns one (sequence, head, chunk): the grid is (S, H, chunks), and a
// chunk past its sequence's last visible row exits at once. The block
// copies its chunk's block-table entries into shared memory; every group
// of lanes that loads one row (16 bytes a lane, see "Head dims" below)
// carries its own m/l/acc in registers over the rows it takes, and the
// block merges its groups' states once through shared memory. A sequence of one chunk writes its output
// there. Otherwise each chunk writes (m, l, acc[D]) in f32 to a workspace;
// the last block of a (sequence, head) to finish, found by __threadfence
// and an atomic ticket, merges the chunks in chunk order, writes the
// output and resets the ticket to 0. So one launch serves a layer, and
// the result is bitwise repeatable: no float atomics, and every sum runs
// in a fixed order whichever block finishes last.
//
// The arena arguments are ONE layer's view of a [P+1, L, page, H, D] arena,
// so they are strided: the page, row and head strides are passed in and
// nothing is copied. Block-table entries outside [0, n_arena_pages) are
// treated as masked rather than read.
//
// Types and head dims: float32, bfloat16 and float16, any D from 1 to
// MAX_D, as the TPU kernel takes any type and head dim. Lanes load a row
// in vectors of VB bytes: 16 where the row is whole 16-byte vectors and
// every base pointer and stride is 16-byte aligned (the wrapper checks),
// else one element (D = 100 in bf16, or a view shifted off 16 bytes). A
// row's NV = D * elem / VB vectors go to LPR lanes, the power of two at
// or above NV (at most 32; always 32 for one-element vectors), VPL
// vectors a lane; lanes past the row load nothing and add 0 (D = 80 in
// f32: 20 of 32 lanes busy). Every type accumulates in f32 and rounds
// once, at the output.
//
// What bounds it on the H100: bytes. A decode step reads every visible K
// and V row once, 2 * sum_s(positions[s] + 1) * H * D * elem bytes, and
// does 4 flops per element read, so at 3.35 TB/s the memory time is far
// above the compute time. What the design does about it: the chunks spread
// a long sequence over many SMs (one block per (sequence, head) left most
// SMs idle while the longest sequence walked all its rows), and each lane
// issues eight K loads and eight V loads (16 bytes each on the wide path)
// before it uses any of them, neighbouring lanes on neighbouring bytes of
// a row.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int U = 8;  // loads of K (and of V) each lane issues a step
constexpr int MAX_D = 1024;  // the widest head taken
constexpr float NEG_INF = -1e30f;
// the most pages of one chunk (its block-table entries in shared memory)
constexpr int MAX_CHUNK_PAGES = 1024;

// a vector of VB bytes as the kernel loads it
template <int VB> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<4> { using type = unsigned int; };
template <> struct Vec<2> { using type = unsigned short; };

__device__ __forceinline__ void to_f(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void to_f(const uint4& u, float* f,
                                     __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void to_f(const uint4& u, float* f, __half) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void to_f(unsigned int u, float* f, float) {
  f[0] = __uint_as_float(u);
}

__device__ __forceinline__ void to_f(unsigned short u, float* f,
                                     __nv_bfloat16) {
  f[0] = __bfloat162float(__ushort_as_bfloat16(u));
}

__device__ __forceinline__ void to_f(unsigned short u, float* f, __half) {
  f[0] = __half2float(__ushort_as_half(u));
}

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_f(__half* p, float x) {
  *p = __float2half(x);
}

// VB-byte vectors, LPR lanes a row (a power of two), VPL vectors a lane;
// D at run time, at most LPR * VPL * VB / elem.
template <typename T, int VB, int LPR, int VPL>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_arena,
                       const T* __restrict__ v_arena, T* __restrict__ out,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ positions,
                       float* __restrict__ ws, int* __restrict__ tickets,
                       int H, int D, int page_size, int pages_per_seq,
                       int n_arena_pages, int chunk_pages,
                       int64_t q_ss, int64_t q_sh,
                       int64_t k_sp, int64_t k_sr, int64_t k_sh,
                       int64_t v_sp, int64_t v_sr, int64_t v_sh,
                       int64_t bt_ss, float scale) {
  using V = typename Vec<VB>::type;
  constexpr int EPL = VB / sizeof(T);  // elements of a vector
  constexpr int RPI = 32 / LPR;        // rows per warp-wide load
  constexpr int UR = VPL < U ? U / VPL : 1;  // warp-wide loads a step
  constexpr int RPS = UR * RPI;        // rows a warp takes per step
  constexpr int GROUPS = WARPS * RPI;  // softmax states per block
  constexpr int DW = LPR * VPL * EPL;  // the widest row of this shape
  __shared__ int s_bt[MAX_CHUNK_PAGES];
  __shared__ float s_m[GROUPS], s_l[GROUPS];
  __shared__ float s_acc[GROUPS][DW];
  __shared__ int s_last;

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int c = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane / LPR;  // which row of a warp-wide load
  const int li = lane % LPR;   // which vectors of the row: li, li + LPR, ..
  bool act[VPL];               // whether vector li + v * LPR is in the row
#pragma unroll
  for (int v = 0; v < VPL; ++v) act[v] = (li + v * LPR) * EPL < D;

  const int chunk_rows = chunk_pages * page_size;
  const int n_rows = min(positions[s] + 1, pages_per_seq * page_size);
  // a sequence that sees no row still has one chunk, which writes 0
  const int n_chunks = max(1, (n_rows + chunk_rows - 1) / chunk_rows);
  if (c >= n_chunks) return;
  const int page0 = c * chunk_pages;
  const int row_end = min(n_rows, page0 * page_size + chunk_rows);
  const int n_pg = min(chunk_pages, pages_per_seq - page0);
  for (int i = tid; i < n_pg; i += THREADS)
    s_bt[i] = block_tables[s * bt_ss + page0 + i];

  float qv[VPL][EPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const V u = act[v] ? __ldg(reinterpret_cast<const V*>(
                             q + s * q_ss + h * q_sh + (li + v * LPR) * EPL))
                       : V();
    to_f(u, qv[v], T());
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[v][e] *= scale;
  }
  __syncthreads();

  const T* kh = k_arena + h * k_sh + li * EPL;
  const T* vh = v_arena + h * v_sh + li * EPL;
  float m = NEG_INF, l = 0.f, acc[VPL][EPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[v][e] = 0.f;

  for (int j0 = page0 * page_size + warp * RPS; j0 < row_end;
       j0 += WARPS * RPS) {
    V kr[UR][VPL], vr[UR][VPL];
    bool ok[UR];
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      const int j = j0 + u * RPI + grp;
      const int pid = j < row_end ? s_bt[j / page_size - page0] : -1;
      ok[u] = pid >= 0 && pid < n_arena_pages;
      const int64_t row = j % page_size;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        kr[u][v] = vr[u][v] = V();
        if (ok[u] && act[v]) {
          const int64_t off = v * LPR * EPL;
          kr[u][v] = __ldg(
              reinterpret_cast<const V*>(kh + pid * k_sp + row * k_sr + off));
          vr[u][v] = __ldg(
              reinterpret_cast<const V*>(vh + pid * v_sp + row * v_sr + off));
        }
      }
    }
    float sc[UR];
    float mx = NEG_INF;
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        float kf[EPL];
        to_f(kr[u][v], kf, T());
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qv[v][e], kf[e], dot);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      sc[u] = ok[u] ? dot : NEG_INF;
      mx = fmaxf(mx, sc[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[v][e] *= alpha;
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      const float p = ok[u] ? expf(sc[u] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        float vf[EPL];
        to_f(vr[u][v], vf, T());
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[v][e] = fmaf(p, vf[e], acc[v][e]);
      }
    }
    m = m_new;
  }

  // the block's groups merge, in group order: column tid of the chunk
  const int gi = warp * RPI + grp;
  if (li == 0) {
    s_m[gi] = m;
    s_l[gi] = l;
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      s_acc[gi][(li + v * LPR) * EPL + e] = acc[v][e];
  __syncthreads();
  float cm = NEG_INF, cl = 0.f;
#pragma unroll 8
  for (int i = 0; i < GROUPS; ++i) cm = fmaxf(cm, s_m[i]);
#pragma unroll 8
  for (int i = 0; i < GROUPS; ++i) cl = fmaf(s_l[i], expf(s_m[i] - cm), cl);
  // column col of the chunk's accumulator, its groups' in group order
  auto chunk_acc = [&](int col) {
    float ca = 0.f;
#pragma unroll 8
    for (int i = 0; i < GROUPS; ++i)
      ca = fmaf(s_acc[i][col], expf(s_m[i] - cm), ca);
    return ca;
  };
  T* o = out + ((int64_t)s * H + h) * D;
  if (n_chunks == 1) {
    for (int col = tid; col < D; col += THREADS)
      store_f(o + col, chunk_acc(col) / fmaxf(cl, 1e-30f));
    return;
  }

  // several chunks: publish this one, and the last to finish merges all
  const int64_t sh = (int64_t)s * H + h;
  float* w = ws + (sh * gridDim.z + c) * (D + 2);
  for (int col = tid; col < D; col += THREADS) w[2 + col] = chunk_acc(col);
  if (tid == 0) {
    w[0] = cm;
    w[1] = cl;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + sh, 1) == n_chunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* w0 = ws + sh * gridDim.z * (D + 2);
  float M = NEG_INF, L = 0.f;
  for (int i = 0; i < n_chunks; ++i) M = fmaxf(M, __ldcg(w0 + i * (D + 2)));
  for (int i = 0; i < n_chunks; ++i) {
    const float* wi = w0 + i * (D + 2);
    L = fmaf(__ldcg(wi + 1), expf(__ldcg(wi) - M), L);
  }
  for (int col = tid; col < D; col += THREADS) {
    float A = 0.f;
    for (int i = 0; i < n_chunks; ++i) {
      const float* wi = w0 + i * (D + 2);
      A = fmaf(__ldcg(wi + 2 + col), expf(__ldcg(wi) - M), A);
    }
    store_f(o + col, A / fmaxf(L, 1e-30f));
  }
  if (tid == 0) tickets[sh] = 0;
}

template <typename T, int VB, int LPR, int VPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* bt, const int* pos, float* ws, int* tickets,
                   int S, int H, int D, int page, int pps, int n_pages,
                   int chunk_pages, const int64_t* st, float scale,
                   cudaStream_t stream) {
  dim3 grid(S, H, (pps + chunk_pages - 1) / chunk_pages);
  paged_attention_kernel<T, VB, LPR, VPL><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bt, pos, ws, tickets,
      H, D, page, pps, n_pages, chunk_pages, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const void*, const void*, const void*,
                                 void*, const int*, const int*, float*, int*,
                                 int, int, int, int, int, int, int,
                                 const int64_t*, float, cudaStream_t);

// The shape for a row of nv VB-byte vectors: on the 16-byte path LPR the
// power of two at or above nv (at most 32), on the one-element path 32;
// then VPL the power of two that covers the rest. nullptr past MAX_D.
template <typename T, int VB>
LaunchFn shape_for(int nv) {
  constexpr int MAX_NV = MAX_D * (int)sizeof(T) / VB;
  if constexpr (VB == 16) {
    if (nv <= 1) return &launch<T, VB, 1, 1>;
    if (nv <= 2) return &launch<T, VB, 2, 1>;
    if (nv <= 4) return &launch<T, VB, 4, 1>;
    if (nv <= 8) return &launch<T, VB, 8, 1>;
    if (nv <= 16) return &launch<T, VB, 16, 1>;
  }
  if (nv <= 32) return &launch<T, VB, 32, 1>;
  if (nv <= 64) return &launch<T, VB, 32, 2>;
  if (nv <= 128) return &launch<T, VB, 32, 4>;
  if constexpr (MAX_NV > 128) {
    if (nv <= 256) return &launch<T, VB, 32, 8>;
  }
  if constexpr (MAX_NV > 256) {
    if (nv <= 512) return &launch<T, VB, 32, 16>;
    if (nv <= 1024) return &launch<T, VB, 32, 32>;
  }
  return nullptr;
}

template <typename T>
cudaError_t dispatch(int D, int vec_bytes, const void* q, const void* k,
                     const void* v, void* out, const int* bt, const int* pos,
                     float* ws, int* tickets, int S, int H, int page,
                     int pps, int n_pages, int chunk_pages,
                     const int64_t* st, float scale, cudaStream_t stream) {
  constexpr int ES = sizeof(T);
  if (D < 1 || D > MAX_D) return cudaErrorInvalidValue;
  LaunchFn fn = nullptr;
  if (vec_bytes == 16 && D * ES % 16 == 0)
    fn = shape_for<T, 16>(D * ES / 16);
  else if (vec_bytes == ES)
    fn = shape_for<T, ES>(D);
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(q, k, v, out, bt, pos, ws, tickets, S, H, D, page, pps, n_pages,
            chunk_pages, st, scale, stream);
}

}  // namespace

// strides: 8 int64 element strides, in order q (s, h), k arena (page, row,
// head), v arena (page, row, head); bt_ss is the block-table row stride.
// workspace: S * H * ceil(pages_per_seq / chunk_pages) * (D + 2) floats,
// uninitialised; tickets: S * H int32 zeros, left zero by every launch.
// dtype 0 = float32, 1 = bfloat16, 2 = float16; vec_bytes 16 (rows of
// whole 16-byte vectors, every base pointer and stride 16-byte aligned)
// or the element size. Returns a cudaError_t.
extern "C" int pt_paged_attention(const void* q, const void* k_arena,
                                  const void* v_arena, void* out,
                                  const void* block_tables,
                                  const void* positions, void* workspace,
                                  void* tickets, int S, int H, int D,
                                  int page_size, int pages_per_seq,
                                  int n_arena_pages, int chunk_pages,
                                  const int64_t* strides, int64_t bt_ss,
                                  float scale, int dtype, int vec_bytes,
                                  void* stream) {
  if (S < 1 || H < 1 || page_size < 1 || pages_per_seq < 1 || H > 65535 ||
      chunk_pages < 1 || chunk_pages > MAX_CHUNK_PAGES ||
      (pages_per_seq + chunk_pages - 1) / chunk_pages > 65535)
    return (int)cudaErrorInvalidValue;
  int64_t st[9];
  for (int i = 0; i < 8; ++i) st[i] = strides[i];
  st[8] = bt_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* pos = static_cast<const int*>(positions);
  float* ws = static_cast<float*>(workspace);
  int* tk = static_cast<int*>(tickets);
  if (dtype == 0)
    return (int)dispatch<float>(D, vec_bytes, q, k_arena, v_arena, out, bt,
                                pos, ws, tk, S, H, page_size, pages_per_seq,
                                n_arena_pages, chunk_pages, st, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(
        D, vec_bytes, q, k_arena, v_arena, out, bt, pos, ws, tk, S, H,
        page_size, pages_per_seq, n_arena_pages, chunk_pages, st, scale, s);
  if (dtype == 2)
    return (int)dispatch<__half>(D, vec_bytes, q, k_arena, v_arena, out, bt,
                                 pos, ws, tk, S, H, page_size, pages_per_seq,
                                 n_arena_pages, chunk_pages, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
