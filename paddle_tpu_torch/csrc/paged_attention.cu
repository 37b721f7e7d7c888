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
// treated as masked rather than read. Every base pointer and stride must
// be 16-byte aligned (the wrapper checks).
//
// Head dims: any D up to MAX_D whose row is a whole number of 16-byte
// vectors (D a multiple of 4 in f32, of 8 in bf16), as the TPU kernel
// takes any D. A row's NV = D * elem / 16 vectors go to LPR lanes, the
// power of two at or above NV (at most 32), VPL vectors a lane; lanes past
// the row load nothing and add 0 (D = 80 in f32: 20 of 32 lanes busy).
//
// What bounds it on the H100: bytes. A decode step reads every visible K
// and V row once, 2 * sum_s(positions[s] + 1) * H * D * elem bytes, and
// does 4 flops per element read, so at 3.35 TB/s the memory time is far
// above the compute time. What the design does about it: the chunks spread
// a long sequence over many SMs (one block per (sequence, head) left most
// SMs idle while the longest sequence walked all its rows), and each lane
// issues eight 16-byte K loads and eight V loads before it uses any of
// them, neighbouring lanes on neighbouring bytes of a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int U = 8;  // 16-byte loads of K (and of V) each lane issues a step
constexpr int MAX_D = 256;  // the widest head taken
static_assert(MAX_D <= THREADS, "the merge gives each column a thread");
constexpr float NEG_INF = -1e30f;
// the most pages of one chunk (its block-table entries in shared memory)
constexpr int MAX_CHUNK_PAGES = 1024;

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

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// LPR lanes a row (a power of two), VPL 16-byte vectors a lane; D at run
// time, at most LPR * VPL * 16 / elem.
template <typename T, int LPR, int VPL>
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
  constexpr int EPL = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int RPI = 32 / LPR;        // rows per warp-wide load
  constexpr int UR = U / VPL;          // warp-wide loads a step
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
    const uint4 u =
        act[v] ? __ldg(reinterpret_cast<const uint4*>(
                     q + s * q_ss + h * q_sh + (li + v * LPR) * EPL))
               : make_uint4(0u, 0u, 0u, 0u);
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
    uint4 kr[UR][VPL], vr[UR][VPL];
    bool ok[UR];
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      const int j = j0 + u * RPI + grp;
      const int pid = j < row_end ? s_bt[j / page_size - page0] : -1;
      ok[u] = pid >= 0 && pid < n_arena_pages;
      const int64_t row = j % page_size;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        kr[u][v] = vr[u][v] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u] && act[v]) {
          const int64_t off = v * LPR * EPL;
          kr[u][v] = __ldg(reinterpret_cast<const uint4*>(
              kh + pid * k_sp + row * k_sr + off));
          vr[u][v] = __ldg(reinterpret_cast<const uint4*>(
              vh + pid * v_sp + row * v_sr + off));
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
  float cm = NEG_INF, cl = 0.f, ca = 0.f;
  if (tid < D) {
#pragma unroll 8
    for (int i = 0; i < GROUPS; ++i) cm = fmaxf(cm, s_m[i]);
#pragma unroll 8
    for (int i = 0; i < GROUPS; ++i) {
      const float f = expf(s_m[i] - cm);
      cl = fmaf(s_l[i], f, cl);
      ca = fmaf(s_acc[i][tid], f, ca);
    }
  }
  T* o = out + ((int64_t)s * H + h) * D;
  if (n_chunks == 1) {
    if (tid < D) store_f(o + tid, ca / fmaxf(cl, 1e-30f));
    return;
  }

  // several chunks: publish this one, and the last to finish merges all
  const int64_t sh = (int64_t)s * H + h;
  float* w = ws + (sh * gridDim.z + c) * (D + 2);
  if (tid < D) w[2 + tid] = ca;
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
  if (tid < D) {
    const float* w0 = ws + sh * gridDim.z * (D + 2);
    float M = NEG_INF, L = 0.f, A = 0.f;
    for (int i = 0; i < n_chunks; ++i) M = fmaxf(M, __ldcg(w0 + i * (D + 2)));
    for (int i = 0; i < n_chunks; ++i) {
      const float* wi = w0 + i * (D + 2);
      const float f = expf(__ldcg(wi) - M);
      L = fmaf(__ldcg(wi + 1), f, L);
      A = fmaf(__ldcg(wi + 2 + tid), f, A);
    }
    store_f(o + tid, A / fmaxf(L, 1e-30f));
  }
  if (tid == 0) tickets[sh] = 0;
}

template <typename T, int LPR, int VPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* bt, const int* pos, float* ws, int* tickets,
                   int S, int H, int D, int page, int pps, int n_pages,
                   int chunk_pages, const int64_t* st, float scale,
                   cudaStream_t stream) {
  dim3 grid(S, H, (pps + chunk_pages - 1) / chunk_pages);
  paged_attention_kernel<T, LPR, VPL><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bt, pos, ws, tickets,
      H, D, page, pps, n_pages, chunk_pages, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale);
  return cudaGetLastError();
}

// The shape for D: LPR the power of two at or above the row's vectors,
// at most 32, and 2 vectors a lane above 32 (f32, D over 128).
template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, const int* bt, const int* pos, float* ws,
                       int* tickets, int S, int H, int page, int pps,
                       int n_pages, int chunk_pages, const int64_t* st,
                       float scale, cudaStream_t stream) {
  constexpr int EPL = 16 / sizeof(T);
  if (D < 1 || D > MAX_D || D % EPL) return cudaErrorInvalidValue;
  const int nv = D / EPL;
  auto fn = &launch<T, 32, 2>;
  if (nv <= 1) fn = &launch<T, 1, 1>;
  else if (nv <= 2) fn = &launch<T, 2, 1>;
  else if (nv <= 4) fn = &launch<T, 4, 1>;
  else if (nv <= 8) fn = &launch<T, 8, 1>;
  else if (nv <= 16) fn = &launch<T, 16, 1>;
  else if (nv <= 32) fn = &launch<T, 32, 1>;
  return fn(q, k, v, out, bt, pos, ws, tickets, S, H, D, page, pps, n_pages,
            chunk_pages, st, scale, stream);
}

}  // namespace

// strides: 8 int64 element strides, in order q (s, h), k arena (page, row,
// head), v arena (page, row, head); bt_ss is the block-table row stride.
// workspace: S * H * ceil(pages_per_seq / chunk_pages) * (D + 2) floats,
// uninitialised; tickets: S * H int32 zeros, left zero by every launch.
// dtype 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int pt_paged_attention(const void* q, const void* k_arena,
                                  const void* v_arena, void* out,
                                  const void* block_tables,
                                  const void* positions, void* workspace,
                                  void* tickets, int S, int H, int D,
                                  int page_size, int pages_per_seq,
                                  int n_arena_pages, int chunk_pages,
                                  const int64_t* strides, int64_t bt_ss,
                                  float scale, int dtype, void* stream) {
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
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float>(D, q, k_arena, v_arena, out, bt, pos, ws, tk, S,
                            H, page_size, pages_per_seq, n_arena_pages,
                            chunk_pages, st, scale, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(D, q, k_arena, v_arena, out, bt, pos, ws,
                                    tk, S, H, page_size, pages_per_seq,
                                    n_arena_pages, chunk_pages, st, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* pt_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
