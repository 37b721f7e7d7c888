// Greedy NMS over score-sorted candidates for Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/custom.py::_nms_kernel
// (launched by pallas_greedy_nms), batched over P independent problems as
// vmap(pallas_greedy_nms) is. For each problem, in candidate order:
//
//   kept[i] = valid[i] && !any_{j<i}(kept[j] && iou[j, i] > thr)
//
// and, when eta < 1 (the adaptive threshold of _greedy_nms_mask in
// paddle_tpu/ops/detection.py), thr *= eta after each kept box while
// thr > 0.5. With eta == 1 this is exactly the TPU kernel.
//
// The TPU kernel holds the whole [k, k] matrix in VMEM and reads column i
// at step i. At the detection path's k = 400 one matrix is 640 KB, more
// than the 227 KB of shared memory a block can have, so one block per
// problem streams the rows it needs from device memory and keeps, for
// every later candidate c, the running maximum over kept j of iou[j, c]
// in shared memory: c is suppressed by the earlier kept rows iff that
// maximum exceeds the threshold in force at step c. This equals the scan
// for every eta, because max_j(x_j) > thr iff some x_j > thr (fmaxf skips
// a NaN, which compares false in the scan too), and the maximum does not
// depend on the threshold.
//
// What bounds it on the H100: a greedy scan is a chain of decisions, and
// a design that folds each kept row into the maxima before the next
// decision pays a dependent global load and a block barrier per kept
// candidate (about 1 us: this kernel's first form ran so, at 10x its
// byte bound). This kernel cuts the chain from the kept count to k / T
// steps, and keeps loads in flight while it decides. The candidates are
// cut into tiles of T; at step t, between two block barriers:
//   - warp 0 decides tile t's candidates in order, from their running
//     maxima (earlier tiles) and the tile's diagonal block
//     iou[tT:tT+T, tT:tT+T] in shared memory. While the threshold is
//     fixed (eta 1, or already at most 0.5) it is a bitmask scan: each
//     kept candidate ORs its row's votes (tile[i][c] > thr over the
//     tile's columns c) into the set of suppressed candidates. Otherwise
//     each candidate takes a vote over kept[j] && tile[j][i] > thr at the
//     threshold in force, and the warp carries the threshold;
//   - warps 1.. prefetch tile t + 1's diagonal block (cp.async; upper
//     triangle, valid rows only; double-buffered), then fold tile t - 1's
//     kept rows into the maxima of every column from tile t + 1 on:
//     coalesced loads that no decision of tile t waits on, spread evenly
//     as (column, chunk of rows) items met by shared atomics on keys of
//     the same order as the floats;
// then all warps fold tile t's kept rows into tile t + 1's columns (each
// warp T / 8 columns, its lanes splitting the rows: one round of loads at
// T = 64), which is all that tile t + 1's decision still lacks.
// Its bytes: the kept rows' later columns plus the diagonal triangles,
// against the bound's fewest overlaps any greedy NMS must read. All of a
// detection batch's problems (640 at k = 400, 35 KB of shared memory
// each) are resident on the 132 SMs at once; one problem's chain of
// tiles, not the bytes, still sets the time (PERF.md). T = 64 and 16
// loads in flight a thread won flash_bwd_ab.py's A/B against T = 32 and
// 128 and 32 loads (PERF.md); a tile width is tried as an edited copy of
// this file in a variant directory of that script.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int T = 64;                // candidates of a tile
constexpr int R = T / 32;            // 32-candidate words of a tile
constexpr int CPW = T / WARPS;       // columns per warp of the next-tile fold
constexpr int G = 32 / CPW;          // lanes sharing one such column
constexpr int UNROLL = 16;           // fold loads in flight per thread
constexpr int STRIDE = T + 1;        // odd: a column of the tile is 32 banks
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
static_assert(T % 32 == 0 && T % WARPS == 0 && CPW <= 32, "tile shape");

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// A float as an unsigned key in the same order (for shared atomicMax),
// and back: every float's key decodes to the same float (-0 and +0 keep
// their own keys, and compare alike with any threshold).
__device__ __forceinline__ unsigned to_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Warps 1.. issue the copies of tile t's diagonal block into buf: its
// valid rows' strictly upper part (row r at buf[r * STRIDE], column c of
// the block at offset c). One warp a row: coalesced, warp-uniform skip.
__device__ __forceinline__ void load_tile(float* buf, const float* mat,
                                          const unsigned* s_vbits, int t,
                                          int k) {
  const int t0 = t * T;
  if (t0 >= k) return;
  const int rows = min(T, k - t0);
  const int lane = threadIdx.x & 31;
  for (int r = (threadIdx.x >> 5) - 1; r < rows; r += WARPS - 1) {
    const int row = t0 + r;
    if (!((s_vbits[row >> 5] >> (row & 31)) & 1u)) continue;
    const float* src = mat + (int64_t)row * k + t0;
    for (int c = r + 1 + lane; c < rows; c += 32)
      cp_async4(buf + r * STRIDE + c, src + c);
  }
}

// The maximum of m and rows list[q], list[q + step], ... (q < end) of mat
// at column c (a NaN never wins), UNROLL loads in flight at a time.
__device__ __forceinline__ float fold_rows(float m, const float* mat,
                                           const int* list, int q, int end,
                                           int step, int k, int c) {
  for (; q < end; q += UNROLL * step) {
    float x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      x[u] = q + u * step < end
                 ? __ldg(mat + (int64_t)list[q + u * step] * k + c)
                 : -INFINITY;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) m = fmaxf(m, x[u]);
  }
  return m;
}

// Warp 0 decides tile t's candidates in order (tile: its diagonal block;
// s_key: the running maxima over earlier tiles). Returns in bit l of
// word r of kept whether candidate t0 + 32r + l is kept.
template <bool ADAPTIVE>
__device__ __forceinline__ void decide(const float* tile,
                                       const unsigned* s_key,
                                       const unsigned* s_vbits, int t0,
                                       int rows, float& thr, float eta,
                                       unsigned (&kept)[R]) {
  const int lane = threadIdx.x & 31;
  unsigned sup[R];                   // bit l of word r: candidate suppressed
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = 32 * r + lane;
    kept[r] = 0;
    sup[r] = ~(32 * r < rows ? s_vbits[(t0 >> 5) + r] : 0u)
             | __ballot_sync(FULL, i < rows && from_key(s_key[t0 + i]) > thr);
  }
  // Straight-line code below (no branch on a decision, none on the tile's
  // end: candidates past it are suppressed from the start), so that the
  // compiler can issue the shared loads and votes of later steps early.
  if (!ADAPTIVE || !(thr > 0.5f)) {
    // The threshold stays fixed through the tile: the bitmask scan. Row i
    // of the block, as R words over the columns, is folded into sup when
    // i is kept. Its lower part (columns <= i, not loaded) only touches
    // candidates already decided.
#pragma unroll
    for (int i = 0; i < T; ++i) {
      unsigned row[R];
#pragma unroll
      for (int w = 0; w < R; ++w)
        row[w] = __ballot_sync(FULL, tile[i * STRIDE + 32 * w + lane] > thr);
      const unsigned keep = ~(sup[i >> 5] >> (i & 31)) & 1u;
      kept[i >> 5] |= keep << (i & 31);
#pragma unroll
      for (int w = 0; w < R; ++w) sup[w] |= row[w] & (0u - keep);
    }
    return;
  }
  // eta < 1 and thr > 0.5: the threshold may fall at each kept candidate,
  // so each decision votes at the threshold in force: a lane per row j,
  // kept[j] && tile[j][i] > thr. A row j >= i has no kept bit at step i,
  // so the unloaded lower triangle is never looked at.
#pragma unroll
  for (int i = 0; i < T; ++i) {
    bool hit = false;
#pragma unroll
    for (int q = 0; q < R; ++q)
      hit |= ((kept[q] >> lane) & 1u)
             && tile[(32 * q + lane) * STRIDE + i] > thr;
    const bool keep = !((sup[i >> 5] >> (i & 31)) & 1u)
                      && !(i < rows && from_key(s_key[t0 + i]) > thr)
                      && !__any_sync(FULL, hit);
    kept[i >> 5] |= (unsigned)keep << (i & 31);
    thr = keep && thr > 0.5f ? thr * eta : thr;
  }
}

template <bool ADAPTIVE>
__global__ void __launch_bounds__(THREADS)
greedy_nms_kernel(const float* __restrict__ iou,
                  const int* __restrict__ valid,
                  const float* __restrict__ thr_in, int* __restrict__ kept,
                  int k, float eta) {
  extern __shared__ unsigned smem[];
  const int words = (k + 31) >> 5;
  unsigned* s_key = smem;                       // [k] running maxima, keys
  unsigned* s_vbits = s_key + k;                // [words]
  float* s_buf = reinterpret_cast<float*>(s_vbits + words);  // 2 blocks
  // kept rows of tiles t (even, odd), count at [T]
  int* s_list = reinterpret_cast<int*>(s_buf + 2 * T * STRIDE);

  const int64_t p = blockIdx.x;
  const float* mat = iou + p * k * k;
  const int* v = valid + p * k;
  int* out = kept + p * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int c = tid; c < k; c += THREADS) s_key[c] = to_key(-INFINITY);
  for (int base = warp * 32; base < k; base += THREADS) {
    const unsigned w = __ballot_sync(FULL, base + lane < k && v[base + lane]);
    if (lane == 0) s_vbits[base >> 5] = w;
  }
  __syncthreads();
  if (warp > 0) load_tile(s_buf, mat, s_vbits, 0, k);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float thr = thr_in[p];             // carried by warp 0 alone
  const int n_tiles = (k + T - 1) / T;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * T;
    const int next = t0 + T;         // first column of tile t + 1
    int* list = s_list + (t & 1) * (T + 1);
    // tile t's block has landed, and its columns' maxima hold every kept
    // row of tiles < t
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (warp == 0) {
      const int rows = min(T, k - t0);
      unsigned mine[R];
      decide<ADAPTIVE>(s_buf + (t & 1) * T * STRIDE, s_key, s_vbits, t0,
                       rows, thr, eta, mine);
      int n = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = 32 * r + lane;
        const bool mk = (mine[r] >> lane) & 1u;
        if (i < rows) out[t0 + i] = mk;
        if (mk) list[n + __popc(mine[r] & ((1u << lane) - 1u))] = t0 + i;
        n += __popc(mine[r]);
      }
      if (lane == 0) list[T] = n;
    } else {
      // the other buffer was last read by tile t - 1's decision
      load_tile(s_buf + ((t + 1) & 1) * T * STRIDE, mat, s_vbits, t + 1, k);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      // tile t - 1's kept rows, from tile t + 1's columns on (its fold into
      // tile t's columns ended the last step): the (column, chunk of at
      // most UNROLL rows) items spread evenly over warps 1.., one round of
      // loads an item, met by shared atomics
      const int* prev = s_list + ((t + 1) & 1) * (T + 1);
      const int nk = t > 0 ? prev[T] : 0;
      const int cols = k - next;
      if (nk > 0 && cols > 0) {
        const int chunks = (nk + UNROLL - 1) / UNROLL;
        const int per = (nk + chunks - 1) / chunks;
        for (int it = tid - 32; it < cols * chunks; it += THREADS - 32) {
          const int q = it / cols * per, c = next + it % cols;
          atomicMax(s_key + c, to_key(fold_rows(
              -INFINITY, mat, prev, q, min(nk, q + per), 1, k, c)));
        }
      }
    }
    __syncthreads();
    // tile t's kept rows into tile t + 1's columns: warp w takes CPW
    // columns, its G lanes on a column split the rows, then meet
    const int nk = list[T];
    const int c = next + warp * CPW + lane % CPW;
    if (nk > 0 && next < k) {
      float m = fold_rows(-INFINITY, mat, list, lane / CPW, nk, G, k,
                          min(c, k - 1));
#pragma unroll
      for (int off = CPW; off < 32; off <<= 1)
        m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      if (lane < CPW && c < k) s_key[c] = max(s_key[c], to_key(m));
    }
  }
}

size_t smem_bytes(int k) {
  return sizeof(float) * ((size_t)k + (k + 31) / 32 + 2 * T * STRIDE
                          + 2 * (T + 1));
}

// A kernel's attributes belong to a device: set them the first time a
// launch lands on it. Dynamic shared memory up to what a block may opt
// into (the wrapper's MAX_NMS_K needs 165 KiB), and as much of the SM's
// 256 KB for shared memory as it gives, so that a whole detection batch
// of blocks is resident at once. Two threads may both set them: the same
// values, so no harm.
template <bool ADAPTIVE>
cudaError_t configure() {
  static std::atomic<bool> done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(greedy_nms_kernel<ADAPTIVE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(greedy_nms_kernel<ADAPTIVE>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done[dev].store(true, std::memory_order_release);
  return err;
}

template <bool ADAPTIVE>
int launch(const float* iou, const int* valid, const float* thr, int* kept,
           int P, int k, float eta, cudaStream_t stream) {
  cudaError_t err = configure<ADAPTIVE>();
  if (err != cudaSuccess) return (int)err;
  greedy_nms_kernel<ADAPTIVE><<<P, THREADS, smem_bytes(k), stream>>>(
      iou, valid, thr, kept, k, eta);
  return (int)cudaGetLastError();
}

}  // namespace

// iou [P, k, k] float32, valid [P, k] int32, thr [P] float32, kept [P, k]
// int32; all contiguous. Returns a cudaError_t.
extern "C" int pt_greedy_nms(const void* iou, const void* valid,
                             const void* thr, void* kept, int P, int k,
                             float eta, void* stream) {
  if (P < 1 || k < 1) return (int)cudaErrorInvalidValue;
  auto* fn = &launch<false>;
  if (eta < 1.0f) fn = &launch<true>;
  return fn(static_cast<const float*>(iou), static_cast<const int*>(valid),
            static_cast<const float*>(thr), static_cast<int*>(kept), P, k,
            eta, static_cast<cudaStream_t>(stream));
}

extern "C" const char* pt_greedy_nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
