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
// than the 227 KB of shared memory a block can have, so this kernel
// streams the matrix from device memory (or L2) instead, and reads rows,
// not columns: one block per problem keeps, for every later candidate c,
// the running maximum over kept j of iou[j, c] in shared memory. Step i
// then decides from one shared value: i is suppressed iff that maximum
// exceeds the threshold in force at step i. This equals the scan for
// every eta, because max_j(x_j) > thr iff some x_j > thr (fmaxf skips a
// NaN, which compares false in the scan too), and the maximum does not
// depend on the threshold. When i is kept the block folds row i into the
// maxima, a coalesced read of k - i - 1 floats, and synchronises; a step
// that keeps nothing reads nothing from device memory and does not
// synchronise. Every thread computes the same keep decision and the same
// threshold, so the control flow is uniform across the block.
//
// What bounds it on the H100: the dependency chain, not bytes or
// operations. Only the rows of kept candidates are read, at most
// P * k * k * 4 bytes (410 MB at P = 640, k = 400: 0.12 ms at 3.35 TB/s),
// but each kept step is a dependent global load plus a barrier
// (roughly a microsecond), so one problem takes about (kept count) us.
// The design's answer is parallelism across problems: the P blocks are
// independent and small (6 bytes of shared memory per candidate, 256
// threads), so all of a batch's problems are resident on the 132 SMs at
// once and their chains overlap. Shortening the chain (speculative row
// prefetch, splitting one problem across a cluster) is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
greedy_nms_kernel(const float* __restrict__ iou,
                  const int* __restrict__ valid,
                  const float* __restrict__ thr_in, int* __restrict__ kept,
                  int k, float eta) {
  extern __shared__ float s_max[];  // [k] max over kept j of iou[j, c]
  unsigned char* s_valid = reinterpret_cast<unsigned char*>(s_max + k);
  unsigned char* s_kept = s_valid + k;

  const int64_t p = blockIdx.x;
  const float* mat = iou + p * k * k;
  const int* v = valid + p * k;
  for (int c = threadIdx.x; c < k; c += THREADS) {
    s_max[c] = -INFINITY;
    s_valid[c] = v[c] != 0;
  }
  __syncthreads();

  float thr = thr_in[p];
  const bool adaptive = eta < 1.0f;
  for (int i = 0; i < k; ++i) {
    // no thread writes s_max[i] at step i or later, so every thread reads
    // the same value and takes the same branch
    const bool keep = s_valid[i] && !(s_max[i] > thr);
    if (threadIdx.x == 0) s_kept[i] = keep;
    if (!keep) continue;
    if (adaptive && thr > 0.5f) thr = thr * eta;
    const float* row = mat + (int64_t)i * k;
    for (int c = i + 1 + threadIdx.x; c < k; c += THREADS)
      s_max[c] = fmaxf(s_max[c], row[c]);
    __syncthreads();
  }
  __syncthreads();
  int* out = kept + p * k;
  for (int c = threadIdx.x; c < k; c += THREADS) out[c] = s_kept[c];
}

}  // namespace

// iou [P, k, k] float32, valid [P, k] int32, thr [P] float32, kept [P, k]
// int32; all contiguous. Returns a cudaError_t.
extern "C" int pt_greedy_nms(const void* iou, const void* valid,
                             const void* thr, void* kept, int P, int k,
                             float eta, void* stream) {
  if (P < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k * (sizeof(float) + 2);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_nms_kernel<<<P, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const int*>(valid),
      static_cast<const float*>(thr), static_cast<int*>(kept), k, eta);
  return (int)cudaGetLastError();
}

extern "C" const char* pt_greedy_nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
