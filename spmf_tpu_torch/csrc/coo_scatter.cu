// COO-to-dense scatter for Hopper: the dense-scatter sparse path's slab,
// out[r, c] += v over a batch's (row, col, value) triplets
// (spmf_tpu_torch/models/poisson.py::_densify_coo).
//
// Replaces no TPU kernel: spmf_tpu densifies with XLA's scatter-add
// (`.at[rows, cols].add(vals)`, spmf_tpu/models/poisson.py:952). Its
// PyTorch form, an accumulating `index_put_`, sorts every triplet on the
// card and then walks each run of equal cells with one warp; a device
// batch's pad slots, all (0, 0, 0), make one run of up to ~150k slots on
// cell (0, 0), and the call took 17.5 ms of a 36 ms step (PERF.md).
//
// What bounds it on an H100, at B = 4,096, D = 20,000 and the 3% cell's
// batch (about 2.46M nonzeros in a pad of about 2.63M slots), float32 and
// int32 indices: the slab's zero fill writes 328 MB and the slots are
// 32 MB to read, 0.107 ms at 3.35 TB/s; the adds touch one 32-byte sector
// each, under 80 MB more. The design:
// - the wrapper zeroes the slab with torch.zeros, a coalesced pass of
//   0.099 ms (a fill kernel of 16-byte stores here took 0.101 ms and the
//   call 5% longer, cudaMemsetAsync 3% longer: PERF.md);
// - then one thread per slot, in a grid-stride loop over the slots: a slot
//   whose value is 0 (a pad slot, a mesh's out-of-tile slot, a stored
//   zero) is skipped, which is exact, since adding 0 changes no cell; any
//   other value, NaN and +-inf included, is added with atomicAdd, which
//   the compiler issues as a reduction whose result nobody waits for;
// - nothing is sorted, so the slots may come in any order, and the offset
//   r * D + c is 64-bit (a slab may pass 2^31 cells);
// - an index outside the slab stops the kernel with a device-side assert,
//   as `index_put_` does, and writes nothing out of bounds.
// Adds to distinct cells give the same bits in any order. Repeated
// triplets of one cell (a CSR with a repeated column) sum in the atomics'
// order, which is exact for integer counts whose sum stays under 2^24 in
// float32 (2^53 in float64); other values may differ from a sorted sum in
// the last bits from run to run.
//
// The kernel allocates nothing and does not synchronise, so it is
// captured into the scan path's CUDA graph with the rest of the step.
#include <cuda_runtime.h>
#include <assert.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// the most blocks a launch takes: 8 resident blocks of 256 threads on each
// of the 132 SMs, twice over; the grid-stride loop takes the rest
constexpr int64_t MAX_BLOCKS = 132 * 8 * 2;

int blocks_for(int64_t n) {
  const int64_t b = (n + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

template <typename I, typename T>
__global__ void __launch_bounds__(THREADS)
coo_scatter_kernel(const I* __restrict__ rows, const I* __restrict__ cols,
                   const T* __restrict__ vals, T* __restrict__ out, int64_t n,
                   int64_t B, int64_t D) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
    const T v = vals[i];
    if (v == T(0)) continue;
    const int64_t r = rows[i], c = cols[i];
    assert(r >= 0 && r < B && c >= 0 && c < D);
    atomicAdd(out + r * D + c, v);
  }
}

template <typename I, typename T>
int scatter(const void* rows, const void* cols, const void* vals, void* out, int64_t n,
            int64_t B, int64_t D, cudaStream_t st) {
  coo_scatter_kernel<I, T><<<blocks_for(n), THREADS, 0, st>>>(
      (const I*)rows, (const I*)cols, (const T*)vals, (T*)out, n, B, D);
  return (int)cudaGetLastError();
}

}  // namespace

// out (B, D), contiguous and zeroed, of float (f64 == 0) or double
// (f64 != 0), takes out[rows[i], cols[i]] += vals[i] for every i < n with
// vals[i] != 0; rows and cols are int32 (i64 == 0) or int64; n > 0. One
// launch on `stream`; returns its error.
extern "C" int coo_scatter(const void* rows, const void* cols, const void* vals, void* out,
                           long long n, long long B, long long D, int i64, int f64,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (i64) return f64 ? scatter<int64_t, double>(rows, cols, vals, out, n, B, D, st)
                      : scatter<int64_t, float>(rows, cols, vals, out, n, B, D, st);
  return f64 ? scatter<int32_t, double>(rows, cols, vals, out, n, B, D, st)
             : scatter<int32_t, float>(rows, cols, vals, out, n, B, D, st);
}
