// K2: 256-bit Hamming 2-NN matcher with the per-column best row.
//
// Replaces: rgbdslam_tpu/ops/pallas_kernels.py hamming_match_2nn (86-150),
// body _match_kernel (38-83). On CUDA this kernel is the live matcher.
//
// What bounds it on an H100: 1024 x 1024 pairs x 8 words is 8.4 M
// XOR+popcount pairs (about 25 M integer ops) from 64 KB of descriptors, so
// the kernel is bound by integer issue and shared-memory reads, not by HBM.
//
// Design: one warp per query row, eight rows per block. The train
// descriptors are staged in shared memory in chunks of 1024 (32 KB,
// word-major so the 32 lanes read 32 consecutive words), each lane walks
// the train rows j = lane, lane + 32, ... keeping its best index, best and
// second distance in registers, and a warp shuffle merges the lanes. The
// N x M distance matrix is never written. The per-column best is a 64-bit
// min over (dist << 32 | row) keys: first in shared memory per block, then
// one global atomicMin per column and block; a second tiny kernel unpacks
// the row. Semantics of the Pallas kernel: invalid pairs have distance
// 2^20, ties go to the lowest index, second is the minimum over j != best
// (so a tie with the best gives second == best), a row with no valid pair
// gets index 0 and distances 2^20.
//
// Batch: blockIdx.z is the batch entry (the keyframe backend verifies its
// candidate keyframes against one frame in a single launch). Either side
// may be shared by all entries (batch stride 0); outputs and the column
// keys are per entry. The unbatched call is the batch of one.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kChunk = 1024;   // train rows staged per pass
constexpr int kWarps = 8;      // query rows per block
constexpr unsigned kBig = 1u << 20;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
hamming_kernel(const unsigned* __restrict__ d1, const unsigned* __restrict__ d2,
               const unsigned char* __restrict__ v1,
               const unsigned char* __restrict__ v2, int n, int m,
               int batched1, int batched2,
               int* __restrict__ best_idx, int* __restrict__ best_dist,
               int* __restrict__ second_dist,
               unsigned long long* __restrict__ col_key) {
  const size_t z = blockIdx.z;
  if (batched1) {
    d1 += z * (size_t)n * 8;
    v1 += z * (size_t)n;
  }
  if (batched2) {
    d2 += z * (size_t)m * 8;
    v2 += z * (size_t)m;
  }
  best_idx += z * (size_t)n;
  best_dist += z * (size_t)n;
  second_dist += z * (size_t)n;
  col_key += z * (size_t)m;
  __shared__ unsigned s_d2[8][kChunk];
  __shared__ unsigned char s_v2[kChunk];
  __shared__ unsigned long long s_col[kChunk];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const bool row_ok = row < n;

  unsigned q[8];
  bool qv = false;
  for (int k = 0; k < 8; ++k) q[k] = 0u;
  if (row_ok) {
    for (int k = 0; k < 8; ++k) q[k] = d1[row * 8 + k];
    qv = v1[row] != 0;
  }

  unsigned best = 0xffffffffu, second = 0xffffffffu;
  int bidx = INT_MAX;

  for (int base = 0; base < m; base += kChunk) {
    const int cnt = min(kChunk, m - base);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      for (int k = 0; k < 8; ++k) s_d2[k][i] = d2[(base + i) * 8 + k];
      s_v2[i] = v2[base + i];
      s_col[i] = ~0ull;
    }
    __syncthreads();
    if (row_ok) {
      for (int j = lane; j < cnt; j += 32) {
        unsigned d = kBig;
        if (qv && s_v2[j]) {
          d = 0u;
          for (int k = 0; k < 8; ++k) d += __popc(q[k] ^ s_d2[k][j]);
        }
        if (d < best) {
          second = best;
          best = d;
          bidx = base + j;
        } else if (d < second) {
          second = d;
        }
        if (d < kBig) {
          atomicMin(&s_col[j], ((unsigned long long)d << 32) | (unsigned)row);
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      if (s_col[i] != ~0ull) atomicMin(&col_key[base + i], s_col[i]);
    }
    __syncthreads();
  }

  // merge the lanes' (best, index, second); lower index wins a tie
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned ob = __shfl_down_sync(kFull, best, off);
    const unsigned os = __shfl_down_sync(kFull, second, off);
    const int oi = __shfl_down_sync(kFull, bidx, off);
    if (ob < best || (ob == best && oi < bidx)) {
      second = min(os, best);
      best = ob;
      bidx = oi;
    } else {
      second = min(second, ob);
    }
  }
  if (row_ok && lane == 0) {
    best_idx[row] = bidx;
    best_dist[row] = (int)best;
    second_dist[row] = (int)min(second, kBig);
  }
}

// total = batch * m entries, laid out alike in both arrays
__global__ void col_best_kernel(const unsigned long long* __restrict__ col_key,
                                int total, int* __restrict__ col_best_row) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < total) col_best_row[j] = (int)(col_key[j] & 0xffffffffull);
}

}  // namespace

extern "C" int rgbd_hamming_match_2nn(const void* d1, const void* d2,
                                      const void* v1, const void* v2, int n,
                                      int m, int batch, int batched1,
                                      int batched2, void* best_idx,
                                      void* best_dist,
                                      void* second_dist, void* col_key,
                                      void* col_best_row, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((n + kWarps - 1) / kWarps, 1, batch);
  hamming_kernel<<<grid, kWarps * 32, 0, s>>>(
      (const unsigned*)d1, (const unsigned*)d2, (const unsigned char*)v1,
      (const unsigned char*)v2, n, m, batched1, batched2, (int*)best_idx,
      (int*)best_dist, (int*)second_dist, (unsigned long long*)col_key);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = batch * m;
  col_best_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      (const unsigned long long*)col_key, total, (int*)col_best_row);
  return (int)cudaGetLastError();
}
