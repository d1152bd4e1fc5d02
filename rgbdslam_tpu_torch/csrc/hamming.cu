// K2: 256-bit Hamming 2-NN matcher with the per-column best row, and the
// matcher's gates.
//
// Replaces: rgbdslam_tpu/ops/pallas_kernels.py hamming_match_2nn (86-150),
// body _match_kernel (38-83), and the elementwise gates XLA fused behind it
// (rgbdslam_tpu/frontend/matcher.py match_descriptors). On CUDA this kernel
// is the live matcher.
//
// What bounds it on an H100: 1024 x 1024 pairs x 8 words is 8.4 M
// XOR+popcount pairs (about 25 M integer ops) from 64 KB of descriptors, so
// the kernel is bound by the integer pipes and shared-memory reads, not by HBM,
// and at this size by one launch's latency.
//
// Design: one launch, no atomics. A block owns eight rows of one side, one
// warp per row. The other side's descriptors are staged in shared memory in
// chunks of 1024 (32 KB, word-major so the 32 lanes read 32 consecutive
// words); each lane walks the staged rows j = lane, lane + 32, ... keeping
// its best index, best and second distance in registers, and a warp shuffle
// merges the lanes. The first ceil(N / 8) blocks own query rows and write
// (best index, best, second); the other ceil(M / 8) blocks own train rows,
// run the same loop with the roles swapped and write the best query of
// their train row. Every distance is computed twice (17 M popcount words at
// 1024 x 1024, still far under a launch's latency), which removes the 64-bit
// atomicMin over (dist << 32 | row) keys, the fill of those keys and the
// kernel that unpacked them. The N x M distance matrix is never written.
// Semantics of the Pallas kernel: invalid pairs have distance 2^20, ties go
// to the lowest index, second is the minimum over j != best (so a tie with
// the best gives second == best), a row or column with no valid pair gets
// index 0 and distances 2^20.
//
// match_gate_kernel is the matcher's epilogue in one launch: Lowe's ratio
// test in f32 as written (best < ratio * second), the mutual-nearest check
// against the column best, the query's validity, best < 2^20 and, where the
// caller gives one, a train-side mask read at the matched index.
//
// Batch: blockIdx.z is the batch entry (the keyframe backend verifies its
// candidate keyframes against one frame in a single launch). Either side
// may be shared by all entries (batch stride 0); outputs are per entry. The
// unbatched call is the batch of one.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kChunk = 1024;   // rows of the other side staged per pass
constexpr int kWarps = 8;      // owned rows per block
constexpr unsigned kBig = 1u << 20;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
hamming_kernel(const unsigned* __restrict__ d1, const unsigned* __restrict__ d2,
               const unsigned char* __restrict__ v1,
               const unsigned char* __restrict__ v2, int n, int m,
               int batched1, int batched2, int row_blocks,
               int* __restrict__ best_idx, int* __restrict__ best_dist,
               int* __restrict__ second_dist, int* __restrict__ col_best_row) {
  const size_t z = blockIdx.z;
  if (batched1) {
    d1 += z * (size_t)n * 8;
    v1 += z * (size_t)n;
  }
  if (batched2) {
    d2 += z * (size_t)m * 8;
    v2 += z * (size_t)m;
  }
  __shared__ unsigned s_d[8][kChunk];
  __shared__ unsigned char s_v[kChunk];

  // the side this block owns rows of, and the side it searches
  const bool cols = (int)blockIdx.x >= row_blocks;
  const unsigned* own_d = cols ? d2 : d1;
  const unsigned char* own_v = cols ? v2 : v1;
  const unsigned* oth_d = cols ? d1 : d2;
  const unsigned char* oth_v = cols ? v1 : v2;
  const int n_own = cols ? m : n, n_oth = cols ? n : m;
  const int tile = cols ? (int)blockIdx.x - row_blocks : (int)blockIdx.x;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = tile * kWarps + warp;
  const bool row_ok = row < n_own;

  unsigned q[8];
  bool qv = false;
  for (int k = 0; k < 8; ++k) q[k] = 0u;
  if (row_ok) {
    for (int k = 0; k < 8; ++k) q[k] = own_d[(size_t)row * 8 + k];
    qv = own_v[row] != 0;
  }

  unsigned best = 0xffffffffu, second = 0xffffffffu;
  int bidx = INT_MAX;

  for (int base = 0; base < n_oth; base += kChunk) {
    const int cnt = min(kChunk, n_oth - base);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      for (int k = 0; k < 8; ++k) s_d[k][i] = oth_d[(size_t)(base + i) * 8 + k];
      s_v[i] = oth_v[base + i];
    }
    __syncthreads();
    if (row_ok) {
      for (int j = lane; j < cnt; j += 32) {
        unsigned d = kBig;
        if (qv && s_v[j]) {
          d = 0u;
          for (int k = 0; k < 8; ++k) d += __popc(q[k] ^ s_d[k][j]);
        }
        if (d < best) {
          second = best;
          best = d;
          bidx = base + j;
        } else if (d < second) {
          second = d;
        }
      }
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
    if (cols) {
      col_best_row[z * (size_t)m + row] = bidx;
    } else {
      best_idx[z * (size_t)n + row] = bidx;
      best_dist[z * (size_t)n + row] = (int)best;
      second_dist[z * (size_t)n + row] = (int)min(second, kBig);
    }
  }
}

// valid[z, i] of the match i -> best_idx[z, i]
__global__ void match_gate_kernel(const int* __restrict__ best_idx,
                                  const int* __restrict__ best_dist,
                                  const int* __restrict__ second_dist,
                                  const int* __restrict__ col_best_row,
                                  const unsigned char* __restrict__ v1, int n,
                                  int m, int batched1, float ratio,
                                  unsigned char* __restrict__ valid_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t z = blockIdx.y;
  const size_t o = z * (size_t)n + i;
  const int j = best_idx[o];
  const int best = best_dist[o];
  bool ok = (float)best < ratio * (float)second_dist[o];
  ok = ok && col_best_row[z * (size_t)m + j] == i;
  ok = ok && v1[(batched1 ? z * (size_t)n : 0) + i] != 0;
  ok = ok && best < (int)kBig;
  valid_out[o] = ok ? 1 : 0;
}

}  // namespace

extern "C" int rgbd_hamming_match_2nn(const void* d1, const void* d2,
                                      const void* v1, const void* v2, int n,
                                      int m, int batch, int batched1,
                                      int batched2, void* best_idx,
                                      void* best_dist, void* second_dist,
                                      void* col_best_row, void* stream) {
  const int row_blocks = (n + kWarps - 1) / kWarps;
  const int col_blocks = (m + kWarps - 1) / kWarps;
  const dim3 grid(row_blocks + col_blocks, 1, batch);
  hamming_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const unsigned*)d1, (const unsigned*)d2, (const unsigned char*)v1,
      (const unsigned char*)v2, n, m, batched1, batched2, row_blocks,
      (int*)best_idx, (int*)best_dist, (int*)second_dist, (int*)col_best_row);
  return (int)cudaGetLastError();
}

extern "C" int rgbd_match_gates(const void* best_idx, const void* best_dist,
                                const void* second_dist, const void* col_best_row,
                                const void* v1, int n, int m, int batch,
                                int batched1, float ratio,
                                void* valid_out, void* stream) {
  const dim3 grid((n + 255) / 256, batch);
  match_gate_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int*)best_idx, (const int*)best_dist, (const int*)second_dist,
      (const int*)col_best_row, (const unsigned char*)v1, n, m, batched1, ratio,
      (unsigned char*)valid_out);
  return (int)cudaGetLastError();
}
