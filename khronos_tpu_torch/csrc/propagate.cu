// Kernel A: iterated 26-neighbour max-label propagation (one round per launch).
//
// Replaces: khronos_tpu/ops/pallas/propagate.py::_propagate_kernel (launched by
// propagate_labels_3d_pallas). Semantics are exactly ops/dense.py
// propagate_labels_3d: labels are first masked to -1 where not growable, then
// each round takes the max over the 3x3x3 neighbourhood (-1 beyond the grid
// border) and forces non-growable cells back to -1.
//
// What bounds it on Hopper: the Pallas kernel keeps the whole grid resident in
// VMEM for every round. At the main path's 112x112x48 crop the labels alone
// are 2.4 MB (plus 0.6 MB of mask), far beyond the 227 KB of shared memory a
// block can have, so the rounds cannot stay on-chip in one block. The working
// set does fit the 50 MB L2, so a round is bound by L2 traffic and launch
// latency, not by device memory: each round re-reads the previous round's
// labels from L2.
//
// Design: one launch per round over ping-pong buffers (the wrapper in
// ops/propagate.py alternates them so the last round lands in the output).
// One thread per cell, z fastest so a warp reads 32 consecutive words; each
// thread takes the 27-point max from L1/L2 through the read-only path. The
// first round reads the unmasked input and applies the growable mask to every
// neighbour it reads, which folds the initial masking pass into it; radius 0
// is the mask alone (iterations == 0). Tiling with a shared-memory halo, or a
// single cooperative launch with a grid-wide barrier between rounds, is later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void propagate_round_kernel(const int32_t* __restrict__ src,
                                       const uint8_t* __restrict__ grow,
                                       int32_t* __restrict__ dst,
                                       int X, int Y, int Z,
                                       int radius, int mask_src) {
  const long long n = (long long)X * Y * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!grow[i]) {
    dst[i] = -1;
    return;
  }
  const int z = (int)(i % Z);
  const long long t = i / Z;
  const int y = (int)(t % Y);
  const int x = (int)(t / Y);
  int best = __ldg(src + i);  // the centre is growable: masking keeps it
  for (int dx = -radius; dx <= radius; ++dx) {
    const int xx = x + dx;
    for (int dy = -radius; dy <= radius; ++dy) {
      const int yy = y + dy;
      for (int dz = -radius; dz <= radius; ++dz) {
        const int zz = z + dz;
        int v = -1;  // the border fill
        if (xx >= 0 && xx < X && yy >= 0 && yy < Y && zz >= 0 && zz < Z) {
          const long long j = ((long long)xx * Y + yy) * Z + zz;
          v = (mask_src && !grow[j]) ? -1 : __ldg(src + j);
        }
        best = max(best, v);
      }
    }
  }
  dst[i] = best;
}

}  // namespace

// One propagation round: dst = where(grow, max27(masked src), -1).
// radius 1 is a round, radius 0 only masks; mask_src != 0 masks the neighbours
// read from src by grow (needed when src is the caller's unmasked input).
extern "C" int khr_propagate_round(const void* src, const void* grow, void* dst,
                                   int X, int Y, int Z, int radius, int mask_src,
                                   void* stream) {
  const long long n = (long long)X * Y * Z;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    propagate_round_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)src, (const uint8_t*)grow, (int32_t*)dst, X, Y, Z, radius,
        mask_src);
  }
  return (int)cudaGetLastError();
}
