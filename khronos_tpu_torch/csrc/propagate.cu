// Kernel A: iterated 26-neighbour max-label propagation, every round of a call
// in one cooperative launch.
//
// Replaces: khronos_tpu/ops/pallas/propagate.py::_propagate_kernel (launched by
// propagate_labels_3d_pallas). Semantics are exactly ops/dense.py
// propagate_labels_3d: labels are first masked to -1 where not growable, then
// each round takes the max over the 3x3x3 neighbourhood (-1 beyond the grid
// border) and forces non-growable cells back to -1.
//
// Bound on Hopper: bytes. The function must read the labels and the mask once
// and write the labels once: 5.42 MB at the main path's 112x112x48 crop, 1.618
// us at 3.35 TB/s; its operations (7 a cell and round) take less. The Pallas
// kernel keeps the whole grid in VMEM for every round; an H100 block has 227 KB
// of shared memory against 2.4 MB of labels and 0.6 MB of mask, so here the
// rounds meet in the 50 MB L2, and one launch holds them all. On the main path
// the work is small and latency, not bytes, sets the time (PERF.md).
//
// What the design does about each cost of the first port (one launch per
// round; 64-bit division for every cell; 27 guarded loads a cell; every cell
// in every round; all rounds always):
// - Launches: ONE cooperative launch per call (cudaLaunchKernelEx with
//   cudaLaunchAttributeCooperative). The grid is the number of blocks that can
//   be resident (occupancy x SMs, at most one a tile); block b takes tiles b,
//   b + grid, ..., so any grid size runs the same code. The labels ping-pong
//   between `out` and `tmp`, which stay in L2.
// - Steps of D rounds: a block loads one TX x TY x TZ tile with a halo D deep
//   (its region), masked as it loads (where not growable or beyond the grid:
//   -1), runs D rounds on it on chip, and writes the tile back; a barrier
//   follows each step. The region's faces go wrong one cell deeper each round
//   and never reach the tile, so the tile is exact. Round 0 masks the caller's
//   input as it loads it: no separate masking pass. Cells of `tmp` that no
//   step wrote are never read unmasked.
// - The 27 loads: warp w holds the region's x plane w; each lane one z (a
//   region row along z is 32 cells, hence TZ = 32 - 2D), and its RY rows along
//   y in registers. A round is the 3-wide max along z (two shuffles), along y
//   (registers), then along x through shared memory (double-buffered, one
//   __syncthreads a round), then the mask select: 6 comparisons and 1 select a
//   cell. -1 is the identity of this max, so the separable form is exact.
// - Index arithmetic: 32 bits (the wrapper refuses grids of 2^31 cells or
//   more). A tile's corner is divided out once, by one thread; a cell's index
//   is a multiply-add from it.
// - Idle cells: a non-growable cell is -1 after every round, so a tile with no
//   growable cell is written as -1 once, into `out`, in the phase before round
//   0. That phase marks the tiles that hold a growable cell, in the workspace
//   and in a list in each block's shared memory (the host never reads either),
//   and ends in a grid-wide barrier (cooperative_groups::this_grid().sync()).
//   The steps visit listed tiles only; a block with none leaves, and the
//   barriers between steps count the blocks that stay.
// - Rounds past the fixpoint: a round whose output equals its masked input is
//   a fixpoint, and every later round returns the same grid. A block arrives
//   at a step's barrier with one release add to a 64-bit word that counts the
//   arrivals and, for each round of the step, the blocks whose tiles that
//   round changed; it polls the word (acquire) until all have arrived, so all
//   read the same counts and stop together after a step in which a round
//   changed nothing. The words rotate over three copies, 128 bytes apart, so
//   the copy a block clears (step s+1's, during step s) is one that no block
//   still reads. The last step writes `out`; a step that stops early with its
//   result in `tmp` copies the block's own tiles to `out`. The rounds run go
//   to a workspace word that only chip_smoke.py and the tests read.
// - No allocation, no memset, no host synchronisation: the wrapper hands in
//   torch.empty buffers, and block 0 clears the barrier words before the
//   grid-wide barrier.
// D, TX and TY come from a sweep on the card (chip_smoke.py's sweep phase),
// which also backs the choice of temporal blocking (D > 1); see PERF.md.
//
// Graph capture: the cooperative launch captures into a CUDA graph and
// replays bit-exact (tests/test_torch_kernels_cuda.py and chip_smoke.py check
// it on the card), so the design keeps its barriers.
//
// khr_propagate_round, the first port's design (one launch per round), stays
// below only as the yardstick that chip_smoke.py times beside this kernel.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// Rounds per step (between two barriers), which is also the halo's depth; a
// region row along z is one warp's 32 lanes, so the tile is TZ = 32 - 2D
// deep. The wrapper (ops/propagate.py TILE, DEPTH) mirrors these.
constexpr int D = 3;
constexpr int TX = 8, TY = 4, TZ = 32 - 2 * D;
constexpr int RX = TX + 2 * D, RY = TY + 2 * D;  // the region's planes and rows
constexpr int THREADS = RX * 32;
static_assert(RX <= 32 && RY <= 32, "a block of RX warps; RY row bits in a word");
// the z-y maxima of every plane, double-buffered: [2][RX][RY][32] int
constexpr int SMEM = 2 * RX * RY * 32 * 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int LIST = 64;  // active tiles a block lists in shared memory; more are found in the marks
constexpr int CHUNK = 8;  // tiles phase 0 loads at once
constexpr int CELL_LOADS = (TX * TY * TZ + THREADS - 1) / THREADS;  // tile cells a thread loads

// Workspace, in int32 words. A step's barrier word is 64 bits: 16 bits count
// the blocks arrived, then a field of FIELD bits a round counts the blocks
// whose tiles that round changed. Three of them rotate, 128 bytes apart.
constexpr int LINE = 32;
constexpr int FIELD = 48 / D;
static_assert(D >= 1 && D <= 4, "one to four change fields fit the barrier word");
constexpr int W_ROUNDS = 3 * LINE;  // rounds run
constexpr int W_HEADER = 4 * LINE;  // then n_tiles tile marks, then one mark a block

struct Tiles {
  int X, Y, Z, ny, nz;  // grid shape, tiles along y and z
  __device__ void origin(int t, int& x0, int& y0, int& z0) const {
    z0 = (t % nz) * TZ;
    t /= nz;
    y0 = (t % ny) * TY;
    x0 = (t / ny) * TX;
  }
  __device__ bool inside(int x, int y, int z) const {
    return (unsigned)x < (unsigned)X && (unsigned)y < (unsigned)Y && (unsigned)z < (unsigned)Z;
  }
  __device__ int index(int x, int y, int z) const { return (x * Y + y) * Z + z; }
};

// Up to D rounds (h) of the tile with corner (x0, y0, z0), on its region:
// warp w holds plane x0 - D + w of it, lane l the cells z0 - D + l of each
// row. A round takes the 3-wide max along z (shuffles) and y (registers),
// puts it in shared memory, and takes it along x from the neighbouring
// planes; then the mask. Writes the tile's cells of dst; returns bit j set
// where round j changed a tile cell of this thread.
__device__ unsigned step_tile(const Tiles& g, int x0, int y0, int z0, int h, const int32_t* src,
                              const uint8_t* __restrict__ grow, int32_t* dst, int* ymax) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int x = x0 - D + w, z = z0 - D + lane;
  const bool xz_in = (unsigned)x < (unsigned)g.X && (unsigned)z < (unsigned)g.Z;
  int v[RY];
  uint8_t gv[RY];
#pragma unroll
  for (int y = 0; y < RY; ++y) {  // every load in flight before the first use
    const int gy = y0 - D + y;
    v[y] = -1;
    gv[y] = 0;
    if (xz_in && (unsigned)gy < (unsigned)g.Y) {
      const int i = g.index(x, gy, z);
      v[y] = __ldcg(src + i);  // written by other blocks in this launch: skip L1
      gv[y] = __ldg(grow + i);  // read-only: L1 keeps it
    }
  }
  unsigned m = 0;  // bit y: row y's cell growable
#pragma unroll
  for (int y = 0; y < RY; ++y) {
    m |= (gv[y] != 0) << y;
    v[y] = gv[y] ? v[y] : -1;
  }
  const bool inner_xz = w >= D && w < D + TX && lane >= D && lane < D + TZ;
  unsigned changed = 0;
  for (int r = 0; r < h; ++r) {
    int* plane = ymax + ((r & 1) * RX + w) * RY * 32;
    // At the region's faces a cell stands in for its missing neighbour (lane
    // 0 and 31 get their own value back from the shuffles): the faces are
    // wrong from round 1 on, and a cell d from them from round d + 1, so the
    // tile's cells, D deep, are exact through D rounds.
    int zm[RY];
#pragma unroll
    for (int y = 0; y < RY; ++y)
      zm[y] = max(v[y], max(__shfl_up_sync(FULL, v[y], 1), __shfl_down_sync(FULL, v[y], 1)));
#pragma unroll
    for (int y = 0; y < RY; ++y)
      plane[y * 32 + lane] = max(zm[y], max(zm[y > 0 ? y - 1 : y], zm[y < RY - 1 ? y + 1 : y]));
    __syncthreads();  // the other buffer is free: no warp can be a round ahead
    const int* lo = plane - (w > 0 ? RY * 32 : 0);
    const int* hi = plane + (w < RX - 1 ? RY * 32 : 0);
#pragma unroll
    for (int y = 0; y < RY; ++y) {
      const int nv = (m >> y & 1) ? max(plane[y * 32 + lane], max(lo[y * 32 + lane], hi[y * 32 + lane])) : -1;
      if (nv != v[y] && inner_xz && y >= D && y < D + TY) changed |= 1u << r;
      v[y] = nv;
    }
  }
  if (inner_xz && xz_in) {
#pragma unroll
    for (int y = D; y < D + TY; ++y)
      if (y0 - D + y < g.Y) dst[g.index(x, y0 - D + y, z)] = v[y];
  }
  __syncthreads();  // the next tile's first round reuses the buffers
  return changed;
}

// The cells of the tile with corner (x0, y0, z0): with src, src masked by
// grow (or copied, grow null); without, -1.
__device__ void fill_tile(const Tiles& g, int x0, int y0, int z0, const int32_t* src, const uint8_t* grow,
                          int32_t* dst) {
#pragma unroll
  for (int k = 0; k < CELL_LOADS; ++k) {
    const int c = threadIdx.x + k * THREADS;
    const int x = x0 + c / (TY * TZ), y = y0 + c / TZ % TY, z = z0 + c % TZ;
    if (c < TX * TY * TZ && g.inside(x, y, z)) {
      const int i = g.index(x, y, z);
      const int label = src != nullptr ? __ldcg(src + i) : -1;
      dst[i] = (grow == nullptr || __ldg(grow + i)) ? label : -1;
    }
  }
}

__device__ __forceinline__ unsigned long long add_release(unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.add.release.gpu.u64 %0, [%1], %2;" : "=l"(old) : "l"(p), "l"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Step s's barrier of the n blocks that hold active tiles: one release add
// carries this block's arrival and its change bits, and an acquire poll of the
// same word returns every block's. Returns bit j set where round j of the
// step changed a cell anywhere.
__device__ unsigned step_barrier(int32_t* ws, int s, int n, unsigned bits) {
  __shared__ unsigned block_bits, all;
  unsigned long long* word = (unsigned long long*)(ws + (s % 3) * LINE);
  if (threadIdx.x == 0) block_bits = 0;
  __syncthreads();
  bits = __reduce_or_sync(FULL, bits);
  if (bits && (threadIdx.x & 31) == 0) atomicOr(&block_bits, bits);
  __syncthreads();  // every cell of this block written before its arrival
  if (threadIdx.x == 0) {
    unsigned long long add = 1;
    for (int j = 0; j < D; ++j)
      if (block_bits >> j & 1) add += 1ull << (16 + FIELD * j);
    add_release(word, add);
    unsigned long long v;
    do {
      v = load_acquire(word);
    } while ((int)(v & 0xffff) < n);
    unsigned a = 0;
    for (int j = 0; j < D; ++j)
      if ((v >> (16 + FIELD * j)) & ((1ull << FIELD) - 1)) a |= 1u << j;
    all = a;
  }
  __syncthreads();
  return all;
}

__global__ void __launch_bounds__(THREADS) propagate_kernel(const int32_t* __restrict__ in,
                                                            const uint8_t* __restrict__ grow,
                                                            int32_t* out, int32_t* tmp, int32_t* ws,
                                                            Tiles g, int n_tiles, int iterations) {
  extern __shared__ __align__(16) int ymax[];
  int32_t* marks = ws + W_HEADER;             // tile t active
  int32_t* workers = ws + W_HEADER + n_tiles;  // block b holds an active tile

  if (blockIdx.x == 0 && threadIdx.x < 3) *(unsigned long long*)(ws + threadIdx.x * LINE) = 0;  // barrier words
  if (blockIdx.x == 0 && threadIdx.x == 0) ws[W_ROUNDS] = 0;
  const int lane = threadIdx.x & 31;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // tile corners, CHUNK at a time, one thread each: the division by the tile
  // counts runs once a tile
  __shared__ int corner[CHUNK][3];

  if (iterations == 0) {  // the mask alone
    for (int c0 = 0; c0 < my_tiles; c0 += CHUNK) {
      if (threadIdx.x < CHUNK) g.origin(blockIdx.x + (c0 + threadIdx.x) * gridDim.x, corner[threadIdx.x][0],
                                        corner[threadIdx.x][1], corner[threadIdx.x][2]);
      __syncthreads();
      for (int j = 0; j < CHUNK && c0 + j < my_tiles; ++j)
        fill_tile(g, corner[j][0], corner[j][1], corner[j][2], in, grow, out);
      __syncthreads();
    }
    return;
  }
  // phase 0: mark the tiles holding a growable cell and list the block's first
  // LIST of them; write the others as -1. CHUNK tiles' mask loads at a time.
  __shared__ int own[LIST][4], n_own;  // tile, corner
  __shared__ unsigned chunk_bits;
  if (threadIdx.x == 0) n_own = 0;
  for (int c0 = 0; c0 < my_tiles; c0 += CHUNK) {
    if (threadIdx.x == 0) chunk_bits = 0;
    if (threadIdx.x < CHUNK) g.origin(blockIdx.x + (c0 + threadIdx.x) * gridDim.x, corner[threadIdx.x][0],
                                      corner[threadIdx.x][1], corner[threadIdx.x][2]);
    __syncthreads();
    uint8_t gv[CHUNK][CELL_LOADS];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {  // every load in flight before the first use
#pragma unroll
      for (int k = 0; k < CELL_LOADS; ++k) {
        const int c = threadIdx.x + k * THREADS;
        const int x = corner[j][0] + c / (TY * TZ), y = corner[j][1] + c / TZ % TY, z = corner[j][2] + c % TZ;
        gv[j][k] = 0;
        if (c0 + j < my_tiles && c < TX * TY * TZ && g.inside(x, y, z)) gv[j][k] = __ldg(grow + g.index(x, y, z));
      }
    }
    unsigned bits = 0;  // bit j: tile c0 + j has a growable cell of this thread
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
#pragma unroll
      for (int k = 0; k < CELL_LOADS; ++k) bits |= (gv[j][k] != 0) << j;
    bits = __reduce_or_sync(FULL, bits);
    if (bits && lane == 0) atomicOr(&chunk_bits, bits);
    __syncthreads();
    for (int j = 0; j < CHUNK && c0 + j < my_tiles; ++j) {
      const int t = blockIdx.x + (c0 + j) * gridDim.x;
      const bool active = chunk_bits >> j & 1;
      if (!active) fill_tile(g, corner[j][0], corner[j][1], corner[j][2], nullptr, nullptr, out);
      if (threadIdx.x == 0) {
        marks[t] = active;
        if (active && n_own < LIST)
          own[n_own][0] = t, own[n_own][1] = corner[j][0], own[n_own][2] = corner[j][1], own[n_own][3] = corner[j][2];
        n_own += active;
      }
    }
    __syncthreads();
  }
  const bool mine = n_own > 0;
  if (threadIdx.x == 0) workers[blockIdx.x] = mine;
  cg::this_grid().sync();
  if (!mine) return;
  __shared__ int stay;  // blocks that stay
  if (threadIdx.x == 0) stay = 0;
  int c = 0;
#pragma unroll 4
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) c += __ldcg(workers + b) != 0;
  __syncthreads();
  c = __reduce_add_sync(FULL, c);
  if (c && (threadIdx.x & 31) == 0) atomicAdd(&stay, c);
  __syncthreads();
  const int n = stay;

  const int steps = (iterations + D - 1) / D;
  int32_t* buf[2] = {((steps - 1) & 1) ? tmp : out, ((steps - 1) & 1) ? out : tmp};  // the last step writes out
  int rounds = 0;
  for (int step = 0; step < steps; ++step) {
    const int h = min(D, iterations - step * D);
    const int32_t* src = step == 0 ? in : buf[(step - 1) & 1];
    int32_t* dst = buf[step & 1];
    if (threadIdx.x == 0)  // step+1's word (step-2's): no block reads it now
      *(unsigned long long*)(ws + ((step + 1) % 3) * LINE) = 0;
    unsigned bits = 0;
    for (int i = 0; i < min(n_own, LIST); ++i)
      bits |= step_tile(g, own[i][1], own[i][2], own[i][3], h, src, grow, dst, ymax);
    if (n_own > LIST)  // the block's active tiles past its list
      for (int t = own[LIST - 1][0] + gridDim.x; t < n_tiles; t += gridDim.x)
        if (marks[t]) {
          int x0, y0, z0;
          g.origin(t, x0, y0, z0);
          bits |= step_tile(g, x0, y0, z0, h, src, grow, dst, ymax);
        }
    rounds += h;
    if (step == steps - 1) break;
    const unsigned all = step_barrier(ws, step, n, bits);
    if (all != (1u << h) - 1) {  // a round of this step changed nothing: the fixpoint
      if (dst != out) {
        for (int i = 0; i < min(n_own, LIST); ++i) fill_tile(g, own[i][1], own[i][2], own[i][3], dst, nullptr, out);
        if (n_own > LIST)
          for (int t = own[LIST - 1][0] + gridDim.x; t < n_tiles; t += gridDim.x)
            if (marks[t]) {
              int x0, y0, z0;
              g.origin(t, x0, y0, z0);
              fill_tile(g, x0, y0, z0, dst, nullptr, out);
            }
      }
      break;
    }
  }
  if (threadIdx.x == 0) ws[W_ROUNDS] = rounds;  // the same in every block that stayed
}

// The first port's design, kept as chip_smoke.py's yardstick: one launch per
// round, one thread per cell, 27 guarded loads through the read-only path.
__global__ void propagate_round_kernel(const int32_t* __restrict__ src, const uint8_t* __restrict__ grow,
                                       int32_t* __restrict__ dst, int X, int Y, int Z, int radius,
                                       int mask_src) {
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
  int best = __ldg(src + i);
  for (int dx = -radius; dx <= radius; ++dx) {
    const int xx = x + dx;
    for (int dy = -radius; dy <= radius; ++dy) {
      const int yy = y + dy;
      for (int dz = -radius; dz <= radius; ++dz) {
        const int zz = z + dz;
        int v = -1;
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

int resident_blocks() {  // blocks of propagate_kernel that fit the card at once
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaFuncSetAttribute(propagate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, propagate_kernel, THREADS, SMEM) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

}  // namespace

// out = propagate_labels_3d(labels, grow, iterations) in one launch. tmp is a
// second [X, Y, Z] int32 buffer and ws holds W_HEADER + 2 * n_tiles int32
// words, both uninitialised; n_tiles must equal the tile count of this
// source's tile shape (the wrapper computes it from ops/propagate.py TILE).
// ws[W_ROUNDS] receives the rounds run.
extern "C" int khr_propagate(const void* labels, const void* grow, void* out, void* tmp, void* ws, int X, int Y,
                             int Z, int n_tiles, int iterations, void* stream) {
  const int nx = (X + TX - 1) / TX, ny = (Y + TY - 1) / TY, nz = (Z + TZ - 1) / TZ;
  if (X <= 0 || Y <= 0 || Z <= 0 || iterations < 0 || (long long)nx * ny * nz != n_tiles)
    return (int)cudaErrorInvalidValue;
  const int resident = resident_blocks();
  if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
  const int blocks = n_tiles < resident ? n_tiles : resident;
  if (blocks >= (1 << 16) || blocks >= (1ll << FIELD)) return (int)cudaErrorInvalidConfiguration;
  const Tiles g{X, Y, Z, ny, nz};

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, propagate_kernel, (const int32_t*)labels, (const uint8_t*)grow,
                                             (int32_t*)out, (int32_t*)tmp, (int32_t*)ws, g, n_tiles, iterations);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One round of the first port's design: dst = where(grow, max27(masked src), -1).
// radius 1 is a round, radius 0 only masks; mask_src != 0 masks the neighbours
// read from src by grow (needed when src is the caller's unmasked input).
extern "C" int khr_propagate_round(const void* src, const void* grow, void* dst, int X, int Y, int Z, int radius,
                                   int mask_src, void* stream) {
  const long long n = (long long)X * Y * Z;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    propagate_round_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)src, (const uint8_t*)grow, (int32_t*)dst, X, Y, Z, radius, mask_src);
  }
  return (int)cudaGetLastError();
}
