// Kernel B: row gather out[i, :] = img[clamp(idx[i]), :].
//
// Replaces: khronos_tpu/ops/pallas/gather_probe.py::make_pallas_gather (its
// inner `kernel`). On the main path it is the per-voxel image lookup
// `packed_img[lin_pix]` of map/active_volume.py::integrate_frame: img is the
// [H*W, 2] payload image (depth f32 + one bit-packed word of rgb, label and
// exclusion flag) and idx holds one projective pixel index per crop voxel.
//
// What bounds it on Hopper: bytes. Each row is 8 bytes and the arithmetic is
// nil; the least traffic is one read of idx and img and one write of out
// (about 9.7 MB at 480x640 and a 112x112x48 crop). The rows read follow the
// projection, so neighbouring voxels hit nearby pixels and the 2.4 MB image
// stays in L2; the loads are scattered at 8-byte granularity, so the kernel
// runs at the L2's random-access rate rather than at the HBM stream rate.
//
// Design: one thread per row, with one 8-byte load and store when C == 2
// (int2: bits are copied, never converted, so payload words whose bits are
// NaN patterns survive); any other C falls back to one thread per element.
// Indices follow jnp indexing: a negative index counts from the end (once),
// then the result is clamped to [0, rows - 1]. On the main path every index
// is already in range.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long clamp_row(long long j, long long rows) {
  if (j < 0) j += rows;
  return j < 0 ? 0 : (j >= rows ? rows - 1 : j);
}

__global__ void gather_rows_c2_kernel(const int2* __restrict__ img,
                                      const int32_t* __restrict__ idx,
                                      int2* __restrict__ out, long long rows,
                                      long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = __ldg(img + clamp_row(__ldg(idx + i), rows));
}

__global__ void gather_rows_kernel(const int32_t* __restrict__ img,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, long long rows,
                                   int channels, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * channels) return;
  const long long i = e / channels;
  const int c = (int)(e % channels);
  out[e] = __ldg(img + clamp_row(__ldg(idx + i), rows) * channels + c);
}

}  // namespace

// img: [rows, channels] 32-bit words, idx: [n] int32, out: [n, channels].
// The C == 2 path needs img and out 8-byte aligned (the wrapper checks).
extern "C" int khr_gather_rows(const void* img, const void* idx, void* out,
                               long long rows, int channels, long long n,
                               void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && channels == 2) {
    const long long blocks = (n + threads - 1) / threads;
    gather_rows_c2_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const int2*)img, (const int32_t*)idx, (int2*)out, rows, n);
  } else if (n > 0 && channels > 0) {
    const long long blocks = (n * channels + threads - 1) / threads;
    gather_rows_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const int32_t*)img, (const int32_t*)idx, (int32_t*)out, rows, channels, n);
  }
  return (int)cudaGetLastError();
}
