// Per-bucket OHLCV aggregation of a batch of tick rows.
//
// Replaces: iv_interpolation_tpu/ops/pallas/stream_agg_pallas.py,
//   aggregate_ohlcv_pallas (kernel body _agg_kernel).
// Wrapper and plain PyTorch version:
//   iv_interpolation_tpu_torch/ops/cuda/stream_agg.py.
//
// Contract (one row = one underlying): bucket id = floor(minute /
// bucket_minutes) - base_bucket; rows with valid == 0 or an id outside
// [0, num_segments) are dropped. Per bucket: high = max h, low = min l,
// volume = sum v, count = number of rows, open = o at the first row and
// close = c at the last row by row position. Membership is by bucket id,
// so high, low, volume and count do not depend on the rows being sorted.
// Invalid rows may carry NaN or Inf: their o, h, l, c, v are never read.
// Empty buckets get count 0 and zeros elsewhere; the wrapper fills them.
//
// Layout: inputs (B, L) row-major, outputs (B, num_segments). Grid
// (B, ceil(num_segments / tile)): block (r, y) owns row r and the buckets
// [y * tile, y * tile + tile); it skips ids outside its tile. The
// block's threads stride over the row's L ticks, so reads are coalesced.
//
// What bounds it on the H100: shared-memory atomics. Each valid tick does
// six atomic updates on its bucket's accumulators, and ticks of the same
// bucket contend for them. Device-memory traffic is small next to that:
// one pass over minutes and valid, h, l and v of the rows that count, two
// gathers per bucket for open and close, and one write of the outputs.
//
// What the design does about it: the accumulators live in shared memory,
// 24 bytes a bucket (12 KB at 512 buckets), never in device memory. No
// (L x tile) equality mask is built, as the TPU kernel did, so a row costs
// O(L) work instead of O(L * num_segments). high and low are atomicMax and
// atomicMin on an order-preserving integer image of the float; first and
// last row are atomicMin and atomicMax on the row index, so open and close
// are read once per bucket after the barrier, and only for nonempty
// buckets (never through a masked product: a NaN open of an empty 1-min
// candle times 0 would still be NaN).
//
// Volume is a float atomicAdd in shared memory: the order of the sum
// changes from run to run. Each result is a float32 sum of the bucket's
// values in some order, so it lies within (count - 1) * eps32 * sum |v| of
// the exact sum, like any float32 sum of the same values.
//
// The bucket id uses floor division: C++ '/' truncates toward zero and
// would put minute -1 of bucket_minutes 5 into bucket 0 instead of -1.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 1024;  // 24 KB of accumulators a block

// Order-preserving map float -> int: a < b as floats iff image(a) <
// image(b) as signed ints (for non-NaN values). It is its own inverse.
__device__ __forceinline__ int ordered_image(int bits) {
  return bits >= 0 ? bits : bits ^ 0x7fffffff;
}

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void stream_agg_kernel(const int* __restrict__ minutes,
                                  const float* __restrict__ o,
                                  const float* __restrict__ h,
                                  const float* __restrict__ l,
                                  const float* __restrict__ c,
                                  const float* __restrict__ v,
                                  const unsigned char* __restrict__ valid,
                                  float* __restrict__ open,
                                  float* __restrict__ high,
                                  float* __restrict__ low,
                                  float* __restrict__ close,
                                  float* __restrict__ volume,
                                  int* __restrict__ count,
                                  int L, int num_segments,
                                  int bucket_minutes, int base_bucket,
                                  int tile) {
  extern __shared__ int smem[];
  int* s_high = smem;
  int* s_low = s_high + tile;
  int* s_count = s_low + tile;
  int* s_first = s_count + tile;
  int* s_last = s_first + tile;
  float* s_vol = reinterpret_cast<float*>(s_last + tile);

  const int lo = blockIdx.y * tile;
  const int width = min(tile, num_segments - lo);
  const long long in_row = static_cast<long long>(blockIdx.x) * L;
  const long long out_row =
      static_cast<long long>(blockIdx.x) * num_segments + lo;

  for (int s = threadIdx.x; s < width; s += blockDim.x) {
    s_high[s] = INT_MIN;
    s_low[s] = INT_MAX;
    s_count[s] = 0;
    s_first[s] = INT_MAX;
    s_last[s] = -1;
    s_vol[s] = 0.0f;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const long long at = in_row + t;
    if (!valid[at]) continue;
    const long long s = static_cast<long long>(
        floor_div(minutes[at], bucket_minutes)) - base_bucket - lo;
    if (s < 0 || s >= width) continue;
    atomicMax(&s_high[s], ordered_image(__float_as_int(h[at])));
    atomicMin(&s_low[s], ordered_image(__float_as_int(l[at])));
    atomicAdd(&s_vol[s], v[at]);
    atomicAdd(&s_count[s], 1);
    atomicMin(&s_first[s], t);
    atomicMax(&s_last[s], t);
  }
  __syncthreads();

  for (int s = threadIdx.x; s < width; s += blockDim.x) {
    const long long out = out_row + s;
    const int n = s_count[s];
    count[out] = n;
    if (n > 0) {
      open[out] = o[in_row + s_first[s]];
      close[out] = c[in_row + s_last[s]];
      high[out] = __int_as_float(ordered_image(s_high[s]));
      low[out] = __int_as_float(ordered_image(s_low[s]));
      volume[out] = s_vol[s];
    } else {
      open[out] = 0.0f;
      close[out] = 0.0f;
      high[out] = 0.0f;
      low[out] = 0.0f;
      volume[out] = 0.0f;
    }
  }
}

}  // namespace

extern "C" int ivt_stream_agg(const int* minutes, const float* o,
                              const float* h, const float* l, const float* c,
                              const float* v, const unsigned char* valid,
                              float* open, float* high, float* low,
                              float* close, float* volume, int* count,
                              int B, int L, int num_segments,
                              int bucket_minutes, int base_bucket, int tile,
                              void* stream) {
  if (B < 1 || L < 1 || num_segments < 1 || bucket_minutes < 1 ||
      tile < 1 || tile > kMaxTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (num_segments + tile - 1) / tile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(B),
                  static_cast<unsigned int>(tiles));
  const size_t smem = 6 * sizeof(int) * static_cast<size_t>(tile);
  stream_agg_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      minutes, o, h, l, c, v, valid, open, high, low, close, volume, count,
      L, num_segments, bucket_minutes, base_bucket, tile);
  return static_cast<int>(cudaGetLastError());
}
