// Per-bucket OHLCV aggregation of a batch of tick rows.
//
// Replaces: iv_interpolation_tpu/ops/pallas/stream_agg_pallas.py,
//   aggregate_ohlcv_pallas (kernel body _agg_kernel).
// Wrapper, launch plan and plain PyTorch version:
//   iv_interpolation_tpu_torch/ops/cuda/stream_agg.py.
//
// Contract (one row = one underlying): bucket id = floor(minute /
// bucket_minutes) - base_bucket; rows with valid == 0 or an id outside
// [0, num_segments) are dropped. Per bucket: high = max h, low = min l,
// volume = sum v, count = number of rows, open = o at the first row and
// close = c at the last row by row position. Membership is by bucket id,
// so high, low, volume and count do not depend on the rows being sorted.
// Invalid rows may carry NaN or Inf: their o, h, l, c, v are never read
// into a result. Empty buckets get count 0, NaN prices and volume 0, and
// valid = count > 0 and count >= min_count (the plain version's
// finish_candles, done here in the epilogue).
//
// Layout: inputs (B, L) row-major, minutes int32 or int64, values float32
// or float64 (all five of one type, outputs in the same); outputs
// (B, num_segments). Grid (B, tiles): block (r, y) owns row r and the
// buckets [y * tile, y * tile + tile). The plan makes tile = num_segments,
// one tile, whenever the accumulators fit in shared memory (24 bytes a
// bucket in float32, up to kMaxTile buckets; 36 bytes in float64, up to
// 6,144 buckets in the 227 KiB a block may hold); only beyond that do
// several tile blocks each read the row.
//
// What bounds it on the H100: the bytes, once the atomics are cut. A
// call must read valid, and minutes, h, l, v of the valid rows, o and c
// once per nonempty bucket, and write 25 bytes a bucket. A block per
// fixed tile of 1,024 buckets would read each row 4 times at the candle
// stage's 3,278, and six shared-memory atomics for every tick would
// serialise on buckets that 4-7 neighbouring lanes hit at once.
//
// What the design does about it:
// - one pass over the row: a thread takes 4 consecutive ticks with
//   vector loads (valid as one 32-bit word, minutes as one or two 16-byte
//   loads, h, l and v as float4) and reads minutes and values only where
//   a tick of the four is valid; the next chunk's valid word is read while
//   this chunk's minutes and values are in flight;
// - a thread first merges its own ticks of one bucket in registers; the
//   warp then presents one (bucket, partial) a lane at a time: lanes with
//   the same bucket id (__match_any_sync) combine max, min, volume, count,
//   first and last row by shuffles in a log-depth tree, and one leader
//   lane a bucket does the six atomics. Sorted rows, as both main paths
//   feed, need one or two rounds per 128 ticks; unsorted rows stay
//   correct with up to four;
// - high and low are atomicMax/atomicMin on an order-preserving integer
//   image of the value (32-bit for float32, 64-bit for float64; exact, the
//   same result in any order); first and
//   last row are integer atomics, so open and close are read once per
//   nonempty bucket after the barrier;
// - the bucket id is a floor division by a multiply-high with a magic
//   number computed once a launch (no division instruction for minutes in
//   int32, none at all for bucket_minutes 1), and a 64-bit division for
//   minutes outside int32, so int64 minutes need no range check or
//   conversion on the host; ids out of range are dropped, as in the plain
//   version.
//
// Volume is a sum in shared memory, in the values' type, whose order
// changes from run to run. Each result is a sum of the bucket's values in
// some order, so it lies within (count - 1) * eps * sum |v| of the exact
// sum (eps of the values' type), like any such sum of the same values.
//
// The bucket id uses floor division: C++ '/' truncates toward zero and
// would put minute -1 of bucket_minutes 5 into bucket 0 instead of -1.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTile = 8192;           // 192 KiB of float32 accumulators a block
constexpr int kDefaultSmem = 48 * 1024;  // above this, opt in per kernel
constexpr int kMaxSmem = 232448;         // 227 KiB: the H100's block limit
constexpr unsigned kFull = 0xffffffffu;

// Per value type: the integer type of its order-preserving image and that
// image's extremes. The map value -> image keeps order (a < b as values iff
// image(a) < image(b) as signed integers, for non-NaN values) and is its
// own inverse.
template <typename V>
struct Value;

template <>
struct Value<float> {
  using Image = int;
  static constexpr Image kLowest = INT_MIN;
  static constexpr Image kHighest = INT_MAX;
  static __device__ __forceinline__ Image ordered_image(float x) {
    const int bits = __float_as_int(x);
    return bits >= 0 ? bits : bits ^ 0x7fffffff;
  }
  static __device__ __forceinline__ float from_image(Image image) {
    return __int_as_float(image >= 0 ? image : image ^ 0x7fffffff);
  }
  static __device__ __forceinline__ float nan() {
    return __int_as_float(0x7fc00000);
  }
};

template <>
struct Value<double> {
  using Image = long long;
  static constexpr Image kLowest = LLONG_MIN;
  static constexpr Image kHighest = LLONG_MAX;
  static __device__ __forceinline__ Image ordered_image(double x) {
    const long long bits = __double_as_longlong(x);
    return bits >= 0 ? bits : bits ^ 0x7fffffffffffffffll;
  }
  static __device__ __forceinline__ double from_image(Image image) {
    return __longlong_as_double(image >= 0 ? image
                                           : image ^ 0x7fffffffffffffffll);
  }
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000ll);
  }
};

// Shared-memory bytes a bucket's accumulators take: high and low images,
// volume, and count, first row, last row as ints.
template <typename V>
constexpr size_t bucket_bytes() {
  return 2 * sizeof(typename Value<V>::Image) + sizeof(V) + 3 * sizeof(int);
}

// floor(m / bm) for a bucket_minutes bm > 0 fixed for the launch, with no
// division instruction where m fits in int32: bm == 1 is the identity;
// otherwise m + bias (bias, a multiple of bm >= 2^31, makes it
// non-negative and below 2^32 + bm) times magic = ceil(2^64 / bm), high
// 64 bits, is the exact quotient (the error, below n / 2^64, stays under
// 1 / bm), less bias / bm. Minutes outside int32 take a 64-bit division.
struct FloorDiv {
  long long bm;
  unsigned long long magic;  // ceil(2^64 / bm) for bm >= 2
  long long bias;            // bm * ceil(2^31 / bm)
  long long bias_q;          // bias / bm
};

FloorDiv make_floor_div(long long bm) {
  FloorDiv f{bm, 0, 0, 0};
  if (bm >= 2) {
    f.magic = ~0ull / static_cast<unsigned long long>(bm) + 1;
    f.bias_q = ((1ll << 31) + bm - 1) / bm;
    f.bias = f.bias_q * bm;
  }
  return f;
}

__device__ __forceinline__ long long floor_div(long long a, const FloorDiv& f) {
  if (f.bm == 1) return a;
  if (a == static_cast<int>(a)) {
    const auto n = static_cast<unsigned long long>(a + f.bias);
    return static_cast<long long>(__umul64hi(n, f.magic)) - f.bias_q;
  }
  const long long q = a / f.bm;
  return (a % f.bm != 0 && a < 0) ? q - 1 : q;
}

// Load 4 consecutive minutes at m (16-byte aligned).
__device__ __forceinline__ void load4(const int* m, int out[4]) {
  const int4 q = *reinterpret_cast<const int4*>(m);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}

__device__ __forceinline__ void load4(const long long* m, long long out[4]) {
  const longlong2 a = *reinterpret_cast<const longlong2*>(m);
  const longlong2 b = *reinterpret_cast<const longlong2*>(m + 2);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  out[0] = q.x; out[1] = q.y; out[2] = q.z; out[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double out[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

// Bit k set where tick t0 + k of the row exists and is valid; one 32-bit
// load for the four flags where the row allows (vec: L % 4 == 0, aligned).
__device__ __forceinline__ unsigned valid_bits(const unsigned char* row,
                                               int t0, int L, bool vec) {
  unsigned bits = 0;
  if (vec) {
    if (t0 < L) {
      const unsigned word = *reinterpret_cast<const unsigned*>(row + t0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((word >> (8 * k)) & 0xffu) bits |= 1u << k;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (t0 + k < L && row[t0 + k]) bits |= 1u << k;
    }
  }
  return bits;
}

// Combine each lane's partial with those of the other lanes in its peer
// group (same bucket id); the group's lowest lane ends with the group's
// total. Log-depth: in round j a lane adds the partial of the next peer
// still in play, then the peers whose rank has bit j set drop out. Every
// lane of the warp takes part.
template <typename I, typename V>
__device__ __forceinline__ void reduce_peers(unsigned peers, int lane,
                                             I& hi, I& lo, V& vol,
                                             int& cnt, int& first,
                                             int& last) {
  unsigned rest = peers & ~((2u << lane) - 1u);  // peers above this lane
  int rank = __popc(peers & ((1u << lane) - 1u));
  while (__any_sync(kFull, rest != 0)) {
    const int next = __ffs(rest) - 1;
    const int src = next < 0 ? lane : next;
    const I hi2 = __shfl_sync(kFull, hi, src);
    const I lo2 = __shfl_sync(kFull, lo, src);
    const V vol2 = __shfl_sync(kFull, vol, src);
    const int cnt2 = __shfl_sync(kFull, cnt, src);
    const int first2 = __shfl_sync(kFull, first, src);
    const int last2 = __shfl_sync(kFull, last, src);
    if (next >= 0) {
      hi = max(hi, hi2);
      lo = min(lo, lo2);
      vol += vol2;
      cnt += cnt2;
      first = min(first, first2);
      last = max(last, last2);
    }
    rest &= ~__ballot_sync(kFull, rank & 1);
    rank >>= 1;
  }
}

template <typename M, typename V>
__global__ void stream_agg_kernel(const M* __restrict__ minutes,
                                  const V* __restrict__ o,
                                  const V* __restrict__ h,
                                  const V* __restrict__ l,
                                  const V* __restrict__ c,
                                  const V* __restrict__ v,
                                  const unsigned char* __restrict__ valid,
                                  V* __restrict__ open,
                                  V* __restrict__ high,
                                  V* __restrict__ low,
                                  V* __restrict__ close,
                                  V* __restrict__ volume,
                                  int* __restrict__ count,
                                  unsigned char* __restrict__ valid_out,
                                  int L, int num_segments,
                                  FloorDiv bucket,
                                  long long base_bucket, int min_count,
                                  int tile, int vec) {
  using Val = Value<V>;
  using Image = typename Val::Image;
  // the widest accumulators first, so each array starts aligned
  extern __shared__ __align__(16) unsigned char smem[];
  Image* s_high = reinterpret_cast<Image*>(smem);
  Image* s_low = s_high + tile;
  V* s_vol = reinterpret_cast<V*>(s_low + tile);
  int* s_count = reinterpret_cast<int*>(s_vol + tile);
  int* s_first = s_count + tile;
  int* s_last = s_first + tile;

  const int lo_id = blockIdx.y * tile;
  const int width = min(tile, num_segments - lo_id);
  const long long in_row = static_cast<long long>(blockIdx.x) * L;
  const long long out_row =
      static_cast<long long>(blockIdx.x) * num_segments + lo_id;
  const long long id0 = base_bucket + lo_id;  // bucket id of s = 0
  const int lane = threadIdx.x & 31;

  for (int s = threadIdx.x; s < width; s += blockDim.x) {
    s_high[s] = Val::kLowest;
    s_low[s] = Val::kHighest;
    s_count[s] = 0;
    s_first[s] = INT_MAX;
    s_last[s] = -1;
    s_vol[s] = V(0);
  }
  __syncthreads();

  // Every thread runs the same number of chunks, so the warp-wide
  // operations below see all 32 lanes. The next chunk's valid flags are
  // read while this chunk's minutes and values are in flight, so a chunk
  // waits on one round trip to device memory, not three.
  const unsigned char* vrow = valid + in_row;
  const int step = blockDim.x * 4;
  unsigned next = valid_bits(vrow, threadIdx.x * 4, L, vec);
  for (int c0 = 0; c0 < L; c0 += step) {
    const int t0 = c0 + threadIdx.x * 4;
    unsigned pending = next;  // bit k: tick t0 + k counts
    M m[4] = {0, 0, 0, 0};
    V hv[4] = {0, 0, 0, 0}, lv[4] = {0, 0, 0, 0}, vv[4] = {0, 0, 0, 0};
    if (pending) {
      const long long at = in_row + t0;
      if (vec) {
        load4(minutes + at, m);
        load4(h + at, hv);
        load4(l + at, lv);
        load4(v + at, vv);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if ((pending >> k) & 1u) {
            m[k] = minutes[at + k];
            hv[k] = h[at + k];
            lv[k] = l[at + k];
            vv[k] = v[at + k];
          }
        }
      }
    }
    next = valid_bits(vrow, t0 + step, L, vec);
    int seg[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((pending >> k) & 1u) {
        const long long s = floor_div(m[k], bucket) - id0;
        if (s < 0 || s >= width) pending &= ~(1u << k);
        seg[k] = static_cast<int>(s);
      }
    }

    // One round per bucket id a lane still holds: the lane's ticks of the
    // bucket of its first pending tick, merged, then merged across lanes.
    while (__any_sync(kFull, pending != 0)) {
      int key = -1, cnt = 0, first = INT_MAX, last = -1;
      Image hi = Val::kLowest, lo = Val::kHighest;
      V vol = V(0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (((pending >> k) & 1u) && key < 0) key = seg[k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (((pending >> k) & 1u) && seg[k] == key) {
          hi = max(hi, Val::ordered_image(hv[k]));
          lo = min(lo, Val::ordered_image(lv[k]));
          vol += vv[k];
          cnt += 1;
          first = min(first, t0 + k);
          last = max(last, t0 + k);
          pending &= ~(1u << k);
        }
      }
      const unsigned peers = __match_any_sync(kFull, key);
      reduce_peers(peers, lane, hi, lo, vol, cnt, first, last);
      if (key >= 0 && lane == __ffs(peers) - 1) {
        atomicMax(&s_high[key], hi);
        atomicMin(&s_low[key], lo);
        atomicAdd(&s_vol[key], vol);
        atomicAdd(&s_count[key], cnt);
        atomicMin(&s_first[key], first);
        atomicMax(&s_last[key], last);
      }
    }
  }
  __syncthreads();

  const V nan = Val::nan();
  for (int s = threadIdx.x; s < width; s += blockDim.x) {
    const long long out = out_row + s;
    const int n = s_count[s];
    count[out] = n;
    valid_out[out] = n > 0 && n >= min_count;
    if (n > 0) {
      open[out] = o[in_row + s_first[s]];
      close[out] = c[in_row + s_last[s]];
      high[out] = Val::from_image(s_high[s]);
      low[out] = Val::from_image(s_low[s]);
      volume[out] = s_vol[s];
    } else {
      open[out] = nan;
      close[out] = nan;
      high[out] = nan;
      low[out] = nan;
      volume[out] = V(0);
    }
  }
}

bool aligned(const void* p, std::uintptr_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

template <typename M, typename V>
int launch(const M* minutes, const V* o, const V* h, const V* l,
           const V* c, const V* v, const unsigned char* valid,
           V* open, V* high, V* low, V* close, V* volume,
           int* count, unsigned char* valid_out, int B, int L,
           int num_segments, long long bucket_minutes, long long base_bucket,
           int min_count, int tile, int threads, void* stream) {
  if (B < 1 || L < 1 || num_segments < 1 || bucket_minutes < 1 ||
      tile < 1 || tile > kMaxTile || threads < 32 || threads > 512 ||
      threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (num_segments + tile - 1) / tile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bucket_bytes<V>() * static_cast<size_t>(tile);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // Raised once per minute and value type to the block limit, on the first
  // launch above the default (outside any graph capture in this package's
  // use).
  static bool opted_in = false;
  if (smem > kDefaultSmem && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_agg_kernel<M, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  // 4 ticks are 16 bytes of float32 and two 16-byte loads of float64, whose
  // rows then start 32 bytes apart
  const bool vec = L % 4 == 0 && aligned(minutes, 16) && aligned(h, 16) &&
                   aligned(l, 16) && aligned(v, 16) && aligned(valid, 4);
  const dim3 grid(static_cast<unsigned int>(B),
                  static_cast<unsigned int>(tiles));
  stream_agg_kernel<M, V><<<grid, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      minutes, o, h, l, c, v, valid, open, high, low, close, volume, count,
      valid_out, L, num_segments, make_floor_div(bucket_minutes), base_bucket, min_count,
      tile, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define IVT_STREAM_AGG(NAME, M, V)                                         \
  extern "C" int NAME(const M* minutes, const V* o, const V* h, const V* l, \
                      const V* c, const V* v, const unsigned char* valid,   \
                      V* open, V* high, V* low, V* close, V* volume,        \
                      int* count, unsigned char* valid_out, int B, int L,   \
                      int num_segments, long long bucket_minutes,           \
                      long long base_bucket, int min_count, int tile,       \
                      int threads, void* stream) {                          \
    return launch<M, V>(minutes, o, h, l, c, v, valid, open, high, low,     \
                        close, volume, count, valid_out, B, L,              \
                        num_segments, bucket_minutes, base_bucket,          \
                        min_count, tile, threads, stream);                  \
  }

IVT_STREAM_AGG(ivt_stream_agg_i32, int, float)
IVT_STREAM_AGG(ivt_stream_agg_i64, long long, float)
IVT_STREAM_AGG(ivt_stream_agg_i32_f64, int, double)
IVT_STREAM_AGG(ivt_stream_agg_i64_f64, long long, double)
