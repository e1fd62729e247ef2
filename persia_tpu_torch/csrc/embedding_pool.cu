// Grouped gather-pool of device-pooled embedding slots, forward and backward.
//
// Forward (gather_pool_fwd): for each slot s of a group (one dim, one row
// dtype T) and each sample b,
//   out[b, slot0 + s, :] = scale_s[b] * sum_l rows_s[index_s[b, l], :]
// summed in f32 in l order, out (B, out_slots, dim) f32, scale_s[b] =
// rsqrt(max(counts_s[b], 1)) where the slot has counts, else 1.
// Backward (gather_pool_bwd): for each slot s and each of its P_s rows r,
//   grad_rows_s[r, :] = sum over (b, l) with index_s[b, l] == r of
//                       scale_s[b] * g[b, slot0 + s, :]
// summed in f32 and rounded once to T. A CSR of the index, built on the
// host, lists the positions b * L + l sorted by row (order_s) and each row's
// span in that list (offsets_s).
//
// Replaces: persia_tpu/parallel/train_step.py:69-87, the device-pooled
// branch of _embedding_model_inputs, where XLA gathers and sums each slot
// in its own fusion and autodiff transposes the gather into a scatter-add
// in the wire dtype; there is no Pallas kernel for it.
//
// Bound on the H100: bytes. At the bench shape (B=4096, 26 slots, L=1,
// dim 16, bf16 rows) the forward reads the index (0.4 MB) and the rows it
// gathers and writes 6.8 MB of f32; the backward reads that much gradient
// and writes the rows. A handful of FLOP per byte.
//
// Design: one launch for the whole group each way (at most kMaxSlots
// slots; a wider group is cut into several launches by the wrapper).
// Per-slot pointers, row counts and ids per sample ride in a parameter
// struct passed by value (__grid_constant__). Index math is 32-bit (the
// entry points check the ranges). Geometry comes from
// ops/plans.py::pool_plan and is checked here.
//
// - Forward: one thread per (sample, slot, VEC columns), in that order, so
//   a warp's stores cover one contiguous span of out (a sample's slots are
//   adjacent there): one 16-byte load per id (8 bf16 or 4 f32) and 16-byte
//   stores. The slot then varies within a warp, so each block copies the
//   slots' fields from the parameter struct into shared memory first. Other
//   dims and alignments take VEC = 1.
// - Backward, two launches, no float atomics, every row written once:
//   1. the sorted positions of a slot are cut into chunks of C, one warp a
//      chunk. A lane group (`lanes` lanes, one row's columns, float4 each)
//      walks 8 consecutive positions; each loads its sample and row (two
//      loads that depend on order[k]) and its gradient row, so a warp has
//      32 / lanes * 8 independent rows in flight. Segments (runs of one row)
//      are summed in position order inside a group, and across groups by a
//      segmented inclusive scan over shuffles (fixed tree, so two runs give
//      the same bits). A segment that begins and ends in the chunk is
//      rounded to T and stored; the chunk's first segment, where it began in
//      the chunk before, stores its f32 sum to partials[chunk][0], and its
//      last, where it goes on into the next chunk, to partials[chunk][1].
//   2. one thread group per row reads offsets[r], offsets[r + 1]: an empty
//      row is written 0; a row inside one chunk was written by pass 1; a
//      row over several chunks sums partials[first][1] and partials[k][0]
//      of the chunks after it, in chunk order, and rounds once.
//   The slot is blockIdx.y in both passes: its fields are warp-uniform reads
//   of parameter memory.
//   So the time no longer follows the longest segment: a row holding all B
//   positions is 1/C of them in each chunk plus one pass-2 sum of B / C
//   partials. Pads point at row D and sum there, as the reference's
//   autodiff does; the host drops that row.

#include <climits>
#include <cstdint>

#include "common.cuh"

// outside the anonymous namespace: the C entry points take it, and a
// parameter of an internal type would give them internal linkage too
constexpr int kMaxSlots = 64;

struct PoolSlotsParams {
  void* rows[kMaxSlots];  // (P, dim) T: the forward reads them, the backward writes its output here
  const int32_t* index[kMaxSlots];  // (B, L)
  const int32_t* counts[kMaxSlots];  // (B,) or null: no sqrt scaling
  const int32_t* order[kMaxSlots];  // backward: (B * L,) positions sorted by row
  const int32_t* offsets[kMaxSlots];  // backward: (P + 1,)
  int num_rows[kMaxSlots];  // P
  int ids_per_sample[kMaxSlots];  // L
};

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kGroupPositions = 8;  // consecutive sorted positions a lane group walks
constexpr int kNoRow = INT_MAX;  // positions past a slot's end (sorts last)
constexpr int kMaxThreads = 256;
constexpr int kPass2Batch = 16;  // partials pass 2 loads before it adds them

__device__ __forceinline__ float sample_scale(const int32_t* counts, int b) {
  return counts == nullptr ? 1.f : rsqrtf(static_cast<float>(max(__ldg(counts + b), 1)));
}

// N consecutive elements of a row widened to f32: one 16-byte load for
// N = 4 (f32) or 8 (bf16), else one element
__device__ __forceinline__ void load_f32(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // bf16 -> f32 is exact: the bits move up
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_f32(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = persia::to_f32(*p);
}

// N f32 values stored as T: 16-byte f32 stores, 8-byte stores of 4 bf16
// (round to nearest even), or one element
__device__ __forceinline__ void store_as(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store_as(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_as(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&lo);
  q.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}
template <typename T>
__device__ __forceinline__ void store_as(T* p, const float (&v)[1]) {
  persia::store_f32(p, v[0]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
gather_pool_fwd_kernel(const __grid_constant__ PoolSlotsParams p, float* __restrict__ out, int batch,
                       int dim, int nslots, int out_slots, int slot0) {
  // the slot varies within a warp, so its fields come from shared memory
  // (parameter memory serialises a warp's distinct addresses)
  __shared__ const T* s_rows[kMaxSlots];
  __shared__ const int32_t* s_index[kMaxSlots];
  __shared__ const int32_t* s_counts[kMaxSlots];
  __shared__ int s_ids[kMaxSlots];
  for (int i = threadIdx.x; i < nslots; i += blockDim.x) {
    s_rows[i] = static_cast<const T*>(p.rows[i]);
    s_index[i] = p.index[i];
    s_counts[i] = p.counts[i];
    s_ids[i] = p.ids_per_sample[i];
  }
  __syncthreads();
  const int row_vecs = dim / VEC;
  const int per_sample = nslots * row_vecs;  // (slot, column vector) items of a sample
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * per_sample) return;
  const int b = t / per_sample;
  const int item = t - b * per_sample;
  const int s = item / row_vecs;
  const int c = (item - s * row_vecs) * VEC;
  const int L = s_ids[s];
  const int32_t* idx = s_index[s] + b * L;
  const T* rows = s_rows[s];
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int l = 0; l < L; ++l) {
    float v[VEC];
    load_f32(rows + __ldg(idx + l) * dim + c, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], v[j]);
  }
  const float scale = sample_scale(s_counts[s], b);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = __fmul_rn(acc[j], scale);
  // a sample's slots slot0.. are contiguous in out: item * VEC is the offset
  store_as(out + (b * out_slots + slot0) * dim + item * VEC, acc);
}

// Pass 1 of the backward: one warp per chunk of a slot's sorted positions
// (see the head of the file). VEC = 4 (float4 columns) or 1; a lane group
// of 2^lanes_log2 lanes holds one position's columns, col_tiles times.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
gather_pool_bwd_chunks_kernel(const __grid_constant__ PoolSlotsParams p, const float* __restrict__ grad,
                              float* __restrict__ partials, int batch, int dim, int out_slots, int slot0,
                              int lanes_log2, int col_tiles, int max_chunks) {
  const int s = blockIdx.y;
  const int L = p.ids_per_sample[s];
  const int n = batch * L;
  const int lanes = 1 << lanes_log2;
  const int groups = 32 >> lanes_log2;
  const int chunk_len = groups * kGroupPositions;
  const int chunk = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (chunk * chunk_len >= n) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int g = lane >> lanes_log2;
  const int v = lane & (lanes - 1);
  const int k0 = chunk * chunk_len;
  const int32_t* order = p.order[s];
  const int32_t* index = p.index[s];
  const int32_t* counts = p.counts[s];

  int row[kGroupPositions], goff[kGroupPositions];
  float scale[kGroupPositions];
#pragma unroll
  for (int i = 0; i < kGroupPositions; ++i) {
    const int k = k0 + g * kGroupPositions + i;
    row[i] = kNoRow;
    goff[i] = 0;
    scale[i] = 0.f;
    if (k < n) {
      const int pos = __ldg(order + k);
      const int b = L == 1 ? pos : pos / L;
      row[i] = __ldg(index + pos);
      goff[i] = (b * out_slots + slot0 + s) * dim;
      scale[i] = sample_scale(counts, b);
    }
  }
  // the rows just before and just after the chunk (-1: none): did its first
  // segment begin in the chunk before, does its last go on into the next?
  const int row_before = k0 > 0 ? __ldg(index + __ldg(order + k0 - 1)) : -1;
  const int row_after = k0 + chunk_len < n ? __ldg(index + __ldg(order + k0 + chunk_len)) : -1;
  const int head = row[0], tail = row[kGroupPositions - 1];
  const int first_row = __shfl_sync(kFullMask, head, 0);
  const int prev_tail = __shfl_up_sync(kFullMask, tail, lanes);
  const int next_head = __shfl_down_sync(kFullMask, head, lanes);
  // this group's first segment began in the group before; its last segment
  // begins in this group unless the whole group continues one
  const bool continues = g > 0 && prev_tail == head;
  const bool tail_starts_here = !continues || head != tail;
  float* part = partials + (s * max_chunks + chunk) * 2 * dim;
  T* out_rows = static_cast<T*>(p.rows[s]);

  for (int tile = 0; tile < col_tiles; ++tile) {
    const int c = ((tile << lanes_log2) + v) * VEC;
    const bool col_ok = c < dim;  // the scalar path's last tile may be ragged
    float x[kGroupPositions][VEC];
#pragma unroll
    for (int i = 0; i < kGroupPositions; ++i) {
      if (row[i] != kNoRow && col_ok) {
        load_f32(grad + goff[i] + c, x[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) x[i][j] = __fmul_rn(x[i][j], scale[i]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) x[i][j] = 0.f;
      }
    }
    // the group's last segment, summed in position order
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = x[0][j];
#pragma unroll
    for (int i = 1; i < kGroupPositions; ++i) {
      const bool same = row[i] == row[i - 1];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = same ? __fadd_rn(acc[j], x[i][j]) : x[i][j];
    }
    // segmented inclusive scan of those sums over the groups (Hillis-Steele,
    // earlier groups' sum on the left); a flag stops the sum where a
    // group's last segment begins
    float scan[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) scan[j] = acc[j];
    bool flag = tail_starts_here;
    for (int d = 1; d < groups; d <<= 1) {
      const int delta = d << lanes_log2;
      float up[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) up[j] = __shfl_up_sync(kFullMask, scan[j], delta);
      const bool up_flag = __shfl_up_sync(kFullMask, static_cast<int>(flag), delta) != 0;
      if (g >= d) {
        if (!flag) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) scan[j] = __fadd_rn(up[j], scan[j]);
        }
        flag = flag || up_flag;
      }
    }
    float carry[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) carry[j] = __shfl_up_sync(kFullMask, scan[j], lanes);
    // walk again, storing every segment that ends in this group
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = continues ? __fadd_rn(carry[j], x[0][j]) : x[0][j];
#pragma unroll
    for (int i = 0; i < kGroupPositions; ++i) {
      if (i > 0) {
        const bool same = row[i] == row[i - 1];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] = same ? __fadd_rn(acc[j], x[i][j]) : x[i][j];
      }
      const bool chunk_end = i == kGroupPositions - 1 && g == groups - 1;
      const int next = i < kGroupPositions - 1 ? row[i + 1] : next_head;
      if (row[i] == kNoRow || !col_ok || (!chunk_end && next == row[i])) continue;
      const bool starts_before = row[i] == first_row && row_before == row[i];
      const bool ends_after = chunk_end && row_after == row[i];
      if (starts_before || ends_after) {
        store_as(part + (starts_before ? 0 : dim) + c, acc);
      } else {
        store_as(out_rows + row[i] * dim + c, acc);
      }
    }
  }
}

// Pass 2 of the backward: thread (x, y) of block (bx, s) takes row
// bx * blockDim.y + y and VEC columns from x * VEC
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
gather_pool_bwd_rows_kernel(const __grid_constant__ PoolSlotsParams p, const float* __restrict__ partials,
                            int dim, int chunk_log2, int max_chunks) {
  const int s = blockIdx.y;
  const int r = blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= p.num_rows[s]) return;
  const int start = __ldg(p.offsets[s] + r);
  const int end = __ldg(p.offsets[s] + r + 1);
  const int first = start >> chunk_log2;
  const int last = (end - 1) >> chunk_log2;
  if (end > start && first == last) return;  // pass 1 wrote it
  const float* part = partials + s * max_chunks * 2 * dim;
  T* out = static_cast<T*>(p.rows[s]) + r * dim;
  for (int c = threadIdx.x * VEC; c < dim; c += blockDim.x * VEC) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    if (end > start) {
      load_f32(part + (2 * first + 1) * dim + c, acc);
      // the partials in chunk order, kPass2Batch loads in flight before
      // their adds, so a row over all B positions costs B / C / kPass2Batch
      // round trips
      for (int k = first + 1; k <= last; k += kPass2Batch) {
        float v[kPass2Batch][VEC];
#pragma unroll
        for (int u = 0; u < kPass2Batch; ++u) {
          if (k + u <= last) load_f32(part + 2 * (k + u) * dim + c, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kPass2Batch; ++u) {
          if (k + u <= last) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], v[u][j]);
          }
        }
      }
    }
    store_as(out + c, acc);
  }
}

bool fits_int(long long x) { return x >= 0 && x < INT_MAX; }

bool aligned(const void* ptr, int bytes) { return reinterpret_cast<uintptr_t>(ptr) % bytes == 0; }

int log2_exact(int x) {
  if (x < 1 || (x & (x - 1)) != 0) return -1;
  int k = 0;
  while ((1 << k) < x) ++k;
  return k;
}

// the group's pointers, the shapes and every product the kernels form in
// 32-bit index math
int check_group(const PoolSlotsParams* p, int nslots, int batch, int dim, int out_slots, int slot0,
                bool backward) {
  if (p == nullptr || nslots < 1 || nslots > kMaxSlots || batch < 1 || dim < 1 || slot0 < 0 ||
      slot0 + nslots > out_slots || !fits_int(1LL * batch * out_slots * dim)) {
    return cudaErrorInvalidValue;
  }
  for (int s = 0; s < nslots; ++s) {
    if (p->rows[s] == nullptr || p->index[s] == nullptr || p->num_rows[s] < 1 ||
        p->ids_per_sample[s] < 1 || !fits_int(1LL * p->num_rows[s] * dim) ||
        !fits_int(1LL * batch * p->ids_per_sample[s])) {
      return cudaErrorInvalidValue;
    }
    if (backward && (p->order[s] == nullptr || p->offsets[s] == nullptr)) {
      return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

bool block_ok(int x, int y) { return x >= 1 && y >= 1 && x * y >= 32 && x * y <= kMaxThreads; }

template <typename T, int VEC>
int launch_bwd(const PoolSlotsParams* p, const float* grad, float* partials, int batch, int dim,
               int out_slots, int slot0, int lanes_log2, int col_tiles, int chunk_len, int max_chunks,
               dim3 chunk_grid, int chunk_threads, dim3 row_grid, dim3 row_block, cudaStream_t stream) {
  gather_pool_bwd_chunks_kernel<T, VEC><<<chunk_grid, chunk_threads, 0, stream>>>(
      *p, grad, partials, batch, dim, out_slots, slot0, lanes_log2, col_tiles, max_chunks);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != cudaSuccess) return rc;
  gather_pool_bwd_rows_kernel<T, VEC><<<row_grid, row_block, 0, stream>>>(
      *p, partials, dim, log2_exact(chunk_len), max_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward: vec = 8 (bf16) or 4 (f32) for 16-byte loads and stores (dim a
// multiple of vec, every rows pointer 16-byte aligned), else 1. One thread
// per (sample, slot, vec columns), threads a block, grid blocks. Returns a
// CUDA error code.
extern "C" int persia_gather_pool_fwd(const PoolSlotsParams* p, void* out, int dtype, int nslots,
                                      int batch, int dim, int out_slots, int slot0, int vec,
                                      int threads, int grid, void* stream) {
  int rc = check_group(p, nslots, batch, dim, out_slots, slot0, false);
  if (rc != cudaSuccess) return rc;
  if (dtype != persia::kFloat32 && dtype != persia::kBFloat16) return cudaErrorInvalidValue;
  const int wide = dtype == persia::kFloat32 ? 4 : 8;
  if (vec != 1 && vec != wide) return cudaErrorInvalidValue;
  if (vec > 1) {
    if (dim % vec != 0 || !aligned(out, 16)) return cudaErrorInvalidValue;
    for (int s = 0; s < nslots; ++s) {
      if (!aligned(p->rows[s], 16)) return cudaErrorInvalidValue;
    }
  }
  const long long items = 1LL * batch * nslots * (dim / vec);
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || 1LL * grid * threads < items ||
      1LL * (grid - 1) * threads >= items) {
    return cudaErrorInvalidValue;
  }
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == persia::kFloat32 && vec == 4) {
    gather_pool_fwd_kernel<float, 4><<<grid, threads, 0, st>>>(*p, o, batch, dim, nslots, out_slots, slot0);
  } else if (dtype == persia::kFloat32) {
    gather_pool_fwd_kernel<float, 1><<<grid, threads, 0, st>>>(*p, o, batch, dim, nslots, out_slots, slot0);
  } else if (vec == 8) {
    gather_pool_fwd_kernel<__nv_bfloat16, 8><<<grid, threads, 0, st>>>(*p, o, batch, dim, nslots, out_slots,
                                                                        slot0);
  } else {
    gather_pool_fwd_kernel<__nv_bfloat16, 1><<<grid, threads, 0, st>>>(*p, o, batch, dim, nslots, out_slots,
                                                                        slot0);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward, both passes on one stream. vec = 4 (float4 columns: dim ==
// col_tiles * lanes_per_pos * 4, grad 16-byte aligned) or 1 (scalar
// columns, the last tile ragged). A chunk is 32 / lanes_per_pos * 8
// positions; partials is (nslots, max_chunks, 2, dim) f32. Pass 1: grid
// (chunk_grid_x, nslots) of chunk_warps warps; pass 2: grid (row_grid_x,
// nslots) of blocks (row_block_x, row_block_y). Returns a CUDA error code.
extern "C" int persia_gather_pool_bwd(const PoolSlotsParams* p, void* grad, void* partials, int dtype,
                                      int nslots, int batch, int dim, int out_slots, int slot0, int vec,
                                      int lanes_per_pos, int col_tiles, int max_chunks, int chunk_warps,
                                      int chunk_grid_x, int row_block_x, int row_block_y,
                                      int row_grid_x, void* stream) {
  int rc = check_group(p, nslots, batch, dim, out_slots, slot0, true);
  if (rc != cudaSuccess) return rc;
  const int lanes_log2 = log2_exact(lanes_per_pos);
  if ((dtype != persia::kFloat32 && dtype != persia::kBFloat16) || (vec != 1 && vec != 4) ||
      lanes_log2 < 0 || lanes_per_pos > 32 || col_tiles < 1 || grad == nullptr || partials == nullptr) {
    return cudaErrorInvalidValue;
  }
  const int tile_cols = lanes_per_pos * vec;
  if (1LL * col_tiles * tile_cols < dim || 1LL * (col_tiles - 1) * tile_cols >= dim) {
    return cudaErrorInvalidValue;
  }
  if (vec == 4) {
    const int row_bytes = dtype == persia::kFloat32 ? 16 : 8;
    if (dim != col_tiles * tile_cols || !aligned(grad, 16) || !aligned(partials, 16)) {
      return cudaErrorInvalidValue;
    }
    for (int s = 0; s < nslots; ++s) {
      if (!aligned(p->rows[s], row_bytes)) return cudaErrorInvalidValue;
    }
  }
  const int chunk_len = (32 / lanes_per_pos) * kGroupPositions;
  int max_rows = 0;
  for (int s = 0; s < nslots; ++s) {
    const long long n = 1LL * batch * p->ids_per_sample[s];
    if ((n + chunk_len - 1) / chunk_len > max_chunks) return cudaErrorInvalidValue;
    max_rows = max_rows > p->num_rows[s] ? max_rows : p->num_rows[s];
  }
  if (!fits_int(2LL * nslots * max_chunks * dim) || chunk_warps < 1 || chunk_warps * 32 > kMaxThreads ||
      1LL * chunk_grid_x * chunk_warps < max_chunks || 1LL * (chunk_grid_x - 1) * chunk_warps >= max_chunks ||
      !block_ok(row_block_x, row_block_y) || 1LL * row_grid_x * row_block_y < max_rows ||
      1LL * (row_grid_x - 1) * row_block_y >= max_rows) {
    return cudaErrorInvalidValue;
  }
  const dim3 chunk_grid(chunk_grid_x, nslots), row_grid(row_grid_x, nslots);
  const dim3 row_block(row_block_x, row_block_y);
  const float* g = static_cast<const float*>(grad);
  float* part = static_cast<float*>(partials);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = chunk_warps * 32;
  if (dtype == persia::kFloat32) {
    return vec == 4
        ? launch_bwd<float, 4>(p, g, part, batch, dim, out_slots, slot0, lanes_log2, col_tiles, chunk_len,
                               max_chunks, chunk_grid, threads, row_grid, row_block, st)
        : launch_bwd<float, 1>(p, g, part, batch, dim, out_slots, slot0, lanes_log2, col_tiles, chunk_len,
                               max_chunks, chunk_grid, threads, row_grid, row_block, st);
  }
  return vec == 4
      ? launch_bwd<__nv_bfloat16, 4>(p, g, part, batch, dim, out_slots, slot0, lanes_log2, col_tiles,
                                     chunk_len, max_chunks, chunk_grid, threads, row_grid, row_block, st)
      : launch_bwd<__nv_bfloat16, 1>(p, g, part, batch, dim, out_slots, slot0, lanes_log2, col_tiles,
                                     chunk_len, max_chunks, chunk_grid, threads, row_grid, row_block, st);
}
