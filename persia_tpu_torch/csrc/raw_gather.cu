// The raw-slot gather (K6) and its scatter-add backward (K7).
//
// Forward (raw_gather_fwd): for each slot s of a group (one row dtype, one
// dim, one count n = B * L of positions) and each position k,
//   out[slot0 + s, k, :] = rows_s[index_s[k], :]
// out (out_slots, n, dim) in the rows' dtype: slot-major, so each slot's
// (B, L, dim) is contiguous. The rows are copied as bits. An index outside
// [0, P_s) stops the kernel with a device-side assert (check_row; the host
// range-checks every index before it stages the batch).
// Backward (raw_gather_bwd): for each slot s and each of its P_s rows r
// but the pad row P_s - 1, whose positions the model masks,
//   grad_rows_s[r, :] = sum over positions k with index_s[k] == r of
//                       g[slot0 + s, k, :]
// and grad_rows_s[P_s - 1, :] = 0. g (out_slots, n, dim) in the rows'
// dtype, summed in f32 and rounded once to the rows' dtype. The host's CSR
// (ops.raw_csr) lists each row's positions in stream order (order_s,
// offsets_s; the pad row's span empty) and the chunks of the long rows
// (long_chunks_s); the kernel never reads the index.
//
// Replaces: persia_tpu/parallel/train_step.py:88-91, the raw branch of
// _embedding_model_inputs: XLA's gather `diff[index]` and its autodiff
// scatter-add onto the distinct rows, which sums in the wire dtype; there
// is no Pallas kernel for it.
//
// Bound on the H100: bytes. At DIN's Taobao shape (B=1024, L=50, dim 16,
// two slots) the forward reads each slot's index (0.2 MB) and writes 1.6 MB
// of bf16 rows (3.3 MB f32); the backward reads the live positions'
// gradient rows and the CSR and writes the distinct rows. No arithmetic to
// speak of.
//
// Design: the forward is one launch for the group, one thread per (slot on
// grid y, position, 16-byte unit of the row), the units fastest: a lane
// group copies one row with 16-byte loads and the warp's stores are one
// contiguous span. A row whose bytes are no multiple of 16, or unaligned,
// is copied element by element.
// The backward is one launch, the slot on grid y, with two kinds of block:
// - short blocks: a lane group (a row's 16-byte units, 4 lanes for f32 dim
//   16, 2 for bf16) takes one row, reads its two offsets, loads the order
//   entries and then the gradient rows of up to kAhead positions at once,
//   and adds them in f32 in stream order from 0 (the bits of a sequential
//   index_add_), rounds once and stores; an empty row stores zeros. Three
//   dependent round trips for a row of up to kAhead positions, no scan, no
//   partials, no second pass. DIN's rows hold 1 to ~11 positions, most 1-3;
// - long blocks: a row of kLongMin positions or more is left to them. The
//   host lists its chunks of kChunk positions; a block stages one chunk's
//   gradient rows in shared memory (all its threads' loads in flight at
//   once) and sums them in stream order, writes the chunk's f32 sum to
//   scratch and takes a ticket (an integer atomic after a __threadfence):
//   the row's last block to finish sums the chunk sums in chunk order from
//   0 and rounds once. The order is fixed whichever block comes last, and a
//   row of n positions is a chain of kChunk + n / kChunk adds, not n.
// No float atomics and one write per row, so two runs give the same bits;
// the order is ops/plans.py::raw_bwd_model's. Geometry comes from
// ops/plans.py (raw_gather_plan, raw_gather_bwd_plan) and is checked here.

#include <cassert>

#include "slot_params.cuh"

// outside the anonymous namespace: the C entry point takes it
struct RawBwdSlots {
  void* rows[kMaxSlots];  // (P, dim) T: the output
  const int32_t* order[kMaxSlots];  // (B * L,) positions sorted by row, ascending within a row
  const int32_t* offsets[kMaxSlots];  // (P + 1,): row r's span in order
  const int32_t* long_chunks[kMaxSlots];  // (long_count, 2): a long row's (row, chunk), rows ascending
  int num_rows[kMaxSlots];  // P
  int long_count[kMaxSlots];
};

namespace {

constexpr int kLongMin = 32;  // plans.K7_LONG_MIN: positions from which a row is long
constexpr int kChunk = 256;  // plans.K7_CHUNK: positions of one chunk of a long row
constexpr int kBwdThreads = 256;  // plans.K7_THREADS
constexpr int kStageFloats = 4096;  // plans.K7_STAGE_FLOATS: f32 a long block stages at a time
// positions whose gradient rows a short row's lane group loads at once: 4
// keeps the f32 kernel at 40 registers, 6 blocks of 256 threads an SM, so
// DIN's 768 short blocks run in one wave (8 took 64 registers: 0.0052 ms
// warm and 0.0088 cold on an H100, against 0.0046 and 0.0076)
constexpr int kAhead = 4;

// Stops the kernel where a row index lies outside [0, rows): a device-side
// assert, as PyTorch's index_select raises on the card (the launch's
// stream reports cudaErrorAssert). The host range-checks every staged
// index, so the main path never takes it.
__device__ __forceinline__ void check_row(int r, int rows) {
  if (static_cast<unsigned>(r) >= static_cast<unsigned>(rows)) {
    assert(!"row index outside the slot's rows");
    __trap();  // also where NDEBUG takes the assert out
  }
}

// The same for the backward's CSR: an order entry outside the slot's
// positions, offsets out of order or past them, a long chunk that is not
// one of its row's
__device__ __forceinline__ void check_csr(bool ok) {
  if (!ok) {
    assert(!"CSR entry outside the slot's positions");
    __trap();
  }
}

template <typename U>
__global__ void __launch_bounds__(kMaxThreads)
raw_gather_fwd_kernel(const __grid_constant__ PoolSlotsParams p, U* __restrict__ out, int positions,
                      int row_units, int slot0) {
  const int s = blockIdx.y;
  const long long t = 1LL * blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 1LL * positions * row_units) return;
  const int k = static_cast<int>(t / row_units);
  const int u = static_cast<int>(t - 1LL * k * row_units);
  const int r = __ldg(p.index[s] + k);
  check_row(r, p.num_rows[s]);
  out[(1LL * (slot0 + s) * positions + k) * row_units + u] =
      __ldg(static_cast<const U*>(p.rows[s]) + 1LL * r * row_units + u);
}

// VEC f32 in shared memory (16-byte aligned where VEC is a multiple of 4)
template <int VEC>
__device__ __forceinline__ void smem_store(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      reinterpret_cast<float4*>(p)[j / 4] = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = v[j];
  }
}
template <int VEC>
__device__ __forceinline__ void smem_load(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 q = reinterpret_cast<const float4*>(p)[j / 4];
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = p[j];
  }
}
// VEC f32 that another block wrote, read from L2 (not this SM's L1)
template <int VEC>
__device__ __forceinline__ void load_cg(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p) + j / 4);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = __ldcg(p + j);
  }
}

// One short row: a lane group of 2^lanes_log2 lanes, VEC columns a lane,
// col_tiles times; the row's positions in stream order, kAhead gradient
// rows in flight
template <typename T, int VEC>
__device__ __forceinline__ void sum_short_row(const T* __restrict__ g, const int32_t* __restrict__ order,
                                              T* __restrict__ out, int start, int end, int positions, int dim,
                                              int lanes_log2, int col_tiles) {
  using U = typename RowUnit<T, VEC>::type;
  const int v = threadIdx.x & ((1 << lanes_log2) - 1);
  for (int tile = 0; tile < col_tiles; ++tile) {
    const int c = ((tile << lanes_log2) + v) * VEC;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int k = start; k < end; k += kAhead) {
      int pos[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) pos[i] = k + i < end ? __ldg(order + k + i) : 0;
      U x[kAhead];
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        if (k + i < end) {
          check_csr(static_cast<unsigned>(pos[i]) < static_cast<unsigned>(positions));
          x[i] = __ldg(reinterpret_cast<const U*>(g + 1LL * pos[i] * dim + c));
        }
      }
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        if (k + i < end) {
          float y[VEC];
          widen(x[i], y);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] = __fadd_rn(acc[j], y[j]);
        }
      }
    }
    store_as(out + c, acc);
  }
}

// One listed chunk of a long row (see the head of the file): a block of
// kBwdThreads threads, thread u < dim / VEC owning VEC columns in the sums;
// tile_rows rows of dim f32 staged at a time
template <typename T, int VEC>
__device__ __forceinline__ void sum_long_chunk(const RawBwdSlots& p, const T* __restrict__ g, int s, int j,
                                               unsigned* __restrict__ tickets, float* __restrict__ sums,
                                               int positions, int dim, int tile_rows) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);  // tile_rows x dim
  int* pos_sh = reinterpret_cast<int*>(stage + tile_rows * dim);  // kChunk
  int* last_sh = pos_sh + kChunk;
  const int t = threadIdx.x;
  const int units = dim / VEC;
  const int32_t* item = p.long_chunks[s] + 2 * j;
  const int r = __ldg(item), c = __ldg(item + 1);
  check_csr(r >= 0 && r < p.num_rows[s] - 1);
  const int start = __ldg(p.offsets[s] + r), end = __ldg(p.offsets[s] + r + 1);
  const int chunks = (end - start + kChunk - 1) / kChunk;
  const int first = j - c;  // the row's first listed chunk
  check_csr(start >= 0 && start <= end && end <= positions && end - start >= kLongMin && c >= 0 &&
            c < chunks && first >= 0 && first + chunks <= p.long_count[s]);
  const int k0 = start + c * kChunk;
  const int n = min(kChunk, end - k0);
  for (int i = t; i < n; i += blockDim.x) {
    const int pos = __ldg(p.order[s] + k0 + i);
    check_csr(static_cast<unsigned>(pos) < static_cast<unsigned>(positions));
    pos_sh[i] = pos;
  }
  __syncthreads();
  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
  for (int i0 = 0; i0 < n; i0 += tile_rows) {
    const int rows = min(tile_rows, n - i0);
    for (int e = t; e < rows * units; e += blockDim.x) {
      const int i = e / units, u = e - i * units;
      float x[VEC];
      load_f32(g + 1LL * pos_sh[i0 + i] * dim + u * VEC, x);
      smem_store(stage + i * dim + u * VEC, x);
    }
    __syncthreads();
    if (t < units) {
      for (int i = 0; i < rows; ++i) {
        float x[VEC];
        smem_load(stage + i * dim + t * VEC, x);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], x[q]);
      }
    }
    __syncthreads();
  }
  if (t < units) store_as(sums + 1LL * j * dim + t * VEC, acc);  // f32
  __threadfence();  // the chunk's sum, before the ticket
  __syncthreads();
  if (t == 0) *last_sh = atomicAdd(tickets + first, 1u) == static_cast<unsigned>(chunks - 1);
  __syncthreads();
  if (!*last_sh) return;
  __threadfence();
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
  for (int i0 = 0; i0 < chunks; i0 += tile_rows) {
    const int rows = min(tile_rows, chunks - i0);
    for (int e = t; e < rows * units; e += blockDim.x) {
      const int i = e / units, u = e - i * units;
      float x[VEC];
      load_cg(sums + 1LL * (first + i0 + i) * dim + u * VEC, x);
      smem_store(stage + i * dim + u * VEC, x);
    }
    __syncthreads();
    if (t < units) {
      for (int i = 0; i < rows; ++i) {
        float x[VEC];
        smem_load(stage + i * dim + t * VEC, x);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], x[q]);
      }
    }
    __syncthreads();
  }
  if (t < units) store_as(static_cast<T*>(p.rows[s]) + 1LL * r * dim + t * VEC, acc);
}

// Blocks [0, short_blocks) of grid x take rows (a lane group each, the
// rows of a block consecutive); blocks from short_blocks take listed
// chunks, the slot's own up to its long_count. tickets (nslots,
// long_blocks) u32 and sums (nslots, long_blocks, dim) f32 are null
// without long rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
raw_gather_bwd_kernel(const __grid_constant__ RawBwdSlots p, const T* __restrict__ grad,
                      unsigned* __restrict__ tickets, float* __restrict__ sums, int positions, int dim,
                      int slot0, int lanes_log2, int col_tiles, int short_blocks, int long_blocks,
                      int tile_rows) {
  const int s = blockIdx.y;
  const T* g = grad + 1LL * (slot0 + s) * positions * dim;
  if (static_cast<int>(blockIdx.x) >= short_blocks) {
    const int j = blockIdx.x - short_blocks;
    if (j < p.long_count[s]) {
      sum_long_chunk<T, VEC>(p, g, s, j, tickets + 1LL * s * long_blocks, sums + 1LL * s * long_blocks * dim,
                             positions, dim, tile_rows);
    }
    return;
  }
  const int P = p.num_rows[s];
  const int r = blockIdx.x * (blockDim.x >> lanes_log2) + (threadIdx.x >> lanes_log2);
  if (r >= P) return;
  int start = 0, end = 0;  // the pad row P - 1: empty, written 0
  if (r < P - 1) {
    start = __ldg(p.offsets[s] + r);
    end = __ldg(p.offsets[s] + r + 1);
    check_csr(start >= 0 && start <= end && end <= positions);
  }
  if (end - start >= kLongMin) return;  // the row's long blocks write it
  sum_short_row<T, VEC>(g, p.order[s], static_cast<T*>(p.rows[s]) + 1LL * r * dim, start, end, positions, dim,
                        lanes_log2, col_tiles);
}

}  // namespace

// Forward: each slot's index is n = positions int32 (ids_per_sample 1 in
// the params); elem_bytes 2 or 4; unit_bytes 16 (the row's bytes a multiple
// of 16, every rows pointer and out 16-byte aligned) or elem_bytes. Grid
// (grid_x, nslots) of threads threads, one per (position, unit). Returns a
// CUDA error code.
extern "C" int persia_raw_gather_fwd(const PoolSlotsParams* p, void* out, int elem_bytes, int nslots,
                                     int positions, int dim, int out_slots, int slot0, int unit_bytes,
                                     int threads, int grid_x, void* stream) {
  int rc = check_group(p, nslots, positions, dim, out_slots, slot0, false);
  if (rc != cudaSuccess) return rc;
  if ((elem_bytes != 2 && elem_bytes != 4) || (unit_bytes != 16 && unit_bytes != elem_bytes) ||
      out == nullptr) {
    return cudaErrorInvalidValue;
  }
  const long long row_bytes = 1LL * dim * elem_bytes;
  if (row_bytes % unit_bytes != 0) return cudaErrorInvalidValue;
  if (unit_bytes == 16) {
    if (!aligned(out, 16)) return cudaErrorInvalidValue;
    for (int s = 0; s < nslots; ++s) {
      if (!aligned(p->rows[s], 16)) return cudaErrorInvalidValue;
    }
  }
  const int row_units = static_cast<int>(row_bytes / unit_bytes);
  const long long items = 1LL * positions * row_units;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 || 1LL * grid_x * threads < items ||
      1LL * (grid_x - 1) * threads >= items) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(grid_x, nslots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (unit_bytes == 16) {
    raw_gather_fwd_kernel<uint4><<<grid, threads, 0, st>>>(*p, static_cast<uint4*>(out), positions, row_units,
                                                           slot0);
  } else if (unit_bytes == 4) {
    raw_gather_fwd_kernel<unsigned><<<grid, threads, 0, st>>>(*p, static_cast<unsigned*>(out), positions,
                                                              row_units, slot0);
  } else {
    raw_gather_fwd_kernel<unsigned short><<<grid, threads, 0, st>>>(*p, static_cast<unsigned short*>(out),
                                                                    positions, row_units, slot0);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: grad is (out_slots, positions, dim) in the rows' dtype, each
// slot's CSR over its positions but the pad row's. vec = 16 / elem_bytes
// (16-byte access: dim a multiple of vec, grad and every rows pointer
// 16-byte aligned) or 1, dim / vec <= threads; lanes (a power of 2
// dividing dim / vec, at most 32) a row's lane group; threads = kBwdThreads; short_blocks the fewest
// blocks of threads / lanes rows over the most rows a slot has;
// long_blocks the most chunks a slot lists. With long rows, scratch is
// zeroed int32: nslots * long_blocks ticket counters (padded to 16 bytes),
// then nslots * long_blocks * dim f32 chunk sums; smem = (tile_rows * dim
// + kChunk) * 4 + 16 bytes, tile_rows = min(kChunk, kStageFloats / dim);
// without, scratch may be null and smem is 0. Returns a CUDA error code.
extern "C" int persia_raw_gather_bwd(const RawBwdSlots* p, const void* grad, void* scratch, int dtype, int nslots,
                                     int positions, int dim, int out_slots, int slot0, int vec, int lanes,
                                     int threads, int short_blocks, int long_blocks, int tile_rows, int smem,
                                     void* stream) {
  if (p == nullptr || grad == nullptr || nslots < 1 || nslots > kMaxSlots || positions < 1 || dim < 1 ||
      slot0 < 0 || slot0 + nslots > out_slots || !fits_int(1LL * positions * out_slots * dim) ||
      (dtype != persia::kFloat32 && dtype != persia::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  const int wide = dtype == persia::kFloat32 ? 4 : 8;
  if ((vec != 1 && vec != wide) || dim % vec != 0) return cudaErrorInvalidValue;
  if (vec > 1 && !aligned(grad, 16)) return cudaErrorInvalidValue;
  int max_rows = 0, max_long = 0;
  for (int s = 0; s < nslots; ++s) {
    if (p->rows[s] == nullptr || p->order[s] == nullptr || p->offsets[s] == nullptr || p->num_rows[s] < 1 ||
        !fits_int(1LL * p->num_rows[s] * dim) || p->long_count[s] < 0 ||
        (p->long_count[s] > 0 && p->long_chunks[s] == nullptr) || (vec > 1 && !aligned(p->rows[s], 16))) {
      return cudaErrorInvalidValue;
    }
    max_rows = max_rows > p->num_rows[s] ? max_rows : p->num_rows[s];
    max_long = max_long > p->long_count[s] ? max_long : p->long_count[s];
  }
  const int units = dim / vec;
  const int lanes_log2 = log2_exact(lanes);
  if (lanes_log2 < 0 || lanes > 32 || units % lanes != 0 || threads != kBwdThreads || units > threads) {
    return cudaErrorInvalidValue;
  }
  const int rows_per_block = threads / lanes;
  if (1LL * short_blocks * rows_per_block < max_rows || 1LL * (short_blocks - 1) * rows_per_block >= max_rows ||
      long_blocks != max_long || !fits_int(1LL * short_blocks + long_blocks)) {
    return cudaErrorInvalidValue;
  }
  unsigned* tickets = nullptr;
  float* sums = nullptr;
  if (long_blocks > 0) {
    const int want_tile = kStageFloats / dim < kChunk ? kStageFloats / dim : kChunk;
    if (tile_rows != want_tile || tile_rows < 1 ||
        smem != (tile_rows * dim + kChunk) * 4 + 16 || scratch == nullptr || !aligned(scratch, 16) ||
        !fits_int(1LL * nslots * long_blocks * (dim + 1) + 4)) {
      return cudaErrorInvalidValue;
    }
    tickets = static_cast<unsigned*>(scratch);
    sums = reinterpret_cast<float*>(tickets + (1LL * nslots * long_blocks + 3) / 4 * 4);
  } else if (smem != 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(short_blocks + long_blocks, nslots);
  const int col_tiles = units / lanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == persia::kFloat32) {
    const float* g = static_cast<const float*>(grad);
    if (vec == 4) {
      raw_gather_bwd_kernel<float, 4><<<grid, threads, smem, st>>>(*p, g, tickets, sums, positions, dim, slot0,
                                                                   lanes_log2, col_tiles, short_blocks,
                                                                   long_blocks, tile_rows);
    } else {
      raw_gather_bwd_kernel<float, 1><<<grid, threads, smem, st>>>(*p, g, tickets, sums, positions, dim, slot0,
                                                                   lanes_log2, col_tiles, short_blocks,
                                                                   long_blocks, tile_rows);
    }
  } else {
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(grad);
    if (vec == 8) {
      raw_gather_bwd_kernel<__nv_bfloat16, 8><<<grid, threads, smem, st>>>(*p, g, tickets, sums, positions, dim,
                                                                           slot0, lanes_log2, col_tiles,
                                                                           short_blocks, long_blocks, tile_rows);
    } else {
      raw_gather_bwd_kernel<__nv_bfloat16, 1><<<grid, threads, smem, st>>>(*p, g, tickets, sums, positions, dim,
                                                                           slot0, lanes_log2, col_tiles,
                                                                           short_blocks, long_blocks, tile_rows);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
