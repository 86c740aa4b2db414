// Calendar transport kernels for Hopper (sm_90a): the port of the two
// Pallas kernels in testground_tpu/sim/pallas_transport.py.
//
// K1 calendar commit, commit_k  (replaces pallas_transport.py:_commit_call,
//    called by commit_calendar). Commits one tick's message stream, sorted
//    by key = bucket*N + dst (dead keys < 0 or >= L*N), into the
//    [L, N*SLOTS] calendar planes at position slot*N + dst of row `bucket`.
//    A message's slot is its rank inside its run of equal keys plus the
//    bucket's PRE-tick fill for dst (the nonzero occupancy words over the
//    SLOTS slots; 0 without stacking); slot >= SLOTS drops it.
//
//    Bound: memory. Per message it reads its key and writes its survival
//    word; per run leader, SLOTS occupancy words (stacking only); per
//    message that can survive, its stream words (occupancy mark, W
//    payload); per survivor, 1 + W (+1 etick) plane words at scattered
//    positions. At the main path's sizes the chain of dependent loads sets
//    the time, so the design keeps it to two: the key tile, then the fill
//    and the stream words together. No search, no scan, no scratch, one
//    launch.
//
//    Design: the run structure comes from neighbours alone. Each block
//    stages its tile of kCommitTile keys (16-byte cp.async) plus a halo of
//    SLOTS keys on each side into shared memory. In a sorted stream the
//    rank of message j is >= SLOTS iff sk[j-SLOTS] == sk[j]; such a
//    message can never survive (the fill is >= 0) and writes survived = 0
//    itself, as a dead key does. Any other live message walks back at most
//    SLOTS-1 keys in shared memory to its run's leader (sk[j-1] != sk[j]).
//    The leader reads the (bucket, dst) fill once into shared memory; after
//    one block barrier each run-mate in the tile commits itself at
//    slot = fill + rank (planes and survived = 1, or survived = 0 when
//    slot >= SLOTS). A run-mate past the tile's end (at most SLOTS-1 of
//    them per tile) belongs to its leader, which commits it after its own
//    message. Every survival word is written exactly once, and heavy
//    fan-in costs a few shared-memory compares per message.
//
//    Why one launch cannot race: the fill of (bucket, dst) is read only by
//    its run's leader, and only that leader's block writes any slot of
//    (bucket, dst): its run-mates in the tile after the block barrier, the
//    ones past the tile by the leader itself after its read. So every fill
//    read precedes every write of those cells, with no ordering across
//    blocks; runs of other keys write disjoint (bucket, dst) columns. The
//    TPU gets the same order from its serial walk ("fill reads stay
//    PRE-update").
//
// K1 sharded, the same commit_k  (replaces
//    pallas_transport.py:_commit_calendar_sharded). On a mesh of S peer
//    shards each shard s holds lanes [s*n_loc, (s+1)*n_loc) in its own
//    [L, SLOTS*n_loc] plane, and a device holds its shards [s0, s1) as one
//    [S_d, L, SLOTS*n_loc] tensor, i.e. a [S_d*L, SLOTS*n_loc] plane. The
//    stream is sorted by the SHARD-major key s*L*n_loc + bucket*n_loc +
//    local dst, so (key - s0*L*n_loc) is exactly the unsharded key of that
//    plane with "bucket" (s - s0)*L + bucket and N = n_loc: one launch per
//    device commits all of its shards, with the key window [key_lo,
//    key_hi) = [s0*L*n_loc, s1*L*n_loc) in place of [0, L*N). Equal-key
//    runs never cross a shard, so the rank walk and the fill are as above.
//    The stream is sorted, so a tile's first and last keys tell whether it
//    meets the window at all: a tile that does not exits right after
//    staging its keys (no search, no host read). Survival is written only
//    inside the window, unless the launch owns the whole stream (own_all:
//    one device holds every shard, or the unsharded call), which writes
//    every word; a device that holds some shards gets a zeroed mask, and
//    the wrapper sums the devices' masks.
//
// K2 delivery pop, pop_vec_k / pop_scalar_k  (replaces
//    pallas_transport.py:_pop_call, called by pop_bucket). Copies row
//    b = t mod L of the occupancy plane and the W payload planes out as
//    [N*SLOTS] rows and zeroes the occupancy row, in one pass. b is
//    computed on the device, once per block (one thread reads t, a 32-bit
//    floor modulo, broadcast through shared memory): the host never reads
//    the tick.
//
//    Bound: memory (reads (occ + 4W) bytes per cell, writes them once plus
//    the cleared occupancy word). Design: the rows of all planes form one
//    list of 16-byte vectors (16 cells of a bool row, 4 of an int32 row);
//    a grid of at most 4 blocks per SM walks it with each thread issuing
//    all of its kPopUnroll loads before any store, so the first wave keeps
//    the whole row in flight. Rows whose length or alignment break 16-byte
//    vectors take the scalar kernel.
//
// K2 sharded, pop_shard_vec_k / pop_shard_scalar_k  (replaces
//    pallas_transport.py:_pop_bucket_sharded). One launch per device pops
//    row b = t mod L of each of its shards' [L, SLOTS*n_loc] planes and
//    writes cell (slot, l) of shard s straight to slot*out_stride +
//    out_col0 + (s - s0)*n_loc + l of the output row: the global
//    slot-major [SLOTS*N] row (out_stride = N, out_col0 = s0*n_loc), or a
//    device-local [SLOTS, S_d*n_loc] row that the wrapper copies home. The
//    occupancy row is cleared in the same pass.
//
//    Bound: memory, as K2 (the same bytes: every popped row read once and
//    written once, the occupancy row cleared).
//
//    Design: a batch of equal segment copies. For one shard and slot, a
//    plane's popped cells are one run of n_loc cells at the source and one
//    at the destination, so the pop is S_d*SLOTS segments of every plane.
//    The wrapper computes their geometry (the length and the strides
//    between segments at both ends: cuda_transport.pop_segments). The
//    grid is 3-D, chunks of a segment x SLOTS x S_d, so a block reads its
//    segment off blockIdx with no division (SLOTS past the grid's 65,535
//    folds into x, with one division a block): a flattened segment index,
//    split by divisions in every block, measured slower at every shape.
//    Every thread reads t itself (one transaction a warp, no barrier).
//    A block moves one chunk of every plane as K2 moves a row: the
//    chunk's 16-byte vectors of all planes form one list, each thread
//    issues its kPopUnroll loads (__ldg on the payload) before any store,
//    and occupancy items are zeroed as they are read. A chunk holds 2^k
//    payload vectors a plane, k the largest that keeps the list within
//    one pass of the block, so the list splits by shifts. Bool occupancy
//    moves 16, 8 or 4 cells an item, the most that every segment base
//    allows (n_loc % 16, % 8, % 4 == 0: at N=100k on 4 shards, 8). Where
//    n_loc % 4 != 0 the scalar kernel walks the same grid, each thread
//    loading its cell of every plane before it stores. What stays slower
//    than K2 at the same bytes: an [S_d*L]-row plane holds one popped
//    row in S_d places, and a segment shorter than a chunk leaves most of
//    its block idle (one block a segment at the least).
//
// Plain C interface (loaded with ctypes): every entry point enqueues on
// the caller's stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported at the call.

#include <cstdint>
#include <cuda_runtime.h>

#define TG_MAX_WIDTH 8

struct Planes {
  int32_t* p[TG_MAX_WIDTH];
};

struct ConstPlanes {
  const int32_t* p[TG_MAX_WIDTH];
};

// ------------------------------------------------------------------ K1

static constexpr int kCommitTile = 256;  // messages per block, one a thread
static constexpr int kMaxHalo = 1024;    // keys staged on each side of a tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// one message's stream words, read before its slot is known
struct Msg {
  int32_t occ;
  int32_t pay[TG_MAX_WIDTH];
};

__device__ __forceinline__ Msg load_msg(int j, int width,
                                        const int32_t* __restrict__ occ_vals,
                                        const ConstPlanes& pay_in) {
  Msg m;
  m.occ = occ_vals[j];
#pragma unroll
  for (int w = 0; w < TG_MAX_WIDTH; ++w) {
    if (w < width) m.pay[w] = pay_in.p[w][j];
  }
  return m;
}

// writes message j at `slot` of its (bucket, dst) cell, or drops it
__device__ __forceinline__ void commit_msg(
    int j, const Msg& m, int slot, int slots, size_t cell, int n, int width,
    void* occ, int occ_bool, const Planes& planes, int32_t* etick, int32_t t,
    int32_t* __restrict__ surv) {
  if (slot >= slots) {
    surv[j] = 0;
    return;
  }
  const size_t pos = cell + (size_t)slot * (size_t)n;
  if (occ_bool) {
    ((uint8_t*)occ)[pos] = m.occ != 0;
  } else {
    ((int32_t*)occ)[pos] = m.occ;
  }
#pragma unroll
  for (int w = 0; w < TG_MAX_WIDTH; ++w) {
    if (w < width) planes.p[w][pos] = m.pay[w];
  }
  if (etick != nullptr) etick[pos] = t;
  surv[j] = 1;
}

__global__ void __launch_bounds__(kCommitTile)
    commit_k(const int32_t* __restrict__ sk,
             const int32_t* __restrict__ occ_vals,
             const __grid_constant__ ConstPlanes pay_in, int width, void* occ,
             int occ_bool, const __grid_constant__ Planes planes,
             int32_t* __restrict__ etick, const int32_t* __restrict__ t_dev,
             int32_t* __restrict__ surv, int m2, int n, int slots,
             int key_lo, int key_hi, int own_all, int stacking, int halo,
             int vec) {
  // shared keys: [pad | left halo | tile | right halo], the tile 16-byte
  // aligned at `hl`; positions outside [0, m2) hold -1, a dead key
  extern __shared__ int4 smem_raw[];
  int32_t* s_key = (int32_t*)smem_raw;
  __shared__ int32_t s_fill[kCommitTile];  // pre-tick fill, at run leaders
  __shared__ int32_t s_t;
  const int hl = (halo + 3) & ~3;
  const int tile0 = blockIdx.x * kCommitTile;
  const int tid = threadIdx.x;
  const int body = min(kCommitTile, m2 - tile0);
  if (vec && body == kCommitTile) {
    if (tid < kCommitTile / 4) {
      cp_async16(s_key + hl + 4 * tid, sk + tile0 + 4 * tid);
    }
  } else {
    s_key[hl + tid] = tid < body ? sk[tile0 + tid] : -1;
  }
  for (int i = tid; i < halo; i += kCommitTile) {
    const int left = tile0 - halo + i;
    const int right = tile0 + kCommitTile + i;
    s_key[hl - halo + i] = left >= 0 ? sk[left] : -1;
    s_key[hl + kCommitTile + i] = right < m2 ? sk[right] : -1;
  }
  if (tid == 0) s_t = etick != nullptr ? *t_dev : 0;
  cp_async_wait_all();
  __syncthreads();
  // a sorted tile wholly outside the key window has nothing to commit
  if (s_key[hl] >= key_hi || s_key[hl + body - 1] < key_lo) {
    if (own_all && tid < body) surv[tile0 + tid] = 0;
    return;
  }

  // key of any stream position: shared memory inside the staged window,
  // device memory beyond it (only when SLOTS > kMaxHalo)
  const int lo = tile0 - halo;
  const int hi = tile0 + kCommitTile + halo;
  auto key_at = [&](int i) -> int32_t {
    if (i >= lo && i < hi) return s_key[hl + (i - tile0)];
    return (i < 0 || i >= m2) ? -1 : sk[i];
  };

  const int j = tile0 + tid;
  const int32_t key = s_key[hl + tid];
  const bool live = j < m2 && key >= key_lo && key < key_hi;
  // rank inside the run, capped at SLOTS: in a sorted stream the rank is
  // >= SLOTS iff sk[j-SLOTS] == sk[j]; otherwise walk back to the leader
  int rank = slots;
  if (live && !(j >= slots && key_at(j - slots) == key)) {
    rank = 0;
    while (key_at(j - rank - 1) == key) ++rank;
  }
  // a run-mate whose leader lies in an earlier tile is that leader's
  const bool mine = live && rank < slots && rank <= tid;
  Msg msg;
  if (mine) msg = load_msg(j, width, occ_vals, pay_in);
  const int rk = key - key_lo;  // the key in this plane's own key space
  const int b = rk / n;
  const size_t cell =
      (size_t)b * (size_t)n * (size_t)slots + (size_t)(rk - b * n);
  int fill = 0;
  if (live && rank == 0) {
    if (stacking) {
      if (occ_bool) {
        const uint8_t* o = (const uint8_t*)occ + cell;
#pragma unroll 4
        for (int s = 0; s < slots; ++s) fill += o[(size_t)s * n] != 0;
      } else {
        const int32_t* o = (const int32_t*)occ + cell;
#pragma unroll 4
        for (int s = 0; s < slots; ++s) fill += o[(size_t)s * n] != 0;
      }
    }
    s_fill[tid] = fill;
  }
  // every fill of this tile's runs is read before any plane is written
  __syncthreads();
  if (j >= m2) return;
  if (!live || rank >= slots) {
    if (live || own_all) surv[j] = 0;
    return;
  }
  if (mine) {
    commit_msg(j, msg, s_fill[tid - rank] + rank, slots, cell, n, width, occ,
               occ_bool, planes, etick, s_t, surv);
  }
  // the leader also commits its run-mates past the tile's end
  if (rank == 0) {
    for (int r = kCommitTile - tid; r < slots && key_at(j + r) == key; ++r) {
      commit_msg(j + r, load_msg(j + r, width, occ_vals, pay_in), fill + r,
                 slots, cell, n, width, occ, occ_bool, planes, etick, s_t,
                 surv);
    }
  }
}

static int launch_commit(const void* sk, const void* occ_vals,
                         const void* pay_sorted_ptrs, int width, void* occ,
                         int occ_bool, const void* plane_ptrs, void* etick,
                         const void* t_dev, void* surv, int m2, int n,
                         int slots, int stacking, int key_lo, int key_hi,
                         int own_all, void* stream) {
  if (width < 0 || width > TG_MAX_WIDTH || slots < 1 || m2 < 1 || n < 1 ||
      key_lo < 0 || key_hi < key_lo) {
    return (int)cudaErrorInvalidValue;
  }
  ConstPlanes pay_in;
  Planes planes;
  const void* const* ps = (const void* const*)pay_sorted_ptrs;
  const void* const* pp = (const void* const*)plane_ptrs;
  for (int w = 0; w < TG_MAX_WIDTH; ++w) {
    pay_in.p[w] = w < width ? (const int32_t*)ps[w] : nullptr;
    planes.p[w] = w < width ? (int32_t*)pp[w] : nullptr;
  }
  const int halo = slots < kMaxHalo ? slots : kMaxHalo;
  const int hl = (halo + 3) & ~3;
  const size_t smem = (size_t)(hl + kCommitTile + halo) * sizeof(int32_t);
  const int blocks = (m2 + kCommitTile - 1) / kCommitTile;
  const int vec = ((uintptr_t)sk & 15) == 0;
  commit_k<<<blocks, kCommitTile, smem, (cudaStream_t)stream>>>(
      (const int32_t*)sk, (const int32_t*)occ_vals, pay_in, width, occ,
      occ_bool, planes, (int32_t*)etick, (const int32_t*)t_dev,
      (int32_t*)surv, m2, n, slots, key_lo, key_hi, own_all, stacking, halo,
      vec);
  return (int)cudaGetLastError();
}

extern "C" int tg_commit_calendar(const void* sk, const void* occ_vals,
                                  const void* pay_sorted_ptrs, int width,
                                  void* occ, int occ_bool,
                                  const void* plane_ptrs, void* etick,
                                  const void* t_dev, void* surv, int m2,
                                  int horizon, int n, int slots, int stacking,
                                  void* stream) {
  return launch_commit(sk, occ_vals, pay_sorted_ptrs, width, occ, occ_bool,
                       plane_ptrs, etick, t_dev, surv, m2, n, slots, stacking,
                       0, horizon * n, 1, stream);
}

// rows = S_d*L bucket rows of the device's [S_d*L, SLOTS*n_loc] plane;
// key_lo = s0*L*n_loc
extern "C" int tg_commit_calendar_sharded(
    const void* sk, const void* occ_vals, const void* pay_sorted_ptrs,
    int width, void* occ, int occ_bool, const void* plane_ptrs, void* etick,
    const void* t_dev, void* surv, int m2, int rows, int n_loc, int slots,
    int stacking, int key_lo, int own_all, void* stream) {
  if ((long long)key_lo + (long long)rows * n_loc >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_commit(sk, occ_vals, pay_sorted_ptrs, width, occ, occ_bool,
                       plane_ptrs, etick, t_dev, surv, m2, n_loc, slots,
                       stacking, key_lo, key_lo + rows * n_loc, own_all,
                       stream);
}

// ------------------------------------------------------------------ K2

static constexpr int kPopThreads = 256;
static constexpr int kPopUnroll = 2;      // 16-byte vectors in flight a thread
static constexpr int kPopBlocksPerSm = 4;

struct PopVecArgs {
  int4* occ;                             // occupancy plane, read and cleared
  const int4* pay[TG_MAX_WIDTH];         // payload planes
  int4* row_occ;                         // popped rows
  int4* row_pay[TG_MAX_WIDTH];
};

__device__ __forceinline__ int bucket_row(const int32_t* t_dev, int horizon) {
  __shared__ int s_b;
  if (threadIdx.x == 0) {
    const int r = *t_dev % horizon;
    s_b = r < 0 ? r + horizon : r;
  }
  __syncthreads();
  return s_b;
}

__global__ void __launch_bounds__(kPopThreads)
    pop_vec_k(const __grid_constant__ PopVecArgs a,
              const int32_t* __restrict__ t_dev, int horizon,
              unsigned nv_occ, unsigned nv_pay, unsigned total) {
  const size_t b = (size_t)bucket_row(t_dev, horizon);
  int4* occ = a.occ + b * nv_occ;
  const size_t pay_row = b * nv_pay;
  const unsigned step = gridDim.x * kPopThreads * kPopUnroll;
  for (unsigned base = blockIdx.x * kPopThreads * kPopUnroll + threadIdx.x;
       base < total; base += step) {
    int4 v[kPopUnroll];
    int plane[kPopUnroll];
    unsigned off[kPopUnroll];
#pragma unroll
    for (int k = 0; k < kPopUnroll; ++k) {
      const unsigned i = base + k * kPopThreads;
      plane[k] = -1;
      if (i >= total) continue;
      if (i < nv_occ) {
        plane[k] = 0;
        off[k] = i;
        v[k] = occ[i];
      } else {
        const unsigned q = i - nv_occ;
        const unsigned w = q / nv_pay;
        plane[k] = 1 + (int)w;
        off[k] = q - w * nv_pay;
        v[k] = __ldg(a.pay[w] + pay_row + off[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPopUnroll; ++k) {
      if (plane[k] < 0) continue;
      if (plane[k] == 0) {
        a.row_occ[off[k]] = v[k];
        occ[off[k]] = make_int4(0, 0, 0, 0);
      } else {
        a.row_pay[plane[k] - 1][off[k]] = v[k];
      }
    }
  }
}

__global__ void __launch_bounds__(kPopThreads)
    pop_scalar_k(void* occ_plane, int occ_bool,
                 const __grid_constant__ ConstPlanes pay, int width,
                 const int32_t* __restrict__ t_dev, int horizon, unsigned ns,
                 void* row_occ, const __grid_constant__ Planes row_pay) {
  const size_t base = (size_t)bucket_row(t_dev, horizon) * ns;
  for (unsigned c = blockIdx.x * kPopThreads + threadIdx.x; c < ns;
       c += gridDim.x * kPopThreads) {
    if (occ_bool) {
      uint8_t* o = (uint8_t*)occ_plane + base + c;
      ((uint8_t*)row_occ)[c] = *o;
      *o = 0;
    } else {
      int32_t* o = (int32_t*)occ_plane + base + c;
      ((int32_t*)row_occ)[c] = *o;
      *o = 0;
    }
    for (int w = 0; w < width; ++w) row_pay.p[w][c] = pay.p[w][base + c];
  }
}

// an error here is left for the launch's cudaGetLastError() to report
static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms > 0 ? sms : 1;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

extern "C" int tg_pop_bucket(void* occ, int occ_bool, const void* pay_ptrs,
                             int width, const void* t_dev, int horizon,
                             long long ns, void* row_occ,
                             const void* row_pay_ptrs, void* stream) {
  if (width < 0 || width > TG_MAX_WIDTH || horizon < 1 || ns < 1 ||
      (long long)horizon * ns >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* const* pp = (const void* const*)pay_ptrs;
  const void* const* rp = (const void* const*)row_pay_ptrs;
  const int occ_cells = occ_bool ? 16 : 4;  // cells in a 16-byte vector
  const long long vectors = ns / occ_cells + width * (ns / 4);
  bool vec = ns % occ_cells == 0 && ns % 4 == 0 && vectors < (1LL << 31) &&
             aligned16(occ) && aligned16(row_occ);
  for (int w = 0; w < width; ++w) {
    vec = vec && aligned16(pp[w]) && aligned16(rp[w]);
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long cap = (long long)sm_count() * kPopBlocksPerSm;
  if (vec) {
    PopVecArgs a;
    a.occ = (int4*)occ;
    a.row_occ = (int4*)row_occ;
    for (int w = 0; w < TG_MAX_WIDTH; ++w) {
      a.pay[w] = w < width ? (const int4*)pp[w] : nullptr;
      a.row_pay[w] = w < width ? (int4*)rp[w] : nullptr;
    }
    const long long per_block = (long long)kPopThreads * kPopUnroll;
    long long blocks = (vectors + per_block - 1) / per_block;
    if (blocks > cap) blocks = cap;
    pop_vec_k<<<(int)blocks, kPopThreads, 0, s>>>(
        a, (const int32_t*)t_dev, horizon, (unsigned)(ns / occ_cells),
        (unsigned)(ns / 4), (unsigned)vectors);
    return (int)cudaGetLastError();
  }
  ConstPlanes pay;
  Planes rows;
  for (int w = 0; w < TG_MAX_WIDTH; ++w) {
    pay.p[w] = w < width ? (const int32_t*)pp[w] : nullptr;
    rows.p[w] = w < width ? (int32_t*)rp[w] : nullptr;
  }
  long long blocks = (ns + kPopThreads - 1) / kPopThreads;
  if (blocks > cap) blocks = cap;
  pop_scalar_k<<<(int)blocks, kPopThreads, 0, s>>>(
      occ, occ_bool, pay, width, (const int32_t*)t_dev, horizon,
      (unsigned)ns, row_occ, rows);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ K2 sharded

static constexpr int kMaxGrid = 65535;  // gridDim.y and gridDim.z

struct PopSegArgs {
  void* occ;  // the device's [S_d*L, SLOTS*n_loc] plane, read and cleared
  const int32_t* pay[TG_MAX_WIDTH];
  void* row_occ;  // output rows
  int32_t* row_pay[TG_MAX_WIDTH];
  // the segment of shard s and slot `slot` starts at cell
  //   s*src_shard + slot*src_slot + b*src_row   of each plane and at
  //   dst0 + s*dst_shard + slot*dst_slot        of each output row
  long long src_shard, src_slot, src_row, dst_shard, dst_slot, dst0;
  int seg_len, slots;
  int chunks;  // blocks along one segment
  int fold;    // slots a grid row holds: 1 unless SLOTS passes kMaxGrid
};

struct SegChunk {
  size_t src, dst;  // the chunk's first cell in the planes and the rows
  int len;          // its cells
  int slot;         // >= slots in the folded grid's last row: no work
};

// the block's chunk: shard blockIdx.z, slot blockIdx.y, chunk blockIdx.x
// (a division only where SLOTS was folded into x); everything but the
// bucket row, so that it overlaps the read of t
__device__ __forceinline__ SegChunk seg_chunk(const PopSegArgs& a,
                                              int chunk_cells) {
  int slot = blockIdx.y;
  int chunk = blockIdx.x;
  if (a.fold > 1) {
    const int q = blockIdx.x / a.chunks;
    slot = blockIdx.y * a.fold + q;
    chunk = blockIdx.x - q * a.chunks;
  }
  const int c0 = chunk * chunk_cells;
  const size_t s = blockIdx.z;
  return {s * a.src_shard + (size_t)slot * a.src_slot + c0,
          a.dst0 + s * a.dst_shard + (size_t)slot * a.dst_slot + c0,
          min(chunk_cells, a.seg_len - c0), slot};
}

// b = t mod L (floor), read by every thread: one transaction a warp and
// no barrier
__device__ __forceinline__ size_t bucket_of(const int32_t* t_dev,
                                            int horizon) {
  const int r = *t_dev % horizon;
  return (size_t)(r < 0 ? r + horizon : r);
}

// occupancy items: 2^occ_shift cells of cell_bytes each, so 16 bytes for
// int32 (shift 2) and 16, 8 or 4 bytes for bool (shift 4, 3 or 2)
__global__ void __launch_bounds__(kPopThreads)
    pop_shard_vec_k(const __grid_constant__ PopSegArgs a,
                    const int32_t* __restrict__ t_dev, int horizon,
                    int cell_bytes, int occ_shift, int width, int log_p) {
  const int chunk_cells = 4 << log_p;
  SegChunk x = seg_chunk(a, chunk_cells);
  if (x.slot >= a.slots) return;
  const size_t row = bucket_of(t_dev, horizon) * (size_t)a.src_row;
  x.src += row;
  // the list: the chunk's occupancy items, then 2^log_p vectors a plane
  const int occ_items = chunk_cells >> occ_shift;
  const int occ_valid = x.len >> occ_shift;
  const int pay_valid = x.len >> 2;
  const int items = occ_items + (width << log_p);
  const int item_bytes = cell_bytes << occ_shift;
  char* occ = (char*)a.occ + x.src * cell_bytes;
  char* row_occ = (char*)a.row_occ + x.dst * cell_bytes;
  const int mask = (1 << log_p) - 1;
  for (int base = threadIdx.x; base < items;
       base += kPopThreads * kPopUnroll) {
    int4 v[kPopUnroll];
    int plane[kPopUnroll];
    int off[kPopUnroll];
#pragma unroll
    for (int k = 0; k < kPopUnroll; ++k) {
      const int i = base + k * kPopThreads;
      plane[k] = -1;
      if (i < occ_items) {
        if (i < occ_valid) {
          plane[k] = 0;
          off[k] = i * item_bytes;
          if (item_bytes == 16) {
            v[k] = *(const int4*)(occ + off[k]);
          } else if (item_bytes == 8) {
            const int2 w = *(const int2*)(occ + off[k]);
            v[k].x = w.x;
            v[k].y = w.y;
          } else {
            v[k].x = *(const int32_t*)(occ + off[k]);
          }
        }
      } else if (i < items) {
        const int j = i - occ_items;
        if ((j & mask) < pay_valid) {
          plane[k] = 1 + (j >> log_p);
          off[k] = j & mask;
          v[k] = __ldg((const int4*)(a.pay[plane[k] - 1] + x.src) + off[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPopUnroll; ++k) {
      if (plane[k] < 0) continue;
      if (plane[k] > 0) {
        ((int4*)(a.row_pay[plane[k] - 1] + x.dst))[off[k]] = v[k];
      } else if (item_bytes == 16) {
        *(int4*)(row_occ + off[k]) = v[k];
        *(int4*)(occ + off[k]) = make_int4(0, 0, 0, 0);
      } else if (item_bytes == 8) {
        *(int2*)(row_occ + off[k]) = make_int2(v[k].x, v[k].y);
        *(int2*)(occ + off[k]) = make_int2(0, 0);
      } else {
        *(int32_t*)(row_occ + off[k]) = v[k].x;
        *(int32_t*)(occ + off[k]) = 0;
      }
    }
  }
}

__global__ void __launch_bounds__(kPopThreads)
    pop_shard_scalar_k(const __grid_constant__ PopSegArgs a,
                       const int32_t* __restrict__ t_dev, int horizon,
                       int occ_bool, int width) {
  constexpr int kChunk = kPopThreads * kPopUnroll;
  SegChunk x = seg_chunk(a, kChunk);
  if (x.slot >= a.slots) return;
  x.src += bucket_of(t_dev, horizon) * (size_t)a.src_row;
  int32_t v[kPopUnroll][1 + TG_MAX_WIDTH];
#pragma unroll
  for (int k = 0; k < kPopUnroll; ++k) {
    const size_t c = threadIdx.x + k * kPopThreads;
    if (c >= (size_t)x.len) continue;
    v[k][0] = occ_bool ? ((const uint8_t*)a.occ)[x.src + c]
                       : ((const int32_t*)a.occ)[x.src + c];
#pragma unroll
    for (int w = 0; w < TG_MAX_WIDTH; ++w) {
      if (w < width) v[k][1 + w] = __ldg(a.pay[w] + x.src + c);
    }
  }
#pragma unroll
  for (int k = 0; k < kPopUnroll; ++k) {
    const size_t c = threadIdx.x + k * kPopThreads;
    if (c >= (size_t)x.len) continue;
    if (occ_bool) {
      ((uint8_t*)a.row_occ)[x.dst + c] = (uint8_t)v[k][0];
      ((uint8_t*)a.occ)[x.src + c] = 0;
    } else {
      ((int32_t*)a.row_occ)[x.dst + c] = v[k][0];
      ((int32_t*)a.occ)[x.src + c] = 0;
    }
#pragma unroll
    for (int w = 0; w < TG_MAX_WIDTH; ++w) {
      if (w < width) a.row_pay[w][x.dst + c] = v[k][1 + w];
    }
  }
}

static bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// the segments' geometry comes from the wrapper (PopSegments): shards x
// slots segments of seg_len cells, strides in cells
extern "C" int tg_pop_bucket_sharded(
    void* occ, int occ_bool, const void* pay_ptrs, int width,
    const void* t_dev, int horizon, int shards, int slots, int seg_len,
    long long src_shard, long long src_slot, long long src_row,
    long long dst_shard, long long dst_slot, long long dst0, void* row_occ,
    const void* row_pay_ptrs, void* stream) {
  if (width < 0 || width > TG_MAX_WIDTH || horizon < 1 || shards < 1 ||
      shards > kMaxGrid || slots < 1 || seg_len < 1 || src_shard < 0 ||
      src_slot < 0 || src_row < 0 || dst_shard < 0 || dst_slot < 0 ||
      dst0 < 0) {
    return (int)cudaErrorInvalidValue;
  }
  PopSegArgs a;
  a.occ = occ;
  a.row_occ = row_occ;
  a.src_shard = src_shard;
  a.src_slot = src_slot;
  a.src_row = src_row;
  a.dst_shard = dst_shard;
  a.dst_slot = dst_slot;
  a.dst0 = dst0;
  a.seg_len = seg_len;
  a.slots = slots;
  const void* const* pp = (const void* const*)pay_ptrs;
  const void* const* rp = (const void* const*)row_pay_ptrs;
  bool pay16 = true;
  for (int w = 0; w < TG_MAX_WIDTH; ++w) {
    a.pay[w] = w < width ? (const int32_t*)pp[w] : nullptr;
    a.row_pay[w] = w < width ? (int32_t*)rp[w] : nullptr;
    if (w < width) pay16 = pay16 && aligned(pp[w], 16) && aligned(rp[w], 16);
  }
  // every segment base a multiple of `cells` cells
  auto bases_divisible = [&](long long cells) {
    return seg_len % cells == 0 && src_shard % cells == 0 &&
           src_slot % cells == 0 && src_row % cells == 0 &&
           dst_shard % cells == 0 && dst_slot % cells == 0 &&
           dst0 % cells == 0;
  };
  // occupancy items of 2^occ_shift cells: 16 bytes of int32 cells, the
  // widest of 16, 8 or 4 bytes of bool cells that every segment base and
  // both pointers allow; 0 takes the scalar kernel
  const int cell_bytes = occ_bool ? 1 : 4;
  int occ_shift = 0;
  if (pay16 && bases_divisible(4)) {
    for (int sh = occ_bool ? 4 : 2; sh >= 2 && occ_shift == 0; --sh) {
      const int bytes = cell_bytes << sh;
      if (bases_divisible(1 << sh) && aligned(occ, bytes) &&
          aligned(row_occ, bytes)) {
        occ_shift = sh;
      }
    }
  }
  // payload vectors a chunk holds per plane: 2^log_p, the list of all
  // planes' vectors within one pass of the block (log_p >= 5 always is)
  int log_p = 8;
  while (log_p > 5 && ((4 << log_p) >> occ_shift) + (width << log_p) >
                          kPopThreads * kPopUnroll) {
    --log_p;
  }
  const int chunk_cells = occ_shift ? 4 << log_p : kPopThreads * kPopUnroll;
  a.chunks = (seg_len + chunk_cells - 1) / chunk_cells;
  a.fold = (slots + kMaxGrid - 1) / kMaxGrid;
  if ((long long)a.chunks * a.fold >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(a.chunks * a.fold, (slots + a.fold - 1) / a.fold, shards);
  cudaStream_t s = (cudaStream_t)stream;
  if (occ_shift) {
    pop_shard_vec_k<<<grid, kPopThreads, 0, s>>>(
        a, (const int32_t*)t_dev, horizon, cell_bytes, occ_shift, width, log_p);
  } else {
    pop_shard_scalar_k<<<grid, kPopThreads, 0, s>>>(
        a, (const int32_t*)t_dev, horizon, occ_bool, width);
  }
  return (int)cudaGetLastError();
}
