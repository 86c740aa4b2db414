// Calendar transport kernels for Hopper (sm_90a): the port of the two
// Pallas kernels in testground_tpu/sim/pallas_transport.py.
//
// K1 segmented calendar commit  (replaces pallas_transport.py:_commit_call,
//    called by commit_calendar). Commits one tick's message stream, sorted
//    by key = bucket*N + dst (dead keys >= L*N), into the [L, N*SLOTS]
//    calendar planes at position slot*N + dst of row `bucket`. A message's
//    slot is its rank inside its run of equal keys plus the bucket's
//    PRE-tick fill for dst (0 without stacking); slot >= SLOTS drops it.
//
//    Bound: memory. Per message it reads the stream words (8 + 4W bytes),
//    up to SLOTS occupancy words at a run start and writes the survival
//    word; per survivor it writes 1 + W (+1) plane words at scattered
//    positions. Arithmetic is a binary search (<= 18 probes at 200k).
//
//    Design: the TPU walks the stream serially with a rank carry in SMEM;
//    here every sorted message is one thread. The run start is a
//    lower-bound binary search over the sorted keys, so ranks need no
//    carry and no scan, and positions are unique by construction, so no
//    atomics. Two launches are REQUIRED: run-mates write into the very
//    slots whose occupancy gives the run's base, so every fill must be
//    read (launch 1: commit_rank) before any plane is written (launch 2:
//    commit_write) — the ordering the TPU gets from its serial walk.
//
// K2 delivery pop  (replaces pallas_transport.py:_pop_call, called by
//    pop_bucket). Copies row b = t mod L of the occupancy plane and the W
//    payload planes out as [N*SLOTS] rows and zeroes the occupancy row, in
//    one pass. b is computed from the device tick, so the host never reads
//    it.
//
//    Bound: memory (reads (occ + 4W) bytes per cell, writes them once
//    plus the cleared occupancy word). Design: 4 cells per thread with
//    16-byte vector accesses when the rows are 16-byte aligned, so the
//    copy runs at full-width transactions; a scalar path otherwise.
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

__global__ void commit_rank(const int32_t* __restrict__ sk,
                            const void* __restrict__ occ, int occ_bool,
                            int m2, int n, int slots, long long big,
                            int stacking, int32_t* __restrict__ slot_out,
                            int32_t* __restrict__ surv) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m2) return;
  const int32_t key = sk[j];
  if (key < 0 || (long long)key >= big) {
    slot_out[j] = -1;
    surv[j] = 0;
    return;
  }
  // run start = first index of `key` in the sorted stream
  int lo = 0, hi = j;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (sk[mid] < key) lo = mid + 1; else hi = mid;
  }
  int slot = j - lo;
  if (stacking) {
    const int b = key / n;
    const int d = key - b * n;
    const size_t row = (size_t)b * (size_t)n * (size_t)slots + (size_t)d;
    int base = 0;
    if (occ_bool) {
      const uint8_t* o = (const uint8_t*)occ;
      for (int s = 0; s < slots; ++s) base += o[row + (size_t)s * n] != 0;
    } else {
      const int32_t* o = (const int32_t*)occ;
      for (int s = 0; s < slots; ++s) base += o[row + (size_t)s * n] != 0;
    }
    slot += base;
  }
  const bool keep = slot < slots;
  slot_out[j] = keep ? slot : -1;
  surv[j] = keep ? 1 : 0;
}

__global__ void commit_write(const int32_t* __restrict__ sk,
                             const int32_t* __restrict__ slot_in,
                             const int32_t* __restrict__ occ_vals,
                             ConstPlanes pay_in, int width, void* occ,
                             int occ_bool, Planes planes,
                             int32_t* __restrict__ etick,
                             const int32_t* __restrict__ t_dev, int m2,
                             int n, int slots) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m2) return;
  const int slot = slot_in[j];
  if (slot < 0) return;
  const int key = sk[j];
  const int b = key / n;
  const int d = key - b * n;
  const size_t pos = (size_t)b * (size_t)n * (size_t)slots +
                     (size_t)slot * (size_t)n + (size_t)d;
  if (occ_bool) {
    ((uint8_t*)occ)[pos] = occ_vals[j] != 0;
  } else {
    ((int32_t*)occ)[pos] = occ_vals[j];
  }
  for (int w = 0; w < width; ++w) planes.p[w][pos] = pay_in.p[w][j];
  if (etick != nullptr) etick[pos] = *t_dev;
}

__device__ __forceinline__ long long floor_mod(long long a, long long m) {
  long long r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void pop_bucket_k(void* occ, int occ_bool, ConstPlanes pay,
                             int width, const int32_t* __restrict__ t_dev,
                             int horizon, long long ns, int vec,
                             void* row_occ, Planes row_pay) {
  const long long i = 4LL * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= ns) return;
  const long long base = floor_mod((long long)(*t_dev), horizon) * ns;
  if (vec) {
    // ns % 4 == 0 and 16-byte aligned planes: whole 4-cell groups
    if (occ_bool) {
      uint32_t* o = (uint32_t*)((uint8_t*)occ + base + i);
      *(uint32_t*)((uint8_t*)row_occ + i) = *o;
      *o = 0u;
    } else {
      int4* o = (int4*)((int32_t*)occ + base + i);
      *(int4*)((int32_t*)row_occ + i) = *o;
      *o = make_int4(0, 0, 0, 0);
    }
    for (int w = 0; w < width; ++w) {
      *(int4*)(row_pay.p[w] + i) = *(const int4*)(pay.p[w] + base + i);
    }
    return;
  }
  const long long end = i + 4 < ns ? i + 4 : ns;
  for (long long c = i; c < end; ++c) {
    if (occ_bool) {
      uint8_t* o = (uint8_t*)occ + base + c;
      ((uint8_t*)row_occ)[c] = *o;
      *o = 0;
    } else {
      int32_t* o = (int32_t*)occ + base + c;
      ((int32_t*)row_occ)[c] = *o;
      *o = 0;
    }
    for (int w = 0; w < width; ++w) row_pay.p[w][c] = pay.p[w][base + c];
  }
}

static const int kThreads = 256;

extern "C" int tg_commit_calendar(
    const void* sk, const void* occ_vals, const void* pay_sorted_ptrs,
    int width, void* occ, int occ_bool, const void* plane_ptrs, void* etick,
    const void* t_dev, void* slot_scratch, void* surv, int m2, int horizon,
    int n, int slots, int stacking, void* stream) {
  if (width < 0 || width > TG_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  ConstPlanes pay_in;
  Planes planes;
  const void* const* ps = (const void* const*)pay_sorted_ptrs;
  const void* const* pp = (const void* const*)plane_ptrs;
  for (int w = 0; w < TG_MAX_WIDTH; ++w) {
    pay_in.p[w] = w < width ? (const int32_t*)ps[w] : nullptr;
    planes.p[w] = w < width ? (int32_t*)pp[w] : nullptr;
  }
  const int blocks = (m2 + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  commit_rank<<<blocks, kThreads, 0, s>>>(
      (const int32_t*)sk, occ, occ_bool, m2, n, slots,
      (long long)horizon * (long long)n, stacking, (int32_t*)slot_scratch,
      (int32_t*)surv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  commit_write<<<blocks, kThreads, 0, s>>>(
      (const int32_t*)sk, (const int32_t*)slot_scratch,
      (const int32_t*)occ_vals, pay_in, width, occ, occ_bool, planes,
      (int32_t*)etick, (const int32_t*)t_dev, m2, n, slots);
  return (int)cudaGetLastError();
}

extern "C" int tg_pop_bucket(void* occ, int occ_bool, const void* pay_ptrs,
                             int width, const void* t_dev, int horizon,
                             long long ns, int vec, void* row_occ,
                             const void* row_pay_ptrs, void* stream) {
  if (width < 0 || width > TG_MAX_WIDTH) return (int)cudaErrorInvalidValue;
  ConstPlanes pay;
  Planes rows;
  const void* const* pp = (const void* const*)pay_ptrs;
  const void* const* rp = (const void* const*)row_pay_ptrs;
  for (int w = 0; w < TG_MAX_WIDTH; ++w) {
    pay.p[w] = w < width ? (const int32_t*)pp[w] : nullptr;
    rows.p[w] = w < width ? (int32_t*)rp[w] : nullptr;
  }
  const long long groups = (ns + 3) / 4;
  const int blocks = (int)((groups + kThreads - 1) / kThreads);
  pop_bucket_k<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      occ, occ_bool, pay, width, (const int32_t*)t_dev, horizon, ns, vec,
      row_occ, rows);
  return (int)cudaGetLastError();
}
