// GF(2^8) constant-matrix apply on packed words, for Hopper (sm_90a).
//
//   out[r] = XOR_k mat[r,k] * data[k]        over GF(2^8), poly 0x11D
//
// Four GF bytes ride in each 32-bit word.  Two entries:
// - gf_apply_words replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py
//   `_rs_kernel` (and its XLA twin rs_jax._packed_xor_network): every EC
//   encode and rebuild window of the volume-server pipeline goes through
//   it;
// - gf_apply_words_batched replaces the `vmap` over volumes of
//   seaweedfs_tpu/parallel/ec_sharded.py `_apply_tables_batch_local`
//   (the 64-volume ec.encode): V volumes, one matrix, one launch.
//
// What bounds it.  A launch moves (K + R) * 4 bytes a word column: at the
// main path's window, [4,10] x 838,860 words, 47.0 MB, 0.0140 ms at the
// H100's 3.35 TB/s; a device-to-device copy of as many bytes takes
// 0.0211 ms on an H100 80GB HBM3 at 700 W (chip_smoke.py's copy_ms),
// launch and ramp included.  The arithmetic is integer work, mostly on
// the 64-lane ALU pipe.  Multiplying by bit masks (a mask per bit of each
// byte times the table c*2^b, as the generic body below does) takes 2,769
// SASS instructions a 16-byte column at [4,10]: an issue floor of
// 0.0174 ms at 1980 MHz, above the bytes bound.
//
// Design.
// - Nibble lookups through PRMT.  c*x = c*(x & 7) ^ c*(x & 0x38) ^
//   c*(x & 0xC0), so three 8-entry byte tables per coefficient (T0[j] =
//   c*j, T1[j] = c*(j << 3), T2[j] = c*(j << 6), in 5 words) give the
//   product of four bytes in three PRMTs.  The PRMT selectors (one 3-bit
//   index a byte lane, in the low 16 bits) are built once a word and k
//   and shared by the R rows: a mask, then one IMAD.HI that adds the
//   word shifted right by p and by p+12 (x0, x2, x1, x3 land in nibbles
//   0..3, so the lanes come out permuted and one PRMT a word puts them
//   back before the store).  Bit 3 of every selector nibble is clear, so
//   prmt.b32 is issued directly (__byte_perm would mask each selector).
//   A uint4 column of [4,10] runs 1,288 SASS instructions against the
//   bit masks' 2,769: an issue floor of 0.0081 ms at the window, under
//   the bytes bound, so the templates are bound by memory.
// - Templates for the main paths' shapes, [1..4, 10] (RS(10,4)'s encode
//   and every rebuild) and [1..3, 6] (RS(6,3)'s encode and every
//   rebuild): K and R are compile-time, so the K 16-byte loads
//   of a column are all issued before its arithmetic, and the R*K*5
//   table words (800 bytes at [4,10]) are a __grid_constant__ launch
//   parameter read from the constant bank: no shared memory, no
//   __syncthreads, and each launch carries its own tables (launches on
//   other streams cannot see them).
// - A persistent grid: SMs x resident blocks (the occupancy API, queried
//   once per device and cached), 128 threads a block, at most 85
//   registers (6 blocks an SM); every thread walks columns at a stride of
//   the grid, the volumes' columns indexed linearly (V x W/4), so a
//   launch of any V has no partial wave.  Occupancy, not a register
//   double buffer, hides the loads: on the card, a double-buffered form
//   (155 registers, 3 blocks an SM) ran the window 9% slower than 5
//   blocks without it, and 5 blocks 7% slower than 6 (PERF.md).
// - Every other shape ([16,16], K or R up to 32) runs the
//   generic body: runtime K, groups of RB <= 8 rows with the accumulators
//   in registers, bit masks times tables read from shared memory (copied
//   from device memory per block: the largest group's tables are 8 KB,
//   over the classic 4 KB parameter limit), on the same persistent grid
//   and linear volume index.
// - Rows 16-byte aligned (W % 4 == 0 and aligned bases) take uint4
//   columns, else single words.  Volume and column indices are 32-bit
//   (fewer registers: at most 65,535 volumes and 2^30 columns a row),
//   offsets 64-bit; nothing is allocated; launches go on the caller's
//   stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // generic body
constexpr int kSpecThreads = 128;      // templates
constexpr int kSpecMinBlocks = 6;      // -> at most 85 registers
constexpr int kMaxRowsPerGroup = 8;
constexpr int kMaxShards = 32;
constexpr int kMaxVolumes = 65535;
constexpr int64_t kMaxColumns = int64_t{1} << 30;  // 32-bit column index
constexpr int kMaxDevices = 64;
constexpr int kSpecSlots = 14;         // [1..4,10] 0-7, [1..3,6] 8-13
constexpr int kSlots = kSpecSlots + 16;  // then the generic body's
constexpr uint32_t kLaneMask = 0x01010101u;

// ---- columns: a uint4 of 4 words when every row is 16-byte aligned ----

template <bool VEC> struct Col {
  using T = uint32_t;
  static constexpr int kWords = 1;
};
template <> struct Col<true> {
  using T = uint4;
  static constexpr int kWords = 4;
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }
__device__ __forceinline__ void set_word(uint4& v, int i, uint32_t x) {
  if (i == 0) v.x = x; else if (i == 1) v.y = x; else if (i == 2) v.z = x;
  else v.w = x;
}
__device__ __forceinline__ void set_word(uint32_t& v, int, uint32_t x) {
  v = x;
}

// ---- the templates' body -----------------------------------------------

template <int R, int K> struct NibbleTables { uint32_t t[R * K * 5]; };

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

struct Selectors { uint32_t s0, s1, s2; };

// Bits 0-2, 3-5 and 6-7 of each byte of d as PRMT selectors: byte lanes
// 0, 2, 1, 3 in nibbles 0..3 of the low 16 bits (bit 3 of each clear).
__device__ __forceinline__ Selectors selectors(uint32_t d) {
  const uint32_t u0 = d & 0x07070707u;
  return {__umulhi(u0, 1u << 20) + u0,                        // u0 + u0>>12
          __umulhi(d & 0x38383838u, (1u << 29) | (1u << 17)),  // >>3, >>15
          __umulhi(d & 0xC0C0C0C0u, (1u << 26) | (1u << 14))}; // >>6, >>18
}

template <int K, class T>
__device__ __forceinline__ void load_column(T (&dst)[K], const T* src,
                                            int64_t C) {
#pragma unroll
  for (int k = 0; k < K; ++k) dst[k] = src[(int64_t)k * C];
}

template <int R, int K, int NW, class T>
__device__ __forceinline__ void apply_column(const NibbleTables<R, K>& tab,
                                             const T (&col)[K],
                                             uint32_t (&acc)[NW][R]) {
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[i][r] = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    Selectors s[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) s[i] = selectors(word(col[k], i));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t* t = &tab.t[(r * K + k) * 5];
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        acc[i][r] ^= prmt(t[0], t[1], s[i].s0) ^ prmt(t[2], t[3], s[i].s1) ^
                     prmt(t[4], 0u, s[i].s2);
      }
    }
  }
}

template <int R, int K, bool VEC>
__global__ void __launch_bounds__(kSpecThreads, kSpecMinBlocks)
gf_apply_spec(const __grid_constant__ NibbleTables<R, K> tab,
              const uint32_t* __restrict__ data,   // [V][K, W]
              uint32_t* __restrict__ out,          // [V][R, W]
              int64_t C, int64_t total) {          // columns a row, V*C
  using T = typename Col<VEC>::T;
  constexpr int NW = Col<VEC>::kWords;
  const T* __restrict__ d = reinterpret_cast<const T*>(data);
  T* __restrict__ o = reinterpret_cast<T*>(out);
  const int64_t stride = (int64_t)gridDim.x * kSpecThreads;
  int64_t g = (int64_t)blockIdx.x * kSpecThreads + threadIdx.x;
  if (g >= total) return;
  int v = (int)(g / C), c = (int)(g - (int64_t)v * C);   // volume, column
  const int sv = (int)(stride / C), sc = (int)(stride - (int64_t)sv * C);
#pragma unroll 1
  for (; g < total; g += stride) {
    T col[K];
    load_column<K>(col, d + ((int64_t)v * K * C + c), C);
    uint32_t acc[NW][R];
    apply_column<R, K, NW>(tab, col, acc);
    T* dst = o + ((int64_t)v * R * C + c);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      T x;
#pragma unroll
      for (int i = 0; i < NW; ++i)
        set_word(x, i, prmt(acc[i][r], 0u, 0x3120));   // lanes back
      dst[(int64_t)r * C] = x;
    }
    v += sv;
    c += sc;
    if (c >= C) { c -= C; ++v; }
  }
}

// ---- the generic body: runtime K, a group of RB <= 8 output rows --------

template <int RB, bool VEC>
__global__ void __launch_bounds__(kThreads)
gf_apply_generic(const uint32_t* __restrict__ tables,  // group's [RB, K, 8]
                 const uint32_t* __restrict__ data,    // [V][K, W]
                 uint32_t* __restrict__ out,           // [V][R, W] + r0 rows
                 int K, int R, int64_t C, int64_t total) {
  using T = typename Col<VEC>::T;
  constexpr int NW = Col<VEC>::kWords;
  extern __shared__ uint32_t tab[];
  for (int i = threadIdx.x; i < RB * K * 8; i += blockDim.x) {
    tab[i] = tables[i];
  }
  __syncthreads();
  const T* __restrict__ d = reinterpret_cast<const T*>(data);
  T* __restrict__ o = reinterpret_cast<T*>(out);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  int v = (int)(g / C), c = (int)(g - (int64_t)v * C);
  const int sv = (int)(stride / C), sc = (int)(stride - (int64_t)sv * C);
  for (; g < total; g += stride) {
    uint32_t acc[NW][RB];
#pragma unroll
    for (int i = 0; i < NW; ++i)
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[i][r] = 0u;
    const T* src = d + ((int64_t)v * K * C + c);
    for (int k = 0; k < K; ++k) {
      const T x = src[(int64_t)k * C];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          // bit b of each byte in place, times c*2^b: no carries
          const uint32_t m = (word(x, i) >> b) & kLaneMask;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            acc[i][r] ^= m * tab[(r * K + k) * 8 + b];
          }
        }
      }
    }
    T* dst = o + ((int64_t)v * R * C + c);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      T y;
#pragma unroll
      for (int i = 0; i < NW; ++i) set_word(y, i, acc[i][r]);
      dst[(int64_t)r * C] = y;
    }
    v += sv;
    c += sc;
    if (c >= C) { c -= C; ++v; }
  }
}

// ---- host side: launch facts per device, queried once -----------------

int g_sms[kMaxDevices];
int g_resident[kMaxDevices][kSlots];

cudaError_t device_sms(int* dev, int* sms) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[*dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
    g_sms[*dev] = n;
  }
  *sms = g_sms[*dev];
  return cudaSuccess;
}

template <class F>
cudaError_t resident_blocks(F kernel, int slot, int dev, int threads,
                            size_t smem, int* blocks) {
  if (g_resident[dev][slot] == 0) {
    int n = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    g_resident[dev][slot] = n > 0 ? n : 1;
  }
  *blocks = g_resident[dev][slot];
  return cudaSuccess;
}

struct Plan {
  int64_t specialised;   // 1: an (R, K) template, 0: the generic body
  int64_t threads;
  int64_t resident;      // blocks an SM (occupancy API)
  int64_t sms;
  int64_t grid;          // blocks a launch
  int64_t launches;      // row groups of the generic body
};

int64_t grid_for(int64_t total, int threads, int sms, int resident) {
  const int64_t need = (total + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * resident;
  return need < 1 ? 1 : need < cap ? need : cap;
}

// T0[j] = c*j (j < 8), T1[j] = c*(j << 3), T2[j] = c*(j << 6) (j < 4),
// each the XOR of the bit tables c*2^b over the bits of its index
template <int R, int K>
void fill_tables(NibbleTables<R, K>& tab, const uint32_t* bits) {
  for (int rk = 0; rk < R * K; ++rk) {
    const uint32_t* bit = bits + rk * 8;
    uint32_t* t = tab.t + rk * 5;
    for (int i = 0; i < 5; ++i) t[i] = 0;
    for (int j = 0; j < 8; ++j) {
      uint32_t x0 = 0, x1 = 0, x2 = 0;
      for (int q = 0; q < 3; ++q) {
        if (j >> q & 1) {
          x0 ^= bit[q];
          x1 ^= bit[q + 3];
          if (q < 2) x2 ^= bit[q + 6];
        }
      }
      t[j / 4] |= (x0 & 0xFF) << (8 * (j % 4));
      t[2 + j / 4] |= (x1 & 0xFF) << (8 * (j % 4));
      if (j < 4) t[4] |= (x2 & 0xFF) << (8 * j);
    }
  }
}

template <int R, int K, bool VEC>
cudaError_t launch_spec(const uint32_t* host, const uint32_t* data,
                        uint32_t* out, int64_t C, int64_t total, int dev,
                        int sms, cudaStream_t s, Plan* plan) {
  auto kernel = gf_apply_spec<R, K, VEC>;
  constexpr int slot = (K == 10 ? 0 : 8) + (R - 1) * 2 + (VEC ? 1 : 0);
  int resident = 0;
  cudaError_t err = resident_blocks(kernel, slot, dev, kSpecThreads, 0,
                                    &resident);
  if (err != cudaSuccess) return err;
  const int64_t grid = grid_for(total, kSpecThreads, sms, resident);
  if (plan) {
    *plan = Plan{1, kSpecThreads, resident, sms, grid, 1};
    return cudaSuccess;
  }
  NibbleTables<R, K> tab;
  fill_tables(tab, host);
  kernel<<<(unsigned)grid, kSpecThreads, 0, s>>>(tab, data, out, C, total);
  return cudaGetLastError();
}

template <int RB, bool VEC>
cudaError_t launch_generic(const uint32_t* tables, const uint32_t* data,
                           uint32_t* out, int K, int R, int64_t C,
                           int64_t total, int dev, int sms, cudaStream_t s,
                           Plan* plan) {
  auto kernel = gf_apply_generic<RB, VEC>;
  int resident = 0;
  // cached at the largest group's shared memory (K = 32)
  cudaError_t err = resident_blocks(
      kernel, kSpecSlots + (RB - 1) * 2 + VEC, dev, kThreads,
      (size_t)RB * kMaxShards * 8 * sizeof(uint32_t), &resident);
  if (err != cudaSuccess) return err;
  const int64_t grid = grid_for(total, kThreads, sms, resident);
  if (plan) {
    *plan = Plan{0, kThreads, resident, sms, grid,
                 (R + kMaxRowsPerGroup - 1) / kMaxRowsPerGroup};
    return cudaSuccess;
  }
  const size_t smem = (size_t)RB * K * 8 * sizeof(uint32_t);
  kernel<<<(unsigned)grid, kThreads, smem, s>>>(tables, data, out, K, R, C,
                                                total);
  return cudaGetLastError();
}

// V volumes of [K, W] words in, [R, W] each out.  `plan` set: fill it
// with what the launch would do and launch nothing.  `generic`: the
// generic body even where a template exists (the templates' yardstick).
int apply_volumes(const void* tables, const void* host, const void* data,
                  void* out, int V, int R, int K, long long W, void* stream,
                  Plan* plan, bool generic = false) {
  if (R < 1 || R > kMaxShards || K < 1 || K > kMaxShards || W < 0 ||
      V < 1 || V > kMaxVolumes) {
    return (int)cudaErrorInvalidValue;
  }
  if (W == 0 && !plan) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  // every volume's base is data + v*K*W and out + v*R*W (+ r0*W): with
  // W % 4 == 0 those offsets are whole 16-byte units, so the bases'
  // alignment holds for every volume and row group
  const bool vec = (W % 4 == 0) && ((uintptr_t)data % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const int64_t C = vec ? W / 4 : W;
  if (C > kMaxColumns) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)V * C;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* h = (const uint32_t*)host;
  const uint32_t* d = (const uint32_t*)data;
  uint32_t* o = (uint32_t*)out;
#define GF_SPEC(N, KK)                                                     \
  err = vec ? launch_spec<N, KK, true>(h, d, o, C, total, dev, sms, s,     \
                                       plan)                               \
            : launch_spec<N, KK, false>(h, d, o, C, total, dev, sms, s,    \
                                        plan)
  if (!generic && K == 10 && R <= 4) {
    switch (R) {
      case 1: GF_SPEC(1, 10); break;
      case 2: GF_SPEC(2, 10); break;
      case 3: GF_SPEC(3, 10); break;
      default: GF_SPEC(4, 10); break;
    }
    return (int)err;
  }
  if (!generic && K == 6 && R <= 3) {
    switch (R) {
      case 1: GF_SPEC(1, 6); break;
      case 2: GF_SPEC(2, 6); break;
      default: GF_SPEC(3, 6); break;
    }
    return (int)err;
  }
#undef GF_SPEC
  for (int r0 = 0; r0 < R; r0 += kMaxRowsPerGroup) {
    const int rb = (R - r0 < kMaxRowsPerGroup) ? R - r0 : kMaxRowsPerGroup;
    const uint32_t* t = (const uint32_t*)tables + (size_t)r0 * K * 8;
    uint32_t* og = o + (size_t)r0 * (size_t)W;
#define GF_GROUP(N)                                                         \
  err = vec ? launch_generic<N, true>(t, d, og, K, R, C, total, dev, sms,   \
                                      s, plan)                              \
            : launch_generic<N, false>(t, d, og, K, R, C, total, dev, sms,  \
                                       s, plan)
    switch (rb) {
      case 1: GF_GROUP(1); break;
      case 2: GF_GROUP(2); break;
      case 3: GF_GROUP(3); break;
      case 4: GF_GROUP(4); break;
      case 5: GF_GROUP(5); break;
      case 6: GF_GROUP(6); break;
      case 7: GF_GROUP(7); break;
      default: GF_GROUP(8); break;
    }
#undef GF_GROUP
    if (err != cudaSuccess || plan) return (int)err;
  }
  return 0;
}

}  // namespace

// tables:      [R*K*8] 32-bit words (c*2^b, < 256) in device memory.
// host_tables: the same words in host memory (copied into the launch).
// data:        [K, W] 32-bit words, row-major, in device memory.
// out:         [R, W] 32-bit words, row-major, in device memory.
// stream:      a cudaStream_t.  Returns a cudaError_t (0 on success).
extern "C" int gf_apply_words(const void* tables, const void* host_tables,
                              const void* data, void* out, int R, int K,
                              long long W, void* stream) {
  return apply_volumes(tables, host_tables, data, out, 1, R, K, W, stream,
                       nullptr);
}

// The same apply through the generic body whatever the shape: the
// yardstick a template is timed against, never the main path.
extern "C" int gf_apply_words_generic(const void* tables, const void* data,
                                      void* out, int R, int K, long long W,
                                      void* stream) {
  return apply_volumes(tables, nullptr, data, out, 1, R, K, W, stream,
                       nullptr, true);
}

// The same apply for V volumes in one launch (one set of tables): data
// [V, K, W] and out [V, R, W], contiguous, in device memory; 1 <= V <=
// 65,535.
extern "C" int gf_apply_words_batched(const void* tables,
                                      const void* host_tables,
                                      const void* data, void* out, int V,
                                      int R, int K, long long W,
                                      void* stream) {
  return apply_volumes(tables, host_tables, data, out, V, R, K, W, stream,
                       nullptr);
}

// What a launch of V [R, K] x W-word applies on the current device does,
// on 16-byte-aligned rows or not: info = {template (1) or generic body
// (0), threads a block, resident blocks an SM, SMs, blocks a launch,
// launches}.  Launches nothing.
extern "C" int gf_apply_plan(int V, int R, int K, long long W, int aligned,
                             long long* info) {
  Plan p{};
  // stand-in device pointers, aligned or not, for the alignment rule
  const uintptr_t base = aligned ? 16 : 20;
  const int err = apply_volumes(nullptr, nullptr, (const void*)base,
                                (void*)base, V, R, K, W, nullptr, &p);
  const int64_t fields[6] = {p.specialised, p.threads, p.resident, p.sms,
                             p.grid, p.launches};
  for (int i = 0; i < 6; ++i) info[i] = fields[i];
  return err;
}
