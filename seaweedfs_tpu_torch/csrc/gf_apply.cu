// GF(2^8) constant-matrix apply on packed words, for Hopper (sm_90a).
//
//   out[r] = XOR_k mat[r,k] * data[k]        over GF(2^8), poly 0x11D
//
// Replaces the TPU kernel seaweedfs_tpu/ops/rs_pallas.py `_rs_kernel`
// (and its XLA twin rs_jax._packed_xor_network): every EC encode and
// rebuild batch of the volume-server pipeline goes through it.
//
// Formulation (the same as the TPU kernel's): multiplying a byte by a
// constant c is linear over GF(2), c*x = XOR_b [bit_b(x) ? c*2^b : 0].
// Four bytes ride in one 32-bit word; for each input row k and bit b,
// mask = (d >> b) & 0x01010101 isolates bit b of each byte in place and
// mask * tab[r,k,b] (tab = c*2^b < 256) multiplies all four bytes at
// once without carries between them.  The tables are a runtime input,
// so one binary serves the encode matrix and every rebuild matrix.
//
// What bounds it on an H100 SXM: per word column it moves (K + R) * 4
// bytes and does K*8*(2 + 2R) integer operations.  For the main-path
// launch ([4,10] x 16,777,216 words) that is 0.94 GB, 0.28 ms at
// 3.35 TB/s, and 13.4 G operations, 0.20 ms at the data sheet's 67 T
// 32-bit operations/s: bytes bound it.  (Counting 64 INT32 lanes a clock
// per SM instead gives 0.80 ms, which is not a bound: the kernel ran in
// 0.52 ms on an H100 80GB HBM3 at 700 W, because the multiplies issue on
// the FMA lanes and three-input LOP3 folds the XORs.)  The design keeps
// the memory side at its floor (each data word read once per row group,
// each output word written once, 16-byte loads and stores); the integer
// work is what keeps it above that floor, and a formulation with fewer
// operations per byte is later work.
//
// The batched entry (gf_apply_words_batched) replaces the `vmap` over
// volumes of seaweedfs_tpu/parallel/ec_sharded.py
// `_apply_tables_batch_local` (BASELINE.json config 3, a 64-volume
// ec.encode): one launch for V volumes, the volume on blockIdx.y, one
// set of tables for all of them.  At the batch path's step shape
// ([64,10] -> [64,4] x 262,144 words) it is the same work as the
// single-volume main-path launch: 0.94 GB moved, >= 0.28 ms at
// 3.35 TB/s, and 13.4 G integer operations, >= 0.20 ms at 67 T/s, so
// bytes bound it.  The x grid is cut to about 8*SMs/V blocks, so the
// x*V blocks of a launch still fill the 132 SMs without launching
// V * 8*SMs of them.
//
// Design:
// - a grid-stride loop over word columns; neighbouring threads take
//   neighbouring 16-byte (uint4) columns when every row is 16-byte
//   aligned (W % 4 == 0), else single words;
// - the accumulators of a group of RB <= 8 output rows live in
//   registers (RB is a template parameter: a runtime-indexed array
//   would spill to local memory); rows past 8 are further groups,
//   each of which reads the data again;
// - the group's RB*K*8 tables are copied from device memory into
//   shared memory by each block (no __constant__ symbol written per
//   call: encode and rebuild launches may be in flight on different
//   streams at once);
// - 64-bit offsets, per volume too (V*K*W passes 2^31 words at large
//   steps); it allocates nothing, launches on the caller's stream and
//   returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsPerGroup = 8;
constexpr int kMaxShards = 32;
constexpr int kMaxGridY = 65535;
constexpr uint32_t kLaneMask = 0x01010101u;

template <int RB, bool VEC>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint32_t* __restrict__ tables,  // [RB, K, 8]
                const uint32_t* __restrict__ data,    // [V][K, W]
                uint32_t* __restrict__ out,           // [V][RB rows of W]
                int K, int64_t W,
                int64_t data_vstride,                 // words per volume
                int64_t out_vstride) {
  extern __shared__ uint32_t tab[];
  data += (int64_t)blockIdx.y * data_vstride;
  out += (int64_t)blockIdx.y * out_vstride;
  for (int i = threadIdx.x; i < RB * K * 8; i += blockDim.x) {
    tab[i] = tables[i];
  }
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    const int64_t W4 = W / 4;
    const uint4* d4 = reinterpret_cast<const uint4*>(data);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (int64_t c = first; c < W4; c += stride) {
      uint4 acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = make_uint4(0u, 0u, 0u, 0u);
      for (int k = 0; k < K; ++k) {
        const uint4 d = d4[(size_t)k * (size_t)W4 + (size_t)c];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const uint32_t mx = (d.x >> b) & kLaneMask;
          const uint32_t my = (d.y >> b) & kLaneMask;
          const uint32_t mz = (d.z >> b) & kLaneMask;
          const uint32_t mw = (d.w >> b) & kLaneMask;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const uint32_t t = tab[(r * K + k) * 8 + b];
            acc[r].x ^= mx * t;
            acc[r].y ^= my * t;
            acc[r].z ^= mz * t;
            acc[r].w ^= mw * t;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        o4[(size_t)r * (size_t)W4 + (size_t)c] = acc[r];
      }
    }
  } else {
    for (int64_t c = first; c < W; c += stride) {
      uint32_t acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0u;
      for (int k = 0; k < K; ++k) {
        const uint32_t d = data[(size_t)k * (size_t)W + (size_t)c];
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const uint32_t m = (d >> b) & kLaneMask;
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            acc[r] ^= m * tab[(r * K + k) * 8 + b];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        out[(size_t)r * (size_t)W + (size_t)c] = acc[r];
      }
    }
  }
}

template <int RB>
cudaError_t launch_group(const uint32_t* tables, const uint32_t* data,
                         uint32_t* out, int V, int K, int64_t W,
                         int64_t data_vstride, int64_t out_vstride,
                         bool vec, int max_blocks, cudaStream_t stream) {
  const int64_t columns = vec ? W / 4 : W;
  int64_t blocks = (columns + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)V);
  const size_t smem = (size_t)RB * K * 8 * sizeof(uint32_t);
  if (vec) {
    gf_apply_kernel<RB, true><<<grid, kThreads, smem, stream>>>(
        tables, data, out, K, W, data_vstride, out_vstride);
  } else {
    gf_apply_kernel<RB, false><<<grid, kThreads, smem, stream>>>(
        tables, data, out, K, W, data_vstride, out_vstride);
  }
  return cudaGetLastError();
}

// V volumes of [K, W] words in, [R, W] each out; row groups of <= 8.
int apply_volumes(const void* tables, const void* data, void* out, int V,
                  int R, int K, long long W, void* stream) {
  if (R < 1 || R > kMaxShards || K < 1 || K > kMaxShards || W < 0 ||
      V < 1 || V > kMaxGridY) {
    return (int)cudaErrorInvalidValue;
  }
  if (W == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // about 8 blocks per SM over the whole grid, at least one per volume
  const int max_blocks = (sms * 8 + V - 1) / V;
  // every volume's base is data + v*K*W and out + v*R*W (+ r0*W): with
  // W % 4 == 0 those offsets are whole 16-byte units, so the bases'
  // alignment holds for every volume and row group
  const bool vec = (W % 4 == 0) &&
                   ((uintptr_t)data % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int64_t data_vstride = (int64_t)K * W;
  const int64_t out_vstride = (int64_t)R * W;
  const cudaStream_t s = (cudaStream_t)stream;
  for (int r0 = 0; r0 < R; r0 += kMaxRowsPerGroup) {
    const int rb = (R - r0 < kMaxRowsPerGroup) ? R - r0 : kMaxRowsPerGroup;
    const uint32_t* t = (const uint32_t*)tables + (size_t)r0 * K * 8;
    const uint32_t* d = (const uint32_t*)data;
    uint32_t* o = (uint32_t*)out + (size_t)r0 * (size_t)W;
#define GF_GROUP(N)                                                    \
  err = launch_group<N>(t, d, o, V, K, W, data_vstride, out_vstride,  \
                        vec, max_blocks, s)
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
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// tables: [R*K*8] 32-bit words (c*2^b, < 256) in device memory.
// data:   [K, W] 32-bit words, row-major, in device memory.
// out:    [R, W] 32-bit words, row-major, in device memory.
// stream: a cudaStream_t.  Returns a cudaError_t (0 on success).
extern "C" int gf_apply_words(const void* tables, const void* data,
                              void* out, int R, int K, long long W,
                              void* stream) {
  return apply_volumes(tables, data, out, 1, R, K, W, stream);
}

// The same apply for V volumes in one launch (one set of tables):
// data [V, K, W] and out [V, R, W], contiguous, in device memory;
// 1 <= V <= 65,535 (the grid's y limit).
extern "C" int gf_apply_words_batched(const void* tables, const void* data,
                                      void* out, int V, int R, int K,
                                      long long W, void* stream) {
  return apply_volumes(tables, data, out, V, R, K, W, stream);
}
