// GF(2^8) Reed-Solomon on the host CPU: the engine of degraded needle
// reads (the port's copy of seaweedfs_tpu/native/gf_rs.cc).
//
// The reference's CPU engine is klauspost/reedsolomon (Go + SIMD
// assembly); this is the same math over poly 0x11D in C++, for the
// latency-bound paths (a degraded read rebuilds one interval on the
// host; the card's kernel keeps bulk encode and rebuild).  Three tiers,
// chosen at runtime:
//
//   1. GFNI + AVX512BW (the scheme klauspost's fastest amd64 paths
//      use): multiply-by-constant as an 8x8 bit-matrix via
//      GF2P8AFFINEQB, register-blocked so every input byte is read
//      once and every output byte written once per call: memory
//      traffic (k+r)/k bytes per input byte, the streaming minimum.
//      Large calls additionally split across a few threads.
//   2. AVX512BW / AVX2 vpshufb low/high-nibble tables (klauspost's
//      classic scheme), L2-tiled.
//   3. Scalar table lookup.
//
// Built with g++ at first use by seaweedfs_tpu_torch/native/__init__.py
// and called through ctypes.  No Python.h dependency.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define GF_X86 1
#endif

namespace {

constexpr int kFieldSize = 256;
constexpr int kPoly = 29;  // 0x11D low bits
constexpr int kMaxShards = 32;  // ShardBits is uint32 (ec_context)

uint8_t g_mul[kFieldSize][kFieldSize];
uint8_t g_low[kFieldSize][16];   // c * nibble
uint8_t g_high[kFieldSize][16];  // c * (nibble << 4)
// GF2P8AFFINEQB bit-matrix for y = c*x over 0x11D.  Output bit i of
// the instruction uses matrix qword byte (7-i) as the row mask over
// the input bits; row_i bit j = bit_i(c * 2^j), since y = sum_j
// x.bit[j] * (c*2^j).
uint64_t g_aff[kFieldSize];

struct TableInit {
  TableInit() {
    uint8_t log_t[kFieldSize] = {0};
    uint8_t exp_t[kFieldSize * 2 - 2] = {0};
    int b = 1;
    for (int l = 0; l < kFieldSize - 1; ++l) {
      log_t[b] = static_cast<uint8_t>(l);
      b <<= 1;
      if (b >= kFieldSize) b = (b - kFieldSize) ^ kPoly;
    }
    for (int i = 1; i < kFieldSize; ++i) {
      int l = log_t[i];
      exp_t[l] = static_cast<uint8_t>(i);
      exp_t[l + kFieldSize - 1] = static_cast<uint8_t>(i);
    }
    for (int a = 0; a < kFieldSize; ++a) {
      for (int c = 0; c < kFieldSize; ++c) {
        g_mul[a][c] = (a == 0 || c == 0)
                          ? 0
                          : exp_t[log_t[a] + log_t[c]];
      }
    }
    for (int c = 0; c < kFieldSize; ++c) {
      for (int n = 0; n < 16; ++n) {
        g_low[c][n] = g_mul[c][n];
        g_high[c][n] = g_mul[c][n << 4];
      }
      uint64_t m = 0;
      for (int i = 0; i < 8; ++i) {  // output bit i
        uint8_t row = 0;
        for (int j = 0; j < 8; ++j) {
          if ((g_mul[c][1 << j] >> i) & 1) row |= (uint8_t)(1 << j);
        }
        m |= (uint64_t)row << (8 * (7 - i));
      }
      g_aff[c] = m;
    }
  }
} g_table_init;

bool cpu_has_gfni_avx512() {
#if defined(GF_X86)
  static const bool ok = __builtin_cpu_supports("gfni") &&
                         __builtin_cpu_supports("avx512bw") &&
                         __builtin_cpu_supports("avx512f");
  return ok;
#else
  return false;
#endif
}

// out ^= c * in  over n bytes (galois-mul-accumulate, the inner op of
// every RS row) — the tiers-2/3 primitive.
void mul_acc(uint8_t c, const uint8_t* in, uint8_t* out, size_t n) {
  if (c == 0) return;
  const uint8_t* mul_row = g_mul[c];
  size_t i = 0;
#if defined(__AVX512BW__)
  const __m512i low5 = _mm512_broadcast_i32x4(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(g_low[c])));
  const __m512i high5 = _mm512_broadcast_i32x4(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(g_high[c])));
  const __m512i mask5 = _mm512_set1_epi8(0x0f);
  for (; i + 64 <= n; i += 64) {
    __m512i x =
        _mm512_loadu_si512(reinterpret_cast<const void*>(in + i));
    __m512i lo = _mm512_and_si512(x, mask5);
    __m512i hi = _mm512_and_si512(_mm512_srli_epi64(x, 4), mask5);
    __m512i prod = _mm512_xor_si512(_mm512_shuffle_epi8(low5, lo),
                                    _mm512_shuffle_epi8(high5, hi));
    __m512i o =
        _mm512_loadu_si512(reinterpret_cast<const void*>(out + i));
    _mm512_storeu_si512(reinterpret_cast<void*>(out + i),
                        _mm512_xor_si512(o, prod));
  }
#endif
#if defined(__AVX2__)
  const __m256i low = _mm256_broadcastsi128_si256(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(g_low[c])));
  const __m256i high = _mm256_broadcastsi128_si256(
      _mm_loadu_si128(reinterpret_cast<const __m128i*>(g_high[c])));
  const __m256i mask = _mm256_set1_epi8(0x0f);
  for (; i + 32 <= n; i += 32) {
    __m256i x =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(in + i));
    __m256i lo = _mm256_and_si256(x, mask);
    __m256i hi = _mm256_and_si256(_mm256_srli_epi64(x, 4), mask);
    __m256i prod = _mm256_xor_si256(_mm256_shuffle_epi8(low, lo),
                                    _mm256_shuffle_epi8(high, hi));
    __m256i o =
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(out + i));
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + i),
                        _mm256_xor_si256(o, prod));
  }
#endif
  for (; i < n; ++i) out[i] ^= mul_row[in[i]];
}

// Tier-2/3 kernel: L2-sized tiles so (k + r) x kTile stays
// cache-resident across the k*r mul_acc passes (klauspost batches at
// 256KB/shard for the same reason, weed ec_encoder.go:61).
void matrix_apply_tiled(const uint8_t* mat, int r, int k,
                        const uint8_t* const* ins,
                        uint8_t* const* outs, size_t off, size_t n) {
  constexpr size_t kTile = 32 * 1024;
  for (size_t t = off; t < off + n; t += kTile) {
    const size_t len = (off + n - t < kTile) ? (off + n - t) : kTile;
    for (int i = 0; i < k; ++i) {
      for (int j = 0; j < r; ++j) {
        mul_acc(mat[j * k + i], ins[i] + t, outs[j] + t, len);
      }
    }
  }
}

#if defined(GF_X86)

// Tier-1 kernel body: R output rows held in zmm accumulators while the
// k input rows stream through GF2P8AFFINEQB.  Processing 2x64 bytes
// per step gives each accumulator two independent dependency chains
// (the affine op has ~3-5 cycle latency).  `acc_init` distinguishes
// fresh outputs (start from zero) from accumulate-into-existing.
template <int R>
__attribute__((target("avx512f,avx512bw,gfni")))
void gfni_block(const uint64_t* aff, int k, const uint8_t* const* ins,
                uint8_t* const* outs, size_t off, size_t n,
                int accumulate) {
  __m512i A[R * kMaxShards];
  for (int j = 0; j < R; ++j)
    for (int s = 0; s < k; ++s)
      A[j * k + s] = _mm512_set1_epi64((long long)aff[j * k + s]);
  size_t i = off;
  for (; i + 128 <= off + n; i += 128) {
    __m512i acc0[R], acc1[R];
    for (int j = 0; j < R; ++j) {
      if (accumulate) {
        acc0[j] = _mm512_loadu_si512(
            reinterpret_cast<const void*>(outs[j] + i));
        acc1[j] = _mm512_loadu_si512(
            reinterpret_cast<const void*>(outs[j] + i + 64));
      } else {
        acc0[j] = _mm512_setzero_si512();
        acc1[j] = _mm512_setzero_si512();
      }
    }
    for (int s = 0; s < k; ++s) {
      __m512i x0 = _mm512_loadu_si512(
          reinterpret_cast<const void*>(ins[s] + i));
      __m512i x1 = _mm512_loadu_si512(
          reinterpret_cast<const void*>(ins[s] + i + 64));
      for (int j = 0; j < R; ++j) {
        acc0[j] = _mm512_xor_si512(
            acc0[j], _mm512_gf2p8affine_epi64_epi8(x0, A[j * k + s], 0));
        acc1[j] = _mm512_xor_si512(
            acc1[j], _mm512_gf2p8affine_epi64_epi8(x1, A[j * k + s], 0));
      }
    }
    for (int j = 0; j < R; ++j) {
      _mm512_storeu_si512(reinterpret_cast<void*>(outs[j] + i),
                          acc0[j]);
      _mm512_storeu_si512(reinterpret_cast<void*>(outs[j] + i + 64),
                          acc1[j]);
    }
  }
  for (; i + 64 <= off + n; i += 64) {
    __m512i acc[R];
    for (int j = 0; j < R; ++j)
      acc[j] = accumulate
                   ? _mm512_loadu_si512(
                         reinterpret_cast<const void*>(outs[j] + i))
                   : _mm512_setzero_si512();
    for (int s = 0; s < k; ++s) {
      __m512i x = _mm512_loadu_si512(
          reinterpret_cast<const void*>(ins[s] + i));
      for (int j = 0; j < R; ++j)
        acc[j] = _mm512_xor_si512(
            acc[j], _mm512_gf2p8affine_epi64_epi8(x, A[j * k + s], 0));
    }
    for (int j = 0; j < R; ++j)
      _mm512_storeu_si512(reinterpret_cast<void*>(outs[j] + i),
                          acc[j]);
  }
}

// Dispatch on r in groups of <=4 accumulator rows (4 rows x 2-way
// unroll = 8 live zmm accumulators + k matrix broadcasts fits the
// 32-register file; r>4 splits into row groups, each still streaming
// the inputs once per group).
__attribute__((target("avx512f,avx512bw,gfni")))
void gfni_apply_range(const uint8_t* mat, const uint64_t* aff, int r,
                      int k, const uint8_t* const* ins,
                      uint8_t* const* outs, size_t off, size_t n,
                      int accumulate) {
  const size_t vec_n = n & ~static_cast<size_t>(63);
  for (int j0 = 0; j0 < r; j0 += 4) {
    const int rr = (r - j0 < 4) ? (r - j0) : 4;
    const uint64_t* aff_g = aff + j0 * k;
    uint8_t* const* outs_g = outs + j0;
    switch (rr) {
      case 1:
        gfni_block<1>(aff_g, k, ins, outs_g, off, vec_n, accumulate);
        break;
      case 2:
        gfni_block<2>(aff_g, k, ins, outs_g, off, vec_n, accumulate);
        break;
      case 3:
        gfni_block<3>(aff_g, k, ins, outs_g, off, vec_n, accumulate);
        break;
      default:
        gfni_block<4>(aff_g, k, ins, outs_g, off, vec_n, accumulate);
        break;
    }
  }
  if (vec_n < n) {  // scalar tail, < 64 bytes
    const size_t t0 = off + vec_n, tn = n - vec_n;
    for (int j = 0; j < r; ++j) {
      if (!accumulate) std::memset(outs[j] + t0, 0, tn);
      for (int s = 0; s < k; ++s)
        mul_acc(mat[j * k + s], ins[s] + t0, outs[j] + t0, tn);
    }
  }
}

#endif  // GF_X86

}  // namespace

extern "C" {

// out[j] (^)= sum_i mat[j*k + i] * in[i]  for all j<r, i<k, over n
// bytes.  accumulate=1 XORs into existing outputs; accumulate=0
// overwrites (callers need not pre-zero).  ins/outs are arrays of row
// pointers.
void gf_matrix_apply(const uint8_t* mat, int r, int k,
                     const uint8_t* const* ins, uint8_t* const* outs,
                     size_t n, int accumulate) {
  if (r <= 0 || k <= 0) return;
#if defined(GF_X86)
  // Schemes beyond the aff[] stack buffer (k or r*k too large) fall
  // through to the tiled path, which handles any matrix size.
  if (cpu_has_gfni_avx512() && n >= 64 && k <= kMaxShards &&
      r * k <= kMaxShards * kMaxShards) {
    uint64_t aff[kMaxShards * kMaxShards];
    for (int j = 0; j < r; ++j)
      for (int s = 0; s < k; ++s)
        aff[j * k + s] = g_aff[mat[j * k + s]];
    // Split large calls across cores (64-byte aligned chunks).  The
    // kernel streams ~(k+r)/k bytes of memory per input byte, so a
    // single core saturates neither the ALUs nor DRAM on 2+ core
    // boxes; small calls stay single-threaded (thread spawn ~50us
    // would swamp the latency path).
    unsigned hw = std::thread::hardware_concurrency();
    size_t want = n / (4 << 20);  // 1 thread per ~4MB, cap at cores
    unsigned nt = want < 2 ? 1
                 : (want > hw ? hw : static_cast<unsigned>(want));
    if (nt <= 1) {
      gfni_apply_range(mat, aff, r, k, ins, outs, 0, n, accumulate);
    } else {
      std::vector<std::thread> ths;
      ths.reserve(nt);
      size_t chunk = ((n / nt) + 63) & ~static_cast<size_t>(63);
      for (unsigned t = 0; t < nt; ++t) {
        size_t off = static_cast<size_t>(t) * chunk;
        if (off >= n) break;
        // The last spawned thread must run to n: when n/nt is already
        // 64-aligned, nt*chunk < n and capping at chunk would leave
        // the final n%nt bytes unprocessed (uninitialized output with
        // accumulate=0).
        size_t len = (t == nt - 1 || n - off < chunk) ? (n - off)
                                                      : chunk;
        ths.emplace_back([=] {
          gfni_apply_range(mat, aff, r, k, ins, outs, off, len,
                           accumulate);
        });
      }
      for (auto& th : ths) th.join();
    }
    return;
  }
#endif
  if (!accumulate) {
    for (int j = 0; j < r; ++j) std::memset(outs[j], 0, n);
  }
  matrix_apply_tiled(mat, r, k, ins, outs, 0, n);
}

// single constant multiply-accumulate, exposed for tests/tools
void gf_mul_slice_acc(uint8_t c, const uint8_t* in, uint8_t* out,
                      size_t n) {
  mul_acc(c, in, out, n);
}

int gf_native_simd() {
  if (cpu_has_gfni_avx512()) return 4;
#if defined(__AVX512BW__)
  return 3;
#elif defined(__AVX2__)
  return 2;
#else
  return 1;
#endif
}

}  // extern "C"
