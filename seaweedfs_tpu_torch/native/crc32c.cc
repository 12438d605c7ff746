// CRC32-Castagnoli of needle checksums, for storage/crc.py where the
// google_crc32c package is absent: the hardware `crc32` instruction
// (SSE4.2) when the CPU has it, else a slice-by-8 table loop.  The same
// three functions and dispatch as write_plane.cc's checksum.
//
// Build: g++ -O3 -shared -fPIC (no deps); driven via ctypes from
// seaweedfs_tpu_torch/storage/crc.py.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace {

uint32_t g_crc_table[8][256];

void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    g_crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int t = 1; t < 8; t++)
      g_crc_table[t][i] =
          (g_crc_table[t - 1][i] >> 8) ^
          g_crc_table[0][g_crc_table[t - 1][i] & 0xFF];
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t crc32c_hw(uint32_t c,
                                                     const uint8_t* p,
                                                     size_t n) {
  c = ~c;
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    c = (uint32_t)__builtin_ia32_crc32di(c, v);
    p += 8;
    n -= 8;
  }
  while (n--) c = __builtin_ia32_crc32qi(c, *p++);
  return ~c;
}
bool g_have_sse42 = false;
#endif

uint32_t crc32c_sw(uint32_t c, const uint8_t* p, size_t n) {
  // slice-by-8
  c = ~c;
  while (n >= 8) {
    c ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
         ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
    uint32_t hi = (uint32_t)p[4] | ((uint32_t)p[5] << 8) |
                  ((uint32_t)p[6] << 16) | ((uint32_t)p[7] << 24);
    c = g_crc_table[7][c & 0xFF] ^ g_crc_table[6][(c >> 8) & 0xFF] ^
        g_crc_table[5][(c >> 16) & 0xFF] ^ g_crc_table[4][c >> 24] ^
        g_crc_table[3][hi & 0xFF] ^ g_crc_table[2][(hi >> 8) & 0xFF] ^
        g_crc_table[1][(hi >> 16) & 0xFF] ^ g_crc_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = g_crc_table[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return ~c;
}

std::once_flag g_init_once;

void init() {
  std::call_once(g_init_once, [] {
    crc_init();
#if defined(__x86_64__)
    g_have_sse42 = __builtin_cpu_supports("sse4.2");
#endif
  });
}

}  // namespace

extern "C" {

// 1 when crc32c_extend runs the SSE4.2 instruction, 0 for the table loop.
int crc32c_simd() {
  init();
#if defined(__x86_64__)
  return g_have_sse42 ? 1 : 0;
#else
  return 0;
#endif
}

// The CRC of p[0:n] continuing from `value` (google_crc32c.extend).
uint32_t crc32c_extend(uint32_t value, const uint8_t* p, size_t n) {
  init();
#if defined(__x86_64__)
  if (g_have_sse42) return crc32c_hw(value, p, n);
#endif
  return crc32c_sw(value, p, n);
}

// The table loop alone, whatever the CPU has.
uint32_t crc32c_extend_sw(uint32_t value, const uint8_t* p, size_t n) {
  init();
  return crc32c_sw(value, p, n);
}

}  // extern "C"
