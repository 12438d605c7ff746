// Native HTTP write plane for the volume server — the C++ sibling of
// read_plane.cc on the WRITE side: a single-threaded epoll loop owning
// the needle-append hot path (`POST /<vid>,<fid>` with a
// Content-Length body), bypassing the Python HTTP stack entirely.
// arXiv:1709.05365's finding is that online-EC object stores bottleneck
// on host-side per-request CPU, not codec math; this plane removes the
// ~5 ms of per-request Python (HTTP machinery, json, GIL convoys) a
// stage decomposition measured on the volume server.
//
// Ownership contract: while a volume is registered here, this library
// owns the .dat TAIL.  Both the plane's HTTP appends and the Python
// server's own appends (replication, overwrites, tombstones, raw
// repair writes) go through the same per-volume mutex (`wp_append`),
// so records never interleave.  Completed native appends are journaled
// per volume; the Python side drains the journal (`wp_drain`) into its
// NeedleMap + .idx under the volume lock — the .dat is the WAL, the
// .idx a checkpoint, and crash recovery replays the unindexed .dat
// tail (storage/volume.py _replay_dat_tail).
//
// Scope (deliberate): PLAIN anonymous needles only — no name, no mime
// beyond octet-stream, no TTL volume, version-3 volumes, replication
// 000.  Anything else answers 404 and the client falls back to the
// Python port (the read plane's exact fallback contract).  A needle id
// the plane has already seen also 404s: overwrite semantics (cookie
// check, unchanged dedup) stay in Python.
//
// Durability: the ack contract of util/group_commit holds across the
// boundary.  write(2) puts the record in the page cache before the ack
// is queued — SIGKILL-durable, byte-for-byte what the Python barrier's
// flush() guarantees.  On the -fsync tier acks PARK on a flush epoch:
// the Python handshake thread (server/write_plane.py) runs the
// volume's CommitBarrier (one os.fsync per epoch window — group commit
// across the language boundary) and releases the epoch; only then do
// the parked 201s leave the socket.
//
// Build: g++ -O2 -shared -fPIC (no deps); driven via ctypes from
// seaweedfs_tpu_torch/server/write_plane.py.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---- crc32c (Castagnoli, reflected — storage/crc.py parity) ----------

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

uint32_t crc32c(const uint8_t* p, size_t n) {
#if defined(__x86_64__)
  if (g_have_sse42) return crc32c_hw(0, p, n);
#endif
  return crc32c_sw(0, p, n);
}

// ---- on-disk record constants (storage/types.py parity) --------------

constexpr size_t kHeaderSize = 16;     // cookie(4) id(8) size(4)
constexpr size_t kChecksumSize = 4;
constexpr size_t kTimestampSize = 8;   // v3 AppendAtNs
constexpr size_t kPadding = 8;
constexpr uint8_t kFlagHasLastModified = 0x08;
constexpr size_t kLastModifiedLen = 5;
constexpr size_t kMaxBody = 64ull << 20;

inline void put32(std::string& b, uint32_t v) {
  char t[4] = {(char)(v >> 24), (char)(v >> 16), (char)(v >> 8),
               (char)v};
  b.append(t, 4);
}

inline void put64(std::string& b, uint64_t v) {
  put32(b, (uint32_t)(v >> 32));
  put32(b, (uint32_t)v);
}

// ---- journal entry handed back to Python -----------------------------

struct WpEntry {
  uint64_t key;
  uint64_t offset;      // absolute byte offset of the record in .dat
  uint64_t append_ns;
  uint32_t vid;
  uint32_t cookie;
  int32_t size;         // on-disk Size field (body size)
  uint32_t data_len;
};

// -- per-request flight records ----------------------------------------
//
// One fixed-width record per request (read_plane.cc's shape) into an
// SPSC overwrite-oldest ring: a ring left undrained never blocks a
// request.

constexpr uint32_t kRecFlagClientRid = 1u;  // rid came off the wire
// wire rid of the plane-minted shape (e.g. "mp00c0ffee-1", forwarded
// by another plane on its upstream hop): not a real client trace id
constexpr uint32_t kRecFlagMintedUpstream = 2u;

inline uint32_t rid_rec_flags(const char* rid, bool client) {
  if (!client) return 0;
  uint32_t f = kRecFlagClientRid;
  if ((rid[0] == 'm' || rid[0] == 'w' || rid[0] == 'r') &&
      rid[1] == 'p' && rid[2] >= '0' && rid[2] <= '9' &&
      rid[3] >= '0' && rid[3] <= '9')
    f |= kRecFlagMintedUpstream;
  return f;
}

struct PlaneRec {
  char rid[40];
  uint64_t start_unix_ns;
  uint64_t stage_ns[4];    // kRecStageNames order
  uint64_t bytes;
  int64_t deadline_ms;     // -1 = absent
  int32_t status;
  int32_t fallback;        // kRecFallbackNames index
  uint32_t flags;
  uint32_t _pad;
};  // 112 bytes

enum {
  kFbNone = 0,
  kFbNotPlain = 1,
  kFbUnregistered = 2,
  kFbSeenKey = 3,
  kFbJournalFull = 4,
  kFbIoError = 5,
};

// The labels of a record's stage and fallback indices.
const char* const kRecStageNames[] = {"recv", "append", "index", "ack"};
const char* const kRecFallbackNames[] = {
    "none", "not_plain", "unregistered", "seen_key", "journal_full",
    "io_error"};

struct RecRing {
  std::vector<PlaneRec> recs;
  uint64_t cap = 0;
  std::atomic<uint64_t> head{0};
  std::atomic<uint64_t> tail{0};
  std::atomic<uint64_t> dropped{0};
};

uint64_t rec_ring_cap_env() {
  const char* v = getenv("SEAWEEDFS_TPU_PLANE_REC_RING");
  if (v != nullptr && *v != '\0') {
    long n = atol(v);
    if (n >= 16 && n <= (1 << 20)) return uint64_t(n);
  }
  return 4096;
}

void rec_push(RecRing* r, const PlaneRec& rec) {
  if (r->cap == 0) return;
  uint64_t h = r->head.load(std::memory_order_relaxed);
  r->recs[h % r->cap] = rec;
  r->head.store(h + 1, std::memory_order_release);
}

int rec_drain(RecRing* r, PlaneRec* out, int cap) {
  if (r->cap == 0 || out == nullptr || cap <= 0) return 0;
  uint64_t h = r->head.load(std::memory_order_acquire);
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  if (h > t + r->cap) {
    r->dropped.fetch_add((h - r->cap) - t, std::memory_order_relaxed);
    t = h - r->cap;
  }
  int n = 0;
  while (t < h && n < cap) out[n++] = r->recs[t++ % r->cap];
  uint64_t h2 = r->head.load(std::memory_order_acquire);
  uint64_t first = t - uint64_t(n);
  if (h2 > first + r->cap) {   // lapped mid-copy: drop torn prefix
    uint64_t torn = h2 - r->cap - first;
    if (torn > uint64_t(n)) torn = uint64_t(n);
    if (torn > 0) {
      memmove(out, out + torn,
              (size_t(n) - size_t(torn)) * sizeof(PlaneRec));
      n -= int(torn);
      r->dropped.fetch_add(torn, std::memory_order_relaxed);
    }
  }
  r->tail.store(t, std::memory_order_relaxed);
  return n;
}

uint64_t rec_dropped(RecRing* r) {
  uint64_t h = r->head.load(std::memory_order_acquire);
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  uint64_t extra = (r->cap != 0 && h > t + r->cap)
                       ? (h - r->cap) - t : 0;
  return r->dropped.load(std::memory_order_relaxed) + extra;
}

struct VolumeState {
  int fd = -1;
  bool armed = false;   // accepts HTTP writes only after wp_arm
  bool fsync_mode = false;
  std::mutex mu;        // serializes appends (HTTP plane + wp_append)
  uint64_t tail = 0;
  uint64_t last_ns = 0;
  uint64_t cur_epoch = 1;      // open fsync-flush window
  bool epoch_requested = false;
  std::unordered_set<uint64_t> keys;
  std::deque<WpEntry> journal;
};

constexpr size_t kJournalCap = 65536;

struct Conn {
  int fd;
  std::string in;
  std::string out;
  bool close_after = false;
  // request-in-progress state
  bool have_headers = false;
  size_t body_need = 0;        // bytes of body still to receive
  std::string req_headers;     // header block of the pending request
  std::string body;
  uint64_t start_ns = 0;
  // fsync parking
  bool parked = false;
  uint32_t parked_vid = 0;
  uint64_t parked_epoch = 0;
  std::string pending;         // staged response, released by epoch
  // flight-record carry (finalized at ack time)
  char rid[40] = {0};
  bool rid_client = false;
  int64_t deadline_ms = -1;
  uint64_t rec_recv_ns = 0;
  uint64_t rec_append_ns = 0;
  uint64_t rec_index_ns = 0;
  uint64_t rec_bytes = 0;
};

// ack latency histogram bucket bounds, microseconds
constexpr uint64_t kLatBuckets[] = {1,    2,     5,     10,    20,
                                    50,   100,   200,   500,   1000,
                                    2000, 5000,  10000, 20000, 50000,
                                    100000, 1000000};
constexpr int kNumLat = sizeof(kLatBuckets) / sizeof(kLatBuckets[0]);

struct Server {
  int epfd = -1;
  int listen_fd = -1;
  int wake_pipe[2] = {-1, -1};
  std::thread loop;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> requests{0};
  std::atomic<uint64_t> fallbacks{0};
  std::atomic<uint64_t> lat_count[kNumLat + 1];
  std::atomic<uint64_t> lat_sum_ns{0};
  std::shared_mutex reg_mu;    // guards the volumes map structure
  std::unordered_map<uint32_t, VolumeState*> volumes;
  std::unordered_map<int, Conn*> conns;
  // fsync-epoch handshake (Python side: wp_wait_epoch/wp_epoch_done)
  std::mutex ep_mu;
  std::condition_variable ep_cv;
  std::deque<std::pair<uint32_t, uint64_t>> ep_requests;
  std::deque<std::pair<uint32_t, uint64_t>> ep_done;  // loop applies
  // per-request flight records
  RecRing rec;
  uint64_t rid_seq = 0;        // event-loop thread only
  char rid_prefix[16] = {0};
};

constexpr int kMaxServers = 16;
Server* g_servers[kMaxServers] = {nullptr};
std::mutex g_servers_mu;
std::once_flag g_init_once;

uint64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

uint64_t mono_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

void note_latency(Server* s, uint64_t ns) {
  uint64_t us = ns / 1000;
  int i = 0;
  while (i < kNumLat && us > kLatBuckets[i]) i++;
  s->lat_count[i].fetch_add(1, std::memory_order_relaxed);
  s->lat_sum_ns.fetch_add(ns, std::memory_order_relaxed);
}

// append one flight record framed off the conn; ack = total residual
void rec_emit(Server* s, Conn* c, uint64_t total_ns, int status,
              int fallback) {
  PlaneRec r{};
  snprintf(r.rid, sizeof(r.rid), "%s", c->rid);
  r.start_unix_ns = now_ns() - total_ns;
  r.stage_ns[0] = c->rec_recv_ns;
  r.stage_ns[1] = c->rec_append_ns;
  r.stage_ns[2] = c->rec_index_ns;
  uint64_t sum = c->rec_recv_ns + c->rec_append_ns + c->rec_index_ns;
  r.stage_ns[3] = total_ns > sum ? total_ns - sum : 0;
  r.bytes = c->rec_bytes;
  r.deadline_ms = c->deadline_ms;
  r.status = status;
  r.fallback = fallback;
  r.flags = rid_rec_flags(c->rid, c->rid_client);
  rec_push(&s->rec, r);
}

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void close_conn(Server* s, Conn* c) {
  epoll_ctl(s->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  close(c->fd);
  s->conns.erase(c->fd);
  delete c;
}

void arm(Server* s, Conn* c, bool want_write) {
  epoll_event ev{};
  ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0);
  ev.data.fd = c->fd;
  epoll_ctl(s->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

// parse "<vid>,<keyhex><cookie8hex>" (read_plane.cc parity)
bool parse_fid(const char* p, size_t n, uint32_t* vid, uint64_t* key,
               uint32_t* cookie) {
  size_t comma = 0;
  while (comma < n && p[comma] != ',') comma++;
  if (comma == 0 || comma >= n) return false;
  uint64_t v = 0;
  for (size_t i = 0; i < comma; i++) {
    if (p[i] < '0' || p[i] > '9') return false;
    v = v * 10 + (p[i] - '0');
    if (v > 0xffffffffULL) return false;
  }
  const char* hex = p + comma + 1;
  size_t hn = n - comma - 1;
  if (hn < 9 || hn > 24) return false;
  uint64_t k = 0;
  uint64_t ck = 0;
  for (size_t i = 0; i < hn; i++) {
    char ch = hex[i];
    int d;
    if (ch >= '0' && ch <= '9') d = ch - '0';
    else if (ch >= 'a' && ch <= 'f') d = ch - 'a' + 10;
    else if (ch >= 'A' && ch <= 'F') d = ch - 'A' + 10;
    else return false;
    if (i < hn - 8) k = (k << 4) | d;
    else ck = (ck << 4) | d;
  }
  *vid = (uint32_t)v;
  *key = k;
  *cookie = (uint32_t)ck;
  return true;
}

void respond(Conn* c, std::string& sink, const char* status,
             const std::string& body) {
  char hdr[160];
  int n = snprintf(hdr, sizeof hdr,
                   "HTTP/1.1 %s\r\n"
                   "Content-Type: application/json\r\n"
                   "Content-Length: %zu\r\n\r\n",
                   status, body.size());
  sink.append(hdr, n);
  sink.append(body);
  (void)c;
}

// case-insensitive header lookup inside a raw header block
std::string header_value(const std::string& block, const char* name) {
  size_t nl = strlen(name);
  size_t pos = 0;
  while (pos < block.size()) {
    size_t eol = block.find("\r\n", pos);
    if (eol == std::string::npos) eol = block.size();
    if (eol - pos > nl + 1 && block[pos + nl] == ':' &&
        strncasecmp(block.data() + pos, name, nl) == 0) {
      size_t v = pos + nl + 1;
      while (v < eol && (block[v] == ' ' || block[v] == '\t')) v++;
      return block.substr(v, eol - v);
    }
    pos = eol + 2;
  }
  return "";
}

// does the query string carry the given key? ("name" in "?name=x&y=z")
bool query_has(const std::string& q, const char* key) {
  size_t kl = strlen(key);
  size_t pos = 0;
  while (pos < q.size()) {
    size_t amp = q.find('&', pos);
    if (amp == std::string::npos) amp = q.size();
    if (amp - pos > kl && q[pos + kl] == '=' &&
        q.compare(pos, kl, key) == 0)
      return true;
    pos = amp + 1;
  }
  return false;
}

uint64_t query_u64(const std::string& q, const char* key) {
  size_t kl = strlen(key);
  size_t pos = 0;
  while (pos < q.size()) {
    size_t amp = q.find('&', pos);
    if (amp == std::string::npos) amp = q.size();
    if (amp - pos > kl && q[pos + kl] == '=' &&
        q.compare(pos, kl, key) == 0) {
      uint64_t v = 0;
      for (size_t i = pos + kl + 1; i < amp; i++) {
        if (q[i] < '0' || q[i] > '9') return 0;
        v = v * 10 + (q[i] - '0');
      }
      return v;
    }
    pos = amp + 1;
  }
  return 0;
}

// serialize + append one plain needle record; returns byte offset or
// -1.  Caller holds NO locks; takes the volume mutex itself.
// On success fills *out (journaled under the same mutex).
bool append_plain(Server* s, VolumeState* vol, uint32_t vid,
                  uint64_t key, uint32_t cookie, const uint8_t* data,
                  size_t len, uint64_t last_modified, WpEntry* out,
                  bool* journal_full, uint64_t* append_ns_out,
                  uint64_t* index_ns_out) {
  uint64_t t_enter = mono_ns();
  // Size field: DataSize(4) + data + flags(1) + lastModified(5)
  int32_t size = (int32_t)(4 + len + 1 + kLastModifiedLen);
  uint32_t crc = crc32c(data, len);
  std::string rec;
  rec.reserve(kHeaderSize + size + kChecksumSize + kTimestampSize +
              kPadding);
  put32(rec, cookie);
  put64(rec, key);
  put32(rec, (uint32_t)size);
  put32(rec, (uint32_t)len);
  rec.append((const char*)data, len);
  rec.push_back((char)kFlagHasLastModified);
  // LastModified: low 5 bytes, big-endian
  char lm[kLastModifiedLen] = {
      (char)(last_modified >> 32), (char)(last_modified >> 24),
      (char)(last_modified >> 16), (char)(last_modified >> 8),
      (char)last_modified};
  rec.append(lm, kLastModifiedLen);
  put32(rec, crc);
  size_t ns_pos = rec.size();      // AppendAtNs patched under the lock
  put64(rec, 0);
  // v3 padding quirk (needle.py to_bytes): pads 8 when aligned, stale
  // bytes re-expose the big-endian Size field then zeros
  size_t pad = kPadding - ((kHeaderSize + (size_t)size +
                            kChecksumSize + kTimestampSize) % kPadding);
  char stale[8] = {(char)((uint32_t)size >> 24),
                   (char)((uint32_t)size >> 16),
                   (char)((uint32_t)size >> 8), (char)(uint32_t)size,
                   0, 0, 0, 0};
  rec.append(stale, pad);

  std::lock_guard<std::mutex> lk(vol->mu);
  if (vol->journal.size() >= kJournalCap) {
    *journal_full = true;
    return false;           // backpressure: fall back to Python
  }
  uint64_t ns = now_ns();
  if (ns <= vol->last_ns) ns = vol->last_ns + 1;
  vol->last_ns = ns;
  char nsb[8] = {(char)(ns >> 56), (char)(ns >> 48), (char)(ns >> 40),
                 (char)(ns >> 32), (char)(ns >> 24), (char)(ns >> 16),
                 (char)(ns >> 8), (char)ns};
  memcpy(&rec[ns_pos], nsb, 8);
  uint64_t off = vol->tail;
  if (off % kPadding) {            // realign a corrupt tail
    size_t fix = kPadding - (off % kPadding);
    char zeros[8] = {0};
    if (pwrite(vol->fd, zeros, fix, (off_t)off) != (ssize_t)fix)
      return false;
    off += fix;
  }
  const char* p = rec.data();
  size_t left = rec.size();
  off_t at = (off_t)off;
  while (left > 0) {
    ssize_t w = pwrite(vol->fd, p, left, at);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return false;                // ENOSPC/EBADF: fall back
    }
    p += w;
    at += w;
    left -= (size_t)w;
  }
  vol->tail = off + rec.size();
  uint64_t t_written = mono_ns();
  vol->keys.insert(key);
  out->key = key;
  out->offset = off;
  out->append_ns = ns;
  out->vid = vid;
  out->cookie = cookie;
  out->size = size;
  out->data_len = (uint32_t)len;
  vol->journal.push_back(*out);
  if (append_ns_out != nullptr) *append_ns_out = t_written - t_enter;
  if (index_ns_out != nullptr) *index_ns_out = mono_ns() - t_written;
  (void)s;
  return true;
}

// handle one complete request (headers in c->req_headers, body in
// c->body).  Appends the response to c->out, or parks it on an fsync
// epoch.  Returns false when the connection must close.
bool handle_request(Server* s, Conn* c) {
  c->rec_recv_ns = mono_ns() - c->start_ns;   // body-receive window
  c->rec_append_ns = 0;
  c->rec_index_ns = 0;
  c->rec_bytes = c->body.size();
  const std::string& req = c->req_headers;
  size_t sp1 = req.find(' ');
  size_t sp2 = (sp1 == std::string::npos) ? std::string::npos
                                          : req.find(' ', sp1 + 1);
  if (sp2 == std::string::npos) return false;
  std::string method = req.substr(0, sp1);
  std::string target = req.substr(sp1 + 1, sp2 - sp1 - 1);
  if (method != "POST" && method != "PUT") {
    respond(c, c->out, "405 Method Not Allowed",
            "{\"error\":\"write plane accepts POST only\"}");
    rec_emit(s, c, mono_ns() - c->start_ns, 405, kFbNotPlain);
    return true;
  }
  std::string query;
  size_t q = target.find('?');
  if (q != std::string::npos) {
    query = target.substr(q + 1);
    target.resize(q);
  }
  uint32_t vid, cookie;
  uint64_t key;
  bool plain = !target.empty() && target[0] == '/' &&
               parse_fid(target.data() + 1, target.size() - 1, &vid,
                         &key, &cookie);
  // non-plain request shapes stay on the Python port: named uploads,
  // real mimes, authenticated writes, replication fan-in
  if (plain) {
    if (query_has(query, "name") || query_has(query, "type")) plain = false;
    std::string ctype = header_value(c->req_headers, "Content-Type");
    if (!ctype.empty() && ctype != "application/octet-stream" &&
        ctype.compare(0, 19, "multipart/form-data") != 0)
      plain = false;
    if (!header_value(c->req_headers, "Authorization").empty())
      plain = false;
    if (c->body.empty()) plain = false;   // 0-byte needles never map
  }
  WpEntry ent{};
  bool parked = false;
  int fb = kFbNotPlain;
  if (plain) {
    std::shared_lock<std::shared_mutex> reg(s->reg_mu);
    auto it = s->volumes.find(vid);
    VolumeState* vol =
        (it == s->volumes.end()) ? nullptr : it->second;
    fb = vol == nullptr ? kFbUnregistered : fb;
    if (vol != nullptr) {
      {
        std::lock_guard<std::mutex> lk(vol->mu);
        // unarmed = registered but keys not yet marked (the attach
        // is mid-handshake): accepting a write here could let an
        // overwrite of an existing key bypass Python's cookie check
        if (!vol->armed || vol->keys.count(key)) {
          vol = nullptr;
          fb = kFbSeenKey;
        }
      }
      if (vol != nullptr) {
        uint64_t ts = query_u64(query, "ts");
        if (ts == 0) ts = now_ns() / 1000000000ull;
        bool journal_full = false;
        if (append_plain(s, vol, vid, key, cookie,
                         (const uint8_t*)c->body.data(),
                         c->body.size(), ts, &ent, &journal_full,
                         &c->rec_append_ns, &c->rec_index_ns)) {
          char body[128];
          int n = snprintf(body, sizeof body,
                           "{\"name\":\"\",\"size\":%zu,"
                           "\"eTag\":\"%08x\",\"unchanged\":false}",
                           c->body.size(),
                           crc32c((const uint8_t*)c->body.data(),
                                  c->body.size()));
          std::string resp;
          respond(c, resp, "201 Created", std::string(body, n));
          s->requests.fetch_add(1, std::memory_order_relaxed);
          if (vol->fsync_mode) {
            // park the ack on the volume's open flush epoch; the
            // Python handshake runs the CommitBarrier and releases it
            std::lock_guard<std::mutex> lk(vol->mu);
            c->parked = true;
            c->parked_vid = vid;
            c->parked_epoch = vol->cur_epoch;
            c->pending = std::move(resp);
            parked = true;
            if (!vol->epoch_requested) {
              vol->epoch_requested = true;
              std::lock_guard<std::mutex> el(s->ep_mu);
              s->ep_requests.emplace_back(vid, vol->cur_epoch);
              s->ep_cv.notify_all();
            }
          } else {
            c->out.append(resp);
            uint64_t total = mono_ns() - c->start_ns;
            note_latency(s, total);
            rec_emit(s, c, total, 201, kFbNone);
          }
          c->body.clear();
          c->body.shrink_to_fit();
          (void)parked;
          return true;
        }
        fb = journal_full ? kFbJournalFull : kFbIoError;
      }
    }
  }
  // fallback: the Python port owns this write
  s->fallbacks.fetch_add(1, std::memory_order_relaxed);
  respond(c, c->out, "404 Not Found",
          "{\"error\":\"write plane fallback\"}");
  rec_emit(s, c, mono_ns() - c->start_ns, 404, fb);
  c->body.clear();
  c->body.shrink_to_fit();
  return true;
}

bool flush_out(Server* s, Conn* c) {
  while (!c->out.empty()) {
    ssize_t n = send(c->fd, c->out.data(), c->out.size(), MSG_NOSIGNAL);
    if (n > 0) {
      c->out.erase(0, (size_t)n);
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return true;
    return false;
  }
  (void)s;
  return true;
}

// consume buffered input into requests; false closes the connection
bool feed(Server* s, Conn* c) {
  for (;;) {
    if (c->parked) return true;  // strictly serial while an ack parks
    if (!c->have_headers) {
      size_t end = c->in.find("\r\n\r\n");
      if (end == std::string::npos)
        return c->in.size() <= (64 << 10);  // header flood guard
      c->req_headers = c->in.substr(0, end);
      c->in.erase(0, end + 4);
      c->have_headers = true;
      c->start_ns = mono_ns();
      std::string rv = header_value(c->req_headers, "X-Request-ID");
      if (!rv.empty()) {
        snprintf(c->rid, sizeof(c->rid), "%.39s", rv.c_str());
        c->rid_client = true;
      } else {
        snprintf(c->rid, sizeof(c->rid), "%s-%llx", s->rid_prefix,
                 (unsigned long long)(++s->rid_seq));
        c->rid_client = false;
      }
      std::string dv =
          header_value(c->req_headers, "X-Weed-Deadline-Ms");
      c->deadline_ms = dv.empty() ? -1 : atoll(dv.c_str());
      std::string te = header_value(c->req_headers,
                                    "Transfer-Encoding");
      if (!te.empty()) return false;       // chunked: Python port
      std::string cl = header_value(c->req_headers, "Content-Length");
      uint64_t need = 0;
      for (char ch : cl) {
        if (ch < '0' || ch > '9') { need = 0; break; }
        need = need * 10 + (uint64_t)(ch - '0');
      }
      if (need > kMaxBody) return false;   // oversized: close
      c->body_need = (size_t)need;
      c->body.clear();
      c->body.reserve(c->body_need);
    }
    if (c->body_need > 0) {
      size_t take = c->in.size() < c->body_need ? c->in.size()
                                                : c->body_need;
      c->body.append(c->in, 0, take);
      c->in.erase(0, take);
      c->body_need -= take;
      if (c->body_need > 0) return true;   // await more body bytes
    }
    c->have_headers = false;
    if (!handle_request(s, c)) return false;
  }
}

void release_epochs(Server* s) {
  std::deque<std::pair<uint32_t, uint64_t>> done;
  {
    std::lock_guard<std::mutex> el(s->ep_mu);
    done.swap(s->ep_done);
  }
  if (done.empty()) return;
  for (auto& kv : s->conns) {
    Conn* c = kv.second;
    if (!c->parked) continue;
    for (auto& d : done) {
      if (c->parked_vid == d.first && c->parked_epoch <= d.second) {
        c->parked = false;
        c->out.append(c->pending);
        c->pending.clear();
        uint64_t total = mono_ns() - c->start_ns;
        note_latency(s, total);
        rec_emit(s, c, total, 201, kFbNone);
        break;
      }
    }
  }
  // a released conn may have both pending output and buffered input
  std::vector<Conn*> dead;
  for (auto& kv : s->conns) {
    Conn* c = kv.second;
    if (c->parked || (c->out.empty() && c->in.empty())) continue;
    bool ok = feed(s, c) && flush_out(s, c);
    if (!ok) dead.push_back(c);
    else arm(s, c, !c->out.empty());
  }
  for (Conn* c : dead) close_conn(s, c);
}

void event_loop(Server* s) {
  epoll_event evs[64];
  while (!s->stop.load(std::memory_order_relaxed)) {
    int n = epoll_wait(s->epfd, evs, 64, 200);
    // NOTE: epoch releases run AFTER the event batch below — a
    // close_conn here could free an fd that accept4 reuses later in
    // the same batch, making a stale evs[] entry poison the fresh
    // connection (the wake pipe guarantees another epoll cycle runs
    // promptly, so releases are not delayed in practice)
    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      if (fd == s->wake_pipe[0]) {
        char tmp[16];
        (void)!read(fd, tmp, sizeof tmp);
        continue;
      }
      if (fd == s->listen_fd) {
        for (;;) {
          int cfd = accept4(s->listen_fd, nullptr, nullptr,
                            SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          Conn* c = new Conn{cfd};
          s->conns[cfd] = c;
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(s->epfd, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      auto it = s->conns.find(fd);
      if (it == s->conns.end()) continue;
      Conn* c = it->second;
      bool dead = false;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) dead = true;
      if (!dead && (evs[i].events & EPOLLIN)) {
        char buf[65536];
        for (;;) {
          ssize_t r = recv(fd, buf, sizeof buf, 0);
          if (r > 0) {
            c->in.append(buf, (size_t)r);
            continue;
          }
          if (r == 0) {
            dead = c->in.empty() && c->out.empty() && !c->parked;
            c->close_after = true;
            break;
          }
          if (errno == EAGAIN || errno == EWOULDBLOCK) break;
          dead = true;
          break;
        }
        if (!dead && !feed(s, c)) dead = true;
      }
      if (!dead && !flush_out(s, c)) dead = true;
      if (!dead && c->close_after && c->out.empty() && !c->parked)
        dead = true;
      if (dead) close_conn(s, c);
      else arm(s, c, !c->out.empty());
    }
    release_epochs(s);
  }
  for (auto& kv : s->conns) {
    close(kv.second->fd);
    delete kv.second;
  }
  s->conns.clear();
}

Server* get_server(int h) {
  std::lock_guard<std::mutex> lk(g_servers_mu);
  if (h < 0 || h >= kMaxServers) return nullptr;
  return g_servers[h];
}

}  // namespace

extern "C" {

int wp_start(const char* host, int port, int* bound_port) {
  std::call_once(g_init_once, [] {
    crc_init();
#if defined(__x86_64__)
    g_have_sse42 = __builtin_cpu_supports("sse4.2");
#endif
  });
  int slot = -1;
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    for (int i = 0; i < kMaxServers; i++) {
      if (g_servers[i] == nullptr) {
        slot = i;
        break;
      }
    }
    if (slot < 0) return -1;
    g_servers[slot] = new Server();
  }
  Server* s = g_servers[slot];
  for (int i = 0; i <= kNumLat; i++) s->lat_count[i].store(0);
  s->rec.cap = rec_ring_cap_env();
  s->rec.recs.resize(s->rec.cap);
  snprintf(s->rid_prefix, sizeof(s->rid_prefix), "wp%02d%06llx", slot,
           (unsigned long long)(now_ns() & 0xffffff));
  s->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (s->listen_fd < 0) return -1;
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) return -1;
  if (bind(s->listen_fd, (sockaddr*)&addr, sizeof addr) < 0 ||
      listen(s->listen_fd, 1024) < 0) {
    close(s->listen_fd);
    return -1;
  }
  socklen_t alen = sizeof addr;
  getsockname(s->listen_fd, (sockaddr*)&addr, &alen);
  *bound_port = ntohs(addr.sin_port);
  s->epfd = epoll_create1(0);
  if (pipe2(s->wake_pipe, O_NONBLOCK) < 0) return -1;
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = s->listen_fd;
  epoll_ctl(s->epfd, EPOLL_CTL_ADD, s->listen_fd, &ev);
  ev.data.fd = s->wake_pipe[0];
  epoll_ctl(s->epfd, EPOLL_CTL_ADD, s->wake_pipe[0], &ev);
  s->loop = std::thread(event_loop, s);
  return slot;
}

void wp_stop(int h) {
  Server* s;
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    if (h < 0 || h >= kMaxServers || g_servers[h] == nullptr) return;
    s = g_servers[h];
    g_servers[h] = nullptr;
  }
  s->stop.store(true);
  (void)!write(s->wake_pipe[1], "x", 1);
  {
    // unblock a parked wp_wait_epoch
    std::lock_guard<std::mutex> el(s->ep_mu);
    s->ep_cv.notify_all();
  }
  s->loop.join();
  close(s->listen_fd);
  close(s->epfd);
  close(s->wake_pipe[0]);
  close(s->wake_pipe[1]);
  {
    std::unique_lock<std::shared_mutex> lk(s->reg_mu);
    for (auto& kv : s->volumes) {
      if (kv.second->fd >= 0) close(kv.second->fd);
      delete kv.second;
    }
    s->volumes.clear();
  }
  delete s;
}

int wp_add_volume(int h, unsigned vid, const char* dat_path,
                  unsigned long long tail, unsigned long long last_ns,
                  int fsync_mode) {
  Server* s = get_server(h);
  if (s == nullptr) return -1;
  int fd = open(dat_path, O_RDWR);
  if (fd < 0) return -1;
  std::unique_lock<std::shared_mutex> lk(s->reg_mu);
  auto it = s->volumes.find(vid);
  if (it != s->volumes.end()) {
    // refresh: close the stale fd, keep journal drained separately.
    // Disarmed until wp_arm: the caller re-marks the key set first,
    // and a write accepted in between would skip the overwrite check.
    std::lock_guard<std::mutex> vl(it->second->mu);
    if (it->second->fd >= 0) close(it->second->fd);
    it->second->fd = fd;
    it->second->tail = tail;
    it->second->last_ns = last_ns;
    it->second->fsync_mode = fsync_mode != 0;
    it->second->armed = false;
    it->second->keys.clear();
    return 0;
  }
  VolumeState* v = new VolumeState();
  v->fd = fd;
  v->tail = tail;
  v->last_ns = last_ns;
  v->fsync_mode = fsync_mode != 0;
  s->volumes[vid] = v;
  return 0;
}

// open the volume for native HTTP writes — called AFTER wp_mark_keys
// so the seen-key fallback set is complete before the first accept
int wp_arm(int h, unsigned vid) {
  Server* s = get_server(h);
  if (s == nullptr) return -1;
  std::shared_lock<std::shared_mutex> reg(s->reg_mu);
  auto it = s->volumes.find(vid);
  if (it == s->volumes.end()) return -1;
  std::lock_guard<std::mutex> lk(it->second->mu);
  it->second->armed = true;
  return 0;
}

int wp_mark_keys(int h, unsigned vid, const unsigned long long* keys,
                 int n) {
  Server* s = get_server(h);
  if (s == nullptr) return -1;
  std::shared_lock<std::shared_mutex> reg(s->reg_mu);
  auto it = s->volumes.find(vid);
  if (it == s->volumes.end()) return -1;
  std::lock_guard<std::mutex> lk(it->second->mu);
  it->second->keys.reserve(it->second->keys.size() + (size_t)n);
  for (int i = 0; i < n; i++) it->second->keys.insert(keys[i]);
  return 0;
}

void wp_remove_volume(int h, unsigned vid) {
  Server* s = get_server(h);
  if (s == nullptr) return;
  VolumeState* v = nullptr;
  {
    std::unique_lock<std::shared_mutex> lk(s->reg_mu);
    auto it = s->volumes.find(vid);
    if (it == s->volumes.end()) return;
    v = it->second;
    s->volumes.erase(it);
  }
  // every in-flight append/drain holds reg_mu shared across its
  // volume-mutex window; the unique_lock above waited them out, so v
  // is exclusively ours now
  std::deque<WpEntry> leftover;
  {
    std::lock_guard<std::mutex> lk(v->mu);
    if (v->fd >= 0) close(v->fd);
    v->fd = -1;
    leftover.swap(v->journal);
  }
  if (leftover.empty()) {
    delete v;
    return;
  }
  // undrained journal entries must stay reachable (they are .idx
  // records Python has not applied yet): park them in an orphan slot
  // (high bit set — the wrapper never registers vids that large)
  std::unique_lock<std::shared_mutex> lk(s->reg_mu);
  auto ins = s->volumes.emplace((unsigned)0x80000000u | vid, v);
  if (!ins.second) {
    // an orphan from an earlier detach still drains: append there
    std::lock_guard<std::mutex> ol(ins.first->second->mu);
    for (auto& e : leftover) ins.first->second->journal.push_back(e);
    delete v;
  } else {
    std::lock_guard<std::mutex> vl(v->mu);
    v->journal.swap(leftover);
  }
}

// append a fully-serialized record from the Python side (replication,
// tombstones, overwrites, raw repair writes).  Returns the byte
// offset, or -1 when the volume is not registered / write failed.
long long wp_append(int h, unsigned vid, unsigned long long key,
                    const unsigned char* rec, unsigned long long len,
                    unsigned long long append_ns) {
  Server* s = get_server(h);
  if (s == nullptr) return -1;
  std::shared_lock<std::shared_mutex> reg(s->reg_mu);
  auto it = s->volumes.find(vid);
  if (it == s->volumes.end() || it->second->fd < 0) return -1;
  VolumeState* v = it->second;
  std::lock_guard<std::mutex> lk(v->mu);
  uint64_t off = v->tail;
  if (off % kPadding) {
    size_t fix = kPadding - (off % kPadding);
    char zeros[8] = {0};
    if (pwrite(v->fd, zeros, fix, (off_t)off) != (ssize_t)fix)
      return -1;
    off += fix;
  }
  const unsigned char* p = rec;
  size_t left = (size_t)len;
  off_t at = (off_t)off;
  while (left > 0) {
    ssize_t w = pwrite(v->fd, p, left, at);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return -1;
    }
    p += w;
    at += w;
    left -= (size_t)w;
  }
  v->tail = off + len;
  v->keys.insert(key);
  if (append_ns > v->last_ns) v->last_ns = append_ns;
  return (long long)off;
}

int wp_drain(int h, unsigned vid, WpEntry* out, int cap) {
  Server* s = get_server(h);
  if (s == nullptr) return 0;
  int n = 0;
  bool orphan_drained = false;
  for (unsigned slot : {vid, 0x80000000u | vid}) {
    // hold reg_mu shared across the volume-mutex window — the remove
    // path's unique_lock is what guarantees v stays alive here
    std::shared_lock<std::shared_mutex> reg(s->reg_mu);
    auto it = s->volumes.find(slot);
    if (it == s->volumes.end()) continue;
    VolumeState* v = it->second;
    std::lock_guard<std::mutex> lk(v->mu);
    while (n < cap && !v->journal.empty()) {
      out[n++] = v->journal.front();
      v->journal.pop_front();
    }
    if ((slot & 0x80000000u) && v->journal.empty())
      orphan_drained = true;
  }
  if (orphan_drained) {
    // reap the empty orphan under the exclusive registry lock (same
    // lock order as remove: reg_mu then volume mutex)
    std::unique_lock<std::shared_mutex> reg(s->reg_mu);
    auto it = s->volumes.find(0x80000000u | vid);
    if (it != s->volumes.end()) {
      VolumeState* v = it->second;
      bool empty;
      {
        std::lock_guard<std::mutex> lk(v->mu);
        empty = v->journal.empty();
      }
      if (empty) {
        s->volumes.erase(it);
        delete v;
      }
    }
  }
  return n;
}

int wp_pending(int h, unsigned vid) {
  Server* s = get_server(h);
  if (s == nullptr) return 0;
  int n = 0;
  for (unsigned slot : {vid, 0x80000000u | vid}) {
    std::shared_lock<std::shared_mutex> reg(s->reg_mu);
    auto it = s->volumes.find(slot);
    if (it == s->volumes.end()) continue;
    std::lock_guard<std::mutex> lk(it->second->mu);
    n += (int)it->second->journal.size();
  }
  return n;
}

unsigned long long wp_tail(int h, unsigned vid) {
  Server* s = get_server(h);
  if (s == nullptr) return 0;
  std::shared_lock<std::shared_mutex> reg(s->reg_mu);
  auto it = s->volumes.find(vid);
  if (it == s->volumes.end()) return 0;
  std::lock_guard<std::mutex> lk(it->second->mu);
  return it->second->tail;
}

// fsync-epoch handshake: block (up to timeout_ms) for a flush request,
// returning 1 with (*vid, *epoch) filled, 0 on timeout/stop.
int wp_wait_epoch(int h, int timeout_ms, unsigned* vid,
                  unsigned long long* epoch) {
  Server* s = get_server(h);
  if (s == nullptr) return 0;
  std::unique_lock<std::mutex> lk(s->ep_mu);
  if (!s->ep_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                         [s] { return !s->ep_requests.empty() ||
                                      s->stop.load(); }))
    return 0;
  if (s->ep_requests.empty()) return 0;
  auto req = s->ep_requests.front();
  s->ep_requests.pop_front();
  lk.unlock();
  // close the volume's epoch window so later appends park on the next
  {
    std::shared_lock<std::shared_mutex> reg(s->reg_mu);
    auto it = s->volumes.find(req.first);
    if (it != s->volumes.end()) {
      std::lock_guard<std::mutex> vl(it->second->mu);
      if (it->second->cur_epoch == req.second) {
        it->second->cur_epoch = req.second + 1;
        it->second->epoch_requested = false;
      }
    }
  }
  *vid = req.first;
  *epoch = req.second;
  return 1;
}

void wp_epoch_done(int h, unsigned vid, unsigned long long epoch) {
  Server* s = get_server(h);
  if (s == nullptr) return;
  {
    std::lock_guard<std::mutex> el(s->ep_mu);
    s->ep_done.emplace_back(vid, epoch);
  }
  (void)!write(s->wake_pipe[1], "x", 1);
}

unsigned long long wp_requests(int h) {
  Server* s = get_server(h);
  return s == nullptr ? 0 : s->requests.load();
}

unsigned long long wp_fallbacks(int h) {
  Server* s = get_server(h);
  return s == nullptr ? 0 : s->fallbacks.load();
}

// latency snapshot: out[0..17] = cumulative bucket counts (le 1us..1s,
// +inf), out[18] = total acks, out[19] = sum of ack ns
int wp_latency(int h, unsigned long long* out) {
  Server* s = get_server(h);
  if (s == nullptr) return 0;
  uint64_t total = 0;
  for (int i = 0; i <= kNumLat; i++) {
    total += s->lat_count[i].load(std::memory_order_relaxed);
    out[i] = total;          // cumulative, Prometheus-style
  }
  out[kNumLat + 1] = total;
  out[kNumLat + 2] = s->lat_sum_ns.load(std::memory_order_relaxed);
  return kNumLat + 1;        // bucket cells written
}

// drain up to `cap` per-request flight records (oldest first; the
// Python side serializes drainers with a lock)
int wp_drain_records(int h, PlaneRec* out, int cap) {
  Server* s = get_server(h);
  if (s == nullptr) return -1;
  return rec_drain(&s->rec, out, cap);
}

unsigned long long wp_records_dropped(int h) {
  Server* s = get_server(h);
  return s != nullptr ? rec_dropped(&s->rec) : 0;
}

}  // extern "C"
