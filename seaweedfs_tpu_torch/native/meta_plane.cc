// Native filer META plane, the port's copy of
// `seaweedfs_tpu/native/meta_plane.cc` — the C++ sibling of
// write_plane.cc, one layer up: a single-threaded epoll HTTP front
// that serves the filer's hot write path with ZERO Python per
// request:
//
//   HTTP parse -> eligibility -> pre-assigned fid pop -> chunk upload
//   (pipelined C++->C++ to the volume write plane) -> entry JSON ->
//   metalog WAL line framing -> group-commit batch append (ONE
//   O_APPEND write per segment run per epoll iteration) -> watermark
//   publish -> 201 ack.
//
// The WAL line is byte-identical to filer/meta_log.py append_raw:
//
//   {"nl":LEN,"wid":"WID","op":"create","tsNs":TS,
//    "oldEntry":null,"newEntry":ENTRY}\n
//
// so the Python meta plane (filer/meta_plane.py: flock-elected applier, overlay
// followers, checkpointing) consumes these lines exactly as it
// consumes a sibling Python filer's.  This plane is, by protocol, just
// another sibling writer over the shared metalog dir: its own wid, its
// own watermark file, O_APPEND whole-batch interleave.
//
// Anything the hot path cannot prove cheap and safe — unknown parent
// directory, possible overwrite, query string, auth, multi-chunk body,
// exotic bytes in the path, empty fid pool, disarmed — answers
// 404 {"error":"meta plane fallback"} and the client retries against
// the Python filer port (the volume planes' fallback contract).
//
// Directory knowledge is fed from Python (mp_mark_dir on every fresh
// directory create, mp_mark_path on every Python-path entry event), so
// the plane only ever acks op="create" for paths that provably did not
// exist: the parent dir was created fresh during this plane's
// lifetime and the name was never seen — by Python, a sibling, or
// this plane itself.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <math.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "plane_pool.h"

namespace {

constexpr int kMaxServers = 16;
constexpr size_t kMaxBody = 4u * 1024 * 1024;   // filer CHUNK_SIZE
constexpr size_t kMaxHeaders = 64 * 1024;
constexpr size_t kMaxPath = 512;
constexpr size_t kMaxDirs = 4096;               // Filer._known_dirs_cap
constexpr size_t kMaxChildren = 1u << 20;

uint64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return uint64_t(ts.tv_sec) * 1000000000ull + uint64_t(ts.tv_nsec);
}

uint64_t mono_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return uint64_t(ts.tv_sec) * 1000000000ull + uint64_t(ts.tv_nsec);
}

int set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  if (fl < 0) return -1;
  return fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

// ack latency buckets, mirroring server/write_plane.py ACK_BUCKETS_S
// (seconds): 1e-6 .. 1e-1, 1.0 — stored here in MICROseconds
const uint64_t kLatBuckets[] = {1,      2,      5,      10,     20,
                                50,     100,    200,    500,    1000,
                                2000,   5000,   10000,  20000,  50000,
                                100000, 1000000};
constexpr int kLatN = 17;

// -- per-request flight records ----------------------------------------
//
// Every request — native ack or fallback — appends one fixed-width
// record to an SPSC overwrite-oldest ring; the Python drainer pulls
// them on a tick and feeds the trace/flight-recorder/histogram planes.
// The hot-path cost is one struct copy + one release store.

constexpr uint32_t kRecFlagClientRid = 1u;  // rid came off the wire
// wire rid of the plane-minted shape ("mp00c0ffee-1"): forwarded by
// a sibling plane on its upstream hop, not a real client trace id —
// the drainer keeps these off the per-record span path unless the
// record is independently interesting (error / over threshold)
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
  char rid[40];            // NUL-padded request id
  uint64_t start_unix_ns;  // CLOCK_REALTIME at ingress (approx)
  uint64_t stage_ns[4];    // kRecStageNames order
  uint64_t bytes;          // request body size
  int64_t deadline_ms;     // X-Weed-Deadline-Ms at ingress; -1 absent
  int32_t status;          // HTTP status answered
  int32_t fallback;        // kRecFallbackNames index
  uint32_t flags;          // kRecFlag*
  uint32_t _pad;
};  // 112 bytes, mirrored by native.PlaneRecord (ctypes)

enum {
  kFbNone = 0,
  kFbIneligible = 1,
  kFbFidDry = 2,
  kFbUpstream = 3,
  kFbWal = 4,
  kFbOversize = 5,
  kFbChunked = 6,
};

// The labels of a record's stage and fallback indices
// (server/meta_plane_native.py RECORD_STAGES / RECORD_FALLBACKS).
const char* const kRecStageNames[] = {"parse", "upload", "wal", "ack"};
const char* const kRecFallbackNames[] = {
    "none", "ineligible", "fid_dry", "upstream", "wal", "oversize",
    "chunked"};
const char* const kStatsNames[] = {
    "requests",    "fallbacks", "fid_misses", "wal_errors",
    "upstream_errors", "parse_ns", "upload_ns", "wal_ns",
    "wal_batches", "wal_lines"};

struct RecRing {
  std::vector<PlaneRec> recs;
  uint64_t cap = 0;
  std::atomic<uint64_t> head{0};     // total produced (producer)
  std::atomic<uint64_t> tail{0};     // total consumed (drain thread)
  std::atomic<uint64_t> dropped{0};  // overwritten before drain
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

// single drainer at a time (the Python side serializes with a lock)
int rec_drain(RecRing* r, PlaneRec* out, int cap) {
  if (r->cap == 0 || out == nullptr || cap <= 0) return 0;
  uint64_t h = r->head.load(std::memory_order_acquire);
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  if (h > t + r->cap) {   // producer lapped us: oldest are gone
    r->dropped.fetch_add((h - r->cap) - t, std::memory_order_relaxed);
    t = h - r->cap;
  }
  int n = 0;
  while (t < h && n < cap) out[n++] = r->recs[t++ % r->cap];
  // the producer may have lapped the slots mid-copy — the torn
  // prefix (oldest copied entries) is dropped, never handed over
  uint64_t h2 = r->head.load(std::memory_order_acquire);
  uint64_t first = t - uint64_t(n);
  if (h2 > first + r->cap) {
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
  // live view: committed drops + the current un-drained overrun
  uint64_t h = r->head.load(std::memory_order_acquire);
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  uint64_t extra = (r->cap != 0 && h > t + r->cap)
                       ? (h - r->cap) - t : 0;
  return r->dropped.load(std::memory_order_relaxed) + extra;
}

// -- metalog segment naming (meta_log.py _segment_name) ---------------
//
// Python computes time.gmtime(ts_ns / 1e9): FLOAT division then
// floor.  The double math is replicated exactly so the two writers
// pick the same segment for the same stamp even at minute boundaries
// where double rounding of ts_ns/1e9 differs from integer division.
void segment_name(uint64_t ts_ns, char* day, char* minute) {
  double secs_f = floor(double(ts_ns) / 1e9);
  time_t secs = time_t(secs_f);
  tm t;
  gmtime_r(&secs, &t);
  snprintf(day, 16, "%04d-%02d-%02d", t.tm_year + 1900, t.tm_mon + 1,
           t.tm_mday);
  snprintf(minute, 8, "%02d-%02d", t.tm_hour, t.tm_min);
}

struct Conn {
  int fd = -1;
  uint64_t gen = 0;           // guards acks against fd reuse
  std::string in;
  std::string out;
  bool have_headers = false;
  size_t header_end = 0;
  size_t body_need = 0;
  std::string method;
  std::string target;
  std::string req_headers;    // raw header block (case-insens. search)
  std::string body;
  uint64_t req_start_ns = 0;  // CLOCK_MONOTONIC, first byte of request
  int inflight = 0;           // parked on the native pipeline
  bool close_after = false;
  bool want_write = false;
  char rid[40] = {0};         // X-Request-ID (or minted)
  bool rid_client = false;    // rid came off the wire
  int64_t deadline_ms = -1;   // X-Weed-Deadline-Ms at ingress
};

// one native request in flight against the volume write plane
struct Pending {
  int client_fd = -1;
  uint64_t client_gen = 0;
  std::string path;           // filer path, vetted bytes
  std::string name;           // basename
  std::string mime;           // "" | "application/octet-stream"
  std::string fid;            // "vid,hexkeycookie"
  size_t size = 0;
  uint64_t start_mono = 0;    // request first byte (ack histogram)
  uint64_t dispatch_mono = 0; // eligibility done -> upstream queued
  uint64_t enq_mono = 0;      // upstream-timeout clock
  uint64_t upload_ns = 0;     // set when the volume round trip lands
  char rid[40] = {0};
  uint32_t rid_flags = 0;
  int64_t deadline_ms = -1;
};

// upstream connections come from the shared persistent plane-socket
// pool (plane_pool.h): pick/pipeline/expire, plus EAGER flush on
// dispatch — the upload hop pays no epoll round trip per request
using Upstream = plane_pool::Upstream<Pending>;

// a parsed+uploaded request waiting on the end-of-iteration barrier
struct WalItem {
  Pending p;
  std::string etag;
  uint64_t chunk_mtime_ns = 0;
};

struct Server {
  int epfd = -1;
  int listen_fd = -1;
  int wake_pipe[2] = {-1, -1};
  std::thread loop;
  std::atomic<bool> stop{false};
  std::atomic<bool> armed{false};

  std::string log_dir;
  std::string wid;
  std::string wm_path;
  int wm_fd = -1;
  uint64_t wm_last = 0;

  // WAL segment writer (single-threaded: the event loop only)
  int seg_fd = -1;
  char seg_day[16] = {0};
  char seg_minute[8] = {0};
  uint64_t last_ts = 0;       // strictly monotonic stamp clock

  std::mutex fid_mu;
  std::deque<std::pair<std::string, std::string>> fids;  // (addr, fid)

  std::mutex dir_mu;
  std::unordered_map<std::string, std::unordered_set<std::string>> dirs;

  std::unordered_map<int, Conn> conns;
  plane_pool::Pool<Pending> pool;    // volume write-plane connections
  std::vector<WalItem> wal_pending;
  uint64_t gen_counter = 0;

  // telemetry (atomics: read from Python threads)
  std::atomic<uint64_t> requests{0};      // native 201 acks
  std::atomic<uint64_t> fallbacks{0};     // 404 handoffs
  std::atomic<uint64_t> fid_misses{0};
  std::atomic<uint64_t> wal_errors{0};
  std::atomic<uint64_t> upstream_errors{0};
  std::atomic<uint64_t> wal_batches{0};
  std::atomic<uint64_t> wal_lines{0};
  std::atomic<uint64_t> parse_ns{0};      // per-stage wall totals
  std::atomic<uint64_t> upload_ns{0};
  std::atomic<uint64_t> wal_ns{0};
  std::atomic<uint64_t> lat_count[kLatN + 1];
  std::atomic<uint64_t> lat_sum_ns{0};

  // per-request flight records + the upload-hop failpoint lever
  RecRing rec;
  std::atomic<int> upload_delay_ms{0};
  uint64_t rid_seq = 0;                   // event-loop thread only
  char rid_prefix[16] = {0};

  Server() {
    for (int i = 0; i <= kLatN; i++) lat_count[i] = 0;
  }
};

std::mutex g_servers_mu;
Server* g_servers[kMaxServers];
std::once_flag g_init_once;

void global_init() {
  for (int i = 0; i < kMaxServers; i++) g_servers[i] = nullptr;
  signal(SIGPIPE, SIG_IGN);
}

Server* get_server(int h) {
  if (h < 0 || h >= kMaxServers) return nullptr;
  std::lock_guard<std::mutex> lk(g_servers_mu);
  return g_servers[h];
}

// -- epoll helpers ----------------------------------------------------

void arm_fd(Server* s, int fd, bool want_write) {
  epoll_event ev{};
  ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0u);
  ev.data.fd = fd;
  epoll_ctl(s->epfd, EPOLL_CTL_MOD, fd, &ev);
}

void conn_arm(Server* s, Conn* c, bool want_write) {
  if (c->want_write == want_write) return;
  c->want_write = want_write;
  arm_fd(s, c->fd, want_write);
}

void close_conn(Server* s, int fd) {
  auto it = s->conns.find(fd);
  if (it == s->conns.end()) return;
  epoll_ctl(s->epfd, EPOLL_CTL_DEL, fd, nullptr);
  close(fd);
  s->conns.erase(it);
}

// -- HTTP plumbing ----------------------------------------------------

// case-insensitive header lookup in a raw "K: v\r\n..." block
std::string header_value(const std::string& headers, const char* name) {
  size_t nlen = strlen(name);
  size_t pos = 0;
  while (pos < headers.size()) {
    size_t eol = headers.find("\r\n", pos);
    if (eol == std::string::npos) eol = headers.size();
    if (eol - pos > nlen && headers[pos + nlen] == ':' &&
        strncasecmp(headers.c_str() + pos, name, nlen) == 0) {
      size_t v = pos + nlen + 1;
      while (v < eol && (headers[v] == ' ' || headers[v] == '\t')) v++;
      return headers.substr(v, eol - v);
    }
    pos = eol + 2;
  }
  return "";
}

bool has_header(const std::string& headers, const char* name) {
  size_t nlen = strlen(name);
  size_t pos = 0;
  while (pos < headers.size()) {
    size_t eol = headers.find("\r\n", pos);
    if (eol == std::string::npos) eol = headers.size();
    if (eol - pos > nlen && headers[pos + nlen] == ':' &&
        strncasecmp(headers.c_str() + pos, name, nlen) == 0)
      return true;
    pos = eol + 2;
  }
  return false;
}

void respond(Server* s, Conn* c, int code, const char* reason,
             const std::string& body) {
  char head[256];
  int n = snprintf(head, sizeof(head),
                   "HTTP/1.1 %d %s\r\n"
                   "Content-Type: application/json\r\n"
                   "Content-Length: %zu\r\n"
                   "%s"
                   "\r\n",
                   code, reason, body.size(),
                   c->close_after ? "Connection: close\r\n" : "");
  c->out.append(head, size_t(n));
  c->out.append(body);
  conn_arm(s, c, true);
}

void respond_fallback(Server* s, Conn* c) {
  s->fallbacks.fetch_add(1, std::memory_order_relaxed);
  respond(s, c, 404, "Not Found",
          "{\"error\":\"meta plane fallback\"}");
}

// append one flight record; ack = total minus the named stages
void rec_emit(Server* s, const char* rid, uint32_t flags,
              int64_t deadline_ms, uint64_t total_ns, uint64_t parse,
              uint64_t upload, uint64_t wal, uint64_t bytes,
              int status, int fallback) {
  PlaneRec r{};
  snprintf(r.rid, sizeof(r.rid), "%s", rid);
  r.start_unix_ns = now_ns() - total_ns;
  r.stage_ns[0] = parse;
  r.stage_ns[1] = upload;
  r.stage_ns[2] = wal;
  uint64_t sum = parse + upload + wal;
  r.stage_ns[3] = total_ns > sum ? total_ns - sum : 0;
  r.bytes = bytes;
  r.deadline_ms = deadline_ms;
  r.status = status;
  r.fallback = fallback;
  r.flags = flags;
  rec_push(&s->rec, r);
}

// fallback record framed from the conn (pre-dispatch failures)
void rec_emit_conn(Server* s, Conn* c, uint64_t bytes, int status,
                   int fallback) {
  uint64_t total =
      c->req_start_ns != 0 ? mono_ns() - c->req_start_ns : 0;
  rec_emit(s, c->rid, rid_rec_flags(c->rid, c->rid_client),
           c->deadline_ms, total, total, 0, 0, bytes, status,
           fallback);
}

// fallback record framed from a dispatched Pending (upstream failures)
void rec_emit_pending(Server* s, const Pending& p, int fallback) {
  uint64_t now = mono_ns();
  uint64_t total = now - p.start_mono;
  uint64_t parse = p.dispatch_mono - p.start_mono;
  uint64_t upload =
      p.upload_ns != 0 ? p.upload_ns : now - p.dispatch_mono;
  rec_emit(s, p.rid, p.rid_flags, p.deadline_ms, total, parse, upload,
           0, p.size, 404, fallback);
}

// -- eligibility ------------------------------------------------------

// the exact byte set the entry JSON can embed with no escaping and the
// Python dispatcher would not transform: printable ASCII minus quote,
// backslash, percent (urllib.unquote), query/fragment markers
bool path_bytes_ok(const std::string& p) {
  for (unsigned char ch : p) {
    if (ch < 0x21 || ch > 0x7E) return false;
    if (ch == '"' || ch == '\\' || ch == '%' || ch == '?' ||
        ch == '#')
      return false;
  }
  return true;
}

bool split_parent(const std::string& path, std::string* parent,
                  std::string* name) {
  size_t slash = path.rfind('/');
  if (slash == std::string::npos || slash + 1 >= path.size())
    return false;
  *parent = slash == 0 ? std::string("/") : path.substr(0, slash);
  *name = path.substr(slash + 1);
  return true;
}

// -- WAL framing + group commit ---------------------------------------

// Python repr of a wall-clock float carries sub-microsecond digits;
// byte parity is NOT required (the applier persists each line's raw
// newEntry verbatim), only valid JSON that parses to the same second
void fmt_wall_seconds(uint64_t ns, char* out, size_t cap) {
  snprintf(out, cap, "%llu.%07llu",
           static_cast<unsigned long long>(ns / 1000000000ull),
           static_cast<unsigned long long>((ns % 1000000000ull) / 100));
}

std::string build_entry_json(const WalItem& w) {
  char mt[40];
  fmt_wall_seconds(w.chunk_mtime_ns, mt, sizeof(mt));
  std::string e;
  e.reserve(256 + w.p.path.size() + w.p.fid.size());
  e += "{\"fullPath\":\"";
  e += w.p.path;
  e += "\",\"isDirectory\":false,\"attributes\":{\"mtime\":";
  e += mt;
  e += ",\"crtime\":";
  e += mt;
  e += ",\"mode\":432,\"uid\":0,\"gid\":0,\"mime\":\"";
  e += w.p.mime;
  e += "\",\"ttlSec\":0,\"symlinkTarget\":\"\"},\"chunks\":[{"
       "\"fileId\":\"";
  e += w.p.fid;
  e += "\",\"offset\":0,\"size\":";
  e += std::to_string(w.p.size);
  e += ",\"eTag\":\"";
  e += w.etag;
  e += "\",\"mtime\":";
  e += std::to_string(w.chunk_mtime_ns);
  e += "}],\"extended\":{}}";
  return e;
}

bool seg_rotate(Server* s, const char* day, const char* minute) {
  if (s->seg_fd >= 0 && strcmp(day, s->seg_day) == 0 &&
      strcmp(minute, s->seg_minute) == 0)
    return true;
  if (s->seg_fd >= 0) {
    close(s->seg_fd);
    s->seg_fd = -1;
  }
  std::string day_dir = s->log_dir + "/" + day;
  mkdir(s->log_dir.c_str(), 0755);
  mkdir(day_dir.c_str(), 0755);
  std::string path = day_dir + "/" + minute + ".log";
  s->seg_fd =
      open(path.c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (s->seg_fd < 0) return false;
  snprintf(s->seg_day, sizeof(s->seg_day), "%s", day);
  snprintf(s->seg_minute, sizeof(s->seg_minute), "%s", minute);
  return true;
}

bool write_all(int fd, const char* buf, size_t len) {
  size_t off = 0;
  while (off < len) {
    ssize_t n = write(fd, buf + off, len - off);
    if (n <= 0) {
      if (n < 0 && errno == EINTR) continue;
      return false;   // short write = failed batch, never a false ack
    }
    off += size_t(n);
  }
  return true;
}

void publish_watermark(Server* s, uint64_t ts) {
  if (s->wm_fd < 0 || ts <= s->wm_last) return;
  s->wm_last = ts;
  char payload[32];
  // meta_log.py _format_wm: 20-digit zero-padded value, mod-97 check
  snprintf(payload, sizeof(payload), "%020llu.%02llu",
           static_cast<unsigned long long>(ts),
           static_cast<unsigned long long>(ts % 97));
  pwrite(s->wm_fd, payload, 23, 0);
}

void record_ack_latency(Server* s, uint64_t ns) {
  uint64_t us = ns / 1000;
  int i = 0;
  while (i < kLatN && us > kLatBuckets[i]) i++;
  s->lat_count[i].fetch_add(1, std::memory_order_relaxed);
  s->lat_sum_ns.fetch_add(ns, std::memory_order_relaxed);
}

void client_feed(Server* s, Conn* c);

void flush_client(Server* s, int fd) {
  auto it = s->conns.find(fd);
  if (it == s->conns.end()) return;
  Conn* c = &it->second;
  while (!c->out.empty()) {
    ssize_t n = send(c->fd, c->out.data(), c->out.size(), MSG_NOSIGNAL);
    if (n > 0) {
      c->out.erase(0, size_t(n));
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      conn_arm(s, c, true);
      return;
    }
    close_conn(s, fd);
    return;
  }
  if (c->close_after) {
    close_conn(s, fd);
    return;
  }
  conn_arm(s, c, false);
  // the conn may hold a pipelined follow-up request buffered behind
  // the one just answered
  if (c->inflight == 0 && !c->in.empty()) client_feed(s, c);
}

// drain this iteration's completed uploads: frame WAL lines, land each
// segment run with ONE write, publish the watermark, then ack — the
// group-commit barrier, in the exact order that makes acked == durable
void commit_batch(Server* s) {
  if (s->wal_pending.empty()) return;
  uint64_t t0 = mono_ns();
  struct Line {
    uint64_t ts;
    std::string text;
    size_t item;
  };
  std::vector<Line> lines;
  lines.reserve(s->wal_pending.size());
  for (size_t i = 0; i < s->wal_pending.size(); i++) {
    WalItem& w = s->wal_pending[i];
    uint64_t ts = now_ns();
    if (ts <= s->last_ts) ts = s->last_ts + 1;
    s->last_ts = ts;
    std::string entry = build_entry_json(w);
    std::string line;
    line.reserve(entry.size() + s->wid.size() + 96);
    line += "{\"nl\":";
    line += std::to_string(entry.size());
    line += ",\"wid\":\"";
    line += s->wid;
    line += "\",\"op\":\"create\",\"tsNs\":";
    line += std::to_string(ts);
    line += ",\"oldEntry\":null,\"newEntry\":";
    line += entry;
    line += "}\n";
    lines.push_back({ts, std::move(line), i});
  }
  // group contiguous same-segment runs, one kernel append per run
  // (mirrors meta_log.py _group_commit_drain — whole-batch O_APPEND
  // interleave is the shared-dir multi-writer contract)
  bool ok = true;
  size_t i = 0;
  while (i < lines.size() && ok) {
    char day[16], minute[8];
    segment_name(lines[i].ts, day, minute);
    size_t j = i;
    std::string buf;
    while (j < lines.size()) {
      char d2[16], m2[8];
      segment_name(lines[j].ts, d2, m2);
      if (strcmp(d2, day) != 0 || strcmp(m2, minute) != 0) break;
      buf += lines[j].text;
      j++;
    }
    if (!seg_rotate(s, day, minute) ||
        !write_all(s->seg_fd, buf.data(), buf.size())) {
      ok = false;
      break;
    }
    i = j;
  }
  uint64_t t1 = mono_ns();
  s->wal_ns.fetch_add(t1 - t0, std::memory_order_relaxed);
  if (ok) {
    publish_watermark(s, lines.back().ts);
    s->wal_batches.fetch_add(1, std::memory_order_relaxed);
    s->wal_lines.fetch_add(lines.size(), std::memory_order_relaxed);
  } else {
    s->wal_errors.fetch_add(1, std::memory_order_relaxed);
    if (s->seg_fd >= 0) {
      close(s->seg_fd);   // reopen next batch; never serve a bad fd
      s->seg_fd = -1;
    }
  }
  uint64_t wal_win = t1 - t0;   // shared batch window, per record
  std::vector<int> touched;
  for (WalItem& w : s->wal_pending) {
    rec_emit(s, w.p.rid, w.p.rid_flags, w.p.deadline_ms,
             mono_ns() - w.p.start_mono,
             w.p.dispatch_mono - w.p.start_mono, w.p.upload_ns,
             wal_win, w.p.size, ok ? 201 : 404,
             ok ? kFbNone : kFbWal);
    auto it = s->conns.find(w.p.client_fd);
    bool alive =
        it != s->conns.end() && it->second.gen == w.p.client_gen;
    if (!alive) continue;   // durable anyway; ack has nowhere to go
    Conn* c = &it->second;
    c->inflight = 0;
    c->req_start_ns = 0;
    if (ok) {
      s->requests.fetch_add(1, std::memory_order_relaxed);
      record_ack_latency(s, mono_ns() - w.p.start_mono);
      std::string body = "{\"name\":\"" + w.p.name +
                         "\",\"size\":" + std::to_string(w.p.size) +
                         "}";
      respond(s, c, 201, "Created", body);
    } else {
      // the chunk landed on the volume but the WAL append failed:
      // hand the request back to Python (which re-uploads; the
      // orphaned chunk is maintenance-job territory, exactly like
      // every other fallback-after-partial-work path)
      respond_fallback(s, c);
    }
    touched.push_back(w.p.client_fd);
  }
  s->wal_pending.clear();
  for (int fd : touched) flush_client(s, fd);
}

// -- request handling -------------------------------------------------

void dispatch_native(Server* s, Conn* c, const std::string& path,
                     const std::string& name, const std::string& mime,
                     const std::string& addr, const std::string& fid) {
  Pending p;
  p.client_fd = c->fd;
  p.client_gen = c->gen;
  p.path = path;
  p.name = name;
  p.mime = mime;
  p.fid = fid;
  p.size = c->body.size();
  p.start_mono = c->req_start_ns;
  p.dispatch_mono = mono_ns();
  p.enq_mono = p.dispatch_mono;
  // failpoint: deliberately slow the volume upload hop.  Runs after
  // the dispatch stamp so the stall lands in the record's upload
  // stage (measured dispatch -> volume ack)
  int delay = s->upload_delay_ms.load(std::memory_order_relaxed);
  if (delay > 0) usleep(useconds_t(delay) * 1000);
  memcpy(p.rid, c->rid, sizeof(p.rid));
  p.rid_flags = rid_rec_flags(c->rid, c->rid_client);
  p.deadline_ms = c->deadline_ms;
  s->parse_ns.fetch_add(p.dispatch_mono - c->req_start_ns,
                        std::memory_order_relaxed);
  Upstream* u = s->pool.pick(addr);
  if (u == nullptr) {
    s->upstream_errors.fetch_add(1, std::memory_order_relaxed);
    rec_emit_conn(s, c, c->body.size(), 404, kFbUpstream);
    respond_fallback(s, c);
    return;
  }
  // forward the request id + remaining deadline on the plane-socket
  // hop so the volume plane's record stitches into the same trace
  char dlbuf[48];
  dlbuf[0] = '\0';
  if (c->deadline_ms >= 0) {
    long long elapsed_ms =
        (long long)((p.dispatch_mono - p.start_mono) / 1000000ull);
    long long left = (long long)c->deadline_ms - elapsed_ms;
    if (left < 1) left = 1;
    snprintf(dlbuf, sizeof(dlbuf), "X-Weed-Deadline-Ms: %lld\r\n",
             left);
  }
  char head[384];
  int n = snprintf(head, sizeof(head),
                   "POST /%s HTTP/1.1\r\n"
                   "Host: %s\r\n"
                   "X-Request-ID: %s\r\n"
                   "%s"
                   "Content-Length: %zu\r\n"
                   "\r\n",
                   fid.c_str(), addr.c_str(), c->rid, dlbuf,
                   c->body.size());
  u->out.append(head, size_t(n));
  u->out.append(c->body);
  u->inflight.push_back(std::move(p));
  c->inflight = 1;
  c->body.clear();
  // eager flush (plane_pool.h): the established
  // keep-alive socket is almost always writable — send now instead
  // of paying an epoll round trip to learn that
  s->pool.flush(u);
}

void handle_request(Server* s, Conn* c) {
  const std::string& t = c->target;
  bool eligible =
      s->armed.load(std::memory_order_relaxed) &&
      (c->method == "POST" || c->method == "PUT") && !t.empty() &&
      t[0] == '/' && t.size() < kMaxPath && t.back() != '/' &&
      t.find("//") == std::string::npos && t.compare(0, 3, "/__") != 0 &&
      path_bytes_ok(t) && !c->body.empty() && c->body.size() <= kMaxBody;
  std::string mime;
  if (eligible) {
    mime = header_value(c->req_headers, "Content-Type");
    if (!mime.empty() && mime != "application/octet-stream")
      eligible = false;
    if (has_header(c->req_headers, "Authorization") ||
        has_header(c->req_headers, "Expect") ||
        has_header(c->req_headers, "X-Tenant"))
      eligible = false;
  }
  std::string parent, name;
  if (eligible) eligible = split_parent(t, &parent, &name);
  if (eligible) {
    // parent must be a directory created fresh during this plane's
    // lifetime, and the name never written by anyone — that is the
    // proof op="create" with oldEntry:null is the truth.  The name
    // is NOT claimed yet: a fid-dry fallback below must leave it
    // retryable on the plane port (a boot-time dry pool otherwise
    // poisons the first path a client hammers)
    std::lock_guard<std::mutex> lk(s->dir_mu);
    auto it = s->dirs.find(parent);
    if (it == s->dirs.end() || it->second.count(name) != 0) {
      eligible = false;
    } else if (it->second.size() >= kMaxChildren) {
      s->dirs.erase(it);     // overflow: this dir falls back from now
      eligible = false;
    }
  }
  std::string addr, fid;
  int fb = kFbIneligible;
  if (eligible) {
    std::lock_guard<std::mutex> lk(s->fid_mu);
    if (s->fids.empty()) {
      s->fid_misses.fetch_add(1, std::memory_order_relaxed);
      eligible = false;
      fb = kFbFidDry;
    } else {
      addr = std::move(s->fids.front().first);
      fid = std::move(s->fids.front().second);
      s->fids.pop_front();
    }
  }
  if (eligible) {
    // claim the name now that a fid is in hand; a concurrent twin
    // of the same name may have claimed it between the dir_mu holds
    std::lock_guard<std::mutex> lk(s->dir_mu);
    auto it = s->dirs.find(parent);
    bool claimed = false;
    if (it != s->dirs.end()) {
      if (it->second.size() >= kMaxChildren)
        s->dirs.erase(it);
      else
        claimed = it->second.insert(name).second;
    }
    if (!claimed) {
      eligible = false;
      std::lock_guard<std::mutex> lk2(s->fid_mu);
      s->fids.emplace_front(std::move(addr), std::move(fid));
    }
  }
  if (!eligible) {
    size_t nbytes = c->body.size();
    c->body.clear();
    rec_emit_conn(s, c, nbytes, 404, fb);
    respond_fallback(s, c);
    return;
  }
  dispatch_native(s, c, t, name, mime, addr, fid);
}

void client_feed(Server* s, Conn* c) {
  for (;;) {
    if (c->inflight > 0) return;   // parked behind the barrier
    if (!c->have_headers) {
      size_t he = c->in.find("\r\n\r\n");
      if (he == std::string::npos) {
        if (c->in.size() > kMaxHeaders) close_conn(s, c->fd);
        return;
      }
      if (c->req_start_ns == 0) c->req_start_ns = mono_ns();
      size_t eol = c->in.find("\r\n");
      std::string req_line = c->in.substr(0, eol);
      c->req_headers = c->in.substr(eol + 2, he - eol - 2);
      size_t sp1 = req_line.find(' ');
      size_t sp2 =
          sp1 == std::string::npos ? sp1 : req_line.find(' ', sp1 + 1);
      if (sp1 == std::string::npos || sp2 == std::string::npos) {
        close_conn(s, c->fd);
        return;
      }
      c->method = req_line.substr(0, sp1);
      c->target = req_line.substr(sp1 + 1, sp2 - sp1 - 1);
      std::string rv = header_value(c->req_headers, "X-Request-ID");
      if (!rv.empty()) {
        snprintf(c->rid, sizeof(c->rid), "%.39s", rv.c_str());
        c->rid_client = true;
      } else {
        snprintf(c->rid, sizeof(c->rid), "%s-%llx", s->rid_prefix,
                 static_cast<unsigned long long>(++s->rid_seq));
        c->rid_client = false;
      }
      std::string dv =
          header_value(c->req_headers, "X-Weed-Deadline-Ms");
      c->deadline_ms = dv.empty() ? -1 : atoll(dv.c_str());
      c->close_after =
          strcasecmp(
              header_value(c->req_headers, "Connection").c_str(),
              "close") == 0;
      std::string te =
          header_value(c->req_headers, "Transfer-Encoding");
      std::string cl = header_value(c->req_headers, "Content-Length");
      if (!te.empty()) {
        // no framing we can cheaply parse — refuse and close
        c->close_after = true;
        rec_emit_conn(s, c, 0, 404, kFbChunked);
        respond_fallback(s, c);
        flush_client(s, c->fd);
        return;
      }
      long long need = cl.empty() ? 0 : atoll(cl.c_str());
      if (need < 0 || size_t(need) > kMaxBody + 1) {
        c->close_after = true;   // body too big to swallow: hand off
        rec_emit_conn(s, c, need > 0 ? uint64_t(need) : 0, 404,
                      kFbOversize);
        respond_fallback(s, c);
        flush_client(s, c->fd);
        return;
      }
      c->body_need = size_t(need);
      c->have_headers = true;
      c->in.erase(0, he + 4);
    }
    if (c->in.size() < c->body_need) return;
    c->body = c->in.substr(0, c->body_need);
    c->in.erase(0, c->body_need);
    c->have_headers = false;
    c->body_need = 0;
    uint64_t start = c->req_start_ns;
    handle_request(s, c);
    // handle_request may have closed the conn (parse errors)
    auto it = s->conns.find(c->fd);
    if (it == s->conns.end() || &it->second != c) return;
    c->req_start_ns = 0;
    (void)start;
    if (c->inflight == 0 && !c->out.empty()) {
      flush_client(s, c->fd);
      it = s->conns.find(c->fd);
      if (it == s->conns.end()) return;
    }
  }
}

// one dropped in-flight upstream request (conn error / timeout),
// handed back by the pool: answer the waiting client with the 404
// fallback so Python re-serves the write
void ups_drop_pending(Server* s, Pending& p) {
  s->upstream_errors.fetch_add(1, std::memory_order_relaxed);
  rec_emit_pending(s, p, kFbUpstream);
  auto it = s->conns.find(p.client_fd);
  if (it == s->conns.end() || it->second.gen != p.client_gen) return;
  it->second.inflight = 0;
  it->second.req_start_ns = 0;
  respond_fallback(s, &it->second);
  flush_client(s, p.client_fd);
}

// parse one complete volume-plane response off u->in; false = need
// more bytes
bool ups_feed_one(Server* s, Upstream* u) {
  if (!u->have_headers) {
    size_t he = u->in.find("\r\n\r\n");
    if (he == std::string::npos) return false;
    u->header_end = he;
    int status = 0;
    if (u->in.size() > 12 && u->in.compare(0, 5, "HTTP/") == 0)
      status = atoi(u->in.c_str() + 9);
    u->status = status;
    std::string head = u->in.substr(0, he);
    std::string cl = header_value(head, "Content-Length");
    u->body_need = cl.empty() ? 0 : size_t(atoll(cl.c_str()));
    u->have_headers = true;
    u->in.erase(0, he + 4);
  }
  if (u->in.size() < u->body_need) return false;
  std::string body = u->in.substr(0, u->body_need);
  u->in.erase(0, u->body_need);
  u->have_headers = false;
  int status = u->status;
  u->status = 0;
  u->body_need = 0;
  if (u->inflight.empty()) return true;   // stray; resync on close
  Pending p = std::move(u->inflight.front());
  u->inflight.pop_front();
  uint64_t t = mono_ns();
  p.upload_ns = t - p.dispatch_mono;
  s->upload_ns.fetch_add(t - p.dispatch_mono,
                         std::memory_order_relaxed);
  if (status == 201) {
    WalItem w;
    w.etag = "";
    size_t e = body.find("\"eTag\":\"");
    if (e != std::string::npos) {
      size_t b = e + 8;
      size_t q = body.find('"', b);
      if (q != std::string::npos && q - b <= 16)
        w.etag = body.substr(b, q - b);
    }
    w.p = std::move(p);
    w.chunk_mtime_ns = now_ns();
    s->wal_pending.push_back(std::move(w));
    return true;
  }
  // volume plane refused (its own fallback contract) — hand the whole
  // request back to Python
  s->upstream_errors.fetch_add(1, std::memory_order_relaxed);
  rec_emit_pending(s, p, kFbUpstream);
  auto it = s->conns.find(p.client_fd);
  if (it != s->conns.end() && it->second.gen == p.client_gen) {
    it->second.inflight = 0;
    it->second.req_start_ns = 0;
    respond_fallback(s, &it->second);
    flush_client(s, p.client_fd);
  }
  return true;
}

// -- event loop -------------------------------------------------------

void event_loop(Server* s) {
  epoll_event evs[256];
  while (!s->stop.load(std::memory_order_relaxed)) {
    int n = epoll_wait(s->epfd, evs, 256, 200);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      uint32_t e = evs[i].events;
      if (fd == s->wake_pipe[0]) {
        char buf[64];
        while (read(fd, buf, sizeof(buf)) > 0) {
        }
        continue;
      }
      if (fd == s->listen_fd) {
        for (;;) {
          int cfd = accept4(s->listen_fd, nullptr, nullptr,
                            SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one,
                     sizeof(one));
          epoll_event cev{};
          cev.events = EPOLLIN;
          cev.data.fd = cfd;
          if (epoll_ctl(s->epfd, EPOLL_CTL_ADD, cfd, &cev) < 0) {
            close(cfd);
            continue;
          }
          Conn c;
          c.fd = cfd;
          c.gen = ++s->gen_counter;
          s->conns[cfd] = std::move(c);
        }
        continue;
      }
      Upstream* u = s->pool.find(fd);
      if (u != nullptr) {
        if (e & (EPOLLHUP | EPOLLERR)) {
          s->pool.close_conn(fd);
          continue;
        }
        if (e & EPOLLOUT) s->pool.flush(u);
        if ((u = s->pool.find(fd)) == nullptr) continue;
        if (e & EPOLLIN) {
          char buf[65536];
          for (;;) {
            ssize_t r = recv(fd, buf, sizeof(buf), 0);
            if (r > 0) {
              u->in.append(buf, size_t(r));
              if (r < ssize_t(sizeof(buf))) break;
              continue;
            }
            if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK))
              break;
            s->pool.close_conn(fd);
            u = nullptr;
            break;
          }
          if (u != nullptr)
            while (ups_feed_one(s, u)) {
            }
        }
        continue;
      }
      auto cit = s->conns.find(fd);
      if (cit == s->conns.end()) continue;
      Conn* c = &cit->second;
      if (e & (EPOLLHUP | EPOLLERR)) {
        close_conn(s, fd);
        continue;
      }
      if (e & EPOLLOUT) {
        flush_client(s, fd);
        cit = s->conns.find(fd);
        if (cit == s->conns.end()) continue;
        c = &cit->second;
      }
      if (e & EPOLLIN) {
        char buf[65536];
        bool dead = false;
        for (;;) {
          ssize_t r = recv(fd, buf, sizeof(buf), 0);
          if (r > 0) {
            c->in.append(buf, size_t(r));
            if (r < ssize_t(sizeof(buf))) break;
            continue;
          }
          if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK))
            break;
          dead = true;
          break;
        }
        if (dead) {
          close_conn(s, fd);
          continue;
        }
        client_feed(s, c);
      }
    }
    // end-of-iteration barrier: everything that finished its volume
    // round trip this pass lands in ONE WAL append (per segment run)
    // and acks together
    commit_batch(s);
    s->pool.expire(mono_ns());
  }
}

}  // namespace

// -- extern "C" API ----------------------------------------------------

extern "C" {

// Start a meta plane over `log_dir` (the shared metalog directory),
// writing lines as writer `wid` and publishing durable stamps into
// `wm_path` (pre-created by the Python wrapper via atomic replace).
// Binds host:port (0 = ephemeral), reports the bound port through
// out_port.  Returns a handle >= 0, or -1.
int mp_start(const char* host, int port, const char* log_dir,
             const char* wid, const char* wm_path, int* out_port) {
  std::call_once(g_init_once, global_init);
  int slot = -1;
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    for (int i = 0; i < kMaxServers; i++)
      if (g_servers[i] == nullptr) {
        slot = i;
        break;
      }
  }
  if (slot < 0) return -1;
  Server* s = new Server();
  s->log_dir = log_dir;
  s->wid = wid;
  s->wm_path = wm_path;
  s->last_ts = now_ns();
  s->rec.cap = rec_ring_cap_env();
  s->rec.recs.resize(s->rec.cap);
  snprintf(s->rid_prefix, sizeof(s->rid_prefix), "mp%02d%06llx", slot,
           static_cast<unsigned long long>(now_ns() & 0xffffff));
  {
    const char* d = getenv("SEAWEEDFS_TPU_MP_UPLOAD_DELAY_MS");
    if (d != nullptr && *d != '\0') s->upload_delay_ms.store(atoi(d));
  }
  s->wm_fd = open(wm_path, O_WRONLY);
  s->epfd = epoll_create1(0);
  s->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (s->epfd < 0 || s->listen_fd < 0) goto fail;
  s->pool.epfd = s->epfd;
  s->pool.on_drop = [s](Pending& p) { ups_drop_pending(s, p); };
  {
    int one = 1;
    setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one,
               sizeof(one));
    sockaddr_in sa{};
    sa.sin_family = AF_INET;
    sa.sin_port = htons(uint16_t(port));
    if (inet_pton(AF_INET, host, &sa.sin_addr) != 1) goto fail;
    if (bind(s->listen_fd, reinterpret_cast<sockaddr*>(&sa),
             sizeof(sa)) < 0)
      goto fail;
    if (listen(s->listen_fd, 512) < 0) goto fail;
    socklen_t slen = sizeof(sa);
    if (getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&sa),
                    &slen) < 0)
      goto fail;
    if (out_port != nullptr) *out_port = int(ntohs(sa.sin_port));
    if (pipe2(s->wake_pipe, O_NONBLOCK) < 0) goto fail;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = s->listen_fd;
    if (epoll_ctl(s->epfd, EPOLL_CTL_ADD, s->listen_fd, &ev) < 0)
      goto fail;
    ev.data.fd = s->wake_pipe[0];
    if (epoll_ctl(s->epfd, EPOLL_CTL_ADD, s->wake_pipe[0], &ev) < 0)
      goto fail;
  }
  s->loop = std::thread(event_loop, s);
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    g_servers[slot] = s;
  }
  return slot;
fail:
  if (s->epfd >= 0) close(s->epfd);
  if (s->listen_fd >= 0) close(s->listen_fd);
  if (s->wm_fd >= 0) close(s->wm_fd);
  if (s->wake_pipe[0] >= 0) close(s->wake_pipe[0]);
  if (s->wake_pipe[1] >= 0) close(s->wake_pipe[1]);
  delete s;
  return -1;
}

void mp_stop(int h) {
  Server* s = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    if (h < 0 || h >= kMaxServers) return;
    s = g_servers[h];
    g_servers[h] = nullptr;
  }
  if (s == nullptr) return;
  s->stop.store(true);
  char b = 1;
  ssize_t ignored = write(s->wake_pipe[1], &b, 1);
  (void)ignored;
  if (s->loop.joinable()) s->loop.join();
  for (auto& kv : s->conns) close(kv.second.fd);
  s->pool.close_all();
  if (s->seg_fd >= 0) close(s->seg_fd);
  if (s->wm_fd >= 0) close(s->wm_fd);
  close(s->listen_fd);
  close(s->epfd);
  close(s->wake_pipe[0]);
  close(s->wake_pipe[1]);
  delete s;
}

// arm/disarm the hot path (disarmed = every request answers the 404
// fallback; the listener stays up so clients need no re-discovery)
void mp_arm(int h, int on) {
  Server* s = get_server(h);
  if (s != nullptr) s->armed.store(on != 0);
}

// feed pre-assigned fids: newline-separated "host:port vid,fidhex"
// entries (the Python wrapper batches master assigns and derives the
// range locally).  Returns the pool level after the feed.
int mp_feed_fids(int h, const char* entries) {
  Server* s = get_server(h);
  if (s == nullptr || entries == nullptr) return -1;
  std::lock_guard<std::mutex> lk(s->fid_mu);
  const char* p = entries;
  while (*p != '\0') {
    const char* nl = strchr(p, '\n');
    size_t len = nl != nullptr ? size_t(nl - p) : strlen(p);
    const char* sp = static_cast<const char*>(memchr(p, ' ', len));
    if (sp != nullptr && sp > p && size_t(sp - p) < len - 1)
      s->fids.emplace_back(std::string(p, size_t(sp - p)),
                           std::string(sp + 1, len - size_t(sp - p) - 1));
    if (nl == nullptr) break;
    p = nl + 1;
  }
  return int(s->fids.size());
}

int mp_fid_level(int h) {
  Server* s = get_server(h);
  if (s == nullptr) return -1;
  std::lock_guard<std::mutex> lk(s->fid_mu);
  return int(s->fids.size());
}

// mark a directory created FRESH (provably empty at creation): its
// children become native-eligible
void mp_mark_dir(int h, const char* path) {
  Server* s = get_server(h);
  if (s == nullptr || path == nullptr) return;
  std::lock_guard<std::mutex> lk(s->dir_mu);
  if (s->dirs.size() >= kMaxDirs) s->dirs.clear();
  s->dirs[std::string(path)];
}

// mark a path written through ANY other route (Python, a sibling):
// future native writes to it fall back (overwrite semantics live in
// Python)
void mp_mark_path(int h, const char* path) {
  Server* s = get_server(h);
  if (s == nullptr || path == nullptr) return;
  std::string p(path);
  size_t slash = p.rfind('/');
  if (slash == std::string::npos || slash + 1 >= p.size()) return;
  std::string parent = slash == 0 ? std::string("/") : p.substr(0, slash);
  std::lock_guard<std::mutex> lk(s->dir_mu);
  auto it = s->dirs.find(parent);
  if (it == s->dirs.end()) return;
  if (it->second.size() >= kMaxChildren)
    s->dirs.erase(it);
  else
    it->second.insert(p.substr(slash + 1));
}

// drop all directory knowledge (delete/rename anywhere — mirrors
// Filer._known_dirs.clear(): rare, conservative, always safe)
void mp_clear_dirs(int h) {
  Server* s = get_server(h);
  if (s == nullptr) return;
  std::lock_guard<std::mutex> lk(s->dir_mu);
  s->dirs.clear();
}

unsigned long long mp_requests(int h) {
  Server* s = get_server(h);
  return s != nullptr ? s->requests.load() : 0;
}

unsigned long long mp_fallbacks(int h) {
  Server* s = get_server(h);
  return s != nullptr ? s->fallbacks.load() : 0;
}

// out[0..kLatN]: cumulative bucket counts; out[kLatN+1]=count,
// out[kLatN+2]=sum ns (same shape as wp_latency)
int mp_latency(int h, unsigned long long* out) {
  Server* s = get_server(h);
  if (s == nullptr || out == nullptr) return -1;
  unsigned long long total = 0;
  for (int i = 0; i <= kLatN; i++) {
    total += s->lat_count[i].load();
    out[i] = total;
  }
  out[kLatN + 1] = total;
  out[kLatN + 2] = s->lat_sum_ns.load();
  return kLatN;
}

// aggregate counters for the Python metrics bridge:
// [requests, fallbacks, fid_misses, wal_errors, upstream_errors,
//  parse_ns, upload_ns, wal_ns, wal_batches, wal_lines]
int mp_stats(int h, unsigned long long* out) {
  Server* s = get_server(h);
  if (s == nullptr || out == nullptr) return -1;
  out[0] = s->requests.load();
  out[1] = s->fallbacks.load();
  out[2] = s->fid_misses.load();
  out[3] = s->wal_errors.load();
  out[4] = s->upstream_errors.load();
  out[5] = s->parse_ns.load();
  out[6] = s->upload_ns.load();
  out[7] = s->wal_ns.load();
  out[8] = s->wal_batches.load();
  out[9] = s->wal_lines.load();
  return 10;
}

// drain up to `cap` per-request flight records into `out` (oldest
// first; overwritten-before-drain records are counted, never handed
// over).  Single concurrent drainer — the Python side holds a lock.
int mp_drain_records(int h, PlaneRec* out, int cap) {
  Server* s = get_server(h);
  if (s == nullptr) return -1;
  return rec_drain(&s->rec, out, cap);
}

unsigned long long mp_records_dropped(int h) {
  Server* s = get_server(h);
  return s != nullptr ? rec_dropped(&s->rec) : 0;
}

// failpoint: stall the volume upload hop by `ms` per request (0 = off)
void mp_set_upload_delay_ms(int h, int ms) {
  Server* s = get_server(h);
  if (s != nullptr) s->upload_delay_ms.store(ms < 0 ? 0 : ms);
}

}  // extern "C"
