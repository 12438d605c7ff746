// Native filer READ plane, the port's copy of
// `seaweedfs_tpu/native/filer_read_plane.cc` — the read sibling of
// meta_plane.cc: a single-threaded epoll HTTP front that serves the
// filer's hot warm-read path with ZERO Python per request:
//
//   HTTP parse -> eligibility -> C-side entry-map lookup (path ->
//   volume read-plane addr + fid + size + mime) -> chunk fetch over a
//   persistent keep-alive plane socket (plane_pool.h, C++->C++
//   against the volume's read_plane.cc) -> 200 stream to the client.
//
// The entry map is ADVISORY knowledge fed from Python exactly like
// the meta plane's directory truth: the filer's own mutation events
// (Filer.subscribe listener) and every sibling writer's WAL lines
// (the meta plane's follower tap) INVALIDATE the touched path
// synchronously — before the writer's ack returns — so overwrite /
// delete coherence is exact: the map can only under-serve (fallback),
// never serve a pre-mutation chunk.  Fills arrive asynchronously
// (event fills + lazy warm fills from the Python read path) and are
// fenced by a generation counter: a fill whose token pre-dates the
// path's latest invalidation is refused (the meta-cache begin_fill
// protocol, C edition).
//
// Anything the hot path cannot prove cheap and exact — multi-chunk,
// ranged, TTL'd, content-encoded, unknown path, query string, auth,
// disarmed — answers 404 {"error":"read plane fallback"} and the
// client replays against the Python filer port (the other planes'
// fallback contract).  The full response is BUFFERED before the
// status line is written, so a client never sees a 200 that framed a
// Content-Length it won't receive: an upstream failure after dispatch
// still degrades to the clean 404 fallback, and a SIGKILL tears the
// connection without ever having promised bytes.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "plane_pool.h"

namespace {

constexpr int kMaxServers = 16;
constexpr size_t kMaxBody = 64 * 1024;    // GETs carry no real body
constexpr size_t kMaxHeaders = 64 * 1024;
constexpr size_t kMaxPath = 512;
constexpr size_t kMaxEntries = 65536;     // entry-map overflow => clear

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

// response latency buckets, mirroring the meta plane's ack histogram
// (server/filer_read_plane_native.py RESPONSE_BUCKETS_S) — stored in
// MICROseconds
const uint64_t kLatBuckets[] = {1,      2,      5,      10,     20,
                                50,     100,    200,    500,    1000,
                                2000,   5000,   10000,  20000,  50000,
                                100000, 1000000};
constexpr int kLatN = 17;

// -- per-request flight records (meta_plane.cc's wire format) ---------

constexpr uint32_t kRecFlagClientRid = 1u;
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
  uint64_t bytes;          // response body size
  int64_t deadline_ms;
  int32_t status;
  int32_t fallback;
  uint32_t flags;
  uint32_t _pad;
};  // 112 bytes, mirrored by native.PlaneRecord (ctypes)

enum {
  kFbNone = 0,
  kFbIneligible = 1,
  kFbUnknownPath = 2,
  kFbStale = 3,
  kFbUpstream = 4,
};

// The labels of a record's stage and fallback indices
// (server/filer_read_plane_native.py RECORD_STAGES / RECORD_FALLBACKS).
const char* const kRecStageNames[] = {"parse", "lookup", "fetch",
                                      "send"};
const char* const kRecFallbackNames[] = {
    "none", "ineligible", "unknown_path", "stale", "upstream"};
const char* const kStatsNames[] = {
    "requests", "fallbacks", "stale_misses", "upstream_errors",
    "parse_ns", "lookup_ns", "fetch_ns", "send_ns"};

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
  // drop the torn prefix if the producer lapped the slots mid-copy
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
  uint64_t h = r->head.load(std::memory_order_acquire);
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  uint64_t extra = (r->cap != 0 && h > t + r->cap)
                       ? (h - r->cap) - t : 0;
  return r->dropped.load(std::memory_order_relaxed) + extra;
}

// -- connection / request state ---------------------------------------

struct Conn {
  int fd = -1;
  uint64_t gen = 0;           // guards responses against fd reuse
  std::string in;
  std::string out;
  bool have_headers = false;
  size_t header_end = 0;
  size_t body_need = 0;
  std::string method;
  std::string target;
  std::string req_headers;
  std::string body;
  uint64_t req_start_ns = 0;  // CLOCK_MONOTONIC, first byte of request
  int inflight = 0;           // parked on an upstream fetch
  bool close_after = false;
  bool want_write = false;
  char rid[40] = {0};
  bool rid_client = false;
  int64_t deadline_ms = -1;
};

// one native fetch in flight against the volume read plane
struct Pending {
  int client_fd = -1;
  uint64_t client_gen = 0;
  std::string path;
  std::string mime;           // resolved Content-Type for the client
  uint64_t size = 0;          // registered chunk size (must match)
  uint64_t start_mono = 0;    // request first byte
  uint64_t lookup_mono = 0;   // parse done -> map lookup begins
  uint64_t dispatch_mono = 0; // lookup done -> upstream queued
  uint64_t enq_mono = 0;      // plane_pool timeout clock
  char rid[40] = {0};
  uint32_t rid_flags = 0;
  int64_t deadline_ms = -1;
};

using Upstream = plane_pool::Upstream<Pending>;

// one servable warm entry: exactly one plain chunk, whole-file, known
// geometry.  `gen` fences fills against later invalidations; a
// tombstone (valid=false) keeps the fence alive after invalidation.
struct EntryRec {
  std::string addr;   // volume read-plane host:port
  std::string fid;    // "vid,hexkeycookie"
  std::string mime;   // response Content-Type (resolved in Python)
  uint64_t size = 0;
  uint64_t gen = 0;   // stamp of the latest invalidation
  bool valid = false;
};

struct Server {
  int epfd = -1;
  int listen_fd = -1;
  int wake_pipe[2] = {-1, -1};
  std::thread loop;
  std::atomic<bool> stop{false};
  std::atomic<bool> armed{false};

  std::mutex entry_mu;
  std::unordered_map<std::string, EntryRec> entries;
  std::atomic<uint64_t> gen{0};       // invalidation generation clock
  uint64_t clear_gen = 0;             // gen at the last wholesale clear

  std::unordered_map<int, Conn> conns;
  plane_pool::Pool<Pending> pool;     // volume read-plane connections
  uint64_t gen_counter = 0;           // conn fd-reuse guard

  // telemetry (atomics: read from Python threads)
  std::atomic<uint64_t> requests{0};       // native 200s served
  std::atomic<uint64_t> fallbacks{0};      // 404 handoffs
  std::atomic<uint64_t> stale_misses{0};   // volume plane said 404
  std::atomic<uint64_t> upstream_errors{0};
  std::atomic<uint64_t> parse_ns{0};
  std::atomic<uint64_t> lookup_ns{0};
  std::atomic<uint64_t> fetch_ns{0};
  std::atomic<uint64_t> send_ns{0};
  std::atomic<uint64_t> lat_count[kLatN + 1];
  std::atomic<uint64_t> lat_sum_ns{0};

  RecRing rec;
  std::atomic<int> fetch_delay_ms{0};  // chaos/flight-deck failpoint
  uint64_t rid_seq = 0;
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

// -- epoll / HTTP plumbing (meta_plane.cc idiom) ----------------------

void conn_arm(Server* s, Conn* c, bool want_write) {
  if (c->want_write == want_write) return;
  c->want_write = want_write;
  epoll_event ev{};
  ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0u);
  ev.data.fd = c->fd;
  epoll_ctl(s->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

void close_conn(Server* s, int fd) {
  auto it = s->conns.find(fd);
  if (it == s->conns.end()) return;
  epoll_ctl(s->epfd, EPOLL_CTL_DEL, fd, nullptr);
  close(fd);
  s->conns.erase(it);
}

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

void respond_json(Server* s, Conn* c, int code, const char* reason,
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
  respond_json(s, c, 404, "Not Found",
               "{\"error\":\"read plane fallback\"}");
}

// the 200: mirror the Python front's header set for an eligible read
// (Content-Type + Content-Length) so plane-vs-python responses are
// interchangeable byte-for-byte in the body and equivalent on the
// wire.  The FULL body is already in hand — the framing promise is
// kept or never made.
void respond_data(Server* s, Conn* c, const std::string& mime,
                  const std::string& body) {
  char head[256];
  int n = snprintf(head, sizeof(head),
                   "HTTP/1.1 200 OK\r\n"
                   "Content-Type: %s\r\n"
                   "Content-Length: %zu\r\n"
                   "%s"
                   "\r\n",
                   mime.empty() ? "application/octet-stream"
                                : mime.c_str(),
                   body.size(),
                   c->close_after ? "Connection: close\r\n" : "");
  c->out.append(head, size_t(n));
  c->out.append(body);
  conn_arm(s, c, true);
}

void rec_emit(Server* s, const char* rid, uint32_t flags,
              int64_t deadline_ms, uint64_t total_ns, uint64_t parse,
              uint64_t lookup, uint64_t fetch, uint64_t bytes,
              int status, int fallback) {
  PlaneRec r{};
  snprintf(r.rid, sizeof(r.rid), "%s", rid);
  r.start_unix_ns = now_ns() - total_ns;
  r.stage_ns[0] = parse;
  r.stage_ns[1] = lookup;
  r.stage_ns[2] = fetch;
  uint64_t sum = parse + lookup + fetch;
  r.stage_ns[3] = total_ns > sum ? total_ns - sum : 0;
  r.bytes = bytes;
  r.deadline_ms = deadline_ms;
  r.status = status;
  r.fallback = fallback;
  r.flags = flags;
  rec_push(&s->rec, r);
}

void rec_emit_conn(Server* s, Conn* c, int status, int fallback) {
  uint64_t total =
      c->req_start_ns != 0 ? mono_ns() - c->req_start_ns : 0;
  rec_emit(s, c->rid, rid_rec_flags(c->rid, c->rid_client),
           c->deadline_ms, total, total, 0, 0, 0, status, fallback);
}

void rec_emit_pending(Server* s, const Pending& p, uint64_t bytes,
                      int status, int fallback) {
  uint64_t now = mono_ns();
  rec_emit(s, p.rid, p.rid_flags, p.deadline_ms, now - p.start_mono,
           p.lookup_mono - p.start_mono,
           p.dispatch_mono - p.lookup_mono, now - p.dispatch_mono,
           bytes, status, fallback);
}

// the exact byte set the Python dispatcher would pass through
// untransformed: printable ASCII minus quote, backslash, percent
// (urllib.unquote), query/fragment markers
bool path_bytes_ok(const std::string& p) {
  for (unsigned char ch : p) {
    if (ch < 0x21 || ch > 0x7E) return false;
    if (ch == '"' || ch == '\\' || ch == '%' || ch == '?' ||
        ch == '#')
      return false;
  }
  return true;
}

void record_latency(Server* s, uint64_t ns) {
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
  if (c->inflight == 0 && !c->in.empty()) client_feed(s, c);
}

// invalidate `path` from the event-loop side (a stale fetch proved
// the registration wrong) — same fencing as frp_invalidate
void invalidate_entry(Server* s, const std::string& path) {
  std::lock_guard<std::mutex> lk(s->entry_mu);
  uint64_t g = s->gen.fetch_add(1, std::memory_order_relaxed) + 1;
  if (s->entries.size() >= kMaxEntries &&
      s->entries.find(path) == s->entries.end()) {
    s->entries.clear();
    s->clear_gen = g;
    return;
  }
  EntryRec& rec = s->entries[path];
  rec.valid = false;
  rec.gen = g;
  rec.addr.clear();
  rec.fid.clear();
  rec.mime.clear();
  rec.size = 0;
}

// -- request handling -------------------------------------------------

void dispatch_fetch(Server* s, Conn* c, const EntryRec& rec,
                    uint64_t lookup_mono) {
  Pending p;
  p.client_fd = c->fd;
  p.client_gen = c->gen;
  p.path = c->target;
  p.mime = rec.mime;
  p.size = rec.size;
  p.start_mono = c->req_start_ns;
  p.lookup_mono = lookup_mono;
  p.dispatch_mono = mono_ns();
  p.enq_mono = p.dispatch_mono;
  // failpoint: stall the volume fetch hop (chaos tests widen the
  // in-flight window with this before delivering SIGKILL)
  int delay = s->fetch_delay_ms.load(std::memory_order_relaxed);
  if (delay > 0) usleep(useconds_t(delay) * 1000);
  memcpy(p.rid, c->rid, sizeof(p.rid));
  p.rid_flags = rid_rec_flags(c->rid, c->rid_client);
  p.deadline_ms = c->deadline_ms;
  s->parse_ns.fetch_add(lookup_mono - c->req_start_ns,
                        std::memory_order_relaxed);
  s->lookup_ns.fetch_add(p.dispatch_mono - lookup_mono,
                         std::memory_order_relaxed);
  Upstream* u = s->pool.pick(rec.addr);
  if (u == nullptr) {
    s->upstream_errors.fetch_add(1, std::memory_order_relaxed);
    rec_emit_conn(s, c, 404, kFbUpstream);
    respond_fallback(s, c);
    return;
  }
  // forward the request id + remaining deadline so the volume plane's
  // flight record stitches into the same trace
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
                   "GET /%s HTTP/1.1\r\n"
                   "Host: %s\r\n"
                   "X-Request-ID: %s\r\n"
                   "%s"
                   "\r\n",
                   rec.fid.c_str(), rec.addr.c_str(), c->rid, dlbuf);
  u->out.append(head, size_t(n));
  u->inflight.push_back(std::move(p));
  c->inflight = 1;
  // eager flush (plane_pool.h): no epoll round trip on the hot hop
  s->pool.flush(u);
}

void handle_request(Server* s, Conn* c) {
  const std::string& t = c->target;
  bool eligible =
      s->armed.load(std::memory_order_relaxed) && c->method == "GET" &&
      !t.empty() && t[0] == '/' && t.size() < kMaxPath &&
      t.back() != '/' && t.find("//") == std::string::npos &&
      t.compare(0, 3, "/__") != 0 && path_bytes_ok(t) &&
      c->body.empty();
  if (eligible) {
    // anything that changes the RESPONSE (ranges, conditionals,
    // auth-derived denial, tenant QoS) stays with Python
    if (has_header(c->req_headers, "Range") ||
        has_header(c->req_headers, "Authorization") ||
        has_header(c->req_headers, "Expect") ||
        has_header(c->req_headers, "If-None-Match") ||
        has_header(c->req_headers, "If-Modified-Since") ||
        has_header(c->req_headers, "X-Tenant"))
      eligible = false;
  }
  if (!eligible) {
    c->body.clear();
    rec_emit_conn(s, c, 404, kFbIneligible);
    respond_fallback(s, c);
    return;
  }
  uint64_t lookup_mono = mono_ns();
  EntryRec rec;
  bool found = false;
  {
    std::lock_guard<std::mutex> lk(s->entry_mu);
    auto it = s->entries.find(t);
    if (it != s->entries.end() && it->second.valid) {
      rec = it->second;   // copy out: the fetch outlives the lock
      found = true;
    }
  }
  if (!found) {
    rec_emit_conn(s, c, 404, kFbUnknownPath);
    respond_fallback(s, c);
    return;
  }
  dispatch_fetch(s, c, rec, lookup_mono);
}

void client_feed(Server* s, Conn* c) {
  for (;;) {
    if (c->inflight > 0) return;   // parked on an upstream fetch
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
      long long need = cl.empty() ? 0 : atoll(cl.c_str());
      if (!te.empty() || need < 0 || size_t(need) > kMaxBody) {
        // framing we won't parse on a read plane — refuse and close
        c->close_after = true;
        rec_emit_conn(s, c, 404, kFbIneligible);
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
    handle_request(s, c);
    auto it = s->conns.find(c->fd);
    if (it == s->conns.end() || &it->second != c) return;
    c->req_start_ns = 0;
    if (c->inflight == 0 && !c->out.empty()) {
      flush_client(s, c->fd);
      it = s->conns.find(c->fd);
      if (it == s->conns.end()) return;
    }
  }
}

// one dropped in-flight fetch (conn error / timeout), handed back by
// the pool: the waiting client falls back to Python
void ups_drop_pending(Server* s, Pending& p) {
  s->upstream_errors.fetch_add(1, std::memory_order_relaxed);
  rec_emit_pending(s, p, 0, 404, kFbUpstream);
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
  uint64_t t_fetched = mono_ns();
  s->fetch_ns.fetch_add(t_fetched - p.dispatch_mono,
                        std::memory_order_relaxed);
  auto cit = s->conns.find(p.client_fd);
  bool alive =
      cit != s->conns.end() && cit->second.gen == p.client_gen;
  if (status == 200 && body.size() == p.size) {
    if (alive) {
      Conn* c = &cit->second;
      c->inflight = 0;
      c->req_start_ns = 0;
      s->requests.fetch_add(1, std::memory_order_relaxed);
      respond_data(s, c, p.mime, body);
      record_latency(s, mono_ns() - p.start_mono);
      rec_emit_pending(s, p, body.size(), 200, kFbNone);
      uint64_t t_sent = mono_ns();
      s->send_ns.fetch_add(t_sent - t_fetched,
                           std::memory_order_relaxed);
      flush_client(s, p.client_fd);
    }
    return true;
  }
  // the volume plane refused: a 404 means OUR registration is stale
  // (vacuum/EC swap, delete raced the map) — drop it so the next
  // request falls back cleanly instead of re-fetching garbage
  if (status == 404) {
    s->stale_misses.fetch_add(1, std::memory_order_relaxed);
    invalidate_entry(s, p.path);
    if (alive) {
      cit->second.inflight = 0;
      cit->second.req_start_ns = 0;
      rec_emit_pending(s, p, 0, 404, kFbStale);
      respond_fallback(s, &cit->second);
      flush_client(s, p.client_fd);
    }
    return true;
  }
  s->upstream_errors.fetch_add(1, std::memory_order_relaxed);
  if (alive) {
    cit->second.inflight = 0;
    cit->second.req_start_ns = 0;
    rec_emit_pending(s, p, 0, 404, kFbUpstream);
    respond_fallback(s, &cit->second);
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
    s->pool.expire(mono_ns());
  }
}

}  // namespace

// -- extern "C" API ----------------------------------------------------

extern "C" {

// Start a filer read plane bound to host:port (0 = ephemeral); the
// bound port reports through out_port.  Returns a handle >= 0, or -1.
int frp_start(const char* host, int port, int* out_port) {
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
  s->rec.cap = rec_ring_cap_env();
  s->rec.recs.resize(s->rec.cap);
  // the minted-rid prefix keeps the plane-sibling shape ("rpNN...")
  // so the volume plane flags our forwarded ids as minted-upstream
  snprintf(s->rid_prefix, sizeof(s->rid_prefix), "rp%02d%06llx", slot,
           static_cast<unsigned long long>(now_ns() & 0xffffff));
  {
    const char* d = getenv("SEAWEEDFS_TPU_FRP_FETCH_DELAY_MS");
    if (d != nullptr && *d != '\0') s->fetch_delay_ms.store(atoi(d));
  }
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
  if (s->wake_pipe[0] >= 0) close(s->wake_pipe[0]);
  if (s->wake_pipe[1] >= 0) close(s->wake_pipe[1]);
  delete s;
  return -1;
}

void frp_stop(int h) {
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
  close(s->listen_fd);
  close(s->epfd);
  close(s->wake_pipe[0]);
  close(s->wake_pipe[1]);
  delete s;
}

// arm/disarm the hot path (disarmed = every request answers the 404
// fallback; the listener stays up so clients need no re-discovery)
void frp_arm(int h, int on) {
  Server* s = get_server(h);
  if (s != nullptr) s->armed.store(on != 0);
}

// current invalidation generation — the fill-fence token.  Python
// captures this BEFORE looking an entry up (begin_fill protocol);
// frp_put_entry refuses a fill whose token pre-dates any later
// invalidation of that path.
unsigned long long frp_gen(int h) {
  Server* s = get_server(h);
  return s != nullptr ? s->gen.load(std::memory_order_relaxed) : 0;
}

// register/refresh one warm servable entry; returns 0 on insert, -1
// when the fill lost the fence race (an invalidation intervened) or
// the server is gone.  Refused fills are NOT an error — the path
// simply stays fallback until a fresher fill lands.
int frp_put_entry(int h, const char* path, const char* addr,
                  const char* fid, const char* mime,
                  unsigned long long size, unsigned long long gen0) {
  Server* s = get_server(h);
  if (s == nullptr || path == nullptr || addr == nullptr ||
      fid == nullptr)
    return -1;
  std::lock_guard<std::mutex> lk(s->entry_mu);
  if (gen0 < s->clear_gen) return -1;   // a wholesale clear intervened
  auto it = s->entries.find(path);
  if (it != s->entries.end() && it->second.gen > gen0) return -1;
  if (it == s->entries.end() && s->entries.size() >= kMaxEntries) {
    // overflow: drop everything (all reads fall back, never stale)
    s->entries.clear();
    s->clear_gen =
        s->gen.fetch_add(1, std::memory_order_relaxed) + 1;
    return -1;
  }
  EntryRec& rec = s->entries[path];
  rec.addr = addr;
  rec.fid = fid;
  rec.mime = mime != nullptr ? mime : "";
  rec.size = size;
  rec.valid = true;
  return 0;
}

// invalidate one path (EVERY mutation event lands here, from the
// filer's own listener and the WAL-follower tap, synchronously before
// the writer's ack returns): the map can no longer serve it, and the
// generation fence kills any in-flight fill that pre-dates this.
void frp_invalidate(int h, const char* path) {
  Server* s = get_server(h);
  if (s == nullptr || path == nullptr) return;
  invalidate_entry(s, std::string(path));
}

// drop all entries (teardown / coarse recovery)
void frp_clear(int h) {
  Server* s = get_server(h);
  if (s == nullptr) return;
  std::lock_guard<std::mutex> lk(s->entry_mu);
  s->entries.clear();
  s->clear_gen = s->gen.fetch_add(1, std::memory_order_relaxed) + 1;
}

// live entry-map size (tombstones included; gauge on /metrics)
int frp_entries(int h) {
  Server* s = get_server(h);
  if (s == nullptr) return -1;
  std::lock_guard<std::mutex> lk(s->entry_mu);
  return int(s->entries.size());
}

unsigned long long frp_requests(int h) {
  Server* s = get_server(h);
  return s != nullptr ? s->requests.load() : 0;
}

unsigned long long frp_fallbacks(int h) {
  Server* s = get_server(h);
  return s != nullptr ? s->fallbacks.load() : 0;
}

// out[0..kLatN]: cumulative bucket counts; out[kLatN+1]=count,
// out[kLatN+2]=sum ns (same shape as mp_latency)
int frp_latency(int h, unsigned long long* out) {
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
// [requests, fallbacks, stale_misses, upstream_errors,
//  parse_ns, lookup_ns, fetch_ns, send_ns]
int frp_stats(int h, unsigned long long* out) {
  Server* s = get_server(h);
  if (s == nullptr || out == nullptr) return -1;
  out[0] = s->requests.load();
  out[1] = s->fallbacks.load();
  out[2] = s->stale_misses.load();
  out[3] = s->upstream_errors.load();
  out[4] = s->parse_ns.load();
  out[5] = s->lookup_ns.load();
  out[6] = s->fetch_ns.load();
  out[7] = s->send_ns.load();
  return 8;
}

int frp_drain_records(int h, PlaneRec* out, int cap) {
  Server* s = get_server(h);
  if (s == nullptr) return -1;
  return rec_drain(&s->rec, out, cap);
}

unsigned long long frp_records_dropped(int h) {
  Server* s = get_server(h);
  return s != nullptr ? rec_dropped(&s->rec) : 0;
}

// failpoint: stall the volume fetch hop by `ms` per request (0 = off)
void frp_set_fetch_delay_ms(int h, int ms) {
  Server* s = get_server(h);
  if (s != nullptr) s->fetch_delay_ms.store(ms < 0 ? 0 : ms);
}

}  // extern "C"
