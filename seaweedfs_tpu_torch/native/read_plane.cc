// Native HTTP read plane for the volume server — the C++ sibling of the
// reference's second native implementation of the read surface
// (seaweed-volume/ Rust volume server, VOLUME_SERVER_RUST_PLAN.md) and
// of its RDMA read sidecar (seaweedfs-rdma-sidecar/rdma-engine):
// a single-threaded epoll loop serving `GET /<vid>,<fid>` straight from
// the .dat file descriptors via sendfile(2), bypassing the Python HTTP
// stack entirely on the hot read path.
//
// Scope (deliberate): plain anonymous needles only — the Python server
// registers an entry (vid, needle id) -> (cookie, absolute data offset,
// data length) at write time / on first read, and only for needles with
// no compression, no name/mime, no TTL and no chunk manifest; anything
// unregistered answers 404 and the client falls back to the full Python
// path (same contract as the UDS plane, server/uds_reader.py).  Deletes
// and vacuum drop entries/volumes; a dropped volume lazily re-registers.
//
// Wire behavior: HTTP/1.1, keep-alive, Content-Length framing,
// ETag "<cookie-hex>", 404 unknown, 400 malformed, 405 non-GET/HEAD.
//
// Build: g++ -O2 -shared -fPIC (no deps); driven via ctypes from
// seaweedfs_tpu_torch/server/read_plane.py.

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
#include <sys/sendfile.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

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

// -- per-request flight records ----------------------------------------
//
// Identical wire shape to write_plane.cc's PlaneRec.

constexpr uint32_t kRecFlagClientRid = 1u;
// a wire rid of the plane-minted shape (e.g. "wp00c0ffee-1")
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
  kFbMethod = 1,
  kFbBadRequest = 2,
  kFbNotFound = 3,
};

// The labels of a record's stage and fallback indices.
const char* const kRecStageNames[] = {"parse", "lookup", "send", "ack"};
const char* const kRecFallbackNames[] = {"none", "method",
                                         "bad_request", "not_found"};

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
    if (n >= 16 && n <= (1 << 20)) return (uint64_t)n;
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
  uint64_t first = t - (uint64_t)n;
  if (h2 > first + r->cap) {   // lapped mid-copy: drop torn prefix
    uint64_t torn = h2 - r->cap - first;
    if (torn > (uint64_t)n) torn = (uint64_t)n;
    if (torn > 0) {
      memmove(out, out + torn,
              ((size_t)n - (size_t)torn) * sizeof(PlaneRec));
      n -= (int)torn;
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

struct Entry {
  uint32_t cookie;
  uint64_t off;    // absolute byte offset of the data payload in .dat
  uint32_t len;    // payload length
};

struct VolumeIdx {
  int fd = -1;
  std::unordered_map<uint64_t, Entry> needles;
};

struct Conn {
  int fd;
  std::string in;          // accumulated request bytes
  std::string out;         // pending response header bytes
  int file_fd = -1;        // pending sendfile source (-1 = none)
  off_t file_off = 0;
  size_t file_left = 0;
  bool close_after = false;
  // flight-record carry for the in-flight body response (at most one:
  // the request loop stalls while file_left > 0)
  bool rec_armed = false;
  uint64_t rec_handoff_mono = 0;
  uint64_t rec_parse_ns = 0;
  uint64_t rec_lookup_ns = 0;
  uint64_t rec_bytes = 0;
  char rid[40] = {0};
  bool rid_client = false;
  int64_t deadline_ms = -1;
};

struct Server {
  int epfd = -1;
  int listen_fd = -1;
  int wake_pipe[2] = {-1, -1};
  std::thread loop;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> served{0};
  std::shared_mutex idx_mu;
  std::unordered_map<uint32_t, VolumeIdx> volumes;
  std::unordered_map<int, Conn*> conns;
  // per-request flight records
  RecRing rec;
  uint64_t rid_seq = 0;    // event-loop thread only
  char rid_prefix[16] = {0};
};

constexpr int kMaxServers = 16;
Server* g_servers[kMaxServers] = {nullptr};
std::mutex g_servers_mu;

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void close_conn(Server* s, Conn* c) {
  epoll_ctl(s->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  close(c->fd);
  if (c->file_fd >= 0) close(c->file_fd);
  s->conns.erase(c->fd);
  delete c;
}

void arm(Server* s, Conn* c, bool want_write) {
  epoll_event ev{};
  ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0);
  ev.data.fd = c->fd;
  epoll_ctl(s->epfd, EPOLL_CTL_MOD, c->fd, &ev);
}

// parse "<vid>,<keyhex><cookie8hex>" -> vid, key, cookie
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
  if (hn < 9 || hn > 24) return false;  // >= 1 key nibble + 8 cookie
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

void respond_simple(Conn* c, const char* status_line) {
  char buf[160];
  int n = snprintf(buf, sizeof buf,
                   "HTTP/1.1 %s\r\nContent-Length: 0\r\n\r\n",
                   status_line);
  c->out.append(buf, n);
}

// case-insensitive header lookup inside a raw header block (the
// request line leads the block; a method never matches "Name:")
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

// append one flight record framed off the conn's carry fields
void rec_emit(Server* s, Conn* c, uint64_t send_ns, uint64_t total_ns,
              int status, int fallback) {
  PlaneRec r{};
  snprintf(r.rid, sizeof(r.rid), "%s", c->rid);
  r.start_unix_ns = now_ns() - total_ns;
  r.stage_ns[0] = c->rec_parse_ns;
  r.stage_ns[1] = c->rec_lookup_ns;
  r.stage_ns[2] = send_ns;
  uint64_t sum = c->rec_parse_ns + c->rec_lookup_ns + send_ns;
  r.stage_ns[3] = total_ns > sum ? total_ns - sum : 0;
  r.bytes = c->rec_bytes;
  r.deadline_ms = c->deadline_ms;
  r.status = status;
  r.fallback = fallback;
  r.flags = rid_rec_flags(c->rid, c->rid_client);
  rec_push(&s->rec, r);
}

// returns false when the connection must close (malformed framing)
bool handle_one_request(Server* s, Conn* c, const std::string& req) {
  uint64_t t0 = mono_ns();
  c->rec_parse_ns = 0;
  c->rec_lookup_ns = 0;
  c->rec_bytes = 0;
  std::string rid = header_value(req, "X-Request-ID");
  if (!rid.empty()) {
    snprintf(c->rid, sizeof(c->rid), "%.39s", rid.c_str());
    c->rid_client = true;
  } else {
    snprintf(c->rid, sizeof(c->rid), "%s-%llx", s->rid_prefix,
             (unsigned long long)++s->rid_seq);
    c->rid_client = false;
  }
  std::string dl = header_value(req, "X-Weed-Deadline-Ms");
  c->deadline_ms = dl.empty() ? -1 : (int64_t)atoll(dl.c_str());
  // request line: METHOD SP target SP version
  size_t sp1 = req.find(' ');
  size_t sp2 = (sp1 == std::string::npos)
                   ? std::string::npos
                   : req.find(' ', sp1 + 1);
  if (sp2 == std::string::npos) return false;
  std::string method = req.substr(0, sp1);
  std::string target = req.substr(sp1 + 1, sp2 - sp1 - 1);
  bool head = method == "HEAD";
  if (method != "GET" && !head) {
    respond_simple(c, "405 Method Not Allowed");
    c->rec_parse_ns = mono_ns() - t0;
    rec_emit(s, c, 0, mono_ns() - t0, 405, kFbMethod);
    return true;
  }
  // strip query + leading slash
  size_t q = target.find('?');
  if (q != std::string::npos) target.resize(q);
  if (target.empty() || target[0] != '/') {
    respond_simple(c, "400 Bad Request");
    c->rec_parse_ns = mono_ns() - t0;
    rec_emit(s, c, 0, mono_ns() - t0, 400, kFbBadRequest);
    return true;
  }
  uint32_t vid, cookie;
  uint64_t key;
  if (!parse_fid(target.data() + 1, target.size() - 1, &vid, &key,
                 &cookie)) {
    respond_simple(c, "404 Not Found");
    c->rec_parse_ns = mono_ns() - t0;
    rec_emit(s, c, 0, mono_ns() - t0, 404, kFbNotFound);
    return true;
  }
  c->rec_parse_ns = mono_ns() - t0;
  uint64_t t_lk = mono_ns();
  int fd = -1;
  Entry e{};
  {
    std::shared_lock<std::shared_mutex> lk(s->idx_mu);
    auto vit = s->volumes.find(vid);
    if (vit != s->volumes.end() && vit->second.fd >= 0) {
      auto nit = vit->second.needles.find(key);
      if (nit != vit->second.needles.end() &&
          nit->second.cookie == cookie) {
        // dup under the lock: rp_remove_volume/rp_add_volume may
        // close the volume fd concurrently; the connection owns its
        // duplicate for the lifetime of the sendfile
        fd = dup(vit->second.fd);
        e = nit->second;
      }
    }
  }
  c->rec_lookup_ns = mono_ns() - t_lk;
  if (fd < 0) {
    respond_simple(c, "404 Not Found");
    rec_emit(s, c, 0, mono_ns() - t0, 404, kFbNotFound);
    return true;
  }
  char hdr[224];
  int hn = snprintf(hdr, sizeof hdr,
                    "HTTP/1.1 200 OK\r\n"
                    "Content-Type: application/octet-stream\r\n"
                    "Content-Length: %u\r\n"
                    "ETag: \"%08x\"\r\n"
                    "Accept-Ranges: bytes\r\n\r\n",
                    e.len, cookie);
  c->out.append(hdr, hn);
  c->rec_bytes = head ? 0 : e.len;
  if (!head && e.len > 0) {
    c->file_fd = fd;           // owned (dup); closed when drained
    c->file_off = (off_t)e.off;
    c->file_left = e.len;
    // record finalized in flush_out once the body drains: the send
    // stage spans the sendfile window, not just header queueing
    c->rec_armed = true;
    c->rec_handoff_mono = mono_ns();
  } else {
    close(fd);
    rec_emit(s, c, 0, mono_ns() - t0, 200, kFbNone);
  }
  s->served.fetch_add(1, std::memory_order_relaxed);
  return true;
}

// drain pending output; returns false on fatal error
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
  while (c->file_left > 0) {
    ssize_t n = sendfile(c->fd, c->file_fd, &c->file_off,
                         c->file_left > (1 << 20) ? (1 << 20)
                                                  : c->file_left);
    if (n > 0) {
      c->file_left -= (size_t)n;
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return true;
    return false;
  }
  if (c->file_fd >= 0) {
    close(c->file_fd);
    c->file_fd = -1;
  }
  if (c->rec_armed && c->file_left == 0) {
    uint64_t send_ns = mono_ns() - c->rec_handoff_mono;
    rec_emit(s, c, send_ns,
             c->rec_parse_ns + c->rec_lookup_ns + send_ns, 200,
             kFbNone);
    c->rec_armed = false;
  }
  return true;
}

void event_loop(Server* s) {
  epoll_event evs[64];
  while (!s->stop.load(std::memory_order_relaxed)) {
    int n = epoll_wait(s->epfd, evs, 64, 500);
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
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        dead = true;
      }
      if (!dead && (evs[i].events & EPOLLIN)) {
        char buf[8192];
        for (;;) {
          ssize_t r = recv(fd, buf, sizeof buf, 0);
          if (r > 0) {
            c->in.append(buf, (size_t)r);
            if (c->in.size() > (64 << 10)) {  // header flood guard
              dead = true;
              break;
            }
            continue;
          }
          if (r == 0) {
            dead = c->in.empty() && c->out.empty() &&
                   c->file_left == 0;
            c->close_after = true;
            break;
          }
          if (errno == EAGAIN || errno == EWOULDBLOCK) break;
          dead = true;
          break;
        }
      }
      // process complete requests (pipelining-tolerant), but only while
      // no body transfer is pending: responses must be emitted in order.
      // Also on an EPOLLOUT that finished a transfer: the requests
      // pipelined behind it wait in c->in, and no EPOLLIN may ever come
      // for them.
      while (!dead) {
        while (!dead && c->file_left == 0) {
          size_t end = c->in.find("\r\n\r\n");
          if (end == std::string::npos) break;
          std::string req = c->in.substr(0, end);
          c->in.erase(0, end + 4);
          if (!handle_one_request(s, c, req)) dead = true;
        }
        if (!dead && !flush_out(s, c)) dead = true;
        if (dead || c->file_left > 0 || !c->out.empty() ||
            c->in.find("\r\n\r\n") == std::string::npos)
          break;
      }
      if (!dead && c->close_after && c->out.empty() &&
          c->file_left == 0) {
        dead = true;
      }
      if (dead) {
        close_conn(s, c);
      } else {
        arm(s, c, !c->out.empty() || c->file_left > 0);
      }
    }
  }
  // teardown
  for (auto& kv : s->conns) {
    close(kv.second->fd);
    if (kv.second->file_fd >= 0) close(kv.second->file_fd);
    delete kv.second;
  }
  s->conns.clear();
}

}  // namespace

extern "C" {

int rp_start(const char* host, int port, int* bound_port) {
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
  s->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (s->listen_fd < 0) return -1;
  int one = 1;
  setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) return -1;
  if (bind(s->listen_fd, (sockaddr*)&addr, sizeof addr) < 0 ||
      listen(s->listen_fd, 512) < 0) {
    close(s->listen_fd);
    return -1;
  }
  socklen_t alen = sizeof addr;
  getsockname(s->listen_fd, (sockaddr*)&addr, &alen);
  *bound_port = ntohs(addr.sin_port);
  s->rec.cap = rec_ring_cap_env();
  s->rec.recs.resize(s->rec.cap);
  snprintf(s->rid_prefix, sizeof(s->rid_prefix), "rp%02d%06llx", slot,
           (unsigned long long)(now_ns() & 0xffffff));
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

void rp_stop(int h) {
  Server* s;
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    if (h < 0 || h >= kMaxServers || g_servers[h] == nullptr) return;
    s = g_servers[h];
    g_servers[h] = nullptr;
  }
  s->stop.store(true);
  (void)!write(s->wake_pipe[1], "x", 1);
  s->loop.join();
  close(s->listen_fd);
  close(s->epfd);
  close(s->wake_pipe[0]);
  close(s->wake_pipe[1]);
  {
    std::unique_lock<std::shared_mutex> lk(s->idx_mu);
    for (auto& kv : s->volumes) {
      if (kv.second.fd >= 0) close(kv.second.fd);
    }
  }
  delete s;
}

static Server* get_server(int h) {
  std::lock_guard<std::mutex> lk(g_servers_mu);
  if (h < 0 || h >= kMaxServers) return nullptr;
  return g_servers[h];
}

int rp_add_volume(int h, unsigned vid, const char* dat_path) {
  Server* s = get_server(h);
  if (s == nullptr) return -1;
  int fd = open(dat_path, O_RDONLY);
  if (fd < 0) return -1;
  std::unique_lock<std::shared_mutex> lk(s->idx_mu);
  VolumeIdx& v = s->volumes[vid];
  if (v.fd >= 0) close(v.fd);  // refresh (post-vacuum fd swap)
  v.fd = fd;
  v.needles.clear();
  return 0;
}

void rp_remove_volume(int h, unsigned vid) {
  Server* s = get_server(h);
  if (s == nullptr) return;
  std::unique_lock<std::shared_mutex> lk(s->idx_mu);
  auto it = s->volumes.find(vid);
  if (it != s->volumes.end()) {
    if (it->second.fd >= 0) close(it->second.fd);
    s->volumes.erase(it);
  }
}

int rp_put(int h, unsigned vid, unsigned long long nid,
           unsigned cookie, unsigned long long data_off,
           unsigned data_len) {
  Server* s = get_server(h);
  if (s == nullptr) return -1;
  std::unique_lock<std::shared_mutex> lk(s->idx_mu);
  auto it = s->volumes.find(vid);
  if (it == s->volumes.end() || it->second.fd < 0) return -1;
  it->second.needles[nid] = Entry{cookie, data_off, data_len};
  return 0;
}

void rp_del(int h, unsigned vid, unsigned long long nid) {
  Server* s = get_server(h);
  if (s == nullptr) return;
  std::unique_lock<std::shared_mutex> lk(s->idx_mu);
  auto it = s->volumes.find(vid);
  if (it != s->volumes.end()) it->second.needles.erase(nid);
}

unsigned long long rp_served(int h) {
  Server* s = get_server(h);
  return s == nullptr ? 0 : s->served.load();
}

// drain up to `cap` flight records into `out`; returns the count
int rp_drain_records(int h, PlaneRec* out, int cap) {
  Server* s = get_server(h);
  if (s == nullptr) return 0;
  return rec_drain(&s->rec, out, cap);
}

unsigned long long rp_records_dropped(int h) {
  Server* s = get_server(h);
  return s == nullptr ? 0 : rec_dropped(&s->rec);
}

}  // extern "C"
