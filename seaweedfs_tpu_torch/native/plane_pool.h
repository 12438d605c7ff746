// Shared persistent plane-socket pool, the port's copy of
// `seaweedfs_tpu/native/plane_pool.h`.
//
// Both filer-side native planes talk to volume-side native planes over
// pipelined keep-alive TCP connections: the meta plane POSTs chunk
// bodies into write_plane.cc, the read plane GETs needle bytes out of
// read_plane.cc.  `flush()` sends EAGERLY: a dispatch that only
// appended to the upstream buffer and armed EPOLLOUT would pay a full
// epoll round trip (wait return, event dispatch, flush) per upstream
// hop even though the established socket is writable almost always.
// Eager send drains the
// buffer inline at dispatch and falls back to EPOLLOUT only on a
// genuinely full socket (or a still-connecting one, where Linux
// send(2) answers EAGAIN until the handshake lands).
//
// The pool owns connection lifecycle (open/pick/flush/expire/close);
// response PARSING stays in each plane — the wire formats differ
// (201-JSON acks vs 200-octet-stream bodies) and so does what a
// completed response means.  `Pending` is the per-plane in-flight
// request type; the pool requires only that it expose `enq_mono`
// (the enqueue stamp the idle-timeout reaper keys on).  Failed
// connections hand their FIFO of in-flight requests back through
// `on_drop`, one at a time, for the plane to answer with its 404
// fallback contract.
//
// Single-threaded by contract: every method runs on the owning
// plane's event-loop thread (the same contract as the planes' own state).

#ifndef SEAWEEDFS_TPU_NATIVE_PLANE_POOL_H_
#define SEAWEEDFS_TPU_NATIVE_PLANE_POOL_H_

#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <deque>
#include <functional>
#include <map>
#include <string>
#include <unordered_map>
#include <vector>

namespace plane_pool {

template <typename Pending>
struct Upstream {
  int fd = -1;
  std::string addr;
  std::string in;              // response bytes being assembled
  std::string out;             // request bytes awaiting the socket
  bool have_headers = false;   // response-parse state (plane-owned)
  size_t header_end = 0;
  size_t body_need = 0;
  int status = 0;
  std::deque<Pending> inflight;  // FIFO: planes answer in order
  bool want_write = false;
};

template <typename Pending>
struct Pool {
  int epfd = -1;
  size_t per_addr = 4;
  size_t pipeline_high = 32;   // per-conn inflight split point
  uint64_t timeout_ns = 5ull * 1000 * 1000 * 1000;
  // a dropped in-flight request (conn error / timeout); the plane
  // answers its client with the 404 fallback
  std::function<void(Pending&)> on_drop;

  std::map<std::string, std::vector<int>> by_addr;
  std::unordered_map<int, Upstream<Pending>> ups;

  Upstream<Pending>* find(int fd) {
    auto it = ups.find(fd);
    return it == ups.end() ? nullptr : &it->second;
  }

  void arm(Upstream<Pending>* u, bool want_write) {
    if (u->want_write == want_write) return;
    u->want_write = want_write;
    epoll_event ev{};
    ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0u);
    ev.data.fd = u->fd;
    epoll_ctl(epfd, EPOLL_CTL_MOD, u->fd, &ev);
  }

  int open_conn(const std::string& addr) {
    size_t colon = addr.rfind(':');
    if (colon == std::string::npos) return -1;
    std::string host = addr.substr(0, colon);
    int port = atoi(addr.c_str() + colon + 1);
    sockaddr_in sa{};
    sa.sin_family = AF_INET;
    sa.sin_port = htons(uint16_t(port));
    if (inet_pton(AF_INET, host.c_str(), &sa.sin_addr) != 1) return -1;
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    int rc = connect(fd, reinterpret_cast<sockaddr*>(&sa), sizeof(sa));
    if (rc < 0 && errno != EINPROGRESS) {
      close(fd);
      return -1;
    }
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = fd;
    if (epoll_ctl(epfd, EPOLL_CTL_ADD, fd, &ev) < 0) {
      close(fd);
      return -1;
    }
    Upstream<Pending> u;
    u.fd = fd;
    u.addr = addr;
    ups[fd] = std::move(u);
    by_addr[addr].push_back(fd);
    return fd;
  }

  void fail_inflight(Upstream<Pending>* u) {
    while (!u->inflight.empty()) {
      Pending p = std::move(u->inflight.front());
      u->inflight.pop_front();
      if (on_drop) on_drop(p);
    }
  }

  void close_conn(int fd) {
    auto it = ups.find(fd);
    if (it == ups.end()) return;
    fail_inflight(&it->second);
    auto& v = by_addr[it->second.addr];
    for (size_t i = 0; i < v.size(); i++)
      if (v[i] == fd) {
        v.erase(v.begin() + long(i));
        break;
      }
    epoll_ctl(epfd, EPOLL_CTL_DEL, fd, nullptr);
    close(fd);
    ups.erase(it);
  }

  // least-loaded connection for `addr`, growing the per-addr set up
  // to `per_addr` once every member is past the pipeline split.  May
  // return a saturated conn (or null on connect failure) — the
  // caller degrades to its fallback contract.
  Upstream<Pending>* pick(const std::string& addr) {
    auto& v = by_addr[addr];
    Upstream<Pending>* best = nullptr;
    for (int fd : v) {
      Upstream<Pending>* u = &ups[fd];
      if (best == nullptr ||
          u->inflight.size() < best->inflight.size())
        best = u;
    }
    if (best != nullptr && best->inflight.size() < pipeline_high)
      return best;
    if (v.size() < per_addr) {
      int fd = open_conn(addr);
      if (fd >= 0) return &ups[fd];
    }
    return best;
  }

  // EAGER flush: drain u->out inline, arming EPOLLOUT only when the
  // socket pushes back.  Call right after appending a request (the
  // dispatch hop) and again on EPOLLOUT readiness.
  void flush(Upstream<Pending>* u) {
    while (!u->out.empty()) {
      ssize_t n =
          send(u->fd, u->out.data(), u->out.size(), MSG_NOSIGNAL);
      if (n > 0) {
        u->out.erase(0, size_t(n));
        continue;
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        arm(u, true);
        return;
      }
      close_conn(u->fd);
      return;
    }
    arm(u, false);
  }

  // reap connections whose OLDEST in-flight request has been waiting
  // past the timeout (a wedged volume plane fails the whole conn; the
  // clients fall back and the next request redials)
  void expire(uint64_t now_mono_ns) {
    std::vector<int> dead;
    for (auto& kv : ups) {
      Upstream<Pending>& u = kv.second;
      if (!u.inflight.empty() &&
          now_mono_ns - u.inflight.front().enq_mono > timeout_ns)
        dead.push_back(kv.first);
    }
    for (int fd : dead) close_conn(fd);
  }

  // teardown after the event loop has stopped: raw close, no epoll,
  // no on_drop (the clients are being torn down too)
  void close_all() {
    for (auto& kv : ups) close(kv.second.fd);
    ups.clear();
    by_addr.clear();
  }
};

}  // namespace plane_pool

#endif  // SEAWEEDFS_TPU_NATIVE_PLANE_POOL_H_
