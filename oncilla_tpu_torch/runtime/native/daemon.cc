// oncillamemd — the native per-host daemon for oncilla-tpu.
//
// Production C++ twin of the Python reference implementation in
// oncilla_tpu/runtime/daemon.py, speaking the identical wire protocol
// (protocol.hh). The analogue of the reference's bin/oncillamem
// (its src/main.c + mem.c + alloc.c): an epoll-driven TCP
// server (per-connection frame state machines; a bounded worker pool
// serves the DATA plane, control messages keep their blocking semantics
// on per-message threads), rank-0 placement master (capacity-aware or
// neighbor round-robin), allocation registry with heartbeat-renewed
// leases (the liveness upgrade the reference left as a TODO,
// main.c:6-7), and the DCN data plane serving one-sided put/get into a
// daemon-owned host arena — with the v2 data-plane capabilities
// (FLAG_CAP_COALESCE ACK coalescing, zero-copy recv-into-arena DATA_PUT
// landings) the Python daemon grew.
//
// Build: cmake -S . -B build && cmake --build build   (or: make)
// Run:   oncillamemd --nodefile FILE --rank N [flags]

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <fcntl.h>
#include <unistd.h>

#include <deque>

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cstdlib>
#include <condition_variable>
#include <cerrno>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <memory>
#include <mutex>
#include <set>
#include <sstream>
#include <thread>
#include <vector>

#include "arena.hh"
#include "membership.hh"
#include "net.hh"
#include "obs.hh"
#include "protocol.hh"

namespace ocm {
namespace {

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Serve-span op names for the types this daemon dispatches (the Python
// daemon's "srv_" + msg.type.name.lower(); data ops use the dcn_*_srv
// names the obs cluster table and Perfetto export already know).
const char* srv_op_name(MsgType t) {
  switch (t) {
    case MsgType::DATA_PUT: return "dcn_put_srv";
    case MsgType::DATA_GET: return "dcn_get_srv";
    case MsgType::CONNECT: return "srv_connect";
    case MsgType::DISCONNECT: return "srv_disconnect";
    case MsgType::ADD_NODE: return "srv_add_node";
    case MsgType::REQ_ALLOC: return "srv_req_alloc";
    case MsgType::DO_ALLOC: return "srv_do_alloc";
    case MsgType::REQ_FREE: return "srv_req_free";
    case MsgType::DO_FREE: return "srv_do_free";
    case MsgType::NOTE_FREE: return "srv_note_free";
    case MsgType::NOTE_ALLOC: return "srv_note_alloc";
    case MsgType::RECLAIM_APP: return "srv_reclaim_app";
    case MsgType::HEARTBEAT: return "srv_heartbeat";
    case MsgType::STATUS: return "srv_status";
    case MsgType::STATUS_PROM: return "srv_status_prom";
    case MsgType::STATUS_EVENTS: return "srv_status_events";
    case MsgType::PLANE_SERVE: return "srv_plane_serve";
    case MsgType::PLANE_PUT: return "srv_plane_put";
    case MsgType::PLANE_GET: return "srv_plane_get";
    case MsgType::PLANE_SCRUB: return "srv_plane_scrub";
    default: return "srv_msg";
  }
}

// Per-CONNECTION bulk-reply buffer pool. The epoll serve core hands a
// connection's messages to whichever worker is free, so a per-THREAD
// pool would interleave unrelated connections' reply buffers (and lose
// the reuse whenever a different worker picks the next chunk);
// per-connection pooling keeps the win — no fresh >=16 MiB allocation
// (mmap + first-touch page faults) per DATA_GET chunk — with ownership
// that matches the serve core's one-message-per-connection discipline.
// take_bulk_buffer hands the pooled capacity to a reply under
// construction; reclaim_bulk_buffer takes it back after the send.
std::vector<uint8_t> take_bulk_buffer(std::vector<uint8_t>& pool,
                                      const uint8_t* src, size_t n) {
  std::vector<uint8_t> buf;
  buf.swap(pool);
  // assign (not resize-then-copy): resize would value-initialize n bytes
  // only for the copy to overwrite them — a wasted full pass on the hot
  // path. assign reuses the pooled capacity and writes each byte once.
  buf.assign(src, src + n);
  return buf;
}

void reclaim_bulk_buffer(std::vector<uint8_t>& pool, Message& sent) {
  if (sent.data.capacity() > pool.capacity()) {
    sent.data.clear();
    pool.swap(sent.data);
  }
}

// Cached peer connections, no re-send on failure (pool.py semantics: control
// messages are not idempotent). Conns are shared_ptr-held: eviction/shutdown
// only ::shutdown()s the fd (waking any blocked recv) and drops the map
// reference; the fd is ::close()d by ~Conn when the last in-flight request
// lets go — so no thread ever uses a closed-and-reused fd number.
//
// MULTIPLE connections per peer (mirrors pool.py): one-conn-per-peer with
// its mutex held across the round-trip lets the waits-for graph cycle
// across >= 3 daemons (REQ_ALLOC forward + DO_ALLOC/DO_FREE legs +
// NOTE_FREE accounting) and deadlocks the cluster until socket timeouts.
// The message call graph is acyclic, so leasing an idle-or-fresh
// connection per request removes every mutex edge.
class PeerPool {
 public:
  Message request(const std::string& host, int port, const Message& m) {
    std::shared_ptr<Conn> c = lease(host, port);
    std::unique_lock<std::mutex> g(c->mu, std::adopt_lock);
    try {
      send_msg(c->fd, m);
      Message r = recv_msg(c->fd, &c->scratch);
      g.unlock();
      cv_.notify_all();  // a cap-blocked lease() can have this conn now
      return r;
    } catch (...) {
      // Any interrupted exchange leaves the stream desynced: evict the
      // connection (never cache a half-read one) and wake cap waiters,
      // since the peer's list just shrank below the bound.
      discard(host, port, c);
      g.unlock();
      cv_.notify_all();
      throw;
    }
  }

  // Terminal: refuses new dials afterwards, so a worker racing shutdown
  // cannot re-dial a hung peer and block stop()'s join forever.
  void close_all() {
    {
      std::lock_guard<std::mutex> g(mu_);
      closed_ = true;
      for (auto& kv : conns_)
        for (auto& c : kv.second) ::shutdown(c->fd, SHUT_RDWR);
      conns_.clear();
    }
    cv_.notify_all();  // cap-blocked leases must see closed_ and throw
  }

 private:
  struct Conn {
    int fd = -1;  // -1 until dial succeeds: ~Conn must never close(0)
    std::mutex mu;
    // Receive scratch reused across requests on this connection (the
    // holder of mu owns it; replies are consumed before the next recv).
    std::vector<uint8_t> scratch;
    ~Conn() {
      if (fd >= 0) ::close(fd);
    }
  };

  // Returns with c->mu HELD (caller adopts). Bounded at kPerPeer
  // connections per peer (pool.py's per_peer): at the cap, wait for any
  // in-flight request to that peer to finish instead of dialing without
  // bound under a concurrency spike.
  std::shared_ptr<Conn> lease(const std::string& host, int port) {
    auto key = host + ":" + std::to_string(port);
    {
      std::unique_lock<std::mutex> g(mu_);
      while (true) {
        if (closed_) throw ProtocolError("peer pool is shut down");
        auto& vec = conns_[key];
        for (auto& c : vec)
          if (c->mu.try_lock()) return c;
        if (vec.size() < kPerPeer) break;  // room: dial outside mu_
        // The timed wait is only a missed-notify backstop; request()'s
        // notify_all is the real wakeup.
        cv_.wait_for(g, std::chrono::seconds(1));
      }
    }
    auto c = std::make_shared<Conn>();
    c->fd = dial(host, port);
    c->mu.lock();
    std::lock_guard<std::mutex> g(mu_);
    if (closed_) {
      ::shutdown(c->fd, SHUT_RDWR);
      c->mu.unlock();
      throw ProtocolError("peer pool is shut down");
    }
    conns_[key].push_back(c);
    return c;
  }

  void discard(const std::string& host, int port,
               const std::shared_ptr<Conn>& c) {
    auto key = host + ":" + std::to_string(port);
    std::lock_guard<std::mutex> g(mu_);
    auto it = conns_.find(key);
    if (it == conns_.end()) return;
    auto& vec = it->second;
    for (auto vit = vec.begin(); vit != vec.end(); ++vit) {
      if (*vit == c) {
        ::shutdown(c->fd, SHUT_RDWR);
        vec.erase(vit);
        break;
      }
    }
  }

  static constexpr size_t kPerPeer = 16;  // pool.py per_peer
  std::mutex mu_;
  std::condition_variable cv_;
  bool closed_ = false;
  std::map<std::string, std::vector<std::shared_ptr<Conn>>> conns_;
};

// ---------------------------------------------------------------------------
// Membership, registry, placement.
// ---------------------------------------------------------------------------

struct RegEntry {
  uint64_t alloc_id;
  Kind kind;
  uint32_t device_index;
  Extent extent;
  uint64_t nbytes;
  int64_t origin_rank;
  int64_t origin_pid;
  double lease_expiry;
};

// Owner-side registry (registry.py twin): ids = (rank << 32) | (counter << 1).
class Registry {
 public:
  Registry(int64_t rank, double lease_s) : rank_(rank), lease_s_(lease_s) {}

  uint64_t next_id() {
    std::lock_guard<std::mutex> g(mu_);
    ++counter_;
    return (uint64_t(rank_) << 32) | (counter_ << 1);
  }

  void insert(RegEntry e) {
    std::lock_guard<std::mutex> g(mu_);
    entries_[e.alloc_id] = std::move(e);
  }

  RegEntry lookup(uint64_t id) const {
    std::lock_guard<std::mutex> g(mu_);
    auto it = entries_.find(id);
    if (it == entries_.end())
      throw BadHandleError("unknown alloc_id " + std::to_string(id));
    return it->second;
  }

  RegEntry remove(uint64_t id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = entries_.find(id);
    if (it == entries_.end())
      throw BadHandleError("unknown alloc_id " + std::to_string(id));
    RegEntry e = it->second;
    entries_.erase(it);
    return e;
  }

  void renew(int64_t pid, int64_t rank) {
    double deadline = now_s() + lease_s_;
    std::lock_guard<std::mutex> g(mu_);
    for (auto& kv : entries_)
      if (kv.second.origin_pid == pid && kv.second.origin_rank == rank)
        kv.second.lease_expiry = deadline;
  }

  std::vector<uint64_t> expired() const {
    double t = now_s();
    std::lock_guard<std::mutex> g(mu_);
    std::vector<uint64_t> out;
    for (auto& kv : entries_)
      if (kv.second.lease_expiry < t) out.push_back(kv.first);
    return out;
  }

  // Every allocation an app originated (disconnect-time reclamation — the
  // reference's unresolved TODO, main.c:6-7,58-103).
  std::vector<uint64_t> ids_for_app(int64_t pid, int64_t rank) const {
    std::lock_guard<std::mutex> g(mu_);
    std::vector<uint64_t> out;
    for (auto& kv : entries_)
      if (kv.second.origin_pid == pid && kv.second.origin_rank == rank)
        out.push_back(kv.first);
    return out;
  }

  double new_deadline() const { return now_s() + lease_s_; }
  double lease_s() const { return lease_s_; }

  uint64_t live_count() const {
    std::lock_guard<std::mutex> g(mu_);
    return entries_.size();
  }

  uint64_t counter() const {
    std::lock_guard<std::mutex> g(mu_);
    return counter_;
  }

  void restore_counter(uint64_t v) {
    std::lock_guard<std::mutex> g(mu_);
    if (v > counter_) counter_ = v;
  }

  std::vector<RegEntry> all() const {
    std::lock_guard<std::mutex> g(mu_);
    std::vector<RegEntry> out;
    for (auto& kv : entries_) out.push_back(kv.second);
    return out;
  }

 private:
  int64_t rank_;
  double lease_s_;
  mutable std::mutex mu_;
  uint64_t counter_ = 0;
  std::map<uint64_t, RegEntry> entries_;
};

struct NodeResources {
  int64_t rank;
  uint32_t ndevices;
  uint64_t device_arena_bytes;
  uint64_t host_arena_bytes;
  std::vector<uint64_t> device_used;
  uint64_t host_used = 0;
};

struct PlacementResult {
  int64_t rank;
  uint32_t device_index;
  Kind kind;
};

struct PlacementError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// Placement (placement.py twin): "capacity" = most-free-fit avoiding the
// origin; "neighbor" = (orig+1) % n reference parity (alloc.c:107).
class Placement {
 public:
  Placement(bool capacity_aware) : capacity_aware_(capacity_aware) {}

  void add_node(NodeResources r) {
    std::lock_guard<std::mutex> g(mu_);
    r.device_used.assign(r.ndevices, 0);
    nodes_[r.rank] = std::move(r);
  }

  int64_t nnodes() const {
    std::lock_guard<std::mutex> g(mu_);
    return int64_t(nodes_.size());
  }

  void note(Kind kind, int64_t rank, uint32_t dev, uint64_t nbytes, bool alloc) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = nodes_.find(rank);
    if (it == nodes_.end()) return;
    NodeResources& n = it->second;
    if (kind_is_host(kind)) {
      n.host_used = alloc ? n.host_used + nbytes
                          : (n.host_used > nbytes ? n.host_used - nbytes : 0);
    } else if (dev < n.device_used.size()) {
      uint64_t& u = n.device_used[dev];
      u = alloc ? u + nbytes : (u > nbytes ? u - nbytes : 0);
    }
  }

  PlacementResult place(int64_t orig_rank, Kind kind, uint64_t nbytes) {
    std::lock_guard<std::mutex> g(mu_);
    if (nodes_.empty()) throw PlacementError("no nodes registered");
    bool remote = kind == Kind::REMOTE_DEVICE || kind == Kind::REMOTE_HOST;
    if (nodes_.size() == 1 && remote) {
      // Single-node demotion (alloc.c:82-83).
      Kind demoted = kind == Kind::REMOTE_DEVICE ? Kind::LOCAL_DEVICE
                                                 : Kind::LOCAL_HOST;
      return {orig_rank, 0, demoted};
    }
    if (!capacity_aware_) {
      int64_t rank = (orig_rank + 1) % int64_t(nodes_.size());
      const NodeResources& n = nodes_.at(rank);
      if (kind == Kind::REMOTE_HOST) return {rank, 0, kind};
      rr_++;
      uint32_t dev = n.ndevices ? uint32_t(rr_ % n.ndevices) : 0;
      return {rank, dev, kind};
    }
    // Capacity-aware: most free bytes that fit, off-origin preferred.
    bool found = false;
    int64_t best_score = 0;
    PlacementResult best{0, 0, kind};
    for (auto& kv : nodes_) {
      const NodeResources& n = kv.second;
      int64_t pref = (kv.first != orig_rank) ? 0 : -(int64_t(1) << 62);
      if (kind == Kind::REMOTE_HOST) {
        int64_t freeb = int64_t(n.host_arena_bytes) - int64_t(n.host_used);
        if (freeb >= int64_t(nbytes)) {
          int64_t score = freeb + pref;
          if (!found || score > best_score) {
            found = true;
            best_score = score;
            best = {kv.first, 0, kind};
          }
        }
      } else {
        for (uint32_t d = 0; d < n.ndevices; ++d) {
          int64_t freeb =
              int64_t(n.device_arena_bytes) - int64_t(n.device_used[d]);
          if (freeb >= int64_t(nbytes)) {
            int64_t score = freeb + pref;
            if (!found || score > best_score) {
              found = true;
              best_score = score;
              best = {kv.first, d, kind};
            }
          }
        }
      }
    }
    if (!found)
      throw PlacementError("no node can fit " + std::to_string(nbytes) + " B");
    return best;
  }

 private:
  bool capacity_aware_;
  mutable std::mutex mu_;
  uint64_t rr_ = 0;
  std::map<int64_t, NodeResources> nodes_;
};

// ---------------------------------------------------------------------------
// The daemon.
// ---------------------------------------------------------------------------

struct Config {
  std::string nodefile;
  std::string snapshot_path;
  // Empty = bind the daemon's own nodefile hostname (routable to peers but
  // not the wildcard; the plane is unauthenticated, so INADDR_ANY is an
  // explicit opt-in via --bind-host 0.0.0.0 / OCM_BIND_HOST). Mirrors the
  // Python CLI (daemon.py main() passes host=entries[rank].host).
  std::string bind_host;
  int64_t rank = -1;
  bool capacity_policy = true;
  uint32_t ndevices = 1;
  uint64_t host_arena_bytes = 256ull << 20;
  uint64_t device_arena_bytes = 128ull << 20;
  uint64_t alignment = 4096;
  double lease_s = 30.0;
  double heartbeat_s = 5.0;
};

class Daemon {
 public:
  Daemon(const Config& cfg, std::vector<NodeEntry> entries)
      : cfg_(cfg),
        entries_(std::move(entries)),
        host_arena_(cfg.host_arena_bytes, cfg.alignment),
        host_store_(cfg.host_arena_bytes, 0),
        registry_(cfg.rank, cfg.lease_s),
        placement_(cfg.capacity_policy),
        track_("daemon-r" + std::to_string(cfg.rank)) {
    for (uint32_t i = 0; i < cfg.ndevices; ++i)
      device_books_.emplace_back(std::make_unique<ArenaAllocator>(
          cfg.device_arena_bytes, cfg.alignment));
    // OCM_NATIVE_OBS=0 reverts the daemon to its pre-obs surface: the
    // trace capability masked out of the CONNECT echo, STATUS_PROM /
    // STATUS_EVENTS answered with typed BAD_MSG, no journal, no
    // flight-recorder spill — what the obs CLI's graceful-degradation
    // path is regression-tested against.
    const char* nob = getenv("OCM_NATIVE_OBS");
    obs_enabled_ = !(nob != nullptr && std::string(nob) == "0");
    caps_mask_ = kFlagCapCoalesce | (obs_enabled_ ? kFlagCapTrace : 0);
  }

  void run() {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr = {};
    addr.sin_family = AF_INET;
    if (cfg_.bind_host.empty())
      cfg_.bind_host = entries_[cfg_.rank].host;
    if (cfg_.bind_host == "0.0.0.0") {
      addr.sin_addr.s_addr = htonl(INADDR_ANY);
    } else if (inet_pton(AF_INET, cfg_.bind_host.c_str(), &addr.sin_addr) != 1) {
      // Not a dotted quad (e.g. a nodefile hostname): resolve it.
      addrinfo hints = {};
      hints.ai_family = AF_INET;
      hints.ai_socktype = SOCK_STREAM;
      addrinfo* res = nullptr;
      if (getaddrinfo(cfg_.bind_host.c_str(), nullptr, &hints, &res) != 0 ||
          res == nullptr)
        throw std::runtime_error("cannot resolve bind host " + cfg_.bind_host);
      addr.sin_addr = ((sockaddr_in*)res->ai_addr)->sin_addr;
      freeaddrinfo(res);
    }
    addr.sin_port = htons(uint16_t(entries_[cfg_.rank].port));
    if (::bind(listen_fd_, (sockaddr*)&addr, sizeof(addr)) != 0)
      throw std::runtime_error("bind failed on port " +
                               std::to_string(entries_[cfg_.rank].port));
    ::listen(listen_fd_, 64);
    // The LISTEN fd is nonblocking so the event loop's accept drain never
    // parks; accepted connection fds stay BLOCKING (reads go through
    // FrameReader's MSG_DONTWAIT; replies ride the plain blocking
    // send_msg, woken by shutdown(2) at stop time).
    fcntl(listen_fd_, F_SETFL,
          fcntl(listen_fd_, F_GETFL, 0) | O_NONBLOCK);
    epoll_fd_ = ::epoll_create1(0);
    wake_fd_ = ::eventfd(0, EFD_NONBLOCK);
    if (epoll_fd_ < 0 || wake_fd_ < 0)
      throw std::runtime_error("epoll/eventfd setup failed");
    epoll_event ev = {};
    ev.events = EPOLLIN;
    ev.data.fd = listen_fd_;
    epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, listen_fd_, &ev);
    ev.data.fd = wake_fd_;
    epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, wake_fd_, &ev);
    running_ = true;

    if (cfg_.rank == 0) {
      placement_.add_node(own_resources());
    } else {
      notify_rank0();
    }
    maybe_restore();
    // Joined in stop(), never detached: a detached worker can wake after
    // run() returns and the Daemon is destroyed (use-after-free caught by
    // the TSan test). Started only after the fallible setup above — a throw
    // while a joinable thread is live would hit std::terminate in ~thread.
    reaper_thread_ = std::thread([this] {
      obs::set_thread_name("reaper");
      reaper_loop();
    });
    // Bounded DATA-plane worker pool: N concurrent stripe connections are
    // served by these few threads instead of N blocking ones. Control
    // messages never queue here (they may block on nested peer requests;
    // see handle_complete), so the pool can never deadlock on itself.
    size_t nworkers = kDefaultWorkers();
    if (const char* w = getenv("OCM_NATIVE_WORKERS")) {
      long v = std::atol(w);
      if (v >= 1 && v <= 64) nworkers = size_t(v);
    }
    for (size_t i = 0; i < nworkers; ++i)
      pool_threads_.emplace_back([this, i] {
        obs::set_thread_name("worker-" + std::to_string(i));
        worker_loop();
      });
    obs::set_thread_name("evloop");
    started_ok_ = true;
    std::printf("oncillamemd rank=%lld listening on %s:%d\n",
                (long long)cfg_.rank, entries_[cfg_.rank].host.c_str(),
                entries_[cfg_.rank].port);
    std::fflush(stdout);

    // The event loop: readiness only — per-connection frame assembly
    // happens in FrameReader, dispatch on workers/control threads.
    std::vector<epoll_event> events(64);
    while (running_) {
      int n = ::epoll_wait(epoll_fd_, events.data(), int(events.size()), -1);
      if (n < 0) {
        if (errno == EINTR) continue;
        break;
      }
      for (int i = 0; i < n && running_; ++i) {
        int fd = events[i].data.fd;
        if (fd == wake_fd_) {
          uint64_t tok;
          while (::read(wake_fd_, &tok, sizeof(tok)) > 0) {
          }
          continue;
        }
        if (fd == listen_fd_) {
          accept_ready();
          continue;
        }
        handle_readable(fd);
      }
    }
    stop();  // signal handler only requested; do the real teardown here
  }

  // Async-signal-safe: called from the SIGINT/SIGTERM handler. Only an
  // atomic store + eventfd write/shutdown(2); the real teardown (mutexes,
  // file I/O) happens on the main thread once epoll_wait returns.
  void request_stop() {
    signalled_.store(true);
    running_.store(false);
    if (listen_fd_ >= 0) ::shutdown(listen_fd_, SHUT_RDWR);
    if (wake_fd_ >= 0) {
      uint64_t one = 1;
      [[maybe_unused]] ssize_t r = ::write(wake_fd_, &one, sizeof(one));
    }
  }

  void stop() {
    // Black-box flush FIRST (the Python Daemon.kill() discipline): a
    // SIGTERM'd daemon — the closest observable analogue of a chaos
    // kill for an out-of-process rank — must leave its journal ring on
    // disk before teardown can hang on sockets or joins. Streamed
    // duplicates dedup away at merge time via (jid, seq), so the spill
    // can only ADD evidence. (A SIGKILL leaves no spill, but every
    // record was already streamed + flushed at record time.)
    if (jrec()) {
      if (signalled_.load())
        journal_.record("daemon_kill", track_,
                        obs::Fields().i("rank", cfg_.rank).str());
      journal_.spill_ring("kill-r" + std::to_string(cfg_.rank));
      journal_.flush();
    }
    running_ = false;
    if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      listen_fd_ = -1;
    }
    // Kick every serving thread off its socket before snapshotting: a
    // pool worker blocked in a reply send (stalled client) wakes with an
    // error once its fd is shut down.
    {
      std::lock_guard<std::mutex> g(conns_mu_);
      for (auto& kv : conns_) ::shutdown(kv.first, SHUT_RDWR);
    }
    // Unblock any worker waiting on a peer reply BEFORE joining — a hung
    // peer must not turn SIGTERM into an infinite hang (close_all also
    // refuses new dials from here on).
    peers_.close_all();
    // Drain the DATA-plane pool: stop flag + wakeup, then join.
    {
      std::lock_guard<std::mutex> g(queue_mu_);
      queue_stop_ = true;
    }
    queue_cv_.notify_all();
    for (std::thread& t : pool_threads_)
      if (t.joinable()) t.join();
    pool_threads_.clear();
    // Control threads exit promptly once their sockets/peers are shut
    // down; join them (and the reaper) so no thread can touch a
    // destroyed Daemon. Only the event loop spawns control threads and
    // it has exited by now. Joins run outside reap_mu_: an exiting
    // control thread takes that lock for its final finished_ push.
    std::vector<std::thread> leftover;
    {
      std::lock_guard<std::mutex> g(reap_mu_);
      leftover.swap(serve_threads_);
      finished_.clear();
    }
    for (std::thread& t : leftover)
      if (t.joinable()) t.join();
    if (reaper_thread_.joinable()) reaper_thread_.join();
    {
      std::lock_guard<std::mutex> g(conns_mu_);
      for (auto& kv : conns_) ::close(kv.first);
      conns_.clear();
    }
    if (epoll_fd_ >= 0) {
      ::close(epoll_fd_);
      epoll_fd_ = -1;
    }
    if (wake_fd_ >= 0) {
      ::close(wake_fd_);
      wake_fd_ = -1;
    }
    if (started_ok_) save_snapshot();
  }

 private:
  NodeResources own_resources() const {
    return {cfg_.rank, cfg_.ndevices, cfg_.device_arena_bytes,
            cfg_.host_arena_bytes, {}, 0};
  }

  void notify_rank0() {
    Message m{MsgType::ADD_NODE,
              {{"rank", Value::I(cfg_.rank)},
               {"host", Value::S(entries_[cfg_.rank].host)},
               {"port", Value::U(uint64_t(entries_[cfg_.rank].port))},
               {"ndevices", Value::U(cfg_.ndevices)},
               {"device_arena_bytes", Value::U(cfg_.device_arena_bytes)},
               {"host_arena_bytes", Value::U(cfg_.host_arena_bytes)}},
              {}};
    for (int attempt = 0; attempt < 40; ++attempt) {
      try {
        peers_.request(entries_[0].caddr(), entries_[0].port, m);
        return;
      } catch (const ProtocolError&) {
        std::this_thread::sleep_for(std::chrono::milliseconds(250));
      }
    }
    throw std::runtime_error("rank 0 daemon unreachable");
  }

  void reaper_loop() {
    // Lease reclamation (the reference's unresolved TODO, main.c:6-7).
    // Sleep in short slices so stop()'s join returns promptly.
    double slept = 0.0;
    while (running_) {
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
      reap_finished();
      slept += 0.05;
      if (slept < cfg_.heartbeat_s) continue;
      slept = 0.0;
      for (uint64_t id : registry_.expired()) {
        try {
          RegEntry e = registry_.lookup(id);
          do_free_local(id);
          lease_reclaims_.fetch_add(1, std::memory_order_relaxed);
          if (jrec())
            journal_.record("lease_reclaim", track_,
                            obs::Fields()
                                .u("alloc_id", e.alloc_id)
                                .u("nbytes", e.nbytes)
                                .i("origin_pid", e.origin_pid)
                                .i("origin_rank", e.origin_rank)
                                .str());
        } catch (const BadHandleError&) {
        }
      }
      bool pending;
      {
        std::lock_guard<std::mutex> g(plane_mu_);
        pending = !plane_unsynced_.empty();
      }
      if (pending) sync_plane_endpoint();
    }
  }

  // Per-connection serving state for the epoll core. Ownership is
  // exclusive at any instant: the event loop owns the connection while
  // assembling a frame (EPOLLONESHOT disarms it on delivery), then hands
  // it — message attached — to exactly one worker/control thread, which
  // re-arms it only after the reply is on the wire. `mu` makes each
  // handoff an explicit synchronization point; it is never contended.
  struct ServeConn {
    explicit ServeConn(int f) : fd(f) {}
    const int fd;
    FrameReader reader;  // event-loop-thread only
    std::mutex mu;       // held by the thread processing a message
    std::vector<uint8_t> bulk_buf;  // pooled DATA_GET_OK reply capacity
    // Coalesced-burst state (FLAG_MORE): per connection, so concurrent
    // stripes on sibling sockets never interact (daemon.py twin).
    uint64_t burst_nbytes = 0;
    bool burst_open = false;
    bool burst_err_set = false;
    Message burst_err;
  };

  static size_t kDefaultWorkers() {
    unsigned hw = std::thread::hardware_concurrency();
    return std::max(2u, std::min(8u, hw ? hw : 2u));
  }

  std::shared_ptr<ServeConn> conn_for(int fd) {
    std::lock_guard<std::mutex> g(conns_mu_);
    auto it = conns_.find(fd);
    return it == conns_.end() ? nullptr : it->second;
  }

  void accept_ready() {
    int one = 1;
    while (running_) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) break;  // EAGAIN (drained) or shutdown
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      int buf = 4 << 20;  // stream 8 MiB chunks without window stalls
      setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
      setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
      {
        std::lock_guard<std::mutex> g(conns_mu_);
        conns_.emplace(fd, std::make_shared<ServeConn>(fd));
      }
      epoll_event ev = {};
      ev.events = EPOLLIN | EPOLLONESHOT;
      ev.data.fd = fd;
      epoll_ctl(epoll_fd_, EPOLL_CTL_ADD, fd, &ev);
    }
  }

  // Re-arm a connection for its next frame (EPOLLONESHOT handoff back to
  // the event loop). Called by whichever thread finished the message.
  void rearm(int fd) {
    epoll_event ev = {};
    ev.events = EPOLLIN | EPOLLONESHOT;
    ev.data.fd = fd;
    epoll_ctl(epoll_fd_, EPOLL_CTL_MOD, fd, &ev);
  }

  void close_conn(const std::shared_ptr<ServeConn>& c) {
    {
      std::lock_guard<std::mutex> g(conns_mu_);
      conns_.erase(c->fd);
    }
    epoll_ctl(epoll_fd_, EPOLL_CTL_DEL, c->fd, nullptr);
    ::close(c->fd);
  }

  // Event-loop read path: advance the connection's frame state machine.
  // DATA_PUT payloads that fully validate land STRAIGHT in the
  // destination arena extent via the router — the recv is the write.
  void handle_readable(int fd) {
    std::shared_ptr<ServeConn> c = conn_for(fd);
    if (c == nullptr) return;  // raced a close
    // Take the connection's ownership mutex for the read phase: the
    // previous message's worker released it only after its rearm, so
    // this acquire is the explicit happens-before edge for everything
    // that thread did on the connection (burst state, the fd itself) —
    // the epoll_ctl -> epoll_wait edge alone is invisible to older
    // TSan runtimes. Never contended: EPOLLONESHOT guarantees the fd
    // has no event in flight while a worker owns it.
    std::lock_guard<std::mutex> own(c->mu);
    FrameReader::Status st;
    try {
      st = c->reader.advance(fd, [this](Message& m, size_t n) {
        return route_put_payload(m, n);
      });
    } catch (const ProtocolError& e) {
      // Malformed wire input, truncation, a reset from a crashed peer —
      // worth a diagnostic saying which (daemon.py twin).
      if (getenv("OCM_VERBOSE"))
        std::fprintf(stderr, "oncillamemd: dropping conn: %s\n", e.what());
      close_conn(c);
      return;
    }
    if (st == FrameReader::Status::kNeedMore) {
      rearm(fd);
      return;
    }
    if (st == FrameReader::Status::kClosed) {
      close_conn(c);  // clean close at a frame boundary: normal
      return;
    }
    Message msg;
    try {
      msg = c->reader.take();
    } catch (const UnknownMsgError& e) {
      // A type this build predates (elastic membership & co): the frame
      // was fully consumed, the stream is in sync — decline the family
      // with a typed BAD_MSG and keep serving, exactly how an
      // un-upgraded v2 Python peer answers. The reply rides the pool
      // (no dispatch, nothing to block on).
      enqueue_work(c, Message{}, e.what());
      return;
    } catch (const ProtocolError& e) {
      if (getenv("OCM_VERBOSE"))
        std::fprintf(stderr, "oncillamemd: dropping conn: %s\n", e.what());
      close_conn(c);
      return;
    }
    handle_complete(c, std::move(msg));
  }

  // Route a completed message: DATA-plane ops ride the bounded worker
  // pool (their dispatch never issues a daemon-to-daemon request that
  // could wait on another pool, so the pool cannot deadlock on itself);
  // everything else — the control plane, PLANE_* relays — keeps its
  // blocking semantics on a per-message thread, the finer-grained twin
  // of the old thread-per-connection serve loop (nested peer legs like
  // REQ_FREE -> DO_FREE -> NOTE_FREE must never compete with stripe
  // traffic for pool slots).
  void handle_complete(const std::shared_ptr<ServeConn>& c, Message msg) {
    if (msg.type == MsgType::DATA_PUT || msg.type == MsgType::DATA_GET) {
      enqueue_work(c, std::move(msg), nullptr);
      return;
    }
    std::lock_guard<std::mutex> g(reap_mu_);
    serve_threads_.emplace_back(
        [this, c, m = std::move(msg)]() mutable {
          process_message(c, std::move(m), nullptr);
          std::lock_guard<std::mutex> g2(reap_mu_);
          finished_.push_back(std::this_thread::get_id());
        });
  }

  struct Work {
    std::shared_ptr<ServeConn> conn;
    Message msg;
    bool is_unknown = false;   // answer BAD_MSG(unknown_detail), no dispatch
    std::string unknown_detail;
  };

  void enqueue_work(const std::shared_ptr<ServeConn>& c, Message msg,
                    const char* unknown_detail) {
    Work w;
    w.conn = c;
    w.msg = std::move(msg);
    if (unknown_detail != nullptr) {
      w.is_unknown = true;
      w.unknown_detail = unknown_detail;
    }
    {
      std::lock_guard<std::mutex> g(queue_mu_);
      queue_.push_back(std::move(w));
    }
    queue_cv_.notify_one();
  }

  void worker_loop() {
    while (true) {
      Work w;
      {
        std::unique_lock<std::mutex> g(queue_mu_);
        queue_cv_.wait(g, [this] { return queue_stop_ || !queue_.empty(); });
        if (queue_stop_ && queue_.empty()) return;
        w = std::move(queue_.front());
        queue_.pop_front();
      }
      process_message(w.conn, std::move(w.msg),
                      w.is_unknown ? w.unknown_detail.c_str() : nullptr);
    }
  }

  // Dispatch + reply for one message, on whichever thread owns the
  // connection right now. Implements the ACK-coalescing contract
  // (daemon.py _serve_conn twin): a DATA_PUT carrying FLAG_MORE is a
  // non-final chunk of a burst — applied but NOT answered; the first
  // chunk without the bit closes the burst and gets ONE reply covering
  // all of it (total bytes on success, the burst's first ERROR
  // otherwise). Replies stay FIFO per connection; there are simply
  // fewer of them.
  void process_message(const std::shared_ptr<ServeConn>& c, Message msg,
                       const char* unknown_detail) {
    std::lock_guard<std::mutex> own(c->mu);
    Message reply;
    bool is_put = false;
    if (unknown_detail != nullptr) {
      reply = err(ErrCode::BAD_MSG, unknown_detail);
    } else {
      is_put = msg.type == MsgType::DATA_PUT;
      if (c->burst_open && !is_put) {
        // A sender may not interleave other requests inside an
        // unfinished burst — the reply stream would desync.
        c->burst_open = false;
        c->burst_err_set = false;
        c->burst_nbytes = 0;
        reply = err(ErrCode::BAD_MSG,
                    "request inside an open DATA_PUT burst");
      } else {
        // Serve-side spans (daemon.py _serve_conn twin): data ops are
        // always measured; control ops get a span only when the request
        // carried a trace context, so the exported trace shows the
        // daemon hop, not just the client's view of the round-trip.
        bool data_op = is_put || msg.type == MsgType::DATA_GET;
        bool spanned = obs_enabled_ && (data_op || msg.trace_id != 0);
        uint64_t span_nbytes =
            data_op && msg.fields.count("nbytes") ? msg.u("nbytes") : 0;
        double wall0 = spanned ? obs::wall_s() : 0.0;
        double t0 = spanned ? obs::mono_s() : 0.0;
        try {
          reply = dispatch(*c, msg);
        } catch (const OomError& e) {
          reply = err(ErrCode::OOM, e.what());
        } catch (const BoundsError& e) {
          reply = err(ErrCode::BOUNDS, e.what());
        } catch (const BadHandleError& e) {
          reply = err(ErrCode::BAD_ALLOC_ID, e.what());
        } catch (const PlacementError& e) {
          reply = err(ErrCode::PLACEMENT, e.what());
        } catch (const std::exception& e) {
          reply = err(ErrCode::UNKNOWN, e.what());
        }
        if (spanned)
          record_span(srv_op_name(msg.type), wall0, obs::mono_s() - t0,
                      span_nbytes, msg);
      }
    }
    bool more = is_put && (msg.flags & kFlagMore) != 0;
    if (is_put && (more || c->burst_open)) {
      if (!c->burst_open) c->burst_open = true;
      if (reply.type == MsgType::ERR) {
        if (!c->burst_err_set) {
          c->burst_err = reply;
          c->burst_err_set = true;
        }
      } else {
        c->burst_nbytes += reply.u("nbytes");
      }
      if (more) {
        rearm(c->fd);  // reply deferred to the burst's last chunk
        return;
      }
      reply = c->burst_err_set
                  ? c->burst_err
                  : Message{MsgType::DATA_PUT_OK,
                            {{"nbytes", Value::U(c->burst_nbytes)}},
                            {}};
      c->burst_open = false;
      c->burst_err_set = false;
      c->burst_nbytes = 0;
    }
    try {
      send_msg(c->fd, reply);
    } catch (const ProtocolError&) {
      close_conn(c);
      return;
    }
    // Hand a sent bulk reply's buffer back to this CONNECTION's pool so
    // its next DATA_GET reuses the capacity: a FRESH vector per 16 MiB
    // reply goes through mmap + first-touch page faults + copy, which
    // measured as ~40% of the GET leg's loopback bandwidth. (A pointer
    // view into the arena would avoid the copy too, but it would extend
    // the freed-extent race across a potentially stalled send — the
    // snapshot copy keeps that window bounded to dispatch.)
    reclaim_bulk_buffer(c->bulk_buf, reply);
    rearm(c->fd);
  }

  // Zero-copy DATA_PUT landing (daemon.py _route_put_payload twin): only
  // a chunk that fully validates routes; anything questionable returns
  // nullptr and takes the copy path, where the handler raises the typed
  // error. TOCTOU note: a concurrent free could recycle the extent
  // between this lookup and the recv completing — the same class of
  // window the copy path already has, reachable only by an app freeing
  // an allocation while actively writing it; the handler revalidates
  // after the recv and answers BAD_ALLOC_ID so such a writer cannot
  // treat the landing as durable.
  uint8_t* route_put_payload(Message& m, size_t n_data) {
    if (m.type != MsgType::DATA_PUT) return nullptr;
    try {
      uint64_t off = m.u("offset");
      uint64_t n = m.u("nbytes");
      if (n != n_data) return nullptr;
      RegEntry e = registry_.lookup(m.u("alloc_id"));
      if (!kind_is_host(e.kind)) return nullptr;  // device relay needs
                                                  // the payload in-frame
      if (off + n > e.nbytes || off + n < off) return nullptr;
      return host_store_.data() + e.extent.offset + off;
    } catch (const std::exception&) {
      return nullptr;
    }
  }

  // Join control threads that have finished (their stacks are not
  // reclaimed until joined). Runs from the reaper loop so idle daemons
  // reclaim too, not just ones with a steady stream of new messages.
  // Joins happen outside reap_mu_ — the exiting thread's own final push
  // needs that lock.
  void reap_finished() {
    std::vector<std::thread> done;
    {
      std::lock_guard<std::mutex> g(reap_mu_);
      for (std::thread::id id : finished_)
        for (auto it = serve_threads_.begin(); it != serve_threads_.end(); ++it)
          if (it->get_id() == id) {
            done.push_back(std::move(*it));
            serve_threads_.erase(it);
            break;
          }
      finished_.clear();
    }
    for (std::thread& t : done) t.join();
  }

  static Message err(ErrCode c, const std::string& detail) {
    return {MsgType::ERR,
            {{"code", Value::U(uint64_t(c))}, {"detail", Value::S(detail)}},
            {}};
  }

  // Journaling is on only when the obs surface is enabled AND the
  // process opted in (OCM_EVENTS / OCM_FLIGHTREC) — the same gate
  // journal.py applies, so the disarmed daemon does zero extra work.
  bool jrec() const { return obs_enabled_ && journal_.enabled(); }

  void record_span(const char* op, double wall0, double dt_s,
                   uint64_t nbytes, const Message& m) {
    opstats_.note(op, dt_s, nbytes);
    if (!jrec()) return;
    obs::Fields f;
    f.s("op", op).u("nbytes", nbytes).d("t_wall", wall0)
        .d("dur_us", dt_s * 1e6)
        .u("trace_id", m.trace_id)
        .u("span_id", m.trace_id ? obs::rand_id() : 0)
        .u("parent_span_id", m.trace_span_id);
    journal_.record("span", track_, f.str());
  }

  Message dispatch(ServeConn& c, const Message& m) {
    switch (m.type) {
      case MsgType::DISCONNECT:
        on_disconnect(m);
        [[fallthrough]];
      case MsgType::CONNECT: {
        Message confirm{MsgType::CONNECT_CONFIRM,
                        {{"rank", Value::I(cfg_.rank)},
                         {"nnodes", Value::I(cfg_.rank == 0
                                                 ? placement_.nnodes()
                                                 : int64_t(entries_.size()))}},
                        {}};
        // Capability negotiation (protocol.py FLAG_CAP_* contract): echo
        // exactly the offered bits this daemon implements — ACK
        // coalescing and (unless OCM_NATIVE_OBS=0) trace propagation.
        // Every other offer (replica, qos, fabric, and any QoS profile
        // data tail riding the frame) is declined by silence: masked
        // out of the echo, tail ignored, so un-upgraded clients and
        // capability-rich ones both get exactly the protocol they can
        // speak (pinned by the declined-by-silence tests).
        if (m.type == MsgType::CONNECT)
          confirm.flags = m.flags & caps_mask_;
        return confirm;
      }
      case MsgType::RECLAIM_APP:
        return {MsgType::RECLAIM_APP_OK,
                {{"count",
                  Value::U(reclaim_app_local(m.i("pid"), m.i("rank")))}},
                {}};
      case MsgType::ADD_NODE: return on_add_node(m);
      case MsgType::REQ_ALLOC: return on_req_alloc(m);
      case MsgType::DO_ALLOC: return on_do_alloc(m);
      case MsgType::REQ_FREE: return on_req_free(m);
      case MsgType::DO_FREE:
        do_free_local(m.u("alloc_id"));
        return {MsgType::FREE_OK, {{"alloc_id", Value::U(m.u("alloc_id"))}}, {}};
      case MsgType::NOTE_FREE: return on_note_free(m);
      case MsgType::NOTE_ALLOC: return on_note_alloc(m);
      case MsgType::DATA_PUT: return on_data_put(m);
      case MsgType::DATA_GET: return on_data_get(c, m);
      case MsgType::PLANE_SERVE: return on_plane_serve(m);
      case MsgType::PLANE_PUT: return forward_to_plane(m);
      case MsgType::PLANE_GET: return forward_to_plane(m);
      case MsgType::PLANE_SCRUB: return forward_to_plane(m);
      case MsgType::HEARTBEAT: return on_heartbeat(m);
      case MsgType::STATUS: return on_status();
      case MsgType::STATUS_PROM:
        if (!obs_enabled_) break;  // OCM_NATIVE_OBS=0: pre-obs surface
        return on_status_prom();
      case MsgType::STATUS_EVENTS:
        if (!obs_enabled_) break;
        return on_status_events();
      default:
        break;
    }
    return err(ErrCode::BAD_MSG, "unhandled message type");
  }

  Message on_add_node(const Message& m) {
    if (cfg_.rank != 0) return err(ErrCode::NOT_MASTER, "ADD_NODE to non-master");
    NodeResources r{m.i("rank"), uint32_t(m.u("ndevices")),
                    m.u("device_arena_bytes"), m.u("host_arena_bytes"), {}, 0};
    placement_.add_node(std::move(r));
    int64_t rank = m.i("rank");
    if (rank >= 0 && size_t(rank) < entries_.size()) {
      {
        std::lock_guard<std::mutex> g(entries_mu_);
        entries_[rank] = {rank, m.s("host"), int(m.u("port")),
                          entries_[rank].addr};
      }
      // A (re)joining daemon holds no plane endpoint: queue it for the
      // reaper's gossip — AFTER the entries update so the gossip dials
      // the replacement's address, never the dead predecessor's, and
      // only for in-range ranks (an out-of-range one would throw in the
      // reaper every tick and never be erased). daemon.py twin.
      std::lock_guard<std::mutex> g(plane_mu_);
      if (!plane_host_.empty()) plane_unsynced_.insert(rank);
    }
    return {MsgType::ADD_NODE_OK, {{"nnodes", Value::I(placement_.nnodes())}}, {}};
  }

  Message on_req_alloc(const Message& m) {
    if (cfg_.rank != 0) {
      // Proxy the whole request to the master (the placement leg,
      // mem.c:128).
      NodeEntry r0 = entry(0);
      return peers_.request(r0.caddr(), r0.port, m);
    }
    Kind kind = Kind(uint8_t(m.u("kind")));
    uint64_t nbytes = m.u("nbytes");
    PlacementResult placed = placement_.place(m.i("orig_rank"), kind, nbytes);
    NodeEntry owner = entry(placed.rank);
    uint64_t alloc_id, offset;
    if (placed.rank == cfg_.rank) {
      do_alloc_local(placed.kind, placed.device_index, nbytes,
                     m.i("orig_rank"), m.i("pid"), &alloc_id, &offset);
    } else {
      Message r = peers_.request(
          owner.caddr(), owner.port,
          {MsgType::DO_ALLOC,
           {{"orig_rank", Value::I(m.i("orig_rank"))},
            {"pid", Value::I(m.i("pid"))},
            {"kind", Value::U(uint64_t(placed.kind))},
            {"device_index", Value::U(placed.device_index)},
            {"nbytes", Value::U(nbytes)}},
           {}});
      if (r.type == MsgType::ERR) return r;
      alloc_id = r.u("alloc_id");
      offset = r.u("offset");
    }
    placement_.note(placed.kind, placed.rank, placed.device_index, nbytes,
                    /*alloc=*/true);
    return {MsgType::ALLOC_RESULT,
            {{"alloc_id", Value::U(alloc_id)},
             {"rank", Value::I(placed.rank)},
             {"device_index", Value::U(placed.device_index)},
             {"kind", Value::U(uint64_t(placed.kind))},
             {"offset", Value::U(offset)},
             {"nbytes", Value::U(nbytes)},
             {"owner_host", Value::S(owner.caddr())},
             {"owner_port", Value::U(uint64_t(owner.port))}},
            {}};
  }

  Message on_do_alloc(const Message& m) {
    uint64_t alloc_id, offset;
    do_alloc_local(Kind(uint8_t(m.u("kind"))), uint32_t(m.u("device_index")),
                   m.u("nbytes"), m.i("orig_rank"), m.i("pid"), &alloc_id,
                   &offset);
    return {MsgType::DO_ALLOC_OK,
            {{"alloc_id", Value::U(alloc_id)}, {"offset", Value::U(offset)}},
            {}};
  }

  // alloc_ate analogue (alloc.c:151-222): reserve BEFORE replying (fixes the
  // reference's reply-before-listen race, mem.c:350-354).
  void do_alloc_local(Kind kind, uint32_t device_index, uint64_t nbytes,
                      int64_t orig_rank, int64_t pid, uint64_t* alloc_id,
                      uint64_t* offset) {
    Extent ext;
    if (kind_is_host(kind)) {
      ext = host_arena_.alloc(nbytes);
      device_index = 0;
    } else {
      if (device_index >= device_books_.size())
        throw BadHandleError("bad device_index");
      ext = device_books_[device_index]->alloc(nbytes);
    }
    *alloc_id = registry_.next_id();
    *offset = ext.offset;
    registry_.insert({*alloc_id, kind, device_index, ext, nbytes, orig_rank,
                      pid, registry_.new_deadline()});
  }

  Message on_req_free(const Message& m) {
    int64_t owner_rank = m.i("rank");
    if (owner_rank < 0 || size_t(owner_rank) >= entries_.size())
      throw BadHandleError("bad owner rank " + std::to_string(owner_rank));
    if (owner_rank == cfg_.rank) {
      do_free_local(m.u("alloc_id"));
    } else {
      NodeEntry owner = entry(owner_rank);
      Message r = peers_.request(
          owner.caddr(), owner.port,
          {MsgType::DO_FREE, {{"alloc_id", Value::U(m.u("alloc_id"))}}, {}});
      if (r.type == MsgType::ERR) return r;
    }
    return {MsgType::FREE_OK, {{"alloc_id", Value::U(m.u("alloc_id"))}}, {}};
  }

  // dealloc_ate analogue (alloc.c:231-282), plus the rank-0 accounting the
  // reference stubbed (mem.c:221-229).
  void do_free_local(uint64_t alloc_id) {
    RegEntry e = registry_.remove(alloc_id);
    if (kind_is_host(e.kind)) {
      // Scrub on free (reference parity: server buffers are calloc'd,
      // alloc.c:171): the next tenant of this extent reads zeros.
      std::memset(host_store_.data() + e.extent.offset, 0, e.extent.nbytes);
      host_arena_.release(e.extent.offset);
    } else {
      // Device twin of the host scrub: ask the plane controller to zero
      // the extent BEFORE the offset returns to the book (O(1) wire).
      // Skipped unless this daemon knows a plane endpoint or has relayed
      // a device write — a bookkeeping-only workload must not pay a
      // master round trip per free (daemon.py twin).
      bool known;
      {
        std::lock_guard<std::mutex> g(plane_mu_);
        known = !plane_host_.empty();
      }
      if (known || device_writes_relayed_) {
        try {
          forward_to_plane(Message{
              MsgType::PLANE_SCRUB,
              {{"alloc_id", Value::U(e.alloc_id)},
               {"rank", Value::I(cfg_.rank)},
               {"device_index", Value::U(e.device_index)},
               {"ext_offset", Value::U(e.extent.offset)},
               {"ext_nbytes", Value::U(e.nbytes)}},
              {}});
        } catch (const std::exception&) {
        }
      }
      device_books_[e.device_index]->release(e.extent.offset);
    }
    if (jrec())
      journal_.record("free_local", track_,
                      obs::Fields()
                          .u("alloc_id", e.alloc_id)
                          .u("nbytes", e.nbytes)
                          .i("origin_pid", e.origin_pid)
                          .i("origin_rank", e.origin_rank)
                          .b("migrating", false)
                          .str());
    Message note{MsgType::NOTE_FREE,
                 {{"kind", Value::U(uint64_t(e.kind))},
                  {"rank", Value::I(cfg_.rank)},
                  {"device_index", Value::U(e.device_index)},
                  {"nbytes", Value::U(e.nbytes)}},
                 {}};
    if (cfg_.rank == 0) {
      on_note_free(note);
    } else {
      try {
        NodeEntry r0 = entry(0);
        peers_.request(r0.caddr(), r0.port, note);
      } catch (const ProtocolError&) {
      }
    }
  }

  Message on_note_free(const Message& m) {
    if (cfg_.rank == 0)
      placement_.note(Kind(uint8_t(m.u("kind"))), m.i("rank"),
                      uint32_t(m.u("device_index")), m.u("nbytes"),
                      /*alloc=*/false);
    return {MsgType::FREE_OK, {{"alloc_id", Value::U(0)}}, {}};
  }

  Message on_note_alloc(const Message& m) {
    if (cfg_.rank == 0)
      placement_.note(Kind(uint8_t(m.u("kind"))), m.i("rank"),
                      uint32_t(m.u("device_index")), m.u("nbytes"),
                      /*alloc=*/true);
    return {MsgType::FREE_OK, {{"alloc_id", Value::U(0)}}, {}};
  }

  // -- checkpoint / resume (snapshot.py's binary format, interchangeable
  // with the Python daemon's snapshots) ----------------------------------

  void save_snapshot() {
    if (cfg_.snapshot_path.empty()) return;
    std::string tmp = cfg_.snapshot_path + ".tmp";
    int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) {
      std::fprintf(stderr, "oncillamemd: snapshot open failed: %s\n",
                   std::strerror(errno));
      return;
    }
    uint32_t crc = 0;  // v2 trailer accumulates over every written byte
    auto write_all = [&](const uint8_t* p, size_t n) {
      crc = crc32_update(crc, p, n);
      size_t done = 0;
      while (done < n) {
        ssize_t w = ::write(fd, p + done, n - done);
        if (w <= 0) return false;
        done += size_t(w);
      }
      return true;
    };
    // Live arena bytes are written straight from host_store_, entry by
    // entry, so peak memory overhead is one metadata record — not a full
    // copy of every live byte (which could double resident memory on a
    // mostly-full arena at shutdown).
    std::vector<uint8_t> rec;
    auto put_le = [&](uint64_t v, int n) {
      for (int i = 0; i < n; ++i) rec.push_back((v >> (8 * i)) & 0xff);
    };
    bool ok = true;
    rec.insert(rec.end(), {'O', 'C', 'M', 'S'});
    rec.push_back(2);  // snapshot version (v2: CRC32 trailer)
    put_le(uint64_t(cfg_.rank), 8);
    put_le(registry_.counter(), 8);
    auto entries = registry_.all();
    put_le(entries.size(), 4);
    ok = write_all(rec.data(), rec.size());
    for (const RegEntry& e : entries) {
      if (!ok) break;
      rec.clear();
      put_le(e.alloc_id, 8);
      rec.push_back(uint8_t(e.kind));
      put_le(e.device_index, 4);
      put_le(e.extent.offset, 8);
      put_le(e.nbytes, 8);
      put_le(uint64_t(e.origin_rank), 8);
      put_le(uint64_t(e.origin_pid), 8);
      put_le(kind_is_host(e.kind) ? e.nbytes : 0, 8);
      ok = write_all(rec.data(), rec.size());
      if (ok && kind_is_host(e.kind))
        ok = write_all(host_store_.data() + e.extent.offset, e.nbytes);
    }
    if (ok) {
      // Trailer bytes are NOT fed back into the accumulator.
      uint8_t tail[4] = {uint8_t(crc & 0xff), uint8_t((crc >> 8) & 0xff),
                         uint8_t((crc >> 16) & 0xff),
                         uint8_t((crc >> 24) & 0xff)};
      uint32_t keep = crc;
      ok = write_all(tail, 4);
      crc = keep;
    }
    if (!ok) {
      std::fprintf(stderr, "oncillamemd: snapshot write failed: %s\n",
                   std::strerror(errno));
      ::close(fd);
      ::unlink(tmp.c_str());  // never rename a bad snapshot into place
      return;
    }
    if (::fsync(fd) != 0 || ::close(fd) != 0 ||
        ::rename(tmp.c_str(), cfg_.snapshot_path.c_str()) != 0) {
      std::fprintf(stderr, "oncillamemd: snapshot finalize failed: %s\n",
                   std::strerror(errno));
      ::unlink(tmp.c_str());
    }
  }

  void maybe_restore() {
    if (cfg_.snapshot_path.empty()) return;
    std::ifstream f(cfg_.snapshot_path, std::ios::binary);
    if (!f) return;
    std::vector<uint8_t> raw((std::istreambuf_iterator<char>(f)),
                             std::istreambuf_iterator<char>());
    size_t off = 0;
    auto get_le = [&](int n) -> uint64_t {
      if (off + n > raw.size()) throw ProtocolError("truncated snapshot");
      uint64_t v = 0;
      for (int i = 0; i < n; ++i) v |= uint64_t(raw[off + i]) << (8 * i);
      off += n;
      return v;
    };
    if (raw.size() < 5 || std::memcmp(raw.data(), "OCMS", 4) != 0)
      throw ProtocolError("bad snapshot magic");
    off = 4;
    uint64_t version = get_le(1);
    if (version != 1 && version != 2)
      throw ProtocolError("unsupported snapshot version");
    if (version >= 2) {
      // Integrity gate BEFORE any entry parsing: refuse a corrupt file
      // whole rather than half-loading it into a live registry.
      if (raw.size() < 5 + 4)
        throw ProtocolError("truncated snapshot (missing CRC)");
      size_t body = raw.size() - 4;
      uint32_t want = uint32_t(raw[body]) | uint32_t(raw[body + 1]) << 8 |
                      uint32_t(raw[body + 2]) << 16 |
                      uint32_t(raw[body + 3]) << 24;
      uint32_t got = crc32_update(0, raw.data(), body);
      if (got != want)
        throw ProtocolError(
            "snapshot CRC mismatch: truncated or corrupt — refusing to "
            "restore");
      raw.resize(body);
    }
    int64_t srank = int64_t(get_le(8));
    if (srank != cfg_.rank)
      throw std::runtime_error("snapshot rank mismatch");
    registry_.restore_counter(get_le(8));
    uint64_t n = get_le(4);
    for (uint64_t i = 0; i < n; ++i) {
      RegEntry e;
      e.alloc_id = get_le(8);
      e.kind = Kind(uint8_t(get_le(1)));
      e.device_index = uint32_t(get_le(4));
      uint64_t offset = get_le(8);
      e.nbytes = get_le(8);
      e.origin_rank = int64_t(get_le(8));
      e.origin_pid = int64_t(get_le(8));
      uint64_t dlen = get_le(8);
      if (kind_is_host(e.kind)) {
        e.extent = host_arena_.reserve(offset, e.nbytes);
        if (dlen) {
          if (off + dlen > raw.size())
            throw ProtocolError("truncated snapshot data");
          if (dlen > e.nbytes || offset + dlen > host_store_.size())
            throw ProtocolError("snapshot data exceeds its extent");
          std::memcpy(host_store_.data() + offset, raw.data() + off, dlen);
        }
      } else {
        if (e.device_index >= device_books_.size())
          throw ProtocolError("snapshot device_index out of range for this "
                              "daemon's --ndevices");
        e.extent = device_books_[e.device_index]->reserve(offset, e.nbytes);
      }
      off += dlen;
      e.lease_expiry = registry_.new_deadline();
      registry_.insert(e);
      // Resync the master's accounting.
      Message note{MsgType::NOTE_ALLOC,
                   {{"kind", Value::U(uint64_t(e.kind))},
                    {"rank", Value::I(cfg_.rank)},
                    {"device_index", Value::U(e.device_index)},
                    {"nbytes", Value::U(e.nbytes)}},
                   {}};
      if (cfg_.rank == 0) {
        on_note_alloc(note);
      } else {
        try {
          NodeEntry r0 = entry(0);
          peers_.request(r0.caddr(), r0.port, note);
        } catch (const ProtocolError&) {
        }
      }
    }
    std::printf("oncillamemd rank=%lld restored %llu allocations\n",
                (long long)cfg_.rank, (unsigned long long)n);
  }

  // DCN data plane: one-sided put/get into the daemon-owned host arena (the
  // registered-buffer analogue, alloc.c:171-176). Device-kind extents hold
  // their bytes in the SPMD controller's plane arena, so those ops are
  // relayed to the registered plane endpoint (runtime/daemon.py twin).
  Message on_data_put(const Message& m) {
    RegEntry e = registry_.lookup(m.u("alloc_id"));
    uint64_t off = m.u("offset"), n = m.u("nbytes");
    if (!m.data_landed && m.data.size() != n)
      throw ProtocolError("DATA_PUT length mismatch");
    if (off + n > e.nbytes)
      throw BoundsError("access [" + std::to_string(off) + ", " +
                        std::to_string(off + n) + ") outside extent of " +
                        std::to_string(e.nbytes) + " B");
    if (!kind_is_host(e.kind)) return relay_device_op(m, e);
    // data_landed: the payload was recv'd STRAIGHT into the arena extent
    // by route_put_payload (which enforced the same bounds); this
    // post-recv revalidation is what makes the landing durable — a free
    // racing the recv fails the lookup above and answers BAD_ALLOC_ID.
    if (!m.data_landed)
      std::memcpy(host_store_.data() + e.extent.offset + off, m.data.data(),
                  n);
    // Client-facing ack evidence (daemon.py twin): the native daemon
    // serves single-copy chains only, so chain is always 1 and the
    // auditor's replica-ack invariant is trivially satisfied — but the
    // put timeline itself is what the mixed-cluster audit merges.
    if (jrec())
      journal_.record("put_ack", track_,
                      obs::Fields()
                          .u("alloc_id", e.alloc_id)
                          .u("offset", off)
                          .u("nbytes", n)
                          .u("chain", 1)
                          .str());
    return {MsgType::DATA_PUT_OK, {{"nbytes", Value::U(n)}}, {}};
  }

  Message on_data_get(ServeConn& c, const Message& m) {
    RegEntry e = registry_.lookup(m.u("alloc_id"));
    uint64_t off = m.u("offset"), n = m.u("nbytes");
    if (off + n > e.nbytes)
      throw BoundsError("access [" + std::to_string(off) + ", " +
                        std::to_string(off + n) + ") outside extent of " +
                        std::to_string(e.nbytes) + " B");
    if (!kind_is_host(e.kind)) return relay_device_op(m, e);
    Message r{MsgType::DATA_GET_OK, {{"nbytes", Value::U(n)}}, {}};
    // Snapshot copy into this CONNECTION's pooled buffer: keeps the
    // concurrent-free race window bounded to dispatch (a zero-copy arena
    // view would stream freed-then-reused bytes across a stalled send)
    // while skipping the fresh-allocation cost per chunk.
    r.data = take_bulk_buffer(c.bulk_buf,
                              host_store_.data() + e.extent.offset + off, n);
    return r;
  }

  // -- cross-process device plane (PLANE_SERVE / PLANE_PUT / PLANE_GET) --

  Message on_plane_serve(const Message& m) {
    std::string host = m.u("port") ? m.s("host") : "";  // port 0 = clear
    int port = int(m.u("port"));
    {
      std::lock_guard<std::mutex> g(plane_mu_);
      if (host == plane_host_ && port == plane_port_ && m.u("relay") != 0) {
        // Gossiped copy of what we already hold: nothing to do. (An
        // UNCHANGED client re-registration still re-arms the gossip
        // below — a restarted peer daemon re-learns the endpoint.)
        return {MsgType::PLANE_SERVE_OK, {{"port", Value::U(m.u("port"))}},
                {}};
      }
      plane_host_ = host;
      plane_port_ = port;
    }
    if (m.u("relay") == 0) {
      // Fresh (de)registration from a local client: the master matters
      // most (it is everyone's fallback hop), so push there inline — one
      // dial. The rest of the peers are retried from the reaper loop; a
      // synchronous broadcast here would stall the registering client
      // for the connect timeout per unreachable peer.
      size_t n;
      {
        std::lock_guard<std::mutex> ge(entries_mu_);
        n = entries_.size();
      }
      {
        std::lock_guard<std::mutex> g(plane_mu_);
        plane_unsynced_.clear();
        for (size_t r = 0; r < n; ++r)
          if (int64_t(r) != cfg_.rank) plane_unsynced_.insert(int64_t(r));
      }
      if (cfg_.rank != 0) sync_plane_endpoint(/*only_rank=*/0);
    }
    return {MsgType::PLANE_SERVE_OK, {{"port", Value::U(m.u("port"))}}, {}};
  }

  // only_rank == -1: push to every pending peer (reaper); otherwise only
  // to that rank.
  void sync_plane_endpoint(int64_t only_rank = -1) {
    std::string host;
    int port = 0;
    std::vector<int64_t> pending;
    {
      std::lock_guard<std::mutex> g(plane_mu_);
      host = plane_host_;
      port = plane_port_;
      pending.assign(plane_unsynced_.begin(), plane_unsynced_.end());
    }
    for (int64_t r : pending) {
      if (only_rank >= 0 && r != only_rank) continue;
      try {
        NodeEntry e = entry(r);
        peers_.request(e.caddr(), e.port,
                       Message{MsgType::PLANE_SERVE,
                               {{"host", Value::S(host)},
                                {"port", Value::U(uint64_t(port))},
                                {"relay", Value::U(1)}},
                               {}});
        std::lock_guard<std::mutex> g(plane_mu_);
        plane_unsynced_.erase(r);
      } catch (const std::exception&) {
        // retried on the next reaper tick
      }
    }
  }

  Message relay_device_op(const Message& m, const RegEntry& e) {
    if (m.type == MsgType::DATA_PUT) device_writes_relayed_ = true;
    Message relay{
        m.type == MsgType::DATA_PUT ? MsgType::PLANE_PUT : MsgType::PLANE_GET,
        {{"alloc_id", Value::U(e.alloc_id)},
         {"rank", Value::I(cfg_.rank)},
         {"device_index", Value::U(e.device_index)},
         {"ext_offset", Value::U(e.extent.offset)},
         {"ext_nbytes", Value::U(e.nbytes)},
         {"offset", Value::U(m.u("offset"))},
         {"nbytes", Value::U(m.u("nbytes"))}},
        m.data};
    return forward_to_plane(relay);
  }

  Message forward_to_plane(const Message& relay) {
    std::string host;
    int port = 0;
    {
      std::lock_guard<std::mutex> g(plane_mu_);
      host = plane_host_;
      port = plane_port_;
    }
    if (!host.empty()) {
      try {
        return peers_.request(host, port, relay);
      } catch (const std::exception&) {
        // Endpoint unreachable (controller gone without deregistering):
        // drop it — live controllers re-register periodically — and fall
        // through to the master hop / typed error.
        std::lock_guard<std::mutex> g(plane_mu_);
        if (plane_host_ == host && plane_port_ == port) {
          plane_host_.clear();
          plane_port_ = 0;
        }
      }
    }
    if (cfg_.rank != 0) {  // master hop: it learns endpoints first
      NodeEntry r0 = entry(0);
      return peers_.request(r0.caddr(), r0.port, relay);
    }
    throw BadHandleError(
        "device-kind data needs a registered plane: construct the "
        "controller's ControlPlaneClient with ici_plane=");
  }

  Message on_heartbeat(const Message& m) {
    registry_.renew(m.i("pid"), m.i("rank"));
    lease_renewals_.fetch_add(1, std::memory_order_relaxed);
    if (jrec())
      journal_.record("lease_renew", track_,
                      obs::Fields()
                          .i("app_pid", m.i("pid"))
                          .i("app_rank", m.i("rank"))
                          .b("relayed", m.i("rank") != cfg_.rank)
                          .str());
    // Relay local-app heartbeats only to the ranks the app reports as
    // owners of its allocations — O(owners) per beat, not an O(nnodes)
    // broadcast. Relayed copies have origin rank != receiver rank, so no
    // forwarding loop.
    if (m.i("rank") == cfg_.rank) {
      for (int64_t r : parse_owners(m.s("owners"))) {
        if (r == cfg_.rank || r < 0 || size_t(r) >= entries_.size()) continue;
        try {
          NodeEntry e = entry(r);
          peers_.request(e.caddr(), e.port, m);
        } catch (const ProtocolError&) {
        }
      }
    }
    return {MsgType::HEARTBEAT_OK,
            {{"lease_s", Value::D(registry_.lease_s())}},
            {}};
  }

  // Immediate reclamation on app disconnect (main.c:46-47,58-103): free
  // local allocations now, and fan RECLAIM_APP out to the owner ranks the
  // app reported. A crashed app never disconnects — the lease reaper is the
  // backstop.
  void on_disconnect(const Message& m) {
    int64_t pid = m.i("pid");
    // Terminal event for the app's lease-renewal chain: the auditor
    // requires every renewing app to end in disconnect/free/reclaim.
    if (jrec())
      journal_.record("app_disconnect", track_,
                      obs::Fields().i("pid", pid).str());
    reclaim_app_local(pid, cfg_.rank);
    for (int64_t r : parse_owners(m.s("owners"))) {
      if (r == cfg_.rank || r < 0 || size_t(r) >= entries_.size()) continue;
      try {
        NodeEntry e = entry(r);
        peers_.request(e.caddr(), e.port,
                       {MsgType::RECLAIM_APP,
                        {{"pid", Value::I(pid)}, {"rank", Value::I(cfg_.rank)}},
                        {}});
      } catch (const ProtocolError&) {
      }
    }
  }

  uint64_t reclaim_app_local(int64_t pid, int64_t origin_rank) {
    uint64_t n = 0;
    for (uint64_t id : registry_.ids_for_app(pid, origin_rank)) {
      try {
        do_free_local(id);
        ++n;
      } catch (const BadHandleError&) {  // raced with an explicit free
      }
    }
    return n;
  }

  static std::vector<int64_t> parse_owners(const std::string& s) {
    std::vector<int64_t> out;
    size_t pos = 0;
    while (pos <= s.size()) {
      size_t comma = s.find(',', pos);
      std::string part = s.substr(
          pos, comma == std::string::npos ? std::string::npos : comma - pos);
      if (!part.empty()) {
        try {
          out.push_back(std::stoll(part));
        } catch (const std::exception&) {
        }
      }
      if (comma == std::string::npos) break;
      pos = comma + 1;
    }
    return out;
  }

  Message on_status() {
    uint64_t dev_live = 0;
    for (auto& b : device_books_) dev_live += b->bytes_live();
    return {MsgType::STATUS_OK,
            {{"rank", Value::I(cfg_.rank)},
             {"nnodes", Value::I(cfg_.rank == 0 ? placement_.nnodes()
                                                : int64_t(entries_.size()))},
             {"live_allocs", Value::U(registry_.live_count())},
             {"host_bytes_live", Value::U(host_arena_.bytes_live())},
             {"device_bytes_live", Value::U(dev_live)}},
            {}};
  }

  // -- in-band observability (STATUS_PROM / STATUS_EVENTS) ---------------

  // Prometheus text exposition rendered natively (obs/prom.py's format,
  // validated by the same Python format checker): the metrics subset a
  // native daemon owns — cluster view, op spans, arena occupancy and
  // churn, lease health. Families the native daemon has no machinery
  // for (replication, QoS, fabric, elastic) are simply absent, exactly
  // like a Python daemon with those subsystems idle.
  Message on_status_prom() {
    using obs::PromDoc;
    PromDoc doc;
    std::string rank = std::to_string(cfg_.rank);
    doc.sample("ocm_nnodes", "gauge",
               "Cluster size as this daemon sees it.",
               double(cfg_.rank == 0 ? placement_.nnodes()
                                     : int64_t(entries_.size())),
               {{"rank", rank}});
    doc.sample("ocm_live_allocs", "gauge",
               "Live allocations registered on this daemon.",
               double(registry_.live_count()), {{"rank", rank}});
    for (const auto& kv : opstats_.snapshot()) {
      PromDoc::Labels lab{{"rank", rank}, {"op", kv.first}};
      doc.sample("ocm_op_total", "counter",
                 "Completed Tracer spans per op.", double(kv.second.count),
                 lab);
      doc.sample("ocm_op_bytes_total", "counter",
                 "Bytes moved by completed spans per op.",
                 double(kv.second.total_bytes), lab);
      doc.sample("ocm_op_p50_seconds", "gauge",
                 "p50 span latency over the sample ring.",
                 kv.second.p50_s, lab);
      doc.sample("ocm_op_p99_seconds", "gauge",
                 "p99 span latency over the sample ring.",
                 kv.second.p99_s, lab);
      doc.sample("ocm_op_gigabits_per_second", "gauge",
                 "Lifetime mean throughput per op (gigabits/s).",
                 kv.second.total_s > 0
                     ? double(kv.second.total_bytes) * 8 /
                           kv.second.total_s / 1e9
                     : 0.0,
                 lab);
    }
    auto arena_rows = [&](const std::string& name, uint64_t live,
                          uint64_t cap, uint64_t allocs, uint64_t frees) {
      doc.sample("ocm_arena_live_bytes", "gauge",
                 "Bytes currently reserved in an arena.", double(live),
                 {{"rank", rank}, {"arena", name}});
      doc.sample("ocm_arena_capacity_bytes", "gauge",
                 "Arena capacity in bytes.", double(cap),
                 {{"rank", rank}, {"arena", name}});
      doc.sample("ocm_arena_ops_total", "counter",
                 "Lifetime arena operations (allocation churn).",
                 double(allocs),
                 {{"rank", rank}, {"arena", name}, {"op", "alloc"}});
      doc.sample("ocm_arena_ops_total", "counter",
                 "Lifetime arena operations (allocation churn).",
                 double(frees),
                 {{"rank", rank}, {"arena", name}, {"op", "free"}});
    };
    arena_rows("host", host_arena_.bytes_live(), cfg_.host_arena_bytes,
               host_arena_.alloc_count(), host_arena_.release_count());
    for (size_t i = 0; i < device_books_.size(); ++i)
      arena_rows("device" + std::to_string(i), device_books_[i]->bytes_live(),
                 cfg_.device_arena_bytes, device_books_[i]->alloc_count(),
                 device_books_[i]->release_count());
    doc.sample("ocm_lease_renewals_total", "counter",
               "Heartbeat-driven lease renewals processed.",
               double(lease_renewals_.load()), {{"rank", rank}});
    doc.sample("ocm_lease_reclaims_total", "counter",
               "Allocations the lease reaper took back.",
               double(lease_reclaims_.load()), {{"rank", rank}});
    doc.sample("ocm_leases_expired", "gauge",
               "Live allocations currently past their lease.",
               double(registry_.expired().size()), {{"rank", rank}});
    std::string text = doc.text();
    Message r{MsgType::STATUS_PROM_OK, {{"rank", Value::I(cfg_.rank)}}, {}};
    r.data.assign(text.begin(), text.end());
    return r;
  }

  // The journal ring as JSONL — exactly journal.py dump_jsonl's record
  // shape, so the obs CLI's --trace cluster merge and the Perfetto
  // exporter consume a native rank with zero changes.
  Message on_status_events() {
    std::string jsonl = journal_.dump_jsonl();
    uint64_t count = 0;
    for (char ch : jsonl)
      if (ch == '\n') ++count;
    Message r{MsgType::STATUS_EVENTS_OK,
              {{"rank", Value::I(cfg_.rank)}, {"count", Value::U(count)}},
              {}};
    r.data.assign(jsonl.begin(), jsonl.end());
    return r;
  }

  NodeEntry entry(int64_t rank) {
    std::lock_guard<std::mutex> g(entries_mu_);
    return entries_.at(size_t(rank));
  }

  Config cfg_;
  std::vector<NodeEntry> entries_;
  std::mutex entries_mu_;
  // Device-plane endpoint registered via PLANE_SERVE (empty host = none);
  // plane_unsynced_ = peer ranks that have not confirmed the endpoint yet
  // (pushed again from the reaper loop).
  std::mutex plane_mu_;
  std::string plane_host_;
  int plane_port_ = 0;
  std::set<int64_t> plane_unsynced_;
  std::atomic<bool> device_writes_relayed_{false};
  ArenaAllocator host_arena_;
  std::vector<uint8_t> host_store_;  // the DCN arm's actual bytes
  std::vector<std::unique_ptr<ArenaAllocator>> device_books_;
  Registry registry_;
  Placement placement_;
  PeerPool peers_;
  // Observability (obs.hh): journal ring + flight recorder + op spans.
  // obs_enabled_ is the OCM_NATIVE_OBS master switch (default on);
  // caps_mask_ is what CONNECT_CONFIRM echoes.
  std::string track_;
  bool obs_enabled_ = true;
  uint16_t caps_mask_ = kCapsImplemented;
  obs::Journal journal_;
  obs::OpStatsBook opstats_;
  std::atomic<uint64_t> lease_renewals_{0};
  std::atomic<uint64_t> lease_reclaims_{0};
  std::atomic<bool> signalled_{false};
  std::atomic<bool> running_{false};
  std::thread reaper_thread_;
  // Per-message control threads (blocking semantics preserved), reaped
  // from the reaper loop via finished_.
  std::vector<std::thread> serve_threads_;
  std::mutex reap_mu_;
  std::vector<std::thread::id> finished_;
  // DATA-plane worker pool.
  std::vector<std::thread> pool_threads_;
  std::mutex queue_mu_;
  std::condition_variable queue_cv_;
  std::deque<Work> queue_;
  bool queue_stop_ = false;
  bool started_ok_ = false;
  std::mutex conns_mu_;
  std::map<int, std::shared_ptr<ServeConn>> conns_;
  int listen_fd_ = -1;
  int epoll_fd_ = -1;
  int wake_fd_ = -1;
};

Daemon* g_daemon = nullptr;

void on_signal(int) {
  if (g_daemon) g_daemon->request_stop();
}

}  // namespace
}  // namespace ocm

int main(int argc, char** argv) {
  ocm::Config cfg;
  if (const char* bh = getenv("OCM_BIND_HOST")) cfg.bind_host = bh;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> std::string {
      if (i + 1 >= argc) throw std::runtime_error("missing value for " + a);
      return argv[++i];
    };
    if (a == "--nodefile") cfg.nodefile = next();
    else if (a == "--rank") cfg.rank = std::stoll(next());
    else if (a == "--policy") cfg.capacity_policy = next() == "capacity";
    else if (a == "--ndevices") cfg.ndevices = uint32_t(std::stoul(next()));
    else if (a == "--host-arena-bytes") cfg.host_arena_bytes = std::stoull(next());
    else if (a == "--device-arena-bytes") cfg.device_arena_bytes = std::stoull(next());
    else if (a == "--alignment") cfg.alignment = std::stoull(next());
    else if (a == "--lease-s") cfg.lease_s = std::stod(next());
    else if (a == "--heartbeat-s") cfg.heartbeat_s = std::stod(next());
    else if (a == "--snapshot") cfg.snapshot_path = next();
    else if (a == "--bind-host") cfg.bind_host = next();
    else {
      std::fprintf(stderr, "unknown flag %s\n", a.c_str());
      return 2;
    }
  }
  if (cfg.nodefile.empty() || cfg.rank < 0) {
    std::fprintf(stderr,
                 "usage: oncillamemd --nodefile FILE --rank N [--policy "
                 "capacity|neighbor] [--ndevices N] [--host-arena-bytes N] "
                 "[--device-arena-bytes N] [--alignment N] [--lease-s S] "
                 "[--heartbeat-s S]\n");
    return 2;
  }
  try {
    auto entries = ocm::parse_nodefile(cfg.nodefile);
    ocm::Daemon d(cfg, entries);
    ocm::g_daemon = &d;
    signal(SIGINT, ocm::on_signal);
    signal(SIGTERM, ocm::on_signal);
    d.run();
  } catch (const std::exception& e) {
    std::fprintf(stderr, "oncillamemd: fatal: %s\n", e.what());
    return 1;
  }
  return 0;
}
