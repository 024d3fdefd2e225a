// libocm_tpu — C-linkable client library for the oncilla-tpu control plane.
//
// The app half of the reference's libocm (its src/lib.c) rebuilt
// on this framework's versioned wire protocol: CONNECT handshake with the
// local daemon (lib.c:98-132), REQ_ALLOC/REQ_FREE through it, and chunked,
// pipelined DATA_PUT/DATA_GET straight to the owner daemon (the one-sided
// data plane that bypasses the local daemon per transfer, SURVEY.md §1;
// window scheme of extoll_rma2_transfer, extoll.c:47-173). Mirrors
// oncilla_tpu/runtime/client.py (the executable spec).
//
// Built as a shared library so C/C++/Fortran applications can drive the
// same daemons as the Python binding.

#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <future>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "membership.hh"
#include "net.hh"
#include "ocm_client.h"
#include "protocol.hh"

namespace {

using namespace ocm;

std::mutex g_init_err_mu;
std::string g_init_err;  // ocmc_last_error(NULL)

struct DataConn {
  int fd = -1;
  std::mutex mu;
  // Receive scratch reused across chunks (holder of mu owns it).
  std::vector<uint8_t> scratch;
  ~DataConn() {
    if (fd >= 0) ::close(fd);
  }
};

}  // namespace

struct ocmc_ctx {
  std::vector<NodeEntry> entries;
  int64_t rank = 0;
  int64_t pid = 0;
  int64_t nnodes = 0;
  // Same defaults as OcmConfig (utils/config.py): 2-deep pipelining per
  // the reference's scheme (extoll.c:44-47), 16 MiB chunks (the
  // reference's 8 MB was an EXTOLL hardware cap; 16 MiB measured best on
  // this transport). OCM_CHUNK_BYTES overrides, like the Python side.
  uint64_t chunk_bytes = [] {
    const uint64_t kDefault = uint64_t(16) << 20;
    const char* v = std::getenv("OCM_CHUNK_BYTES");
    if (!v || !*v) return kDefault;
    char* end = nullptr;
    errno = 0;
    uint64_t n = std::strtoull(v, &end, 10);
    // A malformed, zero, negative (strtoull wraps "-1" to 2^64-1) or
    // overflowing value must not reach the transfer engine: a 0-byte
    // chunk never advances `pos` and loops forever, and a wrapped giant
    // defeats the 2 x chunk_bytes buffering bound (the Python twin
    // raises at config construction instead, utils/config.py).
    if (end == v || *end != '\0' || n == 0 || v[0] == '-' ||
        errno == ERANGE || n > (uint64_t(1) << 40)) {
      std::fprintf(stderr,
                   "libocm: ignoring invalid OCM_CHUNK_BYTES=%s\n", v);
      return kDefault;
    }
    return n;
  }();
  int inflight = 2;  // extoll.c:44-47
  int ctrl_fd = -1;
  std::mutex ctrl_mu;
  std::map<std::string, std::shared_ptr<DataConn>> data_conns;
  std::mutex data_mu;
  std::string last_error;
  mutable std::mutex err_mu;
  // rank -> live remote-alloc count; reported as the "owners" field on
  // HEARTBEAT/DISCONNECT so daemons relay/reclaim with O(owners) fan-out.
  std::map<int64_t, int> owner_ranks;
  std::mutex owners_mu;
  // Per-handle app-side staging buffers (ocm_localbuf; the reference
  // mallocs one into the handle at alloc time, lib.c:255-269).
  std::map<uint64_t, std::vector<uint8_t>> stagebufs;
  std::mutex stage_mu;
  std::thread hb_thread;
  std::atomic<bool> hb_stop{false};
  std::condition_variable hb_cv;
  std::mutex hb_mu;

  ~ocmc_ctx() {
    hb_stop = true;
    hb_cv.notify_all();
    // Polite DISCONNECT while the fd is still whole. try_lock keeps
    // teardown bounded: if a heartbeat is wedged inside ctrl_request on a
    // dead daemon, skip the courtesy message rather than block on ctrl_mu.
    if (ctrl_fd >= 0 && ctrl_mu.try_lock()) {
      try {
        Message m{MsgType::DISCONNECT,
                  {{"pid", Value::I(pid)}, {"owners", Value::S(owners_field())}},
                  {}};
        send_msg(ctrl_fd, m);
      } catch (...) {
      }
      ctrl_mu.unlock();
    }
    // Shut the socket down BEFORE joining: this unblocks a heartbeat stuck
    // in send/recv on a wedged daemon (join-before-shutdown hung forever).
    if (ctrl_fd >= 0) ::shutdown(ctrl_fd, SHUT_RDWR);
    if (hb_thread.joinable()) hb_thread.join();
    if (ctrl_fd >= 0) ::close(ctrl_fd);
  }

  void set_error(const std::string& e) {
    std::lock_guard<std::mutex> g(err_mu);
    last_error = e;
  }

  std::string owners_field() {
    std::lock_guard<std::mutex> g(owners_mu);
    std::string s;
    for (auto& kv : owner_ranks) {
      if (!s.empty()) s += ",";
      s += std::to_string(kv.first);
    }
    return s;
  }

  void note_owner(int64_t owner_rank, int delta) {
    if (owner_rank == rank) return;
    std::lock_guard<std::mutex> g(owners_mu);
    int n = owner_ranks[owner_rank] + delta;
    if (n > 0)
      owner_ranks[owner_rank] = n;
    else
      owner_ranks.erase(owner_rank);
  }

  Message ctrl_request(const Message& m) {
    std::lock_guard<std::mutex> g(ctrl_mu);
    send_msg(ctrl_fd, m);
    Message r = recv_msg(ctrl_fd);
    if (r.type == MsgType::ERR)
      throw ProtocolError("daemon error " + std::to_string(r.u("code")) +
                          ": " + r.s("detail"));
    return r;
  }

  std::shared_ptr<DataConn> data_conn(const std::string& host, int port) {
    auto key = host + ":" + std::to_string(port);
    std::lock_guard<std::mutex> g(data_mu);
    auto it = data_conns.find(key);
    if (it != data_conns.end()) return it->second;
    auto c = std::make_shared<DataConn>();
    c->fd = dial(host, port);
    data_conns[key] = c;
    return c;
  }

  void evict_data_conn(const std::string& host, int port) {
    auto key = host + ":" + std::to_string(port);
    std::lock_guard<std::mutex> g(data_mu);
    data_conns.erase(key);  // ~DataConn closes when last user drops it
  }

  // Chunked, windowed transfer to the owner daemon (client.py
  // _pipelined_once): keep `inflight` requests on the wire; on a daemon
  // ERR reply drain the remaining in-flight replies before failing so the
  // cached connection stays in sync; transport errors evict it. One full
  // retry through the membership address (DATA_PUT/GET are idempotent).
  void transfer(const ocmc_handle* h, uint64_t total,
                const std::function<Message(uint64_t, uint64_t)>& make_req,
                const std::function<void(const Message&, uint64_t, uint64_t)>&
                    on_reply) {
    try {
      transfer_once(h->owner_host, int(h->owner_port), total, make_req,
                    on_reply);
      return;
    } catch (const ProtocolError& e) {
      if (std::string(e.what()).rfind("daemon error", 0) == 0) throw;
      const NodeEntry& e2 = entries.at(size_t(h->rank));
      transfer_once(e2.caddr(), e2.port, total, make_req, on_reply);
    }
  }

  void transfer_once(
      const std::string& host, int port, uint64_t total,
      const std::function<Message(uint64_t, uint64_t)>& make_req,
      const std::function<void(const Message&, uint64_t, uint64_t)>&
          on_reply) {
    auto c = data_conn(host, port);
    std::lock_guard<std::mutex> g(c->mu);
    std::deque<std::pair<uint64_t, uint64_t>> window;  // (chunk_off, nbytes)
    uint64_t pos = 0;
    std::string failure;
    try {
      while (pos < total || !window.empty()) {
        while (pos < total && window.size() < size_t(inflight) &&
               failure.empty()) {
          uint64_t n = std::min(chunk_bytes, total - pos);
          send_msg(c->fd, make_req(pos, n));
          window.emplace_back(pos, n);
          pos += n;
        }
        if (window.empty()) break;
        Message r = recv_msg(c->fd, &c->scratch);
        auto [start, n] = window.front();
        window.pop_front();
        if (r.type == MsgType::ERR) {
          if (failure.empty())
            failure = "daemon error " + std::to_string(r.u("code")) + ": " +
                      r.s("detail");
        } else if (failure.empty()) {
          on_reply(r, start, n);
        }
      }
    } catch (const ProtocolError&) {
      evict_data_conn(host, port);
      throw;
    }
    if (!failure.empty()) throw ProtocolError(failure);
  }
};

namespace {

void heartbeat_loop(ocmc_ctx* ctx, double period_s) {
  std::unique_lock<std::mutex> lk(ctx->hb_mu);
  while (!ctx->hb_stop) {
    ctx->hb_cv.wait_for(
        lk, std::chrono::duration<double>(period_s),
        [&] { return ctx->hb_stop.load(); });
    if (ctx->hb_stop) return;
    try {
      ctx->ctrl_request(Message{MsgType::HEARTBEAT,
                                {{"rank", Value::I(ctx->rank)},
                                 {"pid", Value::I(ctx->pid)},
                                 {"owners", Value::S(ctx->owners_field())}},
                                {}});
    } catch (...) {  // transient: next beat retries
    }
  }
}

bool kind_is_device(uint8_t k) {
  return k == OCMC_KIND_LOCAL_DEVICE || k == OCMC_KIND_REMOTE_DEVICE;
}

}  // namespace

extern "C" {

ocmc_ctx* ocmc_init(const char* nodefile, int64_t rank, double heartbeat_s) {
  auto fail = [&](const std::string& e) -> ocmc_ctx* {
    std::lock_guard<std::mutex> g(g_init_err_mu);
    g_init_err = e;
    return nullptr;
  };
  try {
    auto ctx = std::make_unique<ocmc_ctx>();
    ctx->entries = parse_nodefile(nodefile ? nodefile : "");
    if (rank < 0 || size_t(rank) >= ctx->entries.size())
      return fail("rank out of range for nodefile");
    ctx->rank = rank;
    ctx->pid = int64_t(::getpid());
    const NodeEntry& me = ctx->entries[size_t(rank)];
    ctx->ctrl_fd = dial(me.caddr(), me.port);
    Message r = ctx->ctrl_request(Message{
        MsgType::CONNECT,
        {{"pid", Value::I(ctx->pid)}, {"rank", Value::I(rank)}},
        {}});
    if (r.type != MsgType::CONNECT_CONFIRM)
      return fail("bad handshake reply");
    ctx->nnodes = r.i("nnodes");
    if (heartbeat_s > 0) {
      ocmc_ctx* raw = ctx.get();
      ctx->hb_thread =
          std::thread([raw, heartbeat_s] { heartbeat_loop(raw, heartbeat_s); });
    }
    return ctx.release();
  } catch (const std::exception& e) {
    return fail(e.what());
  }
}

void ocmc_tini(ocmc_ctx* ctx) { delete ctx; }

int ocmc_alloc(ocmc_ctx* ctx, uint64_t nbytes, uint8_t kind,
               ocmc_handle* out) {
  if (!ctx || !out) return -1;
  try {
    Message r = ctx->ctrl_request(Message{MsgType::REQ_ALLOC,
                                          {{"orig_rank", Value::I(ctx->rank)},
                                           {"pid", Value::I(ctx->pid)},
                                           {"kind", Value::U(kind)},
                                           {"nbytes", Value::U(nbytes)}},
                                          {}});
    std::memset(out, 0, sizeof(*out));
    out->alloc_id = r.u("alloc_id");
    out->rank = r.i("rank");
    out->device_index = uint32_t(r.u("device_index"));
    out->kind = uint8_t(r.u("kind"));
    out->nbytes = nbytes;
    out->offset = r.u("offset");
    std::snprintf(out->owner_host, sizeof(out->owner_host), "%s",
                  r.s("owner_host").c_str());
    out->owner_port = uint32_t(r.u("owner_port"));
    ctx->note_owner(out->rank, +1);
    return 0;
  } catch (const std::exception& e) {
    ctx->set_error(e.what());
    return -1;
  }
}

int ocmc_free(ocmc_ctx* ctx, const ocmc_handle* h) {
  if (!ctx || !h) return -1;
  try {
    ctx->ctrl_request(Message{MsgType::REQ_FREE,
                              {{"alloc_id", Value::U(h->alloc_id)},
                               {"rank", Value::I(h->rank)}},
                              {}});
    ctx->note_owner(h->rank, -1);
    {
      std::lock_guard<std::mutex> g(ctx->stage_mu);
      ctx->stagebufs.erase(h->alloc_id);
    }
    return 0;
  } catch (const std::exception& e) {
    ctx->set_error(e.what());
    return -1;
  }
}

int ocmc_put(ocmc_ctx* ctx, const ocmc_handle* h, const void* buf,
             uint64_t nbytes, uint64_t offset) {
  if (!ctx || !h || (!buf && nbytes)) return -1;
  // Device kinds flow like host kinds: the owner daemon relays them to the
  // SPMD controller's registered plane endpoint (PLANE_PUT/PLANE_GET), so
  // a pure-C app gets the full kind taxonomy cross-process.
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  try {
    ctx->transfer(
        h, nbytes,
        [&](uint64_t pos, uint64_t n) {
          Message m{MsgType::DATA_PUT,
                    {{"alloc_id", Value::U(h->alloc_id)},
                     {"offset", Value::U(offset + pos)},
                     {"nbytes", Value::U(n)}},
                    {}};
          m.data.assign(p + pos, p + pos + n);
          return m;
        },
        [](const Message&, uint64_t, uint64_t) {});
    return 0;
  } catch (const std::exception& e) {
    ctx->set_error(e.what());
    return -1;
  }
}

int ocmc_get(ocmc_ctx* ctx, const ocmc_handle* h, void* buf, uint64_t nbytes,
             uint64_t offset) {
  if (!ctx || !h || (!buf && nbytes)) return -1;
  uint8_t* p = static_cast<uint8_t*>(buf);
  try {
    ctx->transfer(
        h, nbytes,
        [&](uint64_t pos, uint64_t n) {
          return Message{MsgType::DATA_GET,
                         {{"alloc_id", Value::U(h->alloc_id)},
                          {"offset", Value::U(offset + pos)},
                          {"nbytes", Value::U(n)}},
                         {}};
        },
        [&](const Message& r, uint64_t start, uint64_t n) {
          if (r.data.size() != n)
            throw ProtocolError("short DATA_GET reply");
          std::memcpy(p + start, r.data.data(), n);
        });
    return 0;
  } catch (const std::exception& e) {
    ctx->set_error(e.what());
    return -1;
  }
}

static void* localbuf_impl(ocmc_ctx* ctx, const ocmc_handle* h,
                           uint64_t window, uint64_t* out_size) {
  try {
    std::lock_guard<std::mutex> g(ctx->stage_mu);
    auto it = ctx->stagebufs.find(h->alloc_id);
    if (it == ctx->stagebufs.end()) {
      it = ctx->stagebufs
               .emplace(h->alloc_id,
                        std::vector<uint8_t>(window ? window : h->nbytes, 0))
               .first;
    } else if (window && it->second.size() != window) {
      ctx->set_error("staging window already created at a different size");
      return nullptr;
    }
    if (out_size) *out_size = it->second.size();
    return it->second.data();
  } catch (const std::exception& e) {  // bad_alloc must not cross the C ABI
    ctx->set_error(std::string("localbuf allocation failed: ") + e.what());
    return nullptr;
  }
}

void* ocmc_localbuf(ocmc_ctx* ctx, const ocmc_handle* h) {
  if (!ctx || !h) return nullptr;
  return localbuf_impl(ctx, h, 0, nullptr);
}

uint64_t ocmc_localbuf_size(ocmc_ctx* ctx, const ocmc_handle* h) {
  if (!ctx || !h) return 0;
  std::lock_guard<std::mutex> g(ctx->stage_mu);
  auto it = ctx->stagebufs.find(h->alloc_id);
  return it == ctx->stagebufs.end() ? 0 : it->second.size();
}

void* ocmc_localbuf_sized(ocmc_ctx* ctx, const ocmc_handle* h,
                          uint64_t nbytes) {
  if (!ctx || !h) return nullptr;
  if (nbytes == 0 || nbytes > h->nbytes) {
    ctx->set_error("window size must be in (0, handle nbytes]");
    return nullptr;
  }
  return localbuf_impl(ctx, h, nbytes, nullptr);
}

int ocmc_copy_onesided(ocmc_ctx* ctx, const ocmc_handle* h, int op_flag) {
  if (!ctx || !h) return -1;
  uint64_t window = 0;
  void* buf = localbuf_impl(ctx, h, 0, &window);
  if (!buf) return -1;
  // The staging vector is stable (never resized after creation), so using
  // the pointer outside stage_mu is safe until ocmc_free/ocmc_tini. An
  // asymmetric window moves its own size (from remote offset 0; use
  // ocmc_put/ocmc_get for explicit offsets).
  return op_flag ? ocmc_put(ctx, h, buf, window, 0)
                 : ocmc_get(ctx, h, buf, window, 0);
}

int ocmc_copy(ocmc_ctx* ctx, const ocmc_handle* dst, const ocmc_handle* src,
              uint64_t nbytes) {
  if (!ctx || !dst || !src) return -1;
  if (nbytes == 0) nbytes = std::min(src->nbytes, dst->nbytes);
  if (nbytes > src->nbytes || nbytes > dst->nbytes) {
    ctx->set_error("ocmc_copy size exceeds an allocation");
    return -1;
  }
  // Double-buffered stream through the app: the get of chunk N+1 overlaps
  // the put of chunk N (the extoll.c:44-51 overlap idea at the copy level;
  // 2 x chunk_bytes of memory). ocmc_get/ocmc_put are thread-safe — data
  // connections carry their own mutexes.
  try {
    std::vector<uint8_t> cur(std::min(ctx->chunk_bytes, nbytes));
    std::vector<uint8_t> next;
    uint64_t pos = 0;
    if (ocmc_get(ctx, src, cur.data(), cur.size(), pos) != 0) return -1;
    while (pos < nbytes) {
      uint64_t n = cur.size();
      uint64_t next_pos = pos + n;
      std::future<int> fut;
      if (next_pos < nbytes) {
        uint64_t next_n = std::min(ctx->chunk_bytes, nbytes - next_pos);
        next.resize(next_n);
        fut = std::async(std::launch::async, [&, next_pos, next_n] {
          return ocmc_get(ctx, src, next.data(), next_n, next_pos);
        });
      }
      int put_rc = ocmc_put(ctx, dst, cur.data(), n, pos);
      int get_rc = fut.valid() ? fut.get() : 0;
      if (put_rc != 0 || get_rc != 0) return -1;
      cur.swap(next);
      pos = next_pos;
    }
    return 0;
  } catch (const std::exception& e) {  // allocation/thread failure
    ctx->set_error(std::string("ocmc_copy failed: ") + e.what());
    return -1;
  }
}

int ocmc_copy_out(ocmc_ctx* ctx, void* dst, const ocmc_handle* src,
                  uint64_t nbytes, uint64_t offset) {
  return ocmc_get(ctx, src, dst, nbytes, offset);
}

int ocmc_copy_in(ocmc_ctx* ctx, const ocmc_handle* dst, const void* src,
                 uint64_t nbytes, uint64_t offset) {
  return ocmc_put(ctx, dst, src, nbytes, offset);
}

int ocmc_is_remote(const ocmc_handle* h) {
  if (!h) return 0;
  return (h->kind == OCMC_KIND_REMOTE_HOST ||
          h->kind == OCMC_KIND_REMOTE_DEVICE)
             ? 1
             : 0;
}

uint64_t ocmc_remote_sz(const ocmc_handle* h) {
  return (h && ocmc_is_remote(h)) ? h->nbytes : 0;
}

int64_t ocmc_nnodes(const ocmc_ctx* ctx) { return ctx ? ctx->nnodes : 0; }

int64_t ocmc_refresh_nnodes(ocmc_ctx* ctx) {
  if (!ctx) return -1;
  try {
    Message r = ctx->ctrl_request(Message{MsgType::STATUS, {}, {}});
    ctx->nnodes = r.i("nnodes");
    return ctx->nnodes;
  } catch (const std::exception& e) {
    ctx->set_error(e.what());
    return -1;
  }
}

const char* ocmc_last_error(const ocmc_ctx* ctx) {
  // Snapshot into thread-local storage under the lock: the returned pointer
  // is stable for the calling thread until its next ocmc_last_error call,
  // and never races a concurrent set_error (returning last_error.c_str()
  // directly was a data race and a use-after-free hazard).
  thread_local std::string tls;
  if (!ctx) {
    std::lock_guard<std::mutex> g(g_init_err_mu);
    tls = g_init_err;
  } else {
    std::lock_guard<std::mutex> g(ctx->err_mu);
    tls = ctx->last_error;
  }
  return tls.c_str();
}

}  // extern "C"
