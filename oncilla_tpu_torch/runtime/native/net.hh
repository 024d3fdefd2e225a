// Socket plumbing shared by the daemon and the C client library
// (conn_put/conn_get analogue, the reference's src/sock.c): length-exact
// framed send/recv of protocol.hh messages over blocking TCP, plus dial().

#pragma once

#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cerrno>
#include <cstring>
#include <functional>
#include <string>
#include <vector>

#include "protocol.hh"

namespace ocm {

inline void send_all(int fd, const uint8_t* p, size_t n) {
  while (n) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) throw ProtocolError("send failed");
    p += w;
    n -= size_t(w);
  }
}

// Read exactly n bytes. eof_ok permits a clean EOF *before the first
// byte* (returns false); EOF mid-read always throws (protocol.py
// _recv_exact semantics). Socket errors (r < 0) are reported with errno —
// a reset from a crashed peer is not "malformed input".
inline bool recv_all(int fd, uint8_t* p, size_t n, bool eof_ok = false) {
  size_t want = n;
  while (want) {
    ssize_t r = ::recv(fd, p, want, 0);
    if (r < 0)
      throw ProtocolError(std::string("recv failed: ") + strerror(errno));
    if (r == 0) {
      if (eof_ok && want == n) return false;
      throw ProtocolError(want == n ? "peer closed" : "peer closed mid-message");
    }
    p += r;
    want -= size_t(r);
  }
  return true;
}

// Scatter-gather sendall of [a, b] without concatenating them — the
// bulk-data path (copying an 8 MiB payload into a contiguous frame costs
// two extra memcpys per chunk).
inline void send_vec(int fd, const uint8_t* a, size_t an, const uint8_t* b,
                     size_t bn) {
  while (an + bn) {
    struct iovec iov[2];
    int cnt = 0;
    if (an) iov[cnt++] = {const_cast<uint8_t*>(a), an};
    if (bn) iov[cnt++] = {const_cast<uint8_t*>(b), bn};
    struct msghdr mh = {};
    mh.msg_iov = iov;
    mh.msg_iovlen = size_t(cnt);
    ssize_t w = ::sendmsg(fd, &mh, MSG_NOSIGNAL);
    if (w <= 0) throw ProtocolError("send failed");
    size_t ww = size_t(w);
    size_t from_a = ww < an ? ww : an;
    a += from_a;
    an -= from_a;
    ww -= from_a;
    b += ww;
    bn -= ww;
  }
}

inline void send_msg(int fd, const Message& m) {
  if (m.data.size() >= (64u << 10)) {
    auto prefix = pack_prefix(m);
    send_vec(fd, prefix.data(), prefix.size(), m.data.data(), m.data.size());
    return;
  }
  auto buf = pack(m);
  send_all(fd, buf.data(), buf.size());
}

// With `scratch`, small payloads land in a REUSED buffer, and BULK
// payloads of fixed-field messages (DATA_PUT/DATA_GET_OK chunks) are
// received STRAIGHT into Message::data — no intermediate buffer, no
// extra copy per 8 MiB chunk. Pass one scratch per connection in the
// data-plane loops.
inline Message recv_msg(int fd, std::vector<uint8_t>* scratch = nullptr) {
  uint8_t header[kHeaderSize];
  if (!recv_all(fd, header, kHeaderSize, /*eof_ok=*/true))
    throw ProtocolError("peer closed");
  uint64_t plen = 0;
  for (int i = 0; i < 4; ++i) plen |= uint64_t(header[8 + i]) << (8 * i);
  if (plen > kMaxPayload) throw ProtocolError("advertised payload too large");
  size_t ffix = SIZE_MAX;
  if (plen >= (64u << 10)) {
    try {
      ffix = fixed_fields_size(MsgType(header[5]));
    } catch (const ProtocolError&) {
      ffix = SIZE_MAX;  // unknown type: let unpack raise the real error
    }
  }
  if (ffix != SIZE_MAX && ffix <= 64 && plen >= ffix &&
      (plen - ffix) >= (64u << 10)) {
    uint8_t fields[64];
    if (ffix) recv_all(fd, fields, ffix);
    Message m = unpack_fields(header, fields, ffix);
    m.data.resize(plen - ffix);
    recv_all(fd, m.data.data(), m.data.size());
    return m;
  }
  if (scratch) {
    if (scratch->size() < plen) scratch->resize(plen);
    if (plen) recv_all(fd, scratch->data(), plen);
    return unpack(header, scratch->data(), plen);
  }
  std::vector<uint8_t> payload(plen);
  if (plen) recv_all(fd, payload.data(), plen);
  return unpack(header, payload.data(), plen);
}

// Zero-copy landing hook for bulk payloads — the C++ twin of protocol.py
// recv_msg(data_router=): called after a fixed-field bulk message's
// fields are decoded but BEFORE its payload is read, it may return a
// writable pointer to exactly n_data bytes (e.g. the destination arena
// extent of a DATA_PUT — the recv IS the write, no scratch hop, no
// copy). The message is then delivered with data_landed = true and an
// empty Message::data. A nullptr return (or a router exception) takes
// the ordinary copy path, where the handler raises the typed error.
using DataRouter = std::function<uint8_t*(Message&, size_t)>;

// Incremental frame assembly for ONE connection on a readiness-driven
// (epoll) serve loop: feed it the fd whenever the loop reports
// readability and it advances a header -> fields -> data state machine
// with MSG_DONTWAIT reads, never blocking and never reading past the
// current frame. The fd itself stays in blocking mode, so replies can
// ride the ordinary send_msg path (a blocked send is woken by
// shutdown(2) at stop time, exactly the thread-per-connection
// semantics this replaces).
//
// advance() returns kNeedMore when the socket drained mid-frame,
// kComplete when a full message is assembled (call take() before the
// next advance), or kClosed on a clean EOF at a frame boundary; it
// throws ProtocolError on malformed input or transport errors, leaving
// the connection to be dropped. Unknown message TYPES are not an
// advance() failure: the frame is consumed whole (the stream stays in
// sync) and take() throws UnknownMsgError, which the serve loop
// answers with a typed BAD_MSG — decline-by-silence for whole
// families, same as the blocking recv_msg path.
class FrameReader {
 public:
  enum class Status { kNeedMore, kComplete, kClosed };

  Status advance(int fd, const DataRouter& router = nullptr) {
    while (true) {
      switch (phase_) {
        case Phase::kHeader: {
          Status st = fill(fd, header_ + got_, kHeaderSize);
          if (st != Status::kComplete) return st;
          on_header(router);
          if (phase_ == Phase::kDone) return Status::kComplete;
          break;
        }
        case Phase::kFields: {
          Status st = fill(fd, fields_ + got_, ffix_);
          if (st != Status::kComplete) return st;
          on_fields(router);
          if (phase_ == Phase::kDone) return Status::kComplete;
          break;
        }
        case Phase::kTrace: {
          // A kFlagTraceCtx request's data tail starts with a 16-byte
          // trace context that is NOT payload (obs/trace.py): read it
          // into its own buffer so the payload proper — including the
          // burst-closing chunk of a striped coalesced put, the one
          // chunk that carries the prefix — still lands zero-copy in
          // the arena via the router.
          Status st = fill(fd, trace_buf_ + got_, kTraceCtxBytes);
          if (st != Status::kComplete) return st;
          uint64_t tid = 0, sid = 0;
          for (int i = 0; i < 8; ++i) {
            tid |= uint64_t(trace_buf_[i]) << (8 * i);
            sid |= uint64_t(trace_buf_[8 + i]) << (8 * i);
          }
          msg_.trace_id = tid;
          msg_.trace_span_id = sid;
          msg_.flags &= ~kFlagTraceCtx;  // stripped: handlers see payload only
          n_data_ -= kTraceCtxBytes;
          begin_data(router);
          if (phase_ == Phase::kDone) return Status::kComplete;
          break;
        }
        case Phase::kData: {
          Status st = fill(fd, data_dst_ + got_, n_data_);
          if (st != Status::kComplete) return st;
          phase_ = Phase::kDone;
          return Status::kComplete;
        }
        case Phase::kPayload: {
          Status st = fill(fd, payload_.data() + got_, plen_);
          if (st != Status::kComplete) return st;
          phase_ = Phase::kDone;
          return Status::kComplete;
        }
        case Phase::kDone:
          // take() was not called; nothing to read until it is.
          return Status::kComplete;
      }
    }
  }

  // Move the completed message out and reset for the next frame. May
  // throw (UnknownMsgError for a type this build predates,
  // ProtocolError for malformed fields) — the reader is ALREADY reset
  // when it does, so the stream stays usable at the next frame.
  Message take() {
    phase_ = Phase::kHeader;
    got_ = 0;
    if (fields_parsed_) {
      fields_parsed_ = false;
      Message out = std::move(msg_);
      msg_ = Message{};
      return out;
    }
    std::vector<uint8_t> payload;
    payload.swap(payload_);
    Message m = unpack(header_, payload.data(), plen_);
    // Variable-width (string-schema) types assemble whole and decode
    // here, so their trace prefix is stripped here too. A tail shorter
    // than the prefix is malformed-but-tolerated (trace.py split
    // semantics): flag left set, data untouched.
    if ((m.flags & kFlagTraceCtx) && m.data.size() >= kTraceCtxBytes) {
      for (int i = 0; i < 8; ++i) {
        m.trace_id |= uint64_t(m.data[i]) << (8 * i);
        m.trace_span_id |= uint64_t(m.data[8 + i]) << (8 * i);
      }
      m.data.erase(m.data.begin(), m.data.begin() + kTraceCtxBytes);
      m.flags &= ~kFlagTraceCtx;
    }
    return m;
  }

 private:
  enum class Phase { kHeader, kFields, kTrace, kData, kPayload, kDone };

  // Read toward `want` total bytes of the current phase (got_ tracks
  // progress); dst must point at the next unwritten byte.
  Status fill(int fd, uint8_t* dst, size_t want) {
    while (got_ < want) {
      ssize_t r = ::recv(fd, dst, want - got_, MSG_DONTWAIT);
      if (r < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) return Status::kNeedMore;
        if (errno == EINTR) continue;
        throw ProtocolError(std::string("recv failed: ") + strerror(errno));
      }
      if (r == 0) {
        if (phase_ == Phase::kHeader && got_ == 0) return Status::kClosed;
        throw ProtocolError("peer closed mid-message");
      }
      got_ += size_t(r);
      dst += size_t(r);
    }
    got_ = 0;
    return Status::kComplete;
  }

  void on_header(const DataRouter&) {
    if (std::memcmp(header_, kMagic, 4) != 0)
      throw ProtocolError("bad magic");
    if (header_[4] != kVersion) throw ProtocolError("unsupported version");
    plen_ = 0;
    for (int i = 0; i < 4; ++i)
      plen_ |= uint64_t(header_[8 + i]) << (8 * i);
    if (plen_ > kMaxPayload)
      throw ProtocolError("advertised payload too large");
    size_t ffix = SIZE_MAX;
    try {
      ffix = fixed_fields_size(MsgType(header_[5]));
    } catch (const ProtocolError&) {
      ffix = SIZE_MAX;  // unknown type: consume the frame, throw in take()
    }
    if (ffix != SIZE_MAX && ffix <= sizeof(fields_) && plen_ >= ffix) {
      ffix_ = ffix;
      if (ffix == 0) {
        // No field bytes to read (e.g. STATUS): decode straight away.
        // The router is irrelevant here — bulk-routed types all carry
        // fixed fields.
        on_fields(nullptr);
      } else {
        phase_ = Phase::kFields;
      }
    } else {
      // Variable-width (string) schema or unknown type: assemble the
      // whole payload and decode in take() (unpack copies the data out,
      // so the buffer is free for the next frame).
      payload_.resize(plen_);
      phase_ = plen_ ? Phase::kPayload : Phase::kDone;
    }
  }

  void on_fields(const DataRouter& router) {
    msg_ = unpack_fields(header_, fields_, ffix_);
    fields_parsed_ = true;
    n_data_ = plen_ - ffix_;
    if ((msg_.flags & kFlagTraceCtx) && n_data_ >= kTraceCtxBytes) {
      // The data tail leads with a trace context: read it apart from
      // the payload (see the kTrace arm). A tail shorter than the
      // prefix is malformed-but-tolerated: flag kept, ordinary path.
      phase_ = Phase::kTrace;
      return;
    }
    begin_data(router);
  }

  // Route the (post-trace-prefix) payload: zero-copy sink when the
  // router accepts, Message::data otherwise.
  void begin_data(const DataRouter& router) {
    if (n_data_ == 0) {
      phase_ = Phase::kDone;
      return;
    }
    uint8_t* sink = nullptr;
    if (router) {
      try {
        sink = router(msg_, n_data_);
      } catch (...) {
        sink = nullptr;  // routing is best-effort; the handler raises
      }
    }
    if (sink != nullptr) {
      data_dst_ = sink;
      msg_.data_landed = true;  // payload lands at its destination
    } else {
      msg_.data.resize(n_data_);
      data_dst_ = msg_.data.data();
    }
    phase_ = Phase::kData;
  }

  Phase phase_ = Phase::kHeader;
  uint8_t header_[kHeaderSize] = {};
  uint8_t fields_[64] = {};
  uint8_t trace_buf_[kTraceCtxBytes] = {};
  size_t got_ = 0;
  size_t ffix_ = 0;
  uint64_t plen_ = 0;
  size_t n_data_ = 0;
  uint8_t* data_dst_ = nullptr;
  bool fields_parsed_ = false;
  Message msg_;
  std::vector<uint8_t> payload_;
};

inline int dial(const std::string& host, int port) {
  struct addrinfo hints = {};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  if (getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints, &res))
    throw ProtocolError("resolve failed for " + host);
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0 || ::connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    freeaddrinfo(res);
    if (fd >= 0) ::close(fd);
    throw ProtocolError("connect failed to " + host + ":" +
                        std::to_string(port));
  }
  freeaddrinfo(res);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // Large buffers so 8 MiB pipelined chunks stream without window
  // stalls (kernel may clamp; best effort).
  int buf = 4 << 20;
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
  return fd;
}

}  // namespace ocm
