// Wire protocol for the oncilla-tpu control plane, C++ side.
//
// Byte-for-byte identical to oncilla_tpu/runtime/protocol.py (the executable
// spec): frame = "OCM1" | version u8 | type u8 | flags u16 | payload_len u32,
// all little-endian, strings u16-length-prefixed UTF-8, raw data trailing.
// The reference shipped raw C structs over TCP with no versioning
// (its src/mem.c:63-88); this replaces that scheme.

#pragma once

#include <cstdint>
#include <cstring>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

namespace ocm {

constexpr char kMagic[4] = {'O', 'C', 'M', '1'};
// v2: owners field on DISCONNECT/HEARTBEAT, RECLAIM_APP (protocol.py).
constexpr uint8_t kVersion = 2;
constexpr size_t kHeaderSize = 12;
constexpr uint64_t kMaxPayload = 64ull << 20;

// Header-flag bits (protocol.py FLAG_*). The v2 frame always carried a
// u16 flags word; capabilities ride it without a version bump. This
// daemon implements exactly the data-plane + observability subset below
// — every other capability bit (replica, qos, fabric) is declined by
// silence: the CONNECT_CONFIRM echo masks to kCapsImplemented, so an
// offer the daemon does not serve comes back 0 and the client stays on
// the plain v2 protocol (pinned by the declined-by-silence tests).
constexpr uint16_t kFlagMore = 0x0001;         // non-final coalesced PUT chunk
constexpr uint16_t kFlagCapCoalesce = 0x0002;  // CONNECT offer/echo
// Distributed-trace propagation (obs/trace.py): the offer/echo dance at
// CONNECT; once granted, a request may carry kFlagTraceCtx — its data
// tail starts with a 16-byte (trace_id u64 | span_id u64) prefix that
// is NOT payload. The frame reader strips it generically (net.hh) and
// the daemon's serve spans join the client's trace.
constexpr uint16_t kFlagCapTrace = 0x0004;
constexpr uint16_t kFlagTraceCtx = 0x0008;
constexpr uint16_t kCapsImplemented = kFlagCapCoalesce | kFlagCapTrace;
constexpr size_t kTraceCtxBytes = 16;

enum class MsgType : uint8_t {
  CONNECT = 1,
  CONNECT_CONFIRM = 2,
  DISCONNECT = 3,
  ADD_NODE = 10,
  ADD_NODE_OK = 11,
  REQ_ALLOC = 12,
  ALLOC_PLACED = 13,
  DO_ALLOC = 14,
  DO_ALLOC_OK = 15,
  REQ_FREE = 16,
  DO_FREE = 17,
  FREE_OK = 18,
  ALLOC_RESULT = 19,
  NOTE_FREE = 20,
  NOTE_ALLOC = 21,
  RECLAIM_APP = 22,
  RECLAIM_APP_OK = 23,
  DATA_PUT = 30,
  DATA_PUT_OK = 31,
  DATA_GET = 32,
  DATA_GET_OK = 33,
  HEARTBEAT = 40,
  HEARTBEAT_OK = 41,
  STATUS = 42,
  STATUS_OK = 43,
  // In-band observability (obs/): Prometheus text exposition and the
  // JSONL journal dump, served over the ordinary control port so no
  // extra listener exists (protocol.py twin).
  STATUS_PROM = 44,
  STATUS_PROM_OK = 45,
  STATUS_EVENTS = 46,
  STATUS_EVENTS_OK = 47,
  // Cross-process device plane: the SPMD controller registers its plane
  // endpoint (PLANE_SERVE); daemons relay device-kind data ops to it as
  // PLANE_PUT/PLANE_GET enriched with the registry extent (replies reuse
  // DATA_PUT_OK / DATA_GET_OK).
  PLANE_SERVE = 50,
  PLANE_SERVE_OK = 51,
  PLANE_PUT = 52,
  PLANE_GET = 53,
  PLANE_SCRUB = 54,
  ERR = 99,
};

enum class ErrCode : uint32_t {
  UNKNOWN = 0,
  OOM = 1,
  BAD_ALLOC_ID = 2,
  BOUNDS = 3,
  BAD_MSG = 4,
  PLACEMENT = 5,
  NOT_MASTER = 6,
};

// Wire kind tags (protocol.py WIRE_KIND).
enum class Kind : uint8_t {
  LOCAL_HOST = 0,
  LOCAL_DEVICE = 1,
  REMOTE_DEVICE = 2,
  REMOTE_HOST = 3,
};

inline bool kind_is_host(Kind k) {
  return k == Kind::LOCAL_HOST || k == Kind::REMOTE_HOST;
}

struct ProtocolError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// A well-framed message of a TYPE this build predates (e.g. the elastic
// membership family): the payload was fully consumed, so the stream is
// still in sync — the serve loop answers a typed BAD_MSG and keeps the
// connection, which is how this daemon declines whole message families
// by silence.
struct UnknownMsgError : ProtocolError {
  using ProtocolError::ProtocolError;
};

// A field value: integers (stored as u64 two's complement), doubles, strings.
struct Value {
  enum class Tag { I64, U64, F64, STR } tag = Tag::U64;
  int64_t i64 = 0;
  uint64_t u64 = 0;
  double f64 = 0.0;
  std::string str;

  static Value I(int64_t v) { Value x; x.tag = Tag::I64; x.i64 = v; return x; }
  static Value U(uint64_t v) { Value x; x.tag = Tag::U64; x.u64 = v; return x; }
  static Value D(double v) { Value x; x.tag = Tag::F64; x.f64 = v; return x; }
  static Value S(std::string v) {
    Value x; x.tag = Tag::STR; x.str = std::move(v); return x;
  }
};

struct Message {
  MsgType type;
  std::map<std::string, Value> fields;
  std::vector<uint8_t> data;
  // Header-flag bits, preserved by the codec both directions (senders
  // pack them, receivers expose them; unknown bits are tolerated).
  uint16_t flags = 0;
  // NOT a wire field: set by the receive path when the bulk payload was
  // routed STRAIGHT into its destination (the arena extent) instead of
  // Message::data — the zero-copy DATA_PUT landing. Handlers must skip
  // their own copy (and trust data.size() == 0) when this is set.
  bool data_landed = false;
  // NOT wire fields: the inbound trace context, filled by the frame
  // reader when it strips a kFlagTraceCtx prefix off the data tail
  // (trace_id == 0 means "untraced request"). The flag bit is cleared
  // once stripped, so handlers always see payload-only data.
  uint64_t trace_id = 0;
  uint64_t trace_span_id = 0;

  int64_t i(const std::string& k) const { return fields.at(k).i64; }
  uint64_t u(const std::string& k) const { return fields.at(k).u64; }
  const std::string& s(const std::string& k) const { return fields.at(k).str; }
};

// Schema: field name + struct char ('q' i64, 'Q' u64, 'I' u32, 'B' u8,
// 'd' f64, 's' string) in wire order — mirrors protocol.py _SCHEMAS.
struct Field { const char* name; char fmt; };

const std::vector<Field>& schema(MsgType t);

std::vector<uint8_t> pack(const Message& m);
// Header + encoded fields ONLY (the frame length still counts m.data):
// the bulk-data fast path sends [prefix, m.data] as one scatter-gather
// write instead of copying the payload into a contiguous frame.
std::vector<uint8_t> pack_prefix(const Message& m);
Message unpack(const uint8_t* header, const uint8_t* payload, size_t plen);
// Encoded size of a type's fields when the schema is fixed-width
// (SIZE_MAX when it contains strings): lets recv_msg receive a bulk
// payload's trailing data STRAIGHT into Message::data.
size_t fixed_fields_size(MsgType t);
// Parse fields from an exactly-flen buffer; Message::data left empty.
Message unpack_fields(const uint8_t* header, const uint8_t* fields,
                      size_t flen);

}  // namespace ocm
