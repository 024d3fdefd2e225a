#include "protocol.hh"

namespace ocm {
namespace {

const std::vector<Field> kEmpty{};

const std::map<MsgType, std::vector<Field>>& schemas() {
  static const std::map<MsgType, std::vector<Field>> kSchemas = {
      {MsgType::CONNECT, {{"pid", 'q'}, {"rank", 'q'}}},
      {MsgType::CONNECT_CONFIRM, {{"rank", 'q'}, {"nnodes", 'q'}}},
      {MsgType::DISCONNECT, {{"pid", 'q'}, {"owners", 's'}}},
      {MsgType::ADD_NODE,
       {{"rank", 'q'},
        {"host", 's'},
        {"port", 'I'},
        {"ndevices", 'I'},
        {"device_arena_bytes", 'Q'},
        {"host_arena_bytes", 'Q'}}},
      {MsgType::ADD_NODE_OK, {{"nnodes", 'q'}}},
      {MsgType::REQ_ALLOC,
       {{"orig_rank", 'q'}, {"pid", 'q'}, {"kind", 'B'}, {"nbytes", 'Q'}}},
      {MsgType::ALLOC_PLACED,
       {{"rank", 'q'}, {"device_index", 'I'}, {"kind", 'B'}}},
      {MsgType::DO_ALLOC,
       {{"orig_rank", 'q'},
        {"pid", 'q'},
        {"kind", 'B'},
        {"device_index", 'I'},
        {"nbytes", 'Q'}}},
      {MsgType::DO_ALLOC_OK, {{"alloc_id", 'Q'}, {"offset", 'Q'}}},
      {MsgType::REQ_FREE, {{"alloc_id", 'Q'}, {"rank", 'q'}}},
      {MsgType::ALLOC_RESULT,
       {{"alloc_id", 'Q'},
        {"rank", 'q'},
        {"device_index", 'I'},
        {"kind", 'B'},
        {"offset", 'Q'},
        {"nbytes", 'Q'},
        {"owner_host", 's'},
        {"owner_port", 'I'}}},
      {MsgType::NOTE_FREE,
       {{"kind", 'B'}, {"rank", 'q'}, {"device_index", 'I'}, {"nbytes", 'Q'}}},
      {MsgType::NOTE_ALLOC,
       {{"kind", 'B'}, {"rank", 'q'}, {"device_index", 'I'}, {"nbytes", 'Q'}}},
      {MsgType::DO_FREE, {{"alloc_id", 'Q'}}},
      {MsgType::FREE_OK, {{"alloc_id", 'Q'}}},
      {MsgType::RECLAIM_APP, {{"pid", 'q'}, {"rank", 'q'}}},
      {MsgType::RECLAIM_APP_OK, {{"count", 'Q'}}},
      {MsgType::DATA_PUT, {{"alloc_id", 'Q'}, {"offset", 'Q'}, {"nbytes", 'Q'}}},
      {MsgType::DATA_PUT_OK, {{"nbytes", 'Q'}}},
      {MsgType::DATA_GET, {{"alloc_id", 'Q'}, {"offset", 'Q'}, {"nbytes", 'Q'}}},
      {MsgType::DATA_GET_OK, {{"nbytes", 'Q'}}},
      {MsgType::HEARTBEAT, {{"rank", 'q'}, {"pid", 'q'}, {"owners", 's'}}},
      {MsgType::HEARTBEAT_OK, {{"lease_s", 'd'}}},
      {MsgType::STATUS, {}},
      {MsgType::STATUS_PROM, {}},
      {MsgType::STATUS_PROM_OK, {{"rank", 'q'}}},
      {MsgType::STATUS_EVENTS, {}},
      {MsgType::STATUS_EVENTS_OK, {{"rank", 'q'}, {"count", 'Q'}}},
      {MsgType::STATUS_OK,
       {{"rank", 'q'},
        {"nnodes", 'q'},
        {"live_allocs", 'Q'},
        {"host_bytes_live", 'Q'},
        {"device_bytes_live", 'Q'}}},
      {MsgType::PLANE_SERVE, {{"host", 's'}, {"port", 'I'}, {"relay", 'B'}}},
      {MsgType::PLANE_SERVE_OK, {{"port", 'I'}}},
      {MsgType::PLANE_PUT,
       {{"alloc_id", 'Q'},
        {"rank", 'q'},
        {"device_index", 'I'},
        {"ext_offset", 'Q'},
        {"ext_nbytes", 'Q'},
        {"offset", 'Q'},
        {"nbytes", 'Q'}}},
      {MsgType::PLANE_GET,
       {{"alloc_id", 'Q'},
        {"rank", 'q'},
        {"device_index", 'I'},
        {"ext_offset", 'Q'},
        {"ext_nbytes", 'Q'},
        {"offset", 'Q'},
        {"nbytes", 'Q'}}},
      {MsgType::PLANE_SCRUB,
       {{"alloc_id", 'Q'},
        {"rank", 'q'},
        {"device_index", 'I'},
        {"ext_offset", 'Q'},
        {"ext_nbytes", 'Q'}}},
      {MsgType::ERR, {{"code", 'I'}, {"detail", 's'}}},
  };
  return kSchemas;
}

void put_le(std::vector<uint8_t>& out, uint64_t v, int nbytes) {
  for (int i = 0; i < nbytes; ++i) out.push_back((v >> (8 * i)) & 0xff);
}

uint64_t get_le(const uint8_t* p, int nbytes) {
  uint64_t v = 0;
  for (int i = 0; i < nbytes; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

}  // namespace

const std::vector<Field>& schema(MsgType t) {
  auto it = schemas().find(t);
  if (it == schemas().end())
    throw UnknownMsgError("no schema for message type " +
                          std::to_string(unsigned(t)));
  return it->second;
}

namespace {

std::vector<uint8_t> encode_fields(const Message& m) {
  std::vector<uint8_t> payload;
  for (const Field& f : schema(m.type)) {
    auto it = m.fields.find(f.name);
    if (it == m.fields.end())
      throw ProtocolError(std::string("missing field ") + f.name);
    const Value& v = it->second;
    switch (f.fmt) {
      case 'q': put_le(payload, uint64_t(v.i64), 8); break;
      case 'Q': put_le(payload, v.u64, 8); break;
      case 'I': put_le(payload, v.u64, 4); break;
      case 'B': put_le(payload, v.u64, 1); break;
      case 'd': {
        uint64_t bits;
        static_assert(sizeof(double) == 8, "double must be 8 bytes");
        std::memcpy(&bits, &v.f64, 8);
        put_le(payload, bits, 8);
        break;
      }
      case 's': {
        if (v.str.size() > 0xffff) throw ProtocolError("string too long");
        put_le(payload, v.str.size(), 2);
        payload.insert(payload.end(), v.str.begin(), v.str.end());
        break;
      }
      default: throw ProtocolError("bad schema fmt");
    }
  }
  return payload;
}

}  // namespace

std::vector<uint8_t> pack_prefix(const Message& m) {
  std::vector<uint8_t> fields = encode_fields(m);
  size_t plen = fields.size() + m.data.size();
  if (plen > kMaxPayload) throw ProtocolError("payload exceeds cap");
  std::vector<uint8_t> out;
  out.reserve(kHeaderSize + fields.size());
  out.insert(out.end(), kMagic, kMagic + 4);
  out.push_back(kVersion);
  out.push_back(uint8_t(m.type));
  put_le(out, m.flags, 2);
  put_le(out, plen, 4);
  out.insert(out.end(), fields.begin(), fields.end());
  return out;
}

std::vector<uint8_t> pack(const Message& m) {
  std::vector<uint8_t> out = pack_prefix(m);
  out.insert(out.end(), m.data.begin(), m.data.end());
  return out;
}

namespace {

// Parses fields per the schema; returns the offset where data starts.
size_t parse_fields(const std::vector<Field>& sch, const uint8_t* payload,
                    size_t plen, Message& m) {
  size_t off = 0;
  auto need = [&](size_t n) {
    if (off + n > plen) throw ProtocolError("truncated payload");
  };
  for (const Field& f : sch) {
    switch (f.fmt) {
      case 'q':
        need(8);
        m.fields[f.name] = Value::I(int64_t(get_le(payload + off, 8)));
        off += 8;
        break;
      case 'Q':
        need(8);
        m.fields[f.name] = Value::U(get_le(payload + off, 8));
        off += 8;
        break;
      case 'I':
        need(4);
        m.fields[f.name] = Value::U(get_le(payload + off, 4));
        off += 4;
        break;
      case 'B':
        need(1);
        m.fields[f.name] = Value::U(get_le(payload + off, 1));
        off += 1;
        break;
      case 'd': {
        need(8);
        uint64_t bits = get_le(payload + off, 8);
        double d;
        std::memcpy(&d, &bits, 8);
        m.fields[f.name] = Value::D(d);
        off += 8;
        break;
      }
      case 's': {
        need(2);
        size_t n = get_le(payload + off, 2);
        off += 2;
        need(n);
        m.fields[f.name] =
            Value::S(std::string(payload + off, payload + off + n));
        off += n;
        break;
      }
    }
  }
  return off;
}

void check_header(const uint8_t* header) {
  if (std::memcmp(header, kMagic, 4) != 0) throw ProtocolError("bad magic");
  if (header[4] != kVersion) throw ProtocolError("unsupported version");
}

}  // namespace

Message unpack(const uint8_t* header, const uint8_t* payload, size_t plen) {
  check_header(header);
  uint64_t want = get_le(header + 8, 4);
  if (want != plen) throw ProtocolError("length mismatch");

  Message m;
  m.type = MsgType(header[5]);
  m.flags = uint16_t(get_le(header + 6, 2));
  const std::vector<Field>& sch = schema(m.type);  // throws on unknown type
  size_t off = parse_fields(sch, payload, plen, m);
  m.data.assign(payload + off, payload + plen);
  return m;
}

size_t fixed_fields_size(MsgType t) {
  size_t n = 0;
  for (const Field& f : schema(t)) {  // throws on unknown type
    switch (f.fmt) {
      case 'q': case 'Q': case 'd': n += 8; break;
      case 'I': n += 4; break;
      case 'B': n += 1; break;
      default: return SIZE_MAX;  // variable-width (strings)
    }
  }
  return n;
}

Message unpack_fields(const uint8_t* header, const uint8_t* fields,
                      size_t flen) {
  check_header(header);
  Message m;
  m.type = MsgType(header[5]);
  m.flags = uint16_t(get_le(header + 6, 2));
  size_t off = parse_fields(schema(m.type), fields, flen, m);
  if (off != flen) throw ProtocolError("trailing bytes in field prefix");
  return m;
}

}  // namespace ocm
