#include "obs.hh"

#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cinttypes>
#include <cstdlib>
#include <cstring>
#include <random>

namespace ocm {

uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
  static const auto table = [] {
    std::array<uint32_t, 256> t{};
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
    return t;
  }();
  crc ^= 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

namespace obs {
namespace {

// mkdir -p for the flight-recorder directory (OCM_FLIGHTREC may name a
// nested path that nothing created yet; flightrec.py does makedirs).
void mkdirs(const std::string& path) {
  std::string cur;
  for (size_t i = 0; i <= path.size(); ++i) {
    if (i == path.size() || path[i] == '/') {
      if (!cur.empty()) ::mkdir(cur.c_str(), 0777);
      if (i < path.size()) cur += '/';
      continue;
    }
    cur += path[i];
  }
}

std::string env_str(const char* name) {
  const char* v = getenv(name);
  return v ? std::string(v) : std::string();
}

std::atomic<int> g_tid_counter{0};
thread_local int t_tid = 0;
thread_local std::string t_thread_name;

int this_tid() {
  if (t_tid == 0) t_tid = ++g_tid_counter;
  return t_tid;
}

}  // namespace

std::string json_escape(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (unsigned char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += char(c);
        }
    }
  }
  return out;
}

void Fields::key(const char* k) {
  if (!buf_.empty()) buf_ += ',';
  buf_ += '"';
  buf_ += k;
  buf_ += "\":";
}

Fields& Fields::i(const char* k, int64_t v) {
  key(k);
  char buf[32];
  std::snprintf(buf, sizeof(buf), "%" PRId64, v);
  buf_ += buf;
  return *this;
}

Fields& Fields::u(const char* k, uint64_t v) {
  key(k);
  char buf[32];
  std::snprintf(buf, sizeof(buf), "%" PRIu64, v);
  buf_ += buf;
  return *this;
}

Fields& Fields::d(const char* k, double v) {
  key(k);
  char buf[48];
  std::snprintf(buf, sizeof(buf), "%.6f", v);
  buf_ += buf;
  return *this;
}

Fields& Fields::s(const char* k, const std::string& v) {
  key(k);
  buf_ += '"';
  buf_ += json_escape(v);
  buf_ += '"';
  return *this;
}

Fields& Fields::b(const char* k, bool v) {
  key(k);
  buf_ += v ? "true" : "false";
  return *this;
}

double wall_s() {
  return std::chrono::duration<double>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

double mono_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

void set_thread_name(const std::string& name) { t_thread_name = name; }

uint64_t rand_id() {
  static std::mutex mu;
  static std::mt19937_64 rng(std::random_device{}() ^
                             uint64_t(::getpid()) << 32 ^
                             uint64_t(std::chrono::steady_clock::now()
                                          .time_since_epoch()
                                          .count()));
  std::lock_guard<std::mutex> g(mu);
  uint64_t v = rng();
  return v ? v : 1;  // 0 means "absent" on the wire
}

// -- FlightRec ----------------------------------------------------------

FlightRec::FlightRec(const std::string& jid) : jid_(jid) {
  dir_ = env_str("OCM_FLIGHTREC");
  std::string sb = env_str("OCM_FLIGHTREC_SEG_BYTES");
  if (!sb.empty()) {
    long v = std::atol(sb.c_str());
    if (v > 0) seg_bytes_ = size_t(v);
  }
  std::string ms = env_str("OCM_FLIGHTREC_MAX_SEGS");
  if (!ms.empty()) {
    long v = std::atol(ms.c_str());
    if (v > 0) max_segs_ = size_t(v);
  }
}

FILE* FlightRec::open_segment_locked(const std::string& label) {
  ++seg_seq_;
  char name[256];
  if (label.empty()) {
    std::snprintf(name, sizeof(name), "fr-%s-%05d.seg", jid_.c_str(),
                  seg_seq_);
  } else {
    std::snprintf(name, sizeof(name), "fr-%s-%s-%05d.seg", jid_.c_str(),
                  label.c_str(), seg_seq_);
  }
  mkdirs(dir_);
  std::string path = dir_ + "/" + name;
  FILE* fh = std::fopen(path.c_str(), "wb");
  if (fh == nullptr) return nullptr;
  static const uint8_t hdr[5] = {'O', 'C', 'M', 'J', 1};
  if (std::fwrite(hdr, 1, sizeof(hdr), fh) != sizeof(hdr)) {
    std::fclose(fh);
    return nullptr;
  }
  own_segs_.push_back(path);
  rotate_locked();
  return fh;
}

void FlightRec::rotate_locked() {
  // OCM_FLIGHTREC_MAX_SEGS bounds THIS writer's on-disk footprint (a
  // long soak used to grow the directory without bound): oldest own
  // segment goes first, other processes' evidence is never touched.
  if (max_segs_ == 0) return;
  while (own_segs_.size() > max_segs_) {
    ::unlink(own_segs_.front().c_str());
    own_segs_.pop_front();
  }
}

void FlightRec::append(const std::string& payload) {
  if (dir_.empty()) return;
  uint8_t frame[8];
  uint32_t len = uint32_t(payload.size());
  uint32_t crc = crc32_update(
      0, reinterpret_cast<const uint8_t*>(payload.data()), payload.size());
  for (int i = 0; i < 4; ++i) frame[i] = (len >> (8 * i)) & 0xff;
  for (int i = 0; i < 4; ++i) frame[4 + i] = (crc >> (8 * i)) & 0xff;
  std::lock_guard<std::mutex> g(mu_);
  if (failures_ >= 8) return;  // disarmed: a full disk must not wedge
  if (fh_ == nullptr) {
    fh_ = open_segment_locked("");
    if (fh_ == nullptr) {
      ++failures_;
      return;
    }
    written_ = 5;
  }
  bool ok = std::fwrite(frame, 1, sizeof(frame), fh_) == sizeof(frame) &&
            std::fwrite(payload.data(), 1, payload.size(), fh_) ==
                payload.size() &&
            std::fflush(fh_) == 0;
  if (!ok) {
    ++failures_;
    std::fclose(fh_);
    fh_ = nullptr;
    return;
  }
  failures_ = 0;
  written_ += sizeof(frame) + payload.size();
  if (written_ >= seg_bytes_) {
    std::fclose(fh_);
    fh_ = nullptr;
  }
}

void FlightRec::dump(const std::vector<std::string>& payloads,
                     const std::string& label) {
  if (dir_.empty() || payloads.empty()) return;
  std::lock_guard<std::mutex> g(mu_);
  FILE* fh = open_segment_locked(label);
  if (fh == nullptr) return;
  for (const std::string& p : payloads) {
    uint8_t frame[8];
    uint32_t len = uint32_t(p.size());
    uint32_t crc = crc32_update(
        0, reinterpret_cast<const uint8_t*>(p.data()), p.size());
    for (int i = 0; i < 4; ++i) frame[i] = (len >> (8 * i)) & 0xff;
    for (int i = 0; i < 4; ++i) frame[4 + i] = (crc >> (8 * i)) & 0xff;
    if (std::fwrite(frame, 1, sizeof(frame), fh) != sizeof(frame) ||
        std::fwrite(p.data(), 1, p.size(), fh) != p.size())
      break;
  }
  std::fflush(fh);
  ::fsync(fileno(fh));
  std::fclose(fh);
}

void FlightRec::flush() {
  std::lock_guard<std::mutex> g(mu_);
  if (fh_ != nullptr) {
    std::fflush(fh_);
    ::fsync(fileno(fh_));
  }
}

// -- Journal ------------------------------------------------------------

namespace {

std::string make_jid() {
  char buf[64];
  std::snprintf(buf, sizeof(buf), "%x-%08x", unsigned(::getpid()),
                unsigned(rand_id() & 0xffffffffu));
  return buf;
}

}  // namespace

Journal::Journal() : jid_(make_jid()), flightrec_(jid_) {
  // OCM_FLIGHTREC alone is a complete opt-in (journal.py): a flight
  // recorder that also required OCM_EVENTS=1 would record nothing.
  std::string ev = env_str("OCM_EVENTS");
  enabled_ = (!ev.empty() && ev != "0") || flightrec_.configured();
  std::string cap = env_str("OCM_EVENTS_CAP");
  if (!cap.empty()) {
    long v = std::atol(cap.c_str());
    if (v > 0) cap_ = size_t(v);
  }
}

void Journal::record(const char* ev, const std::string& track,
                     const std::string& extra) {
  if (!enabled_) return;
  std::string thread =
      t_thread_name.empty() ? std::string("native") : t_thread_name;
  Fields head;
  head.s("ev", ev).d("ts", wall_s()).d("mono", mono_s());
  head.i("pid", int64_t(::getpid())).i("tid", this_tid()).s("thread", thread);
  std::string rec;
  {
    std::lock_guard<std::mutex> g(mu_);
    ++seq_;
    Fields tail;
    tail.s("track", track).s("jid", jid_).u("seq", seq_);
    rec = "{" + head.str() + (extra.empty() ? "" : "," + extra) + "," +
          tail.str() + "}";
    ring_.push_back(rec);
    while (ring_.size() > cap_) ring_.pop_front();
  }
  // Spill OUTSIDE the ring lock (journal.py discipline): the recorder
  // has its own lock, and a slow disk must never serialize hot-path
  // record() callers behind the ring.
  flightrec_.append(rec);
}

size_t Journal::size() {
  std::lock_guard<std::mutex> g(mu_);
  return ring_.size();
}

std::string Journal::dump_jsonl() {
  std::lock_guard<std::mutex> g(mu_);
  std::string out;
  for (const std::string& r : ring_) {
    out += r;
    out += '\n';
  }
  return out;
}

void Journal::spill_ring(const std::string& label) {
  if (!flightrec_.configured()) return;
  std::vector<std::string> evts;
  {
    std::lock_guard<std::mutex> g(mu_);
    evts.assign(ring_.begin(), ring_.end());
  }
  flightrec_.dump(evts, label);
}

// -- OpStatsBook --------------------------------------------------------

void OpStatsBook::note(const std::string& op, double dt_s,
                       uint64_t nbytes) {
  std::lock_guard<std::mutex> g(mu_);
  Rec& r = stats_[op];
  r.count += 1;
  r.total_s += dt_s;
  r.total_bytes += nbytes;
  r.samples.push_back(dt_s);
  while (r.samples.size() > 2048) r.samples.pop_front();
}

std::map<std::string, OpSnap> OpStatsBook::snapshot() const {
  std::lock_guard<std::mutex> g(mu_);
  std::map<std::string, OpSnap> out;
  for (const auto& kv : stats_) {
    OpSnap s;
    s.count = kv.second.count;
    s.total_s = kv.second.total_s;
    s.total_bytes = kv.second.total_bytes;
    if (!kv.second.samples.empty()) {
      std::vector<double> sorted(kv.second.samples.begin(),
                                 kv.second.samples.end());
      std::sort(sorted.begin(), sorted.end());
      s.p50_s = sorted[sorted.size() / 2];
      size_t i99 = std::min(size_t(double(sorted.size()) * 0.99),
                            sorted.size() - 1);
      s.p99_s = sorted[i99];
    }
    out[kv.first] = s;
  }
  return out;
}

// -- PromDoc ------------------------------------------------------------

std::string prom_num(double v) {
  if (v == int64_t(v) && v >= -9.2e18 && v <= 9.2e18) {
    char buf[32];
    std::snprintf(buf, sizeof(buf), "%" PRId64, int64_t(v));
    return buf;
  }
  char buf[48];
  std::snprintf(buf, sizeof(buf), "%.12g", v);
  return buf;
}

namespace {

std::string label_escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    if (c == '\\') out += "\\\\";
    else if (c == '"') out += "\\\"";
    else if (c == '\n') out += "\\n";
    else out += c;
  }
  return out;
}

}  // namespace

void PromDoc::sample(const std::string& family, const char* kind,
                     const char* help, double value, const Labels& labels) {
  auto it = fams_.find(family);
  if (it == fams_.end()) {
    order_.push_back(family);
    it = fams_.emplace(family, Fam{kind, help, {}}).first;
  }
  std::string line = family + "{";
  bool first = true;
  for (const auto& kv : labels) {
    if (!first) line += ',';
    first = false;
    line += kv.first + "=\"" + label_escape(kv.second) + "\"";
  }
  line += "} " + prom_num(value);
  it->second.samples.push_back(line);
}

std::string PromDoc::text() const {
  std::string out;
  for (const std::string& family : order_) {
    const Fam& f = fams_.at(family);
    out += "# HELP " + family + " " + f.help + "\n";
    out += "# TYPE " + family + " " + f.kind + "\n";
    for (const std::string& s : f.samples) out += s + "\n";
  }
  return out;
}

}  // namespace obs
}  // namespace ocm
