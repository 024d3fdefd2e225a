// Native observability: the C++ twin of oncilla_tpu/obs/ — a bounded
// journal ring (journal.py), a CRC-framed flight-recorder segment
// writer emitting EXACTLY the on-disk format obs/flightrec.py reads
// (magic "OCMJ" | version u8; per frame: payload_len u32 | crc32 u32 |
// JSON payload), per-op span statistics, and a Prometheus text
// renderer whose output passes the same format checker as
// obs/prom.py's.
//
// The contracts are on-wire and on-disk, not in-code: no Python-side
// consumer needs a new format. `python -m oncilla_tpu.obs audit`
// merges native-written segments into the cluster timeline purely by
// reading files; STATUS_EVENTS ships the ring as JSONL; STATUS_PROM
// ships the exposition text — all three byte-compatible with what the
// Python daemon produces.
//
// Threading: every mutable structure here has its own mutex; record()
// is called from the epoll loop, the worker pool, and control threads
// concurrently (the TSan suite runs exactly that mix). The journal
// lock orders ring appends; the flight-recorder lock orders file
// writes; neither is ever held while the other's user code runs
// except journal -> flightrec (append after ring insert), a fixed
// one-way order that cannot cycle.

#pragma once

#include <cstdint>
#include <cstdio>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace ocm {

// CRC32 (IEEE 802.3 polynomial, zlib-compatible) shared by the
// snapshot v2 trailer (daemon.cc) and the flight-recorder framing.
uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n);

namespace obs {

std::string json_escape(const std::string& s);

// Incremental JSON-object member builder: `Fields().u("nbytes", n)
// .s("op", op).str()` yields `"nbytes":5,"op":"put"` — the extra
// members Journal::record splices into the common envelope.
class Fields {
 public:
  Fields& i(const char* k, int64_t v);
  Fields& u(const char* k, uint64_t v);
  Fields& d(const char* k, double v);
  Fields& s(const char* k, const std::string& v);
  Fields& b(const char* k, bool v);
  const std::string& str() const { return buf_; }

 private:
  void key(const char* k);
  std::string buf_;
};

// Wall clock (seconds since the epoch — what exporters align processes
// on) and the monotonic clock (in-process ordering / latency math).
double wall_s();
double mono_s();

// Label the calling thread for journal records ("evloop", "worker-2",
// ...); unnamed threads report "native".
void set_thread_name(const std::string& name);

// -- flight recorder (flightrec.py twin) --------------------------------

class FlightRec {
 public:
  // Reads OCM_FLIGHTREC / OCM_FLIGHTREC_SEG_BYTES /
  // OCM_FLIGHTREC_MAX_SEGS once at construction.
  explicit FlightRec(const std::string& jid);

  bool configured() const { return !dir_.empty(); }

  // Stream one JSON record into the current segment (rotating past the
  // size bound, deleting this writer's oldest segment past the
  // OCM_FLIGHTREC_MAX_SEGS count). Never throws: a failing spill
  // counts failures and disarms after a few — the recorder must not
  // take down the plane it observes.
  void append(const std::string& payload);

  // Write `payloads` whole into a fresh labelled segment (the
  // kill-time ring flush); fsynced. Streamed duplicates dedup away at
  // merge time via each record's (jid, seq).
  void dump(const std::vector<std::string>& payloads,
            const std::string& label);

  // fsync the open segment (graceful-shutdown courtesy).
  void flush();

 private:
  FILE* open_segment_locked(const std::string& label);
  void rotate_locked();

  std::string jid_;
  std::string dir_;
  size_t seg_bytes_ = 4 << 20;
  size_t max_segs_ = 0;  // 0 = unbounded
  std::mutex mu_;
  FILE* fh_ = nullptr;
  size_t written_ = 0;
  int seg_seq_ = 0;
  int failures_ = 0;
  std::deque<std::string> own_segs_;  // creation order, oldest first
};

// -- journal ring (journal.py twin) -------------------------------------

class Journal {
 public:
  Journal();

  bool enabled() const { return enabled_; }
  const std::string& jid() const { return jid_; }
  bool flightrec_configured() { return flightrec_.configured(); }

  // Append one event (no-op when journaling is off). `extra` is the
  // Fields-built member fragment; the envelope (ev/ts/mono/pid/tid/
  // thread/track/jid/seq) is added here.
  void record(const char* ev, const std::string& track,
              const std::string& extra);

  size_t size();
  // Ring snapshot as JSONL (oldest first) — the STATUS_EVENTS body.
  std::string dump_jsonl();
  // Flush the current ring to a labelled flight-recorder segment (the
  // kill path's black-box flush; safe to call unconfigured).
  void spill_ring(const std::string& label);
  void flush() { flightrec_.flush(); }

 private:
  std::string jid_;
  bool enabled_ = false;
  size_t cap_ = 8192;
  std::mutex mu_;
  uint64_t seq_ = 0;
  std::deque<std::string> ring_;
  FlightRec flightrec_;
};

// -- per-op span statistics (utils/debug.py Tracer subset) --------------

struct OpSnap {
  uint64_t count = 0;
  double total_s = 0.0;
  uint64_t total_bytes = 0;
  double p50_s = 0.0;
  double p99_s = 0.0;
};

class OpStatsBook {
 public:
  void note(const std::string& op, double dt_s, uint64_t nbytes);
  std::map<std::string, OpSnap> snapshot() const;

 private:
  struct Rec {
    uint64_t count = 0;
    double total_s = 0.0;
    uint64_t total_bytes = 0;
    std::deque<double> samples;  // capped ring for p50/p99
  };
  mutable std::mutex mu_;
  std::map<std::string, Rec> stats_;
};

// Collision-unlikely 64-bit id (span ids; 0 means "absent").
uint64_t rand_id();

// -- Prometheus text exposition (obs/prom.py twin) ----------------------

// Accumulates samples per family and renders one HELP line, one TYPE
// line, then ALL the family's samples consecutively — the text format
// (0.0.4) forbids interleaving, so grouping is deferred to render.
class PromDoc {
 public:
  using Labels = std::vector<std::pair<std::string, std::string>>;
  void sample(const std::string& family, const char* kind,
              const char* help, double value, const Labels& labels);
  std::string text() const;

 private:
  struct Fam {
    std::string kind, help;
    std::vector<std::string> samples;
  };
  std::vector<std::string> order_;
  std::map<std::string, Fam> fams_;
};

std::string prom_num(double v);

}  // namespace obs
}  // namespace ocm
