// First-fit coalescing arena suballocator — C++ twin of
// oncilla_tpu/core/arena.py (same semantics, same error behavior).
//
// Concurrency contract the epoll data plane leans on: alloc()/release()
// are serialized by the internal mutex, and the daemon scrubs an
// extent's bytes BEFORE release() returns the offset to the free book.
// A zero-copy DATA_PUT landing (the event loop writing a recycled
// extent's bytes) can therefore only begin after the allocating
// request observed the insert that followed this mutex — the
// release-mutex → alloc-mutex → registry-insert chain is the
// happens-before edge that keeps scrub, re-allocation, and landing
// ordered across the serve threads (and visible to TSan as such).
// Callers must not touch extent bytes outside that discipline.

#pragma once

#include <cstdint>
#include <map>
#include <mutex>
#include <optional>
#include <stdexcept>

namespace ocm {

struct OomError : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct BadHandleError : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct BoundsError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

struct Extent {
  uint64_t offset = 0;
  uint64_t nbytes = 0;  // user-requested size
};

class ArenaAllocator {
 public:
  ArenaAllocator(uint64_t capacity, uint64_t alignment)
      : capacity_(capacity), alignment_(alignment) {
    free_[0] = capacity;
  }

  Extent alloc(uint64_t nbytes) {
    if (nbytes == 0) throw BadHandleError("nbytes must be positive");
    uint64_t need = (nbytes + alignment_ - 1) / alignment_ * alignment_;
    std::lock_guard<std::mutex> g(mu_);
    for (auto it = free_.begin(); it != free_.end(); ++it) {
      if (it->second >= need) {
        uint64_t off = it->first;
        uint64_t span = it->second;
        free_.erase(it);
        if (span > need) free_[off + need] = span - need;
        live_[off] = need;
        ++allocs_;
        return Extent{off, nbytes};
      }
    }
    throw OomError("arena cannot fit " + std::to_string(nbytes) + " B");
  }

  // Claim a specific extent (snapshot restore).
  Extent reserve(uint64_t offset, uint64_t nbytes) {
    if (nbytes == 0) throw BadHandleError("nbytes must be positive");
    if (offset % alignment_) throw BadHandleError("offset not aligned");
    uint64_t need = (nbytes + alignment_ - 1) / alignment_ * alignment_;
    std::lock_guard<std::mutex> g(mu_);
    for (auto it = free_.begin(); it != free_.end(); ++it) {
      uint64_t off = it->first, span = it->second;
      if (off <= offset && offset + need <= off + span) {
        free_.erase(it);
        if (off < offset) free_[off] = offset - off;
        uint64_t tail = (off + span) - (offset + need);
        if (tail) free_[offset + need] = tail;
        live_[offset] = need;
        return Extent{offset, nbytes};
      }
    }
    throw BadHandleError("cannot reserve extent: overlaps live allocation");
  }

  void release(uint64_t offset) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = live_.find(offset);
    if (it == live_.end())
      throw BadHandleError("free of unknown extent at offset " +
                           std::to_string(offset));
    uint64_t span = it->second;
    live_.erase(it);
    insert_free(offset, span);
    ++releases_;
  }

  // Lifetime op counters for the Prometheus exposition
  // (ocm_arena_ops_total): how much churn each arena has absorbed —
  // the occupancy gauges alone cannot distinguish an idle arena from
  // one recycling extents at full tilt.
  uint64_t alloc_count() const {
    std::lock_guard<std::mutex> g(mu_);
    return allocs_;
  }

  uint64_t release_count() const {
    std::lock_guard<std::mutex> g(mu_);
    return releases_;
  }

  uint64_t bytes_live() const {
    std::lock_guard<std::mutex> g(mu_);
    uint64_t t = 0;
    for (auto& kv : live_) t += kv.second;
    return t;
  }

  uint64_t capacity() const { return capacity_; }

 private:
  void insert_free(uint64_t off, uint64_t span) {
    auto next = free_.lower_bound(off);
    // Coalesce with next span.
    if (next != free_.end() && off + span == next->first) {
      span += next->second;
      next = free_.erase(next);
    }
    // Coalesce with previous span.
    if (next != free_.begin()) {
      auto prev = std::prev(next);
      if (prev->first + prev->second == off) {
        prev->second += span;
        return;
      }
    }
    free_[off] = span;
  }

  uint64_t capacity_;
  uint64_t alignment_;
  mutable std::mutex mu_;
  uint64_t allocs_ = 0;
  uint64_t releases_ = 0;
  std::map<uint64_t, uint64_t> free_;  // offset -> span (sorted, coalesced)
  std::map<uint64_t, uint64_t> live_;  // offset -> reserved span
};

}  // namespace ocm
