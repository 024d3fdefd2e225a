// Cluster membership shared by the daemon and the C client library:
// NodeEntry + nodefile parsing (struct node_entry / parse_nodefile analogue,
// the reference's inc/nodefile.h:19-27, src/nodefile.c:30-37) — mirrors
// oncilla_tpu/runtime/membership.py.

#pragma once

#include <algorithm>
#include <fstream>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace ocm {

struct NodeEntry {
  int64_t rank;
  std::string host;  // DNS name (self-rank detection / logs)
  int port;
  std::string addr;  // connect address column; empty for short-form lines
  // Address peers connect to: the nodefile's addr column when present,
  // else the (possibly ADD_NODE-updated) host. Matches the Python
  // NodeEntry.connect_host contract so mixed Python/C++ clusters route
  // peers identically.
  const std::string& caddr() const { return addr.empty() ? host : addr; }
};

// Accepts "rank host port", "rank host ip port", and the reference's
// "rank host ip ocm_port rdmacm_port" (src/nodefile.c:30-37); the trailing
// per-fabric port is ignored (the TPU data plane is connectionless).
inline std::vector<NodeEntry> parse_nodefile(const std::string& path) {
  std::ifstream f(path);
  if (!f) throw std::runtime_error("cannot open nodefile " + path);
  std::vector<NodeEntry> entries;
  std::string line;
  while (std::getline(f, line)) {
    auto hash = line.find('#');
    if (hash != std::string::npos) line = line.substr(0, hash);
    std::istringstream ss(line);
    std::vector<std::string> tok;
    std::string t;
    while (ss >> t) tok.push_back(t);
    if (tok.empty()) continue;
    NodeEntry e;
    try {
      if (tok.size() == 3) {
        e = {std::stoll(tok[0]), tok[1], std::stoi(tok[2]), ""};
      } else if (tok.size() == 4 || tok.size() == 5) {
        e = {std::stoll(tok[0]), tok[1], std::stoi(tok[3]), tok[2]};
      } else {
        throw std::runtime_error("nodefile line has " +
                                 std::to_string(tok.size()) + " fields");
      }
    } catch (const std::logic_error&) {  // stoi/stoll invalid or overflow
      throw std::runtime_error("bad nodefile line: " + line);
    }
    entries.push_back(e);
  }
  std::sort(entries.begin(), entries.end(),
            [](auto& a, auto& b) { return a.rank < b.rank; });
  for (size_t i = 0; i < entries.size(); ++i)
    if (entries[i].rank != int64_t(i))
      throw std::runtime_error("nodefile ranks must be contiguous from 0");
  return entries;
}

}  // namespace ocm
