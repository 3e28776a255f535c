// Interval-set retransmission tally — the native counterpart of the
// reference's only core C++ component (ref:
// src/main/host/descriptor/tcp_retransmit_tally.{cc,h}): tracks
// sacked / retransmitted / marked-lost sequence ranges as sorted,
// coalesced [begin, end) interval vectors and computes the lost
// ranges below the recovery point (RACK-style: lost = in
// [snd_una, recovery_point), not sacked, given >= 3 duplicate acks —
// ref: tcp_retransmit_tally.h:52-76 kDuplAckLostThresh).
//
// Exposed through a C ABI (ref: the retransmit_tally_* wrappers,
// tcp_retransmit_tally.h:29-50) and consumed from Python via ctypes
// (shadow_tpu/native/tally.py). The device TCP engine keeps a reduced
// 3-range advertised-list scoreboard on-chip (net/tcp.py sack_l/r +
// sack_clip_len); this native tally is its full-fidelity
// differential-validation ORACLE: tests/test_tally_oracle.py drives
// both with the same heavy-loss packet streams and asserts the
// device's retransmit decisions match the interval-set computation.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

using Range = std::pair<int64_t, int64_t>;  // [begin, end)
using Ranges = std::vector<Range>;

constexpr int kDuplAckLostThresh = 3;  // ref: tcp_retransmit_tally.h

// insert [b, e) keeping the vector sorted and coalesced
void insert_range(Ranges* rs, int64_t b, int64_t e) {
  if (b >= e) return;
  Ranges out;
  out.reserve(rs->size() + 1);
  bool placed = false;
  for (const Range& r : *rs) {
    if (r.second < b) {
      out.push_back(r);
    } else if (e < r.first) {
      if (!placed) {
        out.emplace_back(b, e);
        placed = true;
      }
      out.push_back(r);
    } else {  // overlap/adjacent: merge into the pending range
      b = std::min(b, r.first);
      e = std::max(e, r.second);
    }
  }
  if (!placed) out.emplace_back(b, e);
  std::sort(out.begin(), out.end());
  *rs = std::move(out);
}

// remove everything below `seq` (cumulative ACK advance)
void trim_below(Ranges* rs, int64_t seq) {
  Ranges out;
  for (const Range& r : *rs) {
    if (r.second <= seq) continue;
    out.emplace_back(std::max(r.first, seq), r.second);
  }
  *rs = std::move(out);
}

bool contains(const Ranges& rs, int64_t b, int64_t e) {
  for (const Range& r : rs)
    if (r.first <= b && e <= r.second) return true;
  return false;
}

struct Tally {
  int64_t snd_una = 0;
  int64_t recovery_point = -1;
  int num_dupl_acks = 0;
  Ranges sacked;
  Ranges retransmitted;
  Ranges marked_lost;  // explicit (timeout) loss marks
};

// lost = [snd_una, recovery_point) minus sacked, when the dup-ack
// threshold has been reached or loss was marked explicitly
// (ref: tcp_retransmit_tally.cc compute_lost)
void compute_lost(const Tally& t, Ranges* lost) {
  lost->clear();
  for (const Range& r : t.marked_lost)
    insert_range(lost, r.first, r.second);
  if (t.recovery_point >= 0 && t.num_dupl_acks >= kDuplAckLostThresh) {
    int64_t cur = t.snd_una;
    int64_t end = t.recovery_point;
    for (const Range& s : t.sacked) {
      if (s.second <= cur) continue;
      if (s.first >= end) break;
      if (s.first > cur) insert_range(lost, cur, std::min(s.first, end));
      cur = std::max(cur, s.second);
      if (cur >= end) break;
    }
    if (cur < end) insert_range(lost, cur, end);
  }
  // sacked bytes are never lost (explicit timeout marks can cover
  // them: ref compute_lost subtracts sacked_ from marked_lost_), and
  // never report retransmitted-and-not-again-lost ranges
  auto subtract = [lost](const Ranges& minus) {
    for (const Range& r : minus) {
      Ranges out;
      for (const Range& l : *lost) {
        if (l.second <= r.first || r.second <= l.first) {
          out.push_back(l);
          continue;
        }
        if (l.first < r.first) out.emplace_back(l.first, r.first);
        if (r.second < l.second) out.emplace_back(r.second, l.second);
      }
      *lost = std::move(out);
    }
  };
  subtract(t.sacked);
  subtract(t.retransmitted);
}

}  // namespace

extern "C" {

void* retransmit_tally_new(int64_t snd_una) {
  Tally* t = new Tally();
  t->snd_una = snd_una;
  return t;
}

void retransmit_tally_free(void* p) { delete static_cast<Tally*>(p); }

void retransmit_tally_sacked(void* p, int64_t begin, int64_t end) {
  insert_range(&static_cast<Tally*>(p)->sacked, begin, end);
}

void retransmit_tally_retransmitted(void* p, int64_t begin, int64_t end) {
  insert_range(&static_cast<Tally*>(p)->retransmitted, begin, end);
}

void retransmit_tally_mark_lost(void* p, int64_t begin, int64_t end) {
  insert_range(&static_cast<Tally*>(p)->marked_lost, begin, end);
}

void retransmit_tally_dupl_ack(void* p) {
  static_cast<Tally*>(p)->num_dupl_acks++;
}

void retransmit_tally_set_recovery_point(void* p, int64_t seq) {
  static_cast<Tally*>(p)->recovery_point = seq;
}

// cumulative ACK advance: drop state below snd_una, reset dup-acks
void retransmit_tally_advance(void* p, int64_t snd_una) {
  Tally* t = static_cast<Tally*>(p);
  if (snd_una <= t->snd_una) {
    t->num_dupl_acks++;
    return;
  }
  t->snd_una = snd_una;
  t->num_dupl_acks = 0;
  trim_below(&t->sacked, snd_una);
  trim_below(&t->retransmitted, snd_una);
  trim_below(&t->marked_lost, snd_una);
  if (t->recovery_point >= 0 && snd_una >= t->recovery_point)
    t->recovery_point = -1;
}

int retransmit_tally_is_sacked(void* p, int64_t begin, int64_t end) {
  return contains(static_cast<Tally*>(p)->sacked, begin, end) ? 1 : 0;
}

// fills out_begins/out_ends (capacity `cap`), returns count
// (ref: retransmit_tally_populate_lost_ranges)
int retransmit_tally_lost_ranges(void* p, int64_t* out_begins,
                                 int64_t* out_ends, int cap) {
  Ranges lost;
  compute_lost(*static_cast<Tally*>(p), &lost);
  int n = 0;
  for (const Range& r : lost) {
    if (n >= cap) break;
    out_begins[n] = r.first;
    out_ends[n] = r.second;
    n++;
  }
  return n;
}

int64_t retransmit_tally_sacked_bytes(void* p) {
  int64_t total = 0;
  for (const Range& r : static_cast<Tally*>(p)->sacked)
    total += r.second - r.first;
  return total;
}

}  // extern "C"
