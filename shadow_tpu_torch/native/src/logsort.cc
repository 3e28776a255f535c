// Log-record time sorter — the native counterpart of the reference's
// logger helper thread (ref: logger_helper.c:50-66: merge/sort
// buffered LogRecords by sim time before writing). The Python
// SimLogger falls back to list.sort(); at heavy log volume this
// stable (time, seq) argsort over parallel arrays is the hot path.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// stable argsort of (times[i], seqs[i]); writes permutation into out
void logsort_argsort(const int64_t* times, const int64_t* seqs, int64_t n,
                     int64_t* out) {
  std::vector<int64_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  std::stable_sort(idx.begin(), idx.end(),
                   [&](int64_t a, int64_t b) {
                     if (times[a] != times[b]) return times[a] < times[b];
                     return seqs[a] < seqs[b];
                   });
  std::copy(idx.begin(), idx.end(), out);
}

}  // extern "C"
