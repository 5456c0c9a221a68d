// mwerSegmenter-style resegmentation DP, C++ core.
//
// Splits a hypothesis token stream into |refs| contiguous segments
// minimising the summed word edit distance to the reference segments
// (the segmentation protocol behind StreamLAAL).  The pure-Python DP in
// eval/latency.py is O(R * H^2 * len) and unusable at full-TED-talk scale;
// this implementation is exact and fast enough for talk-length streams,
// and is loaded via ctypes (no pybind11 dependency in this image).
//
// Tokens are passed as integer ids (the Python side interns strings).
//
// Build: g++ -O2 -shared -fPIC -o libmwer.so mwer.cpp
//   (done lazily by infinisst_tpu_torch/native/__init__.py, into
//   build/native/ at the repository root)

#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// edit distance between hyp[a, b) and ref tokens, with a row buffer
int edit_distance(const int32_t* hyp, int a, int b, const int32_t* ref,
                  int ref_len, std::vector<int>& prev,
                  std::vector<int>& cur) {
  int h = b - a;
  prev.resize(h + 1);
  cur.resize(h + 1);
  for (int i = 0; i <= h; ++i) prev[i] = i;
  for (int j = 1; j <= ref_len; ++j) {
    cur[0] = j;
    int32_t rw = ref[j - 1];
    for (int i = 1; i <= h; ++i) {
      int sub = prev[i - 1] + (hyp[a + i - 1] == rw ? 0 : 1);
      int del = prev[i] + 1;
      int ins = cur[i - 1] + 1;
      int m = sub < del ? sub : del;
      cur[i] = m < ins ? m : ins;
    }
    prev.swap(cur);
  }
  return prev[h];
}

}  // namespace

extern "C" {

// hyp: H token ids.  refs: concatenated token ids with ref_offsets (R+1
// prefix offsets).  out_bounds: R exclusive end indices.  band: half-width
// of the search band around the proportional boundary estimate (pass <= 0
// for the exact full search).  Returns total edit cost, or -1 on error.
int64_t mwer_segment(const int32_t* hyp, int H, const int32_t* refs,
                     const int32_t* ref_offsets, int R, int band,
                     int32_t* out_bounds) {
  if (R <= 0) return -1;
  const int64_t INF = std::numeric_limits<int64_t>::max() / 4;

  // cumulative reference lengths for proportional band centres
  std::vector<int> ref_len(R);
  int total_ref = 0;
  for (int r = 0; r < R; ++r) {
    ref_len[r] = ref_offsets[r + 1] - ref_offsets[r];
    total_ref += ref_len[r];
  }
  if (total_ref == 0) total_ref = 1;

  // candidate boundary sets per r (boundary after segment r): banded around
  // the proportional position; r == R-1 is pinned to H.
  auto lo_of = [&](int r) {
    if (band <= 0) return 0;
    int64_t centre = 0;
    int acc = 0;
    for (int k = 0; k <= r; ++k) acc += ref_len[k];
    centre = (int64_t)H * acc / total_ref;
    int lo = (int)centre - band;
    return lo < 0 ? 0 : lo;
  };
  auto hi_of = [&](int r) {
    if (band <= 0) return H;
    int64_t centre = 0;
    int acc = 0;
    for (int k = 0; k <= r; ++k) acc += ref_len[k];
    centre = (int64_t)H * acc / total_ref;
    int hi = (int)centre + band;
    return hi > H ? H : hi;
  };

  // dp over boundaries: dp[b] = min cost of hyp[:b] against refs[:r]
  std::vector<int64_t> dp(H + 1, INF), ndp(H + 1, INF);
  std::vector<int32_t> back((int64_t)(R + 1) * (H + 1), 0);
  dp[0] = 0;
  std::vector<int> prev_buf, cur_buf;

  for (int r = 1; r <= R; ++r) {
    std::fill(ndp.begin(), ndp.end(), INF);
    int b_lo = (r == R) ? H : lo_of(r - 1);
    int b_hi = (r == R) ? H : hi_of(r - 1);
    int a_lo = (r == 1) ? 0 : lo_of(r - 2);
    int a_hi = (r == 1) ? 0 : hi_of(r - 2);
    const int32_t* ref = refs + ref_offsets[r - 1];
    int rl = ref_len[r - 1];
    for (int b = b_lo; b <= b_hi; ++b) {
      int64_t best = INF;
      int32_t arg = a_lo;
      for (int a = a_lo; a <= a_hi && a <= b; ++a) {
        if (dp[a] >= INF) continue;
        int64_t c = dp[a] + edit_distance(hyp, a, b, ref, rl, prev_buf,
                                          cur_buf);
        if (c < best) {
          best = c;
          arg = a;
        }
      }
      ndp[b] = best;
      back[(int64_t)r * (H + 1) + b] = arg;
    }
    dp.swap(ndp);
  }

  if (dp[H] >= INF) return -1;
  int b = H;
  for (int r = R; r >= 1; --r) {
    out_bounds[r - 1] = b;
    b = back[(int64_t)r * (H + 1) + b];
  }
  return dp[H];
}

}  // extern "C"
