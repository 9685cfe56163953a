// Native runtime components (C++17, C ABI for ctypes).
//
// TPU-native equivalents of the reference's C++ runtime pieces that sit
// AROUND the device compute path (the compute itself is JAX/XLA):
//
// 1. EuRoC ground-truth CSV loader — replaces the CSV parsing in
//    vins_estimator/src/utility/horizon_generator.cpp:169-196
//    (csviterator.h) and benchmark_publisher_node.cpp:33-52. Parses the
//    17-column state CSV (ns timestamp, p, q, v, bg, ba) at fread speed.
//
// 2. Measurement aligner — replaces estimator_node's buffered
//    getMeasurements() pairing of IMU batches with feature frames
//    (estimator_node.cpp:100-141): a ring buffer of IMU samples, aligned
//    per frame timestamp with boundary interpolation of a virtual sample
//    at the frame time (matching :120-139 semantics).
//
// 3. Batched Hamming matcher — replaces the DBoW2/DVision descriptor
//    search loops (pose_graph/src/ThirdParty, keyframe.cpp:200-258) with a
//    popcount kernel over packed 256-bit descriptors.
//
// Build: g++ -O3 -march=native -shared -fPIC avm_native.cc -o libavm_native.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1. EuRoC CSV loader
// ---------------------------------------------------------------------------

// Parses `path`; writes up to max_rows rows of 17 doubles (t_seconds, p[3],
// q[4], v[3], bg[3], ba[3]) into out (row-major). Returns rows parsed, or
// -1 on open failure. Timestamps are rebased to the first row.
int avm_load_euroc_csv(const char* path, double* out, int max_rows) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  int rows = 0;
  long long ns0 = -1;
  while (rows < max_rows && fgets(line, sizeof(line), f)) {
    if (line[0] == '#' || line[0] == '\n') continue;
    // timestamp: parse as integer ns to keep full precision (19 digits
    // exceed double's mantissa); rebase before converting to seconds
    char* p = line;
    char* end = nullptr;
    long long ns = strtoll(p, &end, 10);
    if (end == p) continue;
    p = end;
    while (*p == ',' || *p == ' ') ++p;
    double v[16];
    int k = 0;
    while (k < 16 && *p) {
      v[k] = strtod(p, &end);
      if (end == p) break;
      ++k;
      p = end;
      while (*p == ',' || *p == ' ') ++p;
    }
    if (k < 16) continue;
    if (ns0 < 0) ns0 = ns;
    double* row = out + 17 * rows;
    row[0] = static_cast<double>(ns - ns0) * 1e-9;
    for (int i = 1; i < 17; ++i) row[i] = v[i - 1];
    ++rows;
  }
  fclose(f);
  return rows;
}

// ---------------------------------------------------------------------------
// 2. Measurement aligner (IMU ring buffer + per-frame batch extraction)
// ---------------------------------------------------------------------------

struct Aligner {
  std::deque<double> t;              // sample times
  std::deque<double> acc, gyr;       // interleaved xyz (3 per sample)
  double last_frame_t = -1.0;
};

void* avm_aligner_create() { return new Aligner(); }
void avm_aligner_destroy(void* h) { delete static_cast<Aligner*>(h); }

void avm_aligner_push_imu(void* h, double t, const double* a,
                          const double* w) {
  auto* al = static_cast<Aligner*>(h);
  al->t.push_back(t);
  for (int i = 0; i < 3; ++i) al->acc.push_back(a[i]);
  for (int i = 0; i < 3; ++i) al->gyr.push_back(w[i]);
}

// Extract the IMU batch for a frame at time ft (+ optional td offset):
// all samples in (last_frame_t, ft], plus a linearly interpolated virtual
// sample AT ft (estimator_node.cpp:120-139). Writes dts[n], acc[n*3],
// gyr[n*3], and the pre-interval boundary sample acc0/gyr0.
// Returns n (or -1 if not enough data yet: need a sample beyond ft).
int avm_aligner_frame_batch(void* h, double ft, double* dts, double* acc,
                            double* gyr, double* acc0, double* gyr0,
                            int max_n) {
  auto* al = static_cast<Aligner*>(h);
  if (al->t.empty() || al->t.back() < ft) return -1;  // wait for more IMU

  // drop samples at/before the previous frame time, keeping one boundary
  // sample before the interval start for interpolation/acc0
  double start = al->last_frame_t;
  while (al->t.size() >= 2 && al->t[1] <= start) {
    al->t.pop_front();
    for (int i = 0; i < 3; ++i) al->acc.pop_front();
    for (int i = 0; i < 3; ++i) al->gyr.pop_front();
  }

  // boundary sample (interpolated at `start` if start sits between samples)
  double a_prev[3], w_prev[3], t_prev;
  {
    t_prev = al->t[0];
    for (int i = 0; i < 3; ++i) a_prev[i] = al->acc[i];
    for (int i = 0; i < 3; ++i) w_prev[i] = al->gyr[i];
    if (start > t_prev && al->t.size() >= 2 && al->t[1] > start) {
      double t1 = al->t[1];
      double u = (start - t_prev) / (t1 - t_prev);
      for (int i = 0; i < 3; ++i) {
        a_prev[i] = (1 - u) * al->acc[i] + u * al->acc[3 + i];
        w_prev[i] = (1 - u) * al->gyr[i] + u * al->gyr[3 + i];
      }
      t_prev = start;
    }
  }
  for (int i = 0; i < 3; ++i) acc0[i] = a_prev[i];
  for (int i = 0; i < 3; ++i) gyr0[i] = w_prev[i];

  int n = 0;
  size_t k = 0;
  // find first sample strictly after t_prev
  while (k < al->t.size() && al->t[k] <= t_prev) ++k;
  for (; k < al->t.size() && n < max_n; ++k) {
    double tk = al->t[k];
    if (tk >= ft) break;
    dts[n] = tk - t_prev;
    for (int i = 0; i < 3; ++i) acc[3 * n + i] = al->acc[3 * k + i];
    for (int i = 0; i < 3; ++i) gyr[3 * n + i] = al->gyr[3 * k + i];
    t_prev = tk;
    ++n;
  }
  // virtual interpolated sample at ft (:128-139)
  if (n < max_n && k < al->t.size() && al->t[k] >= ft && ft > t_prev) {
    double t1 = al->t[k];
    double tk0 = k ? al->t[k - 1] : t_prev;
    double u = (t1 - tk0) > 1e-12 ? (ft - tk0) / (t1 - tk0) : 0.0;
    for (int i = 0; i < 3; ++i) {
      double a0 = k ? al->acc[3 * (k - 1) + i] : a_prev[i];
      double w0 = k ? al->gyr[3 * (k - 1) + i] : w_prev[i];
      acc[3 * n + i] = (1 - u) * a0 + u * al->acc[3 * k + i];
      gyr[3 * n + i] = (1 - u) * w0 + u * al->gyr[3 * k + i];
    }
    dts[n] = ft - t_prev;
    ++n;
  }
  al->last_frame_t = ft;
  return n;
}

// ---------------------------------------------------------------------------
// 3. Batched Hamming matcher (256-bit packed descriptors)
// ---------------------------------------------------------------------------

// d1: [n1][4] uint64, d2: [n2][4] uint64; out: [n1][n2] int32 distances.
void avm_hamming_all_pairs(const uint64_t* d1, int n1, const uint64_t* d2,
                           int n2, int32_t* out) {
  for (int i = 0; i < n1; ++i) {
    const uint64_t* a = d1 + 4 * i;
    for (int j = 0; j < n2; ++j) {
      const uint64_t* b = d2 + 4 * j;
      int32_t d = 0;
      for (int w = 0; w < 4; ++w) d += __builtin_popcountll(a[w] ^ b[w]);
      out[i * n2 + j] = d;
    }
  }
}

// Best match per row with ratio/threshold gating (keyframe.cpp:200-230:
// best < 80 Hamming). Writes idx[n1] (or -1) and dist[n1].
void avm_hamming_best(const uint64_t* d1, int n1, const uint64_t* d2, int n2,
                      int32_t max_dist, int32_t* idx, int32_t* dist) {
  for (int i = 0; i < n1; ++i) {
    const uint64_t* a = d1 + 4 * i;
    int32_t best = 0x7fffffff, bj = -1;
    for (int j = 0; j < n2; ++j) {
      const uint64_t* b = d2 + 4 * j;
      int32_t d = 0;
      for (int w = 0; w < 4; ++w) d += __builtin_popcountll(a[w] ^ b[w]);
      if (d < best) { best = d; bj = j; }
    }
    idx[i] = (best <= max_dist) ? bj : -1;
    dist[i] = best;
  }
}

}  // extern "C"
