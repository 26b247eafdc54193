// One greedy sweep of Louvain's first phase (graph/community.py), host code.
//
// Built by g++ -O2 -std=c++17 -fPIC -shared -ffp-contract=off
// (ops/_nvcc.py GXX_FLAGS) and called through ctypes.  It computes the plain
// sweep's float64 arithmetic in the same order, so the labels are byte-equal:
//   - the weights from v to each neighbouring community (self-loop left out)
//     are summed in CSR order, starting from 0.0, as np.bincount sums them;
//   - a gain is w_to - k_v * tot / m2, evaluated left to right, no FMA;
//   - the best community is the first maximum in ascending community id, as
//     np.unique then np.argmax pick it;
//   - v moves when gain > stay + 1e-12;
//   - v leaves its community (tot -= k_v) only after the early continue for
//     a node whose only edge is its self-loop, and rejoins (tot += k_v)
//     whether or not it moved.
// The visit order (perm) is drawn by the caller from numpy's generator.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" int64_t louvain_sweep(int64_t n, const int64_t* indptr, const int64_t* indices,
                                 const double* data, const double* k,
                                 const double* self_loops, int64_t* comm, double* comm_tot,
                                 double m2, const int64_t* perm) {
  std::vector<double> w_to(static_cast<size_t>(n), 0.0);
  std::vector<char> seen(static_cast<size_t>(n), 0);
  std::vector<int64_t> touched;
  int64_t moved = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t v = perm[i];
    const int64_t cv = comm[v];
    const int64_t lo = indptr[v], hi = indptr[v + 1];
    bool any_other = false;
    for (int64_t e = lo; e < hi; ++e) {
      if (indices[e] != v) {
        any_other = true;
        break;
      }
    }
    if (!any_other && k[v] == self_loops[v]) continue;
    const double kv = k[v];
    comm_tot[cv] -= kv;
    touched.clear();
    for (int64_t e = lo; e < hi; ++e) {
      const int64_t u = indices[e];
      if (u == v) continue;
      const int64_t c = comm[u];
      if (!seen[c]) {
        seen[c] = 1;
        touched.push_back(c);
      }
      w_to[c] += data[e];
    }
    std::sort(touched.begin(), touched.end());
    bool have_cv = false;
    double stay = 0.0;
    int64_t best = -1;
    double best_gain = 0.0;
    for (int64_t c : touched) {
      const double gain = w_to[c] - kv * comm_tot[c] / m2;
      if (c == cv) {
        have_cv = true;
        stay = gain;
      }
      if (best < 0 || gain > best_gain) {
        best = c;
        best_gain = gain;
      }
      w_to[c] = 0.0;
      seen[c] = 0;
    }
    if (!have_cv) stay = -kv * comm_tot[cv] / m2;
    if (best >= 0 && best_gain > stay + 1e-12) {
      comm[v] = best;
      ++moved;
    }
    comm_tot[comm[v]] += kv;
  }
  return moved;
}
