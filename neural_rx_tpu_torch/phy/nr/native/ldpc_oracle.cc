// Independent GF(2) QC-LDPC encoder oracle.
//
// Cross-checks the structured encoder (phy/nr/ldpc.py): instead of
// the spec's special-column/staircase trick, this solves the 4Z x 4Z
// core-parity system generically by bitset Gaussian elimination over
// GF(2), directly from the lifted base-graph edge list. Any valid shift
// table works (no two-equal-shifts assumption), so an agreement test
// between the two encoders validates both the table plumbing and the
// structured solve. Plain C ABI for ctypes (pybind11 not in the image).
//
// Convention matches the python side: a base-graph edge (r, c, s) adds
// block equation  sum_c P_s x_c = 0  with (P_s x)[i] = x[(i + s) mod Z]
// (i.e. roll(x, -s)).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Solve A x = b over GF(2). A: n x n bit matrix as row bitsets.
// Returns false if singular.
bool gf2_solve(std::vector<std::vector<uint64_t>>& a,
               std::vector<uint8_t>& b, int n, std::vector<uint8_t>& x) {
  const int words = (n + 63) / 64;
  std::vector<int> where(n, -1);
  int row = 0;
  for (int col = 0; col < n && row < n; ++col) {
    int piv = -1;
    for (int r = row; r < n; ++r) {
      if ((a[r][col / 64] >> (col % 64)) & 1u) { piv = r; break; }
    }
    if (piv < 0) continue;
    std::swap(a[piv], a[row]);
    std::swap(b[piv], b[row]);
    for (int r = 0; r < n; ++r) {
      if (r != row && ((a[r][col / 64] >> (col % 64)) & 1u)) {
        for (int w = 0; w < words; ++w) a[r][w] ^= a[row][w];
        b[r] ^= b[row];
      }
    }
    where[col] = row;
    ++row;
  }
  for (int col = 0; col < n; ++col) {
    if (where[col] < 0) return false;  // singular
    x[col] = b[where[col]];
  }
  return true;
}

}  // namespace

extern "C" {

// info:  [k_b * z] bits (0/1). out: [num_cols * z] bits.
// Edge arrays: er/ec/es of length n_edges (row, col, shift-mod-z).
// Returns 0 on success, -1 if the core system is singular.
int ldpc_encode_oracle(int num_rows, int num_cols, int k_b, int z,
                       int n_edges, const int32_t* er, const int32_t* ec,
                       const int32_t* es, const uint8_t* info,
                       uint8_t* out) {
  const int n_core = 4 * z;
  // lam[r*z + i] = sum over info-edges of core row r
  std::vector<uint8_t> lam(n_core, 0);
  // core parity columns k_b..k_b+3: A[(r*z + i)][(c-k_b)*z + j]
  const int words = (n_core + 63) / 64;
  std::vector<std::vector<uint64_t>> A(n_core,
                                       std::vector<uint64_t>(words, 0));
  for (int e = 0; e < n_edges; ++e) {
    const int r = er[e], c = ec[e], s = es[e];
    if (r >= 4) continue;
    if (c < k_b) {
      for (int i = 0; i < z; ++i)
        lam[r * z + i] ^= info[c * z + (i + s) % z];
    } else if (c < k_b + 4) {
      for (int i = 0; i < z; ++i) {
        const int col = (c - k_b) * z + (i + s) % z;
        A[r * z + i][col / 64] ^= (1ull << (col % 64));
      }
    }
  }
  std::vector<uint8_t> p(n_core, 0);
  if (!gf2_solve(A, lam, n_core, p)) return -1;

  std::memcpy(out, info, (size_t)k_b * z);
  std::memcpy(out + (size_t)k_b * z, p.data(), n_core);

  // extension rows r >= 4: out[ext_col] = sum of info/core terms
  // (each extension column is degree-1; its own edge has shift s_e,
  // giving P_{s_e} p_ext = rhs -> p_ext[i] = rhs[(i - s_e) mod z]).
  for (int r = 4; r < num_rows; ++r) {
    std::vector<uint8_t> rhs(z, 0);
    int ext_col = -1, ext_shift = 0;
    for (int e = 0; e < n_edges; ++e) {
      if (er[e] != r) continue;
      const int c = ec[e], s = es[e];
      if (c >= k_b + 4 + (r - 4)) { ext_col = c; ext_shift = s; continue; }
      for (int i = 0; i < z; ++i)
        rhs[i] ^= out[(size_t)c * z + (i + s) % z];
    }
    if (ext_col < 0) return -2;
    // P_{s_e} p_ext = rhs  =>  p_ext[(i + s_e) mod z] = rhs[i]
    for (int i = 0; i < z; ++i)
      out[(size_t)ext_col * z + (i + ext_shift) % z] = rhs[i];
  }
  return 0;
}

}  // extern "C"
