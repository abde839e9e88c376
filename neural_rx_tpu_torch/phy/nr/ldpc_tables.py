"""5G NR LDPC base graph definitions (38.212 §5.3.2) + lifting.

The port's copy of `neural_rx_tpu/phy/nr/ldpc_tables.py`, in NumPy: the
same base-graph structure, the same CSV loader and validator, and the same
seeded greedy shift search, so the generated tables are the JAX package's.

The two base graphs' *structure* (edge positions, dimensions, the
double-diagonal core-parity layout, lifting-size sets) follows 38.212
Tables 5.3.2-1..3 exactly.

Shift coefficients come from one of two sources, in priority order:

1. **Spec tables** (Table 5.3.2-2 for BG1, 5.3.2-3 for BG2), loaded from
   CSV files ``nr_ldpc_bg{1,2}_shifts.csv`` found in
   ``$NRX_LDPC_TABLE_DIR`` or ``neural_rx_tpu_torch/phy/nr/data/``.
   Format: one line per base-graph edge, ``row,col,V0,V1,...,V7`` (the
   eight V(i,j) values for lifting-set indices i_LS = 0..7). On load the
   tables are validated against the hard spec invariants (exact edge set,
   per-set value range, all-zero double-diagonal staircase and degree-1
   extension columns, the two-equal-shifts property of the weight-3 core
   parity column that the structured encoder relies on); a file failing
   validation is an error, never a silent fallback.

2. **Generated fallback**: a deterministic greedy girth-maximizing search
   per lifting set (minimizing lifted 4-cycles at the set's maximum Z,
   the same design criterion used for the spec tables), seeded with
   ``default_rng(1000 * bg + i_LS)``. The resulting code family is
   structurally identical to 5G NR LDPC (same rates, blocklengths, degree
   profiles, puncturing, HARQ buffer) but is NOT bit-interoperable with a
   transmitter using the true spec shifts. No CSVs ship with the
   repository, so this is the live source; ``spec_tables_active()``
   reports which source is live. The search takes ~2.5 s per BG1 lifting
   set, once per process (``base_graph`` is cached).
"""

from __future__ import annotations

import functools
import os
import pathlib

import numpy as np

# Lifting size sets, Table 5.3.2-1 (set index i_LS -> allowed Z values).
LIFTING_SETS = [
    [2, 4, 8, 16, 32, 64, 128, 256],
    [3, 6, 12, 24, 48, 96, 192, 384],
    [5, 10, 20, 40, 80, 160, 320],
    [7, 14, 28, 56, 112, 224],
    [9, 18, 36, 72, 144, 288],
    [11, 22, 44, 88, 176, 352],
    [13, 26, 52, 104, 208],
    [15, 30, 60, 120, 240],
]

ALL_Z = sorted(z for s in LIFTING_SETS for z in s)


def lifting_set_index(z: int) -> int:
    for i, s in enumerate(LIFTING_SETS):
        if z in s:
            return i
    raise ValueError(f"invalid lifting size {z}")


# Base graph 1: 46 rows x 68 cols, 22 info columns. Edge positions per row
# (38.212 Table 5.3.2-2). Rows 0-3 are the high-density core; rows >= 4
# each add one degree-1 extension parity column (col 26 + row - 4).
BG1_ROWS = [
    [0, 1, 2, 3, 5, 6, 9, 10, 11, 12, 13, 15, 16, 18, 19, 20, 21, 22, 23],
    [0, 2, 3, 4, 5, 7, 8, 9, 11, 12, 14, 15, 16, 17, 19, 21, 22, 23, 24],
    [0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 13, 14, 15, 17, 18, 19, 20, 24, 25],
    [0, 1, 3, 4, 6, 7, 8, 10, 11, 12, 13, 14, 16, 17, 18, 20, 21, 22, 25],
    [0, 1, 26],
    [0, 1, 3, 12, 16, 21, 22, 27],
    [0, 6, 10, 11, 13, 17, 18, 20, 28],
    [0, 1, 4, 7, 8, 14, 29],
    [0, 1, 3, 12, 16, 19, 21, 22, 24, 30],
    [0, 1, 10, 11, 13, 17, 18, 20, 31],
    [1, 2, 4, 7, 8, 14, 32],
    [0, 1, 12, 16, 21, 22, 23, 33],
    [0, 1, 10, 11, 13, 18, 34],
    [0, 3, 7, 20, 23, 35],
    [0, 12, 15, 16, 17, 21, 36],
    [0, 1, 10, 13, 18, 25, 37],
    [1, 3, 11, 20, 22, 38],
    [0, 14, 16, 17, 21, 39],
    [1, 12, 13, 18, 19, 40],
    [0, 1, 7, 8, 10, 41],
    [0, 3, 9, 11, 22, 42],
    [1, 5, 16, 20, 21, 43],
    [0, 12, 13, 17, 44],
    [1, 2, 10, 18, 45],
    [0, 3, 4, 11, 22, 46],
    [1, 6, 7, 14, 47],
    [0, 2, 4, 15, 48],
    [1, 6, 8, 49],
    [0, 4, 19, 21, 50],
    [1, 14, 18, 25, 51],
    [0, 10, 13, 24, 52],
    [1, 7, 22, 25, 53],
    [0, 12, 14, 24, 54],
    [1, 2, 11, 21, 55],
    [0, 7, 15, 17, 56],
    [1, 6, 12, 22, 57],
    [0, 14, 15, 18, 58],
    [1, 13, 23, 59],
    [0, 9, 10, 12, 60],
    [1, 3, 7, 19, 61],
    [0, 8, 17, 62],
    [1, 3, 9, 18, 63],
    [0, 4, 24, 64],
    [1, 16, 18, 25, 65],
    [0, 7, 9, 22, 66],
    [1, 6, 10, 67],
]

# Base graph 2: 42 rows x 52 cols, 10 info columns (Table 5.3.2-3).
BG2_ROWS = [
    [0, 1, 2, 3, 6, 9, 10, 11],
    [0, 3, 4, 5, 6, 7, 8, 9, 11, 12],
    [0, 1, 3, 4, 8, 10, 12, 13],
    [1, 2, 4, 5, 6, 7, 8, 9, 10, 13],
    [0, 1, 11, 14],
    [0, 1, 5, 7, 11, 15],
    [0, 5, 7, 9, 11, 16],
    [1, 5, 7, 11, 13, 17],
    [0, 1, 12, 18],
    [1, 8, 10, 11, 19],
    [0, 1, 6, 7, 20],
    [0, 7, 9, 13, 21],
    [1, 3, 11, 22],
    [0, 1, 8, 13, 23],
    [1, 6, 11, 13, 24],
    [0, 10, 11, 25],
    [1, 9, 11, 12, 26],
    [1, 5, 11, 12, 27],
    [0, 6, 7, 28],
    [0, 1, 10, 29],
    [1, 4, 11, 30],
    [0, 8, 13, 31],
    [1, 2, 32],
    [0, 3, 5, 33],
    [1, 2, 9, 34],
    [0, 5, 35],
    [2, 7, 12, 13, 36],
    [0, 6, 37],
    [1, 2, 5, 38],
    [0, 4, 39],
    [2, 5, 7, 9, 40],
    [1, 13, 41],
    [0, 5, 12, 42],
    [2, 7, 10, 43],
    [0, 12, 13, 44],
    [1, 5, 11, 45],
    [0, 2, 7, 46],
    [10, 13, 47],
    [1, 5, 11, 48],
    [0, 7, 12, 49],
    [2, 10, 13, 50],
    [1, 5, 11, 51],
]

BG_PARAMS = {
    1: dict(rows=BG1_ROWS, num_rows=46, num_cols=68, k_b=22),
    2: dict(rows=BG2_ROWS, num_rows=42, num_cols=52, k_b=10),
}


def _greedy_shifts(rows, num_cols, z_max: int, seed: int) -> dict:
    """Assign a shift to each edge, greedily minimizing lifted 4-cycles.

    A 4-cycle appears in the lifted graph iff for edges (r1,c1),(r1,c2),
    (r2,c2),(r2,c1): (s11 - s12 + s22 - s21) % Z == 0. Assigning edge
    (r, c) creates a cycle with each already-assigned triple
    (r,c2),(r2,c2),(r2,c) exactly when
    s == shifts[r,c2] + shifts[r2,c] - shifts[r2,c2] (mod z_max), so we
    histogram these forbidden values and pick the least-hit shift.
    Smaller Z in the same lifting set folds mod Z (as the spec does).
    """
    rng = np.random.default_rng(seed)
    col_rows: list[list[int]] = [[] for _ in range(num_cols)]
    shifts: dict = {}
    for r, cols in enumerate(rows):
        for c in cols:
            hist = np.zeros(z_max, np.int32)
            for r2 in col_rows[c]:
                for c2 in rows[r]:
                    if c2 == c:
                        continue
                    s_rc2 = shifts.get((r, c2))
                    s_r2c2 = shifts.get((r2, c2))
                    if s_rc2 is None or s_r2c2 is None:
                        continue
                    forbidden = (s_rc2 + shifts[(r2, c)] - s_r2c2) % z_max
                    hist[forbidden] += 1
            best = np.flatnonzero(hist == hist.min())
            shifts[(r, c)] = int(rng.choice(best))
            col_rows[c].append(r)
    return shifts


# Rows carrying the weight-3 "special" core-parity column (col k_b):
# BG1 col 22 appears in rows {0,1,3}; BG2 col 10 in rows {0,2,3}.
SPECIAL_ROWS = {1: (0, 1, 3), 2: (0, 2, 3)}

_SPEC_CSV = {1: "nr_ldpc_bg1_shifts.csv", 2: "nr_ldpc_bg2_shifts.csv"}


def _spec_table_path(bg: int):
    """First existing spec-shift CSV for base graph `bg`, else None."""
    cands = []
    env = os.environ.get("NRX_LDPC_TABLE_DIR")
    if env:
        cands.append(pathlib.Path(env) / _SPEC_CSV[bg])
    cands.append(pathlib.Path(__file__).parent / "data" / _SPEC_CSV[bg])
    for c in cands:
        if c.is_file():
            return c
    return None


def validate_shift_table(bg: int, table: dict) -> None:
    """Check a {(row, col): [V_0..V_7]} table against spec invariants.

    Raises ValueError on the first violation. Invariants (38.212 §5.3.2):
    edge set identical to Table 5.3.2-2/3 structure; 0 <= V(i,j) < max Z
    of lifting set i; double-diagonal staircase and degree-1 extension
    entries all zero; weight-3 special column has two equal shifts per
    set (the property the structured encoder relies on).
    """
    p = BG_PARAMS[bg]
    k_b = p["k_b"]
    want_edges = {(r, c) for r, cols in enumerate(p["rows"]) for c in cols}
    have_edges = set(table.keys())
    if have_edges != want_edges:
        missing = sorted(want_edges - have_edges)[:5]
        extra = sorted(have_edges - want_edges)[:5]
        raise ValueError(
            f"BG{bg} edge set mismatch: missing {missing}, extra {extra}")
    for (r, c), vals in table.items():
        if len(vals) != len(LIFTING_SETS):
            raise ValueError(f"BG{bg} edge ({r},{c}): need 8 values")
        for i, v in enumerate(vals):
            zmax = max(LIFTING_SETS[i])
            if not 0 <= v < zmax:
                raise ValueError(
                    f"BG{bg} edge ({r},{c}) set {i}: V={v} not in [0,{zmax})")
    for i in range(3):  # staircase cols k_b+1..k_b+3, rows (i, i+1)
        for r in (i, i + 1):
            if any(table[(r, k_b + 1 + i)]):
                raise ValueError(f"BG{bg} staircase ({r},{k_b + 1 + i}) != 0")
    for r in range(4, p["num_rows"]):
        if any(table[(r, k_b + r)]):
            raise ValueError(f"BG{bg} extension ({r},{k_b + r}) != 0")
    for i in range(len(LIFTING_SETS)):
        s = [table[(r, k_b)][i] for r in SPECIAL_ROWS[bg]]
        if len(set(s)) == 3:
            raise ValueError(
                f"BG{bg} set {i}: special col shifts {s} all distinct "
                "(spec encoder needs two equal)")


@functools.lru_cache(maxsize=2)
def _load_spec_table(bg: int):
    """Parse + validate the spec CSV for `bg`; None if no file exists."""
    path = _spec_table_path(bg)
    if path is None:
        return None
    table = {}
    for ln, line in enumerate(path.read_text().splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [int(x) for x in line.replace(";", ",").split(",")]
        if len(parts) != 10:
            raise ValueError(f"{path}:{ln}: need row,col,V0..V7")
        table[(parts[0], parts[1])] = parts[2:]
    validate_shift_table(bg, table)
    return table


def spec_tables_active() -> bool:
    """True iff both base graphs run with loaded 38.212 shift tables."""
    return _load_spec_table(1) is not None and _load_spec_table(2) is not None


@functools.lru_cache(maxsize=None)
def base_graph(bg: int, z: int):
    """-> (rows, shifts) for base graph `bg` at lifting size `z`.

    rows: list of per-row column lists; shifts: {(row, col): shift mod z}.

    Shift source: validated spec CSV if present (see module docstring),
    else the generated fallback. Either way the encodable core-parity
    structure holds: the weight-3 special column k_b has two equal shifts
    per lifting set (so summing the four lifted core rows isolates p1
    through a single circulant), and the double-diagonal staircase over
    columns k_b+1..k_b+3 plus all degree-1 extension columns carry
    shift 0.
    """
    p = BG_PARAMS[bg]
    rows = [list(r) for r in p["rows"]]
    k_b = p["k_b"]
    num_cols = p["num_cols"]

    i_ls = lifting_set_index(z)
    z_max = max(LIFTING_SETS[i_ls])

    spec = _load_spec_table(bg)
    if spec is not None:
        shifts = {edge: vals[i_ls] for edge, vals in spec.items()}
    else:
        shifts = _greedy_shifts(rows, num_cols, z_max, seed=1000 * bg + i_ls)
        # Canonical, guaranteed-invertible core parity shifts.
        special_rows = SPECIAL_ROWS[bg]
        s = 1 % z_max
        shifts[(special_rows[0], k_b)] = s
        shifts[(special_rows[1], k_b)] = 0
        shifts[(special_rows[2], k_b)] = s
        # staircase: col k_b+1 rows (0,1), k_b+2 rows (1,2), k_b+3 rows (2,3)
        for i in range(3):
            shifts[(i, k_b + 1 + i)] = 0
            shifts[(i + 1, k_b + 1 + i)] = 0
        # extension parity columns: degree-1 identity (shift 0)
        for r in range(4, p["num_rows"]):
            ext_col = k_b + r
            shifts[(r, ext_col)] = 0

    shifts = {k: v % z for k, v in shifts.items()}
    return rows, shifts


def select_base_graph(tb_size: int, coderate: float) -> int:
    """Base graph selection, 38.212 §7.2.2."""
    if tb_size <= 292 or coderate <= 0.25 or (
            tb_size <= 3824 and coderate <= 0.67):
        return 2
    return 1


def select_lifting_size(k_prime: int, k_b: int) -> int:
    """Smallest Z in Table 5.3.2-1 with k_b * Z >= K'."""
    for z in ALL_Z:
        if k_b * z >= k_prime:
            return z
    raise ValueError(f"K'={k_prime} too large")
