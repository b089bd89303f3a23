"""Seeded raw inputs for the backpointer walk and the min-plus scan
(``ops/cuda_backtrace.backtrace_walk``, ``ops/cuda_minplus.minplus_scan``)
at shapes and contents the planner's own calls do not reach.  A case is a
dictionary of numpy arrays keyed by the wrappers' argument names, so the
same case can go through the JAX package, the plain PyTorch version and the
CUDA kernel.  The index arrays of a case are a mix of int32 and int64.

Walk: row counts around a warp and a block and beyond the fleet's 4,096;
node counts below, at and above a warp (the kernel's lanes hold one or two
columns each, or the table lies in shared memory beyond 64 nodes or 32
layers); horizons of 0, 1, H and mixed, and beyond H; goals at 0 and
N - 1; tables taken from a real min-plus DP (consistent chains) and tables
of random nodes with holes (-1: after a hole the TPU kernel's one-hot
select gives node 0 where ``ops/search.backtrace`` reads the entry of node
0, so only the DP tables go to the Pallas kernel); the slot form, in which
``bp`` is the unselected (R0, S, H+1, N) table and row r walks
``bp[r // k, slot[r]]``, with all four slots and repeated slots.

Min-plus: row counts from 1 to more than 4,096, node counts whose step slab
is no multiple of 16 bytes (odd N), horizons of 1 to 27, tied sums (small
integer costs), rows that are all INF or become INF mid-window, and costs
at and far above INF, so that ``INF + w`` saturates (or overflows to inf)
before the clamp.
"""

from __future__ import annotations

import numpy as np

INF = np.float32(1e30)

WALK_ARGS = ("bp", "goal_node", "h_eff")
MINPLUS_ARGS = ("w_window", "start_node")

# (R, N, H+1, horizons, table, slots): horizons "zero", "one", "full",
# "over" (beyond H) or "mixed"; table "dp" or "random"; slots 0 (no slot
# form) or S, the rows per table row k = 4 with S slots
WALK_CASES = (
    (4096, 24, 28, "mixed", "dp", 4),       # the fleet's call
    (3, 24, 28, "mixed", "dp", 4),          # the facade's: one scenario
    (1, 24, 28, "full", "dp", 0),
    (3, 8, 2, "mixed", "random", 0),
    (31, 8, 20, "one", "dp", 0),
    (33, 32, 20, "mixed", "random", 4),
    (4095, 32, 20, "full", "dp", 0),
    (4100, 24, 28, "mixed", "random", 4),
    (31, 33, 28, "mixed", "dp", 0),
    (33, 64, 28, "full", "random", 4),
    (1, 64, 2, "over", "random", 0),
    (3, 33, 20, "zero", "random", 0),
    (33, 24, 2, "mixed", "dp", 4),
    (31, 64, 20, "mixed", "dp", 1),
    (4100, 8, 28, "over", "dp", 0),
    (33, 80, 20, "mixed", "dp", 4),         # N > 64: the shared-memory path
    (31, 24, 40, "mixed", "random", 0),     # H+1 > 32: the same
    (4095, 64, 28, "mixed", "random", 4),
)

# (R, N, H, costs): "uniform", "ties" (small integers), "inf" (all-INF rows
# and rows that become INF mid-window) or "huge" (costs at and above INF)
MINPLUS_CASES = (
    (4096, 24, 27, "ties"),                 # the dense-window call
    (1, 24, 27, "uniform"),
    (3, 8, 1, "ties"),
    (7, 33, 19, "inf"),
    (4100, 24, 19, "huge"),
    (1, 64, 27, "inf"),
    (7, 32, 27, "huge"),
    (3, 33, 1, "uniform"),
    (7, 8, 27, "inf"),
    (4100, 8, 27, "ties"),
    (3, 64, 19, "ties"),
    (1, 33, 27, "huge"),
    (7, 24, 19, "inf"),
    (3, 32, 1, "uniform"),
)


def _index(values, i, k):
    """Index array ``k`` of case ``i``: int32 or int64 by turns."""
    return values.astype(np.int64 if (i + k) % 2 else np.int32)


def minplus_window(rng, R, H, N, costs):
    """(R, H, N, N) float32 edge costs of one kind (see ``MINPLUS_CASES``)."""
    if costs == "ties":
        w = rng.integers(0, 4, (R, H, N, N)).astype(np.float32)
    else:
        w = rng.uniform(0.5, 30.0, (R, H, N, N)).astype(np.float32)
    w[rng.random(w.shape) < 0.2] = INF
    if costs == "inf":
        w[::3] = INF                        # rows with no edge at all
        if H > 1:                           # rows that end mid-window
            w[1::3, H // 2] = INF
    if costs == "huge":
        big = rng.random(w.shape)
        w[big < 0.15] = np.float32(3e30)
        w[big > 0.95] = np.float32(3e38)    # INF + w is +inf in float32
    return w


def minplus_numpy(w, start):
    """The recurrence of ``ops/search.minplus_scan`` over rows, in numpy:
    ``best`` (R, H+1, N) and ``bp`` (R, H+1, N) int32."""
    R, H, N, _ = w.shape
    best = np.full((R, N), INF, np.float32)
    best[np.arange(R), start] = 0.0
    bests = [best]
    bps = [np.full((R, N), -1, np.int32)]
    with np.errstate(over="ignore"):
        for h in range(H):
            tot = best[:, :, None] + w[:, h]
            best = np.minimum(tot.min(axis=1), INF)
            bests.append(best)
            bps.append(tot.argmin(axis=1).astype(np.int32))
    return np.stack(bests, axis=1), np.stack(bps, axis=1)


def walk_case(seed: int, i: int, R: int, N: int, Hp1: int, horizons: str,
              table: str, slots: int) -> dict:
    """One call's inputs of ``backtrace_walk``: ``bp``, ``goal_node``,
    ``h_eff`` and, in the slot form, ``slot``."""
    rng = np.random.default_rng(seed)
    H = Hp1 - 1
    k = 4 if slots else 1
    R0 = -(-R // k)
    R = R0 * k
    T = R0 * max(slots, 1)                  # tables
    if table == "dp":
        w = minplus_window(rng, T, H, N, "ties")
        w[rng.random(w.shape) < 0.3] = INF
        _, bp = minplus_numpy(w, rng.integers(0, N, T))
    else:
        bp = rng.integers(0, N, (T, Hp1, N)).astype(np.int32)
        bp[rng.random(bp.shape) < 0.1] = -1
        bp[:, 0] = -1
    h_eff = {"zero": np.zeros(R, np.int64), "one": np.ones(R, np.int64),
             "full": np.full(R, H, np.int64),
             "over": np.full(R, Hp1 + 2, np.int64)}.get(horizons)
    if h_eff is None:
        h_eff = rng.integers(-1, Hp1 + 1, R)
        h_eff[: min(R, 4)] = np.array([0, 1, H, H])[: min(R, 4)]
    goal = rng.integers(0, N, R)
    goal[0] = 0
    goal[-1] = N - 1
    case = dict(goal_node=_index(goal, i, 0), h_eff=_index(h_eff, i, 1))
    if slots:
        case["bp"] = bp.reshape(R0, slots, Hp1, N)
        slot = rng.integers(0, slots, R)
        slot[:k] = np.arange(k) % slots     # every slot, then repeats
        if R0 > 1:
            slot[k:2 * k] = slot[k]
        case["slot"] = _index(slot, i, 2)
    else:
        case["bp"] = bp
    return case


def minplus_case(seed: int, i: int, R: int, N: int, H: int,
                 costs: str) -> dict:
    """One call's inputs of ``minplus_scan``."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, N, R)
    start[0] = N - 1
    return dict(w_window=minplus_window(rng, R, H, N, costs),
                start_node=_index(start, i, 0))


def walk_args(case):
    """The positional arguments of ``backtrace_walk`` in a case."""
    return [case[k] for k in WALK_ARGS] + (
        [case["slot"]] if "slot" in case else [])


def walk_label(i: int) -> str:
    """The label of ``WALK_CASES[i]``, with the row count the case has."""
    R, N, Hp1, horizons, table, slots = WALK_CASES[i]
    k = 4 if slots else 1
    return (f"R{-(-R // k) * k}-N{N}-Hp{Hp1}-{horizons}-{table}"
            f"-slots{slots}")


def walk_case_at(i: int) -> dict:
    return walk_case(4000 + i, i, *WALK_CASES[i])


def minplus_label(i: int) -> str:
    R, N, H, costs = MINPLUS_CASES[i]
    return f"R{R}-N{N}-H{H}-{costs}"


def minplus_case_at(i: int) -> dict:
    return minplus_case(5000 + i, i, *MINPLUS_CASES[i])


def walk_cases():
    """``(label, case)`` for every entry of ``WALK_CASES``."""
    for i in range(len(WALK_CASES)):
        yield walk_label(i), walk_case_at(i)


def minplus_cases():
    """``(label, case)`` for every entry of ``MINPLUS_CASES``."""
    for i in range(len(MINPLUS_CASES)):
        yield minplus_label(i), minplus_case_at(i)
