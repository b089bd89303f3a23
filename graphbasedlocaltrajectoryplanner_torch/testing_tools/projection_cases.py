"""Seeded inputs of the arc-length projection kernel
(``ops/cuda_projection.get_s_coords``, ``csrc/projection.cu``), the
recording of the fleet tick's calls, and the comparison of a kernel call
with its plain version: the one place the CPU tests, ``chip_smoke.py`` and
``cuda_parity`` read them from.

A case is one call: a polyline, one to three position sets and the
polyline's arc lengths, the cases the kernel must reproduce bit for bit
(:data:`CASES`):

* ``ellipse_closed`` / ``ellipse_open``: a 40-point ellipse and 25 seeded
  positions near it;
* ``tie``: positions equidistant from two vertices (the lower index wins);
* ``wrap_first`` / ``wrap_last``: a closed ring, positions around vertex 0
  and vertex n - 1 from both sides (the neighbours wrap);
* ``clamp_ends``: an open line, positions before its start and beyond its
  end (the neighbours clamp);
* ``equal_angles``: both neighbours of the closest vertex one point, so
  ``ang1 == ang2`` exactly: the foot segment (``>``) and the returned
  indices (``>=``) differ;
* ``padded_rows``: a polyline a row, the follow path's layout (x, y of a
  (R, 4, P, 5) path table's slot 1, s of its (R, 4, P) arc lengths), rows
  frozen at their last real sample from a seeded length on, two position
  sets (the object and the ego), some beyond the end;
* ``shared_sets``: the raceline launch's form: a closed 61-point ring, two
  columns of a (61, 5) table, sets of (B,), (B,) and (B, O) positions;
* ``long_line``: a shared polyline of 5,000 vertices (more than the kernel
  stages in shared memory: read in place);
* ``tiny``: polylines of 1, 2 and 3 vertices, closed and open;
* ``nan_position``: a NaN position (every distance NaN: vertex 0).

Positions lie on rounded coordinates where a case needs an exact tie.
"""

from __future__ import annotations

import numpy as np
import torch

from graphbasedlocaltrajectoryplanner_torch.ops import cuda_projection as cpj


def _arc(line):
    """Cumulative chord lengths of a (..., n, 2) polyline, a leading 0."""
    d = np.hypot(*np.moveaxis(np.diff(line, axis=-2), -1, 0))
    return np.concatenate([np.zeros(d.shape[:-1] + (1,)),
                           np.cumsum(d, axis=-1)], axis=-1)


def _ellipse(n, a=80.0, b=40.0):
    ang = np.linspace(0, 2 * np.pi, n + 1)[:-1]
    return np.stack([a * np.cos(ang), b * np.sin(ang)], 1)


def _near(rng, line, q, sigma=3.0):
    """q positions near seeded vertices of ``line``."""
    return line[rng.integers(0, len(line), q)] + rng.normal(0, sigma, (q, 2))


def _ellipse_case(closed):
    rng = np.random.default_rng(2)
    line = _ellipse(40)
    return dict(line=line, s=_arc(line), pos=[_near(rng, line, 25)],
                closed=closed)


def _tie():
    line = np.stack([np.arange(8) * 2.0, np.zeros(8)], 1)
    pos = np.array([[1.0, 0.5], [3.0, -0.75], [5.0, 0.0], [13.0, 2.0],
                    [-1.0, 0.0], [7.0, 4.0]])
    return dict(line=line, s=_arc(line), pos=[pos], closed=False)


def _wrap(first):
    rng = np.random.default_rng(4 if first else 5)
    line = _ellipse(24, 30.0, 30.0)
    v = 0 if first else len(line) - 1
    ring = line[[v - 1, v, (v + 1) % len(line)]]
    pos = np.concatenate([ring + rng.normal(0, 0.5, (3, 2)),
                          0.5 * (ring[:-1] + ring[1:]) * 1.02,
                          ring * 0.97])
    return dict(line=line, s=_arc(line), pos=[pos], closed=True)


def _clamp_ends():
    rng = np.random.default_rng(6)
    line = np.cumsum(rng.uniform(0.5, 2.0, (30, 2)), axis=0)
    first, last = line[0], line[-1]
    pos = np.stack([first - 3.0, first - [0.0, 1.0], first, last,
                    last + 2.5, last + [1.0, -0.5], line[1] + 0.1,
                    line[-2] - 0.1])
    return dict(line=line, s=_arc(line), pos=[pos], closed=False)


def _equal_angles():
    line = np.array([[-1.0, 0.0], [0.0, 0.0], [-1.0, 0.0], [4.0, 4.0],
                     [4.0, 4.0], [4.0, 4.0], [9.0, 0.0]])
    pos = np.array([[0.25, 0.5], [0.5, -0.25], [4.0, 5.0], [4.5, 4.0]])
    return dict(line=line, s=np.arange(len(line), dtype=np.float64),
                pos=[pos], closed=False)


def _padded_rows():
    rng = np.random.default_rng(7)
    R, P = 37, 448
    el = rng.uniform(0.5, 3.0, (R, 4, P))
    ang = np.cumsum(rng.normal(0.0, 0.05, (R, 4, P)), axis=-1)
    xy = np.cumsum(np.stack([el * np.cos(ang), el * np.sin(ang)], -1),
                   axis=-2)
    n_valid = rng.integers(1, P + 1, (R, 4))
    n_valid[:4, 1] = (1, 2, P - 1, P)
    idx = np.arange(P)
    last = np.take_along_axis(xy, (n_valid - 1)[..., None, None], axis=-2)
    xy = np.where((idx >= n_valid[..., None])[..., None], last, xy)
    el = np.where(idx >= n_valid[..., None] - 1, 0.0, el)
    table = np.concatenate([xy, ang[..., None], np.zeros((R, 4, P, 1)),
                            el[..., None]], -1)
    s4 = np.concatenate([np.zeros((R, 4, 1)),
                         np.cumsum(el[..., :-1], axis=-1)], -1)
    path = xy[:, 1]
    pick = rng.integers(0, P, (2, R))
    obj = path[np.arange(R), pick[0]] + rng.normal(0, 1.0, (R, 2))
    ego = path[np.arange(R), pick[1]] + rng.normal(0, 1.0, (R, 2))
    ego[:3] = last[:3, 1, 0] + [[2.0, 1.0], [5.0, 0.0], [0.0, -3.0]]
    return dict(table=table, s4=s4, slot=1, pos=[obj, ego], closed=False)


def _shared_sets():
    rng = np.random.default_rng(8)
    line = _ellipse(61, 200.0, 90.0)
    table = np.concatenate([_arc(line)[:, None], line,
                            rng.normal(0.0, 0.01, (61, 1)),
                            rng.uniform(20, 70, (61, 1))], 1)
    B, O = 65, 4
    return dict(rl_table=table, closed=True,
                pos=[_near(rng, line, B, 5.0), line[rng.integers(0, 61, B)],
                     _near(rng, line, B * O, 8.0).reshape(B, O, 2)])


def _long_line():
    rng = np.random.default_rng(9)
    line = _ellipse(5000, 900.0, 500.0)
    return dict(line=line, s=_arc(line), pos=[_near(rng, line, 70)],
                closed=True)


def _tiny(n, closed):
    rng = np.random.default_rng(10 + n)
    line = rng.normal(0.0, 3.0, (n, 2))
    pos = np.concatenate([rng.normal(0.0, 4.0, (5, 2)), line])
    return dict(line=line, s=_arc(line), pos=[pos], closed=closed)


def _nan_position():
    line = _ellipse(12)
    pos = np.array([[np.nan, 0.0], [10.0, np.nan], [70.0, 10.0]])
    return dict(line=line, s=_arc(line), pos=[pos], closed=True)


CASES = {
    "ellipse_closed": lambda: _ellipse_case(True),
    "ellipse_open": lambda: _ellipse_case(False),
    "tie": _tie,
    "wrap_first": lambda: _wrap(True),
    "wrap_last": lambda: _wrap(False),
    "clamp_ends": _clamp_ends,
    "equal_angles": _equal_angles,
    "padded_rows": _padded_rows,
    "shared_sets": _shared_sets,
    "long_line": _long_line,
    "tiny_1_closed": lambda: _tiny(1, True),
    "tiny_2_closed": lambda: _tiny(2, True),
    "tiny_3_open": lambda: _tiny(3, False),
    "tiny_2_open": lambda: _tiny(2, False),
    "nan_position": _nan_position,
}


def case(name: str, device="cpu"):
    """``(ref_line, positions, s_array, closed)`` of a case as
    :func:`cuda_projection.get_s_coords` takes them, float32 on
    ``device``: the follow path's and the raceline table's columns as the
    strided views the tick passes."""
    c = CASES[name]()

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    pos = tuple(t(p) for p in c["pos"])
    if "table" in c:
        paths, s4 = t(c["table"]), t(c["s4"])
        return (paths[:, c["slot"], :, 0:2], pos, s4[:, c["slot"]],
                c["closed"])
    if "rl_table" in c:
        table = t(c["rl_table"])
        return table[:, 1:3], pos, table[:, 0], c["closed"]
    return t(c["line"]), pos, t(c["s"]), c["closed"]


def recorded(fn):
    """``fn()`` with every call of ``cuda_projection.get_s_coords``
    recorded (tensors cloned with their strides, so a strided view stays
    one; the wrapper's ``launches`` kept): ``(out, [(args, kw)])``."""
    calls, orig = [], cpj.get_s_coords

    def rec(ref_line, positions, s_array, closed=False):
        calls.append(((_strided_clone(ref_line),
                       tuple(p.clone() for p in positions),
                       _strided_clone(s_array)), dict(closed=closed)))
        return orig(ref_line, positions, s_array, closed)
    rec.launches = 0
    cpj.get_s_coords = rec
    try:
        out = fn()
    finally:
        cpj.get_s_coords = orig
        orig.launches += rec.launches
    return out, calls


def _strided_clone(x):
    """A copy of ``x`` with the strides of ``x``."""
    span = 1 + sum((d - 1) * st for d, st in zip(x.shape, x.stride()))
    buf = torch.full((max(span, 1),), float("nan"), dtype=x.dtype,
                     device=x.device)
    y = buf.as_strided(x.shape, x.stride())
    y.copy_(x)
    return y


def flat(outs):
    """A call's outputs ``((s, (idx_a, idx_b)), ...)`` as one tuple."""
    return tuple(x for s, (ia, ib) in outs for x in (s, ia, ib))


def compare(got, want):
    """A kernel call's outputs against its plain version's: ``(ok,
    what)``, each output of the same shape and dtype and equal bit for bit
    (a NaN s where the plain one is NaN, a -0.0 where it is -0.0)."""
    for i, (x, y) in enumerate(zip(flat(got), flat(want))):
        if x.shape != y.shape or x.dtype != y.dtype:
            return False, f"output {i}: {x.dtype}{tuple(x.shape)} against " \
                f"{y.dtype}{tuple(y.shape)}"
        xb = x.contiguous().view(torch.int32) if x.is_floating_point() else x
        yb = y.contiguous().view(torch.int32) if y.is_floating_point() else y
        if not torch.equal(xb, yb):
            return False, f"output {i} (set {i // 3}, " \
                f"{('s', 'idx_a', 'idx_b')[i % 3]}) differs in " \
                f"{int((xb != yb).sum())} of {x.numel()} places"
    return True, ""


# float operations a (query, vertex) pair (two subtractions, two products,
# a sum, a comparison) and a query's tail (two atan2 pairs and their
# wraps, the foot point, the division, the root)
VERTEX_OPS, TAIL_OPS = 6, 60


def work(args, outs):
    """(bytes, operations) one call needs: the polyline's x, y and s read
    once (a shared one once, one a row once a row: its 20-byte rows where
    it is the follow path), each position read and each output written
    once; operations a (query, vertex) pair and a query's tail."""
    ref_line, positions, s_array = args[:3]
    n = ref_line.shape[-2]
    rows = ref_line.shape[0] if ref_line.dim() == 3 else 1
    row_bytes = 4 * max(ref_line.stride(-2), 2) if rows > 1 else 8
    nb = rows * n * (row_bytes + 4)
    queries = sum(p.numel() // 2 for p in positions)
    nb += queries * (8 + 4 + 16)
    return nb, queries * (n * VERTEX_OPS + TAIL_OPS)
