"""Bounded per-row shifts and windows as plain index arithmetic —
counterpart of the JAX package's ``ops/dynshift.py`` (whose barrel-shift
ladders were a TPU workaround; the semantics are the same)."""

from __future__ import annotations

import torch


def _shift_rows(x: torch.Tensor, shift, bound: int, sign: int):
    P = x.shape[-2]
    shift = torch.clamp(torch.as_tensor(shift, device=x.device).long(),
                        0, bound)
    src = torch.arange(P, device=x.device) + sign * shift[..., None]
    ok = (src >= 0) & (src < P)
    lead = torch.broadcast_shapes(x.shape[:-2], src.shape[:-1])
    xe = x.expand(lead + x.shape[-2:])
    src = src.clamp(0, P - 1).expand(lead + (P,))
    out = torch.gather(xe, -2, src[..., None].expand(lead + x.shape[-2:]))
    return torch.where(ok.expand(lead + (P,))[..., None], out,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def shift_rows_down(x: torch.Tensor, shift, bound: int):
    """``out[..., i, :] = x[..., i - shift, :]`` (zeros for i < shift);
    ``shift`` (per leading index) is clamped into ``[0, bound]``."""
    return _shift_rows(x, shift, bound, -1)


def shift_rows_up(x: torch.Tensor, shift, bound: int):
    """``out[..., i, :] = x[..., i + shift, :]`` (zeros past the end);
    ``shift`` is clamped into ``[0, bound]``."""
    return _shift_rows(x, shift, bound, +1)


def select_window(table: torch.Tensor, start, length: int):
    """Rows ``table[start : start + length]`` per entry of ``start`` (...,)
    -> (..., length, C); the caller guarantees ``start + length <= T``
    (tile wrap copies, see planner/velplan.opponent_summary)."""
    T = table.shape[0]
    if T < length:
        raise ValueError(
            f"select_window: table has {T} rows < window length {length}; "
            "tile more wrap copies at the call site")
    start = torch.as_tensor(start, device=table.device).long()
    idx = start[..., None] + torch.arange(length, device=table.device)
    return table[idx.clamp(max=T - 1)]
