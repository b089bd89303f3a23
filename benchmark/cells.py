"""A run of a cell: set-up, the measured window, the trace run's
readings, the check and the result line.  :func:`run_cell` returns the
result and the checks without printing, for the tests, which drive it on
the CPU with the program's plain path and a planted fault.
"""

from __future__ import annotations

import gc
import sys

import torch

from benchmark import core, fleet


def run(man, cell, cfg, mix, args, t_start) -> int:
    result, checks = run_cell(man, cell, cfg, mix, args.seed, args.seconds,
                              bool(args.trace), t_start,
                              torch.device("cuda"))
    return core.finish(result, checks)


def run_cell(man, cell, cfg, mix, seed, seconds, traced, t_start, dev,
             fault=None, control=None):
    """One run; ``fault`` (the tests') breaks the program's timed path:
    the program's tick is replaced by ``fault(tick)``; ``control`` checks
    the control in the program's place (its readings)."""
    if mix["kind"] != "fleet":
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    return run_fleet(man, cell, cfg, mix, seed, seconds, traced, t_start,
                     dev, fault, control)


def _result(man, cell, e2e: dict, ctx, checks, attempted, failed, dev,
            peak, traced):
    ok = all(c["ok"] for c in checks)
    metrics = {}
    if traced:
        for m in core.per_layer(man, cell["name"]):
            v = core.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        for m in core.end_to_end(man, cell["name"]):
            metrics[m["name"]] = dict(value=e2e[m["name"]], unit=m["unit"])
    device = core.device_info(cell["chips"], peak, dev)
    out = dict(correct=ok, attempted=int(attempted), failed=int(failed),
               metrics=metrics, device=device)
    if traced:
        device["busy_s"] = ctx["busy_s"]
        device["window_s"] = ctx["window_s"]
        out["breakdown"] = dict(device_ops=ctx["device_ops"],
                                idle_gaps=ctx["idle_gaps"])
    return out


def phases(setup_s, window_s, between_s, check_s) -> None:
    print(f"phases: set-up {setup_s:.3f} s, window {window_s:.3f} s, "
          f"trace and release {between_s:.3f} s, check {check_s:.3f} s",
          file=sys.stderr, flush=True)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _release(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _signatures(tick) -> int:
    """The compiled tick's captured signatures (0 for an eager tick)."""
    return len(getattr(tick, "graphs", ()))


def run_fleet(man, cell, cfg, mix, seed, seconds, traced, t_start, dev,
              fault, control):
    f = fleet.setup(cfg, mix, seed, dev, fault=fault)
    fleet.warm(f.tick, f.batches, dev)
    setup_s = core.clock() - t_start
    sigs = _signatures(f.tick)
    n, secs, keep, used = fleet.window(f.tick, f.batches, seconds, dev)
    peak = _peak(dev)
    if dev.type == "cuda":
        print(f"card after the window: {core.card_state()}; compiled "
              f"signatures before the window {sigs}, after it "
              f"{_signatures(f.tick)}; device ms a tick after it "
              f"(quartiles): {fleet.device_ms(f.tick, f.batches)}",
              file=sys.stderr)
    B = mix["batch"]
    e2e = dict(replans_per_s=n * B / secs, setup_s=setup_s)
    ctx = None
    if traced:
        ctx = fleet.traced_readings(f.tick, f.batches, dev, core.PROGRAM,
                                    mix["trace_ticks"])
        peak = max(peak, _peak(dev))
    rows = fleet.checked_rows(f)
    p_rows = fleet.program_rows(keep, rows)
    c_rows = None if used is None else fleet.program_rows(used, rows)
    del keep, used
    f.tick = f.batches = None
    _release(dev)
    t_check = core.clock()
    checks = fleet.check(f, p_rows, control, c_rows)
    phases(setup_s, secs, t_check - t_start - setup_s - secs,
           core.clock() - t_check)
    failed = 0 if all(c["ok"] for c in checks) else n * B
    return _result(man, cell, e2e, ctx, checks, n * B, failed, dev, peak,
                   traced), checks
