"""The program's own record of the traced window, for the readers under
``metrics/`` that read it: ``tpuseg_torch.utils.profiling.snapshot()``,
which sums the spans, device stages and counters the program recorded
while the window's profiler session was on, and its gauges. A program
without that recorder gives None here, and so does every such reader."""

from __future__ import annotations


def snapshot() -> dict | None:
    try:
        from tpuseg_torch.utils import profiling
    except ImportError:
        return None
    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else None


def stage_ms(name: str, snap: dict | None = None) -> float | None:
    """Device milliseconds of the stage ``name`` per call that ran it,
    summed over its marks in the call (None where no call timed it)."""
    snap = snapshot() if snap is None else snap
    stage = (snap or {}).get("stages", {}).get(name)
    return stage.get("per_call_ms") if stage else None


def span(name: str, snap: dict | None = None) -> dict | None:
    """The spans named ``name``: ``count``, ``calls``, ``sum_ms``,
    ``mean_ms``, ``per_call_ms``."""
    snap = snapshot() if snap is None else snap
    return (snap or {}).get("spans", {}).get(name)
