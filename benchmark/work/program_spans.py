"""The program's own spans set against the device trace, for the readers of
the idle shares and the loader's starved share.

The port records spans of its host work while a ``torch.profiler`` records
(``pti_ldm_vae_tpu_torch/utils/profiling.py``: ``span`` / ``take_spans``),
on the clock the trace stamps its device events with. After the window of a
traced run, :func:`spans` takes them once for every reader. Each idle instant
of the window (the window less the union of the device operations) goes to
one group, tested in this order:

1. the outermost open span is ``val.epoch`` or ``train.epoch_end``: ``between_epochs``;
2. else the innermost open span is ``h2d``: ``h2d``;
3. else it is ``train.step``: ``issue`` (the host issuing the step's work);
4. else it is ``loader.wait``: ``loader``;
5. else ``unattributed``.

A program that records no spans (one from before them) gives None for every
number here, and its readers leave their metrics out.
"""

from __future__ import annotations

from pti_ldm_vae_tpu_torch.utils import profiling

from ..harness import busy_intervals

BETWEEN_EPOCHS = ("val.epoch", "train.epoch_end")
INNERMOST = {"h2d": "h2d", "train.step": "issue", "loader.wait": "loader"}
GROUPS = ("between_epochs", "h2d", "issue", "loader", "unattributed")

_taken: tuple | None = None  # (run, its spans, their idle split): taken once per run


def _take(run) -> tuple:
    global _taken
    if _taken is None or _taken[0] is not run:
        take = getattr(profiling, "take_spans", None)
        found = (take() if take is not None else None) or None
        split = None
        if found and run.kernels and run.window_ns:
            split = split_idle(found, run.kernels, run.window_ns)
            run.notes.append("program spans: idle % of the window " + " ".join(
                f"{g} {v:.4f}" for g, v in split.items()) + f" ({len(found)} spans)")
        _taken = (run, found, split)
    return _taken


def spans(run) -> list | None:
    """The program's spans of ``run`` (``Span`` tuples), or None where the
    program has no span recorder or recorded nothing."""
    return _take(run)[1]


def idle_split(run) -> dict[str, float] | None:
    """:func:`split_idle` of ``run``'s spans and device trace, or None where
    there are no spans. The split, with the unattributed rest, goes on the
    run's standard error once."""
    return _take(run)[2]


def _group(open_spans: dict[int, str]) -> str:
    if not open_spans:
        return "unattributed"
    if open_spans[min(open_spans)] in BETWEEN_EPOCHS:
        return "between_epochs"
    return INNERMOST.get(open_spans[max(open_spans)], "unattributed")


def split_idle(found: list, kernels: list, window_ns: tuple[int, int]) -> dict[str, float]:
    """Percent of the window idle in each group of ``GROUPS``. Spans open
    in the window at their start (in the order they opened) and close at
    their end; both are clipped to the window, and a span still open
    (``end_ns`` 0) runs to its end."""
    w0, w1 = window_ns
    edges = []  # (time, 0 close / 1 open, index, name)
    for i, s in enumerate(found):
        start, end = max(s.start_ns, w0), min(s.end_ns or w1, w1)
        if end > start:
            edges += [(start, 1, i, s.name), (end, 0, i, s.name)]
    edges.sort()
    idle = []  # the window less the union of the device operations
    cursor = w0
    for a, b in busy_intervals(kernels):
        if a > cursor:
            idle.append((cursor, min(a, w1)))
        cursor = max(cursor, b)
        if cursor >= w1:
            break
    if cursor < w1:
        idle.append((cursor, w1))

    out = dict.fromkeys(GROUPS, 0)
    open_spans: dict[int, str] = {}
    k = 0  # the first idle interval that may still reach past ``t``
    t = w0
    for when, opens, i, name in edges + [(w1, 0, -1, "")]:
        if when > t:
            group = _group(open_spans)
            while k < len(idle) and idle[k][1] <= t:
                k += 1
            j = k
            while j < len(idle) and idle[j][0] < when:
                out[group] += min(idle[j][1], when) - max(idle[j][0], t)
                j += 1
            t = when
        if opens:
            open_spans[i] = name
        else:
            open_spans.pop(i, None)
    return {g: 100.0 * v / (w1 - w0) for g, v in out.items()}


def _inside(found: list, i: int, name: str) -> bool:
    """Whether span ``i`` lies inside a span named ``name``."""
    parent = found[i].parent
    while parent is not None:
        if found[parent].name == name:
            return True
        parent = found[parent].parent
    return False


def starved_share(found: list, window_ns: tuple[int, int]) -> float | None:
    """Percent of the training loader's requests (``loader.wait`` spans
    started in the window, outside ``val.epoch``) that found its prefetch
    queue empty (``arg`` 0); None where there were none."""
    w0, w1 = window_ns
    depths = [s.arg for i, s in enumerate(found)
              if s.name == "loader.wait" and w0 <= s.start_ns < w1
              and not _inside(found, i, "val.epoch")]
    if not depths:
        return None
    return 100.0 * sum(d == 0 for d in depths) / len(depths)
