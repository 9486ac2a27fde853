"""The readers of the program's spans (``benchmark/work/program_spans.py``
and the five ``benchmark/metrics/`` readers that use it) on synthetic spans
and device operations: the idle groups add up to the idle share, spans and
gaps are clipped at the window's edges, the outermost-then-innermost rule,
the starved share of the training loader's requests, one take per run and
nothing read from a program without spans."""

from __future__ import annotations

import types
from pathlib import Path

import pytest

from benchmark import run as harness
from benchmark.harness import busy_s
from benchmark.work import program_spans, readers
from pti_ldm_vae_tpu_torch.utils import profiling
from pti_ldm_vae_tpu_torch.utils.profiling import Span

METRICS = Path(__file__).resolve().parents[1] / "metrics"
READERS = {"idle_between_epochs_share.train": "between_epochs",
           "idle_in_h2d_share.train": "h2d", "idle_in_issue_share.train": "issue",
           "idle_in_loader_share.train": "loader"}


def _run(kernels, window=(0, 100)):
    run = types.SimpleNamespace(kernels=kernels, window_ns=window, counts={}, notes=[],
                                window_s=(window[1] - window[0]) / 1e9)
    run.counts["busy_s"] = busy_s(run)
    return run


def _span(name, start, end, parent=None, arg=None):
    return Span(name, start, end, parent, None, arg)


# one training step, its epoch's end and a validation, on a window of 100 ns:
#   0-10 loader.wait (depth 0), 10-40 train.step with h2d 12-20, 40-50 train.epoch_end,
#   50-80 val.epoch with loader.wait 52-58 (depth 0) and h2d 60-62, 80-100 nothing
STEP = [_span("loader.wait", 0, 10, arg=0), _span("train.step", 10, 40, arg=1),
        _span("h2d", 12, 20, parent=1, arg=8), _span("train.epoch_end", 40, 50),
        _span("val.epoch", 50, 80), _span("loader.wait", 52, 58, parent=4, arg=0),
        _span("h2d", 60, 62, parent=4, arg=8)]
# device busy 5-11, 14-16, 25-45, 55-70, 90-95: idle 0-5, 11-14, 16-25, 45-55, 70-90, 95-100
KERNELS = [("k", 5, 11), ("k", 14, 16), ("k", 25, 30), ("k", 28, 45), ("k", 55, 70),
           ("k", 90, 95)]


def test_the_idle_groups_add_up_to_the_idle_share():
    run = _run(KERNELS)
    split = program_spans.split_idle(STEP, run.kernels, run.window_ns)
    # loader 0-5; h2d 12-14 and 16-20; issue 11-12 and 20-25; between 45-55 and 70-80;
    # unattributed 80-90 and 95-100
    assert split == pytest.approx({"loader": 5.0, "h2d": 6.0, "issue": 6.0,
                                   "between_epochs": 20.0, "unattributed": 15.0})
    assert sum(split.values()) == pytest.approx(readers.idle_share(run))


def test_spans_and_gaps_are_clipped_at_both_window_edges():
    spans = [_span("train.step", -50, 30), _span("h2d", -40, 5, parent=0),
             _span("val.epoch", 60, 500), _span("loader.wait", 70, 400, parent=2)]
    kernels = [("k", -30, 10), ("k", 20, 40), ("k", 90, 130)]  # idle 10-20, 40-60, 60-90
    split = program_spans.split_idle(spans, kernels, (0, 100))
    assert split == pytest.approx({"issue": 10.0, "h2d": 0.0, "unattributed": 20.0,
                                   "between_epochs": 30.0, "loader": 0.0})
    # an open span (end 0) runs to the window's end
    split = program_spans.split_idle([_span("loader.wait", 50, 0)], [("k", 0, 10)], (0, 100))
    assert split["loader"] == pytest.approx(50.0) and split["unattributed"] == pytest.approx(40.0)


@pytest.mark.parametrize("chain,group", [
    (["val.epoch", "h2d"], "between_epochs"), (["val.epoch", "loader.wait"], "between_epochs"),
    (["train.epoch_end"], "between_epochs"), (["train.step", "h2d"], "h2d"),
    (["train.step"], "issue"), (["loader.wait"], "loader"), (["h2d"], "h2d"),
    (["ckpt.save"], "unattributed"), (["ckpt.save", "h2d"], "h2d"), ([], "unattributed"),
])
def test_the_outermost_span_then_the_innermost_decides(chain, group):
    spans = [_span(name, 10 + i, 90 - i, parent=i - 1 if i else None)
             for i, name in enumerate(chain)]
    split = program_spans.split_idle(spans, [("k", 0, 20), ("k", 80, 100)], (0, 100))
    assert split[group] == pytest.approx(60.0)
    assert sum(split.values()) == pytest.approx(60.0)


def test_validation_requests_are_left_out_of_the_starved_share():
    spans = STEP + [_span("loader.wait", 85, 86, arg=2), _span("loader.wait", 99, 120, arg=0),
                    _span("loader.wait", -5, 1, arg=0)]
    # in the window and outside val.epoch: depths 0, 2 and 0 (the last from 99)
    assert program_spans.starved_share(spans, (0, 100)) == pytest.approx(200.0 / 3)
    validation = [_span("val.epoch", 50, 80), _span("loader.wait", 52, 58, parent=0, arg=0)]
    assert program_spans.starved_share(validation, (0, 100)) is None


def _read(name, run):
    module = harness.load_module(METRICS / f"{name}.py", "metric_" + name.replace(".", "_"))
    return module.read(run)


def test_the_readers_take_the_spans_once(monkeypatch):
    taken = []
    monkeypatch.setattr(profiling, "take_spans", lambda: taken.append(1) or list(STEP))
    run = _run(KERNELS)
    split = program_spans.split_idle(STEP, KERNELS, run.window_ns)
    for name, group in READERS.items():
        assert _read(name, run) == pytest.approx(split[group])
    assert _read("loader_starved_share.train", run) == pytest.approx(100.0)
    assert taken == [1] and len(run.notes) == 1 and "unattributed 15.0000" in run.notes[0]
    other = _run(KERNELS)  # a new run takes again
    assert _read("idle_in_h2d_share.train", other) == pytest.approx(6.0) and taken == [1, 1]


@pytest.mark.parametrize("program", ["no_spans", "no_recorder"])
def test_a_program_without_spans_gives_no_reading(monkeypatch, program):
    if program == "no_spans":
        monkeypatch.setattr(profiling, "take_spans", lambda: [])
    else:  # a program from before the recorder
        monkeypatch.delattr(profiling, "take_spans")
    run = _run(KERNELS)
    for name in [*READERS, "loader_starved_share.train"]:
        assert _read(name, run) is None
    assert run.notes == []
