"""The port's profiling utilities (CPU): the span recorder (nothing without
a profiler; the trainer's and loader's spans, their parents, steps and queue
depths under one; the shared clock with ``torch.profiler``; ``take_spans``),
``trace_if`` on ``torch.profiler``, the live endpoint of
``start_profiler_server`` (windows recorded by the loop's own thread, its
errors, the ``--trace-at-step`` rule) and the trainer's ``--trace-at-step`` /
``--profile-port``. Every socket wait has a time limit of 30 s or less, and
every thread join one of 120 s or less."""

import gzip
import json
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pti_ldm_vae_tpu_torch.cli.train_vae import main as train_vae
from pti_ldm_vae_tpu_torch.data.loader import ShardedDataLoader
from pti_ldm_vae_tpu_torch.data.io import write_tif
from pti_ldm_vae_tpu_torch.utils import profiling


def test_a_disabled_trace_writes_nothing(tmp_path):
    with profiling.trace_if(tmp_path / "traces", enabled=False):
        torch.ones(4).sum()
    assert not (tmp_path / "traces").exists()


def _trace_events(folder: Path) -> list[dict]:
    files = sorted(folder.glob("*.pt.trace.json*"))
    assert len(files) == 1, files
    opener = gzip.open if files[0].suffix == ".gz" else open
    with opener(files[0], "rt") as fh:
        return json.load(fh)["traceEvents"]


def test_trace_if_writes_a_readable_chrome_trace(tmp_path):
    with profiling.trace_if(tmp_path / "traces"):
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    names = {e.get("name") for e in _trace_events(tmp_path / "traces")}
    assert "aten::matmul" in names


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _wait_for(cond, timeout_s: float = 20.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


class _Client(threading.Thread):
    """A capture from another thread; its result or its error afterwards."""

    def __init__(self, port, duration_ms, logdir, timeout_s=20.0, retry_s=0.0):
        super().__init__(daemon=True)
        self.args = (port, duration_ms, logdir, timeout_s)
        self.retry_s = retry_s  # how long "nothing answers" is retried (a server still starting)
        self.path = self.error = None
        self.start()

    def run(self):
        deadline = time.monotonic() + self.retry_s
        while True:
            try:
                self.path = profiling.capture(*self.args)
                return
            except profiling.CaptureError as exc:
                if "nothing answers" not in str(exc) or time.monotonic() > deadline:
                    self.error = exc
                    return
                time.sleep(0.02)

    def result(self):
        self.join(timeout=30)
        assert not self.is_alive()
        return self.path, self.error


def _train_step(model, x):
    model(x).square().mean().backward()


def _loop_until(server, client, model, x, first_step):
    """A training loop that calls ``step_boundary`` as the trainer does,
    until ``client`` has its answer; returns the next step number."""
    step = first_step
    while client.is_alive():
        assert step < first_step + 500
        if server.request is not None:
            server.step_boundary(step)
        _train_step(model, x)
        step += 1
    return step


def _names(path: Path) -> list[str]:
    return [e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]]


def test_profiler_server_windows_hold_the_loop_threads_ops(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Conv2d(1, 4, 3, padding=1), torch.nn.SiLU(),
                                torch.nn.Conv2d(4, 1, 3, padding=1))
    x = torch.randn(2, 1, 16, 16)
    port = _free_port()
    server = profiling.start_profiler_server(port)
    try:
        steps = 1
        for duration_ms in (1.0, 40.0):
            client = _Client(port, duration_ms, tmp_path / "tb")
            _wait_for(lambda: server.request is not None or not client.is_alive())
            steps = _loop_until(server, client, model, x, steps)
            path, error = client.result()
            assert error is None and path.parent == tmp_path / "tb"
            assert path.name.endswith(".pt.trace.json") and path.name.startswith(server.worker)
            names = _names(path)
            # the loop thread's forward and autograd ops, step by step
            assert "aten::conv2d" in names and any("Backward" in n for n in names)
            marked = [n for n in names if n.startswith("ProfilerStep#")]
            assert len(marked) >= 1 and (duration_ms > 1.0 or len(marked) == 1)
            assert server.request is None
    finally:
        server.close()
    with pytest.raises(profiling.CaptureError, match="nothing answers"):  # the port closed
        profiling.capture(port, 1.0, tmp_path / "tb", timeout_s=5)


def test_the_capture_client_command_writes_the_trace(tmp_path, capsys):
    port = _free_port()
    server = profiling.start_profiler_server(port)
    x = torch.randn(2, 1, 8, 8, requires_grad=True)
    try:
        out = {}
        thread = threading.Thread(target=lambda: out.setdefault("path", profiling.main(
            ["--port", str(port), "--duration-ms", "1", "--logdir", str(tmp_path / "logs"),
             "--timeout-s", "20"])), daemon=True)
        thread.start()
        _wait_for(lambda: server.request is not None)
        server.step_boundary(1)
        torch.nn.functional.conv2d(x, torch.ones(1, 1, 3, 3)).sum().backward()
        server.step_boundary(2)
        thread.join(timeout=30)
        assert not thread.is_alive()
    finally:
        server.close()
    assert capsys.readouterr().out.strip() == str(out["path"])
    assert out["path"].parent == tmp_path / "logs" and "aten::conv2d" in _names(out["path"])


def test_a_second_request_while_one_is_open_is_refused(tmp_path):
    port = _free_port()
    server = profiling.start_profiler_server(port)
    try:
        first = _Client(port, 1.0, tmp_path)
        _wait_for(lambda: server.request is not None)
        with pytest.raises(profiling.CaptureError, match="already open"):
            profiling.capture(port, 1.0, tmp_path, timeout_s=5)
        assert server.request is not None and server.request.state == "pending"
    finally:
        server.close()
    path, error = first.result()  # the run ended before its window
    assert path is None and "ended before the capture window started" in str(error)


def test_a_run_that_ends_before_the_window_gives_an_error(tmp_path):
    port = _free_port()
    server = profiling.start_profiler_server(port)
    client = _Client(port, 1.0, tmp_path)
    _wait_for(lambda: server.request is not None)
    server.close()
    path, error = client.result()
    assert path is None and isinstance(error, profiling.CaptureError)
    assert "the run ended before the capture window started" in str(error)
    assert not list(tmp_path.iterdir())


def test_a_request_no_step_serves_times_out(tmp_path):
    port = _free_port()
    server = profiling.start_profiler_server(port)
    try:
        t0 = time.monotonic()
        with pytest.raises(profiling.CaptureError, match="no step boundary came within 0.3 s"):
            profiling.capture(port, 1.0, tmp_path, timeout_s=0.3)
        assert time.monotonic() - t0 < 10 and server.request is None  # withdrawn
    finally:
        server.close()


def test_nothing_answering_gives_an_error(tmp_path):
    with pytest.raises(profiling.CaptureError, match="nothing answers on 127.0.0.1"):
        profiling.capture(_free_port(), 1.0, tmp_path, timeout_s=5)


def test_a_taken_port_raises_at_start():
    with socket.create_server(("127.0.0.1", 0)) as taken:
        port = taken.getsockname()[1]
        with pytest.raises(OSError, match=f"profiler port {port} on 127.0.0.1 is not free"):
            profiling.start_profiler_server(port)


def test_a_window_runs_through_the_step_its_duration_ends_in(tmp_path, monkeypatch):
    port = _free_port()
    server = profiling.start_profiler_server(port)
    x = torch.randn(4, 4, requires_grad=True)
    real = profiling.time.perf_counter

    def boundary(step, now):  # the loop's clock at this boundary, seconds since the first
        monkeypatch.setattr(profiling.time, "perf_counter", lambda: 100.0 + now)
        server.step_boundary(step)
        monkeypatch.setattr(profiling.time, "perf_counter", real)

    try:
        client = _Client(port, 100.0, tmp_path)
        _wait_for(lambda: server.request is not None)
        for step, now in ((1, 0.0), (2, 0.06), (3, 0.099)):  # 99 ms: not yet
            boundary(step, now)
            (x @ x).sum().backward()
        assert server.request.steps == [1, 3]
        boundary(4, 0.12)  # 100 ms passed during step 3: the window ends with it
        path, error = client.result()
        assert error is None and server.request is None
        assert sum(n.startswith("ProfilerStep#") for n in _names(path)) == 3
    finally:
        server.close()


def test_a_window_never_overlaps_the_traced_step(tmp_path):
    port = _free_port()
    server = profiling.start_profiler_server(port)
    x = torch.randn(4, 4, requires_grad=True)
    try:
        client = _Client(port, 1.0, tmp_path)
        _wait_for(lambda: server.request is not None)
        server.step_boundary(3, hold=True)  # step 3 is traced: the request waits
        assert server.request.state == "pending"
        server.step_boundary(4)
        assert server.request.state == "recording" and server.request.steps == [4, 4]
        (x @ x).sum().backward()
        server.step_boundary(5, hold=True)  # ended before the traced step
        assert server.request is None
        assert client.result()[1] is None
        client = _Client(port, 60_000.0, tmp_path)  # a long window, cut by the traced step
        _wait_for(lambda: server.request is not None)
        server.step_boundary(6)
        (x @ x).sum().backward()
        server.step_boundary(7)
        assert server.request.steps == [6, 7]
        (x @ x).sum().backward()
        server.step_boundary(8, hold=True)
        path, error = client.result()
        assert error is None
        assert sum(n.startswith("ProfilerStep#") for n in _names(path)) == 2
    finally:
        server.close()


def _toy_run(tmp_path: Path, flags: list[str], epochs: int = 1, name: str = "run",
             val_interval: int = 1) -> dict:
    data = tmp_path / "data" / "dente"
    if not data.exists():
        data.mkdir(parents=True)
        rng = np.random.default_rng(0)
        for i in range(8):
            write_tif(str(data / f"img_{i:02d}.tif"),
                      rng.uniform(0.1, 1.0, (40, 40)).astype(np.float32))
    cfg = {
        "data_base_dir": str(tmp_path / "data"), "data_source": "dente", "train_split": 0.75,
        "run_dir": str(tmp_path / name),
        "autoencoder_def": {"spatial_dims": 2, "in_channels": 1, "out_channels": 1,
                            "latent_channels": 3, "channels": [8, 16], "num_res_blocks": 1,
                            "norm_num_groups": 4, "norm_eps": 1e-6,
                            "attention_levels": [False, False],
                            "with_encoder_nonlocal_attn": True,
                            "with_decoder_nonlocal_attn": True},
        "autoencoder_train": {"batch_size": 2, "patch_size": [32, 32], "lr": 1e-3,
                              "perceptual_weight": 0.0, "kl_weight": 1e-3, "recon_loss": "l1",
                              "adv_enabled": False, "max_epochs": epochs,
                              "val_interval": val_interval},
        "wandb": {"enabled": False},
    }
    (tmp_path / f"{name}.json").write_text(json.dumps(cfg))
    return train_vae(["-c", str(tmp_path / f"{name}.json"), "--device", "cpu", "--no-wandb",
                      "--num-workers", "1", *flags])


def test_train_vae_traces_the_asked_step(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("PTI_LPIPS_WEIGHTS", "none")
    result = _toy_run(tmp_path, ["--trace-at-step", "2"])
    assert result["total_step"] == 3  # 6 train images in batches of 2
    assert "[INFO] profiler trace captured at step 2" in capsys.readouterr().out
    events = _trace_events(tmp_path / "run" / "traces")
    names = {e.get("name", "") for e in events}
    # one step: the forward's convolutions and the backward's autograd nodes
    assert any("conv" in n for n in names) and any("Backward" in n for n in names)
    assert {"train.step", "h2d"} <= names  # the step's spans, its copy included


def test_train_vae_profile_port_serves_two_captures(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("PTI_LPIPS_WEIGHTS", "none")
    port = _free_port()
    out = {}
    # 36 steps, epoch 0 alone validated: room for both captures, little else to wait for
    trainer = threading.Thread(target=lambda: out.setdefault("result", _toy_run(
        tmp_path, ["--profile-port", str(port)], epochs=12, val_interval=100)), daemon=True)
    trainer.start()
    paths = []
    for duration_ms in (1.0, 30.0):  # one step, then a few
        path, error = _Client(port, duration_ms, tmp_path / "tb", retry_s=25.0).result()
        assert error is None, error
        paths.append(path)
    trainer.join(timeout=120)  # the rest of the run: seconds, but the suite may load the host
    assert not trainer.is_alive() and out["result"]["total_step"] == 36
    assert f"[INFO] profiler server on 127.0.0.1:{port}" in capsys.readouterr().out
    for path in paths:  # the training thread's forward convolutions and autograd nodes
        names = _names(path)
        assert any(n.startswith("aten::") and "conv" in n for n in names)
        assert any("Backward" in n for n in names)
        assert any(n.startswith("ProfilerStep#") for n in names)
        assert "train.step" in names and "h2d" in names


def _losses(run_dir: Path) -> list[dict]:
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in ("time_per_epoch", "_time")} for r in rows]


def test_train_vae_profile_port_without_a_request_changes_no_bit(tmp_path, monkeypatch):
    monkeypatch.setenv("PTI_LPIPS_WEIGHTS", "none")
    plain = _toy_run(tmp_path, [], epochs=2, name="plain")
    served = _toy_run(tmp_path, ["--profile-port", str(_free_port())], epochs=2, name="served")
    assert plain == served
    assert _losses(tmp_path / "plain") == _losses(tmp_path / "served")
    ours = torch.load(tmp_path / "served" / "trained_weights" / "autoencoder_last.pth")
    theirs = torch.load(tmp_path / "plain" / "trained_weights" / "autoencoder_last.pth")
    assert all(torch.equal(ours[k], theirs[k]) for k in theirs)


# -- the program's spans ------------------------------------------------------------------
def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_a_run_with_no_profiler_records_no_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("PTI_LPIPS_WEIGHTS", "none")
    profiling.take_spans()
    calls = []
    with profiling.span("outer", arg=lambda: calls.append(1) or 1.0):
        _toy_run(tmp_path, [])
    assert profiling.take_spans() == [] and calls == []  # not even the argument is worked out


def test_a_profiled_run_records_the_loops_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("PTI_LPIPS_WEIGHTS", "none")
    batches = ShardedDataLoader._batches

    def slow_start(self):  # the first batch of an epoch comes well after its first request
        time.sleep(0.5)
        yield from batches(self)

    monkeypatch.setattr(ShardedDataLoader, "_batches", slow_start)
    profiling.take_spans()
    with _cpu_profile() as prof:
        result = _toy_run(tmp_path, [], epochs=2)
    spans = profiling.take_spans()
    assert result["total_step"] == 6  # 6 train images in batches of 2, 2 epochs
    names = [s.name for s in spans]
    assert set(names) == {"loader.wait", "train.step", "h2d", "train.epoch_end", "val.epoch",
                          "ckpt.save"}
    assert all(0 < s.start_ns <= s.end_ns for s in spans)
    # every span is a range of the CPU trace too
    events = [e.name for e in prof.events()]
    assert all(events.count(n) == names.count(n) for n in set(names))
    steps = [s for s in spans if s.name == "train.step"]
    assert [(s.step, s.arg, s.parent) for s in steps] == [(n, n, None) for n in range(1, 7)]
    for i, s in enumerate(spans):
        if s.parent is not None:  # a child lies inside its parent and shares its step
            up = spans[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns and s.step == up.step
    h2d = [s for s in spans if s.name == "h2d"]
    assert [spans[s.parent].name for s in h2d] == ["train.step"] * 3 + ["val.epoch"] + \
        ["train.step"] * 3 + ["val.epoch"]
    assert all(s.arg == 2 * 32 * 32 * 4 + 2 * 4 for s in h2d)  # images and mask, f32
    tops = [s.name for s in spans if s.parent is None and s.name != "loader.wait"]
    assert tops == (["train.step"] * 3 + ["train.epoch_end", "val.epoch", "ckpt.save"]) * 2
    ends = [s for s in spans if s.name in ("train.epoch_end", "val.epoch", "ckpt.save")]
    assert [s.step for s in ends] == [3, 3, 3, 6, 6, 6]
    # each epoch's first request, train or validation, finds the prefetch queue empty
    waits = [(s.parent is None, s.arg) for s in spans if s.name == "loader.wait"]
    train_waits = [arg for top, arg in waits if top]
    val_waits = [arg for top, arg in waits if not top]
    assert len(train_waits) == 2 * 4 and len(val_waits) == 2 * 2  # each epoch's last: its end
    assert train_waits[0] == train_waits[4] == 0 and val_waits[0] == val_waits[2] == 0
    assert all(spans[s.parent].name == "val.epoch" for s in spans
               if s.name == "loader.wait" and s.parent is not None)


def test_a_range_inside_a_span_lies_within_it_on_the_shared_clock():
    profiling.take_spans()
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            time.sleep(0.005)
            with torch.profiler.record_function("inner"):
                torch.ones(64, 64).sum()
            time.sleep(0.005)
    (outer,) = profiling.take_spans()
    inner = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    assert len(inner) == 1
    assert outer.start_ns < inner[0].start_ns() <= inner[0].end_ns() < outer.end_ns
    assert abs(profiling.now_ns() - time.time_ns()) < 5e7  # the wall clock


def test_spans_nest_by_thread_and_take_clears_the_list():
    profiling.take_spans()
    with _cpu_profile():
        with profiling.span("a", step=7):
            with profiling.span("b", arg=lambda: 3):
                pass
            with profiling.span("c", step=8, arg=0.5):
                pass
        with profiling.span("d"):
            pass
    spans = profiling.take_spans()
    assert [(s.name, s.parent, s.step, s.arg) for s in spans] == [
        ("a", None, 7, None), ("b", 0, 7, 3), ("c", 0, 8, 0.5), ("d", None, None, None)]
    assert profiling.take_spans() == []
    with _cpu_profile():
        with profiling.span("open"):
            assert [s.end_ns for s in profiling.take_spans()] == [0]  # taken while open
            with profiling.span("after"):
                pass
    assert [(s.name, s.parent) for s in profiling.take_spans()] == [("after", None)]
