"""Tracing, the program's spans and the live profiler endpoint (counterpart
of ``pti_ldm_vae_tpu/utils/profiling.py``).

Usage::

    with trace_if(run_dir / "traces", enabled=step == 20):
        train_step(...)

    with span("train.step", step=n, arg=n):   # recorded only while a profiler records
        ...
    spans = take_spans()                        # [Span(name, start_ns, end_ns, parent, step, arg)]

``trace_if`` runs ``torch.profiler`` over the block (CPU activity, and CUDA
activity when a card is in use) and writes a Chrome trace that TensorBoard's
profiler plugin reads (``tensorboard_trace_handler``) into ``log_dir``: the
kernels of the block appear there by name.

``span`` marks where the program's host time goes: the training loop, the
loader and validation open one around each piece of their work (README,
"Live profiling"). Spans are recorded only while a ``torch.profiler`` records
on the calling thread; otherwise a span costs one read of the profiler's
flag and records nothing. A recorded span keeps its name, its start and end
on :func:`now_ns` (the wall clock ``torch.profiler`` stamps its events with,
read through the monotonic counter, so a span and a kernel of the same trace
sit side by side with no conversion), the index of the span enclosing it on
the same thread (``parent``), the trainer's global step (``step``, taken from
the parent when not given) and one optional number (``arg``). While the
profiler also records CPU activity, each span is a ``record_function`` range
of its name as well, so the Chrome trace shows it beside the kernels; under a
profile of the device's activity alone it adds no host event. The spans stay
in memory until :func:`take_spans` hands them over and clears the list.

``start_profiler_server(port)`` is the counterpart of
``jax.profiler.start_server``: a daemon thread listens on ``127.0.0.1:port``
(loopback only: the endpoint is unauthenticated; reach it from another
machine through an ssh tunnel) for capture requests, which name a duration
in ms as TensorBoard's "Capture profile" does. The listener does not profile
on its own thread (``torch.profiler`` records the CPU ops of the thread it
is started on and of the autograd threads that thread drives): it posts the
request, and the training loop records the window itself at its step
boundaries::

    server = start_profiler_server(9012, device=device)
    for step, batch in enumerate(loader, start=1):
        if server.request is not None:   # one attribute read; nothing else without a request
            server.step_boundary(step)
        train_step(...)
    server.close()

A pending request opens a ``torch.profiler`` window at the next boundary;
the window runs through the step at which ``duration_ms`` of wall time has
passed (so it holds at least one whole step), then the device is
synchronized, so that the window's kernels end inside the trace, and the
Chrome trace goes back over the request's connection. One ``profile`` object
serves every window of a process, started and stopped per window. The client
writes the trace in ``tensorboard_trace_handler``'s layout,
``<logdir>/<worker>.<ns>.pt.trace.json``::

    python -m pti_ldm_vae_tpu_torch.utils.profiling --port 9012 --duration-ms 2000 --logdir tb/

(or :func:`capture` from Python). One capture is open at a time; a second
request while one is open, a request the run ends before serving, and a port
where nothing listens each give the client a :class:`CaptureError`; a taken
port makes ``start_profiler_server`` raise. Every wait has a time limit.

Protocol, one request per connection: the client sends one JSON line
``{"duration_ms": D, "timeout_s": T}``; the server answers one JSON line,
``{"error": "..."}`` or ``{"ok": true, "worker": ..., "steps": [first,
last], "window_ms": ..., "bytes": N}`` followed by the N bytes of the trace.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import tempfile
import threading
import time
import traceback
import warnings
from pathlib import Path
from typing import Callable, NamedTuple

import torch

__all__ = ["start_profiler_server", "ProfilerServer", "capture", "CaptureError", "trace_if",
           "Span", "span", "take_spans", "now_ns"]

HOST = "127.0.0.1"
IO_TIMEOUT_S = 30.0  # reading a request, writing a reply
DEFAULT_TIMEOUT_S = 120.0  # a capture's whole wait: its window's start, length and export
_MAX_REQUEST = 4096
_REPLY_SLACK_S = 5.0


# -- the program's spans --------------------------------------------------------------
_WALL_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
_recording = torch._C._autograd._profiler_enabled  # this thread's profiler is on
# a range in a CPU-activity trace; adds nothing where no RecordFunction callback is active
_range = torch._C._profiler._RecordFunctionFast


def now_ns() -> int:
    """The wall clock in ns (``torch.profiler``'s), read through the monotonic counter."""
    return time.perf_counter_ns() + _WALL_OFFSET_NS


class Span(NamedTuple):
    """A recorded span. ``end_ns`` is 0 while the span is open; ``parent``
    indexes the list :func:`take_spans` returns (None at the top)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    step: int | None
    arg: float | None


_lock = threading.Lock()
_spans: list[list] = []  # [name, start_ns, end_ns, parent's record, step, arg] while recording
_open = threading.local()  # per thread: the stack of open records


class _Span:
    """A span being recorded (:func:`span`)."""

    __slots__ = ("name", "step", "arg", "_record", "_range")

    def __init__(self, name: str, step: int | None, arg: float | Callable[[], float] | None):
        self.name, self.step, self.arg = name, step, arg

    def __enter__(self) -> None:
        stack = _open.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        step = self.step if self.step is not None or parent is None else parent[4]
        arg = self.arg() if callable(self.arg) else self.arg
        self._record = [self.name, now_ns(), 0, parent, step, arg]
        stack.append(self._record)
        with _lock:
            _spans.append(self._record)
        self._range = _range(self.name)
        self._range.__enter__()

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        self._record[2] = now_ns()
        _open.stack.pop()


_OFF = contextlib.nullcontext()


def span(name: str, *, step: int | None = None,
         arg: float | Callable[[], float] | None = None):
    """A context that records the enclosed block as the span ``name`` while
    a profiler records on this thread (module docstring), else does nothing.
    ``arg`` is a number, or a function returning one, called only while
    recording."""
    return _Span(name, step, arg) if _recording() else _OFF


def take_spans() -> list[Span]:
    """The spans recorded since the last take, in the order they opened; the
    list is cleared. A span whose parent was taken before has no parent."""
    global _spans
    with _lock:
        taken, _spans = _spans, []
    index = {id(record): i for i, record in enumerate(taken)}
    return [Span(name, start, end, index.get(id(parent)), step, arg)
            for name, start, end, parent, step, arg in taken]


class CaptureError(RuntimeError):
    """A capture the endpoint refused or could not serve."""


class _Capture:
    """One request: pending, then recording, then done (with a trace or an error)."""

    def __init__(self, duration_ms: float, timeout_s: float):
        self.duration_ms = duration_ms
        self.timeout_s = timeout_s
        self.state = "pending"
        self.t0 = 0.0
        self.steps = [0, 0]
        self.window_ms = 0.0
        self.trace: bytes | None = None
        self.error: str | None = None
        self.done = threading.Event()


class ProfilerServer:
    """The listener of :func:`start_profiler_server` and the window the
    training loop records for it. ``request`` is the open capture, None when
    there is none: the loop reads it at every step boundary and calls
    :meth:`step_boundary` only when it is set."""

    def __init__(self, port: int, device: torch.device | str | None = None):
        self.port = port
        self.device = torch.device(device if device is not None else "cpu")
        self.worker = f"{socket.gethostname()}_{os.getpid()}"
        self.request: _Capture | None = None
        self._lock = threading.Lock()
        self._closed = False
        self._prof = None
        self._exporting: _Capture | None = None
        try:
            self._sock = socket.create_server((HOST, port))
        except OSError as exc:
            raise OSError(exc.errno, f"profiler port {port} on {HOST} is not free: "
                                     f"{exc.strerror}") from exc
        self._sock.settimeout(0.2)  # the accept loop looks at ``_closed`` this often
        self._thread = threading.Thread(target=self._serve, name=f"profiler-server-{port}",
                                        daemon=True)
        self._thread.start()

    # -- listener side ----------------------------------------------------------
    def _serve(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except TimeoutError:
                continue
            except OSError:  # the socket was closed
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        with conn:
            conn.settimeout(IO_TIMEOUT_S)
            try:
                cap = self._open(*_read_request(conn))
            except (CaptureError, ValueError, OSError) as exc:
                _reply(conn, {"error": str(exc)})
                return
            if not cap.done.wait(cap.timeout_s):
                with self._lock:
                    if cap.state == "pending":  # never started: withdraw it
                        self.request = None
                        cap.state = "done"
                        cap.error = f"no step boundary came within {cap.timeout_s:g} s"
                    elif cap.state == "recording":
                        cap.error = (f"the window did not end within {cap.timeout_s:g} s "
                                     f"(duration {cap.duration_ms:g} ms)")
            if cap.error is not None or cap.trace is None:
                _reply(conn, {"error": cap.error or "the window ended without a trace"})
                return
            # a slow link (an ssh tunnel) gets a second for each MB of the trace
            conn.settimeout(IO_TIMEOUT_S + len(cap.trace) / 1e6)
            _reply(conn, {"ok": True, "worker": self.worker, "steps": cap.steps,
                          "window_ms": cap.window_ms, "bytes": len(cap.trace)}, cap.trace)

    def _open(self, duration_ms: float, timeout_s: float) -> _Capture:
        with self._lock:
            if self._closed:
                raise CaptureError("the run has ended")
            if self.request is not None:
                raise CaptureError(f"a capture is already open on port {self.port} "
                                   f"({self.request.state}, {self.request.duration_ms:g} ms)")
            self.request = _Capture(duration_ms, timeout_s)
            return self.request

    # -- training-loop side -------------------------------------------------------
    def step_boundary(self, step: int, *, hold: bool = False) -> None:
        """The training loop is about to run ``step``: open a pending
        capture's window from this step, or end a recording one whose
        duration has passed. ``hold``: another profiler traces this step
        (``--trace-at-step``), so a recording window ends here and a pending
        one waits for the next boundary."""
        cap = self.request
        if cap is None:
            return
        if cap.state == "recording":
            if hold or (time.perf_counter() - cap.t0) * 1e3 >= cap.duration_ms:
                self._end(cap)
            else:
                cap.steps[1] = step
                self._prof.step()
            return
        if hold:
            return
        with self._lock:
            if self.request is not cap or cap.state != "pending":  # withdrawn meanwhile
                return
            cap.state = "recording"
        self._start(cap, step)

    def _start(self, cap: _Capture, step: int) -> None:
        try:
            if self._prof is None:
                from torch.profiler import ProfilerAction, ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                # one profile for every window of the run, started and stopped per
                # window; the schedule only marks the steps (ProfilerStep#N) in the trace
                self._prof = profile(activities=activities,
                                     schedule=lambda _: ProfilerAction.RECORD,
                                     on_trace_ready=self._export)
            with warnings.catch_warnings():
                # "Profiler clears events at the end of each cycle": each window is its own trace
                warnings.filterwarnings("ignore",
                                        message=".*clears events at the end of each cycle")
                self._prof.start()
        except Exception:  # the run goes on; the client gets the traceback
            self._finish(cap, "torch.profiler failed to start:\n" + traceback.format_exc())
            return
        cap.steps = [step, step]
        cap.t0 = time.perf_counter()  # the window's duration counts from its first step

    def _end(self, cap: _Capture) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        cap.window_ms = (time.perf_counter() - cap.t0) * 1e3
        self._exporting = cap
        error = None
        try:
            self._prof.stop()  # -> _export
        except Exception:  # the run goes on; the client gets the traceback
            error = "torch.profiler failed:\n" + traceback.format_exc()
        finally:
            self._exporting = None
        self._finish(cap, error)

    def _finish(self, cap: _Capture, error: str | None) -> None:
        if error is not None:
            cap.error = error
            self._prof = None  # a fresh profile for the next window
        with self._lock:
            cap.state = "done"
            self.request = None
        cap.done.set()

    def _export(self, prof) -> None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            self._exporting.trace = Path(path).read_bytes()

    def close(self) -> None:
        """End of the run: a recording window ends here and its trace goes
        out; a pending capture gets an error; the port closes. Called from
        the training loop's thread."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            cap = self.request
            if cap is not None and cap.state == "pending":
                cap.error = "the run ended before the capture window started"
                cap.state = "done"
                self.request = None
                cap.done.set()
        if cap is not None and cap.state == "recording":
            self._end(cap)
        self._sock.close()
        self._thread.join(timeout=5.0)


def start_profiler_server(port: int = 9999, *,
                          device: torch.device | str | None = None) -> ProfilerServer:
    """Listen on ``127.0.0.1:port`` for capture requests (module docstring);
    ``device`` is the training loop's (CUDA activity is traced and the card
    synchronized at a window's end when it is a CUDA device). Returns the
    server, whose ``close()`` ends it; raises ``OSError`` when the port is
    taken."""
    return ProfilerServer(port, device)


def _read_line(conn: socket.socket) -> tuple[bytes, bytes]:
    """One header line from ``conn`` and whatever came after it."""
    buf = b""
    while b"\n" not in buf:
        chunk = conn.recv(_MAX_REQUEST)
        if not chunk:
            break
        buf += chunk
        if len(buf) > _MAX_REQUEST:
            raise ValueError(f"a header line longer than {_MAX_REQUEST} bytes")
    line, _, rest = buf.partition(b"\n")
    if not line:
        raise ValueError("the connection closed before a header line")
    return line, rest


def _read_request(conn: socket.socket) -> tuple[float, float]:
    req = json.loads(_read_line(conn)[0])
    duration_ms = float(req["duration_ms"])
    timeout_s = float(req.get("timeout_s", DEFAULT_TIMEOUT_S))
    if not duration_ms > 0 or not 0 < timeout_s <= 3600:
        raise ValueError(f"duration_ms {duration_ms} must be > 0 and timeout_s {timeout_s} "
                         "in (0, 3600]")
    return duration_ms, timeout_s


def _reply(conn: socket.socket, header: dict, payload: bytes = b"") -> None:
    with contextlib.suppress(OSError):  # a client that left takes no answer
        conn.sendall(json.dumps(header).encode() + b"\n" + payload)


def capture(port: int, duration_ms: float, logdir: str | os.PathLike,
            timeout_s: float = DEFAULT_TIMEOUT_S) -> Path:
    """Ask the server on ``127.0.0.1:port`` for a window of ``duration_ms``
    and write its trace to ``<logdir>/<worker>.<ns>.pt.trace.json``; returns
    the path. Raises :class:`CaptureError` when nothing answers, when the
    server refuses or cannot serve the request, or when no answer comes
    within ``timeout_s`` (and a few seconds of slack)."""
    try:
        conn = socket.create_connection((HOST, port), timeout=min(timeout_s, IO_TIMEOUT_S))
    except OSError as exc:
        raise CaptureError(f"nothing answers on {HOST}:{port}: {exc}") from exc
    with conn:
        try:
            conn.sendall(json.dumps({"duration_ms": duration_ms, "timeout_s": timeout_s}).encode()
                         + b"\n")
            conn.settimeout(timeout_s + _REPLY_SLACK_S)  # the server answers within timeout_s
            line, trace = _read_line(conn)
            header = json.loads(line)
            if "error" in header:
                raise CaptureError(f"{HOST}:{port}: {header['error']}")
            conn.settimeout(IO_TIMEOUT_S)  # for each read: the trace keeps coming
            buf = bytearray(header["bytes"])
            got = len(trace)
            buf[:got] = trace
            view = memoryview(buf)
            while got < len(buf):
                n = conn.recv_into(view[got:])
                if not n:
                    break
                got += n
        except (OSError, ValueError) as exc:
            raise CaptureError(f"{HOST}:{port}: no complete answer: {exc}") from exc
    if got != len(buf):
        raise CaptureError(f"{HOST}:{port}: {got} of {len(buf)} trace bytes came")
    trace = bytes(buf)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{header['worker']}.{time.time_ns()}.pt.trace.json"
    path.write_bytes(trace)
    return path


@contextlib.contextmanager
def trace_if(log_dir: str | os.PathLike, *, enabled: bool = True):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` when ``enabled``; CUDA activity is traced when CUDA is
    initialized in this process. The caller synchronizes the device inside the
    block, so that its kernels end within the trace."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(
        description="Capture a profiler window from a running train_vae --profile-port job on "
                    "this machine (a remote job: forward the port through ssh first)")
    parser.add_argument("--port", type=int, required=True,
                        help="the job's --profile-port (+ local rank under torchrun)")
    parser.add_argument("--duration-ms", type=float, default=2000.0,
                        help="the window's length; it always holds at least one whole step")
    parser.add_argument("--logdir", required=True,
                        help="where the Chrome trace goes (tensorboard --logdir reads it)")
    parser.add_argument("--timeout-s", type=float, default=DEFAULT_TIMEOUT_S,
                        help="how long to wait for the window to start, end and come back")
    args = parser.parse_args(argv)
    path = capture(args.port, args.duration_ms, args.logdir, timeout_s=args.timeout_s)
    print(path)
    return path


if __name__ == "__main__":
    main()
