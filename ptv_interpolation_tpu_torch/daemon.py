"""Persistent serving daemon: keep one warm process holding the CUDA
context and the kernels.

Counterpart of ``ptv_interpolation_tpu/daemon.py``. A CLI-shaped tool pays
a fresh-process cost on every invocation: the torch import, CUDA context
creation, loading the three kernel libraries (built by ``nvcc`` on first
use), cuBLAS set-up and the caching allocator's first growth. A resident
server pays it once; every later request runs at warm-process speed.

Protocol (newline-delimited JSON over a Unix socket, one request per
connection, served strictly serially — ONE process owns the card):

  client → server: {"entry": "interpolate"|"analyze", "argv": [...],
                    "cwd": "/abs/path"}
  server → client: {"t": "out", "d": "<chunk>"}   (stdout/stderr, streamed)
                   {"t": "rc", "d": <int>}         (final)

Special entries: "ping" (readiness / status) and "shutdown".

Opt-in only: the CLIs dispatch here when ``--daemon`` is passed or
``PTV_DAEMON=1`` is set, spawning the server on first use.  The server
exits after ``PTV_DAEMON_IDLE_S`` (default 1800 s) without requests, and
after a job that failed with a CUDA error (the context is then unusable:
the next request spawns a fresh server).  Each job's device comes from
its argv (the CLIs' ``--device``, default ``cuda``).

``PTV_DAEMON_PLATFORM=cpu`` skips the CUDA warm-up at start; otherwise a
server without a card fails to start.  ``PTV_DAEMON_DIR`` sets the
socket's directory; the socket's name differs from the JAX package's, so
a resident JAX daemon never answers the port's CLIs.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import time

__all__ = ["socket_path", "dispatch", "serve", "main"]

_IDLE_DEFAULT = 1800.0
_KERNEL_MODULES = ("fused_grid_knn", "fused_mad", "pallas_grid_knn")


def socket_path() -> str:
    d = os.environ.get("PTV_DAEMON_DIR") or f"/tmp/ptv-daemon-{os.getuid()}"
    return os.path.join(d, "torch-daemon.sock")


def _ensure_sock_dir(path: str) -> None:
    d = os.path.dirname(path)
    os.makedirs(d, mode=0o700, exist_ok=True)
    os.chmod(d, 0o700)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class _StreamWriter(io.TextIOBase):
    """File-like that frames writes as {"t":"out"} messages to the client."""

    def __init__(self, conn: socket.socket):
        self._conn = conn

    def writable(self):  # pragma: no cover - io protocol
        return True

    def write(self, s: str) -> int:
        if s:
            try:
                msg = json.dumps({"t": "out", "d": s}) + "\n"
                self._conn.sendall(msg.encode())
            except OSError:
                pass  # client went away; keep running the job
        return len(s)


def _run_entry(entry: str, argv: list[str]) -> int:
    os.environ["PTV_IN_DAEMON"] = "1"  # CLIs must not re-dispatch to us
    if entry == "interpolate":
        from ptv_interpolation_tpu_torch.cli.main import main as fn
    elif entry == "analyze":
        from ptv_interpolation_tpu_torch.cli.analyze_flow import main as fn
    else:
        raise ValueError(f"unknown entry {entry!r}")
    try:
        rc = fn(argv)
        return 0 if rc is None else int(rc)
    except SystemExit as e:  # argparse errors etc.
        code = e.code
        return code if isinstance(code, int) else (0 if code is None else 1)


def _warm_up() -> None:
    """Import the CLIs, create the CUDA context on the default card and
    load the three kernel libraries (built in parallel where missing)."""
    from concurrent.futures import ThreadPoolExecutor
    from importlib import import_module

    import torch

    import ptv_interpolation_tpu_torch.cli.analyze_flow  # noqa: F401
    import ptv_interpolation_tpu_torch.cli.main  # noqa: F401
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the daemon serves the card "
                           "(PTV_DAEMON_PLATFORM=cpu skips the warm-up)")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    mods = [import_module(f"ptv_interpolation_tpu_torch.ops.{m}")
            for m in _KERNEL_MODULES]
    with ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: m._kernel_lib(), mods))


def serve(path: str | None = None, idle_s: float | None = None) -> None:
    path = path or socket_path()
    if idle_s is None:
        idle_s = float(os.environ.get("PTV_DAEMON_IDLE_S", _IDLE_DEFAULT))
    _ensure_sock_dir(path)
    with contextlib.suppress(FileNotFoundError):
        os.unlink(path)

    if os.environ.get("PTV_DAEMON_PLATFORM") != "cpu":
        _warm_up()

    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    os.chmod(path, 0o600)
    srv.listen(8)
    srv.settimeout(min(idle_s, 60.0))
    last = time.time()
    try:
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                if time.time() - last > idle_s:
                    return
                continue
            last = time.time()
            with conn:
                try:
                    stop = _handle(conn)
                except Exception:
                    stop = False
            if stop:
                return
    finally:
        srv.close()
        with contextlib.suppress(FileNotFoundError):
            os.unlink(path)


def _is_cuda_error(e: BaseException) -> bool:
    """A failure that leaves the CUDA context unusable: torch's CUDA
    runtime errors and the kernel wrappers' launch errors. Running out of
    device memory is not one."""
    import torch
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    msg = str(e)
    return isinstance(e, RuntimeError) and ("CUDA error" in msg
                                            or "cudaError" in msg)


def _handle(conn: socket.socket) -> bool:
    """Serve one request; returns True if the server should shut down."""
    buf = b""
    conn.settimeout(30.0)
    while not buf.endswith(b"\n"):
        chunk = conn.recv(1 << 16)
        if not chunk:
            return False
        buf += chunk
    req = json.loads(buf.decode())
    entry = req.get("entry")

    def reply(rc: int) -> None:
        with contextlib.suppress(OSError):
            conn.sendall((json.dumps({"t": "rc", "d": rc}) + "\n").encode())

    if entry == "ping":
        reply(0)
        return False
    if entry == "shutdown":
        reply(0)
        return True

    conn.settimeout(None)  # jobs can run for minutes
    cwd = req.get("cwd")
    prev_cwd = os.getcwd()
    out = _StreamWriter(conn)
    poisoned = False
    try:
        if cwd:
            os.chdir(cwd)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            rc = _run_entry(entry, list(req.get("argv") or []))
    except Exception as e:
        poisoned = _is_cuda_error(e)
        out.write(f"daemon: job failed: {type(e).__name__}: {e}\n")
        if poisoned:
            out.write("daemon: CUDA error; the server exits and the next "
                      "request starts a fresh one\n")
        rc = 1
    finally:
        os.chdir(prev_cwd)
    reply(rc)
    return poisoned


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

def _connect(path: str, timeout: float = 1.0) -> socket.socket | None:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(path)
        return s
    except OSError:
        s.close()
        return None


def _request(sock: socket.socket, req: dict,
             echo: bool = True) -> int:
    try:
        sock.sendall((json.dumps(req) + "\n").encode())
    except OSError:
        return 1  # server tore down between connect and send
    sock.settimeout(None)
    buf = b""
    while True:
        try:
            chunk = sock.recv(1 << 16)
        except OSError:
            return 1  # reset during server shutdown = daemon gone
        if not chunk:
            return 1  # daemon died mid-job
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if not line.strip():
                continue
            msg = json.loads(line.decode())
            if msg["t"] == "out":
                if echo:
                    sys.stdout.write(msg["d"])
                    sys.stdout.flush()
            elif msg["t"] == "rc":
                return int(msg["d"])


def _spawn(path: str, wait_s: float = 120.0) -> bool:
    proc = subprocess.Popen(
        [sys.executable, "-m", "ptv_interpolation_tpu_torch.daemon", "serve",
         path],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    deadline = time.time() + wait_s
    while time.time() < deadline:
        if proc.poll() is not None:
            return False
        s = _connect(path)
        if s is not None:
            with s:
                if _request(s, {"entry": "ping"}, echo=False) == 0:
                    return True
        time.sleep(0.1)
    return False


def dispatch(entry: str, argv: list[str],
             spawn: bool = True) -> int | None:
    """Run `entry(argv)` on the daemon; None = unavailable (run inline)."""
    path = socket_path()
    s = _connect(path)
    if s is None and spawn:
        if not _spawn(path):
            return None
        s = _connect(path)
    if s is None:
        return None
    with s:
        return _request(s, {"entry": entry, "argv": argv,
                            "cwd": os.getcwd()})


def wants_daemon(args_daemon_flag: bool) -> bool:
    return bool(args_daemon_flag) or os.environ.get("PTV_DAEMON") == "1"


# ---------------------------------------------------------------------------
# ptv-torch-daemon control CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = argv[0] if argv else "status"
    path = argv[1] if len(argv) > 1 else socket_path()
    if cmd == "serve":                       # foreground server (internal)
        serve(path)
        return 0
    if cmd == "start":
        s = _connect(path)
        if s is not None:
            with s:
                if _request(s, {"entry": "ping"}, echo=False) == 0:
                    print(f"daemon already running at {path}")
                    return 0
        ok = _spawn(path)
        print(f"daemon {'started' if ok else 'FAILED to start'} at {path}")
        return 0 if ok else 1
    if cmd == "stop":
        s = _connect(path)
        if s is None:
            print("no daemon running")
            return 0
        with s:
            _request(s, {"entry": "shutdown"}, echo=False)
        # The server unlinks the socket on its way out; wait for that so a
        # status/start issued right after `stop` can't hit the closing
        # listener and read a half-dead daemon.
        deadline = time.time() + 10.0
        while time.time() < deadline and os.path.exists(path):
            time.sleep(0.05)
        print("daemon stopped")
        return 0
    if cmd == "status":
        s = _connect(path)
        if s is not None:
            with s:
                if _request(s, {"entry": "ping"}, echo=False) == 0:
                    print(f"daemon running at {path}")
                    return 0
        print("no daemon running")
        return 1
    print("usage: ptv-torch-daemon start|stop|status [socket]",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
