"""Warm-process daemon for the CLI.

Why this exists: the reference workflow is "run a short-lived process
per command" (its trainer is a compiled .so, reference bpe.cpp:597).  A
fresh JAX process pays backend start-up and executable loading on
every command, even when the persistent compilation cache
(utils/jaxcache.py) hits.  The answer bazel/gradle use applies: keep
ONE warm server process holding the compiled executables and make the
user-facing command a thin client.  Whether that still pays on a GPU
host is an open question: chip_smoke.py times a fresh-process CLI
train, cold and warm on the persistent cache.

Protocol (newline-delimited JSON over a unix socket):

  request  {"argv": [...], "stdin": str, "cwd": str}
  response {"rc": int, "stdout": str, "stderr": str}

Special argv values: ``["__ping__"]`` health check, ``["__stop__"]``
clean shutdown.  The server is single-threaded by design — commands
serialize on the one device anyway, and per-request ``os.chdir`` stays
race-free.

Usage:

  shredword-tpu daemon start|stop|status      # explicit lifecycle
  SHREDWORD_DAEMON=1 shredword-tpu train ...  # auto-start + route

The daemon auto-exits after ``--idle-timeout`` seconds (default 1 h)
without a request so it never keeps holding the device.
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

_MAX_LINE = 512 * 2**20     # refuse absurd requests (corrupt stream)


def default_socket_path() -> str:
    return os.environ.get(
        "SHREDWORD_DAEMON_SOCKET",
        os.path.join("/tmp", f"shredword_daemon_{os.getuid()}.sock"))


# ---------------------------------------------------------------------------
# server


def _handle(req: dict) -> dict:
    """Run one CLI command in-process with captured stdio."""
    argv = req.get("argv", [])
    out, err = io.StringIO(), io.StringIO()
    rc = 0
    old_cwd = os.getcwd()
    old_stdin = sys.stdin
    try:
        cwd = req.get("cwd")
        if cwd:
            os.chdir(cwd)
        sys.stdin = io.StringIO(req.get("stdin", ""))
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            from . import cli
            try:
                rc = cli.main(argv)
            except SystemExit as e:      # argparse errors exit
                rc = int(e.code or 0)
            except Exception:            # command failed; daemon lives on
                import traceback
                traceback.print_exc()
                rc = 1
    finally:
        sys.stdin = old_stdin
        os.chdir(old_cwd)
    return {"rc": rc, "stdout": out.getvalue(), "stderr": err.getvalue()}


def _recv_line(conn: socket.socket) -> bytes | None:
    chunks = []
    total = 0
    while True:
        b = conn.recv(1 << 20)
        if not b:
            return None
        chunks.append(b)
        total += len(b)
        if b.endswith(b"\n"):
            return b"".join(chunks)
        if total > _MAX_LINE:
            return None


def serve(socket_path: str | None = None,
          idle_timeout: float = 3600.0) -> int:
    """Run the daemon loop (blocks).  Returns process exit code."""
    # The server must NEVER route its own command handling back through
    # daemon clients: with SHREDWORD_DAEMON=1 inherited from the
    # spawning client, cli.main inside _handle would try to reach the
    # daemon (busy: itself), fail, and auto-start another server — a
    # cross-process spawn loop (observed live in r05 before this guard).
    os.environ["_SHREDWORD_IN_DAEMON"] = "1"
    path = socket_path or default_socket_path()
    # Exclusive lock: a second `serve` on the same path must exit, not
    # silently steal the socket from a live (possibly busy) server.
    import fcntl
    lock_fd = os.open(path + ".lock", os.O_CREAT | os.O_RDWR, 0o600)
    try:
        fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        os.close(lock_fd)
        print(f"[daemon] another server owns {path}; exiting",
              flush=True)
        return 1
    with contextlib.suppress(FileNotFoundError):
        os.unlink(path)          # stale socket only: the lock is ours
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    os.chmod(path, 0o600)
    srv.listen(16)               # busy-server clients queue here
    srv.settimeout(idle_timeout)
    # initialize the backend + persistent cache once, up front, so the
    # first command doesn't also pay backend discovery
    from .utils.jaxcache import ensure_jax_cache
    ensure_jax_cache()
    print(f"[daemon] serving on {path} (pid {os.getpid()})", flush=True)
    try:
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                print("[daemon] idle timeout, exiting", flush=True)
                return 0
            with conn:
                line = _recv_line(conn)
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except ValueError:
                    continue
                argv = req.get("argv", [])
                if argv == ["__ping__"]:
                    resp = {"rc": 0, "stdout": "pong\n", "stderr": ""}
                elif argv == ["__stop__"]:
                    conn.sendall(json.dumps(
                        {"rc": 0, "stdout": "stopping\n",
                         "stderr": ""}).encode() + b"\n")
                    return 0
                else:
                    resp = _handle(req)
                with contextlib.suppress(BrokenPipeError,
                                         ConnectionResetError):
                    conn.sendall(json.dumps(resp).encode() + b"\n")
    finally:
        srv.close()
        with contextlib.suppress(FileNotFoundError):
            os.unlink(path)
        with contextlib.suppress(OSError):
            os.close(lock_fd)    # releases the flock
        with contextlib.suppress(FileNotFoundError):
            os.unlink(path + ".lock")


# ---------------------------------------------------------------------------
# client


def request(argv: list[str], *, socket_path: str | None = None,
            stdin_text: str = "", timeout: float = 24 * 3600.0,
            ) -> dict | None:
    """Send one command to the daemon; None if it is not reachable."""
    path = socket_path or default_socket_path()
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.settimeout(timeout)
        c.connect(path)
    except OSError:
        return None
    try:
        req = {"argv": argv, "stdin": stdin_text, "cwd": os.getcwd()}
        c.sendall(json.dumps(req).encode() + b"\n")
        line = _recv_line(c)
        if not line:
            return None
        return json.loads(line)
    except (OSError, ValueError):
        return None
    finally:
        c.close()


def ping(socket_path: str | None = None) -> bool:
    r = request(["__ping__"], socket_path=socket_path, timeout=10.0)
    return bool(r) and r.get("stdout") == "pong\n"


def alive(socket_path: str | None = None) -> bool:
    """Connect-level liveness: a LISTENING server accepts the connect
    into its backlog even while busy running a long command, so this —
    unlike ping() — never mistakes a busy daemon for a dead one (the
    mistake that made clients spawn duplicate servers)."""
    path = socket_path or default_socket_path()
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.settimeout(5.0)
        c.connect(path)
        c.close()
        return True
    except OSError:
        return False


def start(socket_path: str | None = None, *, wait: float = 60.0,
          idle_timeout: float = 3600.0) -> bool:
    """Spawn a detached daemon process; True once it is reachable."""
    path = socket_path or default_socket_path()
    if alive(path):
        return True
    log_path = path + ".log"
    with open(log_path, "ab") as log:
        subprocess.Popen(
            [sys.executable, "-m", "shredword_tpu", "daemon", "serve",
             "--socket", path, "--idle-timeout", str(idle_timeout)],
            stdout=log, stderr=log, stdin=subprocess.DEVNULL,
            start_new_session=True)
    deadline = time.monotonic() + wait
    while time.monotonic() < deadline:
        if alive(path):
            return True
        time.sleep(0.2)
    return False


def stop(socket_path: str | None = None) -> bool:
    r = request(["__stop__"], socket_path=socket_path, timeout=10.0)
    return bool(r)


def run_client(argv: list[str], *, socket_path: str | None = None,
               auto_start: bool = True) -> int | None:
    """Route a CLI command through the daemon.  Returns the command's
    exit code, or None if no daemon could be reached/started (caller
    should fall back to running locally).

    Liveness is the connect probe, not a ping: a daemon busy with a
    long train cannot answer a ping, but its listen backlog still
    accepts the connect and this client simply waits its turn."""
    path = socket_path or default_socket_path()
    if not alive(path) and not (auto_start and start(path)):
        return None
    stdin_text = ""
    if "-" in argv and not sys.stdin.isatty():
        stdin_text = sys.stdin.read()
    r = request(argv, socket_path=path, stdin_text=stdin_text)
    if r is None:
        return None
    sys.stdout.write(r.get("stdout", ""))
    sys.stderr.write(r.get("stderr", ""))
    return int(r.get("rc", 1))
