"""Daemon-mode tests: the warm-process CLI server (daemon.py).

The daemon exists because a fresh JAX process pays backend start-up and
executable loading on every run.  These tests drive
the full socket protocol on the CPU backend: server in a subprocess,
thin clients in this process, results compared against the direct
in-process CLI.
"""

import os
import subprocess
import sys
import time

import pytest

from shredword_tpu import daemon
from shredword_tpu.cli import main

pytestmark = pytest.mark.skipif(
    not hasattr(os, "getuid"), reason="unix-socket daemon")


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """A live daemon subprocess on the CPU backend."""
    d = tmp_path_factory.mktemp("daemon")
    sock = str(d / "d.sock")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # deliberately hostile env: routing ON and pointed at this daemon's
    # own socket.  serve() must set _SHREDWORD_IN_DAEMON so commands it
    # handles execute locally — without that guard the daemon's own
    # handler becomes a client of itself and auto-starts duplicate
    # servers (the r05 spawn-loop incident).
    env["SHREDWORD_DAEMON"] = "1"
    env["SHREDWORD_DAEMON_SOCKET"] = sock
    env.pop("_SHREDWORD_IN_DAEMON", None)
    env.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    log = open(str(d / "d.log"), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "shredword_tpu", "daemon", "serve",
         "--socket", sock, "--idle-timeout", "600"],
        stdout=log, stderr=log, stdin=subprocess.DEVNULL, env=env,
        cwd="/root/repo")
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if daemon.ping(sock):
            break
        if proc.poll() is not None:
            log.close()
            raise RuntimeError("daemon died: " +
                               open(str(d / "d.log")).read()[-2000:])
        time.sleep(0.2)
    else:
        proc.kill()
        raise RuntimeError("daemon did not come up")
    yield sock
    daemon.stop(sock)
    proc.wait(timeout=30)
    log.close()


def test_ping(server):
    assert daemon.ping(server)
    assert not daemon.ping(server + ".nonexistent")


def test_train_and_encode_via_daemon(server, small_corpus_file, tmp_path):
    model = str(tmp_path / "m.model")
    vocab = str(tmp_path / "m.vocab")
    r = daemon.request(
        ["train", "--corpus", small_corpus_file, "--model", model,
         "--vocab", vocab, "--vocab-size", "300", "--min-pair-freq", "2",
         "--backend", "cpu"], socket_path=server)
    assert r is not None and r["rc"] == 0, r
    assert "trained" in r["stdout"]
    assert os.path.exists(model) and os.path.exists(vocab)

    # encode through the daemon == encode in-process
    text = "the quick brown fox jumps over the lazy dog"
    r2 = daemon.request(["encode", "--model", model, "--input", "-"],
                        socket_path=server, stdin_text=text)
    assert r2 is not None and r2["rc"] == 0, r2
    import io
    from contextlib import redirect_stdout
    buf = io.StringIO()
    old_stdin = sys.stdin
    try:
        sys.stdin = io.StringIO(text)
        with redirect_stdout(buf):
            rc = main(["encode", "--model", model, "--input", "-"])
    finally:
        sys.stdin = old_stdin
    assert rc == 0
    assert r2["stdout"] == buf.getvalue()


def test_bad_command_keeps_daemon_alive(server):
    r = daemon.request(["info", "/nonexistent/model/path.model"],
                       socket_path=server)
    assert r is not None and r["rc"] != 0
    assert daemon.ping(server)          # still serving


def test_argparse_error_returns_rc(server):
    r = daemon.request(["train"], socket_path=server)  # missing required
    assert r is not None and r["rc"] != 0
    assert daemon.ping(server)


def test_env_routing_falls_back_without_daemon(tmp_path, monkeypatch,
                                               capsys):
    """SHREDWORD_DAEMON=1 with an unreachable socket and failing
    auto-start must fail with a clear message (no recursion, no hang)
    and must NOT run locally, where it could open the device beside a
    daemon that is still starting — the local `info` would raise on the
    missing file instead of returning 1."""
    monkeypatch.setenv("SHREDWORD_DAEMON", "1")
    monkeypatch.delenv("_SHREDWORD_IN_DAEMON", raising=False)
    monkeypatch.setenv("SHREDWORD_DAEMON_SOCKET",
                       str(tmp_path / "nope" / "x.sock"))
    monkeypatch.setattr(daemon, "start", lambda *a, **k: False)
    assert main(["info", str(tmp_path / "missing.model")]) == 1
    assert "daemon could not be reached" in capsys.readouterr().err


def test_second_serve_refuses_to_steal_socket(server):
    """A second `daemon serve` on a live socket must exit without
    stealing the path (flock guard) — stealing orphaned live servers
    and multiplied daemons in the r05 incident."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run(
        [sys.executable, "-m", "shredword_tpu", "daemon", "serve",
         "--socket", server, "--idle-timeout", "5"],
        capture_output=True, text=True, timeout=120, env=env,
        cwd="/root/repo")
    assert p.returncode == 1
    assert "another server owns" in p.stdout
    assert daemon.ping(server)          # original still serving


def test_alive_connect_probe(server, tmp_path):
    """alive() is a connect probe: true for the live server, false for
    a missing socket — and unlike ping it would stay true while the
    server is busy (the property that prevents duplicate auto-starts)."""
    assert daemon.alive(server)
    assert not daemon.alive(str(tmp_path / "missing.sock"))


def test_env_routing_through_daemon(server, monkeypatch, capsys):
    """SHREDWORD_DAEMON=1 routes a command through a live daemon and
    relays its stdout + exit code."""
    monkeypatch.setenv("SHREDWORD_DAEMON", "1")
    monkeypatch.setenv("SHREDWORD_DAEMON_SOCKET", server)
    monkeypatch.delenv("_SHREDWORD_IN_DAEMON", raising=False)
    rc = main(["info", "/nonexistent/model/path.model"])
    assert rc != 0                     # daemon caught the error -> rc
    out = capsys.readouterr()
    assert "Traceback" in out.err or out.err == "" or rc == 1
