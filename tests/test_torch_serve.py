"""The port's HTTP service (``avsum_torch/serve/server.py``) on the CPU, as
``tests/test_serve.py`` and ``tests/test_serve_robustness.py`` drive the
JAX one: a server on port 0 with warmup, every endpoint, a served summary
equal to ``AVPipeline.summarize``'s, 400 / 404 / 403, uploads with 411 and
413, concurrent requests all answered in FIFO order, the access log; 429,
504 and 499 with a stub pipeline; the ``serve`` parser and the SIGTERM
drain of ``python -m avsum_torch.cli serve``. Tiny backbone, float32,
hidden-64 BiLSTM scorer drawn from a seed."""

import dataclasses
import glob
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from http.client import HTTPConnection

import pytest

from avsum_torch.cli.main import build_pipeline, main, summary_json
from avsum_torch.io.native import native_available
from avsum_torch.io.synthetic import write_scene_video
from avsum_torch.serve import ServeConfig, SummarizeServer
from avsum_torch.train.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = ["visual.backbone=tiny", "visual.dtype=float32", "audio.dtype=float32",
         "model.hidden_dim=64", "audio.silence_fallback=true"]

needs_native = pytest.mark.skipif(not native_available(),
                                  reason="libavsumio.so not built")


@pytest.fixture(scope="module")
def served():
    """(server, pipeline, scorer): a started server on a free port."""
    pipeline, model = build_pipeline(load_config(overrides=SLICE), "cpu",
                                     seed=1)
    srv = SummarizeServer(pipeline, ServeConfig(port=0, warmup=True),
                          model=model)
    srv.start(block=False)
    assert srv._ready.wait(timeout=120)
    yield srv, pipeline, model
    srv.stop()


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    stem = str(tmp_path_factory.mktemp("serve") / "clip")
    write_scene_video(stem, n_scenes=3, seed=5, fps=8.0, height=64, width=96,
                      scene_len_frames=(10, 16))
    return stem + ".y4m"


def _request(port, method, path, body=None, headers=None, raw=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = raw if raw is not None else (
            json.dumps(body) if body is not None else None)
        conn.request(method, path, body=data, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


@needs_native
def test_health_readiness_and_stats(served, video):
    srv = served[0]
    assert _request(srv.port, "GET", "/healthz") == (200, {"status": "ok"})
    assert _request(srv.port, "GET", "/readyz") == (200, {"status": "ready"})
    _, before = _request(srv.port, "GET", "/v1/stats")
    assert _request(srv.port, "POST", "/v1/summarize",
                    {"path": video})[0] == 200
    code, after = _request(srv.port, "GET", "/v1/stats")
    assert code == 200 and after["requests"] == before["requests"] + 1
    assert after["frames"] > before["frames"] and after["latency_ewma_s"] > 0


@needs_native
def test_served_summary_equals_summarize(served, video):
    srv, pipeline, model = served
    code, payload = _request(srv.port, "POST", "/v1/summarize",
                             {"path": video})
    assert code == 200, payload
    want = summary_json(pipeline.summarize(video, model))
    assert payload.pop("latency_s") >= 0
    assert payload["segments"] == want["segments"]
    assert payload["n_frames"] == want["n_frames"]
    assert payload["fps"] == want["fps"] and payload["video_id"] == "clip"
    assert payload["shot_scores"] == pytest.approx(want["shot_scores"],
                                                   abs=1e-6)


@needs_native
def test_budget_override(served, video):
    srv = served[0]
    frames = {}
    for budget in (0.9, 0.1):
        code, out = _request(srv.port, "POST", "/v1/summarize",
                             {"path": video, "budget_fraction": budget})
        assert code == 200
        frames[budget] = sum(b - a for a, b in out["segments"])
    assert frames[0.1] <= frames[0.9]


@needs_native
def test_errors_are_isolated(served, video):
    srv = served[0]
    assert _request(srv.port, "POST", "/v1/summarize",
                    {"path": "/nope/missing.y4m"})[0] == 404
    assert _request(srv.port, "POST", "/v1/summarize", {"nope": 1})[0] == 400
    assert _request(srv.port, "POST", "/v1/summarize", raw=b"[1]")[0] == 400
    assert _request(srv.port, "GET", "/nope")[0] == 404
    assert _request(srv.port, "POST", "/nope")[0] == 404
    bad = os.path.join(os.path.dirname(video), "bad.y4m")
    with open(bad, "wb") as fh:
        fh.write(b"junk")
    assert _request(srv.port, "POST", "/v1/summarize", {"path": bad})[0] == 500
    assert _request(srv.port, "POST", "/v1/summarize",
                    {"path": video})[0] == 200


@needs_native
def test_upload(served, video):
    srv = served[0]
    with open(video, "rb") as fh:
        blob = fh.read()
    code, up = _request(srv.port, "POST", "/v1/summarize/upload?ext=y4m",
                        raw=blob)
    assert code == 200, up
    assert "video_id" not in up and up["n_frames"] > 0
    code, by_type = _request(srv.port, "POST", "/v1/summarize/upload",
                             raw=blob,
                             headers={"Content-Type": "application/vnd.y4m"})
    assert code == 200 and by_type["segments"] == up["segments"]
    assert not glob.glob(os.path.join(tempfile.gettempdir(), "avsum_up_*"))


@needs_native
def test_upload_rejections(served):
    srv = served[0]
    code, out = _request(srv.port, "POST", "/v1/summarize/upload", raw=b"xx")
    assert code == 400 and "ext" in out["error"]
    # no Content-Length: a chunked body
    conn = HTTPConnection("127.0.0.1", srv.port, timeout=60)
    try:
        conn.putrequest("POST", "/v1/summarize/upload?ext=y4m")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        conn.send(b"2\r\nxx\r\n0\r\n\r\n")
        resp = conn.getresponse()
        assert resp.status == 411
    finally:
        conn.close()
    old = srv.serve_config
    try:
        srv.serve_config = dataclasses.replace(old, max_upload_mb=1)
        code, out = _request(srv.port, "POST", "/v1/summarize/upload?ext=y4m",
                             raw=b"\0" * (2 * 1024 * 1024))
        assert code == 413, out
        srv.serve_config = dataclasses.replace(old, max_upload_mb=0)
        code, out = _request(srv.port, "POST", "/v1/summarize/upload?ext=y4m",
                             raw=b"xx")
        assert code == 404 and "disabled" in out["error"]
    finally:
        srv.serve_config = old
    assert _request(srv.port, "GET", "/healthz")[0] == 200


@needs_native
def test_concurrent_requests_all_succeed(served, video):
    srv = served[0]
    results = [None] * 5

    def client(i):
        results[i] = _request(srv.port, "POST", "/v1/summarize",
                              {"path": video})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(code == 200 for code, _ in results), results
    assert len({tuple(p["shot_scores"]) for _, p in results}) == 1


@needs_native
def test_access_log(tmp_path, video):
    pipeline, model = build_pipeline(load_config(overrides=SLICE), "cpu")
    log_path = str(tmp_path / "access.jsonl")
    srv = SummarizeServer(pipeline, ServeConfig(port=0, warmup=False,
                                                access_log=log_path), model)
    srv.start(block=False)
    try:
        assert _request(srv.port, "POST", "/v1/summarize",
                        {"path": video})[0] == 200
    finally:
        srv.stop()
    lines = [json.loads(line) for line in open(log_path)]
    assert lines[0]["code"] == 200 and lines[0]["path"] == video
    assert lines[0]["n_frames"] > 0 and lines[0]["latency_s"] > 0


# -- admission control, deadlines and cancellation, with a stub pipeline --

class _StubPipeline:
    """begin() may block; the finisher returns a minimal summary."""

    def __init__(self, begin_delay=0.0, finish_delay=0.0):
        self.begin_delay = begin_delay
        self.finish_delay = finish_delay
        self.started = []

    def summarize_begin(self, path, model, budget):
        self.started.append(path)
        time.sleep(self.begin_delay)

        def finish():
            time.sleep(self.finish_delay)
            return {"video_id": "stub", "n_frames": 10, "fps": 1.0,
                    "segments": [(0, 2)], "scores": [0.5]}

        return finish


@pytest.fixture()
def make_server():
    """A worker-only server (no socket) around a stub pipeline."""
    servers = []

    def _make(stub, **serve_kw):
        srv = SummarizeServer(stub, ServeConfig(warmup=False, **serve_kw))
        srv._ready.set()
        srv._running = True
        srv._worker = threading.Thread(target=srv._worker_loop, daemon=True)
        srv._worker.start()
        servers.append(srv)
        return srv

    yield _make
    for srv in servers:
        srv._running = False
        srv._worker.join(timeout=10)
        assert not srv._worker.is_alive()


@pytest.fixture()
def stub_video(tmp_path):
    p = tmp_path / "clip.y4m"
    p.write_bytes(b"stub")
    return str(p)


def _wait_for(cond, limit=10.0):
    deadline = time.time() + limit
    while time.time() < deadline and not cond():
        time.sleep(0.05)
    return cond()


def test_media_root_containment(make_server, tmp_path, stub_video):
    root = tmp_path / "media"
    root.mkdir()
    (root / "ok.y4m").write_bytes(b"stub")
    srv = make_server(_StubPipeline(), media_root=str(root))
    assert srv.handle_summarize(stub_video)[0] == 403
    assert srv.handle_summarize(str(root / ".." / "clip.y4m"))[0] == 403
    assert srv.handle_summarize("/etc/passwd")[0] == 403
    assert srv.handle_summarize(str(root / "missing.y4m"))[0] == 404
    assert srv.handle_summarize(str(root / "ok.y4m"))[0] == 200


def test_flood_gets_429(make_server, stub_video):
    srv = make_server(_StubPipeline(begin_delay=1.0), max_queue=2)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(srv.handle_summarize(stub_video)))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    codes = sorted(c for c, _ in results)
    assert codes.count(429) >= 4 and set(codes) <= {200, 429}, codes
    assert srv._stats["rejected"] >= 4
    assert srv.handle_summarize(stub_video)[0] == 200


def test_slow_request_times_out_504_and_is_skipped(make_server, stub_video):
    stub = _StubPipeline(begin_delay=1.5)
    srv = make_server(stub, request_timeout_s=0.3)
    first = threading.Thread(target=srv.handle_summarize, args=(stub_video,))
    first.start()
    time.sleep(0.2)
    t0 = time.perf_counter()
    code, _ = srv.handle_summarize(stub_video)
    assert code == 504 and time.perf_counter() - t0 < 1.2
    first.join(timeout=30)
    assert _wait_for(lambda: srv._stats["cancelled"] >= 1)
    assert len(stub.started) == 1


def test_client_disconnect_cancels_queued_request(make_server, stub_video):
    stub = _StubPipeline(begin_delay=1.0)
    srv = make_server(stub)
    first = threading.Thread(target=srv.handle_summarize, args=(stub_video,))
    first.start()
    time.sleep(0.2)
    code, _ = srv.handle_summarize(stub_video, disconnected=lambda: True)
    assert code == 499
    first.join(timeout=30)
    assert _wait_for(lambda: srv._stats["cancelled"] >= 1)
    assert len(stub.started) == 1


def test_requests_are_served_in_arrival_order(make_server, tmp_path):
    """FIFO: begun in the order they were queued, one in flight behind
    another (the worker pipelines begin i+1 before finishing i)."""
    stub = _StubPipeline(finish_delay=0.05)
    srv = make_server(stub)
    paths = []
    for i in range(5):
        p = tmp_path / f"v{i}.y4m"
        p.write_bytes(b"stub")
        paths.append(str(p))
    threads = []
    for p in paths:
        threads.append(threading.Thread(target=srv.handle_summarize,
                                        args=(p,)))
        threads[-1].start()
        time.sleep(0.02)
    for t in threads:
        t.join(timeout=30)
    assert stub.started == paths


def test_cli_serve_parser(capsys):
    with pytest.raises(SystemExit) as e:
        main(["serve", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--artifact", "--checkpoint", "--weights", "--media-root",
                 "--max-queue", "--request-timeout", "--max-upload-mb",
                 "--device"):
        assert flag in out
    with pytest.raises(SystemExit):
        main(["serve", "--checkpoint", "c", "--artifact", "a"])


@needs_native
def test_sigterm_drains_and_exits(tmp_path, video):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    sets = [a for x in SLICE for a in ("--set", x)]
    err = open(tmp_path / "serve.err", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "avsum_torch.cli", "serve", "--device", "cpu",
         "--port", str(port), "--random-init", *sets],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdout=subprocess.DEVNULL, stderr=err)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            assert proc.poll() is None, _tail(err)
            try:
                if _request(port, "GET", "/readyz")[0] == 200:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        code, out = _request(port, "POST", "/v1/summarize", {"path": video})
        assert code == 200, out
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, _tail(err)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _tail(fh):
    fh.seek(0)
    return fh.read()[-2000:]
