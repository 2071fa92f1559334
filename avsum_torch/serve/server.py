"""HTTP summarization service over one pipeline (``avsum_tpu/serve/server.py``).

- ONE pipeline owns the device, driven by ONE worker thread, which enters
  ``torch.inference_mode`` itself (the mode is per thread). Warmup runs a
  synthetic clip through it before ``/readyz`` reports ready, so cuDNN and
  the kernels are set up before the first request.
- Requests are served in FIFO arrival order through a queue, and the
  worker pipelines consecutive ones: request i+1 is begun (its host
  threads, decode and device dispatch, ``AVPipeline.summarize_begin``)
  before request i is finished, so i+1's host work runs under i's device
  work.
- The weights stay on the device in the pipeline and the scorer; a
  request carries only its video's path or bytes.

The API takes server-local paths (a trusted service next to its media;
``media_root`` confines them) and, for clients without shared storage,
raw media uploads (``POST /v1/summarize/upload``): the body is streamed
to a bounded temp file, summarized through the same queue, and deleted.
The JAX server's ``programs_dir`` (AOT executables) has no counterpart.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import select
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

log = logging.getLogger("avsum_torch.serve")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    host: str = "127.0.0.1"
    port: int = 8080  # 0 = ephemeral (the bound port is in .port)
    # run a synthetic clip through the pipeline before reporting ready
    # (cuDNN, the kernels' builds and the caches set up before requests)
    warmup: bool = True
    # JSONL access log (one line per summarize request); "" disables
    access_log: str = ""
    # only serve media under this directory (realpath prefix check);
    # "" = any server-local path (trusted/loopback deployments only)
    media_root: str = ""
    # admission control: queued-but-unstarted requests beyond this get 429
    # (the flood can't grow the queue without bound); 0 = unbounded
    max_queue: int = 64
    # per-request wall-clock budget: waiters give up with 504 and the
    # worker skips the request if it hasn't started yet; 0 = no timeout
    request_timeout_s: float = 0.0
    # POST /v1/summarize/upload: largest accepted media body (413 beyond);
    # 0 disables the upload endpoint entirely
    max_upload_mb: int = 512


class _Request:
    """One queued summarize call; the worker fills (code, payload)."""

    __slots__ = (
        "path", "budget", "done", "code", "payload", "t0", "abandoned"
    )

    def __init__(self, path: str, budget: Optional[float]):
        self.path = path
        self.budget = budget
        self.done = threading.Event()
        self.code = 500
        self.payload = {"error": "request dropped"}
        self.t0 = time.perf_counter()
        # set when the waiter gave up (timeout / client disconnect); the
        # worker skips abandoned requests it hasn't started yet
        self.abandoned = threading.Event()

    def finish(self, code: int, payload: dict) -> None:
        self.code = code
        self.payload = payload
        self.done.set()


class SummarizeServer:
    """HTTP server wrapping ``AVPipeline.summarize``.

    Endpoints:
      GET  /healthz       -> 200 {"status": "ok"} (process liveness)
      GET  /readyz        -> 200 once warmup finished; 503 while warming
                             or (permanently) after a failed warmup
      GET  /v1/stats      -> request counters + latency
      POST /v1/summarize  -> {"path": ..., "budget_fraction"?: float}
                             -> summary JSON (scores, segments, fps)
      POST /v1/summarize/upload?ext=mp4[&budget_fraction=f]
                          -> raw media bytes as the body -> summary JSON
                             (streamed to a bounded temp file; 413 over
                             ``ServeConfig.max_upload_mb``)
    """

    def __init__(self, pipeline, serve_config: ServeConfig = ServeConfig(),
                 model=None):
        """``pipeline``: an ``AVPipeline`` on its device; ``model``: its
        scorer (an ``nn.Module``), an exported artifact
        (``serve.export.load_scorer``) or None (uniform scores)."""
        self.serve_config = serve_config
        self.pipeline = pipeline
        self.model = model
        self._queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=max(serve_config.max_queue, 0)
        )
        self._running = False
        self._worker: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._warmup_error: Optional[str] = None
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "failures": 0,
            "rejected": 0,   # 429 backpressure
            "cancelled": 0,  # timed out / disconnected before start
            "frames": 0,
            "latency_ewma_s": 0.0,
        }
        self._media_root = (
            os.path.realpath(serve_config.media_root)
            if serve_config.media_root
            else ""
        )
        self._t0 = time.time()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------

    @property
    def port(self) -> int:
        assert self._httpd is not None, "server not started"
        return self._httpd.server_address[1]

    # ------------------------------------------------------------------
    # worker: the single pipeline owner, with request pipelining
    # ------------------------------------------------------------------

    def _worker_loop(self) -> None:
        with torch.inference_mode():
            self._serve_queue()

    def _serve_queue(self) -> None:
        in_flight = None  # (request, finisher)
        while True:
            try:
                # with work in flight, only PEEK briefly for a successor to
                # pipeline behind it; otherwise block until work arrives
                req = self._queue.get(timeout=0.02 if in_flight else 0.2)
            except queue.Empty:
                req = None
            if req is None:
                if in_flight is not None:
                    self._complete(*in_flight)
                    in_flight = None
                    continue
                if not self._running:
                    break  # graceful drain done: queue empty, nothing in flight
                continue
            if req.abandoned.is_set():
                # waiter gave up (timeout / client disconnect) while the
                # request was still queued — don't burn pipeline time on it
                with self._stats_lock:
                    self._stats["cancelled"] += 1
                self._access_log(req, 499, {"error": "cancelled before start"})
                req.finish(499, {"error": "cancelled"})
                continue
            try:
                fin = self.pipeline.summarize_begin(
                    req.path, self.model, req.budget
                )
            except Exception as e:  # noqa: BLE001 — per-request isolation
                self._fail(req, e)
                continue
            if in_flight is not None:
                self._complete(*in_flight)
            in_flight = (req, fin)
        # safety net for a request that raced the drain check
        while True:
            try:
                self._fail(self._queue.get_nowait(), RuntimeError("server stopped"))
            except queue.Empty:
                break

    def _access_log(self, req: _Request, code: int, extra: dict) -> None:
        if not self.serve_config.access_log:
            return
        record = {
            "ts": round(time.time(), 3),
            "path": req.path,
            "code": code,
            "latency_s": round(time.perf_counter() - req.t0, 3),
            **extra,
        }
        try:
            with open(self.serve_config.access_log, "a") as fh:
                fh.write(json.dumps(record) + "\n")
        except OSError as e:
            log.warning("access log write failed: %s", e)

    def _complete(self, req: _Request, finisher) -> None:
        try:
            result = finisher()
        except Exception as e:  # noqa: BLE001 — per-request isolation
            self._fail(req, e)
            return
        dt = time.perf_counter() - req.t0
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["frames"] += int(result["n_frames"])
            ewma = self._stats["latency_ewma_s"]
            self._stats["latency_ewma_s"] = round(
                dt if ewma == 0.0 else 0.8 * ewma + 0.2 * dt, 4
            )
        self._access_log(
            req, 200,
            {"n_frames": int(result["n_frames"]),
             "segments": len(result["segments"])},
        )
        req.finish(200, {
            "video_id": result["video_id"],
            "n_frames": int(result["n_frames"]),
            "fps": float(result["fps"]),
            "segments": [[int(a), int(b)] for a, b in result["segments"]],
            "shot_scores": [float(s) for s in result["scores"]],
            "latency_s": round(dt, 3),
        })

    def _fail(self, req: _Request, exc: Exception) -> None:
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["failures"] += 1
        log.error("summarize %s failed: %s", req.path, exc, exc_info=exc)
        self._access_log(req, 500, {"error": str(exc)[:200]})
        req.finish(500, {"error": str(exc)})

    # ------------------------------------------------------------------

    def warmup(self) -> None:
        """Run a synthetic clip through the pipeline, then mark ready.

        Runs through the worker queue, from a thread that :meth:`start`
        begins once the worker is alive (the worker is the only thread
        that touches the pipeline). A failed warmup still releases request
        waiters (``_ready`` set in ``finally`` — per-request isolation
        reports errors per call), but ``/readyz`` keeps returning 503
        with the warmup error so load balancers don't route here."""
        import tempfile

        try:
            if self.serve_config.warmup:
                from avsum_torch.io.synthetic import write_scene_video

                with tempfile.TemporaryDirectory() as td:
                    stem = os.path.join(td, "warmup")
                    write_scene_video(
                        stem, n_scenes=2, seed=0, fps=8.0, height=64,
                        width=96, scene_len_frames=(8, 12),
                    )
                    req = _Request(stem + ".y4m", None)
                    self._queue.put(req)
                    req.done.wait()
                    if req.code != 200:
                        raise RuntimeError(req.payload.get("error", "?"))
        except Exception as e:  # noqa: BLE001 — degraded, not wedged
            self._warmup_error = str(e)
            log.error("warmup failed (serving degraded): %s", e)
        finally:
            self._ready.set()

    def start(self, block: bool = False) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route through our logger
                log.debug("http: " + fmt, *args)

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    return self._json(200, {"status": "ok"})
                if self.path == "/readyz":
                    if server._warmup_error is not None:
                        return self._json(
                            503,
                            {
                                "status": "warmup_failed",
                                "error": server._warmup_error,
                            },
                        )
                    if server._ready.is_set():
                        return self._json(200, {"status": "ready"})
                    return self._json(503, {"status": "warming_up"})
                if self.path == "/v1/stats":
                    with server._stats_lock:
                        stats = dict(server._stats)
                    stats["uptime_s"] = round(time.time() - server._t0, 1)
                    return self._json(200, stats)
                return self._json(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):
                if self.path.split("?", 1)[0] == "/v1/summarize/upload":
                    return self._upload()
                if self.path != "/v1/summarize":
                    return self._json(404, {"error": f"unknown path {self.path}"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError(
                            f"body must be a JSON object, got {type(req).__name__}"
                        )
                    path = req["path"]
                except (ValueError, KeyError) as e:
                    return self._json(
                        400, {"error": f"bad request: {e!r} (need JSON with 'path')"}
                    )
                code, payload = server.handle_summarize(
                    path, req.get("budget_fraction"),
                    disconnected=self._client_gone,
                )
                if code == 499:
                    return  # client already gone; nothing to write
                return self._json(code, payload)

            def _upload(self):
                """Raw media body -> temp file -> the same worker queue.

                The extension (which selects the decode backend) comes
                from ``?ext=``, or from the Content-Type for the common
                container types. The temp file is deleted when the
                request finishes, succeed or fail."""
                import tempfile
                from urllib.parse import parse_qs, urlparse

                if server.serve_config.max_upload_mb <= 0:
                    return self._json(404, {"error": "uploads disabled"})
                q = parse_qs(urlparse(self.path).query)
                ctype_ext = {
                    "video/mp4": "mp4",
                    "video/quicktime": "mov",
                    "video/x-y4m": "y4m",
                    "application/vnd.y4m": "y4m",
                }
                ext = (q.get("ext", [None])[0]
                       or ctype_ext.get(
                           (self.headers.get("Content-Type") or "")
                           .split(";")[0].strip().lower()))
                if not ext or not ext.replace(".", "").isalnum():
                    return self._json(400, {
                        "error": "need ?ext=<container extension> (e.g. "
                        "ext=mp4) or a recognized video Content-Type"})
                ext = "." + ext.lstrip(".").lower()
                try:
                    n = int(self.headers.get("Content-Length", -1))
                except ValueError:
                    n = -1
                limit = server.serve_config.max_upload_mb * 1024 * 1024
                if n < 0:
                    return self._json(411, {"error": "Content-Length required"})
                if n > limit:
                    # drain a bounded amount so simple clients mid-send see
                    # the 413 instead of a broken pipe; beyond the drain
                    # cap just close (we won't sink arbitrary bytes)
                    remaining = min(n, limit + 8 * 1024 * 1024)
                    while remaining > 0:
                        got = self.rfile.read(min(remaining, 1 << 20))
                        if not got:
                            break
                        remaining -= len(got)
                    self.close_connection = True
                    return self._json(413, {
                        "error": f"body {n} bytes exceeds max_upload_mb="
                        f"{server.serve_config.max_upload_mb}"})
                budget = None
                if "budget_fraction" in q:
                    try:
                        budget = float(q["budget_fraction"][0])
                    except ValueError:
                        return self._json(
                            400, {"error": "bad budget_fraction"})
                fd, tmp = tempfile.mkstemp(suffix=ext, prefix="avsum_up_")
                try:
                    with os.fdopen(fd, "wb") as fh:
                        remaining = n
                        while remaining > 0:
                            chunk = self.rfile.read(min(remaining, 1 << 20))
                            if not chunk:
                                return self._json(
                                    400, {"error": "truncated body"})
                            fh.write(chunk)
                            remaining -= len(chunk)
                    code, payload = server.handle_summarize(
                        tmp, budget, disconnected=self._client_gone,
                        is_upload=True,
                    )
                    if code == 499:
                        return  # client already gone
                    if code == 200:
                        payload = dict(payload)
                        payload.pop("video_id", None)  # temp name: noise
                    return self._json(code, payload)
                finally:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass

            def _client_gone(self) -> bool:
                """True if the client closed its end (poll, non-blocking).

                Request body is fully read before this is polled, so any
                readable-with-no-data state means EOF/half-close."""
                try:
                    r, _, _ = select.select([self.connection], [], [], 0)
                    if not r:
                        return False
                    return self.connection.recv(1, socket.MSG_PEEK) == b""
                except (OSError, ValueError):
                    return True

        if (self.serve_config.host not in ("127.0.0.1", "localhost", "::1")
                and not self._media_root):
            log.warning(
                "binding %s without media_root: any client can summarize "
                "any server-local file path — set ServeConfig.media_root "
                "(--media-root) for non-loopback deployments",
                self.serve_config.host,
            )
        self._httpd = ThreadingHTTPServer(
            (self.serve_config.host, self.serve_config.port), Handler
        )
        self._httpd.daemon_threads = True
        self._running = True
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)
        self._worker.start()
        threading.Thread(target=self.warmup, daemon=True).start()
        if block:
            import signal

            def _graceful(signum, frame):
                log.info("signal %d: draining in-flight work, shutting down",
                         signum)
                # stop() joins serve_forever; must run off this thread
                threading.Thread(target=self.stop, daemon=True).start()

            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    signal.signal(sig, _graceful)
                except ValueError:
                    pass  # not the main thread: rely on external stop()
            log.info("serving on %s:%d", self.serve_config.host, self.port)
            self._httpd.serve_forever()
            if self._worker is not None:
                self._worker.join(timeout=600)  # finish draining
        else:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            if self._thread is not None:
                self._thread.join(timeout=5)
        self._running = False
        if self._worker is not None:
            self._worker.join(timeout=60)

    # ------------------------------------------------------------------

    def handle_summarize(self, path: str, budget_fraction=None,
                         disconnected=None, is_upload: bool = False):
        """One request: (http_code, payload). FIFO order via the worker.

        ``disconnected`` is an optional zero-arg callable polled while
        waiting; when it returns True the request is abandoned (the worker
        skips it if it hasn't started) and the result is discarded.
        ``is_upload`` marks a server-created temp file (the media-root
        containment check applies only to client-supplied paths).
        """
        self._ready.wait()
        if not self._running:
            return 503, {"error": "server is shutting down"}
        if self._media_root and not is_upload:
            real = os.path.realpath(path)
            if not (real == self._media_root
                    or real.startswith(self._media_root + os.sep)):
                # uniform 403 (no existence oracle outside the root)
                return 403, {"error": "path outside media root"}
        if not os.path.exists(path):
            return 404, {"error": f"no such video: {path}"}
        req = _Request(path, budget_fraction)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._stats_lock:
                self._stats["rejected"] += 1
            return 429, {"error": "queue full, retry later"}
        timeout = self.serve_config.request_timeout_s
        deadline = req.t0 + timeout if timeout > 0 else None
        # poll instead of a bare wait: an enqueue can race the worker's
        # final drain at shutdown — if the worker has exited and nobody
        # will ever serve this request, answer 503 instead of hanging
        while not req.done.wait(timeout=0.05):
            worker = self._worker
            if not self._running and (worker is None or not worker.is_alive()):
                return 503, {"error": "server is shutting down"}
            if deadline is not None and time.perf_counter() > deadline:
                # the worker counts it as cancelled if it skips it; if it
                # already started, the result completes and is discarded
                req.abandoned.set()
                self._access_log(req, 504, {"error": "request timeout"})
                return 504, {"error": f"request exceeded {timeout:g}s budget"}
            if disconnected is not None and disconnected():
                req.abandoned.set()
                return 499, {"error": "client disconnected"}
        return req.code, req.payload
