"""Job server of the port: the reference's Spark-JobServer surface
(reference Main.scala:99-143) over the port's pipeline, as
stellar_rw_tpu/serve.py offers it over the JAX package's.

`validate(config) -> Params` parses the single `rw.input` config string as
argv (Main.scala:137-143, key read at :139); `run_job(params) -> str` runs
the CLI's pipeline and returns the output path (Main.scala:109-127). A stdlib
HTTP server exposes them as the job-server REST surface:

  POST /jobs   body {"rw.input": "--cmd ... --input ... --output ..."}
               -> 202 {"jobId": ..., "status": "RUNNING"}   (job runs async)
  GET  /jobs/<id>  -> {"jobId", "status": RUNNING|FINISHED|ERROR, "result"|"error"}
  GET  /jobs       -> list of the above

    python -m stellar_rw_tpu_torch.serve --port 8090

Execution is serialized by a semaphore (`max_concurrent`, default 1), so
one pipeline runs at a time, like one SparkContext per job-server context;
queued jobs report RUNNING.

A REST job runs in a disposable `python -m stellar_rw_tpu_torch <argv>`
worker process in its own process group: a worker that crashes or hangs
(a wedged device call) ends or is killed alone (`job_timeout`), and the
server and later jobs go on. The worker is the command line, so it runs on
the card or fails with CudaUnavailable; it never falls back to the CPU.
`submit(params)` without an argv (library use) runs the job in a thread of
this process on the server's `device` (the card unless device="cpu" is
asked for).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .utils.config import Params, parse

CONFIG_KEY = "rw.input"  # reference Main.scala:139
# the directory that holds this package: a worker imports the same code
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def validate(config: dict) -> Params:
    """Parse a job-server config into Params (reference Main.validate:137-143).

    The reference reads the single `rw.input` string and whitespace-splits it
    into argv; a missing key or an argv that does not parse fails the job
    (the reference's MatchError; here a ValueError)."""
    if CONFIG_KEY not in config:
        raise ValueError(f"config key {CONFIG_KEY!r} is required")
    argv = str(config[CONFIG_KEY]).split()
    params = parse(argv)
    if params is None:
        raise ValueError(f"could not parse {CONFIG_KEY}: {config[CONFIG_KEY]!r}")
    return params


def run_job(params: Params, device="cuda") -> str:
    """Run the pipeline on `device`; JobOutput = the output path (reference
    Main.scala:126)."""
    from . import cli
    from .errors import resolve_device

    return cli.run_job(params, resolve_device("serve.run_job", device), {})


def worker_command(argv: list[str]) -> list[str]:
    """The REST worker: the port's command line on the job's argv."""
    return [sys.executable, "-m", "stellar_rw_tpu_torch"] + list(argv)


@dataclass
class _Job:
    id: str
    status: str = "RUNNING"            # RUNNING | FINISHED | ERROR
    result: str | None = None
    error: str | None = None
    thread: threading.Thread | None = field(default=None, repr=False)

    def as_dict(self) -> dict:
        d = {"jobId": self.id, "status": self.status}
        if self.result is not None:
            d["result"] = self.result
        if self.error is not None:
            d["error"] = self.error
        return d


class JobServer:
    """Minimal REST job server over the validate/run_job pair."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_concurrent: int = 1, job_timeout: float | None = None,
                 device="cuda"):
        self._jobs: dict[str, _Job] = {}
        self._lock = threading.Lock()
        self._run_slots = threading.Semaphore(max(1, max_concurrent))
        self.job_timeout = job_timeout
        self.device = device
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                if self.path.rstrip("/") != "/jobs":
                    return self._reply(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    config = json.loads(self.rfile.read(n) or b"{}")
                    params = validate(config)
                except (ValueError, json.JSONDecodeError) as e:
                    return self._reply(400, {"error": str(e)})
                job = server.submit(
                    params, argv=str(config[CONFIG_KEY]).split())
                self._reply(202, job.as_dict())

            def do_GET(self):
                parts = [p for p in self.path.split("/") if p]
                if parts == ["jobs"]:
                    with server._lock:
                        return self._reply(
                            200, {"jobs": [j.as_dict() for j in server._jobs.values()]})
                if len(parts) == 2 and parts[0] == "jobs":
                    with server._lock:
                        job = server._jobs.get(parts[1])
                    if job is None:
                        return self._reply(404, {"error": "no such job"})
                    return self._reply(200, job.as_dict())
                self._reply(404, {"error": "not found"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._serve_thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def submit(self, params: Params, argv: list[str] | None = None) -> _Job:
        """Run a validated job asynchronously; returns its tracking record.

        With `argv` (the REST path) the job runs as a disposable worker
        process (worker_command) in its own process group, killed with its
        group after job_timeout seconds. Without argv (library use) it runs
        in a daemon thread of this process on the server's device."""
        job = _Job(id=uuid.uuid4().hex[:12])

        def work_subprocess():
            with self._run_slots:
                try:
                    env = dict(os.environ)
                    env["PYTHONPATH"] = os.pathsep.join(
                        p for p in (PACKAGE_PARENT, env.get("PYTHONPATH"))
                        if p)
                    proc = subprocess.Popen(
                        worker_command(argv), stdout=subprocess.PIPE,
                        stderr=subprocess.PIPE, text=True, env=env,
                        start_new_session=True)
                    try:
                        _, err = proc.communicate(timeout=self.job_timeout)
                    except subprocess.TimeoutExpired:
                        try:  # a wedged device call may ignore SIGTERM
                            os.killpg(proc.pid, signal.SIGKILL)
                        except ProcessLookupError:
                            proc.kill()
                        proc.communicate()
                        job.error = (f"TIMEOUT: worker killed after "
                                     f"{self.job_timeout:g}s")
                        job.status = "ERROR"
                        return
                    if proc.returncode == 0:
                        job.result = params.output
                        job.status = "FINISHED"
                    else:
                        job.error = (f"worker exited rc={proc.returncode}: "
                                     f"{err[-1000:]}")
                        job.status = "ERROR"
                except Exception as e:  # Popen/communicate failure must not
                    job.error = f"{type(e).__name__}: {e}"   # strand the job
                    job.status = "ERROR"

        def work_inproc():
            with self._run_slots:  # bound concurrency (max_concurrent pipelines)
                try:
                    job.result = run_job(params, self.device)
                    job.status = "FINISHED"
                except Exception as e:  # a failed job must not kill the server
                    job.error = f"{type(e).__name__}: {e}"
                    job.status = "ERROR"

        job.thread = threading.Thread(
            target=work_subprocess if argv is not None else work_inproc,
            daemon=True)
        with self._lock:
            self._jobs[job.id] = job
        job.thread.start()
        return job

    def start(self) -> None:
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._serve_thread.start()

    def stop(self) -> None:
        # shutdown() blocks forever if serve_forever() was never entered:
        # call it only when a serve thread exists
        if self._serve_thread is not None:
            self.httpd.shutdown()
            self._serve_thread.join(timeout=10)
        self.httpd.server_close()

    def wait(self, job_id: str, timeout: float | None = None) -> _Job:
        with self._lock:
            job = self._jobs[job_id]
        if job.thread is not None:
            job.thread.join(timeout)
        return job


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="stellar-rw-tpu-torch-serve",
        description="job server of the PyTorch/CUDA port")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8090)
    ns = ap.parse_args(argv)
    srv = JobServer(ns.host, ns.port)
    print(f"serving on http://{srv.address[0]}:{srv.address[1]} "
          f"(POST /jobs with {{'{CONFIG_KEY}': '<argv string>'}})")
    try:
        srv.httpd.serve_forever()
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
