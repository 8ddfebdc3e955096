"""The port's job server (stellar_rw_tpu_torch/serve.py), ported from
tests/test_serve.py: validate parses the single rw.input config string,
run_job returns the output path, the REST server runs jobs asynchronously
in disposable worker processes. Jobs that run in this process take the
server's device ("cpu" here); a REST worker is the port's command line, so
on a machine without a GPU it ends ERROR with CudaUnavailable and never
gives a CPU result. The workers here are given no GPU
(CUDA_VISIBLE_DEVICES empty), so the tests hold on any machine."""

import filecmp
import json
import urllib.request

import jax
import pytest

from stellar_rw_tpu import serve as jserve
from stellar_rw_tpu_torch import serve
from stellar_rw_tpu_torch.utils.config import TaskName


@pytest.fixture(autouse=True)
def _workers_without_gpu(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")


def _job(karate_path, out, extra=""):
    return {"rw.input": f"--cmd randomwalk --input {karate_path} --output "
                        f"{out} --walkLength 2 --numWalks 1 --weighted false"
                        f"{extra}"}


def _http(method, url, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_validate_parses_rw_input(karate_path, tmp_path):
    cfg = {"rw.input": f"--cmd randomwalk --input {karate_path} "
                       f"--output {tmp_path} --walkLength 3 --numWalks 1"}
    params = serve.validate(cfg)
    assert params.cmd == TaskName.randomwalk
    assert params.walk_length == 3 and params.num_walks == 1
    assert params.input == str(karate_path)
    assert params.__dict__.keys() == jserve.validate(cfg).__dict__.keys()


def test_validate_rejects_bad_config():
    with pytest.raises(ValueError):
        serve.validate({})  # missing rw.input (reference Main.scala:139)
    with pytest.raises(ValueError):
        # an argv that does not parse: the reference's MatchError
        serve.validate({"rw.input": "--cmd nosuch --input x --output y"})


def test_run_job_returns_output_path(karate_path, tmp_path):
    """JobOutput = params.output (Main.scala:126); /path byte for byte the
    JAX package's run_job on the same config."""
    out, jout = tmp_path / "job_out", tmp_path / "jax_out"
    result = serve.run_job(serve.validate(_job(karate_path, out)),
                           device="cpu")
    assert result == str(out)
    with jax.enable_x64(False):
        jserve.run_job(jserve.validate(_job(karate_path, jout)))
    assert filecmp.cmp(out / "path" / "part-00000",
                       jout / "path" / "part-00000", shallow=False)


def test_inprocess_submit_finishes_on_the_servers_device(karate_path,
                                                         tmp_path):
    """submit(params) without an argv runs in this process on the server's
    device, here the CPU, through to FINISHED."""
    srv = serve.JobServer(device="cpu")
    try:
        out = tmp_path / "inproc"
        job = srv.submit(serve.validate(_job(karate_path, out,
                                             " --cmd node2vec --dim 8 "
                                             "--iter 1 --window 2")))
        srv.wait(job.id, timeout=120)
        assert not job.thread.is_alive()
        assert job.status == "FINISHED", job.error
        assert job.result == str(out)
        for sub in ("path", "vec", "bin"):
            assert (out / sub).is_dir()
    finally:
        srv.stop()


def test_rest_job_lifecycle(karate_path, tmp_path):
    """POST -> 202 RUNNING, GET by id and the listing, 400 on a bad
    config, 404 on an unknown id; the worker (no GPU) ends ERROR naming
    CudaUnavailable and writes no /path."""
    srv = serve.JobServer(device="cpu")
    srv.start()
    host, port = srv.address
    base = f"http://{host}:{port}"
    try:
        out = tmp_path / "rest_out"
        code, job = _http("POST", f"{base}/jobs", _job(karate_path, out))
        assert code == 202 and job["status"] in ("RUNNING", "ERROR")
        jid = job["jobId"]
        srv.wait(jid, timeout=120)
        code, done = _http("GET", f"{base}/jobs/{jid}")
        assert code == 200 and done["status"] == "ERROR", done
        assert "CudaUnavailable" in done["error"] and "result" not in done
        assert not (out / "path").exists()
        code, lst = _http("GET", f"{base}/jobs")
        assert code == 200 and any(j["jobId"] == jid for j in lst["jobs"])
        code, err = _http("POST", f"{base}/jobs", {"wrong": "key"})
        assert code == 400
        code, _ = _http("GET", f"{base}/jobs/doesnotexist")
        assert code == 404
    finally:
        srv.stop()


def test_failed_job_reports_error(tmp_path):
    srv = serve.JobServer(device="cpu")
    try:
        params = serve.validate(
            {"rw.input": f"--cmd randomwalk --input /nonexistent/file "
                         f"--output {tmp_path}/x"})
        job = srv.submit(params)
        srv.wait(job.id, timeout=60)
        assert job.status == "ERROR" and job.error
    finally:
        srv.stop()


def test_rest_worker_death_is_isolated(karate_path, tmp_path):
    """A REST job whose worker process dies (unreadable input) reports
    ERROR with its exit code, and the server goes on: the next job runs to
    FINISHED."""
    srv = serve.JobServer(device="cpu")
    srv.start()
    host, port = srv.address
    base = f"http://{host}:{port}"
    try:
        code, bad = _http("POST", f"{base}/jobs", {
            "rw.input": f"--cmd randomwalk --input /nonexistent/graph.txt "
                        f"--output {tmp_path}/bad --walkLength 2 --numWalks 1"})
        assert code == 202
        srv.wait(bad["jobId"], timeout=120)
        code, done = _http("GET", f"{base}/jobs/{bad['jobId']}")
        assert done["status"] == "ERROR" and "rc=" in done["error"]
        out = tmp_path / "good"
        good = srv.submit(serve.validate(_job(karate_path, out)))
        srv.wait(good.id, timeout=120)
        code, done = _http("GET", f"{base}/jobs/{good.id}")
        assert done["status"] == "FINISHED", done
        assert (out / "path" / "part-00000").exists()
    finally:
        srv.stop()


def test_job_timeout_kills_wedged_worker(karate_path, tmp_path):
    """A worker that outlives job_timeout is killed with its process group
    and the job reports TIMEOUT. A hung device call cannot be staged here,
    so the timeout (0.1 s) is one that the worker's own start, which
    imports torch, always exceeds."""
    srv = serve.JobServer(job_timeout=0.1, device="cpu")
    try:
        argv = _job(karate_path, tmp_path / "t")["rw.input"].split()
        job = srv.submit(serve.validate({"rw.input": " ".join(argv)}),
                         argv=argv)
        srv.wait(job.id, timeout=60)
        assert not job.thread.is_alive()
        assert job.status == "ERROR" and "TIMEOUT" in job.error
        assert not (tmp_path / "t").exists()
    finally:
        srv.stop()


def test_worker_is_the_ports_command_line():
    cmd = serve.worker_command(["--cmd", "randomwalk"])
    assert cmd[1:] == ["-m", "stellar_rw_tpu_torch", "--cmd", "randomwalk"]
