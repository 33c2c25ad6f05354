"""The port's operator CLI (``python -m ray_tpu_torch``) against the JAX
package's (``python -m ray_tpu``), on the CPU.

Each CLI runs as real processes, as an operator runs it: ``start --head``
spawns a head, ``job submit`` a job whose entrypoint joins the cluster, and
``stop`` ends the head. Each package gets a ``HOME`` of its own, where its CLI
keeps its state file (``~/.ray_tpu/cli_state.json`` and
``~/.ray_tpu_torch/cli_state.json``), so neither finds the other's head. The
same job must give the same exit code and logs, and the listings the same
keys (the port's actor listing adds ``resources`` and ``gpu_ids``). The
port's GPU seams run on logical GPUs: no CUDA is touched.
"""

import json
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_ACTOR_KEYS = {"resources", "gpu_ids"}

JOB = """\
import os
import {pkg}

{pkg}.init(address=os.environ["{env}ADDRESS"])


@{pkg}.remote
def square(x):
    return x * x


print("sum", sum({pkg}.get([square.remote(i) for i in range(5)])), flush=True)
print("job id given", bool(os.environ.get("{env}JOB_ID")), flush=True)
raise SystemExit({code})
"""

GPU_JOB = """\
import json
import os
import ray_tpu_torch

ray_tpu_torch.init(address=os.environ["RAY_TPU_TORCH_ADDRESS"])


@ray_tpu_torch.remote(num_gpus=1)
class Worker:
    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")


w = Worker.options(name="gpu_worker").remote()
print(json.dumps({"entrypoint": os.environ.get("CUDA_VISIBLE_DEVICES"),
                  "actor": ray_tpu_torch.get(w.visible.remote())}), flush=True)
"""


class Cli:
    """One package's CLI in processes of its own, with its own HOME."""

    def __init__(self, pkg, home):
        self.pkg, self.home = pkg, str(home)
        self.env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        self.env.update(HOME=self.home, JAX_PLATFORMS="cpu")
        for k in list(self.env):
            if k.startswith("RAY_TPU_"):
                del self.env[k]

    def __call__(self, *args, check=True, timeout=180):
        proc = subprocess.run([sys.executable, "-m", self.pkg, *args], cwd=ROOT, env=self.env,
                              capture_output=True, text=True, timeout=timeout)
        if check:
            assert proc.returncode == 0, (self.pkg, args, proc.stdout, proc.stderr[-3000:])
        return proc

    def json(self, *args):
        return json.loads(self(*args).stdout)

    def state(self):
        with open(os.path.join(self.home, f".{self.pkg}", "cli_state.json")) as f:
            return json.load(f)

    def write(self, name, text):
        path = os.path.join(self.home, name)
        with open(path, "w") as f:
            f.write(text)
        return path


def _keys(rows):
    return sorted({k for r in rows for k in r})


def _gone(pid, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.1)
    return False


def _job_lines(out):
    """A ``job submit --wait``'s stdout without its first line (the job id,
    random in each package)."""
    return out.splitlines()[1:]


@pytest.fixture
def clis(tmp_path):
    out = {"jax": Cli("ray_tpu", tmp_path / "jax"), "port": Cli("ray_tpu_torch", tmp_path / "port")}
    for c in out.values():
        os.makedirs(c.home)
    yield out
    for c in out.values():
        if os.path.exists(os.path.join(c.home, f".{c.pkg}", "cli_state.json")):
            c("stop", check=False)


def test_cli_matches_jax(clis):
    jax, port = clis["jax"], clis["port"]
    jax("start", "--head", "--num-cpus", "2", "--num-tpus", "0")
    port("start", "--head", "--num-cpus", "2", "--num-gpus", "0")
    assert jax.state()["head"]["address"] != port.state()["head"]["address"]
    runs = {}
    for name, c, env in (("jax", jax, "RAY_TPU_"), ("port", port, "RAY_TPU_TORCH_")):
        runs[name] = []
        for code in (0, 3):
            script = c.write(f"job{code}.py", JOB.format(pkg=c.pkg, env=env, code=code))
            p = c("job", "submit", "--wait", "--entrypoint", f"python {script}", check=False)
            runs[name].append((p.returncode, _job_lines(p.stdout)))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == (0, ["SUCCEEDED", "sum 30", "job id given True"])
    assert runs["port"][1][0] == 1 and runs["port"][1][1][0] == "FAILED"

    jobs = {name: c.json("job", "list") for name, c in (("jax", jax), ("port", port))}
    assert sorted(jobs["port"].values()) == sorted(jobs["jax"].values()) == ["FAILED",
                                                                             "SUCCEEDED"]
    for jid, status in jobs["port"].items():
        assert port("job", "status", jid).stdout.strip() == status
        assert "sum 30" in port("job", "logs", jid).stdout

    j_status, t_status = jax.json("status"), port.json("status")
    assert sorted(t_status) == sorted(j_status)
    assert sorted(t_status["task_latency"]) == sorted(j_status["task_latency"])
    for what in ("nodes", "tasks", "objects"):
        assert _keys(port.json("list", what)) == _keys(jax.json("list", what)), what
    j_actors, t_actors = jax.json("list", "actors"), port.json("list", "actors")
    assert _keys(t_actors) == sorted(set(_keys(j_actors)) | PORT_ACTOR_KEYS)
    assert sorted(a["class_name"] for a in t_actors) == sorted(a["class_name"] for a in j_actors)
    assert port.json("train", "--json") == jax.json("train", "--json") == {"gangs": {}}
    heads = {}
    for name, c in (("jax", jax), ("port", port)):
        heads[name] = c.state()["head"]
        out = os.path.join(c.home, "timeline.json")
        c("timeline", "--output", out)
        with open(out) as f:
            heads[name]["cats"] = {e["cat"] for e in json.load(f)}
        assert c("stop").stdout.strip() == "stopped 1 process(es)"
    assert heads["port"]["cats"] == heads["jax"]["cats"] >= {"task", "task_stage"}
    for h in heads.values():
        assert _gone(h["pid"]), h
        assert not os.path.exists(h["session_dir"]), h


def test_cli_gpus_entrypoint_and_what_the_port_rejects(clis):
    port = clis["port"]
    bad = port("start", "--head", "--num-tpus", "1", check=False)
    assert bad.returncode == 2 and "unrecognized arguments: --num-tpus" in bad.stderr
    assert not os.path.exists(os.path.join(port.home, ".ray_tpu_torch"))
    mb = port("microbenchmark", check=False)
    assert mb.returncode != 0
    assert "NotImplementedError" in mb.stderr and "ROADMAP.md item 9" in mb.stderr

    port("start", "--head", "--num-cpus", "2", "--num-gpus", "2", "--dashboard-port", "0")
    head = port.state()["head"]
    assert head["dashboard_port"] > 0
    status = port.json("status")
    assert status["cluster_resources"]["GPU"] == 2.0
    script = port.write("gpu_job.py", GPU_JOB)
    p = port("job", "submit", "--wait", "--entrypoint", f"python {script}")
    assert _job_lines(p.stdout)[0] == "SUCCEEDED"
    # The entrypoint runs under the job's supervisor, an actor that holds no
    # GPU; the actor it starts holds one and sees its device id.
    assert json.loads(_job_lines(p.stdout)[1]) == {"entrypoint": "", "actor": "0"}
    actors = {a["name"]: a for a in port.json("list", "actors")}
    sup = next(a for n, a in actors.items() if n and n.startswith("JOB_SUPERVISOR::"))
    assert sup["class_name"] == "_JobSupervisor" and sup["gpu_ids"] == []
    assert actors["gpu_worker"]["class_name"] == "Worker"
    # Both are dead now (the job's driver exited, and the supervisor is reaped):
    # the node's GPUs are free again.
    deadline = time.time() + 30
    while port.json("status")["available_resources"].get("GPU") != 2.0:
        assert time.time() < deadline, port.json("status")
        time.sleep(0.2)
    port("stop")
    assert _gone(head["pid"]) and not os.path.exists(head["session_dir"])


def test_a_job_outlives_the_cli_that_submitted_it(clis):
    # `job submit` without --wait exits as soon as it prints the job id. The
    # job's run() is submitted by its supervisor, which owns it, so the job
    # runs to its end (the JAX package's client submits run() itself, and
    # the head fails it with OwnerDiedError when that client exits first:
    # ROADMAP.md Queue 3).
    port = clis["port"]
    port("start", "--head", "--num-cpus", "2", "--num-gpus", "0")
    script = port.write("slow.py", "import time\ntime.sleep(2)\nprint('slept', flush=True)\n")
    job_id = port("job", "submit", "--entrypoint", f"python {script}").stdout.strip()
    deadline = time.time() + 60
    while (status := port("job", "status", job_id).stdout.strip()) in ("PENDING", "RUNNING"):
        assert time.time() < deadline, status
        time.sleep(0.3)
    assert status == "SUCCEEDED" and port("job", "logs", job_id).stdout == "slept\n"
    # Its supervisor was reaped: no actor is left alive.
    assert [a for a in port.json("list", "actors") if a["state"] == "ALIVE"] == []
    port("stop")
