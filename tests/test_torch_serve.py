"""The port's Serve (``ray_tpu_torch.serve``) against the JAX package's
(``ray_tpu.serve``) on the CPU: both runtimes and both Serve instances run in
this process, each proxy on an ephemeral port (``port=0``; no case binds
Serve's default 8000), and the same deployment, built by one function from
either package's ``serve`` module, answers the same requests in each.

Replies must be equal: over a handle and over HTTP (status, body, and the
headers a client reads), through composition graphs, ``@serve.batch``
(results and the batch sizes formed), the multiplexed LRU (loads, evictions,
``__serve_unload__``), streamed replies (chunked over HTTP, a generator over
a handle), ``DAGDriver`` on one route and on several, shed requests (503 with
``Retry-After``) and a redeployed version. A nano GPT scored by the port's
``TorchPredictor(device="cpu")`` in a replica is held to the JAX package's
``JaxPredictor`` in one within ``GPT_ATOL``, the weights carried across by
``params_from_numpy``. The port's own divergences (ROADMAP.md Queue 3) are
held last: the GPU-share check of ``serve.run``, the capped upscale, and a
replica constructor's error reaching the caller of ``serve.run``.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu_torch import serve as tserve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The nano GPT's f32 NLLs: the two packages' forwards in f32 on the CPU.
GPT_ATOL = 1e-5
TIMEOUT_S = 30


@pytest.fixture(scope="module")
def both():
    ray_tpu.init(num_cpus=6)
    ray_tpu_torch.init(num_cpus=6, num_gpus=1)  # a logical GPU: no CUDA is touched
    for serve in (jserve, tserve):
        serve.start(http_options={"port": 0})
    yield
    for serve, pkg in ((tserve, ray_tpu_torch), (jserve, ray_tpu)):
        serve.shutdown()
        pkg.shutdown()


@pytest.fixture(autouse=True)
def _cleanup(both):
    yield
    for serve in (jserve, tserve):
        for name in list(serve.status()):
            serve.delete(name)


def _http(serve, path, data=None, headers=None, method=None):
    """(status, body, headers) of one request to ``serve``'s proxy."""
    url = f"http://127.0.0.1:{serve.http_port()}{path}"
    req = urllib.request.Request(url, data=data, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _each(fn):
    """``fn(serve)`` through each package: [JAX's, the port's]."""
    return [fn(serve) for serve in (jserve, tserve)]


def test_exports_are_the_jax_packages():
    assert tserve.__all__ == jserve.__all__
    assert all(hasattr(tserve, name) for name in tserve.__all__)
    from ray_tpu_torch.serve._private.common import DEFAULT_HTTP_PORT

    assert DEFAULT_HTTP_PORT == 8000  # the reference's; every test here binds port 0


def test_handle_and_http(both):
    def run(serve):
        @serve.deployment(num_replicas=2)
        class Echo:
            def __init__(self, prefix):
                self.prefix = prefix

            def __call__(self, req):
                return {"prefix": self.prefix, "method": req.method, "path": req.path,
                        "query": req.query_params, "json": req.json(),
                        "header": req.headers.get("X-Probe")}

            def upper(self, s):
                return self.prefix + s.upper()

        h = serve.run(Echo.bind("p:"), route_prefix="/echo", port=0)
        out = [h.upper.remote("ab").result(), h.options(method_name="upper").remote("c").result()]
        st, body, hdrs = _http(serve, "/echo/x/y?a=1&b=", json.dumps({"k": [1, 2]}).encode(),
                               {"X-Probe": "v", "Content-Type": "application/json"}, "POST")
        out += [st, json.loads(body), hdrs["Content-Type"]]
        st, body, _ = _http(serve, "/nowhere")
        out += [st, json.loads(body), serve.status()["Echo"]["num_replicas"]]
        return out

    jax_out, torch_out = _each(run)
    assert jax_out == torch_out
    assert torch_out[:3] == ["p:AB", "p:C", 200]
    assert torch_out[3] == {"prefix": "p:", "method": "POST", "path": "/x/y",
                            "query": {"a": "1", "b": ""}, "json": {"k": [1, 2]}, "header": "v"}
    assert torch_out[5:] == [404, {"error": "no route for /nowhere"}, 2]


def test_composition_graph(both):
    def run(serve):
        @serve.deployment
        class Adder:
            def __init__(self, k):
                self.k = k

            def add(self, x):
                return x + self.k

        @serve.deployment
        class Pipeline:
            def __init__(self, a, b):
                self.a, self.b = a, b

            def __call__(self, req):
                x = int(req.query_params["x"])
                return self.b.add.remote(self.a.add.remote(x).result()).result()

            def run(self, x):
                return self.b.add.remote(self.a.add.remote(x).result()).result()

        h = serve.run(Pipeline.bind(Adder.options(name="A1").bind(1),
                                    Adder.options(name="A2").bind(10)), route_prefix="/p", port=0)
        return [h.run.remote(5).result(), _http(serve, "/p?x=7")[:2], sorted(serve.status())]

    jax_out, torch_out = _each(run)
    assert jax_out == torch_out == [16, (200, b"18"), ["A1", "A2", "Pipeline"]]


def test_serve_batch(both):
    def run(serve):
        @serve.deployment(max_concurrent_queries=16)
        class Batched:
            def __init__(self):
                self.sizes = []

            @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.5)
            async def handle(self, xs):
                self.sizes.append(len(xs))
                return [x * 10 for x in xs]

            async def __call__(self, x):
                return await self.handle(x)

            def sizes_seen(self):
                return self.sizes

        h = serve.run(Batched.bind(), _blocking_http=False)
        resps = [h.remote(i) for i in range(8)]
        got = [r.result() for r in resps]
        return got, sorted(h.sizes_seen.remote().result())

    (jax_got, jax_sizes), (torch_got, torch_sizes) = _each(run)
    assert jax_got == torch_got == [i * 10 for i in range(8)]
    assert sum(torch_sizes) == sum(jax_sizes) == 8
    assert max(torch_sizes) == 4 and max(jax_sizes) == 4


def test_multiplex_lru(both):
    def run(serve):
        @serve.deployment(max_concurrent_queries=4)
        class Multi:
            def __init__(self):
                self.loads, self.unloads = [], []

            @serve.multiplexed(max_num_models_per_replica=2)
            async def get_model(self, model_id):
                self.loads.append(model_id)
                owner = self

                class Model:
                    def __serve_unload__(self):
                        owner.unloads.append(model_id)

                return Model()

            async def __call__(self, req):
                mid = serve.get_multiplexed_model_id()
                await self.get_model()
                return {"id": mid,
                        "cached": self.get_model._model_cache.model_ids(),
                        "loads": list(self.loads), "unloads": list(self.unloads)}

        h = serve.run(Multi.bind(), route_prefix="/m", port=0)
        out = []
        for mid in ("m1", "m2", "m3", "m1"):
            st, body, _ = _http(serve, "/m", headers={"serve_multiplexed_model_id": mid})
            out.append((st, json.loads(body)))
        out.append(h.options(multiplexed_model_id="m3").remote(None).result())
        return out

    jax_out, torch_out = _each(run)
    assert jax_out == torch_out
    last = torch_out[-1]
    assert last["loads"] == ["m1", "m2", "m3", "m1"] and last["unloads"] == ["m1", "m2"]
    assert last["cached"] == ["m1", "m3"]


def test_streaming_http_and_handle(both):
    def run(serve):
        @serve.deployment
        class Tokens:
            def __call__(self, req):
                for i in range(int(req.query_params.get("n", 3))):
                    yield f"tok{i};"

            def gen(self, n):
                for i in range(n):
                    yield {"i": i}

        h = serve.run(Tokens.bind(), route_prefix="/t", port=0)
        st, body, hdrs = _http(serve, "/t?n=4")
        streamed = list(h.options(method_name="gen", stream=True).remote(3))
        return st, body, hdrs.get("Transfer-Encoding"), streamed

    jax_out, torch_out = _each(run)
    assert jax_out == torch_out == (200, b"tok0;tok1;tok2;tok3;", "chunked",
                                    [{"i": 0}, {"i": 1}, {"i": 2}])


def _raw(port, data, timeout=TIMEOUT_S):
    """Send raw bytes to a proxy; returns all it answers until it closes
    the connection (or goes quiet for a second)."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall(data)
        sock.settimeout(1.0)
        out = b""
        try:
            while True:
                got = sock.recv(65536)
                if not got:
                    break
                out += got
        except socket.timeout:
            pass
    return out


def _statuses(raw):
    import re

    return [int(code) for code in re.findall(rb"HTTP/1\.[01] (\d{3}) ", raw)]


def test_http_connections(both):
    # The proxy's HTTP/1.1 handling on the wire: three requests on one
    # keep-alive connection (the last with Connection: close), a chunked
    # request body, and a malformed request line (400).
    def run(serve):
        @serve.deployment
        class Echo:
            def __call__(self, req):
                return req.body.decode() or req.method

        serve.run(Echo.bind(), route_prefix="/e", port=0)
        port = serve.http_port()
        two = _raw(port, b"GET /e HTTP/1.1\r\nHost: x\r\n\r\n"
                         b"POST /e HTTP/1.1\r\nHost: x\r\nContent-Length: 3\r\n\r\nabc"
                         b"GET /e HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
        chunked = _raw(port, b"POST /e HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n"
                             b"Connection: close\r\n\r\n3\r\nabc\r\n2\r\nde\r\n0\r\n\r\n")
        bad = _raw(port, b"NONSENSE\r\n\r\n")
        return (_statuses(two), two.count(b"GET"), b"abc" in two, _statuses(chunked),
                chunked.endswith(b"abcde"), _statuses(bad))

    jax_out, torch_out = _each(run)
    assert jax_out == torch_out == ([200, 200, 200], 2, True, [200], True, [400])
    # The port answers a body over 1 MiB (the reference's limit) with 413
    # from its declared length, before reading it, and closes; and a
    # malformed length with 400.
    port = tserve.http_port()
    big = _raw(port, b"POST /e HTTP/1.1\r\nContent-Length: %d\r\n\r\n" % (2 * 1024 ** 2))
    assert _statuses(big) == [413] and b"Connection: close" in big
    assert _statuses(_raw(port, b"POST /e HTTP/1.1\r\nContent-Length: x\r\n\r\n")) == [400]


def test_streaming_chunks_arrive_one_by_one(both):
    # Each yield is one flushed chunk: the first arrives while the producer
    # still sleeps before the next.
    import http.client

    @tserve.deployment
    class Slow:
        def __call__(self, req):
            for i in range(3):
                yield f"c{i};"
                time.sleep(0.5)

    tserve.run(Slow.bind(), route_prefix="/slow", port=0)
    conn = http.client.HTTPConnection("127.0.0.1", tserve.http_port(), timeout=TIMEOUT_S)
    t0 = time.perf_counter()
    conn.request("GET", "/slow")
    resp = conn.getresponse()
    first, first_s = resp.read(3), time.perf_counter() - t0
    rest, total_s = resp.read(), time.perf_counter() - t0
    conn.close()
    assert (first, rest) == (b"c0;", b"c1;c2;")
    assert total_s >= 1.0 and first_s < total_s - 0.5, (first_s, total_s)


def test_dag_driver_single_and_multi_route(both):
    def run(serve):
        pkg = ray_tpu if serve is jserve else ray_tpu_torch
        dag_mod = __import__(f"{pkg.__name__}.dag", fromlist=["InputNode"])
        drivers = __import__(f"{pkg.__name__}.serve.drivers", fromlist=["DAGDriver"])

        @pkg.remote
        def double(x):
            return x * 2

        @pkg.remote
        def add_one(x):
            return x + 1

        @pkg.remote
        def negate(x):
            return -x

        inp = dag_mod.InputNode()
        single = add_one.bind(double.bind(inp))
        h = serve.run(serve.deployment(drivers.DAGDriver).bind(single), route_prefix="/calc",
                      port=0)
        out = [h.predict.remote(5).result(), _http(serve, "/calc", b"20", method="POST")[:2]]
        serve.delete("DAGDriver")
        multi = {"/double": double.bind(dag_mod.InputNode()),
                 "/neg": negate.bind(dag_mod.InputNode())}
        h = serve.run(serve.deployment(drivers.DAGDriver).bind(multi), route_prefix="/m",
                      port=0)
        out += [_http(serve, "/m/double", b"7", method="POST")[:2],
                _http(serve, "/m/neg", b"7", method="POST")[:2],
                h.predict_with_route.remote("/neg", 3).result()]
        return out

    jax_out, torch_out = _each(run)
    assert jax_out == torch_out == [11, (200, b"41"), (200, b"14"), (200, b"-7"), -3]


def test_shed_with_retry_after(both):
    # The app's cap is one admitted request at the proxy: while one sleeps in
    # the replica, every other request is shed at once with 503.
    def run(serve):
        @serve.deployment(max_queued_requests=1)
        class Slow:
            def __call__(self, req):
                time.sleep(2.0)
                return "done"

        serve.run(Slow.bind(), route_prefix="/slow", port=0)
        first = {}
        t = threading.Thread(target=lambda: first.update(r=_http(serve, "/slow")))
        t.start()
        time.sleep(0.5)
        shed = [_http(serve, "/slow") for _ in range(3)]
        t.join()
        return ([first["r"][:2]] + [(s, json.loads(b), h.get("Retry-After"))
                                    for s, b, h in shed])

    jax_out, torch_out = _each(run)
    assert jax_out == torch_out
    assert torch_out[0] == (200, b"done")
    assert torch_out[1:] == [(503, {"error": "shed", "reason": "app_queue", "app": "Slow"},
                              "1")] * 3


def test_redeploy_new_version(both):
    def run(serve):
        @serve.deployment(name="Ver")
        class V1:
            def __call__(self, req):
                return "v1"

        @serve.deployment(name="Ver")
        class V2:
            def __call__(self, req):
                return "v2"

        serve.run(V1.bind(), route_prefix="/ver", port=0)
        before = _http(serve, "/ver")[:2]
        h = serve.run(V2.bind(), route_prefix="/ver", port=0)
        return [before, _http(serve, "/ver")[:2], h.remote(None).result(),
                serve.status()["Ver"]["version"]]

    jax_out, torch_out = _each(run)
    assert jax_out == torch_out == [(200, b"v1"), (200, b"v2"), "v2", 1]


def test_gpt_predictor_deployment_matches_jax(both):
    import jax
    import jax.numpy as jnp

    from ray_tpu.air.checkpoint import Checkpoint as JaxCheckpoint
    from ray_tpu.models import gpt as jgpt
    from ray_tpu.train import JaxPredictor
    from ray_tpu_torch.air.checkpoint import Checkpoint
    from ray_tpu_torch.models import gpt as tgpt
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.train import TorchPredictor

    sys.path.insert(0, ROOT)
    import chip_smoke

    jcfg = jgpt.GPTConfig.nano(dtype=jnp.float32)
    tcfg = tgpt.GPTConfig.nano(dtype=__import__("torch").float32)
    weights = jax.tree.map(np.asarray, jgpt.init_params(jcfg, jax.random.PRNGKey(0)))
    rows = np.random.default_rng(0).integers(0, 255, (6, 17)).astype(np.int32)

    def jax_nll(params, b):
        logits = jgpt.forward(params, b["tokens"], jcfg)
        target = jnp.take_along_axis(logits, b["targets"][..., None], -1)[..., 0]
        return jax.nn.logsumexp(logits, -1) - target

    def scorer(serve, build):
        @serve.deployment(max_concurrent_queries=8)
        class Scorer:
            def __init__(self):
                self.predictor = build()

            @serve.batch(max_batch_size=3, batch_wait_timeout_s=0.2)
            async def score(self, rows):
                import numpy as np

                t = np.stack([np.asarray(r, np.int32) for r in rows])
                nll = self.predictor.predict({"tokens": t[:, :-1], "targets": t[:, 1:]})
                return [row.mean(dtype=np.float64).item() for row in nll["predictions"]]

            async def __call__(self, req):
                return await self.score(req.json())

        return Scorer

    jax_app = scorer(jserve, lambda: JaxPredictor.from_checkpoint(
        JaxCheckpoint(data_dict={"params": weights}), apply_fn=jax_nll))
    tparams = params_from_numpy(weights, "cpu")
    nll_fn = chip_smoke.next_token_nll_fn(tcfg)
    torch_app = scorer(tserve, lambda: TorchPredictor.from_checkpoint(
        Checkpoint(data_dict={"params": tparams}), apply_fn=nll_fn, device="cpu"))
    out = []
    for serve, app in ((jserve, jax_app), (tserve, torch_app)):
        h = serve.run(app.bind(), route_prefix="/score", port=0)
        via_http = [json.loads(_http(serve, "/score", json.dumps(r.tolist()).encode(),
                                     method="POST")[1]) for r in rows[:3]]
        via_handle = [h.score.remote(r.tolist()).result() for r in rows[3:]]
        out.append(np.asarray(via_http + via_handle))
    assert out[0].shape == out[1].shape == (6,) and np.isfinite(out[1]).all()
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=GPT_ATOL)


# ------------------------------------------------------------------ the port's divergences
def test_gpu_share_beyond_the_cluster_raises(both):
    # The cluster has GPU 1 (logical). Three replicas of 0.5 would leave the
    # third unplaceable, blocking the controller: serve.run refuses at once.
    @tserve.deployment(num_replicas=3, ray_actor_options={"num_gpus": 0.5})
    class G:
        def __call__(self, req):
            return "g"

    with pytest.raises(ValueError, match=r"3 replica\(s\) x num_gpus=0.5 = 1.5 GPU.*GPU 1.0"):
        tserve.run(G.bind(), port=0)
    with pytest.raises(ValueError, match=r"3 replica\(s\) x num_gpus=1.0 = 3.0 GPU"):
        tserve.run(G.options(num_replicas=1, ray_actor_options={"num_gpus": 1.0},
                             autoscaling_config={"min_replicas": 3, "max_replicas": 4}).bind(),
                   port=0)
    assert "G" not in tserve.status()
    # Two of 0.5 fit: both replicas on the one logical GPU, none left free.
    h = tserve.run(G.options(num_replicas=2).bind(), route_prefix="/g", port=0)
    assert h.remote(None).result() == "g"
    assert ray_tpu_torch.available_resources().get("GPU", 0.0) == 0.0
    tserve.delete("G")


def test_gpu_upscale_caps_at_what_fits(both):
    # An autoscaling GPU deployment under load asks for up to 4 replicas of
    # 0.5; the node holds 2: the controller stops there, status() shows it.
    @tserve.deployment(ray_actor_options={"num_gpus": 0.5}, max_concurrent_queries=1,
                       autoscaling_config={"min_replicas": 1, "max_replicas": 4,
                                           "target_num_ongoing_requests_per_replica": 1,
                                           "upscale_delay_s": 0})
    class Busy:
        def __call__(self, x):
            time.sleep(0.3)
            return x

    h = tserve.run(Busy.bind(), _blocking_http=False)
    resps = [h.remote(i) for i in range(8)]
    deadline, held_since = time.time() + 20, None
    while time.time() < deadline:
        st = tserve.status()["Busy"]
        assert st["num_replicas"] <= 2, st
        if st["num_replicas"] == 2 and held_since is None:
            held_since = time.time()
        if held_since is not None and time.time() - held_since > 2.0:
            break  # the load still asks for 4; two control-loop ticks later, still 2
        resps.append(h.remote(99))  # keeps the router reporting fresh load
        time.sleep(0.3)
    assert [r.result(timeout=TIMEOUT_S) for r in resps[:8]] == list(range(8))
    for r in resps[8:]:
        r.result(timeout=TIMEOUT_S)
    st = tserve.status()["Busy"]
    assert held_since is not None and st["num_replicas"] == 2, st
    assert st["gpu_replica_cap"] == 2 and len(st["replica_start_s"]) == 2


def test_replica_constructor_error_reaches_serve_run(both):
    # A TorchPredictor built with the default device in a replica that holds
    # no GPU share (CUDA_VISIBLE_DEVICES="") raises; serve.run raises with
    # its message, after one attempt (a constructor error is not retried).
    from ray_tpu_torch.train import TorchPredictor

    @tserve.deployment
    class NoShare:
        def __init__(self):
            import os

            self.visible = os.environ.get("CUDA_VISIBLE_DEVICES")
            self.p = TorchPredictor({"w": np.ones(2, np.float32)}, lambda p, x: x)

        def __call__(self, req):
            return "unreachable"

    t0 = time.perf_counter()
    with pytest.raises(Exception, match="ReplicaConstructorError") as e:
        tserve.run(NoShare.bind(), port=0)
    assert "no CUDA device" in str(e.value) and time.perf_counter() - t0 < TIMEOUT_S
    assert tserve.status()["NoShare"]["num_replicas"] == 0

    # The JAX package raises too (its creation error carries no cause).
    @jserve.deployment
    class Raises:
        def __init__(self):
            raise RuntimeError("constructor failed")

    with pytest.raises(Exception):
        jserve.run(Raises.bind(), port=0)
