"""The benchmark's user code: the per-worker training loop that
``TorchTrainer`` runs, and the pieces of it that the control and the tests
drive directly.

A worker makes the weights from the seed on its device, hands them to the
port as a ``TrainState``, builds ``make_train_step``, and trains the first
``checked_steps`` steps through the same call and feed as the window, reading
what the check compares (each step's loss, the first gradient as AdamW holds
it, the parameters' change). Those steps warm every shape the window uses.
Then the window: a fresh host batch a step from the traffic generator,
pinned and copied in the step as a data loader would, a CUDA event at every
step boundary, ``session.report`` every ``report_every`` steps (the one host
sync), and a synchronize at the first step boundary after ``seconds``. A
traced run then trains ``trace_steps`` more steps under ``torch.profiler``
with the device's activity alone, counting the MoE's routes over them, and
``host_trace_steps`` with the host's ops too, whose device time it splits by
the program's regions. Last, with the program's state freed, the reference
(``reference/<reference>.py``) follows the first steps on rank 0, and rank 0
reports every rank's readings. The configuration's architecture
(``archs/<model_type>.py``) gives the port's config, the weights and the
units the check compares.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import os
import time

from port_bench import archs

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ray_tpu")


def forbidden_modules():
    """Top-level names in ``sys.modules`` of JAX or the JAX package, each
    compared whole (``ray_tpu_torch`` is not ``ray_tpu``)."""
    import sys

    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def optimizer_settings(model):
    a = model["assumed"]
    return {k: a[k] for k in ("learning_rate", "weight_decay", "b1", "b2", "eps", "grad_clip")}


def traffic_generator(traffic, model, seed):
    gen = importlib.import_module(f"port_bench.traffic.{traffic['generator']}")
    return gen.make(traffic, model, seed)


class Worker:
    """One rank's program: weights, state, step and feed."""

    def __init__(self, cell, seed, device, mesh=None, rank=0, world=1):
        self.cell, self.seed, self.device, self.mesh = cell, int(seed), device, mesh
        self.rank, self.world = rank, world
        self.model, self.traffic = cell["model"], cell["traffic"]
        self.arch = archs.of(self.model)
        self.rows = self.traffic["rows_per_gpu"]
        self.tokens_per_step = self.rows * world * self.traffic["seq"]
        self.gen = traffic_generator(self.traffic, self.model, self.seed)
        self.prefetched = {}

    def build(self):
        """Weights from the seed, the port's state and step."""
        from port_bench.weights import leaves
        from ray_tpu_torch.models import default_optimizer, make_train_step
        from ray_tpu_torch.models.training import TrainState, param_shardings

        self.cfg = self.arch.port_config(self.model)
        o = optimizer_settings(self.model)
        self.opt = default_optimizer(learning_rate=o["learning_rate"],
                                     weight_decay=o["weight_decay"], b1=o["b1"], b2=o["b2"],
                                     grad_clip=o["grad_clip"])
        params = self.arch.init_params(self.model, self.seed, self.device)
        if self.mesh is not None:
            from ray_tpu_torch.parallel.mesh import distribute

            placements = param_shardings(self.cfg, self.mesh)

            def place(tree, where):
                return {k: place(v, where[k]) if isinstance(v, dict) else
                        distribute(v, self.mesh, where[k]) for k, v in tree.items()}

            params = place(params, placements)
        for _, leaf in leaves(params):
            leaf.requires_grad_(True)
        self.state = TrainState(params, self.opt.init(params), 0)
        self.step_fn = make_train_step(self.cfg, self.opt, mesh=self.mesh)

    def host_rows(self, step):
        """This rank's rows of the step's batch from the generator, pinned
        on a card."""
        import torch

        host = torch.from_numpy(self.gen.rows(step, self.rank * self.rows,
                                              (self.rank + 1) * self.rows))
        return host.pin_memory() if self.device.type == "cuda" else host

    def batch(self, step):
        """The step's batch, as a data loader gives it: rows made while the
        last step ran (``step`` prefetches the next), copied to the device
        without a sync."""
        host = self.prefetched.pop(step, None)
        if host is None:
            host = self.host_rows(step)
        tokens = host.to(self.device, non_blocking=True)
        if self.mesh is not None:
            from ray_tpu_torch.parallel.mesh import batch_spec, host_local_to_global

            tokens = host_local_to_global(self.mesh, batch_spec(), tokens)
        return {"tokens": tokens}

    def step(self, i):
        self.state, m = self.step_fn(self.state, self.batch(i))
        self.prefetched = {i + 1: self.host_rows(i + 1)}
        return m

    def checked_steps(self, on_first_step=None):
        """The first ``checked_steps`` steps, with what the check reads of
        them: each loss, each unit's norm of the first gradient as AdamW got
        it (its first moment over 1 - b1), and each unit's norm of the
        parameters' change over the steps (against the weights made anew
        from the seed, so no copy is held)."""
        from port_bench.weights import delta_norms, unit_norms

        units = self.arch.units
        losses, grads = [], None
        for i in range(self.traffic["checked_steps"]):
            losses.append(self.step(i)["loss"])
            if i == 0:
                grads = unit_norms(units(self.state.opt_state["mu"]), 1 / (1 - self.opt.b1))
                if on_first_step is not None:
                    on_first_step()
        start = self.arch.init_params(self.model, self.seed, self.device)
        delta = delta_norms(units(self.state.params), units(start))
        del start
        return {"losses": [float(x) for x in losses], "grad_units": grads, "delta_units": delta}

    def free(self):
        import torch

        for name in ("state", "step_fn", "opt"):
            self.__dict__.pop(name, None)
        self.prefetched = {}
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gc_timer(out):
    """A ``gc.callbacks`` entry that appends (generation, ms) of each
    collection to ``out``."""
    start = {}

    def timer(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter()
        elif "t" in start:
            out.append((info["generation"], (time.perf_counter() - start.pop("t")) * 1e3))

    return timer


def run_window(w, seconds, report, first_step, trace_steps=0):
    """The measured window from step ``first_step`` on, then, with
    ``trace_steps``, the traced steps. Returns the window's readings and the
    trace (None untraced)."""
    import torch

    from ray_tpu_torch.ops import launch_counts, reset_launch_counts

    cuda = w.device.type == "cuda"
    every = w.traffic["report_every"]
    multi = w.world > 1

    def agreed_stop(local):
        if not multi:
            return local
        import torch.distributed as dist

        flag = torch.tensor([1.0 if local else 0.0], device=w.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def train(i, n_steps, deadline, spans, events):
        """Steps from ``i`` until ``n_steps`` are done or, with a
        ``deadline``, the first step boundary past it (on a mesh, the first
        report boundary, agreed between the ranks)."""
        report_ms, losses, done = [], [], 0
        while True:
            with spans("port_bench.step"):
                m = w.step(i)
            i += 1
            done += 1
            if events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
            at_report = i % every == 0
            if at_report:
                with spans("port_bench.report"):
                    loss = m["loss"].item()
                    t = time.perf_counter()
                    report({"loss": loss, "step": i})
                    report_ms.append((time.perf_counter() - t) * 1e3)
                losses.append(loss)
            if n_steps is not None and done >= n_steps:
                return i, done, report_ms, losses
            if deadline is None:
                continue
            if not multi and time.perf_counter() >= deadline:
                return i, done, report_ms, losses
            if multi and at_report and agreed_stop(time.perf_counter() >= deadline):
                return i, done, report_ms, losses

    if multi:
        import torch.distributed as dist

        dist.barrier()
    sync(w.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(w.device)
    reset_launch_counts()
    events = []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    collections = []
    gc.callbacks.append(_gc_timer(collections))
    t_open_wall, t_open = time.time(), time.perf_counter()
    try:
        i, steps, report_ms, losses = train(first_step, None, t_open + seconds,
                                            lambda name: contextlib.nullcontext(),
                                            events if cuda else None)
        sync(w.device)
        window_s = time.perf_counter() - t_open
    finally:
        gc.callbacks.pop()
    launches = launch_counts()
    boundaries = [start.elapsed_time(ev) for ev in events] if cuda else []
    out = {"open_wall": t_open_wall, "seconds": window_s, "steps": steps,
           "tokens": steps * w.tokens_per_step, "boundaries_ms": boundaries,
           "report_ms": report_ms, "losses": losses, "launches": launches,
           "gc_ms": collections,
           "peak_bytes": torch.cuda.max_memory_allocated(w.device) if cuda else None}
    trace = None
    if trace_steps:
        from torch.profiler import ProfilerActivity, profile, record_function

        from port_bench import regions
        from port_bench import trace as tracing
        from ray_tpu_torch.models.moe import reset_route_counts, route_counts

        # The MoE's route counter launches its kernel only from a process's
        # first reset on: it counts the traced steps, and the timed window
        # above ran without it. On a card it counts the steps that trace the
        # device alone; on the CPU, the host-traced ones.
        if cuda:
            # The profiler's first use in a process sets it up: trace two
            # steps first and drop them.
            with profile(activities=[ProfilerActivity.CUDA]):
                i, _, _, _ = train(i, 2, None, lambda name: contextlib.nullcontext(), None)
                sync(w.device)
            # The device's timeline, with the host's ops untraced: tracing
            # them slows the host's dispatch enough to starve the card.
            begin, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                sync(w.device)
                reset_route_counts()
                begin.record()
                i, done, _, out["trace_losses"] = train(
                    i, trace_steps, None, lambda name: contextlib.nullcontext(), None)
                end.record()
                sync(w.device)
            trace = tracing.collect(prof, done, window_us=begin.elapsed_time(end) * 1e3)
            trace["moe_routes"] = route_counts()
        else:
            reset_route_counts()
        # What the host does while the card waits: a few steps with the
        # host's ops traced too, each gap named by the op running, and each
        # device activity by the program's region that launched it.
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW):
                _, done, _, _ = train(i, w.traffic["host_trace_steps"], None, record_function,
                                      None)
                sync(w.device)
        host = tracing.collect(prof, done)
        if cuda:
            trace.update(idle_us_by_host_op=host["idle_us_by_host_op"], ranges=host["ranges"],
                         host_steps=done, host_window_us=host["window_us"])
        else:
            trace = dict(host, moe_routes=route_counts())
        trace["regions"] = regions.collect(prof, done)
    return out, trace


def reference_readings(cell, seed, device, precision="f32"):
    """The reference's readings of the first ``checked_steps`` steps on the
    whole global batch: each loss, each unit's norm of the first clipped
    gradient, and each unit's norm of the parameters' change."""
    import torch

    from port_bench.weights import delta_norms, unit_norms

    model, traffic = cell["model"], cell["traffic"]
    arch = archs.of(model)
    gen = traffic_generator(traffic, model, seed)
    rows = traffic["rows_per_gpu"] * traffic["workers"]
    params = arch.init_params(model, seed, device)
    batches = [torch.from_numpy(gen.rows(i, 0, rows)).to(device)
               for i in range(traffic["checked_steps"])]
    seen = {}

    def on_step(i, clipped):
        if i == 0:
            seen["grad_units"] = unit_norms(arch.units(clipped))

    seen["losses"] = archs.reference(model).train(params, batches, model,
                                                  optimizer_settings(model), precision,
                                                  on_step=on_step)
    seen["delta_units"] = delta_norms(arch.units(params),
                                      arch.units(arch.init_params(model, seed, device)))
    return seen


def train_loop(config):
    """The per-worker loop ``TorchTrainer`` runs (see the module's doc)."""
    stamps = {"loop_start": time.time()}
    import torch

    from ray_tpu_torch.air import session

    cell = config["cell"]
    if config.get("fault"):
        from port_bench import faults

        faults.plant(config["fault"], cell["model"])
    rank, world = session.get_world_rank(), session.get_world_size()
    if config["device"] == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the CUDA context
    else:
        device = torch.device("cpu")
    stamps["torch_cuda"] = time.time()
    mesh = session.get_mesh() if world > 1 else None
    stamps["mesh"] = time.time()
    w = Worker(cell, config["seed"], device, mesh, rank, world)
    w.build()
    sync(device)
    stamps["weights"] = time.time()
    checked = w.checked_steps(
        on_first_step=lambda: (sync(device), stamps.__setitem__("first_step", time.time())))
    session.report({"loss": checked["losses"][-1], "step": w.state.step})
    sync(device)
    # What set-up made lives as long as the run: a full collection in the
    # window scans only what the window makes, as a long training loop does.
    gc.collect()
    gc.freeze()
    stamps["checked"] = time.time()
    window, trace = run_window(w, config["seconds"], session.report,
                               first_step=w.traffic["checked_steps"],
                               trace_steps=w.traffic["trace_steps"] if config["trace"] else 0)
    stamps["window_open"] = window.pop("open_wall")
    w.free()
    payload = {"rank": rank, "world": world, "stamps": stamps, "program": checked,
               "window": window, "trace": trace, "pid": os.getpid(),
               "device": str(device), "forbidden_modules": forbidden_modules(),
               "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                               else "cpu")}
    if rank == 0:
        t = time.perf_counter()
        payload["reference"] = reference_readings(cell, config["seed"], device)
        payload["reference_s"] = time.perf_counter() - t
    if world > 1:
        import torch.distributed as dist

        gathered = [None] * world if rank == 0 else None
        dist.gather_object(payload, gathered, dst=0)
        if rank == 0:
            session.report({"ranks": gathered})
        else:
            session.report({"ranks": None})
    else:
        session.report({"ranks": [payload]})
