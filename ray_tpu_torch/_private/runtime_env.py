"""Runtime environments: per-task/actor pip packages, working_dir, py_modules.

Reference: `python/ray/_private/runtime_env/` + the per-node agent
(`dashboard/modules/runtime_env/runtime_env_agent.py:162 GetOrCreateRuntimeEnv`)
— envs are created once per node, cached by content hash, and workers using an
env get it applied before their task loop. Here setup runs inside the worker
process at startup (`worker_main.worker_loop`): simpler than a separate agent,
same cache-by-hash behavior (concurrent workers coordinate via an atomic
marker), and failures surface as RuntimeEnvSetupError on the tasks.

Supported keys:
  env_vars: {str: str}        — applied by the scheduler at spawn (spec.env_vars)
  pip: [requirement|wheel]    — `pip install --target` into the cached env dir
  pip_install_options: [str]  — extra pip flags (e.g. ["--no-index"])
  working_dir: path           — copied into the env dir; cwd + sys.path for the worker
  py_modules: [path]          — modules/packages copied onto sys.path
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, Optional

_SETUP_KEYS = ("pip", "pip_install_options", "working_dir", "py_modules")
CACHE_ROOT = os.environ.get(
    "RAY_TPU_TORCH_RUNTIME_ENV_CACHE",
    os.path.join(tempfile.gettempdir(), "ray_tpu_torch_runtime_envs"),
)


class RuntimeEnvPlugin:
    """Extension seam for runtime_env keys beyond the built-ins (reference:
    `python/ray/_private/runtime_env/plugin.py` RuntimeEnvPlugin — conda and
    container ship as plugins there too).

    build() runs once per env hash while the cache dir is being provisioned;
    activate() runs in every worker process adopting the env."""

    def build(self, value: Any, env_dir: str) -> None:
        pass

    def activate(self, value: Any, env_dir: str) -> None:
        pass


class _BrokenPlugin(RuntimeEnvPlugin):
    """Stand-in for a plugin this process failed to import: provisioning
    fails loudly instead of tasks silently running without their env."""

    def __init__(self, cls_path: str, error: str):
        self._cls_path = cls_path
        self._error = error

    def _raise(self):
        raise RuntimeError(
            f"runtime_env plugin {self._cls_path!r} failed to import in this "
            f"process: {self._error}"
        )

    def build(self, value, env_dir):
        self._raise()

    def activate(self, value, env_dir):
        # A cache hit skips build(): activation must fail just as loudly or
        # the task would run with the plugin's per-worker setup missing.
        self._raise()


_PLUGINS: Dict[str, RuntimeEnvPlugin] = {}
_PLUGINS_ENV = "RAY_TPU_TORCH_RUNTIME_ENV_PLUGINS"
_plugins_loaded = False


def register_runtime_env_plugin(key: str, plugin: RuntimeEnvPlugin) -> None:
    """Register in THIS process and, when the plugin class is importable,
    record it in the environment so worker processes load it too (reference:
    the RAY_RUNTIME_ENV_PLUGINS class-path mechanism). Plugins defined in
    __main__ or test modules only exist driver-side — their build/activate
    would silently no-op in workers, so importability matters.

    TIMING: register BEFORE ray_tpu_torch.init() — like the reference's env-var
    mechanism, plugins are startup configuration. Processes already running
    (a pre-started head, remote node daemons) captured their environment at
    spawn; for multi-node clusters set RAY_TPU_TORCH_RUNTIME_ENV_PLUGINS in every
    node's environment instead."""
    if key in _SETUP_KEYS or key == "env_vars":
        raise ValueError(f"'{key}' is a built-in runtime_env key")
    _PLUGINS[key] = plugin
    cls = type(plugin)
    mod = cls.__module__
    if mod not in (__name__, "__main__"):
        entries = json.loads(os.environ.get(_PLUGINS_ENV, "[]"))
        entry = {"key": key, "cls": f"{mod}:{cls.__qualname__}"}
        if entry not in entries:
            entries.append(entry)
            os.environ[_PLUGINS_ENV] = json.dumps(entries)


def _load_env_plugins() -> None:
    """Import plugins advertised by the driver (workers inherit the env)."""
    global _plugins_loaded
    if _plugins_loaded:
        return
    _plugins_loaded = True
    import importlib

    for entry in json.loads(os.environ.get(_PLUGINS_ENV, "[]")):
        key = entry.get("key")
        if not key or key in _PLUGINS:
            continue
        try:
            mod_name, qual = entry["cls"].split(":", 1)
            obj = importlib.import_module(mod_name)
            for part in qual.split("."):
                obj = getattr(obj, part)
            _PLUGINS[key] = obj()
        except Exception as e:  # noqa: BLE001
            # Register a POISONED stand-in rather than skipping: skipping
            # would make needs_isolated_worker() False and silently run the
            # task with NO runtime env. This way the key still hashes and
            # build() fails the task with the import error.
            _PLUGINS[key] = _BrokenPlugin(entry.get("cls", key), repr(e))


def _plugin_keys(renv: Dict[str, Any]):
    _load_env_plugins()
    return [k for k in renv if k in _PLUGINS and renv.get(k)]


def needs_isolated_worker(renv: Optional[Dict[str, Any]]) -> bool:
    """True if this runtime_env requires per-env worker pooling (anything
    beyond env_vars, which plain workers already apply per task)."""
    if not renv:
        return False
    return any(renv.get(k) for k in _SETUP_KEYS) or bool(_plugin_keys(renv))


def env_hash(renv: Optional[Dict[str, Any]]) -> str:
    if not needs_isolated_worker(renv):
        return ""
    payload = {k: renv.get(k) for k in _SETUP_KEYS if renv.get(k)}
    for k in _plugin_keys(renv):
        payload[k] = renv.get(k)
    return hashlib.sha1(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


# ----------------------------------------------------------- bundled plugins
class CondaPlugin(RuntimeEnvPlugin):
    """`conda: <env name>` or `conda: {dependencies: [...]}` (reference:
    `_private/runtime_env/conda.py`). Gated on a conda binary: absence is a
    RuntimeEnvSetupError at provision time, surfaced per task."""

    def _conda(self) -> str:
        import shutil as _shutil

        exe = _shutil.which("conda") or _shutil.which("mamba")
        if exe is None:
            raise RuntimeError(
                "runtime_env['conda'] requires a conda/mamba binary on the "
                "node; none found on PATH"
            )
        return exe

    def build(self, value: Any, env_dir: str) -> None:
        exe = self._conda()
        prefix = os.path.join(env_dir, "conda")
        if isinstance(value, str):
            # Named pre-existing env: cloned so the cache dir owns it.
            cmd = [exe, "create", "--yes", "--prefix", prefix, "--clone", value]
        else:
            spec_path = os.path.join(env_dir, "conda_env.json")
            with open(spec_path, "w") as f:
                json.dump(value, f)
            cmd = [exe, "env", "create", "--yes", "--prefix", prefix,
                   "--file", spec_path]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"conda env create failed (rc={proc.returncode}):\n"
                f"{proc.stderr[-4000:]}"
            )

    def activate(self, value: Any, env_dir: str) -> None:
        prefix = os.path.join(env_dir, "conda")
        bin_dir = os.path.join(prefix, "bin")
        if os.path.isdir(bin_dir):
            os.environ["PATH"] = bin_dir + os.pathsep + os.environ.get("PATH", "")
            os.environ["CONDA_PREFIX"] = prefix
        site = os.path.join(prefix, "lib")
        if os.path.isdir(site):
            for entry in sorted(os.listdir(site)):
                sp = os.path.join(site, entry, "site-packages")
                if entry.startswith("python") and os.path.isdir(sp):
                    sys.path.insert(0, sp)


class ContainerPlugin(RuntimeEnvPlugin):
    """`container: {"image": ..., "run_options": [...]}` (reference:
    `_private/runtime_env/container.py` wraps the worker command in podman).

    The real work happens on the SPAWN path, not here: the node spawning a
    worker for this env wraps the worker command via `wrap_worker_command`
    (podman/docker run with the session/shm dir, framework source, and env
    cache mounted, env forwarded, host network). build() runs inside the
    worker — i.e. inside the container when wrapping succeeded — so it only
    validates that the wrap actually happened and fails the task with a clear
    error when the node had no container binary."""

    def build(self, value: Any, env_dir: str) -> None:
        image = value.get("image") if isinstance(value, dict) else value
        if not image:
            raise RuntimeError(
                "runtime_env['container'] needs an 'image' "
                '(e.g. {"image": "rayproject/ray:latest"})'
            )
        self.activate(value, env_dir)

    def activate(self, value: Any, env_dir: str) -> None:
        # Validated in activate() — i.e. in EVERY worker adopting the env —
        # not just build(): with a shared env cache a later worker can find
        # .DONE already written, skip build(), and still have been launched
        # unwrapped by a node without a container binary.
        if os.environ.get("RAY_TPU_TORCH_IN_CONTAINER") != "1":
            raise RuntimeError(
                "runtime_env['container'] requires podman or docker on the "
                "node spawning the worker; neither was found, so the worker "
                "was launched unwrapped"
            )


def container_binary() -> Optional[str]:
    """The container runtime to wrap worker commands with.
    RAY_TPU_TORCH_CONTAINER_BINARY overrides discovery (tests point it at a shim)."""
    exe = os.environ.get("RAY_TPU_TORCH_CONTAINER_BINARY")
    if exe:
        return exe
    return shutil.which("podman") or shutil.which("docker")


def wrap_worker_command(
    renv: Optional[Dict[str, Any]],
    cmd: list,
    env: Dict[str, str],
    mounts: list,
) -> list:
    """Wrap a worker spawn command in `podman/docker run` when the task's
    runtime_env requests a container (reference:
    `_private/runtime_env/container.py` — the worker process itself runs
    inside the container). Mounts carry the shm/session dir (object arena +
    control socket), the framework source, and the runtime-env cache; env
    vars the worker needs are forwarded explicitly (a container does not
    inherit host env). Returns `cmd` unchanged when no container is requested
    or no binary exists — in the latter case ContainerPlugin.build fails the
    task with the real reason from inside the unwrapped worker."""
    value = (renv or {}).get("container")
    if not value:
        return cmd
    image = value.get("image") if isinstance(value, dict) else str(value)
    exe = container_binary()
    if exe is None or not image:
        return cmd
    env["RAY_TPU_TORCH_IN_CONTAINER"] = "1"
    wrapped = [exe, "run", "--rm", "--network=host"]
    seen = set()
    for m in list(mounts) + [CACHE_ROOT]:
        if m and m not in seen:
            seen.add(m)
            wrapped += ["-v", f"{m}:{m}"]
    for k, v in env.items():
        if k.startswith(("RAY_TPU_TORCH_", "PYTHON", "CUDA_", "NCCL_")):
            wrapped += ["--env", f"{k}={v}"]
    if isinstance(value, dict):
        wrapped += [str(o) for o in (value.get("run_options") or [])]
    wrapped.append(image)
    return wrapped + cmd


register_runtime_env_plugin("conda", CondaPlugin())
register_runtime_env_plugin("container", ContainerPlugin())


def _install_pip(renv: Dict[str, Any], target: str) -> None:
    reqs = list(renv.get("pip") or [])
    if not reqs:
        return
    cmd = [
        sys.executable, "-m", "pip", "install",
        "--target", target,
        "--no-warn-script-location",
        "--disable-pip-version-check",
    ] + list(renv.get("pip_install_options") or []) + reqs
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"pip install failed (rc={proc.returncode}):\n{proc.stdout[-4000:]}"
        )


def _copy_working_dir(renv: Dict[str, Any], env_dir: str) -> Optional[str]:
    src = renv.get("working_dir")
    if not src:
        return None
    dst = os.path.join(env_dir, "working_dir")
    if not os.path.exists(dst):
        shutil.copytree(src, dst, symlinks=True)
    return dst


def _copy_py_modules(renv: Dict[str, Any], pkg_dir: str) -> None:
    for mod in renv.get("py_modules") or []:
        base = os.path.basename(mod.rstrip("/"))
        dst = os.path.join(pkg_dir, base)
        if os.path.exists(dst):
            continue
        if os.path.isdir(mod):
            shutil.copytree(mod, dst, symlinks=True)
        else:
            os.makedirs(pkg_dir, exist_ok=True)
            shutil.copy2(mod, dst)


def ensure_runtime_env(renv: Optional[Dict[str, Any]], timeout_s: float = 300.0) -> Optional[str]:
    """Create (or reuse) the cached env dir for `renv`; returns its path.

    Concurrency: the first worker to claim the hash dir builds it and writes a
    DONE marker; others wait for the marker (the per-node agent's
    GetOrCreateRuntimeEnv semantics, without the agent)."""
    h = env_hash(renv)
    if not h:
        return None
    env_dir = os.path.join(CACHE_ROOT, h)
    done = os.path.join(env_dir, ".DONE")
    fail = os.path.join(env_dir, ".FAILED")
    builder = False
    for _attempt in range(2):
        try:
            os.makedirs(env_dir)
            builder = True
            break
        except FileExistsError:
            if os.path.exists(fail):
                # A previous build failed: retire the poisoned dir (atomic
                # rename claims it against concurrent retirers) and rebuild
                # instead of failing forever.
                trash = f"{env_dir}.trash.{os.getpid()}.{int(time.time() * 1e6)}"
                try:
                    os.rename(env_dir, trash)
                    shutil.rmtree(trash, ignore_errors=True)
                except OSError:
                    time.sleep(0.1)  # another process is retiring/rebuilding
                continue
            break
    if builder:
        try:
            pkg_dir = os.path.join(env_dir, "pkgs")
            os.makedirs(pkg_dir, exist_ok=True)
            _install_pip(renv, pkg_dir)
            _copy_working_dir(renv, env_dir)
            _copy_py_modules(renv, pkg_dir)
            for key in _plugin_keys(renv):
                _PLUGINS[key].build(renv[key], env_dir)
            with open(done, "w") as f:
                f.write("ok")
        except Exception as e:  # noqa: BLE001
            with open(fail, "w") as f:
                f.write(repr(e))
            raise
    else:
        deadline = time.time() + timeout_s
        while not os.path.exists(done):
            if os.path.exists(fail):
                with open(fail) as f:
                    raise RuntimeError(f"runtime_env build failed: {f.read()}")
            if time.time() > deadline:
                # Builder likely died mid-build (no marker either way): retire
                # the partial dir so the next task rebuilds from scratch.
                trash = f"{env_dir}.trash.{os.getpid()}.{int(time.time() * 1e6)}"
                try:
                    os.rename(env_dir, trash)
                    shutil.rmtree(trash, ignore_errors=True)
                except OSError:
                    pass
                raise TimeoutError(f"timed out waiting for runtime_env {h}")
            time.sleep(0.1)
    return env_dir


def apply_runtime_env(renv: Optional[Dict[str, Any]]) -> None:
    """Make the env active in THIS process: sys.path for pip/py_modules, cwd +
    sys.path for working_dir. Called once at worker startup."""
    env_dir = ensure_runtime_env(renv)
    if env_dir is None:
        return
    pkg_dir = os.path.join(env_dir, "pkgs")
    if os.path.isdir(pkg_dir):
        sys.path.insert(0, pkg_dir)
    wd = os.path.join(env_dir, "working_dir")
    if os.path.isdir(wd):
        os.chdir(wd)
        sys.path.insert(0, wd)
    for key in _plugin_keys(renv or {}):
        _PLUGINS[key].activate(renv[key], env_dir)
