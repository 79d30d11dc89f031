"""Helpers of the libraries' parity tests (tests/test_torch_*_parity.py for
air, tune, data and workflow): the reference's own test modules loaded
for either package, each scenario run with its fixtures, and the outputs
of its calls recorded so the two packages' runs can be compared.

`load(filename, pkg)` executes a reference test module's source in a
namespace of its own: as it is for "ref", translated for "port" (the
package's name, the accelerator resource and its fields, the trainer and
predictor that run on it, and `device="cpu"` added to
`iter_torch_batches`, to rllib's learners, learner groups and algorithm
configs and to the `rllib` CLI, whose port defaults to the card).
`run(ns, name,
pkg, ...)` calls one of its tests with fixtures bound to the runtime the
calling test holds. `recording(pkg, targets)` wraps methods of the
package's classes and records what each outermost call returns, after
`normalize`.
"""

import contextlib
import functools
import inspect
import re
import threading
from pathlib import Path

import numpy as np

TESTS = Path(__file__).resolve().parent
PKG_NAME = {"ref": "ray_tpu", "port": "ray_tpu_torch"}


def to_port(src: str) -> str:
    """A reference test's source as the port runs it."""
    src = re.sub(r"\bray_tpu\b", "ray_tpu_torch", src)
    src = src.replace('"TPU"', '"GPU"').replace("num_tpus", "num_gpus")
    for ref, port in (("JaxTrainer", "MeshTrainer"),
                      ("JaxPredictor", "TorchPredictor"),
                      ("use_tpu", "use_gpu"),
                      ("chips_per_worker", "gpus_per_worker"),
                      ("get_tpu_ids", "get_gpu_ids")):
        src = re.sub(rf"\b{ref}\b", port, src)
    src = src.replace(".iter_torch_batches(", '.iter_torch_batches(device="cpu", ')
    return _rllib_on_cpu(src)


RL_LEARNERS = ("PPOLearner", "PGLearner", "A2CLearner", "ImpalaLearner",
               "APPOLearner", "DQNLearner", "SACLearner", "DDPGLearner",
               "MARWILLearner", "CQLLearner", "CRRLearner", "R2D2Learner")
RL_CONFIGS = ("A2CConfig", "A3CConfig", "PGConfig", "APPOConfig",
              "DQNConfig", "SimpleQConfig", "ImpalaConfig", "SACConfig",
              "DDPGConfig", "TD3Config", "ApexDQNConfig", "ApexDDPGConfig",
              "BCConfig", "MARWILConfig", "CQLConfig", "CRRConfig",
              "DTConfig", "QMixConfig", "MADDPGConfig", "R2D2Config",
              "DDPPOConfig")


def _rllib_on_cpu(src: str) -> str:
    """rllib's learners, learner groups, configs and CLI asked for the CPU
    at the call: `X(...)` of a learner becomes
    `functools.partial(X, device="cpu")(...)`, a LearnerGroup's kwargs
    dict gains `"device": "cpu"`, `PPOConfig()` gets `.learners(device=)`
    and the other configs `.training(device=)`, and `rllib train` and
    `rllib evaluate` get `--device cpu`."""
    names = "|".join(RL_LEARNERS)
    src, n = re.subn(rf"(?<![\w.])({names})\(",
                     r'__import__("functools").partial(\1, device="cpu")(',
                     src)
    src = re.sub(r"(\bLearnerGroup\(\s*\w+,\s*\{)", r'\1"device": "cpu", ',
                 src)
    src = re.sub(r"\bPPOConfig\(\)", 'PPOConfig().learners(device="cpu")',
                 src)
    src = re.sub(rf"\b({'|'.join(RL_CONFIGS)})\(\)",
                 r'\1().training(device="cpu")', src)
    return re.sub(r'"rllib", "(train|evaluate)",',
                  r'"rllib", "\1", "--device", "cpu",', src)


def load(filename: str, pkg: str) -> dict:
    src = (TESTS / filename).read_text()
    if pkg == "port":
        src = to_port(src)
    ns = {"__name__": f"_parity_{pkg}_{Path(filename).stem}",
          "__file__": str(TESTS / filename)}
    exec(compile(src, f"<{pkg}:{filename}>", "exec"), ns)
    return ns


def run(ns: dict, name: str, pkg: str, tmp_path: Path, request=None,
        extra=None):
    """Call test `name` of `ns` with its fixtures: the package for
    ray_start_regular and rt (its runtime already up), a fresh directory
    for tmp_path, pytest's monkeypatch, and any of `extra`."""
    import importlib

    module = importlib.import_module(PKG_NAME[pkg])
    fn = ns[name]
    kwargs = {}
    for arg in inspect.signature(fn).parameters:
        if extra and arg in extra:
            kwargs[arg] = extra[arg]
        elif arg in ("ray_start_regular", "rt"):
            kwargs[arg] = module
        elif arg == "tmp_path":
            d = tmp_path / pkg / name
            d.mkdir(parents=True, exist_ok=True)
            kwargs[arg] = d
        elif arg == "monkeypatch":
            kwargs[arg] = request.getfixturevalue("monkeypatch")
        else:
            raise KeyError(f"{name}: no fixture {arg!r}")
    return fn(**kwargs)


def normalize(v):
    """A value as plain, comparable Python: arrays as (dtype, shape,
    values), numpy scalars as Python numbers, dtypes as strings, dicts by
    sorted key."""
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, normalize(v.tolist()))
    if isinstance(v, np.generic):
        return normalize(v.item())
    if isinstance(v, (np.dtype, type)):
        return str(np.dtype(v)) if isinstance(v, np.dtype) else v.__name__
    if isinstance(v, dict):
        return {str(k): normalize(x) for k, x in sorted(v.items(),
                                                        key=lambda kv: str(kv[0]))}
    if isinstance(v, (list, tuple)):
        return [normalize(x) for x in v]
    if isinstance(v, float) and v != v:
        return "nan"
    return v


@contextlib.contextmanager
def recording(pkg: str, targets):
    """Record (label, normalize(result)) of each outermost call of the
    methods in `targets` ([(class, method name), ...], or (class, method
    name, summary) to record `summary(result)`) made in this process while
    the block runs."""
    calls = []
    depth = threading.local()
    saved = []

    def wrap(cls, name, orig, summary):
        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            level = getattr(depth, "n", 0)
            depth.n = level + 1
            try:
                out = orig(*args, **kwargs)
            finally:
                depth.n = level
            if level == 0:
                calls.append((f"{cls.__name__.rsplit('.', 1)[-1]}.{name}",
                              normalize(summary(out) if summary else out)))
            return out

        return wrapper

    for cls, name, *summary in targets:
        orig = cls.__dict__[name]
        saved.append((cls, name, orig))
        setattr(cls, name, wrap(cls, name, orig, (summary or [None])[0]))
    try:
        yield calls
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


def reference_tests(filename: str):
    """The test functions of a reference test module, in file order."""
    src = (TESTS / filename).read_text()
    return re.findall(r"^def (test_\w+)\(", src, flags=re.M)
