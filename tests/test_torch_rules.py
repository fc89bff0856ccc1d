"""The port's ground rules: it imports nothing of JAX or of the JAX package,
its entry points default to the card, and nothing falls back from the CUDA
path to the plain one."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import (
    facility_location_from_features,
    facility_location_from_numpy,
    feature_coverage_from_numpy,
    greedy,
    ss_sparsify,
    streaming_facility_location_from_numpy,
    summarize,
)
from repro_torch.core import (
    CudaBackend,
    ReferenceBackend,
    SubmodularFunction,
    resolve_backend,
)
from repro_torch.data import clustered_embeddings, news_day, video

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) >= 15
    assert {"fl_divergence.py", "fl_stream.py"} <= {f.name for f in files}
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & FORBIDDEN


def _fn():
    return feature_coverage_from_numpy(news_day(0, 200, 32), device="cpu")


@pytest.mark.parametrize("call", ["gains", "gains_compact", "divergence",
                                  "divergence_compact", "ss_sparsify",
                                  "greedy", "summarize"])
def test_cuda_backend_refuses_cpu_tensors(call, fn=None):
    fn = _fn() if fn is None else fn
    be = CudaBackend()
    probes, cand = torch.tensor([1, 2, 3]), torch.arange(10)
    calls = {
        "gains": lambda: be.gains(fn, fn.empty_state()),
        "gains_compact": lambda: be.gains_compact(fn, fn.empty_state(), cand),
        "divergence": lambda: be.divergence(fn, probes),
        "divergence_compact": lambda: be.divergence_compact(fn, probes, cand),
        "ss_sparsify": lambda: ss_sparsify(fn, backend="cuda"),
        "greedy": lambda: greedy(fn, 3, backend="cuda"),
        "summarize": lambda: summarize(fn, 3, backend=be),
    }
    with pytest.raises(ValueError, match="CUDA tensors only"):
        calls[call]()


def test_backend_follows_the_device_never_the_reverse():
    assert isinstance(resolve_backend(None, torch.device("cpu")), ReferenceBackend)
    assert isinstance(resolve_backend(None, torch.device("cuda")), CudaBackend)
    assert isinstance(resolve_backend("reference", "cuda"), ReferenceBackend)
    be = CudaBackend()
    assert resolve_backend(be, "cpu") is be
    with pytest.raises(KeyError):
        resolve_backend("oracle", "cpu")
    with pytest.raises(ValueError):
        resolve_backend(None)


def test_objective_without_kernel_hooks_raises_under_cuda():
    class NoKernel(SubmodularFunction):
        n = 4
        device = torch.device("cuda")
        empty_state = value = gains = add = add_many = None
        pairwise_gains = residual_gains = None

    fn = NoKernel()
    with pytest.raises(NotImplementedError):
        CudaBackend().gains(fn, torch.zeros(3))
    with pytest.raises(NotImplementedError):
        CudaBackend().divergence(fn, torch.tensor([0]), residual=torch.zeros(4))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    W = np.ones((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        feature_coverage_from_numpy(W)
    assert feature_coverage_from_numpy(W, device="cpu").device.type == "cpu"


FL_OBJECTIVES = {
    "facility_location": lambda: facility_location_from_features(
        video(0, 200, 16), "cosine", device="cpu"),
    "streaming_facility_location": lambda: streaming_facility_location_from_numpy(
        clustered_embeddings(0, 200, 8), device="cpu"),
}


@pytest.mark.parametrize("objective", list(FL_OBJECTIVES))
@pytest.mark.parametrize("call", ["gains", "gains_compact", "divergence",
                                  "divergence_compact", "ss_sparsify",
                                  "greedy", "summarize"])
def test_cuda_backend_refuses_cpu_facility_location(call, objective):
    test_cuda_backend_refuses_cpu_tensors(call, FL_OBJECTIVES[objective]())


FL_ENTRY_POINTS = {
    "facility_location_from_numpy": lambda W, **kw: facility_location_from_numpy(
        W @ W.T, **kw),
    "facility_location_from_features": lambda W, **kw:
        facility_location_from_features(W, "dot", **kw),
    "streaming_facility_location_from_numpy": lambda W, **kw:
        streaming_facility_location_from_numpy(W, W, **kw),
}


@pytest.mark.parametrize("entry", list(FL_ENTRY_POINTS))
def test_facility_location_entry_points_default_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    W = np.ones((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FL_ENTRY_POINTS[entry](W)
    assert FL_ENTRY_POINTS[entry](W, device="cpu").device.type == "cpu"


def _lm_entry_points():
    from repro_torch import configs
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.models import init_params
    from repro_torch.serve import Engine

    cfg = configs.smoke("qwen3-4b")
    cpu_params = init_params(torch.Generator(), cfg, device="cpu")
    np_params = _numpy(cpu_params)
    return {
        "init_params": lambda **kw: init_params(torch.Generator(), cfg, **kw),
        "Engine": lambda **kw: Engine(cfg, cpu_params, **kw),
        "model_params_from_numpy": lambda **kw: model_params_from_numpy(
            np_params, cfg, **kw),
    }


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


@pytest.mark.parametrize("entry", ["init_params", "Engine",
                                   "model_params_from_numpy"])
def test_lm_entry_points_default_to_the_card(monkeypatch, entry):
    call = _lm_entry_points()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    call(device="cpu")     # the host works when asked for
