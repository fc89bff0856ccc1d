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
    lazy_greedy,
    sieve_extend,
    sieve_init,
    sieve_streaming,
    sieve_update,
    ss_sparsify,
    stochastic_greedy,
    stream_sieve_init,
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
    assert {"fl_divergence.py", "fl_stream.py", "sieve.py",
            "sieve_gains.py"} <= {f.name for f in files}
    rel = {f.relative_to(ROOT / "src" / "repro_torch").as_posix() for f in files}
    assert {"obs/__init__.py", "obs/events.py", "obs/metrics.py", "obs/trace.py",
            "serve/faults.py", "serve/summarize_service.py", "serve/wal.py",
            "serve/sessions.py", "api.py", "launch/mesh.py", "launch/steps.py",
            "launch/cost.py", "launch/roofline.py", "launch/dryrun.py",
            "configs/paper_ss.py", "data/video_eval.py", "core/distributed.py"} <= rel
    # the sharded tests' ranks run the port alone, as the card's script does
    return files + [ROOT / "chip_smoke.py", ROOT / "chip_peak_probe.py",
                    ROOT / "chip_dtensor_probe.py",
                    ROOT / "tests" / "torch_sharded_ranks.py",
                    ROOT / "tests" / "torch_lm_sharded_ranks.py",
                    ROOT / "tests" / "torch_dryrun_sharded_ranks.py"] + [
        ROOT / "examples" / f"{name}_torch.py"
        for name in ("quickstart", "video_summarize", "serve_kv_pruning",
                     "train_lm_ss")]


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


CALLS = ["gains", "gains_compact", "divergence", "divergence_compact",
         "ss_sparsify", "greedy", "summarize", "stochastic_greedy",
         "lazy_greedy", "sieve_table", "sieve_streaming", "sieve_extend",
         "sieve_update"]


@pytest.mark.parametrize("call", CALLS)
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
        "stochastic_greedy": lambda: stochastic_greedy(fn, 3, backend="cuda"),
        "lazy_greedy": lambda: lazy_greedy(fn, 3, backend=be),
        "sieve_table": lambda: be.sieve_table(fn, fn.empty_state()[None], None),
        "sieve_streaming": lambda: sieve_streaming(fn, 3, backend="cuda"),
        "sieve_extend": lambda: sieve_extend(fn, sieve_init(fn, 3), cand,
                                             backend=be),
        "sieve_update": lambda: sieve_update(fn, sieve_init(fn, 3, eps=0.2), 1,
                                             backend="cuda"),
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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_sieve_init(3, 8)
    assert stream_sieve_init(3, 8, device="cpu").cov.device.type == "cpu"


def test_every_kernel_source_is_built():
    """The build compiles every ``csrc/*.cu``, the sieve's table and both
    flash backward routes included, and each source has a wrapper that
    counts its launches."""
    from repro_torch.kernels import _build

    built = {p.name for p in _build.CSRC.glob("*.cu")}
    assert {"ss_divergence.cu", "feature_gains.cu", "fl_divergence.cu",
            "fl_stream.cu", "flash_attention.cu", "flash_attention_tc.cu",
            "sieve_gains.cu", "flash_attention_bwd.cu",
            "flash_attention_bwd_tc.cu"} == built
    text = Path(_build.__file__).read_text()
    assert "lib.sieve_gains_launch.argtypes" in text
    assert "lib.flash_attention_bwd_launch.argtypes" in text
    assert "lib.flash_attention_bwd_tc_launch.argtypes" in text


FL_OBJECTIVES = {
    "facility_location": lambda: facility_location_from_features(
        video(0, 200, 16), "cosine", device="cpu"),
    "streaming_facility_location": lambda: streaming_facility_location_from_numpy(
        clustered_embeddings(0, 200, 8), device="cpu"),
}


@pytest.mark.parametrize("objective", list(FL_OBJECTIVES))
@pytest.mark.parametrize("call", CALLS)
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


SERVICE_ENTRY_POINTS = {
    "SummarizeService": lambda **kw: _service_module().SummarizeService(**kw),
    "api.serve": lambda **kw: _api().serve(**kw),
    "api.summarize": lambda **kw: _api().summarize(news_day(0, 64, 16), k=3, **kw),
    "api.default_service": lambda **kw: _api().default_service(**kw),
}


def _service_module():
    from repro_torch.serve import summarize_service

    return summarize_service


def _api():
    from repro_torch import api

    return api


SESSION_ENTRY_POINTS = {
    "SessionEngine": lambda **kw: _sessions_module().SessionEngine(**kw),
    "api.sessions": lambda **kw: _api().sessions(**kw),
    "api.default_engine": lambda **kw: _api().default_engine(**kw),
    "api.open_session": lambda **kw: (
        _api().open_session(engine=_api().sessions(**kw)) if kw
        else _api().open_session()),
}


def _sessions_module():
    from repro_torch.serve import sessions

    return sessions


@pytest.mark.parametrize("entry", list(SESSION_ENTRY_POINTS))
def test_session_entry_points_default_to_the_card(monkeypatch, entry):
    """The session engine and the facade verbs that create one run on the
    card unless the host is asked for: ``api.open_session`` with no engine
    creates the default engine there, and raises on a host without one."""
    call = SESSION_ENTRY_POINTS[entry]
    monkeypatch.setattr(_api(), "_default_engine", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    call(device="cpu")


@pytest.mark.parametrize("entry", list(SERVICE_ENTRY_POINTS))
def test_service_entry_points_default_to_the_card(monkeypatch, entry):
    """The service and the facade verbs that create one run on the card
    unless the host is asked for, and raise on a host without one."""
    call = SERVICE_ENTRY_POINTS[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    if entry != "api.default_service":      # a process-wide singleton
        call(device="cpu")
