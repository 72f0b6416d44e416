"""The port's five examples (`examples/torch_*.py`) at a small size on
the CPU, each through its own `main(argv)` and its own checks (rel err
against the direct oracle below 1e-3, at least two algorithms, every
request answered, a valid trace, a falling loss and a resume that
reaches the uninterrupted run's loss)."""

import importlib.util
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _wisdom(tmp_path, monkeypatch):
    """Plans from the model alone, in a wisdom file of the test's own."""
    monkeypatch.setenv("REPRO_WISDOM", str(tmp_path / "wisdom.json"))


def test_quickstart():
    out = _example("torch_quickstart").main(["--device", "cpu", "--size", "16"])
    assert len(out["errs"]) >= 2 and max(out["errs"].values()) < 1e-3
    assert out["n_fused"] >= 1


def test_convnet_l3fusion():
    out = _example("torch_convnet_l3fusion").main(["--device", "cpu", "--reps", "1"])
    assert len(out["algos"]) >= 2 and out["rel"] < 1e-3 and out["rel_stride2"] < 1e-3


def test_serve_batch():
    out = _example("torch_serve_batch").main(["--device", "cpu", "--requests", "3",
                                              "--max-new", "4"])
    assert sorted(out) == [0, 1, 2]


def test_serve_online(tmp_path):
    trace = tmp_path / "online.trace.json"
    out = _example("torch_serve_online").main(["--device", "cpu", "--requests", "24",
                                               "--trace", str(trace)])
    assert out["served"] == 24 and out["events"] > 24
    assert json.loads(trace.read_text())


def test_train_lm(tmp_path):
    out = _example("torch_train_lm").main(["--device", "cpu", "--steps", "12",
                                           "--ckpt-every", "5", "--ckpt-dir", str(tmp_path)])
    assert out["resumed_from"] == 10 and len(out["resumed_losses"]) == 1
    assert out["losses"][-1] < out["losses"][0]
