"""`repro_torch.launch.serve --trace` against the reference's
`repro.launch.serve --trace`, on the CPU: the same arguments write a
Chrome trace with the same event names and counts (a ``serve:<arch>``
span around the engine's run, one ``request:<rid>`` instant per
request), valid by the port's own check."""

import collections
import json

import pytest

from repro.launch import serve as ref_serve
from repro_torch.convserve.obs import validate_chrome_trace
from repro_torch.launch import serve

ARGS = ["--arch", "gemma3-1b", "--requests", "5", "--max-new", "3", "--seed", "2"]


def _events(path):
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return data, [e for e in events if e.get("ph") != "M"]


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("traces")
    ref, port = str(d / "ref.trace.json"), str(d / "port.trace.json")
    ref_serve.main(ARGS + ["--trace", ref])
    results = serve.main(ARGS + ["--trace", port, "--device", "cpu"])
    return ref, port, results


def test_trace_events_equal_the_reference(traces):
    ref, port, results = traces
    _, want = _events(ref)
    data, got = _events(port)
    assert validate_chrome_trace(data) == []
    count = lambda evs: collections.Counter((e["name"], e["ph"], e.get("cat")) for e in evs)
    assert count(got) == count(want)
    names = [e["name"] for e in got]
    assert names.count("serve:gemma3-1b") == 1
    assert sorted(n for n in names if n.startswith("request:")) == sorted(
        f"request:{rid}" for rid in results)
    tokens = {e["name"]: e["args"]["tokens"] for e in got if e["name"].startswith("request:")}
    assert tokens == {f"request:{rid}": len(v) for rid, v in results.items()}


def test_without_trace_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    results = serve.main(["--arch", "gemma3-1b", "--requests", "2", "--max-new", "2",
                          "--device", "cpu"])
    assert sorted(results) == [0, 1] and not list(tmp_path.iterdir())
