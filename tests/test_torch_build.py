"""The kernel build's schedule: ``start`` launches the compilers without
waiting, ``finish`` waits for and loads what a caller needs, and each
source is compiled once however it is asked for.

``nvcc`` is not run here: the compile and load steps are replaced by
records of the calls, which is all the schedule decides.
"""

import pytest

from repro_torch import testing  # noqa: F401  (one torch thread per worker)
from repro_torch.kernels import build


@pytest.fixture
def calls(monkeypatch):
    log = []
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_pending", {})
    monkeypatch.setattr(build, "_start", lambda n: log.append(("start", n))
                        or f"proc-{n}")
    monkeypatch.setattr(build, "_finish", lambda n, started: log.append(
        ("finish", n, started)) or 1.5)
    monkeypatch.setattr(build, "_load", lambda n: f"lib-{n}")
    return log


def test_start_then_finish_waits_only_for_the_names_given(calls):
    build.start()
    assert calls == [("start", n) for n in build.SOURCES]
    assert set(build._pending) == set(build.SOURCES)
    assert build.finish(("quant", "votes")) == {"quant": 1.5, "votes": 1.5}
    assert build._loaded == {"quant": "lib-quant", "votes": "lib-votes"}
    assert list(build._pending) == ["attention", "attention_bwd"]
    assert build.finish(("attention", "attention_bwd")) == {
        "attention": 1.5, "attention_bwd": 1.5}
    assert not build._pending
    assert [c[0] for c in calls].count("start") == len(build.SOURCES)
    assert ("finish", "attention", "proc-attention") in calls


def test_each_source_is_compiled_once(calls):
    build.start(("attention",))
    assert build.library("attention") == "lib-attention"
    assert build.library("quant") == "lib-quant"
    assert build.build_all() == {"quant": 0.0, "votes": 1.5,
                                 "attention": 0.0, "attention_bwd": 1.5}
    build.start()
    assert build.finish() == {n: 0.0 for n in build.SOURCES}
    assert sorted(c[1] for c in calls if c[0] == "start") \
        == sorted(build.SOURCES)
    assert sorted(c[1] for c in calls if c[0] == "finish") \
        == sorted(build.SOURCES)
