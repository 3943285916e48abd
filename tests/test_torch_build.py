"""`kernels/_build.py::build` is entered once when two threads reach it
together (the serving frontend's dispatch and resolve threads can both
launch a kernel first).  The compiler is a stub: a fake `nvcc` process
that takes a moment and writes its output file, and a fake library
loader, so the test runs on the CPU with no CUDA toolkit."""
import threading
import time

import pytest

from repro_torch.kernels import _build


class _FakeProc:
    calls = 0
    lock = threading.Lock()

    def __init__(self, cmd, **kw):
        with _FakeProc.lock:
            _FakeProc.calls += 1
        self.returncode = 0
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\0")

    def communicate(self):
        time.sleep(0.2)     # long enough for the other thread to arrive
        return "", None


class _FakeLib:
    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        return type("_Fn", (), {})()


@pytest.fixture()
def stub_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeProc)
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    monkeypatch.setattr(_build._State, "libs", None)
    _FakeProc.calls = 0
    yield tmp_path


def test_two_threads_build_once(stub_compiler):
    barrier = threading.Barrier(2)
    got, errors = [], []

    def caller():
        barrier.wait()
        try:
            got.append(_build.build())
        except Exception as e:     # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=caller) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert _FakeProc.calls == len(_build.SIGNATURES)    # one nvcc a source
    assert len(got) == 2 and got[0] is got[1]
    assert sorted(got[0]) == sorted(_build.SIGNATURES)
    libs = sorted(p.name for p in stub_compiler.rglob("*.so"))
    assert libs == sorted(f"lib{n}.so" for n in _build.SIGNATURES)


def test_built_libraries_are_reused(stub_compiler):
    first = _build.build()
    assert _build.build() is first
    assert _FakeProc.calls == len(_build.SIGNATURES)
