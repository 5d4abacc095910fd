"""The port's build-on-first-use (omp_amg_tpu_torch/_build.py): concurrent
builds produce one library, atomically, and a failed build raises."""

import ctypes
import threading

import pytest

from omp_amg_tpu_torch import _build, native

SOURCE = 'extern "C" int answer(void) { return 42; }\n'


def test_concurrent_builds_make_one_library(tmp_path, monkeypatch):
    src = tmp_path / "answer.cc"
    src.write_text(SOURCE)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    flags = ("-O1", "-shared", "-fPIC")
    paths, errors = [], []

    def build():
        try:
            paths.append(_build._compile("libanswer", "g++", flags, [src]))
        except Exception as e:   # reported below, after the join
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(set(paths)) == 1
    built = sorted(p.name for p in (tmp_path / "build").glob("*.so"))
    assert built == [paths[0].name]          # no temporary files left
    assert ctypes.CDLL(str(paths[0])).answer() == 42


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed to build"):
        _build._compile("libbroken", "g++", ("-shared", "-fPIC"), [src])
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_library_is_built_from_source():
    assert native.available(), native.build_error()
    path = _build.native_library()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libamgnative-")
