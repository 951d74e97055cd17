"""The port's token loaders (``dataio.py``: the native C++ loader built
from ``csrc/tokenloader.cpp``, and the numpy engine) against the JAX
package's ``NativeTokenLoader`` and ``PyTokenLoader``, on the CPU with
``g++``.  Streams are compared exactly, row for row, on
``data/corpus.bin``.  The JAX native loader is built here from the JAX
package's own ``native/tokenloader.cpp`` into a temporary directory, so
nothing writes into ``native/build/``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess

import numpy as np
import pytest

from tpu_autoscaler import dataio as jax_dataio
from tpu_autoscaler_torch import dataio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_BIN = os.path.join(REPO, "data", "corpus.bin")
STEPS = list(range(64)) + list(range(400, 601, 50))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's C++ loader built from its source into a
    temporary directory (native/Makefile's flags), in the JAX front
    end's library cache while the module's tests run."""
    out = tmp_path_factory.mktemp("jax_native") / "libtokenloader.so"
    subprocess.run(
        ["g++", "-O2", "-fPIC", "-std=c++17", "-Wall", "-shared", "-o",
         str(out), os.path.join(REPO, "native", "tokenloader.cpp"),
         "-lpthread"], check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(out))
    jax_dataio._configure_tokenloader(lib)
    saved = dict(jax_dataio._tl_cache)
    jax_dataio._tl_cache["lib"] = lib
    yield lib
    jax_dataio._tl_cache.clear()
    jax_dataio._tl_cache.update(saved)


@pytest.fixture
def fresh_lib(monkeypatch):
    """The port's library verdict forgotten for one test."""
    monkeypatch.setattr(dataio, "_lib_state", {})


def _engines(jax_native, seed):
    args = (CORPUS_BIN, 16, 257, seed)
    return {"port native": dataio.NativeTokenLoader(*args),
            "port numpy": dataio.PyTokenLoader(*args),
            "jax native": jax_dataio.NativeTokenLoader(*args),
            "jax numpy": jax_dataio.PyTokenLoader(*args)}


@pytest.mark.parametrize("seed", [0, 1])
def test_four_engines_give_one_stream(jax_native, seed):
    """Batch 16, window 257 (the converge run's), steps 0-63 then 400-600
    by 50, in order (so the native engines serve each step from the
    prefetch the step before started, or cold after a jump)."""
    engines = _engines(jax_native, seed)
    try:
        assert {e.n_tokens for e in engines.values()} == {199_762}
        for step in STEPS:
            want = engines["jax numpy"].next(step)
            assert want.shape == (16, 257) and want.dtype == np.uint32
            for name, engine in engines.items():
                np.testing.assert_array_equal(engine.next(step), want,
                                              err_msg=f"{name} step {step}")
    finally:
        for engine in engines.values():
            engine.close()


def test_streams_differ_by_seed_and_step():
    a = dataio.NativeTokenLoader(CORPUS_BIN, 4, 33, seed=0)
    b = dataio.NativeTokenLoader(CORPUS_BIN, 4, 33, seed=1)
    try:
        assert not np.array_equal(a.next(5), b.next(5))
        assert not np.array_equal(a.next(5), a.next(6))
        np.testing.assert_array_equal(a.next(5), a.next(5))
    finally:
        a.close()
        b.close()


def test_prefetched_step_equals_a_cold_read(jax_native):
    """next(step) starts the prefetch of step + 1; that buffered batch
    equals a cold loader's, and JAX's prefetched one."""
    ours = dataio.NativeTokenLoader(CORPUS_BIN, 4, 16, seed=9)
    theirs = jax_dataio.NativeTokenLoader(CORPUS_BIN, 4, 16, seed=9)
    try:
        ours.next(0)
        theirs.next(0)
        warm = ours.next(1)
        cold = dataio.PyTokenLoader(CORPUS_BIN, 4, 16, seed=9).next(1)
        np.testing.assert_array_equal(warm, cold)
        np.testing.assert_array_equal(warm, theirs.next(1))
    finally:
        ours.close()
        theirs.close()


def test_missing_and_short_shards_raise_the_jax_errors(jax_native, tmp_path):
    missing = str(tmp_path / "missing.bin")
    short = str(tmp_path / "short.bin")
    dataio.write_token_file(short, np.arange(4, dtype=np.uint32))
    for path, window in ((missing, 4), (short, 8)):
        with pytest.raises(ValueError, match="tl_open") as ours:
            dataio.NativeTokenLoader(path, batch=1, window=window)
        with pytest.raises(ValueError, match="tl_open") as theirs:
            jax_dataio.NativeTokenLoader(path, batch=1, window=window)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as ours:
        dataio.PyTokenLoader(short, batch=1, window=8)
    with pytest.raises(ValueError) as theirs:
        jax_dataio.PyTokenLoader(short, batch=1, window=8)
    assert str(ours.value) == str(theirs.value)
    assert "need at least one window of 8" in str(ours.value)
    # open_token_loader lets the native engine's ValueError through, as
    # JAX's does (the trainer turns it into a usage error).
    with pytest.raises(ValueError, match="tl_open"):
        dataio.open_token_loader(missing, 1, 4)


def test_open_token_loader_takes_the_native_engine_and_logs_once(
        fresh_lib, caplog):
    assert shutil.which("g++"), "the CPU tests run where g++ is"
    with caplog.at_level(logging.INFO, logger=dataio.__name__):
        loaders = [dataio.open_token_loader(CORPUS_BIN, 2, 8, seed)
                   for seed in (0, 1)]
    try:
        assert all(isinstance(ld, dataio.NativeTokenLoader)
                   for ld in loaders)
        lines = [r.getMessage() for r in caplog.records
                 if r.getMessage().startswith("token loader:")]
        assert lines == [f"token loader: native engine "
                         f"({dataio.loader_library_path()})"]
        assert dataio.native_available()
    finally:
        for ld in loaders:
            ld.close()


def test_without_a_compiler_it_takes_numpy_and_says_why(fresh_lib,
                                                        monkeypatch,
                                                        tmp_path, caplog):
    monkeypatch.setattr(dataio, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(dataio.shutil, "which", lambda name: None)
    with caplog.at_level(logging.INFO, logger=dataio.__name__):
        ld = dataio.open_token_loader(CORPUS_BIN, 2, 8)
        assert isinstance(ld, dataio.PyTokenLoader)
        assert not dataio.native_available()
    assert [r.getMessage() for r in caplog.records] == [
        "token loader: numpy engine (the native loader is unavailable: "
        "no C++ compiler (g++) on PATH)"]
    with pytest.raises(RuntimeError, match="native token loader "
                                           "unavailable"):
        dataio.NativeTokenLoader(CORPUS_BIN, 2, 8)
    assert not (tmp_path / "torch_native").exists()


def test_build_lands_in_build_torch_native_keyed_by_the_source(
        fresh_lib, monkeypatch, tmp_path):
    """The library is named after the hash of its source and flags, built
    through a temporary file renamed into place: an edited source builds
    a new library, an unchanged one is reused."""
    assert dataio.BUILD_DIR == \
        dataio.Path(REPO) / "build" / "torch_native"
    assert dataio.LOADER_SOURCE == \
        dataio.Path(REPO) / "tpu_autoscaler_torch" / "csrc" / \
        "tokenloader.cpp"
    source = tmp_path / "tokenloader.cpp"
    shutil.copy(dataio.LOADER_SOURCE, source)
    monkeypatch.setattr(dataio, "LOADER_SOURCE", source)
    monkeypatch.setattr(dataio, "BUILD_DIR", tmp_path / "out")
    first = dataio.build_loader()
    assert first.parent == tmp_path / "out" and first.exists()
    mtime = first.stat().st_mtime_ns
    assert dataio.build_loader() == first
    assert first.stat().st_mtime_ns == mtime
    source.write_text(source.read_text() + "\n// edited\n")
    second = dataio.build_loader()
    assert second != first and second.exists()
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == \
        sorted([first.name, second.name])


def test_a_failed_build_raises_with_the_compiler_output(fresh_lib,
                                                        monkeypatch,
                                                        tmp_path):
    source = tmp_path / "tokenloader.cpp"
    source.write_text("this is not C++\n")
    monkeypatch.setattr(dataio, "LOADER_SOURCE", source)
    monkeypatch.setattr(dataio, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="exited"):
        dataio.build_loader()
    assert list((tmp_path / "out").iterdir()) == []
    assert isinstance(dataio.open_token_loader(CORPUS_BIN, 2, 8),
                      dataio.PyTokenLoader)


def test_the_port_keeps_a_verbatim_copy_of_the_loader_source():
    with open(os.path.join(REPO, "native", "tokenloader.cpp")) as f:
        assert dataio.LOADER_SOURCE.read_text() == f.read()
