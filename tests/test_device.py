"""Native build keys and the compile-cache location."""

import jax
import pytest

from astarpa_tpu.utils import build, device


def test_build_key_changes_with_each_input(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    base = build.build_key([src], ("-O3",), "g++ 12", "cpu A")
    assert base == build.build_key([src], ("-O3",), "g++ 12", "cpu A")
    assert base != build.build_key([src], ("-O2",), "g++ 12", "cpu A")
    assert base != build.build_key([src], ("-O3",), "g++ 13", "cpu A")
    assert base != build.build_key([src], ("-O3",), "g++ 12", "cpu B")
    src.write_text("int f() { return 2; }\n")
    assert base != build.build_key([src], ("-O3",), "g++ 12", "cpu A")


def test_build_library_builds_once_under_build_root(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    calls = []

    def compile_to(path):
        calls.append(path)
        path.write_bytes(b"lib")

    out = build.build_library("demo", "k1", compile_to)
    assert out == tmp_path / "build" / "demo" / "k1" / "libdemo.so"
    assert out.read_bytes() == b"lib"
    assert build.build_library("demo", "k1", compile_to) == out
    assert len(calls) == 1
    assert not list(out.parent.glob("*.part*"))


def test_native_library_is_keyed_on_this_host():
    """The native library's key covers its sources and the host CPU, and
    the loaded file lives under the gitignored build root."""
    from astarpa_tpu import native

    if not native.available():
        pytest.skip("no native toolchain")
    key = native.library_key()
    assert (build.BUILD_ROOT / "astarpa_native" / key /
            "libastarpa_native.so").exists()
    assert build.host_cpu_id()


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_native_failure_raises_off_the_cpu(monkeypatch, backend):
    """A native build or load failure is a quiet False only on the CPU
    backend; on a device backend it raises instead of degrading."""
    from astarpa_tpu import native

    def broken():
        raise OSError("no compiler")

    monkeypatch.setattr(native, "load", broken)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if backend == "cpu":
        assert native.available() is False
    else:
        with pytest.raises(RuntimeError, match="gpu backend: no compiler"):
            native.available()


def test_compile_cache_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the code sets nothing.
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = device.enable_compile_cache()
        assert path == str(build.REPO_ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert device.compile_cache_dir() == path
        ignored = (build.REPO_ROOT / ".gitignore").read_text().split()
        assert ".jax_cache/" in ignored and "build/" in ignored
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_build_library_threads_build_once(tmp_path, monkeypatch):
    """Threads asking for the same library wait for one build."""
    import threading
    import time

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    calls = []

    def compile_to(path):
        calls.append(path)
        time.sleep(0.05)
        path.write_bytes(b"lib")

    outs = []
    threads = [threading.Thread(target=lambda: outs.append(
        build.build_library("demo", "k1", compile_to))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(set(outs)) == 1 and len(outs) == 4
    assert outs[0].read_bytes() == b"lib"
