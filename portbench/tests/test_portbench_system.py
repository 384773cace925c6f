"""The index cache: a build is found again by its key, the key follows
what the build depends on, and runs that build at once never lose or
break the artifact."""
from __future__ import annotations

import threading

from portbench import system


def fake_build(seconds: float, started=None, release=None):
    def make(directory):
        (directory / "pages.bin").write_bytes(b"x" * 64)
        if started is not None:
            started.set()
            release.wait(10)
        (directory / "manifest.json").write_text("{}")
        return seconds
    return make


def test_a_build_is_saved_once_and_then_loaded(tmp_path):
    final, built = system.cached_index_dir(tmp_path, "cfg", b"a",
                                           fake_build(7.0))
    assert built == 7.0 and (final / "manifest.json").is_file()
    again, built = system.cached_index_dir(tmp_path, "cfg", b"a",
                                           fake_build(9.0))
    assert again == final and built is None
    # another configuration file is another key
    other, built = system.cached_index_dir(tmp_path, "cfg", b"b",
                                           fake_build(5.0))
    assert other != final and built == 5.0
    assert sorted(p.name for p in (tmp_path / "cfg").iterdir()) == \
        sorted([final.name, other.name])


def test_two_runs_that_build_at_once_keep_one_whole_artifact(tmp_path):
    started, release = threading.Event(), threading.Event()
    out = {}

    def slow():
        out["slow"] = system.cached_index_dir(
            tmp_path, "cfg", b"a", fake_build(2.0, started, release))

    t = threading.Thread(target=slow)
    t.start()
    started.wait(10)
    # the second run starts while the first is half way through its build
    fast, built = system.cached_index_dir(tmp_path, "cfg", b"a",
                                          fake_build(1.0))
    assert built == 1.0 and (fast / "manifest.json").is_file()
    release.set()
    t.join(10)
    slow_dir, slow_built = out["slow"]
    assert slow_dir == fast and slow_built == 2.0
    assert sorted(p.name for p in (tmp_path / "cfg").iterdir()) == \
        [fast.name]
    assert sorted(p.name for p in fast.iterdir()) == ["manifest.json",
                                                      "pages.bin"]


def test_the_key_covers_the_harness_code_that_makes_the_collection(
        tmp_path, monkeypatch):
    for name in system.BUILD_CODE:
        (tmp_path / name).write_bytes((system.HARNESS / name).read_bytes())
    assert set(system.BUILD_CODE) == {"data.py", "system.py"}
    monkeypatch.setattr(system, "HARNESS", tmp_path)
    key = system.cache_key(b"config")
    assert system.cache_key(b"config") == key
    assert system.cache_key(b"config 2") != key
    with (tmp_path / "data.py").open("a") as f:
        f.write("# another collection\n")
    assert system.cache_key(b"config") != key
