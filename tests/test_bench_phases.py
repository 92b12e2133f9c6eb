"""bench.py's reference-Timer parsing feeds the per-phase honesty of
every BENCH/BASELINE artifact — pin its labeling.

The frag -> phase mapping mirrors the reference's own Timer spans
(reference CMakeLists.txt:6-8 compiles them in by default; messages at
subCommand.cpp:192, sketch.cpp:588, dist.cpp:134,273,340)."""

import importlib.util
import os
import sys

_spec = importlib.util.spec_from_file_location(
    "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
bench = importlib.util.module_from_spec(_spec)
sys.modules.setdefault("bench", bench)
_spec.loader.exec_module(bench)


SKETCH_ALLDIST_STDERR = """\
===============the time of transSketches is: 98.8
===================time of computing sketches and save sketches into file is: 110.2
===================time of read sketches from file is 0.41
===================time of read index and offset sketch file is: 2.1
===================time of multiple threads distance computing and save the subFile is: 1.9
===================time of merge the subFiles into final files is: 0.002
"""

ALLDIST_ONLY_STDERR = """\
===================time of read sketches from file is 164.2
===================time of read index and offset sketch file is: 3.0
===================time of multiple threads distance computing and save the subFile is: 50.1
===================time of merge the subFiles into final files is: 0.002
"""


def test_sketch_phase_net_of_nested_index_build():
    # transSketches (sketch.cpp:588) is nested INSIDE the "computing
    # sketches and save" span (subCommand.cpp:192): the sketch phase
    # must be reported net of the index build, or a host page-fault
    # pathology in the dense index build masquerades as sketch time
    p = bench.parse_ref_phases(SKETCH_ALLDIST_STDERR)
    assert p["index"] == 98.8
    assert abs(p["sketch"] - (110.2 - 98.8)) < 1e-6
    assert p["load"] == 0.41
    assert abs(p["dist"] - (2.1 + 1.9 + 0.002)) < 1e-6


def test_alldist_only_index_build_stays_out_of_sketch():
    # the alldist-from-sketch path rebuilds the index inside "read
    # sketches from file" with NO separate Timer line (dist.cpp:134):
    # that span must surface as "load", never as "sketch"
    p = bench.parse_ref_phases(ALLDIST_ONLY_STDERR)
    assert "sketch" not in p
    assert p["load"] == 164.2
    assert abs(p["dist"] - (3.0 + 50.1 + 0.002)) < 1e-6


def test_garbage_lines_ignored():
    p = bench.parse_ref_phases("=====total: 64\nfinshed sketching\n"
                               "time of something unknown is: 5.0\n")
    assert p == {}


def _load_bench(monkeypatch, env: dict):
    for k in ("KSSD_BENCH_DIR", "REF_BIN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location("bench_fresh",
                                                  _spec.origin)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_dirs_default_under_checkout(monkeypatch):
    # corpora and the reference build stay inside each checkout, so two
    # checkouts compared on one machine never reuse each other's
    b = _load_bench(monkeypatch, {})
    build = os.path.join(os.path.dirname(os.path.abspath(_spec.origin)),
                         "build")
    assert b.BENCH_DIR == os.path.join(build, "bench")
    assert b.REF_BIN == os.path.join(build, "refbuild", "rabbit_kssd")


def test_bench_dirs_honour_env(monkeypatch, tmp_path):
    b = _load_bench(monkeypatch, {"KSSD_BENCH_DIR": str(tmp_path / "c"),
                                  "REF_BIN": str(tmp_path / "r" / "bin")})
    assert b.BENCH_DIR == str(tmp_path / "c")
    assert b.REF_BIN == str(tmp_path / "r" / "bin")
