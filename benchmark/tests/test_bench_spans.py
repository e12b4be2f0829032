"""``trace.device_summary`` names an idle gap of the device by the innermost
of the program's own ranges that holds it: the stages and spans that the
port opens as ``record_function`` ranges while a profiler records
(``msm_we_tpu_torch/tracing.py``), on a small hand-written trace."""
import json

import bench_helpers  # noqa: F401  (puts the checkout on the path)
from benchmark.trace import device_summary

# Host ranges (us): a stage with two spans inside it, then another stage
HOST = [("Clustering", 0, 100), ("cluster_fold", 10, 40), ("model_copy", 60, 30),
        ("Cleaning", 100, 50)]
# Device events (us): the gaps between them lie in cluster_fold (twice),
# in Clustering outside its spans, in Cleaning, and outside every range
DEVICE = [(0, 5), (20, 5), (70, 2), (120, 1), (150, 1), (200, 1)]
NAMES = tuple(n for n, _ts, _dur in HOST)


def _trace(path):
    events = [dict(ph="X", cat="user_annotation", name=n, ts=ts, dur=dur, pid=1, tid=1)
              for n, ts, dur in HOST]
    events += [dict(ph="X", cat="kernel", name="k", ts=ts, dur=dur, pid=0, tid=7)
               for ts, dur in DEVICE]
    with open(path, "w") as fh:
        json.dump({"traceEvents": events}, fh)
    return str(path)


def test_a_gap_is_named_by_the_innermost_program_range(tmp_path):
    s = device_summary(_trace(tmp_path / "t.json"), labels=NAMES)
    assert sorted(s["idle_gaps"], key=lambda g: -g[1]) == s["idle_gaps"]
    assert sorted(s["idle_gaps"]) == sorted([
        ["cluster_fold", 15e-6], ["cluster_fold", 45e-6], ["Clustering", 48e-6],
        ["Cleaning", 29e-6], ["host", 49e-6]])
    assert s["busy_s"] == 15e-6


def test_without_the_programs_names_every_gap_is_host(tmp_path):
    s = device_summary(_trace(tmp_path / "t.json"), labels=("enqueue",))
    assert {label for label, _s in s["idle_gaps"]} == {"host"}
