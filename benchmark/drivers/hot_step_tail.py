"""Driver of the hot-step cells whose steady-state tail is read on its own:
``drivers/hot_step.py``'s cell (the same set-up, window, end-to-end numbers,
device time, profile and check), and with ``trace`` one phase more after
those. One step under ``tracing.collect()`` captures the step's traced graph
(``msm_we_tpu_torch/_graph.py``: event nodes where the tail starts and ends,
a device counter of its extra rounds); then ``trace_steps`` steps run under
a second ``collect()`` block, and the record keeps, per traced replay, the
mean device milliseconds of the tail (``device_ms["tail"]``), its extra
rounds (``counts["tail_rounds"]``) and the share of replays whose tail took
the float64 route (``counts["tail_f64"]``), beside the state count and the
fixed squarings of the configuration's tail. A program that lacks one of
these leaves it None, and its reader reports nothing. A configuration that
names its WE bins (``we_bins``) runs only traffic of that many bins.
"""
from __future__ import annotations

import importlib.util
import math
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def _base():
    """``drivers/hot_step.py`` of this checkout, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "bench_driver_hot_step_base", os.path.join(_HERE, "hot_step.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


base = _base()


def fixed_squarings(n_iters):
    """The squarings the tail takes before its first convergence test:
    ``ceil(log2(n_iters))``, at least one."""
    return max(int(math.ceil(math.log2(max(n_iters, 2)))), 1)


class Cell(base.Cell):
    def __init__(self, config, workload, seed, device):
        bins = config.get("we_bins")
        if bins is not None and bins != workload["traffic"]["n_bins"]:
            raise ValueError(f"the configuration bins {bins} WE bins, the "
                             f"traffic {workload['traffic']['n_bins']}")
        super().__init__(config, workload, seed, device)
        self.trace_steps = workload["traffic"]["trace_steps"]
        self.n_iters = config["steady_state"]["n_iters"]

    def window(self, seconds, trace=False):
        res = super().window(seconds, trace=trace)
        if trace:
            res["record"]["tail"] = self._trace_tail()
        return res

    def _trace_tail(self):
        """The tail's numbers per traced replay over ``trace_steps`` steps
        under ``collect()``, after one step that captures the traced graph."""
        from msm_we_tpu_torch import tracing

        with tracing.collect():
            self._step()
        base._sync(self.device)
        with tracing.collect() as col:
            for _ in range(self.trace_steps):
                self._step()
            base._sync(self.device)
        tail_ms = col.device_ms.get("tail") or []
        replays = len(tail_ms)

        def per_replay(name):
            n = col.counts.get(name)
            return n / replays if replays and n is not None else None

        return dict(replays=replays,
                    device_ms=sum(tail_ms) / replays if replays else None,
                    rounds=per_replay("tail_rounds"),
                    f64_share=per_replay("tail_f64"),
                    n_states=int(self.problem["n_states"]),
                    fixed_squarings=fixed_squarings(self.n_iters))
