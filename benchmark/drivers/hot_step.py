"""Driver of the hot-step cells: ``msm_we_tpu_torch.entry.hot_step`` in a
closed loop, one synchronised step after another.

Set-up makes the cell's problem from its traffic's ``problem_seed`` and
deals its segments out in an order drawn from the run's seed
(``traffic/hot_problem.py``), stages it on the card (``entry.stage_problem``) and warms up: the first
step captures the step's CUDA graph, later ones replay it. The window
times every step on the host clock, from the call to the end of its
synchronise. With ``trace`` it also records the host time of each call
without its synchronise; after the window it times the device's share of
a step by CUDA events around replays queued back to back
(``_device_step_ms``) and profiles a few more steps (``torch.profiler``)
for the breakdown.

The outputs of a few steps drawn from the seed, and of the last one, are
kept and held to ``reference/hot_step.py`` once the window has closed.
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from benchmark.reference import hot_step as reference
from benchmark.trace import device_summary
from benchmark.traffic.hot_problem import make_problem, reorder

OUTPUT_KEYS = ("pidx", "cidx", "fm", "pss", "flux")
# Cycles of ``torch.cuda._sleep`` a second, at least: the card's highest
# clock (1.98 GHz on an H100 SXM) rounded up
SPIN_CYCLES_PER_S = 2.0e9
# Steps queued behind the spin: an H100 holds some 26 launches of the
# step's graph before the next launch waits for the device
QUEUED_STEPS = 20


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def roofline_sizes(problem, tier):
    """What the step's work needs, counted from its inputs: the sizes that
    ``metrics/step.roofline_pct.py`` turns into bytes and operations. The
    ``two_transform`` tier's input holds every parent and child row; the
    ``dedup`` tier's the child rows and the recycled parents' frames."""
    p = problem
    n, d = p["raw_child"].shape
    valid = np.asarray(p["valid"], bool)
    per_bin = np.bincount(np.asarray(p["center_bin"])[valid],
                          minlength=int(max(p["pbins"].max(), p["cbins"].max())) + 1)
    scored = (int(per_bin[p["pbins"][~p["basis_p"]]].sum())
              + int(per_bin[p["cbins"][~(p["basis_c"] | p["target_c"])]].sum()))
    raw_rows = 2 * n if tier == "two_transform" else n + len(p["fb_idx"])
    return dict(raw_rows=int(raw_rows), n_segments=int(n), n_raw=int(d), n_components=int(p["comp"].shape[1]),
                n_centers=int(len(valid)), n_states=int(p["n_states"]),
                scored_pairs=scored)


class Cell:
    def __init__(self, config, workload, seed, device):
        from msm_we_tpu_torch import entry

        self.entry = entry
        self.device = device
        t = workload["traffic"]
        self.tier = t["tier"]
        self.problem = reorder(make_problem(
            n_segments=config["n_segments"], n_raw_features=config["n_raw_features"],
            n_components=config["n_components"], n_bins=t["n_bins"],
            k_per_bin=config["clusters_per_bin"], seed=t["problem_seed"],
            fallback_frac=config["recycled_fraction"]), seed % 2**64)
        self.staged = entry.stage_problem(self.problem, self.tier, device)
        for _ in range(t["warmup_steps"]):
            entry.hot_step(self.staged, self.tier)
        _sync(device)
        rng = np.random.default_rng(seed % 2**64)
        self.keep = set(rng.choice(t["check_from_first"], t["check_steps"],
                                   replace=False).tolist())
        self.profile_steps = t["profile_steps"]
        self.kept = []

    def _step(self):
        return self.entry.hot_step(self.staged, self.tier)

    def window(self, seconds, trace=False):
        dev = self.device
        times, enqueue = [], []
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            out = self._step()
            if trace:
                enqueue.append(time.perf_counter() - a)
            _sync(dev)
            b = time.perf_counter()
            times.append(b - a)
            if len(times) - 1 in self.keep:
                self.kept.append(out)
            if b - t0 >= seconds:
                break
        self.kept.append(out)
        window_s = b - t0
        n = len(times)
        res = dict(t0=t0, attempted=n, failed=0, end_to_end=dict(
            hot_step_frames_per_s=self.problem["raw_child"].shape[0] * n / window_s,
            hot_step_p95_ms=float(np.percentile(times, 95)) * 1e3,
        ))
        if trace:
            res["record"] = dict(
                window_s=window_s, steps=n, step_s=times, enqueue_s=enqueue,
                roofline=roofline_sizes(self.problem, self.tier))
            if dev.type == "cuda":
                res["record"]["device_step_ms"] = self._device_step_ms(
                    QUEUED_STEPS, sum(enqueue) / n)
                res.update(self._profile())
        return res

    def _device_step_ms(self, n, enqueue_s):
        """The device's milliseconds of one step: ``n`` steps queued behind
        a spin kernel long enough for the host to queue them all, so that
        the CUDA events around them span device work alone. None where the
        host took longer to queue them than the spin lasted (the device
        may then have waited on the host)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(int(max(4 * n * enqueue_s, 1e-3) * SPIN_CYCLES_PER_S))
        ev[1].record()
        a = time.perf_counter()
        for _ in range(n):
            self._step()
        queued_ms = (time.perf_counter() - a) * 1e3
        ev[2].record()
        _sync(self.device)
        if queued_ms >= ev[0].elapsed_time(ev[1]):
            return None
        return ev[1].elapsed_time(ev[2]) / n

    def _profile(self):
        """``profile_steps`` more steps under ``torch.profiler``: the
        device's busy seconds over the profiled window, and the breakdown
        (device operations by time; idle gaps by what the host was doing,
        ``enqueue`` inside the call or ``sync`` waiting for it)."""
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            a = time.perf_counter()
            for _ in range(self.profile_steps):
                with record_function("enqueue"):
                    self._step()
                with record_function("sync"):
                    _sync(self.device)
            wall = time.perf_counter() - a
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            s = device_summary(path, labels=("enqueue", "sync"))
        finally:
            os.remove(path)
        return dict(busy_s=s["busy_s"], window_s=wall,
                    breakdown=dict(device_ops=s["device_ops"], idle_gaps=s["idle_gaps"]))

    def release(self):
        """Free the program's state: the staged problem (and with it the
        step's graph); the kept outputs move to the host."""
        self.kept = [{k: out[k].detach().cpu() for k in OUTPUT_KEYS}
                     for out in self.kept]
        self.staged = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def control(self):
        """The check's numbers for the control: the plain step in float32
        with TF32 products in the program's place, on these inputs."""
        judge = reference.Judge(self.problem, self.device)
        return list(judge(reference.solve(self.problem, self.device, tf32=True)).items())

    def check(self):
        """Each compared number, the largest over the kept steps."""
        judge = reference.Judge(self.problem, self.device)
        worst = {}
        for out in self.kept:
            for k, v in judge(out).items():
                worst[k] = max(worst.get(k, v), v) if v == v else v
        return list(worst.items())
