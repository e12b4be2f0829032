"""Driver of the build cells: ``modelWE.build_analyze_model`` with the
WESTPA plugin's defaults, one fresh build after another.

Set-up makes the WE run from the seed (``traffic/we_run.py``) and warms up
with one build. Each build of the window is a fresh ``modelWE`` over a
fresh ``ArrayWEDataset`` of the same arrays, called with the arguments
``westpa_plugins.hamsm_driver.build_hamsm_from_config`` passes for the
configuration's plugin settings; only the kernel library and the CUDA
context carry over. ``build_s`` is the window's seconds over the builds it
completed. With ``trace`` the stage spans of every build are kept
(``model.stage_timings``), and after the window ``trace_builds`` more
builds run under the build's own profiler (``profile_dir``) for the
device's busy time and the breakdown.

The state of one build drawn from the seed, and of the last, is kept and
held to ``reference/build.py`` once the window has closed.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.reference import build as reference
from benchmark.trace import device_summary
from benchmark.traffic.we_run import generate


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def extract(model, n_bins):
    """What the judge reads of a built model, as host arrays: the PCA
    components, and for the model and each validation model its centers
    in global-id order with their WE bins, its ids, its sorted normalized
    flux matrix, steady state and target flux; and the centers right after
    clustering."""

    def bank(m):
        # A bin that was never clustered has no view of centers
        views = [getattr(v, "cluster_centers_", None) for v in m.clusters.cluster_models]
        d = next(np.shape(v)[1] for v in views if v is not None)
        centers = [np.zeros((0, d)) if v is None else np.asarray(v) for v in views]
        return dict(centers=np.concatenate(centers),
                    center_bin=np.repeat(np.arange(n_bins), [len(c) for c in centers]))

    def one(m):
        pairs = np.concatenate(m.pair_dtrajs)
        return dict(bank(m), parent_idx=pairs[:, 0].copy(), child_idx=pairs[:, 1].copy(),
                    flux_matrix=np.array(m.fluxMatrix), pss=np.array(m.pSS).ravel(),
                    target_flux=float(m.JtargetSS))

    models = {"main": one(model)}
    for g, v in enumerate(model.validation_models or []):
        models[f"validation{g}"] = one(v)
    return dict(pca_components=np.array(model.coordinates.components_),
                models=models, post_cluster_bank=bank(model.post_cluster_model))


class Cell:
    def __init__(self, config, workload, seed, device):
        from msm_we_tpu_torch.binning import RectilinearBinMapper

        self.config = config
        self.device = device
        self.seed = seed % 2**64
        t = workload["traffic"]
        s = config["synthetic"]
        self.data = generate(
            t["n_iterations"], t["n_segments"], self.seed, warmup=s["warmup"],
            n_atoms=s["n_atoms"], pcoord_len=s["pcoord_len"],
            target_bounds=tuple(s["target_bounds"]), basis_bounds=tuple(s["basis_bounds"]),
            x_min=s["x_min"], x_max=s["x_max"], dt=s["dt"], noise=s["noise"],
            barrier=s["barrier"], n_we_bins=s["n_we_bins"])
        b = config["build"]
        self.n_bins = len(b["we_bin_edges"]) - 1
        self.mapper = RectilinearBinMapper([np.asarray(b["we_bin_edges"])])
        self.groups = b["cross_validation_groups"]
        rng = np.random.default_rng(self.seed)
        self.keep = int(rng.integers(t["check_from_first"]))
        self.trace_builds = t["trace_builds"]
        self.states = []
        self._build()  # warm-up
        _sync(device)

    def _build(self, profile_dir=None):
        """One build as the plugin runs it (``build_hamsm_from_config``'s
        arguments for the configuration's settings)."""
        from msm_we_tpu_torch.data import ArrayWEDataset
        from msm_we_tpu_torch.model import modelWE

        b = self.config["build"]
        first = b["first_analysis_iter"]
        model = modelWE(device=self.device)
        model.build_analyze_model(
            file_paths=ArrayWEDataset(self.data),
            ref_struct={"coords": None, "nAtoms": self.config["synthetic"]["n_atoms"],
                        "coord_ndim": 3},
            modelName=b["model_name"],
            basis_pcoord_bounds=b["basis_pcoord_bounds"],
            target_pcoord_bounds=b["target_pcoord_bounds"],
            dimreduce_method=b["dimreduce_method"],
            n_clusters=b["n_clusters"], tau=b["tau"],
            step_kwargs={
                "dimReduce": {"use_weights": b["use_weights"],
                              "variance_cutoff": b["variance_cutoff"],
                              "first_iter": first},
                "clustering": {"first_cluster_iter": first,
                               "user_bin_mapper": self.mapper},
            },
            fluxmatrix_iters=[first, -1],
            allow_validation_failure=b["allow_validation_failure"],
            cross_validation_groups=self.groups,
            cross_validation_blocks=b["cross_validation_blocks"],
            device_pipeline=b["device_pipeline"],
            show_live_display=False,
            profile_dir=profile_dir,
        )
        _sync(self.device)
        return model

    def _failed(self, model):
        return len(model.validation_models or []) != self.groups

    def window(self, seconds, trace=False):
        stages, failed, kept = [], 0, []
        t0 = time.perf_counter()
        while True:
            model = self._build()
            end = time.perf_counter()
            failed += self._failed(model)
            stages.append([(n, s) for n, s, _note in model.stage_timings.stages])
            if len(stages) - 1 == self.keep:
                kept.append(model)
            if end - t0 >= seconds:
                break
        if len(stages) - 1 != self.keep:
            kept.append(model)
        del model
        # Read after the window, so that the check's copies take no window time
        self.states = [extract(m, self.n_bins) for m in kept]
        del kept
        n = len(stages)
        res = dict(t0=t0, attempted=n, failed=failed,
                   end_to_end=dict(build_s=(end - t0) / n))
        if trace:
            res["record"] = dict(build_stages=stages)
            if self.device.type == "cuda":
                prof = self._profile()
                res["record"].update(busy_s=prof["busy_s"], traced_wall_s=prof["window_s"])
                res.update(prof)
        return res

    def _profile(self):
        """``trace_builds`` more builds under the build's own profiler: the
        device's busy seconds over the builds' stage seconds, and the
        breakdown, with idle gaps labelled by the build stage that ran
        (placed from the stages' durations, in order, from the trace's
        first host event)."""
        busy = wall = 0.0
        ops, gaps = {}, []
        for _ in range(self.trace_builds):
            d = tempfile.mkdtemp(prefix="build_trace_")
            try:
                model = self._build(profile_dir=d)
                spans = [(n, s) for n, s, _note in model.stage_timings.stages]
                wall += sum(sec for _n, sec in spans)
                del model
                path = os.path.join(d, os.listdir(d)[0])
                first = device_summary(path)["t0_us"]
                marks, t = [], first
                for name, sec in spans:
                    marks.append((name, t, t + sec * 1e6))
                    t += sec * 1e6
                s = device_summary(path, spans=marks)
            finally:
                shutil.rmtree(d, ignore_errors=True)
            busy += s["busy_s"]
            for name, sec in s["device_ops"]:
                ops[name] = ops.get(name, 0.0) + sec
            gaps += s["idle_gaps"]
        gaps.sort(key=lambda g: -g[1])
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        return dict(busy_s=busy, window_s=wall,
                    breakdown=dict(device_ops=[[n, s] for n, s in top], idle_gaps=gaps[:10]))

    def release(self):
        """The built models are gone already; free the card's cache."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _judge(self):
        return reference.Judge(self.data, self.config, self.device)

    def check(self):
        """Each compared number, the worst over the kept builds."""
        judge = self._judge()
        worst = {}
        for state in self.states:
            for k, v in judge(state, seed=self.seed).items():
                worst[k] = max(worst.get(k, v), v) if v == v else v
        return list(worst.items())

    def control(self):
        """The check's numbers for the control: the reference in float32 in
        the build's place, from the centers of one build of these inputs."""
        if not self.states:
            self.states.append(extract(self._build(), self.n_bins))
        judge = self._judge()
        return list(judge(judge.control(self.states[-1]), seed=self.seed).items())
