"""Flux/committor plotting and coarse-grained flux profiles.

Counterpart of ``msm_we_tpu/plotting.py`` (reference PlottingMixin,
``_hamsm/_plotting.py``): flux vs pcoord (:243), flux vs pseudocommittor
(:95), pcoord-colored committor-flux scatter (:16), committor scatter
(:431), coarse-grained flux profile via pcoord digitization (:450-515),
basis/target boundary lines (:393), and the flux-overcorrection warning box
(:410-429). Validation-model overlays require cross-validation unless
suppressed (:114-122).

Free functions over a model object; the modelWE facade delegates to these
under the reference method names. Everything here is host numpy on the
built model's float64 arrays. matplotlib is imported only inside
:func:`_plt`, so importing this module and ``get_coarse_flux_profile`` need
no matplotlib; a ``plot_*`` call without it raises an ``ImportError`` that
names it.
"""
from __future__ import annotations

import numpy as np

from ._logging import log

__all__ = [
    "plot_flux",
    "plot_flux_committor",
    "plot_flux_committor_pcoordcolor",
    "plot_committor",
    "get_coarse_flux_profile",
    "plot_coarse_flux_profile",
    "draw_basis_target_boundaries",
    "plot_implied_timescales",
    "plot_ck_test",
]


def _plt():
    """``matplotlib.pyplot``, imported on first use."""
    try:
        from matplotlib import pyplot as plt
    except ImportError as e:
        raise ImportError(
            "plotting needs matplotlib, which is not installed; the arrays "
            "behind every plot (get_flux, get_flux_committor, "
            "get_coarse_flux_profile, get_implied_timescales, get_ck_test) "
            "are available without it"
        ) from e
    return plt


def _validation_models(model):
    """The model's validation models (none before cross-validation ran)."""
    return list(getattr(model, "validation_models", None) or [])


def _require_validation(model, suppress_validation):
    done = len(_validation_models(model)) > 1
    if not done:
        log.critical(
            "No cross-validation models have been generated! Do this before "
            "making plots."
        )
        if not suppress_validation:
            raise RuntimeError("Perform cross-validation before plotting results.")


def _models_and_labels(model):
    validation = _validation_models(model)
    models = [model] + validation
    labels = ["main_model"] + [
        f"validation_model_{n}" for n in range(len(validation))
    ]
    return models, labels


def _ensure_committor_flux(m, label):
    if getattr(m, "q", None) is None:
        log.info(f"Committors not yet generated for {label}, generating now.")
        m.get_committor()
    if getattr(m, "Jq", None) is None:
        log.info(f"Committor-fluxes not yet generated for {label}, generating now.")
        m.get_flux_committor()


def _windowed_committor_flux(m, nwin):
    """Window-average Jq and q along the committor ordering (reference
    ``_plotting.py:158-170``), vectorized with a cumulative-sum moving
    average: result[i] = mean(x[i : i + nwin]) for i <= n - 1 - nwin,
    matching the reference's backwards loop.

    Divergence from the reference, deliberately: ``Jq`` is stored in
    original state order (``get_flux_committor`` scatters via
    ``J[indq[i]]``, ``_analysis.py:500``), so it must be reordered by
    ``indq`` before windowing, exactly like ``q``. The reference windows
    the unsorted ``Jq`` (``_plotting.py:68-70``), pairing each plotted
    committor value with a *different state's* flux. Returns a third
    array: ``indq``, so callers can reorder per-state companions
    (e.g. pcoord colors) consistently."""
    n_bins = m.targetRMSD_centers.shape[0]
    Jq = np.asarray(m.Jq, dtype=float)
    q = np.asarray(m.q, dtype=float)
    indq = np.argsort(np.squeeze(1.0 - q))
    Jq_sorted = Jq[indq]
    Jq_avg = Jq_sorted.copy()
    q_avg = np.zeros_like(Jq_avg)

    def moving_mean(x):
        c = np.concatenate([[0.0], np.cumsum(x)])
        return (c[nwin:] - c[:-nwin]) / nwin

    if n_bins - nwin > 0:
        # windows [i, i+nwin) for i in 0..n_bins-1-nwin (the reference loop
        # writes indices _i - nwin for _i in nwin..n_bins-1)
        Jq_avg[: n_bins - nwin] = moving_mean(Jq_sorted)[: n_bins - nwin]
        q_avg[: n_bins - nwin] = moving_mean(q[indq])[: n_bins - nwin]
    return q_avg, Jq_avg, indq


def draw_basis_target_boundaries(model, ax, pcoord_to_use=0):
    for i, bound in enumerate(model.target_pcoord_bounds[pcoord_to_use, :]):
        ax.axvline(
            bound, color="r", linestyle="--",
            label="Target boundary" if i == 0 else "",
        )
    for i, bound in enumerate(model.basis_pcoord_bounds[pcoord_to_use, :]):
        ax.axvline(
            bound, color="b", linestyle="--",
            label="Basis/Source boundary" if i == 0 else "",
        )


def _check_display_overcorrection_warning(model, ax):
    if not getattr(model, "slope_overcorrected", False):
        return
    log.warning(
        "Flux profile appears to be overcorrected; continue the WE run "
        "without restarting and let it relax."
    )
    ax.text(
        0.5,
        -0.25,
        "WARNING: Possible flux overcorrection! WE should be continued "
        "without restarting now.",
        ha="center",
        va="center",
        transform=ax.transAxes,
        weight="bold",
    )


def plot_flux(
    model,
    custom_name=None,
    ax=None,
    save=False,
    suppress_validation=False,
    _from_colors=None,
    _to_colors=None,
    pcoord_to_use=0,
    **_plot_args,
):
    """Net flux profile vs pcoord, with validation-model overlays and the
    linear fit + overcorrection callout. Reference ``_plotting.py:243-391``."""
    plt = _plt()
    _require_validation(model, suppress_validation)
    models, labels = _models_and_labels(model)

    own_ax = ax is None
    if own_ax:
        fig = plt.figure(figsize=(10, 4))
        ax = fig.add_subplot(111)

    plot_args = {"linewidth": 2, "markersize": 10}
    plot_args.update(_plot_args)

    n_models = len(models)
    from_colors = [
        plt.get_cmap("cool")(0.25 + (0.75 * i / n_models)) for i in range(n_models)
    ]
    to_colors = [
        plt.get_cmap("hot")(0.25 + (0.5 * i / n_models)) for i in range(n_models)
    ]

    draw_basis_target_boundaries(model, ax, pcoord_to_use)

    for i, (m, label) in enumerate(zip(models, labels)):
        if m is None:
            continue
        if getattr(m, "J", None) is None:
            log.info(f"Fluxes not yet generated for {label}, generating now.")
            m.get_flux()

        J = np.asarray(m.J) / m.tau
        binCenters = m.targetRMSD_centers[:, pcoord_to_use].copy()
        binCenters[m.indTargets] = m.target_bin_centers[pcoord_to_use]
        binCenters[m.indBasis] = m.basis_bin_centers[pcoord_to_use]

        indPlus = np.where(J > 0.0)
        indMinus = np.where(J < 0.0)

        plot_args["color"] = (_to_colors or to_colors)[i]
        ax.plot(
            binCenters[indPlus], np.squeeze(J[indPlus]), ">",
            label=f"{label} flux toward target", **plot_args,
        )
        plot_args["color"] = (_from_colors or from_colors)[i]
        ax.plot(
            binCenters[indMinus], -np.squeeze(J[indMinus]), "<",
            label=f"{label} flux toward source/basis", **plot_args,
        )

    if not model.fit_parameters:
        model.get_flux()
    slope = model.fit_parameters["slope"]
    intercept = model.fit_parameters["intercept"]
    r_value = model.fit_parameters["r_value"]
    ax.plot(
        model.all_centers[model.sorted_centers],
        slope * model.all_centers[model.sorted_centers] + intercept,
        color="gray",
        label=f"Linear fit (m={slope:.1e}, b={intercept:.1e}, r^2={r_value ** 2:.1e})",
    )

    _check_display_overcorrection_warning(model, ax)

    ax.set_yscale("log")
    ax.set_xlabel(f"Pcoord {pcoord_to_use}")
    ax.set_ylabel("Flux (weight/second)")

    if own_ax:
        ax.legend(bbox_to_anchor=(1.01, 1.0), loc="upper left")
        ax.figure.tight_layout()
    if save:
        plot_filename = custom_name or f"{model.modelName}_flux.pdf"
        log.info(f"Saving flux plot to {plot_filename}")
        # ax.figure, not plt.savefig: the current pyplot figure may be a
        # different one when the caller passed its own ax
        ax.figure.savefig(plot_filename)
    return ax


def plot_flux_committor(
    model,
    nwin=1,
    ax=None,
    save=False,
    suppress_validation=False,
    _from_colors=None,
    _to_colors=None,
    **_plot_args,
):
    """Window-averaged net flux vs pseudocommittor. Reference
    ``_plotting.py:95-241``."""
    plt = _plt()
    _require_validation(model, suppress_validation)
    models, labels = _models_and_labels(model)

    own_ax = ax is None
    if own_ax:
        fig = plt.figure(figsize=(10, 4))
        ax = fig.add_subplot(111)

    plot_args = {"linewidth": 2, "markersize": 10}
    plot_args.update(_plot_args)

    n_models = len(models)
    from_colors = [
        plt.get_cmap("cool")(0.25 + (0.75 * i / n_models)) for i in range(n_models)
    ]
    to_colors = [
        plt.get_cmap("hot")(0.25 + (0.5 * i / n_models)) for i in range(n_models)
    ]

    for i, (m, label) in enumerate(zip(models, labels)):
        if m is None:
            continue
        _ensure_committor_flux(m, label)
        q_avg, Jq_avg, _indq = _windowed_committor_flux(m, nwin)
        indPlus = np.where(Jq_avg > 0.0)
        indMinus = np.where(Jq_avg < 0.0)

        plot_args["color"] = (_from_colors or from_colors)[i]
        ax.plot(
            q_avg[indMinus], -np.squeeze(Jq_avg[indMinus]), "<",
            label=f"{label} flux toward source/basis", **plot_args,
        )
        plot_args["color"] = (_to_colors or to_colors)[i]
        ax.plot(
            q_avg[indPlus], np.squeeze(Jq_avg[indPlus]), ">",
            label=f"{label} flux toward target", **plot_args,
        )

    ax.set_yscale("log")
    ax.set_xscale("linear")
    ax.set_xlim([-0.1, 1.1])
    ax.set_xlabel("Pseudocommittor")
    ax.set_ylabel("Flux (weight/second)")

    if not model.fit_parameters:
        model.get_flux()
    slope = model.fit_parameters["slope"]
    intercept = model.fit_parameters["intercept"]
    r_value = model.fit_parameters["r_value"]
    q_sort = np.argsort(model.q)[1:-1]
    ax.plot(
        model.q[q_sort],
        slope * model.all_centers[q_sort] + intercept,
        color="gray",
        label=(
            f"Linear fit to flux profile\nm={slope:.1e}, b={intercept:.1e}\n"
            f"r^2={r_value ** 2:.1e}\n"
        ),
    )
    _check_display_overcorrection_warning(model, ax)

    if own_ax:
        ax.legend(bbox_to_anchor=(1.01, 1.0), loc="upper left")
        ax.figure.tight_layout()
    if save:
        plot_filename = f"{model.modelName}_flux_committor.pdf"
        log.info(f"Saving flux-committor plot to {plot_filename}")
        ax.figure.savefig(plot_filename)
    return ax


def plot_flux_committor_pcoordcolor(
    model, nwin=1, ax=None, pcoord_to_use=0, **_plot_args
):
    """Committor-flux scatter colored by pcoord. Reference ``_plotting.py:16-93``."""
    plt = _plt()
    plot_args = {
        "linewidth": 2,
        "s": 50,
        "marker": ">",
        "cmap": plt.cm.rainbow.reversed(),
        "alpha": 0.7,
    }
    plot_args.update(_plot_args)

    if ax is None:
        fig = plt.figure(figsize=(10, 4))
        ax = fig.add_subplot(111)

    _ensure_committor_flux(model, "main_model")
    q_avg, Jq_avg, indq = _windowed_committor_flux(model, nwin)
    indPlus = np.where(Jq_avg > 0.0)

    # Colors must follow the committor ordering of q_avg/Jq_avg; the
    # reference reads centers by original state index (_plotting.py:79),
    # coloring each point with another state's pcoord
    centers_q = np.asarray(model.targetRMSD_centers)[indq, pcoord_to_use]
    lines = ax.scatter(
        q_avg[indPlus],
        np.squeeze(Jq_avg[indPlus]),
        c=np.ravel(centers_q[indPlus]),
        label="main_model flux toward target",
        **plot_args,
    )
    ax.figure.colorbar(lines, label=f"Progress Coordinate {pcoord_to_use}")
    ax.set_xlim([-0.1, 1.1])
    ax.set_title("Full-data model")
    ax.set_yscale("log")
    ax.set_xlabel("Pseudocommittor")
    ax.set_ylabel("Flux (weight/second)")
    return ax, lines


def plot_committor(model):
    """Committor scatter vs mean microstate pcoord. Reference ``_plotting.py:431-448``.

    Extension: if ``model.flux_bootstrap`` carries committor bands (from
    ``bootstrap_target_flux(observables=(..., "committor"))``, which stores
    them in the model's sorted numbering), they are drawn as error bars.
    """
    plt = _plt()
    fig = plt.figure(figsize=(8, 6))
    boot = getattr(model, "flux_bootstrap", None)
    # Staleness checks: a re-cluster/re-organize after the bootstrap leaves
    # old bands behind (facade attributes are overwrite-on-recompute, like
    # the reference's). The length must match the current model, and the
    # bootstrap's sort-index stamp must equal the model's current one — a
    # same-size re-organize changes state identities without changing
    # n_states.
    def _bands_fresh():
        if boot is None or "committor_ci" not in boot:
            return False
        if boot["committor_ci"].shape[1] != len(np.ravel(model.q)):
            return False
        stamp = boot.get("sort_indices")
        current = getattr(model, "pcoord_sort_indices", None)
        if stamp is not None and current is not None:
            return np.array_equal(stamp, current)
        return True

    if _bands_fresh():
        lo, hi = boot["committor_ci"]
        q = np.asarray(model.q)
        plt.errorbar(
            model.targetRMSD_centers[:, 0],
            q,
            yerr=np.stack([np.maximum(q - lo, 0.0), np.maximum(hi - q, 0.0)]),
            fmt="none",
            ecolor="gray",
            elinewidth=0.8,
            capsize=2,
            zorder=1,
        )
    plt.scatter(model.targetRMSD_centers[:, 0], model.q, s=15, c="black")
    plt.yscale("log")
    plt.ylabel("Pseudocommittor to target", fontsize=12)
    plt.xlabel("Average microstate pcoord", fontsize=12)
    fig.savefig(
        f"{model.modelName}_s{model.first_iter}_e{model.last_iter}committor.png"
    )
    return fig


def get_coarse_flux_profile(model, min_coarse_bins=10):
    """Coarse-grained net flux profile by pcoord digitization.

    Reference ``_plotting.py:450-515``; the per-cut block sums are computed
    with cumulative sums over the coarse-sorted matrix rather than the
    reference's per-bin double loop.
    """
    binCenters = model.all_centers
    n_coarse_bins = max(min_coarse_bins, model.n_clusters // 10)

    bin_boundaries = np.linspace(
        binCenters[:-2].min() - 0.1, binCenters[:-2].max() + 0.1, n_coarse_bins
    )
    coarse = np.digitize(binCenters[:-2], bin_boundaries, right=True)
    flux_matrix = np.asarray(model.fluxMatrix)[: len(coarse), : len(coarse)]

    new_net_fluxes = np.full(n_coarse_bins, np.nan)
    for coarse_bin_idx in range(n_coarse_bins):
        fwd = coarse <= coarse_bin_idx
        flux_forward = flux_matrix[np.ix_(~fwd, fwd)].sum()
        flux_backward = flux_matrix[np.ix_(fwd, ~fwd)].sum()
        new_net_fluxes[coarse_bin_idx] = flux_forward - flux_backward
    return new_net_fluxes, bin_boundaries


def plot_coarse_flux_profile(model, pcoord_to_use=0):
    """Reference ``_plotting.py:517-569``."""
    plt = _plt()
    binCenters = model.all_centers
    intercept = model.fit_parameters["intercept"]
    slope = model.fit_parameters["slope"]
    r_value = model.fit_parameters["r_value"]

    new_net_fluxes, bin_boundaries = get_coarse_flux_profile(model)
    is_backwards = np.argwhere(new_net_fluxes < 0)
    is_forward = np.argwhere(new_net_fluxes >= 0)

    fig, ax = plt.subplots()
    # Markers follow plot_flux's convention ('>' toward target, '<' toward
    # basis); the reference's coarse profile inverts them
    # (_plotting.py:533-549) relative to its own plot_flux
    ax.scatter(
        bin_boundaries[is_backwards],
        abs(new_net_fluxes[is_backwards] / model.tau),
        color="b", marker="<", s=20, label="Flux toward source/basis",
    )
    ax.plot(
        bin_boundaries[is_forward],
        new_net_fluxes[is_forward] / model.tau,
        "r>", alpha=1.0, linestyle="-", linewidth=1, label="Flux toward target",
    )
    _check_display_overcorrection_warning(model, ax)
    draw_basis_target_boundaries(model, ax, pcoord_to_use)

    sorted_centers = np.argsort(binCenters)
    ax.plot(
        binCenters[sorted_centers],
        slope * binCenters[sorted_centers] + intercept,
        color="gray",
        label=f"Linear fit (m={slope:.1e}, b={intercept:.1e}, r^2={r_value ** 2:.1e})",
    )
    ax.set_ylabel("Flux (weight/second)")
    ax.set_xlabel(f"Pcoord {pcoord_to_use}")
    ax.set_yscale("log")
    ax.legend(bbox_to_anchor=(1.01, 1.0), loc="upper left")
    return fig, ax


def plot_implied_timescales(
    model, lags=(0, 1, 2), n_timescales=3, ax=None, iters_to_use=None
):
    """Implied-timescale lag test plot: t_i vs physical lag time, with the
    t = lag region shaded (timescales below the lag are unresolvable).
    Flat curves indicate Markovian dynamics in the cluster space. Uses
    :meth:`modelWE.get_implied_timescales` (lag support extends the
    reference, whose lag machinery is gated)."""
    plt = _plt()
    lag_times, ts = model.get_implied_timescales(
        lags=lags, n_timescales=n_timescales, iters_to_use=iters_to_use
    )
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    else:
        fig = ax.figure
    for i in range(ts.shape[1]):
        ax.plot(lag_times, ts[:, i], "o-", label=f"$t_{{{i + 2}}}$")
    ax.fill_between(
        lag_times, 0, lag_times, color="gray", alpha=0.3,
        label="unresolvable (t < lag)",
    )
    ax.set_xlabel("lag time")
    ax.set_ylabel("implied timescale")
    ax.set_yscale("log")
    ax.legend()
    return fig, ax


def plot_ck_test(model, lags=(0, 1, 2, 3), sets=None, axes=None, iters_to_use=None):
    """Chapman-Kolmogorov test plot: one panel per coarse set, base-model
    prediction (line) vs directly estimated lagged models (points).
    Coinciding curves indicate Markovian dynamics in the cluster space."""
    plt = _plt()
    lag_times, sets, predicted, estimated = model.get_ck_test(
        lags=lags, sets=sets, iters_to_use=iters_to_use
    )
    n_sets = len(sets)
    if axes is None:
        fig, axes = plt.subplots(1, n_sets, figsize=(4 * n_sets, 3.2), squeeze=False)
        axes = axes[0]
    else:
        fig = axes[0].figure
    for si, ax in enumerate(axes[:n_sets]):
        ax.plot(lag_times, predicted[si], "-", label="predicted $T(\\tau)^k$")
        ax.plot(lag_times, estimated[si], "o", label="estimated $T(k\\tau)$")
        ax.set_title(f"set {si} ({len(sets[si])} states)")
        ax.set_xlabel("lag time")
        ax.set_ylabel("residence probability")
        ax.set_ylim(0, 1.05)
        ax.legend()
    return fig, axes
