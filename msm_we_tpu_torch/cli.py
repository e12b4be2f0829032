"""Command-line interface of the port: ``msm-we-tpu-torch``.

Counterpart of ``msm_we_tpu/cli.py`` (the ``msm-we-tpu`` console script)
with the same commands -- ``generate``, ``build``, ``validate``, ``info`` --
and the same JSON. Where the JAX CLI forces the CPU through an environment
variable, ``build`` and ``validate`` take ``--device`` (default ``cuda``; a
run without a card passes ``--device cpu``). ``build`` takes the host flux
route unless ``--device-pipeline`` is given, as the JAX CLI does: the model's
``device_pipeline`` is set from the flag, and only the flag enables the mesh.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="msm-we-tpu-torch",
        description="haMSM estimation from weighted-ensemble data on an NVIDIA GPU",
    )
    sub = parser.add_subparsers(dest="command")
    on_device = argparse.ArgumentParser(add_help=False)
    on_device.add_argument("--device", default="cuda",
                           help="torch device of the model (default: cuda)")

    gen = sub.add_parser("generate", help="Generate a synthetic WE dataset (west.h5)")
    gen.add_argument("output", help="Output west.h5 path")
    gen.add_argument("--iterations", type=int, default=50)
    gen.add_argument("--segments", type=int, default=32)
    gen.add_argument("--seed", type=int, default=0)

    build = sub.add_parser("build", parents=[on_device],
                           help="Build an haMSM from west.h5 files")
    build.add_argument("h5files", nargs="+", help="Input west.h5 paths")
    build.add_argument("--n-clusters", type=int, default=10)
    build.add_argument("--basis", type=float, nargs=2, required=True,
                       help="Basis pcoord bounds (lower upper)")
    build.add_argument("--target", type=float, nargs=2, required=True,
                       help="Target pcoord bounds (lower upper)")
    build.add_argument("--tau", type=float, default=1.0)
    build.add_argument("--stratified", action="store_true",
                       help="Per-WE-bin stratified clustering (n-clusters per bin)")
    build.add_argument("--bin-bounds", type=float, nargs=3, default=None,
                       metavar=("LO", "HI", "NBINS"),
                       help="Rectilinear WE bin grid for stratified clustering")
    build.add_argument("--output", default=None, help="Write results as JSON here")
    build.add_argument("--lag", type=int, default=0,
                       help="Transition lag in iterations (lagtime = tau*(lag+1))")
    build.add_argument("--device-pipeline", action="store_true",
                       help="Discretize parent and child rows in pair launches "
                            "over the model's mesh (the device flux route opens)")
    build.add_argument("--scan-small-batches", action="store_true",
                       help="Run every non-seeding clustering fill batch "
                            "through the device scan (device numerics family)")
    build.add_argument("--save-model", default=None,
                       help="Pickle the built model here")

    validate = sub.add_parser(
        "validate", parents=[on_device],
        help="Lag-validate a saved model (implied timescales + CK test)",
    )
    validate.add_argument("model", help="Pickled model from build --save-model")
    validate.add_argument("--lags", type=int, nargs="+", default=[0, 1, 2, 3],
                          help="n_lag windows (physical lag = tau*(lag+1))")
    validate.add_argument("--n-timescales", type=int, default=3)
    validate.add_argument("--pcca-sets", type=int, default=None,
                          help="Coarse-grain the CK test into N PCCA+ sets "
                               "(default: 2-set slowest-mode sign split)")
    validate.add_argument("--output", default=None, help="Write results as JSON here")

    sub.add_parser("info", help="Print package/device info")

    args = parser.parse_args(argv)

    if args.command == "info":
        import torch

        from . import __version__

        print(f"msm_we_tpu_torch {__version__}")
        print(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
        print(f"cuda available: {torch.cuda.is_available()}")
        for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
            print(f"cuda:{i}: {torch.cuda.get_device_name(i)}")
        return 0

    if args.command == "generate":
        from .data.synthetic import generate_west_h5

        path = generate_west_h5(
            args.output,
            n_iterations=args.iterations,
            n_segments=args.segments,
            seed=args.seed,
        )
        print(f"Wrote synthetic WE dataset to {path}")
        return 0

    if args.command == "build":
        if args.scan_small_batches and not args.stratified:
            parser.error("--scan-small-batches requires --stratified")
        results, model = _build(args)
        print(json.dumps(results, indent=2))
        if args.output:
            with open(args.output, "w") as f:
                json.dump(results, f)
        if args.save_model:
            model.save(args.save_model)
        return 0

    if args.command == "validate":
        results = _validate(args)
        print(json.dumps(results, indent=2))
        if args.output:
            with open(args.output, "w") as f:
                json.dump(results, f)
        return 0

    parser.print_help()
    return 1


def _build(args):
    """The hand-driven build of ``build``: its JSON results and the model."""
    import numpy as np

    from .model import modelWE

    model = modelWE(device=args.device)
    model.initialize(
        args.h5files,
        {"coords": None, "nAtoms": 1, "coord_ndim": 3},
        "cli_model",
        basis_pcoord_bounds=[list(args.basis)],
        target_pcoord_bounds=[list(args.target)],
        dim_reduce_method="none",
        tau=args.tau,
        _suppress_boundary_warning=True,
    )
    # The JAX CLI takes the host route unless the flag enables its mesh;
    # the port's route flag starts True, so it is set from the flag here
    model.device_pipeline = args.device_pipeline
    if args.device_pipeline:
        model.enable_mesh()
    model.get_iterations()
    model.get_coordSet(model.maxIter)
    model.dimReduce()
    cluster_kwargs = {}
    if args.stratified:
        from .binning import RectilinearBinMapper

        if args.bin_bounds is None:
            # Default grid spanning everything discretization will ever
            # assign: parent AND child pcoords across all iterations, the
            # basis/target bounds, and 0.0 (NaN pcoords are zero-filled).
            # Infinite bounds are legal but must not enter the finite grid
            extremes = [
                b
                for b in (0.0, args.basis[0], args.basis[1],
                          args.target[0], args.target[1])
                if np.isfinite(b)
            ]
            for i in range(1, model.maxIter):
                d = model._dataset.iter_data(i)
                for key in ("pcoord0", "pcoord1"):
                    vals = d[key][:, 0]
                    if np.isfinite(vals).any():
                        extremes.append(float(np.nanmin(vals)))
                        extremes.append(float(np.nanmax(vals)))
            lo, hi = min(extremes), max(extremes)
            span = max(hi - lo, 1e-9)
            lo -= 0.001 * span
            hi += 0.001 * span
            nbins = 10
        else:
            lo, hi, nbins = args.bin_bounds
        cluster_kwargs["user_bin_mapper"] = RectilinearBinMapper(
            [np.linspace(lo, hi, int(nbins) + 1)]
        )
    if args.scan_small_batches:
        cluster_kwargs["scan_small_batches"] = True
    model.cluster_coordinates(
        n_clusters=args.n_clusters, stratified=args.stratified, **cluster_kwargs
    )
    model.get_fluxMatrix(args.lag)
    model.organize_fluxMatrix()
    model.get_Tmatrix()
    model.get_steady_state()
    model.get_steady_state_target_flux()
    model.close_files()

    results = {
        "n_clusters": int(model.n_clusters),
        "n_lag": int(args.lag),
        "lagtime": float(model.lagtime),
        "JtargetSS": float(model.JtargetSS),
        "pSS": [float(x) for x in model.pSS],
    }
    return results, model


def _validate(args):
    """Implied timescales and the CK test of a saved model, as JSON
    (NaN and infinities as ``null``; a failed CK test as ``ck_error``)."""
    import numpy as np

    from .model import modelWE
    from .ops.linalg import (
        chapman_kolmogorov_from_flux,
        implied_timescales_from_flux,
        pcca_sets,
    )

    model = modelWE.load(args.model, device=args.device)
    # One pass over the lagged flux matrices feeds both tests
    fms, lag_times = model._lagged_flux_matrices(
        args.lags, iters_to_use=None, drop_basis_target=True
    )
    ts = implied_timescales_from_flux(fms, lag_times, n_timescales=args.n_timescales)

    def _clean(arr):
        # RFC-compliant JSON: NaN/inf become null
        return [
            [None if not np.isfinite(x) else float(x) for x in row]
            for row in np.atleast_2d(arr)
        ]

    results = {
        "lag_times": [float(x) for x in lag_times],
        "implied_timescales": _clean(ts),
    }
    try:
        factors = np.rint(lag_times / lag_times[0]).astype(int)
        if not np.allclose(lag_times / lag_times[0], factors):
            raise ValueError(
                f"CK test needs integer lag multiples of the base "
                f"window; got physical lags {lag_times.tolist()}"
            )
        sets = pcca_sets(fms[0], args.pcca_sets) if args.pcca_sets is not None else None
        sets, predicted, estimated = chapman_kolmogorov_from_flux(fms, factors, sets=sets)
        dev = np.abs(predicted - estimated)
        results.update(
            ck_sets=[[int(s) for s in S] for S in sets],
            ck_predicted=_clean(predicted),
            ck_estimated=_clean(estimated),
            ck_max_abs_deviation=(
                float(np.nanmax(dev)) if np.isfinite(dev).any() else None
            ),
        )
    except ValueError as e:
        # The implied-timescale results are still valid: report them with
        # the CK failure instead of discarding everything
        results["ck_error"] = str(e)
    model.close_files()
    return results


if __name__ == "__main__":
    sys.exit(main())
