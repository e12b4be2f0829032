"""``build.fold_host_share``, the layer clustering and discretization
(``ops/stratified.py``): the share, in percent, of the streaming
clustering's bin batches (a bin seeded or updated by one
``StratifiedKmeans.partial_fit``, or one batch of a device scan) that the
host numpy family ran, over the profiled builds of a ``--trace 1`` run:
``fold_host_bins`` / (``fold_host_bins`` + ``fold_device_bins``), the
program's host counts under ``tracing.collect()``
(``drivers/build_spans.py``). Nothing where the program kept no such
count.

Lower is better at 128 WE bins: the host family seeds a bin at a time in
numpy, the device family seeds and updates every bin of a batch together.
On an NVIDIA H100 (700 W), a 101 x 1,000 build at 128 bins spent 0.26-0.42
s in the fold as routed (104 host bins, 12-17%) and 0.037-0.041 s with
every bin on the device family."""


def read(rec):
    builds = rec.get("trace_counts") or ()
    host = [b.get("fold_host_bins") for b in builds]
    device = [b.get("fold_device_bins") for b in builds]
    if not builds or None in host or None in device or not sum(host) + sum(device):
        return None
    return 100.0 * sum(host) / (sum(host) + sum(device))
