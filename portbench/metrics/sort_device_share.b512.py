"""sort_device_share.b512: sort_device_share.batch's reading (device time
of sort kernels over the device's busy time in the traced window) in a
cell of batches of 512, whose screens sort ~590k candidates a query."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("sort_device_share.batch.py"),
                   "portbench_metric_sort_device_share.batch").read
