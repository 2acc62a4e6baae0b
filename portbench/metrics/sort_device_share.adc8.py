"""sort_device_share.adc8: sort_device_share.batch's reading (device time
of sort kernels over the device's busy time in the traced window) in the
8-bit conventional-ADC cell, whose screen sorts each query's ~37k window
minima (24 probes x ~1,536 windows), with no tile minima from the scan."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("sort_device_share.batch.py"),
                   "portbench_metric_sort_device_share.batch").read
