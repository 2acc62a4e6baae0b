"""device_ops_per_batch.adc8: device_ops_per_batch.batch's reading (device
ops the profiler recorded in the traced window over the batches searched
there) in the 8-bit conventional-ADC cell, whose rerank launches a gather
and an addition for each of the m sub-quantizers."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("device_ops_per_batch.batch.py"),
                   "portbench_metric_device_ops_per_batch.batch").read
