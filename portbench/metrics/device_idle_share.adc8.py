"""device_idle_share.adc8: device_idle_share.batch's reading (1 - the
device-busy seconds a batch in the traced window over the seconds a batch
of the untraced pacing loop) in the 8-bit conventional-ADC cell, whose
device work a batch (kernel 5, the wide screen, the gather rerank) differs
from the 4-bit cells'."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("device_idle_share.batch.py"),
                   "portbench_metric_device_idle_share.batch").read
