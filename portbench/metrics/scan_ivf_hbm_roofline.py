"""scan_ivf_hbm_roofline: scan_ivf_roofline's reading (the least time of
the IVF grouped 4-bit scan's work by portbench/work/scan_ivf/count.py over
the device time of the kernels portbench/work/scan_ivf/ names, in percent)
in a cell whose index lies in HBM, far beyond the L2, so that M1 streams
the codes it probes from HBM every batch. None when none of them ran."""

from pathlib import Path

from portbench.harness import load_module

read = load_module(Path(__file__).with_name("scan_ivf_roofline.py"),
                   "portbench_metric_scan_ivf_roofline").read
