from qadc_tpu_torch.kernels.scan_ref import adc_scan_f32, adc_scan_int8, scan_topk_f32, scan_topk_int8

__all__ = [
    "adc_scan_f32",
    "adc_scan_int8",
    "scan_topk_f32",
    "scan_topk_int8",
]
