"""sort_device_share.batch: device time of sort kernels over the device's
busy time in the traced window. The screens and reranks select by stable
torch.sort, which runs CUB's radix sort (segmented or whole) and, for short
rows, PyTorch's bitonic sort kernels; these patterns name them."""

PATTERNS = ("RadixSort", "radixSort", "radix_sort", "bitonicSort", "sort_kernel",
            "SegmentedSort", "segmented_sort")


def read(rec):
    if not rec.events:
        return None
    return rec.kernel_us(PATTERNS) / rec.busy_us()
