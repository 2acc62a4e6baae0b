"""The work of the flat 4-bit scan for one batch of queries, from the
inputs' shapes and sizes, not from any kernel: bytes are the n real codes
read once (padding excluded), the int8 tables once (query x sub-quantizer x
16) and one int32 minimum a (query, window of real codes) written once (a
window is a storage row: 128 / code bytes codes); operations are one int8
lookup-addition a (query, real code, sub-quantizer)."""


def count(dep, qids) -> tuple[int, int]:
    state = dep.state()
    q = len(qids)
    n = int(state.sizes[0])
    code_bytes = state.codes.shape[-1]
    m = 2 * code_bytes
    cpr = 128 // code_bytes
    moved = n * code_bytes + q * m * 16 + q * (-(-n // cpr)) * 4
    return moved, q * n * m
