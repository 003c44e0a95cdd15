"""Share of the training window's device time in BatchNorm and the time pools.

Device time of the kernels named for BatchNorm (cuDNN's ``bn_fw``/``bn_bw``,
ATen's ``batch_norm``) and the average pools (ATen's ``avg_pool2d``),
forward and backward, over the summed device time of every kernel, copy
and set in the window (``torch.profiler``'s trace).
"""

BN_POOL = r"(?i)(bn_fw|bn_bw|batch_?norm|avg_pool)"


def read(run):
    t = run.trace
    if t is None:
        return None
    total, n = t.op_seconds()
    part, k = t.op_seconds(BN_POOL)
    return 100.0 * part / total if n and k and total > 0 else None
