"""K2's share of its roofline in the scoring window: the least time its launches need over the time they took.

K2 is the fused conv-block kernel (``ops/conv_block``, ``csrc/conv_block.cu``):
one block-1 launch (``conv_block_cin1_f32`` or ``conv_block_cin1_tc``) and
two block-2 and -3 launches (``conv_block_f32`` or ``conv_block_tc``) a
batch. The bound of a batch is the three launches' bounds at the traffic's
batch and the configuration's precision (``counts/cnn2d.k2_block_bounds``);
the time is the launches' summed device time in ``torch.profiler``'s trace.
Silent where the trace holds no K2 launch or not two later launches per
block-1 launch.
"""

from perfbench.counts.cnn2d import k2_batch_bound_s
from perfbench.lib.bench import model_dims

BLOCK1 = r"(?<![A-Za-z0-9_])conv_block_cin1_(f32|tc)(?![A-Za-z0-9_])"
BLOCKS23 = r"(?<![A-Za-z0-9_])conv_block_(f32|tc)(?![A-Za-z0-9_])"


def read(run):
    t = run.trace
    if t is None:
        return None
    s1, n1 = t.op_seconds(BLOCK1)
    s23, n23 = t.op_seconds(BLOCKS23)
    if n1 == 0 or n23 != 2 * n1 or s1 + s23 <= 0:
        return None
    need = n1 * k2_batch_bound_s(model_dims(run.config, "cnn2d"), run.traffic["batch_size"], run.config["dtype"])
    return 100.0 * need / (s1 + s23)
