"""The attention kernels' share of their roofline in the training window:
the least time of every forward and backward attention call of the traced
steps (counts/work.py: the backwards' head-factorized least work, at one
peak) over the device time of the kernels named below, in percent. Moves
train_graphs_per_s."""

from perfbench.core.readers import attn_roofline_pct

# every kernel of csrc/{edge,bond,triplet}_attention.cu, forward and
# backward, and the backwards' reduction of per-block parameter gradients
KERNELS = ('edge_attention', 'bond_attention', 'triplet_attention',
           'reduce_slots')


def read(ctx):
    return attn_roofline_pct(ctx, 'train', KERNELS)
