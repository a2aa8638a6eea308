"""The attention kernels' share of their roofline in the sampling window:
the least time of every forward attention call of the traced steps
(counts/work.py, at one peak) over the device time of the kernels named
below, in percent. Moves sample_mol_steps_per_s."""

from perfbench.core.readers import attn_roofline_pct

# the forward kernels of csrc/{edge,bond,triplet}_attention.cu, by name
KERNELS = ('edge_attention_kernel', 'edge_attention_row_kernel',
           'bond_attention_kernel', 'bond_attention_row_kernel',
           'triplet_attention_kernel', 'triplet_attention_row_kernel')


def read(ctx):
    return attn_roofline_pct(ctx, 'sample', KERNELS)
