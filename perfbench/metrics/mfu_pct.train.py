"""Model FLOPs of the traced training steps over the traced window at the
card's dense bf16 peak (counts/work.py model_flops, three forwards a step),
in percent. Moves train_graphs_per_s."""

from perfbench.core.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, 'train')
