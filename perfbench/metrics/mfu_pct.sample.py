"""Model FLOPs of the traced guided sampling steps over the traced window
at the card's dense bf16 peak (counts/work.py model_flops), in percent.
Moves sample_mol_steps_per_s."""

from perfbench.core.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, 'sample')
