"""Device kernels a guided sampling step launches, counted in the
profiler's trace of the traced window (memory copies and sets left out).
Moves sample_mol_steps_per_s."""

from perfbench.core.readers import kernels_per_step


def read(ctx):
    return kernels_per_step(ctx, 'sample')
