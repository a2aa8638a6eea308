"""Device milliseconds a step between the CUDA events the harness records
on the stream before and after the model's denoiser call (a forward hook),
the mean over the traced steps. Moves sample_mol_steps_per_s."""

from perfbench.core.readers import mean_ms


def read(ctx):
    return mean_ms(ctx.denoiser_ms) if ctx.kind == 'sample' else None
