"""The hand-written kernels' wrappers: edge_attention, bond_attention and
triplet_attention, each with its backward, whose launch counters this module
gathers; and multi_tensor_adam, the optimizer's update, which keeps its own
(`multi_tensor_adam.launches`)."""

KERNEL_MODULES = ('edge_attention', 'bond_attention', 'triplet_attention')


def launch_counters() -> dict:
    """{name: (wrapper, counter attribute)} of every launch counter of the
    forward and backward wrappers: '<kernel>' and '<kernel>_backward' count
    every launch; the m-gated and gather edge launches ('_mgate', '_gather'
    after 'edge_attention') and the triplet's bf16 launches
    ('triplet_attention_bf16') count in counters of their own as well; so
    do the per-row launches ('<kernel>_row', any mode; '<kernel>_backward_row':
    every width but 32, 64, 128, or outside a head route's heads and
    sources) and the backward launches with the row buffers in device
    memory ('<kernel>_backward_wide')."""
    import importlib
    counters = {}
    for name in KERNEL_MODULES:
        mod = importlib.import_module(f'decompdiff_tpu_torch.ops.{name}')
        fwd, bwd = getattr(mod, name), getattr(mod, f'{name}_backward')
        for n, fn in ((name, fwd), (f'{name}_backward', bwd)):
            counters[n] = (fn, 'launches')
            if name == 'edge_attention':
                for rec, attr in (('mgate', 'gated_launches'),
                                  ('gather', 'gather_launches')):
                    counters[n.replace(name, f'{name}_{rec}')] = (fn, attr)
        if name == 'triplet_attention':
            counters[f'{name}_bf16'] = (fwd, 'bf16_launches')
        counters[f'{name}_row'] = (fwd, 'row_launches')
        counters[f'{name}_backward_wide'] = (bwd, 'scratch_launches')
        counters[f'{name}_backward_row'] = (bwd, 'row_launches')
    return counters


def _triplet_backward():
    from decompdiff_tpu_torch.ops.triplet_attention import (
        triplet_attention_backward)
    return triplet_attention_backward


def launch_counts() -> dict:
    """Every launch count of this process, by the names of launch_counters,
    and the triplet backward's launches at each Nl it ran as
    'triplet_attention_backward_nl<Nl>'."""
    counts = {n: getattr(fn, attr)
              for n, (fn, attr) in launch_counters().items()}
    for nl, c in sorted(_triplet_backward().nl_launches.items()):
        counts[f'triplet_attention_backward_nl{nl}'] = c
    return counts


def zero_launch_counts() -> None:
    """Sets every launch count to 0."""
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)
    _triplet_backward().nl_launches = {}


def launches_since(before: dict) -> dict:
    """The launches counted since `before` (a launch_counts()), nonzero
    ones only."""
    return {k: c - before.get(k, 0) for k, c in launch_counts().items()
            if c != before.get(k, 0)}
