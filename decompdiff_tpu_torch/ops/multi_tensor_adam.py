"""Adam over every parameter in one launch: wrapper, plain version and
launch count of the CUDA kernel in csrc/multi_tensor_adam.cu, and the
torch.optim.Adam that takes its step with it on the card.

For each float32 tensor p with gradient g, moments m and v and step count
s (a 0-d float32 tensor: the steps taken before this one), t = s + 1:

    g = g + weight_decay * p
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g * g
    p = p - lr / (1 - beta1**t) * m / (sqrt(v) / sqrt(1 - beta2**t) + eps)
    s = s + 1

which is torch.optim.Adam's update with its L2 weight decay, in float32,
with the bias corrections formed in double from s and the betas as given,
as optax and perfbench's plain reference form them. torch's own fused CUDA
Adam (2.11 on an H100) shrinks every update by about 6e-6 of itself, as
1 - 0.999**t does with 0.999 rounded to float32, which the training cell's
window-step check of the parameter change tells apart.

`multi_tensor_adam` updates CPU tensors with the plain version and CUDA
tensors with two launches, counted in `multi_tensor_adam.launches` as one:
the update of every tensor (one block per CHUNK elements of each), then the
step counts. Its inputs' addresses go to the device in one table, copied
from pinned memory without a host synchronisation, and a caller whose
tensors stay the same from step to step (MultiTensorAdam's) launches the
same table again: a step then costs the host a few list operations, which
also check that every tensor is still contiguous float32 on the table's
device.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
import operator
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from decompdiff_tpu_torch.ops import _build
from decompdiff_tpu_torch.ops.common import launch, on_cpu

CHUNK = 8192   # elements a block of the update launch

Tensors = Sequence[torch.Tensor]


def multi_tensor_adam_reference(params: Tensors, grads: Tensors,
                                exp_avgs: Tensors, exp_avg_sqs: Tensors,
                                steps: Tensors, *, lr: float, beta1: float,
                                beta2: float, eps: float,
                                weight_decay: float = 0.0,
                                table: Optional['Table'] = None) -> None:
    """Plain PyTorch version of the kernel, one tensor at a time, in place:
    MultiTensorAdam's step on the CPU. It takes multi_tensor_adam's
    arguments, so it can stand in for it (`table` is not read)."""
    for p, g, m, v, s in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        t = float(s) + 1.0
        if weight_decay:
            g = g + weight_decay * p
        m.copy_(beta1 * m + (1 - beta1) * g)
        v.copy_(beta2 * v + (1 - beta2) * g * g)
        p.sub_((lr / (1 - beta1 ** t)) * m / (
            torch.sqrt(v) / math.sqrt(1 - beta2 ** t) + eps))
        s.add_(1)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library('multi_tensor_adam').multi_tensor_adam
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_double] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class Table(NamedTuple):
    """The kernel's int64 table on the device: the addresses of p, m, v, s
    and g of every tensor, their element counts, then each block's tensor
    and first element; `key`, the _key of the tensors it was built for."""
    key: tuple
    table: torch.Tensor
    n_blocks: int


def _key(columns: tuple) -> tuple:
    """What a table holds or was checked for: every tensor's address and
    element count, whether all are contiguous, and the set of their dtypes
    and devices. Equal keys mean the same memory in the same layout. (Maps,
    not a Python loop: a step costs the host no interpreter loop over the
    tensors.)"""
    tensors = list(itertools.chain(*columns))
    return (list(map(torch.Tensor.data_ptr, tensors)),
            list(map(torch.Tensor.numel, tensors)),
            all(map(torch.Tensor.is_contiguous, tensors)),
            set(map(operator.attrgetter('dtype', 'device'), tensors)))


def _table(columns: tuple, key: tuple) -> Table:
    params = columns[0]
    device = params[0].device
    for t in itertools.chain(*columns):
        if (t.device != device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError('multi_tensor_adam takes contiguous float32 '
                             f'tensors on {device}; got {t.dtype} on '
                             f'{t.device}')
    if any(s.dim() for s in columns[3]):
        raise ValueError('the step counts must be 0-d tensors')
    for p, m, v, g in zip(params, *columns[1:3], columns[4]):
        if not p.shape == m.shape == v.shape == g.shape:
            raise ValueError('a parameter, its gradient and its moments '
                             'differ in shape')
    n = len(params)
    numel = np.asarray(key[1][:n], np.int64)
    blocks = -(-numel // CHUNK)
    first = np.repeat(np.cumsum(blocks) - blocks, blocks)
    n_blocks = int(blocks.sum())
    table = np.concatenate([
        np.asarray(key[0], np.int64), numel,
        np.repeat(np.arange(n), blocks),
        (np.arange(n_blocks) - first) * CHUNK])
    return Table(key, torch.from_numpy(table).pin_memory().to(
        device, non_blocking=True), n_blocks)


def multi_tensor_adam(params: Tensors, grads: Tensors, exp_avgs: Tensors,
                      exp_avg_sqs: Tensors, steps: Tensors, *, lr: float,
                      beta1: float, beta2: float, eps: float,
                      weight_decay: float = 0.0,
                      table: Optional[Table] = None) -> Optional[Table]:
    """One Adam step of every tensor in place (the update above): the plain
    version on CPU tensors (returns None), the kernel on CUDA tensors, which
    must all be contiguous float32 on one device (the step counts 0-d).
    On CUDA it returns the Table it launched; given back as `table` while
    the tensors keep their addresses, sizes, contiguity, dtype and device
    (its key), which an update leaves as they are, it is launched again
    without being built and copied anew."""
    if not params:
        return None
    if on_cpu(params[0]):
        multi_tensor_adam_reference(
            params, grads, exp_avgs, exp_avg_sqs, steps, lr=lr, beta1=beta1,
            beta2=beta2, eps=eps, weight_decay=weight_decay)
        return None
    columns = (params, exp_avgs, exp_avg_sqs, steps, grads)
    key = _key(columns)
    if table is None or table.key != key:
        table = _table(columns, key)
    launch(_launcher(), [ctypes.c_void_p(table.table.data_ptr()),
                         len(params), table.n_blocks, CHUNK, lr, beta1,
                         beta2, eps, weight_decay], params[0].device,
           'multi_tensor_adam')
    multi_tensor_adam.launches += 1
    return table


multi_tensor_adam.launches = 0


class MultiTensorAdam(torch.optim.Adam):
    """torch.optim.Adam (its hooks, its state keys exp_avg, exp_avg_sq and
    step, its state_dict) whose step is multi_tensor_adam over the
    parameters that have a gradient, each group's table kept from step to
    step: the kernel when they are on CUDA, its plain version on the CPU.
    Each parameter's `step` is a float32 0-d tensor on the parameter's
    device, where load_state_dict puts it too. Takes torch Adam's lr,
    betas, eps and weight_decay (L2, added to the gradient), and none of
    its other options."""

    OPTIONS = ('amsgrad', 'maximize', 'foreach', 'capturable',
               'differentiable', 'fused', 'decoupled_weight_decay')

    def __init__(self, params, **options):
        refused = [k for k in self.OPTIONS if options.get(k)]
        if refused:
            raise ValueError(f'MultiTensorAdam takes none of {refused}')
        super().__init__(params, **options)
        self._tables: Dict[int, Table] = {}

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group['params']:
                st = self.state.get(p)
                if st and 'step' in st:
                    st['step'] = torch.as_tensor(
                        st['step'], dtype=torch.float32, device=p.device)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for i, group in enumerate(self.param_groups):
            refused = [k for k in self.OPTIONS if group.get(k)]
            if refused:
                raise ValueError(f'MultiTensorAdam takes none of {refused}')
            # maps, not Python loops: over 704 tensors a loop costs the host
            # milliseconds when the loader's threads want the interpreter
            params = group['params']
            grads = list(map(operator.attrgetter('grad'), params))
            if not all(map(operator.is_not, grads, itertools.repeat(None))):
                params = [p for p, g in zip(params, grads) if g is not None]
                grads = [g for g in grads if g is not None]
            states = list(map(self.state.__getitem__, params))
            if not all(states):
                for p, st in zip(params, states):
                    if not st:     # the first step: zeros, step 0
                        st['step'] = torch.zeros((), dtype=torch.float32,
                                                 device=p.device)
                        st['exp_avg'] = torch.zeros_like(p)
                        st['exp_avg_sq'] = torch.zeros_like(p)
            beta1, beta2 = group['betas']
            self._tables[i] = multi_tensor_adam(
                params, grads,
                *(list(map(operator.itemgetter(k), states))
                  for k in ('exp_avg', 'exp_avg_sq', 'step')),
                lr=float(group['lr']), beta1=float(beta1),
                beta2=float(beta2), eps=float(group['eps']),
                weight_decay=float(group['weight_decay']),
                table=self._tables.get(i))
        return loss
