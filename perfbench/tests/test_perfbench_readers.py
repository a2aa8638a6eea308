"""The traced window's arithmetic on a made-up trace: busy time as the
union of intervals, idle gaps and their names, and each per-layer reader
(a reader with nothing to read returns None; the roofline refuses a window
in which no attention kernel ran)."""

import pytest

from perfbench.core import spec
from perfbench.core.readers import ReadContext
from perfbench.core.trace import TraceSummary, short_name, union_us
from perfbench.counts import work

TRIPLET = ('void (anonymous namespace)::triplet_attention_kernel<128, false>'
           '((anonymous namespace)::TripletArgs, int, int)')
SHAPE = work.Shapes(Np=320, Nl=32, protein=(300,) * 4, ligand=(30,) * 4,
                    H=128, heads=16, K=32, layers=6, model_type='uni_o2_bond',
                    classes=8, bond_classes=5)


def _trace():
    ops = [(TRIPLET, 0.0, 40.0), ('at::native::add', 30.0, 50.0),
           ('Memcpy HtoD', 70.0, 80.0), (TRIPLET, 100.0, 150.0)]
    host = [('cudaMemcpyAsync', 45.0, 75.0)]
    return TraceSummary(ops=ops, host=host, window_us=200.0, steps=2)


def test_union_and_gaps():
    assert union_us([(0, 40), (30, 50), (70, 80), (100, 150)]) == 110.0
    t = _trace()
    assert t.busy_us == 110.0 and len(t.kernels) == 3
    gaps = t.idle_gaps()
    assert gaps[0] == ['host before triplet_attention_kernel', 20e-6]
    assert gaps[1] == ['host in cudaMemcpyAsync', 20e-6]
    assert t.top_ops()[0] == [TRIPLET, 90e-6]
    assert short_name(TRIPLET) == 'triplet_attention_kernel'


@pytest.mark.parametrize('kind', ['sample', 'train'])
def test_readers(kind):
    other = {'sample': 'train', 'train': 'sample'}[kind]
    ctx = ReadContext(kind=kind, trace=_trace(), shapes=[SHAPE, SHAPE],
                      denoiser_ms=[2.0, 4.0], loader_wait_s=[0.001, 0.003],
                      peak_mem_bytes=2 ** 31)
    read = {n: spec.metric_reader(n) for n in (
        f'kernels_per_step.{kind}', f'idle_pct.{kind}', f'mfu_pct.{kind}',
        f'peak_mem_gib.{kind}', f'attn_roofline_pct.{kind}',
        f'idle_pct.{other}')}
    assert read[f'kernels_per_step.{kind}'](ctx) == 1.5
    assert read[f'idle_pct.{kind}'](ctx) == pytest.approx(45.0)
    assert read[f'peak_mem_gib.{kind}'](ctx) == 2.0
    assert read[f'idle_pct.{other}'](ctx) is None
    calls = 3 if kind == 'train' else 1
    want = (100 * calls * 2 * work.model_flops(SHAPE)
            / (200e-6 * work.PEAKS['flops_per_s']))
    assert read[f'mfu_pct.{kind}'](ctx) == pytest.approx(want)
    assert read[f'attn_roofline_pct.{kind}'](ctx) > 0
    if kind == 'sample':
        assert spec.metric_reader('denoiser_ms.sample')(ctx) == 3.0
    else:
        assert spec.metric_reader('loader_wait_ms.train')(ctx) == \
            pytest.approx(2.0)


def test_roofline_without_attention_kernels_is_a_fault():
    t = TraceSummary(ops=[('at::native::add', 0.0, 1.0)], host=[],
                     window_us=2.0, steps=1)
    ctx = ReadContext(kind='sample', trace=t, shapes=[SHAPE])
    with pytest.raises(RuntimeError):
        spec.metric_reader('attn_roofline_pct.sample')(ctx)
