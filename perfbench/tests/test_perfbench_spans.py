"""core/spans.py on a made-up window: device operations put down to the
span that launched them (a launch on a thread with no open span goes to
the window thread's span), idle gaps labelled ` @ <span>`, the table by
span, and the six per-layer numbers, each refused where its span or
counter is missing."""

import pytest

from decompdiff_tpu_torch.utils.profiling import Recording, Span
from perfbench.core import spans as sp

MAIN, GRAD, LOADER = 100, 200, 300          # native thread ids
IDENTS = {MAIN: 1000, GRAD: 2000, LOADER: 3000}
ANCHORS = dict(start=(0, 0), stop=(10 ** 6, 10 ** 6))   # one clock


def _recording(spans, counters=None):
    return Recording([Span(*s) for s in spans], counters or {}, MAIN,
                     IDENTS, **ANCHORS)


def _sample_window():
    rec = _recording([
        ('sample.step', 0, 1000, MAIN, -1, 0),
        ('sample.denoiser', 10, 400, MAIN, 0, 0),
        ('ops.edge_attention', 20, 100, MAIN, 1, 0),
        ('sample.guidance', 400, 600, MAIN, 0, 0),
        ('sample.posterior', 600, 900, MAIN, 0, 0),
        ('ops.edge_attention.backward', 450, 500, GRAD, -1, 0)])
    launches = {1: ('cudaLaunchKernel', 30, 35, 1000),
                2: ('cudaLaunchKernel', 200, 205, 1000),
                3: ('cudaLaunchKernel', 460, 465, 2000),
                4: ('cudaLaunchKernel', 520, 525, 2000),
                5: ('cudaMemcpyAsync', 700, 720, 1000),
                6: ('cudaLaunchKernel', 950, 955, 1000),
                7: ('cudaLaunchKernel', 1200, 1205, 1000)}
    ops = [('k1', 40, 140, 1), ('k2', 210, 260, 2), ('k3', 470, 520, 3),
           ('k4', 530, 580, 4), ('Memcpy HtoD', 720, 740, 5),
           ('k6', 960, 980, 6), ('k7', 1210, 1220, 7),
           ('k8', 1300, 1310, 99)]            # no launch record
    kin = sp.Kineto(ops, launches, [c[:3] for c in launches.values()])
    return sp.Attribution.of(rec, kin, steps=2)


def test_operations_go_to_the_launching_span():
    att = _sample_window()
    assert [att.index.name(i) for i in att.owner] == [
        'ops.edge_attention', 'sample.denoiser',
        'ops.edge_attention.backward',
        # the autograd thread outside its own spans: the window thread's
        'sample.guidance',
        'sample.posterior', 'sample.step', 'none', 'none']
    assert att.attributed_share() == pytest.approx(290 / 310)
    # launched from t = 500 on: k4 to k7; k8 has no launch record
    assert att.attributed_share(since=500) == pytest.approx(90 / 100)


def test_cupti_thread_ids_are_the_low_32_bits_of_the_pthread_id():
    # as read on the card: threading.get_ident() against the runtime
    # record's device_resource_id()
    assert sp.thread32(140564705338112) == -984325376
    assert sp.thread32(140550053295808) == 1543501504


def test_gap_labels_name_the_span():
    assert _sample_window().idle_gaps(n=7) == [
        ['host before k7 @ sample.step', 230e-9],
        ['host before k6 @ sample.posterior', 220e-9],
        ['host before k3 @ sample.denoiser', 210e-9],
        ['host before Memcpy HtoD @ sample.guidance', 140e-9],
        ['host before k8 @ none', 80e-9],
        ['host before k2 @ sample.denoiser', 70e-9],
        ['host in cudaLaunchKernel @ sample.guidance', 10e-9]]


def test_by_span():
    rows = _sample_window().by_span()
    ms = 1e-6 / 2                               # ns to ms, over 2 steps
    assert rows['ops.edge_attention']['device_ms'] == pytest.approx(100 * ms)
    assert rows['ops.edge_attention']['kernels'] == 0.5
    assert rows['sample.posterior']['kernels'] == 0     # a copy
    assert rows['none']['device_ms'] == pytest.approx(20 * ms)
    assert rows['sample.step']['host_ms'] == pytest.approx(1000 * ms)
    idle = {k: v['idle_ms'] / ms for k, v in rows.items() if v['idle_ms']}
    assert idle == pytest.approx({'sample.denoiser': 280,
                                  'sample.guidance': 150,
                                  'sample.posterior': 220,
                                  'sample.step': 230, 'none': 80})


def test_sampling_metrics():
    att = _sample_window()
    got = sp.metrics(att, {}, 'sample')
    assert got == pytest.approx({'guidance_ms.sample': 50 * 1e-6 / 2,
                                 'posterior_ms.sample': 20 * 1e-6 / 2})
    # the device ms under a span count what its inner spans launched
    assert att.device_ms_under('sample.denoiser') == pytest.approx(
        150 * 1e-6 / 2)


def _train_window(counters):
    rec = _recording([
        ('train.step', 0, 1000, MAIN, -1, 7),
        ('train.loss', 10, 300, MAIN, 0, 7),
        ('train.backward', 300, 800, MAIN, 0, 7),
        ('train.optimizer', 800, 950, MAIN, 0, 7),
        ('loader.collate', 100, 300, LOADER, -1, 7),
        ('loader.collate', 500, 900, LOADER, -1, 7)], counters)
    launches = {1: ('cudaLaunchKernel', 810, 815, 1000),
                2: ('cudaLaunchKernel', 400, 405, 2000)}
    ops = [('adam', 820, 870, 1), ('bwd', 410, 430, 2)]
    kin = sp.Kineto(ops, launches, [c[:3] for c in launches.values()])
    return sp.Attribution.of(rec, kin, steps=1)


def test_training_metrics():
    counters = {'loader.gets': 4, 'loader.empty_gets': 1}
    got = sp.metrics(_train_window(counters), counters, 'train')
    assert got == pytest.approx({'optimizer_ms.train': 50e-6,
                                 'step_host_ms.train': 1000e-6,
                                 'collate_ms.train': 300e-6,
                                 'loader_empty_pct.train': 25.0})


@pytest.mark.parametrize('case', ['train_span', 'sample_span', 'counter'])
def test_a_missing_span_or_counter_is_refused(case):
    gets = {'loader.gets': 1}
    att, counters, kind, missing = {
        # the sampling window holds no training span, and the reverse
        'train_span': (_sample_window(), gets, 'train', 'train.optimizer'),
        'sample_span': (_train_window(gets), gets, 'sample',
                        'sample.guidance'),
        'counter': (_train_window({}), {}, 'train', 'loader.gets')}[case]
    with pytest.raises(RuntimeError, match=missing):
        sp.metrics(att, counters, kind)
