"""The port's host-side guidance (decompdiff_tpu_torch/utils/chem.py,
guidance/{ffmin,ring,mmff}.py) against the JAX package's modules on the
same numpy inputs, and the sampler's host drift (SampleConfig.mmff_callback)
against the JAX sampler's.

  * chem, ffmin and ring are the same float64 numpy and scipy code: their
    outputs are equal, bitwise;
  * the sampler calls the drift only at the steps with
    mmff_end_time <= t < mmff_start_time (t of the step: in strided mode the
    jump's start, not its index), on host copies of (pos_mean, v_next,
    ligand_mask); with the same injected noise and a recording callback
    whose drift is a smooth function of its input, the steps it fires at,
    its inputs and outputs and the final positions agree with the JAX
    sampler's at rtol 1e-4 / atol 1e-5 (tests/test_torch_sampler.py), types
    exactly. The ffmin drift perceives bonds from positions, which is
    discontinuous, so the two ffmin callbacks are held on the JAX run's
    recorded inputs instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompdiff_tpu.data.batch import FullProtein as JaxFullProtein
from decompdiff_tpu.data.mol import MolRecord as JaxMolRecord
from decompdiff_tpu.guidance import ffmin as jffmin
from decompdiff_tpu.guidance import ring as jring
from decompdiff_tpu.models.diffusion_model import DecompDiffModel as JaxModel
from decompdiff_tpu.sampling import sampler as jsampler
from decompdiff_tpu.utils import chem as jchem
from decompdiff_tpu_torch.data.batch import FullProtein
from decompdiff_tpu_torch.data.mol import MolRecord
from decompdiff_tpu_torch.guidance import ffmin, mmff, ring
from decompdiff_tpu_torch.sampling.sampler import (
    SampleConfig, sample_diffusion)
from decompdiff_tpu_torch.utils import chem
from tests.test_torch_sampler import GUIDANCE, NUM_CLASSES, _sampler_case

torch.set_num_threads(2)
POS_TOL = dict(rtol=1e-4, atol=1e-5)


def _equal(got, want, path='out'):
    """Equal structures of numbers, arrays and records, bitwise."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f'{path}[{i}]')
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _equal(got[k], want[k], f'{path}[{k!r}]')
    elif isinstance(want, (np.ndarray, np.generic)):
        assert np.asarray(got).dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, JaxMolRecord):
        assert type(got) is MolRecord, path
        _equal(vars(got), vars(want), path)
    else:
        assert got == want, path


def _records(element, pos, bonds):
    """The same molecule as a port and a JAX MolRecord."""
    idx, typ = [[], []], []
    for (a, b), t in bonds.items():
        idx[0] += [a, b]
        idx[1] += [b, a]
        typ += [t, t]
    fields = dict(element=np.asarray(element),
                  pos=np.asarray(pos, np.float32),
                  bond_index=np.asarray(idx).reshape(2, -1),
                  bond_type=np.asarray(typ, np.int64),
                  aromatic=np.zeros(len(element), bool))
    return MolRecord(**fields), JaxMolRecord(**fields)


def _hexagon(bond=1.39):
    ang = np.pi / 3 * np.arange(6)
    return bond / (2 * np.sin(np.pi / 6)) * np.stack(
        [np.cos(ang), np.sin(ang), np.zeros(6)], axis=1)


def _molecules():
    """Named (element, pos, bonds): fused rings, a spiro pair of
    triangles, chains with double and triple bonds, a stretched bond."""
    hexagon = _hexagon()
    mid = (hexagon[0] + hexagon[1]) / 2
    naph = np.concatenate([hexagon, 2 * mid - hexagon[2:6]])
    naph_bonds = {(i, (i + 1) % 6): 1 for i in range(6)}
    ring2 = [0, 6, 7, 8, 9, 1]
    for a, b in zip(ring2, ring2[1:] + ring2[:1]):
        naph_bonds[(min(a, b), max(a, b))] = 1
    rng = np.random.default_rng(5)
    line = np.zeros((5, 3))
    line[:, 0] = np.arange(5) * 1.45
    line += rng.normal(size=line.shape) * 0.2
    return {
        'naphthalene': ([6] * 10, naph + rng.normal(size=(10, 3)) * 0.05,
                        naph_bonds),
        'spiro': ([6] * 5, rng.normal(size=(5, 3)),
                  {(0, 1): 1, (1, 2): 1, (0, 2): 1, (0, 3): 1, (3, 4): 1,
                   (0, 4): 1}),
        'butane': ([6, 6, 8, 6], line[:4], {(0, 1): 1, (1, 2): 1, (2, 3): 1}),
        'propyne': ([6, 6, 6, 6], line[:4],
                    {(0, 1): 3, (1, 2): 1, (2, 3): 1}),
        'pentene': ([6, 6, 6, 7, 6], line,
                    {(0, 1): 1, (1, 2): 2, (2, 3): 1, (3, 4): 1}),
        'stretched': ([6, 6], [[0., 0., 0.], [2.2, 0., 0.]], {(0, 1): 1}),
    }


@pytest.mark.parametrize('name', sorted(_molecules()))
def test_chem_helpers_match_jax(name):
    rec, jrec = _records(*_molecules()[name])
    for spiro in (False, True):
        _equal(chem.get_ring_systems(rec, includeSpiro=spiro),
               jchem.get_ring_systems(jrec, includeSpiro=spiro))
    _equal(chem._record_rings(rec), jchem._record_rings(jrec))
    _equal(chem.num_x_mem_ring(rec, (3, 6, 10)),
           jchem.num_x_mem_ring(jrec, (3, 6, 10)))
    _equal(chem._record_rotatable_bonds(rec),
           jchem._record_rotatable_bonds(jrec))
    assert (chem.get_num_rotatable_bonds(rec)
            == jchem.get_num_rotatable_bonds(jrec))
    frags, rot = chem.break_rotatable_bond(rec)
    jfrags, jrot = jchem.break_rotatable_bond(jrec)
    assert rot == jrot and len(frags) == len(jfrags)
    for f, jf in zip(frags, jfrags):
        _equal(f, jf)
    _equal(chem.ff_optimize(rec), jchem.ff_optimize(jrec))
    other = rec.pos + np.random.default_rng(1).normal(size=rec.pos.shape)
    assert chem.get_rmsd(rec.pos, other) == jchem.get_rmsd(jrec.pos, other)


def test_chem_ff_optimize_relaxes_and_keeps_the_input():
    rec, _ = _records(*_molecules()['stretched'])
    energy_change, rmsd, out = chem.ff_optimize(rec)
    assert energy_change > 0 and rmsd > 0.05
    assert abs(np.linalg.norm(out.pos[1] - out.pos[0]) - 1.52) < 1e-2
    assert rec.pos[1, 0] == np.float32(2.2)
    lone, _ = _records([6], np.zeros((1, 3)), {})
    assert chem.ff_optimize(lone) == (None,)


@pytest.mark.parametrize('name', sorted(_molecules()))
def test_ffmin_terms_energy_and_relaxation_match_jax(name):
    element, pos, bonds = _molecules()[name]
    pos, element = np.asarray(pos, np.float64), np.asarray(element)
    terms = ffmin.build_ff_terms(pos, element, bonds)
    _equal(terms, jffmin.build_ff_terms(pos, element, bonds))
    x = pos.reshape(-1)
    _equal(ffmin.ff_energy_grad(x, terms), jffmin.ff_energy_grad(x, terms))
    _equal(ffmin.relax_positions(pos, element, bonds, return_energy=True),
           jffmin.relax_positions(pos, element, bonds, return_energy=True))
    for z, n, order in ((6, 2, 3), (8, 2, 1), (6, 2, 4), (6, 3, 1),
                        (7, 4, 1), (6, 2, 2), (16, 2, 1), (6, 1, 1)):
        assert (ffmin._equilibrium_angle(z, n, order)
                == jffmin._equilibrium_angle(z, n, order))


def _drift_inputs(mode):
    """A batch for the drift callbacks: a perturbed carbon chain, a ring,
    two atoms 10 A apart (disconnected: no drift) and a lone atom."""
    B, Nl = 4, 8
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(B, Nl, 3)).astype(np.float32) * 5
    mask = np.zeros((B, Nl), bool)
    chain = np.array([[0.0, 0, 0], [1.5, 0.1, 0], [2.9, -0.2, 0.2],
                      [4.4, 0.15, -0.1], [5.3, 1.3, 0.3]])
    pos[0, :5], mask[0, :5] = chain, True
    pos[1, :6] = _hexagon(1.42) + rng.normal(size=(6, 3)) * 0.08
    mask[1, :6] = True
    pos[2, 0], pos[2, 1], mask[2, :2] = 0, [10, 0, 0], True
    mask[3, 0] = True
    # carbons; with add_aromatic the ring's atoms carry the aromatic class
    v = np.ones((B, Nl), np.int64)
    if mode == 'add_aromatic':
        v[1, :6] = 7
    return pos, v, mask


@pytest.mark.parametrize('mode', ['basic', 'add_aromatic'])
def test_ff_callback_matches_jax(mode):
    pos, v, mask = _drift_inputs(mode)
    got = ffmin.make_ff_callback(mode)(pos, v, mask)
    _equal(got, jffmin.make_ff_callback(mode)(pos, v, mask))
    assert np.abs(got[:2]).max() > 0 and not got[2:].any()
    assert not got[~mask].any()


def _polyacene(n_rings, bond=1.4):
    pts = set()
    for k in range(n_rings):
        cx = k * np.sqrt(3) * bond
        for i in range(6):
            ang = np.pi / 6 + i * np.pi / 3
            pts.add((round(cx + bond * np.cos(ang), 6),
                     round(bond * np.sin(ang), 6)))
    return np.array([[x, y, 0.0] for x, y in sorted(pts)])


@pytest.mark.parametrize('n_rings', [1, 2, 3, 4])
def test_ring_repulsion_matches_jax(n_rings):
    pos = _polyacene(n_rings)
    pos = pos + np.random.default_rng(3).normal(size=pos.shape) * 0.01
    _equal(ring.ring_repulsion_single(pos), jring.ring_repulsion_single(pos))
    _equal(ring.ring_repulsion_energy_single(pos),
           jring.ring_repulsion_energy_single(pos))
    B, Nl = 2, len(pos) + 2
    batch = np.zeros((B, Nl, 3))
    batch[:, :len(pos)] = pos
    mask = np.zeros((B, Nl), bool)
    mask[0, :len(pos)] = mask[1, :len(pos) - 1] = True
    v = np.zeros((B, Nl), np.int64)
    got = ring.make_ring_repulsion_callback()(batch, v, mask)
    _equal(got, jring.make_ring_repulsion_callback()(batch, v, mask))
    assert (np.abs(got).max() > 0) == (n_rings >= 3)


def test_mmff_callback_needs_rdkit():
    if mmff.HAS_RDKIT:
        pytest.skip('RDKit is installed: the RDKit path applies')
    with pytest.raises(ImportError, match='RDKit'):
        mmff.make_mmff_callback('basic')


# --------------------------------------------------------------------------
# the sampler's host drift
# --------------------------------------------------------------------------

class Recorder:
    """A drift that is a smooth function of its input; records every call's
    inputs and output."""

    def __init__(self):
        self.calls = []

    def __call__(self, pos, v, mask):
        pos, v, mask = np.array(pos), np.array(v), np.array(mask)
        out = (0.05 * np.sin(pos) * mask[..., None]).astype(np.float32)
        self.calls.append((pos, v, mask, out))
        return out


def _port_run(steps, mode, callback=None, start=0, end=0):
    cfg, model, params, batch, jbatch, init, noise, full = _sampler_case(
        steps)
    full_mask = torch.ones(full.shape[:2], dtype=torch.bool)
    scfg = SampleConfig(num_steps=steps, skip_mode=mode, save_traj=False,
                        energy_drift=GUIDANCE, mmff_callback=callback,
                        mmff_start_time=start, mmff_end_time=end)
    return sample_diffusion(
        model, scfg, batch, torch.as_tensor(init['pos']),
        torch.as_tensor(init['v']), torch.as_tensor(init['bond']),
        FullProtein(torch.as_tensor(full), full_mask),
        noise_override={k: torch.as_tensor(v) for k, v in noise.items()})


def test_drift_window_gating():
    """truncate over T = 50, 10 steps (t = 49 .. 40): an empty window fires
    nothing and leaves the result bitwise equal; [42, 45) fires at t = 44,
    43, 42 exactly; strided, 5 steps (t = 49, 37, 24, 12, 0): [10, 40)
    fires at t = 37, 24, 12 (step indices 1-3)."""
    base = _port_run(10, 'truncate')
    empty = Recorder()
    out = _port_run(10, 'truncate', empty, start=0, end=0)
    assert empty.calls == []
    for key in ('pos', 'v', 'bond'):
        assert torch.equal(out[key], base[key]), key
    fired = Recorder()
    out = _port_run(10, 'truncate', fired, start=45, end=42)
    assert len(fired.calls) == 3
    assert not torch.allclose(out['pos'], base['pos'])
    pos, v, mask, _ = fired.calls[0]
    assert pos.shape == (2, 10, 3) and pos.dtype == np.float32
    assert v.shape == mask.shape == (2, 10) and mask.dtype == bool
    strided = Recorder()
    _port_run(5, 'strided', strided, start=40, end=10)
    assert len(strided.calls) == 3


def test_drift_inputs_and_outputs_match_jax_sampler():
    steps, mode, start, end = 5, 'strided', 40, 10
    cfg, model, params, batch, jbatch, init, noise, full = _sampler_case(
        steps)
    jrec, rec = Recorder(), Recorder()
    want = jsampler.sample_diffusion(
        JaxModel.create(cfg, NUM_CLASSES), jsampler.SampleConfig(
            num_steps=steps, skip_mode=mode, save_traj=False,
            energy_drift=GUIDANCE, mmff_callback=jrec,
            mmff_start_time=start, mmff_end_time=end),
        params, jax.random.PRNGKey(0), jbatch, jnp.asarray(init['pos']),
        jnp.asarray(init['v']), jnp.asarray(init['bond']),
        full_protein=JaxFullProtein(jnp.asarray(full),
                                    jnp.ones(full.shape[:2], bool)),
        noise_override={k: jnp.asarray(v) for k, v in noise.items()})
    got = _port_run(steps, mode, rec, start, end)

    assert len(rec.calls) == len(jrec.calls) == 3
    for (pos, v, mask, out), (jpos, jv, jmask, jout) in zip(rec.calls,
                                                            jrec.calls):
        assert pos.dtype == jpos.dtype and pos.shape == jpos.shape
        np.testing.assert_allclose(pos, jpos, **POS_TOL)
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(mask, jmask)
        np.testing.assert_allclose(out, jout, **POS_TOL)
    np.testing.assert_array_equal(got['v'].numpy(), np.asarray(want['v']))
    np.testing.assert_allclose(got['pos'].numpy(), np.asarray(want['pos']),
                               **POS_TOL)

    # both ffmin drifts on the JAX run's recorded inputs, and on a batch
    # with molecules that relax
    for pos, v, mask, _ in jrec.calls + [(*_drift_inputs('basic'), None)]:
        _equal(ffmin.make_ff_callback('basic')(pos, v, mask),
               jffmin.make_ff_callback('basic')(pos, v, mask))
