"""The port's utilities and the public functions of its ported modules
against the JAX package, on the same seeded numpy inputs.

Tolerances:
  * geometry (torch against jnp, float32): rtol 1e-5 / atol 1e-6. The
    same formulas; cross products, norms and arccos may round differently
    in the last bits.
  * reverse_step, normal_kl, log_normal (float32): rtol 1e-5 / atol 1e-6;
    reverse_step at t = 0 equals the port's posterior mean exactly.
  * everything else (the 3Dmol HTML and SVG strings, numpy helpers, bond
    perception, exceptions): equal.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decompdiff_tpu import constants as jax_constants
from decompdiff_tpu.data import mol as jax_mol
from decompdiff_tpu.data import transforms as jax_transforms
from decompdiff_tpu.diffusion import categorical as jax_categorical
from decompdiff_tpu.diffusion import gaussian as jax_gaussian
from decompdiff_tpu.diffusion.gaussian import (
    GaussianDiffusion as JaxGaussianDiffusion)
from decompdiff_tpu.reconstruct import builder as jax_builder
from decompdiff_tpu.utils import draw2d as jax_draw2d
from decompdiff_tpu.utils import geometry as jax_geometry
from decompdiff_tpu.utils import misc as jax_misc
from decompdiff_tpu.utils import viewer3d as jax_viewer3d
from decompdiff_tpu.utils import visualize as jax_visualize
from decompdiff_tpu_torch import constants, priors
from decompdiff_tpu_torch.data import mol, transforms
from decompdiff_tpu_torch.diffusion import categorical, gaussian
from decompdiff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from decompdiff_tpu_torch.reconstruct import builder
from decompdiff_tpu_torch.utils import (
    draw2d, geometry, misc, viewer3d, visualize)
from tests.test_data_layer import PDB_BLOCK
from tests.test_torch_host_data import assert_same

TOL = dict(rtol=1e-5, atol=1e-6)
SCHEDULE = {'beta_schedule': 'sigmoid', 'beta_start': 1e-7,
            'beta_end': 2e-3, 'num_diffusion_timesteps': 100}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# --------------------------------------------------------------------------
# utils/geometry.py
# --------------------------------------------------------------------------

def _points(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(5, 3)).astype(np.float32) * 2 for _ in range(n)]


GEOMETRY = {
    'normalize_vector': lambda g, a, p: g.normalize_vector(a(p[0])),
    'project_v2v': lambda g, a, p: g.project_v2v(
        a(p[0]), g.normalize_vector(a(p[1]))),
    'construct_3d_basis': lambda g, a, p: g.construct_3d_basis(
        a(p[0]), a(p[1]), a(p[2])),
    'local_to_global': lambda g, a, p: g.local_to_global(
        g.construct_3d_basis(a(p[0]), a(p[1]), a(p[2])), a(p[3]),
        a(np.repeat(p[4][:, None], 2, 1))),
    'global_to_local': lambda g, a, p: g.global_to_local(
        g.construct_3d_basis(a(p[0]), a(p[1]), a(p[2])), a(p[3]),
        a(np.repeat(p[4][:, None], 2, 1))),
    'apply_rotation_to_vector': lambda g, a, p: g.apply_rotation_to_vector(
        g.construct_3d_basis(a(p[0]), a(p[1]), a(p[2])),
        a(p[4][:, None])),
    'dihedral_from_four_points': lambda g, a, p: g.dihedral_from_four_points(
        a(p[0]), a(p[1]), a(p[2]), a(p[3])),
    'angle_from_three_points': lambda g, a, p: g.angle_from_three_points(
        a(p[0]), a(p[1]), a(p[2])),
    'quaternion_to_rotation_matrix': lambda g, a, p: (
        g.quaternion_to_rotation_matrix(a(np.concatenate(
            [p[0], p[1][:, :1]], -1)))),
    'axis_angle_rotation_matrix': lambda g, a, p: (
        g.axis_angle_rotation_matrix(a(p[0][0]), 0.7)),
    'set_dihedral_on_point_cloud': lambda g, a, p: (
        g.set_dihedral_on_point_cloud(a(p[0]), (0, 1, 2, 3), 1.1)),
    'set_dihedral_on_point_cloud_moving': lambda g, a, p: (
        g.set_dihedral_on_point_cloud(a(p[0]), (0, 1, 2, 3), -2.0,
                                      moving_idx=[3, 4])),
}


@pytest.mark.parametrize('name', sorted(GEOMETRY))
def test_geometry_matches_jax(name):
    pts = _points(5, seed=len(name))
    got = GEOMETRY[name](geometry, torch.as_tensor, pts)
    want = GEOMETRY[name](jax_geometry, jnp.asarray, pts)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


def test_set_dihedral_reaches_its_value_and_moves_only_the_branch():
    pos = torch.as_tensor(_points(1, seed=3)[0], dtype=torch.float64)
    out = geometry.set_dihedral_on_point_cloud(pos, (0, 1, 2, 3), 0.5,
                                               moving_idx=[3, 4])
    assert out.dtype == torch.float64 and out.device == pos.device
    assert torch.equal(out[:3], pos[:3])
    got = geometry.dihedral_from_four_points(out[0], out[1], out[2], out[3])
    assert abs(float(got) - 0.5) < 1e-9


# --------------------------------------------------------------------------
# utils/viewer3d.py, utils/visualize.py (3Dmol HTML), utils/draw2d.py (SVG)
# --------------------------------------------------------------------------

def _records(module, n=3):
    """Chain ligands with one double bond each, as MolRecords of `module`."""
    out = []
    for k in range(n):
        rng = np.random.default_rng(k)
        m = 5 + k
        pos = (np.cumsum(rng.normal(size=(m, 3)), 0) * 0.9).astype(
            np.float32)
        src = list(range(m - 1)) + list(range(1, m))
        dst = list(range(1, m)) + list(range(m - 1))
        bond_type = np.ones(len(src), np.int64)
        bond_type[[0, m - 1]] = 2
        out.append(module.MolRecord(
            element=np.array([6, 7, 6, 8, 6, 16, 6][:m]), pos=pos,
            bond_index=np.array([src, dst]), bond_type=bond_type,
            aromatic=np.zeros(m, bool), name=f'lig{k}'))
    return out


def _views(vis, mol_module, tmp_path):
    """One view of each 3D viewer function on the same records."""
    pdb = tmp_path / 'p.pdb'
    pdb.write_text(PDB_BLOCK)
    lig = _records(mol_module)
    traj = np.stack([lig[0].pos + 0.1 * t for t in range(3)])
    result = {'pred_pos': lig[1].pos, 'pred_v': np.array([1, 2, 1, 3, 1, 6]),
              'protein_path': str(pdb)}
    return {
        'complex': vis.visualize_complex(PDB_BLOCK, lig[0]),
        'frags': vis.visualize_complex_with_frags(PDB_BLOCK, lig[:2]),
        'pocket': vis.visualize_complex_highlight_pocket(
            PDB_BLOCK, lig[0], pocket_atom_idx=[0, 2]),
        'xyz': vis.visualize_generated_xyz(result),
        'sdf': vis.visualize_generated_sdf(lig[0], str(pdb)),
        'arms': vis.visualize_generated_arms(lig[:2], str(pdb)),
        'trajectory': vis.visualize_generated_trajectory(traj,
                                                         lig[0].element),
        'ligand': vis.visualize_ligand(lig, surface=True),
        'centers': vis.vis_complex_with_decomp_centers(
            str(pdb), lig[2], [[1, 2, 3], [4, 5, 6]], [[0, 0, 1]]),
    }


def test_3dmol_views_match_jax(tmp_path, monkeypatch):
    """Without py3Dmol both packages record on their first-party
    viewer3d.View; the HTML documents are equal."""
    monkeypatch.setitem(sys.modules, 'py3Dmol', None)   # import fails
    got = _views(visualize, mol, tmp_path)
    want = _views(jax_visualize, jax_mol, tmp_path)
    for key, view in got.items():
        assert isinstance(view, viewer3d.View), key
        assert view._repr_html_() == want[key]._repr_html_(), key
    path = got['complex'].write_html(str(tmp_path / 'v.html'))
    assert open(path).read() == want['complex']._make_html()


def test_viewer3d_recorder_matches_jax():
    calls = [('addModel', ('C 0 0 0\n', 'xyz', {'keepH': True})),
             ('addModelsAsFrames', ('`${x}\\', 'mol0')),
             ('setStyle', ({'stick': {}},)),
             ('setStyle', ({'model': -1}, {'sphere': {'radius': 0.3}})),
             ('addSurface', (viewer3d.SES, {'opacity': 0.5}, {'model': 0})),
             ('addSphere', ({'center': {'x': 1.0, 'y': 2.0, 'z': 3.0}},)),
             ('zoomTo', ()), ('animate', ({'loop': 'forward'},)),
             ('render', ())]
    got, want = viewer3d.view(size=(320, 240)), jax_viewer3d.view(
        size=(320, 240))
    for name, args in calls:
        getattr(got, name)(*args)
        getattr(want, name)(*args)
    assert got.show() == want.show()
    assert (viewer3d.VDW, viewer3d.SAS, viewer3d.SES, viewer3d.MS) == (
        jax_viewer3d.VDW, jax_viewer3d.SAS, jax_viewer3d.SES, jax_viewer3d.MS)


def test_svg_grids_match_jax(tmp_path):
    got, want = _records(mol), _records(jax_mol)
    legends = ['a', 'b']
    for g, w in (
            (visualize.draw_mol_grid(got, legends=legends),
             jax_visualize.draw_mol_grid(want, legends=legends)),
            (visualize.visualize_mol_highlight_fragments(got[1], [[0, 1],
                                                                  [2, 9]]),
             jax_visualize.visualize_mol_highlight_fragments(
                 want[1], [[0, 1], [2, 9]])),
            (draw2d.mols_to_grid_svg([]), jax_draw2d.mols_to_grid_svg([]))):
        assert isinstance(g, draw2d.SVGImage)
        assert g._repr_svg_() == w._repr_svg_()
    assert g._repr_svg_().startswith('<svg')
    np.testing.assert_array_equal(draw2d.layout_2d(got[2]),
                                  jax_draw2d.layout_2d(want[2]))
    assert visualize.mol_record_to_xyz(got[0], 'c') == \
        jax_visualize.mol_record_to_xyz(want[0], 'c')
    saved = visualize.draw_mol_grid(got).save(str(tmp_path / 'g.svg'))
    assert open(saved).read().endswith('</svg>')


# --------------------------------------------------------------------------
# public functions of ported modules
# --------------------------------------------------------------------------

def _diffusions():
    return (GaussianDiffusion.create(SCHEDULE, 'cpu'),
            JaxGaussianDiffusion.create(types.SimpleNamespace(**SCHEDULE)))


def _reverse_inputs(seed=4):
    rng = np.random.default_rng(seed)
    x0, xt = (rng.normal(size=(3, 4, 3)).astype(np.float32) * 2
              for _ in range(2))
    stds = rng.uniform(0.5, 2.0, size=(3, 4, 3)).astype(np.float32)
    return x0, xt, stds


@pytest.mark.parametrize('t', [[0, 0, 0], [1, 50, 99]])
def test_reverse_step_matches_jax_with_injected_noise(t):
    """The JAX step draws eps from its key; the same eps goes into the
    port's step as `noise`, as tests/test_torch_sampler.py injects it."""
    port, jax_diff = _diffusions()
    x0, xt, stds = _reverse_inputs()
    key = jax.random.PRNGKey(5)
    t_np = np.array(t, np.int32)
    eps = np.array(jax.random.normal(key, xt.shape, jnp.float32))
    want = jax_diff.reverse_step(key, jnp.asarray(x0), jnp.asarray(xt),
                                 jnp.asarray(t_np), jnp.asarray(stds))
    args = [torch.as_tensor(a) for a in (x0, xt)]
    tt, st = torch.as_tensor(t_np), torch.as_tensor(stds)
    got = port.reverse_step(None, *args, tt, st, noise=torch.as_tensor(eps))
    _close(got, want)
    if not any(t):       # no noise at t = 0, whatever the generator draws
        drawn = port.reverse_step(torch.Generator().manual_seed(1), *args,
                                  tt, st)
        assert torch.equal(drawn, port.q_posterior_mean(*args, tt))
        assert torch.equal(got, drawn)


def test_reverse_step_draws_from_its_generator():
    port, _ = _diffusions()
    x0, xt, stds = (torch.as_tensor(a) for a in _reverse_inputs())
    t = torch.tensor([5, 60, 99])
    runs = [port.reverse_step(torch.Generator().manual_seed(s), x0, xt, t,
                              stds) for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                             runs[2])
    eps = torch.randn(xt.shape, generator=torch.Generator().manual_seed(7))
    assert torch.equal(runs[0], port.reverse_step(None, x0, xt, t, stds,
                                                  noise=eps))


def test_normal_kl_and_log_normal_match_jax():
    rng = np.random.default_rng(6)
    a, b, c, d = (rng.normal(size=(4, 7, 3)).astype(np.float32)
                  for _ in range(4))
    _close(gaussian.normal_kl(*map(torch.as_tensor, (a, b, c, d))),
           jax_gaussian.normal_kl(*map(jnp.asarray, (a, b, c, d))))
    _close(gaussian.log_normal(*map(torch.as_tensor, (a, b, c * 0.3))),
           jax_gaussian.log_normal(*map(jnp.asarray, (a, b, c * 0.3))))


def test_log_onehot_to_index_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 8, size=(3, 11))
    log_x = jax_categorical.index_to_log_onehot(jnp.asarray(x), 8)
    got = categorical.log_onehot_to_index(
        categorical.index_to_log_onehot(torch.as_tensor(x), 8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_categorical.log_onehot_to_index(log_x)))
    np.testing.assert_array_equal(got.numpy(), x)


def _prior_sample():
    rng = np.random.default_rng(8)

    def part(num):
        return (num, rng.normal(size=3).astype(np.float32),
                np.eye(3, dtype=np.float32) * rng.uniform(0.5, 2),
                rng.normal(size=3).astype(np.float32),
                rng.normal(size=(3, 3)).astype(np.float32))
    return {'arms_prior': [part(5), part(2)], 'scaffold_prior': [part(1)]}


def test_prior_adjustments_match_jax():
    from decompdiff_tpu.priors import (
        apply_num_atoms_change as jax_change, apply_std_coef as jax_coef)
    for fn, jax_fn, arg in ((priors.apply_std_coef, jax_coef, 1.5),
                            (priors.apply_num_atoms_change, jax_change, -3),
                            (priors.apply_num_atoms_change, jax_change, 4)):
        assert_same(fn(_prior_sample(), arg), jax_fn(_prior_sample(), arg))
    assert {'compute_golden_prior', 'get_iso_aniso_mu_cov',
            'substitute_with_beta_prior',
            'substitute_with_given_prior'} <= set(dir(priors))


@pytest.mark.parametrize('seed', range(3))
def test_perceive_bonds_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(12, 3)) * 1.3
    z = rng.choice([6, 7, 8, 16], size=12)
    for kw in ({}, {'stretch_factor': 1.15}):
        assert_same(builder.perceive_bonds(pos, z, **kw),
                    jax_builder.perceive_bonds(pos, z, **kw))


def test_hybridization_and_feature_dims_match_jax():
    idx = np.arange(constants.atom_class_count('full'))
    assert_same(constants.hybridization_from_index(idx, 'full'),
                jax_constants.hybridization_from_index(idx, 'full'))
    for mode in ('basic', 'add_aromatic'):
        with pytest.raises(ValueError):
            constants.hybridization_from_index(idx[:2], mode)
    for mode in ('basic', 'add_aromatic', 'full'):
        assert transforms.ligand_feature_dim(mode) == \
            jax_transforms.ligand_feature_dim(mode)


def test_random_rotation_matches_jax():
    pts = _points(2, seed=9)
    got = transforms.random_rotation(np.random.default_rng(3), *pts)
    want = jax_transforms.random_rotation(np.random.default_rng(3), *pts)
    assert_same(got, want)
    np.testing.assert_allclose(np.linalg.norm(got[0], axis=-1),
                               np.linalg.norm(pts[0], axis=-1), rtol=1e-5)


def test_black_hole_and_error_taxonomy():
    bh = misc.BlackHole()
    bh.some_attr = 3
    assert bh.anything is bh and bh('x', kw=1) is bh
    assert bh.a.b.c(1)(2) is bh
    for name in ('AlphaSpaceError', 'SDFParsingError', 'ExtractPocketError'):
        cls = getattr(misc, name)
        assert issubclass(cls, Exception) and cls.__name__ == name
        assert getattr(jax_misc, name).__mro__[1:] == cls.__mro__[1:]
