"""Notebook visualization helpers (py3Dmol-compatible, RDKit 2D gated;
port of decompdiff_tpu/utils/visualize.py, imports rewritten).

Full surface parity with ref utils/visualize.py:18-412 (complex viewers with
optional VDW surfaces, fragment overlays, pocket highlighting, generated-xyz
and trajectory animation, decomp-center spheres, RDKit grid images). The repo
variants accept this framework's native types — `MolRecord`, numpy arrays,
sampling result dicts — in addition to RDKit mols / raw format blocks.

3D viewers use real py3Dmol when installed (live notebook WebGL widgets);
without it they run on the first-party recorder (utils/viewer3d.py) and
return views with `.write_html(path)` / `._repr_html_()` producing
standalone 3Dmol.js HTML. The 2D grid depictions (`draw_mol_grid`,
`visualize_mol_highlight_fragments`, `vis_decomp_from_meta`) route
MolRecords through the first-party SVG renderer (utils/draw2d.py) when
RDKit is absent; RDKit mols still rasterize through MolsToGridImage.
`mol_record_to_xyz` / `atoms_to_xyz_block` work everywhere.
"""

from __future__ import annotations

import copy
import os
import pickle

import numpy as np

from decompdiff_tpu_torch.constants import ATOMIC_NUM_TO_SYMBOL
from decompdiff_tpu_torch.data.mol import MolRecord, mol_to_sdf_block


# ---------------------------------------------------------------- text blocks

def atoms_to_xyz_block(elements, pos, comment: str = '') -> str:
    """XYZ-format block from parallel element/position arrays
    (the inline xyz builder of ref utils/visualize.py:151-158)."""
    elements = np.asarray(elements)
    pos = np.asarray(pos)
    lines = [str(len(elements)), comment]
    for i in range(len(elements)):
        sym = ATOMIC_NUM_TO_SYMBOL.get(int(elements[i]), 'C')
        x, y, z = pos[i]
        lines.append(f'{sym} {x:.8f} {y:.8f} {z:.8f}')
    return '\n'.join(lines) + '\n'


def mol_record_to_xyz(mol: MolRecord, comment: str = '') -> str:
    """XYZ-format dump of a MolRecord (viewer-agnostic)."""
    return atoms_to_xyz_block(mol.element, mol.pos, comment)


def _to_sdf_block(ligand) -> str:
    """SDF/mol block from a MolRecord, an RDKit mol, or a raw block string."""
    if isinstance(ligand, str):
        return ligand
    if isinstance(ligand, MolRecord):
        return mol_to_sdf_block(ligand)
    from rdkit import Chem
    return Chem.MolToMolBlock(ligand)


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _require_py3dmol():
    """Real py3Dmol when installed; the first-party standalone-HTML
    recorder (utils/viewer3d.py) otherwise — same call surface."""
    try:
        import py3Dmol  # noqa: F401
        return py3Dmol
    except Exception:
        from decompdiff_tpu_torch.utils import viewer3d
        return viewer3d


def _add_protein(view, py3Dmol, pdb_block, show_surface: bool):
    """Shared protein styling (ref utils/visualize.py:22-27)."""
    view.addModel(pdb_block, 'pdb')
    if show_surface:
        view.addSurface(py3Dmol.VDW, {'opacity': 0.7, 'color': 'white'},
                        {'model': -1})
        view.setStyle({'model': -1}, {'cartoon': {'style': 'edged',
                                                  'opacity': 0}})
    else:
        view.setStyle({'model': -1},
                      {'cartoon': {'color': 'spectrum'}, 'line': {}})


# ------------------------------------------------------------- complex views

def visualize_complex(pdb_block, ligand, show_protein_surface=True,
                      show_ligand=True, show_ligand_surface=True,
                      size=(640, 480)):
    """Protein (surface or cartoon) + ligand sticks
    (ref utils/visualize.py:18-38)."""
    py3Dmol = _require_py3dmol()
    view = py3Dmol.view(width=size[0], height=size[1])
    _add_protein(view, py3Dmol, pdb_block, show_protein_surface)
    if show_ligand:
        view.addModel(_to_sdf_block(ligand), 'sdf')
        view.setStyle({'model': -1}, {'stick': {}})
        if show_ligand_surface:
            view.addSurface(py3Dmol.VDW, {'opacity': 0.8}, {'model': -1})
    view.zoomTo()
    return view


def visualize_complex_with_frags(pdb_block, all_frags,
                                 show_protein_surface=True, show_ligand=True,
                                 show_ligand_surface=True, size=(640, 480)):
    """Protein + one stick model per decomposed fragment
    (ref utils/visualize.py:41-63)."""
    py3Dmol = _require_py3dmol()
    view = py3Dmol.view(width=size[0], height=size[1])
    _add_protein(view, py3Dmol, pdb_block, show_protein_surface)
    if show_ligand:
        for frag in all_frags:
            view.addModel(_to_sdf_block(frag), 'sdf')
            view.setStyle({'model': -1}, {'stick': {}})
            if show_ligand_surface:
                view.addSurface(py3Dmol.VDW, {'opacity': 0.8}, {'model': -1})
    view.zoomTo()
    return view


def visualize_complex_highlight_pocket(pdb_block, ligand, pocket_atom_idx=None,
                                       pocket_res_idx=None, pocket_chain=None,
                                       show_ligand=True,
                                       show_ligand_surface=True,
                                       size=(640, 480)):
    """Protein surface with pocket atoms/residues highlighted in red
    (ref utils/visualize.py:66-99)."""
    py3Dmol = _require_py3dmol()
    view = py3Dmol.view(width=size[0], height=size[1])
    view.addModel(pdb_block, 'pdb')
    view.addSurface(py3Dmol.VDW, {'opacity': 0.7, 'color': 'white'},
                    {'model': -1})
    if pocket_atom_idx:
        view.addSurface(py3Dmol.VDW, {'opacity': 0.7, 'color': 'red'},
                        {'model': -1, 'serial': list(pocket_atom_idx)})
    if pocket_res_idx:
        sel = {'model': -1, 'resi': sorted(set(pocket_res_idx))}
        if pocket_chain is not None:
            sel['chain'] = pocket_chain
        view.addSurface(py3Dmol.VDW, {'opacity': 0.7, 'color': 'red'}, sel)
    view.setStyle({'model': -1}, {'cartoon': {'style': 'edged',
                                              'opacity': 0.0}})
    if show_ligand:
        view.addModel(_to_sdf_block(ligand), 'sdf')
        view.setStyle({'model': -1}, {'stick': {}})
        if show_ligand_surface:
            view.addSurface(py3Dmol.VDW, {'opacity': 0.8}, {'model': -1})
    view.zoomTo()
    return view


# --------------------------------------------------- generated-sample views

def visualize_generated_xyz_v2(atom_pos, atom_type, protein_path,
                               ligand_path=None, pocket_atom_idx_list=None,
                               pocket_centers=None, show_ligand=False,
                               show_protein_surface=True, center_opacity=1.0,
                               size=(640, 480)):
    """Generated point cloud + pocket (+ colored sub-pocket surfaces and
    center spheres) (ref utils/visualize.py:148-198)."""
    py3Dmol = _require_py3dmol()
    view = py3Dmol.view(width=size[0], height=size[1])
    view.addModel(atoms_to_xyz_block(atom_type, atom_pos), 'xyz')
    view.setStyle({'model': -1}, {'sphere': {'radius': 0.3}, 'stick': {}})
    _add_protein(view, py3Dmol, _read(protein_path), show_protein_surface)

    colors = ['red', 'blue', 'green', 'orange']
    if pocket_atom_idx_list:
        for i, atom_idx in enumerate(pocket_atom_idx_list):
            view.addSurface(py3Dmol.VDW,
                            {'opacity': 0.7, 'color': colors[i % len(colors)]},
                            {'model': -1, 'serial': list(atom_idx)})
    if pocket_centers is not None:
        for i, c in enumerate(pocket_centers):
            c = np.asarray(c, float)
            view.addSphere({'center': {'x': float(c[0]), 'y': float(c[1]),
                                       'z': float(c[2])},
                            'color': colors[i % len(colors)], 'radius': 1.0,
                            'opacity': center_opacity})
    view.zoomTo()
    if show_ligand and ligand_path is not None:
        view.addModel(_read(ligand_path), 'sdf')
        view.setStyle({'model': -1}, {'stick': {}})
    return view


def visualize_generated_xyz(result: dict, root: str = '',
                            atom_mode: str = 'basic', show_ligand=False,
                            size=(640, 480)):
    """View one sampling-result entry as a raw point cloud in its pocket
    (ref utils/visualize.py:201-236). Consumes the scripts/sample.py entry
    contract: `pred_pos` [N, 3], `pred_v` (atom-CLASS indices, mapped to
    atomic numbers via `atom_mode`), and the provenance paths — falls back
    to `src_protein_filename` under `root` when `protein_path` was not
    recorded (sample.py ran without --protein_path)."""
    from decompdiff_tpu_torch.constants import atomic_numbers_from_index
    protein_path = result.get('protein_path') or result.get(
        'src_protein_filename')
    if not protein_path:
        raise ValueError('result carries no protein path (pass '
                         '--protein_path at sampling time or record '
                         'src_protein_filename)')
    protein_path = os.path.join(root, protein_path)
    elements = atomic_numbers_from_index(result['pred_v'], atom_mode)
    ligand_path = result.get('src_ligand_filename')
    return visualize_generated_xyz_v2(
        result['pred_pos'], elements, protein_path,
        ligand_path=os.path.join(root, ligand_path) if ligand_path else None,
        show_ligand=show_ligand, show_protein_surface=False, size=size)


def visualize_generated_sdf(mol, protein_path, ligand_path=None,
                            show_ligand=False, show_protein_surface=True,
                            size=(640, 480)):
    """Reconstructed molecule (with bonds) + pocket
    (ref utils/visualize.py:239-268)."""
    py3Dmol = _require_py3dmol()
    view = py3Dmol.view(width=size[0], height=size[1])
    view.addModel(_to_sdf_block(mol), 'sdf')
    view.setStyle({'model': -1}, {'sphere': {'radius': 0.3}, 'stick': {}})
    _add_protein(view, py3Dmol, _read(protein_path), show_protein_surface)
    if show_ligand and ligand_path is not None:
        view.addModel(_read(ligand_path), 'sdf')
        view.setStyle({'model': -1}, {'stick': {}})
    view.zoomTo()
    return view


def visualize_generated_arms(mols, protein_path, ligand_path=None,
                             show_ligand=False, show_protein_surface=True,
                             size=(640, 480)):
    """Several generated arms/fragments in one pocket view
    (ref utils/visualize.py:271-301)."""
    py3Dmol = _require_py3dmol()
    view = py3Dmol.view(width=size[0], height=size[1])
    for mol in mols:
        view.addModel(_to_sdf_block(mol), 'sdf')
        view.setStyle({'model': -1}, {'sphere': {'radius': 0.3}, 'stick': {}})
    _add_protein(view, py3Dmol, _read(protein_path), show_protein_surface)
    if show_ligand and ligand_path is not None:
        view.addModel(_read(ligand_path), 'sdf')
        view.setStyle({'model': -1}, {'stick': {}})
    view.zoomTo()
    return view


# ------------------------------------------------------------- trajectories

def _traj_frames(pos_traj, type_traj) -> str:
    frames = []
    for t in range(len(pos_traj)):
        frames.append(atoms_to_xyz_block(type_traj[t], pos_traj[t]))
    return ''.join(frames)


def visualize_xyz_animation(atom_pos_traj, atom_type_traj, protein_path=None,
                            size=(640, 480), interval=50, reps=2):
    """Animated denoising trajectory, optionally inside its pocket
    (ref utils/visualize.py:116-145). `atom_type_traj` may be a single
    per-atom element array (types fixed over time) or one per frame."""
    py3Dmol = _require_py3dmol()
    type_traj = np.asarray(atom_type_traj)
    if type_traj.ndim == 1:
        type_traj = np.broadcast_to(type_traj,
                                    (len(atom_pos_traj), len(type_traj)))
    view = py3Dmol.view(width=size[0], height=size[1])
    view.addModelsAsFrames(_traj_frames(atom_pos_traj, type_traj), 'xyz')
    view.setStyle({'sphere': {'radius': 0.3}, 'stick': {}})
    if protein_path is not None:
        view.addModel(_read(protein_path), 'pdb')
        view.setStyle({'model': -1},
                      {'cartoon': {'color': 'spectrum'}, 'line': {}})
    view.zoomTo()
    view.animate({'loop': 'forward', 'interval': interval, 'reps': reps})
    return view


def visualize_generated_trajectory(traj_pos, elements, size=(640, 480),
                                   interval=50):
    """Animated point-cloud trajectory from stacked sampler outputs."""
    return visualize_xyz_animation(traj_pos, np.asarray(elements),
                                   protein_path=None, size=size,
                                   interval=interval)


# ------------------------------------------------------------ ligand-centric

def visualize_ligand(mol, size=(300, 300), style='stick', surface=False,
                     opacity=0.5):
    """Single-molecule 3D viewer, multi-conformer aware
    (ref utils/visualize.py:304-337)."""
    assert style in ('line', 'stick', 'sphere', 'carton')
    py3Dmol = _require_py3dmol()
    viewer = py3Dmol.view(width=size[0], height=size[1])
    if isinstance(mol, (list, tuple)):
        for i, m in enumerate(mol):
            viewer.addModel(_to_sdf_block(m), f'mol{i}')
    elif not isinstance(mol, (MolRecord, str)) and hasattr(
            mol, 'GetConformers') and len(mol.GetConformers()) > 1:
        from rdkit import Chem
        for i in range(len(mol.GetConformers())):
            viewer.addModel(Chem.MolToMolBlock(mol, confId=i), f'mol{i}')
    else:
        viewer.addModel(_to_sdf_block(mol), 'mol')
    viewer.setStyle({style: {}})
    if surface:
        viewer.addSurface(py3Dmol.SAS, {'opacity': opacity})
    viewer.zoomTo()
    return viewer


def mol_with_atom_index(mol):
    """Copy of an RDKit mol with atom-map numbers = atom indices, conformers
    stripped, for 2D index-labelled depiction (ref utils/visualize.py:340-345)."""
    mol = copy.deepcopy(mol)
    mol.RemoveAllConformers()
    for atom in mol.GetAtoms():
        atom.SetAtomMapNum(atom.GetIdx())
    return mol


def _is_record(mol) -> bool:
    return hasattr(mol, 'bond_index')


def visualize_mol_highlight_fragments(mol, match_list, size=(400, 400),
                                      mols_per_row=4):
    """Grid image of `mol` repeated once per fragment match, each with its
    atoms highlighted (ref utils/visualize.py:102-112). MolRecords render
    through the first-party SVG depiction (utils/draw2d.py)."""
    if _is_record(mol):
        from decompdiff_tpu_torch.utils.draw2d import mols_to_grid_svg
        idx_set = set(range(mol.num_atoms))
        highlights = [[i for i in match if i in idx_set]
                      for match in match_list]
        return mols_to_grid_svg([mol] * len(match_list),
                                highlight_atom_lists=highlights,
                                sub_img_size=size, mols_per_row=mols_per_row)
    from rdkit.Chem import Draw
    idx_set = {a.GetIdx() for a in mol.GetAtoms()}
    highlights = [[i for i in match if i in idx_set] for match in match_list]
    return Draw.MolsToGridImage([mol] * len(match_list),
                                highlightAtomLists=highlights,
                                subImgSize=size, molsPerRow=mols_per_row)


def draw_mol_grid(mols, mols_per_row=4, size=(200, 200), legends=None):
    """Grid image (ref utils/visualize.py MolsToGridImage uses). RDKit mols
    rasterize through RDKit; MolRecords through the first-party SVG grid."""
    mols = list(mols)
    if mols and all(_is_record(m) for m in mols):
        from decompdiff_tpu_torch.utils.draw2d import mols_to_grid_svg
        return mols_to_grid_svg(mols, legends=legends,
                                mols_per_row=mols_per_row,
                                sub_img_size=size)
    from rdkit.Chem import Draw
    return Draw.MolsToGridImage(mols, molsPerRow=mols_per_row,
                                subImgSize=size, legends=legends)


# --------------------------------------------------------- decomp-aware views

def vis_decomp_from_meta(meta_file: str, size=(400, 400), mols_per_row=4):
    """Grid image of the decomposition submols recorded in a preprocessing
    meta pickle (ref utils/visualize.py:348-358). First-party metas carry
    MolRecord submols and render via utils/draw2d; RDKit metas keep the
    reference raster."""
    with open(meta_file, 'rb') as f:
        r = pickle.load(f)
    subs = [s for s in r['data']['all_submols'] if s is not None]
    if subs and all(_is_record(s) for s in subs):
        from decompdiff_tpu_torch.utils.draw2d import mols_to_grid_svg
        return mols_to_grid_svg(subs, sub_img_size=size,
                                mols_per_row=mols_per_row)
    from rdkit.Chem import Draw
    clean = []
    for submol in subs:
        submol = copy.deepcopy(submol)
        submol.RemoveAllConformers()
        clean.append(submol)
    return Draw.MolsToGridImage(clean, subImgSize=size,
                                molsPerRow=mols_per_row)


def vis_complex_from_paths(protein_file: str, ligand_file: str, **kwargs):
    """Complex viewer straight from file paths (ref utils/visualize.py:361-367)."""
    return visualize_complex(_read(protein_file), _read(ligand_file), **kwargs)


def _data_field(data, key: str):
    """Field access for dataset entries: mapping (this framework's
    meta/sample dicts) or attribute object (the reference's Data)."""
    return data[key] if isinstance(data, dict) else getattr(data, key)


def vis_complex_from_data(data, **kwargs):
    """Complex viewer from a dataset entry carrying `protein_file` /
    `ligand_file` (ref utils/visualize.py:361-367)."""
    return vis_complex_from_paths(_data_field(data, 'protein_file'),
                                  _data_field(data, 'ligand_file'), **kwargs)


def vis_decomp_from_data(data, **kwargs):
    """Decomposition grid image from a dataset entry carrying `meta_file`
    (ref utils/visualize.py:348-358; RDKit raster path)."""
    return vis_decomp_from_meta(_data_field(data, 'meta_file'), **kwargs)


def _add_center_spheres(viewer, arm_centers, scaffold_center):
    color_map = ['red', 'green', 'blue']
    for idx, c in enumerate(arm_centers):
        c = np.asarray(c, float).reshape(-1)
        viewer.addSphere({'center': {'x': float(c[0]), 'y': float(c[1]),
                                     'z': float(c[2])},
                          'radius': 1.0, 'color': color_map[idx % 3]})
    scaffold_center = np.asarray(scaffold_center, float).reshape(-1, 3)
    if len(scaffold_center) > 0:
        s = scaffold_center[0]
        viewer.addSphere({'center': {'x': float(s[0]), 'y': float(s[1]),
                                     'z': float(s[2])},
                          'radius': 1.0, 'color': 'yellow'})
    return viewer


def vis_complex_with_decomp_centers(protein_file: str, ligand, arm_centers,
                                    scaffold_center, **kwargs):
    """Complex viewer with arm-prior centers (red/green/blue spheres) and the
    scaffold center (yellow) (ref utils/visualize.py:370-390); also covers the
    generated-mol variant (:393-412) since `ligand` may be any mol form."""
    kwargs.setdefault('show_ligand_surface', False)
    viewer = visualize_complex(_read(protein_file), ligand, **kwargs)
    return _add_center_spheres(viewer, arm_centers, scaffold_center)
