"""AutoDock Vina / QVina docking wrappers (host, gated on external tools).

Parity with ref utils/evaluation/docking_vina.py (PrepLig/PrepProt/VinaDock/
VinaDockingTask) and ref utils/evaluation/docking.py:24-183 (QVinaDockingTask
subprocess pipeline + SDF REMARK parsing). Where the vina/meeko/
AutoDockTools/pdb2pqr/obabel/qvina2 tools are missing, every entry point
degrades to an informative ImportError/FileNotFoundError so the evaluation
driver can skip docking without breaking, and the subprocess/vina seams are
monkeypatchable for tests.

Unlike the reference, the ligand SDF writer also accepts the RDKit-free
MolRecord (data/mol.py), so box geometry and the pipeline plumbing work on
hosts without RDKit.

Unlike the JAX package, a tmp_dir left out is the platform's temporary
directory (TMPDIR, resolve_tmp_dir) rather than a fixed /tmp.

Port of decompdiff_tpu/evaluation/docking.py,
the same numpy in the same order.
"""

from __future__ import annotations

import os
import random
import string
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

# Receptor prep is expensive (pdb2pqr + prepare_receptor4, tens of seconds)
# and the evaluation driver docks samples on a thread pool, so concurrent
# tasks on the SAME receptor must serialize through one lock: without it the
# pool workers duplicate the prep AND collide on the scratch names (the old
# pid-only suffix was shared by every thread in the process — one os.replace
# consumed the tmp file and the loser's replace raised ENOENT, dropping its
# sample from the evaluation).
_receptor_locks_guard = threading.Lock()
_receptor_locks: dict = {}


def _receptor_lock(path: str) -> threading.Lock:
    # Key on the canonical path so relative/absolute/symlinked spellings of
    # one receptor all serialize through the same lock.
    key = os.path.realpath(path)
    with _receptor_locks_guard:
        return _receptor_locks.setdefault(key, threading.Lock())


def _have(cmd: str) -> bool:
    from shutil import which
    return which(cmd) is not None


def resolve_tmp_dir(tmp_dir: Optional[str]) -> str:
    """The docking scratch dir: tmp_dir, else the platform's temporary
    directory."""
    return tempfile.gettempdir() if tmp_dir is None else tmp_dir


def get_random_id(length=30):
    return ''.join(random.choice(string.ascii_lowercase)
                   for _ in range(length))


def _mol_positions(mol) -> np.ndarray:
    """Heavy-atom coordinates from an RDKit mol or a MolRecord."""
    if hasattr(mol, 'bond_index'):  # MolRecord
        return np.asarray(mol.pos, np.float64)
    return np.asarray(mol.GetConformer(0).GetPositions(), np.float64)


def _mol_positions_with_hs(mol) -> np.ndarray:
    """Coordinates INCLUDING explicit hydrogens for the search-box geometry:
    both reference tasks AddHs(addCoords=True) before reading positions
    (ref docking_vina.py:183-196, docking.py:87-105), so the box extends
    over the H shell. MolRecords (RDKit-free) stay heavy-atom."""
    if hasattr(mol, 'bond_index'):
        return np.asarray(mol.pos, np.float64)
    from rdkit import Chem
    m = Chem.AddHs(mol, addCoords=True)
    return np.asarray(m.GetConformer(0).GetPositions(), np.float64)


def _write_ligand_sdf(mol, path: str, add_hs: bool = True):
    """Write the generated ligand to SDF (RDKit path adds explicit Hs with
    coordinates, ref docking_vina.py:183-190; MolRecord path writes as-is)."""
    if hasattr(mol, 'bond_index'):
        from decompdiff_tpu_torch.data.mol import mol_to_sdf_block
        with open(path, 'w') as f:
            f.write(mol_to_sdf_block(mol))
        return mol
    from rdkit import Chem
    rdmol = Chem.AddHs(mol, addCoords=True) if add_hs else mol
    writer = Chem.SDWriter(path)
    writer.write(rdmol)
    writer.close()
    return rdmol


def compute_box(pos: np.ndarray, center=None, size_factor: Optional[float] = 1.0,
                buffer: float = 5.0):
    """Search-box geometry (ref docking_vina.py:193-202 / docking.py:96-105):
    center = ligand bbox center unless given; size = extent * size_factor +
    buffer, or a fixed 20 A cube when size_factor is None."""
    pos = np.asarray(pos, np.float64)
    if center is None:
        center = (pos.max(0) + pos.min(0)) / 2
    center = [float(c) for c in np.asarray(center)]
    if size_factor is None:
        size = [20.0, 20.0, 20.0]
    else:
        size = [float(s) for s in
                (pos.max(0) - pos.min(0)) * size_factor + buffer]
    return center, size


class PrepLig:
    """Ligand SDF -> PDBQT via meeko (ref docking_vina.py:30-58)."""

    def __init__(self, input_mol: str, mol_format: str):
        from rdkit import Chem
        from rdkit.Chem import AllChem
        if mol_format == 'smi':
            # keep the embedded AddHs mol — embedding a temporary copy
            # would leave self.ob_mol with no conformer for meeko
            mol = Chem.AddHs(Chem.MolFromSmiles(input_mol))
            AllChem.EmbedMolecule(mol)
            self.ob_mol = mol
        elif mol_format == 'sdf':
            self.ob_mol = Chem.MolFromMolFile(input_mol, removeHs=False)
        else:
            raise ValueError(mol_format)

    def get_pdbqt(self, lig_pdbqt: str):
        from meeko import MoleculePreparation
        preparator = MoleculePreparation()
        preparator.prepare(self.ob_mol)
        preparator.write_pdbqt_file(lig_pdbqt)


class PrepProt:
    """Protein -> PDBQT via pdb2pqr + ADT prepare_receptor4
    (ref docking_vina.py:61-82)."""

    def __init__(self, pdb_file: str):
        self.prot = pdb_file

    def del_water(self, dry_pdb_file: str):
        with open(self.prot) as f:
            lines = [l for l in f if l.startswith(('ATOM', 'HETATM'))
                     and 'HOH' not in l]
        with open(dry_pdb_file, 'w') as f:
            f.writelines(lines)
        self.prot = dry_pdb_file

    def addH(self, prot_pqr: str):
        if not _have('pdb2pqr30'):
            raise FileNotFoundError('pdb2pqr30 not found on PATH')
        subprocess.run(['pdb2pqr30', '--ff=AMBER', self.prot, prot_pqr],
                       check=True, capture_output=True)
        self.prot_pqr = prot_pqr

    def get_pdbqt(self, prot_pdbqt: str):
        if not _have('prepare_receptor4.py'):
            raise FileNotFoundError('AutoDockTools prepare_receptor4.py '
                                    'not found on PATH')
        subprocess.run(['prepare_receptor4.py', '-r', self.prot_pqr,
                        '-o', prot_pdbqt], check=True, capture_output=True)


class VinaDock:
    """Thin wrapper over the python vina API (ref docking_vina.py:85-149)."""

    def __init__(self, lig_pdbqt: str, prot_pdbqt: str):
        self.lig_pdbqt = lig_pdbqt
        self.prot_pdbqt = prot_pdbqt
        self.pocket_center: Optional[List[float]] = None
        self.box_size: Optional[List[float]] = None

    def get_box(self, ref_ligand_pos: np.ndarray, buffer: float = 5.0):
        """Box = ligand extent + buffer (ref docking_vina.py:90-116)."""
        self.pocket_center, self.box_size = compute_box(
            ref_ligand_pos, size_factor=1.0, buffer=buffer)

    def run(self, mode: str = 'dock', exhaustiveness: int = 8,
            save_pose: bool = True, **kwargs):
        """One Vina call; returns (score, pose) (ref docking_vina.py:118-149)."""
        from vina import Vina
        v = Vina(sf_name='vina', seed=0, verbosity=0)
        v.set_receptor(self.prot_pdbqt)
        v.set_ligand_from_file(self.lig_pdbqt)
        v.compute_vina_maps(center=self.pocket_center, box_size=self.box_size)
        pose = None
        if mode == 'score_only':
            score = v.score()[0]
        elif mode == 'minimize':
            score = v.optimize()[0]
            if save_pose:
                with tempfile.NamedTemporaryFile('r', suffix='.pdbqt') as tmp:
                    v.write_pose(tmp.name, overwrite=True)
                    pose = open(tmp.name).read()
        elif mode == 'dock':
            v.dock(exhaustiveness=exhaustiveness, n_poses=1)
            score = v.energies(n_poses=1)[0][0]
            if save_pose:
                pose = v.poses(n_poses=1)
        else:
            raise ValueError(mode)
        return (score, pose) if save_pose else score


class VinaDockingTask:
    """End-to-end docking of one generated molecule against its pocket
    (ref docking_vina.py:152-227). run() returns [{'affinity', 'pose'}] to
    match the reference driver's indexing (ref evaluate_mol_from_meta_full.py
    :188-198)."""

    def __init__(self, mol, protein_path: str, tmp_dir: Optional[str] = None,
                 center=None, size_factor: Optional[float] = 1.0,
                 buffer: float = 5.0):
        if protein_path is None:
            raise ValueError('protein_path is required for docking — pass '
                             '--protein_root to the evaluation driver or '
                             'record protein_path at sampling time')
        self.mol = mol
        self.protein_path = protein_path
        self.tmp_dir = resolve_tmp_dir(tmp_dir)
        # box geometry honored exactly as the reference (:193-202),
        # including the explicit-H extent (ref AddHs before reading pos)
        self.center, self.box_size = compute_box(
            _mol_positions_with_hs(mol), center, size_factor, buffer)

    @classmethod
    def from_generated_mol(cls, mol, ligand_filename: str, protein_root: str,
                           **kwargs):
        """Protein path derived from the ligand filename as
        <dir>/<basename[:10]>.pdb (ref docking_vina.py:154-162)."""
        protein_fn = os.path.join(
            os.path.dirname(ligand_filename),
            os.path.basename(ligand_filename)[:10] + '.pdb')
        return cls(mol, os.path.join(protein_root, protein_fn), **kwargs)

    def _receptor_pdbqt(self) -> str:
        """Prepare (or reuse) the receptor PDBQT. The reference caches the
        .pqr/.pdbqt beside the protein file and skips re-prep when present
        (ref docking_vina.py:209-221) — re-running pdb2pqr +
        prepare_receptor4 per molecule and per mode costs tens of seconds
        each and would dominate a 100-sample evaluation. Falls back to a
        path-keyed cache under tmp_dir when the protein dir is read-only."""
        # canonicalize FIRST so every spelling of one receptor (relative,
        # absolute, symlinked) derives the same artifact paths — and
        # therefore the same prep lock and cache entry
        ppath = os.path.realpath(self.protein_path)
        base = ppath[:-4]
        if not os.access(os.path.dirname(ppath) or '.', os.W_OK):
            import hashlib
            h = hashlib.sha1(ppath.encode()).hexdigest()[:16]
            cache = os.path.join(self.tmp_dir, 'ddtpu_receptor_cache')
            os.makedirs(cache, exist_ok=True)
            base = os.path.join(cache, h)
        pqr, pdbqt = base + '.pqr', base + '.pdbqt'
        with _receptor_lock(pdbqt):
            if os.path.exists(pdbqt):
                return pdbqt
            # prep in a scratch dir and publish each artifact with an
            # atomic os.replace: a crashed/interrupted subprocess must not
            # leave a partial file that every later run silently reuses,
            # and concurrent evaluators racing on the same receptor each
            # read only complete files (last complete writer wins).
            # scratch names live BESIDE the destinations (os.replace is
            # only atomic within a filesystem) and carry pid+tid: the lock
            # serializes this process, the unique name keeps cross-PROCESS
            # racers from clobbering each other's scratch files
            suffix = f'.tmp{os.getpid()}_{threading.get_ident()}'
            with tempfile.TemporaryDirectory(dir=self.tmp_dir) as td:
                prot = PrepProt(ppath)
                prot.del_water(os.path.join(td, 'dry.pdb'))
                try:
                    if os.path.exists(pqr):
                        prot.prot_pqr = pqr
                    else:
                        prot.addH(pqr + suffix)
                        os.replace(pqr + suffix, pqr)
                        prot.prot_pqr = pqr
                    prot.get_pdbqt(pdbqt + suffix)
                    os.replace(pdbqt + suffix, pdbqt)
                finally:
                    for leftover in (pqr + suffix, pdbqt + suffix):
                        if os.path.exists(leftover):
                            os.unlink(leftover)
        return pdbqt

    def run(self, mode: str = 'dock', exhaustiveness: int = 8):
        with tempfile.TemporaryDirectory(dir=self.tmp_dir) as td:
            lig_sdf = os.path.join(td, 'lig.sdf')
            _write_ligand_sdf(self.mol, lig_sdf)
            lig_pdbqt = os.path.join(td, 'lig.pdbqt')
            PrepLig(lig_sdf, 'sdf').get_pdbqt(lig_pdbqt)

            prot_pdbqt = self._receptor_pdbqt()

            dock = VinaDock(lig_pdbqt, prot_pdbqt)
            dock.pocket_center, dock.box_size = self.center, self.box_size
            score, pose = dock.run(mode=mode, exhaustiveness=exhaustiveness,
                                   save_pose=True)
            return [{'affinity': score, 'pose': pose}]


def parse_qvina_outputs(docked_sdf_path: str) -> List[dict]:
    """Parse the obabel-converted qvina2 output SDF: each pose carries a
    'REMARK' data field whose first line is 'VINA RESULT: <affinity>
    <rmsd_lb> <rmsd_ub>' (ref utils/evaluation/docking.py:24-39). Text-based
    so it works without RDKit; attaches rdmol objects when RDKit is present."""
    with open(docked_sdf_path) as f:
        text = f.read()
    results = []
    for i, block in enumerate(b for b in text.split('$$$$') if b.strip()):
        lines = block.splitlines()
        remark = None
        for li, line in enumerate(lines):
            if line.strip().startswith('>') and '<REMARK>' in line:
                remark = lines[li + 1].strip()
                break
        if remark is None:
            continue
        toks = remark.split()[2:]  # drop 'VINA RESULT:'
        results.append({
            'mode_id': i,
            'affinity': float(toks[0]),
            'rmsd_lb': float(toks[1]),
            'rmsd_ub': float(toks[2]),
        })
    try:
        from rdkit import Chem
        for r, mol in zip(results, Chem.SDMolSupplier(docked_sdf_path)):
            r['rdmol'] = mol
    except ImportError:
        pass
    return results


class QVinaDockingTask:
    """qvina2 subprocess pipeline (ref utils/evaluation/docking.py:56-183):
    prepare_receptor4 + obabel SDF->PDBQT + qvina2 + obabel back + REMARK
    parse. Runs the binaries from PATH directly (no conda-env indirection)."""

    REQUIRED_TOOLS = ('prepare_receptor4.py', 'obabel', 'qvina2')

    @classmethod
    def from_generated_mol(cls, mol, ligand_filename: str, protein_root: str,
                           **kwargs):
        protein_fn = os.path.join(
            os.path.dirname(ligand_filename),
            os.path.basename(ligand_filename)[:10] + '.pdb')
        return cls(mol, os.path.join(protein_root, protein_fn), **kwargs)

    def __init__(self, mol, protein_path: str, tmp_dir: Optional[str] = None,
                 use_uff: bool = True, center=None,
                 size_factor: Optional[float] = 1.0, buffer: float = 5.0):
        if protein_path is None:
            raise ValueError('protein_path is required for docking')
        self.mol = mol
        self.protein_path = protein_path
        self.tmp_dir = os.path.realpath(resolve_tmp_dir(tmp_dir))
        os.makedirs(self.tmp_dir, exist_ok=True)
        self.use_uff = use_uff
        self.task_id = get_random_id()
        self.receptor_id = self.task_id + '_receptor'
        self.ligand_id = self.task_id + '_ligand'
        self.center, (self.size_x, self.size_y, self.size_z) = compute_box(
            _mol_positions_with_hs(mol), center, size_factor, buffer)
        self.docked_sdf_path = os.path.join(
            self.tmp_dir, f'{self.ligand_id}_out.sdf')

    def check_tools(self):
        missing = [t for t in self.REQUIRED_TOOLS if not _have(t)]
        if missing:
            raise FileNotFoundError(
                f'qvina pipeline tools missing from PATH: {missing}')

    def _prepare_inputs(self):
        """Write receptor PDB copy + ligand SDF (UFF-minimized when RDKit is
        available, ref docking.py:87-93) into tmp_dir."""
        receptor_path = os.path.join(self.tmp_dir, self.receptor_id + '.pdb')
        with open(self.protein_path) as f:
            pdb_block = f.read()
        with open(receptor_path, 'w') as f:
            f.write(pdb_block)
        ligand_path = os.path.join(self.tmp_dir, self.ligand_id + '.sdf')
        rdmol = _write_ligand_sdf(self.mol, ligand_path)
        if self.use_uff and not hasattr(self.mol, 'bond_index'):
            try:
                from rdkit import Chem
                from rdkit.Chem.rdForceFieldHelpers import UFFOptimizeMolecule
                UFFOptimizeMolecule(rdmol)
                writer = Chem.SDWriter(ligand_path)
                writer.write(rdmol)
                writer.close()
            except Exception:
                pass

    def commands(self, exhaustiveness: int = 16) -> str:
        """The bash pipeline (ref docking.py:114-143, sans conda env)."""
        return f"""
cd {self.tmp_dir}
prepare_receptor4.py -r {self.receptor_id}.pdb
obabel {self.ligand_id}.sdf -O{self.ligand_id}.pdbqt
qvina2 \\
    --receptor {self.receptor_id}.pdbqt \\
    --ligand {self.ligand_id}.pdbqt \\
    --center_x {self.center[0]:.4f} \\
    --center_y {self.center[1]:.4f} \\
    --center_z {self.center[2]:.4f} \\
    --size_x {self.size_x} --size_y {self.size_y} --size_z {self.size_z} \\
    --exhaustiveness {exhaustiveness}
obabel {self.ligand_id}_out.pdbqt -O{self.ligand_id}_out.sdf -h
"""

    def run_sync(self, exhaustiveness: int = 16) -> List[dict]:
        self.check_tools()
        self._prepare_inputs()
        proc = subprocess.run(['/bin/bash'],
                              input=self.commands(exhaustiveness).encode(),
                              capture_output=True)
        self.output = proc.stdout
        self.error_output = proc.stderr
        results = parse_qvina_outputs(self.docked_sdf_path)
        if not results:
            raise RuntimeError(
                f'qvina produced no poses (stderr: '
                f'{self.error_output[-400:].decode(errors="replace")})')
        return results


def docking_available() -> dict:
    """What docking backends the current host can actually run."""
    out = {'vina': False, 'meeko': False, 'pdb2pqr': _have('pdb2pqr30'),
           'prepare_receptor4': _have('prepare_receptor4.py'),
           'obabel': _have('obabel'), 'qvina2': _have('qvina2')}
    try:
        import vina  # noqa: F401
        out['vina'] = True
    except Exception:
        pass
    try:
        import meeko  # noqa: F401
        out['meeko'] = True
    except Exception:
        pass
    return out
