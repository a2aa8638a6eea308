"""First-party 2D molecule depiction (SVG) — the RDKit-free grid raster
(port of decompdiff_tpu/utils/draw2d.py, imports rewritten).

The reference's notebook visualizers use RDKit's ``Draw.MolsToGridImage``
(ref utils/visualize.py:102-112, :348-358). RDKit is absent from this
image, so this module renders MolRecords directly:

  * layout: PCA projection of the record's 3D coordinates onto their best
    plane (every MolRecord in this framework carries 3D positions), then a
    short 2D spring refinement — bond springs toward unit length plus
    non-bonded repulsion — so depictions stay readable when the 3D pose is
    elongated or self-overlapping after projection;
  * rendering: Daylight-style SVG — carbon skeleton lines, labeled colored
    heteroatoms with white halos, parallel lines for double/triple bonds,
    a dashed inner ring chord for aromatic bonds, optional atom highlights;
  * compositing: ``mols_to_grid_svg`` tiles cells with legends like
    MolsToGridImage. The returned ``SVGImage`` mimics the notebook surface
    (``_repr_svg_``) and adds ``save(path)``.

The output is a structural-communication raster, not an RDKit-pixel
replica — layout is coordinate-derived rather than template-derived by
construction.
"""

from __future__ import annotations

import html
from typing import List, Optional, Sequence, Tuple

import numpy as np

# CPK-ish label colors (same palette family as utils/visualize.py 3D)
_ATOM_COLOR = {
    1: '#7f7f7f', 6: '#1a1a1a', 7: '#2b4bd7', 8: '#d7301f', 9: '#3cb44b',
    15: '#ff8c00', 16: '#b8a000', 17: '#3cb44b', 35: '#a52a2a',
    53: '#7d00a0', 14: '#808090', 5: '#ffb5b5',
}
_SYMBOL = {
    1: 'H', 5: 'B', 6: 'C', 7: 'N', 8: 'O', 9: 'F', 14: 'Si', 15: 'P',
    16: 'S', 17: 'Cl', 33: 'As', 34: 'Se', 35: 'Br', 53: 'I',
}


def _undirected(record):
    from decompdiff_tpu_torch.reconstruct.builder import _undirected_bonds
    return _undirected_bonds(record.bond_index, record.bond_type)


def layout_2d(record, refine_steps: int = 120) -> np.ndarray:
    """[N, 2] depiction coordinates with median bond length ~1.

    PCA-projects the stored conformer onto its dominant plane, then relaxes
    with bond springs (rest length 1) and short-range non-bonded repulsion.
    """
    pos = np.asarray(record.pos, float)
    n = len(pos)
    if n == 1:
        return np.zeros((1, 2))
    centered = pos - pos.mean(0)
    # PCA: top-2 principal axes of the conformer
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    xy = centered @ vt[:2].T
    bonds = list(_undirected(record).keys())
    if bonds:
        d = np.linalg.norm(xy[[a for a, _ in bonds]]
                           - xy[[b for _, b in bonds]], axis=1)
        med = np.median(d)
        if med > 1e-6:
            xy = xy / med
        else:  # degenerate projection (linear molecule along axis 3)
            rng = np.random.default_rng(0)
            xy = xy + 0.1 * rng.standard_normal(xy.shape)
    bonded = set(bonds)
    for _ in range(refine_steps):
        force = np.zeros_like(xy)
        for a, b in bonds:
            delta = xy[b] - xy[a]
            dist = max(np.linalg.norm(delta), 1e-6)
            f = 0.2 * (dist - 1.0) * delta / dist
            force[a] += f
            force[b] -= f
        # short-range repulsion between non-bonded pairs
        diff = xy[:, None] - xy[None]
        dist = np.linalg.norm(diff, axis=-1) + 1e-9
        close = (dist < 0.9) & ~np.eye(n, dtype=bool)
        for a, b in np.argwhere(close):
            if (min(a, b), max(a, b)) in bonded:
                continue
            push = 0.1 * (0.9 - dist[a, b]) * diff[a, b] / dist[a, b]
            force[a] += push
        xy = xy + force
    return xy - xy.mean(0)


def _ring_interiors(record, xy):
    """Centroid per ring (for aromatic inner-chord orientation)."""
    from decompdiff_tpu_torch.reconstruct.ligan import find_rings
    bonds = _undirected(record)
    rings = find_rings(record.num_atoms, {b: 1 for b in bonds}, max_size=24)
    return [(set(r), xy[list(r)].mean(0)) for r in rings]


def mol_to_svg_cell(record, xy=None, size: Tuple[int, int] = (250, 200),
                    highlight_atoms: Optional[Sequence[int]] = None,
                    legend: str = '') -> str:
    """Inner SVG group for one molecule, scaled into `size` pixels."""
    w, h = size
    if xy is None:
        xy = layout_2d(record)
    element = np.asarray(record.element)
    pad = 22
    scale = min((w - 2 * pad) / (np.ptp(xy[:, 0]) + 1e-6),
                (h - 2 * pad - (14 if legend else 0))
                / (np.ptp(xy[:, 1]) + 1e-6), 38.0)
    pts = (xy - xy.min(0)) * scale
    pts[:, 0] += (w - pts[:, 0].max()) / 2
    pts[:, 1] += (h - (14 if legend else 0) - pts[:, 1].max()) / 2

    bonds = _undirected(record)
    rings = _ring_interiors(record, pts)
    parts = []
    if highlight_atoms:
        for i in highlight_atoms:
            parts.append(
                f'<circle cx="{pts[i, 0]:.1f}" cy="{pts[i, 1]:.1f}" '
                f'r="{0.38 * scale:.1f}" fill="#ffd54d" opacity="0.7"/>')

    def line(p, q, off=0.0, dash=False):
        d = q - p
        nrm = np.array([-d[1], d[0]])
        nn = np.linalg.norm(nrm)
        nrm = nrm / nn if nn > 1e-6 else nrm
        a, b = p + nrm * off, q + nrm * off
        dash_attr = ' stroke-dasharray="4,3"' if dash else ''
        return (f'<line x1="{a[0]:.1f}" y1="{a[1]:.1f}" x2="{b[0]:.1f}" '
                f'y2="{b[1]:.1f}" stroke="#1a1a1a" stroke-width="1.6"'
                f'{dash_attr}/>')

    for (a, b), order in bonds.items():
        p, q = pts[a], pts[b]
        if order == 2:
            parts += [line(p, q, 0.09 * scale), line(p, q, -0.09 * scale)]
        elif order == 3:
            parts += [line(p, q), line(p, q, 0.14 * scale),
                      line(p, q, -0.14 * scale)]
        elif order == 4:
            parts.append(line(p, q))
            # dashed chord offset toward the ring interior
            side = 0.13 * scale
            for atoms, centroid in rings:
                if a in atoms and b in atoms:
                    mid = (p + q) / 2
                    d = q - p
                    nrm = np.array([-d[1], d[0]])
                    nn = np.linalg.norm(nrm)
                    if nn > 1e-6 and np.dot(nrm / nn, centroid - mid) < 0:
                        side = -side
                    break
            parts.append(line(p, q, side, dash=True))
        else:
            parts.append(line(p, q))

    for i in range(len(element)):
        z = int(element[i])
        if z == 6:
            continue
        sym = _SYMBOL.get(z, str(z))
        color = _ATOM_COLOR.get(z, '#555555')
        x, y = pts[i]
        parts.append(
            f'<rect x="{x - 7:.1f}" y="{y - 8:.1f}" width="14" height="15" '
            f'fill="white"/>'
            f'<text x="{x:.1f}" y="{y + 4:.1f}" text-anchor="middle" '
            f'font-family="Helvetica" font-size="13" '
            f'fill="{color}">{html.escape(sym)}</text>')
    if legend:
        parts.append(
            f'<text x="{w / 2:.1f}" y="{h - 4:.1f}" text-anchor="middle" '
            f'font-family="Helvetica" font-size="11" fill="#333">'
            f'{html.escape(legend)}</text>')
    return ''.join(parts)


class SVGImage:
    """Notebook-displayable SVG with a save() convenience."""

    def __init__(self, svg: str):
        self.svg = svg

    def _repr_svg_(self):
        return self.svg

    def save(self, path: str):
        with open(path, 'w') as f:
            f.write(self.svg)
        return path


def mols_to_grid_svg(mols: List, legends: Optional[List[str]] = None,
                     mols_per_row: int = 4,
                     sub_img_size: Tuple[int, int] = (250, 200),
                     highlight_atom_lists=None) -> SVGImage:
    """MolsToGridImage-shaped grid over MolRecords (SVG instead of PNG)."""
    mols = list(mols)
    if not mols:
        return SVGImage('<svg xmlns="http://www.w3.org/2000/svg"/>')
    # pad short option lists instead of IndexError-ing on the later cells
    # (RDKit's MolsToGridImage validates lengths up front)
    if legends is not None and len(legends) < len(mols):
        legends = list(legends) + [''] * (len(mols) - len(legends))
    if highlight_atom_lists is not None and \
            len(highlight_atom_lists) < len(mols):
        highlight_atom_lists = (list(highlight_atom_lists)
                                + [None] * (len(mols)
                                            - len(highlight_atom_lists)))
    w, h = sub_img_size
    cols = max(1, min(mols_per_row, len(mols)))
    rows = (len(mols) + cols - 1) // cols
    cells = []
    for k, m in enumerate(mols):
        r, c = divmod(k, cols)
        legend = legends[k] if legends else ''
        hl = highlight_atom_lists[k] if highlight_atom_lists else None
        inner = mol_to_svg_cell(m, size=sub_img_size, legend=legend,
                                highlight_atoms=hl)
        cells.append(f'<g transform="translate({c * w},{r * h})">'
                     f'<rect width="{w}" height="{h}" fill="white"/>'
                     f'{inner}</g>')
    svg = (f'<svg xmlns="http://www.w3.org/2000/svg" '
           f'width="{cols * w}" height="{rows * h}">' + ''.join(cells)
           + '</svg>')
    return SVGImage(svg)
