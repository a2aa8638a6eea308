"""First-party py3Dmol-compatible 3D viewer (standalone-HTML backend;
a copy of decompdiff_tpu/utils/viewer3d.py).

The reference's notebook visualizations (ref utils/visualize.py:18-412) are
written against py3Dmol, which is itself only a thin recorder that replays
viewer calls as 3Dmol.js JavaScript inside an HTML div. py3Dmol is absent
from this image, so this module supplies the same recorder surface —
`view(width=, height=)` returning an object with `addModel`,
`addModelsAsFrames`, `setStyle`, `addSurface`, `addSphere`, `zoomTo`,
`animate`, plus the `VDW`/`SAS` surface constants — and renders to a
self-contained HTML document that loads 3Dmol.js from its public CDN.

utils/visualize.py prefers real py3Dmol when installed (notebook-embedded
WebGL widgets); this backend makes every viewer function executable
in-image, returning views whose `.write_html(path)` / `._repr_html_()`
output opens in any browser. Viewing needs network access for the CDN
script — the HTML itself is self-contained otherwise.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

_CDN = 'https://cdnjs.cloudflare.com/ajax/libs/3Dmol/2.0.4/3Dmol-min.js'

# py3Dmol module-level surface-type constants (py3Dmol maps these to
# $3Dmol.SurfaceType members)
VDW = 'VDW'
SAS = 'SAS'
SES = 'SES'
MS = 'MS'


def _js_template_literal(data: str) -> str:
    """Embed raw model data as a JS template literal, escaping the three
    characters that are active inside backticks."""
    return '`' + (data.replace('\\', '\\\\').replace('`', '\\`')
                  .replace('${', '\\${')) + '`'


def _normalize_format(fmt: str) -> str:
    """The reference passes synthetic format names like 'mol0', 'mol1' for
    multi-conformer molblocks (ref utils/visualize.py:304-337); 3Dmol.js
    wants 'sdf' for molblock data."""
    return 'sdf' if fmt.startswith('mol') else fmt


class View:
    """Recorded-call 3D viewer; py3Dmol.view drop-in for the calls the
    visualization layer makes."""

    def __init__(self, width: int = 640, height: int = 480):
        self.width = int(width)
        self.height = int(height)
        self._cmds: List[str] = []

    # ------------------------------------------------------------- recording
    def _emit(self, call: str):
        self._cmds.append(f'viewer.{call};')
        return self

    def addModel(self, data: str, fmt: str = 'xyz', options: Optional[dict] = None):
        args = [_js_template_literal(data),
                json.dumps(_normalize_format(fmt))]
        if options:
            args.append(json.dumps(options))
        return self._emit(f'addModel({", ".join(args)})')

    def addModelsAsFrames(self, data: str, fmt: str = 'xyz'):
        return self._emit(
            f'addModelsAsFrames({_js_template_literal(data)}, '
            f'{json.dumps(_normalize_format(fmt))})')

    def setStyle(self, sel_or_style: dict, style: Optional[dict] = None):
        if style is None:
            return self._emit(f'setStyle({json.dumps(sel_or_style)})')
        return self._emit(
            f'setStyle({json.dumps(sel_or_style)}, {json.dumps(style)})')

    def addSurface(self, surf_type: str, params: dict,
                   sel: Optional[dict] = None):
        args = [f'$3Dmol.SurfaceType.{surf_type}', json.dumps(params)]
        if sel is not None:
            args.append(json.dumps(sel))
        return self._emit(f'addSurface({", ".join(args)})')

    def addSphere(self, params: dict):
        return self._emit(f'addSphere({json.dumps(params)})')

    def zoomTo(self, sel: Optional[dict] = None):
        return self._emit(
            f'zoomTo({json.dumps(sel)})' if sel is not None else 'zoomTo()')

    def animate(self, params: dict):
        return self._emit(f'animate({json.dumps(params)})')

    def render(self):
        return self._emit('render()')

    # ------------------------------------------------------------- rendering
    def _make_html(self) -> str:
        body = '\n      '.join(self._cmds)
        return f"""<!DOCTYPE html>
<html>
<head>
  <meta charset="utf-8"/>
  <script src="{_CDN}"></script>
  <style>.mol-container {{ width: {self.width}px; height: {self.height}px;
                           position: relative; }}</style>
</head>
<body>
  <div id="viewer" class="mol-container"></div>
  <script>
    window.addEventListener('load', function () {{
      let viewer = $3Dmol.createViewer(
          document.getElementById('viewer'),
          {{backgroundColor: 'white'}});
      {body}
      viewer.render();
    }});
  </script>
</body>
</html>
"""

    def _repr_html_(self) -> str:
        return self._make_html()

    def write_html(self, path: str) -> str:
        html = self._make_html()
        with open(path, 'w') as f:
            f.write(html)
        return path

    def show(self):  # notebook-API parity; returns the HTML for display
        return self._make_html()


def view(width: int = 640, height: int = 480, size: Optional[Tuple[int, int]] = None,
         **_ignored) -> View:
    """py3Dmol.view(...) drop-in."""
    if size is not None:
        width, height = size
    return View(width=width, height=height)
