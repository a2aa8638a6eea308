"""Atom-type distribution JSD vs the CrossDocked marginal
(parity: ref utils/evaluation/eval_atom_type.py:19-39).

Port of decompdiff_tpu/evaluation/eval_atom_type.py,
the same numpy in the same order.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
from scipy.spatial import distance as sci_distance

# CrossDocked2020 training-set atom-type marginal (data constants; ref :19-27)
ATOM_TYPE_DISTRIBUTION = {
    6: 0.6715020339893559,
    7: 0.11703509510732567,
    8: 0.16956379168491933,
    9: 0.01307879304486639,
    15: 0.01113716146426898,
    16: 0.01123926340861198,
    17: 0.006443861300651673,
}


def eval_atom_type_distribution(pred_counter: Counter) -> float:
    total = sum(pred_counter.values())
    pred = np.array([pred_counter.get(k, 0) / max(total, 1)
                     for k in ATOM_TYPE_DISTRIBUTION])
    ref = np.array(list(ATOM_TYPE_DISTRIBUTION.values()))
    return float(sci_distance.jensenshannon(ref, pred))
