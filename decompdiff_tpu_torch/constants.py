"""The constants the sampling path needs (a copy of the matching entries of
decompdiff_tpu/constants.py)."""

import numpy as np

# elements one-hot over {H, C, N, O, S, Se} + 20 amino acids + backbone flag
# (ref utils/transforms.py:118)
PROTEIN_FEATURE_DIM = 6 + 20 + 1  # 27

# CrossDocked training-set marginals used as terminal distributions when
# `prior_types` featurization is enabled (ref utils/transforms.py:142-143).
ATOM_TYPES_PROB_BASIC = np.array(
    [0.0, 0.6716, 0.1174, 0.1689, 0.01315, 0.01117, 0.01128, 0.00647])
BOND_TYPES_PROB = np.array([0.9170, 0.0433, 0.00687, 0.000173, 0.03266])
