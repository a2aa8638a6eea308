from decompdiff_tpu_torch.preprocess.decompose import (
    find_exact_cover, is_terminal_fragment, assign_fragments,
    DecomposeError)
