from decompdiff_tpu_torch.priors.golden import (
    compute_golden_prior, get_iso_aniso_mu_cov)
from decompdiff_tpu_torch.priors.beta import (
    substitute_with_beta_prior, substitute_with_given_prior,
    apply_std_coef, apply_num_atoms_change)
