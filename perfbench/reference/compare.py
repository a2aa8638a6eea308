"""The numbers that decide `correct`, and their judgement against the
limits of a cell (limits/<workload>.json: {number: limit}).

Sampling (for each checked step, the worst over them):
  step_err  the widest gap between the program's and the reference's
            outputs of the step over real atoms and bonds, as a share of
            the largest reference value of that output: the denoiser's
            coordinates, atom-type and bond-type logits, x_{t-1} (the
            posterior mean, the guidance gradient and the noise), and the
            sampled atom and bond types, whose gap is v_gap / b_gap over
            the largest reference Gumbel score;
  v_gap     (printed, in step_err) the widest gap by which the Gumbel score
            of the atom type the program sampled lies below the
            reference's best: 0 where they agree, a near tie that rounding
            flips reads about the rounding, an altered type about 1;
  b_gap     the same for the bond types;
  ties      the molecules left out: their kNN graph's last edge is a tie
            to within TIE of its squared distance, which rounding decides
            (at most the limit; a collapsed state ties every molecule).
Training (the first three steps, and w*: one window step from the
program's state before it):
  batch_err the elements of the program's collated batches that differ
            from the reference's collation of the same raw records (exact);
  loss1_gap the relative gap of the first step's loss;
  loss_gap  the widest relative gap of the three steps' losses;
  grad_gap  the worst leaf's gap between the norms of the first gradient
            as the optimizer got it (the program's from Adam's first moment
            after one step) against the reference's norm of that leaf or of
            the median leaf, whichever is larger;
  grad_med  the same gap of the median leaf;
  step_gap  the worst leaf's gap for the parameters' change over the three
            steps, leaving out the leaves whose reference gradient is under
            a thousandth of the median leaf's (they move by round-off
            alone);
  step_med  the same gap of the median leaf;
  wloss_gap, wgrad_gap, wgrad_med, wstep_gap, wstep_med
            the same for the window step: its loss, the clipped gradients as
            Adam got them, and the parameters' change in that step.
"""

from __future__ import annotations

import statistics

import torch


def _rel(a, b, mask):
    d = (a - b).abs()[mask]
    scale = b.abs()[mask].max().clamp(min=1e-30)
    return float(d.max() / scale) if d.numel() else 0.0


def _gap(scores, chosen, mask):
    """max over masked entries of best score - score of the chosen class."""
    best = scores.max(-1).values
    got = torch.gather(scores, -1, chosen.long()[..., None])[..., 0]
    g = (best - got)[mask]
    return float(g.max()) if g.numel() else 0.0


# a molecule whose kNN graph has a tie at its last edge within this share
# of the squared distance (nets.knn_margin) is left out of the comparison
TIE = 1e-5


def sampling_numbers(prog: dict, ref: dict, lig_mask, bond_mask) -> dict:
    """prog: the program's preds and next state (x, v, b); ref: the
    reference step (reference/steps.py sample_step). Molecules whose kNN
    graph ties at its last edge (ref['knn_margin'] under TIE) are left
    out and counted in `ties`."""
    keep = ref['knn_margin'] >= TIE
    lig_mask = lig_mask & keep[:, None]
    bond_mask = bond_mask & keep[:, None, None]
    errs = [_rel(prog[k], ref[r], lig_mask[..., None].expand_as(ref[r]))
            for k, r in (('pred_ligand_pos', 'pred_ligand_pos'),
                         ('pred_ligand_v', 'pred_ligand_v'),
                         ('x', 'x_next'))]
    out = {'ties': int((~keep).sum()),
           'v_gap': _gap(ref['v_scores'], prog['v'], lig_mask)}
    errs.append(out['v_gap'] / _scale(ref['v_scores'], lig_mask))
    if 'pred_bond' in ref:
        errs.append(_rel(prog['pred_bond'], ref['pred_bond'],
                         bond_mask[..., None].expand_as(ref['pred_bond'])))
        out['b_gap'] = _gap(ref['b_scores'], prog['b'], bond_mask)
        errs.append(out['b_gap'] / _scale(ref['b_scores'], bond_mask))
    out['step_err'] = max(errs)
    return out


def _scale(scores, mask):
    return float(scores.abs()[mask].max().clamp(min=1e-30))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> tuple:
    """(worst, median) over leaves of |‖p‖ - ‖r‖| / max(‖r‖, median leaf
    ‖r‖)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].norm()) for k in names}
    med = statistics.median(rn.values())
    gaps = [abs(float(prog[k].norm()) - rn[k]) / max(rn[k], med, 1e-30)
            for k in names]
    return max(gaps), statistics.median(gaps)


def moving_leaves(grad_ref: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    norms = {k: float(g.norm()) for k, g in grad_ref.items()}
    med = statistics.median(norms.values())
    return {k for k, n in norms.items() if n >= 1e-3 * med}


def training_numbers(batch_err: int, losses_prog, losses_ref, grad_prog,
                     grad_ref, delta_prog, delta_ref, window) -> dict:
    """`window`: (loss, reference loss, clipped gradients, reference's,
    parameter change, reference's) of the checked window step."""
    keep = moving_leaves(grad_ref)
    loss = [abs(p - r) / abs(r) for p, r in zip(losses_prog, losses_ref)]
    grad = leaf_gaps(grad_prog, grad_ref)
    step = leaf_gaps(delta_prog, delta_ref, keep)
    wl_p, wl_r, wg_p, wg_r, wd_p, wd_r = window
    wgrad = leaf_gaps(wg_p, wg_r)
    wstep = leaf_gaps(wd_p, wd_r, moving_leaves(wg_r))
    return {'batch_err': batch_err, 'loss1_gap': loss[0],
            'loss_gap': max(loss), 'grad_gap': grad[0], 'grad_med': grad[1],
            'step_gap': step[0], 'step_med': step[1],
            'wloss_gap': abs(wl_p - wl_r) / abs(wl_r),
            'wgrad_gap': wgrad[0], 'wgrad_med': wgrad[1],
            'wstep_gap': wstep[0], 'wstep_med': wstep[1],
            'leaves_left_out': len(grad_ref) - len(keep)}


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every limited number must be
    finite and at most its limit; a number without a limit is printed
    only."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name)
        rows.append((name, value, limit))
        if limit is not None and not (value == value and value <= limit):
            ok = False
    missing = [k for k in limits if k not in numbers]
    if missing:
        ok = False
        rows += [(k, None, limits[k]) for k in missing]
    return ok, rows
