"""The numbers that decide ``correct``, each held to a limit the cell
file states.

Training: the program's first three steps against the plain reference
fed the same rows from the same seeded weights.  Each number is a gap
of the program's reading from the reference's, as a share:

- ``loss_gap``: the largest of the three steps' loss gaps, over the
  reference's loss;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient (the program's as its optimizer took it), over the larger of
  that leaf's reference norm and the median leaf's;
- ``change_gap``: the same of each leaf's change after three updates,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (their moves are round-off under Adam);
- ``grad_gap_weights``, ``change_gap_weights``: the median gap over
  the products' weights (the kernels of convolutions and dense layers),
  for a model whose small leaves swing with rounding: ResNet's BN scales
  and biases (a cell holds the numbers its limits name).
"""

from __future__ import annotations

import math
import statistics

INF = float("inf")


def _gaps(prog, ref, keep=None):
    """Each kept leaf's gap, over the larger of its reference norm and
    the median kept leaf's; None where the program gave no reading."""
    if prog is None or len(prog) != len(ref):
        return None
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    out = []
    for i in idx:
        p, r = prog[i], ref[i]
        if p is None or not math.isfinite(p):
            return None
        out.append(abs(p - r) / max(r, med, 1e-30))
    return out


def train_numbers(prog, ref, weights, steps=3):
    """``{name: value}`` from ``prog`` and ``ref`` readings (``losses``,
    ``grad_norms``, ``change_norms``, leaves in the optimizer's order);
    ``weights[i]``: leaf i is a product's weight (a kernel of a
    convolution or a dense layer)."""
    losses = prog.get("losses") or []
    if len(losses) < steps or not all(map(math.isfinite, losses[:steps])):
        loss_gap = INF
    else:
        loss_gap = max(abs(a - b) / abs(b) for a, b in
                       zip(losses[:steps], ref["losses"][:steps]))
    med = statistics.median(ref["grad_norms"])
    keep = [g >= 1e-3 * med for g in ref["grad_norms"]]
    out = {"loss_gap": loss_gap}
    for name, key, mask in (("grad", "grad_norms", None),
                            ("change", "change_norms", keep)):
        gaps = _gaps(prog.get(key), ref[key], mask)
        out[f"{name}_gap"] = max(gaps) if gaps else INF
        gaps = _gaps(prog.get(key), ref[key], [
            w and (mask is None or mask[i]) for i, w in enumerate(weights)])
        out[f"{name}_gap_weights"] = (statistics.median(gaps) if gaps
                                      else INF)
    return out


def held(numbers, limits):
    """``{name: {"value", "limit"}}`` for every limit the cell states; a
    number the run could not read counts as far past any limit (1e300,
    which JSON can carry)."""
    return {k: {"value": min(float(numbers.get(k, INF)), 1e300),
                "limit": float(lim)} for k, lim in limits.items()}
