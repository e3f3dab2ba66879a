"""The comparison that decides `correct`.

Served tokens (`judge_served`): the reference runs once over each judged
request's prompt and served tokens (all but the last), and each served
token's gap is how far the reference's logit of it lies below the
reference's best logit at that position; `decode_gap` is the widest gap
and `decode_gap_mean` the mean.
The control (`control=True`) puts the reference in the program's place at
the next precision down (float8 e4m3 products, `reference.fp8_mm`) and
reads, at each of the same positions, the gap of the token it puts first.

Finetune steps (`judge_training`): the reference follows the job's first
three AdamW steps (the window's first three iterations, from the job's
seed state) from the same adapters on the same rows. Compared:
each step's loss (`loss_rel`, the largest relative gap), the first
gradient as the optimizer got it (the program's from its first moment
after one step, m / (1 - b1)), and the adapters' change after the three
steps, each by the worst leaf (one layer's A or B): the gap between the
two norms over the larger of the reference's norm of that leaf and the
median leaf's (`grad_gap`, `change_gap`). Leaves whose reference gradient
stays under a thousandth of the median leaf's at every step are left out
of the change (round-off alone moves them under Adam).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import model as R

LEAF_FLOOR = 1e-3


def _gaps(weights: R.Weights, h: torch.Tensor, want: torch.Tensor
          ) -> torch.Tensor:
    """Per row of h: the reference's best logit minus its logit of the
    row's token in `want`."""
    out = []
    for r0, logits in R.logits_rows(weights, h):
        w = want[r0:r0 + logits.shape[0]]
        out.append(logits.amax(-1) - logits.gather(-1, w[:, None])[:, 0])
    return torch.cat(out)


def judge_served(weights: R.Weights, arch: R.Arch,
                 requests: List[tuple], decode_group: int, device,
                 control: bool = False) -> Dict[str, float]:
    """requests: (prompt token ids, served token ids). Returns the widest
    gap (`decode_gap`) and the mean gap over every judged token
    (`decode_gap_mean`), the tokens judged, and with `control` the
    control's and those of every served token altered to the next id (a
    fault where tokens are produced)."""
    R.exact_matmul()
    seqs, plens, wants = [], [], []
    for prompt, served in requests:
        ids = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(served[:-1], np.int64)])
        seqs.append(torch.as_tensor(ids, device=device))
        plens.append(len(prompt))
        wants.append(torch.as_tensor(np.asarray(served, np.int64),
                                     device=device))
    hs = R.served_hidden(weights, arch, seqs, plens, decode_group)
    out = {"tokens": float(sum(len(s) for _, s in requests))}

    def judged(wanted):
        return [_gaps(weights, h[P - 1:], w)
                for h, P, w in zip(hs, plens, wanted)]

    gaps = judged(wants)
    out["per_request"] = [float(g.max()) for g in gaps]
    out["decode_gap"] = max(out["per_request"])
    out["decode_gap_mean"] = float(torch.cat(gaps).mean())
    if control:
        hc = R.served_hidden(weights, arch, seqs, plens, decode_group,
                             R.fp8_mm)
        picks = [torch.cat([lg.argmax(-1) for _, lg in R.logits_rows(
            weights, h[P - 1:], R.fp8_mm)]) for h, P in zip(hc, plens)]
        del hc
        for tag, wanted in (("control", picks),
                            ("altered", [(w + 1) % arch.vocab
                                         for w in wants])):
            g = judged(wanted)
            out[f"{tag}_decode_gap"] = max(float(x.max()) for x in g)
            out[f"{tag}_decode_gap_mean"] = float(torch.cat(g).mean())
    return out


def norm_gap(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
             keep: Optional[Dict[str, np.ndarray]] = None) -> float:
    """The worst leaf's |prog - ref| / max(ref, median ref), over the
    leaves `keep` marks (all by default)."""
    med = float(np.median(np.concatenate(list(ref.values()))))
    worst = 0.0
    for name, r in ref.items():
        p = np.asarray(prog[name], np.float64)
        gap = np.abs(p - r) / np.maximum(r, med)
        if keep is not None:
            gap = gap[keep[name]]
        if gap.size:
            worst = max(worst, float(gap.max()))
    return worst


def _kept(grads: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    peak = {n: np.max([g[n] for g in grads], axis=0) for n in grads[0]}
    med = float(np.median(np.concatenate(list(peak.values()))))
    return {n: v >= LEAF_FLOOR * med for n, v in peak.items()}


def _numbers(prog, ref) -> Dict[str, float]:
    losses, grads, change = ref
    kept = _kept(grads)
    return {
        "loss_rel": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                            losses)),
        "grad_gap": norm_gap(prog["grad"], grads[0]),
        "change_gap": norm_gap(prog["change"], change, kept),
        "change_leaves_out": float(sum((~k).sum() for k in kept.values())),
    }


def _np(tree):
    return {k: v.cpu().numpy() for k, v in tree.items()}


def judge_training(weights: R.Weights, arch: R.Arch, adapters0: Dict,
                   rows: Dict, opt: R.AdamW, prog: Dict,
                   control: bool = False) -> Dict[str, float]:
    """prog: the program's {"losses": [3 floats], "grad": leaf norms,
    "change": leaf norms}. rows: torch tensors (steps, B, S)."""
    steps = len(prog["losses"])

    def run(**kw):
        losses, grads, change = R.train_steps(weights, arch, adapters0, rows,
                                              opt, steps, **kw)
        return losses, [_np(g) for g in grads], _np(change)

    ref = run()
    out = _numbers(prog, ref)
    if control:
        for tag, kw in (("control", {"mm": R.fp8_mm}),
                        ("half_batch", {"rows_used": 1})):
            other = run(**kw)
            as_prog = {"losses": other[0], "grad": other[1][0],
                       "change": other[2]}
            for k, v in _numbers(as_prog, ref).items():
                out[f"{tag}_{k}"] = v
        out["unchanged_change_gap"] = norm_gap(
            {k: np.zeros_like(v) for k, v in ref[2].items()}, ref[2],
            _kept(ref[1]))
    return out
