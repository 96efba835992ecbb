"""Inception Distillation (paper §3.2), the GNN half of the port of
`repro.core.inception_distill`.

Primitives implement Eqs. (2)-(6) of the paper:
  * soft-CE knowledge distillation at temperature T        (Eq. 3)
  * offline loss  (1-λ)·CE + λ·T²·KD(student, teacher)     (Eq. 4)
  * self-attention ensemble teacher over the top-r exits   (Eq. 5)
  * online loss   (1-λ)·CE + λ·T²·KD(student, ensemble)    (Eq. 6)

Used by `repro_torch.gnn.distill` (one classifier per propagation order)
and by `repro_torch.models.decoder_lm.loss_fn` (the early-exit heads of
the LM, `transformer_inception_loss`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def soft_ce(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float) -> torch.Tensor:
    """KD loss: CE(softmax(t/T), log softmax(s/T)); mean over rows. (Eq. 3)"""
    t = torch.softmax(teacher_logits.float() / temperature, dim=-1)
    ls = torch.log_softmax(student_logits.float() / temperature, dim=-1)
    return -torch.mean(torch.sum(t * ls, dim=-1))


def hard_ce(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy against integer labels; with `mask`, the mean over
    the rows it marks (at least one row's weight in the denominator)."""
    lf = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.take_along_dim(lf, labels.long()[..., None], dim=-1)[..., 0]
    if mask is None:
        return -torch.mean(ll)
    m = mask.float()
    return -torch.sum(ll * m) / torch.clamp(torch.sum(m), min=1.0)


def offline_loss(student_logits, teacher_logits, labels, *, temperature,
                 lam, label_mask=None) -> torch.Tensor:
    """(Eq. 4). The teacher is detached (pure offline distillation)."""
    kd = soft_ce(student_logits, teacher_logits.detach(), temperature)
    ce = hard_ce(student_logits, labels, label_mask)
    return (1.0 - lam) * ce + lam * temperature ** 2 * kd


def ensemble_teacher(exit_logits: Sequence[torch.Tensor],
                     s: torch.Tensor) -> torch.Tensor:
    """Self-attention ensemble over exit predictions (Eq. 5).

    exit_logits: list of (N, C) logits (the top-r classifiers).
    s: (C, 1) learned projection.
    Returns ensemble logits z̄ (N, C), to be temperature-softmaxed by Eq. 6.
    """
    probs = [torch.softmax(z.float(), dim=-1) for z in exit_logits]
    scores = [torch.relu(p @ s.float())[..., 0] for p in probs]
    w = torch.softmax(torch.stack(scores, dim=-1), dim=-1)      # (N, r)
    stacked = torch.stack(probs, dim=-1)                        # (N, C, r)
    mix = torch.einsum("ncr,nr->nc", stacked, w)
    return torch.log(mix + 1e-9)                        # back to logit space


def online_loss(student_logits, ens_logits, labels, *, temperature, lam,
                label_mask=None) -> torch.Tensor:
    """(Eq. 6). The ensemble teacher is NOT detached: teacher and students
    update together, per the paper."""
    kd = soft_ce(student_logits, ens_logits, temperature)
    ce = hard_ce(student_logits, labels, label_mask)
    return (1.0 - lam) * ce + lam * temperature ** 2 * kd


# ------------------------------------------------------- transformer flavor
def transformer_inception_loss(cfg, params, states, final_logits, labels):
    """Inception Distillation of the LM's early-exit heads.

    states: the R per-block hidden states (B, S, d) of `forward(...,
    collect_states=True)`; final_logits (B, S, V) the trunk's output;
    labels (B, S-1). Each exit head (on its block's state, all positions
    but the last) takes the offline loss against the detached trunk
    logits and the online loss against the ensemble of the last
    `ensemble_r` of (exits + trunk), which is not detached; the sum is
    divided by the number of exits. On a placed model the states are
    placed (`forward(..., collect_states=True)` on a mesh): each exit
    head runs on its block's placed state and its logits, and the
    ensemble vector, are gathered, so that the loss is taken on global
    tensors as the trunk's is. Returns (loss, {"inception_loss"})."""
    from repro_torch.models.decoder_lm import exit_logits as head
    from repro_torch.sharding import placement as pl

    ad = cfg.adaptive
    exits = []
    for i, blk in enumerate(ad.exit_layers):
        z = pl.as_global(head(cfg, params, pl.per_position(
            lambda s: s[:, :-1], states[blk]), i))
        exits.append(z.reshape(-1, z.shape[-1]))
    teacher = final_logits[:, :-1].reshape(-1, final_logits.shape[-1])
    flat_labels = labels.reshape(-1)

    total = torch.zeros((), dtype=torch.float32, device=teacher.device)
    for z in exits:
        total = total + offline_loss(z, teacher, flat_labels,
                                     temperature=ad.temperature, lam=ad.lam)
    # online: the ensemble over the top-r heads (the deepest exits and
    # the trunk)
    pool = (exits + [teacher])[-max(ad.ensemble_r, 1):]
    ens = ensemble_teacher(pool, pl.as_global(params["exits"]["ens_s"]))
    for z in exits:
        total = total + online_loss(z, ens, flat_labels,
                                    temperature=ad.temperature, lam=ad.lam)
    total = total / max(len(exits), 1)
    return total, {"inception_loss": total}
