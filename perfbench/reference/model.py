"""The plain float32 reference of the benchmark's models.

Plain PyTorch, written from the published architectures: a pre-norm
decoder with RMSNorm, rotary embeddings (half-split rotation), grouped
query attention, and a SwiGLU MLP or a Mixtral-style top-k
Mixture-of-Experts FFN; LoRA deltas `s * (x @ A) @ B` on the adapted
projections. It imports nothing of the program and nothing of JAX.

The one rule taken from the program, frozen here as a copy, is the MoE
capacity and drop rule (`moe_capacity`, `rank_in_expert`): each group of
tokens gives every expert C slots, and an assignment ranked C or later
within its expert, in token-major choice order, is dropped (its weight is
0, the others keep their renormalised top-k weights). A served prompt is
one group (its prefill), a decode round's batch of slots is another
(where C covers every slot, so nothing drops), and a training row is one
group.

Every product runs in float32 with TF32 off (`exact_matmul`). `mm(x, w)`
is the one place a base weight meets an activation: the control passes
`fp8_mm`, which rounds both operands to float8 e4m3 first.

Weights come as `Weights`: the benchmark's own tensors (made from the
seed by `perfbench/harness/weights.py`), read one layer at a time and
widened to float32 on use.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def exact_matmul() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def plain_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8 e4m3 with one absmax scale per slice along
    `dim` reduced (448 is e4m3's largest finite value)."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's product: activations rounded per row, weights per
    output column, to float8 e4m3; gradients pass straight through."""
    xq = x + (fp8(x, -1) - x).detach()
    wq = w + (fp8(w, -2) - w).detach()
    return xq @ wq


@dataclasses.dataclass(frozen=True)
class Arch:
    """The sizes the reference needs, read from a configuration file."""
    d: int
    n_layers: int
    n_heads: int
    n_kv: int
    head_dim: int
    ff: int
    vocab: int
    rope_theta: float
    eps: float
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_ff: int = 0
    capacity_factor: float = 1.25
    window: int = 0
    lora_rank: int = 0
    lora_alpha: float = 0.0
    lora_targets: Tuple[str, ...] = ()

    @property
    def lora_scale(self) -> float:
        return self.lora_alpha / self.lora_rank if self.lora_rank else 0.0


class Weights:
    """Read access to one model's weights: `embed`, `unembed` (V, d),
    `final_norm` (d,), and per layer i `layer(i)`: ln1, ln2, wq, wk, wv,
    wo and gate, up, down (dense) or router (d, E), gate, up (E, d, ff),
    down (E, ff, d) (MoE), each widened to float32."""

    def __init__(self, tree: Dict):
        self.tree = tree

    @property
    def embed(self) -> torch.Tensor:
        return self.tree["embed"]

    @property
    def unembed(self) -> torch.Tensor:
        return self.tree["unembed"]

    @property
    def final_norm(self) -> torch.Tensor:
        return self.tree["final_norm"].float()

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        s = self.tree["scan"]
        out = {"ln1": s["ln1"][i], "ln2": s["ln2"][i],
               **{k: v[i] for k, v in s["attn"].items()}}
        ffn = s["moe"] if "moe" in s else s["mlp"]
        out.update({k: v[i] for k, v in ffn.items()})
        return {k: v.float() for k, v in out.items()}


def lora_dims(arch: Arch) -> Dict[str, Tuple[int, int]]:
    """name -> (d_in, d_out) of each adapted projection of a layer."""
    d, hd = arch.d, arch.head_dim
    dims = {"q": (d, arch.n_heads * hd), "k": (d, arch.n_kv * hd),
            "v": (d, arch.n_kv * hd), "o": (arch.n_heads * hd, d),
            "gate": (d, arch.ff), "up": (d, arch.ff), "down": (arch.ff, d)}
    return {n: dims[n] for n in arch.lora_targets}


# ------------------------------------------------------------ blocks ----
def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x (T, h, hd) at positions pos (T,): pairs (i, i + hd/2) rotated
    by pos * theta^(-2i/hd)."""
    hd = x.shape[-1]
    freqs = 1.0 / torch.pow(float(theta), torch.arange(
        0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = pos.float()[:, None] * freqs                        # (T, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 1024):
    """q (T, H, hd), k/v (T, KV, hd): causal softmax attention, grouped
    query heads, query rows in blocks."""
    T, H, hd = q.shape
    KV = k.shape[1]
    g = H // KV
    qr = q.reshape(T, KV, g, hd)
    outs = []
    for q0 in range(0, T, block):
        qb = qr[q0:q0 + block]
        n = qb.shape[0]
        s = torch.einsum("qkgh,skh->kgqs", qb, k[:q0 + n]) * hd ** -0.5
        qpos = torch.arange(q0, q0 + n, device=q.device)[:, None]
        kpos = torch.arange(q0 + n, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, -torch.inf)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("kgqs,skh->qkgh", p, v[:q0 + n]))
    return torch.cat(outs, 0).reshape(T, H * hd)


def lora_delta(x, ad, scale):
    if ad is None:
        return 0.0
    a, b = ad
    return scale * ((x @ a) @ b)


def proj(x, w, ad, scale, mm):
    y = mm(x, w)
    return y if ad is None else y + lora_delta(x, ad, scale)


def moe_capacity(group_tokens: int, row_tokens: int, arch: Arch
                 ) -> Optional[int]:
    """The program's capacity rule: a group of `group_tokens` tokens whose
    rows hold `row_tokens` each gets C slots per expert (None: C covers
    the whole group, so nothing can drop)."""
    if not arch.moe:
        return None
    E, k = arch.n_experts, arch.top_k
    if row_tokens * k >= 2 * E:
        C = max(int(round(group_tokens * k * arch.capacity_factor / E)), 1)
    else:
        C = min(group_tokens, max(8, 4 * (-(-group_tokens * k // E))))
    return None if C >= group_tokens else C


def rank_in_expert(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """Rank of each assignment within its expert, in order."""
    one = F.one_hot(e_flat.long(), E)
    return (one.cumsum(0) * one).sum(-1) - 1


def route(h, lw, arch: Arch):
    """Softmax router over h (T, d): (sorted expert ids (T, E), their
    scores)."""
    scores = torch.softmax(h @ lw["router"], dim=-1)
    w, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return order, w


def experts(h, lw, arch: Arch, idx, w, mm):
    """sum_j w[:, j] * expert idx[:, j] (h), SwiGLU experts."""
    y = torch.zeros_like(h)
    for e in range(arch.n_experts):
        sel = idx == e
        wt = (w * sel).sum(-1)
        tok = torch.nonzero(sel.any(-1)).flatten()
        if tok.numel() == 0:
            continue
        he = h[tok]
        ye = mm(F.silu(mm(he, lw["gate"][e])) * mm(he, lw["up"][e]),
                lw["down"][e])
        y = y.index_add(0, tok, ye * wt[tok, None])
    return y


def top_k(order, w, k: int):
    """The top-k ids and renormalised weights."""
    idx, wk = order[:, :k], w[:, :k]
    return idx, wk / wk.sum(-1, keepdim=True).clamp(min=1e-9)


def moe_ffn(h, lw, arch: Arch, capacity: Optional[int], mm):
    """h (T, d) one group: softmax router, top-k (ties to the lower
    expert), renormalised weights, assignments past the capacity dropped,
    SwiGLU experts."""
    T = h.shape[0]
    order, w = route(h, lw, arch)
    idx, wk = top_k(order, w, arch.top_k)
    if capacity is not None:
        keep = rank_in_expert(idx.reshape(-1), arch.n_experts) < capacity
        wk = torch.where(keep.reshape(T, -1), wk, 0.0)
    return experts(h, lw, arch, idx, wk, mm)


def block(x, lw, arch: Arch, groups: Sequence[Tuple[int, int, Optional[int]]],
          mm: Mm, lora: Optional[Dict] = None):
    """One decoder layer over one sequence x (T, d) at positions 0..T-1.
    groups: (start, end, capacity) row ranges the MoE routes as groups."""
    T = x.shape[0]
    H, KV, hd = arch.n_heads, arch.n_kv, arch.head_dim
    s = arch.lora_scale
    ad = (lambda n: None) if lora is None else lora.get
    pos = torch.arange(T, device=x.device)
    h = rms_norm(x, lw["ln1"], arch.eps)
    q = rope(proj(h, lw["wq"], ad("q"), s, mm).reshape(T, H, hd), pos,
             arch.rope_theta)
    k = rope(proj(h, lw["wk"], ad("k"), s, mm).reshape(T, KV, hd), pos,
             arch.rope_theta)
    v = proj(h, lw["wv"], ad("v"), s, mm).reshape(T, KV, hd)
    x = x + proj(causal_attention(q, k, v), lw["wo"], ad("o"), s, mm)
    h = rms_norm(x, lw["ln2"], arch.eps)
    if arch.moe:
        out = torch.cat([moe_ffn(h[a:b], lw, arch, cap, mm)
                         for a, b, cap in groups], 0)
    else:
        g = proj(h, lw["gate"], ad("gate"), s, mm)
        u = proj(h, lw["up"], ad("up"), s, mm)
        out = proj(F.silu(g) * u, lw["down"], ad("down"), s, mm)
    return x + out


# ----------------------------------------------------------- serving ----
def _qkv(h, lw, arch: Arch, pos, mm):
    n = h.shape[0]
    H, KV, hd = arch.n_heads, arch.n_kv, arch.head_dim
    q = rope(mm(h, lw["wq"]).reshape(n, H, hd), pos, arch.rope_theta)
    k = rope(mm(h, lw["wk"]).reshape(n, KV, hd), pos, arch.rope_theta)
    return q, k, mm(h, lw["wv"]).reshape(n, KV, hd)


@torch.no_grad()
def served_hidden(weights: Weights, arch: Arch, seqs: List[torch.Tensor],
                  prompt_lens: List[int], decode_group: int, mm: Mm = plain_mm):
    """The final normed hidden states (T, d) of each sequence (prompt, then
    the served tokens but the last), layer by layer. A prompt is routed as
    its prefill's group; a served token as one of a decode round's
    `decode_group` slots (where the capacity covers them all)."""
    if arch.window:
        longest = max(t.numel() for t in seqs)
        if longest > arch.window:
            raise ValueError(f"a sequence of {longest} positions passes the "
                             f"{arch.window}-position window, which the "
                             "reference does not model")
    if arch.moe and moe_capacity(decode_group, 1, arch) is not None:
        raise ValueError("a decode round could drop assignments: the "
                         "reference routes each served token alone")
    out = []
    for t, P in zip(seqs, prompt_lens):
        T = t.numel()
        pos = torch.arange(T, device=t.device)
        groups = [(a, b, c) for a, b, c in
                  [(0, P, moe_capacity(P, P, arch)), (P, T, None)] if b > a]
        x = weights.embed[t.long()].float()
        for i in range(arch.n_layers):
            lw = weights.layer(i)
            h = rms_norm(x, lw["ln1"], arch.eps)
            q, k, v = _qkv(h, lw, arch, pos, mm)
            x = x + mm(causal_attention(q, k, v), lw["wo"])
            h = rms_norm(x, lw["ln2"], arch.eps)
            if arch.moe:
                x = x + torch.cat([moe_ffn(h[a:b], lw, arch, cap, mm)
                                   for a, b, cap in groups], 0)
            else:
                x = x + mm(F.silu(mm(h, lw["gate"])) * mm(h, lw["up"]),
                           lw["down"])
            del lw
        out.append(rms_norm(x, weights.final_norm, arch.eps))
    return out


@torch.no_grad()
def logits_rows(weights: Weights, h: torch.Tensor, mm: Mm = plain_mm,
                chunk: int = 1024):
    """Yields (row offset, logits (n, V) f32) over the rows of h."""
    table = weights.unembed.float().t()
    for r0 in range(0, h.shape[0], chunk):
        yield r0, mm(h[r0:r0 + chunk], table)


# ---------------------------------------------------------- training ----
def train_loss(weights: Weights, arch: Arch, adapters: Dict,
               tokens: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
               mm: Mm = plain_mm):
    """The masked mean next-token cross-entropy of a batch (B, S), the
    adapters as the only leaves; each layer recomputed in the backward
    pass. A batch row is one MoE group."""
    B, S = tokens.shape
    x = weights.embed[tokens.long()].float()

    def layer(xb, i, *ad_leaves):
        lw = weights.layer(i)
        names = sorted(adapters)
        lora = {n: (ad_leaves[2 * j], ad_leaves[2 * j + 1])
                for j, n in enumerate(names)}
        groups = [(0, S, moe_capacity(S, S, arch))]
        return torch.stack([block(xb[r], lw, arch, groups, mm, lora)
                            for r in range(B)])

    for i in range(arch.n_layers):
        leaves = [t for n in sorted(adapters)
                  for t in (adapters[n]["a"][i], adapters[n]["b"][i])]
        x = checkpoint(layer, x, i, *leaves, use_reentrant=False)
    h = rms_norm(x, weights.final_norm, arch.eps)[:, :-1]
    lab, msk = labels[:, 1:].long(), mask[:, 1:].float()
    table = weights.unembed

    def nll(hc, lc):
        logits = mm(hc, table.float().t())
        return torch.logsumexp(logits, -1) - logits.gather(
            -1, lc[..., None])[..., 0]

    tot = torch.zeros((), device=x.device)
    for s0 in range(0, S - 1, 256):
        sl = slice(s0, s0 + 256)
        tot = tot + (checkpoint(nll, h[:, sl], lab[:, sl],
                                use_reentrant=False) * msk[:, sl]).sum()
    return tot / msk.sum().clamp(min=1.0)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float
    warmup_steps: int


def leaf_norms(tree: Dict) -> Dict[str, torch.Tensor]:
    """{"name.a" / "name.b": per-layer norms (L,)} of a stacked adapter
    tree."""
    return {f"{n}.{ab}": tree[n][ab].double().flatten(1).norm(dim=1)
            for n in sorted(tree) for ab in ("a", "b")}


def train_steps(weights: Weights, arch: Arch, adapters0: Dict, rows: Dict,
                opt: AdamW, steps: int = 3, mm: Mm = plain_mm,
                rows_used: Optional[int] = None):
    """`steps` AdamW steps of the adapters from adapters0, step s on
    rows["tokens"][s] (B, S) and its labels and mask. rows_used: train
    on the first rows of each batch only (a fault). Returns (losses,
    per step the clipped gradients' leaf norms, the change's leaf
    norms)."""
    exact_matmul()
    ad = {n: {k: t.detach().clone().float().requires_grad_()
              for k, t in v.items()} for n, v in adapters0.items()}
    leaves = [ad[n][k] for n in sorted(ad) for k in ("a", "b")]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    losses, grads = [], []
    for s in range(steps):
        sel = slice(0, rows_used)
        loss = train_loss(weights, arch, ad, rows["tokens"][s][sel],
                          rows["labels"][s][sel], rows["mask"][s][sel], mm)
        g = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        t = s + 1
        gn = torch.sqrt(sum(x.square().sum() for x in g) + 1e-12)
        clip = min(opt.grad_clip / max(float(gn), 1e-12), 1.0) \
            if opt.grad_clip > 0 else 1.0
        g = [x * clip for x in g]
        grads.append(leaf_norms({n: {"a": g[2 * j], "b": g[2 * j + 1]}
                                 for j, n in enumerate(sorted(ad))}))
        lr = opt.lr * min(t / max(opt.warmup_steps, 1), 1.0)
        bc1, bc2 = 1 - opt.b1 ** t, 1 - opt.b2 ** t
        with torch.no_grad():
            for p, mi, vi, gi in zip(leaves, m, v, g):
                mi.mul_(opt.b1).add_((1 - opt.b1) * gi)
                vi.mul_(opt.b2).add_((1 - opt.b2) * gi * gi)
                step = lr * (mi / bc1) / (torch.sqrt(vi / bc2) + opt.eps)
                if opt.weight_decay:
                    step = step + lr * opt.weight_decay * p
                p.sub_(step)
    change = leaf_norms({n: {k: (ad[n][k] - adapters0[n][k].float()).detach()
                             for k in ("a", "b")} for n in ad})
    return losses, grads, change
